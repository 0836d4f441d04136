"""Hopper kernels and the ops around them.

``rope`` and ``flash`` hold the hand-written CUDA kernels (sources in
``csrc/``, built by ``build``) beside their plain PyTorch versions;
``attention`` dispatches the model's attention. Importing this package
builds nothing.
"""
