"""tf_operator_tpu_torch — the PyTorch/CUDA port of the workload tier.

The counterpart of ``tf_operator_tpu``'s workload tier (models/, ops/,
train/) for NVIDIA Hopper GPUs. Plain tensor code is PyTorch; every kernel
that the JAX package wrote in Pallas for the TPU is a hand-written CUDA C++
kernel for ``sm_90a`` under ``ops/csrc``, built with ``nvcc`` at first use
(``ops/build.py``) and bound with ``ctypes``.

Rules the package keeps:

- It imports ``torch`` and numpy, never ``jax``/``flax``/``optax``/``orbax``
  and nothing of ``tf_operator_tpu``: what it needs from there it carries
  as its own copy.
- Importing it builds and loads nothing; kernels are compiled on their
  first launch.
- Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
  and raise when CUDA is absent. Each kernel wrapper uses its plain PyTorch
  version only for a tensor that lies on the CPU; a CUDA tensor gets the
  kernel or an exception.
"""

__version__ = "0.1.0"
