"""Native (C++) host-side components of the port, loaded via ctypes.

The port's copy of ``tf_operator_tpu/native``: ``dataloader.cc`` is built
on demand with the system toolchain (g++) and cached by a hash of its
source, so a source edit rebuilds. Every consumer has a pure-Python
fallback: the native tier raises the floor, it is never a dependency.
"""

from .build import load_library  # noqa: F401
