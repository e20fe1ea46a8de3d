"""InstanceRefer in PyTorch + CUDA: the port of ``instancerefer_tpu`` to one
NVIDIA H100.

Modules mirror the JAX package's paths (``ops/``, ``models/``, ``train/``,
``utils/``, ``data/``).  The JAX package is the reference each module is held
against; this package imports ``torch`` and never ``jax``, ``flax`` or
``yaml``.  The host pipeline (numpy + ctypes) is shared, not copied: see
``data/host.py``.

The sparse-conv gather-GEMM is a hand-written CUDA kernel
(``csrc/gather_conv.cu``, bound in ``ops/gather_conv.py``) that builds with
``nvcc`` at first use; everything else is plain PyTorch.
"""

__version__ = "0.1.0"
