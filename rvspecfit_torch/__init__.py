"""rvspecfit_torch — PyTorch/CUDA port of rvspecfit_tpu's batched fit.

The JAX package ``rvspecfit_tpu`` is the reference; each module here
mirrors the reference module of the same path (``ops/``, ``interp/``,
``fit/``, ``pipeline/``).  Plain tensor code is PyTorch; the two TPU
kernels of the reference are CUDA C++ kernels under ``csrc/``, built at
first use (see ``ops/cuda_build.py``).  This package never imports jax
or ``rvspecfit_tpu``.

Importing the package applies the device/dtype policy of
:mod:`rvspecfit_torch.device` (TF32 off everywhere).
"""
from rvspecfit_torch import device  # noqa: F401  (sets the TF32 policy)

__version__ = '0.1.0'
