"""Device and dtype policy of the port.

Entry points run on the CUDA card unless the caller passes
``device='cpu'``: a ``device=None`` argument resolves through
:func:`resolve_device`, which raises where there is no card (there is
no silent CPU fallback).

float64 on the CPU (the parity tests against the float64 reference),
float32 on CUDA (the working precision on the card).

TF32 is switched off for matmuls AND for cuDNN convolutions: the
spline solve's banded inverse is a conv1d (ops/spline.py), and TF32
keeps ~3 decimal digits, which corrupts the spline coefficients; the
reference found that reduced-precision matmuls also break the grid
interpolation and the chi-square (docs/performance.md, "Precision").
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision('highest')


def default_device():
    """The device of a call that names none: the current CUDA card.

    Raises RuntimeError when torch sees no CUDA device; a caller that
    wants the CPU asks for it with ``device='cpu'``."""
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass '
                           "device='cpu' to run on the CPU")
    return torch.device('cuda')


def resolve_device(device):
    """``device`` as a torch.device, :func:`default_device` if None."""
    return default_device() if device is None else torch.device(device)


def dtype_for(device):
    """Working real dtype of tensors on ``device``."""
    return torch.float32 if torch.device(device).type == 'cuda' \
        else torch.float64


def complex_dtype_for(device):
    """Working complex dtype of tensors on ``device``."""
    return torch.complex64 if torch.device(device).type == 'cuda' \
        else torch.complex128
