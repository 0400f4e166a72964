"""Device and dtype policy of the port.

Entry points run on the CUDA card unless the caller passes
``device='cpu'``: a ``device=None`` argument resolves through
:func:`resolve_device`, which raises where there is no card (there is
no silent CPU fallback).

The working dtype is float64 (complex128) on the CPU and on the card
alike: the fit's results on the H100 are those of the reference's
float64 path.  float32 on the card moved them: the CCF's contraction
has terms of ~4e6 while its chi-square rises by 0.1-3 from one velocity
step to the next, and the Nelder-Mead ends anywhere inside its
tolerance along flat directions (ROADMAP C.1 and C.2, repaired by this
policy).  The card's kernels take float64 (kernel B on the FP64 tensor
cores) and keep their float32 forms, which a caller still reaches by
building its template model and CCF bank with an explicit
``dtype=torch.float32`` (pipeline/library.template_model_from_artifacts,
convert.ccf_bank).

TF32 is switched off for matmuls AND for cuDNN convolutions, for the
float32 forms: the spline solve's banded inverse is a conv1d
(ops/spline.py), and TF32 keeps ~3 decimal digits, which corrupts the
spline coefficients; the reference found that reduced-precision
matmuls also break the grid interpolation and the chi-square
(docs/performance.md, "Precision").
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
    """Working real dtype of tensors on ``device``: float64 on every
    device."""
    return torch.float64


def complex_dtype_for(device):
    """Working complex dtype of tensors on ``device``: complex128 on
    every device."""
    return torch.complex128


def complex_of(dtype):
    """The complex dtype whose parts are ``dtype`` (float32 or
    float64)."""
    return {torch.float32: torch.complex64,
            torch.float64: torch.complex128}[dtype]
