"""Device and dtype policy of the port.

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


def dtype_for(device):
    """Working real dtype of tensors on ``device``."""
    return torch.float32 if torch.device(device).type == 'cuda' \
        else torch.float64


def complex_dtype_for(device):
    """Working complex dtype of tensors on ``device``."""
    return torch.complex64 if torch.device(device).type == 'cuda' \
        else torch.complex128
