"""CPU-side logic of chip_smoke.py and tools/torch_kernel_ab.py: the
kernel A bound's byte count and the A/B tool's choice of a baseline's C
interface."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))

import chip_smoke  # noqa: E402
import torch_kernel_ab  # noqa: E402
from rvspecfit_torch.ops import cuda_build  # noqa: E402


@pytest.mark.parametrize('rpc,knots', [(1, 3 + 2), (2, 4)])
def test_spline_bound_counts_distinct_intervals(rpc, knots):
    # per row: row 0 touches intervals {0, 2, 5}, row 1 {8, 9} (12.0
    # clamps to the last interval, 9); shared by both rows (rpc 2),
    # with row 1 in {0, 2, 5, 9}: {0, 2, 5, 9}
    u = torch.tensor([[0.5, 0.7, 2.1, 5.0], [8.2, 8.9, 9.5, 12.0]])
    if rpc == 2:
        u[1] = torch.tensor([0.1, 2.2, 5.5, 9.9])
    want = 1e3 * (2 * 4 * u.numel() + 16 * knots) \
        / chip_smoke.HBM_BYTES_PER_S
    assert chip_smoke.spline_bound_ms(u, 10, rpc) == pytest.approx(want)


@pytest.mark.parametrize('name', ['spline_eval', 'ccf_chisq'])
def test_ab_binds_the_current_interface(name):
    assert torch_kernel_ab.baseline_interface(cuda_build.CSRC,
                                              name) == 'current'


@pytest.mark.parametrize('params,want', [
    (torch_kernel_ab.SEPARATE_DFT.replace(', ', ',\n    '), 'separate_dft'),
    ('const float* tt2, float* out, int nb, void* stream', None),
])
def test_ab_binds_or_refuses_a_baseline(tmp_path, params, want):
    (tmp_path / 'ccf_chisq.cu').write_text(
        f'extern "C" int rvst_ccf_chisq({params}) {{\n  return 0;\n}}\n')
    if want is None:
        with pytest.raises(SystemExit, match='cannot call'):
            torch_kernel_ab.baseline_interface(tmp_path, 'ccf_chisq')
    else:
        assert torch_kernel_ab.baseline_interface(tmp_path,
                                                  'ccf_chisq') == want
