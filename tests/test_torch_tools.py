"""CPU-side logic of chip_smoke.py, tools/torch_kernel_ab.py,
tools/torch_ablate.py and tools/torch_mesh_cards.py: the kernel A
bound's byte count, the A/B tool's choice of a baseline's C interface,
the ablation tool's table of sources and its reading of ptxas, the
busy time's union, the garbage-collection clock and the mesh tool's
meshes."""
import gc
import re
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / 'tools'))

import chip_smoke  # noqa: E402
import torch_ablate  # noqa: E402
import torch_kernel_ab  # noqa: E402
import torch_mesh_cards  # noqa: E402
from rvspecfit_torch.ops import (  # noqa: E402
    ccf_chisq, cuda_build, spline_eval)


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


@pytest.mark.parametrize('params,want', [
    (None, 'current'),            # the port's own source
    (torch_kernel_ab.F64_SPLIT.replace(', ', ',\n    '), 'split'),
    ('const double* tt2, double* out, int nb, void* stream', None),
    ('', None),                   # a source without a float64 launcher
])
def test_ab_binds_or_refuses_a_float64_baseline(tmp_path, params, want):
    csrc = cuda_build.CSRC
    if params is not None:
        csrc = tmp_path
        fn = f'extern "C" int rvst_ccf_chisq_f64({params}) {{ return 0; }}'
        (tmp_path / 'ccf_chisq.cu').write_text(fn if params else '')
    if want is None:
        with pytest.raises(SystemExit, match='cannot call'):
            torch_kernel_ab.baseline_f64_interface(csrc)
    else:
        assert torch_kernel_ab.baseline_f64_interface(csrc) == want


def test_ab_splits_f_as_the_first_float64_kernel():
    """The first float64 kernel split F 52 ways at one fiber row (two
    waves of its 64-row blocks on 132 SMs) and not at 500 fibers."""
    assert torch_kernel_ab.split_slices(1, 108, 2049, 401, True, 132) == 52
    assert torch_kernel_ab.split_slices(500, 108, 2049, 401, True, 132) == 1


ADJOINT = ('const float* u, const float* g, float* dcoeffs, int rows, '
           'int npix, int nm1, int log_step, float x0, float step, '
           'float expm1_step, void* stream')


@pytest.mark.parametrize('params,want', [
    (None, True),                 # the port's own source
    ('', False),                  # a source from before the adjoint
    (ADJOINT.replace(', ', ',\n    '), True),
    ('const float* u, float* dcoeffs, int rows, void* stream', None),
])
def test_ab_binds_the_adjoint_or_refuses_it(tmp_path, params, want):
    csrc = cuda_build.CSRC
    if params is not None:
        csrc = tmp_path
        fn = f'extern "C" int rvst_spline_adjoint({params}) {{ return 0; }}'
        (tmp_path / 'spline_eval.cu').write_text(fn if params else '')
    if want is None:
        with pytest.raises(SystemExit, match='cannot call'):
            torch_kernel_ab.baseline_has_adjoint(csrc)
    else:
        assert torch_kernel_ab.baseline_has_adjoint(csrc) is want


@pytest.mark.parametrize('kernel', list(torch_ablate.KERNELS))
def test_ablation_table_matches_the_sources(kernel):
    # the source has the launcher, the kernel and every level's switch,
    # and the launcher takes as many parameters as the tool binds
    source, launcher, entry, variants = torch_ablate.KERNELS[kernel]
    text = (cuda_build.CSRC / source).read_text()
    assert f'{entry}(' in text
    for level in set(variants.values()) - {0}:
        assert re.search(rf'RVST_ABLATE\s*[<>=!]=?\s*{level}\b', text)
    params = torch_kernel_ab.c_params(cuda_build.CSRC / source,
                                      launcher.removeprefix('rvst_'))
    argtypes = {'ccf_chisq': ccf_chisq.ARGTYPES,
                'ccf_chisq_f64': ccf_chisq.ARGTYPES_F64,
                'spline_eval_adjoint': spline_eval.ADJOINT_ARGTYPES}[kernel]
    assert len(params.split(',')) == len(argtypes)


PTXAS = """ptxas info    : Compiling entry function '_Z16ccf_chisq_kernelILi1ELi4EEvPK6float4' for 'sm_90a'
ptxas info    : Function properties for _Z16ccf_chisq_kernelILi1ELi4EEvPK6float4
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z16ccf_chisq_kernelILi2ELi2EEvPK6float4' for 'sm_90a'
ptxas info    : Used 96 registers, 392 bytes cmem[0]
ptxas info    : Compiling entry function '_Z21spline_adjoint_kernelPKfS0_Pfiii3Geo' for 'sm_90a'
ptxas info    : Function properties for _Z21spline_adjoint_kernelPKfS0_Pfiii3Geo
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, 400 bytes cmem[0]
"""


@pytest.mark.parametrize('entry,want', [
    ('ccf_chisq_kernel', ['0 bytes stack frame, 0 bytes spill stores, '
                          '0 bytes spill loads | Used 128 registers, '
                          '392 bytes cmem[0]',
                          'Used 96 registers, 392 bytes cmem[0]']),
    ('spline_adjoint_kernel', ['0 bytes stack frame, 0 bytes spill stores, '
                               '0 bytes spill loads | Used 64 registers, '
                               '400 bytes cmem[0]']),
    ('spline_eval_kernel', []),
])
def test_ablation_reads_each_kernels_ptxas_report(entry, want):
    assert torch_ablate.registers(PTXAS, entry) == want


def test_union_ms_counts_overlapping_intervals_once():
    """chip_smoke's busy time: the union of the card's intervals, so two
    streams at once count once (nanoseconds in, milliseconds out)."""
    spans = [(0, 2_000_000), (1_000_000, 3_000_000), (5_000_000,
                                                       6_000_000),
             (5_500_000, 5_600_000)]
    assert chip_smoke.union_ms(spans) == pytest.approx(4.0)
    assert chip_smoke.union_ms([]) == 0.0
    assert chip_smoke.union_ms(spans[::-1]) == pytest.approx(4.0)


def test_gc_time_counts_collections_inside_the_block():
    with chip_smoke.gc_time({}) as seen:
        gc.collect()
        gc.collect(0)
    assert seen['gc_full'] == 1 and seen['gc_s'] > 0
    n = len(gc.callbacks)
    gc.collect()
    assert seen['gc_full'] == 1 and len(gc.callbacks) == n


@pytest.mark.parametrize('cards,want', [
    (1, {'one card': None, 'card 0 twice': ['cuda:0', 'cuda:0']}),
    (4, {'one card': None, '2 cards': ['cuda:0', 'cuda:1'],
         '4 cards': ['cuda:0', 'cuda:1', 'cuda:2', 'cuda:3']}),
])
def test_mesh_tool_shards_over_powers_of_two_of_the_cards(
        monkeypatch, cards, want):
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: cards)
    assert torch_mesh_cards.meshes() == want
