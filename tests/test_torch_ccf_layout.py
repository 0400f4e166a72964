"""Kernel B's float64 form, the parts that run on the host: the planner
that picks its blocks, slices and clusters (ops/ccf_chisq.plan_f64), its
zero-padded operand layouts, the bank operands that the wrapper keeps
while a bank lives, and fit_batch / fit through a plain-torch copy of
the kernel's blocked arithmetic, on the CPU in float64."""
import gc
import itertools

import numpy as np
import pytest
import torch

from rvspecfit_torch import convert, simulation
from rvspecfit_torch.fit import ccf
from rvspecfit_torch.fit.spec_data import SpecData
from rvspecfit_torch.ops import ccf_chisq

NSM = 132   # SMs of an H100 SXM


@pytest.mark.parametrize('nb,nt,nf,nv', list(itertools.product(
    (1, 37, 500, 1000), (1, 108, 129), (1, 2049), (1, 401, 409))))
def test_plan_covers_every_chunk_once(nb, nt, nf, nv):
    """Each block's slices cover its stages of F once, in order, none
    empty, every cluster full and within its size limit; the blocks
    cover (B, T, V); sliced launches fit in one wave."""
    for continuum, nsm in itertools.product((True, False), (NSM, 4 * NSM)):
        plan = ccf_chisq.plan_f64(nb, nt, nf, nv, continuum, nsm)
        rows = ccf_chisq.F64_ROWS[continuum]
        assert plan.t_blk * plan.b_blk == rows
        assert plan.t_blk & (plan.t_blk - 1) == 0
        assert plan.ntt * plan.t_blk >= nt > (plan.ntt - 1) * plan.t_blk
        assert plan.nbt * plan.b_blk >= nb > (plan.nbt - 1) * plan.b_blk
        assert plan.ncb * ccf_chisq.F64_COLS >= nv \
            > (plan.ncb - 1) * ccf_chisq.F64_COLS
        assert plan.nchunks * ccf_chisq.F64_FREQ == \
            ccf_chisq.padded_freqs(nf) >= nf
        assert 1 <= plan.csize <= ccf_chisq.F64_MAX_CLUSTER == 8
        assert plan.nslices % plan.csize == 0
        assert plan.nslices == 1 or plan.tiles * plan.nslices <= nsm
        # slice s is rank s % csize of cluster s // csize: the order in
        # which the kernel adds them
        order = [plan.slice_chunks(cl * plan.csize + r)
                 for cl in range(plan.nclusters) for r in range(plan.csize)]
        assert order[0][0] == 0 and order[-1][1] == plan.nchunks
        for (b0, e0), (b1, _) in zip(order, order[1:]):
            assert e0 == b1
        assert all(e - b >= min(ccf_chisq.F64_MIN_CHUNKS, plan.nchunks)
                   for b, e in order)


def test_plan_pads_the_path_shapes_least():
    """At the path's T = 108 a block is 4 templates x 32 fibers (2.4%
    padded rows at B = 500 and 1000, none in T); one fiber row takes 128
    templates and F in 40 slices, 5 clusters of 8, over 3 column
    blocks (120 blocks on 132 SMs)."""
    p = ccf_chisq.plan_f64(1000, 108, 2049, 401, True, NSM)
    assert (p.t_blk, p.b_blk, p.ncb, p.ntt, p.nbt, p.nslices) == \
        (4, 32, 3, 27, 32, 1)
    p = ccf_chisq.plan_f64(1, 108, 2049, 401, True, NSM)
    assert (p.t_blk, p.ncb, p.nslices, p.csize, p.nclusters) == \
        (128, 3, 40, 8, 5)
    # the few-row cases of the card's test_kernel_b_f64_cluster_sizes
    for nb, cont, slices in ((2, True, (16, 8)), (3, True, (8, 8)),
                             (3, False, (7, 7)), (10, True, (4, 4)),
                             (16, True, (3, 3)), (20, True, (2, 2))):
        p = ccf_chisq.plan_f64(nb, 108, 2049, 401, cont, NSM)
        assert (p.nslices, p.csize) == slices


def _inputs(nb, nt, nf, nv, seed):
    """Bank and exposure rFFTs of real series (positive T2 and IV) and
    DFT-at-lag matrices, complex128 / float64 on the CPU."""
    rng = np.random.RandomState(seed)
    n = max(1, 2 * (nf - 1))
    tm = 1.0 + 0.1 * rng.normal(size=(nt, n))
    spec = 1.0 + 0.1 * rng.normal(size=(nb, n))
    ivar = rng.uniform(0.5, 2.0, (nb, n))
    cplx = [np.fft.rfft(tm, axis=1), np.fft.rfft(tm**2, axis=1),
            np.conj(np.fft.rfft(spec * ivar, axis=1)),
            np.conj(np.fft.rfft(ivar, axis=1))]
    ecos, esin = ccf.dft_mats(dict(npoints=n, logl0=0.0, logl1=n * 1e-4),
                              np.linspace(-400.0, 400.0, nv), 'cpu',
                              torch.float64)
    return [torch.as_tensor(c, dtype=torch.complex128) for c in cplx] + \
        [ecos, esin]


def blocked_f64(args, continuum, operands, nsm=NSM):
    """The float64 kernel's arithmetic in plain torch, block by block as
    plan_f64 lays it out, from its padded operands: each block's rows
    are templates t0 + r % t_blk of fibers b0 + r // t_blk, its complex
    values (-2T) S + T2 IV (or T S and T2 IV) per frequency, each slice
    of stages summed apart and the slices added in order.  Stage c of a
    block reads template t's (T', T2) at tt2[c, t, :16] and column block
    cb's (Ecos, Esin) at e[cb, 8 c:8 c + 8, :136]; S and IV as they are,
    zeros past F."""
    tfft, _, sfft, ivfft, ecos, _ = args
    nt, nf = tfft.shape
    nb, nv = sfft.shape[0], ecos.shape[1]
    plan = ccf_chisq.plan_f64(nb, nt, nf, nv, continuum, nsm)
    cols, freq = ccf_chisq.F64_COLS, ccf_chisq.F64_FREQ
    fp = plan.nchunks * freq
    tt2 = operands[0][..., :-1].unflatten(-1, (freq, 2)).transpose(
        0, 1).reshape(nt, fp, 2)
    siv = sfft.new_zeros((nb, fp, 2))
    siv[:, :nf, 0], siv[:, :nf, 1] = sfft, ivfft
    out = torch.full((nb, nt, nv), float('nan'), dtype=torch.float64)
    r = torch.arange(plan.t_blk * plan.b_blk)
    for tile in range(plan.tiles):
        cb, rest = tile % plan.ncb, tile // plan.ncb
        t = rest % plan.ntt * plan.t_blk + r % plan.t_blk
        b = rest // plan.ntt * plan.b_blk + r // plan.t_blk
        ok = (t < nt) & (b < nb)
        t, b = t[ok], b[ok]
        sums = None
        for s in range(plan.nslices):
            c0, c1 = plan.slice_chunks(s)
            f = slice(c0 * freq, c1 * freq)
            tp, sp = tt2[t, f], siv[b, f]
            xs = [tp[..., 0] * sp[..., 0] + tp[..., 1] * sp[..., 1]] \
                if continuum else [tp[..., 0] * sp[..., 0],
                                   tp[..., 1] * sp[..., 1]]
            ep = operands[1][cb, f, :cols]
            part = [x.real @ ep[..., 0] - x.imag @ ep[..., 1] for x in xs]
            sums = part if sums is None else [a + p
                                              for a, p in zip(sums, part)]
        res = sums[0] if continuum else -(sums[0] ** 2) / sums[1]
        v = cb * cols + torch.arange(cols)
        assert torch.isnan(out[b[:, None], t[:, None], v[v < nv]]).all()
        out[b[:, None], t[:, None], v[v < nv]] = res[:, v < nv]
    return out


@pytest.mark.parametrize('continuum', [True, False])
@pytest.mark.parametrize('nb,nt,nf,nv', [(1, 108, 129, 37), (37, 7, 65, 21),
                                         (5, 129, 9, 141), (2, 1, 1, 1)])
def test_padded_operands_give_the_contraction(continuum, nb, nt, nf, nv):
    """The kernel's blocked arithmetic on the bank operands (built once)
    covers every output once and equals contraction_operands' GEMM and
    the plain version to 1e-12 of max|out|; the layouts (the bank's and
    the exposure's stage-major one) hold the inputs and zeros past F
    and V."""
    args = _inputs(nb, nt, nf, nv, seed=nb + nt + nf + nv)
    ops = ccf_chisq.bank_operands(args[0], args[1], args[4], args[5],
                                  continuum)
    tt2, e = ops
    fp, ncb = ccf_chisq.padded_freqs(nf), -(-nv // 136)
    assert tt2.shape == (fp // 8, nt, 17) and tt2.dtype == torch.complex128
    assert e.shape == (ncb, fp, 138, 2) and e.dtype == torch.float64
    pairs = tt2[..., :16].unflatten(-1, (8, 2)).transpose(0, 1) \
        .reshape(nt, fp, 2)
    assert torch.equal(pairs[:, :nf, 0],
                       -2.0 * args[0] if continuum else args[0])
    assert torch.equal(pairs[:, :nf, 1], args[1])
    ecols = e[..., :136, :].transpose(0, 1).reshape(fp, ncb * 136, 2)
    assert torch.equal(ecols[:nf, :nv, 0], args[4])
    assert torch.equal(ecols[:nf, :nv, 1], args[5])
    assert not tt2[..., 16].any() and not pairs[:, nf:].any()
    assert not e[..., 136:, :].any() and not ecols[nf:].any() \
        and not ecols[:, nv:].any()
    siv = ccf_chisq.exposure_operand(args[2], args[3])
    assert siv.shape == (fp // 8, nb, 17) and not siv[..., 16].any()
    for h in (0, 1):
        part = siv[..., 8 * h:8 * h + 8].transpose(0, 1).reshape(nb, fp)
        assert torch.equal(part[:, :nf], args[2 + h])
        assert not part[:, nf:].any()
    got = blocked_f64(args, continuum, ops, nsm=4 * NSM)
    mats, em = ccf_chisq.contraction_operands(*args, continuum=continuum)
    cs = [(m @ em).reshape(nb, nt, nv) for m in mats]
    gemm = cs[0] if continuum else -(cs[0] ** 2) / cs[1]
    for want in (gemm, ccf_chisq.ccf_chisq_plain(*args, continuum=continuum)):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * float(want.abs().max()))


def test_bank_operands_are_built_once_per_bank():
    """The wrapper keeps a bank's operands while the bank lives: the
    same object for the same bank, DFT matrices and mode; rebuilt for
    another mode, for other DFT matrices (equal values or not) and
    after the bank or a matrix is written to; dropped with the bank."""
    args = _inputs(3, 5, 17, 9, seed=1)
    tfft, t2fft, _, _, ecos, esin = args
    build = lambda cont, ec=ecos: ccf_chisq.bank_operands(
        tfft, t2fft, ec, esin, cont)
    first = build(True)
    assert build(True) is first
    assert torch.equal(first[0], ccf_chisq.template_operand(tfft, t2fft))
    assert torch.equal(first[1], ccf_chisq.dft_operand(ecos, esin))
    assert build(False) is not first
    other = ecos.clone()
    again = build(True, other)
    assert again is not first and build(True, other) is again
    other.mul_(2.0)
    assert build(True, other) is not again
    assert torch.equal(build(True, other)[1],
                       ccf_chisq.dft_operand(other, esin))
    tfft.mul_(2.0)
    assert torch.equal(build(True, other)[0],
                       ccf_chisq.template_operand(tfft, t2fft))
    key = id(tfft)
    assert key in ccf_chisq._bank_cache
    del tfft, args, build
    gc.collect()
    assert key not in ccf_chisq._bank_cache


def test_same_shaped_banks_get_their_own_operands():
    """Two banks of one shape on one grid: each call takes the operands
    of its own bank, never those of the other."""
    a = _inputs(2, 5, 17, 9, seed=3)
    b = _inputs(2, 5, 17, 9, seed=4)
    for bank in (a, b, a, b):
        tt2, _ = ccf_chisq.bank_operands(bank[0], bank[1], a[4], a[5], True)
        assert torch.equal(tt2, ccf_chisq.template_operand(bank[0], bank[1]))


def test_dft_matrices_are_made_once_per_grid():
    conf = dict(npoints=64, logl0=0.0, logl1=0.0064)
    grid = np.linspace(-300.0, 300.0, 13)
    a = ccf.dft_mats(conf, grid, 'cpu', torch.float64)
    assert ccf.dft_mats(conf, list(grid), torch.device('cpu'),
                        torch.float64)[0] is a[0]
    assert ccf.dft_mats(conf, grid, 'cpu', torch.float32)[0].dtype == \
        torch.float32


def _kernel_on_the_cpu(monkeypatch):
    """fit/ccf.py through the float64 kernel's blocked arithmetic: the
    bank operands built and kept as the wrapper keeps them on the card,
    the contraction by blocked_f64."""
    launches = []

    def kernel(*args, continuum=True):
        ops = ccf_chisq.bank_operands(args[0], args[1], args[4], args[5],
                                      continuum)
        launches.append(ops)
        return blocked_f64(args, continuum, ops)
    monkeypatch.setattr(ccf_chisq, 'ccf_chisq', kernel)
    return launches


@pytest.mark.parametrize('continuum', [True, False])
def test_fit_batch_and_fit_through_the_layouts(monkeypatch, continuum):
    """fit_batch and fit give the plain version's templates, velocities
    and chi-squares through the kernel's layouts, with one set of bank
    operands per arm's bank reused by every call."""
    tfft, t2fft, info = simulation.build_ccf_bank(
        3, 3, 3, 2, npix=512, every=2, continuum=continuum, device='cpu')
    arms, _ = simulation.make_exposure(6, npix_arm=160, seed=3)
    banks = {n: convert.ccf_bank(tfft, t2fft, info, device='cpu')
             for n in arms}
    config = dict(min_vel=-600, max_vel=600, vel_step0=40)
    batches = [(n, lam, fl, 1.0 / np.sqrt(iv), None)
               for n, (lam, fl, iv) in arms.items()]
    sds = [SpecData(n, lam, fl[0], 1.0 / np.sqrt(iv[0]))
           for n, (lam, fl, iv) in arms.items()]
    want = ccf.fit_batch(batches, config, banks)
    want1 = ccf.fit(sds, config, banks=banks)
    launches = _kernel_on_the_cpu(monkeypatch)
    got = ccf.fit_batch(batches, config, banks)
    got1 = ccf.fit(sds, config, banks=banks)
    assert len(launches) == 2 * len(arms)
    for i, ops in enumerate(launches[:len(arms)]):
        assert launches[len(arms) + i] is ops
    np.testing.assert_array_equal(got['best_id'], want['best_id'])
    # within test_torch_ccf's limits against the reference (1e-6 km/s,
    # 1e-9 of the chi-square): the sums are taken in another order
    np.testing.assert_allclose(got['best_vel'], want['best_vel'], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got['best_chi'], want['best_chi'], rtol=1e-9)
    assert got1['best_par'] == want1['best_par']
    assert abs(got1['best_vel'] - want1['best_vel']) <= 1e-6
    np.testing.assert_allclose(got1['best_ccf'], want1['best_ccf'],
                               rtol=1e-9)
