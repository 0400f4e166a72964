"""Nelder-Mead's iteration as a CUDA graph, one per padded tile width.

:meth:`BatchedFitter.run_neldermead <rvspecfit_torch.fit.batch.
BatchedFitter.run_neldermead>` runs each round's unconverged fibers in
tiles of a few fixed widths, the reference's ladder (:func:`top_width`,
:func:`ladder`, :func:`tiles`; rvspecfit_tpu/fit/batch.py and
survey/desi.py): the widest is the microbatch, or else the group's size
rounded up to one of :data:`TOP_WIDTHS`, so that groups of any size
share a few ladders; the tail of a round is padded by repeating its last
fiber, and the pad rows start converged, so they never move and are
never written back.  On every device.

On a CUDA device each width has one :class:`IterationGraph`: one whole
iteration of neldermead's ``_step`` (both objective calls under
``scan2``, the one (B, 4) call under ``cand4``, the centroid, the
candidates, the accept masks, the update and the convergence test)
captured once and replayed on every iteration, so the host issues one
replay and one read of the device an iteration in place of ~700 small
kernels.  The graph updates its tile's simplexes, values and mask in
buffers of its own, which a round fills once (:meth:`IterationGraph.
load`) and reads back once (:meth:`IterationGraph.store`).  The rare
shrink is not in the graph: the graph writes [any live shrink, live
count] into a small vector that the iteration's one read returns, and
where a live instance shrinks, the host shrinks and evaluates the
iteration's saved simplexes eagerly and recomputes its update and
convergence (neldermead's ``_shrink`` and ``_finish``, the same
arithmetic as ``_step``'s).  BatchedFitter.check_neldermead holds the
values NM returns to an eager evaluation of the same objective.

The graphs of a ladder are warmed up and captured together at NM's
first use (:func:`graphs`), share one memory pool per device and
thread, and are kept for the process, keyed by everything they bake
in: device, dtype, width, scheme, the template models, the arms'
shapes, basis and bands, vsini and its kernel widths, the velocity
bounds, the priors, the mapper's fixed values and the tolerance
``fatol``.  Capture runs with ``capture_error_mode='thread_local'``,
so other threads go on using the card meanwhile (they may not draw
from the card's random generator or synchronize the whole device while
a capture runs); the process captures one graph at a time.

Counters (:mod:`rvspecfit_torch.trace`, CUDA only): ``fit.nm.
graph_captures``, ``fit.nm.graph_replays`` and ``fit.nm.eager_calls``
(NM's objective calls made eagerly: simplex set-ups, restarts and
shrinks).  After each replay the counts and events of the kernel
launches the graph holds are applied again (``kernel_a.per_row.<form>``
and the ``kernel_a`` events with their shapes).
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import torch

from rvspecfit_torch import trace
from rvspecfit_torch.fit import neldermead as nm
from rvspecfit_torch.fit.vel_fit import prior_rows
from rvspecfit_torch.ops.resolution import BandedMatrix

# the arms' tensors with a fiber axis, and those every fiber shares
PER_FIBER = ('dvec', 'espec_inv', 'log_espec_sum')
SHARED = ('lam', 'polys', 'polys_prod', 'idx0', 'lam_over_step')
# ladders kept per process (each holds one graph per width)
MAX_LADDERS = 8
# eager iterations on copies before a capture
WARMUP = 2
# the widest tile where no microbatch is set: the smallest that holds the
# group, else the last (the reference's rounding of fit_microbatch,
# rvspecfit_tpu/survey/desi.py), so that groups of any size share four
# ladders and their graphs
TOP_WIDTHS = (64, 128, 256, 500)


def top_width(b, microbatch=None):
    """The widest tile of a group of ``b`` fibers: ``microbatch`` where
    set, else the first of :data:`TOP_WIDTHS` that holds the group, or
    the widest."""
    if microbatch:
        return int(microbatch)
    return next((w for w in TOP_WIDTHS if w >= b), TOP_WIDTHS[-1])


def ladder(mb):
    """The tile widths of a microbatch ``mb``, widest first: mb, mb // 2
    and mb // 4 where at least 32 (rvspecfit_tpu/fit/batch.py)."""
    return sorted({mb} | {w for w in (mb // 2, mb // 4) if w >= 32},
                  reverse=True)


def tile_width(u, widths):
    """The width that tiles ``u`` fibers at the least cost: the padded
    fiber-iterations plus a quarter of the widest width per tile beyond
    the first (the reference's rule; ties go to the wider)."""
    mb = max(widths)
    best = None
    for w in sorted(widths, reverse=True):
        ntiles = -(-u // w)
        cost = ntiles * w + 0.25 * mb * (ntiles - 1)
        if best is None or cost < best[0]:
            best = (cost, w)
    return best[1]


def tiles(idx, widths):
    """The fibers ``idx`` (a long tensor) in tiles of one width of
    ``widths``: (sel, n) pairs, ``sel`` the tile's fibers with the last
    tile padded by repeating its last fiber, ``n`` the real ones."""
    u = idx.numel()
    w = tile_width(u, widths)
    out = []
    for lo in range(0, u, w):
        sel = idx[lo:lo + w]
        n = sel.numel()
        if n < w:
            sel = torch.cat([sel, sel[-1:].expand(w - n)])
        out.append((sel, n))
    return out


def _static_arm(arm, width):
    """An ArmState of empty buffers: ``width`` fibers, shapes as ``arm``."""
    new = {f: torch.empty((width,) + tuple(getattr(arm, f).shape[1:]),
                          dtype=getattr(arm, f).dtype,
                          device=getattr(arm, f).device)
           for f in PER_FIBER}
    new.update({f: None if getattr(arm, f) is None
                else torch.empty_like(getattr(arm, f)) for f in SHARED})
    if arm.band is not None:
        b = arm.band.bands
        new['band'] = BandedMatrix(arm.band.offsets, torch.empty(
            (width,) + tuple(b.shape[1:]), dtype=b.dtype, device=b.device))
    return dataclasses.replace(arm, **new)


def _fill_arm(static, arm, sel):
    for f in PER_FIBER:
        torch.index_select(getattr(arm, f), 0, sel, out=getattr(static, f))
    for f in SHARED:
        if getattr(arm, f) is not None:
            getattr(static, f).copy_(getattr(arm, f))
    if arm.band is not None:
        torch.index_select(arm.band.bands, 0, sel, out=static.band.bands)


def _arm_key(arm):
    shapes = tuple(None if getattr(arm, f) is None
                   else tuple(getattr(arm, f).shape[1:] if f in PER_FIBER
                              else getattr(arm, f).shape)
                   for f in PER_FIBER + SHARED)
    band = None if arm.band is None else (tuple(arm.band.offsets),
                                          tuple(arm.band.bands.shape[1:]))
    return (arm.name, arm.setup, arm.dvec.dtype, shapes, band)


def _mapper_key(mapper):
    """What ParamMapper.unpack bakes in as constants."""
    vm = mapper.vsiniMapper
    return (mapper.specParams, mapper.fixParam, mapper.fitVsini,
            tuple(float(mapper.paramDict0[p]) for p in mapper.fixParam
                  if p in mapper.paramDict0),
            None if vm is None else (vm.min_vsini, vm.max_vsini))


class IterationGraph:
    """One Nelder-Mead iteration on a tile of ``width`` fibers as a CUDA
    graph (module docstring).  ``make_fun(arms)`` builds the objective
    on the graph's own arm buffers."""

    def __init__(self, width, arms, make_fun, nvec, scheme, fatol):
        dev = arms[0].dvec.device
        self.width, self.scheme, self.fatol = width, scheme, fatol
        self.arms = [_static_arm(a, width) for a in arms]
        self.fun = make_fun(self.arms)
        z = lambda *shape, dtype=torch.float64: torch.zeros(
            shape, dtype=dtype, device=dev)
        np1 = nvec + 1
        # the tile's state, updated in place by each replay
        self.state = (z(width, np1, nvec), z(width, np1),
                      z(width, dtype=torch.bool))
        self.xatol = z(nvec)
        # what the shrink needs: the iteration's inputs, _propose's
        # results, and the flags [any live shrink, live count]
        self.saved = (z(width, np1, nvec), z(width, np1),
                      z(width, dtype=torch.bool))
        self.proposed = (z(width, np1, nvec), z(width, np1),
                         z(width, dtype=torch.bool), z(width, nvec))
        self.flags = z(2, dtype=torch.long)
        self.graph = None
        self.launches = []

    def _body(self, state, saved, proposed, flags):
        """One iteration on ``state`` in place (the graph's work)."""
        simplex, fvals, done = state
        prop = nm._propose(self.fun, simplex, fvals, self.scheme)
        new = nm._finish(simplex, fvals, done, prop[0], prop[1],
                         self.fatol, self.xatol)
        live_shrink = (prop[2] & ~done).any()
        for dst, src in zip(saved, state):
            dst.copy_(src)
        for dst, src in zip(proposed, prop):
            dst.copy_(src)
        for dst, src in zip(state, new):
            dst.copy_(src)
        flags.copy_(torch.stack([live_shrink.long(), (~new[2]).sum()]))

    def capture(self, stream, pool):
        """Warm up on copies of the buffers (on ``stream``), then
        capture :meth:`_body` into the graph, holding the kernel
        launches' counts and events for :meth:`replay`."""
        dev = self.flags.device
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            for _ in range(WARMUP):
                self._body(*[tuple(t.clone() for t in group) for group in
                             (self.state, self.saved, self.proposed)],
                           self.flags.clone())
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        # one capture at a time in the process: torch.cuda.graph
        # synchronizes the device as it begins, which a capture running
        # on another thread (a second shard on the card) does not permit
        with _capture_lock, trace.deferred() as held:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode='thread_local'):
                self._body(self.state, self.saved, self.proposed,
                           self.flags)
        self.graph, self.launches = graph, held
        trace.count('fit.nm.graph_captures')

    def load(self, arms, sel, n, simplex, fvals, done, xatol):
        """Fill the buffers with the fibers ``sel`` (long tensor of
        ``width``, the first ``n`` real and, as NM's rounds take them,
        not converged): their arm rows, simplexes, values and mask, the
        pad rows converged."""
        for static, arm in zip(self.arms, arms):
            _fill_arm(static, arm, sel)
        for dst, src in zip(self.state, (simplex, fvals, done)):
            torch.index_select(src, 0, sel, out=dst)
        self.state[2][n:] = True
        self.xatol.copy_(xatol)

    def store(self, sel, n, simplex, fvals, done):
        """Write the real rows back into the fitter's state."""
        real = sel[:n]
        for dst, src in zip((simplex, fvals, done), self.state):
            dst[real] = src[:n]

    def replay(self):
        """One iteration: replay, the launches' counts and events, then
        the one read of the device -> (any live shrink, live count)."""
        self.graph.replay()
        trace.count('fit.nm.graph_replays')
        trace.replay(self.launches)
        shrink, live = self.flags.tolist()
        return bool(shrink), live

    def shrink(self):
        """The iteration just replayed, redone with its shrink: from its
        saved inputs and proposal, eagerly (one objective call) ->
        the live count."""
        simplex, fvals, done = self.saved
        upd = nm._shrink(self.fun, simplex, *self.proposed)
        trace.count('fit.nm.eager_calls')
        new = nm._finish(simplex, fvals, done, *upd, self.fatol,
                         self.xatol)
        for dst, src in zip(self.state, new):
            dst.copy_(src)
        return int((~new[2]).sum())

    def step(self):
        """One iteration on the loaded tile (neldermead.iterate's step):
        :meth:`replay`, then :meth:`shrink` where a live instance
        shrinks -> the live count."""
        shrink, live = self.replay()
        return self.shrink() if shrink else live


_ladders = collections.OrderedDict()
_pools = {}
_lock = threading.Lock()
_capture_lock = threading.Lock()


def graphs(arms, mapper, priors, kw, make_fun, widths, nvec,
           scheme, fatol, state):
    """{width: IterationGraph} for ``widths``, from the process's cache,
    or built, warmed up and captured now, all widths together, on the
    first rows of the fitter's ``state`` (simplex, fvals, done, xatol).
    ``kw`` are fit/batch.trial_objective's keywords and
    ``make_fun(arms)`` builds the objective on a graph's arm buffers."""
    dev = arms[0].dvec.device
    thread = threading.current_thread().name
    key = (thread, str(dev), scheme, nvec, float(fatol), tuple(widths),
           tuple((s, id(tm)) for s, tm in sorted(kw['templates'].items())),
           tuple(_arm_key(a) for a in arms), bool(kw['use_vsini']),
           tuple(sorted(kw['half_widths'].items())), float(kw['min_vel']),
           float(kw['max_vel']), float(kw['badchi']), _mapper_key(mapper),
           tuple(prior_rows(mapper.specParams, priors)))
    with _lock:
        entry = _ladders.get(key)
        if entry is not None:
            _ladders.move_to_end(key)
            return entry[0]
        if (str(dev), thread) not in _pools:
            _pools[str(dev), thread] = (torch.cuda.graph_pool_handle(),
                                        torch.cuda.Stream(dev))
        pool, stream = _pools[str(dev), thread]
    built = {}
    simplex = state[0]
    for w in widths:
        g = built[w] = IterationGraph(w, arms, make_fun, nvec, scheme,
                                      fatol)
        # the rows make the warm-up's work real; the graph keeps only
        # the buffers' addresses
        (sel, n), = tiles(torch.arange(min(w, simplex.shape[0]),
                                       device=dev), [w])
        g.load(arms, sel, n, *state)
        g.capture(stream, pool)
    with _lock:
        # the templates and mapper are held so that their ids stay theirs
        _ladders[key] = (built, kw['templates'], mapper)
        while len(_ladders) > MAX_LADDERS:
            _ladders.popitem(last=False)
    return built
