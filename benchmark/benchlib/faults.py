"""Faults planted in the program's timed path, to show that the
comparison fails them (benchmark/tests/test_bench_faults.py on the CPU,
benchmark/fault.py on the card).  Each is a list of mock patches:

* ``stuck``: the fit returns its state unchanged (the batched fitter's
  Nelder-Mead and polish hand back their start; for one object,
  process's Nelder-Mead and BFGS);
* ``half``: half of each group left out, its answers those of the other
  half (a batch of one object has no half);
* ``altered``: the velocity altered where it is produced (the
  refinement's best velocity + 3 km/s);
* ``truncated``: the batched Nelder-Mead stopped at 32 of its 384
  iterations (each restart's ``maxiter``), a fit left half converged
  (at 128, most fibres converge first and the polish completes the
  rest: on the card that read like sound runs, PERF.md);
* ``ccf``: the CCF's chi-squares (kernel B's output) shifted by one
  velocity of its grid, a CCF answer altered where it is produced.

No cell runs on more than one card, so no exchange between cards can be
left out.
"""
from unittest import mock

import numpy as np
import torch

ALTER_KMS = 3.0
TRUNCATED_ITERS = 32           # of run_neldermead's 384


def _stuck_nm(self, mapper, best_vel0=None, priors=None, x0=None, **kw):
    x0 = np.asarray(x0, np.float64)
    return dict(x=x0, fun=np.full(len(x0), np.inf),
                converged=np.ones(len(x0), bool), obj_evals=0)


def _stuck_polish(self, mapper, x, priors=None, steps=None, fun0=None):
    x = np.asarray(x, np.float64)
    return dict(x=x, fun=np.asarray(fun0), moved=np.zeros(len(x), bool))


def _half(real):
    def run(self, *a, **kw):
        out = real(self, *a, **kw)
        h = len(out['x']) // 2
        out['x'][h:2 * h] = out['x'][:h]
        return out
    return run


def _altered(real):
    def refine(self, *a, **kw):
        out = real(self, *a, **kw)
        out['best_vel'] = out['best_vel'] + ALTER_KMS
        return out
    return refine


def _truncated(real):
    def run(self, *a, **kw):
        return real(self, *a, **dict(kw, maxiter=TRUNCATED_ITERS))
    return run


def _ccf_shifted(real):
    def ccf_chisq(*a, **kw):
        return torch.roll(real(*a, **kw), 1, dims=-1)
    return ccf_chisq


def batched(fault):
    """Patches of the batched fitter (survey/desi's group fit)."""
    from rvspecfit_torch.fit.batch import BatchedFitter as BF
    from rvspecfit_torch.ops import ccf_chisq
    return {
        'stuck': lambda: [mock.patch.object(BF, 'run_neldermead', _stuck_nm),
                          mock.patch.object(BF, 'run_polish',
                                            _stuck_polish)],
        'half': lambda: [mock.patch.object(BF, 'run_neldermead',
                                           _half(BF.run_neldermead))],
        'altered': lambda: [mock.patch.object(
            BF, 'refine_velocities', _altered(BF.refine_velocities))],
        'truncated': lambda: [mock.patch.object(
            BF, 'run_neldermead', _truncated(BF.run_neldermead))],
        'ccf': lambda: [mock.patch.object(
            ccf_chisq, 'ccf_chisq', _ccf_shifted(ccf_chisq.ccf_chisq))],
    }[fault]()


def single(fault):
    """Patches of the single-object fit (fit/vel_fit.process)."""
    import scipy.optimize

    from rvspecfit_torch.fit import vel_fit

    def minimize_batch(fun, simplex, **kw):
        b = simplex.shape[0]
        return dict(x=simplex[:, 0],
                    fun=torch.full((b,), 1e300, dtype=torch.float64),
                    converged=torch.ones(b, dtype=torch.bool))

    def minimize(fun, x0, **kw):
        return mock.Mock(fun=np.inf, x=np.asarray(x0))

    real = vel_fit._minimum_sampler

    def altered(*a, **kw):
        v, err, res = real(*a, **kw)
        return v + ALTER_KMS, err, res
    return {
        'stuck': lambda: [mock.patch.object(vel_fit.nm, 'minimize_batch',
                                            minimize_batch),
                          mock.patch.object(scipy.optimize, 'minimize',
                                            minimize)],
        'altered': lambda: [mock.patch.object(vel_fit, '_minimum_sampler',
                                              altered)],
    }[fault]()


def patches(driver, fault):
    """The patches of ``fault`` for a traffic ``driver``'s path."""
    return (batched if driver == 'desi_files' else single)(fault)
