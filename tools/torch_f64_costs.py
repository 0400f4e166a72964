#!/usr/bin/env python3
"""What float64 costs the library calls of the fit on one card: each
timed in float32 and float64 at the main path's shapes, in the order
float32, float64, float64, float32.

Usage (from the root of a checkout, on a machine with one NVIDIA card):

    python3 tools/torch_f64_costs.py

* ops/spline.BandCorrelation (F.conv1d of the spline solve's banded
  inverse, PyTorch's or cuDNN's convolution), forward and its backward,
  on the template stage's (rows, 4094) at 1000 and 5000 rows;
* ops/spline.spline_coeffs, the whole spline solve around it;
* ops/chisq.chol_solve_logdet, the batched 10 x 10 Cholesky of the
  continuum-marginalized chi-square, at 3000 and 30000 matrices;
* torch.fft.rfft / irfft of the CCF's (1000, 4096) rows (cuFFT);
* one template stage (interpolation, spline solve) of 1000 trials.

Prints one line per call and, last, a JSON object with the card.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

FORMS = ('float32', 'float64')


def cases(device):
    """{name: {form: fn()}} at the path's shapes."""
    import numpy as np
    import torch
    from rvspecfit_torch.fit.likelihood import template_stage
    from rvspecfit_torch.ops import chisq, spline
    rng = np.random.RandomState(0)
    out = {}
    for form in FORMS:
        dt = getattr(torch, form)
        tm = chip_smoke.make_template_model(device, dtype=dt)
        geom = tm.geom
        to = lambda a: torch.as_tensor(a, dtype=dt, device=device)
        for rows in (1000, 5000):
            x = to(rng.normal(size=(rows, geom.n - 2)))
            xg = x.clone().requires_grad_(True)
            y = spline.BandCorrelation.apply(xg, geom.inv_kernel)
            g = torch.ones_like(y)
            out.setdefault(f'BandCorrelation forward ({rows}, {geom.n - 2})',
                           {})[form] = lambda x=x, geom=geom: \
                spline.BandCorrelation.apply(x, geom.inv_kernel)
            out.setdefault(f'BandCorrelation backward ({rows}, '
                           f'{geom.n - 2})', {})[form] = \
                lambda y=y, xg=xg, g=g: torch.autograd.grad(
                    y, xg, g, retain_graph=True)[0]
            ys = to(1.0 + rng.normal(size=(rows, geom.n)).cumsum(1) / 300)
            out.setdefault(f'spline_coeffs ({rows}, {geom.n})', {})[form] = \
                lambda ys=ys, geom=geom: spline.spline_coeffs(geom, ys)
        for n in (3000, 30000):
            a = rng.normal(size=(n, 10, 12))
            m = to(a @ a.transpose(0, 2, 1) + np.eye(10))
            v = to(rng.normal(size=(n, 10)))
            out.setdefault(f'chol_solve_logdet ({n}, 10, 10)', {})[form] = \
                lambda m=m, v=v: chisq.chol_solve_logdet(m, v)
        s = to(rng.normal(size=(1000, 4096)))
        f = torch.fft.rfft(s, dim=1)
        out.setdefault('rfft (1000, 4096)', {})[form] = \
            lambda s=s: torch.fft.rfft(s, dim=1)
        out.setdefault('irfft (1000, 2049)', {})[form] = \
            lambda f=f: torch.fft.irfft(f, n=4096, dim=1)
        params = to(np.column_stack([rng.uniform(4500, 9500, 1000),
                                     rng.uniform(1, 4.8, 1000),
                                     rng.uniform(-1.9, -0.1, 1000),
                                     rng.uniform(0.05, 0.95, 1000)]))
        out.setdefault('template_stage (1000 trials, 4096 px)', {})[form] = \
            lambda tm=tm, params=params: template_stage(tm, params, None,
                                                        False, None)[0]
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('torch_f64_costs: no CUDA device', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    smi = chip_smoke.environment()
    rows = []
    for name, fns in cases(device).items():
        t = {form: [] for form in FORMS}
        for form in FORMS + FORMS[::-1]:
            t[form].append(chip_smoke.cuda_time(fns[form], 10))
        ms = {form: sum(v) / len(v) for form, v in t.items()}
        rows.append(dict(call=name, ms=ms, runs=t,
                         ratio=ms['float64'] / ms['float32']))
        chip_smoke.log(f'{name}: float32 {ms["float32"]:.4f} ms, float64 '
                       f'{ms["float64"]:.4f} ms, ratio '
                       f'{ms["float64"] / ms["float32"]:.2f}')
    print(json.dumps(dict(card=smi, calls=rows)))
    return 0


if __name__ == '__main__':
    sys.exit(main())
