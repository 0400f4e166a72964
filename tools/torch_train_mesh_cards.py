#!/usr/bin/env python3
"""Time the NN trainer on (data, model) grids of the host's cards.

Usage (from the root of a checkout, on a machine with CUDA cards):

    python3 tools/torch_train_mesh_cards.py [--templates 2000]
        [--epochs 2] [--repeats 2]

Trains pipeline/train_nn.train_interpolator at the reference CLI's
widths (chip_smoke.TRAIN: 256 wide, 2 hidden layers, npc 64, batch 100,
float64) on a ``--templates`` subset of chip_smoke.py's 24,960-template
training set, for ``--epochs`` epochs from one init_state draw:
unsharded on card 0, then on every grid parallel/mesh.make_grid lays
over the host: (D, M) for each D * M = n, n the powers of two up to
torch.cuda.device_count(); on a one-card host, the card named four
times as a (2, 2) grid.  Each configuration first trains one epoch on
WARM_TEMPLATES templates (the cards' libraries and handles up), then
runs ``--repeats`` rounds, the order reversed every other round.
Prints per run the s/epoch, each card's peak memory and the folded
weights' largest difference from the first unsharded run (relative to
each array's largest entry; the limit is chip_smoke.TRAIN_CMP's 1e-9),
then one JSON line of every run.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

WARM_TEMPLATES = 200


def grids():
    """{name: (shape, devices) or None (unsharded)} of this host."""
    import torch
    n = torch.cuda.device_count()
    out = {'one card': None}
    if n < 2:
        out['(2, 2) on card 0'] = ((2, 2), ['cuda:0'] * 4)
    k = 2
    while k <= n:
        d = 1
        while d <= k:
            out[f'({d}, {k // d}) on {k} cards'] = (
                (d, k // d), [f'cuda:{i}' for i in range(k)])
            d *= 2
        k *= 2
    return out


def train(x, specs, epochs, grid):
    """One run on ``grid`` (None: card 0): (model, numbers)."""
    import torch
    from rvspecfit_torch.parallel import mesh as pmesh
    from rvspecfit_torch.pipeline import train_nn
    ncards = torch.cuda.device_count()
    for d in range(ncards):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    mesh = None if grid is None else pmesh.make_grid(grid[1], grid[0])
    t0 = time.perf_counter()
    model, hist = train_nn.train_interpolator(
        x, specs, device=torch.device('cuda', 0), mesh=mesh,
        **dict(cs.TRAIN, num_epochs=epochs))
    for d in range(ncards):
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    return model, dict(s_per_epoch=wall / epochs, loss=hist['loss'],
                       peak_gb=[torch.cuda.max_memory_allocated(d) / 1e9
                                for d in range(ncards)])


def main():
    import torch
    from rvspecfit_torch.interp import nn
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--templates', type=int, default=2000)
    parser.add_argument('--epochs', type=int, default=2)
    parser.add_argument('--repeats', type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('torch_train_mesh_cards: no CUDA card', file=sys.stderr)
        return 2
    print(cs.environment())
    _, x, specs, _ = cs.training_set()
    sub = np.random.RandomState(3).permutation(len(x))[:args.templates]
    x, specs = x[sub], specs[sub]
    configs = grids()
    names = list(configs)
    for name in names:
        _, r = train(x[:WARM_TEMPLATES], specs[:WARM_TEMPLATES], 1,
                     configs[name])
        print(f'{name:>20} warm-up ({WARM_TEMPLATES} templates, 1 epoch): '
              f'{r["s_per_epoch"]:.3f} s', flush=True)
    results, want, worst = [], None, 0.0
    for rnd in range(args.repeats):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            model, r = train(x, specs, args.epochs, configs[name])
            state = nn.state_to_dict(model)
            if want is None and configs[name] is None:
                want = state
            r['max_rel_dweight'] = None if want is None else max(
                float(np.abs(state[k] - w).max() / np.abs(w).max())
                for k, w in want.items()
                if isinstance(w, np.ndarray) and np.abs(w).max() > 0)
            if r['max_rel_dweight'] is not None:
                worst = max(worst, r['max_rel_dweight'])
            results.append(dict(config=name, round=rnd, **r))
            print(f'{name:>20} round {rnd}: {r["s_per_epoch"]:.4f} s/epoch; '
                  f'peak GB per card {[round(p, 2) for p in r["peak_gb"]]}; '
                  f'weights vs unsharded {r["max_rel_dweight"]}', flush=True)
    limit = cs.TRAIN_CMP['rtol']
    print(f'largest weight difference from the unsharded run {worst:.3g} '
          f'(limit {limit})')
    print(json.dumps(results))
    return 0 if worst <= limit else 1


if __name__ == '__main__':
    sys.exit(main())
