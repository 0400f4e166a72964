"""The comparison that decides ``correct``: each sampled answer of the
window against the plain reference (benchlib/reference.py and
benchlib/reference_ccf.py), by the numbers below, each held to its
limit in ``limits/<workload>.json``.  Each number is the worst over the
judged answers.

* ``missing``: sampled answers that never came or are not finite
  (limit 0);
* ``chi2_gap``: the largest gap between the chi-square the program
  reported and the reference's at the program's own answer, relative to
  the larger of the reference's value and the number of good pixels;
* ``model_gap``: the largest gap between a best-fit model the program
  reported and the reference's at that answer, relative to the
  model's largest value;
* ``vel_gap``: how far, in standard deviations, the reference's -2 log
  L in velocity puts its minimum from the program's velocity (one
  Newton step from central differences, |g| / sqrt(2 H));
* ``param_gap``: the most by which a step of +-delta along one of the
  four stellar parameters or vsini (``limits['param_steps']``; Teff
  relative, vsini in km/s, where the fit models rotation) from the
  program's answer lowers the reference's -2 log L (negative where the
  answer is a minimum along each of them at that scale); a step that
  leaves the grid's node range or vsini's bounds is not taken;
* ``err_gap``: the largest relative gap between an error the program
  reported and the reference's: the velocity's posterior r.m.s. on a
  fine grid (where it is at least twice the configuration's
  min_vel_step, which the refinement's last grid may take), and the
  four parameters' from the inverse of the reference's Hessian of
  (-2 log L) / 2 by central differences inside the answer's grid cell
  (not where the answer lies outside the grid or too near a node for
  the steps, or where the Hessian is not positive definite with its
  correlation matrix's least eigenvalue over ``min_eig``);
* ``ccf_vel_gap``: the gap (km/s) between the CCF velocity the program
  reported and the reference CCF's against the bank template the
  program's CCF chose (infinite where that is not a grid node);
* ``ccf_chi_gap``: the gap between the CCF's chi-square and the
  reference's, relative to the spectrum's sum(flux^2 ivar) on the CCF
  grid.

Beside them the per-answer record (``per_answer`` of harness.run) keeps
``err_vel`` and ``err_par``, the two parts of ``err_gap``, and
``param_step``, the step that lowered -2 log L most.
"""
import numpy as np

from benchlib import generator, reference, reference_ccf

HESS_STEP = 0.01     # of the answer's grid cell, on each axis
RESOLVED = 2.0       # posterior r.m.s. over min_vel_step judged
NUMBERS = ('missing', 'chi2_gap', 'model_gap', 'vel_gap', 'param_gap',
           'err_gap', 'ccf_vel_gap', 'ccf_chi_gap')


def judge(ctx, answers, arms):
    """({number: {value, limit}}, count of answers that failed any
    limit, {number: per-answer values (NaN: not judged)}) of
    ``answers`` (dicts: row, vel, params (4,), vsini, use_vsini,
    chisq_kind, chisq, models [per arm]; optional vel_err, param_errs
    (4,), ccf_vel, ccf_chisq, ccf_params (4,), ccf_vsini; or no vel
    where the answer never came)."""
    lim = ctx.cell.limits
    where = [i for i, a in enumerate(answers) if a.get('vel') is not None
             and np.isfinite(a['vel']) and np.all(np.isfinite(a['params']))
             and np.isfinite(a['chisq'])]
    per = {k: np.full(len(answers), np.nan) for k in NUMBERS}
    per['missing'][:] = 1.0
    per['missing'][where] = 0.0
    if where:
        _fill(ctx, [answers[i] for i in where], arms, lim, per, where)
    checks = {k: dict(value=_worst(per[k]), limit=float(lim[k]))
              for k in NUMBERS}
    if not answers:
        checks['missing'] = dict(value=1.0, limit=float(lim['missing']))
    bad = np.zeros(len(answers), bool)
    for k in NUMBERS:
        bad |= np.nan_to_num(per[k], nan=-np.inf) > lim[k]
    return checks, int(bad.sum()), per


def _worst(vals):
    """The largest judged value (NaN: not judged), finite for JSON: an
    infinite gap reads 1e300; none judged reads -1e300."""
    vals = vals[~np.isnan(vals)]
    if not len(vals):
        return -1e300
    return float(np.clip(vals.max(), -1e300, 1e300))


def _fill(ctx, got, arms, lim, per, where):
    fitcfg = ctx.cell.config['fit']
    rows = np.array([a['row'] for a in got])
    vels = np.array([a['vel'] for a in got], np.float64)
    params = np.array([a['params'] for a in got], np.float64)
    vsinis = np.array([a.get('vsini') or 0.0 for a in got], np.float64)
    use_vsini = bool(got[0]['use_vsini'])
    ev = lambda v, p, w=vsinis: reference.evaluate(  # noqa: E731
        arms, rows, v, p, w, use_vsini)[0].cpu().numpy()
    m2ll, chi2, models = reference.evaluate(arms, rows, vels, params,
                                            vsinis, use_vsini)
    m2ll, chi2 = m2ll.cpu().numpy(), chi2.cpu().numpy()
    npix = sum(a.good[rows].sum(1) for a in arms).cpu().numpy()
    for j, (i, a) in enumerate(zip(where, got)):
        want = m2ll[j] if a['chisq_kind'] == 'm2logl' else chi2[j]
        # -2 log L can lie near 0 (its log-sigma terms cancel the rest):
        # the gap is taken against the larger of it and the pixels fitted
        per['chi2_gap'][i] = abs(a['chisq'] - want) / max(abs(want),
                                                          npix[j])
        gaps = [0.0]
        for am, rm in zip(a['models'], models):
            rm = rm[j].cpu().numpy()
            gaps.append(np.abs(np.asarray(am, np.float64) - rm).max()
                        / np.abs(rm).max())
        per['model_gap'][i] = max(gaps)

    h = float(lim['vel_step'])
    lp, lm = ev(vels + h, params), ev(vels - h, params)
    g = (lp - lm) / (2 * h)
    curv = (lp - 2 * m2ll + lm) / h**2
    with np.errstate(divide='ignore', invalid='ignore'):
        vgap = np.where(curv > 0, np.abs(g) / np.sqrt(2 * np.abs(curv)),
                        np.inf)
    steps = lim['param_steps']
    lows = []
    grid = arms[0].grid
    for k, name in enumerate(generator.PARNAMES):
        u = grid.u[k].cpu().numpy()
        for sign in (1.0, -1.0):
            p2 = params.copy()
            if name == 'teff':
                p2[:, 0] *= 1 + sign * steps['teff']
                q = np.log10(p2[:, 0])
            else:
                p2[:, k] += sign * steps[name]
                q = p2[:, k]
            # a step out of the grid's node range meets the outside-grid
            # penalty's wall: only steps inside are taken
            lows.append(np.where((q >= u[0]) & (q <= u[-1]),
                                 ev(vels, p2), np.inf))
    if use_vsini:
        for sign in (1.0, -1.0):
            w2 = vsinis + sign * steps['vsini']
            inside = (w2 >= fitcfg['min_vsini']) & \
                (w2 <= fitcfg['max_vsini'])
            lows.append(np.where(inside, ev(vels, params,
                                            np.clip(w2, 0, None)), np.inf))
    pgap = m2ll - np.min(np.array(lows), axis=0)
    # which step lowered most: 2 k for +delta along PARNAMES[k], 2 k + 1
    # for -delta, 8 and 9 for vsini
    per['param_step'] = np.full(len(per['missing']), np.nan)
    for j, i in enumerate(where):
        per['vel_gap'][i] = vgap[j]
        per['param_gap'][i] = pgap[j]
        per['param_step'][i] = np.argmin(np.array(lows)[:, j])

    if 'vel_err' in got[0]:
        diag = {}
        egap = _errors(arms, rows, vels, params, vsinis, use_vsini, curv,
                       got, lim, float(fitcfg['min_vel_step']), diag)
        for k in diag:
            per[k] = np.full(len(per['missing']), np.nan)
        for j, i in enumerate(where):
            per['err_gap'][i] = egap[j]
            for k, v in diag.items():
                per[k][i] = v[j]
    if 'ccf_vel' in got[0] and all(getattr(a, 'ccf', None) for a in arms):
        vg, cg = _ccf(arms, got, fitcfg)
        for j, i in enumerate(where):
            per['ccf_vel_gap'][i] = vg[j]
            per['ccf_chi_gap'][i] = cg[j]


def _errors(arms, rows, vels, params, vsinis, use_vsini, curv, got, lim,
            min_vel_step, diag):
    """Per answer, the largest relative gap of its errors (and in
    ``diag`` the velocity's and the parameters' apart)."""
    judged = curv > 0
    sig0 = np.sqrt(2 / np.where(judged, curv, 1.0))
    ref_v = reference.velocity_error(arms, rows, vels, params, vsinis,
                                     use_vsini, sig0)
    prog_v = np.array([a['vel_err'] for a in got])
    # the refinement's last grid may be as coarse as min_vel_step: its
    # r.m.s. is the posterior's only where that resolves the posterior
    resolved = judged & (ref_v >= RESOLVED * min_vel_step)
    gap = np.where(resolved, np.abs(prog_v - ref_v) / ref_v, np.nan)
    gap = np.where(judged, gap, np.inf)
    diag['err_vel'] = gap.copy()
    diag['err_par'] = np.full(len(got), np.nan)

    # steps of 1% of the cell, and at most 0.45 of the distance to its
    # nearest node (in log10 Teff for Teff), so that every point lies
    # in the answer's cell, where the interpolation is smooth; an answer
    # closer to a node than a tenth of that is not judged (its steps
    # would be lost in round-off)
    grid = arms[0].grid
    q = params.copy()
    q[:, 0] = np.log10(q[:, 0])
    hq = np.empty_like(q)
    inside = np.ones(len(got), bool)
    for k in range(4):
        u = grid.u[k].cpu().numpy()
        j = np.clip(np.searchsorted(u, q[:, k], side='right') - 1, 0,
                    len(u) - 2)
        dist = np.minimum(q[:, k] - u[j], u[j + 1] - q[:, k])
        hq[:, k] = np.minimum(HESS_STEP * (u[j + 1] - u[j]), 0.45 * dist)
        inside &= hq[:, k] >= 0.1 * HESS_STEP * (u[j + 1] - u[j])
    steps = hq.copy()
    steps[:, 0] = params[:, 0] * (10**hq[:, 0] - 1)
    steps = np.where(inside[:, None], steps, 1.0)
    hes = reference.param_hessian(arms, rows, vels, params, vsinis,
                                  use_vsini, steps)
    prog_p = np.array([a['param_errs'] for a in got], np.float64)
    for j in range(len(got)):
        if not inside[j]:
            continue
        d = np.sqrt(np.abs(np.diag(hes[j])))
        if not np.all(d > 0):
            continue
        corr = hes[j] / np.outer(d, d)
        if np.linalg.eigvalsh(corr).min() <= lim['min_eig']:
            continue
        ref_p = np.sqrt(np.diag(np.linalg.inv(hes[j])))
        with np.errstate(invalid='ignore'):
            pg = np.abs(prog_p[j] - ref_p) / ref_p
        diag['err_par'][j] = np.nan_to_num(pg, nan=np.inf).max()
        gap[j] = np.fmax(gap[j], diag['err_par'][j])
    return gap


def _ccf(arms, got, fitcfg):
    """Per answer, the CCF velocity's gap (km/s) and the chi-square's
    relative gap."""
    cp = np.array([a['ccf_params'] for a in got], np.float64)
    cv = np.array([a['ccf_vsini'] for a in got], np.float64)
    grid = arms[0].grid
    node = np.ones(len(got), bool)
    for k in range(4):
        u = grid.u[k].cpu().numpy()
        q = np.log10(cp[:, k]) if k == 0 else cp[:, k]
        near = np.abs(q[:, None] - u[None]).min(1)
        node &= near <= 1e-9 * np.abs(u).max()
    vel, chi, sse = reference_ccf.ccf_answer(
        [a.ccf for a in arms], cp, cv, float(fitcfg['max_vel']),
        float(fitcfg['vel_step0']))
    pv = np.array([a['ccf_vel'] for a in got])
    pc = np.array([a['ccf_chisq'] for a in got])
    vg = np.where(node, np.abs(pv - vel), np.inf)
    cg = np.where(node, np.abs(pc - chi) / sse, np.inf)
    return vg, cg
