"""Merging independent nested-sampling runs via birth/death contours.

Combining K independent runs of the same problem into one run with
sum-of-nlive live points (Higson et al. 2019 / anesthetic's algorithm):
each sample carries its *birth* contour (the likelihood threshold it was
sampled above) and its *death* likelihood; at any likelihood level L the
merged live-point count is

    n(L) = #{ i : birth_i < L <= death_i }

and the merged volume shrinks by E[d ln X] = -1/n(L_i) at each death,
processed in increasing-death order.  This gives sqrt(K)-smaller evidence
errors and a denser posterior -- and fits the device-fleet model perfectly:
``parallel.fit_many`` the same problem with K seeds across the mesh, then
merge.  (This also reproduces each run's own bookkeeping when applied to a
single run, which is the invariant test.)

It is the foundation the reference's dyPolyChord role maps onto: instead of
dynamically re-allocating live points inside one run, allocate more
*independent runs* where the posterior needs them and merge.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from mcalf_tpu.sampler.nested import NSResults

__all__ = ["MergedRun", "merge_results", "nlive_of_logl"]


class MergedRun(NamedTuple):
    logz: float
    logzerr: float
    h: float
    samples_u: np.ndarray            # (N, ndim)
    logl: np.ndarray                 # (N,)
    logw: np.ndarray                 # (N,) log prior-mass weights
    log_posterior_weights: np.ndarray
    nlive_at_death: np.ndarray       # (N,) merged live counts


def _extract(res: NSResults):
    logw = np.asarray(res.logw, np.float64)
    valid = np.isfinite(logw)
    return (
        np.asarray(res.samples_u, np.float64)[valid],
        np.asarray(res.logl, np.float64)[valid],
        np.asarray(res.birth_logl, np.float64)[valid],
    )


def _simulated_logzerr(
    logl: np.ndarray, nlive: np.ndarray, ndraw: int = 64, seed: int = 7
) -> float:
    """Std of logZ over ``ndraw`` re-simulations of the stochastic
    shrinkage d ln X_i = -Exp(1)/n_i (deaths already sorted ascending in
    ``logl``; ``nlive`` the live count at each death)."""
    n = logl.size
    if n == 0:
        return 0.0
    rng = np.random.default_rng(seed)
    # (ndraw, n) exponential shrinkage draws; cumsum along deaths.
    e = rng.exponential(size=(ndraw, n))
    logx = np.cumsum(-e / nlive[None, :], axis=1)
    logx_prev = np.concatenate(
        [np.zeros((ndraw, 1)), logx[:, :-1]], axis=1
    )
    with np.errstate(divide="ignore"):
        logw = logx_prev + np.log1p(-np.exp(logx - logx_prev))
    lw = logw + logl[None, :]
    m = lw.max(axis=1, keepdims=True)
    logz = m[:, 0] + np.log(np.exp(lw - m).sum(axis=1))
    return float(np.std(logz))


def merge_results(runs: Sequence[NSResults]) -> MergedRun:
    """Merge K independent NSResults of the SAME problem into one weighted
    run (host-side float64)."""
    us, logls, births = [], [], []
    for r in runs:
        u, l, b = _extract(r)
        us.append(u)
        logls.append(l)
        births.append(b)
    u = np.concatenate(us, axis=0)
    logl = np.concatenate(logls)
    birth = np.concatenate(births)

    order = np.argsort(logl, kind="stable")
    u, logl, birth = u[order], logl[order], birth[order]
    n = logl.size

    # Merged live count at each death: points born strictly below this
    # likelihood and dying at or above it.  births and deaths are both
    # sorted-insertable; compute with searchsorted on the death order.
    # died_before[i] = # deaths with logl < logl[i]  (deaths are sorted)
    died_before = np.searchsorted(logl, logl, side="left")
    # born_before[i] = # births with birth < logl[i]
    birth_sorted = np.sort(birth)
    born_before = np.searchsorted(birth_sorted, logl, side="left")
    nlive = born_before - died_before
    # Ties at identical logl (e.g. -inf rejections) can zero this; floor at 1.
    nlive = np.maximum(nlive, 1)

    # Volume bookkeeping: d ln X_i = -1/n_i; w_i = X_{i-1} - X_i.
    dlogx = -1.0 / nlive
    logx = np.cumsum(dlogx)
    logx_prev = np.concatenate([[0.0], logx[:-1]])
    with np.errstate(divide="ignore"):
        logw = logx_prev + np.log1p(-np.exp(logx - logx_prev))

    finite = np.isfinite(logl)
    lw = np.where(finite, logw + logl, -np.inf)
    m = lw.max()
    logz = m + np.log(np.exp(lw - m).sum())
    log_post = lw - logz
    p = np.exp(log_post)
    h = float(np.sum(np.where(finite, p * logl, 0.0)) - logz)
    # Evidence error by SIMULATED WEIGHTS (Higson et al. 2018, the
    # nestcheck/anesthetic method): the only stochastic element of the NS
    # estimate is the shrinkage itself, d ln X_i = -E_i / n_i with
    # E_i ~ Exp(1) iid.  Redraw the full shrinkage sequence K times,
    # recompute logZ under each draw, and take the standard deviation.
    # Exact for ANY nlive(L) profile -- unlike sqrt(H/nlive), which assumes
    # constant nlive and has no defensible "nlive" for a merged/boosted run
    # (validated against repeat-run scatter in tests/test_dynamic.py).
    logzerr = float(_simulated_logzerr(logl[finite], nlive[finite]))

    return MergedRun(
        logz=float(logz),
        logzerr=logzerr,
        h=h,
        samples_u=u,
        logl=logl,
        logw=logw,
        log_posterior_weights=log_post,
        nlive_at_death=nlive,
    )


def nlive_of_logl(run: MergedRun, logl_grid: np.ndarray) -> np.ndarray:
    """Merged live-point count evaluated on a likelihood grid (diagnostic:
    the reference ecosystem's nlive(logL) plots)."""
    idx = np.searchsorted(run.logl, logl_grid, side="left")
    idx = np.clip(idx, 0, run.nlive_at_death.size - 1)
    return run.nlive_at_death[idx]
