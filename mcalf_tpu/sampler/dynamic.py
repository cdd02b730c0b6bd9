"""Dynamic (posterior-focused) nested sampling via run merging.

The reference offers dyPolyChord's dynamic live-point allocation
(/root/reference/mcalf/cli.py:122-158): after an exploratory run, live
points are concentrated where the posterior mass lives, improving posterior
resolution per likelihood call.  Higson et al. (2019) showed dynamic NS is
equivalent to MERGING nested-sampling runs whose live points are born at a
likelihood threshold inside the posterior bulk -- which is exactly what the
birth-contour merge in :mod:`mcalf_tpu.sampler.merge` computes.  So the
on-device implementation is:

1. run a standard ("base") nested-sampling pass;
2. pick the boost threshold L_init where the cumulative posterior mass
   (from below) crosses ``boost_start_mass`` (dyPolyChord's
   dynamic_goal=1 analogue);
3. draw a fresh live set above L_init: random base samples already above
   the threshold, decorrelated by the same constrained slice engine
   (:func:`mcalf_tpu.sampler.nested.slice_chains`);
4. run a second NS pass from that live set (its shrinkage bookkeeping is
   run-local and never used directly);
5. merge both runs by birth contours: the combined run has
   nlive_base + nlive_boost live points across the posterior bulk, i.e.
   denser posterior samples and a sqrt-ish smaller evidence error there.

Everything device-side stays the static-shape machinery of nested.py; only
threshold selection and the merge run on host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mcalf_tpu.sampler.merge import MergedRun, merge_results
from mcalf_tpu.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    nested_sample,
    slice_chains,
)

__all__ = ["DynamicResults", "dynamic_sample", "posterior_ess"]


class DynamicResults(NamedTuple):
    merged: MergedRun
    base: NSResults
    boost: NSResults
    #: likelihood threshold the boost run was seeded above
    l_init: float


def posterior_ess(log_posterior_weights) -> float:
    """Kish effective sample size of a weighted posterior sample set."""
    logp = np.asarray(log_posterior_weights, np.float64)
    logp = logp[np.isfinite(logp)]
    if logp.size == 0:
        return 0.0
    w = np.exp(logp - logp.max())
    return float(w.sum() ** 2 / (w**2).sum())


def _choose_l_init(base: NSResults, boost_start_mass: float) -> float:
    """Likelihood value below which ``boost_start_mass`` of the posterior
    mass lies (host-side)."""
    logp = np.asarray(base.log_posterior_weights, np.float64)
    logl = np.asarray(base.logl, np.float64)
    valid = np.isfinite(logp)
    logp, logl = logp[valid], logl[valid]
    order = np.argsort(logl)
    w = np.exp(logp[order] - logp.max())
    cum = np.cumsum(w) / w.sum()
    idx = int(np.searchsorted(cum, boost_start_mass))
    idx = min(max(idx, 0), logl.size - 1)
    return float(logl[order][idx])


def _seed_boost_state(
    loglike_batch: Callable,
    key: jax.Array,
    base: NSResults,
    l_init: float,
    cfg: NSConfig,
) -> NSState:
    """Build a decorrelated live set above ``l_init`` from base-run samples.

    Base samples above the threshold are each uniform within their own
    (deeper) contour; using them directly would over-weight the deep
    interior.  Starting chains from them and running the full constrained
    slice engine at threshold l_init re-equilibrates toward
    pi(theta | L > l_init) -- the same approximation quality as every NS
    replacement step (dynesty seeds its batch runs the same way)."""
    cap = int(cfg.max_samples)
    nlive, ndim = cfg.nlive, cfg.ndim
    f32 = jnp.float32

    logl = np.asarray(base.logl, np.float64)
    logw = np.asarray(base.logw, np.float64)
    pool = np.flatnonzero(np.isfinite(logw) & (logl > l_init))
    if pool.size < 2:
        raise ValueError(
            f"only {pool.size} base samples above l_init={l_init}; "
            "lower boost_start_mass"
        )
    rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
    pick = rng.choice(pool, size=nlive, replace=pool.size < nlive)
    u0 = jnp.asarray(np.asarray(base.samples_u)[pick], f32)
    l0 = jnp.asarray(logl[pick], f32)

    key, kc = jax.random.split(key)
    u1, l1, key, n_evals = jax.jit(slice_chains, static_argnums=(0, 7))(
        loglike_batch, kc, u0, l0, u0, l0, f32(l_init), cfg
    )

    return NSState(
        key=key,
        live_u=u1,
        live_logl=l1,
        live_birth=jnp.full((nlive,), f32(l_init)),
        dead_u=jnp.zeros((cap, ndim), f32),
        dead_logl=jnp.full((cap,), -jnp.inf, f32),
        dead_logw=jnp.full((cap,), -jnp.inf, f32),
        dead_birth=jnp.full((cap,), jnp.inf, f32),
        n_dead=jnp.int32(0),
        logx=f32(0.0),
        logz=f32(-jnp.inf),
        n_like=n_evals + jnp.int32(nlive),
        step=jnp.int32(0),
        dead_rank=jnp.full((cap,), -1, jnp.int32),
        live_cluster=jnp.zeros((nlive,), jnp.int32),
    )


def dynamic_sample(
    loglike_batch: Callable,
    key: jax.Array,
    config: NSConfig,
    boost_config: Optional[NSConfig] = None,
    boost_start_mass: float = 0.01,
    *,
    base_state: Optional[NSState] = None,
    boost_state: Optional[NSState] = None,
    on_chunk_base: Optional[Callable[[NSState], None]] = None,
    on_chunk_boost: Optional[Callable[[NSState], None]] = None,
) -> DynamicResults:
    """Two-pass dynamic nested sampling (base + posterior boost + merge).

    ``config`` drives the base run; ``boost_config`` (default: same) the
    boost run.  ``boost_start_mass``: the boost live set is seeded at the
    likelihood below which this fraction of the base-run posterior mass
    lies (0.01 reproduces dyPolyChord's posterior-focused dynamic_goal=1
    behavior of covering essentially the whole posterior bulk).

    Checkpoint/resume (dyPolyChord resume role, reference cli.py:143-144):
    both passes run through the same chunked :func:`nested_sample`
    machinery, so each accepts a resume ``*_state`` and a per-chunk
    callback.  Resuming from a TERMINAL base state replays the (cheap,
    deterministic) finalization and goes straight to the boost pass;
    ``boost_state`` then skips the seeding too.  Threshold selection and
    boost seeding are deterministic functions of (base results, key), so a
    resumed run converges to the same flow.
    """
    key, kb = jax.random.split(jnp.asarray(key))
    base = nested_sample(
        loglike_batch, kb, config, state=base_state, on_chunk=on_chunk_base
    )

    l_init = _choose_l_init(base, boost_start_mass)
    bc = (boost_config or config).resolved()
    key, ks = jax.random.split(key)
    if boost_state is None:
        boost_state = _seed_boost_state(loglike_batch, ks, base, l_init, bc)
    boost = nested_sample(
        loglike_batch, key, bc, state=boost_state, on_chunk=on_chunk_boost
    )

    merged = merge_results([base, boost])
    return DynamicResults(merged=merged, base=base, boost=boost, l_init=l_init)
