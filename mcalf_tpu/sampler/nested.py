"""On-device batched nested sampling (the accelerator replacement for the
reference's four host-side samplers).

The reference delegates sampling to PolyChord / dyPolyChord / MultiNest /
dynesty (host Fortran/Python with per-call Python callbacks,
/root/reference/mcalf/cli.py:80-206) or jaxns (:208-326).  Here the entire
run -- live-point set, constrained replacement sampling, evidence
accumulation, termination -- is ONE ``lax.while_loop`` under ``jit`` with
static shapes.  There are no host round-trips per likelihood call and no MPI:
the reference's MPI fan-out across ranks becomes a batched likelihood over a
live-point block on the device, and independent fits shard over the device mesh
(see :mod:`mcalf_tpu.parallel`).

Algorithm: vectorized nested sampling with batch deletion.

* ``num_delete`` worst live points are deleted per outer step; the j-th
  deleted point (in likelihood order) shrinks the prior volume by
  E[d ln X] = -1/(nlive - j), exactly the sequential-NS bookkeeping, so
  batch deletion is statistically identical to ``num_delete`` classic steps
  (parallel NS a la PolyChord's MPI ranks).
* Replacements are drawn by ``num_repeats`` passes of Neal (2003)
  shrinkage slice sampling, vmapped over all deleted slots at once: random
  directions mapped through the Cholesky factor of the survivor covariance
  (affine whitening); the initial bracket is the exact cube chord along the
  direction (provably a superset of the slice, so no step-out calls are
  needed); hard likelihood constraint L > L*_{(num_delete)} (the highest
  DELETED likelihood).  Chain starts are
  distinct random survivors -- already distributed per the constrained
  prior, so every pass preserves the invariant distribution and
  ``num_repeats`` only controls decorrelation (same role as PolyChord's
  ``num_repeats``, cli.py:92).  Each replacement's insertion rank among the
  survivors is recorded for the Fowlie et al. (2020) uniformity diagnostic
  (:mod:`mcalf_tpu.sampler.diagnostics`).
* Termination on remaining-evidence: mean live likelihood times remaining
  volume < ``precision_criterion`` x accumulated evidence (PolyChord's
  ``precision_criterion``, cli.py:93), or the ``max_samples`` cap (jaxns
  setting, cli.py:259-269).
* After termination the live set is folded in with uniform weights
  X_final/nlive (Skilling's standard finalization).

Everything is float32; the log-evidence error from f32 accumulation is well
below the sampling uncertainty sqrt(H/nlive).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "NSConfig",
    "NSResults",
    "NSState",
    "canonicalize_u",
    "nested_sample",
    "make_sampler",
]


@dataclass(frozen=True)
class NSConfig:
    """Static sampler configuration (hashable; part of the jit key)."""

    ndim: int
    nlive: int = 200
    #: live points deleted + replaced per outer step (the device batch
    #: width).  Default nlive // 2: at nlive=200 the flagship study (tools/
    #: flagship_study.py) found IDENTICAL evidence quality at B=100 and
    #: B=50 (b50 vs ladder rows in the study JSONL), and wider deletion
    #: blocks amortize the per-step whitening/argsort and fill the device.
    num_delete: int = 0  # 0 -> nlive // 2
    #: slice-sampling passes per replacement (decorrelation length)
    num_repeats: int = 0  # 0 -> 12 * ndim (24 * ndim under difficult_model)
    #: stop when Z_live / Z < precision_criterion
    precision_criterion: float = 1e-3
    #: cap on collected dead points (static buffer size)
    max_samples: int = 20000
    #: max shrink iterations per slice pass (chains that don't accept within
    #: the cap keep their point for that pass -- valid but lazier; the
    #: cube-chord bracket needs ~log2(chord/slice)+2 iterations, typically
    #: 5-8, worst case ~20 under deep contraction along collapsed dims)
    max_shrink: int = 30
    #: doubles num_repeats (jaxns 'difficult_model', cli.py:266-267)
    difficult_model: bool = False
    #: slice-direction mixture weights (whitened-Gaussian, global
    #: differential-evolution, coordinate-axis[, triplet-DE]); the optional
    #: 4th weight tunes the triplet-restricted DE family directly (only
    #: active with canon_layout; default: mean of the first three).  See
    #: the direction-mixture note in slice_chains.draw_directions
    move_mix: tuple = (1.0, 1.0, 1.0)
    #: label-symmetry gauge fixing for trans-dimensional component fits:
    #: ``(startind, ncompmax, nfill)`` describing the
    #: [head..., ncomp, (N,z,b) x ncompmax, (N,z,b) x nfill] layout
    #: (SURVEY.md section 3.4).  When set (and ONLY valid when all
    #: components share identical priors, so relabeling is an exact
    #: likelihood symmetry -- see AbsorptionModel.canon_layout), every live
    #: point is mapped after each step to its canonical representative:
    #: active triplets sorted by z first, then inactive ones, fillers
    #: sorted among themselves.  The map permutes coordinates
    #: (volume-preserving) and leaves L unchanged, so the NS bookkeeping is
    #: untouched -- but the ncompmax! x nfill! equivalent label modes
    #: collapse onto one wedge, where whitening/DE directions describe the
    #: actual posterior instead of a mixture of permuted copies.  Measured
    #: on the flagship 10-component fit: without it logZ still climbs
    #: between num_repeats=544 and 1088 (under-mixing across label modes);
    #: with it the evidence stabilizes at far lower repeat counts.
    canon_layout: Optional[tuple] = None
    #: bracket strategy for the slice passes.  "chord" (default,
    #: production): the exact cube chord -- provably a slice superset, zero
    #: expansion evals, ~log2(chord/slice) shrinks (measured plateau ~7 on
    #: the contracted flagship).  "stepout" (EXPERIMENTAL): Neal (2003)
    #: step-out with width ``stepout_w`` whitened t-units and a bounded,
    #: randomly split expansion budget, intersected with the cube chord
    #: (points beyond the chord are outside the prior support, hence
    #: outside the slice -- clamping skips evals whose outcome is known).
    #: Spends ~2 evals testing endpoints to start from a slice-sized
    #: interval instead of the chord.  MEASURED round 3 (after fixing a
    #: window-placement reversibility bug): unbiased on the Gaussian
    #: battery (16 seeds, -0.009 +/- 0.061) and on the flagship
    #: (4854.1/4855.1 at seeds 43/44, ranks green) but NOT cheaper --
    #: 83.0M/80.3M evals vs the chord's 80.2M/78.3M on the converged
    #: flagship; the whitened directions already keep the chord's
    #: shrink count near the slice-geometry floor, so the expansion
    #: tests just replace shrinks one-for-one.  Kept as a validated
    #: option; "chord" stays the default.
    bracket: str = "chord"
    #: step-out initial width in whitened t-units (|d| ~ survivor spread)
    stepout_w: float = 2.0
    #: step-out expansion budget m per pass: Neal's J ~ U{0..m-1} goes to
    #: the low end and K = m-1-J to the high end, so at most m-1 total
    #: expansion steps happen (J + K = m - 1, Neal 2003 fig. 3)
    stepout_budget: int = 16
    #: live-point mode clustering (PolyChord ``do_clustering`` role,
    #: reference cli.py:95; MultiNest is multimodal by construction,
    #: cli.py:179-182).  At every chunk boundary the host re-clusters the
    #: live set (recursive 2-means, sampler/clusters.py) into at most this
    #: many clusters; the slice-direction mixture then draws whitened
    #: directions from a weighted mixture of PER-CLUSTER covariances and DE
    #: pairs from within one cluster -- so on multimodal posteriors the
    #: proposal geometry describes each mode instead of the cross-mode
    #: smear.  The mixture is identical for every chain (independent of the
    #: current point), so the slice kernel stays exactly valid.  1 disables
    #: clustering (identical to the global-covariance kernel); the fully
    #: traced :func:`nested_sample_device` path cannot host-recluster and
    #: always runs as if 1.
    max_clusters: int = 8

    def resolved(self) -> "NSConfig":
        """Fill defaulted fields.  Idempotent: an explicit ``num_repeats`` is
        used as-is (``difficult_model`` only doubles the *default*), so
        resolving a resolved config is a no-op."""
        nd = self.num_delete if self.num_delete > 0 else max(1, self.nlive // 2)
        nd = min(nd, self.nlive - 1)
        if self.num_repeats > 0:
            nr = self.num_repeats
        else:
            # Calibrated against ground truth: analytic Gaussians are
            # unbiased from 2-3*ndim, but the REAL 1-comp CIV fit -- checked
            # against a brute-force quadrature evidence
            # (tools/truth_anchor.py, tests/test_truth_anchor.py) -- needs
            # 8-12*ndim with the 3-way direction mixture before the
            # seed-ensemble bias drops below the quoted logzerr
            # (whitened-only directions need ~32*ndim; see the
            # direction-mixture note in run_steps).  12*ndim is clean;
            # doubled for difficult (multimodal /
            # trans-dimensional) models -- same role as PolyChord's
            # num_repeats (cli.py:92) and jaxns' difficult_model
            # (cli.py:266-267).
            nr = 12 * self.ndim * (2 if self.difficult_model else 1)
        import dataclasses

        return dataclasses.replace(self, num_delete=nd, num_repeats=nr)


class NSState(NamedTuple):
    """Carry of the outer while_loop -- also the checkpointable state."""

    key: jax.Array
    live_u: jax.Array          # (nlive, ndim)
    live_logl: jax.Array       # (nlive,)
    live_birth: jax.Array      # (nlive,) birth contour (threshold at creation)
    dead_u: jax.Array          # (cap, ndim)
    dead_logl: jax.Array       # (cap,)
    dead_logw: jax.Array       # (cap,) log prior-mass weight of each dead point
    dead_birth: jax.Array      # (cap,) birth contour of each dead point
    n_dead: jax.Array          # int32
    logx: jax.Array            # log remaining prior volume
    logz: jax.Array            # accumulated log evidence
    n_like: jax.Array          # int32 likelihood evaluations
    step: jax.Array            # outer step counter
    #: (cap,) int32 insertion ranks of each replacement among the survivor
    #: set at its creation step (Fowlie, Handley & Su 2020 diagnostic).
    #: Aligned with the dead buffer by COUNT (B ranks recorded per step),
    #: not by identity; -1 marks unfilled slots.
    dead_rank: jax.Array
    #: (nlive,) int32 cluster id of each live point in [0, max_clusters);
    #: written by the host at chunk boundaries (see NSConfig.max_clusters),
    #: all-zero means "one cluster" (the global-covariance kernel).
    live_cluster: jax.Array


class NSResults(NamedTuple):
    logz: jax.Array
    logzerr: jax.Array
    h: jax.Array                    # information (nats)
    samples_u: jax.Array            # (cap + nlive, ndim) unit-cube samples
    logl: jax.Array                 # (cap + nlive,)
    logw: jax.Array                 # (cap + nlive,) log prior-mass weights
    birth_logl: jax.Array           # (cap + nlive,) birth contours (for
                                    # run merging / nlive(L) diagnostics)
    log_posterior_weights: jax.Array  # logw + logl - logz (normalized)
    n_dead: jax.Array               # total entries valid (incl. live fold-in)
    n_like: jax.Array
    n_iter: jax.Array
    termination_reason: jax.Array   # 0 = converged, 1 = max_samples
    insertion_rank: jax.Array       # (cap + nlive,) int32 insertion ranks
                                    # (uniform on {0..nlive-num_delete} under
                                    # correct sampling; -1 = unfilled/live)


def _uniform_logw(state: NSState, nlive: int):
    """Log-weights for folding the live set in at termination."""
    return state.logx - jnp.log(jnp.float32(nlive))


def nested_sample(
    loglike_batch: Callable,
    key: jax.Array,
    config: NSConfig,
    state: Optional[NSState] = None,
    return_state: bool = False,
    chunk_steps: Optional[int] = None,
    on_chunk: Optional[Callable[[NSState], None]] = None,
):
    """Run nested sampling on device, stepping in bounded chunks.

    The outer loop advances in chunks of outer steps from a host loop.
    Chunking is *bit-identical* to a single uninterrupted run
    (tests/test_checkpoint.py) -- it exists so no single device execution
    runs unboundedly long (robust against runtime watchdogs; also the
    natural place for checkpoints/progress and for host re-clustering,
    see mcalf_tpu.runner).  The chunk size is auto-tuned from the measured
    first-chunk wall time to target ~15 s per device call, or fixed via
    ``chunk_steps`` / the MCALF_TPU_NS_CHUNK env var.

    Parameters
    ----------
    loglike_batch : callable (B, ndim) unit-cube float32 -> (B,) float32
        Batched constrained-prior log-likelihood (compose the prior transform
        inside; see :meth:`JaxForward.loglike_cube`).
    key : PRNG key
    config : NSConfig
    state : resume from this NSState (e.g. a loaded checkpoint) instead of
        drawing fresh live points; ``key`` is ignored then.
    return_state : also return the final NSState (for checkpointing).
    on_chunk : optional host callback invoked with the NSState after every
        chunk (progress reporting, periodic checkpointing).

    Returns NSResults (device arrays; pull with np.asarray as needed), or
    (NSResults, NSState) when ``return_state``.
    """
    import os
    import time

    cfg = config.resolved()
    if state is None:
        state = init_state(loglike_batch, key, cfg)

    if chunk_steps is None:
        env = os.environ.get("MCALF_TPU_NS_CHUNK", "")
        chunk_steps = int(env) if env else 0

    target_s = 15.0
    probe = 4
    chunk = chunk_steps
    while not is_done(state, cfg):
        # Mode clustering rides the chunk boundary (host-side, cheap): the
        # next chunk's direction mixture uses these assignments.
        state = _recluster(state, cfg)
        if chunk <= 0:
            # Two probe chunks: the first pays the compile, the second is the
            # timing sample.  (num_steps is a traced scalar since round 4 --
            # one executable serves every chunk size -- so the power-of-two
            # rounding below is just a coarse stable quantization of the
            # wall-time-derived size, not a compile-cache necessity.)
            state = run_steps(loglike_batch, state, cfg, probe)
            jax.block_until_ready(state.logz)
            if on_chunk is not None:
                on_chunk(state)
            if is_done(state, cfg):
                break
            t0 = time.perf_counter()
            state = run_steps(loglike_batch, state, cfg, probe)
            jax.block_until_ready(state.logz)
            per = max((time.perf_counter() - t0) / probe, 1e-4)
            chunk = 1 << max(0, int(np.log2(max(target_s / per, 1.0))))
            chunk = min(chunk, 4096)
            if on_chunk is not None:
                on_chunk(state)
            continue
        t0 = time.perf_counter()
        state = run_steps(loglike_batch, state, cfg, chunk)
        jax.block_until_ready(state.logz)
        dt = time.perf_counter() - t0
        if on_chunk is not None:
            on_chunk(state)
        if chunk_steps <= 0:
            # Re-tune continuously: per-step cost GROWS over a run (the
            # constrained region tightens and shrink loops lengthen 3-4x),
            # so a chunk sized from early steps would grow far past the
            # target.  The chunk boundary also sets how often the host
            # re-clusters, so the sizing is part of the trajectory.
            per = max(dt / chunk, 1e-4)
            chunk = 1 << max(0, int(np.log2(max(target_s / per, 1.0))))
            chunk = min(chunk, 4096)

    results = finalize(loglike_batch, state, cfg)
    return (results, state) if return_state else results


def nested_sample_device(loglike_batch, key, config: NSConfig) -> NSResults:
    """Fully traced single-program nested sampling (no host control flow) --
    for use under transforms (shard_map / lax.map in
    :mod:`mcalf_tpu.parallel`).  NOTE: runs the whole fit as one device
    execution; on runtimes that bound execution length, prefer
    :func:`nested_sample`."""
    cfg = config.resolved()
    state = init_state(loglike_batch, key, cfg)
    budget = int(cfg.max_samples) // cfg.num_delete + 2
    state = run_steps(loglike_batch, state, cfg, budget)
    return finalize(loglike_batch, state, cfg)


@partial(jax.jit, static_argnums=(0, 2))
def init_state(loglike_batch, key, config: NSConfig) -> NSState:
    """Draw the initial live-point set and empty dead buffers."""
    cfg = config.resolved()
    ndim, nlive, cap = cfg.ndim, cfg.nlive, int(cfg.max_samples)
    f32 = jnp.float32
    key, k0 = jax.random.split(key)
    live_u = _canon_live(jax.random.uniform(k0, (nlive, ndim), dtype=f32), cfg)
    live_logl = loglike_batch(live_u)
    return NSState(
        key=key,
        live_u=live_u,
        live_logl=live_logl,
        live_birth=jnp.full((nlive,), -jnp.inf, f32),
        dead_u=jnp.zeros((cap, ndim), f32),
        dead_logl=jnp.full((cap,), -jnp.inf, f32),
        dead_logw=jnp.full((cap,), -jnp.inf, f32),
        dead_birth=jnp.full((cap,), jnp.inf, f32),
        n_dead=jnp.int32(0),
        logx=f32(0.0),
        logz=f32(-jnp.inf),
        n_like=jnp.int32(nlive),
        step=jnp.int32(0),
        dead_rank=jnp.full((cap,), -1, jnp.int32),
        live_cluster=jnp.zeros((nlive,), jnp.int32),
    )


def _recluster(state: NSState, cfg: NSConfig) -> NSState:
    """Host-side live-set reclustering at a chunk boundary (no-op when
    clustering is disabled)."""
    if cfg.max_clusters <= 1:
        return state
    from mcalf_tpu.sampler.clusters import assign_clusters

    labels, _ = assign_clusters(
        np.asarray(state.live_u), max_clusters=cfg.max_clusters
    )
    return state._replace(live_cluster=jnp.asarray(labels, jnp.int32))


def _remaining_logz(s: NSState, nlive: int):
    # Upper estimate of the evidence still in the live set.
    return (
        jax.scipy.special.logsumexp(s.live_logl)
        - jnp.log(jnp.float32(nlive))
        + s.logx
    )


def _not_done(s: NSState, cfg: NSConfig):
    B, cap = cfg.num_delete, int(cfg.max_samples)
    log_eps = jnp.log(jnp.float32(cfg.precision_criterion))
    not_capped = s.n_dead + B <= cap
    live_ok = jnp.isfinite(jax.scipy.special.logsumexp(s.live_logl))
    not_converged = (
        _remaining_logz(s, cfg.nlive) - jnp.maximum(s.logz, -1e30) > log_eps
    )
    return not_capped & (not_converged | ~jnp.isfinite(s.logz)) & live_ok


#: jitted termination check for the host chunk loop: ONE executable instead
#: of ~15 eager op-by-op dispatches (each with its own compile at start-up
#: and its own dispatch per chunk).
_not_done_jit = partial(jax.jit, static_argnums=(1,))(_not_done)


def is_done(state: NSState, config: NSConfig) -> bool:
    """Host-side: has the run terminated (converged or capped)?"""
    return not bool(_not_done_jit(state, config.resolved()))


def warmup_executables(loglike_batch, key, config: NSConfig) -> None:
    """Make every executable on the :func:`nested_sample` path resident
    WITHOUT running a fit: ``init_state``, the single chunk-size-agnostic
    ``run_steps`` program (``num_steps`` is traced), the jitted termination
    check, and ``finalize`` -- all at production shapes, driven for two
    real sampler steps.

    Time-to-first-result plumbing: a long-running service (or bench.py)
    calls this once so the compile-or-cache-load tail is paid up front and
    measurable separately; the subsequent fits run with everything
    resident.  Unlike a warmup *fit*, it costs only that tail."""
    cfg = config.resolved()
    state = init_state(loglike_batch, key, cfg)
    state = _recluster(state, cfg)
    state = run_steps(loglike_batch, state, cfg, 2)
    is_done(state, cfg)
    res = finalize(loglike_batch, state, cfg)
    jax.block_until_ready(res.logz)


def canonicalize_u(u, layout, ncomp_vals):
    """Map unit-cube points to their canonical label representative.

    ``layout`` = (startind, ncompmax, nfill); ``ncomp_vals`` the (batched)
    physical ncomp values (so floor gives the active count).  Sorts the
    ncompmax component triplets by (active-first, then z), i.e. the active
    set keeps exactly its members but z-ordered, inactive triplets follow
    z-ordered; filler triplets sort among themselves.  Pure coordinate
    permutation per point: volume-preserving and likelihood-invariant
    (valid only under exchangeable per-component priors; see
    NSConfig.canon_layout)."""
    startind, ncompmax, nfill = layout
    base = startind + 1
    trip = u[..., base : base + 3 * ncompmax]
    trip = trip.reshape(u.shape[:-1] + (ncompmax, 3))
    nact = jnp.floor(ncomp_vals)[..., None]
    idx = jnp.arange(ncompmax, dtype=u.dtype)
    # active triplets (i < nact) keyed by z in [0,1); inactive shifted +2
    key = jnp.where(idx < nact, trip[..., 1], trip[..., 1] + 2.0)
    order = jnp.argsort(key, axis=-1)
    trip = jnp.take_along_axis(trip, order[..., None], axis=-2)
    out = u.at[..., base : base + 3 * ncompmax].set(
        trip.reshape(u.shape[:-1] + (3 * ncompmax,))
    )
    if nfill > 1:
        fb = base + 3 * ncompmax
        ftrip = u[..., fb : fb + 3 * nfill].reshape(
            u.shape[:-1] + (nfill, 3)
        )
        forder = jnp.argsort(ftrip[..., 1], axis=-1)
        ftrip = jnp.take_along_axis(ftrip, forder[..., None], axis=-2)
        out = out.at[..., fb : fb + 3 * nfill].set(
            ftrip.reshape(u.shape[:-1] + (3 * nfill,))
        )
    return out


def _canon_live(live_u, cfg):
    """Apply the gauge fixing to a live-point set (no-op without layout)."""
    if cfg.canon_layout is None:
        return live_u
    startind = cfg.canon_layout[0]
    # ncomp value in u-space: the ncomp dim maps affinely to physical ncomp,
    # but floor(physical) is what the likelihood uses.  The sampler works in
    # the cube and does not know the affine map -- the layout therefore
    # carries the PHYSICAL bounds of the ncomp dim as optional extras.
    if len(cfg.canon_layout) == 5:
        lo, hi = cfg.canon_layout[3], cfg.canon_layout[4]
        ncomp_vals = lo + live_u[..., startind] * (hi - lo)
    else:
        ncomp_vals = live_u[..., startind]
    return canonicalize_u(live_u, cfg.canon_layout[:3], ncomp_vals)


def whitening_factors(surv_u, surv_cluster, max_clusters: int):
    """Affine whitening from survivor covariances (PolyChord-style): one
    Cholesky factor per cluster, and the log mixture weight of each.
    Returns ``(chol_k (K, d, d), logw_k (K,))``; K is 1 (the global
    covariance) when ``max_clusters`` <= 1 or there are no labels.

    The covariance products run at HIGHEST precision: a float32 product
    may otherwise run in TF32 on a GPU (~3 decimal digits), and late in a
    fit, when the live points are tight, a TF32 covariance with only
    1e-10 jitter is where a Cholesky turns NaN."""
    f32 = jnp.float32
    nsurv, ndim = surv_u.shape
    K = max(int(max_clusters), 1)
    hi = jax.lax.Precision.HIGHEST
    centered = surv_u - jnp.mean(surv_u, axis=0)
    cov_g = jnp.matmul(centered.T, centered, precision=hi) / (nsurv - 1)
    eye = jnp.eye(ndim, dtype=f32)
    if K == 1 or surv_cluster is None:
        chol_k = jnp.linalg.cholesky(cov_g + 1e-10 * eye)[None]  # (1,d,d)
        return chol_k, jnp.zeros((1,), f32)
    onehot = jax.nn.one_hot(surv_cluster, K, dtype=f32)          # (nsurv,K)
    n_k = onehot.sum(axis=0)                                      # (K,)
    mean_k = jnp.matmul(onehot.T, surv_u, precision=hi) / jnp.maximum(
        n_k, 1.0
    )[:, None]
    cent_k = surv_u[None, :, :] - mean_k[:, None, :]              # (K,ns,d)
    cov_k = jnp.einsum(
        "kn,kni,knj->kij", onehot.T, cent_k, cent_k, precision=hi
    ) / jnp.maximum(n_k - 1.0, 1.0)[:, None, None]
    # Tiny/empty clusters fall back to the global covariance (their
    # mixture weight is ~0 anyway; this keeps the Cholesky finite).
    cov_k = jnp.where((n_k >= 2)[:, None, None], cov_k, cov_g[None])
    chol_k = jnp.linalg.cholesky(cov_k + 1e-10 * eye[None])       # (K,d,d)
    logw_k = jnp.where(n_k > 0, jnp.log(jnp.maximum(n_k, 1.0)), -jnp.inf)
    return chol_k, logw_k


def slice_chains(
    loglike_batch, key, u_start, logl_start, surv_u, surv_logl, lstar, cfg,
    *, surv_cluster=None
):
    """Evolve B slice-sampling chains for ``cfg.num_repeats`` passes under
    the hard constraint L > lstar, using the survivor set for whitening and
    differential-evolution directions.

    ``surv_cluster`` (optional, (nsurv,) int32 in [0, cfg.max_clusters)):
    live-point mode assignments.  When given (and max_clusters > 1) the
    whitened directions come from a cluster-size-weighted MIXTURE of
    per-cluster covariances and DE pairs are drawn within one cluster (with
    a 25% cross-cluster fraction kept for mode-to-mode vectors).  The
    mixture is the same for every chain and every point, so the slice
    kernel stays exactly valid.  None = one cluster = the global kernel.

    Every start point must satisfy the constraint.  Returns
    (u_new, logl_new, key, n_evals).  This is the constrained-replacement
    engine of the NS step, factored out so the dynamic (posterior-boost)
    sampler can reuse it to decorrelate fresh live sets at an arbitrary
    threshold (sampler/dynamic.py).

    SCHEDULING (round-3 rewrite): chains advance their passes
    ASYNCHRONOUSLY.  The lockstep formulation (scan over passes, inner
    while_loop until every chain accepts) pays max_i(iters_i) batched
    likelihood calls per pass -- measured ~20 on the flagship fit while the
    per-chain mean is ~6, i.e. ~3x the work, because the batch stalls on
    its slowest chain every single pass.  Here ONE while_loop carries a
    per-chain pass counter: each iteration proposes one point per chain
    (one batched likelihood call), accepting chains start their next pass
    with a fresh direction immediately, and the loop runs until every
    chain has completed num_repeats passes.  Total cost is
    max_i(sum_p iters_{i,p}), and the sum over hundreds of passes
    concentrates (CLT) to ~mean + a few percent.  The per-chain Markov
    kernel -- direction mixture, cube-chord bracket, shrinkage,
    max_shrink abandonment -- is IDENTICAL to the lockstep version, so
    the statistics of the replacements are unchanged; only the wall-clock
    (and the honest n_evals accounting) drops."""
    ndim = cfg.ndim
    B = u_start.shape[0]
    nsurv = surv_u.shape[0]
    f32 = jnp.float32
    K = max(int(cfg.max_clusters), 1)

    chol_k, logw_k = whitening_factors(surv_u, surv_cluster, K)
    K = chol_k.shape[0]

    def draw_directions(key):
        """One fresh slice direction per chain, drawn from the mixture.
        Depends only on the survivor set and the PRNG -- NOT on the chains'
        current points, as slice-kernel validity requires (the direction
        distribution must be identical at every point on the line).

        Unit direction in the whitened frame, mapped through L: |d| is
        then ~ the live-point spread along that direction, so the
        shrink loop converges in O(1) iterations.  With clustering the
        frame is drawn per chain from the cluster-size-weighted mixture:
        each direction describes ONE mode's geometry instead of the
        cross-mode smear of the global covariance.

        Direction mixture.  With the cube-chord bracket only the
        ANGULAR distribution matters (the bracket ignores |d|), and no
        single family mixes every phase of a real absorption fit:
        * whitened Gaussian -- right for the unimodal late phase;
        * global differential evolution (difference of two random
          survivors) -- carries mode-to-mode vectors when the region
          fragments (noise-induced secondary redshift channels);
        * coordinate axes -- the slab+tunnel mid-phase of absorption
          fits is axis-aligned in the collapsed (redshift) dims, which
          generic directions cross at unproductive angles;
        * (canon_layout only) TRIPLET-RESTRICTED differential evolution
          -- the survivor difference masked to one random (N, z, b)
          triplet.  Sliding along it reassigns a single component
          wholesale (t=1 swaps in the other survivor's component) while
          leaving every other dimension fixed: the coordinated "move one
          component to another line" update that generic directions
          almost never propose.
        (A "local DE" variant -- nearest-neighbor pairs -- was tried
        and makes things WORSE: small steps under-explore; measured
        -4.3 nats on the 1-comp CIV anchor.)"""
        kd, kj, km, kc, kcl, kg, kx, ka, kt_ = jax.random.split(key, 9)
        n = jax.random.normal(kd, (B, ndim), f32)
        # These products may run in TF32 on a GPU.  That is acceptable:
        # a direction only shapes proposals, and its rounding depends on
        # the survivor set and the PRNG alone -- never on a chain's current
        # point -- so the slice kernel stays exactly valid.
        n = n / (jnp.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
        if K == 1:
            d_white = n @ chol_k[0].T
        else:
            cw = jax.random.categorical(kc, logw_k, shape=(B,))
            d_white = jnp.einsum("bi,bji->bj", n, chol_k[cw])
        w_white, w_de, w_axis = cfg.move_mix[:3]
        jidx = jax.random.randint(kj, (2, B), 0, nsurv)
        if K > 1:
            # Within-cluster DE pairs (uniform member choice via the
            # Gumbel-argmax trick over the cluster mask), keeping a 25%
            # cross-cluster fraction for mode-to-mode difference vectors.
            c2 = jax.random.categorical(kcl, logw_k, shape=(B,))
            member = surv_cluster[None, :] == c2[:, None]     # (B, nsurv)
            g = jax.random.gumbel(kg, (2, B, nsurv), f32)
            score = jnp.where(member[None], g, -jnp.inf)
            jidx_local = jnp.argmax(score, axis=-1).astype(jnp.int32)
            cross = jax.random.uniform(kx, (1, B), f32) < 0.25
            jidx = jnp.where(cross, jidx, jidx_local)
        if cfg.canon_layout:
            w_trip = (
                cfg.move_mix[3]
                if len(cfg.move_mix) > 3
                else (w_white + w_de + w_axis) / 3.0
            )
        else:
            w_trip = 0.0
        tot = w_white + w_de + w_axis + w_trip
        r_mv = jax.random.uniform(km, (B, 1), f32) * tot
        d_diff = surv_u[jidx[0]] - surv_u[jidx[1]]
        de_ok = jnp.linalg.norm(d_diff, axis=1, keepdims=True) > 1e-7
        axis_idx = jax.random.randint(ka, (B,), 0, ndim)
        d_axis = jax.nn.one_hot(axis_idx, ndim, dtype=f32)
        if cfg.canon_layout:
            startind, ncompmax, nfill = cfg.canon_layout[:3]
            tsel = jax.random.randint(kt_, (B,), 0, ncompmax + max(nfill, 0))
            dim_ids = jnp.arange(ndim)
            trip_of_dim = (dim_ids - (startind + 1)) // 3  # -1 for head dims
            tmask = (trip_of_dim[None, :] == tsel[:, None]) & (
                dim_ids[None, :] >= startind + 1
            )
            d_trip = jnp.where(tmask, d_diff, 0.0)
            trip_ok = (
                jnp.linalg.norm(d_trip, axis=1, keepdims=True) > 1e-7
            )
        else:
            d_trip = d_diff
            trip_ok = de_ok
        return jnp.where(
            (r_mv < w_de) & de_ok,
            d_diff,
            jnp.where(
                r_mv < w_de + w_axis,
                d_axis,
                jnp.where(
                    (r_mv < w_de + w_axis + w_trip) & trip_ok,
                    d_trip,
                    d_white,
                ),
            ),
        )

    def bracket(u_cur, d):
        """Exact cube-chord bracket: the full extent of the line
        u_cur + t d inside the unit cube.  This PROVABLY contains the
        entire slice (slice subset of prior support), so shrinkage-only
        is an unconditionally valid slice kernel (Neal 2003) with ZERO
        bracket-expansion likelihood calls -- unlike a fixed-width
        bracket (which truncates wide slices and biases logZ, measured
        +0.15..+0.34 nats at ndim=8) or step-out (correct but ~2.5x
        the evals per pass on multimodal trans-dimensional fits, where
        expansions chase distant modes).  Whitening keeps the expected
        chord/slice ratio O(10), so shrinkage converges in
        ~log2(chord/slice)+2 ~ 5-8 iterations per chain."""
        safe_d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        c1 = (0.0 - u_cur) / safe_d                   # (B, ndim)
        c2 = (1.0 - u_cur) / safe_d
        lo = jnp.max(jnp.minimum(c1, c2), axis=1)     # (B,)
        hi = jnp.min(jnp.maximum(c1, c2), axis=1)
        return lo, hi

    nrep = jnp.int32(cfg.num_repeats)
    # Hard iteration ceiling: no chain can take more than max_shrink
    # proposals per pass, so the loop provably terminates by then.
    total_cap = jnp.int32(cfg.num_repeats * cfg.max_shrink)

    # Direction POOL: chain i's pass p uses pool_d[p, i].  Every chain
    # needs exactly num_repeats directions, all independent of the chain
    # trajectories, so they are drawn up front in one vectorized shot --
    # the while_loop body then only GATHERS (B, ndim) rows, keeping the
    # per-iteration critical path likelihood-dominated (a per-iteration
    # draw costs gumbel cluster selection + categorical + a per-chain
    # cholesky einsum every trip).
    key, kpool = jax.random.split(key)
    pool_d = jax.vmap(draw_directions)(
        jax.random.split(kpool, cfg.num_repeats)
    )                                                  # (R, B, ndim)

    if cfg.bracket == "stepout":
        return _slice_chains_stepout(
            loglike_batch, key, u_start, logl_start, lstar, cfg,
            pool_d, bracket, nrep,
        )

    d0 = pool_d[0]
    lo0, hi0 = bracket(u_start, d0)

    def async_cond(c):
        _, _, _, _, _, _, passes, _, _, it_total = c
        return jnp.any(passes < nrep) & (it_total < total_cap)

    def async_body(c):
        (u_cur, logl_cur, d, lo, hi, it_pass, passes, key, n_like,
         it_total) = c
        active = passes < nrep
        key, kt = jax.random.split(key)
        t = lo + jax.random.uniform(kt, (B,), f32) * (hi - lo)
        u_prop = u_cur + t[:, None] * d
        inside = jnp.all((u_prop >= 0.0) & (u_prop <= 1.0), axis=1)
        ll_prop = loglike_batch(jnp.clip(u_prop, 0.0, 1.0))
        ll_prop = jnp.where(inside, ll_prop, -jnp.inf)
        acc = (ll_prop > lstar) & active
        u_cur = jnp.where(acc[:, None], u_prop, u_cur)
        logl_cur = jnp.where(acc, ll_prop, logl_cur)
        # Rejection shrinks the bracket toward the (unchanged) current
        # point; a chain that exhausts max_shrink proposals abandons the
        # pass and keeps its point (identity kernel -- valid but lazier).
        rej = active & ~acc
        it_pass = jnp.where(rej, it_pass + 1, it_pass)
        lo = jnp.where(rej & (t < 0), t, lo)
        hi = jnp.where(rej & (t >= 0), t, hi)
        exhausted = rej & (it_pass >= cfg.max_shrink)
        fin = acc | exhausted
        passes = passes + fin.astype(jnp.int32)
        # Chains that finished a pass (and still owe passes) start the next
        # one NOW with its next pooled direction -- nobody waits for the
        # batch.
        need = fin & (passes < nrep)
        d_new = pool_d[jnp.minimum(passes, nrep - 1), jnp.arange(B)]
        lo_new, hi_new = bracket(u_cur, d_new)
        d = jnp.where(need[:, None], d_new, d)
        lo = jnp.where(need, lo_new, lo)
        hi = jnp.where(need, hi_new, hi)
        it_pass = jnp.where(fin, jnp.int32(0), it_pass)
        return (u_cur, logl_cur, d, lo, hi, it_pass, passes, key,
                n_like + B, it_total + 1)

    init = (
        u_start,
        logl_start,
        d0,
        lo0,
        hi0,
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
        key,
        jnp.int32(0),
        jnp.int32(0),
    )
    out = jax.lax.while_loop(async_cond, async_body, init)
    u_new, logl_new, _, _, _, _, _, key, n_like, _ = out
    return u_new, logl_new, key, n_like


def _slice_chains_stepout(
    loglike_batch, key, u_start, logl_start, lstar, cfg, pool_d, bracket,
    nrep,
):
    """EXPERIMENTAL step-out bracket variant of the async scheduler (see
    NSConfig.bracket).  Per pass and chain: place a width-``stepout_w``
    window uniformly around the current point (t = 0), expand each end in
    w-steps while the endpoint stays inside the slice, with a total
    expansion budget ``stepout_budget`` split uniformly at random between
    the ends (Neal 2003's bounded step-out), everything intersected with
    the cube chord (beyond it the prior density is zero, so those
    endpoints are outside the slice without evaluation); then standard
    shrinkage.  Phases run asynchronously per chain exactly like the
    chord scheduler; endpoint tests are counted in n_evals."""
    B = u_start.shape[0]
    f32 = jnp.float32
    m = int(cfg.stepout_budget)
    w = jnp.float32(cfg.stepout_w)
    arange_b = jnp.arange(B)

    key, ku, kj = jax.random.split(key, 3)
    u01_pool = jax.random.uniform(ku, (cfg.num_repeats, B), f32)
    js_pool = jax.random.randint(kj, (cfg.num_repeats, B), 0, m)
    total_cap = jnp.int32(cfg.num_repeats * (cfg.max_shrink + m + 2))

    def start_pass(p_idx, u_cur):
        """Window + expansion state for each chain's pass ``p_idx``."""
        idx = jnp.minimum(p_idx, nrep - 1)
        d = pool_d[idx, arange_b]
        clo, chi = bracket(u_cur, d)
        u01 = u01_pool[idx, arange_b]
        # Uniform window placement around t=0 FIRST, then clamp each end
        # to the chord independently: clamping lo before computing hi
        # would shift the window off its uniform placement near chord
        # ends, breaking the reversibility of Neal's interval procedure
        # (measured as a +0.12 nat high bias on the Gaussian battery).
        lo0 = -u01 * w
        lo = jnp.maximum(lo0, clo)
        hi = jnp.minimum(lo0 + w, chi)
        jlo = js_pool[idx, arange_b]
        jhi = (m - 1) - jlo
        # Phase 0/1 test-and-expand an end; skip ends with no budget or
        # already at the chord (their test outcome would be discarded /
        # is known to fail).
        phase = jnp.where(
            (jlo > 0) & (lo > clo),
            jnp.int32(0),
            jnp.where((jhi > 0) & (hi < chi), jnp.int32(1), jnp.int32(2)),
        )
        return d, lo, hi, clo, chi, jlo, jhi, phase

    d0, lo0, hi0, clo0, chi0, jlo0, jhi0, ph0 = start_pass(
        jnp.zeros((B,), jnp.int32), u_start
    )

    def so_cond(c):
        passes, it_total = c[11], c[14]
        return jnp.any(passes < nrep) & (it_total < total_cap)

    def so_body(c):
        (u_cur, logl_cur, d, lo, hi, clo, chi, jlo, jhi, phase, it_pass,
         passes, key, n_like, it_total) = c
        active = passes < nrep
        key, kt = jax.random.split(key)
        tu = jax.random.uniform(kt, (B,), f32)
        t = jnp.where(
            phase == 0, lo, jnp.where(phase == 1, hi, lo + tu * (hi - lo))
        )
        u_prop = u_cur + t[:, None] * d
        inside = jnp.all((u_prop >= 0.0) & (u_prop <= 1.0), axis=1)
        ll = loglike_batch(jnp.clip(u_prop, 0.0, 1.0))
        ll = jnp.where(inside, ll, -jnp.inf)
        in_slice = ll > lstar

        p0 = active & (phase == 0)
        p1 = active & (phase == 1)
        p2 = active & (phase == 2)

        # Expansion: while the tested end is inside the slice and budget/
        # chord allow, move it out by w; otherwise that end is done.
        grow_lo = p0 & in_slice & (jlo > 0) & (lo > clo)
        lo = jnp.where(grow_lo, jnp.maximum(lo - w, clo), lo)
        jlo = jnp.where(grow_lo, jlo - 1, jlo)
        # An end whose budget or chord ran out right after expanding is
        # done WITHOUT another test (its would-be test is discarded).
        stop_lo = (p0 & ~grow_lo) | (grow_lo & ((jlo == 0) | (lo <= clo)))
        grow_hi = p1 & in_slice & (jhi > 0) & (hi < chi)
        hi = jnp.where(grow_hi, jnp.minimum(hi + w, chi), hi)
        jhi = jnp.where(grow_hi, jhi - 1, jhi)
        stop_hi = (p1 & ~grow_hi) | (grow_hi & ((jhi == 0) | (hi >= chi)))
        phase = jnp.where(
            stop_lo,
            jnp.where((jhi > 0) & (hi < chi), jnp.int32(1), jnp.int32(2)),
            phase,
        )
        phase = jnp.where(stop_hi, jnp.int32(2), phase)

        # Shrinkage (identical to the chord scheduler).
        acc = p2 & in_slice
        u_cur = jnp.where(acc[:, None], u_prop, u_cur)
        logl_cur = jnp.where(acc, ll, logl_cur)
        rej = p2 & ~in_slice
        it_pass = jnp.where(rej, it_pass + 1, it_pass)
        lo = jnp.where(rej & (t < 0), t, lo)
        hi = jnp.where(rej & (t >= 0), t, hi)
        exhausted = rej & (it_pass >= cfg.max_shrink)
        fin = acc | exhausted
        passes = passes + fin.astype(jnp.int32)
        need = fin & (passes < nrep)
        d_n, lo_n, hi_n, clo_n, chi_n, jlo_n, jhi_n, ph_n = start_pass(
            passes, u_cur
        )
        d = jnp.where(need[:, None], d_n, d)
        lo = jnp.where(need, lo_n, lo)
        hi = jnp.where(need, hi_n, hi)
        clo = jnp.where(need, clo_n, clo)
        chi = jnp.where(need, chi_n, chi)
        jlo = jnp.where(need, jlo_n, jlo)
        jhi = jnp.where(need, jhi_n, jhi)
        phase = jnp.where(need, ph_n, phase)
        it_pass = jnp.where(fin, jnp.int32(0), it_pass)
        return (u_cur, logl_cur, d, lo, hi, clo, chi, jlo, jhi, phase,
                it_pass, passes, key, n_like + B, it_total + 1)

    init = (
        u_start, logl_start, d0, lo0, hi0, clo0, chi0, jlo0, jhi0, ph0,
        jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32), key,
        jnp.int32(0), jnp.int32(0),
    )
    out = jax.lax.while_loop(so_cond, so_body, init)
    return out[0], out[1], out[12], out[13]


@partial(jax.jit, static_argnums=(0, 2))
def run_steps(loglike_batch, state: NSState, config: NSConfig, num_steps) -> NSState:
    """Advance the sampler until termination or ``num_steps`` further outer
    steps (chunked stepping enables host-side checkpointing / progress
    reports).

    ``num_steps`` is a TRACED scalar, not part of the jit key: the chunk
    auto-tuner re-sizes chunks throughout a run (per-step cost grows as the
    constrained region tightens), and a static budget would compile one
    executable per distinct size (4-6 on the flagship fit).  One
    executable serves every chunk size (and every later fit of the same
    shape)."""
    cfg = config.resolved()
    num_steps = jnp.asarray(num_steps, jnp.int32)
    ndim, nlive, B = cfg.ndim, cfg.nlive, cfg.num_delete
    cap = int(cfg.max_samples)
    f32 = jnp.float32

    # Sequential shrinkage factors for a batch of B deletions:
    # d ln X_j = -1/(nlive - j), j = 0..B-1.
    dlogx = -1.0 / (nlive - jnp.arange(B, dtype=f32))          # (B,)
    cum_dlogx = jnp.cumsum(dlogx)                               # (B,)

    def cond_fn(carry):
        s, k = carry
        return _not_done(s, cfg) & (k < num_steps)

    def body_fn(s: NSState) -> NSState:
        key = s.key

        # ---- delete the B worst live points ----------------------------
        order = jnp.argsort(s.live_logl)                  # ascending
        worst = order[:B]
        surv = order[B:]
        dead_logl_new = s.live_logl[worst]                # ascending in L
        dead_u_new = s.live_u[worst]
        # Constraint for the replacements: strictly above the HIGHEST deleted
        # point (the B-th smallest), i.e. L > L*_{(num_delete)}.  Using the
        # minimum *survivor* here instead is off by one and biases logZ high
        # (the shrinkage bookkeeping assumes replacements are drawn from the
        # prior truncated at the last deleted contour); measured on a 64-seed
        # Gaussian analytic problem: +0.122±0.038 nats with the survivor
        # threshold vs +0.011±0.040 with this one.  This also guarantees every
        # survivor start point strictly satisfies the constraint, so a chain
        # that exhausts max_shrink keeps a valid interior point rather than a
        # boundary point with L == lstar.
        lstar = dead_logl_new[-1]                         # = B-th smallest

        # volumes: j-th deleted dies at logx + cum_dlogx[j]
        logx_seq = s.logx + cum_dlogx                     # (B,)
        logx_prev = jnp.concatenate([s.logx[None], logx_seq[:-1]])
        # w_j = X_{j-1} - X_j  (rectangle rule)
        logw_new = logx_prev + jnp.log1p(-jnp.exp(logx_seq - logx_prev))

        logz = jnp.logaddexp(
            s.logz, jax.scipy.special.logsumexp(logw_new + dead_logl_new)
        )

        dead_u = jax.lax.dynamic_update_slice(s.dead_u, dead_u_new, (s.n_dead, 0))
        dead_logl = jax.lax.dynamic_update_slice(s.dead_logl, dead_logl_new, (s.n_dead,))
        dead_logw = jax.lax.dynamic_update_slice(s.dead_logw, logw_new, (s.n_dead,))
        dead_birth = jax.lax.dynamic_update_slice(
            s.dead_birth, s.live_birth[worst], (s.n_dead,)
        )

        # ---- replacement: slice sampling from random survivors ---------
        surv_u = s.live_u[surv]                           # (nlive-B, ndim)
        surv_logl = s.live_logl[surv]

        key, kstart = jax.random.split(key)
        # Starts: a uniformly random B-subset of the survivors, WITHOUT
        # replacement.  Without-replacement matters because duplicate start
        # points correlate the B replacements, which violates the iid
        # assumption behind the sequential batch-shrinkage bookkeeping and
        # biases logZ upward at small num_repeats (measured ~ +0.1 nat at
        # nlive=100, B=25, 8 repeats on an analytic Gaussian).  Uniformly-
        # random matters because survivors are sorted ascending in logl: a
        # deterministic index set (e.g. always 0..B-1) would start every
        # chain from the lowest-likelihood survivors hugging the deletion
        # contour, so at finite num_repeats the replacements inherit a
        # low-L bias instead of the constrained-prior distribution the
        # bookkeeping assumes.  When B > nsurv, tile survivors as evenly as
        # possible (duplicates are then unavoidable).
        nsurv_ = nlive - B
        if B <= nsurv_:
            start_idx = jax.random.permutation(kstart, nsurv_)[:B]
        else:
            start_idx = jax.random.permutation(
                kstart,
                jnp.tile(jnp.arange(nsurv_, dtype=jnp.int32), -(-B // nsurv_)),
            )[:B]
        start_idx = start_idx.astype(jnp.int32)
        u_cur = surv_u[start_idx]                         # (B, ndim)
        logl_cur = surv_logl[start_idx]

        surv_cluster = s.live_cluster[surv]
        u_new, logl_new, key, n_evals = slice_chains(
            loglike_batch, key, u_cur, logl_cur, surv_u, surv_logl, lstar,
            cfg, surv_cluster=surv_cluster,
        )
        n_like = s.n_like + n_evals

        # ---- insertion-rank diagnostic ---------------------------------
        # Each replacement is (under correct constrained sampling) an iid
        # draw from the prior truncated at lstar, as are the nlive-B
        # survivors, so its rank among the survivors is uniform on
        # {0, ..., nlive-B}.  Non-uniformity flags under-decorrelated chains
        # (Fowlie, Handley & Su 2020, MNRAS 497:5256).
        #
        # TIES: near the posterior peak the f32 likelihood is a plateau
        # landscape (measured: ~90% of logl values in the last decile of a
        # CIV fit are exact duplicates), and counting a tie as "not less"
        # would bias ranks low -- a false rank-test failure that more
        # num_repeats cannot fix.  The correct discrete-likelihood rank is
        # uniform among the tie positions, so break ties at random.  The
        # tie-break key is FOLDED from (not split off) the chain key: the
        # main PRNG stream -- and hence every sampling decision -- is
        # unchanged by this diagnostic.
        nless = jnp.sum(surv_logl[None, :] < logl_new[:, None], axis=1)
        nties = jnp.sum(surv_logl[None, :] == logl_new[:, None], axis=1)
        tie_pos = jnp.floor(
            jax.random.uniform(jax.random.fold_in(key, 0x7a7), nless.shape)
            * (nties + 1).astype(jnp.float32)
        ).astype(jnp.int32)
        ranks = (nless + jnp.minimum(tie_pos, nties)).astype(jnp.int32)
        dead_rank = jax.lax.dynamic_update_slice(s.dead_rank, ranks, (s.n_dead,))

        # ---- rebuild live set ------------------------------------------
        # Gauge fixing: map every point to its canonical label
        # representative (coordinate permutation within each point; L and
        # per-point birth contours unchanged).  Idempotent on survivors.
        live_u = _canon_live(s.live_u.at[worst].set(u_new), cfg)
        live_logl = s.live_logl.at[worst].set(logl_new)
        live_birth = s.live_birth.at[worst].set(lstar)
        # A replacement inherits its start survivor's cluster (it rarely
        # leaves it within one step); the host re-clusters every chunk.
        live_cluster = s.live_cluster.at[worst].set(surv_cluster[start_idx])

        return NSState(
            key=key,
            live_u=live_u,
            live_logl=live_logl,
            live_birth=live_birth,
            dead_u=dead_u,
            dead_logl=dead_logl,
            dead_logw=dead_logw,
            dead_birth=dead_birth,
            n_dead=s.n_dead + B,
            logx=logx_seq[-1],
            logz=logz,
            n_like=n_like,
            step=s.step + 1,
            dead_rank=dead_rank,
            live_cluster=live_cluster,
        )

    def body_wrap(carry):
        s, k = carry
        return body_fn(s), k + 1

    final, _ = jax.lax.while_loop(cond_fn, body_wrap, (state, jnp.int32(0)))
    return final


@partial(jax.jit, static_argnums=(0, 2))
def finalize(loglike_batch, final: NSState, config: NSConfig) -> NSResults:
    """Fold the live set in and assemble NSResults from a terminated (or
    intermediate) state."""
    cfg = config.resolved()
    nlive, cap = cfg.nlive, int(cfg.max_samples)
    f32 = jnp.float32

    # ---- fold the live set in (uniform weights X_final/nlive) ----------
    live_logw = jnp.full((nlive,), _uniform_logw(final, nlive), f32)
    logz = jnp.logaddexp(
        final.logz, jax.scipy.special.logsumexp(live_logw + final.live_logl)
    )

    samples_u = jnp.concatenate([final.dead_u, final.live_u], axis=0)
    logl = jnp.concatenate([final.dead_logl, final.live_logl])
    logw = jnp.concatenate([final.dead_logw, live_logw])
    birth = jnp.concatenate([final.dead_birth, final.live_birth])
    # Live entries sit at [cap, cap+nlive); mark dead padding invalid.
    valid = jnp.concatenate(
        [jnp.arange(cap) < final.n_dead, jnp.ones((nlive,), bool)]
    )
    logw = jnp.where(valid, logw, -jnp.inf)
    logl_safe = jnp.where(valid, logl, 0.0)

    log_post = logw + jnp.where(valid, logl, -jnp.inf) - logz
    # Information H = sum p_i ln L_i - ln Z  ->  logzerr = sqrt(H/nlive)
    p = jnp.exp(log_post)
    h = jnp.sum(jnp.where(valid, p * logl_safe, 0.0)) - logz
    logzerr = jnp.sqrt(jnp.maximum(h, 0.0) / nlive)

    converged = _remaining_logz(final, nlive) - logz <= jnp.log(
        jnp.float32(cfg.precision_criterion)
    )

    return NSResults(
        logz=logz,
        logzerr=logzerr,
        h=h,
        samples_u=samples_u,
        logl=logl,
        logw=logw,
        birth_logl=birth,
        log_posterior_weights=log_post,
        n_dead=final.n_dead + nlive,
        n_like=final.n_like,
        n_iter=final.step,
        termination_reason=jnp.where(converged, jnp.int32(0), jnp.int32(1)),
        insertion_rank=jnp.concatenate(
            [final.dead_rank, jnp.full((nlive,), -1, jnp.int32)]
        ),
    )


def make_sampler(loglike_batch: Callable, config: NSConfig):
    """Return ``run(key) -> NSResults`` with everything jit-compiled."""

    def run(key) -> NSResults:
        return nested_sample(loglike_batch, key, config)

    return run
