"""Nested-sampler correctness on problems with analytic evidence.

The reference has no sampler of its own (it delegates to PolyChord etc.,
SURVEY.md section 2.2); these tests hold our on-device sampler to the
standard analytic benchmarks nested samplers are validated on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mcalf_tpu.sampler import (
    NSConfig,
    insertion_rank_test,
    nested_sample,
    nested_sample_device,
    posterior_stats,
    resample_equal,
)


def gaussian_loglike(sigma, ndim, mu=0.5):
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def loglike(u):
        r2 = jnp.sum((u - mu) ** 2, axis=-1)
        return (norm - 0.5 * r2 / sigma**2).astype(jnp.float32)

    return loglike


@pytest.mark.parametrize("ndim,sigma", [(2, 0.05), (4, 0.08)])
def test_gaussian_evidence(ndim, sigma):
    # Gaussian centered in the unit cube, sigma small enough that the
    # truncation is negligible -> Z = 1, logZ = 0.
    cfg = NSConfig(ndim=ndim, nlive=200, max_samples=20000,
                   precision_criterion=1e-3)
    res = nested_sample(gaussian_loglike(sigma, ndim), jax.random.PRNGKey(0), cfg)
    logz = float(res.logz)
    logzerr = float(res.logzerr)
    assert int(res.termination_reason) == 0, "did not converge"
    assert logzerr < 0.5
    assert abs(logz) < max(3.5 * logzerr, 0.1), (logz, logzerr)


def test_gaussian_posterior_moments():
    ndim, sigma = 3, 0.06
    cfg = NSConfig(ndim=ndim, nlive=250, max_samples=20000)
    res = nested_sample(gaussian_loglike(sigma, ndim), jax.random.PRNGKey(1), cfg)
    mean, std = posterior_stats(res)
    assert np.all(np.abs(mean - 0.5) < 0.01), mean
    assert np.all(np.abs(std - sigma) < 0.015), std


def test_uniform_slab_evidence():
    # L = const on the whole cube: Z = const exactly, H = 0.
    const = -3.7

    def loglike(u):
        return jnp.full(u.shape[:-1], const, jnp.float32)

    cfg = NSConfig(ndim=2, nlive=100, max_samples=5000)
    res = nested_sample(loglike, jax.random.PRNGKey(2), cfg)
    assert abs(float(res.logz) - const) < 0.05
    assert abs(float(res.h)) < 0.05


def test_truncated_gaussian_corner():
    # Gaussian centered at a corner: only 1/2^d of the mass is inside ->
    # logZ = -d log 2 (for sigma << 1).
    ndim, sigma = 2, 0.05
    ll = gaussian_loglike(sigma, ndim, mu=0.0)
    cfg = NSConfig(ndim=ndim, nlive=300, max_samples=20000)
    res = nested_sample(ll, jax.random.PRNGKey(3), cfg)
    want = -ndim * np.log(2.0)
    assert abs(float(res.logz) - want) < max(4 * float(res.logzerr), 0.15)


def test_batch_deletion_consistency():
    # Different num_delete settings must agree on the evidence.
    ndim, sigma = 2, 0.05
    ll = gaussian_loglike(sigma, ndim)
    outs = []
    for nd in (1, 25, 100):
        cfg = NSConfig(ndim=ndim, nlive=200, num_delete=nd, max_samples=20000)
        res = nested_sample(ll, jax.random.PRNGKey(4), cfg)
        outs.append((float(res.logz), float(res.logzerr)))
    for lz, le in outs:
        assert abs(lz) < max(4 * le, 0.15), outs


def test_stepout_bracket_evidence():
    # The EXPERIMENTAL step-out bracket (NSConfig.bracket="stepout") must
    # reproduce the analytic evidence like the default chord bracket.  The
    # window-placement reversibility bug it shipped without (clamping lo
    # to the chord before deriving hi) biased logZ +0.12 nats on this
    # battery -- keep a multi-seed mean so a regression of that size
    # cannot hide in a single run's error bar.
    ndim, sigma = 4, 0.06
    norm = -0.5 * ndim * np.log(2 * np.pi * sigma**2)

    def ll(u):
        r2 = jnp.sum((u - 0.5) ** 2, axis=-1)
        return (norm - 0.5 * r2 / sigma**2).astype(jnp.float32)

    cfg = NSConfig(ndim=ndim, nlive=100, num_repeats=48, max_samples=4000,
                   precision_criterion=1e-3, bracket="stepout")
    zs = [
        float(nested_sample(ll, jax.random.PRNGKey(s), cfg).logz)
        for s in range(6)
    ]
    # 6-seed mean within ~2.5 SEM of truth 0 (SEM ~0.10 at these settings).
    assert abs(np.mean(zs)) < 0.27, zs


def test_async_pass_scheduling_cost():
    # The slice passes are scheduled asynchronously per chain
    # (sampler/nested.py slice_chains): total likelihood evals per
    # replacement concentrate near num_repeats * (per-chain mean iters),
    # NOT num_repeats * (max over the deletion block) as the old lockstep
    # formulation paid.  On this well-whitened Gaussian the per-chain
    # mean is ~3-5 evals/pass; the lockstep max over B=100 chains was
    # ~2-3x that.  Guard the property: a regression to batch-synchronous
    # stalling roughly doubles evals/pass and fails the bound.
    ndim, sigma = 4, 0.08
    cfg = NSConfig(ndim=ndim, nlive=200, num_delete=100, num_repeats=24,
                   max_samples=6000, precision_criterion=1e-2)
    res = nested_sample(gaussian_loglike(sigma, ndim), jax.random.PRNGKey(7),
                        cfg)
    n_dead = int(res.n_dead) - cfg.nlive  # live fold-in isn't sampled
    evals_per_pass = (int(res.n_like) - cfg.nlive) / (n_dead * cfg.num_repeats)
    assert evals_per_pass < 7.0, evals_per_pass
    assert abs(float(res.logz)) < 4 * float(res.logzerr)


def test_max_samples_cap_and_static_shapes():
    ndim = 2
    ll = gaussian_loglike(0.02, ndim)
    cfg = NSConfig(ndim=ndim, nlive=100, max_samples=600, num_delete=50)
    res = nested_sample(ll, jax.random.PRNGKey(5), cfg)
    assert int(res.termination_reason) == 1  # hit the cap
    assert res.samples_u.shape == (600 + 100, ndim)
    assert int(res.n_dead) <= 700


def test_resample_equal_distribution():
    ndim, sigma = 2, 0.06
    res = nested_sample(
        gaussian_loglike(sigma, ndim),
        jax.random.PRNGKey(6),
        NSConfig(ndim=ndim, nlive=200, max_samples=20000),
    )
    samples, logl = resample_equal(jax.random.PRNGKey(42), res, 4000)
    s = np.asarray(samples)
    assert s.shape == (4000, ndim)
    assert np.all(np.abs(s.mean(axis=0) - 0.5) < 0.02)
    assert np.all(np.abs(s.std(axis=0) - sigma) < 0.02)


def test_evidence_unbiased_over_seeds():
    # Seed-ensemble calibration: the mean logZ over
    # many seeds must be consistent with the analytic truth, i.e. the
    # systematic bias must be small compared to the per-run scatter.  This is
    # the regression net for the batch-deletion threshold (off-by-one biases
    # +0.12 nats here) and the step-out slice kernel (truncated brackets
    # bias +0.15..0.34 nats at ndim=8).
    import functools

    ndim, sigma, nseeds = 4, 0.08, 24
    ll = gaussian_loglike(sigma, ndim)
    cfg = NSConfig(ndim=ndim, nlive=100, num_delete=25, max_samples=8000)
    run = jax.jit(functools.partial(nested_sample_device, ll, config=cfg))
    logzs = np.array([float(run(jax.random.PRNGKey(s)).logz) for s in range(nseeds)])
    sem = logzs.std(ddof=1) / np.sqrt(nseeds)
    assert abs(logzs.mean()) < max(3.0 * sem, 0.08), (logzs.mean(), sem)


def test_insertion_rank_uniformity():
    # Fowlie, Handley & Su (2020) diagnostic: replacement insertion ranks
    # among the survivors are uniform for a correctly constrained sampler.
    ndim, sigma = 3, 0.06
    cfg = NSConfig(ndim=ndim, nlive=120, num_delete=30, max_samples=9000)
    res = nested_sample(gaussian_loglike(sigma, ndim), jax.random.PRNGKey(11), cfg)
    diag = insertion_rank_test(res, cfg)
    assert diag.n > 1000
    assert diag.n_levels == 91
    assert diag.p_value > 0.005, diag
    assert diag.p_value_blocks > 0.005, diag
    # ranks fill the full support
    assert diag.ranks.min() == 0 and diag.ranks.max() == 90


def test_rank_block_scan_covers_tail():
    # The per-block scan must test the TRAILING partial block too: late-run
    # ranks are where under-mixing appears (tightest constrained region), so
    # a pathology confined to the final partial block must be flagged.
    from types import SimpleNamespace

    rng = np.random.default_rng(0)
    n_levels, block = 91, 91
    healthy = rng.integers(0, n_levels, size=10 * block)
    tail = np.zeros(block // 2 + 10, dtype=np.int64)  # stuck chains: rank 0
    ranks = np.concatenate([healthy, tail])
    fake = SimpleNamespace(insertion_rank=ranks)
    diag = insertion_rank_test(fake, nsurv=n_levels - 1)
    assert diag.p_value_blocks < 1e-6, diag.p_value_blocks
    # and an entirely healthy sequence of the same ragged length passes
    fake2 = SimpleNamespace(
        insertion_rank=rng.integers(0, n_levels, size=ranks.size)
    )
    diag2 = insertion_rank_test(fake2, nsurv=n_levels - 1)
    assert diag2.p_value_blocks > 0.01, diag2.p_value_blocks


def test_reproducible_with_same_key():
    ll = gaussian_loglike(0.05, 2)
    cfg = NSConfig(ndim=2, nlive=100, max_samples=10000)
    r1 = nested_sample(ll, jax.random.PRNGKey(7), cfg)
    r2 = nested_sample(ll, jax.random.PRNGKey(7), cfg)
    assert float(r1.logz) == float(r2.logz)
    assert int(r1.n_like) == int(r2.n_like)


def test_canonicalize_u_properties():
    # Gauge fixing must be a pure per-point coordinate permutation: active
    # triplets keep exactly their member set (z-sorted first), inactive
    # triplets follow, and the map is idempotent.
    from mcalf_tpu.sampler.nested import canonicalize_u

    rng = np.random.default_rng(0)
    startind, K, nfill = 1, 4, 2
    ndim = startind + 1 + 3 * (K + nfill)
    u = rng.random((64, ndim)).astype(np.float32)
    ncomp_vals = rng.uniform(1, K + 1, 64).astype(np.float32)
    out = np.asarray(canonicalize_u(jnp.asarray(u), (startind, K, nfill), jnp.asarray(ncomp_vals)))

    base = startind + 1
    for i in range(64):
        nact = int(ncomp_vals[i])
        trip_in = u[i, base : base + 3 * K].reshape(K, 3)
        trip_out = out[i, base : base + 3 * K].reshape(K, 3)
        # active set preserved as a set, z-sorted
        a_in = sorted(map(tuple, trip_in[:nact]), key=lambda t: t[1])
        a_out = list(map(tuple, trip_out[:nact]))
        assert a_out == a_in, i
        # inactive set preserved, z-sorted
        b_in = sorted(map(tuple, trip_in[nact:]), key=lambda t: t[1])
        b_out = list(map(tuple, trip_out[nact:]))
        assert b_out == b_in, i
        # head dims untouched
        assert np.array_equal(u[i, : base], out[i, : base])
    # idempotent
    out2 = np.asarray(canonicalize_u(jnp.asarray(out), (startind, K, nfill), jnp.asarray(ncomp_vals)))
    assert np.array_equal(out, out2)


def test_canon_layout_gauge_fixing_preserves_evidence():
    # A likelihood symmetric under swapping (dim1,dim2) <-> (dim3,dim4)
    # pairs: gauge fixing must leave logZ statistically unchanged.
    # Build a 2-component "triplet" toy in the mcalf layout:
    # [ncomp, (N,z,b) x 2] with likelihood symmetric in the two triplets.
    sigma = 0.1

    def ll(u):
        a = u[..., 1:4]
        b = u[..., 4:7]
        r2 = jnp.minimum(
            jnp.sum((a - 0.3) ** 2, -1) + jnp.sum((b - 0.7) ** 2, -1),
            jnp.sum((a - 0.7) ** 2, -1) + jnp.sum((b - 0.3) ** 2, -1),
        )
        return (-0.5 * r2 / sigma**2).astype(jnp.float32)

    cfg0 = NSConfig(ndim=7, nlive=100, max_samples=8000)
    cfg1 = NSConfig(
        ndim=7, nlive=100, max_samples=8000,
        canon_layout=(0, 2, 0, 2.0, 2.0),
    )
    z0 = np.mean([
        float(nested_sample(ll, jax.random.PRNGKey(s), cfg0).logz)
        for s in range(6)
    ])
    z1 = np.mean([
        float(nested_sample(ll, jax.random.PRNGKey(s), cfg1).logz)
        for s in range(6)
    ])
    assert abs(z0 - z1) < 0.4, (z0, z1)


@pytest.mark.parametrize("clusters", [False, True])
def test_covariance_products_at_highest_precision(clusters):
    """The whitening covariance products ask for HIGHEST precision: on a
    GPU a float32 product may otherwise run in TF32, and a TF32
    covariance of a contracted live set can turn the Cholesky NaN."""
    from jax import lax

    from mcalf_tpu.sampler.nested import whitening_factors

    surv = jnp.asarray(
        np.random.default_rng(0).uniform(size=(40, 5)), jnp.float32
    )
    labels = jnp.asarray(np.arange(40) % 3, jnp.int32) if clusters else None
    jaxpr = jax.make_jaxpr(lambda s: whitening_factors(s, labels, 4))(surv)

    def dots(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    sub = getattr(sub, "jaxpr", sub)  # ClosedJaxpr -> Jaxpr
                    if hasattr(sub, "eqns"):
                        yield from dots(sub)

    found = list(dots(jaxpr.jaxpr))
    # global: one product; clustered: + the means and the 3-operand einsum (2)
    assert len(found) == (4 if clusters else 1)
    for eqn in found:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == lax.Precision.HIGHEST for p in prec
        ), prec
    chol, logw = whitening_factors(surv, labels, 4)
    assert np.all(np.isfinite(np.asarray(chol)))
