"""Sampler calibration against a brute-force ground-truth evidence.

The 1-component CIV fit on the shipped mock is small enough (3 informative
dims) that its evidence can be computed by dense-grid quadrature
(tools/truth_anchor.py): logZ = 4985.51 on the f32 likelihood, with
vanishing edge weights and ~20 grid points per posterior sigma.

This anchor caught a chain of real sampler defects in round 2 (each
invisible on analytic-Gaussian tests): a -1.65 nat bias from f32 redshift
quantization, and a residual -1.4 nat over-compression from
under-decorrelated slice chains whose cure is the 3-way direction mixture +
8*ndim repeats (sampler/nested.py).  Keep it: any kernel change that
reintroduces a bias > ~2x the quoted logzerr fails here.

Deterministic (fixed keys), so there is no flake margin to tune.
"""

import jax
import numpy as np
import pytest

from mcalf_tpu.models import AbsorptionModel, make_jax_forward
from mcalf_tpu.sampler import NSConfig, insertion_rank_test, nested_sample

# tools/truth_anchor.py on the repo's testdata/civ_mock_spec.txt (the
# testdata_dir fixture; f32 likelihood, platform differences well below
# the tolerance used here).  The reference's own mock is a DIFFERENT
# dataset (1998 pixels from 6180.02001 A vs the repo's 2000 from 6180.0);
# its evidence is ~1.9 nats lower (4983.62).
QUADRATURE_LOGZ = 4985.51


@pytest.fixture(scope="module")
def anchor_results(testdata_dir):
    model = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    fwd = make_jax_forward(model)
    cfg = NSConfig(ndim=4, nlive=200, max_samples=12000)
    out = []
    for seed in (0, 1, 2):
        res = nested_sample(fwd.loglike_cube, jax.random.PRNGKey(seed), cfg)
        jax.block_until_ready(res.logz)
        out.append(res)
    return out, cfg


def test_logz_matches_quadrature(anchor_results):
    results, _ = anchor_results
    logzs = np.array([float(r.logz) for r in results])
    errs = np.array([float(r.logzerr) for r in results])
    # 3-seed mean within 1.5x the per-run error of the truth: with
    # per-run sigma ~0.31 this is a ~2.6-sigma bound on the mean -- tight
    # enough to catch a bias well below the round-1/2 defects (-1.4 to
    # -1.65 nats, i.e. >7 sigma here), loose enough not to flake on a JAX
    # upgrade re-rolling the fixed-key streams (measured seeds 0-3 on CPU:
    # 4983.92/4983.34/4983.17/4983.05, truth 4983.62).
    assert abs(logzs.mean() - QUADRATURE_LOGZ) < 1.5 * errs.mean(), (
        logzs,
        QUADRATURE_LOGZ,
    )


def test_rank_uniformity_on_real_problem(anchor_results):
    results, cfg = anchor_results
    ps = [insertion_rank_test(r, cfg).p_value for r in results]
    assert max(ps) > 0.05, ps
    assert min(ps) > 1e-4, ps


# Quadrature posterior moments on the same grid (tools/truth_anchor.py,
# 8-digit run on the reference fixture): physical-units mean/sd of the
# (N, z, b) marginals.  These gate posterior BIAS, not just evidence bias
# (the reference's user-facing outputs are posterior percentiles,
# cli.py:298-325).
QUAD_MOMENTS = {
    # dim index in the parameter vector -> (mean, sd)
    1: (13.79954507, 0.00303261),   # N
    2: (3.00000061, 0.00000095),    # z  (grid step ~5e-7 = sd/2: mean is
    #    solid, sd carries a few-percent discretization error -- inside
    #    the 35% test band)
    3: (14.85742690, 0.09325418),   # b
}


def _weighted_moments(res, fwd_bounds, dim):
    logp = np.asarray(res.log_posterior_weights, np.float64)
    u = np.asarray(res.samples_u, np.float64)[:, dim]
    ok = np.isfinite(logp)
    w = np.exp(logp[ok] - logp[ok].max())
    w /= w.sum()
    lo, hi = fwd_bounds
    x = lo + u[ok] * (hi - lo)
    mu = float((w * x).sum())
    sd = float(np.sqrt((w * (x - mu) ** 2).sum()))
    return mu, sd


def test_posterior_moments_match_quadrature(anchor_results, testdata_dir):
    model = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    results, _ = anchor_results
    lo = np.asarray(model.bounds_lo, np.float64)
    hi = np.asarray(model.bounds_hi, np.float64)
    for dim, (mu_t, sd_t) in QUAD_MOMENTS.items():
        mus, sds = zip(
            *(
                _weighted_moments(r, (lo[dim], hi[dim]), dim)
                for r in results
            )
        )
        # 3-seed pooled mean within 0.3 posterior-sigma of the quadrature
        # truth: the MC error of one run's mean is ~sd/sqrt(ESS) ~ 0.03 sd
        # (ESS ~ 1e3), so this is a ~5x margin that still catches
        # sigma-scale biases (the round-2 f32-z quantization bias was
        # ~1 sd in z and would fail here by >3x).
        pooled = float(np.mean(mus))
        assert abs(pooled - mu_t) < 0.3 * sd_t, (dim, mus, mu_t, sd_t)
        # Every run's posterior width within 35% of the quadrature width:
        # catches over-compression (under-decorrelated chains shrink the
        # posterior) and overdispersion both.
        for sd in sds:
            assert 0.65 * sd_t < sd < 1.35 * sd_t, (dim, sds, sd_t)
