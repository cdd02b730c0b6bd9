"""Tests that need the card (marker ``gpu``).  They skip elsewhere, with the
reason; ``python chip_smoke.py`` runs them on the GPU in its last phase."""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_whitening_covariance_full_precision_on_card(gpu_device):
    """A contracted survivor cloud, as late in a fit: the covariance
    products run at HIGHEST precision, so the Cholesky factor reproduces
    the float64 covariance (TF32 would keep ~3 digits and can turn it
    NaN).  The spread keeps the 1e-10 jitter below 1e-6 of the variance."""
    import jax
    import jax.numpy as jnp

    from mcalf_tpu.sampler.nested import whitening_factors

    rng = np.random.default_rng(5)
    ndim, n = 34, 100
    a = rng.normal(size=(ndim, ndim))
    surv = 0.5 + 1e-2 * rng.normal(size=(n, ndim)) @ (a / np.sqrt(ndim))
    chol, _ = jax.jit(whitening_factors, static_argnums=2)(
        jax.device_put(jnp.asarray(surv, jnp.float32), gpu_device), None, 1
    )
    chol = np.asarray(chol[0], np.float64)
    assert np.all(np.isfinite(chol))
    x = np.asarray(np.float32(surv), np.float64)
    want = np.cov(x, rowvar=False)
    got = chol @ chol.T
    scale = np.sqrt(np.outer(np.diag(want), np.diag(want)))
    # HIGHEST: ~1e-6; a TF32 product would read ~1e-3 here
    assert np.max(np.abs(got - want) / scale) < 1e-4


def test_loglike_on_card_matches_cpu_backend(gpu_device, testdata_dir):
    """The flagship likelihood at the production batch on the card agrees
    with the same jitted function on the CPU backend to float32 roundoff
    (the two backends differ in transcendental implementations and sum
    order only)."""
    import jax
    import jax.numpy as jnp

    from mcalf_tpu.config import readconfig
    from mcalf_tpu.models import make_jax_forward
    from mcalf_tpu.runner import build_model

    cp = readconfig(f"{testdata_dir}/fit.cfg")
    cp["specfile"] = f"{testdata_dir}/civ_mock_spec_multicomp.txt"
    model = build_model(cp)
    fwd = make_jax_forward(model)
    u = np.random.default_rng(1).uniform(size=(100, model.ndim))
    u = jnp.asarray(u, jnp.float32)
    on_card = np.asarray(fwd.loglike_cube(jax.device_put(u, gpu_device)))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        fwd_cpu = make_jax_forward(model)
        on_cpu = np.asarray(fwd_cpu.loglike_cube(jax.device_put(u, cpu)))
    rel = np.abs(on_card - on_cpu) / (np.abs(on_cpu) + 1.0)
    assert np.max(rel) < 2e-5, np.max(rel)
