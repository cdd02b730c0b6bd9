"""The device likelihood (models/jax_model.py) against float64 references:
the tau synthesis against an f64-u evaluation, the D0 redshift table, the
floating-resolution/continuum likelihood against the host model, and the
platform policy (one XLA likelihood on every platform, no kernel switch)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from mcalf_tpu.models import AbsorptionModel, make_jax_forward
from mcalf_tpu.models.forward import CCGS, TAU_CONST
from mcalf_tpu.models.jax_model import (
    build_consts,
    lnl_tolerance,
    static_spec,
    synth_tau,
)
from mcalf_tpu.ops.faddeeva import hjert


@pytest.fixture(scope="module")
def problem(testdata_dir):
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(2, 3),
        nfill=1,
        specres=[8.0],
        zrange=[2.99, 3.01],
    )
    c = build_consts(m)
    tab = m.transition_table()
    nujk64 = CCGS / (tab["wrest"] / 1e8)
    cw64 = CCGS / (m.obj_wl / 1e8)

    rng = np.random.default_rng(0)
    B = 13
    lo, hi = m.bounds_lo, m.bounds_hi
    p = (lo + rng.uniform(0.1, 0.9, size=(B, m.ndim)) * (hi - lo)).astype(np.float32)
    N = p[:, c["pidx"]]
    z = p[:, c["pidx"] + 1]
    b = p[:, c["pidx"] + 2]
    # dz must be formed against the f64 zmid the d0 table was built with
    # (the production cube path does this implicitly: u=0.5 IS the f64
    # midpoint); differencing against the f32-rounded zmid shifts filler u
    # by ~8e-4.
    zmid64 = 0.5 * (
        np.asarray(m.bounds_lo, np.float64)[tab["pidx"] + 1]
        + np.asarray(m.bounds_hi, np.float64)[tab["pidx"] + 1]
    )
    dz = (z.astype(np.float64) - zmid64).astype(np.float32)
    dnu = (b * 1e5 * c["inv_wrest_cm"]).astype(np.float32)
    av = (c["gamma"] / (4 * np.pi * dnu)).astype(np.float32)
    nact = np.floor(p[:, m.startind])
    active = (c["comp_id"][None, :] < nact[:, None]) | c["is_fill"][None, :]
    gain = (TAU_CONST * 10.0**N * c["f"] / dnu * active).astype(np.float32)
    return m, c, z, dz, gain, av, dnu, nujk64, cw64


def _tau_f64_u(z, gain, av, dnu, nujk64, cw64):
    """Reference: u in float64 (the quantity the d0 + dz*cw path
    reconstructs), H and the sum in float32."""
    u64 = (
        (1.0 + z.astype(np.float64))[:, :, None] * cw64[None, None, :]
        - nujk64[None, :, None]
    ) / dnu.astype(np.float64)[:, :, None]
    H = hjert(jnp.asarray(u64, jnp.float32), jnp.asarray(av)[..., None])
    return jnp.sum(jnp.asarray(gain)[..., None] * H, axis=-2)


def test_tau_matches_f64_u_reference(problem):
    m, c, z, dz, gain, av, dnu, nujk64, cw64 = problem
    # the production evaluation (Harris / windowed, per the static flags)
    s = static_spec(m)
    cj = {k: jnp.asarray(v) for k, v in c.items()}
    got = np.asarray(synth_tau(dz, gain, av, dnu, cj, s))
    want = np.asarray(_tau_f64_u(z, gain, av, dnu, nujk64, cw64))
    assert got.shape == want.shape == (len(z), m.npix)
    # d0 + dz*cw u reconstruction: agreement at f32 roundoff relative to
    # the local tau scale (the f32 u carries ~1e-4 absolute error, see the
    # D0 test below; measured 3.1e-5 on this mock).
    err = np.abs(got - want) / (np.abs(want) + 1e-3)
    assert np.max(err) < 5e-5, np.max(err)


def test_d0_table_reconstructs_f64_u(problem):
    """The static D0 table plus the f32 dz*cw product reproduce the f64 u to
    ~1e-4 absolute (vs ~2e-3 for a naive f32 (1+z)*cw - nu0)."""
    m, c, z, dz, gain, av, dnu, nujk64, cw64 = problem
    d0 = np.asarray(c["d0"])
    cw32 = np.asarray(c["c_over_wave"])
    u64 = (
        (1.0 + z.astype(np.float64))[:, :, None] * cw64[None, None, :]
        - nujk64[None, :, None]
    ) / dnu.astype(np.float64)[:, :, None]
    u32 = (
        d0[None, :, :].astype(np.float64)
        + (dz.astype(np.float64)[:, :, None] * cw32.astype(np.float64))
    ) / dnu.astype(np.float64)[:, :, None]
    assert np.max(np.abs(u32 - u64)) < 1e-3
    # and it is much better than the naive f32 assembly
    u_naive = (
        ((1.0 + z)[:, :, None] * cw32[None, None, :]).astype(np.float32)
        - (nujk64.astype(np.float32))[None, :, None]
    ) / dnu[:, :, None]
    assert np.max(np.abs(u32 - u64)) < 0.1 * max(
        np.max(np.abs(u_naive - u64)), 1e-3
    )


def test_floating_specres_and_cont_matches_host_f64(testdata_dir):
    """FLOATING specres (per-sample LSF kernels) + floating continuum +
    asymmlike: the device likelihood (with the host's circular convolution
    boundary) agrees with the float64 host model within the float32 bound
    (jax_model.lnl_tolerance), rejections included.  Evaluated at
    perturbations of the mock's generative truth so the asymmlike gate
    accepts most points."""
    from mcalf_tpu import mocks

    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec_multicomp.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11),
        specres=[6.0, 10.0],
        contval=[0.9, 1.1],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
        Asymmlike=True,
    )
    fwd = make_jax_forward(m, conv_mode="wrap")
    assert fwd.static.freespecres and fwd.static.freecont
    lo = np.asarray(m.bounds_lo, np.float64)
    hi = np.asarray(m.bounds_hi, np.float64)
    # The out-of-prior b=8 component is parked at 10.5, the 11th triplet
    # mid-prior.
    bs = [max(b, 10.5) for b in mocks.B_TRUE]
    p = [8.0, 1.0, 10.5]
    for N, z, b in zip(mocks.N_TRUE, mocks.Z_TRUE, bs):
        p += [N, z, b]
    p += [13.0, 3.0, 20.0]
    u0 = (np.array(p) - lo) / (hi - lo)
    rng = np.random.default_rng(1)
    u = np.clip(
        u0[None] + rng.normal(0, 5e-4, size=(37, m.ndim)), 1e-4, 1 - 1e-4
    ).astype(np.float32)
    dev = np.asarray(fwd.loglike_cube(u), np.float64)
    p64 = lo + u.astype(np.float64) * (hi - lo)
    host = np.array([m.lnlhood(pi) for pi in p64])
    assert np.array_equal(np.isfinite(dev), np.isfinite(host))
    fin = np.isfinite(host)
    assert fin.sum() > 20, fin.sum()
    v = m.valid
    resid = np.array([m.obj[v] - m.reconstruct_spec(pi)[v] for pi in p64[fin]])
    tol = lnl_tolerance(resid, 1.0 / m.obj_noise[v] ** 2, host[fin])
    assert np.all(np.abs(dev[fin] - host[fin]) <= tol), (
        np.max(np.abs(dev[fin] - host[fin]) / tol)
    )


def test_one_xla_likelihood_on_every_platform(testdata_dir):
    """No kernel switch exists: the likelihood is the plain XLA path on
    every platform, with no option that picks another."""
    import importlib.util
    import inspect

    import mcalf_tpu.models.jax_model as jm

    assert importlib.util.find_spec("mcalf_tpu.ops.voigt_pallas") is None
    assert "use_pallas" not in inspect.signature(make_jax_forward).parameters
    assert not any("pallas" in f.name for f in dataclasses.fields(jm.StaticSpec))
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
        zrange=[2.99, 3.01],
    )
    fwd = make_jax_forward(m)
    ll = np.asarray(fwd.loglike_cube(jnp.full((3, m.ndim), 0.5, jnp.float32)))
    assert np.all(np.isfinite(ll))
