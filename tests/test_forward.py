"""Golden-model tests for the forward model against the mock spectra
(SURVEY.md sections 4 and 6.2).

The mocks in testdata/ were generated by mcalf_tpu/mocks.py -- the
reference generator's construction on a log-uniform grid -- with numpy
seed 42 noise at sigma=0.02.  Stripping that noise recovers the noiseless
truth exactly, so reconstructing it with the model on the mock's full grid
is a machine-precision parity test of the whole physics pipeline: atomic
data, Voigt tau, LSF convolution, parameter layout.
"""

import numpy as np
import pytest

from mcalf_tpu import mocks
from mcalf_tpu.models import AbsorptionModel, CLIGHT_KMS, make_jax_forward

# Multicomponent truth (reference testdata/generate_from_model.py:12-14).
Z_TRUE, N_TRUE, B_TRUE = mocks.Z_TRUE, mocks.N_TRUE, mocks.B_TRUE


def _noise(npix):
    # Mock noise: np.random.seed(42); normal(0, 0.02) over the mock's
    # whole grid (mocks.py; reference generate_from_model.py:52-56).
    rng = np.random.RandomState(mocks.NOISE_SEED)
    return rng.normal(0, mocks.NOISE_SIGMA, size=npix)


def _full_grid(path, ncomp):
    """The mock on its full grid: the fit range's open ends drop the
    outermost pixels, whose noise draws the noiseless check needs."""
    return AbsorptionModel.from_file(
        path,
        fitrange=[(6179.0, 6221.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=ncomp,
        specres=[8.0],
    )


@pytest.fixture(scope="module")
def single_model(testdata_dir):
    return AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
    )


@pytest.fixture(scope="module")
def multi_model(testdata_dir):
    return AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec_multicomp.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )


def test_layout_and_velstep(single_model, multi_model):
    # ndim = 1 (ncomp) + 3*ncompmax; velstep from the mock's log-uniform
    # grid (mocks.log_uniform_grid: wave ratio 1 + 0.96755464/c per pixel;
    # the model measures c * dlambda / lambda_hi = c * (1 - 1/ratio)).
    assert single_model.ndim == 4
    assert multi_model.ndim == 1 + 3 * 11 == 34
    assert single_model.startind == 0
    ratio = 1.0 + 0.96755464 / CLIGHT_KMS
    assert abs(single_model.velstep - CLIGHT_KMS * (1.0 - 1.0 / ratio)) < 1e-9
    # 2000 grid pixels; the open fit range drops the one at 6180.0 exactly
    assert single_model.npix == 1999


def test_singlecomp_mock_machine_precision(testdata_dir):
    m = _full_grid(f"{testdata_dir}/civ_mock_spec.txt", (1, 1))
    assert m.npix == 2000
    p = np.array([1.0, 13.8, 3.0, 15.0])  # [ncomp, N, z, b]
    model = m.reconstruct_spec(p)
    noiseless = m.obj - _noise(m.npix)
    assert np.max(np.abs(model - noiseless)) < 1e-12


def test_multicomp_mock_machine_precision(testdata_dir):
    # The generator built the multicomp mock as the PRODUCT of individually
    # convolved single-component spectra (generate_from_model.py:42-45).
    m = _full_grid(f"{testdata_dir}/civ_mock_spec_multicomp.txt", (8, 11))
    assert m.npix == 2000
    model = np.ones(m.npix)
    for N, z, b in zip(N_TRUE, Z_TRUE, B_TRUE):
        p = np.array([1.0, N, z, b])
        single = AbsorptionModel(
            wave=m.obj_wl, flux=m.obj, noise=m.obj_noise, lines=m.lines,
            ncomp=(1, 1), specres=[8.0],
        )
        model *= single.reconstruct_spec(p)
    noiseless = m.obj - _noise(m.npix)
    assert np.max(np.abs(model - noiseless)) < 1e-12


def test_jax_matches_numpy_interior(single_model):
    """The JAX float32 path must agree with the float64 numpy path away from
    the convolution edges (different edge semantics by design)."""
    m = single_model
    fwd = make_jax_forward(m, conv_mode="same_edge")
    p = np.array([1.0, 13.8, 3.0, 15.0])
    got = np.asarray(fwd.reconstruct(p.astype(np.float32)))
    want = m.reconstruct_spec(p)
    half = m.kernel_half_size()
    interior = slice(2 * half, m.npix - 2 * half)
    # wrap vs zero-pad only differs within half of the edges; compare
    # interior.  f32 parameter quantization limits agreement to ~3e-4 at the
    # line cores (same for the reference's f32 JAX path); measured 2.64e-4.
    assert np.max(np.abs(got[interior] - want[interior])) < 1e-3


def test_jax_wrap_mode_matches_numpy_everywhere(single_model):
    m = single_model
    fwd = make_jax_forward(m, conv_mode="wrap")
    p = np.array([1.0, 13.8, 3.0, 15.0])
    got = np.asarray(fwd.reconstruct(p.astype(np.float32)))
    want = m.reconstruct_spec(p)
    assert np.max(np.abs(got - want)) < 1e-3


def test_jax_batched_shapes(multi_model):
    m = multi_model
    fwd = make_jax_forward(m)
    rng = np.random.default_rng(0)
    u = rng.uniform(size=(5, 7, m.ndim)).astype(np.float32)
    p = np.asarray(fwd.cube_to_params(u))
    flux = np.asarray(fwd.reconstruct(p))
    ll = np.asarray(fwd.loglike(p))
    assert flux.shape == (5, 7, m.npix)
    assert ll.shape == (5, 7)
    assert np.isfinite(ll).all()
    # Batched result equals per-vector result (up to f32 reduction-order
    # noise: |ll| ~ 1e5 here, so compare relatively).
    single = np.asarray(fwd.loglike(p[2, 3]))
    assert np.allclose(ll[2, 3], single, rtol=1e-6, atol=1e-3)


def test_ncomp_masking_transdimensional(multi_model):
    """Inactive components (i >= floor(ncomp)) must not affect the model."""
    m = multi_model
    fwd = make_jax_forward(m)
    p = np.zeros(m.ndim, np.float32)
    p[0] = 8.4  # floor -> 8 active components
    for i in range(11):
        p[1 + 3 * i : 4 + 3 * i] = [13.0, 3.0 + 1e-4 * i, 20.0]
    base = np.asarray(fwd.reconstruct(p))
    p2 = p.copy()
    p2[1 + 3 * 9 : 4 + 3 * 9] = [14.5, 3.005, 40.0]  # change INACTIVE comp 9
    assert np.array_equal(base, np.asarray(fwd.reconstruct(p2)))
    p3 = p.copy()
    p3[1 + 3 * 7 : 4 + 3 * 7] = [14.5, 3.005, 40.0]  # change ACTIVE comp 7
    assert not np.array_equal(base, np.asarray(fwd.reconstruct(p3)))


def test_loglike_parity_f64_vs_f32(single_model):
    """Device f32 log-likelihood vs host f64 at the truth: tight agreement."""
    m = single_model
    fwd = make_jax_forward(m)
    p = np.array([1.0, 13.8, 3.0, 15.0])
    got = float(fwd.loglike(p.astype(np.float32)))
    want = m.lnlhood(p)
    # The two paths use different convolution edge semantics (by reference
    # design) and different precision; at ll ~ +5500 allow small abs diff.
    assert abs(got - want) < 1.0, (got, want)


def test_asymmlike_rejects_bad_fit(single_model, testdata_dir):
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
        Asymmlike=True,
    )
    fwd = make_jax_forward(m)
    good = np.array([1.0, 13.8, 3.0, 15.0], np.float32)
    # A deep spurious absorber the data doesn't have -> many >5 sigma
    # positive residuals -> rejected.
    bad = np.array([1.0, 14.8, 3.0003, 25.0], np.float32)
    assert np.isfinite(float(fwd.loglike(good)))
    assert float(fwd.loglike(bad)) == -np.inf
    # host path agrees
    assert np.isfinite(m.lnlhood(good))
    assert m.lnlhood(bad) == -np.inf


def test_filler_components_always_active(testdata_dir):
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 2),
        nfill=2,
        specres=[8.0],
    )
    assert m.ndim == 1 + 3 * 2 + 3 * 2
    assert m.linefill.wrest == 250.0
    # Filler z-range maps the observed window through wrest=250.
    zlo, zhi = m.z_lims_fill[0]
    assert 6180.0 / 250.0 - 1 < zlo < zhi < 6220.0 / 250.0 - 1
    fwd = make_jax_forward(m)
    p = np.zeros(m.ndim, np.float32)
    p[0] = 1.2
    p[1:4] = [13.8, 3.0, 15.0]
    p[4:7] = [12.0, 3.0, 15.0]   # inactive target comp
    p[m.endind : m.endind + 3] = [13.5, 6198.0 / 250.0 - 1.0, 15.0]
    p[m.endind + 3 : m.endind + 6] = [12.0, 6205.0 / 250.0 - 1.0, 15.0]
    flux = np.asarray(fwd.reconstruct(p))
    base_p = p.copy()
    base_p[m.endind : m.endind + 3] = [0.0, 6198.0 / 250.0 - 1.0, 15.0]
    # N=0 -> tau ~ 1e-13ish; filler absorption must have changed the flux.
    assert not np.allclose(flux, np.asarray(fwd.reconstruct(base_p)), atol=1e-4)
    # numpy path agrees that fillers absorb (targonly drops them).
    full = m.reconstruct_spec(np.asarray(p, np.float64))
    targ = m.reconstruct_spec(np.asarray(p, np.float64), targonly=True)
    assert np.max(np.abs(full - targ)) > 1e-3


def test_gpriors_applied_on_device(testdata_dir):
    """Gaussian priors (the reference's dead Gpriors path, implemented live
    here) shift the device log-likelihood by the expected amount."""
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(1, 1),
        specres=[8.0],
        Gpriors=["none", "none", "13.8", "0.1", "none", "none", "none", "none"],
    )
    plain = make_jax_forward(m, gpriors=False)
    withgp = make_jax_forward(m, gpriors=True)
    p = np.array([1.0, 13.6, 3.0, 15.0], np.float32)  # 2 sigma off the prior
    d = float(plain.loglike(p)) - float(withgp.loglike(p))
    want = 0.5 * ((13.6 - 13.8) / 0.1) ** 2 + 0.5 * np.log(2 * np.pi * 0.1**2)
    assert abs(d - want) < 1e-2, (d, want)


def test_empty_or_reversed_wavefit_raise_clearly(testdata_dir):
    """Degenerate fit ranges used to surface as 'cannot convert float NaN
    to integer' from the velstep statistics; now they raise actionable
    ValueErrors at model construction."""
    import pytest

    for bad, match in (
        ([(5000.0, 5100.0)], "select"),        # outside the spectrum
        ([(6220.0, 6180.0)], "reversed"),      # reversed pair
    ):
        with pytest.raises(ValueError, match=match):
            AbsorptionModel.from_file(
                f"{testdata_dir}/civ_mock_spec.txt",
                fitrange=bad,
                fitlines=["CIV 1548", "CIV 1550"],
                ncomp=(1, 1),
                specres=[8.0],
            )
