"""Wing-window machinery (ops.faddeeva.hjert_wing / hjert_harris_win).

The windowed likelihood replaces the full Harris Voigt-Hjerting evaluation
by its far-wing tail polynomial wherever u^2 exceeds a static threshold
derived from the prior's tau-amplitude bound (StaticSpec.win_tmin).  These
tests pin the contracts:

1. the wing IS the Harris tail: |hjert_harris - hjert_wing| equals the
   dropped e^{-u^2} terms exactly (bounded, not approximated);
2. the thresholds follow the static prior bound, and MCALF_TPU_WINDOW=0
   switches windowing off;
3. windowing changes the likelihood by no more than the dropped
   exponential, also when windowed and 916-branch transitions mix.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from mcalf_tpu.models import AbsorptionModel, make_jax_forward
from mcalf_tpu.models.forward import TAU_CONST
from mcalf_tpu.models.jax_model import static_spec
from mcalf_tpu.ops.faddeeva import (
    HJERT_WIN_TMIN,
    hjert_harris,
    hjert_harris_win,
    hjert_wing,
)


def test_hjert_wing_is_the_harris_tail():
    # For u^2 >= 16 hjert_harris evaluates its tail polynomial; the wing
    # differs from it by EXACTLY the dropped e^{-u^2}(1 + a^2(1 - 2u^2))
    # term.  Check the bound |harris - wing| <= e^{-t} (1 + 2 a^2 t) over
    # the windowed regime.
    u = np.linspace(np.sqrt(HJERT_WIN_TMIN), 60.0, 4001).astype(np.float32)
    for a in (1e-5, 1e-4, 1e-3):
        av = np.float32(a)
        h = np.asarray(hjert_harris(jnp.asarray(u), av), np.float64)
        w = np.asarray(hjert_wing(jnp.asarray(u), av), np.float64)
        t = u.astype(np.float64) ** 2
        bound = np.exp(-t) * (1.0 + 2.0 * a * a * t) + 1e-11
        assert np.all(np.abs(h - w) <= bound + 4e-7 * np.abs(h)), (
            a, np.max(np.abs(h - w) - bound)
        )


def test_hjert_harris_win_accuracy_vs_scipy():
    from scipy.special import wofz

    u = np.concatenate(
        [np.linspace(0.0, 30.0, 30001), np.linspace(30.0, 500.0, 5001)]
    ).astype(np.float32)
    for a in (1e-5, 3e-4, 1e-3):
        got = np.asarray(
            hjert_harris_win(jnp.asarray(u), np.float32(a), HJERT_WIN_TMIN),
            np.float64,
        )
        want = np.real(wofz(u.astype(np.float64) + 1j * a))
        # relative where H is appreciable, absolute (the dropped exp) in the
        # deep wing -- the production threshold guarantees the ABSOLUTE
        # error stays irrelevant at the tau level (amp_max * 1e-9 < 1e-8).
        err = np.abs(got - want)
        assert np.all(err <= 3e-6 * np.abs(want) + 1.1e-9), (
            a, np.max(err - 3e-6 * np.abs(want))
        )


@pytest.fixture(scope="module")
def flagship(testdata_dir):
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec_multicomp.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    return m


def test_static_spec_win_tmin(flagship, monkeypatch):
    s = static_spec(flagship)
    # CIV is Harris-regime; thresholds = max(floor, ln(amp_max * 1e8)).
    assert all(v >= HJERT_WIN_TMIN for v in s.win_tmin)
    assert all(h for h in s.harris)
    tab = flagship.transition_table()
    b_lo = flagship.bounds_lo[tab["pidx"] + 2]
    dnu_min = b_lo * 1e5 * (1e8 / tab["wrest"])
    amp_max = TAU_CONST * 10.0 ** flagship.bounds_hi[tab["pidx"]] * tab[
        "f"
    ] / dnu_min
    want = np.maximum(HJERT_WIN_TMIN, np.log(amp_max * 1e8))
    assert np.allclose(s.win_tmin, want, rtol=1e-12)
    # and the dropped term is below the 1e-8 tau contract
    assert np.all(amp_max * np.exp(-np.asarray(s.win_tmin)) < 1.1e-8)
    # env kill switch
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    s0 = static_spec(flagship)
    assert all(v == 0.0 for v in s0.win_tmin)


def test_mixed_windowed_and_plain_transitions(testdata_dir, monkeypatch):
    """A model mixing Harris-regime (windowed) and strong-damping (916,
    never windowed) transitions: windowing only touches the windowed
    transitions, so the likelihood matches the unwindowed one to the
    dropped-exponential bound."""
    m = AbsorptionModel.from_file(
        f"{testdata_dir}/civ_mock_spec_multicomp.txt",
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "HI 1215"],
        ncomp=(1, 3),
        nfill=1,
        specres=[8.0],
        Nrange=[12.0, 14.5],
        # b_lo = 5 km/s puts HI 1215 above HARRIS_A_MAX (a = 1.2e-3, the
        # 916 branch) while CIV 1548 stays Harris/windowed (a = 6.5e-4)
        brange=[5.0, 40.0],
        zrange=[2.99, 3.01],
    )
    s = static_spec(m)
    # the mix is real: some pairs windowed, some not
    assert any(v > 0 for v in s.win_tmin) and any(
        v == 0 for v in s.win_tmin
    ), s.win_tmin
    assert not all(s.harris)
    f_win = make_jax_forward(m)
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    f_plain = make_jax_forward(m)
    rng = np.random.default_rng(4)
    u = rng.uniform(0.05, 0.95, size=(24, m.ndim)).astype(np.float32)
    la = np.asarray(f_plain.loglike_cube(u))
    lb = np.asarray(f_win.loglike_cube(u))
    assert np.allclose(la, lb, rtol=1e-5, atol=0.5), (
        np.max(np.abs(la - lb))
    )


def test_windowed_matches_unwindowed_likelihood(flagship, monkeypatch):
    """End-to-end: windowing changes the log-likelihood by no more than the
    dropped-exponential tau bound (far below f32 chi^2 roundoff)."""
    fwd_w = make_jax_forward(flagship)
    assert any(v > 0 for v in fwd_w.static.win_tmin)
    monkeypatch.setenv("MCALF_TPU_WINDOW", "0")
    fwd_0 = make_jax_forward(flagship)
    assert all(v == 0 for v in fwd_0.static.win_tmin)
    rng = np.random.default_rng(9)
    u = rng.uniform(0.02, 0.98, size=(64, flagship.ndim)).astype(np.float32)
    lw = np.asarray(fwd_w.loglike_cube(u), np.float64)
    l0 = np.asarray(fwd_0.loglike_cube(u), np.float64)
    # |dll| <= ivar-weighted propagation of |dtau| <= T * 1e-8; in practice
    # the difference is dominated by f32 evaluation-order roundoff of the
    # chi^2 sum itself -- bound it at that scale.
    assert np.max(np.abs(lw - l0) / (np.abs(l0) + 1.0)) < 3e-6, (
        np.max(np.abs(lw - l0))
    )


def test_hjert_wing_even_symmetry():
    # H(u, a) is even in u; the wing depends on u only through u^2 and must
    # be exactly symmetric (the window can sit on either side of the line).
    u = np.linspace(5.0, 40.0, 1001).astype(np.float32)
    a = np.float32(3e-4)
    wp = np.asarray(hjert_wing(jnp.asarray(u), a))
    wm = np.asarray(hjert_wing(jnp.asarray(-u), a))
    assert np.array_equal(wp, wm)
