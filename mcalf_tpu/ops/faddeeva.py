"""Vectorized Voigt--Hjerting / Faddeeva special functions for the device.

Computes H(u, a) = Re[w(u + i a)] where w is the Faddeeva function, the
kernel of the Voigt absorption profile.  Everything here is elementwise and
fully vectorized: inputs are arrays of any (broadcastable) shape and the
functions evaluate in a single fused XLA computation -- there is
no per-element ``vmap`` and no data-dependent control flow, which is what
an accelerator wants (contrast with the reference, which vmaps a scalar ``hjert`` over
the wavelength axis: /root/reference/mcalf/routines/voigt_jax.py:121-127 and
hires_fitter.py:595).

Numerical method (float32, matching the reference's accuracy bar of
<= 2.4e-6 relative error vs. scipy.special.wofz over a in [1e-4, 1],
u in [0, 100]):

* ``erfcx`` -- scaled complementary error function, rational Chebyshev
  approximation of Shepherd & Laframboise (1981), valid for x > -9.3.
* ``wofz_real_916`` -- Re[w(x+iy)] via Algorithm 916 (Zaghloul & Ali 2011)
  with grid spacing h = 1/2; series terms are *generated programmatically*
  (a_n = n/2, n = 1..N_TERMS) rather than hard-coded tables.
* ``wofz_real_asym`` -- large-|z| asymptotic continued-fraction expansion.
* ``hjert`` -- region switch at u^2 + a^2 = 111 (same switch radius as the
  reference, voigt_jax.py:127, which is where the 916 series with 27 terms
  stops being accurate in float32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "erfcx",
    "wofz_real_916",
    "wofz_real_asym",
    "hjert",
    "dawsn",
    "hjert_harris",
    "hjert_wing",
    "hjert_harris_win",
    "HARRIS_A_MAX",
    "HJERT_WIN_TMIN",
]

# Chebyshev coefficients for (1 + 2a) * erfcx(a) in the transformed variable
# q = (a - 2) / (a + 2), from Shepherd & Laframboise (1981), highest order
# first (jnp.polyval convention).
_ERFCX_COEF = np.array(
    [
        5.92470169e-5,
        1.61224554e-4,
        -3.46481771e-4,
        -1.39681227e-3,
        1.20588380e-3,
        8.69014394e-3,
        -8.01387429e-3,
        -5.42122945e-2,
        1.64048523e-1,
        -1.66031078e-1,
        -9.27637145e-2,
        2.76978403e-1,
    ],
    dtype=np.float32,
)

# Algorithm 916 series grid: a_n = n * h with h = 1/2.  Generated, not typed.
_N_TERMS = 27
_AN = (0.5 * np.arange(1, _N_TERMS + 1)).astype(np.float32)          # n/2
_AN2 = (_AN * _AN).astype(np.float32)                                # (n/2)^2
_EXP_AN2 = np.exp(-_AN2.astype(np.float64)).astype(np.float32)       # e^{-a_n^2}


def erfcx(x):
    """Scaled complementary error function ``exp(x^2) erfc(x)``.

    Rational Chebyshev approximation (Shepherd & Laframboise 1981), accurate
    to ~float32 precision for x > -9.3.  Elementwise on arrays.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    a = jnp.abs(x)
    # Transformed variable in [-1, 1); the two-step form reduces rounding.
    b = (a - 2.0) / (a + 2.0)
    q = (-a * b - 2.0 * (b + 1.0) + a) / (a + 2.0) + b
    # Statically unrolled Horner (jnp.polyval scans; unrolling keeps it fusible).
    p = jnp.full_like(q, float(_ERFCX_COEF[0]))
    for coef in np.asarray(_ERFCX_COEF[1:]):
        p = p * q + float(coef)
    # Undo the (1 + 2a) scaling with a compensated division.
    quot = (p + 1.0) / (1.0 + 2.0 * a)
    resid = (p + 1.0) - quot * (1.0 + 2.0 * a)
    f = 0.5 * resid / (a + 0.5) + quot
    # Reflection for negative arguments: erfcx(-x) = 2 exp(x^2) - erfcx(x).
    return jnp.where(x >= 0.0, f, 2.0 * jnp.exp(x * x) - f).astype(jnp.float32)


def wofz_real_916(x, y):
    """Re[w(x + iy)] by Algorithm 916 (Zaghloul & Ali 2011), h = 1/2.

    Valid (float32-accurate) for x^2 + y^2 < ~111 with 27 series terms.
    Broadcast-aware: ``y`` may have a smaller shape than ``x`` (e.g. a
    per-(sample, transition) scalar column against a pixel axis), in which
    case every y-only quantity -- erfcx(y), the 27 series denominators
    1/(a_n^2+y^2), sigma1 -- is computed at y's shape and broadcast late.
    Elementwise, statically unrolled, and *transcendental-minimal*: the naive
    series needs 2 exps per term (54 per element).  Here the Gaussian terms
    are generated by a multiplicative recurrence instead -- with a_n = n/2,

        exp(-(a_{n+1} -+ x)^2) = exp(-(a_n -+ x)^2) * exp(+-x) * C_n,
        C_n = exp(-(2n+1)/4)   (compile-time constant),

    so the whole double series costs TWO exponentials (exp(-x^2), exp(x))
    plus fused multiply-adds, so the fused Voigt pipeline is bound by
    arithmetic rather than by transcendentals.  |x| <= sqrt(111)
    keeps exp(x) and the recurrence in float32 range; accuracy vs scipy is
    preserved to ~3e-6 (tests/test_faddeeva.py).
    """
    xs = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    x = jnp.abs(xs)  # the function is even in x; recurrence assumes x >= 0
    xy = x * y
    exx = jnp.exp(-x * x)
    ex = jnp.exp(x)
    iex = 1.0 / ex
    y2 = y * y

    # Leading term: exp(-x^2) [erfcx(y) cos(2xy) + sin^2(xy)/(pi x y^2) ...]
    # written with sinc to stay finite at xy -> 0.
    lead = exx * (
        erfcx(y) * jnp.cos(2.0 * xy)
        + x * jnp.sin(xy) / jnp.pi * jnp.sinc(xy / jnp.pi)
    )

    # First terms: exp(-(1/2 -+ x)^2) = exp(-1/4) exp(-x^2) exp(+-x).
    e_quarter = float(np.exp(-0.25))
    tp = e_quarter * exx * iex   # exp(-(a_1 + x)^2): monotone decreasing in n,
    # underflows only where the true value underflows -- single recurrence OK.

    # Minus terms exp(-(a_n - x)^2) peak at a_n ~ x: a single upward
    # recurrence underflows to zero before the peak when x is large, and a
    # long recurrence accumulates rounding.  Use THREE anchors (n = 1, mid,
    # 27) with outward recurrences, and select per element by nearest anchor,
    # bounding both underflow (the nearest anchor's argument is <= ~11, far
    # from the f32 floor) and rounding (<= ~N_TERMS/4 recurrence steps).
    n_mid = _N_TERMS // 2  # 0-based anchor index
    up_ratio = [float(np.exp(-(2 * n + 3) / 4.0)) for n in range(_N_TERMS)]

    def seq_from(anchor_idx, anchor_val):
        seq = [None] * _N_TERMS
        seq[anchor_idx] = anchor_val
        t = anchor_val
        for n in range(anchor_idx + 1, _N_TERMS):
            t = t * (up_ratio[n - 1] * ex)
            seq[n] = t
        t = anchor_val
        for n in range(anchor_idx - 1, -1, -1):
            t = t * ((1.0 / up_ratio[n]) * iex)
            seq[n] = t
        return seq

    seq_lo = seq_from(0, e_quarter * exx * ex)
    seq_mi = seq_from(n_mid, jnp.exp(-((float(_AN[n_mid]) - x) ** 2)))
    seq_hi = seq_from(
        _N_TERMS - 1, jnp.exp(-((float(_AN[_N_TERMS - 1]) - x) ** 2))
    )
    # Nearest-anchor regions (anchor positions a = 0.5, a_mid, 13.5).
    lo_cut = 0.5 * (float(_AN[0]) + float(_AN[n_mid]))
    hi_cut = 0.5 * (float(_AN[n_mid]) + float(_AN[_N_TERMS - 1]))
    use_lo = x < lo_cut
    use_hi = x > hi_cut

    # sigma1 and the denominators depend only on y: accumulate them at y's
    # (possibly scalar-column) shape and broadcast against x only at the end.
    sigma1 = jnp.zeros_like(y2)
    sigma23 = jnp.zeros_like(x)
    for n in range(_N_TERMS):
        denom = 1.0 / (float(_AN2[n]) + y2)
        sigma1 = sigma1 + float(_EXP_AN2[n]) * denom
        tm = jnp.where(use_lo, seq_lo[n], jnp.where(use_hi, seq_hi[n], seq_mi[n]))
        sigma23 = sigma23 + (tp + tm) * denom
        if n + 1 < _N_TERMS:
            tp = tp * (up_ratio[n] * iex)

    return lead + y / jnp.pi * (-jnp.cos(2.0 * xy) * (exx * sigma1) + 0.5 * sigma23)


def wofz_real_asym(x, y):
    """Asymptotic expansion of Re[w(x + iy)] for large |x + iy|.

    w(z) ~ (i / (z sqrt(pi))) * (1 + 1/(2z^2) (1 + 3/(2z^2) (1 + ...))).
    Written in real arithmetic (no complex dtype), which fuses elementwise.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    y = jnp.asarray(y, dtype=jnp.float32)
    # 1 / (2 z^2) = (r - i s) with z = x + iy:
    r2 = x * x + y * y
    inv = 1.0 / (2.0 * r2 * r2)
    ar = (x * x - y * y) * inv
    ai = -2.0 * x * y * inv
    # poly = 1 + a (1 + a (3 + 15 a)), complex, by real parts:
    pr, pi_ = 3.0 + 15.0 * ar, 15.0 * ai
    pr, pi_ = 1.0 + (ar * pr - ai * pi_), (ar * pi_ + ai * pr)
    pr, pi_ = 1.0 + (ar * pr - ai * pi_), (ar * pi_ + ai * pr)
    # i / (z sqrt(pi)) = (y + i x) / (sqrt(pi) r2)
    scale = 1.0 / (jnp.sqrt(jnp.pi) * r2)
    # Re[(y + ix)(pr + i pi)] * scale
    return (y * pr - x * pi_) * scale


# ---------------------------------------------------------------------------
# Dawson function + Harris expansion: the fast path for small damping.
# ---------------------------------------------------------------------------

# Piecewise-polynomial f32 Dawson integral F(x) = e^{-x^2} int_0^x e^{t^2} dt.
# Minimax-grade Chebyshev fits (converted to centered monomial Horner form so
# f32 intermediates stay O(1) -- a single [0, 6.25] polynomial loses 3 digits
# to cancellation), generated by tools/fit_dawson.py against scipy.special
# .dawsn; every region validated <= 5.3e-7 max relative error when evaluated
# in float32.
#   R1: t = x^2 in [0, 2.25]      F = x * P1(t)
#   R2: t in (2.25, 6.25]         F = x * P2(t - 4.25)
#   R3: v = 1/t in [1/16, 0.16]   F = x*v/2 * (1 + v * P3(v - 0.111))
#   R4: v in (0, 1/16]            F = x*v/2 * (1 + v * P4(v))
_DAWSN_P1 = [1.0, -0.6666666865348816, 0.2666666507720947, -0.07619033753871918,
             0.016930753365159035, -0.003077461151406169, 0.00047237955732271075,
             -6.21086364844814e-05, 6.846393716841703e-06, -5.695005711459089e-07,
             2.609287363952717e-08]
_DAWSN_P2 = [0.1402396857738495, -0.03909141942858696, 0.009945407509803772,
             -0.0021992167457938194, 0.00041756173595786095, -6.845255120424554e-05,
             9.795944606594276e-06, -1.233995476468408e-06, 1.3953918198694737e-07,
             -1.5512020112851133e-08, 1.4320578056725708e-09]
_DAWSN_P3 = [0.6264359951019287, 1.7964502573013306, 6.447943687438965,
             -53.4018440246582, -640.7386474609375, 4220.55224609375,
             32805.28515625, -363086.125, -33727.375]
_DAWSN_P4 = [0.5000000596046448, 0.7499195337295532, 1.8925540447235107,
             5.018493175506592, 94.2889404296875, -1155.8101806640625,
             12073.4189453125]

#: damping threshold below which the 3-term Harris expansion meets the
#: framework's accuracy bar (<= ~1e-6 relative vs scipy wofz; the truncation
#: error scales as a^3 near the core and a^2 in the wings -- measured in
#: tests/test_faddeeva.py).  CIV/HI workloads sit at a ~ 1e-4..6e-3.
HARRIS_A_MAX = 1e-3

_TWO_OVER_SQRTPI = float(2.0 / np.sqrt(np.pi))


def _horner(coeffs, x):
    p = jnp.full_like(x, float(coeffs[-1]))
    for c in coeffs[-2::-1]:
        p = p * x + float(c)
    return p


def _dawsn_h1core(x):
    """(F(x), 2 x F(x) - 1) with the second value computed cancellation-free.

    2xF - 1 -> 0 like 1/(2x^2) in the tail, so forming it as (2xF) - 1 in
    f32 loses ~eps/(2xF-1) relative accuracy (measured 8.6% at x ~ 500).  In
    the tail regions the fitted form gives it EXACTLY: 2xF - 1 = v * g(v)
    with v = 1/x^2."""
    x = jnp.asarray(x, jnp.float32)
    t = x * x
    p_head = jnp.where(
        t <= 2.25, _horner(_DAWSN_P1, t), _horner(_DAWSN_P2, t - 4.25)
    )
    v = 1.0 / jnp.maximum(t, 1.0)  # clamped: tail only selected for t > 6.25
    g = jnp.where(
        t <= 16.0, _horner(_DAWSN_P3, v - 0.111), _horner(_DAWSN_P4, v)
    )
    near = t <= 6.25
    F = jnp.where(near, x * p_head, 0.5 * x * v * (1.0 + v * g))
    h1core = jnp.where(near, 2.0 * t * p_head - 1.0, v * g)
    return F, h1core


def dawsn(x):
    """Dawson integral F(x), float32, elementwise and branchless.

    Piecewise polynomial (4 regions, selected with ``where``), <= 5.3e-7
    relative error vs scipy.special.dawsn everywhere.  Odd in x by
    construction (every region is x times an even-argument polynomial).
    """
    return _dawsn_h1core(x)[0]


def hjert_harris(x, a):
    """Voigt--Hjerting function by the 3-term Harris (1948) expansion:

        H(x, a) = H0 + a H1 + a^2 H2 + O(a^3),
        H0 = e^{-x^2},  H1 = (2/sqrt(pi)) (2 x F(x) - 1),
        H2 = (1 - 2 x^2) e^{-x^2},

    with F the Dawson integral.  Valid for small damping a (use when the
    static bound on a is < :data:`HARRIS_A_MAX`); exact in the far wings by
    construction (H1 -> 1/(sqrt(pi) x^2), the leading asymptotic term), so
    NO region switch is needed -- one formula for the whole pixel axis at
    ~1/6 the operation count of the 916 series.  ``a`` broadcasts (e.g. a
    per-(sample, transition) scalar column).  Cost: one exp + ~50 fma.
    """
    x = jnp.asarray(x, jnp.float32)
    a = jnp.asarray(a, jnp.float32)
    t = x * x
    E = jnp.exp(-t)
    _, h1core = _dawsn_h1core(x)
    return E * (1.0 + a * a * (1.0 - 2.0 * t)) + a * (_TWO_OVER_SQRTPI * h1core)


#: floor on the ``tmin`` window threshold of :func:`hjert_harris_win`: below
#: x^2 = 21 the dropped e^{-x^2} terms exceed ~7.6e-10 absolute, and the
#: wing polynomial region itself requires x^2 > 16.
HJERT_WIN_TMIN = 21.0


def hjert_wing(x, a):
    """Far-wing Voigt--Hjerting: :func:`hjert_harris` with its e^{-x^2}
    terms dropped.

    For x^2 >= 16 the Dawson core of ``hjert_harris`` evaluates its tail
    polynomial ``h1core = v * P4(v)`` with v = 1/x^2 -- this function IS
    that tail, so for x^2 >= tmin >= :data:`HJERT_WIN_TMIN` the difference
    from ``hjert_harris`` is exactly the dropped ``e^{-x^2} (1 + a^2 (1 -
    2 x^2))`` term: |hjert_harris - hjert_wing| <= e^{-tmin} * (1 + 2 a^2
    tmin) absolute.  At tmin = 21 that is < 1e-9 for any Harris-regime
    damping (a < :data:`HARRIS_A_MAX`).  Cost: one reciprocal + 7 fma --
    ~6x cheaper than the full Harris evaluation (no exp, no 4-region
    Dawson).  Absorption lines are narrow, so most pixels sit in this
    wing.
    """
    x = jnp.asarray(x, jnp.float32)
    a = jnp.asarray(a, jnp.float32)
    t = x * x
    v = 1.0 / jnp.maximum(t, 16.0)
    return a * ((_TWO_OVER_SQRTPI * v) * _horner(_DAWSN_P4, v))


def hjert_harris_win(x, a, tmin=HJERT_WIN_TMIN):
    """Windowed Harris Voigt--Hjerting: ``hjert_harris`` for x^2 < tmin,
    :func:`hjert_wing` outside.

    This is the piecewise function the likelihood evaluates when windowing
    is enabled (models/jax_model.StaticSpec.win_tmin).  ``jnp.where``
    evaluates both sides, so the selection changes values, not work.
    ``tmin`` is chosen per transition from the
    STATIC prior bound on the tau amplitude so the absolute optical-depth
    error of the dropped exponential, amp_max * e^{-tmin}, stays below
    1e-8 (models/jax_model.static_spec).
    """
    x = jnp.asarray(x, jnp.float32)
    return jnp.where(x * x < tmin, hjert_harris(x, a), hjert_wing(x, a))


def hjert(x, a):
    """Voigt--Hjerting function H(x, a) = Re[w(x + i a)], elementwise with
    broadcasting: ``a`` may have a smaller (broadcastable) shape than ``x``.

    Region switch at x^2 + a^2 = 111 between the Algorithm-916 series and the
    asymptotic expansion (same radius as the reference, voigt_jax.py:127).
    Both branches are evaluated and selected with ``where`` -- branchless, so
    XLA fuses it.

    Performance note: only ``x`` is clamped in the far region (exp(x) would
    overflow f32 there); ``a`` is passed through at ITS OWN shape, which is
    what makes the factored series fast -- in the fused tau synthesis ``a``
    is a per-(sample, transition) scalar column, so erfcx(a) and the 27
    series denominators 1/(a_n^2 + a^2) are computed per *scalar*, not per
    pixel (clamping ``a`` to x's shape forced ~27 divisions + erfcx per
    pixel; removing that measured ~2x on the fused likelihood).  All
    a-dependent terms are finite for any a >= 0, so no clamp is needed
    (physics guarantees a > 0).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    a = jnp.asarray(a, dtype=jnp.float32)
    r2 = x * x + a * a
    near = r2 < 111.0
    # Clamp x in the far region so exp(-(an±x)^2)/exp(x) cannot produce
    # inf/nan garbage that `where` would still compute.
    xs = jnp.where(near, x, 0.0)
    return jnp.where(near, wofz_real_916(xs, a), wofz_real_asym(x, a))
