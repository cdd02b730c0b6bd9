"""Fused, batched JAX forward model + likelihood (the device compute path).

Replaces the reference's ``get_jax_likelihood`` closure factory
(/root/reference/mcalf/routines/hires_fitter.py:521-695) with a batched
formulation that XLA compiles into a few fused kernels:

* tau synthesis is ONE broadcasted elementwise computation over a flattened
  (component x transition) table -- shape (..., T, P) -- instead of nested
  ``fori_loop``s over components and lines with a per-pixel ``vmap``
  (reference :628-661).  Arbitrary leading batch axes flow through, so the
  same function serves a single parameter vector, a live-point batch, or a
  sharded (sightline x model x live-point) block.
* the Gaussian LSF kernel is rebuilt per call from the (possibly sampled)
  ``specres`` against a static support (reference :666-674) and applied with
  the statically-unrolled convolution in :mod:`mcalf_tpu.ops.convolve`,
  which supports per-sample kernel widths.
* the likelihood constant term  sum(log(2 pi sigma^2))  is precomputed in
  float64 on the host, so only the chi^2 part is accumulated in float32 --
  strictly more accurate than the reference's all-f32 nansum (:689-692).
* the asymmetric-likelihood rejection (reference numpy-only, :296-302; the
  reference jax path silently ignores it -- SURVEY.md section 5.6) is
  implemented on-device here.
* optional Gaussian priors (reference's dead ``Gpriors`` path, :218-234) are
  applied on-device when configured.

The compute core is split into *static structure* (:class:`StaticSpec`,
hashable, part of the jit key) and a *data pytree* (:func:`build_consts`,
plain arrays).  Single-problem use closes over the data
(:func:`make_jax_forward`); multi-sightline use stacks the data with a
leading problem axis and shards it over the device mesh
(:mod:`mcalf_tpu.models.batched`, :mod:`mcalf_tpu.parallel`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

import jax
import jax.numpy as jnp
import numpy as np

from mcalf_tpu.models.forward import CCGS, TAU_CONST, AbsorptionModel
from mcalf_tpu.ops.convolve import FWHM_TO_SIGMA, gaussian_kernel, lsf_convolve
from mcalf_tpu.ops.faddeeva import (
    HARRIS_A_MAX,
    HJERT_WIN_TMIN,
    hjert,
    hjert_harris,
    hjert_harris_win,
)


@dataclass(frozen=True)
class StaticSpec:
    """Hashable static structure of a fit problem (shapes + flags).

    Two problems can be stacked/sharded together iff their StaticSpec is
    identical."""

    ndim: int
    npix: int
    ntrans: int
    startind: int
    freecont: bool
    freespecres: bool
    half: int
    conv_mode: str
    asymmlike: bool
    has_gpriors: bool
    #: per-transition flag: the prior bound on the damping parameter
    #: a = gamma/(4 pi dnu) is below ops.faddeeva.HARRIS_A_MAX, so the
    #: 3-term Harris expansion (one exp + Dawson polynomial, ~1/6 the cost
    #: of the 916 series) is accurate for every sample -- a TRACE-TIME
    #: branch, decided from the static prior bounds, never at runtime.
    harris: tuple = ()
    #: per-transition wing-window threshold on u^2 (0.0 = windowing off):
    #: for u^2 >= win_tmin[t] the Voigt-Hjerting value is taken from the
    #: ~6x-cheaper hjert_wing tail instead of the full Harris evaluation
    #: (ops.faddeeva.hjert_harris_win).  The threshold is derived from the
    #: STATIC prior bound on the tau amplitude so the absolute optical-
    #: depth error of the dropped e^{-u^2} stays < 1e-8 per transition.
    #: Set only for Harris-regime transitions.
    win_tmin: tuple = ()


def static_spec(
    model: AbsorptionModel,
    conv_mode: str = "same_edge",
    gpriors: bool = False,
) -> StaticSpec:
    tab = model.transition_table()
    # Worst-case damping per transition over the prior: a is maximal at the
    # LOWER b bound (a = gamma lambda0 / (4 pi b)).
    b_lo_kms = model.bounds_lo[tab["pidx"] + 2]
    dnu_min = b_lo_kms * 1e5 * (1e8 / tab["wrest"])
    a_max = tab["gamma"] / (4.0 * np.pi * dnu_min)
    harris = a_max < HARRIS_A_MAX
    # Wing-window threshold per transition (hjert_harris_win): require the
    # absolute tau error of the dropped exponential, amp_max * e^{-tmin},
    # below 1e-8, with amp_max the static prior bound on the tau amplitude
    # (N at its upper bound, dnu at its minimum).  Floor at HJERT_WIN_TMIN
    # (the wing polynomial's own validity).  Harris transitions only;
    # MCALF_TPU_WINDOW=0 disables (then every pixel takes the full Harris
    # evaluation).
    n_max = model.bounds_hi[tab["pidx"]]
    amp_max = TAU_CONST * 10.0 ** n_max * tab["f"] / dnu_min
    tmin = np.maximum(HJERT_WIN_TMIN, np.log(np.maximum(amp_max, 1e-30) * 1e8))
    window_on = os.environ.get("MCALF_TPU_WINDOW", "1") != "0"
    win_tmin = tuple(
        float(tm) if (window_on and h) else 0.0
        for tm, h in zip(tmin, harris)
    )
    return StaticSpec(
        ndim=model.ndim,
        npix=model.npix,
        ntrans=int(tab["pidx"].size),
        startind=model.startind,
        freecont=model.freecont,
        freespecres=model.freespecres,
        half=model.kernel_half_size(),
        conv_mode=conv_mode,
        asymmlike=bool(model.asymmlike),
        has_gpriors=bool(gpriors and model.gpriors is not None),
        harris=tuple(bool(v) for v in harris),
        win_tmin=win_tmin,
    )


def build_consts(model: AbsorptionModel, gpriors: bool = False) -> Dict[str, Any]:
    """Device-constant data pytree for one fit problem.  All host
    precomputation happens in float64, then casts to f32."""
    tab = model.transition_table()
    c: Dict[str, Any] = {}
    # c / lambda [Hz] precomputed on host: full precision in the static part.
    c["c_over_wave"] = (CCGS / (model.obj_wl / 1e8)).astype(np.float32)     # (P,)
    c["data"] = model.obj.astype(np.float32)                                # (P,)
    c["valid"] = model.valid                                                # (P,)
    c["ivar"] = np.where(
        model.valid, 1.0 / np.where(model.valid, model.obj_noise, 1.0) ** 2, 0.0
    ).astype(np.float32)
    c["noise"] = np.where(model.valid, model.obj_noise, np.inf).astype(np.float32)

    # Per-transition tables (layout indices are static, see StaticSpec).
    c["pidx"] = tab["pidx"]                                                 # (T,)
    c["comp_id"] = tab["comp_id"].astype(np.float32)
    c["is_fill"] = tab["is_fill"]
    c["nujk"] = (CCGS / (tab["wrest"] / 1e8)).astype(np.float32)
    c["inv_wrest_cm"] = (1e8 / tab["wrest"]).astype(np.float32)
    c["gamma"] = tab["gamma"].astype(np.float32)
    c["f"] = tab["f"].astype(np.float32)

    # High-precision redshift handling: a redshift stored in f32 quantizes
    # to ~2.4e-7 steps (~1e-5 posterior sigma_z / 40), turning the
    # likelihood into a STEP function of z whose plateaus/ties measurably
    # bias nested sampling (-1.65 +/- 0.10 nats on the 1-comp CIV fit vs a
    # quadrature truth anchor).  Instead the u-argument is assembled as
    #     u * dnu = D0 + dz * (c/lam),
    # with D0 = (1 + zmid) c/lam - nu0 precomputed per (transition, pixel)
    # in float64 on host (zmid = prior midpoint, static) and dz = z - zmid
    # carried at f32 resolution of the PRIOR WIDTH (eps * 0.02 ~ 2.4e-9 in
    # z) by deriving it directly from the unit cube (loglike_cube_core).
    # Residual u error ~ 1e-5 Doppler widths vs ~ 2e-3 for naive f32 z.
    wave_cm64 = np.asarray(model.obj_wl, np.float64) / 1e8
    cw64 = CCGS / wave_cm64                                                 # (P,)
    nu0 = CCGS / (np.asarray(tab["wrest"], np.float64) / 1e8)               # (T,)
    z_lo = np.asarray(model.bounds_lo, np.float64)[tab["pidx"] + 1]
    z_hi = np.asarray(model.bounds_hi, np.float64)[tab["pidx"] + 1]
    zmid = 0.5 * (z_lo + z_hi)
    c["d0"] = ((1.0 + zmid)[:, None] * cw64[None, :] - nu0[:, None]).astype(
        np.float32
    )                                                                       # (T, P)
    c["zmid"] = zmid.astype(np.float32)                                     # (T,)
    c["zspan"] = (z_hi - z_lo).astype(np.float32)                           # (T,)
    c["u_zidx"] = (tab["pidx"] + 1).astype(np.int32)                        # (T,)

    c["contval"] = np.float32(model.contval[0])
    # Reference JAX path uses specres[0] when fixed (:572); the numpy path
    # uses max(specres).  Identical for the 1-element case; the JAX path is
    # the fit parity target.
    c["fixed_specres"] = np.float32(
        model.specres[0] if not model.freespecres else 0.0
    )
    c["velstep"] = np.float32(model.velstep)
    c["const_term"] = np.float32(
        np.sum(
            -np.log(1.0 / model.obj_noise[model.valid] ** 2) + np.log(2.0 * np.pi)
        )
    )
    c["cdf4"] = np.float32(model.gauss_cdf[1])
    c["cdf5"] = np.float32(model.gauss_cdf[2])
    c["grace"] = np.float32(model.gracenum)

    c["lo"] = model.bounds_lo.astype(np.float32)
    c["hi"] = model.bounds_hi.astype(np.float32)

    if gpriors and model.gpriors is not None:
        mu, sig = _parse_gpriors(model.gpriors, model.ndim)
        use = np.isfinite(sig)
        c["gp_mu"] = np.where(use, mu, 0.0).astype(np.float32)
        c["gp_isig2"] = np.where(use, 1.0 / sig**2, 0.0).astype(np.float32)
        c["gp_norm"] = np.float32(
            np.sum(np.where(use, np.log(2.0 * np.pi * sig**2), 0.0))
        )

    return c


# ---------------------------------------------------------------------------
# Pure compute cores: (params, consts, static) -> arrays.
# ---------------------------------------------------------------------------

def _head(p, c, s: StaticSpec):
    specres = p[..., 0] if s.freespecres else c["fixed_specres"]
    if s.freecont:
        cont = p[..., 1] if s.freespecres else p[..., 0]
    else:
        cont = c["contval"]
    return specres, cont


def synth_tau(dz, gain, avoigt, dnu, c, s: StaticSpec):
    """Optical depth tau (..., P) = sum_t gain_t H(u_t, a_t) over the
    transition table, from per-(sample, transition) tables of shape
    (..., T): redshift offsets ``dz`` = z - zmid, amplitudes ``gain`` (zero
    for inactive components), damping ``avoigt`` and Doppler widths
    ``dnu``.

    The sum is a statically unrolled loop: each step is elementwise on a
    (..., P) block, so XLA fuses the whole sum into one kernel instead of
    materializing a (..., T, P) intermediate."""
    T = int(c["pidx"].shape[0])
    tau = jnp.zeros(dz.shape[:-1] + (s.npix,), jnp.float32)
    # Per-(sample, transition) scalars hoisted out of the pixel axis --
    # in particular the reciprocal of dnu, so the per-pixel u costs one
    # fma + one mul instead of a division.
    idnu = 1.0 / dnu
    for t in range(T):
        # u(wave) = (D0 + dz c/wave) * (1/dnu) on a (..., P) block
        u = (
            c["d0"][t] + dz[..., t : t + 1] * c["c_over_wave"]
        ) * idnu[..., t : t + 1]
        # Trace-time choice per transition: windowed Harris (wing tail
        # beyond the static u^2 threshold, see StaticSpec.win_tmin) /
        # plain Harris when the prior bound guarantees small damping
        # (s.harris) / the full 916/asymptotic evaluation otherwise.
        a_t = avoigt[..., t : t + 1]
        if s.win_tmin and s.win_tmin[t] > 0.0:
            H = hjert_harris_win(u, a_t, s.win_tmin[t])
        elif s.harris[t]:
            H = hjert_harris(u, a_t)
        else:
            H = hjert(u, a_t)
        tau = tau + gain[..., t : t + 1] * H
    return tau


def reconstruct_core(p, c, s: StaticSpec, dz=None):
    """Model flux for physical parameters p of shape (..., ndim).

    ``dz``: optional (..., T) high-precision redshift offsets z - zmid (see
    build_consts); when None they are recovered from ``p`` in f32 (adequate
    for plotting / chi2-at-medians; the sampler path supplies cube-derived
    offsets through :func:`loglike_cube_core`)."""
    p = jnp.asarray(p, jnp.float32)
    specres, cont = _head(p, c, s)
    nact = jnp.floor(p[..., s.startind])                   # (...,)

    pidx = c["pidx"]
    N = p[..., pidx]                                       # (..., T)
    b = p[..., pidx + 2]
    if dz is None:
        dz = p[..., pidx + 1] - c["zmid"]                  # (..., T)

    dnu = b * 1e5 * c["inv_wrest_cm"]                      # (..., T)
    avoigt = c["gamma"] / (4.0 * jnp.pi * dnu)
    amp = TAU_CONST * jnp.power(10.0, N) * c["f"] / dnu    # (..., T)
    active = ((c["comp_id"] < nact[..., None]) | c["is_fill"]).astype(jnp.float32)

    tau = synth_tau(dz, active * amp, avoigt, dnu, c, s)   # (..., P)
    flux_model = jnp.exp(-tau)                             # (..., P)

    if s.half > 0:
        sigma_pix = (specres / FWHM_TO_SIGMA) / c["velstep"]
        kernel = gaussian_kernel(jnp.asarray(sigma_pix, jnp.float32), s.half)
        flux_model = lsf_convolve(flux_model, kernel, mode=s.conv_mode)
    return flux_model * jnp.asarray(cont)[..., None]


def chi2_core(p, c, s: StaticSpec):
    m = reconstruct_core(p, c, s)
    r = c["data"] - m
    return jnp.sum(c["ivar"] * r * r, axis=-1)


def loglike_core(p, c, s: StaticSpec, dz=None):
    p = jnp.asarray(p, jnp.float32)
    m = reconstruct_core(p, c, s, dz=dz)
    r = c["data"] - m
    c2 = jnp.sum(c["ivar"] * r * r, axis=-1)
    ll = -0.5 * (c2 + c["const_term"])
    if s.asymmlike:
        resid = r / c["noise"]
        n5 = jnp.sum((resid > 5.0) & c["valid"], axis=-1)
        n4 = jnp.sum((resid > 4.0) & c["valid"], axis=-1)
        bad = (n5 > c["cdf5"] + c["grace"]) | (n4 > c["cdf4"] + c["grace"])
        ll = jnp.where(bad, -jnp.inf, ll)
    if s.has_gpriors:
        d = p - c["gp_mu"]
        ll = ll - 0.5 * (jnp.sum(d * d * c["gp_isig2"], axis=-1) + c["gp_norm"])
    return ll


def cube_to_params_core(u, c):
    lo, hi = c["lo"], c["hi"]
    return lo + jnp.asarray(u, jnp.float32) * (hi - lo)


def loglike_cube_core(u, c, s: StaticSpec):
    # dz derived straight from the unit cube: resolution eps * zspan
    # (~2.4e-9 in z) instead of the f32 redshift's eps * (1+z) ~ 2.4e-7 --
    # see the d0/zmid note in build_consts.
    u = jnp.asarray(u, jnp.float32)
    dz = (u[..., c["u_zidx"]] - 0.5) * c["zspan"]
    return loglike_core(cube_to_params_core(u, c), c, s, dz=dz)


#: Largest flux error of the float32 device forward model against the
#: float64 host model (AbsorptionModel.reconstruct_spec): the quantisation
#: of the forward model's float32 parameters, measured at the line cores
#: (tests/test_forward.py: 2.64e-4).
F32_FLUX_EPS = 3e-4
#: float32 rounding of the chi^2 sum and of the constant term, relative
F32_SUM_RTOL = 1e-6


def lnl_tolerance(resid, ivar, lnl):
    """Largest |lnL_device - lnL_host| the float32 forward model allows.

    A flux error |dm| <= F32_FLUX_EPS moves chi^2 = sum ivar r^2 by at most
    2 eps sum ivar |r| + eps^2 sum ivar, so lnL = -(chi^2 + const)/2 moves
    by at most eps sum ivar |r| + eps^2 sum ivar / 2, with r the float64
    residual; F32_SUM_RTOL adds the float32 rounding of the sum and of
    the constant.  ``resid``: (n, P) float64 residuals at the valid
    pixels, ``ivar``: (P,), ``lnl``: (n,) host log-likelihoods.  Returns
    (n,)."""
    resid = np.atleast_2d(resid)
    const = float(np.sum(np.log(2.0 * np.pi / ivar)))
    return (
        F32_FLUX_EPS * np.sum(ivar * np.abs(resid), axis=-1)
        + 0.5 * F32_FLUX_EPS**2 * float(np.sum(ivar))
        + F32_SUM_RTOL * (np.abs(np.asarray(lnl)) + abs(const))
    )


# ---------------------------------------------------------------------------
# Single-problem convenience bundle.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JaxForward:
    """Bundle of jitted device functions for one fit problem.

    All functions accept arbitrary leading batch axes on ``p`` (physical
    parameters, shape (..., ndim)) or ``u`` (unit-cube coordinates).
    """

    ndim: int
    npix: int
    static: StaticSpec
    reconstruct: Callable[[Any], Any]      # p (..., ndim) -> flux (..., P)
    loglike: Callable[[Any], Any]          # p (..., ndim) -> (...)
    cube_to_params: Callable[[Any], Any]   # u (..., ndim) -> p (..., ndim)
    loglike_cube: Callable[[Any], Any]     # u (..., ndim) -> (...)
    chi2: Callable[[Any], Any]             # p (..., ndim) -> (...)
    bounds_lo: Any
    bounds_hi: Any


def make_jax_forward(
    model: AbsorptionModel,
    conv_mode: str = "same_edge",
    gpriors: bool = False,
) -> JaxForward:
    """Build the device forward model for an :class:`AbsorptionModel`.

    ``conv_mode='same_edge'`` reproduces the reference JAX-likelihood
    convolution semantics (parity target for fits); ``'wrap'`` reproduces the
    numpy/plot/mock path on device.
    """
    s = static_spec(model, conv_mode=conv_mode, gpriors=gpriors)
    c = {
        k: jnp.asarray(v)
        for k, v in build_consts(model, gpriors=gpriors).items()
    }

    return JaxForward(
        ndim=model.ndim,
        npix=model.npix,
        static=s,
        reconstruct=jax.jit(lambda p: reconstruct_core(p, c, s)),
        loglike=jax.jit(lambda p: loglike_core(p, c, s)),
        cube_to_params=jax.jit(lambda u: cube_to_params_core(u, c)),
        loglike_cube=jax.jit(lambda u: loglike_cube_core(u, c, s)),
        chi2=jax.jit(lambda p: chi2_core(p, c, s)),
        bounds_lo=c["lo"],
        bounds_hi=c["hi"],
    )


def _parse_gpriors(gpriors, ndim: int):
    """Parse the reference's Gpriors format: a flat sequence of 2*ndim
    entries alternating (value, sigma), with 'none' marking unconstrained
    dimensions (hires_fitter.py:225-230)."""
    mu = np.zeros(ndim)
    sig = np.full(ndim, np.inf)
    g = list(gpriors)
    if len(g) != 2 * ndim:
        raise ValueError(f"Gpriors must have 2*ndim={2*ndim} entries, got {len(g)}")
    for i in range(ndim):
        v, srr = g[2 * i], g[2 * i + 1]
        if str(v).lower() != "none" and str(srr).lower() != "none":
            mu[i] = float(v)
            sig[i] = float(srr)
    return mu, sig
