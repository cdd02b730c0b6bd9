"""Reference-style likelihood formulation, FOR BENCHMARKING ONLY.

This re-expresses the *computational pattern* of the reference's JAX
likelihood (/root/reference/mcalf/routines/hires_fitter.py:575-695) so
``bench.py`` can measure, on identical hardware, what the batched
redesign buys relative to a faithful translation:

* per-pixel scalar ``vmap`` of the Voigt function (reference :595),
* ``fori_loop`` over components, inner ``fori_loop`` over transitions
  (reference :628-661),
* outer ``vmap`` over the live-point batch (what jaxns does to vectorize a
  single-point likelihood).

It reuses our (equivalent) special functions and produces the same numbers;
only the *structure* differs.  Do not use this in production paths.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from mcalf_tpu.models.forward import CCGS, TAU_CONST, AbsorptionModel
from mcalf_tpu.ops.convolve import FWHM_TO_SIGMA
from mcalf_tpu.ops.faddeeva import erfcx, wofz_real_asym

__all__ = ["make_reference_style_loglike"]


def _hjert_naive(x, a):
    """Voigt-Hjerting with the reference's *series structure*: Algorithm 916
    evaluated with two direct exponentials per term (54 exps/element,
    voigt_jax.py:90-111) plus the same asymptotic switch -- i.e. without the
    recurrence optimization our production kernel uses.  Benchmark-only."""
    an = 0.5 * np.arange(1, 28)
    r2 = x * x + a * a
    sel = r2 < 111.0
    xs = jnp.where(sel, x, 0.0)
    ys = jnp.where(sel, a, 1.0)
    xy = xs * ys
    exx = jnp.exp(-xs * xs)
    y2 = ys * ys
    f = exx * (
        erfcx(ys) * jnp.cos(2.0 * xy)
        + xs * jnp.sin(xy) / jnp.pi * jnp.sinc(xy / jnp.pi)
    )
    s1 = jnp.zeros_like(x)
    s23 = jnp.zeros_like(x)
    for n in range(27):
        denom = 1.0 / (float(an[n] ** 2) + y2)
        s1 = s1 + float(np.exp(-(an[n] ** 2))) * denom
        s23 = s23 + (
            jnp.exp(-((float(an[n]) + xs) ** 2))
            + jnp.exp(-((float(an[n]) - xs) ** 2))
        ) * denom
    near = f + ys / jnp.pi * (-jnp.cos(2.0 * xy) * (exx * s1) + 0.5 * s23)
    return jnp.where(sel, near, wofz_real_asym(x, a))


def make_reference_style_loglike(model: AbsorptionModel):
    """Return a jitted (B, ndim) -> (B,) likelihood built the reference's way
    (loops + scalar vmap), for apples-to-apples throughput comparison."""
    import numpy as np

    wave = jnp.asarray(model.obj_wl, jnp.float32)
    data = jnp.asarray(model.obj, jnp.float32)
    noise = jnp.asarray(model.obj_noise, jnp.float32)
    tab = model.transition_table()
    nl = model.numlines
    line_wrest = jnp.asarray(tab["wrest"][:nl], jnp.float32)
    line_f = jnp.asarray(tab["f"][:nl], jnp.float32)
    line_gamma = jnp.asarray(tab["gamma"][:nl], jnp.float32)
    fill_wrest = jnp.float32(model.linefill.wrest)
    fill_f = jnp.float32(model.linefill.f)
    fill_gamma = jnp.float32(model.linefill.gamma)

    startind, endind = model.startind, model.endind
    ncompmax, nfill = model.ncompmax, model.nfill
    freespecres, freecont = model.freespecres, model.freecont
    contval = float(model.contval[0])
    fixed_specres = float(model.specres[0]) if not freespecres else 0.0
    velstep = float(model.velstep)
    half = model.kernel_half_size()
    kernel_x = jnp.arange(-half, half + 1, dtype=jnp.float32)

    def voigt_tau(N, z, b, wrest, f, gamma):
        cold = 10.0**N
        w_cm = wave / 1e8
        wrest_cm = wrest / 1e8
        nujk = CCGS / wrest_cm
        dnu = (b * 1e5) / wrest_cm
        avoigt = gamma / (4 * jnp.pi * dnu)
        uvoigt = ((CCGS / (w_cm / (z + 1.0))) - nujk) / dnu
        # Scalar hjert vmapped over the pixel axis (the reference pattern),
        # with the reference's direct-exponential series.
        v = jax.vmap(_hjert_naive, (0, None))(uvoigt, avoigt)
        return TAU_CONST * cold * f * v / dnu

    def reconstruct(p):
        specres = p[0] if freespecres else fixed_specres
        if freecont:
            cont = p[1] if freespecres else p[0]
        else:
            cont = contval
        thisncomp = jnp.floor(p[startind]).astype(jnp.int32)

        def comp_body(i, tau):
            idx = 1 + 3 * i + startind

            def line_body(j, t):
                return (
                    t + voigt_tau(p[idx], p[idx + 1], p[idx + 2],
                                  line_wrest[j], line_f[j], line_gamma[j])
                ).astype(jnp.float32)

            ctau = jax.lax.fori_loop(0, nl, line_body, jnp.zeros_like(wave))
            return tau + jnp.where(i < thisncomp, ctau, 0.0)

        tau = jax.lax.fori_loop(0, ncompmax, comp_body, jnp.zeros_like(wave))

        def fill_body(i, t):
            idx = 3 * i + endind
            return (
                t + voigt_tau(p[idx], p[idx + 1], p[idx + 2],
                              fill_wrest, fill_f, fill_gamma)
            ).astype(jnp.float32)

        tau = jax.lax.fori_loop(0, nfill, fill_body, tau)
        spec = jnp.exp(-tau)

        sigma = (specres / FWHM_TO_SIGMA) / velstep
        kern = jnp.exp(-(kernel_x**2) / (2 * sigma**2))
        kern = kern / jnp.sum(kern)
        conv = jnp.convolve(spec, kern, mode="same")
        idx = jnp.arange(spec.shape[0])
        edge = (idx < half) | (idx >= spec.shape[0] - half)
        conv = jnp.where(edge, spec, conv)
        return conv * cont

    def loglike_one(p):
        m = reconstruct(p)
        ispec2 = 1.0 / noise**2
        chi2 = ispec2 * (data - m) ** 2
        return -0.5 * jnp.nansum(chi2 - jnp.log(ispec2) + jnp.log(2.0 * jnp.pi))

    return jax.jit(jax.vmap(loglike_one))
