"""Absorption-line forward model: parameter layout, priors, and spectra.

This is the heart of the framework, replacing the reference's ``als_fitter``
class (/root/reference/mcalf/routines/hires_fitter.py:30-700) with a
design built for batched device execution:

* :class:`AbsorptionModel` holds the *static* problem definition -- data
  arrays, line list, prior bounds, and the parameter-vector layout -- plus a
  float64 numpy forward model used for plotting and mock generation (exact
  parity with the reference numpy path, including circular 'wrap' LSF
  convolution, hires_fitter.py:409-464).

* :func:`make_jax_forward` builds the fused, *batched* JAX forward model +
  likelihood.  Unlike the reference JAX path (which vmaps a scalar Voigt over
  pixels and fori-loops over components and lines,
  hires_fitter.py:628-661), the whole tau synthesis here is one broadcasted
  elementwise computation over a flattened (component x transition) table of
  shape (..., T, P): no loops, no dynamic control flow, arbitrary leading
  batch axes (live points, sightlines, models).  XLA fuses it into a few
  elementwise kernels.

Parameter-vector layout (identical to the reference, SURVEY.md section 3.4 /
hires_fitter.py:168-200)::

    [specres?] [cont?] [ncomp] [N,z,b] * ncompmax  [N,z,b] * nfill

``ncomp`` is sampled continuously and floored inside the likelihood
(trans-dimensional product-space construction, hires_fitter.py:616,647);
inactive components still occupy dimensions and are integrated over their
priors, so the evidence automatically penalizes extra components.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.special as _sps

from mcalf_tpu.atomic import LineData, get_lines
from mcalf_tpu.io.spectra import load_spectrum
from mcalf_tpu.ops.convolve import (
    FWHM_TO_SIGMA,
    SUPPORT_SIGMAS,
    gaussian_kernel,
    kernel_half_size,
    lsf_convolve,
)
from mcalf_tpu.utils.stats import sigma_clipped_stats

# Physical constants (cgs), as in the reference (hires_fitter.py:65-66,364).
CLIGHT_KMS = 2.9979245e5
CCGS = 2.9979245e10
TAU_CONST = 0.014971475  # sqrt(pi) e^2 / (m_e c), cgs

#: Filler nuisance lines clone the first target line with wrest := 250 A
#: (hires_fitter.py:120-121; the in-code comment says 1000 A, code wins).
FILLER_WREST = 250.0


def _as_pair(x) -> Tuple[float, float]:
    arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
    if arr.size == 1:
        return (float(arr[0]), float(arr[0]))
    return (float(arr[0]), float(arr[1]))


@dataclass
class AbsorptionModel:
    """Static fit definition + float64 numpy forward model.

    Use :meth:`from_file` for the reference's file-driven construction
    (specfile + wavefit masking, hires_fitter.py:69-87).
    """

    wave: np.ndarray
    flux: np.ndarray
    noise: np.ndarray
    lines: List[LineData]
    ncomp: Tuple[int, int] = (1, 1)
    nfill: int = 0
    specres: Sequence[float] = (7.0,)
    contval: Sequence[float] = (1.0,)
    Nrange: Sequence[float] = (11.5, 16.0)
    brange: Sequence[float] = (1.0, 30.0)
    zrange: Optional[Sequence[float]] = None
    Nrangefill: Sequence[float] = (11.5, 16.0)
    brangefill: Sequence[float] = (1.0, 30.0)
    wrangefill: Optional[Sequence[float]] = None
    fitrange: Optional[Sequence[Tuple[float, float]]] = None
    asymmlike: bool = False
    gpriors: Optional[Sequence] = None
    debug: bool = False

    # Derived (filled in __post_init__)
    velstep: float = field(init=False, default=0.0)
    bounds: List[Tuple[float, float]] = field(init=False, default_factory=list)
    ndim: int = field(init=False, default=0)
    startind: int = field(init=False, default=0)
    endind: int = field(init=False, default=0)

    # ------------------------------------------------------------------
    @classmethod
    def from_file(
        cls,
        specfile: str,
        fitrange: Sequence[Tuple[float, float]],
        fitlines: Sequence[str],
        ncomp: Sequence[int],
        nfill: int = 0,
        specres: Sequence[float] = (7.0,),
        contval: Sequence[float] = (1.0,),
        Nrange: Sequence[float] = (11.5, 16.0),
        brange: Sequence[float] = (1.0, 30.0),
        zrange: Optional[Sequence[float]] = None,
        Nrangefill: Sequence[float] = (11.5, 16.0),
        brangefill: Sequence[float] = (1.0, 30.0),
        wrangefill: Optional[Sequence[float]] = None,
        coldef: Sequence[str] = ("Wave", "Flux", "Err"),
        Gpriors=None,
        Asymmlike: bool = False,
        debug: bool = False,
    ) -> "AbsorptionModel":
        """Construct from an ASCII spectrum file -- reference ``als_fitter``
        constructor semantics (hires_fitter.py:32-200)."""
        wave, flux, noise = load_spectrum(specfile, coldef)
        return cls(
            wave=wave,
            flux=flux,
            noise=noise,
            lines=get_lines(fitlines),
            ncomp=(int(ncomp[0]), int(ncomp[1])),
            nfill=int(nfill),
            specres=specres,
            contval=contval,
            Nrange=Nrange,
            brange=brange,
            zrange=zrange,
            Nrangefill=Nrangefill,
            brangefill=brangefill,
            wrangefill=wrangefill,
            fitrange=fitrange,
            asymmlike=Asymmlike,
            gpriors=Gpriors,
            debug=debug,
        )

    # ------------------------------------------------------------------
    def __post_init__(self):
        self.specres = np.atleast_1d(np.asarray(self.specres, dtype=np.float64))
        self.contval = np.atleast_1d(np.asarray(self.contval, dtype=np.float64))
        self.freecont = len(self.contval) > 1
        self.freespecres = len(self.specres) > 1
        self.ncompmin = int(self.ncomp[0])
        self.ncompmax = int(self.ncomp[1])
        self.nfill = int(self.nfill)
        self.numlines = len(self.lines)

        wave = np.asarray(self.wave, dtype=np.float64)
        flux = np.asarray(self.flux, dtype=np.float64)
        noise = np.asarray(self.noise, dtype=np.float64)
        if self.fitrange is not None:
            ok = np.zeros(wave.shape, dtype=bool)
            for lo, hi in self.fitrange:
                if not hi > lo:
                    raise ValueError(
                        f"wavefit range ({lo}, {hi}) is empty or reversed "
                        "(ranges are min,max pairs)"
                    )
                ok |= (wave > lo) & (wave < hi)
            if ok.sum() < 2:
                raise ValueError(
                    f"wavefit ranges {list(self.fitrange)} select "
                    f"{int(ok.sum())} pixels of the spectrum (it covers "
                    f"{wave.min():.1f}-{wave.max():.1f} A); nothing to fit"
                )
            wave, flux, noise = wave[ok], flux[ok], noise[ok]
            self.numfitranges = len(self.fitrange)
        else:
            self.fitrange = [(float(wave.min()), float(wave.max()))]
            self.numfitranges = 1
        self.obj_wl, self.obj, self.obj_noise = wave, flux, noise
        self.npix = wave.size

        # Velocity step: sigma-clipped median of per-pixel km/s
        # (hires_fitter.py:84-87).
        velsteps = (wave[1:] - wave[:-1]) / wave[1:] * CLIGHT_KMS
        _, med, _ = sigma_clipped_stats(velsteps)
        self.velstep = float(med)

        # Filler line: clone of the first target line at FILLER_WREST.
        self.linefill = self.lines[0].replace(
            name=self.lines[0].name + " (filler)", wrest=FILLER_WREST
        )

        # --- Prior bounds / parameter layout (hires_fitter.py:123-200) ---
        self.z_lims: List[Tuple[float, float]] = []
        zr = None if self.zrange is None else np.atleast_1d(
            np.asarray(self.zrange, dtype=np.float64)
        )
        w0 = self.lines[0].wrest
        for zz in range(self.ncompmax):
            if zr is None:
                # z prior spans the first fitted window (0.25 A inset) mapped
                # through the first line's rest wavelength.
                zmin = (self.fitrange[0][0] + 0.25) / w0 - 1.0
                zmax = (self.fitrange[0][1] - 0.25) / w0 - 1.0
            elif zr.size == 2:
                zmin, zmax = float(zr[0]), float(zr[1])
            elif zr.size >= 2 * self.ncompmax:
                zmin, zmax = float(zr[2 * zz]), float(zr[2 * zz + 1])
            else:
                raise ValueError("zrange keyword not understood")
            self.z_lims.append((zmin, zmax))

        self.z_lims_fill: List[Tuple[float, float]] = []
        wr = None if self.wrangefill is None else np.atleast_1d(
            np.asarray(self.wrangefill, dtype=np.float64)
        )
        wf = self.linefill.wrest
        for zz in range(self.nfill):
            if wr is None:
                zmin = (wave.min() + 0.25) / wf - 1.0
                zmax = (wave.max() - 0.25) / wf - 1.0
            elif wr.size == 2:
                zmin = wr[0] / wf - 1.0
                zmax = wr[1] / wf - 1.0
            elif wr.size == 2 * self.nfill:
                zmin = wr[2 * zz] / wf - 1.0
                zmax = wr[2 * zz + 1] / wf - 1.0
            else:
                raise ValueError("wrangefill keyword not understood")
            self.z_lims_fill.append((float(zmin), float(zmax)))

        self.startind = int(self.freecont) + int(self.freespecres)
        self.endind = self.startind + 3 * self.ncompmax + 1

        bounds: List[Tuple[float, float]] = []
        if self.freespecres:
            bounds.append(_as_pair(self.specres))
        if self.freecont:
            bounds.append(_as_pair(self.contval))
        bounds.append((float(self.ncompmin), float(self.ncompmax)))
        for ii in range(self.ncompmax):
            bounds.append(_as_pair(self.Nrange))
            bounds.append(self.z_lims[ii])
            bounds.append(_as_pair(self.brange))
        for ii in range(self.nfill):
            bounds.append(_as_pair(self.Nrangefill))
            bounds.append(self.z_lims_fill[ii])
            bounds.append(_as_pair(self.brangefill))
        self.bounds = bounds
        self.ndim = len(bounds)

        # Asymmetric-likelihood thresholds.  The reference draws an *unseeded*
        # standard-normal sample of npix points and counts >3/4/5 sigma
        # exceedances (hires_fitter.py:179-181) -- nondeterministic.  We use
        # the deterministic expectations npix * (1 - Phi(k)) instead, which is
        # the statistical intent; the 1% grace margin is unchanged
        # (hires_fitter.py:296-302).
        self.gauss_cdf = [
            float(self.npix * _sps.ndtr(-k)) for k in (3.0, 4.0, 5.0)
        ]
        self.gracenum = 0.01 * self.npix

        # Pixel-validity mask (the reference uses nansum; we mask explicitly).
        self.valid = (
            np.isfinite(flux) & np.isfinite(noise) & (noise > 0)
        )

    # ------------------------------------------------------------------
    # Prior transforms (unit cube -> physical), reference
    # hires_fitter.py:202-216.
    @property
    def bounds_lo(self) -> np.ndarray:
        return np.array([b[0] for b in self.bounds], dtype=np.float64)

    @property
    def bounds_hi(self) -> np.ndarray:
        return np.array([b[1] for b in self.bounds], dtype=np.float64)

    def scale_cube(self, cube: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds_lo, self.bounds_hi
        return lo + np.asarray(cube, dtype=np.float64) * (hi - lo)

    def canon_layout(self):
        """Label-symmetry gauge-fixing layout for the sampler
        (NSConfig.canon_layout): ``(startind, ncompmax, nfill, ncomp_lo,
        ncomp_hi)``, or None when the components are NOT exchangeable.

        Relabeling component triplets is an exact likelihood symmetry only
        when every component shares identical (N, z, b) priors (the default
        construction; per-component zranges break it,
        hires_fitter.py:143-145) and no Gaussian priors distinguish
        dimensions."""
        if self.gpriors is not None:
            return None
        lo, hi = self.bounds_lo, self.bounds_hi

        def _blocks_equal(start, n):
            if n <= 1:
                return True
            blo = lo[start : start + 3 * n].reshape(n, 3)
            bhi = hi[start : start + 3 * n].reshape(n, 3)
            return bool(
                np.all(blo == blo[0]) and np.all(bhi == bhi[0])
            )

        base = self.startind + 1
        if not _blocks_equal(base, self.ncompmax):
            return None
        if not _blocks_equal(base + 3 * self.ncompmax, self.nfill):
            return None
        return (
            self.startind,
            int(self.ncompmax),
            int(self.nfill),
            float(lo[self.startind]),
            float(hi[self.startind]),
        )

    # ------------------------------------------------------------------
    # Float64 numpy forward model (plot/mock parity path).
    def voigt_tau(self, wave_cm: np.ndarray, logN, z, b_cgs, wrest_cm, f, gamma):
        """Optical depth (cgs inputs), reference hires_fitter.py:331-367."""
        cold = 10.0**logN
        zp1 = z + 1.0
        nujk = CCGS / wrest_cm
        dnu = b_cgs / wrest_cm
        avoigt = gamma / (4.0 * np.pi * dnu)
        uvoigt = (CCGS / (wave_cm / zp1) - nujk) / dnu
        cne = TAU_CONST * cold * f
        return cne * _sps.wofz(uvoigt + 1j * avoigt).real / dnu

    def voigt_model(self, wave_A: np.ndarray, N, b_kms, z, line: LineData):
        """exp(-tau) for one component of one transition
        (hires_fitter.py:369-377)."""
        tau = self.voigt_tau(
            wave_A / 1e8, N, z, b_kms * 1e5, line.wrest / 1e8, line.f, line.gamma
        )
        return np.exp(-tau)

    def convolve_model(self, spec: np.ndarray, fwhm_kms: float) -> np.ndarray:
        """Point-sampled Gaussian kernel, circular boundary
        (hires_fitter.py:452-464); verified to reproduce the reference mocks
        to ~6e-15 (BASELINE.md)."""
        sigma = (fwhm_kms / FWHM_TO_SIGMA) / self.velstep
        n = int(np.ceil(SUPPORT_SIGMAS * sigma))
        k = np.arange(-n, n + 1, dtype=np.float64)
        kernel = np.exp(-(k**2) / (2.0 * sigma**2))
        kernel /= kernel.sum()
        P = spec.size
        idx = (np.arange(P)[:, None] + k.astype(int)[None, :]) % P
        return (spec[idx] * kernel[None, :]).sum(axis=1)

    def _parse_scalar_head(self, p):
        if self.freespecres:
            specresolution = float(p[0])
        else:
            specresolution = float(np.max(self.specres))
        if self.freecont:
            continuum = float(p[1] if self.freespecres else p[0])
        else:
            continuum = float(self.contval[0])
        return specresolution, continuum

    def reconstruct_spec(self, p, targonly: bool = False) -> np.ndarray:
        """Float64 model spectrum for a full parameter vector
        (hires_fitter.py:409-449)."""
        p = np.asarray(p, dtype=np.float64)
        specresolution, continuum = self._parse_scalar_head(p)
        specmodel = np.ones_like(self.obj)
        thisncomp = int(p[self.startind])
        for comp in range(thisncomp):
            i0 = 1 + 3 * comp + self.startind
            _N, _z, _b = p[i0 : i0 + 3]
            for line in self.lines:
                specmodel = specmodel * self.voigt_model(self.obj_wl, _N, _b, _z, line)
        if not targonly:
            for fill in range(self.nfill):
                i0 = 3 * fill + self.endind
                _N, _z, _b = p[i0 : i0 + 3]
                specmodel = specmodel * self.voigt_model(
                    self.obj_wl, _N, _b, _z, self.linefill
                )
        if specresolution > self.velstep:
            specmodel = self.convolve_model(specmodel, specresolution)
        return specmodel * continuum

    def reconstruct_onecomp(self, specresolution, continuum, N, z, b) -> np.ndarray:
        """Single-component target profile (hires_fitter.py:379-392)."""
        specmodel = np.ones_like(self.obj)
        for line in self.lines:
            specmodel = specmodel * self.voigt_model(self.obj_wl, N, b, z, line)
        if specresolution > self.velstep:
            specmodel = self.convolve_model(specmodel, float(specresolution))
        return specmodel * continuum

    def reconstruct_onecomp_fill(self, specresolution, continuum, N, z, b) -> np.ndarray:
        """Single filler profile (hires_fitter.py:394-406)."""
        specmodel = self.voigt_model(self.obj_wl, N, b, z, self.linefill)
        if specresolution > self.velstep:
            specmodel = self.convolve_model(specmodel, float(specresolution))
        return specmodel * continuum

    # ------------------------------------------------------------------
    def chi2(self, p) -> float:
        """Data chi^2 at parameter vector p (hires_fitter.py:236-248)."""
        model = self.reconstruct_spec(p)
        ispec2 = 1.0 / self.obj_noise[self.valid] ** 2
        r = self.obj[self.valid] - model[self.valid]
        return float(np.sum(ispec2 * r * r))

    def lnlhood(self, p) -> float:
        """Host-side float64 Gaussian log-likelihood
        (hires_fitter.py:287-328), including the asymmetric-likelihood
        rejection when enabled."""
        model = self.reconstruct_spec(p)
        v = self.valid
        ispec2 = 1.0 / self.obj_noise[v] ** 2
        r = self.obj[v] - model[v]
        ll = -0.5 * np.sum(ispec2 * r * r - np.log(ispec2) + np.log(2.0 * np.pi))
        if self.asymmlike:
            resid = r / self.obj_noise[v]
            if (resid > 5).sum() > self.gauss_cdf[2] + self.gracenum:
                return -np.inf
            if (resid > 4).sum() > self.gauss_cdf[1] + self.gracenum:
                return -np.inf
        return float(ll)

    # ------------------------------------------------------------------
    # Derived quantities.  NOTE: the reference's calc_w/calc_N index the
    # parameter vector off by one (they omit the +1 for the ncomp slot,
    # hires_fitter.py:482,499) -- we index correctly and document the fix.
    def calc_w(self, p, lineid: int = 0) -> float:
        """Total rest-frame equivalent width of the target profile [A]
        (reference hires_fitter.py:467-491, with corrected indexing)."""
        p = np.asarray(p, dtype=np.float64)
        _, cont = self._parse_scalar_head(p)
        dlam = np.diff(self.obj_wl)
        dlam = np.insert(dlam, 0, dlam[0])
        Wtot = 0.0
        thisncomp = int(p[self.startind])
        for comp in range(thisncomp):
            i0 = 1 + 3 * comp + self.startind
            _N, _z, _b = p[i0 : i0 + 3]
            absorption = cont * self.voigt_model(
                self.obj_wl, _N, _b, _z, self.lines[lineid]
            )
            W = np.sum((1.0 - absorption / cont) * dlam)
            Wtot += W / (1.0 + _z)
        return float(Wtot)

    def calc_N(self, p) -> float:
        """log10 of the summed column density over active components
        (reference hires_fitter.py:493-505, with corrected indexing)."""
        p = np.asarray(p, dtype=np.float64)
        thisncomp = int(p[self.startind])
        total = 0.0
        for comp in range(thisncomp):
            i0 = 1 + 3 * comp + self.startind
            _N, _z, _b = p[i0 : i0 + 3]
            if _z < 10:
                total += 10.0**_N
        return float(np.log10(total)) if total > 0 else -np.inf

    # ------------------------------------------------------------------
    def transition_table(self):
        """Flattened (component x transition) table driving the fused JAX
        tau synthesis.  Returns dict of numpy arrays of length
        T = ncompmax * numlines + nfill."""
        pidx, wrest, f, gamma, comp_id, is_fill = [], [], [], [], [], []
        for c in range(self.ncompmax):
            base = 1 + 3 * c + self.startind
            for line in self.lines:
                pidx.append(base)
                wrest.append(line.wrest)
                f.append(line.f)
                gamma.append(line.gamma)
                comp_id.append(c)
                is_fill.append(False)
        for j in range(self.nfill):
            base = 3 * j + self.endind
            pidx.append(base)
            wrest.append(self.linefill.wrest)
            f.append(self.linefill.f)
            gamma.append(self.linefill.gamma)
            comp_id.append(self.ncompmax + j)
            is_fill.append(True)
        return {
            "pidx": np.asarray(pidx, np.int32),
            "wrest": np.asarray(wrest, np.float64),
            "f": np.asarray(f, np.float64),
            "gamma": np.asarray(gamma, np.float64),
            "comp_id": np.asarray(comp_id, np.int32),
            "is_fill": np.asarray(is_fill, bool),
        }

    def kernel_half_size(self) -> int:
        """Static LSF kernel half-width from the largest admissible FWHM
        (reference hires_fitter.py:548-560)."""
        if self.freespecres:
            max_res = float(self.specres[1])
        else:
            max_res = float(np.max(self.specres))
        return kernel_half_size(max_res, self.velstep)

    def get_jax_likelihood(self):
        """Reference-API convenience (hires_fitter.py:521): returns the
        jitted device log-likelihood over *physical* parameter vectors,
        batched over arbitrary leading axes.  Prefer
        :func:`mcalf_tpu.models.make_jax_forward` for the full bundle
        (cube transform, reconstruction, chi2)."""
        from mcalf_tpu.models.jax_model import make_jax_forward

        return make_jax_forward(self).loglike
