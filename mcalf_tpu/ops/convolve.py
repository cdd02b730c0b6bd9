"""Gaussian line-spread-function convolution, batched and fusible by XLA.

Two exact semantics are provided because the reference has two (deliberately
different) convolution paths:

* ``mode='wrap'``   -- point-sampled Gaussian kernel, normalized to sum 1,
  *circular* boundary.  This is the numpy/plotting/mock path
  (astropy ``convolve(..., boundary='wrap')``, hires_fitter.py:452-464) and
  reproduces the reference mocks to machine precision.
* ``mode='same_edge'`` -- zero-padded 'same' convolution with the
  ``half_size`` edge pixels on each side reset to the *unconvolved* model.
  This is the reference's JAX-likelihood path (hires_fitter.py:666-681) and
  is the parity target for fits.

The implementation is a statically-unrolled shifted-slice accumulation over
the (small, static) kernel support: for K taps it is K fused multiply-adds
over the whole batch, which XLA fuses into one elementwise kernel with no gather and
no dynamic shapes.  It natively supports a *per-sample* kernel width
(floating ``specres`` sampled by the nested sampler), which a plain
``lax.conv`` cannot express.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["kernel_half_size", "gaussian_kernel", "lsf_convolve"]

#: FWHM -> sigma conversion used throughout the reference (hires_fitter.py:454)
FWHM_TO_SIGMA = 2.354820
#: Gaussian support radius in sigmas (astropy Gaussian1DKernel default via
#: the reference's explicit x_size formula, hires_fitter.py:456-459)
SUPPORT_SIGMAS = 3.0348


def kernel_half_size(max_fwhm_kms: float, velstep_kms: float) -> int:
    """Static kernel half-width in pixels for the largest admissible FWHM
    (reference sizing: hires_fitter.py:548-560)."""
    sigma_max = (float(max_fwhm_kms) / FWHM_TO_SIGMA) / float(velstep_kms)
    return int(np.ceil(SUPPORT_SIGMAS * sigma_max))


def gaussian_kernel(sigma_pix, half_size: int):
    """Point-sampled normalized Gaussian kernel.

    ``sigma_pix`` may be a scalar or a batch of shape (...,); the returned
    kernel has shape (..., 2*half_size+1).  Matches astropy's
    ``Gaussian1DKernel(sigma, x_size)`` with mode='center' after
    normalization, and the reference's explicit JAX kernel
    (hires_fitter.py:666-670).
    """
    sigma_pix = jnp.asarray(sigma_pix)
    x = jnp.arange(-half_size, half_size + 1, dtype=sigma_pix.dtype)
    k = jnp.exp(-(x**2) / (2.0 * sigma_pix[..., None] ** 2))
    return k / jnp.sum(k, axis=-1, keepdims=True)


def lsf_convolve(flux, kernel, mode: str = "same_edge"):
    """Convolve batched spectra with (possibly batched) symmetric kernels.

    Parameters
    ----------
    flux : (..., P) array
    kernel : (K,) or (..., K) array, K = 2*half+1 odd, normalized
    mode : 'same_edge' | 'wrap' | 'same'
        'same_edge' additionally resets the ``half`` edge pixels on each side
        to the unconvolved input (reference hires_fitter.py:674-681).

    Returns (..., P) array.
    """
    flux = jnp.asarray(flux)
    kernel = jnp.asarray(kernel)
    K = kernel.shape[-1]
    if K % 2 != 1:
        raise ValueError("kernel size must be odd")
    half = K // 2
    P = flux.shape[-1]

    if mode == "wrap":
        pad_width = [(0, 0)] * (flux.ndim - 1) + [(half, half)]
        padded = jnp.pad(flux, pad_width, mode="wrap")
    elif mode in ("same", "same_edge"):
        pad_width = [(0, 0)] * (flux.ndim - 1) + [(half, half)]
        padded = jnp.pad(flux, pad_width, mode="constant")
    else:
        raise ValueError(f"unknown convolution mode {mode!r}")

    # Statically unrolled shifted-slice FMA: out[i] = sum_k kernel[k] *
    # padded[i + k].  The kernel is symmetric, so convolution == correlation.
    acc = kernel[..., 0:1] * padded[..., 0:P]
    for k in range(1, K):
        acc = acc + kernel[..., k : k + 1] * padded[..., k : k + P]

    if mode == "same_edge":
        idx = jnp.arange(P)
        edge = (idx < half) | (idx >= P - half)
        acc = jnp.where(edge, flux, acc)
    return acc
