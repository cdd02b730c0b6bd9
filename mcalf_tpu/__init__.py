"""MC-ALF-TPU: an accelerator-native Bayesian absorption-line fitting framework.

A ground-up rebuild of the capabilities of matteofox/MC-ALF (Monte-Carlo
Absorption Line Fitter) designed for accelerators: the Voigt forward model,
Gaussian LSF convolution, likelihood, and the nested sampler itself all run
on-device under ``jit``, batched over live points and sharded over device
meshes across sightlines and candidate models.  Host code only does config,
IO, and reporting.
"""

from mcalf_tpu._version import __version__

__all__ = ["__version__"]
