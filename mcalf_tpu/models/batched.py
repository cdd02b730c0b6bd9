"""Stacking many fit problems into one SPMD-ready data pytree.

The reference can only fit one spectrum per process (MPI parallelism lives
*inside* its external samplers, SURVEY.md section 2.3).  Here, independent
problems -- different sightlines, different candidate models, different
seeds -- become a leading axis of the data pytree, and
:mod:`mcalf_tpu.parallel` shards that axis over the device mesh.  All
problems in a stack must share one :class:`StaticSpec` (same ndim, npix,
transition count, kernel support, flags); pad spectra to a common grid if
needed (masked pixels carry zero inverse variance, so padding does not
affect the likelihood).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from mcalf_tpu.models.forward import AbsorptionModel
from mcalf_tpu.models.jax_model import StaticSpec, build_consts, static_spec

__all__ = ["stack_problems", "pad_model_to_npix"]


def stack_problems(
    models: Sequence[AbsorptionModel],
    conv_mode: str = "same_edge",
    gpriors: bool = False,
) -> Tuple[StaticSpec, Dict[str, Any]]:
    """Stack N fit problems into (shared StaticSpec, data pytree with leading
    axis N).  Raises if the problems are not structurally identical."""
    if not models:
        raise ValueError("need at least one model")
    specs = [
        static_spec(m, conv_mode=conv_mode, gpriors=gpriors) for m in models
    ]
    s0 = specs[0]
    for i, s in enumerate(specs[1:], 1):
        if s != s0:
            raise ValueError(
                f"problem {i} has incompatible structure:\n  {s}\nvs\n  {s0}\n"
                "(pad spectra to a common pixel grid and use identical "
                "component/line configuration to stack)"
            )
    consts = [build_consts(m, gpriors=gpriors) for m in models]
    stacked = {
        k: np.stack([c[k] for c in consts], axis=0) for k in consts[0]
    }
    # Layout index tables are identical across problems -- keep them
    # unstacked so gathers stay static.
    for k in ("pidx", "comp_id", "is_fill", "u_zidx"):
        stacked[k] = consts[0][k]
    return s0, stacked


def index_consts(stacked: Dict[str, Any], i) -> Dict[str, Any]:
    """Select problem ``i`` from a stacked pytree (static tables pass
    through)."""
    out = {}
    for k, v in stacked.items():
        if k in ("pidx", "comp_id", "is_fill", "u_zidx"):
            out[k] = v
        else:
            out[k] = v[i]
    return out


def pad_model_to_npix(model: AbsorptionModel, npix: int) -> AbsorptionModel:
    """Pad a problem's spectrum to ``npix`` pixels with zero-weight pixels so
    structurally similar sightlines of different lengths can stack.

    Padded pixels extend the wavelength grid at the red end with the median
    *logarithmic* pixel spacing (constant velocity step, so the derived
    ``velstep`` -- and hence the LSF kernel -- is unchanged), carry flux=1
    and noise=inf (=> zero inverse variance and no likelihood
    contribution)."""
    cur = model.npix
    if cur > npix:
        raise ValueError(f"model has {cur} pixels > target {npix}")
    if cur == npix:
        return model
    extra = npix - cur
    ratio = float(np.median(model.obj_wl[1:] / model.obj_wl[:-1]))
    wave = np.concatenate(
        [model.obj_wl, model.obj_wl[-1] * ratio ** np.arange(1, extra + 1)]
    )
    flux = np.concatenate([model.obj, np.ones(extra)])
    noise = np.concatenate([model.obj_noise, np.full(extra, np.inf)])
    return AbsorptionModel(
        wave=wave,
        flux=flux,
        noise=noise,
        lines=model.lines,
        ncomp=(model.ncompmin, model.ncompmax),
        nfill=model.nfill,
        specres=model.specres,
        contval=model.contval,
        Nrange=model.Nrange,
        brange=model.brange,
        zrange=model.zrange,
        Nrangefill=model.Nrangefill,
        brangefill=model.brangefill,
        wrangefill=model.wrangefill,
        fitrange=None,  # arrays are already masked; keep as-is
        asymmlike=model.asymmlike,
        gpriors=model.gpriors,
    )
