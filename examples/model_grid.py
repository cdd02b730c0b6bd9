#!/usr/bin/env python3
"""Model-grid fitting: one fixed-ncomp fit per mesh device + evidence table.

The reference explores the component count *inside one run* via the sampled
ncomp dimension (product-space trans-dimensional inference).  The classical
alternative -- one fit per fixed component count, compared by evidence -- is
embarrassingly parallel, and on a device mesh it costs one fit of
wall-clock: every candidate model runs on its own device simultaneously.

This example fits the bundled single-component CIV mock at fixed
ncomp = 1 and 2 (four seeds each on an 8-device mesh), prints the evidence
table with Bayes factors, and merges the per-model seeds for tighter logZ.
(Swap in civ_mock_spec_multicomp.txt and a grid of 8-11 for the flagship
version -- on GPUs; it is heavy on CPU.)

Run on the virtual CPU mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/model_grid.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from mcalf_tpu.models import AbsorptionModel
    from mcalf_tpu.models.batched import stack_problems
    from mcalf_tpu.parallel import fit_stacked, make_mesh
    from mcalf_tpu.sampler import NSConfig
    from mcalf_tpu.sampler.merge import merge_results

    here = os.path.dirname(os.path.abspath(__file__))
    spec = os.path.join(here, "..", "testdata", "civ_mock_spec.txt")

    ncomp_grid = [1, 2]
    seeds_per_model = 4

    # Fixed-ncomp models: ncomp=(k, k) pins the dimension; pad the parameter
    # layout to the largest k so all problems stack (same ndim).  Simpler:
    # run each k at ncompmax=max(grid) with ncomp=(k, k) -- identical layout,
    # the ncomp prior collapses to the single value k.
    kmax = max(ncomp_grid)
    problems = []
    for k in ncomp_grid:
        # ncompmax = kmax keeps the parameter layout identical across the
        # grid (stackable); the ncomp prior is pinned to the value k below.
        m2 = AbsorptionModel.from_file(
            spec,
            fitrange=[(6180.0, 6220.0)],
            fitlines=["CIV 1548", "CIV 1550"],
            ncomp=(k, kmax),
            specres=[8.0],
            Nrange=[12.0, 14.5],
            brange=[10.0, 40.0],
            zrange=[2.99, 3.01],
        )
        # force the ncomp prior to the single value k: bounds (k, k+eps)
        m2.bounds[m2.startind] = (float(k), float(k) + 1e-3)
        problems.extend([m2] * seeds_per_model)

    stat, stacked = stack_problems(problems)
    # refresh per-problem bounds into the stacked pytree (bounds edited above)
    lo = np.stack([m.bounds_lo for m in problems]).astype(np.float32)
    hi = np.stack([m.bounds_hi for m in problems]).astype(np.float32)
    stacked["lo"], stacked["hi"] = lo, hi

    mesh = make_mesh()
    # Demo budgets (CPU-friendly); production evidences want nlive >= 200
    # and num_repeats >= 8*ndim.
    cfg = NSConfig(
        ndim=problems[0].ndim, nlive=60, max_samples=4000,
        precision_criterion=0.05, num_repeats=20,
    )
    print(f"Fitting {len(problems)} problems on {mesh.devices.size} devices...")
    res = fit_stacked(stat, stacked, cfg, seed=17, mesh=mesh)

    print("\n  ncomp |    logZ (merged over seeds)   | dlogZ vs best")
    merged = {}
    for i, k in enumerate(ncomp_grid):
        runs = [
            jax.tree.map(lambda x: x[i * seeds_per_model + j], res)
            for j in range(seeds_per_model)
        ]
        merged[k] = merge_results(runs)
    best = max(m.logz for m in merged.values())
    for k in ncomp_grid:
        m = merged[k]
        print(f"    {k:3d} | {m.logz:10.2f} +/- {m.logzerr:5.2f}       | {m.logz - best:8.2f}")
    kbest = max(merged, key=lambda k: merged[k].logz)
    print(
        f"\nPreferred model: ncomp = {kbest} (truth: 1; demo budgets are "
        "small -- production evidences want nlive>=200, num_repeats>=8*ndim)"
    )


if __name__ == "__main__":
    main()
