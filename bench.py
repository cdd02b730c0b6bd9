#!/usr/bin/env python3
"""Flagship benchmark: the reference's shipped workload end-to-end on one
NVIDIA GPU.

Workload (reference testdata/fit.cfg:24-42): trans-dimensional fit of the
10-component CIV mock with ncomp in [8,11] (ndim=34), nlive=200 -- run
entirely on-device by the native nested sampler in its PRODUCTION
configuration: label-gauge fixing + triplet-DE (canon_layout), mode
clustering, num_delete = nlive//2 = 100, num_repeats = 544 -- the FIRST
CONVERGED RUNG of the repeats ladder, calibrated on FRESH seeds
(tools/flagship_study_r05_anchor.jsonl, seeds 51-62): 272 -> 4856.60 +/-
0.46 (n=8), 544 -> 4854.94 +/- 0.48 (n=8), 1088 -> 4855.37 (n=2).  The
272->544 doubling shift is -1.66 +/- 0.66 (2.5 sigma) -- real residual
under-mixing bias at 272 -- while 544->1088 is +0.43 +/- 1.45, so the
ladder criterion (run at the first rung whose doubling moves logZ by less
than its combined uncertainty) selects 544.  The per-seed logZ scatter is
sd ~1.33, 1.6x the quoted per-run logzerr ~0.84 (SEED_SCATTER_SD below);
the convergence gate uses the measured scatter, not the quoted error.

Two independent seeds are fit and merged via birth-contour run merging
(sampler/merge.py).  ``converged`` gates on the evidence termination
criterion AND the Fowlie et al. insertion-rank health test (p > 0.01) for
every seed AND the merged evidence landing within 2 sigma of the
fresh-seed 544+1088 pooled limit (logz_vs_ladder_limit) -- a failing
sampler cannot report success.

The benchmark runs only on a GPU whose peak rates are in PEAKS: with no
GPU it exits non-zero (a CPU timing is not a device number).

Printed JSON:
* value          -- end-to-end wall-clock of ONE converged fit [s] with
                    the executables resident (seed A; seed B repeats it as
                    extra.fit_s_warm).  The one-time executable build/load
                    happens inside an UNTIMED sampler.warmup_executables
                    call (two production-shape steps driving every
                    executable on the fit path), recorded as
                    extra.warmup_compile_s, with extra.distinct_executables
                    counting the programs built (jax.monitoring
                    backend-compile events) and extra.compile_cache saying
                    whether the persistent cache held entries before the
                    run (utils/compile_cache.py).
* vs_baseline    -- sustained-throughput ratio, on the SAME device, of our
                    sampler's execution pattern (likelihood batched over
                    the deletion block) versus the reference's execution
                    pattern (its best solver, jaxns, evaluates the
                    likelihood point-sequentially inside the sampler loop;
                    re-expressed faithfully in ops/reference_style.py).
                    The reference publishes no absolute numbers
                    (BASELINE.md), so same-hardware pattern speedup is the
                    honest comparison.
* extra          -- merged/per-seed logZ + rank health, eval counts,
                    throughputs, the census FLOP rate over the device's
                    published float32 peak (PEAKS), a num_delete
                    batch-width study, and an interleaved
                    4-problem-vmapped occupancy measurement.
"""

import json
import os
import sys
import time

import numpy as np

#: Repeats-ladder limit: the FRESH-SEED 544+1088 pool
#: (tools/flagship_study_r05_anchor.jsonl, seeds 51-58 at 544 and 55-56 at
#: 1088, n=10): 4855.03 +/- 0.44.  Fresh seeds matter: a limit pooled
#: from the seeds the bench merges would be correlated with the quantity
#: it gates.
LADDER_LIMIT = 4855.03
#: sem of the pooled limit above
LADDER_LIMIT_SEM = 0.44
#: Measured per-seed logZ scatter at the production rung (sd over the
#: n=8 fresh 544 runs; 1.6x the quoted per-run logzerr ~0.84 -- the
#: quoted error understates run-to-run variation, so gates use this).
SEED_SCATTER_SD = 1.33

#: Published peak rates per device kind (NVIDIA H100 data sheet, SXM part:
#: float32 outside the tensor cores, HBM3 bandwidth).  The likelihood has
#: no matrix products, so the float32 vector peak is its roofline.  A
#: device kind missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}

REPO = os.path.dirname(os.path.abspath(__file__))


def require_gpu():
    """The first JAX device and its peak rates; SystemExit when JAX finds
    no GPU or the kind has no entry in PEAKS."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench: no GPU found (JAX runs on {dev.platform}); the "
            "benchmark measures the GPU only"
        )
    if dev.device_kind not in PEAKS:
        raise SystemExit(
            f"bench: no peak rates for device kind {dev.device_kind!r}; "
            "add it to PEAKS with its source"
        )
    return dev, PEAKS[dev.device_kind]


def _make_sustained(fn, arg, iters=400):
    """Sustained-rate measure of ``fn`` over a batch ``arg``: ``iters``
    evaluations inside one jitted loop (as the sampler calls the
    likelihood), each on a slightly shifted input so XLA cannot hoist the
    call out of the loop, ending in block_until_ready.  Returns a
    measure() -> evaluations/s closure."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(x):
        def body(i, acc):
            return acc + jnp.sum(fn(x + i.astype(jnp.float32) * 1e-7))

        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    loop(arg).block_until_ready()  # compile

    def measure():
        t0 = time.perf_counter()
        loop(arg).block_until_ready()
        return iters * arg.shape[0] / (time.perf_counter() - t0)

    return measure


def _interleaved_best(measures, reps=3):
    """Alternate the measurements (compare in turns, not in sequence);
    take each function's best."""
    best = [0.0] * len(measures)
    for _ in range(reps):
        for i, m in enumerate(measures):
            best[i] = max(best[i], m())
    return best


def _hi_forest_fit():
    """Secondary workload: HI Lya forest + filler nuisance line (BASELINE.md
    config #4, mirroring tests/test_hi_forest.py) -- a different transition,
    grid, and trans-dimensional shape (ncomp 1-3 + 1 filler, ndim=13) so the
    recorded numbers show the sampler generalizes beyond the CIV flagship.
    Truth: 2 HI components plus a CIV contaminant the filler absorbs."""
    import jax

    from mcalf_tpu.atomic import get_lines
    from mcalf_tpu.models import AbsorptionModel, make_jax_forward
    from mcalf_tpu.models.forward import CLIGHT_KMS
    from mcalf_tpu.sampler import NSConfig, insertion_rank_test, nested_sample

    velstep = 2.0
    step = 1.0 + velstep / CLIGHT_KMS
    n = 400
    wave = 4251.0 * step ** np.arange(n)
    gen = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, 0.02),
        lines=get_lines(["HI 1215"]), ncomp=(2, 2), specres=[8.0],
    )
    p = np.array([2.0, 13.6, 2.4975, 25.0, 13.2, 2.4995, 18.0])
    flux = gen.reconstruct_spec(p)
    civ = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, 0.02),
        lines=get_lines(["CIV 1548"]), ncomp=(1, 1), specres=[8.0],
    )
    zciv = 4259.0 / 1548.204 - 1.0
    flux = flux * civ.reconstruct_spec(np.array([1.0, 13.4, zciv, 12.0]))
    rng = np.random.RandomState(7)
    noisy = flux + rng.normal(0, 0.02, n)

    m = AbsorptionModel(
        wave=wave, flux=noisy, noise=np.full(n, 0.02),
        lines=get_lines(["HI 1215"]), ncomp=(1, 3), nfill=1,
        specres=[8.0], Nrange=[12.5, 14.5], brange=[10.0, 40.0],
        zrange=[(4251.0 / 1215.67 - 1), (4262.0 / 1215.67 - 1)],
        Nrangefill=[12.5, 15.0], brangefill=[5.0, 30.0],
    )
    fwd = make_jax_forward(m)
    cfg = NSConfig(
        ndim=m.ndim, nlive=100, max_samples=8000, precision_criterion=0.05,
        canon_layout=m.canon_layout(),
    )
    t0 = time.perf_counter()
    res = nested_sample(fwd.loglike_cube, jax.random.PRNGKey(11), cfg)
    jax.block_until_ready(res.logz)
    wall = time.perf_counter() - t0
    diag = insertion_rank_test(res, cfg)
    # Posterior over the active component count (ncomp dim is index 0; no
    # free specres/continuum in this model).
    lo, hi = float(fwd.bounds_lo[0]), float(fwd.bounds_hi[0])
    k = np.floor(lo + np.asarray(res.samples_u)[:, 0] * (hi - lo)).astype(int)
    w = np.exp(np.asarray(res.log_posterior_weights, np.float64))
    mass = {int(kk): float(w[k == kk].sum()) for kk in np.unique(k)}
    map_ncomp = max(mass, key=mass.get)
    return {
        "wall_s": round(wall, 1),
        "logz": round(float(res.logz), 2),
        "logzerr": round(float(res.logzerr), 2),
        "n_like": int(res.n_like),
        "rank_p": round(diag.p_value, 4),
        "map_ncomp": map_ncomp,
        "map_ncomp_mass": round(mass[map_ncomp], 3),
        "converged": bool(int(res.termination_reason) == 0),
    }


def main():
    import dataclasses

    import jax

    dev, peaks = require_gpu()

    # Persistent executable cache (utils/compile_cache.py), enabled BEFORE
    # the first compile; extra.compile_cache records whether it held
    # entries before this run.
    from mcalf_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    cache_warm = bool(cache_dir and os.listdir(cache_dir))

    from mcalf_tpu.models import AbsorptionModel, make_jax_forward
    from mcalf_tpu.ops.reference_style import make_reference_style_loglike
    from mcalf_tpu.sampler import (
        NSConfig,
        init_state,
        insertion_rank_test,
        merge_results,
        nested_sample,
        run_steps,
        warmup_executables,
    )

    model = AbsorptionModel.from_file(
        os.path.join(REPO, "testdata", "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=(8, 11),
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    fwd = make_jax_forward(model)
    # PRODUCTION kernel configuration: gauge fixing + triplet-DE via
    # canon_layout (exactly what runner.fit_config applies) and the
    # num_delete default (nlive//2 = 100).
    cfg = NSConfig(
        ndim=model.ndim,
        nlive=200,
        num_repeats=544,
        max_samples=60000,
        precision_criterion=1e-3,
        canon_layout=model.canon_layout(),
    )

    # ---- untimed warmup: make the flagship executables resident ----------
    # sampler.warmup_executables drives every executable on the seed-A path
    # (init_state, the single traced-num_steps run_steps program, the
    # jitted termination check, finalize) through compile-or-cache-load, so
    # time-to-first-result is warmup + one fit.  distinct_executables counts
    # backend compiles during warmup via jax.monitoring.
    compile_events = {"backend_compiles": 0, "cache_hits": 0}

    def _count_compiles(key, *a, **kw):
        if key == "/jax/core/compile/backend_compile_duration":
            compile_events["backend_compiles"] += 1

    def _count_hits(key, **kw):
        if key == "/jax/compilation_cache/cache_hits":
            compile_events["cache_hits"] += 1

    jax.monitoring.register_event_duration_secs_listener(_count_compiles)
    jax.monitoring.register_event_listener(_count_hits)
    t0 = time.perf_counter()
    warmup_executables(fwd.loglike_cube, jax.random.PRNGKey(7), cfg)
    warmup_compile_s = time.perf_counter() - t0
    distinct_executables = compile_events["backend_compiles"]
    cache_hits_at_warmup = compile_events["cache_hits"]
    # Second call with everything resident: the per-call cost of the
    # warmup steps alone.
    t0 = time.perf_counter()
    warmup_executables(fwd.loglike_cube, jax.random.PRNGKey(8), cfg)
    warmup_repeat_s = time.perf_counter() - t0

    # ---- end-to-end converged fits (2 seeds) + merge --------------------
    runs, times, ranks = [], [], []
    for seed in (43, 44):
        t0 = time.perf_counter()
        res = nested_sample(fwd.loglike_cube, jax.random.PRNGKey(seed), cfg)
        jax.block_until_ready(res.logz)
        times.append(time.perf_counter() - t0)
        runs.append(res)
        ranks.append(insertion_rank_test(res, cfg))
    fit_s = times[0]
    fit_s_warm = times[1]  # seed B reuses seed A's single executable
    n_like = int(runs[0].n_like)
    merged = merge_results(runs)
    logz_seeds = [round(float(r.logz), 3) for r in runs]
    seed_spread = round(max(logz_seeds) - min(logz_seeds), 3)
    # A failing health check or a truncated run is NOT a success, whatever
    # the termination flag says.  Third gate per the module docstring: the
    # merged evidence must land within 2 sigma of the fresh-seed pooled
    # ladder limit; the merged-run scatter is SEED_SCATTER_SD/sqrt(2) (two
    # seeds), combined with the limit's sem.
    ladder_tol = 2.0 * float(
        np.hypot(SEED_SCATTER_SD / np.sqrt(2.0), LADDER_LIMIT_SEM)
    )
    converged = (
        all(int(r.termination_reason) == 0 for r in runs)
        and all(d.p_value > 0.01 for d in ranks)
        and abs(merged.logz - LADDER_LIMIT) < ladder_tol
    )

    # Secondary workload: HI forest + filler (different transition/grid/
    # trans-dimensional shape; generality evidence).
    hi_forest = _hi_forest_fit()

    # ---- nlive=400 / num_delete=200 flagship study -----------------------
    # B=200 needs nlive >= 400, and convergence needs ~2x the dead points
    # at 2x nlive -- whether a per-eval throughput win survives END-TO-END
    # is an empirical question answered here: one converged fit at the
    # same calibrated num_repeats, judged against the ladder limit.
    cfg400 = dataclasses.replace(
        cfg, nlive=400, num_delete=200, max_samples=120000
    )
    t0 = time.perf_counter()
    res400 = nested_sample(fwd.loglike_cube, jax.random.PRNGKey(43), cfg400)
    jax.block_until_ready(res400.logz)
    wall400 = time.perf_counter() - t0
    d400 = insertion_rank_test(res400, cfg400)
    nlive400_study = {
        "wall_s": round(wall400, 1),
        "logz": round(float(res400.logz), 3),
        "logzerr": round(float(res400.logzerr), 3),
        "n_like": int(res400.n_like),
        "kevals_per_s": round(int(res400.n_like) / wall400 / 1e3),
        "rank_p": round(d400.p_value, 4),
        "vs_ladder_limit": round(float(res400.logz) - LADDER_LIMIT, 3),
        "converged": bool(int(res400.termination_reason) == 0),
    }

    # ---- sustained likelihood throughput vs reference formulation -------
    rng = np.random.default_rng(0)
    lo = np.asarray(fwd.bounds_lo)
    hi = np.asarray(fwd.bounds_hi)

    def draw(B):
        return (
            lo + rng.uniform(0.2, 0.8, size=(B, model.ndim)) * (hi - lo)
        ).astype(np.float32)

    ref_ll = make_reference_style_loglike(model)
    B_prod = cfg.resolved().num_delete
    p200 = draw(cfg.nlive)
    pprod = draw(B_prod)
    p1 = draw(1)
    ours_eps, ref_eps = _interleaved_best(
        [_make_sustained(fwd.loglike, p200), _make_sustained(ref_ll, p200)]
    )
    ours_eps_small, ref_eps_small = _interleaved_best(
        [_make_sustained(fwd.loglike, pprod), _make_sustained(ref_ll, pprod)]
    )
    # The reference's execution pattern: point-sequential likelihood calls
    # inside the sampler loop (jaxns, cli.py:275-280).
    (ref_eps_seq,) = _interleaved_best(
        [_make_sustained(ref_ll, p1, iters=2000)]
    )

    # ---- num_delete batch-width study (evals/s via real sampler steps) ---
    # interleaved across the three widths, so only the relative batch-width
    # effect remains.
    def _make_ndel_measure(ndel):
        c2 = NSConfig(
            ndim=model.ndim, nlive=max(cfg.nlive, 2 * ndel),
            num_delete=ndel, num_repeats=64, max_samples=60000,
            canon_layout=model.canon_layout(),
        )
        st = init_state(fwd.loglike_cube, jax.random.PRNGKey(0), c2)
        st = run_steps(fwd.loglike_cube, st, c2, 3)  # compile + warm
        jax.block_until_ready(st.logz)
        holder = {"st": st}

        def measure():
            s0 = holder["st"]
            n0 = int(s0.n_like)
            t0 = time.perf_counter()
            s1 = run_steps(fwd.loglike_cube, s0, c2, 10)
            jax.block_until_ready(s1.logz)
            dt = time.perf_counter() - t0
            holder["st"] = s1
            return (int(s1.n_like) - n0) / dt

        return measure

    ndel_widths = (50, 100, 200)
    ndel_rates = _interleaved_best([_make_ndel_measure(n) for n in ndel_widths])
    ndel_study = {
        str(n): round(r / 1e3) for n, r in zip(ndel_widths, ndel_rates)
    }

    # ---- occupancy: K vmapped flagship problems on ONE device ------------
    # Is the device under-filled at one problem?  Aggregate sampler step
    # throughput at K = 1 vs 4 problems VECTORIZED (jax.vmap over NSState --
    # the likelihood batch becomes (K, B, ndim)), interleaved in one
    # process.
    ck = dataclasses.replace(cfg, num_repeats=64, max_samples=4000).resolved()

    def _make_vmeasure(K):
        keys = jax.random.split(jax.random.PRNGKey(0), K)
        st = jax.jit(
            jax.vmap(lambda k: init_state(fwd.loglike_cube, k, ck))
        )(keys)
        step = jax.jit(
            jax.vmap(lambda s: run_steps(fwd.loglike_cube, s, ck, 6))
        )
        st = step(st)  # compile + warm
        jax.block_until_ready(st.logz)
        holder = {"st": st}

        def measure():
            s0 = holder["st"]
            n0 = int(np.sum(np.asarray(s0.n_like)))
            t0 = time.perf_counter()
            s1 = step(s0)
            jax.block_until_ready(s1.logz)
            dt = time.perf_counter() - t0
            holder["st"] = s1
            return (int(np.sum(np.asarray(s1.n_like))) - n0) / dt
        return measure

    k1_eps, k4_eps = _interleaved_best(
        [_make_vmeasure(1), _make_vmeasure(4)]
    )
    occupancy_gain = round(k4_eps / k1_eps, 2)

    # ---- utilization against the published peak -------------------------
    # FLOPs/eval from an automatic op census of the likelihood's jaxpr
    # (utils/flops.py; policy stated there -- elementwise arithmetic at 1
    # FLOP per output element, FMA=2, transcendentals at 1 = a LOWER
    # bound, predicates/selects/data-movement at 0).
    from mcalf_tpu.utils.flops import flop_census

    census = flop_census(fwd.loglike, pprod)
    flops = census.flops // B_prod
    kernel_utilization_pct = round(
        100.0 * ours_eps_small * flops / peaks["f32_flops"], 2
    )
    # Fit-level throughput from the WARM fit (seed B).
    fit_eps = int(runs[1].n_like) / fit_s_warm
    utilization_pct = round(100.0 * fit_eps * flops / peaks["f32_flops"], 2)

    print(
        json.dumps(
            {
                "metric": "civ_multicomp_converged_fit_walltime",
                "value": round(fit_s, 1),
                "unit": "s",
                "vs_baseline": round(ours_eps_small / ref_eps_seq, 2),
                "extra": {
                    "logz": round(merged.logz, 3),
                    "logzerr": round(merged.logzerr, 3),
                    "logz_seeds": logz_seeds,
                    "seed_spread": seed_spread,
                    "logz_vs_ladder_limit": round(
                        merged.logz - LADDER_LIMIT, 3
                    ),
                    "num_repeats": cfg.num_repeats,
                    "ladder_limit": LADDER_LIMIT,
                    "ladder_tol_2sigma": round(ladder_tol, 3),
                    "seed_scatter_sd": SEED_SCATTER_SD,
                    "rank_test_p": [round(d.p_value, 4) for d in ranks],
                    "rank_test_p_blocks": [
                        round(d.p_value_blocks, 4) for d in ranks
                    ],
                    "rank_test_kappa": round(ranks[0].kappa, 3),
                    "converged": converged,
                    "n_like": n_like,
                    "fit_s_warm": round(fit_s_warm, 1),
                    "compile_cache": "warm" if cache_warm else "cold",
                    "warmup_compile_s": round(warmup_compile_s, 1),
                    "distinct_executables": distinct_executables,
                    "cache_hits_at_warmup": cache_hits_at_warmup,
                    "warmup_repeat_s": round(warmup_repeat_s, 1),
                    "nlive400_b200": nlive400_study,
                    "fit_evals_per_s": round(fit_eps, 1),
                    "censused_flops_per_eval": flops,
                    "est_sustained_tflops": round(fit_eps * flops / 1e12, 3),
                    "peak_f32_tflops": peaks["f32_flops"] / 1e12,
                    "kernel_utilization_pct": kernel_utilization_pct,
                    "utilization_pct": utilization_pct,
                    "fused_likelihood_evals_per_s": round(ours_eps, 1),
                    "reference_style_evals_per_s": round(ref_eps, 1),
                    "reference_sequential_evals_per_s": round(ref_eps_seq, 1),
                    "formulation_ratio_live_batch": round(ours_eps / ref_eps, 2),
                    "formulation_ratio_deletion_batch": round(
                        ours_eps_small / ref_eps_small, 2
                    ),
                    "hi_forest": hi_forest,
                    "num_delete_kevals_per_s": ndel_study,
                    "vmap4_kevals_per_s": round(k4_eps / 1e3),
                    "vmap1_kevals_per_s": round(k1_eps / 1e3),
                    "occupancy_gain_4x": occupancy_gain,
                    "device": {
                        "platform": dev.platform,
                        "kind": dev.device_kind,
                        "count": len(jax.devices()),
                    },
                },
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
