#!/usr/bin/env python3
"""Flagship evidence-convergence study (run on the GPU).

Re-measures the num_repeats ladder for the trans-dimensional 10-component
CIV flagship fit with the PRODUCTION kernel configuration (canon_layout
gauge fixing + triplet-DE move + uniformly-random chain starts), plus:

* a num_delete=50 vs 100 quality comparison at fixed repeats,
* fixed-k runs (ncomp locked to 8 / 9 / 10) whose evidences give the exact
  decomposition Z_flagship = (Z8 + Z9 + Z10)/3 (uniform ncomp prior on
  [8, 11], floor -> mass 1/3 each; k=11 has measure zero) -- an independent
  truth cross-check for the trans-dimensional evidence.

Each fit appends one JSON line to the output file as it finishes, so a
killed run loses nothing.  Usage:

    python tools/flagship_study.py [out.jsonl]
"""

import dataclasses
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def make_model(ncomp):
    from mcalf_tpu.models import AbsorptionModel

    return AbsorptionModel.from_file(
        os.path.join(os.path.dirname(HERE), "testdata",
                     "civ_mock_spec_multicomp.txt"),
        fitrange=[(6180.0, 6220.0)],
        fitlines=["CIV 1548", "CIV 1550"],
        ncomp=ncomp,
        specres=[8.0],
        Nrange=[12.0, 14.5],
        brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )


def build_jobs(mode="full"):
    jobs = []
    if mode == "anchor544":
        # Ladder re-anchor: the 544-rung limit
        # was measured with the round-3 kernel; re-pool it with the
        # current (windowed, round-4/5) kernel on four FRESH seeds --
        # independent of the bench's headline seeds 43/44 so the gate is
        # not judged against its own draws.
        for seed in (51, 52, 53, 54):
            jobs.append(("anchor544", (8, 11), 544, 100, seed))
        return jobs
    if mode == "recal":
        # Round-5 rung recalibration on FRESH seeds after the anchor544
        # runs exposed that the round-3 544 'pool' was two seeds (43/44)
        # counted twice (scheduler variants), correlated with the bench's
        # own merged seeds.  Pooled per-rung means suggest a decaying
        # high bias at 272; this resolves the 272-vs-544 doubling shift
        # at sem ~0.4-0.5 per rung.
        for seed in range(55, 63):
            jobs.append(("recal272", (8, 11), 272, 100, seed))
        for seed in range(55, 59):
            jobs.append(("recal544", (8, 11), 544, 100, seed))
        for seed in (55, 56):
            jobs.append(("recal1088", (8, 11), 1088, 100, seed))
        return jobs
    if mode == "fixedk544":
        # Independent cross-check of the recalibrated evidence: the exact
        # decomposition Z_trans = logsumexp(Z8, Z9, Z10) - log 3 from
        # fixed-ncomp fits AT THE CONVERGED RUNG on fresh seeds.  (The
        # round-3 decomposition ran 272 repeats on seeds 43/44 -- both
        # defects of the old limit.)
        for k in (8, 9, 10):
            for seed in (63, 64):
                jobs.append((f"fixedk544_{k}", (k, k), 544, 100, seed))
        return jobs
    # (tag, ncomp, num_repeats, num_delete, seed)
    for nr in (68, 136, 272, 544):
        for seed in (43, 44):
            jobs.append(("ladder", (8, 11), nr, 100, seed))
    for seed in (43, 44):
        jobs.append(("b50", (8, 11), 272, 50, seed))
    for k in (8, 9, 10):
        for seed in (43, 44):
            jobs.append((f"fixed{k}", (k, k), 272, 100, seed))
    # Round-3 additions: the 1088 rung that closes the doubling criterion
    # (see the pooled-rung analysis in bench.py's LADDER_LIMIT note), and
    # the async-scheduler re-validation points (tags match the recorded
    # rows in flagship_study_r03.jsonl).
    for seed in (43, 44):
        jobs.append(("ladder1088", (8, 11), 1088, 100, seed))
    for nr in (544, 272):
        for seed in (43, 44):
            jobs.append(("async_sched", (8, 11), nr, 100, seed))
    return jobs


def main(out_path, mode="full"):
    import jax

    from mcalf_tpu.models import make_jax_forward
    from mcalf_tpu.sampler import NSConfig, insertion_rank_test, nested_sample

    jobs = build_jobs(mode)

    models = {}
    for tag, ncomp, nr, nd, seed in jobs:
        if ncomp not in models:
            m = make_model(ncomp)
            models[ncomp] = (m, make_jax_forward(m))
        model, fwd = models[ncomp]
        cfg = NSConfig(
            ndim=model.ndim,
            nlive=200,
            num_repeats=nr,
            num_delete=nd,
            max_samples=60000,
            precision_criterion=1e-3,
            canon_layout=model.canon_layout(),
        )
        t0 = time.perf_counter()
        res = nested_sample(fwd.loglike_cube, jax.random.PRNGKey(seed), cfg)
        jax.block_until_ready(res.logz)
        dt = time.perf_counter() - t0
        d = insertion_rank_test(res, cfg)
        rec = {
            "tag": tag,
            "ncomp": list(ncomp),
            "ndim": model.ndim,
            "num_repeats": nr,
            "num_delete": nd,
            "seed": seed,
            "logz": round(float(res.logz), 3),
            "logzerr": round(float(res.logzerr), 3),
            "h": round(float(res.h), 2),
            "n_like": int(res.n_like),
            "n_dead": int(res.n_dead),
            "rank_p": round(d.p_value, 5),
            "rank_p_blocks": round(d.p_value_blocks, 5),
            "converged": int(res.termination_reason) == 0,
            "wall_s": round(dt, 1),
        }
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/flagship_study.jsonl"
    mode = sys.argv[2] if len(sys.argv) > 2 else "full"
    main(out, mode)
