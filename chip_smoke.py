#!/usr/bin/env python3
"""Smoke test of the fitter on one NVIDIA GPU: the quickest proof that the
main path still starts, compiles and converges on the card.

    python chip_smoke.py           # one card: phases 1-5 below
    python chip_smoke.py --four    # four cards: the seed-ensemble phase only

Everything runs in ONE process, which owns the card(s); nothing is caught
and carried past, so any failed phase ends the run with a non-zero exit and
no result line.  The phases, in order, each print their own result line:

1. device     JAX must run on a GPU (never on the CPU).  Prints the device
              kind and count, and nvidia-smi's name and power limit (read
              in a child process before JAX touches the card).
2. parity     the device log-likelihood at the production batch (B = 100)
              against the float64 host model (AbsorptionModel.lnlhood) at
              the mock truth and at seeded cube points, for the flagship
              and the HI forest; then the sampler's ``run_steps`` program
              is compiled at both shapes and its memory_analysis() printed.
3. flagship   testdata/fit.cfg through the CLI (cli.main, in-process), at
              full width and to convergence, gated on termination, the
              insertion-rank test and the fresh-seed ladder limit.
4. hi_forest  testdata/hi_forest.cfg through the CLI, compared with the
              same config and seed run on the CPU (HI_CPU_* below).
5. gpu tests  the tests marked ``gpu`` (pytest, in-process).

``--four`` runs the seed ensemble of examples/ensemble_fit.cfg (seeds
43-46) through the CLI on a 4-card mesh, and the same four seeds on a
1-card mesh in the same process, and compares per-seed and merged evidence.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Outputs land under chiprun_out/smoke/.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "chiprun_out", "smoke")

#: Flagship evidence gate: the fresh-seed repeats-ladder limit and the
#: measured per-seed logZ scatter of the flagship fit (bench.py
#: LADDER_LIMIT / SEED_SCATTER_SD; tools/flagship_study_r05_anchor.jsonl).
#: They are statistics of the sampler, not timings, so they carry over to
#: any device.  A single fit must land within 3 seed-scatter sd.
FLAGSHIP_LOGZ_LIMIT = 4855.03
FLAGSHIP_SEED_SD = 1.33
FLAGSHIP_LOGZ_TOL = 3.0 * FLAGSHIP_SEED_SD
#: insertion-rank KS p below this marks an under-decorrelated run
#: (the same threshold the CLI warns at, runner.run_fit).
RANK_P_MIN = 0.01

#: The HI-forest fit on the CPU, same config and seed (43) as phase 4:
#:   JAX_PLATFORMS=cpu python -m mcalf_tpu <copy of testdata/hi_forest.cfg
#:                                          with doplot = False>
#: GPU and CPU sum in different orders, so the two runs take different
#: trajectories; they must agree within 3 x their combined logzerr.
HI_CPU_LOGZ = 924.1839599609375
HI_CPU_LOGZERR = 0.6584018468856812

#: Parity tolerance: models/jax_model.lnl_tolerance.  The float32 device
#: forward model differs from the float64 host model by at most ~3e-4 in
#: flux (F32_FLUX_EPS: the quantisation of the forward model's parameters,
#: measured at the line cores; the cube path's high-precision redshift
#: keeps it lower).  That bounds |dlnL| per point by eps sum ivar |r| +
#: eps^2 sum ivar / 2 (r the float64 residual), plus the float32 rounding
#: of the chi^2 sum.

#: the production deletion batch (NSConfig.num_delete = nlive // 2 at
#: nlive = 200)
BATCH = 100

FLAGSHIP_CFG = os.path.join(REPO, "testdata", "fit.cfg")
HI_CFG = os.path.join(REPO, "testdata", "hi_forest.cfg")
ENSEMBLE_CFG = os.path.join(REPO, "examples", "ensemble_fit.cfg")


class PhaseFailed(RuntimeError):
    """A phase's gate did not hold."""


# ---------------------------------------------------------------------------
# Helpers (importable and testable without a card)
# ---------------------------------------------------------------------------

def rewrite_config(src: str, dst: str, outdir: str) -> str:
    """Copy a fit config with ``doplot = False``, ``outdir`` set to
    ``outdir`` and ``datadir`` made absolute (relative to the repo root),
    so the copy runs from any directory.  Returns ``dst``."""
    lines = []
    with open(src) as f:
        for line in f:
            key = line.split("=", 1)[0].strip().lower() if "=" in line else ""
            if key == "doplot":
                line = "doplot = False\n"
            elif key == "outdir":
                line = f"outdir = {os.path.join(outdir, '')}\n"
            elif key == "datadir":
                d = line.split("=", 1)[1].strip()
                line = f"datadir = {os.path.join(REPO, d, '')}\n"
            lines.append(line)
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        f.writelines(lines)
    return dst


def within(a: float, b: float, tol: float) -> bool:
    return abs(float(a) - float(b)) <= tol


def combined_tol(err_a: float, err_b: float, nsigma: float = 3.0) -> float:
    return nsigma * math.hypot(float(err_a), float(err_b))


def read_stats_file(path: str) -> dict:
    """logZ, its error and the ``# key = value`` / rank / seed lines of a
    CLI ``.stats`` file."""
    out = {"seeds": {}}
    with open(path) as f:
        for line in f:
            if line.startswith("log(Z)"):
                items = line.split()
                out["logz"], out["logzerr"] = float(items[2]), float(items[4])
                continue
            m = re.match(r"# (termination|n_like) = (\S+)", line)
            if m:
                out[m.group(1)] = m.group(2)
            m = re.match(r"# insertion-rank KS p = ([0-9.]+)", line)
            if m:
                out["rank_p"] = float(m.group(1))
            m = re.match(
                r"# seed (\d+): logZ = (\S+) \+/- (\S+); insertion-rank KS p"
                r" = ([0-9.]+)", line
            )
            if m:
                out["seeds"][int(m.group(1))] = (
                    float(m.group(2)), float(m.group(3)), float(m.group(4))
                )
            m = re.match(r"# seeds sharded over devices \[([0-9, ]*)\]", line)
            if m:
                out["shard_devices"] = [
                    int(v) for v in m.group(1).split(",") if v.strip()
                ]
    if "logz" not in out:
        raise PhaseFailed(f"no log(Z) line in {path}")
    return out


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of standard output."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, from a child process."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False,
        )
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return r.stdout.strip() or f"nvidia-smi failed: {r.stderr.strip()}"


def require_gpu(min_devices: int = 1):
    """The JAX devices, or SystemExit when JAX finds no GPU (it would fall
    back to the CPU; a smoke run there proves nothing)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU found (JAX runs on {devs[0].platform}); "
            "this smoke test runs only on an NVIDIA GPU"
        )
    if len(devs) < min_devices:
        raise SystemExit(
            f"chip_smoke: need {min_devices} GPUs, JAX sees {len(devs)}"
        )
    return devs


def say(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(min_devices: int = 1):
    smi = nvidia_smi()  # before JAX touches the card
    devs = require_gpu(min_devices)
    from mcalf_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    say(f"phase 1 device: {devs[0].platform} {devs[0].device_kind} x "
        f"{len(devs)}; compile cache {cache}")
    say(f"phase 1 nvidia-smi: {smi}")
    return devs, smi.splitlines()[0] if smi else ""


def _truth(name: str, model):
    """The mock's generative parameters as a physical parameter vector."""
    import numpy as np

    from mcalf_tpu import mocks

    p = np.asarray(0.5 * (model.bounds_lo + model.bounds_hi), np.float64)
    if name == "flagship":
        trip = list(zip(mocks.N_TRUE, mocks.Z_TRUE, mocks.B_TRUE))
    else:
        trip = list(mocks.HI_TRUTH)
    p[model.startind] = len(trip) + 0.5
    for i, t in enumerate(trip):
        p[model.startind + 1 + 3 * i: model.startind + 4 + 3 * i] = t
    if model.nfill:
        # the filler sits on the HI mock's unidentified contaminant
        p[model.endind: model.endind + 3] = [
            mocks.HI_CONTAM["N"],
            mocks.HI_CONTAM["obs_wave"] / model.linefill.wrest - 1.0,
            mocks.HI_CONTAM["b"],
        ]
    return p


def phase_parity(name: str, cfg_path: str):
    """Phase 2 for one problem; returns (model, fit plan, NSConfig)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcalf_tpu.config import readconfig
    from mcalf_tpu.models import make_jax_forward
    from mcalf_tpu.models.jax_model import lnl_tolerance
    from mcalf_tpu.runner import build_model, fit_config
    from mcalf_tpu.sampler.nested import init_state, run_steps

    cp = readconfig(rewrite_config(
        cfg_path, os.path.join(OUT, "cfg", f"{name}.cfg"),
        os.path.join(OUT, name)))
    model = build_model(cp)
    v = model.valid
    ivar = 1.0 / model.obj_noise[v] ** 2

    def host(p):
        r = model.obj[v] - model.reconstruct_spec(p)[v]
        return model.lnlhood(p), r

    # (a) production forward (same_edge convolution, as the fit runs it)
    # at the exact truth: the model is flat at the spectrum edges there,
    # so the two convolution boundaries agree.
    with jax.default_matmul_precision("highest"):
        fwd = make_jax_forward(model)
        p_true = _truth(name, model)
        ll_dev = float(fwd.loglike(jnp.asarray(p_true, jnp.float32)))
    ll_host, r = host(p_true)
    tol = float(lnl_tolerance(r, ivar, [ll_host])[0])
    ok_truth = within(ll_dev, ll_host, tol)

    # (b) one production batch of cube points: the truth's cube image and
    # seeded uniform points.  The device model uses the host's circular
    # ('wrap') convolution boundary so both sides compute the same
    # function; everything else is the production arithmetic.
    rng = np.random.default_rng(2024)
    lo, hi = model.bounds_lo, model.bounds_hi
    u = rng.uniform(0.0, 1.0, size=(BATCH, model.ndim))
    u[0] = np.clip((p_true - lo) / (hi - lo), 0.0, 1.0)
    u = u.astype(np.float32)
    with jax.default_matmul_precision("highest"):
        fwd_wrap = make_jax_forward(model, conv_mode="wrap")
        ll_dev_b = np.asarray(fwd_wrap.loglike_cube(jnp.asarray(u)), np.float64)
    p_b = lo + u.astype(np.float64) * (hi - lo)
    host_b = [host(p) for p in p_b]
    ll_host_b = np.array([h[0] for h in host_b])
    tol_b = lnl_tolerance(np.array([h[1] for h in host_b]), ivar, ll_host_b)
    dev = np.abs(ll_dev_b - ll_host_b)
    ok_batch = bool(np.all(np.isfinite(ll_dev_b)) and np.all(dev <= tol_b))
    say(
        f"phase 2 parity {name}: truth lnL device {ll_dev:.4f} host "
        f"{ll_host:.4f} (|d| {abs(ll_dev - ll_host):.4f} <= tol {tol:.3f}); "
        f"B={BATCH} cube batch max |d| {dev.max():.4f}, max |d|/tol "
        f"{np.max(dev / tol_b):.4f}: {'PASS' if ok_truth and ok_batch else 'FAIL'}"
    )
    if not (ok_truth and ok_batch):
        raise PhaseFailed(f"likelihood parity failed for {name}")

    # The sampler program the CLI fit will run, compiled at this shape.
    plan, cfg = fit_config(cp, model)
    key = jax.random.PRNGKey(0)
    st = jax.eval_shape(lambda k: init_state(fwd.loglike_cube, k, cfg), key)
    t0 = time.perf_counter()
    compiled = run_steps.lower(
        fwd.loglike_cube, st, cfg, jnp.int32(4)
    ).compile()
    say(f"phase 2 run_steps {name} (ndim={model.ndim}, npix={model.npix}, "
        f"nlive={cfg.nlive}, B={cfg.resolved().num_delete}): compiled in "
        f"{time.perf_counter() - t0:.1f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    return model, plan, cfg


def _cli_fit(name: str, cfg_path: str):
    """One fit through the CLI, in-process; returns (stats dict, wall s)."""
    from mcalf_tpu import cli
    from mcalf_tpu.config import readconfig
    from mcalf_tpu.runner import chain_basename

    path = rewrite_config(
        cfg_path, os.path.join(OUT, "cfg", f"{name}.cfg"),
        os.path.join(OUT, name))
    t0 = time.perf_counter()
    rc = cli.main([path])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise PhaseFailed(f"{name}: cli.main returned {rc}")
    stats = read_stats_file(chain_basename(readconfig(path)) + ".stats")
    return stats, wall


def phase_flagship(card: str, cfg):
    stats, wall = _cli_fit("flagship", FLAGSHIP_CFG)
    n_like = int(stats["n_like"])
    r = cfg.resolved()
    trips = (n_like - r.nlive) / r.num_delete
    gates = {
        "terminated": stats.get("termination") == "converged",
        "rank_p": stats.get("rank_p", 0.0) > RANK_P_MIN,
        "logz": within(stats["logz"], FLAGSHIP_LOGZ_LIMIT, FLAGSHIP_LOGZ_TOL),
    }
    say(
        f"phase 3 flagship [{card}]: wall {wall:.2f} s (CLI, compile "
        f"included), n_like {n_like}, slice-loop trips {trips:.0f}, "
        f"{n_like / wall:.0f} evals/s, {trips / wall:.0f} trips/s; logZ "
        f"{stats['logz']:.3f} +/- {stats['logzerr']:.3f} (gate "
        f"{FLAGSHIP_LOGZ_LIMIT} +/- {FLAGSHIP_LOGZ_TOL:.2f}), rank p "
        f"{stats.get('rank_p')}; gates {gates}"
    )
    if not all(gates.values()):
        raise PhaseFailed(f"flagship gates failed: {gates}")


def phase_hi_forest(card: str):
    stats, wall = _cli_fit("hi_forest", HI_CFG)
    tol = combined_tol(stats["logzerr"], HI_CPU_LOGZERR)
    ok = (
        within(stats["logz"], HI_CPU_LOGZ, tol)
        and stats.get("termination") == "converged"
    )
    say(
        f"phase 4 hi_forest [{card}]: wall {wall:.2f} s, n_like "
        f"{stats['n_like']}, logZ {stats['logz']:.3f} +/- "
        f"{stats['logzerr']:.3f} vs CPU {HI_CPU_LOGZ:.3f} +/- "
        f"{HI_CPU_LOGZERR:.3f} (|d| {abs(stats['logz'] - HI_CPU_LOGZ):.3f}"
        f" <= {tol:.3f}), rank p {stats.get('rank_p')}: "
        f"{'PASS' if ok else 'FAIL'}"
    )
    if not ok:
        raise PhaseFailed("HI-forest evidence disagrees with the CPU run")


def phase_gpu_tests():
    import pytest

    rc = pytest.main([
        "-q", "-m", "gpu", "-p", "no:cacheprovider", "-p", "no:xdist",
        "-p", "no:randomly", os.path.join(REPO, "tests"),
    ])
    say(f"phase 5 gpu tests: pytest exit {int(rc)}")
    if int(rc) != 0:
        raise PhaseFailed(f"gpu-marked tests failed (pytest exit {int(rc)})")


def phase_four(card: str):
    """Seed ensemble on a 4-card mesh (CLI) vs the same seeds on 1 card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mcalf_tpu.config import readconfig
    from mcalf_tpu.models.batched import stack_problems
    from mcalf_tpu.parallel.fleet import fit_stacked, make_mesh
    from mcalf_tpu.runner import build_model, fit_config
    from mcalf_tpu.sampler import merge_results

    stats4, wall4 = _cli_fit("ensemble4", ENSEMBLE_CFG)
    devs4 = stats4.get("shard_devices", [])
    if len(set(devs4)) != 4:
        raise PhaseFailed(f"4-card shards sat on devices {devs4}")
    say(f"phase four mesh4 [{card}]: wall {wall4:.2f} s, shards on devices "
        f"{devs4}, merged logZ {stats4['logz']:.3f} +/- "
        f"{stats4['logzerr']:.3f}, seeds {stats4['seeds']}")

    cp = readconfig(os.path.join(OUT, "cfg", "ensemble4.cfg"))
    model = build_model(cp)
    _, cfg = fit_config(cp, model)
    seeds = list(cp["seeds"])
    spec, stacked = stack_problems([model] * len(seeds))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    t0 = time.perf_counter()
    res1 = fit_stacked(spec, stacked, cfg, keys=keys,
                       mesh=make_mesh(jax.devices()[:1]))
    jax.block_until_ready(res1.logz)
    wall1 = time.perf_counter() - t0
    devs1 = sorted({sh.device.id for sh in res1.logz.addressable_shards})
    runs = [jax.tree.map(lambda a, i=i: a[i], res1) for i in range(len(seeds))]
    merged1 = merge_results(runs)
    lz1 = {s: (float(r.logz), float(r.logzerr)) for s, r in zip(seeds, runs)}
    say(f"phase four mesh1 [{card}]: wall {wall1:.2f} s, shards on devices "
        f"{devs1}, merged logZ {merged1.logz:.3f} +/- {merged1.logzerr:.3f}, "
        f"seeds {lz1}")
    ok = devs1 == [jax.devices()[0].id]
    for s in seeds:
        a, ea, _ = stats4["seeds"][s]
        b, eb = lz1[s]
        ok &= within(a, b, combined_tol(ea, eb))
    ok &= within(stats4["logz"], merged1.logz,
                 combined_tol(stats4["logzerr"], merged1.logzerr))
    exact = all(
        abs(stats4["seeds"][s][0] - lz1[s][0]) < 1e-3 for s in seeds
    )
    say(f"phase four compare: per-seed and merged logZ within 3 x combined "
        f"logzerr: {'PASS' if ok else 'FAIL'} (per-seed equal to 1e-3: "
        f"{exact}); speed-up 1 card -> 4 cards {wall1 / wall4:.2f}x")
    if not ok:
        raise PhaseFailed("4-card and 1-card ensembles disagree")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    unknown = [a for a in argv if a != "--four"]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown arguments {unknown}")
    os.makedirs(OUT, exist_ok=True)
    devs, card = phase_device(4 if four else 1)
    if four:
        phase_four(card)
    else:
        _, _, flag_cfg = phase_parity("flagship", FLAGSHIP_CFG)
        phase_parity("hi_forest", HI_CFG)
        phase_flagship(card, flag_cfg)
        phase_hi_forest(card)
        phase_gpu_tests()
    import jax

    devs = jax.devices()
    print(result_line(devs[0].platform, devs[0].device_kind, len(devs)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
