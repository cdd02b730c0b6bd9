"""Fit orchestration: config dict -> model -> sampler -> chain files.

This is the engine behind the CLI (the reference spreads it across the
solver branches of /root/reference/mcalf/cli.py:71-329).  Every solver name
the reference accepts ('polychord', 'dypolychord', 'multinest', 'dynesty',
'jaxns') runs on the SAME native on-device nested sampler here -- the name
selects which settings section tunes it, so existing config files work
unchanged.  The native section ``[ns_settings]`` exposes the sampler
directly.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from mcalf_tpu.atomic import load_atomfile
from mcalf_tpu.io.chains import write_equal_weights, write_stats
from mcalf_tpu.models import AbsorptionModel, make_jax_forward
from mcalf_tpu.sampler import (
    NSConfig,
    NSResults,
    equal_weights_matrix,
    nested_sample,
    resample_equal,
)
from mcalf_tpu.utils.checkpoint import (
    latest_checkpoint,
    load_state,
    problem_fingerprint,
    prune_checkpoints,
    save_state,
)
from mcalf_tpu.utils.profiling import phase_timer

KNOWN_SOLVERS = (
    "polychord",
    "dypolychord",
    "multinest",
    "dynesty",
    "jaxns",
    "ns",
    "native",
    "tpu-ns",
)


def _as_bool(v, default=False):
    """Robust settings-boolean: config values arrive as strings, and
    ``bool("false")`` is True (the reference has exactly this bug on the
    jaxns ``difficult_model`` key, cli.py:267 -- fixed here per the
    SURVEY 5.6 policy)."""
    if isinstance(v, bool):
        return v
    if v is None:
        return default
    return str(v).strip().lower() in ("true", "1", "yes")


#: Recognized keys per settings section.  Everything the reference honors
#: is either mapped onto the native sampler or accepted as a documented
#: no-op (PolyChord file-output toggles; see MIGRATION.md).  Any OTHER key
#: draws a warning -- the reference silently ignores typos
#: (``num_repeat``), which degrades fits with no trace.
_KNOWN_SETTINGS = {
    "pc_settings": {
        "nlive", "num_repeats", "precision_criterion", "do_clustering",
        "feedback", "equals", "read_resume", "write_resume", "write_live",
        "write_dead", "write_prior", "posteriors", "cluster_posteriors",
        "dynamic_goal",
    },
    "mn_settings": {"nlive", "samplingeff", "evidence_tolerance"},
    "jaxns_settings": {"max_samples", "num_live_points", "difficult_model"},
    "ns_settings": {
        "nlive", "num_repeats", "num_delete", "precision_criterion",
        "max_samples", "difficult_model", "max_clusters", "dynamic",
        "auto_repeats", "bracket", "stepout_w", "stepout_budget",
        "boost_start_mass", "boost_nlive", "boost_num_repeats",
        "boost_max_samples",
    },
}

_warned_settings_keys = set()


def _warn_unknown_settings(configpars) -> None:
    """Warn (once per process per key) about unrecognized settings keys in
    any ``[*_settings]`` section."""
    for section, known in _KNOWN_SETTINGS.items():
        for key in configpars.get(section, {}) or {}:
            if key not in known and (section, key) not in _warned_settings_keys:
                _warned_settings_keys.add((section, key))
                print(
                    f"WARNING: unrecognized key {key!r} in [{section}] is "
                    f"ignored (known keys: {', '.join(sorted(known))})."
                )


class SolverPlan(NamedTuple):
    """How a (solver, settings) combination maps onto the native sampler."""

    cfg: "NSConfig"
    #: equal-weight resample size (0 -> number of valid posterior samples)
    resample_S: int
    #: run the two-pass posterior-boost sampler (sampler/dynamic.py)
    dynamic: bool
    #: boost-pass NSConfig override (None -> same as cfg)
    boost_config: Optional["NSConfig"] = None
    #: posterior-mass threshold seeding the boost pass (dynamic.py)
    boost_start_mass: float = 0.01
    #: PolyChord resume semantics (reference cli.py:97-98): resume from /
    #: write sampler-state checkpoints under ``<chain base>_resume/``
    read_resume: bool = False
    write_resume: bool = False
    #: write a PolyChord/anesthetic-style ``_dead-birth.txt`` file
    write_dead: bool = False


def build_model(configpars: Dict[str, Any], debug: bool = False) -> AbsorptionModel:
    """Instantiate the fit model from a run-params dict (the reference's
    ``als_fitter(...)`` construction, cli.py:73-78)."""
    if configpars.get("atomfile"):
        load_atomfile(configpars["atomfile"])
    return AbsorptionModel.from_file(
        configpars["specfile"],
        fitrange=configpars["wavefit"],
        fitlines=configpars["linelist"],
        ncomp=configpars["ncomp"],
        nfill=configpars["nfill"],
        coldef=configpars["coldef"],
        contval=configpars["contval"],
        specres=configpars["specres"],
        Nrange=configpars["Nrange"],
        brange=configpars["brange"],
        zrange=configpars["zrange"],
        Nrangefill=configpars["Nrangefill"],
        brangefill=configpars["brangefill"],
        wrangefill=configpars["wrangefill"],
        Gpriors=configpars.get("gpriors"),
        Asymmlike=configpars["asymmlike"],
        debug=debug,
    )


def solver_nsconfig(configpars: Dict[str, Any], ndim: int) -> SolverPlan:
    """Map a solver name + its settings section onto the native sampler.

    Returns a :class:`SolverPlan`.  ``dynamic`` selects the two-pass
    posterior-boost sampler (sampler/dynamic.py): on by default for
    solver=dypolychord (its reference role, cli.py:122-158) AND
    solver=dynesty (the reference's dynesty is a DynamicNestedSampler,
    cli.py:196), or forced either way with ``[ns_settings] dynamic``.
    Defaults per solver mirror the reference's defaults for that backend:
    * polychord/dypolychord: nlive=100, precision 1e-3 (cli.py:91-93).
      num_repeats, when not set in [pc_settings]/[ns_settings], uses the
      CALIBRATED default (12*ndim, NSConfig.resolved) rather than
      PolyChord's 5*ndim: PolyChord's figure is tuned to ITS slice
      kernel, and ours measurably under-mixes there (~-2 nats on the
      1-comp CIV fit at 5*ndim vs the quadrature anchor) -- replicating
      it would replicate a bias, the same policy as the SURVEY 5.6
      config bugs we deliberately fix.  The asynchronous pass scheduler
      makes 12*ndim cost about what 5*ndim used to.
      ``read_resume``/``write_resume`` (reference defaults True when the
      section exists, cli.py:97-98) map onto the sampler-state checkpoint
      machinery; ``dynamic_goal`` (the dyPolyChord knob, cli.py:135-156)
      maps onto ``boost_start_mass = 0.01 * goal`` (goal=1 reproduces the
      posterior-focused default; goal=0 reruns from the prior, the
      evidence-focused limit).  The remaining PolyChord file-output
      toggles (feedback, equals, write_live/prior, posteriors,
      cluster_posteriors) are accepted no-ops -- our chain files are
      always written -- except ``write_dead``, which emits an
      anesthetic-compatible ``_dead-birth.txt``.
    * multinest: nlive=1000, evidence_tolerance=0.1 (cli.py:170-182);
      ``samplingeff`` is accepted (rejection-efficiency knob with no slice
      analogue).
    * dynesty: nlive=500 (dynesty's default), dynamic=True
    * jaxns: nlive=500, max_samples=1e5, difficult_model=False
      (cli.py:259)
    Unknown keys in any settings section draw a warning
    (:func:`_warn_unknown_settings`).
    """
    solver = configpars.get("solver", "polychord")
    if solver not in KNOWN_SOLVERS:
        raise ValueError(
            f"Requested solver {solver!r} not implemented; known: {KNOWN_SOLVERS}"
        )
    _warn_unknown_settings(configpars)

    nlive, num_repeats, precision = 100, 0, 1e-3
    max_samples, difficult = 20000, False
    num_delete = 0
    max_clusters = 8  # PolyChord default do_clustering=True (cli.py:95)
    read_resume = write_resume = write_dead = False
    boost_start_mass = 0.01

    if solver in ("polychord", "dypolychord"):
        s = configpars.get("pc_settings", {})
        nlive = int(s.get("nlive", 100))
        num_repeats = int(s.get("num_repeats", 0))  # 0 -> calibrated 12*ndim
        precision = float(s.get("precision_criterion", 1e-3))
        if not _as_bool(s.get("do_clustering", True), True):
            max_clusters = 1
        if s:
            # Reference defaults these True whenever [pc_settings] exists
            # (cli.py:97-99); an absent section keeps them off.
            read_resume = _as_bool(s.get("read_resume", True), True)
            write_resume = _as_bool(s.get("write_resume", True), True)
            write_dead = _as_bool(s.get("write_dead", True), True)
        if "dynamic_goal" in s:
            boost_start_mass = 0.01 * float(s["dynamic_goal"])
    elif solver == "multinest":
        s = configpars.get("mn_settings", {})
        nlive = int(s.get("nlive", 1000))
        precision = float(s.get("evidence_tolerance", 0.1))
    elif solver == "dynesty":
        nlive = 500
    elif solver == "jaxns":
        s = configpars.get("jaxns_settings", {})
        max_samples = int(float(s.get("max_samples", 1e5)))
        nlive = int(s.get("num_live_points", 500))
        difficult = _as_bool(s.get("difficult_model", False))

    # Native overrides apply on top for any solver.
    s = configpars.get("ns_settings", {})
    nlive = int(s.get("nlive", nlive))
    num_repeats = int(s.get("num_repeats", num_repeats))
    num_delete = int(s.get("num_delete", num_delete))
    precision = float(s.get("precision_criterion", precision))
    max_samples = int(float(s.get("max_samples", max_samples)))
    difficult = _as_bool(s.get("difficult_model", difficult))
    max_clusters = int(s.get("max_clusters", max_clusters))
    bracket = str(s.get("bracket", "chord"))
    stepout_w = float(s.get("stepout_w", 2.0))
    stepout_budget = int(s.get("stepout_budget", 16))
    dynamic = _as_bool(
        s.get("dynamic", solver in ("dypolychord", "dynesty")), False
    )
    boost_start_mass = float(s.get("boost_start_mass", boost_start_mass))

    cfg = NSConfig(
        ndim=ndim,
        nlive=nlive,
        num_delete=num_delete,
        num_repeats=num_repeats,
        precision_criterion=precision,
        max_samples=max_samples,
        difficult_model=difficult,
        max_clusters=max_clusters,
        bracket=bracket,
        stepout_w=stepout_w,
        stepout_budget=stepout_budget,
    )
    # Boost-pass overrides ([ns_settings] boost_*): tune the posterior-boost
    # run independently of the base run (dyPolyChord's dynamic allocation
    # knobs, reference cli.py:151-156, as explicit settings).
    boost_config = None
    boost_keys = ("boost_nlive", "boost_num_repeats", "boost_max_samples")
    if any(k in s for k in boost_keys):
        import dataclasses

        boost_config = dataclasses.replace(
            cfg,
            nlive=int(s.get("boost_nlive", nlive)),
            num_repeats=int(s.get("boost_num_repeats", num_repeats)),
            max_samples=int(float(s.get("boost_max_samples", max_samples))),
        )
    resample_S = max_samples if solver == "jaxns" else 0  # 0 -> use n_dead
    return SolverPlan(
        cfg=cfg,
        resample_S=resample_S,
        dynamic=dynamic,
        boost_config=boost_config,
        boost_start_mass=boost_start_mass,
        read_resume=read_resume,
        write_resume=write_resume,
        write_dead=write_dead,
    )


def transdim_counts_as_difficult(cfg: "NSConfig", model) -> bool:
    """Should an unset ``num_repeats`` resolve to the difficult (24*ndim)
    default because the model is trans-dimensional?

    Trans-dimensional fits mix slower than the 1-comp anchor the 12*ndim
    default was calibrated on: the round-5 fresh-seed recalibration
    (tools/flagship_study_r05_anchor.jsonl) measured a -1.66 +/- 0.66 nat
    evidence bias at 8*ndim repeats on the flagship, converged at
    16*ndim -- so an unset num_repeats on a variable-ncomp model gets the
    same doubling jaxns' ``difficult_model`` applies (reference
    cli.py:266-267 exposes the flag; this makes it the trans-dimensional
    default rather than an opt-in)."""
    return (
        cfg.num_repeats == 0
        and not cfg.difficult_model
        and model.ncomp[0] != model.ncomp[1]
    )


def chain_basename(configpars: Dict[str, Any]) -> str:
    """``chaindir + chainfmt.format(nfill)`` (reference cli.py:293,324)."""
    return os.path.join(
        configpars["chaindir"], configpars["chainfmt"].format(configpars["nfill"])
    )


def report_device() -> None:
    """Say which platform and device kind the fit runs on: JAX falls back
    to the CPU without a word when it finds no accelerator."""
    import jax

    devs = jax.devices()
    print(
        f"Fitting on {devs[0].platform} ({devs[0].device_kind}), "
        f"{len(devs)} device(s)"
    )


def fit_config(
    configpars: Dict[str, Any], model: AbsorptionModel
) -> Tuple[SolverPlan, "NSConfig"]:
    """The solver plan and sampler configuration :func:`run_fit` uses for
    ``model``: the solver mapping (:func:`solver_nsconfig`), the
    trans-dimensional repeats default and the label-symmetry gauge."""
    plan = solver_nsconfig(configpars, model.ndim)
    cfg = plan.cfg
    if cfg.num_repeats == 0:
        if transdim_counts_as_difficult(cfg, model):
            import dataclasses

            cfg = dataclasses.replace(cfg, difficult_model=True)
            if plan.boost_config is not None and plan.boost_config.num_repeats == 0:
                plan = plan._replace(
                    boost_config=dataclasses.replace(
                        plan.boost_config, difficult_model=True
                    )
                )
        # The calibrated default differs from PolyChord's (see
        # solver_nsconfig); say so once per fit so the cost change at high
        # ndim is never silent (MIGRATION.md documents the calibration).
        r = cfg.resolved()
        print(
            f"num_repeats unset -> calibrated default {r.num_repeats} "
            f"(= {'24' if cfg.difficult_model else '12'}*ndim at ndim="
            f"{model.ndim}"
            + (", trans-dimensional model counts as difficult"
               if cfg.difficult_model else "")
            + "); set [ns_settings] num_repeats to override."
        )
    layout = model.canon_layout()
    if layout is not None:
        # Label-symmetry gauge fixing (see NSConfig.canon_layout): collapses
        # the ncompmax! permutation modes so the slice kernel mixes the
        # actual posterior geometry.
        import dataclasses

        cfg = dataclasses.replace(cfg, canon_layout=layout)
    return plan, cfg


def run_fit(
    configpars: Dict[str, Any],
    debug: bool = False,
    model: Optional[AbsorptionModel] = None,
) -> Tuple[NSResults, str]:
    """Run the fit and write `.stats` + `_equal_weights.txt`.

    Returns (NSResults, chain basename)."""
    import jax

    specfiles = configpars.get("specfiles") or []
    if len(specfiles) > 1 and model is None:
        return _run_spectrum_fleet(configpars, debug=debug)

    if configpars.get("ncomp_grid"):
        return _run_ncomp_grid(configpars, debug=debug)

    device = str(configpars.get("device", "default")).lower()
    if device == "cpu":
        # Force the fit onto CPU in-process (reference cli.py:215-216).  Must
        # run before the first backend touch; if a backend is already live
        # (e.g. an earlier fit in this process) the platform cannot change.
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            print("WARNING: device=cpu requested but a JAX backend is already "
                  "initialized; continuing on the existing platform.")
    report_device()

    if model is None:
        model = build_model(configpars, debug=debug)
    fwd = make_jax_forward(model, gpriors=model.gpriors is not None)
    plan, cfg = fit_config(configpars, model)
    resample_S, dynamic = plan.resample_S, plan.dynamic

    if debug:
        print(
            f"[DEBUG]: native NS with nlive={cfg.nlive}, "
            f"num_repeats={cfg.resolved().num_repeats}, "
            f"num_delete={cfg.resolved().num_delete}, "
            f"max_samples={cfg.max_samples}, "
            f"precision={cfg.precision_criterion}, ndim={model.ndim}, "
            f"dynamic={dynamic}"
        )

    seeds_list = configpars.get("seeds")
    if seeds_list:
        if dynamic:
            raise ValueError(
                "[run] seeds (seed-ensemble) and dynamic sampling cannot be "
                "combined; drop one of the two."
            )
        if configpars.get("checkpoint"):
            print(
                "WARNING: [run] checkpoint is not supported with [run] "
                "seeds; the ensemble runs without checkpoints."
            )
        return _run_seed_ensemble(
            configpars, model, fwd, cfg, seeds_list, resample_S, debug=debug
        )

    seed = int(configpars.get("seed", 43))
    ckpt_dir = configpars.get("checkpoint")
    # An explicit [run] checkpoint dir both reads and writes.  Without one,
    # the PolyChord resume keys (reference cli.py:97-98) drive the same
    # machinery under <chain base>_resume/: write_resume saves rolling
    # sampler-state checkpoints, read_resume resumes from them.
    ckpt_read = ckpt_write = ckpt_dir is not None
    ckpt_implicit = False
    if ckpt_dir is None and (plan.read_resume or plan.write_resume):
        ckpt_dir = chain_basename(configpars) + "_resume"
        ckpt_read, ckpt_write = plan.read_resume, plan.write_resume
        # read_resume defaults ON whenever [pc_settings] exists (reference
        # cli.py:97-98), so stale resume files from an EDITED config must
        # not abort the run -- warn and refit instead.  The explicit
        # [run] checkpoint surface keeps the hard fingerprint refusal.
        ckpt_implicit = True
    showprogress = bool(configpars.get("showprogress", False))
    # [ns_settings] auto_repeats: run the repeats LADDER (sampler/repeats.py)
    # instead of a single fit -- double num_repeats until one doubling moves
    # the evidence by less than its combined uncertainty with green rank
    # tests, then report the final rung's 2 seeds birth-merged.  The
    # automated form of the flagship convergence methodology
    # (tools/flagship_study.py).
    auto_repeats = _as_bool(
        configpars.get("ns_settings", {}).get("auto_repeats", False)
    )
    if auto_repeats and dynamic:
        raise ValueError(
            "[ns_settings] auto_repeats and dynamic sampling cannot be "
            "combined (set dynamic = false, or drop auto_repeats)."
        )
    if auto_repeats and ckpt_dir:
        print(
            "WARNING: checkpoints/resume are not supported with "
            "auto_repeats; the ladder runs without them."
        )
        ckpt_dir = None
        ckpt_read = ckpt_write = False

    t0 = datetime.datetime.now()
    with phase_timer("nested_sampling"):
        # Chunked stepping is always on (nested_sample auto-tunes the chunk
        # size and is bit-identical to an uninterrupted run); checkpoints and
        # progress hang off the per-chunk callback.
        state = None
        boost_state = None
        fp = problem_fingerprint(model, cfg, seed) if ckpt_dir else None
        def _load_resume(path, what):
            # The fingerprint check refuses checkpoints from a different
            # problem / sampler config / seed (same-shape states would
            # otherwise resume silently into a wrong run).  On the IMPLICIT
            # pc-resume surface a mismatch means the user edited the
            # config/data since the stale files were written: warn and
            # refit fresh rather than aborting (the explicit [run]
            # checkpoint surface keeps the hard refusal).
            print(f"Resuming {what}from checkpoint {path}")
            try:
                return load_state(path, fingerprint=fp)
            except ValueError:
                if not ckpt_implicit:
                    raise
                print(
                    f"WARNING: stale resume files in {ckpt_dir} do not "
                    "match this problem/config/seed (config edited since "
                    "they were written?); starting a fresh fit.  Delete "
                    "the directory or set [pc_settings] read_resume = "
                    "False to silence this."
                )
                return None

        if ckpt_read:
            prev = latest_checkpoint(ckpt_dir)
            if prev is not None:
                state = _load_resume(prev, "")
            # a stale (mismatched) base state means the boost files are
            # equally stale -- skip them and refit fresh
            if dynamic and (prev is None or state is not None):
                prevb = latest_checkpoint(ckpt_dir, prefix="ns_boost")
                if prevb is not None:
                    boost_state = _load_resume(prevb, "boost pass ")

        def make_on_chunk(prefix, tag=""):
            def on_chunk(s):
                if showprogress:
                    print(
                        f"  {tag}step {int(s.step):5d}  n_dead={int(s.n_dead):6d}"
                        f"  logZ={float(s.logz):.3f}  logX={float(s.logx):.2f}"
                    )
                if ckpt_write:
                    save_state(
                        os.path.join(
                            ckpt_dir, f"{prefix}_{int(s.step):06d}.npz"
                        ),
                        s,
                        fingerprint=fp,
                    )
                    prune_checkpoints(ckpt_dir, keep=3, prefix=prefix)

            return on_chunk

        want_cb = bool(ckpt_write or showprogress)
        if dynamic:
            # Two-pass posterior-boost sampling (sampler/dynamic.py) -- the
            # dyPolyChord analogue.  Both passes checkpoint and report
            # through the same chunked machinery (base under the ns_state
            # prefix, boost under ns_boost); a kill mid-boost resumes past
            # the (terminal) base checkpoint into the boost pass.
            from mcalf_tpu.sampler import dynamic_sample

            dyn = dynamic_sample(
                fwd.loglike_cube,
                jax.random.PRNGKey(seed),
                cfg,
                boost_config=plan.boost_config,
                boost_start_mass=plan.boost_start_mass,
                base_state=state,
                boost_state=boost_state,
                on_chunk_base=make_on_chunk("ns_state") if want_cb else None,
                on_chunk_boost=(
                    make_on_chunk("ns_boost", tag="boost ") if want_cb else None
                ),
            )
            res, post = dyn.base, dyn.merged
            logz, logzerr = dyn.merged.logz, dyn.merged.logzerr
            unconverged = any(
                int(r.termination_reason) != 0 for r in (dyn.base, dyn.boost)
            )
            if debug:
                from mcalf_tpu.sampler import posterior_ess

                print(
                    f"[DEBUG]: dynamic boost above lnL={dyn.l_init:.3f}; "
                    f"posterior ESS {posterior_ess(dyn.base.log_posterior_weights):.0f}"
                    f" -> {posterior_ess(dyn.merged.log_posterior_weights):.0f}"
                )
        elif auto_repeats:
            from mcalf_tpu.sampler import converged_sample

            conv = converged_sample(
                fwd.loglike_cube,
                jax.random.PRNGKey(seed),
                cfg,
                seeds=2,
                verbose=debug or showprogress,
            )
            res = conv.results[0]
            post = conv.merged
            logz, logzerr = conv.merged.logz, conv.merged.logzerr
            unconverged = any(
                int(r.termination_reason) != 0 for r in conv.results
            )
            rungs = [r.num_repeats for r in conv.ladder]
            if conv.converged:
                print(
                    f"auto_repeats: evidence converged at num_repeats="
                    f"{conv.num_repeats} (ladder {rungs})"
                )
            else:
                print(
                    "WARNING: auto_repeats ladder budget exhausted at "
                    f"num_repeats={conv.num_repeats} (ladder {rungs}) "
                    "without meeting the doubling criterion; treat the "
                    "evidence as a lower-confidence estimate or raise "
                    "max_doublings/num_repeats."
                )
        else:
            res = nested_sample(
                fwd.loglike_cube,
                jax.random.PRNGKey(seed),
                cfg,
                state=state,
                on_chunk=make_on_chunk("ns_state") if want_cb else None,
            )
            jax.block_until_ready(res.logz)
            post = res
            logz, logzerr = float(res.logz), float(res.logzerr)
            unconverged = int(res.termination_reason) != 0
    t1 = datetime.datetime.now()
    print("Execution time {}".format(t1 - t0))

    if unconverged:
        print(
            "WARNING: sampler hit max_samples before the evidence converged; "
            "consider raising max_samples."
        )

    # Insertion-rank health check -- ALWAYS on, not just under --debug: an
    # under-decorrelated run completes silently with a plausible-looking but
    # biased evidence, and the rank test (Fowlie et al. 2020) is the cheap
    # quantitative tripwire.  The verdict goes to stdout AND into the .stats
    # file as comment lines (format-compatible; see io/chains.write_stats).
    from mcalf_tpu.sampler import insertion_rank_test

    runs_to_check = [("", res)]
    if dynamic:
        runs_to_check.append(("boost ", dyn.boost))
    elif auto_repeats:
        # Every ladder seed feeds the merged evidence, so every one gets a
        # recorded verdict (not just the first).
        runs_to_check = [
            (f"seed{i} ", r) for i, r in enumerate(conv.results)
        ]
    # Run provenance as comment lines: whether the evidence converged and
    # what the first run cost, in likelihood evaluations.
    stats_extra = [
        f"termination = {'max_samples' if unconverged else 'converged'}",
        f"n_like = {int(res.n_like)}",
    ]
    if auto_repeats:
        stats_extra.append(
            f"auto_repeats ladder converged={conv.converged} "
            f"(rungs {[r.num_repeats for r in conv.ladder]}, "
            f"final num_repeats={conv.num_repeats})"
            + ("" if conv.converged else "  ** BUDGET EXHAUSTED **")
        )
    for tag, r in runs_to_check:
        diag = insertion_rank_test(r, cfg)
        line = (
            f"insertion-rank KS p = {diag.p_value:.4f} "
            f"(blocks {diag.p_value_blocks:.4f}, n={diag.n})"
        )
        if debug:
            print(f"[DEBUG]: {tag}{line}")
        if diag.p_value < 0.01:
            warn = (
                f"WARNING: {tag}insertion-rank test FAILED (p = "
                f"{diag.p_value:.4f} < 0.01): replacements are "
                "under-decorrelated and the evidence may be biased; raise "
                "num_repeats (ns_settings) and re-run."
            )
            print(warn)
            stats_extra.append(tag + line + "  ** FAILED (p < 0.01) **")
        else:
            stats_extra.append(tag + line)

    os.makedirs(configpars["chaindir"], exist_ok=True)
    base = chain_basename(configpars)
    write_stats(base + ".stats", float(logz), float(logzerr), stats_extra)
    if plan.write_dead:
        # Dynamic solvers merge base+boost into .stats/_equal_weights, so
        # the dead-birth file must carry BOTH passes too -- anesthetic
        # reconstructs the run from (logL, birth-logL) pairs, and a
        # base-only file would re-analyze to a different evidence than the
        # shipped outputs.  Concatenated dead points with per-point birth
        # contours are exactly how a dynamic run is represented.
        dead_runs = (res, dyn.boost) if dynamic else (res,)
        _write_dead_birth(base + "_dead-birth.txt", fwd, *dead_runs)

    if debug and cfg.max_clusters > 1:
        # Per-mode posterior readout (the MultiNest multimodal-summary
        # role, reference cli.py:179-182): mass fraction + mean per mode.
        from mcalf_tpu.sampler import posterior_cluster_report

        rep = posterior_cluster_report(post, max_clusters=cfg.max_clusters)
        if rep.k > 1:
            print(f"[DEBUG]: posterior has {rep.k} modes:")
            for i in range(rep.k):
                print(
                    f"[DEBUG]:   mode {i}: mass {rep.mass[i]:.3f}  "
                    f"mean(u) {np.round(rep.mean_u[i], 3)}"
                )

    if debug:
        # Sampler-diagnostics figure, the reference's jaxns --debug analogue
        # (cli.py:288-289) -- the quantitative rank verdict is printed above.
        from mcalf_tpu.plotting import plot_diagnostics

        png = os.path.join(
            configpars.get("plotdir", configpars["chaindir"]),
            configpars["chainfmt"].format(configpars["nfill"])
            + "_diagnostics.png",
        )
        plot_diagnostics(res, cfg, png)

    S = resample_S if resample_S > 0 else int(
        np.isfinite(np.asarray(post.log_posterior_weights)).sum()
    )
    su, logl = resample_equal(jax.random.PRNGKey(42), post, S)
    params = np.asarray(fwd.cube_to_params(su), np.float64)
    matrix = equal_weights_matrix(params, np.asarray(logl))
    write_equal_weights(base + "_equal_weights.txt", matrix)
    print(f"Saved results to {base}_equal_weights.txt")
    return res, base


def _write_dead_birth(path, fwd, *runs):
    """PolyChord-format ``_dead-birth.txt`` (the reference's ``write_dead``
    passthrough output, cli.py:100): one row per dead point -- physical
    parameters, logL, birth-contour logL -- the file anesthetic's
    ``read_polychord`` consumes, so downstream nested-sampling tooling
    works on our chains unchanged.  Prior-born points get PolyChord's
    -1e30 birth sentinel instead of -inf.  Several runs (a dynamic
    base+boost pair) concatenate: per-point birth contours are the
    canonical representation of a merged/dynamic run."""
    rows = []
    for res in runs:
        logw = np.asarray(res.logw, np.float64)
        valid = np.isfinite(logw)
        params = np.asarray(
            fwd.cube_to_params(np.asarray(res.samples_u)[valid]), np.float64
        )
        logl = np.asarray(res.logl, np.float64)[valid]
        birth = np.asarray(res.birth_logl, np.float64)[valid]
        birth = np.where(np.isfinite(birth), birth, -1e30)
        rows.append(np.column_stack([params, logl, birth]))
    np.savetxt(path, np.concatenate(rows, axis=0))


def _write_chain_files(base, fwd, post, resample_S, extra_lines=()):
    """Write one `.stats` + `_equal_weights.txt` pair for any posterior
    carrier (NSResults or MergedRun)."""
    logz = float(np.asarray(post.logz))
    logzerr = float(np.asarray(post.logzerr))
    write_stats(base + ".stats", logz, logzerr, extra_lines)
    S = resample_S if resample_S > 0 else int(
        np.isfinite(np.asarray(post.log_posterior_weights)).sum()
    )
    import jax

    su, logl = resample_equal(jax.random.PRNGKey(42), post, S)
    params = np.asarray(fwd.cube_to_params(su), np.float64)
    write_equal_weights(
        base + "_equal_weights.txt",
        equal_weights_matrix(params, np.asarray(logl)),
    )


def _run_seed_ensemble(
    configpars, model, fwd, cfg, seeds, resample_S, debug=False
):
    """Seed-ensemble fleet fit through the config surface (``[run] seeds``).

    The same problem is fit once per seed -- sharded over the device mesh
    when the seed count divides the device count (parallel.fit_stacked),
    else sequentially with the chunked sampler -- then the members are
    birth-contour merged (sampler/merge.py) into ONE evidence with a
    sqrt(K)-smaller, simulated-weights error bar.  Per-member chain files
    get a ``_s<seed>`` suffix on the ``chainfmt.format(nfill)`` base
    (reference naming, cli.py:86,129); the merged posterior lands under the
    base name so the analysis/plot phase works unchanged.  This is SURVEY
    section 2.3's "(spectrum x seed) fits across chips" as a user surface.
    """
    import jax

    from mcalf_tpu.sampler import (
        insertion_rank_test,
        merge_results,
        nested_sample,
    )

    t0 = datetime.datetime.now()
    ndev = len(jax.devices())
    use_mesh = ndev > 1 and len(seeds) % ndev == 0
    with phase_timer("nested_sampling"):
        if use_mesh:
            import jax.numpy as jnp

            from mcalf_tpu.models.batched import stack_problems
            from mcalf_tpu.parallel.fleet import fit_stacked

            if debug:
                print(
                    f"[DEBUG]: sharding {len(seeds)} seeds over {ndev} devices"
                )
            spec, stacked = stack_problems([model] * len(seeds))
            keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
            batched = fit_stacked(spec, stacked, cfg, keys=keys)
            jax.block_until_ready(batched.logz)
            # Each device must hold its own seeds' results: a mesh that
            # quietly piles every shard onto one device would still give
            # right numbers, at 1/ndev of the speed.
            shard_devices = sorted(
                {sh.device.id for sh in batched.logz.addressable_shards}
            )
            if len(shard_devices) != ndev:
                raise RuntimeError(
                    f"seed shards landed on devices {shard_devices}, "
                    f"expected {ndev} distinct devices"
                )
            runs = [
                jax.tree.map(lambda a, i=i: a[i], batched)
                for i in range(len(seeds))
            ]
        else:
            runs = []
            for s in seeds:
                res = nested_sample(
                    fwd.loglike_cube, jax.random.PRNGKey(int(s)), cfg
                )
                jax.block_until_ready(res.logz)
                if debug:
                    print(f"[DEBUG]: seed {s}: logZ = {float(res.logz):.3f}")
                runs.append(res)
    print("Execution time {}".format(datetime.datetime.now() - t0))

    merged = merge_results(runs)
    os.makedirs(configpars["chaindir"], exist_ok=True)
    base = chain_basename(configpars)
    stats_extra = []
    unconv = False
    for s, r in zip(seeds, runs):
        diag = insertion_rank_test(r, cfg)
        line = (
            f"seed {s}: logZ = {float(r.logz):.3f} +/- "
            f"{float(r.logzerr):.3f}; insertion-rank KS p = {diag.p_value:.4f}"
        )
        if diag.p_value < 0.01:
            print(
                f"WARNING: seed {s} insertion-rank test FAILED "
                f"(p = {diag.p_value:.4f} < 0.01); raise num_repeats."
            )
            line += "  ** FAILED (p < 0.01) **"
        stats_extra.append(line)
        unconv |= int(r.termination_reason) != 0
        _write_chain_files(f"{base}_s{s}", fwd, r, resample_S)
    if unconv:
        print(
            "WARNING: at least one ensemble member hit max_samples before "
            "converging; consider raising max_samples."
        )
    spread = max(float(r.logz) for r in runs) - min(
        float(r.logz) for r in runs
    )
    stats_extra.append(
        f"merged {len(seeds)} seeds {list(seeds)} by birth contours; "
        f"seed spread = {spread:.3f}"
    )
    if use_mesh:
        stats_extra.append(f"seeds sharded over devices {shard_devices}")
    _write_chain_files(base, fwd, merged, resample_S, stats_extra)
    print(f"Saved merged ensemble results to {base}_equal_weights.txt")
    return merged, base


def _run_ncomp_grid(configpars, debug=False):
    """Fixed-k model grid through the config surface (``[run] ncomp_grid``).

    One fixed-ncomp fit per k in the configured [components] ncomp range
    (each through the full run_fit flow under a ``_k<k>`` chain suffix),
    then a Bayes-factor table: per-k logZ, Delta logZ vs the best k, and
    the uniform-prior trans-dimensional evidence logsumexp(logZ_k) - log K.
    The best-k chain files are copied to the base name so the analysis /
    plot phase picks the selected model (the reference workflow's
    evidence-based ncomp selection, cli.py:367-383, as one command)."""
    import shutil

    lo, hi = int(configpars["ncomp"][0]), int(configpars["ncomp"][1])
    ks = list(range(lo, hi + 1))
    base = chain_basename(configpars)
    rows = []
    for k in ks:
        sub = dict(
            configpars,
            ncomp=np.array([k, k]),
            ncomp_grid=False,
            chainfmt=configpars["chainfmt"] + f"_k{k}",
        )
        print(f"--- ncomp grid: fitting fixed k = {k} ---")
        res, kbase = run_fit(sub, debug=debug)
        rows.append(
            (k, float(np.asarray(res.logz)), float(np.asarray(res.logzerr)),
             kbase, res)
        )

    logzs = np.array([r[1] for r in rows])
    best = int(np.argmax(logzs))
    m = logzs.max()
    logz_trans = m + np.log(np.exp(logzs - m).sum()) - np.log(len(ks))
    os.makedirs(configpars["chaindir"], exist_ok=True)
    table = base + "_ncomp_grid.txt"
    with open(table, "w") as f:
        f.write("# k  logZ  logZerr  dlogZ_vs_best\n")
        for k, lz, le, _, _res in rows:
            f.write(f"{k}  {lz:.4f}  {le:.4f}  {lz - logzs[best]:+.4f}\n")
        f.write(
            f"# best k = {rows[best][0]}; trans-dimensional evidence "
            f"(uniform k prior) = {logz_trans:.4f}\n"
        )
    print(f"ncomp grid: best k = {rows[best][0]} "
          f"(logZ = {logzs[best]:.3f}); table in {table}")
    for suffix in (".stats", "_equal_weights.txt"):
        src = rows[best][3] + suffix
        if os.path.exists(src):
            shutil.copyfile(src, base + suffix)
    # Return the best-k RESULTS (not the bare k): run_fit declares
    # Tuple[NSResults, str] and programmatic callers rely on it.  The
    # selected k is recoverable from the table / `_k<k>` chain files.
    return rows[best][4], base


def spectrum_subconfigs(configpars: Dict[str, Any]):
    """Per-spectrum sub-configs for a multi-sightline run (``specfile`` as
    a comma list / glob in the config).  Each spectrum gets a
    ``_<filestem>`` chain/plot suffix (disambiguated on collision) and,
    when checkpointing, its own checkpoint subdirectory (the problem
    fingerprint would refuse cross-spectrum resumes anyway)."""
    specfiles = configpars.get("specfiles") or [configpars["specfile"]]
    seen: Dict[str, int] = {}
    subs = []
    for sf in specfiles:
        stem = os.path.splitext(os.path.basename(sf))[0]
        if stem in seen:
            seen[stem] += 1
            stem = f"{stem}{seen[stem]}"
        else:
            seen[stem] = 0
        sub = dict(
            configpars,
            specfile=sf,
            specfiles=[sf],
            chainfmt=configpars["chainfmt"] + "_" + stem,
        )
        if configpars.get("checkpoint"):
            sub["checkpoint"] = os.path.join(configpars["checkpoint"], stem)
        subs.append(sub)
    return subs


def _run_spectrum_fleet(configpars, debug=False):
    """Multi-sightline fit through the config surface (``specfile`` list).

    Every spectrum is fit with the same settings.  When the problems stack
    (same pixel structure after red-end padding) and fill the device mesh,
    they run SHARDED via :func:`mcalf_tpu.parallel.fit_many` (SURVEY
    section 2.3 sightline sharding); otherwise each runs through the full
    single-spectrum ``run_fit`` flow sequentially (which also covers
    dynamic sampling, seed ensembles and checkpoints per spectrum).
    Returns the list of per-spectrum (results, chain basename) pairs."""
    import jax

    subs = spectrum_subconfigs(configpars)
    ndev = len(jax.devices())
    plain = not configpars.get("seeds") and not configpars.get("ncomp_grid")
    probe = solver_nsconfig(configpars, 1)
    use_mesh = (
        plain and not probe.dynamic and ndev > 1 and len(subs) % ndev == 0
    )
    if use_mesh:
        report_device()

    if use_mesh:
        try:
            from mcalf_tpu.models.batched import pad_model_to_npix
            from mcalf_tpu.parallel import fit_many
            from mcalf_tpu.sampler import insertion_rank_test

            models = [build_model(s, debug=debug) for s in subs]
            npix = max(m.npix for m in models)
            padded = [pad_model_to_npix(m, npix) for m in models]
            fleet_plan = solver_nsconfig(configpars, models[0].ndim)
            cfg, resample_S = fleet_plan.cfg, fleet_plan.resample_S
            if transdim_counts_as_difficult(cfg, models[0]):
                # Same calibrated trans-dimensional default as run_fit
                # (all spectra share the config's ncomp range); without
                # this the sharded path would silently fit at half the
                # repeats of the sequential fallback.
                import dataclasses

                cfg = dataclasses.replace(cfg, difficult_model=True)
                r = cfg.resolved()
                print(
                    f"num_repeats unset -> calibrated default "
                    f"{r.num_repeats} (= 24*ndim at ndim={models[0].ndim}, "
                    "trans-dimensional model counts as difficult); set "
                    "[ns_settings] num_repeats to override."
                )
            if debug:
                print(
                    f"[DEBUG]: sharding {len(subs)} spectra over {ndev} "
                    f"devices"
                )
            seed = int(configpars.get("seed", 43))
            t0 = datetime.datetime.now()
            with phase_timer("nested_sampling"):
                batched = fit_many(padded, cfg, seed=seed)
                jax.block_until_ready(batched.logz)
            print("Execution time {}".format(datetime.datetime.now() - t0))
            out = []
            for i, (sub, m) in enumerate(zip(subs, models)):
                r = jax.tree.map(lambda a, i=i: a[i], batched)
                fwd = make_jax_forward(m, gpriors=m.gpriors is not None)
                os.makedirs(sub["chaindir"], exist_ok=True)
                base = chain_basename(sub)
                diag = insertion_rank_test(r, cfg)
                line = (
                    f"insertion-rank KS p = {diag.p_value:.4f} "
                    f"(blocks {diag.p_value_blocks:.4f}, n={diag.n})"
                )
                if diag.p_value < 0.01:
                    print(
                        f"WARNING: {os.path.basename(sub['specfile'])} "
                        f"insertion-rank test FAILED (p = {diag.p_value:.4f}"
                        " < 0.01); raise num_repeats."
                    )
                    line += "  ** FAILED (p < 0.01) **"
                if int(r.termination_reason) != 0:
                    print(
                        f"WARNING: {os.path.basename(sub['specfile'])} hit "
                        "max_samples before the evidence converged."
                    )
                _write_chain_files(base, fwd, r, resample_S, [line])
                print(f"Saved results to {base}_equal_weights.txt")
                out.append((r, base))
            return out
        except ValueError as e:
            print(
                f"NOTE: spectra do not stack for mesh sharding ({e}); "
                "fitting sequentially."
            )

    out = []
    for sub in subs:
        print(f"--- fitting {sub['specfile']} ---")
        out.append(run_fit(sub, debug=debug))
    return out
