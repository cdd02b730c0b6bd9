"""Console entry point: ``mc-alf-tpu <config.ini> [--debug]``.

Same interface as the reference's ``mc-alf`` command
(/root/reference/mcalf/cli.py:46-54): positional config file, ``--debug``
for verbosity, ``--version``.  The fit runs on the native on-device nested
sampler regardless of the configured solver name (see
:mod:`mcalf_tpu.runner`); plotting reads the chain files back, so
``dofit``/``doplot`` can run in separate invocations exactly as in the
reference.
"""

from __future__ import annotations

import argparse
import os

from mcalf_tpu import __version__
from mcalf_tpu.config import readconfig


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mc-alf-tpu")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument(
        "--version", action="version", version=f"mc-alf-tpu {__version__}"
    )
    parser.add_argument("config")
    args = parser.parse_args(argv)

    configpars = readconfig(args.config)

    # Multi-process fleets print from rank 0 only (the reference gates its
    # output to MPI rank 0, cli.py:116-118,184-186).  is_rank0 never
    # initializes a backend, so `[run] device = cpu` still works below.
    from mcalf_tpu.utils.rank import is_rank0

    if not is_rank0():
        import sys

        sys.stdout = open(os.devnull, "w")

    print(f"MC-ALF-TPU version {__version__}")
    if args.debug:
        print("--- DEBUG mode, increased verbosity ---")

    os.makedirs(configpars["chaindir"], exist_ok=True)
    os.makedirs(configpars["plotdir"], exist_ok=True)

    # Plotting needs matplotlib (an optional extra).  Refuse before the
    # fit, not after it has run for minutes.
    if configpars["doplot"] or args.debug:
        import importlib.util

        if importlib.util.find_spec("matplotlib") is None:
            raise SystemExit(
                "mc-alf-tpu: plotting needs matplotlib, which is not "
                "installed; set [run] doplot = False (and drop --debug) or "
                "install the 'plot' extra."
            )

    # Persistent executable cache (utils/compile_cache.py resolves where:
    # JAX_COMPILATION_CACHE_DIR, else ``[run] compile_cache``, else the
    # checkout's .jax_cache/): repeat fits of the same model shape skip
    # XLA recompilation.  Must run before the first jax compile, hence
    # before the heavy imports below.
    from mcalf_tpu.utils.compile_cache import enable_compile_cache

    resolved = enable_compile_cache(configpars.get("compile_cache"))
    if args.debug:
        print(f"[DEBUG]: persistent compile cache at {resolved}")

    # Heavy imports after arg parsing so --help/--version stay fast.
    from mcalf_tpu.runner import build_model, run_fit, spectrum_subconfigs
    from mcalf_tpu.plotting import run_plot

    if len(configpars.get("specfiles") or []) > 1:
        # Multi-sightline fleet: one fit + plot per spectrum (config
        # extension; the reference fits one spectrum per config).
        if configpars["dofit"]:
            run_fit(configpars, debug=args.debug)
        if configpars["doplot"]:
            for sub in spectrum_subconfigs(configpars):
                run_plot(sub, debug=args.debug)
        return 0

    model = build_model(configpars, debug=args.debug)
    if args.debug:
        print(
            f"[DEBUG]: ndim={model.ndim}, npix={model.npix}, "
            f"velstep={model.velstep:.5f} km/s, lines={[l.name for l in model.lines]}"
        )

    if configpars["dofit"]:
        run_fit(configpars, debug=args.debug, model=model)

    if configpars["doplot"]:
        run_plot(configpars, debug=args.debug, model=model)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
