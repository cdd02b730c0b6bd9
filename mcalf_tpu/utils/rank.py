"""Process-rank console gating for multi-host fleets.

The reference gates its prints to MPI rank 0
(/root/reference/mcalf/cli.py:116-118,184-186) so an MPI fleet prints one
banner, not one per process.  Our distributed runtime is
``jax.distributed`` (parallel/fleet.init_distributed); these helpers
answer "should this process own console output?" WITHOUT forcing backend
initialization -- crucial because ``[run] device = cpu`` must still be able
to flip the platform after the CLI banner would have printed.
"""

from __future__ import annotations

__all__ = ["is_rank0", "rank0_print"]


def is_rank0() -> bool:
    """True when this process should own console output.

    Resolution order, never initializing a backend as a side effect:
    1. ``jax.distributed``'s global state (set by ``init_distributed`` /
       ``jax.distributed.initialize`` -- the multi-host fleet case);
    2. ``jax.process_index()`` if a backend already exists (auto-initialized
       multi-process clusters);
    3. rank 0 otherwise (single-process runs, or anything unresolvable --
       printing twice beats swallowing output on a misdetected rank).
    """
    try:
        from jax._src import distributed

        gs = distributed.global_state
        # process_id DEFAULTS to 0 before initialization (verified on the
        # installed jax), so it is only authoritative once the distributed
        # client actually exists -- gate on that, or single-process runs
        # would terminate resolution here and auto-initialized pods would
        # never reach the backend check below.
        if gs.client is not None:
            return int(gs.process_id) == 0
    except Exception:
        pass
    try:
        from jax._src import xla_bridge

        if xla_bridge._backends:
            import jax

            return jax.process_index() == 0
    except Exception:
        pass
    return True


def rank0_print(*args, **kwargs) -> None:
    """``print`` that only rank 0 of a multi-process fleet executes."""
    if is_rank0():
        print(*args, **kwargs)
