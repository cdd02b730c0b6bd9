"""Multi-sightline / multi-model fitting sharded over the device mesh.

This is the framework's "data parallelism" (SURVEY.md sections 2.3, 5.8):
independent fit problems -- sightlines, candidate ncomp models, repeated
seeds -- are stacked on a leading axis (:mod:`mcalf_tpu.models.batched`) and
``shard_map``-ped over a 1-D ``jax.sharding.Mesh``.  Each device runs its own
complete nested-sampling ``while_loop`` to ITS OWN convergence (no lockstep
barrier, no collectives inside the hot loop -- the fits are embarrassingly
parallel, so the interconnect only carries the final gather).  This replaces the
reference's host-MPI parallelism, which lives inside PolyChord/MultiNest
(/root/reference/mcalf/cli.py:37-41,116-118,158).

Multiple problems per device are handled with ``lax.map`` inside the shard
(sequential per device, parallel across devices).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from mcalf_tpu.models.batched import stack_problems
from mcalf_tpu.models.forward import AbsorptionModel
from mcalf_tpu.models.jax_model import StaticSpec, loglike_cube_core
from mcalf_tpu.sampler.nested import (
    NSConfig,
    NSResults,
    NSState,
    _not_done,
    finalize,
    init_state,
    nested_sample_device,
    run_steps,
)

__all__ = ["init_distributed", "make_mesh", "fit_many", "fit_stacked"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> int:
    """Initialize the multi-host (DCN) runtime and return the process count.

    Wraps ``jax.distributed.initialize``.  Pass the coordinator address,
    process count and process id explicitly; a single host with several
    GPUs needs no call at all (one process drives every local card).  After this, ``jax.devices()`` spans all hosts and
    :func:`make_mesh` builds a global mesh, so ``fit_many``/``fit_stacked``
    shard their problem axis across hosts with no further changes -- the
    fits are embarrassingly parallel, so the DCN only carries the final
    gather (SURVEY.md section 5.8; replaces the reference's
    mpi4py/MPI.COMM_WORLD plumbing, cli.py:37-41,158).

    Safe to call once per process before any backend touch; a second call
    raises (mirror of jax.distributed semantics).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    return jax.process_count()

_STATIC_KEYS = ("pidx", "comp_id", "is_fill", "u_zidx")


def make_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over all (or the given) devices.  For multi-host pods the
    caller should have run ``jax.distributed.initialize`` first; the mesh
    then spans hosts with the DCN axis folded into the same name."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis_name,))


def _split_static(stacked: Dict[str, Any]):
    data = {k: jnp.asarray(v) for k, v in stacked.items() if k not in _STATIC_KEYS}
    tables = {k: jnp.asarray(stacked[k]) for k in _STATIC_KEYS}
    return data, tables


def fit_stacked(
    spec: StaticSpec,
    stacked: Dict[str, Any],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[Mesh] = None,
    chunk_steps: Optional[int] = None,
    keys=None,
    states: Optional[NSState] = None,
    on_chunk=None,
) -> NSResults:
    """Run one independent nested-sampling fit per stacked problem, sharded
    over the mesh.  Returns NSResults with a leading problem axis.

    ``keys``: optional (nprob, 2) PRNG keys, one per problem (e.g. a
    user-specified seed list for a seed ensemble); default derives them by
    splitting ``seed``.

    The number of problems must be a multiple of the mesh size (pad with
    repeated problems if needed).

    ``chunk_steps``: when set, advance all shards in bounded chunks of outer
    steps from a host loop (keeps every device execution short -- required on
    runtimes that bound execution length; see CLAUDE.md).  Shards that
    converge early no-op their remaining chunks.  Bit-identical to the
    single-shot path.

    ``states``/``on_chunk`` (chunked path only): ``states`` resumes from a
    previously captured stacked sampler state (an :class:`NSState` pytree
    with the problem axis leading -- exactly what ``on_chunk`` receives and
    what ``utils.checkpoint.save_state``/``load_state`` round-trip, so a
    killed fleet restarts mid-run with bit-identical results);
    ``on_chunk(states)`` is a host callback invoked after every chunk, the
    fleet analogue of ``nested_sample``'s checkpoint hook."""
    mesh = mesh if mesh is not None else make_mesh()
    axis = mesh.axis_names[0]
    nprob = next(iter(v.shape[0] for k, v in stacked.items() if k not in _STATIC_KEYS))
    nd = mesh.devices.size
    if nprob % nd != 0:
        raise ValueError(
            f"number of problems ({nprob}) must be a multiple of mesh size ({nd})"
        )

    data, tables = _split_static(stacked)
    cfg = config.resolved()
    if keys is None:
        keys = jax.random.split(jax.random.PRNGKey(seed), nprob)
    keys = jnp.asarray(keys)
    data_specs = jax.tree.map(lambda _: P(axis), data)

    def _ll(local_consts):
        consts = dict(local_consts, **tables)
        return lambda u: loglike_cube_core(u, c=consts, s=spec)

    if chunk_steps is None:
        if states is not None or on_chunk is not None:
            raise ValueError(
                "states=/on_chunk= require the chunked path; pass chunk_steps"
            )

        def run_one(args):
            local_consts, key = args
            return nested_sample_device(_ll(local_consts), key, cfg)

        fitter = shard_map(
            lambda d, k: jax.lax.map(run_one, (d, k)),
            mesh=mesh,
            in_specs=(data_specs, P(axis)),
            out_specs=P(axis),
            check_vma=False,
        )
        return fitter(data, keys)

    # ---- chunked path ----------------------------------------------------
    if states is None:
        init_fn = shard_map(
            lambda d, k: jax.lax.map(
                lambda a: init_state(_ll(a[0]), a[1], cfg), (d, k)
            ),
            mesh=mesh,
            in_specs=(data_specs, P(axis)),
            out_specs=P(axis),
            check_vma=False,
        )
        states = init_fn(data, keys)
    else:
        # resumed checkpoint: host numpy arrays re-enter as device arrays
        states = jax.tree.map(jnp.asarray, states)
    state_specs = jax.tree.map(lambda _: P(axis), states)

    step_fn = shard_map(
        lambda d, st: jax.lax.map(
            lambda a: run_steps(_ll(a[0]), a[1], cfg, chunk_steps), (d, st)
        ),
        mesh=mesh,
        in_specs=(data_specs, state_specs),
        out_specs=state_specs,
        check_vma=False,
    )
    not_done = jax.jit(jax.vmap(lambda s: _not_done(s, cfg)))
    while bool(np.any(np.asarray(not_done(states)))):
        states = step_fn(data, states)
        jax.block_until_ready(states.logz)
        if on_chunk is not None:
            on_chunk(states)

    fin_fn = shard_map(
        lambda d, st: jax.lax.map(
            lambda a: finalize(_ll(a[0]), a[1], cfg), (d, st)
        ),
        mesh=mesh,
        in_specs=(data_specs, state_specs),
        out_specs=P(axis),
        check_vma=False,
    )
    return fin_fn(data, states)


def fit_many(
    models: Sequence[AbsorptionModel],
    config: NSConfig,
    seed: int = 43,
    mesh: Optional[Mesh] = None,
    conv_mode: str = "same_edge",
    chunk_steps: Optional[int] = None,
    states: Optional[NSState] = None,
    on_chunk=None,
) -> NSResults:
    """Fit a list of structurally identical problems across the mesh.

    ``chunk_steps``/``states``/``on_chunk`` select and drive the chunked
    host loop (see :func:`fit_stacked`) -- the path a real pod under
    execution-time limits uses, with checkpoint/resume of the sharded
    state."""
    spec, stacked = stack_problems(models, conv_mode=conv_mode)
    # Label-symmetry gauge fixing when it is a shared exact symmetry of
    # every stacked problem (see NSConfig.canon_layout).
    layouts = {m.canon_layout() for m in models}
    if config.canon_layout is None and len(layouts) == 1:
        layout = layouts.pop()
        if layout is not None:
            import dataclasses

            config = dataclasses.replace(config, canon_layout=layout)
    return fit_stacked(
        spec, stacked, config, seed=seed, mesh=mesh,
        chunk_steps=chunk_steps, states=states, on_chunk=on_chunk,
    )
