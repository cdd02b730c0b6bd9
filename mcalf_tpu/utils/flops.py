"""Automatic FLOP census of a jitted function, from its jaxpr.

Replaces a hand FLOP formula (it under-counted the Harris-path math ~2x:
62 FLOP per (transition, pixel) against a censused ~109), and makes the
counting policy explicit and testable instead of folklore.

Counting policy (``FLOP_WEIGHTS``):

* elementwise arithmetic (add/sub/mul/div/neg/max/min) -- 1 FLOP per
  output element.  A hardware-fused multiply-add therefore counts 2,
  matching the roofline convention (FMA = 2 FLOP).
* transcendentals (exp/log/sqrt/pow/...) -- 1 FLOP per output element.
  This is a deliberate LOWER bound: on a GPU a transcendental costs
  several instructions (special-function unit plus fix-up), so utilization computed from this census
  slightly UNDERSTATES true pipe occupancy.  Stated here so the number
  is interpretable; never silently inflated.
* reductions (reduce_sum/reduce_max/...) -- one op per INPUT element
  (n inputs -> n-1 combines, counted as n).
* dot_general -- 2*M*N*K.
* comparisons, selects, data movement (broadcast/slice/pad/gather/
  transpose/...) -- 0 FLOPs.  They occupy issue slots but move or
  choose data rather than compute; counting them would inflate
  utilization with non-arithmetic.

Control flow: ``scan`` bodies are multiplied by trip count; ``cond``
takes the most expensive branch; ``while`` bodies are counted ONCE and
flagged in :attr:`FlopCensus.has_while` (the trip count is dynamic --
callers measuring a while-heavy function should census the body
separately).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field

import numpy as np

__all__ = ["FlopCensus", "flop_census"]

#: FLOPs per OUTPUT element (reductions handled separately).
FLOP_WEIGHTS = {
    "add": 1, "sub": 1, "mul": 1, "div": 1, "neg": 1,
    "max": 1, "min": 1, "rem": 1,
    "exp": 1, "exp2": 1, "log": 1, "log1p": 1, "expm1": 1,
    "sqrt": 1, "rsqrt": 1, "cbrt": 1,
    "pow": 1, "integer_pow": 1,
    "tanh": 1, "sin": 1, "cos": 1, "tan": 1, "atan2": 1,
    "erf": 1, "erfc": 1, "erf_inv": 1,
    "logistic": 1, "floor": 1, "ceil": 1, "round": 1,
    "nextafter": 1, "square": 1,
}

_REDUCTIONS = {
    "reduce_sum": 1, "reduce_max": 1, "reduce_min": 1,
    "reduce_prod": 1, "argmax": 1, "argmin": 1,
    "cumsum": 1, "cumlogsumexp": 2, "cummax": 1, "cummin": 1, "cumprod": 1,
}

_CALL_PRIMS = (
    "pjit", "jit", "closed_call", "core_call", "remat", "checkpoint",
    "custom_jvp_call", "custom_vjp_call", "custom_vjp_call_jaxpr",
)


@dataclass
class FlopCensus:
    """Result of :func:`flop_census`."""

    #: total FLOPs under the module policy
    flops: int = 0
    #: FLOPs by primitive name (same policy)
    by_primitive: Counter = field(default_factory=Counter)
    #: a while_loop body was counted once (dynamic trip count)
    has_while: bool = False
    #: primitives encountered with no weight rule (counted as 0) --
    #: data movement and predicates land here by design
    unweighted: Counter = field(default_factory=Counter)


def _size(v) -> int:
    return int(np.prod(v.aval.shape)) if v.aval.shape else 1


def _sub_jaxpr(params):
    for key in ("jaxpr", "call_jaxpr", "body_jaxpr"):
        if key in params and params[key] is not None:
            j = params[key]
            return j.jaxpr if hasattr(j, "jaxpr") else j
    return None


def _walk(jaxpr, mult: int, out: FlopCensus) -> None:
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim in _CALL_PRIMS:
            sub = _sub_jaxpr(eqn.params)
            if sub is not None:
                _walk(sub, mult, out)
            continue
        if prim == "scan":
            _walk(eqn.params["jaxpr"].jaxpr, mult * eqn.params["length"], out)
            continue
        if prim == "while":
            out.has_while = True
            _walk(eqn.params["body_jaxpr"].jaxpr, mult, out)
            continue
        if prim == "cond":
            best = None
            for br in eqn.params["branches"]:
                c = FlopCensus()
                _walk(br.jaxpr, mult, c)
                if best is None or c.flops > best.flops:
                    best = c
            if best is not None:
                out.flops += best.flops
                out.by_primitive.update(best.by_primitive)
                out.has_while |= best.has_while
                out.unweighted.update(best.unweighted)
            continue
        if prim == "dot_general":
            ((lc, rc), _batch) = eqn.params["dimension_numbers"]
            lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
            k = int(np.prod([lhs.shape[d] for d in lc])) if lc else 1
            n = 2 * _size(eqn.outvars[0]) * k
            out.flops += mult * n
            out.by_primitive[prim] += mult * n
            continue
        if prim in _REDUCTIONS:
            n = _REDUCTIONS[prim] * sum(_size(v) for v in eqn.invars)
            out.flops += mult * n
            out.by_primitive[prim] += mult * n
            continue
        w = FLOP_WEIGHTS.get(prim)
        if w is None:
            out.unweighted[prim] += mult * max(
                (_size(v) for v in eqn.outvars), default=0
            )
            continue
        n = w * max((_size(v) for v in eqn.outvars), default=0)
        out.flops += mult * n
        out.by_primitive[prim] += mult * n


def flop_census(fn, *example_args) -> FlopCensus:
    """Count the FLOPs one call of ``fn(*example_args)`` performs, by
    walking its jaxpr under the module counting policy.  Host-side
    tracing only; nothing executes on a device."""
    import jax

    jaxpr = jax.make_jaxpr(fn)(*example_args)
    out = FlopCensus()
    _walk(jaxpr.jaxpr, 1, out)
    return out
