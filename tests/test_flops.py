"""FLOP-census unit tests: hand-counted micro-functions pin the walker's
policy (utils/flops.py), so the bench's utilization denominator is a
tested quantity, not folklore."""

import jax
import jax.numpy as jnp
import numpy as np

from mcalf_tpu.utils.flops import flop_census


def test_elementwise_counts():
    x = jnp.ones((8, 16), jnp.float32)
    # 3 weighted elementwise ops on (8,16) = 3 * 128
    c = flop_census(lambda x: jnp.exp(x * 2.0 + 1.0) - x, x)
    assert c.flops == 4 * 128
    assert c.by_primitive["mul"] == 128
    assert c.by_primitive["exp"] == 128
    assert not c.has_while


def test_reduction_counts_input_size():
    x = jnp.ones((8, 16), jnp.float32)
    c = flop_census(lambda x: jnp.sum(x), x)
    assert c.flops == 128


def test_dot_general_2mnk():
    a = jnp.ones((4, 5), jnp.float32)
    b = jnp.ones((5, 3), jnp.float32)
    c = flop_census(lambda a, b: a @ b, a, b)
    assert c.flops == 2 * 4 * 3 * 5


def test_scan_multiplies_by_length():
    x = jnp.ones((16,), jnp.float32)

    def f(x):
        def body(carry, _):
            return carry * 1.5 + x, None

        out, _ = jax.lax.scan(body, x, None, length=7)
        return out

    c = flop_census(f, x)
    assert c.flops == 7 * 2 * 16


def test_cond_takes_max_branch():
    x = jnp.ones((16,), jnp.float32)

    def f(x):
        return jax.lax.cond(
            x[0] > 0.0,
            lambda x: x * 2.0 + 1.0,  # 32
            lambda x: x * 2.0,        # 16
            x,
        )

    c = flop_census(f, x)
    assert c.flops == 32


def test_while_flagged():
    x = jnp.ones((4,), jnp.float32)

    def f(x):
        return jax.lax.while_loop(
            lambda s: s[0] < 10.0, lambda s: s + 1.0, x
        )

    c = flop_census(f, x)
    assert c.has_while
    assert c.flops == 4  # body counted once


def test_predicates_and_movement_are_zero_weight():
    x = jnp.ones((8,), jnp.float32)
    c = flop_census(
        lambda x: jnp.where(x > 0.5, x, jnp.broadcast_to(0.0, x.shape)), x
    )
    assert c.flops == 0
    assert c.unweighted["gt"] == 8 or c.unweighted["lt"] == 8


def test_flagship_likelihood_census_scale():
    """The production likelihood's censused FLOPs/eval must sit in the
    measured ballpark (round-5 census: ~5.3M/eval for the flagship CIV
    model; the round-4 hand formula said 2.83M -- the ~2x under-count
    this module exists to prevent regressing)."""
    from mcalf_tpu.models import AbsorptionModel, make_jax_forward
    from mcalf_tpu.atomic import get_lines

    n = 512
    wave = np.linspace(6180.0, 6220.0, n)
    m = AbsorptionModel(
        wave=wave, flux=np.ones(n), noise=np.full(n, 0.02),
        lines=get_lines(["CIV 1548", "CIV 1550"]), ncomp=(8, 11),
        specres=[8.0], Nrange=[12.0, 14.5], brange=[10.0, 40.0],
        zrange=[2.99, 3.01],
    )
    fwd = make_jax_forward(m)
    B = 8
    x = np.full((B, m.ndim), 0.5, np.float32)
    c = flop_census(fwd.loglike, x)
    per_eval = c.flops / B
    ntrans = int(m.transition_table()["pidx"].size)
    per_pair = per_eval / (ntrans * m.npix)
    # Harris-path math is ~100 FLOP per (transition, pixel); the old
    # hand count of 62 must read as a clear under-count.
    assert 70 <= per_pair <= 200, per_pair
    assert not c.has_while
