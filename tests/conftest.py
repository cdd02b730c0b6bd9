"""Test configuration: an 8-device virtual CPU platform, and the ``gpu`` marker.

Multi-device sharding paths are exercised on a virtual CPU mesh
(xla_force_host_platform_device_count); compute tests run the same code
single-device.  The platform must be chosen before JAX starts a backend,
so it is set here, at import.  When a backend is already running -- the
card-only tests run inside ``chip_smoke.py``, which owns the GPU -- the
platform is left as it is.

Tests that need an NVIDIA GPU are marked ``gpu`` and take the
``gpu_device`` fixture, which decides whether a card is present (never at
import) and skips with the reason otherwise.  ``python chip_smoke.py`` runs
them on the card.
"""

import os

import jax  # noqa: E402
from jax._src import xla_bridge  # noqa: E402

if not xla_bridge.backends_are_initialized():
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


# ---------------------------------------------------------------------------
# Test tiers.  `pytest -m "not slow"` is the documented <5 min smoke tier
# (CLAUDE.md): physics parity (forward/faddeeva), analytic sampler
# checks, config, chain IO, checkpointing, diagnostics.  Everything below is
# marked `slow` from one central list keyed on MEASURED call/setup durations
# (full-suite --durations=0 run, 2026-08-18; cut at >= ~20 s, plus mid-band
# tests whose coverage the smoke tier already carries).  Whole modules are
# listed where every test (or a shared module fixture) runs a full fit.
# ---------------------------------------------------------------------------

#: Modules whose tests (or shared fixtures) each run a full end-to-end fit.
_SLOW_MODULES = {
    "test_e2e",           # CLI fits (30-94 s each; shared 35 s fit fixture)
    "test_sharding",      # mesh fleet fits (33-177 s)
    "test_distributed",   # 2-process DCN cluster (58 s)
    "test_truth_anchor",  # 3-seed quadrature-anchor fit fixture (75 s)
    "test_multiwindow",   # multi-window fit fixture (30 s)
    "test_repeats",       # repeats-ladder escalation fits (26-56 s)
    "test_merge",         # multi-run merge fits (24 s each)
    "test_clusters",      # two-mode clustering fits (26-35 s)
    "test_hi_forest",     # HI+filler trans-dimensional fit (92 s)
    "test_coverage",      # 32-realization SBC battery over the mesh (53 s)
}

#: Individual heavy tests inside otherwise-fast modules.  The smoke tier
#: keeps one analytic evidence check (gaussian_evidence[2-0.05]), the
#: posterior-moment check, the static-shape contract and the checkpoint
#: round-trip as its sampler-analytics coverage.
_SLOW_TESTS = {
    "test_gaussian_evidence[4-0.08]",
    "test_uniform_slab_evidence",
    "test_truncated_gaussian_corner",
    "test_batch_deletion_consistency",
    "test_stepout_bracket_evidence",
    "test_async_pass_scheduling_cost",
    "test_resample_equal_distribution",
    "test_evidence_unbiased_over_seeds",
    "test_insertion_rank_uniformity",
    "test_reproducible_with_same_key",
    "test_canon_layout_gauge_fixing_preserves_evidence",
    "test_dynamic_gaussian",
    "test_dynamic_resume_bit_identical",
    "test_merged_logzerr_calibrated_against_repeat_scatter",
    "test_chunked_equals_oneshot",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        module = item.module.__name__.rsplit(".", 1)[-1]
        if module in _SLOW_MODULES or item.name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled_executables():
    """Free jit executables between test modules.

    Every compiled executable holds LLVM-JIT'd code in its own set of
    memory mappings; a single-process run of the full suite compiles
    thousands of variants and the process's mapping count grows ~2k/min
    (measured via /proc/self/maps) until it hits vm.max_map_count
    (65530 default), where the next mmap fails inside XLA:CPU's LLVM
    codegen and the compiler SEGFAULTS (observed deterministically ~37
    min in, in whichever test compiles next -- the traceback blames an
    innocent test).  Executables are only reachable through the jit
    caches once a module's closures are gone, so clearing per module
    caps the mapping count at the suite's largest single module.  Costs
    only cross-module cache hits, which are rare (configs differ)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def testdata_dir():
    # The repo's mock spectra (mcalf_tpu/mocks.py) are golden fixtures.
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "testdata"
    )


@pytest.fixture
def gpu_device():
    """The first JAX device when it is an NVIDIA GPU; skip otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            f"needs an NVIDIA GPU (JAX runs on {dev.platform}); "
            "chip_smoke.py runs the gpu-marked tests on the card"
        )
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
