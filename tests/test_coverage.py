"""SBC posterior-coverage calibration test (tools/coverage_study.py).

Fits 32 prior-drawn 1-component CIV noise realizations sharded over the
8-device virtual mesh and asserts the truth's weighted posterior ranks
are uniform and the central credible intervals cover at their nominal
rates -- the posterior-side complement of the evidence anchoring in
tests/test_truth_anchor.py."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))


def test_sbc_rank_and_interval_coverage():
    from coverage_study import run_coverage

    out = run_coverage(n_real=32, nlive=100, max_samples=6000)
    assert out["converged_all"]
    # Bonferroni-corrected rank-uniformity gate across the ndim KS tests;
    # measured p = [0.11, 0.86, 1.00, 0.29] at this seed.
    assert out["ranks_ok"], out["rank_ks_p"]
    for lvl in ("0.68", "0.95"):
        assert out["coverage"][lvl]["ok"], out["coverage"]
