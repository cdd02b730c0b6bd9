"""CPU tests of the GPU entry points: ``chip_smoke.py`` and ``bench.py``
refuse to run anywhere but on a GPU, and the smoke test's helpers
(config rewriting, tolerance checks, stats parsing, last-line format) work
without a card."""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("entry", [chip_smoke.require_gpu, bench.require_gpu])
def test_device_check_fails_without_gpu(entry):
    with pytest.raises(SystemExit, match="no GPU found"):
        entry()


def test_smoke_main_exits_without_result_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "OUT", str(tmp_path / "smoke"))
    with pytest.raises(SystemExit, match="no GPU found"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_smoke_rejects_unknown_arguments(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "OUT", str(tmp_path / "smoke"))
    with pytest.raises(SystemExit, match="unknown arguments"):
        chip_smoke.main(["--eight"])


def test_rewrite_config_keeps_the_fit_and_moves_outputs(tmp_path):
    from mcalf_tpu.config import readconfig

    dst = chip_smoke.rewrite_config(
        chip_smoke.FLAGSHIP_CFG, str(tmp_path / "cfg" / "f.cfg"),
        str(tmp_path / "out"),
    )
    new = readconfig(dst)
    old = readconfig(chip_smoke.FLAGSHIP_CFG)
    assert new["doplot"] is False and old["doplot"] is True
    assert new["chaindir"].startswith(str(tmp_path / "out"))
    assert os.path.isfile(new["specfile"])
    assert os.path.samefile(new["specfile"], os.path.join(REPO, old["specfile"]))
    for k in ("ncomp", "Nrange", "brange", "zrange", "specres", "wavefit"):
        assert np.array_equal(np.asarray(new[k]), np.asarray(old[k])), k
    assert new["jaxns_settings"] == old["jaxns_settings"]


def test_tolerance_helpers():
    assert chip_smoke.within(4855.0, chip_smoke.FLAGSHIP_LOGZ_LIMIT,
                             chip_smoke.FLAGSHIP_LOGZ_TOL)
    assert not chip_smoke.within(4850.0, chip_smoke.FLAGSHIP_LOGZ_LIMIT,
                                 chip_smoke.FLAGSHIP_LOGZ_TOL)
    assert chip_smoke.FLAGSHIP_LOGZ_TOL == pytest.approx(3.99)
    assert chip_smoke.combined_tol(0.3, 0.4) == pytest.approx(1.5)


def test_lnl_tolerance_bounds_a_flux_error():
    """A model off by the float32 flux bound everywhere moves lnL by less
    than the tolerance built from the float64 residual."""
    from mcalf_tpu.models.jax_model import F32_FLUX_EPS, lnl_tolerance

    rng = np.random.default_rng(0)
    ivar = np.full(500, 1.0 / 0.02**2)
    data = 1.0 + rng.normal(0, 0.02, 500)
    model = np.ones(500)
    r = data - model
    const = np.sum(np.log(2 * np.pi / ivar))
    ll = -0.5 * (np.sum(ivar * r * r) + const)
    for sign in (+1.0, -1.0):
        r2 = data - (model + sign * F32_FLUX_EPS)
        ll2 = -0.5 * (np.sum(ivar * r2 * r2) + const)
        assert abs(ll2 - ll) <= lnl_tolerance(r, ivar, [ll])[0]


def test_read_stats_file(tmp_path):
    from mcalf_tpu.io.chains import write_stats

    p = str(tmp_path / "x.stats")
    write_stats(p, 924.18, 0.66, [
        "termination = converged", "n_like = 6528500",
        "insertion-rank KS p = 0.6607 (blocks 1.0000, n=3650)",
        "seed 43: logZ = 4855.100 +/- 0.800; insertion-rank KS p = 0.5000",
        "seeds sharded over devices [0, 1, 2, 3]",
    ])
    st = chip_smoke.read_stats_file(p)
    assert st["logz"] == pytest.approx(924.18)
    assert st["termination"] == "converged" and st["n_like"] == "6528500"
    assert st["rank_p"] == pytest.approx(0.6607)
    assert st["seeds"][43] == pytest.approx((4855.1, 0.8, 0.5))
    assert st["shard_devices"] == [0, 1, 2, 3]


def test_result_line_format():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }


def test_bench_peaks_keyed_by_device_kind():
    peaks = bench.PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks["f32_flops"] == 67e12 and peaks["hbm_bytes_per_s"] == 3.35e12
