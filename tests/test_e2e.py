"""End-to-end CLI test: config file -> fit -> chain files -> analysis -> PDF.

Exercises every layer the way a user does (the reference's de-facto
integration test is fitting its own mocks, SURVEY.md section 4)."""

import os

import numpy as np
import pytest

from mcalf_tpu.analysis import analyze_chains
from mcalf_tpu.cli import main
from mcalf_tpu.io.chains import read_stats


@pytest.fixture(scope="module")
def e2e_outputs(tmp_path_factory, testdata_dir):
    out = tmp_path_factory.mktemp("e2e")
    cfg = out / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = jaxns
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {out}/
chainfmt = pc_fits_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True

[jaxns_settings]
max_samples = 4000
num_live_points = 100
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    return out


def test_outputs_exist(e2e_outputs):
    out = e2e_outputs
    assert os.path.exists(out / "fits" / "pc_fits_0.stats")
    assert os.path.exists(out / "fits" / "pc_fits_0_equal_weights.txt")
    assert os.path.exists(out / "plots" / "pc_fits_0.pdf")


def test_posterior_recovers_truth(e2e_outputs):
    base = str(e2e_outputs / "fits" / "pc_fits_0")
    lnz, err, lhood, post = analyze_chains(base)
    # Layout: [ncomp, N, z, b]; truth N=13.8, z=3.0, b=15.
    assert post.shape[1] == 4
    assert abs(np.nanmedian(post[:, 1]) - 13.8) < 0.05
    assert abs(np.nanmedian(post[:, 2]) - 3.0) < 1e-4
    assert abs(np.nanmedian(post[:, 3]) - 15.0) < 1.5
    assert np.isfinite(lnz) and err > 0


def test_stats_format(e2e_outputs):
    lnz, err = read_stats(str(e2e_outputs / "fits" / "pc_fits_0.stats"))
    assert 4900 < lnz < 5050  # ll at truth ~ +5002; logZ a bit below
    assert 0 < err < 1.0


def test_device_cpu_and_debug_diagnostics(tmp_path, testdata_dir):
    # `device = cpu` must be honored (reference cli.py:215-216) and --debug
    # must write the sampler-diagnostics PNG (reference cli.py:288-289).
    # The test platform is already CPU (conftest), so this exercises the
    # config path end-to-end without a platform flip.
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = jaxns
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = dbg_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
device = cpu

[jaxns_settings]
max_samples = 2000
num_live_points = 60
"""
    )
    rc = main([str(cfg), "--debug"])
    assert rc == 0
    assert os.path.exists(tmp_path / "plots" / "dbg_0_diagnostics.png")


def test_dypolychord_dynamic_end_to_end(tmp_path, testdata_dir):
    # solver=dypolychord runs the two-pass dynamic sampler through the full
    # CLI; the chain files must carry the merged posterior.
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = dypolychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = dy_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[pc_settings]
read_resume = False
write_resume = False

[ns_settings]
nlive = 60
max_samples = 3000
precision_criterion = 0.01
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    from mcalf_tpu.io.chains import read_stats

    lnz, err = read_stats(str(tmp_path / "fits" / "dy_0.stats"))
    # brute-force quadrature truth for this (reference) mock: 4983.62
    assert abs(lnz - 4983.62) < 3.0, lnz
    base = str(tmp_path / "fits" / "dy_0")
    _, _, _, post = analyze_chains(base)
    assert abs(np.nanmedian(post[:, 1]) - 13.8) < 0.06
    assert abs(np.nanmedian(post[:, 2]) - 3.0) < 1e-4

    # The _dead-birth.txt must carry BOTH passes of the dynamic run (the
    # .stats evidence is merged base+boost): boost points are born at the
    # finite l_init contour, and an anesthetic-style reconstruction of the
    # evidence from (logL, birth) pairs alone must agree with the shipped
    # merged logZ -- a base-only file re-analyzes ~1 nat off.
    dead = np.loadtxt(base + "_dead-birth.txt")
    assert np.any(dead[:, -1] == -1e30), "no prior-born (base) points"
    finite_births = dead[dead[:, -1] > -1e29, -1]
    assert finite_births.size > 0, "boost pass missing from dead-birth file"
    assert abs(lnz - _deadbirth_logz(dead)) < 3 * err + 0.3


def _deadbirth_logz(dead):
    """Anesthetic's dead-birth evidence reconstruction: the live-point count
    at each death is recovered from the birth contours, so this checks the
    FILE is a self-consistent nested-sampling run, not just row counts."""
    logl = dead[:, -2]
    birth = dead[:, -1]
    order = np.argsort(logl, kind="stable")
    logl, birth = logl[order], birth[order]
    nlive = np.array(
        [np.sum((birth < li) & (logl >= li)) for li in logl], dtype=np.float64
    )
    # mean-shrinkage volumes: X_i = prod n_k/(n_k+1); w_i = X_{i-1}/(n_i+1)
    logx = np.cumsum(np.log(nlive) - np.log(nlive + 1.0))
    logw = np.concatenate([[0.0], logx[:-1]]) - np.log(nlive + 1.0)
    a = logw + logl
    m = a.max()
    return m + np.log(np.sum(np.exp(a - m)))


def test_xla_only_full_fit_pinned(tmp_path, testdata_dir, monkeypatch):
    # The plain-XLA likelihood is the one path on every platform (the GPU
    # runs exactly this): it must complete a full fit with a correct
    # evidence.  Pinned by name so the contract stays explicit.
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = xla_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[ns_settings]
nlive = 60
max_samples = 2500
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    lnz, err = read_stats(str(tmp_path / "fits" / "xla_0.stats"))
    # quadrature truth for this mock: 4983.62
    assert abs(lnz - 4983.62) < 3.0, lnz
    assert 0 < err < 1.0


def test_rank_guard_warns_on_failing_fit(tmp_path, testdata_dir, capsys, monkeypatch):
    # The insertion-rank guard is ALWAYS on (no --debug needed): when the
    # test fails, the runner must print the health warning and record the
    # failure in the .stats file.  Detection power of the diagnostic itself
    # is unit-tested (test_sampler.test_rank_block_scan_covers_tail); here a
    # forced-failure verdict exercises the guard plumbing end-to-end (a real
    # easy 1-comp fit passes the rank test even when under-repeated, since
    # chain starts are already constrained-prior distributed).
    import mcalf_tpu.sampler as sampler_pkg
    from mcalf_tpu.sampler.diagnostics import RankDiagnostic

    real = sampler_pkg.insertion_rank_test

    def failing(res, cfg=None, **kw):
        d = real(res, cfg, **kw)
        return RankDiagnostic(
            ks_stat=d.ks_stat, p_value=1.6e-3, p_value_blocks=d.p_value_blocks,
            n=d.n, n_levels=d.n_levels, ranks=d.ranks,
        )

    monkeypatch.setattr(sampler_pkg, "insertion_rank_test", failing)
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = bad_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[ns_settings]
nlive = 100
num_repeats = 8
max_samples = 4000
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    captured = capsys.readouterr()
    assert "insertion-rank test FAILED" in captured.out
    stats = (tmp_path / "fits" / "bad_0.stats").read_text()
    assert "FAILED (p < 0.01)" in stats
    # the .stats file stays parseable despite the comment lines
    lnz, err = read_stats(str(tmp_path / "fits" / "bad_0.stats"))
    assert np.isfinite(lnz) and err > 0


def test_seed_ensemble_through_cli(tmp_path, testdata_dir):
    # [run] seeds drives a 4-seed fleet fit: per-member chain files with the
    # _s<seed> suffix plus ONE merged .stats/_equal_weights under the base
    # name (SURVEY 2.3's seed fleet as a user surface).
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = ens_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True
seeds = 43,44,45,46

[ns_settings]
nlive = 60
max_samples = 2500
precision_criterion = 0.01
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    fits = tmp_path / "fits"
    for s in (43, 44, 45, 46):
        assert os.path.exists(fits / f"ens_0_s{s}.stats")
        assert os.path.exists(fits / f"ens_0_s{s}_equal_weights.txt")
    stats = (fits / "ens_0.stats").read_text()
    assert "merged 4 seeds" in stats
    lnz, err = read_stats(str(fits / "ens_0.stats"))
    # quadrature truth for the repo mock: 4985.51; 4-seed merge is tight
    assert abs(lnz - 4985.51) < 2.0, lnz
    assert 0 < err < 1.0
    # merged posterior feeds the standard analysis phase
    _, _, _, post = analyze_chains(str(fits / "ens_0"))
    assert abs(np.nanmedian(post[:, 1]) - 13.8) < 0.06
    # plots ran off the merged chains
    assert os.path.exists(tmp_path / "plots" / "ens_0.pdf")


def test_seed_ensemble_sharded_over_mesh(tmp_path, testdata_dir, capsys):
    # 8 seeds on the 8-device virtual mesh: the ensemble shards one fit per
    # device (parallel.fit_stacked with explicit per-seed keys) instead of
    # looping.  Output contract identical to the sequential path.
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = mesh_{{0}}

[components]
ncomp = 1,1
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
seeds = 50,51,52,53,54,55,56,57

[ns_settings]
nlive = 50
max_samples = 2000
precision_criterion = 0.01
"""
    )
    rc = main([str(cfg), "--debug"])
    assert rc == 0
    captured = capsys.readouterr()
    assert "sharding 8 seeds over 8 devices" in captured.out
    fits = tmp_path / "fits"
    assert os.path.exists(fits / "mesh_0_s57.stats")
    lnz, err = read_stats(str(fits / "mesh_0.stats"))
    assert abs(lnz - 4985.51) < 2.5, lnz


def test_ncomp_grid_through_cli(tmp_path, testdata_dir):
    # [run] ncomp_grid fits each fixed k in the ncomp range and writes the
    # Bayes-factor table; the best-k chains land under the base name
    # (reference evidence-based ncomp selection, cli.py:367-383).
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = grid_{{0}}

[components]
ncomp = 1,2
contval  = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
ncomp_grid = True

[ns_settings]
nlive = 60
max_samples = 2500
precision_criterion = 0.01
"""
    )
    # Drive the runner directly (the CLI wraps it) so the declared
    # Tuple[NSResults, str] return contract is asserted too.
    from mcalf_tpu.config import readconfig
    from mcalf_tpu.runner import run_fit
    from mcalf_tpu.sampler import NSResults

    res, base = run_fit(readconfig(str(cfg)))
    assert isinstance(res, NSResults)  # the BEST-k results, not a bare int
    fits = tmp_path / "fits"
    assert base == str(fits / "grid_0")
    table = (fits / "grid_0_ncomp_grid.txt").read_text()
    assert "best k = 1" in table, table  # the mock is a single component
    for k in (1, 2):
        assert os.path.exists(fits / f"grid_0_k{k}.stats")
    # best-k chains copied to the base name; returned results match them
    lnz, err = read_stats(str(fits / "grid_0.stats"))
    lnz1, _ = read_stats(str(fits / "grid_0_k1.stats"))
    assert lnz == lnz1
    assert lnz == float(np.round(np.asarray(res.logz, np.float64), 6)) or abs(
        lnz - float(res.logz)
    ) < 1e-4


def test_refit_with_dofit_false_reuses_chains(e2e_outputs, testdata_dir, capsys):
    # doplot-only invocation must work from the chain files alone
    # (fit and analysis communicate only via disk, SURVEY.md 5.4).
    out = e2e_outputs
    cfg = out / "plot_only.cfg"
    cfg.write_text(
        (out / "fit.cfg").read_text().replace("dofit = True", "dofit = False")
    )
    rc = main([str(cfg)])
    assert rc == 0
    captured = capsys.readouterr()
    assert "Ln(z):" in captured.out
    assert "Ncomp: 01 Occurrence Fraction: 1.000" in captured.out


def test_multi_spectrum_sequential(tmp_path, testdata_dir):
    # ``specfile`` as a comma list (here the same file twice -> the stem
    # collision disambiguator kicks in): one fit + plot per spectrum,
    # chain files under per-spectrum suffixes.
    cfg = tmp_path / "multi.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt, civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
solver = jaxns
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = ms_{{0}}

[components]
ncomp = 1,1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = True

[jaxns_settings]
max_samples = 2500
num_live_points = 60
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    fits, plots = tmp_path / "fits", tmp_path / "plots"
    for stem in ("civ_mock_spec", "civ_mock_spec1"):
        lnz, err = read_stats(str(fits / f"ms_0_{stem}.stats"))
        assert 4900 < lnz < 5050 and 0 < err < 1.5
        assert os.path.exists(fits / f"ms_0_{stem}_equal_weights.txt")
        assert os.path.exists(plots / f"ms_0_{stem}.pdf")


def test_multi_spectrum_sharded(tmp_path, testdata_dir, capsys):
    # 8 spectra on the 8-device virtual mesh: the stacked/sharded path
    # (identical files stack trivially).  doplot off to keep it fast.
    speclist = ", ".join(["civ_mock_spec.txt"] * 8)
    cfg = tmp_path / "multi8.cfg"
    cfg.write_text(
        f"""
[input]
specfile = {speclist}
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
solver = jaxns
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = m8_{{0}}

[components]
ncomp = 1,1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[jaxns_settings]
max_samples = 1600
num_live_points = 40
"""
    )
    rc = main([str(cfg), "--debug"])
    assert rc == 0
    captured = capsys.readouterr()
    assert "sharding 8 spectra over 8 devices" in captured.out
    fits = tmp_path / "fits"
    lnzs = []
    for i, stem in enumerate(
        ["civ_mock_spec"] + [f"civ_mock_spec{k}" for k in range(1, 8)]
    ):
        lnz, err = read_stats(str(fits / f"m8_0_{stem}.stats"))
        lnzs.append(lnz)
        assert 4900 < lnz < 5050 and 0 < err < 2.0
    # identical data, different per-shard seeds -> close but not equal
    assert np.std(lnzs) < 3.0
    assert len(set(lnzs)) > 1


def test_cli_kill_and_resume_bit_identical(tmp_path, testdata_dir, capsys,
                                           monkeypatch):
    # Crash-resume through the CLI (the reference's PolyChord read_resume
    # role, cli.py:97-98): a fit killed mid-run restarts from its latest
    # checkpoint and -- at a FIXED chunk schedule -- finishes bit-identical
    # to an uninterrupted run (.stats byte-equal).
    monkeypatch.setenv("MCALF_TPU_NS_CHUNK", "4")

    def write_cfg(name, outdir, ckpt):
        cfg = tmp_path / name
        cfg.write_text(
            f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {outdir}/
chainfmt = res_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False
seed = 43
{ckpt}

[ns_settings]
nlive = 60
num_repeats = 24
max_samples = 2500
precision_criterion = 0.01
"""
        )
        return cfg

    # Uninterrupted reference run (same fixed chunk schedule, no checkpoints).
    ref_out = tmp_path / "ref"
    rc = main([str(write_cfg("ref.cfg", ref_out, ""))])
    assert rc == 0
    ref_stats = (ref_out / "fits" / "res_0.stats").read_bytes()

    # Interrupted run: die after 3 sampler chunks (checkpoints 1-3 on disk).
    int_out = tmp_path / "int"
    ckpt_dir = tmp_path / "ckpt"
    cfg_int = write_cfg("int.cfg", int_out, f"checkpoint = {ckpt_dir}")

    import mcalf_tpu.sampler.nested as nested

    real_run_steps = nested.run_steps

    class Killed(RuntimeError):
        pass

    calls = {"n": 0}

    def dying_run_steps(*a, **k):
        calls["n"] += 1
        if calls["n"] > 3:
            raise Killed("simulated mid-fit crash")
        return real_run_steps(*a, **k)

    monkeypatch.setattr(nested, "run_steps", dying_run_steps)
    with pytest.raises(Killed):
        main([str(cfg_int)])
    monkeypatch.setattr(nested, "run_steps", real_run_steps)
    assert any(ckpt_dir.glob("ns_state_*.npz")), "no checkpoint written"

    # Second invocation resumes past the crash and completes.
    capsys.readouterr()
    rc = main([str(cfg_int)])
    assert rc == 0
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert (int_out / "fits" / "res_0.stats").read_bytes() == ref_stats


def test_auto_repeats_through_cli(tmp_path, testdata_dir, capsys):
    # [ns_settings] auto_repeats drives the automated repeats ladder
    # (sampler/repeats.py) from the config surface: the run prints the
    # ladder verdict and the merged evidence lands near the quadrature
    # anchor for this mock (4983.62 on the reference fixture).
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = auto_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[ns_settings]
nlive = 60
num_repeats = 12
max_samples = 2500
precision_criterion = 0.01
auto_repeats = true
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "auto_repeats:" in out or "auto_repeats ladder" in out
    lnz, err = read_stats(str(tmp_path / "fits" / "auto_0.stats"))
    # Ladder-converged merged evidence: close to the quadrature anchor
    # (generous bound -- nlive=60 quoted err ~0.55, 2-seed merge).
    assert abs(lnz - 4983.62) < 2.5, lnz
    assert 0 < err < 1.0


def test_pc_settings_resume_surface(tmp_path, testdata_dir, capsys,
                                    monkeypatch):
    # The reference honors read_resume/write_resume from [pc_settings]
    # (cli.py:97-98, exercised by its shipped testdata/fit.cfg:53-54); ours
    # maps them onto the sampler-state checkpoint machinery under
    # <chain base>_resume/, and write_dead emits the PolyChord/anesthetic
    # _dead-birth.txt.
    monkeypatch.setenv("MCALF_TPU_NS_CHUNK", "4")
    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = polychord
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/
chainfmt = pcres_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 12.0,14.5
brange = 10.0, 40.0
zrange = 2.99, 3.01

[run]
dofit = True
doplot = False

[pc_settings]
nlive = 60
num_repeats = 24
precision_criterion = 0.01
read_resume = True
write_resume = True

[ns_settings]
max_samples = 2500
"""
    )
    rc = main([str(cfg)])
    assert rc == 0
    fits = tmp_path / "fits"
    resume_dir = fits / "pcres_0_resume"
    assert any(resume_dir.glob("ns_state_*.npz")), "write_resume wrote nothing"
    # Per-chunk checkpoints are pruned as they are written (keep=3):
    # ordinary polychord configs must not grow the resume dir unboundedly
    # (one multi-MB state per ~15 s chunk otherwise).
    assert len(list(resume_dir.glob("ns_state_*.npz"))) <= 3
    stats0 = (fits / "pcres_0.stats").read_bytes()
    # write_dead defaults True when [pc_settings] exists (reference
    # cli.py:100): params + logL + birth logL per dead point.
    dead = np.loadtxt(fits / "pcres_0_dead-birth.txt")
    assert dead.shape[1] == 4 + 2  # ndim=4 params, logl, birth
    assert np.all(dead[:, -1] <= dead[:, -2])  # birth contour below logl
    assert np.any(dead[:, -1] == -1e30)  # prior-born points sentinel

    # Re-invocation resumes from the (terminal) checkpoint instead of
    # refitting, and reproduces the chain files bit-identically.
    capsys.readouterr()
    rc = main([str(cfg)])
    assert rc == 0
    assert "Resuming from checkpoint" in capsys.readouterr().out
    assert (fits / "pcres_0.stats").read_bytes() == stats0

    # read_resume=False ignores the checkpoints (fresh fit, no resume line).
    cfg2 = tmp_path / "fit2.cfg"
    cfg2.write_text(
        cfg.read_text().replace("read_resume = True", "read_resume = False")
    )
    rc = main([str(cfg2)])
    assert rc == 0
    assert "Resuming from checkpoint" not in capsys.readouterr().out

    # STALE resume files (the user edited the sampler config since they
    # were written) must not abort the run on this implicitly-enabled
    # surface: warn and refit fresh.  (The explicit [run] checkpoint
    # surface keeps the hard fingerprint refusal --
    # tests/test_checkpoint.py.)
    cfg3 = tmp_path / "fit3.cfg"
    cfg3.write_text(
        cfg.read_text().replace("num_repeats = 24", "num_repeats = 32")
    )
    rc = main([str(cfg3)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "starting a fresh fit" in out, out
    assert np.isfinite(
        np.loadtxt(fits / "pcres_0_equal_weights.txt")
    ).all()


def test_cli_version_and_missing_config(capsys):
    # --version exits 0 printing the package version (reference --version
    # role); a nonexistent config file is a clean readconfig error, not a
    # traceback soup.
    import pytest

    from mcalf_tpu import __version__

    with pytest.raises(SystemExit) as e:
        main(["--version"])
    assert e.value.code == 0
    assert __version__ in capsys.readouterr().out
    with pytest.raises((FileNotFoundError, ValueError)):
        main(["/nonexistent/config.ini"])
