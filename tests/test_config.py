"""Config-system tests: fit.cfg compatibility + defaults."""

import os

import numpy as np
import pytest

from mcalf_tpu.config import readconfig
from mcalf_tpu.runner import solver_nsconfig


def test_reads_reference_fit_cfg(testdata_dir):
    # The shipped flagship config (the reference's fit.cfg in the repo's
    # mock layout, mcalf_tpu/mocks.FIT_CFG) must parse unchanged.
    cfg = readconfig(f"{testdata_dir}/fit.cfg")
    assert cfg["specfile"] == "testdata/civ_mock_spec_multicomp.txt"
    assert cfg["wavefit"] == [(6180.0, 6220.0)]
    assert cfg["linelist"] == ["CIV 1548", "CIV 1550"]
    assert cfg["coldef"] == ["Wave", "Flux", "Err"]
    assert cfg["solver"] == "jaxns"
    assert np.allclose(cfg["specres"], [8.0])
    assert cfg["asymmlike"] is False
    assert list(cfg["ncomp"]) == [8, 11]
    assert np.allclose(cfg["Nrange"], [12.0, 14.5])
    assert np.allclose(cfg["brange"], [10.0, 40.0])
    assert np.allclose(cfg["zrange"], [2.99, 3.01])
    assert cfg["chaindir"] == "testdata/output/fits/"
    assert cfg["plotdir"] == "testdata/output/plots/"
    assert cfg["chainfmt"] == "pc_fits_{0}"
    # the reference ships max_samples = 2000, which caps the fit before it
    # converges; the repo's config raises it (testdata/fit.cfg:29-31)
    assert cfg["jaxns_settings"]["max_samples"] == "40000"
    assert cfg["jaxns_settings"]["num_live_points"] == "200"
    assert cfg["jaxns_settings"]["difficult_model"] is True
    assert "pc_settings" not in cfg
    assert cfg["nmaxcols"] == 5
    assert cfg["dofit"] is True and cfg["doplot"] is True


def test_defaults(tmp_path):
    p = tmp_path / "min.cfg"
    p.write_text(
        "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"
    )
    cfg = readconfig(str(p))
    assert cfg["solver"] == "polychord"
    assert np.allclose(cfg["specres"], [7.0])
    assert list(cfg["ncomp"]) == [1, 1]
    assert cfg["nfill"] == 0
    assert np.allclose(cfg["Nrange"], (11.5, 16))
    assert np.allclose(cfg["brange"], (1, 30))
    assert cfg["zrange"] is None
    assert cfg["chaindir"] == "./fits/"
    assert cfg["chainfmt"].format(0) == "pc_fits_0"  # valid format string
    assert cfg["nmaxcols"] == 5
    assert np.allclose(cfg["yrange"], (-0.1, 1.2))
    assert cfg["seed"] == 43


def test_mandatory_keys(tmp_path):
    p = tmp_path / "bad.cfg"
    p.write_text("[input]\nwavefit = 1,2\nlinelist = CIV 1548\n")
    with pytest.raises(Exception):
        readconfig(str(p))
    p.write_text("[input]\nspecfile = s\nwavefit = 1,2,3\nlinelist = CIV 1548\n")
    with pytest.raises(ValueError):
        readconfig(str(p))


def test_input_run_bools_tolerant(tmp_path):
    # The reference crashes with a bare KeyError on `asymmlike = true`
    # (hires_fitter.py:803-804); every [input]/[run] boolean accepts the
    # usual INI spellings case-insensitively and raises a READABLE error
    # on junk (SURVEY 5.6 fix-the-bugs policy).
    head = "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"

    p = tmp_path / "b.cfg"
    p.write_text(head + "asymmlike = true\n[run]\ndofit = YES\ndoplot = 0\n"
                 "showprogress = on\nncomp_grid = No\n")
    cfg = readconfig(str(p))
    assert cfg["asymmlike"] is True
    assert cfg["dofit"] is True
    assert cfg["doplot"] is False
    assert cfg["showprogress"] is True
    assert cfg["ncomp_grid"] is False

    p.write_text(head + "asymmlike = maybe\n")
    with pytest.raises(ValueError, match=r"asymmlike.*maybe|maybe.*asymmlike"):
        readconfig(str(p))
    p.write_text(head + "[run]\ndofit = 2\n")
    with pytest.raises(ValueError, match="dofit"):
        readconfig(str(p))


def test_settings_dict_lowercase_literals(tmp_path):
    # [*_settings] sections convert true/false case-insensitively (1/0 stay
    # strings -- they could be numeric settings).
    p = tmp_path / "s.cfg"
    p.write_text(
        "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"
        "[pc_settings]\nread_resume = false\nwrite_resume = TRUE\nnlive = 1\n"
    )
    cfg = readconfig(str(p))
    assert cfg["pc_settings"]["read_resume"] is False
    assert cfg["pc_settings"]["write_resume"] is True
    assert cfg["pc_settings"]["nlive"] == "1"


def test_solver_mapping(testdata_dir):
    cfg = readconfig(f"{testdata_dir}/fit.cfg")
    plan = solver_nsconfig(cfg, ndim=34)
    ns = plan.cfg
    # jaxns settings from fit.cfg: max_samples=40000, nlive=200, difficult.
    assert ns.nlive == 200
    assert ns.max_samples == 40000
    assert ns.difficult_model is True
    assert plan.resample_S == 40000
    # polychord mapping picks up pc_settings.
    cfg2 = dict(
        cfg,
        solver="polychord",
        pc_settings={
            "nlive": "150", "num_repeats": "25",
            "precision_criterion": "0.01",
            "read_resume": False, "write_resume": False,
        },
    )
    plan2 = solver_nsconfig(cfg2, ndim=34)
    assert plan2.cfg.nlive == 150
    assert plan2.cfg.num_repeats == 25
    assert plan2.cfg.precision_criterion == 0.01
    assert plan2.resample_S == 0
    # The reference's shipped fit.cfg sets the resume keys False
    # (its [pc_settings]) -- they must be honored, not dropped.
    assert plan2.read_resume is False
    assert plan2.write_resume is False
    # without a [pc_settings] section the polychord defaults apply and the
    # resume machinery stays off
    plan3 = solver_nsconfig(dict(cfg, solver="polychord"), ndim=34)
    assert plan3.cfg.nlive == 100 and plan3.cfg.num_repeats == 0
    assert not plan3.read_resume and not plan3.write_resume
    with pytest.raises(ValueError):
        solver_nsconfig(dict(cfg, solver="emcee"), ndim=4)


def test_pc_resume_defaults_and_write_dead():
    # Reference defaults read/write_resume True whenever [pc_settings]
    # exists (cli.py:97-98); absent section keeps them off.
    plan = solver_nsconfig(
        {"solver": "polychord", "pc_settings": {"nlive": "50"}}, ndim=4
    )
    assert plan.read_resume and plan.write_resume and plan.write_dead
    plan = solver_nsconfig({"solver": "polychord"}, ndim=4)
    assert not plan.read_resume and not plan.write_resume
    plan = solver_nsconfig(
        {
            "solver": "polychord",
            "pc_settings": {
                "read_resume": "False",
                "write_resume": "false",
                "write_dead": False,
            },
        },
        ndim=4,
    )
    assert not plan.read_resume and not plan.write_resume
    assert not plan.write_dead


def test_settings_bools_accept_lowercase_strings():
    # configparser hands settings values through as raw strings;
    # bool("false") is True, so the mapping must parse, not cast
    # (the reference has exactly this bug on jaxns difficult_model).
    plan = solver_nsconfig(
        {"solver": "jaxns", "jaxns_settings": {"difficult_model": "false"}},
        ndim=4,
    )
    assert plan.cfg.difficult_model is False
    plan = solver_nsconfig(
        {"solver": "jaxns", "jaxns_settings": {"difficult_model": "true"}},
        ndim=4,
    )
    assert plan.cfg.difficult_model is True
    plan = solver_nsconfig(
        {"solver": "ns", "ns_settings": {"difficult_model": "false"}}, ndim=4
    )
    assert plan.cfg.difficult_model is False


def test_unknown_settings_key_warns(capsys):
    import mcalf_tpu.runner as runner

    runner._warned_settings_keys.clear()
    solver_nsconfig(
        {
            "solver": "polychord",
            "pc_settings": {"num_repeat": "20"},  # typo: num_repeats
            "ns_settings": {"nlive": "100"},
        },
        ndim=4,
    )
    out = capsys.readouterr().out
    assert "unrecognized key 'num_repeat' in [pc_settings]" in out
    # known keys never warn
    assert "nlive" not in [
        k for (_, k) in runner._warned_settings_keys
    ]
    # warning is once-per-process, not per call
    solver_nsconfig(
        {"solver": "polychord", "pc_settings": {"num_repeat": "20"}}, ndim=4
    )
    assert "num_repeat" not in capsys.readouterr().out


def test_ns_settings_boost_and_bracket_knobs():
    plan = solver_nsconfig(
        {
            "solver": "dypolychord",
            "ns_settings": {
                "nlive": "80",
                "boost_nlive": "160",
                "boost_num_repeats": "24",
                "boost_start_mass": "0.05",
                "bracket": "stepout",
                "stepout_w": "1.5",
                "stepout_budget": "8",
            },
        },
        ndim=4,
    )
    assert plan.dynamic
    assert plan.boost_start_mass == 0.05
    assert plan.boost_config is not None
    assert plan.boost_config.nlive == 160
    assert plan.boost_config.num_repeats == 24
    assert plan.cfg.nlive == 80
    assert plan.cfg.bracket == "stepout"
    assert plan.cfg.stepout_w == 1.5
    assert plan.cfg.stepout_budget == 8
    # dynamic_goal (reference cli.py:135-156) maps onto boost_start_mass
    plan = solver_nsconfig(
        {"solver": "dypolychord", "pc_settings": {"dynamic_goal": "0.25"}},
        ndim=4,
    )
    assert plan.boost_start_mass == pytest.approx(0.0025)


def test_specfile_list_and_glob(tmp_path):
    for name in ("s1.txt", "s2.txt", "other.dat"):
        (tmp_path / name).write_text("1 1 1\n")
    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        f"""
[input]
specfile = s*.txt, other.dat
wavefit = 6180,6220
linelist = CIV 1548

[pathing]
datadir = {tmp_path}/
"""
    )
    pars = readconfig(str(cfg))
    names = [p.rsplit("/", 1)[-1] for p in pars["specfiles"]]
    assert names == ["s1.txt", "s2.txt", "other.dat"]
    assert pars["specfile"].endswith("s1.txt")  # back-compat: first entry


def test_specfile_single_unchanged(tmp_path):
    (tmp_path / "one.txt").write_text("1 1 1\n")
    cfg = tmp_path / "c.cfg"
    cfg.write_text(
        f"""
[input]
specfile = one.txt
wavefit = 6180,6220
linelist = CIV 1548

[pathing]
datadir = {tmp_path}/
"""
    )
    pars = readconfig(str(cfg))
    assert pars["specfiles"] == [pars["specfile"]]
    assert pars["specfile"].endswith("one.txt")


def test_compile_cache_surface(tmp_path, monkeypatch):
    # Config key round-trips; default is unset.
    p = tmp_path / "cc.cfg"
    p.write_text(
        "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"
        f"[run]\ncompile_cache = {tmp_path}/cc\n"
    )
    assert readconfig(str(p))["compile_cache"] == f"{tmp_path}/cc"
    p.write_text(
        "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"
    )
    assert readconfig(str(p))["compile_cache"] is None

    # The utility creates the directory and points jax at it; 'off'
    # sentinels disable.  Global jax.config is restored afterwards.
    import jax

    from mcalf_tpu.utils import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old_dir = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        got = enable_compile_cache(str(tmp_path / "cc"))
        assert got == str(tmp_path / "cc")
        assert (tmp_path / "cc").is_dir()
        assert jax.config.jax_compilation_cache_dir == got
        assert enable_compile_cache("off") is None
        assert enable_compile_cache("") is None  # empty env fallthrough
        # off-sentinels are case/whitespace-insensitive: OFF must not
        # create and use a cache directory literally named 'OFF'
        for s in ("OFF", "None", "FALSE", " Off ", "0"):
            assert enable_compile_cache(s) is None, s
        assert not (tmp_path / "OFF").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", old_dir)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs", old_min
        )


def test_transdim_default_counts_as_difficult():
    """Unset num_repeats on a variable-ncomp model doubles the calibrated
    default (round-5 rung recalibration: 8*ndim repeats carries a
    -1.66 +/- 0.66 nat bias on the flagship; 16*ndim converges)."""
    from types import SimpleNamespace

    from mcalf_tpu.runner import solver_nsconfig, transdim_counts_as_difficult

    plan = solver_nsconfig({"solver": "polychord"}, ndim=34)
    assert transdim_counts_as_difficult(
        plan.cfg, SimpleNamespace(ncomp=(8, 11))
    )
    # fixed-ncomp models keep the 12*ndim anchor calibration
    assert not transdim_counts_as_difficult(
        plan.cfg, SimpleNamespace(ncomp=(2, 2))
    )
    # explicit settings always win
    plan2 = solver_nsconfig(
        {"solver": "polychord", "pc_settings": {"num_repeats": 170}}, ndim=34
    )
    assert not transdim_counts_as_difficult(
        plan2.cfg, SimpleNamespace(ncomp=(8, 11))
    )


@pytest.mark.parametrize(
    "env, explicit, want",
    [
        ("env", "explicit", "env"),      # placed from outside: always wins
        ("env", "off", "env"),
        (None, "explicit", "explicit"),  # then [run] compile_cache
        (None, "off", None),             # 'off' disables
        (None, None, "default"),         # then the checkout's fixed path
    ],
)
def test_cache_dir_resolution_order(tmp_path, monkeypatch, env, explicit, want):
    import tempfile

    from mcalf_tpu.utils.compile_cache import DEFAULT_CACHE_DIR, resolve_cache_dir

    paths = {"env": str(tmp_path / "env"), "explicit": str(tmp_path / "exp")}
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", paths[env])
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = resolve_cache_dir(paths.get(explicit, explicit))
    assert got == (DEFAULT_CACHE_DIR if want == "default" else paths.get(want))
    # the fixed path sits in the checkout, never in a temporary directory
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert DEFAULT_CACHE_DIR == os.path.join(repo, ".jax_cache")
    assert not DEFAULT_CACHE_DIR.startswith(tempfile.gettempdir())


def test_cli_run_puts_cache_entries_where_the_env_says(tmp_path, testdata_dir):
    """A CLI fit (in its own process, so this worker's JAX config is left
    alone) writes its compile-cache entries to JAX_COMPILATION_CACHE_DIR."""
    import subprocess
    import sys

    cfg = tmp_path / "fit.cfg"
    cfg.write_text(
        f"""
[input]
specfile = civ_mock_spec.txt
wavefit = 6180,6220
linelist = CIV 1548, CIV 1550
coldef = Wave, Flux, Err
solver = ns
specres = 8.0

[pathing]
datadir = {testdata_dir}/
outdir = {tmp_path}/out/
chainfmt = cc_{{0}}

[components]
ncomp = 1,1
contval = 1
Nrange = 13.0,14.5
brange = 10.0,30.0
zrange = 2.999,3.001

[run]
dofit = True
doplot = False

[ns_settings]
nlive = 20
num_repeats = 4
max_samples = 400
precision_criterion = 0.5
"""
    )
    cache = tmp_path / "cc"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache)
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "mcalf_tpu", "--debug", str(cfg)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert f"persistent compile cache at {cache}" in r.stdout
    assert "Fitting on cpu" in r.stdout
    assert any(cache.iterdir()), "no cache entries written"


def test_cli_without_matplotlib_stops_before_the_fit(tmp_path, monkeypatch):
    """matplotlib is an optional extra: with doplot on and no matplotlib the
    CLI stops with one clear message before fitting anything."""
    import importlib.util

    from mcalf_tpu import cli

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a, **k: None if name == "matplotlib" else real(name, *a, **k),
    )
    cfg = tmp_path / "p.cfg"
    cfg.write_text(
        "[input]\nspecfile = s.txt\nwavefit = 1, 2\nlinelist = CIV 1548\n"
        f"[pathing]\noutdir = {tmp_path}/out/\n"
        "[run]\ndoplot = True\n"
    )
    with pytest.raises(SystemExit, match="matplotlib"):
        cli.main([str(cfg)])
    assert not (tmp_path / "out" / "fits").exists() or not any(
        (tmp_path / "out" / "fits").iterdir()
    )
