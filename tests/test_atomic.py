"""Sanity checks on the bundled atomic-line database.

The reference trusts linetools for these numbers (hires_fitter.py:90-113);
since we bundle them, physical-consistency invariants stand in for the
upstream library's curation: alkali-doublet f-ratios, Lyman-series
monotonicity, and the ALIS CrII overrides the reference applies by hand.
"""

import numpy as np
import pytest

from mcalf_tpu.atomic import get_line, get_lines
from mcalf_tpu.atomic.data import (
    LineNotFoundError,
    available_lines,
    load_atomfile,
    register_line,
)


def test_every_line_physical():
    for name in available_lines():
        ln = get_line(name)
        assert 900.0 < ln.wrest < 10000.0, name
        assert 0.0 < ln.f <= 2.2, name
        # high-order Lyman gammas reach ~5e5; SiII* 1194 is 3.45e9
        assert 1.0e5 < ln.gamma < 4.0e9, name
        ion, label = name.split()
        # name convention: label is the truncated rest wavelength
        assert abs(float(label) - ln.wrest) < 1.0, name


def test_breadth_vs_linetools_namespace():
    # Coverage target: >= 150 transitions so the
    # common linetools-ISM names a reference config can ask for resolve.
    names = available_lines()
    assert len(names) >= 150, len(names)
    ions = {n.split()[0] for n in names}
    for ion in ("HI", "DI", "CI", "CI*", "CI**", "CII*", "SiII*", "OI*",
                "PII", "PV", "ArI", "NII", "NIII", "SIII", "SIV", "SVI",
                "FeII", "FeIII", "NiII", "MnII", "TiII"):
        assert ion in ions, ion


@pytest.mark.parametrize(
    "strong,weak",
    [
        ("CIV 1548", "CIV 1550"),
        ("MgII 2796", "MgII 2803"),
        ("SiIV 1393", "SiIV 1402"),
        ("OVI 1031", "OVI 1037"),
        ("NV 1238", "NV 1242"),
        ("CaII 3934", "CaII 3969"),
        ("NaI 5891", "NaI 5897"),
        ("AlIII 1854", "AlIII 1862"),
        ("PV 1117", "PV 1128"),
        ("SVI 933", "SVI 944"),
    ],
)
def test_doublet_f_ratio_near_two(strong, weak):
    # s1/2 -> p3/2,p1/2 alkali-like doublets have f_strong/f_weak = 2
    # to within a few percent relativistic correction.
    s, w = get_line(strong), get_line(weak)
    assert s.wrest < w.wrest
    assert 1.8 < s.f / w.f < 2.2, (strong, weak, s.f / w.f)


def test_lyman_series_monotone():
    names = [
        "HI 1215", "HI 1025", "HI 972", "HI 949", "HI 937", "HI 930",
        "HI 926", "HI 923", "HI 920", "HI 919", "HI 918", "HI 917",
        "HI 916", "HI 915", "HI 915.3", "HI 914.9", "HI 914.5",
        "HI 914.2", "HI 914.0",
    ]
    lines = get_lines(names)
    wrest = np.array([l.wrest for l in lines])
    f = np.array([l.f for l in lines])
    gam = np.array([l.gamma for l in lines])
    assert (np.diff(wrest) < 0).all()
    assert (np.diff(f) < 0).all()
    assert (np.diff(gam) < 0).all()
    assert wrest[-1] > 911.75  # series limit


def test_deuterium_mirrors_hydrogen():
    for hn, dn in (("HI 1215", "DI 1215"), ("HI 1025", "DI 1025"),
                   ("HI 972", "DI 972"), ("HI 949", "DI 949"),
                   ("HI 937", "DI 937")):
        h, d = get_line(hn), get_line(dn)
        assert d.f == h.f and d.gamma == h.gamma
        # isotope shift: ~0.33 A blueward at Ly-a, scaling with wrest
        assert 0.15 < h.wrest - d.wrest < 0.5, (hn, dn)


def test_fine_structure_families():
    # excited fine-structure entries sit within a few A of their
    # ground-level parent and share its upper-level width
    assert abs(get_line("CI* 1656.2").wrest - get_line("CI 1656").wrest) < 2
    assert get_line("CI* 1656.2").gamma == get_line("CI 1656").gamma
    assert abs(get_line("OI* 1304").wrest - get_line("OI 1302").wrest) < 4
    assert abs(get_line("SiII* 1264").wrest - get_line("SiII 1260").wrest) < 6
    assert abs(get_line("SiII* 1533").wrest - get_line("SiII 1526").wrest) < 8
    assert abs(get_line("CII* 1335").wrest - get_line("CII 1334").wrest) < 2


def test_ni_1200_alias():
    assert get_line("NI 1200.2").wrest == get_line("NI 1200").wrest
    assert get_line("NI 1200.2").f == get_line("NI 1200").f
    assert get_line("NI 1200.7").wrest != get_line("NI 1200").wrest


def test_crii_carries_alis_overrides():
    # the reference patches these in by hand (hires_fitter.py:102-110)
    assert get_line("CrII 2056").f == pytest.approx(0.103)
    assert get_line("CrII 2062").f == pytest.approx(0.0759)
    assert get_line("CrII 2066").f == pytest.approx(0.0512)


def test_unknown_line_raises_with_catalog():
    with pytest.raises(LineNotFoundError, match="CIV 1548"):
        get_line("XYZ 9999")


def test_register_and_atomfile_roundtrip(tmp_path):
    register_line("FAKE 1000", 1000.5, 0.1, 1e8)
    assert get_line("FAKE 1000").wrest == 1000.5
    p = tmp_path / "atoms.txt"
    p.write_text("# comment\nFAKE 2000 2000.25 0.2 2e8\n")
    assert load_atomfile(str(p)) == 1
    assert get_line("FAKE 2000").f == pytest.approx(0.2)
