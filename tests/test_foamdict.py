"""OpenFOAM dictionary parser tests (native C++ + Python fallback)."""
import numpy as np
import pytest

from qgdsolver_tpu.io import foamdict, foam_case
from qgdsolver_tpu.physics.qgdcoeffs import VarScModel5

CONTROL_DICT = """
/*--------------------------------*- C++ -*----------------------------------*\\
| =========                 |                                                 |
\\*---------------------------------------------------------------------------*/
FoamFile
{
    version     2.0;
    format      ascii;
    class       dictionary;
    object      controlDict;
}
// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //

application     QGDFoam;
startTime       0;
endTime         0.03;
deltaT          1e-08;
adjustTimeStep  yes;
maxCo           0.2;
maxDeltaT       0.001;
cTau            0.5;
writeControl    adjustableRunTime;
functions
{
    fieldAverage1
    {
        type            fieldAverage;
        fields          ( U p );
    }
}
"""

FV_SCHEMES = """
fvsc
{
    default GaussVolPoint;
    grad(p) leastSquares;
}
divSchemes
{
    default         none;
}
"""

THERMO = """
thermoType
{
    type            hePsiQGDThermo;
    mixture         pureMixture;
    transport       const;
    thermo          hConst;
    equationOfState perfectGas;
    specie          specie;
    energy          sensibleInternalEnergy;
}
QGD
{
    implicitDiffusion false;
    QGDCoeffs varScModel5;
    aQGD   0.3;
    rC     0.05;
    minSc  0.0;
    maxSc  2.0;
}
mixture
{
    specie      { nMoles 1; molWeight 28.96; }
    thermodynamics { Cp 1005; Hf 0; }
    transport   { mu 1.8e-05; Pr 0.7; beta [0 0 0 -1 0 0 0] 3e-03; }
}
"""


@pytest.mark.parametrize("use_native", [True, False])
def test_parse_control_dict(use_native):
    if use_native and not foamdict.native_available():
        pytest.skip("no native parser")
    d = (foamdict.parse(CONTROL_DICT) if use_native
         else foamdict._parse_py(CONTROL_DICT))
    assert d["application"] == "QGDFoam"
    assert d["adjustTimeStep"] is True
    assert float(d["maxCo"]) == 0.2
    assert float(d["deltaT"]) == 1e-8
    assert d["functions"]["fieldAverage1"]["fields"] == ["U", "p"]


def test_native_matches_python():
    if not foamdict.native_available():
        pytest.skip("no native parser")
    for text in (CONTROL_DICT, FV_SCHEMES, THERMO):
        a = foamdict.parse(text)
        b = foamdict._parse_py(text)
        # normalize ints/floats
        import json
        assert json.loads(json.dumps(a)) == json.loads(json.dumps(b))


def test_case_mapping():
    tc = foam_case.time_controls(foamdict._parse_py(CONTROL_DICT))
    assert tc.adjust_time_step and tc.max_co == 0.2 and tc.c_tau == 0.5
    scheme = foam_case.fvsc_scheme(foamdict._parse_py(FV_SCHEMES))
    assert scheme == "full"
    th = foamdict._parse_py(THERMO)
    tau = foam_case.tau_model(th)
    assert isinstance(tau, VarScModel5)
    assert np.isclose(tau.alpha, 0.3) and np.isclose(tau.rC, 0.05)
    assert foam_case.implicit_diffusion(th) is False
    # dimensioned scalar parsed: beta [dims] value
    beta = th["mixture"]["transport"]["beta"]
    assert beta[0]["__dims__"] == [0, 0, 0, -1, 0, 0, 0]
    assert float(beta[1]) == 3e-3


@pytest.mark.parametrize("layout, stale", [
    ("no_library", True),
    ("library_older", True),
    ("library_newer", False),
    ("no_source", False),
])
def test_native_library_staleness(tmp_path, layout, stale):
    """The library is rebuilt when it is missing or older than the
    committed foamdict.cpp, and never without a source to build from."""
    import os

    so, src = tmp_path / "libfoamdict.so", tmp_path / "foamdict.cpp"
    if layout != "no_source":
        src.write_text("// source\n")
        os.utime(src, (2_000_000, 2_000_000))
    if layout != "no_library":
        so.write_text("")
        t = 1_000_000 if layout == "library_older" else 3_000_000
        os.utime(so, (t, t))
    assert foamdict._stale(str(so), str(src)) is stale


def test_stale_native_library_is_rebuilt(tmp_path, monkeypatch):
    """A library older than foamdict.cpp (here a broken file) is rebuilt
    from the source and loads, so the parser always matches the source."""
    import os
    import shutil

    shutil.copy(os.path.join(foamdict._NATIVE_DIR, "foamdict.cpp"),
                tmp_path / "foamdict.cpp")
    so = tmp_path / "libfoamdict.so"
    so.write_text("not a library")
    os.utime(so, (1_000_000, 1_000_000))
    monkeypatch.setattr(foamdict, "_NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(foamdict, "_TRIED", False)
    monkeypatch.setattr(foamdict, "_LIB", None)
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler")
    assert foamdict.native_available()
    assert not foamdict._stale(str(so), str(tmp_path / "foamdict.cpp"))
    assert foamdict.parse("a 1; b { c (1 2); }") == {"a": 1,
                                                     "b": {"c": [1, 2]}}
    assert [p.name for p in tmp_path.iterdir() if p.suffix == ".tmp"] == []
