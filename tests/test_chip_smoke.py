"""chip_smoke.py's parts that a CPU can check: the device refusal, the
case writer, the main path at a tiny size, the reference comparator, the
physics checks, the phase selection and the shape of the last line.  The
phases at full size run only on the GPU, through `python chip_smoke.py`."""
import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from qgdsolver_tpu.io import foam_case  # noqa: E402
from qgdsolver_tpu.physics.qgdcoeffs import VarScModel5  # noqa: E402
from qgdsolver_tpu.solvers import common  # noqa: E402


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert "not a GPU" in str(exc.value)


def test_main_refuses_the_cpu_and_prints_no_result(capsys):
    cache_dir = jax.config.jax_compilation_cache_dir
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out
    # refused before the compile cache was touched
    assert jax.config.jax_compilation_cache_dir == cache_dir


@pytest.mark.parametrize("cells", [(12, 6, 4), (16, 8, 1)])
def test_written_case_builds_and_steps(tmp_path, cells):
    """The case writer's dictionaries build the flagship configuration
    (varScModel5, qgdFlux on the x_hi patch, Mach-2 inflow) and step."""
    case = chip_smoke.write_case(str(tmp_path / "case"), cells,
                                 (4.0, 2.0, 2.0))
    solver, state = foam_case.build_case(case)
    nd = 2 if cells[2] == 1 else 3
    assert solver.mesh.shape == cells[:nd]
    assert isinstance(solver.tau_model, VarScModel5)
    assert solver._flux_sides() == ((0, 1),)
    s = common.run_steps(jax.jit(solver.make_step()), state, 5)
    assert np.isfinite(np.asarray(s.rho)).all()
    assert float(s.t) > 0.0


@pytest.mark.parametrize("cells", [(24, 8, 8), (32, 16, 1)])
def test_main_path_tiny(tmp_path, monkeypatch, cells):
    """The main path at a tiny size: cli.run_case, one write at the end,
    the written fields read back and physically sane."""
    monkeypatch.setattr(chip_smoke, "WORK_DIR", str(tmp_path))
    r = chip_smoke.main_path("test card", cells=cells,
                             lengths=(4.0, 2.0, 2.0), steps=30, chunk=10)
    assert r["steps_per_s"] > 0.0
    assert 1.0 < r["mach_max"] <= 3.5
    assert r["e_min"] > 0.0
    written = [d for d in os.listdir(tmp_path / "main_path")
               if d not in ("0", "system", "constant")]
    assert len(written) == 1  # the run writes once, at its end


def _fields(n=8, mach=2.0, T=300.0):
    c = np.sqrt(chip_smoke.GAMMA * chip_smoke.R_GAS * T)
    U = np.zeros((3, n))
    U[0, 0] = mach * c
    return {"U": U, "p": np.full(n, 1e5), "T": np.full(n, T)}


def test_check_physics_accepts_a_jet():
    r = chip_smoke.check_physics(_fields())
    assert r["mach_max"] == pytest.approx(2.0)


@pytest.mark.parametrize("bad", ["nan", "cold", "subsonic", "hypersonic"])
def test_check_physics_rejects(bad):
    f = _fields(mach={"subsonic": 0.5, "hypersonic": 4.0}.get(bad, 2.0))
    if bad == "nan":
        f["p"][3] = np.nan
    if bad == "cold":
        f["T"][2] = -1.0
    with pytest.raises(AssertionError):
        chip_smoke.check_physics(f)


def test_compare_devices_cpu_against_cpu():
    """The comparator itself: the same step on two CPU devices agrees to
    the bit, and the compiled step holds no matrix product."""
    cpu = jax.devices("cpu")
    r = chip_smoke.compare_devices(cpu[0], cpu[-1], shape=(32, 16),
                                   n_steps=5)
    assert r["rel_linf"] == {"rho": 0.0, "rhoU": 0.0, "rhoE": 0.0,
                             "t": 0.0}
    assert r["t"] == r["t_ref"] > 0.0
    assert r["matrix_product"] is False


@pytest.mark.parametrize("with_dot", [True, False])
def test_has_matrix_product(with_dot):
    a = np.ones((8, 8), np.float32)
    f = (lambda x: x @ x) if with_dot else (lambda x: x * x + 1.0)
    hlo = jax.jit(f).lower(a).compile().as_text()
    assert chip_smoke.has_matrix_product(hlo) is with_dot


def test_rel_linf():
    a = np.array([1.0, -4.0, 2.0])
    assert chip_smoke.rel_linf(a, a) == 0.0
    assert chip_smoke.rel_linf(a, a + [0.0, 0.0, 0.04]) == pytest.approx(0.01)


@pytest.mark.parametrize("argv, names", [
    ([], ["main_path", "reference_phase"]),
    (["--four-cards"], ["four_card_phase"]),
])
def test_phase_selection(argv, names):
    args = chip_smoke.parse_args(argv)
    assert [p.__name__ for p in chip_smoke.phases(args.four_cards)] == names


def test_last_line_shape():
    line = chip_smoke.last_line(chip_smoke.device_summary())
    d = json.loads(line)
    assert d == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}
    assert "\n" not in line


def test_latest_time_dir(tmp_path):
    for d in ("0", "system", "constant", "0.0005", "0.002", "0.0011"):
        (tmp_path / d).mkdir()
    assert chip_smoke.latest_time_dir(str(tmp_path)) == "0.002"


def test_four_card_phase_on_virtual_devices(tmp_path, monkeypatch):
    """The four-card phase's path on four virtual CPU devices: both cases
    decomposed (2x2 in 3D, 4x1 in 2D) write the one-device fields."""
    if len(jax.devices("cpu")) < 4:
        pytest.skip("needs 4 virtual devices")
    monkeypatch.setattr(chip_smoke, "WORK_DIR", str(tmp_path))
    r = chip_smoke.four_card_phase("test card", cells3=(16, 8, 8),
                                   cells2=(32, 16, 1), steps=20, chunk=10)
    for name in ("flagship3d", "flagship2d"):
        assert max(r[name]["rel_linf"].values()) <= \
            chip_smoke.DECOMPOSED_RTOL
