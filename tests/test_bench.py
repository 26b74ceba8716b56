"""bench.py: refuses a non-GPU backend (still printing its JSON line),
measures a tiny case on the CPU through the same code, and every section
names a `cases` function whose case builds and steps."""
import json
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench  # noqa: E402
from qgdsolver_tpu import cases  # noqa: E402


def test_refuses_a_non_gpu_backend(capsys):
    cache_dir = jax.config.jax_compilation_cache_dir
    assert bench.main() == 1
    lines = capsys.readouterr().out.strip().splitlines()
    d = json.loads(lines[-1])
    assert d["platform"] == "cpu"
    assert d["device_count"] == len(jax.devices())
    assert "not a GPU" in d["backend_error"]
    assert d["value"] == 0.0
    assert not any(k.endswith("_points_per_s") for k in d)
    assert jax.config.jax_compilation_cache_dir == cache_dir


def test_measure_reports_rates_and_bytes():
    solver, state = cases.supersonic_jet(shape=(32, 16), dtype=np.float32)
    r = bench._measure(solver, state, n_steps=3, repeats=2)
    assert set(r) == {"points_per_s", "median", "spread", "bytes_per_point"}
    assert r["points_per_s"] >= r["median"] > 0.0
    assert r["spread"] >= 0.0
    # the step reads and writes at least its own state (rho, rhoU, rhoE)
    assert r["bytes_per_point"] > 2 * 4 * 4


@pytest.mark.parametrize("section", bench.SECTIONS,
                         ids=[s[0] for s in bench.SECTIONS])
def test_section_case_builds_and_steps(section):
    _, maker, shape, n_steps, repeats = section
    assert n_steps > 0 and repeats >= 3
    tiny = (16, 8) if len(shape) == 2 else (8, 6, 6)
    solver, state = getattr(cases, maker)(shape=tiny, dtype=np.float32)
    s = jax.jit(solver.make_step())(state)
    assert np.isfinite(np.asarray(s.rho)).all()
    assert s.rho.dtype == np.float32
