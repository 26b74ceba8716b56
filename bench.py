"""Benchmark: QGDFoam composable-step throughput (grid points/s per card).

    python bench.py

Prints ONE JSON line: {"metric", "value", "unit", device fields, extras}.
Each section is failure-isolated: a crash in one records an
"<name>_error" extra instead of destroying the others, and a partial JSON
line is flushed after each section so a hard process death later still
leaves a parseable artifact (the LAST printed line is the most complete).

Sections, all on the composable XLA step (`solver.make_step()`):
  * primary (the headline value): 1024x512 plain supersonic jet;
  * big grid ("big_*"): 4096x2048 shock-capturing jet (varScModel5 +
    qgdFlux outflow), and the same grid with plain physics;
  * 3D ("3d_*"): 256x126x126 duct and the 3D varScModel5 + qgdFlux jet.

Every section reports points/s (best and median of its repeats), the
spread (max-min)/median, and XLA's cost-model bytes accessed per grid
point per step (`compiled.cost_analysis()`), the figure to hold against
the card's memory bandwidth.  The line names the device (`platform`,
`device_kind`, `device_count`, and `nvidia-smi`'s name and power limit).

The exit code is 1 when JAX's backend is not a GPU (no section runs: the
CPU is not the measured device) or when any section recorded an error;
the JSON line is printed either way.
"""
from __future__ import annotations

import json
import sys
import time
import traceback

import jax
import numpy as np


def _measure(solver, state, n_steps, repeats=3):
    """Best/median points/s of `repeats` timed scans of `n_steps` steps
    (compile + one warm-up scan excluded), spread, and XLA's bytes
    accessed per point for one step."""
    from qgdsolver_tpu.solvers import common

    step = solver.make_step()
    points = int(np.prod(solver.mesh.shape))
    cost = jax.jit(step).lower(state).compile().cost_analysis()
    bytes_pp = float(cost["bytes accessed"]) / points

    run = jax.jit(lambda s: common.run_steps(step, s, n_steps))
    state = jax.block_until_ready(run(state))  # compile + warm-up
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state = jax.block_until_ready(run(state))
        times.append(time.perf_counter() - t0)
    pps = sorted(points * n_steps / t for t in times)
    med = pps[len(pps) // 2]
    return {"points_per_s": pps[-1], "median": med,
            "spread": (pps[-1] - pps[0]) / med,
            "bytes_per_point": bytes_pp}


def _err(e) -> str:
    return "%s: %s" % (type(e).__name__, str(e)[:300])


def device_info() -> dict:
    from qgdsolver_tpu.utils import observability

    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs),
            "gpu": observability.gpu_name_and_power_limit()}


SECTIONS = (
    # (prefix, `cases` function, shape, steps per scan, repeats)
    ("primary", "supersonic_jet", (1024, 512), 500, 5),
    ("big", "supersonic_jet_varsc", (4096, 2048), 60, 3),
    ("big_plain", "supersonic_jet", (4096, 2048), 60, 3),
    ("3d", "supersonic_duct_3d", (256, 126, 126), 60, 3),
    ("3d_varsc", "supersonic_jet_3d_varsc", (256, 126, 126), 60, 3),
)


def main() -> int:
    out = {"metric": "qgdfoam_jet_grid_points_per_s_per_chip",
           "value": 0.0, "unit": "points/s"}
    out.update(device_info())
    if jax.default_backend() != "gpu":
        out["backend_error"] = (
            "backend %r is not a GPU; nothing measured"
            % jax.default_backend())
        print(json.dumps(out), flush=True)
        return 1

    from qgdsolver_tpu import cases
    from qgdsolver_tpu.utils import compile_cache

    compile_cache.enable()
    for prefix, maker, shape, n_steps, repeats in SECTIONS:
        try:
            solver, state = getattr(cases, maker)(shape=shape,
                                                  dtype=np.float32)
            r = _measure(solver, state, n_steps, repeats)
            if prefix == "primary":
                out["value"] = r.pop("points_per_s")
            out.update({f"{prefix}_{k}": v for k, v in r.items()})
            out[f"{prefix}_grid"] = "x".join(map(str, shape)) + " " + maker
        except Exception as e:  # noqa: BLE001 — per-section isolation
            out[f"{prefix}_error"] = _err(e)
            traceback.print_exc(file=sys.stderr)
        print(json.dumps(out), flush=True)
    return 1 if any(k.endswith("_error") for k in out) else 0


if __name__ == "__main__":
    sys.exit(main())
