"""Case-runner CLI: the executable surface of the reference solvers.

Every reference application is a binary run inside a case directory whose
`system/controlDict` drives the time loop: startFrom/startTime, endTime,
writeControl/writeInterval, adjustTimeStep (QGDFoam_8C_source.html:90-163,
setDeltaT-QGDQHD_8H).  This module reproduces that surface:

    python -m qgdsolver_tpu <case_dir> [--max-steps N] [--chunk K]

dispatches on `application`, runs jitted chunks of K steps (one lax.scan
each — the adaptive dt stays on device), writes OpenFOAM-format time
directories via io.foam_write whenever the solution time crosses the next
write threshold (adjustableRunTime semantics up to chunk granularity;
writeControl timeStep counts steps), and prints the reference-style Info
lines (Time/deltaT) per chunk.
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np


def _state_time(state) -> float:
    tv = state.t if hasattr(state, "t") else state.fluid.t
    return float(np.asarray(tv))


def _state_dt(state) -> float:
    dv = state.dt if hasattr(state, "dt") else state.fluid.dt
    return float(np.asarray(dv))


def run_case(case_dir: str, max_steps=None, chunk: int = 50,
             log=print, devices=None) -> int:
    """Run the case to controlDict endTime; returns the step count.

    Every solver runs its composable step (`solver.make_step()`).

    devices: "PXxPY" decomposes the case over a (PX, PY) device mesh — the
    reference's `decomposePar + mpirun <solver>` workflow (SURVEY.md §2.4)
    — through the shard_map decomposition of the composable step
    (parallel.sharding.build_spmd_step).  Field writes gather
    transparently (shard_map outputs are global arrays).
    """
    import jax

    if devices:
        px, py = (int(v) for v in str(devices).lower().split("x"))
        if len(jax.devices()) < px * py:
            try:  # CPU backend: raise the virtual device count
                jax.config.update("jax_num_cpu_devices", px * py)
            except Exception:  # noqa: BLE001 — backend already initialised
                pass
        if len(jax.devices()) < px * py:
            raise SystemExit(
                f"--devices {devices}: only {len(jax.devices())} devices "
                "available")

    from .io import foam_case, foam_write, foamdict
    from .solvers import common
    import os

    solver, state = foam_case.build_case(case_dir)
    control = foamdict.parse_file(
        os.path.join(case_dir, "system", "controlDict"))
    end_time = float(control.get("endTime", math.inf))
    write_control = str(control.get("writeControl", "adjustableRunTime"))
    if isinstance(control.get("writeControl"), list):
        write_control = str(control["writeControl"][0])
    write_interval = float(control.get("writeInterval", 0.0) or 0.0)

    if devices:
        from .parallel import sharding as shd
        from .solvers import particles as prt

        dmesh = shd.make_device_mesh(jax.devices()[: px * py],
                                     shape=(px, py), axis_names=("X", "Y"))
        if isinstance(state, prt.PState):
            # decomposePar of the cloud: slot blocks ordered by the
            # parcels' resident shard
            state = state._replace(cloud=prt.distribute_cloud(
                state.cloud, solver.mesh, dmesh))
        step, to_spmd = shd.build_spmd_step(solver, dmesh, state)
        state = to_spmd(state)
        log("shard_map decomposition engaged (%dx%d mesh)" % (px, py))
    else:
        step = solver.make_step()
    run = jax.jit(lambda s: common.run_steps(step, s, chunk))

    t = _state_time(state)
    n_steps = 0
    by_steps = write_control == "timeStep"
    next_write = None
    if write_interval > 0.0:
        next_write = (n_steps + write_interval if by_steps
                      else t + write_interval)

    def write():
        tdir = foam_write.write_state(case_dir, solver, state)
        log("writing fields to %s" % tdir)
        return tdir

    adjustable = (not by_steps
                  and getattr(solver, "time", None) is not None
                  and solver.time.adjust_time_step)

    def _set_dt(s, dt_val):
        # carried-dt surgery between jitted chunks (no recompile): the
        # controller's growth cap is exactly 1.2x, so seeding
        # dt = (target - t)/1.2 makes the next step land ON the target
        # when the CFL allows — Time::adjustDeltaT parity
        # (setDeltaT-QGDQHD_8H_source.html + adjustableRunTime)
        import jax.numpy as jnp

        if hasattr(s, "dt"):
            return s._replace(dt=jnp.asarray(dt_val, dtype=s.dt.dtype))
        return s._replace(fluid=s.fluid._replace(
            dt=jnp.asarray(dt_val, dtype=s.fluid.dt.dtype)))

    run1 = jax.jit(lambda s: common.run_steps(step, s, 1))

    t_wall = time.perf_counter()
    while t < end_time and (max_steps is None or n_steps < max_steps):
        target = end_time
        if adjustable and next_write is not None:
            target = min(target, next_write)
        k = chunk if max_steps is None else min(chunk, max_steps - n_steps)
        dt_cur = max(_state_dt(state), 1e-300)
        if math.isfinite(target):
            remaining = target - t
            if adjustable and remaining <= dt_cur * 1.2 * (1 + 1e-12):
                # landing step: trim dt to hit the write/end instant
                state = _set_dt(state, remaining / 1.2)
                state = jax.block_until_ready(run1(state))
                n_steps += 1
                t = _state_time(state)
                log("Time = %.8g  deltaT = %.8g  (%d steps, %.1f s)"
                    % (t, _state_dt(state), n_steps,
                       time.perf_counter() - t_wall))
                if next_write is not None and t >= next_write * (1 - 1e-9):
                    write()
                    while next_write <= t * (1 + 1e-9):
                        next_write += write_interval
                continue
            # bound the chunk so the run approaches the next stop without
            # overshooting it; dt may grow 1.2x per step COMPOUNDING, so
            # the k-step distance is at most dt*1.2*(1.2^k - 1)/0.2
            if adjustable:
                k_geo = int(math.log(remaining * (0.2 / 1.2) / dt_cur + 1.0)
                            / math.log(1.2))
                k = max(1, min(k, k_geo))
            else:
                k = max(1, min(k, int(remaining / dt_cur) + 1))
        state = run(state) if k == chunk else jax.jit(
            lambda s, _k=k: common.run_steps(step, s, _k))(state)
        state = jax.block_until_ready(state)
        n_steps += k
        t = _state_time(state)
        log("Time = %.8g  deltaT = %.8g  (%d steps, %.1f s)"
            % (t, _state_dt(state), n_steps, time.perf_counter() - t_wall))
        if next_write is not None:
            due = (n_steps >= next_write) if by_steps else (t >= next_write)
            if due:
                write()
                while by_steps and next_write <= n_steps:
                    next_write += write_interval
                while not by_steps and next_write <= t:
                    next_write += write_interval
    tdir = write()
    log("End.  Final fields in %s" % tdir)
    return n_steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m qgdsolver_tpu",
        description="Run an OpenFOAM-layout QGD/QHD case directory "
                    "(application from system/controlDict).")
    ap.add_argument("case", help="case directory")
    ap.add_argument("--max-steps", type=int, default=None,
                    help="stop after N steps even before endTime")
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps per jitted lax.scan chunk (default 50)")
    ap.add_argument("--devices", default=None, metavar="PXxPY",
                    help="decompose the case over a (PX, PY) device mesh "
                         "(the decomposePar + mpirun workflow), e.g. 4x2")
    args = ap.parse_args(argv)
    from .utils import compile_cache

    compile_cache.enable()
    run_case(args.case, max_steps=args.max_steps, chunk=args.chunk,
             devices=args.devices)
    return 0


if __name__ == "__main__":
    sys.exit(main())
