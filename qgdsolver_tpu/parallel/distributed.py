"""Multi-process bring-up + scaling measurement harness.

The reference scales across nodes with decomposePar + mpirun (SURVEY.md
§2.4); the counterpart here is one JAX process per host joined by
`jax.distributed`, with the device mesh laid out so that most halo
exchanges stay between the devices of one host.  This module provides:

* `initialize()` — jax.distributed bring-up with env-var fallbacks, safe to
  call unconditionally (no-op for single-process runs);
* `host_mesh()` — an (X, Y) device mesh whose X axis is contiguous within
  each host's local devices (halo ppermutes over X stay inside a host; only
  the Y boundary between host blocks crosses the network);
* `measure_scaling()` — points/s/device for a solver step over a device
  mesh vs the single-device run — the measurable stand-in for BASELINE.md's
  weak-scaling row (>=80% at N hosts) until multi-host hardware exists.
"""
from __future__ import annotations

import os
import time
import typing as tp

import jax
import numpy as np

from . import sharding as shd


def initialize(coordinator_address: tp.Optional[str] = None,
               num_processes: tp.Optional[int] = None,
               process_id: tp.Optional[int] = None) -> bool:
    """Bring up jax.distributed for a multi-host run.

    Resolution order: explicit args -> JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID env vars.  Without either, nothing
    is initialized: a plain GPU host has no cluster to detect, so a
    multi-process run names its coordinator (`localhost:<port>` on one
    host), process count and process id.  Returns
    True when a multi-process world was initialized, False for single-process
    (in which case nothing was touched — the single-chip path is unchanged).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def host_mesh(axis_names=("X", "Y")):
    """Device mesh with X contiguous inside each host.

    jax.devices() orders devices process-major on multi-host systems, so
    reshaping (num_hosts, devices_per_host) and using the per-host axis as
    the mesh's X keeps the X halo ring inside a host (NVLink between the
    cards of one host); Y crosses hosts once per block boundary, mirroring
    the reference's node-boundary MPI traffic but with an order of
    magnitude fewer, larger messages.  On one host every card reaches
    every other at the same rate, so the layout is the algorithm's alone.
    """
    devs = jax.devices()
    n_local = max(1, jax.local_device_count())
    n_hosts = max(1, len(devs) // n_local)
    arr = np.asarray(devs[: n_hosts * n_local]).reshape(n_hosts, n_local).T
    from jax.sharding import Mesh
    return Mesh(arr, axis_names)


def measure_scaling(solver_factory, dmesh, n_steps: int = 50,
                    repeats: int = 2, base=(256, 256),
                    shared_cores: bool = False, path: str = "spmd"):
    """Weak-scaling figure over `dmesh`.

    solver_factory(shape) -> (solver, state); the global shape is
    base * mesh shape, so points-per-device stays fixed at `base` (256^2
    default — bench scale, where the halo/compute ratio, not per-step
    dispatch, sets the figure).

    path: "spmd" (default) runs the production shard_map decomposition
    (`sharding.build_spmd_step`: one explicit ppermute halo pair per padded
    axis, pmax/pmin reductions); "gspmd" runs the auto-partitioned jit
    fallback (`sharding.sharded_step`), which re-partitions the
    ghost-concatenated arrays every pad — kept measurable as the diagnostic
    that motivated the spmd path (r3 recorded 0.45 efficiency on it).

    shared_cores=False (real chips): per-device throughput of the sharded
    run vs a 1-device run of the `base` tile — the BASELINE.md weak-scaling
    definition (devices are independent compute).

    shared_cores=True (the 8-virtual-CPU-device proxy): the N "devices" are
    threads of ONE host, so a 1-device tile run would use every core and
    the per-device ratio can never exceed ~1/N.  Instead both runs solve
    the SAME global problem — unsharded on one virtual device vs sharded
    over the mesh — so core contention cancels and the efficiency isolates
    exactly the partition/halo-exchange overhead (the quantity the proxy
    exists to watch).
    """
    px, py = dmesh.devices.shape

    def run(solver, state, step):
        r = jax.jit(lambda s: _repeat(step, s, n_steps))
        state = r(state)
        jax.block_until_ready(state)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            state = r(state)
            jax.block_until_ready(state)
            best = min(best, time.perf_counter() - t0)
        pts = solver.mesh.shape[0] * solver.mesh.shape[1]
        return pts * n_steps / best

    shape_n = (base[0] * px, base[1] * py)
    shape_1 = shape_n if shared_cores else base
    solver1, state1 = solver_factory(shape_1)
    # pin the 1-device reference to the mesh's platform (a CPU mesh may
    # be measured while the default backend is a GPU)
    dev0 = dmesh.devices.flat[0]
    state1 = jax.tree_util.tree_map(
        lambda x: jax.device_put(jax.numpy.asarray(x), dev0), state1)
    pps1 = run(solver1, state1, solver1.make_step())

    solverN, stateN = solver_factory(shape_n)
    if path == "spmd":
        stepN, to_spmd = shd.build_spmd_step(solverN, dmesh, stateN)
        sstate = to_spmd(stateN)
    else:
        sstate = shd.shard_state(stateN, 2, dmesh)
        stepN = shd.sharded_step(solverN.make_step(), sstate, 2, dmesh)
    ppsN = run(solverN, sstate, stepN)

    n_dev = px * py
    eff = (ppsN / pps1) if shared_cores else (ppsN / n_dev) / pps1
    return {
        "devices": n_dev,
        "points_per_s_1dev": pps1,
        "points_per_s_per_dev": ppsN / n_dev,
        "weak_scaling_efficiency": eff,
    }


def _repeat(step, s, n):
    import jax.lax as lax
    return lax.fori_loop(0, n, lambda _, x: step(x), s)
