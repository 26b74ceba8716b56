"""Domain decomposition over a device mesh.

The reference's only parallelism is MPI domain decomposition with 1-ring +
vertex-corner halo exchange (SURVEY.md §2.4: OpenFOAM processorFvPatch plus
the 600-line leastSquaresBase corner-process discovery,
extendedFaceStencilFindNeighbours_8C_source.html:41-612).  The
replacement here is GSPMD sharding of the structured block over a
`jax.sharding.Mesh`: every stencil in ops/fvsc.py is a shifted slice of a
ghost-padded array, which XLA's SPMD partitioner lowers to collective-permute
halo exchanges between devices automatically — including the diagonal
values, because the per-axis sequential padding transports corners in two
hops exactly like the reference's two-phase exchange would.

Global reductions (Courant max, CG dot products) lower to psum/pmax across
the same mesh.  No reference-style rank bookkeeping exists at all: the mesh
axes ARE the decomposition.
"""
from __future__ import annotations

import math
import typing as tp

import jax
import numpy as np
from jax.sharding import Mesh as DeviceMesh, NamedSharding, PartitionSpec as P


def factor2d(n: int):
    """Near-square factorization n = px*py (px >= py)."""
    py = int(math.isqrt(n))
    while n % py:
        py -= 1
    return n // py, py


def make_device_mesh(devices=None, shape=None, axis_names=("X", "Y")):
    """Build a 2-axis device mesh for (x, y) domain decomposition."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = factor2d(len(devices))
    arr = np.asarray(devices[: shape[0] * shape[1]]).reshape(shape)
    return DeviceMesh(arr, axis_names)


def spatial_spec(arr_ndim: int, mesh_ndim: int, dmesh: DeviceMesh):
    """PartitionSpec sharding the trailing spatial axes over the device mesh.

    Decomposes the first min(mesh_ndim, len(mesh axes)) spatial axes; leading
    component axes replicate.
    """
    names = list(dmesh.axis_names)
    lead = [None] * (arr_ndim - mesh_ndim)
    spat = [names[i] if i < len(names) else None for i in range(mesh_ndim)]
    return P(*(lead + spat))


def state_shardings(state, mesh_ndim: int, dmesh: DeviceMesh):
    """NamedShardings for a solver-state pytree: spatial axes decomposed,
    scalars (t, dt) replicated."""

    def one(leaf):
        leaf = jax.numpy.asarray(leaf)
        if leaf.ndim < mesh_ndim:
            return NamedSharding(dmesh, P())
        return NamedSharding(dmesh, spatial_spec(leaf.ndim, mesh_ndim, dmesh))

    return jax.tree_util.tree_map(one, state)


def shard_state(state, mesh_ndim: int, dmesh: DeviceMesh):
    """Place a state pytree onto the device mesh."""
    sh = state_shardings(state, mesh_ndim, dmesh)
    return jax.tree_util.tree_map(jax.device_put, state, sh)


def sharded_step(step_fn, state, mesh_ndim: int, dmesh: DeviceMesh):
    """jit the step with explicit in/out shardings over the device mesh.

    XLA GSPMD inserts all halo collective-permutes and reduction psums; the
    latency-hiding scheduler overlaps them with interior compute (the
    analogue of the reference's nonblocking PstreamBuffers
    exchanges, extendedFaceStencilScalarGrad_8C_source.html:122-268).

    NOTE: GSPMD re-partitions the ghost-concatenated arrays every pad — use
    `build_spmd_step` (explicit shard_map halos) for production multi-chip
    runs; this wrapper remains as the any-solver fallback.
    """
    sh = state_shardings(state, mesh_ndim, dmesh)
    return jax.jit(step_fn, in_shardings=(sh,), out_shardings=sh)


# ---------------------------------------------------------------------------
# shard_map decomposition of the composable step (production multi-device path)
# ---------------------------------------------------------------------------


def spmd_supported(solver) -> tp.Optional[str]:
    """None if `build_spmd_step` can decompose this solver; else the reason.

    Nonuniform (graded) spacings and wedge (axisymmetric) metrics ARE
    supported: the per-shard geometry is windowed from the global mesh's
    arrays inside the shard body (parallel.shardmesh.ShardMesh), exactly
    reproducing the serial discretization at partition faces — the
    counterpart of the reference's mesh-agnostic decomposition
    (extendedFaceStencilCalculateWeights_8C_source.html:165-229).
    Const-Sc cellSets / per-cell cqSc floors window per shard
    (spmd.localize_cells), and DyM (mesh_velocity / mesh_scale) configs
    ride the ShardMesh geometry windows with globally-reduced mesh
    Courant — only stairstep solid masks remain excluded."""
    mesh = solver.mesh
    if getattr(mesh, "solid", None) is not None:
        return "stairstep solid masks are globally indexed"
    return None


def _is_particles(solver) -> bool:
    from ..solvers import particles as prt

    return isinstance(solver, (prt.ParticlesQGDFoam, prt.ParticlesQHDFoam,
                               prt.ReactingLagrangianQGDFoam))


def build_spmd_step(solver, dmesh: DeviceMesh, state,
                    step_fn_name: str = "make_step", **step_kwargs):
    """Decompose a solver's composable step over a device mesh via shard_map.

    This package's `decomposePar + mpirun <solver>` (SURVEY.md §2.4): the
    solver is rebuilt on a local block mesh and its UNMODIFIED `make_step()`
    is traced inside `shard_map` under an active `parallel.spmd` context —
    `ops.pad.ghost_pad` then fetches partition-edge ghosts from neighbour
    shards via ppermute (axis-sequential, corners in two hops exactly like
    the reference's corner-process exchange,
    extendedFaceStencilFindNeighbours_8C_source.html:305-612) and the
    Courant/CG/smooth reductions become pmax/pmin/psum collectives.

    `state` is a template pytree used to derive per-leaf PartitionSpecs:
    spatial leaves shard over (X, Y[, ...]); boundary-row leaves (size-1
    normal axis, e.g. the lagged qgdFlux gradients) shard tangentially and
    replicate over the normal mesh axis; scalars replicate.

    Returns (step, to_spmd): `step` is the jitted global-array step;
    `to_spmd` places a state pytree onto the device mesh.
    """
    from ..core.mesh import Mesh
    from . import spmd

    reason = spmd_supported(solver)
    if reason is not None:
        raise NotImplementedError(f"spmd decomposition unsupported: {reason}")

    mesh = solver.mesh
    nd = mesh.ndim
    names = list(dmesh.axis_names)
    axes = []
    local_faces = []
    for a in range(nd):
        name = names[a] if a < len(names) else None
        size = int(dmesh.shape[name]) if name is not None else 1
        n = mesh.shape[a]
        if size > 1:
            if n % size:
                raise ValueError(
                    f"axis {a}: {n} cells not divisible by {size} shards")
            nloc = n // size
            axes.append(spmd.AxisShard(name=name, size=size, n_local=nloc))
        else:
            nloc = n
            axes.append(None)
        local_faces.append(mesh.x_faces[a][: nloc + 1])
    ctx = spmd.SpmdContext(axes=tuple(axes), global_shape=tuple(mesh.shape),
                           global_mesh=mesh)

    import dataclasses as dc

    # uniform planar meshes: every shard's block is geometrically
    # identical, so a static local Mesh (shard-0 window) is exact and
    # cheapest to compile.  Graded or wedge meshes window the global
    # geometry per shard inside the body (ShardMesh) — as do Lagrangian
    # clouds, whose parcel positions are GLOBAL coordinates (locate and
    # the migration block faces need the shard's true window).
    uniform = (not getattr(mesh, "axisymmetric", False)
               and not _is_particles(solver)
               and getattr(solver, "mesh_scale", None) is None
               and getattr(solver, "mesh_velocity", None) is None
               and all(np.allclose(mesh.dx[a], mesh.dx[a][0])
                       for a in range(nd)))
    def replace_mesh(sv, m):
        # particle solvers nest the mesh inside their fluid solver
        if _is_particles(sv):
            return dc.replace(sv, fluid=dc.replace(sv.fluid, mesh=m))
        return dc.replace(sv, mesh=m)

    local_shape = tuple(len(f) - 1 for f in local_faces)
    if uniform:
        local_mesh = Mesh(x_faces=tuple(local_faces), dtype=mesh.dtype)
        local_solver = replace_mesh(solver, local_mesh)
        local_step = getattr(local_solver, step_fn_name)(**step_kwargs)
    else:
        from .shardmesh import ShardMesh

        def local_step(s):
            starts = []
            for a in range(nd):
                ax = axes[a]
                if ax is None or ax.size == 1:
                    starts.append(0)
                else:
                    starts.append(jax.lax.axis_index(ax.name) * ax.n_local)
            smesh = ShardMesh(mesh, starts, local_shape)
            ssolver = replace_mesh(solver, smesh)
            return getattr(ssolver, step_fn_name)(**step_kwargs)(s)

    sharded_names = tuple(ax.name for ax in axes
                          if ax is not None and ax.size > 1)
    n_shards = int(np.prod([ax.size for ax in axes
                            if ax is not None and ax.size > 1] or [1]))

    def spec_for(path, leaf):
        leaf = jax.numpy.asarray(leaf)
        if any("cloud" in str(k) for k in path):
            # Lagrangian cloud arrays: parcel SLOTS shard across the whole
            # device mesh (each shard owns a fixed-capacity slot block);
            # particles.distribute_cloud orders the initial slots by
            # spatial residency (the decomposePar of the cloud)
            if leaf.ndim == 0 or not sharded_names:
                return P()
            if leaf.shape[-1] % n_shards:
                raise ValueError(
                    f"cloud slot count {leaf.shape[-1]} not divisible by "
                    f"{n_shards} shards — use particles.distribute_cloud")
            return P(*([None] * (leaf.ndim - 1) + [sharded_names]))
        if leaf.ndim < nd:
            return P()
        lead = [None] * (leaf.ndim - nd)
        spat = []
        for a in range(nd):
            ax = axes[a]
            n_leaf = leaf.shape[leaf.ndim - nd + a]
            if ax is None or n_leaf == 1:
                spat.append(None)
            elif n_leaf == mesh.shape[a]:
                spat.append(ax.name)
            else:
                raise ValueError(
                    f"state leaf with extent {n_leaf} along axis {a} "
                    f"(global {mesh.shape[a]}) has no spmd decomposition")
        return P(*(lead + spat))

    specs = jax.tree_util.tree_map_with_path(spec_for, state)

    def body(s):
        with spmd.active(ctx):
            return local_step(s)

    step = jax.jit(jax.shard_map(body, mesh=dmesh, in_specs=(specs,),
                                 out_specs=specs, check_vma=False))

    def to_spmd(s):
        sh = jax.tree_util.tree_map(
            lambda sp: NamedSharding(dmesh, sp), specs)
        return jax.tree_util.tree_map(
            lambda x, shx: jax.device_put(jax.numpy.asarray(x), shx), s, sh)

    return step, to_spmd
