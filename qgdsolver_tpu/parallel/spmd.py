"""Trace-time SPMD context: one mechanism that makes the ENTIRE composable
solver layer shard_map-able.

The reference's MPI parallelism has two ingredients (SURVEY.md §2.4): halo
exchange around each rank's block (1-ring + vertex corners,
extendedFaceStencilScalarGrad_8C_source.html:122-268) and global reductions
(gMax/gMin Courant bounds, parallel linear-solver dot products).  In this
framework every stencil reads ghost-padded arrays built by `ops.pad.ghost_pad`
and every global quantity funnels through a handful of reduction helpers — so
instead of wrapping each solver by hand, a single trace-time context makes
those two primitives shard-aware:

* `ghost_pad` consults `spmd.current()`: on a sharded mesh axis the ghost
  layer comes from the neighbour shard via `jax.lax.ppermute`, with the
  physical-BC layer selected only on the global-boundary shards.  Axes are
  padded sequentially, so the second axis' exchange transports the corner
  ghosts of the first — exactly the reference's two-phase corner-process
  replacement described in ops/pad.py.
* `all_max/all_min/all_sum/all_any` apply `jax.lax.pmax/pmin/psum` over the
  active mesh axis names (Courant reduction, CG dot products, the
  fvc::smooth fixed-point termination test).

`parallel.sharding.build_spmd_step` activates the context while tracing a
solver's unmodified `make_step()` inside `shard_map`: the same numerics run
per-block with explicit collectives — this package's analogue of
`decomposePar + mpirun <solver>` with zero solver-code changes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import typing as tp

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class AxisShard:
    """Decomposition of one spatial mesh axis over one device-mesh axis."""

    name: str      # device-mesh axis name (jax.sharding.Mesh axis)
    size: int      # number of shards along this axis
    n_local: int   # cells per shard along this axis


@dataclasses.dataclass(frozen=True)
class SpmdContext:
    """Active decomposition: axes[a] is an AxisShard (or None when spatial
    axis `a` is not decomposed); global_mesh is the full-domain Mesh used to
    evaluate coordinate-dependent BC values (each shard's local mesh carries
    shard-0 coordinates only)."""

    axes: tp.Tuple[tp.Optional[AxisShard], ...]
    global_shape: tp.Tuple[int, ...]
    global_mesh: tp.Any = None

    def sharded(self, a: int) -> bool:
        ax = self.axes[a]
        return ax is not None and ax.size > 1

    @property
    def axis_names(self):
        return tuple(ax.name for ax in self.axes
                     if ax is not None and ax.size > 1)


_state = threading.local()


def current() -> tp.Optional[SpmdContext]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def active(ctx: SpmdContext):
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


# ---------------------------------------------------------------------------
# reductions (no-ops without an active context)
# ---------------------------------------------------------------------------


def _reduce(val, op):
    ctx = current()
    if ctx is None:
        return val
    for name in ctx.axis_names:
        val = op(val, name)
    return val


def all_max(x):
    """Global max of an already locally-reduced value (gMax equivalent)."""
    return _reduce(x, jax.lax.pmax)


def all_min(x):
    return _reduce(x, jax.lax.pmin)


def all_sum(x):
    """Global sum (the distributed-CG dot-product psum)."""
    return _reduce(x, jax.lax.psum)


def all_any(x):
    """Global logical-or of a local boolean scalar."""
    ctx = current()
    if ctx is None:
        return x
    return _reduce(x.astype(jnp.int32), jax.lax.psum) > 0


def edge_shard_value(v, mesh_axis: int, side: int):
    """Broadcast a boundary-row quantity from the shard that OWNS the global
    (mesh_axis, side) boundary to every shard along that mesh axis.

    State-carried boundary rows (e.g. the lagged qgdFlux dp/dn) are computed
    from the local edge row on every shard, but only the global-edge shard's
    row is physical; its value must be the one replicated into the carry
    (out-spec None over the normal axis)."""
    ctx = current()
    if ctx is None or not ctx.sharded(mesh_axis):
        return v
    sh = ctx.axes[mesh_axis]
    idx = jax.lax.axis_index(sh.name)
    own = (idx == 0) if side == 0 else (idx == sh.size - 1)
    return jax.lax.psum(jnp.where(own, v, jnp.zeros_like(v)), sh.name)


def first_shard_value(v):
    """The value of per-shard scalar `v` on the shard whose every mesh-axis
    index is 0 — the owner of the GLOBAL cell (0, ..., 0) — broadcast to all
    shards (the pRefCell fix of a decomposed pressure solve)."""
    ctx = current()
    if ctx is None:
        return v
    mask = None
    for name in ctx.axis_names:
        m = jax.lax.axis_index(name) == 0
        mask = m if mask is None else jnp.logical_and(mask, m)
    if mask is None:
        return v
    return _reduce(jnp.where(mask, v, jnp.zeros_like(v)), jax.lax.psum)


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------


def _sl(arr, axis, s):
    idx = [slice(None)] * arr.ndim
    idx[axis] = s
    return arr[tuple(idx)]


def halo_layers(arr, arr_axis: int, mesh_axis: int, periodic: bool = False):
    """Neighbour edge layers of `arr` along a sharded mesh axis.

    Returns (from_prev, from_next, is_lo, is_hi): the previous shard's last
    layer / next shard's first layer (size-1 slices along arr_axis, zeros on
    the chain ends unless periodic), plus boundary-shard predicates.  The
    caller selects the physical-BC layer on boundary shards — the ppermute
    pair is this framework's processorFvPatch::patchNeighbourField.
    """
    ctx = current()
    sh = ctx.axes[mesh_axis]
    cast = arr.dtype == jnp.bool_
    if cast:  # ppermute payloads must be arithmetic types
        arr = arr.astype(jnp.int8)
    lo_src = _sl(arr, arr_axis, slice(-1, None))   # flows to the next shard
    hi_src = _sl(arr, arr_axis, slice(0, 1))       # flows to the prev shard
    if periodic:
        fwd = [(i, (i + 1) % sh.size) for i in range(sh.size)]
        bwd = [((i + 1) % sh.size, i) for i in range(sh.size)]
    else:
        fwd = [(i, i + 1) for i in range(sh.size - 1)]
        bwd = [(i + 1, i) for i in range(sh.size - 1)]
    from_prev = jax.lax.ppermute(lo_src, sh.name, fwd)
    from_next = jax.lax.ppermute(hi_src, sh.name, bwd)
    if cast:
        from_prev = from_prev.astype(jnp.bool_)
        from_next = from_next.astype(jnp.bool_)
    idx = jax.lax.axis_index(sh.name)
    return from_prev, from_next, idx == 0, idx == sh.size - 1


def localize_cells(v, mesh_ndim: int):
    """Window a spatially-GLOBAL cell array (e.g. a const-Sc cellSet mask
    or a per-cell bad-quality floor, both trace-time constants on the
    model) to this shard's block: each sharded axis of global extent
    dynamic-slices to [idx*n_local, +n_local).  Local or size-1 extents
    pass through; no-op without an active context."""
    ctx = current()
    if ctx is None or not hasattr(v, "ndim") or v.ndim == 0:
        return v
    for b in range(mesh_ndim):
        sh = ctx.axes[b]
        if sh is None or sh.size == 1:
            continue
        ax = v.ndim - mesh_ndim + b
        if ax < 0:
            continue
        ext = int(v.shape[ax])
        ng, nl = ctx.global_shape[b], sh.n_local
        if ext in (1, nl):
            continue
        if ext != ng:
            raise ValueError(
                f"cell array extent {ext} along axis {b} matches neither "
                f"the local ({nl}) nor the global ({ng}) size")
        start = jax.lax.axis_index(sh.name) * nl
        v = jax.lax.dynamic_slice_in_dim(v, start, nl, axis=ax)
    return v


def localize_layer(v, a: int, mesh_ndim: int):
    """Window a spatially-global BC layer array to this shard's block.

    BC value/gradient/mask arrays (and callable BC results evaluated on the
    GLOBAL layer coordinates) span the full boundary; each shard needs its
    tangential window.  For each sharded axis b != a: extent n_global slices
    to [idx*n_local, +n_local); extent n_global+2 (edge-extended because axes
    < a were padded first) slices to [idx*n_local, +n_local+2) — the window
    then starts at the previous shard's last entry, reproducing the serial
    corner values exactly.  Extents already equal to the local (or local+2,
    or 1 = broadcast) sizes pass through.
    """
    ctx = current()
    if ctx is None or not hasattr(v, "ndim") or v.ndim == 0:
        return v
    for b in range(mesh_ndim):
        sh = ctx.axes[b]
        if b == a or sh is None or sh.size == 1:
            continue
        ax = v.ndim - mesh_ndim + b
        if ax < 0:
            continue
        ext = int(v.shape[ax])
        ng, nl = ctx.global_shape[b], sh.n_local
        if ext in (1, nl, nl + 2):
            continue
        start = jax.lax.axis_index(sh.name) * nl
        if ext == ng:
            v = jax.lax.dynamic_slice_in_dim(v, start, nl, axis=ax)
        elif ext == ng + 2:
            v = jax.lax.dynamic_slice_in_dim(v, start, nl + 2, axis=ax)
        else:
            raise ValueError(
                f"BC layer extent {ext} along axis {b} matches neither the "
                f"local ({nl}) nor the global ({ng}) boundary size")
    return v
