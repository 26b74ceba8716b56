"""Ghost-cell padding of cell fields under boundary conditions.

Corner/edge ghosts are produced by padding the axes sequentially: the layer
fed to a later axis' BC already contains the earlier axes' ghosts, so the
diagonal ghost cells needed by the vertex (full) gradient stencil come out
consistent — this replaces the reference's MPI "corner process" discovery
machinery (extendedFaceStencilFindNeighbours_8C.html:305-612) with two/three
ordered pads, which under sharding lower to ordinary XLA halo exchanges.

Under an active `parallel.spmd` context (a shard_map-decomposed step) each
sharded axis' ghost layer is fetched from the neighbour shard via
jax.lax.ppermute, and the physical-BC layer is applied only on the shards
that own the global boundary; the sequential-axis ordering then transports
diagonal corner ghosts across shard corners in two hops, exactly like the
serial corner construction (and the reference's corner-process exchange).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..parallel import spmd


def _spatial_axis(arr_ndim: int, mesh_ndim: int, a: int) -> int:
    """Mesh axis a -> array axis (spatial axes are the trailing mesh_ndim)."""
    return arr_ndim - mesh_ndim + a


def _sl(arr, axis, s):
    idx = [slice(None)] * arr.ndim
    idx[axis] = s
    return arr[tuple(idx)]


def _layer_coords(mesh: Mesh, a: int, side: int):
    """Broadcastable coordinate arrays of the ghost layer being built while
    padding axis `a` (axes < a already padded -> extended centers).  Shaped
    over the mesh.ndim spatial dims only, so they broadcast under any leading
    component/batch axes."""
    nd = mesh.ndim
    coords = []
    for b in range(nd):
        if b == a:
            c = jnp.asarray(
                mesh.x_faces[a][0] if side == 0 else mesh.x_faces[a][-1],
                dtype=mesh.dtype,
            ).reshape((1,) * nd)
        else:
            vals = mesh.ext_centers[b] if b < a else mesh.centers[b]
            shape = [1] * nd
            shape[b] = len(vals)
            c = jnp.asarray(vals, dtype=mesh.dtype).reshape(shape)
        coords.append(c)
    return tuple(coords)


def _eval_bc_value(v, t, coords, vector, ncomp, layer_ndim):
    """Evaluate a BC value spec into an array broadcastable with the layer."""
    if callable(v):
        return v(t, coords)
    v = jnp.asarray(v)
    if vector and v.ndim == 1 and v.shape[0] == ncomp:
        return v.reshape((ncomp,) + (1,) * (layer_ndim - 1))
    return v


def _ghost_layers(bc_lo, bc_hi, arr, mesh, a, t, vector):
    """(lo, hi) ghost layers (size-1 along the padded axis) for mesh axis a.

    With an active spmd context and axis `a` sharded, the physical-BC layers
    computed here are kept only on the global-boundary shards; interior
    partition edges take the neighbour shard's edge layer via ppermute."""
    nd = mesh.ndim
    ax = _spatial_axis(arr.ndim, nd, a)
    i_lo = _sl(arr, ax, slice(0, 1))
    i_hi = _sl(arr, ax, slice(-1, None))
    # in the field's dtype: the mesh keeps f64 spacings, which would
    # promote an f32 fixedGradient/qgdFlux ghost layer under x64
    dx_lo = jnp.asarray(mesh.dx[a][0], dtype=arr.dtype)
    dx_hi = jnp.asarray(mesh.dx[a][-1], dtype=arr.dtype)
    ncomp = arr.shape[0] if vector else 0
    ctx = spmd.current()
    sharded = ctx is not None and ctx.sharded(a)
    # BC value callables see the GLOBAL boundary coordinates (each shard's
    # local mesh carries shard-0 coordinates only); the evaluated layer is
    # then windowed to the shard
    cmesh = ctx.global_mesh if (ctx is not None
                                and ctx.global_mesh is not None) else mesh

    def extend_prior(v):
        """Extend a BC layer array along the already-padded axes b < a to
        the interior layer's ghosted extent: neighbour values across
        sharded partition edges, edge replication at physical boundaries
        (the same construction the interior ghosts got)."""
        if not hasattr(v, "ndim") or v.ndim < nd:
            return v
        for b in range(a):
            axb = _spatial_axis(v.ndim, nd, b)
            if v.shape[axb] != mesh.shape[b] or mesh.shape[b] == 1:
                continue
            first = jnp.take(v, jnp.asarray([0]), axis=axb)
            last = jnp.take(v, jnp.asarray([-1]), axis=axb)
            if ctx is not None and ctx.sharded(b):
                prev_m, next_m, b_lo, b_hi = spmd.halo_layers(
                    v, axb, b, periodic=False)
                first = jnp.where(b_lo, first, prev_m)
                last = jnp.where(b_hi, last, next_m)
            v = jnp.concatenate([first, v, last], axis=axb)
        return v

    def ev(raw, side, interior):
        coords = _layer_coords(cmesh, a, side)
        v = _eval_bc_value(raw, t, coords, vector, ncomp, interior.ndim)
        return extend_prior(spmd.localize_layer(v, a, nd))

    def one(bc, side, interior, other_interior, dx, near2):
        if isinstance(bc, bcm.FixedValue):
            return 2.0 * ev(bc.value, side, interior) - interior
        if isinstance(bc, bcm.ZeroGradient):
            return interior
        if isinstance(bc, bcm.Symmetry):
            if vector:
                sign = jnp.ones((ncomp,)).at[a].set(-1.0)
                return interior * sign.reshape((ncomp,) + (1,) * (interior.ndim - 1))
            return interior
        if isinstance(bc, bcm.FixedGradient):
            return interior + ev(bc.grad, side, interior) * dx
        if isinstance(bc, bcm.Mixed):
            v = ev(bc.value, side, interior)
            f = ev(bc.fraction, side, interior)
            return 2.0 * (f * v + (1.0 - f) * interior) - interior
        if isinstance(bc, bcm.Periodic):
            return other_interior
        if isinstance(bc, bcm.Extrapolated):
            return 2.0 * interior - near2
        if isinstance(bc, bcm.WaveTransmissive):
            # solvers with the carried-face-value machinery (the QGD
            # family) substitute Mixed before padding; elsewhere the
            # marker degrades to the linear-extrapolation outflow it
            # replaced (the pre-r5 word mapping)
            return 2.0 * interior - near2
        if isinstance(bc, bcm.FluxSwitched):
            v = ev(bc.value, side, interior)
            # the outflow mask lives on the unpadded mesh; axes < a already
            # carry ghosts here, so extend the mask to match: neighbour
            # values across sharded partition edges, edge-replication at
            # physical boundaries (serial parity in the corner ghosts)
            mask = extend_prior(
                spmd.localize_layer(jnp.asarray(bc.outflow), a, nd))
            return jnp.where(mask, interior, 2.0 * v - interior)
        if isinstance(bc, bcm.Segmented):
            # split-side patches: each segment's ghost layer applies on its
            # global cell-index rectangles (later segments win on overlap;
            # ingestion validates full coverage).  Reference analogue:
            # per-patch boundary loops,
            # extendedFaceStencilScalarGrad_8C_source.html:86-109.
            layer = None
            for rects, sub in bc.segments:
                sub_layer = one(sub, side, interior, other_interior, dx,
                                near2)
                if layer is None:
                    layer = jnp.broadcast_to(sub_layer, interior.shape)
                else:
                    m = _segment_mask(rects, a, mesh, ctx)
                    layer = jnp.where(m, sub_layer, layer)
            return layer
        if isinstance(bc, bcm.InletOutlet):
            raise TypeError(
                "InletOutlet must be resolved per step via "
                "bc.resolve_inlet_outlet before padding")
        raise TypeError(f"unsupported BC {bc!r}")

    lo = one(bc_lo, 0, i_lo, i_hi, dx_lo, _sl(arr, ax, slice(1, 2)))
    hi = one(bc_hi, 1, i_hi, i_lo, dx_hi, _sl(arr, ax, slice(-2, -1)))
    if sharded:
        periodic = isinstance(bc_lo, bcm.Periodic)
        from_prev, from_next, is_lo, is_hi = spmd.halo_layers(
            arr, ax, a, periodic=periodic)
        if periodic:
            # the global wraparound IS the neighbour exchange
            lo, hi = from_prev, from_next
        else:
            lo = jnp.where(is_lo, lo, from_prev)
            hi = jnp.where(is_hi, hi, from_next)
    return lo, hi, ax


def _segment_mask(rects, a, mesh, ctx):
    """Boolean mask over the axis-`a` ghost layer's spatial dims selecting
    the GLOBAL cell-index rectangles `rects` (tangential axes, ascending
    order).  Axes < a carry one ghost position each side (index -1 / n,
    clamped into the nearest cell); under an spmd context, local positions
    offset by the shard's start index."""
    nd = mesh.ndim
    tang = [b for b in range(nd) if b != a]
    glob = ctx.global_mesh if (ctx is not None
                               and ctx.global_mesh is not None) else mesh
    mask = None
    for rect in rects:
        m = None
        for k, b in enumerate(tang):
            lo_k, hi_k = rect[k]
            n_loc = mesh.shape[b]
            ext = n_loc + 2 if b < a else n_loc
            idx = jnp.arange(ext) - (1 if b < a else 0)
            if ctx is not None and ctx.sharded(b):
                import jax

                idx = idx + jax.lax.axis_index(ctx.axes[b].name) \
                    * ctx.axes[b].n_local
            idx = jnp.clip(idx, 0, glob.shape[b] - 1)
            shape = [1] * nd
            shape[b] = ext
            cond = ((idx >= lo_k) & (idx < hi_k)).reshape(shape)
            m = cond if m is None else (m & cond)
        mask = m if mask is None else (mask | m)
    return mask


def ghost_pad(field, bcs: bcm.FieldBCs, mesh: Mesh, t=0.0, vector: bool = False):
    """Pad `field` with one ghost layer per spatial axis.

    field: (..., n0, n1[, n2]) — trailing axes are spatial; for vector=True the
    leading axis is the component axis and Symmetry flips the normal component.
    """
    out = field
    for a in range(mesh.ndim):
        lo, hi, ax = _ghost_layers(bcs[a, 0], bcs[a, 1], out, mesh, a, t, vector)
        lo = jnp.broadcast_to(lo, lo.shape[:ax] + (1,) + lo.shape[ax + 1:]) if lo.ndim == out.ndim else lo
        out = jnp.concatenate(
            [jnp.broadcast_to(lo, _shape_with(out, ax, 1)),
             out,
             jnp.broadcast_to(hi, _shape_with(out, ax, 1))],
            axis=ax,
        )
    return out


def _shape_with(arr, axis, n):
    s = list(arr.shape)
    s[axis] = n
    return tuple(s)


def trim_other_axes(arr, mesh_ndim: int, keep_axis: int):
    """Drop the ghost layers along every spatial axis except `keep_axis`."""
    sl = [slice(None)] * arr.ndim
    for a in range(mesh_ndim):
        if a != keep_axis:
            sl[_spatial_axis(arr.ndim, mesh_ndim, a)] = slice(1, -1)
    return arr[tuple(sl)]
