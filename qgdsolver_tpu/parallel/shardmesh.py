"""Per-shard geometry windows for spmd decomposition of nonuniform meshes.

The global mesh may itself be a `core.mesh.TracedMesh` (general per-axis
mesh motion under decomposition): the windows then dynamic-slice traced
global arrays instead of numpy constants — same semantics.

The reference's MPI decomposition is mesh-agnostic: decomposePar hands every
rank its own cell geometry, graded spacings and wedge radii included
(extendedFaceStencilCalculateWeights_8C_source.html:165-229 exchanges true
neighbour cell centres across processor faces).  The structured
counterpart: the global `core.mesh.Mesh` precomputes every separable 1-D
geometry array (dx, interpolation weights w_face, center distances
d_centers, QGD lengths h_face_1d) and the broadcastable products
(cell_volume, face_area, h_cell) in numpy — exactly the serial values —
and `ShardMesh` hands each shard a `jax.lax.dynamic_slice` window of those
arrays at `axis_index * n_local` inside the shard_map body.

Because the windows are cut from the GLOBAL arrays, shard-edge faces carry
the true neighbour-side spacings (w_face, d_centers, h_face at a partition
face are the same numbers the serial mesh computes for that interior face),
so the decomposed step is exactly the serial discretization — no
geometry-halo exchange is needed at all, replacing the reference's
processor-face weight exchange with trace-time constants + dynamic slices.

`ShardMesh` duck-types the `Mesh` geometry surface consumed by ops/ and
solvers/ (everything flows through jnp, so traced windows are fine); shapes
(`shape`, `face_shape`) stay static Python tuples.
"""
from __future__ import annotations

from functools import cached_property

import jax
import jax.numpy as jnp
import numpy as np


def _reshape_axis(arr, axis: int, ndim: int):
    shape = [1] * ndim
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


class ShardMesh:
    """A shard's window of `global_mesh` geometry.

    starts[a]: traced flat start cell index of this shard along axis a
    (0 where the axis is not decomposed); shape: the local block shape.
    """

    solid = None

    def __init__(self, global_mesh, starts, shape):
        self._g = global_mesh
        self._starts = tuple(starts)
        self.shape = tuple(int(n) for n in shape)
        self.dtype = global_mesh.dtype
        self.axisymmetric = bool(getattr(global_mesh, "axisymmetric", False))

    # -- topology ----------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    # -- 1-D windows of the global arrays ----------------------------------
    def _win1(self, arr, a: int, extra: int = 0):
        """Window a global 1-D geometry array to this shard: length
        n_local + extra starting at the shard's cell offset.  `extra`
        covers face (+1) and ghost-extended (+2) arrays, whose global
        versions are aligned so the same start index applies."""
        arr = jnp.asarray(arr)   # numpy global OR traced (TracedMesh)
        return jax.lax.dynamic_slice_in_dim(
            arr, self._starts[a], self.shape[a] + extra, axis=0)

    @cached_property
    def x_faces(self) -> tuple:
        return tuple(self._win1(self._g.x_faces[a], a, 1)
                     for a in range(self.ndim))

    @cached_property
    def dx(self) -> tuple:
        return tuple(self._win1(self._g.dx[a], a) for a in range(self.ndim))

    @cached_property
    def centers(self) -> tuple:
        return tuple(self._win1(self._g.centers[a], a)
                     for a in range(self.ndim))

    @cached_property
    def ext_centers(self) -> tuple:
        # global ext (N+2, domain-mirror ghosts): window [start, start+n+2)
        # = [cell start-1, cell start+n] — interior shard ghosts are the
        # TRUE neighbour centers, domain edges keep the mirror ghost
        return tuple(self._win1(self._g.ext_centers[a], a, 2)
                     for a in range(self.ndim))

    @cached_property
    def _pdx(self) -> tuple:
        return tuple(self._win1(self._g._pdx[a], a, 2)
                     for a in range(self.ndim))

    @cached_property
    def d_centers(self) -> tuple:
        return tuple(self._win1(self._g.d_centers[a], a, 1)
                     for a in range(self.ndim))

    @cached_property
    def w_face(self) -> tuple:
        return tuple(self._win1(self._g.w_face[a], a, 1)
                     for a in range(self.ndim))

    @property
    def w_vertex(self) -> tuple:
        return self.w_face

    @cached_property
    def h_face_1d(self) -> tuple:
        return tuple(self._win1(self._g.h_face_1d[a], a, 1)
                     for a in range(self.ndim))

    # -- broadcastable geometry --------------------------------------------
    def bcast(self, arr_1d, axis: int):
        arr = jnp.asarray(arr_1d)
        return _reshape_axis(arr, axis, self.ndim).astype(self.dtype)

    def _winb(self, arr, face_axis=None):
        """Window a broadcastable global array: size-1 dims pass through;
        dims of global cell extent window to n_local (n_local+1 when the
        dim is `face_axis` at face extent)."""
        arr = jnp.asarray(arr)   # numpy global OR traced (TracedMesh)
        out = arr
        for a in range(self.ndim):
            d = arr.ndim - self.ndim + a
            size = arr.shape[d]
            if size == 1:
                continue
            if a == face_axis and size == self._g.shape[a] + 1:
                n = self.shape[a] + 1
            else:
                n = self.shape[a]
            out = jax.lax.dynamic_slice_in_dim(out, self._starts[a], n,
                                               axis=d)
        return out

    @cached_property
    def cell_volume(self):
        return self._winb(self._g.cell_volume)

    def face_area(self, axis: int):
        return self._winb(self._g.face_area(axis), face_axis=axis)

    def h_face(self, axis: int):
        return self.bcast(self.h_face_1d[axis], axis)

    @cached_property
    def h_cell(self):
        return self._winb(self._g.h_cell)

    @cached_property
    def r_cell(self):
        assert self.axisymmetric
        return self._win1(self._g.centers[1], 1)

    # -- misc ---------------------------------------------------------------
    def min_h(self) -> float:
        return self._g.min_h()  # global min: identical on every shard

    def cell_coords(self, axis: int):
        return self.bcast(self.centers[axis], axis)

    def face_coords(self, axis: int):
        return self.bcast(self.x_faces[axis], axis)
