"""Structured rectilinear block mesh for the QGD framework.

The reference (unicfdlab/QGDsolver) runs on unstructured OpenFOAM meshes; this
framework deliberately targets structured rectilinear blocks so that every
face-stencil operator becomes a fixed-pattern array-slicing op that XLA fuses
into elementwise device kernels, and domain decomposition becomes plain array
sharding over a `jax.sharding.Mesh`.

Geometry quantities mirror the reference definitions:
  * QGD face length scale  h_f = 2*min(|C_own-C_f|, |C_nei-C_f|)
    (uncoupled boundary faces: h_f = 2*|C_own-C_f|), see reference
    docs/html/QGDCoeffs_8C_source.html:298-317 (orig. QGD/QGDCoeffs/QGDCoeffs.C).
  * QGD cell length scale  h = sum_faces(h_f*|S_f|)/sum_faces(|S_f|), see
    docs/html/QGDCoeffs_8C_source.html:320-362.

All per-axis geometry is stored as 1-D arrays and broadcast on demand; on a
rectilinear mesh every geometric factor is separable, so nothing of O(n_cells)
is ever materialised for geometry.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import jax.numpy as jnp


def _reshape_axis(arr: np.ndarray, axis: int, ndim: int) -> np.ndarray:
    """Reshape 1-D `arr` so it broadcasts along `axis` of an ndim-D field."""
    shape = [1] * ndim
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Rectilinear structured mesh in 1, 2 or 3 dimensions.

    Parameters
    ----------
    x_faces : tuple of 1-D float arrays, one per axis, strictly increasing,
        giving the face coordinates along that axis (length n_i + 1).
    """

    x_faces: tuple
    dtype: np.dtype = np.float32
    # optional dead-cell (solid) mask, True where the cell is OUTSIDE the
    # flow domain (L-shaped multi-block unions); solvers with stairstep
    # immersed-wall support honor it, others reject the mesh
    solid: tuple = dataclasses.field(default=None, compare=False,
                                     repr=False)

    # -- construction helpers -------------------------------------------------
    @staticmethod
    def uniform(shape, lengths=None, origin=None, dtype=np.float32) -> "Mesh":
        """Uniform mesh with `shape` cells spanning `lengths` (default unit box)."""
        ndim = len(shape)
        lengths = lengths if lengths is not None else (1.0,) * ndim
        origin = origin if origin is not None else (0.0,) * ndim
        faces = tuple(
            np.linspace(origin[a], origin[a] + lengths[a], shape[a] + 1, dtype=np.float64)
            for a in range(ndim)
        )
        return Mesh(x_faces=faces, dtype=dtype)

    def __post_init__(self):
        object.__setattr__(
            self, "x_faces", tuple(np.asarray(xf, dtype=np.float64) for xf in self.x_faces)
        )

    # -- basic topology --------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.x_faces)

    @cached_property
    def shape(self) -> tuple:
        return tuple(xf.shape[0] - 1 for xf in self.x_faces)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    # -- 1-D geometry (numpy, used to build broadcastable constants) ----------
    @cached_property
    def dx(self) -> tuple:
        """Cell widths per axis, shape (n_a,)."""
        return tuple(np.diff(xf) for xf in self.x_faces)

    @cached_property
    def centers(self) -> tuple:
        """Cell center coordinates per axis, shape (n_a,)."""
        return tuple(0.5 * (xf[:-1] + xf[1:]) for xf in self.x_faces)

    @cached_property
    def _pdx(self) -> tuple:
        """Cell widths padded with mirrored ghost widths, shape (n_a+2,)."""
        return tuple(np.concatenate([[d[0]], d, [d[-1]]]) for d in self.dx)

    @cached_property
    def d_centers(self) -> tuple:
        """Center-to-center distance across each face (ghosts mirrored),
        shape (n_a+1,).  Across boundary faces this equals the edge cell width
        (mirror ghost), matching OpenFOAM's boundary deltaCoeffs 1/|C_own-C_f|
        up to the factor-2 handled in the BC ghost values."""
        return tuple(0.5 * (p[:-1] + p[1:]) for p in self._pdx)

    @cached_property
    def w_face(self) -> tuple:
        """Linear interpolation weight of the LEFT (lower-index) cell at each
        face, shape (n_a+1,).  f_face = w*f_left + (1-w)*f_right, ghost-padded
        indexing.  w = dx_right / (dx_left + dx_right) — OpenFOAM linear
        (see reference QGDInterpolate_8H.html qgdInterpolate == linear)."""
        return tuple(p[1:] / (p[:-1] + p[1:]) for p in self._pdx)

    @cached_property
    def w_vertex(self) -> tuple:
        """Same weights used to interpolate cell lines to vertex planes along
        an axis (identical formula: vertices coincide with face coordinates)."""
        return self.w_face

    # -- QGD length scales (reference QGDCoeffs::updateQGDLength) --------------
    @cached_property
    def h_face_1d(self) -> tuple:
        """Per-axis face QGD length, shape (n_a+1,).

        Interior: 2*min(dx_l/2, dx_r/2) = min(dx_l, dx_r);
        boundary: 2*(dx/2)*... reference sets boundary h_f = deltaCoeff^-1 * 2
        = (dx/2)*2 = dx (QGDCoeffs_8C_source.html:195-199, 310-317)."""
        out = []
        for d in self.dx:
            h = np.empty(d.shape[0] + 1)
            h[1:-1] = np.minimum(d[:-1], d[1:])
            h[0] = d[0]
            h[-1] = d[-1]
            out.append(h)
        return tuple(out)

    # -- broadcastable jnp geometry --------------------------------------------
    def bcast(self, arr_1d, axis: int):
        """1-D array -> broadcastable numpy array along `axis` of a cell field.

        Geometry is returned as NUMPY (not jnp): numpy operands are embedded
        as constants at their jnp use sites, so nothing traced is ever cached
        on the (long-lived) Mesh object — caching jnp arrays created inside a
        jit trace leaks tracers under JAX's constant lifting."""
        return _reshape_axis(np.asarray(arr_1d), axis, self.ndim).astype(self.dtype)

    @cached_property
    def cell_volume(self):
        """Cell volumes, broadcastable to the cell shape."""
        v = _reshape_axis(self.dx[0], 0, self.ndim)
        for a in range(1, self.ndim):
            v = v * _reshape_axis(self.dx[a], a, self.ndim)
        return v.astype(self.dtype)

    def face_area(self, axis: int):
        """|S_f| for faces normal to `axis`, broadcastable to the face shape
        (constant along `axis`)."""
        a_ = np.ones([1] * self.ndim)
        for b in range(self.ndim):
            if b != axis:
                a_ = a_ * _reshape_axis(self.dx[b], b, self.ndim)
        return a_.astype(self.dtype)

    def h_face(self, axis: int):
        """QGD face length scale h_f, broadcastable to axis-face fields."""
        return self.bcast(self.h_face_1d[axis], axis)

    @cached_property
    def h_cell(self):
        """QGD cell length scale: area-weighted face-h average over the cell's
        2*ndim faces (reference QGDCoeffs_8C_source.html:320-362).

        On a rectilinear mesh |S_f| is constant per axis within a cell, so
        h = sum_a A_a*(h_f(lo)+h_f(hi)) / sum_a 2*A_a with A_a separable.
        Returns a full (broadcast) cell-shaped array."""
        num = 0.0
        den = 0.0
        for a in range(self.ndim):
            hf = self.h_face_1d[a]
            h_lo = _reshape_axis(hf[:-1], a, self.ndim)
            h_hi = _reshape_axis(hf[1:], a, self.ndim)
            area = np.ones([1] * self.ndim)
            for b in range(self.ndim):
                if b != a:
                    area = area * _reshape_axis(self.dx[b], b, self.ndim)
            num = num + area * (h_lo + h_hi)
            den = den + 2.0 * area
        return np.ascontiguousarray(np.broadcast_to(num / den, self.shape)).astype(self.dtype)

    @cached_property
    def ext_centers(self) -> tuple:
        """Cell centers extended with mirrored ghost centers, shape (n_a+2,)."""
        out = []
        for a in range(self.ndim):
            c = self.centers[a]
            xf = self.x_faces[a]
            out.append(np.concatenate([[2 * xf[0] - c[0]], c, [2 * xf[-1] - c[-1]]]))
        return tuple(out)

    # -- misc -------------------------------------------------------------------
    def min_h(self) -> float:
        return float(min(h.min() for h in self.h_face_1d))

    def cell_coords(self, axis: int):
        """Cell center coordinates along axis, broadcastable."""
        return self.bcast(self.centers[axis], axis)

    def face_coords(self, axis: int):
        """Face coordinates along axis (for axis-normal faces), broadcastable."""
        return self.bcast(self.x_faces[axis], axis)


# `Mesh.axisymmetric` distinguishes planar meshes from the wedge-ingested
# axisymmetric specialisation below without isinstance checks at use sites.
Mesh.axisymmetric = False


class TracedMesh:
    """Mesh-geometry view over TRACED per-axis face coordinates.

    Backs arbitrary per-axis 1-D mesh motion (QHDDyMFoam `mesh_faces`):
    inside the jitted step, x_faces = motion(t) is a tuple of traced
    (n_a+1,) arrays and every geometry quantity is recomputed from them
    with the EXACT `Mesh` formulas in jnp — the moving-mesh counterpart of
    OpenFOAM's mesh.update() geometry refresh (QHDDyMFoam_8C:109-135).
    Shapes stay static; the instance lives for one trace (no caching
    hazards).  Duck-types the `Mesh` surface the ops layer consumes (the
    same contract `parallel.shardmesh.ShardMesh` established)."""

    axisymmetric = False
    solid = None

    def __init__(self, x_faces, dtype=np.float32):
        self.x_faces = tuple(jnp.asarray(f) for f in x_faces)
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(f.shape[0]) - 1 for f in self.x_faces)

    @property
    def ndim(self) -> int:
        return len(self.x_faces)

    @property
    def num_cells(self) -> int:
        return int(np.prod(self.shape))

    def face_shape(self, axis: int) -> tuple:
        s = list(self.shape)
        s[axis] += 1
        return tuple(s)

    @property
    def dx(self):
        return tuple(jnp.diff(f) for f in self.x_faces)

    @property
    def centers(self):
        return tuple(0.5 * (f[:-1] + f[1:]) for f in self.x_faces)

    @property
    def _pdx(self):
        return tuple(jnp.concatenate([d[:1], d, d[-1:]]) for d in self.dx)

    @property
    def d_centers(self):
        return tuple(0.5 * (p[:-1] + p[1:]) for p in self._pdx)

    @property
    def w_face(self):
        return tuple(p[1:] / (p[:-1] + p[1:]) for p in self._pdx)

    @property
    def w_vertex(self):
        return self.w_face

    @property
    def h_face_1d(self):
        out = []
        for d in self.dx:
            mid = jnp.minimum(d[:-1], d[1:])
            out.append(jnp.concatenate([d[:1], mid, d[-1:]]))
        return tuple(out)

    def bcast(self, arr_1d, axis: int):
        return _reshape_axis(jnp.asarray(arr_1d), axis,
                             self.ndim).astype(self.dtype)

    @property
    def cell_volume(self):
        v = _reshape_axis(self.dx[0], 0, self.ndim)
        for a in range(1, self.ndim):
            v = v * _reshape_axis(self.dx[a], a, self.ndim)
        return v.astype(self.dtype)

    def face_area(self, axis: int):
        a_ = jnp.ones((1,) * self.ndim)
        for b in range(self.ndim):
            if b != axis:
                a_ = a_ * _reshape_axis(self.dx[b], b, self.ndim)
        return a_.astype(self.dtype)

    def h_face(self, axis: int):
        return self.bcast(self.h_face_1d[axis], axis)

    @property
    def h_cell(self):
        num = 0.0
        den = 0.0
        for a in range(self.ndim):
            hf = self.h_face_1d[a]
            h_lo = _reshape_axis(hf[:-1], a, self.ndim)
            h_hi = _reshape_axis(hf[1:], a, self.ndim)
            area = jnp.ones((1,) * self.ndim)
            for b in range(self.ndim):
                if b != a:
                    area = area * _reshape_axis(self.dx[b], b, self.ndim)
            num = num + area * (h_lo + h_hi)
            den = den + 2.0 * area
        return jnp.broadcast_to(num / den, self.shape).astype(self.dtype)

    @property
    def ext_centers(self):
        out = []
        for a in range(self.ndim):
            c = self.centers[a]
            f = self.x_faces[a]
            out.append(jnp.concatenate([2 * f[:1] - c[:1], c,
                                        2 * f[-1:] - c[-1:]]))
        return tuple(out)

    def cell_coords(self, axis: int):
        return self.bcast(self.centers[axis], axis)

    def face_coords(self, axis: int):
        return self.bcast(self.x_faces[axis], axis)


@dataclasses.dataclass(frozen=True)
class AxisymmetricMesh(Mesh):
    """2D axisymmetric (x, r) mesh — the structured counterpart of an
    OpenFOAM wedge mesh (one-cell sector swept about the x axis).

    The reference runs wedge cases through OpenFOAM's mesh geometry: wedge
    side-face areas/volumes carry the radius weighting and the rotated
    patch fields supply the hoop coupling (fvsc_8C_source.html:60-82 only
    guards the GaussVolPoint scheme against wedges — other schemes run
    them).  Here the same physics enters through r-weighted metrics, all
    per unit swept angle (the 1-radian sector):

      V       = dx * dr * r_c
      |S_x|   = dr * r_c          (axial faces)
      |S_r|   = dx * r_f          (radial faces; zero on the axis r=0)

    so conservative face-flux divergence reproduces the cylindrical
    (1/r) d(r .)/dr operator exactly, and uniform-pressure freestreams are
    preserved discretely against the p/r hoop source:
    (|S_r|_hi - |S_r|_lo)/V = 1/r_c holds to rounding.

    Axis 0 is the symmetry axis coordinate x; axis 1 is the radius r >= 0.
    Solvers add the radial hoop sources (p - Pi_theta_theta)/r; stencil
    operators (coordinate derivatives) are unchanged.
    """

    def __post_init__(self):
        super().__post_init__()
        assert self.ndim == 2, "axisymmetric meshes are 2D (x, r)"
        assert self.x_faces[1][0] >= -1e-12, "radius must be non-negative"

    axisymmetric = True

    @cached_property
    def r_cell(self) -> np.ndarray:
        """Cell-center radii, shape (n_r,)."""
        return self.centers[1]

    @cached_property
    def cell_volume(self):
        v = _reshape_axis(self.dx[0], 0, 2) * _reshape_axis(self.dx[1], 1, 2)
        return (v * _reshape_axis(self.r_cell, 1, 2)).astype(self.dtype)

    def face_area(self, axis: int):
        if axis == 0:
            a_ = (_reshape_axis(self.dx[1], 1, 2)
                  * _reshape_axis(self.r_cell, 1, 2))
        else:
            a_ = (_reshape_axis(self.dx[0], 0, 2)
                  * _reshape_axis(self.x_faces[1], 1, 2))
        return a_.astype(self.dtype)
