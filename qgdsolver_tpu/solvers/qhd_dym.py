"""QHDDyMFoam — QHD on a moving/deforming mesh.

Re-design of reference QGDsolver/QHDDyMFoam (QHDDyMFoam_8C_source.html:
44-60 createDynamicFvMesh, :109-135 mesh.update() + fvc::makeRelative(phi,U)
+ mesh-Courant check).  The structured-mesh counterpart supports
two prescribed motion classes:

* rigid translation (`mesh_velocity`: t -> (ndim,)) — the convective flux
  is made relative to the mesh face flux and the Courant number uses the
  relative face speed;
* per-axis dilation (`mesh_scale`: t -> (ndim,) scale factors, physical
  faces x_a(t) = s_a(t)*xi_a) — the step runs on the logical grid with
  metric factors on every operator, discrete-GCL-exact mesh face fluxes
  (Thomas-Lombard mixed-area weighting) and moving-volume ddt, so a uniform
  field on an oscillating-compression grid is preserved to solver tolerance
  (the space-conservation property of the reference's mesh.update() path).

* GENERAL per-axis 1-D face motion (`mesh_faces`: t -> tuple of (n_a+1,)
  strictly-increasing face-coordinate arrays) — pistons, oscillating
  walls, moving refinement zones.  OpenFOAM's mesh.update() order:
  Courant + setDeltaT on the pre-motion mesh, then the WHOLE step on the
  post-motion geometry (a per-trace `core.mesh.TracedMesh`), with
  moving-volume ddt and Thomas-Lombard mixed-area mesh fluxes (discrete
  GCL exact).  Subsumes the other two motion classes.

Rigid + dilation may be combined.  Implemented as the shared QHD step with
the motion hooks set (solvers/qhd.py step: metric factors / TracedMesh,
phim / sweep assembly).
"""
from __future__ import annotations

from .qhd import QHDFoam, State  # noqa: F401


def QHDDyMFoam(*, mesh_velocity=None, mesh_scale=None, mesh_faces=None,
               **kwargs) -> QHDFoam:
    """mesh_velocity: callable t -> (ndim,) rigid mesh velocity;
    mesh_scale: callable t -> (ndim,) per-axis dilation factors;
    mesh_faces: callable t -> tuple of per-axis face-coordinate arrays
    (the general motion spec; exclusive with the other two)."""
    assert (mesh_velocity is not None or mesh_scale is not None
            or mesh_faces is not None)
    return QHDFoam(mesh_velocity=mesh_velocity, mesh_scale=mesh_scale,
                   mesh_faces=mesh_faces, **kwargs)
