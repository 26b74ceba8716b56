"""Matrix-free linear solvers for the implicit steps.

The reference delegates every `fvm::laplacian` solve (pressure Poisson
QHDpEqn_8H_source.html:36-45, implicit diffusion QGDUEqn_8H_source.html:54-75)
to OpenFOAM's distributed PCG/GAMG.  The replacement here is a
matrix-free preconditioned conjugate gradient in `jax.lax.while_loop`: the
matvec is the same fused stencil laplacian as the explicit operators, the
whole Krylov loop stays on device (dot products lower to `psum` under
sharding), and no sparse matrix is ever materialised.

For singular pure-Neumann Poisson systems the nullspace (constants) is
projected out of rhs and iterates — the analogue of OpenFOAM's
`pEqn.setReference(pRefCell, ...)` (QHDpEqn_8H_source.html:43).
"""
from __future__ import annotations

import dataclasses
import typing as tp
from functools import partial

import jax
import jax.numpy as jnp

from ..core.mesh import Mesh
from ..core import bc as bcm
from ..parallel import spmd
from . import fvsc


@dataclasses.dataclass(frozen=True)
class CGResult:
    x: tp.Any
    iters: tp.Any
    residual: tp.Any  # final |r| / normFactor


def _dot(a, b):
    """Inner product — a psum over the device mesh under an spmd context
    (the distributed-CG reduction of OpenFOAM's parallel PCG)."""
    return spmd.all_sum(jnp.sum(a * b))


def cg(matvec, b, x0, *, tol=1e-7, maxiter=1000, precond=None, project=None):
    """Preconditioned conjugate gradient, fully on-device.

    matvec : linear operator (must be symmetric positive (semi)definite)
    precond: approximate inverse (e.g. Jacobi); identity if None
    project: nullspace projector applied to b, x and residuals (for the
             singular Neumann-Poisson case)
    Convergence: |r|_2 <= tol * |b|_2 (plus iteration cap), computed without
    host sync.
    """
    if project is not None:
        b = project(b)
        x0 = project(x0)
    M = precond if precond is not None else (lambda r: r)

    r0 = b - matvec(x0)
    if project is not None:
        r0 = project(r0)
    z0 = M(r0)
    if project is not None:
        # a nonuniform preconditioner reintroduces nullspace components;
        # leaving them in the search directions makes p.Ap collapse while
        # rz stays finite (alpha blow-up) — project z, not just Ap
        z0 = project(z0)
    norm_b = jnp.sqrt(_dot(b, b))
    norm_b = jnp.where(norm_b > 0, norm_b, 1.0)

    # |r|^2 is computed in the BODY and carried, so the while cond stays
    # collective-free (required for psum-bearing dots under shard_map)
    def cond(carry):
        x, r, z, p_, rz, rr, it, ok = carry
        return jnp.logical_and(
            ok, jnp.logical_and(rr > jnp.square(tol * norm_b),
                                it < maxiter))

    def body(carry):
        x, r, z, p_, rz, rr, it, ok = carry
        Ap = matvec(p_)
        if project is not None:
            Ap = project(Ap)
        alpha = rz / jnp.maximum(_dot(p_, Ap), jnp.finfo(b.dtype).tiny)
        x = x + alpha * p_
        r = r - alpha * Ap
        z = M(r)
        if project is not None:
            z = project(z)
        rz_new = _dot(r, z)
        beta = rz_new / jnp.maximum(rz, jnp.finfo(b.dtype).tiny)
        p_ = z + beta * p_
        rr_new = _dot(r, r)
        # SPD breakdown guard: rz must stay positive; once the residual is
        # pure rounding noise (a near-zero rhs) the recurrence degrades —
        # stop with the current (already converged) iterate instead of
        # grinding to NaN
        ok = jnp.logical_and(jnp.isfinite(rr_new), rz_new > 0)
        return (x, r, z, p_, rz_new, rr_new, it + 1, ok)

    init = (x0, r0, z0, z0, _dot(r0, z0), _dot(r0, r0), jnp.asarray(0),
            jnp.asarray(True))
    x, r, _, _, _, rr, it, _ = jax.lax.while_loop(cond, body, init)
    if project is not None:
        x = project(x)
    return CGResult(x=x, iters=it, residual=jnp.sqrt(rr) / norm_b)


# ---------------------------------------------------------------------------
# Helmholtz / Poisson assembly helpers (the fvm::laplacian replacements)
# ---------------------------------------------------------------------------


def face_fluid_masks(solid, mesh: Mesh):
    """Per-axis face multipliers for a stairstep solid mask: 1 on
    fluid-fluid interior faces and on domain-boundary faces of fluid cells,
    0 on every face touching a solid cell (zero-flux immersed wall).

    This is the masked-operator counterpart of the reference's mesh-agnostic
    pEqn (QHDpEqn_8H_source.html:33-48): OpenFOAM's unstructured mesh simply
    omits solid cells; the structured design keeps the bounding box and
    zeroes their faces, which renders the masked Helmholtz operator
    symmetric positive (semi)definite on the fluid subspace.
    """
    import numpy as np_

    fluid = ~np_.asarray(solid, dtype=bool)
    nd = mesh.ndim
    masks = []
    for a in range(nd):
        lo = np_.take(fluid, [0], axis=a)
        hi = np_.take(fluid, [-1], axis=a)
        ext = np_.concatenate([lo, fluid, hi], axis=a)
        sl_lo = [slice(None)] * nd
        sl_lo[a] = slice(0, -1)
        sl_hi = [slice(None)] * nd
        sl_hi[a] = slice(1, None)
        masks.append(jnp.asarray(
            (ext[tuple(sl_lo)] & ext[tuple(sl_hi)]).astype(mesh.dtype)))
    return tuple(masks)


def helmholtz_affine(x, *, diag_coeff, gamma_faces, bcs, mesh: Mesh, t=0.0,
                     vector=False):
    """Affine operator A(x) = diag_coeff*x - laplacian(Gamma_f, x) with BCs.

    This is the discretization of `fvm::Sp(diag) - fvm::laplacian(Gamma, x)`
    used by every implicit step in the reference solver family.
    """
    lap = fvsc.laplacian_explicit(gamma_faces, x, bcs, mesh, t=t, vector=vector)
    return diag_coeff * x - lap


def helmholtz_diag(*, diag_coeff, gamma_faces, mesh: Mesh):
    """Jacobi diagonal of the Helmholtz operator on a rectilinear mesh:
    diag + sum_f Gamma_f*|S_f| / (d_cc * V)."""
    nd = mesh.ndim
    vol = mesh.cell_volume
    tot = 0.0
    for a in range(nd):
        g = gamma_faces[a] * mesh.face_area(a)
        d = mesh.bcast(mesh.d_centers[a], a)
        w = g / d
        sl_lo = [slice(None)] * w.ndim
        sl_lo[w.ndim - nd + a] = slice(0, -1)
        sl_hi = [slice(None)] * w.ndim
        sl_hi[w.ndim - nd + a] = slice(1, None)
        tot = tot + w[tuple(sl_lo)] + w[tuple(sl_hi)]
    return diag_coeff + tot / vol


def solve_helmholtz(*, diag_coeff, gamma_faces, rhs, x0, bcs, mesh: Mesh,
                    t=0.0, vector=False, tol=1e-7, maxiter=1000,
                    singular=False, fluid_mask=None,
                    solid_wall_dirichlet=False):
    """Solve diag*x - lap(Gamma_f, x) = rhs under `bcs`.

    The affine BC contribution is split off (homogeneous-BC linear part feeds
    CG; A(0) moves to the rhs) so arbitrary FixedValue/FixedGradient BCs work
    with a symmetric matvec.  `singular=True` enables mean-projection for the
    pure-Neumann pressure equation (OpenFOAM pRefCell equivalent — the
    returned field has zero mean; callers re-add their reference level, as
    QHDFoam does at QHDFoam_8C_source.html:123-131).

    fluid_mask: static boolean FLUID-cell array for stairstep solid meshes.
    Faces touching solid cells carry zero flux (face_fluid_masks), solid
    rows become a decoupled identity block with zero rhs, and the singular
    projector acts on the fluid subspace only — the masked counterpart of
    the reference's mesh-agnostic pEqn (QHDpEqn_8H_source.html:33-48).
    With solid_wall_dirichlet=True the immersed faces instead behave as
    homogeneous Dirichlet walls (the no-slip mirror G = -x across the
    face adds +2*Gamma_f*|S_f|/(d*V) to the adjacent fluid diagonal) —
    what a body-fitted fixedValue-0 wall BC contributes.
    """
    solid_sel = None
    wall_diag = 0.0
    if fluid_mask is not None:
        import numpy as np_

        fm = np_.asarray(fluid_mask, dtype=bool)
        solid_np = ~fm
        fmasks = face_fluid_masks(solid_np, mesh)
        if solid_wall_dirichlet:
            # per-axis immersed-wall face masks: exactly one side solid
            # (domain-boundary faces replicate and never qualify)
            nd = mesh.ndim
            wall_diag = jnp.zeros(mesh.shape, dtype=mesh.dtype)
            for a in range(nd):
                lo = np_.take(fm, [0], axis=a)
                hi = np_.take(fm, [-1], axis=a)
                ext = np_.concatenate([lo, fm, hi], axis=a)
                sl_lo = [slice(None)] * nd
                sl_lo[a] = slice(0, -1)
                sl_hi = [slice(None)] * nd
                sl_hi[a] = slice(1, None)
                wmask = jnp.asarray(
                    (ext[tuple(sl_lo)] != ext[tuple(sl_hi)])
                    .astype(mesh.dtype))
                gw = jnp.broadcast_to(
                    gamma_faces[a] * wmask * mesh.face_area(a)
                    / mesh.bcast(mesh.d_centers[a], a),
                    wmask.shape)
                cl = [slice(None)] * nd
                cl[a] = slice(0, -1)
                ch = [slice(None)] * nd
                ch[a] = slice(1, None)
                wall_diag = wall_diag + 2.0 * (gw[tuple(cl)]
                                               + gw[tuple(ch)])
            wall_diag = (wall_diag / mesh.cell_volume
                         * jnp.asarray(fm.astype(mesh.dtype)))
        gamma_faces = tuple(g * m for g, m in zip(gamma_faces, fmasks))
        fluid_f = jnp.asarray(fm.astype(mesh.dtype))
        solid_sel = jnp.asarray(solid_np)
        rhs = jnp.where(solid_sel, 0.0, rhs)
        x0 = jnp.where(solid_sel, 0.0, x0)

    bcs_h = bcs.map(bcm.homogeneous)
    aff = partial(
        helmholtz_affine, diag_coeff=diag_coeff, gamma_faces=gamma_faces,
        mesh=mesh, t=t, vector=vector,
    )

    def add_solid(ax, x):
        # decoupled unit rows keep the operator SPD when diag_coeff == 0;
        # wall_diag carries the immersed no-slip Dirichlet contribution
        if solid_sel is None:
            return ax
        return ax + jnp.where(solid_sel, x, 0.0) + wall_diag * x

    a0 = aff(jnp.zeros_like(rhs), bcs=bcs)

    def matvec(x):
        return add_solid(aff(x, bcs=bcs_h), x)

    b = rhs - a0

    diag = helmholtz_diag(diag_coeff=diag_coeff, gamma_faces=gamma_faces, mesh=mesh)
    if solid_sel is not None:
        diag = diag + jnp.where(solid_sel, 1.0, 0.0) + wall_diag
    diag = jnp.broadcast_to(diag, rhs.shape)

    def precond(r):
        return r / diag

    project = None
    if singular:
        vol = jnp.broadcast_to(mesh.cell_volume, mesh.shape)
        if solid_sel is not None:
            vol = vol * fluid_f
        vtot = spmd.all_sum(jnp.sum(vol))

        def project(f):  # noqa: F811 — volume-weighted mean removal
            m = spmd.all_sum(jnp.sum(f * vol)) / vtot
            if solid_sel is not None:
                return f - jnp.where(solid_sel, 0.0, m)
            return f - m

    return cg(matvec, b, x0, tol=tol, maxiter=maxiter, precond=precond,
              project=project)
