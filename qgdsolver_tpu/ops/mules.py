"""MULES — multidimensional universal limiter for explicit solution.

The reference uses OpenFOAM's `MULES::explicitSolve`/`MULES::limit` for
bounded scalar advection (mulesQHDFoam T-equation, MULESTEqn_8H_source.html:
41-64, with global gMax/gMin bounds; interQHDFoam alpha1-equation,
interQHDFoam_8C_source.html:246-273).  MULES is a flux-corrected-transport
limiter of the Zalesak family; the implementation below is the
classic Zalesak limiter with the same structure (low-order upwind transport +
limited antidiffusive correction, iterated), expressed as pure per-axis array
ops — every quantity is a fixed-pattern stencil, no cell loops.

All fluxes are area-included face values; `phi` is the volumetric transport
flux, `phiH` the high-order scalar flux to be limited toward upwind.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.mesh import Mesh


def _upwind_flux(T, phi, mesh: Mesh, a: int):
    """Low-order (upwind-donor) face flux of T along axis a with mirrored
    boundary donors."""
    nd = mesh.ndim
    pad_lo = jnp.take(T, jnp.asarray([0]), axis=T.ndim - nd + a)
    pad_hi = jnp.take(T, jnp.asarray([-1]), axis=T.ndim - nd + a)
    Te = jnp.concatenate([pad_lo, T, pad_hi], axis=T.ndim - nd + a)
    ax = Te.ndim - nd + a
    lo = jnp.take(Te, jnp.arange(Te.shape[ax] - 1), axis=ax)  # donor if phi>0
    hi = jnp.take(Te, jnp.arange(1, Te.shape[ax]), axis=ax)
    return jnp.where(phi >= 0, lo, hi) * phi


def _cell_sums(corr, mesh: Mesh):
    """(P_in, P_out): per-cell sums of incoming / outgoing antidiffusive flux.
    Outward sign convention: at a cell's high face the outward flux is +corr,
    at its low face it is -corr."""
    nd = mesh.ndim
    p_in = 0.0
    p_out = 0.0
    for a, c in enumerate(corr):
        ax = c.ndim - nd + a
        n = c.shape[ax]
        c_lo = jnp.take(c, jnp.arange(0, n - 1), axis=ax)  # cell's low face
        c_hi = jnp.take(c, jnp.arange(1, n), axis=ax)  # cell's high face
        p_in = p_in + jnp.maximum(c_lo, 0.0) + jnp.maximum(-c_hi, 0.0)
        p_out = p_out + jnp.maximum(-c_lo, 0.0) + jnp.maximum(c_hi, 0.0)
    return p_in, p_out


def limit(T, phi, phiH, dt, mesh: Mesh, t_max, t_min, n_iter: int = 3,
          eps: float = 1e-30):
    """Return limited face fluxes lam*phiH + (1-lam)*phiBD (per-axis tuple).

    T      : transported cell field (old values)
    phi    : per-axis volumetric face fluxes
    phiH   : per-axis high-order scalar face fluxes
    t_max/t_min : per-cell bounds (arrays or scalars; MULESTEqn uses global
                  gMax/gMin, interQHDFoam uses [0,1])
    """
    nd = mesh.ndim
    vol = mesh.cell_volume
    phiBD = tuple(_upwind_flux(T, phi[a], mesh, a) for a in range(nd))
    corr = tuple(phiH[a] - phiBD[a] for a in range(nd))

    # low-order provisional solution
    divBD = 0.0
    for a in range(nd):
        ax = phiBD[a].ndim - nd + a
        n = phiBD[a].shape[ax]
        divBD = divBD + (
            jnp.take(phiBD[a], jnp.arange(1, n), axis=ax)
            - jnp.take(phiBD[a], jnp.arange(0, n - 1), axis=ax)
        )
    T_low = T - dt * divBD / vol

    lam = tuple(jnp.ones_like(c) for c in corr)
    for _ in range(n_iter):
        lcorr = tuple(lam[a] * corr[a] for a in range(nd))
        p_in, p_out = _cell_sums(lcorr, mesh)
        q_in = (t_max - T_low) * vol / dt
        q_out = (T_low - t_min) * vol / dt
        r_in = jnp.minimum(1.0, jnp.maximum(q_in, 0.0) / (p_in + eps))
        r_out = jnp.minimum(1.0, jnp.maximum(q_out, 0.0) / (p_out + eps))
        new_lam = []
        for a in range(nd):
            ax = corr[a].ndim - nd + a
            pad = [(0, 0)] * corr[a].ndim
            pad[ax] = (1, 1)
            ri = jnp.pad(r_in, pad, mode="edge")
            ro = jnp.pad(r_out, pad, mode="edge")
            n = corr[a].shape[ax]
            # face between cells (k-1, k): positive corr = out of k-1 into k
            ro_up = jnp.take(ro, jnp.arange(0, n), axis=ax)
            ri_dn = jnp.take(ri, jnp.arange(1, n + 1), axis=ax)
            ri_up = jnp.take(ri, jnp.arange(0, n), axis=ax)
            ro_dn = jnp.take(ro, jnp.arange(1, n + 1), axis=ax)
            lam_a = jnp.where(
                corr[a] >= 0,
                jnp.minimum(ro_up, ri_dn),
                jnp.minimum(ri_up, ro_dn),
            )
            new_lam.append(lam_a * lam[a])
        lam = tuple(new_lam)

    return tuple(phiBD[a] + lam[a] * corr[a] for a in range(nd))


def explicit_solve(T, phi, phiH, dt, mesh: Mesh, t_max, t_min, n_iter: int = 3):
    """MULES::explicitSolve equivalent: bounded explicit update of T
    (MULESTEqn_8H_source.html:44-54)."""
    flux = limit(T, phi, phiH, dt, mesh, t_max, t_min, n_iter=n_iter)
    nd = mesh.ndim
    div = 0.0
    for a in range(nd):
        ax = flux[a].ndim - nd + a
        n = flux[a].shape[ax]
        div = div + (
            jnp.take(flux[a], jnp.arange(1, n), axis=ax)
            - jnp.take(flux[a], jnp.arange(0, n - 1), axis=ax)
        )
    return T - dt * div / mesh.cell_volume, flux
