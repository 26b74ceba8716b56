"""QGDFoam — compressible all-Mach viscous perfect-gas QGD solver (flagship).

Re-design of reference QGDsolver/QGDFoam (QGDFoam_8C_source.html:68-163).
Per step:
  updateFields.H  (QGDFoam_2updateFields_8H:45-80): interpolate
    rho,U,rhoU,U*rhoU,p,c,gamma,Cp,H=(rhoE+p)/rho, muEff, alphaEff to faces
  updateFluxes.H  (QGDFoam_2updateFluxes_8H:41-139):
    gradUf/gradef/gradRhof/gradPf = fvsc::grad;  divUf = tr(gradUf)
    rhoW  = tau_f*((Uf.gradRhof)Uf + rhoUf*divUf + (rhoUf.grad)Uf)
    phiwStar = Sf&rhoW;  rhoW += tau_f*gradPf;  jm = rhoUf - rhoW
    Pif   = tau_f*((UrhoUf.gradUf) + Uf*gradPf
                   + I((Uf.gradPf) + gammaf*pf*divUf)) [+ NS stress if expl.]
    qf    = -tau_f*(UrhoUf.(gradef - (pf/rhof^2) gradRhof)) [- alphau_f gradef]
  QGDCourantNo.H + setDeltaT (acoustic CFL + cTau cap)
  QGDRhoEqn.H : ddt(rho)  + div(phiJm) = rhoSu          (explicit)
  QGDUEqn.H   : ddt(rhoU) + div(phiJm*Uf + Sf*pf - Sf&Pif) = 0; U = rhoU/rho;
                implicitDiffusion: solve rho/dt(U-U*) - lap(muEff_f,U)
                = div(phiTauMC) + rhoUSu, phiTauMC = Sf&interp(muEff*
                dev2(grad(U)^T));  sigmaDotU for the energy eqn
  QGDEEqn.H   : ddt(rhoE) + div(phiJm*Hf + phiQ - Sf&(Pif&Uf)
                - phiSigmaDotU) = 0; e = rhoE/rho - |U|^2/2;
                implicitDiffusion: rho/dt(e-e*) - lap(alphaEff_f,e) = rhoESu
  closure     : p = rho/psi (QGDFoam_8C:149-156)

Primitive ghosts are derived thermodynamically from the p/T/U boundary
conditions (rho_ghost = p_ghost*psi(T_ghost) etc.), matching OpenFOAM's
calculated rho/e patches; each primitive is ghost-padded once and reused by
all four fvsc gradients — one HBM pass per primitive.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp

from ..core.mesh import Mesh
from ..core import bc as bcm
from ..ops import fvsc, linsolve
from ..ops.pad import ghost_pad
from ..physics.thermo import PerfectGasThermo
from ..physics.qgdcoeffs import TauModel, ConstScPrModel1
from . import common
from .common import TimeControls


class State(tp.NamedTuple):
    rho: jax.Array
    rhoU: jax.Array  # (d, *cells)
    rhoE: jax.Array
    sc: jax.Array  # ScQGD carried state (varScModel5 relaxation)
    t: jax.Array
    dt: jax.Array
    # lagged qgdFlux p-BC gradients, one per QGDFluxP-marked (axis, side):
    # dp/dn = -phiwStar/(tau_f*|Sf|) from the PREVIOUS step's fluxes, exactly
    # like the reference's updateCoeffs lookup of the registered phiwStar
    # (qgdFluxFvPatchScalarField_8C updateCoeffs, gradient at :192)
    pbc: tp.Tuple[jax.Array, ...] = ()
    # waveTransmissive carried patch face values, one per marker-tagged
    # (field, axis, side) — advanced each step by the implicit-upwind
    # advective update at speed max(Un,0)+c (core/bc.py WaveTransmissive)
    wt: tp.Tuple[jax.Array, ...] = ()


@dataclasses.dataclass(frozen=True)
class QGDFoam:
    mesh: Mesh
    thermo: PerfectGasThermo
    tau_model: TauModel = ConstScPrModel1()
    bc_U: tp.Optional[bcm.FieldBCs] = None
    bc_p: tp.Optional[bcm.FieldBCs] = None
    bc_T: tp.Optional[bcm.FieldBCs] = None
    time: TimeControls = TimeControls()
    implicit_diffusion: bool = False
    cg_tol: float = 1e-8
    cg_maxiter: int = 500
    fvsc_scheme: tp.Any = "full"  # word or {term: word} dict
    # qgdFlux robustness for shocks sitting ON the patch (VERDICT r4 weak
    # #4): the reference BC's lagged dp/dn = -phiwStar/(tau_f|Sf|)
    # (qgdFluxFvPatchScalarField_8C updateCoeffs) feeds its own w_star
    # back through the ghost pressure when a steady shock stands on the
    # patch; OpenFOAM's implicit p-solves damp the loop, the explicit
    # path needs a face-local limiter.  qgdflux_limit clamps |dp/dn| to
    # limit x the interior |snGrad p| at the patch-adjacent faces;
    # qgdflux_relax under-relaxes the carried gradient.  Defaults (None,
    # 1.0) reproduce the reference BC verbatim.
    qgdflux_limit: tp.Optional[float] = None
    qgdflux_relax: float = 1.0

    def _bcs(self):
        nd = self.mesh.ndim
        bu = self.bc_U or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        bp = self.bc_p or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        bt = self.bc_T or bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        return bu, bp, bt

    def _flux_sides(self):
        """(axis, side) pairs carrying the qgdFlux p BC."""
        _, bp, _ = self._bcs()
        return tuple(
            (a, side)
            for a in range(self.mesh.ndim)
            for side in (0, 1)
            if isinstance(bp[a, side], bcm.QGDFluxP)
        )

    def _pbc_zeros(self, dtype):
        out = []
        for a, side in self._flux_sides():
            shape = list(self.mesh.shape)
            shape[a] = 1
            out.append(jnp.zeros(tuple(shape), dtype=dtype))
        return tuple(out)

    def _wt_sides(self):
        """(field, axis, side, bc) tuples carrying waveTransmissive markers
        across the p/T/U boundary sets."""
        bu, bp, bt = self._bcs()
        out = []
        for key, bcs in (("p", bp), ("T", bt), ("U", bu)):
            for a in range(self.mesh.ndim):
                for side in (0, 1):
                    b = bcs[a, side]
                    if isinstance(b, bcm.WaveTransmissive):
                        out.append((key, a, side, b))
        return tuple(out)

    def _wt_init(self, p0, T0, U0):
        """Initial carried face values: the patch-adjacent cell layer."""
        fields = {"p": p0, "T": T0, "U": U0}
        nd = self.mesh.ndim
        out = []
        for key, a, side, _ in self._wt_sides():
            f = fields[key]
            idx = 0 if side == 0 else -1
            out.append(jnp.take(f, jnp.asarray([idx]),
                                axis=f.ndim - nd + a))
        return tuple(out)

    def init(self, p0, T0, U0, t0=0.0, sc0=None) -> State:
        th = self.thermo
        p0, T0, U0 = jnp.asarray(p0), jnp.asarray(T0), jnp.asarray(U0)
        rho = th.rho_from_p_T(p0, T0)
        e = th.e_from_T(T0)
        rhoU = rho[None] * U0
        rhoE = rho * e + 0.5 * rho * jnp.sum(U0 * U0, axis=0)
        sc = jnp.zeros_like(rho) if sc0 is None else jnp.asarray(sc0)
        dt = jnp.asarray(self.time.dt0, dtype=rho.dtype)
        return State(rho=rho, rhoU=rhoU, rhoE=rhoE, sc=sc,
                     t=jnp.asarray(t0, dtype=rho.dtype), dt=dt,
                     pbc=self._pbc_zeros(rho.dtype),
                     wt=self._wt_init(p0, T0, U0))

    # -- primitive reconstruction ------------------------------------------
    def primitives(self, s: State):
        th = self.thermo
        U = s.rhoU / s.rho[None]
        e = s.rhoE / s.rho - 0.5 * jnp.sum(U * U, axis=0)
        T = th.T_from_e(e)
        p = th.p_from_rho_T(s.rho, T)
        return U, e, T, p

    def make_step(self, external_sources: bool = False):
        """Build the jitted step.

        external_sources=True: the returned step takes
        (state, (rhoSu, rhoUSu, rhoESu)) — the createZeroSources.H slots used
        by the Lagrangian solvers (particlesQGDFoam_8C:125-130 sets
        rhoUSu = parcels.SU(U), rhoESu = parcels.Sh(e)).
        """
        mesh = self.mesh
        nd = mesh.ndim
        th = self.thermo
        bc_U, bc_p0, bc_T = self._bcs()
        tc = self.time
        scheme = self.fvsc_scheme  # one word or per-term dict (fvsc_8C:47-58)
        sch_U = fvsc.scheme_for(scheme, "grad(U)")
        sch_e = fvsc.scheme_for(scheme, "grad(e)")
        sch_rho = fvsc.scheme_for(scheme, "grad(rho)")
        sch_p = fvsc.scheme_for(scheme, "grad(p)")
        bc_zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), nd)
        area = tuple(mesh.face_area(a) for a in range(nd))

        # stairstep immersed solid regions (dead cells of L-shaped
        # multi-block meshes): mirror-ghost fill before the step + solid
        # clamp after — see core.solid.StairstepSolid
        wall = None
        fluid_mask = None
        if getattr(mesh, "solid", None) is not None:
            import numpy as _np

            from ..core.solid import StairstepSolid

            wall = StairstepSolid(mesh.solid)
            # implicit diffusion on masked meshes: the same masked Helmholtz
            # the QHD family uses (linsolve fluid_mask; no-slip immersed
            # Dirichlet for U, zero-flux for e) — reference parity:
            # QGDUEqn_8H_source.html:54-75 works on any mesh
            fluid_mask = ~_np.asarray(mesh.solid, dtype=bool)

        # waveTransmissive sides (carried face values, substituted per step)
        wt_sides = self._wt_sides()
        wt_has_T = any(k == "T" for k, _, _, _ in wt_sides)
        # e-BCs derived from T-BCs: e_wall = e(T_wall) (sensibleInternalEnergy)
        bc_e = (None if wt_has_T else
                common.e_bcs_from_T(bc_T, th.e_from_T, getattr(th, "Cv", None)))
        # trace-time constant gamma for calorically perfect gases; None for
        # variable-cp thermos (JANAF), whose gamma field is interpolated to
        # faces per step like the reference's updateFields gamma interp
        gamma_const = getattr(th, "gamma", None)

        flux_sides = self._flux_sides()

        def step(s: State, srcs=None) -> State:
            rho, rhoU, rhoE, sc_prev, t, dt = s[:6]
            # substitute lagged qgdFlux gradients into the p BCs
            bc_p = bc_p0
            for i, (a, side) in enumerate(flux_sides):
                bc_p = bc_p.replace(a, side, bcm.FixedGradient(s.pbc[i]))
            U, e, T, p = self.primitives(s)
            if wall is not None:
                # mirror-ghost fill of solid boundary cells: shared faces
                # see zero normal velocity + the wall pressure mirror
                T = wall.mirror(T)
                p = wall.mirror(p)
                U = wall.mirror_vector(U)
                e = jnp.where(wall.boundary, th.e_from_T(T), e)
                rho = jnp.where(wall.boundary, th.rho_from_p_T(p, T), rho)
                rhoU = jnp.where(wall.boundary[None], rho[None] * U, rhoU)
                rhoE = jnp.where(wall.boundary,
                                 rho * e + 0.5 * rho * jnp.sum(U * U, 0),
                                 rhoE)
            # waveTransmissive: OpenFOAM advectiveFvPatchField::updateCoeffs
            # (Euler ddt) from the current fields and the carried old face
            # value — the BC acts as the mixed condition
            #   face = frac*ref + (1-frac)*cell,
            #   ref = (v_old + k*field_inf)/(1+k),
            #   frac = (1+k)/(1+alpha+k),  alpha = w dt/delta,  k = w dt/lInf
            # at the outgoing wave speed w = max(Un,0)+c (waveTransmissive
            # advectionSpeed).
            bc_Uw, bc_Tw = bc_U, bc_T
            wt_ref, wt_frac = [], []
            for i, (key, a, side, b) in enumerate(wt_sides):
                idx = 0 if side == 0 else -1

                def take_edge(f, a=a, idx=idx):
                    return jnp.take(f, jnp.asarray([idx]),
                                    axis=f.ndim - nd + a)

                Un = take_edge(U[a]) * (1.0 if side else -1.0)
                w = jnp.maximum(Un, 0.0) + th.c_from_pT(take_edge(p),
                                                        take_edge(T))
                delta = 0.5 * jnp.asarray(mesh.dx[a][-1 if side else 0],
                                          dtype=w.dtype)
                al = w * dt / delta
                k = (w * dt / b.l_inf) if b.l_inf > 0 else 0.0
                ref = (s.wt[i] + k * b.field_inf) / (1.0 + k)
                frac = (1.0 + k) / (1.0 + al + k)
                wt_ref.append(ref)
                wt_frac.append(frac)
                sub = bcm.Mixed(ref, frac)
                if key == "p":
                    bc_p = bc_p.replace(a, side, sub)
                elif key == "T":
                    bc_Tw = bc_Tw.replace(a, side, sub)
                else:
                    bc_Uw = bc_Uw.replace(a, side, sub)
            bc_ew = (common.e_bcs_from_T(bc_Tw, th.e_from_T,
                                         getattr(th, "Cv", None))
                     if wt_has_T else bc_e)

            # resolve inletOutlet markers against the current flow direction
            bc_Ur = bcm.resolve_inlet_outlet(bc_Uw, U, nd)
            bc_Tr = bcm.resolve_inlet_outlet(bc_Tw, U, nd)
            bc_p = bcm.resolve_inlet_outlet(bc_p, U, nd)
            bc_er = bcm.resolve_inlet_outlet(bc_ew, U, nd)
            c = th.c_from_pT(p, T)
            mu_mol = th.mu(p, T)
            alphau_mol = th.alphah(p, T)

            # --- thermo.correct(): tau coefficients + effective transport
            coeffs = self.tau_model.correct(
                mesh, c=c, p=p, rho=rho, sc_prev=sc_prev, mu=mu_mol,
                bc_p=bc_p, t=t,
            )
            tau_f = coeffs.tau_f
            mu_eff = mu_mol + coeffs.mu_qgd
            alphau_eff = alphau_mol + coeffs.alphau_qgd

            # --- qgdFlux p BC needs phiwStar: substitute after flux assembly;
            # gradients here use the previous-step convention (zero-order) —
            # build padded primitives with the *configured* BCs first.
            p_pad = ghost_pad(p, bc_p, mesh, t=t)
            T_pad = ghost_pad(T, bc_Tr, mesh, t=t)
            U_pad = ghost_pad(U, bc_Ur, mesh, t=t, vector=True)
            # thermodynamically-consistent derived ghosts
            rho_pad = th.rho_from_p_T(p_pad, T_pad)
            e_pad = th.e_from_T(T_pad)
            rhoU_pad = rho_pad[None] * U_pad
            rhoE_pad = rho_pad * e_pad + 0.5 * rho_pad * jnp.sum(U_pad * U_pad, axis=0)
            H_pad = (rhoE_pad + p_pad) / rho_pad
            c_pad = th.c_from_pT(p_pad, T_pad)

            # --- updateFields.H: face interpolations
            rhof = fvsc.interp_from_padded(rho_pad, mesh)
            Uf = fvsc.interp_from_padded(U_pad, mesh)
            rhoUf = fvsc.interp_from_padded(rhoU_pad, mesh)
            # UrhoUf = interp(U*rhoU) (QGDFoam_2updateFields_8H:55) — the
            # nonlinear product is interpolated, NOT the product of
            # interpolants; only row a is needed at a-faces.
            UrhoUf_row = tuple(
                fvsc.interp_axis_from_padded(U_pad[a] * rhoU_pad, mesh, a)
                for a in range(nd)
            )
            pf = fvsc.interp_from_padded(p_pad, mesh)
            cf = fvsc.interp_from_padded(c_pad, mesh)
            Hf = fvsc.interp_from_padded(H_pad, mesh)
            if gamma_const is not None:
                gammaf = tuple(gamma_const for _ in range(nd))
            else:
                gammaf = fvsc.interp_from_padded(th.gamma_of(T_pad), mesh)
            muf = fvsc.interpolate(mu_eff, bc_zg, mesh)
            alphauf = fvsc.interpolate(alphau_eff, bc_zg, mesh)

            # --- updateFluxes.H: fvsc gradients (the 4 hot stencil ops)
            gradUf = fvsc.grad_from_padded(U_pad, mesh, scheme=sch_U)
            gradef = fvsc.grad_from_padded(e_pad, mesh, scheme=sch_e)
            gradRhof = fvsc.grad_from_padded(rho_pad, mesh, scheme=sch_rho)
            gradPf = fvsc.grad_from_padded(p_pad, mesh, scheme=sch_p)

            # Flux assembly, fully unrolled over the (small, static) component
            # indices.  Two deliberate deviations from a naive translation,
            # both exact:
            #  * only ROW `a` of the Pi tensor is ever needed at a-faces
            #    (phiPi = Sf&Pif = area*Pif[a,:], phiPiU = area*Pif[a,:].Uf),
            #    so the other rows are never formed;
            #  * no stacked (d,d,faces) tensors / dot_generals — XLA fuses
            #    the scalar-component chains into elementwise kernels, where
            #    the tensor-shaped formulation materialises every product.
            phiJm = [None] * nd
            phiJmU = [None] * nd
            phiP = [None] * nd
            phiPi = [None] * nd
            phiJmH = [None] * nd
            phiQ = [None] * nd
            phiPiU = [None] * nd
            phiwStar = [None] * nd

            for a in range(nd):
                gU = gradUf[a]  # (i,j,faces)
                uf = Uf[a]
                ruf = rhoUf[a]
                divU = sum(gU[i, i] for i in range(nd))
                u_gradrho = sum(uf[i] * gradRhof[a][i] for i in range(nd))
                # (rhoU & gradU)_j = sum_i rhoU_i dU_j/dx_i
                rhoU_gradU = [
                    sum(ruf[i] * gU[i, j] for i in range(nd)) for j in range(nd)
                ]
                w_star = [
                    tau_f[a] * (u_gradrho * uf[j] + ruf[j] * divU + rhoU_gradU[j])
                    for j in range(nd)
                ]
                phiwStar[a] = w_star[a] * area[a]
                jm_n = ruf[a] - (w_star[a] + tau_f[a] * gradPf[a][a])
                phiJm[a] = jm_n * area[a]

                # momentum fluxes
                phiJmU[a] = phiJm[a] * uf
                phiP[a] = area[a] * pf[a]  # vector: normal component only
                u_gradp = sum(uf[i] * gradPf[a][i] for i in range(nd))
                iso = u_gradp + gammaf[a] * pf[a] * divU
                urr = UrhoUf_row[a]  # (k,faces): interp(U_a * rhoU_k)
                pi_row = []
                for j in range(nd):
                    pij = tau_f[a] * (
                        sum(urr[k] * gU[k, j] for k in range(nd))
                        + uf[a] * gradPf[a][j]
                        + (iso if j == a else 0.0)
                    )
                    if not self.implicit_diffusion:
                        pij = pij + muf[a] * (
                            gU[a, j] + gU[j, a]
                            - ((2.0 / 3.0) * divU if j == a else 0.0)
                        )
                    pi_row.append(pij)
                phiPi[a] = area[a] * jnp.stack(pi_row, axis=0)

                # energy fluxes
                phiJmH[a] = phiJm[a] * Hf[a]
                de = [
                    gradef[a][k] - (pf[a] / rhof[a] ** 2) * gradRhof[a][k]
                    for k in range(nd)
                ]
                q_n = -tau_f[a] * sum(urr[k] * de[k] for k in range(nd))
                if not self.implicit_diffusion:
                    q_n = q_n - alphauf[a] * gradef[a][a]
                phiQ[a] = q_n * area[a]
                phiPiU[a] = area[a] * sum(pi_row[j] * uf[j] for j in range(nd))

            # --- Courant + setDeltaT (acoustic)
            co = common.courant_acoustic(Uf, cf, dt, mesh)
            dt_new = common.set_delta_t(dt, co, common.tau_f_min(tau_f), tc)

            # external sources: tuple, or callable of the dt actually applied
            # (keeps parcel-exchange conservation exact under adaptive dt)
            if srcs is None:
                rhoSu = rhoUSu = rhoESu = 0.0
            elif callable(srcs):
                rhoSu, rhoUSu, rhoESu = srcs(dt_new)
            else:
                rhoSu, rhoUSu, rhoESu = srcs

            # --- QGDRhoEqn.H (explicit)
            rho_new = rho - dt_new * (fvsc.div_flux(tuple(phiJm), mesh) - rhoSu)
            if wall is not None:
                # solid cells are not prognostic: clamp to the mirror fill
                rho_new = jnp.where(wall.solid, rho, rho_new)

            # --- QGDUEqn.H
            mom_flux = tuple(phiJmU[a] + eye_vec(phiP[a], a, nd) - phiPi[a]
                             for a in range(nd))
            rhoU_new = rhoU - dt_new * (fvsc.div_flux(mom_flux, mesh) - rhoUSu)
            if mesh.axisymmetric:
                # wedge hoop terms (radial momentum; u_theta = 0): pressure
                # and Pi_theta_theta forces of the wedge side faces,
                # (p - Pi_tt)/r per volume, with
                #   Pi_tt = tau*(U.grad p + gamma*p*divU)
                #         [+ mu_eff*(2 u_r/r - (2/3) divU) when explicit]
                # and divU the conservative (cylindrical) velocity
                # divergence.  The p/r part balances the r-weighted
                # face-area divergence exactly, preserving uniform
                # freestreams discretely (AxisymmetricMesh identity).
                r_c = mesh.cell_coords(1)
                divU_cell = fvsc.div_flux(
                    tuple(Uf[a][a] * area[a] for a in range(nd)), mesh)
                # reuse the already-interpolated pf (same p_pad/bc_p):
                # saves a ghost_pad (a halo exchange per step under spmd)
                gradp_cell = fvsc.grad_cell_from_faces(pf, mesh)
                u_gradp_cell = sum(U[i] * gradp_cell[i] for i in range(nd))
                gam_c = (gamma_const if gamma_const is not None
                         else th.gamma_of(T))
                # the viscous hoop stress is ALWAYS explicit: the implicit
                # Helmholtz sub-step supplies only the coordinate laplacian
                # (no 1/r^2 hoop term), so this is its complement in both
                # diffusion modes (mirrors qhd.py's unconditional term)
                pi_tt = (coeffs.tau * (u_gradp_cell + gam_c * p * divU_cell)
                         + mu_eff * (2.0 * U[1] / r_c
                                     - (2.0 / 3.0) * divU_cell))
                rhoU_new = rhoU_new.at[1].add(dt_new * (p - pi_tt) / r_c)
            if wall is not None:
                rhoU_new = jnp.where(wall.solid[None], rhoU, rhoU_new)
            U_new = rhoU_new / rho_new[None]

            phiSigmaDotU = tuple(jnp.zeros_like(phiJm[a]) for a in range(nd))
            if self.implicit_diffusion:
                # tauMC = muEff*dev2(grad(U)^T); phiTauMC = Sf & interp(tauMC)
                gradU_cell = fvsc.grad_cell_vector(U, bc_Ur, mesh, t=t)
                if wall is not None:
                    # zg-parity at immersed faces (solid cells take the
                    # adjacent fluid cell's gradient — mirrors qhd.py)
                    gradU_cell = jnp.stack([
                        jnp.stack([wall.mirror(gradU_cell[i, j])
                                   for j in range(nd)])
                        for i in range(nd)])
                tauMC = mu_eff * dev2T(gradU_cell, nd)
                tauMC_f = fvsc.interpolate(
                    tauMC.reshape((nd * nd,) + mesh.shape), bc_zg, mesh
                )
                phiTauMC = tuple(
                    area[a] * tauMC_f[a].reshape((nd, nd) + mesh.face_shape(a))[a]
                    for a in range(nd)
                )
                rhs_U = (
                    rho_new * U_new / dt_new
                    + fvsc.div_flux(phiTauMC, mesh)
                )
                resU = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=muf, rhs=rhs_U,
                    x0=U_new, bcs=bc_Ur, mesh=mesh, t=t, vector=True,
                    tol=self.cg_tol, maxiter=self.cg_maxiter,
                    fluid_mask=fluid_mask, solid_wall_dirichlet=True,
                )
                U_new = resU.x
                if wall is not None:
                    # solid cells are not prognostic: restore the
                    # mirror-filled carry (the solve left them at 0)
                    U_new = jnp.where(wall.solid[None], U, U_new)
                rhoU_new = rho_new[None] * U_new
                # sigmaDotU = (muf*interp(grad U) + tauMC_f) & Uf
                gradU_lin_f = fvsc.interpolate(
                    gradU_cell.reshape((nd * nd,) + mesh.shape), bc_zg, mesh
                )
                phiSigmaDotU = tuple(
                    area[a]
                    * jnp.sum(
                        (
                            muf[a]
                            * gradU_lin_f[a].reshape((nd, nd) + mesh.face_shape(a))
                            + tauMC_f[a].reshape((nd, nd) + mesh.face_shape(a))
                        )[a]
                        * Uf[a],
                        axis=0,
                    )
                    for a in range(nd)
                )

            # --- QGDEEqn.H
            e_flux = tuple(phiJmH[a] + phiQ[a] - phiPiU[a] - phiSigmaDotU[a]
                           for a in range(nd))
            rhoE_new = rhoE - dt_new * (fvsc.div_flux(e_flux, mesh) - rhoESu)
            if wall is not None:
                rhoE_new = jnp.where(wall.solid, rhoE, rhoE_new)
            e_new = rhoE_new / rho_new - 0.5 * jnp.sum(U_new * U_new, axis=0)
            if self.implicit_diffusion:
                rhs_e = rho_new * e_new / dt_new
                resE = linsolve.solve_helmholtz(
                    diag_coeff=rho_new / dt_new, gamma_faces=alphauf, rhs=rhs_e,
                    x0=e_new, bcs=bc_er, mesh=mesh, t=t,
                    tol=self.cg_tol, maxiter=self.cg_maxiter,
                    fluid_mask=fluid_mask,
                )
                e_new = resE.x
                if wall is not None:
                    e_new = jnp.where(wall.solid, e, e_new)
                rhoE_new = rho_new * (e_new + 0.5 * jnp.sum(U_new * U_new, axis=0))

            # update the lagged qgdFlux gradients from this step's phiwStar
            pbc_new = []
            for i, (a, side) in enumerate(flux_sides):
                idx = 0 if side == 0 else -1
                ax = phiwStar[a].ndim - nd + a
                ws = jnp.take(phiwStar[a], jnp.asarray([idx]), axis=ax)
                tf = jnp.take(tau_f[a], jnp.asarray([idx]),
                              axis=tau_f[a].ndim - nd + a)
                sign = -1.0 if side == 0 else 1.0
                ar = jnp.broadcast_to(area[a] * jnp.ones_like(tau_f[a]),
                                      tau_f[a].shape)
                arb = jnp.take(ar, jnp.asarray([idx]), axis=ax)
                g = -sign * ws / (tf * arb)
                if self.qgdflux_limit is not None:
                    # face-local clamp: |dp/dn| <= limit * interior |snGrad|
                    axp = p.ndim - nd + a
                    pm1 = jnp.take(p, jnp.asarray([idx]), axis=axp)
                    pm2 = jnp.take(p, jnp.asarray([-2 if side else 1]),
                                   axis=axp)
                    dxe = jnp.asarray(mesh.dx[a][-1 if side else 0],
                                      dtype=p.dtype)
                    cap = self.qgdflux_limit * jnp.abs(pm1 - pm2) / dxe
                    g = jnp.clip(g, -cap, cap)
                if self.qgdflux_relax != 1.0:
                    g = ((1.0 - self.qgdflux_relax) * s.pbc[i]
                         + self.qgdflux_relax * g)
                # under spmd decomposition only the global-edge shard's row
                # is physical; broadcast it into the replicated carry
                pbc_new.append(common.spmd.edge_shard_value(g, a, side))

            # store the realized waveTransmissive face values: the mixed
            # condition evaluated against the updated interior cells
            wt_new = []
            for i, (key, a, side, b) in enumerate(wt_sides):
                idx = 0 if side == 0 else -1

                def take_edge(f, a=a, idx=idx):
                    return jnp.take(f, jnp.asarray([idx]),
                                    axis=f.ndim - nd + a)

                T_edge = th.T_from_e(take_edge(e_new))
                p_edge = th.p_from_rho_T(take_edge(rho_new), T_edge)
                phi_c = {"p": p_edge, "T": T_edge,
                         "U": take_edge(U_new)}[key]
                v = wt_frac[i] * wt_ref[i] + (1.0 - wt_frac[i]) * phi_c
                wt_new.append(common.spmd.edge_shard_value(v, a, side))

            return State(rho=rho_new, rhoU=rhoU_new, rhoE=rhoE_new,
                         sc=coeffs.sc, t=t + dt_new, dt=dt_new,
                         pbc=tuple(pbc_new), wt=tuple(wt_new))

        if external_sources:
            return step
        return lambda s: step(s, None)


def eye_vec(phiP_a, a, nd):
    """Embed the scalar normal-pressure flux as the a-component of a vector
    face flux (Sf * pf has only the normal component on a brick mesh)."""
    comps = [jnp.zeros_like(phiP_a) for _ in range(nd)]
    comps[a] = phiP_a
    return jnp.stack(comps, axis=0)


def dev2T(gradU_cell, nd):
    """dev2(T^t) = T^t - (2/3) tr(T) I  for T = grad(U) (OpenFOAM dev2 of the
    transposed gradient, used in tauMC — QGDFoam_2updateFluxes_8H:109)."""
    gT = jnp.swapaxes(gradU_cell, 0, 1)
    tr = sum(gradU_cell[i, i] for i in range(nd))
    eye = jnp.eye(nd).reshape((nd, nd) + (1,) * (gradU_cell.ndim - 2))
    return gT - (2.0 / 3.0) * eye * tr
