"""Lagrangian parcel clouds + the particlesQGDFoam/particlesQHDFoam solvers.

Re-design of the reference's Lagrangian coupling (particlesQGDFoam_8C_source.
html:50,112,125-130: basicThermoCloud with parcels.evolve(), momentum source
rhoUSu = parcels.SU(U), energy source rhoESu = parcels.Sh(e);
particlesQHDFoam_8C:119 evolves one-way).  OpenFOAM tracks parcels through an
unstructured mesh with per-parcel face walks; the cloud here is a
fixed-size structure-of-arrays with:
  * cell location by per-axis `searchsorted` on the rectilinear face
    coordinates (O(log n), fully vectorised — no face walking);
  * gas properties sampled at the owner cell (OpenFOAM's default cell-value
    interpolation);
  * Schiller-Naumann drag and Ranz-Marshall heat transfer (the
    basicThermoCloud defaults: sphereDrag + RanzMarshall);
  * two-way source fields by scatter-add of per-parcel momentum/energy
    exchange into owner cells;
  * boundary handling: periodic wrap or deactivate-on-escape, per axis.

All of evolve() is jittable; parcel count is static (inactive slots masked),
which replaces OpenFOAM's dynamic parcel lists with a static layout.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np

from ..core.mesh import Mesh
from ..parallel import spmd
from . import common


class CloudState(tp.NamedTuple):
    x: jax.Array  # (d, N) positions
    u: jax.Array  # (d, N) velocities
    Tp: jax.Array  # (N,) temperatures
    dp: jax.Array  # (N,) diameters
    active: jax.Array  # (N,) 0/1 mask


@dataclasses.dataclass(frozen=True)
class ThermoCloud:
    """basicThermoCloud equivalent: inert spherical parcels with drag + heat
    exchange."""

    rho_p: float = 1000.0  # parcel material density
    Cp_p: float = 4187.0  # parcel specific heat
    mu_g: float = 1.8e-5  # gas viscosity for drag/heat correlations
    kappa_g: float = 0.026  # gas conductivity (Ranz-Marshall)
    Pr_g: float = 0.7
    two_way: bool = True  # particlesQGDFoam two-way vs QHD one-way
    wall: str = "escape"  # "escape" | "periodic" | "rebound"

    def make(self, x, u, Tp, dp) -> CloudState:
        x = jnp.asarray(x)
        n = x.shape[1]
        return CloudState(
            x=x, u=jnp.asarray(u), Tp=jnp.asarray(Tp), dp=jnp.asarray(dp),
            active=jnp.ones((n,), dtype=x.dtype),
        )

    def mass(self, c: CloudState):
        return self.rho_p * jnp.pi / 6.0 * c.dp ** 3

    def locate(self, c: CloudState, mesh: Mesh):
        """Owner-cell indices per parcel (per-axis searchsorted)."""
        idx = []
        for a in range(mesh.ndim):
            faces = jnp.asarray(mesh.x_faces[a])
            i = jnp.searchsorted(faces, c.x[a], side="right") - 1
            idx.append(jnp.clip(i, 0, mesh.shape[a] - 1))
        return tuple(idx)

    def evolve(self, c: CloudState, mesh: Mesh, dt, *, rho_g, U_g, T_g):
        """One parcel step (parcels.evolve equivalent).

        Returns (cloud', rhoUSu, rhoESu): the two-way exchange source fields
        [kg/(m^2 s^2)] and [W/m^3] with opposite sign to the parcel gain —
        momentum/energy leaving the gas enters the parcels.
        """
        nd = mesh.ndim
        idx = self.locate(c, mesh)
        flat = idx[0]
        for a in range(1, nd):
            flat = flat * mesh.shape[a] + idx[a]

        # gas state at parcel (owner-cell value)
        rho_at = rho_g.reshape(-1)[flat]
        T_at = T_g.reshape(-1)[flat]
        U_at = jnp.stack([U_g[a].reshape(-1)[flat] for a in range(nd)])

        m = self.mass(c)
        act = c.active

        # Schiller-Naumann drag: tau_p = rho_p dp^2/(18 mu) / (1+0.15 Re^0.687)
        du = U_at - c.u
        rel = jnp.sqrt(jnp.sum(du * du, axis=0))
        Re = jnp.maximum(rho_at * rel * c.dp / self.mu_g, 1e-12)
        f = 1.0 + 0.15 * Re ** 0.687
        tau_p = self.rho_p * c.dp ** 2 / (18.0 * self.mu_g) / f
        # exact exponential integrator for the linear drag relaxation
        fac = 1.0 - jnp.exp(-dt / jnp.maximum(tau_p, 1e-12))
        dup = du * fac * act
        u_new = c.u + dup
        x_new = c.x + dt * u_new

        # Ranz-Marshall heat transfer: Nu = 2 + 0.6 Re^1/2 Pr^1/3
        Nu = 2.0 + 0.6 * jnp.sqrt(Re) * self.Pr_g ** (1.0 / 3.0)
        h = Nu * self.kappa_g / jnp.maximum(c.dp, 1e-12)
        A_p = jnp.pi * c.dp ** 2
        tau_T = m * self.Cp_p / jnp.maximum(h * A_p, 1e-30)
        facT = 1.0 - jnp.exp(-dt / tau_T)
        dTp = (T_at - c.Tp) * facT * act
        Tp_new = c.Tp + dTp

        # boundary handling per axis — against the GLOBAL domain bounds:
        # under spmd decomposition the block edges are partition faces
        # (parcels crossing them migrate, see _migrate), only the global
        # boundary is a wall
        ctx = spmd.current()
        gmesh = (ctx.global_mesh if ctx is not None
                 and ctx.global_mesh is not None else mesh)
        active = act
        xs = []
        for a in range(nd):
            lo = float(gmesh.x_faces[a][0])
            hi = float(gmesh.x_faces[a][-1])
            xa = x_new[a]
            if self.wall == "periodic":
                xa = lo + jnp.mod(xa - lo, hi - lo)
            elif self.wall == "rebound":
                xa = jnp.where(xa < lo, 2 * lo - xa, xa)
                xa = jnp.where(xa > hi, 2 * hi - xa, xa)
            else:  # escape: deactivate
                out = jnp.logical_or(xa < lo, xa > hi)
                active = active * (1.0 - out.astype(active.dtype))
                xa = jnp.clip(xa, lo, hi)
            xs.append(xa)
        x_new = jnp.stack(xs, axis=0)

        cloud = CloudState(x=x_new, u=u_new, Tp=Tp_new, dp=c.dp, active=active)
        # parcels that crossed a partition face move to the neighbour
        # shard (reference: particle migration across processor
        # boundaries, SURVEY.md §3.5); source deposition above used the
        # PRE-move owner cells, which are always local
        cloud = _migrate(cloud, mesh)

        if not self.two_way:
            z = jnp.zeros(mesh.shape, dtype=rho_g.dtype)
            return cloud, jnp.zeros((nd,) + mesh.shape, dtype=rho_g.dtype), z

        # two-way sources: gas loses what parcels gain (per cell, per volume)
        vol = jnp.broadcast_to(mesh.cell_volume, mesh.shape).reshape(-1)[flat]
        w = act / (vol * jnp.maximum(dt, 1e-30))
        ncell = int(np.prod(mesh.shape))
        rhoUSu = jnp.stack([
            jnp.zeros((ncell,), dtype=rho_g.dtype).at[flat].add(
                -m * dup[a] * w
            ).reshape(mesh.shape)
            for a in range(nd)
        ])
        # energy: convective heat to parcels + work of drag force
        q_p = m * self.Cp_p * dTp
        work = m * jnp.sum(dup * U_at, axis=0)
        rhoESu = jnp.zeros((ncell,), dtype=rho_g.dtype).at[flat].add(
            -(q_p + work) * w
        ).reshape(mesh.shape)
        return cloud, rhoUSu, rhoESu


def _migrate(c: CloudState, mesh) -> CloudState:
    """Move parcels that left this shard's block to the neighbour shard.

    The replacement of OpenFOAM's processor-boundary particle
    transfer (SURVEY.md §3.5 "particle migration PROCESS BOUNDARY"):
    per decomposed axis, parcels beyond the local block's faces ride a
    `jax.lax.ppermute` to the next/previous shard — axis-sequential, so a
    diagonal mover reaches the corner shard in two hops, exactly like the
    ghost-corner exchange.  Fixed-size slots: each shard's capacity is its
    slot count; incoming parcels compact into inactive slots via a stable
    active-first argsort (no scatter collisions).  Parcels move at most
    one block per step (the advective CFL keeps them well under one CELL
    per step).  No-op outside an spmd context.
    """
    ctx = spmd.current()
    if ctx is None:
        return c
    nd = mesh.ndim
    act = c.active
    cap = act.shape[0]
    arrays = [c.x, c.u, c.Tp, c.dp]
    for a in range(nd):
        sh = ctx.axes[a]
        if sh is None or sh.size == 1:
            continue
        xf = mesh.x_faces[a]
        lo, hi = xf[0], xf[-1]
        up = act * (arrays[0][a] >= hi)
        dn = act * (arrays[0][a] < lo)
        stay = act * (1.0 - up) * (1.0 - dn)
        # cyclic one-hop exchange; at the global domain edge the wall
        # handling already wrapped (periodic: the cyclic hop IS the
        # wraparound) or clamped/deactivated (escape/rebound: up/dn empty)
        perm_up = [(i, (i + 1) % sh.size) for i in range(sh.size)]
        perm_dn = [(i, (i - 1) % sh.size) for i in range(sh.size)]
        act_up = jax.lax.ppermute(up, sh.name, perm_up)
        act_dn = jax.lax.ppermute(dn, sh.name, perm_dn)
        vals_up = [jax.lax.ppermute(arr, sh.name, perm_up) for arr in arrays]
        vals_dn = [jax.lax.ppermute(arr, sh.name, perm_dn) for arr in arrays]
        pool_act = jnp.concatenate([stay, act_up, act_dn])
        pool = [jnp.concatenate([arr, u_, d_], axis=-1)
                for arr, u_, d_ in zip(arrays, vals_up, vals_dn)]
        # active slots first (stable), truncate to capacity; actives
        # beyond capacity are dropped — size the cloud's slots per shard
        # at the maximum expected residency (distribute_cloud does)
        order = jnp.argsort(pool_act < 0.5, stable=True)[:cap]
        act = pool_act[order]
        arrays = [arr[..., order] for arr in pool]
    return CloudState(x=arrays[0], u=arrays[1], Tp=arrays[2], dp=arrays[3],
                      active=act)


def distribute_cloud(cloud: CloudState, mesh, dmesh,
                     capacity: int = None) -> CloudState:
    """Host-side decomposePar of a cloud: reorder parcels into per-shard
    slot blocks so that, sharded over `dmesh` (slots split across all
    device-mesh axes in device order), every shard's slice holds exactly
    the parcels resident in its spatial block.

    capacity: slots per shard (default: total slot count — no shard can
    ever overflow).  Returns a cloud with n_shards*capacity slots.
    """
    shape = dmesh.devices.shape
    nshards = int(np.prod(shape))
    cap = int(capacity if capacity is not None else cloud.active.shape[0])
    x = np.asarray(cloud.x)
    nd = x.shape[0]
    sidx = np.zeros(x.shape[1], dtype=int)
    for a in range(min(nd, len(shape))):
        npa = int(shape[a])
        nloc = mesh.shape[a] // npa
        ci = np.clip(np.searchsorted(np.asarray(mesh.x_faces[a]), x[a],
                                     side="right") - 1, 0, mesh.shape[a] - 1)
        sidx = sidx * npa + ci // nloc
    fields = {f: np.asarray(getattr(cloud, f)) for f in cloud._fields}
    out = {f: np.zeros(v.shape[:-1] + (nshards * cap,), dtype=v.dtype)
           for f, v in fields.items()}
    for s in range(nshards):
        sel = np.where((sidx == s) & (fields["active"] > 0.5))[0]
        if len(sel) > cap:
            raise ValueError(
                f"shard {s} holds {len(sel)} parcels > capacity {cap}")
        for f, v in fields.items():
            out[f][..., s * cap: s * cap + len(sel)] = v[..., sel]
    return CloudState(**{f: jnp.asarray(v) for f, v in out.items()})


class PState(tp.NamedTuple):
    fluid: tp.Any
    cloud: CloudState


@dataclasses.dataclass(frozen=True)
class ParticlesQGDFoam:
    """particlesQGDFoam: QGDFoam + two-way basicThermoCloud
    (particlesQGDFoam_8C_source.html:112,125-130)."""

    fluid: tp.Any  # QGDFoam
    cloud: ThermoCloud = ThermoCloud()

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, p0, T0, U0, x_p, u_p, T_p, d_p, **kw) -> PState:
        return PState(
            fluid=self.fluid.init(p0, T0, U0, **kw),
            cloud=self.cloud.make(x_p, u_p, T_p, d_p),
        )

    def make_step(self):
        fstep = self.fluid.make_step(external_sources=True)
        mesh = self.fluid.mesh

        def step(s: PState) -> PState:
            U, e, T, p = self.fluid.primitives(s.fluid)
            stash = {}

            def srcs(dt_new):
                cloud, rhoUSu, rhoESu = self.cloud.evolve(
                    s.cloud, mesh, dt_new, rho_g=s.fluid.rho, U_g=U, T_g=T
                )
                stash["cloud"] = cloud
                return (0.0, rhoUSu, rhoESu)

            fluid = fstep(s.fluid, srcs)
            return PState(fluid=fluid, cloud=stash["cloud"])

        return step


@dataclasses.dataclass(frozen=True)
class ParticlesQHDFoam:
    """particlesQHDFoam: QHDFoam + one-way cloud (evolve only; QHD equations
    keep zero sources — particlesQHDFoam_8C_source.html:119,126-131)."""

    fluid: tp.Any  # QHDFoam
    cloud: ThermoCloud = ThermoCloud(two_way=False)

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, U0, T0, x_p, u_p, T_p, d_p, **kw) -> PState:
        return PState(
            fluid=self.fluid.init(U0, T0, **kw),
            cloud=self.cloud.make(x_p, u_p, T_p, d_p),
        )

    def make_step(self):
        fstep = self.fluid.make_step()
        mesh = self.fluid.mesh
        thermo = self.fluid.thermo

        def step(s: PState) -> PState:
            T = s.fluid.T
            rho = thermo.rho(s.fluid.p, T)
            cloud, _, _ = self.cloud.evolve(
                s.cloud, mesh, s.fluid.dt, rho_g=rho, U_g=s.fluid.U, T_g=T
            )
            return PState(fluid=fstep(s.fluid), cloud=cloud)

        return step


@dataclasses.dataclass(frozen=True)
class ReactingCloud(ThermoCloud):
    """basicReactingCloud equivalent: ThermoCloud + d^2-law evaporation.

    Evaporated mass enters the gas as specie `evap_specie` (the reference's
    reactingLagrangianQGDFoam couples parcels.SYi into QGDYEqn,
    QGDYEqn_8H:59), with latent-heat sink L per kg.
    """

    evap_specie: int = 0
    K_evap: float = 0.0  # d^2-law constant [m^2/s]: d(dp^2)/dt = -K
    latent_heat: float = 0.0  # J/kg

    def evolve_reacting(self, c: CloudState, mesh: Mesh, dt, *, rho_g, U_g,
                        T_g, n_species: int):
        """Returns (cloud', rhoSu, rhoUSu, rhoESu, YSu-list)."""
        nd = mesh.ndim
        cloud, rhoUSu, rhoESu = self.evolve(
            c, mesh, dt, rho_g=rho_g, U_g=U_g, T_g=T_g
        )
        # d^2-law evaporation on the post-drag cloud
        dp2 = jnp.maximum(cloud.dp ** 2 - self.K_evap * dt * cloud.active, 0.0)
        dp_new = jnp.sqrt(dp2)
        dm = self.rho_p * jnp.pi / 6.0 * (cloud.dp ** 3 - dp_new ** 3)
        cloud = cloud._replace(dp=dp_new)

        idx = self.locate(cloud, mesh)
        flat = idx[0]
        for a in range(1, nd):
            flat = flat * mesh.shape[a] + idx[a]
        vol = jnp.broadcast_to(mesh.cell_volume, mesh.shape).reshape(-1)[flat]
        w = cloud.active / (vol * jnp.maximum(dt, 1e-30))
        ncell = int(np.prod(mesh.shape))
        src = jnp.zeros((ncell,), dtype=rho_g.dtype).at[flat].add(
            dm * w).reshape(mesh.shape)
        rhoSu = src  # gas gains evaporated mass
        YSu = [jnp.zeros_like(src) for _ in range(n_species)]
        YSu[self.evap_specie] = src
        rhoESu = rhoESu - self.latent_heat * src
        return cloud, rhoSu, rhoUSu, rhoESu, YSu


@dataclasses.dataclass(frozen=True)
class ReactingLagrangianQGDFoam:
    """reactingLagrangianQGDFoam: multicomponent reacting QGD + reacting
    cloud two-way coupling (reactingLagrangianQGDFoam_8C_source.html:57-150:
    parcels.evolve, rhoUSu = parcels.SU, rhoESu = parcels.Sh + Qdot, specie
    sources parcels.SYi)."""

    fluid: tp.Any  # ReactingQGDFoam
    cloud: ReactingCloud = ReactingCloud()

    @property
    def mesh(self):
        return self.fluid.mesh

    def init(self, p0, T0, U0, Y0, x_p, u_p, T_p, d_p, **kw) -> PState:
        return PState(
            fluid=self.fluid.init(p0, T0, U0, Y0, **kw),
            cloud=self.cloud.make(x_p, u_p, T_p, d_p),
        )

    def make_step(self):
        mesh = self.fluid.mesh
        ns = self.fluid.mixture.n_species

        # the cloud's sources are computed before the fluid step from the
        # pre-step state, then injected through the `sources` hook
        def step(s: PState) -> PState:
            stash = {}

            def hook(st, prims, dt_new):
                U, e, T, p = prims
                cloud, rhoSu, rhoUSu, rhoESu, YSu = self.cloud.evolve_reacting(
                    s.cloud, mesh, dt_new, rho_g=st.rho, U_g=U, T_g=T,
                    n_species=ns,
                )
                stash["cloud"] = cloud
                return (rhoSu, rhoUSu, rhoESu, YSu)

            fstep = self.fluid.make_step(sources=hook)
            return PState(fluid=fstep(s.fluid), cloud=stash["cloud"])

        return step
