"""Thermophysical models — a re-design of the reference thermo layer.

The reference builds QGD-aware thermo classes on top of OpenFOAM's template
zoo (reference QGD/thermoModels/: psiQGDThermo/hePsiQGDThermo — perfect-gas
psi-based compressible thermo, docs/html/hePsiQGDThermo_8C_source.html:38-124
with gamma = Cp/Cv and c = sqrt(gamma/psi) at :123-124; rhoQGDThermo/
heRhoQGDThermo — density-based incl. rhoConst incompressible,
heRhoQGDThermo_8C_source.html:135-136; transport models const/Sutherland/
powerLaw, powerLawTransportI_8H_source.html:127).

Here a thermo model is a frozen dataclass of scalars with pure jnp methods:
every quantity is an elementwise closed form (or a short fixed-iteration
Newton solve for tabulated cp), so XLA fuses the whole thermo update into the
surrounding step.  No OpenFOAM-style virtual dispatch: the solver is jitted
against one concrete thermo, matching how a case selects exactly one
`makeThermo` combination in the reference.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax.numpy as jnp

from ..core.registry import register


# ---------------------------------------------------------------------------
# transport models: mu(T)  (reference const/sutherland/powerLaw transport)
# ---------------------------------------------------------------------------


class Transport:
    """Base marker for dynamic-viscosity models mu(p, T)."""


@register("transport", "const")
@dataclasses.dataclass(frozen=True)
class ConstTransport(Transport):
    """constTransport: mu = const (reference psiQGDThermos_8C const combos)."""

    mu0: float

    def mu(self, p, T):
        return jnp.full_like(T, self.mu0)


@register("transport", "sutherland")
@dataclasses.dataclass(frozen=True)
class SutherlandTransport(Transport):
    """sutherlandTransport: mu = As*sqrt(T)/(1 + Ts/T) (OpenFOAM form)."""

    As: float
    Ts: float

    def mu(self, p, T):
        return self.As * jnp.sqrt(T) / (1.0 + self.Ts / T)


@register("transport", "powerLaw")
@dataclasses.dataclass(frozen=True)
class PowerLawTransport(Transport):
    """powerLawTransport: mu = mu0*(T/T0)^k — reference
    powerLawTransportI_8H_source.html:127 (kappa = Cp*mu/Pr at :138-149)."""

    mu0: float
    T0: float
    k: float

    def mu(self, p, T):
        return self.mu0 * (T / self.T0) ** self.k


# ---------------------------------------------------------------------------
# psi-based compressible perfect-gas thermo (psiQGDThermo family)
# ---------------------------------------------------------------------------


@register("thermo", "psiPerfectGas")
@dataclasses.dataclass(frozen=True)
class PerfectGasThermo:
    """Calorically perfect gas, psi-based (compressible).

    Mirrors hePsiQGDThermo<pureMixture<...perfectGas>>> with
    sensibleInternalEnergy: e = Cv*T, psi = 1/(R*T), p = rho/psi = rho*R*T,
    gamma = Cp/Cv, c = sqrt(gamma/psi) (reference
    hePsiQGDThermo_8C_source.html:123-124).

    R is the specific gas constant [J/(kg K)].
    """

    R: float
    Cp: float
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0

    @property
    def Cv(self) -> float:
        return self.Cp - self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    def gamma_of(self, T):
        """Uniform interface with the variable-cp thermos (a trace-time
        constant here — solvers specialize on it)."""
        return self.gamma

    # -- state relations ----------------------------------------------------
    def T_from_e(self, e):
        return e / self.Cv

    def e_from_T(self, T):
        return self.Cv * T

    def psi(self, T):
        return 1.0 / (self.R * T)

    def p_from_rho_T(self, rho, T):
        return rho * self.R * T

    def rho_from_p_T(self, p, T):
        return p * self.psi(T)

    def c(self, T):
        """Speed of sound sqrt(gamma/psi) = sqrt(gamma R T)."""
        return jnp.sqrt(self.gamma * self.R * T)

    def c_from_pT(self, p, T):
        """Uniform thermo interface used by the QGD solver family."""
        return self.c(T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        """Thermal diffusivity alpha = kappa/Cp = mu/Pr [kg/(m s)]
        (reference powerLawTransportI_8H_source.html:138-149)."""
        return self.transport.mu(p, T) / self.Pr


@register("thermo", "rhoConst")
@dataclasses.dataclass(frozen=True)
class RhoConstThermo:
    """Incompressible liquid thermo for the QHD family.

    Mirrors heRhoQGDThermo<pureMixture<constTransport<hConst<rhoConst>>>>
    (reference rhoQGDThermos_8C_source.html:137-138): rho = const, mu = const,
    alpha = mu/Pr, Boussinesq expansion coefficient beta read from the
    transport dict (reference QHDFoam_2createFields_8H:110-115).
    """

    rho0: float
    Cp: float
    mu0: float
    Pr: float = 1.0
    beta: float = 0.0  # thermal expansion [1/K] for Boussinesq buoyancy

    def rho(self, p, T):
        return jnp.broadcast_to(jnp.asarray(self.rho0, dtype=T.dtype), T.shape)

    def mu(self, p, T):
        return jnp.full_like(T, self.mu0)

    def alphah(self, p, T):
        """alpha = kappa/Cp = mu/Pr [kg/(m s)]."""
        return jnp.full_like(T, self.mu0 / self.Pr)

    def nu(self):
        return self.mu0 / self.rho0


# ---------------------------------------------------------------------------
# arbitrary-EoS rho-based thermo (rhoQGDThermo / README's rhoQGDFoam lineage)
# ---------------------------------------------------------------------------


class EquationOfState:
    """rho(p, T) closures for the rho-based thermo family."""


@register("eos", "perfectGas")
@dataclasses.dataclass(frozen=True)
class PerfectGasEoS(EquationOfState):
    R: float

    def rho(self, p, T):
        return p / (self.R * T)

    def psi(self, p, T):
        return 1.0 / (self.R * T)

    def dpdrho_T(self, p, T):
        return self.R * T


@register("eos", "stiffenedGas")
@dataclasses.dataclass(frozen=True)
class StiffenedGasEoS(EquationOfState):
    """Stiffened gas p = rho*R*T - p_inf — a simple non-ideal EoS exercising
    the arbitrary-EoS path (the reference's rhoQGDThermo admits any OpenFOAM
    EoS via makeThermo tables, rhoQGDThermos_8C_source.html:60-146)."""

    R: float
    p_inf: float

    def rho(self, p, T):
        return (p + self.p_inf) / (self.R * T)

    def psi(self, p, T):
        return 1.0 / (self.R * T)

    def dpdrho_T(self, p, T):
        return self.R * T


@register("thermo", "rhoThermo")
@dataclasses.dataclass(frozen=True)
class RhoThermo:
    """Density-based thermo with pluggable EoS — QGD variant for arbitrary
    equations of state (reference heRhoQGDThermo_8C_source.html:39-136; the
    README's rhoQGDFoam solver consumes this layer).

    e = Cv*T calorically perfect caloric closure; c^2 = gamma * dp/drho|_T.
    """

    eos: EquationOfState
    Cp: float
    R: float
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0

    @property
    def Cv(self) -> float:
        return self.Cp - self.R

    @property
    def gamma(self) -> float:
        return self.Cp / self.Cv

    def gamma_of(self, T):
        return self.gamma

    def T_from_e(self, e):
        return e / self.Cv

    def e_from_T(self, T):
        return self.Cv * T

    def rho(self, p, T):
        return self.eos.rho(p, T)

    def psi(self, p, T):
        return self.eos.psi(p, T)

    def p_from_rho_T(self, rho, T):
        """Invert the EoS for p; both bundled EoS are affine in p."""
        p0 = jnp.zeros_like(T)
        rho0 = self.eos.rho(p0, T)
        drho_dp = self.eos.psi(p0, T)
        return (rho - rho0) / drho_dp

    def rho_from_p_T(self, p, T):
        return self.eos.rho(p, T)

    def c(self, p, T):
        """c = sqrt(gamma/psi) (reference heRhoQGDThermo_8C:135-136)."""
        return jnp.sqrt(self.gamma / self.eos.psi(p, T))

    def c_from_pT(self, p, T):
        return self.c(p, T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        return self.transport.mu(p, T) / self.Pr


# ---------------------------------------------------------------------------
# JANAF polynomial caloric closure (psiQGDReactionThermo building block)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class JanafThermo:
    """7-coefficient NASA/JANAF cp polynomial for one specie.

    cp/R = a0 + a1 T + a2 T^2 + a3 T^3 + a4 T^4;
    h/(R T) = a0 + a1/2 T + ... + a5/T.  Used by the reacting thermo
    (reference psiQGDReactionThermos_8C janaf combos).  T from e by a short
    fixed-iteration Newton (OpenFOAM's THE equivalent, tolerance-free under
    jit).
    """

    R: float  # specific gas constant of the specie
    low: tp.Tuple[float, ...]  # 7 coeffs, T < Tcommon
    high: tp.Tuple[float, ...]  # 7 coeffs, T >= Tcommon
    Tcommon: float = 1000.0

    def _coeffs(self, T):
        lo = jnp.asarray(self.low)
        hi = jnp.asarray(self.high)
        return jnp.where(T[..., None] < self.Tcommon, lo, hi)

    def cp(self, T):
        a = self._coeffs(T)
        poly = a[..., 0] + T * (a[..., 1] + T * (a[..., 2] + T * (a[..., 3] + T * a[..., 4])))
        return self.R * poly

    def h_abs(self, T):
        a = self._coeffs(T)
        poly = (
            a[..., 0]
            + T * (a[..., 1] / 2 + T * (a[..., 2] / 3 + T * (a[..., 3] / 4 + T * a[..., 4] / 5)))
        )
        return self.R * (T * poly + a[..., 5])

    def e_abs(self, T):
        return self.h_abs(T) - self.R * T

    def s_abs(self, T):
        """Standard-state entropy s0(T) (NASA polynomial 7th coefficient):
        s/R = a0 ln T + a1 T + a2 T^2/2 + a3 T^3/3 + a4 T^4/4 + a6.
        Needed for equilibrium constants of reversible reactions
        (Gibbs energies from the same JANAF data the reference's
        makeChemistryModel hierarchy uses)."""
        a = self._coeffs(T)
        poly = (a[..., 0] * jnp.log(T)
                + T * (a[..., 1] + T * (a[..., 2] / 2
                                        + T * (a[..., 3] / 3
                                               + T * a[..., 4] / 4)))
                + a[..., 6])
        return self.R * poly

    def cv(self, T):
        return self.cp(T) - self.R

    def T_from_e(self, e, T0, iters: int = 8):
        """Newton solve e_abs(T) = e starting from T0 (fixed iterations)."""
        T = T0
        for _ in range(iters):
            T = T - (self.e_abs(T) - e) / jnp.maximum(self.cv(T), 1e-30)
            T = jnp.clip(T, 10.0, 20000.0)
        return T


@register("thermo", "janafPerfectGas")
@dataclasses.dataclass(frozen=True)
class JanafPerfectGasThermo:
    """Single-gas psi-thermo with a JANAF caloric closure — the reference's
    pureMixture janaf x sutherland psiQGDThermo instantiations
    (psiQGDThermos_8C_source.html:65-110: sutherland<janaf<perfectGas>> and
    janaf x const combos), previously reachable here only through the
    multicomponent MixtureThermo.

    sensibleInternalEnergy convention (OpenFOAM): e_s(T) = h_a(T) - h_a(Tstd)
    - R*T, cv(T) = cp(T) - R, gamma(T) = cp/cv, psi = 1/(R*T),
    c = sqrt(gamma/psi)/rho^0 = sqrt(gamma R T).
    """

    janaf: JanafThermo
    transport: Transport = ConstTransport(0.0)
    Pr: float = 1.0
    Tstd: float = 298.15

    @property
    def R(self) -> float:
        return self.janaf.R

    def _h_std(self, like):
        return self.janaf.h_abs(jnp.asarray(self.Tstd, dtype=like.dtype))

    # -- caloric ------------------------------------------------------------
    def e_from_T(self, T):
        """e_s(T) = h_a(T) - h_a(Tstd) - R*T (OpenFOAM sensibleInternalEnergy:
        hs = ha - hc with hc = ha(Tstd) for a pure janaf gas)."""
        T = jnp.asarray(T, dtype=jnp.result_type(float, T))
        return self.janaf.e_abs(T) - self._h_std(T)

    def T_from_e(self, e, iters: int = 12):
        e = jnp.asarray(e)
        e_abs = e + self._h_std(e)
        T0 = jnp.full_like(e, 1000.0)
        return self.janaf.T_from_e(e_abs, T0, iters=iters)

    def gamma_of(self, T):
        return self.janaf.cp(T) / self.janaf.cv(T)

    # -- state relations ------------------------------------------------------
    def psi(self, T):
        return 1.0 / (self.R * T)

    def p_from_rho_T(self, rho, T):
        return rho * self.R * T

    def rho_from_p_T(self, p, T):
        return p * self.psi(T)

    def c_from_pT(self, p, T):
        """c = sqrt(gamma/psi) (hePsiQGDThermo_8C_source.html:123-124)."""
        return jnp.sqrt(self.gamma_of(T) * self.R * T)

    def mu(self, p, T):
        return self.transport.mu(p, T)

    def alphah(self, p, T):
        """alpha = kappa/cp.  Sutherland transport uses OpenFOAM's modified
        Eucken correction kappa = mu*cv*(1.32 + 1.77*R/cv) (sutherland
        Transport::kappa); const/powerLaw use kappa = cp*mu/Pr."""
        mu = self.transport.mu(p, T)
        cp = self.janaf.cp(T)
        if isinstance(self.transport, SutherlandTransport):
            cv = self.janaf.cv(T)
            kappa = mu * cv * (1.32 + 1.77 * self.R / cv)
            return kappa / cp
        return mu / self.Pr
