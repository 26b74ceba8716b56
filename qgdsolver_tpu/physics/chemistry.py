"""Chemistry & combustion models (ChemistryQGD/CombustionQGD equivalents).

The reference registers OpenFOAM's chemistry/combustion hierarchies against
psiQGDReactionThermo via pure template-instantiation shims (SURVEY.md §2.3:
BasicChemistryModelsQGD_8C:48-60, CombustionQGDModels_8C:48, one file per
combustion family laminar/EDC/PaSR/noCombustion/...).  The capability being
registered is: given (Y, rho, T, p), produce per-specie reaction sources
R(Yi) [kg/m^3/s] and a heat release Qdot [W/m^3] (QGDYEqn_8H:36-37,57).

Here the same capability is a `CombustionModel` registry of pure functions.
`Laminar` is finite-rate Arrhenius kinetics (the laminar combustion model +
StandardChemistryModel path); `EddyDissipation` is the classic mixing-limited
model (EDC family's algebraic core); `NoCombustion` returns zeros.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np

from ..core.registry import register
from .species import MixtureThermo, R_UNIVERSAL


P_STD = 101325.0  # standard-state pressure for Kp [Pa]


@dataclasses.dataclass(frozen=True)
class Reaction:
    """Arrhenius reaction: kf = A T^beta exp(-Ta/T).

    lhs/rhs: ((specie_index, stoichiometric coefficient), ...).

    reversible: backward rate kr = kf/Kc with the equilibrium constant from
    the species' JANAF Gibbs energies (OpenFOAM reversibleArrheniusReaction;
    the reference registers the full reaction hierarchy via
    makeChemistryModel, BasicChemistryModelsQGD_8C_source.html:48-60).

    third_body: the rate is multiplied by [M] = sum_i eff_i*conc_i with
    per-specie efficiencies (default 1.0; OpenFOAM thirdBodyArrhenius
    `coeffs` list)."""

    lhs: tp.Tuple[tp.Tuple[int, float], ...]
    rhs: tp.Tuple[tp.Tuple[int, float], ...]
    A: float
    beta: float = 0.0
    Ta: float = 0.0  # activation temperature Ea/Ru
    reversible: bool = False
    third_body: bool = False
    efficiencies: tp.Tuple[tp.Tuple[int, float], ...] = ()

    def kf(self, T):
        return self.A * jnp.power(T, self.beta) * jnp.exp(
            -self.Ta / jnp.maximum(T, 1.0))

    def equilibrium_kc(self, mix, T):
        """Kc(T) = Kp*(p0/(Ru T))^dnu, Kp = exp(-dG0/(Ru T)); molar Gibbs
        from the JANAF polynomials (g/(Ru T) = h/(R_i T) - s/R_i, the
        specific-over-R ratios equal the molar-over-Ru ones)."""
        dg = 0.0
        dnu = 0.0
        for sgn, side in ((-1.0, self.lhs), (1.0, self.rhs)):
            for i, nu in side:
                sp = mix.species[i]
                if sp.janaf is None:
                    raise NotImplementedError(
                        f"reversible reaction requires JANAF data for "
                        f"{sp.name} (no entropy in const-cp species)")
                g_over_rut = (sp.janaf.h_abs(T) / (sp.janaf.R * T)
                              - sp.janaf.s_abs(T) / sp.janaf.R)
                dg = dg + sgn * nu * g_over_rut
                dnu = dnu + sgn * nu
        kp = jnp.exp(-dg)
        return kp * jnp.power(P_STD / (R_UNIVERSAL * T), dnu)

    def rate(self, conc, T):
        """Forward omega [kmol/m^3/s] (legacy irreversible path)."""
        w = self.kf(T)
        for i, nu in self.lhs:
            w = w * jnp.power(jnp.maximum(conc[i], 0.0), nu)
        return w

    def net_rate(self, conc, T, mix=None):
        """Net omega incl. the reverse rate and third-body factor."""
        k = self.kf(T)
        wf = k
        for i, nu in self.lhs:
            wf = wf * jnp.power(jnp.maximum(conc[i], 0.0), nu)
        w = wf
        if self.reversible:
            kc = self.equilibrium_kc(mix, T)
            wr = k / jnp.maximum(kc, 1e-300)
            for i, nu in self.rhs:
                wr = wr * jnp.power(jnp.maximum(conc[i], 0.0), nu)
            w = w - wr
        if self.third_body:
            eff = dict(self.efficiencies)
            m = sum(eff.get(i, 1.0) * jnp.maximum(conc[i], 0.0)
                    for i in range(len(conc)))
            w = w * m
        return w


class CombustionModel:
    """Base: correct(mix, Y, rho, T, p) -> (RR[i] tuple, Qdot)."""


@register("combustion", "none")
@register("combustion", "noCombustion")
@dataclasses.dataclass(frozen=True)
class NoCombustion(CombustionModel):
    """noCombustion family (noCombustionsQGD_8C shim)."""

    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        zero = jnp.zeros_like(T)
        return tuple(zero for _ in mix.species), zero


@register("combustion", "laminar")
@dataclasses.dataclass(frozen=True)
class Laminar(CombustionModel):
    """Finite-rate Arrhenius kinetics (laminar combustion +
    StandardChemistryModel path, laminarsQGD_8C shim)."""

    reactions: tp.Tuple[Reaction, ...]

    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        ns = mix.n_species
        conc = [rho * Y[i] / mix.species[i].W for i in range(ns)]  # kmol/m^3
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        for rxn in self.reactions:
            w = rxn.net_rate(conc, T, mix)
            for i, nu in rxn.lhs:
                rr[i] = rr[i] - nu * w * mix.species[i].W
            for i, nu in rxn.rhs:
                rr[i] = rr[i] + nu * w * mix.species[i].W
        # Qdot = -sum_i hf_i * RR_i (heat release from formation enthalpies)
        qdot = -sum(mix.species[i].hf * rr[i] for i in range(ns))
        return tuple(rr), qdot


@register("combustion", "eddyDissipation")
@dataclasses.dataclass(frozen=True)
class EddyDissipation(CombustionModel):
    """Mixing-limited single-step model (EDC/eddyDissipationDiffusion
    family's algebraic core): fuel burns at rate C_EDC*rho*min(Y_F,
    Y_O/s)/t_mix with a fixed mixing time."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]  # (index, mass yield)
    s: float  # stoichiometric oxidizer/fuel mass ratio
    C: float = 4.0
    t_mix: float = 1e-3
    q_fuel: float = 0.0  # heat release per kg fuel

    def correct(self, mix: MixtureThermo, Y, rho, T, p):
        ns = mix.n_species
        rate = self.C / self.t_mix * rho * jnp.minimum(
            jnp.maximum(Y[self.fuel], 0.0),
            jnp.maximum(Y[self.oxidizer], 0.0) / self.s,
        )
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        rr[self.fuel] = -rate
        rr[self.oxidizer] = -self.s * rate
        for i, yield_i in self.products:
            rr[i] = rr[i] + yield_i * rate
        qdot = self.q_fuel * rate
        return tuple(rr), qdot

@register("combustion", "infinitelyFastChemistry")
@dataclasses.dataclass(frozen=True)
class InfinitelyFastChemistry(CombustionModel):
    """Mixed-is-burnt single-step model (infinitelyFastChemistrysQGD_8C
    shim): fuel consumed at rho*min(Y_F, Y_O/s)/(C*dt) — complete combustion
    of the deficient reactant within C timesteps."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 5.0
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        ns = mix.n_species
        dt = 1e-6 if dt is None else dt
        rate = rho * jnp.minimum(
            jnp.maximum(Y[self.fuel], 0.0),
            jnp.maximum(Y[self.oxidizer], 0.0) / self.s,
        ) / (self.C * dt)
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        rr[self.fuel] = -rate
        rr[self.oxidizer] = -self.s * rate
        for i, yield_i in self.products:
            rr[i] = rr[i] + yield_i * rate
        return tuple(rr), self.q_fuel * rate


@register("combustion", "PaSR")
@dataclasses.dataclass(frozen=True)
class PaSR(CombustionModel):
    """Partially-Stirred Reactor (PaSRsQGD_8C shim): finite-rate kinetics
    scaled by the reacting-fraction kappa = tau_c/(tau_c + tau_mix), with the
    chemical time estimated from the current consumption rates."""

    base: "Laminar"
    t_mix: float = 1e-4

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        rr, qdot = self.base.correct(mix, Y, rho, T, p)
        # tau_c ~ rho * sum(max(Y,0)) / sum(|RR|) (OpenFOAM PaSR::tc analogue)
        denom = sum(jnp.abs(r) for r in rr) + 1e-30
        tau_c = rho * sum(jnp.maximum(Y[i], 0.0)
                          for i in range(mix.n_species)) / denom
        kappa = tau_c / (tau_c + self.t_mix)
        return tuple(kappa * r for r in rr), kappa * qdot


@register("combustion", "eddyDissipationDiffusion")
@dataclasses.dataclass(frozen=True)
class EddyDissipationDiffusion(CombustionModel):
    """eddyDissipationDiffusion family: mixing-limited rate with an
    additional diffusion-limited bound via the product mass fraction
    (rate ~ min(Y_F, Y_O/s, C_d*Y_P/(1+s)))."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 4.0
    Cd: float = 0.5
    t_mix: float = 1e-3
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        ns = mix.n_species
        yp = sum(jnp.maximum(Y[i], 0.0) for i, _ in self.products)
        lim = jnp.minimum(
            jnp.minimum(jnp.maximum(Y[self.fuel], 0.0),
                        jnp.maximum(Y[self.oxidizer], 0.0) / self.s),
            self.Cd * yp / (1.0 + self.s),
        )
        rate = self.C / self.t_mix * rho * lim
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        rr[self.fuel] = -rate
        rr[self.oxidizer] = -self.s * rate
        for i, yield_i in self.products:
            rr[i] = rr[i] + yield_i * rate
        return tuple(rr), self.q_fuel * rate


@register("combustion", "zoneCombustion")
@dataclasses.dataclass(frozen=True)
class ZoneCombustion(CombustionModel):
    """zoneCombustion family (zoneCombustionsQGD_8C shim): delegates to a
    base model but zeroes the sources outside a static cell mask."""

    base: CombustionModel
    mask: tp.Any  # (cells) 0/1 array

    needs_aux: bool = dataclasses.field(default=True, init=False)

    @property
    def needs_grad(self):
        return getattr(self.base, "needs_grad", False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        rr, qdot = _call(self.base, mix, Y, rho, T, p, dt, aux=aux)
        m = jnp.asarray(self.mask)
        return tuple(m * r for r in rr), m * qdot


def _call(model, mix, Y, rho, T, p, dt, aux=None):
    """Invoke correct() passing dt/aux only to models that accept them.

    `aux` carries per-step auxiliary fields some families need: gradient-
    limited models read aux['gradY'] (tuple of (ndim, cells) arrays) and
    aux['mu_eff']; EDC reads aux['k'], aux['eps'], aux['nu'].  Models that
    need it declare `needs_grad = True` so the solver only computes
    gradients when required."""
    if aux is not None and getattr(model, "needs_aux", False):
        try:
            return model.correct(mix, Y, rho, T, p, dt=dt, aux=aux)
        except TypeError:
            pass
    try:
        return model.correct(mix, Y, rho, T, p, dt=dt)
    except TypeError:
        return model.correct(mix, Y, rho, T, p)


@register("combustion", "EDC")
@dataclasses.dataclass(frozen=True)
class EDC(CombustionModel):
    """Eddy Dissipation Concept (EDCsQGD_8C shim): Magnussen fine-structure
    scaling of finite-rate kinetics.  gamma_L = Cgamma*(nu*eps/k^2)^(1/4)
    (fine-structure length fraction), tau* = Ctau*sqrt(nu/eps) (fine-
    structure residence time); the reacting-fraction multiplier is
    kappa = gamma_L^expo / (1 - gamma_L^3).

    Turbulence quantities (k, eps, nu) come from aux (per-cell arrays) or
    the model's scalar defaults — the QGD solvers resolve the flow
    laminarly, so constants parametrize the sub-cell mixing exactly like
    the fixed t_mix of EddyDissipation."""

    base: "Laminar"
    Cgamma: float = 2.1377
    Ctau: float = 0.4083
    expo: int = 2          # EDC version exponent (2 = 2005 formulation)
    k: float = 1.0         # default turbulent kinetic energy [m^2/s^2]
    eps: float = 1e3       # default dissipation rate [m^2/s^3]
    nu: float = 1.5e-5     # default kinematic viscosity [m^2/s]
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        aux = aux or {}
        k = aux.get("k", self.k)
        eps = aux.get("eps", self.eps)
        nu = aux.get("nu", self.nu)
        gammaL = jnp.clip(
            self.Cgamma * jnp.power(nu * eps / jnp.maximum(k * k, 1e-30),
                                    0.25), 0.0, 0.999)
        kappa = jnp.power(gammaL, self.expo) / (1.0 - gammaL ** 3)
        rr, qdot = self.base.correct(mix, Y, rho, T, p)
        return tuple(kappa * r for r in rr), kappa * qdot


@register("combustion", "FSD")
@dataclasses.dataclass(frozen=True)
class FSD(CombustionModel):
    """Flame Surface Density model (FSDsQGD_8C shim): premixed burn rate
    omega = rho_u * S_L * Xi * Sigma * Y_F0 from an algebraic FSD closure
    Sigma = 4 c (1 - c) / delta_L over the progress variable
    c = 1 - Y_F/Y_F0 (peak 1/delta_L at c = 1/2)."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float               # stoichiometric oxidizer/fuel mass ratio
    YF0: float             # unburnt fuel mass fraction
    S_L: float             # laminar flame speed [m/s]
    delta_L: float         # laminar flame thickness [m]
    rho_u: float           # unburnt density [kg/m^3]
    Xi: float = 1.0        # wrinkling factor
    q_fuel: float = 0.0

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None):
        ns = mix.n_species
        c = jnp.clip(1.0 - jnp.maximum(Y[self.fuel], 0.0) / self.YF0,
                     0.0, 1.0)
        sigma_fsd = 4.0 * c * (1.0 - c) / self.delta_L
        rate = self.rho_u * self.S_L * self.Xi * sigma_fsd * self.YF0
        # flame exists only where both reactants remain
        rate = rate * (Y[self.fuel] > 0.0) * (Y[self.oxidizer] > 0.0)
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        rr[self.fuel] = -rate
        rr[self.oxidizer] = -self.s * rate
        for i, yield_i in self.products:
            rr[i] = rr[i] + yield_i * rate
        return tuple(rr), self.q_fuel * rate


@register("combustion", "diffusion")
@dataclasses.dataclass(frozen=True)
class Diffusion(CombustionModel):
    """diffusion family (diffusionsQGD_8C shim): single-step diffusion-
    limited rate R_F = C * mu_eff * |grad(Y_F) . grad(Y_O)| — fuel and
    oxidizer burn where their gradients interleave (the flame sheet).
    Requires aux['gradY'] (from fvsc.grad_cell) and aux['mu_eff']."""

    fuel: int
    oxidizer: int
    products: tp.Tuple[tp.Tuple[int, float], ...]
    s: float
    C: float = 500.0
    q_fuel: float = 0.0
    needs_grad: bool = dataclasses.field(default=True, init=False)
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        ns = mix.n_species
        aux = aux or {}
        gY = aux.get("gradY")
        if gY is None:
            raise ValueError("diffusion combustion model needs aux['gradY']")
        mu_eff = aux.get("mu_eff", 1e-5)
        dot = jnp.sum(gY[self.fuel] * gY[self.oxidizer], axis=0)
        rate = self.C * mu_eff * jnp.abs(dot)
        # gate on both reactants being present
        rate = rate * (Y[self.fuel] > 0.0) * (Y[self.oxidizer] > 0.0)
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        rr[self.fuel] = -rate
        rr[self.oxidizer] = -self.s * rate
        for i, yield_i in self.products:
            rr[i] = rr[i] + yield_i * rate
        return tuple(rr), self.q_fuel * rate


@register("combustion", "diffusionMulticomponent")
@dataclasses.dataclass(frozen=True)
class DiffusionMulticomponent(CombustionModel):
    """diffusionMulticomponent family: one diffusion-limited flame sheet per
    (fuel_i, oxidizer_i) pair with per-pair rate constants Ci and
    stoichiometry si, summed over pairs (diffusionMulticomponentsQGD_8C)."""

    pairs: tp.Tuple[tp.Tuple[int, int], ...]      # (fuel, oxidizer) indices
    si: tp.Tuple[float, ...]                      # per-pair mass stoich
    Ci: tp.Tuple[float, ...]                      # per-pair rate constants
    products: tp.Tuple[tp.Tuple[int, float], ...]  # shared product yields
    q_fuel: tp.Tuple[float, ...] = ()
    needs_grad: bool = dataclasses.field(default=True, init=False)
    needs_aux: bool = dataclasses.field(default=True, init=False)

    def correct(self, mix: MixtureThermo, Y, rho, T, p, dt=None, aux=None):
        ns = mix.n_species
        aux = aux or {}
        gY = aux.get("gradY")
        if gY is None:
            raise ValueError(
                "diffusionMulticomponent needs aux['gradY']")
        mu_eff = aux.get("mu_eff", 1e-5)
        rr = [jnp.zeros_like(T) for _ in range(ns)]
        qdot = jnp.zeros_like(T)
        qf = self.q_fuel or (0.0,) * len(self.pairs)
        for (fi, oi), s, C, q in zip(self.pairs, self.si, self.Ci, qf):
            dot = jnp.sum(gY[fi] * gY[oi], axis=0)
            rate = C * mu_eff * jnp.abs(dot)
            rate = rate * (Y[fi] > 0.0) * (Y[oi] > 0.0)
            rr[fi] = rr[fi] - rate
            rr[oi] = rr[oi] - s * rate
            total = (1.0 + s) * rate
            for i, yield_i in self.products:
                rr[i] = rr[i] + yield_i * total
            qdot = qdot + q * rate
        return tuple(rr), qdot


# ---------------------------------------------------------------------------
# chemistry solvers (makeChemistrySolversQGD_8C equivalents): integrate the
# stiff reaction sources over dt by sub-cycling, returning EFFECTIVE mean
# rates for the operator-split YEqn (noChemistrySolver / EulerImplicit / ode).
# ---------------------------------------------------------------------------


class ChemistrySolver:
    """Base: rates(model, mix, Y, rho, T, p, dt) -> (RR tuple, Qdot)."""


@register("chemistrySolver", "none")
@dataclasses.dataclass(frozen=True)
class DirectRates(ChemistrySolver):
    """noChemistrySolver: instantaneous rates, no sub-integration."""

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        return _call(model, mix, Y, rho, T, p, dt, aux=aux)


@register("chemistrySolver", "EulerImplicit")
@register("chemistrySolver", "euler")
@dataclasses.dataclass(frozen=True)
class SubcycledEuler(ChemistrySolver):
    """EulerImplicit analogue: n_sub forward-Euler sub-steps of the source
    ODE dY/dt = RR/rho at frozen (rho, T, p); returns the mean rate over dt
    so the split YEqn advances Y exactly to the sub-integrated endpoint."""

    n_sub: int = 8

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        h = dt / self.n_sub
        Yc = list(Y)
        q_acc = 0.0
        for _ in range(self.n_sub):
            rr, qdot = _call(model, mix, tuple(Yc), rho, T, p, h, aux=aux)
            for i in range(mix.n_species):
                Yc[i] = Yc[i] + h * rr[i] / rho
            q_acc = q_acc + qdot
        rr_eff = tuple((Yc[i] - Y[i]) * rho / dt for i in range(mix.n_species))
        return rr_eff, q_acc / self.n_sub


@register("chemistrySolver", "ode")
@dataclasses.dataclass(frozen=True)
class SubcycledRK4(ChemistrySolver):
    """ode (RK) analogue: RK4 sub-steps at frozen (rho, T, p)."""

    n_sub: int = 4

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        ns = mix.n_species
        h = dt / self.n_sub

        def f(Yc):
            rr, qdot = _call(model, mix, tuple(Yc), rho, T, p, h, aux=aux)
            return [r / rho for r in rr], qdot

        Yc = list(Y)
        q_acc = 0.0
        for _ in range(self.n_sub):
            k1, q1 = f(Yc)
            k2, _ = f([Yc[i] + 0.5 * h * k1[i] for i in range(ns)])
            k3, _ = f([Yc[i] + 0.5 * h * k2[i] for i in range(ns)])
            k4, _ = f([Yc[i] + h * k3[i] for i in range(ns)])
            Yc = [Yc[i] + h / 6.0 * (k1[i] + 2 * k2[i] + 2 * k3[i] + k4[i])
                  for i in range(ns)]
            q_acc = q_acc + q1
        rr_eff = tuple((Yc[i] - Y[i]) * rho / dt for i in range(ns))
        return rr_eff, q_acc / self.n_sub


# ---------------------------------------------------------------------------
# TDAC: mechanism reduction + tabulation (makeChemistryReductionMethodsQGD_8C,
# makeChemistryTabulationMethodsQGD_8C, TDAC path of
# BasicChemistryModelsQGD_8C:48-60).
#
# Device stance: OpenFOAM's TDAC reduces the mechanism PER CELL each step
# and tabulates ODE solutions in a binary tree — both are data-dependent
# control flow that cannot live inside an XLA-compiled step.  Here reduction
# runs at TRACE TIME against a reference state (the mechanism the compiled
# step integrates is the pruned one — the compile-once analogue of DAC), and
# ISAT-style tabulation is a host-side cache for eager/driver-loop use where
# the kinetics subset evaluation is numpy-cheap.
# ---------------------------------------------------------------------------


class ChemistryReduction:
    """Base: reduce(mix, reactions, Y0, T0, p0) -> (reactions', active)."""


@register("chemistryReduction", "none")
@dataclasses.dataclass(frozen=True)
class NoReduction(ChemistryReduction):
    def reduce(self, mix, reactions, Y0, T0, p0):
        return tuple(reactions), tuple(range(mix.n_species))


@register("chemistryReduction", "DRG")
@dataclasses.dataclass(frozen=True)
class DRG(ChemistryReduction):
    """Directed Relation Graph reduction at a reference state: interaction
    coefficient r_AB = sum_{i: B in rxn i} |nu_Ai w_i| / sum_i |nu_Ai w_i|;
    BFS from `targets` keeps every specie reachable through edges with
    r >= threshold; reactions touching a removed specie are pruned."""

    targets: tp.Tuple[int, ...]
    threshold: float = 0.01

    def reduce(self, mix, reactions, Y0, T0, p0):
        import numpy as _np

        ns = mix.n_species
        conc = [max(float(Y0[i]), 0.0) * float(p0) /
                (R_UNIVERSAL * float(T0) * mix.species[i].W)
                for i in range(ns)]
        # per-reaction rates at the reference state (scalar numpy math)
        w = []
        for rxn in reactions:
            k = rxn.A * float(T0) ** rxn.beta * _np.exp(
                -rxn.Ta / max(float(T0), 1.0))
            for i, nu in rxn.lhs:
                k *= max(conc[i], 0.0) ** nu
            w.append(abs(k))
        # denominator: total production/consumption per specie
        denom = _np.zeros(ns)
        nu_net = []
        for rxn, wi in zip(reactions, w):
            nus = {}
            for i, nu in rxn.lhs:
                nus[i] = nus.get(i, 0.0) - nu
            for i, nu in rxn.rhs:
                nus[i] = nus.get(i, 0.0) + nu
            nu_net.append(nus)
            for i, nu in nus.items():
                denom[i] += abs(nu * wi)
        # r[A][B]: A depends on B
        r = _np.zeros((ns, ns))
        for rxn, wi, nus in zip(reactions, w, nu_net):
            involved = set(nus) | {i for i, _ in rxn.lhs}
            for A, nuA in nus.items():
                if denom[A] <= 0.0:
                    continue
                for B in involved:
                    if B != A:
                        r[A, B] = max(r[A, B], abs(nuA * wi) / denom[A])
        # BFS from targets over edges r >= threshold
        keep = set(self.targets)
        frontier = list(self.targets)
        while frontier:
            A = frontier.pop()
            for B in range(ns):
                if B not in keep and r[A, B] >= self.threshold:
                    keep.add(B)
                    frontier.append(B)
        pruned = tuple(
            rxn for rxn in reactions
            if all(i in keep for i, _ in rxn.lhs)
            and all(i in keep for i, _ in rxn.rhs)
        )
        return pruned, tuple(sorted(keep))


class ChemistryTabulation:
    """Base: host-side retrieve/grow cache of integrated rates."""


@register("chemistryTabulation", "none")
@dataclasses.dataclass(frozen=True)
class NoTabulation(ChemistryTabulation):
    def rates(self, compute, mix, Y, rho, T, p, dt):
        return compute(Y, rho, T, p, dt)


@register("chemistryTabulation", "ISAT")
class ISAT(ChemistryTabulation):
    """ISAT-style tabulation (host/eager path only): cells are keyed by
    their (T, p, Y) quantized to `tol` relative steps; only cells whose key
    misses the table get the kinetics evaluated (pointwise, on the miss
    subset), and results are stored for retrieval.  `max_size` evicts
    nothing — the table is cleared wholesale when full (OpenFOAM ISAT's
    maxNLeafs -> clear behaviour)."""

    def __init__(self, tol: float = 1e-3, max_size: int = 100000):
        self.tol = tol
        self.max_size = max_size
        self.table: dict = {}
        self.hits = 0
        self.misses = 0

    def _keys(self, Y, T, p):
        import numpy as _np

        q = [_np.round(_np.log(_np.maximum(_np.asarray(T, dtype=_np.float64)
                                           .reshape(-1), 1e-300))
                       / self.tol).astype(_np.int64),
             _np.round(_np.log(_np.maximum(_np.asarray(p, dtype=_np.float64)
                                           .reshape(-1), 1e-300))
                       / self.tol).astype(_np.int64)]
        for Yi in Y:
            q.append(_np.round(_np.asarray(Yi, dtype=_np.float64)
                               .reshape(-1) / self.tol).astype(_np.int64))
        return list(zip(*(arr.tolist() for arr in q)))

    def rates(self, compute, mix, Y, rho, T, p, dt):
        import numpy as _np
        import jax.core as _jc

        if any(isinstance(x, _jc.Tracer) for x in (T, p, *Y)):
            # inside jit: tabulation is a host-side optimisation only
            return compute(Y, rho, T, p, dt)
        ns = mix.n_species
        shape = _np.asarray(T).shape
        keys = self._keys(Y, T, p)
        ncells = len(keys)
        miss_idx = [i for i, k in enumerate(keys) if k not in self.table]
        if miss_idx:
            if len(self.table) > self.max_size:
                self.table.clear()
            flat = lambda x: _np.asarray(x, dtype=_np.float64).reshape(-1)
            sel = _np.asarray(miss_idx)
            Ym = tuple(flat(Yi)[sel] for Yi in Y)
            rr_m, q_m = compute(Ym, flat(rho)[sel], flat(T)[sel],
                                flat(p)[sel], dt)
            rr_m = [_np.asarray(r) for r in rr_m]
            q_m = _np.asarray(q_m)
            for j, i in enumerate(miss_idx):
                self.table[keys[i]] = (
                    tuple(float(r[j]) for r in rr_m), float(q_m[j]))
        self.misses += len(miss_idx)
        self.hits += ncells - len(miss_idx)
        rr_out = _np.zeros((ns, ncells))
        q_out = _np.zeros(ncells)
        for i, k in enumerate(keys):
            vals, qv = self.table[k]
            rr_out[:, i] = vals
            q_out[i] = qv
        return (tuple(jnp.asarray(rr_out[i].reshape(shape))
                      for i in range(ns)),
                jnp.asarray(q_out.reshape(shape)))


@register("chemistrySolver", "TDAC")
@dataclasses.dataclass(frozen=True)
class TDACChemistrySolver(ChemistrySolver):
    """TDAC wrapper around a base integrator: static DRG mechanism pruning
    (applied to Laminar-kinetics models at build/trace time against
    `ref_state` = (Y0, T0, p0)) + optional ISAT tabulation of the
    integrated rates (host/eager path)."""

    base: ChemistrySolver
    reduction: tp.Optional[ChemistryReduction] = None
    tabulation: tp.Optional[ChemistryTabulation] = None
    ref_state: tp.Optional[tuple] = None

    def _pruned(self, model, mix):
        if self.reduction is None or self.ref_state is None:
            return model
        Y0, T0, p0 = self.ref_state
        if isinstance(model, Laminar):
            rxns, _ = self.reduction.reduce(mix, model.reactions, Y0, T0, p0)
            return dataclasses.replace(model, reactions=rxns)
        if isinstance(model, (PaSR, EDC)):
            return dataclasses.replace(
                model, base=self._pruned(model.base, mix))
        return model

    def rates(self, model, mix, Y, rho, T, p, dt, aux=None):
        model = self._pruned(model, mix)
        if self.tabulation is not None:
            def compute(Yc, rhoc, Tc, pc, dtc):
                return self.base.rates(model, mix, Yc, rhoc, Tc, pc, dtc,
                                       aux=aux)
            return self.tabulation.rates(compute, mix, Y, rho, T, p, dt)
        return self.base.rates(model, mix, Y, rho, T, p, dt, aux=aux)


@register("chemistryTabulation", "ISATDevice")
@dataclasses.dataclass(frozen=True)
class DeviceISAT(ChemistryTabulation):
    """Jit-compatible device-resident tabulation (the device-side ISAT).

    OpenFOAM's ISAT grows a binary tree of ODE solutions on the host —
    data-dependent control flow XLA cannot compile, which is why the host
    `ISAT` class above bails to direct compute under tracing.  This variant
    keeps a FIXED-CAPACITY open-addressed hash table as explicit functional
    state (arrays in the step carry), so retrieval/insert run inside the
    jitted step:

      key   = quantized (log T, log p, Y/tol) int vector, hashed to one slot
      hit   = slot valid AND the FULL stored key equals the cell key
              -> gather stored rates (exact verification: a 32-bit hash
              collision can never return wrong rates)
      miss  -> rates computed and scattered into the slots
              (last-writer-wins on collisions)

    On SIMD hardware the ODE integration is batched, so unlike host ISAT the
    win is not skipped cells but (a) the whole batched integration is
    SKIPPED (lax.cond) on steps where every cell hits — exact step-to-step
    reuse in quasi-steady regions — and (b) the miss mask is passed to
    `compute` so a mask-aware integrator can early-exit.  `hits`/`lookups`
    counters ride in the state as 2-limb uint32 pairs (overflow-safe without
    x64) for the reference's ISAT retrieve diagnostics; read them with
    `DeviceISAT.counter(table, "hits")`.

    Usage (functional):
        tab = DeviceISAT(tol=1e-3, capacity=1 << 15)
        table = tab.init(n_species, dtype=jnp.float32)
        (rr, q), table = tab.rates_stateful(table, compute, mix, Y, rho,
                                            T, p, dt)
    where `compute(Y, rho, T, p, dt, miss=None)` returns (rr tuple, Qdot);
    the `miss` keyword (a flat bool mask, None on the untabulated path) is
    optional for the integrator to exploit.
    """

    tol: float = 1e-3
    capacity: int = 1 << 15  # slots (power of two)

    def init(self, n_species: int, dtype=jnp.float32):
        cap = self.capacity
        return {
            # key rows: quantized (log T, log p, log dt, Y/tol...) — dt is
            # part of the key because the tabulated value is the effective
            # mean rate of the sub-integrated mapping over dt, not an
            # instantaneous rate
            "keys": jnp.zeros((n_species + 3, cap), dtype=jnp.int32),
            "valid": jnp.zeros((cap,), dtype=jnp.bool_),
            "rr": jnp.zeros((n_species, cap), dtype=dtype),
            "q": jnp.zeros((cap,), dtype=dtype),
            "hits": jnp.zeros((2,), dtype=jnp.uint32),
            "lookups": jnp.zeros((2,), dtype=jnp.uint32),
            # live-slot overwrites (a miss landing on a valid slot with a
            # different key) — the open-addressed table's eviction metric;
            # a rising eviction rate means the capacity is too small for
            # the state-space being visited (pathological miss rates)
            "evictions": jnp.zeros((2,), dtype=jnp.uint32),
        }

    @staticmethod
    def counter(table, name: str) -> int:
        """Decode a 2-limb uint32 counter ([lo, hi]) to a Python int."""
        c = np.asarray(table[name], dtype=np.uint64)
        return int(c[0] + (c[1] << np.uint64(32)))

    @staticmethod
    def _ctr_add(c, n):
        """(2,) uint32 [lo, hi] += n with carry (overflow-safe counters)."""
        lo = c[0] + n.astype(jnp.uint32)
        carry = (lo < c[0]).astype(jnp.uint32)
        return jnp.stack([lo, c[1] + carry])

    def _key(self, Y, T, p, dt):
        """Quantized key matrix (n_species+3, cells) + FNV-1a slot index."""
        def quant(x, lo=1e-30):
            return jnp.round(
                jnp.log(jnp.maximum(x, lo)) / self.tol).astype(jnp.int32)

        rows = [quant(T), quant(p),
                jnp.broadcast_to(quant(jnp.asarray(dt, dtype=T.dtype)),
                                 jnp.shape(T))]
        for Yi in Y:
            rows.append(jnp.round(Yi / self.tol).astype(jnp.int32))
        key = jnp.stack(rows)

        h = jnp.full(jnp.shape(T), 0x811C9DC5, dtype=jnp.uint32)
        for v in rows:
            h = jnp.bitwise_xor(h, v.astype(jnp.uint32)) * jnp.uint32(16777619)
        slot = (h % jnp.uint32(self.capacity)).astype(jnp.int32)
        return key, slot

    def rates_stateful(self, table, compute, mix, Y, rho, T, p, dt):
        """(rates, Qdot), table' — all lax ops, safe under jit/scan."""
        shape = jnp.shape(T)
        flat = lambda x: jnp.reshape(x, (-1,))
        Tf, pf = flat(T), flat(p)
        Yf = tuple(flat(Yi) for Yi in Y)
        key, slot = self._key(Yf, Tf, pf, dt)
        stored_key = table["keys"][:, slot]
        hit = jnp.logical_and(table["valid"][slot],
                              jnp.all(stored_key == key, axis=0))
        miss = jnp.logical_not(hit)

        def _compute(_):
            try:
                rr_c, q_c = compute(Y, rho, T, p, dt,
                                    miss=jnp.reshape(miss, shape))
            except TypeError:  # integrator without mask support
                rr_c, q_c = compute(Y, rho, T, p, dt)
            return (jnp.stack([flat(r) for r in rr_c]).astype(
                        table["rr"].dtype),
                    flat(q_c).astype(table["q"].dtype))

        def _skip(_):
            # every cell hit: the batched integration is skipped entirely
            return (jnp.zeros((mix.n_species, Tf.shape[0]),
                              dtype=table["rr"].dtype),
                    jnp.zeros((Tf.shape[0],), dtype=table["q"].dtype))

        rr_cf, q_cf = jax.lax.cond(jnp.any(miss), _compute, _skip,
                                   operand=None)

        rr_tab = table["rr"][:, slot]
        q_tab = table["q"][slot]
        rr_out = jnp.where(hit[None, :], rr_tab, rr_cf)
        q_out = jnp.where(hit, q_tab, q_cf)

        # insert misses (scatter; last-writer-wins on slot collisions)
        new_rr = table["rr"].at[:, slot].set(
            jnp.where(miss[None, :], rr_cf, rr_tab))
        new_q = table["q"].at[slot].set(jnp.where(miss, q_cf, q_tab))
        new_keys = table["keys"].at[:, slot].set(
            jnp.where(miss[None, :], key, stored_key))
        new_valid = table["valid"].at[slot].set(True)
        table2 = {
            "keys": new_keys, "valid": new_valid,
            "rr": new_rr, "q": new_q,
            "hits": self._ctr_add(table["hits"], jnp.sum(hit)),
            "lookups": self._ctr_add(table["lookups"],
                                     jnp.asarray(Tf.shape[0])),
            "evictions": self._ctr_add(
                table["evictions"],
                jnp.sum(jnp.logical_and(miss, table["valid"][slot]))),
        }
        ns = rr_out.shape[0]
        return (tuple(jnp.reshape(rr_out[i], shape) for i in range(ns)),
                jnp.reshape(q_out, shape)), table2
