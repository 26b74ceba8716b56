"""tau-regularization coefficient models (the reference QGDCoeffs layer).

Re-design of reference QGD/QGDCoeffs/ (QGDCoeffs_8C_source.html:58-375 base;
constScPrModel1_8C_source.html correct(); HbyUQHD_8C / H2bynuQHD_8C /
T0byGr_8C / constTau_8C; varScModel5/6/7 shock sensors).  A model is a frozen
dataclass; `correct()` is a pure function from the current thermo state to a
`Coeffs` pytree — no mutable registered fields, the relaxation state of
varScModel5 (its ScQGD low-pass) is threaded through the solver state
explicitly.

Conventions: cell fields (..., spatial); face fields are per-axis tuples.
tau_f is interpolated exactly as the reference does per model (e.g. model1
interpolates a/c then multiplies by h_f, constScPrModel1_8C:103-104).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp

from ..core.mesh import Mesh
from ..core import bc as bcm
from ..core.registry import register
from ..ops import fvsc


def _zg(ndim):
    return bcm.FieldBCs.uniform(bcm.ZeroGradient(), ndim)


def _interp_zg(field, mesh):
    """OpenFOAM linearInterpolate of a coefficient field (zero-gradient
    extrapolation at uncoupled boundaries, like `calculated` patches)."""
    return fvsc.interpolate(field, _zg(mesh.ndim), mesh)


@dataclasses.dataclass(frozen=True)
class Coeffs:
    """Per-step regularization coefficients (pytree).

    Mirrors the fields owned by the reference QGDCoeffs base
    (QGDCoeffs_8H_source.html:62-176): tauQGD, tauQGDf, muQGD, alphauQGD,
    ScQGD diagnostic.
    """

    tau: tp.Any  # cell tau
    tau_f: tp.Any  # per-axis face tau tuple
    mu_qgd: tp.Any  # cell QGD viscosity add-in
    alphau_qgd: tp.Any  # cell QGD thermal-diffusivity add-in
    sc: tp.Any  # ScQGD field (carried state for varScModel5)


def _finish(mesh, tau, tau_f, p, sc, pr):
    """muQGD = p*Sc*tau, alphauQGD = muQGD/Pr
    (reference constScPrModel1_8C_source.html:106-115)."""
    mu_qgd = p * sc * tau
    return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=mu_qgd, alphau_qgd=mu_qgd / pr, sc=sc)


class TauModel:
    """Base marker. Subclasses implement correct(mesh, **state) -> Coeffs."""

    # alphaQGD in the reference: dict/field alpha, default 0.5
    # (QGDCoeffs_8C_source.html:119-160)


@register("tau", "constScPrModel1")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel1(TauModel):
    """Compressible default: tau = alpha*h/c; tau_f = interp(alpha/c)*h_f;
    muQGD = p*Sc*tau; alphauQGD = muQGD/Pr
    (reference constScPrModel1_8C_source.html:97-131)."""

    alpha: float = 0.5
    Sc: float = 1.0
    Pr: float = 1.0

    def correct(self, mesh: Mesh, *, c, p, sc_field=None, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = jnp.full_like(tau, self.Sc) if sc_field is None else sc_field
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)


@register("tau", "constScPrModel1n")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel1n(ConstScPrModel1):
    """Variant reading a per-cell ScQGD field if present (reference
    constScPrModel1n_8C_source.html:68-105): pass sc_field= to correct()."""


@register("tau", "constScPrModel2")
@dataclasses.dataclass(frozen=True)
class ConstScPrModel2(ConstScPrModel1):
    """Same tau as model1 with fixed Sc/Pr handling (reference
    constScPrModel2_8C_source.html:83)."""


@register("tau", "constTau")
@dataclasses.dataclass(frozen=True)
class ConstTau(TauModel):
    """tau = const from config; Sc=0, Pr=1 => muQGD = alphauQGD = 0
    (reference constTau_8C_source.html:48-75)."""

    tau0: float = 0.0

    def correct(self, mesh: Mesh, *, p=None, ref=None, **_):
        ref = ref if ref is not None else p
        tau = jnp.full(mesh.shape, self.tau0, dtype=ref.dtype)
        tau_f = tuple(
            jnp.full(mesh.face_shape(a), self.tau0, dtype=ref.dtype)
            for a in range(mesh.ndim)
        )
        z = jnp.zeros(mesh.shape, dtype=ref.dtype)
        return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=z, alphau_qgd=z, sc=z)


@register("tau", "HbyUQHD")
@dataclasses.dataclass(frozen=True)
class HbyUQHD(TauModel):
    """QHD: tau = alpha*h/U0, tau_f = interp(tau)
    (reference HbyUQHD_8C_source.html:80-84)."""

    alpha: float = 0.5
    U0: float = 1.0

    def correct(self, mesh: Mesh, *, p=None, T=None, ref=None, **_):
        ref = ref if ref is not None else (p if p is not None else T)
        tau = jnp.broadcast_to(self.alpha * mesh.h_cell / self.U0, mesh.shape).astype(
            ref.dtype
        )
        tau_f = _interp_zg(tau, mesh)
        z = jnp.zeros(mesh.shape, dtype=ref.dtype)
        return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=z, alphau_qgd=z, sc=z)


@register("tau", "H2bynuQHD")
@dataclasses.dataclass(frozen=True)
class H2bynuQHD(TauModel):
    """QHD: tau = alpha*h^2/nu, nu = mu/rho
    (reference H2bynuQHD_8C_source.html:78-83)."""

    alpha: float = 0.5

    def correct(self, mesh: Mesh, *, mu, rho, **_):
        nu = mu / rho
        tau = self.alpha * jnp.square(mesh.h_cell) / nu
        tau_f = _interp_zg(tau, mesh)
        z = jnp.zeros_like(tau)
        return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=z, alphau_qgd=z, sc=z)


@register("tau", "T0byGr")
@dataclasses.dataclass(frozen=True)
class T0byGr(TauModel):
    """QHD: tau = T0/Gr const (reference T0byGr_8C_source.html:84-88)."""

    T0: float = 1.0
    Gr: float = 1.0

    def correct(self, mesh: Mesh, *, p=None, T=None, ref=None, **_):
        ref = ref if ref is not None else (p if p is not None else T)
        tau0 = self.T0 / self.Gr
        tau = jnp.full(mesh.shape, tau0, dtype=ref.dtype)
        tau_f = tuple(
            jnp.full(mesh.face_shape(a), tau0, dtype=ref.dtype)
            for a in range(mesh.ndim)
        )
        z = jnp.zeros(mesh.shape, dtype=ref.dtype)
        return Coeffs(tau=tau, tau_f=tau_f, mu_qgd=z, alphau_qgd=z, sc=z)


# ---------------------------------------------------------------------------
# shock-sensor variable-Sc models
# ---------------------------------------------------------------------------


def _neighbour_max(field):
    """Max over the face neighbours of each cell (edge-replicated at
    boundaries, which is a no-op for the smoothing update below).  Under an
    spmd context, partition-edge neighbours come from the adjacent shard
    via ppermute (the FaceCellWave crossing processor patches)."""
    from ..parallel import spmd

    ctx = spmd.current()
    nd = field.ndim
    nb = field
    for a in range(nd):
        first = jnp.take(field, jnp.asarray([0]), axis=a)
        last = jnp.take(field, jnp.asarray([-1]), axis=a)
        if ctx is not None and ctx.sharded(a):
            prev_l, next_l, is_lo, is_hi = spmd.halo_layers(
                field, a, a, periodic=False)
            first = jnp.where(is_lo, first, prev_l)
            last = jnp.where(is_hi, last, next_l)
        lo = jnp.concatenate([first, field], axis=a)
        hi = jnp.concatenate([field, last], axis=a)
        sl_lo = [slice(None)] * nd
        sl_lo[a] = slice(0, -1)
        sl_hi = [slice(None)] * nd
        sl_hi[a] = slice(1, None)
        nb = jnp.maximum(nb, jnp.maximum(lo[tuple(sl_lo)], hi[tuple(sl_hi)]))
    return nb


def fvc_smooth(field, coeff, max_iters: int = 10_000):
    """Faithful OpenFOAM fvc::smooth (fvcSmooth.C + smoothData FaceCellWave).

    OpenFOAM seeds a FaceCellWave at every face whose two cells differ by
    more than maxRatio = 1 + coeff and propagates until, for every pair of
    adjacent cells, field[i] >= field[j]/maxRatio — i.e. a peak decays by at
    most a factor maxRatio per cell ring.  That fixed point is computed here
    by the monotone iteration  field <- max(field, nbr_max(field)/maxRatio)
    inside a lax.while_loop (values are nondecreasing and bounded by the
    global max, so it terminates in at most the mesh diameter iterations;
    in practice a peak stops spreading once it decays below the background).
    Replaces the reference varScModel5's sensor smoothing
    (varScModel5_8C_source.html:232) with identical numerics.
    """
    from ..parallel import spmd

    max_ratio = 1.0 + coeff

    def body_k(k):
        def body(carry):
            f, _, it = carry
            # several relaxation rings per convergence test: the iteration
            # is monotone and idempotent at the fixed point, so chunking
            # changes neither the result nor its bitwise value — it only
            # amortises the global any-reduce; the FIRST evaluation uses a
            # single ring so an already-smooth field exits at 1-ring cost
            fn = f
            for _ in range(k):
                fn = jnp.maximum(fn, _neighbour_max(fn) / max_ratio)
            # the termination test is GLOBAL under spmd (all shards must
            # agree on the fixed point — computed in the body so the while
            # cond stays collective-free)
            return fn, spmd.all_any(jnp.any(fn > f)), it + k

        return body

    def cond(carry):
        _, changed, it = carry
        return jnp.logical_and(changed, it < max_iters)

    f1, changed, it = body_k(1)((field, True, jnp.asarray(0)))
    out, _, _ = jax.lax.while_loop(cond, body_k(4), (f1, changed, it))
    return out


@register("tau", "varScModel5")
@dataclasses.dataclass(frozen=True)
class VarScModel5(TauModel):
    """Relaxed density-gradient shock sensor (reference
    varScModel5_8C_source.html:198-269):
      Sc <- rC*(|grad rho|*h/rho) + (1-rC)*Sc_prev, clamp [minSc,maxSc],
      floor cqSc, fvc::smooth, then muQGD = p*Sc*tau as model1.
    Note the reference interpolates a and c separately for tau_f here
    (interp(a)/interp(c)*h_f, :204-205)."""

    # defaults follow the reference ctor (varScModel5_8C_source.html:61-68)
    alpha: float = 0.5
    Pr: float = 1.0
    rC: float = 0.5
    minSc: float = 0.05
    maxSc: float = 1.0
    cqSc: tp.Any = 0.0  # scalar or per-cell bad-quality floor array
    smoothCoeff: float = 0.1
    # optional const-Sc cellSet (reference varScModel5: cells listed in the
    # `constScCells` set keep a fixed Sc instead of the sensor value)
    const_sc_mask: tp.Any = None   # 0/1 cell array
    const_sc_value: float = 1.0

    def sc_update(self, mesh: Mesh, rho, sc_prev):
        """The relaxed sensor update: Sc <- rC*(|grad rho|*h/rho) +
        (1-rC)*Sc_prev, clamp, bad-quality floor, const-Sc cellSet, then
        fvc::smooth — reference ordering varScModel5_8C:214-232."""
        from ..parallel import spmd as _spmd

        grad_rho = fvsc.grad_cell(rho, _zg(mesh.ndim), mesh)
        mag_grad = jnp.sqrt(jnp.sum(jnp.square(grad_rho), axis=0))
        sc = self.rC * (mag_grad * mesh.h_cell / rho) + (1.0 - self.rC) * sc_prev
        sc = jnp.clip(sc, self.minSc, self.maxSc)
        cq = self.cqSc
        if hasattr(cq, "ndim") and getattr(cq, "ndim", 0) > 0:
            # per-cell bad-quality floor: window to the shard's block
            cq = _spmd.localize_cells(jnp.asarray(cq), mesh.ndim)
        sc = jnp.maximum(sc, cq)
        if self.const_sc_mask is not None:
            mask = _spmd.localize_cells(jnp.asarray(self.const_sc_mask),
                                        mesh.ndim)
            sc = jnp.where(mask > 0, self.const_sc_value, sc)
        return fvc_smooth(sc, self.smoothCoeff)

    def correct(self, mesh: Mesh, *, c, p, rho, sc_prev, **_):
        tau = self.alpha * mesh.h_cell / c
        c_f = _interp_zg(c, mesh)
        tau_f = tuple(self.alpha / c_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = self.sc_update(mesh, rho, sc_prev)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)


def _pressure_jump_sensor(mesh: Mesh, p, bc_p=None, t=0.0):
    """Per-cell |sum_faces +-dp_f| / mean(p_f) — the varScModel6/7 sensor
    (varScModel6_8C_source.html:215-268).

    Internal faces contribute the signed owner/neighbour jump +-(p_nei-p_own),
    which telescopes to the per-axis second difference.  Uncoupled boundary
    faces contribute dpf = snGrad(p)/deltaCoeffs = (p_face - p_cell) with
    POSITIVE sign (varScModel6_8C:256-262), and p_face comes from the actual
    p boundary condition — under the ghost convention p_face - p_cell =
    (p_ghost - p_cell)/2, i.e. the boundary delta of the ghost-padded array
    halved.  With bc_p=None a zeroGradient convention is used (boundary
    dpf = 0), matching calculated/zeroGradient p patches.
    """
    from ..ops.pad import ghost_pad

    nd = mesh.ndim
    if bc_p is None:
        bc_p = _zg(nd)
    pe_full = ghost_pad(p, bc_p, mesh, t=t)
    total = jnp.zeros_like(p)
    sum_pf = jnp.zeros_like(p)
    for a in range(nd):
        # keep only axis-a ghosts
        sl = [slice(1, -1)] * nd
        sl[a] = slice(None)
        pe = pe_full[tuple(sl)]
        dp = jnp.diff(pe, axis=a)  # n+1 face deltas along a (ghost at ends)
        # halve the boundary-face deltas: contribution is (p_face - p_cell)
        first = jnp.take(dp, jnp.asarray([0]), axis=a) * 0.5
        last = jnp.take(dp, jnp.asarray([-1]), axis=a) * 0.5
        mid_sl = [slice(None)] * nd
        mid_sl[a] = slice(1, -1)
        dp = jnp.concatenate([first, dp[tuple(mid_sl)], last], axis=a)
        sl_lo = [slice(None)] * nd
        sl_lo[a] = slice(0, -1)
        sl_hi = [slice(None)] * nd
        sl_hi[a] = slice(1, None)
        # owner/neighbour signs: +hi face (cell is owner), -lo face (neighbour);
        # at boundaries the halved delta already carries the correct + sign:
        # low side -(p_cell - p_ghost)/2 = +(p_face - p_cell).
        total = total + dp[tuple(sl_hi)] - dp[tuple(sl_lo)]
        pf = 0.5 * (pe[tuple(sl_lo)] + pe[tuple(sl_hi)])
        sum_pf = sum_pf + pf[tuple(sl_lo)] + pf[tuple(sl_hi)]
    mean_pf = sum_pf / (2.0 * nd)
    return jnp.abs(total) / mean_pf


@register("tau", "varScModel6")
@dataclasses.dataclass(frozen=True)
class VarScModel6(TauModel):
    """Pressure-jump sensor: Sc = |sum +-dp_f|/mean(p_f)
    (reference varScModel6_8C_source.html:201-269)."""

    alpha: float = 0.5
    Pr: float = 1.0

    def correct(self, mesh: Mesh, *, c, p, bc_p=None, t=0.0, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = _pressure_jump_sensor(mesh, p, bc_p=bc_p, t=t)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)


@register("tau", "varScModel7")
@dataclasses.dataclass(frozen=True)
class VarScModel7(TauModel):
    """varScModel6 with coefficient cSc1 and optional clamps
    (reference varScModel7_8C_source.html:167-243)."""

    alpha: float = 0.5
    Pr: float = 1.0
    cSc1: float = 1.0
    minSc: float = -1.0  # < 0 disables, as the reference
    maxSc: float = -1.0

    def correct(self, mesh: Mesh, *, c, p, bc_p=None, t=0.0, **_):
        tau = self.alpha * mesh.h_cell / c
        aoc_f = _interp_zg(self.alpha / c, mesh)
        tau_f = tuple(aoc_f[a] * mesh.h_face(a) for a in range(mesh.ndim))
        sc = self.cSc1 * _pressure_jump_sensor(mesh, p, bc_p=bc_p, t=t)
        if self.minSc >= 0:
            sc = jnp.maximum(sc, self.minSc)
        if self.maxSc >= 0:
            sc = jnp.minimum(sc, self.maxSc)
        return _finish(mesh, tau, tau_f, p, sc, self.Pr)
