"""Boundary conditions over structured block faces.

The reference implements BCs as OpenFOAM fvPatchField subclasses (reference
QGD/BCs/: qgdFluxFvPatchScalarField.C, qhdFluxFvPatchScalarField.C,
cosVelocityFvPatchVectorField.C).  Here a BC is a small frozen dataclass that
maps the first interior cell layer to a ghost cell layer; all operators then
work on ghost-padded arrays with uniform slicing (XLA friendly — no
scatter, no boundary special cases inside kernels).  The padding itself lives
in ops/pad.py.

Ghost conventions (ghost center mirrored across the face, distance dx_edge
from the interior center):
  FixedValue v     : G = 2 v - I        (face value == v under linear interp)
  ZeroGradient     : G = I
  FixedGradient g  : G = I + g dx_edge  (g = outward-normal gradient)
  Symmetry scalar  : G = I
  Symmetry vector  : normal component negated, tangential copied
  Periodic         : G = opposite-side interior layer
  Extrapolated     : G = 2 I - I2       (linear extrapolation, outflow)

BC `value`/`grad` entries may be:
  * a scalar (or per-component vector for vector fields),
  * an array broadcastable against the boundary layer (axis-`a` dim kept as 1),
  * a callable `f(t, coords)` with `coords` a tuple of ndim broadcastable
    coordinate arrays of the ghost layer (the normal axis holds the face
    coordinate) — this is how time/space-dependent BCs like the reference's
    cosVelocity (cosVelocityFvPatchVectorField_8C.html:176-186) are written.

State-coupled pressure BCs (qgdFlux / qhdFlux) are realised by the solvers
constructing a FixedGradient with the traced per-step gradient value
(reference qgdFluxFvPatchScalarField.C updateCoeffs: dp/dn = -phiwStar/(tau_f
|Sf|); qhdFlux adds the rho_f factor) — see solvers/qgd.py / solvers/qhd.py.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax.numpy as jnp


class BC:
    """Base class for boundary conditions (marker)."""


@dataclasses.dataclass(frozen=True)
class FixedValue(BC):
    value: tp.Any


@dataclasses.dataclass(frozen=True)
class ZeroGradient(BC):
    pass


@dataclasses.dataclass(frozen=True)
class FixedGradient(BC):
    grad: tp.Any  # outward-normal gradient


@dataclasses.dataclass(frozen=True)
class Symmetry(BC):
    """Symmetry plane / slip wall. Scalars: zero gradient; vectors: mirror."""


@dataclasses.dataclass(frozen=True)
class Periodic(BC):
    """Cyclic boundary; both sides of the axis must be Periodic."""


@dataclasses.dataclass(frozen=True)
class Extrapolated(BC):
    """Linear extrapolation from the two interior layers (outflow-ish)."""


@dataclasses.dataclass(frozen=True)
class Mixed(BC):
    """OpenFOAM mixed BC with zero refGrad: face value =
    fraction*value + (1 - fraction)*interior-cell value, so the ghost is
    G = 2*(f*v + (1-f)*I) - I.  fraction=1 -> FixedValue, fraction=0 ->
    ZeroGradient.  Used by the waveTransmissive substitution (the
    advective-BC valueFraction)."""

    value: tp.Any
    fraction: tp.Any


@dataclasses.dataclass(frozen=True)
class InletOutlet(BC):
    """OpenFOAM inletOutlet: per-face switch on the flux direction —
    zeroGradient where flow leaves the domain, fixedValue `inlet_value`
    where it enters (the entrainment-boundary BC of the reference jet
    tutorials).  A marker: solvers resolve it each step into `FluxSwitched`
    via `resolve_inlet_outlet` using the interior-cell outward normal
    velocity (OpenFOAM switches on the face flux phi; on the uncoupled
    boundaries this BC is used on, the adjacent-cell normal velocity carries
    the same sign — documented deviation: phi includes the QGD mass-flux
    correction, the switch here does not)."""

    inlet_value: tp.Any = 0.0


@dataclasses.dataclass(frozen=True)
class FluxSwitched(BC):
    """Resolved inletOutlet: `outflow` is a boolean boundary-layer array
    (True -> zeroGradient ghost, False -> fixedValue(value) ghost)."""

    value: tp.Any
    outflow: tp.Any


def resolve_inlet_outlet(bcs: "FieldBCs", U, ndim: int) -> "FieldBCs":
    """Replace InletOutlet markers with FluxSwitched from the current cell
    velocity U (d, *cells), recursing into Segmented sides.  No-op
    (trace-time) when no marker is present."""

    def has_io(b):
        if isinstance(b, InletOutlet):
            return True
        if isinstance(b, Segmented):
            return any(has_io(s) for _, s in b.segments)
        return False

    if not any(has_io(bcs[a, s]) for a in range(ndim) for s in (0, 1)):
        return bcs
    out = bcs
    for a in range(ndim):
        for side in (0, 1):
            b = out[a, side]
            if not has_io(b):
                continue
            idx = 0 if side == 0 else -1
            un = jnp.take(U[a], jnp.asarray([idx]), axis=a)
            outflow = (un < 0) if side == 0 else (un > 0)

            def resolve(x):
                if isinstance(x, InletOutlet):
                    return FluxSwitched(x.inlet_value, outflow)
                if isinstance(x, Segmented):
                    return Segmented(tuple(
                        (r, resolve(s)) for r, s in x.segments))
                return x

            out = out.replace(a, side, resolve(b))
    return out


@dataclasses.dataclass(frozen=True)
class Segmented(BC):
    """A mesh side shared by SEVERAL patches with different BCs (split-side
    layouts: a jet `inlet` strip surrounded by a `farField` patch on the
    same boundary plane — the reference's per-patch boundary handling,
    extendedFaceStencilScalarGrad_8C_source.html:86-109).

    segments: ordered tuple of (rects, bc).  Each `rects` is a tuple of
    rectangles; a rectangle is a tuple of (lo, hi) half-open GLOBAL
    cell-index ranges, one per tangential spatial axis in ascending axis
    order (the side's normal axis excluded).  Ghost cells outside the
    domain (corner positions) take the nearest segment (indices clamp).
    Segments are applied in order; later segments win on overlap, and
    every boundary cell must be covered (ingestion validates coverage).
    """

    segments: tp.Tuple[tp.Tuple[tp.Any, BC], ...]


@dataclasses.dataclass(frozen=True)
class QGDFluxP(BC):
    """qgdFlux pressure BC marker: the solver substitutes a FixedGradient
    with dp/dn = -phiwStar/(tau_f*|Sf|) each step (reference
    qgdFluxFvPatchScalarField_8C_source.html updateCoeffs, gradient at :192)."""


@dataclasses.dataclass(frozen=True)
class WaveTransmissive(BC):
    """OpenFOAM waveTransmissive outflow marker (the characteristics-based
    advective/non-reflecting condition the reference jet tutorials select
    for p).  The solver carries the patch face value in its State and
    advances it each step with the implicit-upwind advective update at the
    outgoing wave speed w = max(Un, 0) + c:

        v^{n+1} = (v^n + alpha*phi_cell + k*field_inf) / (1 + alpha + k),
        alpha = w dt / delta,  k = w dt / l_inf  (0 when l_inf == 0),

    delta the cell-center-to-face distance — OpenFOAM
    advectiveFvPatchField::updateCoeffs with the Euler ddt scheme, with
    waveTransmissive's advectionSpeed() = phi/(rho|Sf|) + sqrt(gamma p/rho).
    l_inf > 0 relaxes the face value toward the far-field `field_inf` on
    the length scale l_inf.  During the step the BC acts as
    FixedValue(v^n) (the same lagged-carry pattern as QGDFluxP)."""

    field_inf: float = 0.0
    l_inf: float = 0.0


@dataclasses.dataclass(frozen=True)
class QHDFluxP(BC):
    """qhdFlux pressure BC marker: dp/dn = -phiwStar*rho_f/(tau_f*|Sf|)
    (reference qhdFluxFvPatchScalarField_8C_source.html:193-203).  Also used
    for the two-phase mixture variant mQhdFlux
    (mQhdFluxFvPatchScalarField_8C_source.html)."""


def noslip(ndim: int) -> FixedValue:
    return FixedValue(jnp.zeros((ndim,)))


def cos_velocity(amplitude, omega0, phi0, height, ndim, flow_axis=0, profile_axis=1):
    """Time-periodic velocity BC — reference cosVelocity:
    U = A*cos(pi*z/H)*(-omega0)*sin(omega0*t + phi0)
    (cosVelocityFvPatchVectorField_8C.html:176-186)."""

    def value(t, coords):
        z = coords[profile_axis]
        u = amplitude * jnp.cos(jnp.pi * z / height) * (-omega0) * jnp.sin(
            omega0 * t + phi0
        )
        comps = [jnp.zeros_like(u + 0.0 * t) for _ in range(ndim)]
        comps[flow_axis] = u + 0.0 * comps[flow_axis]
        return jnp.stack(jnp.broadcast_arrays(*comps), axis=0)

    return FixedValue(value)


def homogeneous(bc: BC) -> BC:
    """Zero the inhomogeneous part — used to build the linear part of implicit
    operators (matrix-free CG matvec needs a linear map)."""
    if isinstance(bc, FixedValue):
        return FixedValue(0.0)
    if isinstance(bc, FixedGradient):
        return FixedGradient(0.0)
    if isinstance(bc, Mixed):
        return Mixed(0.0, bc.fraction)
    if isinstance(bc, FluxSwitched):
        return FluxSwitched(0.0, bc.outflow)
    if isinstance(bc, InletOutlet):
        return InletOutlet(0.0)
    return bc


class FieldBCs:
    """Per-field boundary set: one BC per (axis, side), side 0=low, 1=high."""

    def __init__(self, bcs):
        self.bcs = tuple(tuple(b) for b in bcs)

    @staticmethod
    def uniform(bc: BC, ndim: int) -> "FieldBCs":
        return FieldBCs(tuple((bc, bc) for _ in range(ndim)))

    def __getitem__(self, key):
        axis, side = key
        return self.bcs[axis][side]

    @property
    def ndim(self):
        return len(self.bcs)

    def replace(self, axis: int, side: int, bc: BC) -> "FieldBCs":
        bcs = [list(b) for b in self.bcs]
        bcs[axis][side] = bc
        return FieldBCs(bcs)

    def map(self, fn) -> "FieldBCs":
        """Apply fn to every leaf BC, recursing into Segmented sides (fn
        sees the sub-BCs, never the Segmented wrapper)."""

        def one(b):
            if isinstance(b, Segmented):
                return Segmented(tuple((r, one(s)) for r, s in b.segments))
            return fn(b)

        return FieldBCs(tuple(tuple(one(b) for b in row) for row in self.bcs))
