"""Shared solver building blocks: time-step control, Courant numbers, runner.

Re-design of reference QGD/QGDcommon/ time-control includes:
  * setDeltaT-QGDQHD.H (docs/html/setDeltaT-QGDQHD_8H_source.html:41-61):
    damped dt growth, acoustic-CFL bound, cTau*min(tau_f) cap;
  * QGDCourantNo.H (QGDCourantNo_8H_source.html:36-53): acoustic Courant
    max(|Un+c|,|Un-c|)*dt/h_f;
  * QHDCourantNo.H (QHDCourantNo_8H_source.html:37-57): advective |Un|*dt/h_f.

Everything is a pure on-device function; the adaptive dt lives in the solver
state so a whole run can stay inside one `lax.scan`/`while_loop` without host
syncs (the replacement of the reference's per-step host-side
`runTime.setDeltaT`).
"""
from __future__ import annotations

import dataclasses
import typing as tp

import jax
import jax.numpy as jnp

from ..core import bc as bcm
from ..core.mesh import Mesh
from ..parallel import spmd

SMALL = 1e-30


def e_bcs_from_T(bc_T: "bcm.FieldBCs", e_of_T, Cv=None) -> "bcm.FieldBCs":
    """Internal-energy BCs derived from the configured T BCs:
    e_wall = e(T_wall) (sensibleInternalEnergy), so the implicit heat
    diffusion sub-step sees the correct wall condition — the reference's
    e-field boundary handling in QGDEEqn (QGDEEqn_8H_source.html:37-76 with
    thermo.he() patches derived from T patches).

    e_of_T: callable T -> e (Cv*T for calorically perfect gases, the JANAF
    sensible energy otherwise).  Cv: constant de/dT when one exists — needed
    to convert FixedGradient T BCs (grad_e = Cv*grad_T); with a T-dependent
    cv a FixedGradient T BC cannot be converted statically and raises."""

    def t2e(b):
        if isinstance(b, bcm.FixedValue) and not callable(b.value):
            return bcm.FixedValue(e_of_T(jnp.asarray(b.value)))
        if isinstance(b, bcm.FixedValue):
            return bcm.FixedValue(lambda t_, c_: e_of_T(b.value(t_, c_)))
        if isinstance(b, bcm.InletOutlet):
            if not callable(b.inlet_value):
                return bcm.InletOutlet(e_of_T(jnp.asarray(b.inlet_value)))
            return bcm.InletOutlet(lambda t_, c_: e_of_T(b.inlet_value(t_, c_)))
        if isinstance(b, bcm.FixedGradient):
            if Cv is None:
                raise ValueError(
                    "FixedGradient T BC with a T-dependent cv: no static "
                    "grad_e conversion exists (use ZeroGradient or FixedValue)")
            if not callable(b.grad):
                return bcm.FixedGradient(Cv * jnp.asarray(b.grad))
            return bcm.FixedGradient(lambda t_, c_: Cv * b.grad(t_, c_))
        if isinstance(b, bcm.Mixed):
            if not callable(b.value):
                return bcm.Mixed(e_of_T(jnp.asarray(b.value)), b.fraction)
            return bcm.Mixed(lambda t_, c_: e_of_T(b.value(t_, c_)),
                             b.fraction)
        return b

    return bc_T.map(t2e)


@dataclasses.dataclass(frozen=True)
class TimeControls:
    """controlDict equivalents (reference §2.5 config inventory)."""

    adjust_time_step: bool = True
    max_co: float = 0.5
    max_dt: float = 1.0
    c_tau: float = 0.75
    dt0: float = 1e-6


def set_delta_t(dt, co_num, tau_f_min, tc: TimeControls):
    """setDeltaT-QGDQHD.H: immediate reduction, damped increase
    (setDeltaT-QGDQHD_8H_source.html:41-61)."""
    if not tc.adjust_time_step:
        return dt
    max_fact = tc.max_co / (co_num + SMALL)
    fact = jnp.minimum(jnp.minimum(max_fact, 1.0 + 0.1 * max_fact), 1.2)
    max_dt1 = jnp.minimum(tc.max_dt, tc.c_tau * tau_f_min)
    return jnp.minimum(fact * dt, max_dt1)


def face_normal_speed(Uf_a, axis: int):
    """Un at faces normal to `axis` = component `axis` of the face velocity
    (structured-mesh Sf is axis-aligned: Uf & Sf/|Sf| = Uf[axis])."""
    return Uf_a[axis]


def courant_acoustic(Uf, cf, dt, mesh: Mesh):
    """QGD acoustic Courant: max over faces of max(|Un+c|,|Un-c|)*dt/h_f
    (QGDCourantNo_8H_source.html:44-50).  The max is global under an spmd
    context (the reference's `max()` gMax reduction,
    QGDCourantNo_8H_source.html:50); partition-edge faces are counted by
    both owning shards — idempotent for max."""
    co = 0.0
    for a in range(mesh.ndim):
        un = face_normal_speed(Uf[a], a)
        wave = jnp.maximum(jnp.abs(un + cf[a]), jnp.abs(un - cf[a]))
        co = jnp.maximum(co, jnp.max(wave * dt / mesh.h_face(a)))
    return spmd.all_max(co)


def courant_advective(Uf, dt, mesh: Mesh):
    """QHD advective Courant: max |Un|*dt/h_f
    (QHDCourantNo_8H_source.html:45-54)."""
    co = 0.0
    for a in range(mesh.ndim):
        un = jnp.abs(face_normal_speed(Uf[a], a))
        co = jnp.maximum(co, jnp.max(un * dt / mesh.h_face(a)))
    return spmd.all_max(co)


def courant_mag(Uf, dt, mesh: Mesh):
    """scalarTransportQHDFoam variant: mag(Uf) (full face-velocity magnitude)
    * dt / h_f (scalarTransportQHDFoam_8C_source.html:86-98)."""
    co = 0.0
    for a in range(mesh.ndim):
        mag = jnp.sqrt(jnp.sum(jnp.square(Uf[a]), axis=0))
        co = jnp.maximum(co, jnp.max(mag * dt / mesh.h_face(a)))
    return spmd.all_max(co)


def tau_f_min(tau_f):
    return spmd.all_min(jnp.min(jnp.asarray([jnp.min(tf) for tf in tau_f])))


# ---------------------------------------------------------------------------
# run drivers
# ---------------------------------------------------------------------------


class NonphysicalStateError(RuntimeError):
    """Raised by the checked runner when a prognostic field goes nonfinite or
    nonpositive — the reference's abort path (QGDFoam_8C_source.html:142-147
    writes U/e/rho to disk and exits on negative e or rho)."""

    def __init__(self, message, dump_path=None):
        super().__init__(message)
        self.dump_path = dump_path


def run_steps(step_fn, state, n_steps: int, log_every: int = 0,
              log_fn: tp.Optional[tp.Callable] = None,
              check_every: int = 0,
              check_fields: tp.Tuple[str, ...] = ("rho", "rhoE"),
              dump_dir: tp.Optional[str] = None):
    """Run `n_steps` with optional host-side logging and failure detection.

    With log_every == check_every == 0 the whole run is one `lax.scan`
    (zero host syncs — the bench path); otherwise the loop is chunked scans
    with logging/checking between chunks (the reference's per-step Info
    prints, QGDFoam_8C:160-162).

    check_every > 0 wires in the reference's crash-dump semantics
    (QGDFoam_8C:142-147): at that cadence the named state fields are checked
    for finiteness and positivity; on failure the full state pytree is
    written via utils.checkpoint.save to `dump_dir` (default
    "nonphysical_dump/") and NonphysicalStateError is raised.
    """

    def scan_body(s, _):
        return step_fn(s), None

    cadences = [x for x in (log_every, check_every) if x > 0]
    if not cadences:
        state, _ = jax.lax.scan(scan_body, state, None, length=n_steps)
        return state

    def check(done, s):
        bad = {}
        for name in check_fields:
            f = getattr(s, name, None)
            if f is None:
                continue
            import numpy as np

            arr = np.asarray(f)
            n_bad = int(np.sum(~np.isfinite(arr)) + np.sum(arr <= 0))
            if n_bad:
                bad[name] = n_bad
        if bad:
            from ..utils import checkpoint

            d = dump_dir or "nonphysical_dump"
            path = checkpoint.save(s, d, done)
            raise NonphysicalStateError(
                f"nonphysical state at step {done}: {bad} "
                f"(state dumped to {path})", dump_path=path)

    done = 0
    chunk_size = min(cadences)
    scan = jax.jit(lambda s, n: jax.lax.scan(scan_body, s, None, length=n)[0],
                   static_argnums=1)
    while done < n_steps:
        chunk = min(chunk_size, n_steps - done)
        state = scan(state, chunk)
        done += chunk
        if check_every > 0 and done % check_every == 0:
            check(done, state)
        if log_fn is not None and log_every > 0 and done % log_every == 0:
            log_fn(done, state)
    return state
