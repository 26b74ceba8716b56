"""Genuinely 2D shock validation for the FLAGSHIP config (VERDICT r3 next
#9): regular reflection of an oblique shock off a slip wall, run with
varScModel5 + qgdFlux — the production shock-capturing configuration.

Setup (classic regular-reflection benchmark): uniform M1 = 2 inflow from
the left; the TOP boundary prescribes the exact post-oblique-shock state
for a 10 deg flow deflection, so the incident shock enters at the top-left
corner, runs down at the analytic wave angle beta1, reflects off the
bottom slip wall, and exits right.  Asserted against the exact two-shock
theory: the double-shock pressure ratio p3/p1, the wall impact point of
the incident shock, and the reflected-shock position — the tangential
(vertex-stencil cross term + sensor) behavior the quasi-1D Sod test
cannot see."""
import math

import numpy as np
import jax
import jax.numpy as jnp

from qgdsolver_tpu.core import bc as bcm
from qgdsolver_tpu.core.mesh import Mesh
from qgdsolver_tpu.physics.thermo import PerfectGasThermo
from qgdsolver_tpu.physics.qgdcoeffs import VarScModel5
from qgdsolver_tpu.solvers import common
from qgdsolver_tpu.solvers.qgd import QGDFoam

GAMMA = 1.4


def oblique_shock(M1, theta):
    """Weak-solution oblique shock: wave angle beta and post-shock state
    ratios for deflection theta (exact theta-beta-M relation)."""

    def f(b):
        return (math.tan(theta)
                - 2.0 / math.tan(b)
                * (M1 ** 2 * math.sin(b) ** 2 - 1.0)
                / (M1 ** 2 * (GAMMA + math.cos(2 * b)) + 2.0))

    lo = math.asin(1.0 / M1) + 1e-9
    hi = math.radians(65.0)  # weak branch for these conditions
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if f(lo) * f(mid) <= 0:
            hi = mid
        else:
            lo = mid
    beta = 0.5 * (lo + hi)
    Mn1 = M1 * math.sin(beta)
    p_ratio = 1.0 + 2.0 * GAMMA / (GAMMA + 1.0) * (Mn1 ** 2 - 1.0)
    r_ratio = ((GAMMA + 1.0) * Mn1 ** 2) / ((GAMMA - 1.0) * Mn1 ** 2 + 2.0)
    T_ratio = p_ratio / r_ratio
    Mn2 = math.sqrt((1.0 + 0.5 * (GAMMA - 1.0) * Mn1 ** 2)
                    / (GAMMA * Mn1 ** 2 - 0.5 * (GAMMA - 1.0)))
    M2 = Mn2 / math.sin(beta - theta)
    return beta, p_ratio, r_ratio, T_ratio, M2


def _jump_x(p_line, x, thresh):
    """x where the pressure first crosses `thresh` (shock locator)."""
    idx = int(np.argmax(p_line > thresh))
    return float(x[idx])


def test_regular_reflection_flagship():
    M1, theta = 2.0, math.radians(10.0)
    b1, pr1, rr1, tr1, M2 = oblique_shock(M1, theta)
    # reflected shock: turn the flow back by theta at the wall
    b2, pr2, _, _, _ = oblique_shock(M2, theta)

    p1, T1 = 1.0e5, 300.0
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    c1 = float(th.c(jnp.asarray(T1)))
    u1 = M1 * c1
    p2, T2 = p1 * pr1, T1 * tr1
    u2 = M2 * float(th.c(jnp.asarray(T2)))

    nx, ny = 256, 96
    Lx, Ly = 2.0, 0.75
    mesh = Mesh.uniform((nx, ny), lengths=(Lx, Ly), dtype=np.float64)
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(jnp.asarray([u1, 0.0])), bcm.ZeroGradient()),
        (bcm.Symmetry(),
         bcm.FixedValue(jnp.asarray([u2 * math.cos(theta),
                                     -u2 * math.sin(theta)]))),
    ))
    # outlet p: zeroGradient (supersonic outflow).  Documented deviation
    # from the VERDICT's "varScModel5 + qgdFlux" ask: the lagged qgdFlux
    # dp/dn = -phiwStar/(tau_f|Sf|) is a SUBSONIC far-field condition; a
    # steady shock sitting on the outlet feeds its own w_star back through
    # the ghost pressure and diverges within ~10 steps (measured: pbc
    # 1.7e7 -> 1.4e9).  The reference tutorials place qgdFlux on smooth
    # far-field patches only; the flagship qgdFlux path stays covered by
    # the Sod flagship tests (2D and 3D) + the sharded parity tests.
    bc_p = bcm.FieldBCs((
        (bcm.FixedValue(p1), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.FixedValue(p2)),
    ))
    bc_T = bcm.FieldBCs((
        (bcm.FixedValue(T1), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.FixedValue(T2)),
    ))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                              maxSc=1.0, smoothCoeff=0.1),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    shp = mesh.shape
    # initialize with the exact THREE-region solution (incident + reflected
    # shock in place) — the standard startup for this benchmark; a cold
    # start's wall-impinging region-2 flow overdrives the lagged qgdFlux
    # gradient at the outlet corner before the reflection can form
    _, _, _, tr2, M3 = oblique_shock(M2, theta)
    p3, T3 = p2 * pr2, T2 * tr2
    u3 = M3 * float(th.c(jnp.asarray(T3)))
    x_imp0 = Ly / math.tan(b1)
    X = np.asarray(mesh.centers[0])[:, None] * np.ones(shp)
    Y = np.asarray(mesh.centers[1])[None, :] * np.ones(shp)
    in2 = Y > Ly - X * math.tan(b1)
    in3 = Y < (X - x_imp0) * math.tan(b2 - theta)
    p0 = np.where(in3, p3, np.where(in2, p2, p1))
    T0 = np.where(in3, T3, np.where(in2, T2, T1))
    ux0 = np.where(in3, u3, np.where(in2, u2 * math.cos(theta), u1))
    uy0 = np.where(in3, 0.0, np.where(in2, -u2 * math.sin(theta), 0.0))
    state = solver.init(
        p0=jnp.asarray(p0), T0=jnp.asarray(T0),
        U0=jnp.stack([jnp.asarray(ux0), jnp.asarray(uy0)]),
        sc0=jnp.full(shp, 0.05))

    step = solver.make_step()
    # ~2 domain transits to steady state (the 3-region init starts exact)
    t_end = 2.0 * Lx / u1
    run = jax.jit(lambda s: common.run_steps(step, s, 500))
    for _ in range(30):
        state = run(state)
        if float(state.t) > t_end:
            break
    assert float(state.t) > t_end, "did not reach steady state"

    U, e, T, p = solver.primitives(state)
    p = np.asarray(p)
    x = np.asarray(mesh.centers[0])
    y = np.asarray(mesh.centers[1])

    # the shock sensor must be ACTIVE along the shocks
    sc = np.asarray(state.sc)
    assert sc.max() > 3.0 * float(solver.tau_model.minSc), \
        "varScModel5 sensor did not activate"

    # (1) double-shock pressure ratio behind the reflection (wall row,
    # downstream of the impact point)
    p3_exact = p1 * pr1 * pr2
    x_imp = (Ly - 0.5 * float(mesh.dx[1][0])) / math.tan(b1)
    probe = (x > x_imp + 0.45) & (x < Lx - 0.2)
    p3_num = p[probe, 1].mean()
    np.testing.assert_allclose(p3_num, p3_exact, rtol=0.03)

    # (2) incident-shock position along y = 0.5*Ly: x_s = (Ly - y)/tan(b1)
    j = ny // 2
    thresh = p1 * (1.0 + 0.5 * (pr1 - 1.0))
    x_inc = _jump_x(p[:, j], x, thresh)
    x_inc_exact = (Ly - y[j]) / math.tan(b1)
    assert abs(x_inc - x_inc_exact) < 4.0 * Lx / nx, (x_inc, x_inc_exact)

    # (3) reflected-shock position along the same line: from the impact
    # point rising at angle (b2 - theta) above the wall
    x_ref_exact = x_imp + y[j] / math.tan(b2 - theta)
    p_after = p[:, j]
    thresh2 = p1 * pr1 * (1.0 + 0.5 * (pr2 - 1.0))
    x_ref = _jump_x(p_after, x, thresh2)
    assert abs(x_ref - x_ref_exact) < 6.0 * Lx / nx, (x_ref, x_ref_exact)


def _reflection_solver(bc_p_outlet, **solver_kw):
    """The regular-reflection config with a configurable outlet p BC."""
    M1, theta = 2.0, math.radians(10.0)
    b1, pr1, rr1, tr1, M2 = oblique_shock(M1, theta)
    b2, pr2, _, _, _ = oblique_shock(M2, theta)
    p1, T1 = 1.0e5, 300.0
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    c1 = float(th.c(jnp.asarray(T1)))
    u1 = M1 * c1
    p2, T2 = p1 * pr1, T1 * tr1
    u2 = M2 * float(th.c(jnp.asarray(T2)))
    nx, ny = 192, 72
    Lx, Ly = 2.0, 0.75
    mesh = Mesh.uniform((nx, ny), lengths=(Lx, Ly), dtype=np.float64)
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(jnp.asarray([u1, 0.0])), bcm.ZeroGradient()),
        (bcm.Symmetry(),
         bcm.FixedValue(jnp.asarray([u2 * math.cos(theta),
                                     -u2 * math.sin(theta)]))),
    ))
    bc_p = bcm.FieldBCs((
        (bcm.FixedValue(p1), bc_p_outlet),
        (bcm.ZeroGradient(), bcm.FixedValue(p2)),
    ))
    bc_T = bcm.FieldBCs((
        (bcm.FixedValue(T1), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.FixedValue(T2)),
    ))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                              maxSc=1.0, smoothCoeff=0.1),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
        **solver_kw,
    )
    shp = mesh.shape
    _, _, _, tr2, M3 = oblique_shock(M2, theta)
    p3, T3 = p2 * pr2, T2 * tr2
    u3 = M3 * float(th.c(jnp.asarray(T3)))
    x_imp0 = Ly / math.tan(b1)
    X = np.asarray(mesh.centers[0])[:, None] * np.ones(shp)
    Y = np.asarray(mesh.centers[1])[None, :] * np.ones(shp)
    in2 = Y > Ly - X * math.tan(b1)
    in3 = Y < (X - x_imp0) * math.tan(b2 - theta)
    p0 = np.where(in3, p3, np.where(in2, p2, p1))
    T0 = np.where(in3, T3, np.where(in2, T2, T1))
    ux0 = np.where(in3, u3, np.where(in2, u2 * math.cos(theta), u1))
    uy0 = np.where(in3, 0.0, np.where(in2, -u2 * math.sin(theta), 0.0))
    state = solver.init(
        p0=jnp.asarray(p0), T0=jnp.asarray(T0),
        U0=jnp.stack([jnp.asarray(ux0), jnp.asarray(uy0)]),
        sc0=jnp.full(shp, 0.05))
    return solver, state, (u1, p1, pr1, pr2, b1, Lx, Ly)


def test_qgdflux_shock_on_patch_diverges_unlimited():
    """Document the failure mode the limiter exists for (VERDICT r4 weak
    #4): the raw lagged qgdFlux dp/dn on an outlet with the reflected
    shock standing on it blows up within a few hundred steps."""
    solver, state, _ = _reflection_solver(bcm.QGDFluxP())
    step = jax.jit(solver.make_step())
    s = common.run_steps(step, state, 300)
    bad = (not np.isfinite(np.asarray(s.rho)).all()
           or not np.isfinite(np.asarray(s.pbc[0])).all()
           or float(jnp.max(jnp.abs(s.pbc[0]))) > 1e8)
    assert bad, "expected the unlimited lagged gradient to run away"


def test_qgdflux_shock_on_patch_limited_converges():
    """With the face-local limiter (|dp/dn| clamped to 4x the interior
    |snGrad p|) + mild under-relaxation, the same config runs to a steady
    regular reflection: finite fields, bounded BC gradient, and the
    two-shock wall pressure ratio."""
    solver, state, (u1, p1, pr1, pr2, b1, Lx, Ly) = _reflection_solver(
        bcm.QGDFluxP(), qgdflux_limit=4.0, qgdflux_relax=0.5)
    step = solver.make_step()
    t_end = 1.5 * Lx / u1
    run = jax.jit(lambda s: common.run_steps(step, s, 500))
    for _ in range(30):
        state = run(state)
        if float(state.t) > t_end:
            break
    assert float(state.t) > t_end, "did not reach steady state"
    assert np.isfinite(np.asarray(state.rho)).all()
    assert np.isfinite(np.asarray(state.pbc[0])).all()
    # the BC gradient stays on the physical scale (interior snGrad-bound)
    nx = solver.mesh.shape[0]
    dx = Lx / nx
    p = np.asarray(solver.primitives(state)[3])
    max_int = np.abs(np.diff(p, axis=0)).max() / dx
    assert float(jnp.max(jnp.abs(state.pbc[0]))) <= 4.0 * max_int * 1.01
    # two-shock pressure ratio on the wall row behind the reflection
    x = np.asarray(solver.mesh.centers[0])
    x_imp = (Ly - 0.5 * Ly / solver.mesh.shape[1]) / math.tan(b1)
    probe = (x > x_imp + 0.45) & (x < Lx - 0.25)
    p3_num = p[probe, 1].mean()
    np.testing.assert_allclose(p3_num, p1 * pr1 * pr2, rtol=0.05)
