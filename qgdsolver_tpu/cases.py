"""Canonical case configurations — the tutorial equivalents.

The reference ships OpenFOAM tutorial cases as its validation/benchmark
vehicle (README.md papers table; BASELINE.json configs).  These builders are
this framework's counterparts: each returns (solver, initial_state).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from .core.mesh import Mesh
from .core import bc as bcm
from .physics.thermo import PerfectGasThermo, RhoConstThermo
from .physics.qgdcoeffs import ConstScPrModel1, H2bynuQHD, HbyUQHD
from .solvers import common
from .solvers.qgd import QGDFoam
from .solvers.qhd import QHDFoam
from .solvers.scalar_transport import ScalarTransportQHD


def supersonic_jet(shape=(512, 256), dtype=np.float32, mach=2.0,
                   implicit_diffusion=False, fvsc_scheme="full",
                   x_faces=None):
    """QGDFoam supersonic-jet config (BASELINE.json config #3): a Mach-`mach`
    air jet entering a quiescent domain through a slot in the left boundary.

    x_faces: optional explicit face coordinates (graded-mesh variants);
    must span the same (4.0, 2.0) box.
    """
    nx, ny = shape
    if x_faces is not None:
        mesh = Mesh(x_faces=tuple(x_faces), dtype=dtype)
    else:
        mesh = Mesh.uniform(shape, lengths=(4.0, 2.0), dtype=dtype)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_jet = mach * float(th.c(jnp.asarray(T_inf)))

    # tanh-smoothed slot profile (|y-1| < 0.15, edges smeared over ~3 cells):
    # a step profile seeds an odd-even decoupling at the inlet shear that the
    # tau-regularization cannot damp at this resolution — the smooth profile
    # is also what the reference jet tutorials prescribe physically.
    y = np.asarray(mesh.centers[1])
    delta = 3.0 * float(mesh.dx[1][0])

    def _profile(yy, xp):
        return 0.5 * (xp.tanh((0.15 - xp.abs(yy - 1.0)) / delta) + 1.0)

    jet_mask = _profile(y, np).astype(dtype)

    def inlet_u(t, coords):
        yy = coords[1]
        ux = u_jet * _profile(yy, jnp) * jnp.ones_like(yy)
        return jnp.stack(jnp.broadcast_arrays(ux, jnp.zeros_like(ux)), axis=0)

    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(inlet_u), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.ZeroGradient()),
    ))
    bc_p = bcm.FieldBCs((
        (bcm.ZeroGradient(), bcm.FixedValue(p_inf)),
        (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
    ))
    bc_T = bcm.FieldBCs((
        (bcm.FixedValue(T_inf), bcm.ZeroGradient()),
        (bcm.ZeroGradient(), bcm.ZeroGradient()),
    ))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        # explicit QGD stability: the tau-diffusion terms (nu_eff ~
        # tau*(u^2+c^2)) bind before the acoustic CFL at jet Mach 2 —
        # reference QGDFoam tutorials run maxCo ~= 0.2 for the same reason
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
        implicit_diffusion=implicit_diffusion, fvsc_scheme=fvsc_scheme,
    )
    p0 = jnp.full(mesh.shape, p_inf, dtype=dtype)
    T0 = jnp.full(mesh.shape, T_inf, dtype=dtype)
    ux0 = jnp.asarray(u_jet * jet_mask[None, :] *
                      np.exp(-np.asarray(mesh.centers[0]))[:, None], dtype=dtype)
    U0 = jnp.stack([ux0, jnp.zeros(mesh.shape, dtype=dtype)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0)


def _geom_faces(n, L, ratio, origin=0.0):
    """simpleGrading-style geometric face coordinates (total expansion
    `ratio` across the block)."""
    r = ratio ** (1.0 / max(n - 1, 1))
    w = r ** np.arange(n)
    w = w / w.sum() * L
    return origin + np.concatenate([[0.0], np.cumsum(w)])


def supersonic_jet_graded(shape=(512, 256), dtype=np.float32, mach=2.0):
    """The supersonic jet on a simpleGrading mesh (x expands 3:1 away from
    the inlet, y contracts toward the centerline then expands) — the
    graded-tutorial counterpart used by the spmd nonuniform-geometry
    weak-scaling row (VERDICT r4 next #4)."""
    nx, ny = shape
    yh = _geom_faces(ny // 2, 1.0, 2.5, origin=1.0)
    yl = 2.0 - yh[::-1]
    yf = np.concatenate([yl[:-1], yh])
    return supersonic_jet(shape=shape, dtype=dtype, mach=mach,
                          x_faces=(_geom_faces(nx, 4.0, 3.0), yf))


def wedge_blob(shape=(128, 64), dtype=np.float64):
    """QGDFoam on an axisymmetric wedge duct with an off-axis hot blob —
    exercises the r-weighted metrics + hoop sources (the wedge multi-chip
    weak-scaling row)."""
    from .core.mesh import AxisymmetricMesh

    nx, nr = shape
    mesh = AxisymmetricMesh(
        x_faces=(np.linspace(0.0, 2.0, nx + 1),
                 np.linspace(0.0, 0.5, nr + 1)),
        dtype=dtype)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bcm.FieldBCs(((bcm.ZeroGradient(), bcm.ZeroGradient()),
                           (bcm.Symmetry(), bcm.FixedValue(jnp.zeros(2))))),
        bc_p=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        bc_T=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    x = np.asarray(mesh.centers[0])[:, None] * np.ones(mesh.shape)
    r = np.asarray(mesh.centers[1])[None, :] * np.ones(mesh.shape)
    p0 = 1e5 * (1.0 + 0.2 * np.exp(-((x - 0.6) ** 2 + (r - 0.12) ** 2)
                                   / 0.02))
    state = solver.init(p0=jnp.asarray(p0, dtype=dtype),
                        T0=jnp.full(mesh.shape, 300.0, dtype=dtype),
                        U0=jnp.zeros((2,) + mesh.shape, dtype=dtype))
    return solver, state


def supersonic_jet_varsc(shape=(512, 256), dtype=np.float32, mach=2.0):
    """The shock-capturing flagship: the supersonic jet with the
    varScModel5 relaxed density-gradient sensor and the qgdFlux outflow
    pressure BC — the physically-correct QGDFoam jet configuration
    (reference jet tutorials run varSc sensors + qgdFlux patches;
    varScModel5_8C correct(), qgdFluxFvPatchScalarField_8C updateCoeffs)."""
    from .physics.qgdcoeffs import VarScModel5

    solver, state = supersonic_jet(shape=shape, dtype=dtype, mach=mach)
    bc_p = bcm.FieldBCs((
        (bcm.ZeroGradient(), bcm.QGDFluxP()),
        (bcm.FixedValue(1.0e5), bcm.FixedValue(1.0e5)),
    ))
    solver = dataclasses.replace(
        solver,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5,
                              minSc=0.05, maxSc=1.0, smoothCoeff=0.1),
        bc_p=bc_p,
    )
    s = state
    state = solver.init(
        p0=jnp.full(solver.mesh.shape, 1.0e5, dtype=dtype),
        T0=jnp.full(solver.mesh.shape, 300.0, dtype=dtype),
        U0=s.rhoU / s.rho[None],
        sc0=jnp.full(solver.mesh.shape, 0.05, dtype=dtype),
    )
    return solver, state


def buoyant_cavity(shape=(128, 128), dtype=np.float64, beta=-3e-3):
    """QHDFoam differentially-heated cavity (BASELINE.json config #2)."""
    mesh = Mesh.uniform(shape, lengths=(1.0, 1.0), dtype=dtype)
    thermo = RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-2, Pr=0.71, beta=beta)
    noslip = bcm.FieldBCs.uniform(bcm.FixedValue(jnp.zeros(2)), 2)
    bc_T = bcm.FieldBCs((
        (bcm.FixedValue(1.0), bcm.FixedValue(-1.0)),
        (bcm.ZeroGradient(), bcm.ZeroGradient()),
    ))
    solver = QHDFoam(
        mesh=mesh, thermo=thermo, tau_model=H2bynuQHD(alpha=0.3),
        g=(0.0, -9.81), bc_U=noslip, bc_T=bc_T,
        bc_p=bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2),
        time=common.TimeControls(max_co=0.3, max_dt=0.05, dt0=1e-3),
    )
    T0 = jnp.zeros(mesh.shape, dtype=dtype)
    U0 = jnp.zeros((2,) + mesh.shape, dtype=dtype)
    return solver, solver.init(U0, T0)


def scalar_box(shape=(64, 64), dtype=np.float64):
    """scalarTransportQHDFoam 2D periodic box (BASELINE.json config #1)."""
    mesh = Mesh.uniform(shape, lengths=(1.0, 1.0), dtype=dtype)
    thermo = RhoConstThermo(rho0=1.0, Cp=1000.0, mu0=1e-3, Pr=1.0)
    per = bcm.FieldBCs.uniform(bcm.Periodic(), 2)
    solver = ScalarTransportQHD(
        mesh=mesh, thermo=thermo, tau_model=HbyUQHD(alpha=0.2, U0=1.0),
        bc_T=per, bc_U=per,
        time=common.TimeControls(max_co=0.4, max_dt=0.01, dt0=1e-4),
    )
    x = np.asarray(mesh.cell_coords(0)) * np.ones(mesh.shape)
    y = np.asarray(mesh.cell_coords(1)) * np.ones(mesh.shape)
    T0 = jnp.asarray(np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.01), dtype=dtype)
    U0 = jnp.stack([jnp.ones(mesh.shape, dtype=dtype),
                    jnp.zeros(mesh.shape, dtype=dtype)])
    return solver, solver.init(T0, U0)


def supersonic_duct_3d(shape=(256, 126, 126), dtype=np.float32, mach=2.0):
    """3D QGDFoam bench/parity case: a Mach-`mach` duct flow with a hot
    low-density spherical disturbance advecting through it.  All BCs are
    scalar-valued (uniform inflow, zero-gradient outflow/walls).

    The reference's primary workload is 3D (GaussVolPointBase3D,
    GaussVolPointBase3D_8C_source.html:41-963); this is the structured
    3D counterpart of the supersonic-jet bench config.
    """
    from .solvers.qgd import QGDFoam

    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0, 2.0), dtype=dtype)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_in = mach * float(th.c(jnp.asarray(T_inf)))
    zg = bcm.ZeroGradient()
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(jnp.asarray([u_in, 0.0, 0.0], dtype=dtype)), zg),
        (zg, zg), (zg, zg)))
    bc_p = bcm.FieldBCs(((zg, bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf))))
    bc_T = bcm.FieldBCs(((bcm.FixedValue(T_inf), zg),
                         (zg, zg), (zg, zg)))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    xc = [np.asarray(c) for c in mesh.centers]
    r2 = ((xc[0][:, None, None] - 1.0) ** 2
          + (xc[1][None, :, None] - 1.0) ** 2
          + (xc[2][None, None, :] - 1.0) ** 2)
    hot = 1.0 + 0.2 * np.exp(-r2 / 0.08)
    p0 = jnp.full(mesh.shape, p_inf, dtype=dtype)
    T0 = jnp.asarray(T_inf * hot, dtype=dtype)
    U0 = jnp.stack([jnp.full(mesh.shape, u_in, dtype=dtype),
                    jnp.zeros(mesh.shape, dtype=dtype),
                    jnp.zeros(mesh.shape, dtype=dtype)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0)


def supersonic_jet_3d_varsc(shape=(256, 126, 126), dtype=np.float32,
                            mach=2.0):
    """3D FLAGSHIP shock-capturing jet: a round Mach-`mach` jet entering a
    quiescent box through a profiled slot in the x_lo plane (array-valued
    inlet BCs), varScModel5 shock sensor, qgdFlux regularizing-flux p BC
    on the outflow — the 3D counterpart of the 2D big-grid flagship
    config."""
    from .physics.qgdcoeffs import VarScModel5
    from .solvers.qgd import QGDFoam

    mesh = Mesh.uniform(shape, lengths=(4.0, 2.0, 2.0), dtype=dtype)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    p_inf, T_inf = 1.0e5, 300.0
    u_jet = mach * float(th.c(jnp.asarray(T_inf)))
    yc = np.asarray(mesh.centers[1])
    zc = np.asarray(mesh.centers[2])
    rr = np.sqrt((yc[:, None] - 1.0) ** 2 + (zc[None, :] - 1.0) ** 2)
    delta = 3.0 * float(mesh.dx[1][0])
    prof = 0.5 * (np.tanh((0.3 - rr) / delta) + 1.0)  # (ny, nz) slot
    zg = bcm.ZeroGradient()
    # value array (3, 1, ny, nz): normal-axis dim kept as 1 (core.bc spec)
    profj = jnp.asarray(prof, dtype=dtype)
    bc_U = bcm.FieldBCs((
        (bcm.FixedValue(jnp.stack([u_jet * profj, jnp.zeros_like(profj),
                                   jnp.zeros_like(profj)])[:, None]), zg),
        (zg, zg), (zg, zg)))
    bc_p = bcm.FieldBCs(((zg, bcm.QGDFluxP()),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf)),
                         (bcm.FixedValue(p_inf), bcm.FixedValue(p_inf))))
    bc_T = bcm.FieldBCs(((bcm.FixedValue(T_inf), zg),
                         (zg, zg), (zg, zg)))
    solver = QGDFoam(
        mesh=mesh, thermo=th,
        tau_model=VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                              maxSc=1.0, smoothCoeff=0.1),
        bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
        time=common.TimeControls(max_co=0.2, max_dt=1e-3, dt0=1e-7),
    )
    p0 = jnp.full(mesh.shape, p_inf, dtype=dtype)
    T0 = jnp.full(mesh.shape, T_inf, dtype=dtype)
    decay = np.exp(-np.asarray(mesh.centers[0]))[:, None, None]
    U0 = jnp.stack([jnp.asarray(u_jet * prof[None] * decay, dtype=dtype),
                    jnp.zeros(mesh.shape, dtype=dtype),
                    jnp.zeros(mesh.shape, dtype=dtype)])
    return solver, solver.init(p0=p0, T0=T0, U0=U0,
                               sc0=jnp.full(mesh.shape, 0.05, dtype=dtype))
