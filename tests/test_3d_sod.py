"""3D composable QGDFoam step against the exact Sod Riemann solution.

A quasi-1D shock tube along each axis of a 3D brick, with the constScPr
(plain) coefficients and with the varScModel5 sensor + qgdFlux outlet of
the flagship configs: physics validation of the 3D step, not just parity,
and a check that no axis of the per-axis 3D flux assembly is transposed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_qgd import _sod_exact
from qgdsolver_tpu.core import bc as bcm
from qgdsolver_tpu.core.mesh import Mesh
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1, VarScModel5
from qgdsolver_tpu.physics.thermo import PerfectGasThermo
from qgdsolver_tpu.solvers import common
from qgdsolver_tpu.solvers.qgd import QGDFoam

N = 128
T_END = 0.12


def _sod_3d(axis, tau):
    shape = [4, 4, 4]
    shape[axis] = N
    lengths = [4.0 / N] * 3
    lengths[axis] = 1.0
    mesh = Mesh.uniform(tuple(shape), lengths=tuple(lengths),
                        dtype=np.float32)
    R, gamma = 1.0, 1.4
    th = PerfectGasThermo(R=R, Cp=gamma * R / (gamma - 1))
    zg = bcm.ZeroGradient()
    sides = [(zg, zg)] * 3
    if tau == "varsc":
        p_sides = list(sides)
        p_sides[axis] = (zg, bcm.QGDFluxP())
        bc_p = bcm.FieldBCs(tuple(p_sides))
        model = VarScModel5(alpha=0.5, Pr=1.0, rC=0.5, minSc=0.05,
                            maxSc=1.0, smoothCoeff=0.1)
    else:
        bc_p = bcm.FieldBCs(tuple(sides))
        model = ConstScPrModel1(alpha=0.5, Sc=1.0, Pr=1.0)
    solver = QGDFoam(
        mesh=mesh, thermo=th, tau_model=model,
        bc_U=bcm.FieldBCs(tuple(sides)), bc_p=bc_p,
        bc_T=bcm.FieldBCs(tuple(sides)),
        time=common.TimeControls(max_co=0.3, max_dt=1e-3, dt0=1e-6),
    )
    x = np.asarray(mesh.centers[axis])
    bshape = [1, 1, 1]
    bshape[axis] = N
    left = (x < 0.5).reshape(bshape) * np.ones(mesh.shape)
    p0 = np.where(left, 1.0, 0.1)
    rho0 = np.where(left, 1.0, 0.125)
    s = solver.init(p0=jnp.asarray(p0, jnp.float32),
                    T0=jnp.asarray(p0 / (R * rho0), jnp.float32),
                    U0=jnp.zeros((3,) + mesh.shape, jnp.float32),
                    sc0=jnp.full(mesh.shape, 0.05, jnp.float32))
    return solver, s, x


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("tau", ["plain", "varsc"])
def test_sod_3d_vs_exact(axis, tau):
    """rho and u along the tube match the exact Riemann solution (the L1
    bars of the 1D Sod test, loosened for f32), the transverse axes stay
    uniform, and with varScModel5 the sensor localises at the waves."""
    solver, s, x = _sod_3d(axis, tau)
    run = jax.jit(lambda st: common.run_steps(solver.make_step(), st, 10))
    for _ in range(200):
        s = run(s)
        if float(s.t) >= T_END:
            break
    assert float(s.t) >= T_END
    rho = np.moveaxis(np.asarray(s.rho), axis, 0)
    u = np.moveaxis(np.asarray(s.rhoU[axis] / s.rho), axis, 0)
    assert np.max(np.std(rho, axis=(1, 2))) < 1e-3  # stays quasi-1D
    for b in range(3):
        if b != axis:
            assert np.max(np.abs(np.asarray(s.rhoU[b]))) < 1e-3
    rho_ex, u_ex, _ = _sod_exact(x, float(s.t))
    l1 = np.mean(np.abs(rho[:, 1, 1] - rho_ex))
    assert l1 < 0.04, f"3D Sod rho L1 error {l1}"
    assert np.mean(np.abs(u[:, 1, 1] - u_ex)) < 0.08
    if tau == "varsc":
        sc = np.moveaxis(np.asarray(s.sc), axis, 0)[:, 1, 1]
        assert sc.max() > 2.0 * 0.05  # active at the waves
        assert sc[: N // 8].mean() < 0.08  # near the floor where smooth
