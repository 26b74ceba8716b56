"""Physics-level validation of QGDFoam beyond shock tubes.

These are sharp structural checks in the spirit of the reference's
tutorial-validation practice (SURVEY.md §4):
  * acoustic pulse propagates at the speed of sound (energy/momentum/psi
    coupling correct);
  * an x<->y mirror-symmetric state stays mirror-symmetric (catches any
    axis-transposition bug in the per-axis flux assembly);
  * checkpoint/resume round-trips the composable state pytree,
    including the varScModel5 sensor and the lagged qgdFlux gradients.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qgdsolver_tpu.core.mesh import Mesh
from qgdsolver_tpu.core import bc as bcm
from qgdsolver_tpu.physics.thermo import PerfectGasThermo
from qgdsolver_tpu.physics.qgdcoeffs import ConstScPrModel1
from qgdsolver_tpu.solvers import common
from qgdsolver_tpu.solvers.qgd import QGDFoam


def test_acoustic_pulse_speed():
    """A small Gaussian pressure pulse splits into two fronts moving at +-c."""
    n = 256
    mesh = Mesh.uniform((n, 4), lengths=(10.0, 0.15625), dtype=np.float64)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    per = bcm.FieldBCs.uniform(bcm.Periodic(), 2)
    solver = QGDFoam(
        mesh=mesh, thermo=th, tau_model=ConstScPrModel1(alpha=0.3),
        bc_U=per, bc_p=per, bc_T=per,
        time=common.TimeControls(max_co=0.2, max_dt=1.0, dt0=1e-7),
    )
    x = np.asarray(mesh.centers[0])
    T0 = 300.0
    c0 = float(th.c(jnp.asarray(T0)))
    p0 = 1e5 * (1.0 + 1e-3 * np.exp(-((x - 5.0) / 0.3) ** 2))[:, None]
    s = solver.init(p0=jnp.asarray(np.broadcast_to(p0, mesh.shape)),
                    T0=jnp.full(mesh.shape, T0),
                    U0=jnp.zeros((2,) + mesh.shape))
    step = jax.jit(solver.make_step())
    # run to a fixed physical time ~ 2.0/c0 (pulse moves ~2 length units)
    t_target = 2.0 / c0
    while float(s.t) < t_target:
        s = common.run_steps(step, s, 50)
    U, e, T, p = solver.primitives(s)
    prof = np.asarray(p[:, 1]) - 1e5
    # two symmetric fronts at x = 5 +- c0*t
    x_right = x[np.argmax(prof * (x > 5.0))]
    x_left = x[np.argmax(prof * (x < 5.0))]
    expect = c0 * float(s.t)
    assert abs((x_right - 5.0) - expect) < 0.15, (x_right, expect)
    assert abs((5.0 - x_left) - expect) < 0.15, (x_left, expect)
    # and the sign symmetry of the split
    np.testing.assert_allclose(x_right - 5.0, 5.0 - x_left, atol=0.08)


def test_xy_mirror_symmetry():
    """State symmetric under (x<->y, ux<->uy) must remain so exactly —
    catches any transposition error between the per-axis flux assemblies."""
    n = 48
    mesh = Mesh.uniform((n, n), lengths=(1.0, 1.0), dtype=np.float64)
    th = PerfectGasThermo(R=287.0, Cp=1004.5)
    zg = bcm.FieldBCs.uniform(bcm.ZeroGradient(), 2)
    solver = QGDFoam(
        mesh=mesh, thermo=th, tau_model=ConstScPrModel1(alpha=0.5),
        bc_U=zg, bc_p=zg, bc_T=zg,
        time=common.TimeControls(max_co=0.2, max_dt=1.0, dt0=1e-7),
    )
    x = np.asarray(mesh.centers[0])[:, None]
    y = np.asarray(mesh.centers[1])[None, :]
    # diagonal-symmetric pressure bump + diagonal velocity field
    p0 = 1e5 * (1.0 + 0.2 * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02))
    ux = 30.0 * np.exp(-((x - 0.35) ** 2 + (y - 0.65) ** 2) / 0.03)
    uy = ux.T  # mirror
    s = solver.init(p0=jnp.asarray(p0), T0=jnp.full(mesh.shape, 300.0),
                    U0=jnp.stack([jnp.asarray(ux), jnp.asarray(uy)]))
    s = common.run_steps(jax.jit(solver.make_step()), s, 100)
    rho = np.asarray(s.rho)
    rux = np.asarray(s.rhoU[0])
    ruy = np.asarray(s.rhoU[1])
    rhoE = np.asarray(s.rhoE)
    assert np.isfinite(rho).all()
    np.testing.assert_allclose(rho, rho.T, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rhoE, rhoE.T, rtol=1e-12, atol=1e-10)
    np.testing.assert_allclose(rux, ruy.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["plain_2d", "varsc_2d", "varsc_3d"])
def test_state_checkpoint_roundtrip(tmp_path, case):
    """checkpoint.save/restore_latest round-trips every leaf of the state
    bitwise — the varScModel5 sensor field and the lagged qgdFlux pbc
    rows included — and a resumed run continues exactly like an
    unbroken one."""
    from qgdsolver_tpu import cases
    from qgdsolver_tpu.utils import checkpoint

    maker, shape = {
        "plain_2d": (cases.supersonic_jet, (32, 16)),
        "varsc_2d": (cases.supersonic_jet_varsc, (32, 16)),
        "varsc_3d": (cases.supersonic_jet_3d_varsc, (8, 6, 6)),
    }[case]
    solver, s = maker(shape=shape, dtype=np.float32)
    step = jax.jit(solver.make_step())
    s = common.run_steps(step, s, 5)
    if case != "plain_2d":
        assert len(s.pbc) == 1
    checkpoint.save(s, str(tmp_path), step=5)
    assert checkpoint.latest_step(str(tmp_path)) == 5
    s2 = checkpoint.restore_latest(s, str(tmp_path))[0]
    for a, b in zip(jax.tree_util.tree_leaves(s),
                    jax.tree_util.tree_leaves(s2)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    s_cont = common.run_steps(step, s2, 3)
    s_ref = common.run_steps(step, s, 3)
    for a, b in zip(jax.tree_util.tree_leaves(s_cont),
                    jax.tree_util.tree_leaves(s_ref)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
