"""Serial vs domain-decomposed equivalence — this package's analogue of the
reference's decomposePar+mpirun-vs-serial oracle practice (SURVEY.md §4).

Runs on the 8 virtual CPU devices set up in conftest.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

from qgdsolver_tpu import cases
from qgdsolver_tpu.parallel import sharding as shd
from qgdsolver_tpu.solvers import common


def test_qgd_step_serial_vs_sharded():
    assert jax.device_count() >= 8
    solver, state = cases.supersonic_jet(shape=(32, 16), dtype=np.float64)
    step = solver.make_step()

    s_serial = state
    for _ in range(5):
        s_serial = jax.jit(step)(s_serial)

    dmesh = shd.make_device_mesh(jax.devices()[:8])  # (4, 2)
    assert dmesh.devices.shape == (4, 2)
    s_shard = shd.shard_state(state, 2, dmesh)
    sstep = shd.sharded_step(step, s_shard, 2, dmesh)
    for _ in range(5):
        s_shard = sstep(s_shard)

    for name in ("rho", "rhoU", "rhoE"):
        a = np.asarray(getattr(s_serial, name))
        b = np.asarray(getattr(s_shard, name))
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(float(s_shard.dt), float(s_serial.dt), rtol=1e-12)


def test_qhd_step_serial_vs_sharded():
    """Includes the CG pressure solve: dot-product psums must reproduce the
    serial reduction to tolerance."""
    solver, state = cases.buoyant_cavity(shape=(16, 16), dtype=np.float64)
    step = solver.make_step()

    s_serial = state
    for _ in range(3):
        s_serial = jax.jit(step)(s_serial)

    dmesh = shd.make_device_mesh(jax.devices()[:4], shape=(2, 2))
    s_shard = shd.shard_state(state, 2, dmesh)
    sstep = shd.sharded_step(step, s_shard, 2, dmesh)
    for _ in range(3):
        s_shard = sstep(s_shard)

    np.testing.assert_allclose(
        np.asarray(s_shard.U), np.asarray(s_serial.U), rtol=1e-9, atol=1e-11
    )
    np.testing.assert_allclose(
        np.asarray(s_shard.p), np.asarray(s_serial.p), rtol=1e-8, atol=1e-9
    )


def test_qgd_serial_vs_sharded_mesh_orientations():
    """VERDICT r2 item 6: pin sharded-vs-serial equivalence at BOTH 2D
    device-mesh orientations (4,2) and (2,4)."""
    solver, state = cases.supersonic_jet(shape=(32, 16), dtype=np.float64)
    step = solver.make_step()
    s_serial = state
    for _ in range(3):
        s_serial = jax.jit(step)(s_serial)
    for shape in ((4, 2), (2, 4)):
        dmesh = shd.make_device_mesh(jax.devices()[:8], shape=shape)
        s_shard = shd.shard_state(state, 2, dmesh)
        sstep = shd.sharded_step(step, s_shard, 2, dmesh)
        for _ in range(3):
            s_shard = sstep(s_shard)
        for name in ("rho", "rhoU", "rhoE"):
            np.testing.assert_allclose(
                np.asarray(getattr(s_shard, name)),
                np.asarray(getattr(s_serial, name)),
                rtol=1e-12, atol=1e-12, err_msg=f"{shape} {name}")


def test_measure_scaling_smoke():
    """The weak-scaling harness runs on the virtual CPU mesh and reports a
    positive efficiency figure (absolute value is meaningless on shared
    host cores — the field exists so BENCH can carry it)."""
    from qgdsolver_tpu.parallel import distributed as dist

    dmesh = shd.make_device_mesh(jax.devices()[:4], shape=(2, 2))

    def factory(shape):
        return cases.supersonic_jet(shape=shape, dtype=np.float32)

    rep = dist.measure_scaling(factory, dmesh, n_steps=5, repeats=1)
    assert rep["devices"] == 4
    assert rep["points_per_s_per_dev"] > 0
    assert rep["weak_scaling_efficiency"] > 0


def test_distributed_initialize_noop():
    """Single-process: initialize() must be a safe no-op returning False."""
    from qgdsolver_tpu.parallel import distributed as dist

    assert dist.initialize() is False
