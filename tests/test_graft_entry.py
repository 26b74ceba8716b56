"""The entry points of __graft_entry__: one step on one device, and the
multi-device dry run over both decomposition paths."""
import os
import sys

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import __graft_entry__ as graft  # noqa: E402


def test_entry_step_runs():
    step, (state,) = graft.entry()
    out = jax.jit(step)(state)
    assert out.rho.shape == state.rho.shape
    assert np.isfinite(np.asarray(out.rho)).all()


@pytest.mark.parametrize("n_devices", [4, 8])
def test_dryrun_multichip(n_devices):
    if len(jax.devices()) < n_devices:
        pytest.skip(f"needs {n_devices} virtual devices")
    graft.dryrun_multichip(n_devices)
