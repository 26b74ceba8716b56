"""Test configuration: run on CPU with 8 virtual devices and float64.

Mirrors the reference's serial-oracle testing practice (SURVEY.md §4): the
multi-device sharded path is exercised on a virtual CPU mesh and compared
against the single-device result.
"""
import os

# Force CPU: the suite must run without an accelerator, fast, and with 8
# virtual devices, even where JAX_PLATFORMS names a GPU.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Set the platform through the config API too: a jax imported before this
# file (a plugin, another conftest) has already read the environment.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
