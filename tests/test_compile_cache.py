"""The persistent compile cache helper (utils.compile_cache): the
environment variable is honoured, the default is a fixed directory in the
checkout, and no module turns the cache on by being imported."""
import os
import subprocess
import sys

import jax
import pytest

from qgdsolver_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_is_honoured(monkeypatch, restore_cache_dir, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_the_fixed_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    expect = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.DEFAULT_DIR == expect
    assert compile_cache.enable() == expect
    assert jax.config.jax_compilation_cache_dir == expect
    # the same path from another working directory and another process
    out = subprocess.run(
        [sys.executable, "-c",
         "from qgdsolver_tpu.utils import compile_cache as c; "
         "print(c.DEFAULT_DIR)"],
        cwd="/", env={**os.environ, "PYTHONPATH": ROOT},
        capture_output=True, text=True, timeout=120, check=True)
    assert out.stdout.strip() == expect


def test_cache_dir_is_ignored_by_git():
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("module", [
    "qgdsolver_tpu.cli", "bench", "chip_smoke", "__graft_entry__"])
def test_not_enabled_on_import(module):
    env = {k: v for k, v in os.environ.items()
           if k != compile_cache.ENV_VAR}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c",
         f"import jax, {module}; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    assert out.stdout.strip().splitlines()[-1] == "None"
