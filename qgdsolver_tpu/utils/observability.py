"""Per-step logging, timing meters and profiler hooks.

The reference's observability is Info-stream prints per step — Courant number
(QGDCourantNo_8H:52), deltaT (setDeltaT-QGDQHD_8H:60), field max/min
(QHDTEqn_8H:94, varScModel5 correct), execution time (QGDFoam_8C:160-162) —
plus scheduled field writes.  Equivalents here:
  * `StepLogger` — periodic host-side log lines with Courant/dt/max-min and a
    points/s meter (device->host sync only at the logging cadence);
  * `trace` — `jax.profiler` trace context for TensorBoard-compatible
    device profiles (replaces "no profiler hooks" in the reference);
  * `gpu_name_and_power_limit` — the card identity printed beside rates.
"""
from __future__ import annotations

import contextlib
import subprocess
import time
import typing as tp

import jax
import jax.numpy as jnp
import numpy as np


class StepLogger:
    """Log a line every `every` steps: t, dt, points/s, field ranges."""

    def __init__(self, mesh_shape, every: int = 50, fields=(), out=print):
        self.points = int(np.prod(mesh_shape))
        self.every = every
        self.fields = tuple(fields)  # names of state attrs to min/max
        self.out = out
        self._t0 = time.perf_counter()
        self._last_steps = 0

    def __call__(self, done_steps: int, state):
        now = time.perf_counter()
        dsteps = done_steps - self._last_steps
        rate = self.points * dsteps / max(now - self._t0, 1e-12)
        parts = [
            f"step={done_steps}",
            f"t={float(state.t):.6g}",
            f"deltaT={float(state.dt):.6g}",
            f"points/s={rate:.3e}",
        ]
        for name in self.fields:
            f = getattr(state, name)
            parts.append(
                f"max/min {name}: {float(jnp.max(f)):.6g}/{float(jnp.min(f)):.6g}"
            )
        self.out("  ".join(parts))
        self._t0 = now
        self._last_steps = done_steps


def gpu_name_and_power_limit() -> tp.Optional[str]:
    """The card's name and power limit as `nvidia-smi` reports them
    (first card), or None where there is no `nvidia-smi`.  A card set
    below its maximum power runs slower under load, so every rate is
    reported beside this line."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0].strip() if lines else None


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view in TensorBoard / xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def nonphysical_dump(state, fields=("rho", "rhoE"), out=print):
    """Crash-diagnostic analogue of the reference's negative-e/rho dump
    (QGDFoam_8C:142-147): report nonfinite/nonpositive field stats."""
    bad = {}
    for name in fields:
        f = np.asarray(getattr(state, name))
        n_bad = int(np.sum(~np.isfinite(f)) + np.sum(f <= 0))
        if n_bad:
            bad[name] = n_bad
    if bad:
        out(f"NONPHYSICAL STATE detected: {bad}")
    return bad
