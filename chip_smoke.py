"""Smoke test of the QGD solver on an NVIDIA GPU, through the user's path.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards: decomposed runs only

One process holds the card(s) throughout: no phase starts a second JAX
process.  Phases on one card:

1. device — refuse unless JAX's backend is a GPU; print `nvidia-smi`'s
   name and power limit, the device kind and the device count.
2. main path — write a reference-layout OpenFOAM case directory (3D
   256x126x126 QGDFoam inflow with the varScModel5 shock sensor and a
   qgdFlux outlet), run it with `cli.run_case` for a few hundred steps
   ending in a field write, read the written time directory back through
   `io.foam_fields`, and check the physics (finite fields, positive
   internal energy, 1 < max Mach <= 3.5).  Prints steps/s, points/s and
   the device's peak bytes in use beside the card's name and power limit.
3. reference — the composable step of the 2D varScModel5 + qgdFlux jet
   (1024x512 f32, 50 steps) on the GPU and on the CPU in this process;
   rho, rhoU, rhoE and the time reached agree to REF_RTOL in relative
   L-infinity, and the compiled step holds no matrix product (so TF32
   cannot enter).

With `--four-cards` the one phase is: the 3D case through
`cli.run_case(devices="2x2")` and the 2D varsc case (1024x512) through
`devices="4x1"`, each against the same case run on one card, to
DECOMPOSED_RTOL.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; any failed check
raises, so the process exits non-zero and prints no such line.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import time

import jax
import numpy as np

from qgdsolver_tpu import cases, cli
from qgdsolver_tpu.io import foam_fields
from qgdsolver_tpu.solvers import common
from qgdsolver_tpu.utils import compile_cache, observability

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, ".chip_smoke")  # listed in .gitignore

# the gas of the written cases: air as a perfect gas
CP = 1004.5
MOL_WEIGHT = 28.96
R_GAS = 8314.47 / MOL_WEIGHT
GAMMA = CP / (CP - R_GAS)
T_INF = 300.0
P_INF = 101325.0
MACH_IN = 2.0

MAIN_CELLS = (256, 126, 126)     # the 3D flagship grid of bench.py
MAIN_LENGTHS = (4.0, 2.0, 2.0)
MAIN_STEPS = 300
MAIN_CHUNK = 100
REF_SHAPE = (1024, 512)
REF_STEPS = 50
FOUR_2D_CELLS = (1024, 512, 1)
FOUR_2D_LENGTHS = (4.0, 2.0, 0.1)

# GPU vs CPU, f32, 50 steps: the step has no matrix product, so the two
# backends differ only in summation order, FMA contraction and the last
# bits of transcendentals (~1e-7 relative per operation); 1e-4 leaves
# ~three orders of magnitude for their growth over 50 steps and no room
# for a wrong stencil, sign or boundary row (those differ at O(1e-2)).
REF_RTOL = 1e-4
# decomposed vs one card, same backend: the halo exchange copies values
# and the global dt/sensor reductions are min/max/any, which are exact,
# so the runs differ only where XLA contracts the per-shard programs
# differently (ulp-level), grown over the run.
DECOMPOSED_RTOL = 1e-4


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def require_gpu(n_devices: int = 1) -> str:
    """Refuse any backend but a GPU; return nvidia-smi's name and power
    limit line."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX backend is {backend!r}, not a "
                         "GPU; nothing was run")
    if len(jax.devices()) < n_devices:
        raise SystemExit(f"chip_smoke: {n_devices} GPUs needed, "
                         f"{len(jax.devices())} found")
    card = observability.gpu_name_and_power_limit()
    if card is None:
        raise SystemExit("chip_smoke: nvidia-smi gave no name/power limit")
    return card


def device_summary() -> dict:
    """The device as JAX reports it, for the last line."""
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def last_line(device: dict) -> str:
    return json.dumps({"ok": True, "device": device})


# ---------------------------------------------------------------------------
# the case directory
# ---------------------------------------------------------------------------

_HEADER = ("FoamFile { version 2.0; format ascii; class %s; "
           "object %s; }\n")


def write_case(case_dir: str, cells, lengths, end_time: float = 1.0,
               write_interval: int = 1_000_000) -> str:
    """Write a reference-layout QGDFoam case: a box with a Mach-2 inflow
    through the x_lo patch into gas at rest, zeroGradient walls, the
    varScModel5 shock sensor and a qgdFlux pressure outlet on x_hi.
    `cells[2] == 1` gives a 2D case (empty front and back).  Writes are
    counted in steps (`writeControl timeStep`), so with the default
    interval the run writes once, at its end."""
    nx, ny, nz = cells
    lx, ly, lz = lengths
    two_d = nz == 1
    u_in = MACH_IN * float(np.sqrt(GAMMA * R_GAS * T_INF))
    if os.path.exists(case_dir):
        shutil.rmtree(case_dir)
    for sub in ("0", "constant", "system"):
        os.makedirs(os.path.join(case_dir, sub))

    def put(rel, text):
        with open(os.path.join(case_dir, rel), "w") as f:
            f.write(text)

    walls = ["bottom", "top"] + ([] if two_d else ["back", "front"])
    faces = {"inlet": "(0 4 7 3)", "outlet": "(1 2 6 5)",
             "bottom": "(0 1 5 4)", "top": "(3 7 6 2)",
             "back": "(0 3 2 1)", "front": "(4 5 6 7)"}
    boundary = ["    inlet  { type patch; faces (%s); }" % faces["inlet"],
                "    outlet { type patch; faces (%s); }" % faces["outlet"]]
    boundary += ["    %s { type wall; faces (%s); }" % (w, faces[w])
                 for w in walls]
    if two_d:
        boundary.append("    frontAndBack { type empty; faces (%s %s); }"
                        % (faces["back"], faces["front"]))
    put("system/blockMeshDict", (
        _HEADER % ("dictionary", "blockMeshDict")
        + "convertToMeters 1;\n"
        + "vertices\n(\n"
        + "    (0 0 0) (%g 0 0) (%g %g 0) (0 %g 0)\n" % (lx, lx, ly, ly)
        + "    (0 0 %g) (%g 0 %g) (%g %g %g) (0 %g %g)\n"
        % (lz, lx, lz, lx, ly, lz, ly, lz)
        + ");\n"
        + "blocks ( hex (0 1 2 3 4 5 6 7) (%d %d %d) "
          "simpleGrading (1 1 1) );\n" % (nx, ny, nz)
        + "edges ();\nboundary\n(\n" + "\n".join(boundary) + "\n);\n"
        + "mergePatchPairs ();\n"))
    put("system/controlDict", (
        _HEADER % ("dictionary", "controlDict")
        + "application     QGDFoam;\n"
        + "startFrom       startTime;\nstartTime       0;\n"
        + "stopAt          endTime;\nendTime         %g;\n" % end_time
        + "deltaT          1e-7;\n"
        + "writeControl    timeStep;\nwriteInterval   %d;\n" % write_interval
        + "adjustTimeStep  yes;\nmaxCo           0.2;\n"
        + "maxDeltaT       1e-3;\ncTau            0.75;\n"))
    put("system/fvSchemes", (
        _HEADER % ("dictionary", "fvSchemes")
        + "fvsc { default GaussVolPoint; }\n"
        + "ddtSchemes { default Euler; }\n"
        + "gradSchemes { default Gauss linear; }\n"
        + "divSchemes { default Gauss linear; }\n"
        + "laplacianSchemes { default Gauss linear corrected; }\n"
        + "interpolationSchemes { default linear; }\n"
        + "snGradSchemes { default corrected; }\n"))
    put("constant/thermophysicalProperties", (
        _HEADER % ("dictionary", "thermophysicalProperties")
        + "thermoType\n{\n    type hePsiQGDThermo; mixture pureMixture;\n"
        + "    transport const; thermo hConst; equationOfState perfectGas;\n"
        + "    specie specie; energy sensibleInternalEnergy;\n}\n"
        + "mixture\n{\n    specie { nMoles 1; molWeight %g; }\n" % MOL_WEIGHT
        + "    thermodynamics { Cp %g; Hf 0; }\n" % CP
        + "    transport { mu 1.8e-5; Pr 0.7; }\n}\n"
        + "QGD\n{\n    implicitDiffusion false;\n"
        + "    QGDCoeffs varScModel5;\n    aQGD 0.5;\n    PrQGD 1.0;\n"
        + "    rC 0.5;\n    minSc 0.05;\n    maxSc 1.0;\n"
        + "    smoothCoeff 0.1;\n}\n"))

    def field(name, cls, dims, internal, inlet, outlet, wall):
        rows = ["    inlet  { %s }" % inlet, "    outlet { %s }" % outlet]
        rows += ["    %s { %s }" % (w, wall) for w in walls]
        if two_d:
            rows.append("    frontAndBack { type empty; }")
        put("0/" + name, (
            _HEADER % (cls, name) + "dimensions %s;\n" % dims
            + "internalField uniform %s;\n" % internal
            + "boundaryField\n{\n" + "\n".join(rows) + "\n}\n"))

    zg = "type zeroGradient;"
    field("p", "volScalarField", "[1 -1 -2 0 0 0 0]", "%g" % P_INF,
          zg, "type qgdFlux; value uniform %g;" % P_INF, zg)
    field("T", "volScalarField", "[0 0 0 1 0 0 0]", "%g" % T_INF,
          "type fixedValue; value uniform %g;" % T_INF, zg, zg)
    field("U", "volVectorField", "[0 1 -1 0 0 0 0]", "(0 0 0)",
          "type fixedValue; value uniform (%.6g 0 0);" % u_in, zg, zg)
    return case_dir


def latest_time_dir(case_dir: str) -> str:
    times = [d for d in os.listdir(case_dir)
             if d not in ("0", "system", "constant")
             and os.path.isdir(os.path.join(case_dir, d))]
    if not times:
        raise AssertionError(f"{case_dir}: no time directory written")
    return max(times, key=float)


def read_written_fields(case_dir: str) -> dict:
    """{name: array} of the latest written time directory, read back
    through io.foam_fields."""
    mesh, patch_map, kept = foam_fields.load_block_mesh(case_dir)
    fields = foam_fields.load_initial_fields(
        case_dir, mesh, patch_map, kept, time_name=latest_time_dir(case_dir))
    return {name: arr for name, (arr, _) in fields.items()}


def check_physics(fields: dict) -> dict:
    """Finite U/p/T, positive internal energy (e = Cv T), and a max Mach
    number in the jet's band (1, 3.5]."""
    for name in ("U", "p", "T"):
        if not np.isfinite(fields[name]).all():
            raise AssertionError(f"field {name} is not finite")
    e_min = float((CP - R_GAS) * fields["T"].min())
    if not e_min > 0.0:
        raise AssertionError(f"min internal energy {e_min} <= 0")
    mach = (np.sqrt(np.sum(fields["U"] ** 2, axis=0))
            / np.sqrt(GAMMA * R_GAS * fields["T"]))
    mach_max = float(mach.max())
    if not 1.0 < mach_max <= 3.5:
        raise AssertionError(f"max Mach {mach_max} outside (1, 3.5]")
    return {"e_min": e_min, "mach_max": mach_max,
            "p_min": float(fields["p"].min()),
            "p_max": float(fields["p"].max())}


def run_case_timed(case_dir: str, steps: int, chunk: int, devices=None):
    """cli.run_case with a log that stamps each chunk; returns
    (n_steps, steps/s over the chunks after the first, which holds the
    compile)."""
    stamps = []

    def log(line):
        m = re.match(r"Time = \S+\s+deltaT = \S+\s+\((\d+) steps", line)
        if m:
            stamps.append((int(m.group(1)), time.perf_counter()))
        print("  " + line, flush=True)

    n = cli.run_case(case_dir, max_steps=steps, chunk=chunk, log=log,
                     devices=devices)
    rate = float("nan")
    if len(stamps) >= 2:
        (n0, t0), (n1, t1) = stamps[0], stamps[-1]
        rate = (n1 - n0) / (t1 - t0)
    return n, rate


def main_path(card: str, cells=MAIN_CELLS, lengths=MAIN_LENGTHS,
              steps=MAIN_STEPS, chunk=MAIN_CHUNK) -> dict:
    case = write_case(os.path.join(WORK_DIR, "main_path"), cells, lengths)
    t0 = time.perf_counter()
    n, rate = run_case_timed(case, steps, chunk)
    wall = time.perf_counter() - t0
    if n != steps:
        raise AssertionError(f"run_case ran {n} steps, expected {steps}")
    if not rate > 0.0:
        raise AssertionError("no chunk after the first was timed")
    phys = check_physics(read_written_fields(case))
    points = int(np.prod([c for c in cells if c > 1]))
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"main path: {n} steps of {cells} varScModel5+qgdFlux through "
          f"cli.run_case in {wall:.1f} s (compile and write included); "
          f"written time {latest_time_dir(case)}", flush=True)
    print(f"main path: {rate:.6g} steps/s, {rate * points:.6g} points/s, "
          f"peak_bytes_in_use {peak} ({card})", flush=True)
    print("main path: physics " + json.dumps(phys), flush=True)
    return {"steps_per_s": rate, "points_per_s": rate * points,
            "peak_bytes_in_use": peak, **phys}


# ---------------------------------------------------------------------------
# GPU against the plain reference (the same step on the CPU)
# ---------------------------------------------------------------------------


def rel_linf(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


def _run_on(device, shape, n_steps):
    with jax.default_device(device):
        solver, state = cases.supersonic_jet_varsc(shape=shape,
                                                   dtype=np.float32)
        step = solver.make_step()
        out = jax.jit(lambda s: common.run_steps(step, s, n_steps))(state)
        out = jax.block_until_ready(out)
        hlo = jax.jit(step).lower(state).compile().as_text()
    return out, hlo


def has_matrix_product(hlo_text: str) -> bool:
    """True if a compiled HLO module holds a dot or a BLAS call."""
    return bool(re.search(r"\bdot\(|dot_general|cublas|gemm", hlo_text))


def compare_devices(dev_test, dev_ref, shape=REF_SHAPE, n_steps=REF_STEPS):
    """The composable step run on `dev_test` and on `dev_ref` from the same
    initial state: relative L-infinity of rho, rhoU, rhoE, and whether
    the step compiled for `dev_test` holds a matrix product."""
    out_t, hlo_t = _run_on(dev_test, shape, n_steps)
    out_r, _ = _run_on(dev_ref, shape, n_steps)
    # t is the sum of the adaptive dt chain: a check on the dt reduction
    errs = {name: rel_linf(getattr(out_r, name), getattr(out_t, name))
            for name in ("rho", "rhoU", "rhoE", "t")}
    return {"rel_linf": errs, "t": float(out_t.t), "t_ref": float(out_r.t),
            "matrix_product": has_matrix_product(hlo_t)}


def reference_phase(card: str, shape=REF_SHAPE, n_steps=REF_STEPS) -> dict:
    r = compare_devices(jax.devices()[0], jax.devices("cpu")[0], shape,
                        n_steps)
    print(f"reference: {shape} varsc jet, {n_steps} steps, GPU vs CPU "
          f"relative L-inf {json.dumps(r['rel_linf'])} (tolerance "
          f"{REF_RTOL}); matrix product in the compiled step: "
          f"{r['matrix_product']} ({card})", flush=True)
    if r["matrix_product"]:
        raise AssertionError("the compiled step holds a matrix product")
    bad = {k: v for k, v in r["rel_linf"].items() if not v <= REF_RTOL}
    if bad:
        raise AssertionError(f"GPU differs from the CPU reference: {bad}")
    return r


# ---------------------------------------------------------------------------
# four cards: the decomposePar + mpirun path against one card
# ---------------------------------------------------------------------------


def decomposed_vs_single(name, cells, lengths, devices, steps, chunk):
    """Run one case on one device and decomposed over `devices`; return
    the relative L-infinity of the written U, p, T and the two rates."""
    single = write_case(os.path.join(WORK_DIR, name + "_single"), cells,
                        lengths)
    split = write_case(os.path.join(WORK_DIR, name + "_" + devices), cells,
                       lengths)
    _, rate1 = run_case_timed(single, steps, chunk)
    _, rate_n = run_case_timed(split, steps, chunk, devices=devices)
    f1, fn = read_written_fields(single), read_written_fields(split)
    errs = {k: rel_linf(f1[k], fn[k]) for k in ("U", "p", "T")}
    check_physics(fn)
    return {"rel_linf": errs, "steps_per_s_1": rate1,
            "steps_per_s_n": rate_n}


def four_card_phase(card: str, cells3=MAIN_CELLS, lengths3=MAIN_LENGTHS,
                    cells2=FOUR_2D_CELLS, lengths2=FOUR_2D_LENGTHS,
                    steps=MAIN_STEPS, chunk=MAIN_CHUNK) -> dict:
    out = {}
    for name, cells, lengths, devices in (
            ("flagship3d", cells3, lengths3, "2x2"),
            ("flagship2d", cells2, lengths2, "4x1")):
        r = decomposed_vs_single(name, cells, lengths, devices, steps, chunk)
        print(f"four cards: {name} {cells} devices={devices} vs one card: "
              f"relative L-inf {json.dumps(r['rel_linf'])} (tolerance "
              f"{DECOMPOSED_RTOL}); {r['steps_per_s_1']:.6g} steps/s on "
              f"one card, {r['steps_per_s_n']:.6g} on {devices} ({card})",
              flush=True)
        bad = {k: v for k, v in r["rel_linf"].items()
               if not v <= DECOMPOSED_RTOL}
        if bad:
            raise AssertionError(f"{name}: decomposed run differs: {bad}")
        out[name] = r
    return out


# ---------------------------------------------------------------------------


def phases(four_cards: bool):
    """The phases one invocation runs, after the device check."""
    if four_cards:
        return [four_card_phase]
    return [main_path, reference_phase]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card decomposition phase")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    n_devices = 4 if args.four_cards else 1
    card = require_gpu(n_devices)
    print(card, flush=True)
    dev = device_summary()
    print(f"device: {dev['kind']} x{dev['count']} "
          f"(platform {dev['platform']})", flush=True)
    print(f"compile cache: {compile_cache.enable()}", flush=True)
    for phase in phases(args.four_cards):
        phase(card)
    print(last_line(dev), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
