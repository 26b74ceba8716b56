"""Map OpenFOAM case dictionaries onto the framework's config tree.

Mirrors the reference's startup reads (SURVEY.md §2.5):
  * system/controlDict: adjustTimeStep, maxCo, maxDeltaT, cTau, deltaT
    (setDeltaT-QGDQHD_8H:41-48);
  * system/fvSchemes `fvsc` sub-dict: per-term stencil scheme with `default`
    fallback (fvsc_8C:50-58) — leastSquares/GaussVolPoint map to the
    structured-mesh "full" vertex stencil, `reduced` to face-normal-only;
  * constant/thermophysicalProperties `QGD` sub-dict: QGDCoeffs model word +
    its coefficients + implicitDiffusion (QGDThermo_8C:54-79).
"""
from __future__ import annotations

import os

from . import foamdict
from ..core.registry import create
from ..physics import qgdcoeffs as _qgdcoeffs  # noqa: F401 — registers tau
from ..solvers.common import TimeControls

# reference scheme words -> structured-mesh stencils (SURVEY.md §7.1: both
# full reference schemes coincide with the tensor-product vertex stencil on
# rectilinear bricks)
_SCHEME_MAP = {
    "leastSquares": "full",
    "leastSquaresOpt": "full",
    "GaussVolPoint": "full",
    "reduced": "reduced",
}

# QGDCoeffs dict keys -> our tau-model constructor kwargs
_TAU_KEYS = {
    "aQGD": "alpha",
    "ScQGD": "Sc",
    "PrQGD": "Pr",
    "Tau": "tau0",
    "UQGD": "U0",
    "rC": "rC",
    "minSc": "minSc",
    "maxSc": "maxSc",
    "cqSc": "cqSc",
    "cSc1": "cSc1",
    "smoothCoeff": "smoothCoeff",
    "T0": "T0",
    "Gr": "Gr",
}


def time_controls(control_dict: dict) -> TimeControls:
    """controlDict -> TimeControls (reference setDeltaT-QGDQHD.H reads)."""
    d = control_dict
    return TimeControls(
        adjust_time_step=bool(d.get("adjustTimeStep", False)),
        max_co=float(d.get("maxCo", 0.5)),
        max_dt=float(d.get("maxDeltaT", 1.0)),
        c_tau=float(d.get("cTau", 0.75)),
        dt0=float(d.get("deltaT", 1e-6)),
    )


def fvsc_scheme(fv_schemes: dict, term: str = "default") -> str:
    """fvSchemes.fvsc lookup with `default` fallback (fvsc_8C:50-58)."""
    sub = fv_schemes.get("fvsc", {})
    word = sub.get(term, sub.get("default", "GaussVolPoint"))
    if isinstance(word, list):
        word = word[0]
    return _SCHEME_MAP.get(str(word), "full")


def fvsc_schemes(fv_schemes: dict):
    """Whole fvSchemes.fvsc sub-dict -> per-term {term: scheme} mapping with
    a `default` entry — the reference dispatches one stencil per operator
    name (fvsc_8C:47-85); solvers consume this via ops.fvsc.scheme_for."""
    sub = fv_schemes.get("fvsc", {})
    out = {}
    for term, word in sub.items():
        if isinstance(word, list):
            word = word[0]
        out[term] = _SCHEME_MAP.get(str(word), "full")
    out.setdefault("default", "full")
    return out


def tau_model(thermo_props: dict):
    """thermophysicalProperties.QGD -> tau model instance
    (QGDCoeffs::New word dispatch, QGDCoeffs_8C:58-117)."""
    qgd = thermo_props.get("QGD", {})
    name = qgd.get("QGDCoeffs", "constScPrModel1")
    if isinstance(name, list):
        name = name[0]
    kwargs = {}
    for k, v in qgd.items():
        if k in _TAU_KEYS:
            kwargs[_TAU_KEYS[k]] = float(v) if not isinstance(v, list) else float(v[-1])
    return create("tau", str(name), **kwargs)


def implicit_diffusion(thermo_props: dict) -> bool:
    """QGD.implicitDiffusion, default true (QGDThermo_8C:70-79)."""
    qgd = thermo_props.get("QGD", {})
    return bool(qgd.get("implicitDiffusion", True))


_RR = 8314.462618  # universal gas constant [J/(kmol K)], OpenFOAM's RR


def build_foam_thermo(thermo_props: dict):
    """constant/thermophysicalProperties thermoType + mixture dicts -> a
    thermo instance (the makeThermo-table dispatch, reference
    psiQGDThermos_8C/rhoQGDThermos_8C instantiations)."""
    from ..physics import thermo as tm

    tt = thermo_props.get("thermoType", {})
    word = str(tt.get("type", "hePsiQGDThermo"))
    caloric = str(tt.get("thermo", "hConst"))
    transport_word = str(tt.get("transport", "const"))
    eos_word = str(tt.get("equationOfState", "perfectGas"))
    mix = thermo_props.get("mixture", {})
    spec = mix.get("specie", {})
    thermodyn = mix.get("thermodynamics", {})
    transp = mix.get("transport", {})
    eosd = mix.get("equationOfState", {})

    W = float(spec.get("molWeight", 28.96))
    R = _RR / W
    Pr = float(transp.get("Pr", 1.0))

    if transport_word == "sutherland":
        transport = tm.SutherlandTransport(As=float(transp.get("As", 1.458e-6)),
                                           Ts=float(transp.get("Ts", 110.4)))
    elif transport_word == "polynomial" or transport_word == "powerLaw":
        transport = tm.PowerLawTransport(mu0=float(transp.get("mu0", 1.8e-5)),
                                         T0=float(transp.get("T0", 273.0)),
                                         k=float(transp.get("k", 0.7)))
    else:
        transport = tm.ConstTransport(mu0=float(transp.get("mu", 0.0)))

    if caloric == "janaf":
        lo = [float(x) for x in thermodyn.get("lowCpCoeffs", [])]
        hi = [float(x) for x in thermodyn.get("highCpCoeffs", [])]
        j = tm.JanafThermo(R=R, low=tuple(lo), high=tuple(hi),
                           Tcommon=float(thermodyn.get("Tcommon", 1000.0)))
        return tm.JanafPerfectGasThermo(janaf=j, transport=transport, Pr=Pr)

    Cp = float(thermodyn.get("Cp", 1004.5))
    if word.startswith("heRho") or word.startswith("rho"):
        if eos_word == "rhoConst":
            rho0 = float(eosd.get("rho", eosd.get("rho0", 1000.0)))
            mu0 = float(transp.get("mu", 1e-3))
            beta = float(thermo_props.get("beta",
                                          transp.get("beta", 0.0)) or 0.0)
            return tm.RhoConstThermo(rho0=rho0, Cp=Cp, mu0=mu0, Pr=Pr,
                                     beta=beta)
        eos = tm.PerfectGasEoS(R=R)
        return tm.RhoThermo(eos=eos, Cp=Cp, R=R, transport=transport, Pr=Pr)
    return tm.PerfectGasThermo(R=R, Cp=Cp, transport=transport, Pr=Pr)


def build_case(case_dir: str):
    """Full end-to-end case ingestion: blockMeshDict + system/constant dicts
    + `0/` field files -> (solver, initial state).

    The startup equivalent of a reference solver's main() preamble:
    createMesh + createFields (MUST_READ field dictionaries, e.g.
    QGDFoam_2createFields_8H orig. lines 3-35) + thermo/New RTS dispatch.
    Dispatches on controlDict `application`.
    """
    import jax.numpy as jnp
    from .foam_fields import load_block_mesh, load_initial_fields

    cfg = load_case(case_dir)
    control = cfg.get("controlDict", {})
    app = str(control.get("application", "QGDFoam"))
    mesh, patch_map, kept_axes = load_block_mesh(case_dir)
    time_name, t0 = start_time(case_dir, control)
    fields = load_initial_fields(case_dir, mesh, patch_map, kept_axes,
                                 time_name=time_name)
    if time_name != "0":
        # resume semantics: fields absent from the restart directory fall
        # back to their 0/ definitions (MUST_READ + READ_IF_PRESENT mix,
        # QGDFoam_2createFields_8H orig. 24-35)
        base = load_initial_fields(case_dir, mesh, patch_map, kept_axes)
        for k, v in base.items():
            fields.setdefault(k, v)

    if getattr(mesh, "solid", None) is not None and app not in (
            "QGDFoam", "particlesQGDFoam",
            # r4: the QHD family runs masked Helmholtz/Poisson operators
            # (linsolve fluid_mask + stairstep mirror walls)
            "QHDFoam", "SRFQHDFoam", "mulesQHDFoam"):
        raise NotImplementedError(
            "dead-cell (L-shaped multi-block) meshes are supported by the "
            "stairstep-wall QGD/QHD families only; got " + app)
    if getattr(mesh, "axisymmetric", False) and app not in (
            "QGDFoam", "rhoQGDFoam", "particlesQGDFoam", "particlesQHDFoam",
            "QHDFoam", "SRFQHDFoam", "mulesQHDFoam", "QHDDyMFoam",
            "scalarTransportQHDFoam",
            # r4: interQHDFoam carries the viscous hoop source and the
            # interface curvature's hoop part comes through the r-weighted
            # metrics (axisymmetric two-phase nozzles / liquid columns)
            "interQHDFoam"):
        # only solvers carrying the radial hoop sources may run wedges —
        # anything else would silently generate spurious radial momentum
        # against the r-weighted face areas
        raise NotImplementedError(
            f"wedge (axisymmetric) meshes are not supported by {app}")

    tc = cfg.get("time_controls", TimeControls())
    fvsc = fvsc_schemes(cfg.get("fvSchemes", {}))
    tau = cfg.get("tau_model", None)
    impl = cfg.get("implicit_diffusion", False)
    thermo = (build_foam_thermo(cfg["thermophysicalProperties"])
              if "thermophysicalProperties" in cfg else None)

    def fld(name):
        if name not in fields:
            raise ValueError(f"case {case_dir} is missing 0/{name}")
        arr, bcs = fields[name]
        return jnp.asarray(arr), bcs

    if app in ("QGDFoam", "rhoQGDFoam", "zQGDFoam"):
        from ..solvers.qgd import QGDFoam
        from ..solvers.zqgd import ZQGDFoam

        U0, bc_U = fld("U")
        p0, bc_p = fld("p")
        T0, bc_T = fld("T")
        cls = ZQGDFoam if app == "zQGDFoam" else QGDFoam
        kw = dict(mesh=mesh, thermo=thermo, bc_U=bc_U, bc_p=bc_p, bc_T=bc_T,
                  time=tc, implicit_diffusion=impl, fvsc_scheme=fvsc)
        if tau is not None:
            kw["tau_model"] = tau
        solver = cls(**kw)
        return solver, solver.init(p0=p0, T0=T0, U0=U0, t0=t0)

    if app in ("QHDFoam", "SRFQHDFoam", "mulesQHDFoam", "QHDDyMFoam"):
        from ..solvers.qhd import QHDFoam

        U0, bc_U = fld("U")
        T0, bc_T = fld("T")
        p0, bc_p = (fields["p"][0], fields["p"][1]) if "p" in fields else (None, None)
        g = _read_gravity(case_dir, kept_axes)
        # the configured QGD.implicitDiffusion (reference default true,
        # QGDThermo_8C:70-79) — r2 hardcoded True here and ignored the dict
        kw = dict(mesh=mesh, thermo=thermo, bc_U=bc_U, bc_T=bc_T, time=tc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True),
                  fvsc_scheme=fvsc)
        if bc_p is not None:
            kw["bc_p"] = bc_p
        if tau is not None:
            kw["tau_model"] = tau
        if g is not None:
            kw["g"] = g
        if app == "mulesQHDFoam":
            kw["t_equation"] = "mules"
        if app == "SRFQHDFoam":
            omega = _read_srf_omega(case_dir)
            if omega is not None:
                kw["omega"] = omega
        if app == "QHDDyMFoam":
            kw.update(_read_dynamic_mesh(case_dir, mesh.ndim))
        solver = QHDFoam(**kw)
        p_init = jnp.asarray(p0) if p0 is not None else None
        return solver, solver.init(U0=U0, T0=T0, p0=p_init, t0=t0)

    if app == "scalarTransportQHDFoam":
        from ..solvers.scalar_transport import ScalarTransportQHD

        U0, bc_U = fld("U")
        T0, bc_T = fld("T")
        kw = dict(mesh=mesh, bc_T=bc_T, time=tc)
        if tau is not None:
            kw["tau_model"] = tau
        solver = ScalarTransportQHD(**kw)
        return solver, solver.init(T0=T0, U0=U0, t0=t0)

    if app == "interQHDFoam":
        from ..solvers.inter_qhd import InterQHDFoam

        props, phase1 = _read_two_phase(cfg.get("transportProperties", {}),
                                        case_dir)
        U0, bc_U = fld("U")
        alpha_name = next(
            (n for n in (f"alpha.{phase1}", "alpha1", "alpha.water", "alpha")
             if n in fields), None)
        if alpha_name is None:
            raise ValueError(
                f"case {case_dir} has no alpha field for phase {phase1!r}")
        a0, bc_a = fields[alpha_name]
        g = _read_gravity(case_dir, kept_axes)
        kw = dict(mesh=mesh, props=props, bc_U=bc_U, bc_alpha=bc_a, time=tc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True),
                  fvsc_scheme=fvsc, alpha_field=alpha_name)
        if g is not None:
            kw["g"] = g
        if "p" in fields or "p_rgh" in fields:
            p0, bc_p = fields.get("p", fields.get("p_rgh"))
            kw["bc_p"] = bc_p
        else:
            p0 = None
        angles = _read_contact_angles(case_dir, time_name, alpha_name,
                                      patch_map)
        if angles:
            kw["contact_angles"] = angles
        solver = InterQHDFoam(**kw)
        return solver, solver.init(
            U0=U0, alpha0=jnp.asarray(a0),
            p0=jnp.asarray(p0) if p0 is not None else None, t0=t0)

    if app in ("particlesQGDFoam", "particlesQHDFoam"):
        from ..solvers.particles import (ParticlesQGDFoam, ParticlesQHDFoam,
                                         ThermoCloud)

        cloud_kw, parcels, has_parcels, _ = _read_cloud(case_dir, kept_axes)

        def _deactivate(st):
            # no injection block: the placeholder parcel is inert
            if has_parcels:
                return st
            return st._replace(
                cloud=st.cloud._replace(active=st.cloud.active * 0))

        if app == "particlesQGDFoam":
            from ..solvers.qgd import QGDFoam

            U0, bc_U = fld("U")
            p0, bc_p = fld("p")
            T0, bc_T = fld("T")
            kw = dict(mesh=mesh, thermo=thermo, bc_U=bc_U, bc_p=bc_p,
                      bc_T=bc_T, time=tc, implicit_diffusion=impl,
                      fvsc_scheme=fvsc)
            if tau is not None:
                kw["tau_model"] = tau
            cloud = ThermoCloud(two_way=True, **cloud_kw)
            solver = ParticlesQGDFoam(fluid=QGDFoam(**kw), cloud=cloud)
            return solver, _deactivate(
                solver.init(p0=p0, T0=T0, U0=U0, t0=t0, **parcels))
        from ..solvers.qhd import QHDFoam

        U0, bc_U = fld("U")
        T0, bc_T = fld("T")
        g = _read_gravity(case_dir, kept_axes)
        kw = dict(mesh=mesh, thermo=thermo, bc_U=bc_U, bc_T=bc_T, time=tc,
                  implicit_diffusion=cfg.get("implicit_diffusion", True),
                  fvsc_scheme=fvsc)
        if "p" in fields:
            kw["bc_p"] = fields["p"][1]
        if tau is not None:
            kw["tau_model"] = tau
        if g is not None:
            kw["g"] = g
        cloud = ThermoCloud(two_way=False, **cloud_kw)
        solver = ParticlesQHDFoam(fluid=QHDFoam(**kw), cloud=cloud)
        return solver, _deactivate(
            solver.init(U0=U0, T0=T0, t0=t0, **parcels))

    if app == "reactingLagrangianQGDFoam":
        from ..solvers.reacting import ReactingQGDFoam

        mix = build_reaction_thermo(cfg.get("thermophysicalProperties", {}),
                                    case_dir)
        combustion, chem_solver, tabulation = _read_chemistry(case_dir, mix)
        U0, bc_U = fld("U")
        p0, bc_p = fld("p")
        T0, bc_T = fld("T")
        Y0, bc_Y = _species_fields(fields, mix)
        kw = dict(mesh=mesh, mixture=mix, combustion=combustion,
                  chemistry_solver=chem_solver, tabulation=tabulation,
                  bc_U=bc_U, bc_p=bc_p, bc_T=bc_T, bc_Y=bc_Y, time=tc,
                  implicit_diffusion=impl, fvsc_scheme=fvsc)
        if tau is not None:
            kw["tau_model"] = tau
        fluid = ReactingQGDFoam(**kw)
        # reacting apps prefer the reacting-cloud dictionary: a case that
        # also ships a thermo-cloud file must not silently drop the
        # evaporation block (reference createClouds.H reads
        # reactingCloud1Properties for this solver)
        cloud_kw, parcels, has_parcels, cloud_props = _read_cloud(
            case_dir, kept_axes,
            names=("reactingCloud1Properties", "reactingCloudProperties",
                   "cloudProperties", "thermoCloud1Properties",
                   "thermoCloudProperties"))
        if not cloud_props:
            # no cloud dictionary: the Eulerian reacting core alone
            return fluid, fluid.init(p0=p0, T0=T0, U0=U0, Y0=Y0, t0=t0)
        # reference reactingLagrangianQGDFoam always carries the reacting
        # cloud (createClouds.H); evaporation maps onto the d^2-law
        from ..solvers.particles import (ReactingCloud,
                                         ReactingLagrangianQGDFoam)

        evap = cloud_props.get("evaporation", {})
        sp_word = str(evap.get("specie", mix.species[0].name))
        names = [sp.name for sp in mix.species]
        cloud = ReactingCloud(
            two_way=True,
            evap_specie=(names.index(sp_word) if sp_word in names else 0),
            K_evap=float(evap.get("K", 0.0)),
            latent_heat=float(evap.get("latentHeat", 0.0)),
            **cloud_kw)
        solver = ReactingLagrangianQGDFoam(fluid=fluid, cloud=cloud)
        st = solver.init(p0=p0, T0=T0, U0=U0, Y0=Y0, t0=t0, **parcels)
        if not has_parcels:
            st = st._replace(
                cloud=st.cloud._replace(active=st.cloud.active * 0))
        return solver, st

    raise ValueError(f"unsupported application {app!r}")


def start_time(case_dir: str, control: dict):
    """controlDict startFrom semantics -> (time directory name, t0).

    `latestTime` scans the case for numeric time directories and resumes
    from the largest — the reference's MUST_READ resume path
    (QGDFoam_2createFields_8H orig. 24-35; OpenFOAM Time::setTime).
    `startTime` / `firstTime` read the named start time (default 0).
    """
    mode = str(control.get("startFrom", "startTime"))
    if isinstance(mode, list):
        mode = str(mode[0])
    if mode == "latestTime":
        best = None
        for name in os.listdir(case_dir):
            if not os.path.isdir(os.path.join(case_dir, name)):
                continue
            try:
                tval = float(name)
            except ValueError:
                continue
            if best is None or tval > best[1]:
                best = (name, tval)
        if best is not None:
            return best
        return "0", 0.0
    if mode == "firstTime":
        return "0", 0.0
    t0 = float(control.get("startTime", 0.0))
    # OpenFOAM writes integral times without a trailing .0
    name = str(int(t0)) if t0 == int(t0) else repr(t0)
    return name, t0


def _read_contact_angles(case_dir: str, time_name: str, alpha_name: str,
                         patch_map) -> dict:
    """Wall contact-angle specs from the alpha field's boundaryField
    (constant/dynamicAlphaContactAngle words, degrees in the dict ->
    radians for qInterfaceProperties::correctContactAngle,
    qInterfaceProperties_8H_source.html:74-144)."""
    import math

    from ..physics.twophase import ContactAngle

    # NOTE: this re-parses the alpha field file load_initial_fields already
    # read (its BC word_map collapses contact-angle words to zeroGradient,
    # dropping the angle parameters); the duplicate parse keeps
    # parse_field_file's return shape stable for all other fields
    path = os.path.join(case_dir, time_name, alpha_name)
    if not os.path.exists(path):
        path = os.path.join(case_dir, "0", alpha_name)
        if not os.path.exists(path):
            return {}
    d = foamdict.parse_file(path)
    out = {}
    for name, entry in d.get("boundaryField", {}).items():
        if name not in patch_map or not isinstance(entry, dict):
            continue
        word = entry.get("type", "")
        if isinstance(word, list):
            word = word[0]
        if "AlphaContactAngle" not in str(word):
            continue
        rad = math.radians
        ca = ContactAngle(
            theta0=rad(float(entry.get("theta0", 90.0))),
            uTheta=float(entry.get("uTheta", 0.0)),
            thetaA=rad(float(entry.get("thetaA", 0.0))),
            thetaR=rad(float(entry.get("thetaR", 0.0))))
        for axis, side in patch_map[name][1]:
            out[(axis, side)] = ca
    return out


def _read_two_phase(transport_props: dict, case_dir: str):
    """constant/transportProperties -> (TwoPhaseProperties, phase1 name).

    Reads the interFoam-style phase pair (`phases (water air)`, per-phase
    nu/rho sub-dicts), per-phase relaxation times `tau<phase>` (reference
    constTwoPhaseProperties_8C:44-45 reads Tau1_("tau"+phase1name)), sigma,
    and the interface-compression cAlpha from fvSolution's alpha solver dict
    (interQHDFoam_8C_source.html:71-105 createFields)."""
    from ..physics.twophase import TwoPhaseProperties

    d = transport_props
    phases = d.get("phases", ["water", "air"])
    if not isinstance(phases, list):
        phases = [str(phases), "air"]
    if len(phases) < 2:
        raise ValueError(
            f"case {case_dir}: transportProperties `phases {tuple(phases)}` "
            "must name two phases (e.g. `phases (water air);`)")
    p1, p2 = str(phases[0]), str(phases[1])

    def phase(name, default_nu, default_rho):
        sub = d.get(name, {})
        nu = sub.get("nu", default_nu)
        rho = sub.get("rho", default_rho)
        # dimensionedScalar entries parse as [word, dims..., value]
        if isinstance(nu, list):
            nu = nu[-1]
        if isinstance(rho, list):
            rho = rho[-1]
        return float(nu), float(rho)

    nu1, rho1 = phase(p1, 1e-6, 1000.0)
    nu2, rho2 = phase(p2, 1.48e-5, 1.0)

    def scal(key, default):
        v = d.get(key, default)
        return float(v[-1] if isinstance(v, list) else v)

    tau1 = scal("tau" + p1, scal("Tau" + p1, 1e-5))
    tau2 = scal("tau" + p2, scal("Tau" + p2, tau1))
    sigma = scal("sigma", 0.0)

    c_alpha = 1.0
    fvsol = os.path.join(case_dir, "system", "fvSolution")
    if os.path.exists(fvsol):
        sol = foamdict.parse_file(fvsol).get("solvers", {})
        for key, sub in sol.items():
            if key.startswith("alpha") and isinstance(sub, dict) \
                    and "cAlpha" in sub:
                c_alpha = float(sub["cAlpha"])
    return TwoPhaseProperties(rho1=rho1, rho2=rho2, nu1=nu1, nu2=nu2,
                              tau1=tau1, tau2=tau2, sigma=sigma,
                              c_alpha=c_alpha), p1


def _read_cloud(case_dir: str, kept_axes,
                names=("thermoCloud1Properties", "thermoCloudProperties",
                       "cloudProperties", "reactingCloud1Properties")):
    """constant/*CloudProperties -> (ThermoCloud kwargs, initial parcels,
    has_real_parcels, raw properties dict).

    The reference's basicThermoCloud construction reads
    constant/thermoCloud1Properties (particlesQGDFoam_2createClouds_8H orig.
    1-9).  Supported content: constantProperties {rho0, Cp0} and a
    manual-injection block `initialParcels { positions ((x y z)...);
    U0 (ux uy uz); T0 ..; d0 ..; }` (the structured-framework counterpart of
    a manualInjection positionsFile).  With no injection block the parcel
    arrays hold one placeholder the caller must DEACTIVATE."""
    import numpy as np

    props = {}
    for name in names:
        p = os.path.join(case_dir, "constant", name)
        if os.path.exists(p):
            props = foamdict.parse_file(p)
            break
    const = props.get("constantProperties", {})
    kw = {}
    if "rho0" in const:
        kw["rho_p"] = float(const["rho0"])
    if "Cp0" in const:
        kw["Cp_p"] = float(const["Cp0"])

    inj = props.get("initialParcels", {})
    pos = inj.get("positions", [])
    if pos and not isinstance(pos[0], list):
        pos = [pos]
    n = max(len(pos), 1)
    if pos:
        xyz = np.asarray([[float(c) for c in q] for q in pos])
    else:
        xyz = np.zeros((1, 3))
    x_p = np.stack([xyz[:, ax] for ax in kept_axes])
    u0 = inj.get("U0", [0.0, 0.0, 0.0])
    u_p = np.stack([np.full(n, float(u0[ax])) for ax in kept_axes])
    T_p = np.full(n, float(inj.get("T0", 300.0)))
    d_p = np.full(n, float(inj.get("d0", 1e-4)))
    parcels = {"x_p": x_p, "u_p": u_p, "T_p": T_p, "d_p": d_p}
    # no injection block: the placeholder parcel must be INACTIVE, or a
    # two-way cloud would deposit phantom drag/heat into the origin cell
    return kw, parcels, bool(pos), props


def build_reaction_thermo(thermo_props: dict, case_dir: str):
    """thermophysicalProperties (psiQGDReactionThermo style) ->
    MixtureThermo: `species` word list, per-specie {specie,thermodynamics,
    transport} sub-dicts, `inertSpecie`, and the reference's `ScNumbers`
    tuple list (readScNumbers_8H orig. 1-20)."""
    from ..physics import thermo as tm
    from ..physics.species import MixtureThermo, Specie

    d = thermo_props
    names = [str(s) for s in d.get("species", [])]
    if not names:
        raise ValueError("reacting case: thermophysicalProperties has no "
                         "`species` list")
    inert = str(d.get("inertSpecie", names[-1]))

    sc_map = {}
    for pair in d.get("ScNumbers", []):
        if isinstance(pair, list) and len(pair) == 2:
            sc_map[str(pair[0])] = float(pair[1])

    mix_transport = None
    mix_pr = 0.7
    species = []
    for name in names:
        sub = d.get(name, {})
        spec = sub.get("specie", {})
        thermodyn = sub.get("thermodynamics", {})
        transp = sub.get("transport", {})
        W = float(spec.get("molWeight", 28.96))
        janaf = None
        if "highCpCoeffs" in thermodyn:
            janaf = tm.JanafThermo(
                R=_RR / W,
                low=tuple(float(x) for x in thermodyn.get("lowCpCoeffs", [])),
                high=tuple(float(x)
                           for x in thermodyn.get("highCpCoeffs", [])),
                Tcommon=float(thermodyn.get("Tcommon", 1000.0)))
        species.append(Specie(
            name=name, W=W,
            Cp=float(thermodyn.get("Cp", 1000.0)),
            hf=float(thermodyn.get("Hf", thermodyn.get("hf", 0.0))),
            janaf=janaf, Sc=sc_map.get(name, 1.0)))
        if mix_transport is None and "mu" in transp:
            mix_transport = tm.ConstTransport(mu0=float(transp["mu"]))
            mix_pr = float(transp.get("Pr", 0.7))
    if mix_transport is None:
        mix_transport = tm.ConstTransport(1.8e-5)
    return MixtureThermo(
        species=tuple(species),
        inert_index=names.index(inert) if inert in names else -1,
        transport=mix_transport, Pr=mix_pr)


def _parse_reaction_side(side: str, name_to_idx: dict):
    out = []
    for term in side.split("+"):
        term = term.strip()
        if not term:
            continue
        i = 0
        while i < len(term) and (term[i].isdigit() or term[i] == "."):
            i += 1
        coeff = float(term[:i]) if i else 1.0
        sp = term[i:].strip()
        if sp in name_to_idx:
            out.append((name_to_idx[sp], coeff))
    return tuple(out)


def _read_chemistry(case_dir: str, mix):
    """constant/chemistryProperties + constant/combustionProperties ->
    (combustion model, chemistry solver, DeviceISAT tabulation or None).

    The TDAC path (reduction + tabulation sub-dicts active) builds a
    TDACChemistrySolver, with `method ISATDevice` (or the reference's ISAT
    word on this framework's device path) yielding a DeviceISAT whose table
    rides the solver state — the runtime-selectable registration of
    BasicChemistryModelsQGD_8C_source.html:48-60."""
    from ..physics import chemistry as chem

    name_to_idx = {sp.name: i for i, sp in enumerate(mix.species)}

    reactions = []
    chem_props = {}
    p = os.path.join(case_dir, "constant", "chemistryProperties")
    if os.path.exists(p):
        chem_props = foamdict.parse_file(p)
    rxn_sources = [chem_props.get("reactions", {})]
    rp = os.path.join(case_dir, "constant", "reactions")
    if os.path.exists(rp):
        rxn_sources.append(foamdict.parse_file(rp).get("reactions", {}))
    for src in rxn_sources:
        for rname, sub in src.items():
            if not isinstance(sub, dict) or "reaction" not in sub:
                continue
            eq = sub["reaction"]
            if isinstance(eq, list):
                eq = " ".join(str(x) for x in eq)
            eq = str(eq).strip('"')
            lhs_s, _, rhs_s = eq.partition("=")
            # OpenFOAM reaction hierarchy words (the reference's
            # makeChemistryModel registrations,
            # BasicChemistryModelsQGD_8C_source.html:48-60):
            # [ir]reversibleArrheniusReaction,
            # [ir]reversibleThirdBodyArrheniusReaction; third-body
            # efficiencies from the `coeffs ((name eff) ...)` list.
            # ("M" in the equation is not a specie and parses away.)
            word = sub.get("type", "irreversibleArrheniusReaction")
            if isinstance(word, list):
                word = word[0]
            word = str(word)
            reversible = word.lower().startswith("reversible")
            third_body = "thirdbody" in word.lower()
            effs = []
            raw_eff = sub.get("coeffs", sub.get("efficiencies", []))
            if isinstance(raw_eff, list):
                pairs = (raw_eff if raw_eff
                         and isinstance(raw_eff[0], list) else [raw_eff])
                for pr in pairs:
                    if (isinstance(pr, list) and len(pr) == 2
                            and str(pr[0]) in name_to_idx):
                        effs.append((name_to_idx[str(pr[0])],
                                     float(pr[1])))
            reactions.append(chem.Reaction(
                lhs=_parse_reaction_side(lhs_s, name_to_idx),
                rhs=_parse_reaction_side(rhs_s, name_to_idx),
                A=float(sub.get("A", 1.0)),
                beta=float(sub.get("beta", 0.0)),
                Ta=float(sub.get("Ta", 0.0)),
                reversible=reversible, third_body=third_body,
                efficiencies=tuple(effs)))

    comb_word = "laminar" if reactions else "none"
    cp = os.path.join(case_dir, "constant", "combustionProperties")
    if os.path.exists(cp):
        cd = foamdict.parse_file(cp)
        w = cd.get("combustionModel", comb_word)
        if isinstance(w, list):
            w = w[0]
        comb_word = str(w).split("<")[0]
        if not bool(cd.get("active", True)):
            comb_word = "none"
    comb_kw = {}
    if comb_word in ("laminar", "PaSR", "EDC", "zoneCombustion",
                     "infinitelyFastChemistry"):
        comb_kw["reactions"] = tuple(reactions)
    try:
        combustion = create("combustion", comb_word, **comb_kw)
    except (KeyError, TypeError):
        combustion = create("combustion", comb_word)

    ctype = chem_props.get("chemistryType", {})
    solver_word = str(ctype.get("solver", "EulerImplicit"))
    method = str(ctype.get("method", "standard"))
    if not bool(chem_props.get("chemistry", True)):
        combustion = chem.NoCombustion()
    base = create("chemistrySolver",
                  solver_word if solver_word != "TDAC" else "EulerImplicit")

    tabulation = None
    solver = base
    tab_sub = chem_props.get("tabulation", {})
    red_sub = chem_props.get("reduction", {})
    if method == "TDAC" or tab_sub or red_sub:
        reduction = None
        if bool(red_sub.get("active", False)):
            targets = [str(s) for s in red_sub.get("targetSpecies",
                                                   red_sub.get("species", []))]
            tgt = tuple(name_to_idx[s] for s in targets if s in name_to_idx)
            if tgt:
                reduction = chem.DRG(
                    targets=tgt,
                    threshold=float(red_sub.get("tolerance", 0.01)))
        if bool(tab_sub.get("active", False)):
            tabulation = chem.DeviceISAT(
                tol=float(tab_sub.get("tolerance", 1e-3)))
        solver = chem.TDACChemistrySolver(base=base, reduction=reduction)
    return combustion, solver, tabulation


def _species_fields(fields: dict, mix):
    """Per-specie 0/<name> fields (Ydefault fallback) -> (Y0 stack, bc_Y
    per-specie tuple) — the reference's per-specie MUST_READ field files
    (QGDYEqn solves each specie with its own patches)."""
    import jax.numpy as jnp
    import numpy as np

    default = fields.get("Ydefault")
    arrs, bcs = [], []
    for sp in mix.species:
        if sp.name in fields:
            a, b = fields[sp.name]
        elif default is not None:
            a, b = default
        else:
            raise ValueError(f"missing 0/{sp.name} field (and no Ydefault)")
        arrs.append(np.asarray(a))
        bcs.append(b)
    return jnp.asarray(np.stack(arrs)), tuple(bcs)


def _read_dynamic_mesh(case_dir: str, ndim: int):
    """constant/dynamicMeshDict -> QHDFoam mesh-motion kwargs.

    The reference QHDDyMFoam constructs whatever dynamicFvMesh the dict
    names (QHDDyMFoam_8C_source.html:44-60); the structured-mesh design
    supports the rigid-translation / per-axis-dilation / oscillating
    subset (arbitrary per-axis 1-D face motion is the library-level
    `mesh_faces` spec):
      solver uniformVelocity;  velocity (ux uy uz);
      solver uniformDilation;  rate (rx ry rz);   // s_a(t) = 1 + r_a t
      oscillatingLinearMotionCoeffs { amplitude (ax ay az); omega w; }
        // rigid x(t) = A sin(w t): mesh_velocity = A w cos(w t)
    (velocity/rate may appear together)."""
    p = os.path.join(case_dir, "constant", "dynamicMeshDict")
    if not os.path.exists(p):
        return {}
    d = foamdict.parse_file(p)
    # accept the keys at top level or inside a coeffs sub-dict
    sub = {}
    for k, v in d.items():
        if isinstance(v, dict):
            sub.update(v)
    sub.update({k: v for k, v in d.items() if not isinstance(v, dict)})
    kw = {}
    if "amplitude" in sub and "omega" in sub:
        # OpenFOAM oscillatingLinearMotion: x(t) = amplitude*sin(omega*t)
        amp = tuple(float(x) for x in sub["amplitude"])[:ndim]
        om = float(sub["omega"])

        def mesh_velocity_osc(t, _a=amp, _w=om):
            import jax.numpy as _jnp

            c = _w * _jnp.cos(_w * t)
            return tuple(a * c for a in _a)

        kw["mesh_velocity"] = mesh_velocity_osc
    if "velocity" in sub:
        vel = tuple(float(x) for x in sub["velocity"])[:ndim]

        def mesh_velocity(t, _v=vel):
            return _v

        kw["mesh_velocity"] = mesh_velocity
    if "rate" in sub:
        rate = tuple(float(x) for x in sub["rate"])[:ndim]

        def mesh_scale(t, _r=rate):
            return tuple(1.0 + r * t for r in _r)

        kw["mesh_scale"] = mesh_scale
        if "velocity" not in sub:
            kw.setdefault("mesh_velocity", None)
    if kw:
        kw.setdefault("check_mesh_courant",
                      bool(sub.get("checkMeshCourantNo", False)))
    return kw


def _read_gravity(case_dir: str, kept_axes):
    p = os.path.join(case_dir, "constant", "g")
    if not os.path.exists(p):
        return None
    d = foamdict.parse_file(p)
    v = d.get("value", [0.0, 0.0, 0.0])
    return tuple(float(v[ax]) for ax in kept_axes)


def _read_srf_omega(case_dir: str):
    p = os.path.join(case_dir, "constant", "SRFProperties")
    if not os.path.exists(p):
        return None
    d = foamdict.parse_file(p)
    sub = d.get("rpmCoeffs", {})
    if "rpm" in sub:
        w = float(sub["rpm"]) * 2.0 * 3.141592653589793 / 60.0
        axis = d.get("axis", [0.0, 0.0, 1.0])
        return tuple(w * float(a) for a in axis)
    if "omega" in d:
        v = d["omega"]
        if isinstance(v, list):
            return tuple(float(x) for x in v)
        return (0.0, 0.0, float(v))
    return None


def load_case(case_dir: str) -> dict:
    """Read the standard case files that exist under `case_dir` and return
    {controlDict, fvSchemes, thermophysicalProperties, transportProperties,
    time_controls, fvsc, tau_model, implicit_diffusion}."""
    out = {}
    paths = {
        "controlDict": "system/controlDict",
        "fvSchemes": "system/fvSchemes",
        "thermophysicalProperties": "constant/thermophysicalProperties",
        "transportProperties": "constant/transportProperties",
        "gravitationalProperties": "constant/gravitationalProperties",
    }
    for key, rel in paths.items():
        p = os.path.join(case_dir, rel)
        if os.path.exists(p):
            out[key] = foamdict.parse_file(p)
    if "controlDict" in out:
        out["time_controls"] = time_controls(out["controlDict"])
    if "fvSchemes" in out:
        out["fvsc"] = fvsc_scheme(out["fvSchemes"])
    if "thermophysicalProperties" in out:
        out["tau_model"] = tau_model(out["thermophysicalProperties"])
        out["implicit_diffusion"] = implicit_diffusion(
            out["thermophysicalProperties"])
    return out
