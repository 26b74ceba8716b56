"""qgdsolver_tpu — a JAX regularized gas/hydro dynamics framework.

A from-scratch JAX/XLA re-design of the capabilities of
unicfdlab/QGDsolver (OpenFOAM QGD/QHD solver family) for structured block
meshes on an accelerator: face-centered fvsc operators, tau-regularized
flux assembly,
explicit acoustic-CFL time stepping (QGD) and pressure-Poisson projection
(QHD), sharded over `jax.sharding.Mesh` device grids.
"""

__version__ = "0.1.0"

from .core.mesh import Mesh  # noqa: F401
from .core import bc  # noqa: F401
