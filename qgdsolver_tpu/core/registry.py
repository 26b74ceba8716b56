"""Model registries — this package's analogue of OpenFOAM run-time selection
tables (reference fvscStencil_8C.html:59-95, QGDCoeffs_8C.html:58-117, and the
makeThermo/makeReactionThermo instantiation tables).

Each registry maps a config word to a constructor, so config files can select
stencil schemes, tau-coefficient models, thermo combinations and BC types by
name, exactly like `fvSchemes`/`thermophysicalProperties` dictionaries do in
the reference.
"""
from __future__ import annotations

from collections import defaultdict

_REGISTRIES: dict = defaultdict(dict)


def register(kind: str, name: str):
    """Decorator: register `cls_or_fn` under (kind, name)."""

    def deco(obj):
        _REGISTRIES[kind][name] = obj
        return obj

    return deco


def create(kind: str, name: str, *args, **kwargs):
    try:
        ctor = _REGISTRIES[kind][name]
    except KeyError:
        raise KeyError(
            f"no {kind!r} registered under {name!r}; available: "
            f"{sorted(_REGISTRIES[kind])}"
        ) from None
    return ctor(*args, **kwargs)


def available(kind: str):
    return sorted(_REGISTRIES[kind])
