"""Public serving API: ``Engine(model, cluster, device=...).compile(graph)
.session().query()``.

Exports resolve lazily (PEP 562): core modules register their components
into ``repro_torch.api.registry`` at import time, and a lazy ``__init__``
keeps that registration free of circular imports.
"""
from repro_torch.api.registry import (ALL_REGISTRIES, COMPRESSORS,
                                      EXCHANGES, EXECUTORS, PARTITIONERS,
                                      PLACEMENTS, Registry,
                                      UnknownComponentError)

_LAZY = {
    "Engine": "repro_torch.api.engine",
    "Plan": "repro_torch.api.plan",
    "EngineConfig": "repro_torch.api.plan",
    "ModelSpec": "repro_torch.api.plan",
    "as_model": "repro_torch.api.plan",
    "Session": "repro_torch.api.session",
    "QueryResult": "repro_torch.api.session",
    "ExecutorBackend": "repro_torch.api.executors",
}

__all__ = sorted(["Registry", "UnknownComponentError", "ALL_REGISTRIES",
                  "PARTITIONERS", "PLACEMENTS", "COMPRESSORS", "EXCHANGES",
                  "EXECUTORS", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute "
                         f"{name!r}")


def __dir__():
    return __all__
