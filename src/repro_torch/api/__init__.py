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
    "Server": "repro_torch.api.server",
    "Request": "repro_torch.api.server",
    "Response": "repro_torch.api.server",
    "UpdateResponse": "repro_torch.api.server",
    "GraphDelta": "repro_torch.api.updates",
    "UpdateRequest": "repro_torch.api.updates",
    "UpdateReport": "repro_torch.api.updates",
    "Fleet": "repro_torch.api.fleet",
    "FleetServer": "repro_torch.api.fleet",
    "Router": "repro_torch.api.fleet",
    "Site": "repro_torch.api.fleet",
    "Fault": "repro_torch.api.faults",
    "FaultSchedule": "repro_torch.api.faults",
    "FaultInjector": "repro_torch.api.faults",
    "FailoverAudit": "repro_torch.api.faults",
    "SLOPolicy": "repro_torch.api.slo",
    "DegradationLevel": "repro_torch.api.slo",
    "AdaptiveBatchController": "repro_torch.api.slo",
    "Rejection": "repro_torch.api.slo",
    "faults": "repro_torch.api.faults",    # submodule: the module itself
    "fleet": "repro_torch.api.fleet",      # submodule: the module itself
    "traces": "repro_torch.api.traces",    # submodule: the module itself
    "updates": "repro_torch.api.updates",  # submodule: the module itself
    "slo": "repro_torch.api.slo",          # submodule: the module itself
}

__all__ = sorted(["Registry", "UnknownComponentError", "ALL_REGISTRIES",
                  "PARTITIONERS", "PLACEMENTS", "COMPRESSORS", "EXCHANGES",
                  "EXECUTORS", *_LAZY])


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(_LAZY[name])
        if _LAZY[name].rsplit(".", 1)[-1] == name:
            return module   # submodule entry (e.g. traces)
        return getattr(module, name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute "
                         f"{name!r}")


def __dir__():
    return __all__
