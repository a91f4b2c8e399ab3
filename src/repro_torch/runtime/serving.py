"""Deprecated Fograph serving entry points (pre-Engine API).

.. deprecated::
   ``deploy`` / ``serve_query`` / ``adapt`` are thin shims over the unified
   ``repro_torch.api`` Engine/Plan/Session pipeline and will be removed in
   a future PR. New code should use::

       from repro_torch.api import Engine
       plan = Engine((params, kind), cluster="1A+4B+1C",
                     compressor="daq").compile(graph)
       session = plan.session()
       result = session.query()          # serving
       session.adapt()                   # adaptive-scheduler tick

   See docs/api.md for the full migration table.
"""
from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.api.plan import Plan
from repro_torch.api.session import QueryResult, Session
from repro_torch.core import simulation

__all__ = ["FographService", "QueryResult", "deploy", "serve_query", "adapt"]


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.runtime.serving.{old} is deprecated; use {new} "
        "(see docs/api.md)", DeprecationWarning, stacklevel=3)


class FographService:
    """Legacy service handle — now a thin view over an api.Session.

    Keeps the old attribute surface (``cluster``, ``fogs``, ``params``,
    ``kind``, ``placement``, ``state``, ``compress``, ``exchange``) so
    existing call sites keep working while they migrate. The knobs the old
    dataclass let callers reassign between queries (``compress``,
    ``exchange``, ``state``) stay writable and take effect on the next
    ``serve_query``; ``params``/``kind`` are frozen into the compiled plan
    (re-``deploy`` to change the model).
    """

    def __init__(self, session: Session):
        self.session = session

    @property
    def plan(self) -> Plan:
        return self.session.plan

    @property
    def cluster(self) -> simulation.FogCluster:
        return self.session.plan.cluster

    @property
    def fogs(self):
        return self.session.fogs

    @property
    def params(self):
        return list(self.session.plan.model.params)

    @property
    def kind(self) -> str:
        return self.session.plan.model.kind

    @property
    def placement(self):
        return self.session.placement

    @property
    def state(self):
        return self.session.state

    @state.setter
    def state(self, value) -> None:
        self.session.state = value
        self.session._partitioned = None  # layout may have changed

    @property
    def compress(self) -> Optional[str]:
        key = self.session._compressor.name
        return None if key == "none" else key

    @compress.setter
    def compress(self, key: Optional[str]) -> None:
        from repro_torch.api.registry import COMPRESSORS
        self.session._compressor = COMPRESSORS.resolve(
            "none" if key is None else key)

    @property
    def exchange(self) -> str:
        return self.session._exchange.name

    @exchange.setter
    def exchange(self, key: str) -> None:
        from repro_torch.api.registry import EXCHANGES
        self.session._exchange = EXCHANGES.resolve(key)


def deploy(graph, params, kind: str, *, cluster_spec: str = "1A+4B+1C",
           network: str = "wifi", hidden: int = 64, seed: int = 0,
           compress: Optional[str] = "daq", strategy: str = "iep",
           exchange: str = "halo",
           sync_cost: float = simulation.DEFAULT_SYNC_COST,
           device: str = "cuda") -> FographService:
    """Deprecated: use ``repro_torch.api.Engine(...).compile(graph)
    .session()``. ``device`` is the Engine's (the CPU only when named)."""
    from repro_torch.api.engine import Engine
    _deprecated("deploy",
                "repro_torch.api.Engine(...).compile(graph).session()")
    engine = Engine((params, kind), cluster=cluster_spec, network=network,
                    placement=strategy,  # registry resolves legacy aliases
                    compressor="none" if compress is None else compress,
                    exchange=exchange, executor="sim", hidden=hidden,
                    seed=seed, sync_cost=sync_cost, device=device)
    return FographService(engine.compile(graph).session())


def serve_query(svc: FographService, *,
                distributed: bool = False) -> QueryResult:
    """Deprecated: use ``Session.query()`` (``executor="mesh-bsp"`` for the
    mesh path the old ``distributed=True`` flag selected)."""
    _deprecated("serve_query", "Session.query()")
    return svc.session.query(executor="mesh-bsp" if distributed else None)


def adapt(svc: FographService, *, lam: float = 1.3, theta: float = 0.5,
          seed: int = 0) -> str:
    """Deprecated: use ``Session.adapt()``."""
    _deprecated("adapt", "Session.adapt()")
    return svc.session.adapt(lam=lam, theta=theta, seed=seed)
