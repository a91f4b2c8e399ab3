"""Deterministic chaos injection for node-level fault tolerance.

A :class:`FaultSchedule` is a time-sorted list of typed :class:`Fault`
events replayed against the ``Server``'s *simulated* clock — the same
clock that prices batches and updates — so every chaos run is exactly
reproducible: same schedule + same trace = same responses, bit for bit.

Fault kinds and the recovery tier that handles each:

  ``halo_loss``   transient loss of ``losses`` consecutive halo-exchange
                  rounds. Tier 1: retry with exponential backoff, priced
                  by ``simulation.simulate_retry`` through the exchange's
                  retry knobs (``ExchangeSpec.recovery_cost``) and
                  reported as ``breakdown["recovery"]``. When the retry
                  budget/timeout is exhausted, tier 2 rides through on
                  the stale halo store (``staleness_bound``); with no
                  stale capacity either, tier 3 fails the node over.
  ``straggler``   the node runs ``slowdown`` x slower for ``duration``
                  seconds (modeled as extra ``background_load``, so the
                  analytic clock prices it through the node's effective
                  capability). Numerics are unaffected.
  ``crash``       tier 3: the node's shards are re-placed onto the
                  survivors (``Engine.fail_nodes``, the
                  ``repair_assignment`` machinery) and the session
                  rebases onto the degraded-capacity failover plan.
                  In-flight requests are served on the new plan — zero
                  drops by construction, mirroring the fleet invariant.
  ``recover``     the node rejoins: a crashed node's cluster is restored
                  (recompiling if the graph moved while degraded), a
                  straggler's extra load is lifted.

The :class:`FaultInjector` is the tiny runtime cursor the ``Server``
advances batch by batch; :class:`FailoverAudit` packages a failover for
the ``analysis`` fault-check family.

Host code only, a copy of the JAX reference's ``api/faults.py``: the same
seed gives the same schedule in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

#: legal Fault.kind values.
KINDS = ("crash", "recover", "halo_loss", "straggler")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One typed chaos event on the simulated clock.

    ``node`` names the target fog node (``SimNode.name``, e.g.
    ``"fog1(B)"``); required for every kind except ``halo_loss``, where
    None models an unattributed transient loss (tier 1/2 only — there
    is nothing to fail over). ``duration``/``slowdown`` apply to
    stragglers, ``losses`` to halo losses.
    """
    time: float
    kind: str
    node: Optional[str] = None
    duration: float = 0.0
    slowdown: float = 1.0
    losses: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"available: {', '.join(KINDS)}")
        if self.time < 0:
            raise ValueError(f"fault time must be >= 0, got {self.time}")
        if self.kind in ("crash", "recover", "straggler") and not self.node:
            raise ValueError(f"{self.kind!r} fault needs a node name")
        if self.kind == "straggler":
            if self.slowdown < 1.0:
                raise ValueError(f"straggler slowdown must be >= 1, "
                                 f"got {self.slowdown}")
            if self.duration <= 0:
                raise ValueError(f"straggler duration must be > 0, "
                                 f"got {self.duration}")
        if self.kind == "halo_loss" and self.losses < 1:
            raise ValueError(f"halo_loss losses must be >= 1, "
                             f"got {self.losses}")


class FaultSchedule:
    """An immutable, time-sorted sequence of :class:`Fault` events.

    Events at equal times keep their construction order (stable sort),
    so a schedule is a total order — the injector consumes it exactly
    once per run regardless of batch boundaries.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        for f in faults:
            if not isinstance(f, Fault):
                raise TypeError(f"FaultSchedule takes Fault events, got "
                                f"{type(f).__name__}")
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: f.time))

    @classmethod
    def random(cls, nodes: Sequence[str], *, horizon: float,
               crash_rate: float = 0.0, loss_rate: float = 0.0,
               straggler_rate: float = 0.0, mean_outage: float = 1.0,
               mean_slowdown: float = 2.0, max_losses: int = 6,
               seed: int = 0) -> "FaultSchedule":
        """Seeded Poisson chaos over ``[0, horizon)``.

        Rates are events per simulated second. Each crash is paired with
        a ``recover`` ~``mean_outage`` later; crashes never take the last
        surviving node down (the generator tracks who is up). Same seed,
        nodes and rates -> the identical schedule, always.
        """
        if horizon <= 0:
            raise ValueError(f"horizon must be > 0, got {horizon}")
        nodes = list(nodes)
        if not nodes:
            raise ValueError("FaultSchedule.random needs node names")
        rng = np.random.default_rng(seed)
        events: List[Fault] = []
        for t in np.sort(rng.uniform(0, horizon,
                                     rng.poisson(loss_rate * horizon))):
            events.append(Fault(float(t), "halo_loss",
                                node=str(rng.choice(nodes)),
                                losses=int(rng.integers(1, max_losses + 1))))
        for t in np.sort(rng.uniform(0, horizon,
                                     rng.poisson(straggler_rate * horizon))):
            events.append(Fault(
                float(t), "straggler", node=str(rng.choice(nodes)),
                duration=float(rng.exponential(mean_outage) + 1e-3),
                slowdown=float(1.0 + rng.exponential(mean_slowdown - 1.0))))
        down_until: dict = {}
        for t in np.sort(rng.uniform(0, horizon,
                                     rng.poisson(crash_rate * horizon))):
            up = [n for n in nodes if down_until.get(n, -1.0) <= float(t)]
            if len(up) <= 1:
                continue   # never crash the last survivor
            victim = str(rng.choice(up))
            outage = float(rng.exponential(mean_outage) + 1e-3)
            events.append(Fault(float(t), "crash", node=victim))
            events.append(Fault(float(t) + outage, "recover", node=victim))
            down_until[victim] = float(t) + outage
        return cls(events)

    def window(self, t0: float, t1: float) -> Tuple[Fault, ...]:
        """Events with ``t0 <= time < t1``."""
        return tuple(f for f in self.faults if t0 <= f.time < t1)

    @property
    def node_names(self) -> Tuple[str, ...]:
        return tuple(sorted({f.node for f in self.faults
                             if f.node is not None}))

    def counts(self) -> dict:
        out = {k: 0 for k in KINDS}
        for f in self.faults:
            out[f.kind] += 1
        return out

    def __iter__(self) -> Iterator[Fault]:
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __getitem__(self, i):
        return self.faults[i]

    def __repr__(self) -> str:
        c = self.counts()
        parts = ", ".join(f"{k}={v}" for k, v in c.items() if v)
        return f"FaultSchedule({len(self.faults)} events: {parts or 'none'})"


class FaultInjector:
    """Runtime cursor over one :class:`FaultSchedule`.

    The ``Server`` calls :meth:`due` with the simulated time of the next
    service instant; events fire exactly once, in schedule order. The
    injector holds no recovery state — that lives in the server, which
    owns the clock and the session.
    """

    def __init__(self, schedule: FaultSchedule):
        if not isinstance(schedule, FaultSchedule):
            schedule = FaultSchedule(schedule)
        self.schedule = schedule
        self._i = 0

    def due(self, t: float) -> List[Fault]:
        """Consume and return every unfired event with ``time <= t``."""
        out: List[Fault] = []
        while (self._i < len(self.schedule)
               and self.schedule[self._i].time <= t + 1e-12):
            out.append(self.schedule[self._i])
            self._i += 1
        return out

    def flush(self) -> List[Fault]:
        """Consume every remaining event (end-of-trace fire)."""
        out = list(self.schedule[self._i:])
        self._i = len(self.schedule)
        return out

    @property
    def remaining(self) -> int:
        return len(self.schedule) - self._i

    def __repr__(self) -> str:
        return (f"FaultInjector({self._i}/{len(self.schedule)} fired, "
                f"{self.schedule!r})")


@dataclasses.dataclass(frozen=True)
class FailoverAudit:
    """Input bundle for the ``analysis`` fault-check family.

    ``plan`` is the failover (or candidate) plan under audit;
    ``base_plan`` the pre-crash plan it was derived from and ``crashed``
    the evicted node names (both optional — coverage degrades to what
    can still be checked); ``server`` a fault-aware ``Server`` whose
    halo-store/session agreement is audited; ``schedule`` a
    :class:`FaultSchedule` for the retry-budget/well-formedness check.
    """
    plan: object
    base_plan: Optional[object] = None
    crashed: Tuple[str, ...] = ()
    server: Optional[object] = None
    schedule: Optional[FaultSchedule] = None
