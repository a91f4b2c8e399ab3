"""String-keyed component registries for the Fograph serving pipeline.

Every pluggable stage of the paper's workflow (Fig. 5/6) resolves through
one of five registries, so scenarios are wired by *key*, not by code:

  PARTITIONERS  graph -> balanced partitions        ("bgp")
  PLACEMENTS    partitions -> fog mapping           ("iep", "metis+greedy",
                                                     "random")
  COMPRESSORS   device upload codec                 ("daq", "uniform8",
                                                     "none", ...)
  EXCHANGES     per-layer BSP cross-fog exchange    ("halo", "allgather")
  EXECUTORS     runtime backend                     ("sim", "single",
                                                     "cloud")

This module is intentionally a leaf: it imports nothing from the rest of
``repro_torch`` so that core modules can register themselves without cycles.
Implementations live next to the algorithms they wrap (``core.partition``,
``core.placement``, ``core.compression``, ``runtime.bsp``,
``api.executors``) and register at import time.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class UnknownComponentError(KeyError):
    """Raised when a registry key does not resolve; message lists the
    registry's name, every available key, and a close-match suggestion."""

    def __init__(self, kind: str, key: str, available, aliases=()):
        self.kind = kind
        self.key = key
        self.available = tuple(sorted(available))
        msg = (f"unknown {kind} {key!r}; available: "
               f"{', '.join(self.available) or '(none registered)'}")
        import difflib
        close = difflib.get_close_matches(
            key, [*self.available, *aliases], n=1, cutoff=0.6)
        if close:
            msg += f" (did you mean {close[0]!r}?)"
        super().__init__(msg)

    def __str__(self) -> str:  # KeyError.__str__ would repr() the message
        return self.args[0]


class Registry:
    """A named string -> component mapping with helpful resolution errors."""

    def __init__(self, kind: str, aliases: Optional[Dict[str, str]] = None):
        self.kind = kind
        self._entries: Dict[str, Any] = {}
        self._aliases: Dict[str, str] = dict(aliases or {})

    def register(self, key: str, value: Any = None) -> Any:
        """Register ``value`` under ``key``; usable as a decorator."""
        if value is None:
            return lambda v: self.register(key, v)
        self._entries[key] = value
        return value

    def alias(self, alias: str, target: str) -> None:
        self._aliases[alias] = target

    def canonical(self, key: str) -> str:
        return self._aliases.get(key, key)

    def resolve(self, key: Any) -> Any:
        """Resolve a registry key to its component.

        Non-string values pass through unchanged, so call sites accept
        either a key or an already-constructed component.
        """
        if not isinstance(key, str):
            return key
        k = self.canonical(key)
        if k not in self._entries:
            raise UnknownComponentError(self.kind, key, self._entries,
                                        aliases=self._aliases)
        return self._entries[k]

    def keys(self):
        return sorted(self._entries)

    def __contains__(self, key: str) -> bool:
        return isinstance(key, str) and self.canonical(key) in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __repr__(self) -> str:
        return f"Registry({self.kind!r}, keys={self.keys()})"


PARTITIONERS = Registry("partitioner")
PLACEMENTS = Registry("placement strategy",
                      aliases={"greedy": "metis+greedy",
                               "metis+random": "random"})
COMPRESSORS = Registry("compressor", aliases={"null": "none"})
EXCHANGES = Registry("exchange")
EXECUTORS = Registry("executor backend", aliases={"bsp": "mesh-bsp",
                                                  "simulate": "sim"})

ALL_REGISTRIES = {
    "partitioner": PARTITIONERS,
    "placement": PLACEMENTS,
    "compressor": COMPRESSORS,
    "exchange": EXCHANGES,
    "executor": EXECUTORS,
}
