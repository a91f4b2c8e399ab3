"""Diagnostics framework for the static plan/kernel/cache verifier.

Everything the analyzers emit is a :class:`Diagnostic` — one finding with a
stable check id (``"plan.halo.consistency"``), a severity, the layer it
lives in and a fix hint. Checks are plain functions registered in the
string-keyed :data:`CHECKS` registry (the same :class:`~repro_torch.api.
registry.Registry` class behind the five pipeline registries), take an
:class:`AnalysisContext` and yield diagnostics; :func:`run_checks` collects
them into a :class:`Report`.

The analyzer families (check ids keep the JAX reference's wherever the
invariant is the same; see the port's section of ``README.md``):

  plan      invariants of a compiled :class:`~repro_torch.api.plan.Plan`
            (``repro_torch.analysis.plan_checks``)
  frontier  a session's pending dirty frontier (``frontier_checks``)
  fleet     the geo-distributed serving layer (``fleet_checks``)
  fault     node-failure recovery (``fault_checks``)
  kernel    launch lint of the hand-written row kernels over the launches a
            plan implies (``kernel_lint``)
  cache     the keyed BlockCsr LRU and the layouts' device caches
            (``cache_audit``)

Everything here is host code: no check launches a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from repro_torch.api.registry import Registry

#: legal Diagnostic severities, in decreasing order of gravity.
SEVERITIES = ("error", "warning", "info")

#: legal values of the ``EngineConfig.validate`` knob.
VALIDATE_MODES = ("off", "warn", "strict")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of a static check.

    ``check_id`` is the stable dotted id of the check that produced it
    (``family.subject.property``); ``layer`` names the stack layer the
    invariant lives in ("plan", "fleet", "kernel", "cache"); ``subject``
    pinpoints the object ("halo_csr[2]", "key[3]"); ``fix_hint`` tells the
    operator what to do about it.
    """
    check_id: str
    severity: str
    message: str
    layer: str = ""
    subject: str = ""
    fix_hint: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"available: {', '.join(SEVERITIES)}")

    def format(self) -> str:
        loc = f" [{self.subject}]" if self.subject else ""
        hint = f"\n      fix: {self.fix_hint}" if self.fix_hint else ""
        return (f"{self.severity.upper():7s} {self.check_id}{loc}: "
                f"{self.message}{hint}")


def error(check_id: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(check_id, "error", message, **kw)


def warning(check_id: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(check_id, "warning", message, **kw)


def info(check_id: str, message: str, **kw) -> Diagnostic:
    return Diagnostic(check_id, "info", message, **kw)


@dataclasses.dataclass
class AnalysisContext:
    """Everything a check may inspect. ``plan`` feeds the plan, kernel and
    device-cache checks; ``block_csr_cache`` defaults to the live
    process-wide BlockCsr LRU (``kernels.ops``) and exists so tests can
    audit synthetic cache states."""
    plan: Optional[object] = None
    block_csr_cache: Optional[dict] = None
    #: pending dirty-frontier snapshot (:class:`repro_torch.core.frontier.
    #: FrontierPlan`, from ``Session.frontier_state()``) for the frontier
    #: family; None on sessions without an activation cache.
    frontier: Optional[object] = None
    #: geo-distributed fleet state for the fleet family: a
    #: :class:`repro_torch.api.fleet.FleetServer` (router + live per-site
    #: sessions; the full audit) or a bare ``Fleet`` (compiled plans only —
    #: the revision check still runs, the router/serving checks report
    #: what a bare fleet cannot violate).
    fleet: Optional[object] = None
    #: node-failure recovery state for the fault family: a
    #: :class:`repro_torch.api.faults.FailoverAudit` bundling a
    #: post-failover plan with the full-cluster plan it degraded from, the
    #: crashed node names, and optionally the live Server / the replayed
    #: FaultSchedule.
    failover: Optional[object] = None
    #: flash-attention launches to lint (``kernel_lint.FlashLaunch``, e.g.
    #: from ``kernel_lint.flash_launches(config, batch, seq)``); the
    #: attention kernel is off the GNN plan, so it is linted only when
    #: these are given.
    attention: Optional[Sequence[object]] = None
    #: representative micro-batch size for lint of the batched kernels.
    batch_probe: int = 8

    def resolved_block_csr_cache(self) -> dict:
        if self.block_csr_cache is None:
            from repro_torch.kernels import ops
            return ops._BLOCK_CSR_CACHE
        return self.block_csr_cache


#: check-id -> check function; one entry per invariant.
CHECKS = Registry("analysis check")


def register_check(check_id: str, *, family: str, layer: str,
                   requires: Tuple[str, ...] = ("plan",),
                   description: str = ""):
    """Decorator: register ``fn(ctx) -> Iterable[Diagnostic]`` under
    ``check_id``.  ``requires`` names the AnalysisContext attributes the
    check needs (it is skipped, not failed, when one is None)."""
    def wrap(fn: Callable[[AnalysisContext], Iterable[Diagnostic]]):
        fn.check_id = check_id
        fn.family = family
        fn.layer = layer
        fn.requires = tuple(requires)
        fn.description = description or (fn.__doc__ or "").strip().split(
            "\n")[0]
        CHECKS.register(check_id, fn)
        return fn
    return wrap


def checks_for(families: Optional[Sequence[str]] = None) -> List[Callable]:
    """Registered checks, optionally filtered to the given families."""
    out = []
    for cid in CHECKS:
        fn = CHECKS.resolve(cid)
        if families is None or fn.family in families:
            out.append(fn)
    return out


@dataclasses.dataclass
class Report:
    """The outcome of one verifier run: which checks ran, what they found."""
    diagnostics: List[Diagnostic] = dataclasses.field(default_factory=list)
    ran: Tuple[str, ...] = ()
    skipped: Tuple[str, ...] = ()

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def by_check(self, check_id: str) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.check_id == check_id]

    def check_ids(self) -> set:
        return {d.check_id for d in self.diagnostics}

    def format(self, verbose: bool = False) -> str:
        lines = []
        for d in self.diagnostics:
            if d.severity == "info" and not verbose:
                continue
            lines.append(d.format())
        tally = (f"{len(self.ran)} checks ran, {len(self.errors)} errors, "
                 f"{len(self.warnings)} warnings")
        if self.skipped:
            tally += f" ({len(self.skipped)} skipped: missing inputs)"
        lines.append(tally)
        return "\n".join(lines)

    def raise_if_errors(self) -> "Report":
        if self.errors:
            raise PlanValidationError(self)
        return self

    def extend(self, other: "Report") -> "Report":
        self.diagnostics.extend(other.diagnostics)
        self.ran = tuple(self.ran) + tuple(other.ran)
        self.skipped = tuple(self.skipped) + tuple(other.skipped)
        return self


class PlanValidationError(RuntimeError):
    """Raised by strict validation when any check reports an error."""

    def __init__(self, report: Report):
        self.report = report
        super().__init__(
            f"{len(report.errors)} invariant violation(s):\n"
            + "\n".join(d.format() for d in report.errors))


class PlanInvariantWarning(UserWarning):
    """Category used by warn-mode validation (targetable by filters)."""


def run_checks(ctx_or_plan, families: Optional[Sequence[str]] = None,
               checks: Optional[Sequence[str]] = None) -> Report:
    """Run registered checks against a plan or a full AnalysisContext.

    ``families`` filters by analyzer family ("plan", "frontier", "fleet",
    "fault", "kernel", "cache"); ``checks`` filters by exact check id. A
    check whose required context attributes are missing is recorded as
    skipped. A check that
    *crashes* is reported as an error on its own id — a broken verifier
    must never pass silently.
    """
    ctx = (ctx_or_plan if isinstance(ctx_or_plan, AnalysisContext)
           else AnalysisContext(plan=ctx_or_plan))
    fns = checks_for(families)
    if checks is not None:
        wanted = set(checks)
        for cid in wanted:
            CHECKS.resolve(cid)   # fail fast on unknown ids
        fns = [f for f in fns if f.check_id in wanted]
    report = Report()
    ran, skipped = [], []
    for fn in fns:
        if any(getattr(ctx, r, None) is None for r in fn.requires):
            skipped.append(fn.check_id)
            continue
        try:
            report.diagnostics.extend(fn(ctx))
        except Exception as e:  # noqa: BLE001 — verifier crash = finding
            report.diagnostics.append(error(
                fn.check_id, f"check crashed: {type(e).__name__}: {e}",
                layer=fn.layer, subject="(verifier)",
                fix_hint="fix the check in repro_torch.analysis — a "
                         "crashing verifier must not pass silently"))
        ran.append(fn.check_id)
    report.ran = tuple(ran)
    report.skipped = tuple(skipped)
    return report


def verify_plan(plan, mode: str = "strict",
                families: Sequence[str] = ("plan",)) -> Report:
    """Engine-facing entry point: run the plan invariant checks.

    ``mode="strict"`` raises :class:`PlanValidationError` on any error;
    ``mode="warn"`` emits a :class:`PlanInvariantWarning` per error/warning
    and returns; ``mode="off"`` is a no-op.  This is what
    ``EngineConfig.validate`` plumbs into ``Engine.compile`` /
    ``Engine.apply_delta`` / ``Engine.fail_nodes``.
    """
    if mode not in VALIDATE_MODES:
        raise ValueError(f"unknown validate mode {mode!r}; available: "
                         f"{', '.join(VALIDATE_MODES)}")
    if mode == "off":
        return Report()
    report = run_checks(plan, families=families)
    if mode == "strict":
        report.raise_if_errors()
    else:
        import warnings as _warnings
        for d in report.diagnostics:
            if d.severity in ("error", "warning"):
                _warnings.warn(d.format(), PlanInvariantWarning,
                               stacklevel=3)
    return report
