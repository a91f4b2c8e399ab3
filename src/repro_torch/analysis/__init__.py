"""repro_torch.analysis — static plan/kernel/cache verifier of the port.

Audits compiled :class:`~repro_torch.api.plan.Plan` objects, the row-kernel
launches they imply and the port's keyed device caches *without launching
anything*. Six analyzer families (check ids keep the JAX reference's
wherever the invariant is the same; the catalogue with the reference
check each stands for is in the port's section of ``README.md``):

  plan      partition coverage/disjointness, halo consistency, ELL padding,
            capacity skew, post-update layout agreement, knob resolution
  frontier  dirty-frontier closure soundness + cache-revision agreement of
            a session's pending incremental state
  fleet     geo-fleet router coverage, cross-tier graph-revision agreement,
            staleness_bound consistency of the stale-tolerant exchange
  fault     node-failure recovery: failover-plan eviction/coverage (and
            the cluster_spec=None pricing invariant), stale-halo layout
            agreement, retry-budget reachability + schedule well-formedness
  kernel    launch lint of the hand-written row kernels (grid limit, the
            split CTA's shared memory, TileRows bounds, column-block
            bounds, the DAQ wire's dtypes) and of flash attention's
            shared memory
  cache     BlockCsr LRU key completeness; device-cache keys and staleness
            of a plan's layout

The reference's ``hlo`` family reads XLA's compiled text, which a torch
program does not have; the port has no counterpart.

Entry points::

    from repro_torch.analysis import run_checks, verify_plan
    report = run_checks(plan)                  # plan+kernel+cache families
    verify_plan(plan, mode="strict")           # what EngineConfig.validate
                                               # plumbs into Engine.compile
    python -m repro_torch.analysis --demo --strict   # registry sweep
"""
from repro_torch.analysis.diagnostics import (AnalysisContext, CHECKS,
                                              Diagnostic,
                                              PlanInvariantWarning,
                                              PlanValidationError, Report,
                                              SEVERITIES, VALIDATE_MODES,
                                              checks_for, register_check,
                                              run_checks, verify_plan)

# Importing the check modules registers every check in CHECKS.
from repro_torch.analysis import cache_audit      # noqa: E402,F401
from repro_torch.analysis import fault_checks     # noqa: E402,F401
from repro_torch.analysis import fleet_checks     # noqa: E402,F401
from repro_torch.analysis import frontier_checks  # noqa: E402,F401
from repro_torch.analysis import kernel_lint      # noqa: E402,F401
from repro_torch.analysis import plan_checks      # noqa: E402,F401

__all__ = [
    "AnalysisContext", "CHECKS", "Diagnostic", "PlanInvariantWarning",
    "PlanValidationError", "Report", "SEVERITIES", "VALIDATE_MODES",
    "cache_audit", "checks_for", "fault_checks", "fleet_checks",
    "frontier_checks", "kernel_lint", "plan_checks", "register_check",
    "run_checks", "verify_plan",
]
