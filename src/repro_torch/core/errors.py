"""Error taxonomy for the correct-by-design pipeline core.

The paper's central design principle (§3) is *fail fast*: "we should never
fail at a later moment if we could have failed at a previous one". Every
error therefore carries the ``Moment`` at which it was raised so tests can
assert the ordering property mechanically.
"""
from __future__ import annotations

import enum


class Moment(enum.IntEnum):
    """The three moments of a run's life-cycle (paper §3, Figure 1).

    Ordered: AUTHORING < CONTROL_PLANE < WORKER. A correct system surfaces
    each class of failure at the *smallest* moment able to detect it.
    """

    AUTHORING = 1      # local code environment, before a run is triggered
    CONTROL_PLANE = 2  # plan validation, before any distributed execution
    WORKER = 3         # runtime, after execution but before persisting data


class ReproError(Exception):
    """Base class for all framework errors."""

    moment: Moment = Moment.WORKER


class ContractError(ReproError):
    """A schema/contract violation (paper §3.1)."""


class ContractCompositionError(ContractError):
    """Adjacent DAG nodes do not compose (control-plane static check)."""

    moment = Moment.CONTROL_PLANE


class ContractAuthoringError(ContractError):
    """A schema is ill-formed at definition time (authoring check)."""

    moment = Moment.AUTHORING


class ContractRuntimeError(ContractError):
    """Physical data does not conform to its declared schema (worker check)."""

    moment = Moment.WORKER


class CatalogError(ReproError):
    """Versioning layer errors (paper §3.2)."""


class BranchNotFound(CatalogError):
    pass


class BranchExists(CatalogError):
    pass


class RefConflict(CatalogError):
    """Optimistic CAS on a branch head failed (concurrent writer)."""


class MergeConflict(CatalogError):
    """Both branches changed the same table since the merge base."""


class VisibilityError(CatalogError):
    """Operation violates branch visibility rules (the Fig. 4 guardrail)."""


class TransactionError(ReproError):
    """Transactional run protocol errors (paper §3.3)."""


class TransactionAborted(TransactionError):
    """The run failed; its transactional branch was preserved for debugging."""

    def __init__(self, msg: str, branch: str | None = None,
                 cause: BaseException | None = None):
        super().__init__(msg)
        self.branch = branch
        self.cause = cause


class PublicationConflict(TransactionAborted):
    """Rebase-and-revalidate publication exhausted its retry budget.

    The target branch kept moving faster than the run could rebase,
    re-verify, and CAS its merge. The run is aborted (branch preserved);
    the caller may retry the whole run against the new head.
    """


class PlanError(ReproError):
    """DAG is structurally invalid (cycle, missing input, duplicate output)."""

    moment = Moment.CONTROL_PLANE


class ExecutionError(ReproError):
    """A node failed during wave execution (DESIGN.md §8).

    Raised by the engine after the failing node's *whole wave* has
    drained: ``partial`` maps every output that validated before the
    failure (earlier waves + validated wave siblings, in plan order) to
    its snapshot key, so the runner can flush exactly the validated
    outputs to the ABORTED branch — deterministically, regardless of
    sibling timing. ``cause`` is the first failure in plan order.
    """

    moment = Moment.WORKER

    def __init__(self, msg: str, cause: BaseException | None = None,
                 partial: dict | None = None,
                 executed: tuple = (), cached: tuple = ()):
        super().__init__(msg)
        self.cause = cause
        self.partial = dict(partial or {})
        self.executed = tuple(executed)
        self.cached = tuple(cached)


class QualityError(ContractRuntimeError):
    """A data-quality verifier (expectation) failed on the worker."""
