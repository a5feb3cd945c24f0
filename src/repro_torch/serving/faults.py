"""Typed serving errors, a seeded fault-injection harness, and backoff —
a copy of ``repro/serving/faults.py`` (stdlib + numpy) for the port.

This module is the vocabulary of the robustness layer (docs/robustness.md):

* **Error taxonomy** — every failure a client can observe is a
  :class:`ServingError` with a stable ``code`` string and a ``retriable``
  flag.  The JSON-lines protocol (launch/serve.py) serializes them with
  :func:`error_payload`, so a client never has to parse prose to decide
  whether to retry.  ``BadRequest`` deliberately subclasses ``ValueError``
  as well: the pool's host-side validation raises plain ``ValueError``
  and callers that predate the taxonomy keep working.

* **Fault injection** — a :class:`FaultPlan` is a *seeded, deterministic*
  schedule of :class:`FaultEvent` s at named sites (:data:`SITES`).  The
  pool/driver call :meth:`FaultInjector.fire` at each site; the injector
  counts invocations per site and raises :class:`InjectedFault` exactly at
  the scheduled invocation indices.  Determinism is the whole point: the
  chaos tests replay the same plan against the same workload and assert
  every *surviving* session is bit-identical to the fault-free run.  Sites the pool cannot raise at (a client vanishing,
  a consumer stalling, a process being preempted) are *harness-enacted*:
  the plan still schedules them deterministically and the test enacts the
  behaviour (``events_for(site)``).

* **Backoff** — seeded full-jitter exponential backoff for retriable
  errors.  ``delay(attempt)`` is a pure function of ``(seed, attempt)``,
  so client retry schedules are reproducible in tests while still
  decorrelating real fleets (every client seeds with its own id).

Stdlib + numpy only — no torch import, so the scheduler, async driver and
launcher can all import it without cycles or device initialisation.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- error taxonomy -----------------------------------------------------------


class ServingError(Exception):
    """Base of every typed serving failure.

    ``code`` is the stable wire identifier (see docs/robustness.md for the
    catalog); ``retriable`` tells a client whether the same request can
    succeed later without modification.
    """

    code: str = "internal"
    retriable: bool = False

    def __init__(self, message: str = "", *,
                 code: Optional[str] = None,
                 retriable: Optional[bool] = None) -> None:
        super().__init__(message or self.__class__.code)
        if code is not None:
            self.code = code
        if retriable is not None:
            self.retriable = retriable


class BadRequest(ServingError, ValueError):
    """The payload itself is invalid (NaN/Inf, wrong dtype/shape, too
    long).  Never retriable: resending the same bytes fails the same way.
    Subclasses ``ValueError`` so pre-taxonomy callers catch it unchanged."""

    code = "bad_request"
    retriable = False


class AdmissionShed(ServingError):
    """The server refused admission under overload (``max_pending``
    saturated and the overload policy is ``"shed"``).  Retriable: back off
    and re-open — ideally with the same re-admission token."""

    code = "shed"
    retriable = True

    def __init__(self, message: str = "admission shed under overload", *,
                 retry_after_ms: float = 50.0) -> None:
        super().__init__(message)
        self.retry_after_ms = float(retry_after_ms)


class SessionTimeout(ServingError):
    """The idle reaper cancelled a silent session (``idle_timeout_s``).
    Retriable: the client may open a new stream and resend."""

    code = "timeout"
    retriable = True


class DriverRecovered(ServingError):
    """The driver watchdog rebuilt the pool but could not salvage this
    session (its chunk was mid-flight, or its snapshot/restore failed).
    Retriable: the server is alive again; resend the utterance."""

    code = "retriable_internal"
    retriable = True


class ProtocolError(ServingError):
    """A malformed message on the JSON-lines transport (bad JSON, unknown
    op, frames before open, oversized line...).  The ``code`` is chosen at
    raise time; never retriable — the *message* was wrong, not the state
    of the server."""

    def __init__(self, code: str, message: str) -> None:
        super().__init__(message, code=code, retriable=False)


class InjectedFault(ServingError):
    """A scheduled failure fired by the :class:`FaultInjector`.  Retriable
    by construction: the injected failure models a transient infrastructure
    fault, not a bad request."""

    code = "injected"
    retriable = True

    def __init__(self, site: str, invocation: int,
                 payload: Optional[str] = None) -> None:
        super().__init__(
            f"injected fault at site {site!r} (invocation {invocation})"
            + (f" payload={payload!r}" if payload else ""))
        self.site = site
        self.invocation = invocation
        self.payload = payload


def error_payload(exc: BaseException) -> Dict[str, Any]:
    """Serialize any exception to the wire error fields.

    ``ServingError`` carries its own code/retriable; a plain ``ValueError``
    (the pool's validation errors) maps to ``bad_request``; anything else
    is a fatal ``internal``.  The result is merged into the JSON-lines
    ``{"event": "error", ...}`` frame by launch/serve.py.
    """
    if isinstance(exc, ServingError):
        out: Dict[str, Any] = {
            "code": exc.code,
            "retriable": bool(exc.retriable),
            "message": str(exc),
        }
        retry_after = getattr(exc, "retry_after_ms", None)
        if retry_after is not None:
            out["retry_after_ms"] = retry_after
        return out
    if isinstance(exc, ValueError):
        return {"code": "bad_request", "retriable": False,
                "message": str(exc)}
    return {"code": "internal", "retriable": False,
            "message": f"{type(exc).__name__}: {exc}"}


# -- fault plans --------------------------------------------------------------

#: Named injection sites.  The first two are raised *by the pool itself*
#: (``SessionPool._fire``); the rest are harness-enacted — the chaos tests
#: read them from the plan and perform the behaviour.
SITES: Tuple[str, ...] = (
    "admission_upload",   # pool: staged H2D upload wave fails
    "dispatch",           # pool: tick/step_chunk dispatch raises
    "client_disconnect",  # harness: client vanishes mid-utterance
    "slow_consumer",      # harness: client stops draining partials
    "corrupt_frame",      # harness: payload arrives NaN-poisoned
    "preempt",            # harness: kill the pool, restore from checkpoint
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled failure: fire at the ``at``-th invocation of
    ``site`` (0-indexed, counted by the injector).  ``payload`` refines
    the behaviour (e.g. ``"poison"`` on a dispatch fault additionally
    invalidates the device state to model a crash that lost it)."""

    site: str
    at: int
    req_id: Optional[int] = None
    payload: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable schedule of fault events."""

    events: Tuple[FaultEvent, ...] = ()
    seed: Optional[int] = None

    @classmethod
    def seeded(cls, seed: int, *, n_events: int = 4,
               sites: Sequence[str] = SITES,
               max_at: int = 8) -> "FaultPlan":
        """Draw a deterministic plan: ``n_events`` events over ``sites``
        with invocation indices in ``[0, max_at)``.  Same seed, same
        plan — the contract the chaos grid is built on."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            site = sites[int(rng.integers(len(sites)))]
            events.append(FaultEvent(site=site, at=int(rng.integers(max_at))))
        return cls(events=tuple(events), seed=seed)

    def events_for(self, site: str) -> Tuple[FaultEvent, ...]:
        """The schedule for one site, ordered by invocation index —
        how the harness enacts the sites the pool cannot raise at."""
        return tuple(sorted((e for e in self.events if e.site == site),
                            key=lambda e: e.at))

    def with_events(self, *events: FaultEvent) -> "FaultPlan":
        return FaultPlan(events=self.events + tuple(events), seed=self.seed)


class FaultInjector:
    """Counts invocations per site and raises at the scheduled ones.

    Thread-safe (the pool may tick from the async server's offload
    thread).  Each event fires exactly once; ``fired`` records the events
    that actually triggered, in order, for post-hoc assertions."""

    # machine-checked lock discipline (the reference's
    # analysis/concurrency.py lints every .py under src/):
    _guarded_by_ = {"_counts": "_lock", "_pending": "_lock",
                    "fired": "_lock"}

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._pending: Dict[str, Dict[int, FaultEvent]] = {}
        for ev in plan.events:
            self._pending.setdefault(ev.site, {})[ev.at] = ev
        self.fired: List[FaultEvent] = []

    def count(self, site: str) -> int:
        with self._lock:
            return self._counts.get(site, 0)

    def fire(self, site: str) -> None:
        """Record one invocation of ``site``; raise if it is scheduled."""
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            ev = self._pending.get(site, {}).pop(n, None)
            if ev is not None:
                self.fired.append(ev)
        if ev is not None:
            raise InjectedFault(site, n, payload=ev.payload)


# -- backoff ------------------------------------------------------------------


class Backoff:
    """Seeded full-jitter exponential backoff (the AWS "full jitter"
    policy): ``delay(k) ~ Uniform(0, min(cap, base * factor**k))``.

    Deterministic per ``(seed, attempt)`` — two instances with the same
    seed produce the same schedule, so tests can pin retry timing while
    production clients decorrelate by seeding with their own id."""

    def __init__(self, *, base_s: float = 0.05, cap_s: float = 2.0,
                 factor: float = 2.0, seed: int = 0) -> None:
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.factor = float(factor)
        self.seed = int(seed)

    def ceiling(self, attempt: int) -> float:
        return min(self.cap_s, self.base_s * self.factor ** attempt)

    def delay(self, attempt: int) -> float:
        rng = np.random.default_rng((self.seed, attempt))
        return float(rng.uniform(0.0, self.ceiling(attempt)))
