"""Runtime lock-order recorder — a copy of ``repro/analysis/lockorder.py``
(stdlib only) for the port, so ``repro_torch`` never imports the JAX
package.  The reference's static half (``repro.analysis.concurrency``)
lints the port's ``_guarded_by_`` tables too.

The serving stack holds a small family of locks — ``SessionPool._state_lock``
guarding the pool's device state, the metrics-registry lock shared by
every counter/gauge/histogram, the time-series and tracer ring locks, the
checkpoint manager's commit lock.  Each is individually correct; what no
single call site can see is the *order* they nest in across threads.  Two
threads that ever acquire the same two locks in opposite orders can
deadlock — a class of bug that survives any number of green test runs
until the interleaving finally lands.  This module makes the test suite
itself the detector:

* :func:`make_lock` is the factory the serving modules create their locks
  through.  With no recorder installed it returns a plain
  ``threading.Lock`` — identical cost to today, nothing imported at lock
  time, production untouched.  With a recorder installed (the port's
  concurrency stress test installs one) it returns an
  :class:`InstrumentedLock` that reports every acquire/release.
* :class:`LockOrderRecorder` keeps, per thread, the stack of locks
  currently held, and builds the directed *acquisition-order graph*: an
  edge ``A -> B`` for every acquire of ``B`` while ``A`` is held, keyed
  by lock **name** (every ``SessionPool._state_lock`` instance is one
  node — the ordering discipline is per role, not per object).
  ``cycles()`` runs a DFS over that graph; a cycle is a potential
  deadlock even if no run ever hung.  The recorder also aggregates
  per-name **hold times** (count / total / max seconds) so a lock held
  across a blocking device fetch shows up as a number, not a hunch —
  ``slow_holds`` lists every hold longer than ``slow_hold_s`` with the
  thread that did it.  The static companion rule (``await-under-lock``
  in the reference's ``analysis/concurrency.py``) catches the async-driver variant of
  the same mistake at lint time.
* Re-acquiring a lock object the same thread already holds (guaranteed
  self-deadlock for non-reentrant locks) is recorded as a violation
  *before* the acquire blocks, so the report names the culprit even when
  the test then times out.

The recorder never holds its own mutex while acquiring an instrumented
lock, so instrumentation cannot itself deadlock; stdlib-only, no jax.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = [
    "InstrumentedLock",
    "LockOrderRecorder",
    "current",
    "install",
    "make_lock",
    "uninstall",
]


class LockOrderRecorder:
    """Cross-thread lock acquisition-order graph + hold-time aggregator.

    Thread-safe; one instance is typically installed process-wide via
    :func:`install` and fed by every :class:`InstrumentedLock`.
    """

    def __init__(self, slow_hold_s: float = 1.0):
        self.slow_hold_s = float(slow_hold_s)
        self._mu = threading.Lock()
        self._tls = threading.local()
        # acquisition-order edges, (held_name, acquired_name) -> count:
        self._edges: Dict[Tuple[str, str], int] = {}
        # per-name hold stats: name -> [n_holds, total_s, max_s]:
        self._holds: Dict[str, List[float]] = {}
        self._slow: List[Tuple[str, float, int]] = []  # (name, s, thread id)
        self._violations: List[str] = []

    # -- instrumentation feed (called by InstrumentedLock) -------------------

    def _stack(self) -> List[Tuple[str, int, float]]:
        """This thread's held-lock stack: (name, lock id, t_acquired)."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def note_acquire(self, name: str, lock_id: int) -> None:
        """About to block on ``(name, lock_id)``: record order edges from
        every lock this thread already holds (intent, not success — the
        deadlock happens at intent time)."""
        stack = self._stack()
        if any(lid == lock_id for _, lid, _ in stack):
            with self._mu:
                self._violations.append(
                    f"re-acquire of held lock {name!r} on thread "
                    f"{threading.get_ident()}: guaranteed self-deadlock "
                    f"(threading.Lock is not reentrant)")
        if not stack:
            return
        with self._mu:
            for held_name, _, _ in stack:
                if held_name != name:
                    key = (held_name, name)
                    self._edges[key] = self._edges.get(key, 0) + 1

    def note_acquired(self, name: str, lock_id: int) -> None:
        self._stack().append((name, lock_id, time.perf_counter()))

    def note_release(self, name: str, lock_id: int) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][1] == lock_id:
                _, _, t0 = stack.pop(i)
                dt = time.perf_counter() - t0
                with self._mu:
                    h = self._holds.setdefault(name, [0, 0.0, 0.0])
                    h[0] += 1
                    h[1] += dt
                    h[2] = max(h[2], dt)
                    if dt >= self.slow_hold_s:
                        self._slow.append((name, dt, threading.get_ident()))
                return
        with self._mu:
            self._violations.append(
                f"release of {name!r} not held by thread "
                f"{threading.get_ident()}")

    # -- analysis ------------------------------------------------------------

    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def violations(self) -> List[str]:
        with self._mu:
            return list(self._violations)

    def cycles(self) -> List[List[str]]:
        """Cycles in the acquisition-order graph (each as the name path
        ``[a, b, ..., a]``) — every one is a potential deadlock."""
        graph: Dict[str, List[str]] = {}
        for (a, b) in self.edges():
            graph.setdefault(a, []).append(b)
            graph.setdefault(b, [])
        out: List[List[str]] = []
        color: Dict[str, int] = {}          # 0 absent / 1 on path / 2 done
        path: List[str] = []

        def dfs(n: str) -> None:
            color[n] = 1
            path.append(n)
            for m in graph[n]:
                c = color.get(m, 0)
                if c == 1:
                    out.append(path[path.index(m):] + [m])
                elif c == 0:
                    dfs(m)
            path.pop()
            color[n] = 2

        for n in sorted(graph):
            if color.get(n, 0) == 0:
                dfs(n)
        return out

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            pretty = "; ".join(" -> ".join(c) for c in cyc)
            raise AssertionError(
                f"lock-order cycles (potential deadlocks): {pretty}")
        bad = self.violations()
        if bad:
            raise AssertionError("lock discipline violations: "
                                 + "; ".join(bad))

    def hold_times(self) -> Dict[str, Dict[str, float]]:
        with self._mu:
            return {name: {"count": int(h[0]), "total_s": h[1],
                           "max_s": h[2]}
                    for name, h in sorted(self._holds.items())}

    def slow_holds(self) -> List[Tuple[str, float, int]]:
        with self._mu:
            return list(self._slow)

    def report(self) -> Dict[str, object]:
        """JSON-ready summary of the graph, holds and violations."""
        return {
            "edges": [{"held": a, "acquired": b, "count": n}
                      for (a, b), n in sorted(self.edges().items())],
            "cycles": self.cycles(),
            "violations": self.violations(),
            "hold_times": self.hold_times(),
            "slow_holds": [{"name": n, "seconds": s, "thread": t}
                           for n, s, t in self.slow_holds()],
        }


class InstrumentedLock:
    """Drop-in ``threading.Lock`` that reports to a `LockOrderRecorder`.

    The recorder is resolved per acquire (the installed one by default),
    so locks created before a recorder swap keep reporting to the live
    instance.  Supports the full Lock protocol used in this repo:
    ``with``, ``acquire(blocking=, timeout=)``, ``release``, ``locked``.
    """

    __slots__ = ("name", "_lock", "_rec")

    def __init__(self, name: str,
                 recorder: Optional[LockOrderRecorder] = None):
        self.name = name
        self._lock = threading.Lock()
        self._rec = recorder

    def _recorder(self) -> Optional[LockOrderRecorder]:
        return self._rec if self._rec is not None else current()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        rec = self._recorder()
        if rec is not None:
            rec.note_acquire(self.name, id(self))
        ok = self._lock.acquire(blocking, timeout)
        if ok and rec is not None:
            rec.note_acquired(self.name, id(self))
        return ok

    def release(self) -> None:
        rec = self._recorder()
        if rec is not None:
            rec.note_release(self.name, id(self))
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


_installed: Optional[LockOrderRecorder] = None


def install(recorder: LockOrderRecorder) -> None:
    """Make ``recorder`` the process-wide recorder new instrumented locks
    report to, and the one :func:`make_lock` instruments for."""
    global _installed
    _installed = recorder


def uninstall() -> None:
    global _installed
    _installed = None


def current() -> Optional[LockOrderRecorder]:
    return _installed


def make_lock(name: str):
    """The serving modules' lock factory.

    No recorder installed (production, plain test runs): a bare
    ``threading.Lock`` — zero added cost, chosen once at creation.  With
    a recorder installed (chaos job, stress tests): an
    :class:`InstrumentedLock` named ``name``, feeding the
    acquisition-order graph.  Name by role (``"SessionPool._state_lock"``),
    not by instance — ordering discipline is a property of the role.
    """
    if _installed is None:
        return threading.Lock()
    return InstrumentedLock(name)
