"""Runtime lock-order / thread-ownership sanitizer (TRIVY_TPU_LOCKCHECK=1).

Copied from `trivy_tpu/lockcheck.py`: the port imports nothing from the JAX
package, so it keeps its own copy of this jax-free module.

The codebase is hand-threaded: the serve scheduler's engine-owner thread,
RulesetManager epoch swaps staged from admin/SIGHUP threads, the hybrid
engine's sieve worker pool, metrics scrapes from HTTP threads.  The static
side of the contract lives in tools/graftlint (ownership annotations,
`make lint`); this module is the dynamic side — the moral equivalent of
Go's `-race` + a lock-order checker, scoped to the locks this project
actually creates.

Every `threading.Lock`/`Condition` site in trivy_tpu constructs through
`make_lock(name)` / `make_condition(lock, name)`.  Disabled (the default)
these return the plain threading primitives — zero overhead, byte-for-byte
the pre-sanitizer behavior.  With ``TRIVY_TPU_LOCKCHECK=1`` in the
environment at construction time they return instrumented wrappers that:

  * record the process-wide lock ACQUISITION-ORDER GRAPH: an edge A -> B
    for every acquire of B while A is held, keyed by lock *name* (every
    per-instance family lock of one kind shares a name, so the graph stays
    O(named sites), not O(objects)).  ``check_cycles()`` reports cycles —
    an ABBA pair that never happened to interleave in the run still shows
    up, which is the whole point of order checking over deadlock waiting.
  * fail FAST on same-thread re-acquisition of a non-reentrant lock
    (``LockCheckError`` instead of the silent deadlock CPython gives you).
  * enforce OWNER ROLES: ``owner_role(name)`` returns a per-instance role
    that binds to the first asserting thread; later ``assert_here()`` calls
    from any other thread raise.  RulesetManager.engine() uses this to pin
    "only the engine-owner thread swaps epochs" at runtime.

Self-cycles (A -> A) never enter the graph — re-acquisition is reported
eagerly instead — and Condition round-trips through ``wait()`` release and
re-acquire the underlying checked lock, so held-sets stay exact.

Tests drive real workloads (scheduler coalescing, hot reload, chunk
pipeline) with the flag on and assert ``check_cycles() == []`` and
``violations() == []``; tests/conftest.py installs a session-end assert
whenever the flag is set so `TRIVY_TPU_LOCKCHECK=1 pytest ...` fails on
any cycle or ownership violation anywhere in the run.
"""

from __future__ import annotations

import os
import threading

__all__ = [
    "enabled",
    "make_lock",
    "make_condition",
    "owner_role",
    "check_cycles",
    "violations",
    "edges",
    "reset",
    "LockCheckError",
]


class LockCheckError(RuntimeError):
    """A lock-discipline violation detected while the sanitizer is on."""


def enabled() -> bool:
    """Read at every construction site (not import), so tests can flip
    the flag per-test without reimporting the modules that hold locks."""
    return os.environ.get("TRIVY_TPU_LOCKCHECK", "") not in (
        "", "0", "false", "off",
    )


# -- global order graph ----------------------------------------------------

# Guards the graph + violation ledger.  A plain threading.Lock on purpose:
# the sanitizer must not check itself.
_graph_lock = threading.Lock()
# edge (held_name, acquired_name) -> first witness "thread=<n> at <site>"
_edges: dict[tuple[str, str], str] = {}
_violations: list[str] = []
_tls = threading.local()


def _held() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _record_violation(msg: str) -> None:
    with _graph_lock:
        _violations.append(msg)


def reset() -> None:
    """Drop the recorded graph, violations, and this thread's held set
    (tests isolate themselves with this; production never calls it)."""
    with _graph_lock:
        _edges.clear()
        _violations.clear()
    _tls.held = []


def edges() -> dict[tuple[str, str], str]:
    with _graph_lock:
        return dict(_edges)


def violations() -> list[str]:
    with _graph_lock:
        return list(_violations)


def check_cycles() -> list[list[str]]:
    """Cycles in the acquisition-order graph, each as the list of lock
    names along the cycle (first == last).  Empty list = order-clean."""
    with _graph_lock:
        adj: dict[str, list[str]] = {}
        for a, b in _edges:
            adj.setdefault(a, []).append(b)
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {n: WHITE for n in adj}

    def dfs(node: str, path: list[str]) -> None:
        color[node] = GRAY
        path.append(node)
        for nxt in adj.get(node, ()):
            if color.get(nxt, WHITE) == GRAY:
                cyc = path[path.index(nxt):] + [nxt]
                # canonicalize by rotating to the min element so the same
                # cycle found from two entry points reports once
                body = cyc[:-1]
                k = body.index(min(body))
                canon = tuple(body[k:] + body[:k])
                if canon not in seen_cycles:
                    seen_cycles.add(canon)
                    cycles.append(list(canon) + [canon[0]])
            elif color.get(nxt, WHITE) == WHITE:
                dfs(nxt, path)
        path.pop()
        color[node] = BLACK

    for n in list(adj):
        if color.get(n, WHITE) == WHITE:
            dfs(n, [])
    return cycles


def assert_clean() -> None:
    """Raise LockCheckError when the run recorded any cycle or violation
    (the tests/conftest session-end gate)."""
    cyc = check_cycles()
    vio = violations()
    if cyc or vio:
        parts = []
        if cyc:
            parts.append(
                "lock-order cycles: "
                + "; ".join(" -> ".join(c) for c in cyc)
            )
        parts.extend(vio)
        raise LockCheckError("; ".join(parts))


# -- instrumented primitives ----------------------------------------------


class _CheckedLock:
    """threading.Lock wrapper recording order edges and re-acquisition.

    Exposes the full lock protocol Condition needs (acquire/release/
    locked/context manager), so `make_condition` can wrap one directly.
    """

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        held = _held()
        if any(l is self for l in held):
            if not blocking:
                # Condition._is_owned() probes non-RLock locks with
                # acquire(False): held-by-us must answer False exactly
                # like the plain Lock, without touching the real lock.
                return False
            # The plain Lock would deadlock right here; failing the test
            # beats hanging it.
            msg = (
                f"re-acquisition of non-reentrant lock {self.name!r} on "
                f"thread {threading.current_thread().name}"
            )
            _record_violation(msg)
            raise LockCheckError(msg)
        if held:
            site = (
                f"thread={threading.current_thread().name}"
            )
            with _graph_lock:
                for h in held:
                    if h.name != self.name:
                        _edges.setdefault((h.name, self.name), site)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self)
        return ok

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        else:
            _record_violation(
                f"release of {self.name!r} not held by thread "
                f"{threading.current_thread().name}"
            )
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def make_lock(name: str):
    """A threading.Lock, instrumented iff TRIVY_TPU_LOCKCHECK is set at
    construction time.  `name` identifies the SITE (all instances from one
    site share a node in the order graph)."""
    if not enabled():
        return threading.Lock()
    return _CheckedLock(name)


def make_condition(lock, name: str = ""):
    """A threading.Condition over `lock` (plain or checked).  Condition
    drives the lock purely through acquire/release, so wait()'s release +
    re-acquire keeps the checked held-set exact."""
    return threading.Condition(lock)


# -- owner roles -----------------------------------------------------------


class _NoopRole:
    __slots__ = ()

    def assert_here(self) -> None:
        pass

    def reset(self) -> None:
        pass


_NOOP_ROLE = _NoopRole()


class _OwnerRole:
    """First-asserter-binds thread role; per owning object, not global."""

    __slots__ = ("name", "_thread_id", "_thread_name", "_bind_lock")

    def __init__(self, name: str):
        self.name = name
        self._thread_id: int | None = None
        self._thread_name = ""
        self._bind_lock = threading.Lock()

    def assert_here(self) -> None:
        me = threading.get_ident()
        with self._bind_lock:
            if self._thread_id is None:
                self._thread_id = me
                self._thread_name = threading.current_thread().name
                return
            bound, bound_name = self._thread_id, self._thread_name
        if bound != me:
            msg = (
                f"owner role {self.name!r} bound to thread "
                f"{bound_name!r} but asserted from "
                f"{threading.current_thread().name!r}"
            )
            _record_violation(msg)
            raise LockCheckError(msg)

    def reset(self) -> None:
        with self._bind_lock:
            self._thread_id = None
            self._thread_name = ""


def owner_role(name: str):
    """Per-instance thread-role assertion, no-op unless the sanitizer is
    enabled at construction time."""
    if not enabled():
        return _NOOP_ROLE
    return _OwnerRole(name)
