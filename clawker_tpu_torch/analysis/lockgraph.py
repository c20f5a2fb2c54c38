"""Runtime lock-order tracer: the race-detector half of `clawker analyze`.

Static checkers prove what code *says*; deadlocks live in what threads
*do*.  This module wraps ``threading.Lock``/``threading.RLock`` (opt-in,
via :func:`install_lock_tracing` -- the testenv hook and the chaos soak
turn it on) and records the cross-thread lock **acquisition graph**:
an edge A -> B every time a thread tries to take B while holding A.
A cycle in that graph is a potential deadlock -- two threads that draw
the cyclic orders concurrently will park forever -- and the report
carries both acquisition stacks so the fix is a code pointer, not a
core dump.

Locks aggregate by **creation site** (file:line of the ``Lock()``
call): lock-order discipline is a property of lock *classes* ("the
pool lock", "the bus stamp lock"), not instances.  Same-site nesting
(two per-worker lane locks held together) is recorded separately and
never reported as a cycle -- per-instance hierarchies are legitimate;
cross-site cycles are not.

Edges are recorded on the acquire *attempt*, before the real acquire
can block, so a live deadlock still leaves its own evidence.  The
tracer costs one thread-local list scan per acquire and captures
frames only for the held-stack bookkeeping (bounded, no linecache), so
the 25-scenario chaos soak runs it without moving its budget.

The port's copy of ``clawker_tpu/analysis/lockgraph.py``, whole.  Its
graph stack is its own: the tests' suite-wide ``CLAWKER_TPU_LOCKGRAPH``
hook installs the reference's tracer.  Each module captures
``threading.Lock`` when it is first imported, so a process that may
run both imports both modules before it installs either, and never
installs one package's tracer inside the other's.
"""

from __future__ import annotations

import sys
import threading

# originals captured at import: the graph's own mutation lock must never
# be a traced lock, and uninstall must restore exactly these
_ORIG_LOCK = threading.Lock
_ORIG_RLOCK = threading.RLock

_STACK_LIMIT = 6


def _site(depth: int) -> str:
    f = sys._getframe(depth)
    fn = f.f_code.co_filename.replace("\\", "/")
    short = "/".join(fn.split("/")[-3:])
    return f"{short}:{f.f_lineno}"


def _mini_stack(skip: int = 2) -> tuple[str, ...]:
    out: list[str] = []
    f = sys._getframe(skip)
    while f is not None and len(out) < _STACK_LIMIT:
        co = f.f_code
        fn = co.co_filename.replace("\\", "/")
        if "analysis/lockgraph" not in fn:
            out.append(f"{'/'.join(fn.split('/')[-3:])}:{f.f_lineno} "
                       f"in {co.co_name}")
        f = f.f_back
    return tuple(out)


class LockGraph:
    """Cross-thread lock acquisition graph, aggregated by creation site."""

    def __init__(self):
        self.enabled = True
        self._glock = _ORIG_LOCK()
        self._tls = threading.local()
        # (site_a, site_b) -> edge doc, recorded once per ordered pair
        self.edges: dict[tuple[str, str], dict] = {}
        self.same_site: dict[str, int] = {}
        # re-acquire of a HELD non-reentrant lock: a guaranteed
        # single-thread deadlock, reported as a self-cycle
        self.self_deadlocks: dict[str, dict] = {}
        # per-thread acquire tallies (each thread only ever writes its
        # own slot, so no lock and no lost increments); summed by the
        # `acquires` property
        self._acq_counts: dict[int, int] = {}
        # ((edge_count, self_deadlock_count), cycle list) -- see cycles()
        self._cycles_cache: tuple[tuple[int, int], list[dict]] | None = None

    # ------------------------------------------------------- hot path

    def _held(self) -> list:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    @property
    def acquires(self) -> int:
        return sum(self._acq_counts.values())

    def before_acquire(self, lock: "TracedLock", blocking: bool = True,
                       timeout: float = -1) -> None:
        if not self.enabled:
            return
        held = self._held()
        if any(e[1] is lock for e in held):
            # RLock reentry carries no ordering information -- but an
            # UNBOUNDED blocking re-acquire of a held non-reentrant
            # lock is a guaranteed single-thread deadlock: record it
            # before we park forever.  Trylocks and timed attempts are
            # exempt -- Condition._is_owned probes a held lock with
            # acquire(False) by design.
            if not lock._reentrant and blocking and timeout < 0 \
                    and lock.site not in self.self_deadlocks:
                with self._glock:
                    self.self_deadlocks.setdefault(lock.site, {
                        "count": 1,
                        "thread": threading.current_thread().name,
                        "held_stack": [
                            list(e[2]) for e in held if e[1] is lock
                        ][0],
                        "acquire_stack": list(_mini_stack()),
                    })
            return
        tid = threading.get_ident()
        self._acq_counts[tid] = self._acq_counts.get(tid, 0) + 1
        if not held:
            return
        my_stack: tuple[str, ...] | None = None
        for site_a, lock_a, stack_a in held:
            if site_a == lock.site:
                with self._glock:
                    self.same_site[site_a] = \
                        self.same_site.get(site_a, 0) + 1
                continue
            key = (site_a, lock.site)
            if key in self.edges:       # racy pre-check; settled below
                with self._glock:
                    self.edges[key]["count"] += 1
                continue
            if my_stack is None:
                my_stack = _mini_stack()
            with self._glock:
                if key in self.edges:
                    self.edges[key]["count"] += 1
                else:
                    self.edges[key] = {
                        "count": 1,
                        "thread": threading.current_thread().name,
                        "held_stack": list(stack_a),
                        "acquire_stack": list(my_stack),
                    }

    def acquired(self, lock: "TracedLock") -> None:
        if not self.enabled:
            return
        self._held().append((lock.site, lock, _mini_stack()))

    def released(self, lock: "TracedLock") -> None:
        if not self.enabled:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][1] is lock:
                del held[i]
                return

    # ------------------------------------------------------- analysis

    def cycles(self) -> list[dict]:
        """Every elementary cross-site cycle, each with its edges and
        both acquisition stacks per edge.  Empty list == deadlock-free
        ordering over everything this graph observed.  Cached per edge
        count: report()/render_cycles() reuse one enumeration instead
        of re-running the (worst-case exponential) DFS."""
        with self._glock:
            key = (len(self.edges), len(self.self_deadlocks))
            cached = self._cycles_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            adj: dict[str, list[str]] = {}
            for a, b in self.edges:
                adj.setdefault(a, []).append(b)
            edge_docs = {k: dict(v) for k, v in self.edges.items()}
            self_dl = {s: dict(d) for s, d in self.self_deadlocks.items()}
        found: list[list[str]] = []
        seen_cycles: set[tuple[str, ...]] = set()

        def dfs(start: str) -> None:
            stack: list[tuple[str, list[str]]] = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in adj.get(node, ()):
                    if nxt == start:
                        # path only ever contains nodes >= start, so
                        # start is the cycle's canonical smallest node
                        norm = tuple(path)
                        if norm not in seen_cycles:
                            seen_cycles.add(norm)
                            found.append(list(norm))
                    elif nxt not in path and nxt > start:
                        # only walk nodes ordered after start: every
                        # cycle is found from its smallest node exactly
                        # once, and the search stays polynomial-ish
                        stack.append((nxt, path + [nxt]))

        for node in sorted(adj):
            dfs(node)
        out = []
        # a held non-reentrant lock re-acquired by its own thread is
        # the degenerate (guaranteed) cycle: report it first
        for site, doc in sorted(self_dl.items()):
            out.append({"locks": [site],
                        "edges": [{"from": site, "to": site, **doc}]})
        for cyc in found:
            edges = []
            for i, a in enumerate(cyc):
                b = cyc[(i + 1) % len(cyc)]
                doc = edge_docs.get((a, b), {})
                edges.append({"from": a, "to": b, **doc})
            out.append({"locks": cyc, "edges": edges})
        with self._glock:
            self._cycles_cache = (key, out)
        return out

    def report(self) -> dict:
        with self._glock:
            n_edges = len(self.edges)
        return {
            "acquires": self.acquires,
            "edges": n_edges,
            "same_site_nestings": dict(self.same_site),
            "cycles": self.cycles(),
        }

    def render_cycles(self) -> str:
        lines: list[str] = []
        for c in self.cycles():
            lines.append("potential deadlock: "
                         + " -> ".join(c["locks"] + [c["locks"][0]]))
            for e in c["edges"]:
                lines.append(f"  {e['from']} held while acquiring "
                             f"{e['to']} (thread {e.get('thread', '?')}, "
                             f"seen {e.get('count', 0)}x)")
                for fr in e.get("held_stack", []):
                    lines.append(f"    held at:    {fr}")
                for fr in e.get("acquire_stack", []):
                    lines.append(f"    acquire at: {fr}")
        return "\n".join(lines)


# active recording graphs, innermost last.  A stack (not a singleton)
# so `testenv.lock_tracing()` nests under the suite-wide
# CLAWKER_TPU_LOCKGRAPH tracer: every traced lock dispatches events to
# ALL active graphs, and popping one's own graph never disables the
# outer one.  Each graph keeps its own thread-local held state, so an
# inner graph only ever sees edges from its own install window.
_graphs: list[LockGraph] = []


class TracedLock:
    """``threading.Lock`` wrapper feeding the active :class:`LockGraph`
    stack (or one pinned graph, for direct construction in tests)."""

    _reentrant = False

    def __init__(self, graph: LockGraph | None = None, site: str = "?",
                 inner=None):
        self._graph = graph         # None = dispatch to the active stack
        self.site = site
        self._inner = inner if inner is not None else _ORIG_LOCK()

    def _targets(self):
        return (self._graph,) if self._graph is not None else tuple(_graphs)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        for g in self._targets():
            g.before_acquire(self, blocking, timeout)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            for g in self._targets():
                g.acquired(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        for g in self._targets():
            g.released(self)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, name: str):
        # stdlib code probes lock internals the wrapper doesn't model --
        # os.register_at_fork(after_in_child=lock._at_fork_reinit, ...)
        # in concurrent.futures and logging is the load-bearing one.
        # Delegate to the real lock; held-state bookkeeping is
        # thread-local, and a forked child has one thread and a fresh
        # world, so inner-only reinit is exactly right.
        try:
            inner = object.__getattribute__(self, "_inner")
        except AttributeError:      # mid-__init__: nothing to delegate to
            raise AttributeError(name) from None
        return getattr(inner, name)

    def __repr__(self) -> str:
        return f"<Traced{'R' if self._reentrant else ''}Lock {self.site}>"


class TracedRLock(TracedLock):
    _reentrant = True

    def __init__(self, graph: LockGraph | None = None, site: str = "?"):
        super().__init__(graph, site, inner=_ORIG_RLOCK())

    # threading.Condition integration: it probes for these and, when
    # present, uses them to fully release / reacquire around wait().
    # They must keep OUR held bookkeeping in sync or every lock taken
    # during a cond.wait() would look nested under the waited lock.
    # (Defined explicitly, so __getattr__ never hands Condition the
    # inner methods that would bypass the bookkeeping.)
    def _is_owned(self) -> bool:
        return self._inner._is_owned()

    def _release_save(self):
        state = self._inner._release_save()
        for g in self._targets():
            g.released(self)
        return state

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        for g in self._targets():
            g.acquired(self)


def _make_lock():
    return TracedLock(None, _site(2))


def _make_rlock():
    return TracedRLock(None, _site(2))


def installed_graph() -> LockGraph | None:
    """The innermost active graph, or None when tracing is off."""
    return _graphs[-1] if _graphs else None


def install_lock_tracing(graph: LockGraph | None = None) -> LockGraph:
    """Push a recording graph and (on first install) patch
    ``threading.Lock``/``RLock`` so every lock created from now on
    feeds the active graph stack.  Locks that already exist stay
    untraced.  Nests: an inner install records its own window and its
    matching :func:`uninstall_lock_tracing` pops only its own graph --
    the suite-wide CLAWKER_TPU_LOCKGRAPH tracer survives a
    ``testenv.lock_tracing()`` block untouched."""
    g = graph if graph is not None else LockGraph()
    _graphs.append(g)
    if len(_graphs) == 1:
        threading.Lock = _make_lock             # type: ignore[assignment]
        threading.RLock = _make_rlock           # type: ignore[assignment]
    return g


def uninstall_lock_tracing() -> LockGraph | None:
    """Pop the innermost graph and stop its recording; restores the
    real lock factories when the last graph leaves.  Locks created
    while tracing was on keep working (they wrap real locks)."""
    g = _graphs.pop() if _graphs else None
    if g is not None:
        g.enabled = False
    if not _graphs:
        threading.Lock = _ORIG_LOCK             # type: ignore[assignment]
        threading.RLock = _ORIG_RLOCK           # type: ignore[assignment]
    return g
