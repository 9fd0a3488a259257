"""lockwatch: the port's runtime lock-acquisition-order watchdog.

A stdlib-only copy of ``lightgbm_tpu/analysis/lockwatch.py`` for
lightgbm_tpu_torch. The static ``lock-order`` rule reasons about the
composed call graph; this module validates that reasoning against REALITY
by recording the order in which the port's locks are actually acquired
while serving, an online cycle and a fleet run. An inversion — thread 1
observed taking A then B, thread 2 observed taking B then A — is the
precondition for deadlock and fails the run even though the deadlock
itself didn't fire.

Mechanics: :func:`install` patches ``threading.Lock`` / ``threading.RLock``
with factories that, when called from a file under ``lightgbm_tpu_torch/``,
return a thin proxy around the real lock. Each proxy acquisition records
the edge (held-lock -> acquired-lock) per thread into a global order graph
keyed by the lock's CREATION site. Reentrant re-acquisition of the same
RLock records nothing (legal). :func:`inversions` reports every pair of
creation sites seen in both orders, with the thread names and code that
produced each direction; :func:`assert_clean` raises on any.

Two differences from the reference's copy: a site is keyed by its path
from the watched package's directory (``lightgbm_tpu_torch/server.py:N``),
not by its basename, so ``lightgbm_tpu/server.py:N`` and
``lightgbm_tpu_torch/server.py:N`` cannot collide; and the default prefix
is ``lightgbm_tpu_torch``.

Bootstrap: load this file by its FILE PATH
(``importlib.util.spec_from_file_location``) and call :func:`install`
*before* the port is imported, because patching must precede the port's
lock creation (chip_smoke.py's path (v3) does so in a fresh process). It
therefore uses only stdlib absolute imports — no relative imports, no
package siblings. ``LGBMTPU_LOCKWATCH=0`` disables installation entirely.

Overhead: one dict update per (holder, acquired) edge per thread, only for
locks created by the port; stdlib and torch locks pass through untouched.
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock

# edge (site_a -> site_b) -> {(thread_name, "file:line")} examples of a
# thread acquiring b while holding a
_EdgeMap = Dict[Tuple[str, str], Set[Tuple[str, str]]]


class LockWatch:
    """Global recorder. One instance (:data:`WATCH`) lives for the process;
    tests reset() it between suites if they want isolation."""

    def __init__(self) -> None:
        self._mu = _REAL_LOCK()
        self._edges: _EdgeMap = {}
        # creation sites of the watched locks made so far
        self.sites: Set[str] = set()
        self._held = threading.local()
        self.enabled = True

    # -- recording ---------------------------------------------------------
    def _stack(self) -> List[str]:
        st = getattr(self._held, "stack", None)
        if st is None:
            st = self._held.stack = []
        return st

    def note_acquire(self, site: str, reentrant: bool) -> None:
        if not self.enabled:
            return
        st = self._stack()
        if reentrant and site in st:
            return                      # legal RLock re-entry: no edge
        caller = _caller_site()
        tname = threading.current_thread().name
        if st:
            holder = st[-1]
            if holder != site:
                with self._mu:
                    self._edges.setdefault((holder, site), set()).add(
                        (tname, caller))
        st.append(site)

    def note_release(self, site: str) -> None:
        st = self._stack()
        # release order may not mirror acquire order; drop the last match
        for i in range(len(st) - 1, -1, -1):
            if st[i] == site:
                del st[i]
                break

    # -- reporting ---------------------------------------------------------
    def edges(self) -> _EdgeMap:
        with self._mu:
            return {k: set(v) for k, v in self._edges.items()}

    def inversions(self) -> List[str]:
        """Human-readable report per lock pair observed in both orders."""
        edges = self.edges()
        out = []
        for (a, b) in sorted(edges):
            if a < b and (b, a) in edges:
                fwd = "; ".join(f"{t} at {c}" for t, c in sorted(edges[(a, b)]))
                rev = "; ".join(f"{t} at {c}" for t, c in sorted(edges[(b, a)]))
                out.append(
                    f"lock-order inversion between {a} and {b}:\n"
                    f"  {a} -> {b}: {fwd}\n"
                    f"  {b} -> {a}: {rev}")
        return out

    def assert_clean(self, context: str = "") -> None:
        inv = self.inversions()
        if inv:
            where = f" during {context}" if context else ""
            raise AssertionError(
                f"lockwatch recorded {len(inv)} lock-order inversion(s)"
                f"{where} — potential deadlock under load:\n"
                + "\n".join(inv))

    def reset(self) -> None:
        with self._mu:
            self._edges.clear()


WATCH = LockWatch()


def _outer_frame():
    """Nearest stack frame outside this module. Raw frame walking, not
    ``traceback.extract_stack`` — this runs on EVERY watched acquisition,
    and extract_stack's linecache reads are slow enough to perturb the
    serve path's timing-sensitive tests."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    return f


_PREFIXES: Tuple[str, ...] = ("lightgbm_tpu_torch",)


def _site(filename: str, lineno: int) -> str:
    """``filename:lineno`` from the watched package's directory on
    (``lightgbm_tpu_torch/server.py:12``), else the basename."""
    path = filename.replace(os.sep, "/")
    best = -1
    for p in _PREFIXES:
        i = path.rfind("/" + p + "/")
        best = max(best, i + 1 if i >= 0 else -1)
        if path.startswith(p + "/"):
            best = max(best, 0)
    rel = path[best:] if best >= 0 else os.path.basename(filename)
    return f"{rel}:{lineno}"


def _caller_site() -> str:
    """First stack frame outside this module — the acquisition site."""
    f = _outer_frame()
    if f is None:
        return "<unknown>"
    return _site(f.f_code.co_filename, f.f_lineno)


def _creation_site(prefixes: Tuple[str, ...]) -> Optional[str]:
    """Creation site if the factory call came from watched code, else None."""
    f = _outer_frame()
    if f is None:
        return None
    fn = f.f_code.co_filename
    if any(sep in fn for sep in prefixes):
        return _site(fn, f.f_lineno)
    return None


class _LockProxy:
    """Wraps a real lock; records acquisition edges against its creation
    site. Delegates everything else (Condition wiring etc.) to the real
    lock via __getattr__."""

    __slots__ = ("_lock", "_site", "_reentrant")

    def __init__(self, lock, site: str, reentrant: bool) -> None:
        self._lock = lock
        self._site = site
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got:
            WATCH.note_acquire(self._site, self._reentrant)
        return got

    def release(self) -> None:
        WATCH.note_release(self._site)
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __getattr__(self, name):
        return getattr(self._lock, name)

    def __repr__(self) -> str:
        return f"<lockwatch proxy for {self._site} ({self._lock!r})>"


_installed = False


def install(path_prefixes: Tuple[str, ...] = ("lightgbm_tpu_torch",)
            ) -> bool:
    """Patch threading.Lock/RLock so locks created from files under a
    directory named by ``path_prefixes`` are watched. Idempotent. Returns
    whether the patch is active (False under LGBMTPU_LOCKWATCH=0)."""
    global _installed, _PREFIXES
    if os.environ.get("LGBMTPU_LOCKWATCH", "1") == "0":
        return False
    if _installed:
        return True
    _PREFIXES = tuple(path_prefixes)
    # a directory of that name, not a name that merely starts with it
    prefixes = tuple(os.sep + p + os.sep for p in path_prefixes)

    def make(real, reentrant):
        site = _creation_site(prefixes)
        if not site:
            return real
        WATCH.sites.add(site)
        return _LockProxy(real, site, reentrant)

    def make_lock():
        return make(_REAL_LOCK(), False)

    def make_rlock():
        return make(_REAL_RLOCK(), True)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    _installed = True
    return True


def uninstall() -> None:
    global _installed
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    _installed = False
