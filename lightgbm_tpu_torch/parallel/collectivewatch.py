"""collectivewatch: the per-rank ledger of the collectives a rank issues.

Port of ``lightgbm_tpu/analysis/collectivewatch.py`` over
``torch.distributed``. ``install`` wraps the group's entry points
(``all_gather``, ``all_reduce``, ``broadcast``, ``barrier``) so that each
call appends ``(op, dtype, shape, call site)`` to the process ledger
``WATCH`` before it runs. Two ranks whose ledgers differ (another order,
another dtype or shape at one position) have paired mismatched
rendezvous: on a cluster that is a hang or a silent corruption, in the
drills a failure with both ledgers in its message.

The ledger also holds the wire rule: a raw ``all_gather`` carries uint8
bytes only (``multihost.wire_allgather`` encodes every host payload), so
f64 bounds and i64 counts cannot be narrowed in flight;
``wire_violations`` lists any other dtype there. The histogram sums are
``all_reduce`` of f32 and are not raw payloads.
"""
from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

_OPS = ("all_gather", "all_reduce", "broadcast", "barrier")
# the op whose payloads must be raw bytes, and their dtype
RAW_OP = "all_gather"
WIRE_DTYPE = "torch.uint8"


def _caller_site() -> str:
    """The nearest frame outside this module: the collective's call
    site."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == __file__:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


def _payload(op: str, args) -> Any:
    """The tensor a call carries (``all_gather``'s is its second
    argument)."""
    if op == RAW_OP:
        return args[1] if len(args) > 1 else None
    return args[0] if args else None


class CollectiveWatch:
    """The process recorder (``WATCH``); tests may build their own."""

    def __init__(self, ledger_path: Optional[str] = None) -> None:
        self.records: List[Dict[str, Any]] = []
        self.enabled = True
        self.ledger_path = ledger_path

    def note(self, op: str, payload: Any) -> None:
        if not self.enabled:
            return
        dt = getattr(payload, "dtype", None)
        shape = getattr(payload, "shape", None)
        self.records.append({
            "op": op, "dtype": str(dt) if dt is not None else "",
            "shape": [int(s) for s in shape] if shape is not None else [],
            "site": _caller_site()})

    def sequence(self) -> List[Tuple[str, str, Tuple[int, ...]]]:
        """The rank's rendezvous identity: ordered (op, dtype, shape)."""
        return [(r["op"], r["dtype"], tuple(r["shape"]))
                for r in self.records]

    def wire_violations(self) -> List[str]:
        """Raw gathers of another dtype than uint8."""
        return [f"{r['op']}({r['dtype']}{tuple(r['shape'])}) at "
                f"{r['site']}: a raw payload bypassed the uint8 wire codec"
                for r in self.records
                if r["op"] == RAW_OP and r["dtype"] != WIRE_DTYPE]

    def assert_clean(self, context: str = "") -> None:
        bad = self.wire_violations()
        if bad:
            where = f" during {context}" if context else ""
            raise AssertionError(
                f"collectivewatch recorded {len(bad)} wire-dtype "
                f"violation(s){where}:\n" + "\n".join(bad))

    def write_ledger(self, path: Optional[str] = None) -> Optional[str]:
        path = path or self.ledger_path
        if not path:
            return None
        # a per-run diagnostic written once as the rank exits and read only
        # by its launcher after every rank has exited; atomicity buys
        # nothing  # tpu-lint: disable=non-atomic-artifact-write
        with open(path, "w") as fh:
            for r in self.records:
                fh.write(json.dumps(r) + "\n")
        return path

    def reset(self) -> None:
        self.records.clear()


WATCH = CollectiveWatch()


def read_ledger(path: str) -> List[Dict[str, Any]]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _key(rec: Dict[str, Any]) -> Tuple[str, str, Tuple[int, ...]]:
    return (rec["op"], rec["dtype"], tuple(rec["shape"]))


def compare_ledgers(paths: Sequence[str]) -> List[str]:
    """The problems across per-rank ledgers: every rank must have issued
    the same ordered (op, dtype, shape) sequence and no wire violation.
    Empty when the ranks agree."""
    ranks = [read_ledger(p) for p in paths]
    out: List[str] = []
    if len({len(r) for r in ranks}) > 1:
        counts = ", ".join(f"rank{i}={len(r)}" for i, r in enumerate(ranks))
        out.append(f"collective COUNT diverges across ranks ({counts}): "
                   "some rank skipped or repeated a rendezvous")
    for pos in range(min(len(r) for r in ranks) if ranks else 0):
        keys = [_key(r[pos]) for r in ranks]
        if len(set(keys)) > 1:
            shown = "; ".join(
                f"rank{i}: {k[0]}({k[1]}{k[2]}) at {ranks[i][pos]['site']}"
                for i, k in enumerate(keys))
            out.append(f"rendezvous #{pos} diverges: {shown}")
    for i, recs in enumerate(ranks):
        w = CollectiveWatch()
        w.records = recs
        out.extend(f"rank{i}: {v}" for v in w.wire_violations())
    return out


def assert_ledgers_match(paths: Sequence[str], context: str = "") -> None:
    problems = compare_ledgers(paths)
    if problems:
        where = f" during {context}" if context else ""
        raise AssertionError(
            f"collectivewatch: {len(problems)} cross-rank ledger "
            f"problem(s){where}:\n" + "\n".join(problems))


def _wrap(op: str, fn, watch: CollectiveWatch):
    def wrapped(*args, **kwargs):
        watch.note(op, _payload(op, args))
        return fn(*args, **kwargs)
    wrapped.__name__ = f"collectivewatch_{op}"
    wrapped.collectivewatch_of = fn
    return wrapped


def install(ledger_path: Optional[str] = None) -> None:
    """Wrap the ``torch.distributed`` entry points so that every collective
    of this process lands in ``WATCH``; idempotent."""
    import torch.distributed as dist
    WATCH.ledger_path = ledger_path or WATCH.ledger_path
    for op in _OPS:
        fn = getattr(dist, op)
        if getattr(fn, "collectivewatch_of", None) is None:
            setattr(dist, op, _wrap(op, fn, WATCH))


def uninstall() -> None:
    import torch.distributed as dist
    for op in _OPS:
        orig = getattr(getattr(dist, op), "collectivewatch_of", None)
        if orig is not None:
            setattr(dist, op, orig)
