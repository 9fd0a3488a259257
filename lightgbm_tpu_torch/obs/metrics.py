"""Counters, gauges and log2-bucketed histograms with JSON + Prometheus export.

Port of ``lightgbm_tpu/obs/metrics.py`` (pure Python, copied). A
deliberately small metrics layer (no client-library dependency): metric
families live in a thread-safe registry, support Prometheus-style labels
(``registry.counter("predict_calls", bucket="1024")``), and export two ways —

* :meth:`MetricsRegistry.to_json` — a nested dict snapshot, written as
  ``metrics.json``;
* :meth:`MetricsRegistry.to_prometheus` — the Prometheus *textfile exposition
  format* (``# HELP``/``# TYPE``, ``_total`` counters, cumulative
  ``_bucket{le=...}`` histogram series), suitable for the node-exporter
  textfile collector or ``promtool check metrics``.

Latency histograms use log2 buckets: upper bounds ``base * 2**i`` starting at
1 microsecond, as the reference's.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

from ..utils import atomic_io

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class Counter:
    """Monotonic counter. ``inc`` only; negative increments raise."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value; ``set_max`` keeps a high-watermark."""

    def __init__(self) -> None:
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        with self._lock:
            if v > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Log2-bucketed histogram.

    Bucket ``i`` has upper bound ``base * 2**i`` (inclusive, Prometheus
    ``le`` semantics); observations above the last bound land in +Inf.
    Defaults cover 1 us .. ~67 s in 27 buckets — the full span from a
    one-row predict to a long training phase.
    """

    def __init__(self, base: float = 1e-6, n_buckets: int = 27) -> None:
        self.base = float(base)
        self.bounds: List[float] = [base * (2.0 ** i) for i in range(n_buckets)]
        self.counts: List[int] = [0] * (n_buckets + 1)   # last = +Inf
        self.sum = 0.0
        self._lock = threading.Lock()

    def bucket_index(self, value: float) -> int:
        if value <= self.base:
            return 0
        idx = int(math.ceil(math.log2(value / self.base)))
        return min(idx, len(self.bounds))   # len(bounds) == +Inf slot

    def observe(self, value: float) -> None:
        idx = self.bucket_index(value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self.counts)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"bounds": list(self.bounds), "counts": list(self.counts),
                    "sum": self.sum, "count": sum(self.counts)}


class _Family:
    def __init__(self, name: str, kind: str, help_: str) -> None:
        self.name = name
        self.kind = kind        # "counter" | "gauge" | "histogram"
        self.help = help_
        self.children: Dict[LabelKey, Any] = {}


_VALID_NAME = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class MetricsRegistry:
    """Get-or-create registry of metric families, keyed by name + labels."""

    def __init__(self) -> None:
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _child(self, name: str, kind: str, help_: str,
               labels: Dict[str, str], factory) -> Any:
        if not _VALID_NAME.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(name, kind, help_)
            elif fam.kind != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam.kind}, not {kind}")
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = factory()
            return child

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._child(name, "counter", help, labels, Counter)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._child(name, "gauge", help, labels, Gauge)

    def histogram(self, name: str, help: str = "", base: float = 1e-6,
                  n_buckets: int = 27, **labels: str) -> Histogram:
        return self._child(name, "histogram", help, labels,
                           lambda: Histogram(base=base, n_buckets=n_buckets))

    def clear(self) -> None:
        with self._lock:
            self._families.clear()

    def get_family(self, name: str) -> Optional[Tuple[str, Dict[LabelKey, Any]]]:
        """``(kind, {label_key: child})`` snapshot of one family, or None.
        The child objects are live (their own locks guard reads)."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.kind, dict(fam.children)

    # ---- exporters ----
    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        with self._lock:
            fams = {n: (f.kind, f.help, dict(f.children))
                    for n, f in self._families.items()}
        for name, (kind, help_, children) in sorted(fams.items()):
            entry: Dict[str, Any] = {"kind": kind, "help": help_, "series": {}}
            for key, child in sorted(children.items()):
                label = _label_str(key) or "{}"
                if kind == "histogram":
                    entry["series"][label] = child.snapshot()
                else:
                    entry["series"][label] = child.value
            out[name] = entry
        return out

    def to_prometheus(self, prefix: str = "lgbmtpu_") -> str:
        """Prometheus textfile exposition format."""
        lines: List[str] = []
        with self._lock:
            fams = {n: (f.kind, f.help, dict(f.children))
                    for n, f in self._families.items()}
        for name, (kind, help_, children) in sorted(fams.items()):
            full = prefix + name
            if kind == "counter" and not full.endswith("_total"):
                full += "_total"
            lines.append(f"# HELP {full} {help_ or name}")
            lines.append(f"# TYPE {full} {kind}")
            for key, child in sorted(children.items()):
                ls = _label_str(key)
                if kind == "histogram":
                    snap = child.snapshot()
                    cum = 0
                    for bound, cnt in zip(snap["bounds"], snap["counts"]):
                        cum += cnt
                        blabels = dict(key)
                        blabels["le"] = _fmt_float(bound)
                        lines.append(f"{full}_bucket{_label_str(_label_key(blabels))} {cum}")
                    cum += snap["counts"][-1]
                    inf_labels = dict(key)
                    inf_labels["le"] = "+Inf"
                    lines.append(f"{full}_bucket{_label_str(_label_key(inf_labels))} {cum}")
                    lines.append(f"{full}_sum{ls} {_fmt_float(snap['sum'])}")
                    lines.append(f"{full}_count{ls} {cum}")
                else:
                    lines.append(f"{full}{ls} {_fmt_float(child.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_json(self, path: str) -> None:
        atomic_io.atomic_write_text(
            path, json.dumps(self.to_json(), sort_keys=True, indent=1) + "\n")

    def write_prometheus(self, path: str, prefix: str = "lgbmtpu_") -> None:
        atomic_io.atomic_write_text(path, self.to_prometheus(prefix=prefix))


def histogram_quantiles(snap: Dict[str, Any],
                        qs: Tuple[float, ...] = (0.5, 0.95, 0.99),
                        ) -> Dict[float, float]:
    """Estimate quantiles from a :meth:`Histogram.snapshot` by linear
    interpolation within the covering bucket — the same estimate Prometheus'
    ``histogram_quantile`` gives.  Observations in the +Inf bucket clamp to
    the last finite bound; an empty histogram yields 0.0 for every q."""
    bounds, counts = snap["bounds"], snap["counts"]
    total = snap["count"]
    out: Dict[float, float] = {}
    for q in qs:
        if total <= 0:
            out[q] = 0.0
            continue
        rank = q * total
        cum = 0
        val = bounds[-1]
        for i, cnt in enumerate(counts):
            cum += cnt
            if cum >= rank:
                if i < len(bounds):
                    lo = bounds[i - 1] if i > 0 else 0.0
                    frac = (rank - (cum - cnt)) / cnt if cnt else 1.0
                    val = lo + (bounds[i] - lo) * frac
                break
        out[q] = val
    return out


def _fmt_float(v: float) -> str:
    # integral values print without exponent/decimal noise; others use repr
    # (shortest round-trip), matching prometheus client conventions
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


_SAMPLE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"\\]*"(?:,[a-zA-Z_][a-zA-Z0-9_]*='
    r'"[^"\\]*")*\})? (-?(?:[0-9]+(?:\.[0-9]*)?(?:[eE][-+]?[0-9]+)?|inf)'
    r'|\+Inf|-Inf|NaN)$')
_COMMENT = re.compile(r"^# (HELP [a-zA-Z_:][a-zA-Z0-9_:]* .*|TYPE "
                      r"[a-zA-Z_:][a-zA-Z0-9_:]* (counter|gauge|histogram))$")


def parse_prometheus(text: str) -> Dict[str, List[Tuple[str, float]]]:
    """Read a textfile exposition back (what to_prometheus writes): each
    sample line must match the format's ``name{label="v",...} value``,
    each comment a ``# HELP`` or ``# TYPE`` line, and each histogram's
    ``_bucket`` series must be cumulative (non-decreasing up to +Inf).
    Returns {sample name: [(labels, value)]}; raises ValueError naming the
    first line that does not parse."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    for line in text.splitlines():
        if line.startswith("#"):
            if not _COMMENT.match(line):
                raise ValueError(f"not an exposition comment: {line!r}")
            continue
        m = _SAMPLE.match(line)
        if m is None:
            raise ValueError(f"not an exposition sample: {line!r}")
        out.setdefault(m.group(1), []).append((m.group(2) or "",
                                               float(m.group(3))))
    for name, samples in out.items():
        if name.endswith("_bucket"):
            runs: Dict[str, List[float]] = {}
            for labels, v in samples:
                key = re.sub(r',?le="[^"]*"', "", labels)
                runs.setdefault(key, []).append(v)
            for vals in runs.values():
                if vals != sorted(vals):
                    raise ValueError(f"{name}: buckets not cumulative")
    return out
