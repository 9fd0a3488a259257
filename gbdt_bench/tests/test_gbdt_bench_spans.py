"""The readers of the program's spans (gbdt_bench/spans.py and the six
span metrics) on hand-built profiles with known spans, kernels and gaps."""
import random
import types

import pytest

from gbdt_bench.tests._tiny import ROOT  # noqa: F401
from gbdt_bench import spans, trace
from gbdt_bench.layer_metrics import (apply_idle_ms, hist_pass_idle_ms,
                                      host_syncs_per_iter,
                                      outside_pass_idle_ms, search_idle_ms,
                                      sync_wait_ms)

IDLE = (search_idle_ms, apply_idle_ms, hist_pass_idle_ms,
        outside_pass_idle_ms)
READERS = IDLE + (host_syncs_per_iter, sync_wait_ms)


def _ua(name, s, e):
    return ("user_annotation", name, s, e)


def _profile(iterations=2):
    """One boosting range of a tree with two level passes, then eval; the
    device busy in seven stretches (times in seconds)."""
    host = [_ua("boosting", 0.0, 10.0), _ua("eval", 10.0, 12.0),
            _ua("grow.tree", 1.0, 9.0), _ua("grow.front", 1.0, 2.0),
            _ua("grow.pass", 2.0, 6.0), _ua("pass.apply", 2.0, 3.0),
            _ua("pass.hist", 3.0, 4.5), _ua("pass.apply", 4.5, 5.0),
            _ua("pass.search", 5.0, 6.0), _ua("sync.select", 5.5, 5.8),
            _ua("grow.pass", 6.0, 8.5), _ua("pass.apply", 6.0, 7.0),
            _ua("sync.apply", 6.2, 6.3), _ua("pass.hist", 7.0, 7.5),
            # 7.5 .. 7.6: between two phases of the pass
            _ua("pass.apply", 7.6, 8.0), _ua("pass.search", 8.0, 8.5),
            _ua("grow.leaf_renew", 8.5, 9.0),
            _ua("iter.score_update", 9.0, 9.7),
            _ua("sync.shrink", 9.0, 9.1), _ua("sync.route", 9.5, 9.6),
            _ua("sync.finite", 9.8, 9.9), _ua("sync.metric", 11.0, 11.5),
            ("cpu_op", "aten::nonzero", 5.5, 5.8)]
    dev = [("kernel", "k", s, e) for s, e in
           ((0.5, 1.5), (2.5, 3.5), (4.0, 4.2), (5.2, 5.5), (7.2, 7.55),
            (9.2, 9.4), (11.2, 11.4), (15.0, 20.0))]
    return trace.Profile(iterations, dev, host, (0.0, 20.0))


def _ctx(p):
    return types.SimpleNamespace(profile=p)


def _idle_in_boosting(p):
    ranges = spans.spans(p, "boosting")
    return sum(max(0.0, min(e, g1) - max(s, g0))
               for g0, g1 in trace.idle_gaps(p) for s, e in ranges)


def test_each_reader_reads_its_spans():
    ctx = _ctx(_profile())
    # per iteration (2): idle pieces cut at the spans' edges
    assert search_idle_ms.read(ctx) == pytest.approx(1.2 / 2 * 1e3)
    assert apply_idle_ms.read(ctx) == pytest.approx(2.45 / 2 * 1e3)
    assert hist_pass_idle_ms.read(ctx) == pytest.approx(1.0 / 2 * 1e3)
    assert outside_pass_idle_ms.read(ctx) == pytest.approx(2.3 / 2 * 1e3)
    # six sync spans, 1.2 s inside them, eval's read included
    assert host_syncs_per_iter.read(ctx) == pytest.approx(3.0)
    assert sync_wait_ms.read(ctx) == pytest.approx(1.2 / 2 * 1e3)


def test_the_idle_parts_sum_to_the_idle_inside_boosting():
    p = _profile()
    total = sum(m.read(_ctx(p)) for m in IDLE)
    assert _idle_in_boosting(p) == pytest.approx(6.95)
    assert abs(total - _idle_in_boosting(p) / 2 * 1e3) < 1e-9


def test_random_nested_spans_and_kernels_sum_to_the_idle():
    rng = random.Random(3)
    for _ in range(20):
        host, dev, t = [], [], 0.0
        for _it in range(3):
            b0 = t
            t += rng.random()
            tree0 = t
            for _p in range(rng.randint(0, 6)):
                p0 = t
                for ph in rng.choices(spans.PHASES, k=rng.randint(1, 5)):
                    s = t + rng.random() * 0.01
                    t = s + rng.random()
                    host.append(_ua(ph, s, t))
                    if rng.random() < 0.5:
                        host.append(_ua("sync.x", s, (s + t) / 2))
                t += rng.random() * 0.01
                host.append(_ua("grow.pass", p0, t))
            t += rng.random()
            host.append(_ua("grow.tree", tree0, t))
            host.append(_ua("boosting", b0, t))
            host.append(_ua("eval", t, t + 0.5))
            t += 0.5
        for _k in range(200):
            s = rng.random() * t
            dev.append(("kernel", "k", s, s + rng.random() * 0.05))
        p = trace.Profile(3, dev, host, (0.0, t))
        total = sum(m.read(_ctx(p)) for m in IDLE)
        assert abs(total - _idle_in_boosting(p) / 3 * 1e3) < 1e-9


def test_a_program_without_its_spans_reports_nothing():
    p = _profile()
    bare = trace.Profile(2, p.device,
                         [h for h in p.host if h[1] in ("boosting", "eval")
                          or h[0] != "user_annotation"], p.window)
    for m in READERS:
        assert m.read(_ctx(bare)) is None, m.__name__
        assert m.read(_ctx(None)) is None, m.__name__
    # the spans present and no idle time or sync: 0, not None
    busy = trace.Profile(1, [("kernel", "k", 0.0, 20.0)],
                         [h for h in p.host if not h[1].startswith("sync.")],
                         p.window)
    assert [m.read(_ctx(busy)) for m in READERS] == [0.0] * 6
