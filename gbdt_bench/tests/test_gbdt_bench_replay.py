"""``replay_pass_share`` on hand-built profiles: replayed passes over all
level passes, and nothing from a program that replays none."""
import types

import pytest

from gbdt_bench.tests._tiny import ROOT  # noqa: F401
from gbdt_bench import trace
from gbdt_bench.layer_metrics import replay_pass_share


def _ua(name, s, e):
    return ("user_annotation", name, s, e)


def _profile(replayed, eager):
    """One tree of ``eager`` eager passes, then ``replayed`` replays."""
    host = [_ua("boosting", 0.0, 100.0), _ua("grow.tree", 1.0, 99.0),
            _ua("grow.front", 1.0, 2.0)]
    t = 2.0
    for i in range(eager + replayed):
        host.append(_ua("grow.pass", t, t + 1.0))
        if i < eager:
            host += [_ua("pass.apply", t, t + 0.3),
                     _ua("pass.hist", t + 0.3, t + 0.6),
                     _ua("pass.search", t + 0.6, t + 1.0)]
        else:
            host.append(_ua("pass.replay", t, t + 0.8))
            host.append(_ua("sync.select", t + 0.8, t + 0.9))
        t += 1.0
    return trace.Profile(1, [("kernel", "k", 0.5, 1.5)], host, (0.0, 100.0))


def _read(p):
    return replay_pass_share.read(types.SimpleNamespace(profile=p))


@pytest.mark.parametrize("replayed,eager", [(9, 0), (8, 1), (3, 6)])
def test_share_of_replayed_passes(replayed, eager):
    assert _read(_profile(replayed, eager)) == pytest.approx(
        replayed / (replayed + eager))


def test_a_program_that_replays_no_pass_reports_nothing():
    assert _read(_profile(0, 9)) is None
    assert _read(None) is None
    bare = trace.Profile(1, [], [_ua("boosting", 0.0, 1.0)], (0.0, 1.0))
    assert _read(bare) is None
