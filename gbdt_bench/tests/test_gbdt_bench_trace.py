"""The trace reduction and the needed-work count on hand-built inputs."""
import numpy as np
import pytest

from gbdt_bench.tests._tiny import ROOT  # noqa: F401
from gbdt_bench import trace
from gbdt_bench.hw import kernel_part
from gbdt_bench.reference.trees import Tree
from gbdt_bench.work.needed import (Shape, hist_bytes, iteration_work,
                                     levels, searched_levels)


def _profile():
    dev = [("kernel", "void hist_q8_kernel<3, 64>(int const*, float*)",
            1.0, 3.0),
           ("kernel", "void at::native::elementwise_kernel<128>(int)",
            2.0, 4.0),            # overlaps the first: union 1..4
           ("gpu_memcpy", "Memcpy DtoH", 6.0, 7.0)]
    host = [("user_annotation", "boosting", 0.0, 8.0),
            ("cpu_op", "aten::nonzero", 4.0, 6.0),
            ("cuda_runtime", "cudaStreamSynchronize", 4.5, 5.5),
            ("user_annotation", "eval", 8.0, 10.0)]
    return trace.Profile(2, dev, host, (0.0, 10.0))


def test_busy_is_the_union_not_the_sum():
    p = _profile()
    assert trace.busy_s(p) == pytest.approx(3.0 + 1.0)
    assert trace.idle_gaps(p) == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]


def test_gaps_are_named_by_the_host_range_and_innermost_call():
    p = _profile()
    b = trace.breakdown(p)
    assert b["idle_gaps"][0] == ["eval", 3.0]
    assert b["idle_gaps"][1] == ["boosting/cudaStreamSynchronize", 2.0]
    labels = [k for k, _ in b["device_ops"]]
    assert labels[0] == "B5 hist_q8" and "gpu_memcpy" in labels
    assert trace.device_seconds(p, True) == pytest.approx(2.0)
    assert trace.device_seconds(p, False) == pytest.approx(2.0)
    assert trace.range_seconds(p, "eval") == pytest.approx(2.0)


def test_kernel_names_of_the_port_with_and_without_templates():
    assert kernel_part("hist_routed_kernel(int, float*)") == \
        "B2 hist_routed_fused"
    assert kernel_part("void take_kernel<float>(float const*, int)") == \
        "B4 take_small"
    assert kernel_part("void at::native::reduce_kernel<512, 1>(int)") is None


def _tree():
    # root 0 splits 100 rows into node 1 (60) and leaf 2 (40); node 1 into
    # leaves 0 (45) and 1 (15)
    return Tree(feature=np.array([0, 1]), threshold=np.array([3, 5]),
                left=np.array([1, ~0]), right=np.array([~2, ~1]),
                leaf_value=np.zeros(3, np.float32),
                leaf_count=np.array([45.0, 15.0, 40.0]),
                internal_count=np.array([100.0, 60.0]), num_leaves=3)


def test_needed_work_counts_the_root_and_each_smaller_child():
    t = _tree()
    assert levels(t) == [[0], [1]]
    s = Shape(rows_train=100, rows_valid=10, features=4, bins=64,
              chan_bytes=2, num_leaves=255)
    # root 100 rows, then the smaller children: 40 at level 0, 15 at 1
    assert hist_bytes(t, s) == (100 + 40 + 15) * (4 + 2)
    nbytes, ops = iteration_work(t, s)
    mean_path = (2 * 45 + 2 * 15 + 1 * 40) / 100
    want = ((100 + 40 + 15) * 6 + (100 + 60) * 9 + 100 * (8 + 2)
            + 100 * 12 + 100 * 12 + 10 * (8 + mean_path) + 10 * 8)
    assert nbytes == pytest.approx(want)
    assert ops > 0


def test_needed_work_leaves_out_the_children_past_the_leaf_budget():
    t = _tree()
    # with a budget of 3 the tree is full after level 1: the children of
    # level 1 are never searched; with 2, after level 0 already
    s = Shape(rows_train=100, rows_valid=10, features=4, bins=64,
              chan_bytes=2, num_leaves=3)
    assert searched_levels(t, 3) == [[0]]
    assert hist_bytes(t, s) == (100 + 40) * (4 + 2)
    full = Shape(**{**s.__dict__, "num_leaves": 255})
    nbytes, ops = iteration_work(t, s)
    nbytes_full, ops_full = iteration_work(t, full)
    # 15 rows of histogram fewer, and two children of 64 bins unsearched
    assert nbytes_full - nbytes == pytest.approx(15 * 6)
    assert ops_full - ops == pytest.approx(3.0 * 15 * 4
                                           + 20.0 * 2 * 4 * 64)
    assert searched_levels(t, 2) == []
    assert hist_bytes(t, Shape(**{**s.__dict__, "num_leaves": 2})) == 100 * 6
