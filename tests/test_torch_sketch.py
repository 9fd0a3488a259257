"""The port's mergeable bin-finding sketch against the reference's.

``lightgbm_tpu_torch.binning`` ``FeatureSketch``, ``sketch_feature``,
``merge_sketches`` and ``BinMapper.from_sketch`` (the process-spanning bin
finding, A21b) on the cases of tests/test_sketch.py: dense values, ties,
few distinct values, NaN, zeros, categorical, any merge order and any
reduction tree. The port's sketches equal the reference's field for field,
and its mappers from a merge equal, bit for bit, the reference's
``find_bin_mappers`` over the concatenated rows (and the port's own).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu import binning as RB
from lightgbm_tpu.parallel import multihost as RM
from lightgbm_tpu_torch import binning as PB
from lightgbm_tpu_torch.parallel import multihost as PM

# six pytest workers share the box's cores: with torch's default of
# one intra-op thread a core, their OpenMP threads spin against each
# other's, so each test process keeps one
torch.set_num_threads(1)

KINDS = ("dense", "ties", "few", "nan", "zeros")


def _rand_column(rng, n, kind):
    if kind == "dense":
        return rng.randn(n)
    if kind == "ties":
        return np.round(rng.randn(n) * 4) / 4
    if kind == "few":
        return rng.randint(0, 5, n).astype(np.float64)
    v = rng.randn(n)
    if kind == "nan":
        v[rng.rand(n) < 0.1] = np.nan
    else:
        v[rng.rand(n) < 0.5] = 0.0
    return v


def _fields(s):
    return (int(s.bin_type), np.asarray(s.distinct, np.float64).tobytes(),
            np.asarray(s.counts, np.int64).tobytes(), int(s.zero_cnt),
            int(s.na_cnt), int(s.total_cnt))


def _mapper_fields(m):
    return (m.num_bins, m.bin_type, m.missing_type, m.default_bin,
            m.most_freq_bin, m.is_trivial, m.sparse_rate, m.min_value,
            m.max_value, np.asarray(m.upper_bounds, np.float64).tobytes(),
            np.asarray(m.cat_values, np.int64).tobytes())


def _parts(values, cuts, bin_type, pkg):
    return [pkg.sketch_feature(p, len(p), bin_type)
            for p in np.split(values, cuts)]


@pytest.mark.parametrize("kind", KINDS)
def test_sketch_equals_reference(kind):
    rng = np.random.RandomState(2)
    for n in (0, 1, 57, 400):
        v = _rand_column(rng, n, kind)
        for total in (n, n + 13):   # implicit zeros past the values
            assert _fields(PB.sketch_feature(v, total)) == \
                _fields(RB.sketch_feature(v, total))


@pytest.mark.parametrize("kind", KINDS)
def test_merge_order_invariant_and_equal_to_reference(kind):
    rng = np.random.RandomState(3)
    for _ in range(10):
        n = rng.randint(50, 400)
        v = _rand_column(rng, n, kind)
        cuts = np.sort(rng.choice(n, rng.randint(1, 5), replace=False))
        parts = _parts(v, cuts, PB.BIN_NUMERICAL, PB)
        merged = PB.merge_sketches(parts)
        assert _fields(merged) == _fields(RB.merge_sketches(
            _parts(v, cuts, RB.BIN_NUMERICAL, RB)))
        assert _fields(merged) == _fields(PB.sketch_feature(v, n))
        for _ in range(4):
            perm = rng.permutation(len(parts))
            assert _fields(PB.merge_sketches([parts[i] for i in perm])) \
                == _fields(merged)


def test_merge_associative():
    rng = np.random.RandomState(5)
    for _ in range(20):
        n = rng.randint(60, 300)
        v = _rand_column(rng, n, "ties")
        a, b, c = _parts(v, np.sort(rng.choice(n, 2, replace=False)),
                         PB.BIN_NUMERICAL, PB)
        left = PB.merge_sketches([PB.merge_sketches([a, b]), c])
        right = PB.merge_sketches([a, PB.merge_sketches([b, c])])
        assert _fields(left) == _fields(right) == \
            _fields(PB.merge_sketches([a, b, c]))


def test_merge_of_nothing_and_mixed_types():
    assert _fields(PB.merge_sketches([])) == _fields(RB.merge_sketches([]))
    with pytest.raises(ValueError, match="mixed"):
        PB.merge_sketches([PB.FeatureSketch(PB.BIN_NUMERICAL),
                           PB.FeatureSketch(PB.BIN_CATEGORICAL)])


@pytest.mark.parametrize("max_bin", [4, 16, 255])
def test_categorical_merge_and_mapper(max_bin):
    rng = np.random.RandomState(11)
    v = rng.randint(0, 12, 500).astype(np.float64)
    v[rng.rand(500) < 0.05] = np.nan
    parts = np.split(v, [137, 260, 401])
    merged = PB.merge_sketches([PB.sketch_feature(p, len(p),
                                                  PB.BIN_CATEGORICAL)
                                for p in parts])
    assert _fields(merged) == _fields(
        PB.sketch_feature(v, 500, PB.BIN_CATEGORICAL))
    assert _fields(merged) == _fields(RB.merge_sketches(
        [RB.sketch_feature(p, len(p), RB.BIN_CATEGORICAL) for p in parts]))
    got = PB.BinMapper.from_sketch(merged, max_bin, min_data_in_bin=3)
    ref = RB.find_bin_mappers(v.reshape(-1, 1), max_bin=max_bin,
                              categorical=[0])[0]
    assert _mapper_fields(got) == _mapper_fields(ref)


@pytest.mark.parametrize("cuts", [[300, 600], [1, 899], [450],
                                  [123, 456, 789]])
@pytest.mark.parametrize("missing", [
    {}, {"use_missing": False}, {"zero_as_missing": True}])
def test_from_sketch_bit_identical_to_find_bins_on_concat(cuts, missing):
    """Merged-sketch mappers over row splits: bit for bit the reference's
    find_bin_mappers over the whole matrix, every field."""
    rng = np.random.RandomState(13)
    n, max_bin = 900, 16
    X = np.stack([_rand_column(rng, n, k) for k in KINDS], axis=1)
    ref = RB.find_bin_mappers(X, max_bin=max_bin, **missing)
    own = PB.find_bin_mappers(X, max_bin=max_bin, **missing)
    rows = np.split(np.arange(n), cuts)
    for j in range(X.shape[1]):
        merged = PB.merge_sketches([PB.sketch_feature(X[r, j], len(r))
                                    for r in rows])
        m = PB.BinMapper.from_sketch(merged, max_bin, min_data_in_bin=3,
                                     **missing)
        assert _mapper_fields(m) == _mapper_fields(ref[j]), j
        assert _mapper_fields(m) == _mapper_fields(own[j]), j
        r = RB.BinMapper.from_sketch(RB.merge_sketches(
            [RB.sketch_feature(X[i, j], len(i)) for i in rows]), max_bin,
            min_data_in_bin=3, **missing)
        assert _mapper_fields(m) == _mapper_fields(r), j


def test_from_sketch_forced_bounds_and_sampled_rows():
    """Forced bounds replace the found ones, and a sample that leaves rows
    out (implicit zeros) gives the reference's mapper."""
    rng = np.random.RandomState(19)
    v = _rand_column(rng, 700, "zeros")
    s = PB.sketch_feature(v[:600], 700)
    for forced in (None, [-0.5, 0.0, 0.75]):
        got = PB.BinMapper.from_sketch(s, 32, forced_bounds=forced)
        ref = RB.BinMapper.from_sample(v[:600], 700, 32,
                                       forced_bounds=forced)
        assert _mapper_fields(got) == _mapper_fields(ref)


def test_sketch_wire_codec_equals_reference():
    rng = np.random.RandomState(17)
    sketches = [PB.sketch_feature(_rand_column(rng, 333, k), 333)
                for k in KINDS]
    sketches.append(PB.sketch_feature(
        rng.randint(0, 9, 333).astype(np.float64), 333, PB.BIN_CATEGORICAL))
    enc = PM.encode_sketches(sketches)
    ref_enc = RM.encode_sketches([RB.FeatureSketch(
        s.bin_type, s.distinct, s.counts, s.zero_cnt, s.na_cnt, s.total_cnt)
        for s in sketches])
    assert enc.tobytes() == ref_enc.tobytes()
    back = PM.decode_sketches(enc, len(sketches))
    assert [_fields(a) for a in back] == [_fields(a) for a in sketches]
    empty = PM.decode_sketches(PM.encode_sketches([PB.FeatureSketch()]), 1)
    assert _fields(empty[0]) == _fields(PB.FeatureSketch())
