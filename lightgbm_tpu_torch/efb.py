"""Exclusive Feature Bundling (EFB).

Port of ``lightgbm_tpu/efb.py``: ``BundleMeta``, the greedy
conflict-bounded plan ``plan_bundles`` (:63), ``identity_meta`` (:243),
``merge_bundle_meta`` (:276) and the encoder ``apply_bundles`` (:296).
Mutually sparse numerical features share one uint8 column: feature ``j``'s
non-default bins take a contiguous range of positions (ascending original
bin, its default bin skipped), and bundle bin 0 means "every member at its
default". The split search scores each position as the candidate
"original bin <= pos_bin[p]" of its member from the bundle histogram's
prefix sums (``ops/split.py``); a chosen candidate routes as a bin-subset
mask over the bundle column, the membership the categorical splits use,
and ``models/tree.py`` decodes it back to (original feature, real
threshold), so a saved model reads as if trained unbundled.

The plan is made once at construct time from a 50,000-row sample drawn by
``RandomState(data_random_seed)`` (``plan_sample_index``; the reference's
``basic.py:325-328``). Its pairwise conflict counts are exact integers:
the reference sums f32 chunk products on its device in f64; here one f64
BLAS product of the 0/1 sample mask gives the same integers (each below
2^53). ``apply_bundles`` encodes binned rows on their device;
``encode_sparse`` encodes a scipy CSC matrix column by column straight
into its bundle columns, so the unbundled ``[N, F]`` matrix never exists.
A later member overwrites an earlier one on a conflicting row in both, as
in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .binning import (BIN_CATEGORICAL, MISSING_NONE, BinMapper,
                      sparse_column_bins)
from .log import info

PLAN_SAMPLE = 50_000       # the reference's EFB plan sample (basic.py:506)
MAX_BUNDLE_BINS = 256
_B = 256                   # width of the per-position arrays
_CHUNK = 8192              # rows of the sample mask a conflict product


@dataclass
class BundleMeta:
    """Static description of the bundled feature space (arrays [F_b, 256]
    but default_bin [F_used], is_bundle and num_bins [F_b])."""
    members: List[List[Tuple[int, int, int]]]  # per column: (feat, off, nb)
    default_bin: np.ndarray   # [F_used] default (most frequent) bin
    pos_feat: np.ndarray      # used feature of each bundle position
    pos_bin: np.ndarray       # original threshold bin of the candidate at p
    range_start: np.ndarray   # first position of the range holding p
    range_end: np.ndarray     # last position of that range
    prefix_end: np.ndarray    # last prefix position the candidate at p takes
    incl_default: np.ndarray  # bool: the candidate at p sends the default left
    valid: np.ndarray         # bool: p is a split candidate
    is_bundle: np.ndarray     # [F_b] bool: two or more members
    num_bins: np.ndarray      # [F_b]

    @property
    def num_columns(self) -> int:
        return len(self.members)


def plan_sample_index(n_rows: int, seed: int) -> Optional[np.ndarray]:
    """Row indices of the plan sample (None: every row)."""
    if n_rows <= PLAN_SAMPLE:
        return None
    return np.random.RandomState(seed).choice(n_rows, PLAN_SAMPLE,
                                              replace=False)


def _conflicts(sub: np.ndarray, cols: Sequence[int],
               default_bin: np.ndarray) -> np.ndarray:
    """[Fc, Fc] int64 counts of sample rows non-default in both features."""
    db = default_bin[list(cols)][None, :]
    conf = np.zeros((len(cols), len(cols)), dtype=np.float64)
    for s0 in range(0, sub.shape[0], _CHUNK):
        nz = (sub[s0:s0 + _CHUNK][:, cols] != db).astype(np.float64)
        conf += nz.T @ nz
    return conf.astype(np.int64)


def plan_bundles(bins: np.ndarray, mappers: Sequence[BinMapper],
                 max_conflict_rate: float = 0.0,
                 sparse_threshold: float = 0.8,
                 max_bundle_bins: int = MAX_BUNDLE_BINS,
                 sample_cnt: int = PLAN_SAMPLE, seed: int = 0,
                 exclude: Sequence[int] = (),
                 reduce_fn=None) -> Optional[BundleMeta]:
    """Greedy conflict-bounded bundling plan over binned rows ``bins``
    [n, F_used] uint8 (reference: plan_bundles, efb.py:63): the candidates
    are numerical features without a missing bin whose most frequent bin
    holds at least ``sparse_threshold`` of the sample; by descending
    non-default count (ties by index), each joins the first bundle whose
    bins stay under ``max_bundle_bins`` and whose summed pairwise conflicts
    stay within ``max_conflict_rate`` of the sample. None when no bundle
    has two members. ``exclude``: features kept out of bundles.
    ``reduce_fn`` sums a count array across the ranks of a
    multi-process run (every quantity of the greedy is a count), so that
    each rank plans from the whole sample and all plan alike
    (reference: efb.py:63-75)."""
    n, f = bins.shape
    rng = np.random.RandomState(seed)
    sample_idx = (np.arange(n) if n <= sample_cnt
                  else rng.choice(n, sample_cnt, replace=False))
    sub = bins[sample_idx]
    maxb = max((m.num_bins for m in mappers), default=1)
    counts = np.zeros((f, maxb), dtype=np.int64)
    for j in range(f):
        counts[j] = np.bincount(sub[:, j], minlength=maxb)[:maxb]
    if reduce_fn is not None:
        counts = reduce_fn(counts)
    total = float(counts[0].sum()) if f else 0.0
    max_conflicts = max_conflict_rate * total

    default_bin = np.zeros(f, dtype=np.int32)
    cand = []
    excluded = set(exclude)
    for j, m in enumerate(mappers):
        if (m.bin_type == BIN_CATEGORICAL or m.missing_type != MISSING_NONE
                or m.num_bins < 2 or j in excluded):
            continue
        db = int(counts[j].argmax())
        if counts[j, db] / max(total, 1.0) < sparse_threshold:
            continue
        default_bin[j] = db
        cand.append((j, total - float(counts[j, db])))
    if len(cand) < 2:
        return None
    cj = [j for j, _ in cand]
    conf = _conflicts(sub, cj, default_bin)
    if reduce_fn is not None:
        conf = reduce_fn(conf)
    cidx = {j: k for k, j in enumerate(cj)}

    # greedy first-fit by non-default count, descending (dataset.cpp:120)
    cand.sort(key=lambda t: (-t[1], t[0]))
    bundles: List[List[int]] = []
    conflict: List[int] = []
    nbins: List[int] = []
    for j, _ in cand:
        extra = mappers[j].num_bins - 1
        for bi, members in enumerate(bundles):
            if nbins[bi] + extra > max_bundle_bins - 1:
                continue
            inter = int(conf[[cidx[i] for i in members], cidx[j]].sum())
            if conflict[bi] + inter <= max_conflicts:
                members.append(j)
                conflict[bi] += inter
                nbins[bi] += extra
                break
        else:
            bundles.append([j])
            conflict.append(0)
            nbins.append(extra)

    multi = [sorted(b) for b in bundles if len(b) >= 2]
    if not multi:
        return None
    bundled = set(j for b in multi for j in b)
    columns = [[(j, 0, mappers[j].num_bins)] for j in range(f)
               if j not in bundled]
    for b in multi:
        offs, mem = 1, []
        for j in b:
            mem.append((j, offs, mappers[j].num_bins))
            offs += mappers[j].num_bins - 1
        columns.append(mem)
    meta = _columns_meta(columns, default_bin)
    info(f"EFB: bundled {len(bundled)} sparse features into {len(multi)} "
         f"columns ({f} -> {meta.num_columns} total)")
    return meta


def _columns_meta(columns: List[List[Tuple[int, int, int]]],
                  default_bin: np.ndarray) -> BundleMeta:
    """The per-position arrays of a plan's columns (efb.py:185-236)."""
    fb = len(columns)
    pos_feat = np.zeros((fb, _B), dtype=np.int32)
    pos_bin = np.zeros((fb, _B), dtype=np.int32)
    range_start = np.zeros((fb, _B), dtype=np.int32)
    range_end = np.zeros((fb, _B), dtype=np.int32)
    prefix_end = np.zeros((fb, _B), dtype=np.int32)
    incl_default = np.zeros((fb, _B), dtype=bool)
    valid = np.zeros((fb, _B), dtype=bool)
    is_bundle = np.zeros(fb, dtype=bool)
    num_bins = np.zeros(fb, dtype=np.int32)
    for c, mem in enumerate(columns):
        if len(mem) == 1:
            # a single column: the numerical scan searches it
            j, _, nb = mem[0]
            num_bins[c] = nb
            pos_feat[c] = j
            pos_bin[c] = np.arange(_B)
            range_end[c] = nb - 1
            continue
        is_bundle[c] = True
        num_bins[c] = 1 + sum(nb - 1 for _, _, nb in mem)
        pos_feat[c] = mem[0][0]
        for j, off, nb in mem:
            db = int(default_bin[j])
            end = off + nb - 2
            ob = np.asarray([bb for bb in range(nb) if bb != db])
            pos_feat[c, off:end + 1] = j
            pos_bin[c, off:end + 1] = ob
            range_start[c, off:end + 1] = off
            range_end[c, off:end + 1] = end
            prefix_end[c, off:end + 1] = np.arange(off, end + 1)
            incl_default[c, off:end + 1] = ob >= db
            # p < end: the threshold ob[p - off], the prefix through p;
            # p == end would send every position left, so unless the
            # default is the last bin it hosts "t == default": the bins
            # below the default (an empty prefix at default 0) and the
            # default side
            valid[c, off:end + 1] = True
            if db < nb - 1:
                pos_bin[c, end] = db
                prefix_end[c, end] = off + db - 1
                incl_default[c, end] = True
    return BundleMeta(members=columns, default_bin=default_bin,
                      pos_feat=pos_feat, pos_bin=pos_bin,
                      range_start=range_start, range_end=range_end,
                      prefix_end=prefix_end, incl_default=incl_default,
                      valid=valid, is_bundle=is_bundle, num_bins=num_bins)


def identity_meta(mappers: Sequence[BinMapper]) -> BundleMeta:
    """The plan that gives every used feature its own column (reference:
    efb.py:243), for merging a bundled and an unbundled Dataset."""
    return _columns_meta([[(j, 0, m.num_bins)] for j, m in enumerate(mappers)],
                         np.zeros(len(mappers), dtype=np.int32))


def merge_bundle_meta(a: BundleMeta, b: BundleMeta,
                      n_used_a: int) -> BundleMeta:
    """Two plans side by side; ``b``'s member features shift by
    ``n_used_a``, the first Dataset's used-feature count (reference:
    efb.py:276)."""
    members = a.members + [[(j + n_used_a, off, nb) for j, off, nb in mem]
                           for mem in b.members]
    return BundleMeta(
        members=members,
        default_bin=np.concatenate([a.default_bin, b.default_bin]),
        pos_feat=np.vstack([a.pos_feat, b.pos_feat + n_used_a]),
        **{k: np.vstack([getattr(a, k), getattr(b, k)])
           for k in ("pos_bin", "range_start", "range_end", "prefix_end",
                     "incl_default", "valid")},
        is_bundle=np.concatenate([a.is_bundle, b.is_bundle]),
        num_bins=np.concatenate([a.num_bins, b.num_bins]))


def _position(bins: torch.Tensor, off: int, db: int) -> torch.Tensor:
    """A member's bundle position of each of its bins (the default bin has
    none)."""
    return off + torch.where(bins < db, bins, bins - 1)


def apply_bundles(bins: torch.Tensor, meta: BundleMeta) -> torch.Tensor:
    """The bundled uint8 [N, F_b] matrix of binned rows ``bins`` [N, F_used]
    uint8, on their device (reference: apply_bundles, efb.py:296)."""
    n = bins.shape[0]
    out = torch.empty((n, meta.num_columns), dtype=torch.uint8,
                      device=bins.device)
    for c, mem in enumerate(meta.members):
        if len(mem) == 1:
            out[:, c] = bins[:, mem[0][0]]
            continue
        col = torch.zeros(n, dtype=torch.int64, device=bins.device)
        for j, off, _ in mem:
            db = int(meta.default_bin[j])
            bj = bins[:, j].to(torch.int64)
            col = torch.where(bj != db, _position(bj, off, db), col)
        out[:, c] = col.to(torch.uint8)
    return out


def encode_sparse(csc, mappers: Sequence[BinMapper],
                  feature_map: Sequence[int], meta: BundleMeta,
                  device: torch.device) -> torch.Tensor:
    """The bundled uint8 [N, F_b] matrix of a scipy CSC matrix (raw
    columns ``feature_map`` binned by ``mappers``), equal to
    ``apply_bundles`` of its unbundled bins: each column's stored values
    are binned on ``device`` and written into its bundle column; an absent
    entry has the bin of 0.0."""
    n = csc.shape[0]
    out = torch.empty((n, meta.num_columns), dtype=torch.uint8,
                      device=device)
    for c, mem in enumerate(meta.members):
        col = torch.zeros(n, dtype=torch.int64, device=device)
        for j, off, _ in mem:
            rows, bj, zero_bin = sparse_column_bins(
                mappers[j], csc, int(feature_map[j]), device)
            if len(mem) == 1:
                col.fill_(zero_bin)
                col[rows] = bj
                continue
            db = int(meta.default_bin[j])
            if zero_bin != db:
                # the bin of 0.0 is not the default: the member writes
                # every row but its stored default ones
                kept = col[rows]
                col.fill_(off + (zero_bin if zero_bin < db else zero_bin - 1))
                col[rows] = torch.where(bj != db, _position(bj, off, db),
                                        kept)
            else:
                nz = bj != db
                col[rows[nz]] = _position(bj[nz], off, db)
        out[:, c] = col.to(torch.uint8)
    return out
