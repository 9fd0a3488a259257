"""Vectorized best-split search over histograms.

Port of ``lightgbm_tpu/ops/split.py`` ``best_split`` (:218) for the slice's
path: numerical features, both missing-direction planes, the L1/L2 terms,
``max_delta_step``, ``min_data_in_leaf``, ``min_sum_hessian_in_leaf``,
``min_gain_to_split`` and the lowest-index election inside the ``TIE_RTOL``
gain band; and categorical features (``SplitParams.cat_features``,
:354-451): the one-hot scan at ``num_bins <= max_cat_to_onehot`` and the
sorted k-subset scan in ascending and descending order of g / (h +
cat_smooth), with ``cat_l2``, ``cat_smooth``, ``max_cat_threshold`` and
``min_data_per_group``, decoded into ``SplitResult.is_cat`` and the
``cat_member [L, B]`` bins that go left (:528-566); and the EFB bundle
columns (``SplitParams.has_bundles`` with ``BundleArrays``, :450-495):
each bundle position is its member's candidate "original bin <=
pos_bin", its left side a range of the column's prefix sums plus, when the
threshold covers the member's default bin, everything outside that range;
the winner routes as the bin-subset ``cat_member`` (:569-591); and the
split constraints (:254-345, :437-446, :478-495, :593-603): per-leaf
monotone output bounds (``leaf_min``/``leaf_max``) with the gains at the
clamped outputs and the direction filter of ``monotone_constraints`` on
the numerical planes (the bundle plane clamps, the categorical ones do
not), ``feature_contri`` rewriting every plane to the penalized
improvement ``contri * (gain - parent - min_gain_to_split)``, a CEGB
``gain_penalty`` [L, F] subtracted from every plane, and extra_trees
keeping one threshold per (leaf, feature) on the numerical planes, drawn
from ``rand_key`` on the threefry replica (:314-325). The whole
``[L, 3, F, B]`` frontier is searched at once: prefix sums over the bin
axis give the left-side stats of every threshold, and one masked election
over the sections ``[num_r, num_l, onehot, asc, desc, bundle]`` picks each
leaf's split, so the lowest flat index wins a tie as in the reference.

Every f32 operation is the reference's, in its order; the bin-axis prefix
sums use the reference's summation order (``scan.blocked_cumsum``), so on
the same histograms the split records agree bit for bit. The reference
ranks the categories with ``[L, Fc, B, B]`` compare and one-hot tensors;
here a stable sort gives the same order (equal means by bin index,
invalid bins last) and a gather the same sorted stats.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from ..utils import threefry
from .scan import blocked_cumsum

NEG_INF = -1e30
# relative half-width of the split-gain tie band: candidates closer than
# this are tied and the lowest flat (plane, feature, bin) index wins
TIE_RTOL = 1e-6
_EPS_H = 1e-38


@dataclass(frozen=True)
class SplitParams:
    """Static split hyperparameters (subset of the reference Config)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_gain_to_split: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    max_delta_step: float = 0.0
    # the categorical features' indices (empty: numerical search only)
    cat_features: tuple = ()
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100
    # the Dataset has EFB bundle columns (searched through BundleArrays)
    has_bundles: bool = False
    # per-column monotone constraints (-1 / 0 / +1; empty: off)
    monotone_constraints: tuple = ()
    # per-column split-gain multipliers (feature_contri; empty: off)
    feature_contri: tuple = ()
    # extremely randomized trees: one random threshold per (leaf, feature)
    # on the numerical planes, drawn from a ``rand_key`` of extra_seed
    extra_trees: bool = False
    extra_seed: int = 6
    # CEGB: the penalty vectors ride along in the grower's CEGBState;
    # these gate the penalty plane's terms
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    cegb_coupled: bool = False
    cegb_lazy: bool = False
    # the lean grower's feature tiles (grow_depthwise._tile_split_params):
    # keep the leaf output clamp and the contri rewrite on in a tile whose
    # own slice of the constraints is trivial, so that every tile's gains
    # are on one scale
    monotone_clamp: bool = False
    contri_active: bool = False

    @property
    def has_monotone(self) -> bool:
        return (any(m != 0 for m in self.monotone_constraints)
                or self.monotone_clamp)

    @property
    def has_contri(self) -> bool:
        return (any(c != 1.0 for c in self.feature_contri)
                or self.contri_active)

    def contri_array(self, f: int, device=None) -> torch.Tensor:
        """[F] f32 gain multipliers: the tuple clamped at 0 and padded
        with 1.0 to width f."""
        out = torch.ones(f, dtype=torch.float32)
        vals = torch.tensor(self.feature_contri, dtype=torch.float32)
        vals = torch.clamp(vals, min=0.0)[:f]
        out[: vals.numel()] = vals
        return out.to(device) if device is not None else out

    def monotone_array(self, f: int, device=None) -> torch.Tensor:
        """[F] i64 constraints padded with 0 to width f."""
        out = torch.zeros(f, dtype=torch.int64)
        vals = torch.tensor(self.monotone_constraints, dtype=torch.int64)[:f]
        out[: vals.numel()] = vals
        return out.to(device) if device is not None else out

    @property
    def has_cegb(self) -> bool:
        return (self.cegb_penalty_split > 0.0 or self.cegb_coupled
                or self.cegb_lazy)


class BundleArrays(NamedTuple):
    """The EFB plan's per-position arrays on the device (``efb.BundleMeta``
    sliced to the grower's bin axis), all [F, B] but is_bundle [F]."""
    range_start: torch.Tensor
    range_end: torch.Tensor
    prefix_end: torch.Tensor
    incl_default: torch.Tensor
    valid: torch.Tensor
    is_bundle: torch.Tensor


class SplitResult(NamedTuple):
    """Best split per leaf (reference analog: SplitInfo). All [L] but
    cat_member [L, B]. A categorical split (is_cat) sends the bins of
    cat_member left and every other bin right; its ``bin`` is the subset
    size - 1, or the one-hot bin; a bundle split (is_cat too) sends its
    range and, with its default, the bins outside it left, and its
    ``feature`` and ``bin`` are the bundle column and position."""
    gain: torch.Tensor          # improvement; NEG_INF where no split
    feature: torch.Tensor       # i64
    bin: torch.Tensor           # i64 threshold bin (left if bin <= threshold)
    default_left: torch.Tensor  # bool: missing values go left
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_cnt: torch.Tensor
    is_cat: torch.Tensor        # bool
    cat_member: torch.Tensor    # [L, B] bool (all False but on is_cat)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp(s.abs() - l1, min=0.0)


def leaf_output(sum_g: torch.Tensor, sum_h: torch.Tensor,
                p: SplitParams) -> torch.Tensor:
    """Optimal leaf value -G / (H + lambda_l2), clipped by max_delta_step."""
    w = -threshold_l1(sum_g, p.lambda_l1) / (sum_h + p.lambda_l2 + _EPS_H)
    if p.max_delta_step > 0.0:
        w = torch.clamp(w, -p.max_delta_step, p.max_delta_step)
    return w


def leaf_gain_given_output(sum_g: torch.Tensor, sum_h: torch.Tensor,
                           output: torch.Tensor,
                           p: SplitParams) -> torch.Tensor:
    """Gain of a leaf whose output is fixed (clamped by monotone bounds)."""
    sg = threshold_l1(sum_g, p.lambda_l1)
    return -(2.0 * sg * output + (sum_h + p.lambda_l2) * output * output)


def leaf_split_gain(sum_g: torch.Tensor, sum_h: torch.Tensor,
                    p: SplitParams) -> torch.Tensor:
    """Gain contribution of a leaf (no 1/2 factor, as the reference)."""
    if p.max_delta_step <= 0.0:
        sg = threshold_l1(sum_g, p.lambda_l1)
        return sg * sg / (sum_h + p.lambda_l2 + _EPS_H)
    return leaf_gain_given_output(sum_g, sum_h,
                                  leaf_output(sum_g, sum_h, p), p)


def per_feature_gains(hist: torch.Tensor, num_bins: torch.Tensor,
                      na_bin: torch.Tensor, parent_g: torch.Tensor,
                      parent_h: torch.Tensor, parent_cnt: torch.Tensor,
                      p: SplitParams) -> torch.Tensor:
    """Each feature's best numerical gain [L, F], the voting-parallel
    learner's vote (reference: ``per_feature_gains``, split.py:179-215):
    numerical planes only, missing rows to the right, the gain rewritten
    under feature_contri as the final search ranks it. hist [L, 3, F, B];
    parent_* [L]."""
    L, _, f, b = hist.shape
    dev = hist.device
    iota = torch.arange(b, device=dev)[None, None, :]
    na_sel = iota == na_bin.to(torch.int64)[None, :, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    cum = blocked_cumsum(torch.where(na_sel[:, None], zero, hist))
    lg, lh, lc = cum[:, 0], cum[:, 1], cum[:, 2]
    pg, ph, pc = (x[:, None, None] for x in (parent_g, parent_h, parent_cnt))
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    ok = ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
          & (lh >= p.min_sum_hessian_in_leaf)
          & (rh >= p.min_sum_hessian_in_leaf)
          & (iota < num_bins.to(torch.int64)[None, :, None] - 1) & ~na_sel)
    gain = leaf_split_gain(lg, lh, p) + leaf_split_gain(rg, rh, p)
    best = torch.where(ok, gain, torch.full_like(gain, NEG_INF)).amax(-1)
    if p.has_contri:
        parent = leaf_split_gain(parent_g, parent_h, p)
        best = p.contri_array(f, dev)[None, :] * (
            best - parent[:, None] - p.min_gain_to_split)
    return best


def best_split(hist: torch.Tensor, num_bins: torch.Tensor,
               na_bin: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_cnt: torch.Tensor,
               feature_mask: torch.Tensor, p: SplitParams,
               allow_split: torch.Tensor,
               bundle: Optional[BundleArrays] = None,
               leaf_min: Optional[torch.Tensor] = None,
               leaf_max: Optional[torch.Tensor] = None,
               gain_penalty: Optional[torch.Tensor] = None,
               rand_key: Optional[threefry.Key] = None) -> SplitResult:
    """Best split of every leaf of a frontier.

    hist [L, 3, F, B] channel-major (grad, hess, count) f32; num_bins [F]
    bins per feature; na_bin [F] missing-bin index (>= B when none);
    parent_g/h/cnt and allow_split [L]; feature_mask [F] bool, or [L, F]
    for a mask per leaf (feature_fraction_bynode); ``bundle`` the EFB
    arrays when ``p.has_bundles``. Under ``p.has_monotone``, ``leaf_min``
    / ``leaf_max`` [L] bound each leaf's outputs (unbounded when None);
    ``gain_penalty`` [L, F] is subtracted from every candidate of that
    (leaf, feature) (CEGB); under ``p.extra_trees``, ``rand_key`` draws
    the one threshold each (leaf, feature) may take."""
    L, _, f, b = hist.shape
    dev = hist.device
    iota = torch.arange(b, device=dev)[None, None, :]              # [1,1,B]
    na = na_bin.to(torch.int64)[None, :, None]                    # [1,F,1]
    na_sel = iota == na                                           # [1,F,B]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    masked = torch.where(na_sel[:, None], zero, hist)
    na_stats = torch.where(na_sel[:, None], hist, zero).sum(dim=3)  # [L,3,F]
    cum = blocked_cumsum(masked)                                  # [L,3,F,B]
    pg = parent_g[:, None, None]
    ph = parent_h[:, None, None]
    pc = parent_cnt[:, None, None]
    mono = None
    if p.has_monotone:
        inf = torch.full((L, 1, 1), float("inf"), device=dev)
        lmin = -inf if leaf_min is None else leaf_min.reshape(L, 1, 1)
        lmax = inf if leaf_max is None else leaf_max.reshape(L, 1, 1)
        mono = p.monotone_array(f, dev)[None, :, None]

    def clamped_gains(lg, lh, rg, rh):
        """The gain at the outputs clamped to the leaf's bounds, and the
        clamped (left, right) outputs."""
        wl = torch.clamp(leaf_output(lg, lh, p), lmin, lmax)
        wr = torch.clamp(leaf_output(rg, rh, p), lmin, lmax)
        return (leaf_gain_given_output(lg, lh, wl, p)
                + leaf_gain_given_output(rg, rh, wr, p)), wl, wr

    def gains_of(lg, lh, lc):
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        ok = ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
              & (lh >= p.min_sum_hessian_in_leaf)
              & (rh >= p.min_sum_hessian_in_leaf))
        if mono is not None:
            # the direction filter: an increasing feature may not send
            # the larger output left
            gain, wl, wr = clamped_gains(lg, lh, rg, rh)
            ok = ok & ~(((mono > 0) & (wl > wr)) | ((mono < 0) & (wl < wr)))
        else:
            gain = leaf_split_gain(lg, lh, p) + leaf_split_gain(rg, rh, p)
        return torch.where(ok, gain, torch.full_like(gain, NEG_INF))

    gain_r = gains_of(cum[:, 0], cum[:, 1], cum[:, 2])           # missing -> right
    gain_l = gains_of(cum[:, 0] + na_stats[:, 0, :, None],         # missing -> left
                      cum[:, 1] + na_stats[:, 1, :, None],
                      cum[:, 2] + na_stats[:, 2, :, None])
    fm_lf = feature_mask.view(-1, f).expand(L, f)
    valid_t = ((iota < num_bins.to(torch.int64)[None, :, None] - 1)
               & ~na_sel & fm_lf[:, :, None])
    cat_idx = sorted(set(ci for ci in p.cat_features if 0 <= ci < f))
    if cat_idx:
        # the numerical planes skip categorical features
        is_num = torch.ones(f, dtype=torch.bool, device=dev)
        is_num[cat_idx] = False
        valid_t = valid_t & is_num[None, :, None]
    bun = bundle if p.has_bundles else None
    if bun is not None:
        # so do bundle columns: the bundle plane scores them
        valid_t = valid_t & ~bun.is_bundle[None, :, None]
    if p.extra_trees and rand_key is not None:
        # one random threshold per (leaf, feature) on the numerical
        # planes; a draw on the missing bin leaves none
        u = threefry.uniform(rand_key, (L, f), dev)
        nb = num_bins.to(torch.int64)[None, :]
        rnd = torch.floor(u * torch.clamp(nb - 1, min=1).to(torch.float32))
        rnd = torch.minimum(rnd.to(torch.int64), nb - 2)
        valid_t = valid_t & (iota == rnd[:, :, None])
    has_na = na < b
    neg = torch.full_like(gain_r, NEG_INF)
    gain_r = torch.where(valid_t, gain_r, neg)
    gain_l = torch.where(valid_t & has_na, gain_l, neg)
    parent_gain = leaf_split_gain(parent_g, parent_h, p)          # [L]

    # feature_contri: every plane becomes the penalized improvement
    # contri * (gain - parent - min_gain_to_split); then the CEGB penalty
    contri = shift = None
    if p.has_contri:
        contri = p.contri_array(f, dev)
        shift = (parent_gain + p.min_gain_to_split)[:, None, None]
    pen = (None if gain_penalty is None else
           gain_penalty.to(torch.float32).expand(L, f))

    def penalized(gain, cols=None):
        if contri is not None:
            c_ = contri if cols is None else contri[cols]
            gain = c_[None, :, None] * (gain - shift)
        if pen is not None:
            gain = gain - (pen if cols is None else pen[:, cols])[:, :, None]
        return gain

    gain_r, gain_l = penalized(gain_r), penalized(gain_l)
    sections = [gain_r.reshape(L, f * b), gain_l.reshape(L, f * b)]
    cat = (_categorical_planes(hist, num_bins, fm_lf, pg, ph, pc, cat_idx,
                               p) if cat_idx else None)
    if cat is not None:
        cat = cat._replace(gains=tuple(penalized(x, cat.cat_idx)
                                       for x in cat.gains))
        sections += [x.reshape(L, -1) for x in cat.gains]
    if bun is not None:
        lB, gain_b = _bundle_plane(
            cum, pg, ph, pc, fm_lf, bun, p,
            clamped_gains if mono is not None else None)
        sections.append(penalized(gain_b).reshape(L, f * b))
    gains = torch.cat(sections, dim=1)
    n_flat = gains.shape[1]
    best_raw = gains.max(dim=1).values
    tie_scale = torch.clamp(torch.maximum(best_raw.abs(), parent_gain.abs()),
                            min=1.0)
    near = gains >= (best_raw - TIE_RTOL * tie_scale)[:, None]
    kidx = torch.arange(n_flat, device=dev)[None, :]
    flat = torch.where(near, kidx, torch.full_like(kidx, n_flat)).min(dim=1).values
    flat = torch.clamp(flat, max=n_flat - 1)
    lidx = torch.arange(L, device=dev)
    best_gain = gains[lidx, flat]
    d = flat // (f * b)
    rem = flat % (f * b)
    feat = rem // b
    tbin = rem % b

    def pick(chan):
        base = cum[lidx, chan, feat, tbin]
        return base + torch.where(d == 1, na_stats[lidx, chan, feat], zero)

    left = [pick(0), pick(1), pick(2)]
    is_cat = torch.zeros(L, dtype=torch.bool, device=dev)
    member = torch.zeros((L, b), dtype=torch.bool, device=dev)
    if cat is not None:
        is_cat, feat, tbin, member, left = _decode_categorical(
            cat, flat, 2 * f * b, lidx, feat, tbin, left)
    if bun is not None:
        n_cat = 0 if cat is None else sum(x[0].numel() for x in cat.gains)
        is_cat, feat, tbin, member, left = _decode_bundle(
            bun, lB, flat, 2 * f * b + n_cat, lidx, is_cat, feat, tbin,
            member, left)

    if contri is not None:
        # the planes hold the penalized improvement already: a masked
        # candidate is <= 0 after the rewrite, so positivity alone gates
        improvement = best_gain
        found = allow_split & (improvement > 0.0)
    else:
        improvement = best_gain - parent_gain
        found = (allow_split & (best_gain > NEG_INF / 2)
                 & (improvement > p.min_gain_to_split) & (improvement > 0.0))
    return SplitResult(
        gain=torch.where(found, improvement,
                         torch.full_like(improvement, NEG_INF)),
        feature=feat, bin=tbin, default_left=(d == 1) & ~is_cat,
        left_g=left[0], left_h=left[1], left_cnt=left[2], is_cat=is_cat,
        cat_member=member & is_cat[:, None])


class _CatPlanes(NamedTuple):
    """The categorical sections of one search and what decodes them."""
    gains: tuple            # (onehot, asc, desc), each [L, Fc, B]
    cat_idx: torch.Tensor   # [Fc] i64 feature of each categorical column
    rank: torch.Tensor      # [L, Fc, B] i64 ascending rank; B + 1 invalid
    used: torch.Tensor      # [L, Fc] i64 valid bins
    onehot: tuple           # (g, h, count) [L, Fc, B] of each bin
    asc: tuple              # (g, h, count) of the ascending prefixes
    desc: tuple             # (g, h, count) of the descending prefixes


def _categorical_planes(hist, num_bins, fm_lf, pg, ph, pc, cat_idx,
                        p: SplitParams) -> _CatPlanes:
    """The one-hot, ascending and descending subset gains of every
    categorical feature (reference: split.py:354-451). Bin 0 (other /
    missing) is never a member."""
    L, _, f, b = hist.shape
    dev = hist.device
    ci = torch.as_tensor(cat_idx, dtype=torch.int64, device=dev)
    hcat = hist[:, :, ci, :]                                     # [L,3,Fc,B]
    gch, hch, cch = hcat[:, 0], hcat[:, 1], hcat[:, 2]
    nb_c = num_bins.to(torch.int64)[ci][None, :, None]           # [1,Fc,1]
    iota = torch.arange(b, device=dev)[None, None, :]
    fm_c = fm_lf[:, ci][:, :, None]                              # [L,Fc,1]
    in_range = (iota >= 1) & (iota < nb_c)
    neg = torch.full_like(gch, NEG_INF)

    # one-hot: one category left, lambda_l2 as is
    oh_allowed = (nb_c <= p.max_cat_to_onehot) & fm_c & in_range
    rg, rh, rc = pg - gch, ph - hch, pc - cch
    ok = ((cch >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
          & (hch >= p.min_sum_hessian_in_leaf)
          & (rh >= p.min_sum_hessian_in_leaf))
    gain_oh = leaf_split_gain(gch, hch, p) + leaf_split_gain(rg, rh, p)
    gain_oh = torch.where(ok & oh_allowed, gain_oh, neg)

    # k-subsets of the bins sorted by g / (h + cat_smooth); bins under
    # cat_smooth rows are left out (mean +inf, sorted last, rank B + 1)
    pc2 = replace(p, lambda_l2=p.lambda_l2 + p.cat_l2)
    subset_allowed = (nb_c > p.max_cat_to_onehot) & fm_c
    svalid = in_range & (cch >= p.cat_smooth)
    inf = torch.full_like(gch, float("inf"))
    mean = torch.where(svalid, gch / (hch + p.cat_smooth), inf)
    # the reference's pairwise rank counts -0.0 and 0.0 equal, and gives a
    # NaN mean (cat_smooth 0, an empty bin) rank 0 without counting it in
    # any other bin's rank
    key = torch.where(mean == 0, torch.zeros_like(mean), mean)
    order = torch.sort(key, dim=-1, stable=True).indices
    pos = torch.arange(b, device=dev).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, pos)
    rank = torch.where(torch.isnan(mean), torch.zeros_like(rank), rank)
    rank = torch.where(svalid, rank, torch.full_like(rank, b + 1))
    used = svalid.sum(dim=-1)                                    # [L, Fc]
    first = pos < used[..., None]
    zero = torch.zeros((), dtype=gch.dtype, device=dev)

    def sort_prefix(x):
        # the reference's one-hot contraction adds exact zeros to each
        # sorted bin: -0.0 comes out +0.0
        srt = torch.where(first, torch.gather(torch.where(svalid, x, zero),
                                              -1, order), zero)
        return blocked_cumsum(srt + 0.0)

    asc = tuple(sort_prefix(x) for x in (gch, hch, cch))
    kidx = pos

    def desc_prefix(cum):
        j = used[..., None] - kidx - 2
        got = torch.gather(cum, -1, j.clamp(0, b - 1))
        return cum[..., -1:] - torch.where(j >= 0, got, zero)

    desc = tuple(desc_prefix(c) for c in asc)

    def subset_gains(lg, lh, lc):
        rg_, rh_, rc_ = pg - lg, ph - lh, pc - lc
        max_num_cat = torch.clamp((used[..., None] + 1) // 2,
                                  max=p.max_cat_threshold)
        ok = ((kidx < torch.minimum(max_num_cat, used[..., None]))
              & (lc >= p.min_data_in_leaf) & (rc_ >= p.min_data_in_leaf)
              & (rc_ >= p.min_data_per_group)
              & (lh >= p.min_sum_hessian_in_leaf)
              & (rh_ >= p.min_sum_hessian_in_leaf) & subset_allowed)
        gain = leaf_split_gain(lg, lh, pc2) + leaf_split_gain(rg_, rh_, pc2)
        return torch.where(ok, gain, neg)

    return _CatPlanes(
        gains=(gain_oh, subset_gains(*asc), subset_gains(*desc)),
        cat_idx=ci, rank=rank, used=used, onehot=(gch, hch, cch), asc=asc,
        desc=desc)


def _decode_categorical(cat: _CatPlanes, flat, n_num: int, lidx, feat, tbin,
                        left):
    """The winner of a categorical section: its feature, its bin (the
    one-hot bin or the prefix length - 1), the bins that go left and its
    left stats (reference: split.py:528-566)."""
    L, fc, b = cat.rank.shape
    n_cat = 3 * fc * b
    cflat = torch.clamp(flat - n_num, min=0)
    plane = torch.clamp(cflat // (fc * b), 0, 2)
    crem = cflat % (fc * b)
    cf = crem // b
    ck = crem % b
    is_cat = (flat >= n_num) & (flat < n_num + n_cat)
    feat = torch.where(is_cat, cat.cat_idx[cf], feat)
    tbin = torch.where(is_cat, ck, tbin)
    rank_w = cat.rank[lidx, cf]                                  # [L, B]
    used_w = cat.used[lidx, cf][:, None]
    iota = torch.arange(b, device=flat.device)[None, :]
    mem_oh = iota == ck[:, None]
    mem_asc = rank_w <= ck[:, None]
    mem_desc = (rank_w >= used_w - ck[:, None] - 1) & (rank_w <= b)
    member = torch.where((plane == 0)[:, None], mem_oh,
                         torch.where((plane == 1)[:, None], mem_asc,
                                     mem_desc))
    member = member & is_cat[:, None]
    out = []
    for ch in range(3):
        v = torch.where(plane == 0, cat.onehot[ch][lidx, cf, ck],
                        torch.where(plane == 1, cat.asc[ch][lidx, cf, ck],
                                    cat.desc[ch][lidx, cf, ck]))
        out.append(torch.where(is_cat, v, left[ch]))
    return is_cat, feat, tbin, member, out


def _bundle_plane(cum, pg, ph, pc, fm_lf, bun: BundleArrays,
                  p: SplitParams, clamped_gains=None):
    """The left stats ([L, 3, F, B]) and gains ([L, F, B]) of every bundle
    position (reference: split.py:450-495): the range's prefix through
    prefix_end, plus the parent minus the whole range where the candidate
    takes the default side. The prefix sums are read at range_start - 1,
    range_end and prefix_end; prefix_end below range_start is the empty
    prefix (the candidate "t == default" at default bin 0)."""
    shape = cum.shape

    def at(idx):
        return torch.gather(cum, -1, idx.to(torch.int64)[None, None]
                            .expand(shape))

    rs = bun.range_start[None, None]
    pe = bun.prefix_end[None, None]
    cum_start = at((bun.range_start - 1).clamp(min=0))
    cum_end = at(bun.range_end)
    cum_pe = at(bun.prefix_end.clamp(min=0))
    zero = torch.zeros((), dtype=cum.dtype, device=cum.device)
    prefix = torch.where(pe >= rs, cum_pe - cum_start, zero)
    rng_tot = cum_end - cum_start
    incl = bun.incl_default.to(torch.float32)[None, None]
    par = torch.stack([pg, ph, pc], dim=1)                  # [L, 3, 1, 1]
    lB = prefix + incl * (par - rng_tot)
    lg, lh, lc = lB[:, 0], lB[:, 1], lB[:, 2]
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    ok = ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
          & (lh >= p.min_sum_hessian_in_leaf)
          & (rh >= p.min_sum_hessian_in_leaf)
          & bun.valid[None] & bun.is_bundle[None, :, None]
          & fm_lf[:, :, None])
    if clamped_gains is not None:
        # a monotone leaf's bounds hold on a bundle split too (bundled
        # features are never constrained themselves)
        gain = clamped_gains(lg, lh, rg, rh)[0]
    else:
        gain = leaf_split_gain(lg, lh, p) + leaf_split_gain(rg, rh, p)
    return lB, torch.where(ok, gain, torch.full_like(gain, NEG_INF))


def _decode_bundle(bun: BundleArrays, lB, flat, base: int, lidx, is_cat,
                   feat, tbin, member, left):
    """The winner of the bundle section: its column and position, the
    bins that go left (the range through prefix_end, and every bin outside
    the range when it takes the default side) and its left stats
    (reference: split.py:569-591)."""
    b = member.shape[1]
    bflat = torch.clamp(flat - base, min=0)
    bf = bflat // b
    bp = bflat % b
    is_bun = flat >= base
    start = bun.range_start[bf, bp][:, None]
    end = bun.range_end[bf, bp][:, None]
    pe = bun.prefix_end[bf, bp][:, None]
    incl = bun.incl_default[bf, bp][:, None]
    iota = torch.arange(b, device=flat.device)[None, :]
    mem_b = (((iota >= start) & (iota <= pe))
             | (incl & ((iota < start) | (iota > end))))
    out = [torch.where(is_bun, lB[lidx, ch, bf, bp], left[ch])
           for ch in range(3)]
    return (is_cat | is_bun, torch.where(is_bun, bf, feat),
            torch.where(is_bun, bp, tbin),
            torch.where(is_bun[:, None], mem_b, member), out)
