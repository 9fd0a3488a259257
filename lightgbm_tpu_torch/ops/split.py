"""Vectorized best-split search over histograms (numerical features).

Port of ``lightgbm_tpu/ops/split.py`` ``best_split`` (:218) for the slice's
path: numerical features, both missing-direction planes, the L1/L2 terms,
``max_delta_step``, ``min_data_in_leaf``, ``min_sum_hessian_in_leaf``,
``min_gain_to_split`` and the lowest-index election inside the ``TIE_RTOL``
gain band. The whole ``[L, 3, F, B]`` frontier is searched at once: prefix
sums over the bin axis give the left-side stats of every threshold, and one
masked election picks each leaf's (feature, bin, default_left).

Every f32 operation is the reference's, in its order; the bin-axis prefix
sum uses the reference's summation order (``scan.blocked_cumsum``), so on
the same histograms the split records agree bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

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


class SplitResult(NamedTuple):
    """Best split per leaf (reference analog: SplitInfo). All [L]."""
    gain: torch.Tensor          # improvement; NEG_INF where no split
    feature: torch.Tensor       # i64
    bin: torch.Tensor           # i64 threshold bin (left if bin <= threshold)
    default_left: torch.Tensor  # bool: missing values go left
    left_g: torch.Tensor
    left_h: torch.Tensor
    left_cnt: torch.Tensor


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


def leaf_split_gain(sum_g: torch.Tensor, sum_h: torch.Tensor,
                    p: SplitParams) -> torch.Tensor:
    """Gain contribution of a leaf (no 1/2 factor, as the reference)."""
    sg = threshold_l1(sum_g, p.lambda_l1)
    if p.max_delta_step <= 0.0:
        return sg * sg / (sum_h + p.lambda_l2 + _EPS_H)
    w = leaf_output(sum_g, sum_h, p)
    return -(2.0 * sg * w + (sum_h + p.lambda_l2) * w * w)


def best_split(hist: torch.Tensor, num_bins: torch.Tensor,
               na_bin: torch.Tensor, parent_g: torch.Tensor,
               parent_h: torch.Tensor, parent_cnt: torch.Tensor,
               feature_mask: torch.Tensor, p: SplitParams,
               allow_split: torch.Tensor) -> SplitResult:
    """Best split of every leaf of a frontier.

    hist [L, 3, F, B] channel-major (grad, hess, count) f32; num_bins [F]
    bins per feature; na_bin [F] missing-bin index (>= B when none);
    parent_g/h/cnt and allow_split [L]; feature_mask [F] bool, or [L, F]
    for a mask per leaf (feature_fraction_bynode)."""
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

    def gains_of(lg, lh, lc):
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        ok = ((lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
              & (lh >= p.min_sum_hessian_in_leaf)
              & (rh >= p.min_sum_hessian_in_leaf))
        gain = leaf_split_gain(lg, lh, p) + leaf_split_gain(rg, rh, p)
        return torch.where(ok, gain, torch.full_like(gain, NEG_INF))

    gain_r = gains_of(cum[:, 0], cum[:, 1], cum[:, 2])           # missing -> right
    gain_l = gains_of(cum[:, 0] + na_stats[:, 0, :, None],         # missing -> left
                      cum[:, 1] + na_stats[:, 1, :, None],
                      cum[:, 2] + na_stats[:, 2, :, None])
    valid_t = ((iota < num_bins.to(torch.int64)[None, :, None] - 1)
               & ~na_sel & feature_mask.view(-1, f)[:, :, None])
    has_na = na < b
    neg = torch.full_like(gain_r, NEG_INF)
    gain_r = torch.where(valid_t, gain_r, neg)
    gain_l = torch.where(valid_t & has_na, gain_l, neg)
    parent_gain = leaf_split_gain(parent_g, parent_h, p)          # [L]

    gains = torch.cat([gain_r.reshape(L, f * b), gain_l.reshape(L, f * b)],
                      dim=1)
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

    improvement = best_gain - parent_gain
    found = (allow_split & (best_gain > NEG_INF / 2)
             & (improvement > p.min_gain_to_split) & (improvement > 0.0))
    return SplitResult(
        gain=torch.where(found, improvement,
                         torch.full_like(improvement, NEG_INF)),
        feature=feat, bin=tbin, default_left=d == 1,
        left_g=pick(0), left_h=pick(1), left_cnt=pick(2))
