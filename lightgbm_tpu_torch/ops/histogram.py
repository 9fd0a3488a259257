"""Histogram dispatch of the growers.

Port of the parts of ``lightgbm_tpu/ops/histogram.py`` that the serial
growers run: the stochastic-rounding quantizer
(``quantize_sr``/``make_quant``/``QuantChannels``), the packed-lattice
guard-bit budget (``pack_guard_bits``), ``RouteTables``, the fused
gradient front ``grad_quant_hist0``, and the Pallas branches of
``hist_leaf`` (the root pass, from quantized channels or from f32 rows) and
``hist_routed`` (with quantized channels, the fused level pass when
F * B <= 2048, else route then histogram; with f32 rows, route then
histogram at every F * B; numerical and categorical splits alike), and
``hist_routed_multi``, the multi-level replay of D known levels (the
reference's ``hist_routed_fused_multi_q8`` at D > 1). The
kernels themselves live in ``hist_kernels.py``; this module turns their
sums into the channel-major f32 histograms ``[S, 3, F, B]`` of the
reference contract.

The packed g/h lattice is a lane economy of the TPU's matrix unit: unpacking
returns exactly the int32 sums the separate channels give, so the port
always accumulates separate channels and dequantizes them with the same f32
operations (``dequant``), whatever ``pack_k`` says.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..obs.tracing import span
from . import hist_kernels as K

# _ACC_ROWS_MAX of the reference: the fused kernels need F * B <= 2048
ACC_ROWS_MAX = 2048
_INV127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


class RouteTables(NamedTuple):
    """Per-leaf split routing tables for one depthwise level, all [L] i32
    but ``member``.

    ``feat < 0`` means the leaf does not split this level; ``slot_left`` /
    ``slot_right`` name the histogram slot a row lands in (the out-of-range
    sentinel for the larger child, rebuilt by subtraction). ``is_cat`` and
    ``member`` [L, B] bool (the bins that go left) give the categorical
    splits (reference: CategoricalDecision); None on a level without one."""
    feat: torch.Tensor
    thr: torch.Tensor
    dleft: torch.Tensor       # 1 if missing goes left
    new_leaf: torch.Tensor    # leaf id of the right child
    slot_left: torch.Tensor
    slot_right: torch.Tensor
    is_cat: Optional[torch.Tensor] = None
    member: Optional[torch.Tensor] = None

    def stacked(self) -> torch.Tensor:
        """The kernel's int32 table: [6, L], or [7, L] with the is_cat row
        on a level with a categorical split."""
        rows = [self.feat, self.thr, self.dleft, self.new_leaf,
                self.slot_left, self.slot_right]
        if self.is_cat is not None:
            rows.append(self.is_cat)
        return torch.stack(rows).to(torch.int32).contiguous()

    def bitset(self) -> Optional[torch.Tensor]:
        """The kernel's [L, ceil(B / 32)] int32 membership words, or None
        on a level without a categorical split."""
        return None if self.member is None else K.member_bitset(self.member)


class QuantChannels(NamedTuple):
    """Per-tree quantized row channels and scales. ``hq is None`` marks
    const-hessian elision: h = h_const * bag01, so the hessian histogram is
    ``count * scale_h / 127``."""
    gq: torch.Tensor                 # [N] int8
    hq: Optional[torch.Tensor]       # [N] int8, or None
    cq: torch.Tensor                 # [N] int8 0/1
    scale_g: torch.Tensor            # f32 scalar
    scale_h: torch.Tensor            # f32 scalar


def quantize_sr(x: torch.Tensor, seed: int, salt: int):
    """Stochastic-rounding int8 quantization: (q [N] int8, scale f32)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mx = x.abs().max() if x.numel() else zero
    # a blocking copy of the floor from the host
    with span("sync.quant_floor"):
        floor = torch.tensor(1e-20, dtype=torch.float32, device=x.device)
    scale = torch.maximum(mx, floor)
    u = K.sr_dither(x.shape[0], seed, salt, x.device)
    return K.quantize_rows(x, scale, u), scale


def make_quant(g, h, c, seed: int, const_hess: bool = False) -> QuantChannels:
    gq, sg = quantize_sr(g, seed, salt=1)
    if const_hess:
        return QuantChannels(gq, None, c.to(torch.int8), sg, h.max() * 127.0)
    hq, sh = quantize_sr(h, seed, salt=2)
    return QuantChannels(gq, hq, c.to(torch.int8), sg, sh)


def pack_guard_bits(n_rows: int, const_hess: bool = False) -> int:
    """Guard-bit budget k of the reference's packed g/h lattice, or 0 when
    packing cannot be overflow-safe at this row count. The port accepts and
    reports it; its kernels accumulate separate channels either way."""
    n = int(n_rows)
    if n <= 0:
        return 0
    low_max = 1 if const_hess else 127
    k = int(low_max * n).bit_length()
    if 127 * n * (1 << k) + low_max * n > (1 << 31) - 1:
        return 0
    return k


def dequant(acc: torch.Tensor, const_hess: bool, scale_g: torch.Tensor,
            scale_h: torch.Tensor) -> torch.Tensor:
    """[..., nch, F, B] int32 channel sums -> [..., 3, F, B] f32 (g, h,
    count), the reference's _dequant_stack: sg = scale_g * f32(1/127),
    g = f32(sum) * sg, h = f32(sum) * sh or count * sh under const-hess."""
    sg = scale_g * _INV127
    sh = scale_h * _INV127
    out = acc.to(torch.float32)
    g = out[..., 0, :, :] * sg
    cnt = out[..., -1, :, :]
    h = cnt * sh if const_hess else out[..., 1, :, :] * sh
    return torch.stack([g, h, cnt], dim=-3)


def grad_quant_hist0(bins_T: torch.Tensor, score: torch.Tensor,
                     aux: torch.Tensor, bag: torch.Tensor, seed: int, spec,
                     num_bins: int, const_hess: bool = False):
    """Fused per-iteration front: objective gradients + SR quantization +
    root histogram in one pass. Returns (QuantChannels, hist0 [3, F, B]).
    Only for F * B <= 2048 (models/gbdt.py gates it); wider data takes the
    unfused front (make_quant, hist_leaf)."""
    gq, hq, cq, scales, acc = K.grad_quant_hist0(
        bins_T, score, aux, bag, seed, spec, num_bins, const_hess)
    quant = QuantChannels(gq, hq, cq, scales[0], scales[1])
    return quant, dequant(acc, const_hess, quant.scale_g, quant.scale_h)


Rows = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def hist_leaf(bins_T: torch.Tensor, num_bins: int,
              quant: Optional[QuantChannels] = None,
              rows: Optional[Rows] = None) -> torch.Tensor:
    """Root histogram [3, F, B] f32: one slot, every row in it. From the
    quantized channels when ``quant`` is given (the reference's hist_leaf
    with quant on its Pallas path: hist_pallas_q8 with slot zeros), else
    from the f32 ``rows`` (g, h, c) (hist_leaf_pallas)."""
    if quant is None:
        return K.hist_f32(bins_T, *rows, None, 1, num_bins)[0]
    acc = K.hist_q8(bins_T, quant.gq, quant.hq, quant.cq, None, 1, num_bins)
    return dequant(acc, quant.hq is None, quant.scale_g, quant.scale_h)[0]


def hist_routed(bins_T: torch.Tensor, leaf_id: torch.Tensor,
                tables: RouteTables, na_bin: torch.Tensor, num_slots: int,
                num_bins: int, quant: Optional[QuantChannels] = None,
                rows: Optional[Rows] = None,
                bins: Optional[torch.Tensor] = None):
    """Route + level histogram of the quantized channels ``quant``, or of
    the f32 ``rows`` (g, h, c) when quant is None. Returns (hist
    [S, 3, F, B] f32, new leaf id [N] i32).

    Quantized channels at F * B <= 2048 take the fused pass (one kernel
    call that routes each row once); wider data, and f32 rows at every
    width, route first (``route_level``, which also counts the rows of each
    slot) and then build the slot histogram (``hist_q8`` or ``hist_f32``,
    handed those counts). On the card every histogram over routed
    rows reads the kept rows' bins from ``bins``, the row-major [N, F] copy
    of bins_T. The reference routes
    data wider than 512 features through an XLA gather instead, because
    its route kernel's [F, chunk] block would exhaust VMEM;
    ``route_level`` reads one bin a row and has no such limit, so every F
    takes it: the same function."""
    f = bins_T.shape[0]
    tab, bits = tables.stacked(), tables.bitset()
    if quant is None:
        slot, lid2, counts = K.route_level(bins_T, leaf_id, tab, na_bin,
                                           num_slots, bits)
        return (K.hist_f32(bins_T, *rows, slot, num_slots, num_bins, bins,
                           counts), lid2)
    if f * num_bins <= ACC_ROWS_MAX:
        acc, lid2 = K.hist_routed_fused(
            bins_T, quant.gq, quant.hq, quant.cq, leaf_id, tab, na_bin,
            num_slots, num_bins, bins, bits)
    else:
        slot, lid2, counts = K.route_level(bins_T, leaf_id, tab, na_bin,
                                           num_slots, bits)
        acc = K.hist_q8(bins_T, quant.gq, quant.hq, quant.cq, slot,
                        num_slots, num_bins, bins, counts)
    return dequant(acc, quant.hq is None, quant.scale_g, quant.scale_h), lid2


def hist_routed_multi(bins_T: torch.Tensor, leaf_id: torch.Tensor,
                      tables_seq: Sequence[RouteTables],
                      na_bin: torch.Tensor, num_slots, num_bins: int,
                      quant: QuantChannels,
                      bins: Optional[torch.Tensor] = None):
    """D consecutive levels of quantized channels in one kernel call (the
    replay of known route tables, the reference's hist_routed_fused_multi_q8
    at D > 1). ``num_slots``: one S, or each level's. Returns (hist
    [D, S, 3, F, B] f32, each band dequantized with the tree's one
    scale_g and scale_h as the reference's are, and the leaf ids [N] i32
    after the D levels)."""
    acc, lid = K.hist_routed_fused_multi(
        bins_T, quant.gq, quant.hq, quant.cq, leaf_id,
        [t.stacked() for t in tables_seq], na_bin, num_slots, num_bins,
        bins, [t.bitset() for t in tables_seq])
    return dequant(acc, quant.hq is None, quant.scale_g, quant.scale_h), lid
