"""Banded pair-HMM batch layout and the plain-PyTorch DP engine.

Ported from quaff_tpu/dp/engine.py (whose JAX imports keep its numpy
pieces out of reach of a jax-free process):

  PairBatch      the padded host arrays of a batch of (ref, read, envelope)
                 pairs, bounding-band (build) or lane-packed (build_packed)
  pow2ceil       the batch-size quantum
  to_device      device_batch / host_batch: the batch as tensors on one
                 device, in the same narrowed integer dtypes
  dp_fill        the banded Viterbi / Forward fill as a row loop over
                 [B, W] tensors, optionally returning the M/I/D matrices

dp_fill is the port's float64 parity engine: in float64 Viterbi its delete
recurrence runs strictly lane by lane, like the reference's C++ loop
(qmodel.cpp:1546-1547), so scores and matrices equal the JAX engine's bit
for bit.  The aligner uses it to refill winners on the host when the
native library is missing; device scoring goes through dp/fill_v2.py.

Band coordinates: the state for read row j is a vector over a contiguous
range of diagonals d = i - j (lane w holds diagonal d_lo + w), so

  mat[w] <- prev row, lane w        (i-1, j-1) is the same diagonal
  ins[w] <- prev row, lane w+1      (i,   j-1) is diagonal d+1
  del[w] <- THIS row, lane w-1      (i-1, j)   is diagonal d-1
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from quaff_tpu.envelope import Envelope
from quaff_tpu.io.fastseq import FastSeq

from .scores import ScoreTables

NEG_INF = -np.inf


def pow2ceil(n: int, minimum: int = 8) -> int:
    """The smallest power of two >= n (floor `minimum`)."""
    b = minimum
    while b < n:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# batch assembly (host side)


@dataclass
class PairBatch:
    """Padded arrays describing a batch of (ref x, read y, envelope) pairs."""

    x_tok: np.ndarray  # [B, Lx] int32, padded with 0
    x_len: np.ndarray  # [B] int32
    y_tok: np.ndarray  # [B, Ly] int32
    y_match_kmer: np.ndarray  # [B, Ly] int32
    y_indel_kmer_pad: np.ndarray  # [B, Ly+1] int32; [:,0] = 0 (dummy)
    y_qual: np.ndarray  # [B, Ly] int32 (0 where absent)
    y_has_qual: np.ndarray  # [B] bool
    y_len: np.ndarray  # [B] int32
    d_lo: np.ndarray  # [B] int32: diagonal of lane 0 (includes -1 halo)
    member: np.ndarray  # [B, W] bool: member diagonals of the envelope
    width: int
    max_y_len: int
    # exclusive upper bounds on the kmer codes, for narrow transfer dtypes
    match_kmer_bound: int = 1 << 30
    indel_kmer_bound: int = 1 << 30
    # lane-packed strip descriptors ([B, MAX_SEGS] int32), set by
    # build_packed; None for bounding-band batches
    seg_d_lo: Optional[np.ndarray] = None
    seg_start: Optional[np.ndarray] = None
    seg_width: Optional[np.ndarray] = None

    @classmethod
    def build(
        cls,
        pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
        tables: ScoreTables,
        width: Optional[int] = None,
        max_y_len: Optional[int] = None,
        max_x_len: Optional[int] = None,
    ) -> "PairBatch":
        B = len(pairs)
        Lx = max(len(x.seq) for x, _, _ in pairs)
        if max_x_len is not None:
            Lx = max(Lx, max_x_len)
        Ly = max(len(y.seq) for _, y, _ in pairs)
        if max_y_len is not None:
            Ly = max(Ly, max_y_len)
        W = max(e.band_width for _, _, e in pairs)
        if width is not None:
            W = max(W, width)
        out = cls(
            x_tok=np.zeros((B, Lx), dtype=np.int32),
            x_len=np.zeros(B, dtype=np.int32),
            y_tok=np.zeros((B, Ly), dtype=np.int32),
            y_match_kmer=np.zeros((B, Ly), dtype=np.int32),
            y_indel_kmer_pad=np.zeros((B, Ly + 1), dtype=np.int32),
            y_qual=np.zeros((B, Ly), dtype=np.int32),
            y_has_qual=np.zeros(B, dtype=bool),
            y_len=np.zeros(B, dtype=np.int32),
            d_lo=np.zeros(B, dtype=np.int32),
            member=np.zeros((B, W), dtype=bool),
            width=W,
            max_y_len=Ly,
            match_kmer_bound=4 ** tables.match_kmer_len,
            indel_kmer_bound=4 ** tables.indel_kmer_len,
        )
        for b, (x, y, env) in enumerate(pairs):
            xt = x.tokens()
            yt = y.tokens()
            ly = len(yt)
            out.x_tok[b, : len(xt)] = xt
            out.x_len[b] = len(xt)
            out.y_tok[b, :ly] = yt
            out.y_match_kmer[b, :ly] = y.kmers(tables.match_kmer_len)
            out.y_indel_kmer_pad[b, 1 : ly + 1] = y.kmers(tables.indel_kmer_len)
            if y.has_qual():
                out.y_qual[b, :ly] = y.qual_scores()
                out.y_has_qual[b] = True
            out.y_len[b] = ly
            out.d_lo[b] = env.band_lo
            mask = env.member_mask()
            out.member[b, : len(mask)] = mask
        return out

    @classmethod
    def build_packed(
        cls,
        pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
        tables: ScoreTables,
        width: Optional[int] = None,
        max_y_len: Optional[int] = None,
        max_segs: int = 3,
        max_x_len: Optional[int] = None,
    ) -> "PairBatch":
        """Lane-packed strip layout for the score kernel: each pair's
        envelope is split into its independent diagonal strips (merged to
        at most max_segs) and the strips are laid side by side on the
        lane axis, so a multi-cluster envelope pays the sum of its strip
        widths in lanes instead of its (much wider) bounding band.  Each
        strip keeps its +-1 non-member halo, which blocks the in-row
        recursions at the seams.  Only dp/fill_v2.py reads this layout
        (the seg_* descriptors); dp_fill must use build()."""
        from quaff_tpu.envelope import pack_strips

        segs_per_pair = [pack_strips(e, max_segs) for _, _, e in pairs]

        class _PackedView:
            def __init__(self, segs):
                self.band_lo = 0  # unused by kernels for packed batches
                self.band_width = sum(s.band_width for s in segs)
                self._segs = segs

            def member_mask(self):
                return np.concatenate([s.member_mask() for s in self._segs])

        packed_pairs = [
            (x, y, _PackedView(segs))
            for (x, y, _), segs in zip(pairs, segs_per_pair)
        ]
        out = cls.build(
            packed_pairs, tables, width=width, max_y_len=max_y_len,
            max_x_len=max_x_len,
        )
        B = len(pairs)
        # sentinel diagonal for absent segments (fill_v2.D_SENTINEL: rows
        # are always out of x range there)
        out.seg_d_lo = np.full((B, max_segs), 1 << 24, dtype=np.int32)
        out.seg_start = np.zeros((B, max_segs), dtype=np.int32)
        out.seg_width = np.zeros((B, max_segs), dtype=np.int32)
        for b, segs in enumerate(segs_per_pair):
            lane = 0
            for k, s in enumerate(segs):
                out.seg_d_lo[b, k] = s.band_lo
                out.seg_start[b, k] = lane
                out.seg_width[b, k] = s.band_width
                lane += s.band_width
        return out


def _narrow_dtype(bound: int) -> np.dtype:
    """Narrowest integer dtype holding [0, bound); consumers widen before
    arithmetic."""
    if bound <= 127:
        return np.int8
    if bound <= 32767:
        return np.int16
    return np.int32


def to_device(batch: PairBatch, device) -> dict:
    """The batch as a dict of tensors on `device`, with the key set and
    narrowed integer dtypes of quaff_tpu's device_batch / host_batch."""
    host = {
        "x_tok": np.asarray(batch.x_tok, _narrow_dtype(4)),
        "x_len": np.asarray(batch.x_len),
        "y_tok": np.asarray(batch.y_tok, _narrow_dtype(4)),
        "y_match_kmer": np.asarray(
            batch.y_match_kmer, _narrow_dtype(batch.match_kmer_bound)
        ),
        "y_indel_kmer_pad": np.asarray(
            batch.y_indel_kmer_pad, _narrow_dtype(batch.indel_kmer_bound)
        ),
        "y_qual": np.asarray(batch.y_qual, _narrow_dtype(94)),
        "y_has_qual": np.asarray(batch.y_has_qual),
        "y_len": np.asarray(batch.y_len),
        "d_lo": np.asarray(batch.d_lo),
        "member": np.asarray(batch.member),
    }
    if batch.seg_d_lo is not None:
        host["seg_d_lo"] = np.asarray(batch.seg_d_lo)
        host["seg_start"] = np.asarray(batch.seg_start)
        host["seg_width"] = np.asarray(batch.seg_width)
    return {
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in host.items()
    }


TABLE_NAMES = (
    "match_score", "match_score_noq", "insert_score", "insert_score_noq",
    "m2m", "m2i", "m2d", "m2e", "d2d", "d2m", "i2i", "i2m",
)


def table_tensors(tables: ScoreTables, dtype=torch.float64,
                  device="cpu") -> dict:
    """The score tables as tensors (quaff_tpu's device_tables)."""
    return {
        k: torch.as_tensor(np.asarray(getattr(tables, k)), dtype=dtype,
                           device=device)
        for k in TABLE_NAMES
    }


# ---------------------------------------------------------------------------
# semirings and the in-row delete recurrence


def _shift_right(v: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """out[:, w] = v[:, w - s], `fill` for w < s."""
    pad = torch.full((v.shape[0], s), fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v[:, :-s]], dim=1)


def _shift_left(v: torch.Tensor, fill: float) -> torch.Tensor:
    """out[:, w] = v[:, w + 1], `fill` for the last lane."""
    pad = torch.full((v.shape[0], 1), fill, dtype=v.dtype, device=v.device)
    return torch.cat([v[:, 1:], pad], dim=1)


def doubling_scan(combine, c: torch.Tensor, b: torch.Tensor, reach: int,
                  neg: float) -> torch.Tensor:
    """x[w] = combine(x[w-1] + c[w], b[w]) (x[-1] = -inf) over the last
    axis, in log2(reach) shift steps: exact wherever a chain of
    recurrence steps is no longer than `reach` lanes (lanes with
    c = -inf cut the chain)."""
    s = 1
    while s < reach:
        b = combine(_shift_right(b, s, neg) + c, b)
        c = _shift_right(c, s, 0.0) + c
        s *= 2
    return b


def _sequential_scan(combine, c: torch.Tensor, b: torch.Tensor,
                     neg: float) -> torch.Tensor:
    """The same recurrence strictly lane by lane.  The shift-scan's
    doubling order rounds the +c offsets differently from the
    reference's lane-at-a-time loop, by ulps, which flips equal-scoring
    delete placements in repeats; float64 Viterbi parity needs this
    order.  Lanes left of the first live lane (c = -inf everywhere there)
    stay -inf, so the loop starts at it."""
    out = torch.full_like(b, neg)
    live = torch.nonzero((c > neg).any(dim=0)).flatten()
    if live.numel() == 0:
        return out
    x = torch.full_like(b[:, 0], neg)
    for w in range(int(live[0]), int(live[-1]) + 1):
        x = combine(x + c[:, w], b[:, w])
        out[:, w] = x
    return out


# ---------------------------------------------------------------------------
# DP fill


def dp_fill(
    tables_dev: dict,
    batch_dev: dict,
    mode: str = "viterbi",
    local: bool = True,
    return_matrices: bool = False,
    dtype=torch.float64,
) -> dict:
    """Fill the banded DP for a batch of pairs (quaff_tpu dp_fill).

    tables_dev / batch_dev are dicts of tensors on one device (see
    `table_tensors` / `to_device`).  Returns a dict with 'score' [B] (the
    Viterbi or Forward end score) and, if return_matrices,
    'mat'/'ins'/'del' [B, Ly+1, W] (row 0 = the all -inf virtual row).
    """
    if "seg_d_lo" in batch_dev:
        raise ValueError(
            "dp_fill cannot consume lane-packed strip batches "
            "(PairBatch.build_packed); use PairBatch.build"
        )
    viterbi = mode == "viterbi"
    combine = torch.maximum if viterbi else torch.logaddexp
    neg = float("-inf")

    x_tok = batch_dev["x_tok"].long()
    x_len = batch_dev["x_len"].long()[:, None]
    y_tok = batch_dev["y_tok"].long()
    y_mk = batch_dev["y_match_kmer"].long()
    ik_pad = batch_dev["y_indel_kmer_pad"].long()
    y_qual = batch_dev["y_qual"].long()
    y_has_qual = batch_dev["y_has_qual"].bool()
    y_len = batch_dev["y_len"].long()
    d_lo = batch_dev["d_lo"].long()[:, None]
    member = batch_dev["member"].bool()
    dev = member.device

    B, W = member.shape
    Ly = y_tok.shape[1]
    Lx = x_tok.shape[1]
    t = {k: v.to(dtype) for k, v in tables_dev.items()}
    lane = torch.arange(W, device=dev)[None, :]
    sequential = viterbi and dtype == torch.float64

    mat = torch.full((B, W), neg, dtype=dtype, device=dev)
    ins = mat.clone()
    dele = mat.clone()
    end = torch.full((B,), neg, dtype=dtype, device=dev)
    rows = []
    for j in range(1, Ly + 1):
        ik_prev = ik_pad[:, j - 1]  # yIndelKmer[j-1] (dummy 0 at j=1)
        ik_cur = ik_pad[:, j]
        m2m_j = t["m2m"][ik_prev][:, None]
        m2i_j = t["m2i"][ik_prev][:, None]
        m2d_j = t["m2d"][ik_cur][:, None]
        m2e_j = t["m2e"][ik_cur][:, None]

        ykm = y_mk[:, j - 1]
        yq = y_qual[:, j - 1]
        yt = y_tok[:, j - 1]
        # [B, 4]: emission scores for the 4 possible ref symbols this row
        mrow = torch.where(
            y_has_qual[:, None],
            t["match_score"][:, ykm, yq].T,
            t["match_score_noq"][:, ykm].T,
        )
        ins_emit = torch.where(
            y_has_qual, t["insert_score"][yt, yq], t["insert_score_noq"][yt]
        )[:, None]

        idx = d_lo + (j - 1) + lane  # lane -> ref offset i-1
        valid = member & (idx >= 0) & (idx < x_len) & (j <= y_len)[:, None]
        xtok_lane = torch.gather(x_tok, 1, idx.clamp(0, Lx - 1))
        emit = torch.gather(mrow, 1, xtok_lane)

        # match: all sources on the same lane of the previous row
        mat_c = combine(combine(mat + m2m_j, dele + t["d2m"]), ins + t["i2m"])
        if j == 1:
            start_ok = torch.ones_like(valid) if local else idx == 0
            mat_c = combine(mat_c, torch.where(
                start_ok, torch.zeros((), dtype=dtype, device=dev), neg))
        mat_c = torch.where(valid, mat_c + emit, neg)

        # insert: sources on lane w+1 of the previous row
        ins_c = ins_emit + combine(
            _shift_left(ins, neg) + t["i2i"], _shift_left(mat, neg) + m2i_j
        )
        ins_c = torch.where(valid, ins_c, neg)

        # delete: in-row linear recurrence over lanes
        b_vec = torch.where(valid, _shift_right(mat_c, 1, neg) + m2d_j, neg)
        c_vec = torch.where(valid, t["d2d"], neg)
        if sequential:
            d = _sequential_scan(combine, c_vec, b_vec, neg)
        else:
            d = doubling_scan(combine, c_vec, b_vec, W, neg)
        del_c = torch.where(valid, d, neg)

        # the end contribution fires only on each pair's final row
        if local:
            end_ok = valid
        else:
            end_ok = valid & (idx == x_len - 1)
        row_end = torch.where(end_ok, mat_c + m2e_j, neg)
        if viterbi:
            contrib = row_end.amax(dim=1)
        else:
            contrib = torch.logsumexp(row_end, dim=1)
        end = combine(end, torch.where(y_len == j, contrib, neg))

        mat, ins, dele = mat_c, ins_c, del_c
        if return_matrices:
            rows.append((mat_c, ins_c, del_c))

    out = {"score": end}
    if return_matrices:
        zero_row = torch.full((B, 1, W), neg, dtype=dtype, device=dev)
        for k, name in enumerate(("mat", "ins", "del")):
            out[name] = torch.cat(
                [zero_row] + [r[k][:, None, :] for r in rows], dim=1
            )
    return out
