"""Forward-Backward with expected-count accumulation: the exact engine of
the counting E-step, in PyTorch.

Ported from quaff_tpu/dp/counts.py (dp_forward_backward, the JAX package's
f64 parity path; QuaffBackwardMatrix, src/qmodel.cpp:1393-1510).  The
forward fill stores its banded rows; the backward fill walks the rows in
reverse carrying the next row's backward state and emits per-row
posterior transition and emission count contributions, which are then
reduced by their (read k-mer, quality), (read token, quality) and indel
context keys.

Backward recursion in band coordinates (lane w <-> diagonal d, cell
i = d + j):
  back_del[j][w] = lse(d2m + me[j+1][w] + back_mat[j+1][w],
                       d2d + back_del[j][w+1])          (in-row, reverse)
  back_mat[j][w] = lse(end-term if j==yLen,
                       m2m(j) + me[j+1][w] + back_mat[j+1][w],
                       m2i(j) + ie(j+1)   + back_ins[j+1][w-1],
                       m2d(j) + back_del[j][w+1])
  back_ins[j][w] = lse(i2m + me[j+1][w] + back_mat[j+1][w],
                       i2i + ie(j+1)   + back_ins[j+1][w-1])
Counts: exp(fwd_src + trans (+emit) + back_dest - fwd_result), matching
transCount (qmodel.cpp:1505-1510).

Runs on any torch device in float64 (parity) or float32 (`count -fast`
off the card).  The in-row delete recurrences are log2(W)-step doubling
scans (dp/engine.doubling_scan), as the JAX engine's associative scans.
"""

from __future__ import annotations

import torch

from .engine import _shift_left, _shift_right, doubling_scan


def _reverse_linear_recurrence(combine, c_vec, b_vec):
    """x[w] = combine(x[w+1] + c[w], b[w]) with x[W] = -inf."""
    W = c_vec.shape[-1]
    x = doubling_scan(combine, c_vec.flip(-1), b_vec.flip(-1), W,
                      float("-inf"))
    return x.flip(-1)


def dp_forward_backward(
    tables_dev: dict,
    batch_dev: dict,
    local: bool = True,
    dtype=torch.float64,
    num_match_kmers: int = 4,
    num_indel_kmers: int = 1,
    return_post: bool = False,
) -> dict:
    """Per-pair forward score, backward score and expected counts for a
    bounding-band batch (dp/engine.to_device of PairBatch.build) on the
    batch's device.

    Output dict of tensors:
      fwd_score [B], back_score [B]
      match_counts [B, 4, Km, Q], insert_counts [B, 4, Q]
      m2m, m2i, m2d, m2e  [B, Ki]
      i2i, i2m, d2d, d2m  [B]
      post_mat, post_ins, post_del [B, Ly, W] with return_post
    Pairs whose forward score is -inf produce all-zero counts.
    """
    lse = torch.logaddexp
    neg = float("-inf")
    x_tok = batch_dev["x_tok"].long()
    x_len = batch_dev["x_len"].long()
    y_tok = batch_dev["y_tok"].long()
    y_mk = batch_dev["y_match_kmer"].long()
    ik_pad = batch_dev["y_indel_kmer_pad"].long()
    y_qual = batch_dev["y_qual"].long()
    y_has_qual = batch_dev["y_has_qual"].bool()
    y_len = batch_dev["y_len"].long()
    d_lo = batch_dev["d_lo"].long()
    member = batch_dev["member"].bool()
    dev = member.device

    B, W = member.shape
    Ly = y_tok.shape[1]
    Lx = x_tok.shape[1]
    t = {k: v.to(device=dev, dtype=dtype) for k, v in tables_dev.items()}
    Q = t["match_score"].shape[2]
    Km, Ki = num_match_kmers, num_indel_kmers
    lane = torch.arange(W, device=dev)[None, :]
    zero = torch.zeros((), dtype=dtype, device=dev)

    def row_emissions(j):
        ykm = y_mk[:, j - 1]
        yq = y_qual[:, j - 1]
        yt = y_tok[:, j - 1]
        mrow = torch.where(y_has_qual[:, None], t["match_score"][:, ykm, yq].T,
                           t["match_score_noq"][:, ykm].T)
        ie = torch.where(y_has_qual, t["insert_score"][yt, yq],
                         t["insert_score_noq"][yt])
        idx = d_lo[:, None] + (j - 1) + lane
        valid = (member & (idx >= 0) & (idx < x_len[:, None])
                 & (j <= y_len)[:, None])
        xtok_lane = torch.gather(x_tok, 1, idx.clamp(0, Lx - 1))
        me = torch.gather(mrow, 1, xtok_lane)
        return me, ie, idx, valid, xtok_lane

    # ---------------- forward pass, storing rows -------------------------
    mat = torch.full((B, W), neg, dtype=dtype, device=dev)
    ins = mat.clone()
    dele = mat.clone()
    fwd_score = torch.full((B,), neg, dtype=dtype, device=dev)
    fm, fi, fd = [mat], [ins], [dele]  # virtual row 0: all -inf
    for j in range(1, Ly + 1):
        ik_prev = ik_pad[:, j - 1]
        ik_cur = ik_pad[:, j]
        me, ie, idx, valid, _ = row_emissions(j)
        mat_c = lse(lse(mat + t["m2m"][ik_prev][:, None], dele + t["d2m"]),
                    ins + t["i2m"])
        if j == 1:
            start_ok = torch.ones_like(valid) if local else idx == 0
            mat_c = lse(mat_c, torch.where(start_ok, zero, neg))
        mat_c = torch.where(valid, mat_c + me, neg)
        ins_c = ie[:, None] + lse(_shift_left(ins, neg) + t["i2i"],
                                  _shift_left(mat, neg)
                                  + t["m2i"][ik_prev][:, None])
        ins_c = torch.where(valid, ins_c, neg)
        b_vec = torch.where(valid, _shift_right(mat_c, 1, neg)
                            + t["m2d"][ik_cur][:, None], neg)
        c_vec = torch.where(valid, t["d2d"], neg)
        del_c = torch.where(valid, doubling_scan(lse, c_vec, b_vec, W, neg),
                            neg)
        end_ok = valid if local else valid & (idx == x_len[:, None] - 1)
        contrib = torch.logsumexp(
            torch.where(end_ok, mat_c + t["m2e"][ik_cur][:, None], neg), dim=1)
        fwd_score = lse(fwd_score, torch.where(y_len == j, contrib, neg))
        mat, ins, dele = mat_c, ins_c, del_c
        fm.append(mat)
        fi.append(ins)
        fd.append(dele)

    finite = torch.isfinite(fwd_score)
    f_norm = torch.where(finite, fwd_score, zero)[:, None]

    def post(logw):
        return torch.where(finite[:, None], torch.exp(logw - f_norm), zero)

    # ---------------- backward pass with counts --------------------------
    bm_next = torch.full((B, W), neg, dtype=dtype, device=dev)
    bi_next = bm_next.clone()
    me_next = torch.zeros((B, W), dtype=dtype, device=dev)
    ie_next = torch.zeros((B,), dtype=dtype, device=dev)
    names = ("m2m", "m2i", "m2d", "m2e", "i2i", "i2m", "d2d", "d2m")
    rows = {k: [None] * Ly for k in ("mc4", "ic", *names)}
    if return_post:
        for k in ("post_mat", "post_ins", "post_del"):
            rows[k] = [None] * Ly
    back_score = torch.full((B,), neg, dtype=dtype, device=dev)
    for j in range(Ly, 0, -1):
        ik_prev = ik_pad[:, j - 1]
        ik_cur = ik_pad[:, j]
        me_cur, ie_cur, idx, valid, xtok_lane = row_emissions(j)
        m2m_j = t["m2m"][ik_cur][:, None]
        m2i_j = t["m2i"][ik_cur][:, None]
        m2d_j = t["m2d"][ik_cur][:, None]
        m2e_j = t["m2e"][ik_cur][:, None]

        from_match = me_next + bm_next  # via (i+1, j+1), lane w
        b_vec = torch.where(valid, t["d2m"] + from_match, neg)
        c_vec = torch.where(valid, t["d2d"], neg)
        bd_cur = torch.where(valid, _reverse_linear_recurrence(lse, c_vec,
                                                               b_vec), neg)
        end_ok = valid & (j == y_len)[:, None]
        if not local:
            end_ok &= idx == x_len[:, None] - 1
        bi_lo = _shift_right(bi_next, 1, neg)
        ie_n = ie_next[:, None]
        bm_cur = lse(
            lse(torch.where(end_ok, m2e_j, neg), m2m_j + from_match),
            lse(m2i_j + ie_n + bi_lo, m2d_j + _shift_left(bd_cur, neg)),
        )
        bm_cur = torch.where(valid, bm_cur, neg)
        bi_cur = torch.where(valid, lse(t["i2m"] + from_match,
                                        t["i2i"] + ie_n + bi_lo), neg)

        # posterior counts (transCount, qmodel.cpp:1505-1510)
        fm_cur, fi_cur, fd_cur = fm[j], fi[j], fd[j]
        fm_prev, fi_prev, fd_prev = fm[j - 1], fi[j - 1], fd[j - 1]
        mm = t["m2m"][ik_prev][:, None]
        mi = t["m2i"][ik_prev][:, None]
        w_m2m = post(fm_prev + mm + me_cur + bm_cur)
        w_d2m = post(fd_prev + t["d2m"] + me_cur + bm_cur)
        w_i2m = post(fi_prev + t["i2m"] + me_cur + bm_cur)
        if j == 1:
            start_ok = torch.ones_like(valid) if local else idx == 0
            w_s2m = torch.where(start_ok, post(me_cur + bm_cur), zero)
            back_score = torch.logsumexp(
                torch.where(valid & start_ok, me_cur + bm_cur, neg), dim=1)
        else:
            w_s2m = zero
        mc = w_m2m + w_d2m + w_i2m + w_s2m
        w_m2i = post(_shift_left(fm_prev, neg) + mi + ie_cur[:, None] + bi_cur)
        w_i2i = post(_shift_left(fi_prev, neg) + t["i2i"] + ie_cur[:, None]
                     + bi_cur)
        w_m2d = post(_shift_right(fm_cur, 1, neg) + m2d_j + bd_cur)
        w_d2d = post(_shift_right(fd_cur, 1, neg) + t["d2d"] + bd_cur)
        w_m2e = torch.where(end_ok, post(fm_cur + m2e_j), zero)

        r = j - 1
        onehot_x = torch.nn.functional.one_hot(xtok_lane, 4).to(dtype)
        rows["mc4"][r] = torch.einsum("bw,bwa->ba", mc, onehot_x)
        rows["ic"][r] = (w_m2i + w_i2i).sum(1)
        for k, v in zip(names, (w_m2m, w_m2i, w_m2d, w_m2e, w_i2i, w_i2m,
                                w_d2d, w_d2m)):
            rows[k][r] = v.sum(1)
        if return_post:
            # per-cell posterior state probabilities for `-log postmatrix`
            # (QuaffForwardBackwardMatrix::postMatch/Insert/Delete,
            # qmodel.cpp:1778-1788)
            rows["post_mat"][r] = post(fm_cur + bm_cur)
            rows["post_ins"][r] = post(fi_cur + bi_cur)
            rows["post_del"][r] = post(fd_cur + bd_cur)
        bm_next, bi_next, me_next, ie_next = bm_cur, bi_cur, me_cur, ie_cur

    # ---------------- keyed reductions over rows -------------------------
    row_valid = (torch.arange(1, Ly + 1, device=dev)[None, :]
                 <= y_len[:, None]).to(dtype)  # [B, Ly]
    stack = {k: torch.stack(v, dim=1) for k, v in rows.items()}  # [B, Ly, ..]

    def keyed(key, vals, n):
        """sum over rows of vals [B, Ly] (or [B, Ly, A]) by key [B, Ly]."""
        if vals.dim() == 2:
            out = torch.zeros((B, n), dtype=dtype, device=dev)
            return out.scatter_add_(1, key, vals * row_valid)
        A = vals.shape[2]
        out = torch.zeros((B, A, n), dtype=dtype, device=dev)
        src = (vals * row_valid[..., None]).transpose(1, 2)
        return out.scatter_add_(2, key[:, None, :].expand(B, A, Ly),
                                src.contiguous())

    kq = y_mk * Q + y_qual
    tq = y_tok * Q + y_qual
    out = {
        "fwd_score": fwd_score,
        "back_score": back_score,
        "match_counts": keyed(kq, stack["mc4"], Km * Q).reshape(B, 4, Km, Q),
        "insert_counts": keyed(tq, stack["ic"], 4 * Q).reshape(B, 4, Q),
        "m2m": keyed(ik_pad[:, :-1], stack["m2m"], Ki),
        "m2i": keyed(ik_pad[:, :-1], stack["m2i"], Ki),
        "m2d": keyed(ik_pad[:, 1:], stack["m2d"], Ki),
        "m2e": keyed(ik_pad[:, 1:], stack["m2e"], Ki),
    }
    for k in ("i2i", "i2m", "d2d", "d2m"):
        out[k] = (stack[k] * row_valid).sum(1)
    if return_post:
        for k in ("post_mat", "post_ins", "post_del"):
            out[k] = stack[k]
    return out
