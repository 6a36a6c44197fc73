"""The plain reference's E-step: quaff's pair HMM over the whole matrix, in
plain PyTorch.

For each (ref, read) pair the Forward algorithm runs row by row over the
read, each row a vector over every ref position (the matrix has no
envelope: quaff's -kmatchoff).  Read-global, ref-local, as quaff's default
train: a path starts at read position 1 anywhere on the ref and ends at the
read's last position anywhere on it.  With i a ref position and j a read
position,

  M[j][i] = match(x_i, y_j, q_j) + lse(M[j-1][i-1] + m2m, D[j-1][i-1] + d2m,
                                       I[j-1][i-1] + i2m; 0 when j = 1)
  I[j][i] = insert(y_j, q_j) + lse(I[j-1][i] + i2i, M[j-1][i] + m2i)
  D[j][i] = lse(M[j][i-1] + m2d, D[j][i-1] + d2d)
  log P   = lse_i(M[Y][i] + m2e)

The delete chain along a row is a linear recurrence with a constant step
d2d, so D[j][i] = (i-1) d2d + logcumsumexp_k<i(M[j][k] + m2d - k d2d): one
scan a row, where quaff walks the lanes one by one.

Expected counts are the gradient of the E-step's log-likelihood, the sum
over reads of lse(null, log P of each of the read's refs), with respect to
the log-probabilities the HMM reads: d/d log(theta) of that sum is the
posterior expected number of uses of theta, which is what quaff's Backward
pass accumulates.  Autograd takes the gradient; rows are checkpointed in
segments so the stored rows fit.  Nothing here comes from the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# a finite stand-in for log 0, so that the gradient of a log-add-exp of two
# impossible cells is 0 and never 0/0
NEG = -1.0e30
SEGMENT_ROWS = 48
BLOCK_CELLS = 2_000_000  # pairs x ref positions of one batch

TRANSITIONS = ("m2m", "m2i", "m2d", "m2e", "i2i", "i2m", "d2d", "d2m")


def _lse3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                         + torch.exp(c - m))


class _Block:
    """One batch of pairs, padded: refs [B, X] one-hot, reads [B, Y]."""

    def __init__(self, pairs, dtype, device):
        B = len(pairs)
        X = max(len(x) for x, _, _ in pairs)
        Y = max(len(y) for _, y, _ in pairs)
        xt = np.zeros((B, X), np.int64)
        yt = np.zeros((B, Y), np.int64)
        yq = np.zeros((B, Y), np.int64)
        for b, (x, y, q) in enumerate(pairs):
            xt[b, :len(x)] = x
            yt[b, :len(y)] = y
            yq[b, :len(y)] = q
        self.B, self.X, self.Y = B, X, Y
        as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        self.onehot = torch.nn.functional.one_hot(as_t(xt), 4).to(dtype)
        self.y_tok, self.y_qual = as_t(yt), as_t(yq)
        self.x_len = as_t(np.array([len(x) for x, _, _ in pairs]))
        self.y_len = as_t(np.array([len(y) for _, y, _ in pairs]))
        self.pos = torch.arange(X, device=device).to(dtype)
        self.valid = torch.arange(X, device=device)[None, :] < self.x_len[:, None]
        self.dtype, self.device = dtype, device


def _rows(blk, t, j0, j1, M, I, D, fwd):
    """Forward rows j0..j1-1 (1-based) of a block; returns the new state."""
    neg = torch.full((blk.B, 1), NEG, dtype=blk.dtype, device=blk.device)
    for j in range(j0, j1):
        yt, yq = blk.y_tok[:, j - 1], blk.y_qual[:, j - 1]
        # match emission of each ref position: the row's [B, 4] table
        # entries (read k-mer of order 1 = the read's own symbol) by ref base
        mrow = t["match"][:, yt, yq].T
        me = torch.bmm(blk.onehot, mrow[:, :, None])[:, :, 0]
        ie = t["insert"][yt, yq][:, None]
        if j == 1:
            diag = torch.zeros_like(me)
        else:
            diag = torch.cat([neg, _lse3(M[:, :-1] + t["m2m"],
                                         D[:, :-1] + t["d2m"],
                                         I[:, :-1] + t["i2m"])], 1)
        M_new = torch.where(blk.valid, me + diag, NEG)
        I_new = torch.where(blk.valid, ie + torch.logaddexp(
            I + t["i2i"], M + t["m2i"]), NEG)
        scan = torch.logcumsumexp(M_new + t["m2d"] - blk.pos * t["d2d"], 1)
        D_new = torch.where(blk.valid, torch.cat(
            [neg, scan[:, :-1] + blk.pos[:-1] * t["d2d"]], 1), NEG)
        end = torch.logsumexp(torch.where(blk.valid, M_new + t["m2e"], NEG), 1)
        fwd = torch.where(blk.y_len == j, end, fwd)
        M, I, D = M_new, I_new, D_new
    return M, I, D, fwd


def _forward(blk, t):
    """Each pair's log P, its rows checkpointed by segments for the
    gradient."""
    state = [torch.full((blk.B, blk.X), NEG, dtype=blk.dtype,
                        device=blk.device) for _ in range(3)]
    fwd = torch.full((blk.B,), NEG, dtype=blk.dtype, device=blk.device)
    for j0 in range(1, blk.Y + 1, SEGMENT_ROWS):
        j1 = min(j0 + SEGMENT_ROWS, blk.Y + 1)
        *state, fwd = torch.utils.checkpoint.checkpoint(
            _rows, blk, t, j0, j1, *state, fwd, use_reentrant=False)
    return fwd


def _blocks(pairs):
    """Pair indices in batches of at most BLOCK_CELLS ref positions, each
    batch of like read lengths."""
    order = sorted(range(len(pairs)), key=lambda b: -len(pairs[b][1]))
    out, cur, cur_x = [], [], 0
    for b in order:
        x = len(pairs[b][0])
        if cur and (len(cur) + 1) * max(cur_x, x) > BLOCK_CELLS:
            out.append(cur)
            cur, cur_x = [], 0
        cur.append(b)
        cur_x = max(cur_x, x)
    if cur:
        out.append(cur)
    return out


def estep(tables: dict, refs, reads, orders, null_lls, dtype=torch.float64,
          device="cpu"):
    """One E-step.  tables: score_tables' float64 arrays; refs: token arrays
    (revcomps included); reads: (tokens, quals) each; orders: the refs each
    read is scored against; null_lls: each read's null log-likelihood.

    Returns (y_ll [reads] float64, pair_ll {(read, ref): float}, counts):
    counts holds match [4, Km, Q], insert [4, Q] and each transition [1],
    float64 numpy, summed over reads with each pair weighted by its
    posterior exp(log P - y_ll) (the read's null counting in y_ll).  The
    numbers are computed in `dtype`."""
    pairs, keys = [], []
    for ny, (y, q) in enumerate(reads):
        for nx in orders[ny]:
            pairs.append((refs[nx], y, q))
            keys.append((ny, nx))

    t = {k: torch.tensor(v, dtype=dtype, device=device, requires_grad=True)
         for k, v in tables.items()}
    # one Forward of every pair with the gradient kept; the E-step's
    # log-likelihood is the sum over reads of lse(null, the read's pairs),
    # whose gradient weights each pair by its posterior
    fwd = torch.empty(len(pairs), dtype=dtype, device=device)
    for idx in _blocks(pairs):
        blk = _Block([pairs[b] for b in idx], dtype, device)
        fwd = fwd.index_put((torch.as_tensor(idx, device=device),),
                            _forward(blk, t))
    by_read = [[] for _ in reads]
    for k, (ny, _) in enumerate(keys):
        by_read[ny].append(k)
    nulls = torch.as_tensor(np.asarray(null_lls, np.float64), dtype=dtype,
                            device=device)
    y_t = torch.stack([
        torch.logsumexp(torch.cat([nulls[ny:ny + 1], fwd[torch.as_tensor(
            ks, dtype=torch.long, device=device)]]), 0)
        for ny, ks in enumerate(by_read)])
    y_t.sum().backward()
    pair_ll = fwd.detach().double().cpu().numpy()
    y_ll = y_t.detach().double().cpu().numpy()
    counts = {"match": t["match"].grad, "insert": t["insert"].grad}
    counts.update({k: t[k].grad for k in TRANSITIONS})
    counts = {k: v.double().cpu().numpy() for k, v in counts.items()}
    return y_ll, dict(zip(keys, pair_ll.tolist())), counts


def prune(ref_lls: dict, y_ll: float, n_refs: int, delta: float):
    """quaff's ref order after an E-step: refs best first, without those
    whose log-likelihood trails the read's by more than delta."""
    xs = [ref_lls.get(nx, -math.inf) for nx in range(n_refs)]
    order = sorted(range(n_refs), key=lambda nx: -xs[nx])
    return [nx for nx in order if xs[nx] >= y_ll - delta]
