"""The plain reference's quaff model: parameters, score tables, the null
model, the prior and the M-step, in NumPy and `math`.

It follows quaff's definitions (src/qmodel.cpp of the reference quaff:
QuaffParams, QuaffScores, QuaffNullParams::fit, QuaffParamCounts::initCounts
and ::fit) and imports nothing of the program.  Parameters are a dict of
float64 arrays:

  ref_base [4], begin_insert [Ki], begin_delete [Ki], extend_insert,
  extend_delete, insert_prob / insert_q / insert_r [4],
  match_prob / match_q / match_r [4 ref symbols, Km read k-mers]

The negative-binomial fit is a frozen copy of quaff's three-stage fit
(src/negbinom.cpp:112-129, as the port carries it in
quaff_tpu_torch/model/negbinom.py: moments, Brent on the profile
likelihood's derivative in a bracket, a Newton polish that keeps a runaway
iterate), so that the M-step's (q, r) are quaff's and not another solver's.
"""

from __future__ import annotations

import json
import math

import numpy as np

ALPHABET = "ACGT"
QUAL_RANGE = 94  # quality characters '!'..'~'


# ---------------------------------------------------------------------------
# sequences


def tokens(seq: str) -> np.ndarray:
    table = np.full(256, -1, np.int64)
    for i, c in enumerate(ALPHABET):
        table[ord(c)] = i
        table[ord(c.lower())] = i
    tok = table[np.frombuffer(seq.encode(), np.uint8)]
    if np.any(tok < 0):
        raise ValueError("sequence holds a symbol other than ACGT")
    return tok


def quals(qual: str) -> np.ndarray:
    b = np.frombuffer(qual.encode(), np.uint8).astype(np.int64) - 33
    return np.clip(b, 0, QUAL_RANGE - 1)


def revcomp_tokens(tok: np.ndarray) -> np.ndarray:
    return (3 - tok)[::-1].copy()


# ---------------------------------------------------------------------------
# negative binomial: log pmf and quaff's fit


def log_nb(k, p: float, n: float):
    """log NB(k; p, n) = lgamma(n+k) - lgamma(n) - lgamma(k+1) + n log p
    + k log(1-p), elementwise over integer k."""
    k = np.asarray(k, np.float64)
    lg = np.vectorize(math.lgamma, otypes=[np.float64])
    return (lg(k + n) - math.lgamma(n) - lg(k + 1.0) + n * math.log(p)
            + k * math.log1p(-p))


def _digamma(x: float) -> float:
    r = 0.0
    while x < 10.0:
        r -= 1.0 / x
        x += 1.0
    i = 1.0 / x
    i2 = i * i
    s = i2 * (-1 / 12 + i2 * (1 / 120 + i2 * (-1 / 252 + i2 * (
        1 / 240 + i2 * (-1 / 132 + i2 * (691 / 32760))))))
    return r + math.log(x) - 0.5 * i + s


def _trigamma(x: float) -> float:
    r = 0.0
    while x < 10.0:
        r += 1.0 / (x * x)
        x += 1.0
    i = 1.0 / x
    i2 = i * i
    return r + i * (1 + i * (0.5 + i * (1 / 6 + i2 * (-1 / 30 + i2 * (
        1 / 42 + i2 * (-1 / 30))))))


def _opt_p(n: float, f: np.ndarray) -> float:
    k = np.arange(len(f), dtype=np.float64)
    return 1.0 / (1.0 + float(np.dot(f, k)) / (float(np.sum(f)) * n))


def _loglike(n: float, f: np.ndarray) -> float:
    p = _opt_p(n, f)
    with np.errstate(invalid="ignore"):
        return float(np.sum(f * log_nb(np.arange(len(f)), p, n)))


def _d1(n: float, f: np.ndarray) -> float:
    nz = np.nonzero(f)[0]
    fs = float(np.sum(f[nz]))
    ks = float(np.dot(f[nz], nz))
    s = sum(float(f[k]) * _digamma(n + k) for k in nz)
    return -fs * math.log(1.0 + ks / (fs * n)) - fs * _digamma(n) + s


def _d2(n: float, f: np.ndarray) -> float:
    nz = np.nonzero(f)[0]
    fs = float(np.sum(f[nz]))
    s = sum(float(f[k]) * _trigamma(n + k) for k in nz)
    return -fs * _trigamma(n) + s


def _brent(fn, lo, hi, max_iter=100, epsabs=1e-3, epsrel=1e-3):
    a, b = lo, hi
    fa, fb = fn(a), fn(b)
    c, fc = b, fb
    d = e = b - a
    for _ in range(max_iter):
        ac_equal = False
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            ac_equal = True
            c, fc = a, fa
            d = e = b - a
        if abs(fc) < abs(fb):
            ac_equal = True
            a, b, c = b, c, b
            fa, fb, fc = fb, fc, fb
        tol = 0.5 * 2.220446049250313e-16 * abs(b)
        m = 0.5 * (c - b)
        if fb == 0.0 or abs(m) <= tol:
            return b
        if abs(e) < tol or abs(fa) <= abs(fb):
            d = e = m
        else:
            s = fb / fa
            if ac_equal:
                p, q = 2.0 * m * s, 1.0 - s
            else:
                q, r = fa / fc, fb / fc
                p = s * (2.0 * m * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0:
                q = -q
            else:
                p = -p
            if 2.0 * p < min(3.0 * m * q - abs(tol * q), abs(e * q)):
                e, d = d, p / q
            else:
                d = e = m
        a, fa = b, fb
        b += d if abs(d) > tol else (tol if m > 0 else -tol)
        fb = fn(b)
        if (fb < 0 and fc < 0) or (fb > 0 and fc > 0):
            lo_i, hi_i = sorted((b, a))
        else:
            lo_i, hi_i = sorted((b, c))
        same_sign = (lo_i > 0 and hi_i > 0) or (lo_i < 0 and hi_i < 0)
        min_abs = min(abs(lo_i), abs(hi_i)) if same_sign else 0.0
        if abs(hi_i - lo_i) < epsabs + epsrel * min_abs:
            return b
    return b


def fit_nb(f) -> tuple:
    """quaff's ML fit of a quality histogram f [94]: (p, n)."""
    f = np.asarray(f, np.float64)
    k = np.arange(len(f), dtype=np.float64)
    count = float(np.sum(f))
    if count <= 0:
        return float("nan"), float("nan")
    mean = float(np.dot(f, k)) / count
    var = float(np.dot(f, k * k)) / count - mean * mean
    if var > 0 and var > mean:
        p = mean / var
        n = mean * p / (1.0 - p)
        lo, hi = max(1.0, n / 2.0), min(len(f) - 1.0, n * 2.0)
    else:
        lo, hi = 1.0, max(1.0, len(f) - 1.0)
    fn = lambda x: _d1(x, f)  # noqa: E731
    if (fn(lo) >= 0) == (fn(hi) >= 0):
        n = lo if _loglike(lo, f) > _loglike(hi, f) else hi
    else:
        n = _brent(fn, lo, hi)
    for _ in range(100):  # Newton polish, relative step 1e-4
        last = n
        dd = _d2(n, f)
        if dd == 0 or not math.isfinite(dd):
            break
        n = n - _d1(n, f) / dd
        if abs(n - last) < 1e-4 * abs(n):
            break
        if n > len(f):
            break  # runaway: quaff keeps the iterate
    return _opt_p(n, f), n


# ---------------------------------------------------------------------------
# parameters


def load_params(path) -> dict:
    """A quaff params JSON file (order 1, gap order 0) as the dict above."""
    with open(path) as fh:
        d = json.load(fh)
    return params_from_json(d)


def params_from_json(d: dict) -> dict:
    if d.get("matchOrder", 1) != 1 or d.get("gapOrder", 0) != 0:
        raise ValueError("the plain reference takes quaff's default orders "
                         "(match order 1, gap order 0) only")
    p = {"ref_base": np.array([d["refBase"][c] for c in ALPHABET], float),
         "begin_insert": np.array([d["beginInsert"][""]], float),
         "begin_delete": np.array([d["beginDelete"][""]], float),
         "extend_insert": float(d["extendInsert"]),
         "extend_delete": float(d["extendDelete"])}
    for k in ("p", "q", "r"):
        p[f"insert_{'prob' if k == 'p' else k}"] = np.array(
            [d["insert"][c][k] for c in ALPHABET], float)
        p[f"match_{'prob' if k == 'p' else k}"] = np.array(
            [[d["match"][""][a][b][k] for b in ALPHABET] for a in ALPHABET],
            float)
    return p


def score_tables(p: dict) -> dict:
    """Log-probabilities the pair HMM reads (quaff's QuaffScores):
    match [4 ref, Km, Q], insert [4, Q] and the eight transitions, each
    transition a [1] array (gap order 0)."""
    q = np.arange(QUAL_RANGE)
    match = np.stack([np.stack([
        math.log(p["match_prob"][a, k]) + log_nb(q, p["match_q"][a, k],
                                                 p["match_r"][a, k])
        for k in range(p["match_prob"].shape[1])]) for a in range(4)])
    insert = np.stack([
        math.log(p["insert_prob"][t]) + log_nb(q, p["insert_q"][t],
                                               p["insert_r"][t])
        for t in range(4)])
    bi, bd = p["begin_insert"], p["begin_delete"]
    ei, ed = p["extend_insert"], p["extend_delete"]
    return {
        "match": match, "insert": insert,
        "m2m": np.log1p(-bi) + np.log1p(-bd), "m2i": np.log(bi),
        "m2d": np.log1p(-bi) + np.log(bd), "m2e": np.log(bi),
        "i2i": np.array([math.log(ei)]), "i2m": np.array([math.log1p(-ei)]),
        "d2d": np.array([math.log(ed)]), "d2m": np.array([math.log1p(-ed)]),
    }


# ---------------------------------------------------------------------------
# null model and prior


def fit_null(reads) -> dict:
    """quaff's null model of reads [(tokens, quals)], pseudocount 1."""
    counts = np.full((4, QUAL_RANGE), 1.0 / QUAL_RANGE)
    sym = np.ones(4)
    no, yes = 1.0, 1.0
    for tok, qv in reads:
        no += 1
        yes += len(tok)
        np.add.at(sym, tok, 1.0)
        np.add.at(counts, (tok, qv), 1.0)
    qr = [fit_nb(counts[n]) for n in range(4)]
    return {"emit": 1.0 / (1.0 + no / yes), "sym": sym / np.sum(sym),
            "q": np.array([x[0] for x in qr]), "r": np.array([x[1] for x in qr])}


def null_loglike(null: dict, tok: np.ndarray, qv: np.ndarray) -> float:
    table = np.stack([log_nb(np.arange(QUAL_RANGE), null["q"][n], null["r"][n])
                      for n in range(4)])
    return float(len(tok) * math.log(null["emit"]) + math.log1p(-null["emit"])
                 + np.sum(np.log(null["sym"])[tok]) + np.sum(table[tok, qv]))


def prior_counts(null: dict) -> dict:
    """quaff's default prior, initCounts(9, 9, 5, 1, null), as parameter
    counts (the dict `mstep` takes)."""
    nb = np.exp(np.stack([log_nb(np.arange(QUAL_RANGE), null["q"][n],
                                 null["r"][n]) for n in range(4)]))
    insert = np.stack([4 * null["sym"][j] * nb[j] for j in range(4)])
    match = np.empty((4, 4, QUAL_RANGE))
    for i in range(4):
        for j in range(4):
            base = (5.0 if i == j
                    else 4 * null["sym"][j] / (1.0 - null["sym"][i]))
            match[i, j] = base * nb[j]
    one = np.ones(1)
    return {"insert": insert, "match": match,
            "begin_insert_no": 9 * one, "begin_insert_yes": one.copy(),
            "begin_delete_no": 9 * one, "begin_delete_yes": one.copy(),
            "extend_insert_no": 1.0, "extend_insert_yes": 9.0,
            "extend_delete_no": 1.0, "extend_delete_yes": 9.0}


def param_counts(c: dict) -> dict:
    """Expected transition and emission counts (match [4, Km, Q], insert
    [4, Q], m2m, m2i, m2d, m2e [Ki], i2i, i2m, d2d, d2m) as quaff's
    parameter counts."""
    return {"insert": c["insert"], "match": c["match"],
            "begin_insert_no": c["m2m"] + c["m2d"],
            "begin_insert_yes": c["m2i"] + c["m2e"],
            "begin_delete_no": c["m2m"], "begin_delete_yes": c["m2d"],
            "extend_insert_no": float(np.sum(c["i2m"])),
            "extend_insert_yes": float(np.sum(c["i2i"])),
            "extend_delete_no": float(np.sum(c["d2m"])),
            "extend_delete_yes": float(np.sum(c["d2d"]))}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def mstep(pc: dict, ref_tokens) -> dict:
    """quaff's M-step: ratio estimators and negative-binomial refits of
    parameter counts, then the refs' base composition."""
    def ratio(no, yes):
        with np.errstate(divide="ignore", invalid="ignore"):
            return 1.0 / (1.0 + np.asarray(no, float) / yes)

    p = {"begin_insert": ratio(pc["begin_insert_no"], pc["begin_insert_yes"]),
         "begin_delete": ratio(pc["begin_delete_no"], pc["begin_delete_yes"]),
         "extend_insert": float(ratio(pc["extend_insert_no"],
                                      pc["extend_insert_yes"])),
         "extend_delete": float(ratio(pc["extend_delete_no"],
                                      pc["extend_delete_yes"]))}
    freq = pc["insert"].sum(1)
    p["insert_prob"] = freq / freq.sum()
    qr = [fit_nb(pc["insert"][t]) for t in range(4)]
    p["insert_q"] = np.array([x[0] for x in qr])
    p["insert_r"] = np.array([x[1] for x in qr])
    km = pc["match"].shape[1]
    p["match_prob"] = np.empty((4, km))
    p["match_q"] = np.empty((4, km))
    p["match_r"] = np.empty((4, km))
    for i in range(4):
        freq = pc["match"][i].sum(1)
        p["match_prob"][i] = freq / freq.sum()
        for j in range(km):
            p["match_q"][i, j], p["match_r"][i, j] = fit_nb(pc["match"][i, j])
    comp = np.zeros(4)
    for tok in ref_tokens:
        comp += np.bincount(tok, minlength=4)
    p["ref_base"] = comp / comp.sum()
    return p
