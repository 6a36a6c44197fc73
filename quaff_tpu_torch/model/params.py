"""Pair-HMM parameters, null model and count structures (pytree-friendly).

Array-structured equivalents of the reference's QuaffParams /
QuaffNullParams / QuaffCounts / QuaffParamCounts (src/qmodel.h:88-233),
with JSON round-trip byte-compatible with the reference writers
(src/qmodel.cpp:187-276, 341-478, 1892-1901).  Parameters are stored as
numpy arrays keyed by k-mer context so they convert directly into
device-resident score tables for the DP kernels.

Model structure (reference src/qmodel.h:148-164):
  ref_base[4]                      stationary ref composition
  begin_insert[Ki], begin_delete[Ki]   gap-open probs per indel k-mer context
  extend_insert, extend_delete         scalar gap-extend probs
  insert_*: [4]                    insert emission (sym prob + NB(q,r) qual)
  match_*: [4, Km]                 match emission given (ref sym, read k-mer)
where Ki = 4^gap_order, Km = 4^(1+sub_order) (matchContext counts the
emitted symbol itself as part of the k-mer).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import IO, Optional

import numpy as np

from ..alphabet import (
    ALPHABET_SIZE,
    DNA_ALPHABET,
    QUAL_SCORE_RANGE,
    kmer_to_string,
    number_of_kmers,
)
from .negbinom import (
    fit_negative_binomial,
    log_negative_binomial_array,
    negative_binomial_mean,
    negative_binomial_variance,
)

DEFAULT_MATCH_KMER_LEN = 1
DEFAULT_INDEL_KMER_LEN = 0


def fmt(v: float) -> str:
    """C++ default ostream double formatting (6 significant digits, %g)."""
    return f"{v:.6g}"


def gason_string2double(s: str) -> float:
    """Exact mirror of the reference JSON parser's number conversion
    (gason.cpp:73-118 string2double): naive digit accumulation plus a
    squared-base power loop, NOT correctly rounded.  Parsed parameter
    values must be bit-identical to the reference's for ulp-level Viterbi
    tie parity (round 4), so every params/null/counts JSON number goes
    through this instead of Python's correctly-rounded float()."""
    i, n = 0, len(s)
    neg = n > 0 and s[0] == "-"
    if neg:
        i += 1
    result = 0.0
    while i < n and s[i].isdigit():
        result = (result * 10) + (ord(s[i]) - 48)
        i += 1
    if i < n and s[i] == ".":
        i += 1
        fraction = 1.0
        while i < n and s[i].isdigit():
            fraction *= 0.1
            result += (ord(s[i]) - 48) * fraction
            i += 1
    if i < n and s[i] in "eE":
        i += 1
        base = 10.0
        if i < n and s[i] == "+":
            i += 1
        elif i < n and s[i] == "-":
            i += 1
            base = 0.1
        exponent = 0
        while i < n and s[i].isdigit():
            exponent = (exponent * 10) + (ord(s[i]) - 48)
            i += 1
        power = 1.0
        while exponent:
            if exponent & 1:
                power *= base
            exponent >>= 1
            base *= base
        result *= power
    return -result if neg else result


def gason_loads(text: str):
    """json.loads with every number converted via gason_string2double."""
    return json.loads(
        text,
        parse_float=gason_string2double,
        parse_int=lambda s: gason_string2double(s),
    )


def _kmer_string(kmer: int, k: int) -> str:
    return kmer_to_string(kmer, k) if k > 0 else ""


def _kmer_prefix(kmer: int, k: int) -> str:
    s = kmer_to_string(kmer, k)
    return s[: k - 1]


# ---------------------------------------------------------------------------


@dataclass
class QuaffNullParams:
    """Geometric-length null model with per-symbol emission distributions
    (reference QuaffNullParams, qmodel.cpp:1806-1907)."""

    null_emit: float = 0.5
    sym_prob: np.ndarray = field(
        default_factory=lambda: np.full(ALPHABET_SIZE, 0.25)
    )
    q: np.ndarray = field(default_factory=lambda: np.full(ALPHABET_SIZE, 0.5))
    r: np.ndarray = field(
        default_factory=lambda: np.full(ALPHABET_SIZE, QUAL_SCORE_RANGE / 2)
    )

    @classmethod
    def fit(cls, seqs, pseudocount: float = 1.0) -> "QuaffNullParams":
        """Fit from read sequences with +pseudocount smoothing
        (qmodel.cpp:1811-1843)."""
        null_count = np.full(
            (ALPHABET_SIZE, QUAL_SCORE_RANGE), pseudocount / QUAL_SCORE_RANGE
        )
        null_emit_yes = pseudocount
        null_emit_no = pseudocount
        sym_count = np.full(ALPHABET_SIZE, pseudocount)
        for s in seqs:
            null_emit_no += 1
            null_emit_yes += len(s.seq)
            tok = s.tokens()
            np.add.at(sym_count, tok, 1.0)
            if s.has_qual():
                np.add.at(null_count, (tok, s.qual_scores()), 1.0)
        out = cls()
        out.null_emit = 1.0 / (1.0 + null_emit_no / null_emit_yes)
        out.sym_prob = sym_count / np.sum(sym_count)
        q = np.zeros(ALPHABET_SIZE)
        r = np.zeros(ALPHABET_SIZE)
        for n in range(ALPHABET_SIZE):
            q[n], r[n] = fit_negative_binomial(null_count[n])
        out.q, out.r = q, r
        return out

    def log_qual_prob_table(self) -> np.ndarray:
        """[4, QUAL_SCORE_RANGE] log NB tables.  Cached per (q, r) state:
        log_likelihood runs once per read on the align/overlap hot paths
        and the scalar libm construction (ulp-parity, round 4) is ~2k
        libm calls."""
        key = (self.q.tobytes(), self.r.tobytes())
        cached = getattr(self, "_lqpt_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        k = np.arange(QUAL_SCORE_RANGE)
        table = np.stack(
            [
                log_negative_binomial_array(k, self.q[i], self.r[i])
                for i in range(ALPHABET_SIZE)
            ]
        )
        self._lqpt_cache = (key, table)
        return table

    def log_likelihood(self, seq) -> float:
        """Null log-likelihood of one read (qmodel.cpp:1875-1890).

        Bitwise-mirrors the reference: log(1 - nullEmit) (NOT log1p), and a
        single sequential accumulation interleaving the per-position symbol
        and quality terms in the reference's loop order — np.cumsum is a
        strict left-to-right accumulation, so the rounding sequence matches
        the scalar C++ loop exactly (round-4 ulp-parity fix)."""
        tok = seq.tokens()
        start = len(seq.seq) * math.log(self.null_emit) + math.log(
            1.0 - self.null_emit
        )
        log_sym = np.array([math.log(p) for p in self.sym_prob])
        sym_terms = log_sym[tok]
        if seq.has_qual():
            table = self.log_qual_prob_table()
            qual_terms = table[tok, seq.qual_scores()]
            terms = np.empty(2 * len(tok) + 1)
            terms[0] = start
            terms[1::2] = sym_terms
            terms[2::2] = qual_terms
        else:
            terms = np.concatenate(([start], sym_terms))
        return float(np.cumsum(terms)[-1])

    # -- JSON -------------------------------------------------------------

    def write_json(self, out: IO[str]) -> None:
        out.write("{\n")
        out.write(f'  "nullEmit": {fmt(self.null_emit)},\n')
        out.write('  "null": {')
        parts = []
        for i, c in enumerate(DNA_ALPHABET):
            parts.append(f' "{c}": {_sym_qual_json(self.sym_prob[i], self.q[i], self.r[i])}')
        out.write(",".join(parts) + " }")
        out.write(" }")

    @classmethod
    def from_json(cls, data) -> "QuaffNullParams":
        if isinstance(data, str):
            data = gason_loads(data)
        out = cls()
        out.null_emit = float(data["nullEmit"])
        for i, c in enumerate(DNA_ALPHABET):
            d = data["null"][c]
            out.sym_prob[i] = float(d["p"])
            out.q[i] = float(d["q"])
            out.r[i] = float(d["r"])
        return out


def _sym_qual_json(p: float, q: float, r: float) -> str:
    m = negative_binomial_mean(q, r)
    sd = math.sqrt(negative_binomial_variance(q, r))
    return (
        f'{{ "p": {fmt(p)}, "q": {fmt(q)}, "r": {fmt(r)},'
        f' "m": {fmt(m)}, "sd": {fmt(sd)} }}'
    )


# ---------------------------------------------------------------------------


@dataclass
class QuaffParams:
    match_kmer_len: int = DEFAULT_MATCH_KMER_LEN
    indel_kmer_len: int = DEFAULT_INDEL_KMER_LEN
    ref_base: np.ndarray = field(default_factory=lambda: np.full(ALPHABET_SIZE, 0.25))
    begin_insert: np.ndarray = field(default_factory=lambda: np.full(1, 0.5))
    begin_delete: np.ndarray = field(default_factory=lambda: np.full(1, 0.5))
    extend_insert: float = 0.5
    extend_delete: float = 0.5
    insert_prob: np.ndarray = field(default_factory=lambda: np.full(ALPHABET_SIZE, 0.25))
    insert_q: np.ndarray = field(default_factory=lambda: np.full(ALPHABET_SIZE, 0.5))
    insert_r: np.ndarray = field(
        default_factory=lambda: np.full(ALPHABET_SIZE, QUAL_SCORE_RANGE / 2)
    )
    match_prob: np.ndarray = field(
        default_factory=lambda: np.full((ALPHABET_SIZE, ALPHABET_SIZE), 0.25)
    )
    match_q: np.ndarray = field(
        default_factory=lambda: np.full((ALPHABET_SIZE, ALPHABET_SIZE), 0.5)
    )
    match_r: np.ndarray = field(
        default_factory=lambda: np.full(
            (ALPHABET_SIZE, ALPHABET_SIZE), QUAL_SCORE_RANGE / 2
        )
    )

    @classmethod
    def create(cls, match_kmer_len: int, indel_kmer_len: int) -> "QuaffParams":
        km = number_of_kmers(match_kmer_len)
        ki = number_of_kmers(indel_kmer_len)
        return cls(
            match_kmer_len=match_kmer_len,
            indel_kmer_len=indel_kmer_len,
            begin_insert=np.full(ki, 0.5),
            begin_delete=np.full(ki, 0.5),
            match_prob=np.full((ALPHABET_SIZE, km), 0.25),
            match_q=np.full((ALPHABET_SIZE, km), 0.5),
            match_r=np.full((ALPHABET_SIZE, km), QUAL_SCORE_RANGE / 2),
        )

    @property
    def num_match_kmers(self) -> int:
        return number_of_kmers(self.match_kmer_len)

    @property
    def num_indel_kmers(self) -> int:
        return number_of_kmers(self.indel_kmer_len)

    def fit_ref_seqs(self, refs) -> None:
        """Set ref_base to the base composition of the references
        (qmodel.cpp:284-294)."""
        counts = np.zeros(ALPHABET_SIZE)
        total = 0
        for fs in refs:
            total += len(fs.seq)
            np.add.at(counts, fs.tokens(), 1.0)
        self.ref_base = counts / total

    # -- JSON -------------------------------------------------------------

    def write_json(self, out: IO[str]) -> None:
        out.write("{\n")
        if self.match_kmer_len != DEFAULT_MATCH_KMER_LEN:
            out.write(f'  "matchOrder": {self.match_kmer_len},\n')
        if self.indel_kmer_len != DEFAULT_INDEL_KMER_LEN:
            out.write(f'  "gapOrder": {self.indel_kmer_len},\n')
        out.write('  "refBase": {')
        for i, c in enumerate(DNA_ALPHABET):
            out.write(f' "{c}": {fmt(self.ref_base[i])}')
            out.write(" },\n" if i == ALPHABET_SIZE - 1 else ",")
        self._write_kmer_map(out, "beginInsert", self.begin_insert)
        out.write(",\n")
        self._write_kmer_map(out, "beginDelete", self.begin_delete)
        out.write(",\n")
        out.write(f'  "extendInsert": {fmt(self.extend_insert)},\n')
        out.write(f'  "extendDelete": {fmt(self.extend_delete)},\n')
        out.write('  "insert": {\n')
        for i, c in enumerate(DNA_ALPHABET):
            out.write(
                f'    "{c}": '
                + _sym_qual_json(self.insert_prob[i], self.insert_q[i], self.insert_r[i])
            )
            out.write(" },\n" if i == ALPHABET_SIZE - 1 else ",\n")
        out.write('  "match": {\n')
        n_kmers = self.num_match_kmers
        for j_prefix in range(0, n_kmers, ALPHABET_SIZE):
            out.write(f'   "{_kmer_prefix(j_prefix, self.match_kmer_len)}": {{\n')
            for i, c in enumerate(DNA_ALPHABET):
                out.write(f'    "{c}": {{\n')
                for j_suffix, cs in enumerate(DNA_ALPHABET):
                    j = j_prefix + j_suffix
                    out.write(
                        f'      "{cs}": '
                        + _sym_qual_json(
                            self.match_prob[i][j], self.match_q[i][j], self.match_r[i][j]
                        )
                    )
                    out.write(" }" if j_suffix == ALPHABET_SIZE - 1 else ",\n")
                out.write(" }" if i == ALPHABET_SIZE - 1 else ",\n")
            out.write(" }" if j_prefix == n_kmers - ALPHABET_SIZE else ",\n")
        out.write(" }")

    def _write_kmer_map(self, out: IO[str], name: str, values: np.ndarray) -> None:
        out.write(f'  "{name}": {{')
        for j in range(self.num_indel_kmers):
            out.write("" if j == 0 else ",")
            out.write(f' "{_kmer_string(j, self.indel_kmer_len)}": {fmt(values[j])}')
        out.write(" }")

    @classmethod
    def from_json(cls, data) -> "QuaffParams":
        if isinstance(data, str):
            data = gason_loads(data)
        match_kmer_len = int(data.get("matchOrder", DEFAULT_MATCH_KMER_LEN))
        indel_kmer_len = int(data.get("gapOrder", DEFAULT_INDEL_KMER_LEN))
        out = cls.create(match_kmer_len, indel_kmer_len)
        for i, c in enumerate(DNA_ALPHABET):
            out.ref_base[i] = float(data["refBase"][c])
        for j in range(out.num_indel_kmers):
            key = _kmer_string(j, indel_kmer_len)
            out.begin_insert[j] = float(data["beginInsert"][key])
            out.begin_delete[j] = float(data["beginDelete"][key])
        out.extend_insert = float(data["extendInsert"])
        out.extend_delete = float(data["extendDelete"])
        for i, c in enumerate(DNA_ALPHABET):
            d = data["insert"][c]
            out.insert_prob[i] = float(d["p"])
            out.insert_q[i] = float(d["q"])
            out.insert_r[i] = float(d["r"])
        for j_prefix in range(0, out.num_match_kmers, ALPHABET_SIZE):
            prefix_key = _kmer_prefix(j_prefix, match_kmer_len)
            for i, c in enumerate(DNA_ALPHABET):
                for j_suffix, cs in enumerate(DNA_ALPHABET):
                    d = data["match"][prefix_key][c][cs]
                    j = j_prefix + j_suffix
                    out.match_prob[i][j] = float(d["p"])
                    out.match_q[i][j] = float(d["q"])
                    out.match_r[i][j] = float(d["r"])
        return out


# ---------------------------------------------------------------------------


@dataclass
class QuaffCounts:
    """Raw transition/emission expected counts from one Backward pass
    (reference QuaffCounts, qmodel.h:205-212)."""

    match_kmer_len: int
    indel_kmer_len: int
    insert: np.ndarray  # [4, QUAL_SCORE_RANGE]
    match: np.ndarray  # [4, Km, QUAL_SCORE_RANGE]
    m2m: np.ndarray  # [Ki]
    m2i: np.ndarray
    m2d: np.ndarray
    m2e: np.ndarray
    d2d: float = 0.0
    d2m: float = 0.0
    i2i: float = 0.0
    i2m: float = 0.0

    @classmethod
    def zero(cls, match_kmer_len: int, indel_kmer_len: int) -> "QuaffCounts":
        km = number_of_kmers(match_kmer_len)
        ki = number_of_kmers(indel_kmer_len)
        return cls(
            match_kmer_len=match_kmer_len,
            indel_kmer_len=indel_kmer_len,
            insert=np.zeros((ALPHABET_SIZE, QUAL_SCORE_RANGE)),
            match=np.zeros((ALPHABET_SIZE, km, QUAL_SCORE_RANGE)),
            m2m=np.zeros(ki),
            m2i=np.zeros(ki),
            m2d=np.zeros(ki),
            m2e=np.zeros(ki),
        )


@dataclass
class QuaffParamCounts:
    """Counts in parameter space: emission counts plus yes/no counts for each
    Bernoulli transition parameter (reference QuaffParamCounts,
    qmodel.h:214-233).  Doubles as a conjugate prior (counts-as-
    pseudocounts)."""

    match_kmer_len: int = DEFAULT_MATCH_KMER_LEN
    indel_kmer_len: int = DEFAULT_INDEL_KMER_LEN
    insert: np.ndarray = field(
        default_factory=lambda: np.zeros((ALPHABET_SIZE, QUAL_SCORE_RANGE))
    )
    match: np.ndarray = field(
        default_factory=lambda: np.zeros(
            (ALPHABET_SIZE, ALPHABET_SIZE, QUAL_SCORE_RANGE)
        )
    )
    begin_insert_no: np.ndarray = field(default_factory=lambda: np.zeros(1))
    begin_insert_yes: np.ndarray = field(default_factory=lambda: np.zeros(1))
    begin_delete_no: np.ndarray = field(default_factory=lambda: np.zeros(1))
    begin_delete_yes: np.ndarray = field(default_factory=lambda: np.zeros(1))
    extend_insert_no: float = 0.0
    extend_insert_yes: float = 0.0
    extend_delete_no: float = 0.0
    extend_delete_yes: float = 0.0

    @classmethod
    def zero(cls, match_kmer_len: int = DEFAULT_MATCH_KMER_LEN,
             indel_kmer_len: int = DEFAULT_INDEL_KMER_LEN) -> "QuaffParamCounts":
        km = number_of_kmers(match_kmer_len)
        ki = number_of_kmers(indel_kmer_len)
        return cls(
            match_kmer_len=match_kmer_len,
            indel_kmer_len=indel_kmer_len,
            insert=np.zeros((ALPHABET_SIZE, QUAL_SCORE_RANGE)),
            match=np.zeros((ALPHABET_SIZE, km, QUAL_SCORE_RANGE)),
            begin_insert_no=np.zeros(ki),
            begin_insert_yes=np.zeros(ki),
            begin_delete_no=np.zeros(ki),
            begin_delete_yes=np.zeros(ki),
        )

    @classmethod
    def from_counts(cls, c: QuaffCounts) -> "QuaffParamCounts":
        """Transition-count -> parameter-count mapping (qmodel.cpp:407-417)."""
        out = cls.zero(c.match_kmer_len, c.indel_kmer_len)
        out.insert = c.insert.copy()
        out.match = c.match.copy()
        out.begin_insert_no = c.m2m + c.m2d
        out.begin_insert_yes = c.m2i + c.m2e
        out.extend_insert_no = c.i2m
        out.extend_insert_yes = c.i2i
        out.begin_delete_no = c.m2m.copy()
        out.begin_delete_yes = c.m2d.copy()
        out.extend_delete_no = c.d2m
        out.extend_delete_yes = c.d2d
        return out

    @property
    def num_match_kmers(self) -> int:
        return number_of_kmers(self.match_kmer_len)

    @property
    def num_indel_kmers(self) -> int:
        return number_of_kmers(self.indel_kmer_len)

    def init_counts(
        self,
        no_begin_count: float,
        yes_extend_count: float,
        match_ident_count: float,
        other_count: float,
        null_model: Optional[QuaffNullParams] = None,
    ) -> None:
        """Initialise pseudocounts, optionally shaped by a null model
        (qmodel.cpp:431-456)."""
        km = self.num_match_kmers
        if null_model is not None:
            nb = np.exp(null_model.log_qual_prob_table())  # [4, Q]
            for j in range(ALPHABET_SIZE):
                self.insert[j] = (
                    other_count * null_model.sym_prob[j] * ALPHABET_SIZE * nb[j]
                )
            for i in range(ALPHABET_SIZE):
                for j_prefix in range(0, km, ALPHABET_SIZE):
                    for j_suffix in range(ALPHABET_SIZE):
                        j = j_prefix + j_suffix
                        if i == j:
                            base = match_ident_count
                        else:
                            base = (
                                other_count
                                * null_model.sym_prob[j_suffix]
                                * ALPHABET_SIZE
                                / (1.0 - null_model.sym_prob[i])
                            )
                        self.match[i, j] = base * nb[j_suffix]
        else:
            self.insert[:] = other_count / QUAL_SCORE_RANGE
            for i in range(ALPHABET_SIZE):
                for j in range(km):
                    c = match_ident_count if i == j else other_count
                    self.match[i, j] = c / QUAL_SCORE_RANGE
        ki = self.num_indel_kmers
        self.begin_insert_no = np.full(ki, no_begin_count)
        self.begin_insert_yes = np.full(ki, other_count)
        self.extend_insert_no = other_count
        self.extend_insert_yes = yes_extend_count
        self.begin_delete_no = np.full(ki, no_begin_count)
        self.begin_delete_yes = np.full(ki, other_count)
        self.extend_delete_no = other_count
        self.extend_delete_yes = yes_extend_count

    def add_weighted(self, other: "QuaffParamCounts", weight: float) -> None:
        assert other.match_kmer_len == self.match_kmer_len
        assert other.indel_kmer_len == self.indel_kmer_len
        self.insert += weight * other.insert
        self.match += weight * other.match
        self.begin_insert_no = self.begin_insert_no + weight * other.begin_insert_no
        self.begin_insert_yes = self.begin_insert_yes + weight * other.begin_insert_yes
        self.begin_delete_no = self.begin_delete_no + weight * other.begin_delete_no
        self.begin_delete_yes = self.begin_delete_yes + weight * other.begin_delete_yes
        self.extend_insert_no += weight * other.extend_insert_no
        self.extend_insert_yes += weight * other.extend_insert_yes
        self.extend_delete_no += weight * other.extend_delete_no
        self.extend_delete_yes += weight * other.extend_delete_yes

    def fit(self) -> QuaffParams:
        """M-step: ratio estimators + negative-binomial refits
        (qmodel.cpp:1733-1768)."""
        qp = QuaffParams.create(self.match_kmer_len, self.indel_kmer_len)
        # C++ float semantics (0/0 -> nan, x/0 -> inf -> prob 0), matching
        # the reference's unguarded ratio estimators (qmodel.cpp:1735-1740)
        with np.errstate(divide="ignore", invalid="ignore"):
            qp.begin_delete = 1.0 / (1.0 + self.begin_delete_no / self.begin_delete_yes)
            qp.begin_insert = 1.0 / (1.0 + self.begin_insert_no / self.begin_insert_yes)
            qp.extend_delete = float(
                1.0 / (1.0 + np.float64(self.extend_delete_no) / self.extend_delete_yes)
            )
            qp.extend_insert = float(
                1.0 / (1.0 + np.float64(self.extend_insert_no) / self.extend_insert_yes)
            )

        ins_freq = np.sum(self.insert, axis=1)
        with np.errstate(divide="ignore", invalid="ignore"):
            qp.insert_prob = ins_freq / np.sum(ins_freq)
        for i in range(ALPHABET_SIZE):
            qp.insert_q[i], qp.insert_r[i] = fit_negative_binomial(self.insert[i])

        km = self.num_match_kmers
        for i in range(ALPHABET_SIZE):
            for j_prefix in range(0, km, ALPHABET_SIZE):
                block = self.match[i, j_prefix : j_prefix + ALPHABET_SIZE]
                freq = np.sum(block, axis=1)
                norm = np.sum(freq)
                for j_suffix in range(ALPHABET_SIZE):
                    j = j_prefix + j_suffix
                    qp.match_prob[i, j] = freq[j_suffix] / norm
                    qp.match_q[i, j], qp.match_r[i, j] = fit_negative_binomial(
                        self.match[i, j]
                    )
        return qp

    def log_prior(self, qp: QuaffParams) -> float:
        """Log-density of params under the counts-as-pseudocounts prior
        (beta pdfs for Bernoullis, dirichlet for symbol probs, NB likelihood
        of the quality pseudo-counts; qmodel.cpp:1681-1710)."""
        lp = 0.0
        for j in range(self.num_indel_kmers):
            lp += _log_beta_pdf(qp.begin_insert[j], self.begin_insert_yes[j], self.begin_insert_no[j])
            lp += _log_beta_pdf(qp.begin_delete[j], self.begin_delete_yes[j], self.begin_delete_no[j])
        lp += _log_beta_pdf(qp.extend_insert, self.extend_insert_yes, self.extend_insert_no)
        lp += _log_beta_pdf(qp.extend_delete, self.extend_delete_yes, self.extend_delete_no)
        ks = np.arange(QUAL_SCORE_RANGE)
        theta = qp.insert_prob
        alpha = np.sum(self.insert, axis=1) + 1.0
        for i in range(ALPHABET_SIZE):
            lp += float(
                np.dot(
                    self.insert[i],
                    log_negative_binomial_array(ks, qp.insert_q[i], qp.insert_r[i]),
                )
            )
        lp += _log_dirichlet_pdf(theta, alpha)
        km = self.num_match_kmers
        for i in range(ALPHABET_SIZE):
            for j_prefix in range(0, km, ALPHABET_SIZE):
                theta = np.zeros(ALPHABET_SIZE)
                alpha = np.zeros(ALPHABET_SIZE)
                for j_suffix in range(ALPHABET_SIZE):
                    j = j_prefix + j_suffix
                    lp += float(
                        np.dot(
                            self.match[i, j],
                            log_negative_binomial_array(ks, qp.match_q[i, j], qp.match_r[i, j]),
                        )
                    )
                    theta[j_suffix] = qp.match_prob[i, j]
                    alpha[j_suffix] = np.sum(self.match[i, j]) + 1.0
                lp += _log_dirichlet_pdf(theta, alpha)
        return lp

    def expected_log_like(self, qp: QuaffParams) -> float:
        """Unnormalised expected complete log-likelihood (qmodel.cpp:1712-1731)."""
        ll = 0.0
        for j in range(self.num_indel_kmers):
            ll += math.log(qp.begin_insert[j]) * self.begin_insert_yes[j]
            ll += math.log1p(-qp.begin_insert[j]) * self.begin_insert_no[j]
            ll += math.log(qp.begin_delete[j]) * self.begin_delete_yes[j]
            ll += math.log1p(-qp.begin_delete[j]) * self.begin_delete_no[j]
        ll += math.log(qp.extend_insert) * self.extend_insert_yes
        ll += math.log1p(-qp.extend_insert) * self.extend_insert_no
        ll += math.log(qp.extend_delete) * self.extend_delete_yes
        ll += math.log1p(-qp.extend_delete) * self.extend_delete_no
        ks = np.arange(QUAL_SCORE_RANGE)
        for i in range(ALPHABET_SIZE):
            ll += float(
                np.dot(
                    self.insert[i],
                    log_negative_binomial_array(ks, qp.insert_q[i], qp.insert_r[i]),
                )
            )
            ll += math.log(qp.insert_prob[i]) * float(np.sum(self.insert[i]))
        for i in range(ALPHABET_SIZE):
            for j in range(self.num_match_kmers):
                ll += float(
                    np.dot(
                        self.match[i, j],
                        log_negative_binomial_array(ks, qp.match_q[i, j], qp.match_r[i, j]),
                    )
                )
                ll += math.log(qp.match_prob[i, j]) * float(np.sum(self.match[i, j]))
        return ll

    # -- JSON -------------------------------------------------------------

    def _write_emit_json(self, out: IO[str]) -> None:
        """Emission-count block (reference QuaffEmitCounts::writeJson,
        qmodel.cpp:341-362)."""
        if self.match_kmer_len != DEFAULT_MATCH_KMER_LEN:
            out.write(f'  "matchOrder": {self.match_kmer_len},\n')
        if self.indel_kmer_len != DEFAULT_INDEL_KMER_LEN:
            out.write(f'  "gapOrder": {self.indel_kmer_len},\n')
        out.write('  "insert": {\n')
        for i, c in enumerate(DNA_ALPHABET):
            out.write(f'    "{c}": {_count_array_json(self.insert[i])}')
            out.write(" },\n" if i == ALPHABET_SIZE - 1 else ",\n")
        out.write('  "match": {\n')
        km = self.num_match_kmers
        for j_prefix in range(0, km, ALPHABET_SIZE):
            out.write(f'   "{_kmer_prefix(j_prefix, self.match_kmer_len)}": {{\n')
            for i, c in enumerate(DNA_ALPHABET):
                out.write(f'    "{c}": {{\n')
                for j_suffix, cs in enumerate(DNA_ALPHABET):
                    j = j_prefix + j_suffix
                    out.write(f'      "{cs}": {_count_array_json(self.match[i, j])}')
                    out.write(" }" if j_suffix == ALPHABET_SIZE - 1 else ",\n")
                out.write(" }" if i == ALPHABET_SIZE - 1 else ",\n")
            out.write(" }\n" if j_prefix == km - ALPHABET_SIZE else ",\n")

    def _write_kmer_map(self, out: IO[str], name: str, values: np.ndarray) -> None:
        out.write(f'  "{name}": {{')
        for j in range(self.num_indel_kmers):
            out.write("" if j == 0 else ",")
            out.write(f' "{_kmer_string(j, self.indel_kmer_len)}": {fmt(values[j])}')
        out.write(" }")

    def write_json(self, out: IO[str]) -> None:
        out.write("{\n")
        self._write_emit_json(out)
        out.write(",\n")
        self._write_kmer_map(out, "beginInsertNo", self.begin_insert_no)
        out.write(",\n")
        self._write_kmer_map(out, "beginInsertYes", self.begin_insert_yes)
        out.write(",\n")
        self._write_kmer_map(out, "beginDeleteNo", self.begin_delete_no)
        out.write(",\n")
        self._write_kmer_map(out, "beginDeleteYes", self.begin_delete_yes)
        out.write(",\n")
        out.write(f'  "extendInsertNo": {fmt(self.extend_insert_no)},\n')
        out.write(f'  "extendInsertYes": {fmt(self.extend_insert_yes)},\n')
        out.write(f'  "extendDeleteNo": {fmt(self.extend_delete_no)},\n')
        out.write(f'  "extendDeleteYes": {fmt(self.extend_delete_yes)} }}')

    @classmethod
    def from_json(cls, data) -> "QuaffParamCounts":
        if isinstance(data, str):
            data = gason_loads(data)
        match_kmer_len = int(data.get("matchOrder", DEFAULT_MATCH_KMER_LEN))
        indel_kmer_len = int(data.get("gapOrder", DEFAULT_INDEL_KMER_LEN))
        out = cls.zero(match_kmer_len, indel_kmer_len)
        for i, c in enumerate(DNA_ALPHABET):
            out.insert[i] = np.asarray(data["insert"][c], dtype=np.float64)
        for j_prefix in range(0, out.num_match_kmers, ALPHABET_SIZE):
            prefix_key = _kmer_prefix(j_prefix, match_kmer_len)
            for i, c in enumerate(DNA_ALPHABET):
                for j_suffix, cs in enumerate(DNA_ALPHABET):
                    out.match[i, j_prefix + j_suffix] = np.asarray(
                        data["match"][prefix_key][c][cs], dtype=np.float64
                    )
        for j in range(out.num_indel_kmers):
            key = _kmer_string(j, indel_kmer_len)
            out.begin_insert_no[j] = float(data["beginInsertNo"][key])
            out.begin_insert_yes[j] = float(data["beginInsertYes"][key])
            out.begin_delete_no[j] = float(data["beginDeleteNo"][key])
            out.begin_delete_yes[j] = float(data["beginDeleteYes"][key])
        out.extend_insert_no = float(data["extendInsertNo"])
        out.extend_insert_yes = float(data["extendInsertYes"])
        out.extend_delete_no = float(data["extendDeleteNo"])
        out.extend_delete_yes = float(data["extendDeleteYes"])
        return out


def _count_array_json(values: np.ndarray) -> str:
    return "[ " + ", ".join(fmt(v) for v in values) + " ]"


def _log_beta_pdf(prob: float, yes_count: float, no_count: float) -> float:
    """log Beta(prob; yes+1, no+1) (qmodel.cpp:35-37)."""
    a, b = yes_count + 1.0, no_count + 1.0
    return (
        (a - 1.0) * math.log(prob)
        + (b - 1.0) * math.log1p(-prob)
        - (math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b))
    )


def _log_dirichlet_pdf(theta: np.ndarray, alpha: np.ndarray) -> float:
    lg = np.vectorize(math.lgamma, otypes=[np.float64])
    return float(
        np.dot(alpha - 1.0, np.log(theta))
        - np.sum(lg(alpha))
        + math.lgamma(float(np.sum(alpha)))
    )


# ---------------------------------------------------------------------------

_DEFAULT_PARAMS_JSON = None


def default_params() -> QuaffParams:
    """The compiled-in nanopore-trained parameter set (reference
    src/defaultparams.cpp, regenerated from data/defaultparams.json)."""
    global _DEFAULT_PARAMS_JSON
    if _DEFAULT_PARAMS_JSON is None:
        import pathlib

        path = pathlib.Path(__file__).parent / "defaultparams.json"
        _DEFAULT_PARAMS_JSON = path.read_text()
    return QuaffParams.from_json(_DEFAULT_PARAMS_JSON)
