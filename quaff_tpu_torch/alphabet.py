"""DNA alphabet, tokenisation and k-mer packing.

Capability parity with the reference's src/fastseq.{h,cpp} token/k-mer layer
(tokenize fastseq.cpp:11, makeKmer fastseq.cpp:27, kmers fastseq.cpp:85,
revcomp fastseq.cpp:210) but vectorised with numpy: sequences are tokenised
once into int8 arrays and k-mer codes are computed with rolling base-4
arithmetic rather than per-position loops.
"""

from __future__ import annotations

import numpy as np

DNA_ALPHABET = "ACGT"
ALPHABET_SIZE = 4

MIN_QUALITY_CHAR = "!"
MAX_QUALITY_CHAR = "~"
QUAL_SCORE_RANGE = 94  # '!'..'~' inclusive

# token lookup table: ASCII byte -> token, -1 if not ACGT (case-insensitive)
_TOKEN_TABLE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(DNA_ALPHABET):
    _TOKEN_TABLE[ord(_c)] = _i
    _TOKEN_TABLE[ord(_c.lower())] = _i

_COMPLEMENT_CHAR = np.arange(256, dtype=np.uint8)
for _i, _c in enumerate(DNA_ALPHABET):
    _comp = DNA_ALPHABET[ALPHABET_SIZE - 1 - _i]
    _COMPLEMENT_CHAR[ord(_c)] = ord(_comp)
    _COMPLEMENT_CHAR[ord(_c.lower())] = ord(_comp.lower())


def tokenize_char(c: str) -> int:
    """Single-character token; -1 if not in the DNA alphabet."""
    return int(_TOKEN_TABLE[ord(c)])


def tokens(seq: str) -> np.ndarray:
    """Tokenise a sequence string to an int array; raises on unknown symbols."""
    b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    tok = _TOKEN_TABLE[b]
    if np.any(tok < 0):
        bad = seq[int(np.argmax(tok < 0))]
        raise ValueError(f"Unknown symbol {bad} in sequence")
    return tok.astype(np.int32)


def dna_complement(token: int) -> int:
    return ALPHABET_SIZE - 1 - token


def revcomp_str(seq: str) -> str:
    b = np.frombuffer(seq.encode("latin-1"), dtype=np.uint8)
    return _COMPLEMENT_CHAR[b][::-1].tobytes().decode("latin-1")


def number_of_kmers(k: int, alphabet_size: int = ALPHABET_SIZE) -> int:
    return alphabet_size ** k


def kmer_to_string(kmer: int, k: int, alphabet: str = DNA_ALPHABET) -> str:
    out = []
    for _ in range(k):
        out.append(alphabet[kmer % len(alphabet)])
        kmer //= len(alphabet)
    return "".join(reversed(out))


def string_to_kmer(s: str, alphabet: str = DNA_ALPHABET) -> int:
    code = 0
    for c in s:
        code = code * len(alphabet) + alphabet.index(c)
    return code


def kmer_codes(tok: np.ndarray, k: int) -> np.ndarray:
    """Base-4 codes of all length-k windows: out[i] = code of tok[i:i+k].

    Length is len(tok) - k + 1 (empty if the sequence is shorter than k).
    """
    n = len(tok) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    code = np.zeros(n, dtype=np.int64)
    for j in range(k):
        code = code * ALPHABET_SIZE + tok[j : j + n].astype(np.int64)
    return code


def context_kmers(tok: np.ndarray, k: int) -> np.ndarray:
    """Per-position k-mer context codes, one per sequence position.

    Matches the semantics of the reference FastSeq::kmers (fastseq.cpp:85-99):
    position p gets the code of the k-mer *ending* at p; the sequence is
    left-padded with k-1 copies of its most frequent token so every position
    has a context.  k == 0 yields all zeros.
    """
    n = len(tok)
    if k == 0:
        return np.zeros(n, dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    counts = np.bincount(tok, minlength=ALPHABET_SIZE)
    most_frequent = int(np.argmax(counts))
    padded = np.concatenate([np.full(k - 1, most_frequent, dtype=tok.dtype), tok])
    return kmer_codes(padded, k)


def qual_scores(qual: str) -> np.ndarray:
    """Quality string -> clamped integer scores in [0, QUAL_SCORE_RANGE)."""
    b = np.frombuffer(qual.encode("latin-1"), dtype=np.uint8).astype(np.int32)
    return np.clip(b - ord(MIN_QUALITY_CHAR), 0, QUAL_SCORE_RANGE - 1)


def qual_chars(scores: np.ndarray) -> str:
    b = np.clip(scores + ord(MIN_QUALITY_CHAR), ord(MIN_QUALITY_CHAR), ord(MAX_QUALITY_CHAR))
    return b.astype(np.uint8).tobytes().decode("latin-1")
