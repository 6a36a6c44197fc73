"""FASTA/FASTQ sequence I/O with gzip transparency.

Replicates the observable behaviour of the reference's kseq-based reader
(src/fastseq.cpp:139-198, kseq/kseq.h): records start at '>' or '@', the
name is the first whitespace-delimited token and the rest of the line is the
comment, sequence lines are concatenated until the next record or a '+'
line, and quality strings are kept only when their length matches the
sequence length (truncated-quality records degrade to no-quality records).
Per-record uncompressed byte offsets are recorded so a single record can be
re-read by seek (the reference's -readindex mechanism, fastseq.cpp:178).
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np

from ..alphabet import (
    QUAL_SCORE_RANGE,
    context_kmers,
    kmer_codes,
    qual_scores,
    revcomp_str,
    tokens,
)

MIN_QUALITY_CHAR = "!"
MAX_QUALITY_CHAR = "~"


@dataclass
class SeqIntervalCoords:
    """Provenance of a subsequence: 1-based closed interval, optional revcomp.

    Mirrors the reference SeqIntervalCoords (fastseq.h:30-40) including
    interval composition for nested substring/revcomp provenance
    (fastseq.cpp:51-65).
    """

    name: str = ""
    start: int = 0
    end: int = 0
    rev: bool = False

    def is_null(self) -> bool:
        return self.name == ""

    def compose(self, src: "SeqIntervalCoords") -> "SeqIntervalCoords":
        if src.is_null():
            return self
        out = SeqIntervalCoords()
        out.name = src.name
        out.rev = self.rev != src.rev
        if src.rev:
            out.start = src.end - self.end + 1
            out.end = src.end - self.start + 1
        else:
            out.start = self.start + src.start - 1
            out.end = self.end + src.start - 1
        return out


@dataclass
class FastSeq:
    name: str = ""
    comment: str = ""
    seq: str = ""
    qual: str = ""
    source: SeqIntervalCoords = field(default_factory=SeqIntervalCoords)
    filename: str = ""
    filepos: int = -1

    def __len__(self) -> int:
        return len(self.seq)

    @property
    def length(self) -> int:
        return len(self.seq)

    def has_qual(self) -> bool:
        return len(self.qual) == len(self.seq) and len(self.seq) > 0

    def tokens(self) -> np.ndarray:
        """Token array, memoized per seq-string identity (batch pipelines
        re-derive it hundreds of times per read).  The cached array is
        read-only; callers needing a mutable copy must .copy()."""
        c = self.__dict__.get("_tok_cache")
        if c is None or c[0] is not self.seq:
            try:
                arr = tokens(self.seq)
            except ValueError as e:
                # reference names the offending record (fastseq.cpp
                # tokenize: "Unknown symbol N in sequence q")
                raise ValueError(f"{e} {self.name}") from None
            arr.setflags(write=False)
            c = (self.seq, arr)
            self.__dict__["_tok_cache"] = c
        return c[1]

    def kmers(self, k: int) -> np.ndarray:
        """Per-position k-mer context codes (see alphabet.context_kmers),
        memoized like tokens(); read-only."""
        c = self.__dict__.get("_kmer_cache")
        if c is None or c[0] is not self.seq or c[1] != k:
            arr = context_kmers(self.tokens(), k)
            arr.setflags(write=False)
            c = (self.seq, k, arr)
            self.__dict__["_kmer_cache"] = c
        return c[2]

    def qual_scores(self) -> np.ndarray:
        if not self.has_qual():
            return np.zeros(0, dtype=np.int32)
        c = self.__dict__.get("_qual_cache")
        if c is None or c[0] is not self.qual:
            arr = qual_scores(self.qual)
            arr.setflags(write=False)
            c = (self.qual, arr)
            self.__dict__["_qual_cache"] = c
        return c[1]

    def revcomp(self) -> "FastSeq":
        fs = FastSeq()
        fs.name = f"revcomp({self.name})"
        fs.comment = self.comment
        fs.seq = revcomp_str(self.seq)
        fs.qual = self.qual[::-1]
        fs.filename = self.filename
        fs.filepos = self.filepos
        coords = SeqIntervalCoords(self.name, 1, len(self.seq), True)
        fs.source = coords.compose(self.source)
        return fs

    def write_fasta(self, out) -> None:
        out.write(f">{self.name}")
        if self.comment:
            out.write(f" {self.comment}")
        out.write("\n")
        out.write(self.seq + "\n")

    def write_fastq(self, out) -> None:
        out.write(f"@{self.name}")
        if self.comment:
            out.write(f" {self.comment}")
        out.write("\n")
        out.write(self.seq + "\n")
        if self.has_qual():
            out.write("+\n" + self.qual + "\n")


def _open_maybe_gz(filename: str):
    f = open(filename, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return gzip.GzipFile(fileobj=f)
    return f


class _RecordParser:
    """Streaming record parser over an uncompressed byte stream."""

    def __init__(self, stream):
        self.stream = _io.BufferedReader(stream) if not isinstance(
            stream, _io.BufferedReader
        ) else stream
        self.offset = 0  # uncompressed offset of the next byte to read
        self._peeked: Optional[bytes] = None
        self._peeked_at = 0

    def _readline(self) -> Optional[bytes]:
        if self._peeked is not None:
            line, self._peeked = self._peeked, None
            return line
        line = self.stream.readline()
        if not line:
            return None
        self.offset += len(line)
        return line

    def _peekline(self) -> Optional[bytes]:
        if self._peeked is None:
            self._peeked_at = self.offset
            self._peeked = self._readline()
            if self._peeked is None:
                return None
        return self._peeked

    def records(self):
        # skip to first header
        while True:
            pos = self.offset if self._peeked is None else self._peeked_at
            line = self._readline()
            if line is None:
                return
            s = line.strip()
            if s.startswith(b">") or s.startswith(b"@"):
                rec = self._parse_record(s)
                if rec is not None:
                    rec.filepos = pos
                    yield rec

    def _parse_record(self, header: bytes) -> Optional[FastSeq]:
        rec = FastSeq()
        head = header[1:].decode("latin-1")
        parts = head.split(None, 1)
        rec.name = parts[0] if parts else ""
        rec.comment = parts[1] if len(parts) > 1 else ""
        seq_parts: List[bytes] = []
        has_plus = False
        while True:
            line = self._peekline()
            if line is None:
                break
            s = line.strip()
            if s.startswith(b">") or s.startswith(b"@"):
                break
            self._readline()
            if s.startswith(b"+"):
                has_plus = True
                break
            seq_parts.append(s)
        rec.seq = b"".join(seq_parts).decode("latin-1")
        if has_plus:
            qual_parts: List[bytes] = []
            qlen = 0
            while qlen < len(rec.seq):
                line = self._readline()
                if line is None:
                    break
                s = line.rstrip(b"\r\n")
                qual_parts.append(s)
                qlen += len(s)
            qual = b"".join(qual_parts).decode("latin-1")
            if len(qual) == len(rec.seq):
                rec.qual = qual
        return rec


def read_fast_seqs(filename: str) -> List[FastSeq]:
    import os

    if os.environ.get("QUAFF_TPU_NATIVE", "1") != "0":
        from .. import native

        if native.available():
            recs = native.read_fast_seqs_native(filename)
            if recs is not None:
                return recs
    seqs: List[FastSeq] = []
    with _open_maybe_gz(filename) as f:
        parser = _RecordParser(f)
        for rec in parser.records():
            rec.filename = filename
            seqs.append(rec)
    return seqs


def read_indexed_fast_seq(filename: str, filepos: int) -> FastSeq:
    """Read the single record starting at (uncompressed) byte offset filepos."""
    with _open_maybe_gz(filename) as f:
        f.read(filepos) if filepos > 0 else None
        parser = _RecordParser(f)
        for rec in parser.records():
            rec.filename = filename
            rec.filepos = filepos
            return rec
    raise IOError(f"Couldn't read sequence starting at byte {filepos} in {filename}")


def write_fasta(out, seqs: List[FastSeq]) -> None:
    for s in seqs:
        s.write_fasta(out)


def write_fastq(out, seqs: List[FastSeq]) -> None:
    for s in seqs:
        s.write_fastq(out)


def duplicate_names(seqs: List[FastSeq]) -> Set[str]:
    seen: Set[str] = set()
    dups: Set[str] = set()
    for s in seqs:
        if s.name in seen:
            dups.add(s.name)
        seen.add(s.name)
    return dups


def add_revcomps(seqs: List[FastSeq]) -> List[FastSeq]:
    return seqs + [s.revcomp() for s in seqs]


def make_name_index(seqs: List[FastSeq]) -> Dict[str, int]:
    return {s.name: i for i, s in enumerate(seqs)}


class KmerIndex:
    """Sorted k-mer -> positions index of one sequence.

    Equivalent information to the reference KmerIndex (fastseq.cpp:240-256)
    but stored as parallel sorted arrays so envelope seeding can join
    against it with vectorised searchsorted instead of per-k-mer hash
    lookups.
    Positions are 0-based window start offsets.
    """

    def __init__(self, seq: FastSeq, kmer_len: int):
        self.seq = seq
        self.kmer_len = kmer_len
        tok = seq.tokens()
        codes = kmer_codes(tok, kmer_len)
        order = np.argsort(codes, kind="stable")
        self.sorted_codes = codes[order]
        self.sorted_positions = np.arange(len(codes), dtype=np.int64)[order]
        self._native_index = False  # lazy (see native_index)

    def native_index(self):
        """Prebuilt native counting-bucket index (or None), built on
        first use: all-vs-all prep joins ~N partners against the same
        y, and the per-pair index rebuild was ~60% of the native
        k-mer-join wall."""
        if self._native_index is False:
            from ..native import diag_kmer_index_native

            self._native_index = diag_kmer_index_native(
                self.seq.tokens(), self.kmer_len
            )
        return self._native_index
