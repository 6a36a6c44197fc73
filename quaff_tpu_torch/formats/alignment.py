"""Pairwise alignment container and text output formats.

Byte-parity reimplementation of the reference Alignment writers
(src/qmodel.cpp:545-676): gapped FASTA, Stockholm (80-column blocks,
#=GR quality rows, #=GC identity consensus), SAM (with revcomp
normalisation and the reference's char-before-count CIGAR convention),
and ungapped reference extraction.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import IO, List

from ..io.fastseq import FastSeq
from ..model.params import fmt

GAP_CHAR = "-"
MISMATCH_CHAR = ":"
MAX_QUALITY_CHAR = "~"


def is_gap_char(c: str) -> bool:
    return c == "-" or c == "."


@dataclass
class Alignment:
    gapped_seq: List[FastSeq] = field(default_factory=list)
    score: float = -math.inf

    @property
    def rows(self) -> int:
        return len(self.gapped_seq)

    @property
    def columns(self) -> int:
        return len(self.gapped_seq[0].seq) if self.gapped_seq else 0

    def write_gapped_fasta(self, out: IO[str]) -> None:
        for s in self.gapped_seq:
            s.write_fasta(out)

    def write_stockholm(self, out: IO[str]) -> None:
        row_name: List[str] = []
        row_data: List[str] = []
        row_index: List[int] = []
        for s in self.gapped_seq:
            row_index.append(len(row_name))
            row_name.append(s.name)
            row_data.append(s.seq)
            if s.has_qual():
                row_name.append(f"#=GR {s.name} QS")
                row_data.append(s.qual)

        if self.rows == 2:
            import numpy as np

            a0 = np.frombuffer(
                self.gapped_seq[0].seq.upper().encode("latin-1"), np.uint8
            )
            a1 = np.frombuffer(
                self.gapped_seq[1].seq.upper().encode("latin-1"), np.uint8
            )
            gap = (
                (a0 == ord("-")) | (a0 == ord("."))
                | (a1 == ord("-")) | (a1 == ord("."))
            )
            cons_a = np.where(
                gap,
                np.uint8(ord(GAP_CHAR)),
                np.where(a0 == a1, a0, np.uint8(ord(MISMATCH_CHAR))),
            )
            row_name.insert(row_index[1], "#=GC id")
            row_data.insert(
                row_index[1], cons_a.tobytes().decode("latin-1")
            )
            if self.gapped_seq[0].has_qual():
                row_name[0], row_name[1] = row_name[1], row_name[0]
                row_data[0], row_data[1] = row_data[1], row_data[0]

        name_width = max(len(s) for s in row_name)
        data_width = max(name_width, 79 - name_width)

        # one join + one write: an alignment spans hundreds of 80-column
        # block lines, and per-line f-string writes were ~0.26 ms per
        # alignment — a serial tail at all-vs-all output volumes
        parts = ["# STOCKHOLM 1.0\n", f"#=GF Score {fmt(self.score)}\n"]
        for s in self.gapped_seq:
            if s.comment:
                parts.append(f"#=GS CC {s.name} {s.comment}\n")
        pad_name = [f"{name:<{name_width}} " for name in row_name]
        for col in range(0, self.columns, data_width):
            if col > 0:
                parts.append("\n")
            for pn, data in zip(pad_name, row_data):
                parts.append(pn)
                parts.append(data[col : col + data_width])
                parts.append("\n")
        parts.append("//\n")
        out.write("".join(parts))

    def cigar_string(self) -> str:
        assert self.rows == 2
        import numpy as np

        a0 = np.frombuffer(self.gapped_seq[0].seq.encode("latin-1"), np.uint8)
        a1 = np.frombuffer(self.gapped_seq[1].seq.encode("latin-1"), np.uint8)
        g0 = (a0 == ord("-")) | (a0 == ord("."))
        g1 = (a1 == ord("-")) | (a1 == ord("."))
        code = np.where(
            ~g0 & ~g1, 0, np.where(~g0 & g1, 1, np.where(g0 & ~g1, 2, 3))
        )
        code = code[code != 3]  # both-gap columns contribute nothing
        if code.size == 0:
            return ""
        b = np.flatnonzero(np.diff(code)) + 1
        starts = np.concatenate(([0], b))
        ends = np.concatenate((b, [code.size]))
        return "".join(
            "MDI"[code[s]] + str(e - s) for s, e in zip(starts, ends)
        )

    def revcomp(self) -> "Alignment":
        out = Alignment(
            gapped_seq=[s.revcomp() for s in self.gapped_seq], score=self.score
        )
        return out

    def write_sam(self, out: IO[str]) -> None:
        assert self.rows == 2, "SAM output is for pairwise alignments"
        if self.gapped_seq[0].source.rev:
            self.revcomp().write_sam(out)
            return
        flag = 16 if self.gapped_seq[1].source.rev else 0
        # The reference's SeqIdx is uint32 (fastseq.h:14): the coord
        # compose chain for a reverse-strand SAM row can go "negative"
        # and the reference prints the WRAPPED value (e.g. -391 →
        # 4294966905, qmodel.cpp:614).  +/- commute with mod 2^32, so
        # wrapping the final signed value reproduces it bit-for-bit.
        pos = self.gapped_seq[0].source.start % (1 << 32)
        out.write(
            f"{self.gapped_seq[1].source.name}\t{flag}\t"
            f"{self.gapped_seq[0].source.name}\t{pos}"
            f"\t0\t{self.cigar_string()}\t*\t0\t0\t*\t*\t"
            f"AS:i:{int(_cpp_round(self.score))}\n"
        )

    @staticmethod
    def write_sam_header(out: IO[str], seqs: List[FastSeq], go_so: str = "SO:unknown") -> None:
        out.write(f"@HD\tVN:1.0\t{go_so}\n")
        for s in seqs:
            if s.source.is_null():
                out.write(f"@SQ\tSN:{s.name}\tLN:{len(s.seq)}\n")

    def get_ungapped(self, row: int) -> FastSeq:
        g = self.gapped_seq[row]
        s = FastSeq(name=g.name, comment=g.comment, source=g.source,
                    filename=g.filename, filepos=g.filepos)
        seq_chars, qual_chars = [], []
        for pos, c in enumerate(g.seq):
            if not is_gap_char(c):
                seq_chars.append(c)
                if g.has_qual():
                    qual_chars.append(g.qual[pos])
        s.seq = "".join(seq_chars)
        s.qual = "".join(qual_chars)
        return s


def _cpp_round(x: float) -> float:
    """C's round(): halfway cases away from zero (Python round is to-even)."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


class OutputFormat(enum.Enum):
    GAPPED_FASTA = "fasta"
    STOCKHOLM = "stockholm"
    SAM = "sam"
    REFSEQ = "refseq"


@dataclass
class AlignmentPrinter:
    """Format dispatch + log-odds threshold filter (reference
    QuaffAlignmentPrinter, qmodel.cpp:2480-2600)."""

    format: OutputFormat = OutputFormat.STOCKHOLM
    log_odds_threshold: float = 0.0

    def write_header(self, out: IO[str], refs: List[FastSeq], group_by_query: bool) -> None:
        if self.format == OutputFormat.SAM:
            Alignment.write_sam_header(
                out, refs, "GO:query" if group_by_query else "SO:unknown"
            )

    def write_alignment(self, out: IO[str], align: Alignment) -> None:
        if align.score < self.log_odds_threshold:
            return
        if self.format == OutputFormat.GAPPED_FASTA:
            align.write_gapped_fasta(out)
            out.write("\n")
        elif self.format == OutputFormat.STOCKHOLM:
            align.write_stockholm(out)
        elif self.format == OutputFormat.SAM:
            align.write_sam(out)
        elif self.format == OutputFormat.REFSEQ:
            assert align.rows == 2
            ref = align.get_ungapped(0)
            ref.comment = f"matches({align.gapped_seq[1].name}) {ref.comment}"
            ref.write_fasta(out)
