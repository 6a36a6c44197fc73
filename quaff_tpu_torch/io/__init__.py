from .fastseq import (  # noqa: F401
    FastSeq,
    SeqIntervalCoords,
    KmerIndex,
    read_fast_seqs,
    read_indexed_fast_seq,
    write_fasta,
    write_fastq,
    add_revcomps,
    duplicate_names,
    make_name_index,
)
