"""quaff-compatible command line for the PyTorch port:

    python -m quaff_tpu_torch.cli align refs.fasta reads.fastq [options]

Ported from quaff_tpu/cli.py.  The flag surface and its parsing are
quaff_tpu.cli's own jax-free helpers; the output stream and null-model
handling are written here because quaff_tpu's versions reach JAX through
its multi-host module.  The device comes from $QUAFF_TORCH_DEVICE
("cuda" by default, "cpu" for the plain PyTorch versions).

Only `align` is ported.  train, count, overlap and server, and align's
-mesh, multi-host, -remote (ssh), -qsubjobs, EC2 and -profile options,
exit 1 with "not yet ported".
"""

from __future__ import annotations

import sys
from collections import deque
from types import SimpleNamespace
from typing import List, Optional

from quaff_tpu.cli import (
    DEFAULT_REFSEQ_KMER_THRESHOLD,
    SeqListArgs,
    _load_params,
    _parse_dp_config,
    _parse_model_files,
    _parse_printer,
    _parse_unknown,
    _parse_verbosity,
)

PROG = "quaff-tpu-torch"
VERSION = "0.1"
NOT_PORTED = "not yet ported in quaff_tpu_torch"

USAGE = f"""Usage: {PROG} align refs.fasta reads.fastq [options]

 {PROG} align refs.fasta reads.fastq
  (to align FASTQ reads to FASTA reference sequences, using Viterbi;
   pairs are scored on $QUAFF_TORCH_DEVICE, default cuda)

   -printall       Print all pairwise alignments, not just best for each read
   -threshold <n>, -nothreshold    Log-odds score threshold
   -noquals        Ignore read quality scores during alignment
   -savealign <file>               Stream alignments to file
   -format {{fasta,stockholm,sam,refseq}}
   -params <file>  Load model parameters from file
   -ref <file>, -read <file>       Load additional sequences
   -fwdstrand      Do not include reverse-complemented sequences
   -global         Force all of refseq to be aligned
   -null <file>, -savenull <file>  Load/save null model
   -kmatch <k>, -kmatchn <n>, -kmatchband <n>, -kmatchmb <M>,
   -kmatchmax, -kmatchoff          k-mer envelope options
   -threads <n>    Host threads for envelopes and winner tracebacks
   -v, -vv, -log <tag>, -nocolor   Logging

train, count, overlap and server are {NOT_PORTED}.
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = deque(argv)
    if not args:
        sys.stderr.write(f"Usage: {PROG} {{help,align}} [options]\n")
        return 1
    command = args.popleft()
    if command in ("help", "-help", "--help", "-h"):
        sys.stdout.write(USAGE)
        return 0
    if command in ("version", "-version", "--version", "-V"):
        sys.stdout.write(f"{PROG} {VERSION}\n")
        return 0
    if command in ("train", "count", "overlap", "server"):
        sys.stderr.write(f"{command}: {NOT_PORTED}\n")
        return 1
    if command != "align":
        sys.stderr.write(f"Unrecognized command: {command}\n")
        return 1
    try:
        return _cmd_align(args, {})
    except (ValueError, OSError, RuntimeError) as e:
        # the reference exits with failure status on any error
        # (t/quaff.cpp:321-323)
        sys.stderr.write(f"{e}\n")
        return 1


def _parse_target():
    """What quaff_tpu.cli._parse_dp_config writes into: the port's DPConfig
    fields, plus the backend fields it fills from -remote, -qsub*, -ec2*,
    -mesh and the multi-host flags (any other attribute it sets is only
    bookkeeping for those backends)."""
    from dataclasses import asdict

    from .aligner import DPConfig

    return SimpleNamespace(
        **asdict(DPConfig()), remotes=[], remote_jobs=[], qsub_jobs=0,
        qsub_opts="", ec2_instances=0, use_mesh=False, coordinator="",
        n_procs=0, proc_id=-1,
    )


def _refuse_unported(parsed, state) -> None:
    """Backends and options that quaff_tpu's align honours but this port
    does not have yet: refuse them rather than ignore them."""
    named = []
    if parsed.use_mesh:
        named.append("-mesh")
    if parsed.coordinator or parsed.n_procs or parsed.proc_id >= 0:
        named.append("multi-host (-coordinator/-nprocs/-procid)")
    if parsed.remotes or parsed.remote_jobs:
        named.append("-remote (incl. ssh-launched workers)")
    if parsed.qsub_jobs > 0:
        named.append("-qsubjobs")
    if parsed.ec2_instances > 0:
        named.append("-ec2instances")
    if state.get("profile_dir"):
        named.append("-profile")
    if named:
        raise RuntimeError(f"{', '.join(named)}: {NOT_PORTED}")


def _load_null(state, reads):
    from quaff_tpu.model.params import QuaffNullParams

    fn = state.get("null_file")
    if fn:
        with open(fn) as f:
            null = QuaffNullParams.from_json(f.read())
    else:
        null = QuaffNullParams.fit(reads)
    sf = state.get("savenull_file")
    if sf:
        with open(sf, "w") as f:
            null.write_json(f)
    return null


def _cmd_align(args: deque, state) -> int:
    from dataclasses import fields

    from quaff_tpu.formats.alignment import AlignmentPrinter

    from .aligner import DPConfig, QuaffAligner
    from .device import resolve_device

    printer = AlignmentPrinter()
    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    parsed = _parse_target()
    parsed.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    print_all = False
    while args:
        if args[0] == "-printall":
            print_all = True
            args.popleft()
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_printer(args, printer, state)
            or _parse_dp_config(args, parsed)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
            or reads_args.parse_noquals(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break
    _refuse_unported(parsed, state)
    config = DPConfig(**{f.name: getattr(parsed, f.name) for f in fields(DPConfig)})
    resolve_device(config.device)  # fail before any work

    reads, _ = reads_args.load(check_duplicates=True)
    refs, _ = refs_args.load(check_duplicates=True)
    params = _load_params(state)
    null = _load_null(state, reads)
    aligner = QuaffAligner(params, null, config, print_all=print_all)
    fn = state.get("align_file")
    out = open(fn, "w") if fn else sys.stdout
    try:
        aligner.align_all(out, refs, reads, printer)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
