"""quaff-compatible command line for the PyTorch port:

    python -m quaff_tpu_torch.cli align refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli train refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli count refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli overlap reads.fastq [options]

Ported from quaff_tpu/cli.py.  The flag surface and its parsing are the
port's copies of that module's helpers (cliargs.py).  The device comes from
$QUAFF_TORCH_DEVICE ("cuda" by default, "cpu" for the plain PyTorch
versions of the kernels).

server, and the -mesh, multi-host, -remote (ssh), -qsubjobs, EC2 and
-profile options, exit 1 with "not yet ported".
"""

from __future__ import annotations

import sys
from collections import deque
from types import SimpleNamespace
from typing import List, Optional

from .cliargs import (
    DEFAULT_REFSEQ_KMER_THRESHOLD,
    SeqListArgs,
    _load_params,
    _need_arg,
    _parse_dp_config,
    _parse_model_files,
    _parse_printer,
    _parse_unknown,
    _parse_verbosity,
)

PROG = "quaff-tpu-torch"
VERSION = "0.1"
NOT_PORTED = "not yet ported in quaff_tpu_torch"

USAGE = f"""Usage: {PROG} {{help,train,count,align,overlap}} [options]

 {PROG} train refs.fasta reads.fastq  >params.json
  (to fit a model to unaligned sequences, using EM/Forward-Backward; the
   E-step runs on $QUAFF_TORCH_DEVICE, default cuda)

   -maxiter <n>    Max number of EM iterations (default is 100)
   -mininc <n>     EM convergence threshold as relative log-likelihood increase
   -maxreadmb <n>  Use only the first n megabases of the read training set
   -force          Force each read to match a refseq, i.e. disallow null model
   -suborder <k>   Allow substitutions to depend on k-mer contexts
   -gaporder <k>   Allow gap open probabilities to depend on k-mer contexts
   -order <k>      Shorthand for '-suborder <k> -gaporder <k>'
   -prior <file>, -saveprior <file>   Load/save prior pseudocounts
   -saveparams <file>, -savecounts <file>, -savecountswithprior <file>
   -checkpoint <dir>                  Save/resume the EM state

 {PROG} count refs.fasta reads.fastq  >counts.json
  (expected counts of one E-step: float64 on the host, the parity
   artifact; -fast: the training E-step's own float32 route on
   $QUAFF_TORCH_DEVICE)

   -fast, -force, -savecounts <file>

 {PROG} align refs.fasta reads.fastq
  (to align FASTQ reads to FASTA reference sequences, using Viterbi;
   pairs are scored on $QUAFF_TORCH_DEVICE, default cuda)

   -printall       Print all pairwise alignments, not just best for each read
   -threshold <n>, -nothreshold    Log-odds score threshold
   -noquals        Ignore read quality scores during alignment
   -savealign <file>               Stream alignments to file
   -format {{fasta,stockholm,sam,refseq}}

 {PROG} overlap reads.fastq
  (to detect overlaps between reads, using Viterbi; every ordered pair,
   reverse complements included, is scored on $QUAFF_TORCH_DEVICE, and
   the reported ones are filled and traced back in float64 on the host)

   -threshold <n>, -nothreshold    Log-odds score threshold
   -noquals        Ignore read quality scores
   -savealign <file>, -format {{fasta,stockholm,sam,refseq}}

General options:
   -params <file>  Load model parameters from file
   -ref <file>, -read <file>       Load additional sequences
   -fwdstrand      Do not include reverse-complemented sequences
   -global         Force all of refseq to be aligned (align/train only)
   -null <file>, -savenull <file>  Load/save null model
   -kmatch <k>, -kmatchn <n>, -kmatchband <n>, -kmatchmb <M>,
   -kmatchmax, -kmatchoff          k-mer envelope options
   -threads <n>    Host threads for envelopes and winner tracebacks
   -v, -vv, -log <tag>, -nocolor   Logging

server is {NOT_PORTED}.
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = deque(argv)
    if not args:
        sys.stderr.write(f"Usage: {PROG} {{help,train,count,align,overlap}} "
                         "[options]\n")
        return 1
    command = args.popleft()
    if command in ("help", "-help", "--help", "-h"):
        sys.stdout.write(USAGE)
        return 0
    if command in ("version", "-version", "--version", "-V"):
        sys.stdout.write(f"{PROG} {VERSION}\n")
        return 0
    if command == "server":
        sys.stderr.write(f"{command}: {NOT_PORTED}\n")
        return 1
    commands = {"align": _cmd_align, "train": _cmd_train, "count": _cmd_count,
                "overlap": _cmd_overlap}
    if command not in commands:
        sys.stderr.write(f"Unrecognized command: {command}\n")
        return 1
    try:
        return commands[command](args, {})
    except (ValueError, OSError, RuntimeError) as e:
        # the reference exits with failure status on any error
        # (t/quaff.cpp:321-323)
        sys.stderr.write(f"{e}\n")
        return 1


def _parse_target():
    """What _parse_dp_config writes into: the port's DPConfig fields, plus
    the backend fields it fills from -remote, -qsub*, -ec2*, -mesh and the
    multi-host flags (any other attribute it sets is only bookkeeping for
    those backends)."""
    from dataclasses import asdict

    from .aligner import DPConfig

    return SimpleNamespace(
        **asdict(DPConfig()), remotes=[], remote_jobs=[], qsub_jobs=0,
        qsub_opts="", ec2_instances=0, use_mesh=False, coordinator="",
        n_procs=0, proc_id=-1,
    )


def _config(parsed, state):
    """The DPConfig of the parsed flags, after refusing the backends and
    options this port does not have yet (rather than ignoring them)."""
    from dataclasses import fields

    from .aligner import DPConfig
    from .device import resolve_device

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
    config = DPConfig(**{f.name: getattr(parsed, f.name) for f in fields(DPConfig)})
    resolve_device(config.device)  # fail before any work
    return config


def _load_null(state, reads):
    from .model.params import QuaffNullParams

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
    from .aligner import QuaffAligner
    from .formats.alignment import AlignmentPrinter

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
    config = _config(parsed, state)

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


def _cmd_overlap(args: deque, state) -> int:
    import torch

    from .formats.alignment import AlignmentPrinter
    from .overlap import QuaffOverlapAligner

    printer = AlignmentPrinter()
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=True)
    parsed = _parse_target()
    implicit = ["-read"]
    while args:
        if (
            _parse_verbosity(args, state)
            or _parse_printer(args, printer, state)
            or _parse_dp_config(args, parsed, general_only=True)
            or _parse_model_files(args, state)
            or reads_args.parse(args)
            or reads_args.parse_noquals(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break
    config = _config(parsed, state)

    seqs, n_originals = reads_args.load(check_duplicates=True)
    params = _load_params(state)
    null = _load_null(state, seqs)
    aligner = QuaffOverlapAligner(params, null, config)
    n_threads = torch.get_num_threads()
    if aligner.device.type == "cpu":
        # K4's plain version steps small [B, W] tensors row by row: more
        # intra-op threads only add synchronisation, and beside the exact
        # pass's pool they made each row ~100x slower
        torch.set_num_threads(1)
    fn = state.get("align_file")
    out = open(fn, "w") if fn else sys.stdout
    try:
        aligner.align_all(out, seqs, n_originals, printer)
    finally:
        torch.set_num_threads(n_threads)
        if out is not sys.stdout:
            out.close()
    return 0


def _cmd_count(args: deque, state) -> int:
    import torch

    from .trainer import QuaffCounter

    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    parsed = _parse_target()
    parsed.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    allow_null = True
    save_counts = None
    fast_counts = False
    while args:
        if args[0] == "-force":
            allow_null = False
            args.popleft()
            continue
        if args[0] == "-fast":
            fast_counts = True
            args.popleft()
            continue
        if args[0] == "-savecounts":
            save_counts = _need_arg(args, args[0])
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_dp_config(args, parsed)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break
    config = _config(parsed, state)

    reads, _ = reads_args.load()
    refs, _ = refs_args.load()
    params = _load_params(state)
    null = _load_null(state, reads)
    if fast_counts:
        # `count -fast`: the E-step that `train` runs, at its precision
        # (the fused float32 kernels on a card, the float32 engine on the
        # CPU); within 5e-3 + 5e-3*|count| of the parity artifact
        counter = QuaffCounter(params, null, config, use_null_model=allow_null,
                               dtype=torch.float32)
    else:
        # plain `count` is the float64 parity artifact, computed by the
        # exact engine on the host CPU whatever the device, as the JAX
        # package computes it (quaff_tpu/cli.py:991-1011); off the card
        # the counter never takes the fused kernels
        config.device = "cpu"
        counter = QuaffCounter(params, null, config, use_null_model=allow_null,
                               dtype=torch.float64)
    counts, _, _ = counter.get_counts(refs, reads)
    if save_counts:
        with open(save_counts, "w") as f:
            counts.write_json(f)
            f.write("\n")
    else:
        counts.write_json(sys.stdout)
    return 0


def _cmd_train(args: deque, state) -> int:
    from .logger import logger
    from .model.params import QuaffParamCounts, QuaffParams
    from .trainer import QuaffTrainer

    refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
    reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=False)
    parsed = _parse_target()
    parsed.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
    implicit = ["-ref", "-read"]
    trainer = QuaffTrainer()
    match_order, gap_order = 1, 0
    order_specified = False
    prior_file = None
    save_prior = None
    while args:
        arg = args[0]
        if arg == "-maxiter":
            trainer.max_iterations = int(_need_arg(args, arg))
            continue
        if arg == "-mininc":
            trainer.min_fractional_loglike_increment = float(_need_arg(args, arg))
            continue
        if arg == "-maxreadmb":
            trainer.max_read_bases = int(0.5 + 1e6 * float(_need_arg(args, arg)))
            continue
        if arg == "-force":
            trainer.allow_null_model = False
            args.popleft()
            continue
        if arg == "-saveparams":
            trainer.save_params_filename = _need_arg(args, arg)
            continue
        if arg == "-savecounts":
            trainer.raw_counts_filename = _need_arg(args, arg)
            continue
        if arg == "-savecountswithprior":
            trainer.counts_with_prior_filename = _need_arg(args, arg)
            continue
        if arg == "-checkpoint":
            trainer.checkpoint_dir = _need_arg(args, arg)
            continue
        if arg == "-order":
            k = int(_need_arg(args, arg))
            match_order, gap_order = 1 + k, k
            order_specified = True
            continue
        if arg == "-suborder":
            match_order = 1 + int(_need_arg(args, arg))
            order_specified = True
            continue
        if arg == "-gaporder":
            gap_order = int(_need_arg(args, arg))
            order_specified = True
            continue
        if arg == "-prior":
            prior_file = _need_arg(args, arg)
            continue
        if arg == "-saveprior":
            save_prior = _need_arg(args, arg)
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_dp_config(args, parsed)
            or _parse_model_files(args, state)
            or refs_args.parse(args)
            or reads_args.parse(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break
    config = _config(parsed, state)

    reads, _ = reads_args.load()
    refs, _ = refs_args.load()
    null = _load_null(state, reads)
    params_file = state.get("params_file")
    if prior_file:
        with open(prior_file) as f:
            prior = QuaffParamCounts.from_json(f.read())
    else:
        # prior from the null model (requirePriorOrUseNullModel,
        # t/quaff.cpp:490-515: initCounts(9, 9, 5, 1, &null))
        if params_file and not order_specified:
            with open(params_file) as f:
                seed_probe = QuaffParams.from_json(f.read())
            match_order = seed_probe.match_kmer_len
            gap_order = seed_probe.indel_kmer_len
        prior = QuaffParamCounts.zero(match_order, gap_order)
        prior.init_counts(9, 9, 5, 1, null)
    if save_prior:
        with open(save_prior, "w") as f:
            prior.write_json(f)
            f.write("\n")
    params = _load_params(state, prior=prior)
    new_params = trainer.fit(refs, reads, params, null, prior, config,
                             log=lambda msg: logger.log(1, msg))
    if not trainer.save_params_filename:
        new_params.write_json(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
