"""quaff-compatible command line for the PyTorch port:

    python -m quaff_tpu_torch.cli align refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli train refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli count refs.fasta reads.fastq [options]
    python -m quaff_tpu_torch.cli overlap reads.fastq [options]
    python -m quaff_tpu_torch.cli server {align,count,overlap} [options]

Ported from quaff_tpu/cli.py.  The flag surface and its parsing are the
port's copies of that module's helpers (cliargs.py).  The device comes from
$QUAFF_TORCH_DEVICE ("cuda" by default, "cpu" for the plain PyTorch
versions of the kernels); worker processes the client starts (ssh, EC2,
qsub) inherit it.  The socket, ssh, EC2 and qsub backends are server.py,
bootstrap.py and batch.py; `-profile <dir>` writes a torch.profiler Chrome
trace of the whole command into <dir>.

-mesh and the multi-host flags (-coordinator/-nprocs/-procid) exit 1 with
"not yet ported".
"""

from __future__ import annotations

import contextlib
import os
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

USAGE = f"""Usage: {PROG} {{help,train,count,align,overlap,server}} [options]

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
                   (server: listening ports, from -port on)
   -v, -vv, -log <tag>, -nocolor   Logging
   -profile <dir>  Write a torch.profiler Chrome trace of the run into dir

 {PROG} server {{align,count,overlap}} -ref refs.fasta -read reads.fastq
  (a worker for -remote clients: JSON jobs over TCP, framed by "# EOF";
   prints "# READY" once it listens; align jobs are scored by K1 on
   $QUAFF_TORCH_DEVICE)

   -port <n>       First port to listen on (default 8000)
   -job <file>     Run the one job in file, print its reply, and exit

Remote and batch backends (align, count, train, overlap):
   -remote [user@]host[:port[-maxport]]
                   With user@: ssh-launch a worker server there.
                   Bare host:port: connect to an already-running server.
   -sshkey <file>, -sshpath <p>, -rsyncpath <p>, -awspath <p>
   -remotepath <p> Worker command (default: this checkout's CLI)
   -rsync          Client rsyncs data files to the worker staging dir
   -s3bucket <B>   Client and workers sync data files via S3 bucket B
   -ec2instances <N>               Launch N temporary EC2 instances
   -ec2ami <AMI>, -ec2type <type>, -ec2cores <n>, -ec2user <user>,
   -ec2key <keypair>, -ec2group <group>, -ec2port <port>
   -qsubjobs <N>   Submit jobs to a queueing system (needs a shared
                   filesystem); -qsub <path>, -qsubopts <options>,
                   -qsubdir <path>, -qsubheader <file>

-mesh and the multi-host flags (-coordinator/-nprocs/-procid) are
{NOT_PORTED}.
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = deque(argv)
    if not args:
        sys.stderr.write(f"Usage: {PROG} {{help,train,count,align,overlap,"
                         "server}} [options]\n")
        return 1
    command = args.popleft()
    if command in ("help", "-help", "--help", "-h"):
        sys.stdout.write(USAGE)
        return 0
    if command in ("version", "-version", "--version", "-V"):
        sys.stdout.write(f"{PROG} {VERSION}\n")
        return 0
    commands = {"align": _cmd_align, "train": _cmd_train, "count": _cmd_count,
                "overlap": _cmd_overlap}
    if command == "server":
        from .server import cmd_server

        commands["server"] = cmd_server
    if command not in commands:
        sys.stderr.write(f"Unrecognized command: {command}\n")
        return 1
    # -profile anywhere in the args (the option parsers consume it later)
    rest = list(args)
    profile_dir = None
    if "-profile" in rest and rest.index("-profile") + 1 < len(rest):
        profile_dir = rest[rest.index("-profile") + 1]
    try:
        if profile_dir:
            with _profiled(profile_dir, command):
                return commands[command](args, {})
        return commands[command](args, {})
    except (ValueError, OSError, RuntimeError) as e:
        # the reference exits with failure status on any error
        # (t/quaff.cpp:321-323)
        sys.stderr.write(f"{e}\n")
        return 1


@contextlib.contextmanager
def _profiled(profile_dir: str, command: str):
    """torch.profiler over the whole command (the JAX package's
    jax.profiler.trace, quaff_tpu/cli.py:751-764): CPU activity always,
    CUDA activity when the command runs on a card; the Chrome trace is
    written to <profile_dir>/quaff-<command>-<pid>.trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .device import DEFAULT_DEVICE, ENV_VAR

    activities = [ProfilerActivity.CPU]
    dev = torch.device(os.environ.get(ENV_VAR) or DEFAULT_DEVICE)
    if dev.type == "cuda" and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"quaff-{command}-{os.getpid()}.trace.json"))


# the JAX package's DPConfig fields for the remote, ssh, EC2, qsub, mesh and
# multi-host backends (quaff_tpu/aligner.py:68-110), with their defaults
BACKEND_DEFAULTS = dict(
    remotes=[], remote_jobs=[], ssh_path="ssh", rsync_path="rsync",
    aws_path="aws", ssh_key="", use_rsync=False, bucket="", ec2_ami="",
    ec2_type="", ec2_cores=1, ec2_user="ec2-user", ec2_port=8000,
    ec2_instances=0, ec2_key="", ec2_group="", file_args=[], qsub_jobs=0,
    qsub_path="qsub", qsub_opts="", qsub_header="#!/bin/sh\n", qsub_dir="",
    worker_path="", use_mesh=False, mesh_mp=1, coordinator="", n_procs=0,
    proc_id=-1,
)


def _parse_target():
    """What _parse_dp_config writes into: the port's DPConfig fields, plus
    the backend fields it fills from -remote, -ssh*, -rsync*, -s3bucket,
    -ec2*, -qsub*, -mesh and the multi-host flags."""
    import copy
    from dataclasses import asdict

    from .aligner import DPConfig

    return SimpleNamespace(**asdict(DPConfig()),
                           **copy.deepcopy(BACKEND_DEFAULTS))


def _config(parsed, state):
    """The DPConfig of the parsed flags, after refusing the backends this
    port does not have yet (rather than ignoring them) and resolving the
    device (so a run that cannot have its device fails before any work)."""
    from dataclasses import fields

    from .aligner import DPConfig
    from .device import resolve_device

    named = []
    if parsed.use_mesh:
        named.append("-mesh")
    if parsed.coordinator or parsed.n_procs or parsed.proc_id >= 0:
        named.append("multi-host (-coordinator/-nprocs/-procid)")
    if named:
        raise RuntimeError(f"{', '.join(named)}: {NOT_PORTED}")
    config = DPConfig(**{f.name: getattr(parsed, f.name) for f in fields(DPConfig)})
    resolve_device(config.device)
    return config


def _server_args(
    mode: str,
    parsed,
    state,
    printer=None,
    force: bool = False,
    fwdstrand: bool = False,
    noquals: bool = False,
    ref_files: Optional[List[str]] = None,
    read_files: Optional[List[str]] = None,
    print_all: bool = False,
) -> str:
    """Serialise the client's config into worker CLI flags: the
    flags-as-wire-format scheme of setServerArgs (qmodel.cpp:993-1006).

    When rsync/S3 staging is active, file paths are rewritten to the
    worker-side staging directory (makeServerArgs, qmodel.cpp:1019-1028).
    """
    from .bootstrap import staging_dir
    from .logger import logger

    staging = parsed.use_rsync or bool(parsed.bucket)

    def fpath(fn: str) -> str:
        return f"{staging_dir()}/{os.path.basename(fn)}" if staging else fn

    parts = [mode]
    if force:
        parts.append("-force")
    if print_all:
        parts.append("-printall")
    if printer is not None:
        parts.append(f"-format {printer.format.value}")
        if printer.log_odds_threshold > float("-inf"):
            parts.append(f"-threshold {printer.log_odds_threshold:g}")
        else:
            parts.append("-nothreshold")
    if fwdstrand:
        parts.append("-fwdstrand")
    if noquals:
        parts.append("-noquals")
    if parsed.sparse:
        parts.append(f"-kmatchband {parsed.band_size} -kmatch {parsed.kmer_len}")
        if parsed.kmer_threshold >= 0:
            parts.append(f"-kmatchn {parsed.kmer_threshold}")
        else:
            parts.append(f"-kmatchmb {parsed.max_size >> 20}")
    else:
        parts.append("-kmatchoff")
    if parsed.bucket:
        parts.append(f"-s3bucket {parsed.bucket}")
        if parsed.aws_path != "aws":
            parts.append(f"-awspath {parsed.aws_path}")
    if state.get("params_file"):
        parts.append(f"-params {fpath(state['params_file'])}")
    if state.get("null_file"):
        parts.append(f"-null {fpath(state['null_file'])}")
    for f in ref_files or []:
        parts.append(f"-ref {fpath(f)}")
    for f in read_files or []:
        parts.append(f"-read {fpath(f)}")
    return " ".join(parts) + logger.args()


def _collect_file_args(parsed, state, refs_args=None, reads_args=None) -> None:
    """Record every file the workers must open, for rsync/S3 staging
    (addFileArg/addReadFileArg, qmodel.cpp:1008-1016)."""
    parsed.file_args = []
    for key, tag in (("params_file", "-params"), ("null_file", "-null")):
        if state.get(key):
            parsed.file_args.append((tag, state[key]))
    for sl, tag in ((refs_args, "-ref"), (reads_args, "-read")):
        if sl is not None:
            for fn in sl.filenames:
                parsed.file_args.append((tag, fn))


def _launch_remote_pool(parsed, sargs: str):
    """ssh/EC2 worker bootstrap before remote dispatch
    (startRemoteServers, qmodel.cpp:1093-1125).

    Returns (pool_handles, extra_remotes): pool_handles is None or a
    (RemoteServerPool, ElasticPool|None) tuple to stop after the run;
    extra_remotes is a list of (addr, port) worker endpoints.  A worker
    that never reports READY raises here: nothing runs locally instead.
    """
    if not (parsed.remote_jobs or parsed.ec2_instances > 0):
        return None, []
    from . import bootstrap as bs

    specs = [
        bs.RemoteServerSpec(addr=a, port=p, threads=t, user=u)
        for (u, a, p, t) in parsed.remote_jobs
    ]
    elastic = None
    if parsed.ec2_instances > 0:
        elastic = bs.ElasticPool(
            ami=parsed.ec2_ami or bs.AWS_DEFAULT_AMI,
            instance_type=parsed.ec2_type or bs.AWS_DEFAULT_INSTANCE_TYPE,
            user=parsed.ec2_user,
            key_pair=parsed.ec2_key,
            security_group=parsed.ec2_group,
            aws_path=parsed.aws_path,
        )
        addrs = elastic.launch(
            parsed.ec2_instances,
            f"mkdir -p -m a=rwx {bs.staging_dir()}\n",
        )
        specs += [
            bs.RemoteServerSpec(
                addr=a,
                port=parsed.ec2_port,
                threads=parsed.ec2_cores,
                user=parsed.ec2_user,
                instance_id=iid,
            )
            for a, iid in zip(addrs, elastic.instance_ids)
        ]
    # file staging: S3 bucket overrides rsync (qmodel.cpp:1113)
    if parsed.bucket:
        for _tag, fn in parsed.file_args:
            bs.sync_to_bucket(parsed.bucket, fn, parsed.aws_path)
    elif parsed.use_rsync:
        for spec in specs:
            for _tag, fn in parsed.file_args:
                bs.sync_to_remote(fn, spec, parsed.rsync_path, parsed.ssh_path)
    pool = bs.RemoteServerPool(
        bs.SshLauncher(parsed.ssh_path, parsed.ssh_key),
        worker_command=parsed.worker_path or _default_worker_command(),
        elastic=elastic,
    )
    try:
        extra = pool.start(specs, sargs)
    except BaseException:
        _stop_remote_pool((pool, elastic))
        raise
    return (pool, elastic), extra


def _stop_remote_pool(pool_handles) -> None:
    if pool_handles is None:
        return
    pool, elastic = pool_handles
    pool.stop()
    if elastic is not None:
        elastic.terminate_all()


def _default_worker_command() -> str:
    """This checkout's CLI: PYTHONPATH=<repo> <python> -m quaff_tpu_torch.cli
    (the caller's PYTHONPATH kept after the repo)."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    extra = os.environ.get("PYTHONPATH")
    path = f"{root}:{extra}" if extra else str(root)
    return f"PYTHONPATH={path} {sys.executable} -m quaff_tpu_torch.cli"


def _make_qsub_runner(parsed, server_args: str):
    from .batch import QsubConfig, QsubRunner

    return QsubRunner(
        QsubConfig(
            jobs=parsed.qsub_jobs,
            qsub_path=parsed.qsub_path,
            qsub_opts=parsed.qsub_opts,
            header=parsed.qsub_header,
            temp_dir=parsed.qsub_dir,
            worker_command=parsed.worker_path or _default_worker_command(),
            server_args=server_args,
        )
    )


def _remote_workers(parsed, extra_remotes):
    """RemoteWorker connections to every -remote endpoint and launched
    worker port (empty when the run has none)."""
    from .server import RemoteWorker

    return [RemoteWorker(a, p) for a, p in parsed.remotes + extra_remotes]


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

    def server_args(read_files):
        return _server_args(
            "align", parsed, state, printer=printer,
            fwdstrand=not refs_args.want_revcomps,
            noquals=not reads_args.want_quals,
            ref_files=refs_args.filenames, read_files=read_files,
            print_all=print_all)

    _collect_file_args(parsed, state, refs_args, reads_args)
    pool, extra_remotes = _launch_remote_pool(
        parsed, server_args(reads_args.filenames))
    fn = state.get("align_file")
    out = open(fn, "w") if fn else sys.stdout
    try:
        if parsed.remotes or extra_remotes:
            from .server import remote_align_all

            workers = _remote_workers(parsed, extra_remotes)
            try:
                remote_align_all(out, workers, reads, refs, printer)
            finally:
                for w in workers:
                    w.close()
        elif parsed.qsub_jobs > 0:
            from .batch import qsub_align_all

            # each job loads its one read by -readindex
            qsub_align_all(out, _make_qsub_runner(parsed, server_args(None)),
                           reads, refs, printer)
        else:
            aligner = QuaffAligner(params, null, config, print_all=print_all)
            aligner.align_all(out, refs, reads, printer)
    finally:
        _stop_remote_pool(pool)
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

    def server_args(read_files):
        return _server_args(
            "overlap", parsed, state, printer=printer,
            fwdstrand=not reads_args.want_revcomps,
            noquals=not reads_args.want_quals, read_files=read_files)

    _collect_file_args(parsed, state, reads_args=reads_args)
    pool, extra_remotes = _launch_remote_pool(
        parsed, server_args(reads_args.filenames))
    if parsed.remotes or extra_remotes or parsed.qsub_jobs > 0:
        fn = state.get("align_file")
        out = open(fn, "w") if fn else sys.stdout
        # the pair order without building the pair tables
        pairs = QuaffOverlapAligner.__new__(QuaffOverlapAligner).enumerate_pairs
        try:
            if parsed.remotes or extra_remotes:
                from .server import remote_overlap_all

                workers = _remote_workers(parsed, extra_remotes)
                try:
                    remote_overlap_all(out, workers, seqs, n_originals,
                                       printer, pairs)
                finally:
                    for w in workers:
                        w.close()
            else:
                from .batch import qsub_overlap_all

                # each job loads its two reads by -readindex
                qsub_overlap_all(
                    out, _make_qsub_runner(parsed, server_args(None)), seqs,
                    n_originals, printer, pairs)
        finally:
            _stop_remote_pool(pool)
            if out is not sys.stdout:
                out.close()
        return 0

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

    def server_args(read_files):
        return _server_args(
            "count", parsed, state, force=not allow_null,
            fwdstrand=not refs_args.want_revcomps,
            ref_files=refs_args.filenames, read_files=read_files)

    _collect_file_args(parsed, state, refs_args, reads_args)
    pool, extra_remotes = _launch_remote_pool(
        parsed, server_args(reads_args.filenames))
    if parsed.remotes or extra_remotes:
        # each worker counts in float64 by the exact engine on its device
        # (its reads carry no qualities); replies carry 6 significant
        # figures
        from .server import remote_get_counts

        workers = _remote_workers(parsed, extra_remotes)
        try:
            counts, _, _ = remote_get_counts(workers, refs, reads, params, null)
        finally:
            for w in workers:
                w.close()
            _stop_remote_pool(pool)
    elif parsed.qsub_jobs > 0:
        from .batch import qsub_get_counts

        counts, _, _ = qsub_get_counts(
            _make_qsub_runner(parsed, server_args(None)), refs, reads, params,
            null)
    elif fast_counts:
        # `count -fast`: the E-step that `train` runs, at its precision
        # (the fused float32 kernels on a card, the float32 engine on the
        # CPU); within 5e-3 + 5e-3*|count| of the parity artifact
        counter = QuaffCounter(params, null, config, use_null_model=allow_null,
                               dtype=torch.float32)
        counts, _, _ = counter.get_counts(refs, reads)
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

    # remote/qsub E-step dispatch (QuaffTrainer::getCounts wraps each EM
    # iteration's counting in startRemoteServers/stopRemoteServers,
    # qmodel.cpp:2034-2041): the workers are count servers
    def server_args(read_files):
        return _server_args(
            "count", parsed, state, force=not trainer.allow_null_model,
            fwdstrand=not refs_args.want_revcomps,
            ref_files=refs_args.filenames, read_files=read_files)

    _collect_file_args(parsed, state, refs_args, reads_args)
    pool, extra_remotes = _launch_remote_pool(
        parsed, server_args(reads_args.filenames))
    counts_provider = None
    workers = _remote_workers(parsed, extra_remotes)
    used = trainer.effective_reads(reads)
    if workers:
        from .server import remote_get_counts

        def counts_provider(qp, order):
            return remote_get_counts(workers, refs, used, qp, null, order)

    elif parsed.qsub_jobs > 0:
        from .batch import qsub_get_counts

        runner = _make_qsub_runner(parsed, server_args(None))

        def counts_provider(qp, order):
            return qsub_get_counts(runner, refs, used, qp, null, order)

    try:
        new_params = trainer.fit(refs, reads, params, null, prior, config,
                                 log=lambda msg: logger.log(1, msg),
                                 counts_provider=counts_provider)
    finally:
        for w in workers:
            w.close()
        _stop_remote_pool(pool)
    if not trainer.save_params_filename:
        new_params.write_json(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
