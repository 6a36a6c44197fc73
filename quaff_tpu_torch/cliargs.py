"""The command-line argument helpers of quaff_tpu/cli.py, copied for the
port (that module's other parts reach JAX): -ref/-read lists, the DP
configuration flags, the alignment printer flags, verbosity, implicit
filename switches, model files, and the parameter loading.
"""

from __future__ import annotations

import sys
from collections import deque
from typing import List

DEFAULT_REFSEQ_KMER_THRESHOLD = 20  # align/train (t/quaff.cpp:15)


def _fail(msg: str) -> "NoReturn":
    sys.stderr.write(msg + "\n")
    sys.exit(1)


def _need_arg(args: deque, flag: str) -> str:
    if len(args) < 2:
        _fail(f"{flag} must have an argument")
    args.popleft()
    return args.popleft()


class SeqListArgs:
    """-ref/-read accumulation with -fwdstrand/-noquals (SeqList,
    t/quaff.cpp:21-49)."""

    def __init__(self, tag: str, want_quals: bool, want_revcomps: bool):
        self.tag = tag
        self.filenames: List[str] = []
        self.filepos: List[int] = []
        self.want_quals = want_quals
        self.want_revcomps = want_revcomps

    def parse(self, args: deque) -> bool:
        if not args:
            return False
        arg = args[0]
        if arg == self.tag:
            self.filenames.append(_need_arg(args, arg))
            self.filepos.append(-1)
            return True
        if arg == self.tag + "index":
            if len(args) < 3:
                _fail(f"{arg} needs two arguments")
            args.popleft()
            self.filenames.append(args.popleft())
            self.filepos.append(int(args.popleft()))
            return True
        if arg == "-fwdstrand":
            self.want_revcomps = False
            args.popleft()
            return True
        return False

    def parse_noquals(self, args: deque) -> bool:
        if args and args[0] == "-noquals":
            self.want_quals = False
            args.popleft()
            return True
        return False

    def load(self, require_quals_ok: bool = True, check_duplicates: bool = False):
        from .io.fastseq import (
            add_revcomps,
            duplicate_names,
            read_fast_seqs,
            read_indexed_fast_seq,
        )

        if not self.filenames:
            _fail(f"Please specify at least one sequence file using {self.tag}")
        seqs = []
        for fn, pos in zip(self.filenames, self.filepos):
            if pos < 0:
                recs = read_fast_seqs(fn)
            else:
                recs = [read_indexed_fast_seq(fn, pos)]
            for fs in recs:
                if self.want_quals:
                    if not fs.has_qual():
                        _fail(
                            f"Sequence {fs.name} in file {fn} does not have"
                            " quality scores"
                        )
                else:
                    fs.qual = ""
                if len(fs.seq):
                    seqs.append(fs)
        n_originals = len(seqs)
        if self.want_revcomps:
            seqs = add_revcomps(seqs)
        if not seqs:
            _fail(f"Please specify a valid sequence file using {self.tag}")
        if check_duplicates:
            dups = duplicate_names(seqs)
            if dups:
                _fail(
                    "Duplicate names: "
                    + " ".join(sorted(dups))
                    + "\nAll sequence names are required to be unique"
                )
        return seqs, n_originals


def _parse_dp_config(args: deque, config, general_only: bool = False) -> bool:
    """-kmatch*/-global/-threads parsing (QuaffDPConfig::parse*ConfigArgs,
    qmodel.cpp:746-1012)."""
    if not args:
        return False
    arg = args[0]
    if arg == "-global" and not general_only:
        config.local = False
        args.popleft()
        return True
    if arg == "-kmatchband":
        config.band_size = int(_need_arg(args, arg))
        return True
    if arg == "-kmatch":
        k = int(_need_arg(args, arg))
        if not (5 <= k <= 32):
            _fail(f"-kmatch out of range ({k}). Try 5 to 32")
        config.kmer_len = k
        return True
    if arg == "-kmatchn":
        config.kmer_threshold = int(_need_arg(args, arg))
        return True
    if arg == "-kmatchmb":
        config.max_size = int(_need_arg(args, arg)) << 20
        if config.max_size == 0:
            # -kmatchmb 0 falls back to physical memory
            # (qmodel.cpp:789-793)
            from .memsize import get_memory_size

            config.max_size = get_memory_size()
        config.kmer_threshold = -1
        config.auto_mem_size = False
        return True
    if arg == "-kmatchmax":
        # physical RAM (memsize.cpp equivalent, cross-platform)
        from .memsize import get_memory_size

        config.max_size = get_memory_size()
        config.kmer_threshold = -1
        config.auto_mem_size = True
        args.popleft()
        return True
    if arg == "-kmatchoff":
        config.sparse = False
        args.popleft()
        return True
    if arg == "-threads":
        config.threads = int(_need_arg(args, arg))
        return True
    if arg == "-remote":
        import re

        spec = _need_arg(args, arg)
        m = re.fullmatch(r"(?:([^@]+)@)?([-A-Za-z0-9.]+)(?::(\d+)(?:-(\d+))?)?", spec)
        if not m:
            _fail(f"Can't parse server address: {spec}")
        user = m.group(1) or ""
        addr = m.group(2)
        lo = int(m.group(3)) if m.group(3) else 8000
        hi = int(m.group(4)) if m.group(4) else lo
        if user:
            # credentials given: ssh-launch a worker server there
            # (addRemote, qmodel.cpp:943-955/1087-1091)
            config.remote_jobs.append((user, addr, lo, hi + 1 - lo))
        else:
            for port in range(lo, hi + 1):
                config.remotes.append((addr, port))
        return True
    if arg == "-sshpath":
        config.ssh_path = _need_arg(args, arg)
        return True
    if arg == "-rsyncpath":
        config.rsync_path = _need_arg(args, arg)
        return True
    if arg == "-awspath":
        config.aws_path = _need_arg(args, arg)
        return True
    if arg == "-sshkey":
        config.ssh_key = _need_arg(args, arg)
        return True
    if arg == "-rsync":
        config.use_rsync = True
        args.popleft()
        return True
    if arg == "-s3bucket":
        config.bucket = _need_arg(args, arg)
        return True
    if arg == "-ec2ami":
        config.ec2_ami = _need_arg(args, arg)
        return True
    if arg == "-ec2type":
        config.ec2_type = _need_arg(args, arg)
        return True
    if arg == "-ec2cores":
        config.ec2_cores = int(_need_arg(args, arg))
        return True
    if arg == "-ec2user":
        config.ec2_user = _need_arg(args, arg)
        return True
    if arg == "-ec2port":
        config.ec2_port = int(_need_arg(args, arg))
        return True
    if arg == "-ec2instances":
        config.ec2_instances = int(_need_arg(args, arg))
        return True
    if arg == "-ec2key":
        config.ec2_key = _need_arg(args, arg)
        return True
    if arg == "-ec2group":
        config.ec2_group = _need_arg(args, arg)
        return True
    if arg == "-maxthreads":
        import os

        config.threads = os.cpu_count() or 1
        args.popleft()
        return True
    if arg == "-qsubjobs":
        config.qsub_jobs = int(_need_arg(args, arg))
        return True
    if arg in ("-qsubpath", "-qsub"):
        config.qsub_path = _need_arg(args, arg)
        return True
    if arg == "-qsubopts":
        config.qsub_opts += _need_arg(args, arg)
        return True
    if arg == "-qsubdir":
        config.qsub_dir = _need_arg(args, arg)
        return True
    if arg == "-qsubheader":
        config.qsub_header = open(_need_arg(args, arg)).read()
        return True
    if arg == "-remotepath":
        config.worker_path = _need_arg(args, arg)
        return True
    if arg == "-mesh":
        config.use_mesh = True
        args.popleft()
        return True
    if arg == "-meshmp":
        config.mesh_mp = int(_need_arg(args, arg))
        config.use_mesh = True
        return True
    # multi-host runtime flags (consumed for config bookkeeping; the
    # actual jax.distributed.initialize happened in main() before the
    # backend came up — see _peek_distributed_args)
    if arg == "-coordinator":
        config.coordinator = _need_arg(args, arg)
        return True
    if arg == "-nprocs":
        config.n_procs = int(_need_arg(args, arg))
        return True
    if arg == "-procid":
        config.proc_id = int(_need_arg(args, arg))
        return True
    return False


def _parse_printer(args: deque, printer, state) -> bool:
    """-format/-threshold/-nothreshold/-savealign
    (parseAlignmentPrinterArgs, qmodel.cpp:2485-2529)."""
    from .formats.alignment import OutputFormat

    if not args:
        return False
    arg = args[0]
    if arg == "-format":
        fmt = _need_arg(args, arg)
        try:
            printer.format = OutputFormat(fmt)
        except ValueError:
            _fail(f"Unknown format: {fmt}")
        return True
    if arg == "-threshold":
        printer.log_odds_threshold = float(_need_arg(args, arg))
        return True
    if arg == "-nothreshold":
        printer.log_odds_threshold = float("-inf")
        args.popleft()
        return True
    if arg == "-savealign":
        state["align_file"] = _need_arg(args, arg)
        return True
    return False


def _parse_verbosity(args: deque, state) -> bool:
    from .logger import logger

    if args and args[0] == "-profile":
        # capture a JAX profiler trace for the whole run (TPU-native
        # observability; view with TensorBoard / xprof)
        state["profile_dir"] = _need_arg(args, "-profile")
        return True
    return logger.parse_args(args)


def _parse_unknown(args: deque, implicit: List[str], unlimited: bool) -> bool:
    """Bare filenames become implicit switches (optparser.cpp:32-54)."""
    if not args:
        return False
    arg = args[0]
    if arg == "-abort":
        # hidden stack-trace test flag (optparser.cpp:35-37)
        raise RuntimeError("abort triggered")
    if arg.startswith("-") or not implicit:
        _fail(f"Unknown option: {arg}")
    args.appendleft(implicit[0])
    if len(implicit) > 1 or not unlimited:
        implicit.pop(0)
    return True


def _load_params(args_state, prior=None):
    from .model.params import QuaffParams, default_params

    fn = args_state.get("params_file")
    if fn:
        return QuaffParams.from_json(open(fn).read())
    if prior is not None:
        return prior.fit()
    return default_params()


def _parse_model_files(args: deque, state) -> bool:
    if not args:
        return False
    arg = args[0]
    if arg == "-params":
        state["params_file"] = _need_arg(args, arg)
        return True
    if arg == "-null":
        state["null_file"] = _need_arg(args, arg)
        return True
    if arg == "-savenull":
        state["savenull_file"] = _need_arg(args, arg)
        return True
    return False
