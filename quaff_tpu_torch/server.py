"""JSON-over-TCP worker protocol for the port: `quaff server` and the remote
client.

Ported from quaff_tpu/server.py, with the wire format unchanged
(src/qmodel.cpp:2043-2166, 2648-2756; framing src/jsonutil.h:17,
jsonutil.cpp:116-131): requests and replies are framed by a literal
"# EOF" line; a listening server prints "# READY" on stdout (the ssh
bootstrap handshake, qmodel.h:54); {"quit":1} shuts a worker down.  Count
jobs carry the full params and null model and return counts JSON with
{"yName","xSort","loglike","counts"}; align and overlap jobs carry
sequence names and return formatted alignment text.  A worker of the port
and one of the JAX package serve the same clients.

The server's device is resolved when it starts, so a worker asked for a
card on a host without one fails before it prints "# READY".  An align
server scores each job's candidate pairs with K1 on that device and
refills the winner as the local `align` does; its aligner (and an overlap
server's) is built once, since their params are fixed at start-up.  A count server builds its counter per job, from the
params the job carries.
"""

from __future__ import annotations

import io
import json
import socket
import sys
import threading
from collections import deque
from typing import IO, List, Optional, Tuple

TERMINATOR = "# EOF"
READY = "# READY"


# ---------------------------------------------------------------------------
# framing


def send_framed(sock: socket.socket, payload: str) -> None:
    if payload and not payload.endswith("\n"):
        payload += "\n"
    sock.sendall((payload + TERMINATOR + "\n").encode())


def recv_framed(f) -> Optional[str]:
    """Read until the terminator; returns payload or None on EOF.

    Like the reference's readStringFromSocket (jsonutil.cpp:116-131), the
    terminator is matched anywhere in the stream, not just at line start.
    """
    lines: List[str] = []
    while True:
        line = f.readline()
        if not line:
            return None
        text = line.decode("latin-1", "replace")
        pos = text.find(TERMINATOR)
        if pos >= 0:
            lines.append(text[:pos])
            return "".join(lines)
        lines.append(text)


def json_escape(s: str) -> str:
    return json.dumps(s)


# ---------------------------------------------------------------------------
# job handlers (server side)


def _counts_reply(name: str, sort_order: List[int], loglike: float, counts) -> str:
    """writeJsonWithMeta (qmodel.cpp:472-478)."""
    from .model.params import fmt

    out = io.StringIO()
    out.write(f'{{"yName": {json_escape(name)},\n')
    out.write(f' "xSort": [ {", ".join(str(i) for i in sort_order)} ],\n')
    out.write(f' "loglike": {fmt(loglike)},\n')
    out.write(' "counts": ')
    counts.write_json(out)
    out.write(" }\n")
    return out.getvalue()


class QuaffServer:
    """One worker process serving count / align / overlap jobs on
    `config.device`."""

    def __init__(self, mode: str, config, refs, reads, n_originals: int,
                 printer=None, params=None, null_model=None, print_all=False,
                 use_null_model=True):
        from dataclasses import replace

        from .device import resolve_device

        self.device = resolve_device(config.device)
        self.mode = mode
        # every job runs on the device resolved now
        self.config = config = replace(config, device=str(self.device))
        self.refs = refs
        self.reads = reads
        self.n_originals = n_originals
        self.printer = printer
        self.params = params
        self.null_model = null_model
        self.print_all = print_all
        self.use_null_model = use_null_model
        self.read_index = {s.name: i for i, s in enumerate(reads)}
        self.n_ports = 1
        self._aligner = None
        if mode == "align":
            from .aligner import QuaffAligner

            self._aligner = QuaffAligner(params, null_model, config,
                                         print_all=print_all)
        elif mode == "overlap":
            from .overlap import QuaffOverlapAligner

            self._aligner = QuaffOverlapAligner(params, null_model, config)
            # both strands' tables now: ports serve jobs on threads of
            # their own, and the reverse strand's build is lazy
            self._aligner._tables(True)
        elif mode != "count":
            raise ValueError(mode)

    def handle_job(self, job: dict) -> Optional[str]:
        if "quit" in job:
            return None
        if self.mode == "count":
            return self._count_job(job)
        if self.mode == "align":
            return self._align_job(job)
        return self._overlap_job(job)

    def _count_job(self, job: dict) -> str:
        from .model.params import QuaffNullParams, QuaffParams
        from .trainer import QuaffCounter

        name = job["yName"]
        y = self.reads[self.read_index[name]]
        params = QuaffParams.from_json(job["params"])
        null = QuaffNullParams.from_json(job["null"])
        sort_order = [int(v) for v in job["xSort"]]
        counter = QuaffCounter(params, null, self.config, self.use_null_model)
        counts, loglike, new_order = counter.count_read(self.refs, y, sort_order)
        return _counts_reply(name, new_order, loglike, counts)

    def _align_job(self, job: dict) -> str:
        """align_read on the job's read, as quaff_tpu/server.py:123-134:
        K1 scores the read's pairs, the winner's whole envelope is refilled
        in float64 and walked back."""
        y = self.reads[self.read_index[job["yName"]]]
        out = io.StringIO()
        for a in self._aligner.align_read(self.refs, y):
            self.printer.write_alignment(out, a)
        return out.getvalue()

    def _overlap_job(self, job: dict) -> str:
        x = self.reads[self.read_index[job["xName"]]]
        y = self.reads[self.read_index[job["yName"]]]
        y_comp = bool(job.get("yComplemented", 0))
        a = self._aligner.overlap_pair(x, y, y_comp)
        out = io.StringIO()
        if a is not None:
            self.printer.write_alignment(out, a)
        return out.getvalue()

    # -- socket loop ------------------------------------------------------

    def serve(self, port: int, n_ports: int = 1, ready_out=None) -> None:
        """Listen on ports port..port+n_ports-1 (one thread each), print
        the READY sentinel (to ready_out when given: an in-process host
        keeps its own stdout; stdout is the ssh-bootstrap handshake), serve
        until {"quit":1}."""
        quit_event = threading.Event()
        threads = []
        for p in range(port, port + n_ports):
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("", p))
            srv.listen(8)
            srv.settimeout(0.5)
            t = threading.Thread(target=self._port_loop, args=(srv, quit_event))
            t.daemon = True
            threads.append(t)
        for t in threads:
            t.start()
        print(READY, flush=True, file=ready_out if ready_out is not None
              else sys.stdout)
        for t in threads:
            t.join()

    def _port_loop(self, srv: socket.socket, quit_event: threading.Event) -> None:
        with srv:
            while not quit_event.is_set():
                try:
                    sock, _ = srv.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                with sock:
                    f = sock.makefile("rb")
                    while True:
                        payload = recv_framed(f)
                        if payload is None:
                            break
                        try:
                            job = json.loads(payload)
                        except json.JSONDecodeError:
                            continue
                        result = self.handle_job(job)
                        if result is None:
                            quit_event.set()
                            return
                        send_framed(sock, result)

    def run_job_file(self, filename: str, out: IO[str]) -> None:
        """Single-shot -job mode (qmodel.cpp:2043-2050): run one task from
        a job file and print the result to stdout."""
        with open(filename) as f:
            job = json.loads(f.read())
        result = self.handle_job(job)
        if result is not None:
            out.write(result)


# ---------------------------------------------------------------------------
# remote client


class RemoteWorker:
    """Client connection to one remote worker (RemoteServer,
    qmodel.cpp:678-705)."""

    def __init__(self, addr: str, port: int, timeout: float = 3600.0):
        self.addr = addr
        self.port = port
        self.timeout = timeout
        self._sock: Optional[socket.socket] = None
        self._file = None

    def _connect(self):
        if self._sock is None:
            self._sock = socket.create_connection(
                (self.addr, self.port), timeout=self.timeout
            )
            self._file = self._sock.makefile("rb")
        return self._sock

    def request(self, payload: str) -> str:
        sock = self._connect()
        send_framed(sock, payload)
        reply = recv_framed(self._file)
        if reply is None:
            raise ConnectionError(f"Connection to {self.addr}:{self.port} lost")
        return reply

    def quit(self) -> None:
        try:
            sock = self._connect()
            send_framed(sock, '{"quit": 1}')
        except OSError:
            pass
        self.close()

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None
                self._file = None


# ---------------------------------------------------------------------------
# CLI entry


def server_from_args(args: deque, state) -> Tuple[QuaffServer, Optional[str], int]:
    """Parse `server <mode> [options]` (the words after `server`) and load
    what it serves: (server, the -job file or None, first port).  Raises
    before anything is served if the device cannot be had."""
    from .cli import _config, _load_null, _parse_target
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
    from .formats.alignment import AlignmentPrinter

    if not args:
        raise ValueError("server needs a command")
    mode = args.popleft()
    if mode not in ("align", "count", "overlap"):
        raise ValueError(f"Unrecognized server command: {mode}")

    printer = AlignmentPrinter()
    parsed = _parse_target()
    port = 8000
    job_file = None
    print_all = False
    use_null = True
    if mode in ("align", "count"):
        parsed.kmer_threshold = DEFAULT_REFSEQ_KMER_THRESHOLD
        refs_args = SeqListArgs("-ref", want_quals=False, want_revcomps=True)
        reads_args = SeqListArgs(
            "-read", want_quals=(mode == "align"), want_revcomps=False
        )
        implicit = ["-ref", "-read"]
    else:
        refs_args = None
        reads_args = SeqListArgs("-read", want_quals=True, want_revcomps=True)
        implicit = ["-read"]

    while args:
        arg = args[0]
        if arg == "-port":
            port = int(_need_arg(args, arg))
            continue
        if arg == "-job":
            job_file = _need_arg(args, arg)
            continue
        if arg == "-printall":
            print_all = True
            args.popleft()
            continue
        if arg == "-force":
            use_null = False
            args.popleft()
            continue
        if (
            _parse_verbosity(args, state)
            or _parse_printer(args, printer, state)
            or _parse_dp_config(args, parsed)
            or _parse_model_files(args, state)
            or (refs_args is not None and refs_args.parse(args))
            or reads_args.parse(args)
            or reads_args.parse_noquals(args)
        ):
            continue
        if not _parse_unknown(args, implicit, True):
            break
    config = _config(parsed, state)

    if parsed.bucket:
        # pull staged files down from S3 before loading
        # (SeqList::syncBucket / QuaffParamsIn::syncBucket,
        # t/quaff.cpp:342-346, 567-571)
        from .bootstrap import sync_from_bucket

        model_files = [
            f for f in (state.get("params_file"), state.get("null_file")) if f
        ]
        for fn in (
            (refs_args.filenames if refs_args else [])
            + reads_args.filenames
            + model_files
        ):
            sync_from_bucket(parsed.bucket, fn, parsed.aws_path)

    reads, n_originals = reads_args.load()
    refs = reads
    if refs_args is not None:
        refs, _ = refs_args.load()

    params = null = None
    if mode in ("align", "overlap"):
        params = _load_params(state)
        null = _load_null(state, reads)

    server = QuaffServer(
        mode,
        config,
        refs,
        reads,
        n_originals,
        printer=printer,
        params=params,
        null_model=null,
        print_all=print_all,
        use_null_model=use_null,
    )
    # -threads N: N listening ports (qmodel.cpp's one socket a thread)
    server.n_ports = max(1, config.threads)
    return server, job_file, port


def cmd_server(args: deque, state) -> int:
    server, job_file, port = server_from_args(args, state)
    if job_file:
        server.run_job_file(job_file, sys.stdout)
    else:
        server.serve(port, server.n_ports)
    return 0


# ---------------------------------------------------------------------------
# remote task orchestration (client side)
#
# Replaces remoteRunQuaff*Tasks (qmodel.cpp:2450-2478, 2884-2929;
# qoverlap.cpp:583-613): one worker thread per remote connection pulls
# tasks from a shared queue and prints replies under an output lock.


def _run_remote_workers(workers, task_iter, handle_reply):
    """Pull-scheduler over remote workers with failure requeue.

    Mirrors the reference's drain semantics (rescheduleCountingTask +
    the pending/noMoreTasks distinction, qmodel.cpp:2392-2478): a worker
    that errors requeues its in-flight task and exits; the surviving
    workers keep pulling until every task has a result ("queue empty" is
    not "all results in", so idle workers wait on the condition instead of
    exiting while tasks are still in flight).  Only when every worker has
    died with tasks unfinished does the pass fail."""
    queue_: List = list(task_iter)
    cv = threading.Condition()
    state = {"pending": len(queue_), "fatal": False}
    errors: List[BaseException] = []

    def loop(worker: RemoteWorker):
        while True:
            with cv:
                while not queue_:
                    if state["pending"] == 0 or state["fatal"]:
                        return
                    cv.wait(0.05)
                item = queue_.pop(0)
            try:
                reply = worker.request(item[0])
            except BaseException as e:  # requeue and quit this worker
                with cv:
                    queue_.append(item)
                    errors.append(e)
                    cv.notify_all()
                return
            with cv:
                try:
                    handle_reply(item, reply)
                except BaseException as e:
                    # a reply-handler failure is not retryable: abort the
                    # pass instead of leaving the other workers waiting
                    # on a pending count that can never drain
                    errors.append(e)
                    state["fatal"] = True
                    cv.notify_all()
                    return
                state["pending"] -= 1
                cv.notify_all()

    threads = [threading.Thread(target=loop, args=(w,)) for w in workers]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if state["pending"]:
        raise ConnectionError(
            f"remote workers failed with {len(errors)} errors: {errors[:1]}"
        )


def remote_align_all(out, workers, reads, refs, printer) -> None:
    """Delegate per-read alignment tasks to remote workers
    (QuaffAlignmentTask::toJson carries just the read name,
    qmodel.cpp:2809-2813).  One worker writes in read order, several in
    the order their replies arrive."""
    printer.write_header(out, refs, group_by_query=True)
    tasks = [(json.dumps({"yName": y.name}), y.name) for y in reads]
    if len(workers) == 1:
        for payload, _ in tasks:
            out.write(workers[0].request(payload))
    else:
        _run_remote_workers(workers, tasks, lambda item, reply: out.write(reply))


def remote_overlap_all(out, workers, seqs, n_originals, printer, enumerate_pairs) -> None:
    printer.write_header(out, seqs, group_by_query=False)
    tasks = []
    for nx, ny, y_comp in enumerate_pairs(seqs, n_originals):
        payload = json.dumps(
            {"xName": seqs[nx].name, "yName": seqs[ny].name,
             "yComplemented": 1 if y_comp else 0}
        )
        tasks.append((payload, (nx, ny)))
    if len(workers) == 1:
        for payload, _ in tasks:
            out.write(workers[0].request(payload))
    else:
        _run_remote_workers(workers, tasks, lambda item, reply: out.write(reply))


def count_task(y, sort_order, params_json: str, null_json: str) -> str:
    """One read's count job (QuaffCountingTask::toJson)."""
    return (
        f'{{"yName": {json_escape(y.name)},\n'
        f' "xSort": [ {", ".join(str(i) for i in sort_order)} ],\n'
        f' "null": {null_json},\n'
        f' "params": {params_json} }}'
    )


def model_json(params, null_model) -> Tuple[str, str]:
    """The params' and the null model's JSON, as count jobs carry them."""
    pj, nj = io.StringIO(), io.StringIO()
    params.write_json(pj)
    null_model.write_json(nj)
    return pj.getvalue(), nj.getvalue()


def merge_counts(replies, mk: int, ik: int):
    """Sum per-read count replies (parsed), in read order (finalCounts,
    qmodel.cpp:2416-2478): (counts, loglike, new sort orders)."""
    from .model.params import QuaffParamCounts

    total = QuaffParamCounts.zero(mk, ik)
    loglike = 0.0
    new_orders: List[List[int]] = []
    for data in replies:
        loglike += float(data["loglike"])
        new_orders.append([int(v) for v in data["xSort"]])
        total.add_weighted(QuaffParamCounts.from_json(data["counts"]), 1.0)
    return total, loglike, new_orders


def remote_get_counts(workers, refs, reads, params, null_model, sort_order=None):
    """Delegate counting tasks; merge per-read counts client-side
    (remoteRunQuaffCountingTasks + finalCounts, qmodel.cpp:2416-2478)."""
    if sort_order is None:
        sort_order = [list(range(len(refs))) for _ in reads]
    pj, nj = model_json(params, null_model)
    tasks = [(count_task(y, sort_order[ny], pj, nj), ny)
             for ny, y in enumerate(reads)]
    results = {}

    def handle(item, reply):
        results[item[1]] = json.loads(reply)

    if len(workers) == 1:
        for item in tasks:
            handle(item, workers[0].request(item[0]))
    else:
        _run_remote_workers(workers, tasks, handle)
    return merge_counts(
        (results[ny] for ny in range(len(reads))),
        params.match_kmer_len, params.indel_kmer_len)
