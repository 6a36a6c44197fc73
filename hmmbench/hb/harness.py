"""One run of one cell: inputs from --seed, set-up, the measured window of
`train` fits, the check of one fit against the plain reference, and the
result line.

A cell's configuration, traffic mix and per-layer metrics are found by
name: configs/<config>.json (the file BENCHMARK.json names),
traffic/<traffic>.json and metrics/<metric>.py under the benchmark's
folder.  The window drives the port's `train` command in-process, through
quaff_tpu_torch.cli.main with a user's argv; the harness wraps a few of the
port's functions to record what each fit computed (every E-step's
log-likelihoods, counts and ref orders, every M-step's parameters) and,
with --trace 1, to time spans around the layers and to count cells.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib.util
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np

from . import faults, pairhmm, quaffmodel as qm, roofline, workload

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "quaff_tpu")
# quaff's MAX_TRAINING_LOG_DELTA: refs trailing a read's log-likelihood by
# more than this leave its order
PRUNE_DELTA = 20.0
LOWER = {"float64": "float32", "float32": "bfloat16"}
COUNTERS = ("launches", "warp_launches", "cluster_launches", "smem_launches",
            "global_launches", "two_level_launches")


class WindowClosed(Exception):
    """Raised inside a fit that is still running when the window closes."""


def log(msg: str) -> None:
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


# ---------------------------------------------------------------------------
# the cell's files


def load_cell(bench_json: pathlib.Path, name: str, bench_dir=BENCH):
    """(cell, config, traffic, per-layer metric entries of the cell)."""
    spec = json.loads(bench_json.read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in {bench_json}")
    centry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((bench_json.parent / centry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in spec["per_layer"]
                 if name in m.get("workloads", [name])]
    return cell, config, traffic, per_layer


def load_metric(bench_dir, name: str):
    """metrics/<name>.py's read(ctx)."""
    path = pathlib.Path(bench_dir) / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"hmmbench_metric_{name}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# recording the program


def params_dict(qp) -> dict:
    """A port QuaffParams as the reference's parameter dict."""
    keys = ("ref_base", "begin_insert", "begin_delete", "insert_prob",
            "insert_q", "insert_r", "match_prob", "match_q", "match_r")
    d = {k: np.array(getattr(qp, k), np.float64) for k in keys}
    d["extend_insert"] = float(qp.extend_insert)
    d["extend_delete"] = float(qp.extend_delete)
    return d


COUNT_FIELDS = ("insert", "match", "begin_insert_no", "begin_insert_yes",
                "begin_delete_no", "begin_delete_yes", "extend_insert_no",
                "extend_insert_yes", "extend_delete_no", "extend_delete_yes")


def counts_dict(pc) -> dict:
    return {k: np.array(getattr(pc, k), np.float64) for k in COUNT_FIELDS}


class Recorder:
    """Wraps the port's functions for the run's life (uninstall restores
    them): records each fit's E-steps and M-steps, counts pairs, chunks and
    oversize reads, raises WindowClosed once the window has closed, and
    with `trace` marks spans for the profiler and times them on the host's
    clock.  Spans never synchronise with the card: the traced run keeps
    the program's own overlap of host work and kernels."""

    def __init__(self, trace: bool):
        import torch

        self.torch = torch
        self.trace = trace
        self.deadline = math.inf
        self.in_window = False
        self.fit = None
        self.pairs = 0
        self.esteps = 0
        self.oversize = 0
        self.chunks = []
        self.last_layout = None
        self.span_s = collections.Counter()
        self._undo = []

    @contextlib.contextmanager
    def span(self, name):
        if not self.trace:
            yield
            return
        t = time.perf_counter()
        try:
            with self.torch.profiler.record_function("hmmbench." + name):
                yield
        finally:
            if self.in_window:
                self.span_s[name] += time.perf_counter() - t

    def check_deadline(self):
        if time.perf_counter() > self.deadline:
            raise WindowClosed()

    def _patch(self, owner, name, new):
        self._undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, new)

    def install(self, control=None, estep_fault=None, mstep_fault=None):
        """control replaces the E-step (QuaffCounter.count_reads); a fault
        (hb/faults.py) breaks the E-step or the M-step underneath."""
        from quaff_tpu_torch import trainer
        from quaff_tpu_torch.dp import engine, estep
        from quaff_tpu_torch.model import params

        rec = self
        count_reads = control or trainer.QuaffCounter.count_reads
        if estep_fault is not None:
            count_reads = estep_fault(count_reads)
        pc_fit = params.QuaffParamCounts.fit
        if mstep_fault is not None:
            pc_fit = mstep_fault(pc_fit)
        fit_ref = params.QuaffParams.fit_ref_seqs
        plan = trainer.estep_chunk_plan
        fused = estep.estep_fused_multi
        build_packed = engine.PairBatch.build_packed
        to_device = trainer.to_device

        def w_count_reads(counter, refs, reads, sort_order=None):
            rec.check_deadline()
            rec.esteps += rec.in_window
            orders_in = ([list(o) for o in sort_order] if sort_order
                         is not None else [list(range(len(refs)))] * len(reads))
            with rec.span("estep"):
                total, lls, orders = count_reads(counter, refs, reads,
                                                 sort_order)
            if rec.fit is not None:
                rec.fit["esteps"].append(dict(
                    params_in=params_dict(counter.params), orders_in=orders_in,
                    lls=np.array(lls, np.float64),
                    orders=[list(o) for o in orders],
                    counts=counts_dict(total)))
            return total, lls, orders

        def w_pc_fit(pc):
            with rec.span("mstep"):
                qp = pc_fit(pc)
            if rec.fit is not None:
                rec.fit["msteps"].append(qp)
            return qp

        def w_fit_ref(qp, refs):
            with rec.span("mstep"):
                return fit_ref(qp, refs)

        def w_plan(reads, pair_bytes, lane_cap=None, budget=None):
            with rec.span("plan"):
                chunks, oversize = plan(reads, pair_bytes, lane_cap, budget)
            rec.oversize += len(oversize)
            return chunks, oversize

        def w_fused(v2tab, batch, gid, null_lls, *a, **k):
            rec.check_deadline()
            if rec.in_window:
                rec.pairs += len(gid)
                rec.chunks.append(rec.last_layout)
            return fused(v2tab, batch, gid, null_lls, *a, **k)

        def w_build_packed(cls, pairs, *a, **k):
            with rec.span("layout"):
                out = build_packed(pairs, *a, **k)
            if rec.trace:
                rec.last_layout = dict(
                    pairs=len(pairs),
                    cells=sum(roofline.envelope_cells(len(x.seq), len(y.seq),
                                                      env.diagonals)
                              for x, y, env in pairs),
                    x_lens=[len(x.seq) for x, _, _ in pairs],
                    y_lens=[len(y.seq) for _, y, _ in pairs])
            return out

        def w_to_device(batch, device):
            with rec.span("upload"):
                return to_device(batch, device)

        self._patch(trainer.QuaffCounter, "count_reads", w_count_reads)
        self._patch(params.QuaffParamCounts, "fit", w_pc_fit)
        self._patch(params.QuaffParams, "fit_ref_seqs", w_fit_ref)
        self._patch(trainer, "estep_chunk_plan", w_plan)
        self._patch(estep, "estep_fused_multi", w_fused)
        self._patch(engine.PairBatch, "build_packed",
                    classmethod(w_build_packed))
        self._patch(trainer, "to_device", w_to_device)

    def uninstall(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo = []


def launch_counts() -> dict:
    from quaff_tpu_torch.dp import estep

    out = {}
    for fn in (estep.fwd_store, estep.bwd_counts):
        for c in COUNTERS:
            out[f"{fn.__name__}.{c}"] = getattr(fn, c)
    out["estep_reduce.launches"] = estep.estep_reduce.launches
    return out


# ---------------------------------------------------------------------------
# the control: the plain reference in the E-step's place, one precision down


def control_count_reads(dtype, device):
    from quaff_tpu_torch.model.params import QuaffParamCounts

    def count_reads(counter, refs, reads, sort_order=None):
        rt = [qm.tokens(r.seq) for r in refs]
        rd = [(qm.tokens(y.seq), qm.quals(y.qual)) for y in reads]
        null = qm.fit_null(rd)
        nlls = [qm.null_loglike(null, t, q) for t, q in rd]
        orders = sort_order or [list(range(len(refs)))] * len(reads)
        y_ll, pll, counts = pairhmm.estep(
            qm.score_tables(params_dict(counter.params)), rt, rd, orders,
            nlls, dtype=dtype, device=device)
        pc = qm.param_counts(counts)
        total = QuaffParamCounts.zero(counter.params.match_kmer_len,
                                      counter.params.indel_kmer_len)
        for k in COUNT_FIELDS:
            v = pc[k]
            setattr(total, k, float(np.sum(v)) if k.startswith("extend")
                    else np.array(v, np.float64))
        new = [pairhmm.prune({nx: pll[(ny, nx)] for nx in orders[ny]},
                             y_ll[ny], len(refs), PRUNE_DELTA)
               for ny in range(len(reads))]
        return total, list(y_ll), new

    return count_reads


# ---------------------------------------------------------------------------
# the check


def _rel_l1(a, b) -> float:
    """|a - b|_1 / |b|_1 (0 where both are all zero)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    num, den = float(np.sum(np.abs(a - b))), float(np.sum(np.abs(b)))
    if den > 0:
        return num / den
    return 0.0 if num == 0 else math.inf


# M-step outputs that follow from the counts in closed form
CLOSED_FORM = ("ref_base", "begin_insert", "begin_delete", "extend_insert",
               "extend_delete", "insert_prob", "match_prob")


def _rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
    g = np.where(np.isnan(a) & np.isnan(b), 0.0, g)
    return float(np.nan_to_num(np.max(g), nan=math.inf))


def param_gaps(p, r):
    """(mstep_gap, nb_shape_gap) of parameters p against r: the widest
    relative gap of the closed-form parameters and of each negative
    binomial's mean r(1-q)/q, which its fit pins to the histogram's mean;
    and of each negative binomial's shape r, which quaff's fit leaves
    within its bracket's tolerance (1e-3 relative)."""
    gap = max(_rel_gap(p[k], r[k]) for k in CLOSED_FORM)
    for e in ("insert", "match"):
        mean = lambda d: d[f"{e}_r"] * (1 - d[f"{e}_q"]) / d[f"{e}_q"]  # noqa: E731
        gap = max(gap, _rel_gap(mean(p), mean(r)))
    shape = max(_rel_gap(p[f"{e}_r"], r[f"{e}_r"]) for e in ("insert", "match"))
    return gap, shape


# E-steps the reference follows: the first two of a fit's (three, as quaff's
# stop rule ends these cells' fits), so that the check stays near the
# window's length; every M-step is checked
CHECKED_ESTEPS = 2


def check_fit(fit, refs_tok, reads, params0, limits, device):
    """The fit's first CHECKED_ESTEPS E-steps against the plain reference
    from the same parameters and ref orders, and every M-step, and the
    parameters train wrote, against the reference's M-step of the fit's own
    counts; returns {number: value}.  A fit that failed (the control's can)
    is read as far as it got."""
    import torch

    null = qm.fit_null(reads)
    nlls = [qm.null_loglike(null, t, q) for t, q in reads]
    prior = qm.prior_counts(null)
    out = dict(ll_gap_nats=0.0, counts_gap=0.0, order_diffs=0,
               mstep_gap=0.0, nb_shape_gap=0.0)
    last = None
    for k, es in enumerate(fit["esteps"]):
        if k < len(fit["msteps"]):
            last = qm.mstep(qm.add_counts(es["counts"], prior), refs_tok)
            _worst(out, param_gaps(params_dict(fit["msteps"][k]), last))
        if k >= CHECKED_ESTEPS:
            continue
        P = params0 if k == 0 else es["params_in"]
        y_ll, pll, cnt = pairhmm.estep(
            qm.score_tables(P), refs_tok, reads, es["orders_in"], nlls,
            dtype=torch.float64, device=device)
        out["ll_gap_nats"] = max(out["ll_gap_nats"],
                                 float(np.max(np.abs(es["lls"] - y_ll))))
        pc = qm.param_counts(cnt)
        out["counts_gap"] = max(out["counts_gap"], max(
            _rel_l1(es["counts"][f], pc[f]) for f in COUNT_FIELDS))
        for ny, order in enumerate(es["orders"]):
            ref_lls = {nx: pll[(ny, nx)] for nx in es["orders_in"][ny]}
            want = pairhmm.prune(ref_lls, y_ll[ny], len(refs_tok), PRUNE_DELTA)
            edge = y_ll[ny] - PRUNE_DELTA
            # a ref within the log-likelihood limit of the pruning edge may
            # fall on either side of it
            if any(abs(ref_lls.get(nx, -math.inf) - edge) > limits["ll_gap_nats"]
                   for nx in set(order) ^ set(want)):
                out["order_diffs"] += 1
    if fit["rc"] == 0:
        # what train writes: its last M-step, to six digits
        _worst(out, param_gaps(qm.params_from_json(json.loads(fit["written"])),
                               last))
    return out


def _worst(out, gaps):
    out["mstep_gap"] = max(out["mstep_gap"], gaps[0])
    out["nb_shape_gap"] = max(out["nb_shape_gap"], gaps[1])


# ---------------------------------------------------------------------------
# the run


def window(do_fit, t0: float, seconds: float):
    """The measured window: fits k = 0, 1, ... by do_fit(k) while the
    window is open, each stamped with its end.  A fit the window closes
    on raises WindowClosed (the recorder's deadline) and is dropped."""
    fits = []
    while time.perf_counter() < t0 + seconds:
        try:
            fit = do_fit(len(fits))
        except WindowClosed:
            break
        fit["end"] = time.perf_counter()
        fits.append(fit)
    return fits


def train_kb_per_s(fits, set_bases, t0: float) -> float:
    """Read kilobases scored by completed EM iterations over the time they
    took: for every fit that completed (exit 0) in the window, its read
    set's bases x the E-steps it ran, over the time from the window's
    start to the end of the last completed fit."""
    done = [f for f in fits if f["rc"] == 0]
    kb = sum(set_bases[f["set"]] * len(f["esteps"]) for f in done) / 1e3
    return kb / (done[-1]["end"] - t0)


def _argv(traffic, files, k):
    return [a.format(refs=files["refs"], reads=files["reads"][k],
                     params=files["params"]) for a in traffic["command"]]


def _power() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def parse(argv):
    ap = argparse.ArgumentParser(prog="hmmbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="put the plain reference, one precision below the "
                         "configuration's, in the E-step's place")
    ap.add_argument("--readings", type=int, default=0, metavar="N",
                    help="no window: one fit on each of N seeds from --seed "
                         "and the check's numbers of each, one JSON line a "
                         "seed (for setting the check's limits)")
    ap.add_argument("--fault", choices=sorted(faults.ESTEP) + ["unchanged_step"],
                    help="with --readings: plant a fault (hb/faults.py)")
    return ap.parse_args(argv)


# seeds of a --readings run: --seed, then steps of this odd number
READING_STEP = 1_000_003


def prepare(cfg, traffic, seed: int, work: pathlib.Path, bench_dir, sets):
    """The seed's references and `sets` read sets, written where the train
    command reads them: (refs, sets, files)."""
    refs = workload.references(cfg, seed)
    reads = workload.read_sets(cfg, dict(traffic, sets=sets), refs, seed)
    files = {"refs": str(work / "refs.fasta"),
             "params": str(bench_dir / "data" / cfg["params"]),
             "reads": [str(work / f"reads{k}.fastq")
                       for k in range(len(reads))]}
    workload.write_fasta(files["refs"], refs)
    for path, rs in zip(files["reads"], reads):
        workload.write_fastq(path, rs)
    return refs, reads, files


def check(fit, refs, reads, files, limits, device):
    """({number: {value, limit}}, [reasons it is not correct]) of one fit."""
    refs_tok = [t for _, t in refs]
    refs_tok = refs_tok + [qm.revcomp_tokens(t) for t in refs_tok]
    got = check_fit(fit, refs_tok, reads, qm.load_params(files["params"]),
                    limits, device)
    checks, reasons = {}, []
    for name, v in got.items():
        checks[name] = {"value": v, "limit": limits[name]}
        if not v <= limits[name]:
            reasons.append(f"{name} {v!r} over its limit {limits[name]!r}")
    return checks, reasons


def _fit(rec, cli, traffic, files, k):
    """One train command on read set k, recorded into rec.fit."""
    rec.fit = dict(set=k, esteps=[], msteps=[])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), rec.span("fit"):
        rc = cli.main(_argv(traffic, files, k))
    rec.fit.update(rc=rc, written=out.getvalue())
    return rec.fit


def run(argv, started: float, bench_json=None, bench_dir=BENCH,
        device="cuda"):
    """One run; returns the exit code.  `device` "cpu" skips the look for a
    card and runs the port on the CPU (the tests)."""
    args = parse(argv)
    bench_json = pathlib.Path(bench_json or ROOT / "BENCHMARK.json")
    cell, cfg, traffic, per_layer = load_cell(bench_json, args.workload,
                                              bench_dir)
    import torch

    cuda = device == "cuda"
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell["chips"]):
        log(f"hmmbench: the cell needs {cell['chips']} CUDA device(s); "
            f"torch sees {torch.cuda.device_count()}")
        return 3
    os.environ["QUAFF_TORCH_DEVICE"] = device
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    work = pathlib.Path(tempfile.mkdtemp(prefix="hmmbench-"))
    rec = None
    try:
        from quaff_tpu_torch import cli

        if cuda:
            from quaff_tpu_torch import kernels, native

            kernels.library()
            native.get_lib()
        control = None
        if args.control:
            control = control_count_reads(getattr(torch, LOWER[cfg["precision"]]),
                                          device)
        rec = Recorder(trace=bool(args.trace))
        if args.fault == "unchanged_step":
            from quaff_tpu_torch.model.params import QuaffParams

            start = QuaffParams.from_json(
                (bench_dir / "data" / cfg["params"]).read_text())
            rec.install(control, mstep_fault=faults.unchanged_step(start))
        else:
            rec.install(control, estep_fault=faults.ESTEP.get(args.fault))
        if args.readings:
            return readings(args, cfg, traffic, rec, cli, work, bench_dir,
                            device)
        refs, sets, files = prepare(cfg, traffic, args.seed, work, bench_dir,
                                    traffic["sets"] + 1)
        warm = len(sets) - 1
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(_argv(traffic, files, warm))
        if rc != 0:
            log(f"hmmbench: the warm-up fit exited {rc}")
            return 1
        if cuda:
            torch.cuda.synchronize()
        rec.oversize = 0
        before = launch_counts()

        prof = contextlib.nullcontext()
        if args.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            prof = profile(activities=acts)

        with prof as p:  # started before the window opens
            t_wall0 = time.time()
            t0 = time.perf_counter()
            rec.deadline = t0 + args.seconds
            rec.in_window = True
            with torch.profiler.record_function("hmmbench.window"):
                fits = window(lambda k: _fit(rec, cli, traffic, files,
                                             k % (len(sets) - 1)),
                              t0, args.seconds)
                if cuda:
                    torch.cuda.synchronize()
        rec.in_window = False
        rec.fit = None
        t_close = time.perf_counter()
        launches = {k: v - before[k] for k, v in launch_counts().items()}
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        rec.uninstall()

        done = [f for f in fits if f["rc"] == 0]
        failed = len(fits) - len(done)
        metrics, device_info, breakdown = {}, {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(peak)}, None
        if not args.trace and done:
            bases = [sum(len(t) for t, _ in reads) for reads in sets]
            metrics["train_kb_per_s"] = {
                "value": train_kb_per_s(fits, bases, t0), "unit": "kb/s"}
            metrics["setup_s"] = {"value": t_wall0 - started, "unit": "s"}
        if args.trace:
            from . import trace as tr

            win = tr.Window(tr.events(p)) if cuda else None
            ctx = SimpleNamespace(
                window=win, chunks=[c for c in rec.chunks if c],
                pairs=rec.pairs, esteps=rec.esteps, launches=launches,
                spans=dict(rec.span_s), precision=cfg["precision"],
                roofline=roofline)
            for m in per_layer:
                v = load_metric(bench_dir, m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if win is not None:
                device_info.update(busy_s=win.busy_s, window_s=win.window_s)
                breakdown = {"device_ops": win.top_ops(),
                             "idle_gaps": win.idle_by_host()}
            del p
        log(f"hmmbench: {cell['name']} seed {args.seed}: {len(fits)} fits "
            f"({failed} failed), E-steps {[len(f['esteps']) for f in fits]}, "
            f"fit ends {[round(f['end'] - t0, 3) for f in fits]}, "
            f"window {t_close - t0:.3f} s, setup {t_wall0 - started:.3f} s")
        log(f"hmmbench: card {_power() if cuda else 'none'}")
        log("hmmbench: launches in the window " + json.dumps(launches))
        log(f"hmmbench: oversize reads in the window {rec.oversize}, pairs "
            f"{rec.pairs}, spans {json.dumps(dict(rec.span_s))}")

        # the check, once the program's state is freed
        del cli
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks, reasons = {}, []
        if not done:
            reasons.append("no fit completed in the window")
        else:
            rng = np.random.default_rng([args.seed % (1 << 63), 7])
            fit = done[int(rng.integers(len(done)))]
            checks, reasons = check(fit, refs, sets[fit["set"]], files,
                                    cfg["limits"], device)
        if rec.oversize:
            reasons.append(f"{rec.oversize} reads went to the exact engine")
        if failed:
            reasons.append(f"{failed} fits exited non-zero")
        checks["oversize_reads"] = {"value": rec.oversize, "limit": 0}
        log(f"hmmbench: check took {time.perf_counter() - t_check:.3f} s")

        loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
        if loaded:
            log(f"hmmbench: the run loaded {', '.join(loaded)}; no result")
            return 4
        result = {"correct": not reasons, "attempted": len(fits),
                  "failed": failed, "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        for r in reasons:
            log(f"hmmbench: not correct: {r}")
        for name, c in checks.items():
            log(f"hmmbench: check {name} = {c['value']!r} (limit "
                f"{c['limit']!r})")
        sys.stdout.write(json.dumps(result) + "\n")
        sys.stdout.flush()
        return 0
    except Exception:  # the run's boundary: report and fail
        traceback.print_exc()
        return 1
    finally:
        if rec is not None:
            rec.uninstall()
        shutil.rmtree(work, ignore_errors=True)


def readings(args, cfg, traffic, rec, cli, work, bench_dir, device) -> int:
    """One fit on each of args.readings seeds, each checked: a JSON line a
    seed with the check's numbers (no limit applies; the limits are set
    from these)."""
    import torch

    limits = dict(cfg["limits"])
    for i in range(args.readings):
        seed = args.seed + i * READING_STEP
        refs, sets, files = prepare(cfg, traffic, seed, work, bench_dir, 1)
        rec.oversize = 0
        t = time.perf_counter()
        fit = _fit(rec, cli, traffic, files, 0)
        rec.fit = None
        t_fit = time.perf_counter() - t
        if device == "cuda":
            torch.cuda.empty_cache()
        t = time.perf_counter()
        checks, _ = check(fit, refs, sets[0], files, limits, device)
        line = {"seed": seed, "control": args.control, "fault": args.fault,
                "rc": fit["rc"], "esteps": len(fit["esteps"]),
                "oversize": rec.oversize, "fit_s": t_fit,
                "check_s": time.perf_counter() - t,
                "readings": {k: c["value"] for k, c in checks.items()}}
        sys.stdout.write(json.dumps(line) + "\n")
        sys.stdout.flush()
    return 0
