"""The port's ssh and EC2 worker bootstrap on the CPU (the mirror of
tests/test_ssh_launch.py, tests/test_ec2_launch.py, tests/test_bootstrap.py,
the EC2 case of tests/test_failure_injection.py and tests/test_cli_flags.py's
-sshkey/-remotepath case).

A stub ssh runs the worker command locally and a stub `aws` answers the
EC2 and S3 calls with loopback addresses and a local bucket directory, so
the whole chain (server-args serialisation, READY handshake, framed TCP
tasks, {"quit":1} shutdown, staging, terminate on exit) runs with no
network.  Workers are the port's own `server` processes, on the CPU.
"""

import contextlib
import io
import os
import pathlib
import signal
import socket
import subprocess
import sys
import textwrap
from collections import deque

import pytest
import torch

from quaff_tpu_torch.bootstrap import (
    ElasticPool,
    RemoteServerPool,
    RemoteServerSpec,
    SshLauncher,
)
from quaff_tpu_torch.cli import _default_worker_command, _parse_target, main

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _worker_env(monkeypatch, tmp_path):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    # workers inherit one intra-op thread (the suite runs many processes
    # at once)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    # staged files go under the test's own directory
    monkeypatch.setenv("QUAFF_STAGING_DIR", str(tmp_path / "staging"))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stub_ssh(tmp_path) -> str:
    stub = tmp_path / "fake-ssh"
    stub.write_text(
        "#!/bin/sh\n"
        "# stand-in for ssh: run the final argument (the remote command)\n"
        "# locally, ignoring the connection options before it\n"
        "for last; do :; done\n"
        'exec sh -c "$last"\n'
    )
    stub.chmod(0o755)
    return str(stub)


def _stub_aws(tmp_path) -> str:
    """Fake `aws` CLI: ec2 run-instances/wait/describe/terminate plus s3
    cp/sync against a local directory standing in for the bucket."""
    bucket = tmp_path / "s3-bucket"
    bucket.mkdir(exist_ok=True)
    stub = tmp_path / "fake-aws"
    stub.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import json, pathlib, shutil, sys

        args = sys.argv[1:]
        here = pathlib.Path({str(tmp_path)!r})
        bucket = here / "s3-bucket"
        (here / "aws-calls.log").open("a").write(" ".join(args) + "\\n")
        cmd = tuple(args[:2])
        if cmd == ("ec2", "run-instances"):
            n = int(args[args.index("--count") + 1])
            ids = [f"i-stub{{k}}" for k in range(n)]
            print(json.dumps({{"Instances": [{{"InstanceId": i}} for i in ids]}}))
        elif cmd == ("ec2", "wait"):
            pass
        elif cmd == ("ec2", "describe-instances"):
            ids = args[args.index("--instance-ids") + 1:]
            insts = [{{"InstanceId": i, "PublicIpAddress": "127.0.0.1"}} for i in ids]
            print(json.dumps({{"Reservations": [{{"Instances": insts}}]}}))
        elif cmd == ("ec2", "terminate-instances"):
            ids = args[args.index("--instance-ids") + 1:]
            with (here / "terminated.log").open("a") as fh:
                for i in ids:
                    fh.write(i + "\\n")
            print("{{}}")
        elif cmd == ("s3", "cp"):
            shutil.copy(args[2], bucket)
        elif cmd == ("s3", "sync"):
            name = args[args.index("--include") + 1]
            dest = pathlib.Path(args[3])
            dest.mkdir(parents=True, exist_ok=True)
            shutil.copy(bucket / name, dest)
        else:
            sys.exit(f"stub aws: unhandled {{args}}")
    """))
    stub.chmod(0o755)
    return str(stub)


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _dpm_base(src_dir):
    return ["align", str(src_dir / "dpm_ref.fasta"),
            str(src_dir / "dpm_read.fastq"), "-kmatchoff", "-fwdstrand",
            "-nothreshold"]


def _copy_dpm(data_dir, tmp_path):
    """The dpm pair in a directory the worker's rewritten args cannot reach
    unless staging really happened."""
    import shutil

    src_dir = tmp_path / "cl"
    src_dir.mkdir()
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        shutil.copy(data_dir / fn, src_dir / fn)
    return src_dir


def test_align_via_ssh_launched_worker(data_dir, tmp_path):
    base = ["align", str(data_dir / "c8f30.fastq.gz"),
            str(data_dir / "c8f30.fastq.gz"), "-kmatchmb", "10", "-fwdstrand"]
    rc, want = _run(base)
    assert rc == 0 and want == (data_dir / "c8f30-self-align.json").read_text()
    rc, got = _run(base + ["-remote", f"tester@127.0.0.1:{_free_port()}",
                           "-sshpath", _stub_ssh(tmp_path)])
    assert rc == 0
    assert got == want


def test_ssh_bootstrap_pool_align_golden(data_dir, tmp_path):
    """The pool directly: the launched worker's ports, then real tasks."""
    from quaff_tpu_torch.formats.alignment import AlignmentPrinter, OutputFormat
    from quaff_tpu_torch.io.fastseq import read_fast_seqs
    from quaff_tpu_torch.server import RemoteWorker, remote_align_all

    port = _free_port()
    reads_file = data_dir / "c8f30.fastq.gz"
    pool = RemoteServerPool(
        launcher=SshLauncher(ssh_path=_stub_ssh(tmp_path)),
        worker_command=_default_worker_command(), max_attempts=2,
        ready_timeout=180.0, min_retry_delay=0.5)
    remotes = pool.start(
        [RemoteServerSpec(addr="127.0.0.1", port=port)],
        f"align -kmatchband 64 -kmatch 6 -kmatchmb 10 -fwdstrand "
        f"-ref {reads_file} -read {reads_file}")
    try:
        assert remotes == [("127.0.0.1", port)]
        workers = [RemoteWorker(a, p) for a, p in remotes]
        reads = read_fast_seqs(str(reads_file))
        refs = read_fast_seqs(str(reads_file))
        for r in refs:
            r.qual = ""
        out = io.StringIO()
        remote_align_all(out, workers, reads, refs,
                         AlignmentPrinter(format=OutputFormat.STOCKHOLM))
        for w in workers:
            w.close()
        assert out.getvalue() == (data_dir / "c8f30-self-align.json").read_text()
    finally:
        pool.stop()
    assert pool.handles == []


def test_failed_launch_is_reported_not_run_locally(data_dir, tmp_path,
                                                   monkeypatch):
    """A worker that cannot have its card (QUAFF_TORCH_DEVICE=cuda on a
    host without one) never reports READY: the pool retries, then raises,
    and the client's CLI exits 1 with nothing on stdout."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    d = data_dir / "c8f30.fastq.gz"
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cuda")
    pool = RemoteServerPool(
        launcher=SshLauncher(ssh_path=_stub_ssh(tmp_path)),
        worker_command=_default_worker_command(), max_attempts=2,
        ready_timeout=120.0, min_retry_delay=0.01)
    with pytest.raises(RuntimeError, match="after 2 attempts"):
        pool._start_one(RemoteServerSpec(addr="127.0.0.1", port=_free_port()),
                        f"align -ref {d} -read {d}")
    # through the CLI (two attempts, not twenty): the client itself runs on
    # the CPU, its worker asks for the card
    import functools

    import quaff_tpu_torch.bootstrap as bs

    monkeypatch.setattr(bs, "RemoteServerPool", functools.partial(
        bs.RemoteServerPool, max_attempts=2, min_retry_delay=0.01))
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, out = _run(["align", str(d), str(d), "-kmatchmb", "10",
                        "-remote", f"tester@127.0.0.1:{_free_port()}",
                        "-sshpath", _stub_ssh(tmp_path), "-remotepath",
                        "QUAFF_TORCH_DEVICE=cuda " + _default_worker_command()])
    assert rc == 1 and out == ""
    assert "failed to start worker" in err.getvalue()


def test_remote_user_parsing_populates_jobs():
    from quaff_tpu_torch.cliargs import _parse_dp_config

    config = _parse_target()
    args = deque(["-remote", "alice@node1:8000-8003", "-remote", "node2:9000"])
    assert _parse_dp_config(args, config)
    assert _parse_dp_config(args, config)
    assert config.remote_jobs == [("alice", "node1", 8000, 4)]
    assert config.remotes == [("node2", 9000)]


def test_server_args_staging_rewrite(tmp_path):
    from quaff_tpu_torch.cli import _server_args

    staged = str(tmp_path / "staging")
    config = _parse_target()
    config.use_rsync = True
    sargs = _server_args(
        "align", config, {"params_file": "/data/p.json"},
        ref_files=["/data/refs.fasta"], read_files=["/data/reads.fastq"])
    assert f"-params {staged}/p.json" in sargs
    assert f"-ref {staged}/refs.fasta" in sargs
    assert f"-read {staged}/reads.fastq" in sargs

    config = _parse_target()
    config.bucket = "mybucket"
    sargs = _server_args("align", config, {}, ref_files=["/data/refs.fasta"])
    assert "-s3bucket mybucket" in sargs
    assert f"-ref {staged}/refs.fasta" in sargs


def test_server_args_carry_printall_and_force():
    from quaff_tpu_torch.cli import _server_args

    assert "-printall" in _server_args("align", _parse_target(), {},
                                       print_all=True)
    assert "-force" in _server_args("count", _parse_target(), {}, force=True)


def test_server_args_round_trip_through_the_server_parser(data_dir):
    """Every flag the client serialises is one the port's server parses."""
    from quaff_tpu_torch.cli import _server_args
    from quaff_tpu_torch.formats.alignment import AlignmentPrinter
    from quaff_tpu_torch.server import server_from_args

    d = str(data_dir / "c8f30.fastq.gz")
    config = _parse_target()
    config.kmer_threshold = -1
    config.max_size = 10 << 20
    sargs = _server_args("align", config, {}, printer=AlignmentPrinter(),
                         fwdstrand=True, noquals=True, ref_files=[d],
                         read_files=[d], print_all=True)
    server, _, _ = server_from_args(deque(sargs.split()), {})
    assert server.mode == "align" and server.print_all
    assert server.config.max_size == 10 << 20 and server.config.kmer_threshold == -1
    assert len(server.refs) == 1 and not server.reads[0].has_qual()


def test_align_with_rsync_staging(data_dir, tmp_path):
    """-rsync stages data files into the worker staging dir and rewrites the
    worker's file args to the staged paths (makeServerArgs + syncToRemote,
    qmodel.cpp:1019-1085)."""
    src_dir = _copy_dpm(data_dir, tmp_path)
    rsync = tmp_path / "fake-rsync"
    rsync.write_text(
        "#!/bin/sh\n"
        "# stand-in for rsync src host:dest: a local copy, host prefix cut\n"
        'src="$(eval echo \\${$(($#-1))})"\n'
        'dst="$(eval echo \\${$#})"\n'
        'exec cp "$src" "${dst#*:}"\n'
    )
    rsync.chmod(0o755)
    rc, want = _run(_dpm_base(src_dir))
    assert rc == 0 and want
    rc, got = _run(_dpm_base(src_dir) + [
        "-remote", f"tester@127.0.0.1:{_free_port()}",
        "-sshpath", _stub_ssh(tmp_path), "-rsyncpath", str(rsync), "-rsync"])
    assert rc == 0
    assert got == want
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        assert (tmp_path / "staging" / fn).exists()


def test_align_via_ec2_pool(data_dir, tmp_path):
    """Full -ec2instances chain: provision via the stub aws, align via the
    launched loopback worker, terminate the instance after the run."""
    rc, want = _run(_dpm_base(data_dir))
    assert rc == 0 and want
    rc, got = _run(_dpm_base(data_dir) + [
        "-ec2instances", "1", "-ec2port", str(_free_port()),
        "-ec2user", "tester", "-sshpath", _stub_ssh(tmp_path),
        "-awspath", _stub_aws(tmp_path)])
    assert rc == 0
    assert got == want
    calls = (tmp_path / "aws-calls.log").read_text()
    assert "ec2 run-instances" in calls
    assert "ec2 wait instance-status-ok" in calls
    assert (tmp_path / "terminated.log").read_text().splitlines() == ["i-stub0"]


def test_ec2_terminate_on_signal(tmp_path):
    """Fatal signals terminate provisioned instances (AWS::handleSignal
    chain, aws.cpp:179-208): a subprocess provisions via the stub aws,
    SIGTERMs itself, and both instances appear in the terminate log."""
    aws = _stub_aws(tmp_path)
    script = (
        "import os, signal\n"
        "from quaff_tpu_torch.bootstrap import ElasticPool\n"
        f"pool = ElasticPool(aws_path={aws!r})\n"
        "addrs = pool.launch(2, 'true\\n')\n"
        "assert addrs == ['127.0.0.1', '127.0.0.1'], addrs\n"
        "os.kill(os.getpid(), signal.SIGTERM)\n"
        "raise SystemExit('signal handler did not fire')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], env=env, cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 128 + signal.SIGTERM, proc.stderr
    terminated = set((tmp_path / "terminated.log").read_text().split())
    assert terminated == {"i-stub0", "i-stub1"}


def test_align_with_s3_staging(data_dir, tmp_path):
    """-s3bucket stages data through the (stub) bucket: the client uploads
    every file arg, the worker's args name staging paths, and the worker
    pulls its files down before loading (syncToBucket /
    SeqList::syncBucket, qmodel.cpp:1062-1070, t/quaff.cpp:342-346)."""
    src_dir = _copy_dpm(data_dir, tmp_path)
    rc, want = _run(_dpm_base(src_dir))
    assert rc == 0 and want
    rc, got = _run(_dpm_base(src_dir) + [
        "-remote", f"tester@127.0.0.1:{_free_port()}",
        "-sshpath", _stub_ssh(tmp_path), "-awspath", _stub_aws(tmp_path),
        "-s3bucket", "stub-bucket"])
    assert rc == 0
    assert got == want
    for fn in ("dpm_ref.fasta", "dpm_read.fastq"):
        assert (tmp_path / "s3-bucket" / fn).exists()
        assert (tmp_path / "staging" / fn).exists()


def test_ec2_instance_rebooted_on_launch_failure(tmp_path):
    """A cloud worker that fails its first READY handshake gets its instance
    rebooted before the retry (qmodel.cpp:1211-1218)."""
    calls = tmp_path / "aws-calls"
    stub_aws = tmp_path / "fake-aws"
    stub_aws.write_text(f"#!/bin/sh\necho \"$@\" >> {calls}\necho '{{}}'\n")
    stub_aws.chmod(0o755)
    # first launch prints nothing and exits; the second reports READY
    state = tmp_path / "ssh-state"
    stub_ssh = tmp_path / "fake-ssh"
    stub_ssh.write_text(textwrap.dedent(f"""\
        #!/bin/sh
        if [ -f {state} ]; then echo '# READY'; sleep 2; else touch {state}; fi
    """))
    stub_ssh.chmod(0o755)
    pool = RemoteServerPool(
        SshLauncher(str(stub_ssh)), worker_command="true", ready_timeout=5.0,
        min_retry_delay=0.01, elastic=ElasticPool(aws_path=str(stub_aws)))
    spec = RemoteServerSpec(addr="203.0.113.5", port=9999, user="ec2-user",
                            instance_id="i-deadbeef")
    assert pool._start_one(spec, "") is not None
    pool.stop()
    logged = calls.read_text()
    assert "reboot-instances" in logged and "i-deadbeef" in logged


def test_sshkey_and_remotepath_parse():
    """-sshkey feeds ssh -i; -remotepath overrides the worker command
    (makeSshCommand qmodel.cpp:1131-1144)."""
    from quaff_tpu_torch.cliargs import _parse_dp_config

    config = _parse_target()
    args = deque(["-sshkey", "/keys/id_quaff", "-remotepath",
                  "/usr/local/bin/quaff-worker"])
    while args:
        assert _parse_dp_config(args, config)
    assert config.ssh_key == "/keys/id_quaff"
    assert config.worker_path == "/usr/local/bin/quaff-worker"
    cmd = SshLauncher("ssh", config.ssh_key).command(
        RemoteServerSpec(addr="host", port=8000, user="me"), "echo hi")
    assert cmd[cmd.index("-i") + 1] == "/keys/id_quaff"
    assert cmd[-2:] == ["me@host", "echo hi"]
    assert str(RemoteServerSpec("h", 8000, threads=4, user="u")) == "u@h:8000-8003"


def test_default_worker_command_is_the_port():
    cmd = _default_worker_command()
    assert cmd.startswith(f"PYTHONPATH={REPO}")
    assert cmd.endswith(f"{sys.executable} -m quaff_tpu_torch.cli")
