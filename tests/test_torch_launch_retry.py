"""parallel/launch.py survives a rendezvous port that was taken.

The launcher picks its port bind-then-close, so another process can
take it before rank 0's TCPStore binds it. A real two-rank gloo group
whose first port is held by this test still exits 0, on a second port;
the retry reads torch's own message for a taken port. A failure of any
other kind, or a bind failure after rank 0 has printed, is not retried;
free_ports(k) gives k distinct ports, and the dry run's retry reads the
launcher's signatures.
"""

import socket
import sys

import pytest

from distributedmnist_tpu_torch import dryrun
from distributedmnist_tpu_torch.parallel import launch

RANK = '''
import datetime, os, sys
import torch
import torch.distributed as dist
mode = sys.argv[1]
rank = int(os.environ["RANK"])
if mode == "print-first" and rank == 0:
    print("rank 0 up", flush=True)
if mode == "fail" and rank == 0:
    raise ValueError("a rank that fails for another reason")
dist.init_process_group("gloo", init_method="env://",
                        timeout=datetime.timedelta(seconds=60))
t = torch.ones(1)
dist.all_reduce(t)
if rank == 0:
    print(f"sum {t.item():g} port {os.environ['MASTER_PORT']}", flush=True)
dist.destroy_process_group()
'''


@pytest.fixture
def held():
    """A port this test holds with a listening socket."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        s.listen()
        yield s.getsockname()[1]


@pytest.fixture
def ports(monkeypatch, held):
    """launch's free_port stubbed: the held port first, then free ones.
    Returns the list of ports it handed out."""
    real = launch.free_port
    given: list = []

    def stub():
        given.append(held if not given else real())
        return given[-1]

    monkeypatch.setattr(launch, "free_port", stub)
    return given


def _launch(tmp_path, mode):
    script = tmp_path / "rank.py"
    script.write_text(RANK)
    return launch.launch([sys.executable, str(script), mode], 2,
                         cwd=str(tmp_path))


def test_a_taken_port_is_retried_on_a_fresh_one(tmp_path, capsys, held,
                                                ports):
    rc = _launch(tmp_path, "ok")
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    assert len(ports) == 2 and ports[0] == held and ports[1] != held
    assert out.splitlines() == [f"sum 2 port {ports[1]}"]
    # torch's own words for the taken port are among the signatures
    assert launch.bind_failure(err) and "EADDRINUSE" in err
    assert "retrying once on a fresh port" in err


def test_another_failure_is_not_retried(tmp_path, capsys, ports):
    rc = _launch(tmp_path, "fail")
    err = capsys.readouterr().err
    assert rc == 1 and len(ports) == 1
    assert "a rank that fails for another reason" in err
    assert "retrying" not in err


def test_a_bind_failure_after_a_printed_line_is_not_retried(
        tmp_path, capsys, held, ports):
    rc = _launch(tmp_path, "print-first")
    out, err = capsys.readouterr()
    assert rc == 1 and ports == [held]
    assert out.splitlines() == ["rank 0 up"]     # printed once, not twice
    assert launch.bind_failure(err) and "retrying" not in err


@pytest.mark.parametrize("k", [1, 8])
def test_free_ports_are_distinct(k):
    got = launch.free_ports(k)
    assert len(got) == len(set(got)) == k
    assert all(0 < p < 65536 for p in got)


def test_free_port_is_one_of_free_ports(monkeypatch):
    monkeypatch.setattr(launch, "free_ports", lambda k: [4242] * k)
    assert launch.free_port() == 4242


@pytest.mark.parametrize("message, retried", [
    ("The server socket has failed to listen on any local network "
     "address. port: 29500, useIpv6: false, code: -98, name: EADDRINUSE, "
     "message: address already in use", True),
    ("[Errno 98] Address already in use", True),
    ("RuntimeError: connection refused", False)])
def test_dryrun_retry_reads_the_launchers_signatures(monkeypatch, message,
                                                     retried):
    assert dryrun.bind_failure is launch.bind_failure
    calls = []

    def group(*args):
        calls.append(args)
        if len(calls) == 1:
            raise RuntimeError(f"mh_smoke rank failed (rc 1):\n{message}")
        return ["second"]

    monkeypatch.setattr(dryrun, "_run_group", group)
    if retried:
        assert dryrun._run_group_retry(2, "cpu", 6, "ck", "wd") == ["second"]
        assert len(calls) == 2
    else:
        with pytest.raises(RuntimeError, match="connection refused"):
            dryrun._run_group_retry(2, "cpu", 6, "ck", "wd")
        assert len(calls) == 1
