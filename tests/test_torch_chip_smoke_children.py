"""How chip_smoke.py starts its children, on the CPU.

Every child environment the script builds comes from `_child_env`
(the repository on PYTHONPATH, OMP_NUM_THREADS=1, the bytecode cache),
the script fails naming the reason when that cache cannot be made, and
its fork server gives a child what `subprocess` gives the same command
on a tiny module: exit code, stdout and stderr, signals, its own
environment and working directory, a kill past a timeout; it refuses to
fork once CUDA is initialized in it, and a dead server fails the
request.
"""

import ast
import os
import signal
import subprocess
import sys
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = '''
import os, sys, time
if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "echo":
        print("out", sys.argv[2:], os.getcwd(), os.environ.get("TINY"),
              __name__, os.path.basename(sys.argv[0]), sys.path[0])
        print("err", file=sys.stderr)
        sys.exit(int(sys.argv[2]))
    if mode == "raise":
        raise ValueError("boom")
    if mode == "sleep":
        with open(sys.argv[2], "w") as f:
            f.write(str(os.getpid()))
        print("up", flush=True)
        time.sleep(120)
'''
STARTS = 120


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The children's environment, its bytecode cache in a temporary
    directory shared by this module's servers."""
    return dict(chip_smoke._child_env(), PYTHONPYCACHEPREFIX=str(
        tmp_path_factory.mktemp("pycache")))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    (d / "tiny_child.py").write_text(TINY)
    return str(d)


@pytest.fixture(scope="module")
def children(env):
    kids = chip_smoke.Children(chip_smoke.ForkServer(env, REPO))
    yield kids
    kids.close()
    assert kids.server.proc.returncode == 0


def _tiny(*args):
    return [sys.executable, "-m", "tiny_child", *args]


def test_child_env_carries_the_cache_and_one_thread():
    env = chip_smoke._child_env()
    assert env["PYTHONPYCACHEPREFIX"] == chip_smoke.PYCACHE
    assert env["OMP_NUM_THREADS"] == "1"
    assert "PYTHONDONTWRITEBYTECODE" not in env
    assert env["PYTHONPATH"].split(os.pathsep)[0] == REPO
    assert chip_smoke.PYCACHE.startswith(
        os.path.join(REPO, "distributedmnist_tpu_torch", "csrc", "build"))


def _functions(tree):
    """Each node of the script beside the function it is in (None at the
    top level)."""
    def walk(node, where):
        for child in ast.iter_child_nodes(node):
            inner = child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else where
            yield child, inner
            yield from walk(child, inner)
    return walk(tree, None)


def test_every_child_env_comes_from_the_helper():
    """No `dict(os.environ ...)` outside _child_env; every env= the
    script passes is _child_env() or a name bound only to it (or a
    parameter); no subprocess call outside the Children and ForkServer
    machinery."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        source = f.read()
    tree = ast.parse(source)

    def is_helper_call(v):
        return (isinstance(v, ast.Call) and isinstance(v.func, ast.Name)
                and v.func.id == "_child_env")

    bad = []
    for node, fn in _functions(tree):
        if not isinstance(node, ast.Call):
            continue
        where = fn.name if fn else "<module>"
        f = node.func
        if (isinstance(f, ast.Name) and f.id == "dict" and node.args
                and ast.unparse(node.args[0]) == "os.environ"
                and where != "_child_env"):
            bad.append(f"line {node.lineno}: dict(os.environ) in {where}")
        if (isinstance(f, ast.Attribute)
                and ast.unparse(f) in ("subprocess.Popen", "subprocess.run",
                                       "subprocess.call",
                                       "subprocess.check_output")
                and where not in ("popen", "__init__")):
            bad.append(f"line {node.lineno}: {ast.unparse(f)} in {where}")
        for kw in node.keywords:
            if kw.arg != "env" or is_helper_call(kw.value):
                continue
            if not isinstance(kw.value, ast.Name) or fn is None:
                bad.append(f"line {node.lineno}: env={ast.unparse(kw.value)}")
                continue
            name = kw.value.id
            params = {a.arg for a in fn.args.args + fn.args.kwonlyargs}
            binds = [a.value for a in ast.walk(fn)
                     if isinstance(a, ast.Assign)
                     and any(isinstance(t, ast.Name) and t.id == name
                             for t in a.targets)]
            if name not in params and (not binds or not all(
                    is_helper_call(v) for v in binds)):
                bad.append(f"line {node.lineno}: env={name} in {where} "
                           f"is not _child_env()")
    assert not bad, bad
    assert source.count("dict(os.environ") == 1


def test_script_fails_naming_the_reason_without_its_cache(tmp_path,
                                                          monkeypatch):
    """A cache directory that cannot be made stops main() before any
    child starts, the reason in the error; the environment untouched."""
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    monkeypatch.setattr(chip_smoke, "PYCACHE", str(blocker / "pycache"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    before = dict(os.environ)
    with pytest.raises(RuntimeError, match="bytecode cache .* cannot be "
                       "made or written"):
        chip_smoke.main()
    assert chip_smoke.CHILDREN is None
    assert dict(os.environ) == before


@pytest.mark.parametrize("args", [("echo", "0"), ("echo", "3"), ("raise",)],
                         ids=["rc0", "rc3", "uncaught"])
def test_fork_matches_subprocess(children, env, tiny, args):
    run = dict(env=dict(env, TINY="t"), cwd=tiny, capture_output=True,
               text=True, timeout=STARTS)
    forked = children.run(_tiny(*args), **run)
    plain = subprocess.run(_tiny(*args), **run)
    assert forked.returncode == plain.returncode
    assert forked.stdout == plain.stdout
    if args[0] == "raise":
        assert forked.returncode == 1
        for err in (forked.stderr, plain.stderr):
            assert err.startswith("Traceback (most recent call last):")
            assert err.rstrip().endswith("ValueError: boom")
    else:
        assert forked.stderr == plain.stderr == "err\n"
        assert forked.stdout.startswith(f"out ['{args[1]}'] {tiny} t "
                                        f"__main__ tiny_child.py {tiny}")


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL],
                         ids=["sigterm", "kill"])
def test_signals_reach_the_child(children, env, tiny, tmp_path, sig):
    proc = children.popen(_tiny("sleep", str(tmp_path / "pid")), env=env,
                          cwd=tiny, stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline() == "up\n"
    assert int((tmp_path / "pid").read_text()) == proc.pid
    assert proc.poll() is None
    if sig == signal.SIGKILL:
        proc.kill()
    else:
        proc.send_signal(sig)
    assert proc.wait(STARTS) == -sig
    proc.stdout.close()


def test_each_child_its_own_env_and_cwd(children, env, tiny, tmp_path):
    (tmp_path / "tiny_child.py").write_text(TINY)
    procs = [children.popen(_tiny("echo", "0"), env=dict(env, TINY=tag),
                            cwd=cwd, stdout=subprocess.PIPE, text=True)
             for tag, cwd in (("first", tiny), ("second", str(tmp_path)))]
    outs = [p.communicate(timeout=STARTS)[0] for p in procs]
    assert outs[0].startswith(f"out ['0'] {tiny} first")
    assert outs[1].startswith(f"out ['0'] {tmp_path} second")
    draw = [sys.executable, "-c",
            "import numpy; print(numpy.random.randint(1 << 30))"]
    draws = {children.run(draw, env=env, cwd=tiny, capture_output=True,
                          text=True, timeout=STARTS).stdout
             for _ in range(2)}
    assert len(draws) == 2, "forked children share numpy's random state"


def test_a_child_past_its_timeout_is_killed(children, env, tiny, tmp_path):
    pid_file = tmp_path / "pid"
    with pytest.raises(subprocess.TimeoutExpired):
        children.run(_tiny("sleep", str(pid_file)), env=env, cwd=tiny,
                     capture_output=True, text=True, timeout=5)
    with pytest.raises(ProcessLookupError):
        os.kill(int(pid_file.read_text()), 0)


def test_routes(children, env):
    assert children.route([sys.executable, "-m", "x"], env) == "fork"
    assert children.route([sys.executable, "-m", "x"],
                          dict(env, OMP_NUM_THREADS="2")) == "cache"
    assert children.route([sys.executable, "-m", "x"], env,
                          fresh=True) == "cache"
    plain = {k: v for k, v in env.items() if k != "PYTHONPYCACHEPREFIX"}
    assert children.route([sys.executable, "-c", "pass"], plain) == "plain"
    assert children.route([sys.executable, "-u", "-m", "x"], env) == "cache"
    assert children.route(["git", "status"], env) == "tool"


def test_refuses_to_fork_once_cuda_is_initialized(env, tiny):
    server = chip_smoke.ForkServer(
        env, REPO, preload="import numpy, torch; "
        "torch.cuda.is_initialized = lambda: True")
    try:
        with pytest.raises(RuntimeError, match="refused .*CUDA is "
                           "initialized in the fork server"):
            server.popen(_tiny("echo", "0"), env=env, cwd=tiny)
    finally:
        server.close()


def test_a_dead_server_fails_its_requests(env, tiny, tmp_path):
    server = chip_smoke.ForkServer(env, REPO)
    pid_file = tmp_path / "pid"
    try:
        proc = server.popen(_tiny("sleep", str(pid_file)), env=env, cwd=tiny,
                            stdout=subprocess.PIPE, text=True)
        assert proc.stdout.readline() == "up\n"
        server.proc.kill()
        server.proc.wait(STARTS)
        with pytest.raises(RuntimeError, match="server has died"):
            proc.wait(STARTS)
        with pytest.raises(RuntimeError, match="fork server took no "
                           "request"):
            server.popen(_tiny("echo", "0"), env=env, cwd=tiny)
    finally:
        os.kill(int(pid_file.read_text()), signal.SIGKILL)
        proc.stdout.close()
        server.close()


def test_closing_the_server_stops_its_children(env, tiny, tmp_path):
    server = chip_smoke.ForkServer(env, REPO)
    proc = server.popen(_tiny("sleep", str(tmp_path / "pid")), env=env,
                        cwd=tiny, stdout=subprocess.PIPE, text=True)
    assert proc.stdout.readline() == "up\n"
    server.close()
    assert server.proc.returncode == 0
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            os.kill(proc.pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.05)
    else:
        pytest.fail(f"child {proc.pid} outlived its fork server")
    proc.stdout.close()


# -- coordinated groups' rendezvous ports --------------------------------------

TAKEN = ("The server socket has failed to listen on any local network "
         "address. port: {}, useIpv6: false, code: -98, name: EADDRINUSE, "
         "message: address already in use")


def _groups(sizes):
    """A group a size: its ranks' argvs carry its port and its index."""
    return [lambda port, g=g, n=n: [["group", str(g), str(port), str(r)]
                                    for r in range(n)]
            for g, n in enumerate(sizes)]


@pytest.fixture
def ranks(monkeypatch):
    """chip_smoke._run_ranks stubbed: each call's argvs are recorded,
    and `fail(argv)` gives a rank's (rc, stderr)."""
    calls: list = []
    state = {"fail": lambda argv: (0, "")}

    def run(argvs):
        calls.append(argvs)
        out = []
        for a in argvs:
            rc, err = state["fail"](a)
            out.append((rc, f"rank {a}", err))
        return out

    monkeypatch.setattr(chip_smoke, "_run_ranks", run)
    return calls, state


def test_concurrent_groups_take_distinct_ports(ranks):
    calls, _ = ranks
    out = chip_smoke._run_groups(_groups([2, 1, 2]))
    assert len(calls) == 1 and len(calls[0]) == 5
    ports = {g: {a[2] for a in calls[0] if a[1] == str(g)} for g in range(3)}
    assert all(len(p) == 1 for p in ports.values())
    assert len({p.pop() for p in ports.values()}) == 3
    assert [[r[1] for r in res] for res in out] == [
        [f"rank {a}" for a in calls[0] if a[1] == str(g)] for g in range(3)]


def test_a_group_whose_port_was_taken_reruns_once(ranks):
    calls, state = ranks
    state["fail"] = lambda a: ((1, TAKEN.format(a[2]))
                               if a[1] == "1" and len(calls) == 1
                               and a[3] == "0" else (0, ""))
    out = chip_smoke._run_groups(_groups([2, 2, 1]))
    assert len(calls) == 2
    assert {a[1] for a in calls[1]} == {"1"}      # only the failed group
    first = {a[2] for a in calls[0] if a[1] == "1"}
    assert {a[2] for a in calls[1]} != first
    assert [rc for rc, _, _ in out[1]] == [0, 0]
    assert out[0][0][1] == f"rank {calls[0][0]}"


@pytest.mark.parametrize("err", ["ValueError: boom", TAKEN.format(1)])
def test_no_rerun_for_another_failure_or_a_second_bind_failure(ranks, err):
    calls, state = ranks
    bind = "EADDRINUSE" in err
    state["fail"] = lambda a: (1, err) if a[1] == "0" else (0, "")
    out = chip_smoke._run_groups(_groups([2, 1]))
    # another failure is the caller's; a bind failure is rerun once only
    assert len(calls) == (2 if bind else 1)
    assert [rc for rc, _, _ in out[0]] == [1, 1]


def test_no_rank_group_picks_its_port_alone():
    """Every coordinated group of the script takes its port through
    _run_groups (one launch.free_ports call a batch of groups)."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    singles = [n.lineno for n in ast.walk(tree)
               if isinstance(n, ast.Attribute) and n.attr == "free_port"]
    assert not singles, singles
