"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``),
its store rendezvous and ``fleet.ElasticManager`` against the JAX
package's: the child environment equals the JAX launcher's, restarts and
logs, two nodes taking their ranks through the store, and a peer's death
detected by its heartbeat (exit 101).  Heartbeats run every 0.1-0.3 s, so
a death shows within seconds; single-node launches run in this process
(``launch.main``), the multi-node ones as real launcher processes."""

import argparse
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import pytest

from paddle_tpu.distributed import launch as jlaunch
from paddle_tpu_torch.distributed import launch
from paddle_tpu_torch.distributed.fleet import ELASTIC_EXIT_CODE, ElasticManager
from paddle_tpu_torch.distributed.fleet.elastic import migrate_to_mesh
from paddle_tpu_torch.distributed.launch.rendezvous import (
    GenerationInvalidated, invalidate_generation, rendezvous, shrink_rendezvous)
from paddle_tpu_torch.distributed.store import TCPStore

REPO = Path(__file__).resolve().parents[1]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------- the CLI

def _options(parser):
    return sorted((a.dest, tuple(a.option_strings), a.default, a.type, a.choices)
                  for a in parser._actions if not isinstance(a, argparse._HelpAction))


def test_flags_equal_jax():
    assert _options(launch.build_parser()) == _options(jlaunch.build_parser())
    assert launch.ELASTIC_EXIT_CODE == jlaunch.ELASTIC_EXIT_CODE == ELASTIC_EXIT_CODE == 101


PEERS = [{"rank": 0, "host": "a", "prev_rank": 2, "prev_nnodes": 3},
         {"rank": 1, "host": "b", "prev_rank": 0, "prev_nnodes": 3}]


@pytest.mark.parametrize("argv,local_rank,coordinator,peers", [
    ([], 0, None, None),
    (["--nnodes", "4", "--rank", "3", "--master", "10.0.0.1:9999"], 0, None, None),
    (["--nnodes", "2", "--rank", "1", "--nproc_per_node", "2"], 1, "h0:8477", None),
    (["--nnodes", "2", "--rank", "0", "--max_restarts", "1"], 0, "a:8480", PEERS),
], ids=["single", "multi", "nproc", "shrunk"])
def test_child_env_equals_jax(argv, local_rank, coordinator, peers, monkeypatch):
    monkeypatch.setenv("PADDLE_RESTART_COUNT", "0")
    envs = []
    for mod in (launch, jlaunch):
        args = mod.build_parser().parse_args(argv + ["train.py", "--lr", "1"])
        if peers is not None:
            args._shrink_peers = peers
        envs.append(mod._child_env(args, local_rank, coordinator))
    assert envs[0] == envs[1]
    if argv:
        assert "PADDLE_TPU_COORDINATOR" in envs[0]


def _script(tmp_path, body, name="train.py"):
    path = tmp_path / name
    path.write_text(textwrap.dedent(body))
    return str(path)


def test_restart_then_success(tmp_path):
    marker = tmp_path / "attempts.txt"
    script = _script(tmp_path, f"""
        import os, sys
        n = int(open({str(marker)!r}).read()) if os.path.exists({str(marker)!r}) else 0
        open({str(marker)!r}, "w").write(str(n + 1))
        assert os.environ["PADDLE_RESTART_COUNT"] == str(n)
        if n < 2:
            sys.exit(101)                  # a simulated preemption
        print("recovered-after", n)
    """)
    rc = launch.main(["--max_restarts", "3", "--log_dir", str(tmp_path / "logs"), script])
    assert rc == 0
    assert marker.read_text() == "3"
    assert "recovered-after 2" in (tmp_path / "logs" / "default.rank0.local0.log").read_text()


def test_restarts_exhausted(tmp_path):
    script = _script(tmp_path, "import sys; sys.exit(7)\n")
    assert launch.main(["--max_restarts", "1", "--log_dir", str(tmp_path), script]) == 7


def test_log_dir(tmp_path):
    log_dir = tmp_path / "logs"
    script = _script(tmp_path, """
        import os
        print("hello-from-child", os.environ["PADDLE_TRAINER_ID"],
              os.environ["PADDLE_TRAINERS_NUM"], "PADDLE_TPU_COORDINATOR" in os.environ)
    """)
    assert launch.main(["--log_dir", str(log_dir), "--job_id", "j1", script]) == 0
    logs = list(log_dir.glob("j1.*.log"))
    assert [p.name for p in logs] == ["j1.rank0.local0.log"]
    assert "hello-from-child 0 1 False" in logs[0].read_text()


# ---------------------------------------------------------------- rendezvous

def _launchers(script, port, n, *extra):
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--master", f"127.0.0.1:{port}", "--nnodes", str(n), "--rank", "-1", *extra, script]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=env) for _ in range(n)]


def test_two_nodes_take_their_ranks_through_the_store(tmp_path):
    script = _script(tmp_path, """
        import os
        print("ASSIGNED", os.environ["PADDLE_TRAINER_ID"], os.environ["PADDLE_TRAINERS_NUM"],
              os.environ["PADDLE_TPU_COORDINATOR"], flush=True)
    """)
    port = _free_port()
    procs = _launchers(script, port, 2)
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    got = sorted(line.split()[1:] for out in outs for line in out.splitlines()
                 if line.startswith("ASSIGNED"))
    # the coordinator binds past the store's port, on the rank-0 node
    assert [g[:2] for g in got] == [["0", "2"], ["1", "2"]]
    assert {g[2].rsplit(":", 1)[1] for g in got} == {str(port + 1)}


def test_rendezvous_generations_roll_and_short_ones_time_out():
    r1 = rendezvous("127.0.0.1:0", 1, job_id="genroll")
    r2 = rendezvous(f"127.0.0.1:{r1.store.port}", 1, job_id="genroll")
    assert (r1.rank, r1.gen, r2.rank, r2.gen) == (0, 0, 0, 1)
    r2.store.close()
    r1.store.close()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"missing ranks \[1\]"):
        rendezvous("127.0.0.1:0", nnodes=2, job_id="short", timeout=1.0)
    assert time.monotonic() - t0 < 20.0


def test_rendezvous_aborts_on_an_invalidated_generation():
    master = TCPStore("127.0.0.1", 0, world_size=2, is_master=True, timeout=10.0)
    errs = []

    def join():
        try:
            rendezvous(f"127.0.0.1:{master.port}", nnodes=2, job_id="inv", timeout=30.0)
        except BaseException as e:  # noqa: BLE001 - surfaced by the assert
            errs.append(e)

    t = threading.Thread(target=join, daemon=True)
    t.start()
    time.sleep(0.5)                     # the joiner registers as rank 0 of gen 0
    invalidate_generation(master, "inv", 0, dead_ranks=[1])
    t.join(timeout=15.0)
    assert not t.is_alive() and len(errs) == 1 and isinstance(errs[0], GenerationInvalidated)
    master.close()


def test_shrink_rendezvous_reforms_the_survivors():
    master = TCPStore("127.0.0.1", 0, world_size=3, is_master=True, timeout=30.0)
    addr = f"127.0.0.1:{master.port}"
    results, shrunk, errs = {}, {}, []

    def run(fn, *a):
        try:
            fn(*a)
        except BaseException as e:  # noqa: BLE001 - surfaced by the assert
            errs.append(e)

    def join(i):
        results[i] = rendezvous(addr, nnodes=3, job_id="shrink", timeout=30.0)

    def reform(prev):
        invalidate_generation(prev.store, prev.job_id, prev.gen, [2])
        shrunk[prev.rank] = shrink_rendezvous(prev, [2], timeout=30.0)

    for fn, args in ((join, [(i,) for i in range(3)]), (reform, None)):
        if args is None:
            by_rank = {r.rank: r for r in results.values()}
            assert sorted(by_rank) == [0, 1, 2]
            args = [(by_rank[r],) for r in (0, 1)]     # rank 2 died
        threads = [threading.Thread(target=run, args=(fn, *a), daemon=True) for a in args]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not errs, errs
    new = list(shrunk.values())
    assert sorted(r.rank for r in new) == [0, 1]
    assert all(r.nnodes == 2 and r.subgen == 0 and len(r.peers) == 2 for r in new)
    assert sorted(p["prev_rank"] for p in new[0].peers) == [0, 1]
    for r in results.values():
        r.store.close()
    master.close()


# ---------------------------------------------------------------- elastic

def _stores(n):
    master = TCPStore("127.0.0.1", 0, world_size=n, is_master=True, timeout=10.0)
    return [master] + [TCPStore("127.0.0.1", master.port, world_size=n, timeout=10.0)
                       for _ in range(n - 1)]


def test_elastic_manager_flags_a_dead_peer():
    stores = _stores(3)
    mgrs = [ElasticManager(s, r, 3, job_id="hb", interval=0.1).start()
            for r, s in enumerate(stores)]
    try:
        assert mgrs[0].dead_peers() == [] and mgrs[1].dead_peers() == []
        mgrs[2].stop()                  # node 2 dies
        seen = {}
        dead = mgrs[0].watch(on_dead=lambda rs: seen.setdefault("d", rs))
        assert dead == [2] and seen["d"] == [2]
        assert 2 in mgrs[1].dead_peers()
        assert set(mgrs[0].counters()) == {0, 1, 2}
    finally:
        for m in mgrs:
            m.stop()
        for s in stores:
            s.close()
    with pytest.raises(NotImplementedError, match="meshes"):
        migrate_to_mesh({}, None)


def test_peer_death_exits_with_the_elastic_code(tmp_path):
    """Two auto-rank launchers; one is SIGKILLed while its trainer runs.
    The survivor's heartbeat watch sees it, stops its own trainer and exits
    101 for an outer supervisor.  The trainers leave when their launcher
    goes, so nothing outlives the test."""
    script = _script(tmp_path, f"""
        import os, time
        rank = os.environ["PADDLE_TRAINER_ID"]
        open(os.path.join({str(tmp_path)!r}, "up" + rank), "w").close()
        parent = os.getppid()
        while os.getppid() == parent:
            time.sleep(0.1)
    """)
    procs = _launchers(script, _free_port(), 2, "--max_restarts", "0",
                       "--heartbeat_interval", "0.2")
    try:
        deadline = time.monotonic() + 120
        while not all((tmp_path / f"up{r}").exists() for r in (0, 1)):
            assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
            time.sleep(0.1)
        procs[1].send_signal(signal.SIGKILL)
        out, _ = procs[0].communicate(timeout=120)
        assert procs[0].returncode == ELASTIC_EXIT_CODE, (procs[0].returncode, out[-2000:])
        assert "stopped heartbeating" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
