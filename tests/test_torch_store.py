"""The port's control-plane store (``paddle_tpu_torch.distributed.store``
and ``store_replicated``) against the JAX package's: every operation on
the native and the Python kind, each package's clients against the other's
servers (one wire protocol), ``WarmStandby`` failover, the replicated
store's failover guarantees, and a native build that fails raising."""

import threading
import time

import pytest

from paddle_tpu.distributed.store import TCPStore as JaxStore
from paddle_tpu_torch.core import native
from paddle_tpu_torch.distributed.fault_tolerance import set_injector
from paddle_tpu_torch.distributed.store import TCPStore, WarmStandby
from paddle_tpu_torch.distributed.store_replicated import ReplicatedStore

KINDS = {"native": True, "python": False}


@pytest.fixture(autouse=True)
def _no_injector():
    set_injector(None)
    yield
    set_injector(None)


def _ops(client, master):
    """Every store operation through ``client``, whose server ``master``
    hosts; the values must be the same whichever package or kind serves."""
    client.set("str", "value")
    assert master.get("str") == b"value"
    key = b"bin\x00key"                       # binary-safe, embedded NUL
    client.set(key, b"\x00\xffpayload")
    assert master.get(key) == b"\x00\xffpayload"
    assert client.get("absent", wait=False) is None
    assert client.add("ctr", 3) == 3
    assert master.add("ctr", -1) == 2
    assert client.add("ctr", 0) == 2
    got = {}

    def waiter():
        got["v"] = client.get("late", timeout=10.0)

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    time.sleep(0.1)
    master.set("late", b"now")
    t.join(10.0)
    assert got.get("v") == b"now"
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.2)
    client.delete_key("str")
    assert master.get("str", wait=False) is None
    assert master.num_keys() >= 3


@pytest.mark.parametrize("kind", KINDS)
def test_store_ops(kind):
    use = KINDS[kind]
    master = TCPStore("127.0.0.1", 0, world_size=2, is_master=True, timeout=10.0,
                      use_native=use)
    client = TCPStore("127.0.0.1", master.port, world_size=2, timeout=10.0, use_native=use)
    try:
        assert master.native is use and client.native is use
        _ops(client, master)
        errs = []

        def side(s):
            try:
                s.barrier("b", timeout=10.0)
                s.barrier("b", timeout=10.0)      # the same name, the next generation
            except BaseException as e:  # noqa: BLE001 - surfaced by the assert
                errs.append(e)

        threads = [threading.Thread(target=side, args=(s,), daemon=True)
                   for s in (master, client)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20.0)
        assert not errs, errs
        with pytest.raises(TimeoutError, match=r"1/2 arrived"):
            master.barrier("lonely", timeout=0.5)
        with pytest.raises(RuntimeError, match="coordinator-only"):
            client.num_keys()
    finally:
        client.close()
        master.close()


@pytest.mark.parametrize("server", KINDS)
@pytest.mark.parametrize("client", KINDS)
def test_port_client_against_jax_server(server, client):
    master = JaxStore("127.0.0.1", 0, world_size=1, is_master=True, timeout=10.0,
                      use_native=KINDS[server])
    c = TCPStore("127.0.0.1", master.port, timeout=10.0, use_native=KINDS[client])
    try:
        assert master.native is KINDS[server] and c.native is KINDS[client]
        _ops(c, master)
    finally:
        c.close()
        master.close()


@pytest.mark.parametrize("server", KINDS)
@pytest.mark.parametrize("client", KINDS)
def test_jax_client_against_port_server(server, client):
    master = TCPStore("127.0.0.1", 0, world_size=1, is_master=True, timeout=10.0,
                      use_native=KINDS[server])
    c = JaxStore("127.0.0.1", master.port, timeout=10.0, use_native=KINDS[client])
    try:
        assert master.native is KINDS[server] and c.native is KINDS[client]
        _ops(c, master)
    finally:
        c.close()
        master.close()


def test_python_snapshot_matches_jax_server():
    """The snapshot op (what WarmStandby and the replicated store's catch-up
    read) decodes the JAX server's frame."""
    with JaxStore("127.0.0.1", 0, is_master=True, timeout=5.0, use_native=False) as master:
        master.set("a", b"1")
        master.set("b", b"2")
        c = TCPStore("127.0.0.1", master.port, timeout=5.0, use_native=False)
        try:
            assert c._client.snapshot() == {b"a": b"1", b"b": b"2"}
        finally:
            c.close()


def test_warm_standby_mirrors_and_fails_over():
    """The standby mirrors the master's keys; when the master dies a client
    with ``enable_failover()`` re-points to it, reads the mirror and
    writes there."""
    master = TCPStore("127.0.0.1", 0, is_master=True, timeout=5.0, use_native=False)
    sb = WarmStandby("127.0.0.1", master.port, interval=0.05, timeout=3.0)
    client = TCPStore("127.0.0.1", master.port, timeout=3.0, use_native=False)
    try:
        client.set("job/epoch", b"7")
        deadline = time.monotonic() + 5.0
        while sb.mirrored < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert sb.mirrored >= 1 and sb.num_keys() >= 2
        assert client.enable_failover() is True
        master._server.stop()                   # the coordinator host dies
        master._server = None
        # 3 s on the dead master, then the standby
        assert client.get("job/epoch", timeout=3.0) == b"7"
        client.set("job/epoch", b"8")
        assert client.get("job/epoch", timeout=3.0) == b"8"
    finally:
        sb.stop()
        client.close()
        master.close()


@pytest.fixture()
def rs():
    store = ReplicatedStore(replicas=3, interval=0.05, timeout=30.0)
    yield store
    store.group.stop()


def test_replicated_ops(rs):
    rs.set("str", "value")
    assert rs.get("str") == b"value"
    assert rs.get("absent", wait=False) is None
    assert rs.add("ctr", 3) == 3
    assert rs.add("ctr") == 4
    rs.delete_key("str")
    assert rs.get("str", wait=False) is None


def test_replicated_leader_failover_keeps_acked_writes(rs):
    rs.set("durable", b"1")
    first = rs.leader_id()
    rs.kill_replica(first)
    second = rs.group.leader_id(timeout=15.0, exclude=(first,))
    assert second != first
    assert rs.get("durable") == b"1"
    assert rs.add("post", 1) == 1


def test_replicated_add_counts_once_across_failover(rs):
    total = 30
    rs.kill_replica(rs.leader_id())
    for _ in range(total):
        rs.add("counter", 1)
    assert rs.add("counter", 0) == total


def test_replicated_restarted_replica_catches_up(rs):
    for i in range(8):
        rs.set(f"k{i}", str(i))
    victim = rs.leader_id()
    rs.kill_replica(victim)
    rs.group.leader_id(timeout=15.0, exclude=(victim,))
    rs.set("after-kill", b"x")
    srv = rs.restart_replica(victim)
    deadline = time.monotonic() + 15.0
    while time.monotonic() < deadline:
        with srv._cond:
            if srv._synced and srv._kv.get(b"after-kill") == b"x":
                break
        time.sleep(0.05)
    with srv._cond:
        assert srv._synced, "restarted replica never caught up"
        assert srv._kv.get(b"k3") == b"3"           # from the snapshot
        assert srv._kv.get(b"after-kill") == b"x"   # from the log tail
    cur = rs.leader_id()
    rs.kill_replica(cur)                            # the restartee makes the quorum
    rs.group.leader_id(timeout=15.0, exclude=(cur,))
    assert rs.get("k7") == b"7"


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A native build that fails raises with the compiler's message; the
    store and the DataLoader's workers raise with it, and neither falls
    back to its slower path."""
    import numpy as np

    from paddle_tpu_torch.io import DataLoader

    src = tmp_path / "csrc"
    src.mkdir()
    (src / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(native, "CSRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="native build failed") as ei:
        native.load()
    assert "broken.cc" in str(ei.value)
    assert native.available() is False
    assert not list((tmp_path / "build").glob("*.so*"))    # no half-written library
    with pytest.raises(RuntimeError, match="native build failed"):
        TCPStore("127.0.0.1", 0, is_master=True, timeout=2.0)
    with TCPStore("127.0.0.1", 0, is_master=True, timeout=2.0, use_native=False) as s:
        s.set("k", b"v")                                 # the Python kind on request
        assert s.get("k") == b"v"
    loader = DataLoader([np.zeros(2, np.float32)] * 4, batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="native build failed"):
        next(iter(loader))
