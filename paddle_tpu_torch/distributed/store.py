"""``TCPStore``: the host-side key-value store of the control plane (port
of ``paddle_tpu/distributed/store.py``).

Counterpart of the reference's native ``TCPStore``
(``paddle/phi/core/distributed/store/tcp_store.h:121`` ``class TCPStore :
Store`` with set/get/add/wait, ``tcp_utils.cc`` socket plumbing).  The
device rendezvous belongs to ``torch.distributed``; this store is the host
control plane the reference uses TCPStore for: launcher/elastic
membership, rpc registries, checkpoint coordination, cross-host barriers.

The hot implementation is native C++
(``paddle_tpu_torch/core/csrc/tcp_store.cc``) loaded via ctypes; a
pure-Python client/server speaks the SAME wire protocol (and the JAX
package's, so clients and servers of both packages interoperate within one
job).  The native library is built at first use and a failed build raises;
``use_native=False`` picks the Python kind explicitly.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple, Union

from ..core import native

__all__ = ["TCPStore", "WarmStandby"]

_SET, _GET, _ADD, _WAIT, _DELETE, _SNAPSHOT = 1, 2, 3, 4, 5, 6

#: master-side key a WarmStandby advertises its endpoint under; clients
#: that called TCPStore.enable_failover() re-point here on master death
STANDBY_ENDPOINT_KEY = b"__standby/endpoint"


# ---------------------------------------------------------------------------
# pure-Python protocol fallback (same wire format as tcp_store.cc)
# ---------------------------------------------------------------------------

def _send_bytes(sock: socket.socket, data: bytes) -> None:
    sock.sendall(struct.pack("!I", len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store peer closed")
        buf += chunk
    return buf


def _recv_bytes(sock: socket.socket) -> bytes:
    (n,) = struct.unpack("!I", _recv_exact(sock, 4))
    return _recv_exact(sock, n) if n else b""


def _encode_kv(kv: Dict[bytes, bytes], extra: bytes = b"") -> bytes:
    """Length-prefixed key/value framing for the snapshot op: item count,
    then per item a length-prefixed key and value, then ``extra`` verbatim
    (the replicated store's catch-up metadata rides there).  Replaces the
    old pickle payload — nothing executable crosses the socket."""
    out = [struct.pack("!q", len(kv))]
    for k, v in kv.items():
        out.append(struct.pack("!I", len(k)) + k)
        out.append(struct.pack("!I", len(v)) + v)
    out.append(extra)
    return b"".join(out)


def _decode_kv(blob: bytes) -> Tuple[Dict[bytes, bytes], bytes]:
    """Inverse of :func:`_encode_kv`: returns the map and any trailing
    ``extra`` bytes.  Raises ``ValueError`` on a truncated frame."""
    if len(blob) < 8:
        raise ValueError("store snapshot frame truncated (no item count)")
    (count,) = struct.unpack("!q", blob[:8])
    off = 8
    kv: Dict[bytes, bytes] = {}
    for _ in range(count):
        for slot in range(2):
            if off + 4 > len(blob):
                raise ValueError("store snapshot frame truncated")
            (n,) = struct.unpack("!I", blob[off:off + 4])
            off += 4
            if off + n > len(blob):
                raise ValueError("store snapshot frame truncated")
            if slot == 0:
                k = blob[off:off + n]
            else:
                kv[k] = blob[off:off + n]
            off += n
    return kv, blob[off:]


class _PyServer:
    def __init__(self, port: int):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", port))
        self._sock.listen(512)
        self.port = self._sock.getsockname()[1]
        self._kv: Dict[bytes, bytes] = {}
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def num_keys(self) -> int:
        with self._cond:
            return len(self._kv)

    def _accept(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return  # stop() closed the socket before this thread ran
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            with conn:
                while not self._stop.is_set():
                    cmd = _recv_exact(conn, 1)[0]
                    key = _recv_bytes(conn)
                    if cmd == _SET:
                        val = _recv_bytes(conn)
                        with self._cond:
                            self._kv[key] = val
                            self._cond.notify_all()
                        conn.sendall(b"\x00" + struct.pack("!I", 0))
                    elif cmd == _GET:
                        with self._cond:
                            val = self._kv.get(key)
                        if val is None:
                            conn.sendall(b"\x01" + struct.pack("!I", 0))
                        else:
                            conn.sendall(b"\x00")
                            _send_bytes(conn, val)
                    elif cmd == _ADD:
                        (delta,) = struct.unpack("<q", _recv_bytes(conn))
                        with self._cond:
                            raw = self._kv.get(key)
                            # non-8-byte existing value counts as 0, matching
                            # the native server (tcp_store.cc kAdd size check)
                            cur = struct.unpack("<q", raw)[0] \
                                if raw is not None and len(raw) == 8 else 0
                            now = cur + delta
                            self._kv[key] = struct.pack("<q", now)
                            self._cond.notify_all()
                        conn.sendall(b"\x00")
                        _send_bytes(conn, struct.pack("<q", now))
                    elif cmd == _WAIT:
                        (timeout_ms,) = struct.unpack("<I", _recv_bytes(conn))
                        deadline = time.monotonic() + timeout_ms / 1000.0
                        with self._cond:
                            while key not in self._kv and not self._stop.is_set():
                                left = deadline - time.monotonic()
                                if left <= 0 or not self._cond.wait(left):
                                    break
                            have = key in self._kv
                        conn.sendall((b"\x00" if have else b"\x01") +
                                     struct.pack("!I", 0))
                    elif cmd == _DELETE:
                        with self._cond:
                            self._kv.pop(key, None)
                        conn.sendall(b"\x00" + struct.pack("!I", 0))
                    elif cmd == _SNAPSHOT:
                        # full key-space dump for the warm standby's mirror
                        with self._cond:
                            blob = _encode_kv(dict(self._kv))
                        conn.sendall(b"\x00")
                        _send_bytes(conn, blob)
                    else:
                        return
        except (ConnectionError, OSError):
            pass

    def stop(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass


_OP_NAMES = {_SET: "set", _GET: "get", _ADD: "add", _WAIT: "wait",
             _DELETE: "delete"}


class _PyClient:
    """Pure-Python client with bounded ops: the connected socket honors the
    store timeout (a dead master raises ``TimeoutError`` naming the key —
    it can never hang ``get()`` forever), and idempotent ops reconnect on a
    dropped connection under an exponential-backoff policy."""

    def __init__(self, host: str, port: int, timeout: float):
        self._host, self._port = host, port
        self._timeout = float(timeout)
        self._mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._failover: Optional[Tuple[str, int]] = None
        self._connect(time.monotonic() + timeout)

    def set_failover(self, host: str, port: int) -> None:
        """Warm-standby endpoint to re-point at when the master becomes
        unreachable (see :class:`WarmStandby`)."""
        self._failover = (host, int(port))

    def _switch_failover(self) -> bool:
        """Re-point at the standby (at most once — it IS the master after
        that).  Returns True when an op should retry there."""
        if self._failover is None or (self._host, self._port) == self._failover:
            return False
        print(f"[store] master {self._host}:{self._port} unreachable; "
              f"failing over to standby "
              f"{self._failover[0]}:{self._failover[1]}",
              file=sys.stderr, flush=True)
        self._host, self._port = self._failover
        self._drop_sock()
        return True

    def _connect(self, deadline: float):
        last = None
        while time.monotonic() < deadline:
            try:
                self._sock = socket.create_connection(
                    (self._host, self._port),
                    timeout=min(5.0, self._timeout))
                self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock.settimeout(self._timeout)
                return
            except OSError as e:
                last = e
                self._sock = None
                time.sleep(0.05)
        raise TimeoutError(
            f"TCPStore: cannot reach {self._host}:{self._port}: {last}")

    def _drop_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _retry_policy(self):
        from ..framework import flags
        from .fault_tolerance.policy import RetryPolicy
        return RetryPolicy(max_attempts=flags.get_flag("ft_store_max_retries"),
                           base_delay=flags.get_flag("ft_store_backoff_base"),
                           seed=flags.get_flag("ft_inject_seed"))

    def _roundtrip(self, cmd: int, key: bytes, payload: Optional[bytes],
                   op_timeout: Optional[float] = None,
                   idempotent: bool = True):
        from .fault_tolerance.injection import get_injector

        op = _OP_NAMES.get(cmd, str(cmd))
        limit = op_timeout if op_timeout is not None else self._timeout
        inj = get_injector()
        with self._mu:
            if inj is not None and inj.delay_seconds():
                time.sleep(inj.delay_seconds())  # slow/partitioned peer
            drop_next = inj is not None and inj.should_drop()
            policy = self._retry_policy()
            last: Optional[BaseException] = None
            # outer loop: at most two endpoints — the master, then (if a
            # WarmStandby was advertised via set_failover) the standby;
            # each gets a fresh attempt budget and deadline
            for _ep_round in range(2):
                schedule = policy.delays()
                deadline = time.monotonic() + limit
                switched = False
                for _ in range(policy.max_attempts):
                    try:
                        if self._sock is None:
                            self._connect(deadline)
                        if drop_next:
                            drop_next = False
                            self._drop_sock()
                            raise ConnectionError("[inject] store connection dropped")
                        self._sock.settimeout(max(0.05, min(limit,
                                                            deadline - time.monotonic())))
                        msg = bytes([cmd]) + struct.pack("!I", len(key)) + key
                        if payload is not None:
                            msg += struct.pack("!I", len(payload)) + payload
                        self._sock.sendall(msg)
                        status = _recv_exact(self._sock, 1)[0]
                        val = _recv_bytes(self._sock)
                        return status, val
                    except TimeoutError as e:
                        # socket.timeout (master unresponsive) or the reconnect
                        # deadline inside _connect — either way: bounded, loud
                        self._drop_sock()
                        if self._switch_failover():
                            last = e
                            switched = True
                            break  # retry the op on the standby
                        raise TimeoutError(
                            f"TCPStore {op}({key!r}) timed out after {limit:.1f}s "
                            f"(master {self._host}:{self._port} dead or "
                            f"unresponsive)") from e
                    except (ConnectionError, OSError) as e:
                        last = e
                        self._drop_sock()
                        if not idempotent:
                            # the op may or may not have executed server-side;
                            # a blind retry could e.g. double-increment a rank
                            # counter — surface the drop to the caller instead
                            raise ConnectionError(
                                f"TCPStore {op}({key!r}) connection lost mid-op: "
                                f"{e}") from e
                        delay = next(schedule, None)
                        if delay is None or time.monotonic() + delay > deadline:
                            break
                        time.sleep(delay)
                # this endpoint's budget is spent; unless the TimeoutError
                # path already re-pointed us, try the standby (once)
                if not switched and not self._switch_failover():
                    break
            raise TimeoutError(
                f"TCPStore {op}({key!r}): master {self._host}:{self._port} "
                f"unreachable within {limit:.1f}s ({last})")

    def set(self, key: bytes, val: bytes, op_timeout: Optional[float] = None):
        status, _ = self._roundtrip(_SET, key, val, op_timeout=op_timeout)
        if status != 0:
            raise RuntimeError("store set failed")

    def get(self, key: bytes,
            op_timeout: Optional[float] = None) -> Optional[bytes]:
        status, val = self._roundtrip(_GET, key, None, op_timeout=op_timeout)
        return val if status == 0 else None

    def add(self, key: bytes, delta: int,
            op_timeout: Optional[float] = None) -> int:
        status, val = self._roundtrip(_ADD, key, struct.pack("<q", delta),
                                      op_timeout=op_timeout, idempotent=False)
        if status != 0:
            raise RuntimeError("store add failed")
        return struct.unpack("<q", val)[0]

    def wait_key(self, key: bytes, timeout_ms: int) -> bool:
        # the server parks the request up to timeout_ms before answering —
        # the socket deadline must outlive the server-side wait
        status, _ = self._roundtrip(_WAIT, key, struct.pack("<I", timeout_ms),
                                    op_timeout=timeout_ms / 1000.0 + 5.0)
        return status == 0

    def delete(self, key: bytes):
        self._roundtrip(_DELETE, key, None)

    def snapshot(self, op_timeout: Optional[float] = None) -> Dict[bytes, bytes]:
        """Full key-space dump (the warm standby's mirror primitive)."""
        status, val = self._roundtrip(_SNAPSHOT, b"", None,
                                      op_timeout=op_timeout)
        if status != 0:
            raise RuntimeError("store snapshot failed")
        kv, _extra = _decode_kv(val)
        return kv

    def close(self):
        self._drop_sock()


class WarmStandby:
    """Warm-standby TCPStore: high availability without consensus.

    Runs its own server, mirrors the master's FULL key-space via the
    snapshot op every ``interval`` seconds, and advertises its endpoint
    on the master (``__standby/endpoint``) so clients that called
    :meth:`TCPStore.enable_failover` re-point here when the master dies
    instead of hanging the next rendezvous.

    Scope (deliberate): mirror + client re-point only.  Writes that land
    after failover exist on the standby alone; a master that comes back
    is NOT reconciled, and keys written between the last snapshot and
    the master's death are lost — acceptable for the rendezvous /
    heartbeat control plane, whose keys are re-established by the next
    generation anyway.  For a control plane whose acked writes must
    survive the coordinator dying, use
    ``distributed.store_replicated.ReplicatedStore``; this class is
    retained as the cheap 2-node degraded mode.

    Timing derivation (``fault_tolerance.heartbeat_config``): the
    polling ``interval`` defaults to the heartbeat interval and the
    probe ``timeout`` to the lease ttl — a master silent for a full
    membership-lease ttl is degraded exactly when the failure detector
    would declare a peer dead.  ``max_failures`` is how many
    consecutive intervals fit in one ttl (>= 3); past it the standby
    enters DEGRADED mode: it keeps serving the last mirror AND keeps
    probing at an exponentially backed-off cadence (capped at
    ``max(5s, 10 x interval)``), resuming live mirroring if the master
    returns.
    """

    def __init__(self, master_host: str, master_port: int,
                 host: str = "127.0.0.1", port: int = 0,
                 interval: Optional[float] = None,
                 timeout: Optional[float] = None,
                 max_failures: Optional[int] = None):
        from .fault_tolerance.policy import heartbeat_config
        hb = heartbeat_config(interval=interval)
        self._server = _PyServer(port)
        self.host, self.port = host, self._server.port
        self.interval = hb.interval
        if timeout is None:
            timeout = hb.ttl
        self.max_failures = (int(max_failures) if max_failures is not None
                             else max(3, int(round(hb.ttl / hb.interval))))
        self._client = _PyClient(master_host, int(master_port), float(timeout))
        self._client.set(STANDBY_ENDPOINT_KEY,
                         f"{host}:{self.port}".encode())
        self.mirrored = 0  # snapshots applied (monotonic)
        self.degraded = False  # True while serving a possibly-stale mirror
        self.recoveries = 0  # master came back after a degraded stretch
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._mirror_loop,
                                        name="store-standby", daemon=True)
        self._thread.start()

    def _mirror_loop(self):
        failures = 0
        delay = self.interval
        backoff_cap = max(5.0, 10.0 * self.interval)
        op_timeout = max(2.0, 2.0 * self.interval)
        while not self._stop.is_set():
            try:
                kv = self._client.snapshot(op_timeout=op_timeout)
                with self._server._cond:
                    self._server._kv.clear()
                    self._server._kv.update(kv)
                    self._server._cond.notify_all()
                self.mirrored += 1
                failures = 0
                delay = self.interval
                if self.degraded:
                    self.degraded = False
                    self.recoveries += 1
                    print(f"[store] standby {self.host}:{self.port}: master "
                          f"back; live mirroring resumed "
                          f"(recovery #{self.recoveries})",
                          file=sys.stderr, flush=True)
            except Exception:
                failures += 1
                if failures >= self.max_failures and not self.degraded:
                    self.degraded = True
                    print(f"[store] standby {self.host}:{self.port}: master "
                          f"unreachable {failures}x; serving last mirror "
                          f"({self.mirrored} snapshots), probing backed off",
                          file=sys.stderr, flush=True)
                if self.degraded:
                    delay = min(delay * 2.0, backoff_cap)
            self._stop.wait(delay)

    def num_keys(self) -> int:
        return self._server.num_keys()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._client.close()
        self._server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


# ---------------------------------------------------------------------------
# native handles
# ---------------------------------------------------------------------------

class _NativeServer:
    def __init__(self, lib, port: int):
        self._lib = lib
        self._h = lib.pts_server_start(port)
        if not self._h:
            raise OSError(f"TCPStore: cannot bind port {port}")
        self.port = lib.pts_server_port(self._h)

    def num_keys(self) -> int:
        return self._lib.pts_server_num_keys(self._h)

    def stop(self):
        if self._h:
            self._lib.pts_server_stop(self._h)
            self._h = None


class _NativeClient:
    def __init__(self, lib, host: str, port: int, timeout: float):
        self._lib = lib
        self._host, self._port = host, port
        # one request/response in flight per connection: without this lock,
        # concurrent ops from the heartbeat/monitor/watch threads interleave
        # send+recv on the shared socket and deadlock reading each other's
        # responses (same discipline as _PyClient._mu)
        self._mu = threading.Lock()
        self._h = lib.pts_client_connect(host.encode(), port,
                                         int(timeout * 1000))
        if not self._h:
            raise TimeoutError(f"TCPStore: cannot reach {host}:{port}")

    def _fail(self, op: str, key: bytes):
        # same typed contract as _PyClient: a broken/unresponsive master is
        # a ConnectionError naming the op + key, never a bare RuntimeError
        raise ConnectionError(
            f"TCPStore {op}({key!r}) failed (master {self._host}:"
            f"{self._port} dead or unresponsive)")

    # op_timeout is accepted for client-interface parity and ignored: native
    # ops never reconnect, so a dead master fails them immediately (the recv
    # errors out) — there is no retry loop to bound

    def set(self, key: bytes, val: bytes, op_timeout: Optional[float] = None):
        with self._mu:
            if self._lib.pts_set(self._h, key, len(key), val, len(val)) != 0:
                self._fail("set", key)

    def get(self, key: bytes,
            op_timeout: Optional[float] = None) -> Optional[bytes]:
        import ctypes
        out = ctypes.POINTER(ctypes.c_uint8)()
        n = ctypes.c_int()
        with self._mu:
            rc = self._lib.pts_get(self._h, key, len(key),
                                   ctypes.byref(out), ctypes.byref(n))
            if rc == 1:
                return None
            if rc != 0:
                self._fail("get", key)
            val = bytes(bytearray(out[: n.value])) if n.value else b""
            self._lib.pts_buf_free(out)
        return val

    def add(self, key: bytes, delta: int,
            op_timeout: Optional[float] = None) -> int:
        import ctypes
        res = ctypes.c_int64()
        with self._mu:
            if self._lib.pts_add(self._h, key, len(key), delta,
                                 ctypes.byref(res)) != 0:
                self._fail("add", key)
        return res.value

    def wait_key(self, key: bytes, timeout_ms: int) -> bool:
        # slice long waits so heartbeat/monitor threads sharing this
        # connection aren't starved for the whole rendezvous timeout
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            remaining_ms = int((deadline - time.monotonic()) * 1000)
            slice_ms = max(1, min(200, remaining_ms))
            with self._mu:
                rc = self._lib.pts_wait(self._h, key, len(key), slice_ms)
            if rc < 0:
                self._fail("wait", key)
            if rc == 0:
                return True
            if remaining_ms <= slice_ms:
                return False

    def delete(self, key: bytes):
        with self._mu:
            self._lib.pts_delete(self._h, key, len(key))

    def close(self):
        if self._h:
            self._lib.pts_client_close(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# public API (reference TCPStore surface)
# ---------------------------------------------------------------------------

def _replicated_endpoints_from_env(
        host: str, port: int) -> Optional[List[Tuple[str, int]]]:
    """Parse ``PADDLE_STORE_ENDPOINTS`` (exported by a ReplicaGroup) and
    return it only when ``host:port`` is one of the listed replicas — the
    scope check that keeps replication from hijacking unrelated stores
    (collective p2p, rpc registry) built on other ports."""
    raw = os.environ.get("PADDLE_STORE_ENDPOINTS", "")
    if not raw:
        return None
    eps: List[Tuple[str, int]] = []
    for tok in raw.split(","):
        h, _, p = tok.strip().rpartition(":")
        if h and p.isdigit():
            eps.append((h, int(p)))
    if (host, int(port)) not in eps:
        return None
    return eps

class TCPStore:
    """Reference-compatible store: the coordinator (``is_master=True``) hosts
    the map; every process (coordinator included) is a client.

    >>> s0 = TCPStore("127.0.0.1", 0, world_size=2, is_master=True)
    >>> s1 = TCPStore("127.0.0.1", s0.port, world_size=2)
    >>> s1.set("k", b"v"); s0.get("k")
    b'v'

    ``replicas >= 2`` upgrades the store to the quorum-replicated
    control plane (``store_replicated``) behind the same client surface:
    the master hosts an N-replica group instead of one server, clients
    follow NotLeader redirects transparently.  Client processes adopt
    replication through the ``PADDLE_STORE_ENDPOINTS`` env the group
    exports (scoped: only a construction whose ``host:port`` appears in
    the endpoint list is upgraded, so unrelated stores — p2p, rpc — on
    other ports are untouched).
    """

    def __init__(self, host: str, port: int, world_size: int = 1,
                 is_master: bool = False, timeout: float = 300.0,
                 use_native: Optional[bool] = None,
                 replicas: Optional[int] = None):
        n_replicas = int(replicas or 0)
        env_eps = _replicated_endpoints_from_env(host, port)
        if n_replicas >= 2 or env_eps:
            from .store_replicated import attach_replicated
            attach_replicated(self, host, port, world_size=int(world_size),
                              is_master=bool(is_master), timeout=float(timeout),
                              replicas=n_replicas, endpoints=env_eps)
            return
        if use_native is None:
            from .fault_tolerance.injection import get_injector
            inj = get_injector()
            if inj is not None and (inj.store_drop_rate > 0
                                    or inj.store_delay_ms > 0):
                # store-fault injection instruments the Python client (drops,
                # delays, reconnect) — chaos runs must not silently bypass it
                use_native = False
        # the native library, built at first use; a failed build raises
        lib = native.load() if use_native in (None, True) else None
        self._server = None
        self.is_master = bool(is_master)
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        if is_master:
            self._server = (_NativeServer(lib, port) if lib is not None
                            else _PyServer(port))
            port = self._server.port
        self.host, self.port = host, port
        self._client = (_NativeClient(lib, host, port, timeout)
                        if lib is not None else _PyClient(host, port, timeout))
        self.native = lib is not None

    @staticmethod
    def _k(key: Union[str, bytes]) -> bytes:
        return key.encode() if isinstance(key, str) else bytes(key)

    def set(self, key, value: Union[str, bytes],
            timeout: Optional[float] = None) -> None:
        """``timeout`` bounds THIS op (default: the store timeout).  Liveness
        probes pass a short one — a failure detector must not wait out the
        rendezvous-scale default to learn the master is dead."""
        if isinstance(value, str):
            value = value.encode()
        self._client.set(self._k(key), value, op_timeout=timeout)

    def get(self, key, wait: bool = True,
            timeout: Optional[float] = None) -> Optional[bytes]:
        """Blocking get (reference ``Store::get`` waits for the key).
        ``timeout`` bounds the whole op (default: the store timeout)."""
        k = self._k(key)
        t = self.timeout if timeout is None else timeout
        if wait:
            if not self._client.wait_key(k, int(t * 1000)):
                raise TimeoutError(f"TCPStore.get({key!r}) timed out")
        return self._client.get(k, op_timeout=timeout)

    def add(self, key, delta: int = 1,
            timeout: Optional[float] = None) -> int:
        return self._client.add(self._k(key), int(delta), op_timeout=timeout)

    def wait(self, keys: Union[str, List[str]], timeout: Optional[float] = None) -> None:
        if isinstance(keys, (str, bytes)):
            keys = [keys]
        ms = int((self.timeout if timeout is None else timeout) * 1000)
        for key in keys:
            if not self._client.wait_key(self._k(key), ms):
                raise TimeoutError(f"TCPStore.wait({key!r}) timed out")

    def delete_key(self, key) -> None:
        self._client.delete(self._k(key))

    def enable_failover(self, timeout: Optional[float] = None) -> bool:
        """Arm failover to the warm standby advertised on the master.

        Reads the standby endpoint (published by :class:`WarmStandby` at
        startup) and installs it on the client; when the master later
        becomes unreachable the client re-points there instead of raising.
        Returns ``False`` when no standby is advertised or the native
        client (which has no failover hook) is in use."""
        if not hasattr(self._client, "set_failover"):
            return False
        try:
            ep = self._client.get(STANDBY_ENDPOINT_KEY, op_timeout=timeout)
        except (TimeoutError, ConnectionError, OSError):
            return False
        if not ep:
            return False
        host, _, port = ep.decode().rpartition(":")
        if not host or not port.isdigit():
            return False
        self._client.set_failover(host, int(port))
        return True

    def num_keys(self) -> int:
        if self._server is None:
            raise RuntimeError("num_keys is coordinator-only")
        return self._server.num_keys()

    def barrier(self, name: str = "barrier", timeout: Optional[float] = None) -> None:
        """All ``world_size`` processes rendezvous; generation-counted so the
        same name can be reused across phases.  Bounded: raises
        ``TimeoutError`` reporting how many peers arrived — a dead peer
        fails the barrier loudly instead of hanging it."""
        arrived = self.add(f"__{name}/arrive", 1)
        gen = (arrived - 1) // self.world_size  # which barrier round am I in
        if arrived == (gen + 1) * self.world_size:  # last one in: release
            self.set(f"__{name}/release/{gen}", b"1")
        try:
            self.wait(f"__{name}/release/{gen}", timeout)
        except TimeoutError:
            try:
                now = self.add(f"__{name}/arrive", 0) - gen * self.world_size
            except Exception:
                now = -1  # store unreachable: arrival count unknown
            raise TimeoutError(
                f"store barrier {name!r} (gen {gen}) timed out after "
                f"{self.timeout if timeout is None else timeout:.1f}s: "
                f"{now}/{self.world_size} arrived") from None

    def close(self) -> None:
        self._client.close()
        if self._server is not None:
            self._server.stop()
            self._server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
