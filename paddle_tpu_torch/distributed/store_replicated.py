"""Replicated control-plane store: leader-leased quorum replication.

``WarmStandby`` (store.py) is mirror + client re-point only — its own
docstring concedes that keys written between the last snapshot and the
master's death are lost.  Everything chaos-proved above the store
(rendezvous generations, the failure detector, checkpoint commit
markers, the router's exactly-once ledger) assumes acked writes
survive the coordinator dying, so this module closes the gap with a
small Raft-style replicated log behind the SAME wire protocol and the
SAME ``TCPStore`` client surface:

- N :class:`ReplicaServer` s speak the ``_PyServer`` wire format
  (cmd byte + length-prefixed frames) extended with three consensus
  ops: ``_APPEND`` (log replication + heartbeat), ``_VOTE``
  (prevote + vote), ``_CONFIG`` (membership/leader discovery).
- One leader per term.  A client ``set``/``add``/``delete`` is acked
  only after a majority of replicas appended it to their log
  (quorum commit); the entry is then applied to the key-value state
  machine on every replica in log order.
- The leader holds a **quorum-granted lease** (timings derived from
  ``fault_tolerance.store_consensus_config`` — the same flag surface
  as the failure detector): reads (``get``/``wait``/``snapshot``) are
  served only while the majority's latest append-acks are younger
  than the lease ttl minus a clock-skew margin, and the leader steps
  down once the lease lapses.  Until then no other replica can win an
  election (election timeout >= 2x lease ttl), so lease reads are
  linearizable without a quorum round per read.
- Followers redirect clients with ``NotLeader(term, leader_endpoint)``
  (status byte 2); a leader that cannot currently commit/serve
  answers "retry" (status byte 3).  :class:`ReplicatedClient` follows
  redirects, rotates endpoints, and retries within the op budget —
  callers above the ``TCPStore`` surface see none of this.
- Elections are quorum votes with randomized timeouts, preceded by a
  **prevote** probe round (no term bump) so a partitioned minority
  replica cannot inflate the term and force a disruptive re-election
  when the partition heals.
- A minority partition refuses writes: nothing commits without a
  majority, the minority leader's lease lapses so it stops serving
  reads too, and on heal its unacked log tail is truncated by the
  new leader's conflicting entries (no split brain).
- A restarted replica (``recover=True``) catches up from the current
  leader via the existing ``_SNAPSHOT`` op — key/value map plus
  applied-index/term and the add-dedup table ride the same
  length-prefixed frame — and then receives the log tail through
  normal appends; it neither votes nor stands for election until
  synced.
- ``add`` is exactly-once across failover: the client stamps each add
  with (client id, sequence), the dedup table is replicated in the
  state machine, so a retry of an add whose ack was lost to a dying
  leader returns the original result instead of double-incrementing.

Scope (deliberate, documented): the log is in-memory per process —
"durably appended" means replicated to a majority of replica
processes, which is the fault model the chaos tests exercise (kill a
replica process, partition replicas).  Disk persistence and dynamic
membership are out of scope; a full-cluster restart loses state just
like the single-server store it replaces.
"""

from __future__ import annotations

import json
import os
import random
import socket
import struct
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..obs import dump_flight, flight_event

from .store import (TCPStore, _ADD, _DELETE, _GET, _SET, _SNAPSHOT, _WAIT,
                    _decode_kv, _encode_kv, _recv_bytes, _recv_exact)
from .fault_tolerance.injection import get_injector
from .fault_tolerance.policy import (StoreConsensusConfig,
                                     store_consensus_config)

__all__ = ["ReplicatedStore", "ReplicaServer", "ReplicaGroup",
           "ReplicatedClient", "attach_replicated"]

# consensus wire ops (continue the store.py numbering)
_APPEND, _VOTE, _CONFIG = 7, 8, 9
#: log-entry op for the leader's term-opening no-op (commits the log
#: prefix under the new term without touching the state machine)
_NOOP = 0

#: reply status bytes beyond the base protocol's 0=ok / 1=not-found
_ST_NOT_LEADER = 2   # frame: json {term, leader_id, leader: "host:port"}
_ST_RETRY = 3        # no quorum / no lease yet — retry the same endpoint

_FOLLOWER, _CANDIDATE, _LEADER = "follower", "candidate", "leader"

#: ops that consume one payload frame after the key frame
_OPS_WITH_PAYLOAD = frozenset({_SET, _ADD, _WAIT, _APPEND, _VOTE, _CONFIG})

ENDPOINTS_ENV = "PADDLE_STORE_ENDPOINTS"
REPLICAS_ENV = "PADDLE_STORE_REPLICAS"


def _raw_call(endpoint: Tuple[str, int], cmd: int, key: bytes,
              payload: Optional[bytes], timeout: float):
    """One request/response round on a fresh connection (consensus RPCs
    are tiny and infrequent enough that connection reuse isn't worth the
    stale-socket states it introduces)."""
    conn = socket.create_connection(endpoint, timeout=timeout)
    try:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(timeout)
        msg = bytes([cmd]) + struct.pack("!I", len(key)) + key
        if payload is not None:
            msg += struct.pack("!I", len(payload)) + payload
        conn.sendall(msg)
        status = _recv_exact(conn, 1)[0]
        val = _recv_bytes(conn)
        return status, val
    finally:
        try:
            conn.close()
        except OSError:
            pass


def _encode_dedup(dedup: Dict[bytes, Tuple[int, int]]) -> bytes:
    out = [struct.pack("!I", len(dedup))]
    for cid, (seq, res) in dedup.items():
        out.append(struct.pack("!I", len(cid)) + cid)
        out.append(struct.pack("!qq", seq, res))
    return b"".join(out)


def _decode_dedup(blob: bytes) -> Dict[bytes, Tuple[int, int]]:
    (count,) = struct.unpack("!I", blob[:4])
    off = 4
    out: Dict[bytes, Tuple[int, int]] = {}
    for _ in range(count):
        (n,) = struct.unpack("!I", blob[off:off + 4])
        off += 4
        cid = blob[off:off + n]
        off += n
        seq, res = struct.unpack("!qq", blob[off:off + 16])
        off += 16
        out[cid] = (seq, res)
    return out


class ReplicaServer:
    """One replica of the replicated store.

    State transitions follow Raft: follower -> (randomized election
    timeout, prevote quorum) -> candidate -> (vote quorum) -> leader;
    any higher term observed demotes to follower.  All consensus state
    lives under one condition variable (``self._cond``); network I/O is
    never performed while holding it.

    ``clock`` is injectable (monotonic seconds) so the lease/skew unit
    tests can drive time explicitly; ``start=False`` builds the server
    (socket bound, state initialized) without its threads for the same
    purpose.
    """

    def __init__(self, rid: int, host: str = "127.0.0.1", port: int = 0,
                 cfg: Optional[StoreConsensusConfig] = None, seed: int = 0,
                 clock=None, start: bool = True, recover: bool = False):
        self._id = int(rid)
        self._host = host
        self._cfg = cfg if cfg is not None else store_consensus_config()
        self._now = clock if clock is not None else time.monotonic
        self._rng = random.Random(f"{seed}/store-replica/{rid}")
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", int(port)))
        self._sock.listen(512)
        self.port = self._sock.getsockname()[1]
        self.endpoint = (host, self.port)

        # consensus + state-machine state, all under _cond
        self._cond = threading.Condition()
        self._term = 0
        self._voted_for: Optional[int] = None
        self._role = _FOLLOWER
        self._leader_id: Optional[int] = None
        self._log: List[Tuple[int, int, bytes, bytes]] = []  # (term, op, k, v)
        self._base = 0          # index covered by the installed snapshot
        self._base_term = 0
        self._commit = 0
        self._applied = 0
        self._kv: Dict[bytes, bytes] = {}
        self._dedup: Dict[bytes, Tuple[int, int]] = {}  # cid -> (seq, result)
        self._add_results: Dict[int, int] = {}          # log index -> result
        self._synced = not recover  # a recovering replica may not vote/stand
        self._heard: Optional[float] = None  # last valid leader contact
        self._election_deadline = self._now() + self._election_delay()
        self._lease_grace = 0.0  # fresh-leader grace before lease step-down
        self._noop_idx: Optional[int] = None  # this term's no-op entry index
        self.writes_acked = 0

        # peer bookkeeping (populated by configure())
        self._peers: Dict[int, Tuple[str, int]] = {}
        self._all_endpoints: Dict[int, Tuple[str, int]] = {
            self._id: self.endpoint}
        self._next: Dict[int, int] = {}
        self._match: Dict[int, int] = {}
        self._ack: Dict[int, float] = {}
        self._send_ev: Dict[int, threading.Event] = {}

        self._stop = threading.Event()
        self._conn_mu = threading.Lock()
        self._conns: set = set()
        self._threads: List[threading.Thread] = []
        self._start_threads = bool(start)

    # -- lifecycle -----------------------------------------------------------

    def configure(self, endpoints: Dict[int, Tuple[str, int]]) -> None:
        """Install the full replica map (own id included) before start()."""
        self._all_endpoints = dict(endpoints)
        self._peers = {rid: ep for rid, ep in endpoints.items()
                       if rid != self._id}
        for rid in self._peers:
            self._send_ev[rid] = threading.Event()

    def start(self) -> None:
        if not self._start_threads:
            return
        t = threading.Thread(target=self._accept, daemon=True,
                             name=f"store-r{self._id}-accept")
        t.start()
        self._threads.append(t)
        t = threading.Thread(target=self._tick_loop, daemon=True,
                             name=f"store-r{self._id}-tick")
        t.start()
        self._threads.append(t)
        for rid in self._peers:
            t = threading.Thread(target=self._sender, args=(rid,),
                                 daemon=True,
                                 name=f"store-r{self._id}-send{rid}")
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for ev in self._send_ev.values():
            ev.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conn_mu:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def kill(self) -> None:
        """Fail-stop this replica (chaos injection): no cleanup beyond
        closing sockets, exactly what a dead process looks like to peers."""
        print(f"[inject] store replica {self._id} "
              f"({self._host}:{self.port}) killed", file=sys.stderr,
              flush=True)
        self.stop()

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()

    def num_keys(self) -> int:
        with self._cond:
            return len(self._kv)

    # -- timing helpers ------------------------------------------------------

    def _election_delay(self) -> float:
        # randomized in [T, 2T) so simultaneous candidacies de-synchronize
        et = self._cfg.election_timeout
        if self._heard is None and self._role != _LEADER:
            # cold boot: no leader has EVER been heard by this process, so
            # there is no lease to protect — elect at RPC scale instead of
            # waiting out a production lease timeout (a replica that was
            # merely partitioned from a live leader is still held back by
            # the prevote freshness check on the quorum side)
            et = min(et, 0.25)
        return self._rng.uniform(et, 2.0 * et)

    def _reset_election_locked(self) -> None:
        self._election_deadline = self._now() + self._election_delay()

    def _lease_expiry_locked(self) -> float:
        # the lease starts at the majority-th NEWEST append-ack (own clock
        # counts as an ack of itself): a quorum vouched for this leader at
        # that instant, and no competing election can conclude before
        # lease_ttl past it (election timeout >= 2x ttl)
        times = sorted([self._now()] + [self._ack.get(p, float("-inf"))
                                        for p in self._peers], reverse=True)
        majority_ix = (len(self._peers) + 1) // 2
        return times[majority_ix] + self._cfg.lease_ttl

    def _lease_ok_locked(self) -> bool:
        # clock_skew margin: replicas' clocks may drift within one lease,
        # so the leader must consider its lease dead strictly before the
        # quorum would grant a new one
        return self._now() < self._lease_expiry_locked() - self._cfg.clock_skew

    # -- log helpers (all _locked) -------------------------------------------

    def _last_index_locked(self) -> int:
        return self._base + len(self._log)

    def _term_at_locked(self, index: int) -> int:
        if index == self._base:
            return self._base_term
        if index <= 0:
            return 0
        return self._log[index - self._base - 1][0]

    def _last_term_locked(self) -> int:
        return self._term_at_locked(self._last_index_locked())

    def _apply_locked(self, index: int,
                      entry: Tuple[int, int, bytes, bytes]) -> None:
        _term, op, key, val = entry
        if op == _SET:
            self._kv[key] = val
        elif op == _DELETE:
            self._kv.pop(key, None)
        elif op == _ADD:
            (delta,) = struct.unpack("<q", val[:8])
            seq = struct.unpack("!q", val[8:16])[0] if len(val) >= 16 else -1
            cid = val[16:] if len(val) >= 16 else b""
            known = self._dedup.get(cid) if cid else None
            if known is not None and known[0] == seq:
                result = known[1]  # client retry replayed across failover
            else:
                raw = self._kv.get(key)
                cur = (struct.unpack("<q", raw)[0]
                       if raw is not None and len(raw) == 8 else 0)
                result = cur + delta
                self._kv[key] = struct.pack("<q", result)
                if cid:
                    self._dedup[cid] = (seq, result)
            if len(self._add_results) > 4096:
                self._add_results.clear()  # results are read-once by waiters
            self._add_results[index] = result
        # _NOOP: state machine untouched

    def _set_commit_locked(self, target: int) -> None:
        if target <= self._commit:
            return
        self._commit = target
        while self._applied < self._commit:
            entry = self._log[self._applied - self._base]
            self._applied += 1
            self._apply_locked(self._applied, entry)
        self._cond.notify_all()

    def _leader_advance_locked(self) -> None:
        if self._role != _LEADER:
            return
        matches = sorted(
            [self._last_index_locked()]
            + [self._match.get(p, 0) for p in self._peers], reverse=True)
        majority_ix = (len(self._peers) + 1) // 2
        m = matches[majority_ix]
        # only entries of the CURRENT term commit by counting (Raft §5.4.2);
        # earlier-term entries commit transitively via the term-opening no-op
        if (m > self._commit and m > self._base
                and self._term_at_locked(m) == self._term):
            self._set_commit_locked(m)

    def _step_down_locked(self, why: str) -> None:
        if self._role != _FOLLOWER:
            print(f"[store] replica {self._id} term {self._term}: "
                  f"{self._role} -> follower ({why})", file=sys.stderr,
                  flush=True)
            flight_event("store.step-down", replica=self._id,
                         term=self._term, why=why)
        self._role = _FOLLOWER
        self._noop_idx = None
        # a stale self-hint would bounce clients back here forever; the
        # next valid append (or a _CONFIG probe) re-learns the leader
        self._leader_id = None
        self._reset_election_locked()
        self._cond.notify_all()

    def _redirect_locked(self) -> Tuple[int, bytes]:
        lead = self._leader_id
        ep = ""
        if lead is not None and lead in self._all_endpoints:
            h, p = self._all_endpoints[lead]
            ep = f"{h}:{p}"
        blob = json.dumps({"term": self._term,
                           "leader_id": -1 if lead is None else lead,
                           "leader": ep}).encode()
        return _ST_NOT_LEADER, blob

    # -- network: serving ----------------------------------------------------

    def _accept(self):
        try:
            self._sock.settimeout(0.2)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._conn_mu:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            with conn:
                while not self._stop.is_set():
                    cmd = _recv_exact(conn, 1)[0]
                    key = _recv_bytes(conn)
                    payload = (_recv_bytes(conn)
                               if cmd in _OPS_WITH_PAYLOAD else b"")
                    status, frame, acked_write = self._dispatch(cmd, key,
                                                                payload)
                    conn.sendall(bytes([status])
                                 + struct.pack("!I", len(frame)) + frame)
                    if acked_write:
                        self._after_write_ack()
        except (ConnectionError, OSError, struct.error):
            pass
        finally:
            with self._conn_mu:
                self._conns.discard(conn)

    def _dispatch(self, cmd: int, key: bytes,
                  payload: bytes) -> Tuple[int, bytes, bool]:
        if cmd == _APPEND:
            st, fr = self._on_append(payload)
            return st, fr, False
        if cmd == _VOTE:
            st, fr = self._on_vote(payload)
            return st, fr, False
        if cmd == _CONFIG:
            return 0, self._config_blob(), False
        if cmd in (_SET, _ADD, _DELETE):
            return self._on_client_write(cmd, key, payload)
        if cmd in (_GET, _WAIT, _SNAPSHOT):
            return self._on_client_read(cmd, key, payload)
        raise ConnectionError(f"unknown store op {cmd}")

    def _config_blob(self) -> bytes:
        with self._cond:
            info = {
                "id": self._id,
                "term": self._term,
                "role": self._role,
                "leader_id": (-1 if self._leader_id is None
                              else self._leader_id),
                "leader": "",
                "commit": self._commit,
                "synced": self._synced,
                "endpoints": [f"{h}:{p}" for _, (h, p)
                              in sorted(self._all_endpoints.items())],
            }
            if self._leader_id in self._all_endpoints:
                h, p = self._all_endpoints[self._leader_id]
                info["leader"] = f"{h}:{p}"
        return json.dumps(info).encode()

    # -- client ops ----------------------------------------------------------

    def _on_client_write(self, op: int, key: bytes,
                         payload: bytes) -> Tuple[int, bytes, bool]:
        value = payload if op in (_SET, _ADD) else b""
        with self._cond:
            if self._role != _LEADER or not self._synced:
                st, fr = self._redirect_locked()
                return st, fr, False
            self._log.append((self._term, op, key, value))
            idx = self._last_index_locked()
            term0 = self._term
            self._leader_advance_locked()  # single-replica degenerate case
        for ev in self._send_ev.values():
            ev.set()
        deadline = self._now() + self._cfg.op_timeout
        with self._cond:
            while self._applied < idx:
                if self._stop.is_set():
                    return _ST_RETRY, b"", False
                if self._term != term0 or self._role != _LEADER:
                    # the entry MAY still commit under the new leader; the
                    # client retries (sets are idempotent, adds deduped)
                    st, fr = self._redirect_locked()
                    return st, fr, False
                if self._now() >= deadline:
                    return _ST_RETRY, b"", False  # no quorum within budget
                self._cond.wait(min(0.05, max(0.005, self._cfg.heartbeat)))
            # applied >= idx alone does not prove OUR entry committed: a new
            # leader may have truncated the conflicting tail (replacing the
            # entry at idx) and advanced commit past idx while this waiter
            # slept, all before the term/role check above ever re-ran.  Ack
            # only if the committed entry at the proposed index still carries
            # the proposal term (Raft's standard client-ack rule).  idx below
            # the snapshot base means this node was deposed and caught up in
            # the meantime, so the entry's term is unknowable — redirect.
            if idx <= self._base or self._term_at_locked(idx) != term0:
                st, fr = self._redirect_locked()
                return st, fr, False
            if op == _ADD:
                result = self._add_results.pop(idx, None)
                if result is None:  # replay of a deduped add: read the table
                    cid = value[16:] if len(value) >= 16 else b""
                    known = self._dedup.get(cid)
                    result = known[1] if known else 0
                return 0, struct.pack("<q", result), True
        return 0, b"", True

    def _after_write_ack(self) -> None:
        with self._cond:
            self.writes_acked += 1
            n = self.writes_acked
        inj = get_injector()
        if inj is not None and inj.store_kill_due(n):
            print(f"[inject] store leader {self._id} dying after "
                  f"{n} acked writes", file=sys.stderr, flush=True)
            flight_event("store.leader-kill", replica=self._id,
                         term=self._term, writes_acked=n)
            self.kill()
            dump_flight("store-leader-kill",
                        victim=f"replica {self._id}", writes_acked=n)

    def _read_gate_locked(self) -> Optional[int]:
        """None when linearizable reads are serveable, else the status to
        return: redirect off a non-leader, retry on a leader that holds no
        lease yet or has not committed an entry in its own term."""
        if self._role != _LEADER or not self._synced:
            return _ST_NOT_LEADER
        if not self._lease_ok_locked():
            return _ST_RETRY
        if self._noop_idx is None or self._commit < self._noop_idx:
            return _ST_RETRY
        return None

    def _on_client_read(self, cmd: int, key: bytes,
                        payload: bytes) -> Tuple[int, bytes, bool]:
        with self._cond:
            gate = self._read_gate_locked()
            if gate == _ST_NOT_LEADER:
                st, fr = self._redirect_locked()
                return st, fr, False
            if gate is not None:
                return gate, b"", False
            if cmd == _GET:
                val = self._kv.get(key)
                if val is None:
                    return 1, b"", False
                return 0, val, False
            if cmd == _SNAPSHOT:
                extra = struct.pack(
                    "!qq", self._applied,
                    self._term_at_locked(self._applied))
                extra += _encode_dedup(self._dedup)
                return 0, _encode_kv(dict(self._kv), extra), False
            # _WAIT: park while this replica remains the lease-holding
            # leader; abort with redirect/retry the moment it is not, so
            # the client re-parks on the new leader instead of going blind
            (timeout_ms,) = struct.unpack("<I", payload)
            deadline = self._now() + timeout_ms / 1000.0
            while key not in self._kv and not self._stop.is_set():
                gate = self._read_gate_locked()
                if gate == _ST_NOT_LEADER:
                    st, fr = self._redirect_locked()
                    return st, fr, False
                if gate is not None:
                    return gate, b"", False
                if self._now() >= deadline:
                    break
                self._cond.wait(min(0.05, max(0.005, self._cfg.heartbeat)))
            return (0 if key in self._kv else 1), b"", False

    # -- consensus ops -------------------------------------------------------

    def _on_append(self, payload: bytes) -> Tuple[int, bytes]:
        term, lid, prev_idx, prev_term, lcommit = struct.unpack(
            "!qqqqq", payload[:40])
        (n_entries,) = struct.unpack("!I", payload[40:44])
        off = 44
        entries: List[Tuple[int, int, bytes, bytes]] = []
        for _ in range(n_entries):
            eterm, eop = struct.unpack("!qB", payload[off:off + 9])
            off += 9
            (kl,) = struct.unpack("!I", payload[off:off + 4])
            off += 4
            k = payload[off:off + kl]
            off += kl
            (vl,) = struct.unpack("!I", payload[off:off + 4])
            off += 4
            v = payload[off:off + vl]
            off += vl
            entries.append((eterm, eop, k, v))
        with self._cond:
            if term < self._term:
                return 1, struct.pack("!qq", self._term, -1)
            if term > self._term:
                self._term = term
                self._voted_for = None
            if self._role != _FOLLOWER:
                self._step_down_locked(f"append from leader {lid}")
            self._leader_id = lid
            self._heard = self._now()
            self._reset_election_locked()
            if not self._synced:
                # mid-catch-up: snapshot pull in flight, no log to match
                return 1, struct.pack("!qq", self._term, -1)
            last = self._last_index_locked()
            if prev_idx > last:
                return 1, struct.pack("!qq", self._term, last)
            if prev_idx < self._base:
                # the installed snapshot already covers a prefix of this
                # batch (committed state can never conflict) — skip it
                skip = self._base - prev_idx
                if skip >= len(entries):
                    return 0, struct.pack("!qq", self._term,
                                          max(self._base,
                                              prev_idx + len(entries)))
                entries = entries[skip:]
                prev_idx = self._base
            elif (prev_idx > self._base
                  and self._term_at_locked(prev_idx) != prev_term):
                # log-matching violated at prev: drop the conflicting tail
                del self._log[prev_idx - self._base - 1:]
                return 1, struct.pack("!qq", self._term,
                                      max(self._base, prev_idx - 1))
            idx = prev_idx
            for entry in entries:
                idx += 1
                if idx <= self._last_index_locked():
                    if self._term_at_locked(idx) != entry[0]:
                        # a divergent unacked tail (e.g. a healed minority
                        # leader's uncommitted writes) is discarded here
                        del self._log[idx - self._base - 1:]
                        self._log.append(entry)
                else:
                    self._log.append(entry)
            match = prev_idx + len(entries)
            if lcommit > self._commit:
                self._set_commit_locked(min(lcommit,
                                            self._last_index_locked()))
            self._cond.notify_all()
            return 0, struct.pack("!qq", self._term, match)

    def _on_vote(self, payload: bytes) -> Tuple[int, bytes]:
        term, cand, lli, llt, prevote = struct.unpack("!qqqqB", payload)
        with self._cond:
            if not self._synced:
                # catching up: this replica's log is not a valid yardstick
                return 1, struct.pack("!q", self._term)
            up_to_date = (llt, lli) >= (self._last_term_locked(),
                                        self._last_index_locked())
            if prevote:
                # probe round, no state change: deny while we recently
                # heard a live leader (stickiness — a healed minority
                # replica cannot disrupt a working term), or while we ARE
                # the leader
                fresh = (self._heard is not None
                         and self._now() - self._heard
                         < self._cfg.election_timeout)
                grant = (term >= self._term and up_to_date
                         and not fresh and self._role != _LEADER)
                return (0 if grant else 1), struct.pack("!q", self._term)
            if term < self._term:
                return 1, struct.pack("!q", self._term)
            if term > self._term:
                self._term = term
                self._voted_for = None
                if self._role != _FOLLOWER:
                    self._step_down_locked(f"vote request term {term}")
            grant = self._voted_for in (None, cand) and up_to_date
            if grant:
                self._voted_for = cand
                self._reset_election_locked()
            return (0 if grant else 1), struct.pack("!q", self._term)

    # -- peer RPC ------------------------------------------------------------

    def _peer_call(self, rid: int, cmd: int, payload: Optional[bytes],
                   timeout: float):
        inj = get_injector()
        if inj is not None and inj.store_link_blocked(self._id, rid):
            raise ConnectionError(
                f"[inject] store link {self._id}<->{rid} partitioned")
        return _raw_call(self._peers[rid], cmd, b"", payload, timeout)

    def _rpc_timeout(self) -> float:
        return max(0.1, min(1.0, 4.0 * self._cfg.heartbeat))

    # -- leader: replication senders -----------------------------------------

    def _sender(self, rid: int):
        ev = self._send_ev[rid]
        while not self._stop.is_set():
            ev.wait(timeout=self._cfg.heartbeat)
            ev.clear()
            with self._cond:
                if self._role != _LEADER or self._stop.is_set():
                    continue
                ni = self._next.get(rid, self._last_index_locked() + 1)
                if ni <= self._base:
                    # the peer is behind our snapshot horizon; it pulls a
                    # snapshot itself in its catch-up loop — skip until then
                    continue
                prev = ni - 1
                prev_term = self._term_at_locked(prev)
                entries = self._log[ni - self._base - 1:]
                if len(entries) > 256:
                    entries = entries[:256]
                parts = [struct.pack("!qqqqq", self._term, self._id, prev,
                                     prev_term, self._commit),
                         struct.pack("!I", len(entries))]
                for eterm, eop, k, v in entries:
                    parts.append(struct.pack("!qB", eterm, eop))
                    parts.append(struct.pack("!I", len(k)) + k)
                    parts.append(struct.pack("!I", len(v)) + v)
                payload = b"".join(parts)
                term0 = self._term
            # lease time must be measured from BEFORE the RPC: the follower's
            # no-election promise starts when it processes the append, which
            # is at most t0 + rtt; stamping the response-receipt time would
            # stretch the lease by up to a full round-trip past what the
            # quorum actually promised.
            t0 = self._now()
            try:
                st, val = self._peer_call(rid, _APPEND, payload,
                                          self._rpc_timeout())
                rterm, aux = struct.unpack("!qq", val)
            except (OSError, ConnectionError, struct.error):
                continue  # dead/partitioned peer: no ack recorded
            with self._cond:
                if rterm > self._term:
                    self._term = rterm
                    self._voted_for = None
                    if self._role != _FOLLOWER:
                        self._step_down_locked(f"peer {rid} on term {rterm}")
                    continue
                if self._role != _LEADER or self._term != term0:
                    continue
                if t0 > self._ack.get(rid, float("-inf")):
                    self._ack[rid] = t0  # term-confirming contact (RPC start)
                if st == 0:
                    if aux > self._match.get(rid, 0):
                        self._match[rid] = aux
                    self._next[rid] = aux + 1
                    self._leader_advance_locked()
                    if self._match[rid] < self._last_index_locked():
                        ev.set()  # more log to ship, don't wait a beat
                elif aux >= 0:
                    # consistency backtrack, guided by the follower's hint
                    self._next[rid] = max(self._base + 1,
                                          min(aux + 1, max(1, ni - 1)))
                    ev.set()
                # aux < 0: peer is recovering (pulls a snapshot); hold next

    # -- follower: elections + catch-up --------------------------------------

    def _tick_loop(self):
        while not self._stop.is_set():
            with self._cond:
                role = self._role
                synced = self._synced
            if not synced:
                self._try_catch_up()
            elif role == _LEADER:
                with self._cond:
                    if (self._role == _LEADER
                            and not self._lease_ok_locked()
                            and self._now() > self._lease_grace):
                        self._step_down_locked("lease expired (no quorum)")
            else:
                due = False
                with self._cond:
                    due = (self._synced and self._role != _LEADER
                           and self._now() >= self._election_deadline)
                if due:
                    self._run_election()
            self._stop.wait(max(0.01, self._cfg.heartbeat / 2.0))

    def _run_election(self):
        with self._cond:
            if not self._synced or self._role == _LEADER:
                return
            term0 = self._term
            proposed = term0 + 1
            lli = self._last_index_locked()
            llt = self._last_term_locked()
            started = self._now()
        peers = list(self._peers)
        majority = (len(peers) + 1) // 2 + 1
        ballot = struct.pack("!qqqqB", proposed, self._id, lli, llt, 1)
        grants = 1
        for rid in peers:
            try:
                st, val = self._peer_call(rid, _VOTE, ballot,
                                          self._rpc_timeout())
            except (OSError, ConnectionError, struct.error):
                continue
            if st == 0:
                grants += 1
            else:
                (rt,) = struct.unpack("!q", val)
                with self._cond:
                    if rt > self._term:
                        self._term = rt
                        self._voted_for = None
        if grants < majority:
            # prevote failed: a quorum is unreachable or follows a live
            # leader — do NOT bump the term (a healed minority replica
            # rejoins without disrupting the cluster)
            with self._cond:
                self._reset_election_locked()
            return
        with self._cond:
            if (self._term != term0 or self._role == _LEADER
                    or (self._heard is not None and self._heard >= started)):
                return  # the world moved on during the prevote round
            self._term = proposed
            self._voted_for = self._id
            self._role = _CANDIDATE
        ballot = struct.pack("!qqqqB", proposed, self._id, lli, llt, 0)
        votes = 1
        voters = []
        for rid in peers:
            try:
                st, val = self._peer_call(rid, _VOTE, ballot,
                                          self._rpc_timeout())
            except (OSError, ConnectionError, struct.error):
                continue
            if st == 0:
                votes += 1
                voters.append(rid)
            else:
                (rt,) = struct.unpack("!q", val)
                with self._cond:
                    if rt > self._term:
                        self._term = rt
                        self._voted_for = None
                        if self._role == _CANDIDATE:
                            self._step_down_locked(f"outvoted on term {rt}")
        with self._cond:
            if (self._term == proposed and self._role == _CANDIDATE
                    and votes >= majority):
                self._become_leader_locked(voters)
            else:
                if self._role == _CANDIDATE:
                    self._role = _FOLLOWER
                self._reset_election_locked()

    def _become_leader_locked(self, voters: List[int]) -> None:
        self._role = _LEADER
        self._leader_id = self._id
        now = self._now()
        self._ack = {rid: now for rid in voters}  # votes ARE quorum contact
        last = self._last_index_locked()
        self._next = {rid: last + 1 for rid in self._peers}
        self._match = {rid: 0 for rid in self._peers}
        # one base election timeout to earn a full lease before the lease
        # check may demote us (a fresh leader has no append acks yet)
        self._lease_grace = now + self._cfg.election_timeout
        # term-opening no-op: commits the inherited log prefix under this
        # term so lease reads observe every previously-acked write
        self._log.append((self._term, _NOOP, b"", b""))
        self._noop_idx = self._last_index_locked()
        print(f"[store] replica {self._id} elected leader for term "
              f"{self._term} (log at {self._noop_idx})", file=sys.stderr,
              flush=True)
        flight_event("store.leader-elected", replica=self._id,
                     term=self._term, log_index=self._noop_idx)
        self._cond.notify_all()
        for ev in self._send_ev.values():
            ev.set()

    def _try_catch_up(self):
        """Restarted-replica path: pull the leader's snapshot (kv + applied
        index/term + dedup table over the `_SNAPSHOT` op), install it as
        the log base, then let normal appends deliver the tail.  Until
        synced this replica neither votes nor stands."""
        leader_rid: Optional[int] = None
        leader_term = 0
        for rid in self._peers:
            try:
                st, val = self._peer_call(rid, _CONFIG, b"",
                                          self._rpc_timeout())
            except (OSError, ConnectionError, struct.error, ValueError):
                continue
            info = json.loads(val.decode())
            if info.get("leader_id", -1) >= 0 and info["leader_id"] != self._id:
                leader_rid = info["leader_id"]
                leader_term = int(info.get("term", 0))
                if info.get("role") == _LEADER:
                    break  # talking to the leader itself: best source
        if leader_rid is None or leader_rid not in self._peers:
            return  # no leader visible yet; retry next tick
        try:
            st, blob = self._peer_call(leader_rid, _SNAPSHOT, None,
                                       max(2.0, self._rpc_timeout()))
        except (OSError, ConnectionError, struct.error):
            return
        if st != 0:
            return  # leader lacks its lease right now; retry next tick
        kv, extra = _decode_kv(blob)
        base_idx, base_term = struct.unpack("!qq", extra[:16])
        dedup = _decode_dedup(extra[16:])
        with self._cond:
            self._kv = kv
            self._dedup = dedup
            self._log = []
            self._base = base_idx
            self._base_term = base_term
            self._commit = base_idx
            self._applied = base_idx
            self._term = max(self._term, leader_term)
            self._role = _FOLLOWER
            self._voted_for = None
            self._leader_id = leader_rid
            self._synced = True
            self._reset_election_locked()
            self._cond.notify_all()
        print(f"[store] replica {self._id} caught up from leader "
              f"{leader_rid}: snapshot at index {base_idx} "
              f"(term {base_term}), awaiting log tail", file=sys.stderr,
              flush=True)
        flight_event("store.catch-up", replica=self._id,
                     leader=leader_rid, index=base_idx)


class ReplicaGroup:
    """N in-process :class:`ReplicaServer` s forming one replicated store.

    Binds every replica's socket before starting any thread so a taken
    well-known port raises ``OSError`` synchronously (the rendezvous
    host-or-join probe depends on that).  With an explicit base ``port``
    the replicas bind ``port .. port+n-1`` so remote clients can derive
    the endpoint list from the master address alone; with ``port=0``
    they are ephemeral and discovery goes through ``ENDPOINTS_ENV`` /
    the ``_CONFIG`` op.
    """

    def __init__(self, n: int, host: str = "127.0.0.1", port: int = 0,
                 cfg: Optional[StoreConsensusConfig] = None, seed: int = 0,
                 clock=None, export_env: bool = False):
        if int(n) < 2:
            raise ValueError(f"ReplicaGroup needs >= 2 replicas, got {n}")
        self._cfg = cfg if cfg is not None else store_consensus_config()
        self._seed = int(seed)
        self._clock = clock
        self._host = host
        self.replicas: List[ReplicaServer] = []
        try:
            for rid in range(int(n)):
                p = (int(port) + rid) if int(port) else 0
                self.replicas.append(ReplicaServer(
                    rid, host=host, port=p, cfg=self._cfg, seed=self._seed,
                    clock=clock))
        except OSError:
            for srv in self.replicas:
                srv.stop()
            raise
        endpoints = {srv._id: srv.endpoint for srv in self.replicas}
        for srv in self.replicas:
            srv.configure(endpoints)
            srv.start()
        self.endpoints: List[Tuple[str, int]] = [srv.endpoint
                                                 for srv in self.replicas]
        self._env_exported = False
        if export_env:
            os.environ[ENDPOINTS_ENV] = ",".join(
                f"{h}:{p}" for h, p in self.endpoints)
            self._env_exported = True

    @property
    def port(self) -> int:
        return self.endpoints[0][1]

    def server(self, rid: int) -> ReplicaServer:
        return self.replicas[rid]

    def leader_id(self, timeout: float = 10.0,
                  exclude: Tuple[int, ...] = ()) -> int:
        """Wait for a live leader that holds its lease (reads serveable)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for srv in self.replicas:
                if not srv.alive or srv._id in exclude:
                    continue
                with srv._cond:
                    if (srv._role == _LEADER and srv._synced
                            and srv._read_gate_locked() is None):
                        return srv._id
            time.sleep(0.01)
        raise TimeoutError(
            f"no replicated-store leader within {timeout:.1f}s "
            f"(roles: {[srv._role for srv in self.replicas]})")

    def kill(self, rid: int) -> None:
        self.replicas[rid].kill()

    def restart(self, rid: int) -> ReplicaServer:
        """Bring a killed replica back (same id, same port) in recovery
        mode: it catches up from the leader before it may vote."""
        old = self.replicas[rid]
        if old.alive:
            old.stop()
        srv = ReplicaServer(rid, host=self._host, port=old.port,
                            cfg=self._cfg, seed=self._seed + 1,
                            clock=self._clock, recover=True)
        endpoints = {s._id: s.endpoint for s in self.replicas}
        endpoints[rid] = srv.endpoint
        srv.configure(endpoints)
        srv.start()
        self.replicas[rid] = srv
        return srv

    def num_keys(self) -> int:
        best = 0
        for srv in self.replicas:
            if srv.alive:
                best = max(best, srv.num_keys())
        return best

    def stop(self) -> None:
        for srv in self.replicas:
            srv.stop()
        if self._env_exported:
            os.environ.pop(ENDPOINTS_ENV, None)
            self._env_exported = False


class ReplicatedClient:
    """`_PyClient`-surface client for a replica group: follows NotLeader
    redirects, rotates endpoints while electing, and stamps every ``add``
    with (client id, sequence) so a retry across leader failover is
    exactly-once.  Deliberately has NO ``set_failover`` — redirects
    subsume the warm-standby re-point, so ``TCPStore.enable_failover``
    reports False on a replicated store."""

    def __init__(self, endpoints: List[Tuple[str, int]], timeout: float):
        if not endpoints:
            raise ValueError("ReplicatedClient needs at least one endpoint")
        self._eps: List[Tuple[str, int]] = [(h, int(p)) for h, p in endpoints]
        self._timeout = float(timeout)
        self._mu = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._sock_ep: Optional[Tuple[str, int]] = None
        self._lead = 0
        self._cid = os.urandom(8).hex().encode()
        self._seq = 0
        self._refresh_deadline = 0.0

    # -- plumbing ------------------------------------------------------------

    def _drop_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._sock_ep = None

    def _note_leader(self, endpoint_str: str) -> bool:
        """Re-point at a redirect hint; learns endpoints we did not know
        (ephemeral-port replicas discovered at runtime)."""
        host, _, port = endpoint_str.rpartition(":")
        if not host or not port.isdigit():
            return False
        ep = (host, int(port))
        if ep not in self._eps:
            self._eps.append(ep)
        self._lead = self._eps.index(ep)
        return True

    def _refresh_endpoints(self):
        """Merge the membership list from any reachable replica (used when
        a full rotation failed — e.g. the one seed endpoint is dead)."""
        for ep in list(self._eps):
            try:
                st, val = _raw_call(ep, _CONFIG, b"", b"", 0.5)
                info = json.loads(val.decode())
            except (OSError, ConnectionError, struct.error, ValueError):
                continue
            for tok in info.get("endpoints", []):
                host, _, port = tok.rpartition(":")
                if host and port.isdigit() and (host, int(port)) not in self._eps:
                    self._eps.append((host, int(port)))
            if info.get("leader"):
                self._note_leader(info["leader"])
            return

    def _op(self, cmd: int, key: bytes, payload: Optional[bytes],
            limit: float, op_name: str):
        deadline = time.monotonic() + limit
        backoff = 0.02
        misses = 0
        retries_here = 0
        with self._mu:
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"TCPStore {op_name}({key!r}): no replicated-store "
                        f"leader acked within {limit:.1f}s "
                        f"({len(self._eps)} endpoints tried)")
                ep = self._eps[self._lead % len(self._eps)]
                try:
                    if self._sock is None or self._sock_ep != ep:
                        self._drop_sock()
                        self._sock = socket.create_connection(
                            ep, timeout=min(2.0, max(0.05, left)))
                        self._sock.setsockopt(socket.IPPROTO_TCP,
                                              socket.TCP_NODELAY, 1)
                        self._sock_ep = ep
                    # _WAIT parks server-side: the socket deadline must
                    # outlive the requested park
                    park = (struct.unpack("<I", payload)[0] / 1000.0
                            if cmd == _WAIT and payload else 0.0)
                    self._sock.settimeout(max(0.05, left) + park + 2.0)
                    msg = bytes([cmd]) + struct.pack("!I", len(key)) + key
                    if payload is not None:
                        msg += struct.pack("!I", len(payload)) + payload
                    self._sock.sendall(msg)
                    status = _recv_exact(self._sock, 1)[0]
                    val = _recv_bytes(self._sock)
                except (ConnectionError, OSError, struct.error):
                    self._drop_sock()
                    self._lead = (self._lead + 1) % max(1, len(self._eps))
                    misses += 1
                    if misses % max(1, len(self._eps)) == 0:
                        self._refresh_endpoints()
                    time.sleep(min(backoff,
                                   max(0.0, deadline - time.monotonic())))
                    backoff = min(backoff * 2.0, 0.25)
                    continue
                if status == _ST_NOT_LEADER:
                    self._drop_sock()
                    pointed = False
                    try:
                        hint = json.loads(val.decode())
                        if hint.get("leader"):
                            pointed = self._note_leader(hint["leader"])
                    except ValueError:
                        pass
                    # a hint back to the endpoint we just asked is stale
                    if pointed and self._eps[self._lead] == ep:
                        pointed = False
                    if not pointed:  # election in progress: rotate + wait
                        self._lead = (self._lead + 1) % max(1, len(self._eps))
                        time.sleep(min(backoff,
                                       max(0.0,
                                           deadline - time.monotonic())))
                        backoff = min(backoff * 2.0, 0.25)
                    retries_here = 0
                    continue
                if status == _ST_RETRY:
                    # the leader itself says "not yet" (no lease / no
                    # quorum).  Usually transient — but a PARTITIONED
                    # leader answers this until its lease lapses, so after
                    # a couple of strikes rotate away (a healthy leader's
                    # followers just redirect us straight back)
                    retries_here += 1
                    if retries_here >= 2:
                        retries_here = 0
                        self._drop_sock()
                        self._lead = (self._lead + 1) % max(1, len(self._eps))
                    time.sleep(min(0.03,
                                   max(0.0, deadline - time.monotonic())))
                    continue
                retries_here = 0
                return status, val

    # -- _PyClient surface ---------------------------------------------------

    def set(self, key: bytes, val: bytes,
            op_timeout: Optional[float] = None):
        limit = op_timeout if op_timeout is not None else self._timeout
        status, _ = self._op(_SET, key, val, limit, "set")
        if status != 0:
            raise RuntimeError("store set failed")

    def get(self, key: bytes,
            op_timeout: Optional[float] = None) -> Optional[bytes]:
        limit = op_timeout if op_timeout is not None else self._timeout
        status, val = self._op(_GET, key, None, limit, "get")
        return val if status == 0 else None

    def add(self, key: bytes, delta: int,
            op_timeout: Optional[float] = None) -> int:
        limit = op_timeout if op_timeout is not None else self._timeout
        with self._mu:
            self._seq += 1
            seq = self._seq
        payload = (struct.pack("<q", delta) + struct.pack("!q", seq)
                   + self._cid)
        status, val = self._op(_ADD, key, payload, limit, "add")
        if status != 0:
            raise RuntimeError("store add failed")
        return struct.unpack("<q", val)[0]

    def wait_key(self, key: bytes, timeout_ms: int) -> bool:
        deadline = time.monotonic() + timeout_ms / 1000.0
        while True:
            left_ms = int((deadline - time.monotonic()) * 1000)
            if left_ms <= 0:
                return False
            # park in bounded slices so a leader change mid-wait re-parks
            # on the new leader promptly
            chunk = min(left_ms, 1000)
            try:
                status, _ = self._op(_WAIT, key, struct.pack("<I", chunk),
                                     chunk / 1000.0 + 3.0, "wait")
            except TimeoutError:
                continue  # slice budget burnt electing; loop re-checks
            if status == 0:
                return True

    def delete(self, key: bytes):
        self._op(_DELETE, key, None, self._timeout, "delete")

    def snapshot(self, op_timeout: Optional[float] = None) -> Dict[bytes, bytes]:
        limit = op_timeout if op_timeout is not None else self._timeout
        status, val = self._op(_SNAPSHOT, b"", None, limit, "snapshot")
        if status != 0:
            raise RuntimeError("store snapshot failed")
        kv, _extra = _decode_kv(val)
        return kv

    def close(self):
        with self._mu:
            self._drop_sock()


def attach_replicated(tcp: TCPStore, host: str, port: int, *,
                      world_size: int, is_master: bool, timeout: float,
                      replicas: int,
                      endpoints: Optional[List[Tuple[str, int]]]) -> None:
    """Finish a ``TCPStore.__init__`` in replicated mode (called from
    store.py when ``replicas >= 2`` or the construction's ``host:port``
    appears in ``PADDLE_STORE_ENDPOINTS``).  Masters host a
    :class:`ReplicaGroup` and export the endpoint env for child
    processes; clients get a :class:`ReplicatedClient` over the known
    or derived (consecutive-port) endpoints."""
    tcp.is_master = bool(is_master)
    tcp.world_size = int(world_size)
    tcp.timeout = float(timeout)
    tcp.native = False
    if is_master and replicas >= 2:
        group = ReplicaGroup(replicas, host=host, port=int(port),
                             export_env=True)
        tcp._server = group
        tcp.host, tcp.port = host, group.port
        tcp._client = ReplicatedClient(group.endpoints, float(timeout))
        return
    tcp._server = None
    tcp.host, tcp.port = host, int(port)
    eps = list(endpoints) if endpoints else []
    if not eps:
        if replicas >= 2 and int(port):
            # deterministic consecutive-port layout (see ReplicaGroup)
            eps = [(host, int(port) + i) for i in range(int(replicas))]
        else:
            eps = [(host, int(port))]
    tcp._client = ReplicatedClient(eps, float(timeout))


class ReplicatedStore(TCPStore):
    """The quorum-replicated store behind the full ``TCPStore`` surface.

    Hosts an N-replica :class:`ReplicaGroup` in-process and talks to it
    through a :class:`ReplicatedClient`, so every ``TCPStore`` method —
    ``set``/``get``/``add``/``wait``/``barrier``/``num_keys`` — works
    unchanged, and so do rendezvous, the failure detector, checkpoint
    commit barriers, and the serving router built on them.

    >>> rs = ReplicatedStore(replicas=3)
    >>> rs.set("k", b"v"); rs.get("k")
    b'v'
    """

    def __init__(self, replicas: int = 3, host: str = "127.0.0.1",
                 port: int = 0, world_size: int = 1, timeout: float = 60.0,
                 interval: Optional[float] = None,
                 ttl: Optional[float] = None, seed: int = 0,
                 export_env: bool = False):
        cfg = store_consensus_config(interval, ttl)
        self.is_master = True
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.native = False
        self._server = ReplicaGroup(int(replicas), host=host, port=int(port),
                                    cfg=cfg, seed=int(seed),
                                    export_env=export_env)
        self.host, self.port = host, self._server.port
        self._client = ReplicatedClient(self._server.endpoints,
                                        float(timeout))

    @property
    def group(self) -> ReplicaGroup:
        return self._server

    def leader_id(self, timeout: float = 10.0) -> int:
        return self._server.leader_id(timeout=timeout)

    def kill_replica(self, rid: int) -> None:
        self._server.kill(rid)

    def restart_replica(self, rid: int) -> ReplicaServer:
        return self._server.restart(rid)
