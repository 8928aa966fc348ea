"""Multi-host launcher CLI: ``python -m paddle_tpu_torch.distributed.launch``
(port of ``paddle_tpu/distributed/launch``).

Counterpart of the reference's ``python/paddle/distributed/launch``
(``main.py``, controllers, HTTP/etcd masters) and the elastic manager
(``fleet/elastic/manager.py:125``).

As in the JAX package:

- ONE process per host; ``--nproc_per_node > 1`` is CPU simulation only
  (a process per GPU is not a feature of this launcher);
- the launcher wires the job into the child's environment
  (``PADDLE_TPU_COORDINATOR`` / ``PADDLE_TPU_NUM_PROCESSES`` /
  ``PADDLE_TPU_PROCESS_ID``, ``PADDLE_TRAINER_ID``, ``PADDLE_LOCAL_RANK``,
  ``PADDLE_RESTART_COUNT``, ``PADDLE_SHRINK_PEERS``), the same names and
  values as the JAX launcher, so a child reads one environment whichever
  package launched it; a child hands the coordinator to
  ``torch.distributed.init_process_group`` itself;
- ``--rank -1`` assigns node ranks through the store rendezvous at
  ``--master`` (the native ``TCPStore``), and with several nodes each
  launcher heartbeats through an ``ElasticManager``;
- elastic: the child is watched and relaunched on failure/preemption up to
  ``--max_restarts`` times (reference ``ELASTIC_EXIT_CODE=101`` auto-restart
  semantics; training code resumes from its last checkpoint through
  ``fleet.CheckpointManager``); a peer node's death exits 101, or with
  ``--on_peer_failure shrink`` re-forms the job on the survivors.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["main", "launch"]

# reference fleet/elastic/__init__.py:33-34
ELASTIC_EXIT_CODE = 101
ELASTIC_AUTO_PARALLEL_EXIT_CODE = 102


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Launch a paddle_tpu_torch training program across hosts")
    p.add_argument("--master", default=None,
                   help="coordinator address host:port (default: this host:8476 on node 0)")
    p.add_argument("--nnodes", type=int, default=int(os.environ.get("PADDLE_NNODES", "1")),
                   help="number of hosts in the job")
    p.add_argument("--rank", "--node_rank", dest="rank", type=int,
                   default=int(os.environ.get("PADDLE_TRAINER_ID", "0")),
                   help="this host's index [0, nnodes); -1 = assign via "
                        "store rendezvous at --master (reference "
                        "HTTPMaster/ETCDMaster role)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes per host (1 on the card; >1 only for CPU simulation)")
    p.add_argument("--max_restarts", type=int, default=3,
                   help="elastic: relaunch a failed training process this many times")
    p.add_argument("--on_peer_failure", choices=("exit", "shrink"),
                   default="exit",
                   help="when a peer node stops heartbeating: 'exit' stops "
                        "local trainers and exits ELASTIC_EXIT_CODE for an "
                        "outer supervisor (reference behavior); 'shrink' "
                        "re-rendezvouses the SURVIVORS at the reduced node "
                        "count and relaunches trainers (graceful mesh "
                        "shrink; requires the store host to survive)")
    p.add_argument("--heartbeat_interval", type=float, default=None,
                   help="seconds between membership heartbeats (lower = "
                        "faster failure detection, more store traffic); "
                        "default: FLAGS_ft_heartbeat_interval (see "
                        "fault_tolerance.policy.heartbeat_config for the "
                        "validated bounds, FLAGS_ft_lease_ttl for the "
                        "companion lease knob)")
    p.add_argument("--store_replicas", type=int,
                   default=int(os.environ.get("PADDLE_STORE_REPLICAS", "1")),
                   help="replicate the rendezvous/control store across this "
                        "many quorum replicas (>= 2 upgrades to the "
                        "leader-leased replicated store; acked writes then "
                        "survive a store-host crash).  The master node binds "
                        "ports master_port .. master_port+N-1, so the "
                        "coordinator moves past that range; timings derive "
                        "from FLAGS_ft_heartbeat_interval/FLAGS_ft_lease_ttl "
                        "(fault_tolerance.policy.store_consensus_config)")
    p.add_argument("--log_dir", default=None, help="write per-process logs here")
    p.add_argument("--job_id", default="default", help="job name for logs")
    p.add_argument("training_script", help="the training program")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    return p


def _child_env(args, local_rank: int, coordinator: Optional[str] = None) -> dict:
    env = dict(os.environ)
    nproc = args.nproc_per_node
    world = args.nnodes * nproc
    proc_id = args.rank * nproc + local_rank
    if world > 1:
        master = coordinator or args.master or f"127.0.0.1:8476"
        env["PADDLE_TPU_COORDINATOR"] = master
        env["PADDLE_TPU_NUM_PROCESSES"] = str(world)
        env["PADDLE_TPU_PROCESS_ID"] = str(proc_id)
    # reference-compatible names, for user scripts that read them
    env["PADDLE_TRAINER_ID"] = str(proc_id)
    env["PADDLE_TRAINERS_NUM"] = str(world)
    env["PADDLE_LOCAL_RANK"] = str(local_rank)
    # after a mesh shrink: rendezvous v2 peer records (rank/host/prev_rank)
    # so CheckpointManager.resume can stream each rank's OLD shard file
    # onto the new topology (distributed.resharding)
    peers = getattr(args, "_shrink_peers", None)
    if peers is not None:
        import json

        env["PADDLE_SHRINK_PEERS"] = json.dumps(peers)
        mine = next((p for p in peers
                     if int(p.get("rank", -1)) == args.rank), None)
        if mine is not None and mine.get("prev_rank") is not None:
            env["PADDLE_PREV_RANK"] = str(mine["prev_rank"])
    return env


class _Proc:
    def __init__(self, cmd: List[str], env: dict, log_path: Optional[str],
                 tag: str, restart_base: int = 0):
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.tag = tag
        self.restarts = 0
        # restarts inherited from earlier incarnations (mesh shrinks): keeps
        # PADDLE_RESTART_COUNT monotonic across generations, so crash-once
        # fault injection (fault_tolerance.injection) never re-fires
        self.restart_base = restart_base
        self.popen: Optional[subprocess.Popen] = None
        self._log_f = None

    def start(self):
        if self.log_path:
            self._log_f = open(self.log_path, "ab")
            out = self._log_f
        else:
            out = None  # inherit
        self.env["PADDLE_RESTART_COUNT"] = str(self.restarts + self.restart_base)
        self.popen = subprocess.Popen(self.cmd, env=self.env, stdout=out, stderr=out)

    def stop(self, sig=signal.SIGTERM):
        if self.popen and self.popen.poll() is None:
            self.popen.send_signal(sig)

    def close(self):
        if self._log_f:
            self._log_f.close()
            self._log_f = None


def _run_generation(args, rdzv, coordinator, incarnation: int):
    """Run the trainers for ONE rendezvous (sub-)generation.

    Returns ``(exit_code, dead_ranks)``.  ``dead_ranks`` is non-empty when
    peer nodes stopped heartbeating — in ``--on_peer_failure shrink`` mode
    the caller then re-rendezvouses the survivors and runs the next
    sub-generation; in ``exit`` mode it exits ``ELASTIC_EXIT_CODE`` for an
    outer supervisor (reference elastic semantics).
    """
    procs: List[_Proc] = []
    elastic_mgr = None
    node_died = []
    if rdzv is not None and args.nnodes > 1:
        # heartbeat this node + watch peers over the rendezvous store
        # (reference ElasticManager: etcd registry + watch -> relaunch);
        # lease keys are scoped per (sub-)generation so stale counters from
        # a pre-shrink mesh never alias a renumbered survivor
        from ..fleet.elastic import ElasticManager

        lease_job = (args.job_id if incarnation == 0
                     else f"{args.job_id}/g{rdzv.gen}.{rdzv.subgen}")
        elastic_mgr = ElasticManager(rdzv.store, args.rank, args.nnodes,
                                     job_id=lease_job,
                                     interval=args.heartbeat_interval).start()
        import threading

        def _watch():
            dead = elastic_mgr.watch(on_dead=lambda rs: node_died.extend(rs))
            if dead:
                print(f"[launch] peer node(s) {dead} stopped heartbeating; "
                      f"stopping local trainers for re-rendezvous",
                      file=sys.stderr)
                for p in procs:
                    p.stop()

        threading.Thread(target=_watch, daemon=True,
                         name="elastic-watch").start()
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    for lr in range(args.nproc_per_node):
        cmd = [sys.executable, args.training_script] + list(args.training_script_args)
        log_path = (os.path.join(args.log_dir, f"{args.job_id}.rank{args.rank}.local{lr}.log")
                    if args.log_dir else None)
        p = _Proc(cmd, _child_env(args, lr, coordinator), log_path,
                  tag=f"rank{args.rank}.{lr}", restart_base=incarnation)
        p.start()
        procs.append(p)

    exit_code = 0
    try:
        alive = list(procs)
        while alive:
            time.sleep(0.2)
            # a dead PEER NODE needs whole-job re-rendezvous, not a local
            # restart: stop trainers and report the dead ranks upward.
            # Checked BEFORE child exit codes — a trainer that traps SIGTERM
            # and exits 0 must not read as success while the job is short
            if node_died:
                exit_code = ELASTIC_EXIT_CODE
                for p in alive:
                    p.stop()
                for p in alive:
                    try:
                        p.popen.wait(timeout=10)
                    except subprocess.TimeoutExpired:
                        p.popen.kill()
                break
            for p in list(alive):
                rc = p.popen.poll()
                if rc is None:
                    continue
                if rc == 0:
                    alive.remove(p)
                    continue
                # failure / preemption: elastic relaunch (reference
                # ElasticManager watch->relaunch loop, manager.py:125)
                if p.restarts < args.max_restarts:
                    p.restarts += 1
                    print(f"[launch] {p.tag} exited rc={rc}; restart "
                          f"{p.restarts}/{args.max_restarts}", file=sys.stderr)
                    p.start()
                else:
                    print(f"[launch] {p.tag} exited rc={rc}; restarts exhausted",
                          file=sys.stderr)
                    exit_code = rc
                    alive.remove(p)
                    for q in alive:
                        q.stop()
    except KeyboardInterrupt:
        for p in procs:
            p.stop(signal.SIGINT)
        exit_code = 130
    finally:
        for p in procs:
            if p.popen and p.popen.poll() is None:
                try:
                    p.popen.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.popen.kill()
            p.close()
        if elastic_mgr is not None:
            elastic_mgr.stop()
    return exit_code, list(node_died)


def launch(args) -> int:
    """Run the job on this host; returns the exit code."""
    rdzv = None
    coordinator = None
    coord_base = None
    n_store = max(1, int(getattr(args, "store_replicas", 1) or 1))
    if n_store >= 2:
        # children (and the rendezvous below) pick the replicated client
        # path up from the environment — zero call-site changes
        os.environ["PADDLE_STORE_REPLICAS"] = str(n_store)
    # the replicated store occupies master_port..master_port+n-1, so the
    # coordinator handed to the children binds past the replica range
    coord_off = n_store
    if args.rank < 0:
        # dynamic rank assignment over the native TCPStore (the reference's
        # launch-master role); requires --master and --nnodes
        if not args.master:
            raise SystemExit("--rank -1 (auto) needs --master host:port")
        from .rendezvous import rendezvous

        rdzv = rendezvous(args.master.replace("tcp://", ""), args.nnodes,
                          job_id=args.job_id)
        args.rank = rdzv.rank
        # the rendezvous store OWNS the --master port for the job's lifetime;
        # the children's coordinator must bind a DIFFERENT one, on the
        # machine of process 0 (= the rank-0 node by arrival order)
        host, port_s = args.master.replace("tcp://", "").rsplit(":", 1)
        coord_base = int(port_s) or rdzv.store.port
        coordinator = f"{rdzv.peers[0]['host']}:{coord_base + coord_off}"
        print(f"[launch] rendezvous assigned node rank {args.rank}/{args.nnodes}"
              f" (coordinator {coordinator})", file=sys.stderr)
    incarnation = 0
    try:
        while True:
            exit_code, dead = _run_generation(args, rdzv, coordinator,
                                              incarnation)
            can_shrink = (args.on_peer_failure == "shrink" and dead
                          and rdzv is not None
                          and all(r >= 0 for r in dead)  # STORE_LOST => no store to shrink on
                          and args.nnodes - len(set(dead)) >= 1)
            if not can_shrink:
                return exit_code
            # graceful mesh shrink: survivors re-form the job at the reduced
            # node count on the same store and resume from checkpoints
            from .rendezvous import invalidate_generation, shrink_rendezvous

            invalidate_generation(rdzv.store, rdzv.job_id, rdzv.gen, dead)
            rdzv = shrink_rendezvous(rdzv, dead)
            args.rank, args.nnodes = rdzv.rank, rdzv.nnodes
            args._shrink_peers = rdzv.peers  # exported via _child_env
            incarnation += 1
            # fresh coordinator port per incarnation: the previous
            # service (on a possibly-dead host) must not be re-joined
            coordinator = (f"{rdzv.peers[0]['host']}:"
                           f"{coord_base + coord_off + incarnation}")
            print(f"[launch] mesh shrunk to {args.nnodes} node(s); this host "
                  f"is now rank {args.rank} (gen {rdzv.gen}.{rdzv.subgen}, "
                  f"coordinator {coordinator})", file=sys.stderr)
    finally:
        if rdzv is not None:
            rdzv.store.close()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return launch(args)
