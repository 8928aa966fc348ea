"""The port's fault tolerance (``paddle_tpu_torch.distributed.
fault_tolerance``) and collective watchdog against the JAX package's: the
injector's seeded draws, the retry schedule and the heartbeat and
consensus configurations equal the JAX package's; ``crash_point``
fail-stops a real process once; the detector flags a dead peer; the
watchdog reports a stuck op.  Heartbeat intervals are cut to 0.1 s so a
peer's death shows in about a second."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

import paddle_tpu.distributed.fault_tolerance as jft
from paddle_tpu.distributed.fault_tolerance import policy as jpolicy
from paddle_tpu.framework import flags as jflags
from paddle_tpu_torch.distributed import watchdog
from paddle_tpu_torch.distributed.fault_tolerance import (
    STORE_LOST, Deadline, FaultInjector, HeartbeatFailureDetector, RetryPolicy,
    get_injector, guard_host_collectives, heartbeat_config, retry_call, set_injector)
from paddle_tpu_torch.distributed.fault_tolerance import policy
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.framework import flags

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _no_injector():
    set_injector(None)
    yield
    set_injector(None)


# ---------------------------------------------------------------- injection

@pytest.mark.parametrize("seed,rate", [(0, 0.3), (42, 0.7)])
def test_injector_drop_draws_equal_jax(seed, rate):
    mine = FaultInjector(seed=seed, store_drop_rate=rate)
    ref = jft.FaultInjector(seed=seed, store_drop_rate=rate)
    assert [mine.should_drop() for _ in range(500)] == [ref.should_drop() for _ in range(500)]
    assert FaultInjector(seed=seed, store_delay_ms=35).delay_seconds() == \
        jft.FaultInjector(seed=seed, store_delay_ms=35).delay_seconds() == 0.035


def test_injector_flips_and_one_shot_kills_equal_jax(tmp_path):
    payload = bytes(range(256)) * 16
    flips = []
    for name, inj in (("mine", FaultInjector(seed=9)), ("ref", jft.FaultInjector(seed=9))):
        path = tmp_path / f"{name}.bin"
        path.write_bytes(payload)
        flips.append((inj.corrupt_file(str(path), nbits=8), path.read_bytes()))
    assert flips[0] == flips[1] and flips[0][1] != payload
    kw = dict(seed=1, serve_kill_round=3, serve_kill_replica=5, store_kill_leader=2,
              stage_kill_tick=4, stage_kill_stage=1, store_partition="0|1,2")
    mine, ref = FaultInjector(**kw), jft.FaultInjector(**kw)
    for inj in (mine, ref):
        inj.answers = ([inj.serve_kill_due(r, [0, 2]) for r in range(6)]
                       + [inj.stage_kill_due(t, [0, 1]) for t in range(6)]
                       + [inj.store_kill_due(n) for n in range(4)]
                       + [inj.store_link_blocked(a, b) for a in range(4) for b in range(4)])
    assert mine.answers == ref.answers
    assert mine.active() and not FaultInjector(seed=3).active()


def test_injector_from_flags_equals_jax(monkeypatch):
    names = {"ft_inject_seed": 11, "ft_inject_crash_step": 4, "ft_inject_crash_signal": 9,
             "ft_inject_store_drop_rate": 0.25, "ft_inject_corrupt_step": 2}
    old = flags.get_flags(list(names)), jflags.get_flags(list(names))
    try:
        flags.set_flags(names)
        jflags.set_flags(names)
        mine, ref = FaultInjector.from_flags(), jft.FaultInjector.from_flags()
        assert vars(mine).keys() == vars(ref).keys()
        for k, v in vars(mine).items():
            if not k.endswith("_rng"):
                assert v == getattr(ref, k), k
        assert [mine.should_drop() for _ in range(100)] == [ref.should_drop() for _ in range(100)]
    finally:
        flags.set_flags(old[0])
        jflags.set_flags(old[1])


_CRASH_CHILD = """
from paddle_tpu_torch.distributed.fault_tolerance import get_injector
for step in range(1, 6):
    get_injector().crash_point(step)
    print("STEP", step, flush=True)
"""


def test_crash_point_fail_stops_a_process_once():
    """``crash_point`` at step 3 kills the process (SIGKILL, no cleanup;
    ``os._exit(1)`` without a signal) in its first incarnation, and never
    under ``PADDLE_RESTART_COUNT=1``."""
    base = {**os.environ, "PYTHONPATH": str(REPO), "FLAGS_ft_inject_crash_step": "3"}
    base.pop("PADDLE_RESTART_COUNT", None)
    cases = {"sigkill": ({"FLAGS_ft_inject_crash_signal": "9"}, -signal.SIGKILL, 2),
             "exit": ({}, 1, 2),
             "relaunched": ({"FLAGS_ft_inject_crash_signal": "9",
                             "PADDLE_RESTART_COUNT": "1"}, 0, 5)}
    procs = {k: subprocess.Popen([sys.executable, "-c", _CRASH_CHILD], env={**base, **env},
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (env, _, _) in cases.items()}
    for k, p in procs.items():
        out, err = p.communicate(timeout=120)
        _, rc, steps = cases[k]
        assert p.returncode == rc, (k, p.returncode, err[-2000:])
        assert out.split() == [w for s in range(1, steps + 1) for w in ("STEP", str(s))], k
        if rc:
            assert "crash at step 3" in err


def test_injector_is_built_from_the_environment_once():
    assert get_injector() is None               # set_injector(None) by the fixture
    inj = FaultInjector(seed=0, crash_step=5, crash_rank=1)
    set_injector(inj)
    assert get_injector() is inj
    inj.crash_point(4, rank=1)                  # another step: no crash
    inj.crash_point(5, rank=0)                  # another rank: no crash


# ---------------------------------------------------------------- policies

@pytest.mark.parametrize("kw", [dict(seed=7), dict(max_attempts=5, base_delay=0.05, max_delay=0.4,
                                                   multiplier=2.0, jitter=0.25, seed=3),
                                dict(max_attempts=9, base_delay=0.01, jitter=0.0, seed=1)])
def test_retry_policy_schedule_equals_jax(kw):
    mine, ref = RetryPolicy(**kw), jpolicy.RetryPolicy(**kw)
    assert list(mine.delays()) == list(ref.delays()) == list(mine.delays())


def test_retry_call_recovers_then_exhausts_and_honours_its_deadline():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("boom")
        return "ok"

    assert retry_call(flaky, policy=RetryPolicy(max_attempts=5, base_delay=0.001)) == "ok"
    assert len(calls) == 3

    def always():
        raise ConnectionResetError("never")

    with pytest.raises(ConnectionResetError):
        retry_call(always, policy=RetryPolicy(max_attempts=2, base_delay=0.001))

    def slow_fail():
        time.sleep(0.05)
        raise OSError("down")

    with pytest.raises(TimeoutError, match="deadline"):
        retry_call(slow_fail, policy=RetryPolicy(max_attempts=50, base_delay=0.05),
                   deadline=Deadline.after(0.1), describe="talking to store")
    d = Deadline.after(0.2)
    assert d.clamp(10.0) <= 0.2 and not d.expired()
    assert Deadline(None).remaining() == float("inf")


@pytest.mark.parametrize("interval,ttl", [(None, None), (1.0, 4.0), (0.05, None), (0.01, None),
                                          (301.0, None), (2.0, 3.0)])
def test_heartbeat_config_and_its_errors_equal_jax(interval, ttl):
    def outcome(fn):
        try:
            return fn(interval=interval, ttl=ttl)
        except ValueError as e:
            return ("ValueError", str(e))

    mine, ref = outcome(heartbeat_config), outcome(jft.heartbeat_config)
    assert tuple(mine) == tuple(ref)
    if interval is None:
        assert mine[0] == flags.get_flag("ft_heartbeat_interval") and mine[1] == 3 * mine[0]


@pytest.mark.parametrize("kw", [dict(), dict(interval=0.05), dict(interval=0.2, ttl=1.0)])
def test_store_consensus_config_equals_jax(kw):
    assert tuple(policy.store_consensus_config(**kw)) == \
        tuple(jpolicy.store_consensus_config(**kw))


# ---------------------------------------------------------------- detector

def _stores(n, timeout=10.0):
    master = TCPStore("127.0.0.1", 0, world_size=n, is_master=True, timeout=timeout)
    return [master] + [TCPStore("127.0.0.1", master.port, world_size=n, timeout=timeout)
                       for _ in range(n - 1)]


def test_detector_flags_a_dead_peer_and_publishes_an_epoch():
    stores = _stores(3)
    try:
        dets = [HeartbeatFailureDetector(stores[r], r, 3, job_id="det", interval=0.1).start()
                for r in range(3)]
        assert dets[1].membership() == (0, [0, 1, 2])
        dets[2].stop()                           # rank 2 fail-stops
        assert dets[1].wait_epoch(above=0, timeout=15.0) >= 1
        assert dets[1].membership()[1] == [0, 1]
        assert dets[1].dead_from_epoch() == [2]
        for d in dets[:2]:
            d.stop()
    finally:
        for s in stores:
            s.close()


def test_detector_sample_dead_counts_a_stalled_peer_and_a_lost_store():
    stores = _stores(2)
    try:
        d0 = HeartbeatFailureDetector(stores[0], 0, 2, job_id="smp", interval=0.1).start()
        HeartbeatFailureDetector(stores[1], 1, 2, job_id="smp", interval=0.1).beat_once()
        time.sleep(0.3)                          # rank 1 beat once, then stalled
        probe = HeartbeatFailureDetector(stores[1], 0, 2, job_id="smp", interval=0.1)
        assert probe.sample_dead(wait_factor=2.5) == [1]
        d0.stop()
        stores[0].close()                        # the store's host dies
        assert probe.sample_dead(wait_factor=1.0, retries=1) == [STORE_LOST]
    finally:
        for s in stores[1:]:
            s.close()


# ---------------------------------------------------------------- watchdog

def test_watchdog_fast_op_reports_nothing(capsys):
    with watchdog.watch("quick", timeout=1.0) as dog:
        pass
    time.sleep(0.05)
    assert not dog.timed_out
    assert "comm-watchdog" not in capsys.readouterr().err
    with watchdog.watch("anything") as dog:      # no timeout configured: no thread
        pass
    assert dog is None


def test_watchdog_reports_a_stuck_op_and_calls_its_hook(capsys):
    hits = []
    with watchdog.watch("slow_barrier", timeout=0.1, on_timeout=hits.append) as dog:
        time.sleep(0.4)
    err = capsys.readouterr().err
    assert "collective 'slow_barrier' stuck" in err
    assert "test_torch_fault_tolerance" in err   # the waiting stack names this file
    assert hits == ["slow_barrier"] and dog.timed_out


def test_watchdog_default_timeout_and_interrupt_main(capsys):
    guard_host_collectives(0.1)
    try:
        with watchdog.watch("global_to"):
            time.sleep(0.3)
        assert "global_to" in capsys.readouterr().err
    finally:
        watchdog.set_default_timeout(None)
    with pytest.raises(KeyboardInterrupt):
        with watchdog.watch("dead_peer", timeout=0.1, interrupt_main=True):
            for _ in range(50):                  # a hung collective, polling
                time.sleep(0.1)
