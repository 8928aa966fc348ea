"""Collective watchdog: hang detection for host-level collectives.

Counterpart of the reference's NCCL comm-task watchdog
(``phi/core/distributed/comm_task_manager.h:37``, ``comm_task.h:127``
``IsTimeout``): an async monitor that flags collectives stuck past a timeout
and surfaces WHERE each rank is waiting.

Scope: device collectives are NCCL's (its own timeout aborts a wedged
communicator).  What CAN hang at the Python level are the HOST collectives (barrier / allreduce / broadcast /
all_gather_object used by checkpointing and the launcher rendezvous) when a
peer dies: this watchdog wraps those with a timer thread that, on expiry,
dumps the stuck op + stack to stderr; with ``interrupt_main=True`` (or an
``on_timeout`` hook calling e.g. ``os.kill``) it interrupts the blocked main
thread with KeyboardInterrupt so the elastic launcher can relaunch instead of
hanging forever.  The port's host collectives come with its communication
layer; until then :func:`watch` wraps any blocking host call.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["CommWatchdog", "watch", "set_default_timeout"]

_DEFAULT_TIMEOUT: Optional[float] = None  # None = disabled


def set_default_timeout(seconds: Optional[float]):
    """Enable the watchdog for every wrapped host collective (None disables).
    The reference's ``FLAGS_enable_async_trace`` + timeout role."""
    global _DEFAULT_TIMEOUT
    _DEFAULT_TIMEOUT = seconds


class CommWatchdog:
    """Monitors one in-flight collective (reference ``CommTask``)."""

    def __init__(self, op_name: str, timeout: float,
                 on_timeout: Optional[Callable[[str], None]] = None,
                 interrupt_main: bool = False):
        self.op_name = op_name
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.interrupt_main = interrupt_main
        self.started_at = time.monotonic()
        self.timed_out = False
        self._done = threading.Event()
        self._main = threading.current_thread()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, name=f"comm-watchdog-{self.op_name}",
                                        daemon=True)
        self._thread.start()
        return self

    def _run(self):
        if self._done.wait(self.timeout):
            return
        if self._done.is_set():  # finished at ~timeout: not stuck, no report
            return
        self.timed_out = True
        elapsed = time.monotonic() - self.started_at
        frames = sys._current_frames().get(self._main.ident)
        stack = "".join(traceback.format_stack(frames)) if frames else "<no stack>"
        msg = (f"[comm-watchdog] collective '{self.op_name}' stuck for "
               f"{elapsed:.1f}s (timeout {self.timeout}s); waiting at:\n{stack}")
        print(msg, file=sys.stderr)
        if self.on_timeout is not None:
            self.on_timeout(self.op_name)
        if self.interrupt_main and not self._done.is_set():
            # last-instant recheck: an op that completed while the report was
            # printing must not take a stray KeyboardInterrupt later
            import _thread

            _thread.interrupt_main()  # KeyboardInterrupt in the blocked caller

    def done(self):
        self._done.set()


@contextlib.contextmanager
def watch(op_name: str, timeout: Optional[float] = None,
          on_timeout: Optional[Callable[[str], None]] = None,
          interrupt_main: bool = False):
    """Guard a host collective: ``with watch("barrier"): barrier_impl()``.

    No-op when neither ``timeout`` nor the default timeout is set, so the
    fast path costs one branch.
    """
    t = timeout if timeout is not None else _DEFAULT_TIMEOUT
    if t is None:
        yield None
        return
    dog = CommWatchdog(op_name, t, on_timeout, interrupt_main).start()
    try:
        yield dog
    finally:
        dog.done()
