"""Fault tolerance of the input pipeline, the counterpart of the parts of
``raft_tpu/resilience.py`` that the loaders use (framework-free; the
loaders' worker processes import it, so it imports no torch):

* ``retry_with_backoff``: exponential-backoff retries of a transient I/O
  failure (a sample read);
* ``StallWatchdog``: a timer that prints a diagnostic when the loader's
  prefetch pump stops producing batches (a hung mount, a wedged worker)
  instead of the run wedging silently;
* ``ResilienceStats``: the loader's degradation counters
  (``substituted_samples``, ``sample_retries``, ``worker_timeouts``),
  which its state carries and ``train`` streams to its logger;
* ``FaultInjector``, ``active_injector``, ``set_injector``: deterministic
  fault injection so that the recovery paths are testable on the CPU.
  With no ``RAFT_FAULT_CORRUPT_SAMPLES`` in the environment the injector is
  inert.

The JAX module's cross-host vote and its checkpoint, serving and worker
faults belong to parts of the package not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, FrozenSet, Optional, Tuple


def retry_with_backoff(fn: Callable, *, retries: int = 3,
                       base_delay: float = 0.5, max_delay: float = 8.0,
                       retry_on: Tuple[type, ...] = (OSError,),
                       describe: str = "operation",
                       on_retry: Optional[Callable] = None):
    """Run ``fn()``, retrying transient failures with exponential backoff.

    Attempts ``retries + 1`` times in all; sleeps ``base_delay * 2**k``
    (capped at ``max_delay``) between attempts. Exceptions outside
    ``retry_on`` propagate at once; the last retryable failure is raised
    again once the budget is spent. ``on_retry(attempt, exc)`` is called
    before each sleep, after a printed warning.
    """
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            if attempt == retries:
                raise
            delay = min(base_delay * (2 ** attempt), max_delay)
            print(f"WARNING: {describe} failed "
                  f"(attempt {attempt + 1}/{retries + 1}): {e}; "
                  f"retrying in {delay:.2f}s", flush=True)
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(delay)


class StallWatchdog:
    """Prints a diagnostic when a producer loop stops making progress.

    The owner calls ``pet`` on every unit of progress (one batch yielded);
    if ``timeout`` seconds pass with no pet, ``describe()`` goes to
    ``sink`` once per stall (the timer re-arms at the next pet). It never
    stops the run.
    """

    def __init__(self, timeout: float,
                 describe: Callable[[], str],
                 sink: Callable[[str], None] = None):
        self.timeout = timeout
        self.describe = describe
        self.sink = sink if sink is not None else \
            (lambda msg: print(msg, flush=True))
        self.fired = 0
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None
        self._closed = False

    def _fire(self):
        with self._lock:
            self.fired += 1
        try:
            self.sink(f"WARNING: loader stalled for >{self.timeout:.0f}s: "
                      f"{self.describe()}")
        except Exception as e:   # a broken describe() must not kill the timer
            self.sink(f"WARNING: loader stalled for >{self.timeout:.0f}s "
                      f"(diagnostic unavailable: {e})")

    def pet(self):
        """Record progress: cancel the pending alarm and arm a new one. A
        no-op after ``close``, so that a late pet from a draining producer
        leaves no timer behind."""
        with self._lock:
            if self._closed:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.timeout, self._fire)
            self._timer.daemon = True    # never keeps the interpreter alive
            self._timer.start()

    def close(self):
        """Tear the watchdog down; idempotent."""
        with self._lock:
            self._closed = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None


class ResilienceStats:
    """Thread-safe degradation counters of a loader:
    ``substituted_samples`` (unreadable samples replaced by a deterministic
    neighbour), ``sample_retries`` (transient read errors that succeeded
    on a retry) and ``worker_timeouts`` (worker drains that hit their
    deadline)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.substituted_samples = 0
        self.sample_retries = 0
        self.worker_timeouts = 0

    def count_substitution(self, n: int = 1):
        with self._lock:
            self.substituted_samples += n

    def count_sample_retries(self, n: int = 1):
        with self._lock:
            self.sample_retries += n

    def count_worker_timeout(self, n: int = 1):
        with self._lock:
            self.worker_timeouts += n


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection for the loaders' recovery paths.

    Inert by default; active when constructed with faults (tests) or from
    the environment: ``RAFT_FAULT_CORRUPT_SAMPLES=3,17`` makes dataset reads
    of these indices raise ``OSError`` (retry, then substitution), as in
    the JAX package.
    """

    corrupt_sample_indices: FrozenSet[int] = frozenset()

    @staticmethod
    def from_env() -> "FaultInjector":
        raw = os.environ.get("RAFT_FAULT_CORRUPT_SAMPLES", "").strip()
        return FaultInjector(corrupt_sample_indices=frozenset(
            int(x) for x in raw.split(",") if x.strip()))

    def maybe_fail_sample(self, index: int):
        """Called before each dataset read; deterministic by index, so a
        corrupt sample stays corrupt across retries (forcing the
        substitution) while its neighbours stay readable."""
        if int(index) in self.corrupt_sample_indices:
            raise OSError(f"injected corrupt sample at index {index}")


_ACTIVE: Optional[FaultInjector] = None


def active_injector() -> FaultInjector:
    """The process-wide injector: built from the environment on first use,
    or whatever ``set_injector`` installed."""
    global _ACTIVE
    if _ACTIVE is None:
        _ACTIVE = FaultInjector.from_env()
    return _ACTIVE


def set_injector(inj: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install ``inj`` as the process-wide injector (``None``: built from
    the environment again on next use). Returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = inj
    return prev
