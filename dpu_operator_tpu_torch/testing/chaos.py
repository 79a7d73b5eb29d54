"""Deterministic fault injection for the serving executor.

The port's copy of the serve-executor part of
``dpu_operator_tpu/testing/chaos.py``: the fault vocabulary, the scripted
:class:`FaultPlan` and :class:`ChaosExecutor`. The reference's kube,
channel, VSP and hardware wrappers are left out. With the same seed and
script a plan injects the same faults in the same order as the
reference's, so the port's scheduler and the JAX one can be run side by
side under one storm.

Faults are consumed in script order; once a key's script is exhausted,
calls pass through untouched. Random fault streams (``FaultPlan.flaky``)
are driven by ``random.Random(seed)``, so a failing chaos run replays
bit-identically from its seed.

Fault vocabulary:

- :class:`Fail` — raise BEFORE the wrapped operation runs.
- :class:`FailAfter` — run the operation, THEN raise: the work landed,
  the caller saw an error.
- :class:`Latency` — sleep, then run.
- :class:`Stall` — Latency on an INJECTED clock (no wall sleep): an
  executor hang past a deadline, bit-reproducible.
- :class:`Oom` — raise :class:`ExecutorOom` before the operation: an
  allocation-time failure whose cure is freeing blocks (the serve
  retry-with-rebuild path).

:class:`ChaosExecutor` applies the vocabulary to the serving decode path
(begin / prefill_chunk / step / spec_step), plus per-rid poisoning
(:class:`PoisonedRid`).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional


class Fault:
    """One scripted fault; ``apply`` wraps the underlying operation."""

    def apply(self, op: Callable, args: tuple, kwargs: dict):
        raise NotImplementedError


class Fail(Fault):
    """Fail *times* calls before the operation executes."""

    def __init__(self, exc: Optional[Callable[[], BaseException]] = None,
                 times: int = 1):
        self.exc = exc or (lambda: ConnectionResetError(
            "chaos: connection reset"))
        self.times = times

    def apply(self, op, args, kwargs):
        raise self.exc()


class FailAfter(Fault):
    """Execute the operation, then fail: its side effects landed, the
    caller saw an error."""

    def __init__(self, exc: Optional[Callable[[], BaseException]] = None,
                 times: int = 1):
        self.exc = exc or (lambda: ConnectionResetError(
            "chaos: connection reset mid-response"))
        self.times = times

    def apply(self, op, args, kwargs):
        op(*args, **kwargs)
        raise self.exc()


class Latency(Fault):
    """Delay the call by *seconds*, then execute it."""

    def __init__(self, seconds: float, times: int = 1,
                 sleep: Callable[[float], None] = time.sleep):
        self.seconds = seconds
        self.times = times
        self.sleep = sleep

    def apply(self, op, args, kwargs):
        self.sleep(self.seconds)
        return op(*args, **kwargs)


class Stall(Latency):
    """A stall on an INJECTED clock: *advance* (e.g. a test clock's
    ``advance``) moves virtual time, then the operation runs — the
    executor "hung" for *seconds* without a single wall-clock sleep."""

    def __init__(self, seconds: float,
                 advance: Callable[[float], None], times: int = 1):
        super().__init__(seconds, times=times, sleep=advance)


class ExecutorOom(MemoryError):
    """Allocation-time OOM from an executor: transient from the
    scheduler's point of view — the retry-with-rebuild path frees the
    victim's blocks, which is exactly what an OOM needs."""


class Oom(Fault):
    """Fail *times* calls with :class:`ExecutorOom` before the operation
    runs (the allocation never succeeded)."""

    def __init__(self, times: int = 1):
        self.times = times

    def apply(self, op, args, kwargs):
        raise ExecutorOom("chaos: executor allocation OOM")


class PoisonedRid(RuntimeError):
    """Deterministic per-request fault: raised by :class:`ChaosExecutor`
    for every executor call that touches the configured rid. Carries
    ``rid`` so the scheduler can attribute a batched-step failure to the
    actual victim instead of guessing."""

    def __init__(self, rid: str):
        super().__init__(f"chaos: poisoned request {rid}")
        self.rid = rid


class Ok(Fault):
    """Explicit pass-through slot in a script (the call succeeds)."""

    def __init__(self, times: int = 1):
        self.times = times

    def apply(self, op, args, kwargs):
        return op(*args, **kwargs)


_PassThrough = Ok


class FaultPlan:
    """Per-key fault scripts, consumed in order; thread-safe.

    ``plan.script("step", Ok(times=3), Fail())`` lets the next three
    ``step`` calls through and fails the fourth. The key ``"*"`` matches
    any call that has no key-specific script left.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rng = random.Random(seed)
        self._scripts: dict[str, list[Fault]] = {}
        self._lock = threading.Lock()
        #: (key, fault-class-name) log of every injected fault, for
        #: assertions on what the harness actually did
        self.injected: list[tuple[str, str]] = []

    def script(self, key: str, *faults: Fault) -> "FaultPlan":
        with self._lock:
            self._scripts.setdefault(key, []).extend(faults)
        return self

    def flaky(self, key: str, rate: float, n: int = 32,
              exc: Optional[Callable[[], BaseException]] = None
              ) -> "FaultPlan":
        """Script *n* calls where each fails with probability *rate*,
        decided by the plan's seeded RNG — a deterministic flap storm."""
        faults = [Fail(exc) if self.rng.random() < rate else _PassThrough()
                  for _ in range(n)]
        return self.script(key, *faults)

    def _pop(self, key: str) -> Optional[Fault]:
        with self._lock:
            for k in (key, "*"):
                script = self._scripts.get(k)
                while script:
                    fault = script[0]
                    if fault.times <= 0:
                        # scripted with times=0: drop WITHOUT applying
                        script.pop(0)
                        continue
                    fault.times -= 1
                    if fault.times <= 0:
                        script.pop(0)
                    if not isinstance(fault, _PassThrough):
                        self.injected.append((key, type(fault).__name__))
                    return fault
        return None

    def run(self, key: str, op: Callable, *args, **kwargs):
        fault = self._pop(key)
        if fault is None:
            return op(*args, **kwargs)
        return fault.apply(op, args, kwargs)

    def exhausted(self) -> bool:
        with self._lock:
            return not any(self._scripts.values())


class ChaosExecutor:
    """Serve-executor wrapper: scripted faults on the decode path.

    Wraps ``SimExecutor`` / ``TorchSlotExecutor`` (anything with the
    executor surface) and injects faults keyed by method name — ``begin``
    / ``prefill_chunk`` / ``step`` / ``spec_step`` — through a
    :class:`FaultPlan`. A rid passed to :meth:`poison` fails EVERY call
    whose request set contains it (:class:`PoisonedRid`, carrying the
    rid), before the plan is consulted.

    Capability attributes (``prefix_aware``, ``chunk_capacity``,
    ``spec_width``) pass through, so a wrapped executor schedules exactly
    like the bare one between faults.
    """

    def __init__(self, inner, plan: Optional[FaultPlan] = None,
                 seed: int = 0):
        self.inner = inner
        self.plan = plan or FaultPlan(seed)
        self._poisoned: set[str] = set()

    def poison(self, *rids: str) -> "ChaosExecutor":
        self._poisoned.update(rids)
        return self

    def __getattr__(self, name):
        # capability attributes and anything non-faulted pass through
        return getattr(self.inner, name)

    def _check_poison(self, rids) -> None:
        for rid in rids:
            if rid in self._poisoned:
                raise PoisonedRid(rid)

    def begin(self, req, slot):
        self._check_poison((req.rid,))
        return self.plan.run("begin", self.inner.begin, req, slot)

    def prefill_chunk(self, req, slot, offset, n):
        self._check_poison((req.rid,))
        return self.plan.run("prefill_chunk", self.inner.prefill_chunk,
                             req, slot, offset, n)

    def step(self, active):
        self._check_poison(r.rid for _, r in active)
        return self.plan.run("step", self.inner.step, active)

    def spec_step(self, active, drafts):
        self._check_poison(r.rid for _, r in active)
        return self.plan.run("spec_step", self.inner.spec_step,
                             active, drafts)
