"""Graceful-degradation ladder for the serving path.

The port's copy of ``dpu_operator_tpu/workloads/degrade.py``, whole and
unchanged in logic. Under sustained executor faults or a firing serve-SLO
alert the scheduler must get SMALLER before it gets dead: shed what is
sheddable, stop speculating, stop advertising capacity it cannot honor,
and keep the interactive contract alive longest. This module is the
judgment for that — a deterministic rung ladder with hysteresis:
escalation takes consecutive bad signals, de-escalation takes consecutive
good signals AND an expired hold-down, and re-escalating within the flap
window doubles the hold-down (bounded), so a flapping executor cannot
oscillate the ladder.

The ladder is a PURE state machine over an injected clock: it holds no
locks, emits nothing, and touches no wall time — the scheduler feeds it
one signal per iteration and publishes the transitions (a ``rung`` trace
tuple). That purity is what keeps seeded chaos storms bit-reproducible.

Rungs, in escalation order (each includes everything above it):

0. ``healthy`` — full service.
1. ``shed_batch`` — batch-class ADMISSIONS are rejected
   (``degraded_shed``); batch work already admitted keeps running.
2. ``no_spec`` — speculation k clamps to 0 (plain decode): no verify
   amplification against a faulting executor.
3. ``shrink_slots`` — advertised serve slots clamp to a fraction of
   the configured width; the device plugin stops selling capacity the
   replica may not be able to serve.
4. ``interactive_only`` — zero advertised slots and no batch-class
   admissions at all, even from the already-queued backlog;
   everything left serves the interactive contract.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

#: rung names, index == rung number
RUNGS = ("healthy", "shed_batch", "no_spec", "shrink_slots",
         "interactive_only")

RUNG_HEALTHY = 0
RUNG_SHED_BATCH = 1
RUNG_NO_SPEC = 2
RUNG_SHRINK_SLOTS = 3
RUNG_INTERACTIVE_ONLY = 4


@dataclasses.dataclass(frozen=True)
class LadderPolicy:
    """Hysteresis thresholds (the reference's defaults)."""

    #: consecutive bad signals (faulting iterations / firing serve-SLO
    #: alert) before stepping DOWN one rung
    escalate_after: int = 2
    #: consecutive good signals, after the hold-down expired, before
    #: stepping back UP one rung
    recover_after: int = 4
    #: hold-down started on every escalation, seconds; good signals
    #: during it are IGNORED (CrashLoopBackOff-style)
    hold_down_base_s: float = 2.0
    #: hold-down ceiling, seconds
    hold_down_max_s: float = 60.0
    #: window for counting escalation episodes: a re-escalation within
    #: it doubles the hold-down (flap damping)
    flap_window_s: float = 30.0


@dataclasses.dataclass(frozen=True)
class RungChange:
    """One committed ladder transition (old < new = escalation)."""

    old: int
    new: int
    reason: str


class DegradationLadder:
    """The rung state machine. Feed :meth:`observe` one boolean signal
    per scheduler iteration (True = this iteration saw an executor
    fault or a firing serve-SLO burn alert); it returns the committed
    :class:`RungChange`, if any, for the caller to publish."""

    def __init__(self, policy: Optional[LadderPolicy] = None) -> None:
        self.policy = policy or LadderPolicy()
        self.rung = RUNG_HEALTHY
        self._bad = 0
        self._good = 0
        #: recovery is gated on this expiring; escalations re-arm it
        self._hold_until = 0.0
        self._hold_s = self.policy.hold_down_base_s
        #: recent escalation times (flap-window episode accounting)
        self._episodes: collections.deque = collections.deque(maxlen=16)
        self.escalations = 0
        self.holddown_doublings = 0

    def observe(self, now: float, bad: bool) -> Optional[RungChange]:
        if bad:
            self._good = 0
            self._bad += 1
            if self._bad >= self.policy.escalate_after \
                    and self.rung < len(RUNGS) - 1:
                self._bad = 0
                return self._escalate(now)
            return None
        self._bad = 0
        if self.rung == RUNG_HEALTHY:
            return None
        if now < self._hold_until:
            # goods during hold-down are ignored — the damping that
            # stops a flapping executor from walking the ladder back
            # up between bounces
            self._good = 0
            return None
        self._good += 1
        if self._good < self.policy.recover_after:
            return None
        self._good = 0
        old = self.rung
        self.rung -= 1
        return RungChange(old, self.rung, "recovered")

    def _escalate(self, now: float) -> RungChange:
        old = self.rung
        self.rung += 1
        self.escalations += 1
        # flap damping: another escalation inside the window doubles
        # the hold-down (capped); outside it, the hold-down resets
        recent = [t for t in self._episodes
                  if now - t <= self.policy.flap_window_s]
        if recent:
            self._hold_s = min(self._hold_s * 2,
                               self.policy.hold_down_max_s)
            self.holddown_doublings += 1
        else:
            self._hold_s = self.policy.hold_down_base_s
        self._episodes.append(now)
        self._hold_until = now + self._hold_s
        return RungChange(old, self.rung, "degraded")

    # -- introspection --------------------------------------------------------
    @property
    def rung_name(self) -> str:
        return RUNGS[self.rung]

    def hold_remaining_s(self, now: float) -> float:
        return max(0.0, self._hold_until - now)

    def snapshot(self, now: float) -> dict:
        return {
            "rung": self.rung,
            "name": self.rung_name,
            "escalations": self.escalations,
            "holddownDoublings": self.holddown_doublings,
            "holdRemainingS": round(self.hold_remaining_s(now), 6),
        }
