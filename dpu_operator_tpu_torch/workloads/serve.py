"""Continuous-batching serving: requests, the slot executor, the scheduler.

The port's core of ``dpu_operator_tpu/workloads/serve.py``:

- :class:`Request`, :class:`CostModel` and a :class:`ServeConfig` holding
  the fields this scheduler honours;
- :class:`TorchSlotExecutor`, with the contract of ``JaxSlotExecutor``:
  slot i owns row i of a (slots, max_seq, H, Dh) cache and sits at its own
  position; ``begin`` prefills a whole prompt, ``prefill_chunk`` one chunk
  of it, ``step`` decodes every slot once (greedy);
- :class:`Scheduler`, whose iteration follows ``Scheduler._step_locked``:
  admission in class order (interactive before batch, FIFO within a class)
  into a free slot with the whole sequence's KV blocks reserved, a chunked
  prefill pass under a per-iteration token budget, one batched decode
  pass, then completion and release of slot and blocks.

Not ported yet: preemption, speculative decoding, prefix sharing, the
fault / retry engine, the degrade ladder, deadlines, tracing, metrics and
the cost ledger, ``DecodeService`` and the HTTP ingress.
"""

from __future__ import annotations

import dataclasses
import heapq
import logging
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from .decode import decode_step, init_kv_cache, prefill, prefill_chunk
from .kv_pool import KvBlockPool

log = logging.getLogger(__name__)

INTERACTIVE = "interactive"
BATCH = "batch"

QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
FAILED = "failed"


@dataclasses.dataclass
class Request:
    """One generation request: *output_len* tokens to generate after
    *prompt* (token ids, whose length is *prompt_len*)."""

    rid: str
    prompt_len: int
    output_len: int
    slo_class: str = BATCH
    arrival_s: float = 0.0
    prompt: Optional[tuple] = None
    # runtime state, owned by the scheduler
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: list = dataclasses.field(default_factory=list)
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    reject_reason: str = ""
    #: chunked prefill: ids consumed so far and the target (prompt length)
    prefilled: int = 0
    prefill_target: int = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    def total_tokens(self) -> int:
        """KV rows the whole sequence needs (the reservation)."""
        return self.prompt_len + self.output_len


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Modelled iteration costs in seconds, which advance the scheduler's
    virtual clock when it runs without a real one: a decode iteration is
    one weight sweep plus a per-sequence term, prefill is linear in
    tokens. The defaults are the JAX package's and were not measured on
    this port's card."""

    decode_base_s: float = 0.025
    decode_per_seq_s: float = 0.0005
    prefill_per_token_s: float = 0.0002

    def decode_s(self, batch: int) -> float:
        return self.decode_base_s + self.decode_per_seq_s * batch \
            if batch else 0.0

    def prefill_s(self, tokens: int) -> float:
        return self.prefill_per_token_s * tokens


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler shape: *slots* concurrent sequences sharing
    ``kv_blocks * kv_block_size`` token slots; *queue_limit* bounds each
    class's queue (past it requests are rejected); a positive
    *prefill_chunk_tokens* spends at most that many prompt tokens per
    iteration on prefill chunks interleaved with decode (0: whole-prompt
    prefill at admission); *static* admits only into an empty batch."""

    slots: int = 8
    kv_blocks: int = 256
    kv_block_size: int = 16
    queue_limit: int = 64
    prefill_chunk_tokens: int = 0
    static: bool = False


class TorchSlotExecutor:
    """Real tokens over a slotted dense KV cache, one iteration at a time.

    Slot *i* owns row *i* of the cache and its own position (``pos``).
    Greedy decoding. Inactive slots decode too, harmlessly: their row is
    dead until the next ``begin`` or chunk rewrites it, and their writes
    land at or above every position a later occupant has filled."""

    #: a dense slot row cannot alias blocks of another request
    prefix_aware = False
    #: no speculative verify path in this executor yet
    spec_width = None

    def __init__(self, params: dict, cfg: Any, slots: int,
                 chunk_tokens: int = 0,
                 device: "str | torch.device" = "cuda") -> None:
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        #: fixed padded chunk width for prefill_chunk; None = no chunking
        self.chunk_capacity = int(chunk_tokens) if chunk_tokens else None
        self.cache = init_kv_cache(cfg, slots, device=self.device)
        self.pos = np.zeros(slots, dtype=np.int32)
        self.last = np.zeros(slots, dtype=np.int32)

    def _ids(self, req: Request) -> list:
        if req.prompt is None:
            raise ValueError(f"request {req.rid} has no prompt ids "
                             "(TorchSlotExecutor needs real tokens)")
        return list(req.prompt) + list(req.tokens)

    def _check_fits(self, req: Request, ids: list) -> None:
        if len(ids) + req.output_len - len(req.tokens) > self.cfg.max_seq:
            raise ValueError(f"request {req.rid} exceeds max_seq "
                             f"{self.cfg.max_seq}")

    def begin(self, req: Request, slot: int) -> int:
        """Prefill the whole prompt into *slot*; returns the first token."""
        ids = self._ids(req)
        self._check_fits(req, ids)
        one, logits = prefill(self.params, self.cfg,
                              torch.tensor([ids], device=self.device))
        for layer, fresh in zip(self.cache, one):
            for key in layer:
                layer[key][slot] = fresh[key][0]
        tok = int(logits[0].argmax())
        self.pos[slot] = len(ids)
        self.last[slot] = tok
        return tok

    def prefill_chunk(self, req: Request, slot: int, offset: int,
                      n: int) -> Optional[int]:
        """Ids [offset, offset + n) of *req* into *slot*, padded to the
        chunk width. Returns the first generated token when this chunk
        completes the prompt, else None. ``pos[slot]`` follows the prefill
        frontier, so a decode iteration between chunks writes its dead row
        exactly where the next chunk overwrites it."""
        if not self.chunk_capacity:
            raise ValueError("TorchSlotExecutor needs chunk_tokens > 0 "
                             "for chunked prefill")
        ids = self._ids(req)
        if n > self.chunk_capacity or offset + n > len(ids):
            raise ValueError(
                f"chunk [{offset}, {offset + n}) outside capacity "
                f"{self.chunk_capacity} / sequence {len(ids)}")
        if offset == 0:
            self._check_fits(req, ids)
        chunk = np.zeros(self.chunk_capacity, np.int64)
        chunk[:n] = ids[offset:offset + n]
        _, logits = prefill_chunk(self.params, self.cfg, self.cache, slot,
                                  torch.from_numpy(chunk), offset, n)
        self.pos[slot] = offset + n
        if offset + n < len(ids):
            return None
        tok = int(logits.argmax())
        self.last[slot] = tok
        return tok

    def step(self, active: list) -> dict:
        """One decode iteration over every slot; returns ``{slot: token}``
        for the *active* ``(slot, request)`` pairs."""
        tokens = torch.from_numpy(self.last.astype(np.int64))
        pos = torch.from_numpy(np.clip(self.pos, 0, self.cfg.max_seq - 1))
        logits, _ = decode_step(self.params, self.cfg, self.cache,
                                tokens.to(self.device),
                                pos.to(self.device))
        # the one device-to-host copy of the iteration: every slot's argmax
        picked = logits.argmax(-1).cpu().numpy()
        out = {}
        for slot, _req in active:
            tok = int(picked[slot])
            self.last[slot] = tok
            self.pos[slot] += 1
            out[slot] = tok
        return out


class Scheduler:
    """Iteration-level continuous-batching scheduler over an executor.

    Drive it with :meth:`step` (one iteration) or :meth:`run` (until
    drained). Without a *clock* time is virtual and advances by the cost
    model; with one (``time.monotonic``) latencies are measured. Every
    admission, chunk, decode and completion is appended to :attr:`trace`.
    """

    def __init__(self, config: ServeConfig, executor: Any,
                 cost_model: Optional[CostModel] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.config = config
        self.executor = executor
        self.cost = cost_model if cost_model is not None else CostModel()
        self._clock = clock
        self.pool = KvBlockPool(config.kv_blocks, config.kv_block_size)
        self._chunked = config.prefill_chunk_tokens > 0 and not config.static
        if self._chunked and getattr(executor, "chunk_capacity",
                                     0) is None:
            raise ValueError(
                "chunked prefill configured but the executor was built "
                "without a chunk width (pass chunk_tokens)")
        self.now = 0.0 if clock is None else clock()
        #: future arrivals: (arrival_s, submission seq, request) min-heap
        self._pending: list[tuple] = []
        self._seq = 0
        self._queues: dict[str, list[Request]] = {INTERACTIVE: [],
                                                  BATCH: []}
        self._live_rids: set[str] = set()
        self._active: dict[int, Request] = {}
        #: admitted requests whose prompt is not fully prefilled yet
        self._prefilling: list[Request] = []
        self._free_slots: list[int] = list(range(config.slots))
        self.completed: list[Request] = []
        self.rejected: list[Request] = []
        self.failed: list[Request] = []
        self.iterations = 0
        self.prefill_chunks_total = 0
        self.trace: list[tuple] = []

    # -- intake ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue an arrival at ``req.arrival_s`` on the scheduler's
        clock; ties are taken in submission order."""
        self._seq += 1
        heapq.heappush(self._pending, (req.arrival_s, self._seq, req))

    # -- one iteration --------------------------------------------------------
    def step(self) -> bool:
        """One iteration. Returns False when nothing is left to do now."""
        if self._clock is not None:
            self.now = self._clock()
        self._ingest()
        if not self._active and not self._queued_count():
            if not self._pending:
                return False
            if self._clock is not None:
                return False  # real clock: nothing due yet
            self.now = max(self.now, self._pending[0][0])
            self._ingest()
        self.iterations += 1
        it = self.iterations
        admitted = self._admit(it)
        if self._chunked:
            for req in admitted:
                req.state = PREFILLING
                self._prefilling.append(req)
            self._prefill_pass(it)
        else:
            for req in admitted:
                self._advance(self.cost.prefill_s(req.prefill_target))
                try:
                    tok = self.executor.begin(req, req.slot)
                except (ValueError, RuntimeError) as e:
                    self._fail(it, req, e)
                    continue
                req.prefilled = req.prefill_target
                self._finish_prefill(it, req, tok)
        active = sorted((slot, req) for slot, req in self._active.items()
                        if req.state == RUNNING
                        and len(req.tokens) < req.output_len)
        if active:
            self._advance(self.cost.decode_s(len(active)))
            toks = self.executor.step(active)
            self._tick()
            for slot, req in active:
                req.tokens.append(toks[slot])
                self.pool.set_used_tokens(
                    req.rid, req.prompt_len + len(req.tokens))
            self.trace.append(("decode", it, len(active)))
        for slot in sorted(self._active):
            req = self._active[slot]
            if len(req.tokens) >= req.output_len:
                self._complete(it, req)
        return True

    def run(self, max_steps: int = 1_000_000) -> int:
        """Step until drained (or *max_steps*); returns steps taken."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps

    # -- internals ------------------------------------------------------------
    def _advance(self, cost_s: float) -> None:
        if self._clock is None:
            self.now += cost_s

    def _tick(self) -> None:
        if self._clock is not None:
            self.now = self._clock()

    def _queued_count(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _reject(self, req: Request, reason: str) -> None:
        req.state = REJECTED
        req.reject_reason = reason
        self.rejected.append(req)
        self.trace.append(("reject", self.iterations + 1, req.rid, reason))

    def _ingest(self) -> None:
        """Move due arrivals into their class queue, rejecting duplicate
        ids, reservations larger than the whole pool and arrivals past the
        queue bound."""
        while self._pending and self._pending[0][0] <= self.now:
            _, _, req = heapq.heappop(self._pending)
            if req.rid in self._live_rids:
                self._reject(req, "duplicate_rid")
            elif self.pool.blocks_for_tokens(req.total_tokens()) \
                    > self.pool.num_blocks:
                self._reject(req, "kv_too_large")
            elif len(self._queues[req.slo_class]) >= self.config.queue_limit:
                self._reject(req, "queue_full")
            else:
                self._queues[req.slo_class].append(req)
                self._live_rids.add(req.rid)

    def _head(self) -> Optional[Request]:
        for cls in (INTERACTIVE, BATCH):
            if self._queues[cls]:
                return self._queues[cls][0]
        return None

    def _admit(self, it: int) -> list:
        """Admission: the head request, in class order, into the lowest
        free slot with its whole sequence's blocks reserved; stops at the
        first head that does not fit. Returns the requests admitted."""
        if self.config.static and self._active:
            return []
        admitted: list[Request] = []
        while self._free_slots:
            req = self._head()
            if req is None:
                break
            blocks = self.pool.blocks_for_tokens(req.total_tokens())
            if self.pool.alloc(req.rid, blocks) is None:
                break
            self._queues[req.slo_class].remove(req)
            slot = self._free_slots.pop(0)
            req.slot = slot
            req.state = RUNNING
            req.prefill_target = req.prompt_len + len(req.tokens)
            req.prefilled = 0
            self._active[slot] = req
            admitted.append(req)
            self.trace.append(("admit", it, req.rid, req.slo_class, slot,
                               blocks))
        return admitted

    def _prefill_pass(self, it: int) -> None:
        """Spend this iteration's prefill budget over the chunk queue:
        interactive first, FIFO within a class, the head served to the end
        of its prompt before the next. A request whose last chunk lands
        takes its first token now and joins this iteration's decode."""
        budget = self.config.prefill_chunk_tokens
        cap = self.executor.chunk_capacity or budget
        order = ([r for r in self._prefilling if r.slo_class == INTERACTIVE]
                 + [r for r in self._prefilling if r.slo_class == BATCH])
        for req in order:
            while budget > 0:
                remaining = req.prefill_target - req.prefilled
                if remaining <= 0:
                    break
                n = min(budget, remaining, cap)
                self._advance(self.cost.prefill_s(n))
                try:
                    tok = self.executor.prefill_chunk(req, req.slot,
                                                      req.prefilled, n)
                except (ValueError, RuntimeError) as e:
                    self._fail(it, req, e)
                    break
                req.prefilled += n
                self.pool.set_used_tokens(req.rid, req.prefilled)
                budget -= n
                self.prefill_chunks_total += 1
                self.trace.append(("chunk", it, req.rid,
                                   req.prefilled - n, n))
                if req.prefilled >= req.prefill_target:
                    self._prefilling.remove(req)
                    self._finish_prefill(it, req, tok)
                    break
            if budget <= 0:
                break

    def _finish_prefill(self, it: int, req: Request,
                        tok: Optional[int]) -> None:
        """The prompt is in the cache: append the first token and stamp
        TTFT. A missing token is the executor breaking its contract and
        fails the request (left active it would hold its slot forever)."""
        if tok is None:
            self._fail(it, req, RuntimeError(
                f"executor returned no token for {req.rid}'s final "
                "prefill chunk"))
            return
        self._tick()
        req.state = RUNNING
        if not req.tokens:
            req.first_token_s = self.now
        req.tokens.append(tok)
        self.pool.set_used_tokens(req.rid, req.prompt_len + len(req.tokens))

    def _release(self, req: Request) -> None:
        """Free chunk-queue entry, slot and KV blocks: the one teardown
        that completion and failure share."""
        if req in self._prefilling:
            self._prefilling.remove(req)
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self._free_slots.append(req.slot)
            self._free_slots.sort()
            req.slot = None
        self.pool.free(req.rid)
        self._live_rids.discard(req.rid)

    def _fail(self, it: int, req: Request, exc: Exception) -> None:
        """A request the executor cannot serve fails alone."""
        log.warning("executor failed for %s (failing the request): %s",
                    req.rid, exc)
        self._release(req)
        req.state = FAILED
        req.reject_reason = str(exc)
        self.failed.append(req)
        self.trace.append(("fail", it, req.rid))

    def _complete(self, it: int, req: Request) -> None:
        self._release(req)
        req.state = DONE
        req.finish_s = self.now
        self.completed.append(req)
        self.trace.append(("complete", it, req.rid, len(req.tokens)))
