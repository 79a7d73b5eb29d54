"""Continuous-batching serving: requests, the executors, the scheduler.

The port's core of ``dpu_operator_tpu/workloads/serve.py``:

- :class:`Request`, :class:`CostModel` and a :class:`ServeConfig` holding
  the fields this scheduler honours;
- :class:`TorchSlotExecutor`, with the contract of ``JaxSlotExecutor``:
  slot i owns row i of a (slots, max_seq, H, Dh) cache and sits at its own
  position; ``begin`` prefills a whole prompt, ``prefill_chunk`` one chunk
  of it, ``step`` decodes every slot once (greedy), ``spec_step`` verifies
  every slot's drafts at a fixed width in one pass;
- :class:`SimExecutor` and :class:`PeriodicSimExecutor`, synthetic tokens
  on the host: the only executors whose cache can alias blocks, so the
  ones through which prefix sharing, copy-on-write and rollback run;
- :class:`Scheduler`, whose iteration follows ``Scheduler._step_locked``:
  admission in class order (interactive before batch, FIFO within a class)
  into a free slot with the whole sequence's KV blocks reserved (shared
  prefix blocks mapped, not allocated), preempting batch requests for an
  interactive one; a chunked prefill pass under a per-iteration token
  budget; one batched decode pass, or a speculative verify pass when the
  adaptive draft length says so; then completion, deadlines and release,
  and one signal to the degradation ladder (:mod:`.degrade`).

Serving under faults follows the reference's fault engine: an executor
exception costs one request, never the scheduler. A batched pass that
raises blames one victim (the rid the exception names, else the
latest-admitted request); a contract breach (``ValueError`` /
``TypeError``) fails its request; anything else retries with rebuild
(blocks freed, tokens kept, prefill again on readmission after a seeded
backoff on the scheduler's clock), and a request past its retry budget is
excised as poisoned. Deadlines (``x-tpu-deadline-ms``) are enforced at
admission, at chunk-queue re-entry and mid-stream; :meth:`Scheduler.cancel`
abandons a live request.

The serving bench follows the reference's: seeded open-loop arrivals
(:func:`open_loop_arrivals`, :func:`prefix_heavy_arrivals`) run to drain on
the virtual clock (:func:`run_open_loop`) over a :class:`CostModel` that
:func:`calibrate_cost_model` fits to the port's own iterations, and the
records built from such runs (:func:`bench_serving`,
:func:`compare_batching`, :func:`bench_prefix_sharing`,
:func:`bench_spec_decoding`); :func:`wall_open_loop` serves the same
arrivals through :class:`TorchSlotExecutor` on the wall clock.

The serving shell follows the reference's: each :meth:`Scheduler.step`
runs under the scheduler's state lock and a task-scoped watchdog
heartbeat, writes a :class:`StepLedger` entry whose phases reconcile with
the iteration's time, and records the request lifecycle as phase spans in
the flight ring (kind ``serve``, deterministic ids, the ingress's trace
id); the serve metrics, flight records and Events follow the reference's
call sites, and :meth:`Scheduler.snapshot`, :meth:`Scheduler.headroom` and
:meth:`Scheduler.serving_summary` are its JSON views. :class:`DecodeService`
steps the scheduler from a thread of its own, serves those views as
``/debug/serve``, ``/debug/serve/ledger`` and ``/debug/serve/headroom``,
and streams ``POST /v1/generate`` over chunked HTTP, one token a flush
(:meth:`DecodeService.start_http`). As the reference's, its ``start``
also arms the performance and history planes: the sampling profiler
(``utils/profiler.py``, ``/debug/profile``), the metrics-history rings
over the serving families (``utils/history.py``, ``/debug/history``) and
the trend engine judging them (``utils/trend.py``), whose anomalies the
headroom digest carries as ``trendAnomalies``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import itertools
import json
import logging
import queue
import random
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils import (flight, history, metrics, profiler, slo, tracing,
                     trend, validate, watchdog)
from ..utils.resilience import RetryPolicy
from ..utils.stats import nearest_rank
from . import degrade
from .decode import (decode_step, init_kv_cache, params_device, prefill,
                     prefill_chunk, verify_step)
from .kv_pool import KvBlockPool, chain_keys
from .model import TransformerConfig, init_params
from .moe import moe_capacity
from .spec import AdaptiveK, NgramDrafter, greedy_accept

log = logging.getLogger(__name__)

INTERACTIVE = "interactive"
BATCH = "batch"

#: ingress bounds: every request field is clamped against these before it
#: can size a read, a KV reservation or a decode budget
MAX_BODY_BYTES = 1 << 20      # 1 MiB of request JSON is ~1.5e5 tokens
MAX_PROMPT_LEN = 65536
MAX_OUTPUT_LEN = 65536
MAX_TOKEN_ID = 1 << 30        # any real vocabulary fits well inside this

#: per-request deadline header: a relative millisecond budget from arrival
DEADLINE_HEADER = "x-tpu-deadline-ms"
MAX_DEADLINE_MS = 86_400_000  # 24 h: anything longer is no deadline
_DEADLINE_RE = re.compile(r"^[0-9]{1,8}$")
#: a stream waits this long past its deadline budget, so the scheduler's
#: own deadline_exceeded record reaches the wire first
STREAM_DEADLINE_GRACE_S = 0.5


def parse_deadline_ms(value: object) -> Optional[int]:
    """Strict parse of the ``x-tpu-deadline-ms`` header: 1-8 ASCII digits
    (no sign, point, whitespace or exponent) within [1 ms, 24 h]. Anything
    else returns None, and the request carries no deadline."""
    if not isinstance(value, str):
        return None
    if not _DEADLINE_RE.match(value):
        return None
    ms = int(value)
    if ms < 1 or ms > MAX_DEADLINE_MS:
        return None
    return ms


#: a request survives this many transient executor faults; each retry is
#: held back by a full-jitter backoff from the base, doubling to the cap
RETRY_BUDGET = 2
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 1.0
#: the request size (tokens) whose KV blocks back one advertisable slot
TYPICAL_TOKENS = 128

QUEUED = "queued"
PREFILLING = "prefilling"
RUNNING = "running"
DONE = "done"
REJECTED = "rejected"
#: admitted, then not served: executor failure, poisoned, deadline
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
    #: ``stream(event, value)``: ("token", tok) per generated token, then
    #: one terminal ("done", n_tokens), ("rejected", reason), ("failed",
    #: reason) or ("deadline_exceeded", n_tokens); called under the
    #: scheduler's state lock, so it must only enqueue, never block
    stream: Optional[Callable] = dataclasses.field(
        default=None, repr=False, compare=False)
    # runtime state, owned by the scheduler
    state: str = QUEUED
    slot: Optional[int] = None
    tokens: list = dataclasses.field(default_factory=list)
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finish_s: Optional[float] = None
    preemptions: int = 0
    reject_reason: str = ""
    #: chunked prefill: ids consumed so far, the target (prompt + kept
    #: tokens) and where this admission started (past any shared prefix;
    #: a preemption counts ``prefilled - prefill_start`` as discarded)
    prefilled: int = 0
    prefill_target: int = 0
    prefill_start: int = 0
    #: prefix sharing: the prompt's block chain keys, and the prompt
    #: tokens covered by mapped shared blocks
    prefix_keys: Optional[list] = dataclasses.field(default=None,
                                                    repr=False)
    shared_tokens: int = 0
    #: lifecycle tracing: the trace every phase span carries (the
    #: caller's through the ingress, else one minted from the rid), the
    #: span the phases hang under, and the next span's sequence number
    trace_id: Optional[str] = None
    parent_span_id: Optional[str] = None
    span_seq: int = 0
    #: when the current wait began (arrival, or the preemption), when the
    #: current decode residency began, and its decode iterations
    queued_since_s: Optional[float] = None
    decode_since_s: Optional[float] = None
    decode_iters: int = 0
    #: optional deadline: a relative budget (``parse_deadline_ms``), made
    #: an absolute instant on the scheduler's clock at ingest
    deadline_budget_s: Optional[float] = None
    deadline_s: Optional[float] = None
    #: retry-with-rebuild: transient faults survived, the instant before
    #: which the request is not readmitted, and when the last fault hit
    retries: int = 0
    retry_at: float = 0.0
    last_fault_s: Optional[float] = None

    def fresh_copy(self) -> "Request":
        """The request's spec alone (id, lengths, class, arrival, prompt,
        deadline budget), without the runtime state or the stream."""
        return Request(rid=self.rid, prompt_len=self.prompt_len,
                       output_len=self.output_len,
                       slo_class=self.slo_class,
                       arrival_s=self.arrival_s, prompt=self.prompt,
                       deadline_budget_s=self.deadline_budget_s)

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
    virtual clock when it runs without a real one and price the adaptive
    draft length: a decode iteration is one weight sweep plus a
    per-sequence term, a verify iteration adds a term per scored draft,
    prefill is linear in tokens. The defaults are the JAX package's, not
    a measurement of this port; :func:`calibrate_cost_model` fits one to
    the port's iterations on a device."""

    decode_base_s: float = 0.025
    decode_per_seq_s: float = 0.0005
    prefill_per_token_s: float = 0.0002
    spec_verify_per_token_s: float = 0.0002

    def decode_s(self, batch: int) -> float:
        return self.decode_base_s + self.decode_per_seq_s * batch \
            if batch else 0.0

    def prefill_s(self, tokens: int) -> float:
        return self.prefill_per_token_s * tokens

    def verify_s(self, batch: int, k: int) -> float:
        """One verify iteration scoring k drafts per sequence; k = 0 is
        exactly ``decode_s``."""
        return self.decode_s(batch) \
            + self.spec_verify_per_token_s * batch * k


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Scheduler shape: *slots* concurrent sequences sharing
    ``kv_blocks * kv_block_size`` token slots; *queue_limit* bounds each
    class's queue (past it requests are rejected); a positive
    *prefill_chunk_tokens* spends at most that many prompt tokens per
    iteration on prefill chunks interleaved with decode (0: whole-prompt
    prefill at admission); *static* admits only into an empty batch;
    *preemption* lets an interactive request evict batch requests;
    *prefix_sharing* maps common prompt prefixes onto the same blocks
    (with a prefix-aware executor); a positive *spec_k* speculates up to
    that many drafts per sequence per iteration."""

    slots: int = 8
    kv_blocks: int = 256
    kv_block_size: int = 16
    queue_limit: int = 64
    prefill_chunk_tokens: int = 0
    static: bool = False
    preemption: bool = True
    prefix_sharing: bool = False
    spec_k: int = 0


#: the bound on one iteration (a full-batch decode plus the prefill
#: stacked on it) that sizes the prefill budget, and the budget's floor
ITL_BOUND_S = 0.05
PREFILL_FLOOR_TOKENS = 16
#: :func:`chunked_config`'s width: enough slots that the KV pool, not the
#: slot count, binds
CHUNKED_SLOTS = 24


def prefill_budget_tokens(cost_model: CostModel, slots: int) -> int:
    """The per-iteration prefill budget (tokens) from a cost model: the
    most prompt tokens whose prefill, stacked on a full-batch decode
    iteration, keeps the iteration under :data:`ITL_BOUND_S`; never below
    :data:`PREFILL_FLOOR_TOKENS`, so prefill progresses even when one
    decode iteration already exceeds the bound."""
    spare = ITL_BOUND_S - cost_model.decode_s(slots)
    if cost_model.prefill_per_token_s <= 0:
        return PREFILL_FLOOR_TOKENS
    return max(PREFILL_FLOOR_TOKENS,
               int(spare / cost_model.prefill_per_token_s))


def chunked_config(cost_model: CostModel) -> ServeConfig:
    """The serving shape the reference's bench records: chunked prefill
    with the budget of :func:`prefill_budget_tokens`, prefix sharing on,
    :data:`CHUNKED_SLOTS` slots over the default pool."""
    return ServeConfig(
        slots=CHUNKED_SLOTS,
        prefill_chunk_tokens=prefill_budget_tokens(cost_model,
                                                   CHUNKED_SLOTS),
        prefix_sharing=True)


class SimExecutor:
    """Synthetic tokens, a pure function of (rid, position): the scheduling
    harness executor. It stores no KV, so prefix sharing is accounting
    alone and any chunk or verify width fits (0 = unbounded)."""

    prefix_aware = True
    chunk_capacity = 0
    spec_width = 0

    def begin(self, req: Request, slot: int) -> int:
        # the continuation token: a re-admitted request re-prefills
        # prompt + tokens and goes on from the stream it has
        return self._token(req, len(req.tokens))

    def prefill_chunk(self, req: Request, slot: int, offset: int,
                      n: int) -> Optional[int]:
        """The continuation token when this chunk completes the prompt,
        else None."""
        if offset + n >= req.prompt_len + len(req.tokens):
            return self._token(req, len(req.tokens))
        return None

    def step(self, active: list) -> dict:
        return {slot: self._token(req, len(req.tokens))
                for slot, req in active}

    def spec_step(self, active: list, drafts: dict) -> dict:
        """Each row's drafts scored against the true stream by
        :func:`greedy_accept`; returns ``{slot: [emitted tokens]}``."""
        out = {}
        for slot, req in active:
            d = drafts.get(slot, [])
            base = len(req.tokens)
            truth = [self._token(req, base + i)
                     for i in range(len(d) + 1)]
            _, emitted = greedy_accept(d, truth)
            out[slot] = emitted
        return out

    @staticmethod
    def _token(req: Request, n: int) -> int:
        acc = 0
        for ch in req.rid:
            acc = (acc * 131 + ord(ch)) % 50_021
        return (acc + 7919 * n) % 50_021


class PeriodicSimExecutor(SimExecutor):
    """Synthetic stream whose tokens cycle with a fixed *period*: the
    drafter-friendly traffic shape, where the n-gram drafter's acceptance
    approaches 1 after one period."""

    def __init__(self, period: int = 4) -> None:
        if period < 1:
            raise ValueError("period must be >= 1")
        self.period = period

    def _token(self, req: Request, n: int) -> int:  # type: ignore[override]
        acc = 0
        for ch in req.rid:
            acc = (acc * 131 + ord(ch)) % 50_021
        return (acc + 7919 * (n % self.period)) % 50_021


class TorchSlotExecutor:
    """Real tokens over a slotted dense KV cache, one iteration at a time.

    Slot *i* owns row *i* of the cache and its own position (``pos``).
    Greedy decoding. Inactive slots decode too, harmlessly: their row is
    dead until the next ``begin`` or chunk rewrites it, and their writes
    land at or above every position a later occupant has filled.

    A call that raises commits no slot state: ``pos`` and ``last`` move
    only after the forward has returned. Rows it wrote before raising lie
    at or past each slot's frontier, so the next call rewrites them (the
    same tokens at the same positions), and a retried request is prefilled
    again, prompt and kept tokens, into whatever slot it is readmitted
    to.

    Each blocking transfer between host and card is an ``executor.wait``
    profiler range: the copies of a call's inputs from pageable memory
    (each drains the stream first) and the read of its argmaxes (their
    launch stays outside). It keeps on the host what the scheduler's
    ledger reads an iteration at a time (:meth:`counters`): the seconds of
    the decode passes' transfers, and the real tokens its MoE layers
    routed beside the expert rows they computed, from the shapes."""

    #: a dense slot row cannot alias blocks of another request
    prefix_aware = False

    def __init__(self, params: dict, cfg: Any, slots: int,
                 chunk_tokens: int = 0, spec_k: int = 0,
                 device: "str | torch.device" = "cuda") -> None:
        self.device = resolve_device(device)
        if params_device(params).type != self.device.type:
            raise ValueError(f"params live on {params_device(params)}, "
                             f"not {self.device}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        #: fixed padded chunk width for prefill_chunk; None = no chunking
        self.chunk_capacity = int(chunk_tokens) if chunk_tokens else None
        #: fixed verify width (drafts + 1) for spec_step; None = no
        #: verify path (a speculating Scheduler refuses the executor)
        self.spec_width = int(spec_k) + 1 if spec_k else None
        self.cache = init_kv_cache(cfg, slots, device=self.device)
        self.pos = np.zeros(slots, dtype=np.int32)
        self.last = np.zeros(slots, dtype=np.int32)
        self._moe_layers = sum(1 for i in range(cfg.n_layers)
                               if cfg.is_moe_layer(i))
        self.decode_wait_s = 0.0
        self.moe_routed_tokens = 0
        self.moe_expert_rows = 0

    def counters(self) -> dict:
        """Running totals: ``decode_wait_s``, the seconds ``step`` and
        ``spec_step`` spent in transfers (``perf_counter``'s);
        ``moe_routed_tokens``, the real tokens of every forward (a chunk's
        valid ones, a decode pass's active slots) times the MoE layers;
        ``moe_expert_rows``, the rows those layers' expert products
        computed (experts x batch rows x capacity)."""
        return {"decode_wait_s": self.decode_wait_s,
                "moe_routed_tokens": self.moe_routed_tokens,
                "moe_expert_rows": self.moe_expert_rows}

    @contextlib.contextmanager
    def _waiting(self, decode: bool = False) -> Iterator[None]:
        """A blocking transfer between host and card: an
        ``executor.wait`` range, its seconds added to ``decode_wait_s`` in
        a decode pass."""
        t0 = time.perf_counter()
        with tracing.profiled("executor.wait"):
            yield
        if decode:
            self.decode_wait_s += time.perf_counter() - t0

    def _count_moe(self, tokens: int, b: int, s: int) -> None:
        """A forward over (*b*, *s*) that holds *tokens* real ones: each
        MoE layer routes the batch rows alone (``moe_ffn``)."""
        if self._moe_layers:
            self.moe_routed_tokens += self._moe_layers * tokens
            self.moe_expert_rows += self._moe_layers * self.cfg.moe_experts \
                * b * moe_capacity(s, self.cfg.moe_experts,
                                   self.cfg.moe_capacity_factor)

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
        with self._waiting():
            prompt = torch.tensor([ids], device=self.device)
        one, logits = prefill(self.params, self.cfg, prompt)
        self._count_moe(len(ids), 1, len(ids))
        for layer, fresh in zip(self.cache, one):
            for key in layer:
                layer[key][slot] = fresh[key][0]
        picked = logits[0].argmax()
        with self._waiting():
            tok = int(picked)
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
        with self._waiting():
            tokens = torch.from_numpy(chunk).to(self.device)
        _, logits = prefill_chunk(self.params, self.cfg, self.cache, slot,
                                  tokens, offset, n)
        self._count_moe(n, 1, self.chunk_capacity)
        self.pos[slot] = offset + n
        if offset + n < len(ids):
            return None
        picked = logits.argmax()
        with self._waiting():
            tok = int(picked)
        self.last[slot] = tok
        return tok

    def _positions(self) -> torch.Tensor:
        return torch.from_numpy(np.clip(self.pos, 0, self.cfg.max_seq - 1)
                                ).to(self.device)

    def step(self, active: list) -> dict:
        """One decode iteration over every slot; returns ``{slot: token}``
        for the *active* ``(slot, request)`` pairs."""
        with self._waiting(decode=True):
            tokens = torch.from_numpy(self.last.astype(np.int64)
                                      ).to(self.device)
            pos = self._positions()
        logits, _ = decode_step(self.params, self.cfg, self.cache, tokens,
                                pos)
        self._count_moe(len(active), self.slots, 1)
        picked = logits.argmax(-1)
        # the one device-to-host copy of the iteration: every slot's argmax
        with self._waiting(decode=True):
            picked = picked.cpu().numpy()
        out = {}
        for slot, _req in active:
            tok = int(picked[slot])
            self.last[slot] = tok
            self.pos[slot] += 1
            out[slot] = tok
        return out

    def spec_step(self, active: list, drafts: dict) -> dict:
        """One speculative iteration: every slot's row ``[last committed,
        d_1..d_k]``, padded to ``spec_width`` with repeats of the committed
        token, goes through one :func:`verify_step`, and the exact greedy
        rule accepts on the host. A row whose drafts are all rejected still
        emits the correction token; the K/V it wrote past the accepted
        frontier is dead, overwritten before a causal mask admits it, and
        rows past ``max_seq`` are not written. Returns ``{slot: [emitted
        tokens]}`` for the *active* pairs."""
        if not self.spec_width:
            raise ValueError("TorchSlotExecutor needs spec_k > 0 for "
                             "speculative decoding")
        width = self.spec_width
        tokens = np.tile(self.last.astype(np.int64)[:, None], (1, width))
        n_drafted = {}
        for slot, _req in active:
            d = [int(t) for t in drafts.get(slot, ())][:width - 1]
            n_drafted[slot] = len(d)
            tokens[slot, 1:1 + len(d)] = d
        with self._waiting(decode=True):
            rows = torch.from_numpy(tokens).to(self.device)
            pos = self._positions()
        logits, _ = verify_step(self.params, self.cfg, self.cache, rows, pos)
        self._count_moe(sum(1 + n_drafted[slot] for slot, _ in active),
                        self.slots, width)
        picked = logits.argmax(-1)
        # the one device-to-host copy of the iteration: every slot's k + 1
        # argmaxes
        with self._waiting(decode=True):
            picked = picked.cpu().numpy()
        out = {}
        for slot, _req in active:
            k = n_drafted[slot]
            _, emitted = greedy_accept(
                [int(t) for t in tokens[slot, 1:1 + k]],
                [int(t) for t in picked[slot, :k + 1]])
            self.last[slot] = emitted[-1]
            self.pos[slot] += len(emitted)
            out[slot] = emitted
        return out


def _change(before: dict, after: dict) -> dict:
    """*after* less *before*, key by key; seconds (floats) rounded to the
    ledger's 6 places."""
    return {key: round(value - before[key], 6) if isinstance(value, float)
            else value - before[key] for key, value in after.items()}


#: the ledger's phase keys, in render order: ``verify`` is the speculative
#: iteration that replaces decode; ``compile`` is the compile time an
#: iteration's executor calls spent, re-billed out of the phase that
#: absorbed it. Eager PyTorch compiles nothing, so it reads 0 until the
#: executor captures CUDA graphs
LEDGER_PHASES = ("prefill", "decode", "verify", "cow", "sched",
                 "compile")


class StepLedger:
    """Bounded ring of per-iteration cost entries: each ``step()`` splits
    its measured (real clock) or modelled (virtual clock) time into
    prefill-budget spend, decode or verify, copy-on-write and pool write
    accounting, and scheduling. Served at ``/debug/serve/ledger``,
    summarized into ``tpu_serve_step_breakdown_seconds{phase}``, and
    reconciled: the phase sum must track the iteration's time.

    An entry holds the reference's keys and one of the port's own,
    ``detail``, the iteration's change of running totals: the seconds of
    the pool's gauge upkeep (``pool_gauge_s``, in whichever segment it
    fell) and, from an executor that keeps
    :meth:`TorchSlotExecutor.counters`, the decode pass's transfers
    (``decode_wait_s``) and its MoE layers' routed tokens and expert rows
    (``moe_routed_tokens``, ``moe_expert_rows``). These seconds are
    ``perf_counter``'s."""

    def __init__(self, capacity: int = 256) -> None:
        self.capacity = capacity
        self._entries: collections.deque = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, entry: dict) -> None:
        with self._lock:
            self._entries.append(entry)
        for phase, seconds in entry["phases"].items():
            metrics.SERVE_STEP_BREAKDOWN.observe(phase, seconds)

    def entries(self, last: Optional[int] = None) -> list:
        with self._lock:
            out = list(self._entries)
        return out[-last:] if last else out

    def reconcile(self, tolerance_s: float = 0.005,
                  rel: float = 0.02) -> dict:
        """Per entry, ``|sum(phases) - total_s|`` must stay within
        ``max(tolerance_s, rel * total_s)`` (the floor covers the clock's
        granularity between segments, the relative term long stalls).
        Returns the verdict."""
        with self._lock:
            entries = list(self._entries)
        violations = 0
        worst_gap = 0.0
        worst_it = None
        for e in entries:
            gap = abs(sum(e["phases"].values()) - e["total_s"])
            if gap > max(tolerance_s, rel * e["total_s"]):
                violations += 1
            if gap > worst_gap:
                worst_gap, worst_it = gap, e["iteration"]
        return {"checked": len(entries), "violations": violations,
                "maxGapSeconds": round(worst_gap, 6),
                "worstIteration": worst_it, "ok": violations == 0}

    def snapshot(self) -> dict:
        """``/debug/serve/ledger``: the ring and its reconciliation."""
        return {"capacity": self.capacity, "entries": self.entries(),
                "phases": list(LEDGER_PHASES),
                "reconciliation": self.reconcile()}


class Scheduler:
    """Iteration-level continuous-batching scheduler over an executor.

    Drive it with :meth:`step` (one iteration) or :meth:`run` (until
    drained). Without a *clock* time is virtual and advances by the cost
    model; with one (``time.monotonic``) latencies are measured. Every
    admission, preemption, chunk, decode, speculation, fault, retry, rung
    change and outcome is appended to :attr:`trace` as the JAX scheduler
    writes it. *drafter* proposes the drafts when ``config.spec_k > 0``
    (default :class:`NgramDrafter`); *executor* defaults to
    :class:`SimExecutor`.

    Each step runs under ``_state_lock`` (and the *heartbeat*'s task, when
    one is given), so :meth:`snapshot`, :meth:`capacity` and
    :meth:`headroom` may be read from other threads; :meth:`submit` and
    :meth:`submit_now` take only ``_lock``, which guards the arrivals and
    is held for no executor call. Each step records a :class:`StepLedger`
    entry, the request lifecycle lands in the flight ring as phase spans
    (kind ``serve``), and the serve metrics, flight records and Events
    follow the reference's call sites.
    """

    def __init__(self, config: ServeConfig, executor: Optional[Any] = None,
                 cost_model: Optional[CostModel] = None,
                 clock: Optional[Callable[[], float]] = None,
                 heartbeat: Optional[watchdog.Heartbeat] = None,
                 headroom_clock: Optional[Callable[[], float]] = None,
                 drafter: Optional[Any] = None) -> None:
        self.config = config
        self.executor = executor if executor is not None else SimExecutor()
        self.cost = cost_model if cost_model is not None else CostModel()
        self._clock = clock
        self.heartbeat = heartbeat
        self.pool = KvBlockPool(config.kv_blocks, config.kv_block_size,
                                sharing=config.prefix_sharing)
        #: sharing needs an executor whose cache can alias blocks; mapping
        #: without one would share rows a real cache never holds
        self._share = (config.prefix_sharing
                       and getattr(self.executor, "prefix_aware", False))
        self._chunked = config.prefill_chunk_tokens > 0 and not config.static
        if self._chunked and getattr(self.executor, "chunk_capacity",
                                     0) is None:
            raise ValueError(
                "chunked prefill configured but the executor was built "
                "without a chunk width (pass chunk_tokens)")
        self._spec_on = config.spec_k > 0
        if self._spec_on:
            width = getattr(self.executor, "spec_width", None)
            if width is None:
                raise ValueError(
                    "speculative decoding configured but the executor "
                    "has no verify path (pass spec_k to "
                    "TorchSlotExecutor)")
            if width and width < config.spec_k + 1:
                raise ValueError(
                    f"executor verify width {width} cannot score "
                    f"{config.spec_k} drafts (needs spec_k + 1 "
                    "positions)")
        self._drafter = drafter if drafter is not None else NgramDrafter()
        #: the adaptive draft length, with the lifetime proposed /
        #: accepted counts
        self._spec = AdaptiveK(k_max=config.spec_k)
        #: (iteration, row) verify events that carried drafts
        self.spec_rows_total = 0
        self.now = 0.0 if clock is None else clock()
        #: the headroom digest's freshness: a sequence per replica and a
        #: wall-clock stamp (injectable), so a reader can order digests
        self._headroom_seq = 0
        self._headroom_clock: Callable[[], float] = (
            headroom_clock if headroom_clock is not None else time.time)
        #: guards _pending (submit may race the step loop)
        self._lock = threading.Lock()
        #: guards the rest of the state against readers on other threads
        #: (snapshot, capacity, headroom); reentrant, taken before _lock
        self._state_lock = threading.RLock()
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
        #: admitted, then not served (executor error, poisoned, deadline)
        self.failed: list[Request] = []
        self.completed_total = 0
        self.rejected_total = 0
        self.failed_total = 0
        self.poisoned_total = 0
        self.deadline_exceeded_total = 0
        self.retries_total = 0
        self.iterations = 0
        self.preemptions = 0
        self.prefill_chunks_total = 0
        self.prefill_tokens_discarded = 0
        #: retry backoff from a seeded rng, so the jitter, and with it
        #: every readmission order, replays the reference's exactly
        self._retry_policy = RetryPolicy(
            max_attempts=RETRY_BUDGET + 1,
            base=RETRY_BACKOFF_BASE_S,
            cap=RETRY_BACKOFF_CAP_S,
            rng=random.Random(0x5E17E))
        #: fed one signal per iteration: an executor fault this step, or
        #: a firing serve-SLO alert (``slo_alert_fn``)
        self.ladder = degrade.DegradationLadder()
        self.slo_alert_fn: Optional[Callable[[], bool]] = None
        self._fault_this_step = False
        #: (rid, seconds) from a retried request's last fault to its
        #: completion: the serve-path MTTR samples
        self.retry_recoveries: list[tuple[str, float]] = []
        #: when set, trace / completed / rejected / failed keep their last
        #: N entries after each step (a long-lived service); the totals
        #: stay monotone
        self.history_limit: Optional[int] = None
        self.trace: list[tuple] = []
        self._recent_ttft: list[float] = []
        #: the per-iteration cost ledger; under a virtual clock each
        #: modelled advance lands in the phase named by _ledger_phase
        self.ledger = StepLedger()
        self._ledger_phases: Optional[dict] = None
        self._ledger_phase: Optional[str] = None
        #: where the ledger's current segment began
        self._ledger_mark = self.now
        self._update_gauges()

    # -- intake ---------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue an arrival at ``req.arrival_s`` on the scheduler's
        clock; ties are taken in submission order."""
        with self._lock:
            self._seq += 1
            heapq.heappush(self._pending, (req.arrival_s, self._seq, req))

    def submit_all(self, reqs: list) -> None:
        for r in reqs:
            self.submit(r)

    def submit_now(self, req: Request) -> None:
        """Enqueue an arrival at the scheduler's current time: the live
        ingress's entry. Under a real clock the clock itself is read (the
        cached ``now`` moves once an iteration, and a stale stamp would
        bill a request for queueing it never did)."""
        with self._lock:
            req.arrival_s = (self._clock() if self._clock is not None
                             else self.now)
            self._seq += 1
            heapq.heappush(self._pending, (req.arrival_s, self._seq, req))

    # -- one iteration --------------------------------------------------------
    def step(self) -> bool:
        """One iteration. Returns False when nothing is left to do now."""
        with watchdog.task(self.heartbeat), self._state_lock, \
                tracing.profiled("serve.step"):
            return self._step_locked()

    def _step_locked(self) -> bool:
        if self._clock is not None:
            self.now = self._clock()
        self._ingest()
        if not self._active and not self._queued_count():
            nxt = self._next_arrival()
            if nxt is None:
                self._update_gauges()
                return False
            if self._clock is not None:
                self._update_gauges()
                return False  # real clock: nothing due yet
            self.now = max(self.now, nxt)
            self._ingest()
        elif (self._clock is None and not self._active
                and not self._prefilling and self._head() is None):
            # every queued request is held back (retry backoff, or the
            # ladder's interactive-only rung) and nothing runs: move
            # virtual time to the nearest wake-up so backoffs and
            # hold-downs expire, or by one decode quantum without one
            targets = [r.retry_at for q in self._queues.values()
                       for r in q if r.retry_at > self.now]
            nxt = self._next_arrival()
            if nxt is not None and nxt > self.now:
                targets.append(nxt)
            self.now = min(targets) if targets \
                else self.now + self.cost.decode_base_s
            self._ingest()
        self.iterations += 1
        it = self.iterations
        # the ledger: under a real clock _bill charges each segment its
        # measured time (a stalled executor's seconds land in the phase
        # that stalled); under the virtual clock _advance attributes the
        # modelled costs. Each stretch is a profiler range of its own
        phases = dict.fromkeys(LEDGER_PHASES, 0.0)
        self._ledger_phases = phases
        step_start = self._ledger_mark = self._mark()
        counted = self._counted()
        self._ledger_phase = "sched"
        with tracing.profiled("serve.admit"):
            admitted = self._admit(it)
            self._bill("sched")
        # an interleaved iteration's ITL includes the chunks it carried
        iter_start = self.now
        self._ledger_phase = "prefill"
        with tracing.profiled("serve.prefill"):
            if self._chunked:
                for req in admitted:
                    req.state = PREFILLING
                    self._prefilling.append(req)
                self._prefill_pass(it)
            else:
                for req in admitted:
                    prefill_start = self._mark()
                    self._advance(self.cost.prefill_s(
                        req.prefill_target - req.prefill_start))
                    try:
                        tok = self.executor.begin(req, req.slot)
                    except Exception as e:  # noqa: BLE001 — one request's
                        # fault, never the scheduler's
                        self._executor_fault(it, req, e, "prefill")
                        continue
                    req.prefilled = req.prefill_target
                    self._phase_span(
                        req, "serve.prefill", prefill_start, self._mark(),
                        tokens=req.prefill_target - req.prefill_start,
                        offset=req.prefill_start)
                    self._finish_prefill(it, req, tok)
                iter_start = self.now
            self._bill("prefill")
        self._ledger_phase = "sched"
        with tracing.profiled("serve.select"):
            active = sorted((slot, req)
                            for slot, req in self._active.items()
                            if req.state == RUNNING
                            and len(req.tokens) < req.output_len)
            drafts = self._propose(active) if active and self._spec_on \
                else None
            self._bill("sched")
        if active and drafts:
            self._spec_pass(it, active, drafts, iter_start)
        elif active:
            self._decode_pass(it, active, iter_start)
        self._ledger_phase = "sched"
        with tracing.profiled("serve.finish"):
            for slot in sorted(self._active):
                req = self._active[slot]
                if len(req.tokens) >= req.output_len:
                    self._complete(it, req)
                elif req.deadline_s is not None \
                        and self.now > req.deadline_s:
                    # mid-stream: after completion, so a request holding
                    # all its tokens completes rather than expires
                    self._deadline_exceed(it, req)
            self._degrade_pass(it)
            if self.history_limit is not None:
                del self.trace[:-self.history_limit]
                del self.completed[:-self.history_limit]
                del self.rejected[:-self.history_limit]
                del self.failed[:-self.history_limit]
            self._bill("sched")
        with tracing.profiled("serve.gauges"):
            self._update_gauges()
            self._bill("sched")
        self._ledger_phase = None
        self._ledger_phases = None
        self.ledger.record({
            "iteration": it,
            "now_s": round(self.now, 6),
            "activeSlots": len(self._active),
            "queuedRequests": self._queued_count(),
            "chunkBacklogTokens": self._prefill_backlog(),
            "admitted": len(admitted),
            "phases": {k: round(v, 6) for k, v in phases.items()},
            "total_s": round(self._ledger_mark - step_start, 6),
            "preemptionsTotal": self.preemptions,
            "cowCopiesTotal": self.pool.cow_copies,
            "detail": _change(counted, self._counted()),
        })
        return True

    def _counted(self) -> dict:
        """The running totals an iteration's ``detail`` holds the change
        of: the pool's gauge upkeep and, where the executor keeps them,
        its :meth:`TorchSlotExecutor.counters`."""
        out = {"pool_gauge_s": self.pool.gauge_s}
        counters = getattr(self.executor, "counters", None)
        if counters is not None:
            out.update(counters())
        return out

    def _decode_pass(self, it: int, active: list,
                     iter_start: float) -> None:
        """One batched decode iteration; a pass that raises retries one
        victim and commits nothing."""
        self._ledger_phase = "decode"
        with tracing.profiled("serve.decode"):
            self._advance(self.cost.decode_s(len(active)))
            try:
                toks = self.executor.step(active)
            except Exception as e:  # noqa: BLE001 — the batch loses one
                # iteration and one victim retries
                toks = None
                self._step_fault(it, "decode", active, e)
            self._tick()
            self._bill("decode")
        self._ledger_phase = "cow"
        with tracing.profiled("serve.commit"):
            # the measured iteration under a real clock (a stall is a
            # stall), the modelled one, chunks included, under the virtual
            # clock
            metrics.SERVE_ITL_SECONDS.observe(
                self.now - iter_start, exemplar=self._exemplar(active))
            for slot, req in (active if toks is not None else ()):
                if self._share:
                    self._write(it, req, req.prompt_len + len(req.tokens))
                req.tokens.append(toks[slot])
                req.decode_iters += 1
                self.pool.set_used_tokens(
                    req.rid, req.prompt_len + len(req.tokens))
                self._notify(req, "token", toks[slot])
            if toks is not None:
                metrics.SERVE_TOKENS.inc(len(active), phase="decode")
            self._bill("cow")
        if toks is not None:
            self.trace.append(("decode", it, len(active)))

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
            # the virtual ledger: the modelled cost lands in the phase
            # the step is in
            if self._ledger_phases is not None and self._ledger_phase:
                self._ledger_phases[self._ledger_phase] += cost_s

    def _tick(self) -> None:
        if self._clock is not None:
            self.now = self._clock()

    def _mark(self) -> float:
        """The ledger's and the phase spans' clock: the real clock when
        there is one, else the virtual time (already advanced)."""
        return self._clock() if self._clock is not None else self.now

    def _bill(self, phase: str) -> float:
        """Close a ledger segment at the clock: under a real clock the
        time since the last mark is charged to *phase*. The segments tile
        the iteration, so its phases sum to its total whatever else the
        host ran between them (under the virtual clock _advance has
        charged the modelled costs already). Returns the segment's
        length."""
        now = self._mark()
        spent = now - self._ledger_mark
        if self._clock is not None and self._ledger_phases is not None:
            self._ledger_phases[phase] += spent
        self._ledger_mark = now
        return spent

    def _next_arrival(self) -> Optional[float]:
        with self._lock:
            return self._pending[0][0] if self._pending else None

    def _queued_count(self) -> int:
        return sum(len(q) for q in self._queues.values())

    @staticmethod
    def _exemplar(active: list) -> Optional[dict]:
        trace_id = active[0][1].trace_id
        return {"trace_id": trace_id} if trace_id else None

    def _write(self, it: int, req: Request, pos: int) -> None:
        """Account a decode or verify write under sharing. A copy the full
        pool cannot make proceeds uncopied rather than stall (a stalled
        request frees nothing), and the trace says so."""
        wrote = self.pool.write_token(req.rid, pos)
        if wrote is None:
            self.trace.append(("cow_uncopied", it, req.rid))
        elif wrote:
            self._phase_span(req, "serve.cow", self.now, self.now, pos=pos)

    def _notify(self, req: Request, event: str, value: object) -> None:
        """Call the request's stream; a failing sink is dropped, never
        allowed to take the scheduler down."""
        if req.stream is None:
            return
        try:
            req.stream(event, value)
        except Exception:  # noqa: BLE001 — the client's fault
            log.warning("stream callback for %s failed on %r", req.rid,
                        event, exc_info=True)
            req.stream = None

    # -- request-lifecycle tracing --------------------------------------------
    def _ensure_trace(self, req: Request) -> None:
        """A request without the ingress's trace gets a deterministic one
        from its rid, so seeded runs replay the same span tree."""
        if req.trace_id is None:
            req.trace_id = tracing.det_trace_id(req.rid)

    def _phase_span(self, req: Request, name: str, start_s: float,
                    end_s: float, **attrs: object) -> None:
        """One lifecycle phase span in the flight ring (kind ``serve``,
        the request's trace id, a deterministic span id), timed on the
        scheduler's clock."""
        self._ensure_trace(req)
        assert req.trace_id is not None
        span_id = tracing.det_span_id(req.trace_id, req.rid, req.span_seq)
        req.span_seq += 1
        attributes = {"rid": req.rid, "start_s": f"{start_s:.6f}"}
        if req.parent_span_id:
            attributes["parent_span_id"] = req.parent_span_id
        attributes.update({k: str(v) for k, v in attrs.items()})
        flight.record("serve", name, trace_id=req.trace_id,
                      span_id=span_id,
                      duration_s=round(max(0.0, end_s - start_s), 6),
                      attributes=attributes)

    def _close_open_phase(self, req: Request, outcome: str) -> None:
        """End the phase *req* is in (its decode residency or its wait),
        so an abandoned or failed request still shows a whole timeline."""
        if req.decode_since_s is not None:
            self._phase_span(
                req, "serve.decode", req.decode_since_s, self.now,
                iterations=req.decode_iters, tokens=len(req.tokens),
                outcome=outcome)
            req.decode_since_s = None
        elif req.queued_since_s is not None and req.slot is None:
            self._phase_span(
                req, "serve.preempted" if req.preemptions
                else "serve.queued",
                req.queued_since_s, self.now, outcome=outcome)
            req.queued_since_s = None

    # -- speculative decoding -------------------------------------------------
    def _propose(self, active: list) -> Optional[dict]:
        """The speculate-or-decode decision and each row's drafts: the
        adaptive k from the cost model and the acceptance EWMA; k = 0, no
        row with a draft, or the ladder at its no-speculation rung returns
        None (plain decode)."""
        if self.ladder.rung >= degrade.RUNG_NO_SPEC:
            return None
        k = self._spec.choose(self.cost, len(active))
        if k <= 0:
            return None
        drafts: dict = {}
        for slot, req in active:
            # a row emits up to drafts + 1 tokens: never draft past the
            # request's remaining output (or its KV reservation)
            remaining = req.output_len - len(req.tokens)
            if remaining <= 1:
                continue
            ids = list(req.prompt or ()) + list(req.tokens)
            d = self._drafter.propose(ids, min(k, remaining - 1))
            if d:
                drafts[slot] = [int(t) for t in d]
        return drafts or None

    def _spec_pass(self, it: int, active: list, drafts: dict,
                   iter_start: float) -> None:
        """One verify iteration: the executor scores every row's drafts in
        one pass, and each row's accepted + 1 tokens commit. Under sharing
        every speculated position is written at verify time (so
        copy-on-write fires when the divergent write happens) and the
        written frontier rolls back past the accepted tokens. A pass that
        raises commits nothing and retries one victim."""
        k_iter = max(len(d) for d in drafts.values())
        self._ledger_phase = "verify"
        with tracing.profiled("serve.verify"):
            self._advance(self.cost.verify_s(len(active), k_iter))
            try:
                emitted = self.executor.spec_step(active, drafts)
            except Exception as e:  # noqa: BLE001 — as the decode pass
                self._step_fault(it, "verify", active, e)
                self._tick()
                self._bill("verify")
                return
            self._tick()
            verify_s = self._bill("verify")
        self._ledger_phase = "cow"
        with tracing.profiled("serve.commit"):
            metrics.SERVE_SPEC_VERIFY_SECONDS.observe(verify_s)
            metrics.SERVE_ITL_SECONDS.observe(
                self.now - iter_start, exemplar=self._exemplar(active))
            committed = 0
            for slot, req in active:
                toks = emitted[slot]
                proposed = len(drafts.get(slot, ()))
                accepted = len(toks) - 1
                base = req.prompt_len + len(req.tokens)
                if self._share:
                    for i in range(proposed + 1):
                        self._write(it, req, base + i)
                    self.pool.set_used_tokens(req.rid, base + proposed + 1)
                req.tokens.extend(toks)
                req.decode_iters += 1
                used = req.prompt_len + len(req.tokens)
                if self._share and accepted < proposed:
                    self.pool.rollback_tokens(req.rid, used)
                self.pool.set_used_tokens(req.rid, used)
                committed += len(toks)
                for tok in toks:
                    self._notify(req, "token", tok)
                if proposed:
                    self._spec.observe(proposed, accepted)
                    self.spec_rows_total += 1
                    metrics.SERVE_SPEC_TOKENS.inc(proposed,
                                                  outcome="proposed")
                    metrics.SERVE_SPEC_TOKENS.inc(accepted,
                                                  outcome="accepted")
                    metrics.SERVE_SPEC_TOKENS.inc(proposed - accepted,
                                                  outcome="rejected")
                    self.trace.append(("spec", it, req.rid, proposed,
                                       accepted))
            if committed:
                metrics.SERVE_TOKENS.inc(committed, phase="decode")
            metrics.SERVE_SPEC_ACCEPTANCE.set(self._spec.acceptance_rate())
            self._bill("cow")
        self.trace.append(("decode", it, len(active)))

    # -- admission ------------------------------------------------------------
    def _reject(self, req: Request, reason: str, message: str) -> None:
        """Refuse an arrival: counted, flight-recorded, and a
        ``ServeAdmissionRejected`` Event whose message leads with the
        machine-readable reason."""
        self._ensure_trace(req)
        req.state = REJECTED
        req.reject_reason = reason
        self.rejected.append(req)
        self.rejected_total += 1
        self.trace.append(("reject", self.iterations + 1, req.rid,
                           req.slo_class, reason))
        metrics.SERVE_ADMISSION_REJECTED.inc(slo_class=req.slo_class,
                                             reason=reason)
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="rejected")
        flight.record("serve", "AdmissionRejected", trace_id=req.trace_id,
                      attributes={"rid": req.rid, "class": req.slo_class,
                                  "reason": reason})
        watchdog.emit_health_event(
            "ServeAdmissionRejected", f"[{reason}] {message}", "Warning",
            series=f"serve-admission/{req.slo_class}")
        self._notify(req, "rejected", reason)

    def _ingest(self) -> None:
        """Move due arrivals into their class queue, rejecting duplicate
        ids, reservations larger than the whole pool, batch arrivals while
        the ladder sheds them, and arrivals past the queue bound. A
        deadline budget becomes an absolute instant here."""
        while True:
            with self._lock:
                if not self._pending or self._pending[0][0] > self.now:
                    return
                _, _, req = heapq.heappop(self._pending)
            if req.rid in self._live_rids:
                self._reject(req, "duplicate_rid",
                             f"request id {req.rid!r} is already live; "
                             "a second request under the same id would "
                             "merge both requests' KV accounting")
                continue
            if self.pool.blocks_for_tokens(req.total_tokens()) \
                    > self.pool.num_blocks:
                self._reject(req, "kv_too_large",
                             f"request {req.rid} needs "
                             f"{req.total_tokens()} KV token slots; the "
                             f"whole pool holds "
                             f"{self.pool.num_blocks * self.pool.block_size}")
                continue
            if req.deadline_budget_s is not None and req.deadline_s is None:
                req.deadline_s = req.arrival_s + req.deadline_budget_s
            if req.slo_class == BATCH \
                    and self.ladder.rung >= degrade.RUNG_SHED_BATCH:
                self._reject(req, "degraded_shed",
                             f"serving degraded to rung "
                             f"{self.ladder.rung} "
                             f"({self.ladder.rung_name}); batch-class "
                             "admissions shed until recovery")
                continue
            if len(self._queues[req.slo_class]) >= self.config.queue_limit:
                self._reject(req, "queue_full",
                             f"serve admission queue for class "
                             f"{req.slo_class} is full "
                             f"({self.config.queue_limit}); rejecting "
                             "new requests (service saturated)")
            else:
                self._ensure_trace(req)
                req.queued_since_s = req.arrival_s
                self._queues[req.slo_class].append(req)
                self._live_rids.add(req.rid)

    def _head(self) -> Optional[Request]:
        """The first admittable request in class order, skipping requests
        held back by a retry backoff and, at the ladder's interactive-only
        rung, the whole batch queue (they stay queued)."""
        for cls in (INTERACTIVE, BATCH):
            if cls == BATCH \
                    and self.ladder.rung >= degrade.RUNG_INTERACTIVE_ONLY:
                continue
            for r in self._queues[cls]:
                if r.retry_at <= self.now:
                    return r
        return None

    def _admit(self, it: int) -> list:
        """Admission: the head request, in class order, into the lowest
        free slot with its whole sequence's blocks reserved; with sharing
        its indexed prefix blocks are mapped and only the rest allocated.
        A head whose least finish time already misses its deadline is
        excised. An interactive head that does not fit preempts batch
        requests; otherwise admission stops at the first head that does
        not fit. Returns the requests admitted (prefill pending)."""
        if self.config.static and self._active:
            return []
        admitted: list[Request] = []
        while self._free_slots or self._can_preempt_for_head():
            req = self._head()
            if req is None:
                break
            if req.deadline_s is not None \
                    and self._eta_s(req) > req.deadline_s:
                self._deadline_exceed(it, req)
                continue
            blocks = self.pool.blocks_for_tokens(req.total_tokens())
            keys: list = []
            if self._share and req.prompt:
                if req.prefix_keys is None:
                    req.prefix_keys = chain_keys(req.prompt,
                                                 self.pool.block_size)
                # never map more than the reservation
                keys = req.prefix_keys[:blocks]
            fresh = blocks - self.pool.probe_prefix(keys)
            if not self._free_slots or not self.pool.can_alloc(fresh):
                if not (req.slo_class == INTERACTIVE
                        and self.config.preemption
                        and self._preempt_for(it, req, fresh)):
                    break
                # a victim may have held the last reference of an indexed
                # block: size the fresh ask again
                fresh = blocks - self.pool.probe_prefix(keys)
                if not self._free_slots \
                        or not self.pool.can_alloc(fresh):
                    break
            mapped = self.pool.map_prefix(req.rid, keys)
            if self.pool.alloc(req.rid, blocks - mapped) is None:
                self.pool.free(req.rid)  # roll the mapping back
                break
            req.shared_tokens = min(mapped * self.pool.block_size,
                                    req.prompt_len)
            if self._share and mapped and req.tokens:
                # re-admission after a preemption: the kept tokens
                # re-prefill past the prompt, possibly into a just-mapped
                # shared tail block, so copy it before the executor writes
                for pos in range(req.prompt_len,
                                 req.prompt_len + len(req.tokens)):
                    if self.pool.write_token(req.rid, pos) is None:
                        log.warning("kv pool exhausted at CoW for %s "
                                    "re-admission; divergence proceeds "
                                    "uncopied", req.rid)
                        break
            self._queues[req.slo_class].remove(req)
            slot = self._free_slots.pop(0)
            req.slot = slot
            req.state = RUNNING
            req.admitted_s = self.now
            # the wait ends: serve.queued after arrival, serve.preempted
            # after an eviction
            wait_start = (req.queued_since_s
                          if req.queued_since_s is not None
                          else req.arrival_s)
            self._phase_span(
                req, "serve.preempted" if req.preemptions
                else "serve.queued",
                wait_start, self.now, slo_class=req.slo_class, slot=slot,
                **({"preemptions": req.preemptions}
                   if req.preemptions else {}))
            req.queued_since_s = None
            req.prefill_target = req.prompt_len + len(req.tokens)
            # shared coverage is KV already computed: prefill resumes past
            # it, always leaving one token whose logits pick the next one
            req.prefill_start = min(req.shared_tokens,
                                    req.prefill_target - 1)
            req.prefilled = req.prefill_start
            self._active[slot] = req
            admitted.append(req)
            self.trace.append(("admit", it, req.rid, req.slo_class, slot,
                               blocks - mapped, mapped))
        return admitted

    def _can_preempt_for_head(self) -> bool:
        req = self._head()
        return (req is not None and req.slo_class == INTERACTIVE
                and self.config.preemption
                and any(r.slo_class == BATCH
                        for r in self._active.values()))

    def _preempt_for(self, it: int, req: Request, blocks: int) -> bool:
        """Evict batch requests, latest-admitted first, until *req* fits
        (a free slot and *blocks* fresh blocks). A victim keeps its tokens
        and goes back to the front of the batch queue; its KV is computed
        again on re-admission. One caught mid-prefill leaves the chunk
        queue, and its chunk progress since admission counts as discarded
        prefill work. Returns whether *req* now fits."""
        victims = sorted(
            (r for r in self._active.values() if r.slo_class == BATCH),
            key=lambda r: (-(r.admitted_s or 0.0), r.rid))
        progressed = False
        for victim in victims:
            if self._free_slots and self.pool.can_alloc(blocks):
                break
            slot = victim.slot
            self.pool.free(victim.rid)
            del self._active[slot]
            self._free_slots.append(slot)
            self._free_slots.sort()
            victim.slot = None
            discarded = 0
            phase = "decode"
            if victim in self._prefilling:
                self._prefilling.remove(victim)
                phase = "prefill"
                discarded = max(0, victim.prefilled - victim.prefill_start)
                if discarded:
                    self.prefill_tokens_discarded += discarded
                    metrics.SERVE_PREFILL_CHUNK_TOKENS.inc(
                        discarded, outcome="discarded")
            if phase == "decode" and victim.decode_since_s is not None:
                self._phase_span(
                    victim, "serve.decode", victim.decode_since_s,
                    self.now, iterations=victim.decode_iters,
                    tokens=len(victim.tokens), outcome="preempted")
            victim.decode_since_s = None
            victim.decode_iters = 0
            victim.queued_since_s = self.now
            victim.prefilled = 0
            victim.state = QUEUED
            victim.preemptions += 1
            self.preemptions += 1
            self._queues[BATCH].insert(0, victim)
            progressed = True
            self.trace.append(("preempt", it, victim.rid, req.rid, phase,
                               discarded))
            metrics.SERVE_PREEMPTIONS.inc(reason="kv_pressure")
            flight.record("serve", "Preempted", trace_id=victim.trace_id,
                          attributes={
                              "rid": victim.rid, "for": req.rid,
                              "phase": phase,
                              "tokens_done": str(len(victim.tokens)),
                              "prefill_discarded": str(discarded)})
            watchdog.emit_health_event(
                "ServePreempted",
                f"batch-class request {victim.rid} evicted "
                f"(recomputable, {phase} phase) to admit interactive "
                f"{req.rid} under KV/slot pressure", "Normal",
                series="serve-preempt")
        return progressed and bool(self._free_slots) \
            and self.pool.can_alloc(blocks)

    # -- prefill --------------------------------------------------------------
    def _prefill_pass(self, it: int) -> None:
        """Spend this iteration's prefill budget over the chunk queue:
        interactive first, FIFO within a class, the head served to the end
        of its prompt before the next. A request whose deadline has passed
        is excised instead of served. A request whose last chunk lands
        takes its first token now and joins this iteration's decode."""
        budget = self.config.prefill_chunk_tokens
        cap = self.executor.chunk_capacity or budget
        order = ([r for r in self._prefilling if r.slo_class == INTERACTIVE]
                 + [r for r in self._prefilling if r.slo_class == BATCH])
        for req in order:
            if req.deadline_s is not None and self.now > req.deadline_s:
                self._deadline_exceed(it, req)
                continue
            while budget > 0:
                remaining = req.prefill_target - req.prefilled
                if remaining <= 0:
                    break
                n = min(budget, remaining, cap)
                chunk_start = self._mark()
                self._advance(self.cost.prefill_s(n))
                try:
                    tok = self.executor.prefill_chunk(req, req.slot,
                                                      req.prefilled, n)
                except Exception as e:  # noqa: BLE001 — the request's
                    # fault alone: left queued it would raise every
                    # iteration
                    self._executor_fault(it, req, e, "prefill")
                    break
                self._phase_span(req, "serve.prefill_chunk", chunk_start,
                                 self._mark(), tokens=n,
                                 offset=req.prefilled, iteration=it)
                req.prefilled += n
                self.pool.set_used_tokens(req.rid, req.prefilled)
                budget -= n
                self.prefill_chunks_total += 1
                metrics.SERVE_PREFILL_CHUNKS.inc()
                metrics.SERVE_PREFILL_CHUNK_TOKENS.inc(n,
                                                       outcome="prefilled")
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
        """The prompt is in the cache: publish its blocks in the prefix
        index, account the first token's write, append the token, open the
        decode residency and stamp TTFT. A missing token is the executor
        breaking its contract and fails the request (left active it would
        hold its slot forever)."""
        if tok is None:
            self._fail(it, req, RuntimeError(
                f"executor returned no token for {req.rid}'s final "
                "prefill chunk"))
            return
        self._tick()
        req.state = RUNNING
        first = not req.tokens
        if self._share and req.prefix_keys:
            # before the first token's write, which lands past the keys'
            # coverage and so cannot unpublish them
            self.pool.register_prefix(req.rid, req.prefix_keys,
                                      req.prompt_len)
        if self._share:
            pos = req.prompt_len + len(req.tokens)
            wrote = self.pool.write_token(req.rid, pos)
            if wrote is None:
                log.warning("kv pool exhausted at CoW for %s; divergence "
                            "proceeds uncopied", req.rid)
            elif wrote:
                self._phase_span(req, "serve.cow", self.now, self.now,
                                 pos=pos)
        req.decode_since_s = self.now
        req.decode_iters = 0
        req.tokens.append(tok)
        self.pool.set_used_tokens(req.rid, req.prompt_len + len(req.tokens))
        metrics.SERVE_TOKENS.inc(phase="prefill")
        if first:
            req.first_token_s = self.now
            self._record_first_token(req)
        self._notify(req, "token", tok)

    def _record_first_token(self, req: Request) -> None:
        ttft = req.ttft_s or 0.0
        metrics.SERVE_TTFT_SECONDS.observe(
            ttft, exemplar=({"trace_id": req.trace_id}
                            if req.trace_id else None))
        self._recent_ttft.append(ttft)
        del self._recent_ttft[:-64]
        flight.record("serve", "FirstToken", trace_id=req.trace_id,
                      attributes={"rid": req.rid, "class": req.slo_class,
                                  "ttft_s": f"{ttft:.6f}"})

    # -- cancel ---------------------------------------------------------------
    def cancel(self, rid: str) -> bool:
        """Abandon a live request wherever it is (pending, queued,
        prefilling or decoding), freeing its slot and blocks: the ingress
        calls it when a client's stream times out or drops. Returns
        whether anything was cancelled."""
        with self._state_lock:
            pending_hit = None
            with self._lock:
                for i, (_, _, r) in enumerate(self._pending):
                    if r.rid == rid:
                        self._pending.pop(i)
                        heapq.heapify(self._pending)
                        pending_hit = r
                        break
            if pending_hit is not None:
                self._record_cancel(pending_hit)
                return True
            req = None
            for q in self._queues.values():
                for r in q:
                    if r.rid == rid:
                        req = r
                        q.remove(r)
                        break
            if req is None:
                req = next((r for r in self._active.values()
                            if r.rid == rid), None)
            if req is None:
                return False
            self._close_open_phase(req, "cancelled")
            self._release(req)
            self._record_cancel(req)
            self._update_gauges()
            return True

    def _record_cancel(self, req: Request) -> None:
        req.state = REJECTED
        req.reject_reason = "cancelled"
        self.rejected.append(req)
        self.rejected_total += 1
        self.trace.append(("cancel", self.iterations, req.rid))
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="cancelled")
        flight.record("serve", "Cancelled", trace_id=req.trace_id,
                      attributes={"rid": req.rid})

    # -- the fault engine -----------------------------------------------------
    def _eta_s(self, req: Request) -> float:
        """The least finish time of *req* admitted now: its remaining
        prefill plus one uncontended decode iteration a remaining token.
        Real service is slower, so a deadline this misses is missed."""
        prefill_tokens = max(
            0, req.prompt_len + len(req.tokens) - req.prefilled)
        remaining = max(0, req.output_len - len(req.tokens))
        return (self.now + self.cost.prefill_s(prefill_tokens)
                + remaining * self.cost.decode_s(1))

    def _step_fault(self, it: int, phase: str, active: list,
                    exc: Exception) -> None:
        """A batched pass raised: blame ONE victim, the rid the exception
        names (``exc.rid``) when it is in the batch, else the
        latest-admitted request (least progress, cheapest rebuild), and
        retry it with rebuild. The rest of the batch loses one
        iteration."""
        self._fault_this_step = True
        metrics.SERVE_EXECUTOR_FAULTS.inc(phase=phase)
        rid = getattr(exc, "rid", None)
        victim = next((r for _, r in active if r.rid == rid), None)
        if victim is None:
            victim = max((r for _, r in active),
                         key=lambda r: ((r.admitted_s or 0.0), r.rid))
        self.trace.append(("step_fault", it, phase, victim.rid,
                           type(exc).__name__))
        self._retry_request(it, victim, exc, phase)

    def _executor_fault(self, it: int, req: Request, exc: Exception,
                        phase: str) -> None:
        """One request's executor call raised: a contract breach
        (``ValueError`` / ``TypeError``: a bad spec, no prompt ids) can
        never succeed and fails the request; anything else is presumed
        transient and retries with rebuild."""
        self._fault_this_step = True
        metrics.SERVE_EXECUTOR_FAULTS.inc(phase=phase)
        if isinstance(exc, (ValueError, TypeError)):
            self._fail(it, req, exc)
        else:
            self._retry_request(it, req, exc, phase)

    def _retry_request(self, it: int, req: Request, exc: Exception,
                       phase: str) -> None:
        """Retry with rebuild: the victim takes a preemption's
        recomputable eviction (blocks freed, tokens kept, prefill again on
        readmission) and goes back to the front of its class queue, held
        back until a backoff on the scheduler's clock expires. A request
        past its retry budget is poisoned instead."""
        req.retries += 1
        req.last_fault_s = self.now
        if req.retries > RETRY_BUDGET:
            self._poison_request(it, req, exc)
            return
        log.warning("executor %s fault for %s (retry %d/%d, rebuilding): "
                    "%s", phase, req.rid, req.retries,
                    RETRY_BUDGET, exc)
        self.pool.free(req.rid)
        if req.slot is not None:
            self._active.pop(req.slot, None)
            self._free_slots.append(req.slot)
            self._free_slots.sort()
            req.slot = None
        if req in self._prefilling:
            self._prefilling.remove(req)
            discarded = max(0, req.prefilled - req.prefill_start)
            if discarded:
                self.prefill_tokens_discarded += discarded
                metrics.SERVE_PREFILL_CHUNK_TOKENS.inc(
                    discarded, outcome="discarded")
        elif req.decode_since_s is not None:
            self._phase_span(
                req, "serve.decode", req.decode_since_s, self.now,
                iterations=req.decode_iters, tokens=len(req.tokens),
                outcome="retried")
        req.decode_since_s = None
        req.decode_iters = 0
        req.queued_since_s = self.now
        req.prefilled = 0
        req.state = QUEUED
        req.retry_at = self.now \
            + self._retry_policy.backoff(req.retries - 1)
        self._queues[req.slo_class].insert(0, req)
        self.retries_total += 1
        self.trace.append(("retry", it, req.rid, req.retries))
        metrics.SERVE_RETRIES.inc(phase=phase)
        flight.record("serve", "RetryScheduled", trace_id=req.trace_id,
                      attributes={
                          "rid": req.rid, "attempt": str(req.retries),
                          "phase": phase,
                          "tokens_kept": str(len(req.tokens)),
                          "error": f"{type(exc).__name__}: {exc}"})

    def _poison_request(self, it: int, req: Request,
                        exc: Exception) -> None:
        """Excise a request that failed past its retry budget (the same
        rid failing on every attempt is a poisoned request, not a sick
        executor): slot and blocks freed, outcome ``poisoned``."""
        log.warning("request %s poisoned after %d retries (excising): %s",
                    req.rid, req.retries - 1, exc)
        self._close_open_phase(req, "poisoned")
        self._release(req)
        req.state = FAILED
        req.reject_reason = "poisoned"
        self.failed.append(req)
        self.failed_total += 1
        self.poisoned_total += 1
        self.trace.append(("poison", it, req.rid, req.retries - 1))
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="poisoned")
        metrics.SERVE_POISONED.inc()
        flight.record("serve", "Poisoned", trace_id=req.trace_id,
                      attributes={
                          "rid": req.rid,
                          "retries": str(req.retries - 1),
                          "error": f"{type(exc).__name__}: {exc}"})
        watchdog.emit_health_event(
            "ServeRequestPoisoned",
            f"request {req.rid} failed the executor on every attempt "
            f"({req.retries - 1} rebuilds); excised so it cannot "
            "crash-loop the step", "Warning", series="serve-poison")
        self._notify(req, "failed", "poisoned")

    def _deadline_exceed(self, it: int, req: Request) -> None:
        """Excise a request that can no longer meet its deadline, wherever
        it is (queued, prefilling, decoding), keeping the tokens it has."""
        q = self._queues[req.slo_class]
        if req in q:
            q.remove(req)
        self._close_open_phase(req, "deadline_exceeded")
        self._release(req)
        req.state = FAILED
        req.reject_reason = "deadline_exceeded"
        self.failed.append(req)
        self.failed_total += 1
        self.deadline_exceeded_total += 1
        self.trace.append(("deadline", it, req.rid, len(req.tokens)))
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="deadline_exceeded")
        flight.record("serve", "DeadlineExceeded", trace_id=req.trace_id,
                      attributes={"rid": req.rid,
                                  "tokens_done": str(len(req.tokens))})
        self._notify(req, "deadline_exceeded", len(req.tokens))

    def _degrade_pass(self, it: int) -> None:
        """Feed the ladder this iteration's signal (an executor fault, or
        a firing serve-SLO alert) and publish a committed rung change:
        gauge, trace tuple, flight record and Event."""
        bad = self._fault_this_step
        self._fault_this_step = False
        if not bad and self.slo_alert_fn is not None:
            try:
                bad = bool(self.slo_alert_fn())
            except Exception:  # noqa: BLE001 — a broken probe must not
                # stop the step loop
                log.warning("serve slo_alert_fn failed", exc_info=True)
                metrics.SWALLOWED_ERRORS.inc(site="serve.slo_alert")
        change = self.ladder.observe(self.now, bad)
        metrics.SERVE_DEGRADED_RUNG.set(float(self.ladder.rung))
        if change is None:
            return
        self.trace.append(("rung", it, change.old, change.new))
        names = degrade.RUNGS
        if change.new > change.old:
            flight.record("serve", "Degraded", attributes={
                "from": names[change.old], "to": names[change.new]})
            watchdog.emit_health_event(
                "ServeDegraded",
                f"serving degraded {names[change.old]} -> "
                f"{names[change.new]} (rung {change.new}) under "
                "sustained executor faults or serve-SLO burn",
                "Warning", series="serve-degrade")
        else:
            flight.record("serve", "Recovered", attributes={
                "from": names[change.old], "to": names[change.new]})
            watchdog.emit_health_event(
                "ServeRecovered",
                f"serving recovered {names[change.old]} -> "
                f"{names[change.new]} (rung {change.new})",
                "Normal", series="serve-degrade")

    # -- teardown -------------------------------------------------------------
    def _release(self, req: Request) -> None:
        """Free chunk-queue entry, slot and KV blocks: the one teardown
        that completion, failure, poisoning, deadlines and cancel share."""
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
        """A request the executor cannot serve fails alone, with outcome
        ``executor_error``."""
        log.warning("executor failed for %s (failing the request): %s",
                    req.rid, exc)
        metrics.SWALLOWED_ERRORS.inc(site="serve.executor")
        self._close_open_phase(req, "failed")
        self._release(req)
        req.state = FAILED
        req.reject_reason = "executor_error"
        self.failed.append(req)
        self.failed_total += 1
        self.trace.append(("fail", it, req.rid))
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="failed")
        flight.record("serve", "ExecutorFailed", trace_id=req.trace_id,
                      attributes={"rid": req.rid,
                                  "error": f"{type(exc).__name__}: {exc}"})
        self._notify(req, "failed", "executor_error")

    def _complete(self, it: int, req: Request) -> None:
        if req.decode_since_s is not None:
            self._phase_span(
                req, "serve.decode", req.decode_since_s, self.now,
                iterations=req.decode_iters, tokens=len(req.tokens),
                outcome="complete")
            req.decode_since_s = None
        self._release(req)
        req.state = DONE
        req.finish_s = self.now
        if req.retries and req.last_fault_s is not None:
            self.retry_recoveries.append(
                (req.rid, self.now - req.last_fault_s))
        self.completed.append(req)
        self.completed_total += 1
        self.trace.append(("complete", it, req.rid, len(req.tokens)))
        metrics.SERVE_REQUESTS.inc(slo_class=req.slo_class,
                                   outcome="completed")
        flight.record("serve", "Completed", trace_id=req.trace_id,
                      attributes={"rid": req.rid, "class": req.slo_class,
                                  "tokens": str(len(req.tokens)),
                                  "preemptions": str(req.preemptions)})
        self._notify(req, "done", len(req.tokens))

    # -- gauges and capacity --------------------------------------------------
    def _prefill_backlog(self) -> int:
        return sum(max(0, r.prefill_target - r.prefilled)
                   for r in self._prefilling)

    def _update_gauges(self) -> None:
        """The queue, slot and backlog gauges and the scheduler's headroom
        dimensions, from values in hand, every step."""
        for cls in (INTERACTIVE, BATCH):
            metrics.SERVE_QUEUE_DEPTH.set(float(len(self._queues[cls])),
                                          slo_class=cls)
            metrics.SERVE_ACTIVE.set(
                float(sum(1 for r in self._active.values()
                          if r.slo_class == cls)), slo_class=cls)
        free_slots = len(self._free_slots)
        backlog = self._prefill_backlog()
        metrics.SERVE_SLOTS.set(float(free_slots), state="free")
        metrics.SERVE_SLOTS.set(float(len(self._active)), state="active")
        metrics.SERVE_PREFILL_BACKLOG.set(float(backlog))
        free_blocks = self.pool.free_blocks()
        metrics.SERVE_HEADROOM.set(float(free_slots),
                                   dimension="free_slots")
        metrics.SERVE_HEADROOM.set(
            float(self._advertisable(free_slots, free_blocks)),
            dimension="advertisable_slots")
        metrics.SERVE_HEADROOM.set(float(free_blocks),
                                   dimension="free_kv_blocks")
        metrics.SERVE_HEADROOM.set(float(backlog),
                                   dimension="chunk_backlog_tokens")
        metrics.SERVE_HEADROOM.set(
            float(self.pool.prefix_index_keys() if self._share else 0),
            dimension="prefix_index_keys")
        metrics.SERVE_HEADROOM.set(float(self.ladder.rung),
                                   dimension="degraded_rung")

    def _advertisable(self, free_slots: int, free_blocks: int) -> int:
        """Free slots derated so each is backed by the KV blocks of a
        typical request, then by the ladder: a quarter of the slots from
        the shrink-slots rung, none at interactive-only."""
        typical = self.pool.blocks_for_tokens(TYPICAL_TOKENS)
        slots = min(free_slots, free_blocks // max(typical, 1))
        if self.ladder.rung >= degrade.RUNG_INTERACTIVE_ONLY:
            return 0
        if self.ladder.rung >= degrade.RUNG_SHRINK_SLOTS:
            return min(slots, max(1, self.config.slots // 4))
        return slots

    def capacity(self) -> dict:
        """What the device plugin advertises: slots that could take a
        request now, derated by :meth:`_advertisable`."""
        with self._state_lock:
            free_slots = len(self._free_slots)
        free_blocks = self.pool.free_blocks()
        return {
            "slots": self.config.slots,
            "freeSlots": free_slots,
            "freeKvBlocks": free_blocks,
            "advertisableSlots": self._advertisable(free_slots,
                                                    free_blocks),
        }

    def headroom(self) -> dict:
        """The headroom digest's scheduler-owned dimensions: free
        capacity, the prefill backlog, the queues and the reusable prefix
        KV, with a sequence and a stamp. :meth:`DecodeService.headroom`
        folds in the SLO alerts, the fault-gate capacity and the trend
        engine's anomalies."""
        with self._state_lock:
            cap = self.capacity()
            backlog = self._prefill_backlog()
            queued = {cls: len(q) for cls, q in self._queues.items()}
            # under the state lock: concurrent readers get distinct,
            # ordered sequences
            self._headroom_seq += 1
            seq = self._headroom_seq
        return {
            "sequence": seq,
            "asOf": round(self._headroom_clock(), 6),
            "slots": self.config.slots,
            "freeSlots": cap["freeSlots"],
            "advertisableSlots": cap["advertisableSlots"],
            "freeKvBlocks": cap["freeKvBlocks"],
            "chunkBacklogTokens": backlog,
            "queueDepth": queued,
            "prefixIndexKeys": self.pool.prefix_index_keys(),
            "degradedRung": self.ladder.rung,
        }

    def serving_summary(self) -> dict:
        """The digest's serving dimensions: the ladder's rung and the
        speculative acceptance rate."""
        with self._state_lock:
            return {
                "degradedRung": self.ladder.rung,
                "degradedRungName": degrade.RUNGS[self.ladder.rung],
                "specKMax": self.config.spec_k,
                "specAcceptanceRate": round(
                    self._spec.acceptance_rate(), 4),
            }

    def snapshot(self) -> dict:
        """``/debug/serve``: taken under the state lock, so a reader on
        another thread never iterates state the step loop is changing."""
        with self._state_lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        queued = {cls: [r.rid for r in q]
                  for cls, q in self._queues.items()}
        active = {cls: sorted(r.rid for r in self._active.values()
                              if r.slo_class == cls)
                  for cls in (INTERACTIVE, BATCH)}
        return {
            "now_s": round(self.now, 6),
            "iterations": self.iterations,
            "active": active,
            "queued": queued,
            "queueDepth": {cls: len(q)
                           for cls, q in self._queues.items()},
            "kv": self.pool.snapshot(),
            "capacity": self.capacity(),
            "completed": self.completed_total,
            "rejected": self.rejected_total,
            "failed": self.failed_total,
            "poisoned": self.poisoned_total,
            "deadlineExceeded": self.deadline_exceeded_total,
            "retries": self.retries_total,
            "preemptions": self.preemptions,
            "degraded": self.ladder.snapshot(self.now),
            "prefill": {
                "chunkTokensPerIteration":
                    self.config.prefill_chunk_tokens,
                "prefilling": [r.rid for r in self._prefilling],
                "backlogTokens": self._prefill_backlog(),
                "chunksTotal": self.prefill_chunks_total,
                "tokensDiscarded": self.prefill_tokens_discarded,
            },
            "recentTtftS": [round(t, 6)
                            for t in self._recent_ttft[-16:]],
            "spec": {
                "kMax": self.config.spec_k,
                "proposed": self._spec.proposed_total,
                "accepted": self._spec.accepted_total,
                "rejected": (self._spec.proposed_total
                             - self._spec.accepted_total),
                "acceptanceRate": round(self._spec.acceptance_rate(), 4),
                "ewmaRate": round(self._spec.rate, 4),
                "meanAcceptedK": round(
                    self._spec.accepted_total
                    / max(self.spec_rows_total, 1), 4),
                "verifyRows": self.spec_rows_total,
            },
        }


class DecodeService:
    """The serving shell of a pod: a background thread stepping the
    scheduler under a task-scoped watchdog heartbeat, the scheduler's
    snapshot, ledger and headroom digest as ``/debug/serve*`` handlers of a
    :class:`~..utils.metrics.MetricsServer`, and a streaming HTTP ingress
    (:meth:`start_http`): chunked responses, one token a flush, W3C trace
    context adopted from the caller, so TTFT is measured at the wire; and,
    while started, the process-global sampling profiler, metrics history
    and trend engine (``/debug/profile``, ``/debug/history``, the digest's
    ``trendAnomalies``)."""

    def __init__(self, scheduler: Scheduler,
                 idle_interval_s: float = 0.05,
                 stream_timeout_s: float = 30.0,
                 evaluator: Optional[Any] = None,
                 fault_capacity_fn: Optional[Callable[[], Optional[int]]]
                 = None) -> None:
        self.scheduler = scheduler
        self.idle_interval_s = idle_interval_s
        #: how long a stream waits for its next token before it gives up
        #: on the scheduler (a wedged loop must not hold clients forever)
        self.stream_timeout_s = stream_timeout_s
        #: the SLO evaluator whose serve-* alerts join the digest and feed
        #: the ladder (None: the port's global ``slo.EVALUATOR``)
        self.evaluator = evaluator
        #: the fault gate's capacity (the device plugin's operational chip
        #: count); None reports the dimension as null, gauged as 0
        self.fault_capacity_fn = fault_capacity_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._http: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._rid_seq = itertools.count()
        if scheduler.slo_alert_fn is None:
            # the ladder's second signal: a firing serve-SLO alert
            scheduler.slo_alert_fn = self._serve_alert_firing

    def _evaluator(self) -> Any:
        return self.evaluator if self.evaluator is not None \
            else slo.EVALUATOR

    def _serve_alert_firing(self) -> bool:
        return any(name.startswith("serve-")
                   for name, _ in self._evaluator().active_alerts())

    def debug_handlers(self) -> dict:
        return {"/debug/serve": self.scheduler.snapshot,
                "/debug/serve/ledger": self.scheduler.ledger.snapshot,
                "/debug/serve/headroom": self.headroom,
                "/debug/profile": profiler.debug_handler,
                "/debug/history": history.debug_handler}

    def headroom(self) -> dict:
        """The replica's headroom digest: the scheduler's dimensions, the
        firing serve SLO alerts, the fault-gate capacity and the trend
        engine's anomalous series (the record a router scores replicas
        by); refreshes the folded dimensions' ``tpu_serve_headroom``
        gauges."""
        digest = self.scheduler.headroom()
        alerts = [{"slo": name, "severity": severity}
                  for name, severity in self._evaluator().active_alerts()
                  if name.startswith("serve-")]
        digest["sloAlerts"] = alerts
        fault_capacity = (self.fault_capacity_fn()
                          if self.fault_capacity_fn is not None else None)
        digest["faultGateCapacity"] = fault_capacity
        anomalies = trend.TREND.anomalies()
        digest["trendAnomalies"] = anomalies
        metrics.SERVE_HEADROOM.set(float(len(alerts)),
                                   dimension="slo_alerts_firing")
        metrics.SERVE_HEADROOM.set(float(fault_capacity or 0),
                                   dimension="fault_gate_capacity")
        metrics.SERVE_HEADROOM.set(float(len(anomalies)),
                                   dimension="trend_anomalies")
        return digest

    # -- streaming ingress ----------------------------------------------------
    def start_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind ``POST /v1/generate`` (body ``{"prompt_len", "output_len",
        "slo_class"?, "prompt"?, "rid"?}``). Every field passes a
        :mod:`~..utils.validate` sanitizer, and hostile input is a 400
        before any scheduler state changes. The response is chunked NDJSON,
        one ``{"token": t}`` object a chunk flush, then one terminal record
        (``{"done": true, "tokens": n}`` or ``{"error": ...}``). An inbound
        ``traceparent`` is adopted, ``x-tpu-deadline-ms`` sets a deadline,
        and a client that disconnects or a stream that times out cancels
        its request. Returns the bound port."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: object) -> None:
                pass

            def _write_chunk(self, obj: dict) -> None:
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()  # one token a flush

            def _parse(self) -> Request:
                length = validate.clamped_int(
                    self.headers.get("Content-Length") or 0,
                    0, MAX_BODY_BYTES, "Content-Length")
                spec = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(spec, dict):
                    raise ValueError("body must be a JSON object")
                prompt = spec.get("prompt")
                if prompt is not None \
                        and not isinstance(prompt, (list, tuple)):
                    raise ValueError("prompt must be a list of token ids")
                return Request(
                    rid=validate.bounded_str(
                        spec.get("rid") or f"http-{next(outer._rid_seq)}",
                        max_len=128, what="rid"),
                    prompt_len=validate.clamped_int(
                        spec.get("prompt_len") or len(prompt or ()),
                        1, MAX_PROMPT_LEN, "prompt_len"),
                    output_len=validate.clamped_int(
                        spec["output_len"], 1, MAX_OUTPUT_LEN,
                        "output_len"),
                    slo_class=validate.parse_choice(
                        spec.get("slo_class", INTERACTIVE),
                        (INTERACTIVE, BATCH), "slo_class"),
                    # bounded ints now: a bad element 400s here, not
                    # inside the scheduler's loop
                    prompt=tuple(
                        validate.clamped_int(t, 0, MAX_TOKEN_ID,
                                             "prompt id")
                        for t in prompt) if prompt else None)

            def do_POST(self) -> None:  # noqa: N802 — stdlib contract
                if self.path != "/v1/generate":
                    self.send_error(404, "unknown path")
                    return
                try:
                    req = self._parse()
                except (KeyError, ValueError, TypeError,
                        AttributeError) as e:
                    self.send_error(400, f"bad request: {e}")
                    return
                if req.prompt is not None \
                        and len(req.prompt) != req.prompt_len:
                    self.send_error(400, "prompt_len disagrees with the "
                                         "prompt ids' length")
                    return
                # a hostile or malformed deadline header is no deadline
                deadline_ms = parse_deadline_ms(
                    self.headers.get(DEADLINE_HEADER))
                if deadline_ms is not None:
                    req.deadline_budget_s = deadline_ms / 1000.0
                ctx = tracing.extract_traceparent(
                    self.headers.get(tracing.TRACEPARENT_HEADER))
                events: queue.Queue = queue.Queue()
                req.stream = lambda ev, val: events.put((ev, val))
                with tracing.context_scope(ctx), tracing.span(
                        "serve.request", rid=req.rid,
                        slo_class=req.slo_class) as span_ctx:
                    # the phase spans join this trace, parented on the
                    # caller's span when one was adopted
                    req.trace_id = span_ctx.trace_id
                    req.parent_span_id = (ctx.span_id if ctx
                                          else span_ctx.span_id)
                    t0 = time.monotonic()
                    outer.scheduler.submit_now(req)
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    self._stream(req, events, t0)

            def _stream(self, req: Request, events: queue.Queue,
                        t0: float) -> None:
                """Relay the request's events until its terminal one; a
                timeout or a dropped client cancels the request."""
                first = True
                finished = False
                timeout_s = outer.stream_timeout_s
                if req.deadline_budget_s is not None:
                    # give up once the deadline cannot be met, after a
                    # grace for the scheduler's own terminal record
                    timeout_s = min(timeout_s, req.deadline_budget_s
                                    + STREAM_DEADLINE_GRACE_S)
                try:
                    while True:
                        try:
                            ev, val = events.get(timeout=timeout_s)
                        except queue.Empty:
                            self._write_chunk({"error": "stream timeout"})
                            break
                        if ev == "token":
                            if first:
                                metrics.SERVE_WIRE_TTFT_SECONDS.observe(
                                    time.monotonic() - t0,
                                    exemplar=tracing.exemplar())
                                first = False
                            self._write_chunk({"token": val})
                            continue
                        finished = True
                        if ev == "done":
                            self._write_chunk({"done": True,
                                               "tokens": val})
                        elif ev == "failed":
                            # admitted, then lost: not a rejection
                            self._write_chunk({"error": f"failed: {val}"})
                        elif ev == "deadline_exceeded":
                            self._write_chunk({"error": "deadline exceeded",
                                               "tokens": val})
                        else:
                            self._write_chunk(
                                {"error": f"rejected: {val}"})
                        break
                    self.wfile.write(b"0\r\n\r\n")
                    self.wfile.flush()
                except OSError:
                    pass  # the client hung up: cancelled below
                finally:
                    if not finished:
                        outer.scheduler.cancel(req.rid)

        srv = ThreadingHTTPServer((host, port), Handler)
        srv.daemon_threads = True
        self._http = srv
        self._http_thread = threading.Thread(
            target=srv.serve_forever, daemon=True, name="serve-ingress")
        self._http_thread.start()
        return srv.server_address[1]

    def start(self) -> None:
        """Start the step loop: registers the ``serve.scheduler``
        heartbeat (60 s a step), bounds the scheduler's history, starts
        the global sampling profiler, wires the serving families and their
        trend watches onto the global history and starts its sampler."""
        if self._thread is not None:
            return
        self._stop.clear()
        if self.scheduler.heartbeat is None:
            self.scheduler.heartbeat = watchdog.register(
                "serve.scheduler", deadline=60.0)
        if self.scheduler.history_limit is None:
            self.scheduler.history_limit = 4096
        profiler.PROFILER.start()
        history.register_serving_families()
        trend.register_serving_watches()
        history.HISTORY.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-scheduler")
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                busy = self.scheduler.step()
            except Exception:  # noqa: BLE001 — a raising step costs one
                # step, never the serving thread
                log.exception("scheduler step failed; serving continues")
                metrics.SWALLOWED_ERRORS.inc(site="serve.step")
                self._stop.wait(self.idle_interval_s)
                continue
            if not busy:
                self._stop.wait(self.idle_interval_s)

    def stop(self) -> None:
        """Close the ingress, stop the history sampler and the step loop
        and join the threads (each join bounded at 5 s, the sampler's at
        2 s), then close the heartbeat. The profiler keeps sampling, as
        the reference's does: it is the process's, not the service's."""
        http, self._http = self._http, None
        if http is not None:
            http.shutdown()
            http.server_close()
        if self._http_thread is not None:
            self._http_thread.join(timeout=5)
            self._http_thread = None
        self._stop.set()
        history.HISTORY.stop()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
        if self.scheduler.heartbeat is not None:
            self.scheduler.heartbeat.close()
            self.scheduler.heartbeat = None


# -- open-loop traffic and the serving bench ---------------------------------

#: :func:`open_loop_arrivals`' inclusive prompt and output length ranges,
#: from which the modelled capacity takes its means
PROMPT_LENS = (16, 128)
OUTPUT_LENS = (8, 128)
#: :func:`prefix_heavy_arrivals`' traffic: common prefixes (100 tokens,
#: off the block boundary, so the partial tail block's copy-on-write
#: runs), a unique tail of 0-32 tokens (empty tails repeat a bare prefix)
#: and 8-64 output tokens, ids under a 50 000-token vocabulary
PREFIX_COUNT = 4
PREFIX_LEN = 100
TAIL_LENS = (0, 32)
PREFIX_OUTPUT_LENS = (8, 64)
PREFIX_VOCAB = 50_000
#: offered loads (fractions of the modelled capacity) of the sharing and
#: the speculation benches, and the speculation bench's draft length and
#: token period
SHARING_LOAD = 0.8
SPEC_LOAD = 0.6
SPEC_K = 4
SPEC_PERIOD = 4
#: :func:`calibrate_cost_model`'s batch for the decode slope and the
#: verify pass, its prompt length, and the verify pass's drafts
CALIBRATION_SLOTS = 8
CALIBRATION_PROMPT_LEN = 32
CALIBRATION_SPEC_K = 4
#: :func:`wall_open_loop`'s offered load
WALL_LOAD = 0.8


def _mean(lens: tuple) -> float:
    return (lens[0] + lens[1]) / 2.0


def open_loop_arrivals(seed: int, rate_rps: float, horizon_s: float,
                       interactive_frac: float = 0.5,
                       id_prefix: str = "r") -> list:
    """Seeded Poisson arrivals up to *horizon_s*: lengths uniform over
    :data:`PROMPT_LENS` and :data:`OUTPUT_LENS`, the class a Bernoulli
    draw. Open loop: arrivals do not wait for service, so queueing
    collapse shows. The draws are the reference's, in its order, so both
    packages make the same list."""
    rng = random.Random(seed)
    out: list[Request] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        if t > horizon_s:
            return out
        out.append(Request(
            rid=f"{id_prefix}{len(out)}",
            prompt_len=rng.randint(*PROMPT_LENS),
            output_len=rng.randint(*OUTPUT_LENS),
            slo_class=INTERACTIVE if rng.random() < interactive_frac
            else BATCH,
            arrival_s=t))


def prefix_heavy_arrivals(seed: int, rate_rps: float,
                          horizon_s: float) -> list:
    """Seeded shared-system-prompt traffic: each prompt is one of
    :data:`PREFIX_COUNT` common prefixes plus a unique tail, as real token
    ids, so the pool's content keys find the sharing unaided; half the
    requests interactive."""
    rng = random.Random(seed)
    prefixes = [tuple(rng.randrange(PREFIX_VOCAB) for _ in range(PREFIX_LEN))
                for _ in range(PREFIX_COUNT)]
    out: list[Request] = []
    t = 0.0
    while True:
        t += rng.expovariate(rate_rps)
        if t > horizon_s:
            return out
        tail = tuple(rng.randrange(PREFIX_VOCAB)
                     for _ in range(rng.randint(*TAIL_LENS)))
        prompt = prefixes[rng.randrange(PREFIX_COUNT)] + tail
        out.append(Request(
            rid=f"p{len(out)}",
            prompt_len=len(prompt),
            output_len=rng.randint(*PREFIX_OUTPUT_LENS),
            slo_class=INTERACTIVE if rng.random() < 0.5 else BATCH,
            arrival_s=t, prompt=prompt))


def run_open_loop(config: ServeConfig, cost_model: CostModel,
                  arrivals: list,
                  executor_factory: Optional[Callable[[], Any]]
                  = None) -> dict:
    """One open-loop experiment on the virtual clock, run to drain: the
    reference's serving record, key for key and rounded alike. Tokens/s is
    generated tokens over the makespan. *executor_factory* makes the
    executor (a fresh one: executors keep per-slot state); default
    :class:`SimExecutor`."""
    sched = Scheduler(config,
                      executor=(executor_factory()
                                if executor_factory is not None
                                else SimExecutor()),
                      cost_model=cost_model)
    for req in arrivals:
        sched.submit(req)
    occupancies: list[float] = []
    shared_peak = 0
    while sched.step():
        occupancies.append(sched.pool.occupancy())
        if config.prefix_sharing:
            shared_peak = max(shared_peak, sched.pool.shared_blocks())
    done = sched.completed
    tokens = sum(len(r.tokens) for r in done)
    ttfts = [r.ttft_s for r in done if r.ttft_s is not None]
    makespan = max((r.finish_s for r in done), default=0.0)
    # each request's mean inter-token latency
    itls = [(r.finish_s - r.first_token_s) / max(len(r.tokens) - 1, 1)
            for r in done if r.first_token_s is not None
            and r.finish_s is not None and len(r.tokens) > 1]
    spec = sched._spec
    return {
        "requests": len(arrivals),
        "completed": len(done),
        "rejected": len(sched.rejected),
        "preemptions": sched.preemptions,
        "tokens": tokens,
        "makespan_s": round(makespan, 4),
        "tokens_per_s": round(tokens / makespan, 2) if makespan else 0.0,
        "ttft_p50_s": round(nearest_rank(ttfts, 0.50), 4),
        "ttft_p99_s": round(nearest_rank(ttfts, 0.99), 4),
        "itl_p50_s": round(nearest_rank(itls, 0.50), 4),
        "itl_p99_s": round(nearest_rank(itls, 0.99), 4),
        "kv_occupancy_mean": round(
            sum(occupancies) / len(occupancies), 4) if occupancies
        else 0.0,
        "kv_occupancy_max": round(max(occupancies), 4) if occupancies
        else 0.0,
        "kv_blocks_leaked": sched.pool.outstanding(),
        "kv_blocks_shared_peak": shared_peak,
        "kv_cow_copies": sched.pool.cow_copies,
        "kv_prefix_block_hits": sched.pool.prefix_block_hits,
        "prefill_chunks": sched.prefill_chunks_total,
        "prefill_tokens_discarded": sched.prefill_tokens_discarded,
        "trace_events": len(sched.trace),
        "spec_proposed": spec.proposed_total,
        "spec_accepted": spec.accepted_total,
        "spec_acceptance_rate": round(spec.acceptance_rate(), 4),
        "spec_mean_accepted_k": round(
            spec.accepted_total / max(sched.spec_rows_total, 1), 4),
        "spec_kv_rollback_tokens": sched.pool.spec_rollback_tokens,
    }


def _per_request_s(cm: CostModel, slots: int, prompt_mean: float,
                   output_mean: float) -> float:
    """Modelled service time of one request at a full batch: its prefill
    plus its share of every decode iteration it is in."""
    return (cm.prefill_s(prompt_mean)
            + output_mean * cm.decode_s(slots) / slots)


def _open_loop_request_s(cm: CostModel, slots: int) -> float:
    return _per_request_s(cm, slots, _mean(PROMPT_LENS), _mean(OUTPUT_LENS))


def open_loop_capacity_rps(cm: CostModel, slots: int) -> float:
    """The modelled capacity, in requests per second, of a *slots*-wide
    scheduler under :func:`open_loop_arrivals`: the load 1.0 of
    :func:`bench_serving`."""
    return 1.0 / _open_loop_request_s(cm, slots)


def compare_batching(config: ServeConfig, cost_model: CostModel,
                     arrivals: list) -> dict:
    """Continuous against static batching (a batch admitted only once the
    last one drained) on the same arrivals, both with an unbounded queue
    so that neither rejects what the other serves."""
    cont_cfg = dataclasses.replace(config, queue_limit=1_000_000)
    cont = run_open_loop(cont_cfg, cost_model,
                         [r.fresh_copy() for r in arrivals])
    static_cfg = dataclasses.replace(cont_cfg, static=True,
                                     preemption=False)
    stat = run_open_loop(static_cfg, cost_model,
                         [r.fresh_copy() for r in arrivals])
    ratio = (cont["tokens_per_s"] / stat["tokens_per_s"]
             if stat["tokens_per_s"] else float("inf"))
    return {"continuous": cont, "static": stat,
            "speedup": round(ratio, 3)}


def bench_prefix_sharing(seed: int = 0,
                         cost_model: Optional[CostModel] = None,
                         config: Optional[ServeConfig] = None,
                         horizon_s: float = 40.0) -> dict:
    """The same seeded prefix-heavy arrivals at :data:`SHARING_LOAD` with
    sharing on and off: the peak physical KV occupancy each reaches, with
    the shared-block and copy-on-write counters. *config* defaults to
    :func:`chunked_config`."""
    cm = cost_model or CostModel()
    base = config or chunked_config(cm)
    rate = SHARING_LOAD / _per_request_s(
        cm, base.slots, PREFIX_LEN + _mean(TAIL_LENS),
        _mean(PREFIX_OUTPUT_LENS))
    arrivals = prefix_heavy_arrivals(seed, rate, horizon_s)
    on = run_open_loop(dataclasses.replace(base, prefix_sharing=True),
                       cm, [r.fresh_copy() for r in arrivals])
    off = run_open_loop(dataclasses.replace(base, prefix_sharing=False),
                        cm, [r.fresh_copy() for r in arrivals])
    return {
        "offered_load": SHARING_LOAD,
        "offered_rps": round(rate, 3),
        "prefix_len": PREFIX_LEN,
        "with_sharing": on,
        "without_sharing": off,
        "kv_blocks_shared": on["kv_blocks_shared_peak"],
        "occupancy_max_with": on["kv_occupancy_max"],
        "occupancy_max_without": off["kv_occupancy_max"],
        "occupancy_cut": round(off["kv_occupancy_max"]
                               - on["kv_occupancy_max"], 4),
    }


def bench_spec_decoding(seed: int = 0, horizon_s: float = 40.0,
                        cost_model: Optional[CostModel] = None) -> dict:
    """The same seeded arrivals at :data:`SPEC_LOAD` through
    :class:`PeriodicSimExecutor` (tokens cycle every :data:`SPEC_PERIOD`,
    so prompt lookup drafts well) on the default :class:`ServeConfig`,
    with speculation at :data:`SPEC_K` and without: acceptance, mean
    accepted k, ITL p50 and tokens/s of each, and the blocks both
    leaked."""
    cm = cost_model or CostModel()
    base = ServeConfig()
    rate = SPEC_LOAD / _open_loop_request_s(cm, base.slots)
    arrivals = open_loop_arrivals(seed, rate, horizon_s, id_prefix="S")
    on = run_open_loop(
        dataclasses.replace(base, spec_k=SPEC_K), cm,
        [r.fresh_copy() for r in arrivals],
        executor_factory=lambda: PeriodicSimExecutor(SPEC_PERIOD))
    off = run_open_loop(
        base, cm, [r.fresh_copy() for r in arrivals],
        executor_factory=lambda: PeriodicSimExecutor(SPEC_PERIOD))
    return {
        "offered_load": SPEC_LOAD,
        "offered_rps": round(rate, 3),
        "spec_k": SPEC_K,
        "period": SPEC_PERIOD,
        "with_speculation": on,
        "baseline": off,
        "acceptance_rate": on["spec_acceptance_rate"],
        "mean_accepted_k": on["spec_mean_accepted_k"],
        "itl_p50_s_spec": on["itl_p50_s"],
        "itl_p50_s_baseline": off["itl_p50_s"],
        "itl_p50_delta_s": round(off["itl_p50_s"] - on["itl_p50_s"], 4),
        "itl_p50_speedup": round(off["itl_p50_s"] / on["itl_p50_s"], 3)
        if on["itl_p50_s"] else 0.0,
        "tokens_per_s_speedup": round(
            on["tokens_per_s"] / off["tokens_per_s"], 3)
        if off["tokens_per_s"] else 0.0,
        "kv_blocks_leaked": (on["kv_blocks_leaked"]
                             + off["kv_blocks_leaked"]),
    }


def calibrate_cost_model(cfg: TransformerConfig,
                         device: "str | torch.device" = "cuda") -> CostModel:
    """Fit :class:`CostModel` to the port's own iterations of *cfg* on
    *device* (the reference's fit): each of ``prefill`` of a
    :data:`CALIBRATION_PROMPT_LEN`-token prompt, ``decode_step`` at batch 1
    and at :data:`CALIBRATION_SLOTS`, and ``verify_step`` of that many rows
    of :data:`CALIBRATION_SPEC_K` drafts, each over a fresh
    ``init_kv_cache``, runs once untimed and then 8 times on the host
    clock, each call ending in ``torch.cuda.synchronize()`` on the card.
    The decode slope between the two batches is the per-sequence term (at
    least 1e-6 s), the rest of batch 1 the base; prefill and the verify
    slope per (sequence, draft) are clamped at 1e-7 s. Random parameters
    from seed 0."""
    dev = resolve_device(device)
    slots, prompt_len = CALIBRATION_SLOTS, CALIBRATION_PROMPT_LEN
    params = init_params(0, cfg, device=dev)

    def timed(fn: Callable[[], object], iters: int = 8) -> float:
        def call() -> None:
            fn()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        call()  # untimed: first-use allocations and library handles
        t0 = time.perf_counter()
        for _ in range(iters):
            call()
        return (time.perf_counter() - t0) / iters

    prompt = torch.ones((1, prompt_len), dtype=torch.int64, device=dev)
    prefill_s = timed(lambda: prefill(params, cfg, prompt))

    def one_decode(batch: int) -> float:
        cache = init_kv_cache(cfg, batch, device=dev)
        toks = torch.zeros((batch,), dtype=torch.int64, device=dev)
        pos = torch.full((batch,), prompt_len, dtype=torch.int32,
                         device=dev)
        return timed(lambda: decode_step(params, cfg, cache, toks, pos))

    d1, dn = one_decode(1), one_decode(slots)
    per_seq = max((dn - d1) / max(slots - 1, 1), 1e-6)
    base = max(d1 - per_seq, 1e-6)
    k = CALIBRATION_SPEC_K
    cache = init_kv_cache(cfg, slots, device=dev)
    toks = torch.zeros((slots, k + 1), dtype=torch.int64, device=dev)
    pos = torch.full((slots,), prompt_len, dtype=torch.int32, device=dev)
    verify = timed(lambda: verify_step(params, cfg, cache, toks, pos))
    return CostModel(
        decode_base_s=base, decode_per_seq_s=per_seq,
        prefill_per_token_s=max(prefill_s / prompt_len, 1e-7),
        spec_verify_per_token_s=max((verify - dn) / (slots * k), 1e-7))


def bench_serving(seed: int = 0, loads: tuple = (0.5, 0.8, 1.1),
                  cost_model: Optional[CostModel] = None,
                  config: Optional[ServeConfig] = None,
                  horizon_s: float = 60.0) -> dict:
    """The serving record: open-loop arrivals at each offered load (a
    fraction of the modelled capacity), then continuous against static
    batching on batch-only arrivals at the capacity itself, where static
    batching's drained-batch stalls bind. Virtual time over the cost
    model, seeded: the record is reproducible."""
    config = config or ServeConfig()
    cm = cost_model or CostModel()
    # a request's share of the prefill time as well as of every decode
    # iteration: without the prefill, "0.5 load" overloads any backend
    # where prefill dominates
    capacity_rps = open_loop_capacity_rps(cm, config.slots)
    out: dict = {
        "seed": seed,
        "slots": config.slots,
        "kv_blocks": config.kv_blocks,
        "kv_block_size": config.kv_block_size,
        "prefill_chunk_tokens": config.prefill_chunk_tokens,
        "prefix_sharing": config.prefix_sharing,
        "cost_model": {
            "decode_base_ms": round(cm.decode_base_s * 1e3, 4),
            "decode_per_seq_ms": round(cm.decode_per_seq_s * 1e3, 4),
            "prefill_per_token_ms": round(cm.prefill_per_token_s * 1e3, 5),
        },
        "peak_tokens_per_s_modeled": round(
            capacity_rps * _mean(OUTPUT_LENS), 1),
        "loads": {},
    }
    for load in loads:
        rate = load * capacity_rps
        arrivals = open_loop_arrivals(seed, rate, horizon_s,
                                      id_prefix=f"L{load}-")
        out["loads"][str(load)] = dict(
            offered_load=load, offered_rps=round(rate, 3),
            **run_open_loop(config, cm, arrivals))
    out["continuous_vs_static"] = compare_batching(
        config, cm, open_loop_arrivals(seed + 1, capacity_rps, horizon_s,
                                       interactive_frac=0.0,
                                       id_prefix="C-"))
    return out


def wall_open_loop(params: dict, cfg: TransformerConfig,
                   cost_model: CostModel, config: ServeConfig,
                   horizon_s: float) -> dict:
    """The open loop served for real: :func:`open_loop_arrivals` (seed 0)
    at :data:`WALL_LOAD` of the modelled capacity over *horizon_s* of
    virtual time, each request given prompt ids drawn from seed 0 in
    [0, vocab), run through :func:`run_open_loop` over
    :class:`TorchSlotExecutor` on *params*' device with prefix sharing off
    (the executor is not prefix-aware) and timed on the wall clock. The
    schedule depends on lengths alone, so the record must equal a
    :class:`SimExecutor` run's on the same arrivals; ``RuntimeError``
    otherwise. Returns the record, the wall seconds, the wall tokens/s,
    the offered rate, the executor's chunk width and the served
    requests."""
    config = dataclasses.replace(config, prefix_sharing=False)
    rate = WALL_LOAD * open_loop_capacity_rps(cost_model, config.slots)
    arrivals = open_loop_arrivals(0, rate, horizon_s, id_prefix="OL-")
    rng = np.random.default_rng(0)
    for r in arrivals:
        r.prompt = tuple(int(t) for t in rng.integers(0, cfg.vocab,
                                                      r.prompt_len))
    # the executor pads every chunk to its width, which one slot row must
    # hold; no chunk is longer than its prompt, so capping the width at
    # max_seq leaves the budget's schedule as it is
    width = min(config.prefill_chunk_tokens, cfg.max_seq)
    dev = params_device(params)
    sim = run_open_loop(config, cost_model,
                        [r.fresh_copy() for r in arrivals])
    served = [r.fresh_copy() for r in arrivals]
    t0 = time.perf_counter()
    real = run_open_loop(
        config, cost_model, served,
        executor_factory=lambda: TorchSlotExecutor(
            params, cfg, slots=config.slots, chunk_tokens=width,
            device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if real != sim:
        diff = {k: (real[k], sim[k]) for k in real if real[k] != sim[k]}
        raise RuntimeError(f"the real executor's record differs from the "
                           f"SimExecutor's on the same arrivals: {diff}")
    return {"record": real, "wall_s": wall,
            "wall_tokens_per_s": real["tokens"] / wall,
            "offered_rps": rate, "chunk_width": width, "served": served}
