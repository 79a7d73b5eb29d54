"""Prometheus-format metrics and the debug HTTP endpoints of the serving
shell.

The port's copy of ``dpu_operator_tpu/utils/metrics.py``, trimmed to what
the serving shell uses: :class:`Counter`, :class:`Gauge`,
:class:`Histogram` (with OpenMetrics exemplars and ``count_above``),
:class:`HistogramVec`, :class:`Registry` with the classic (0.0.4) and the
OpenMetrics exposition (counter families without ``_total``, a closing
``# EOF``), and :class:`MetricsServer` (``/metrics``, ``/healthz``,
``/debug``, ``/debug/flight`` and registered ``/debug/...`` handlers).
Its registry holds only the families the serving path, its pool,
watchdog, SLOs, flight ring, sampling profiler (``tpu_profile_*``),
metrics history (``tpu_history_*``) and trend engine (``tpu_trend_*``)
touch; their names, types, buckets and
labels are the reference's letter for letter, since the operator's SLOs
and telemetry read them. The bearer-token filter, the readiness and
health-snapshot endpoints and every other family are left out.
"""

from __future__ import annotations

import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional, Sequence, TypeVar

from . import flight

log = logging.getLogger(__name__)

_MetricT = TypeVar("_MetricT")


class Counter:
    def __init__(self, name: str, help_: str) -> None:
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: object) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum across label sets."""
        with self._lock:
            return sum(self._values.values())

    def samples(self) -> list:
        """Sorted ``(label-dict, value)`` rows across every label set."""
        with self._lock:
            items = sorted(self._values.items())
        return [({str(k): str(v) for k, v in key}, val)
                for key, val in items]

    def _render(self, openmetrics: bool = False) -> list:
        # OpenMetrics names counter FAMILIES without the _total suffix
        # (samples keep it)
        family = (self.name[:-len("_total")]
                  if openmetrics and self.name.endswith("_total")
                  else self.name)
        out = [f"# HELP {family} {self.help}",
               f"# TYPE {family} counter"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                out.append(f"{self.name}{_labels(key)} {_num(val)}")
        return out


class _FlightRecordedCounter(Counter):
    """Counter whose every increment also lands in the flight ring: the
    counter says how many, the flight event when and under which trace."""

    def __init__(self, name: str, help_: str, kind: str) -> None:
        super().__init__(name, help_)
        self._flight_kind = kind

    def inc(self, amount: float = 1.0, **labels: object) -> None:
        super().inc(amount, **labels)
        flight.record(self._flight_kind, self.name,
                      attributes={k: str(v) for k, v in labels.items()}
                      or None)


class Gauge(Counter):
    def set(self, value: float, **labels: object) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def _render(self, openmetrics: bool = False) -> list:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, val in sorted(self._values.items()):
                out.append(f"{self.name}{_labels(key)} {_num(val)}")
        return out


class Histogram:
    """Fixed-bucket histogram."""

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                       5.0, 10.0, 30.0, 60.0, 120.0)

    def __init__(self, name: str, help_: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 const_labels: Optional[dict] = None) -> None:
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        #: fixed label set rendered on every sample (HistogramVec children)
        self.const_labels = tuple(sorted((const_labels or {}).items()))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        #: per-bucket-index latest exemplar: (labels, observed value),
        #: rendered only on OpenMetrics scrapes
        self._exemplars: dict[int, tuple[tuple, float]] = {}
        self._lock = threading.Lock()

    def observe(self, value: float,
                exemplar: Optional[dict] = None) -> None:
        with self._lock:
            self._sum += value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    idx = i
                    break
            else:
                idx = len(self.buckets)
            self._counts[idx] += 1
            if exemplar:
                self._exemplars[idx] = (tuple(sorted(exemplar.items())),
                                        value)

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self._counts)

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def count_above(self, le: float) -> float:
        """Observations above *le*, at bucket granularity (the bad-event
        read of a latency SLO: *le* should be a bucket bound)."""
        with self._lock:
            total = sum(self._counts)
            covered = sum(c for b, c in zip(self.buckets, self._counts)
                          if b <= le)
        return float(total - covered)

    def _render(self, with_header: bool = True,
                openmetrics: bool = False) -> list:
        out = ([f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} histogram"] if with_header else [])
        extra = "".join(f',{k}="{_escape(v)}"' for k, v in self.const_labels)
        base = (_labels(self.const_labels) if self.const_labels else "")
        with self._lock:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                out.append(
                    f'{self.name}_bucket{{le="{_num(b)}"{extra}}} {cum}'
                    + self._exemplar_suffix(i, openmetrics))
            cum += self._counts[-1]
            out.append(f'{self.name}_bucket{{le="+Inf"{extra}}} {cum}'
                       + self._exemplar_suffix(len(self.buckets),
                                               openmetrics))
            out.append(f"{self.name}_sum{base} {_num(self._sum)}")
            out.append(f"{self.name}_count{base} {cum}")
        return out

    def _exemplar_suffix(self, idx: int, openmetrics: bool) -> str:
        """`` # {trace_id="..."} <value>`` per the OpenMetrics exemplar
        grammar; empty on classic scrapes (the 0.0.4 parser rejects
        exemplars) and for buckets without one."""
        if not openmetrics:
            return ""
        hit = self._exemplars.get(idx)
        if hit is None:
            return ""
        labels, value = hit
        inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
        return f" # {{{inner}}} {_num(value)}"


class HistogramVec:
    """Histogram family keyed on one label: children share the name and
    buckets; HELP / TYPE are emitted once for the family."""

    def __init__(self, name: str, help_: str, label: str,
                 buckets: Sequence[float] = Histogram.DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help_
        self.label = label
        self.buckets = tuple(buckets)
        self._children: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Histogram:
        with self._lock:
            child = self._children.get(value)
            if child is None:
                child = Histogram(self.name, self.help, self.buckets,
                                  const_labels={self.label: value})
                self._children[value] = child
            return child

    def observe(self, value: str, seconds: float,
                exemplar: Optional[dict] = None) -> None:
        self.labels(value).observe(seconds, exemplar=exemplar)

    def _snapshot_children(self) -> list:
        with self._lock:
            return list(self._children.values())

    def count(self) -> float:
        return float(sum(c.count for c in self._snapshot_children()))

    def _render(self, openmetrics: bool = False) -> list:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for _, child in children:
            out.extend(child._render(with_header=False,
                                     openmetrics=openmetrics))
        return out


def bounded_label(value: object, allowed: Optional[set] = None,
                  fallback: str = "other", max_len: int = 64) -> str:
    """Clamp a label value derived from request or series data to a
    bounded set before it becomes a metric label: with *allowed*,
    membership (anything else collapses to *fallback*); without, a
    charset and length clamp (characters other than ``[A-Za-z0-9._-]``
    become ``_``). It clamps instead of refusing, because a metric bump
    must never fail the work it accounts for."""
    text = str(value)
    if allowed is not None:
        return text if text in allowed else fallback
    text = re.sub(r"[^A-Za-z0-9._-]", "_", text[:max_len])
    return text or fallback


def _escape(v: object) -> str:
    """Label-value escaping per the Prometheus exposition format."""
    return (str(v).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in key)
    return "{" + inner + "}"


def _num(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Registry:
    def __init__(self) -> None:
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str) -> Counter:
        return self._add(Counter(name, help_))

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._add(Gauge(name, help_))

    def histogram(self, name: str, help_: str, **kw: Any) -> Histogram:
        return self._add(Histogram(name, help_, **kw))

    def histogram_vec(self, name: str, help_: str, label: str,
                      **kw: Any) -> HistogramVec:
        return self._add(HistogramVec(name, help_, label, **kw))

    def _add(self, metric: _MetricT) -> _MetricT:
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition; *openmetrics* also renders exemplars and the
        closing ``# EOF`` the OpenMetrics grammar requires."""
        lines = []
        with self._lock:
            for m in self._metrics:
                lines.extend(m._render(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"


#: the port's process-global registry
REGISTRY = Registry()

# -- health engine (utils/watchdog.py + utils/slo.py) ------------------------
WATCHDOG_STALLS = REGISTRY.counter(
    "tpu_watchdog_stalls_total",
    "Heartbeats detected past their deadline by the watchdog, by "
    "component (each stall dumps all-thread stacks into the flight "
    "recorder, kind=stall)")
SLO_BURN_RATE = REGISTRY.gauge(
    "tpu_slo_burn_rate",
    "Error-budget burn rate per SLO and window (1.0 = spending the "
    "budget exactly; SRE Workbook multi-window thresholds fire at "
    "14.4x/6x)")
SLO_ALERT_ACTIVE = REGISTRY.gauge(
    "tpu_slo_alert_active",
    "1 while a multi-window burn-rate alert is firing, by SLO and "
    "severity")
# -- ICI fault-domain engine (dpu_operator_tpu/faults/) ----------------------
# -- continuous-batching decode service (workloads/serve.py) -----------------
SERVE_REQUESTS = REGISTRY.counter(
    "tpu_serve_requests_total",
    "Serve requests by SLO class and outcome (completed / rejected = "
    "shed at admission / cancelled / failed = lost after admission / "
    "poisoned = failed past the retry budget / deadline_exceeded)")
SERVE_TOKENS = REGISTRY.counter(
    "tpu_serve_tokens_total",
    "Tokens produced by the decode service, by phase (prefill = first "
    "tokens, decode = continuation tokens)")
SERVE_TTFT_SECONDS = REGISTRY.histogram(
    "tpu_serve_ttft_seconds",
    "Time-to-first-token per request: arrival to first emitted token "
    "(queueing + admission + prefill) — the serve-ttft SLO source",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
             30.0, 60.0))
SERVE_ITL_SECONDS = REGISTRY.histogram(
    "tpu_serve_itl_seconds",
    "Inter-token latency per decode iteration (includes prefill "
    "interference from interleaved admissions) — the serve-tokens SLO "
    "source",
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.2, 0.5, 1.0, 2.5, 5.0))
SERVE_QUEUE_DEPTH = REGISTRY.gauge(
    "tpu_serve_queue_depth",
    "Requests waiting for admission, by SLO class")
SERVE_ACTIVE = REGISTRY.gauge(
    "tpu_serve_active_requests",
    "Requests currently holding a batch slot, by SLO class")
SERVE_SLOTS = REGISTRY.gauge(
    "tpu_serve_batch_slots",
    "Batch slots by state (free / active) — free slots are half of the "
    "capacity the device plugin advertises as tpu-serve-slots")
SERVE_KV_BLOCKS = REGISTRY.gauge(
    "tpu_serve_kv_blocks",
    "Paged KV cache blocks by state (free / used); used must return "
    "to zero when the service drains (the leak gate)")
SERVE_KV_FRAGMENTATION = REGISTRY.gauge(
    "tpu_serve_kv_internal_fragmentation",
    "Fraction of allocated KV token slots not yet written (internal "
    "fragmentation; external is zero by paging construction)")
SERVE_PREEMPTIONS = REGISTRY.counter(
    "tpu_serve_preemptions_total",
    "Batch-class requests evicted (KV blocks freed, recompute on "
    "re-admission) to admit an interactive request, by reason")
SERVE_ADMISSION_REJECTED = REGISTRY.counter(
    "tpu_serve_admission_rejections_total",
    "Requests rejected at admission, by SLO class and reason (a rising "
    "rate is the health engine's first saturation signal)")
SERVE_PREFILL_CHUNKS = REGISTRY.counter(
    "tpu_serve_prefill_chunks_total",
    "Prefill chunks executed by the iteration-level scheduler (chunked "
    "prefill splits each prompt into budget-sized pieces interleaved "
    "with decode iterations)")
SERVE_PREFILL_CHUNK_TOKENS = REGISTRY.counter(
    "tpu_serve_prefill_chunk_tokens_total",
    "Prompt tokens prefilled through the chunk queue, by outcome "
    "(prefilled = executed toward a first token; discarded = chunk "
    "progress thrown away by a preemptive eviction — the chunk-aware "
    "preemption cost)")
SERVE_PREFILL_BACKLOG = REGISTRY.gauge(
    "tpu_serve_prefill_chunk_backlog_tokens",
    "Prompt tokens admitted but not yet prefilled (the chunk queue's "
    "backlog; TTFT is bounded by this backlog over the per-iteration "
    "budget)")
SERVE_WIRE_TTFT_SECONDS = REGISTRY.histogram(
    "tpu_serve_wire_ttft_seconds",
    "Time-to-first-token measured AT THE WIRE by the streaming HTTP "
    "ingress: request read to first chunked-response flush (includes "
    "scheduler queueing the model-level tpu_serve_ttft_seconds sees, "
    "plus serialization)",
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0,
             30.0, 60.0))
KV_SHARED_BLOCKS = REGISTRY.gauge(
    "tpu_kv_shared_blocks",
    "Physical KV blocks currently mapped by >= 2 requests (prefix "
    "sharing; each counts once toward occupancy — the saving is this "
    "gauge times the extra mappers)")
KV_COW_COPIES = REGISTRY.counter(
    "tpu_kv_cow_copies_total",
    "Copy-on-write block copies: a request wrote into a block it "
    "shared, got a private copy, and the original kept serving its "
    "other readers")
KV_PREFIX_BLOCK_HITS = REGISTRY.counter(
    "tpu_kv_prefix_block_hits_total",
    "KV blocks served from the content-addressed prefix index instead "
    "of fresh allocation (each hit is block_size token slots not "
    "duplicated)")
SERVE_STEP_BREAKDOWN = REGISTRY.histogram_vec(
    "tpu_serve_step_breakdown_seconds",
    "Per-iteration scheduler time decomposed by phase (prefill = "
    "chunk-budget spend, decode = the executor's decode pass, cow = "
    "KV-pool write/copy-on-write accounting, sched = admission/"
    "completion/lock overhead) — the cost ledger's fleet view; the "
    "per-iteration entries live at /debug/serve/ledger",
    label="phase",
    buckets=(0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
             0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
SERVE_SPEC_TOKENS = REGISTRY.counter(
    "tpu_serve_spec_tokens_total",
    "Speculative-decoding draft tokens by outcome (proposed = drafted "
    "by the prompt-lookup drafter and scored by the verify pass; "
    "accepted = matched the model's own greedy choice and were "
    "emitted; rejected = mismatched and rolled back via the paged KV "
    "pool)")
SERVE_SPEC_ACCEPTANCE = REGISTRY.gauge(
    "tpu_serve_spec_acceptance_rate",
    "Lifetime speculative-draft acceptance rate (accepted / proposed "
    "tokens); the adaptive-k policy's EWMA tracks the same signal and "
    "drives k back to 0 when this collapses")
SERVE_SPEC_VERIFY_SECONDS = REGISTRY.histogram(
    "tpu_serve_spec_verify_seconds",
    "Duration of each speculative verify iteration (the batched "
    "k+1-position verify_step pass plus acceptance) — what the "
    "calibrated cost model's verify term must track for adaptive k "
    "to price speculation honestly",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5, 5.0))
SERVE_HEADROOM = REGISTRY.gauge(
    "tpu_serve_headroom",
    "Replica headroom digest by dimension (free_slots / "
    "advertisable_slots / free_kv_blocks / chunk_backlog_tokens / "
    "prefix_index_keys / degraded_rung / slo_alerts_firing / "
    "fault_gate_capacity) — the deterministic record the prefix/"
    "load-aware router scores replicas by; served at "
    "/debug/serve/headroom")
SERVE_EXECUTOR_FAULTS = REGISTRY.counter(
    "tpu_serve_executor_faults_total",
    "Executor exceptions caught by the serving-path fault engine, by "
    "phase (prefill / decode / verify) — each one cost the batch an "
    "iteration and routed exactly one victim through retry or "
    "fail-fast")
SERVE_RETRIES = REGISTRY.counter(
    "tpu_serve_retries_total",
    "Retry-with-rebuild lifecycles scheduled after a transient "
    "executor fault, by phase: the victim's KV blocks are freed, its "
    "generated tokens kept, and it re-prefills on readmission after "
    "RetryPolicy's backoff")
SERVE_POISONED = REGISTRY.counter(
    "tpu_serve_poisoned_requests_total",
    "Requests classified poisoned — the same rid failed the executor "
    "past its retry budget — and excised so one bad request can never "
    "crash-loop the step")
SERVE_DEGRADED_RUNG = REGISTRY.gauge(
    "tpu_serve_degraded_rung",
    "Current graceful-degradation ladder rung (0 healthy / 1 "
    "shed_batch / 2 no_spec / 3 shrink_slots / 4 interactive_only); "
    "rung changes also emit ServeDegraded / ServeRecovered Events")
FLIGHT_DROPPED = REGISTRY.counter(
    "tpu_flight_dropped_total",
    "Flight-recorder events evicted by ring overflow, per kind — a "
    "storm that outruns the ring is visible here instead of silently "
    "overwriting history (tpuctl flight surfaces the same counts)")
# -- runtime performance plane (utils/profiler.py) ---------------------------
PROFILE_SAMPLES = REGISTRY.counter(
    "tpu_profile_samples_total",
    "Sampling-profiler stack walks taken (one per cadence tick, each "
    "walking every live thread's current frame); served in aggregate "
    "at /debug/profile and by tpuctl profile")
PROFILE_DROPPED = REGISTRY.counter(
    "tpu_profile_dropped_total",
    "Profiler samples not aggregated because a bounded table (folded "
    "stacks or per-thread site rows) was already full — the profiler "
    "trades tail completeness for a hard memory bound")
PROFILE_OVERHEAD = REGISTRY.gauge(
    "tpu_profile_overhead_ratio",
    "Self-metered profiler overhead: time spent walking/aggregating "
    "frames divided by elapsed run time (the profile gate asserts "
    "this stays under 0.02 on a busy scheduler loop)")
PROFILE_TRACKED_SITES = REGISTRY.gauge(
    "tpu_profile_tracked_sites",
    "Distinct (thread, code site) rows currently held in the "
    "profiler's bounded self/total tables")
# -- metrics history plane (utils/history.py + utils/trend.py) ---------------
HISTORY_SAMPLES = REGISTRY.counter(
    "tpu_history_samples_total",
    "Sampling passes taken by the in-process metrics history (one per "
    "cadence tick, each reading every registered family into the "
    "multi-resolution rings served at /debug/history)")
HISTORY_SERIES = REGISTRY.gauge(
    "tpu_history_series",
    "Distinct time series currently tracked by the metrics history "
    "(families expand per label set / quantile, bounded by the "
    "series cap)")
HISTORY_POINTS = REGISTRY.gauge(
    "tpu_history_points",
    "Total points currently held across every history ring at every "
    "resolution — the memory-bound readout the history gate asserts "
    "against under a 10k-sample storm")
HISTORY_EVICTED = REGISTRY.counter(
    "tpu_history_evicted_total",
    "History points/series not kept, by reason (ring = oldest point "
    "evicted by a full ring; series_cap = a new label set refused "
    "because the series table was full) — bounded by construction, "
    "never grown")
TREND_EVALUATIONS = REGISTRY.counter(
    "tpu_trend_evaluations_total",
    "Trend-engine evaluation passes over the watched history series")
TREND_SLOPE = REGISTRY.gauge(
    "tpu_trend_slope",
    "Per-series relative drift over the judgment window (signed: "
    "positive = rising), by series — the raw signal the hysteresis "
    "judges before any anomaly fires")
TREND_ANOMALY = REGISTRY.gauge(
    "tpu_trend_anomaly",
    "1 while a watched series is in the anomalous state (drift past "
    "the threshold in its bad direction for escalate_after "
    "consecutive evaluations, not yet cleared through hold-down), "
    "by series")
TREND_TRANSITIONS = REGISTRY.counter(
    "tpu_trend_transitions_total",
    "Committed trend state transitions by series and target state "
    "(anomaly / cleared) — each one also emits a TrendAnomaly / "
    "TrendCleared Event and a kind=trend flight entry")
# -- exception hygiene --------------------------------------------------------
SWALLOWED_ERRORS = REGISTRY._add(_FlightRecordedCounter(
    "tpu_daemon_swallowed_errors_total",
    "Exceptions deliberately swallowed on the daemon/reconcile path, "
    "by site — a rising rate at one site is a failing dependency that "
    "would otherwise be invisible",
    kind="swallowed_error"))



class MetricsServer:
    """``/metrics`` (classic, or OpenMetrics when the scraper's ``Accept``
    asks for it), ``/healthz``, ``/debug`` (the index of the debug
    endpoints), ``/debug/flight`` (the flight ring as JSON) and the
    registered *debug_handlers* (``/debug/...`` paths to JSON-snapshot
    callables, e.g. ``DecodeService.debug_handlers()``) on one port."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0,
                 debug_handlers: Optional[
                     dict[str, Callable[[], dict]]] = None) -> None:
        self.host = host
        self.port = port
        self.debug_handlers = dict(debug_handlers or {})
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def _get(self, path: str, accept: str) -> tuple:
        """(code, body, content type) of a GET of *path*."""
        if path == "/metrics":
            om = "application/openmetrics-text" in accept
            body = REGISTRY.render(openmetrics=om).encode()
            return 200, body, ("application/openmetrics-text; "
                               "version=1.0.0; charset=utf-8" if om
                               else "text/plain; version=0.0.4")
        if path == "/debug/flight":
            return (200, json.dumps(flight.RECORDER.snapshot()).encode(),
                    "application/json")
        if path == "/debug":
            paths = sorted({"/debug/flight", *self.debug_handlers})
            return (200, json.dumps({"debugHandlers": paths}).encode(),
                    "application/json")
        if path in self.debug_handlers:
            try:
                body = json.dumps(self.debug_handlers[path]()).encode()
            except Exception:  # noqa: BLE001 — a broken snapshot source
                # must not take the whole mux down
                log.exception("debug handler %s failed", path)
                return 500, b"debug snapshot failed", "text/plain"
            return 200, body, "application/json"
        if path == "/healthz":
            return 200, b"ok", "text/plain"
        return 404, b"not found", "text/plain"

    def start(self) -> None:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt: str, *args: object) -> None:
                pass

            def do_GET(self) -> None:  # noqa: N802 — stdlib contract
                code, body, ctype = outer._get(
                    self.path, self.headers.get("Accept", ""))
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="metrics")
        self._thread.start()

    def stop(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
