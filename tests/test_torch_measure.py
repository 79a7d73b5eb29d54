"""Measurement and calibration in the PyTorch/CUDA port, on the CPU,
against the JAX package.

The port's open-loop serving bench (``open_loop_arrivals``,
``prefix_heavy_arrivals``, ``run_open_loop``, ``compare_batching``,
``bench_prefix_sharing``, ``bench_spec_decoding``, ``bench_serving``),
``chunked_config``, the pool's occupancy queries and ``nearest_rank`` are
held against their JAX twins on the same inputs: equal under ``==``. The
scheduler gates of tests/test_serve.py that these functions carry run again
on the port, and the reference's parameters that the port fixes are its
defaults. Then the runs over ``TorchSlotExecutor`` and the tiny model
(``run_open_loop`` and ``wall_open_loop``), whose record must equal the
``SimExecutor`` record and whose streams must equal ``generate``; and the
wall-clock entry points (``calibrate_cost_model``,
``measure_flash_attention``, ``measure_decode``'s sanity bound and
``bench_torch.py``) at CPU sizes, whose numbers are smoke values.
"""

import dataclasses
import inspect
import json
import math
import random

import numpy as np
import pytest
import torch

import bench_torch
from dpu_operator_tpu.utils.stats import nearest_rank as jnearest_rank
from dpu_operator_tpu.workloads import kv_pool as jkv
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.utils.stats import nearest_rank
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import kv_pool as tkv
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import perf as tperf
from dpu_operator_tpu_torch.workloads import serve as tserve

SEED = 20260804
#: tests/test_serve.py's CPU-calibrated cost model
CALIBRATED = dict(decode_base_s=0.0007512, decode_per_seq_s=0.0000835,
                  prefill_per_token_s=0.00026168)


def _cms(**kw):
    """The same cost model in both packages: (port, JAX)."""
    return tserve.CostModel(**kw), jserve.CostModel(**kw)


def _jax_config(port_config):
    """The JAX ServeConfig holding the port config's fields (the JAX-only
    fields at their defaults)."""
    return jserve.ServeConfig(**dataclasses.asdict(port_config))


def _fields(reqs):
    return [(r.rid, r.prompt_len, r.output_len, r.slo_class, r.arrival_s,
             r.prompt) for r in reqs]


def _port_arrivals(*args, **kw):
    """JAX ``open_loop_arrivals`` at lengths the port's generator does
    not take, as port Requests: the arrivals are data here."""
    return [tserve.Request(rid=r.rid, prompt_len=r.prompt_len,
                           output_len=r.output_len, slo_class=r.slo_class,
                           arrival_s=r.arrival_s)
            for r in jserve.open_loop_arrivals(*args, **kw)]


def _default(fn, name):
    return inspect.signature(fn).parameters[name].default


#: the reference's tiny calibration model (its calibrate_cost_model default)
CALIBRATION_TINY = tmodel.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                            n_layers=2, d_ff=128, max_seq=256)


# -- nearest_rank -------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_nearest_rank_equals_the_jax_helper(seed):
    rng = random.Random(seed)
    for n in (0, 1, 2, 5, 20, 37):
        samples = [rng.random() for _ in range(n)]
        for frac in (0.0, 0.01, 0.5, 0.95, 0.99, 1.0, rng.random()):
            assert nearest_rank(samples, frac) \
                == jnearest_rank(samples, frac)
    # the rank rule itself: p95 of 20 samples is the 19th, not the max
    assert nearest_rank(list(range(20)), 0.95) == 18


# -- the pool's occupancy queries ---------------------------------------------

def test_pool_queries_follow_the_jax_pool_through_cow_and_rollback():
    """The four queries after each step of one scripted sequence: alloc,
    publish, map_prefix, a copy-on-write write, rollback, free."""
    ours, theirs = (tkv.KvBlockPool(12, 4, sharing=True),
                    jkv.KvBlockPool(12, 4, sharing=True))
    prompt = tuple(range(10))                       # 2.5 blocks of 4
    keys = tkv.chain_keys(prompt, 4)
    assert keys == jkv.chain_keys(prompt, 4)
    script = [
        ("alloc", ("a", 4)),
        ("set_used_tokens", ("a", 10)),
        ("register_prefix", ("a", keys, 10)),
        ("map_prefix", ("b", keys)),
        ("alloc", ("b", 1)),
        ("set_used_tokens", ("b", 10)),
        ("write_token", ("b", 10)),                 # into the shared tail
        ("write_token", ("b", 13)),
        ("set_used_tokens", ("b", 14)),
        ("rollback_tokens", ("b", 11)),
        ("map_prefix", ("c", keys[:2])),
        ("alloc", ("c", 2)),
        ("free", ("a",)),
        ("free", ("b",)),
        ("free", ("c",)),
    ]
    for op, args in script:
        assert getattr(ours, op)(*args) == getattr(theirs, op)(*args), op
        for query in ("used_blocks", "occupancy", "logical_blocks",
                      "shared_blocks", "outstanding"):
            assert getattr(ours, query)() == getattr(theirs, query)(), \
                (op, query)
    assert ours.shared_blocks() == 0 and ours.occupancy() == 0.0
    assert ours.cow_copies == theirs.cow_copies == 1


# -- chunked_config -----------------------------------------------------------

@pytest.mark.parametrize("cost", [
    {},
    CALIBRATED,
    dict(decode_base_s=0.06, decode_per_seq_s=1e-6,
         prefill_per_token_s=3e-4, spec_verify_per_token_s=1e-7),
])
def test_chunked_config_equals_the_jax_one(cost):
    ours, theirs = _cms(**cost)
    for slots in (8, 24):
        assert tserve.prefill_budget_tokens(ours, slots) \
            == jserve.prefill_budget_tokens(theirs, slots)
    cfg = tserve.chunked_config(ours)
    assert _jax_config(cfg) == jserve.chunked_config(theirs)
    assert cfg.prefix_sharing and cfg.prefill_chunk_tokens >= 16


@pytest.mark.parametrize("constant,fn,name", [
    ("ITL_BOUND_S", "prefill_budget_tokens", "itl_bound_s"),
    ("PREFILL_FLOOR_TOKENS", "prefill_budget_tokens", "floor"),
    ("CHUNKED_SLOTS", "chunked_config", "slots"),
    ("PROMPT_LENS", "open_loop_arrivals", "prompt_lens"),
    ("OUTPUT_LENS", "open_loop_arrivals", "output_lens"),
    ("PREFIX_COUNT", "prefix_heavy_arrivals", "n_prefixes"),
    ("TAIL_LENS", "prefix_heavy_arrivals", "tail_lens"),
    ("PREFIX_OUTPUT_LENS", "prefix_heavy_arrivals", "output_lens"),
    ("PREFIX_VOCAB", "prefix_heavy_arrivals", "vocab"),
    ("PREFIX_LEN", "bench_prefix_sharing", "prefix_len"),
    ("SHARING_LOAD", "bench_prefix_sharing", "offered_load"),
    ("SPEC_LOAD", "bench_spec_decoding", "offered_load"),
    ("SPEC_K", "bench_spec_decoding", "spec_k"),
    ("SPEC_PERIOD", "bench_spec_decoding", "period"),
    ("CALIBRATION_SLOTS", "calibrate_cost_model", "slots"),
    ("CALIBRATION_PROMPT_LEN", "calibrate_cost_model", "prompt_len"),
])
def test_fixed_knobs_are_the_jax_defaults(constant, fn, name):
    """Each parameter of the reference that no caller of the port sets is
    a module constant holding the reference's default."""
    assert getattr(tserve, constant) == _default(getattr(jserve, fn), name)
    assert name not in inspect.signature(getattr(tserve, fn)).parameters


# -- arrivals -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["open_loop", "prefix_heavy"])
def test_arrivals_equal_field_for_field(kind):
    # the port's prefix traffic is the one its sharing bench sends: the
    # bench's prefix length, not the generator's default
    kw = {"prefix_len": tserve.PREFIX_LEN} if kind == "prefix_heavy" else {}
    for seed, rate, horizon in ((SEED, 6.0, 20.0), (3, 40.0, 5.0)):
        name = f"{kind}_arrivals"
        ours = getattr(tserve, name)(seed, rate, horizon)
        theirs = getattr(jserve, name)(seed, rate, horizon, **kw)
        assert ours and _fields(ours) == _fields(theirs)


# -- run_open_loop and the records --------------------------------------------

def _load_arrivals(pkg, cm, slots, load, horizon):
    """Arrivals at *load* x the modelled capacity of a *slots*-wide
    scheduler (tests/test_serve.py's ``_load_arrivals``)."""
    per_req = cm.prefill_s((16 + 128) / 2.0) \
        + (8 + 128) / 2.0 * cm.decode_s(slots) / slots
    return pkg.open_loop_arrivals(0, load / per_req, horizon)


@pytest.mark.parametrize("case", ["default", "chunked_shared", "spec"])
def test_run_open_loop_record_equals_the_jax_record(case):
    ours_cm, theirs_cm = _cms(**CALIBRATED)
    if case == "default":
        cfg, factory = tserve.ServeConfig(), (None, None)
    elif case == "chunked_shared":
        cfg, factory = tserve.chunked_config(ours_cm), (None, None)
    else:
        cfg = tserve.ServeConfig(spec_k=4)
        factory = (lambda: tserve.PeriodicSimExecutor(4),
                   lambda: jserve.PeriodicSimExecutor(4))
    horizon = 12.0
    if case == "chunked_shared":
        # common prefixes off the block boundary: mapping and the tail
        # block's copy-on-write both fire
        arrivals = [tserve.prefix_heavy_arrivals(SEED, 30.0, horizon),
                    jserve.prefix_heavy_arrivals(SEED, 30.0, horizon,
                                                 prefix_len=100)]
    else:
        arrivals = [_load_arrivals(pkg, cm, cfg.slots, 0.8, horizon)
                    for pkg, cm in ((tserve, ours_cm), (jserve, theirs_cm))]
    ours = tserve.run_open_loop(cfg, ours_cm, arrivals[0],
                                executor_factory=factory[0])
    theirs = jserve.run_open_loop(_jax_config(cfg), theirs_cm, arrivals[1],
                                  executor_factory=factory[1])
    assert ours == theirs
    assert ours["completed"] > 0 and ours["kv_blocks_leaked"] == 0
    if case == "chunked_shared":
        assert ours["prefill_chunks"] > 0
        assert ours["kv_blocks_shared_peak"] > 0
        assert ours["kv_cow_copies"] > 0
    if case == "spec":
        assert ours["spec_accepted"] > 0


def test_compare_batching_equals_the_jax_record():
    ours_cm, theirs_cm = _cms()
    cfg = tserve.ServeConfig(slots=8, kv_blocks=256, queue_limit=256)
    args = (SEED, 8 / ours_cm.decode_s(8) / 66.0, 15.0)
    kw = dict(prompt_lens=(16, 128), output_lens=(4, 128),
              interactive_frac=0.0)
    ours = tserve.compare_batching(cfg, ours_cm, _port_arrivals(*args, **kw))
    assert ours == jserve.compare_batching(
        _jax_config(cfg), theirs_cm, jserve.open_loop_arrivals(*args, **kw))


@pytest.mark.parametrize("bench", ["prefix_sharing", "spec_decoding",
                                   "serving"])
def test_bench_records_equal_the_jax_records(bench):
    ours_cm, theirs_cm = _cms(**CALIBRATED)
    if bench == "prefix_sharing":
        kw = dict(seed=SEED, horizon_s=10.0)
    elif bench == "spec_decoding":
        kw = dict(seed=0, horizon_s=8.0)
    else:
        kw = dict(seed=SEED, loads=(0.6, 1.1), horizon_s=8.0)
    name = f"bench_{bench}"
    ours = getattr(tserve, name)(cost_model=ours_cm, **kw)
    assert ours == getattr(jserve, name)(cost_model=theirs_cm, **kw)


def test_bench_serving_with_a_chunked_config_equals_the_jax_record():
    ours_cm, theirs_cm = _cms(**CALIBRATED)
    kw = dict(seed=0, loads=(0.8,), horizon_s=8.0)
    ours = tserve.bench_serving(cost_model=ours_cm,
                                config=tserve.chunked_config(ours_cm), **kw)
    assert ours == jserve.bench_serving(
        cost_model=theirs_cm, config=jserve.chunked_config(theirs_cm), **kw)


# -- the scheduler gates of tests/test_serve.py, on the port ------------------

def test_continuous_beats_static_by_1_5x():
    """Twin of tests/test_serve.py's gate: at the modelled capacity the
    continuous scheduler sustains at least 1.5x static batching's
    tokens/s on the same arrivals and tokens."""
    cfg = tserve.ServeConfig(slots=8, kv_blocks=256, queue_limit=256)
    cm = tserve.CostModel()
    arrivals = _port_arrivals(
        SEED, rate_rps=cfg.slots / cm.decode_s(cfg.slots) / 66.0,
        horizon_s=60.0, prompt_lens=(16, 128), output_lens=(4, 128),
        interactive_frac=0.0)
    out = tserve.compare_batching(cfg, cm, arrivals)
    assert out["continuous"]["completed"] == len(arrivals)
    assert out["static"]["completed"] == len(arrivals)
    assert out["continuous"]["tokens"] == out["static"]["tokens"]
    assert out["speedup"] >= 1.5, out


def test_chunked_prefill_bounds_ttft_p99_at_0_8_load():
    """Twin of tests/test_serve.py's gate: at 0.8 load on the calibrated
    model, chunked prefill cuts whole-prompt prefill's TTFT p99 at least
    5x on the same arrivals, stays under 1.038 s at its own 0.8 load and
    gives up no tokens/s."""
    cm = tserve.CostModel(**CALIBRATED)
    legacy = tserve.ServeConfig()
    arrivals = _load_arrivals(tserve, cm, legacy.slots, 0.8, 60.0)
    base = tserve.run_open_loop(legacy, cm,
                                [r.fresh_copy() for r in arrivals])
    assert base["ttft_p99_s"] > 2.0
    chunked = tserve.chunked_config(cm)
    same = tserve.run_open_loop(chunked, cm,
                                [r.fresh_copy() for r in arrivals])
    assert same["ttft_p99_s"] <= base["ttft_p99_s"] / 5.0, (base, same)
    own = tserve.run_open_loop(
        chunked, cm, _load_arrivals(tserve, cm, chunked.slots, 0.8, 60.0))
    assert own["ttft_p99_s"] <= 5.19 / 5.0, own
    assert own["tokens_per_s"] >= base["tokens_per_s"], (base, own)
    for out in (same, own):
        assert out["kv_blocks_leaked"] == 0
        assert out["prefill_chunks"] > 0


def test_prefix_sharing_cuts_peak_kv_occupancy():
    """Twin of tests/test_serve.py's sharing gate: peak physical
    occupancy at least 0.1 lower with sharing, nothing leaked, the
    shared-block and prefix-hit counters firing, no work lost."""
    out = tserve.bench_prefix_sharing(seed=SEED,
                                      cost_model=tserve.CostModel(
                                          **CALIBRATED))
    on, off = out["with_sharing"], out["without_sharing"]
    assert out["occupancy_max_with"] <= out["occupancy_max_without"] - 0.1
    assert out["kv_blocks_shared"] > 0
    assert on["kv_blocks_leaked"] == off["kv_blocks_leaked"] == 0
    assert on["completed"] >= off["completed"]
    assert on["rejected"] <= off["rejected"]
    assert on["kv_prefix_block_hits"] > 0


def test_bench_serving_record_shape_and_determinism():
    """Twin of tests/test_serve.py's record test: two load points with
    TTFT p99 at or above p50, nothing leaked, a real batching win, and
    the same record twice."""
    kw = dict(seed=SEED, loads=(0.6, 1.1), horizon_s=12.0)
    rec = tserve.bench_serving(**kw)
    assert tserve.bench_serving(**kw) == rec
    assert len(rec["loads"]) == 2
    for row in rec["loads"].values():
        assert row["ttft_p99_s"] >= row["ttft_p50_s"] >= 0.0
        assert row["kv_blocks_leaked"] == 0
        assert row["tokens_per_s"] > 0
    assert rec["continuous_vs_static"]["speedup"] > 1.0


# -- the open loop over the real executor -------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = tmodel.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, max_seq=64,
                                   dtype=torch.float32)
    return cfg, tmodel.init_params(0, cfg, device="cpu")


@pytest.fixture(scope="module")
def tiny_wide():
    """The tiny fp32 model with room for the bench's longest arrival."""
    cfg = tmodel.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, max_seq=256,
                                   dtype=torch.float32)
    return cfg, tmodel.init_params(0, cfg, device="cpu")


@pytest.mark.parametrize("chunk", [0, 8])
def test_open_loop_over_the_torch_executor_equals_the_sim_record(tiny,
                                                                 chunk):
    """The tiny fp32 model served open loop on the virtual clock: the
    record equals the SimExecutor's on the same arrivals (the schedule
    depends on lengths alone), and every stream equals ``generate``."""
    cfg, params = tiny
    cm = tserve.CostModel(**CALIBRATED)
    config = tserve.ServeConfig(slots=3, kv_blocks=24, kv_block_size=8,
                                prefill_chunk_tokens=chunk)
    arrivals = _port_arrivals(SEED, 40.0, 0.3, prompt_lens=(4, 24),
                              output_lens=(2, 16))
    rng = np.random.default_rng(SEED)
    for r in arrivals:
        r.prompt = tuple(int(t) for t in rng.integers(0, cfg.vocab,
                                                      r.prompt_len))
    sim = tserve.run_open_loop(config, cm,
                               [r.fresh_copy() for r in arrivals])
    served = [r.fresh_copy() for r in arrivals]
    real = tserve.run_open_loop(
        config, cm, served, executor_factory=lambda: tserve.TorchSlotExecutor(
            params, cfg, slots=config.slots, chunk_tokens=chunk,
            device="cpu"))
    assert real == sim
    assert real["completed"] == len(arrivals) >= 8
    assert real["kv_blocks_leaked"] == 0
    for r in served:
        want = tdecode.generate(params, cfg, torch.tensor([r.prompt]),
                                r.output_len, device="cpu")[0].tolist()
        assert r.tokens == want, r.rid


# -- wall-clock entry points at CPU sizes -------------------------------------

def test_wall_open_loop_on_the_cpu_equals_the_sim_record(tiny_wide):
    """``wall_open_loop`` of the tiny fp32 model on the CPU: the bench's
    arrivals at 0.8 load, the record equal to the SimExecutor's (checked
    inside), every served stream equal to ``generate``, a wall time."""
    cfg, params = tiny_wide
    cm = tserve.CostModel(**CALIBRATED)
    config = tserve.chunked_config(cm)
    out = tserve.wall_open_loop(params, cfg, cm, config, 0.3)
    rec = out["record"]
    assert rec["requests"] >= 4 and rec["completed"] == rec["requests"]
    assert rec["kv_blocks_leaked"] == 0 and rec["prefill_chunks"] > 0
    assert rec["kv_blocks_shared_peak"] == 0    # sharing is off
    assert out["chunk_width"] == config.prefill_chunk_tokens
    assert out["offered_rps"] == pytest.approx(
        tserve.WALL_LOAD * tserve.open_loop_capacity_rps(cm, config.slots))
    assert out["wall_s"] > 0
    assert out["wall_tokens_per_s"] == rec["tokens"] / out["wall_s"]
    for r in out["served"]:
        assert all(0 <= t < cfg.vocab for t in r.prompt)
        want = tdecode.generate(params, cfg, torch.tensor([r.prompt]),
                                r.output_len, device="cpu")[0].tolist()
        assert r.tokens == want, r.rid


def test_wall_open_loop_raises_when_the_record_departs(tiny_wide,
                                                       monkeypatch):
    """A record that is not the SimExecutor's is an error, not a number."""
    cfg, params = tiny_wide
    cm = tserve.CostModel(**CALIBRATED)
    real = tserve.run_open_loop
    calls = []

    def skewed(*a, **kw):
        rec = real(*a, **kw)
        calls.append(1)
        return dict(rec, tokens=rec["tokens"] + 1) if len(calls) == 2 \
            else rec

    monkeypatch.setattr(tserve, "run_open_loop", skewed)
    with pytest.raises(RuntimeError, match="differs from the SimExecutor"):
        tserve.wall_open_loop(params, cfg, cm, tserve.chunked_config(cm),
                              0.1)


def test_calibrate_cost_model_on_the_cpu_fits_finite_positive_fields():
    cm = tserve.calibrate_cost_model(CALIBRATION_TINY, device="cpu")
    for f in dataclasses.fields(tserve.CostModel):
        v = getattr(cm, f.name)
        assert math.isfinite(v) and v > 0, (f.name, v)
    assert cm.decode_per_seq_s >= 1e-6 and cm.decode_base_s >= 1e-6
    assert cm.prefill_per_token_s >= 1e-7
    assert cm.spec_verify_per_token_s >= 1e-7
    # the fit feeds the budget and the record as the reference's does
    assert tserve.chunked_config(cm).prefill_chunk_tokens >= 16


def test_measure_flash_attention_at_a_cpu_size():
    b, s, h, d = 1, 64, 2, 32
    perf = tperf.measure_flash_attention(b=b, s=s, h=h, d=d, iters=4,
                                         best_of=1, device="cpu")
    assert perf.device == "cpu" and perf.call_ms > 0
    assert perf.peak_tflops == tperf.CPU_PEAK_FLOPS / 1e12
    flops = tperf.attention_flops(b, s, h, d, causal=True)
    assert perf.tflops_causal == pytest.approx(
        flops / (perf.call_ms / 1e3) / 1e12, rel=1e-9)
    assert perf.frac_of_peak == pytest.approx(
        perf.tflops_causal / perf.peak_tflops, rel=1e-9)


@pytest.mark.parametrize("bound,raises", [(1e-9, True), (1e9, False)])
def test_measure_decode_raises_outside_max_sane_frac(bound, raises):
    cfg = tmodel.TransformerConfig(vocab=64, d_model=32, n_heads=2,
                                   n_layers=1, d_ff=64, max_seq=32)
    kw = dict(batch=1, steps=8, iters=1, best_of=1, device="cpu",
              max_sane_frac=bound)
    if raises:
        with pytest.raises(ValueError, match="roofline_frac"):
            tperf.measure_decode(cfg, **kw)
    else:
        assert tperf.measure_decode(cfg, **kw)["roofline_frac"] <= bound


def test_bench_torch_on_the_cpu_prints_one_line_with_every_section(capsys):
    assert bench_torch.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert "errors" not in rec
    assert rec["record"] == "bench_torch" and rec["device"] == "cpu"
    srv = rec["serve"]
    assert srv["cost_model_calibrated"] is True
    assert set(srv["modelled"]["loads"]) == {"0.5", "0.8", "1.1"}
    for row in srv["modelled"]["loads"].values():
        assert row["kv_blocks_leaked"] == 0
    wall = srv["wall"]
    assert wall["record_equals_sim"] is True
    assert wall["kv_blocks_leaked"] == 0
    assert wall["completed"] == wall["requests"]
    assert wall["wall_s"] > 0 and wall["tokens_per_s"] >= 0
    for key in ("train_step_ms", "flash_call_ms", "decode_tok_s_b1",
                "decode_tok_s_b1_int8", "decode_tok_s_b8_int8kv8"):
        assert rec[key] > 0, key


def test_bench_torch_records_a_failed_section_and_exits_1(monkeypatch,
                                                          capsys):
    def broken(*a, **kw):
        raise RuntimeError("calibration failed")

    monkeypatch.setattr(bench_torch.serve_mod, "calibrate_cost_model",
                        broken)
    bench = bench_torch.ComputeBench("cpu")
    monkeypatch.setattr(bench_torch.ComputeBench, "sections",
                        lambda self: [("serve", bench.serve),
                                      ("flash", bench.flash)])
    assert bench_torch.main(["--device", "cpu"]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["errors"] == {"serve": "RuntimeError: calibration failed"}
    assert "serve" not in rec and rec["flash_call_ms"] > 0


def test_the_card_is_the_default_and_missing_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tserve.calibrate_cost_model(CALIBRATION_TINY),
             lambda: tperf.measure_flash_attention(b=1, s=64, h=2, d=32),
             lambda: tperf.measure_train(tmodel.TransformerConfig()),
             lambda: bench_torch.ComputeBench(),
             lambda: bench_torch.main([])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_bench_torch_on_a_card_without_an_nvidia_smi_line_exits_1(
        monkeypatch, capsys):
    """On the card the line must name the card's power limit: where
    nvidia-smi gives none, the run is an error."""
    class OnTheCard:
        dev = torch.device("cuda")

        def __init__(self, device):
            pass

        def sections(self):
            return []

    monkeypatch.setattr(bench_torch, "ComputeBench", OnTheCard)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "a card")
    monkeypatch.setattr(bench_torch, "nvidia_smi_line", lambda: None)
    assert bench_torch.main([]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["device"] == "a card" and rec["nvidia_smi"] is None
    assert set(rec["errors"]) == {"nvidia_smi"}


# -- the two-length slope on a loaded host ------------------------------------

class _ScriptedChains:
    """``make_chained`` over a fake clock: each call of a chain of n
    iterations advances the clock by the next duration scripted for n (the
    last one repeating), so a test sets the minima of the short and the
    long chains try by try, with no wall time."""

    def __init__(self, script: dict) -> None:
        self.now = 0.0
        self.script = {n: list(d) for n, d in script.items()}
        self.calls = {n: 0 for n in script}

    def perf_counter(self) -> float:
        return self.now

    def __call__(self, n: int):
        def go() -> None:
            durations = self.script[n]
            self.now += durations[min(self.calls[n], len(durations) - 1)]
            self.calls[n] += 1
        return go


def _slope_with(monkeypatch, script, **kw):
    chains = _ScriptedChains(script)
    monkeypatch.setattr(tperf, "time", chains)
    args = dict(n_short=16, n_long=64, repeats=2, best_of=1)
    args.update(kw)
    return chains, tperf._marginal_step_s(chains, **args)


def test_crossed_minima_are_taken_again_and_give_a_positive_slope(
        monkeypatch):
    """A loaded host stalls the short chains of the first try (minimum
    10 s against the long chains' 9 s: a slope of -1/48 s, which the JAX
    helper clamps to 1e-9 s). The repeats run again, and the minima of
    both tries (1 s, 5 s) give the slope (5 - 1) / 48."""
    chains, slope = _slope_with(monkeypatch, {
        16: [1.0, 10.0, 10.0, 1.0, 1.0],     # warm-up, try 1, try 2
        64: [5.0, 9.0, 9.0, 5.0, 5.0]})
    assert slope == pytest.approx(4.0 / 48)
    assert chains.calls == {16: 5, 64: 5}


def test_a_slope_crossed_in_every_try_raises(monkeypatch):
    with pytest.raises(ValueError, match="collapsed slope"):
        _slope_with(monkeypatch, {16: [1.0, 10.0], 64: [5.0, 9.0]})
    chains = _ScriptedChains({16: [1.0, 10.0], 64: [5.0, 9.0]})
    monkeypatch.setattr(tperf, "time", chains)
    with pytest.raises(ValueError,
                       match=f"every one of {3 * tperf.SLOPE_TRIES} tries"):
        tperf._marginal_step_s(chains, 16, 64, repeats=2, best_of=3)
    assert chains.calls[16] == 1 + 2 * 3 * tperf.SLOPE_TRIES


def test_a_barely_positive_slope_of_a_stalled_short_chain_is_taken_again(
        monkeypatch):
    """The stalled short chains (minimum 10 s) leave the long ones' (10.05
    s) just above them: a slope of 0.05 / 48 s, below 1/256 of the short
    chain's 10 / 16 s an iteration, which the JAX helper keeps. The
    repeats run again, and the minima of both tries (1 s, 5 s) give the
    slope."""
    chains, slope = _slope_with(monkeypatch, {
        16: [1.0, 10.0, 10.0, 1.0, 1.0],
        64: [5.0, 10.05, 10.05, 5.0, 5.0]})
    assert slope == pytest.approx(4.0 / 48)
    assert chains.calls == {16: 5, 64: 5}


def test_a_refused_round_takes_its_minima_over_every_run(monkeypatch):
    """The first try's short chain stalls (10 s against the long one's 5
    s: crossed); the second try's long chain stalls (12 s). Each try alone
    reads nothing sound, or a slope of (12 - 1) / 48; the round's minima
    over both tries (1 s, 5 s) give (5 - 1) / 48."""
    chains, slope = _slope_with(monkeypatch, {
        16: [1.0, 10.0, 1.0], 64: [5.0, 5.0, 12.0]}, repeats=1)
    assert slope == pytest.approx(4.0 / 48)
    assert chains.calls == {16: 3, 64: 3}


def test_a_round_with_no_sound_slope_leaves_the_others_to_give_one(
        monkeypatch):
    """best_of 2: every try of the first round crosses, the second
    round's first try is sound, and its slope is returned."""
    tries = tperf.SLOPE_TRIES
    chains, slope = _slope_with(monkeypatch, {
        16: [1.0] + [10.0] * 2 * tries + [1.0, 1.0],
        64: [5.0] + [9.0] * 2 * tries + [4.0, 4.0]}, best_of=2)
    assert slope == pytest.approx(3.0 / 48)
    assert chains.calls == {16: 3 + 2 * tries, 64: 3 + 2 * tries}


def test_a_quiet_host_keeps_the_first_try_and_the_least_of_slopes(
        monkeypatch):
    """No minimum pair crosses: each slope is taken once, from the minima
    of its repeats, and the least of best_of slopes is returned, as the
    JAX ``best_marginal_time`` does."""
    chains, slope = _slope_with(monkeypatch, {
        16: [1.0, 1.2, 1.1, 1.0, 1.3, 1.0, 1.0],
        64: [5.0, 5.2, 5.0, 4.6, 4.9, 5.3, 5.1]}, best_of=3)
    # tries: min(1.2, 1.1) / min(5.2, 5.0) -> 3.9; (1.0, 1.3) / (4.6, 4.9)
    # -> 3.6; (1.0, 1.0) / (5.3, 5.1) -> 4.1
    assert slope == pytest.approx(3.6 / 48)
    assert chains.calls == {16: 7, 64: 7}
