"""The readers of the serving loop's counters, on runs written by hand:
``pool_gauge_ms.serve``, ``decode_launch_ms.serve`` and
``moe_expert_fill.serve`` read the ``detail`` of the scheduler's
``StepLedger`` entries that the harness hands them, and read nothing where
a program without ``detail`` ran, or where nothing decoded or no expert
row was computed."""

import pytest

from harness.manifest import metric_reader

READERS = ("pool_gauge_ms.serve", "decode_launch_ms.serve",
           "moe_expert_fill.serve")


def _entry(decode, detail=None):
    e = {"phases": {"prefill": 0.01, "decode": decode, "verify": 0.0,
                    "cow": 0.1, "sched": 0.02, "compile": 0.0}}
    if detail is not None:
        e["detail"] = detail
    return e


def _detail(gauge_s, wait_decode, routed=0, rows=0):
    return {"pool_gauge_s": gauge_s, "decode_wait_s": wait_decode,
            "moe_routed_tokens": routed, "moe_expert_rows": rows}


def _run(entries):
    return {"host": {"iterations": [(256, e) for e in entries]}}


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    """No host part (a run without a trace), no iteration, a parent's
    entries without ``detail``, and a dense model: no value."""
    read = metric_reader(name)
    assert read({}) is None
    assert read(_run([])) is None
    assert read(_run([_entry(0.02), _entry(0.03)])) is None
    if name == "moe_expert_fill.serve":
        assert read(_run([_entry(0.02, _detail(0.1, 0.01))])) is None
    else:
        # iterations that did not decode are not averaged
        assert read(_run([_entry(0.0, _detail(0.1, 0.0))])) is None


def test_pool_gauge_ms_is_the_mean_over_decoding_iterations():
    read = metric_reader("pool_gauge_ms.serve")
    run = _run([_entry(0.02, _detail(0.100, 0.005)),
                _entry(0.03, _detail(0.140, 0.010)),
                _entry(0.0, _detail(0.500, 0.0))])   # a prefill-only one
    assert read(run) == pytest.approx(120.0)


def test_decode_launch_ms_is_the_decode_segment_less_its_wait():
    read = metric_reader("decode_launch_ms.serve")
    run = _run([_entry(0.020, _detail(0.1, 0.004)),
                _entry(0.030, _detail(0.1, 0.010)),
                _entry(0.0, _detail(0.1, 0.0))])
    # (16 + 20) / 2 ms
    assert read(run) == pytest.approx(18.0)


def test_moe_expert_fill_sums_tokens_over_rows():
    """Two decode passes over 256 slots (16,384 rows each over 8 experts
    at capacity 8), 200 and 256 of them active, and one chunk of 512
    columns (640 rows) holding 300 valid tokens, per MoE layer: real
    tokens over rows, over every iteration, decoding or not."""
    read = metric_reader("moe_expert_fill.serve")
    layers = 12
    full = _detail(0.1, 0.01, routed=layers * 256, rows=layers * 16384)
    part = _detail(0.1, 0.01, routed=layers * 200, rows=layers * 16384)
    chunk = _detail(0.1, 0.0, routed=layers * 300, rows=layers * 640)
    assert read(_run([_entry(0.02, full)])) == pytest.approx(1.5625)
    assert read(_run([_entry(0.0, chunk)])) == pytest.approx(46.875)
    both = read(_run([_entry(0.02, full), _entry(0.02, part),
                      _entry(0.0, chunk)]))
    assert both == pytest.approx(100.0 * (256 + 200 + 300)
                                 / (2 * 16384 + 640))


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_span_split_divides_each_gap_among_the_program_ranges():
    """``span_split``'s reduction: a gap under the scheduler's step (by its
    middle, as the benchmark labels it) split exactly among the innermost
    program ranges over it, and a gap under the executor's span."""
    from span_split import scheduler_share, split_idle
    events = [
        _x("bench.slice", "user_annotation", 0, 100),
        _x("bench.scheduler.step", "user_annotation", 0, 100),
        _x("serve.step", "user_annotation", 0, 100),
        _x("serve.commit", "user_annotation", 10, 50),
        _x("kv_pool.gauges", "user_annotation", 20, 10),
        _x("kv_pool.gauges", "user_annotation", 40, 5),
        _x("serve.decode", "user_annotation", 65, 30),
        _x("bench.executor.step", "user_annotation", 70, 22),
        _x("executor.wait", "user_annotation", 80, 10),
        _x("attn_decode_split_kernel", "kernel", 70, 10, tid=7),
    ]
    split = split_idle(events)["split"]
    assert split["bench.scheduler.step"] == pytest.approx(
        {"serve.step": 15e-6, "serve.commit": 35e-6,
         "kv_pool.gauges": 15e-6, "serve.decode": 5e-6})
    assert split["bench.executor.step"] == pytest.approx(
        {"executor.wait": 10e-6, "serve.decode": 5e-6, "serve.step": 5e-6})
    share = scheduler_share(split)
    assert share["idle_s"] == pytest.approx(70e-6)
    assert share["share"] == pytest.approx(55 / 70)
    assert list(share["by_range"])[0] == "serve.commit"


def test_span_split_fill_from_the_shapes():
    """The MoE cell's shapes: a decode pass computes 16,384 expert rows a
    layer, whatever its active slots, and a chunk of 512 columns 640,
    whatever its valid tokens."""
    from harness.manifest import block_of
    expected_moe_fill = block_of({"block": "gpt2"}).expected_moe_fill
    model = {"moe_experts": 8, "moe_capacity_factor": 1.25}
    traffic = {"slots": 256, "chunk_tokens": 512}

    def counts(decode, decode_tokens, chunk, chunk_tokens):
        return {"decode": decode, "decode_tokens": decode_tokens,
                "chunk": chunk, "chunk_tokens": chunk_tokens}

    assert expected_moe_fill(model, traffic, counts(1, 256, 0, 0)) \
        == pytest.approx(1.5625)
    assert expected_moe_fill(model, traffic, counts(0, 0, 1, 512)) \
        == pytest.approx(80.0)
    assert expected_moe_fill(model, traffic, counts(2, 300, 1, 100)) \
        == pytest.approx(100.0 * 400 / (2 * 16384 + 640))
    assert expected_moe_fill({"moe_experts": 0}, traffic,
                             counts(3, 700, 1, 512)) is None
