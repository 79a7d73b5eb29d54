"""The reduction of a traced slice, on a trace written by hand."""

import pytest

from harness.trace import reduce_trace, short_name


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_busy_idle_and_the_gaps_host_side():
    events = [
        _x("bench.slice", "user_annotation", 0, 100),
        _x("bench.scheduler.step", "user_annotation", 0, 100),
        _x("bench.executor.step", "user_annotation", 10, 50),
        _x("aten::mm", "cpu_op", 12, 5),
        _x("aten::index_put_", "cpu_op", 70, 20),
        _x("void attn_decode_split_kernel<128>(float*)", "kernel", 20, 30,
           tid=7),
        _x("ampere_gemm", "kernel", 40, 20, tid=7),   # overlaps: 20-60
        _x("memcpy", "gpu_memcpy", 95, 10, tid=8),   # clipped at 100
    ]
    out = reduce_trace(events)
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx((40 + 5) * 1e-6)
    assert out["kernels"]["attn_decode_split_kernel<128>"] == \
        pytest.approx(30e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    # 0-20: the executor's span at its middle, no op; 60-95 the
    # index_put inside the scheduler's step
    assert gaps["bench.executor.step"] == pytest.approx(20e-6)
    assert gaps["bench.scheduler.step / aten::index_put_"] == \
        pytest.approx(35e-6)
    assert out["breakdown"]["device_ops"][0][0] == \
        "attn_decode_split_kernel<128>"


def test_short_names():
    assert short_name("void k<1, (x)2>(int, float)") == "k<1, (x)2>"
    assert short_name("memcpy HtoD") == "memcpy HtoD"


def test_the_decode_roofline_counts_live_rows_only():
    """The executor decodes every slot; the traced step records the
    positions of the rows the scheduler handed it, so an idle slot at a
    stale position adds no work to the roofline's count."""
    import numpy as np

    from harness import manifest
    from harness.serve_cell import _Recorder

    class Executor:
        pos = np.array([5, 900, 7, 1000])

        def step(self, active):
            return {s: 0 for s, _ in active}

        def prefill_chunk(self, req, slot, offset, n):
            return None

    ex = Executor()
    recorder = _Recorder(ex)
    recorder.in_slice = True
    ex.step([(0, None), (2, None)])
    rows = [c[3] for c in recorder.calls if c[0] == "step" and c[4]]
    assert rows == [[5, 7]]
    model = {"d_model": 64, "n_layers": 2}
    peak = {"bfloat16": 1e15, "hbm_bytes_per_s": 1e9}
    block = manifest.block_of({"block": "gpt2"})
    least = block.decode_attention_least_s(model, [5, 7], peak)
    run = {"model": model, "block": block, "peak": peak,
           "slice": {"decode_positions": rows,
                     "kernels": {"attn_decode_split_kernel<64>": least * 2}}}
    assert manifest.metric_reader("decode_attn_roofline.serve")(run) == \
        pytest.approx(50.0)
