"""The frozen counts against values worked by hand."""

import json

import pytest

from harness import arith, manifest

PEAK = {"bfloat16": 1e12, "hbm_bytes_per_s": 1e9}
GPT2 = manifest.block_of({"block": "gpt2"})


def _model(name: str) -> dict:
    return _config(name)["model"]


def _config(name: str) -> dict:
    return json.loads((manifest.BENCH / "configs" / f"{name}.json")
                      .read_text())


def test_parameter_counts():
    # embed 50257 x 1024 + pos 1024 x 1024 + out_norm 1024, and 24 layers
    # of 2 x 1024 + 4 x 1024^2 + 2 x 1024 x 4096
    dense = 51463168 + 1048576 + 1024 + 24 * 12584960
    assert GPT2.param_count(_model("gpt2-medium")) == dense == 354551808
    # twelve MoE layers swap 2 x 1024 x 4096 for a router 1024 x 8 and 8
    # experts; one expert is active
    moe = _model("gpt2-medium-moe8")
    assert GPT2.param_count(moe) == dense + 12 * (8192 + 7 * 8388608)
    assert GPT2.active_param_count(moe) == dense + 12 * 8192
    for name in ("gpt2-medium", "gpt2-medium-moe8"):
        c = _config(name)
        assert c["parameters"] == GPT2.param_count(c["model"])


@pytest.mark.parametrize("name", ["gpt2-medium", "gpt2-medium-moe8"])
def test_widths_are_the_sources(name):
    """Every width, the depth, the vocabulary and the positions are the
    source's own numbers."""
    c = _config(name)
    m, src = c["model"], c["source_config"]
    assert (m["d_model"], m["n_heads"], m["n_layers"], m["max_seq"],
            m["vocab"]) == (src["n_embd"], src["n_head"], src["n_layer"],
                            src["n_positions"], src["vocab_size"])
    assert m["d_ff"] == (src["n_inner"] or 4 * src["n_embd"])


def test_causal_pairs():
    assert arith.causal_pairs(4) == 10          # 1 + 2 + 3 + 4
    assert arith.causal_pairs(2, 3) == 4 + 5    # rows at 3 and 4


def test_decode_attention_least_time():
    m = {"d_model": 8, "n_layers": 2}
    # rows at 0 and 2: 1 + 3 keys; K and V of 4 keys and q, out of 2 rows,
    # 8 wide in bf16: (2 x 4 x 8 + 2 x 2 x 8) x 2 bytes = 192 a layer
    assert GPT2.decode_attention_least_s(m, [0, 2], PEAK) == \
        pytest.approx(2 * 192 / 1e9)


def test_serve_flops():
    m = {"d_model": 2, "d_ff": 4, "n_layers": 1, "vocab": 10,
         "moe_experts": 0, "moe_every": 2}
    # layer products 4 x 4 + 2 x 8 = 32; 3 prefilled + 2 decoded tokens;
    # logits 10 x 2 for 1 first + 2 decoded; 7 pairs at 4 x 2
    work = {"prefill_tokens": 3, "prefill_pairs": 5, "first_tokens": 1,
            "decode_tokens": 2, "decode_pairs": 2}
    assert GPT2.serve_flops(m, work) == 2 * 32 * 5 + 2 * 20 * 3 + 4 * 2 * 7


def test_peaks_by_exact_name():
    assert arith.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    assert arith.peaks("NVIDIA H100 PCIe") is None
