"""A configuration brings its own block (``blocks/<block>.py``).

GPT-2's block reproduces what the harness gave before it moved there
(``golden_gpt2.json``, frozen from that code): the weight tree bit for
bit, the reference logits, the work counts. The harness itself holds no
GPT-2 key, and a second architecture is added as files alone.
"""

import hashlib
import json
import re
import shutil

import pytest
import torch

from harness import arith, manifest, reference
from harness.weights import make_weights

GOLDEN = json.loads((manifest.BENCH / "tests" / "golden_gpt2.json")
                    .read_text())
CONFIGS = ("gpt2-medium", "gpt2-medium-moe8")
CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


def _config(name: str, tiny: bool = False) -> dict:
    mf = manifest.load_manifest()
    config = manifest.load_config(mf, name)
    if tiny:
        config["model"] = dict(config["model"], **GOLDEN["tiny"])
    return config


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _digest(tree) -> tuple:
    """sha256 over every leaf's path, shape, type and bytes, in the tree's
    order, and the number of leaves."""
    h = hashlib.sha256()
    n = 0
    for path, t in _leaves(tree):
        name = "/".join(map(str, path))
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        raw = t.contiguous()
        raw = raw.view(torch.int16) if t.dtype == torch.bfloat16 \
            else raw.view(torch.uint8)
        h.update(raw.numpy().tobytes())
        n += 1
    return h.hexdigest(), n


@pytest.mark.parametrize("name", CONFIGS)
def test_the_weight_tree_is_the_same_bit_for_bit(name):
    tree = make_weights(_config(name, tiny=True), GOLDEN["seed"], CPU)
    golden = GOLDEN["weights"][name]
    assert _digest(tree) == (golden["sha256"], golden["paths"])


def _close(logits: torch.Tensor, golden: dict) -> None:
    lg = logits.double()
    assert list(lg.shape) == golden["shape"]
    assert lg.argmax(-1).flatten().tolist() == golden["argmax"]
    for got, want in ((lg.amax(-1).flatten(), golden["row_max"]),
                      (torch.logsumexp(lg, -1).flatten(), golden["lse"])):
        assert torch.allclose(got, torch.tensor(want, dtype=torch.float64),
                              rtol=1e-6, atol=1e-6)
    assert lg.sum().item() == pytest.approx(golden["sum"], rel=1e-6,
                                            abs=1e-3)
    assert lg.abs().sum().item() == pytest.approx(golden["abs_sum"],
                                                  rel=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("routing", ["batch", "groups"])
def test_the_reference_logits_are_the_same(name, routing):
    """A batch of two rows, each routing as one row; and one served
    sequence routed in its prefill chunks and decoded tokens."""
    config = _config(name, tiny=True)
    params32 = reference.fp32_tree(make_weights(config, GOLDEN["seed"], CPU))
    tokens = torch.tensor(GOLDEN["tokens"])
    with reference.full_fp32(), torch.no_grad():
        if routing == "batch":
            logits = reference.forward(params32, tokens, config)
        else:
            logits = reference.sequence_logits(
                params32, tokens[0].tolist(), config, CPU,
                groups=[tuple(g) for g in GOLDEN["groups"]])
    _close(logits, GOLDEN["logits"][f"{name}.{routing}"])


@pytest.mark.parametrize("name", CONFIGS)
def test_the_work_counts_are_the_same(name):
    config = _config(name)
    block, m, golden = manifest.block_of(config), config["model"], \
        GOLDEN["counts"][name]
    assert block.param_count(m) == golden["param_count"]
    assert block.active_param_count(m) == golden["active_param_count"]
    work = dict(zip(("prefill_tokens", "prefill_pairs", "first_tokens",
                     "decode_tokens", "decode_pairs"), golden["work"]))
    assert block.serve_flops(m, work) == golden["serve_flops"]
    assert block.decode_attention_least_s(
        m, golden["positions"], arith.peaks(H100)) == \
        golden["decode_attention_least_s"]


def test_the_published_counts():
    dense, moe = (_config(n) for n in CONFIGS)
    block = manifest.block_of(dense)
    assert block.param_count(dense["model"]) == 354_551_808
    assert block.param_count(moe["model"]) == 1_059_293_184
    assert block.active_param_count(moe["model"]) == 354_650_112


def test_the_expected_fill_is_the_same():
    traffic = manifest.load_traffic("serve-batch")
    golden = GOLDEN["fill"]
    for name, want in zip(CONFIGS, (golden["dense"], golden["moe"])):
        config = _config(name)
        assert manifest.block_of(config).expected_moe_fill(
            config["model"], traffic, golden["counts"]) == want


#: keys of GPT-2's weight tree and of its model dict
GPT2_KEYS = ("wqkv", "wo", "w1", "w2", "wg", "embed", "pos", "out_norm",
             "ln1", "ln2", "layers", "moe", "d_ff", "d_model", "n_heads",
             "n_layers", "moe_every", "moe_experts", "moe_capacity_factor",
             "moe_aux_weight", "max_seq", "vocab", "attention")


def test_the_harness_holds_no_gpt2_key():
    """No file of the harness, the readers, ``calibrate.py`` or
    ``span_split.py`` reads a GPT-2 weight or model key: what a block is
    lives in its own file."""
    bench = manifest.BENCH
    files = sorted((bench / "harness").glob("*.py")) \
        + sorted((bench / "metrics").glob("*.py")) \
        + [bench / "calibrate.py", bench / "span_split.py", bench / "run.py"]
    key = re.compile(r"""["'](%s)["']""" % "|".join(GPT2_KEYS))
    found = [f"{path.relative_to(bench)}:{i}: {line.strip()}"
             for path in files
             for i, line in enumerate(path.read_text().splitlines(), 1)
             if key.search(line)]
    assert found == []


#: a block unlike GPT-2's: no positions table, no attention, an untied
#: head, a causal running mean and gated layers
TOY_BLOCK = '''
import torch


def program_config(m):
    raise NotImplementedError("the port has no such model")


def vocab(m):
    return m["tokens"]


def positions(m):
    return m["context"]


def leaves(m):
    out = [(("table",), (m["tokens"], m["width"]), m["tokens"])]
    for i in range(m["depth"]):
        out.append((("blocks", i, "gate"), (m["width"], 2 * m["width"]),
                    m["width"]))
    out.append((("head",), (m["width"], m["tokens"]), m["width"]))
    return out


def norms(m):
    return [(("final",), (m["width"],))]


def forward(params, tokens, m, mm, groups=None):
    x = params["table"][tokens]
    steps = torch.arange(1, x.shape[1] + 1, device=x.device)[:, None]
    x = x.cumsum(1) / steps
    for blk in params["blocks"]:
        a, b = mm(x, blk["gate"]).chunk(2, -1)
        x = x + a * torch.sigmoid(b)
    return mm(x * params["final"], params["head"])


def param_count(m):
    w = m["width"]
    return 2 * m["tokens"] * w + m["depth"] * 2 * w * w + w


def active_param_count(m):
    return param_count(m)


def serve_flops(m, work):
    return 2.0 * (param_count(m) - m["tokens"] * m["width"]) * (
        work["prefill_tokens"] + work["decode_tokens"])


def decode_attention_least_s(m, rows, peak):
    return 0.0


def expected_moe_fill(m, traffic, counts):
    return None
'''


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _tree(root) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_block_added_as_files_is_found_drawn_and_run(tmp_path):
    root = _checkout(tmp_path)
    before = _tree(root)
    bench = root / "benchmark"
    (bench / "blocks" / "toy.py").write_text(TOY_BLOCK)
    model = {"tokens": 50, "width": 16, "depth": 3, "context": 32,
             "dtype": "float32"}
    (bench / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "block": "toy", "source": "test", "reduced": [],
         "model": model}))
    mf = manifest.load_manifest()
    mf["configs"].append({"name": "toy", "source": "test", "reduced": [],
                          "file": "benchmark/configs/toy.json", "why": "t"})
    after = _tree(root)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(root) for p in (bench / "blocks" / "toy.py",
                                      bench / "configs" / "toy.json")}

    config = manifest.load_config(mf, "toy", root)
    block = manifest.block_of(config)
    assert block.vocab(model) == 50 and block.positions(model) == 32
    tree = make_weights(config, 2 ** 31 + 9, CPU)
    assert tree["table"].shape == (50, 16) and len(tree["blocks"]) == 3
    assert torch.equal(tree["final"], torch.ones(16))
    assert tree["head"].std().item() == pytest.approx(0.25, rel=0.2)
    assert torch.equal(make_weights(config, 2 ** 31 + 9, CPU)["head"],
                       tree["head"])
    logits = reference.sequence_logits(reference.fp32_tree(tree),
                                       list(range(20)), config, CPU)
    assert logits.shape == (20, 50) and torch.isfinite(logits).all()


def test_a_missing_block_fails_at_load_with_its_name(tmp_path):
    root = _checkout(tmp_path)
    (root / "benchmark" / "configs" / "orphan.json").write_text(json.dumps(
        {"name": "orphan", "block": "no-such-block", "model": {}}))
    mf = manifest.load_manifest()
    mf["configs"].append({"name": "orphan", "source": "test", "reduced": [],
                          "file": "benchmark/configs/orphan.json",
                          "why": "t"})
    with pytest.raises(FileNotFoundError, match="no-such-block"):
        manifest.load_config(mf, "orphan", root)
