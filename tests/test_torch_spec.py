"""Speculative decoding in the PyTorch/CUDA port, on the CPU, against the
JAX package.

The port's ``spec`` module, the sharing half of its ``kv_pool``, its
``TorchSlotExecutor.spec_step`` and its scheduler's speculation are each
held against their JAX twins on the same inputs: equal return values and
counters for the pure-Python parts, exact greedy streams for the model
(fp32 against JAX's ``generate``; fp32 and bf16 against the port's own),
and identical scheduler traces on the synthetic executors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads import decode as jdecode
from dpu_operator_tpu.workloads import kv_pool as jkv
from dpu_operator_tpu.workloads import model as jmodel
from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu.workloads import spec as jspec
from dpu_operator_tpu_torch.workloads import decode as tdecode
from dpu_operator_tpu_torch.workloads import kv_pool as tkv
from dpu_operator_tpu_torch.workloads import model as tmodel
from dpu_operator_tpu_torch.workloads import serve as tserve
from dpu_operator_tpu_torch.workloads import spec as tspec

SEED = 20260806
#: the tiny model of tests/test_spec.py
SHAPE = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=64)


def _bridge(dtype):
    jcfg = jmodel.TransformerConfig(dtype=jnp.dtype(dtype), **SHAPE)
    tcfg = tmodel.TransformerConfig(dtype=getattr(torch, dtype), **SHAPE)
    jparams = jmodel.init_params(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, tcfg, tmodel.params_from_numpy(tree, tcfg,
                                                         device="cpu")


@pytest.fixture(scope="module")
def f32():
    return _bridge("float32")


@pytest.fixture(scope="module")
def bf16():
    return _bridge("bfloat16")


def _port_request(r):
    """A JAX arrival as a fresh port Request."""
    return tserve.Request(rid=r.rid, prompt_len=r.prompt_len,
                          output_len=r.output_len, slo_class=r.slo_class,
                          arrival_s=r.arrival_s, prompt=r.prompt)


# -- spec.py: the same answers on the same inputs ------------------------------

ACCEPT_CASES = [([5, 6, 7], [5, 6, 7, 9]), ([5, 6, 7], [5, 8, 7, 9]),
                ([], [42]), ([1, 2, 3, 4], [1, 2, 3, 4, 5]),
                ([1, 2, 3, 4], [9, 9, 9, 9, 9])]


def _random_accept_cases(n):
    rng = np.random.default_rng(SEED)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 6))
        truth = rng.integers(0, 4, k + 1).tolist()
        drafts = [t if rng.random() < 0.7 else int(rng.integers(0, 4))
                  for t in truth[:k]]
        out.append((drafts, truth))
    return out


@pytest.mark.parametrize("drafts,argmaxes",
                         ACCEPT_CASES + _random_accept_cases(20))
def test_greedy_accept_matches_jax(drafts, argmaxes):
    assert tspec.greedy_accept(drafts, argmaxes) \
        == jspec.greedy_accept(drafts, argmaxes)


def test_greedy_accept_rejects_length_mismatch_as_jax_does():
    for fn in (tspec.greedy_accept, jspec.greedy_accept):
        with pytest.raises(ValueError):
            fn([1, 2], [1, 2])


DRAFT_CASES = [(3, 1, [10, 11, 12, 13, 99, 11, 12, 13], 2),
               (1, 1, [7, 1, 7, 2, 7], 1), (2, 1, [5, 6, 9, 3, 5, 6], 1),
               (3, 1, [1, 2, 3, 4], 4), (3, 1, [], 4), (3, 1, [1], 4),
               (3, 1, [1, 2, 3], 0), (1, 1, [4, 8, 9, 10, 11, 4], 2),
               (1, 1, [4, 8, 9, 10, 11, 4], 10)]


def _random_draft_cases(n):
    rng = np.random.default_rng(SEED + 1)
    return [(int(rng.integers(1, 4)), 1,
             rng.integers(0, 5, int(rng.integers(0, 30))).tolist(),
             int(rng.integers(0, 6))) for _ in range(n)]


@pytest.mark.parametrize("max_ngram,min_ngram,ids,k",
                         DRAFT_CASES + _random_draft_cases(20))
def test_ngram_drafter_matches_jax(max_ngram, min_ngram, ids, k):
    got = tspec.NgramDrafter(max_ngram, min_ngram).propose(ids, k)
    assert got == jspec.NgramDrafter(max_ngram, min_ngram).propose(ids, k)


def test_ngram_drafter_refuses_bad_ngram_range_as_jax_does():
    for cls in (tspec.NgramDrafter, jspec.NgramDrafter):
        with pytest.raises(ValueError):
            cls(max_ngram=1, min_ngram=2)


def _random_outcomes(n):
    out = []
    for s in range(n):
        rng = np.random.default_rng(SEED + s)
        proposed = rng.integers(0, 5, 40)
        accepted = (proposed * rng.random(40)).astype(int)
        out.append((float(rng.random()),
                    [(int(p), int(a)) for p, a in zip(proposed, accepted)]))
    return out


@pytest.mark.parametrize("init_rate,outcomes", [
    (0.5, [(4, 4)] * 50), (0.9, [(4, 0)] * 50), (0.0, []),
    (0.5, [(3, 1), (0, 0), (2, 2), (4, 3), (1, 0)]),
    *_random_outcomes(6)])
def test_adaptive_k_matches_jax(init_rate, outcomes):
    """The EWMA, the lifetime rate and the chosen k after every outcome,
    at two batch sizes and two cost models, equal the JAX policy's."""
    ours = tspec.AdaptiveK(k_max=4, init_rate=init_rate)
    theirs = jspec.AdaptiveK(k_max=4, init_rate=init_rate)
    costs = [(tserve.CostModel(), jserve.CostModel()),
             (tserve.CostModel(spec_verify_per_token_s=0.004),
              jserve.CostModel(spec_verify_per_token_s=0.004))]
    for proposed, accepted in [(0, 0)] + outcomes:
        ours.observe(proposed, accepted)
        theirs.observe(proposed, accepted)
        assert ours.rate == theirs.rate
        assert ours.acceptance_rate() == theirs.acceptance_rate()
        assert [ours.expected_tokens(k) for k in range(5)] \
            == [theirs.expected_tokens(k) for k in range(5)]
        for tc, jc in costs:
            for batch in (0, 1, 8):
                assert ours.choose(tc, batch) == theirs.choose(jc, batch)
    assert (ours.proposed_total, ours.accepted_total) \
        == (theirs.proposed_total, theirs.accepted_total)


def test_cost_model_verify_collapses_to_decode_at_k0():
    cm = tserve.CostModel()
    assert cm.verify_s(8, 0) == cm.decode_s(8)
    assert cm.verify_s(8, 4) > cm.decode_s(8)
    assert cm.verify_s(8, 4) == jserve.CostModel().verify_s(8, 4)


# -- kv_pool.py: rollback and sharing ------------------------------------------


def test_pool_rollback_unwrites_past_frontier():
    pool = tkv.KvBlockPool(num_blocks=4, block_size=4)
    pool.alloc("a", 3)
    pool.set_used_tokens("a", 9)
    assert pool.rollback_tokens("a", 6) == 3
    assert pool.spec_rollback_tokens == 3
    assert pool.free_blocks() == 1  # accounting only: blocks stay
    pool.free("a")
    assert pool.outstanding() == 0


def test_pool_rollback_never_extends_and_guards_inputs():
    pool = tkv.KvBlockPool(num_blocks=4, block_size=4)
    pool.alloc("a", 2)
    pool.set_used_tokens("a", 3)
    assert pool.rollback_tokens("a", 8) == 0
    with pytest.raises(KeyError):
        pool.rollback_tokens("ghost", 0)
    with pytest.raises(ValueError):
        pool.rollback_tokens("a", -1)


def test_pool_rollback_preserves_cow_copy_in_shared_block():
    pool = tkv.KvBlockPool(num_blocks=8, block_size=4, sharing=True)
    keys = tkv.chain_keys(tuple(range(8)), 4)
    pool.alloc("a", 3)
    for i in range(8):
        pool.write_token("a", i)
    pool.register_prefix("a", keys, 8)
    assert pool.map_prefix("b", keys) == 2
    pool.alloc("b", 1)
    before = pool.cow_copies
    assert pool.write_token("b", 8) is False
    pool.set_used_tokens("b", 9)
    assert pool.rollback_tokens("b", 8) == 1
    assert pool.write_token("b", 7) is True
    assert pool.cow_copies == before + 1
    pool.rollback_tokens("b", 7)
    assert pool.cow_copies == before + 1
    pool.free("a")
    pool.free("b")
    assert pool.outstanding() == 0


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_chain_keys_match_jax(block_size):
    rng = np.random.default_rng(SEED)
    for n in (0, 1, 3, 4, 17, 33):
        toks = tuple(int(t) for t in rng.integers(0, 50_000, n))
        assert tkv.chain_keys(toks, block_size) \
            == jkv.chain_keys(toks, block_size)


def _pool_ops(seed, n_ops):
    """A seeded sequence of sharing operations over owners whose prompts
    share one of three prefixes: (name, owner, argument)."""
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(t) for t in rng.integers(0, 9, 9))
                for _ in range(3)]
    ops = []
    for i in range(n_ops):
        r = rng.random()
        prompt = prefixes[int(rng.integers(3))] \
            + tuple(int(t) for t in rng.integers(0, 9,
                                                 int(rng.integers(0, 6))))
        ops.append(("admit" if r < 0.3 else "write" if r < 0.6
                    else "rollback" if r < 0.75 else "register" if r < 0.9
                    else "free", int(rng.integers(8)), prompt,
                    float(rng.random())))
    return ops


@pytest.mark.parametrize("seed", range(4))
def test_pool_sharing_sequence_matches_jax(seed):
    """The same operations on both pools (probe, map, alloc, write with
    copy-on-write, register, rollback, free) give the same return values,
    the same block maps and the same three counters after every step."""
    bs = 4
    ours = tkv.KvBlockPool(24, bs, sharing=True)
    theirs = jkv.KvBlockPool(24, bs, sharing=True)
    live = {}
    for op, o, prompt, u in _pool_ops(SEED + seed, 300):
        owner = f"o{o}"
        if op == "admit" and owner not in live:
            keys = tkv.chain_keys(prompt, bs)
            assert keys == jkv.chain_keys(prompt, bs)
            blocks = -(-(len(prompt) + 6) // bs)
            fresh = blocks - ours.probe_prefix(keys)
            assert fresh == blocks - theirs.probe_prefix(keys)
            if not ours.can_alloc(fresh):
                assert not theirs.can_alloc(fresh)
                continue
            mapped = ours.map_prefix(owner, keys)
            assert mapped == theirs.map_prefix(owner, keys)
            assert ours.alloc(owner, blocks - mapped) \
                == theirs.alloc(owner, blocks - mapped)
            live[owner] = (keys, len(prompt), blocks * bs)
        elif owner in live:
            keys, plen, cap = live[owner]
            if op == "write":
                pos = int(u * cap)
                assert ours.write_token(owner, pos) \
                    == theirs.write_token(owner, pos)
                ours.set_used_tokens(owner, pos + 1)
                theirs.set_used_tokens(owner, pos + 1)
            elif op == "rollback":
                tokens = int(u * cap)
                assert ours.rollback_tokens(owner, tokens) \
                    == theirs.rollback_tokens(owner, tokens)
            elif op == "register":
                assert ours.register_prefix(owner, keys, plen) \
                    == theirs.register_prefix(owner, keys, plen)
            else:
                assert ours.free(owner) == theirs.free(owner)
                del live[owner]
        for name in live:
            assert ours.blocks_of(name) == theirs.blocks_of(name)
        assert (ours.cow_copies, ours.prefix_block_hits,
                ours.spec_rollback_tokens, ours.outstanding()) \
            == (theirs.cow_copies, theirs.prefix_block_hits,
                theirs.spec_rollback_tokens, theirs.outstanding())
    assert ours.prefix_block_hits > 0 and ours.cow_copies > 0
    for owner in list(live):
        ours.free(owner)
    assert ours.outstanding() == 0


# -- verify: exact greedy identity ---------------------------------------------


def _spec_generate(params, cfg, prompt, out_len, k, ref, corrupt):
    """The port's verify_step driven with an oracle drafter (drafts copied
    from *ref*, the last one corrupted when *corrupt*) and the exact greedy
    rule at the fixed width k + 1, as tests/test_spec.py drives JAX's."""
    cache, logits = tdecode.prefill(params, cfg, torch.tensor([prompt]))
    toks = [int(logits[0].argmax())]
    pos = len(prompt)
    while len(toks) < out_len:
        kk = min(k, out_len - len(toks) - 1)
        drafts = list(ref[len(toks):len(toks) + kk])
        if corrupt and drafts:
            drafts[-1] = (drafts[-1] + 1) % cfg.vocab
        row = [toks[-1]] + drafts + [toks[-1]] * (k - len(drafts))
        logits, cache = tdecode.verify_step(
            params, cfg, cache, torch.tensor([row]),
            torch.tensor([pos], dtype=torch.int32))
        arg = logits.argmax(-1)[0].tolist()
        _, emitted = tspec.greedy_accept(drafts, arg[:len(drafts) + 1])
        toks.extend(emitted)
        pos += len(emitted)
    return toks[:out_len]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_verify_streams_identical_to_generate(f32, bf16, dtype, k):
    """Speculation through the port's verify_step, with rejections forced
    every iteration, emits exactly the port's generate stream; in fp32
    that stream is JAX's generate stream from the same weights."""
    jcfg, jparams, cfg, params = f32 if dtype == "float32" else bf16
    prompt = [3, 7, 11, 5, 2]
    out_len = 12
    ref = tdecode.generate(params, cfg, torch.tensor([prompt]), out_len,
                           device="cpu")[0].tolist()
    if dtype == "float32":
        jref = jdecode.generate(jparams, jcfg,
                                jnp.asarray([prompt], jnp.int32), out_len)
        assert ref == [int(t) for t in np.asarray(jref)[0]]
    for corrupt in (True, False):
        assert _spec_generate(params, cfg, prompt, out_len, k, ref,
                              corrupt) == ref


def test_spec_step_at_the_end_of_a_slot_row(f32):
    """A slot at max_seq - 2 verified at width 5 writes its two rows and
    no other (the three rows past max_seq are dropped, not wrapped onto
    the row's start), and its two logits rows are the two decode steps'."""
    _, _, cfg, params = f32
    ex = tserve.TorchSlotExecutor(params, cfg, slots=2, spec_k=4,
                                  device="cpu")
    rng = np.random.default_rng(SEED)
    for layer in ex.cache:
        for key in layer:
            layer[key].copy_(torch.from_numpy(
                rng.standard_normal(layer[key].shape).astype(np.float32)))
    before = [{k: t.clone() for k, t in layer.items()} for layer in ex.cache]
    s = cfg.max_seq
    # slot 0 alone, one decode step at a time, on a copy of the cache: the
    # drafts accept the first step's token and reject the second's
    twin = [{k: t.clone() for k, t in layer.items()} for layer in before]
    argmaxes, tok = [], 5
    for i in range(2):
        logits, _ = tdecode.decode_step(
            params, cfg, twin, torch.tensor([tok, 0]),
            torch.tensor([s - 2 + i, 0], dtype=torch.int32))
        tok = int(logits[0].argmax())
        argmaxes.append(tok)
    ex.pos[:] = [s - 2, 20]
    ex.last[:] = [5, 9]
    reqs = [tserve.Request(rid=f"r{i}", prompt_len=1, output_len=8)
            for i in range(2)]
    drafts = {0: [argmaxes[0], (argmaxes[1] + 1) % cfg.vocab, 2, 3],
              1: [4, 4]}
    emitted = ex.spec_step(list(enumerate(reqs)), drafts)
    assert emitted[0] == argmaxes
    assert ex.pos[0] == s and ex.last[0] == argmaxes[1]
    for layer, old, ref in zip(ex.cache, before, twin):
        for key in ("k", "v"):
            changed = (layer[key] != old[key]).flatten(2).any(-1)
            assert changed[0].nonzero().flatten().tolist() == [s - 2, s - 1]
            assert changed[1].nonzero().flatten().tolist() == [20, 21, 22,
                                                               23, 24]
            torch.testing.assert_close(layer[key][0, s - 2:],
                                       ref[key][0, s - 2:])


def test_spec_step_needs_a_verify_width(f32):
    _, _, cfg, params = f32
    ex = tserve.TorchSlotExecutor(params, cfg, slots=1, device="cpu")
    assert ex.spec_width is None
    with pytest.raises(ValueError, match="spec_k"):
        ex.spec_step([], {})
    assert tserve.TorchSlotExecutor(params, cfg, slots=1, spec_k=3,
                                    device="cpu").spec_width == 4


# -- the scheduler with the real model -----------------------------------------


class _OracleDrafter:
    """Drafts copied from per-request reference streams (keyed by prompt),
    the last of two or more corrupted: forced mid-speculation rejections
    on the real verify path (tests/test_spec.py's drafter)."""

    def __init__(self, refs, prompts, vocab):
        self.refs, self.prompts, self.vocab = refs, prompts, vocab

    def propose(self, ids, k):
        ids = list(ids)
        for rid, p in self.prompts.items():
            if len(ids) >= len(p) and tuple(ids[:len(p)]) == p:
                done = len(ids) - len(p)
                d = list(self.refs[rid][done:done + k])
                if len(d) >= 2:
                    d[-1] = (d[-1] + 1) % self.vocab
                return d
        return []


@pytest.mark.parametrize("chunk", [0, 4])
def test_scheduler_spec_streams_match_jax_through_preemption(f32, chunk):
    """The twin of tests/test_spec.py's serving-path identity, in fp32:
    an interactive request preempts a batch request mid-speculation, and
    every stream still equals JAX's generate from the same weights."""
    jcfg, jparams, cfg, params = f32
    prompts = {"b1": (3, 7, 11, 5), "b2": (9, 2, 4, 1),
               "hot": (1, 1, 2, 3, 5)}
    out_len = 10
    refs = {rid: [int(t) for t in np.asarray(jdecode.generate(
        jparams, jcfg, jnp.asarray([list(p)], jnp.int32), out_len))[0]]
        for rid, p in prompts.items()}
    ex = tserve.TorchSlotExecutor(params, cfg, slots=2, chunk_tokens=chunk,
                                  spec_k=3, device="cpu")
    sched = tserve.Scheduler(
        tserve.ServeConfig(slots=2, kv_blocks=4, kv_block_size=16,
                           spec_k=3, preemption=True,
                           prefill_chunk_tokens=chunk),
        ex, drafter=_OracleDrafter(refs, prompts, cfg.vocab))
    for rid, cls, t in (("b1", tserve.BATCH, 0.0), ("b2", tserve.BATCH, 0.0),
                        ("hot", tserve.INTERACTIVE, 0.002)):
        sched.submit(tserve.Request(rid=rid, prompt_len=len(prompts[rid]),
                                    output_len=out_len, prompt=prompts[rid],
                                    slo_class=cls, arrival_s=t))
    sched.run()
    assert {r.rid: r.tokens for r in sched.completed} == refs
    assert any(t[0] == "preempt" for t in sched.trace)
    spec = [t for t in sched.trace if t[0] == "spec"]
    assert spec and any(t[4] < t[3] for t in spec)
    assert sched.pool.outstanding() == 0


def test_scheduler_spec_construction_guards(f32):
    _, _, cfg, params = f32
    ex = tserve.TorchSlotExecutor(params, cfg, slots=2, device="cpu")
    with pytest.raises(ValueError, match="verify"):
        tserve.Scheduler(tserve.ServeConfig(slots=2, spec_k=2), ex)
    ex2 = tserve.TorchSlotExecutor(params, cfg, slots=2, spec_k=1,
                                   device="cpu")
    with pytest.raises(ValueError, match="width"):
        tserve.Scheduler(tserve.ServeConfig(slots=2, spec_k=3), ex2)
    # wide enough, or no speculation asked for: accepted
    tserve.Scheduler(tserve.ServeConfig(slots=2, spec_k=1), ex2)
    tserve.Scheduler(tserve.ServeConfig(slots=2), ex)


# -- the scheduler on the synthetic executors ----------------------------------


def _spec_config(**kw):
    base = dict(slots=4, kv_blocks=64, kv_block_size=16, queue_limit=256,
                spec_k=4)
    base.update(kw)
    return tserve.ServeConfig(**base)


def _arrivals(fn, *args, **kw):
    return [_port_request(r) for r in fn(SEED, *args, **kw)]


class _WrongDrafter:
    """Always proposes tokens the synthetic stream rejects."""

    def propose(self, ids, k):
        return [1] * k


class _FlakyDrafter:
    """Prompt-lookup drafts with every second proposal's tail corrupted
    (tests/test_spec.py's drafter, over either package's NgramDrafter)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = 0

    def propose(self, ids, k):
        d = self.inner.propose(ids, k)
        self.calls += 1
        if d and self.calls % 2 == 0:
            d[-1] = (d[-1] + 1) % 50_021
        return d


def test_spec_run_matches_plain_run_token_for_token():
    def run(spec_k):
        sched = tserve.Scheduler(_spec_config(spec_k=spec_k),
                                 tserve.PeriodicSimExecutor(4))
        arrivals = _arrivals(jserve.open_loop_arrivals, 8.0, 10.0)
        for r in arrivals:
            sched.submit(r)
        sched.run()
        return sched, arrivals

    on, arrivals = run(4)
    off, _ = run(0)
    tok_on = {r.rid: r.tokens for r in on.completed}
    assert tok_on == {r.rid: r.tokens for r in off.completed}
    assert len(tok_on) == len(arrivals)
    assert on._spec.proposed_total > 0
    assert on._spec.acceptance_rate() > 0.8
    assert on.pool.outstanding() == 0


def test_spec_traces_are_bit_deterministic():
    def run():
        sched = tserve.Scheduler(
            _spec_config(prefix_sharing=True, prefill_chunk_tokens=32),
            tserve.PeriodicSimExecutor(4))
        for r in _arrivals(jserve.open_loop_arrivals, 10.0, 12.0):
            sched.submit(r)
        sched.run()
        return sched.trace
    t1, t2 = run(), run()
    assert t1 == t2
    assert any(t[0] == "spec" for t in t1)


def test_spec_degrades_to_plain_decode_under_hostile_acceptance():
    sched = tserve.Scheduler(_spec_config(), tserve.SimExecutor(),
                             drafter=_WrongDrafter())
    for r in _arrivals(jserve.open_loop_arrivals, 6.0, 15.0):
        sched.submit(r)
    sched.run()
    spec_events = [t for t in sched.trace if t[0] == "spec"]
    assert spec_events
    assert max(t[1] for t in spec_events) < sched.iterations
    assert sched._spec.rate < 0.05
    assert sched._spec.choose(sched.cost, 4) == 0
    ex = tserve.SimExecutor()
    for r in sched.completed:
        assert r.tokens == [ex._token(r, n) for n in range(r.output_len)]
    assert sched.pool.outstanding() == 0


def test_spec_rollback_with_cow_shared_blocks_leaks_nothing():
    """500 speculate / reject lifecycles over shared prompt prefixes drain
    the pool to zero with rollback moving, and the cost ledger
    reconciles."""
    sched = tserve.Scheduler(
        _spec_config(slots=8, kv_blocks=128, prefix_sharing=True),
        tserve.PeriodicSimExecutor(4),
        drafter=_FlakyDrafter(tspec.NgramDrafter()))
    arrivals = _arrivals(jserve.prefix_heavy_arrivals, 40.0, 16.0,
                         n_prefixes=3, prefix_len=33)
    assert len(arrivals) >= 500
    for r in arrivals[:500]:
        sched.submit(r)
    sched.run()
    assert len(sched.completed) + len(sched.rejected) == 500
    assert len(sched.completed) >= 450
    assert sched.pool.outstanding() == 0
    assert sched._spec.proposed_total > sched._spec.accepted_total > 0
    assert sched.pool.spec_rollback_tokens > 0
    assert sched.pool.cow_copies > 0 and sched.pool.prefix_block_hits > 0
    assert sched.ledger.reconcile()["ok"]


def test_spec_verify_phase_lands_in_ledger():
    """The twin of tests/test_spec.py's: verify iterations bill the
    ledger's ``verify`` phase, the ledger reconciles, and its entries equal
    the JAX scheduler's on the same arrivals."""
    entries = {}
    for name, serve in (("jax", jserve), ("port", tserve)):
        sched = serve.Scheduler(
            serve.ServeConfig(slots=4, kv_blocks=64, kv_block_size=16,
                              queue_limit=256, spec_k=4),
            executor=serve.PeriodicSimExecutor(4))
        for r in jserve.open_loop_arrivals(SEED, 6.0, 6.0):
            sched.submit(serve.Request(
                rid=r.rid, prompt_len=r.prompt_len,
                output_len=r.output_len, slo_class=r.slo_class,
                arrival_s=r.arrival_s))
        sched.run()
        assert set(serve.LEDGER_PHASES) == {"prefill", "decode", "verify",
                                            "cow", "sched", "compile"}
        assert sum(e["phases"]["verify"]
                   for e in sched.ledger.entries()) > 0.0
        assert sched.ledger.reconcile()["ok"]
        entries[name] = sched.ledger.entries()
    # the port's entries hold one key of their own, ``detail``
    assert [{k: v for k, v in e.items() if k != "detail"}
            for e in entries["port"]] == entries["jax"]


@pytest.mark.parametrize("chunk", [0, 32])
@pytest.mark.parametrize("flaky", [False, True])
def test_scheduler_trace_equals_jax_scheduler(chunk, flaky):
    """The port's and the JAX scheduler on PeriodicSimExecutor(4), the same
    prefix-heavy mixed-class arrivals and the same config (speculation,
    sharing, preemption), on the virtual clock: the same completed
    streams, the same trace tuple for tuple (spec and preempt included),
    and the same pool counters."""
    kw = dict(slots=4, kv_blocks=48, kv_block_size=16, queue_limit=256,
              spec_k=3, prefix_sharing=True, preemption=True,
              prefill_chunk_tokens=chunk)
    arrivals = jserve.prefix_heavy_arrivals(SEED, 30.0, 4.0, n_prefixes=3,
                                            prefix_len=33)
    jsched = jserve.Scheduler(
        jserve.ServeConfig(**kw), executor=jserve.PeriodicSimExecutor(4),
        drafter=_FlakyDrafter(jspec.NgramDrafter()) if flaky else None)
    jsched.submit_all([r.fresh_copy() for r in arrivals])
    jsched.run()
    tsched = tserve.Scheduler(
        tserve.ServeConfig(**kw), tserve.PeriodicSimExecutor(4),
        drafter=_FlakyDrafter(tspec.NgramDrafter()) if flaky else None)
    for r in arrivals:
        tsched.submit(_port_request(r))
    tsched.run()
    assert {r.rid: r.tokens for r in tsched.completed} \
        == {r.rid: r.tokens for r in jsched.completed}
    for kind in ("spec", "preempt"):
        ours = [t for t in tsched.trace if t[0] == kind]
        assert ours and ours == [t for t in jsched.trace if t[0] == kind]
    assert tsched.trace == jsched.trace
    counters = ("cow_copies", "prefix_block_hits", "spec_rollback_tokens")
    assert [getattr(tsched.pool, c) for c in counters] \
        == [getattr(jsched.pool, c) for c in counters]
    assert (tsched.preemptions, tsched.prefill_tokens_discarded,
            tsched.spec_rows_total) \
        == (jsched.preemptions, jsched.prefill_tokens_discarded,
            jsched.spec_rows_total)
    assert tsched.pool.prefix_block_hits > 0
    if flaky:
        assert tsched.pool.spec_rollback_tokens > 0
    assert tsched.pool.outstanding() == jsched.pool.outstanding() == 0
