"""Preemption in the PyTorch/CUDA port's scheduler, on the CPU.

Twins of tests/test_serve.py's preemption gates on the port's
``SimExecutor``, each also run through the JAX scheduler on the same
requests: the traces must be equal tuple for tuple. Then the same eviction
through ``TorchSlotExecutor`` and the real model, where the preempted
stream must still equal ``generate``.
"""

import numpy as np
import pytest
import torch

from dpu_operator_tpu.workloads import serve as jserve
from dpu_operator_tpu_torch.workloads import decode, model
from dpu_operator_tpu_torch.workloads import serve as tserve

#: tests/test_serve.py's CPU-calibrated cost model
CALIBRATED = dict(decode_base_s=0.0007512, decode_per_seq_s=0.0000835,
                  prefill_per_token_s=0.00026168)


def _both(config, requests, cost=None):
    """The same config and requests through the port's scheduler and the
    JAX one on their SimExecutors: (port scheduler, JAX scheduler)."""
    ours = tserve.Scheduler(
        tserve.ServeConfig(**config), tserve.SimExecutor(),
        cost_model=tserve.CostModel(**cost) if cost else None)
    theirs = jserve.Scheduler(
        jserve.ServeConfig(**config),
        cost_model=jserve.CostModel(**cost) if cost else None)
    for kw in requests:
        ours.submit(tserve.Request(**kw))
        theirs.submit(jserve.Request(**kw))
    ours.run()
    theirs.run()
    assert ours.trace == theirs.trace
    assert ours.pool.outstanding() == theirs.pool.outstanding() == 0
    return ours, theirs


def _harness(**kw):
    base = dict(slots=4, kv_blocks=64, kv_block_size=16, queue_limit=256)
    base.update(kw)
    return base


def test_interactive_meets_ttft_bound_via_preemption():
    """Two batch requests hold both slots and 14 of 16 blocks; an
    interactive arrival evicts one, takes its first token within 1 s, and
    the victims still complete with every token."""
    reqs = [dict(rid=f"hog{i}", prompt_len=48, output_len=64,
                 slo_class=tserve.BATCH, arrival_s=0.0) for i in range(2)]
    reqs.append(dict(rid="vip", prompt_len=32, output_len=4,
                     slo_class=tserve.INTERACTIVE, arrival_s=0.5))
    sched, _ = _both(_harness(slots=2, kv_blocks=16), reqs)
    assert any(ev[0] == "preempt" for ev in sched.trace)
    assert sched.preemptions >= 1
    done = {r.rid: r for r in sched.completed}
    assert set(done) == {"hog0", "hog1", "vip"}
    assert done["vip"].ttft_s is not None and done["vip"].ttft_s <= 1.0
    assert all(len(done[r].tokens) == 64 for r in ("hog0", "hog1"))
    assert sum(done[r].preemptions for r in ("hog0", "hog1")) >= 1


@pytest.mark.parametrize("chunk", [0, 8])
def test_preempted_request_token_stream_is_unchanged(chunk):
    def run(with_vip):
        reqs = [dict(rid="steady", prompt_len=16, output_len=24,
                     slo_class=tserve.BATCH, arrival_s=0.0)]
        if with_vip:
            reqs.append(dict(rid="vip", prompt_len=8, output_len=2,
                             slo_class=tserve.INTERACTIVE, arrival_s=0.1))
        sched, _ = _both(_harness(slots=1, kv_blocks=8,
                                  prefill_chunk_tokens=chunk), reqs)
        return {r.rid: r for r in sched.completed}

    calm, stormy = run(False), run(True)
    assert stormy["steady"].preemptions >= 1
    assert stormy["steady"].tokens == calm["steady"].tokens


def test_chunk_aware_preemption_accounts_discarded_tokens():
    """A victim evicted mid-prefill has its chunk progress counted as
    discarded prefill work and still completes."""
    reqs = [dict(rid="victim", prompt_len=200, output_len=4,
                 slo_class=tserve.BATCH, arrival_s=0.0),
            dict(rid="vip", prompt_len=8, output_len=2,
                 slo_class=tserve.INTERACTIVE, arrival_s=0.01)]
    sched, theirs = _both(dict(slots=1, kv_blocks=32, kv_block_size=16,
                               prefill_chunk_tokens=16), reqs,
                          cost=CALIBRATED)
    assert sched.prefill_tokens_discarded > 0
    assert sched.prefill_tokens_discarded == theirs.prefill_tokens_discarded
    preempts = [ev for ev in sched.trace if ev[0] == "preempt"]
    assert preempts and preempts[0][4] == "prefill" and preempts[0][5] > 0
    done = {r.rid: r for r in sched.completed}
    assert set(done) == {"victim", "vip"}
    assert len(done["victim"].tokens) == 4


def test_no_preemption_when_disabled():
    reqs = [dict(rid=f"hog{i}", prompt_len=48, output_len=64,
                 slo_class=tserve.BATCH, arrival_s=0.0) for i in range(2)]
    reqs.append(dict(rid="vip", prompt_len=32, output_len=4,
                     slo_class=tserve.INTERACTIVE, arrival_s=0.5))
    sched, _ = _both(_harness(slots=2, kv_blocks=16, preemption=False),
                     reqs)
    assert not any(ev[0] == "preempt" for ev in sched.trace)
    assert len(sched.completed) == 3


# -- the real model ------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = model.TransformerConfig(vocab=256, d_model=64, n_heads=4,
                                  n_layers=2, d_ff=128, max_seq=64,
                                  dtype=torch.float32)
    return cfg, model.init_params(0, cfg, device="cpu")


@pytest.mark.parametrize("chunk", [0, 8])
def test_preemption_through_the_slot_executor_keeps_streams(tiny, chunk):
    """Two batch requests on both slots of a tight pool; an interactive
    arrival preempts one (mid-prefill or mid-decode), which is prefilled
    again from prompt + kept tokens on re-admission: every stream equals
    generate, and no block leaks."""
    cfg, params = tiny
    rng = np.random.default_rng(11)
    prompts = {rid: tuple(int(t) for t in rng.integers(0, 256, n))
               for rid, n in (("b1", 20), ("b2", 13), ("hot", 9))}
    ex = tserve.TorchSlotExecutor(params, cfg, slots=2, chunk_tokens=chunk,
                                  device="cpu")
    sched = tserve.Scheduler(
        tserve.ServeConfig(slots=2, kv_blocks=5, kv_block_size=8,
                           prefill_chunk_tokens=chunk), ex)
    for rid, cls, t in (("b1", tserve.BATCH, 0.0), ("b2", tserve.BATCH, 0.0),
                        ("hot", tserve.INTERACTIVE, 0.03)):
        sched.submit(tserve.Request(rid=rid, prompt_len=len(prompts[rid]),
                                    output_len=12, prompt=prompts[rid],
                                    slo_class=cls, arrival_s=t))
    sched.run()
    assert any(ev[0] == "preempt" for ev in sched.trace)
    assert len(sched.completed) == 3 and not sched.failed
    for r in sched.completed:
        want = decode.generate(params, cfg, torch.tensor([r.prompt]),
                               r.output_len, device="cpu")[0].tolist()
        assert r.tokens == want, r.rid
    assert sched.pool.outstanding() == 0
