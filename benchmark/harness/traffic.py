"""The general traffic generator: every mix is a data file of parameters.

A serving mix (``"kind": "serve"``) gives the scheduler's shape, the
length distributions and the arrivals: a backlog kept topped up, or an
open loop of Poisson arrivals at a fixed rate.

Lengths and gaps between arrivals come from a fixed pool: the quantiles
of the mix's lognormal (or exponential) distribution at ``pool`` evenly
spaced probabilities, with prompt and output lengths paired by a fixed
stride. The seed draws the token ids and the order in which the pool is
walked, never the sizes, so every seed offers the same work in another
order.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np

#: the traffic's stream of the seed, apart from the weights'
TRAFFIC_STREAM = 0x7AFF1C
#: pairs prompt quantile i with output quantile (i * stride) mod pool
PAIR_STRIDE = 2654435761


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


# -- serving ------------------------------------------------------------------

def lognormal_pool(spec: dict, n: int) -> np.ndarray:
    """*n* lengths: the lognormal's quantiles (median, sigma) at
    probabilities (i + 0.5) / n, rounded and clipped to [min, max]."""
    nd = NormalDist()
    out = np.empty(n, dtype=np.int64)
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        out[i] = round(spec["median"] * math.exp(spec["sigma"] * z))
    return np.clip(out, spec["min"], spec["max"])


def exponential_pool(rate: float, n: int) -> np.ndarray:
    """*n* gaps between Poisson arrivals at *rate*: the exponential's
    quantiles at probabilities (i + 0.5) / n."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


class RequestStream:
    """The mix's requests in the seed's order: ``next()`` gives
    ``(rid, prompt ids, output length)``, walking the pool of lengths in
    a permutation drawn from the seed and drawing each prompt's ids
    uniform over the vocabulary."""

    def __init__(self, traffic: dict, vocab: int, seed: int) -> None:
        n = traffic["pool"]
        self.prompts = lognormal_pool(traffic["prompt"], n)
        outputs = lognormal_pool(traffic["output"], n)
        self.outputs = outputs[(np.arange(n) * PAIR_STRIDE) % n]
        self._rng = _rng(seed, TRAFFIC_STREAM)
        self._order = self._rng.permutation(n)
        self.vocab = vocab
        self.count = 0

    def next(self) -> tuple:
        i = self._order[self.count % len(self._order)]
        rid = f"r{self.count}"
        self.count += 1
        ids = self._rng.integers(0, self.vocab, int(self.prompts[i]))
        return rid, tuple(int(t) for t in ids), int(self.outputs[i])


def arrival_offsets(traffic: dict, seed: int, horizon_s: float) -> list:
    """Seconds from the start of traffic at which each open-loop request
    is due, up to *horizon_s*: the pool of gaps at the mix's rate, walked
    in a permutation drawn from the seed (and again, in a new one, once
    the pool is spent)."""
    arr = traffic["arrivals"]
    gaps = exponential_pool(arr["rate_rps"], traffic["pool"])
    rng = _rng(seed, TRAFFIC_STREAM + 1)
    out, t = [], 0.0
    while True:
        for g in gaps[rng.permutation(len(gaps))]:
            t += float(g)
            if t > horizon_s:
                return out
            out.append(t)
