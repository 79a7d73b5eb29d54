"""The seeded generators: same seed, same work; other seeds, the same
sizes in another order; every request within the model's positions."""

import collections

import pytest

from harness import manifest
from harness.traffic import RequestStream, arrival_offsets, lognormal_pool

SEED = 2 ** 31 + 977
SERVE_MIXES = ("serve-batch",)


def _take(mix: dict, seed: int, n: int) -> list:
    stream = RequestStream(mix, 32768, seed)
    return [stream.next() for _ in range(n)]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_same_seed_same_requests(name):
    mix = manifest.load_traffic(name)
    assert _take(mix, SEED, 50) == _take(mix, SEED, 50)
    assert _take(mix, SEED, 50) != _take(mix, SEED + 1, 50)


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_every_seed_offers_the_same_sizes(name):
    mix = manifest.load_traffic(name)
    n = mix["pool"]
    sizes = [collections.Counter((len(p), o) for _, p, o in
                                 _take(mix, seed, n)) for seed in (1, SEED)]
    assert sizes[0] == sizes[1]


@pytest.mark.parametrize("name", SERVE_MIXES)
def test_requests_fit_the_model(name):
    mix = manifest.load_traffic(name)
    mf = manifest.load_manifest()
    for cell in mf["workloads"]:
        if cell["traffic"] != name:
            continue
        config = manifest.load_config(mf, cell["config"])
        block, m = manifest.block_of(config), config["model"]
        for _, ids, out in _take(mix, SEED, mix["pool"]):
            assert 1 <= len(ids) and len(ids) + out <= block.positions(m)
            assert 0 <= min(ids) and max(ids) < block.vocab(m)


def test_pool_follows_its_quantiles():
    pool = lognormal_pool({"median": 100, "sigma": 0.5, "min": 1,
                           "max": 10 ** 6}, 1001)
    assert sorted(pool)[500] == 100 and pool.min() >= 1


def test_arrivals_keep_the_rate_and_the_seed():
    rate = 17.0
    mix = dict(manifest.load_traffic("serve-batch"),
               arrivals={"kind": "poisson", "rate_rps": rate})
    a = arrival_offsets(mix, SEED, 60.0)
    assert a == arrival_offsets(mix, SEED, 60.0)
    assert a != arrival_offsets(mix, SEED + 1, 60.0)
    assert abs(len(a) / 60.0 - rate) / rate < 0.05
    assert all(x < y for x, y in zip(a, a[1:]))

