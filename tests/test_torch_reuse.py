"""The port's request-stream feature tier (``repro_torch.serve.reuse``)
against the JAX package's, on the CPU.

One feature store written by the port's generator and opened by both
packages; the same Zipf request stream (seeded numpy) through the JAX
``RequestStreamCache`` and the port's gives equal hit masks, records and
counters at every round, and the hit rate lands in the closed-form
``served_hit_model`` band ± 0.05, the slack ``benchmarks/serve_latency.py``
gives it (the closed forms are steady state; a finite run pays cold-start
misses).  The benchmark's settings: 512 features, 64 cached, 8 a
request, Zipf alpha 1.1, 400 rounds.
"""
import numpy as np
import pytest

from repro.serve import EstimatedReusePolicy as JaxPolicy
from repro.serve import RequestStreamCache as JaxStreamCache
from repro.storage.record_store import RecordStore as JaxStore
from repro_torch.core import LocationGenerator
from repro_torch.data.synthetic import make_classification_dataset
from repro_torch.serve import EstimatedReusePolicy, RequestStreamCache, zipf_probabilities
from repro_torch.storage.devices import served_hit_model, zipf_popularity
from repro_torch.storage.record_store import RecordStore, RecordWriter

NUM_FEATURES, CACHE_RECORDS, PER_REQUEST, ROUNDS, BAND_SLACK = 512, 64, 8, 400, 0.05


@pytest.fixture(scope="module")
def feature_path(tmp_path_factory):
    return make_classification_dataset(
        str(tmp_path_factory.mktemp("feat") / "features.rrec"), NUM_FEATURES, dim=16, seed=0
    ).path


@pytest.mark.parametrize("alpha,seed", [(1.1, 7), (0.9, 3)])
@pytest.mark.parametrize("policy", ["belady", "lru"])
def test_request_stream_cache_matches_jax(feature_path, policy, alpha, seed):
    ts, js = RecordStore(feature_path), JaxStore(feature_path)
    try:
        budget = CACHE_RECORDS * ts.record_size
        port = RequestStreamCache(ts, budget, policy=policy)
        ref = JaxStreamCache(js, budget, policy=policy)
        rng = np.random.default_rng(seed)
        p = zipf_probabilities(NUM_FEATURES, alpha)
        for step in range(ROUNDS):
            ids = rng.choice(NUM_FEATURES, size=PER_REQUEST, p=p).astype(np.int64)
            got, hit = port.fetch(ids, float(step))
            want, jhit = ref.fetch(ids, float(step))
            np.testing.assert_array_equal(hit, jhit)
            np.testing.assert_array_equal(got, want)
        counters = ("hits", "misses", "hit_bytes", "insertions", "evictions", "rejected",
                    "planned_skips", "used_bytes", "capacity")
        assert {k: getattr(port.cache, k) for k in counters} == \
            {k: getattr(ref.cache, k) for k in counters}
        assert port.fetched == ref.fetched == ROUNDS * PER_REQUEST
        assert port.hit_rate == ref.hit_rate
        # the store's counters reconcile with the cache's, on both sides
        assert ts.stats.cache_hits == port.cache.hits == js.stats.cache_hits
        assert ts.stats.batch_records == port.cache.misses == js.stats.batch_records
        pop = zipf_popularity(NUM_FEATURES, alpha)
        lo = served_hit_model(pop, port.cache.capacity, "lru")
        hi = served_hit_model(pop, port.cache.capacity, "belady")
        assert port.cache.capacity == CACHE_RECORDS and lo < hi
        assert lo - BAND_SLACK <= port.hit_rate <= hi + BAND_SLACK
        np.testing.assert_array_equal(got, ts.read_batch_into(ids))  # the last request's bytes
    finally:
        ts.close()
        js.close()


def test_estimated_reuse_policy_matches_jax():
    port, ref = EstimatedReusePolicy(32, ewma=0.4), JaxPolicy(32, ewma=0.4)
    rng = np.random.default_rng(1)
    for now in range(60):
        ids = rng.integers(0, 32, size=5)
        port.observe(ids, float(now))
        ref.observe(ids, float(now))
        probe = rng.integers(0, 32, size=9)
        np.testing.assert_array_equal(port.estimate_next_use(probe, float(now)),
                                      ref.estimate_next_use(probe, float(now)))
    with pytest.raises(ValueError, match="ewma"):
        EstimatedReusePolicy(4, ewma=0.0)


def test_variable_length_store_refused(tmp_path):
    """A feature tier over variable-length records stays refused, as in
    the JAX package: the served batch is a fixed (B, record_size) block."""
    path = str(tmp_path / "var.rrec")
    with RecordWriter(path) as w:
        for n in (3, 9, 5, 12):
            w.append(bytes(range(n)))
    store = RecordStore(path)
    LocationGenerator().generate(store)
    try:
        with pytest.raises(ValueError, match="fixed-size"):
            RequestStreamCache(store, budget_bytes=4096)
    finally:
        store.close()
