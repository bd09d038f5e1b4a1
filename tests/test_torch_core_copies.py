"""The port's numpy-only copies of the LIRS core's measures against the
JAX package's modules: ``core/sampler.py`` (the sharded sampler),
``core/shuffle_quality.py`` (the shuffle entropies) and
``storage/page_cache.py`` (the LRU, Belady and multi-host cache
simulators).

They carry no device code, so the same seeded inputs go through both
packages and every output must be equal: index streams ``np.array_equal``,
entropies, hit rates and counters exactly (``==``).  The cases follow
``tests/test_sampler.py``, ``tests/test_shuffle_quality.py``, the
page-cache parts of ``tests/test_eviction_policy.py`` and
``DistributedCacheSim`` in ``tests/test_multihost.py``, with fixed seeds
where those draw examples, and the same properties are asserted on the
port's side.
"""
import numpy as np
import pytest

from repro.core import sampler as jsampler
from repro.core import shuffle_quality as jquality
from repro.core import shuffler as jshuffler
from repro.storage import page_cache as jcache
from repro_torch.core import sampler as tsampler
from repro_torch.core import shuffle_quality as tquality
from repro_torch.core import shuffler as tshuffler
from repro_torch.storage import page_cache as tcache

N, BATCH = 4096, 128


# ---------------------------------------------------------------- sampler


def _both_samplers(n, gb, hosts, seed, assignment="feistel"):
    return [(jsampler.ShardedSampler(n, gb, hosts, h, seed=seed, assignment=assignment),
             tsampler.ShardedSampler(n, gb, hosts, h, seed=seed, assignment=assignment))
            for h in range(hosts)]


@pytest.mark.parametrize("assignment", ["feistel", "table"])
@pytest.mark.parametrize("hosts,lb,n_mult,seed", [(1, 8, 2, 0), (2, 3, 5, 11), (4, 5, 3, 42),
                                                  (8, 2, 6, 99)])
def test_sharded_sampler_streams_equal_jax(assignment, hosts, lb, n_mult, seed):
    """Two epochs of every host's batches, and the global batches, equal
    JAX's; each step's host shards are a disjoint union of the global
    batch, and an epoch covers every item once."""
    gb = hosts * lb
    n = gb * n_mult
    pairs = _both_samplers(n, gb, hosts, seed, assignment)
    for epoch in range(2):
        seen = []
        for step in range(n_mult):
            got = [t.next_batch() for _, t in pairs]
            want = [j.next_batch() for j, _ in pairs]
            for a, b in zip(got, want):
                assert np.array_equal(a, b)
            union = np.concatenate(got)
            glob = pairs[0][1].global_batch_indices(epoch, step)
            assert np.array_equal(glob, pairs[0][0].global_batch_indices(epoch, step))
            assert len(set(union.tolist())) == gb and set(union.tolist()) == set(glob.tolist())
            seen.append(union)
        assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(n))
    assert pairs[0][1].state.to_dict() == pairs[0][0].state.to_dict()


def test_sampler_checkpoint_reshard_and_steal_equal_jax():
    """Checkpoint and restore, an elastic reshard from 4 to 8 hosts, and
    slot stealing give JAX's batches, dicts and shard sizes."""
    j, t = _both_samplers(128, 16, 4, 3)[2]
    for _ in range(5):
        assert np.array_equal(t.next_batch(), j.next_batch())
    assert t.checkpoint() == j.checkpoint()
    t2, j2 = tsampler.ShardedSampler(128, 16, 4, 2, seed=3), jsampler.ShardedSampler(128, 16, 4, 2, seed=3)
    t2.restore(t.checkpoint())
    j2.restore(j.checkpoint())
    assert np.array_equal(t2.next_batch(), j2.next_batch())
    tre = [t.reshard(8, h) for h in range(8)]
    jre = [j.reshard(8, h) for h in range(8)]
    merged = np.concatenate([r.next_batch() for r in tre])
    assert np.array_equal(merged, np.concatenate([r.next_batch() for r in jre]))
    assert set(merged.tolist()) == set(t.global_batch_indices(t.state.epoch, t.state.step).tolist())

    pairs = _both_samplers(400, 40, 4, 5)
    for jp, tp in pairs:
        jp.steal_slots(slow_host=1, fast_host=0, count=4)
        tp.steal_slots(slow_host=1, fast_host=0, count=4)
    assert pairs[0][1].shard_sizes() == pairs[0][0].shard_sizes() == [14, 6, 10, 10]
    got = [tp.next_batch() for _, tp in pairs]
    for a, (jp, _) in zip(got, pairs):
        assert np.array_equal(a, jp.next_batch())
    assert len(set(np.concatenate(got).tolist())) == 40
    for s in (pairs[0][0], pairs[0][1]):
        with pytest.raises(ValueError, match="adjacent"):
            s.steal_slots(slow_host=3, fast_host=0, count=2)


# ------------------------------------------------------- shuffle quality


def _shufflers(mod):
    return {
        "lirs": mod.LIRSShuffler(N, BATCH, seed=2),
        "tfip_queue_1": mod.TFIPShuffler(N, BATCH, queue_size=1, seed=3),
        "corgipile_full_span": mod.CorgiPileShuffler(N, BATCH, block_records=1,
                                                     buffer_blocks=N, seed=2),
        "corgisquared": mod.CorgiSquaredShuffler(N, BATCH, block_records=256, seed=2),
        "corgipile_256": mod.CorgiPileShuffler(N, BATCH, block_records=256, seed=2),
        **{f"corgipile_buffer_{b}": mod.CorgiPileShuffler(N, BATCH, 256, buffer_blocks=b, seed=1)
           for b in (1, 2, 4, 8)},
    }


@pytest.fixture(scope="module")
def qualities():
    """{strategy: (port's epoch_quality, JAX's)} over epoch 1, each
    package scoring its own shuffler's stream."""
    got, want = _shufflers(tshuffler), _shufflers(jshuffler)
    return {k: (tquality.epoch_quality(got[k], 1), jquality.epoch_quality(want[k], 1))
            for k in got}


def test_epoch_quality_equals_jax_on_every_strategy(qualities):
    for name, (got, want) in qualities.items():
        assert got == want, name
    # the JAX tests' gates, on the port's numbers
    assert qualities["tfip_queue_1"][0]["within_batch_entropy"] == 0.0
    assert qualities["tfip_queue_1"][0]["successor_gap_entropy"] == pytest.approx(0.0)
    lirs = qualities["lirs"][0]
    assert lirs["within_batch_entropy"] > 0.95
    for key in lirs:
        assert abs(qualities["corgipile_full_span"][0][key] - lirs[key]) < 0.02
    assert abs(qualities["corgisquared"][0]["within_batch_entropy"]
               - lirs["within_batch_entropy"]) < 0.02
    assert qualities["corgipile_256"][0]["within_batch_entropy"] < 0.5
    vals = [qualities[f"corgipile_buffer_{b}"][0]["within_batch_entropy"] for b in (1, 2, 4, 8)]
    assert all(b > a + 1e-6 for a, b in zip(vals, vals[1:])), vals


@pytest.mark.parametrize("stream,batch,num_items", [
    (np.arange(N), BATCH, N),                       # sequential scan: zero entropy
    (np.arange(N)[::-1], BATCH, N),                 # backward scan
    (np.arange(0, N, 7), BATCH, N),                 # constant stride
    (np.random.default_rng(0).permutation(N), BATCH, None),
    (np.random.default_rng(1).permutation(1000), 32, 1000),
    (np.random.default_rng(2).integers(0, 50, 300), 64, 50),   # repeats
    (np.array([5]), 4, 8),
    (np.array([], np.int64), 4, 8),
])
def test_stream_entropies_equal_jax(stream, batch, num_items):
    got = tquality.stream_quality(stream, batch, num_items)
    want = jquality.stream_quality(stream, batch, num_items)
    assert got == want
    assert all(0.0 <= v <= 1.0 for v in got.values())
    assert tquality.within_batch_entropy(stream, batch, num_items) == \
        jquality.within_batch_entropy(stream, batch, num_items)
    assert tquality.successor_gap_entropy(stream, num_items) == \
        jquality.successor_gap_entropy(stream, num_items)


def test_structured_streams_have_zero_successor_entropy():
    assert tquality.within_batch_entropy(np.arange(N), BATCH, N) == 0.0
    for s in (np.arange(N), np.arange(N)[::-1], np.arange(0, N, 7)):
        assert tquality.successor_gap_entropy(s, N) == pytest.approx(0.0)


# ------------------------------------------------------------ page cache


def _lirs_stream(n, batch, seed, epochs):
    sh = tshuffler.LIRSShuffler(n, batch, seed=seed)
    return np.concatenate([sh.epoch_index_stream(e) for e in range(epochs)])


@pytest.mark.parametrize("n,batch,frac_pct,seed", [(256, 16, 3, 0), (1024, 64, 30, 3),
                                                   (1500, 256, 50, 7), (2048, 100, 97, 11)])
def test_page_cache_simulators_equal_jax(n, batch, frac_pct, seed):
    """LRU and Belady replays of the same LIRS stream (3 warm-up epochs,
    one counted): hit rates and counters equal JAX's; MIN never loses to
    recency; Belady serves exactly its capacity in hits an epoch."""
    k = max(1, (n * frac_pct) // 100)
    stream = _lirs_stream(n, batch, seed, 4)
    jstream = np.concatenate([jshuffler.LIRSShuffler(n, batch, seed=seed).epoch_index_stream(e)
                              for e in range(4)])
    assert np.array_equal(stream, jstream)
    out = {}
    for name in ("LRUPageCache", "BeladyPageCache"):
        got, want = getattr(tcache, name)(k), getattr(jcache, name)(k)
        rate = got.simulate(stream, warmup=3 * n)
        assert rate == want.simulate(stream, warmup=3 * n)
        assert (got.hits, got.misses, got.transfers) == (want.hits, want.misses, want.transfers)
        out[name] = (rate, got)
    assert out["BeladyPageCache"][0] >= out["LRUPageCache"][0]
    assert (out["BeladyPageCache"][1].hits, out["BeladyPageCache"][1].misses) == (k, n - k)


def test_lru_access_many_and_reset_equal_jax():
    stream = _lirs_stream(512, 32, 5, 2)
    got, want = tcache.LRUPageCache(100), jcache.LRUPageCache(100)
    assert got.access_many(int(i) for i in stream) == want.access_many(int(i) for i in stream)
    assert [got.access(int(i)) for i in stream[:64]] == [want.access(int(i)) for i in stream[:64]]
    assert (got.hits, got.misses) == (want.hits, want.misses)
    got.reset()
    assert (got.hits, got.misses, got.transfers) == (0, 0, 0)


def test_next_use_times_equal_jax():
    stream = np.array([3, 1, 3, 2, 1, 3])
    big = np.iinfo(np.int64).max
    np.testing.assert_array_equal(tcache.BeladyPageCache.next_use_times(stream),
                                  [2, 4, 5, big, big, big])
    for s in (_lirs_stream(300, 30, 1, 3), np.array([], np.int64), np.array([7, 7, 7])):
        assert np.array_equal(tcache.BeladyPageCache.next_use_times(s),
                              jcache.BeladyPageCache.next_use_times(s))


@pytest.mark.parametrize("policy", ["lru", "belady"])
@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_distributed_cache_sim_equals_jax(policy, hosts):
    """Five epochs of the multi-host tier's replay over each package's
    LIRS shuffler: every epoch's local/remote/storage counts equal JAX's;
    under Belady, storage reads meet the pigeonhole floor n - sum(caps)
    from epoch 1 on."""
    n, batch, cap = 1024, 128, 256
    caps = [cap // hosts] * hosts
    got = tcache.DistributedCacheSim(hosts, caps, policy=policy).simulate(
        tshuffler.LIRSShuffler(n, batch, seed=3), 5)
    want = jcache.DistributedCacheSim(hosts, caps, policy=policy).simulate(
        jshuffler.LIRSShuffler(n, batch, seed=3), 5)
    assert got == want
    for e, stats in enumerate(got):
        assert stats["local"] + stats["remote"] + stats["storage"] == stats["accesses"] == n
        if policy == "belady" and e >= 1:
            assert stats["storage"] == n - sum(caps)
        if hosts == 1:
            assert stats["remote"] == 0


def test_distributed_cache_sim_refuses_bad_arguments():
    with pytest.raises(ValueError, match="one capacity per host"):
        tcache.DistributedCacheSim(2, [4], policy="lru")
    with pytest.raises(ValueError, match="unknown policy"):
        tcache.DistributedCacheSim(1, [4], policy="fifo")
