"""The port's single-host DRAM tier against the JAX package, on the CPU.

Same record files, same shuffler seed, the JAX module beside its port
(``repro_torch.prefetch``, ``repro_torch.obs.drift``):
  * ``TieredCache``: one random sequence of ``insert`` (filtered and
    not), ``gather``, ``admit``, ``pin``/``unpin``, ``note_next_use`` and
    ``invalidate`` under ``lru`` and ``belady`` gives equal return values,
    residency, counters and gathered bytes;
  * ``LookaheadScheduler``: equal plans and counters over three epochs;
  * ``PrefetchingFetcher``: dense and ragged stores × ``lru``/``belady`` ×
    planner on/off.  With ``background=False`` every batch and every
    counter of the launchers' ``cache`` block is equal; with the
    background worker (whose counters depend on thread timing) the
    batches are equal, to the JAX tier's and to the direct plane's;
  * ``single_host_report``: equal dicts on the same counters.
``build_data_plane`` with the multi-host tier's ``remote`` / ``placement``
is held in ``tests/test_torch_multihost.py``.
All comparisons are exact: the tier moves bytes and counts, it computes
nothing in floating point beyond the drift report's closed forms, which
are the same numpy expressions on both sides.
"""
import numpy as np
import pytest

from repro.core.location import LocationGenerator as JaxLocationGenerator
from repro.core.pipeline import InputPipeline as JaxPipeline
from repro.core.readpath import ReadPathConfig as JaxReadPathConfig
from repro.core.readpath import build_data_plane as jax_build_data_plane
from repro.core.shuffler import LIRSShuffler as JaxLIRS
from repro.obs import drift as jax_drift
from repro.prefetch import LookaheadScheduler as JaxScheduler
from repro.prefetch import TieredCache as JaxCache
from repro.prefetch import copy_records as jax_copy_records
from repro.storage.record_store import RecordStore as JaxStore
from repro_torch.core import InputPipeline, LIRSShuffler, LocationGenerator
from repro_torch.core.readpath import ReadPathConfig, build_data_plane, close_data_plane
from repro_torch.obs import drift
from repro_torch.prefetch import (
    NEVER,
    LookaheadScheduler,
    PrefetchingFetcher,
    TieredCache,
    copy_records,
)
from repro_torch.storage.record_store import RecordStore, RecordWriter

N_RECORDS, BATCH, EPOCHS = 240, 16, 3

# every counter of the launchers' ``cache`` block, by its attribute
CACHE_COUNTERS = ("hits", "misses", "hit_bytes", "insertions", "evictions", "rejected",
                  "planned_skips", "planned_skip_bytes", "stray_unpins", "invalidations",
                  "scratch_copies", "scratch_copy_bytes", "used_bytes", "capacity")
SCHED_COUNTERS = ("window_hits", "doomed_records", "doomed_bytes", "admitted_records",
                  "planned_records", "window_records")
FETCHER_COUNTERS = ("prefetch_records", "probe_skips", "plans_failed", "worker_restarts",
                    "planner")


def _write(path, recs, record_size=None):
    with RecordWriter(str(path), record_size=record_size) as w:
        for r in recs:
            w.append(r)
    return str(path)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One fixed-size and one variable-length record file, each opened by
    both packages: {"dense": (port, jax, recs), "ragged": (...)}."""
    d = tmp_path_factory.mktemp("tier")
    rng = np.random.default_rng(11)
    fixed = [rng.bytes(48) for _ in range(N_RECORDS)]
    var = [rng.bytes(int(rng.integers(4, 96))) for _ in range(N_RECORDS)]
    out = {}
    for kind, recs, size in (("dense", fixed, 48), ("ragged", var, None)):
        path = _write(d / f"{kind}.rrec", recs, size)
        ts, js = RecordStore(path), JaxStore(path)
        if size is None:
            LocationGenerator().generate(ts)
            JaxLocationGenerator().generate(js)
        out[kind] = (ts, js, recs)
    yield out
    for ts, js, _ in out.values():
        ts.close()
        js.close()


def _counters(obj, names):
    return {k: getattr(obj, k) for k in names}


# ----------------------------------------------------------------- cache
def _cache_ops(rng, n, steps):
    """A random op sequence over ``n`` records: (name, ids, extra)."""
    ops = []
    for _ in range(steps):
        op = rng.choice(["insert", "insert_filtered", "gather", "admit", "pin", "unpin",
                         "note_next_use", "invalidate"],
                        p=[0.25, 0.2, 0.2, 0.1, 0.05, 0.1, 0.07, 0.03])
        ids = rng.integers(0, n, size=int(rng.integers(1, 24))).astype(np.int64)
        nu = rng.integers(0, 4 * n, size=len(ids)).astype(np.int64)
        nu[rng.random(len(ids)) < 0.15] = NEVER
        ops.append((str(op), ids, nu))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["lru", "belady"])
def test_tiered_cache_same_ops_same_state(policy, seed):
    rng = np.random.default_rng(seed)
    n = 120
    lengths = rng.integers(1, 40, size=n).astype(np.int64)
    src = rng.integers(0, 256, size=int(lengths.sum()), dtype=np.uint8)
    src_off = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    budget = int(rng.integers(20, 60)) * int(lengths.max())
    port, ref = TieredCache(lengths, budget, policy=policy), JaxCache(lengths, budget, policy=policy)
    for name, ids, nu in _cache_ops(rng, n, 300):
        if name in ("insert", "insert_filtered"):
            filt = name == "insert_filtered"
            got = port.insert(ids, src, src_off[ids], next_use=nu, filtered=filt, with_bytes=True)
            want = ref.insert(ids, src, src_off[ids], next_use=nu, filtered=filt, with_bytes=True)
            assert got == want
        elif name == "gather":
            off = np.concatenate(([0], np.cumsum(lengths[ids])[:-1]))
            dst_p = np.zeros(int(lengths[ids].sum()), np.uint8)
            dst_j = np.zeros_like(dst_p)
            hit_p, hit_j = port.gather(ids, dst_p, off), ref.gather(ids, dst_j, off)
            np.testing.assert_array_equal(hit_p, hit_j)
            np.testing.assert_array_equal(dst_p, dst_j)
            for i in np.flatnonzero(hit_p):  # hits carry the record's bytes
                r = ids[i]
                np.testing.assert_array_equal(
                    dst_p[off[i]:off[i] + lengths[r]], src[src_off[r]:src_off[r] + lengths[r]])
        elif name == "admit":
            np.testing.assert_array_equal(port.admit(ids, nu), ref.admit(ids, nu))
        elif name == "pin":
            port.pin(ids)
            ref.pin(ids)
        elif name == "unpin":
            port.unpin(ids)
            ref.unpin(ids)
        elif name == "note_next_use":
            port.note_next_use(ids, nu)
            ref.note_next_use(ids, nu)
        else:
            assert port.invalidate(ids) == ref.invalidate(ids)
        np.testing.assert_array_equal(port.resident(np.arange(n)), ref.resident(np.arange(n)))
    assert _counters(port, CACHE_COUNTERS) == _counters(ref, CACHE_COUNTERS)
    assert port.used_bytes <= port.budget_bytes
    np.testing.assert_array_equal(port.next_use, ref.next_use)
    np.testing.assert_array_equal(port.pinned(np.arange(n)), ref.pinned(np.arange(n)))


def test_copy_records_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, size=4000, dtype=np.uint8)
    lens = rng.integers(0, 30, size=60)
    src_off = rng.integers(0, 4000 - 30, size=60)
    dst_off = np.concatenate(([0], np.cumsum(lens)[:-1]))
    got, want = np.zeros(int(lens.sum()), np.uint8), np.zeros(int(lens.sum()), np.uint8)
    copy_records(src, src_off, got, dst_off, lens)
    jax_copy_records(src, src_off, want, dst_off, lens)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- scheduler
def _plan_tuple(p):
    opt = lambda a: None if a is None else a.tolist()  # noqa: E731
    return (p.epoch, p.seq, p.batch.tolist(), p.fetch.tolist(), p.fetch_bytes,
            opt(p.use_pos), opt(p.peer))


@pytest.mark.parametrize("policy,lookahead", [("lru", 3), ("belady", 3), ("belady", 7)])
def test_lookahead_scheduler_equal_plans(stores, policy, lookahead):
    """Both schedulers over the same shuffler stream and cache history:
    each plan's fetch set, bytes and admission priorities are equal; the
    caches are filled from every plan as the fetcher would."""
    ts, _, _ = stores["ragged"]
    lengths = ts.lengths()
    src = np.zeros(int(lengths.sum()), np.uint8)
    src_off = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    budget = 40 * int(lengths.max())
    port_c, ref_c = TieredCache(lengths, budget, policy=policy), JaxCache(lengths, budget, policy=policy)
    port = LookaheadScheduler(LIRSShuffler(N_RECORDS, BATCH, seed=3), port_c,
                              lookahead=lookahead, max_epochs=EPOCHS)
    ref = JaxScheduler(JaxLIRS(N_RECORDS, BATCH, seed=3), ref_c,
                       lookahead=lookahead, max_epochs=EPOCHS)
    assert port.planner == ref.planner == (policy == "belady")

    def fill(plans, sched, cache):
        for p in plans:
            cache.insert(p.fetch, src, src_off[p.fetch], next_use=p.use_pos,
                         filtered=sched.planner)
        return [_plan_tuple(p) for p in plans]

    n_plans = 0
    for epoch in range(EPOCHS):
        assert fill(port.start_epoch(epoch), port, port_c) == fill(ref.start_epoch(epoch), ref, ref_c)
        for batch in LIRSShuffler(N_RECORDS, BATCH, seed=3).epoch_batches(epoch):
            nu_p, nu_j = port.next_use_after(batch), ref.next_use_after(batch)
            assert (nu_p is None) == (nu_j is None)
            if nu_p is not None:
                np.testing.assert_array_equal(nu_p, nu_j)
            got = fill(port.advance(batch), port, port_c)
            assert got == fill(ref.advance(batch), ref, ref_c)
            n_plans += len(got)
        assert _counters(port, SCHED_COUNTERS) == _counters(ref, SCHED_COUNTERS)
    assert n_plans > 0
    assert _counters(port_c, CACHE_COUNTERS) == _counters(ref_c, CACHE_COUNTERS)


# --------------------------------------------------------------- fetcher
def _records(batch):
    """A batch as a list of per-record bytes (dense buffer or arena)."""
    if hasattr(batch, "tolist") and isinstance(batch, tuple):
        return batch.tolist()
    return [bytes(r) for r in np.asarray(batch)]


def _fetcher_state(f):
    return {**_counters(f.cache, CACHE_COUNTERS), **_counters(f.scheduler, SCHED_COUNTERS),
            **_counters(f, FETCHER_COUNTERS)}


@pytest.mark.parametrize("planner", [False, True])
@pytest.mark.parametrize("policy", ["lru", "belady"])
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_prefetching_fetcher_matches_jax_in_the_foreground(stores, kind, policy, planner):
    """``background=False``: plans run in the caller's thread, so every
    batch and every counter is deterministic, and equal to the JAX tier's
    and (the bytes) to the direct read."""
    ts, js, recs = stores[kind]
    ts.stats.reset()
    js.stats.reset()
    budget = 50 * int(ts.lengths().max())
    kw = dict(budget_bytes=budget, lookahead=4, mode=kind, background=False,
              max_epochs=EPOCHS, policy=policy, planner=planner)
    port = PrefetchingFetcher(ts, LIRSShuffler(N_RECORDS, BATCH, seed=1), **kw)
    ref = jax_build_data_plane(js, JaxReadPathConfig(
        mode=kind, shuffler=JaxLIRS(N_RECORDS, BATCH, seed=1), cache_budget_bytes=budget,
        lookahead=4, prefetch_background=False, max_epochs=EPOCHS, eviction_policy=policy,
        prefetch_planner=planner))
    try:
        for epoch in range(EPOCHS):
            for idx, jidx in zip(port.batch_iter(epoch), ref.batch_iter(epoch)):
                np.testing.assert_array_equal(idx, jidx)
                got, want = _records(port(idx)), _records(ref(jidx))
                assert got == want == [recs[i] for i in idx]
            assert _fetcher_state(port) == _fetcher_state(ref)
        assert port.cache.hits > 0
        assert ts.stats.snapshot() == js.stats.snapshot()
    finally:
        port.close()
        ref.close()


def _epoch_records(pipe, epochs):
    return [[r for item in pipe.epoch(e) for r in _records(item)] for e in range(epochs)]


@pytest.mark.parametrize("producers", [1, 3])
@pytest.mark.parametrize("policy", ["lru", "belady"])
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_background_tier_batches_equal_jax_and_direct(stores, kind, policy, producers):
    """With the background worker the counters depend on thread timing;
    the bytes never do: the port's tiered plane, the JAX one and the
    port's direct plane yield the same records, epoch for epoch."""
    ts, js, recs = stores[kind]
    budget = 30 * int(ts.lengths().max())
    cfg = ReadPathConfig(mode=kind, shuffler=LIRSShuffler(N_RECORDS, BATCH, seed=2),
                         cache_budget_bytes=budget, lookahead=5, max_epochs=EPOCHS,
                         eviction_policy=policy, workers=2)
    port = build_data_plane(ts, cfg)
    ref = jax_build_data_plane(js, JaxReadPathConfig(
        mode=kind, shuffler=JaxLIRS(N_RECORDS, BATCH, seed=2), cache_budget_bytes=budget,
        lookahead=5, max_epochs=EPOCHS, eviction_policy=policy, workers=2))
    direct = build_data_plane(ts, ReadPathConfig(mode=kind))
    try:
        got = _epoch_records(InputPipeline(port.batch_iter, port, num_producers=producers), EPOCHS)
        want = _epoch_records(JaxPipeline(ref.batch_iter, ref, num_producers=producers), EPOCHS)
        plain = _epoch_records(InputPipeline(LIRSShuffler(N_RECORDS, BATCH, seed=2).epoch_batches,
                                             direct), EPOCHS)
        assert got == want == plain
        order = [np.concatenate(list(LIRSShuffler(N_RECORDS, BATCH, seed=2).epoch_batches(e)))
                 for e in range(EPOCHS)]
        assert got == [[recs[i] for i in o] for o in order]
        assert port.cache.used_bytes <= budget and port.cache.stray_unpins == 0
    finally:
        close_data_plane(port)
        ref.close()


def test_tier_reconciles_with_iostats(stores):
    """Demand hits are charged to ``IOStats.cache_hits``; storage records
    are only what the tier could not serve."""
    ts, _, _ = stores["dense"]
    ts.stats.reset()
    f = PrefetchingFetcher(ts, LIRSShuffler(N_RECORDS, BATCH, seed=4),
                           budget_bytes=N_RECORDS * 48, lookahead=3, background=False,
                           max_epochs=2, policy="belady")
    try:
        for epoch in range(2):
            for idx in f.batch_iter(epoch):
                f(idx)
        assert ts.stats.cache_hits == f.cache.hits
        # a whole-store budget: after the cold epoch, storage is never read
        assert ts.stats.batch_records == N_RECORDS
        assert f.cache.hits + f.cache.misses == 2 * N_RECORDS
    finally:
        f.close()


# ------------------------------------------------------------------ drift
DRIFT_CASES = [
    # (capacity_frac, policy, planner_on, storage_records, storage_ios, device)
    (0.5, "belady", True, 8, 3, "optane"),
    (0.5, "belady", True, 11, 5, None),
    (0.25, "lru", False, 190, 40, "ssd"),
    (0.8, "lru", True, 70, 12, "hdd"),
    (1.0, "belady", True, 0, 0, "optane"),
]


@pytest.mark.parametrize("c,policy,planner_on,records,ios,device", DRIFT_CASES)
def test_single_host_report_matches_jax(c, policy, planner_on, records, ios, device):
    kw = dict(n_records=240, record_bytes=16388, capacity_frac=c, policy=policy,
              planner_on=planner_on, window_frac=0.25, batch_frac=1 / 16, epochs=1,
              storage_records=records, storage_ios=ios, storage_bytes=records * 16388,
              device=device)
    got = drift.single_host_report(**kw).to_dict()
    assert got == jax_drift.single_host_report(**kw).to_dict()
    assert set(got) >= {"ok", "context", "checks"}
    for policy_ in ("lru", "belady"):
        assert drift.hit_rate_tolerance(policy_) == jax_drift.hit_rate_tolerance(policy_)
