"""The port's multi-host tier against the JAX package's, on the CPU:
``sharding/placement.py``, ``prefetch/transport.py``,
``prefetch/distributed.py`` and ``launch/mesh.py``'s CPU process mesh.

All comparisons are exact: the tier moves bytes and counts and computes
nothing in floating point.
  * ``host_slice_bounds``, ``HostShardView`` and ``ClairvoyantPlacement``'s
    tables, routes and models: equal arrays and numbers for 1–4 hosts,
    both policies, equal and unequal capacities;
  * ``make_cluster(background=False)``: every global batch byte-identical
    to JAX's cluster and to the direct read, fixed and variable stores, 1,
    2 and 4 hosts, both policies; ``aggregate_io()`` dict-equal to JAX's
    after every epoch; under Belady the steady epochs at the pigeonhole
    floor;
  * a dead peer: bytes still identical and the counters JAX's;
  * ``RemoteFetcher``'s retries and deadline under a fake clock: the same
    counters and the same sleeps as JAX's;
  * ``PeerServer``/``TCPTransport`` on localhost answer fetch and push as
    ``LocalTransport`` does, and speak JAX's wire format both ways;
  * the CPU process mesh's rounds and its failure path; the 3-process
    TCP cluster (``slow``, as JAX's).
"""
import numpy as np
import pytest
from _torch_dist import mesh_echo, mesh_raise

from repro.core.location import LocationGenerator as JaxLocationGenerator
from repro.core.shuffler import LIRSShuffler as JaxLIRS
from repro.prefetch.cache import TieredCache as JaxCache
from repro.prefetch.distributed import ClusterFetcher as JaxClusterFetcher
from repro.prefetch.distributed import RemoteFetcher as JaxRemoteFetcher
from repro.prefetch.distributed import make_cluster as jax_make_cluster
from repro.prefetch.transport import PeerServer as JaxPeerServer
from repro.prefetch.transport import TCPTransport as JaxTCPTransport
from repro.sharding import placement as jpl
from repro.storage.faults import RetryPolicy as JaxRetryPolicy
from repro.storage.record_store import RecordStore as JaxStore
from repro_torch.core import LIRSShuffler, LocationGenerator
from repro_torch.core.readpath import ReadPathConfig, build_data_plane
from repro_torch.launch.mesh import run_cpu_process_mesh
from repro_torch.prefetch.cache import TieredCache
from repro_torch.prefetch.distributed import (
    ClusterFetcher,
    RemoteFetcher,
    RemoteTier,
    make_cluster,
)
from repro_torch.prefetch.transport import LocalTransport, PeerServer, TCPTransport
from repro_torch.sharding.placement import (
    NO_HOST,
    ClairvoyantPlacement,
    HostShardView,
    host_slice_bounds,
)
from repro_torch.storage.faults import RetryPolicy
from repro_torch.storage.page_cache import DistributedCacheSim
from repro_torch.storage.record_store import RecordStore, RecordWriter

N, BATCH, RECORD = 256, 32, 64
EPOCHS = 4


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(11)
    out = {}
    with RecordWriter(str(d / "fixed.rrec"), record_size=RECORD) as w:
        for _ in range(N):
            w.append(rng.bytes(RECORD))
    out["dense"] = str(d / "fixed.rrec")
    rng = np.random.default_rng(12)
    with RecordWriter(str(d / "var.rrec")) as w:
        for _ in range(N):
            w.append(rng.bytes(int(rng.integers(4, 96))))
    out["ragged"] = str(d / "var.rrec")
    return out


def _open(path):
    store = RecordStore(path)
    if store.variable:
        LocationGenerator().generate(store)
    return store


def _jopen(path):
    store = JaxStore(path)
    if store.variable:
        JaxLocationGenerator().generate(store)
    return store


def _as_list(batch):
    return np.asarray(batch).tolist() if isinstance(batch, np.ndarray) else batch.tolist()


# ------------------------------------------------------------- placement
@pytest.mark.parametrize("blen", [1, 7, 32, 33])
def test_host_slice_bounds_equal_jax(blen):
    for hosts in (1, 2, 3, 4, 5):
        b = host_slice_bounds(blen, hosts)
        assert b.dtype == np.int64 and b[0] == 0 and b[-1] == blen
        np.testing.assert_array_equal(b, jpl.host_slice_bounds(blen, hosts))


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_host_shard_view_equals_jax(hosts):
    sh, jsh = LIRSShuffler(200, 24, seed=3), JaxLIRS(200, 24, seed=3)
    for h in range(hosts):
        v, jv = HostShardView(sh, hosts, h), jpl.HostShardView(jsh, hosts, h)
        for e in range(2):
            got, want = list(v.epoch_batches(e)), list(jv.epoch_batches(e))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(v.host_epoch_stream(e), jv.host_epoch_stream(e))
            np.testing.assert_array_equal(v.epoch_index_stream(e), jv.epoch_index_stream(e))
    with pytest.raises(ValueError):
        HostShardView(sh, hosts, hosts)


@pytest.mark.parametrize("policy", ["lru", "belady"])
@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
def test_placement_tables_equal_jax(hosts, policy):
    n = 512
    caps = [24 + 8 * h for h in range(hosts)]  # unequal budgets
    sh, jsh = LIRSShuffler(n, 64, seed=9), JaxLIRS(n, 64, seed=9)
    pl = ClairvoyantPlacement(sh, hosts, caps, policy=policy, max_epochs=4)
    jp = jpl.ClairvoyantPlacement(jsh, hosts, caps, policy=policy, max_epochs=4)
    ids = np.random.default_rng(hosts).integers(0, n, 100)
    for e in range(-1, 4):
        if e >= 0:
            np.testing.assert_array_equal(pl.consumer_table(e), jp.consumer_table(e))
        got = pl.holder_after(e)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jp.holder_after(e))
        np.testing.assert_array_equal(pl.peer_for(ids, e + 1), jp.peer_for(ids, e + 1))
    assert (pl.holder_after(3) == NO_HOST).all()  # nothing after the last epoch
    assert pl.aggregate_capacity() == jp.aggregate_capacity() == sum(caps)
    for steady in (True, False):
        assert pl.expected_storage_reads(steady) == jp.expected_storage_reads(steady)
    with pytest.raises(ValueError, match="one capacity per host"):
        ClairvoyantPlacement(sh, hosts, caps + [1])


@pytest.mark.parametrize("hosts", [1, 2, 4])
def test_simulator_with_placement_bounds_hits_the_floor(hosts):
    """``DistributedCacheSim`` (now on placement's slot bounds) replays the
    tier at the closed-form floor from epoch 1 on."""
    n, batch, cap = 1024, 128, 256
    sh = LIRSShuffler(n, batch, seed=3)
    caps = [cap // hosts] * hosts
    pl = ClairvoyantPlacement(sh, hosts, caps)
    for e, stats in enumerate(DistributedCacheSim(hosts, caps).simulate(sh, 4)):
        assert stats["local"] + stats["remote"] + stats["storage"] == stats["accesses"] == n
        if e >= 1:
            assert stats["storage"] == pl.expected_storage_reads()


# ---------------------------------------------------------- the cluster
def _clusters(path, hosts, policy, seed=5, **kw):
    sh = LIRSShuffler(N, BATCH, seed=seed, avg_instance_bytes=RECORD)
    jsh = JaxLIRS(N, BATCH, seed=seed, avg_instance_bytes=RECORD)
    common = dict(budget_bytes=N * RECORD // 2, lookahead=4, gap_bytes=0, workers=1,
                  policy=policy)
    common.update(kw)
    cl = make_cluster(lambda: _open(path), sh, hosts, **common)
    jcl = jax_make_cluster(lambda: _jopen(path), jsh, hosts,
                           **{k: (JaxRetryPolicy(**vars(v)) if k == "retry" else v)
                              for k, v in common.items()})
    return cl, jcl


@pytest.mark.parametrize("policy", ["lru", "belady"])
@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("kind", ["dense", "ragged"])
def test_cluster_batches_and_counters_equal_jax(paths, kind, hosts, policy):
    path = paths[kind]
    ref = _jopen(path)
    cl, jcl = _clusters(path, hosts, policy, max_epochs=EPOCHS)
    f, jf = ClusterFetcher(cl), JaxClusterFetcher(jcl)
    per_epoch, prev = [], 0
    try:
        for e in range(EPOCHS):
            for idx, jidx in zip(f.batch_iter(e), jf.batch_iter(e), strict=True):
                np.testing.assert_array_equal(idx, jidx)
                got, want = f(idx), jf(jidx)
                assert _as_list(got) == _as_list(want)
                if kind == "dense":
                    np.testing.assert_array_equal(got, ref.read_batch_into(idx))
                else:
                    assert got.tolist() == ref.read_batch_ragged(idx).tolist()
            agg = cl.aggregate_io()
            assert agg == jcl.aggregate_io()
            per_epoch.append(agg["storage_records"] - prev)
            prev = agg["storage_records"]
        assert cl.num_hosts == hosts
        if policy == "belady":
            floor = cl.placement.expected_storage_reads()
            assert per_epoch == [N] + [floor] * (EPOCHS - 1)
        if hosts > 1:  # under lru a peer is asked, under belady it pushed
            assert agg["remote_hits"] > 0
            assert (agg["peer_pushes"] > 0) == (policy == "belady")
        assert agg["peer_failures"] == agg["push_errors"] == 0
    finally:
        f.close()
        jf.close()
        ref.close()


def test_peer_failure_falls_back_to_storage_as_jax(paths):
    """Host 0 stops answering after a warm epoch: its pushes fail (one
    attempt each, counted), their records come from storage, the bytes
    stay the direct read's, and every counter is JAX's."""
    ref = RecordStore(paths["dense"])
    retry = RetryPolicy(max_retries=1, backoff_s=1e-4, backoff_cap_s=1e-3, deadline_s=1.0)
    cl, jcl = _clusters(paths["dense"], 2, "belady", seed=2, max_epochs=3, retry=retry)
    f, jf = ClusterFetcher(cl), JaxClusterFetcher(jcl)
    try:
        for idx in f.batch_iter(0):
            f(idx)
        for idx in jf.batch_iter(0):
            jf(idx)
        cl.transport.down.add(0)
        jcl.transport.down.add(0)
        for e in (1, 2):
            for idx, jidx in zip(f.batch_iter(e), jf.batch_iter(e), strict=True):
                got = f(idx)
                np.testing.assert_array_equal(got, ref.read_batch_into(idx))
                np.testing.assert_array_equal(got, jf(jidx))
        agg = cl.aggregate_io()
        assert agg == jcl.aggregate_io()
        assert agg["push_errors"] > 0 and agg["peer_errors"] >= agg["push_errors"]
        assert agg["peer_failures"] == 0
    finally:
        f.close()
        jf.close()
        ref.close()


@pytest.mark.parametrize("kind", ["dense", "ragged"])
@pytest.mark.parametrize("hosts", [2, 3])
def test_build_data_plane_with_remote_tier_serves_jax_bytes(paths, kind, hosts):
    """``build_data_plane`` takes ``remote=`` and ``placement=`` (the
    cross-host tier) and passes them to the fetcher: planes built per host
    over ``HostShardView`` and a ``LocalTransport`` serve JAX's store's
    bytes, with records served host-to-host and the storage floor met."""
    sh = LIRSShuffler(N, BATCH, seed=4)
    placement_caps = None
    transport = LocalTransport()
    stores, planes = [], []
    budget = N * RECORD // 2 // hosts
    for h in range(hosts):
        store = _open(paths[kind])
        probe = TieredCache(store.lengths(), budget, policy="belady")
        placement_caps = placement_caps or [probe.capacity] * hosts
        stores.append(store)
    placement = ClairvoyantPlacement(sh, hosts, placement_caps, max_epochs=3)
    for h in range(hosts):
        remote = RemoteTier(h, placement, RemoteFetcher(transport, h))
        plane = build_data_plane(stores[h], ReadPathConfig(
            shuffler=HostShardView(sh, hosts, h), cache_budget_bytes=budget, lookahead=4,
            gap_bytes=0, prefetch_background=False, max_epochs=3, eviction_policy="belady",
            remote=remote, placement=placement))
        assert plane.remote is remote and plane.scheduler.placement is placement
        transport.register(h, plane.cache)
        transport.register_inbox(h, plane._inbox_put)
        planes.append(plane)
    ref = _jopen(paths[kind])
    try:
        for e in range(3):
            for parts in zip(*[p.batch_iter(e) for p in planes], strict=True):
                for plane, part in zip(planes, parts):
                    got = plane(part)
                    want = (ref.read_batch_into(part) if kind == "dense"
                            else ref.read_batch_ragged(part))
                    assert _as_list(got) == _as_list(want)
        storage = sum(s.stats.batch_records for s in stores)
        assert storage == N + 2 * placement.expected_storage_reads()
        assert sum(s.stats.remote_hits for s in stores) > 0
    finally:
        for p in planes:
            p.close()
        for s in stores:
            s.close()
        ref.close()


# ------------------------------------------------------- remote fetcher
class _FlakyTransport:
    """Raises ``OSError`` on the first ``fails`` fetches, then answers
    every id found, one byte each."""

    def __init__(self, fails):
        self.fails = fails

    def fetch(self, peer, ids):
        if self.fails:
            self.fails -= 1
            raise OSError("injected")
        n = len(ids)
        return np.ones(n, bool), np.arange(n, dtype=np.uint8), np.arange(n), np.ones(n, np.int64)

    def push(self, peer, ids, payload, offsets, lengths, next_use):
        raise OSError("injected")


class _Clock:
    def __init__(self):
        self.t, self.sleeps = 0.0, []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


RETRY_CASES = [  # (fails, max_retries, backoff_s, cap_s, deadline_s)
    (0, 4, 0.002, 0.1, 30.0),
    (2, 4, 0.002, 0.1, 30.0),
    (10, 4, 0.002, 0.1, 30.0),  # retries exhausted: all-miss, one failure
    (10, 10, 0.05, 0.4, 1.0),   # deadline cuts the backoff short
    (3, 6, 0.01, 0.02, None),   # capped backoff, no deadline
]


@pytest.mark.parametrize("fails,retries,backoff,cap,deadline", RETRY_CASES)
def test_remote_fetcher_retries_equal_jax(fails, retries, backoff, cap, deadline):
    outs = []
    for fetcher_cls, policy_cls in ((RemoteFetcher, RetryPolicy),
                                    (JaxRemoteFetcher, JaxRetryPolicy)):
        clock = _Clock()
        rf = fetcher_cls(_FlakyTransport(fails), 1,
                         policy_cls(max_retries=retries, backoff_s=backoff,
                                    backoff_cap_s=cap, deadline_s=deadline),
                         clock=clock, sleep=clock.sleep)
        found, payload, offsets, lens = rf.fetch_from(0, np.arange(5))
        with pytest.raises(OSError):
            rf.push_to(0, np.arange(2), np.zeros(2, np.uint8), np.arange(2), np.ones(2), np.arange(2))
        outs.append(((found.tolist(), payload.tolist(), offsets.tolist(), lens.tolist()),
                     clock.sleeps,
                     {k: getattr(rf, k) for k in ("remote_hits", "remote_hit_bytes",
                                                  "remote_misses", "peer_errors",
                                                  "peer_failures", "pushed")}))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ transport
def _filled_cache(cls, store, ids):
    cache = cls(store.lengths(), 40 * RECORD, policy="belady")
    data = store.read_batch_into(ids)
    cache.insert(ids, data.reshape(-1), np.arange(len(ids), dtype=np.int64) * RECORD)
    return cache


@pytest.mark.parametrize("client,server", [("port", "port"), ("jax", "port"), ("port", "jax")])
def test_tcp_transport_answers_as_local_transport(paths, client, server):
    """A ``PeerServer`` over one cache and a ``TCPTransport`` to it give
    what ``LocalTransport`` gives over an identical cache: the same fetch
    quadruples (served records released) and push counts.  Across the
    packages the frames are the same, so either side may be JAX's."""
    store = RecordStore(paths["dense"])
    resident = np.arange(0, 60, 2)
    srv_cache = _filled_cache(JaxCache if server == "jax" else TieredCache, store, resident)
    loc_cache = _filled_cache(TieredCache, store, resident)
    srv = (JaxPeerServer if server == "jax" else PeerServer)(srv_cache)
    tcp = (JaxTCPTransport if client == "jax" else TCPTransport)({7: srv.address}, timeout_s=10.0)
    loc = LocalTransport()
    loc.register(7, loc_cache)
    loc.register_inbox(7, lambda ids, payload, offsets, lens, next_use: loc_cache.insert(
        ids, payload, offsets, next_use=next_use, filtered=True))
    try:
        for ids in (np.array([0, 1, 2, 3, 58, 59]), np.array([4, 4, 6]), np.array([1, 3]),
                    np.array([], np.int64)):
            got, want = tcp.fetch(7, ids), loc.fetch(7, ids)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        push_ids = np.array([100, 101, 102])
        data = store.read_batch_into(push_ids).reshape(-1)
        offs = np.arange(3, dtype=np.int64) * RECORD
        lens = np.full(3, RECORD, np.int64)
        nxt = np.array([5, 6, 7])
        assert tcp.push(7, push_ids, data, offs, lens, nxt) == loc.push(
            7, push_ids, data, offs, lens, nxt) > 0
        np.testing.assert_array_equal(srv_cache.resident(np.arange(N)),
                                      loc_cache.resident(np.arange(N)))
        with pytest.raises(OSError):
            tcp.fetch(8, np.array([1]))
    finally:
        tcp.close()
        srv.close()
        loc.close()
        store.close()


def test_tcp_transport_dead_peer_raises_and_reconnects(paths):
    """A peer with no server raises ``OSError``, which ``RemoteFetcher``
    retries, then answers all-miss and counts one failure; a server
    brought up at that address later is reached on a fresh connection."""
    store = RecordStore(paths["dense"])
    cache = _filled_cache(TieredCache, store, np.arange(8))
    srv = PeerServer(cache)
    addr = srv.address
    srv.close()
    tcp = TCPTransport({0: addr}, timeout_s=5.0)
    rf = RemoteFetcher(tcp, 1, RetryPolicy(max_retries=1, backoff_s=1e-4, backoff_cap_s=1e-3,
                                           deadline_s=1.0))
    try:
        found, payload, _, _ = rf.fetch_from(0, np.array([3]))
        assert not found.any() and payload.size == 0
        assert rf.peer_failures == 1 and rf.peer_errors == 2
        srv = PeerServer(cache, port=addr[1])
        found, payload, _, lens = rf.fetch_from(0, np.array([3, 9]))
        assert found.tolist() == [True, False] and lens.tolist() == [RECORD]
        np.testing.assert_array_equal(payload, store.read_batch_into(np.array([3])).reshape(-1))
        assert rf.remote_hits == 1 and rf.remote_misses == 1 and rf.peer_failures == 1
    finally:
        tcp.close()
        srv.close()
        store.close()


# ------------------------------------------------------------------ mesh
def test_cpu_process_mesh_rounds():
    codes = run_cpu_process_mesh(mesh_echo, 3, args=(4,), mp_context="spawn",
                                 round_timeout_s=60.0, join_timeout_s=60.0)
    assert codes == [0, 0, 0]


def test_cpu_process_mesh_fails_when_a_host_dies():
    with pytest.raises(RuntimeError, match="cpu process mesh failed"):
        run_cpu_process_mesh(mesh_raise, 2, mp_context="spawn", round_timeout_s=60.0,
                             join_timeout_s=60.0)
    with pytest.raises(ValueError):
        run_cpu_process_mesh(mesh_echo, 0)


def _tcp_mesh_target(spec, path, n, batch, budget_bytes, epochs):
    """One host process: a PeerServer over its cache, a TCPTransport to
    the peers found through all_gather, lockstep epochs."""
    from repro_torch.prefetch.fetcher import PrefetchingFetcher

    sh = LIRSShuffler(n, batch, seed=5)
    store, ref = RecordStore(path), RecordStore(path)
    cache = TieredCache(store.lengths(), budget_bytes, policy="belady")
    server = PeerServer(cache)
    addrs = spec.all_gather(server.address)
    transport = TCPTransport({h: a for h, a in addrs.items() if h != spec.host_id})
    placement = ClairvoyantPlacement(sh, spec.num_hosts, [cache.capacity] * spec.num_hosts,
                                     policy="belady", max_epochs=epochs)
    remote = RemoteTier(spec.host_id, placement, RemoteFetcher(transport, spec.host_id))
    fetcher = PrefetchingFetcher(store, HostShardView(sh, spec.num_hosts, spec.host_id),
                                 lookahead=2, gap_bytes=0, workers=1, background=False,
                                 max_epochs=epochs, cache=cache, policy="belady",
                                 remote=remote, placement=placement)
    server.inbox = fetcher._inbox_put
    spec.all_gather(None)
    for e in range(epochs):
        for part in fetcher.batch_iter(e):
            np.testing.assert_array_equal(fetcher(part), ref.read_batch_into(part))
            spec.all_gather(None)
    stats = spec.all_gather({"remote_hits": store.stats.remote_hits,
                             "pushed": fetcher.pushed_records,
                             "push_errors": fetcher.push_errors,
                             "peer_failures": remote.fetcher.peer_failures,
                             "storage_records": store.stats.batch_records})
    assert sum(v["peer_failures"] + v["push_errors"] for v in stats.values()) == 0
    assert sum(v["pushed"] for v in stats.values()) > 0
    assert sum(v["remote_hits"] for v in stats.values()) > 0
    assert (sum(v["storage_records"] for v in stats.values())
            == n + (epochs - 1) * placement.expected_storage_reads())
    fetcher.close()
    server.close()
    transport.close()
    ref.close()
    store.close()


@pytest.mark.slow
def test_tcp_process_mesh_cluster(paths):
    """3 processes over real sockets: byte identity, peer serving and the
    storage floor hold over the wire protocol."""
    codes = run_cpu_process_mesh(_tcp_mesh_target, 3,
                                 args=(paths["dense"], N, BATCH, N * RECORD // 4, 3),
                                 round_timeout_s=120.0)
    assert all(c == 0 for c in codes)
