"""The port's serving engine: the contracts of ``tests/test_serve.py``
(no slot leak, slots reused, greedy tokens identical to a solo run, one
arena allocation, static shapes, submit validation, refused kinds), plus
the cross-check that matters for a port: the same float32 workload
through the JAX ``ServeEngine`` and the port's, with the JAX weights
carried across, gives identical completion tokens.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.granite_3_8b import smoke_config as jax_smoke
from repro.models import model as jm
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs.granite_3_8b import smoke_config
from repro_torch.models import model as model_lib
from repro_torch.models.weights import params_from_jax
from repro_torch.obs import trace
from repro_torch.serve import Request, ServeEngine, synthetic_workload


@pytest.fixture(scope="module")
def cfg():
    return smoke_config()


@pytest.fixture(scope="module")
def params(cfg):
    return model_lib.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _engine(cfg, params, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("prompt_capacity", 8)
    kw.setdefault("max_new_tokens", 6)
    return ServeEngine(cfg, params, **kw)


def _workload(cfg, n, load=0.8, seed=3):
    return synthetic_workload(
        n, vocab=cfg.vocab_size, offered_load=load,
        prompt_len=(2, 8), gen_len=(2, 6), seed=seed,
    )


# ------------------------------------------------- engine: slot hygiene
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_no_slot_leak_after_mixed_workload(cfg, params, mode):
    eng = _engine(cfg, params, mode=mode)
    reqs = _workload(cfg, 24)
    comps = eng.run(reqs)
    assert eng.free_slots == eng.max_batch
    assert eng.active == 0 and not eng.queue
    assert sorted(c.rid for c in comps) == sorted(r.rid for r in reqs)
    budget = {r.rid: r.max_new_tokens for r in reqs}
    for c in comps:
        assert len(c.tokens) == budget[c.rid]
        assert c.arrival <= c.first_token <= c.finished


def test_slots_reused_not_grown(cfg, params):
    eng = _engine(cfg, params, max_batch=2)
    eng.run(_workload(cfg, 12, load=2.0))
    assert eng.prefills == 12
    assert eng.free_slots == 2


# ------------------------------------ engine: scheduling changes nothing
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_greedy_tokens_identical_to_solo_run(cfg, params, mode):
    reqs = _workload(cfg, 8, load=1.5, seed=11)
    eng = _engine(cfg, params, mode=mode)
    got = {c.rid: c.tokens for c in eng.run(reqs)}
    for r in reqs:
        solo = _engine(cfg, params, max_batch=1)
        [c] = solo.run([Request(rid=r.rid, prompt=r.prompt,
                                max_new_tokens=r.max_new_tokens)])
        assert got[r.rid] == c.tokens, f"rid {r.rid} diverged under {mode}"


def test_eos_retires_early_and_frees_slot(cfg, params):
    """The eos id is one whose first occurrence in the free run is at the
    intended cut, so an earlier repeat cannot stop the run sooner."""
    req = _workload(cfg, 1, seed=5)[0]
    req.arrival = 0.0
    [full] = _engine(cfg, params).run([req])
    cut_at = next(i for i in range(1, len(full.tokens))
                  if full.tokens[i] not in full.tokens[:i])
    eng = _engine(cfg, params, eos_id=full.tokens[cut_at])
    [cut] = eng.run([Request(rid=0, prompt=req.prompt,
                             max_new_tokens=req.max_new_tokens)])
    assert cut.tokens == full.tokens[: cut_at + 1]
    assert eng.free_slots == eng.max_batch


def test_continuous_retires_in_fewer_decode_steps(cfg, params):
    reqs = _workload(cfg, 16, load=2.0, seed=9)
    cont = _engine(cfg, params, mode="continuous")
    stat = _engine(cfg, params, mode="static")
    cont.run(reqs)
    stat.run(list(reqs))
    assert cont.generated_tokens == stat.generated_tokens
    assert cont.decode_steps < stat.decode_steps


def test_submit_validates_against_arena(cfg, params):
    eng = _engine(cfg, params, prompt_capacity=4, max_new_tokens=3)
    with pytest.raises(ValueError, match="prompt_capacity"):
        eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                           max_new_tokens=2))
    with pytest.raises(ValueError, match="generation arena"):
        eng.submit(Request(rid=1, prompt=np.arange(2, dtype=np.int32),
                           max_new_tokens=9))
    with pytest.raises(ValueError, match="mode must be one of"):
        _engine(cfg, params, mode="batched")


def test_engine_refuses_unservable_and_unported(cfg, params):
    with pytest.raises(ValueError, match="local_attn"):
        _engine(cfg.replace(stages=((("attn", "local_attn"), 1),)), params)
    with pytest.raises(ValueError, match="mlstm"):  # ported, but not servable (recurrent state)
        _engine(cfg.replace(stages=((("mlstm",), 1),)), params)


# ------------------------------------------- engine: one arena, forever
def test_arena_allocated_exactly_once(cfg, params):
    trace.disable()
    rec = trace.enable(capacity_per_thread=1024)
    try:
        eng = _engine(cfg, params)
        eng.run(_workload(cfg, 10, load=1.2, seed=2))
    finally:
        trace.disable()
    evs = rec.drain()
    allocs = [e for e in evs if e["name"] == "serve/arena_alloc"]
    assert len(allocs) == 1
    assert allocs[0]["args"]["slots"] == eng.max_batch
    assert allocs[0]["args"]["capacity"] == eng.capacity
    prefills = [e for e in evs if e["name"] == "serve/prefill"]
    decodes = [e for e in evs if e["name"] == "serve/decode"]
    assert len(prefills) == eng.prefills == 10
    assert len(decodes) == eng.decode_steps > 0
    t0 = allocs[0]["ts"]
    assert all(e["ts"] >= t0 for e in prefills + decodes)


def test_arena_storage_static_across_run(cfg, params):
    """Shapes and the storage itself: decode updates the arena in place."""
    eng = _engine(cfg, params)
    leaves = [t for st in eng.arena["stages"] for c in st for t in c.values()]
    before = [(t.shape, t.data_ptr()) for t in leaves]
    eng.warmup()
    eng.run(_workload(cfg, 6, seed=4))
    leaves = [t for st in eng.arena["stages"] for c in st for t in c.values()]
    assert [(t.shape, t.data_ptr()) for t in leaves] == before


# --------------------------------------- the port against the reference
@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_same_completion_tokens_as_jax_engine(mode):
    jcfg = jax_smoke().replace(dtype="float32")
    tcfg = smoke_config().replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    kw = dict(max_batch=3, prompt_capacity=8, max_new_tokens=6, mode=mode)
    reqs = _workload(tcfg, 10, load=0.5, seed=7)
    jeng = JaxServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, **kw)
    jeng.warmup()
    teng.warmup()
    seen = []  # arena positions at each decode: idle slots run past C
    decode = teng._decode
    teng._decode = lambda: seen.append(int(teng.arena["pos"].max())) or decode()
    want = {c.rid: (c.tokens, c.first_token, c.finished) for c in jeng.run(reqs)}
    got = {c.rid: (c.tokens, c.first_token, c.finished) for c in teng.run(reqs)}
    assert got == want
    assert max(seen) >= teng.capacity
    assert (teng.decode_steps, teng.prefills) == (jeng.decode_steps, jeng.prefills)


@pytest.mark.parametrize("policy", ["belady", "lru"])
def test_feature_cache_engine_matches_jax_engine(tmp_path, policy):
    """Each admission serves the request's Zipf feature ids through a
    ``RequestStreamCache`` before its prefill: completions, step counts,
    the cache's counters and the store's equal the JAX engine's over one
    feature file, and every fetched id is counted once."""
    from repro.serve import RequestStreamCache as JaxStreamCache
    from repro.storage.record_store import RecordStore as JaxStore
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.serve import RequestStreamCache
    from repro_torch.storage.record_store import RecordStore

    path = make_classification_dataset(str(tmp_path / "f.rrec"), 64, dim=16, seed=0).path
    jcfg = jax_smoke().replace(dtype="float32")
    tcfg = smoke_config().replace(dtype="float32")
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    reqs = synthetic_workload(12, vocab=tcfg.vocab_size, offered_load=1.0, prompt_len=(2, 8),
                              gen_len=(2, 6), num_features=64, features_per_request=4, seed=5)
    assert all(r.feature_ids is not None for r in reqs)
    ts, js = RecordStore(path), JaxStore(path)
    budget = 16 * ts.record_size
    tfc, jfc = RequestStreamCache(ts, budget, policy=policy), JaxStreamCache(js, budget, policy=policy)
    kw = dict(max_batch=3, prompt_capacity=8, max_new_tokens=6)
    teng = ServeEngine(tcfg, tparams, feature_cache=tfc, **kw)
    jeng = JaxServeEngine(jcfg, jparams, feature_cache=jfc, **kw)
    want = {c.rid: (c.tokens, c.first_token, c.finished) for c in jeng.run(reqs)}
    got = {c.rid: (c.tokens, c.first_token, c.finished) for c in teng.run(reqs)}
    assert got == want
    assert (teng.decode_steps, teng.prefills) == (jeng.decode_steps, jeng.prefills)
    counters = ("hits", "misses", "insertions", "evictions", "planned_skips", "used_bytes")
    assert {k: getattr(tfc.cache, k) for k in counters} == {k: getattr(jfc.cache, k) for k in counters}
    assert tfc.fetched == 12 * 4 == tfc.cache.hits + tfc.cache.misses
    assert ts.stats.cache_hits == tfc.cache.hits and ts.stats.batch_records == tfc.cache.misses
    assert tfc.cache.hits > 0
    ts.close()
    js.close()
