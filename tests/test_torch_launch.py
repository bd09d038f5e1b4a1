"""The port's serving launcher: the JAX launcher's report, on the CPU,
with the request-stream feature tier off and on."""
import pytest
import torch

from repro.launch import serve as jax_serve
from repro_torch.launch import serve

ARGS = ["--smoke", "--max-batch", "2", "--prompt-capacity", "6", "--gen", "4",
        "--requests", "5", "--offered-load", "1.0"]


def test_report_carries_the_jax_launchers_keys():
    want = jax_serve.main(ARGS)
    got = serve.main(ARGS + ["--device", "cpu"])
    assert set(want) <= set(got)
    assert got["requests"] == want["requests"] == 5
    assert got["generated_tokens"] == want["generated_tokens"]  # same budgets
    assert got["prefills"] == 5 and got["slot_leaks"] == 0
    assert got["device"] == "cpu" and got["peak_memory_gib"] is None


# the JAX benchmark's feature-tier settings (benchmarks/serve_latency.py),
# 64 records of 68 bytes (a label and 16 f32 features) cached
TIER = ["--cache-mb", str(64 * 68 / 2**20), "--num-features", "512",
        "--features-per-request", "8", "--zipf-alpha", "1.1"]


@pytest.mark.parametrize("policy", ["belady", "lru"])
def test_feature_tier_report_matches_jax_launcher(policy):
    """``--cache-mb > 0``: the same synthetic feature store and request
    stream through both launchers give the same ``feature_cache`` block,
    counters and closed-form band included, and the same token budgets."""
    flags = ARGS + TIER + ["--eviction-policy", policy]
    want = jax_serve.main(flags)
    got = serve.main(flags + ["--device", "cpu"])
    assert set(want) <= set(got)
    assert got["feature_cache"] == want["feature_cache"]
    fc = got["feature_cache"]
    assert fc["capacity_records"] == 64 and fc["policy"] == policy
    assert fc["hits"] + fc["misses"] == 5 * 8
    assert fc["storage_cache_hits"] == fc["hits"] and fc["storage_records_read"] == fc["misses"]
    assert got["generated_tokens"] == want["generated_tokens"]
    assert got["requests"] == 5 and got["slot_leaks"] == 0


def test_feature_tier_refused(tmp_path):
    """A variable-length feature store stays refused, as in the JAX
    launcher: the tier serves fixed-size feature records."""
    from repro_torch.core import LocationGenerator
    from repro_torch.storage.record_store import RecordStore, RecordWriter

    path = str(tmp_path / "var.rrec")
    with RecordWriter(path) as w:
        for n in (3, 9, 5):
            w.append(bytes(range(n)))
    store = RecordStore(path)
    LocationGenerator().generate(store)
    store.close()
    with pytest.raises(ValueError, match="fixed-size"):
        serve.main(ARGS + ["--device", "cpu", "--cache-mb", "1", "--feature-data", path])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(ARGS)  # --device defaults to cuda
