"""The port's serving launcher: the JAX launcher's report, on the CPU."""
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


def test_feature_tier_refused():
    with pytest.raises(NotImplementedError, match="cache-mb"):
        serve.main(ARGS + ["--device", "cpu", "--cache-mb", "1"])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(ARGS)  # --device defaults to cuda
