"""Serving requests, clocks, and synthetic offered-load workloads.

Latency is measured on a *step clock*: one unit per engine step
(deterministic given the workload seed, so CI can gate p50/p99 without
wall-clock noise), while throughput (tokens/s) is measured on the wall
clock by the driver.  Arrivals are Poisson in step units at a
configurable offered load; feature ids follow a Zipf popularity law so
the request-stream cache has skew to exploit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


class StepClock:
    """Virtual time: the engine advances it one unit per decode step."""

    def __init__(self) -> None:
        self._now = 0.0

    def now(self) -> float:
        return self._now

    def advance(self, dt: float = 1.0) -> None:
        self._now += dt


@dataclasses.dataclass
class Request:
    """One generation request."""

    rid: int
    prompt: np.ndarray          # int32 prompt tokens
    max_new_tokens: int
    arrival: float = 0.0        # step-clock units
    # record ids of the features/embeddings this request consults (served
    # through the RequestStreamCache when one is attached)
    feature_ids: Optional[np.ndarray] = None


@dataclasses.dataclass
class Completion:
    """A finished request with its step-clock timeline."""

    rid: int
    tokens: List[int]
    arrival: float
    first_token: float
    finished: float

    @property
    def latency(self) -> float:
        return self.finished - self.arrival

    @property
    def ttft(self) -> float:
        return self.first_token - self.arrival


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation)."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = min(len(xs) - 1, max(0, int(np.ceil(q / 100.0 * len(xs))) - 1))
    return float(xs[k])


def zipf_probabilities(n: int, alpha: float) -> np.ndarray:
    """Zipf popularity over ``n`` items: ``p_i ∝ 1/(i+1)^alpha``."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), alpha)
    return w / w.sum()


def synthetic_workload(
    num_requests: int,
    *,
    vocab: int,
    offered_load: float,
    prompt_len: Tuple[int, int] = (4, 12),
    gen_len: Tuple[int, int] = (4, 16),
    num_features: int = 0,
    features_per_request: int = 0,
    zipf_alpha: float = 1.1,
    seed: int = 0,
) -> List[Request]:
    """Poisson arrivals at ``offered_load`` requests per engine step,
    uniform prompt/generation lengths in the given inclusive ranges, and
    (optionally) Zipf-popular feature ids per request."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / offered_load, num_requests))
    feat_p = (
        zipf_probabilities(num_features, zipf_alpha) if num_features else None
    )
    out: List[Request] = []
    for i in range(num_requests):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        glen = int(rng.integers(gen_len[0], gen_len[1] + 1))
        feats = None
        if feat_p is not None and features_per_request:
            feats = rng.choice(
                num_features, size=features_per_request, p=feat_p
            ).astype(np.int64)
        out.append(
            Request(
                rid=i,
                prompt=rng.integers(1, vocab, size=plen).astype(np.int32),
                max_new_tokens=glen,
                arrival=float(arrivals[i]),
                feature_ids=feats,
            )
        )
    return out
