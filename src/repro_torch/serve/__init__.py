"""Serving: continuous batching over a slot-based KV arena.

- request:  Request/Completion, StepClock, synthetic offered-load workloads
- engine:   slot-based continuous/static batching prefill+decode engine
- reuse:    estimated-reuse admission for the request-stream feature cache
"""
from repro_torch.serve.engine import SERVE_MODES, ServeEngine  # noqa: F401
from repro_torch.serve.request import (  # noqa: F401
    Completion,
    Request,
    StepClock,
    percentile,
    synthetic_workload,
    zipf_probabilities,
)
from repro_torch.serve.reuse import (  # noqa: F401
    EstimatedReusePolicy,
    RequestStreamCache,
)
