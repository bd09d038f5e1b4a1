"""Partition specs (:mod:`repro_torch.sharding.specs`, re-exported here
as the JAX package's ``repro.sharding`` re-exports its own) and record
placement across hosts (:mod:`repro_torch.sharding.placement`)."""
from repro_torch.sharding.specs import (  # noqa: F401
    batch_pspecs,
    cache_pspecs,
    param_pspecs,
    state_pspecs,
)
