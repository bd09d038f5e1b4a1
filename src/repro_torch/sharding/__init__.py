"""Record placement across hosts (:mod:`repro_torch.sharding.placement`).

The JAX package's ``repro.sharding`` also re-exports its XLA partition
specs (``specs``); the port has no counterpart of those yet, so this
package exports nothing.
"""
