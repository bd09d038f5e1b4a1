"""Clairvoyant prefetch + tiered DRAM cache over the record store (the
port's copy of ``repro.prefetch``, single host).

LIRS shuffles *indexes*, not data: the entire per-epoch storage access
sequence is known before the first batch is read.  This package exploits
that clairvoyance as a layer between shuffling and storage; all of it is
numpy and threads on the host, with no device code:

* :class:`~repro_torch.prefetch.cache.TieredCache` — a byte-budgeted
  DRAM tier holding record payloads in a slot arena, served and filled
  with vectorized gathers, with known-reuse pinning.  Eviction is
  LRU-by-batch or Belady's farthest-next-use rule, which is *exact* here
  because the scheduler knows every future position.
* :class:`~repro_torch.prefetch.scheduler.LookaheadScheduler` — walks
  the shuffler's future index stream N batches ahead (across epoch
  boundaries), emits deduplicated prefetch plans and feeds the cache
  each served record's next-use position.
* :class:`~repro_torch.prefetch.fetcher.PrefetchingFetcher` — an
  ``InputPipeline`` ``fetch_fn`` drop-in (dense and ragged) whose
  background worker executes plans through the store's pread pool.
  Batch bytes are identical with prefetch on or off.

The multi-host tier (``repro.prefetch.distributed`` and ``transport``)
is not in the port yet.
"""
from repro_torch.prefetch.cache import NEVER, TieredCache, copy_records
from repro_torch.prefetch.fetcher import PrefetchingFetcher
from repro_torch.prefetch.scheduler import LookaheadScheduler, PrefetchPlan

__all__ = [
    "NEVER",
    "TieredCache",
    "copy_records",
    "LookaheadScheduler",
    "PrefetchPlan",
    "PrefetchingFetcher",
]
