"""Shared launcher flags for the read path (the port's copy of
``repro.launch.args``: ``add_read_path_args`` and
``make_shuffler_from_args``).

The launchers declare the same flags as the JAX ones; the port runs only
``--cache-mb 0`` so far, and the launchers refuse the rest of the tier.
"""
from __future__ import annotations

import argparse

SHUFFLER_CHOICES = ("lirs", "lirs_page", "bmf", "tfip", "corgipile", "corgi2")


def add_read_path_args(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Declare the shared read-path / tier flags on ``ap`` (idempotent
    per parser; returns it for chaining)."""
    g = ap.add_argument_group("read path")
    g.add_argument("--shuffler", default="lirs", choices=list(SHUFFLER_CHOICES))
    g.add_argument("--shuffle-block-records", type=int, default=0,
                   help="block size (records) for corgipile/corgi2; "
                        "0 = batch//2")
    g.add_argument("--shuffle-buffer-blocks", type=int, default=2,
                   help="shuffle-buffer span in blocks for corgipile/corgi2")
    g.add_argument("--io-workers", type=int, default=4,
                   help="reader threads for coalesced batch reads "
                        "(queue depth)")
    g.add_argument("--cache-mb", type=float, default=0.0,
                   help="DRAM tier budget in MiB (0 = no tiered read path)")
    g.add_argument("--prefetch-lookahead", type=int, default=8,
                   help="batches the clairvoyant prefetcher plans ahead")
    g.add_argument("--eviction-policy", default="belady",
                   choices=["lru", "belady"],
                   help="DRAM tier eviction: lru (recency) or belady "
                        "(farthest next use — exact under the known "
                        "LIRS permutation, estimated under a request "
                        "stream)")
    g.add_argument("--prefetch-planner", default="auto",
                   choices=["auto", "on", "off"],
                   help="policy-aware prefetch planner: simulate the "
                        "cache admission decision along the known index "
                        "stream and drop doomed records from prefetch "
                        "plans instead of reading them twice (auto = on "
                        "for belady, off for lru)")
    return ap


def make_shuffler_from_args(args, store, batch: int, seed: int):
    """Build the shuffle strategy the flags describe over ``store``."""
    from repro_torch.train.loop import make_shuffler

    kw = {}
    if args.shuffler == "lirs_page":
        kw["page_groups"] = store.page_groups()
    elif args.shuffler in ("corgipile", "corgi2"):
        if args.shuffle_block_records > 0:
            kw["block_records"] = args.shuffle_block_records
        kw["buffer_blocks"] = args.shuffle_buffer_blocks
    return make_shuffler(
        args.shuffler, store.num_records, batch, seed=seed, **kw
    )
