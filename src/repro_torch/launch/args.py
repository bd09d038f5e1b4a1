"""Shared launcher flags for the read path — declared once, parsed into
:class:`~repro_torch.core.readpath.ReadPathConfig` (the port's copy of
``repro.launch.args``).

``launch/train.py`` and ``launch/serve.py`` both front the same tiered
read path: :func:`add_read_path_args` declares the flags once,
:func:`config_from_args` round-trips them into a ``ReadPathConfig``,
and :func:`make_shuffler_from_args` builds the shuffle strategy the
tier's clairvoyance rides on.  The launchers take the same flags as the
JAX ones; the training launcher's ``--hosts N`` spreads the tier over an
in-process cluster (:mod:`repro_torch.prefetch.distributed`).
"""
from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.core.readpath import ReadPathConfig

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


def planner_from_args(args) -> Optional[bool]:
    """``--prefetch-planner`` tri-state → ``ReadPathConfig`` value
    (None = auto)."""
    return None if args.prefetch_planner == "auto" else (
        args.prefetch_planner == "on"
    )


def config_from_args(
    args,
    *,
    shuffler=None,
    max_epochs: Optional[int] = None,
    mode: str = "auto",
    ring=None,
) -> ReadPathConfig:
    """Round-trip the :func:`add_read_path_args` flags into a validated
    :class:`ReadPathConfig`.  ``shuffler`` / ``max_epochs`` / ``ring``
    come from the launcher (they are built objects, not flags)."""
    return ReadPathConfig(
        mode=mode,
        ring=ring,
        workers=args.io_workers,
        shuffler=shuffler,
        cache_budget_bytes=int(args.cache_mb * 2**20),
        lookahead=args.prefetch_lookahead,
        max_epochs=max_epochs,
        eviction_policy=args.eviction_policy,
        prefetch_planner=planner_from_args(args),
    ).validate()


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
