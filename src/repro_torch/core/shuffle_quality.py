"""Shuffle-quality metrics: how random is an epoch's access stream?

The shuffle-strategy spectrum trades randomness for I/O cost: LIRS pays
one random read per record for a fully uniform per-epoch permutation;
block strategies (BMF, CorgiPile, Corgi²) read near-sequentially but
quantize randomness to a block or buffer span; TFIP's streaming queue
randomizes only within a sliding window.  SGD convergence tracks the
*quality* end of that trade (the paper's Tables 3/6: full shuffles
converge like uniform SGD, degenerate ones like cyclic), so the frontier
benchmark needs a convergence-free, closed-form proxy measurable on the
index stream alone.  Two entropies cover the two ways a stream can be
non-random:

* :func:`within_batch_entropy` — **spatial spread of one batch.**  The
  id space is cut into buckets of one batch width; each served batch's
  bucket histogram is scored by normalized Shannon entropy and averaged
  over the epoch.  A uniform batch touches every region of the dataset
  (entropy → 1); a sequential or single-block batch is one bucket
  (entropy → 0); a buffer-bounded shuffle lands in between, rising with
  the span.  This is the metric SGD cares about per *step*: gradient
  bias grows when a batch over-samples one physical region, which is
  exactly co-resident correlated records (the paper's motivation for
  shuffling at all).
* :func:`successor_gap_entropy` — **sequential structure of the whole
  stream.**  Consecutive accesses' signed id gaps are histogrammed in
  log2-width bins (sign preserved — forward scans and backward scans are
  both structure); normalized entropy of that histogram.  A sequential
  scan is a point mass at gap +1 (entropy 0); a uniform permutation
  spreads mass over all magnitudes; block-sequential streams sit between
  (mostly +1 within a block, one long jump per block edge).  This is
  the metric the *storage tier* cares about: it is low exactly when
  reads coalesce.

Both are deterministic functions of the stream — no seeds, no model —
so the frontier benchmark can assert monotonicity (larger shuffle span
⇒ larger entropy) and the extremes (TFIP ``queue_size=1`` ≡ sequential
scan ⇒ 0; CorgiPile with the buffer spanning the dataset ≡ full shuffle
⇒ the LIRS value) as hard gates rather than statistical ones.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = [
    "within_batch_entropy",
    "successor_gap_entropy",
    "stream_quality",
    "epoch_quality",
]


def _entropy(counts: np.ndarray) -> float:
    """Shannon entropy (nats) of a count histogram."""
    total = counts.sum()
    if total <= 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log(p)).sum())


def within_batch_entropy(
    stream: np.ndarray, batch_size: int, num_items: int | None = None
) -> float:
    """Mean normalized entropy of per-batch bucket histograms, in [0, 1].

    ``stream`` is one epoch's access order; buckets are ``batch_size``-
    wide slices of the *physical* id space, so a full batch drawn
    uniformly spreads over ``n / batch_size`` buckets while a sequential
    batch fills exactly one.  Normalization is by the entropy of the
    best-spread batch (``log(min(B, num_buckets))``), making 1.0 the
    even-spread limit independent of the batch/bucket geometry.
    """
    stream = np.asarray(stream, np.int64)
    n = int(num_items) if num_items is not None else int(stream.max()) + 1
    if len(stream) == 0 or n <= 0:
        return 0.0
    bs = max(1, int(batch_size))
    num_buckets = -(-n // bs)
    if num_buckets <= 1:
        return 0.0
    buckets = stream // bs
    scores = []
    for i in range(0, len(stream), bs):
        b = buckets[i : i + bs]
        hmax = np.log(min(len(b), num_buckets))
        if hmax <= 0:
            continue
        scores.append(_entropy(np.bincount(b, minlength=num_buckets)) / hmax)
    return float(np.mean(scores)) if scores else 0.0


def successor_gap_entropy(
    stream: np.ndarray, num_items: int | None = None
) -> float:
    """Normalized entropy of the signed log2-binned successor-gap
    histogram, in [0, 1].

    Gap ``g = stream[i+1] - stream[i]`` falls in bin
    ``sign(g) * (floor(log2(|g|)) + 1)`` (bin 0 would be ``g == 0``,
    impossible within a permutation), giving ``2 * ceil(log2(n))``
    possible bins; normalization is by the log of that bin count.  A
    sequential scan is a point mass (0), and the uniform-permutation
    value — the quantity the frontier normalizes against — follows from
    the triangular gap distribution, concentrated in the top few
    magnitude bins (≈ 0.55 for the sizes swept here).
    """
    stream = np.asarray(stream, np.int64)
    if len(stream) < 2:
        return 0.0
    n = int(num_items) if num_items is not None else int(stream.max()) + 1
    gaps = np.diff(stream)
    gaps = gaps[gaps != 0]
    if len(gaps) == 0 or n < 2:
        return 0.0
    mag = np.floor(np.log2(np.abs(gaps))).astype(np.int64) + 1
    levels = int(np.ceil(np.log2(n))) + 1
    bins = np.where(gaps > 0, mag, -mag) + levels  # shift into [0, 2L]
    hmax = np.log(2 * levels + 1)
    if hmax <= 0:
        return 0.0
    h = _entropy(np.bincount(bins, minlength=2 * levels + 1))
    return float(h / hmax)


def stream_quality(
    stream: np.ndarray, batch_size: int, num_items: int | None = None
) -> Dict[str, float]:
    """Both metrics for one epoch stream."""
    return {
        "within_batch_entropy": within_batch_entropy(
            stream, batch_size, num_items
        ),
        "successor_gap_entropy": successor_gap_entropy(stream, num_items),
    }


def epoch_quality(shuffler, epoch: int = 0) -> Dict[str, float]:
    """Convenience: score ``shuffler``'s epoch via its index stream —
    works for any strategy exposing ``epoch_index_stream`` (LIRS, TFIP,
    BMF, CorgiPile, Corgi²), which is the same contract the clairvoyant
    scheduler consumes."""
    stream = np.asarray(shuffler.epoch_index_stream(epoch), np.int64)
    return stream_quality(
        stream, getattr(shuffler, "batch_size", 512), shuffler.num_items
    )
