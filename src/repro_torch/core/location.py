"""Data-Format-Aware Location Generator (paper §4.1).

Fixed-size records: offset(i) = header + i·record_size — O(1), no
pre-processing (LIRS eliminates the pre-processing stage entirely).

Variable-length (sparse) records: one *sequential* scan builds the offset
table (N×8 B) — the only pre-processing LIRS keeps, replacing BMF's
shuffle-and-write-back pass.
"""
from __future__ import annotations

import struct
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.storage.record_store import HEADER_SIZE, RecordStore


@dataclass
class LocationTable:
    offsets: np.ndarray  # int64, absolute file offset of each record
    lengths: np.ndarray  # int64, payload bytes (excludes length prefix)
    scan_bytes: int      # bytes sequentially read to build it (0 for fixed)
    build_seconds: float

    @property
    def nbytes(self) -> int:
        """Host memory overhead — the paper's Table 5 'Offset Table'."""
        return int(self.offsets.nbytes + self.lengths.nbytes)


class LocationGenerator:
    def generate(self, store: RecordStore) -> LocationTable:
        t0 = time.perf_counter()
        if not store.variable:
            table = LocationTable(
                offsets=store.offsets().copy(),
                lengths=store.lengths().copy(),
                scan_bytes=0,
                build_seconds=time.perf_counter() - t0,
            )
            return table
        offsets = np.empty(store.num_records, dtype=np.int64)
        lengths = np.empty(store.num_records, dtype=np.int64)
        i = 0
        pos = HEADER_SIZE
        buf = b""
        buf_start = HEADER_SIZE
        scan_bytes = 0
        for chunk_off, chunk in store.scan_sequential():
            if not buf:
                buf_start = chunk_off
            buf += chunk
            scan_bytes += len(chunk)
            # parse complete (len, payload) entries out of buf
            local = pos - buf_start
            while local + 4 <= len(buf):
                (ln,) = struct.unpack_from("<I", buf, local)
                if local + 4 + ln > len(buf):
                    break
                offsets[i] = buf_start + local
                lengths[i] = ln
                i += 1
                local += 4 + ln
            pos = buf_start + local
            buf = buf[local:]
            buf_start = pos
        if i != store.num_records:
            raise ValueError(f"scan found {i} records, header says {store.num_records}")
        table = LocationTable(offsets, lengths, scan_bytes, time.perf_counter() - t0)
        store.install_index(offsets, lengths)
        return table
