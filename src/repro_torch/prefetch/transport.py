"""Peer transports for the cross-host record tier (the port's copy of
``repro.prefetch.transport``: host code, same wire format).

Two implementations of one contract — ``fetch(peer, ids)`` returns
``(found, payload, offsets, lengths)`` exactly as
:meth:`repro_torch.prefetch.cache.TieredCache.export_records` does on the
serving side:

* :class:`LocalTransport` — in-process: peers are ``TieredCache``
  objects in a shared registry, a fetch is one locked arena copy.  This
  is the multi-host *data plane* run inside one process (threads or
  lockstep loops): byte-exact, deterministic, no sockets — what the
  byte-identity tests and the aggregate-read benchmark drive.
* :class:`TCPTransport` / :class:`PeerServer` — a real socket path with
  the same framing a multi-node deployment would use, for when hosts
  are actual processes (``launch/mesh.py``'s CPU process mesh).  One
  persistent connection per peer, length-prefixed binary frames,
  vectorized numpy (de)serialization — no pickling, no per-record
  Python.

Both transports also carry ``push(peer, ids, payload, offsets,
lengths, next_use)`` — the consumer-side retention handoff: the host
that just consumed a record ships its bytes (with the record's
next-epoch Belady priority) to the placement-predicted next holder,
which banks them in its fetcher's push inbox and drains into its cache
between batches.

Wire format (little-endian), one frame each way per operation:

    fetch request:  u8 op=0 | u32 n | n × i64 record ids
    fetch response: u32 n | n × u8 found mask | u64 payload_bytes
                    | f × i64 lengths (f = found count) | payload bytes
    push request :  u8 op=1 | u32 n | n × i64 record ids
                    | n × i64 next_use | u64 payload_bytes
                    | n × i64 lengths | payload bytes
    push response:  u64 accepted count

Offsets are reconstructed by cumsum on the receiver — they are
redundant on the wire.  Failures (connect refused, short frame, peer
gone) raise ``OSError`` and are the
:class:`~repro_torch.prefetch.distributed.RemoteFetcher`'s problem: fetches
retry under the :class:`~repro_torch.storage.faults.RetryPolicy` and
fall back to storage; a lost push costs its receiver one storage read
next epoch — so a dead peer degrades throughput, never correctness.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs import trace as _trace

FetchResult = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]

_REQ_HDR = struct.Struct("<BI")   # op, record count
_RSP_HDR = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_OP_FETCH = 0
_OP_PUSH = 1


def _empty_result(n: int) -> FetchResult:
    return (
        np.zeros(n, bool),
        np.empty(0, np.uint8),
        np.empty(0, np.int64),
        np.empty(0, np.int64),
    )


class LocalTransport:
    """In-process peer fetches against a shared ``{host_id: TieredCache}``
    registry.  ``register`` is called by ``make_cluster`` as nodes come
    up; fetching from an unknown/closed peer raises ``OSError`` like a
    refused connection would, exercising the retry/fallback path."""

    def __init__(self):
        self._peers: Dict[int, object] = {}
        self._inboxes: Dict[int, object] = {}
        self._lock = threading.Lock()
        # fault hook for tests: host ids whose fetches currently fail
        self.down: set = set()

    def register(self, host_id: int, cache) -> None:
        with self._lock:
            self._peers[int(host_id)] = cache

    def register_inbox(self, host_id: int, fn) -> None:
        """Install a host's push inbox: ``fn(ids, payload, offsets,
        lengths, next_use) -> accepted`` (the fetcher's
        ``_inbox_put``)."""
        with self._lock:
            self._inboxes[int(host_id)] = fn

    def unregister(self, host_id: int) -> None:
        with self._lock:
            self._peers.pop(int(host_id), None)
            self._inboxes.pop(int(host_id), None)

    def fetch(self, peer: int, ids: np.ndarray) -> FetchResult:
        if peer in self.down:
            raise OSError(f"peer {peer} unreachable (injected)")
        with self._lock:
            cache = self._peers.get(int(peer))
        if cache is None:
            raise OSError(f"peer {peer} not registered")
        with _trace.span(
            "remote/serve",
            "remote",
            args={"peer": int(peer), "records": len(ids)}
            if _trace.enabled()
            else None,
        ):
            return cache.export_records(ids, release=True)

    def push(
        self, peer: int, ids, payload, offsets, lengths, next_use
    ) -> int:
        """Hand just-consumed records to their predicted next holder;
        returns how many the receiver banked.  The caller owns
        ``payload`` handoff — pass a freshly copied arena, never a view
        of a reusable serve buffer."""
        if peer in self.down:
            raise OSError(f"peer {peer} unreachable (injected)")
        with self._lock:
            fn = self._inboxes.get(int(peer))
        if fn is None:
            raise OSError(f"peer {peer} has no push inbox")
        with _trace.span(
            "remote/push",
            "remote",
            args={"peer": int(peer), "records": len(ids)}
            if _trace.enabled()
            else None,
        ):
            return int(fn(ids, payload, offsets, lengths, next_use))

    def close(self) -> None:
        with self._lock:
            self._peers.clear()
            self._inboxes.clear()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise OSError("peer closed connection mid-frame")
        got += k
    return bytes(buf)


class PeerServer:
    """Serves one host's ``TieredCache`` to peers over TCP.

    One accept thread, one thread per connection (peer count is small
    and connections are persistent).  Binds ``host:port`` (port 0 = OS
    pick, read back from ``.address``)."""

    def __init__(self, cache, host: str = "127.0.0.1", port: int = 0):
        self.cache = cache
        # push inbox: set to the local fetcher's ``_inbox_put`` once it
        # exists; until then incoming pushes insert straight into the
        # cache (admission-filtered — a declined early push costs one
        # storage read, never correctness)
        self.inbox = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address = self._sock.getsockname()
        self._closing = threading.Event()
        self._threads = []
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket):
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            while not self._closing.is_set():
                hdr = conn.recv(_REQ_HDR.size, socket.MSG_WAITALL)
                if len(hdr) < _REQ_HDR.size:
                    return
                op, n = _REQ_HDR.unpack(hdr)
                if op == _OP_PUSH:
                    ids = np.frombuffer(
                        _recv_exact(conn, 8 * n), "<i8"
                    ).astype(np.int64)
                    next_use = np.frombuffer(
                        _recv_exact(conn, 8 * n), "<i8"
                    ).astype(np.int64)
                    (pb,) = _U64.unpack(_recv_exact(conn, _U64.size))
                    lens = np.frombuffer(
                        _recv_exact(conn, 8 * n), "<i8"
                    ).astype(np.int64)
                    payload = np.frombuffer(_recv_exact(conn, pb), np.uint8)
                    payload = payload.copy()
                    offsets = np.concatenate(
                        ([0], np.cumsum(lens[:-1]))
                    ).astype(np.int64) if n else np.empty(0, np.int64)
                    with _trace.span(
                        "remote/push",
                        "remote",
                        args={"records": int(n)}
                        if _trace.enabled()
                        else None,
                    ):
                        if self.inbox is not None:
                            accepted = int(
                                self.inbox(
                                    ids, payload, offsets, lens, next_use
                                )
                            )
                        else:
                            accepted = int(
                                self.cache.insert(
                                    ids,
                                    payload,
                                    offsets,
                                    next_use=next_use,
                                    filtered=True,
                                )
                            )
                    conn.sendall(_U64.pack(accepted))
                    continue
                ids = np.frombuffer(_recv_exact(conn, 8 * n), "<i8")
                with _trace.span(
                    "remote/serve",
                    "remote",
                    args={"records": int(n)} if _trace.enabled() else None,
                ):
                    found, payload, _, lens = self.cache.export_records(
                        ids, release=True
                    )
                    frame = b"".join(
                        (
                            _RSP_HDR.pack(n),
                            found.astype(np.uint8).tobytes(),
                            _U64.pack(payload.nbytes),
                            lens.astype("<i8").tobytes(),
                            payload.tobytes(),
                        )
                    )
                    conn.sendall(frame)
        except OSError:
            return
        finally:
            conn.close()

    def close(self):
        self._closing.set()
        try:
            self._sock.close()
        except OSError:
            pass


class TCPTransport:
    """Socket transport: one persistent connection per peer, lazily
    opened, serialized per-peer by a lock (the RemoteFetcher groups a
    batch's records by peer, so a fetch is one frame exchange).  A
    connection error closes that peer's socket so the next attempt — the
    retry layer's — reconnects fresh."""

    def __init__(self, addresses: Dict[int, tuple], timeout_s: Optional[float] = 10.0):
        self.addresses = {int(k): tuple(v) for k, v in addresses.items()}
        self.timeout_s = timeout_s
        self._conns: Dict[int, socket.socket] = {}
        self._locks: Dict[int, threading.Lock] = {
            h: threading.Lock() for h in self.addresses
        }

    def _conn(self, peer: int) -> socket.socket:
        sock = self._conns.get(peer)
        if sock is None:
            sock = socket.create_connection(
                self.addresses[peer], timeout=self.timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._conns[peer] = sock
        return sock

    def fetch(self, peer: int, ids: np.ndarray) -> FetchResult:
        peer = int(peer)
        if peer not in self.addresses:
            raise OSError(f"peer {peer} has no address")
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        if n == 0:
            return _empty_result(0)
        with self._locks[peer]:
            try:
                sock = self._conn(peer)
                sock.sendall(
                    _REQ_HDR.pack(_OP_FETCH, n) + ids.astype("<i8").tobytes()
                )
                (rn,) = _RSP_HDR.unpack(_recv_exact(sock, _RSP_HDR.size))
                if rn != n:
                    raise OSError(f"peer {peer} answered {rn} ids for {n}")
                found = np.frombuffer(_recv_exact(sock, n), np.uint8).astype(bool)
                (pb,) = _U64.unpack(_recv_exact(sock, _U64.size))
                f = int(found.sum())
                lens = np.frombuffer(_recv_exact(sock, 8 * f), "<i8").astype(
                    np.int64
                )
                payload = np.frombuffer(_recv_exact(sock, pb), np.uint8).copy()
                if int(lens.sum()) != pb:
                    raise OSError(f"peer {peer} framing mismatch")
            except OSError:
                self._drop(peer)
                raise
        offsets = np.concatenate(([0], np.cumsum(lens[:-1]))).astype(np.int64)
        if f == 0:
            offsets = np.empty(0, np.int64)
        return found, payload, offsets, lens

    def push(
        self, peer: int, ids, payload, offsets, lengths, next_use
    ) -> int:
        peer = int(peer)
        if peer not in self.addresses:
            raise OSError(f"peer {peer} has no address")
        ids = np.asarray(ids, np.int64)
        n = len(ids)
        if n == 0:
            return 0
        lengths = np.asarray(lengths, np.int64)
        offsets = np.asarray(offsets, np.int64)
        # repack into a contiguous arena in id order for the wire
        payload = np.asarray(payload, np.uint8)
        parts = [
            payload[offsets[i] : offsets[i] + lengths[i]] for i in range(n)
        ]
        body = (
            np.concatenate(parts) if parts else np.empty(0, np.uint8)
        )
        frame = b"".join(
            (
                _REQ_HDR.pack(_OP_PUSH, n),
                ids.astype("<i8").tobytes(),
                np.asarray(next_use, np.int64).astype("<i8").tobytes(),
                _U64.pack(body.nbytes),
                lengths.astype("<i8").tobytes(),
                body.tobytes(),
            )
        )
        with self._locks[peer]:
            try:
                sock = self._conn(peer)
                sock.sendall(frame)
                (accepted,) = _U64.unpack(_recv_exact(sock, _U64.size))
            except OSError:
                self._drop(peer)
                raise
        return int(accepted)

    def _drop(self, peer: int):
        sock = self._conns.pop(peer, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def close(self):
        for peer in list(self._conns):
            self._drop(peer)
