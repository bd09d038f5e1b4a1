"""Continuous (in-flight) batching over a fixed slot-based KV arena.

The port of ``repro.serve.engine``: the same scheduler, counters and
modes.  The engine owns ``max_batch`` generation *slots* in one decode
arena allocated exactly once (``init_decode_cache`` at construction —
the ``serve/arena_alloc`` trace instant marks it).  Each step:

1. **Admit** — queued requests whose arrival time has passed take free
   slots (``mode='continuous'``), or — ``mode='static'`` — only when
   *every* slot is free.  Admission prefills the request right-padded to
   ``prompt_capacity`` (batch 1, fixed shape) and copies its KV into the
   slot with :func:`~repro_torch.models.model.write_prefill_slot`.
2. **Decode** — one :func:`~repro_torch.models.model.decode_step` on
   per-row positions over the whole arena; every row appends at its own
   position.
   Finished rows (budget reached / EOS) free their slots immediately.

Requests may carry ``feature_ids``; admission serves them through the
attached :class:`~repro_torch.serve.reuse.RequestStreamCache`
(estimated-reuse tier, host memory) before the prefill.

The arena lives on the parameters' device and is updated in place.  The
host waits on the device at exactly two points, as the JAX engine does:
the first token of an admission (``.item()``) and the step's next tokens
(``.cpu()``).  Beyond the JAX engine's counters, ``prefill_seconds`` and
``decode_seconds`` sum the durations of the ``serve/prefill`` and
``serve/decode`` spans (``trace.timed``: measured always, recorded when
tracing or under a profiler), each ending at its sync, so they are
device-inclusive.  Spans, all of category ``serve``:

* ``serve/step`` — one :meth:`ServeEngine.step`: admit, decode, retire.
* ``serve/admit`` — one admission, from its start (the feature fetch
  included) to the first token on the host; ``args``: ``rid``,
  ``queued_s`` (the clock at admission start less the request's arrival).
* ``serve/prefill`` (in ``serve/admit``) — the prefill, the slot write
  and the first token's sync; ``args``: ``rid``, ``tokens`` (the prompt's
  length), ``padded`` (``prompt_capacity``, what the prefill ran).
* ``serve/decode`` — one decode step over the arena and its tokens' sync.
* ``serve/prefill/sync``, ``serve/decode/sync`` (children) — the
  ``argmax`` and the copy to the host: their parent's time less theirs is
  the host's time to enqueue the work.

A request's first token is stamped from the engine's clock once it is on
the host; ``admitted`` when its admission starts.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as _trace
from repro_torch.serve.request import Completion, Request, StepClock

SERVE_MODES = ("continuous", "static")
# block kinds whose decode state lives entirely in the self-attention KV
# arena; recurrent kinds and local-attention rings would carry padded
# prefill junk into real rows, so the engine refuses them
SERVABLE_KINDS = ("attn", "moe")


@dataclasses.dataclass
class _Slot:
    request: Request
    tokens: List[int]
    admitted: float
    first_token: float


class ServeEngine:
    """Request queue → continuous-batching scheduler → prefill/decode."""

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        max_batch: int,
        prompt_capacity: int,
        max_new_tokens: int,
        mode: str = "continuous",
        feature_cache=None,
        eos_id: Optional[int] = None,
        clock: Optional[StepClock] = None,
    ):
        if mode not in SERVE_MODES:
            raise ValueError(f"mode must be one of {SERVE_MODES}, got {mode!r}")
        for pattern, _ in cfg.stages:
            for kind in pattern:
                if kind not in SERVABLE_KINDS:
                    raise ValueError(
                        f"serving engine supports {SERVABLE_KINDS} blocks; "
                        f"got {kind!r} (recurrent state / local rings would "
                        "carry padded-prefill junk)"
                    )
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.mode = mode
        self.max_batch = int(max_batch)
        self.prompt_capacity = int(prompt_capacity)
        self.max_new_tokens = int(max_new_tokens)
        self.capacity = self.prompt_capacity + self.max_new_tokens
        self.feature_cache = feature_cache
        self.eos_id = eos_id
        self.clock = clock or StepClock()

        # the one arena allocation of the engine's lifetime — decode
        # never reallocates (tests assert exactly one of these instants)
        self.arena = model_lib.init_decode_cache(
            cfg, self.max_batch, self.capacity, self.device,
            pos=torch.zeros((self.max_batch,), dtype=torch.int32),
        )
        arena_bytes = sum(
            x.numel() * x.element_size()
            for x in [self.arena["pos"]]
            + [t for st in self.arena["stages"] for c in st for t in c.values()]
        )
        _trace.instant(
            "serve/arena_alloc", "serve",
            args={"bytes": arena_bytes, "slots": self.max_batch,
                  "capacity": self.capacity},
        )

        self.queue: Deque[Request] = deque()
        self.slots: Dict[int, _Slot] = {}
        self._free: List[int] = list(range(self.max_batch))
        self._cur = np.zeros((self.max_batch, 1), np.int32)
        self.completions: List[Completion] = []
        # counters
        self.steps = 0
        self.decode_steps = 0
        self.prefills = 0
        self.generated_tokens = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------- queue
    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active(self) -> int:
        return len(self.slots)

    def submit(self, request: Request) -> None:
        if len(request.prompt) > self.prompt_capacity:
            raise ValueError(
                f"prompt of {len(request.prompt)} exceeds prompt_capacity "
                f"{self.prompt_capacity}"
            )
        if request.max_new_tokens > self.max_new_tokens:
            raise ValueError(
                f"max_new_tokens {request.max_new_tokens} exceeds the "
                f"engine's generation arena {self.max_new_tokens}"
            )
        self.queue.append(request)

    # ------------------------------------------------------------ device
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        # non_blocking: CUDA copies pageable memory to a staging buffer
        # before returning, and a blocking copy would add a stream sync to
        # every upload
        return torch.as_tensor(a).to(self.device, non_blocking=True)

    def _prefill(self, padded: np.ndarray, length: int):
        """Batch-1 prefill of one padded prompt: (cache, logits)."""
        return model_lib.prefill_at(
            self.cfg, self.params, self._tensor(padded),
            self._tensor(np.asarray([length], np.int32)),
        )

    def _decode(self) -> torch.Tensor:
        """One decode step over the whole arena; returns the logits."""
        self.arena, logits = model_lib.decode_step(
            self.cfg, self.params, self.arena, self._tensor(self._cur)
        )
        return logits

    # --------------------------------------------------------- admission
    def _arrived(self) -> bool:
        return bool(self.queue) and self.queue[0].arrival <= self.clock.now()

    def _admit_one(self, req: Request, slot: int) -> None:
        now = self.clock.now()
        on = _trace.enabled()
        admit_args = {"rid": req.rid, "queued_s": now - req.arrival} if on else None
        prefill_args = ({"rid": req.rid, "tokens": len(req.prompt),
                         "padded": self.prompt_capacity} if on else None)
        with _trace.span("serve/admit", "serve", args=admit_args):
            if self.feature_cache is not None and req.feature_ids is not None:
                self.feature_cache.fetch(req.feature_ids, now)
            padded = np.zeros((1, self.prompt_capacity), np.int32)
            padded[0, : len(req.prompt)] = req.prompt
            with _trace.timed("serve/prefill", "serve", args=prefill_args) as sp:
                pre, logits = self._prefill(padded, len(req.prompt))
                self.arena = model_lib.write_prefill_slot(self.cfg, self.arena, slot, pre)
                with _trace.span("serve/prefill/sync", "serve"):
                    first = int(torch.argmax(logits[0], -1).item())
            self.prefill_seconds += sp.duration_s
        first_token = self.clock.now()
        self._cur[slot, 0] = first
        self.slots[slot] = _Slot(
            request=req, tokens=[first], admitted=now, first_token=first_token
        )
        self.prefills += 1
        self.generated_tokens += 1
        if self._finished(self.slots[slot]):
            self._retire(slot, first_token)

    def _admit(self) -> int:
        admitted = 0
        if self.mode == "continuous":
            while self._free and self._arrived():
                self._admit_one(self.queue.popleft(), self._free.pop())
                admitted += 1
        else:  # static: refill only at a whole-batch boundary
            if not self.slots:
                while self._free and self._arrived():
                    self._admit_one(self.queue.popleft(), self._free.pop())
                    admitted += 1
        return admitted

    # ------------------------------------------------------- decode step
    def _finished(self, s: _Slot) -> bool:
        if len(s.tokens) >= s.request.max_new_tokens:
            return True
        return self.eos_id is not None and s.tokens[-1] == self.eos_id

    def _retire(self, slot: int, finished: float) -> None:
        s = self.slots.pop(slot)
        self._free.append(slot)
        self.completions.append(
            Completion(
                rid=s.request.rid,
                tokens=s.tokens,
                arrival=s.request.arrival,
                first_token=s.first_token,
                finished=finished,
            )
        )

    def step(self) -> None:
        """One engine step: admit, decode the whole arena once, retire."""
        with _trace.span("serve/step", "serve"):
            self._admit()
            if self.slots:
                with _trace.timed("serve/decode", "serve") as sp:
                    logits = self._decode()
                    with _trace.span("serve/decode/sync", "serve"):
                        nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy().reshape(-1)
                self.decode_seconds += sp.duration_s
                self.decode_steps += 1
                self.clock.advance(1.0)
                done = self.clock.now()
                for slot in list(self.slots):
                    tok = int(nxt[slot])
                    self._cur[slot, 0] = tok
                    s = self.slots[slot]
                    s.tokens.append(tok)
                    self.generated_tokens += 1
                    if self._finished(s):
                        self._retire(slot, done)
            else:
                self.clock.advance(1.0)
            self.steps += 1

    def warmup(self) -> None:
        """Run the prefill/slot-insert/decode path once before measured
        steps (the JAX engine compiles here; the port loads and builds its
        kernels).  The junk KV this writes into slot 0 is overwritten at
        its next admission before any decode attends it."""
        pre, plog = self._prefill(np.zeros((1, self.prompt_capacity), np.int32), 1)
        torch.argmax(plog[0], -1).item()
        self.arena = model_lib.write_prefill_slot(self.cfg, self.arena, 0, pre)
        torch.argmax(self._decode(), -1).cpu()
        self.arena["pos"] = torch.zeros(
            (self.max_batch,), dtype=torch.int32, device=self.device
        )

    # --------------------------------------------------------------- run
    def run(self, requests=None) -> List[Completion]:
        """Drive the engine until queue and slots drain; returns all
        completions (arrival order is whatever ``requests`` carries)."""
        if requests is not None:
            for r in sorted(requests, key=lambda r: r.arrival):
                self.submit(r)
        while self.queue or self.slots:
            if not self.slots and self.queue:
                gap = self.queue[0].arrival - self.clock.now()
                if gap > 0:  # idle: jump to the next arrival
                    self.clock.advance(gap)
            self.step()
        return self.completions
