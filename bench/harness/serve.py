"""The ``serve`` generator: requests arriving in an open loop at the mix's
fixed rate, served by the port's continuous-batching ``ServeEngine``.

Every seed gets the same number of requests in the window and the same
set of gaps between them (the exponential distribution's quantiles at the
rate), the same set of prompt lengths (the lognormal's quantiles, clipped)
and of generation lengths (evenly over the range); the seed draws the order
of each, independently, and the prompt tokens.  So the seed changes when the
bursts come and which request is long, not how much work there is.  The
engine's clock is the wall clock from the window's start, and a request is
submitted when it is due.  Its time to first token runs from when it was
due to when its admission has the first token on the host.  Requests due in the window and
not yet served when it closes are served after it, for as long as the mix's
``drain_seconds``; their wait counts, and one never served counts as a
miss.

After the window the program is freed; the configuration's reference runs
a sample of the finished requests, drawn from the seed and holding the
longest, over each prompt with its served tokens, and the widest gap by
which a served token's logit lies below the reference's best is compared
with the cell's limit.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from harness import common, flops, profile, spec, weights

GIB = 2 ** 30


class WallClock:
    """The engine's clock: seconds since ``start()``; steps do not move it."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def advance(self, dt: float = 1.0) -> None:
        pass


def schedule(mix: Dict, seed: int, seconds: float, vocab: int) -> List[Dict]:
    """The requests due in ``[0, seconds)``: ``rid``, ``due``, ``prompt``
    (int32 ids from 1), ``gen``.  There are ``rate × seconds`` of them
    (rounded down), and their gaps sum to less than ``seconds``: the
    midpoint quantiles of the exponential fall short of its mean."""
    rate = mix["rate_per_s"]
    n = max(1, int(rate * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    pl = mix["prompt_len"]
    z = np.array([statistics.NormalDist().inv_cdf(x) for x in q])
    plen = np.clip(np.round(pl["median"] * np.exp(pl["sigma"] * z)), pl["min"], pl["max"])
    gl = mix["gen_len"]
    glen = gl["min"] + (np.arange(n) * (gl["max"] - gl["min"] + 1)) // n
    due = np.cumsum(np.random.default_rng([int(seed), 0xA7]).permutation(gaps))
    rng = np.random.default_rng([int(seed), 0x5E])
    plen, glen = rng.permutation(plen).astype(int), rng.permutation(glen).astype(int)
    out = []
    for i in range(n):
        if due[i] >= seconds:
            break
        out.append({"rid": i, "due": float(due[i]), "gen": int(glen[i]),
                    "prompt": rng.integers(1, vocab, size=int(plen[i])).astype(np.int32)})
    return out


def _port_params(cfg, conf: Dict, seed: int, device, ref):
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_map

    shapes = M.init_params(cfg, None, torch.device("meta"))
    params = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device=device), shapes)
    weights.fill_port(ref, conf, seed, params)
    return params


class Recorder:
    """When each request's first token reached the host, and the work the
    requests asked for, with whether the trace was on: a prefill for each
    admitted request at its prompt's own length, and for each decode step
    the positions each decoded row attends.

    The engine stamps a request's first token when its admission starts,
    before the prefill, so the one hook into the engine wraps its admission
    (``_admit_one``) to read the clock when the token is on the host.  The
    decode steps are read from the engine's public state after each
    ``step``: the rows still in ``slots`` and those it retired into
    ``completions`` during the step."""

    def __init__(self, engine, clock: WallClock, reqs: List[Dict]):
        self.engine = engine
        self.prompt_len = {r["rid"]: len(r["prompt"]) for r in reqs}
        self.first: Dict[int, float] = {}
        self.admitted: List = []  # (rid, traced)
        self.decodes: List = []  # (positions attended by each row, traced)
        self.traced = None
        admit = engine._admit_one

        def admit_one(req, slot):
            admit(req, slot)
            self.first[req.rid] = clock.now()
            self.admitted.append((req.rid, self._on()))

        engine._admit_one = admit_one

    def _on(self) -> bool:
        return self.traced is not None and self.traced.active

    def step(self) -> None:
        """One ``engine.step()``, and the decode step it made, if any: a row
        holding ``t`` tokens after the step attended ``prompt + t - 1``
        positions (a request retired at admission never decoded)."""
        e, on = self.engine, self._on()
        steps, done = e.decode_steps, len(e.completions)
        e.step()
        if e.decode_steps == steps:
            return
        rows = [(s.request.rid, len(s.tokens)) for s in e.slots.values()]
        rows += [(c.rid, len(c.tokens)) for c in e.completions[done:] if len(c.tokens) > 1]
        self.decodes.append(([self.prompt_len[rid] + t - 1 for rid, t in rows], on))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        check: bool = True) -> Dict:
    """One run; ``check=False`` (the knee sweep) skips the reference."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.request import Request

    t_setup = time.perf_counter()
    phases = common.Phases()
    mix, conf = cell.mix, cell.config
    cfg = spec.port_config(conf, ref=cell.reference)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    params = _port_params(cfg, conf, seed, device, cell.reference)
    phases.mark("weights")
    clock = WallClock()
    engine = ServeEngine(cfg, params, max_batch=mix["max_batch"],
                         prompt_capacity=mix["prompt_capacity"],
                         max_new_tokens=mix["max_new_tokens"], clock=clock)
    phases.mark("engine")
    engine.warmup()  # one prefill at capacity and one decode step
    phases.mark("warmup")
    reqs = schedule(mix, seed, seconds, conf["vocab_size"])
    rec = Recorder(engine, clock, reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.mark("schedule")
    setup_s = time.perf_counter() - t_setup

    c0 = (engine.prefills, engine.prefill_seconds, engine.decode_steps, engine.decode_seconds)
    nxt = 0

    def submit_due(now):
        nonlocal nxt
        while nxt < len(reqs) and reqs[nxt]["due"] <= now:
            r = reqs[nxt]
            engine.submit(Request(rid=r["rid"], prompt=r["prompt"], max_new_tokens=r["gen"],
                                  arrival=r["due"]))
            nxt += 1

    with profile.Traced(trace, mix["trace_seconds"]) as traced:
        rec.traced = traced
        clock.start()
        while True:
            now = clock.now()
            if now >= seconds:
                break
            if traced.due():
                traced.pause()
            submit_due(now)
            if engine.queue or engine.slots:
                rec.step()
            else:
                wait = (reqs[nxt]["due"] if nxt < len(reqs) else seconds) - now
                time.sleep(max(0.0, min(wait, seconds - now)))
        window_s = clock.now()
        traced.pause()
    counters = [b - a for a, b in zip(c0, (engine.prefills, engine.prefill_seconds,
                                           engine.decode_steps, engine.decode_seconds))]
    in_window = ([(rec.prompt_len[rid], on) for rid, on in rec.admitted], list(rec.decodes))
    waiting_at_close = len(reqs) - len(rec.first)
    # serve what was due in the window and is still waiting, then finish
    deadline = time.perf_counter() + mix["drain_seconds"]
    submit_due(seconds)
    while (engine.queue or engine.slots) and time.perf_counter() < deadline:
        rec.step()
    ttft = [1e3 * (rec.first[r["rid"]] - r["due"]) if r["rid"] in rec.first else math.inf
            for r in reqs]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    done = {c.rid: c.tokens for c in engine.completions}
    run_info = {
        "kind": "serve", "config": conf, "mix": mix, "window_s": window_s,
        "prefill_lengths": [n for n, _ in in_window[0]],
        "decode_rows": [rows for rows, _ in in_window[1]],
        "traced_prefills": [n for n, on in in_window[0] if on],
        "traced_decodes": [rows for rows, on in in_window[1] if on],
        "prefills": counters[0], "prefill_s": counters[1],
        "decode_steps": counters[2], "decode_s": counters[3],
        "trace": traced.events() if trace else None,
    }
    del engine, rec, params, traced
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    checks = _check(cell, seed, device, reqs, done) if check else []
    return {
        "setup_s": setup_s, "attempted": len(reqs),
        "failed": sum(1 for t in ttft if math.isinf(t)),
        "end_to_end": {"ttft_ms_p90": common.nearest_rank(ttft, 90) if ttft else math.inf,
                       "peak_mem_gib": peak / GIB},
        "memory_peak_bytes": peak, "run": run_info, "checks": checks,
        "setup_phases": phases.seconds,
        "requests": reqs, "served": done, "ttft_ms": ttft, "waiting_at_close": waiting_at_close,
    }


def sample(reqs: List[Dict], done: Dict[int, List[int]], seed: int, tokens: int) -> List[int]:
    """Finished requests to check: the longest, then others in an order
    drawn from the seed, until they hold ``tokens`` served tokens."""
    ids = [r["rid"] for r in reqs if r["rid"] in done]
    if not ids:
        return []
    size = {r["rid"]: len(r["prompt"]) + len(done[r["rid"]]) for r in reqs if r["rid"] in done}
    longest = max(ids, key=lambda i: size[i])
    rest = [i for i in np.random.default_rng([int(seed), 0x5A]).permutation(ids) if i != longest]
    out, served = [longest], len(done[longest])
    for i in rest:
        if served >= tokens:
            break
        out.append(int(i))
        served += len(done[i])
    return out


def widest_gap(cell, seed: int, device, reqs, done, precision: str = "") -> float:
    """The widest gap, over the sampled requests' served positions, between
    the reference's best logit and its logit of the token served; with a
    ``precision``, of the token that reference in that precision (the
    control) puts first instead."""
    conf, lm = cell.config, cell.reference
    by_rid = {r["rid"]: r for r in reqs}
    lm.full_f32()
    ref = lm.Ref(conf)
    control = lm.Ref(conf, precision) if precision else None
    W = weights.make(lm, conf, seed, device)
    widest = 0.0
    for rid in sample(reqs, done, seed, cell.mix["sample_served_tokens"]):
        prompt = torch.from_numpy(by_rid[rid]["prompt"]).to(device).long()
        toks = torch.tensor(done[rid], dtype=torch.int64, device=device)
        widest = max(widest, float(lm.served_gaps(ref, W, prompt, toks, control).max()))
    del W
    return widest


def _check(cell, seed, device, reqs, done) -> List[Dict]:
    unserved = float(sum(1 for r in reqs if r["rid"] not in done))
    return [common.check("served_logit_gap", widest_gap(cell, seed, device, reqs, done),
                         cell.limits["served_logit_gap"]),
            common.check("requests_never_finished", unserved, 0.0)]
