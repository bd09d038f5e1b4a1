"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory with exponential gating, sequential), the port of
``repro.layers.xlstm``.

mLSTM recurrence (per head, scalar gates i_t, f_t):
    m_t = max(log f_t + m_{t-1}, log i_t)                    (stabilizer)
    C_t = exp(log f_t + m_{t-1} - m_t) C_{t-1} + exp(log i_t - m_t) k_t v_tᵀ
    n_t = exp(log f_t + m_{t-1} - m_t) n_{t-1} + exp(log i_t - m_t) k_t
    h_t = C_tᵀ q_t / max(|n_tᵀ q_t|, 1)

Training and prefill run the chunkwise-parallel form (intra-chunk
quadratic, inter-chunk recurrence over chunk summaries), a Python loop
over the chunks where JAX runs ``lax.scan``; decode is the recurrent step.
The sLSTM is a loop over time, in f32 in every compute dtype, as
``_SLSTMScan``: an autograd function whose backward runs the
recurrence's gradient in reverse time from the gate pre-activations and
states the forward saved, so it recomputes no product.  The stabilisers
start at ``SENTINEL`` and stay f32.  There is no kernel here: the JAX
package computes both recurrences in plain XLA.

The mLSTM's q/k/v is in (B, H, S, hd) layout, the sLSTM's state in
(H, B, hd) inside the scan; both take and return JAX's layouts.  With
``ckpt`` (``remat="dots"``) the chunks' stabilisers and their
normalisation are remat segments (``common.segment``) between the
products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from repro_torch.layers.common import (cast, dense_init, flatten, replicate_dims, segment,
                                      unflatten)

SENTINEL = -1e30  # the stabilisers' start (m), f32 everywhere


def mlstm_width(d_model: int, proj_factor: float) -> int:
    """The mLSTM's up-projected width: ``d_model * proj_factor`` rounded up
    to a multiple of 128."""
    dp = int(d_model * proj_factor)
    return ((dp + 127) // 128) * 128


# ---------------------------------------------------------------- mLSTM


def init_mlstm(generator, d_model: int, num_heads: int, proj_factor: float, dtype, device):
    """As JAX's ``init_mlstm``; ``wq``/``wk``/``wv`` are (H, hd, hd), so
    ``dense_init``'s fan-in is H, as there."""
    dp = mlstm_width(d_model, proj_factor)
    hd = dp // num_heads

    def dense(shape, scale=None):
        return dense_init(shape, dtype, generator, device, scale=scale)

    return {
        "w_up": dense((d_model, dp)),
        "w_gate_up": dense((d_model, dp)),
        # block-diagonal q/k/v over heads, as in the official xLSTM blocks
        "wq": dense((num_heads, hd, hd)),
        "wk": dense((num_heads, hd, hd)),
        "wv": dense((num_heads, hd, hd)),
        "w_if": dense((d_model, 2 * num_heads), scale=0.02),
        "b_if": torch.cat([torch.zeros((num_heads,), device=device),
                           torch.full((num_heads,), 3.0, device=device)]).to(dtype),
        "w_down": dense((dp, d_model)),
        "skip": torch.ones((dp,), dtype=dtype, device=device),  # learnable per-channel skip
    }


def _mlstm_qkv(params, x, num_heads: int, dtype):
    """u and the output gate (B,S,dp); q, k, v (B,H,S,hd); the log input
    and forget gates (B,H,S) in f32.  On DTensors the up-projections'
    partial sums are reduced where they are made, as JAX lays the block
    out (no split over ``model``): reduced where a nonlinearity reads them,
    they went onto a split of S beside B's (the 3-dim mesh), a strided
    split that DTensor's planner takes minutes to lay out."""
    u, g, gi = (replicate_dims(x @ cast(params[w], dtype), 1, 2)
                for w in ("w_up", "w_gate_up", "w_if"))
    gate = F.silu(g)
    b, s, dp = u.shape
    hd = dp // num_heads
    uh = unflatten(u, -1, (num_heads, hd))
    q, k, v = (torch.einsum("bshd,hde->bhse", uh, cast(params[w], dtype))
               for w in ("wq", "wk", "wv"))
    # JAX divides by sqrt(hd) rounded to the compute dtype
    k = k / float(torch.tensor(float(hd)).sqrt().to(dtype))
    gates = (gi + params["b_if"]).float().transpose(1, 2)
    log_i, log_f = gates[:, :num_heads], _log_sigmoid(gates[:, num_heads:])
    return u, gate, q, k, v, log_i, log_f


def _log_sigmoid(x):
    """``log σ(x)`` as JAX's ``-softplus(-x)``, ``-logaddexp(0, -x)`` (which
    DTensor also shards, unlike ``log_sigmoid``'s backward)."""
    return -torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device), -x)


def _empty_mlstm_state(x, num_heads: int, hd: int):
    b = x.shape[0]
    return (x.new_zeros((b, num_heads, hd, hd), dtype=torch.float32),
            x.new_zeros((b, num_heads, hd), dtype=torch.float32),
            x.new_full((b, num_heads), SENTINEL, dtype=torch.float32))


def _stabilisers(li, lfc, w_key, m_key, m_prev, m_next, causal, dtype):
    """Every chunk's log-space weights at once.  li, lfc, w_key: (B,H,nc,c)
    log input gates, in-chunk cumulative log forget gates and each key's
    log-weight into the next state; m_key (B,H,nc) its max; m_prev, m_next
    (B,H,nc) the state's stabiliser before and after each chunk.  Returns
    the intra-chunk weights (B,H,nc,c,c) in ``dtype``, the state path's
    weight a query (B,H,nc,c), each key's weight into the next state
    (B,H,nc,c) and the state's decay (B,H,nc)."""
    # weight of key s at query t (s <= t)
    logits = lfc[..., :, None] - lfc[..., None, :] + li[..., None, :]
    logits = torch.where(causal, logits, SENTINEL)
    state_logit = lfc + m_prev[..., None]
    m_row = torch.maximum(torch.amax(logits, dim=-1), state_logit)
    intra_w = torch.exp(logits - m_row[..., None]).to(dtype)
    state_w = torch.exp(state_logit - m_row)
    key_w = torch.exp(m_key - m_next)[..., None] * torch.exp(w_key - m_key[..., None])
    decay = torch.exp(lfc[..., -1] + m_prev - m_next)
    return intra_w, state_w, key_w, decay


def _normalise(intra, n_intra, q_state, qn_state, state_w, dtype):
    """h = (intra + state path) / max(|den|, 1), in f32, returned in
    ``dtype``."""
    num = intra.float() + q_state * state_w[..., None]
    den = n_intra.float() + qn_state * state_w
    one = torch.ones((), dtype=den.dtype, device=den.device)
    return (num / torch.maximum(den.abs(), one)[..., None]).to(dtype)


def _rows_layout(mesh, *ts):
    """Every operand and output split by its rows (dim 0, the batch) over
    the data dims, the rest whole: each (row, head, chunk) is independent."""
    pl = ops._kernel_placements(mesh, ts[0].shape[0], None, ())
    return (pl,) * 4, (pl,) * len(ts), None, ts


@ops.local_shards(_rows_layout)
def _chunk_products(q, k, v, intra_w, key_w):
    """Every chunk's products at once, on each rank's rows for DTensors
    (DTensor's own propagation split the flattened (B, H, chunk) dim of
    their backward over ``model`` too, where the batch cannot take it):
    the scores times the intra weights ``p`` (B,H,nc,t,s), ``p @ v``, and
    each chunk's state update ``kv`` and normaliser update ``kn`` in f32."""
    p = (q @ k.transpose(-1, -2)) * intra_w  # scores x intra weights, (B,H,nc,t,s)
    intra = p @ v
    kf = k.float()
    kv = (kf * key_w[..., None]).transpose(-1, -2) @ v.float()  # each chunk's state update
    kn = (key_w[..., None, :] @ kf)[..., 0, :]
    return p, intra, kv, kn


def mlstm_chunkwise(params, x: torch.Tensor, num_heads: int, chunk: int, dtype, state=None,
                    ckpt: bool = False):
    """x: (B,S,d).  Returns (y, state), state = (C (B,H,hd,hd), n (B,H,hd),
    m (B,H)) in f32.  The chunk is ``min(chunk, S)`` and must divide S.

    JAX's ``lax.scan`` over the chunks carries (C, n, m).  Here what does
    not need the carry runs for every chunk at once (the weights, the
    intra-chunk products, each chunk's contribution to the next state);
    Python loops carry m (tiny) and then C and n, reading the state path
    of each chunk's queries on the way, so each element is computed as in
    the scan.  JAX's ``unroll`` flag (an unrolled scan for dry-run cost
    accounting) has no counterpart."""
    b, s, _ = x.shape
    u, gate, q, k, v, log_i, log_f = _mlstm_qkv(params, x, num_heads, dtype)
    hd = q.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the mLSTM chunk {c}")
    nc = s // c
    q, k, v = (unflatten(t, 2, (nc, c)) for t in (q, k, v))
    li = unflatten(log_i, 2, (nc, c))
    lfc = torch.cumsum(unflatten(log_f, 2, (nc, c)), dim=-1)  # F_t within chunk, with f_t
    C, n, m = _empty_mlstm_state(x, num_heads, hd) if state is None else state
    lft = lfc[..., -1]
    w_key = lft[..., None] + li - lfc  # log-weight of key s into the next state
    m_key = torch.amax(w_key, dim=-1)
    ms = [m]
    for ci in range(nc):
        ms.append(torch.maximum(lft[..., ci] + ms[-1], m_key[..., ci]))
    m_prev, m_next = torch.stack(ms[:-1], dim=-1), torch.stack(ms[1:], dim=-1)
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    intra_w, state_w, key_w, decay = segment(ckpt, _stabilisers, li, lfc, w_key, m_key, m_prev,
                                             m_next, causal, dtype)
    p, intra, kv, kn = _chunk_products(q, k, v, intra_w, key_w)
    qf = q.float()
    q_state, qn_state = [], []
    for ci in range(nc):
        q_state.append(qf[:, :, ci] @ C)
        qn_state.append((qf[:, :, ci] @ n[..., None])[..., 0])
        C = decay[..., ci, None, None] * C + kv[:, :, ci]
        n = decay[..., ci, None] * n + kn[:, :, ci]
    h = segment(ckpt, _normalise, intra, p.sum(-1), torch.stack(q_state, dim=2),
                torch.stack(qn_state, dim=2), state_w, dtype)
    h = flatten(flatten(h, 2, 3).transpose(1, 2), 2, 3)
    h = h + u * cast(params["skip"], dtype)
    return (h * gate) @ cast(params["w_down"], dtype), (C, n, ms[-1])


def mlstm_step(params, x: torch.Tensor, state, num_heads: int, dtype):
    """Single-token decode.  x: (B,1,d); state = (C, n, m).  Returns
    (y (B,1,d), new state); the state's tensors are new."""
    b = x.shape[0]
    C, n, m = state
    u, gate, q, k, v, log_i, log_f = _mlstm_qkv(params, x, num_heads, dtype)
    qf, kf, vf = (t[:, :, 0].float() for t in (q, k, v))  # (B,H,hd)
    li, lf = log_i[..., 0], log_f[..., 0]  # (B,H)
    m_next = torch.maximum(lf + m, li)
    fw = torch.exp(lf + m - m_next)[..., None]
    iw = torch.exp(li - m_next)[..., None]
    C = fw[..., None] * C + iw[..., None] * (kf[..., :, None] * vf[..., None, :])
    n = fw * n + iw * kf
    num = (qf[..., None, :] @ C)[..., 0, :]
    den = (qf * n).sum(-1)
    one = torch.ones((), dtype=den.dtype, device=den.device)
    h = flatten((num / torch.maximum(den.abs(), one)[..., None]).to(dtype), 1, 2)[:, None]
    h = h + u * cast(params["skip"], dtype)
    return (h * gate) @ cast(params["w_down"], dtype), (C, n, m_next)


def mlstm_sequential_ref(params, x: torch.Tensor, num_heads: int, dtype):
    """The per-step recurrence from an empty state: the oracle for the
    chunkwise form (tests)."""
    state = _empty_mlstm_state(x, num_heads, params["w_up"].shape[1] // num_heads)
    ys = []
    for t in range(x.shape[1]):
        y, state = mlstm_step(params, x[:, t:t + 1], state, num_heads, dtype)
        ys.append(y)
    return torch.cat(ys, dim=1), state


# ---------------------------------------------------------------- sLSTM


def init_slstm(generator, d_model: int, num_heads: int, dtype, device):
    hd = d_model // num_heads
    return {
        "w_in": dense_init((d_model, 4 * d_model), dtype, generator, device),
        # block-diagonal recurrent weights, one (hd, hd) block per head per gate
        "r": dense_init((4, num_heads, hd, hd), dtype, generator, device, scale=1.0 / hd**0.5),
        "b": torch.zeros((4 * d_model,), dtype=dtype, device=device),
        "w_out": dense_init((d_model, d_model), dtype, generator, device),
    }


def _tie_weight(a, b):
    """d max(a, b) / da: 1 where a > b, 1/2 where a == b (``jnp.maximum``'s
    rule), else 0."""
    return (a > b).float() + 0.5 * (a == b).float()


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over time, in f32.

    pre: (S, H, B, 4*hd) gate pre-activations from the input, gates
    z, i, f, o along the last axis; r2: (H, hd, 4*hd) the recurrent
    weights; c0, n0, m0, h0: (H, B, hd).  Returns the hidden states
    (S, H, B, hd) and the last c, n, m, h.  The forward saves each step's
    gate pre-activations (input plus recurrent product) and the states
    before it; the backward recomputes the gates from them and runs the
    gradient in reverse time, one product a step (the gradient through
    ``h @ r2``), and ``r2``'s gradient as one product over all steps."""

    @staticmethod
    def forward(ctx, pre, r2, c0, n0, m0, h0):
        s, heads, b, _ = pre.shape
        a = torch.empty_like(pre)
        st = pre.new_empty((4, s + 1) + tuple(c0.shape))  # c, n, m, h before and after each step
        for j, x in enumerate((c0, n0, m0, h0)):
            st[j, 0] = x
        cs, ns, ms, hs = st
        for t in range(s):
            torch.baddbmm(pre[t], hs[t], r2, out=a[t])
            z, i, f, o = a[t].unflatten(-1, (4, -1)).unbind(-2)
            u = f + ms[t]
            m = torch.maximum(u, i, out=ms[t + 1])
            i = torch.exp(i - m)
            f = torch.exp(u - m)
            c = torch.addcmul(i * torch.tanh(z), f, cs[t], out=cs[t + 1])
            n = torch.addcmul(i, f, ns[t], out=ns[t + 1])
            torch.div(torch.sigmoid(o) * c, torch.clamp(n, min=1.0), out=hs[t + 1])
        ctx.save_for_backward(a, r2, st)
        # the last states as tensors of their own: a prefill cache keeps them
        return hs[1:], cs[s].clone(), ns[s].clone(), ms[s].clone(), hs[s].clone()

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm, dh):
        a, r2, st = ctx.saved_tensors
        s = a.shape[0]
        cs, ns, ms, hs = st
        # every step's gates and the coefficients of its gradient, at once
        az, ai, af, ao = a.unflatten(-1, (4, -1)).unbind(-2)
        u = af + ms[:-1]
        m, c, n = ms[1:], cs[1:], ns[1:]
        i = torch.exp(ai - m)
        f = torch.exp(u - m)
        z = torch.tanh(az)
        o = torch.sigmoid(ao)
        d = torch.clamp(n, min=1.0)
        k_c = o / d                                           # dh -> dc
        k_n = -(o * c) / (d * d) * _tie_weight(n, 1.0)        # dh -> dn
        k_o = c / d * o * (1.0 - o)                           # dh -> d(o's pre-activation)
        k_z = i * (1.0 - z * z)                               # dc -> d(z's pre-activation)
        w_u = _tie_weight(u, ai)
        w_i = 1.0 - w_u
        da = torch.empty_like(a)
        dz, di_, df_, do = da.unflatten(-1, (4, -1)).unbind(-2)
        r2t = r2.transpose(1, 2)
        dh = dh + dhs[s - 1]
        for t in range(s - 1, -1, -1):
            dct = torch.addcmul(dc, dh, k_c[t])
            dnt = torch.addcmul(dn, dh, k_n[t])
            torch.mul(dh, k_o[t], out=do[t])
            torch.mul(dct, k_z[t], out=dz[t])
            dfi = torch.addcmul(dct * cs[t], dnt, ns[t]) * f[t]  # d f, times f
            dii = torch.addcmul(dnt, dct, z[t]) * i[t]           # d i, times i
            dmt = dm - dii - dfi                                 # d m_t
            du = torch.addcmul(dfi, dmt, w_u[t], out=df_[t])
            torch.addcmul(dii, dmt, w_i[t], out=di_[t])
            dm, dc, dn = du, dct * f[t], dnt * f[t]
            # through the recurrent product, plus the output's own gradient
            dh = torch.bmm(da[t], r2t) if t == 0 else torch.baddbmm(dhs[t - 1], da[t], r2t)
        dr2 = torch.einsum("shbd,shbe->hde", hs[:-1], da)
        return da, dr2, dc, dn, dm, dh


def _scan_layout(mesh, pre, r2, *state):
    """``_SLSTMScan`` on each rank's rows and heads (the batch over the
    data dims, the heads over ``model`` where they divide it): every (row,
    head) runs its own recurrence, and the time loop then dispatches local
    ops, not DTensor ops."""
    from torch.distributed.tensor import Partial, Shard

    b, h = pre.shape[2], pre.shape[1]
    seq = ops._kernel_placements(mesh, b, 1, (h,), batch_dim=2)  # (S, H, B, .)
    st = ops._kernel_placements(mesh, b, 0, (h,), batch_dim=1)   # (H, B, hd)
    w = ops._kernel_placements(mesh, b, 0, (h,), batch_dim=None)  # (H, hd, 4 hd)
    # the weights' gradient on a rank sums its own rows only: partial sums
    # over the mesh dims that split the batch
    dw = tuple(Partial() if s == Shard(1) else p for s, p in zip(st, w))
    return ((seq, st, st, st, st), (seq, w, st, st, st, st), (seq, dw, st, st, st, st),
            (pre, r2, *state))


_scan = ops.local_shards(_scan_layout)(_SLSTMScan.apply)


def slstm_scan(params, x: torch.Tensor, num_heads: int, dtype, state=None):
    """x: (B,S,d) -> (y, state), state = (c, n, m, h), each (B,H,hd) in f32.
    The recurrent weights are cast to f32 and the recurrence runs in f32 in
    every compute dtype.  The input product's partial sums are reduced
    where made, as ``_mlstm_qkv``'s."""
    b, s, d = x.shape
    hd = d // num_heads
    pre = (replicate_dims(x @ cast(params["w_in"], dtype), 1, 2) + params["b"]).float()
    pre = flatten(unflatten(pre, -1, (4, num_heads, hd)).permute(1, 3, 0, 2, 4), 3, 4)
    if state is None:
        zeros = x.new_zeros((num_heads, b, hd), dtype=torch.float32)
        state = (zeros, zeros, torch.full_like(zeros, SENTINEL), zeros)
    else:
        state = tuple(t.transpose(0, 1) for t in state)
    r = cast(params["r"], torch.float32)  # (4, H, hd, hd)
    r2 = flatten(r.permute(1, 2, 0, 3), 2, 3)
    hs, *state = _scan(pre, r2, *state)
    h = flatten(hs.permute(2, 0, 1, 3), 2, 3).to(dtype)
    return h @ cast(params["w_out"], dtype), tuple(t.transpose(0, 1) for t in state)


def slstm_step(params, x: torch.Tensor, state, num_heads: int, dtype):
    """Single-token decode: ``slstm_scan`` over one step from ``state``."""
    return slstm_scan(params, x, num_heads, dtype, state=state)
