#!/usr/bin/env python3
"""xlstm-1.3b at full width on the CPU: the port beside the JAX reference
where the reference is ill-conditioned.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/kernel_xlstm_depth.py \
        [--periods 1] [--tokens 8] [--teacher 8] [--other-chunk 2] [--threads 8]

The xLSTM path launches no kernel; this measures the model around it.
xlstm-1.3b's published widths (d_model 2,048, 4 heads, mLSTM chunk 256)
are kept and the depth is cut to ``--periods`` periods of its pattern (7
mLSTM and 1 sLSTM layers).  From JAX's ``init_params`` (key 0), in f32,
four runs take the same weights and tokens:

- ``jax``: the reference at the config's chunk;
- ``jax other``: the reference at ``--other-chunk``, the same recurrence
  on another chunk schedule, so its distance from ``jax`` is what the
  reference's own rounding moves;
- ``jax perturbed``: the reference at the config's chunk on the weights
  each times (1 + 2^-24 z), z ~ N(0, 1) (seed 9): what one rounding of
  every weight moves;
- ``port``: ``repro_torch`` on the weights ``params_from_jax`` carries
  across.

For each it prints the loss over ``--tokens`` tokens, each layer's
gradient (its largest |g| and its norm, bottom layer first) from
``jax.grad`` and from autograd, and the prefill's last logits over
``--teacher`` tokens against as many teacher-forced decode steps from
``init_decode_cache``.  Two periods hold ~13 GiB; keep ``--periods`` at
1 or 2.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))

ARCH = "xlstm-1.3b"


def _layer_stats(grads, pattern, periods, leaves, host):
    """[(period, position, kind, max |g|, norm)] over each layer's leaves."""
    out = []
    for r in range(periods):
        for pi, kind in enumerate(pattern):
            arrs = [host(v)[r].astype(np.float64) for v in leaves(grads["stages"][0][pi])]
            out.append((r, pi, kind, max(float(np.abs(a).max()) for a in arrs),
                        float(np.sqrt(sum(float((a * a).sum()) for a in arrs)))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--periods", type=int, default=1)
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--teacher", type=int, default=None, help="default: --tokens")
    ap.add_argument("--other-chunk", type=int, default=2)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    teacher = args.teacher or args.tokens

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import get_config as jax_config
    from repro.models import model as jm
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    from repro_torch.models.weights import params_from_jax
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    if args.threads:
        torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    (pattern, _), = jax_config(ARCH).stages
    stages = ((pattern, args.periods),)
    jcfg = jax_config(ARCH).replace(dtype="float32", stages=stages)
    tcfg = get_config(ARCH).replace(dtype="float32", stages=stages)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    toks = np.random.default_rng(1).integers(1, jcfg.vocab_size, (1, args.tokens + 1)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tbatch = {"tokens": torch.from_numpy(toks[:, :-1]).long(), "labels": torch.from_numpy(toks[:, 1:]).long()}
    print(f"{ARCH} at full width, {args.periods * len(pattern)} layers, f32, JAX's weights (key 0): "
          f"loss and gradients over {args.tokens} tokens, teacher-forced decode over {teacher}; "
          f"chunk {jcfg.mlstm_chunk}, the other schedule {args.other_chunk}; torch threads "
          f"{torch.get_num_threads()}", flush=True)

    noise = np.random.default_rng(9)
    perturbed = jax.tree_util.tree_map(lambda w: jnp.asarray(
        (np.asarray(w) * (1 + 2.0**-24 * noise.standard_normal(w.shape))).astype(np.float32)), jparams)
    jruns = (("jax", jcfg.mlstm_chunk, jparams), ("jax other", args.other_chunk, jparams),
             ("jax perturbed", jcfg.mlstm_chunk, perturbed))
    fns = {chunk: jax.jit(jax.value_and_grad(
        lambda p, b, cfg=jcfg.replace(mlstm_chunk=chunk): jm.loss_fn(cfg, p, b)[0]))
        for chunk in (jcfg.mlstm_chunk, args.other_chunk)}
    runs = {}
    for name, chunk, params in jruns:
        loss, grads = fns[chunk](params, jbatch)
        runs[name] = [float(loss), _layer_stats(grads, pattern, args.periods,
                                                jax.tree_util.tree_leaves, np.asarray)]
        del grads
    leaves = [p.detach().requires_grad_() for p in tree_leaves(tparams)]
    loss, _ = tm.loss_fn(tcfg, tree_unflatten(tparams, leaves), tbatch)
    grads = tree_unflatten(tparams, list(torch.autograd.grad(loss, leaves)))
    runs["port"] = [float(loss.detach()), _layer_stats(grads, pattern, args.periods, tree_leaves,
                                                       lambda v: v.numpy())]
    del grads, leaves

    ttoks = toks[:, :teacher]
    step = jax.jit(lambda p, c, t: jm.decode_step(jcfg, p, c, t))
    for name, chunk, params in jruns:
        cfg = jcfg.replace(mlstm_chunk=chunk)
        _, pre = jax.jit(lambda p, t: jm.prefill(cfg, p, t))(params, jnp.asarray(ttoks))
        cache = jm.init_decode_cache(cfg, 1, teacher)
        for i in range(teacher):
            cache, last = step(params, cache, jnp.asarray(ttoks[:, i:i + 1]))
        runs[name] += [np.asarray(pre), np.asarray(last)]
    with torch.no_grad():
        tt = torch.from_numpy(ttoks).long()
        _, pre = tm.prefill(tcfg, tparams, tt)
        cache = tm.init_decode_cache(tcfg, 1, teacher, "cpu")
        for i in range(teacher):
            cache, last = tm.decode_step(tcfg, tparams, cache, tt[:, i:i + 1])
    runs["port"] += [pre.numpy(), last.numpy()]

    ref_loss, ref_layers, ref_pre, _ = runs["jax"]
    for name, (loss, layers, pre, last) in runs.items():
        print(f"{name}: loss {loss:.7f} ({abs(loss - ref_loss) / ref_loss:.3e} from jax's); prefill "
              f"logits max |{float(np.abs(pre).max()):.4f}|, {float(np.abs(pre - ref_pre).max()):.3e} "
              f"from jax's; teacher-forced decode {float(np.abs(last - pre).max()):.3e} from its own "
              "prefill")
    print("gradient by layer, bottom first: jax's max |g| and norm; the others' as fractions of jax's")
    for i, (r, pi, kind, gmax, gnorm) in enumerate(ref_layers):
        others = "; ".join(f"{name} {runs[name][1][i][3] / gmax:.4f}, {runs[name][1][i][4] / gnorm:.4f}"
                           for name in ("jax other", "jax perturbed", "port"))
        print(f"  period {r} layer {pi} {kind}: {gmax:.4e}, {gnorm:.4e}; {others}")
    top, bottom = ref_layers[-1], ref_layers[0]
    print(f"jax's gradient norm grows {bottom[4] / top[4]:.3e} from the top layer to the bottom; "
          f"the port's {runs['port'][1][0][4] / runs['port'][1][-1][4]:.3e} "
          f"({time.perf_counter() - t0:.0f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
