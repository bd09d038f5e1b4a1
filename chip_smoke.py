#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit) and versions;
   exits non-zero without a CUDA device.
2. Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``
   (nvcc, sm_90a, one process per source) and prints the build time,
   each kernel's registers and spills (ptxas), and the count of the
   redesigned kernels' tensor-core and bulk-copy instructions (SASS from
   cuobjdump, else PTX); fails if those kernels spill or lack them.
3. Holds each kernel against its plain PyTorch version on the card:
   the attention kernels in bf16 (the tensor-core kernel) and f32 (the
   CUDA-core kernel) at the serving path's shapes plus ragged ones, and at
   stablelm-12b's heads (32/8) at head dim 160;
   ``flash_decode`` (bf16 D 64/128/160: the split-KV cluster kernel; f32:
   the tile kernel) at the serving shape (D 128 and 160), and at T = 1,
   32, 33, 160 and 4,096 with groups 1/3/4/6/8/16, head dims 64, 128 and
   160, ``cur`` at 0, at both sides
   of every 64-key tile edge (every split boundary), T-1, T and past T,
   and B = 1; ``flash_decode`` at head dim 256 (bf16, the cluster
   kernel) at recurrentgemma-2b's ring (q (4,10,256), caches
   (4,2048,1,256)) with cur below T, at T-1 and past T, and at ragged T,
   timed beside SDPA; ``csr_dot``
   bit-exact (``torch.equal``) with both ``gather`` values at the SVM
   path's shape, a ragged B and K with the same w, a kddcup10-like one, a
   ragged B, duplicate ids and B = 0 (no launch).  Times the attention kernels, their plain versions
   and one PyTorch library call (``scaled_dot_product_attention``, a
   yardstick only: the port never calls it) and computes the least time
   the card could take; ``flash_attention`` also at granite-3-8b's
   4,096-token context (the row's ``context_4096``); both at head dim
   160 (the rows' ``head_dim_160``: K4 at stablelm-12b's 128-token prompt
   in bf16 and f32, K6 at the serving shape in bf16).  Then whisper-tiny's
   shapes: K4 with ``causal=False`` at its encoder's q, k, v (8, 1,500, 6,
   64) and its cross-attention's q (8, 384, 6, 64) against (8, 1,500, 6,
   64), K6 on its 1,500-frame cross cache at cur = T - 1, T - 2, 0 and
   past T, in bf16 and f32, the three bf16 calls timed (the rows'
   ``whisper``).
4. Holds the port's model on the card against the same model on the CPU
   (plain kernel versions) at smoke size, in float32 (granite; whisper
   with its frames and qwen2-vl with ``positions_3d``: loss, gradients,
   prefill and its caches, decode); and ``LinearSVM`` likewise, a few
   steps on one dense batch at epsilon's width.
5. Drives the serving launcher (``repro_torch.launch.serve``) on
   granite-3-8b at full published width — random weights from ``--seed``,
   40 layers, d_model 4096 — and checks that every request completed, no
   slot leaked, and each kernel launched 40 times per prefill and per
   decode step (the warmup's included).  Then again with the
   request-stream feature tier on (``--cache-mb``: 64 of 512 Zipf-popular
   feature records in a Belady DRAM tier, 8 ids a request), with the same
   checks, and that every feature read is a hit or a miss, the store's
   counters equal the tier's, and misses alone reached storage.
6. Profiles a few steady decode steps at full width (device time by
   kernel, device busy share).
7. Trains the sparse SVM at webspam width (16,609,143 features, rows cut
   to 12,500) as the JAX package's acceptance path does: record store →
   LIRS shuffler → the tiered read path (a Belady DRAM tier of a quarter
   of the training rows' bytes, lookahead prefetch along the shuffler's
   index stream) → multi-producer ragged pipeline → CSR packing → DCD,
   with the objective and held-out margins through ``csr_dot`` after
   each epoch; checks the batches, the falling objective, the margins
   against a host reference and the launch count; first reads both
   epochs through a second tiered plane and the direct plane and checks
   every record's bytes equal; prints each epoch's storage reads and tier
   counters (checking the store's cache hits equal the tier's) and the
   drift report of the second epoch; prints the host time
   split, the kernel's device time and the device's busy share; then
   times ``csr_dot`` on the path's training-set inputs against its plain
   version and ``embedding_bag``.
8. Holds ``batch_gather`` and ``batch_gather_dma`` bit-exact against
   their plain version (f32/bf16/int32, rows_per_block 1-8,
   rows_per_step 1/8/16, ragged B, duplicate and out-of-range ids, B = 0
   without a launch), and ``batch_gather_tables`` (three tables, one
   launch) on both of its routes, host ids in the launch's parameters and
   ids loaded by the kernel, around the 960-id cap; times them, their
   plain version and ``index_select`` at the DNN path's shape (K1 one
   launch for the pair) and a 2 GiB bandwidth shape (this runs right
   after step 3); times K1 at B = 1 on the DNN tables, its per-launch
   latency floor.
9. Trains the paper's DNN workload (Tables 6-7) through
   ``repro_torch.dnn.convergence`` at ImageNet-1k's row count (1,281,160
   rows of 32 f32 features held on the card, vgg-like MLP, batch 100):
   TFIP with a 10,000 queue against LIRS, one epoch each, every batch
   gathered by one ``batch_gather`` launch for features and labels, the
   ids in its parameters; checks the rows consumed, one launch a step, the
   falling validation loss and LIRS's higher test accuracy;
   replays LIRS's first epoch with ``batch_gather_dma`` against the same
   step losses; checks one epoch of both shufflers' batches, gathered by
   both kernels, against ``xs[idx]`` on the host; prints the host time of
   TFIP's window shuffle and the device's busy share over 200 steps.
10. Holds ``rglru_scan`` and its backward ``rglru_scan_bwd`` bit-exact
   (``torch.equal``) against their plain versions at the training path's
   shape (1, 4096, 2560), a ragged one, T = 1, a long ragged T that wraps
   the TMA ring many times and a W no multiple of the channel strip (each
   routed to the ring kernel, the lanes kernel at W % 4 != 0), and times each
   direction against its plain loop (no single PyTorch call computes a
   linear recurrence, so there is no library time).  Then one train step
   of smoke recurrentgemma (float32) on the card against the same step on
   the CPU: loss, gradient norm and updated parameters (this runs after
   step 4's model check).
11. Trains recurrentgemma-2b at full width and depth through
   ``repro_torch.launch.train`` (seq 4096, batch 1, 8 steps, AdamW,
   ``remat="dots"``: the blocks' work between products checkpointed):
   checks 8 finite losses and 36 ``rglru_scan`` and
   18 ``rglru_scan_bwd`` launches a step (18 RG-LRU layers, each scan run
   forward and again in the recompute); prints Eq. 1's numbers, the step
   times and the peak memory; then trains it again through the tiered
   read path (16 records, 2 epochs, half of them in a Belady DRAM tier,
   ``--drift-device optane``): 32 finite losses, the same scan launches a
   step, the summary's ``cache`` and ``drift`` blocks, the drift report
   within its tolerances; then profiles two steady steps (device time by
   kernel, busy share, peak memory) under ``remat="dots"`` and again
   under ``"full"``, their step times and peaks side by side; each peak
   must stay 5 GiB under the card's memory (``"dots"`` saves no bf16
   weight cast: the backward casts the weights again).  The profiles run
   after step 12's phases.
12. Trains recurrentgemma-2b at full width and depth through the
   multi-host tier (``--hosts 4 --cache-mb``: a 4-host clairvoyant
   cluster in this process, 4 x 1,024 tokens a step, 32 records, a fleet
   budget of 16, 3 epochs): first a second cluster without background
   workers reads every global batch of the 3 epochs, each equal to the
   store's direct read, and the fleet's storage records equal n +
   (epochs - 1) x floor; then the launcher: 24 finite losses, the scan
   launches of step 11, the ``distributed`` block (4 hosts, 16 records of
   fleet capacity, a floor of 16, records served host-to-host, no peer
   failure or push error) and a ``drift`` block; prints step times, Eq.
   1, the peak, the storage records of each epoch beside the floor.
   Then the TCP route: three processes through ``run_cpu_process_mesh``,
   each a ``PeerServer`` and a ``TCPTransport``, lockstep epochs (bytes
   equal to the direct read, records pushed and served, reads at the
   floor).  Then gradient compression at full width, batch 1 x 1,024:
   one step's gradients compressed on the card and on the CPU (codes,
   scales and residuals ``torch.equal``), error feedback's invariant
   ``decompress + new_residual == grad + residual`` bit for bit on the
   card, ``compressed_psum`` over a one-rank NCCL group on the embedding's
   gradient equal to ``dequantize(quantize(x))``, and 4 steps through
   ``make_train_step(compressor=EFCompressor(8))``: finite losses, the
   first equal to an uncompressed step's from the same weights and
   batch, the scan launches, both peaks 5 GiB under the card.
13. Prefills recurrentgemma-2b at full width and depth (4 x 4,096
   tokens, through ``make_prefill_step``) and decodes 64 greedy steps
   past it (``make_decode_step``: RG-LRU state caches, 2,048-slot
   local-attention rings that wrap at once, scalar position): checks 18
   forward scans in prefill, 8 x 64 ``flash_decode`` launches in decode,
   all on the cluster kernel at head dim 256, no scan, finite logits;
   prints prefill ms, decode ms a step, tokens/s, peak memory and
   profiles of both.  Then 128 teacher-forced decode steps from an empty
   cache against prefill's logits (bf16, 5e-2); granite-3-8b at full
   width and 4 of 40 layers: prefill -> ``extend_cache`` -> 8
   scalar-position decode steps against prefill at 3e-2; and
   ``blocked_attention`` at granite's 4,096-token context against K4.
14. Serves qwen2-moe-a2.7b at full width and depth (24 ``moe`` layers,
   60 routed experts top-4 and 4 shared; 14,315,587,584 parameters in
   f32) through the serving launcher with step 5's checks; profiles its
   steady decode (device time by operation: dispatch and combine, the
   experts' products, the other products, casts); checks one decode step
   of its 8-slot arena dense against ragged, and a 64-token prefill under
   ``impl="ragged"`` against teacher-forced ``"dense"`` decode, in f32
   (the strict check) and in bf16 (counting the routings that differ);
   trains it at full width and 4 of 24 layers for 8 steps of 4,096 tokens
   (finite losses, aux loss above 0); and checks minitron-8b and
   phi4-mini-3.8b at full depth and dbrx-132b at 2 of 40 layers, prefill
   against teacher-forced decode in f32 and bf16 (K4 and K6 at groups 3,
   4 and 6).  The kernel checks of step 3 also run K4 at these configs'
   heads and K6 at groups 3 and 6.
   Serves stablelm-12b at full width and depth (40 ``attn`` layers, GQA
   32/8 at head dim 160; 12,142,924,800 parameters in f32) through the
   serving launcher with step 5's checks, every K4 launch on the
   tensor-core kernel and every K6 launch on the cluster kernel at D 160;
   profiles its steady decode (casts, GEMMs, ``flash_decode``); and
   checks its prefill against teacher-forced decode at full depth in f32
   (1e-3, K4 and K6 on their f32 kernels at D 160) and bf16 (5e-2).
15. xlstm-1.3b (48 layers: 42 ``mlstm``, 6 ``slstm``; 2,047,318,352
   parameters), which launches no kernel: first the sLSTM alone at (1,
   4,096, 2,048), forward and backward timed with CUDA events, its
   launches a time step from profiles at two lengths; every xLSTM path at
   smoke size in f32 on the card against the CPU (a train step, prefill
   and its caches, 8 decode steps, teacher-forced decode); training at
   full width and depth through the launcher (seq 4,096, 4 steps, a
   finite first loss: the reference's first gradient overflows at this
   depth, printed a period; no launch); a profile of 2 steps (the sLSTM
   loop's span on the device's timeline, the rest's device time by
   class); prefill of 4 x 4,096 and 64 greedy decode steps (the caches'
   shapes, every ``m`` finite, no launch, ``pos``) with their profiles;
   teacher-forced decode against prefill at 48 layers (bf16 within twice
   the bf16 prefill's distance from f32, f32 printed) and on one layer of
   each kind at full width (f32, 1e-3).
16. whisper-tiny at published width and depth (4 ``enc_attn`` + 4
   ``dec_attn`` layers, d_model 384, 6 heads of 64, 56,355,840
   parameters; random frames, the conv frontend a stub as in the JAX
   package): 8 training steps through ``make_train_step`` (B 8, 1,500
   frames, 448 tokens; finite losses, encoder gradients non-zero, no
   launch); then prefill 8 x 384 tokens with the frames, ``extend_cache``
   by 64 and 64 greedy decode steps: 12 K4 launches a prefill, all on the
   tensor-core kernel, 8 K6 launches a step, all on the cluster kernel, the
   cross K/V unchanged by decode; prefill ms, decode ms a step, tokens/s,
   peak memory and a profile of 5 decode steps; then prefill(320) ->
   ``extend_cache`` -> 64 teacher-forced steps against prefill(384), f32
   (1e-3) and bf16 (5e-2).
17. qwen2-vl-72b at full width and 8 of 80 layers (9,512,820,736
   parameters): a 64-token prompt with a 6 x 8 image block, its M-RoPE
   positions as Qwen2-VL lays them out; prefill against 64 teacher-forced
   decode steps each with its (1, 3, 1) positions, f32 (1e-3) and bf16
   (5e-2), K4 and K6 at group 8, D 128; the default positions must move
   the logits by more than each tolerance; the peak 5 GiB under the card.
18. Prints ``{"kernels": [...]}``, then ``{"ok": true, "device": ...}`` as
   the last line.  Any failed check exits non-zero before those lines.
"""
from __future__ import annotations

import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12          # H100 SXM f32 on the CUDA cores
TOL = {"torch.float32": 2e-5, "torch.bfloat16": 2e-2}
TIMED_DECODE256_TOL = 1e-2  # K6 at D 256 on the timed inputs (decode256_phase)

# sparse SVM widths: Yu, Hsieh, Chang & Lin, "Large Linear Classification
# When Data Cannot Fit in Memory", KDD 2010, Table 2
WEBSPAM_DIM = 16_609_143   # webspam (trigram)
KDDCUP10_DIM = 29_890_095  # kddcup10
EPSILON_DIM = 2_000        # epsilon
SVM_TRAIN, SVM_TEST, SVM_BLOCK = 10_000, 2_500, 1_000  # rows cut from 350,000
SVM_NNZ = (2000, 5456)     # mean 3,728 nonzeros per row, as webspam's ~3,700
SVM_SWEEPS, SVM_EPOCHS = 3, 2
SVM_CACHE_FRAC = 0.25      # the tier's budget: this share of the training rows' bytes

# the DNN path (paper Tables 6-7): the JAX benchmark's widths (DIM 32, 20
# classes, batch 100, "vgg-like" hidden widths) at the row count of the
# paper's DNN dataset, ImageNet-1k train; make_clustered_data keeps
# n // 20 rows per class, so the table holds 1,281,160 rows
IMAGENET_ROWS = 1_281_167
DNN_QUEUE = 10_000        # the paper's TFIP queue (benchmarks/dnn_convergence.py:21)
DNN_EPOCHS = 1            # reduced from E_MAX = 10 for time (a step costs ~3 ms of host)
DNN_MODEL = "vgg-like"
DNN_PROFILE_STEPS = 200
GATHER_BW = (1_048_576, 512, 8_192)  # bandwidth shape: a 2 GiB f32 table, B

# the LM training path: recurrentgemma-2b at published width and depth;
# seq 4096 is twice the local-attention window, so the chunked branch runs
TRAIN_ARGS = ["--arch", "recurrentgemma-2b", "--seq-len", "4096", "--batch", "1",
              "--num-records", "64", "--epochs", "1", "--steps", "8", "--seed", "0",
              "--device", "cuda"]
# the same through the tiered read path: 16 records of 4,097 int32 (16,388
# bytes), 8 of them in a Belady DRAM tier, 2 epochs (32 steps), a 4-batch
# lookahead, and the drift report priced on Optane
TRAIN_TIER_ARGS = ["--arch", "recurrentgemma-2b", "--seq-len", "4096", "--batch", "1",
                   "--num-records", "16", "--epochs", "2", "--steps", "0", "--seed", "0",
                   "--cache-mb", str(8 * 16388 / 2**20), "--prefetch-lookahead", "4",
                   "--eviction-policy", "belady", "--drift-device", "optane", "--device", "cuda"]
# the multi-host tier: recurrentgemma-2b trained through a 4-host
# clairvoyant cluster in this process (``--hosts 4``).  Batch 4 x 1,024 so
# that each host owns one row of every global batch (a step still takes
# 4,096 tokens); 32 records of 1,025 int32 (4,100 bytes), a fleet budget of
# half of them (16, 4 a host), 3 epochs of 8 steps, a 2-batch lookahead
MULTIHOST_HOSTS, MULTIHOST_RECORDS, MULTIHOST_SEQ, MULTIHOST_BATCH = 4, 32, 1024, 4
MULTIHOST_EPOCHS, MULTIHOST_CACHED = 3, 16
MULTIHOST_ARGS = ["--arch", "recurrentgemma-2b", "--seq-len", str(MULTIHOST_SEQ),
                  "--batch", str(MULTIHOST_BATCH), "--num-records", str(MULTIHOST_RECORDS),
                  "--epochs", str(MULTIHOST_EPOCHS), "--steps", "0", "--seed", "0",
                  "--hosts", str(MULTIHOST_HOSTS),
                  "--cache-mb", str(MULTIHOST_CACHED * (MULTIHOST_SEQ + 1) * 4 / 2**20),
                  "--eviction-policy", "belady", "--prefetch-lookahead", "2", "--device", "cuda"]
# the TCP route: 3 host processes, each a PeerServer and a TCPTransport, over
# 256 records of 64 bytes (batches of 32), a quarter of them cached a host
TCP_HOSTS, TCP_RECORDS, TCP_BATCH, TCP_RECORD, TCP_EPOCHS = 3, 256, 32, 64, 3
# gradient compression at recurrentgemma-2b's full width: batch 1 x 1,024,
# COMPRESSION_STEPS steps through make_train_step(compressor=EFCompressor(8))
COMPRESSION_SEQ, COMPRESSION_STEPS = 1024, 4
# the path's first; then ragged, T = 1, a long ragged T (128 ring tiles and
# one step), a W no multiple of the 32-channel strip, and W % 4 != 0
SCAN_SHAPES = ((1, 4096, 2560), (3, 1000, 2560 + 96), (2, 1, 2560), (1, 16385, 2560),
               (2, 300, 2568), (2, 77, 2562))

# flash_decode's sweep: arena lengths (one key, one and two 32-key tiles, the
# serving arena, granite-3-8b's context) and GQA groups
DECODE_LENGTHS = (1, 32, 33, 160, 4096)
DECODE_GROUPS = (1, 3, 4, 6, 8, 16)  # 3: phi4-mini-3.8b's, 6: dbrx-132b's
# flash_attention at the copied configs' heads (query heads, KV heads), D
# 128: qwen2-moe-a2.7b (group 1, the tensor cores), phi4-mini-3.8b (group 3)
# and dbrx-132b (group 6), whose bf16 groups do not divide 64: CUDA cores
PREFILL_HEADS = ((16, 16), (24, 8), (48, 8))
# stablelm-12b's heads: 32 query heads on 8 KV heads at head dim 160
STABLELM_ARCH, STABLELM_HEADS, STABLELM_D = "stablelm-12b", (32, 8), 160

LONG_CONTEXT = 4096  # granite-3-8b's context: flash_attention's second timed shape

# recurrentgemma-2b's prefill and decode at published width and depth: 4
# prompts of two windows (the chunked local attention and the ring's
# roll), then greedy decode past them (the 2,048-slot ring wraps at once);
# the teacher-forced check decodes 128 tokens from an empty cache
RG_BATCH, RG_PROMPT, RG_DECODE, RG_TEACHER = 4, 4096, 64, 128
RG_PROFILE_STEPS = 5
# the same ring as K6 sees it there: q (B, 10, 256), caches (B, 2048, 1, 256)
RG_RING = (RG_BATCH, 10, 1, 256, 2048)
# granite-3-8b at full width, 4 of its 40 layers: scalar-position decode
GRANITE_LAYERS, GRANITE_PROMPT, GRANITE_EXTEND = 4, 120, 8
BLOCKED_BLOCK = 1024  # attn_block's default: the blocked check at LONG_CONTEXT

MOE_ARCH = "qwen2-moe-a2.7b"
# qwen2-moe-a2.7b at full width: prefill of MOE_CHECK_TOKENS under
# impl="ragged" (nothing dropped) against as many teacher-forced decode
# steps under "dense"
MOE_CHECK_TOKENS = 64
# teacher-forced logits against prefill's at full width: f32 (the strict
# check) and bf16, whose rounding at depth alone moves the logits by a few
# 1e-2 (teacher_forced_check holds recurrentgemma-2b to 5e-2 for the same reason)
F32_LOGITS_TOL, BF16_LOGITS_TOL = 1e-3, 5e-2
# its training at full width and MOE_TRAIN_LAYERS of 24 layers (the full
# depth's f32 weights and AdamW state need ~229 GB)
MOE_TRAIN_LAYERS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 4096, 8
# the copied configs' prefill against teacher-forced decode, bf16: (arch,
# layers kept or None for the full depth); dbrx-132b's 40 layers hold 13 GB
# of f32 weights each
COPIED_CHECKS = (("minitron-8b", None), ("phi4-mini-3.8b", None), ("dbrx-132b", 2),
                 (STABLELM_ARCH, None))
COPIED_TOKENS = 64

# xlstm-1.3b at published width and depth (42 mlstm and 6 slstm layers):
# the training path at seq 4096 (16 mLSTM chunks of 256; ``reduced``: 8 ->
# 2 steps: a step takes ~12 s of host launches, and at the reference's
# initialisation the first update leaves the weights non-finite, so later
# steps add times and no check), then prefill of 4 x 4,096 and greedy
# decode past it
XLSTM_ARCH = "xlstm-1.3b"
XLSTM_TRAIN_STEPS = 2
XLSTM_TRAIN_ARGS = ["--arch", XLSTM_ARCH, "--seq-len", "4096", "--batch", "1",
                    "--num-records", "64", "--epochs", "1", "--steps", str(XLSTM_TRAIN_STEPS),
                    "--seed", "0", "--device", "cuda"]
XLSTM_PROFILE_STEPS = 2
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_DECODE = 4, 4096, 64
# teacher-forced tokens at 48 layers (one chunk; ``reduced`` from 512 for
# time) and on XLSTM_HELD_PATTERN (two chunks)
XLSTM_TEACHER, XLSTM_TEACHER_HELD = 256, 512
# the full-width check that holds f32 decode to prefill: one layer of each
# kind (at 8 layers the reference's own f32 prefill and decode part by
# 1.5e-2 after 8 tokens: xlstm_teacher_forced_check)
XLSTM_HELD_PATTERN = ("mlstm", "slstm")
XLSTM_DECODE_PROFILE = 5
# the sLSTM alone at the training path's shape (B, S, d_model), and the two
# short lengths whose profiles give its launches a time step
SLSTM_SHAPE, SLSTM_COUNT_LENGTHS = (1, 4096, 2048), (64, 128)

# whisper-tiny at published width and depth (4 enc_attn + 4 dec_attn
# layers, d_model 384, 6 heads of 64): 30 s of audio is 1,500 encoder
# frames, Whisper's text context 448 tokens; training B = 8 over both,
# WHISPER_TRAIN_STEPS steps; serving prefills 8 x WHISPER_PROMPT tokens,
# extends the cache by WHISPER_DECODE and decodes as many greedy steps (448
# positions); the teacher-forced check prefills WHISPER_TEACHER_PROMPT and
# decodes the rest of WHISPER_PROMPT against prefill(WHISPER_PROMPT)
WHISPER_ARCH = "whisper-tiny"
WHISPER_BATCH, WHISPER_TEXT, WHISPER_TRAIN_STEPS = 8, 448, 8
WHISPER_PROMPT, WHISPER_DECODE, WHISPER_TEACHER_PROMPT = 384, 64, 320
WHISPER_PROFILE_STEPS = 5
# qwen2-vl-72b at full width and QWEN_VL_LAYERS of its 80 layers
# (``reduced``: 80 layers are 290.8 GB of f32 weights; 8 are 38.05 GB): a
# prompt of QWEN_VL_TEXT text tokens, an image of QWEN_VL_IMAGE (h, w)
# patches, then text again, QWEN_VL_TOKENS in all, prefilled and decoded
# teacher-forced with its M-RoPE positions
QWEN_VL_ARCH, QWEN_VL_LAYERS = "qwen2-vl-72b", 8
QWEN_VL_TEXT, QWEN_VL_IMAGE, QWEN_VL_TOKENS = 8, (6, 8), 64

SERVE_ARGS = ["--arch", "granite-3-8b", "--serve-mode", "continuous",
              "--max-batch", "8", "--prompt-capacity", "128", "--gen", "32",
              "--requests", "16", "--offered-load", "1.0", "--seed", "0",
              "--device", "cuda"]
# the request-stream feature tier, at benchmarks/serve_latency.py's
# settings: 512 feature records of 68 bytes (a label and 16 f32 features),
# 64 of them cached, 8 Zipf-popular ids a request
SERVE_CACHE_RECORDS, SERVE_FEATURES_PER_REQUEST = 64, 8
SERVE_TIER_FLAGS = ["--cache-mb", str(SERVE_CACHE_RECORDS * 68 / 2**20), "--num-features", "512",
                    "--features-per-request", str(SERVE_FEATURES_PER_REQUEST),
                    "--zipf-alpha", "1.1", "--eviction-policy", "belady"]
MOE_SERVE_ARGS = ["--arch", MOE_ARCH] + SERVE_ARGS[2:]
STABLELM_SERVE_ARGS = ["--arch", STABLELM_ARCH] + SERVE_ARGS[2:]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare(label, got, want, tol, show=True):
    """max |got - want| and whether every element is within
    tol + tol·|want| (numpy's allclose with rtol = atol = tol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol + tol * want.abs()).all())
    max_err = float(err.max())
    if show or not ok:
        print(f"  {label}: max_abs_err {max_err:.3e} (tol {tol:g}) {'ok' if ok else 'BREACH'}")
    check(ok, f"{label} outside tolerance")
    return max_err


def time_ms(fns, n=50, rounds=3):
    """Device time per call: each function's n calls are captured in one
    CUDA graph, so the Python wrappers' host time drops out, and the
    graph replays are timed with CUDA events.  Median over rounds; the
    functions take turns (a b c, c b a, a b c) on one card.  Also returns
    the eager per-call time (host and device, as the serve loop sees it)."""
    graphs, eager = {}, {}
    for k, f in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            f()
        torch.cuda.current_stream().wait_stream(side)
        graphs[k] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[k]):
            for _ in range(n):
                f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        eager[k] = 1e3 * (time.perf_counter() - t0) / n
    samples = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[k].replay()
            stop.record()
            torch.cuda.synchronize()
            samples[k].append(start.elapsed_time(stop) / n)
    return {k: statistics.median(v) for k, v in samples.items()}, eager


def _profiled(fn, steps, **kw):
    """Run ``fn`` ``steps`` times under torch.profiler (``kw`` its options):
    ``(profile, device events, wall seconds)``.  Device-side events only
    (kernels, copies): the CPU ops that launch them carry the same device
    time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    check(bool(events), "the profiler recorded no device activity")
    return prof, events, wall


# ------------------------------------------------------------ kernels

# the kernels redesigned for Hopper (mangled-name fragments) and the
# instructions that show they use the tensor cores and bulk copies: SASS
# from cuobjdump where the toolkit has it, else PTX from nvcc -ptx
NEW_KERNELS = ("fa_wgmma_kernel", "fa_wgmma_kernelILi160E", "gather_bulk_kernel",
               "gather_staged_kernel", "fd_cluster_kernel", "fd_cluster_kernelILi256E",
               "fd_cluster_kernel_1smILi160E", "scan_ring_kernel", "gather_tables_kernel",
               "csr_dot_kernel")
SASS_OPS = {"fa_wgmma_kernel": ("HGMMA", "UTMALDG"), "gather_bulk_kernel": ("UBLKCP",),
            "fd_cluster_kernel": ("LDGSTS", "HMMA"), "scan_ring_kernel": ("UTMALDG", "UTMASTG"),
            "gather_tables_kernel": ("LDC",),
            # the head dim 160 instantiations on their own
            "fa_wgmma_kernelILi160E": ("HGMMA", "UTMALDG"),
            "fd_cluster_kernel_1smILi160E": ("LDGSTS", "HMMA")}
PTX_OPS = {"flash_attention_wgmma.cu": ("wgmma.mma_async", "cp.async.bulk.tensor"),
           "batch_gather.cu": ("cp.async.bulk.shared", "cp.async.bulk.global"),
           "flash_decode_cluster.cu": ("cp.async.cg.shared.global", "mapa",
                                       "mma.sync.aligned.m16n8k16"),
           "rglru_scan.cu": ("cp.async.bulk.tensor.3d.shared", "cp.async.bulk.tensor.3d.global")}
# csr_dot's evict-first stream (PTX in every run: SASS names no policy)
POLICY_PTX = {"csr_dot.cu": ("createpolicy.fractional.L2::evict_first",
                             "ld.global.nc.L2::cache_hint")}


def ptxas_resources(log):
    """{mangled kernel name: registers and spill bytes} from ``-Xptxas -v``."""
    import re

    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": None, "spill_stores": 0, "spill_loads": 0}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn]["spill_stores"], out[fn]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn]["registers"] = int(m.group(1))
    return out


def instruction_counts(lib):
    """Count the tensor-core and bulk-copy instructions of the redesigned
    kernels in the built library (SASS), or in their PTX without cuobjdump;
    fails if one is missing."""
    import shutil

    from repro_torch.kernels import build

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(build._nvcc()), "cuobjdump")
    def ptx_counts(table, why):
        for src, ops in table.items():
            ptx = subprocess.run([build._nvcc(), *build.ARCH_FLAGS, "-std=c++17", "-ptx", "-o",
                                  "-", str(build.CSRC / src)], capture_output=True, text=True,
                                 timeout=300, check=True).stdout
            counts = {op: ptx.count(op) for op in ops}
            print(f"  PTX of {src}{why}: {counts}")
            check(all(counts.values()), f"{src}: PTX lacks one of {ops}")

    if os.path.exists(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              timeout=300, check=True).stdout
        funcs = sass.split("Function : ")[1:]
        for key, ops in SASS_OPS.items():
            text = "".join(f for f in funcs if f.split()[0].find(key) >= 0)
            counts = {op: text.count(op) for op in ops}
            print(f"  SASS of {key}: {counts}")
            check(all(counts.values()), f"{key}: SASS lacks one of {ops}")
        ptx_counts(POLICY_PTX, "")
        return
    ptx_counts({**PTX_OPS, **POLICY_PTX}, " (no cuobjdump)")


def kernel_phase(dev):
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator().manual_seed(0)

    def randn(*shape, dt):
        return torch.randn(*shape, generator=g).to(dev, dt)

    rows = []
    print("flash_attention vs plain version (bf16: tensor-core kernel; f32: CUDA-core kernel):")
    heads = [((32, 8), 128)] + [(hk, 128) for hk in PREFILL_HEADS] + [(STABLELM_HEADS, STABLELM_D)]
    for dt in (torch.bfloat16, torch.float32):
        for ((h, kh), d), (p, causal) in itertools.product(
                heads, ((128, True), (200, True), (200, False))):
            q, k, v = randn(1, p, h, d, dt=dt), randn(1, p, kh, d, dt=dt), randn(1, p, kh, d, dt=dt)
            got = ops.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            compare(f"{dt} q{tuple(q.shape)} kv{tuple(k.shape)} causal={causal} "
                    f"({ops._attention_kernel(dt, d, h // kh)})",
                    got, ref.flash_attention(q, k, v, causal), TOL[str(dt)])

    def timed_prefill(s, h, kh, d, dt, n):
        """Kernel, plain version and SDPA at one causal shape, beside the bound."""
        q, k, v = randn(1, s, h, d, dt=dt), randn(1, s, kh, d, dt=dt), randn(1, s, kh, d, dt=dt)
        err = compare(f"timed inputs {dt} q{tuple(q.shape)} kv{tuple(k.shape)} causal=True "
                      f"({ops._attention_kernel(dt, d, h // kh)})",
                      ops.flash_attention(q, k, v), ref.flash_attention(q, k, v), TOL[str(dt)])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t, eager = time_ms({
            "kernel": lambda: ops.flash_attention(q, k, v),
            "plain": lambda: ref.flash_attention(q, k, v),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                              enable_gqa=True),
        }, n=n)
        pairs = s * (s + 1) // 2
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + q.numel())
        peak = BF16_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        out = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                   **bound(nbytes, 4 * pairs * h * d, peak), library_ms=t["library"])
        print(f"  {dt} S = T = {s}, D = {d}: device ms per call: {t}; eager ms per call: "
              f"{eager}; bound {out['bound_ms']:.6f} ms ({out['bound_by']}); kernel at "
              f"{out['bound_ms'] / t['kernel']:.3f} of it, SDPA at "
              f"{out['bound_ms'] / t['library']:.3f}")
        return out

    # the prefill path's shape and dtype: one admitted 128-token prompt;
    # then granite-3-8b's full 4,096-token context, where the tensor cores
    # show; then stablelm-12b's prompt at head dim 160 in both dtypes
    timed = {s: timed_prefill(s, 32, 8, 128, torch.bfloat16, 50 if s == 128 else 10)
             for s in (128, LONG_CONTEXT)}
    wide = {str(dt).removeprefix("torch."): timed_prefill(128, *STABLELM_HEADS, STABLELM_D, dt, 50)
            for dt in (torch.bfloat16, torch.float32)}
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:104", **timed[128],
        context_4096=timed[LONG_CONTEXT], head_dim_160=wide,
    ))

    print("flash_decode vs plain version (bf16 D 64/128/160: cluster kernel; f32: tile kernel):")
    for d in (128, STABLELM_D):
        check(ops._decode_kernel(torch.bfloat16, d) == "cluster",
              f"the serving path's decode at D {d} does not route to the cluster kernel")
    c = 160  # the arena: prompt capacity 128 + 32 generated
    cur = torch.tensor([0, 17, 31, 32, 100, c - 1, c, c + 11], dtype=torch.int32, device=dev)
    for dt, d in itertools.product((torch.bfloat16, torch.float32), (128, STABLELM_D)):
        q, kc, vc = randn(8, 32, d, dt=dt), randn(8, c, 8, d, dt=dt), randn(8, c, 8, d, dt=dt)
        got = ops.flash_decode(q, kc, vc, cur)
        torch.cuda.synchronize()
        compare(f"{dt} q{tuple(q.shape)} cache{tuple(kc.shape)} cur={cur.tolist()}",
                got, ref.flash_decode(q, kc, vc, cur), TOL[str(dt)])
    decode_sweep(dev)

    def timed_decode(d):
        """Kernel, plain version and SDPA at the serving shape, bf16, beside the bound."""
        dt = torch.bfloat16
        q, kc, vc = randn(8, 32, d, dt=dt), randn(8, c, 8, d, dt=dt), randn(8, c, 8, d, dt=dt)
        err = compare(f"timed inputs D = {d}", ops.flash_decode(q, kc, vc, cur),
                      ref.flash_decode(q, kc, vc, cur), 2e-2)
        q4 = q[:, :, None]                                     # (B,H,1,D)
        kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))  # (B,K,T,D)
        mask = (torch.arange(c, device=dev)[None, :] <= cur[:, None])[:, None, None, :]
        t, eager = time_ms({
            "kernel": lambda: ops.flash_decode(q, kc, vc, cur),
            "plain": lambda: ref.flash_decode(q, kc, vc, cur),
            "library": lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask,
                                                              enable_gqa=True),
        })
        used = int((cur.clamp(max=c - 1) + 1).sum())  # cache positions read
        kh, h = kc.shape[2], q.shape[1]
        nbytes = 2 * (2 * q.numel() + 2 * used * kh * d) + 4 * cur.numel()
        out = dict(max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                   **bound(nbytes, 4 * used * h * d, BF16_FLOPS), library_ms=t["library"])
        print(f"  D = {d}: device ms per call: {t}; eager ms per call: {eager}; "
              f"bound {out['bound_ms']:.6f} ms ({out['bound_by']})")
        return out

    rows.append(dict(
        name="flash_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_decode_cluster.cu",
        replaces="src/repro/kernels/flash_decode.py:91", **timed_decode(128),
        head_dim_160=timed_decode(STABLELM_D),
    ))

    print("csr_dot vs plain version (bit-exact, both gathers):")
    gg = torch.Generator(device=dev).manual_seed(1)
    for label, b, k, d in (("SVM path (webspam width)", SVM_TRAIN, SVM_NNZ[1], WEBSPAM_DIM),
                           ("ragged B and K", 2501, 4100, WEBSPAM_DIM),
                           ("kddcup10-like", 100_000, 56, KDDCUP10_DIM),
                           ("ragged B", 1001, 77, 1000)):
        idx = torch.randint(0, d, (b, k), generator=gg, device=dev, dtype=torch.int32)
        val = torch.randn(b, k, generator=gg, device=dev)
        keep = torch.randint(1, k + 1, (b, 1), generator=gg, device=dev)
        pad = torch.arange(k, device=dev)[None, :] >= keep  # pad_csr's zero suffix
        idx, val = idx.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
        idx[0, : k // 2] = idx[0, 0]  # a row listing one id many times
        w = torch.randn(d, generator=gg, device=dev)
        want = ref.csr_dot(idx, val, w)
        for gather in ("take", "onehot"):
            got = ops.csr_dot(idx, val, w, gather=gather)
            torch.cuda.synchronize()
            check_equal(f"{label} ({b}x{k}, D={d}) gather={gather}", got, want)
    idx = torch.tensor([[3, 3, 0, 0], [5, 1, 5, 5]], dtype=torch.int32, device=dev)
    val = torch.tensor([[1.5, 2.5, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0]], device=dev)
    w = torch.arange(8, dtype=torch.float32, device=dev)
    got = ops.csr_dot(idx, val, w)
    check(got.tolist() == [12.0, 42.0], f"duplicate ids: {got.tolist()}, want [12.0, 42.0]")
    before = ops.LAUNCHES["csr_dot"]
    empty = ops.csr_dot(idx[:0], val[:0], w)
    check(empty.shape == (0,) and ops.LAUNCHES["csr_dot"] == before, "B = 0 launched a kernel")
    print("  duplicate ids accumulate; B = 0 returns (0,) without a launch")
    return rows


def decode_cases():
    """(T, cur values) for flash_decode's sweep: cur at 0, at both sides of
    every 64-key tile edge (every split boundary ops._decode_splits can
    choose is one), at T-1, T and past T; one batch row per value."""
    for t in DECODE_LENGTHS:
        edges = [e for c in range(64, t, 64) for e in (c - 1, c)]
        yield t, sorted({0, *edges, t - 1, t, t + 7})


def decode_sweep(dev):
    """flash_decode against its plain version over DECODE_LENGTHS x
    DECODE_GROUPS x head dims 64/128/160 x both dtypes (two KV heads), and at
    B = 1 (the fewest blocks) at the serving widths; one line per length."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = 0
    for dt in (torch.bfloat16, torch.float32):
        for d in (64, 128, STABLELM_D):
            for t, curs in decode_cases():
                b, kh = len(curs), 2
                cur = torch.tensor(curs, dtype=torch.int32, device=dev)
                kc, vc = (torch.randn(b, t, kh, d, generator=g, device=dev).to(dt)
                          for _ in range(2))
                worst = 0.0
                for group in DECODE_GROUPS:
                    q = torch.randn(b, kh * group, d, generator=g, device=dev).to(dt)
                    got = ops.flash_decode(q, kc, vc, cur)
                    torch.cuda.synchronize()
                    worst = max(worst, compare(f"{dt} D={d} T={t} G={group}", got,
                                               ref.flash_decode(q, kc, vc, cur), TOL[str(dt)],
                                               show=False))
                    cases += 1
                kernel = ops._decode_kernel(dt, d)
                if kernel == "cluster":
                    kernel += f", splits/chunk {ops._decode_splits(b, kh, t, sms)}"
                print(f"  {dt} D={d} T={t} ({kernel}) cur={curs if len(curs) < 12 else '...'}"
                      f" groups {DECODE_GROUPS}: max_abs_err {worst:.3e} (tol {TOL[str(dt)]:g}) ok")
        for t in (160, 4096):
            q = torch.randn(1, 32, 128, generator=g, device=dev).to(dt)
            kc, vc = (torch.randn(1, t, 8, 128, generator=g, device=dev).to(dt) for _ in range(2))
            cur = torch.tensor([t - 1], dtype=torch.int32, device=dev)
            compare(f"{dt} B=1 q{tuple(q.shape)} cache{tuple(kc.shape)} cur=[{t - 1}]",
                    ops.flash_decode(q, kc, vc, cur), ref.flash_decode(q, kc, vc, cur),
                    TOL[str(dt)])
            cases += 1
    print(f"  {cases} decode cases within tolerance")


def gather_kernel_phase(dev):
    """batch_gather (K1) and batch_gather_dma (K2) against ref.batch_gather,
    bit for bit, then timed at the DNN path's shape and a bandwidth shape;
    returns their kernel rows (launches are filled in by the DNN phase)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(5)
    print("batch_gather / batch_gather_dma vs plain version (bit-exact):")
    cases = 0
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for d, b in ((40, 37), (3, 61), (4100, 9)):  # ragged B; 16/4/2-byte words; 16 KB chunks
            full = torch.randn(1025, d, generator=g, device=dev).mul(1000).to(dt)
            table = full[1:]  # 1024 rows, off a 16-byte boundary where d·elt is not
            for r in (1, 2, 4, 8):
                nb = 1024 // r
                idx = torch.randint(-nb - 5, nb + 6, (b,), generator=g, device=dev,
                                    dtype=torch.int32)
                idx[:4] = idx[4]  # duplicates; the range puts ids outside the table
                want = ref.batch_gather(table, idx, r)
                # block_d = d: 4100 is no multiple of the default 512
                got = {"batch_gather": ops.batch_gather(table, idx, block_d=d, rows_per_block=r)}
                for m in (1, 8, 16):
                    got[f"batch_gather_dma m={m}"] = ops.batch_gather_dma(
                        table, idx, block_d=d, rows_per_block=r, rows_per_step=m)
                torch.cuda.synchronize()
                for name, out in got.items():
                    cases += 1
                    check(torch.equal(out, want),
                          f"{name} {dt} d={d} B={b} r={r} differs from the plain version")
    before = dict(ops.LAUNCHES)
    for fn in (ops.batch_gather, ops.batch_gather_dma):
        check(tuple(fn(table, idx[:0], block_d=d).shape) == (0, d), "B = 0 shape")
    check(ops.LAUNCHES == before, "B = 0 launched a kernel")
    print(f"  {cases} cases bit-exact (f32/bf16/int32, rows_per_block 1/2/4/8, rows_per_step "
          f"1/8/16, ragged B, duplicate and out-of-range ids); B = 0 launches nothing")

    # batch_gather_tables: the DNN path's f32 and int32 tables with a bf16 one
    # off a 16-byte boundary, one launch each call, host ids in the launch's
    # parameters up to the cap and loaded by the kernel above it or on the card
    x = torch.randn(4096, 32, generator=g, device=dev)
    y = torch.randint(-2**31, 2**31 - 1, (4096, 1), generator=g, device=dev, dtype=torch.int32)
    z = torch.randn(4097, 3, generator=g, device=dev).to(torch.bfloat16)[1:]
    cap = ops._PARAM_IDS
    routes = {}
    for b in (1, 100, 129, cap, cap + 1, 5000):
        for r in (1, 2):
            nb = 4096 // r
            idx = torch.randint(-nb - 3, nb + 4, (b,), generator=g, device=dev, dtype=torch.int32)
            for ids in (idx.cpu(), idx):
                ops.reset_launch_counts()
                got = ops.batch_gather_tables((x, y, z), ids, block_d=1, rows_per_block=r)
                torch.cuda.synchronize()
                check(all(torch.equal(o, ref.batch_gather(t, idx, r)) for o, t in zip(got, (x, y, z)))
                      and ops.LAUNCHES["batch_gather"] == 1,
                      f"batch_gather_tables B={b} r={r} on {ids.device} differs or launched "
                      f"{ops.LAUNCHES['batch_gather']} times")
                route = ops._gather_route(ids.device.type == "cpu", b)
                check(list(ops.ENTRY_LAUNCHES) == [{"params": "repro_torch_gather_tables_params",
                                                    "load": "repro_torch_gather_tables"}[route]],
                      f"B={b} on {ids.device}: {ops.ENTRY_LAUNCHES}, want the {route} route")
                routes[route] = routes.get(route, 0) + 1
    print(f"  batch_gather_tables (f32 + int32 + bf16 off 16 bytes, one launch a call) bit-exact "
          f"at B 1-5000 around the {cap}-id cap, r 1/2, host and device ids; calls by route "
          f"{routes}")

    rows = time_gathers(dev, g)
    torch.cuda.empty_cache()  # the 2 GiB table
    return rows


def time_gathers(dev, g):
    """Both gathers, their plain version and index_select at the DNN
    path's shape (one batch's features and labels) and a bandwidth shape.
    Each timed call gathers its own ids (one set per call of the graph),
    so the bandwidth shape's rows are not all in the 50 MB L2.  K1 gathers
    the DNN pair in one launch, as ``DeviceTable.batch`` does, with host
    ids (the parameter route, the path's) and with device ids (the loading
    route); K2 makes a launch a table."""
    from repro_torch.kernels import ops, ref

    n, d, b = 20 * (IMAGENET_ROWS // 20), 32, 100
    x = torch.randn(n, d, generator=g, device=dev)
    y = torch.randint(0, 20, (n, 1), generator=g, device=dev, dtype=torch.int32)
    nbw, dbw, bbw = GATHER_BW
    big = torch.randn(nbw, dbw, generator=g, device=dev)
    shapes = [("DNN path: features + labels", (x, y), b, 1, 50),
              ("bandwidth r=1", (big,), bbw, 1, 50), ("bandwidth r=8", (big,), bbw, 8, 20)]
    rows, bandwidth = {}, {}
    for label, tables, b, r, calls in shapes:
        nb = tables[0].shape[0] // r
        ids = [torch.randint(0, nb, (b,), generator=g, device=dev, dtype=torch.int32)
               for _ in range(calls)]
        host = [i.cpu() for i in ids]

        def timed(f, ids=ids):
            it = itertools.cycle(ids)
            return lambda: f(next(it))

        def k1(i):
            return ops.batch_gather_tables(tables, i, block_d=1, rows_per_block=r)

        def k2(i):
            return [ops.batch_gather_dma(t, i, rows_per_block=r) for t in tables]

        def plain(i):
            return [ref.batch_gather(t, i, r) for t in tables]

        def library(i):
            return [t.view(nb, r * t.shape[1]).index_select(0, i) for t in tables]

        want = plain(ids[0])
        errs = {}
        for name, got in (("batch_gather", k1(host[0])), ("batch_gather (device ids)", k1(ids[0])),
                          ("batch_gather_dma", k2(ids[0]))):
            errs[name] = max(check_equal(f"{label} {name}", o, w) for o, w in zip(got, want))
        check(all(torch.equal(a.view(-1), w.view(-1)) for a, w in zip(library(ids[0]), want)),
              f"{label}: index_select differs from the plain version")
        fns = {"batch_gather": timed(k1, host), "batch_gather (device ids)": timed(k1),
               "batch_gather_dma": timed(k2), "plain": timed(plain), "library": timed(library)}
        if b > ops._PARAM_IDS:  # host ids above the cap are copied first: not graph-capturable
            del fns["batch_gather"]
        t, eager = time_ms(fns, n=calls)
        # each row read once and written once; the ids read from device
        # memory once a launch: none for K1 on host ids (they ride in the
        # launch's parameters), once for K1 on device ids (one launch for
        # every table), once a table for K2 (one launch a table)
        data = sum(2 * b * r * tb.shape[1] * tb.element_size() for tb in tables)
        nbytes = {"batch_gather": data, "batch_gather (device ids)": data + 4 * b,
                  "batch_gather_dma": data + 4 * b * len(tables)}
        bnd = {k: bound(v, 0, F32_FLOPS) for k, v in nbytes.items()}
        print(f"  {label}: B={b}, tables {[tuple(tb.shape) for tb in tables]}: device ms per "
              f"call {t}; eager ms per call {eager}; bound ms "
              f"{ {k: round(v['bound_ms'], 9) for k, v in bnd.items()} } (bytes {nbytes})")
        if label.startswith("DNN path"):
            for name in ("batch_gather", "batch_gather_dma"):
                rows[name] = dict(
                    name=name, route="cuda", source="src/repro_torch/kernels/csrc/batch_gather.cu",
                    replaces=("src/repro/kernels/batch_gather.py:63" if name == "batch_gather"
                              else "src/repro/kernels/batch_gather.py:144"),
                    max_abs_err=errs[name], ms=t[name], plain_ms=t["plain"], **bnd[name],
                    library_ms=t["library"])
            rows["batch_gather"]["device_ids_ms"] = t["batch_gather (device ids)"]
            rows["batch_gather"]["device_ids_bound_ms"] = \
                bnd["batch_gather (device ids)"]["bound_ms"]
        else:
            bandwidth[label] = {"batch_gather": (t["batch_gather (device ids)"],
                                                 bnd["batch_gather (device ids)"]["bound_ms"]),
                                "batch_gather_dma": (t["batch_gather_dma"],
                                                     bnd["batch_gather_dma"]["bound_ms"]),
                                "library": t["library"]}
    for name in ("batch_gather", "batch_gather_dma"):
        rows[name]["bandwidth_ms"] = {k: {"ms": v[name][0], "library_ms": v["library"],
                                          "bound_ms": v[name][1]} for k, v in bandwidth.items()}
    # K1's latency floor: one launch gathering one row of each DNN table
    # (host ids: the row is the block's first load; device ids: the id
    # first, then the row it names), and the features alone
    ids = [torch.randint(0, n, (1,), generator=g, device=dev, dtype=torch.int32)
           for _ in range(50)]
    host = [i.cpu() for i in ids]
    it, ih = itertools.cycle(ids), itertools.cycle(host)
    t, _ = time_ms({"features": lambda: ops.batch_gather(x, next(ih)),
                    "pair": lambda: ops.batch_gather_tables((x, y), next(ih)),
                    "pair (device ids)": lambda: ops.batch_gather_tables((x, y), next(it))})
    print(f"  K1 per-launch latency floor (B = 1 on the DNN tables): device ms per call {t}")
    rows["batch_gather"]["b1_ms"] = t
    return rows


def check_equal(label, got, want):
    same = torch.equal(got, want)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"  {label}: {'bit-exact' if same else 'DIFFERS'} (max_abs_err {err:.3e})")
    check(same, f"{label} not bit-exact")
    return err


def bound(nbytes, flops, peak_flops):
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / peak_flops
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def rglru_kernel_phase(dev):
    """rglru_scan (K5) and its reverse-time backward against their plain
    versions, bit for bit, then timed at the training path's shape;
    returns their kernel rows (launches are filled in by the training
    phase)."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(8)
    print("rglru_scan / rglru_scan_bwd vs plain versions (bit-exact):")
    inputs = {}
    for shape in SCAN_SHAPES:
        a = torch.rand(shape, generator=g, device=dev) * 0.4 + 0.6  # decays as the layer's
        x = torch.randn(shape, generator=g, device=dev)
        dh = torch.randn(shape, generator=g, device=dev)
        route = ops._scan_kernel(a, x)
        check(route == ("ring" if shape[2] % 4 == 0 else "lanes"), f"{shape} routes to {route}")
        print(f"  {shape}: {route} kernel")
        h = ops.rglru_scan(a, x)
        dx, da = ops.rglru_scan_bwd(a, h, dh)
        torch.cuda.synchronize()
        want_h = ref.rglru_scan(a, x)
        want_dx, want_da = ref.rglru_scan_bwd(a, want_h, dh)
        errs = {"rglru_scan": check_equal(f"forward {shape}", h, want_h),
                "rglru_scan_bwd": max(check_equal(f"backward dx {shape}", dx, want_dx),
                                      check_equal(f"backward da {shape}", da, want_da))}
        if not inputs:
            inputs = dict(a=a, x=x, dh=dh, h=h, errs=errs)
        del a, x, dh, h, dx, da, want_h, want_dx, want_da
    a, x, dh, h = (inputs[k] for k in ("a", "x", "dh", "h"))
    b, t, w = a.shape
    rows = {}
    for name, kernel, plain, nbytes in (
        ("rglru_scan", lambda: ops.rglru_scan(a, x), lambda: ref.rglru_scan(a, x),
         3 * b * t * w * 4),  # a, x in; h out
        ("rglru_scan_bwd", lambda: ops.rglru_scan_bwd(a, h, dh),
         lambda: ref.rglru_scan_bwd(a, h, dh), 5 * b * t * w * 4),  # a, h, dh in; dx, da out
    ):
        tk, ek = time_ms({"kernel": kernel}, n=20)
        tp, ep = time_ms({"plain": plain}, n=1)  # a graph of T steps' small ops
        flops = (2 if name == "rglru_scan" else 3) * b * t * w
        rows[name] = dict(
            name=name, route="cuda", source="src/repro_torch/kernels/csrc/rglru_scan.cu",
            replaces="src/repro/kernels/rglru_scan.py:58", max_abs_err=inputs["errs"][name],
            ms=tk["kernel"], plain_ms=tp["plain"], **bound(nbytes, flops, F32_FLOPS),
            library_ms=None)
        print(f"  {name} {tuple(a.shape)}: device ms per call kernel {tk['kernel']:.6f}, plain "
              f"{tp['plain']:.3f}; eager ms per call kernel {ek['kernel']:.6f}, plain "
              f"{ep['plain']:.3f}; bound {rows[name]['bound_ms']:.6f} ms ({nbytes} bytes, "
              f"{rows[name]['bound_by']}); no PyTorch call computes a linear recurrence")
    return rows


# ---------------------------------------------------- model, small size


def model_phase(dev):
    """The port on the card (kernels) against the port on the CPU (plain
    versions), smoke granite, same weights and inputs."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    # float32: the point is the algorithm, and bf16 matrix products round
    # differently on the card and the CPU (the kernels' bf16 results are
    # held to their plain versions on the card above)
    print("model on the card vs on the CPU (smoke granite, float32):")
    cfg = get_config("granite-3-8b", smoke=True).replace(dtype="float32")
    cpu = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    gpu = M.tree_map(lambda x: x.to(dev), cpu)
    toks = torch.randint(1, cfg.vocab_size, (1, 37), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([29], dtype=torch.int32)
    outs = {}
    for name, params, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        arena = M.init_decode_cache(cfg, 4, 48, d, pos=torch.tensor([0, 5, 47, 60]))
        pre, plog = M.prefill_at(cfg, params, toks.to(d), lens.to(d))
        arena = M.write_prefill_slot(cfg, arena, 0, pre)
        arena, dlog = M.decode_step(cfg, params, arena, torch.full((4, 1), 7, device=d))
        outs[name] = (plog, dlog)
    for i, what in enumerate(("prefill_at logits", "decode_step logits (per-row pos)")):
        want, got = outs["cpu"][i], outs["gpu"][i].cpu()
        check(got.shape == want.shape, f"{what}: shape {got.shape} vs {want.shape}")
        compare(f"{what} {tuple(got.shape)}", got, want, 1e-4)
    for arch in (WHISPER_ARCH, QWEN_VL_ARCH):
        extras_card_vs_cpu_check(dev, arch)


def _worst_leaf(got, want):
    """The largest |card - CPU| over a list of leaves, each as a share of
    the CPU leaf's largest entry."""
    return max(float((g.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
               for g, w in zip(got, want))


def _smoke_extras(cfg, b, n, device):
    """The batch extras of a smoke config: seeded frames for an encoder,
    Qwen2-VL positions (one image of 2 x 3 patches) for M-RoPE."""
    from repro_torch.layers.positional import vl_positions

    if cfg.encoder is not None:
        enc = cfg.encoder
        return {"encoder_frames": torch.randn(b, enc.num_frames, enc.d_input,
                                              generator=torch.Generator().manual_seed(4))}
    return {"positions_3d": vl_positions(n, 3, (2, 3))[None].repeat(b, 1, 1)}


def extras_card_vs_cpu_check(dev, arch):
    """Smoke ``arch`` (whisper-tiny: encoder frames; qwen2-vl-72b:
    ``positions_3d``) in f32 on the card (the kernels) against the CPU
    (their plain versions), same weights and inputs: the loss and every
    gradient leaf (to 1e-4 of the leaf's largest entry), the prefill's
    logits and every cache leaf, then ``extend_cache`` and 4 decode steps
    (qwen2-vl with each step's (B, 3, 1) positions), at 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    print(f"{arch} smoke (f32) on the card vs on the CPU: loss, gradients, prefill, decode")
    init = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    n, p = 21, 16
    toks = torch.randint(1, cfg.vocab_size, (2, n), generator=torch.Generator().manual_seed(2))
    extras = _smoke_extras(cfg, 2, n, "cpu")
    steps = "positions_3d" in extras
    outs = {}
    for d in ("cpu", dev):
        ex = {k: v.to(d) for k, v in extras.items()}
        train = {k: v[..., :n - 1] if k == "positions_3d" else v for k, v in ex.items()}
        leaves = [x.to(d, copy=True).requires_grad_() for x in tree_leaves(init)]
        loss, _ = M.loss_fn(cfg, tree_unflatten(init, leaves),
                            {"tokens": toks[:, :-1].to(d), "labels": toks[:, 1:].to(d), **train})
        grads = torch.autograd.grad(loss, leaves)
        params = tree_map(lambda x: x.to(d), init)
        pre = {k: v[..., :p] if k == "positions_3d" else v for k, v in ex.items()}
        cache, plog = M.prefill(cfg, params, toks[:, :p].to(d), pre)
        cache_leaves = [x.clone() for x in tree_leaves(cache["stages"])]
        cache = M.extend_cache(cfg, cache, n - p)
        dlogs = []
        for i in range(p, n):
            step = {"positions_3d": ex["positions_3d"][..., i:i + 1]} if steps else None
            cache, lg = M.decode_step(cfg, params, cache, toks[:, i:i + 1].to(d), step)
            dlogs.append(lg)
        outs[d] = (loss.detach(), grads, plog, cache_leaves, torch.stack(dlogs))
    (closs, cgrads, cplog, cleaves, cdec), (gloss, ggrads, gplog, gleaves, gdec) = (
        outs["cpu"], outs[dev])
    compare("loss", gloss.cpu(), closs, 1e-4)
    worst = _worst_leaf(ggrads, cgrads)
    print(f"  {len(ggrads)} gradient leaves: worst |card - CPU| {worst:.2e} of the leaf's "
          "largest entry (tol 1e-4)")
    check(worst <= 1e-4, f"{arch}: a gradient leaf differs")
    compare(f"prefill logits {tuple(gplog.shape)}", gplog.cpu(), cplog, 1e-4)
    worst = _worst_leaf(gleaves, cleaves)
    print(f"  prefill cache: {len(gleaves)} leaves, worst {worst:.2e} of the leaf's largest "
          "entry (tol 1e-4)")
    check(worst <= 1e-4, f"{arch}: a prefill cache leaf differs")
    compare(f"{n - p} decode steps' logits {tuple(gdec.shape)}", gdec.cpu(), cdec, 1e-4)


def train_step_phase(dev):
    """One train step (loss, autograd, AdamW) of smoke recurrentgemma in
    float32 on the card (the scan kernels) against the same step on the
    CPU (their plain versions), from the same weights and batch."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config("recurrentgemma-2b", smoke=True).replace(dtype="float32")
    print("train step on the card vs on the CPU (smoke recurrentgemma, float32, seq 32 > "
          f"window {cfg.local_window}):")
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    toks = torch.randint(0, cfg.vocab_size, (2, 33), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    init = init_train_state(cfg, torch.Generator().manual_seed(1), AdamW(opt_cfg), "cpu")
    outs = {}
    for d in ("cpu", dev):
        state = tree_map(lambda x: x.clone().to(d), init)
        before = dict(ops.LAUNCHES)
        state, out = make_train_step(cfg, AdamW(opt_cfg))(state, {k: v.to(d) for k, v in batch.items()})
        torch.cuda.synchronize()
        outs[d] = (state, {k: float(v) for k, v in out.items()},
                   {k: ops.LAUNCHES[k] - before[k] for k in before})
    (cs, co, _), (gs, go, glaunch) = outs["cpu"], outs[dev]
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    check(glaunch["rglru_scan"] == 2 * rg and glaunch["rglru_scan_bwd"] == rg,
          f"scan launches {glaunch} for {rg} RG-LRU layers")
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        err = abs(go[k] - co[k]) / abs(co[k])
        print(f"  {k}: card {go[k]:.7f}, CPU {co[k]:.7f}, relative error {err:.2e} (tol {tol:g})")
        check(err <= tol, f"train step {k} differs")
    # The step's clipped gradients, from the first moments (mu = (1 - b1)·g
    # after one step): each leaf to 1e-4 of its largest entry, as the CPU
    # tests hold the port's gradients to JAX's.  The weights then differ by
    # what Adam's first step, lr·m̂/(sqrt(v̂) + eps), makes of the two
    # gradients (near g = 0 it magnifies their last digits): each weight is
    # held to that propagated difference + 1e-6 + 1e-5·|p|.
    c = opt_cfg
    grad_err, p_err, worst = 0.0, 0.0, 0.0
    for pg, pc, mg, mc, vg, vc in zip(
            tree_leaves(gs["params"]), tree_leaves(cs["params"]),
            tree_leaves(gs["opt"]["mu"]), tree_leaves(cs["opt"]["mu"]),
            tree_leaves(gs["opt"]["nu"]), tree_leaves(cs["opt"]["nu"])):
        pg, mg, vg = pg.cpu(), mg.cpu(), vg.cpu()
        e = float((mg - mc).abs().max()) / max(float(mc.abs().max()), 1e-30)
        grad_err = max(grad_err, e)
        step_g = (mg / (1 - c.b1)) / ((vg / (1 - c.b2)).sqrt() + c.eps)
        step_c = (mc / (1 - c.b1)) / ((vc / (1 - c.b2)).sqrt() + c.eps)
        allowed = co["lr"] * (step_g - step_c).abs() + 1e-6 + 1e-5 * pc.abs()
        diff = (pg - pc).abs()
        p_err = max(p_err, float(diff.max()))
        worst = max(worst, float((diff / allowed).max()))
    print(f"  gradients (first moments): max error {grad_err:.2e} of each leaf's largest entry "
          f"(tol 1e-4); updated parameters: max_abs_err {p_err:.3e}, at most {worst:.3f} of the "
          f"propagated tolerance; scan launches {glaunch['rglru_scan']} forward, "
          f"{glaunch['rglru_scan_bwd']} backward for {rg} RG-LRU layers")
    check(grad_err <= 1e-4, "train step gradients differ")
    check(worst <= 1.0, "updated parameters differ")


def linear_svm_phase(dev, steps=4):
    """LinearSVM on the card against the CPU: a few train_batch steps on
    one dense batch at epsilon's width, float32 with TF32 off."""
    import numpy as np

    from repro_torch.svm import LinearSVM

    print(f"LinearSVM on the card vs on the CPU ({EPSILON_DIM} features, float32):")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(512, EPSILON_DIM)).astype(np.float32)
    y = np.where(x @ rng.normal(size=EPSILON_DIM) > 0, 1.0, -1.0).astype(np.float32)
    models = {d: LinearSVM(EPSILON_DIM, lam=1e-4, lr=0.05, device=d) for d in ("cpu", dev)}
    losses = {d: torch.tensor([m.train_batch(x, y, inner_steps=2) for _ in range(steps)])
              for d, m in models.items()}
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    cpu, gpu = models["cpu"], models[dev]
    compare(f"loss over {steps} steps", losses[dev], losses["cpu"], 1e-5)
    compare("w", gpu.w.cpu(), cpu.w, 1e-5)
    compare("b", gpu.b.cpu().reshape(1), cpu.b.reshape(1), 1e-5)
    check(losses["cpu"][-1] < losses["cpu"][0], "LinearSVM loss did not fall")


# ------------------------------------------------------- the main path


def serve_phase():
    """The serving path twice at full width: ``SERVE_ARGS`` (the feature
    tier off), then with the request-stream feature tier on; each run's
    launches are counted from 0.  Returns the first run's launches."""
    import gc

    launches, _ = serve_run(SERVE_ARGS)
    gc.collect()
    torch.cuda.empty_cache()  # the first engine's 8 B parameters
    serve_run(SERVE_ARGS + SERVE_TIER_FLAGS, _check_feature_tier)
    return launches


def _check_feature_tier(report):
    fc = report["feature_cache"]
    print(f"  feature tier: {json.dumps(fc)}")
    n = report["requests"] * SERVE_FEATURES_PER_REQUEST
    check(fc["hits"] + fc["misses"] == n, f"{fc['hits']} + {fc['misses']} feature reads, want {n}")
    check(fc["storage_cache_hits"] == fc["hits"],
          f"IOStats counts {fc['storage_cache_hits']} cache hits, the tier {fc['hits']}")
    check(fc["storage_records_read"] == fc["misses"],
          f"storage read {fc['storage_records_read']} records for {fc['misses']} misses")
    check(fc["capacity_records"] == SERVE_CACHE_RECORDS,
          f"the tier holds {fc['capacity_records']} records, want {SERVE_CACHE_RECORDS}")


def serve_run(args, extra_check=None):
    """One run of the serving launcher at the full width and depth of
    ``args``' arch, its launches counted from 0: every request done, no
    slot leak, one K4 launch a layer per prefill (on the kernel
    ``ops._attention_kernel`` routes the config to) and one K6 launch (on
    the cluster kernel) a layer per decode step, the warmup's included.
    Returns the launches and the report."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    arch = args[args.index("--arch") + 1]
    print(f"serving {arch} at full width:", " ".join(args))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    report = serve.main(args)
    launches = dict(ops.LAUNCHES)
    entries = dict(ops.ENTRY_LAUNCHES)
    print(f"  serve run incl. init {time.perf_counter() - t0:.1f} s; launches {launches}")
    cfg = get_config(arch)
    layers = cfg.num_layers
    check(report["arch"] == arch, "not the full-width config")
    check(report["requests"] == 16, f"{report['requests']} of 16 requests completed")
    check(report["slot_leaks"] == 0, f"{report['slot_leaks']} slots leaked")
    want_fa = layers * (report["prefills"] + 1)
    want_fd = layers * (report["decode_steps"] + 1)
    check(launches["flash_attention"] == want_fa,
          f"flash_attention launched {launches['flash_attention']} times, want {want_fa}")
    check(launches["flash_decode"] == want_fd,
          f"flash_decode launched {launches['flash_decode']} times, want {want_fd}")
    entry = entries.get("repro_torch_flash_decode_cluster", 0)
    check(entry == want_fd, f"the cluster kernel ran {entry} of {want_fd} decode launches")
    fa_entry = "repro_torch_flash_attention" + (
        "_wgmma" if ops._attention_kernel(cfg.compute_dtype, cfg.kq_dim,
                                          cfg.num_heads // cfg.num_kv_heads) == "wgmma" else "")
    entry = entries.get(fa_entry, 0)
    check(entry == want_fa, f"{fa_entry} ran {entry} of {want_fa} prefill launches")
    print(f"  launches by entry point {entries}")
    if extra_check is not None:
        extra_check(report)
    return launches, report


def profile_phase(dev, arch="granite-3-8b", params=None, steps=5):
    """Where a steady decode step's time goes: all 8 slots live at full
    width, ``steps`` engine steps under torch.profiler; prints device time
    by kernel, device time per step and the device's busy share of the
    wall time; for a MoE config also device time by operation class
    (``_moe_classes``).  Runs after the main path, so its launches are not
    counted there.  Returns the engine (8 live slots)."""

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)
    if params is None:
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, max_batch=8, prompt_capacity=128, max_new_tokens=32)
    eng.warmup()
    rng = torch.Generator().manual_seed(3)
    for rid in range(8):
        prompt = torch.randint(1, cfg.vocab_size, (100,), generator=rng).numpy().astype("int32")
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=32))
    eng.step()  # admits all 8 and decodes once
    eng.step()
    torch.cuda.synchronize()
    prof, events, wall = _profiled(eng.step, steps, record_shapes=cfg.moe is not None)
    check(eng.active == 8, "profiled steps lost a slot")
    device_us = sum(e.self_device_time_total for e in events)
    print(f"profile of {steps} decode steps ({arch}, 8 live slots, full width): "
          f"wall {1e3 * wall / steps:.2f} ms/step, device busy "
          f"{1e-3 * device_us / steps:.2f} ms/step, busy share "
          f"{1e-6 * device_us / wall:.3f}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
              f"{e.count // steps:5d} calls/step  {e.key[:100]}")
    if cfg.moe is not None:
        split = _moe_classes(prof, cfg.moe.num_experts)
    else:
        split = _dense_classes(prof, events)
    print("  device ms/step by operation: " + ", ".join(
        f"{c} {v / steps / 1e3:.2f} ({v / max(device_us, 1):.3f})" for c, v in split.items()))
    return eng


def _dense_classes(prof, events):
    """Device microseconds of a dense decode step by what launched them:
    the f32 -> bf16 weight casts (``aten::_to_copy``), the matrix products
    (``aten::matmul``: projections, FFN, logits) and ``flash_decode``
    (the cluster kernel's own device time)."""
    from torch.autograd import DeviceType

    casts = matmul = 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        if e.key == "aten::_to_copy":
            casts += e.device_time_total
        elif e.key == "aten::matmul":
            matmul += e.device_time_total
    decode = sum(e.self_device_time_total for e in events if "fd_cluster" in e.key)
    return {"casts": casts, "GEMMs": matmul, "flash_decode": decode}


def _moe_classes(prof, experts):
    """Device microseconds of a MoE step by the operations that launched
    them: the experts' products (``aten::bmm`` batched over the E
    experts), the rest of the einsums (the dispatch and combine products
    and their operands' copies), the other matrix products
    (``aten::matmul``, every ``@``: attention, shared experts, logits) and
    the f32 -> bf16 casts (``aten::_to_copy``: the weights', chiefly).
    Reads the profile's CPU operations with their input shapes (an
    einsum's operands are not recorded, its ``bmm``'s are)."""
    from torch.autograd import DeviceType

    einsum = experts_us = matmul = casts = 0.0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.device_type != DeviceType.CPU:
            continue
        if e.key == "aten::einsum":
            einsum += e.device_time_total
        elif e.key == "aten::bmm" and e.input_shapes and e.input_shapes[0][:1] == [experts]:
            experts_us += e.device_time_total
        elif e.key == "aten::matmul":
            matmul += e.device_time_total
        elif e.key == "aten::_to_copy":
            casts += e.device_time_total
    return {"dispatch and combine": einsum - experts_us, "expert GEMMs": experts_us,
            "other GEMMs": matmul, "casts": casts}


class _EventTimed:
    """Brackets every ``ops.csr_dot`` call of a scope with CUDA events, so
    the kernel's device time on the path is read off the card; the
    launch count stays the wrapper's own."""

    def __init__(self, ops):
        self.ops, self.pairs = ops, []

    def __enter__(self):
        inner = self.inner = self.ops.csr_dot

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            stop.record()
            self.pairs.append((start, stop))
            return out

        self.ops.csr_dot = timed
        return self

    def __exit__(self, *exc):
        self.ops.csr_dot = self.inner

    def device_ms(self):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


def _tier_counters(plane):
    """The tier's cumulative counters, as the training summary's ``cache``
    block names them."""
    return {"demand_hits": plane.cache.hits, "demand_misses": plane.cache.misses,
            "window_hits": plane.scheduler.window_hits,
            "prefetched_records": plane.prefetch_records,
            "rejected_inserts": plane.cache.rejected, "planned_skips": plane.cache.planned_skips}


def svm_tier_bytes_check(tiered, direct):
    """Reads every batch of both epochs through a tiered plane and the
    direct plane; each batch's lengths and every record's payload must be
    equal (the tier moves bytes, never changes them)."""
    import numpy as np

    t0, records = time.perf_counter(), 0
    try:
        for epoch in range(SVM_EPOCHS):
            for idx in tiered.batch_iter(epoch):
                got, want = tiered(idx), direct(idx)
                check(np.array_equal(got.lengths, want.lengths),
                      f"epoch {epoch}: a tiered batch's lengths differ from the direct read's")
                for i in range(len(want)):
                    check(np.array_equal(got.record(i), want.record(i)),
                          f"epoch {epoch}: record {idx[i]} differs through the tier")
                records += len(want)
    finally:
        tiered.close()
    print(f"  tier byte check: {records} records over {SVM_EPOCHS} epochs identical to the "
          f"direct read ({tiered.cache.hits} served from DRAM) in {time.perf_counter() - t0:.1f} s")


def svm_phase(dev, seed=0):
    """The sparse-SVM training path at webspam width, driven as the JAX
    package's acceptance test drives it; returns csr_dot's kernel row."""
    import tempfile

    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import (InputPipeline, LIRSShuffler, LocationGenerator,
                                  ReadPathConfig, build_data_plane, close_data_plane)
    from repro_torch.data.synthetic import make_classification_dataset
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import drift, trace
    from repro_torch.storage import RaggedBufferRing, RecordStore
    from repro_torch.storage.record_store import IOStats
    from repro_torch.svm import pack_csr_batch, pad_csr
    from repro_torch.svm.dcd import DCDSolver

    n, dim = SVM_TRAIN + SVM_TEST, WEBSPAM_DIM
    print(f"sparse SVM at webspam width: D={dim}, {SVM_TRAIN} train + {SVM_TEST} held-out "
          f"rows, nnz {SVM_NNZ}, LIRS blocks of {SVM_BLOCK}, {SVM_SWEEPS} DCD sweeps, "
          f"{SVM_EPOCHS} epochs, seed {seed}")
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        t0 = time.perf_counter()
        meta = make_classification_dataset(
            os.path.join(tmp, "webspam.rrec"), n, dim, sparse=True,
            nnz_range=SVM_NNZ, noise=0.05, seed=seed)
        t_gen = time.perf_counter() - t0
        store = RecordStore(meta.path)
        loc = LocationGenerator().generate(store)
        train = pack_csr_batch(store.read_batch_ragged(np.arange(SVM_TRAIN)), dim)
        test = pack_csr_batch(store.read_batch_ragged(np.arange(SVM_TRAIN, n)), dim)
        print(f"  set-up: {meta.total_bytes / 1e6:.1f} MB of records written in {t_gen:.1f} s, "
              f"locations in {loc.build_seconds:.1f} s; mean nnz {train.nnz / SVM_TRAIN:.1f}")

        sh = LIRSShuffler(SVM_TRAIN, SVM_BLOCK, seed=seed)
        ring = RaggedBufferRing(SVM_BLOCK * (8 + 8 * SVM_NNZ[1]), SVM_BLOCK, depth=4)
        # the tier: a Belady DRAM cache of a quarter of the training rows'
        # bytes, fed along the shuffler's index stream
        budget = int(SVM_CACHE_FRAC * store.lengths()[:SVM_TRAIN].sum())

        def tiered(ring=None):
            return build_data_plane(store, ReadPathConfig(
                mode="ragged", ring=ring, workers=4, shuffler=sh, cache_budget_bytes=budget,
                eviction_policy="belady", max_epochs=SVM_EPOCHS))

        svm_tier_bytes_check(tiered(), build_data_plane(
            store, ReadPathConfig(mode="ragged", workers=4)))
        plane = tiered(ring)
        print(f"  tier: budget {budget / 1e6:.1f} MB, {plane.cache.capacity} slots of "
              f"{plane.cache.slot_bytes} B ({plane.cache.capacity / SVM_TRAIN:.4f} of the rows), "
              f"lookahead {plane.scheduler.lookahead} batches, planner {plane.planner}")
        solver = DCDSolver(dim, SVM_TRAIN, device=dev)
        host = {"dcd": 0.0, "pack": 0.0, "wait": 0.0}
        consumed, margin_calls, objs, accs = 0, 0, [], []
        store.stats.reset()
        snaps = [store.stats.snapshot()]
        tier_before = _tier_counters(plane)

        ops.reset_launch_counts()
        with trace.tracing() as rec, _EventTimed(ops) as ev, \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for epoch in range(SVM_EPOCHS):
                # the shuffler's batches and the pipeline's items arrive in
                # the same order, so row j of a batch owns dual idx[j]
                idx_iter = sh.epoch_batches(epoch)
                pipe = InputPipeline(plane.batch_iter, plane, prefetch=2,
                                     num_producers=2, recycle_fn=ring.recycle)
                for item in pipe.epoch(epoch):
                    idx = next(idx_iter)
                    t1 = time.perf_counter()
                    csr = pack_csr_batch(item, dim)
                    t2 = time.perf_counter()
                    solver.solve_block_csr(csr, idx, sweeps=SVM_SWEEPS)
                    host["pack"] += t2 - t1
                    host["dcd"] += time.perf_counter() - t2
                    consumed += len(csr)
                host["wait"] += pipe.stats.t_wait
                snaps.append(store.stats.snapshot())
                d, tier_now = IOStats.delta(snaps[-1], snaps[-2]), _tier_counters(plane)
                print(f"  epoch {epoch} reads: storage {d['batch_records']} records, "
                      f"{d['bytes_read'] / 1e6:.1f} MB in {d['batch_ios']} I/Os; tier " + ", ".join(
                          f"{k} {tier_now[k] - tier_before[k]}" for k in tier_now))
                tier_before = tier_now
                objs.append(solver.primal_objective_csr(train))
                margins = solver.margins_csr(test)
                margin_calls += 2
                accs.append(float((np.where(margins >= 0, 1.0, -1.0) == test.labels).mean()))
                print(f"  epoch {epoch}: primal objective {objs[-1]:.6f}, held-out accuracy "
                      f"{accs[-1]:.4f}, {time.perf_counter() - t0:.1f} s")
            train_acc = float((np.where(solver.margins_csr(train) >= 0, 1.0, -1.0)
                               == train.labels).mean())
            margin_calls += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = ops.LAUNCHES["csr_dot"]
        close_data_plane(plane)
        check(store.stats.cache_hits == plane.cache.hits,
              f"IOStats counts {store.stats.cache_hits} cache hits, the tier {plane.cache.hits}")
        check(plane.cache.hits + plane.cache.misses == SVM_EPOCHS * SVM_TRAIN,
              f"the tier served {plane.cache.hits + plane.cache.misses} records")
        d = IOStats.delta(snaps[2], snaps[1])
        report = drift.single_host_report(
            n_records=SVM_TRAIN, record_bytes=store.record_size or 0,
            capacity_frac=min(1.0, plane.cache.capacity / SVM_TRAIN), policy="belady",
            planner_on=bool(plane.planner),
            window_frac=min(1.0, plane.scheduler.lookahead * SVM_BLOCK / SVM_TRAIN),
            batch_frac=SVM_BLOCK / SVM_TRAIN, epochs=1, storage_records=d["batch_records"],
            storage_ios=d["batch_ios"], storage_bytes=d["bytes_read"])
        print(f"  drift report, epoch 1: {json.dumps(report.to_dict())}")
        kernel_ms = ev.device_ms()
        spans = {}
        for e in rec.drain():
            if e["ph"] == "X":
                spans[e["name"]] = spans.get(e["name"], 0.0) + e["dur"] / 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        check(bool(events), "the profiler recorded no device activity")
        busy_s = sum(e.self_device_time_total for e in events) / 1e6

        print(f"  phase wall {wall:.2f} s over {SVM_EPOCHS} epochs; host: DCD {host['dcd']:.2f} s, "
              f"CSR packing {host['pack']:.2f} s, pad_csr {spans.get('svm/pad', 0):.2f} s, "
              f"host-to-device copy {spans.get('svm/h2d', 0):.2f} s, csr_dot call and "
              f"copy back {spans.get('svm/csr_dot', 0):.2f} s, waiting on reads "
              f"{host['wait']:.2f} s")
        print(f"  csr_dot: {launches} launches, {kernel_ms:.3f} ms on the device (CUDA "
              f"events); device busy {busy_s * 1e3:.1f} ms, busy share {busy_s / wall:.5f}")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:5]:
            print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:5d} calls  {e.key[:90]}")
        print(f"  training accuracy {train_acc:.4f}; held-out accuracy by epoch {accs}")

        check(consumed == SVM_EPOCHS * SVM_TRAIN,
              f"consumed {consumed} rows, want {SVM_EPOCHS * SVM_TRAIN}")
        check(all(np.isfinite(objs)) and objs[1] < objs[0],
              f"objective did not fall from epoch 1 to 2: {objs}")
        check(train_acc > 0.99, f"training accuracy {train_acc}")
        check(launches == margin_calls,
              f"csr_dot launched {launches} times for {margin_calls} margins_csr calls")
        # the held-out margins against a host f64 CSR product of the same
        # f32 weights: the kernel's f32 sum of |terms| bounds the error
        rows = np.repeat(np.arange(len(test)), np.diff(test.row_ptr))
        w32 = solver.w.astype(np.float32).astype(np.float64)
        terms = test.values.astype(np.float64) * w32[test.indices]
        host_m = np.bincount(rows, terms, minlength=len(test))
        scale = np.bincount(rows, np.abs(terms), minlength=len(test))
        check(bool((np.abs(margins - host_m) <= 1e-5 * scale).all()),
              "held-out margins disagree with the host CSR product")
        host_acc = float((np.where(host_m >= 0, 1.0, -1.0) == test.labels).mean())
        print(f"  held-out margins match the host f64 product; accuracy from host margins "
              f"{host_acc:.4f}")

        # csr_dot timed on the path's training-set call
        idx2d, val2d = pad_csr(train)
        idx, val = torch.from_numpy(idx2d).to(dev), torch.from_numpy(val2d).to(dev)
        w = torch.from_numpy(solver.w.astype(np.float32)).to(dev)
        err = check_equal(f"training-set call {tuple(idx.shape)}", ops.csr_dot(idx, val, w),
                          ref.csr_dot(idx, val, w))
        w2 = w[:, None]
        t, eager = time_ms({
            "kernel": lambda: ops.csr_dot(idx, val, w),
            "plain": lambda: ref.csr_dot(idx, val, w),
            "library": lambda: F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0],
        }, n=20)
        lib_err = float((F.embedding_bag(idx, w2, per_sample_weights=val, mode="sum")[:, 0]
                         - ref.csr_dot(idx, val, w)).abs().max())
        b, k = idx.shape
        distinct = int(torch.unique(idx).numel())
        nbytes = 8 * b * k + 4 * distinct + 4 * b
        row = dict(name="csr_dot", route="cuda", source="src/repro_torch/kernels/csrc/csr_dot.cu",
                   replaces="src/repro/kernels/csr_dot.py:88", launches=launches,
                   max_abs_err=err, ms=t["kernel"], plain_ms=t["plain"],
                   **bound(nbytes, 2 * b * k, F32_FLOPS), library_ms=t["library"])
        print(f"  device ms per call: {t}; eager ms per call: {eager}; {distinct} distinct ids; "
              f"bound {row['bound_ms']:.6f} ms ({row['bound_by']}); embedding_bag's "
              f"max_abs_err {lib_err:.3e}")
        store.close()
    return row


def dnn_phase(dev, seed=0):
    """The DNN path (paper Tables 6-7) at ImageNet-1k's row count, driven
    through dnn/convergence.py: TFIP (queue 10,000) against LIRS, every
    batch gathered on the card by batch_gather (K1); then LIRS's first
    epoch replayed with batch_gather_dma (K2) from the same weights.
    Returns the launches of K1 on the main run and of K2 on the replay."""
    import numpy as np

    from repro_torch.core.shuffler import LIRSShuffler, TFIPShuffler
    from repro_torch.data.device_table import DeviceTable
    from repro_torch.dnn import convergence as C
    from repro_torch.dnn.mlp import MLPClassifier, make_clustered_data
    from repro_torch.kernels import ops

    hidden = C.MODELS[DNN_MODEL]
    print(f"DNN path: {IMAGENET_ROWS} rows requested, DIM {C.DIM}, {C.CLASSES} classes, "
          f"{DNN_MODEL} {hidden}, batch {C.BATCH}, TFIP queue {DNN_QUEUE} vs LIRS, "
          f"{DNN_EPOCHS} epochs each, seed {seed}, gather=block")
    order_s = []
    epoch_order = TFIPShuffler.epoch_order

    def timed_order(self, epoch):  # the host time of TFIP's window shuffle
        t = time.perf_counter()
        out = epoch_order(self, epoch)
        order_s.append(time.perf_counter() - t)
        return out

    runs = []
    TFIPShuffler.epoch_order = timed_order
    try:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = C.compute(n=IMAGENET_ROWS, queue=DNN_QUEUE, epochs=DNN_EPOCHS,
                        models={DNN_MODEL: hidden}, seeds=(seed,), gather="block",
                        device=dev, runs=runs)[DNN_MODEL]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, entries = dict(ops.LAUNCHES), dict(ops.ENTRY_LAUNCHES)
    finally:
        TFIPShuffler.epoch_order = epoch_order
    n = runs[0][3].rows // DNN_EPOCHS
    steps = sum(len(e) for *_, r in runs for e in r.losses)
    print(f"  phase wall {wall:.2f} s incl. set-up; TFIP's epoch_order on the host "
          f"{sum(order_s):.2f} s ({', '.join(f'{x:.2f}' for x in order_s)}); launches {launches}")
    for _, _, kind, r in runs:
        print(f"  {kind}: {r.rows} rows in {sum(map(len, r.losses))} steps, {r.seconds:.2f} s, "
              f"{sum(map(len, r.losses)) / r.seconds:.1f} steps/s; validation loss by epoch "
              f"{r.val_loss}")
    print(f"  result: {json.dumps(res)}")

    xs, ys, centers = make_clustered_data(IMAGENET_ROWS, C.DIM, C.CLASSES, seed=42,
                                          class_sorted=True, spread=1.0)
    xval, yval, _ = make_clustered_data(2000, C.DIM, C.CLASSES, seed=7, class_sorted=False,
                                        centers=centers)
    check(len(xs) == n == 20 * (IMAGENET_ROWS // 20), f"table of {len(xs)} rows, runs of {n} per epoch")
    # TFIP's class-skewed batches can leave its validation loss above where
    # it started, or drive it past f32's range (the reference does the same
    # on the same data: the class read last dominates); LIRS's must fall,
    # and reach TFIP's minimum, where that is finite, within the epochs
    # (Table 6's direction)
    for _, _, kind, r in runs:
        check(r.rows == DNN_EPOCHS * n, f"{kind} consumed {r.rows} rows, want {DNN_EPOCHS * n}")
        start = MLPClassifier(C.DIM, C.CLASSES, hidden, device=dev, params=r.init).loss(xval, yval)
        print(f"  {kind}: validation loss {start:.4f} before training, {r.val_loss} after each "
              f"epoch; step losses finite in {sum(np.isfinite(e).sum() for e in r.losses)} of "
              f"{sum(map(len, r.losses))} steps")
        if kind == "lirs":
            check(all(np.isfinite(r.val_loss)) and r.val_loss[-1] < start,
                  f"LIRS's validation loss {r.val_loss} did not fall from {start:.4f}")
    if np.isfinite(res["val_traj_tfip"][-1]):  # np.minimum.accumulate keeps a NaN, as in JAX
        check(res["epochs_lirs_mean"] <= DNN_EPOCHS,
              f"LIRS did not reach TFIP's minimum validation loss in {DNN_EPOCHS} epochs")
    check(launches["batch_gather"] == steps
          and entries.get("repro_torch_gather_tables_params") == steps,
          f"batch_gather launched {launches['batch_gather']} times ({entries}) for {steps} "
          "steps, want one launch a step with the ids in its parameters")
    check(launches["batch_gather_dma"] == 0, "batch_gather_dma launched on the block run")
    check(res["acc_lirs"] > res["acc_tfip"],
          f"LIRS test accuracy {res['acc_lirs']} not above TFIP's {res['acc_tfip']}")

    # LIRS's first epoch again with batch_gather_dma, from the same weights
    lirs = runs[1][3]
    dma = DeviceTable(xs, ys, dev, gather="dma")
    ops.reset_launch_counts()
    replay = C.train(dma, hidden, LIRSShuffler(n, C.BATCH, seed=seed), 1, seed,
                     init=lambda dims, s: lirs.init)
    torch.cuda.synchronize()
    dma_launches = ops.LAUNCHES["batch_gather_dma"]
    check(ops.LAUNCHES["batch_gather"] == 0, "batch_gather launched on the dma replay")
    check(dma_launches == 2 * len(replay.losses[0]),
          f"batch_gather_dma launched {dma_launches} times for {len(replay.losses[0])} steps")
    # the same bytes in, the same kernels and sums after: identical losses
    diff = max(abs(a - b) for a, b in zip(replay.losses[0], lirs.losses[0]))
    check(replay.losses[0] == lirs.losses[0],
          f"dma replay's step losses differ from the block run's (max {diff:.3e})")
    print(f"  dma replay of LIRS epoch 0: {len(replay.losses[0])} steps, {replay.seconds:.2f} s, "
          f"step losses identical to the block run's; launches {dma_launches}")

    # one epoch of each shuffler's batches, gathered by both kernels,
    # against xs[idx] taken on the host
    block = DeviceTable(xs, ys, dev, gather="block")
    for sh in (LIRSShuffler(n, C.BATCH, seed=seed),
               TFIPShuffler(n, C.BATCH, queue_size=DNN_QUEUE, seed=seed)):
        batches = list(sh.epoch_batches(0))
        check(len(batches) == -(-n // C.BATCH) and len(batches[-1]) == (n % C.BATCH or C.BATCH),
              f"{len(batches)} batches in an epoch of {n} rows")
        order = np.concatenate(batches)
        want = (torch.from_numpy(xs[order]).to(dev), torch.from_numpy(ys[order]).to(dev))
        for table in (block, dma):
            got = [table.batch(idx) for idx in batches]
            check(torch.equal(torch.cat([x for x, _ in got]), want[0])
                  and torch.equal(torch.cat([y for _, y in got]), want[1]),
                  f"{type(sh).__name__} batches by {table.gather} differ from xs[idx]")
    print(f"  one epoch of LIRS and of TFIP batches ({len(batches)}, the last of "
          f"{len(batches[-1])} rows), gathered by both kernels, equal xs[idx], ys[idx] taken "
          "on the host")

    # device busy share over a steady window of LIRS steps
    model = MLPClassifier(C.DIM, C.CLASSES, hidden, device=dev, params=lirs.init)
    batches = LIRSShuffler(n, C.BATCH, seed=seed + 1).epoch_batches(0)
    for _ in range(20):
        model.train_batch(*block.batch(next(batches)))
    torch.cuda.synchronize()
    _, events, win = _profiled(lambda: model.train_batch(*block.batch(next(batches))),
                               DNN_PROFILE_STEPS)
    busy_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)
    print(f"  profile of {DNN_PROFILE_STEPS} LIRS steps: wall {1e3 * win / DNN_PROFILE_STEPS:.3f} "
          f"ms/step, device busy {1e-3 * busy_us / DNN_PROFILE_STEPS:.3f} ms/step, "
          f"{calls / DNN_PROFILE_STEPS:.1f} device ops/step, busy share {1e-6 * busy_us / win:.3f}")
    top = sorted(events, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "gather" in e.key]:
        print(f"    {e.self_device_time_total / DNN_PROFILE_STEPS:8.2f} us/step "
              f"{e.count / DNN_PROFILE_STEPS:5.1f} calls/step  {e.key[:90]}")
    return {"batch_gather": launches["batch_gather"], "batch_gather_dma": dma_launches}


def train_phase(dev):
    """The LM training path at recurrentgemma-2b's full width and depth,
    through the launcher; returns the main run's launches."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    torch.cuda.reset_peak_memory_stats(dev)
    print("training recurrentgemma-2b at full width:", " ".join(TRAIN_ARGS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = get_config("recurrentgemma-2b")
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)  # 18
    steps = summary["steps"]
    secs = summary["step_seconds"]
    print(f"  run incl. init and data {wall:.1f} s; {cfg.num_layers} layers; launches {launches}")
    print(f"  losses {summary['losses']}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{steps} "
          f"{statistics.median(secs[1:]):.4f} s ({4096 / statistics.median(secs[1:]):.0f} tokens/s)")
    print(f"  Eq. 1: t_load {summary['t_load']:.4f} s, t_comp {summary['t_comp']:.4f} s, t_overlap "
          f"{summary['t_overlap']:.4f} s, t_unhidden_load {summary['t_unhidden_load']:.4f} s, "
          f"effective {summary['effective_time']:.4f} s; peak memory "
          f"{summary['peak_memory_gib']:.2f} GiB")
    check(steps == 8, f"{steps} steps, want 8")
    check(len(summary["losses"]) == 8 and all(np.isfinite(summary["losses"])),
          f"losses {summary['losses']}")
    _check_scan_launches(launches, dict(ops.ENTRY_LAUNCHES), steps, rg)
    return launches


def _check_scan_launches(launches, entries, steps, rg):
    """Two forward scans (the step and the remat recompute) and one
    reverse scan a step for each RG-LRU layer, all on the ring kernel."""
    check(launches["rglru_scan"] == steps * 2 * rg,
          f"rglru_scan launched {launches['rglru_scan']} times, want {steps * 2 * rg}")
    check(launches["rglru_scan_bwd"] == steps * rg,
          f"rglru_scan_bwd launched {launches['rglru_scan_bwd']} times, want {steps * rg}")
    print(f"  launches by entry point {entries}")
    for name, entry in (("rglru_scan", "repro_torch_rglru_scan_ring"),
                        ("rglru_scan_bwd", "repro_torch_rglru_scan_ring_bwd")):
        ring = entries.get(entry, 0)
        check(ring == launches[name], f"the ring kernel ran {ring} of {launches[name]} {name}")


def train_tier_phase(dev):
    """LM training at full width again, through the tiered read path: 16
    records, two epochs, half the records in a Belady DRAM tier, and the
    drift report priced on Optane.  Counts its own launches from 0."""
    import gc

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()  # the direct run's state
    torch.cuda.reset_peak_memory_stats(dev)
    print("training recurrentgemma-2b at full width through the tier:", " ".join(TRAIN_TIER_ARGS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(TRAIN_TIER_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    cfg = get_config("recurrentgemma-2b")
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    steps, secs = summary["steps"], summary["step_seconds"]
    print(f"  run incl. init and data {wall:.1f} s; launches {launches}")
    print(f"  losses {summary['losses']}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{steps} "
          f"{statistics.median(secs[1:]):.4f} s; peak memory {summary['peak_memory_gib']:.2f} GiB")
    print(f"  Eq. 1: t_load {summary['t_load']:.4f} s, t_comp {summary['t_comp']:.4f} s, "
          f"t_unhidden_load {summary['t_unhidden_load']:.4f} s")
    print(f"  cache {json.dumps(summary.get('cache'))}")
    print(f"  drift {json.dumps(summary.get('drift'))}")
    check(steps == 32, f"{steps} steps, want 32")
    check(len(summary["losses"]) == 32 and all(np.isfinite(summary["losses"])),
          f"losses {summary['losses']}")
    _check_scan_launches(launches, dict(ops.ENTRY_LAUNCHES), steps, rg)
    check("cache" in summary and "drift" in summary, "the summary lacks its cache or drift block")
    check(summary["drift"]["ok"], "the drift report disagrees with the closed forms")
    return launches


def multihost_lockstep_check(path, args):
    """A second 4-host cluster over the launcher's corpus and shuffler,
    without the background workers (``background=False``): every global
    batch of the run's epochs through ``ClusterFetcher`` equal to the
    store's direct read, and the fleet's storage reads exactly ``n +
    (epochs - 1) * floor``."""
    import numpy as np

    from repro_torch.launch.args import make_shuffler_from_args, planner_from_args
    from repro_torch.prefetch.distributed import ClusterFetcher, make_cluster
    from repro_torch.storage.record_store import RecordStore

    ref = RecordStore(path)
    shuffler = make_shuffler_from_args(args, ref, args.batch, args.seed)
    cluster = make_cluster(lambda: RecordStore(path), shuffler, args.hosts,
                           budget_bytes=int(args.cache_mb * 2**20),
                           lookahead=args.prefetch_lookahead, workers=args.io_workers,
                           background=False, max_epochs=args.epochs,
                           policy=args.eviction_policy, planner=planner_from_args(args))
    fetcher = ClusterFetcher(cluster)
    t0 = time.perf_counter()
    try:
        batches, per_epoch, prev = 0, [], 0
        for e in range(args.epochs):
            for idx in fetcher.batch_iter(e):
                check(np.array_equal(fetcher(idx), ref.read_batch_into(idx)),
                      f"lockstep cluster batch {batches} differs from the direct read")
                batches += 1
            total = cluster.aggregate_io()["storage_records"]
            per_epoch.append(total - prev)
            prev = total
        agg = cluster.aggregate_io()
        floor = cluster.placement.expected_storage_reads()
    finally:
        fetcher.close()
        ref.close()
    n = args.num_records
    print(f"  lockstep cluster ({args.hosts} hosts, background off): {batches} global batches "
          f"equal to the direct read in {time.perf_counter() - t0:.2f} s; storage records by "
          f"epoch {per_epoch} (floor {floor}); remote hits {agg['remote_hits']}, pushes "
          f"{agg['peer_pushes']}")
    check(batches == args.epochs * n // args.batch, f"{batches} lockstep batches")
    check(agg["storage_records"] == n + (args.epochs - 1) * floor,
          f"lockstep storage records {agg['storage_records']}, want "
          f"{n + (args.epochs - 1) * floor}")
    check(agg["peer_failures"] == agg["push_errors"] == 0, f"lockstep peer errors {agg}")


def multihost_train_phase(dev):
    """LM training at full width through the multi-host tier: the launcher
    with ``--hosts 4 --cache-mb`` (a 4-host clairvoyant cluster in this
    process, compute on the card), after a lockstep byte check of the same
    cluster over the same corpus.  Counts its own launches from 0 and
    returns them."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config("recurrentgemma-2b")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="multihost_", dir=os.path.join(ROOT, "build"))
    try:
        path = make_token_dataset(os.path.join(tmp, "corpus.rrec"), MULTIHOST_RECORDS,
                                  MULTIHOST_SEQ, cfg.vocab_size, seed=0).path
        argv = MULTIHOST_ARGS + ["--data", path]
        print("training recurrentgemma-2b at full width through the multi-host tier:",
              " ".join(MULTIHOST_ARGS))
        multihost_lockstep_check(path, train.build_argparser().parse_args(argv))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = train.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        entries = dict(ops.ENTRY_LAUNCHES)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    steps, secs = summary["steps"], summary["step_seconds"]
    dist = summary.get("distributed", {})
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    floor = dist.get("expected_steady_storage_records_per_epoch")
    print(f"  run incl. init and data {wall:.1f} s; launches {launches}")
    print(f"  losses {summary['losses']}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{steps} "
          f"{statistics.median(secs[1:]):.4f} s ({MULTIHOST_SEQ * MULTIHOST_BATCH / statistics.median(secs[1:]):.0f} "
          f"tokens/s); peak memory {summary['peak_memory_gib']:.2f} GiB of {card_gib:.2f}")
    print(f"  Eq. 1: t_load {summary['t_load']:.4f} s, t_comp {summary['t_comp']:.4f} s, t_overlap "
          f"{summary['t_overlap']:.4f} s, t_unhidden_load {summary['t_unhidden_load']:.4f} s, "
          f"effective {summary['effective_time']:.4f} s")
    print(f"  storage records by epoch {summary.get('storage_records_by_epoch')}; steady floor "
          f"{floor} an epoch")
    print(f"  distributed {json.dumps(dist)}")
    print(f"  drift {json.dumps(summary.get('drift'))}")
    epochs = MULTIHOST_EPOCHS
    check(steps == epochs * MULTIHOST_RECORDS // MULTIHOST_BATCH, f"{steps} steps, want 24")
    check(len(summary["losses"]) == steps and all(np.isfinite(summary["losses"])),
          f"losses {summary['losses']}")
    _check_scan_launches(launches, entries, steps, rg)
    check(dist.get("hosts") == MULTIHOST_HOSTS, f"distributed hosts {dist.get('hosts')}")
    check(dist.get("fleet_capacity_records") == MULTIHOST_CACHED,
          f"fleet capacity {dist.get('fleet_capacity_records')} records, want {MULTIHOST_CACHED}")
    check(floor == MULTIHOST_RECORDS - MULTIHOST_CACHED, f"steady floor {floor}")
    check(dist["remote_hits"] > 0, "no record was served host-to-host")
    check(dist["peer_failures"] == 0 and dist["push_errors"] == 0,
          f"peer failures {dist['peer_failures']}, push errors {dist['push_errors']}")
    check("drift" in summary, "the summary lacks its drift block")
    check(summary["peak_memory_gib"] < card_gib - 5, "the peak is within 5 GiB of the card")
    return launches


def tcp_mesh_host(spec, path, budget_bytes, epochs, out_path):
    """One host process of the TCP mesh: a PeerServer over its cache, a
    TCPTransport to the peers found through all_gather, lockstep epochs,
    every served shard checked against the direct read; host 0 writes
    the fleet's counters to ``out_path``."""
    import numpy as np

    from repro_torch.core import LIRSShuffler
    from repro_torch.prefetch.cache import TieredCache
    from repro_torch.prefetch.distributed import RemoteFetcher, RemoteTier
    from repro_torch.prefetch.fetcher import PrefetchingFetcher
    from repro_torch.prefetch.transport import PeerServer, TCPTransport
    from repro_torch.sharding.placement import ClairvoyantPlacement, HostShardView
    from repro_torch.storage.record_store import RecordStore

    sh = LIRSShuffler(TCP_RECORDS, TCP_BATCH, seed=5)
    store, ref = RecordStore(path), RecordStore(path)
    cache = TieredCache(store.lengths(), budget_bytes, policy="belady")
    server = PeerServer(cache)
    addrs = spec.all_gather(server.address)
    transport = TCPTransport({h: a for h, a in addrs.items() if h != spec.host_id})
    placement = ClairvoyantPlacement(sh, spec.num_hosts, [cache.capacity] * spec.num_hosts,
                                     policy="belady", max_epochs=epochs)
    remote = RemoteTier(spec.host_id, placement, RemoteFetcher(transport, spec.host_id))
    fetcher = PrefetchingFetcher(store, HostShardView(sh, spec.num_hosts, spec.host_id),
                                 lookahead=2, gap_bytes=0, workers=1, background=False,
                                 max_epochs=epochs, cache=cache, policy="belady",
                                 remote=remote, placement=placement)
    server.inbox = fetcher._inbox_put
    spec.all_gather(None)  # every host takes pushes before any serves
    equal = True
    for e in range(epochs):
        for part in fetcher.batch_iter(e):
            equal &= bool(np.array_equal(fetcher(part), ref.read_batch_into(part)))
            spec.all_gather(None)  # lockstep: peers stay populated
    stats = spec.all_gather({"equal": equal, "remote_hits": store.stats.remote_hits,
                             "pushed": fetcher.pushed_records, "push_errors": fetcher.push_errors,
                             "peer_failures": remote.fetcher.peer_failures,
                             "storage_records": store.stats.batch_records,
                             "floor": placement.expected_storage_reads()})
    fetcher.close()
    server.close()
    transport.close()
    ref.close()
    store.close()
    if spec.host_id == 0:
        with open(out_path, "w") as f:
            json.dump(stats, f)


def tcp_mesh_phase():
    """The TCP route on the chip's host: three OS processes through
    ``run_cpu_process_mesh``, each a PeerServer and a TCPTransport, lockstep
    epochs over a fixed-record file; byte identity, no peer failure or push
    error, records pushed and served host-to-host, and storage reads
    exactly at the floor."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.mesh import run_cpu_process_mesh
    from repro_torch.storage.record_store import RecordWriter

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="tcp_mesh_", dir=os.path.join(ROOT, "build"))
    try:
        path = os.path.join(tmp, "fixed.rrec")
        rng = np.random.default_rng(11)
        with RecordWriter(path, record_size=TCP_RECORD) as w:
            for _ in range(TCP_RECORDS):
                w.append(rng.bytes(TCP_RECORD))
        out = os.path.join(tmp, "stats.json")
        t0 = time.perf_counter()
        run_cpu_process_mesh(tcp_mesh_host, TCP_HOSTS,
                             args=(path, TCP_RECORDS * TCP_RECORD // 4, TCP_EPOCHS, out),
                             mp_context="spawn", round_timeout_s=120.0, join_timeout_s=120.0)
        wall = time.perf_counter() - t0
        with open(out) as f:
            stats = list(json.load(f).values())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = {k: sum(v[k] for v in stats) for k in ("remote_hits", "pushed", "push_errors",
                                                   "peer_failures", "storage_records")}
    floor = stats[0]["floor"]
    want = TCP_RECORDS + (TCP_EPOCHS - 1) * floor
    print(f"TCP mesh: {TCP_HOSTS} processes, {TCP_EPOCHS} lockstep epochs in {wall:.2f} s "
          f"(process start included); {json.dumps(total)}; floor {floor} an epoch")
    check(all(v["equal"] for v in stats), "a TCP mesh host served bytes unequal to the direct read")
    check(total["peer_failures"] == 0 and total["push_errors"] == 0, f"TCP mesh errors {total}")
    check(total["pushed"] > 0 and total["remote_hits"] > 0, f"TCP mesh served nothing: {total}")
    check(total["storage_records"] == want,
          f"TCP mesh storage records {total['storage_records']}, want {want}")


def compression_phase(dev):
    """Gradient compression at recurrentgemma-2b's full width: one step's
    gradients compressed on the card and, leaf by leaf, on the CPU (codes,
    scales and residuals equal), error feedback's invariant bit for bit on
    the card, COMPRESSION_STEPS compressed train steps (finite losses, the
    first equal to an uncompressed step's from the same weights and batch,
    the scan's launches), and ``compressed_psum`` over a one-rank NCCL
    group on the embedding.  Returns the compressed steps' launches."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.compression import (
        EFCompressor,
        compressed_psum,
        dequantize,
        quantize,
    )
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    cfg = get_config("recurrentgemma-2b")
    comp = EFCompressor(8)
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(0), opt, dev, compressor=comp)
    params = state["params"]
    n_params = sum(p.numel() for p in tree_leaves(params))
    gen = torch.Generator(dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (1, COMPRESSION_SEQ + 1), generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1].to(torch.int32), "labels": toks[:, 1:].to(torch.int32)}
    print(f"compression at full width: {cfg.name}, {n_params:,} parameters, batch 1 x "
          f"{COMPRESSION_SEQ}; the f32 residual {4 * n_params / 2**30:.2f} GiB")

    # 1-2: one step's gradients, compressed on the card and on the CPU
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, _ = M.loss_fn(cfg, tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    del leaves, loss
    t0 = time.perf_counter()
    worst_gap, card_s, cpu_s = 0.0, 0.0, 0.0
    for i, (g, r) in enumerate(zip(grads, tree_leaves(state["ef_residual"]))):
        for rnd in (1, 2):  # round 2 feeds back round 1's residual, on the card only
            t1 = time.perf_counter()
            (codes, scales), (nr,) = comp.compress([g], [r])
            (sent,) = comp.decompress((codes, scales))
            torch.cuda.synchronize()
            card_s += time.perf_counter() - t1
            if rnd == 1:  # the step's own round: the state's zero residual
                t2 = time.perf_counter()
                (ccodes, cscales), (cnr,) = comp.compress([g.cpu()], [r.cpu()])
                cpu_s += time.perf_counter() - t2
                same = (torch.equal(codes[0].cpu(), ccodes[0]),
                        torch.equal(scales[0].cpu(), cscales[0]), torch.equal(nr.cpu(), cnr))
                check(all(same), f"leaf {i} {tuple(g.shape)} compressed on the card differs "
                      f"from the CPU's (codes, scale, residual equal: {same}; scale "
                      f"{float(scales[0])!r} vs {float(cscales[0])!r})")
                del ccodes, cscales, cnr
            e = g.float() + r
            check(torch.equal(sent + nr, e),
                  f"round {rnd}: leaf {i}: decompress + new residual != grad + residual")
            worst_gap = max(worst_gap, float((sent - e).abs_().max() / scales[0]))
            r = nr
            del codes, scales, sent, e
        del r, nr
    print(f"  {len(grads)} leaves: codes, scales and residuals equal on card and CPU; "
          f"decompress + residual == grad + residual bit for bit on the card, from the zero "
          f"residual and again from the first round's; the sent gradient within "
          f"{worst_gap:.4f} scale units of grad + residual; compress card {card_s:.2f} s (both "
          f"rounds), CPU {cpu_s:.2f} s, checks {time.perf_counter() - t0:.1f} s (host clock)")
    check(worst_gap <= 0.5001, f"a residual of {worst_gap} scale units, above half a unit")
    embed = max(grads, key=lambda g: g.numel())

    # 4: compressed_psum through a one-rank NCCL group, on the embedding's gradient
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        out = compressed_psum(embed, bits=8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compressed_psum(embed, bits=8)
        torch.cuda.synchronize()
        psum_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()
    check(torch.equal(out, dequantize(*quantize(embed, 8))),
          "compressed_psum over one rank is not dequantize(quantize(x))")
    print(f"  compressed_psum over a one-rank NCCL group on the {tuple(embed.shape)} gradient: "
          f"equal to dequantize(quantize(x)); {psum_ms:.2f} ms (host clock)")
    del grads, embed, out
    _free()

    checks_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    check(checks_peak < card_gib - 5, "the checks' peak is within 5 GiB of the card")

    # 3: the uncompressed step, then the compressed steps from the same weights
    torch.cuda.reset_peak_memory_stats(dev)
    backup = [p.detach().to("cpu", copy=True) for p in tree_leaves(params)]
    plain = make_train_step(cfg, opt)
    plain_losses, plain_secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, out = plain(state, batch)
        plain_losses.append(out["loss"].clone())
        torch.cuda.synchronize()
        plain_secs.append(time.perf_counter() - t0)
    for p, b in zip(tree_leaves(params), backup):
        p.copy_(b)
    for key in ("mu", "nu"):
        for m in tree_leaves(state["opt"][key]):
            m.zero_()
    state["opt"]["count"].zero_()
    state["step"].zero_()
    del backup
    step = make_train_step(cfg, opt, compressor=comp)
    ops.reset_launch_counts()
    losses, secs = [], []
    for _ in range(COMPRESSION_STEPS):
        t0 = time.perf_counter()
        _, out = step(state, batch)
        losses.append(out["loss"].clone())
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches, entries = dict(ops.LAUNCHES), dict(ops.ENTRY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    vals = [float(x) for x in losses]
    print(f"  {COMPRESSION_STEPS} compressed steps: losses {vals}; step seconds "
          f"{[round(x, 4) for x in secs]}; uncompressed step seconds "
          f"{[round(x, 4) for x in plain_secs]} (losses {[float(x) for x in plain_losses]}); "
          f"peak memory {peak:.2f} GiB of {card_gib:.2f} (the checks before them "
          f"{checks_peak:.2f}); launches {launches}")
    check(all(np.isfinite(vals)), f"compressed losses {vals}")
    check(torch.equal(losses[0], plain_losses[0]),
          f"the first compressed loss {vals[0]} != the uncompressed step's {float(plain_losses[0])}")
    check(int(state["step"]) == COMPRESSION_STEPS, f"step count {int(state['step'])}")
    _check_scan_launches(launches, entries, COMPRESSION_STEPS, rg)
    check(peak < card_gib - 5, "the peak is within 5 GiB of the card")
    del state, params, step, plain
    _free()
    return launches


def train_profile_phase(dev, steps=2):
    """Where a full-width training step's time goes, under both remat
    policies in turn (``"dots"``, the config's default, then ``"full"``):
    after one warm step, ``steps`` steps on the host clock, then ``steps``
    under torch.profiler (device time by kernel, busy share), and the
    steady peak memory.  Runs after the
    main path, so its launches are not counted there."""
    import gc


    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    classes = {"GEMM": ("nvjet", "gemm", "cutlass", "xmma"), "rglru_scan": ("rglru_scan", "scan_ring"),
               "softmax/reduce": ("softmax", "reduce")}
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    step_ms, peaks = {}, {}
    for remat in ("dots", "full"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = get_config("recurrentgemma-2b").replace(remat=remat)
        opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
        state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1), opt, dev)
        n_params = sum(p.numel() for p in tree_leaves(state["params"]))
        step = make_train_step(cfg, opt)
        g = torch.Generator(device=dev).manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (1, 4097), generator=g, device=dev, dtype=torch.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, out = step(state, batch)
        float(out["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(state, batch)
            float(out["loss"])
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0

        def one_step():
            nonlocal state
            state, out = step(state, batch)
            float(out["loss"])

        _, events, wall = _profiled(one_step, steps)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        check(peak <= card_gib - 5, f"remat={remat!r} peaks at {peak:.2f} of the card's "
              f"{card_gib:.2f} GiB, less than 5 GiB under it")
        step_ms[remat], peaks[remat] = 1e3 * plain_wall / steps, peak
        busy_us = sum(e.self_device_time_total for e in events)
        calls = sum(e.count for e in events)
        print(f"profile of {steps} training steps, remat={remat!r} (full width, {n_params:,} "
              f"parameters, seq 4096): wall {1e3 * plain_wall / steps:.1f} ms/step unprofiled, "
              f"{1e3 * wall / steps:.1f} under the profiler; device busy "
              f"{1e-3 * busy_us / steps:.1f} ms/step, {calls / steps:.0f} device ops/step, busy "
              f"share {1e-6 * busy_us / plain_wall:.3f} of the unprofiled step; peak memory "
              f"{peak:.2f} GiB")
        split = dict.fromkeys(classes, 0.0)
        split["other elementwise and copies"] = 0.0
        for e in events:
            name = next((c for c, keys in classes.items() if any(k in e.key.lower() for k in keys)),
                        "other elementwise and copies")
            split[name] += e.self_device_time_total
        print("  device ms/step by class: " + ", ".join(
            f"{c} {v / steps / 1e3:.1f} ({v / busy_us:.3f})" for c, v in split.items()))
        top = sorted(events, key=lambda e: -e.self_device_time_total)
        for e in top[:12] + [e for e in top[12:] if "rglru" in e.key or "scan_ring" in e.key]:
            print(f"  {e.self_device_time_total / steps / 1e3:9.3f} ms/step "
                  f"{e.count // steps:5d} calls/step  {e.key[:100]}")
        del state, out
    print(f"  remat 'dots' {step_ms['dots']:.1f} against 'full' {step_ms['full']:.1f} ms a step "
          f"(host clock, this call): ratio {step_ms['dots'] / step_ms['full']:.3f}; peak memory "
          f"{peaks['dots']:.2f} against {peaks['full']:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------ recurrent prefill and decode


def decode256_phase(dev):
    """K6 at head dim 256, bf16, on the cluster kernel: recurrentgemma-2b's
    local-attention decode (MQA, 10 heads on one KV head, a 2,048-slot
    ring) against the plain version, with cur below T, at T-1 and past T,
    and at a ragged T; then timed at the decode phase's call (every row
    past the ring's end: the whole ring read) beside SDPA and the bound.
    Returns the flash_decode row's ``head_dim_256`` entry (launches are
    filled in by the decode phase)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    b, h, kh, d, t = RG_RING
    check(ops._decode_kernel(torch.bfloat16, d) == "cluster",
          "bf16 decode at head dim 256 does not route to the cluster kernel")
    g = torch.Generator(device=dev).manual_seed(11)
    print(f"flash_decode at head dim {d} vs plain version (bf16, cluster kernel):")
    for tt, curs in ((t, [100, t - 1, t, 3 * t]), (t + 17, [0, 64, t + 16, t + 17]),
                     (1000, [999, 63, 1000, 5000])):
        q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
        kc, vc = (torch.randn(b, tt, kh, d, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        cur = torch.tensor(curs, dtype=torch.int32, device=dev)
        got = ops.flash_decode(q, kc, vc, cur)
        torch.cuda.synchronize()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        compare(f"q{tuple(q.shape)} cache{tuple(kc.shape)} cur={curs} splits/chunk "
                f"{ops._decode_splits(b, kh, tt, sms)}", got, ref.flash_decode(q, kc, vc, cur),
                TOL["torch.bfloat16"])
    q = torch.randn(b, h, d, generator=g, device=dev).to(torch.bfloat16)
    kc, vc = (torch.randn(b, t, kh, d, generator=g, device=dev).to(torch.bfloat16)
              for _ in range(2))
    cur = torch.full((b,), RG_PROMPT, dtype=torch.int32, device=dev)
    # every row averages the whole ring here, so outputs are O(0.03), not
    # O(0.1-1) as in the sweep above: 1e-2 keeps the limit near the output's
    # own scale, where a skipped 64-key tile would breach it
    err = compare("timed inputs (cur past T)", ops.flash_decode(q, kc, vc, cur),
                  ref.flash_decode(q, kc, vc, cur), TIMED_DECODE256_TOL)
    q4 = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    tm_, eager = time_ms({
        "kernel": lambda: ops.flash_decode(q, kc, vc, cur),
        "plain": lambda: ref.flash_decode(q, kc, vc, cur),
        "library": lambda: F.scaled_dot_product_attention(q4, kt, vt, enable_gqa=True),
    })
    nbytes = 2 * (2 * q.numel() + kc.numel() + vc.numel()) + 4 * cur.numel()
    entry = dict(shape=f"q{tuple(q.shape)} cache{tuple(kc.shape)} bf16", max_abs_err=err,
                 ms=tm_["kernel"], plain_ms=tm_["plain"],
                 **bound(nbytes, 4 * b * t * h * d, BF16_FLOPS), library_ms=tm_["library"])
    print(f"  device ms per call: {tm_}; eager ms per call: {eager}; bound "
          f"{entry['bound_ms']:.6f} ms ({entry['bound_by']}, {nbytes} bytes); kernel at "
          f"{entry['bound_ms'] / tm_['kernel']:.3f} of it")
    return entry


def _greedy(logits):
    return logits.argmax(-1, keepdim=True)


def _top(events, n, per):
    """Print the eight kernels with the most device time, per ``per``."""
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / n / 1e3:8.3f} ms/{per} "
              f"{e.count // n:5d} calls/{per}  {e.key[:90]}")


def recurrent_decode_phase(dev):
    """recurrentgemma-2b at published width and depth (26 layers, random
    f32 weights from seed 0, bf16 compute) through the step functions:
    prefill RG_BATCH x RG_PROMPT tokens, then RG_DECODE greedy decode
    steps from position RG_PROMPT, every count from 0 just before each.
    Checks 18 forward scans (K5) in prefill; 8 local layers x RG_DECODE K6
    launches in decode, all on the cluster route, and no scan; finite
    logits.  Prints prefill ms, decode ms a step (host clock ending in a
    sync; device time over RG_PROFILE_STEPS profiled steps), tokens/s and
    peak memory.  Returns the decode's launches."""
    import gc


    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("recurrentgemma-2b")
    rg = sum(p.count("rglru") * r for p, r in cfg.stages)
    local = sum(p.count("local_attn") * r for p, r in cfg.stages)
    print(f"recurrentgemma-2b prefill and decode at full width ({cfg.num_layers} layers, "
          f"{rg} RG-LRU, {local} local attention, window {cfg.local_window}, head dim "
          f"{cfg.kq_dim}, bf16 compute): prefill {RG_BATCH} x {RG_PROMPT}, {RG_DECODE} decode steps")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(1, cfg.vocab_size, (RG_BATCH, RG_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre = dict(ops.LAUNCHES)
    print(f"  prefill {1e3 * prefill_s:.1f} ms ({RG_BATCH * RG_PROMPT / prefill_s:.0f} tokens/s), "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {pre}")
    check(pre["rglru_scan"] == rg, f"prefill launched rglru_scan {pre['rglru_scan']} times, want {rg}")
    check(pre["flash_decode"] == 0 and pre["rglru_scan_bwd"] == 0, f"prefill launches {pre}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    ring = cache["stages"][0][2]["k"]
    check(tuple(ring.shape[1:]) == (RG_BATCH, cfg.local_window, cfg.num_kv_heads, cfg.kq_dim),
          f"ring {tuple(ring.shape)}")
    tok = _greedy(logits)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(RG_DECODE):
        cache, logits = decode(params, cache, tok)
        tok = _greedy(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches, entries = dict(ops.LAUNCHES), dict(ops.ENTRY_LAUNCHES)
    want = local * RG_DECODE
    print(f"  decode {1e3 * decode_s / RG_DECODE:.2f} ms a step (host clock, {RG_BATCH} rows, "
          f"{RG_BATCH * RG_DECODE / decode_s:.0f} tokens/s); launches {launches}, by entry "
          f"point {entries}; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(launches["flash_decode"] == want,
          f"flash_decode launched {launches['flash_decode']} times, want {want}")
    check(entries.get("repro_torch_flash_decode_cluster", 0) == want,
          f"the cluster kernel ran {entries.get('repro_torch_flash_decode_cluster', 0)} of {want}")
    check(launches["rglru_scan"] == 0, f"decode launched rglru_scan {launches['rglru_scan']} times")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(int(cache["pos"]) == RG_PROMPT + RG_DECODE, f"pos {int(cache['pos'])}")
    def one_step():
        nonlocal cache, logits, tok
        cache, logits = decode(params, cache, tok)
        tok = _greedy(logits)

    _, events, wall = _profiled(one_step, RG_PROFILE_STEPS)
    busy_us = sum(e.self_device_time_total for e in events)
    busy_ms = 1e-3 * busy_us / RG_PROFILE_STEPS
    print(f"  profile of {RG_PROFILE_STEPS} decode steps: wall {1e3 * wall / RG_PROFILE_STEPS:.2f} "
          f"ms/step under the profiler, device busy {busy_ms:.2f} ms/step; busy share "
          f"{busy_ms / (1e3 * decode_s / RG_DECODE):.3f} of the unprofiled step")
    _top(events, RG_PROFILE_STEPS, "step")
    del cache, logits
    _, events, _ = _profiled(lambda: prefill(params, toks), 1)
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"  profile of one prefill: device busy {1e-3 * busy_us:.1f} ms; busy share "
          f"{1e-3 * busy_us / (1e3 * prefill_s):.3f} of the unprofiled prefill")
    _top(events, 1, "prefill")
    teacher_forced_check(cfg, params, dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def teacher_forced_check(cfg, params, dev):
    """The form of ``tests/test_models.py::test_decode_matches_prefill_logits``
    at full width, bf16: RG_TEACHER decode steps from
    ``init_decode_cache(cfg, 1, RG_PROMPT)`` against ``prefill``'s last
    logits over the same tokens.  The JAX test's 2e-2 is too tight for
    bf16 at 26 layers: on an H100 the bf16 prefill's logits lie 8.2e-2
    from an f32 prefill's and decode's 3.9e-2 from prefill's, so the check
    holds rtol = atol = 5e-2 (a cache fault moves logits by O(1): the
    shrunken ring of a short prompt by 2.24 at smoke size).  Prints the
    bf16 prefill's distance from an f32 prefill, bf16's own rounding at
    this depth, beside it.  (No f32 decode: K6 takes head dim 256 in bf16
    only.)"""
    from repro_torch.models import model as M

    toks = torch.randint(1, cfg.vocab_size, (1, RG_TEACHER),
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    _, want = M.prefill(cfg, params, toks)
    _, want32 = M.prefill(cfg.replace(dtype="float32"), params, toks)
    cache = M.init_decode_cache(cfg, 1, RG_PROMPT, dev)
    for i in range(RG_TEACHER):
        cache, got = M.decode_step(cfg, params, cache, toks[:, i:i + 1])
    torch.cuda.synchronize()
    print(f"  teacher-forced decode of {RG_TEACHER} tokens vs prefill (bf16; logits max "
          f"|{float(want.float().abs().max()):.3f}|, bf16 prefill vs f32 prefill max_abs_err "
          f"{float((want.float() - want32.float()).abs().max()):.3e}):")
    compare(f"last logits {tuple(got.shape)}", got, want, 5e-2)


def granite_scalar_decode_check(dev):
    """granite-3-8b at full width and GRANITE_LAYERS of its 40 layers:
    prefill(GRANITE_PROMPT) -> extend_cache(GRANITE_EXTEND) -> that many
    teacher-forced scalar-position decode steps against
    prefill(GRANITE_PROMPT + GRANITE_EXTEND)'s last logits at 3e-2, as
    ``tests/test_multihost.py::test_extend_cache_decode_matches_prefill``;
    K4 and K6 at head dim 128."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("granite-3-8b")
    cfg = full.replace(stages=((full.stages[0][0], GRANITE_LAYERS),))
    print(f"granite-3-8b scalar-position decode ({cfg.num_layers} of {full.num_layers} layers, "
          f"full width): prefill({GRANITE_PROMPT}) -> extend_cache({GRANITE_EXTEND}) -> "
          f"{GRANITE_EXTEND} decode steps vs prefill({GRANITE_PROMPT + GRANITE_EXTEND})")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n = GRANITE_PROMPT + GRANITE_EXTEND
    toks = torch.randint(1, cfg.vocab_size, (1, n),
                         generator=torch.Generator(device=dev).manual_seed(4), device=dev)
    ops.reset_launch_counts()
    _, want = M.prefill(cfg, params, toks)
    cache, _ = M.prefill(cfg, params, toks[:, :GRANITE_PROMPT])
    cache = M.extend_cache(cfg, cache, GRANITE_EXTEND)
    for i in range(GRANITE_PROMPT, n):
        cache, got = M.decode_step(cfg, params, cache, toks[:, i:i + 1])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    print(f"  launches {launches}, by entry point {dict(ops.ENTRY_LAUNCHES)}")
    check(launches["flash_attention"] == 2 * GRANITE_LAYERS
          and launches["flash_decode"] == GRANITE_EXTEND * GRANITE_LAYERS, f"launches {launches}")
    compare(f"last logits {tuple(got.shape)}", got, want, 3e-2)
    del params, cache


def blocked_attention_check(dev):
    """``blocked_attention`` (the plain online softmax of
    ``attn_impl="blocked"``) at granite-3-8b's context shape against K4's
    causal result, bf16, block BLOCKED_BLOCK, at bf16's 2e-2."""
    from repro_torch.kernels import ops
    from repro_torch.layers.attention import blocked_attention

    g = torch.Generator(device=dev).manual_seed(12)
    q = torch.randn(1, LONG_CONTEXT, 32, 128, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(1, LONG_CONTEXT, 8, 128, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    print(f"blocked attention (block {BLOCKED_BLOCK}) vs flash_attention, bf16:")
    compare(f"q{tuple(q.shape)} kv{tuple(k.shape)}", blocked_attention(q, k, v, BLOCKED_BLOCK),
            ops.flash_attention(q, k, v), TOL["torch.bfloat16"])


# --------------------------------------------- MoE and the copied configs


def _free():
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def moe_serve_phase(dev):
    """qwen2-moe-a2.7b at published width and depth (24 ``moe`` layers, 60
    routed experts top-4 and 4 shared, f32 storage, bf16 compute) through
    the serving launcher (``MOE_SERVE_ARGS``), with ``serve_run``'s checks;
    returns its launches."""
    _free()
    launches, report = serve_run(MOE_SERVE_ARGS)
    print(f"  {MOE_ARCH}: {report['tokens_per_s']} tokens/s, decode "
          f"{report['decode_ms_per_step']:.2f} ms a step, prefill "
          f"{report['prefill_ms_per_request']:.2f} ms a request, TTFT p50/p99 "
          f"{report['ttft_p50_steps']}/{report['ttft_p99_steps']} steps, peak memory "
          f"{report['peak_memory_gib']:.2f} GiB")
    return launches


def stablelm_serve_phase(dev):
    """stablelm-12b at published width and depth (40 ``attn`` layers,
    d_model 5,120, GQA 32/8 at head dim 160, f32 storage, bf16 compute)
    through the serving launcher (``STABLELM_SERVE_ARGS``), with
    ``serve_run``'s checks: every K4 launch on the tensor-core kernel and
    every K6 launch on the cluster kernel, at D 160; then its steady
    decode profiled (``profile_phase``: casts, GEMMs, ``flash_decode``).
    Returns the serve run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    _free()
    cfg = get_config(STABLELM_ARCH)
    check(cfg.kq_dim == STABLELM_D and (cfg.num_heads, cfg.num_kv_heads) == STABLELM_HEADS,
          f"{STABLELM_ARCH}: heads {cfg.num_heads}/{cfg.num_kv_heads} at D {cfg.kq_dim}")
    check(ops._attention_kernel(cfg.compute_dtype, cfg.kq_dim, 4) == "wgmma"
          and ops._decode_kernel(cfg.compute_dtype, cfg.kq_dim) == "cluster",
          f"{STABLELM_ARCH} does not route to the tensor-core K4 and the cluster K6")
    launches, report = serve_run(STABLELM_SERVE_ARGS)
    print(f"  {STABLELM_ARCH}: {report['tokens_per_s']} tokens/s, decode "
          f"{report['decode_ms_per_step']:.2f} ms a step, prefill "
          f"{report['prefill_ms_per_request']:.2f} ms a request, TTFT p50/p99 "
          f"{report['ttft_p50_steps']}/{report['ttft_p99_steps']} steps, peak memory "
          f"{report['peak_memory_gib']:.2f} GiB")
    del report
    _free()
    eng = profile_phase(dev, STABLELM_ARCH)
    del eng
    _free()
    return launches


class _Routes:
    """Records the expert ids of every MoE routing in a scope (the port's
    ``layers.moe._route``), as ``_EventTimed`` brackets ``csr_dot``."""

    def __init__(self):
        from repro_torch.layers import moe

        self.moe, self.ids = moe, []

    def __enter__(self):
        inner = self.inner = self.moe._route

        def recorded(logits, k):
            out = inner(logits, k)
            self.ids.append(out[1])
            return out

        self.moe._route = recorded
        return self

    def __exit__(self, *exc):
        self.moe._route = self.inner


def _flips(a, b):
    """Routings (rows of expert ids, (L, N, k)) whose sets of experts
    differ between two runs."""
    return int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())


def _entries(ops):
    return ", ".join(f"{k.removeprefix('repro_torch_')} x{v}"
                     for k, v in ops.ENTRY_LAUNCHES.items() if "flash" in k)


def _teacher_forced(cfg, prefill_cfg, params, toks, dev, label, tol, pos3d=None):
    """``prefill_cfg``'s prefill of ``toks`` (1, N) against N teacher-forced
    ``cfg`` decode steps from ``init_decode_cache(cfg, 1, N)``: one K4
    launch a layer in the prefill, one K6 launch a layer a step, the last
    logits finite and, unless ``tol`` is None, within ``tol``.  With
    ``pos3d`` (1, 3, N), the prefill takes it as ``positions_3d`` and
    decode step i its column i.  For a MoE
    config, also counts the (token, layer) routings whose experts differ
    between the two runs.  Returns the decode's launches by entry point
    and the prefill's logits."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    n, layers = toks.shape[1], cfg.num_layers
    ops.reset_launch_counts()
    with _Routes() as pre_ids:
        _, want = M.prefill(prefill_cfg, params, toks,
                            None if pos3d is None else {"positions_3d": pos3d})
    torch.cuda.synchronize()
    check(ops.LAUNCHES["flash_attention"] == layers,
          f"prefill launched flash_attention {ops.LAUNCHES['flash_attention']} times")
    line = f"  {label}: prefill {_entries(ops)}"
    ops.reset_launch_counts()
    cache = M.init_decode_cache(cfg, 1, n, dev)
    with _Routes() as dec_ids:
        for i in range(n):
            step = None if pos3d is None else {"positions_3d": pos3d[:, :, i:i + 1]}
            cache, got = M.decode_step(cfg, params, cache, toks[:, i:i + 1], step)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["flash_decode"] == layers * n,
          f"decode launched flash_decode {ops.LAUNCHES['flash_decode']} times, want {layers * n}")
    line += f", decode {_entries(ops)}; logits max |{float(want.float().abs().max()):.3f}|"
    if cfg.moe is not None:
        pre = torch.stack([x[0] for x in pre_ids.ids])                    # (L, N, k)
        dec = torch.stack([x[0, 0] for x in dec_ids.ids]).unflatten(0, (n, layers)).transpose(0, 1)
        line += f"; {_flips(pre, dec)} of {n * layers} (token, layer) routings differ"
    print(line)
    if tol is None:
        check(bool(torch.isfinite(got).all()), f"{label}: logits not finite")
        print(f"  {label}: last logits {tuple(got.shape)}: max_abs_err "
              f"{float((got.float() - want.float()).abs().max()):.3e} (no tolerance held)")
    else:
        compare(f"{label}: last logits {tuple(got.shape)}", got, want, tol)
    return dict(ops.ENTRY_LAUNCHES), want


def _dtype_checks(cfg, pre, params, toks, dev, label, bf16_tol, pos3d=None):
    """``_teacher_forced`` in f32 compute (K4 and K6 on their f32 kernels)
    at F32_LOGITS_TOL, then in bf16 (the tensor-core K4 where the group
    divides 64, K6 on its cluster kernel) at ``bf16_tol``; prints how far
    the bf16 prefill lies from the f32 one, bf16's own rounding at this
    depth.  Returns the prefills' logits by dtype."""
    n, layers = toks.shape[1], cfg.num_layers
    prefills = {}
    for dtype, tol, entry in (("float32", F32_LOGITS_TOL, "repro_torch_flash_decode"),
                              ("bfloat16", bf16_tol, "repro_torch_flash_decode_cluster")):
        entries, want = _teacher_forced(cfg.replace(dtype=dtype), pre.replace(dtype=dtype),
                                        params, toks, dev, f"{label} {dtype}", tol, pos3d)
        check(entries.get(entry, 0) == layers * n, f"{dtype} decode did not run on {entry}")
        prefills[dtype] = want.float()
    print(f"  {label}: bf16 prefill vs f32 prefill max_abs_err "
          f"{float((prefills['bfloat16'] - prefills['float32']).abs().max()):.3e}")
    return prefills


def moe_checks_phase(dev):
    """qwen2-moe-a2.7b at full width and depth, random f32 weights from
    seed 0: the decode profile (``profile_phase``: 8 live slots, device
    time by operation); one decode step of its 8-slot arena, dense against
    ragged; then the prefill of MOE_CHECK_TOKENS under ``impl="ragged"``
    (no capacity, so nothing dropped) against as many teacher-forced
    decode steps under the default ``"dense"`` (a decode token is a group
    of one, capacity 8 >= top-4, so nothing is dropped there either and
    the two dispatches compute one function).  JAX's own teacher-forced
    test leaves MoE out (``tests/test_models.py``), since its dense
    prefill drops tokens over capacity.

    f32 compute is the strict check, at F32_LOGITS_TOL.  In bf16 the two
    runs' residual streams part by bf16 rounding, and at this depth that
    moves a large share of the top-4 routings (the router's logits of 60
    experts lie close); a changed routing changes the output by O(1), so
    no logits tolerance is held at full depth in bf16: the error and the
    count of changed routings are printed.  bf16 is held at
    BF16_LOGITS_TOL on one layer of the same weights, where the routings
    agree."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_map

    _free()
    cfg = get_config(MOE_ARCH)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = profile_phase(dev, MOE_ARCH, params)
    ragged = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="ragged"))
    toks = torch.tensor(eng._cur, device=dev)
    print(f"{MOE_ARCH}: one decode step of the 8-slot arena, dense vs ragged:")
    for dtype, tol in (("float32", F32_LOGITS_TOL), ("bfloat16", None)):
        logits, ids = [], []
        for c in (cfg, ragged):
            arena = tree_map(lambda x: x.to(getattr(torch, dtype), copy=True) if x.is_floating_point()
                             else x.clone(), eng.arena)
            with _Routes() as r:
                logits.append(M.decode_step(c.replace(dtype=dtype), params, arena, toks)[1])
            ids.append(torch.stack([x[:, 0] for x in r.ids]))  # (L, 8, k)
        label = f"{dtype}: logits {tuple(logits[0].shape)}, {_flips(*ids)} of " \
                f"{ids[0].shape[0] * ids[0].shape[1]} (row, layer) routings differ"
        if tol is None:
            print(f"  {label}: max_abs_err {float((logits[0] - logits[1]).abs().max()):.3e} "
                  "(no tolerance held)")
        else:
            compare(label, logits[0], logits[1], tol)
    del eng, arena
    _free()
    toks = torch.randint(1, cfg.vocab_size, (1, MOE_CHECK_TOKENS),
                         generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    print(f"{MOE_ARCH}: ragged prefill of {MOE_CHECK_TOKENS} tokens vs teacher-forced dense "
          "decode from an empty cache:")
    _dtype_checks(cfg, ragged, params, toks, dev, f"{cfg.num_layers} layers", None)
    one = cfg.replace(stages=((cfg.stages[0][0], 1),))  # the first of the stacked layers
    _teacher_forced(one, ragged.replace(stages=one.stages), params, toks, dev,
                    "1 layer bfloat16", BF16_LOGITS_TOL)
    del params
    _free()


def moe_train_phase(dev):
    """qwen2-moe-a2.7b at full width and MOE_TRAIN_LAYERS of its 24 layers
    (``reduced``: 2.9 B parameters, ~46 GB of f32 weights and AdamW state),
    seq MOE_TRAIN_SEQ, batch 1, the default ``remat="dots"``,
    MOE_TRAIN_STEPS steps through ``make_train_step`` on one batch: finite
    losses and gradient norms, an aux loss above 0 on every step; prints
    the step seconds and the peak memory."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    _free()
    full = get_config(MOE_ARCH)
    cfg = full.replace(stages=((full.stages[0][0], MOE_TRAIN_LAYERS),))
    check(cfg.remat == "dots", f"remat {cfg.remat!r}")
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1), opt, dev)
    n_params = sum(p.numel() for p in tree_leaves(state["params"]))
    step = make_train_step(cfg, opt)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_SEQ + 1), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    print(f"training {MOE_ARCH} at full width, {MOE_TRAIN_LAYERS} of {full.num_layers} layers "
          f"({n_params:,} parameters), seq {MOE_TRAIN_SEQ}, batch 1, remat {cfg.remat!r}:")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, auxes, norms, secs = [], [], [], []
    for _ in range(MOE_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
        secs.append(time.perf_counter() - t0)
        auxes.append(float(out["aux"]))
        norms.append(float(out["grad_norm"]))
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    med = statistics.median(secs[1:])
    print(f"  losses {[round(x, 6) for x in losses]}")
    print(f"  aux {[round(x, 6) for x in auxes]}; gradient norms {[round(x, 4) for x in norms]}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{MOE_TRAIN_STEPS} "
          f"{med:.4f} s ({MOE_TRAIN_SEQ / med:.0f} tokens/s); peak memory {peak:.2f} GiB")
    check(all(math.isfinite(x) for x in losses + norms), "a loss or gradient norm is not finite")
    check(all(a > 0 for a in auxes), f"aux losses {auxes}")
    del state, out
    _free()


def copied_configs_phase(dev):
    """The dense configs copied with the MoE slice, and dbrx-132b, on the
    card: for each of COPIED_CHECKS, random f32 weights from seed 0, a
    prefill of COPIED_TOKENS tokens (dbrx under ``impl="ragged"``, as in
    ``moe_checks_phase``) against as many teacher-forced decode steps from
    an empty cache (``_dtype_checks``): f32 at F32_LOGITS_TOL, bf16 at
    BF16_LOGITS_TOL (dbrx's bf16 unheld, its routings part as
    qwen2-moe's).  K4 and K6 at groups 4 (minitron-8b), 3 (phi4-mini-3.8b)
    and 6 (dbrx-132b), D 128, and at group 4, D 160 (stablelm-12b)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    for arch, layers in COPIED_CHECKS:
        _free()
        full = get_config(arch)
        cfg = full if layers is None else full.replace(stages=((full.stages[0][0], layers),))
        pre = cfg if cfg.moe is None else cfg.replace(
            moe=dataclasses.replace(cfg.moe, impl="ragged"))
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        print(f"{arch} ({cfg.num_layers} of {full.num_layers} layers, full width, "
              f"{M.param_count(cfg):,} parameters, heads {cfg.num_heads}/{cfg.num_kv_heads}): "
              f"prefill of {COPIED_TOKENS} tokens vs teacher-forced decode")
        toks = torch.randint(1, cfg.vocab_size, (1, COPIED_TOKENS),
                             generator=torch.Generator(device=dev).manual_seed(6), device=dev)
        _dtype_checks(cfg, pre, params, toks, dev, arch,
                      BF16_LOGITS_TOL if cfg.moe is None else None)
        del params
    _free()


# ------------------------------------------------------------ xlstm-1.3b


def _device_events(prof):
    """(name, start ns, duration ns) of every device activity of a
    ``torch.profiler`` window, in start order, read from the raw Kineto
    results: the profiler's own ``FunctionEvent`` tree costs ~0.1 ms an
    event to build, minutes for the xlstm path's ~10^5 launches."""
    from torch.autograd import DeviceType

    out = [(e.name(), e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    check(bool(out), "the profiler recorded no device activity")
    return sorted(out, key=lambda e: e[1])


def _by_name(events, n, per):
    """Print the eight kernel names with the most device time, per ``per``."""
    tot, cnt = {}, {}
    for name, _, dur in events:
        tot[name] = tot.get(name, 0) + dur
        cnt[name] = cnt.get(name, 0) + 1
    for name in sorted(tot, key=lambda k: -tot[k])[:8]:
        print(f"    {tot[name] / n / 1e6:9.3f} ms/{per} {cnt[name] // n:7d} calls/{per}  {name[:90]}")


class _SLSTMSplit:
    """Times every ``_SLSTMScan`` forward and backward with a pair of CUDA
    events (its span on the device's timeline, idle gaps included: the loop
    is bound by the host's launches) and, with a profiler, stops the
    profiler's device collection during it: the loop launches ~10^6
    kernels a training step, more than the trace's buffers hold, so a
    profile of the path shows the rest of the work."""

    def __init__(self, prof=None):
        from torch.profiler import ProfilerActivity

        self.prof, self.cuda, self.spans = prof, [ProfilerActivity.CUDA], []

    def __enter__(self):
        from repro_torch.layers import xlstm

        self.cls = xlstm._SLSTMScan
        self.fwd, self.bwd = self.cls.forward, self.cls.backward

        def split(fn):
            def run(ctx, *args):
                if self.prof is not None:
                    self.prof.toggle_collection_dynamic(False, self.cuda)
                start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(ctx, *args)
                stop.record()
                if self.prof is not None:
                    self.prof.toggle_collection_dynamic(True, self.cuda)
                self.spans.append((start, stop))
                return out
            return staticmethod(run)

        self.cls.forward, self.cls.backward = split(self.fwd), split(self.bwd)
        return self

    def __exit__(self, *exc):
        self.cls.forward, self.cls.backward = staticmethod(self.fwd), staticmethod(self.bwd)

    def ms(self):
        """The spans' sum in ms (after a synchronize)."""
        return sum(a.elapsed_time(b) for a, b in self.spans)


def _gemm(name):
    return any(k in name.lower() for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90_"))


def slstm_phase(dev):
    """The sLSTM alone, first of the xlstm phases: ``slstm_scan`` on one
    layer of xlstm-1.3b's width (random f32 weights), x of SLSTM_SHAPE in
    bf16, the recurrence in f32: the forward, and the forward with its
    backward, timed with CUDA events around eager calls (the loop is
    bound by the host's launches, which the events' span includes), in
    turns; then the launches and device time a time step, from the
    profiles of both at two short lengths (their difference over the
    difference of lengths).  Returns the times in ms."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.layers import xlstm

    cfg = get_config(XLSTM_ARCH)
    heads, dt = cfg.num_heads, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(7)
    params = {k: v.requires_grad_() for k, v in
              xlstm.init_slstm(g, cfg.d_model, heads, torch.float32, dev).items()}
    x = torch.randn(SLSTM_SHAPE, generator=g, device=dev).to(dt)

    def fwd(x):
        with torch.no_grad():
            return xlstm.slstm_scan(params, x, heads, dt)[0]

    def fwd_bwd(x):
        y, _ = xlstm.slstm_scan(params, x, heads, dt)
        return torch.autograd.grad(y, list(params.values()), torch.ones_like(y))

    ops.reset_launch_counts()
    print(f"sLSTM alone at {SLSTM_SHAPE} (xlstm-1.3b's width, {heads} heads of "
          f"{cfg.d_model // heads}), bf16 compute, f32 recurrence:")
    fns = {"forward": fwd, "forward+backward": fwd_bwd}
    for f in fns.values():
        f(x)
    times = {k: [] for k in fns}
    for r in range(2):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fns[k](x)
            stop.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(stop))
    check(all(v == 0 for v in ops.LAUNCHES.values()), f"the sLSTM launched kernels {ops.LAUNCHES}")
    ms = {k: min(v) for k, v in times.items()}
    steps = SLSTM_SHAPE[1]
    for k in fns:
        print(f"  {k}: {times[k]} ms (CUDA events, eager), {1e3 * ms[k] / steps:.2f} us a time step")
    counts = {}
    for k, f in fns.items():
        for s in SLSTM_COUNT_LENGTHS:
            xs = x[:, :s].contiguous()
            f(xs)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                f(xs)
                torch.cuda.synchronize()
            ev = _device_events(prof)
            counts[k, s] = (len(ev), sum(e[2] for e in ev))
        (n0, d0), (n1, d1) = counts[k, SLSTM_COUNT_LENGTHS[0]], counts[k, SLSTM_COUNT_LENGTHS[1]]
        ds = SLSTM_COUNT_LENGTHS[1] - SLSTM_COUNT_LENGTHS[0]
        per_step, dev_us = (n1 - n0) / ds, (d1 - d0) / ds / 1e3
        ms[k + " launches/step"], ms[k + " device us/step"] = per_step, dev_us
        print(f"  {k}: {per_step:.2f} device launches a time step, {dev_us:.2f} us of device a "
              f"time step (profiles at S = {SLSTM_COUNT_LENGTHS}: {n0} and {n1} launches)")
    del params, x
    _free()
    return ms


def xlstm_card_vs_cpu_check(dev):
    """Every xLSTM path at smoke size (``mlstm`` and ``slstm`` blocks, d
    64, chunk 16) in f32 on the card against the same on the CPU, from the
    same weights and tokens: one train step (loss and gradient norm; the
    clipped gradients, from the first moments, to 1e-4 of each leaf's
    largest entry), the prefill's logits at 1e-4 and every cache leaf to
    1e-4 of its largest entry, 8 decode steps at F32_LOGITS_TOL (the card
    and the CPU sum the states' products in other orders, and the
    recurrent steps carry the difference: 2.1e-4 on an H100); then
    teacher-forced decode from an empty cache against prefill on the
    card, at F32_LOGITS_TOL.  No kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves, tree_map

    cfg = get_config(XLSTM_ARCH, smoke=True).replace(dtype="float32")
    print(f"{XLSTM_ARCH} smoke (f32) on the card vs on the CPU:")
    ops.reset_launch_counts()
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2)
    toks = torch.randint(1, cfg.vocab_size, (2, 41), generator=torch.Generator().manual_seed(6))
    batch = {"tokens": toks[:, :32], "labels": toks[:, 1:33]}
    init = init_train_state(cfg, torch.Generator().manual_seed(1), AdamW(opt_cfg), "cpu")
    outs = {}
    for d in ("cpu", dev):
        state = tree_map(lambda x: x.clone().to(d), init)
        state, out = make_train_step(cfg, AdamW(opt_cfg))(state, {k: v.to(d) for k, v in batch.items()})
        params = tree_map(lambda x: x.to(d), init["params"])
        cache, pre = M.prefill(cfg, params, toks[:, :32].to(d))
        pre_leaves = [x.clone() for x in tree_leaves(cache["stages"])]
        steps = []
        for t in range(32, 40):
            cache, logits = M.decode_step(cfg, params, cache, toks[:, t:t + 1].to(d))
            steps.append(logits)
        outs[d] = (state, {k: float(v) for k, v in out.items()}, pre, pre_leaves, steps)
    (cs, co, cpre, cleaves, csteps), (gs, go, gpre, gleaves, gsteps) = outs["cpu"], outs[dev]
    for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        err = abs(go[k] - co[k]) / abs(co[k])
        print(f"  train step {k}: card {go[k]:.7f}, CPU {co[k]:.7f}, relative error {err:.2e} "
              f"(tol {tol:g})")
        check(err <= tol, f"train step {k} differs")
    worst = _worst_leaf(tree_leaves(gs["opt"]["mu"]), tree_leaves(cs["opt"]["mu"]))
    print(f"  the step's gradients (first moments): worst leaf {worst:.2e} of its largest entry "
          "(tol 1e-4)")
    check(worst <= 1e-4, "the train step's gradients differ")
    compare(f"prefill logits {tuple(gpre.shape)}", gpre.cpu(), cpre, 1e-4)
    worst = _worst_leaf(gleaves, cleaves)
    print(f"  prefill cache: {len(gleaves)} leaves, worst |card - CPU| {worst:.2e} of the leaf's "
          "largest entry (tol 1e-4)")
    check(worst <= 1e-4, "a prefill cache leaf differs")
    compare(f"8 decode steps' logits {tuple(gsteps[0].shape)}", torch.stack(gsteps).cpu(),
            torch.stack(csteps), F32_LOGITS_TOL)
    params = tree_map(lambda x: x.to(dev), init["params"])
    t_toks = toks[:1, :32].to(dev)
    _, want = M.prefill(cfg, params, t_toks)
    cache = M.init_decode_cache(cfg, 1, 32, dev)
    for t in range(32):
        cache, got = M.decode_step(cfg, params, cache, t_toks[:, t:t + 1])
    compare("on the card: 32 teacher-forced decode steps vs prefill", got, want, F32_LOGITS_TOL)
    check(all(v == 0 for v in ops.LAUNCHES.values()), f"the xlstm path launched kernels {ops.LAUNCHES}")


def xlstm_train_phase(dev):
    """The LM training path at xlstm-1.3b's full width and depth through
    the launcher (XLSTM_TRAIN_ARGS: f32 weights, bf16 compute, the default
    ``remat="dots"``): XLSTM_TRAIN_STEPS steps, a finite first loss and no
    kernel launch (no kernel is on this path).  At the reference's
    initialisation the first gradient overflows in the lowest layers
    (``_gradient_by_period``; JAX's own gradient grows ~2e5 over one
    period at this width: ``tools/kernel_xlstm_depth.py``,
    ``tests/test_torch_xlstm.py::test_full_width_period_matches_jax_as_closely_as_a_rounding_of_its_weights``),
    so the later losses are not finite: printed, not held.  Prints the
    losses, the step times, Eq. 1's numbers and the peak memory."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(XLSTM_ARCH)
    n_slstm = sum(p.count("slstm") * r for p, r in cfg.stages)
    print(f"training {XLSTM_ARCH} at full width ({cfg.num_layers} layers, {n_slstm} sLSTM, remat "
          f"{cfg.remat!r}):", " ".join(XLSTM_TRAIN_ARGS))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summary = train.main(XLSTM_TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps, secs = summary["steps"], summary["step_seconds"]
    med = statistics.median(secs[1:])
    print(f"  run incl. init and data {wall:.1f} s; launches {launches}")
    print(f"  losses {summary['losses']}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{steps} {med:.4f} s "
          f"({4096 / med:.0f} tokens/s)")
    print(f"  Eq. 1: t_load {summary['t_load']:.4f} s, t_comp {summary['t_comp']:.4f} s, t_overlap "
          f"{summary['t_overlap']:.4f} s, t_unhidden_load {summary['t_unhidden_load']:.4f} s; peak "
          f"memory {summary['peak_memory_gib']:.2f} GiB")
    losses = summary["losses"]
    check(steps == XLSTM_TRAIN_STEPS and len(losses) == steps,
          f"{steps} steps, want {XLSTM_TRAIN_STEPS}")
    check(bool(np.isfinite(losses[0])), f"the first loss {losses[0]} is not finite")
    if not all(np.isfinite(losses)):
        print("  the losses after the first update are not finite: the first step's gradient "
              "overflows in the lowest layers (xlstm_train_profile prints it a period)")
    check(all(v == 0 for v in launches.values()) and not ops.ENTRY_LAUNCHES,
          f"the xlstm training path launched kernels: {launches}")
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    check(summary["peak_memory_gib"] <= card_gib - 5,
          f"peak {summary['peak_memory_gib']:.2f} of the card's {card_gib:.2f} GiB")
    return med


def _gradient_by_period(cfg, params, batch):
    """The first step's gradient at full depth (``loss_fn`` and autograd):
    the largest |gradient| of each period's first mLSTM ``w_down`` and its
    sLSTM ``w_in``, top period last.  Holds the top period finite (the
    backward through it is sound); at the reference's initialisation the
    gradient grows ~10^7 a period downwards and overflows in the lowest."""
    from repro_torch.models import model as M
    from repro_torch.utils.tree import tree_leaves, tree_unflatten

    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    loss, _ = M.loss_fn(cfg, tree, batch)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    stage = tree["stages"][0]
    for label, leaf in (("mLSTM w_down", stage[0]["mlstm"]["w_down"]),
                        ("sLSTM w_in", stage[-1]["slstm"]["w_in"])):
        g = grads[id(leaf)]
        per = [float(x.abs().max()) for x in g.float()]
        print(f"  first-step |gradient| max by period, {label}: " + ", ".join(f"{v:.3e}" for v in per))
        check(bool(torch.isfinite(g[-1]).all()), f"the top period's {label} gradient is not finite")
    del grads, leaves
    _free()


def xlstm_train_profile(dev, slstm, steps=XLSTM_PROFILE_STEPS):
    """Where an xlstm-1.3b training step's time goes (``"dots"``): after
    ``_gradient_by_period`` (which warms up), ``steps`` steps on the host
    clock with every sLSTM
    forward and backward timed on the device's timeline (the sLSTM loop's
    share of the step, in place); then ``steps`` under the profiler
    (device activity only, the sLSTM loop left out: ``_SLSTMSplit``):
    device time by class (GEMM, other elementwise and copies) and the
    busy share, the loop's own device time from ``slstm_phase``'s
    per-step profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step

    _free()
    cfg = get_config(XLSTM_ARCH)
    n_slstm = sum(p.count("slstm") * r for p, r in cfg.stages)
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(1), opt, dev)
    step = make_train_step(cfg, opt)
    toks = torch.randint(0, cfg.vocab_size, (1, 4097), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    _gradient_by_period(cfg, state["params"], batch)  # and the warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    norms = []
    with _SLSTMSplit() as timed:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(state, batch)
            norms.append(float(out["grad_norm"]))
        torch.cuda.synchronize()
        plain = 1e3 * (time.perf_counter() - t0) / steps
    check(len(timed.spans) == 2 * n_slstm * steps,
          f"{len(timed.spans)} sLSTM forwards and backwards, want {2 * n_slstm * steps}")
    loop = timed.ms() / steps
    with profile(activities=[ProfilerActivity.CUDA]) as prof, _SLSTMSplit(prof) as split:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, out = step(state, batch)
            float(out["loss"])
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    events = _device_events(prof)
    busy = sum(e[2] for e in events) / steps / 1e6
    gemm = sum(e[2] for e in events if _gemm(e[0])) / steps / 1e6
    loop_dev = n_slstm * SLSTM_SHAPE[1] * slstm["forward+backward device us/step"] / 1e3
    print(f"profile of {steps} xlstm-1.3b training steps (remat 'dots', seq 4096): wall "
          f"{plain:.1f} ms/step unprofiled, {wall:.1f} under the profiler; gradient norms {norms}; "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    print(f"  the sLSTM loop ({n_slstm} layers, forward and backward): {loop:.1f} ms/step on the "
          f"device's timeline, {loop / plain:.3f} of the step; its device time {loop_dev:.1f} "
          f"ms/step (slstm_phase's {slstm['forward+backward device us/step']:.2f} us a layer and "
          f"time step), {n_slstm * SLSTM_SHAPE[1] * slstm['forward+backward launches/step']:.0f} "
          "launches a step")
    print(f"  outside the loop: device busy {busy:.1f} ms/step (GEMM {gemm:.1f}, other "
          f"elementwise and copies {busy - gemm:.1f}), {len(events) / steps:.0f} device ops/step; "
          f"the step's busy share {(busy + loop_dev) / plain:.3f} (the loop's device time "
          f"included; trace read in {time.perf_counter() - t0:.1f} s)")
    check(len(split.spans) == 2 * n_slstm * steps, "the profiled steps ran another sLSTM count")
    _by_name(events, steps, "step")
    del state, out, prof
    _free()


def xlstm_decode_phase(dev, slstm):
    """xlstm-1.3b at published width and depth (random f32 weights from
    seed 0, bf16 compute) through the step functions: prefill
    XLSTM_BATCH x XLSTM_PROMPT tokens, then XLSTM_DECODE greedy decode
    steps, each count from 0 just before.  Checks the cache's leaf
    shapes, every ``m`` finite and past the -1e30 start after the
    prefill, no kernel launch, finite logits and ``pos``.  Prints prefill
    ms, decode ms a step, tokens/s and peak memory, and the device time
    and busy share of XLSTM_DECODE_PROFILE decode steps and of one
    prefill (the sLSTM loop's device time from ``slstm_phase``'s per-step
    profile); then the teacher-forced check."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.layers.xlstm import mlstm_width
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    _free()
    cfg = get_config(XLSTM_ARCH)
    b, heads = XLSTM_BATCH, cfg.num_heads
    hd_m, hd_s = mlstm_width(cfg.d_model, cfg.mlstm_proj_factor) // heads, cfg.d_model // heads
    print(f"{XLSTM_ARCH} prefill and decode at full width ({cfg.num_layers} layers, bf16 compute, "
          f"{M.param_count(cfg):,} parameters): prefill {b} x {XLSTM_PROMPT}, {XLSTM_DECODE} decode "
          "steps")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(1, cfg.vocab_size, (b, XLSTM_PROMPT),
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, toks)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    check(all(v == 0 for v in ops.LAUNCHES.values()), f"prefill launched kernels {ops.LAUNCHES}")
    print(f"  prefill {1e3 * prefill_s:.1f} ms ({b * XLSTM_PROMPT / prefill_s:.0f} tokens/s), peak "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    (pattern, repeats), = cfg.stages
    want = {"mlstm": {"C": (b, heads, hd_m, hd_m), "n": (b, heads, hd_m), "m": (b, heads)},
            "slstm": {k: (b, heads, hd_s) for k in "cnmh"}}
    for kind, leaves in zip(pattern, cache["stages"][0]):
        check({k: tuple(v.shape) for k, v in leaves.items()}
              == {k: (repeats,) + s for k, s in want[kind].items()},
              f"{kind} cache {[tuple(v.shape) for v in leaves.values()]}")
        check(all(v.dtype == torch.float32 for v in leaves.values()), f"{kind} cache dtypes")
        m = leaves["m"]
        check(bool(torch.isfinite(m).all()) and bool((m > -1e29).all()),
              f"{kind} m after prefill: min {float(m.min()):.3e}")
    print(f"  cache: {len(pattern) * repeats} layers' states, "
          f"{sum(v.numel() * 4 for leaves in cache['stages'][0] for v in leaves.values()) / 2**30:.2f}"
          " GiB in f32; every m finite")
    tok = _greedy(logits)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(XLSTM_DECODE):
        cache, logits = decode(params, cache, tok)
        tok = _greedy(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    check(all(v == 0 for v in ops.LAUNCHES.values()) and not ops.ENTRY_LAUNCHES,
          f"decode launched kernels {ops.LAUNCHES}")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(int(cache["pos"]) == XLSTM_PROMPT + XLSTM_DECODE, f"pos {int(cache['pos'])}")
    print(f"  decode {1e3 * decode_s / XLSTM_DECODE:.2f} ms a step (host clock, {b} rows, "
          f"{b * XLSTM_DECODE / decode_s:.0f} tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CUDA]) as prof, _SLSTMSplit() as split:
        t0 = time.perf_counter()
        for _ in range(XLSTM_DECODE_PROFILE):
            cache, logits = decode(params, cache, tok)
            tok = _greedy(logits)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = _device_events(prof)
    busy = sum(e[2] for e in events) / XLSTM_DECODE_PROFILE / 1e6
    print(f"  profile of {XLSTM_DECODE_PROFILE} decode steps: wall "
          f"{1e3 * wall / XLSTM_DECODE_PROFILE:.2f} ms/step under the profiler, device busy "
          f"{busy:.2f} ms/step, {len(events) / XLSTM_DECODE_PROFILE:.0f} device ops/step; busy "
          f"share {busy / (1e3 * decode_s / XLSTM_DECODE):.3f} of the unprofiled step; the sLSTM "
          f"layers' spans {split.ms() / XLSTM_DECODE_PROFILE:.2f} ms/step")
    _by_name(events, XLSTM_DECODE_PROFILE, "step")
    del cache, logits
    _free()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, _SLSTMSplit(prof) as split:
        t0 = time.perf_counter()
        prefill(params, toks)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = _device_events(prof)
    busy = sum(e[2] for e in events) / 1e6
    loop = split.ms()
    n_slstm = sum(p.count("slstm") * r for p, r in cfg.stages)
    loop_dev = n_slstm * XLSTM_PROMPT * slstm["forward device us/step"] / 1e3
    print(f"  profile of one prefill ({wall:.1f} ms under the profiler): the sLSTM loop "
          f"{loop:.1f} ms on the device's timeline ({loop / (1e3 * prefill_s):.3f} of the "
          f"unprofiled prefill), ~{loop_dev:.1f} ms of device at B = 1's rate; outside it device "
          f"busy {busy:.1f} ms, {len(events)} device ops; busy share "
          f"{(busy + loop_dev) / (1e3 * prefill_s):.3f}")
    _by_name(events, 1, "prefill")
    xlstm_teacher_forced_check(cfg, params, dev)
    del params
    _free()


def _teacher_forced_xlstm(cfg, params, toks, dev):
    """{dtype: (last decode logits, prefill logits)} in f32 and bf16
    compute: ``len(toks)`` decode steps from ``init_decode_cache`` (the
    stabilisers at -1e30) against ``prefill`` over the same tokens; no
    kernel launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    n = toks.shape[1]
    ops.reset_launch_counts()
    runs = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        _, want = M.prefill(c, params, toks)
        cache = M.init_decode_cache(c, 1, n, dev)
        for i in range(n):
            cache, got = M.decode_step(c, params, cache, toks[:, i:i + 1])
        runs[dtype] = (got.float(), want.float())
    torch.cuda.synchronize()
    check(all(v == 0 for v in ops.LAUNCHES.values()), f"the check launched kernels {ops.LAUNCHES}")
    return runs


def xlstm_teacher_forced_check(cfg, params, dev):
    """The form of ``tests/test_models.py::test_decode_matches_prefill_logits``
    at full width: XLSTM_TEACHER decode steps from an empty cache against
    ``prefill`` over the same tokens (one chunk of the chunkwise mLSTM;
    XLSTM_TEACHER_HELD, two chunks, for the held check).

    Nothing is held at 48 layers: f32 and bf16 are printed.  The reference
    is ill-conditioned at this width and initialisation: at 8 layers JAX's
    own f32 decode lies 1.5e-2 from its own prefill after 8 tokens
    (``tools/kernel_xlstm_depth.py``; held in
    ``tests/test_torch_xlstm.py::test_full_width_teacher_forced_decode_parts_from_prefill_in_jax_too``),
    and 48 layers make it O(1).  f32 is held at F32_LOGITS_TOL on one
    layer of each kind (XLSTM_HELD_PATTERN, the full config's first mLSTM
    and its sLSTM, full width), the check that the caches carry the
    state; the same run from a cache whose stabilisers start at 0 (the
    fault ``init_decode_cache`` had) must fall outside it.  bf16 there is
    printed: its rounding (~3e-2) hides that fault."""
    from repro_torch.models import model as M

    toks = torch.randint(1, cfg.vocab_size, (1, XLSTM_TEACHER),
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    t0 = time.perf_counter()
    runs = _teacher_forced_xlstm(cfg, params, toks, dev)
    (got32, want32), (got16, want16) = runs["float32"], runs["bfloat16"]
    print(f"  teacher-forced decode of {XLSTM_TEACHER} tokens vs prefill, {cfg.num_layers} layers "
          f"({time.perf_counter() - t0:.1f} s; logits max |{float(want32.abs().max()):.3f}|): f32 "
          f"max_abs_err {float((got32 - want32).abs().max()):.3e}, bf16 "
          f"{float((got16 - want16).abs().max()):.3e}, the bf16 prefill "
          f"{float((want16 - want32).abs().max()):.3e} from the f32 one (none held)")
    check(bool(torch.isfinite(got32).all() and torch.isfinite(got16).all()), "logits not finite")
    (pattern, _), = cfg.stages
    pick = [pattern.index(kind) for kind in XLSTM_HELD_PATTERN]
    held = cfg.replace(stages=((XLSTM_HELD_PATTERN, 1),))
    sub = dict(params, stages=[tuple(
        {k: ({kk: vv[:1] for kk, vv in v.items()} if isinstance(v, dict) else v[:1])
         for k, v in params["stages"][0][i].items()} for i in pick)])
    toks = torch.randint(1, cfg.vocab_size, (1, XLSTM_TEACHER_HELD),
                         generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    runs = _teacher_forced_xlstm(held, sub, toks, dev)
    (got32, want32), (got16, want16) = runs["float32"], runs["bfloat16"]
    print(f"  {held.num_layers} layers ({', '.join(XLSTM_HELD_PATTERN)}), {XLSTM_TEACHER_HELD} "
          f"tokens: bf16 max_abs_err {float((got16 - want16).abs().max()):.3e}, the bf16 prefill "
          f"{float((want16 - want32).abs().max()):.3e} from the f32 one (not held)")
    compare(f"{held.num_layers} layers, f32 last logits {tuple(got32.shape)}", got32, want32,
            F32_LOGITS_TOL)
    f32 = held.replace(dtype="float32")
    cache = M.init_decode_cache(f32, 1, XLSTM_TEACHER_HELD, dev)
    for leaves in cache["stages"][0]:
        leaves["m"].zero_()
    for i in range(XLSTM_TEACHER_HELD):
        cache, got = M.decode_step(f32, sub, cache, toks[:, i:i + 1])
    err = (got.float() - want32).abs()
    print(f"  the same f32 decode from stabilisers at 0: max_abs_err {float(err.max()):.3e} (must "
          f"fall outside tol {F32_LOGITS_TOL:g})")
    check(bool((err > F32_LOGITS_TOL + F32_LOGITS_TOL * want32.abs()).any()),
          "the held check cannot tell a cache with m = 0 from a sound one")


# --------------------------------------- whisper-tiny and qwen2-vl-72b


def faults_seen(label, want, tol, faults):
    """Each planted fault's output against ``want`` must breach ``tol`` as
    ``compare`` reads it: the check just made would fail on a kernel with
    that fault.  ``faults``: {what: the kernel's output with it}."""
    want = want.float()
    for what, got in faults.items():
        err = (got.float() - want).abs()
        seen = bool((err > tol + tol * want.abs()).any())
        print(f"  planted fault, {label}, {what}: max_abs_err {float(err.max()):.3e} (tol {tol:g}) "
              f"{'breaches' if seen else 'UNSEEN'}")
        check(seen, f"{label}: the check does not see {what}")


def whisper_kernel_phase(dev):
    """K4 with ``causal=False`` and K6 at whisper-tiny's shapes (6 heads of
    64, group 1) against their plain versions: K4 at the encoder's q, k, v
    (B, 1500, 6, 64) and at cross-attention's q (B, WHISPER_PROMPT, 6, 64)
    against k, v (B, 1500, 6, 64), in bf16 (the tensor-core kernel) and f32
    (the CUDA-core one); K6 on the cross cache, q (B, 6, 64) against (B,
    1500, 6, 64), at cur = T - 1 (cross-attention's), T - 2, 0 and past T,
    in bf16 (the cluster kernel: 3 splits of 512 keys) and f32.  Each on
    N(0, 1) inputs and on ``ref.edge_probe``'s, whose answer hangs on the
    last key and nothing past it; on those, ``faults_seen`` shows that
    the same limit fails a kernel that drops the ragged last tile, stops
    one key short or attends zero-filled keys past T.  Then the three
    bf16 calls timed (N(0, 1) inputs) beside the bound and SDPA.  Returns the timed
    entries: ``{"flash_attention": {"encoder", "cross"}, "flash_decode":
    {"cross"}}``."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    b, h, d, t, s = WHISPER_BATCH, 6, 64, 1500, WHISPER_PROMPT
    g = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, dt=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=dev).to(dt)

    print("whisper-tiny's attention: flash_attention causal=False (encoder, cross) and "
          "flash_decode on the 1,500-frame cross cache, vs plain versions:")
    check(ops._attention_kernel(torch.bfloat16, d, 1) == "wgmma"
          and ops._decode_kernel(torch.bfloat16, d) == "cluster",
          "whisper-tiny's bf16 attention does not route to the tensor-core K4 and the cluster K6")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"  K6 at B = {b}: (splits, keys a split) {ops._decode_splits(b, h, t, sms)} on {sms} SMs; "
          f"at B = 1: {ops._decode_splits(1, h, t, sms)}")
    whole, cut = -(-t // 64) * 64, t // 64 * 64  # T rounded up and down to 64-key tiles

    def pad(x):  # zero keys up to a whole tile, as a TMA load past T fills them
        return torch.cat([x, x.new_zeros(b, whole - t, h, d)], 1)

    for dt in (torch.bfloat16, torch.float32):
        tol = TOL[str(dt)]
        for label, sq in (("encoder", t), ("cross", s)):
            q, k, v = randn(b, sq, h, d, dt=dt), randn(b, t, h, d, dt=dt), randn(b, t, h, d, dt=dt)
            what = (f"{dt} K4 {label} q{tuple(q.shape)} kv{tuple(k.shape)} causal=False "
                    f"({ops._attention_kernel(dt, d, 1)})")
            compare(what, ops.flash_attention(q, k, v, False), ref.flash_attention(q, k, v, False),
                    tol)
            q, k, v = ref.edge_probe((b, sq, h, d), (b, t, h, d), dt, g)
            want = ref.flash_attention(q, k, v, False)
            compare(f"{what}, edge probe", ops.flash_attention(q, k, v, False), want, tol)
            faults_seen(f"{dt} K4 {label}", want, tol, {
                f"edge mask off (zero keys to {whole})": ops.flash_attention(q, pad(k), pad(v), False),
                f"last partial tile dropped (T = {cut})": ops.flash_attention(
                    q, k[:, :cut].contiguous(), v[:, :cut].contiguous(), False)})
        q, kc, vc = randn(b, h, d, dt=dt), randn(b, t, h, d, dt=dt), randn(b, t, h, d, dt=dt)
        for c in (t - 1, t - 2, 0, t + 9):
            cur = torch.full((b,), c, dtype=torch.int32, device=dev)
            compare(f"{dt} K6 q{tuple(q.shape)} cache{tuple(kc.shape)} cur={c} "
                    f"({ops._decode_kernel(dt, d)})", ops.flash_decode(q, kc, vc, cur),
                    ref.flash_decode(q, kc, vc, cur), tol)
        q, kc, vc = ref.edge_probe((b, 1, h, d), (b, t, h, d), dt, g)
        q = q[:, 0].contiguous()
        for c in (t - 1, t - 2, 0, t + 9):
            cur = torch.full((b,), c, dtype=torch.int32, device=dev)
            compare(f"{dt} K6 cur={c}, edge probe", ops.flash_decode(q, kc, vc, cur),
                    ref.flash_decode(q, kc, vc, cur), tol)
        cur = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
        want = ref.flash_decode(q, kc, vc, cur)
        faults_seen(f"{dt} K6 cur = {t - 1}", want, tol, {
            f"cur one short ({t - 2})": ops.flash_decode(q, kc, vc, cur - 1),
            f"edge mask off (zero keys to {whole})": ops.flash_decode(
                q, pad(kc), pad(vc), cur + whole - t),
            f"last partial tile dropped (T = {cut})": ops.flash_decode(
                q, kc[:, :cut].contiguous(), vc[:, :cut].contiguous(), cur + cut - t)})
    out = {"flash_attention": {}, "flash_decode": {}}
    for label, sq in (("encoder", t), ("cross", s)):
        q, k, v = randn(b, sq, h, d), randn(b, t, h, d), randn(b, t, h, d)
        err = compare(f"timed inputs K4 {label}", ops.flash_attention(q, k, v, False),
                      ref.flash_attention(q, k, v, False), TOL["torch.bfloat16"])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        tm, eager = time_ms({
            "kernel": lambda: ops.flash_attention(q, k, v, False),
            "plain": lambda: ref.flash_attention(q, k, v, False),
            "library": lambda: F.scaled_dot_product_attention(qt, kt, vt),
        }, n=20)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v in; o out
        row = dict(max_abs_err=err, ms=tm["kernel"], plain_ms=tm["plain"],
                   **bound(nbytes, 4 * b * sq * t * h * d, BF16_FLOPS), library_ms=tm["library"])
        out["flash_attention"][label] = row
        print(f"  K4 {label} q{tuple(q.shape)} kv{tuple(k.shape)}: device ms per call {tm}; eager "
              f"{eager}; bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} bytes); "
              f"kernel at {row['bound_ms'] / tm['kernel']:.3f} of it, SDPA at "
              f"{row['bound_ms'] / tm['library']:.3f}")
    q, kc, vc = randn(b, h, d), randn(b, t, h, d), randn(b, t, h, d)
    cur = torch.full((b,), t - 1, dtype=torch.int32, device=dev)
    err = compare("timed inputs K6 cross", ops.flash_decode(q, kc, vc, cur),
                  ref.flash_decode(q, kc, vc, cur), TOL["torch.bfloat16"])
    q4 = q[:, :, None]
    kt, vt = (x.transpose(1, 2).contiguous() for x in (kc, vc))
    tm, eager = time_ms({
        "kernel": lambda: ops.flash_decode(q, kc, vc, cur),
        "plain": lambda: ref.flash_decode(q, kc, vc, cur),
        "library": lambda: F.scaled_dot_product_attention(q4, kt, vt),  # cur = T - 1: every key
    })
    nbytes = 2 * (2 * q.numel() + kc.numel() + vc.numel()) + 4 * b
    row = dict(max_abs_err=err, ms=tm["kernel"], plain_ms=tm["plain"],
               **bound(nbytes, 4 * b * t * h * d, BF16_FLOPS), library_ms=tm["library"])
    out["flash_decode"]["cross"] = row
    print(f"  K6 cross q{tuple(q.shape)} cache{tuple(kc.shape)} cur = {t - 1}: device ms per call "
          f"{tm}; eager {eager}; bound {row['bound_ms']:.6f} ms ({row['bound_by']}, {nbytes} "
          f"bytes); kernel at {row['bound_ms'] / tm['kernel']:.3f} of it, SDPA at "
          f"{row['bound_ms'] / tm['library']:.3f}")
    return out


def _whisper_inputs(cfg, dev):
    """Seeded (B, 1500, 384) f32 frames and (B, 448) tokens."""
    enc = cfg.encoder
    frames = torch.randn(WHISPER_BATCH, enc.num_frames, enc.d_input,
                         generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    toks = torch.randint(1, cfg.vocab_size, (WHISPER_BATCH, WHISPER_TEXT + 1), dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    return frames, toks


def whisper_train_phase(dev):
    """whisper-tiny at published width and depth (random f32 weights,
    bf16 compute, AdamW, ``remat="dots"``) for WHISPER_TRAIN_STEPS steps
    through ``make_train_step``, B = 8 over 1,500 frames and 448 tokens:
    finite losses, every encoder leaf's gradient non-zero (read from the
    first moments after step 1), and no kernel launch (training attention
    is the plain ``sdpa``, as JAX's); prints the step times and the peak
    memory."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.steps import init_train_state, make_train_step
    from repro_torch.utils.tree import tree_leaves

    _free()
    cfg = get_config(WHISPER_ARCH)
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=10))
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0), opt, dev)
    step = make_train_step(cfg, opt)
    frames, toks = _whisper_inputs(cfg, dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "encoder_frames": frames}
    print(f"training {WHISPER_ARCH} at full width and depth ({cfg.num_layers} dec_attn + "
          f"{cfg.encoder.stages[0][1]} enc_attn layers, {WHISPER_BATCH} x {WHISPER_TEXT} tokens "
          f"over {cfg.encoder.num_frames} frames, remat {cfg.remat!r}):")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, secs = [], []
    for i in range(WHISPER_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, out = step(state, batch)
        losses.append(float(out["loss"]))
        secs.append(time.perf_counter() - t0)
        if i == 0:
            mu = tree_leaves(state["opt"]["mu"]["encoder"])
            zero = sum(float(m.abs().max()) == 0.0 for m in mu)
            print(f"  step 1: {len(mu)} encoder gradient leaves, {zero} of them zero")
            check(zero == 0, "an encoder gradient leaf is zero")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    med = statistics.median(secs[1:])
    print(f"  losses {[round(x, 6) for x in losses]}")
    print(f"  step seconds {[round(x, 4) for x in secs]}; median of steps 2-{WHISPER_TRAIN_STEPS} "
          f"{med:.4f} s ({WHISPER_BATCH * WHISPER_TEXT / med:.0f} tokens/s, "
          f"{WHISPER_BATCH * cfg.encoder.num_frames / med:.0f} frames/s); peak memory {peak:.2f} GiB; "
          f"launches {dict(ops.LAUNCHES)}")
    check(all(math.isfinite(x) for x in losses), "a whisper-tiny loss is not finite")
    check(all(v == 0 for v in ops.LAUNCHES.values()), f"training launched kernels {ops.LAUNCHES}")
    del state, out
    _free()


def whisper_serve_phase(dev):
    """whisper-tiny at published width and depth (random f32 weights from
    seed 0, bf16 compute) through the step functions: prefill B x
    WHISPER_PROMPT tokens with the frames, ``extend_cache`` by
    WHISPER_DECODE, then WHISPER_DECODE greedy decode steps (448
    positions), every count from 0 just before each.  Checks 12 K4
    launches in the prefill (4 encoder, 4 decoder self, 4 cross), all on
    the tensor-core kernel; 8 K6 launches a decode step (4 self, 4 cross),
    all on the cluster kernel; the cross K/V ``torch.equal`` before and
    after decode; finite logits.  Prints prefill ms, decode ms a step,
    tokens/s, peak memory and a profile of WHISPER_PROFILE_STEPS steady
    steps (past the arena's end: each writes its last slot and attends all
    448).  Then the teacher-forced check.  Returns the launches of the
    prefill (K4) and the decode (K6)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    _free()
    cfg = get_config(WHISPER_ARCH)
    enc_layers = sum(len(p) * r for p, r in cfg.encoder.stages)
    dec_layers = cfg.num_layers
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    frames, toks = _whisper_inputs(cfg, dev)
    extras = {"encoder_frames": frames}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    b, prompt = WHISPER_BATCH, toks[:, :WHISPER_PROMPT]
    print(f"{WHISPER_ARCH} serving at full width and depth ({M.param_count(cfg):,} parameters): "
          f"prefill {b} x {WHISPER_PROMPT} tokens over {cfg.encoder.num_frames} frames, "
          f"extend_cache by {WHISPER_DECODE}, {WHISPER_DECODE} greedy decode steps")
    warm, _ = prefill(params, prompt, extras)  # first-call costs out of the timed prefill
    decode(params, M.extend_cache(cfg, warm, 1), prompt[:, -1:])
    del warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    cache, logits = prefill(params, prompt, extras)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    pre, pre_entries = dict(ops.LAUNCHES), dict(ops.ENTRY_LAUNCHES)
    want = enc_layers + 2 * dec_layers
    print(f"  prefill {1e3 * prefill_s:.2f} ms ({b * WHISPER_PROMPT / prefill_s:.0f} tokens/s), "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {pre}, "
          f"by entry point {pre_entries}")
    check(pre["flash_attention"] == want, f"prefill launched K4 {pre['flash_attention']} times, "
          f"want {want}")
    check(pre_entries.get("repro_torch_flash_attention_wgmma", 0) == want,
          "a prefill K4 launch missed the tensor-core kernel")
    check(pre["flash_decode"] == 0, f"prefill launched K6 {pre['flash_decode']} times")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    layer = cache["stages"][0][0]
    check(tuple(layer["ck"].shape) == (dec_layers, b, cfg.encoder.num_frames, cfg.num_kv_heads,
                                       cfg.kq_dim), f"cross cache {tuple(layer['ck'].shape)}")
    cache = M.extend_cache(cfg, cache, WHISPER_DECODE)
    layer = cache["stages"][0][0]
    cross = [layer["ck"].clone(), layer["cv"].clone()]
    tok = _greedy(logits)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(WHISPER_DECODE):
        cache, logits = decode(params, cache, tok)
        tok = _greedy(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches, entries = dict(ops.LAUNCHES), dict(ops.ENTRY_LAUNCHES)
    want = 2 * dec_layers * WHISPER_DECODE
    print(f"  decode {1e3 * decode_s / WHISPER_DECODE:.3f} ms a step (host clock, {b} rows, "
          f"{b * WHISPER_DECODE / decode_s:.0f} tokens/s); launches {launches}, by entry point "
          f"{entries}; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(launches["flash_decode"] == want,
          f"decode launched K6 {launches['flash_decode']} times, want {want}")
    check(entries.get("repro_torch_flash_decode_cluster", 0) == want,
          "a decode K6 launch missed the cluster kernel")
    check(launches["flash_attention"] == 0, f"decode launched K4 {launches['flash_attention']} times")
    check(torch.equal(layer["ck"], cross[0]) and torch.equal(layer["cv"], cross[1]),
          "decode wrote the cross K/V")
    print("  the cross K/V are unchanged by decode (torch.equal)")
    check(bool(torch.isfinite(logits).all()), "decode logits not finite")
    check(int(cache["pos"]) == WHISPER_PROMPT + WHISPER_DECODE, f"pos {int(cache['pos'])}")
    state = {"cache": cache, "tok": tok}

    def one_step():
        state["cache"], lg = decode(params, state["cache"], state["tok"])
        state["tok"] = _greedy(lg)

    _, events, wall = _profiled(one_step, WHISPER_PROFILE_STEPS)
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in events) / WHISPER_PROFILE_STEPS
    print(f"  profile of {WHISPER_PROFILE_STEPS} decode steps: wall "
          f"{1e3 * wall / WHISPER_PROFILE_STEPS:.3f} ms/step under the profiler, device busy "
          f"{busy_ms:.3f} ms/step; busy share {busy_ms / (1e3 * decode_s / WHISPER_DECODE):.3f} "
          "of the unprofiled step")
    _top(events, WHISPER_PROFILE_STEPS, "step")
    del cache, state
    whisper_teacher_forced_check(cfg, params, frames, toks, dev)
    del params
    _free()
    return {"flash_attention": pre["flash_attention"], "flash_decode": launches["flash_decode"]}


def whisper_teacher_forced_check(cfg, params, frames, toks, dev):
    """prefill(WHISPER_TEACHER_PROMPT) -> ``extend_cache`` -> teacher-forced
    decode of the rest of WHISPER_PROMPT against prefill(WHISPER_PROMPT)'s
    last logits, all 8 rows, as
    ``tests/test_multihost.py::test_extend_cache_decode_matches_prefill``:
    f32 compute at F32_LOGITS_TOL (K4 and K6 on their f32 kernels at D 64),
    bf16 at BF16_LOGITS_TOL (the tensor-core K4, the cluster K6); the
    launches counted by entry point."""
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    p, n, layers = WHISPER_TEACHER_PROMPT, WHISPER_PROMPT, cfg.num_layers
    k4 = sum(len(q) * r for q, r in cfg.encoder.stages) + 2 * layers
    extras = {"encoder_frames": frames}
    print(f"  teacher-forced: prefill({p}) -> extend_cache({n - p}) -> {n - p} decode steps vs "
          f"prefill({n}), {toks.shape[0]} rows:")
    for dtype, tol, fa, fd in (
            ("float32", F32_LOGITS_TOL, "repro_torch_flash_attention", "repro_torch_flash_decode"),
            ("bfloat16", BF16_LOGITS_TOL, "repro_torch_flash_attention_wgmma",
             "repro_torch_flash_decode_cluster")):
        c = cfg.replace(dtype=dtype)
        ops.reset_launch_counts()
        _, want = M.prefill(c, params, toks[:, :n], extras)
        cache, _ = M.prefill(c, params, toks[:, :p], extras)
        cache = M.extend_cache(c, cache, n - p)
        for i in range(p, n):
            cache, got = M.decode_step(c, params, cache, toks[:, i:i + 1])
        torch.cuda.synchronize()
        entries = dict(ops.ENTRY_LAUNCHES)
        check(entries.get(fa, 0) == 2 * k4 and entries.get(fd, 0) == 2 * layers * (n - p),
              f"{dtype}: launches by entry point {entries}")
        compare(f"{dtype}: last logits {tuple(got.shape)} (logits max "
                f"|{float(want.float().abs().max()):.3f}|; {_entries(ops)})", got, want, tol)


def qwen_vl_phase(dev):
    """qwen2-vl-72b at full width and QWEN_VL_LAYERS of its 80 layers
    (random f32 weights from seed 0): a prompt of QWEN_VL_TOKENS tokens
    with an image of QWEN_VL_IMAGE patches, its M-RoPE positions as
    Qwen2-VL lays them out (``layers.positional.vl_positions``); prefill
    against as many teacher-forced decode steps, each with its (1, 3, 1) positions
    (``_dtype_checks``: f32 at F32_LOGITS_TOL, bf16 at BF16_LOGITS_TOL; K4
    and K6 at group 8, D 128); then the same prefill without
    ``positions_3d`` (every stream at the token's index) must differ by
    more than each tolerance, so the image's positions are read.  The peak
    stays 5 GiB under the card's memory."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.layers.positional import vl_positions
    from repro_torch.models import model as M

    _free()
    full = get_config(QWEN_VL_ARCH)
    cfg = full.replace(stages=((full.stages[0][0], QWEN_VL_LAYERS),))
    check(ops._attention_kernel(torch.bfloat16, cfg.kq_dim, cfg.num_heads // cfg.num_kv_heads)
          == "wgmma" and ops._decode_kernel(torch.bfloat16, cfg.kq_dim) == "cluster",
          f"{QWEN_VL_ARCH} does not route to the tensor-core K4 and the cluster K6")
    card_gib = torch.cuda.get_device_properties(dev).total_memory / 2**30
    torch.cuda.reset_peak_memory_stats(dev)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    toks = torch.randint(1, cfg.vocab_size, (1, QWEN_VL_TOKENS),
                         generator=torch.Generator(device=dev).manual_seed(7), device=dev)
    pos3d = vl_positions(QWEN_VL_TOKENS, QWEN_VL_TEXT, QWEN_VL_IMAGE, dev)[None]
    print(f"{QWEN_VL_ARCH} ({cfg.num_layers} of {full.num_layers} layers, full width, "
          f"{M.param_count(cfg):,} parameters, M-RoPE sections {cfg.mrope_sections}): prefill of "
          f"{QWEN_VL_TOKENS} tokens ({QWEN_VL_TEXT} text, {QWEN_VL_IMAGE[0]} x {QWEN_VL_IMAGE[1]} "
          f"image patches, text) vs teacher-forced decode with per-step positions_3d; positions "
          f"t {pos3d[0, 0].tolist()}")
    prefills = _dtype_checks(cfg, cfg, params, toks, dev, QWEN_VL_ARCH, BF16_LOGITS_TOL, pos3d)
    for dtype, tol in (("float32", F32_LOGITS_TOL), ("bfloat16", BF16_LOGITS_TOL)):
        _, plain = M.prefill(cfg.replace(dtype=dtype), params, toks)
        gap = float((plain.float() - prefills[dtype]).abs().max())
        print(f"  {dtype}: default positions vs positions_3d, prefill logits max_abs_diff "
              f"{gap:.3e} (must exceed {tol:g})")
        check(gap > tol, f"{dtype}: positions_3d did not move the logits")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"  peak memory {peak:.2f} of {card_gib:.2f} GiB")
    check(peak <= card_gib - 5, f"{QWEN_VL_ARCH} peaks at {peak:.2f} GiB, less than 5 GiB under "
          "the card's memory")
    del params
    _free()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = build.build()
    build.library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s: {lib}")
    resources = ptxas_resources((lib.parent / "build.log").read_text())
    for fn, res in resources.items():
        print(f"  ptxas: {fn}: {res['registers']} registers, {res['spill_stores']} bytes spill "
              f"stores, {res['spill_loads']} bytes spill loads")
    for key in NEW_KERNELS:
        hits = [fn for fn in resources if key in fn]
        check(bool(hits), f"ptxas reported no kernel {key}")
        check(all(resources[fn]["spill_stores"] == resources[fn]["spill_loads"] == 0 for fn in hits),
              f"{key} spills registers")
    instruction_counts(lib)

    rows = kernel_phase(dev)
    whisper_kernels = whisper_kernel_phase(dev)
    wide_decode = decode256_phase(dev)
    gathers = gather_kernel_phase(dev)
    scans = rglru_kernel_phase(dev)
    model_phase(dev)
    train_step_phase(dev)
    linear_svm_phase(dev)
    launches = serve_phase()
    profile_phase(dev)
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows.append(svm_phase(dev))
    t0 = time.perf_counter()
    for name, count in dnn_phase(dev).items():
        rows.append(dict(gathers[name], launches=count))
    print(f"DNN phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches = train_phase(dev)
    print(f"training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_tier_phase(dev)
    print(f"tiered training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multihost_launches = multihost_train_phase(dev)
    print(f"multi-host training phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tcp_mesh_phase()
    print(f"TCP mesh phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    compression_launches = compression_phase(dev)
    print(f"compression phase {time.perf_counter() - t0:.1f} s")
    train_profile_phase(dev)
    t0 = time.perf_counter()
    rg_launches = recurrent_decode_phase(dev)
    granite_scalar_decode_check(dev)
    blocked_attention_check(dev)
    print(f"recurrent decode phase and checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_launches = moe_serve_phase(dev)
    moe_checks_phase(dev)
    moe_train_phase(dev)
    print(f"MoE phases {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    stablelm_launches = stablelm_serve_phase(dev)
    print(f"{STABLELM_ARCH} serving phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    copied_configs_phase(dev)
    print(f"copied-config phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    slstm = slstm_phase(dev)
    xlstm_card_vs_cpu_check(dev)
    xlstm_train_phase(dev)
    xlstm_train_profile(dev, slstm)
    print(f"{XLSTM_ARCH} training phases {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    xlstm_decode_phase(dev, slstm)
    print(f"{XLSTM_ARCH} prefill and decode phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    whisper_train_phase(dev)
    whisper_launches = whisper_serve_phase(dev)
    print(f"{WHISPER_ARCH} phases {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    qwen_vl_phase(dev)
    print(f"{QWEN_VL_ARCH} phase {time.perf_counter() - t0:.1f} s")
    for row in rows:
        if row["name"] == "flash_decode":
            row["head_dim_256"] = dict(wide_decode, launches=rg_launches["flash_decode"])
        if row["name"] in ("flash_attention", "flash_decode"):
            row["qwen2_moe_serve_launches"] = moe_launches[row["name"]]
            row["head_dim_160"]["stablelm_serve_launches"] = stablelm_launches[row["name"]]
            row["whisper"] = dict(whisper_kernels[row["name"]],
                                  serve_launches=whisper_launches[row["name"]])
    for name in ("rglru_scan", "rglru_scan_bwd"):
        rows.append(dict(scans[name], launches=train_launches[name],
                         multihost_train_launches=multihost_launches[name],
                         compression_launches=compression_launches[name]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "context_4096", "head_dim_160",
            "head_dim_256", "qwen2_moe_serve_launches", "whisper", "b1_ms",
            "device_ids_ms", "device_ids_bound_ms", "bandwidth_ms", "multihost_train_launches",
            "compression_launches")
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row} for row in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
