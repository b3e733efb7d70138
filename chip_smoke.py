#!/usr/bin/env python3
"""Builds the port's CUDA kernels and drives its paths on one GPU.

Usage: ``python3 chip_smoke.py [--seed S] [--size N] [--reps R]`` from the root
of a checkout, on a machine with an NVIDIA Hopper GPU (sm_90a) and the CUDA
toolkit. It uses ``repro_torch`` only, never JAX or ``repro``. The first path
is Stark's Strassen multiply:

1. builds every kernel in ``src/repro_torch/csrc`` (into ``build/``), logs
   their registers and spills (the tiled matmul, bf16 flash backward and
   sLSTM backward kernels must not spill), and
   checks in the SASS that the bf16 strassen1, tiled matmul and flash
   kernels run on the tensor cores (HGMMA, HGMMA, HMMA);
2. holds each kernel against its plain PyTorch version, in fp32 and bf16,
   for the three schemes, on aligned and ragged shapes (the level kernels
   of kind strassen also on a transposed input), and the matmul-type
   kernels with the other ``out_dtype`` (bf16 operands to fp32, fp32 to
   bf16);
3. drives the main path, ``repro_torch.core.backend.matmul`` on two N x N
   fp32 operands made from ``--seed`` with numpy (N = 16384, the paper's
   headline size, by default), for kinds strassen_fused (depth 1 and 2),
   strassen and winograd (depth 2) and naive, plus the staged pipeline at
   depth 2 in fp32 and bf16, strassen_fused at depth 2 in bf16 and naive in
   bf16. Each
   result is checked against an fp32 ``torch.matmul`` of the same operands
   by normwise relative error, and every kernel of the path must have been
   launched;
4. times each kernel at the main path's shapes with CUDA events, beside its
   plain version, the matching PyTorch call and the card's bound (the tiled
   matmul, divide and combine in bf16 too; the level kernels at the four
   levels of kind strassen's depth-2 multiply, beside the split + einsum
   (+ merge) route they replaced, and in bf16 at one divide and one combine
   level), and splits strassen_fused's device time by kernel class;
5. drives kind ``auto`` (``repro_torch.core.autotune``) on the same
   operands: calibrates the cost model on the card, prints each candidate
   of the N x N multiply in fp32 and bf16 (naive, Strassen and Winograd at
   depths 1-2, strassen_fused at depths 1-2) with its predicted ms and cost
   terms beside its measured ms (``execute``, median of 3), checks its error
   and that the fused candidates launched strassen1, prints the predicted
   decision and its time beside naive's at 2048 to N (the crossover table),
   runs measured mode (top 3) at N in fp32, and checks that a tuning cache
   saved to a file answers the same key from a fresh load with no
   calibration.

The mesh path (``repro_torch.core.distributed`` on ``repro_torch.core.mesh``,
phases m1-m7) runs Stark's distributed strategies on the same N x N operands,
on meshes of positions that all lie on the card (one process drives them, as
one JAX controller drives its devices; on one card they run one after
another, so a time is the work plus the movements' copies and adds, not an
interconnect's). Each run is checked against fp32 ``torch.matmul`` by
normwise error (MAIN_LIMIT), then timed, with the allocator's peak, the
mesh's logical collective bytes (what a cluster would send between
positions) and physical bytes (copied between cards), and the cards behind
the mesh:

m1. ``strassen_bfs_sharded`` at depth 2 on (4, 2) ("data", "model"),
    Strassen and Winograd in fp32 and Strassen in bf16, and on (8,) with
    ``batch_axes=("data",)``;
m2. ``strassen_2d`` at depth 1 on (4, 2);
m3. ``strassen_shardmap`` on (7,) ("mult",);
m4. ``strassen_shardmap_2d`` on (2, 7) ("rows", "mult");
m5. ``strassen_shardmap_3d`` on (2, 2, 7) ("rb", "cb", "mult"), merged and
    in quadrant-block layout;
m6. ``strassen_fused_sharded`` at depths 1 and 2 on (4, 2), fp32 and bf16:
    exactly one strassen1 launch per position, and strassen1 timed at one
    position's row stripe ((1,4,N/16,N/2) by (1,4,N/2,N/2) at depth 1,
    (7,4,N/32,N/4) by (7,4,N/4,N/4) at depth 2) beside its plain version, its
    bound and torch.matmul (depth 1) or torch.bmm (depth 2) of the same
    stripe;
m7. kind ``auto`` over the (4, 2) mesh at N^2 fp32: ``calibrate_collective``
    (0.0 on one card), each mesh candidate's predicted ms and cost terms
    beside its measured ms (median of 3), and the decision.

The out-of-core path (``repro_torch.blocks``, phases o1-o8) runs Stark's
tagged-block recursion with the operands in host memory and the card's
memory capped by a budget: N = 16384 fp32 from ``--seed`` under 1 GiB, where
a dense multiply needs 3 GiB, so the budget picks depth 2 (49 leaves of
4096^2 in 25 waves of 2):

o1. leaf backend strassen_fused depth 1, pipelined (pinned ring, H2D copy
    stream, D2H stream): the product against fp32 torch.matmul, waves >= 2,
    the modeled peak within the budget, overlap efficiency > 0 and exactly
    49 strassen1 launches; wall and phase seconds, H2D/D2H bytes, the
    allocator's measured peak beside the modeled one, the host store peak;
    then one torch.profiler trace of the same run: kernel and memcpy time,
    the share of memcpy time that overlaps a kernel, the device idle share;
    and the strassen1 kernel at the leaf's shape against its bound;
o2. the same with prefetch off: bit-identical to o1;
o3. ``backend.matmul(kind="strassen_oot", device_budget=1 GiB)`` with the
    default kind-auto leaves (calibrated before the first wave), checked as
    o1, with the leaf decisions logged;
o4. bf16 operands staged in fp32 (the default), against fp32 torch.matmul
    of the bf16 operands;
o5. at 4096^2 under 64 MiB: the arena and memmap stores (a temporary spill
    directory, removed after) bit-identical to the dict store, and a
    ``--fault-rate 0.05`` chaos run bit-identical to the fault-free one with
    blocks recovered and none unrecovered;
o6. a real device OOM at 8192^2 under 256 MiB: the allocator capped below
    the pipelined rung's need walks the degradation ladder;
o7. SPIN at 8192^2 fp32 under 128 MiB: ``backend.inverse(kind="spin_oot")``
    of g g^T / n + 2I against torch.linalg.inv, and
    ``backend.solve_triangular(kind="spin_oot")`` lower and upper with 1024
    right-hand sides, each to max|d| / max|want| < 1e-5;
o8. kind auto with ``device_budget`` at 16384^2: each out-of-core candidate's
    predicted against measured seconds, and the decision.

The sharded path runs the models on a (data 2, model 2) mesh of positions
on the card (``launch/mesh.py:make_mesh_for(4, model_parallel=2)``, under
``models.sharding.use_sharding``): every projection that carries
``w_logical``, every attention core and every expert FFN runs once per
distinct slab on its positions, with the collectives in ``mesh.traffic``.
Each phase prints its times beside the unsharded run's, ``mesh.traffic`` by
kind and axes, and the card's name and power limit; every launch count it
checks is computed from the specs (``core.mesh.distinct_slabs``):

s1. (after m7) ``backend.matmul`` with ``w_logical`` at phi4's shapes, x
    (2048, 3072) against wq (3072, 3072) ``("fsdp", "heads")`` and x (2048,
    8192) against down (8192, 3072) ``("d_ff", "fsdp")``, kinds naive,
    strassen and strassen_fused at depth 1, fp32 and bf16: each against the
    same call with no context at the matmul-type kernel bounds (bf16
    Strassen kinds: both against the fp32 product, the sharded one within
    MAIN_LIMIT and BF16_SPREAD times the unsharded one's error), strassen1
    launches equal to the distinct slab pairs, and ``mesh.traffic`` equal
    to its closed form ((data - 1) x w's bytes all-gathered over data; 2
    (model - 1) x each data group's output bytes summed over model);
s2. (after f1) phi4-mini-3.8B served through ``launch/serve.py``'s mesh
    path (``launcher_mesh``, ``place``): phase (b)'s 8 requests under its
    ``ServeConfig``, every one ending by length with no page left in use,
    flash launches per prefill equal to the specs' head slabs, and two
    requests' served tokens within phase (c)'s near-tie rule of the
    unsharded dense route; TTFT, TPOT, tokens/s, the 1024-token prefill and
    the decode step with their device splits, beside the unsharded run's;
s3. a 1024-token phi4 prefill through kind strassen_fused depth 1 under the
    mesh: strassen1 launches equal to the specs' slab pairs, and, as (e)
    holds the unsharded fused prefill, logits within STRASSEN_LIMIT of the
    naive prefill and no more than BF16_SPREAD times as far from it as the
    unsharded fused prefill (the distance between the two fused prefills is
    printed);
s4. (after the training path) one fp32 train step at t2's widths (2 layers,
    vocab 8192, batch 2 x 128) under the mesh against the unsharded step on
    the card from the same state, at t2's limits, with the backward kernels'
    launches from the specs; then accum 2 against accum 1, both through
    ``launch/train.py``'s ``build(mesh=...)``: updates within 1e-3 normwise;
s5. phi4 at full width cut to 4 layers, bf16: 3 steps of 2 x 1024 tokens
    through ``train_loop`` with the mesh, losses and grad norms finite, the
    flash backward's launches per step from the specs; the step time beside
    the unsharded loop's, ``mesh.traffic`` per step and the allocator peak;
s6. olmoe-1b-7b at full width cut to 2 layers, bf16, per-row dispatch
    groups: a 1024-token prefill under the mesh with ``moe_expert_parallel``
    on and then off, logits within SHARD_LIMIT normwise of the
    unsharded prefill, and the dispatch and combine reshard bytes.

The second path serves phi4-mini-3.8B (random weights from ``--seed``, bf16,
full width and depth) through the continuous-batching ``Engine``:

a. holds the RMSNorm and flash-attention kernels against their plain
   versions at the model's shapes, and flash on a grid of head dims, query
   lengths, GQA groups and masks;
b. serves 8 requests of 64 to 1984 prompt tokens, checks that every one ends
   by length with no page leaked, and that each forward launched the RMSNorm
   kernel 65 times and each prefill the flash kernel 32 times;
c. feeds the served tokens of two requests to the dense-cache route: each
   must be its argmax or a near-tie of it, and in an fp32 engine (where the
   two routes' rounding cannot flip an argmax) exactly its argmax;
d. checks that prefill logits (flash kernel) agree with prefill + one decode
   step (plain decode attention) within a normwise bound;
e. prefills through kind strassen_fused and checks the fused kernel ran and
   the logits stay within a normwise bound of the naive run;
e2. serves 4 of the requests with ``matmul_autotune=True`` (kind auto on
   every projection), prints the warm-up's resolutions and the decision
   log's kinds, hits and misses, checks that every request ends by length
   with no page leaked and that its tokens pass (c)'s near-tie rule against
   the dense-cache route of the same config;
f. prints TTFT, TPOT, tokens/s, prefill and decode-step times, peak memory,
   a breakdown of one prefill and each kernel's times against its bound;
f1. the fp8 KV cache (``cache_dtype="float8_e4m3fn"``) on the same bf16
   weights: prints which fp8 index ops the card's torch has, the prefill
   logits of 4 prompts against the bf16 cache's (normwise, printed) and
   their prefill + decode logits, which must be finite; serves the 4
   requests through the Engine: every one ends by length, their first
   tokens agree with the bf16 engine's on at least half, and the KV pool
   takes half the bf16 pool's bytes.

The third path serves xlstm-1.3b (random weights from ``--seed``, bf16, full
width and depth: 42 mLSTM and 6 sLSTM layers) through the same ``Engine``:

g. holds the RMSNorm kernel (at d_model 2048, and at the other models'
   widths 5120, 6144 and 8192) and the sLSTM sequence kernel against their
   plain versions at the model's shapes (for sLSTM a 1000-step prefill from
   zero state, a 4-slot decode step from a carried state, 6 rows at 64 steps,
   8 heads whose r does not fit the SMs' shared memory, a ragged dh of 48),
   checks that two halves with the carried state equal one pass, and that
   the profiler sees one sLSTM kernel a call;
h. serves 8 requests of 32 to 1024 prompt tokens, checks that every one ends
   by length with no page in use, and that each forward launched the sLSTM
   kernel 6 times and the RMSNorm kernel 49 times, and flash never;
i. as (c), two requests' served tokens against the dense-cache route, in
   bf16 and in an fp32 engine;
j. as (d), prefill logits against prefill + one decode step, whose sLSTM
   layers run the kernel at S = 1 on the carried state;
k. the chunkwise mLSTM (``mlstm_chunk=64``) against the shipped sequential
   route: a 256-token prefill in fp32 on the same weights, and a 1024-token
   prefill in bf16 against the fp32 chunkwise logits;
l. prints TTFT, TPOT, tokens/s, prefill ms at 128, 512 and 1024 tokens,
   decode-step ms, peak memory, the device split of one prefill and one
   decode step, and the RMSNorm and sLSTM kernels' times against their
   bounds (sLSTM also per step).

The fourth path serves the MoE models (random bf16 weights from ``--seed``)
through the same ``Engine``: olmoe-1b-7b at full width and depth (16
layers, 64 experts top-8), and qwen2-moe-a2.7b at full width and 4 of its 24
layers (the depth is cut for time only):

p1. holds RMSNorm at (R, 2048) and flash attention at q (1, 16, S, 128), kv
    (1, 16, S, 128), causal, against their plain versions;
p2. serves 8 requests of 64 to 1984 prompt tokens: every one ends by length
    with no page leaked, each forward launches RMSNorm 33 times and each
    prefill flash 16 times; prints the share of dropped assignments per
    layer in the 1984-token prefill (from the port's ``_route`` and
    ``_capacity`` on each layer's input; printed, not gated);
p3. as (c): two requests' served tokens against the dense-cache route, in
    bf16 and in an fp32 engine (with 4 slots a decode step's capacity is at
    least the bucket's tokens, so the two routes drop nothing);
p4. as (d), on a copy of the config with capacity_factor = n_experts /
    top_k, which drops nothing: with drops, a prefill of S tokens and one of
    S - 1 plus a decode step are different computations (the served runs
    keep the shipped 1.25);
p5. as (e): a prefill under kind strassen_fused launches strassen1, stays
    within (e)'s bound of the naive run, and every router call (traced) is a
    naive fp32 product;
p6. qwen2-moe-a2.7b (shared experts, qkv bias, 60 experts top-4): 4
    requests, checked as p2 and p3;
p7. prints prefill ms at 128, 512, 1024 and 1984 tokens, the decode step
    beside its bound (the bytes of the weights a step reads: every routed
    expert's), the allocator's peak, and the device split of one prefill and
    one decode step into the tracer's ``moe.route``, ``moe.dispatch``,
    ``moe.experts`` and ``moe.combine`` spans, the RMSNorm and flash
    kernels, cuBLAS and the rest; and flash at the 1024-token prefill beside
    SDPA and its bound.

The fifth path serves recurrentgemma-9b (random bf16 weights from
``--seed``, full width and depth: 26 RG-LRU and 12 local-attention layers,
MQA with 16 query heads on 1 KV head, head dim 256, window 2048):

r1. holds RMSNorm at (R, 4096) and flash attention at q (1, 16, S, 256), kv
    (1, 1, S, 256), causal, window 2048, for S = 1024 and 3000 (where the
    window bites), against their plain versions;
r2. serves 8 requests of 64 to 3000 prompt tokens with max_seq 4096 (the
    ring of the longer ones wraps in decode): every one ends by length,
    nothing is paged, each forward launches RMSNorm 77 times and each
    prefill flash 12 times;
r3. as (c), in bf16 (requests of 64 and 3000 tokens), and in an fp32 engine
    at full width and 6 layers (an fp32 copy at full depth does not fit
    beside the bf16 model);
r4. as (d), at 2500 tokens (past the window); and layer 0's RG-LRU block
    over 3000 tokens in two halves with the carried {h, conv} state against
    one pass (HALVES_LIMIT);
r5. prints prefill ms at 128, 512, 1024, 2048 and 3000 tokens, the decode
    step beside its bound, the allocator's peak, the device split of one
    prefill and one decode step (the ``rglru.scan`` span: the fp32 gate
    projections and the scan), and flash at its shape beside SDPA (K and V
    repeated to 16 heads, the window as a mask) and its bound, with RMSNorm
    at (1024, 4096).

The sixth path serves whisper-tiny (the encoder-decoder family; random
bf16 weights from ``--seed``, full width and depth: 4 encoder and 4 decoder
layers, d_model 384, 6 heads of 64, vocab 51,865) through
``Engine.generate``'s static batch: 8 requests, each 1500 stub frames (one
30 s window) and the 4-token start-of-transcript prefix, 128 new tokens,
max_seq 448:

w1. (with the kernel checks) holds flash attention against its plain
    version at whisper's four shapes, fp32 and bf16: the encoder (8, 6,
    1500, 64) non-causal, the decoder's prefill (8, 6, 4, 64) causal, and
    cross-attention in the prefill, q (8, 6, 4, 64), and at a decode step,
    q (8, 6, 1, 64), each against kv (8, 6, 1500, 64), non-causal; and
    strassen1 against its plain version at w4's quadrant shapes, the
    encoder's (12000, 384) rows split in four against the (384, 384),
    (384, 1536) and (1536, 384) weights;
w0. serves the batch: tokens (8, 128) in the vocabulary, flash launched
    4 + 4 + 4 times in the prefill and 4 times a decode step, no other
    kernel; tokens/s and the allocator's peak;
w2. every served token against an fp32 copy of the model (its kernels in
    fp32) fed the same frames and tokens: its argmax or within NEAR_TIE;
w3. prefill logits against a 3-token prefill and one decode step;
w4. a prefill through kind strassen_fused (depth 1, min_dim 256: the
    encoder's (8 x 1500)-row projections and MLP and the cross K/V reach
    strassen1) against the naive route, with its strassen1 launches;
w5. prints encode and prefill ms, the decode step's wall (host clock),
    tokens/s and device split (busy time and idle share), and flash at the
    four shapes beside SDPA and its bound.

The seventh path trains (``repro_torch.launch.train``, the train step,
AdamW, remat), on the flash, RMSNorm and sLSTM backward kernels:

t1. (with the kernel checks) holds the flash backward kernel against its
    plain backward at phi4's q (2, 24, 1024, 128), kv (2, 8, 1024, 128)
    causal and whisper's encoder (8, 6, 1500, 64), decoder self-attention
    (8, 6, 128, 64) causal and cross-attention q (8, 6, 128, 64) against kv
    (8, 6, 1500, 64), then gemma-7b's and recurrentgemma-9b's head dim 256
    shapes, and the RMSNorm backward at (2048, 3072) with w in fp32, in fp32
    and bf16 (dq, dk, dv, dx element by element, bf16 also normwise; dw
    normwise); both give the same bits on a second run. Then the sLSTM
    backward (fp32): fed the saved tensors its saving forward wrote, against
    the plain backward fed the same, element by element (dwx, dr and the
    initial state's dc, dn, dm, dh; 1e-4 x max(1, max|plain|)), and the
    kernel pair (saving forward, backward) against the plain pair normwise,
    at xlstm's training rows (2, 1024, 4, 4, 512) from zero state, a carried
    state with final-state gradients, S = 1, 6 rows, 8 heads whose r is
    streamed, and dh 48; the same bits on a rerun, and one backward device
    kernel a call in the profiler;
t2. one fp32 train step at phi4's widths cut to 2 layers and vocab 8192,
    batch 1 x 128, on the card against the CPU port from the same state:
    the loss, each gradient leaf and each parameter's update; then the same
    model in bf16 against the fp32 loss;
t4. a checkpoint after step 2 restored into a fresh state: step 3's loss
    and the state after it bit for bit the uninterrupted run's;
t6. ``strassen_fused`` raises under autograd on the card, and a kind
    ``strassen`` depth-1 train step matches kind naive;
t8. one fp32 train step at xlstm-1.3b's width cut to one block pattern (7
    mLSTM and 1 sLSTM layers, remat over the 8) and vocab 8192, batch 1 x
    128, on the card (the saving sLSTM forward twice, the backward kernel
    once) against the CPU port from the same state: the loss to 1e-5, each
    gradient leaf and r's to 1e-4 normwise (a leaf below 1e-6 of the whole
    gradient, zero in exact arithmetic, absolutely), each update to 1e-3
    from the same gradients (AdamW's lr g / (|g| + eps) is ill-conditioned
    at |g| near eps, where this config has an element), and each side's
    update from its own gradients printed;
t3. phi4-mini-3.8B at full width and depth (bf16, remat every 4 layers)
    trained 8 steps of 2 x 1024 tokens through ``train_loop``: losses and
    grad norms finite, the last loss below the first, RMSNorm backward 65
    and flash backward 32 launches a step (the forwards twice, under
    remat); step time, tokens/s, model TFLOP/s, the allocator's peak,
    one step's device split (flash and RMSNorm forward and backward,
    cuBLAS, the rest) with its idle share, and the AdamW update's alone;
t5. whisper-tiny at full width and depth (bf16) trained 6 steps of 8 x
    1500 frames and 128 decoder tokens: the loss falls, 12 flash backward
    launches a step, the device splits as t3's;
t7. recurrentgemma-9b at full width cut to one block pattern (3 layers),
    bf16, 3 profiled steps of 1 x 4096 tokens through ``launch/train.py``'s
    build: loss and grad norm finite, one flash backward (head dim 256, MQA,
    window 2048) a step, each step's device split;
t9. xlstm-1.3b at full width and depth (48 layers, 6 sLSTM; bf16, remat
    every 8 layers, the chunkwise mLSTM at chunk 64) trained 6 steps of 2 x
    1024 tokens cycling 2 batches through ``train_loop``: losses and grad
    norms finite, the last loss below the first, 6 sLSTM backward and 12
    forward launches a step; step time, tokens/s, the allocator's peak and
    one step's device split (the sLSTM forward and backward kernels and the
    dr product, span ``slstm.dr``, apart) with its idle share;
then the backward kernels are timed at t1's shapes (bf16) beside their
plain versions, torch.autograd through SDPA and through ``F.rms_norm``,
and their bounds, and the sLSTM backward at (2, 1024, 4, 4, 512) beside its
plain version and its bound (no single PyTorch call computes it), with the
saving and serving forwards and the dr product alone beside it.

The examples (``repro_torch.examples``) run last, each once on the card
through its ``main``: ex1 quickstart (four routes, each within 2e-2 of
``torch.matmul``), ex2 strassen_distributed (three strategies within 1e-4
of max|torch.matmul|, with ``mesh.traffic``'s bytes), ex3 serve
(recurrentgemma's smoke config: requests end by length or their eviction,
no page left in use) and ex4 train_e2e ``--ci`` (its loss must fall).

The dry-run path (``repro_torch.launch.dryrun`` over ``op_analysis``, on
fake ``cuda:0`` tensors that allocate nothing) comes after them; its
roofline terms are against ``launch/roofline.py``'s H100 data-sheet peaks:

d1. whisper-tiny x decode_32k x single on the 256-position production mesh
    (the JAX dry-run integration test's cell): trace seconds, the three
    terms, and per-position argument + temporary bytes under 4 GiB;
d2. phi4-mini, one 1024-token prefill and one decode step at batch 8, no
    mesh: predicted by a trace, then run on the card; the launches by
    kernel equal the wrappers' counts, the argument bytes the real
    tensors', and the measured time (CUDA events) is at least the bound;
    the predicted peak is printed beside ``torch.cuda.max_memory_allocated``;
d3. ``strassen_2d`` at depth 1 on (2, 2) at 16384^2 fp32, predicted then
    run: the logical collective bytes by kind equal the run's
    ``mesh.traffic``, the per-position dot FLOPs their closed form.

Every kernel's bound (``time`` lines, the JSON's ``bound_ms``) is its
``kernels/cost.py`` operations and bytes at those peaks, the same numbers
the dry-run's analysis records where a wrapper meets a fake tensor.

RMSNorm is timed with its rows in L2 (the same x again) and cold (x and out
rotating over more than 100 MB, past the 50 MB L2); the JSON line holds
the cold time.

It exits non-zero, before printing a result, on any failure or when no CUDA
device is present. The JSON line's launches are those of the first path's
main-path run, for the strassen1 stripe entries those of the mesh path's
fused runs at that stripe, and for the later entries of a serving kernel
those of the serving run of its model (xLSTM's sLSTM, olmoe's flash,
recurrentgemma's RMSNorm and flash, whisper's flash at its four shapes,
and the backward kernels' of the training run at their shapes: t3's at
phi4's, t5's at whisper's, t7's at head dim 256, t9's for the sLSTM
backward);
the out-of-core path's launches are
printed on its own lines. The last lines are the card's name and power limit, a
JSON line with one entry per kernel, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import io
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.blocks.recovery import ChaosConfig  # noqa: E402
from repro_torch.blocks.scheduler import (  # noqa: E402
    attach_stats_ring,
    min_depth_for_budget,
    strassen_oot_matmul,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotune, distributed  # noqa: E402
from repro_torch.core.backend import (  # noqa: E402
    MatmulBackend,
    inverse,
    is_oom_error,
    matmul,
    sharded_layouts,
    solve_triangular,
)
from repro_torch.core.coefficients import get_scheme  # noqa: E402
from repro_torch.core.mesh import distinct_slabs, make_mesh  # noqa: E402
from repro_torch.core import strassen as core_strassen  # noqa: E402
from repro_torch.core.strassen import (  # noqa: E402
    combine_level,
    divide_level,
    merge_quadrants,
    split_quadrants,
)
from repro_torch.kernels import _build, cost  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS,
    flash_attention_bwd_cuda,
    flash_attention_cuda,
)
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref  # noqa: E402
from repro_torch.kernels.matmul.matmul import batched_matmul_cuda, matmul_cuda  # noqa: E402
from repro_torch.kernels.matmul.ref import batched_matmul_ref, matmul_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda  # noqa: E402
from repro_torch.kernels.slstm.ref import slstm_dr, slstm_seq_bwd_ref, slstm_seq_ref  # noqa: E402
from repro_torch.kernels.slstm.slstm import slstm_seq_bwd_cuda, slstm_seq_cuda  # noqa: E402
from repro_torch.kernels.strassen.ops import strassen_matmul_stages  # noqa: E402
from repro_torch.kernels.strassen.ref import (  # noqa: E402
    combine_level_ref,
    combine_ref,
    divide_level_ref,
    divide_ref,
    strassen1_matmul_ref,
)
from repro_torch.kernels.strassen.strassen import (  # noqa: E402
    combine_cuda,
    combine_level_cuda,
    divide_cuda,
    divide_level_cuda,
    strassen1_matmul_cuda,
)
from repro_torch import obs  # noqa: E402
from repro_torch.examples import quickstart as ex_quickstart  # noqa: E402
from repro_torch.examples import serve as ex_serve  # noqa: E402
from repro_torch.examples import strassen_distributed as ex_distributed  # noqa: E402
from repro_torch.examples import train_e2e as ex_train_e2e  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as transformer_mod  # noqa: E402
from repro_torch.models.frontends import make_stub_frames  # noqa: E402
from repro_torch.models.rglru import init_rglru_state, rglru_block  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.launch.mesh import format_traffic, launcher_mesh, make_mesh_for  # noqa: E402
from repro_torch.launch.roofline import HW, bound_ms  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.op_analysis import OpAnalysis, fake_mode, to_device  # noqa: E402
from repro_torch.launch.specs import named_leaves, place  # noqa: E402
from repro_torch.models.sharding import DEFAULT_RULES, use_sharding  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, OptState, apply_updates  # noqa: E402
from repro_torch.runtime.checkpoint import load_pytree, save_pytree  # noqa: E402
from repro_torch.serving.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.training.train_step import TrainState, init_train_state, make_train_step  # noqa: E402

# Dense peaks of one H100 SXM at its full 700 W (NVIDIA data sheet), per
# dtype, and HBM3 bandwidth: launch/roofline.py's Hardware, which the
# dry-run reckons its terms against too. A kernel's bound is its
# kernels/cost.py operations and bytes at these rates (bound_ms).

# Kernel against plain version: max|kernel - plain| <= TOL * max(1, max|plain|).
# divide/combine sum in the same order and round each add to the storage type
# (the identity in fp32), as their plain versions do, so they must match bit
# for bit. The products accumulate in another order than cuBLAS:
# about sqrt(K) * 2^-24 relative in fp32, and at most a bf16 ulp or two of
# the output (2^-8 relative) in bf16.
# RMSNorm, flash attention and the sLSTM sequence take the JAX kernel tests'
# tolerances in fp32, where the sums run in another order.
TOL = {
    ("sum", torch.float32): 0.0, ("sum", torch.bfloat16): 0.0,
    ("mm", torch.float32): 2e-5, ("mm", torch.bfloat16): 8e-3,
    ("norm", torch.float32): 1e-5, ("flash", torch.float32): 2e-5,
    ("slstm", torch.float32): 2e-5,
    ("flash_bwd", torch.float32): 1e-4, ("norm_bwd", torch.float32): 1e-4,
    ("slstm_bwd", torch.float32): 1e-4,
}
# In bf16, RMSNorm and flash attention compute in fp32 from the same inputs as
# their plain versions and round once, so each element is held to its own
# scale: |kernel - plain| <= tol * (|plain| + rms(plain)). One bf16 ulp is at
# most 2^-7 of the value; the rms term covers elements near 0, where the fp32
# sums' order shows. A dropped, doubled or mis-masked KV tile moves a late
# row of flash attention by about its own size and fails this.
ELEMENT_TOL = {("norm", torch.bfloat16): 2**-7, ("flash", torch.bfloat16): 2**-7,
               ("flash_bwd", torch.bfloat16): 2**-5, ("norm_bwd", torch.bfloat16): 2**-5}
# The backward kernels against their plain backwards. fp32 (TOL above): five
# products and dQ's sum over key tiles in another order than the plain
# version's, hence 1e-4 x max(1, max|plain|). bf16: the flash kernel feeds P
# and dS to its tensor-core products as hi + lo bf16 parts (about 2^-17 of
# the fp32 value) and rounds dQ, dK and dV once, and the RMSNorm kernel rounds
# dx once; each element within 2^-5 x (|plain| + rms(plain)) (ELEMENT_TOL)
# and the whole gradient normwise within GRAD_NORMWISE. dw (fp32 in both)
# adds 2048 rows in another order: DW_LIMIT normwise. The sLSTM backward
# (fp32) takes the fp32 rule element by element when fed the saved tensors
# its own forward wrote; the kernel pair (saving forward, backward) against
# the plain pair differs also by the forward's rounding, carried back through
# the recurrence: each gradient within SLSTM_PAIR_LIMIT normwise.
GRAD_NORMWISE = 1e-2
SLSTM_PAIR_LIMIT = 1e-4
DW_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 1e-4}
# Main path against fp32 torch.matmul, normwise relative error ||C - C_ref|| / ||C_ref||.
MAIN_LIMIT = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# Serving path: logits of two routes through the bf16 model, normwise
# ||a - b|| / ||b||. A bf16 forward differs from exact arithmetic by a few
# bf16 roundings (2^-8 each) of the normalized output; two routes that round
# at different places differ by about twice that. Strassen adds the bf16
# rounding of its operand sums and 7-term combines in every projection.
PREFILL_DECODE_LIMIT = 5e-2
STRASSEN_LIMIT = 1e-1
# The chunkwise mLSTM against the sequential scan, normwise on the logits of a
# prefill. In fp32 (the bf16 weights upcast) the two routes differ only in the
# order of the recurrence's fp32 sums (about 1e-6 relative per layer); 48
# layers may amplify that some tens of times, so 1e-3 leaves a wide margin,
# and a wrong decay, stabilizer or chunk boundary is off by order 1. 256
# tokens are 4 chunks of 64, so every chunk boundary case is crossed.
# In bf16 each route rounds every projection and mLSTM output to bf16, and the
# two routes' roundings differ wherever their fp32 sums do, so their mutual
# distance is the bf16 model's own rounding noise, which grows with depth: the
# JAX package's bf16 model lies as far from its fp32 logits as the port's does
# (tests/test_torch_xlstm.py, 0.24 at 48 layers of the smoke width). So each
# bf16 route is held to the fp32 logits of the checked chunkwise route: the
# chunkwise bf16 route must lie no more than BF16_SPREAD times as far from
# them as the shipped sequential bf16 route does.
CHUNKWISE_FP32_LIMIT = 1e-3
BF16_SPREAD = 2.0
# Served bf16 tokens against the dense-cache route fed the same tokens: each
# must be that route's argmax or lie at most NEAR_TIE x rms(logits) below its
# top logit. The routes' logits differ by about 2e-2 of their rms (phase (d)),
# so a pick flips only on a gap of a few times that; a wrong cache or position
# picks tokens whose logits lie several rms below the top.
NEAR_TIE = 0.25

SCHEMES = ("strassen", "winograd", "naive8")
# The other serving models' widths (qwen1.5, internlm2 and qwen2-vl's
# d_model), where 256 threads or more own an RMSNorm row.
RMSNORM_WIDE = (5120, 6144, 8192)
# (mb, m, k, n) where the tiled matmul's tiles can break, against its 128 x 256
# tile and its K steps (32 fp32, 64 bf16): M and N edges above and below a
# tile (N ending in each of the four 64-column boxes of a bf16 tile); K below
# one step; K or N rows of whole 16-byte chunks in fp32 only
# (36, 68, 100, 260: the TMA in fp32, element loads in bf16) or in neither
# (65, 17, 70); K long enough to wrap the ring of stages.
MATMUL_EDGES = [(2, 130, 72, 200), (1, 257, 520, 136), (3, 33, 65, 17), (2, 64, 8, 64),
                (2, 136, 96, 264), (2, 64, 36, 100), (2, 96, 64, 68), (2, 256, 1024, 384),
                (1, 200, 1000, 260)]
COUNTED = (strassen1_matmul_cuda, batched_matmul_cuda, divide_cuda, combine_cuda,
           divide_level_cuda, combine_level_cuda)
ALL_KERNELS = (*COUNTED, matmul_cuda, rmsnorm_cuda, flash_attention_cuda, slstm_seq_cuda,
               rmsnorm_bwd_cuda, flash_attention_bwd_cuda, slstm_seq_bwd_cuda)
REPLACES = {
    "strassen1_matmul_cuda": "src/repro/kernels/strassen/strassen.py:155",
    "batched_matmul_cuda": "src/repro/kernels/matmul/matmul.py:95",
    "divide_cuda": "src/repro/kernels/strassen/strassen.py:68",
    "combine_cuda": "src/repro/kernels/strassen/strassen.py:105",
    # The JAX package's einsum levels, which kind strassen runs.
    "divide_level_cuda": "src/repro/core/strassen.py:77",
    "combine_level_cuda": "src/repro/core/strassen.py:94",
    "matmul_cuda": "src/repro/kernels/matmul/matmul.py:43",
    "rmsnorm_cuda": "src/repro/kernels/rmsnorm/rmsnorm.py:29",
    "flash_attention_cuda": "src/repro/kernels/flash_attention/flash_attention.py:105",
    "slstm_seq_cuda": "src/repro/kernels/slstm/slstm.py:81",
    # No Pallas backward exists: the JAX package differentiates these pure-JAX
    # functions, which the backward kernels stand in for.
    "rmsnorm_bwd_cuda": "src/repro/models/layers.py:61",
    "flash_attention_bwd_cuda": "src/repro/models/attention.py:44",
    "slstm_seq_bwd_cuda": "src/repro/models/xlstm.py:248",
}
SOURCES = {
    "strassen1_matmul_cuda": "src/repro_torch/csrc/strassen1.cu",
    "batched_matmul_cuda": "src/repro_torch/csrc/matmul.cu",
    "divide_cuda": "src/repro_torch/csrc/signed_sum.cu",
    "combine_cuda": "src/repro_torch/csrc/signed_sum.cu",
    "divide_level_cuda": "src/repro_torch/csrc/strassen_level.cu",
    "combine_level_cuda": "src/repro_torch/csrc/strassen_level.cu",
    "matmul_cuda": "src/repro_torch/csrc/matmul.cu",
    "rmsnorm_cuda": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention_cuda": "src/repro_torch/csrc/flash_attention.cu",
    "slstm_seq_cuda": "src/repro_torch/csrc/slstm.cu",
    "rmsnorm_bwd_cuda": "src/repro_torch/csrc/rmsnorm.cu",
    "flash_attention_bwd_cuda": "src/repro_torch/csrc/flash_attention_bwd.cu",
    "slstm_seq_bwd_cuda": "src/repro_torch/csrc/slstm_bwd.cu",
}

# The served model and its traffic: prompt lengths and max_new_tokens of
# 32 + (i % 3), as the launcher staggers them.
SERVE_ARCH = "phi4_mini_3_8b"
PROMPT_LENS = (64, 128, 300, 512, 1000, 1024, 1536, 1984)
SERVE = dict(max_seq=2048, slots=4, page_size=16, sync_interval=4, temperature=0.0)
# The recurrent model and its traffic (the same ServeConfig).
XLSTM_ARCH = "xlstm_1_3b"
XLSTM_PROMPT_LENS = (32, 64, 128, 256, 384, 512, 768, 1024)
# The MoE models: olmoe at full depth with phi4's traffic; qwen2-moe at full
# width and 4 of its 24 layers (cut for the run's time only), serving 4 of
# those prompts (128, 512, 1024 and 1984 tokens).
MOE_ARCH = "olmoe_1b_7b"
QWEN_MOE_ARCH = "qwen2_moe_a2_7b"
QWEN_MOE_LAYERS = 4
QWEN_MOE_PROMPTS = (1, 3, 5, 7)
MOE_PREFILL_LENS = (128, 512, 1024, 1984)
MOE_SPANS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
# The RG-LRU model: prompts past its 2048-token window, so the ring wraps
# in decode; max_seq 4096 holds the longest prompt and its new tokens. Its fp32
# engine check runs at 6 of its 38 layers (two pattern periods): an fp32
# copy at full depth does not fit beside the bf16 model.
RG_ARCH = "recurrentgemma_9b"
RG_PROMPT_LENS = (64, 128, 512, 1024, 1500, 2048, 2500, 3000)
RG_SERVE = dict(SERVE, max_seq=4096)
RG_PICKS = (0, 7)
RG_FP32_LAYERS = 6
RG_PREFILL_LENS = (128, 512, 1024, 2048, 3000)
RG_FLASH_LENS = (1024, 3000)
# One RG-LRU layer over a sequence in two halves with the carried {h, conv}
# state against one pass, bf16. The two differ only in how the fp32 scan
# associates the second half's steps (about 1e-6 relative in h), which can
# move the bf16 rounding of h by one ulp (2^-8) here and there: the output
# is held to 2^-8 normwise, h to 1e-5 and the conv tail must be equal.
HALVES_LIMIT, HALVES_H_LIMIT = 2.0**-8, 1e-5
# The encoder-decoder model: whisper-tiny at full width and depth (4 encoder
# and 4 decoder layers), one static batch of 8 requests, each one 30 s window
# of stub frames (1500) and the 4-token start-of-transcript prefix
# (<|startoftranscript|><|en|><|transcribe|><|notimestamps|>), 128 new tokens
# each, max_seq 448 (whisper's decoder context).
WHISPER_ARCH = "whisper_tiny"
WHISPER_BATCH = 8
WHISPER_PREFIX = (50258, 50259, 50359, 50363)
WHISPER_NEW = 128
WHISPER_SERVE = dict(max_seq=448, temperature=0.0)
WHISPER_FUSED = MatmulBackend(kind="strassen_fused", depth=1, min_dim=256)
# The training path (t1-t6). t3 trains phi4-mini-3.8B whole; t2, t4 and t6 run
# at its widths cut to TRAIN_CUT (2 layers, vocab 8192), batch CUT_BATCH x
# CUT_SEQ, where the CPU port can run the same step; t5 trains whisper-tiny
# whole. The data cycles through a few batches, so a model that learns shows
# it in a few steps.
TRAIN_ARCH = "phi4_mini_3_8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CYCLE = 2, 1024, 8, 2
TRAIN_OPT = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
TRAIN_CUT = dict(n_layers=2, vocab=8192)
CUT_BATCH, CUT_SEQ = 1, 128
WHISPER_TRAIN = dict(batch=8, seq=128, steps=6, cycle=2)
WHISPER_TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=WHISPER_TRAIN["steps"])
# t7: recurrentgemma-9b at full width cut to one block pattern (rglru, rglru,
# local_attn: 3 layers), bf16, a few steps of 1 x 4096 tokens: the bf16 flash
# backward at head dim 256 under MQA and a window, on a training path.
RG_TRAIN = dict(batch=1, seq=4096, steps=3)
RG_TRAIN_OPT = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=RG_TRAIN["steps"])
# The bf16 flash backward's D = 256 shapes beside the training paths' (t1):
# gemma-7b's (MHA 16/16) and recurrentgemma-9b's (MQA 16/1, window 2048), at
# one sequence of 2048 and 4096 tokens.
D256_SHAPES = [("gemma-7b", (1, 16, 2048, 256), (1, 16, 2048, 256), True, None),
               ("recurrentgemma-9b", (1, 16, 4096, 256), (1, 1, 4096, 256), True, 2048)]
# t8: xlstm-1.3b at full width cut to one block pattern (7 mLSTM and 1 sLSTM
# layers) and vocab 8192, fp32, batch CUT_BATCH x CUT_SEQ: the card's train
# step against the CPU port's, as t2 (STEP_LIMITS). t9: xlstm-1.3b whole
# (48 layers, 6 sLSTM), bf16, remat every 8 layers, the exact chunkwise mLSTM
# (chunk 64; the shipped sequential loop under autograd would run 42 x 1024
# Python steps twice a step), a few steps of 2 x 1024 tokens cycling 2
# batches through train_loop, as t3.
XLSTM_TRAIN_CUT = dict(n_layers=8, vocab=8192)
XLSTM_TRAIN = dict(batch=2, seq=1024, steps=6, cycle=2)
XLSTM_TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=XLSTM_TRAIN["steps"])
XLSTM_TRAIN_CHUNK = 64
# t1's sLSTM backward shapes (name, b, s, h, dh, carried state, final-state
# gradients): xlstm's training rows (t9's) from zero state; a carried state
# with final-state gradients; S = 1; 6 rows (two passes over a tile); 8 heads,
# whose r does not fit the SMs' shared memory and is read from L2 in part (two
# tiles a block); dh 48; each ROWS template (1, 2 and 4 rows at B = 1, 2, 3)
# at an odd S (the ring's last slot is 0, where an even S ends on 1); dh 50,
# whose ring rows are padded to 52 floats.
SLSTM_BWD_SHAPES = [("xlstm-1.3b training rows", 2, 1024, 4, 512, False, False),
                    ("carried state", 2, 64, 4, 512, True, True), ("S = 1", 2, 1, 4, 512, True, True),
                    ("6 rows", 6, 64, 4, 512, True, True), ("8 heads, r streamed", 2, 64, 8, 512, True, True),
                    ("dh 48", 2, 64, 4, 48, True, True), ("1 row, odd S", 1, 65, 4, 512, True, True),
                    ("2 rows, odd S", 2, 63, 4, 512, True, True), ("3 rows, odd S", 3, 33, 4, 512, True, True),
                    ("dh 50, ring rows padded", 2, 64, 4, 50, True, True)]
# The examples (ex1-ex4), each run once on the card through its main():
# train_e2e at its CI scale for the steps of its own CI-scale recipe.
EXAMPLE_TRAIN_STEPS = 120
# t2: the card's fp32 step against the CPU port's. Both compute in fp32 (TF32
# off), in other orders: the loss to 1e-5 relative, each gradient leaf
# normwise to 1e-4, each update normwise to 1e-3 (AdamW's first updates are
# about lr * sign(g): an element whose gradient is near 0 may flip, so the
# update is compared as a whole). bf16 against fp32: the loss of a bf16
# forward lies a few bf16 roundings (2^-8 each) from the fp32 one.
STEP_LIMITS = dict(loss=1e-5, grad=1e-4, update=1e-3)
NOISE_SHARE = 1e-6
BF16_LOSS_LIMIT = 2e-2
# t6: kind strassen at depth 1 against naive, fp32: Strassen's operand sums
# and 7-term combines move each projection by about 1e-6 relative.
STRASSEN_TRAIN = MatmulBackend(kind="strassen", depth=1, min_dim=64)
STRASSEN_LOSS_LIMIT = 1e-4
# The fp8 KV cache (f1): phi4 serves 4 of PROMPT_LENS (64, 512, 1024 and 1984
# tokens) with cache_dtype float8_e4m3fn; its first tokens must agree with the
# bf16 cache's on at least half of them (the bound of
# tests/test_perf_features.py::test_fp8_cache_decode_close_to_full_precision).
FP8 = "float8_e4m3fn"
FP8_PROMPTS = (0, 3, 5, 7)
FP8_NEW = 8
FP8_AGREE = 0.5
# Kind auto: the candidate set of the 16384^2 table (and of the crossover
# table and measured mode, so that every timed candidate is in the table),
# the crossover sizes, and the phi4 requests it serves (prompts of 64, 512,
# 1024 and 1984 tokens).
AUTO_TUNE = dict(max_depth=2, min_dim=1024)
AUTO_SIZES = (2048, 4096, 8192, 16384)
AUTO_PROMPTS = (0, 3, 5, 7)
AUTO_REPS = 3
# The out-of-core path: the cell (N^2 fp32 under a 1 GiB budget, so the
# budget picks depth 2), the stores-and-chaos size and budget (depth 2,
# waves of 2), the OOM size and budget, and the SPIN cell. The bf16 run is
# held to MAIN_LIMIT's bf16 2e-2; SPIN to spin_scaling's max|d| / max|want|.
OOT_N = 16384
OOT_BUDGET = 1 << 30
OOT_LEAF = MatmulBackend(kind="strassen_fused", depth=1, min_dim=1)
OOT_STORE_N, OOT_STORE_BUDGET = 4096, 64 << 20
OOT_FAULT_RATE = 0.05
OOM_N, OOM_BUDGET = 8192, 256 << 20
OOM_CAP = 0.8  # of the uncapped pipelined run's allocator peak
SPIN_N, SPIN_BUDGET, SPIN_NRHS = 8192, 128 << 20, 1024
SPIN_LIMIT = 1e-5
# Kind auto's candidates are held to MAIN_LIMIT, but for one route that the
# reference itself does not meet: Winograd at depth 2 in bf16 (einsum levels,
# every level rounded to bf16) lies 2.10e-2 to 2.12e-2 from fp32 in the JAX
# package from 512^2 to 4096^2, with no trend in the size, and in the port
# within 1% of that
# (tests/test_torch_autotune.py::test_winograd_depth2_bf16_error_is_the_references).
# It is held to the largest of those errors plus 5%.
ROUTE_LIMIT = {("winograd", 2, torch.bfloat16): 2.12e-2 * 1.05}


def route_limit(cand, dtype: torch.dtype) -> float:
    return ROUTE_LIMIT.get((cand.kind, cand.depth, dtype), MAIN_LIMIT[dtype])

# Where every tensor of the run lives.
# The sharded path (s1-s6): a (data 2, model 2) mesh of positions on the card.
SHARD_POSITIONS, SHARD_MODEL = 4, 2
SHARD_PROJECTIONS = (("attn.wq", 2048, 3072, 3072, ("fsdp", "heads")),
                     ("mlp.down", 2048, 8192, 3072, ("d_ff", "fsdp")))
SHARD_KINDS = ("naive", "strassen", "strassen_fused")
SHARD_FUSED = MatmulBackend(kind="strassen_fused", depth=1, min_dim=1024)
# Sharded logits against the unsharded ones, normwise, where both take the
# plain products (s6): the positions round their slabs' products as the
# whole product does, but a row-parallel projection adds its partial
# products in bf16 (as the JAX package's psum of bf16 dot outputs does), one
# more bf16 rounding per projection. Where the projections run Strassen in
# bf16 (s1's strassen kinds, s3), a slab's quadrants are other blocks than
# the whole matrix's, so the two routes round different operand sums, each
# about as far from exact as Strassen's bf16 rounding takes it (phase (e):
# 3.1e-2 from the plain prefill). There each route is held to the plain
# (fp32 or naive) result: the sharded one within the route's limit and no
# more than BF16_SPREAD times as far as the unsharded one.
SHARD_LIMIT = 2e-2
SHARD_STEP = dict(batch=2, seq=128)
SHARD_TRAIN = dict(n_layers=4, steps=3, batch=2, seq=1024, cycle=1)
SHARD_MOE_LAYERS = 2

DEVICE = "cuda"

FAILURES: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    FAILURES.append(msg)
    log(f"FAIL {msg}")


def randn(gen: np.random.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    x = gen.standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(DEVICE).to(dtype)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, kind: str) -> float:
    """Checks a kernel's output against its plain version; returns max|error|."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: got {tuple(got.shape)} {got.dtype}, want {tuple(want.shape)} {want.dtype}")
        return float("inf")
    diff = (got.float() - want.float()).abs()
    err = diff.max().item() if diff.numel() else 0.0
    finite = bool(torch.isfinite(got.float()).all())
    if (kind, want.dtype) in ELEMENT_TOL:
        tol = ELEMENT_TOL[(kind, want.dtype)]
        w = want.float()
        limit = tol * (w.abs() + w.square().mean().sqrt())
        over = (diff - limit).max().item() if diff.numel() else 0.0
        ok = finite and over <= 0.0
        worst = (diff / limit.clamp_min(1e-30)).max().item() if diff.numel() else 0.0
        log(f"check {name}: max_abs_err={err:.3e}, worst err/limit={worst:.3f} with limit "
            f"{tol:.3g} x (|plain| + rms(plain)) per element {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: an element exceeds {tol:.3g} x (|plain| + rms(plain)) or not finite")
        return err
    peak = want.float().abs().max().item() if want.numel() else 0.0
    limit = TOL[(kind, want.dtype)] * max(1.0, peak)
    ok = finite and err <= limit
    log(f"check {name}: max_abs_err={err:.3e} limit={limit:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name}: max_abs_err {err:.3e} > {limit:.3e} or not finite")
    return err


# GPU cycles (about 1 ms) to hold the stream before a queued timing, so that
# the host has enqueued the timed call before the card reaches it.
QUEUE_CYCLES = 2_000_000


def time_ms(fn, reps: int, queued: bool = False) -> float:
    """Median milliseconds of one call, from CUDA events, after one warm-up.

    With ``queued`` the stream is held busy first, so the events measure the
    call's device time alone: a kernel of a few microseconds would otherwise
    be timed as the host's launch gap.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def reset_counts() -> None:
    for fn in ALL_KERNELS:
        fn.launches = 0


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ----------------------------------------------------------------- phases
def phase_build() -> None:
    path = _build.library_path()
    fresh = not path.exists()
    _build.build()
    how = "compiled" if fresh else "cached"
    log(f"kernel build: {_build.build_seconds():.1f} s ({how}) -> {path}")
    build_log = path.parent / "build.log"
    if build_log.exists():
        name = ""
        for line in build_log.read_text().splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {short_name(name)}: {line.strip()}")
                spilled = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
                if (spilled and any(k in name for k in NO_SPILL_KERNELS)
                        and any(int(x) for x in spilled.groups())):
                    fail(f"{short_name(name)} spills registers: {line.strip()}")
    check_tensor_cores(path)


def short_name(mangled: str) -> str:
    """The kernel's own name and template arguments out of a mangled symbol."""
    for kernel in (*TENSOR_CORE_KERNELS, "flash_kernel", "rmsnorm_kernel", "rmsnorm_bwd_kernel",
                   "flash_bwd_f32_kernel", "slstm_seq_kernel", "slstm_seq_bwd_kernel", "signed_sum", "matmul"):
        if kernel in mangled:
            return mangled[mangled.index(kernel):][:48]
    return mangled[:48]


# The bf16 kernels that must run on the tensor cores, and the SASS opcode
# each must hold: warpgroup MMA for strassen1 and the tiled matmul, warp-level
# MMA for flash.
TENSOR_CORE_KERNELS = {"strassen1_wgmma_kernel": "HGMMA", "matmul_wgmma_kernel": "HGMMA",
                       "flash_mma_kernel": "HMMA", "flash_bwd_wgmma_kernel": "HGMMA"}
# Kernels whose every instance must build without spilling registers.
NO_SPILL_KERNELS = ("matmul_fma_kernel", "matmul_wgmma_kernel", "flash_bwd_wgmma_kernel", "slstm_seq_bwd_kernel")


def check_tensor_cores(lib: Path) -> None:
    """cuobjdump's SASS of the built library: every instance of each
    tensor-core kernel holds its MMA opcode."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = {}
        elif name is not None:
            for op in ("HGMMA", "HMMA", "FFMA"):
                if op in line:
                    counts[name][op] = counts[name].get(op, 0) + 1
    for kernel, op in TENSOR_CORE_KERNELS.items():
        found = {n: c for n, c in counts.items() if kernel in n}
        for n, c in found.items():
            log(f"  sass {short_name(n)}: {op} x{c.get(op, 0)}, FFMA x{c.get('FFMA', 0)}")
        if not found or any(c.get(op, 0) == 0 for c in found.values()):
            fail(f"{kernel}: no {op} in the SASS of {lib.name}")


def phase_kernels(gen: np.random.Generator) -> None:
    """Every kernel against its plain version on small aligned and ragged shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for mb, m, k, n in [(7, 64, 64, 64), (49, 32, 32, 32), (1, 128, 64, 128),
                            (3, 100, 70, 130), (2, 8, 16, 8), (1, 64, 192, 128), *MATMUL_EDGES]:
            a, b = randn(gen, (mb, m, k), dtype), randn(gen, (mb, k, n), dtype)
            compare(f"batched_matmul {tag} {(mb, m, k, n)}", batched_matmul_cuda(a, b),
                    batched_matmul_ref(a, b), "mm")
        for m, k, n in [(128, 128, 128), (256, 128, 64), (64, 192, 128), (8, 16, 8),
                        (96, 80, 112), *(e[1:] for e in MATMUL_EDGES)]:
            a, b = randn(gen, (m, k), dtype), randn(gen, (k, n), dtype)
            compare(f"matmul {tag} {(m, k, n)}", matmul_cuda(a, b), matmul_ref(a, b), "mm")
        # bases off 16 bytes: the element route whatever the shape
        mb, m, k, n = 2, 130, 264, 200
        a = randn(gen, (mb * m * k + 1,), dtype)[1:].view(mb, m, k)
        b = randn(gen, (mb * k * n + 1,), dtype)[1:].view(mb, k, n)
        compare(f"batched_matmul {tag} {(mb, m, k, n)} unaligned bases", batched_matmul_cuda(a, b),
                batched_matmul_ref(a, b), "mm")
        for name in SCHEMES:
            s = get_scheme(name)
            for shape in [(1, 4, 64, 64), (7, 4, 32, 64), (4, 4, 128, 128), (3, 4, 5, 7),
                          (2, 4, 16, 24)]:
                x = randn(gen, shape, dtype)
                for coef_name in ("a_coef", "b_coef"):
                    coef = getattr(s, coef_name)
                    compare(f"divide {tag} {name}.{coef_name} {shape}", divide_cuda(x, coef),
                            divide_ref(x, coef), "sum")
            for m, h, w in [(1, 64, 64), (7, 32, 32), (3, 5, 7), (2, 16, 24)]:
                x = randn(gen, (m, s.n_mults, h, w), dtype)
                compare(f"combine {tag} {name} {(m, s.n_mults, h, w)}",
                        combine_cuda(x, s.c_coef), combine_ref(x, s.c_coef), "sum")
            # aligned, ragged in every dimension, K2 below one K step, mb > 1
            for mb, m2, k2, n2 in [(1, 64, 64, 64), (7, 32, 64, 32), (2, 128, 128, 128),
                                   (3, 33, 65, 17), (1, 8, 192, 8), (2, 130, 72, 200),
                                   (2, 64, 8, 64), (2, 200, 520, 136)]:
                aq, bq = randn(gen, (mb, 4, m2, k2), dtype), randn(gen, (mb, 4, k2, n2), dtype)
                compare(f"strassen1 {tag} {name} {(mb, m2, k2, n2)}",
                        strassen1_matmul_cuda(aq, bq, scheme=s),
                        strassen1_matmul_ref(aq, bq, s), "mm")
    phase_out_dtype(gen)


def phase_level_kernels(gen: np.random.Generator) -> None:
    """The level kernels against their plain versions (bit for bit): hc of 64
    and 24 take 16-byte chunks in both dtypes, hc 4 in fp32 only, hc 7 in
    neither; m of 1, 3 and 7; and a transposed (non-contiguous) input."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name in SCHEMES:
            s = get_scheme(name)
            for m, r, c in [(1, 64, 128), (7, 40, 48), (7, 18, 8), (3, 10, 14)]:
                x = randn(gen, (m, r, c), dtype)
                xt = randn(gen, (m, c, r), dtype).transpose(1, 2)
                p = randn(gen, (m * s.n_mults, r // 2, c // 2), dtype)
                compare(f"divide_level {tag} {name}.a_coef {(m, r, c)}",
                        divide_level_cuda(x, s.a_coef), divide_level_ref(x, s.a_coef), "sum")
                compare(f"divide_level {tag} {name}.b_coef {(m, r, c)} transposed",
                        divide_level_cuda(xt, s.b_coef), divide_level_ref(xt, s.b_coef), "sum")
                compare(f"combine_level {tag} {name} {tuple(p.shape)}",
                        combine_level_cuda(p, s.c_coef), combine_level_ref(p, s.c_coef), "sum")


def einsum_level(x: torch.Tensor, coef, divide: bool) -> torch.Tensor:
    """A level of core/strassen.py as it runs on the CPU (split_quadrants,
    one einsum with TF32 off, and for a combine merge_quadrants), here on the
    card: the route the level kernels replaced."""
    on_cuda = core_strassen.on_cuda
    core_strassen.on_cuda = lambda *t: False
    try:
        return divide_level(x, coef) if divide else combine_level(x, coef)
    finally:
        core_strassen.on_cuda = on_cuda


def phase_out_dtype(gen: np.random.Generator) -> None:
    """The matmul-type kernels with the other out_dtype: bf16 operands stored
    as the fp32 accumulator, fp32 operands rounded once to bf16."""
    for dtype, out in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        tag = f"{str(dtype)[6:]} -> {str(out)[6:]}"
        for mb, m, k, n in ((2, 130, 72, 200), (1, 256, 512, 384), (3, 33, 65, 17)):
            a, b = randn(gen, (mb, m, k), dtype), randn(gen, (mb, k, n), dtype)
            compare(f"batched_matmul {tag} {(mb, m, k, n)}", batched_matmul_cuda(a, b, out_dtype=out),
                    batched_matmul_ref(a, b, out), "mm")
            compare(f"matmul {tag} {(m, k, n)}", matmul_cuda(a[0], b[0], out_dtype=out),
                    matmul_ref(a[0], b[0], out), "mm")
        for name in SCHEMES:
            for mb, m2, k2, n2 in ((2, 128, 128, 128), (3, 33, 65, 17)):
                aq, bq = randn(gen, (mb, 4, m2, k2), dtype), randn(gen, (mb, 4, k2, n2), dtype)
                compare(f"strassen1 {tag} {name} {(mb, m2, k2, n2)}",
                        strassen1_matmul_cuda(aq, bq, scheme=name, out_dtype=out),
                        strassen1_matmul_ref(aq, bq, name, out), "mm")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(out.float() - ref) / torch.linalg.vector_norm(ref)).item()


def main_path_runs(a, b, a16, b16) -> list:
    """(name, call, fp32 or bf16 operands) of every main-path configuration."""
    def backend(kind, depth=1):
        return lambda x, w: matmul(x, w, MatmulBackend(kind=kind, depth=depth))

    return [
        ("strassen_fused depth=1 fp32", backend("strassen_fused", 1), a, b),
        ("strassen_fused depth=2 fp32", backend("strassen_fused", 2), a, b),
        ("strassen depth=2 fp32", backend("strassen", 2), a, b),
        ("winograd depth=2 fp32", backend("winograd", 2), a, b),
        ("naive fp32", backend("naive"), a, b),
        ("stages depth=2 fp32", lambda x, w: strassen_matmul_stages(x, w, depth=2), a, b),
        ("strassen_fused depth=2 bf16", backend("strassen_fused", 2), a16, b16),
        ("stages depth=2 bf16", lambda x, w: strassen_matmul_stages(x, w, depth=2), a16, b16),
        ("naive bf16", backend("naive"), a16, b16),
    ]


def phase_main_path(runs: list, refs: dict) -> dict:
    """Each configuration once at full size, checked; returns the launch counts."""
    reset_counts()
    for name, call, x, w in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call(x, w)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        err = rel_err(out, refs[x.dtype])
        limit = MAIN_LIMIT[x.dtype]
        n = x.shape[0]
        ok = (tuple(out.shape) == (n, n) and out.dtype == x.dtype
              and bool(torch.isfinite(out).all()) and err <= limit)
        log(f"main {name}: {n}x{n} rel_err={err:.3e} limit={limit:.0e} first call "
            f"{secs * 1e3:.1f} ms, peak_mem={peak:.2f} GiB {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"main path {name}: rel_err {err:.3e}, shape {tuple(out.shape)}, {out.dtype}")
        del out
    counts = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    log(f"main path launches: {counts}")
    for fn in COUNTED:
        if counts[fn.__name__] <= 0:
            fail(f"{fn.__name__} was not launched on the main path")
    return counts


def phase_end_to_end(runs: list, reps: int) -> None:
    """Median time of one whole multiply per configuration (CUDA events)."""
    for name, call, x, w in runs:
        ms = time_ms(lambda: call(x, w), reps)
        n = x.shape[0]
        log(f"e2e {name}: {ms:.3f} ms, {2 * n**3 / ms / 1e9:.2f} TFLOP/s-equivalent (2N^3)")


def time_kernel(name, kernel, plain, library, work: cost.Cost, kind, reps) -> dict:
    """Checks a kernel against its plain version, then times kernel, plain
    version and library call (device time, CUDA events) beside the card's
    bound for ``work`` (kernels/cost.py)."""
    err = compare(f"{name} at main-path shape", kernel(), plain(), kind)
    ms, plain_ms = time_ms(kernel, reps, queued=True), time_ms(plain, reps, queued=True)
    library_ms = time_ms(library, reps, queued=True) if library is not None else None
    bms, by = bound_ms(work.ops, work.bytes, work.dtype)
    lib = "n/a" if library_ms is None else f"{library_ms:.5g} ms"
    log(f"time {name}: kernel {ms:.5g} ms, plain {plain_ms:.5g} ms, library {lib}, "
        f"bound {bms:.5g} ms ({by}), kernel at {bms / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
                bound_by=by, max_abs_err=err)


def cold_inputs(gen: np.random.Generator, shape: tuple, dtype: torch.dtype) -> list:
    """Distinct inputs of ``shape``, at least 8, enough that they and as many
    outputs of their size pass 100 MB: twice the 50 MB L2, so each call of a
    rotation finds its input cold."""
    pair = 2 * int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    return [randn(gen, shape, dtype) for _ in range(max(8, -(-100_000_000 // pair)))]


def rotating(fn, inputs: list):
    """A call of ``fn`` on the next input in turn (the first call on the
    first). The last output of each input is kept alive, so that the
    allocator hands every call a different output buffer."""
    held = [None] * len(inputs)
    turn = [0]

    def call():
        i = turn[0] % len(inputs)
        turn[0] += 1
        held[i] = None
        held[i] = fn(inputs[i])
        return held[i]
    return call


def time_rmsnorm(gen: np.random.Generator, rows: int, d: int, reps: int) -> dict:
    """RMSNorm bf16 (rows, d), w fp32, beside its plain version and
    F.rms_norm: warm (the same x each call, its rows in L2), then cold (x and
    out rotating past the L2). Returns the cold stats."""
    w = 1.0 + randn(gen, (d,), torch.float32)
    w16 = w.bfloat16()
    work = cost.rmsnorm(rows, d, torch.bfloat16, w.dtype)

    def lib(x):
        return torch.nn.functional.rms_norm(x, (d,), w16, 1e-6)

    x = randn(gen, (rows, d), torch.bfloat16)
    time_kernel(f"rmsnorm bf16 {(rows, d)} warm L2", lambda: rmsnorm_cuda(x, w), lambda: rmsnorm_ref(x, w),
                lambda: lib(x), work, "norm", reps)
    xs = cold_inputs(gen, (rows, d), torch.bfloat16)
    return time_kernel(
        f"rmsnorm bf16 {(rows, d)} cold L2 ({len(xs)} x/out pairs rotating)",
        rotating(lambda x: rmsnorm_cuda(x, w), xs), rotating(lambda x: rmsnorm_ref(x, w), xs),
        rotating(lib, xs), work, "norm", reps)


def json_row(fname: str, counts: dict, stats: dict) -> dict:
    return {"name": fname, "route": "cuda", "source": SOURCES[fname],
            "replaces": REPLACES[fname], "launches": counts[fname], **stats}


def phase_timing(a, b, reps: int, counts: dict) -> list:
    """Per-kernel medians at the main path's shapes; returns the JSON entries.

    The inputs are the main path's own intermediates: the quadrants of the
    operands, their depth-1 operand sums and the depth-2 leaves.
    """
    s = get_scheme("strassen")
    h = a.shape[0] // 2
    entries = []

    def entry(name, kernel, plain, library, work, kind):
        return time_kernel(name, kernel, plain, library, work, kind, reps)

    def add(fname, stats):
        entries.append(json_row(fname, counts, stats))

    # strassen1 at the depth-1 fused shape; the library call is torch.matmul
    # of the same operands before the quadrant split.
    aq, bq = split_quadrants(a[None]), split_quadrants(b[None])  # (1, 4, N/2, N/2)
    add("strassen1_matmul_cuda", entry(
        f"strassen1 fp32 {tuple(aq.shape)}", lambda: strassen1_matmul_cuda(aq, bq, scheme=s),
        lambda: strassen1_matmul_ref(aq, bq, s), lambda: torch.matmul(a, b),
        cost.strassen1(1, h, h, h, s.n_mults, torch.float32), "mm"))

    # The staged pipeline's first divide level, and a combine level of the same size.
    coef = torch.as_tensor(s.a_coef, dtype=torch.float32, device=DEVICE)
    add("divide_cuda", entry(
        f"divide fp32 {tuple(aq.shape)}", lambda: divide_cuda(aq, s.a_coef),
        lambda: divide_ref(aq, s.a_coef), lambda: torch.einsum("pq,mqij->mpij", coef, aq),
        cost.signed_sum(s.a_coef, 1, h * h, torch.float32), "sum"))
    p = divide_cuda(aq, s.a_coef)  # (1, 7, N/2, N/2)
    ccoef = torch.as_tensor(s.c_coef, dtype=torch.float32, device=DEVICE)
    add("combine_cuda", entry(
        f"combine fp32 {tuple(p.shape)}", lambda: combine_cuda(p, s.c_coef),
        lambda: combine_ref(p, s.c_coef), lambda: torch.einsum("kp,mpij->mkij", ccoef, p),
        cost.signed_sum(s.c_coef, 1, h * h, torch.float32), "sum"))
    # the same levels in bf16, on packed bf16x2 pairs (printed, not in the JSON line)
    aq, p = aq.bfloat16(), p.bfloat16()
    entry(f"divide bf16 {tuple(aq.shape)}", lambda: divide_cuda(aq, s.a_coef),
          lambda: divide_ref(aq, s.a_coef), lambda: torch.einsum("pq,mqij->mpij", coef.bfloat16(), aq),
          cost.signed_sum(s.a_coef, 1, h * h, torch.bfloat16), "sum")
    entry(f"combine bf16 {tuple(p.shape)}", lambda: combine_cuda(p, s.c_coef),
          lambda: combine_ref(p, s.c_coef), lambda: torch.einsum("kp,mpij->mkij", ccoef.bfloat16(), p),
          cost.signed_sum(s.c_coef, 1, h * h, torch.bfloat16), "sum")
    del aq, bq, p

    # Kind strassen's levels at depth 2: divide levels 0 and 1 of an operand,
    # combine levels 1 and 0, against the split + einsum (+ merge) route;
    # bf16 (printed, not in the JSON line) at divide level 1 and combine level 1.
    def level(x, coef, divide, json=True):
        fn, plain = ((divide_level_cuda, divide_level_ref) if divide
                     else (combine_level_cuda, combine_level_ref))
        m, hr, hc = ((x.shape[0], x.shape[1] // 2, x.shape[2] // 2) if divide
                     else (x.shape[0] // coef.shape[1], x.shape[1], x.shape[2]))
        what = "divide" if divide else "combine"
        stats = entry(f"{what}_level {str(x.dtype)[6:]} {tuple(x.shape)}",
                      lambda: fn(x, coef), lambda: plain(x, coef),
                      lambda: einsum_level(x, coef, divide),
                      cost.signed_sum(coef, m, hr * hc, x.dtype), "sum")
        if json:
            add(fn.__name__, stats)

    ta = divide_level(a[None], s.a_coef)  # (7, N/2, N/2)
    level(a[None], s.a_coef, True)
    level(ta, s.a_coef, True)
    la = divide_level(ta, s.a_coef)  # (49, N/4, N/4)
    level(la, s.c_coef, False)
    level(ta, s.c_coef, False)
    del la
    ta16 = ta.bfloat16()
    level(ta16, s.a_coef, True, json=False)
    la16 = divide_level(ta16, s.a_coef)
    level(la16, s.c_coef, False, json=False)
    del ta, ta16, la16

    # Depth 2: the fused kernel on the depth-1 operand sums (printed, not in
    # the JSON line), and the staged pipeline's 49 leaves.
    ta, tb = divide_level(a[None], s.a_coef), divide_level(b[None], s.b_coef)  # (7, N/2, N/2)
    for dtype in (torch.float32, torch.bfloat16):
        aq, bq = split_quadrants(ta.to(dtype)), split_quadrants(tb.to(dtype))  # (7, 4, N/4, N/4)
        am, bm = ta.to(dtype), tb.to(dtype)
        entry(f"strassen1 {str(dtype)[6:]} {tuple(aq.shape)}",
              lambda: strassen1_matmul_cuda(aq, bq, scheme=s),
              lambda: strassen1_matmul_ref(aq, bq, s), lambda: torch.bmm(am, bm),
              cost.strassen1(7, h // 2, h // 2, h // 2, s.n_mults, dtype), "mm")
        del aq, bq, am, bm
    la, lb = divide_level(ta, s.a_coef), divide_level(tb, s.b_coef)  # (49, N/4, N/4)
    del ta, tb
    add("batched_matmul_cuda", entry(
        f"batched_matmul fp32 {tuple(la.shape)}", lambda: batched_matmul_cuda(la, lb),
        lambda: batched_matmul_ref(la, lb), lambda: torch.bmm(la, lb),
        cost.matmul(49, h // 2, h // 2, h // 2, torch.float32), "mm"))
    # the same leaves in bf16, on the tensor cores (printed, not in the JSON line)
    la, lb = la.bfloat16(), lb.bfloat16()
    entry(f"batched_matmul bf16 {tuple(la.shape)}", lambda: batched_matmul_cuda(la, lb),
          lambda: batched_matmul_ref(la, lb), lambda: torch.bmm(la, lb),
          cost.matmul(49, h // 2, h // 2, h // 2, torch.bfloat16), "mm")
    del la, lb

    # The single tiled matmul (matmul_pallas's counterpart, on no path that
    # runs here) at the depth-1 leaf size, against torch.matmul.
    am, bm = a[:h, :h].contiguous(), b[:h, :h].contiguous()
    add("matmul_cuda", entry(
        f"matmul fp32 {(h, h, h)}", lambda: matmul_cuda(am, bm), lambda: matmul_ref(am, bm),
        lambda: torch.matmul(am, bm), cost.matmul(1, h, h, h, torch.float32), "mm"))
    am, bm = am.bfloat16(), bm.bfloat16()
    entry(f"matmul bf16 {(h, h, h)}", lambda: matmul_cuda(am, bm), lambda: matmul_ref(am, bm),
          lambda: torch.matmul(am, bm), cost.matmul(1, h, h, h, torch.bfloat16), "mm")
    return entries


def phase_breakdown(a, b, reps: int) -> None:
    """Where the time of strassen_fused at depth 2 goes, step by step (CUDA events)."""
    s = get_scheme("strassen")
    ta = divide_level(a[None], s.a_coef)
    aq = split_quadrants(ta)
    cq = strassen1_matmul_cuda(aq, split_quadrants(divide_level(b[None], s.b_coef)), scheme=s)
    prod = merge_quadrants(cq)
    steps = [
        ("divide_level (level kernel, one operand)", lambda: divide_level(a[None], s.a_coef)),
        ("split_quadrants copy (one operand)", lambda: split_quadrants(ta)),
        ("strassen1 kernel", lambda: strassen1_matmul_cuda(aq, aq, scheme=s)),
        ("merge_quadrants copy", lambda: merge_quadrants(cq)),
        ("combine_level (level kernel)", lambda: combine_level(prod, s.c_coef)),
    ]
    for name, fn in steps:
        log(f"breakdown strassen_fused depth=2 fp32: {name}: {time_ms(fn, reps):.3f} ms")
    del ta, aq, cq, prod
    for x in (a, a.bfloat16()):
        tag = "fp32" if x.dtype == torch.float32 else "bf16"
        run = lambda: matmul(x, x, MatmulBackend(kind="strassen_fused", depth=2))  # noqa: E731
        wall, _ = timed(run)
        log_split(f"strassen_fused depth=2 {tag}", wall, device_split(run))


# -------------------------------------------------------------- kind auto
def cand_name(c) -> str:
    return "naive" if c.is_naive else f"{c.kind} depth={c.depth}"


def phase_auto(a, b, a16, b16, refs: dict) -> autotune.Calibration:
    """(5) Kind auto on the card: calibration, the candidate table, the
    crossover table, measured mode and the tuning cache's round trip.
    Returns the calibration."""
    t0 = t = time.perf_counter()
    calib = autotune.calibrate(device=DEVICE)
    log(f"auto calibrate ({calib.device_kind}, {calib.device_count} device): "
        f"t_flop={calib.t_flop:.4e} s t_elem={calib.t_elem:.4e} s t_h2d={calib.t_h2d:.4e} s "
        f"t_coll={calib.t_coll} in {time.perf_counter() - t:.3f} s")
    if not (calib.t_flop > 0 and calib.t_elem > 0 and calib.t_h2d > 0 and calib.t_coll == 0.0
            and calib.device_kind == "gpu" and calib.device_count == 1):
        fail(f"auto calibrate: {calib}")
    n = a.shape[0]
    pairs = ((a, b), (a16, b16))
    reset_counts()
    for x, w in pairs:
        tag = "fp32" if x.dtype == torch.float32 else "bf16"
        for cand in autotune.enumerate_candidates(n, n, n, **AUTO_TUNE, device=DEVICE):
            terms = autotune.predict_cost_terms(cand, n, n, n, calib)
            before = strassen1_matmul_cuda.launches
            err = rel_err(autotune.execute(cand, x, w), refs[x.dtype])
            launched = strassen1_matmul_cuda.launches - before
            ms = time_ms(lambda: autotune.execute(cand, x, w), AUTO_REPS)
            limit = route_limit(cand, x.dtype)
            ok = err <= limit and (launched > 0) == (cand.kind == "strassen_fused")
            split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in terms.items() if v)
            log(f"auto candidate {n}^2 {tag} {cand_name(cand)}: predicted "
                f"{sum(terms.values()) * 1e3:.3f} ms ({split}), measured {ms:.3f} ms, "
                f"rel_err={err:.3e} limit={limit:.3g}, strassen1 launches "
                f"{launched} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"auto candidate {tag} {cand_name(cand)}: rel_err {err:.3e}, "
                     f"{launched} strassen1 launches")
    launches = strassen1_matmul_cuda.launches
    log(f"auto candidates: strassen1 launches {launches}")
    if launches <= 0:
        fail("auto: strassen1 was not launched over the fused candidates")

    tel = autotune.Telemetry()  # keeps the phase's resolutions out of the process log
    for size in AUTO_SIZES:
        for x, w in pairs:
            tag = "fp32" if x.dtype == torch.float32 else "bf16"
            xs, ws = x[:size, :size].contiguous(), w[:size, :size].contiguous()
            ref = refs[x.dtype] if size == n else torch.matmul(xs.float(), ws.float())
            d = autotune.autotune(size, size, size, x.dtype, calibration=calib, **AUTO_TUNE,
                                  telemetry=tel, device=DEVICE)
            err = rel_err(autotune.execute(d.candidate, xs, ws), ref)
            ms = time_ms(lambda: autotune.execute(d.candidate, xs, ws), AUTO_REPS)
            naive = time_ms(lambda: torch.matmul(xs, ws), AUTO_REPS)
            ok = err <= route_limit(d.candidate, x.dtype)
            log(f"auto crossover {size}^2 {tag}: decision {cand_name(d.candidate)}, predicted "
                f"{d.predicted_s * 1e3:.3f} ms, measured {ms:.3f} ms, naive {naive:.3f} ms, "
                f"decision/naive {ms / naive:.3f}, rel_err={err:.3e} {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"auto crossover {size} {tag}: rel_err {err:.3e}")
            del xs, ws, ref

    cands = autotune.enumerate_candidates(n, n, n, **AUTO_TUNE, device=DEVICE)
    top = sorted(cands, key=lambda c: autotune.predict_seconds(c, n, n, n, calib))[:3]
    t = time.perf_counter()
    d = autotune.autotune(n, n, n, torch.float32, calibration=calib, measure=True, top_k=3,
                          **AUTO_TUNE, telemetry=tel, device=DEVICE)
    ok = d.source == "measured" and d.candidate in top and d.measured_s > 0
    log(f"auto measured mode {n}^2 fp32 (top_k=3): timed {[cand_name(c) for c in top]}, winner "
        f"{cand_name(d.candidate)} at {d.measured_s * 1e3:.3f} ms (predicted "
        f"{d.predicted_s * 1e3:.3f} ms), naive among the timed: "
        f"{any(c.is_naive for c in top)}, {time.perf_counter() - t:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"auto measured mode: {d}")

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tuning.json")
        first = autotune.autotune(n, n, n, torch.float32, calibration=calib, **AUTO_TUNE,
                                  cache=autotune.TuningCache(path), telemetry=tel, device=DEVICE)
        before = autotune.calibration_snapshot(DEVICE)
        fresh = autotune.Telemetry()
        again = autotune.autotune(n, n, n, torch.float32, **AUTO_TUNE, telemetry=fresh,
                                  cache=autotune.TuningCache(path), device=DEVICE)
        ok = (again.source == "cache" and fresh.cache_hits == 1 and fresh.cache_misses == 0
              and again.candidate == first.candidate
              and autotune.calibration_snapshot(DEVICE) == before)
        log(f"auto tuning cache: {cand_name(first.candidate)} saved, fresh load answers "
            f"{cand_name(again.candidate)} from the {again.source}, hits {fresh.cache_hits}, "
            f"no calibration {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"auto tuning cache round trip: {again}, {fresh.snapshot()}")
    log(f"auto phase done in {time.perf_counter() - t0:.1f} s")
    return calib


# ------------------------------------------------------------ the mesh path
def mesh_runs(a, b, a16, b16) -> list:
    """(phase, strategy, mesh shape, axis names, keywords, operands) of each
    mesh-path run, m1-m6."""
    dm = ((4, 2), ("data", "model"))
    grid = ((2, 2, 7), ("rb", "cb", "mult"))
    return [
        ("m1", "strassen_bfs_sharded", *dm, dict(depth=2), a, b),
        ("m1", "strassen_bfs_sharded", *dm, dict(depth=2, scheme="winograd"), a, b),
        ("m1", "strassen_bfs_sharded", *dm, dict(depth=2), a16, b16),
        ("m1", "strassen_bfs_sharded", (8,), ("data",), dict(depth=2, batch_axes=("data",)), a, b),
        ("m2", "strassen_2d", *dm, dict(depth=1), a, b),
        ("m3", "strassen_shardmap", (7,), ("mult",), {}, a, b),
        ("m4", "strassen_shardmap_2d", (2, 7), ("rows", "mult"), {}, a, b),
        ("m5", "strassen_shardmap_3d", *grid, {}, a, b),
        ("m5", "strassen_shardmap_3d", *grid, dict(merge=False), a, b),
        ("m6", "strassen_fused_sharded", *dm, dict(depth=1), a, b),
        ("m6", "strassen_fused_sharded", *dm, dict(depth=2), a, b),
        ("m6", "strassen_fused_sharded", *dm, dict(depth=1), a16, b16),
        ("m6", "strassen_fused_sharded", *dm, dict(depth=2), a16, b16),
    ]


def mesh_run_name(run) -> str:
    phase, name, shape, names, kw, x, _ = run
    opts = " ".join(f"{k}={v}" for k, v in kw.items() if k != "batch_axes")
    tag = "fp32" if x.dtype == torch.float32 else "bf16"
    return f"{phase} {name} {opts} {tag} on {shape} {','.join(names)}".replace("  ", " ")


def phase_mesh(runs: list, refs: dict, reps: int) -> dict:
    """(m1-m6) Each mesh strategy once at full size, checked against fp32
    torch.matmul by normwise error, with its collective bytes and the
    allocator's peak; strassen_fused_sharded must launch strassen1 exactly
    once per position. Then each is timed (CUDA events, median of ``reps``).
    Returns the strassen1 launches of each fused run, by (depth, dtype)."""
    reset_counts()
    stats, fused = [], {}
    for run in runs:
        phase, name, shape, names, kw, x, w = run
        mesh = make_mesh(shape, names, device=DEVICE)
        fn = distributed.get_strategy(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = strassen1_matmul_cuda.launches
        out = fn(x, w, mesh=mesh, **kw)
        torch.cuda.synchronize()
        launched = strassen1_matmul_cuda.launches - before
        peak = torch.cuda.max_memory_allocated() / 2**30
        if kw.get("merge") is False:
            out = merge_quadrants(out)
        err = rel_err(out, refs[x.dtype])
        limit = MAIN_LIMIT[x.dtype]
        n = x.shape[0]
        want_launches = mesh.size if name == "strassen_fused_sharded" else 0
        ok = (tuple(out.shape) == (n, n) and out.dtype == x.dtype
              and bool(torch.isfinite(out).all()) and err <= limit and launched == want_launches)
        if name == "strassen_fused_sharded":
            fused[(kw["depth"], x.dtype)] = launched
        stats.append(dict(run=run, err=err, limit=limit, peak=peak, launched=launched, ok=ok,
                          logical=mesh.logical_bytes, physical=mesh.physical_bytes,
                          positions=mesh.size, cards=mesh.physical_count(),
                          psums=mesh.count("psum"), moves=mesh.count("reshard")))
        if not ok:
            fail(f"mesh {mesh_run_name(run)}: rel_err {err:.3e} (limit {limit:.0e}), "
                 f"shape {tuple(out.shape)} {out.dtype}, strassen1 launches {launched} "
                 f"(want {want_launches})")
        del out, mesh
    launches = strassen1_matmul_cuda.launches
    log(f"mesh path launches: strassen1 {launches}")
    if launches <= 0:
        fail("strassen1 was not launched on the mesh path")
    for st in stats:
        run = st["run"]
        _, name, shape, names, kw, x, w = run
        mesh = make_mesh(shape, names, device=DEVICE)
        fn = distributed.get_strategy(name)
        ms = time_ms(lambda: fn(x, w, mesh=mesh, **kw), reps)
        n = x.shape[0]
        log(f"mesh {mesh_run_name(run)}: {ms:.3f} ms, {2 * n**3 / ms / 1e9:.2f} TFLOP/s-equivalent "
            f"(2N^3), rel_err={st['err']:.3e} limit={st['limit']:.0e}, peak_mem={st['peak']:.2f} "
            f"GiB, collective bytes logical {st['logical'] / 2**30:.4f} GiB physical "
            f"{st['physical']} B ({st['psums']} psum, {st['moves']} reshards), "
            f"{st['positions']} positions on {st['cards']} card(s), strassen1 launches "
            f"{st['launched']} {'ok' if st['ok'] else 'FAIL'}")
        del mesh
    return fused


def phase_mesh_stripes(a, b, reps: int, launches: dict) -> list:
    """(m6) strassen1 at the row stripe of one position of the (4, 2) mesh,
    against its plain version, torch.matmul of the same stripe and the bound;
    returns the JSON entries."""
    s = get_scheme("strassen")
    rows = a.shape[0] // 8
    entries = []
    for depth in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            x, w = a[:rows].to(dtype), b.to(dtype)
            if depth == 1:
                ta, tb = x[None], w[None]
                library = lambda: torch.matmul(x, w)  # noqa: E731
            else:
                ta, tb = divide_level(x[None], s.a_coef), divide_level(w[None], s.b_coef)
                library = lambda: torch.bmm(ta, tb)  # noqa: E731
            aq, bq = split_quadrants(ta), split_quadrants(tb)
            mb, _, m2, k2 = aq.shape
            n2 = bq.shape[3]
            work = cost.strassen1(mb, m2, k2, n2, s.n_mults, dtype)
            tag = str(dtype)[6:]
            stats = time_kernel(
                f"strassen1 {tag} {tuple(aq.shape)} x {tuple(bq.shape)} (mesh stripe, depth {depth})",
                lambda: strassen1_matmul_cuda(aq, bq, scheme=s),
                lambda: strassen1_matmul_ref(aq, bq, s), library, work, "mm", reps)
            fname = "strassen1_matmul_cuda"
            entries.append({"name": f"{fname} (mesh stripe {tuple(aq.shape)} {tag})",
                            "route": "cuda", "source": SOURCES[fname], "replaces": REPLACES[fname],
                            "launches": launches.get((depth, dtype), 0), **stats})
            del x, w, ta, tb, aq, bq
    return entries


def phase_mesh_auto(a, b, ref, calib: autotune.Calibration) -> None:
    """(m7) Kind auto over the (4, 2) mesh at N^2 fp32: calibrate_collective,
    each mesh candidate's predicted ms and cost terms against its measured
    ms, and the decision. The model counts the mesh as 8 devices, as the
    reference's does; on one card its positions run one after another."""
    mesh = make_mesh((4, 2), ("data", "model"), device=DEVICE)
    t = time.perf_counter()
    coll = autotune.calibrate_collective(device=DEVICE)
    cards = torch.cuda.device_count()
    log(f"mesh m7 calibrate_collective over {cards} card(s): t_coll={coll:.4e} s in "
        f"{time.perf_counter() - t:.3f} s")
    if (cards == 1) != (coll == 0.0):
        fail(f"calibrate_collective: {coll} on {cards} card(s)")
    n = a.shape[0]
    measured = {}
    for cand in autotune.enumerate_candidates(n, n, n, mesh=mesh, **AUTO_TUNE, device=DEVICE):
        terms = autotune.predict_cost_terms(cand, n, n, n, calib, device_count=mesh.size)
        split = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in terms.items() if v)
        predicted = sum(terms.values()) * 1e3
        if cand.is_local:
            log(f"mesh m7 local candidate {cand_name(cand)}: predicted {predicted:.3f} ms ({split})")
            continue
        before = strassen1_matmul_cuda.launches
        err = rel_err(autotune.execute(cand, a, b, mesh=mesh), ref)
        launched = strassen1_matmul_cuda.launches - before
        ms = time_ms(lambda: autotune.execute(cand, a, b, mesh=mesh), AUTO_REPS)
        measured[cand] = ms
        limit = route_limit(cand, torch.float32)
        want = mesh.size if cand.kind == "strassen_fused_sharded" else 0
        ok = err <= limit and launched == want
        log(f"mesh m7 candidate {n}^2 fp32 {cand.scheme} {cand_name(cand)}: predicted "
            f"{predicted:.3f} ms ({split}), measured {ms:.3f} ms, rel_err={err:.3e} "
            f"limit={limit:.3g}, strassen1 launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"mesh m7 candidate {cand_name(cand)}: rel_err {err:.3e}, {launched} launches")
    d = autotune.autotune(n, n, n, torch.float32, calibration=calib, mesh=mesh, **AUTO_TUNE,
                          telemetry=autotune.Telemetry(), device=DEVICE)
    ms = measured.get(d.candidate)
    if ms is None:
        ms = time_ms(lambda: autotune.execute(d.candidate, a, b, mesh=mesh), AUTO_REPS)
    best = min(measured, key=measured.get)
    log(f"mesh m7 decision {n}^2 fp32 on {dict(mesh.shape)} ({mesh.size} devices in the model): "
        f"{d.scheme} {cand_name(d.candidate)}, predicted {d.predicted_s * 1e3:.3f} ms, measured "
        f"{ms:.3f} ms; fastest measured mesh candidate {best.scheme} {cand_name(best)} at "
        f"{measured[best]:.3f} ms")


def phase_auto_serve(cfg, params, prompts: list) -> None:
    """(e2) Serve 4 requests with kind auto on every projection."""
    cfg_auto = dataclasses.replace(cfg, matmul_autotune=True)
    t0 = t = time.perf_counter()
    engine = Engine(cfg_auto, params, ServeConfig(**SERVE), device=DEVICE)
    warm = engine.autotune_stats()
    calib = warm["calibration"] or {}
    log(f"auto serve {cfg.name}: warm_for_model {warm['cache_hits'] + warm['cache_misses']} "
        f"resolutions ({warm['cache_misses']} decided, {warm['cache_hits']} from the cache), "
        f"kinds {warm['kinds']}, t_flop={calib.get('t_flop', float('nan')):.4e} "
        f"t_elem={calib.get('t_elem', float('nan')):.4e}, engine built in "
        f"{time.perf_counter() - t:.2f} s")
    picks = [prompts[i] for i in AUTO_PROMPTS]
    reset_counts()
    t = time.perf_counter()
    handles = [engine.submit(p, 32 + i % 3) for i, p in enumerate(picks)]
    n_events = sum(1 for _ in engine.stream(handles))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    st, ss = engine.autotune_stats(), engine.serve_stats()
    log(f"auto serve {cfg.name}: {len(handles)} requests, {n_events} tokens in {wall:.3f} s; "
        f"resolutions after the run: kinds {st['kinds']}, hits {st['cache_hits']}, misses "
        f"{st['cache_misses']}; launches {({f.__name__: f.launches for f in ALL_KERNELS})}")
    for h, p in zip(handles, picks):
        if h.finish_reason != "length" or len(h.tokens()) != 32 + h.id % 3:
            fail(f"auto serve request {h.id}: {h.finish_reason} after {len(h.tokens())} tokens")
    if ss["pages_in_use"] != 0:
        fail(f"auto serve: {ss['pages_in_use']} pages still in use after every request finished")
    for h, p in zip(handles, picks):
        argmaxes, gaps = forced_rollout(engine.cfg, params, p, h.tokens())
        equal = sum(x == y for x, y in zip(argmaxes, h.tokens()))
        ok = max(gaps) <= NEAR_TIE
        log(f"auto serve vs dense route (same config), request {h.id} (prompt {len(p)}): "
            f"{equal} of {len(argmaxes)} tokens are its argmax, largest gap {max(gaps):.3f} rms "
            f"limit={NEAR_TIE} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"auto serve request {h.id}: gaps {[round(g, 3) for g in gaps]}")
    del engine
    log(f"auto serve phase done in {time.perf_counter() - t0:.1f} s")


# -------------------------------------------------------- out-of-core path
def host_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Normwise relative error of two host tensors, in fp32."""
    return (torch.linalg.vector_norm(out.float() - ref) / torch.linalg.vector_norm(ref)).item()


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """spin_scaling's metric: max|got - want| / max|want|."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.4g} GiB"


def log_oot(tag: str, st, wall: float) -> None:
    log(f"{tag}: wall {wall:.3f} s (run {st.total_s:.3f} s: divide {st.divide_s:.3f} s, leaf "
        f"{st.leaf_s:.3f} s, combine {st.combine_s:.3f} s), depth {st.depth}, {st.leaves} leaves "
        f"in {st.waves} waves of {st.wave_size}, {'pipelined' if st.prefetch else 'synchronous'} "
        f"(rung {st.rung}), H2D {gib(st.h2d_bytes)} staged in {st.stage_s:.3f} s, D2H "
        f"{gib(st.d2h_bytes)} fetched in {st.fetch_s:.3f} s, overlap efficiency "
        f"{st.overlap_efficiency:.3f}, modeled device peak {gib(st.peak_device_bytes)} of "
        f"{gib(st.budget_bytes)}, host store peak {gib(st.host_store_peak_bytes)}")


def oot_gates(tag: str, st, err: float, limit: float) -> None:
    ok = (err <= limit and st.waves >= 2 and st.peak_device_bytes <= st.budget_bytes
          and st.overlap_efficiency > 0.0)
    log(f"{tag}: rel_err={err:.3e} limit={limit:.0e}, waves {st.waves} >= 2, modeled peak "
        f"{st.peak_device_bytes} <= budget {st.budget_bytes}, overlap efficiency "
        f"{st.overlap_efficiency:.3f} > 0 {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag}: rel_err {err:.3e}, waves {st.waves}, peak {st.peak_device_bytes}, "
             f"overlap {st.overlap_efficiency}")


def run_oot(fn) -> tuple:
    """(result, stats, wall seconds, the allocator's peak above what was
    allocated before, launches per kernel) of one out-of-core run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_counts()
    t = time.perf_counter()
    out, st = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {f.__name__: f.launches for f in ALL_KERNELS if f.launches}
    return out, st, wall, torch.cuda.max_memory_allocated() - before, launches


def merged(intervals: list) -> list:
    out: list = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def covered(interval, union: list) -> float:
    start, end = interval
    return sum(max(0.0, min(end, e) - max(start, s)) for s, e in union)


def trace_copies(fn) -> None:
    """One torch.profiler trace of ``fn``: kernel time, HtoD and DtoH memcpy
    time and rate, the share of memcpy time that overlaps a kernel, and the
    device idle share over the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, st = fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t) * 1e6
    groups: dict = {"kernel": [], "HtoD": [], "DtoH": [], "other": []}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        iv = (float(evt.time_range.start), float(evt.time_range.end))
        name = evt.name
        key = ("HtoD" if "HtoD" in name else "DtoH" if "DtoH" in name
               else "other" if ("Memcpy" in name or "Memset" in name) else "kernel")
        groups[key].append(iv)
    if not groups["kernel"] or not groups["HtoD"]:
        log(f"o1 trace: not measured (the profiler recorded {len(groups['kernel'])} kernels, "
            f"{len(groups['HtoD'])} HtoD copies)")
        return
    kernels = merged(groups["kernel"])
    busy = sum(e - s for s, e in merged([iv for ivs in groups.values() for iv in ivs]))
    parts = []
    copy_us = hidden_us = 0.0
    for key, nbytes in (("HtoD", st.h2d_bytes), ("DtoH", st.d2h_bytes)):
        us = sum(e - s for s, e in groups[key])
        over = sum(covered(iv, kernels) for iv in groups[key])
        copy_us, hidden_us = copy_us + us, hidden_us + over
        parts.append(f"{key} {len(groups[key])} copies {us / 1e3:.3f} ms "
                     f"({nbytes / us / 1e3:.2f} GB/s), {over / us:.1%} under a kernel")
    kernel_us = sum(e - s for s, e in groups["kernel"])
    log(f"o1 trace: wall {wall_us / 1e3:.1f} ms, kernels {len(groups['kernel'])} in "
        f"{kernel_us / 1e3:.3f} ms; {'; '.join(parts)}; memcpy time overlapping a kernel "
        f"{hidden_us / copy_us:.1%}; device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.1%}")


def phase_oot(seed: int, reps: int) -> None:
    """(o1)-(o5) The out-of-core multiply at the cell's size, then at 4096^2."""
    t0 = time.perf_counter()
    gen = np.random.default_rng([seed, 4])  # the out-of-core path's own stream
    n, budget = OOT_N, OOT_BUDGET
    a = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    b = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    a_dev, b_dev = a.to(DEVICE), b.to(DEVICE)
    ref = torch.matmul(a_dev, b_dev).cpu()
    a16, b16 = a.bfloat16(), b.bfloat16()
    ref16 = torch.matmul(a_dev.bfloat16().float(), b_dev.bfloat16().float()).cpu()
    del a_dev, b_dev
    torch.cuda.empty_cache()
    depth = min_depth_for_budget(n, n, n, budget, torch.float32, pipelined=True)
    log(f"o0 {n}^2 fp32 operands from seed {seed} on the host ({gib(a.numel() * 4)} each; a "
        f"dense multiply needs {gib(3 * n * n * 4)}), budget {gib(budget)} -> depth {depth}, "
        f"{time.perf_counter() - t0:.1f} s")
    kw = dict(depth=depth, budget_bytes=budget, device=DEVICE)

    # (o1) strassen_fused leaves, pipelined.
    t = time.perf_counter()
    out1, st, wall, peak, launches = run_oot(
        lambda: strassen_oot_matmul(a, b, backend=OOT_LEAF, **kw))
    log_oot("o1 strassen_fused depth=1 leaves, pipelined", st, wall)
    log(f"o1 allocator peak {gib(peak)} measured beside the modeled {gib(st.peak_device_bytes)}; "
        f"launches {launches}")
    oot_gates("o1", st, host_rel_err(out1, ref), MAIN_LIMIT[torch.float32])
    if launches.get("strassen1_matmul_cuda", 0) != st.leaves:
        fail(f"o1: strassen1 launched {launches.get('strassen1_matmul_cuda', 0)} times, "
             f"want {st.leaves}")
    trace_copies(lambda: strassen_oot_matmul(a, b, backend=OOT_LEAF, **kw))
    h = n >> (depth + 1)
    aq = torch.randn((1, 4, h, h), device=DEVICE)
    bq = torch.randn((1, 4, h, h), device=DEVICE)
    am, bm = merge_quadrants(aq)[0], merge_quadrants(bq)[0]
    time_kernel(f"strassen1 fp32 {tuple(aq.shape)} (an out-of-core leaf)",
                lambda: strassen1_matmul_cuda(aq, bq), lambda: strassen1_matmul_ref(aq, bq, "strassen"),
                lambda: torch.matmul(am, bm), cost.strassen1(1, h, h, h, 7, torch.float32), "mm",
                reps)
    del aq, bq, am, bm
    log(f"o1 done in {time.perf_counter() - t:.1f} s")

    # (o2) the same with prefetch off: bit-identical.
    t = time.perf_counter()
    out2, st, wall, _, _ = run_oot(
        lambda: strassen_oot_matmul(a, b, backend=OOT_LEAF, prefetch=False, **kw))
    log_oot("o2 strassen_fused depth=1 leaves, prefetch off", st, wall)
    same = torch.equal(out1, out2)
    log(f"o2 bit-identical to o1: {same} {'ok' if same else 'FAIL'}; "
        f"{time.perf_counter() - t:.1f} s")
    if not same:
        fail("o2: the synchronous run differs from the pipelined one")
    del out1, out2

    # (o3) through backend.matmul, default kind-auto leaves.
    t = time.perf_counter()
    ring = attach_stats_ring()
    tel = autotune.get_telemetry()
    seen = len(tel.events)
    a_dev, b_dev = a.to(DEVICE), b.to(DEVICE)
    be = MatmulBackend(kind="strassen_oot", device_budget=budget)
    out3, _, wall, _, launches = run_oot(lambda: (matmul(a_dev, b_dev, be), None))
    st = SimpleNamespace(**ring.snapshot()[-1])
    log_oot("o3 backend.matmul(kind=strassen_oot), auto leaves", st, wall)
    leaf = [e for e in tel.events[seen:] if e.site == "blocks.leaf"]
    log(f"o3 leaf decisions: {[(e.key.split('|')[0], e.kind, e.depth, e.source) for e in leaf]}; "
        f"launches {launches}; result on {out3.device}")
    oot_gates("o3", st, host_rel_err(out3.cpu(), ref), MAIN_LIMIT[torch.float32])
    if out3.device.type != "cuda" or not leaf:
        fail(f"o3: result on {out3.device}, {len(leaf)} leaf decisions")
    del a_dev, b_dev, out3, ring
    torch.cuda.empty_cache()
    log(f"o3 done in {time.perf_counter() - t:.1f} s")

    # (o4) bf16 operands, staged in fp32.
    t = time.perf_counter()
    out4, st, wall, _, _ = run_oot(lambda: strassen_oot_matmul(a16, b16, backend=OOT_LEAF, **kw))
    log_oot("o4 bf16, fp32 staging, strassen_fused depth=1 leaves", st, wall)
    err = host_rel_err(out4, ref16)
    ok = out4.dtype == torch.bfloat16 and st.stage_dtype == "float32" and err <= MAIN_LIMIT[torch.bfloat16]
    log(f"o4 rel_err={err:.3e} limit={MAIN_LIMIT[torch.bfloat16]:.0e} against fp32 torch.matmul "
        f"of the bf16 operands, {out4.dtype}, staged in {st.stage_dtype} {'ok' if ok else 'FAIL'}; "
        f"{time.perf_counter() - t:.1f} s")
    if not ok:
        fail(f"o4: rel_err {err:.3e}, {out4.dtype}, staging {st.stage_dtype}")
    del a, b, a16, b16, ref, ref16, out4

    # (o5) stores and chaos at 4096^2.
    t = time.perf_counter()
    sn = OOT_STORE_N
    a = torch.from_numpy(gen.standard_normal((sn, sn), dtype=np.float32))
    b = torch.from_numpy(gen.standard_normal((sn, sn), dtype=np.float32))
    skw = dict(depth=min_depth_for_budget(sn, sn, sn, OOT_STORE_BUDGET, torch.float32,
                                          pipelined=True),
               budget_bytes=OOT_STORE_BUDGET, backend=OOT_LEAF, device=DEVICE)
    base, st = strassen_oot_matmul(a, b, **skw)
    results = {}
    with tempfile.TemporaryDirectory() as spill:
        for store in ("arena", "memmap"):
            out, st_s = strassen_oot_matmul(a, b, store=store, store_root=spill, **skw)
            results[store] = (torch.equal(out, base), st_s.host_store_peak_bytes)
        left = len(list(Path(spill).iterdir()))
    chaos = ChaosConfig(drop=OOT_FAULT_RATE, corrupt=OOT_FAULT_RATE * 0.4,
                        leaf_fail_rate=OOT_FAULT_RATE * 0.5, seed=seed)
    out, st_c = strassen_oot_matmul(a, b, chaos=chaos, retry_backoff_s=0.0, **skw)
    chaos_same = torch.equal(out, base)
    ok = (all(same for same, _ in results.values()) and left == 0 and chaos_same
          and st_c.recovered_blocks > 0 and st_c.unrecovered_faults == 0)
    log(f"o5 {sn}^2 under {gib(OOT_STORE_BUDGET)} (depth {st.depth}, {st.waves} waves of "
        f"{st.wave_size}): dict store peak {gib(st.host_store_peak_bytes)}; "
        + ", ".join(f"{k} bit-identical {same} (store peak {gib(p)})"
                    for k, (same, p) in results.items())
        + f", {left} spill files left; chaos --fault-rate {OOT_FAULT_RATE}: bit-identical "
        f"{chaos_same}, {st_c.injected_faults} injected, {st_c.lost_blocks} lost, "
        f"{st_c.corrupt_blocks} corrupt, {st_c.recovered_blocks} recovered, {st_c.leaf_retries} "
        f"leaf retries, {st_c.unrecovered_faults} unrecovered, rung {st_c.rung} "
        f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t:.1f} s")
    if not ok:
        fail(f"o5: stores {results}, {left} spill files left, chaos bit-identical {chaos_same}, "
             f"recovered {st_c.recovered_blocks}, unrecovered {st_c.unrecovered_faults}")
    log(f"out-of-core phases o1-o5 done in {time.perf_counter() - t0:.1f} s")


def phase_oot_oom(seed: int) -> None:
    """(o6) A real device OOM: the allocator capped below the pipelined
    rung's need walks the degradation ladder."""
    t = time.perf_counter()
    gen = np.random.default_rng([seed, 5])
    n, budget = OOM_N, OOM_BUDGET
    a = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    b = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    kw = dict(depth=min_depth_for_budget(n, n, n, budget, torch.float32, pipelined=True),
              budget_bytes=budget, backend=MatmulBackend(kind="naive"), device=DEVICE)
    clean, st0, _, peak, _ = run_oot(lambda: strassen_oot_matmul(a, b, **kw))
    ref = torch.matmul(a.to(DEVICE), b.to(DEVICE)).cpu()
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(2 * total, dtype=torch.uint8, device=DEVICE)
        caught = None
    except torch.cuda.OutOfMemoryError as e:
        caught = e
    classified = caught is not None and is_oom_error(caught)
    # The pipelined rung's measured peak holds two waves of operands and one of
    # products; the halved-wave rung's needs about 3/5 of that. Cap between.
    torch.cuda.empty_cache()
    cap = torch.cuda.memory_reserved() + int(peak * OOM_CAP)
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        out, st = strassen_oot_matmul(a, b, **kw)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    err = host_rel_err(out, ref)
    causes = [e["cause"] for e in st.degrade_events]
    ok = (classified and st.degrades >= 1 and causes[0].startswith("OutOfMemoryError")
          and err <= MAIN_LIMIT[torch.float32])
    same = torch.equal(out, clean)
    log(f"o6 {n}^2 under {gib(budget)} (depth {st0.depth}, waves of {st0.wave_size}, allocator "
        f"peak {gib(peak)} uncapped) with the allocator capped at {gib(cap)} reserved: a {gib(2 * total)} allocation raises "
        f"{type(caught).__name__} classified as OOM {classified}; the run completed on rung "
        f"{st.rung} (depth {st.depth}, waves of {st.wave_size}) after {st.degrades} degrades "
        f"{[(e['from'], e['to'], e['cause'][:40]) for e in st.degrade_events]}, rel_err="
        f"{err:.3e}, bit-identical to the uncapped run {same} {'ok' if ok else 'FAIL'}; "
        f"{time.perf_counter() - t:.1f} s")
    if not ok:
        fail(f"o6: classified {classified}, degrades {st.degrades}, causes {causes}, "
             f"rel_err {err:.3e}")


def phase_spin(seed: int) -> None:
    """(o7) SPIN inversion and triangular solves under a 128 MiB budget."""
    t0 = time.perf_counter()
    gen = np.random.default_rng([seed, 6])
    n, budget = SPIN_N, SPIN_BUDGET
    g = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32)).to(DEVICE)
    eye = torch.eye(n, device=DEVICE)
    a = g @ g.T / n + 2.0 * eye
    be = MatmulBackend(kind="auto", depth=2, device_budget=budget)
    ring = attach_stats_ring()
    t = time.perf_counter()
    got = inverse(a, be, kind="spin_oot")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    want = torch.linalg.inv(a)
    err = max_rel(got, want)
    runs = ring.snapshot()
    agg = [r for r in runs if r["op"] == "inverse"][-1]
    nested = [r for r in runs if r["op"] == "matmul"]
    ok = err < SPIN_LIMIT and got.device.type == "cuda"
    log(f"o7 spin inverse {n}^2 fp32 under {gib(budget)} (dense needs {gib(2 * n * n * 4)}): "
        f"{wall:.3f} s, solver depth {agg['depth']}, {agg['leaves']} dense leaves and matmul "
        f"leaves, {agg['oot_runs']} nested out-of-core multiplies "
        f"(waves {[r['waves'] for r in nested]}, depths {sorted({r['depth'] for r in nested})}), "
        f"H2D {gib(agg['h2d_bytes'])}, modeled peak {gib(agg['peak_device_bytes'])}, "
        f"max|d|/max|want|={err:.3e} limit={SPIN_LIMIT:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"o7 inverse: max_rel {err:.3e}")
    del got, want, a
    rhs = torch.from_numpy(gen.standard_normal((n, SPIN_NRHS), dtype=np.float32)).to(DEVICE)
    for lower in (True, False):
        tri = (torch.tril(g) if lower else torch.triu(g)) / np.sqrt(n) + 2.0 * eye
        ring.clear()
        t = time.perf_counter()
        got = solve_triangular(tri, rhs, be, lower=lower, kind="spin_oot")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        want = torch.linalg.solve_triangular(tri, rhs, upper=not lower)
        err = max_rel(got, want)
        agg = [r for r in ring.snapshot() if r["op"] == "solve"][-1]
        ok = err < SPIN_LIMIT
        log(f"o7 spin solve_triangular {'lower' if lower else 'upper'} {n}^2, {SPIN_NRHS} rhs: "
            f"{wall:.3f} s, solver depth {agg['depth']}, {agg['oot_runs']} nested out-of-core "
            f"multiplies, max|d|/max|want|={err:.3e} limit={SPIN_LIMIT:.0e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"o7 solve lower={lower}: max_rel {err:.3e}")
    log(f"o7 done in {time.perf_counter() - t0:.1f} s")


def phase_oot_auto(seed: int) -> None:
    """(o8) Kind auto under a device budget at the cell's size: each
    out-of-core candidate predicted against measured, and the decision."""
    t0 = time.perf_counter()
    gen = np.random.default_rng([seed, 4])
    n, budget = OOT_N, OOT_BUDGET
    a = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    b = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32))
    ref = torch.matmul(a.to(DEVICE), b.to(DEVICE)).cpu()
    torch.cuda.empty_cache()
    calib = autotune.get_calibration(DEVICE)
    cands = autotune.enumerate_candidates(n, n, n, **AUTO_TUNE, oot_budget=budget,
                                          dtype=torch.float32, device=DEVICE)
    for cand in cands:
        fits = autotune._oot_pipeline_fits(n, n, n, cand.depth, torch.float32, budget)
        terms = autotune.predict_cost_terms(cand, n, n, n, calib, oot_overlap=fits)
        t = time.perf_counter()
        out = autotune.execute(cand, a, b, oot_budget=budget, device=DEVICE)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        err = host_rel_err(out.cpu(), ref)
        ok = cand.kind == "strassen_oot" and err <= MAIN_LIMIT[torch.float32]
        split = ", ".join(f"{k} {v:.3f}" for k, v in terms.items() if v)
        log(f"o8 candidate {n}^2 fp32 {cand.kind} {cand.scheme} depth={cand.depth} "
            f"({'pipelined' if fits else 'synchronous'}): predicted {sum(terms.values()):.3f} s "
            f"({split}), measured {secs:.3f} s, rel_err={err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"o8 candidate {cand}: rel_err {err:.3e}")
        del out
    d = autotune.autotune(n, n, n, torch.float32, calibration=calib, **AUTO_TUNE,
                          oot_budget=budget, telemetry=autotune.Telemetry(), device=DEVICE)
    ok = d.kind == "strassen_oot"
    log(f"o8 decision under {gib(budget)}: {d.kind} {d.scheme} depth={d.depth}, predicted "
        f"{d.predicted_s:.3f} s {'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    if not ok:
        fail(f"o8 decision {d}")


# ---------------------------------------------------------- serving path

def phase_serving_kernels(gen: np.random.Generator, cfg) -> None:
    """(a) RMSNorm and flash attention against their plain versions at the model's shapes."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    phase_model_kernels(gen, cfg, (1000, 2048))
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        x, w = randn(gen, (1000, d), dtype), randn(gen, (d,), dtype)
        compare(f"rmsnorm {tag} {(1000, d)} w {tag}", rmsnorm_cuda(x, w), rmsnorm_ref(x, w), "norm")
    q = randn(gen, (1, hq, 1000, hd), torch.bfloat16)
    k, v = (randn(gen, (1, hkv, 1000, hd), torch.bfloat16) for _ in range(2))
    compare("flash bf16 window=256", flash_attention_cuda(q, k, v, window=256),
            attention_ref(q, k, v, window=256), "flash")
    compare("flash bf16 non-causal", flash_attention_cuda(q, k, v, causal=False),
            attention_ref(q, k, v, causal=False), "flash")
    q, k, v = (randn(gen, (1, 16, 1000, 256), torch.bfloat16) for _ in range(3))
    compare("flash bf16 MHA D=256 (gemma)", flash_attention_cuda(q, k, v), attention_ref(q, k, v),
            "flash")
    phase_flash_grid(gen, hq, hkv, hd)


def phase_flash_grid(gen: np.random.Generator, hq: int, hkv: int, hd: int) -> None:
    """Flash attention where the tiles can break, in both dtypes: every head
    dim, query lengths against the 64-row query and 64-key tiles, GQA groups
    1, 3 and 8, no mask, a window of 256 and one below a key tile, and more
    keys than queries."""
    cases = [((1, 4, 2, 300, 300, d), {}) for d in HEAD_DIMS]
    cases += [((1, hq, hkv, s, s, hd), {}) for s in (1, 63, 65)]
    cases += [((2, 8, 8, 200, 200, 64), {}), ((2, 6, 2, 200, 200, 64), {}),
              ((2, 8, 1, 200, 200, 64), {})]
    cases += [((1, 6, 2, 1000, 1000, hd), dict(causal=False)),
              ((1, 6, 2, 1000, 1000, hd), dict(window=256)),
              ((1, 6, 2, 1000, 1000, hd), dict(window=17)),
              ((1, 4, 2, 100, 700, hd), dict(causal=False))]
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for (b, h, g, sq, sk, d), kw in cases:
            q = randn(gen, (b, h, sq, d), dtype)
            k, v = randn(gen, (b, g, sk, d), dtype), randn(gen, (b, g, sk, d), dtype)
            compare(f"flash {tag} q{tuple(q.shape)} kv{tuple(k.shape)} {kw or 'causal'}",
                    flash_attention_cuda(q, k, v, **kw), attention_ref(q, k, v, **kw), "flash")


def make_prompts(gen: np.random.Generator, vocab: int) -> list:
    return [gen.integers(0, vocab, n) for n in PROMPT_LENS]


def per_forward(cfg) -> dict:
    """Launches of each serving kernel per forward (RMSNorm, sLSTM) and per
    prefill (flash) of ``cfg``: one RMSNorm per norm, one flash launch per
    attention layer, one sLSTM launch per sLSTM layer."""
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    return {"rmsnorm_cuda": cfg.n_layers * (2 if transformer_mod._has_ffn(cfg) else 1) + 1,
            "flash_attention_cuda": sum(k in ("attn", "local_attn") for k in kinds),
            "slstm_seq_cuda": kinds.count("slstm")}


def phase_serve(cfg, params, prompts: list, serve: dict = SERVE, flash_slabs: int = 1) -> dict:
    """(b), (h), (p2), (p6), (r2), (s2) Serve the requests at full width; returns
    the launch counts, the handles, the wall time and the peak memory. Under a
    mesh (s2) each attention layer of a prefill launches flash once per head
    slab (``flash_slabs``)."""
    engine = Engine(cfg, params, ServeConfig(**serve), device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    handles = [engine.submit(p, 32 + i % 3) for i, p in enumerate(prompts)]
    n_events = sum(1 for _ in engine.stream(handles))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    st = engine.serve_stats()
    peak = torch.cuda.max_memory_allocated() / 2**30
    forwards = st["prefills"] + st["decode_steps"]
    log(f"serve {cfg.name}: {len(handles)} requests, {n_events} tokens in {wall:.3f} s "
        f"= {n_events / wall:.1f} tokens/s (first requests include kernel set-up); "
        f"prefills {st['prefills']}, decode steps {st['decode_steps']}, "
        f"peak_mem={peak:.2f} GiB")
    for h, p in zip(handles, prompts):
        ttft, gaps = h.latency_stats()
        tpot = float(np.mean(gaps)) * 1e3 if gaps else float("nan")
        log(f"serve request {h.id}: prompt {len(p)}, {len(h.tokens())} tokens, "
            f"{h.finish_reason}, ttft {ttft * 1e3:.1f} ms, mean tpot {tpot:.2f} ms")
        if h.finish_reason != "length" or len(h.tokens()) != 32 + h.id % 3:
            fail(f"serve request {h.id}: {h.finish_reason} after {len(h.tokens())} tokens")
    if st["pages_in_use"] != 0:
        fail(f"serve: {st['pages_in_use']} pages still in use after every request finished")
    each = per_forward(cfg)
    want = {"rmsnorm_cuda": each["rmsnorm_cuda"] * forwards,
            "flash_attention_cuda": each["flash_attention_cuda"] * flash_slabs * st["prefills"],
            "slstm_seq_cuda": each["slstm_seq_cuda"] * forwards}
    log(f"serve launches: {counts} (want rmsnorm {each['rmsnorm_cuda']} and sLSTM "
        f"{each['slstm_seq_cuda']} x {forwards} forwards, flash {each['flash_attention_cuda']} "
        f"x {flash_slabs} x {st['prefills']} prefills)")
    for name, n in want.items():
        if counts[name] != n:
            fail(f"serve: {name} launched {counts[name]} times, want {n}")
    # every serving kernel of this model's path ran in this run
    for name in ("rmsnorm_cuda", *(k for k in each if k != "rmsnorm_cuda" and each[k])):
        if counts[name] <= 0:
            fail(f"serve: {name} was not launched on the {cfg.name} path")
    return {"counts": counts, "handles": handles, "wall": wall, "peak": peak,
            "tokens": n_events, "stats": st}


@torch.inference_mode()
def forced_rollout(cfg, params, prompt: np.ndarray, tokens: list, max_seq: int = SERVE["max_seq"]) -> tuple:
    """The dense-cache route (apply_prefill, then apply_decode) fed the prompt
    and then ``tokens``. Returns its argmax at each step, and how far below its
    top logit the token of ``tokens`` lies there, in units of the logits' rms."""
    cache = M.init_cache(cfg, 1, max_seq, device=DEVICE)
    batch = {"tokens": torch.as_tensor(prompt[None], device=DEVICE)}
    logits, cache = M.apply_prefill(params, batch, cache, cfg)
    argmaxes, gaps = [], []
    for i, tok in enumerate(tokens):
        if i:
            prev = torch.tensor([[tokens[i - 1]]], device=DEVICE)
            logits, cache = M.apply_decode(params, prev, cache, cfg)
        row = logits[0].float()
        argmaxes.append(int(torch.argmax(row)))
        gaps.append(((row.max() - row[tok]) / row.square().mean().sqrt()).item())
    return argmaxes, gaps


def phase_engine_vs_model(cfg, params, prompts: list, served: list, seed: int,
                          serve: dict = SERVE, picks=(0, 1), fp32_layers=None) -> None:
    """(c), (i), (p3), (p6), (r3) The engine's greedy tokens against the
    dense-cache route fed the same tokens.

    The bf16 engine of (b) or (h): every served token must be the dense
    route's argmax or within NEAR_TIE of its top logit, since near-ties among
    the vocabulary's logits can flip on one bf16 rounding. A second engine in
    fp32 (the same config and seed, cut to ``fp32_layers`` where an fp32 copy
    does not fit beside the bf16 model): every token must be the argmax, which
    makes its tokens equal to a free greedy rollout on the dense cache.
    """
    max_seq = serve["max_seq"]
    for i in picks:
        toks = served[i].tokens()
        argmaxes, gaps = forced_rollout(cfg, params, prompts[i], toks, max_seq)
        equal = sum(a == t for a, t in zip(argmaxes, toks))
        ok = max(gaps) <= NEAR_TIE
        log(f"{cfg.name} engine vs dense route bf16, request {i} (prompt {len(prompts[i])}): "
            f"{equal} of {len(toks)} tokens are its argmax, largest gap {max(gaps):.3f} rms "
            f"limit={NEAR_TIE} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{cfg.name} engine vs dense route bf16, request {i}: gaps {[round(g, 3) for g in gaps]}")
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=fp32_layers or cfg.n_layers)
    params32 = M.init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(seed))
    engine = Engine(cfg32, params32, ServeConfig(**serve), device=DEVICE)
    handles = [engine.submit(prompts[i], 32 + i % 3) for i in picks]
    engine.run()
    depth = f", {cfg32.n_layers} of {cfg.n_layers} layers" if fp32_layers else ""
    for i, h in zip(picks, handles):
        argmaxes, _ = forced_rollout(cfg32, params32, prompts[i], h.tokens(), max_seq)
        ok = h.tokens() == argmaxes
        log(f"{cfg.name} engine vs dense rollout fp32{depth}, request {i} (prompt "
            f"{len(prompts[i])}): {len(argmaxes)} tokens {'equal' if ok else 'DIFFER'}")
        if not ok:
            fail(f"{cfg.name} engine vs dense rollout fp32, request {i}: {h.tokens()} != {argmaxes}")
    del engine, params32
    torch.cuda.empty_cache()


def last_logits(params, cfg, tokens: torch.Tensor, split: bool, frames=None) -> torch.Tensor:
    """Last-position logits of a prefill (of an encoder-decoder model: with
    ``frames``), or of a prefill of all but the last token followed by one
    decode step."""
    cache = M.init_cache(cfg, tokens.shape[0], tokens.shape[1], device=DEVICE)
    extra = {} if frames is None else {"frames": frames}
    if not split:
        return M.apply_prefill(params, {"tokens": tokens, **extra}, cache, cfg)[0].float()
    _, cache = M.apply_prefill(params, {"tokens": tokens[:, :-1], **extra}, cache, cfg)
    return M.apply_decode(params, tokens[:, -1:], cache, cfg)[0].float()


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()


def phase_prefill_vs_decode(cfg, params, gen: np.random.Generator, n: int = 1000) -> None:
    """(d), (j) Prefill logits against prefill + one decode step: for phi4 the
    flash kernel against plain decode attention, for xLSTM a 1-step sLSTM
    kernel launch and mLSTM step on the carried state."""
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, n)), device=DEVICE)
    full, split = last_logits(params, cfg, tokens, False), last_logits(params, cfg, tokens, True)
    err = rel_norm(split, full)
    same = int(torch.argmax(full)) == int(torch.argmax(split))
    ok = bool(torch.isfinite(full).all() and torch.isfinite(split).all()) and err <= PREFILL_DECODE_LIMIT
    log(f"{cfg.name} prefill vs prefill+decode, {n} tokens bf16: rel_err={err:.3e} "
        f"limit={PREFILL_DECODE_LIMIT:.0e}, same argmax {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name} prefill vs prefill+decode: rel_err {err:.3e}")


def phase_strassen_prefill(cfg, params, gen: np.random.Generator) -> None:
    """(e) One 1024-token prefill with every projection through strassen_fused."""
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, 1024)), device=DEVICE)
    naive = last_logits(params, cfg, tokens, False)
    fused = dataclasses.replace(
        cfg, matmul_backend=MatmulBackend(kind="strassen_fused", depth=1, min_dim=1024))
    strassen1_matmul_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = last_logits(params, fused, tokens, False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = strassen1_matmul_cuda.launches
    err = rel_norm(got, naive)
    ok = launches > 0 and bool(torch.isfinite(got).all()) and err <= STRASSEN_LIMIT
    log(f"prefill 1024 tokens, strassen_fused depth=1: strassen1 launches {launches}, "
        f"rel_err vs naive={err:.3e} limit={STRASSEN_LIMIT:.0e}, {secs * 1e3:.1f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"strassen_fused prefill: {launches} strassen1 launches, rel_err {err:.3e}")


def profile_events(fn, warm: bool = True) -> list:
    """torch.profiler's events of one call of ``fn`` (after one call to warm
    up, unless ``warm`` is False), with the tracer on and its profiler
    annotations, so that each tracer span is a CPU event over the kernels it
    launched."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    obs.configure(enabled=True, profiler_annotations=True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        obs.configure(enabled=False, profiler_annotations=False)
        obs.reset_tracing()
    return prof.events()


def device_kernels(events) -> list:
    """The device kernels among profiler ``events``."""
    from torch.autograd import DeviceType

    return [evt for evt in events
            if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False)]


def kernel_class(name: str) -> str:
    """The class of a device kernel, by its name."""
    name = name.lower()
    if "flash_bwd" in name:
        return "flash backward kernels"
    if "rmsnorm_bwd_kernel" in name:
        return "rmsnorm backward kernels"
    if "flash_kernel" in name or "flash_mma_kernel" in name:
        return "flash kernel"
    if "strassen1_" in name:
        return "strassen1 kernel"
    if "rmsnorm_kernel" in name:
        return "rmsnorm kernel"
    if "slstm_seq_kernel" in name:
        return "sLSTM kernel"
    if "slstm_seq_bwd_kernel" in name:
        return "sLSTM backward kernel"
    if any(t in name for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matmul (cuBLAS)"
    return "other kernels"


def _kernels_under(evt) -> list:
    """The device kernels that a CPU event and its children launched."""
    out = list(evt.kernels)
    for child in evt.cpu_children:
        out += _kernels_under(child)
    return out


def device_split(fn, spans: tuple = (), warm: bool = True) -> dict:
    """Device time (ms) of one call of ``fn`` (after one to warm up, unless
    ``warm`` is False): the kernels launched inside each tracer span of
    ``spans``, then the other kernels by class. Empty when the profiler saw
    no kernel."""
    from torch.autograd import DeviceType

    events = profile_events(fn, warm)
    split: dict = {}
    for evt in device_kernels(events):
        key = kernel_class(evt.name)
        split[key] = split.get(key, 0.0) + evt.device_time_total / 1e3
    if not split:
        return {}
    for name in spans:
        split[name] = 0.0
    for evt in events:
        if evt.device_type == DeviceType.CPU and evt.name in spans:
            for k in _kernels_under(evt):
                split[evt.name] += k.duration / 1e3
                split[kernel_class(k.name)] -= k.duration / 1e3
    return split


def log_split(what: str, wall_ms: float, split: dict) -> None:
    if not split:
        log(f"device split {what}: not measured (the profiler recorded no kernel)")
        return
    busy = sum(split.values())
    parts = "; ".join(f"{k} {v:.3f} ms" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
    log(f"device split {what}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"(idle share {1 - busy / wall_ms:.1%}); {parts}")


def phase_serving_numbers(cfg, params, prompts: list, reps: int) -> None:
    """(f) Prefill and decode-step times, and where one prefill's time goes."""
    for p in prompts:
        tokens = torch.as_tensor(p[None], device=DEVICE)
        ms = time_ms(lambda: last_logits(params, cfg, tokens, False), reps)
        log(f"prefill {len(p)} tokens bf16: {ms:.3f} ms")

    decode_step_numbers(cfg, params, prompts[4], SERVE)

    # One 1024-token prefill, and its parts timed alone with CUDA events.
    s, d, f = 1024, cfg.d_model, cfg.d_ff
    hq, hkv, hd, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    gen = np.random.default_rng(1)
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, s)), device=DEVICE)
    total = time_ms(lambda: last_logits(params, cfg, tokens, False), reps)
    q = randn(gen, (1, hq, s, hd), torch.bfloat16)
    k, v = (randn(gen, (1, hkv, s, hd), torch.bfloat16) for _ in range(2))
    x, w = randn(gen, (s, d), torch.bfloat16), torch.ones(d, device=DEVICE)
    flash = n * time_ms(lambda: flash_attention_cuda(q, k, v), reps)
    norm = (2 * n + 1) * time_ms(lambda: rmsnorm_cuda(x, w), reps)
    proj = 0.0
    for k_in, n_out, count in ((d, hq * hd, n), (d, hkv * hd, 2 * n), (hq * hd, d, n),
                               (d, f, 2 * n), (f, d, n), (d, cfg.vocab, 1)):
        xa, wb = randn(gen, (s, k_in), torch.bfloat16), randn(gen, (k_in, n_out), torch.bfloat16)
        proj += count * time_ms(lambda: torch.matmul(xa, wb), reps)
        del xa, wb
    log(f"breakdown prefill {s} tokens bf16, parts timed alone: total {total:.3f} ms; "
        f"flash kernel x{n} {flash:.3f} ms; rmsnorm kernel x{2 * n + 1} {norm:.3f} ms; "
        f"projections and unembed (torch.matmul) {proj:.3f} ms; "
        f"rest {total - flash - norm - proj:.3f} ms")
    log_split(f"prefill {s} tokens bf16", total,
              device_split(lambda: last_logits(params, cfg, tokens, False)))


def phase_serving_timing(cfg, reps: int, counts: dict) -> list:
    """Each serving kernel at the model's prefill shape, beside its bound, its
    plain version and the PyTorch call that computes the same function.
    RMSNorm's arithmetic is fp32 (its bound is its bytes either way); the
    flash bound takes the bf16 tensor-core rate, the fastest the card could
    do that work."""
    gen = np.random.default_rng(2)
    s, d, hq, hkv, hd = 1024, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = [json_row("rmsnorm_cuda", counts, time_rmsnorm(gen, s, d, reps))]
    w = 1.0 + randn(gen, (d,), torch.float32)
    w16 = w.bfloat16()
    xd = randn(gen, (SERVE["slots"], d), torch.bfloat16)
    time_kernel(f"rmsnorm bf16 {tuple(xd.shape)} (decode)", lambda: rmsnorm_cuda(xd, w),
                lambda: rmsnorm_ref(xd, w), lambda: torch.nn.functional.rms_norm(xd, (d,), w16, 1e-6),
                cost.rmsnorm(*xd.shape, xd.dtype, w.dtype), "norm", reps)
    for sq in (s, 2048):
        q = randn(gen, (1, hq, sq, hd), torch.bfloat16)
        k, v = (randn(gen, (1, hkv, sq, hd), torch.bfloat16) for _ in range(2))
        kr, vr = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
        stats = time_kernel(
            f"flash bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal",
            lambda: flash_attention_cuda(q, k, v), lambda: attention_ref(q, k, v),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr, is_causal=True),
            cost.flash(1, hq, hkv, sq, sq, hd, True, None, torch.bfloat16), "flash", reps)
        if sq == s:
            rows.append(json_row("flash_attention_cuda", counts, stats))
    return rows


# ------------------------------------------------------------- xLSTM path
def slstm_inputs(gen: np.random.Generator, b: int, s: int, h: int, dh: int, carried: bool):
    """wx (B, S, 4, H, dh) and r as the model draws them, and a zero state (a
    request's first prefill) or a carried one (a state after earlier steps)."""
    wx = randn(gen, (b, s, 4, h, dh), torch.float32)
    r = randn(gen, (4, h, dh, dh), torch.float32) * dh**-0.5
    if carried:
        state = {"c": randn(gen, (b, h, dh), torch.float32),
                 "n": randn(gen, (b, h, dh), torch.float32).abs() + 1.0,
                 "m": randn(gen, (b, h, dh), torch.float32),
                 "h": torch.tanh(randn(gen, (b, h, dh), torch.float32))}
    else:
        zeros = lambda: torch.zeros((b, h, dh), device=DEVICE)
        state = {"c": zeros(), "n": zeros(), "m": torch.full((b, h, dh), -1e30, device=DEVICE),
                 "h": zeros()}
    return wx, r, state


def phase_xlstm_kernels(gen: np.random.Generator, cfg) -> None:
    """(g) The RMSNorm and sLSTM kernels against their plain versions at the
    model's shapes: RMSNorm on a decode step's and a prefill's rows, at this
    model's width and at the widths where a block owns a row."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for d in (cfg.d_model, *RMSNORM_WIDE):
            for r in (SERVE["slots"], 1024):
                x, w = randn(gen, (r, d), dtype), 1.0 + randn(gen, (d,), torch.float32)
                compare(f"rmsnorm {tag} {(r, d)} w fp32", rmsnorm_cuda(x, w), rmsnorm_ref(x, w), "norm")
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    # a prefill from zero state; a decode step; more rows than a pass over a
    # tile; twice the heads, whose r does not fit the SMs' shared memory and
    # is read from L2 in part; a ragged dh
    for b, s, hh, d, carried in ((1, 1000, h, dh, False), (SERVE["slots"], 1, h, dh, True),
                                 (6, 64, h, dh, True), (2, 16, 2 * h, dh, True), (2, 64, h, 48, True)):
        wx, r, state = slstm_inputs(gen, b, s, hh, d, carried)
        got_st, got = slstm_seq_cuda(wx, r, state)
        want_st, want = slstm_seq_ref(wx, r, state)
        tag = f"slstm fp32 {(b, s, 4, hh, d)} from {'a carried' if carried else 'zero'} state"
        compare(f"{tag}: hs", got, want, "slstm")
        for k in ("c", "n", "m", "h"):
            compare(f"{tag}: {k}", got_st[k], want_st[k], "slstm")
    wx, r, state = slstm_inputs(gen, 1, 1000, h, dh, False)
    full_st, full = slstm_seq_cuda(wx, r, state)
    mid, first = slstm_seq_cuda(wx[:, :500].contiguous(), r, state)
    end, second = slstm_seq_cuda(wx[:, 500:].contiguous(), r, mid)
    compare("slstm two halves with the carried state vs one pass: hs", torch.cat([first, second], 1),
            full, "slstm")
    for k in ("c", "n", "m", "h"):
        compare(f"slstm two halves vs one pass: {k}", end[k], full_st[k], "slstm")
    names = [evt.name for evt in device_kernels(profile_events(lambda: slstm_seq_cuda(wx, r, state)))]
    found = [name for name in names if "slstm" in name.lower()]
    ok = len(found) == 1
    log(f"slstm device kernels in one call of {tuple(wx.shape)}: {len(found)} ({found}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"slstm_seq_cuda ran {len(found)} sLSTM kernels in one call, want 1: {names}")


def phase_chunkwise_prefill(cfg, params, gen: np.random.Generator) -> float:
    """(k) The chunkwise mLSTM (chunk 64) against the shipped sequential scan:
    a 256-token prefill in fp32 on the same weights, and a 1024-token prefill
    in bf16 against the fp32 chunkwise logits. Returns the ms of the shipped
    1024-token bf16 prefill."""
    chunked = dataclasses.replace(cfg, mlstm_chunk=64)
    params32 = copy.deepcopy(params).float()
    cfg32, chunked32 = (dataclasses.replace(c, dtype="float32") for c in (cfg, chunked))
    short = torch.as_tensor(gen.integers(0, cfg.vocab, (1, 256)), device=DEVICE)
    err32 = rel_norm(last_logits(params32, chunked32, short, False),
                     last_logits(params32, cfg32, short, False))
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, 1024)), device=DEVICE)
    ref = last_logits(params32, chunked32, tokens, False)
    del params32
    torch.cuda.empty_cache()
    seq_ms, seq = timed(lambda: last_logits(params, cfg, tokens, False))
    chunk_ms, got = timed(lambda: last_logits(params, chunked, tokens, False))
    err_seq, err_chunk = rel_norm(seq, ref), rel_norm(got, ref)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(seq).all())
    ok32 = err32 <= CHUNKWISE_FP32_LIMIT
    ok16 = finite and err_chunk <= BF16_SPREAD * err_seq
    log(f"prefill 256 tokens, chunkwise mLSTM (chunk 64) vs sequential, fp32: rel_err={err32:.3e} "
        f"limit={CHUNKWISE_FP32_LIMIT:.0e} {'ok' if ok32 else 'FAIL'}")
    log(f"prefill 1024 tokens bf16 against the fp32 chunkwise logits: chunkwise rel_err="
        f"{err_chunk:.3e}, sequential {err_seq:.3e}, limit {BF16_SPREAD} x sequential; chunkwise "
        f"vs sequential bf16 {rel_norm(got, seq):.3e}, same argmax "
        f"{int(torch.argmax(got)) == int(torch.argmax(seq))}; {chunk_ms:.1f} ms against "
        f"{seq_ms:.1f} ms {'ok' if ok16 else 'FAIL'}")
    if not ok32:
        fail(f"chunkwise mLSTM prefill fp32: rel_err {err32:.3e}")
    if not ok16:
        fail(f"chunkwise mLSTM prefill bf16: rel_err {err_chunk:.3e} against {err_seq:.3e}")
    return seq_ms


def timed(fn) -> tuple:
    """(milliseconds, result) of one call on the host clock, synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_xlstm_numbers(cfg, params, prompts: list, ms_1024: float) -> None:
    """(l) Prefill ms per length, the decode-step time and the device split of
    one prefill and one decode step. A prefill runs the mLSTM recurrence as
    S Python steps, so its time is linear in S: two lengths are timed once
    each here (the serve run warmed up), and 1024 tokens in (k)."""
    for p in prompts:
        if len(p) in (128, 512):
            tokens = torch.as_tensor(p[None], device=DEVICE)
            ms = timed(lambda: last_logits(params, cfg, tokens, False))[0]
            log(f"prefill {len(p)} tokens bf16: {ms:.3f} ms")
    log(f"prefill 1024 tokens bf16: {ms_1024:.3f} ms (timed in (k))")

    # The recurrent state is O(1) in the position, so short prompts give the
    # decode step of any length.
    decode_step_numbers(cfg, params, prompts[0], SERVE)

    tokens = torch.as_tensor(prompts[1][None], device=DEVICE)
    wall, _ = timed(lambda: last_logits(params, cfg, tokens, False))
    log_split(f"prefill {tokens.shape[1]} tokens bf16", wall,
              device_split(lambda: last_logits(params, cfg, tokens, False)))


def phase_slstm_timing(cfg, reps: int, counts: dict) -> list:
    """RMSNorm at the model's prefill width, warm and cold (printed; its
    JSON row is phi4's), and the sLSTM kernel at a 1024-token prefill and a
    single step from zero state and a 4-slot decode step, beside its bound and
    its plain version; the time a step adds is (t(1024) - t(1)) / 1023. No
    single PyTorch call computes the recurrence, so there is no library time.
    The bound counts the mat-vecs' fp32 operations (2 * B * S * 4 * H * dh^2)
    and the bytes of wx, r, the state in and out and hs."""
    gen = np.random.default_rng(3)
    d = cfg.d_model
    time_rmsnorm(gen, 1024, d, reps)
    h, dh = cfg.n_heads, d // cfg.n_heads
    rows, ms = [], {}
    for b, s, carried in ((1, 1024, False), (1, 1, False), (SERVE["slots"], 1, True)):
        wx, r, state = slstm_inputs(gen, b, s, h, dh, carried)
        stats = time_kernel(
            f"slstm fp32 {(b, s, 4, h, dh)}", lambda: slstm_seq_cuda(wx, r, state)[1],
            lambda: slstm_seq_ref(wx, r, state)[1], None, cost.slstm(b, s, h, dh), "slstm", reps)
        ms[(b, s)] = stats["ms"]
        if s > 1:
            rows.append(json_row("slstm_seq_cuda", counts, stats))
    step_us = (ms[(1, 1024)] - ms[(1, 1)]) / 1023 * 1e3
    log(f"time slstm per step inside a 1024-step prefill: {step_us:.3f} us "
        f"((t(1024) - t(1)) / 1023; the fp32 work of a step bounds it at "
        f"{2 * 4 * h * dh * dh / HW.peak(torch.float32) * 1e6:.3f} us)")
    return rows


def run_xlstm(seed: int, reps: int, gen: np.random.Generator) -> list:
    """(h)-(l) Serve xlstm-1.3b at full width and depth; returns its JSON entries."""
    cfg = get_config(XLSTM_ARCH)
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"{cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}, {cfg.n_layers} layers: {per_forward(cfg)['slstm_seq_cuda']} sLSTM, "
        f"d_model {cfg.d_model}) from seed {seed} in {time.perf_counter() - t:.1f} s")
    prompts = [gen.integers(0, cfg.vocab, n) for n in XLSTM_PROMPT_LENS]
    served = phase_serve(cfg, params, prompts)
    phase_engine_vs_model(cfg, params, prompts, served["handles"], seed)
    phase_prefill_vs_decode(cfg, params, gen, 512)
    ms_1024 = phase_chunkwise_prefill(cfg, params, gen)
    phase_xlstm_numbers(cfg, params, prompts, ms_1024)
    return phase_slstm_timing(cfg, reps, served["counts"])


# --------------------------------------------------------------- MoE path
def phase_model_kernels(gen: np.random.Generator, cfg, seqs: tuple, window=None) -> None:
    """(a), (p1), (r1) RMSNorm at the model's width and flash attention at its heads,
    causal (and windowed where the model's attention is), against their
    plain versions in fp32 and bf16."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for r in (1, SERVE["slots"], 1000, 4096):
            x, w = randn(gen, (r, d), dtype), 1.0 + randn(gen, (d,), torch.float32)
            compare(f"rmsnorm {tag} {(r, d)} w fp32", rmsnorm_cuda(x, w), rmsnorm_ref(x, w), "norm")
        for sq in seqs:
            q = randn(gen, (1, hq, sq, hd), dtype)
            k, v = randn(gen, (1, hkv, sq, hd), dtype), randn(gen, (1, hkv, sq, hd), dtype)
            compare(f"flash {tag} q{tuple(q.shape)} kv{tuple(k.shape)} causal window={window}",
                    flash_attention_cuda(q, k, v, window=window),
                    attention_ref(q, k, v, window=window), "flash")


def moe_drop_shares(cfg, params, tokens: torch.Tensor) -> list:
    """The share of dropped assignments in each MoE layer of one prefill, from
    the port's ``_route`` and ``_capacity`` on that layer's FFN input."""
    shares = []
    real = transformer_mod.moe_block

    def spy(p, x, c):
        t = x.shape[0] * x.shape[1]
        _, idx, _ = moe_mod._route(p, x.reshape(t, -1), c)
        keep, _ = moe_mod._slots(idx.reshape(-1), c, moe_mod._capacity(t, c))
        shares.append(1.0 - keep.float().mean().item())
        return real(p, x, c)

    transformer_mod.moe_block = spy
    try:
        last_logits(params, cfg, tokens, False)
    finally:
        transformer_mod.moe_block = real
    return shares


def phase_moe_strassen_prefill(cfg, params, gen: np.random.Generator) -> None:
    """(p5) Phase (e) on the MoE model with the tracer on: strassen1 ran, the
    logits lie within (e)'s bound of the naive run, and every router call
    stayed a naive fp32 product."""
    obs.reset_tracing()
    obs.configure(enabled=True)
    try:
        phase_strassen_prefill(cfg, params, gen)
        spans = obs.get_tracer().find("backend.matmul")
    finally:
        obs.configure(enabled=False)
        obs.reset_tracing()
    kinds: dict = {}
    for sp in spans:
        kinds.setdefault(sp.attrs["site"], set()).add(sp.attrs["kind"])
    router = [sp.attrs for sp in spans if sp.attrs["site"] == "moe.router"]
    ok = (len(router) == 2 * cfg.n_layers and kinds.get("moe.router") == {"naive"}
          and all((a["k"], a["n"]) == (cfg.d_model, cfg.n_experts) for a in router))
    log(f"{cfg.name} strassen_fused prefill: backend kinds by call site "
        f"{ {k: sorted(v) for k, v in kinds.items()} }; {len(router)} router calls (want "
        f"{2 * cfg.n_layers}: the naive and the fused prefill), all naive {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name}: router calls under strassen_fused: {len(router)}, kinds {kinds.get('moe.router')}")


def weight_bytes(params, cfg) -> int:
    """Bytes of the weights one decode step reads: every parameter but the
    embedding table, whose rows are gathered (a tied table is read whole as
    the unembedding)."""
    total = sum(nbytes(p) for p in params.parameters())
    return total if cfg.tie_embeddings else total - nbytes(params.embed.embedding)


def decode_step_numbers(cfg, params, prompt: np.ndarray, serve: dict, spans: tuple = ()) -> None:
    """Median decode-step time over 16 steps with every slot live, its device
    split, and its bound (the weights a step reads, over the card's rate)."""
    engine = Engine(cfg, params, ServeConfig(**serve), device=DEVICE)
    hs = [engine.submit(prompt, 24) for _ in range(serve["slots"])]
    while any(h.state.value != "decoding" for h in hs):
        engine.step()
    step_ms = statistics.median([timed(engine.step)[0] for _ in range(16)])
    moved = weight_bytes(params, cfg)
    log(f"decode step, {serve['slots']} live slots at ~{len(prompt)} tokens: median {step_ms:.3f} ms "
        f"(host clock around a synchronized step); bound {moved / HW.hbm_bw * 1e3:.3f} ms "
        f"(bytes: the {moved / 1e9:.2f} GB of weights a step reads)")
    log_split(f"decode step, {serve['slots']} live slots", step_ms,
              device_split(engine.step, spans))
    engine.run()


def phase_moe_numbers(cfg, params, prompts: list, reps: int) -> None:
    """(p7) Prefill ms per length, the decode step, the device split of one
    prefill and one decode step, and the allocator's peak."""
    torch.cuda.reset_peak_memory_stats()
    for n in MOE_PREFILL_LENS:
        p = next(q for q in prompts if len(q) == n)
        tokens = torch.as_tensor(p[None], device=DEVICE)
        log(f"prefill {n} tokens bf16: {time_ms(lambda: last_logits(params, cfg, tokens, False), reps):.3f} ms")
    decode_step_numbers(cfg, params, prompts[4], SERVE, MOE_SPANS)
    tokens = torch.as_tensor(prompts[5][None], device=DEVICE)
    wall = time_ms(lambda: last_logits(params, cfg, tokens, False), reps)
    log_split(f"prefill {tokens.shape[1]} tokens bf16", wall,
              device_split(lambda: last_logits(params, cfg, tokens, False), MOE_SPANS))
    log(f"{cfg.name} peak memory over (p7): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_moe_flash_timing(cfg, reps: int, counts: dict) -> list:
    """Flash attention at the MoE model's 1024-token prefill shape beside SDPA
    and its bound; a JSON entry with the MoE path's launches."""
    gen = np.random.default_rng(4)
    s, hq, hkv, hd = 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = randn(gen, (1, hq, s, hd), torch.bfloat16)
    k, v = (randn(gen, (1, hkv, s, hd), torch.bfloat16) for _ in range(2))
    stats = time_kernel(
        f"flash bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal ({cfg.name})",
        lambda: flash_attention_cuda(q, k, v), lambda: attention_ref(q, k, v),
        lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True),
        cost.flash(1, hq, hkv, s, s, hd, True, None, torch.bfloat16), "flash", reps)
    return [json_row("flash_attention_cuda", counts, stats)]


def run_moe(seed: int, reps: int, gen: np.random.Generator) -> list:
    """(p2)-(p7) Serve olmoe-1b-7b at full width and depth and qwen2-moe-a2.7b
    at full width and 4 layers; returns the JSON entries."""
    cfg = get_config(MOE_ARCH)
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    log(f"{cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}, {cfg.n_layers} layers, {cfg.n_experts} experts top-{cfg.top_k}, "
        f"d_model {cfg.d_model}) from seed {seed} in {time.perf_counter() - t:.1f} s")
    prompts = make_prompts(gen, cfg.vocab)
    served = phase_serve(cfg, params, prompts)
    longest = torch.as_tensor(prompts[-1][None], device=DEVICE)
    shares = moe_drop_shares(cfg, params, longest)
    log(f"{cfg.name} dropped share of assignments per layer, {longest.shape[1]}-token prefill "
        f"(capacity {moe_mod._capacity(longest.shape[1], cfg)} per expert): "
        f"{[round(x, 4) for x in shares]} (printed, not gated)")
    phase_engine_vs_model(cfg, params, prompts, served["handles"], seed)
    # With capacity >= T nothing is dropped, so a prefill of S tokens and a
    # prefill of S - 1 plus one decode step are the same computation (with
    # drops they are not: the reference's own consistency test leaves MoE out).
    nodrop = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    log(f"{cfg.name} (p4) on a copy with capacity_factor {nodrop.capacity_factor} "
        f"(capacity = tokens: nothing dropped); the served runs keep {cfg.capacity_factor}")
    phase_prefill_vs_decode(nodrop, params, gen)
    phase_moe_strassen_prefill(cfg, params, gen)
    phase_moe_numbers(cfg, params, prompts, reps)
    entries = phase_moe_flash_timing(cfg, reps, served["counts"])
    del params, served
    torch.cuda.empty_cache()

    qcfg = get_config(QWEN_MOE_ARCH, n_layers=QWEN_MOE_LAYERS)
    qparams = M.init_params(qcfg, torch.Generator(device=DEVICE).manual_seed(seed))
    log(f"{qcfg.name}: {sum(p.numel() for p in qparams.parameters()) / 1e9:.3f} B parameters "
        f"(full width, {qcfg.n_layers} of 24 layers: the depth is cut for time only; "
        f"{qcfg.n_experts} experts top-{qcfg.top_k}, {qcfg.n_shared_experts} shared)")
    qprompts = [prompts[i] for i in QWEN_MOE_PROMPTS]
    qserved = phase_serve(qcfg, qparams, qprompts)
    phase_engine_vs_model(qcfg, qparams, qprompts, qserved["handles"], seed)
    del qparams, qserved
    torch.cuda.empty_cache()
    return entries


# ------------------------------------------------------------ RG-LRU path
def phase_rglru_halves(cfg, params, gen: np.random.Generator, n: int = 3000) -> None:
    """(r4) Layer 0's RG-LRU block over n tokens in two halves with the
    carried {h, conv} state, against one pass."""
    layer = params.layers[0].mixer
    x = randn(gen, (1, n, cfg.d_model), torch.bfloat16)
    zero = init_rglru_state(cfg, 1, DEVICE)
    with torch.inference_mode():
        full, fst = rglru_block(layer, x, cfg, state=zero)
        first, mid = rglru_block(layer, x[:, : n // 2], cfg, state=zero)
        second, end = rglru_block(layer, x[:, n // 2:], cfg, state=mid)
    err = rel_norm(torch.cat([first, second], 1).float(), full.float())
    err_h = rel_norm(end["h"], fst["h"])
    same_tail = torch.equal(end["conv"], fst["conv"])
    ok = bool(torch.isfinite(full.float()).all()) and err <= HALVES_LIMIT and err_h <= HALVES_H_LIMIT and same_tail
    log(f"{cfg.name} RG-LRU layer 0, {n} tokens bf16, two halves with the carried state vs one "
        f"pass: out rel_err={err:.3e} limit={HALVES_LIMIT:.3e}, h rel_err={err_h:.3e} "
        f"limit={HALVES_H_LIMIT:.0e}, conv tail equal {same_tail} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name} RG-LRU halves: out {err:.3e}, h {err_h:.3e}, conv equal {same_tail}")


def phase_rglru_numbers(cfg, params, prompts: list, reps: int) -> None:
    """(r5) Prefill ms per length, the decode step, the device split of one
    prefill and one decode step (the gates and scan beside the projections and
    kernels), and the allocator's peak."""
    torch.cuda.reset_peak_memory_stats()
    gen = np.random.default_rng(5)
    for n in RG_PREFILL_LENS:
        tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, n)), device=DEVICE)
        log(f"prefill {n} tokens bf16: {time_ms(lambda: last_logits(params, cfg, tokens, False), reps):.3f} ms")
    decode_step_numbers(cfg, params, prompts[3], RG_SERVE, ("rglru.scan",))
    tokens = torch.as_tensor(prompts[3][None], device=DEVICE)
    wall = time_ms(lambda: last_logits(params, cfg, tokens, False), reps)
    log_split(f"prefill {tokens.shape[1]} tokens bf16", wall,
              device_split(lambda: last_logits(params, cfg, tokens, False), ("rglru.scan",)))
    log(f"{cfg.name} peak memory over (r5): {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def phase_rglru_kernel_timing(cfg, reps: int, counts: dict) -> list:
    """Flash attention at recurrentgemma's shape (head dim 256, 16 query heads
    on 1 KV head, window 2048) at 1024 and 3000 tokens beside SDPA (K and V
    repeated to 16 heads, the causal window as a boolean mask) and its bound
    (the live pairs of the window), and RMSNorm at (1024, 4096) warm and
    cold; JSON entries with the RG-LRU path's launches."""
    gen = np.random.default_rng(6)
    hq, hkv, hd, win = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.local_window
    rows = [json_row("rmsnorm_cuda", counts, time_rmsnorm(gen, 1024, cfg.d_model, reps))]
    for s in RG_FLASH_LENS:
        q = randn(gen, (1, hq, s, hd), torch.bfloat16)
        k, v = (randn(gen, (1, hkv, s, hd), torch.bfloat16) for _ in range(2))
        kr, vr = k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1)
        i = torch.arange(s, device=DEVICE)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < win)
        stats = time_kernel(
            f"flash bf16 q{tuple(q.shape)} kv{tuple(k.shape)} causal window={win} ({cfg.name})",
            lambda: flash_attention_cuda(q, k, v, window=win),
            lambda: attention_ref(q, k, v, window=win),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr, attn_mask=mask),
            cost.flash(1, hq, hkv, s, s, hd, True, win, torch.bfloat16), "flash", reps)
        if s == max(RG_FLASH_LENS):
            rows.append(json_row("flash_attention_cuda", counts, stats))
    return rows


def run_rglru(seed: int, reps: int, gen: np.random.Generator) -> list:
    """(r2)-(r5) Serve recurrentgemma-9b at full width and depth; returns its JSON entries."""
    cfg = get_config(RG_ARCH)
    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    torch.cuda.synchronize()
    kinds = cfg.layer_kinds()
    log(f"{cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}, {cfg.n_layers} layers: {kinds.count('rglru')} RG-LRU, "
        f"{kinds.count('local_attn')} local attention, window {cfg.local_window}, d_model "
        f"{cfg.d_model}) from seed {seed} in {time.perf_counter() - t:.1f} s")
    prompts = [gen.integers(0, cfg.vocab, n) for n in RG_PROMPT_LENS]
    served = phase_serve(cfg, params, prompts, RG_SERVE)
    budget = served["stats"]["page_budget"]
    log(f"{cfg.name}: page budget {budget} (every attention layer is a {cfg.local_window}-token "
        f"ring, so nothing is paged) {'ok' if budget == 0 else 'FAIL'}")
    if budget:
        fail(f"{cfg.name}: {budget} KV pages allocated where no layer is paged")
    phase_engine_vs_model(cfg, params, prompts, served["handles"], seed, RG_SERVE, RG_PICKS,
                          RG_FP32_LAYERS)
    phase_prefill_vs_decode(cfg, params, gen, 2500)
    phase_rglru_halves(cfg, params, gen)
    phase_rglru_numbers(cfg, params, prompts, reps)
    entries = phase_rglru_kernel_timing(cfg, reps, served["counts"])
    del params, served
    torch.cuda.empty_cache()
    return entries


# ----------------------------------------------------------- whisper path
def whisper_flash_shapes(cfg) -> list:
    """(name, q shape, kv shape, causal) of flash attention on whisper's path:
    the encoder, the decoder's prefill, and cross-attention in the prefill and
    at a decode step."""
    b, h, hd, s = WHISPER_BATCH, cfg.n_heads, cfg.head_dim, cfg.enc_seq
    p = len(WHISPER_PREFIX)
    return [("encoder", (b, h, s, hd), (b, cfg.n_kv_heads, s, hd), False),
            ("decoder prefill", (b, h, p, hd), (b, cfg.n_kv_heads, p, hd), True),
            ("cross prefill", (b, h, p, hd), (b, cfg.n_kv_heads, s, hd), False),
            ("cross decode", (b, h, 1, hd), (b, cfg.n_kv_heads, s, hd), False)]


def whisper_strassen_shapes(cfg) -> list:
    """(M, K, N) of the projections that reach strassen1 on w4's route: the
    encoder's (B * 1500)-row attention projections (and the cross K/V) and its
    MLP; the decoder's 4-token rows stay under min_dim."""
    m, d, f = WHISPER_BATCH * cfg.enc_seq, cfg.d_model, cfg.d_ff
    return [(m, d, d), (m, d, f), (m, f, d)]


def phase_whisper_kernels(gen: np.random.Generator, cfg) -> None:
    """(w1) Flash attention against its plain version at whisper's four shapes,
    and strassen1 at w4's quadrant shapes."""
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, qs, ks, causal in whisper_flash_shapes(cfg):
            q, k, v = randn(gen, qs, dtype), randn(gen, ks, dtype), randn(gen, ks, dtype)
            compare(f"flash {tag} q{qs} kv{ks} {'causal' if causal else 'non-causal'} "
                    f"(whisper {name})", flash_attention_cuda(q, k, v, causal=causal),
                    attention_ref(q, k, v, causal=causal), "flash")
        s = get_scheme(WHISPER_FUSED.scheme_name)
        for m, k, n in whisper_strassen_shapes(cfg):
            aq = split_quadrants(randn(gen, (1, m, k), dtype))
            bq = split_quadrants(randn(gen, (1, k, n), dtype))
            compare(f"strassen1 {tag} {WHISPER_FUSED.scheme_name} {(1, m // 2, k // 2, n // 2)} "
                    f"(whisper {(m, k, n)})", strassen1_matmul_cuda(aq, bq, scheme=s),
                    strassen1_matmul_ref(aq, bq, s), "mm")



@torch.inference_mode()
def whisper_rollout(cfg, params, frames, prefix, tokens):
    """The dense-cache route fed the frames, the prefix and then ``tokens``
    (B, T): per step and row, whether the token is the route's argmax and how
    far below its top logit it lies, in units of the logits' rms."""
    cache = M.init_cache(cfg, prefix.shape[0], WHISPER_SERVE["max_seq"], device=DEVICE)
    logits, cache = M.apply_prefill(params, {"tokens": prefix, "frames": frames}, cache, cfg)
    argmax_equal, gaps = 0, []
    for i in range(tokens.shape[1]):
        if i:
            logits, cache = M.apply_decode(params, tokens[:, i - 1:i], cache, cfg)
        rows = logits.float()
        tok = tokens[:, i]
        argmax_equal += int((rows.argmax(-1) == tok).sum())
        picked = rows.gather(1, tok[:, None])[:, 0]
        gaps.append((rows.amax(-1) - picked) / rows.square().mean(-1).sqrt())
    return argmax_equal, torch.stack(gaps, 1)


def phase_whisper_serve(cfg, engine, frames, prefix) -> dict:
    """(w0) One static batch through ``Engine.generate``: launch counts, the
    tokens, wall, tokens/s and the allocator's peak."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tokens, stats = engine.generate(prefix, WHISPER_NEW, frames=frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = tokens.numel()
    log(f"serve {cfg.name}: {tokens.shape[0]} requests x {tokens.shape[1]} tokens = {n} tokens "
        f"in {wall:.3f} s = {n / wall:.1f} tokens/s (generate, one static batch); "
        f"peak_mem={peak:.3f} GiB; stats {stats}")
    shape_ok = tuple(tokens.shape) == (WHISPER_BATCH, WHISPER_NEW)
    range_ok = bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    if not (shape_ok and range_ok):
        fail(f"serve {cfg.name}: tokens {tuple(tokens.shape)}, all in the vocabulary {range_ok}")
    layers = cfg.n_layers
    want = {"flash_attention_cuda": cfg.enc_layers + 2 * layers + layers * (WHISPER_NEW - 1),
            "rmsnorm_cuda": 0, "strassen1_matmul_cuda": 0}
    log(f"serve {cfg.name} launches: {counts} (want flash {cfg.enc_layers} encoder + {layers} "
        f"self + {layers} cross in the prefill, {layers} cross x {WHISPER_NEW - 1} decode steps)")
    for name, k in want.items():
        if counts[name] != k:
            fail(f"serve {cfg.name}: {name} launched {counts[name]} times, want {k}")
    return {"counts": counts, "tokens": tokens.to(DEVICE), "wall": wall, "peak": peak}


def phase_whisper_vs_fp32(cfg, params, frames, prefix, tokens) -> None:
    """(w2) Every served bf16 token against an fp32 copy of the model (its
    kernels in fp32) fed the same frames and tokens: its argmax, or at most
    NEAR_TIE x rms below its top logit."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).float()
    equal, gaps = whisper_rollout(cfg32, params32, frames.float(), prefix, tokens)
    worst = gaps.max().item()
    ok = worst <= NEAR_TIE
    log(f"{cfg.name} served bf16 tokens vs fp32 copy: {equal} of {tokens.numel()} are its "
        f"argmax, largest gap {worst:.3f} rms limit={NEAR_TIE} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name} served tokens vs fp32 copy: largest gap {worst:.3f} rms")
    del params32
    torch.cuda.empty_cache()


def phase_whisper_prefill_vs_decode(cfg, params, frames, prefix) -> None:
    """(w3) Prefill logits (flash in the decoder's self- and cross-attention)
    against a prefill of 3 tokens and one decode step (plain decode attention,
    flash at Sq = 1 for cross-attention)."""
    full = last_logits(params, cfg, prefix, False, frames)
    split = last_logits(params, cfg, prefix, True, frames)
    err = rel_norm(split, full)
    ok = bool(torch.isfinite(full).all() and torch.isfinite(split).all()) and err <= PREFILL_DECODE_LIMIT
    log(f"{cfg.name} prefill vs prefill+decode, batch {prefix.shape[0]} bf16: rel_err={err:.3e} "
        f"limit={PREFILL_DECODE_LIMIT:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name} prefill vs prefill+decode: rel_err {err:.3e}")


def phase_whisper_strassen(cfg, params, frames, prefix) -> int:
    """(w4) A prefill with every projection through strassen_fused (min_dim
    256: the encoder's (B * 1500)-row projections, the cross K/V and the
    encoder MLP reach strassen1) against the naive route; returns the launches."""
    naive = last_logits(params, cfg, prefix, False, frames)
    fused = dataclasses.replace(cfg, matmul_backend=WHISPER_FUSED)
    strassen1_matmul_cuda.launches = 0
    got = last_logits(params, fused, prefix, False, frames)
    launches = strassen1_matmul_cuda.launches
    err = rel_norm(got, naive)
    ok = launches > 0 and bool(torch.isfinite(got).all()) and err <= STRASSEN_LIMIT
    log(f"{cfg.name} prefill, strassen_fused depth={fused.matmul_backend.depth} min_dim="
        f"{fused.matmul_backend.min_dim}: strassen1 launches {launches}, "
        f"rel_err vs naive={err:.3e} limit={STRASSEN_LIMIT:.0e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{cfg.name} strassen_fused prefill: {launches} strassen1 launches, rel_err {err:.3e}")
    return launches


def phase_whisper_numbers(cfg, params, frames, prefix, reps: int) -> None:
    """(w5) Encode and prefill ms, the decode step's wall and tokens/s, and its
    device split (busy time and idle share)."""
    with torch.inference_mode():
        enc_ms = time_ms(lambda: encdec.encode(params, frames, cfg), reps)
    pre_ms = time_ms(lambda: last_logits(params, cfg, prefix, False, frames), reps)
    log(f"{cfg.name} encode, {WHISPER_BATCH} x {cfg.enc_seq} frames bf16: {enc_ms:.3f} ms; "
        f"prefill (encode + {len(WHISPER_PREFIX)}-token decoder prefill): {pre_ms:.3f} ms")
    cache = M.init_cache(cfg, WHISPER_BATCH, WHISPER_SERVE["max_seq"], device=DEVICE)
    _, cache = M.apply_prefill(params, {"tokens": prefix, "frames": frames}, cache, cfg)
    tok = prefix[:, -1:]

    def step():
        return M.apply_decode(params, tok, cache, cfg)

    wall = statistics.median([timed(step)[0] for _ in range(16)])
    log(f"{cfg.name} decode step, batch {WHISPER_BATCH}: wall {wall:.3f} ms (host clock around a "
        f"synchronized step); {WHISPER_BATCH / wall * 1e3:.1f} tokens/s at this step time")
    log_split(f"{cfg.name} decode step, batch {WHISPER_BATCH}", wall, device_split(step))


def phase_whisper_flash_timing(cfg, reps: int, counts: dict) -> list:
    """Flash attention at whisper's four shapes beside SDPA and its bound;
    JSON entries with the whisper path's launches."""
    gen = np.random.default_rng(7)
    rows = []
    for name, qs, ks, causal in whisper_flash_shapes(cfg):
        q = randn(gen, qs, torch.bfloat16)
        k, v = randn(gen, ks, torch.bfloat16), randn(gen, ks, torch.bfloat16)
        stats = time_kernel(
            f"flash bf16 q{qs} kv{ks} {'causal' if causal else 'non-causal'} (whisper {name})",
            lambda: flash_attention_cuda(q, k, v, causal=causal),
            lambda: attention_ref(q, k, v, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=causal),
            cost.flash(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], causal, None, torch.bfloat16),
            "flash", reps)
        rows.append(json_row("flash_attention_cuda", counts, stats))
    return rows


def run_whisper(seed: int, reps: int) -> list:
    """(w0), (w2)-(w5) Serve whisper-tiny at full width and depth through the
    static generate path; returns its JSON entries."""
    cfg = get_config(WHISPER_ARCH)
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    frames = make_stub_frames(cfg, WHISPER_BATCH, torch.Generator(device=DEVICE).manual_seed(seed),
                              device=DEVICE)
    prefix = torch.tensor([WHISPER_PREFIX] * WHISPER_BATCH, device=DEVICE)
    log(f"{cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e6:.3f} M parameters "
        f"({cfg.dtype}, {cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, vocab {cfg.vocab}) from seed {seed}; "
        f"frames {tuple(frames.shape)}")
    engine = Engine(cfg, params, ServeConfig(**WHISPER_SERVE), device=DEVICE)
    served = phase_whisper_serve(cfg, engine, frames, prefix)
    phase_whisper_vs_fp32(cfg, params, frames, prefix, served["tokens"])
    phase_whisper_prefill_vs_decode(cfg, params, frames, prefix)
    phase_whisper_strassen(cfg, params, frames, prefix)
    phase_whisper_numbers(cfg, params, frames, prefix, reps)
    entries = phase_whisper_flash_timing(cfg, reps, served["counts"])
    del params, engine, served
    torch.cuda.empty_cache()
    return entries


# ------------------------------------------------------------- fp8 KV cache
def probe_fp8_ops() -> None:
    """Which index ops this torch has for float8_e4m3fn on the card (printed:
    the port moves fp8 cache entries through uint8 views either way)."""
    c = torch.zeros((2, 2, 8, 4), dtype=torch.float8_e4m3fn, device=DEVICE)
    kv = torch.ones((2, 2, 1, 4), device=DEVICE).to(c.dtype)
    rows, pos = torch.arange(2, device=DEVICE), torch.tensor([1, 2], device=DEVICE)
    ops = {
        "index_copy_": lambda: c.index_copy_(2, pos[:1], kv),
        "index_put_": lambda: c.__setitem__((rows, slice(None), pos, slice(None)), kv[:, :, 0]),
        "index": lambda: c[rows],
        "roll": lambda: torch.roll(c, 1, dims=2),
        "where": lambda: torch.where(rows.bool()[:, None, None, None], c, c),
    }
    have = []
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            have.append(f"{name} ok")
        except (RuntimeError, NotImplementedError) as e:
            have.append(f"{name} missing ({type(e).__name__})")
    log(f"fp8 (float8_e4m3fn) ops on the card, torch {torch.__version__}: {', '.join(have)}")


def cache_bytes(state) -> int:
    return sum(nbytes(t) for layer in state for t in layer.values())


def phase_fp8_cache(cfg, params, prompts: list, served: list) -> None:
    """(f1) The fp8 KV cache on phi4's bf16 weights: the dense route's prefill
    and prefill + decode logits are finite, and their distance from the bf16
    cache's is printed; 4 requests through the Engine end by length, their
    first tokens agree with the bf16 engine's on at least FP8_AGREE of them,
    and the KV pool takes half the bf16 pool's bytes."""
    probe_fp8_ops()
    cfg8 = dataclasses.replace(cfg, cache_dtype=FP8)
    finite = True
    for i in FP8_PROMPTS:
        tokens = torch.as_tensor(prompts[i][None], device=DEVICE)
        full = last_logits(params, cfg, tokens, False)
        got, split = last_logits(params, cfg8, tokens, False), last_logits(params, cfg8, tokens, True)
        finite &= bool(torch.isfinite(got).all() and torch.isfinite(split).all())
        log(f"fp8 cache, prompt {tokens.shape[1]}: prefill logits rel_err vs bf16 cache="
            f"{rel_norm(got, full):.3e}, prefill+decode vs prefill {rel_norm(split, got):.3e}, "
            f"same argmax {int(got.argmax()) == int(full.argmax())}")
    engine = Engine(cfg8, params, ServeConfig(**SERVE), device=DEVICE)
    handles = [engine.submit(prompts[i], FP8_NEW) for i in FP8_PROMPTS]
    engine.run()
    ended = all(h.finish_reason == "length" and len(h.tokens()) == FP8_NEW for h in handles)
    agree = float(np.mean([h.tokens()[0] == served[i].tokens()[0]
                           for h, i in zip(handles, FP8_PROMPTS)]))
    bf16 = Engine(cfg, params, ServeConfig(**SERVE), device=DEVICE)
    bf16._ensure_serving()
    b8, b16 = cache_bytes(engine._kv), cache_bytes(bf16._kv)
    ok = finite and ended and agree >= FP8_AGREE and 2 * b8 == b16
    log(f"fp8 cache engine, {len(handles)} requests: all end by length {ended}, first tokens agree "
        f"with the bf16 engine on {agree:.0%} (limit {FP8_AGREE:.0%}), logits finite {finite}, "
        f"KV pool {b8 / 2**30:.3f} GiB vs bf16 {b16 / 2**30:.3f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"fp8 cache: finite {finite}, ended {ended}, agree {agree:.2f}, pool bytes {b8} vs {b16}")
    del engine, bf16
    torch.cuda.empty_cache()


# ------------------------------------------------------------- training
def grad_inputs(gen: np.random.Generator, qs: tuple, ks: tuple, causal: bool, dtype,
                window=None) -> tuple:
    """q, k, v, the forward kernel's out and lse, and a random output gradient."""
    q, k, v = randn(gen, qs, dtype), randn(gen, ks, dtype), randn(gen, ks, dtype)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    return q, k, v, out, lse, randn(gen, qs, dtype)


def train_flash_shapes() -> list:
    """(name, q shape, kv shape, causal, window) of flash attention on the
    training paths: phi4's layers at t3's batch, and whisper's encoder,
    decoder self-attention and cross-attention at t5's; then the D = 256
    shapes of D256_SHAPES (recurrentgemma's is t7's)."""
    phi, wh = get_config(TRAIN_ARCH), get_config(WHISPER_ARCH)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    wb, ws, we, h, hd = WHISPER_TRAIN["batch"], WHISPER_TRAIN["seq"], wh.enc_seq, wh.n_heads, wh.head_dim
    return [("phi4", (b, phi.n_heads, s, phi.head_dim), (b, phi.n_kv_heads, s, phi.head_dim), True, None),
            ("whisper encoder", (wb, h, we, hd), (wb, h, we, hd), False, None),
            ("whisper decoder", (wb, h, ws, hd), (wb, h, ws, hd), True, None),
            ("whisper cross", (wb, h, ws, hd), (wb, h, we, hd), False, None),
            *D256_SHAPES]


def mask_name(causal: bool, window) -> str:
    return ("causal" if causal else "non-causal") + ("" if window is None else f" window {window}")



def compare_grad(name: str, got: torch.Tensor, want: torch.Tensor, kind: str) -> float:
    """compare(), and in bf16 also the normwise rule GRAD_NORMWISE."""
    err = compare(name, got, want, kind)
    if got.dtype == torch.bfloat16:
        rel = rel_norm(got.float(), want.float())
        ok = rel <= GRAD_NORMWISE
        log(f"check {name}: normwise {rel:.3e} limit {GRAD_NORMWISE:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{name}: normwise {rel:.3e} > {GRAD_NORMWISE:.0e}")
    return err


def phase_train_kernels(gen: np.random.Generator) -> None:
    """(t1) The backward kernels against their plain backwards at the training
    paths' shapes, fp32 and bf16; both give the same bits on a second run."""
    phi = get_config(TRAIN_ARCH)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "fp32" if dtype == torch.float32 else "bf16"
        for name, qs, ks, causal, window in train_flash_shapes():
            ins = grad_inputs(gen, qs, ks, causal, dtype, window)
            got = flash_attention_bwd_cuda(*ins, causal=causal, window=window)
            want = attention_bwd_ref(*ins, causal=causal, window=window)
            for part, g, w in zip(("dq", "dk", "dv"), got, want):
                compare_grad(f"flash bwd {tag} {part} q{qs} kv{ks} {mask_name(causal, window)} ({name})",
                             g, w, "flash_bwd")
            if name == "phi4" or qs[3] == 256:
                again = flash_attention_bwd_cuda(*ins, causal=causal, window=window)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                log(f"check flash bwd {tag} ({name}): a second run gives the same bits {same}")
                if not same:
                    fail(f"flash bwd {tag} ({name}): two runs differ")
            if name == "phi4" and dtype == torch.bfloat16:
                # information, not a gate: the yardstick's own distance from the plain version
                sdpa = [g.float() for g in sdpa_grad(*ins[:3], ins[5], causal)()]
                ratios = [(s - w).abs().div(2**-5 * (w.abs() + w.square().mean().sqrt())).max().item()
                          for s, w in zip(sdpa, want)]
                log(f"info SDPA autograd bf16 ({name}) against the plain backward under t1's rule: "
                    f"err/limit dq {ratios[0]:.3f}, dk {ratios[1]:.3f}, dv {ratios[2]:.3f}")
            del ins, got, want
        rows, d = TRAIN_BATCH * TRAIN_SEQ, phi.d_model
        x, dy = randn(gen, (rows, d), dtype), randn(gen, (rows, d), dtype)
        w = 1.0 + 0.1 * randn(gen, (d,), torch.float32)
        dx, dw = rmsnorm_bwd_cuda(x, w, dy)
        want_dx, want_dw = rmsnorm_bwd_ref(x, w, dy)
        compare_grad(f"rmsnorm bwd {tag} dx {(rows, d)} w fp32", dx, want_dx, "norm_bwd")
        rel, limit = rel_norm(dw, want_dw), DW_LIMIT[dtype]
        again = rmsnorm_bwd_cuda(x, w, dy)
        same = torch.equal(dx, again[0]) and torch.equal(dw, again[1])
        ok = rel <= limit and same
        log(f"check rmsnorm bwd {tag} dw {(d,)}: normwise {rel:.3e} limit {limit:.0e}, a second run "
            f"gives the same bits {same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"rmsnorm bwd {tag} dw: normwise {rel:.3e} (limit {limit:.0e}), same bits {same}")
    # D = 256 at a ragged length, GQA 2 with a window: few enough key tiles
    # that the plan splits the group into parts, whose dK and dV add in turn
    ins = grad_inputs(gen, (1, 4, 100, 256), (1, 2, 100, 256), True, torch.bfloat16, 37)
    got = flash_attention_bwd_cuda(*ins, causal=True, window=37)
    want = attention_bwd_ref(*ins, causal=True, window=37)
    for part, g, w in zip(("dq", "dk", "dv"), got, want):
        compare_grad(f"flash bwd bf16 {part} D=256 q(1, 4, 100, 256) kv(1, 2, 100, 256) causal window 37",
                     g, w, "flash_bwd")
    phase_slstm_bwd_kernels(gen)


SLSTM_GRADS = ("dwx", "dr", "dc0", "dn0", "dm0", "dh0")


def slstm_grads(out: tuple) -> list:
    """(dwx, dr, {c, n, m, h}) as a list in SLSTM_GRADS' order."""
    dwx, dr, d0 = out
    return [dwx, dr, d0["c"], d0["n"], d0["m"], d0["h"]]


def slstm_bwd_inputs(gen: np.random.Generator, b: int, s: int, h: int, dh: int, carried: bool,
                     final: bool) -> tuple:
    """wx, r, the state, the saving forward kernel's (final state, hs, saved),
    a random gradient of hs and the final state's gradient (random, or zeros
    as in training, where the final state is unused)."""
    wx, r, state = slstm_inputs(gen, b, s, h, dh, carried)
    fwd = slstm_seq_cuda(wx, r, state, save=True)
    dhs = randn(gen, (b, s, h, dh), torch.float32)
    dfin = {k: randn(gen, (b, h, dh), torch.float32) if final else torch.zeros((b, h, dh), device=DEVICE)
            for k in ("c", "n", "m", "h")}
    return wx, r, state, fwd, dhs, dfin


def phase_slstm_bwd_kernels(gen: np.random.Generator) -> None:
    """(t1) The sLSTM backward kernel at SLSTM_BWD_SHAPES: fed the saved
    tensors its saving forward wrote, against the plain backward fed the same,
    element by element (the fp32 backward rule); the kernel pair (saving
    forward, backward) against the plain pair, normwise; the same bits on a
    rerun; and one backward device kernel a call in the profiler."""
    for name, b, s, h, dh, carried, final in SLSTM_BWD_SHAPES:
        wx, r, state, (_, hs, saved), dhs, dfin = slstm_bwd_inputs(gen, b, s, h, dh, carried, final)
        tag = f"slstm bwd fp32 {(b, s, 4, h, dh)} ({name})"
        got = slstm_grads(slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin))
        want = slstm_grads(slstm_seq_bwd_ref(r, state, hs, saved, dhs, dfin))
        for part, g, w in zip(SLSTM_GRADS, got, want):
            compare(f"{tag}: {part}", g, w, "slstm_bwd")
        _, hs_p, saved_p = slstm_seq_ref(wx, r, state, save=True)
        pair = slstm_grads(slstm_seq_bwd_ref(r, state, hs_p, saved_p, dhs, dfin))
        rels = {part: rel_norm(g, w) for part, g, w in zip(SLSTM_GRADS, got, pair) if w.norm() > 0}
        worst = max(rels, key=rels.get)
        again = slstm_grads(slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = rels[worst] <= SLSTM_PAIR_LIMIT and same
        log(f"check {tag}: kernel pair (saving forward + backward) vs plain pair, worst normwise "
            f"{worst} {rels[worst]:.3e} limit {SLSTM_PAIR_LIMIT:.0e}; a second run gives the same bits "
            f"{same} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{tag}: pair normwise {worst} {rels[worst]:.3e}, same bits {same}")
        del wx, r, state, hs, saved, dhs, dfin, got, want, pair, again
    _, r, state, (_, hs, saved), dhs, dfin = slstm_bwd_inputs(gen, 2, 64, 4, 512, True, True)
    events = profile_events(lambda: slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin))
    names = [evt.name for evt in device_kernels(events)]
    found = [n for n in names if "slstm" in n.lower()]
    ok = len(found) == 1 and "bwd" in found[0]
    log(f"slstm bwd device kernels in one call of (2, 64, 4, 4, 512): {len(found)} ({found}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"slstm_seq_bwd_cuda ran {len(found)} sLSTM kernels in one call, want 1: {names}")


def state_to(state: TrainState, device) -> TrainState:
    """A copy of a training state on ``device``."""
    opt = state.opt
    return TrainState(copy.deepcopy(state.params).to(device),
                      OptState(opt.step.to(device, copy=True),
                               {k: t.to(device, copy=True) for k, t in opt.m.items()},
                               {k: t.to(device, copy=True) for k, t in opt.v.items()}))


def loss_and_grads(params, batch: dict, cfg) -> tuple:
    """The loss and {name: gradient} of one forward and backward."""
    for p in params.parameters():
        p.grad = None
    loss, _ = M.loss_fn(params, batch, cfg)
    loss.backward()
    grads = {n: p.grad for n, p in params.named_parameters()}
    for p in params.parameters():
        p.grad = None
    return loss.detach(), grads


def cut_config(dtype: str = "float32"):
    """phi4-mini at full width, cut to TRAIN_CUT (2 layers, vocab 8192)."""
    return dataclasses.replace(get_config(TRAIN_ARCH), dtype=dtype, **TRAIN_CUT)


def worst_rel(got: dict, want: dict) -> tuple:
    """(largest normwise distance over the leaves, its leaf's name)."""
    rels = {n: rel_norm(got[n].detach().float().cpu(), want[n].detach().float()) for n in want}
    name = max(rels, key=rels.get)
    return rels[name], name


def phase_train_step_vs_cpu(seed: int) -> None:
    """(t2) One train step at phi4's widths (TRAIN_CUT, fp32) on the card
    against the CPU port from the same state and batch; then the same model
    in bf16 on the card against the fp32 loss."""
    cfg = cut_config()
    cpu = init_train_state(cfg, TRAIN_OPT, torch.Generator().manual_seed(seed))
    dev = state_to(cpu, DEVICE)
    model16 = copy.deepcopy(dev.params).to(torch.bfloat16)
    batch = SyntheticLM(cfg, DataConfig(CUT_BATCH, CUT_SEQ, seed), device="cpu")(0)
    dbatch = {k: t.to(DEVICE) for k, t in batch.items()}
    p0 = {n: p.detach().clone() for n, p in cpu.params.named_parameters()}
    reset_counts()
    dloss, dgrads = loss_and_grads(dev.params, dbatch, cfg)
    torch.cuda.synchronize()
    launched = (rmsnorm_bwd_cuda.launches, flash_attention_bwd_cuda.launches)
    closs, cgrads = loss_and_grads(cpu.params, batch, cfg)
    apply_updates(dev.params, dgrads, dev.opt, TRAIN_OPT)
    apply_updates(cpu.params, cgrads, cpu.opt, TRAIN_OPT)
    loss_rel = abs(dloss.item() - closs.item()) / abs(closs.item())
    g_rel, g_name = worst_rel(dgrads, cgrads)
    d_dev = {n: p.detach() - p0[n].to(DEVICE) for n, p in dev.params.named_parameters()}
    d_cpu = {n: p.detach() - p0[n] for n, p in cpu.params.named_parameters()}
    u_rel, u_name = worst_rel(d_dev, d_cpu)
    n_params = sum(p.numel() for p in p0.values())
    ok = (loss_rel <= STEP_LIMITS["loss"] and g_rel <= STEP_LIMITS["grad"]
          and u_rel <= STEP_LIMITS["update"] and launched == (2 * cfg.n_layers + 1, cfg.n_layers))
    log(f"train step fp32 on the card vs the CPU port ({cfg.name} widths, {cfg.n_layers} layers, "
        f"vocab {cfg.vocab}, {n_params / 1e6:.1f} M parameters, batch {CUT_BATCH} x {CUT_SEQ}): "
        f"loss {dloss.item():.6f} vs {closs.item():.6f} rel {loss_rel:.2e} (limit "
        f"{STEP_LIMITS['loss']:.0e}); worst gradient leaf {g_name} normwise {g_rel:.2e} (limit "
        f"{STEP_LIMITS['grad']:.0e}); worst update leaf {u_name} normwise {u_rel:.2e} (limit "
        f"{STEP_LIMITS['update']:.0e}); backward launches rmsnorm {launched[0]}, flash "
        f"{launched[1]} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t2 train step vs CPU: loss {loss_rel:.2e}, grad {g_rel:.2e} ({g_name}), update "
             f"{u_rel:.2e} ({u_name}), launches {launched}")
    del cpu, dgrads, cgrads, d_dev, d_cpu
    cfg16 = cut_config("bfloat16")
    loss16, grads16 = loss_and_grads(model16, dbatch, cfg16)
    rel16 = abs(loss16.item() - dloss.item()) / abs(dloss.item())
    ok = rel16 <= BF16_LOSS_LIMIT and all(bool(torch.isfinite(g).all()) for g in grads16.values())
    log(f"train step bf16 on the card: loss {loss16.item():.6f} vs fp32 {dloss.item():.6f} rel "
        f"{rel16:.2e} (limit {BF16_LOSS_LIMIT:.0e}), gradients finite {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t2 bf16 loss rel {rel16:.2e} or non-finite gradients")
    del dev, model16, grads16
    torch.cuda.empty_cache()


def state_leaves(state: TrainState) -> list:
    return [*state.params.state_dict().values(), state.opt.step, *state.opt.m.values(),
            *state.opt.v.values()]


def phase_checkpoint_round_trip(seed: int) -> None:
    """(t4) Save after step 2, restore into a fresh state, run step 3: the
    same loss and state, bit for bit, as the uninterrupted run's step 3."""
    cfg = cut_config()
    step = make_train_step(cfg, TRAIN_OPT)
    data = SyntheticLM(cfg, DataConfig(CUT_BATCH, CUT_SEQ, seed), device=DEVICE)
    a = init_train_state(cfg, TRAIN_OPT, torch.Generator(device=DEVICE).manual_seed(seed))
    for i in range(2):
        a, _ = step(a, data(i))
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        path = save_pytree(a, d, step=2)
        save_s = time.perf_counter() - t
        a, ma = step(a, data(2))
        b = init_train_state(cfg, TRAIN_OPT, torch.Generator(device=DEVICE).manual_seed(seed + 1))
        t = time.perf_counter()
        load_pytree(b, path)
        load_s = time.perf_counter() - t
        b, mb = step(b, data(2))
    same_loss = torch.equal(ma["loss"], mb["loss"])
    same = all(torch.equal(x, y) for x, y in zip(state_leaves(a), state_leaves(b)))
    ok = same_loss and same and int(b.opt.step) == 3
    log(f"checkpoint round trip at step 2 ({len(state_leaves(a))} leaves, save {save_s:.2f} s, load "
        f"{load_s:.2f} s): step 3 loss {mb['loss'].item():.6f} vs {ma['loss'].item():.6f} "
        f"bit-identical {same_loss}, state after step 3 bit-identical {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t4 checkpoint round trip: same loss {same_loss}, same state {same}")
    del a, b
    torch.cuda.empty_cache()


def phase_fenced_routes(seed: int) -> None:
    """(t6) strassen_fused raises under autograd on the card (it has no
    gradient, nor has the reference's Pallas level); a kind-strassen depth-1
    train step matches kind naive."""
    a = torch.randn(256, 256, device=DEVICE, requires_grad=True)
    w = torch.randn(256, 256, device=DEVICE)
    try:
        matmul(a, w, MatmulBackend(kind="strassen_fused", depth=1, min_dim=64))
        fail("strassen_fused under autograd on the card ran; it should raise")
    except NotImplementedError as e:
        ok = "no gradient" in str(e)
        log(f"check strassen_fused under autograd raises NotImplementedError ({e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"strassen_fused: unexpected message {e}")
    cfg = cut_config()
    cfg_s = dataclasses.replace(cfg, matmul_backend=STRASSEN_TRAIN)
    naive = init_train_state(cfg, TRAIN_OPT, torch.Generator(device=DEVICE).manual_seed(seed))
    strassen = state_to(naive, DEVICE)
    batch = SyntheticLM(cfg, DataConfig(CUT_BATCH, CUT_SEQ, seed), device=DEVICE)(0)
    _, mn = make_train_step(cfg, TRAIN_OPT)(naive, batch)
    _, ms = make_train_step(cfg_s, TRAIN_OPT)(strassen, batch)
    rel = abs(ms["loss"].item() - mn["loss"].item()) / abs(mn["loss"].item())
    g_rel = abs(ms["grad_norm"].item() - mn["grad_norm"].item()) / mn["grad_norm"].item()
    ok = rel <= STRASSEN_LOSS_LIMIT and np.isfinite(ms["grad_norm"].item())
    log(f"train step kind strassen depth {STRASSEN_TRAIN.depth} vs naive (fp32, t2's config): loss "
        f"{ms['loss'].item():.6f} vs {mn['loss'].item():.6f} rel {rel:.2e} (limit "
        f"{STRASSEN_LOSS_LIMIT:.0e}), grad norm rel {g_rel:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t6 strassen train step: loss rel {rel:.2e}")
    del naive, strassen
    torch.cuda.empty_cache()


def xlstm_cut_config():
    """xlstm-1.3b at full width, cut to XLSTM_TRAIN_CUT (one block pattern:
    7 mLSTM and 1 sLSTM layers, vocab 8192), fp32."""
    return dataclasses.replace(get_config(XLSTM_ARCH), dtype="float32", **XLSTM_TRAIN_CUT)


def phase_xlstm_step_vs_cpu(seed: int) -> None:
    """(t8) One fp32 train step at xlstm-1.3b's width (XLSTM_TRAIN_CUT) on the
    card, whose sLSTM layer runs the saving forward and the backward kernel,
    against the CPU port from the same state and batch: the loss, each
    gradient leaf (r's named apart) and each update, as t2, the update from
    the same gradients (see below)."""
    cfg = xlstm_cut_config()
    cpu = init_train_state(cfg, TRAIN_OPT, torch.Generator().manual_seed(seed))
    dev, dev_same = state_to(cpu, DEVICE), state_to(cpu, DEVICE)
    batch = SyntheticLM(cfg, DataConfig(CUT_BATCH, CUT_SEQ, seed), device="cpu")(0)
    dbatch = {k: t.to(DEVICE) for k, t in batch.items()}
    p0 = {n: p.detach().clone() for n, p in cpu.params.named_parameters()}
    reset_counts()
    dloss, dgrads = loss_and_grads(dev.params, dbatch, cfg)
    torch.cuda.synchronize()
    launched = (slstm_seq_cuda.launches, slstm_seq_bwd_cuda.launches)
    t = time.perf_counter()
    closs, cgrads = loss_and_grads(cpu.params, batch, cfg)
    cpu_s = time.perf_counter() - t
    apply_updates(dev.params, dgrads, dev.opt, TRAIN_OPT)
    apply_updates(dev_same.params, {n: g.to(DEVICE) for n, g in cgrads.items()}, dev_same.opt, TRAIN_OPT)
    apply_updates(cpu.params, cgrads, cpu.opt, TRAIN_OPT)
    loss_rel = abs(dloss.item() - closs.item()) / abs(closs.item())
    # A leaf below NOISE_SHARE of the whole gradient is zero in exact
    # arithmetic and fp32 roundoff in both runs (the mLSTM input-gate bias:
    # the stabilizer cancels a shift of a head's input gates), as the CPU
    # tests find: it is held to that share absolutely, and its update, about
    # lr x the sign of roundoff, is not compared.
    total = torch.sqrt(sum(g.double().square().sum() for g in cgrads.values())).item()
    noise = {n for n, g in cgrads.items() if g.double().norm().item() <= NOISE_SHARE * total}
    noise_err = max([(dgrads[n].detach().cpu().double() - cgrads[n].double()).norm().item() for n in noise],
                    default=0.0)
    g_rel, g_name = worst_rel({n: dgrads[n] for n in cgrads if n not in noise},
                              {n: g for n, g in cgrads.items() if n not in noise})
    r_names = [n for n in cgrads if n.endswith(".r")]
    r_rel = max(rel_norm(dgrads[n].detach().cpu(), cgrads[n]) for n in r_names)
    # The update is gated with the same gradients on both sides: AdamW's
    # first update, lr g / (|g| + eps), is ill-conditioned where |g| is near
    # eps (1e-8), and an element of a leaf may sit there (xlstm's cut config
    # has one in layers.3.ln1.scale, which the log line prints), where a
    # gradient difference of 1e-9 moves the leaf's update by 1e-3 normwise.
    # Each side's own update
    # is compared too, and printed with the element nearest 0.
    d_cpu = {n: p.detach() - p0[n] for n, p in cpu.params.named_parameters() if n not in noise}
    d_same = {n: p.detach() - p0[n].to(DEVICE) for n, p in dev_same.params.named_parameters() if n not in noise}
    u_rel, u_name = worst_rel(d_same, d_cpu)
    d_dev = {n: p.detach() - p0[n].to(DEVICE) for n, p in dev.params.named_parameters() if n not in noise}
    own_rel, own_name = worst_rel(d_dev, d_cpu)
    g_min = cgrads[own_name].abs().min().item()
    n_slstm = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.n_layers))
    want = (n_slstm * (2 if cfg.remat else 1), n_slstm)
    ok = (loss_rel <= STEP_LIMITS["loss"] and g_rel <= STEP_LIMITS["grad"] and r_rel <= STEP_LIMITS["grad"]
          and noise_err <= NOISE_SHARE * total and u_rel <= STEP_LIMITS["update"] and launched == want
          and len(r_names) == n_slstm)
    log(f"t8 xLSTM train step fp32 on the card vs the CPU port ({cfg.name} widths, {cfg.n_layers} layers "
        f"({', '.join(cfg.block_pattern)}), vocab {cfg.vocab}, "
        f"{sum(x.numel() for x in p0.values()) / 1e6:.1f} M parameters, batch {CUT_BATCH} x {CUT_SEQ}, remat "
        f"{cfg.remat}): loss {dloss.item():.6f} vs {closs.item():.6f} rel {loss_rel:.2e} (limit "
        f"{STEP_LIMITS['loss']:.0e}); worst gradient leaf {g_name} normwise {g_rel:.2e}, r {r_rel:.2e} "
        f"(limit {STEP_LIMITS['grad']:.0e}); {len(noise)} leaves below {NOISE_SHARE:.0e} of the gradient "
        f"({', '.join(sorted(noise))}) within {noise_err:.2e} (limit {NOISE_SHARE * total:.2e}); worst "
        f"update leaf from the same gradients {u_name} normwise {u_rel:.2e} (limit "
        f"{STEP_LIMITS['update']:.0e}); from each side's own gradients {own_name} {own_rel:.2e} (printed; "
        f"its smallest |g| {g_min:.2e}); sLSTM launches forward {launched[0]}, backward {launched[1]} "
        f"(expected {want}); the CPU step took {cpu_s:.1f} s {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t8 xLSTM train step vs CPU: loss {loss_rel:.2e}, grad {g_rel:.2e} ({g_name}), r {r_rel:.2e}, "
             f"noise leaves {noise_err:.2e}, update {u_rel:.2e} ({u_name}), launches {launched} "
             f"(expected {want})")
    del cpu, dev, dev_same, dgrads, cgrads, d_dev, d_cpu, d_same
    torch.cuda.empty_cache()


def train_flops(cfg, n_params: int, tokens: int, batch: int, seq: int) -> dict:
    """One step's work: 6 N T (forward and backward of every parameter), the
    remat forward of the layers (2 N_layers T), and attention's score and
    P V products (forward, remat forward, and the backward's five)."""
    n_layers = n_params - cfg.vocab * cfg.d_model  # all but the (tied) embedding
    attn = cfg.n_layers * cost.flash(batch, cfg.n_heads, cfg.n_kv_heads, seq, seq, cfg.head_dim, True, None,
                                     torch.bfloat16).ops
    return {"6NT": 6 * n_params * tokens, "remat": 2 * n_layers * tokens,
            "attention": (1 + (1 if cfg.remat else 0) + 2.5) * attn}


def run_train_loop(cfg, opt, run: dict, seed: int, what: str, mesh=None,
                   falling: bool = True) -> tuple:
    """Train ``cfg`` through launch/train.py's train_loop; returns (state,
    history, stats, launch counts, peak GiB, wall s) with the gates checked:
    losses and grad norms finite and, with ``falling``, the last loss below
    the first."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stats: dict = {}
    before = torch.cuda.memory_stats()
    t = time.perf_counter()
    state, history = train_mod.train_loop(
        cfg, opt, steps=run["steps"], batch=run["batch"], seq=run["seq"], seed=seed,
        stats_out=stats, device=DEVICE, data_cycle=run["cycle"], log_every=1, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    after = torch.cuda.memory_stats()
    log(f"{what}: allocator peak {peak:.2f} GiB allocated, "
        f"{after.get('reserved_bytes.all.peak', 0) / 2**30:.2f} GiB reserved; during the run "
        f"{after.get('num_alloc_retries', 0) - before.get('num_alloc_retries', 0)} alloc retries, "
        f"{after.get('num_device_alloc', 0) - before.get('num_device_alloc', 0)} cudaMalloc calls")
    finite = all(np.isfinite(history)) and all(np.isfinite(stats["grad_norm"]))
    ok = finite and len(history) == run["steps"] and (history[-1] < history[0] or not falling)
    log(f"{what}: {run['steps']} steps of {run['batch']} x {run['seq']} tokens cycling "
        f"{run['cycle']} batches in {wall:.1f} s; loss {' '.join(f'{x:.4f}' for x in history)}; grad "
        f"norm {' '.join(f'{x:.3f}' for x in stats['grad_norm'])}; finite {finite}, last below "
        f"first {history[-1] < history[0]} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{what}: losses {history}, grad norms {stats['grad_norm']}")
    return state, history, stats, counts, peak, wall


def phase_train_phi4(seed: int, smi: str) -> dict:
    """(t3) phi4-mini-3.8B at full width and depth, bf16, trained through
    train_loop: gates, launches per step, step time, tokens/s, model
    TFLOP/s, the allocator's peak and one step's device split."""
    cfg = get_config(TRAIN_ARCH)
    run = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ, cycle=TRAIN_CYCLE)
    state, history, stats, counts, peak, wall = run_train_loop(
        cfg, TRAIN_OPT, run, seed, f"t3 {cfg.name} full ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.dtype}, remat every {len(cfg.block_pattern)})")
    n_params = sum(p.numel() for p in state.params.parameters())
    state_gb = sum(nbytes(t) for t in state_leaves(state)) / 1e9
    steps = TRAIN_STEPS
    per_step = {k: v / steps for k, v in counts.items() if v}
    want = {"rmsnorm_bwd_cuda": 2 * cfg.n_layers + 1, "flash_attention_bwd_cuda": cfg.n_layers,
            "rmsnorm_cuda": 2 * (2 * cfg.n_layers) + 1, "flash_attention_cuda": 2 * cfg.n_layers}
    ok = all(per_step.get(k) == v for k, v in want.items())
    log(f"t3 launches per step (remat runs each layer's forward twice): "
        f"{', '.join(f'{k} {v:g}' for k, v in sorted(per_step.items()))}; expected {want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t3 launches per step {per_step}, expected {want}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = stats["median_step_time_s"]
    flops = train_flops(cfg, n_params, tokens, TRAIN_BATCH, TRAIN_SEQ)
    total = sum(flops.values())
    log(f"t3 numbers on {smi}: {n_params / 1e9:.3f} B parameters, state {state_gb:.2f} GB (bf16 "
        f"parameters, fp32 moments); median step {step_s * 1e3:.1f} ms (host clock, train_loop's "
        f"watchdog), {tokens / step_s:.0f} tokens/s; work per step "
        f"{', '.join(f'{k} {v / 1e12:.2f}' for k, v in flops.items())} TFLOP = {total / 1e12:.2f} "
        f"TFLOP, {total / step_s / 1e12:.1f} TFLOP/s ({total / step_s / HW.peak(torch.bfloat16):.1%}"
        f" of the 989 TFLOP/s bf16 peak; 6NT alone {flops['6NT'] / step_s / 1e12:.1f} TFLOP/s); "
        f"allocator peak {peak:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    log_step_split(cfg, TRAIN_OPT, state, TRAIN_BATCH, TRAIN_SEQ, seed, "t3")
    del state
    torch.cuda.empty_cache()
    return counts


def log_step_split(cfg, opt, state: TrainState, batch: int, seq: int, seed: int, tag: str) -> None:
    """One more train step's wall (CUDA events, no profiler) and its device
    split by kernel class from the profiler, with its idle share; then the
    AdamW update alone (on one batch's gradients), profiled apart: its
    elementwise kernels are among the step's "other kernels"."""
    step = make_train_step(cfg, opt)
    data = SyntheticLM(cfg, DataConfig(batch, seq, seed), device=DEVICE)(0)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], data)

    step_ms = time_ms(one_step, 1)
    log_split(f"{tag} one train step ({batch} x {seq} tokens, {cfg.dtype})", step_ms,
              device_split(one_step))
    st = holder[0]
    _, grads = loss_and_grads(st.params, data, cfg)
    update_ms = time_ms(lambda: apply_updates(st.params, grads, st.opt, opt), 1)
    log_split(f"{tag} AdamW update alone, on one batch's gradients", update_ms,
              device_split(lambda: apply_updates(st.params, grads, st.opt, opt)))


def run_whisper_train(seed: int) -> dict:
    """(t5) whisper-tiny at full width and depth, bf16, trained through
    train_loop on 8 x 1500 frames and 128 decoder tokens."""
    cfg = get_config(WHISPER_ARCH)
    run = dict(steps=WHISPER_TRAIN["steps"], batch=WHISPER_TRAIN["batch"], seq=WHISPER_TRAIN["seq"],
               cycle=WHISPER_TRAIN["cycle"])
    state, _, stats, counts, peak, _ = run_train_loop(
        cfg, WHISPER_TRAIN_OPT, run, seed, f"t5 {cfg.name} full ({cfg.enc_layers} + {cfg.n_layers} "
        f"layers, {cfg.dtype}, frames {WHISPER_TRAIN['batch']} x {cfg.enc_seq})")
    per_step = counts["flash_attention_bwd_cuda"] / run["steps"]
    want = cfg.enc_layers + 2 * cfg.n_layers
    ok = per_step == want
    step_s = stats["median_step_time_s"]
    log(f"t5 flash bwd launches per step {per_step:g} (expected {want}: encoder, decoder self- and "
        f"cross-attention) {'ok' if ok else 'FAIL'}; median step {step_s * 1e3:.1f} ms, "
        f"{run['batch'] * run['seq'] / step_s:.0f} decoder tokens/s, allocator peak {peak:.2f} GiB")
    if not ok:
        fail(f"t5 flash bwd launches per step {per_step}, expected {want}")
    log_step_split(cfg, WHISPER_TRAIN_OPT, state, run["batch"], run["seq"], seed, "t5")
    del state
    torch.cuda.empty_cache()
    return counts


def run_rg_train(seed: int) -> dict:
    """(t7) recurrentgemma-9b at full width, cut to RG_TRAIN's one block
    pattern (3 layers, one local_attn), bf16: RG_TRAIN steps of 1 x 4096
    SyntheticLM tokens through launch/train.py's build, each step profiled
    for its device split. Gates: loss and grad norm finite each step, and
    the flash backward launched once a step (one attention layer)."""
    full = get_config(RG_ARCH)
    cfg = dataclasses.replace(full, n_layers=len(full.block_pattern))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, data, step = train_mod.build(cfg, RG_TRAIN_OPT, batch=RG_TRAIN["batch"], seq=RG_TRAIN["seq"],
                                        accum=1, seed=seed, device=DEVICE)
    n_params = sum(p.numel() for p in state.params.parameters())
    n_attn = sum(cfg.block_kind(i) in ("attn", "local_attn") for i in range(cfg.n_layers))
    reset_counts()
    holder = [state]
    losses, norms = [], []
    for i in range(RG_TRAIN["steps"]):
        def one_step(i=i):
            holder[0], metrics = step(holder[0], data(i))
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        split = device_split(one_step, warm=False)
        end.record()
        end.synchronize()
        log_split(f"t7 step {i} ({RG_TRAIN['batch']} x {RG_TRAIN['seq']} tokens, {cfg.dtype}, under the "
                  f"profiler)",
                  start.elapsed_time(end), split)
    counts = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = counts["flash_attention_bwd_cuda"] / RG_TRAIN["steps"]
    finite = all(np.isfinite(losses)) and all(np.isfinite(norms))
    ok = finite and per_step == n_attn and len(losses) == RG_TRAIN["steps"]
    log(f"t7 {cfg.name} cut to {cfg.n_layers} layers ({', '.join(cfg.block_pattern)}; full depth "
        f"{full.n_layers}) at full width (d_model {cfg.d_model}, vocab {cfg.vocab}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim}, window {cfg.local_window}), {cfg.dtype}, "
        f"{n_params / 1e9:.3f} B parameters: {RG_TRAIN['steps']} steps of {RG_TRAIN['batch']} x "
        f"{RG_TRAIN['seq']} tokens; loss {' '.join(f'{x:.4f}' for x in losses)}; grad norm "
        f"{' '.join(f'{x:.3f}' for x in norms)}; flash bwd launches per step {per_step:g} (expected "
        f"{n_attn}); finite {finite}; allocator peak {peak:.2f} GiB {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t7: losses {losses}, grad norms {norms}, flash bwd launches per step {per_step}")
    del state, holder, data, step
    torch.cuda.empty_cache()
    return counts


def run_xlstm_train(seed: int, smi: str) -> dict:
    """(t9) xlstm-1.3b at full width and depth (48 layers, 6 sLSTM), bf16,
    remat every 8 layers, the chunkwise mLSTM (XLSTM_TRAIN_CHUNK), trained
    XLSTM_TRAIN's steps through train_loop (launch/train.py's build). Gates:
    losses and grad norms finite, the last loss below the first, and per step
    6 sLSTM backward launches and 12 forward ones (twice under remat). Then
    the step time, tokens/s, the allocator's peak and one more step's device
    split, the sLSTM forward and backward kernels and the dr product (span
    slstm.dr) apart."""
    cfg = dataclasses.replace(get_config(XLSTM_ARCH), mlstm_chunk=XLSTM_TRAIN_CHUNK)
    run = dict(XLSTM_TRAIN)
    state, history, stats, counts, peak, wall = run_train_loop(
        cfg, XLSTM_TRAIN_OPT, run, seed, f"t9 {cfg.name} full ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.vocab}, {cfg.dtype}, remat every {len(cfg.block_pattern)}, mlstm_chunk {cfg.mlstm_chunk})")
    n_slstm = sum(cfg.block_kind(i) == "slstm" for i in range(cfg.n_layers))
    per_step = {k: v / run["steps"] for k, v in counts.items() if v}
    want = {"slstm_seq_bwd_cuda": n_slstm, "slstm_seq_cuda": n_slstm * (2 if cfg.remat else 1),
            "rmsnorm_bwd_cuda": per_forward(cfg)["rmsnorm_cuda"]}
    ok = all(per_step.get(k) == v for k, v in want.items())
    log(f"t9 launches per step (remat runs each layer's forward twice): "
        f"{', '.join(f'{k} {v:g}' for k, v in sorted(per_step.items()))}; expected {want} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"t9 launches per step {per_step}, expected {want}")
    n_params = sum(p.numel() for p in state.params.parameters())
    tokens = run["batch"] * run["seq"]
    step_s = stats["median_step_time_s"]
    log(f"t9 numbers on {smi}: {n_params / 1e9:.3f} B parameters; median step {step_s * 1e3:.1f} ms "
        f"(host clock, train_loop's watchdog), {tokens / step_s:.0f} tokens/s, 6NT "
        f"{6 * n_params * tokens / step_s / 1e12:.1f} TFLOP/s; {run['steps']} steps in {wall:.1f} s; allocator "
        f"peak {peak:.2f} GiB of {torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")
    step = make_train_step(cfg, XLSTM_TRAIN_OPT)
    data = SyntheticLM(cfg, DataConfig(run["batch"], run["seq"], seed), device=DEVICE)(0)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], data)

    # the state is warm from train_loop: one step timed, one profiled
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    one_step()
    end.record()
    end.synchronize()
    t = time.perf_counter()
    log_split(f"t9 one train step ({run['batch']} x {run['seq']} tokens, {cfg.dtype})", start.elapsed_time(end),
              device_split(one_step, spans=("slstm.dr",), warm=False))
    log(f"t9 profiled step and its events took {time.perf_counter() - t:.1f} s")
    del state, holder, data, step
    torch.cuda.empty_cache()
    return counts


def time_grads(name, kernel, plain, library, work: cost.Cost, kind, reps) -> dict:
    """time_kernel() for a kernel that returns several gradients: each
    checked against the plain version's, then the three timed."""
    errs = [compare_grad(f"{name} {i}", g, w, kind) for i, (g, w) in
            enumerate(zip(kernel(), plain()))]
    ms, plain_ms = time_ms(kernel, reps, queued=True), time_ms(plain, reps, queued=True)
    library_ms = time_ms(library, reps, queued=True)
    bms, by = bound_ms(work.ops, work.bytes, work.dtype)
    log(f"time {name}: kernel {ms:.5g} ms, plain {plain_ms:.5g} ms, library {library_ms:.5g} ms, "
        f"bound {bms:.5g} ms ({by}), kernel at {bms / ms:.1%} of bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms, bound_by=by,
                max_abs_err=max(errs))


def sdpa_grad(q, k, v, do, causal: bool, window=None):
    """torch.autograd through scaled_dot_product_attention (the yardstick;
    the port never calls it): a call of the backward alone. A window goes
    in as a boolean mask, beside K and V repeated to q's heads."""
    if window is None:
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])
    else:
        group = q.shape[1] // k.shape[1]
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k.repeat_interleave(group, 1),
                                                             v.repeat_interleave(group, 1)))
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        out = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=(i >= j) & (i - j < window))
    return lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True)


def phase_train_timing(reps: int, phi_counts: dict, whisper_counts: dict, rg_counts: dict,
                       xlstm_counts: dict) -> list:
    """(t1) The backward kernels timed at the training paths' shapes (bf16;
    sLSTM's fp32) beside their plain versions, torch.autograd through SDPA
    and F.rms_norm, and their bounds; JSON entries with the paths' launches
    (t3's for phi4, t5's for whisper, t7's for the D = 256 shapes, t9's for
    the sLSTM backward)."""
    gen = np.random.default_rng(8)
    rows = []
    for name, qs, ks, causal, window in train_flash_shapes():
        q, k, v, out, lse, do = grad_inputs(gen, qs, ks, causal, torch.bfloat16, window)
        stats = time_grads(
            f"flash bwd bf16 q{qs} kv{ks} {mask_name(causal, window)} ({name})",
            lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal, window=window),
            lambda: attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window),
            sdpa_grad(q, k, v, do, causal, window),
            cost.flash_bwd(qs[0], qs[1], ks[1], qs[2], ks[2], qs[3], causal, window, torch.bfloat16),
            "flash_bwd", reps)
        counts = phi_counts if name == "phi4" else rg_counts if qs[3] == 256 else whisper_counts
        rows.append(json_row("flash_attention_bwd_cuda", counts, stats))
        del q, k, v, out, lse, do
        torch.cuda.empty_cache()
    d = get_config(TRAIN_ARCH).d_model
    shape = (TRAIN_BATCH * TRAIN_SEQ, d)
    w = 1.0 + 0.1 * randn(gen, (d,), torch.float32)
    w16 = w.bfloat16().requires_grad_()
    xs = cold_inputs(gen, shape, torch.bfloat16)
    pairs = [(x, xs[(i + 1) % len(xs)]) for i, x in enumerate(xs)]  # (x, dy), rotating
    graphs = []
    for x, dy in pairs:
        xg = x.detach().requires_grad_()
        graphs.append((torch.nn.functional.rms_norm(xg, (d,), w16, 1e-6), xg, dy))
    stats = time_grads(
        f"rmsnorm bwd bf16 {shape} w fp32 cold L2 ({len(pairs)} x/dy pairs rotating)",
        rotating(lambda p: rmsnorm_bwd_cuda(p[0], w, p[1]), pairs),
        rotating(lambda p: rmsnorm_bwd_ref(p[0], w, p[1]), pairs),
        rotating(lambda g: torch.autograd.grad(g[0], (g[1], w16), g[2], retain_graph=True), graphs),
        cost.rmsnorm_bwd(*shape, torch.bfloat16, w.dtype), "norm_bwd", reps)
    rows.append(json_row("rmsnorm_bwd_cuda", phi_counts, stats))
    del xs, pairs, graphs
    rows.append(time_slstm_bwd(gen, reps, xlstm_counts))
    return rows


def time_slstm_bwd(gen: np.random.Generator, reps: int, counts: dict) -> dict:
    """The sLSTM backward at t9's rows, (2, 1024, 4, 4, 512) from zero state,
    beside its plain version on the card and its bound; no single PyTorch
    call computes it. The timed function is the wrapper: the kernel, r's
    transpose and the dr product. Its bound counts the recurrence's and dr's
    fp32 operations (2 x 2 x 4 x B x S x H x dh^2) and the bytes of r, the
    saved tensors, hs, dhs and the state in, and dwx, dr and the initial
    state's gradients out. The saving forward, the serving forward and the dr
    product alone are timed beside it (printed)."""
    cfg = get_config(XLSTM_ARCH)
    b, s, h, dh = XLSTM_TRAIN["batch"], XLSTM_TRAIN["seq"], cfg.n_heads, cfg.d_model // cfg.n_heads
    wx, r, state, (_, hs, saved), dhs, dfin = slstm_bwd_inputs(gen, b, s, h, dh, False, False)
    kernel = lambda: slstm_seq_bwd_cuda(r, state, hs, saved, dhs, dfin)  # noqa: E731
    plain = lambda: slstm_seq_bwd_ref(r, state, hs, saved, dhs, dfin)  # noqa: E731
    errs = [compare(f"slstm bwd fp32 {(b, s, 4, h, dh)} at t9's shape: {part}", g, w, "slstm_bwd")
            for part, g, w in zip(SLSTM_GRADS, slstm_grads(kernel()), slstm_grads(plain()))]
    ms, plain_ms = time_ms(kernel, reps, queued=True), time_ms(plain, reps, queued=True)
    work = cost.slstm_bwd(b, s, h, dh)
    bms, by = bound_ms(work.ops, work.bytes, work.dtype)
    fwd_save = time_ms(lambda: slstm_seq_cuda(wx, r, state, save=True), reps, queued=True)
    fwd = time_ms(lambda: slstm_seq_cuda(wx, r, state), reps, queued=True)
    dwx = kernel()[0]
    dr_ms = time_ms(lambda: slstm_dr(state["h"], hs, dwx), reps, queued=True)
    rec_bound = bound_ms(work.ops / 2, 0, torch.float32)[0]
    log(f"time slstm bwd fp32 {(b, s, 4, h, dh)}: kernel {ms:.5g} ms, plain {plain_ms:.5g} ms, library n/a, "
        f"bound {bms:.5g} ms ({by}), kernel at {bms / ms:.1%} of bound; the recurrence's ops alone bound "
        f"{rec_bound:.5g} ms; dr product alone {dr_ms:.5g} ms; forward at this shape: saving {fwd_save:.5g} ms, "
        f"serving {fwd:.5g} ms; a step: backward without dr {(ms - dr_ms) / s * 1e3:.3f} us, forward saving "
        f"{fwd_save / s * 1e3:.3f} us, serving {fwd / s * 1e3:.3f} us")
    return json_row("slstm_seq_bwd_cuda", counts, dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=bms,
                                                        bound_by=by, max_abs_err=max(errs)))


def run_training(seed: int, reps: int, smi: str) -> list:
    """The training path: t2, t4 and t6 at phi4's widths cut to 2 layers, t8
    at xlstm's width cut to 8 layers, t3 phi4-mini-3.8B in full, t5
    whisper-tiny in full, t7 recurrentgemma-9b cut to 3 layers, t9
    xlstm-1.3b in full, then t1's timings."""
    t0 = time.perf_counter()
    phase_train_step_vs_cpu(seed)
    phase_checkpoint_round_trip(seed)
    phase_fenced_routes(seed)
    log(f"t2, t4, t6 done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_xlstm_step_vs_cpu(seed)
    log(f"t8 done in {time.perf_counter() - t0:.1f} s")
    phi_counts = phase_train_phi4(seed, smi)
    whisper_counts = run_whisper_train(seed)
    rg_counts = run_rg_train(seed)
    t0 = time.perf_counter()
    xlstm_counts = run_xlstm_train(seed, smi)
    log(f"t9 done in {time.perf_counter() - t0:.1f} s")
    return phase_train_timing(reps, phi_counts, whisper_counts, rg_counts, xlstm_counts)


# ------------------------------------------------------------ sharded path
def shard_mesh():
    """The sharded path's (data 2, model 2) mesh, every position on the card."""
    return make_mesh_for(SHARD_POSITIONS, SHARD_MODEL, device=DEVICE)


def q_slabs(mesh, cfg, batch: int, seq: int) -> int:
    """Attention-core calls per attention layer under ``mesh``: the distinct
    (batch slab, head slab) of q (batch, heads, seq, head_dim)."""
    shape = (batch, cfg.n_heads, seq, cfg.head_dim)
    spec = DEFAULT_RULES.spec(mesh, ("batch", "heads", "seq", "head_dim"), shape, allow_uneven=True)
    return distinct_slabs(mesh, (spec, shape))


def projection_pairs(mesh, rows: int, k: int, n: int, w_logical) -> int:
    """The distinct (x slab, w slab) pairs of one sharded projection."""
    _, wg_spec, x_spec, _ = sharded_layouts(mesh, DEFAULT_RULES, rows, k, n, w_logical)
    return distinct_slabs(mesh, (x_spec, (rows, k)), (wg_spec, (k, n)))


def fused_launches(mesh, cfg, rows: int, backend: MatmulBackend) -> int:
    """strassen1 launches of one forward of ``rows`` tokens of a dense model
    whose projections run ``backend`` (kind strassen_fused) under ``mesh``:
    per layer, each projection that reaches depth >= 1 on its global shape
    launches once per distinct slab pair."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    projs = [(d, cfg.n_heads * hd, ("fsdp", "heads")), (d, cfg.n_kv_heads * hd, ("fsdp", "heads")),
             (d, cfg.n_kv_heads * hd, ("fsdp", "heads")), (cfg.n_heads * hd, d, ("heads", "fsdp")),
             (d, f, ("fsdp", "d_ff")), (f, d, ("d_ff", "fsdp"))]
    if cfg.glu:
        projs.append((d, f, ("fsdp", "d_ff")))
    per_layer = sum(projection_pairs(mesh, rows, k, n, wl) for k, n, wl in projs
                    if backend.effective_depth(rows, k, n) > 0)
    return cfg.n_layers * per_layer


def projection_traffic(mesh, m: int, k: int, n: int, w_logical, itemsize: int) -> dict:
    """The closed form of one sharded projection's collectives: (data - 1) x
    w's bytes all-gathered over data where w's FSDP dim is sharded, and 2
    (model - 1) x each data group's output bytes, summed over the groups,
    where the product is row-parallel."""
    w_spec, wg_spec, x_spec, _ = sharded_layouts(mesh, DEFAULT_RULES, m, k, n, w_logical)
    data, model = mesh.shape["data"], mesh.shape["model"]
    want = {}
    if w_spec != wg_spec:
        want[("all_gather", ("data",))] = (data - 1) * k * n * itemsize
    if wg_spec[0] is not None:
        rows = m if x_spec[0] is not None else m * data  # every group holds all rows
        want[("psum", ("model",))] = 2 * (model - 1) * rows * n * itemsize
    return want


def phase_sharded_projections(gen: np.random.Generator, reps: int, smi: str) -> None:
    """(s1) Sharded projections at phi4's shapes against the unsharded calls."""
    t0 = time.perf_counter()
    mesh = shard_mesh()
    log(f"s1 mesh {dict(mesh.shape)} on {sorted({str(d) for d in mesh.devices.flat})}, card {smi}")
    for site, m, k, n, wl in SHARD_PROJECTIONS:
        for dtype in (torch.float32, torch.bfloat16):
            x, w = randn(gen, (m, k), dtype), randn(gen, (k, n), dtype)
            for kind in SHARD_KINDS:
                be = MatmulBackend(kind=kind, depth=1, min_dim=1024)
                tag = f"s1 {site} ({m}x{k} @ {k}x{n}) {kind} {str(dtype)[6:]}"
                want = matmul(x, w, be)
                mesh.reset()
                reset_counts()
                with use_sharding(mesh):
                    got = matmul(x, w, be, w_logical=wl)
                torch.cuda.synchronize()
                launched = strassen1_matmul_cuda.launches
                if kind == "naive" or dtype == torch.float32:
                    compare(f"{tag} sharded vs unsharded", got, want, "mm")
                else:  # bf16 Strassen: each route against the fp32 product of the operands
                    exact = torch.matmul(x.float(), w.float())
                    e_sh, e_un = rel_err(got.float(), exact), rel_err(want.float(), exact)
                    far = (got.float() - want.float()).abs().max().item()
                    ok = (bool(torch.isfinite(got).all()) and e_sh <= MAIN_LIMIT[dtype]
                          and e_sh <= BF16_SPREAD * e_un)
                    log(f"check {tag} sharded vs fp32: rel_err {e_sh:.3e} (unsharded {e_un:.3e}; "
                        f"limit {MAIN_LIMIT[dtype]:.0e} and {BF16_SPREAD} x unsharded); max|sharded "
                        f"- unsharded| {far:.3e} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"{tag}: rel_err {e_sh:.3e} against fp32, unsharded {e_un:.3e}")
                expect = projection_pairs(mesh, m, k, n, wl) if kind == "strassen_fused" else 0
                traffic = {key: t.logical_bytes for key, t in mesh.traffic.items() if t.logical_bytes}
                closed = projection_traffic(mesh, m, k, n, wl, x.element_size())
                ok = launched == expect and traffic == closed and mesh.physical_bytes == 0
                log(f"{tag}: strassen1 launches {launched} (specs: {expect}); traffic "
                    f"{format_traffic(mesh)}; closed form {closed} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"{tag}: launches {launched} != {expect} or traffic {traffic} != {closed}")

                def sharded():
                    with use_sharding(mesh):
                        matmul(x, w, be, w_logical=wl)

                ms_sh, ms_plain = time_ms(sharded, reps), time_ms(lambda: matmul(x, w, be), reps)
                log(f"{tag} time on {smi}: sharded {ms_sh:.3f} ms (4 positions on one card, one "
                    f"after another) vs unsharded {ms_plain:.3f} ms")
            del x, w
    torch.cuda.empty_cache()
    log(f"s1 done in {time.perf_counter() - t0:.1f} s")


def phase_sharded_serve(cfg, params, prompts: list, unsharded: dict, reps: int, smi: str) -> None:
    """(s2) phi4 served through launch/serve.py's mesh path (its flags,
    ``launcher_mesh`` and ``place``), against phase (b)."""
    t0 = time.perf_counter()
    args = serve_mod.build_parser().parse_args(
        ["--mesh", "--positions", str(SHARD_POSITIONS), "--model-parallel", str(SHARD_MODEL)])
    mesh = launcher_mesh(args, torch.device(DEVICE))
    specs = place(params, mesh)
    log(f"s2 {cfg.name} on mesh {dict(mesh.shape)}: {len(specs)} parameter layouts, e.g. "
        f"layers.0.mixer.wq.w {specs['layers/0/mixer/wq/w'].spec}, card {smi}")
    mesh.reset()
    slabs = q_slabs(mesh, cfg, 1, 1024)  # a prefill is one request: batch 1
    with use_sharding(mesh):
        served = phase_serve(cfg, params, prompts, flash_slabs=slabs)
    traffic = format_traffic(mesh)
    log(f"s2 sharded serve: {served['tokens']} tokens in {served['wall']:.3f} s = "
        f"{served['tokens'] / served['wall']:.1f} tokens/s (unsharded (b): "
        f"{unsharded['tokens']} in {unsharded['wall']:.3f} s = "
        f"{unsharded['tokens'] / unsharded['wall']:.1f} tokens/s); peak {served['peak']:.2f} GiB "
        f"(unsharded {unsharded['peak']:.2f}); flash {slabs} launches per attention layer and "
        f"prefill; traffic {traffic}")
    for i in (0, 1):
        toks = served["handles"][i].tokens()
        _, gaps = forced_rollout(cfg, params, prompts[i], toks)
        ok = max(gaps) <= NEAR_TIE
        log(f"s2 sharded engine vs unsharded dense route, request {i} (prompt {len(prompts[i])}): "
            f"largest gap {max(gaps):.3f} rms limit={NEAR_TIE} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"s2 request {i}: gaps {[round(g, 3) for g in gaps]}")
    tokens = torch.as_tensor(prompts[5][None], device=DEVICE)  # 1024 tokens

    def prefill_sharded():
        with use_sharding(mesh):
            last_logits(params, cfg, tokens, False)

    ms_sh = time_ms(prefill_sharded, reps)
    ms_plain = time_ms(lambda: last_logits(params, cfg, tokens, False), reps)
    log(f"s2 prefill {tokens.shape[1]} tokens bf16 on {smi}: sharded {ms_sh:.3f} ms vs unsharded "
        f"{ms_plain:.3f} ms")
    log_split(f"s2 sharded prefill {tokens.shape[1]} tokens bf16", ms_sh, device_split(prefill_sharded))
    log_split(f"s2 unsharded prefill {tokens.shape[1]} tokens bf16", ms_plain,
              device_split(lambda: last_logits(params, cfg, tokens, False)))
    with use_sharding(mesh):
        log("s2 sharded decode step:")
        decode_step_numbers(cfg, params, prompts[4], SERVE)
    log("s2 unsharded decode step:")
    decode_step_numbers(cfg, params, prompts[4], SERVE)
    log(f"s2 done in {time.perf_counter() - t0:.1f} s")


def phase_sharded_strassen_prefill(cfg, params, gen: np.random.Generator) -> None:
    """(s3) A 1024-token prefill through strassen_fused under the mesh, held
    as phase (e) holds the unsharded one: against the naive prefill."""
    mesh = shard_mesh()
    tokens = torch.as_tensor(gen.integers(0, cfg.vocab, (1, 1024)), device=DEVICE)
    fused = dataclasses.replace(cfg, matmul_backend=SHARD_FUSED)
    naive = last_logits(params, cfg, tokens, False)
    want = last_logits(params, fused, tokens, False)
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with use_sharding(mesh):
        got = last_logits(params, fused, tokens, False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launched = strassen1_matmul_cuda.launches
    expect = fused_launches(mesh, cfg, 1024, SHARD_FUSED)
    err, base, apart = rel_norm(got, naive), rel_norm(want, naive), rel_norm(got, want)
    ok = (launched == expect and bool(torch.isfinite(got).all()) and err <= STRASSEN_LIMIT
          and err <= BF16_SPREAD * base)
    log(f"s3 sharded prefill 1024 tokens, strassen_fused depth=1: strassen1 launches {launched} "
        f"(specs: {expect}), rel_err vs naive {err:.3e} (unsharded fused {base:.3e}; limit "
        f"{STRASSEN_LIMIT:.0e} and {BF16_SPREAD} x unsharded), vs the unsharded fused prefill "
        f"{apart:.3e}, {secs * 1e3:.1f} ms; traffic {format_traffic(mesh)} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"s3 sharded strassen_fused prefill: {launched} launches (want {expect}), rel_err "
             f"{err:.3e} (unsharded {base:.3e})")


def phase_sharded_train_step(seed: int) -> None:
    """(s4) One fp32 train step at t2's widths under the mesh against the
    unsharded step; then accum 2 against accum 1, both under the mesh."""
    t0 = time.perf_counter()
    mesh = shard_mesh()
    cfg = cut_config()
    base = init_train_state(cfg, TRAIN_OPT, torch.Generator(device=DEVICE).manual_seed(seed))
    batch = SyntheticLM(cfg, DataConfig(SHARD_STEP["batch"], SHARD_STEP["seq"], seed), device=DEVICE)(0)
    p0 = {n: p.detach().clone() for n, p in base.params.named_parameters()}
    plain, sharded = state_to(base, DEVICE), state_to(base, DEVICE)
    ploss, pgrads = loss_and_grads(plain.params, batch, cfg)
    mesh.reset()
    reset_counts()
    with use_sharding(mesh):
        sloss, sgrads = loss_and_grads(sharded.params, batch, cfg)
    torch.cuda.synchronize()
    launched = (rmsnorm_bwd_cuda.launches, flash_attention_bwd_cuda.launches)
    expect = (2 * cfg.n_layers + 1, cfg.n_layers * q_slabs(mesh, cfg, SHARD_STEP["batch"], SHARD_STEP["seq"]))
    apply_updates(plain.params, pgrads, plain.opt, TRAIN_OPT)
    apply_updates(sharded.params, sgrads, sharded.opt, TRAIN_OPT)
    loss_rel = abs(sloss.item() - ploss.item()) / abs(ploss.item())
    g_rel, g_name = worst_rel(sgrads, {n: g.cpu() for n, g in pgrads.items()})
    d_sh = {n: p.detach() - p0[n] for n, p in sharded.params.named_parameters()}
    d_pl = {n: (p.detach() - p0[n]).cpu() for n, p in plain.params.named_parameters()}
    u_rel, u_name = worst_rel(d_sh, d_pl)
    ok = (loss_rel <= STEP_LIMITS["loss"] and g_rel <= STEP_LIMITS["grad"]
          and u_rel <= STEP_LIMITS["update"] and launched == expect)
    log(f"s4 train step fp32 under the mesh vs unsharded ({cfg.name} widths, {cfg.n_layers} layers, "
        f"vocab {cfg.vocab}, batch {SHARD_STEP['batch']} x {SHARD_STEP['seq']}): loss rel "
        f"{loss_rel:.2e} (limit {STEP_LIMITS['loss']:.0e}); worst gradient leaf {g_name} {g_rel:.2e} "
        f"(limit {STEP_LIMITS['grad']:.0e}); worst update leaf {u_name} {u_rel:.2e} (limit "
        f"{STEP_LIMITS['update']:.0e}); backward launches rmsnorm, flash {launched} (specs: "
        f"{expect}); traffic of the forward {format_traffic(mesh)} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"s4 sharded step: loss {loss_rel:.2e}, grad {g_rel:.2e} ({g_name}), update "
             f"{u_rel:.2e} ({u_name}), launches {launched} != {expect}")
    del plain, sharded, pgrads, sgrads, d_sh, d_pl
    updates = []
    for accum in (1, 2):
        _, _, step = train_mod.build(cfg, TRAIN_OPT, batch=SHARD_STEP["batch"], seq=SHARD_STEP["seq"],
                                     accum=accum, mesh=mesh, seed=seed, device=DEVICE)
        st = state_to(base, DEVICE)
        step(st, batch)
        updates.append({n: (p.detach() - p0[n]).cpu() for n, p in st.params.named_parameters()})
        del st
    u_rel, u_name = worst_rel(updates[1], updates[0])
    ok = u_rel <= STEP_LIMITS["update"]
    log(f"s4 accum 2 vs accum 1 under the mesh (launch/train.py build): worst update leaf {u_name} "
        f"{u_rel:.2e} (limit {STEP_LIMITS['update']:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"s4 accum 2 vs 1: update {u_rel:.2e} ({u_name})")
    del base, updates
    torch.cuda.empty_cache()
    log(f"s4 done in {time.perf_counter() - t0:.1f} s")


def phase_sharded_train_loop(seed: int, smi: str) -> None:
    """(s5) phi4 at full width, 4 layers, bf16, through train_loop with the
    mesh, beside the same loop without it."""
    t0 = time.perf_counter()
    mesh = shard_mesh()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=SHARD_TRAIN["n_layers"])
    run = {k: SHARD_TRAIN[k] for k in ("steps", "batch", "seq", "cycle")}
    # s5's gates are finite losses and grad norms and the launches: 3 steps
    # of a 4-layer cut from random weights need not lower the loss.
    _, plain, pstats, _, ppeak, _ = run_train_loop(
        cfg, TRAIN_OPT, run, seed, f"s5 unsharded {cfg.name} {cfg.n_layers} layers", falling=False)
    torch.cuda.empty_cache()
    mesh.reset()
    _, history, stats, counts, peak, _ = run_train_loop(
        cfg, TRAIN_OPT, run, seed, f"s5 sharded {cfg.name} {cfg.n_layers} layers", mesh=mesh,
        falling=False)
    log(f"s5 sharded losses against the unsharded loop's: largest relative difference "
        f"{max(abs(a - b) / abs(b) for a, b in zip(history, plain)):.2e}")
    steps = run["steps"]
    slabs = q_slabs(mesh, cfg, run["batch"], run["seq"])
    remat = 2 if cfg.remat else 1
    want = {"flash_attention_bwd_cuda": cfg.n_layers * slabs,
            "flash_attention_cuda": remat * cfg.n_layers * slabs,
            "rmsnorm_bwd_cuda": 2 * cfg.n_layers + 1}
    per_step = {k: counts[k] / steps for k in want}
    ok = per_step == want
    log(f"s5 launches per step {per_step} (specs: {want}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"s5 launches per step {per_step}, want {want}")
    per = {f"{op}{list(axes)}": t.logical_bytes / steps for (op, axes), t in sorted(mesh.traffic.items())
           if t.logical_bytes}
    log(f"s5 numbers on {smi}: median step sharded {stats['median_step_time_s'] * 1e3:.1f} ms vs "
        f"unsharded {pstats['median_step_time_s'] * 1e3:.1f} ms (host clock, train_loop's watchdog); "
        f"allocator peak sharded {peak:.2f} GiB vs unsharded {ppeak:.2f} GiB; logical bytes per "
        f"step (the forward's collectives) {per}; physical {mesh.physical_bytes}")
    torch.cuda.empty_cache()
    log(f"s5 done in {time.perf_counter() - t0:.1f} s")


def phase_sharded_moe(seed: int, smi: str) -> None:
    """(s6) olmoe-1b-7b at full width cut to 2 layers, a 1024-token prefill
    under the mesh with expert parallelism on and off."""
    t0 = time.perf_counter()
    mesh = shard_mesh()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=SHARD_MOE_LAYERS, moe_group_dispatch=True)
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    tokens = torch.as_tensor(np.random.default_rng([seed, 8]).integers(0, cfg.vocab, (1, 1024)),
                             device=DEVICE)
    want = last_logits(params, cfg, tokens, False)
    ms_plain = time_ms(lambda: last_logits(params, cfg, tokens, False), 3)
    for ep in (True, False):
        run_cfg = dataclasses.replace(cfg, moe_expert_parallel=ep)
        mesh.reset()
        moe_mod.RESHARD_BYTES.update(dispatch=0, combine=0)
        with use_sharding(mesh):
            got = last_logits(params, run_cfg, tokens, False)
        torch.cuda.synchronize()
        moved = dict(moe_mod.RESHARD_BYTES)
        traffic = format_traffic(mesh)

        def sharded():
            with use_sharding(mesh):
                last_logits(params, run_cfg, tokens, False)

        ms = time_ms(sharded, 3)
        err = rel_norm(got, want)
        ok = bool(torch.isfinite(got).all()) and err <= SHARD_LIMIT
        log(f"s6 {cfg.name} {cfg.n_layers} layers, prefill 1024 tokens bf16 under the mesh, "
            f"moe_expert_parallel={ep}: rel_err vs unsharded {err:.3e} limit="
            f"{SHARD_LIMIT:.0e}; dispatch reshard {moved['dispatch']} B, combine reshard "
            f"{moved['combine']} B (logical); traffic {traffic}; {ms:.3f} ms vs unsharded "
            f"{ms_plain:.3f} ms on {smi} {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"s6 moe_expert_parallel={ep}: rel_err {err:.3e}")
    del params
    torch.cuda.empty_cache()
    log(f"s6 done in {time.perf_counter() - t0:.1f} s")


def run_sharded_training(seed: int, smi: str) -> None:
    """s4-s6: the sharded train step, train loop and MoE prefill."""
    phase_sharded_train_step(seed)
    phase_sharded_train_loop(seed, smi)
    phase_sharded_moe(seed, smi)


# ------------------------------------------------------------- examples
def run_example(tag: str, module, argv: list) -> str:
    """One example's main(argv) on the card: its exit code must be 0 and it
    must not raise; returns what it printed (echoed to the log)."""
    out = io.StringIO()
    t = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
    except AssertionError as e:  # train_e2e's falling-loss check
        rc = f"AssertionError: {e}"
    for line in out.getvalue().splitlines():
        log(f"  {tag} | {line}")
    ok = rc == 0
    log(f"{tag} python -m {module.__name__} {' '.join(argv)}: exit {rc} in {time.perf_counter() - t:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{tag} {module.__name__} {argv}: exit {rc}")
    return out.getvalue()


def run_examples() -> None:
    """(ex1-ex4) The port's four examples, each once on the card through its
    main(): quickstart's four routes (each within 2e-2 of torch.matmul),
    strassen_distributed's three strategies (each within 1e-4 of
    max|torch.matmul|, with mesh.traffic's bytes), serve's requests
    (recurrentgemma's smoke config; every request ends by length or by its
    eviction, no page left in use), and train_e2e at its CI scale (its loss
    must fall)."""
    run_example("ex1", ex_quickstart, [])
    run_example("ex2", ex_distributed, [])
    out = run_example("ex3", ex_serve, [])
    reasons = [ln.split("reason=")[1].split()[0] for ln in out.splitlines() if ln.startswith("req ")]
    ok = len(reasons) == 5 and set(reasons) <= {"length", "evicted"} and "pool: 0 pages in use" in out
    log(f"ex3 requests ended by {reasons}, no page left in use {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"ex3 serve: requests ended by {reasons}")
    run_example("ex4", ex_train_e2e, ["--ci", "--steps", str(EXAMPLE_TRAIN_STEPS)])


# ------------------------------------------------------------- dry-run path
DRYRUN_CELL = ("whisper_tiny", "decode_32k", "single")  # the JAX dry-run integration test's cell
DRYRUN_SERVE = {"batch": 8, "prompt": 1024, "max_seq": 2048}  # d2: phi4-mini, no mesh
DRYRUN_MESH = {"n": 16384, "shape": (2, 2), "depth": 1}  # d3: strassen_2d, an m-phase strategy


def phase_dryrun_cell(smi: str) -> None:
    """(d1) The dry-run of the JAX integration test's cell on the 256-position
    production mesh of fake cuda:0 tensors: its trace seconds and H100 terms;
    per-position argument + temporary bytes under 4 GiB."""
    result = dryrun.run_cell(*DRYRUN_CELL)
    if result.get("skipped"):
        fail(f"d1 {DRYRUN_CELL}: skipped ({result['skipped']})")
        return
    dryrun.save_result(result)
    t, mem = result["roofline"], result["memory"]
    held = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    ok = (result["chips"] == 256 and t["compute_s"] > 0 and t["memory_s"] > 0
          and result["cost_analysis"]["flops_per_device"] > 0 and held < 4 * 2**30)
    log(f"d1 dry-run {' x '.join(DRYRUN_CELL)} on {result['chips']} positions (fake cuda:0), terms "
        f"against {HW.name} data-sheet peaks, card {smi}: traced in {result['trace_seconds']} s, "
        f"{result['cost_analysis']['aten_ops']} aten ops; compute {t['compute_s']:.3e} s, memory "
        f"{t['memory_s']:.3e} s, collective {t['collective_s']:.3e} s -> {t['bottleneck']}; per position "
        f"args {gib(mem['argument_size_in_bytes'])} + temps {gib(mem['temp_size_in_bytes'])} (< 4 GiB); "
        f"launches {result['launches']} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"d1 {DRYRUN_CELL}: chips {result['chips']}, terms {t}, held {held} B")


def _serve_work(cfg, params, cache, tokens, nxt) -> None:
    M.apply_prefill(params, {"tokens": tokens}, cache, cfg)
    M.apply_decode(params, nxt, cache, cfg)


def _leaf_bytes(*trees) -> int:
    return sum(nbytes(t) for tree in trees for t in named_leaves(tree).values())


def phase_dryrun_serve(seed: int, smi: str) -> None:
    """(d2) Predict one 1024-token prefill and one decode step of phi4-mini at
    batch 8 (no mesh) on fake tensors, then run the same work on the card:
    the analysis's launches by kernel equal the wrappers' counts, its
    argument bytes the real tensors' bytes, and the measured time (CUDA
    events, after a warm run) is at least the roofline bound. The predicted
    peak (arguments + temporaries) is printed beside the allocator's."""
    cfg = get_config(SERVE_ARCH)
    b, s, max_seq = DRYRUN_SERVE["batch"], DRYRUN_SERVE["prompt"], DRYRUN_SERVE["max_seq"]
    t = time.perf_counter()
    with fake_mode():
        params = to_device(M.init_params(cfg, torch.Generator().manual_seed(0)), "cuda:0")
        cache = M.init_cache(cfg, b, max_seq, device="cuda:0")
        tokens = torch.empty((b, s), dtype=torch.long, device="cuda:0")
        nxt = torch.empty((b, 1), dtype=torch.long, device="cuda:0")
    with OpAnalysis() as analysis:
        _serve_work(cfg, params, cache, tokens, nxt)
    costs = analysis.costs()
    predicted_args = _leaf_bytes(params, cache, tokens, nxt)
    terms = costs.roofline()
    trace_s = time.perf_counter() - t
    del params, cache, tokens, nxt

    gen = np.random.default_rng([seed, 10])
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    tokens = torch.from_numpy(gen.integers(0, cfg.vocab, (b, s))).to(DEVICE)
    nxt = torch.from_numpy(gen.integers(0, cfg.vocab, (b, 1))).to(DEVICE)
    cache = M.init_cache(cfg, b, max_seq, device=DEVICE)
    real_args = _leaf_bytes(params, cache, tokens, nxt)
    before = {fn.__name__: fn.launches for fn in ALL_KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _serve_work(cfg, params, cache, tokens, nxt)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in ALL_KERNELS
                if fn.launches != before[fn.__name__]}
    cache = M.init_cache(cfg, b, max_seq, device=DEVICE)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    _serve_work(cfg, params, cache, tokens, nxt)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    bound = terms["bound_s"] * 1e3
    ok = launched == costs.launches and predicted_args == real_args and ms >= bound
    log(f"d2 {cfg.name} prefill {b} x {s} + one decode step, no mesh, on {smi}: traced in {trace_s:.1f} s "
        f"({costs.ops} aten ops); launches predicted {costs.launches} vs run {launched}; argument bytes "
        f"predicted {predicted_args} vs real {real_args}; FLOPs {costs.flops_by_dtype}, HBM bytes "
        f"{costs.hbm_bytes:.4g}; terms compute {terms['compute_s'] * 1e3:.3f} ms, memory "
        f"{terms['memory_s'] * 1e3:.3f} ms -> bound {bound:.3f} ms ({terms['bottleneck']}); measured "
        f"{ms:.3f} ms ({bound / ms:.1%} of bound); peak predicted {gib(predicted_args + costs.temp_bytes)} "
        f"(args + temps) vs max_memory_allocated {gib(peak)} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"d2: launches {costs.launches} vs {launched}, args {predicted_args} vs {real_args}, "
             f"{ms:.3f} ms vs bound {bound:.3f} ms")
    del params, cache, tokens, nxt
    torch.cuda.empty_cache()


def phase_dryrun_mesh(seed: int, smi: str) -> None:
    """(d3) Trace strassen_2d at depth 1 on (2, 2) at N^2 fp32 on fake
    tensors, then run it on the card: the analysis's collective operand
    bytes, converted to logical bytes by the ring rule (op_analysis), equal
    the real run's mesh.traffic by kind, and its per-position dot FLOPs the
    closed form 7 N^3 / 16 (the 7 leaf products of (N/4, N/2) by (N/2, N/4))
    + 14 N^2 (the two divide sums over the position's (7, N/4, N/2) slab) +
    3.5 N^2 (the combine sum over its (N/2)^2 quadrant)."""
    n, shape, depth = DRYRUN_MESH["n"], DRYRUN_MESH["shape"], DRYRUN_MESH["depth"]
    t = time.perf_counter()
    fmesh = make_mesh(shape, ("data", "model"), device="cuda:0")
    with fake_mode():
        fa = torch.empty((n, n), device="cuda:0")
        fb = torch.empty((n, n), device="cuda:0")
    with OpAnalysis(chips=fmesh.size) as analysis:
        distributed.strassen_2d(fa, fb, mesh=fmesh, depth=depth)
    costs = analysis.costs()
    trace_s = time.perf_counter() - t
    gen = np.random.default_rng([seed, 11])
    a, b = randn(gen, (n, n), torch.float32), randn(gen, (n, n), torch.float32)
    mesh = make_mesh(shape, ("data", "model"), device=DEVICE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = distributed.strassen_2d(a, b, mesh=mesh, depth=depth)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    err = rel_err(out, torch.matmul(a, b))
    real: dict = {}
    for (op, _axes), tr in mesh.traffic.items():
        if tr.logical_bytes:
            real[op] = real.get(op, 0) + tr.logical_bytes
    closed = 7 * n**3 / 16 + 14 * n**2 + 3.5 * n**2
    pinned = sum(costs.pinned["flops_by_dtype"].values())
    terms = costs.roofline()
    ok = costs.collective_logical == real and pinned == closed == costs.dot_flops and err <= MAIN_LIMIT[torch.float32]
    log(f"d3 strassen_2d depth {depth} on {shape} at {n}^2 fp32, card {smi}: traced in {trace_s:.1f} s; "
        f"logical collective bytes predicted {costs.collective_logical} vs mesh.traffic {real}; per-position "
        f"operand bytes {costs.collective_by_kind}; dot FLOPs per position {pinned:.6g} vs closed form "
        f"{closed:.6g}; terms compute {terms['compute_s'] * 1e3:.3f} ms, memory {terms['memory_s'] * 1e3:.3f} "
        f"ms, collective {terms['collective_s'] * 1e3:.3f} ms -> {terms['bottleneck']}; the real run "
        f"{secs:.2f} s (host clock, 4 positions on one card), rel_err {err:.2e} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"d3: logical {costs.collective_logical} vs {real}, flops {pinned} vs {closed}, rel_err {err:.2e}")
    del a, b, out
    torch.cuda.empty_cache()


def run_dryrun(seed: int, smi: str) -> None:
    phase_dryrun_cell(smi)
    phase_dryrun_serve(seed, smi)
    phase_dryrun_mesh(seed, smi)


def report_failures() -> int:
    print(f"chip_smoke: {len(FAILURES)} failure(s):", file=sys.stderr)
    for f in FAILURES:
        print(f"  {f}", file=sys.stderr)
    return 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--size", type=int, default=16384, help="N of the N x N main-path operands")
    parser.add_argument("--reps", type=int, default=5, help="timed calls per median")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.size % 16:
        parser.error("--size must be a multiple of 16")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    phase_build()
    gen = np.random.default_rng(args.seed)
    phase_kernels(gen)
    serve_gen = np.random.default_rng([args.seed, 2])  # the serving path's own stream
    cfg = get_config(SERVE_ARCH)
    phase_serving_kernels(serve_gen, cfg)
    xlstm_gen = np.random.default_rng([args.seed, 3])  # the xLSTM path's own stream
    phase_xlstm_kernels(xlstm_gen, get_config(XLSTM_ARCH))
    moe_gen = np.random.default_rng([args.seed, 4])  # the MoE path's own stream
    phase_model_kernels(moe_gen, get_config(MOE_ARCH), (1000, 2048))
    rg_gen = np.random.default_rng([args.seed, 5])  # the RG-LRU path's own stream
    rg_cfg = get_config(RG_ARCH)
    phase_model_kernels(rg_gen, rg_cfg, RG_FLASH_LENS, rg_cfg.local_window)
    whisper_gen = np.random.default_rng([args.seed, 6])  # the whisper path's own stream
    phase_whisper_kernels(whisper_gen, get_config(WHISPER_ARCH))
    phase_train_kernels(np.random.default_rng([args.seed, 7]))  # the training path's own stream
    phase_level_kernels(np.random.default_rng([args.seed, 12]))  # the level kernels' own stream
    if FAILURES:  # no point driving the main path through a wrong kernel
        return report_failures()

    n = args.size
    t = time.perf_counter()
    a = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32)).to(DEVICE)
    b = torch.from_numpy(gen.standard_normal((n, n), dtype=np.float32)).to(DEVICE)
    a16, b16 = a.bfloat16(), b.bfloat16()
    ref32 = torch.matmul(a, b)
    ref16 = torch.matmul(a16.float(), b16.float())
    torch.cuda.synchronize()
    log(f"operands {n}x{n} from seed {args.seed}: {time.perf_counter() - t:.1f} s")

    runs = main_path_runs(a, b, a16, b16)
    refs = {torch.float32: ref32, torch.bfloat16: ref16}
    counts = phase_main_path(runs, refs)
    phase_end_to_end(runs, args.reps)
    del runs
    entries = phase_timing(a, b, args.reps, counts)
    phase_breakdown(a, b, args.reps)
    calib = phase_auto(a, b, a16, b16, refs)
    torch.cuda.empty_cache()
    log(f"Strassen path done at {time.perf_counter() - t0:.1f} s")

    launches = phase_mesh(mesh_runs(a, b, a16, b16), refs, args.reps)
    entries += phase_mesh_stripes(a, b, args.reps, launches)
    phase_mesh_auto(a, b, ref32, calib)
    del a, b, a16, b16, ref32, ref16, refs
    torch.cuda.empty_cache()
    phase_sharded_projections(np.random.default_rng([args.seed, 9]), args.reps, smi)
    torch.cuda.empty_cache()
    log(f"mesh path done at {time.perf_counter() - t0:.1f} s")

    phase_oot(args.seed, args.reps)
    phase_oot_oom(args.seed)
    phase_spin(args.seed)
    phase_oot_auto(args.seed)
    torch.cuda.empty_cache()
    log(f"out-of-core path done at {time.perf_counter() - t0:.1f} s")

    t = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(args.seed))
    torch.cuda.synchronize()
    log(f"{cfg.name}: {sum(p.numel() for p in params.parameters()) / 1e9:.3f} B parameters "
        f"({cfg.dtype}, {cfg.n_layers} layers, d_model {cfg.d_model}) from seed {args.seed} "
        f"in {time.perf_counter() - t:.1f} s")
    prompts = make_prompts(serve_gen, cfg.vocab)
    served = phase_serve(cfg, params, prompts)
    phase_engine_vs_model(cfg, params, prompts, served["handles"], args.seed)
    phase_prefill_vs_decode(cfg, params, serve_gen)
    phase_strassen_prefill(cfg, params, serve_gen)
    phase_auto_serve(cfg, params, prompts)
    phase_serving_numbers(cfg, params, prompts, args.reps)
    phase_fp8_cache(cfg, params, prompts, served["handles"])
    phase_sharded_serve(cfg, params, prompts, served, args.reps, smi)
    phase_sharded_strassen_prefill(cfg, params, serve_gen)
    entries += phase_serving_timing(cfg, args.reps, served["counts"])
    del params, served
    torch.cuda.empty_cache()
    log(f"{cfg.name} path done at {time.perf_counter() - t0:.1f} s")

    entries += run_xlstm(args.seed, args.reps, xlstm_gen)
    log(f"{XLSTM_ARCH} path done at {time.perf_counter() - t0:.1f} s")
    entries += run_moe(args.seed, args.reps, moe_gen)
    log(f"MoE path done at {time.perf_counter() - t0:.1f} s")
    entries += run_rglru(args.seed, args.reps, rg_gen)
    log(f"RG-LRU path done at {time.perf_counter() - t0:.1f} s")
    entries += run_whisper(args.seed, args.reps)
    log(f"whisper path done at {time.perf_counter() - t0:.1f} s")
    entries += run_training(args.seed, args.reps, smi)
    log(f"training path done at {time.perf_counter() - t0:.1f} s")
    run_sharded_training(args.seed, smi)
    log(f"sharded training path done at {time.perf_counter() - t0:.1f} s")
    run_examples()
    log(f"examples done at {time.perf_counter() - t0:.1f} s")
    run_dryrun(args.seed, smi)
    log(f"dry-run path done at {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t0:.1f} s")

    if FAILURES:
        return report_failures()
    print(smi)
    print(json.dumps({"kernels": entries}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
