#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deepspeed_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero
before its last line. Phases 2-6 end with their kernels at head dims 80
and 96 (the 128-wide instantiation at a smaller true head dim): B1-B3 at
gpt2-2.7b's [8, 1024, 32, 80] and gpt2-760m's [8, 1024, 16, 96] (plus B1
through the padded route at D=36 beside the native route at 40), B4-B7
and B5i-B7i at Pythia-2.8B's serving geometry (32 kv heads of 80) and
GPT-NeoX-20B's (64 of 96), B8 at [2, 4096, 32, 80] and [2, 4096, 16, 96];
and every attention kernel at head dim 256 (the 256-wide instantiation):
B1 at GPT-J-6B's [8, 1024, 16, 256], B4-B7 and B5i-B7i at its serving
geometry (16 kv heads of 256), B2 and B3 at [8, 1024, 8, 256] (gpt2-1.3b
with 8 heads of 256), B8 at [2, 4096, 8, 256]; each against its plain version on every
head, bit-identical on a second call, on inputs that are ``[..., :D]``
views of buffers whose guard columns hold NaN (B8 also writes into one,
whose guard columns must stay NaN); their times, bounds (true D) and
SDPA times are the ``d80_*`` / ``d96_*`` / ``d256_*`` fields of each
kernel's row.

1. build  — compile every CUDA kernel from ``deepspeed_tpu_torch/ops/csrc``
   (one nvcc per source, in parallel): flash forward, flash backward (dq,
   dk/dv), dense decode, paged decode/verify, paged chunk, block-sparse
   attention and LayerNorm (forward, backward). Prints each ptxas register
   and spill line with its kernel's name, and fails if ptxas ignored the
   flash forward's or backward's or B8's setmaxnreg (C7508) or a 16-bit
   entry of the flash backward, of B1's 256-wide kernel, of B9's
   persistent kernel, of B5/B5i's split kernel, of the B6/B6i and B7/B7i
   tensor-core kernels, of B4's kernel or of B8's two kernels spills, or
   any entry of B10's kernels.
2. flash  — the flash-attention kernel against its plain PyTorch version in
   bf16 at GPT-2 XL prefill shapes (B=8, T in {128, 1024}, H=25, D=64), a
   GQA case (H=32, KH=8, D=128), a ragged T, a full (non-causal) case and
   the GPT-2 1.3B training shape (B=8, T=1024, H=16, D=128, q/k/v views of
   one fused projection; its ms, bound and SDPA time are extra fields of
   the kernel's row); then the wrapper's host time per call at B=1, T=128.
3. decode — the decode-attention kernel (B4) against its plain version at
   B=8, S=1024, H=25, D=64 with seeded lengths in [1, 1024], a GQA case
   (H=32, KH=8, D=128: its time, bound and SDPA time are the ``gqa_*``
   fields of the row), R=3 and R=7 (28 heads over 4, Qwen2-7B's layout),
   each bit-identical on a second call, and a length-0 row; then the
   wrapper's host time per call (``host_us``, median of 2000 calls, each
   after a sync).
4. paged  — the paged decode (S=8 slots, BS=128, MB=8, NB=65), chunk (C=256
   at start 0, 256, 512) and verify (K=4) kernels against their plain
   versions in bf16 at GPT-2 XL shapes and in a GQA case, over shuffled,
   non-contiguous block tables that share prefix blocks between slots and
   point dead entries at the null block. Then their int8 variants (B5i,
   B6i, B7i) at the same shapes over int8 pools quantized per (position,
   head) row from seeded K/V (scales vary per row), with bf16, fp16 and
   f32 queries and a slot of length 0. B5, B5i, B6, B6i, B7 and B7i must
   give the same bits on a second call; each row carries its GQA case's
   time, bound and library time (``gqa_*``), and B5's, B6's and B7's the
   wrapper's host time per call (``host_us``: decode and verify K=4 at
   S=8, a C=256 chunk at start 256).
5. flash_bwd — the flash backward kernels (B2 dq, B3 dk/dv) against their
   plain PyTorch versions: bf16 at the GPT-2 1.3B training shape (B=8,
   T=1024, H=16, D=128, causal, q/k/v as strided views of one fused
   projection), at GPT-2 XL shape (H=25, D=64), a GQA case (H=32, KH=8,
   D=128), a ragged T (1000), a non-causal case, fp16 and fp32. A second
   run of both on the training case must give the same bits; then the
   wrappers' host time per call of the pair at B=1, T=128; the build
   fails on a spill in any 16-bit entry, B3's 256-wide role split
   (`bwd_dkv_split_kernel`) included.
6. sparse — the block-sparse kernel (B8) against its plain version: (i) the
   GPT-2 1.3B attention geometry (B=2, T=4096, 16 heads of 128, bf16,
   Fixed layout of blocks of 64, causal, q/k/v strided views of one fused
   projection), (ii) BigBird at the same shape, (iii) GPT-2 XL heads (25
   of 64) with BSLongformer blocks of 128, (iv) blocks 16 and 32
   (Variable, LocalSlidingWindow), (v) a per-head Fixed layout, (vi) rows
   that see no key (exactly 0), (vii) fp16 and fp32, each with the tile
   order ``SparseSelfAttention`` caches. Each within atol of the plain
   version and within 1e-2 (f32: 1e-4) relative L2 over every tile of 64
   rows; case (i) bit-identical on a second call, and its row carries the
   wrapper's host time per call (``host_us``).
7. layer_norm — the LayerNorm kernels (B9 forward, B10 backward) against
   their plain versions at the GPT-2 1.3B training shape (x [8, 1024,
   2048] bf16, f32 weights), GPT-2 XL width, a ragged R, fp16, fp32 and
   rows of 10001 elements (wider than 8192, no whole 16-byte chunks: B10's
   wide kernel; its time is the ``wide_*`` fields of B10's row); B9 and
   B10 twice on the same inputs must give the same bits; B10 is timed
   beside ``native_layer_norm_backward`` in every case.
8. e2e    — ``deepspeed_tpu_torch.init_inference`` → ``generate`` at GPT-2 XL
   width (48 layers, n_embd 1600, 25 heads, bf16, random weights from a
   seed) on 8 seeded prompts of 64-900 tokens, 32 new tokens, greedy,
   its decode step a replayed CUDA graph; then the same ``generate`` with
   the graph off (the eager control), which must give the same tokens
   (both walls printed), the host enqueue and device time of one step
   eager and replayed, and decode == prefill: the graph's decode-path
   logits against ``causal_forward`` logits taken with the flash kernel's
   plain version.
9. serve  — ``ContinuousBatchingServer`` over one engine of the same weights,
   three servers in turn: (a) the default config (monolithic prefill,
   async loop, lag 1) on 16 requests submitted 8, 4 steps, 8 more; (b)
   prefix caching with 256-token chunks on 8 requests sharing a 512-token
   prefix and 4 cold ones; (c) prompt-lookup speculation, K=4, on prompts
   that repeat a 24-token phrase; (d) an int8 pool with prefix caching,
   256-token chunks and the host tier under pool pressure (4 slots of 8
   blocks; five 768-token prefixes with short tails through two rounds),
   which must demote and swap in with no eviction or preemption, and serve
   the same tokens as a control server whose pool never demotes; (e) an
   int8 pool with speculation K=4 on (c)'s prompts. Each asserts its launch
   counts (48 per prefill, chunk, decode or verify program; no dense
   decode launch; no fp paged launch over an int8 pool), and a
   tie-tolerant oracle on two requests: every served token is within
   E2E_MAX_TOL (int8 pools: INT8_E2E_MAX_TOL) of the maximum logit of a
   forward through no attention kernel. Every server runs its decode or
   verify step as a CUDA graph, which must have replayed; (a), (c) and (d)
   are each run again with the graphs off (the eager control) and must
   serve the same tokens. One paged decode step at S=8 is timed eager and
   replayed (host enqueue, device time). The observability plane: (a) runs
   with every piece armed (request tracing at rate 1, an SLO with load
   shedding on a loose queue-wait objective and one tight decode objective
   that must fire, the canary, incident bundles, the HTTP endpoint on an
   ephemeral port of 127.0.0.1, a profiler capture of 4 decode steps) and
   its eager control with it; every route of the endpoint answers 200 with
   JSON or Prometheus text that parses, each request's trace covers queue
   wait, admission, prefill and decode, the requests' ``request_cost``
   and the canary probes' excluded records sum to the step profiler's
   device-attributed total (within OBSERVE_COST_TOL), the profiler's
   phases sum to its wall, the tight objective fired once and left one
   incident bundle holding ring events, the canary scored only successes,
   and the capture's Chrome trace names ``paged_split_kernel``. Then (a)'s
   requests once more with ``step_profile`` and accounting off: the same
   tokens and one decode graph (the plane's cost on the clock is
   ``scripts/observe_cost.py``'s). (d) runs with the default plane plus
   tracing and logs ``serve_kv_swap_seconds`` (the demotions of its first
   round alone, then both directions) with GB/s, and the step profiler's
   ``serve_step_phase_seconds`` for its chunk steps.
9a. spec — speculative decoding and beam search over phase e2e's weights,
   with a GPT-2 (124M) draft at its published widths and depth (HF
   openai-community/gpt2 config.json: 12 layers, 768 wide, 12 heads of
   64, tied head; random weights from a seed, 124,439,808 parameters):
   ``generate_speculative`` on phase e2e's 8 prompts, 32 new tokens, K=4,
   with the 124M draft, with a second engine over the target's own
   weights and with the target as its own draft (full acceptance: >= 3.5
   tokens a round; the target keeps a second cache for the draft role)
   and by prompt lookup
   on prompts that repeat a 24-token phrase, each equal to greedy
   ``generate`` up to near-ties (where the two part, both tokens'
   logits within SPEC_TIE_TOL of each other, and every speculative token
   within it of the maximum, in a forward through no attention kernel),
   its verify chunk and draft decode steps replayed graphs, launching B1
   and B4 and no paged kernel; sampled speculation
   at temperature 1.0 (well formed) and 1e-6 (greedy, ties excepted);
   ``generate(num_beams=4)`` on 2 prompts, graphed and eager, token for
   token (the beam step's ms printed); then servers with a draft engine
   (the 124M draft; the target's weights, >= 3 tokens per forward) on 16
   requests of 64-700 tokens, K=4: one capture of each graph (verify and
   draft decode), B5 on the draft pool and B7, the served-token oracle
   within SPEC_TIE_TOL, and for the 124M draft an eager control; and the same requests without
   speculation. The ms per committed token, tokens per round, the beam
   step's ms and the servers' tokens/s are printed with the card's name
   and power limit.
9a'. int8 — phase e2e's GPT-2 XL weights served from int8 storage:
   weight bytes (``tree_weight_bytes``, ``memory_allocated``) in bf16,
   row-group int8 (``dtype="int8"``) and per-output-channel int8 (w8a8);
   ``generate`` on phase e2e's 8 prompts, 32 new tokens, graphed, for
   bf16, int8 and w8a8 (B1, B4), decode ms per step of each; the int8
   tokens must equal a bf16 engine's over the dequantized weights (the
   same products on the same values) and its eager control's; w8a8:
   ``_int_mm`` (rows padded to 17) exact against the integer product at
   one layer's q/k/v, attention-out and MLP shapes at M = 8 (eager and
   replayed from a graph) and at the prefill's M = 8192, every int8 GEMM
   weight stored column-major, its first-step logits within W8A8_LOGIT_L2
   of the dequantized path over the same weights; greedy agreement with
   bf16 logged; phase serve's default server (16 requests, 32 new tokens)
   over each engine with its launch counts and the served-token oracle,
   tokens/s printed; an int8 serving checkpoint saved, reloaded (the int8
   leaves as stored) and serving the same tokens, its bytes and seconds
   printed, all with the card's name and power limit.
9b. pythia — Pythia-2.8B at its published widths and depth (HF
   EleutherAI/pythia-2.8b config.json: 32 layers, 32 heads of 80, parallel
   residual, rotary_pct 0.25, exact GELU, untied head; random weights,
   2,775,208,960 parameters): phase e2e's ``generate`` and gates (B1, B4),
   then four servers over one engine: prefix caching with 256-token chunks
   (B6, B5) and speculation K=4 (B1, B7), over an fp and an int8 pool
   (B6i, B5i, B7i), each with its launch counts and the served-token
   oracle.
9c. gptj — GPT-J-6B at its published widths and depth (HF
   EleutherAI/gpt-j-6b config.json: 28 layers, 4096 wide, 16 heads of
   256, rotary_dim 64 interleaved, attention and MLP in parallel behind
   one shared LayerNorm, gelu_new, an untied head with a bias; random
   weights, 6,050,882,784 parameters): phase pythia's ``generate`` and
   four servers, every serving kernel on its 256-wide instantiation.
9d. hf — an HF checkpoint of the Mistral-7B-v0.2 layout (HF
   mistralai/Mistral-7B-v0.2 config.json: 32 layers, 4096 wide, 32 heads
   of 128 over 8 KV heads, FFN 14336, vocab 32000, rope_theta 1e6, no
   sliding window, untied head; the repo's llama-7b-gqa widths; random
   weights from a seed, 7,241,732,096 parameters) served through the
   policy table: (a) its HF-named bf16 state dict made on the card, in a
   ``CheckpointModelView`` with its config, converted by
   ``init_inference(view)`` (``LlamaPolicy``, on the card; the config
   and every leaf's shape gated), the state dict freed, then phase
   pythia's ``generate`` (over 2048 tokens) and its fp-pool servers
   (prefix caching with 256-token chunks: B6, B5; prompt lookup: B7);
   (b) the layout cut to 2 layers for time, written by the port's writers
   as sharded safetensors (>= 2 shards and an index) and as
   ``pytorch_model.bin`` under a temporary dir of ``build/`` (removed at
   the end): ``init_inference(path)`` gives the in-memory tree bit for
   bit and its 8 x 16 greedy tokens; the load seconds and GB/s printed
   with the card's name and power limit.
9e. llama_bert — the training LLaMA and BERT (``models/llama.py``,
   ``models/bert.py`` on ``ops/transformer.py``), bf16, phase train's
   engine: (a) ``llama-1b`` (JAX's preset: 16 layers, 2048 wide, 16 heads
   of 128, FFN 5504, vocab 32000, untied; 940,640,256 parameters) at full
   width and depth, micro 4 x gas 2 x T 2048, remat: the first loss
   against the same weights through no attention kernel, a warm-up step,
   TRAIN_STEPS timed steps on a repeated batch (B1 2 x 16 x micro-batches,
   B2 and B3 16 x micro-batches, finite, falling), the q/k/v gradient
   oracle of every layer on one sequence; then the trained weights
   through ``convert_trained_model`` into ``init_inference``: phase e2e's
   ``generate`` and gates over 2048 tokens (B1, B4) and the served-token
   oracle. (b) ``llama-7b-gqa`` at full width (32 heads of 128 over 8 KV
   heads, FFN 14336: Mistral-7B's geometry) and 8 of its 32 layers
   (2,007,044,096 parameters), micro 2 x gas 1 x T 4096: the same gates,
   B3 summing 4 query heads into each KV head. (c) ``bert-large`` (24
   layers, 1024 wide, 16 heads of 64, FFN 4096, NSP; 336,226,108
   parameters; dropout ratios 0) at full width and depth, micro 16 x gas
   2 x T 512: unmasked batches launch B1, B2 and B3 non-causal (24 each a
   micro-batch), the first loss against the einsum route (a key mask of
   ones); then one step with a key padding mask, which takes the einsum
   route and launches none of them. Step ms, tokens/s, MFU and peak
   memory printed with the card's name and power limit.
10. train — with the serving weights freed: ``deepspeed_tpu_torch.initialize``
   → ``train_batch`` on ``GPT2LMModel(config_for("gpt2-1.3b"))`` at full
   width (24 layers, n_embd 2048, 16 heads of 128, T=1024; random weights
   from a seeded generator), bf16, AdamW (lr 1e-4, weight decay 0.01),
   gradient clipping 1.0, micro-batch 8, 2 accumulation steps, remat on;
   the first step's loss against the same weights' through the flash
   kernel's plain version, one warm-up step, then TRAIN_STEPS timed steps
   on one repeated batch. It asserts the launch counts (forward 24 x 2 (remat) x 2 x steps, dq and
   dk/dv 24 x 2 x steps, no decode kernel), finite losses and gradient
   norms, a falling loss, and an in-situ gradient oracle: one micro-batch of
   2 sequences through the kernels and through the flash kernels' plain
   version under autograd, the losses within TRAIN_LOSS_TOL and every
   layer's ``c_attn.kernel`` gradient within TRAIN_GRAD_TOL relative L2.
   The same for ``gpt2-760m`` (16 heads of 96) and ``gpt2-2.7b`` (32
   heads of 80) at full width and 8 of their 24 and 32 layers, and for
   ``gpt2-1.3b`` with ``n_head=8`` (8 heads of 256: B1-B3 on their
   256-wide instantiations) at full depth.
10a. int8 train — ``gpt2-1.3b`` at full width and depth with
   ``int8_training=True`` (SwitchBack: the four projections of every
   block and the logits run int8 forward and dx GEMMs) beside bf16, from
   the same weights on the same INT8_TRAIN_STEPS + 1 seeded batches,
   phase train's configuration: ``_int_mm`` exact at the forward, dx and
   logits shapes in SwitchBack's layouts, the launch counts of both runs,
   finite int8 losses within INT8_TRAIN_MARGIN of bf16's and not equal to
   them, and both runs' ms per step.
10b. checkpoint — the training engine's checkpoints and the bridge to
   serving, under a temporary directory of the checkout's ``build/``
   (removed at the end; the free space is printed first). The resume
   oracle at ``gpt2-1.3b``'s full width and 2 of its 24 layers
   (CKPT_LAYERS, a cut for the time limit) with phase train's
   configuration: run A takes 4 steps on 4 seeded batches; run B starts
   from the same weights, takes steps 1-2, saves (sync, verified) and is
   destroyed; run C starts from other weights, loads and takes steps 3-4. C's losses and every master leaf must equal A's bit
   for bit, ``global_steps`` be 4, and every run launch B1-B3 as phase
   train counts them; it prints the tag's bytes and the save (state
   write, manifest hash), verify and load seconds with their GB/s. Then
   C's params go through ``gpt2_to_inference`` into ``init_inference``
   (bf16): ``generate`` of 8 seeded prompts x 32 greedy tokens through B1
   and B4, the served-token oracle, a serving checkpoint saved and loaded
   into a fresh engine that must serve the same tokens and the same
   prefill logits bit for bit (its bytes and seconds printed). Last the
   async engine at gpt2-1.3b's width and 2 layers: a save at step 2,
   steps 3-4 while the write may run, ``destroy`` joins, and a fresh
   engine loads the step-2 state bit for bit.
10c. offload — ZeRO-Offload. (i) ``llama-7b-gqa`` at full width and 20
   of its 32 layers (4,624,388,096 parameters), bf16, AdamW, ``stage 1,
   offload_optimizer: {device: cpu, implementation: host}``, micro 2 x
   gas 1 x T 4096, remat, two steps: the port's
   ``estimate_zero_model_states_mem_needs`` puts the in-HBM state above
   the card's memory; each step's time split into device (forward and
   backward), D2H, host Adam and H2D, the device peak and the host RSS
   peak; finite losses; the first step's host master of layer 0's ``wq``
   and of the embedding against ``ops/adam.py`` applied to the same
   gradient (OFFLOAD_ADAM_TOL of the update); every bf16 param on the card
   equal to the RNE cast of its host master; B1-B3 counted (B3 at R = 4).
   (ii) ``gpt2-1.3b`` at its width and 2 layers, phase train's
   configuration, four engines from the same weights over the same 3
   batches: (a) in-HBM, (b) ``offload_optimizer`` host, (c) ``stream``,
   (d) stage 3 with ``offload_param`` (the model fetching its layers) and
   the host optimizer. (c) equals (a) bit for bit; (b) is within
   TRAIN_LOSS_TOL of (a)'s losses and OFFLOAD_UPDATE_TOL relative L2 of
   each leaf's update; (d) equals (b) bit for bit with a lower device
   peak and its params in pinned host memory between steps; (b) saved at
   step 2 (unhashed: phase checkpoint gates the manifest) and resumed from
   other weights gives step 3's loss and host master bit for bit.
10d. dist — ZeRO over ``torch.distributed``: ``gpt2-1.3b`` at its width
   and 4 layers, phase train's configuration, 3 steps, (a) on the
   single-process engine; then NCCL in this process at world size 1 (the
   card box has one card; a ``FileStore`` under ``build/``), (b) stage 3
   with GPT-2's per-layer gather (an all-gather of each layer's blocks,
   whose backward reduce-scatters the gradient) and (c) stage 2, from the
   same weights: both equal (a) bit for bit (losses, whole master and
   params; every collective is an identity at one rank), the comms logger
   counts all-gathers and reduce-scatters, B1-B3 launch through them; the
   step ms of each, the median of 5 after a warm-up step (the collective
   path's cost at one rank), then ``benchmarks_comm.run_sweep`` at 1 and
   64 MB, world size 1, with nothing else running. Last (d) two ranks
   spawned after them on the one card over gloo (CUDA tensors; NCCL
   refuses two ranks on a device) at 2 layers, stage 3 with the
   per-layer gather, 2 steps, against one rank on all their rows: losses
   within 1e-2 relative and each leaf's update within 0.1 relative L2
   (the CPU parity test's bf16 tolerances).
11. sparse run — ``SparseSelfAttention`` with layout (i), three calls at
   T=4096 and one at T=2048: 4 kernel launches, one LUT per length, every
   output within SPARSE_TOL of the plain version; then the same at 32
   heads of 80 and at 8 heads of 256.
12. layer_norm run — ``fused_layer_norm`` and ``fused_residual_layer_norm``
   under autograd at the 1.3B training shape: 2 forward and 2 backward
   launches; the gradients against autograd through
   ``layer_norm_reference``.

Each graphed path logs its captures, replays, capture seconds and the
memory of the graph's pool, and must have replayed at least once. A
replay adds the launches its capture recorded to each wrapper's count, so
the launch counts stay counts of kernel executions.

The kernel launch counts are set to 0 just before each main-path run (the
e2e generate, each server, phase hf's ``generate`` calls, phase
llama_bert's timed steps, ``generate`` and masked step, phase int8's
``generate`` calls, servers and training runs, the timed training steps,
the checkpoint
phase's training runs and its ``generate``, phase offload's and phase
dist's training runs, and the sparse and layer_norm runs) and read just after. Every attention kernel, int8 ones
included, must have launched on a main-path run at head dim 80, 96 or
256, every serving kernel (B1, B4-B7, B5i-B7i) at 256 on the gptj path,
and B1-B3 and B8 at 256 on the train gpt2-1.3b 8x256 or sparse 8 x 256
path. Kernel times are device times (CUDA events behind a device spin,
after an L2 flush).

It prints the wall of every phase, the card's name and power limit
(nvidia-smi), one JSON line of per-kernel numbers, and, last, ``{"ok":
true, "device": {...}}``. It exits
non-zero with no result when no CUDA device is present.
"""
from __future__ import annotations

import dataclasses
import datetime
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12     # dense tensor-core peak (NVIDIA data sheet)
H100_F32_FLOPS = 67e12       # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
# bf16 output of attention (|o| <= ~1, one bf16 step is <= 3.9e-3 there);
# both sides round P to bf16 but may land one step apart where their exp
# differs in the last bits
FLASH_TOL = 2e-2
LSE_TOL = 1e-3   # f32 on both sides; only summation order differs
DECODE_TOL = 1e-2   # f32 math on both sides, output rounded to bf16
# decode == prefill on full-model logits (std ~1): the two paths round in
# bf16 at different places (GEMMs of M=2 vs M=2048 rows pick different
# kernels; attention through two different implementations) and the
# residual stream of 48 random-weight layers grows to where one bf16 step
# is ~0.06, so logits may differ by ~0.1; a position or cache-slot bug
# moves them by O(1)
E2E_MAX_TOL = 0.35
E2E_MEAN_TOL = 0.05
# the same oracle over an int8 pool: each cached k/v element is off its
# value by at most amax/254 of its (position, head) row, a perturbation of
# the scores and attention outputs of the size of one or two bf16 steps of
# the row's largest elements, so the logits move by about as much as the
# bf16 rounding the limit above already absorbs
INT8_E2E_MAX_TOL = E2E_MAX_TOL
# speculative tokens against greedy generate's: the verify chunk scores K
# tokens a row through plain attention and GEMMs over B x K rows, where a
# greedy step runs B4 and GEMMs over B rows, so their logits part by a few
# bf16 steps of the top logits (~4.4 on random GPT-2 XL weights, a step
# 0.03125; the readings: 0 to 0.0625); where the two paths pick different
# tokens, both must lie within four such steps of each other in a forward
# through no attention kernel, and every speculative token within them of
# that forward's maximum (the oracle logs the reference's top-1 - top-2
# gaps, which this limit must sit below)
SPEC_TIE_TOL = 0.125
# flash backward: two gates on each of dq, dk and dv.
# * element-wise |kernel - plain| <= atol + rtol * |plain|: 16-bit outputs
#   land one or two rounding steps apart where the two sides' exp or dot
#   differ in the last bits (a bf16 step is 2^-8 relative, 0.0156 for
#   |x| in [2, 4)); bf16 read at most 0.0156 on NVIDIA H100 80GB HBM3,
#   700 W, where |dv| reaches ~4.
# * relative L2 over each tile of 64 positions along T (and over the whole
#   tensor): rows and keys late in a causal sequence hold values ~20x
#   smaller than the first ones, so a tile the kernel skips, masks wrongly
#   or takes from the wrong q block reads ~1 there, while sums of 16-bit
#   products in another order read ~1e-4 over the whole tensor. A tile
#   whose plain rms is below atol / 10 is measured against that floor.
# f32 inputs: the same sums in another order (read ~3e-6 and ~5e-7). The
# f32 delta = rowsum(dO * O) is held to the f32 limits in every case.
BWD_TOL = {"16": dict(atol=2e-2, rtol=1e-2, l2=1e-2),
           "32": dict(atol=1e-4, rtol=1e-4, l2=1e-4)}
BWD_TILE = 64
# in-situ oracle of the train phase (bf16 model, random weights): the
# kernels and the plain attention under autograd round P, dS and the
# attention output to bf16 at different places, and the backward carries
# those one-step differences through 24 layers; a wrong kernel gradient
# moves a layer's c_attn gradient by O(1) relative
TRAIN_LOSS_TOL = 1e-2   # relative
TRAIN_GRAD_TOL = 5e-2   # relative L2, per layer
TRAIN_STEPS = 4
# ~1 ms of device spin ahead of each timed launch (the clock is ~2 GHz),
# far longer than a wrapper's host time to enqueue its kernel (Python
# checks, allocation, the ctypes launch), which without the spin lands
# between the events whenever the kernel is shorter
SPIN_CYCLES = 2_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, each after
    ``flush`` is rewritten (it is larger than the 50 MB L2, so every launch
    finds its inputs in device memory, as the model's call does). Before
    each start event the device spins for SPIN_CYCLES, so the host has
    enqueued all of ``fn`` before the device reaches it: the events bracket
    device work, not the wrapper's host time."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


def _builders():
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import layer_norm as ln
    return [fa.BUILDER, fa.BWD_BUILDER, da.PAGED_BUILDER, da.CHUNK_BUILDER,
            bsa.BUILDER, ln.BUILDER]


def _demangle(names):
    """C++ names demangled by ``c++filt`` (unchanged where it is missing),
    without the anonymous namespace and the parameter list."""
    filt = shutil.which("c++filt")
    if filt and names:
        out = subprocess.run([filt], input="\n".join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = out.splitlines()
    return [re.sub(r"\(.*\)$", "",
                   n.replace("(anonymous namespace)::", "")) for n in names]


def ptxas_lines(log_text):
    """Each register or spill line of a ``-Xptxas -v`` log with the entry
    function it belongs to, demangled."""
    entry, rows = "?", []
    for line in log_text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            entry = m.group(1)
        elif "registers" in line or "spill" in line:
            rows.append((entry, line.strip()))
    mangled = sorted({e for e, _ in rows})
    pretty = dict(zip(mangled, _demangle(mangled)))
    return [(pretty[e], line) for e, line in rows]


def _spills(builder, entry):
    """The ptxas lines of ``builder`` that report a spill in an entry whose
    demangled name matches the regular expression ``entry``."""
    return [(e, line) for e, line in ptxas_lines(builder.ptxas_log)
            if re.search(entry, e) and "spill" in line
            and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                              line)]


def phase_build():
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import layer_norm as ln
    from deepspeed_tpu_torch.ops.flash_attention import BUILDER, BWD_BUILDER
    from deepspeed_tpu_torch.ops.op_builder import build_all
    t0 = time.perf_counter()
    builders = _builders()
    build_all(builders)
    log(f"[build] {len(builders)} kernel libraries built and loaded in "
        f"{time.perf_counter() - t0:.3f} s")
    for b in builders:
        for entry, line in ptxas_lines(b.ptxas_log):
            log(f"[build] {b.name}: {entry}: {line}")
    # the warp-specialised kernels (flash forward and backward, B8's
    # tensor-core kernel) need setmaxnreg honoured
    for b in (BUILDER, BWD_BUILDER, bsa.BUILDER):
        check("C7508" not in b.ptxas_log,
              f"{b.name}: ptxas ignored setmaxnreg (C7508): " + b.ptxas_log)
    # and the 16-bit backward kernels (B3's role split at 256 too) and B1's
    # 256-wide entries fit their setmaxnreg budgets
    spills = _spills(BWD_BUILDER, "wgmma|split")
    check(not spills, f"flash_attention_bwd: 16-bit kernels spill: {spills}")
    spills = _spills(
        BUILDER, r"\bflash_fwd_wgmma_kernel<(__nv_bfloat16|__half), 256>")
    check(not spills, f"flash_attention_fwd: 16-bit 256-wide entries spill: "
          f"{spills}")
    # no entry of B9's persistent kernel, of B5/B5i's split kernel, of the
    # B7/B7i and B6/B6i tensor-core kernels, of B4's kernel or of B8's
    # two kernels over 16-bit queries spills
    for b, kernel in ((ln.BUILDER, "ln_fwd_ring_kernel"),
                      (da.PAGED_BUILDER, "paged_split_kernel"),
                      (da.PAGED_BUILDER, "paged_verify_mma_kernel"),
                      (da.CHUNK_BUILDER, "paged_chunk_mma_kernel"),
                      (da.PAGED_BUILDER, "decode_dense_kernel"),
                      (bsa.BUILDER, "bsa_wgmma_kernel"),
                      (bsa.BUILDER, "bsa_mma_kernel")):
        spills = _spills(b, rf"\b{kernel}<(__nv_bfloat16|__half),")
        check(not spills, f"{b.name}: 16-bit {kernel} entries spill: "
              f"{spills}")
    # nor any entry of B10's kernels
    spills = _spills(ln.BUILDER, r"\bln_bwd_\w+_kernel<")
    check(not spills, f"{ln.BUILDER.name}: B10 entries spill: {spills}")


# ------------------------------------------------------- head dims to 256
# Every attention kernel runs a head dim D <= 128 on its 64- or 128-wide
# instantiation, and the serving kernels (B1, B4-B7, B5i-B7i) a D <= 256
# on their 256-wide one, reading zeros past D and writing nothing there.
# Each phase below holds its kernels at D = 80 (gpt2-2.7b, Pythia-2.8B)
# and D = 96 (gpt2-760m, GPT-NeoX-20B), and the serving kernels at D = 256
# (GPT-J-6B), against their plain versions on every head, twice for the
# same bits, on inputs that are views of buffers whose guard columns past
# D hold NaN (a load past D poisons the result); B8 also writes into such
# a view, whose guard columns must stay NaN. Bounds count the true D.

def _width(D):
    """The kernel width a head dim D runs at (the wrappers' route)."""
    from deepspeed_tpu_torch.ops.head_dim import head_dim_route
    return head_dim_route(D, 2)[0]


def _guarded(x, fill=float("nan")):
    """``x`` as the ``[..., :D]`` view of a ``[..., DK + 16]`` buffer whose
    guard columns past D hold ``fill`` (NaN; int8 has none, so 127)."""
    D = x.shape[-1]
    buf = torch.full((*x.shape[:-1], _width(D) + 16), fill, dtype=x.dtype,
                     device=x.device)
    buf[..., :D] = x
    return buf[..., :D]


def _head_dim_case(what, D, run, plain, lib, tol, nbytes, flops, peak,
                   flush, iters=20, guard=None):
    """One kernel at head dim D: ``run()`` returns its output, held to
    ``plain()`` within ``tol`` on every head, the same bits on a second
    call (and, given ``guard``, the buffer ``run()`` writes into, its guard
    columns past D still NaN); then timed beside its plain version, the
    library call ``lib()`` and the bound. Returns the row's ``d{D}_*``
    fields and the error."""
    o = run().clone()
    o2 = run()
    ref = plain()
    torch.cuda.synchronize()
    d = (o.float() - ref.float()).abs()
    heads = d.amax(dim=tuple(i for i in range(d.dim()) if i != d.dim() - 2))
    err = heads.max().item()
    check(bool(torch.isfinite(heads).all()) and err <= tol,
          f"{what} D={D}: max |o - plain| over the heads {heads.tolist()} "
          f"> {tol}")
    check(torch.equal(o, o2), f"{what} D={D}: other bits on a second call")
    if guard is not None:
        check(bool(torch.isnan(guard[..., D:]).all()),
              f"{what} D={D}: a store past the head dim touched a guard "
              f"column")
    bound, by = _bound(nbytes, flops, peak)
    ms = cuda_ms(run, iters, flush)
    plain_ms = cuda_ms(plain, 3, flush)
    lib_ms = cuda_ms(lib, iters, flush)
    log(f"[head_dims] {what} D={D}: max|o err| {err!r} (tol {tol}, every "
        f"head), bit-identical twice, NaN guard columns unread"
        f"{', its own untouched' if guard is not None else ''}; kernel "
        f"{ms!r} ms, plain {plain_ms!r} ms, library {lib_ms!r} ms, bound "
        f"{bound!r} ms ({by}, true D)")
    return {f"d{D}_ms": ms, f"d{D}_plain_ms": plain_ms,
            f"d{D}_library_ms": lib_ms, f"d{D}_bound_ms": bound,
            f"d{D}_bound_by": by, f"d{D}_max_abs_err": err}, err


def _fused_qkv(g, B, T, H, D):
    """q, k and v ``[B, T, H, D]`` as views of one guarded fused
    ``[B, T, 3, H, D]`` bf16 projection."""
    return _guarded(torch.randn((B, T, 3, H, D), generator=g, device="cuda",
                                dtype=torch.bfloat16)).unbind(2)


def _flash_head_dims(flush):
    """B1 at gpt2-2.7b's [8, 1024, 32, 80], gpt2-760m's [8, 1024, 16, 96]
    and GPT-J-6B's [8, 1024, 16, 256], q/k/v views of the fused
    projection; then the padded route at D = 36 against the native route
    at D = 40 ([8, 1024, 32, D])."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(21)
    fields, worst = {}, 0.0
    for D, B, T, H in ((80, 8, 1024, 32), (96, 8, 1024, 16),
                       (256, 8, 1024, 16)):
        q, k, v = _fused_qkv(g, B, T, H, D)
        lses = [flash_attention_fwd(q, k, v)[1] for _ in range(2)]
        lse_ref = flash_attention_reference(q, k, v)[1]
        lerr = (lses[0] - lse_ref).abs().max().item()
        check(lerr <= LSE_TOL and torch.equal(lses[0], lses[1]),
              f"flash D={D}: lse off by {lerr} or not bit-stable")
        pairs = T * (T + 1) // 2
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        f, err = _head_dim_case(
            f"flash [{B}, {T}, {H}, {D}]", D,
            lambda: flash_attention_fwd(q, k, v)[0],
            lambda: flash_attention_reference(q, k, v)[0],
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True),
            FLASH_TOL, 2 * 4 * B * T * H * D + 4 * B * H * T,
            4 * B * H * D * pairs, H100_BF16_FLOPS, flush)
        log(f"[head_dims] flash D={D}: the {_width(D)}-wide tile issues "
            f"{4 * B * H * _width(D) * pairs / 1e9:.1f} GFLOP of "
            f"tensor-core work "
            f"for {4 * B * H * D * pairs / 1e9:.1f} GFLOP of the true D; "
            f"max|lse err| {lerr!r}")
        fields.update(f)
        worst = max(worst, err)
        del q, k, v, qt, kt, vt
    for D in (36, 40):
        q, k, v = (torch.randn((8, 1024, 32, D), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        o = flash_attention_fwd(q, k, v)[0]
        err = (o.float() - flash_attention_reference(q, k, v)[0].float()
               ).abs().max().item()
        check(err <= FLASH_TOL, f"flash D={D}: max err {err}")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v), 20, flush)
        route = "padded" if D == 36 else "native"
        fields[f"{'pad' if D == 36 else 'native'}{D}_ms"] = ms
        log(f"[head_dims] flash [8, 1024, 32, {D}], the {route} route: "
            f"max|o err| {err!r}; {ms!r} ms")
        worst = max(worst, err)
    torch.cuda.empty_cache()
    return fields, worst


def _flash_bwd_head_dims(flush):
    """B2 and B3 at the two training shapes of _flash_head_dims and at
    [8, 1024, 8, 256] (gpt2-1.3b with 8 heads of 256), q, k, v and dO
    guarded views, gated as the other backward cases; SDPA's backward is
    the library time of both."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(22)
    fields = {"flash_attention_bwd_dq": {}, "flash_attention_bwd_dkv": {}}
    worst = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    tol = BWD_TOL["16"]
    for D, B, T, H in ((80, 8, 1024, 32), (96, 8, 1024, 16),
                       (256, 8, 1024, 8)):
        q, k, v = _fused_qkv(g, B, T, H, D)
        o, lse = fa.flash_attention_fwd(q, k, v)
        do = _guarded(torch.randn((B, T, H, D), generator=g, device="cuda",
                                  dtype=torch.bfloat16))

        def run_dq():
            return fa.flash_attention_bwd_dq(q, k, v, o, lse, do)

        dq, delta = run_dq()

        def run_dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do)

        dk, dv = run_dkv()
        dq2, delta2 = run_dq()
        dk2, dv2 = run_dkv()
        scale = 1.0 / math.sqrt(D)
        rq, rdelta = fa._bwd_dq_reference(q, k, v, o, lse, do, True, scale)
        rk, rv = fa._bwd_dkv_reference(q, k, v, lse, rdelta, do, True, scale)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in
                  zip((dq, dk, dv, delta), (dq2, dk2, dv2, delta2))),
              f"flash bwd D={D}: other bits on a second run")
        stats = {key: bwd_error(a, r, **tol) for key, a, r in
                 (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        stats["delta"] = bwd_error(delta, rdelta, **BWD_TOL["32"])
        for key, st in stats.items():
            lim = BWD_TOL["32"]["l2"] if key == "delta" else tol["l2"]
            check(math.isfinite(st["max_err"]) and st["elem"] <= 1.0
                  and (key == "delta" or (st["rel_l2"] <= lim
                                          and st["tile_l2"] <= lim)),
                  f"flash bwd D={D}: {key} off its limits ({st})")
        pairs = T * (T + 1) // 2
        bhtd, bht = B * T * H * D, B * H * T
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        lib = cuda_ms(lambda: torch.autograd.grad(
            sdpa, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), 20,
            flush)
        for name, run, plain, nbytes, flops, errs in (
                ("flash_attention_bwd_dq", run_dq,
                 lambda: fa._bwd_dq_reference(q, k, v, o, lse, do, True,
                                              scale),
                 2 * 6 * bhtd + 8 * bht, 6 * B * H * D * pairs,
                 [stats["dq"]["max_err"]]),
                ("flash_attention_bwd_dkv", run_dkv,
                 lambda: fa._bwd_dkv_reference(q, k, v, lse, delta, do,
                                               True, scale),
                 2 * 6 * bhtd + 8 * bht, 8 * B * H * D * pairs,
                 [stats["dk"]["max_err"], stats["dv"]["max_err"]])):
            bound, by = _bound(nbytes, flops, H100_BF16_FLOPS)
            ms = cuda_ms(run, 20, flush)
            plain_ms = cuda_ms(plain, 3, flush)
            fields[name].update({
                f"d{D}_ms": ms, f"d{D}_plain_ms": plain_ms,
                f"d{D}_library_ms": lib, f"d{D}_bound_ms": bound,
                f"d{D}_bound_by": by, f"d{D}_max_abs_err": max(errs)})
            worst[name] = max(worst[name], *errs)
            log(f"[head_dims] {name} [{B}, {T}, {H}, {D}]: max|err| "
                f"{max(errs)!r}, bit-identical twice, NaN guard columns "
                f"unread; kernel {ms!r} ms, plain {plain_ms!r} ms, SDPA "
                f"backward (dq+dk+dv) {lib!r} ms, bound {bound!r} ms ({by}, "
                f"true D), {flops / ms / 1e9:.1f} TFLOP/s of the true D")
        log(f"[head_dims] flash bwd D={D}: " + "; ".join(
            f"{key} max|err| {st['max_err']!r} rel L2 {st['rel_l2']:.2e} "
            f"worst tile {st['tile_l2']:.2e}" for key, st in stats.items()))
        del q, k, v, o, lse, do, dq, dk, dv, dq2, dk2, dv2, rq, rk, rv
        del sdpa, qt, kt, vt
        torch.cuda.empty_cache()
    return fields, worst


def _decode_head_dims(flush):
    """B4 at Pythia-2.8B's decode geometry (8 rows, S=2048, 32 heads of
    80), GPT-NeoX-20B's (64 heads of 96) and GPT-J-6B's (16 heads of 256),
    seeded lengths, the cache and q guarded views."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(23)
    rng = np.random.default_rng(23)
    fields, worst = {}, 0.0
    for D, H in ((80, 32), (96, 64), (256, 16)):
        B, S = 8, 2048

        def rnd(*shape):
            return _guarded(torch.randn(shape, generator=g, device="cuda",
                                        dtype=torch.bfloat16))

        kc, vc = rnd(2, B, S, H, D)[1], rnd(2, B, S, H, D)[1]
        q = rnd(B, 3, H, D)[:, 0]
        lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                               device="cuda")
        live = int(lens.sum())
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        f, err = _head_dim_case(
            f"decode [{B}, {S}, {H}, {D}]", D,
            lambda: decode_attention(q, kc, vc, lens),
            lambda: decode_attention_reference(q, kc, vc, lens),
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=mask),
            DECODE_TOL, 2 * 2 * live * H * D + 2 * 2 * B * H * D + 4 * B,
            4 * live * H * D, H100_F32_FLOPS, flush, iters=50)
        fields.update(f)
        worst = max(worst, err)
        del kc, vc, q, q4, k4, v4, mask
    torch.cuda.empty_cache()
    return fields, worst


def _paged_head_dims(flush):
    """B5-B7 and B5i-B7i at Pythia-2.8B's serving geometry (S=8 slots of
    2048 positions, BS=128, 32 kv heads of 80), GPT-NeoX-20B's (64 of 96)
    and GPT-J-6B's (16 of 256): decode, a C=256 chunk at start 256, verify
    K=4, fp and int8 pools, bf16 queries; q and the pools guarded views
    (int8 guard columns hold 127)."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(24)
    rng = np.random.default_rng(24)
    S, BS, MB, K, C, start = 8, 128, 16, 4, 256, 256
    NB, span = S * MB + 1, MB * BS
    fields, worst = {}, {}
    for D, H in ((80, 32), (96, 64), (256, 16)):
        def rnd(*shape):
            return _guarded(torch.randn(shape, generator=g, device="cuda",
                                        dtype=torch.bfloat16))
        kp2, vp2 = rnd(2, NB, BS, H, D), rnd(2, NB, BS, H, D)
        kq, ks = _int8_layer_pool(kp2)
        vq, vs = _int8_layer_pool(vp2)
        kq, vq = _guarded(kq, 127), _guarded(vq, 127)
        pools = {"": (kp2[1], vp2[1], {}),
                 "_int8": (kq, vq, dict(k_scale=ks, v_scale=vs))}
        lens_np = rng.integers(1, span - K + 1, S).astype(np.int32)
        tables = torch.as_tensor(_paged_tables(rng, -(-(lens_np + K) // BS),
                                               NB, MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        row = torch.as_tensor(_paged_tables(rng, [MB], NB, MB)[0],
                              device="cuda")
        qd, qc, qv = rnd(S, 3, H, D)[:, 0], rnd(C, H, D), rnd(S, K, H, D)
        for suffix, (kp, vp, sc) in pools.items():
            q8 = bool(sc)

            def gathered(t):
                """the cache through the tables (dequantized), [n, H, span,
                D] for SDPA"""
                t = t.long()
                if not q8:
                    return [p[t].reshape(t.shape[0], span, H, D)
                            .transpose(1, 2) for p in (kp, vp)]
                return [(p[t].float() * sp[t].transpose(-1, -2)[..., None]
                         ).to(torch.bfloat16).reshape(t.shape[0], span, H, D)
                        .transpose(1, 2) for p, sp in ((kq, ks), (vq, vs))]

            kc, vc = gathered(tables)
            kc1, vc1 = (x[:1] for x in gathered(row[None]))
            # bytes of one key row and head: K and V (+ their f32 scales)
            row_bytes = 2 * D + 8 if q8 else 2 * 2 * D
            live = int(lens_np.sum())
            dmask = (torch.arange(span, device="cuda")[None, :]
                     < lens[:, None])[:, None, None, :]
            cmask = (torch.arange(span, device="cuda")[None, :]
                     <= start + torch.arange(C, device="cuda")[:, None])
            vmask = (torch.arange(span, device="cuda")[None, None, :]
                     <= lens[:, None, None]
                     + torch.arange(K, device="cuda")[None, :, None])[:, None]
            vkeys = live + S * K
            vpairs = sum(K * int(n) + K * (K + 1) // 2 for n in lens_np)
            cpairs = C * start + C * (C + 1) // 2
            for kind, q, fn, ref, tol, lib, nbytes, flops, peak in (
                    ("decode", qd, da.paged_decode_attention,
                     da.paged_decode_attention_reference, DECODE_TOL,
                     lambda: F.scaled_dot_product_attention(
                         qd[:, :, None], kc, vc, attn_mask=dmask),
                     row_bytes * live * H + 2 * 2 * S * H * D
                     + 4 * S * (MB + 1), 4 * live * H * D, H100_F32_FLOPS),
                    ("chunk", qc, da.paged_chunk_attention,
                     da.paged_chunk_attention_reference, FLASH_TOL,
                     lambda: F.scaled_dot_product_attention(
                         qc.transpose(0, 1)[None], kc1, vc1,
                         attn_mask=cmask),
                     row_bytes * (start + C) * H + 2 * 2 * C * H * D
                     + 4 * MB, 4 * cpairs * H * D, H100_BF16_FLOPS),
                    ("verify", qv, da.paged_verify_attention,
                     da.paged_verify_attention_reference, DECODE_TOL,
                     lambda: F.scaled_dot_product_attention(
                         qv.transpose(1, 2), kc, vc, attn_mask=vmask),
                     row_bytes * vkeys * H + 2 * 2 * S * K * H * D
                     + 4 * S * (MB + 1), 4 * vpairs * H * D,
                     H100_BF16_FLOPS)):
                rest = ((row, start) if kind == "chunk" else (tables, lens))
                name = f"paged_{kind}_attention{suffix}"
                f, err = _head_dim_case(
                    f"{name} H={H}", D,
                    lambda: fn(q, kp, vp, *rest, **sc),
                    lambda: ref(q, kp, vp, *rest, **sc), lib, tol, nbytes,
                    flops, peak, flush)
                fields.setdefault(name, {}).update(f)
                worst[name] = max(worst.get(name, 0.0), err)
            del kc, vc, kc1, vc1
        del kp2, vp2, kq, vq, pools
        torch.cuda.empty_cache()
    return fields, worst


def _sparse_head_dims(flush):
    """B8 on layout (i) (Fixed, blocks of 64, causal) at gpt2-2.7b's
    [2, 4096, 32, 80], gpt2-760m's [2, 4096, 16, 96] and 8 heads of 256
    ([2, 4096, 8, 256], the bytes and operations of case (i)), q/k/v views of a
    guarded fused projection, the output a guarded [B, T, H, D] view (B8
    takes ``out``, for SparseSelfAttention), with the tile order
    SparseSelfAttention caches; SDPA with the dense mask is the library
    time."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import layout_to_dense_mask
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(25)
    fields, worst = {}, 0.0
    for D, B, T, H in ((80, 2, 4096, 32), (96, 2, 4096, 16),
                       (256, 2, 4096, 8)):
        lay = _fixed_1p3b(sa, H).make_layout(T)
        lut_np, counts_np = bsa.build_lut(lay)
        lut, counts = (torch.as_tensor(x, device="cuda")
                       for x in (lut_np, counts_np))
        order = torch.as_tensor(bsa.tile_order(lut_np, counts_np, True),
                                device="cuda")
        q, k, v = (x.transpose(1, 2) for x in _fused_qkv(g, B, T, H, D))
        o = _guarded(torch.full((B, T, H, D), float("nan"), device="cuda",
                                dtype=torch.bfloat16))
        buf, out = o._base, o.transpose(1, 2)
        args = (q, k, v, lut, counts, 64, True)
        ref = bsa.block_sparse_attention_reference(*args)
        st, ok = _sparse_error(bsa.block_sparse_attention(
            *args, out=out, order=order).transpose(1, 2),
            ref.transpose(1, 2), SPARSE_TOL["16"])
        check(ok, f"sparse D={D}: o off its limits ({st})")
        full, diag = _visible_entries(lut_np, counts_np, True)
        mask = torch.as_tensor(layout_to_dense_mask(lay, 64, True),
                               device="cuda")[None]
        f, err = _head_dim_case(
            f"sparse (i) [{B}, {T}, {H}, {D}]", D,
            lambda: bsa.block_sparse_attention(*args, out=out, order=order),
            lambda: bsa.block_sparse_attention_reference(*args),
            lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            SPARSE_TOL["16"]["atol"],
            4 * B * T * H * D * 2 + lut_np.nbytes + counts_np.nbytes,
            4 * B * D * (64 * 64 * full + 64 * 65 // 2 * diag),
            H100_BF16_FLOPS, flush, guard=buf)
        log(f"[head_dims] sparse D={D}: rel L2 {st['rel_l2']:.2e}, worst "
            f"64-row tile {st['tile_l2']:.2e} (limits {SPARSE_TOL['16']})")
        fields.update(f)
        worst = max(worst, err)
        del q, k, v, buf, o, out, ref, mask, lut, counts, order
        torch.cuda.empty_cache()
    return fields, worst


def phase_flash(flush):
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(1)
    cases = [("gpt2-xl T=128", 8, 128, 25, 25, 64, True),
             ("gpt2-xl T=1024", 8, 1024, 25, 25, 64, True),
             ("gqa H=32 KH=8 D=128", 2, 1024, 32, 8, 128, True),
             ("ragged T=1000", 8, 1000, 25, 25, 64, True),
             ("full T=300", 2, 300, 25, 25, 64, False),
             # the train step's shape, q/k/v views of the fused projection
             # as models/gpt2.py makes them (strides (T 3C, 3C, D, 1))
             ("gpt2-1.3b train T=1024", 8, 1024, 16, 16, 128, True)]
    worst, main, train = 0.0, None, None
    for name, B, T, H, KH, D, causal in cases:
        if name.startswith("gpt2-1.3b"):
            qkv = torch.randn((B, T, 3 * H * D), generator=g, device="cuda",
                              dtype=torch.bfloat16)
            q, k, v = (t.reshape(B, T, H, D)
                       for t in qkv.split(H * D, dim=-1))
            del qkv
        else:
            q = torch.randn((B, T, H, D), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            k = torch.randn((B, T, KH, D), generator=g, device="cuda",
                            dtype=torch.bfloat16)
            v = torch.randn((B, T, KH, D), generator=g, device="cuda",
                            dtype=torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=causal)
        o_ref, lse_ref = flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        check(math.isfinite(err) and err <= FLASH_TOL,
              f"flash {name}: max |o - o_ref| = {err} > {FLASH_TOL}")
        check(math.isfinite(lerr) and lerr <= LSE_TOL,
              f"flash {name}: max |lse - lse_ref| = {lerr} > {LSE_TOL}")
        worst = max(worst, err)
        pairs = T * (T + 1) // 2 if causal else T * T
        flops = 4 * B * H * D * pairs
        nbytes = 2 * (2 * B * T * H * D + 2 * B * T * KH * D) + 4 * B * H * T
        bound = max(flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / H100_BF16_FLOPS
                    > nbytes / H100_BYTES_PER_S else "bytes")
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal), 20,
                     flush)
        plain = cuda_ms(lambda: flash_attention_reference(q, k, v, causal),
                        5, flush)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=KH != H), 20, flush)
        log(f"[flash] {name}: max|o err| {err!r} (tol {FLASH_TOL}), "
            f"max|lse err| {lerr!r} (tol {LSE_TOL}); kernel {ms!r} ms, "
            f"plain {plain!r} ms, sdpa {lib!r} ms, bound {bound!r} ms "
            f"({bound_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        if name == "gpt2-xl T=1024":
            main = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                        bound_by=bound_by, library_ms=lib)
        elif name.startswith("gpt2-1.3b"):
            train = dict(train_shape_ms=ms, train_shape_bound_ms=bound,
                         train_shape_library_ms=lib)
        del q, k, v, o, o_ref, lse, lse_ref
    # the wrapper's host time per call (checks, allocation, the tensor
    # maps, the ctypes launch) at a B=1 prefill of the server, T=128
    q = torch.randn((1, 128, 25, 64), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    for _ in range(10):
        flash_attention_fwd(q, q, q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        flash_attention_fwd(q, q, q)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"[flash] host time per call at [1, 128, 25, 64]: {host_us!r} us "
        f"(200 calls, no sync)")
    fields, err = _flash_head_dims(flush)
    return dict(main, **train, host_us=host_us, max_abs_err=max(worst, err),
                **fields)


def host_us(fn, calls=2000):
    """Median host wall of one call of ``fn`` (checks, plan, allocation,
    the ctypes launch) over ``calls`` calls timed one by one, each after a
    sync (outside the timing) so that a kernel longer than its call never
    fills the launch queue and throttles the next: the shared host swings
    by 10-30 us between calls, so a median."""
    for _ in range(10):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def phase_decode(flush):
    """B4 against its plain version: GPT-2 XL (the row), H=32/KH=8/D=128
    (its ``gqa_*`` fields), R=3 and R=7 (Qwen2-7B's 28 heads over 4), each
    twice on the same inputs for the same bits; a length-0 row; the
    wrapper's host time per call."""
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_reference)
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(2)
    rng = np.random.default_rng(2)
    cases = [("gpt2-xl", 8, 1024, 25, 25, 64),
             ("gqa H=32 KH=8 D=128", 8, 1024, 32, 8, 128),
             ("R=3 H=24 KH=8 D=128", 8, 1024, 24, 8, 128),
             ("R=7 H=28 KH=4 D=128", 8, 1024, 28, 4, 128)]
    worst, recs = 0.0, {}
    for name, B, S, H, KH, D in cases:
        # the layer view of a 2-layer cache, as the model passes it
        kc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        vc = torch.randn((2, B, S, KH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)[1]
        q = torch.randn((B, H, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        lens = torch.as_tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                               device="cuda")
        o = decode_attention(q, kc, vc, lens)
        again = decode_attention(q, kc, vc, lens)
        o_ref = decode_attention_reference(q, kc, vc, lens)
        torch.cuda.synchronize()
        err = (o.float() - o_ref.float()).abs().max().item()
        check(math.isfinite(err) and err <= DECODE_TOL,
              f"decode {name}: max |o - o_ref| = {err} > {DECODE_TOL}")
        check(torch.equal(o, again),
              f"decode {name}: other bits on the same inputs")
        worst = max(worst, err)
        live = int(lens.sum())
        bound, bound_by = _bound(2 * 2 * live * KH * D + 2 * 2 * B * H * D
                                 + 4 * B, 4 * live * H * D, H100_F32_FLOPS)
        ms = cuda_ms(lambda: decode_attention(q, kc, vc, lens), 50, flush)
        plain = cuda_ms(lambda: decode_attention_reference(q, kc, vc, lens),
                        10, flush)
        mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, enable_gqa=KH != H), 50, flush)
        log(f"[decode] {name}: lengths sum {live}, max|o err| {err!r} "
            f"(tol {DECODE_TOL}), bit-identical twice; kernel {ms!r} ms, "
            f"plain {plain!r} ms, sdpa {lib!r} ms, bound {bound!r} ms "
            f"({bound_by}), {2 * 2 * live * KH * D / ms / 1e6:.1f} GB/s")
        recs[name] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                          bound_by=bound_by, library_ms=lib)
    # a length-0 row gives zeros, as the TPU kernel does
    lens0 = torch.tensor([0, 5], dtype=torch.int32, device="cuda")
    o = decode_attention(q[:2], kc[:2], vc[:2], lens0)
    check(bool((o[0] == 0).all()) and bool(torch.isfinite(o).all()),
          "decode: a length-0 row must give zeros")
    # the wrapper's host time per call at generate's GPT-2 XL shape
    B, S, H, D = 8, 1024, 25, 64
    kc = torch.randn((2, B, S, H, D), generator=g, device="cuda",
                     dtype=torch.bfloat16)[1]
    q = torch.randn((B, H, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    lens = torch.full((B,), 500, dtype=torch.int32, device="cuda")
    us = host_us(lambda: decode_attention(q, kc, kc, lens))
    log(f"[decode] host time per call at q [8, 25, 64], cache [8, 1024, 25, "
        f"64]: {us!r} us (median of 2000 calls, each after a sync)")
    gqa = recs["gqa H=32 KH=8 D=128"]
    fields, err = _decode_head_dims(flush)
    return dict(recs["gpt2-xl"], max_abs_err=max(worst, err), host_us=us,
                **{f"gqa_{f}": gqa[f] for f in ("ms", "bound_ms",
                                                "library_ms")}, **fields)


def _bound(nbytes, flops, peak_flops):
    """Least time (ms) and what sets it: bytes over HBM rate or
    operations over the peak rate for their type."""
    tb, tf = nbytes / H100_BYTES_PER_S, flops / peak_flops
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def _paged_tables(rng, spans, NB, MB):
    """Shuffled, non-contiguous block tables: slot s owns spans[s] blocks;
    slots 0 and 1 share their first two blocks (a prefix-cache hit); dead
    entries point at the null block 0."""
    ids = iter(rng.permutation(np.arange(1, NB)).tolist())
    tables = np.zeros((len(spans), MB), np.int32)
    for s, n in enumerate(spans):
        for j in range(n):
            tables[s, j] = (tables[0, j] if s == 1 and j < 2 and
                            spans[0] > j else next(ids))
    return tables


def _int8_layer_pool(x2):
    """A 2-layer fp pool [2, NB, BS, KH, D] quantized per (position, head)
    row with the port's quantize_int8 → the int8 layer view [NB, BS, KH, D]
    and the scale tiles' layer view [NB, KH, BS], as the server keeps them."""
    from deepspeed_tpu_torch.ops.quant_core import quantize_int8
    q, s = quantize_int8(x2, -1)
    return q[1], s[..., 0].transpose(-1, -2).contiguous()[1]


def phase_paged(flush):
    """B5, B6 and B7 against their plain versions in bf16 at GPT-2 XL
    shapes (S=8 slots, BS=128, MB=8, NB=65 blocks) and a GQA case; then
    their int8 variants over int8 pools at the same shapes."""
    from deepspeed_tpu_torch.ops import decode_attention as da
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    S, BS, MB, NB, K, C = 8, 128, 8, 65, 4, 256
    out = {}
    for name, H, KH, D in (("gpt2-xl", 25, 25, 64),
                           ("gqa H=32 KH=8 D=128", 32, 8, 128)):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda",
                               dtype=torch.bfloat16)
        # the layer view of a 2-layer pool, as the model passes it
        kp, vp = rnd(2, NB, BS, KH, D)[1], rnd(2, NB, BS, KH, D)[1]
        span = MB * BS

        def gathered(tables):
            t = tables.long()
            return (kp[t].reshape(t.shape[0], span, KH, D).transpose(1, 2),
                    vp[t].reshape(t.shape[0], span, KH, D).transpose(1, 2))

        # ---- B5 paged decode
        lens_np = rng.integers(1, span + 1, S).astype(np.int32)
        tables = torch.as_tensor(_paged_tables(rng, -(-lens_np // BS), NB,
                                               MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        q = rnd(S, H, D)
        args = (q, kp, vp, tables, lens)
        o = da.paged_decode_attention(*args)
        err = (o.float() - da.paged_decode_attention_reference(*args).float()
               ).abs().max().item()
        check(math.isfinite(err) and err <= DECODE_TOL,
              f"paged decode {name}: max err {err} > {DECODE_TOL}")
        check(torch.equal(o, da.paged_decode_attention(*args)),
              f"paged decode {name}: other bits on the same inputs")
        live = int(lens_np.sum())
        bound, by = _bound(2 * 2 * live * KH * D + 2 * 2 * S * H * D
                           + 4 * S * (MB + 1), 4 * live * H * D,
                           H100_F32_FLOPS)
        kc, vc = gathered(tables)
        mask = (torch.arange(span, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        rec = dict(
            ms=cuda_ms(lambda: da.paged_decode_attention(*args), 50, flush),
            plain_ms=cuda_ms(lambda: da.paged_decode_attention_reference(
                *args), 10, flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=KH != H),
                50, flush),
            bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"[paged] decode {name}: lengths sum {live}, max|o err| {err!r} "
            f"(tol {DECODE_TOL}), bit-identical twice; kernel "
            f"{rec['ms']!r} ms, plain "
            f"{rec['plain_ms']!r} ms, sdpa over the cache already gathered "
            f"{rec['library_ms']!r} ms, bound {bound!r} ms ({by})")
        out.setdefault("paged_decode_attention", []).append((name, rec))

        # ---- B6 paged chunk: C=256 at start 0, 256 and 512 of one slot
        row_np = _paged_tables(rng, [MB], NB, MB)[0]
        row = torch.as_tensor(row_np, device="cuda")
        for start in (0, 256, 512):
            qc = rnd(C, H, D)
            cargs = (qc, kp, vp, row, start)
            o = da.paged_chunk_attention(*cargs)
            err = (o.float()
                   - da.paged_chunk_attention_reference(*cargs).float()
                   ).abs().max().item()
            check(math.isfinite(err) and err <= FLASH_TOL,
                  f"paged chunk {name} start {start}: max err {err} > "
                  f"{FLASH_TOL}")
            check(torch.equal(o, da.paged_chunk_attention(*cargs)),
                  f"paged chunk {name} start {start}: other bits on the "
                  f"same inputs")
            keys = start + C
            pairs = C * start + C * (C + 1) // 2
            bound, by = _bound(2 * 2 * keys * KH * D + 2 * 2 * C * H * D
                               + 4 * MB, 4 * pairs * H * D, H100_BF16_FLOPS)
            kc1 = kp[row.long()].reshape(span, KH, D).transpose(0, 1)[None]
            vc1 = vp[row.long()].reshape(span, KH, D).transpose(0, 1)[None]
            cmask = (torch.arange(span, device="cuda")[None, :]
                     <= start + torch.arange(C, device="cuda")[:, None])
            qt = qc.transpose(0, 1)[None]
            rec = dict(
                ms=cuda_ms(lambda: da.paged_chunk_attention(*cargs), 20,
                           flush),
                plain_ms=cuda_ms(lambda: da.paged_chunk_attention_reference(
                    *cargs), 5, flush),
                library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kc1, vc1, attn_mask=cmask, enable_gqa=KH != H), 20,
                    flush),
                bound_ms=bound, bound_by=by, max_abs_err=err)
            log(f"[paged] chunk {name} C={C} start={start}: max|o err| "
                f"{err!r} (tol {FLASH_TOL}), bit-identical twice; kernel "
                f"{rec['ms']!r} ms, plain "
                f"{rec['plain_ms']!r} ms, sdpa over the cache already "
                f"gathered {rec['library_ms']!r} ms, bound {bound!r} ms "
                f"({by}), {4 * pairs * H * D / rec['ms'] / 1e9:.1f} TFLOP/s")
            out.setdefault("paged_chunk_attention", []).append(
                (f"{name} start={start}", rec))

        # ---- B7 paged verify: K=4 candidates per slot
        lens_np = rng.integers(1, span - K + 1, S).astype(np.int32)
        tables = torch.as_tensor(_paged_tables(rng, -(-(lens_np + K) // BS),
                                               NB, MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        qv = rnd(S, K, H, D)
        vargs = (qv, kp, vp, tables, lens)
        o = da.paged_verify_attention(*vargs)
        err = (o.float()
               - da.paged_verify_attention_reference(*vargs).float()
               ).abs().max().item()
        check(math.isfinite(err) and err <= DECODE_TOL,
              f"paged verify {name}: max err {err} > {DECODE_TOL}")
        check(torch.equal(o, da.paged_verify_attention(*vargs)),
              f"paged verify {name}: other bits on the same inputs")
        keys = int(lens_np.sum()) + S * K
        pairs = sum(K * int(n) + K * (K + 1) // 2 for n in lens_np)
        bound, by = _bound(2 * 2 * keys * KH * D + 2 * 2 * S * K * H * D
                           + 4 * S * (MB + 1), 4 * pairs * H * D,
                           H100_BF16_FLOPS)
        kc, vc = gathered(tables)
        vmask = (torch.arange(span, device="cuda")[None, None, :]
                 <= lens[:, None, None]
                 + torch.arange(K, device="cuda")[None, :, None])[:, None]
        qt = qv.transpose(1, 2)
        rec = dict(
            ms=cuda_ms(lambda: da.paged_verify_attention(*vargs), 50, flush),
            plain_ms=cuda_ms(lambda: da.paged_verify_attention_reference(
                *vargs), 10, flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=vmask, enable_gqa=KH != H), 50, flush),
            bound_ms=bound, bound_by=by, max_abs_err=err)
        log(f"[paged] verify {name} K={K}: lengths sum {int(lens_np.sum())}, "
            f"max|o err| {err!r} (tol {DECODE_TOL}), bit-identical twice; "
            f"kernel {rec['ms']!r} ms, plain {rec['plain_ms']!r} ms, sdpa "
            f"over the cache already gathered {rec['library_ms']!r} ms, "
            f"bound {bound!r} ms ({by})")
        out.setdefault("paged_verify_attention", []).append((name, rec))

        # ---- int8 pools: B5i, B6i, B7i with bf16, fp16 and f32 queries
        kq, ks = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        vq, vs = _int8_layer_pool(rnd(2, NB, BS, KH, D))
        sc = dict(k_scale=ks, v_scale=vs)

        def deq(tables):
            """the cache gathered and dequantized to bf16 for SDPA"""
            t = tables.long()
            return [(p[t].float() * sp[t].transpose(-1, -2)[..., None]
                     ).to(torch.bfloat16).reshape(t.shape[0], span, KH, D)
                    .transpose(1, 2) for p, sp in ((kq, ks), (vq, vs))]

        def int8_err(fn, ref, args, dt, tol, what):
            e = (fn(*args, **sc).float() - ref(*args, **sc).float()
                 ).abs().max().item()
            check(math.isfinite(e) and e <= tol,
                  f"{what} {name} {dt}: max err {e} > {tol}")
            return e

        lens_np = rng.integers(1, span + 1, S).astype(np.int32)
        lens_np[-1] = 0   # an idle slot: zeros
        tables = torch.as_tensor(_paged_tables(rng, -(-lens_np // BS), NB,
                                               MB), device="cuda")
        lens = torch.as_tensor(lens_np, device="cuda")
        vlens_np = rng.integers(1, span - K + 1, S).astype(np.int32)
        vtables = torch.as_tensor(_paged_tables(
            rng, -(-(vlens_np + K) // BS), NB, MB), device="cuda")
        vlens = torch.as_tensor(vlens_np, device="cuda")
        errs = {"paged_decode_attention_int8": [],
                "paged_chunk_attention_int8": [],
                "paged_verify_attention_int8": []}
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            tol = 1e-4 if dt == torch.float32 else DECODE_TOL
            q = rnd(S, H, D).to(dt)
            o = da.paged_decode_attention_int8(q, kq, vq, tables, lens, ks,
                                               vs)
            check(bool((o[-1] == 0).all()) and bool(torch.isfinite(o).all()),
                  f"paged decode int8 {name} {dt}: a length-0 slot must "
                  f"give zeros")
            errs["paged_decode_attention_int8"].append(int8_err(
                da.paged_decode_attention, da.paged_decode_attention_reference,
                (q, kq, vq, tables, lens), dt, tol, "paged decode int8"))
            errs["paged_verify_attention_int8"].append(int8_err(
                da.paged_verify_attention, da.paged_verify_attention_reference,
                (rnd(S, K, H, D).to(dt), kq, vq, vtables, vlens), dt, tol,
                "paged verify int8"))
            ctol = 1e-4 if dt == torch.float32 else FLASH_TOL
            for start in ((0, 256, 512) if dt == torch.bfloat16 else (256,)):
                errs["paged_chunk_attention_int8"].append(int8_err(
                    da.paged_chunk_attention,
                    da.paged_chunk_attention_reference,
                    (rnd(C, H, D).to(dt), kq, vq, row, start), dt, ctol,
                    f"paged chunk int8 start {start}"))
        # timed in bf16, at the fp cases' shapes: B5i
        q = rnd(S, H, D)
        args = (q, kq, vq, tables, lens, ks, vs)
        check(torch.equal(da.paged_decode_attention_int8(*args),
                          da.paged_decode_attention_int8(*args)),
              f"paged decode int8 {name}: other bits on the same inputs")
        live = int(lens_np.sum())
        bound, by = _bound((2 * D + 8) * live * KH + 2 * 2 * S * H * D
                           + 4 * S * (MB + 1), 4 * live * H * D,
                           H100_F32_FLOPS)
        kc, vc = deq(tables)
        mask = (torch.arange(span, device="cuda")[None, :] < lens[:, None]
                )[:, None, None, :]
        rec = dict(
            ms=cuda_ms(lambda: da.paged_decode_attention_int8(*args), 50,
                       flush),
            plain_ms=cuda_ms(lambda: da.paged_decode_attention_reference(
                *args[:5], None, ks, vs), 10, flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=KH != H),
                50, flush),
            bound_ms=bound, bound_by=by,
            max_abs_err=max(errs["paged_decode_attention_int8"]))
        log(f"[paged] decode int8 {name}: lengths sum {live} (one slot 0), "
            f"max|o err| bf16/fp16/f32 {errs['paged_decode_attention_int8']!r}"
            f" (tol {DECODE_TOL}, f32 1e-4), bf16 bit-identical twice; "
            f"kernel {rec['ms']!r} ms, plain "
            f"{rec['plain_ms']!r} ms, sdpa over the cache already gathered "
            f"and dequantized {rec['library_ms']!r} ms, bound {bound!r} ms "
            f"({by})")
        out.setdefault("paged_decode_attention_int8", []).append((name, rec))
        # B6i at start 256
        start = 256
        qc = rnd(C, H, D)
        cargs = (qc, kq, vq, row, start, ks, vs)
        check(torch.equal(da.paged_chunk_attention_int8(*cargs),
                          da.paged_chunk_attention_int8(*cargs)),
              f"paged chunk int8 {name}: other bits on the same inputs")
        keys, pairs = start + C, C * start + C * (C + 1) // 2
        bound, by = _bound((2 * D + 8) * keys * KH + 2 * 2 * C * H * D
                           + 4 * MB, 4 * pairs * H * D, H100_BF16_FLOPS)
        kc1, vc1 = (x[0][None] for x in deq(row[None]))
        cmask = (torch.arange(span, device="cuda")[None, :]
                 <= start + torch.arange(C, device="cuda")[:, None])
        qt = qc.transpose(0, 1)[None]
        rec = dict(
            ms=cuda_ms(lambda: da.paged_chunk_attention_int8(*cargs), 20,
                       flush),
            plain_ms=cuda_ms(lambda: da.paged_chunk_attention_reference(
                *cargs[:5], None, ks, vs), 5, flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kc1, vc1, attn_mask=cmask, enable_gqa=KH != H), 20,
                flush),
            bound_ms=bound, bound_by=by,
            max_abs_err=max(errs["paged_chunk_attention_int8"]))
        log(f"[paged] chunk int8 {name} C={C} start={start}: max|o err| "
            f"(starts 0/256/512 bf16, 256 fp16/f32) "
            f"{errs['paged_chunk_attention_int8']!r} (tol {FLASH_TOL}, f32 "
            f"1e-4), bf16 bit-identical twice; kernel {rec['ms']!r} ms, "
            f"plain {rec['plain_ms']!r} ms, sdpa over the cache already "
            f"gathered and dequantized {rec['library_ms']!r} ms, bound "
            f"{bound!r} ms ({by})")
        out.setdefault("paged_chunk_attention_int8", []).append(
            (f"{name} start={start}", rec))
        # B7i
        qv = rnd(S, K, H, D)
        vargs = (qv, kq, vq, vtables, vlens, ks, vs)
        check(torch.equal(da.paged_verify_attention_int8(*vargs),
                          da.paged_verify_attention_int8(*vargs)),
              f"paged verify int8 {name}: other bits on the same inputs")
        keys = int(vlens_np.sum()) + S * K
        pairs = sum(K * int(n) + K * (K + 1) // 2 for n in vlens_np)
        bound, by = _bound((2 * D + 8) * keys * KH + 2 * 2 * S * K * H * D
                           + 4 * S * (MB + 1), 4 * pairs * H * D,
                           H100_BF16_FLOPS)
        kc, vc = deq(vtables)
        vmask = (torch.arange(span, device="cuda")[None, None, :]
                 <= vlens[:, None, None]
                 + torch.arange(K, device="cuda")[None, :, None])[:, None]
        qt = qv.transpose(1, 2)
        rec = dict(
            ms=cuda_ms(lambda: da.paged_verify_attention_int8(*vargs), 50,
                       flush),
            plain_ms=cuda_ms(lambda: da.paged_verify_attention_reference(
                *vargs[:5], None, ks, vs), 10, flush),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kc, vc, attn_mask=vmask, enable_gqa=KH != H), 50, flush),
            bound_ms=bound, bound_by=by,
            max_abs_err=max(errs["paged_verify_attention_int8"]))
        log(f"[paged] verify int8 {name} K={K}: lengths sum "
            f"{int(vlens_np.sum())}, max|o err| bf16/fp16/f32 "
            f"{errs['paged_verify_attention_int8']!r} (tol {DECODE_TOL}, f32 "
            f"1e-4), bf16 bit-identical twice; kernel {rec['ms']!r} ms, "
            f"plain {rec['plain_ms']!r} ms, "
            f"sdpa over the cache already gathered and dequantized "
            f"{rec['library_ms']!r} ms, bound {bound!r} ms ({by})")
        out.setdefault("paged_verify_attention_int8", []).append((name, rec))
    # the row of each kernel: its GPT-2 XL case (B6 at start 256), the GQA
    # case's time, bound and library time beside it, and the worst error
    # over all cases
    rows = {}
    for k, v in out.items():
        at = "start=256" if "chunk" in k else ""
        case = dict(v)
        main = case[f"gpt2-xl {at}".strip()]
        gqa = case[f"gqa H=32 KH=8 D=128 {at}".strip()]
        rows[k] = dict(main, max_abs_err=max(r["max_abs_err"] for _, r in v),
                       **{f"gqa_{f}": gqa[f] for f in ("ms", "bound_ms",
                                                        "library_ms")})
    # each wrapper's host time per call (checks, the plan and its scratch,
    # the ctypes launch) at the server's shapes, GPT-2 XL heads: decode and
    # verify (K=4) at S=8, a C=256 chunk at start 256
    kp = torch.randn((NB, BS, 25, 64), generator=g, device="cuda",
                     dtype=torch.bfloat16)
    tables = torch.arange(1, S * MB + 1, dtype=torch.int32,
                          device="cuda").reshape(S, MB)
    lens = torch.full((S,), 500, dtype=torch.int32, device="cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    calls = {"paged_decode_attention": (f"S={S}", (rnd(S, 25, 64), kp, kp,
                                                   tables, lens)),
             "paged_verify_attention": (f"S={S} K={K}", (
                 rnd(S, K, 25, 64), kp, kp, tables, lens)),
             "paged_chunk_attention": (f"C={C} start=256", (
                 rnd(C, 25, 64), kp, kp, tables[0], 256))}
    for k, (shape, args) in calls.items():
        fn = getattr(da, k)
        for _ in range(10):
            fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        log(f"[paged] {k} host time per call at {shape}, [NB, {BS}, 25, "
            f"64]: {host_us!r} us (200 calls, no sync)")
        rows[k]["host_us"] = host_us
    fields, worst = _paged_head_dims(flush)
    for k, row in rows.items():
        row.update(fields[k], max_abs_err=max(row["max_abs_err"], worst[k]))
    return rows


def bwd_error(a, r, atol, rtol, l2):
    """How far ``a`` lies from ``r``: the largest error and reference, the
    worst element's share of ``atol + rtol * |r|``, the relative L2 error,
    and the worst relative L2 error over tiles of BWD_TILE positions along
    dim 1 (T of [B, T, H, D]; H of delta's [B, H, T], where it is not
    gated)."""
    a, r = a.float(), r.float()
    d = a - r
    dims = [i for i in range(d.dim()) if i != 1]
    d2, r2 = d.square().sum(dims), r.square().sum(dims)
    pad = -d2.numel() % BWD_TILE
    d2, r2 = (torch.nn.functional.pad(x, (0, pad)).view(-1, BWD_TILE).sum(1)
              for x in (d2, r2))
    per_tile = r.numel() / r.shape[1] * BWD_TILE
    floor = (atol / 10) ** 2 * per_tile
    return dict(
        max_err=d.abs().max().item(), max_ref=r.abs().max().item(),
        elem=(d.abs() / (atol + rtol * r.abs())).max().item(),
        rel_l2=(d.norm() / r.norm().clamp_min(1e-30)).item(),
        tile_l2=(d2 / r2.clamp_min(floor)).sqrt().max().item())


def phase_flash_bwd(flush):
    """B2 and B3 against their plain versions; the row of each kernel is
    its GPT-2 1.3B training case, with the worst error over all cases.
    SDPA's backward (dq, dk and dv together) is the library time of
    both."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(9)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [("gpt2-1.3b train", 8, 1024, 16, 16, 128, True, bf16),
             ("gpt2-xl", 8, 1024, 25, 25, 64, True, bf16),
             ("gqa H=32 KH=8 D=128", 2, 1024, 32, 8, 128, True, bf16),
             ("ragged T=1000", 8, 1000, 16, 16, 128, True, bf16),
             ("full T=300", 2, 300, 16, 16, 128, False, bf16),
             ("bert-large full", 16, 512, 16, 16, 64, False, bf16),
             ("fp16", 2, 1024, 16, 16, 128, True, f16),
             ("fp32", 1, 256, 16, 16, 128, True, f32)]
    worst = {"dq": 0.0, "dkv": 0.0}
    rows = {}
    stable = False
    for name, B, T, H, KH, D, causal, dt in cases:
        def rnd(*shape):
            return torch.randn(shape, generator=g, device="cuda", dtype=dt)
        if name == "gpt2-1.3b train":
            # the model's views of its fused c_attn output
            q, k, v = (x.reshape(B, T, H, D) for x in
                       rnd(B, T, 3 * H * D).split(H * D, -1))
        else:
            q, k, v = rnd(B, T, H, D), rnd(B, T, KH, D), rnd(B, T, KH, D)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        do = rnd(B, T, H, D)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, delta, do, causal)
        scale = 1.0 / math.sqrt(D)
        rq, rdelta = fa._bwd_dq_reference(q, k, v, o, lse, do, causal, scale)
        rk, rv = fa._bwd_dkv_reference(q, k, v, lse, rdelta, do, causal,
                                       scale)
        torch.cuda.synchronize()
        tol = BWD_TOL["32" if dt == f32 else "16"]
        stats = {key: bwd_error(a, r, **tol) for key, a, r in
                 (("dq", dq, rq), ("dk", dk, rk), ("dv", dv, rv))}
        stats["delta"] = bwd_error(delta, rdelta, **BWD_TOL["32"])
        for key, st in stats.items():
            lim = BWD_TOL["32"]["l2"] if key == "delta" else tol["l2"]
            check(math.isfinite(st["max_err"]) and st["elem"] <= 1.0,
                  f"flash bwd {name}: {key} off its element-wise limit "
                  f"({st})")
            check(key == "delta" or (st["rel_l2"] <= lim
                                     and st["tile_l2"] <= lim),
                  f"flash bwd {name}: {key} relative L2 over {lim} ({st})")
        if name == "gpt2-1.3b train":
            # no atomics across blocks: a second run gives the same bits
            dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, o, lse, do,
                                                    causal)
            dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lse, delta2, do,
                                                  causal)
            stable = all(torch.equal(a, b) for a, b in (
                (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
            check(stable, f"flash bwd {name}: a second run of B2 and B3 "
                  f"on the same inputs gave other bits")
            del dq2, delta2, dk2, dv2
        worst["dq"] = max(worst["dq"], stats["dq"]["max_err"])
        worst["dkv"] = max(worst["dkv"], stats["dk"]["max_err"],
                           stats["dv"]["max_err"])
        pairs = T * (T + 1) // 2 if causal else T * T
        esz = q.element_size()
        peak = H100_F32_FLOPS if dt == f32 else H100_BF16_FLOPS
        bhtd, bktd, bht = B * T * H * D, B * T * KH * D, B * H * T
        b_dq = _bound(esz * (4 * bhtd + 2 * bktd) + 8 * bht,
                      6 * B * H * D * pairs, peak)
        b_dkv = _bound(esz * (2 * bhtd + 4 * bktd) + 8 * bht,
                       8 * B * H * D * pairs, peak)
        ms_dq = cuda_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, o, lse, do, causal), 20, flush)
        ms_dkv = cuda_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, lse, delta, do, causal), 20, flush)
        plain_dq = cuda_ms(lambda: fa._bwd_dq_reference(
            q, k, v, o, lse, do, causal, scale), 3, flush)
        plain_dkv = cuda_ms(lambda: fa._bwd_dkv_reference(
            q, k, v, lse, delta, do, causal, scale), 3, flush)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                             enable_gqa=KH != H)
        dot = do.transpose(1, 2)
        lib = cuda_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), 20, flush)
        errs = "; ".join(
            f"{key} max|err| {st['max_err']!r} (max|ref| {st['max_ref']!r}, "
            f"{st['elem']:.3f} of the element limit) rel L2 "
            f"{st['rel_l2']:.2e} worst tile {st['tile_l2']:.2e}"
            for key, st in stats.items())
        log(f"[flash_bwd] {name}: {errs} (limits {tol}); dq kernel {ms_dq!r} "
            f"ms (plain {plain_dq!r}, bound {b_dq[0]!r} {b_dq[1]}, "
            f"{6 * B * H * D * pairs / ms_dq / 1e9:.1f} TFLOP/s), dk/dv "
            f"kernel {ms_dkv!r} ms (plain {plain_dkv!r}, bound "
            f"{b_dkv[0]!r} {b_dkv[1]}, "
            f"{8 * B * H * D * pairs / ms_dkv / 1e9:.1f} TFLOP/s); SDPA "
            f"backward, dq+dk+dv together, {lib!r} ms")
        if name == "gpt2-1.3b train":
            rows = {
                "flash_attention_bwd_dq": dict(
                    ms=ms_dq, plain_ms=plain_dq, bound_ms=b_dq[0],
                    bound_by=b_dq[1], library_ms=lib,
                    tflops=6 * B * H * D * pairs / ms_dq / 1e9),
                "flash_attention_bwd_dkv": dict(
                    ms=ms_dkv, plain_ms=plain_dkv, bound_ms=b_dkv[0],
                    bound_by=b_dkv[1], library_ms=lib,
                    tflops=8 * B * H * D * pairs / ms_dkv / 1e9)}
        del q, k, v, o, lse, do, dq, dk, dv, rq, rk, rv, out, qt, kt, vt
    check(stable, "flash bwd: the bit-stability run did not happen")
    # the wrappers' host time per call of the pair (checks, allocation, the
    # tensor maps, two ctypes launches) at B=1, T=128, the 1.3B heads
    q = torch.randn((1, 128, 16, 128), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, q, q)

    def pair():
        _, delta = fa.flash_attention_bwd_dq(q, q, q, o, lse, q)
        fa.flash_attention_bwd_dkv(q, q, q, lse, delta, q)
    for _ in range(10):
        pair()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        pair()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"[flash_bwd] host time per call of the pair at [1, 128, 16, 128]: "
        f"{host_us!r} us (200 calls, no sync); B2 and B3 bit-identical on "
        f"a second run")
    fields, new_worst = _flash_bwd_head_dims(flush)
    for name, key in (("flash_attention_bwd_dq", "dq"),
                      ("flash_attention_bwd_dkv", "dkv")):
        rows[name].update(max_abs_err=max(worst[key], new_worst[name]),
                          host_us_pair=host_us, **fields[name])
    return rows


# B8, two gates on o: max |o - plain| <= atol, where bf16/fp16 outputs land
# one or two rounding steps apart, as in flash attention (P is rounded to 16
# bits on both sides, at different running maxima); and relative L2 over
# each tile of 64 positions along T, as for the flash backward: late rows of
# a long sparse sequence average ~1000 keys, so |o| is ~0.05 there and a
# wrong or skipped block moves a tile by O(1) relative while staying inside
# atol. f32: the sums in another order
SPARSE_TOL = {"16": dict(atol=FLASH_TOL, l2=1e-2),
              "32": dict(atol=1e-4, l2=1e-4)}
# B9/B10: o and dx element-wise within atol + rtol * |plain| in 16 bits (the
# same f32 values rounded to 16 bits land at most a step or two apart, a
# bf16 step being 2^-8 relative) and 1e-4 in f32; mean and rstd are f32 on
# both sides (1e-5 relative); dw and db are f32 sums over the rows in
# another order (1e-4 relative L2; 1e-3 against autograd through the
# reference, whose sums run in yet another order)
LN_TOL = {"16": dict(atol=2e-2, rtol=1e-2), "32": dict(atol=1e-4, rtol=0.0)}
LN_STAT_TOL = 1e-5
LN_SUM_TOL = 1e-4
LN_GRAD_SUM_TOL = 1e-3


def _fixed_1p3b(sa, heads=16):
    """The sparse main path's layout: Fixed, causal, over GPT-2 1.3B's 16
    heads (or ``heads``)."""
    return sa.FixedSparsityConfig(num_heads=heads, block=64,
                                  num_local_blocks=4, num_global_blocks=1,
                                  attention="unidirectional")


def _visible_entries(lut, counts, causal):
    """LUT entries the kernel multiplies, the first ``count`` of each row:
    ``(full, diagonal)``. Causal: blocks above the diagonal are dropped and
    a diagonal block needs only its block(block+1)/2 causal pairs, so it is
    counted apart; otherwise every entry is full."""
    H, nb, A = lut.shape
    live = np.arange(A)[None, None, :] < counts[..., None]
    if not causal:
        return int(live.sum()), 0
    row = np.arange(nb)[None, :, None]
    return int((live & (lut < row)).sum()), int((live & (lut == row)).sum())


def _sparse_error(out, ref, tol):
    """B8's gates on ``[B, T, H, D]`` outputs (see SPARSE_TOL): the stats
    of :func:`bwd_error` with ``elem`` the share of atol, and whether both
    gates hold."""
    st = bwd_error(out, ref, atol=tol["atol"], rtol=0.0, l2=tol["l2"])
    ok = (math.isfinite(st["max_err"]) and st["elem"] <= 1.0
          and st["rel_l2"] <= tol["l2"] and st["tile_l2"] <= tol["l2"])
    return st, ok


def phase_sparse(flush):
    """B8 against its plain version on the card; the row is case (i), the
    GPT-2 1.3B attention geometry, with the worst error over all cases."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    from deepspeed_tpu_torch.ops.sparse_attention.sparse_self_attention \
        import layout_to_dense_mask
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(11)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    nb = 1024 // 64
    dead = np.zeros((16, nb, nb), np.int64)   # the JAX test's layout
    dead[:, 0, 1] = 1              # row block 0 sees only the future block 1
    for i in range(1, nb):
        dead[:, i, i] = 1
    # name, B, T, H, D, block, layout, causal, dtype, q/k/v as strided views
    cases = [
        ("(i) gpt2-1.3b fixed", 2, 4096, 16, 128, 64,
         _fixed_1p3b(sa).make_layout(4096), True, bf16, True),
        ("(ii) bigbird", 2, 4096, 16, 128, 64,
         sa.BigBirdSparsityConfig(num_heads=16, block=64).make_layout(4096),
         False, bf16, True),
        ("(iii) gpt2-xl longformer", 2, 2048, 25, 64, 128,
         sa.BSLongformerSparsityConfig(num_heads=25, block=128
                                       ).make_layout(2048), False, bf16,
         False),
        ("(iv) variable block 16", 2, 1024, 16, 64, 16,
         sa.VariableSparsityConfig(num_heads=16, block=16,
                                   num_random_blocks=2,
                                   local_window_blocks=[4],
                                   global_block_indices=[0]
                                   ).make_layout(1024), False, bf16, False),
        ("(iv) sliding window block 32", 2, 1024, 16, 64, 32,
         sa.LocalSlidingWindowSparsityConfig(
             num_heads=16, block=32, num_sliding_window_blocks=5
         ).make_layout(1024), True, bf16, False),
        ("(v) fixed per-head", 2, 2048, 16, 128, 64,
         sa.FixedSparsityConfig(num_heads=16, block=64, num_local_blocks=4,
                                different_layout_per_head=True,
                                num_different_global_patterns=4
                                ).make_layout(2048), False, bf16, False),
        ("(vi) causally dead rows", 2, 1024, 16, 128, 64, dead, True, bf16,
         False),
        ("(vii) fp16", 2, 2048, 16, 128, 64,
         _fixed_1p3b(sa).make_layout(2048), True, f16, True),
        ("(vii) fp32", 1, 1024, 16, 128, 64,
         _fixed_1p3b(sa).make_layout(1024), True, f32, False),
    ]
    worst, main = 0.0, None
    for name, B, T, H, D, block, lay, causal, dt, strided in cases:
        lut_np, counts_np = bsa.build_lut(lay)
        lut, counts = (torch.as_tensor(x, device="cuda")
                       for x in (lut_np, counts_np))
        # the tile order SparseSelfAttention caches with the LUT
        order = torch.as_tensor(bsa.tile_order(lut_np, counts_np, causal),
                                device="cuda")
        if strided:   # [B, H, T, D] views of a fused [B, T, 3, H, D] output
            q, k, v = (x.transpose(1, 2) for x in torch.randn(
                (B, T, 3, H, D), generator=g, device="cuda",
                dtype=dt).unbind(2))
        else:
            q, k, v = (torch.randn((B, H, T, D), generator=g, device="cuda",
                                   dtype=dt) for _ in range(3))
        args = (q, k, v, lut, counts, block, causal)
        out = bsa.block_sparse_attention(*args, order=order)
        ref = bsa.block_sparse_attention_reference(*args)
        torch.cuda.synchronize()
        if name.startswith("(i)"):
            check(torch.equal(out, bsa.block_sparse_attention(
                *args, order=order)),
                  f"sparse {name}: other bits on the same inputs")
        tol = SPARSE_TOL["32" if dt == f32 else "16"]
        st, ok = _sparse_error(out.transpose(1, 2), ref.transpose(1, 2), tol)
        check(ok, f"sparse {name}: o off its limits {tol} ({st})")
        if lay is dead:
            check(bool((out[:, :, :block] == 0).all())
                  and bool((ref[:, :, :block] == 0).all()),
                  f"sparse {name}: rows that see no key must be exactly 0")
        err = st["max_err"]
        worst = max(worst, err)
        full, diag = _visible_entries(lut_np, counts_np, causal)
        visible = full + diag
        flops = 4 * B * D * (block * block * full
                             + block * (block + 1) // 2 * diag)
        bound, by = _bound(4 * B * T * H * D * q.element_size()
                           + lut_np.nbytes + counts_np.nbytes, flops,
                           H100_F32_FLOPS if dt == f32 else H100_BF16_FLOPS)
        ms = cuda_ms(lambda: bsa.block_sparse_attention(*args, order=order),
                     20, flush)
        extra = ""
        if name.startswith("(i)"):
            plain = cuda_ms(lambda: bsa.block_sparse_attention_reference(
                *args), 3, flush)
            mask = torch.as_tensor(layout_to_dense_mask(lay, block, causal),
                                   device="cuda")[None]
            lib = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 20, flush)
            lib_err = (F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
                       .float() - ref.float()).abs().max().item()
            us = host_us(lambda: bsa.block_sparse_attention(*args,
                                                             order=order))
            main = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                        library_ms=lib, host_us=us)
            extra = (f"; plain {plain!r} ms, sdpa with the dense mask {lib!r} "
                     f"ms (max |sdpa - plain| {lib_err!r}); bit-identical "
                     f"twice; host time per call {us!r} us (median of 2000 "
                     f"calls, each after a sync)")
            del mask
        log(f"[sparse] {name}: B={B} T={T} H={H} D={D} block={block} "
            f"{str(dt).replace('torch.', '')}, {visible} visible blocks "
            f"({diag} on the causal diagonal) of {counts_np.size} rows, "
            f"max|o err| {err!r} (max|ref| {st['max_ref']!r}), rel L2 "
            f"{st['rel_l2']:.2e}, worst 64-row tile {st['tile_l2']:.2e} "
            f"(limits {tol}); kernel {ms!r} ms, bound {bound!r} ms ({by}), "
            f"{flops / ms / 1e9:.1f} TFLOP/s{extra}")
        del q, k, v, out, ref, lut, counts, order
        torch.cuda.empty_cache()
    fields, err = _sparse_head_dims(flush)
    return dict(main, max_abs_err=max(worst, err), **fields)


def _ln_elem_ok(a, r, tol):
    a, r = a.float(), r.float()
    return bool(((a - r).abs() <= tol["atol"] + tol["rtol"] * r.abs()).all())


def _rel_l2(a, r):
    return ((a.float() - r.float()).norm() / r.float().norm()).item()


def phase_layer_norm(flush):
    """B9 and B10 against their plain versions on the card; the rows are
    the GPT-2 1.3B training shape, with the worst errors over all cases."""
    from deepspeed_tpu_torch.ops import layer_norm as ln
    F = torch.nn.functional
    g = torch.Generator(device="cuda").manual_seed(12)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [("gpt2-1.3b train", (8, 1024, 2048), bf16),
             ("gpt2-xl width", (8192, 1600), bf16),
             ("ragged", (1000, 768), bf16),
             ("fp16", (4096, 2048), f16),
             ("fp32", (4096, 2048), f32),
             # rows wider than 8192 that are no whole 16-byte chunks: B10's
             # wide kernel, scalar loads
             ("wide unaligned", (2048, 10001), bf16)]
    worst = {"layer_norm_fwd": 0.0, "layer_norm_bwd": 0.0}
    rows = {}
    for name, shape, dt in cases:
        N = shape[-1]
        x = torch.randn(shape, generator=g, device="cuda", dtype=dt) * 2 + 0.5
        go = torch.randn(shape, generator=g, device="cuda", dtype=dt)
        w = torch.randn(N, generator=g, device="cuda") + 1
        b = torch.randn(N, generator=g, device="cuda")
        x2, go2 = x.reshape(-1, N), go.reshape(-1, N)
        R = x2.shape[0]
        o, mean, rstd = ln.layer_norm_fwd(x2, w, b)
        o_, mean_, rstd_ = ln.layer_norm_fwd(x2, w, b)
        dx, dw, db = ln.layer_norm_bwd(x2, w, mean, rstd, go2)
        dx_, dw_, db_ = ln.layer_norm_bwd(x2, w, mean, rstd, go2)
        ro, rmean, rrstd = ln.layer_norm_fwd_reference(x2, w, b, 1e-5)
        rdx, rdw, rdb = ln.layer_norm_bwd_reference(x2, w, mean, rstd, go2)
        torch.cuda.synchronize()
        tol = LN_TOL["32" if dt == f32 else "16"]
        stat = max(((a - r).abs() / r.abs().clamp_min(1e-30)).max().item()
                   for a, r in ((mean, rmean), (rstd, rrstd)))
        sums = max(_rel_l2(dw, rdw), _rel_l2(db, rdb))
        err_o = (o.float() - ro.float()).abs().max().item()
        err_dx = (dx.float() - rdx.float()).abs().max().item()
        check(_ln_elem_ok(o, ro, tol), f"layer_norm {name}: o off its "
              f"element-wise limit {tol} (max err {err_o})")
        check(_ln_elem_ok(dx, rdx, tol), f"layer_norm {name}: dx off its "
              f"element-wise limit {tol} (max err {err_dx})")
        check(stat <= LN_STAT_TOL, f"layer_norm {name}: mean/rstd relative "
              f"error {stat} > {LN_STAT_TOL}")
        check(sums <= LN_SUM_TOL, f"layer_norm {name}: dw/db relative L2 "
              f"{sums} > {LN_SUM_TOL}")
        check(torch.equal(dx, dx_) and torch.equal(dw, dw_)
              and torch.equal(db, db_),
              f"layer_norm {name}: B10 gave other bits on the same inputs")
        check(torch.equal(o, o_) and torch.equal(mean, mean_)
              and torch.equal(rstd, rstd_),
              f"layer_norm {name}: B9 gave other bits on the same inputs")
        worst["layer_norm_fwd"] = max(worst["layer_norm_fwd"], err_o)
        worst["layer_norm_bwd"] = max(worst["layer_norm_bwd"], err_dx)
        esz = x.element_size()
        b_f = _bound(2 * R * N * esz + 8 * N + 8 * R, 8 * R * N,
                     H100_F32_FLOPS)
        b_b = _bound(3 * R * N * esz + 4 * N + 8 * R + 8 * N, 14 * R * N,
                     H100_F32_FLOPS)
        ms_f = cuda_ms(lambda: ln.layer_norm_fwd(x2, w, b), 50, flush)
        ms_b = cuda_ms(lambda: ln.layer_norm_bwd(x2, w, mean, rstd, go2), 50,
                       flush)
        # PyTorch's own LayerNorm backward, its weights in x's dtype
        wl, bl = w.to(dt), b.to(dt)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(
            x2, [N], wl, bl, 1e-5)
        lib_b = cuda_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            go2, x2, [N], lmean, lrstd, wl, bl, [True, True, True]), 50,
            flush)
        msg = (f"[layer_norm] {name}: x {list(shape)} "
               f"{str(dt).replace('torch.', '')}, f32 weights; max|o err| "
               f"{err_o!r}, max|dx err| {err_dx!r} (limits {tol}), mean/rstd "
               f"relative {stat:.2e}, dw/db relative L2 {sums:.2e}, B9 and "
               f"B10 bit-identical twice; B9 {ms_f!r} ms (bound {b_f[0]!r} "
               f"{b_f[1]}, {(2 * R * N * esz) / ms_f / 1e6:.1f} GB/s), B10 "
               f"{ms_b!r} ms (bound {b_b[0]!r} {b_b[1]}, "
               f"{(3 * R * N * esz) / ms_b / 1e6:.1f} GB/s), "
               f"native_layer_norm_backward {lib_b!r} ms (B10 / native "
               f"{ms_b / lib_b:.3f})")
        if name == "gpt2-1.3b train":
            plain_f = cuda_ms(lambda: ln.layer_norm_fwd_reference(
                x2, w, b, 1e-5), 10, flush)
            plain_b = cuda_ms(lambda: ln.layer_norm_bwd_reference(
                x2, w, mean, rstd, go2), 10, flush)
            # PyTorch's own LayerNorm, its weights in x's dtype
            lib_f = cuda_ms(lambda: F.layer_norm(x2, (N,), wl, bl, 1e-5), 50,
                            flush)
            rows = {"layer_norm_fwd": dict(ms=ms_f, plain_ms=plain_f,
                                           bound_ms=b_f[0], bound_by=b_f[1],
                                           library_ms=lib_f),
                    "layer_norm_bwd": dict(ms=ms_b, plain_ms=plain_b,
                                           bound_ms=b_b[0], bound_by=b_b[1],
                                           library_ms=lib_b)}
            msg += (f"; plain B9 {plain_f!r} ms, B10 {plain_b!r} ms; "
                    f"F.layer_norm {lib_f!r} ms")
        elif name == "wide unaligned":
            rows["layer_norm_bwd"].update(
                wide_ms=ms_b, wide_bound_ms=b_b[0], wide_library_ms=lib_b)
        log(msg)
        del x, go, x2, go2, o, o_, dx, dx_, ro, rdx, lmean, lrstd
    for k in rows:
        rows[k]["max_abs_err"] = worst[k]
    return rows


def run_sparse(heads=16, D=128):
    """The sparse main path: ``SparseSelfAttention`` with the Fixed layout
    of case (i), three calls at T=4096 and one at T=2048 on [B, T, H, D]
    views of fused projections, GPT-2 1.3B's 16 heads of 128 (or ``heads``
    of ``D``); counts set to 0 just before, read just after."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    g = torch.Generator(device="cuda").manual_seed(13)
    op = sa.SparseSelfAttention(_fixed_1p3b(sa, heads))
    inputs = [torch.randn((2, T, 3, heads, D), generator=g, device="cuda",
                          dtype=torch.bfloat16).unbind(2)
              for T in (4096, 4096, 4096, 2048)]
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    outs = [op(q, k, v) for q, k, v in inputs]   # THE main path
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    check(counts["block_sparse_attention"] == 4,
          f"sparse: {counts['block_sparse_attention']} launches for 4 calls")
    check(sorted(op._cache) == [2048, 4096],
          f"sparse: LUT cache holds lengths {sorted(op._cache)}, expected "
          f"one entry per length")
    tol, errs = SPARSE_TOL["16"], []
    for (q, k, v), out in zip(inputs, outs):
        T = q.shape[1]
        _, lut, cnt = op._entry(T)
        ref = bsa.block_sparse_attention_reference(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), lut, cnt,
            64, True).transpose(1, 2)
        check(out.shape == (2, T, heads, D), f"sparse: output {out.shape}")
        st, ok = _sparse_error(out, ref, tol)
        check(ok, f"sparse: call at T={T} off its limits {tol} ({st})")
        errs.append((st["max_err"], st["max_ref"], st["tile_l2"]))
    log(f"[sparse] SparseSelfAttention, {heads} heads of {D}, 4 calls "
        f"(T=4096 x 3, 2048): "
        f"{wall * 1e3!r} ms of host wall incl. the LUT builds; per call "
        f"(max|o err|, max|ref|, worst 64-row tile rel L2) {errs!r} (limits "
        f"{tol}); launches {counts}")
    return counts


def run_layer_norm():
    """The LayerNorm main path: ``fused_layer_norm`` and
    ``fused_residual_layer_norm`` under autograd, forward and backward, at
    the GPT-2 1.3B training shape; counts set to 0 just before, read just
    after; gradients against autograd through ``layer_norm_reference``."""
    from deepspeed_tpu_torch.ops import layer_norm as ln
    g = torch.Generator(device="cuda").manual_seed(14)
    shape, N = (8, 1024, 2048), 2048

    def rnd(*s):
        return torch.randn(s, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    x, r, g1, g2 = rnd(*shape), rnd(*shape), rnd(*shape), rnd(*shape)
    w = torch.randn(N, generator=g, device="cuda") + 1
    b = torch.randn(N, generator=g, device="cuda")

    def leaves(*ts):
        return [t.detach().clone().requires_grad_() for t in ts]
    plain_leaves, res_leaves = leaves(x, w, b), leaves(x, r, w, b)
    torch.cuda.synchronize()
    _launch_counts(reset=True)
    y1 = ln.fused_layer_norm(*plain_leaves)   # THE main path
    y1.backward(g1)
    y2, s = ln.fused_residual_layer_norm(*res_leaves)
    y2.backward(g2)
    torch.cuda.synchronize()
    counts = _launch_counts()
    check(counts["layer_norm_fwd"] == 2 and counts["layer_norm_bwd"] == 2,
          f"layer_norm: launches {counts}, expected 2 forward and 2 "
          f"backward")
    tol = LN_TOL["16"]
    ref1 = leaves(x, w, b)
    ln.layer_norm_reference(*ref1).backward(g1)
    ref2 = leaves(x, r, w, b)
    ln.layer_norm_reference(ref2[0] + ref2[1], *ref2[2:]).backward(g2)
    stats = []
    for ours, theirs in ((plain_leaves, ref1), (res_leaves, ref2)):
        n_x = len(ours) - 2
        for a, rf in zip(ours[:n_x], theirs[:n_x]):
            check(_ln_elem_ok(a.grad, rf.grad, tol),
                  f"layer_norm: dx off its element-wise limit {tol}")
        rel = [_rel_l2(a.grad, rf.grad) for a, rf in
               zip(ours[n_x:], theirs[n_x:])]
        check(all(e <= LN_GRAD_SUM_TOL for e in rel),
              f"layer_norm: dw/db relative L2 {rel} > {LN_GRAD_SUM_TOL}")
        stats.append(rel)
    check(torch.equal(s, x + r), "layer_norm: residual sum differs")
    log(f"[layer_norm] fused_layer_norm + fused_residual_layer_norm under "
        f"autograd at {list(shape)} bf16: dx within {tol} of autograd "
        f"through layer_norm_reference, dw/db relative L2 {stats!r} (tol "
        f"{LN_GRAD_SUM_TOL}); launches {counts}")
    return counts


# the training runs' parameter counts (the port's leaves) by preset and
# depth (None: the preset's); a head-count override keeps the count
TRAIN_PARAMS = {("gpt2-760m", 8): 305495040, ("gpt2-1.3b", None): 1313722368,
                ("gpt2-2.7b", 8): 760816640}
# the depth of the D = 96 and D = 80 runs: 8 of their 24 and 32 layers,
# full width, which keeps chip_smoke.py inside its time limit
NEW_D_TRAIN_LAYERS = 8


def train_engine(model, params, micro, gas):
    """The training engine of phases train and llama_bert: bf16, AdamW
    (lr 1e-4, weight decay 0.01), gradient clipping 1.0."""
    import deepspeed_tpu_torch
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}}})
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return engine


def _train_model_run(tag, model, engine, batch, micro, gas, tokens,
                     plain_loss):
    """The training main path and its oracles on ``engine``: the loss of
    the initial weights through no attention kernel
    (``plain_loss(engine.params, micro_batch)``, the mean over the
    micro-batches) against the first step's, then one warm-up step and
    TRAIN_STEPS timed steps on the repeated batch, the counts set to 0
    just before and read just after; finite losses and gradient norms, a
    falling loss. Logs step ms, tokens/s, MFU and peak memory; returns
    the launch counts."""
    shapes = {k: v.shape for k, v in batch.items()}
    with torch.no_grad():
        ref = float(np.mean([plain_loss(engine.params, {
            k: torch.as_tensor(v[i * micro:(i + 1) * micro], device="cuda")
            for k, v in batch.items()}).item() for i in range(gas)]))
    first = engine.train_batch(batch)   # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    walls, metrics = [], []
    for _ in range(TRAIN_STEPS):   # THE main path
        t = time.perf_counter()
        metrics.append(engine.train_batch(batch))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    counts = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in [first] + metrics]
    gnorms = [float(m["grad_norm"]) for m in [first] + metrics]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{tag}: non-finite loss or grad norm: {losses} {gnorms}")
    check(losses[-1] < losses[0],
          f"{tag}: loss did not fall on a repeated batch: {losses}")
    check(abs(losses[0] - ref) <= TRAIN_LOSS_TOL * abs(ref),
          f"{tag}: first loss {losses[0]} vs {ref} through no attention "
          f"kernel")
    step_s = float(np.median(walls))
    tok_s = tokens / step_s
    mfu = model.flops_per_token() * tok_s / H100_BF16_FLOPS
    log(f"[train] {tag}: {TRAIN_STEPS} steps of {micro} x {gas} "
        f"({shapes}): step ms {[w * 1e3 for w in walls]!r}, median "
        f"{step_s * 1e3!r} ms; {tok_s!r} tokens/s; MFU {mfu!r} (6N flops "
        f"per token at 989 TFLOP/s); peak memory {peak} bytes; losses "
        f"{losses!r} (first against {ref!r} through no attention kernel, "
        f"tol {TRAIN_LOSS_TOL}); grad norms {gnorms!r}; launches {counts}")
    return counts


def _grad_oracle(tag, loss_fn, plain_loss, params, mb, names):
    """In-situ gradient oracle: the gradients of ``names`` on one
    micro-batch through the kernels (``loss_fn``) and through no
    attention kernel (``plain_loss``), the losses within TRAIN_LOSS_TOL
    and each gradient within TRAIN_GRAD_TOL relative L2."""
    out = []
    for fn in (loss_fn, plain_loss):
        loss = fn(params, mb)
        out.append((loss.item(), torch.autograd.grad(
            loss, [params[n] for n in names])))
    (lk, gk), (lr_, gr) = out
    rels = [((a.float() - b.float()).norm() / b.float().norm()).item()
            for a, b in zip(gk, gr)]
    log(f"[train] {tag}: gradient oracle on {mb['input_ids'].shape[0]} "
        f"sequence(s): loss kernels {lk!r} vs plain attention {lr_!r}; "
        f"{len(names)} gradients' relative L2 max {max(rels)!r}, mean "
        f"{float(np.mean(rels))!r} (tol {TRAIN_GRAD_TOL})")
    check(abs(lk - lr_) <= TRAIN_LOSS_TOL * abs(lr_),
          f"{tag} oracle: loss {lk} vs {lr_}")
    check(all(math.isfinite(r) and r <= TRAIN_GRAD_TOL for r in rels),
          f"{tag} oracle: gradient rel errors {rels}")


def phase_train(preset="gpt2-1.3b", n_head=None, n_layer=None,
                observe=False):
    """The training main path of a GPT-2 preset at full width, at its own
    depth or ``n_layer`` (``n_head`` overrides its head count: gpt2-1.3b
    with 8 heads has heads of 256), through ``_train_model_run`` and
    ``_grad_oracle`` (2 sequences, every layer's ``c_attn.kernel``);
    returns its launch counts, read just after the timed steps. With
    ``observe``: then two steps with numerics and goodput on
    (``_train_observed``), and beside it the activation checkpointing
    check at 2 layers (``_act_ckpt_check``; the twin-engine check of the
    observed steps is phase offload's (a) against (c))."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    over = {k: v for k, v in (("n_head", n_head), ("n_layer", n_layer))
            if v is not None}
    cfg = config_for(preset, **over)
    L = cfg.n_layer
    model = GPT2LMModel(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = model.param_count(params)
    check(n_params == TRAIN_PARAMS[preset, n_layer],
          f"{preset} at {L} layers has {n_params} parameters")
    micro, gas = 8, 2
    engine = train_engine(model, params, micro, gas)
    del params
    log(f"[train] {preset}: {L} layers, {cfg.n_head} heads of "
        f"{cfg.head_dim}, {n_params} parameters, random weights and engine "
        f"in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(6)
    T = cfg.n_positions
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro * gas, T),
                                       dtype=np.int32)}

    def plain(p, mb):
        return model.loss_fn(p, mb, reference_attention=True)
    counts = _train_model_run(preset, model, engine, batch, micro, gas,
                              micro * gas * T, plain)
    n = TRAIN_STEPS * gas
    check(counts["flash_attention_fwd"] == 2 * L * n,
          f"train: flash forward launched {counts['flash_attention_fwd']} "
          f"times, expected {2 * L * n} ({L} layers x 2 with remat x {n} "
          f"micro-batches)")
    for k in _BWD_KERNELS:
        check(counts[k] == L * n,
              f"train: {k} launched {counts[k]} times, expected {L * n}")
    for k in _PAGED_KERNELS[1:]:
        check(counts[k] == 0, f"train: decode kernel {k} launched")
    # one micro-batch of 2 sequences from the trained weights
    mb = {"input_ids": torch.as_tensor(batch["input_ids"][:2],
                                       device="cuda")}
    _grad_oracle(preset, model.loss_fn, plain, engine.params, mb,
                 [f"h_{i}.attn.c_attn.kernel" for i in range(L)])
    if observe:
        _train_observed(preset, engine, batch)
    del engine
    torch.cuda.empty_cache()
    if observe:
        _act_ckpt_check(preset)
    return counts


OBSERVE_STEPS = 2
GOODPUT_TOL = 0.05        # the device bucket against CUDA events, relative
GOODPUT_ABS_S = 0.002     # ... and absolute
BLOCK_SQ_TOL = 1e-3       # sum of block grad norms^2 against the global's


def _goodput_step(engine, batch):
    """One ``train_batch`` between two CUDA events: its metrics, the
    caller's wall, the events' seconds and the goodput meter's buckets
    for the step (its snapshot's change)."""
    g0 = engine.goodput.snapshot()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t = time.perf_counter()
    ev[0].record()
    m = engine.train_batch(batch)
    ev[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    g1 = engine.goodput.snapshot()
    step = {k: g1[k] - g0[k] for k in ("wall_s", "data_wait_s", "device_s",
                                       "host_s")}
    return m, wall, ev[0].elapsed_time(ev[1]) / 1e3, step


def _goodput_hbm_check(tag, obs):
    """In-HBM steps from ``_goodput_step``: the device bucket against the
    CUDA events, host above 0, the wall inside the caller's."""
    for _, wall, ev_s, g in obs:
        check(abs(g["device_s"] - ev_s) <= GOODPUT_TOL * ev_s + GOODPUT_ABS_S
              and g["host_s"] > 0 and 0 < g["wall_s"] <= wall,
              f"{tag}: goodput {g} against CUDA events {ev_s} s and the "
              f"caller's wall {wall} s")


def _train_observed(tag, engine, batch):
    """Two steps with numerics and goodput on, then two with both off:
    each observed step's device bucket against CUDA events around the
    step (the engine syncs at its end, so the events span dispatch to
    the results), its host bucket above 0 (the measured device interval
    ends inside the wall: a bucket capped at the wall leaves host 0), its
    wall inside the caller's; the blocks' squared grad norms against the
    global grad norm's square, no block with a non-finite gradient; the
    step times with and without."""
    engine.set_numerics_enabled(True)
    engine.set_goodput_enabled(True)
    obs = [_goodput_step(engine, batch) for _ in range(OBSERVE_STEPS)]
    engine.set_numerics_enabled(False)
    engine.set_goodput_enabled(False)
    off = [_goodput_step(engine, batch)[1] for _ in range(OBSERVE_STEPS)]
    snap = engine.numerics.snapshot()["last"]
    blocks = snap["blocks"]
    gsq = sum(b["grad_norm"] ** 2 for b in blocks)
    gn = float(obs[-1][0]["grad_norm"])
    rel = abs(gsq - gn * gn) / (gn * gn)
    bad = [b["block"] for b in blocks if b["nonfinite"]]
    log(f"[train] {tag}: {OBSERVE_STEPS} steps with numerics and goodput "
        f"on, ms {[o[1] * 1e3 for o in obs]!r}, then off, ms "
        f"{[w * 1e3 for w in off]!r}; goodput by step (s) "
        f"{[o[3] for o in obs]!r} against CUDA events around each step "
        f"{[o[2] for o in obs]!r} s (tol {GOODPUT_TOL} + {GOODPUT_ABS_S} "
        f"s); {len(blocks)} blocks, sum of squared block grad norms "
        f"{gsq!r} against the global {gn!r}^2 (relative {rel!r}, tol "
        f"{BLOCK_SQ_TOL}); blocks with non-finite gradients {bad}; "
        f"largest update ratio {max(b['update_ratio'] for b in blocks)!r}")
    _goodput_hbm_check(tag, obs)
    check(rel <= BLOCK_SQ_TOL, f"{tag}: block grad norms^2 {gsq} against "
          f"{gn}^2")
    check(not bad, f"{tag}: non-finite gradients in {bad}")


def _act_ckpt_check(preset):
    """``deepspeed_tpu_torch.checkpointing.checkpoint`` over two blocks of
    ``preset`` at full width, ``cpu_checkpointing`` off and on: the
    gradients of the input and the blocks' weights equal a plain
    recompute's (``torch.utils.checkpoint``) bit for bit; the device
    bytes each holds between its forward and its backward (the region's
    input is an intermediate the caller drops: on the card it is the
    checkpoint, with cpu_checkpointing it is in pinned host memory, so
    fewer are held) and its device peak."""
    from deepspeed_tpu_torch import checkpointing
    from deepspeed_tpu_torch.models.gpt2 import (GPT2LMModel, _run_block,
                                                 config_for)
    cfg = config_for(preset, n_layer=2)
    model = GPT2LMModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(4))
    mod = model.module
    keys = mod._block_keys
    blocks = [(mod.get_submodule(f"h_{i}"),
               {n: params[f"h_{i}.{n}"].requires_grad_(True) for n in keys})
              for i in range(2)]
    weights = [w for _, bp in blocks for w in bp.values()]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x0 = torch.randn((8, cfg.n_positions, cfg.n_embd), generator=gen,
                     device="cuda", dtype=cfg.dtype)

    def two(x):
        for blk, bp in blocks:
            x = _run_block(blk, bp, x, False)
        return x
    runs = {}
    # phase train's steps made cuBLAS's workspaces: the three compare
    for name, ck in (("plain", None), ("off", False), ("on", True)):
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        h = x * 1.0   # the region's input: an intermediate, dropped below
        if ck is None:
            y = torch.utils.checkpoint.checkpoint(two, h,
                                                  use_reentrant=False)
        else:
            checkpointing.configure(cpu_checkpointing=ck)
            y = checkpointing.checkpoint(two, h)
        del h
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        loss = y.float().square().mean()
        grads = torch.autograd.grad(loss, [x] + weights)
        torch.cuda.synchronize()
        runs[name] = (grads, torch.cuda.max_memory_allocated() - base, held)
        del x, y, loss
    checkpointing.reset()
    same = {n: all(torch.equal(a, b) for a, b in zip(runs[n][0],
                                                     runs["plain"][0]))
            for n in ("off", "on")}
    log(f"[train] {preset} x2 blocks, 8 x {cfg.n_positions}: "
        f"checkpointing.checkpoint gradients equal a plain recompute's bit "
        f"for bit: cpu_checkpointing off {same['off']}, on {same['on']}; "
        f"device bytes held between forward and backward: plain "
        f"{runs['plain'][2]}, off {runs['off'][2]}, on {runs['on'][2]}; "
        f"device peak above the input: plain {runs['plain'][1]}, off "
        f"{runs['off'][1]}, on {runs['on'][1]} bytes")
    check(all(same.values()), f"{preset}: activation checkpointing "
          f"gradients differ from a plain recompute's: {same}")
    check(runs["on"][2] < runs["off"][2], f"{preset}: cpu_checkpointing "
          f"held {runs['on'][2]} device bytes between forward and backward, "
          f"not fewer than without it ({runs['off'][2]})")
    del runs, params, blocks, weights
    torch.cuda.empty_cache()


CKPT_STEPS = 4   # the resume oracle: steps 1-2, a save, steps 3-4
CKPT_NEW = 32    # tokens the converted model serves a prompt
# the resume oracle's and the async engine's depth: gpt2-1.3b's full width
# at 2 of its 24 layers (every gate kept; the full depth wrote 15.8 GB in
# 113-133 s of host and disk time, 4 layers 3.7 GB in ~45 s, which the
# time limit no longer affords)
CKPT_LAYERS = 2


def _ckpt_engine(cfg, seed, extra=None):
    """Phase train's engine of ``cfg`` (bf16, AdamW, clipping 1.0, micro
    8 x gas 2) from random weights seeded ``seed``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel
    model = GPT2LMModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": 8,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}},
            **(extra or {})})[0]
    del params
    torch.cuda.synchronize()
    return engine


def _ckpt_batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, cfg.vocab_size,
                                       (16, cfg.n_positions), dtype=np.int32)}
            for _ in range(n)]


def _ckpt_steps(name, engine, batches, L):
    """``train_batch`` on each batch, a main-path run: the counts are set
    to 0 just before and read just after, and held to phase train's
    (forward 2 x L a micro-batch under remat, dq and dk/dv L)."""
    _launch_counts(reset=True)
    metrics = [engine.train_batch(b) for b in batches]
    torch.cuda.synchronize()
    counts = _launch_counts()
    n = 2 * len(batches)
    check(counts["flash_attention_fwd"] == 2 * L * n,
          f"{name}: flash forward launched {counts['flash_attention_fwd']} "
          f"times, expected {2 * L * n}")
    for k in _BWD_KERNELS:
        check(counts[k] == L * n,
              f"{name}: {k} launched {counts[k]} times, expected {L * n}")
    for k in _PAGED_KERNELS[1:]:
        check(counts[k] == 0, f"{name}: decode kernel {k} launched")
    losses = [float(m["loss"]) for m in metrics]
    check(all(math.isfinite(x) for x in losses),
          f"{name}: non-finite loss {losses}")
    return losses, counts


class _StageTimer:
    """Wall seconds spent in named functions while active: each target
    ``(owner, attribute, stage)`` is wrapped in place and restored on
    exit."""

    def __init__(self, *targets):
        self.targets, self.s = targets, {t[2]: 0.0 for t in targets}

    def __enter__(self):
        self.saved = [getattr(o, a) for o, a, _ in self.targets]
        for (owner, attr, stage), fn in zip(self.targets, self.saved):
            def timed(*a, _fn=fn, _stage=stage, **k):
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.s[_stage] += time.perf_counter() - t
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for (owner, attr, _), fn in zip(self.targets, self.saved):
            setattr(owner, attr, fn)


def _gbps(nbytes, s):
    return nbytes / s / 1e9 if s > 0 else float("inf")


def _ckpt_resume(save_dir):
    """The resume oracle at gpt2-1.3b's full width and CKPT_LAYERS of its
    24 layers: run A takes 4 steps; run B takes steps 1-2 from the same
    weights, saves (sync, verified) and is destroyed; run C starts from
    other weights, loads and takes steps 3-4. Returns (launch counts by
    run, engine C, its config, the tag's bytes)."""
    from deepspeed_tpu_torch.checkpoint import checkpoint_engine as ce_mod
    from deepspeed_tpu_torch.checkpoint.integrity import dir_bytes
    from deepspeed_tpu_torch.models.gpt2 import config_for
    from deepspeed_tpu_torch.runtime import checkpointing as ck
    cfg = config_for("gpt2-1.3b", n_layer=CKPT_LAYERS)
    L = cfg.n_layer
    batches = _ckpt_batches(cfg, CKPT_STEPS, 15)
    runs = {}
    a = _ckpt_engine(cfg, 0)
    losses_a, runs["checkpoint run A"] = _ckpt_steps("checkpoint run A", a,
                                                     batches, L)
    master_a = {k: v.detach().clone() for k, v in a.master.items()}
    del a
    torch.cuda.empty_cache()

    b = _ckpt_engine(cfg, 0)
    losses_b, runs["checkpoint run B"] = _ckpt_steps(
        "checkpoint run B", b, batches[:2], L)
    check(losses_b == losses_a[:2],
          f"checkpoint: run B's losses {losses_b} are not run A's "
          f"{losses_a[:2]}")
    with _StageTimer((ce_mod.TorchCheckpointEngine, "save", "write"),
                     (ck, "write_manifest", "hash"),
                     (ck, "verify_checkpoint", "verify")) as sv:
        t = time.perf_counter()
        b.save_checkpoint(save_dir)
        save_s = time.perf_counter() - t
    b.destroy()
    del b
    torch.cuda.empty_cache()
    tag = os.path.join(save_dir, "global_step2")
    nbytes = dir_bytes(tag)
    files = {os.path.relpath(os.path.join(d, f), tag): os.path.getsize(
        os.path.join(d, f)) for d, _, fs in os.walk(tag) for f in fs}

    c = _ckpt_engine(cfg, 1)   # other weights: a load that does nothing fails
    first = next(iter(master_a))
    check(not torch.equal(c.master[first], master_a[first]),
          "checkpoint: run C starts from run A's weights")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with _StageTimer((ck, "verify_checkpoint", "verify"),
                     (type(c), "_load_checkpoint_state", "restore")) as ld:
        t = time.perf_counter()
        c.load_checkpoint(save_dir)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    extra = torch.cuda.max_memory_allocated() - before
    check(c.global_steps == 2 and c._micro_steps == 4,
          f"checkpoint: loaded counters {c.global_steps}, {c._micro_steps}")
    losses_c, runs["checkpoint run C"] = _ckpt_steps(
        "checkpoint run C", c, batches[2:], L)
    diff = [k for k in master_a if not torch.equal(c.master[k], master_a[k])]
    worst = max((float((c.master[k] - master_a[k]).abs().max())
                 for k in diff), default=0.0)
    log(f"[checkpoint] gpt2-1.3b x{L} resume: losses run A {losses_a!r}, "
        f"run C "
        f"(steps 3-4 after the load) {losses_c!r}; master leaves that "
        f"differ from run A's: {len(diff)} of {len(master_a)} (max |diff| "
        f"{worst!r}); global_steps {c.global_steps}")
    check(losses_c == losses_a[2:],
          f"checkpoint: resumed losses {losses_c} != uninterrupted "
          f"{losses_a[2:]}")
    check(not diff, f"checkpoint: master leaves differ after the resume: "
          f"{diff[:5]} (max |diff| {worst})")
    check(c.global_steps == CKPT_STEPS,
          f"checkpoint: global_steps {c.global_steps} != {CKPT_STEPS}")
    state = sum(n for f, n in files.items() if f.startswith("state"))
    log(f"[checkpoint] gpt2-1.3b x{L} tag global_step2: {nbytes} bytes "
        f"({files}); save {save_s!r} s ({_gbps(nbytes, save_s)!r} GB/s): "
        f"state write {sv.s['write']!r} s ({_gbps(state, sv.s['write'])!r} "
        f"GB/s), "
        f"manifest hash {sv.s['hash']!r} s ({_gbps(nbytes, sv.s['hash'])!r}"
        f" GB/s), shallow verify {sv.s['verify']!r} s; load {load_s!r} s "
        f"({_gbps(nbytes, load_s)!r} GB/s): deep verify {ld.s['verify']!r} "
        f"s ({_gbps(nbytes, ld.s['verify'])!r} GB/s), read and copy to the "
        f"card {ld.s['restore']!r} s ({_gbps(nbytes, ld.s['restore'])!r} "
        f"GB/s); the load's peak device memory above the engine's {extra} "
        f"bytes")
    del master_a
    return runs, c, cfg, nbytes


def _ckpt_serve(engine, icfg, path):
    """The converted model served: ``generate`` of 8 seeded prompts x 32
    greedy tokens through B1 and B4 (a main-path run), the served-token
    oracle, then a serving checkpoint saved and loaded into a fresh engine
    that must serve the same tokens and the same prefill logits."""
    from deepspeed_tpu_torch.checkpoint.integrity import dir_bytes
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import (load_serving_checkpoint,
                                                      save_serving_checkpoint)
    L = icfg.n_layer
    rng = np.random.default_rng(16)
    lens = rng.integers(64, 900, 8)
    prompts = [rng.integers(0, icfg.vocab_size, n).tolist() for n in lens]
    engine.generate(prompts[:1], max_new_tokens=2)   # warm-up
    _launch_counts(reset=True)
    t = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=CKPT_NEW)
    gen_s = time.perf_counter() - t
    counts = _launch_counts()
    check(counts["flash_attention_fwd"] == L,
          f"checkpoint serve: flash launches {counts['flash_attention_fwd']}"
          f" != {L} (one prefill)")
    check(counts["decode_attention"] == L * (CKPT_NEW - 1),
          f"checkpoint serve: decode launches {counts['decode_attention']} "
          f"!= {L} x {CKPT_NEW - 1} steps")
    for b, row in enumerate(out):
        check(len(row) == lens[b] + CKPT_NEW and row[:lens[b]] == prompts[b]
              and all(0 <= x < icfg.vocab_size for x in row[lens[b]:]),
              f"checkpoint serve: row {b} malformed")
    rows = [int(np.argmin(lens)), int(np.argmax(lens))]
    _serve_oracle(engine, f"checkpoint trained gpt2-1.3b x{L}",
                  [prompts[r] for r in rows], [out[r] for r in rows],
                  CKPT_NEW)
    t = time.perf_counter()
    save_serving_checkpoint(engine, path)
    save_s = time.perf_counter() - t
    nbytes = dir_bytes(path)
    t = time.perf_counter()
    back = load_serving_checkpoint(path, DeepSpeedInferenceConfig(
        dtype="bfloat16", max_out_tokens=icfg.n_positions))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    out2 = back.generate(prompts, max_new_tokens=CKPT_NEW)
    check(out2 == out, "checkpoint serve: the reloaded serving checkpoint "
          "serves other tokens")
    ids = np.zeros((8, int(lens.max())), np.int64)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    same = torch.equal(engine.forward(ids), back.forward(ids))
    check(same, "checkpoint serve: prefill logits differ after the serving "
          "checkpoint round trip")
    log(f"[checkpoint] trained gpt2-1.3b x{L} served: generate 8 x "
        f"{CKPT_NEW} "
        f"tokens in {gen_s!r} s, launches {counts}; serving checkpoint "
        f"{nbytes} bytes, save {save_s!r} s ({_gbps(nbytes, save_s)!r} "
        f"GB/s), load {load_s!r} s ({_gbps(nbytes, load_s)!r} GB/s); "
        f"tokens identical after the round trip, prefill logits bit for "
        f"bit {same}")
    return {"checkpoint serve": counts}


def _ckpt_async(save_dir):
    """The async engine at gpt2-1.3b's width and CKPT_LAYERS: save at step 2,
    take steps 3-4 while the write may still run, then ``destroy`` joins;
    a fresh engine loads the step-2 state bit for bit."""
    from deepspeed_tpu_torch.checkpoint.integrity import verify_checkpoint
    from deepspeed_tpu_torch.models.gpt2 import config_for
    cfg = config_for("gpt2-1.3b", n_layer=CKPT_LAYERS)
    L = cfg.n_layer
    batches = _ckpt_batches(cfg, CKPT_STEPS, 17)
    async_cfg = {"checkpoint": {"engine": "async"}}
    e = _ckpt_engine(cfg, 0, async_cfg)
    t = time.perf_counter()
    _, first = _ckpt_steps("checkpoint async steps 1-2", e, batches[:2], L)
    first_s = time.perf_counter() - t
    at_save = {k: v.detach().clone() for k, v in e.master.items()}
    t = time.perf_counter()
    e.save_checkpoint(save_dir)
    ret_s = time.perf_counter() - t
    t = time.perf_counter()
    _, counts = _ckpt_steps("checkpoint async steps 3-4", e, batches[2:], L)
    steps_s = time.perf_counter() - t
    at_4 = {k: v.detach().clone() for k, v in e.master.items()}
    t = time.perf_counter()
    e.destroy()
    join_s = time.perf_counter() - t
    with open(os.path.join(save_dir, "latest")) as f:
        latest = f.read().strip()
    tag = os.path.join(save_dir, "global_step2")
    check(latest == "global_step2" and verify_checkpoint(tag)[0],
          f"checkpoint async: latest {latest!r} or its manifest is wrong")
    f_ = _ckpt_engine(cfg, 1, async_cfg)
    f_.load_checkpoint(save_dir)
    torch.cuda.synchronize()
    same = all(torch.equal(f_.master[k], v) for k, v in at_save.items())
    moved = any(not torch.equal(at_4[k], v) for k, v in at_save.items())
    check(same and moved and f_.global_steps == 2,
          f"checkpoint async: the loaded state is not the step-2 state "
          f"(equal {same}, steps 3-4 moved the master {moved}, "
          f"global_steps {f_.global_steps})")
    f_.destroy()
    log(f"[checkpoint] async, gpt2-1.3b width at {L} layers: steps 1-2 took "
        f"{first_s!r} s; save returned after {ret_s!r} s (host snapshot), "
        f"steps 3-4 took {steps_s!r} s while the write ran, destroy joined "
        f"in {join_s!r} s; the loaded state equals step 2's bit for bit")
    return {"checkpoint async steps 1-2": first,
            "checkpoint async steps 3-4": counts}


def phase_checkpoint():
    """Train, save a verified checkpoint, resume, convert to serving
    weights, save a serving checkpoint, load it and serve; then the async
    engine. Everything is written under a temporary directory of the
    checkout's ``build/`` that is removed at the end. Returns the launch
    counts of its main-path runs by name."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.module_inject import gpt2_to_inference
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    du = shutil.disk_usage(root)
    log(f"[checkpoint] disk under {root}: {du.free} of {du.total} bytes "
        f"free")
    tmp = tempfile.mkdtemp(prefix="ckpt_smoke_", dir=root)
    try:
        runs, c, cfg, _ = _ckpt_resume(os.path.join(tmp, "train"))
        shutil.rmtree(os.path.join(tmp, "train"))
        icfg, ip = gpt2_to_inference(cfg, c.params, torch.bfloat16)
        c.destroy()
        del c
        torch.cuda.empty_cache()
        engine = deepspeed_tpu_torch.init_inference(
            (icfg, ip), dtype="bfloat16", max_out_tokens=icfg.n_positions)
        del ip
        runs.update(_ckpt_serve(engine, icfg, os.path.join(tmp, "serving")))
        del engine
        torch.cuda.empty_cache()
        runs.update(_ckpt_async(os.path.join(tmp, "async")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return runs


# phase offload: llama-7b-gqa at 20 of its 32 layers, whose in-HBM state
# (bf16 params, f32 master, mu, nu, grads: 18 bytes a parameter) exceeds
# the card; the optimizer state goes to the host (12 bytes a parameter).
# 20 layers, not 24, keep chip_smoke.py inside its time: the engine init's
# host copying and zeroing scales with the depth
OFFLOAD_LLAMA = ("llama-7b-gqa", {"n_layer": 20}, 2, 1, 4096, 4624388096)
OFFLOAD_STEPS = 2
OFFLOAD_GPT2_LAYERS = 2     # gpt2-1.3b's width, the four engines
OFFLOAD_GPT2_STEPS = 3
# the C++ step against ops/adam.py on the same grads: the largest
# difference over the largest update of the leaf (the two order their f32
# arithmetic differently: a few ulps of the master against an update of
# ~lr)
OFFLOAD_ADAM_TOL = 1e-3
# host against in-HBM after OFFLOAD_GPT2_STEPS: losses to TRAIN_LOSS_TOL
# relative, each leaf's update of the master to this relative L2 (the key
# third of c_attn.bias, whose exact gradient is zero, to Adam's bound)
OFFLOAD_UPDATE_TOL = 5e-2


class _HostRss:
    """The process's resident set, sampled every 20 ms on a thread while
    active (``/proc/self/statm``): ``peak`` bytes."""

    def __init__(self):
        import threading
        self.peak, self._stop = 0, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def now() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.now())
            self._stop.wait(0.02)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.now())


def _zero_engine(model, params, micro, gas, zero, extra=None):
    """Phase train's engine (bf16, AdamW lr 1e-4, weight decay 0.01,
    clipping 1.0) with a ``zero_optimization`` section."""
    import deepspeed_tpu_torch
    engine = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config={
            "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
            "bf16": {"enabled": True}, "zero_optimization": zero,
            "optimizer": {"type": "AdamW",
                          "params": {"lr": 1e-4, "weight_decay": 0.01}},
            **(extra or {})})[0]
    torch.cuda.synchronize()
    return engine


def _adam_gate(tag, engine, name, master0, lr):
    """The host master of leaf ``name`` after the first step against the
    port's device AdamW (``ops/adam.py``) applied to the same (clipped)
    gradient from the same master; returns the relative error."""
    from deepspeed_tpu_torch.ops.adam import AdamState, adam
    g = engine._acc[engine._index[name]].detach()
    m0 = master0.to("cuda", non_blocking=True).reshape(g.shape)
    opt = adam(weight_decay=0.01)
    state = AdamState(count=0, mu={name: torch.zeros_like(m0)},
                      nu={name: torch.zeros_like(m0)})
    upd, _ = opt.update({name: g}, state, {name: m0}, lr)
    want = m0 + upd[name]
    got = engine.host_opt.master[name].to("cuda").reshape(g.shape)
    err = float((got - want).abs().max())
    scale = float(upd[name].abs().max())
    rel = err / scale
    log(f"[offload] {tag}: step 1's host master of {name} {tuple(g.shape)} "
        f"against ops/adam.py on the same gradient: max |diff| {err!r}, "
        f"largest update {scale!r}, relative {rel!r} (tol "
        f"{OFFLOAD_ADAM_TOL})")
    check(rel <= OFFLOAD_ADAM_TOL,
          f"{tag}: host Adam of {name} off by {rel} of the update")
    return rel


def _offload_llama(smi):
    """(i) llama-7b-gqa at 20 of 32 layers with offload_optimizer host:
    the estimate, two steps with their split, the Adam gate, the bf16
    params against the host master, B3 at R = 4."""
    from deepspeed_tpu_torch.models import llama as llama_mod
    from deepspeed_tpu_torch.runtime.zero import \
        estimate_zero_model_states_mem_needs
    name, over, micro, gas, T, n_params = OFFLOAD_LLAMA
    cfg = llama_mod.config_for(name, **over)
    L = cfg.n_layer
    model = llama_mod.LlamaLMModel(cfg)
    total = torch.cuda.get_device_properties(0).total_memory
    shapes = {n: p.shape for n, p in model.module.named_parameters()}
    n = sum(math.prod(s) for s in shapes.values())
    largest = max(math.prod(s) for s in shapes.values())
    check(n == n_params, f"{name} x{L}: {n} parameters, expected {n_params}")
    est = {off: estimate_zero_model_states_mem_needs(
        n, largest, stage=1, offload_optimizer=off) for off in (False, True)}
    log(f"[offload] {name} x{L}: {n} parameters (largest leaf {largest}); "
        f"estimate_zero_model_states_mem_needs stage 1: in HBM "
        f"{est[False]}, offload_optimizer {est[True]}; the card holds "
        f"{total} bytes")
    check(est[False]["hbm_per_chip"] > total,
          f"{name} x{L}: the in-HBM estimate {est[False]} fits the card's "
          f"{total} bytes")
    rng = np.random.default_rng(22)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (micro * gas, T),
                                       dtype=np.int32)}
    with _HostRss() as rss:
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(22))
        engine = _zero_engine(model, params, micro, gas, {
            "stage": 1, "offload_optimizer": {"device": "cpu",
                                              "implementation": "host"}})
        del params
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        check(engine.host_opt is not None and engine.master is None,
              f"{name}: the optimizer state is not on the host")
        gated = ("layers_0.attn.wq.kernel", "embed")
        master0 = {k: engine.host_opt.master[k].clone() for k in gated}
        rss_init = _HostRss.now()
        torch.cuda.reset_peak_memory_stats()
        _launch_counts(reset=True)
        metrics, walls, times = [], [], []
        for step in range(OFFLOAD_STEPS):   # THE main path
            t = time.perf_counter()
            metrics.append(engine.train_batch(batch))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            times.append(dict(engine.offload_step_times))
            if step == 0:   # launches no kernel of the table
                rels = [_adam_gate(f"{name} x{L}", engine, k, master0[k],
                                   float(metrics[0]["lr"])) for k in gated]
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    gnorms = [float(m["grad_norm"]) for m in metrics]
    check(all(math.isfinite(x) for x in losses + gnorms),
          f"{name} x{L} offload: non-finite loss or grad norm {losses} "
          f"{gnorms}")
    k = OFFLOAD_STEPS * gas
    check(counts["flash_attention_fwd"] == 2 * L * k,
          f"{name} x{L} offload: flash forward launched "
          f"{counts['flash_attention_fwd']} times, expected {2 * L * k}")
    for kk in _BWD_KERNELS:
        check(counts[kk] == L * k,
              f"{name} x{L} offload: {kk} launched {counts[kk]} times, "
              f"expected {L * k} (B3 sums {cfg.n_head // cfg.n_kv_head} "
              f"query heads into each KV head)")
    # the bf16 params on the card are the RNE cast of the host master
    t = time.perf_counter()
    bad = [k for k, p in engine.params.items() if not torch.equal(
        p.detach(), engine.host_opt.master[k].to(
            "cuda", non_blocking=True).reshape(p.shape).to(torch.bfloat16))]
    cmp_s = time.perf_counter() - t
    check(not bad, f"{name} x{L} offload: bf16 params differ from the host "
          f"master's cast: {bad[:5]}")
    tokens = micro * gas * T
    log(f"[offload] {name} x{L}, offload_optimizer host, {micro} x {gas} x "
        f"T {T}: random weights and engine in {init_s!r} s (host RSS "
        f"{rss_init} bytes after); steps {[w * 1e3 for w in walls]!r} ms "
        f"({[tokens / w for w in walls]!r} tokens/s); split by step "
        f"{times!r} (device_s: forward and backward until the gradients "
        f"are final; d2h_s and h2d_s: the copy streams' busy seconds; "
        f"adam_s: the host Adam; wait_s: the host's waits for gradient "
        f"chunks; tail_s: the last payload copies; total_s: the optimizer "
        f"step); losses {losses!r}; grad norms {gnorms!r}; device peak "
        f"{peak} bytes (estimate {est[True]['hbm_per_chip']}); host RSS "
        f"peak {rss.peak} bytes; Adam gates {rels!r}; all {len(engine.params)}"
        f" bf16 params equal the host master's RNE cast ({cmp_s!r} s); "
        f"launches {counts}; {smi}")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {f"offload {name} x{L}": counts}


# (b)'s tag is not hashed: phase checkpoint holds the manifest's gates
UNVERIFIED = {"checkpoint": {"verify": False}}


def _moments(engine):
    """The host optimizer's moments, flat, copied (read from the swap
    files on the NVMe tier)."""
    h = engine.host_opt
    return {k: {p: t.clone() for p, t in h.moments(k).items()}
            for k in h.keys}


def _offload_gpt2_runs(save_dir):
    """(ii) gpt2-1.3b at OFFLOAD_GPT2_LAYERS layers: six engines over the
    same batches from the same weights; a checkpoint of (b) at step 2.
    (e) and (f) are (b) and (d) with the NVMe tier (swap files beside
    ``save_dir``) and goodput on: each equals its twin bit for bit. (a)
    arms numerics and goodput for step 2 and takes step 3 with both off;
    (c), which never arms them, must still equal it bit for bit."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    cfg = config_for("gpt2-1.3b", n_layer=OFFLOAD_GPT2_LAYERS)
    L = cfg.n_layer
    batches = _ckpt_batches(cfg, OFFLOAD_GPT2_STEPS, 23)
    host = {"device": "cpu", "implementation": "host"}
    swap = os.path.join(os.path.dirname(save_dir), "swap")
    nvme_opt = {"device": "nvme", "nvme_path": os.path.join(swap, "e"),
                "implementation": "host"}
    nvme_par = {"device": "nvme", "nvme_path": os.path.join(swap, "f")}
    goodput = {"telemetry": {"goodput": True}}
    engines = {
        "a in-HBM": ({"stage": 0}, False),
        "b host": ({"stage": 1, "offload_optimizer": host}, False),
        "c stream": ({"stage": 1, "offload_optimizer": {
            "device": "cpu", "implementation": "stream"}}, False),
        "d stage 3 param+host": ({"stage": 3, "offload_optimizer": host,
                                  "offload_param": {"device": "cpu"}}, True),
        "e host nvme": ({"stage": 1, "offload_optimizer": nvme_opt}, False),
        "f stage 3 param nvme+host": ({"stage": 3, "offload_optimizer": host,
                                       "offload_param": nvme_par}, True)}
    out, runs = {}, {}
    init = None
    for tag, (zero, fetch) in engines.items():
        model = GPT2LMModel(dataclasses.replace(cfg, offload_params=fetch))
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        if init is None:
            init = {k: v.detach().cpu() for k, v in params.items()}
        engine = _zero_engine(model, params, 8, 2, zero,
                              UNVERIFIED if tag == "b host" else
                              goodput if tag[0] in "ef" else None)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _launch_counts(reset=True)
        losses, walls, times, gsteps = [], [], [], []
        for i, b in enumerate(batches):   # THE main path
            if tag[0] == "a":
                engine.set_numerics_enabled(i == 1)
                engine.set_goodput_enabled(i == 1)
            step = _goodput_step(engine, b)
            losses.append(float(step[0]["loss"]))
            walls.append(step[1])
            times.append(dict(engine.offload_step_times))
            gsteps.append(step[1:] + (getattr(engine, "_param_in_s", 0.0),))
            if tag == "b host" and i == 1:
                t_save = time.perf_counter()
                engine.save_checkpoint(save_dir)
                t_save = time.perf_counter() - t_save
        counts = runs[f"offload gpt2-1.3b x{L} {tag}"] = _launch_counts()
        n = 2 * len(batches)
        check(counts["flash_attention_fwd"] == 2 * L * n and all(
            counts[k] == L * n for k in _BWD_KERNELS),
            f"offload gpt2 {tag}: launches {counts}")
        check(all(math.isfinite(x) for x in losses),
              f"offload gpt2 {tag}: losses {losses}")
        on_host = all(p.device.type == "cpu" for p in engine.params.values())
        on_disk = all(p.device.type == "meta"
                      for p in engine.params.values())
        out[tag] = {"losses": losses,
                    "master": engine.fp32_master_params(),
                    "params": {k: v.detach().cpu() for k, v in
                               engine.module_state_dict().items()},
                    "moments": (_moments(engine) if engine.host_opt
                                is not None and tag[0] in "bdef" else None),
                    "peak": torch.cuda.max_memory_allocated(),
                    "walls": walls, "times": times}
        log(f"[offload] gpt2-1.3b x{L} ({tag}): losses {losses!r}; steps "
            f"{[w * 1e3 for w in walls]!r} ms; split {times!r}; device peak "
            f"{out[tag]['peak']} bytes; params on the host between steps "
            f"{on_host}; launches {counts}")
        if tag.startswith("d"):
            check(on_host and all(p.is_pinned()
                                  for p in engine.params.values()),
                  "offload gpt2 (d): the params are not in pinned host "
                  "memory between steps")
        if tag[0] == "a":
            _goodput_hbm_check("offload gpt2 (a)", [(None,) + gsteps[1][:3]])
        if tag[0] in "ef":
            _nvme_log(tag, engine, times, on_disk, L, gsteps)
        del engine, model
        gc.collect()
        torch.cuda.empty_cache()
    # the checkpoint of (b) at step 2, resumed from other weights
    model = GPT2LMModel(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    engine = _zero_engine(model, params, 8, 2, engines["b host"][0],
                          UNVERIFIED)
    del params
    t = time.perf_counter()
    engine.load_checkpoint(save_dir)
    load_s = time.perf_counter() - t
    _launch_counts(reset=True)
    loss3 = float(engine.train_batch(batches[2])["loss"])
    torch.cuda.synchronize()
    runs[f"offload gpt2-1.3b x{L} b resumed"] = _launch_counts()
    b = out["b host"]
    same_master = all(torch.equal(engine.host_opt.master[k].reshape(v.shape),
                                  v) for k, v in b["master"].items())
    log(f"[offload] gpt2-1.3b x{L} (b) checkpoint at step 2: save "
        f"{t_save!r} s, load {load_s!r} s; step 3 after the load {loss3!r} "
        f"against {b['losses'][2]!r}; host master after it equal {same_master}")
    check(loss3 == b["losses"][2] and same_master,
          f"offload gpt2 (b): the resumed step 3 ({loss3}) is not the "
          f"uninterrupted one ({b['losses'][2]}), master equal {same_master}")
    del engine, model
    # the gates
    a, c, d = out["a in-HBM"], out["c stream"], out["d stage 3 param+host"]
    check(c["losses"] == a["losses"] and all(
        torch.equal(c["master"][k], v) and torch.equal(c["params"][k],
                                                       a["params"][k])
        for k, v in a["master"].items()),
        f"offload gpt2: stream is not the in-HBM path, which armed "
        f"numerics and goodput for step 2, bit for bit "
        f"({c['losses']} against {a['losses']})")
    rel_loss = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                         a["losses"]))
    # the key third of c_attn.bias has an exact gradient of zero (a bias
    # on every key shifts a row's scores by one constant), so both
    # engines move it by rounding noise: it is held to Adam's bound only
    C, key_max = cfg.n_embd, 0.0
    rel_upd = {}
    for k, am in a["master"].items():
        bm, da = b["master"][k], a["master"][k] - init[k]
        if k.endswith("c_attn.bias"):
            key_max = max(key_max, float((bm[C:2 * C] - init[k][C:2 * C])
                                         .abs().max()))
            keep = torch.cat([torch.arange(C), torch.arange(2 * C, 3 * C)])
            bm, am, da = bm[keep], am[keep], da[keep]
        rel_upd[k] = float((bm - am).norm() / da.norm().clamp_min(1e-30))
    top = sorted(rel_upd, key=rel_upd.get, reverse=True)[:3]
    bound = OFFLOAD_GPT2_STEPS * 1e-4 * 1.01
    log(f"[offload] gpt2-1.3b x{L}: (b) host against (a) in-HBM: losses "
        f"within {rel_loss!r} relative (tol {TRAIN_LOSS_TOL}); updates of "
        f"the master within {[(k, rel_upd[k]) for k in top]!r} relative L2 "
        f"at worst, mean {float(np.mean(list(rel_upd.values())))!r} (tol "
        f"{OFFLOAD_UPDATE_TOL}); the key third of c_attn.bias moved at most "
        f"{key_max!r} (Adam's bound {bound!r}); (c) stream, never observed, "
        f"equals (a), observed at step 2 and not at step 3, bit for bit "
        f"(step 3's loss {a['losses'][2]!r}); (d) peak {d['peak']} against (b) {b['peak']} bytes")
    check(rel_loss <= TRAIN_LOSS_TOL and rel_upd[top[0]] <= OFFLOAD_UPDATE_TOL
          and key_max <= bound,
          f"offload gpt2: host against in-HBM: losses {rel_loss}, worst "
          f"update {top[0]} {rel_upd[top[0]]}, key bias {key_max}")
    check(d["losses"] == b["losses"] and all(
        torch.equal(d["master"][k], v) and torch.equal(d["params"][k],
                                                       b["params"][k])
        for k, v in b["master"].items()),
        f"offload gpt2: stage 3 with offload_param is not (b) bit for bit "
        f"({d['losses']} against {b['losses']})")
    check(d["peak"] < b["peak"],
          f"offload gpt2: offload_param's device peak {d['peak']} is not "
          f"below (b)'s {b['peak']}")
    for nv, twin in (("e host nvme", "b host"),
                     ("f stage 3 param nvme+host", "d stage 3 param+host")):
        x, y = out[nv], out[twin]
        same = (x["losses"] == y["losses"] and all(
            torch.equal(x["master"][k], v) and
            torch.equal(x["params"][k], y["params"][k]) and
            all(torch.equal(x["moments"][k][p], y["moments"][k][p])
                for p in ("m", "v"))
            for k, v in y["master"].items()))
        log(f"[offload] gpt2-1.3b x{L}: ({nv[0]}) against ({twin[0]}): "
            f"losses, master, moments and bf16 params equal bit for bit "
            f"{same}")
        check(same, f"offload gpt2: ({nv[0]}) is not ({twin[0]}) bit for "
              f"bit ({x['losses']} against {y['losses']})")
    return runs


def _nvme_log(tag, engine, times, on_disk, L, gsteps):
    """(e)/(f): the swap files' bytes and rates a step, and the goodput
    split of the engine's steps. Each step's device bucket (dispatch to
    the final gradients) against ``offload_step_times``' ``device_s``
    (the first backward to the same point, its own timer); the bucket
    plus the host work timed on its own (the optimizer step, the param
    swap-out, and from the second step on the swap-in) inside the wall,
    so none of that work fell in device; host above 0."""
    for i, ((wall, _, g, param_in), t) in enumerate(zip(gsteps, times)):
        timed = t["total_s"] + t.get("param_out_s", 0.0) + (
            param_in if tag[0] == "f" and i else 0.0)
        check(abs(g["device_s"] - t["device_s"]) <=
              GOODPUT_TOL * t["device_s"] + GOODPUT_ABS_S and
              g["device_s"] + timed <= g["wall_s"] <= wall and
              g["host_s"] > 0,
              f"offload gpt2 ({tag[0]}) step {i + 1}: goodput {g} against "
              f"the engine's device_s {t['device_s']} s, the host work's "
              f"{timed} s and the caller's wall {wall} s")
    g = engine.goodput.snapshot()
    t = times[-1]
    if tag[0] == "e":
        moved = t["swap_read_bytes"] + t["swap_write_bytes"]
        rate = (f"{moved} bytes of moments read and written a step, "
                f"{moved / t['total_s'] / 1e9!r} GB/s over the optimizer "
                f"step's {t['total_s']!r} s (waits for the swap files "
                f"{t['io_s']!r} s, host Adam {t['adam_s']!r} s)")
    else:
        check(on_disk, "offload gpt2 (f): the params are not on disk "
              "between steps")
        nb = t["param_bytes"]
        rate = (f"{nb} bytes of params out and in a step: swap-out "
                f"{nb / t['param_out_s'] / 1e9!r} GB/s "
                f"({t['param_out_s']!r} s), swap-in "
                f"{nb / engine._param_in_s / 1e9!r} GB/s "
                f"({engine._param_in_s!r} s); shapes only between steps "
                f"{on_disk}")
    log(f"[offload] gpt2-1.3b x{L} ({tag}): {rate}; goodput over "
        f"{g['steps']} steps: wall {g['wall_s']!r} s = data "
        f"{g['data_wait_s']!r} + device {g['device_s']!r} + host "
        f"{g['host_s']!r} s (device fraction {g['fraction']!r})")


def phase_offload(smi):
    """ZeRO-Offload on the card: (i) llama-7b-gqa at 20 of its 32 layers,
    whose in-HBM training state exceeds the card, with the optimizer state
    on the host; (ii) gpt2-1.3b's four engines. Writes its checkpoint under
    a temporary directory of the checkout's ``build/``, removed at the
    end. Returns the launch counts of its main-path runs by name."""
    import tempfile
    runs = _offload_llama(smi)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="offload_smoke_", dir=root)
    try:
        runs.update(_offload_gpt2_runs(os.path.join(tmp, "ckpt")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return runs


# phase dist: gpt2-1.3b at its width and DIST_LAYERS layers, phase train's
# configuration (bf16, AdamW, clipping 1.0, micro 8 x gas 2 x T 1024)
DIST_LAYERS = 4
DIST_STEPS = 6      # the first compiles and warms up; 5 timed
DIST_SWEEP_MB = (1, 64)


def _dist_engine(cfg, params, zero, micro=8, gas=2, mesh=None):
    """Phase train's engine with a ``zero_optimization`` section (and a
    ``mesh``) and the comms logger on."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel
    config = {"train_micro_batch_size_per_gpu": micro,
              "gradient_accumulation_steps": gas, "gradient_clipping": 1.0,
              "bf16": {"enabled": True}, "zero_optimization": zero,
              "comms_logger": {"enabled": True},
              "optimizer": {"type": "AdamW",
                            "params": {"lr": 1e-4, "weight_decay": 0.01}}}
    if mesh:
        config["mesh"] = mesh
    engine = deepspeed_tpu_torch.initialize(
        model=GPT2LMModel(cfg), model_parameters=params, config=config)[0]
    torch.cuda.synchronize()
    return engine


def _dist_steps(tag, engine, batches, L):
    """``train_batch`` on each batch, a main-path run (counts set to 0
    just before, read just after; phase train's expected launches); the
    losses, step walls, counts, whole master and params on the host."""
    from deepspeed_tpu_torch.comm import comm
    comm.comms_logger.reset()
    _launch_counts(reset=True)
    losses, walls = [], []
    for b in batches:
        t = time.perf_counter()
        losses.append(float(engine.train_batch(b)["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    counts = _launch_counts()
    comms = {k: dict(v) for k, v in comm.comms_logger.comms_dict.items()}
    n = engine.gas * len(batches)
    check(counts["flash_attention_fwd"] == 2 * L * n and all(
        counts[k] == L * n for k in _BWD_KERNELS),
        f"dist {tag}: launches {counts}")
    check(all(math.isfinite(x) for x in losses),
          f"dist {tag}: losses {losses}")
    return {"losses": losses, "walls": walls, "counts": counts,
            "comms": comms, "master": engine.fp32_master_params(),
            "params": engine.module_state_dict()}


# two ranks on the one card over gloo (NCCL refuses two ranks on a device;
# gloo takes CUDA tensors in every collective the engine makes:
# scripts/probe_gloo_cuda.py) at DIST_GLOO_LAYERS, DIST_GLOO_STEPS, each
# rank micro 2 x gas 1 of the 1-rank run's micro 4 rows (gloo moves CUDA
# tensors through pinned host memory and TCP: ~0.65 GB/s); held to the CPU
# parity test's bf16 tolerances (tests/test_torch_dist_parity.py)
DIST_GLOO_LAYERS = 2
DIST_GLOO_STEPS = 2
DIST_GLOO_LOSS_TOL = 1e-2      # relative
DIST_GLOO_UPDATE_TOL = 0.1     # relative L2 of each leaf's update
DIST_GLOO_DEADLINE = 420       # seconds from the ranks' start
# (e)-(h): the same two ranks go on. (e) the Mistral-7B-v0.2 layout of
# phase hf at full width and depth (32 heads of 128 over 8 KV heads: 16
# over 4 a rank) at tp 2 from seeded weights each rank cuts on the card:
# generate (B1, B4) and server (a) (8 slots, blocks of 128: B1, B5);
# (f) the same weights at sp 2, generate (each rank's cache holds half of
# the positions; decode attention is plain torch there, as JAX's einsum);
# (g) gpt2-1.3b x DIST_GLOO_LAYERS at tensor 2 (8 of 16 heads a rank) and
# (h) at seq 2 (512 of 1024 positions a rank), each rank on all of (d)'s
# rows, against (d)'s one-rank run. Gloo moves every collective through
# the host: their times are not a link's.
TP_PROMPTS = 8
TP_NEW = 16
TP_CTX = 512   # (e)'s max_out_tokens
SP_CTX = 256   # (f)'s: 128 positions a rank; most prompts span both
TP_SEED = 31   # the serving weights' generator


def _gloo_mark(tmp, name):
    with open(os.path.join(tmp, name), "w"):
        pass


def _gloo_await(tmp, name):
    while not os.path.exists(os.path.join(tmp, name)):
        time.sleep(0.05)


def _tp_prompts(cfg):
    rng = np.random.default_rng(23)
    return [rng.integers(0, cfg.vocab_size, n).tolist()
            for n in rng.integers(16, 200, TP_PROMPTS)]


def _tp_generate(engine, prompts):
    """``generate`` of TP_NEW tokens a prompt, a main-path run (counts set
    to 0 just before, read just after); its decode ms per step (the wall
    of TP_NEW tokens less that of 1, over TP_NEW - 1) and peak memory."""
    def timed(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t
    if engine._cuda_graphs:
        # warm-up at the timed shape: the decode graph is made at its
        # first call and captured at its second (eager steps need none:
        # the generate of 1 token warms the prefill)
        engine.generate(prompts, max_new_tokens=3)
    _, one = timed(1)
    torch.cuda.reset_peak_memory_stats()
    _launch_counts(reset=True)
    out, wall = timed(TP_NEW)
    counts = _launch_counts()
    return {"tokens": out, "counts": counts, "wall_s": wall, "first_s": one,
            "decode_ms": (wall - one) / (TP_NEW - 1) * 1e3,
            "peak": torch.cuda.max_memory_allocated(),
            "cache": tuple(engine._kept[1].k.shape)}


def _tp_server(engine, prompts):
    """Server (a) over ``engine``: the prompts submitted at once, TP_NEW
    tokens each, drained; a main-path run."""
    from deepspeed_tpu_torch.inference import ContinuousBatchingServer
    srv = ContinuousBatchingServer(engine)
    _launch_counts(reset=True)
    t = time.perf_counter()
    ids = [srv.submit(p, max_new_tokens=TP_NEW) for p in prompts]
    res = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = _launch_counts()
    st = srv.stats
    out = {"tokens": [res[i] for i in ids], "counts": counts,
           "wall_s": wall, "prefills": st["prefills"],
           "decode_steps": st["decode_steps"],
           "garbage_steps": st["async_loop"]["garbage_steps"],
           "decode_traces": st["decode_traces"],
           "pool": tuple(srv._cache.k.shape)}
    srv.close()
    return out


def _gloo_serve(rank, tmp):
    """(e) and (f) on this rank: each engine from the seeded whole tree
    (tp 2 keeps its cut of it; the whole tree is freed), its generate and
    (e)'s server; saved under ``tmp``. (e)'s engine is built while the
    parent runs its reference; the timed runs wait for ``go_e``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import \
        init_params
    from deepspeed_tpu_torch.module_inject.quantize import tree_weight_bytes
    cfg = mistral_serving_config()
    prompts = _tp_prompts(cfg)
    out = {}
    for tag, knobs, ctx in (
            ("tp", {"tensor_parallel": {"tp_size": 2}, "num_slots": 8,
                    "block_size": 128}, TP_CTX),
            ("sp", {"sp_size": 2}, SP_CTX)):
        params = init_params(
            torch.Generator(device="cuda").manual_seed(TP_SEED), cfg)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine = deepspeed_tpu_torch.init_inference(
            (cfg, params), dtype="bf16", max_out_tokens=ctx, **knobs)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if tag == "tp":
            _gloo_mark(tmp, f"e_built{rank}")
            _gloo_await(tmp, "go_e")
        a = engine.params["layers"][0]["attn"]
        r = {"init_s": init_s, "weights": tree_weight_bytes(engine.params),
             "heads": (a["wq"].shape[1], a["wk"].shape[1]),
             "graphs": engine._cuda_graphs,
             "generate": _tp_generate(engine, prompts)}
        if tag == "tp":
            r["server"] = _tp_server(engine, prompts)
        out[tag] = r
        del engine, a
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"serve{rank}.pt"))


def _gloo_train(rank, tmp, cfg, batches):
    """(g) tensor 2 and (h) seq 2 on this rank: gpt2-1.3b from (d)'s
    seeded weights, stage 0, each rank on all of ``batches``' rows (micro
    4 x gas 1, the one-rank run's); saved under ``tmp`` (the gathered
    master on rank 0 only)."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel
    out = {}
    for tag, mesh in (("tensor", {"tensor": 2}), ("seq", {"seq": 2})):
        params = GPT2LMModel(cfg).init(
            torch.Generator(device="cuda").manual_seed(25))
        engine = _dist_engine(cfg, params, {"stage": 0}, micro=4, gas=1,
                              mesh=mesh)
        del params
        r = _dist_steps(f"gloo {tag} 2 rank {rank}", engine, batches,
                        cfg.n_layer)
        r.pop("params")
        if rank:
            r.pop("master")
        r["c_attn"] = tuple(engine.params["h_0.attn.c_attn.kernel"].shape)
        r["peak"] = torch.cuda.max_memory_allocated()
        out[tag] = r
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(tmp, f"train{rank}.pt"))


def _gloo_rank(rank, ws, tmp, cfg, batches):
    """One of the two gloo ranks. (d) stage 3 with the per-layer gather
    from seeded weights: it builds its engine, waits for the ``go`` file
    (the parent's reference run finishes first), then trains on its rows;
    rank 0 saves its losses, counts, step walls and whole master under
    ``tmp``. Then (e)-(f) after ``go_e`` and (g)-(h) after ``go_g``, each
    marking its end with a file, so that the parent's own runs never
    share the card with the ranks' timed ones."""
    import torch._dynamo  # noqa: F401 (the remat's first call imports it)
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the pinned host allocator's first use, before any timed step
    torch.empty(1, pin_memory=True)
    comm.init_distributed(store=dist.FileStore(os.path.join(tmp, "store"),
                                               ws), num_processes=ws,
                          process_id=rank, dist_backend="gloo",
                          timeout=datetime.timedelta(seconds=120))
    try:
        params = GPT2LMModel(cfg).init(
            torch.Generator(device="cuda").manual_seed(25))
        engine = _dist_engine(dataclasses.replace(cfg, offload_params=True),
                              params, {"stage": 3}, micro=2, gas=1)
        del params
        mine = [{k: v[rank * 2:(rank + 1) * 2] for k, v in b.items()}
                for b in batches]
        _gloo_await(tmp, "go")
        out = _dist_steps(f"gloo rank {rank}", engine, mine, cfg.n_layer)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "rank0.pt"))
        del engine, out
        gc.collect()
        torch.cuda.empty_cache()
        _gloo_mark(tmp, f"d{rank}")
        _gloo_serve(rank, tmp)
        _gloo_mark(tmp, f"ef{rank}")
        _gloo_await(tmp, "go_g")
        _gloo_train(rank, tmp, cfg, batches)
    finally:
        comm.destroy_process_group()


def _gloo_start(cfg, batches, root):
    """Spawn the two gloo ranks; they start (imports, the card, their
    engines) while the parent runs their reference."""
    import tempfile

    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="dist_gloo_", dir=root)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, 2, tmp, cfg, batches),
                         daemon=True) for r in range(2)]
    for p in procs:
        p.start()
    return procs, tmp, time.perf_counter()


def _gloo_wait(started, names):
    """Wait for the ranks' marker files ``names``; fails when a rank has
    exited before writing its marker or the deadline from their start
    passed."""
    procs, tmp, t0 = started
    while not all(os.path.exists(os.path.join(tmp, n)) for n in names):
        late = time.perf_counter() - t0 > DIST_GLOO_DEADLINE
        check(not late and all(p.is_alive() for p in procs),
              f"dist gloo: waiting for {names}: ranks exited "
              f"{[p.exitcode for p in procs]} (the deadline of "
              f"{DIST_GLOO_DEADLINE} s from their start passed: {late})")
        time.sleep(0.05)


def _gloo_join(started):
    procs, tmp, t0 = started
    for p in procs:
        p.join(max(1.0, DIST_GLOO_DEADLINE - (time.perf_counter() - t0)))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    check(not hung and all(p.exitcode == 0 for p in procs),
          f"dist gloo: ranks exited {[p.exitcode for p in procs]} (killed "
          f"{DIST_GLOO_DEADLINE} s after their start: {bool(hung)})")


def _gloo_against(tag, cfg, got, ref, init):
    """A gloo run's losses and each leaf's update of the whole master
    against ``ref``'s, one rank on the same rows (the CPU tests' bf16
    tolerances); the worst leaf and both numbers."""
    rel_loss = max(abs(x - y) / abs(y) for x, y in zip(got["losses"],
                                                         ref["losses"]))
    C, rel = cfg.n_embd, {}
    for k, rm in ref["master"].items():
        gm, dr = got["master"][k], rm - init[k]
        if k.endswith("c_attn.bias"):   # the key third: exact gradient 0
            keep = torch.cat([torch.arange(C), torch.arange(2 * C, 3 * C)])
            gm, rm, dr = gm[keep], rm[keep], dr[keep]
        rel[k] = float((gm - rm).norm() / dr.norm().clamp_min(1e-30))
    worst = max(rel, key=rel.get)
    check(rel_loss <= DIST_GLOO_LOSS_TOL and rel[worst] <= DIST_GLOO_UPDATE_TOL,
          f"dist gloo {tag}: 2 ranks against 1: losses {rel_loss}, {worst} "
          f"{rel[worst]}")
    return (f"losses {got['losses']!r} against one rank's "
            f"{ref['losses']!r} (within {rel_loss!r} relative, tol "
            f"{DIST_GLOO_LOSS_TOL}); each leaf's update within "
            f"{rel[worst]!r} relative L2 at worst ({worst}; tol "
            f"{DIST_GLOO_UPDATE_TOL})")


def _gloo_finish(started, cfg, ref, init):
    """Let the gloo ranks train (d) and hold rank 0's trajectory to
    ``ref``, one rank on all the rows."""
    procs, tmp, t0 = started
    t = time.perf_counter()
    _gloo_mark(tmp, "go")
    _gloo_wait(started, ("d0", "d1"))
    wall = time.perf_counter() - t
    got = torch.load(os.path.join(tmp, "rank0.pt"), weights_only=False)
    os.remove(os.path.join(tmp, "rank0.pt"))
    log(f"[dist] gpt2-1.3b x{cfg.n_layer}, 2 ranks on the one card over "
        f"gloo (stage 3, per-layer gather, CUDA tensors; micro 2 x gas 1 a "
        f"rank): {_gloo_against('(d)', cfg, got, ref, init)}; steps "
        f"{[w * 1e3 for w in got['walls']]!r} ms; comms {got['comms']}; "
        f"launches {got['counts']}; {wall!r} s from 'go' to done")
    return got["counts"]


def _tp_served(engine, name, prompts, rows, want):
    """A tp/sp run's rows: well-formed, and every served token within
    E2E_MAX_TOL of the max logit of the one-process engine's forward
    through no kernel (``_serve_oracle``, which also counts the tokens
    equal to its generate's); the number of rows equal to ``want``."""
    V = engine.model_config.vocab_size
    for p, r in zip(prompts, rows):
        check(r[:len(p)] == p and len(r) == len(p) + TP_NEW
              and all(0 <= t < V for t in r[len(p):]),
              f"{name}: a row is malformed")
    _serve_oracle(engine, name, prompts, rows, TP_NEW, tag="dist")
    return sum(a == b for a, b in zip(rows, want))


def _tp_phases(started, smi):
    """(e) and (f): the one-process engine over the same seeded weights
    first (its generate and server are the reference, and its numbers the
    tp=1 ones), then the ranks' turn, then the gates. Returns the runs'
    launch counts by name."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import \
        init_params
    from deepspeed_tpu_torch.module_inject.quantize import tree_weight_bytes
    procs, tmp, t0 = started
    cfg = mistral_serving_config()
    L, prompts = cfg.n_layer, _tp_prompts(cfg)
    params = init_params(torch.Generator(device="cuda").manual_seed(TP_SEED),
                         cfg)
    engine = deepspeed_tpu_torch.init_inference(
        (cfg, params), dtype="bf16", max_out_tokens=TP_CTX, num_slots=8,
        block_size=128)
    del params
    one = {"generate": _tp_generate(engine, prompts),
           "server": _tp_server(engine, prompts),
           "weights": tree_weight_bytes(engine.params)}
    _gloo_wait(started, ("e_built0", "e_built1"))
    t = time.perf_counter()
    _gloo_mark(tmp, "go_e")
    _gloo_wait(started, ("ef0", "ef1"))
    wall = time.perf_counter() - t
    got = [torch.load(os.path.join(tmp, f"serve{r}.pt"), weights_only=False)
           for r in range(2)]
    runs = {}
    for tag, what in (("tp", "generate"), ("tp", "server"),
                      ("sp", "generate")):
        name = f"dist {tag} 2 Mistral-7B {what}"
        rows = [g[tag][what]["tokens"] for g in got]
        check(rows[0] == rows[1], f"{name}: the two ranks' tokens differ")
        ref = one[what]["tokens"]
        for r, g in enumerate(got):
            run = g[tag][what]
            if what == "generate":
                expect = {"flash_attention_fwd": L, "decode_attention":
                          L * (TP_NEW - 1) if tag == "tp" else 0}
            else:
                expect = {"flash_attention_fwd": L * run["prefills"],
                          "paged_decode_attention": L * (
                              run["decode_steps"] + run["garbage_steps"]),
                          "decode_attention": 0}
                check(run["decode_traces"] == 0,
                      f"{name}: {run['decode_traces']} decode graphs over "
                      "gloo ranks")
            for k, n in expect.items():
                check(run["counts"][k] == n, f"{name} rank {r}: {k} "
                      f"launched {run['counts'][k]} times, expected {n}")
            runs[f"{name} rank {r}"] = run["counts"]
        # the ranks' rows are equal: the oracle on rank 0's
        same = _tp_served(engine, name, prompts, rows[0], ref)
        g = got[0][tag]
        run, base = g[what], one[what]
        check(g["heads"] == ((16, 4) if tag == "tp" else (32, 8)),
              f"{name}: a rank holds {g['heads']} query and KV heads")
        check(not g["graphs"], f"{name}: CUDA graphs over gloo ranks")
        log(f"[dist] {name}, 2 gloo ranks on the one card ({tag} 2; a rank "
            f"holds {g['heads'][0]} query and {g['heads'][1]} KV heads, "
            f"{g['weights']} weight bytes against {one['weights']} at tp 1; "
            f"engine init {g['init_s']!r} s): {same} of {TP_PROMPTS} rows "
            f"equal the one-process engine's; "
            + (f"decode {run['decode_ms']!r} ms a step against "
               f"{base['decode_ms']!r} at tp 1 (graphs); wall "
               f"{run['wall_s']!r} s (first token {run['first_s']!r}); "
               f"cache {run['cache']} against {base['cache']}; peak "
               f"{run['peak']} bytes a rank against {base['peak']}"
               if what == "generate" else
               f"{run['wall_s']!r} s against {base['wall_s']!r} at tp 1 "
               f"({run['prefills']} prefills, {run['decode_steps']} decode "
               f"steps, pool {run['pool']} against {base['pool']})")
            + f"; launches rank 0 {run['counts']}; gloo moves each "
            f"collective through the host, its times are not a link's; "
            f"{smi}")
    runs["dist tp 1 Mistral-7B generate"] = one["generate"]["counts"]
    runs["dist tp 1 Mistral-7B server"] = one["server"]["counts"]
    log(f"[dist] (e), (f): the ranks' turn took {wall!r} s")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def _tensor_seq_phases(started, cfg, ref, init):
    """(g) and (h): the ranks' runs against (d)'s one-rank run; returns
    their launch counts by name."""
    procs, tmp, t0 = started
    t = time.perf_counter()
    _gloo_mark(tmp, "go_g")
    _gloo_join(started)
    wall = time.perf_counter() - t
    got = [torch.load(os.path.join(tmp, f"train{r}.pt"), weights_only=False)
           for r in range(2)]
    runs = {}
    for tag, local in (("tensor", (cfg.n_embd, 3 * cfg.n_embd // 2)),
                       ("seq", (cfg.n_embd, 3 * cfg.n_embd))):
        g = got[0][tag]
        check(got[1][tag]["losses"] == g["losses"],
              f"dist gloo {tag} 2: the ranks' losses differ")
        check(g["c_attn"] == local, f"dist gloo {tag} 2: a rank holds "
              f"c_attn {g['c_attn']}, not {local}")
        log(f"[dist] gpt2-1.3b x{cfg.n_layer} at {tag} 2, 2 gloo ranks on the"
            f" one card (stage 0, micro 4 x gas 1, every rank all of the "
            f"one-rank run's rows; c_attn {g['c_attn']} a rank): "
            f"{_gloo_against(tag, cfg, g, ref, init)}; steps "
            f"{[w * 1e3 for w in g['walls']]!r} ms against one rank's "
            f"{[w * 1e3 for w in ref['walls']]!r}; peak {g['peak']} bytes a "
            f"rank; comms {g['comms']}; launches rank 0 {g['counts']}, rank "
            f"1 {got[1][tag]['counts']}; gloo moves each collective through "
            f"the host, its times are not a link's")
        for r in range(2):
            runs[f"dist gpt2-1.3b x{cfg.n_layer} {tag} 2 rank {r}"] = \
                got[r][tag]["counts"]
    log(f"[dist] (g), (h): the ranks' turn took {wall!r} s")
    return runs


def phase_dist(smi):
    """ZeRO over ``torch.distributed``. (a) gpt2-1.3b x DIST_LAYERS on the
    single-process engine; then NCCL in this process at world size 1 (a
    ``FileStore`` under the checkout's ``build/``) and (b) stage 3 with
    GPT-2's per-layer gather (the fetch all-gathers each layer's blocks,
    its backward reduce-scatters the gradient), (c) stage 2 (the gradient
    reduce-scattered, the new params all-gathered). At one rank every
    collective is an identity: (b) and (c) equal (a) bit for bit (losses,
    whole master and params), with all-gathers and reduce-scatters
    counted by the comms logger. Then ``benchmarks_comm.run_sweep`` at
    DIST_SWEEP_MB. Nothing else runs on the card or the host while these
    are timed. Last (d) two ranks on the one card over gloo at
    DIST_GLOO_LAYERS, stage 3, against one rank on all their rows (the
    CPU test's bf16 tolerances), and the same two ranks go on to (e)-(h)
    (``TP_*`` above): the Mistral-7B-v0.2 layout served at tp 2 and at sp
    2, each rank's tokens equal and held to the one-process engine's
    (its served-token oracle), and gpt2-1.3b trained at tensor 2 and at
    seq 2 against (d)'s one-rank run. Returns the launch counts of its
    runs by name."""
    import tempfile

    import torch.distributed as dist

    from deepspeed_tpu_torch import benchmarks_comm
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    cfg = config_for("gpt2-1.3b", n_layer=DIST_LAYERS)
    L = cfg.n_layer
    batches = _ckpt_batches(cfg, DIST_STEPS, 24)
    params = GPT2LMModel(cfg).init(
        torch.Generator(device="cuda").manual_seed(24))
    engine = _dist_engine(cfg, params, {"stage": 0})
    out = {"a single process": _dist_steps("a", engine, batches, L)}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dist_smoke_", dir=root)
    try:
        t = time.perf_counter()
        comm.init_distributed(
            store=dist.FileStore(os.path.join(tmp, "store"), 1),
            num_processes=1, process_id=0, dist_backend="nccl",
            timeout=datetime.timedelta(seconds=120))
        init_s = time.perf_counter() - t
        for tag, zero, fetch in (("b stage 3", {"stage": 3}, True),
                                 ("c stage 2", {"stage": 2}, False)):
            engine = _dist_engine(dataclasses.replace(
                cfg, offload_params=fetch), params, zero)
            check(engine._dist and engine.dp == 1,
                  f"dist {tag}: the engine is not on the process group")
            out[tag] = _dist_steps(tag, engine, batches, L)
            del engine
            gc.collect()
            torch.cuda.empty_cache()
        sweep = benchmarks_comm.run_sweep(DIST_SWEEP_MB, trials=20)
    finally:
        comm.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    del params
    torch.cuda.empty_cache()
    # (d) after every timed run: the gloo ranks start (imports, the card,
    # their engines) while this process runs their reference, one rank
    # on all their rows
    gcfg = config_for("gpt2-1.3b", n_layer=DIST_GLOO_LAYERS)
    gbatches = [{k: v[:4] for k, v in b.items()}
                for b in _ckpt_batches(gcfg, DIST_GLOO_STEPS, 26)]
    started = _gloo_start(gcfg, gbatches, root)
    try:
        gparams = GPT2LMModel(gcfg).init(
            torch.Generator(device="cuda").manual_seed(25))
        ginit = {k: v.detach().cpu() for k, v in gparams.items()}
        engine = _dist_engine(gcfg, gparams, {"stage": 0}, micro=4, gas=1)
        del gparams
        one = _dist_steps("d one rank", engine, gbatches, gcfg.n_layer)
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        gloo = _gloo_finish(started, gcfg, one, ginit)
        tp_runs = _tp_phases(started, smi)
        tp_runs.update(_tensor_seq_phases(started, gcfg, one, ginit))
    finally:
        for p in started[0]:   # a failure above: stop the ranks
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(started[1], ignore_errors=True)
    a = out["a single process"]
    med = {k: float(np.median(v["walls"][1:])) * 1e3 for k, v in out.items()}
    for tag in ("b stage 3", "c stage 2"):
        r = out[tag]
        same = r["losses"] == a["losses"] and all(
            torch.equal(r["master"][k], v) and torch.equal(
                r["params"][k], a["params"][k])
            for k, v in a["master"].items())
        gathers = sum(v["count"] for k, v in r["comms"].items()
                      if k.startswith("all_gather["))
        scatters = sum(v["count"] for k, v in r["comms"].items()
                       if k.startswith("reduce_scatter["))
        log(f"[dist] gpt2-1.3b x{L} ({tag}, NCCL world size 1): losses "
            f"{r['losses']!r}; steps {[w * 1e3 for w in r['walls']]!r} ms "
            f"(median after the first {med[tag]!r}, single process "
            f"{med['a single process']!r}: the collective path "
            f"{med[tag] - med['a single process']!r} ms a step); comms "
            f"{r['comms']}; launches {r['counts']}; equal to (a) bit for "
            f"bit {same}")
        check(same, f"dist {tag}: not the single-process engine bit for "
              f"bit ({r['losses']} against {a['losses']})")
        check(gathers > 0 and scatters > 0,
              f"dist {tag}: all-gathers {gathers}, reduce-scatters "
              f"{scatters}: the collective path did not run")
    log(f"[dist] gpt2-1.3b x{L} (a single process): losses {a['losses']!r};"
        f" steps {[w * 1e3 for w in a['walls']]!r} ms; NCCL start "
        f"{init_s!r} s; {smi}")
    for r in sweep:
        log(f"[dist] run_sweep world size 1: {json.dumps(r)}")
    runs = {f"dist gpt2-1.3b x{L} {k}": v["counts"] for k, v in out.items()}
    runs[f"dist gpt2-1.3b x{gcfg.n_layer} one rank"] = one["counts"]
    runs[f"dist gpt2-1.3b x{gcfg.n_layer} gloo rank 0"] = gloo
    runs.update(tp_runs)
    return runs


def gpt2_xl_config():
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    # HF openai-community/gpt2-xl config.json, at its published widths
    return InferenceTransformerConfig(
        vocab_size=50257, n_positions=1024, n_embd=1600, n_layer=48,
        n_head=25, activation="gelu_new", layer_norm_eps=1e-5,
        positional="learned", tied_lm_head=True, dtype=torch.bfloat16)


def pythia_2p8b_config():
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    # HF EleutherAI/pythia-2.8b config.json, at its published widths and
    # depth: GPT-NeoX blocks (use_parallel_residual: attention and MLP in
    # parallel, each behind its own LayerNorm), rotary_pct 0.25 of the
    # head dim 80, not interleaved, base 10000, exact GELU, untied head
    return InferenceTransformerConfig(
        vocab_size=50304, n_positions=2048, n_embd=2560, n_layer=32,
        n_head=32, intermediate_size=10240, positional="rotary",
        rotary_dim=20, rotary_interleaved=False, rotary_base=10000.0,
        parallel_attn_mlp=True, activation="gelu", layer_norm_eps=1e-5,
        tied_lm_head=False, dtype=torch.bfloat16)


PYTHIA_PARAMS = 2775208960   # pythia-2.8b's published count


def gptj_6b_config():
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    # HF EleutherAI/gpt-j-6b config.json, at its published widths and
    # depth: 16 heads of 256, rotary_dim 64 interleaved (GPT-J's pairs),
    # attention and MLP in parallel behind one shared LayerNorm, gelu_new,
    # n_inner null (4 x 4096), an untied head with a bias
    return InferenceTransformerConfig(
        vocab_size=50400, n_positions=2048, n_embd=4096, n_layer=28,
        n_head=16, positional="rotary", rotary_dim=64,
        rotary_interleaved=True, rotary_base=10000.0,
        parallel_attn_mlp=True, activation="gelu_new", layer_norm_eps=1e-5,
        tied_lm_head=False, dtype=torch.bfloat16)


# GPT-J-6B's count (GPTJForCausalLM on the meta device): its q, k, v and
# out projections have no bias, where init_params adds zero ones
GPTJ_PARAMS = 6050882784


def make_params(cfg, dev="cuda"):
    """Random weights of ``cfg`` from a generator seeded 0, on the card."""
    from deepspeed_tpu_torch.model_implementations.transformer import \
        init_params
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[e2e] random weights: {n_params} parameters in "
        f"{time.perf_counter() - t0:.3f} s")
    return params


def phase_e2e(cfg, params, dev="cuda", tag="e2e", engine=None, n_ctx=None):
    """``generate`` of 8 seeded prompts of ``n_ctx // 16`` to ``n_ctx *
    7 // 8`` tokens (``n_ctx`` defaults to the model's ``n_positions``)
    and its gates, over ``engine`` (one whose ``max_out_tokens`` is
    ``n_ctx``) or a new engine over ``(cfg, params)``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import (
        causal_forward, decode_step, prefill)
    from deepspeed_tpu_torch.ops.decode_attention import decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_fwd
    n_ctx = n_ctx or cfg.n_positions
    if engine is None:
        engine = deepspeed_tpu_torch.init_inference(
            (cfg, params), dtype=str(cfg.dtype).replace("torch.", ""),
            device=dev, max_out_tokens=n_ctx)
    rng = np.random.default_rng(0)
    lens = rng.integers(n_ctx // 16, n_ctx * 7 // 8 + 5, 8)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 32
    # warm-up: cuBLAS, the allocator, and the decode step's graph (warmed
    # up at the first step, captured at the second)
    engine.generate(prompts, max_new_tokens=3)
    graph = engine._kept[2]

    def timed(n):
        t = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=n)
        return out, time.perf_counter() - t

    _, t_pre = timed(1)
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    decode_attention.launches = 0
    out, t_gen = timed(new)   # THE main path
    n_flash, n_decode = flash_attention_fwd.launches, decode_attention.launches
    peak = torch.cuda.max_memory_allocated()
    _, t_pre2 = timed(1)
    _, t_gen2 = timed(new)
    steps = new - 1   # token 0 comes from the prefill logits
    check(n_flash == cfg.n_layer,
          f"flash launches {n_flash} != {cfg.n_layer} (one prefill)")
    check(n_decode == cfg.n_layer * steps,
          f"decode launches {n_decode} != {cfg.n_layer} x {steps} steps")
    for b, row in enumerate(out):
        check(len(row) == lens[b] + new and row[:lens[b]] == prompts[b],
              f"row {b}: prompt not kept or wrong length {len(row)}")
        check(all(0 <= t < cfg.vocab_size for t in row[lens[b]:]),
              f"row {b}: token out of range")
    per_tok = [(tg - tp) / steps * 1e3 for tg, tp in
               ((t_gen, t_pre), (t_gen2, t_pre2))]
    kept = engine._kept[1]
    cache_bytes = sum(x.nbytes for x in (kept.k, kept.v, kept.lengths))
    log(f"[{tag}] generate 8 x {new} tokens: {t_gen!r} s and {t_gen2!r} s; "
        f"prefill (generate of 1 token) {t_pre * 1e3!r} ms and "
        f"{t_pre2 * 1e3!r} ms; decode {per_tok[0]!r} and {per_tok[1]!r} "
        f"ms per step; {8 * new / t_gen!r} tokens/s; peak memory "
        f"{peak} bytes; launches flash {n_flash}, decode {n_decode}; kept "
        f"dense cache {tuple(kept.k.shape)} {cache_bytes} bytes")
    check(graph is not None and engine._kept[2] is graph,
          f"{tag}: generate's decode step has no graph kept")
    _graph_log(tag, "generate", graph)

    # the eager control: the same generate with the graph off
    engine._cuda_graphs = False
    _, e_pre = timed(1)
    ref, e_gen = timed(new)
    engine._cuda_graphs = True
    e_tok = (e_gen - e_pre) / steps * 1e3
    log(f"[{tag}] eager control: generate 8 x {new} tokens {e_gen!r} s, "
        f"prefill {e_pre * 1e3!r} ms, decode {e_tok!r} ms per step (graphs: "
        f"{t_gen!r} s, {per_tok[0]!r} ms per step)")
    check(ref == out, f"{tag}: generate's tokens with the decode graph "
          f"differ from the eager control's")

    # per-step host time: enqueue (no sync) vs device time of one step,
    # eager and replayed, over the kept cache
    with torch.inference_mode():
        ids = np.zeros((8, n_ctx), np.int64)
        for b, p in enumerate(prompts):
            ids[b, :len(p)] = p
        cache = engine._make_cache(8, n_ctx)
        lg, cache = prefill(engine.params, engine.model_config,
                            torch.as_tensor(ids, device=dev),
                            torch.as_tensor(lens, device=dev), cache)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        for how, step in (
                ("eager", lambda t: decode_step(
                    engine.params, engine.model_config, t, cache)[0]),
                ("replayed", engine._decode_fn(cache))):
            host, dev_ms = [], []
            for i in range(10):
                s, e = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                th = time.perf_counter()
                s.record()
                lg = step(tok)
                e.record()
                th = time.perf_counter() - th
                tok = lg.argmax(-1)
                torch.cuda.synchronize()
                if i >= 2:   # a new graph's warm-up and capture
                    host.append(th)
                    dev_ms.append(s.elapsed_time(e))
            log(f"[{tag}] one decode step (B=8), {how}: host enqueue "
                f"{float(np.median(host)) * 1e3!r} ms, device "
                f"{float(np.median(dev_ms))!r} ms (medians of 8)")

    # decode == prefill: the graph's decode-path logits (kernels) against
    # a forward over the same tokens through the flash kernel's plain
    # version
    rows = [int(np.argmin(lens)), int(np.argmax(lens))]
    k_steps = 4
    with torch.inference_mode():
        p_ids = np.zeros((2, n_ctx), np.int64)
        f_ids = np.zeros((2, n_ctx), np.int64)
        for i, r in enumerate(rows):
            p_ids[i, :lens[r]] = prompts[r]
            f_ids[i, :lens[r] + k_steps] = out[r][:lens[r] + k_steps]
        plen = torch.as_tensor(lens[rows], device=dev)
        cache = engine._make_cache(2, n_ctx)
        lg, cache = prefill(engine.params, engine.model_config,
                            torch.as_tensor(p_ids, device=dev), plen,
                            cache)
        step = engine._decode_fn(cache)
        dec = [lg]
        for s in range(k_steps):
            tok = torch.as_tensor([out[r][lens[r] + s] for r in rows],
                                  device=dev)
            dec.append(step(tok))
        check(engine._kept[2].replays == k_steps - 1,
              f"{tag}: decode == prefill did not replay its graph")
        ref = causal_forward(engine.params, engine.model_config,
                             torch.as_tensor(f_ids, device=dev),
                             reference_attention=True)
        errs = []
        for s, lg in enumerate(dec):
            for i, r in enumerate(rows):
                d = (lg[i] - ref[i, lens[r] - 1 + s]).abs()
                errs.append((d.max().item(), d.mean().item()))
    mx = max(e[0] for e in errs)
    mean = max(e[1] for e in errs)
    log(f"[{tag}] decode == prefill on rows {rows}, {k_steps + 1} positions "
        f"each (the decode steps through the graph): max |logit diff| "
        f"{mx!r} (tol {E2E_MAX_TOL}), worst mean {mean!r} (tol "
        f"{E2E_MEAN_TOL})")
    check(math.isfinite(mx) and mx <= E2E_MAX_TOL and mean <= E2E_MEAN_TOL,
          "decode-path logits disagree with the full forward")
    return {"flash_attention_fwd": n_flash, "decode_attention": n_decode}


_PAGED_KERNELS = ("flash_attention_fwd", "decode_attention",
                  "paged_decode_attention", "paged_chunk_attention",
                  "paged_verify_attention", "paged_decode_attention_int8",
                  "paged_chunk_attention_int8", "paged_verify_attention_int8")
_BWD_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")


def _launch_counts(reset=False):
    """Every wrapper's launch count (set to 0 first when ``reset``)."""
    from deepspeed_tpu_torch.ops import launch_counters
    fns = launch_counters()
    if reset:
        for f in fns.values():
            f.launches = 0
    return {n: f.launches for n, f in fns.items()}


def _graph_log(tag, name, graph):
    """Log one step graph's captures, replays, capture seconds and pool
    bytes; it must have been captured once and replayed."""
    snap = graph.snapshot()
    log(f"[{tag}] {name}: graph {graph.name}: {snap['captures']} capture "
        f"in {snap['capture_s']!r} s, {snap['replays']} replays, graph pool "
        f"{snap['pool_bytes']} bytes, launches a replay "
        f"{snap['launches_per_replay']}")
    check(snap["captures"] == 1 and snap["replays"] > 0,
          f"{name}: the {graph.name} graph was not replayed")


def _serve_run(engine, name, knobs, batches, new, between=None,
               drain_each=False, graphs=True, draft=None, registry=None):
    """One server over ``engine`` with config ``knobs`` (and the draft
    engine ``draft``, the metrics registry ``registry``): submit each batch
    of prompts in turn, stepping ``between(srv, i)`` steps after batch i
    (or, with ``drain_each``, until the batch is served), then drain. Its
    decode or verify step (and a draft's decode step) runs as a CUDA graph,
    which must have replayed, unless ``graphs`` is False (the eager
    control). The kernel counts are set to 0 just before and read just
    after. Returns (server, request ids, outputs, counts, tokens per
    second)."""
    from deepspeed_tpu_torch.inference import (ContinuousBatchingServer,
                                               DeepSpeedInferenceConfig)
    engine.config = DeepSpeedInferenceConfig(dtype="bfloat16", **knobs)
    srv = ContinuousBatchingServer(engine, draft_engine=draft,
                                   registry=registry)
    srv._cuda_graphs = graphs
    torch.cuda.synchronize()
    walls, ids = [], []
    _launch_counts(reset=True)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        ids += [srv.submit(p, max_new_tokens=new) for p in batch]
        for _ in range(between(srv, i) if between else 0):
            ts = time.perf_counter()
            srv.step()
            walls.append(time.perf_counter() - ts)
        while drain_each and not srv.scheduler.idle:
            ts = time.perf_counter()
            srv.step()
            walls.append(time.perf_counter() - ts)
    while not srv.scheduler.idle:
        ts = time.perf_counter()
        srv.step()
        walls.append(time.perf_counter() - ts)
    out = srv.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    st = srv.stats
    tokens = sum(len(out[r]) - len(p) for r, p in
                 zip(ids, [p for b in batches for p in b]))
    log(f"[serve] {name} ({'graphs' if graphs else 'eager'}): {len(ids)} "
        f"requests, {tokens} tokens in {wall!r} "
        f"s = {tokens / wall!r} tokens/s; {len(walls)} steps, median step "
        f"{float(np.median(walls)) * 1e3!r} ms; decode steps "
        f"{st['decode_steps']}, garbage steps "
        f"{st['async_loop']['garbage_steps']}, prefills {st['prefills']}, "
        f"chunks {st['prefill_chunks']}, prefix hits "
        f"{st['prefix_cache_hits']}, verify steps "
        f"{st['speculation']['verify_steps']}, tokens/forward "
        f"{st['speculation']['tokens_per_forward']}; kv tier "
        f"{st['kv_tier']}; launches {counts}")
    if graphs:
        kind = "verify" if srv.spec_tokens else "decode"
        check(kind in srv._graphs, f"serve {name}: no {kind} graph")
        for g in srv._graphs.values():
            _graph_log("serve", name, g)
        traces = (st["speculation"]["verify_traces"] if srv.spec_tokens
                  else st["decode_traces"])
        check(traces == 1 and st["retraces"] == 0,
              f"serve {name}: trace counters {traces}, {st['retraces']}")
    else:
        check(not srv._graphs, f"serve {name}: the eager control captured")
    return srv, ids, out, counts, tokens / wall


def _eager_control(engine, name, knobs, batches, new, ids, out, **kw):
    """The same server run again with its step graphs off: it must serve
    the graphed run's tokens exactly (the same kernels on the same
    inputs)."""
    if "telemetry" in knobs:
        from deepspeed_tpu_torch.telemetry import MetricRegistry
        kw.setdefault("registry", MetricRegistry())
    srv, cids, ref, _, _ = _serve_run(engine, name, knobs, batches, new,
                                      graphs=False, **kw)
    srv.close()
    del srv
    same = sum(out[r] == ref[c] for r, c in zip(ids, cids))
    log(f"[serve] {name}: {same} of {len(ids)} requests token-identical "
        f"with and without graphs")
    check(same == len(ids) == len(cids),
          f"serve {name}: the graphed server's tokens differ from the "
          f"eager control's")


def _serve_oracle(engine, name, prompts, rows, new, tol=E2E_MAX_TOL,
                  tag="serve"):
    """Tie-tolerant oracle on some requests: each served token's logit in
    a forward over prompt + served tokens through no attention kernel
    (the flash kernel's plain version) is within ``tol`` of that
    position's maximum. Also counts served tokens equal to generate's."""
    from deepspeed_tpu_torch.model_implementations.transformer import \
        causal_forward
    T = max(len(r) for r in rows)
    ids = np.zeros((len(rows), T), np.int64)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
    with torch.inference_mode():
        ref = causal_forward(engine.params, engine.model_config,
                             torch.as_tensor(ids, device="cuda"),
                             reference_attention=True)
    worst, gaps = 0.0, []
    for i, (p, r) in enumerate(zip(prompts, rows)):
        if len(r) == len(p):
            continue
        lg = ref[i, len(p) - 1:len(r) - 1].float()
        top = lg.topk(2, dim=-1).values
        served = lg.gather(1, torch.as_tensor(r[len(p):],
                                              device=lg.device)[:, None])
        worst = max(worst, (top[:, 0] - served[:, 0]).max().item())
        gaps.append(top[:, 0] - top[:, 1])
    gaps = torch.cat(gaps)
    gen = engine.generate(prompts, max_new_tokens=new)
    same = sum(a == b for g, r, p in zip(gen, rows, prompts)
               for a, b in zip(g[len(p):], r[len(p):]))
    total = sum(len(r) - len(p) for r, p in zip(rows, prompts))
    log(f"[{tag}] {name} oracle on {len(rows)} requests: worst (max logit - "
        f"served token's logit) {worst!r} (tol {tol}); {same} of {total} "
        f"served tokens equal generate's; the reference's top-1 - top-2 "
        f"gaps: median {gaps.median().item()!r}, "
        f"{int((gaps <= tol).sum())} of {gaps.numel()} within tol")
    check(math.isfinite(worst) and worst <= tol,
          f"{tag} {name}: a served token is not a near-argmax of the "
          f"reference forward ({worst} > {tol})")


def _bf16_step(x: float) -> float:
    """The spacing of bf16 numbers at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def _same_as_control(engine, name, ids, prompts, out, ref, tag="serve",
                     tol=None):
    """Served tokens against a control's (a server's or ``generate``'s),
    request by request (``out[r]``, ``ref[r]`` for ``r`` in ``ids``).
    Where a token differs, the request passes only if the two tokens'
    logits at that position, in a forward over the common prefix through
    no attention kernel, lie within ``tol`` of each other (default: one
    bf16 step, a tie). Returns the ties as (request, generated position,
    logits)."""
    from deepspeed_tpu_torch.model_implementations.transformer import \
        causal_forward
    differ = []
    for r, p in zip(ids, prompts):
        a, b = out[r], ref[r]
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if pos is None:
            check(len(a) == len(b), f"{tag} {name}: request {r} length "
                  f"{len(a)} != control {len(b)}")
            continue
        with torch.inference_mode():
            lg = causal_forward(engine.params, engine.model_config,
                                torch.as_tensor([a[:pos]], device="cuda"),
                                reference_attention=True)[0, -1].float()
        la, lb = lg[a[pos]].item(), lg[b[pos]].item()
        step = _bf16_step(max(abs(la), abs(lb))) if tol is None else tol
        differ.append((r, pos - len(p), la, lb))
        check(abs(la - lb) <= step,
              f"{tag} {name}: request {r} differs from the control at "
              f"generated position {pos - len(p)} (logits {la!r} vs {lb!r}, "
              f"more than {step!r} apart)")
    log(f"[{tag}] {name}: {len(ids) - len(differ)} of {len(ids)} requests "
        f"token-identical to the control; ties {differ}")
    return differ


def _check_served(engine, name, ids, out, prompts, counts, expect, new,
                  tol=E2E_MAX_TOL):
    """A server run's gates: no dense decode launch, each kernel of
    ``expect`` launched exactly as often as its count says (and at least
    once), well-formed outputs, and the oracle on the first and last
    request."""
    V = engine.model_config.vocab_size
    check(counts["decode_attention"] == 0,
          f"serve {name}: {counts['decode_attention']} dense decode "
          f"launches (the server must use the paged kernels)")
    for k, n in expect.items():
        check(counts[k] == n and n > 0,
              f"serve {name}: {k} launched {counts[k]} times, expected {n}")
    for r, p in zip(ids, prompts):
        check(out[r][:len(p)] == p and len(out[r]) == len(p) + new
              and all(0 <= t < V for t in out[r][len(p):]),
              f"serve {name}: request {r} malformed")
    _serve_oracle(engine, name, [prompts[0], prompts[-1]],
                  [out[ids[0]], out[ids[-1]]], new, tol)


EAGER_CONTROLS = ("default", "speculation K=4", "int8+prefix+chunked+offload")

# server (a)'s observability plane: every piece armed. The queue-wait
# objective is loose (nothing is shed); the decode objective is tight and
# must fire. The canary probes every OBSERVE_CANARY_S through the real path.
OBSERVE_TIGHT_S = 1e-5      # decode step p90 objective, seconds
OBSERVE_CANARY_S = 0.5
OBSERVE_TELEMETRY = {
    "trace_sample_rate": 1.0, "http_port": 0,
    "slo": {"enabled": True, "queue_wait_p90_s": 600.0,
            "eval_interval_s": 0.25,
            "objectives": {"decode_tight": {
                "signal": "decode_p90_s", "threshold": OBSERVE_TIGHT_S,
                "fast_window_s": 1.0, "slow_window_s": 2.0}}},
    "canary": {"enabled": True, "interval_s": OBSERVE_CANARY_S,
               "timeout_s": 60.0},
    "incident": {"enabled": True},
}
OBSERVE_COST_TOL = 0.01     # summed request costs vs the profiler's
OBSERVE_CAPTURE_STEPS = 4
OFF_TELEMETRY = {"step_profile": False, "accounting": {"enabled": False}}


def _routes(tag, port):
    """Every route of the scrape endpoint answers 200: Prometheus text
    naming the serving counters, or JSON that parses."""
    import urllib.request

    from deepspeed_tpu_torch.telemetry.exporter import ROUTES
    sizes = {}
    for path in ROUTES:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            body = r.read().decode()
            check(r.status == 200, f"{tag}: {path} answered {r.status}")
            ctype = r.headers["Content-Type"]
        if ctype == "application/json":
            json.loads(body)
        elif path == "/metrics":
            check("# TYPE serve_tokens_total counter" in body,
                  f"{tag}: /metrics without the serving counters")
        sizes[path] = len(body)
    log(f"[{tag}] scrape endpoint on port {port}: every route answered 200 "
        f"(bytes {sizes})")


def _observed(tag, srv, ids, capture_dir):
    """Server (a)'s plane gates, read while the server is still open."""
    _routes(tag, srv.http_server.port)
    traces = {t.trace_id: t.to_dict()["root"] for t in srv.tracer.traces()}
    for r in ids:
        names = {c["name"] for c in traces[r]["children"]}
        check({"queue_wait", "admission", "prefill", "decode"} <= names,
              f"{tag}: request {r}'s trace has only {sorted(names)}")
    st = srv.stats
    prof, acct = st["step_profile"], st["accounting"]
    # every request's cost record, the canary's probes (excluded records,
    # no tenant) among them: together they hold the profiler's device time
    costs = {r: srv.request_cost(r) for r in range(srv._next_id)}
    probes = [c for r, c in costs.items() if r not in ids]
    check(all(costs[r] is not None and costs[r]["device_s"] > 0
              and not costs[r].get("excluded") for r in ids)
          and all(c is not None and c.get("excluded") for c in probes),
          f"{tag}: cost records {costs}")
    user = sum(costs[r]["device_s"] for r in ids)
    canary_s = sum(c["device_s"] for c in probes)
    check(abs(user + canary_s - prof["device_s"]) <= OBSERVE_COST_TOL
          * prof["device_s"],
          f"{tag}: request costs {user} s and canary probes {canary_s} s "
          f"of the profiler's {prof['device_s']} s")
    phases = sum(prof["phases_s"].values())
    check(abs(phases - prof["wall_s"]) <= 1e-6 * prof["wall_s"],
          f"{tag}: phases sum to {phases} s, the wall is {prof['wall_s']} s")
    alerts, inc, canary = st["alerts"], st["incidents"], st["canary"]
    check(alerts["fired_total"] == 1 and alerts["firing"] == [
        "decode_tight"], f"{tag}: the tight objective: {alerts}")
    check(inc["captured_total"] == 1 and inc["incidents"][0]["events"],
          f"{tag}: incidents {inc['captured_total']}, bundle without ring "
          f"events")
    res = canary["results"]
    check(res["success"] >= 1 and res["success"] == canary["probes"],
          f"{tag}: canary {canary}")
    files = [os.path.join(capture_dir, f) for f in os.listdir(capture_dir)]
    check(len(files) == 1, f"{tag}: capture wrote {files}")
    with open(files[0]) as f:
        trace_text = f.read()
    check("paged_split_kernel" in trace_text,
          f"{tag}: the captured trace names no paged_split_kernel")
    log(f"[{tag}] plane: {len(ids)} request traces cover queue_wait/"
        f"admission/prefill/decode; request costs {user!r} s of device "
        f"+ {len(probes)} canary probes {canary_s!r} s vs profiler "
        f"{prof['device_s']!r} s; phases sum {phases!r} s = wall "
        f"{prof['wall_s']!r} s; goodput {prof['goodput_fraction']!r}, "
        f"dispatch gap {prof['dispatch_gap']}; tight objective fired "
        f"{alerts['fired_total']}x, incidents {inc['captured_total']} "
        f"(bundle keys {sorted(inc['incidents'][0])}); canary {res}, "
        f"latency p50 {canary['latency_p50_ms']!r} ms; capture "
        f"{os.path.basename(files[0])} ({len(trace_text)} bytes); "
        f"capacity {srv.capacity_snapshot()}; accounting {acct}")


def _hist(reg, name, labels=None):
    """One series of a registry histogram: count, mean (exact: sum over
    count), p50 and p90 (interpolated in its factor-2 buckets)."""
    for ser in reg.snapshot()[name]["series"]:
        if labels is None or ser["labels"] == labels:
            n = ser["count"]
            return {"count": n, "mean": ser["sum"] / n if n else None,
                    "p50": ser["p50"], "p90": ser["p90"]}
    return None


def _swap_log(tag, srv, reg, first_round):
    """Log (d)'s host-tier copies from ``serve_kv_swap_seconds`` (one
    series for both directions, as JAX's): the first round's (demotions
    alone: its prefixes are all different, so nothing is swapped in) and
    the whole run's, with GB/s at the mean; and the step profiler's
    ``serve_step_phase_seconds`` of its phases."""
    nbytes = srv.host_tier.block_nbytes
    whole = {"demotions": reg.snapshot()["serve_kv_swap_out_total"][
        "series"][0]["value"], "swap-ins": reg.snapshot()[
        "serve_kv_swap_in_total"]["series"][0]["value"],
        **_hist(reg, "serve_kv_swap_seconds")}
    parts = []
    for what, h in (("first round", first_round), ("whole run", whole)):
        gbs = nbytes / h["mean"] / 1e9 if h["mean"] else None
        parts.append(f"{what} {h}: {gbs!r} GB/s at the mean")
    log(f"[{tag}] host tier copies of {nbytes} bytes a block, "
        f"serve_kv_swap_seconds: {'; '.join(parts)}")
    phases = {ser["labels"]["phase"]: _hist(reg, "serve_step_phase_seconds",
                                            ser["labels"])
              for ser in reg.snapshot()["serve_step_phase_seconds"]["series"]}
    log(f"[{tag}] serve_step_phase_seconds by phase: {phases}; step wall "
        f"{_hist(reg, 'serve_step_wall_seconds')}")


def phase_serve(cfg, params, eager=EAGER_CONTROLS):
    """The paged server at GPT-2 XL width through five configurations,
    each server closed before the next; launch counts are set to 0 just
    before each run and read just after. The servers named in ``eager``
    are run again with their step graphs off and must serve the same
    tokens."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
    from deepspeed_tpu_torch.inference.kv_cache import init_paged_cache
    from deepspeed_tpu_torch.model_implementations.transformer import \
        paged_decode_step
    from deepspeed_tpu_torch.telemetry import MetricRegistry
    engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                dtype="bfloat16")
    L, V, new = cfg.n_layer, cfg.vocab_size, 32
    rng = np.random.default_rng(5)
    engine.generate([[1, 2, 3]], max_new_tokens=2)   # warm-up
    runs = {}

    def verify(name, srv, ids, out, prompts, counts, expect,
               tol=E2E_MAX_TOL):
        _check_served(engine, name, ids, out, prompts, counts, expect, new,
                      tol)
        runs[name] = counts
        srv.close()

    # (a) default config: monolithic prefill, async loop, lag 1
    prompts = [rng.integers(0, V, n).tolist()
               for n in rng.integers(64, 701, 16)]
    a_batches = [prompts[:8], prompts[8:]]

    def a_between(srv, i):
        return 4 if i == 0 else 0

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    capture_dir = tempfile.mkdtemp(prefix="capture_smoke_", dir=root)

    def a_capture(srv, i):
        if i == 0:
            srv.capture_decode_steps(OBSERVE_CAPTURE_STEPS, capture_dir)
        return a_between(srv, i)

    a_knobs = {"enable_load_shedding": True, "telemetry": OBSERVE_TELEMETRY}
    try:
        srv, ids, out, counts, _ = _serve_run(
            engine, "default", a_knobs, a_batches, new, between=a_capture,
            registry=MetricRegistry())
        st = srv.stats
        fp_pool = (st["kv_tier"]["pool_bytes"], srv._cache.num_blocks)
        _observed("serve", srv, ids, capture_dir)
        port = srv.http_server.port
        verify("default", srv, ids, out, prompts, counts, {
            "flash_attention_fwd": L * st["prefills"],
            "paged_decode_attention": L * (
                st["decode_steps"] + st["async_loop"]["garbage_steps"])})
        check(srv.http_server is None, "serve: close() kept the endpoint")
        del srv
    finally:
        shutil.rmtree(capture_dir, ignore_errors=True)
    if "default" in eager:
        _eager_control(engine, "default", a_knobs, a_batches, new, ids, out,
                       between=a_between)
    # (a)'s requests with the default plane off: the same tokens and one
    # decode graph (the plane adds no sync and changes no captured step)
    srv, pids, pout, _, _ = _serve_run(
        engine, "default plane off", {"telemetry": OFF_TELEMETRY}, a_batches,
        new, between=a_between, registry=MetricRegistry())
    check(srv._profiler is None and srv._ledger is None
          and [pout[r] for r in pids] == [out[r] for r in ids]
          and srv.stats["decode_traces"] == 1,
          "serve: the plane-off run served other tokens or captured again")
    srv.close()
    del srv

    # one paged decode step at S=8 on its own: host enqueue vs device
    pool = init_paged_cache(L, 8, 65, 128, 8, cfg.kv_heads, cfg.head_dim,
                            device="cuda")
    lens = rng.integers(300, 900, 8)
    pool.block_tables.copy_(torch.as_tensor(
        _paged_tables(rng, -(-(lens + 1) // 128), 65, 8), device="cuda"))
    pool.lengths.copy_(torch.as_tensor(lens, device="cuda"))
    tok = torch.zeros(8, dtype=torch.long, device="cuda")
    active = torch.ones(8, dtype=torch.bool, device="cuda")
    with torch.inference_mode():
        step = GraphedStep(
            "paged_decode_s8",
            lambda t: paged_decode_step(engine.params, engine.model_config,
                                        t, pool, active)[0].argmax(-1),
            (tok,), lambda: (pool.k, pool.v, pool.lengths))
        for how, fn in (
                ("eager", lambda t: paged_decode_step(
                    engine.params, engine.model_config, t, pool,
                    active)[0].argmax(-1)),
                ("replayed", lambda t: (tok.copy_(t), step())[1])):
            host, dev_ms = [], []
            t = tok.clone()
            for i in range(10):
                s_ev, e_ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                th = time.perf_counter()
                s_ev.record()
                t = fn(t)
                e_ev.record()
                if i >= 2:   # the graph's warm-up and capture
                    host.append(time.perf_counter() - th)
                torch.cuda.synchronize()
                if i >= 2:
                    dev_ms.append(s_ev.elapsed_time(e_ev))
            log(f"[serve] one paged decode step, {how} (S=8, lengths from "
                f"{lens.tolist()}): host enqueue "
                f"{float(np.median(host)) * 1e3!r} ms, device "
                f"{float(np.median(dev_ms))!r} ms (medians of 8)")
        _graph_log("serve", "paged decode step S=8", step)
    del pool, step

    # (b) prefix caching + 256-token chunks: 8 requests share a 512-token
    # prefix (the first one prefills it, the others hit it) and 4 are cold
    prefix = rng.integers(0, V, 512).tolist()
    shared = [prefix + rng.integers(0, V, n).tolist()
              for n in rng.integers(8, 200, 8)]
    cold = [rng.integers(0, V, n).tolist() for n in rng.integers(64, 701, 4)]
    prompts = shared + cold

    def until_first_prefilled(srv, i):
        if i == 0:
            while srv.stats["prefills"] == 0:
                srv.step()
        return 0

    b_knobs = {"enable_prefix_caching": True, "prefill_chunk_tokens": 256}
    b_batches = [shared[:1], shared[1:] + cold]
    srv, ids, out, counts, _ = _serve_run(
        engine, "prefix+chunked", b_knobs, b_batches, new,
        between=until_first_prefilled)
    st = srv.stats
    check(st["prefix_cache_hits"] > 0,
          "serve prefix+chunked: no prefix-cache hit")
    verify("prefix+chunked", srv, ids, out, prompts, counts, {
        "paged_chunk_attention": L * st["prefill_chunks"],
        "paged_decode_attention": L * (
            st["decode_steps"] + st["async_loop"]["garbage_steps"])})
    del srv
    if "prefix+chunked" in eager:
        _eager_control(engine, "prefix+chunked", b_knobs, b_batches, new,
                       ids, out, between=until_first_prefilled)

    # (c) prompt-lookup speculation, K=4: prompts repeat a 24-token phrase
    phrase = rng.integers(0, V, 24).tolist()
    prompts = [rng.integers(0, V, n).tolist() + phrase * r
               for n, r in zip(rng.integers(1, 40, 8),
                               rng.integers(2, 8, 8))]
    srv, ids, out, counts, _ = _serve_run(
        engine, "speculation K=4", {"speculation_tokens": 4}, [prompts],
        new)
    st = srv.stats
    tpf = st["speculation"]["tokens_per_forward"]
    check(tpf is not None and tpf > 1,
          f"serve speculation: {tpf} tokens per forward, not > 1")
    verify("speculation K=4", srv, ids, out, prompts, counts, {
        "flash_attention_fwd": L * st["prefills"],
        "paged_verify_attention": L * (
            st["speculation"]["verify_steps"]
            + st["async_loop"]["garbage_steps"])})
    del srv
    if "speculation K=4" in eager:
        _eager_control(engine, "speculation K=4", {"speculation_tokens": 4},
                       [prompts], new, ids, out)
    spec_prompts = prompts

    # (d) int8 pool + prefix caching + 256-token chunks + the host tier,
    # under pool pressure: 4 slots of 8 blocks (32 usable) against five
    # 768-token prefixes (30 blocks) with short tails, served in two rounds
    int8_knobs = {"kv_cache_dtype": "int8", "enable_prefix_caching": True,
                  "prefill_chunk_tokens": 256, "num_slots": 4}
    prefixes = [rng.integers(0, V, 768).tolist() for _ in range(5)]
    rounds = [[p + rng.integers(0, V, n).tolist() for p, n in
               zip(prefixes, rng.integers(8, 65, 5))] for _ in range(2)]
    prompts = rounds[0] + rounds[1]
    d_knobs = {**int8_knobs, "kv_host_offload": True, "max_out_tokens": 1024,
               "telemetry": {"trace_sample_rate": 1.0}}
    d_reg, first = MetricRegistry(), {}

    def after_first_round(srv, i):
        if i == 1:
            snap = d_reg.snapshot()
            check(snap["serve_kv_swap_in_total"]["series"][0]["value"] == 0,
                  "serve int8+offload: a swap-in in the first round")
            first.update(_hist(d_reg, "serve_kv_swap_seconds"))
        return 0
    srv, ids, out, counts, _ = _serve_run(
        engine, "int8+prefix+chunked+offload", d_knobs, rounds, new,
        between=after_first_round, drain_each=True, registry=d_reg)
    st = srv.stats
    tier = st["kv_tier"]
    _swap_log("serve", srv, d_reg, first)
    prof = st["step_profile"]
    log(f"[serve] int8+offload step profile: {prof['steps']} steps, wall "
        f"{prof['wall_s']!r} s, device-attributed {prof['device_s']!r} s "
        f"(goodput {prof['goodput_fraction']!r}), by phase (s) "
        f"{prof['phases_s']}, dispatch gap {prof['dispatch_gap']}; "
        f"{prof['phases_s'].get('prefill_chunk', 0.0) / max(st['prefill_chunks'], 1)!r}"
        f" s of prefill_chunk phase a chunk over {st['prefill_chunks']} "
        f"chunks; kv pool {st['kv_pool']}")
    check(tier["kv_dtype"] == "int8" and tier["demotions"] > 0
          and tier["swap_ins"] > 0,
          f"serve int8+offload: no demotion or swap-in ({tier})")
    check(st["prefix_cache_evictions"] == 0 and st["preempted"] == 0,
          f"serve int8+offload: {st['prefix_cache_evictions']} evictions, "
          f"{st['preempted']} preemptions (the tier must take the pressure)")
    check(sum(counts[k] for k in _PAGED_KERNELS[2:5]) == 0,
          f"serve int8+offload: fp paged launches over an int8 pool "
          f"({counts})")
    int8_pool = (tier["pool_bytes"], srv._cache.num_blocks)
    verify("int8+prefix+chunked+offload", srv, ids, out, prompts, counts, {
        "paged_chunk_attention_int8": L * st["prefill_chunks"],
        "paged_decode_attention_int8": L * (
            st["decode_steps"] + st["async_loop"]["garbage_steps"])},
        tol=INT8_E2E_MAX_TOL)
    del srv
    if "int8+prefix+chunked+offload" in eager:
        _eager_control(engine, "int8+prefix+chunked+offload", d_knobs,
                       rounds, new, ids, out, drain_each=True)
    # the control: the same int8 server with a pool that never demotes
    srv, cids, ref, _, _ = _serve_run(
        engine, "int8+prefix+chunked control",
        {**int8_knobs, "max_out_tokens": 2048}, rounds, new, drain_each=True)
    st = srv.stats
    check(st["kv_tier"]["demotions"] == 0
          and st["prefix_cache_evictions"] == 0 and cids == ids,
          f"serve int8 control: it demoted or evicted ({st['kv_tier']})")
    srv.close()
    del srv
    _same_as_control(engine, "int8+prefix+chunked+offload", ids, prompts,
                     out, ref)
    log(f"[serve] pool bytes: fp (a) {fp_pool[0]} for {fp_pool[1]} blocks, "
        f"int8 (d) {int8_pool[0]} for {int8_pool[1]} blocks; per block "
        f"int8/fp {int8_pool[0] / int8_pool[1] / (fp_pool[0] / fp_pool[1])!r}")

    # (e) int8 pool + prompt-lookup speculation K=4 on (c)'s prompts
    e_knobs = {"kv_cache_dtype": "int8", "speculation_tokens": 4}
    srv, ids, out, counts, _ = _serve_run(
        engine, "int8 speculation K=4", e_knobs, [spec_prompts], new)
    st = srv.stats
    tpf = st["speculation"]["tokens_per_forward"]
    check(tpf is not None and tpf > 1,
          f"serve int8 speculation: {tpf} tokens per forward, not > 1")
    check(sum(counts[k] for k in _PAGED_KERNELS[2:5]) == 0,
          f"serve int8 speculation: fp paged launches over an int8 pool "
          f"({counts})")
    verify("int8 speculation K=4", srv, ids, out, spec_prompts, counts, {
        "flash_attention_fwd": L * st["prefills"],
        "paged_verify_attention_int8": L * (
            st["speculation"]["verify_steps"]
            + st["async_loop"]["garbage_steps"])}, tol=INT8_E2E_MAX_TOL)
    del srv
    if "int8 speculation K=4" in eager:
        _eager_control(engine, "int8 speculation K=4", e_knobs,
                       [spec_prompts], new, ids, out)
    return runs


def gpt2_small_config():
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    # HF openai-community/gpt2 config.json, at its published widths and
    # depth: 12 layers, 768 wide, 12 heads of 64, 1024 positions, tied head
    return InferenceTransformerConfig(
        vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
        n_head=12, activation="gelu_new", layer_norm_eps=1e-5,
        positional="learned", tied_lm_head=True, dtype=torch.bfloat16)


GPT2_PARAMS = 124439808   # GPT-2 (124M)'s count, the tied head once


def phase_spec(cfg, params, smi):
    """Speculative decoding and beam search at GPT-2 XL's full width and
    depth (the serving weights), with a GPT-2 (124M) draft of random
    weights from a seed: ``generate_speculative`` at B=8, 32 new tokens,
    K=4, with the 124M draft (the rejection path), with a second engine
    over the target's own weights and with the target as its own draft
    (full acceptance) and with prompt lookup
    on repetitive prompts, each against greedy ``generate`` (near-ties
    within SPEC_TIE_TOL excepted) and with its launch counts (B1, B4, no
    paged kernel); sampled speculation at temperature 1.0 (well formed) and
    1e-6 (greedy); ``generate(num_beams=4)`` on 2 prompts, graphed against
    eager, token for token; then servers with a draft engine (the 124M
    draft, and the target's own weights), graphed, with an eager control,
    and the same requests without speculation. Returns the runs' launch
    counts by name."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.model_implementations.transformer import \
        init_params
    dcfg = gpt2_small_config()
    dparams = init_params(torch.Generator(device="cuda").manual_seed(1),
                          dcfg)
    n_params = sum(p.numel() for p in _leaves(dparams))
    check(n_params == GPT2_PARAMS,
          f"the gpt2 draft has {n_params} parameters, not {GPT2_PARAMS}")

    def engine(c, p):
        return deepspeed_tpu_torch.init_inference(
            (c, p), dtype="bfloat16", max_out_tokens=cfg.n_positions)

    target, draft = engine(cfg, params), engine(dcfg, dparams)
    twin = engine(cfg, params)   # the target's own weights, not copied
    L, Ld, V, new, K = cfg.n_layer, dcfg.n_layer, cfg.vocab_size, 32, 4
    rng = np.random.default_rng(0)   # phase e2e's prompts
    lens = rng.integers(cfg.n_positions // 16, cfg.n_positions * 7 // 8 + 5,
                        8)
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    rng = np.random.default_rng(21)
    phrase = rng.integers(0, V, 24).tolist()
    rep_prompts = [rng.integers(0, V, n).tolist() + phrase * r
                   for n, r in zip(rng.integers(1, 40, 8),
                                   rng.integers(2, 8, 8))]
    rows = list(range(8))
    runs = {}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    # the controls: greedy generate of both prompt sets, warm
    target.generate(prompts, max_new_tokens=3)
    greedy = {}
    for key, ps in (("e2e", prompts), ("repetitive", rep_prompts)):
        target.generate(ps, max_new_tokens=3)
        out, wall = timed(lambda: target.generate(ps, max_new_tokens=new))
        greedy[key] = (out, wall / (len(ps) * new) * 1e3)

    forms = (("124M draft", prompts, draft, "e2e", Ld),
             ("self-draft", prompts, twin, "e2e", L),
             ("draft is self", prompts, target, "e2e", L),
             ("prompt lookup", rep_prompts, None, "repetitive", 0))
    for name, ps, d, key, d_layers in forms:
        def run():
            return target.generate_speculative(ps, d, max_new_tokens=new,
                                               draft_tokens=K)
        run()   # warm-up: the verify and draft graphs warm up and capture
        _launch_counts(reset=True)
        out, wall = timed(run)   # THE main path
        counts = _launch_counts()
        st = dict(target.last_speculative_stats)
        ref, ms_greedy = greedy[key]
        ms_tok = wall / st["tokens"] * 1e3
        log(f"[spec] {smi}: generate_speculative {name}, B=8, {new} new "
            f"tokens, K={K}: {ms_tok!r} ms per committed token against "
            f"{ms_greedy!r} for greedy generate; tokens per round a row "
            f"{st['tokens_per_round'] / len(ps)!r}; {st}; launches "
            f"{counts}")
        ties = _same_as_control(target, name, rows, ps, dict(enumerate(out)),
                                dict(enumerate(ref)), tag="spec",
                                tol=SPEC_TIE_TOL)
        _serve_oracle(target, name, ps, out, new, SPEC_TIE_TOL, tag="spec")
        check(st["tokens"] == 8 * new and all(
            len(r) == len(p) + new for r, p in zip(out, ps)),
            f"spec {name}: {st['tokens']} tokens")
        chunk = target._chunk_graph[1]
        _graph_log("spec", f"{name} verify", chunk)
        runs[f"spec {name}"] = counts
        check(sum(counts[k] for k in _PAGED_KERNELS[2:]) == 0,
              f"spec {name}: a paged kernel launched ({counts})")
        if d is None:
            check(st["draft"] == "prompt-lookup"
                  and counts["flash_attention_fwd"] == L
                  and counts["decode_attention"] == 0,
                  f"spec {name}: launches {counts}")
            check(st["tokens_per_round"] > 1,
                  f"spec {name}: {st['tokens_per_round']} tokens a round")
            continue
        _graph_log("spec", f"{name} draft decode", d._kept_draft[2])
        # the draft runs K decode steps a round; the host learns a round
        # late that no row is live, so one round may run past the end
        # (and change nothing)
        steps, rem = divmod(counts["decode_attention"], d_layers * K)
        check(counts["flash_attention_fwd"] == L + d_layers and rem == 0
              and st["rounds"] <= steps <= st["rounds"] + 1,
              f"spec {name}: launches {counts} for {st['rounds']} rounds")
        if d is not draft:
            # the stat counts the batch's tokens, as JAX's does
            check(st["tokens_per_round"] / len(ps) >= 3.5,
                  f"spec {name}: {st['tokens_per_round'] / len(ps)} tokens "
                  f"a round a row (full acceptance gives 3.5 or more), "
                  f"ties {ties}")
        if d is target:
            check(target._kept_draft[1] is not target._kept[1],
                  "spec draft is self: the draft role shares the main cache")

    # sampled speculation with the 124M draft
    hot = target.generate_speculative(prompts, draft, max_new_tokens=new,
                                      draft_tokens=K, temperature=1.0,
                                      seed=5)
    check(all(len(r) == len(p) + new and r[:len(p)] == p
              and all(0 <= t < V for t in r[len(p):])
              for r, p in zip(hot, prompts)),
          "spec sampled T=1.0: malformed rows")
    log(f"[spec] sampled T=1.0: {target.last_speculative_stats}")
    cold = target.generate_speculative(prompts, draft, max_new_tokens=new,
                                       draft_tokens=K, temperature=1e-6,
                                       seed=5)
    _same_as_control(target, "sampled T=1e-6", rows, prompts,
                     dict(enumerate(cold)), dict(enumerate(greedy["e2e"][0])),
                     tag="spec", tol=SPEC_TIE_TOL)

    # beams: 2 prompts x 4 beams, graphed and eager
    bp = prompts[:2]

    def beams(n):
        return timed(lambda: target.generate(bp, max_new_tokens=n,
                                             num_beams=4))

    beams(3)
    _, t1 = beams(1)
    _launch_counts(reset=True)
    b_out, t_b = beams(new)   # THE main path
    counts = _launch_counts()
    graph = target._kept[2]
    check(counts["flash_attention_fwd"] == L
          and counts["decode_attention"] == L * (new - 1),
          f"spec beams: launches {counts}")
    runs["spec beams"] = counts
    _graph_log("spec", "beams", graph)
    target._cuda_graphs = False
    _, e1 = beams(1)
    e_out, e_b = beams(new)
    target._cuda_graphs = True
    check(e_out == b_out, "spec beams: the graphed beams' tokens differ "
          "from the eager control's")
    log(f"[spec] {smi}: generate(num_beams=4), 2 prompts, {new} new tokens: "
        f"beam step {(t_b - t1) / (new - 1) * 1e3!r} ms graphed, "
        f"{(e_b - e1) / (new - 1) * 1e3!r} ms eager; tokens identical; "
        f"launches {counts}")
    del greedy, hot, cold

    # servers: 16 requests of 64-700 tokens, 8 slots, K=4
    rng = np.random.default_rng(17)
    sp = [rng.integers(0, V, n).tolist() for n in rng.integers(64, 701, 16)]
    batches = [sp[:8], sp[8:]]

    def between(srv, i):
        return 4 if i == 0 else 0

    knobs = {"speculation_tokens": K}
    tps = {}
    for name, d, d_layers in (("124M draft K=4", draft, Ld),
                              ("self-draft K=4", twin, L)):
        srv, ids, out, counts, rate = _serve_run(
            target, name, knobs, batches, new, between=between, draft=d)
        st = srv.stats
        spc = st["speculation"]
        rounds = spc["verify_steps"] + st["async_loop"]["garbage_steps"]
        check(spc["draft"] == "model" and spc["draft_decode_traces"] == 1
              and spc["verify_traces"] == 1
              and spc["draft_prefill_traces"] == -1,
              f"serve {name}: speculation stats {spc}")
        _check_served(target, name, ids, out, sp, counts, {
            "flash_attention_fwd": (L + d_layers) * st["prefills"],
            "paged_verify_attention": L * rounds,
            "paged_decode_attention": d_layers * K * rounds}, new,
            SPEC_TIE_TOL)
        tps[name] = (rate, spc["tokens_per_forward"])
        if d is twin:
            check(spc["tokens_per_forward"] >= 3,
                  f"serve {name}: {spc['tokens_per_forward']} tokens per "
                  f"forward (full acceptance gives 3 or more)")
        runs[f"serve {name}"] = counts
        srv.close()
        del srv
        if d is draft:
            _eager_control(target, name, knobs, batches, new, ids, out,
                           between=between, draft=d)
    srv, ids, out, counts, rate = _serve_run(target, "no speculation", {},
                                             batches, new, between=between)
    st = srv.stats
    _check_served(target, "no speculation", ids, out, sp, counts, {
        "flash_attention_fwd": L * st["prefills"],
        "paged_decode_attention": L * (
            st["decode_steps"] + st["async_loop"]["garbage_steps"])}, new)
    tps["no speculation"] = (rate, None)
    runs["serve no speculation"] = counts
    srv.close()
    del srv, target, twin, draft, dparams
    log(f"[spec] {smi}: server tokens/s and tokens per forward, 16 requests "
        f"x {new} tokens, graphs: {tps}")
    return runs


# phase int8. w8a8 first-step logits against the dequantized path over the
# same per-output-channel weights: the only difference is the activation's
# per-token int8 quant, an error of at most amax/254 an element (~0.5% of a
# row's rms for a Gaussian-like row of 1600), entering each of the 192
# projections of GPT-2 XL; through 48 random-weight layers such input
# noise compounds to a few percent of the logits, where a wrong scale, a
# transposed weight or a garbage pad row moves them by O(1) relative
W8A8_LOGIT_L2 = 0.1   # relative L2 over the [8, V] logits
# int8 training's losses against bf16 training on the same batches from
# the same weights: SwitchBack adds per-token int8 noise to the forward
# and dx products; after a few AdamW steps at lr 1e-4 the trajectories
# part by far less than the 11.2 -> ~10 fall of the loss, while a wrong
# gradient scale or a transposed product stalls or diverges it
INT8_TRAIN_MARGIN = 2e-2   # relative, per step
INT8_TRAIN_STEPS = 3


def _graphed_once(fn, *args):
    """``fn(*args)`` through the port's graph runner: warmed up, captured,
    replayed once; the replay's output."""
    from deepspeed_tpu_torch.inference.cuda_graph import GraphedStep
    step = GraphedStep("int8_mm check", fn, args, lambda: ())
    step()   # warm-up
    out = step()
    check(step.captures == 1 and step.replays == 1,
          "the int8_mm check did not replay a graph")
    return out


def _int_mm_exact(tag, shapes, make_b):
    """``int8_mm`` (``torch._int_mm``, rows padded to 17) against the
    exact integer product (f64 GEMM: every partial sum is an integer below
    2**53) for each (name, M, K, N), eagerly and, for M <= 16 (the padded
    rows), replayed from a captured graph."""
    from deepspeed_tpu_torch.ops.int8_gemm import int8_mm
    g = torch.Generator(device="cuda").manual_seed(7)
    done = []
    for name, M, K, N in shapes:
        a = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                          dtype=torch.int8)
        b = make_b(name, K, N, g)
        want = a.double() @ b.double()
        outs = [int8_mm(a, b)] + ([_graphed_once(int8_mm, a, b)]
                                  if M < 17 else [])
        for out in outs:
            check(out.dtype == torch.int32 and torch.equal(out.double(), want),
                  f"[{tag}] _int_mm {name} at M={M}: not the exact integer "
                  f"product")
        done.append(f"{name} [{M}, {K}] x [{K}, {N}]"
                    + (" (+graph)" if M < 17 else ""))
        del a, b, want, outs
    log(f"[{tag}] _int_mm exact against the integer product: {done}")


def phase_int8(cfg, params, smi):
    """GPT-2 XL (phase e2e's weights) served from int8 weights: weight
    bytes in bf16, row-group int8 and per-output-channel int8; ``generate``
    with ``dtype="int8"`` (graphed) against a bf16 engine over the
    dequantized weights (the same tokens) and its eager control; w8a8
    (``quant.activation``): ``_int_mm`` exact at one layer's shapes, its
    first-step logits against the dequantized path over the same weights,
    its greedy agreement with bf16; the default server over each engine
    (the served-token oracle, tokens/s); and an int8 serving checkpoint
    round trip. Returns the runs' launch counts by name."""
    import tempfile

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.integrity import dir_bytes
    from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
    from deepspeed_tpu_torch.inference.engine import (load_serving_checkpoint,
                                                      save_serving_checkpoint)
    from deepspeed_tpu_torch.model_implementations.transformer import prefill
    from deepspeed_tpu_torch.module_inject.quantize import tree_weight_bytes
    from deepspeed_tpu_torch.ops.int8_gemm import is_quantized, weight_as
    L, V, new, steps = cfg.n_layer, cfg.vocab_size, 32, 31
    rng = np.random.default_rng(0)   # phase e2e's prompts
    lens = rng.integers(cfg.n_positions // 16, cfg.n_positions * 7 // 8 + 5, 8)
    prompts = [rng.integers(0, V, n).tolist() for n in lens]
    runs, decode_ms, engines = {}, {}, {}

    def build(name, p, **kw):
        gc.collect()   # engines and their graphs hold reference cycles
        torch.cuda.synchronize()
        m0, t = torch.cuda.memory_allocated(), time.perf_counter()
        eng = deepspeed_tpu_torch.init_inference(
            (cfg, p), max_out_tokens=cfg.n_positions, **kw)
        torch.cuda.synchronize()
        log(f"[int8] {name} engine: weights {tree_weight_bytes(eng.params)} "
            f"bytes (tree_weight_bytes), {torch.cuda.memory_allocated() - m0}"
            f" bytes newly allocated (memory_allocated; bf16 leaves are "
            f"shared with the caller's), placed and quantized in "
            f"{time.perf_counter() - t!r} s")
        engines[name] = eng
        return eng

    def timed(eng, n):
        t = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=n)
        return out, time.perf_counter() - t

    def gen(name, eng):
        """Graphed generate of 8 x 32 tokens, its launches read just
        around it, and decode ms per step from two (32 - 1 token) pairs."""
        timed(eng, 3)   # warm-up: cuBLAS, the decode graph's capture
        _, t_pre = timed(eng, 1)
        _launch_counts(reset=True)
        out, t_gen = timed(eng, new)   # a main path
        counts = _launch_counts()
        _, t_pre2 = timed(eng, 1)
        _, t_gen2 = timed(eng, new)
        check(counts["flash_attention_fwd"] == L
              and counts["decode_attention"] == L * steps,
              f"[int8] {name}: launches {counts}")
        for b, row in enumerate(out):
            check(len(row) == lens[b] + new and row[:lens[b]] == prompts[b]
                  and all(0 <= x < V for x in row[lens[b]:]),
                  f"[int8] {name}: row {b} malformed")
        graph = eng._kept[2]
        check(graph is not None and graph.replays > 0,
              f"[int8] {name}: the decode step did not replay a graph")
        ms = [(a - b) / steps * 1e3 for a, b in ((t_gen, t_pre),
                                                 (t_gen2, t_pre2))]
        decode_ms[name] = ms
        log(f"[int8] {name} generate 8 x {new} tokens (graphed): {t_gen!r} "
            f"s; decode {ms[0]!r} and {ms[1]!r} ms per step; prefill "
            f"{t_pre * 1e3!r} ms; {smi}")
        runs[f"int8 phase generate {name}"] = counts
        return out

    bf16_bytes = tree_weight_bytes(params)
    log(f"[int8] bf16 weights: {bf16_bytes} bytes (tree_weight_bytes)")
    ref16 = gen("bf16", build("bf16", params, dtype="bfloat16"))

    # weight-only int8 (row-group scales), against a bf16 engine over the
    # dequantized weights: the same products on the same values
    eng8 = build("int8", params, dtype="int8")
    w = eng8.params["layers"][0]["mlp"]["wi"]
    check(is_quantized(w) and w["q"].dtype == torch.int8
          and w["scale"].dtype == torch.float32,
          "[int8] dtype='int8' did not store int8 q/scale leaves")
    out8 = gen("int8", eng8)

    def deq(x):
        if is_quantized(x):
            return weight_as(x, torch.bfloat16)
        if isinstance(x, dict):
            return {k: deq(v) for k, v in x.items()}
        if isinstance(x, list):
            return [deq(v) for v in x]
        return x
    engd = deepspeed_tpu_torch.init_inference(
        (cfg, deq(eng8.params)), dtype="bfloat16",
        max_out_tokens=cfg.n_positions)
    outd = engd.generate(prompts, max_new_tokens=new)
    del engd
    torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(out8, outd))
    log(f"[int8] dequant oracle: {same} of 8 rows of the int8 engine equal "
        f"a bf16 engine's over the dequantized weights")
    check(same == 8, "[int8] int8 generate differs from bf16 over the "
          "dequantized weights")
    eng8._cuda_graphs = False
    t = time.perf_counter()
    oute = eng8.generate(prompts, max_new_tokens=new)
    eng8._cuda_graphs = True
    log(f"[int8] int8 eager control: {time.perf_counter() - t!r} s, "
        f"{sum(a == b for a, b in zip(out8, oute))} of 8 rows equal the "
        f"graphed run's")
    check(oute == out8, "[int8] graphed int8 generate differs from eager")

    # w8a8: per-output-channel int8, every projection an int8 GEMM
    engw = build("w8a8", params, dtype="bfloat16",
                 quant={"enabled": True, "activation": {"enabled": True}})
    lay = engw.params["layers"][0]
    mats = {"qkv (wq)": lay["attn"]["wq"], "attn out": lay["attn"]["wo"],
            "mlp in": lay["mlp"]["wi"], "mlp out": lay["mlp"]["wo"]}
    two_d = {}
    for name, node in mats.items():
        c = 2 if name == "attn out" else 1
        q2 = node["q"].reshape(node["q"].shape[:c].numel(), -1)
        check("oscale" in node and q2.stride(0) == 1,
              f"[int8] w8a8 {name}: not an oscale leaf stored column-major")
        two_d[name] = q2
    _int_mm_exact("int8", [(n, M, *two_d[n].shape) for n in two_d
                           for M in (8, 8 * cfg.n_positions)],
                  lambda n, K, N, g: two_d[n])
    ids = np.zeros((8, cfg.n_positions), np.int64)
    for b, p in enumerate(prompts):
        ids[b, :len(p)] = p
    first = []
    with torch.inference_mode():
        for mc in (engw.model_config, dataclasses.replace(
                engw.model_config, int8_compute=False)):
            cache = engw._make_cache(8, cfg.n_positions)
            first.append(prefill(engw.params, mc,
                                 torch.as_tensor(ids, device="cuda"),
                                 torch.as_tensor(lens, device="cuda"),
                                 cache)[0].float())
    l2 = ((first[0] - first[1]).norm() / first[1].norm()).item()
    agree = int((first[0].argmax(-1) == first[1].argmax(-1)).sum())
    log(f"[int8] w8a8 first-step logits against the dequantized path over "
        f"the same weights: relative L2 {l2!r} (tol {W8A8_LOGIT_L2}), max "
        f"|diff| {(first[0] - first[1]).abs().max().item()!r} at max |logit| "
        f"{first[1].abs().max().item()!r}; argmax equal on {agree} of 8 rows")
    check(math.isfinite(l2) and l2 <= W8A8_LOGIT_L2,
          "[int8] w8a8 logits far from the dequantized path's")
    del first
    outw = gen("w8a8", engw)

    def agreement(out):
        """Generated tokens equal to bf16's up to each row's first
        divergence, of 8 x 32."""
        n = 0
        for a, b, p in zip(out, ref16, prompts):
            for x, y in zip(a[len(p):], b[len(p):]):
                if x != y:
                    break
                n += 1
        return n
    log(f"[int8] greedy agreement with bf16 (tokens before each row's first "
        f"divergence, of {8 * new}): int8 {agreement(out8)}, w8a8 "
        f"{agreement(outw)}; decode ms per step (graphed, B=8) bf16 "
        f"{decode_ms['bf16']!r}, int8 {decode_ms['int8']!r}, w8a8 "
        f"{decode_ms['w8a8']!r}; {smi}")

    # the default server (phase serve's (a): 16 requests of 64-700 tokens,
    # 8 then 8) over each engine
    srng = np.random.default_rng(5)
    sprompts = [srng.integers(0, V, n).tolist()
                for n in srng.integers(64, 701, 16)]
    tps = {}
    for name, eng in engines.items():
        srv, sids, sout, counts, tps[name] = _serve_run(
            eng, f"default over {name} weights", {},
            [sprompts[:8], sprompts[8:]], new,
            between=lambda s, i: 4 if i == 0 else 0)
        st = srv.stats
        _check_served(eng, f"default over {name} weights", sids, sout,
                      sprompts, counts, {
                          "flash_attention_fwd": L * st["prefills"],
                          "paged_decode_attention": L * (
                              st["decode_steps"]
                              + st["async_loop"]["garbage_steps"])}, new)
        runs[f"int8 phase serve {name}"] = counts
        srv.close()
        del srv
    log(f"[int8] default server tokens/s: bf16 {tps['bf16']!r}, int8 "
        f"{tps['int8']!r}, w8a8 {tps['w8a8']!r}; {smi}")
    del engines["bf16"], engines["w8a8"], engw
    torch.cuda.empty_cache()

    # an int8 serving checkpoint round trip
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="int8_serving_", dir=root)
    try:
        t = time.perf_counter()
        save_serving_checkpoint(eng8, tmp)
        save_s = time.perf_counter() - t
        nbytes = dir_bytes(tmp)
        t = time.perf_counter()
        back = load_serving_checkpoint(tmp, DeepSpeedInferenceConfig(
            dtype="bfloat16", max_out_tokens=cfg.n_positions))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        node = back.params["layers"][0]["mlp"]["wi"]
        check(set(node) == {"q", "scale"} and node["q"].dtype == torch.int8
              and node["scale"].dtype == torch.float32,
              "[int8] the reloaded checkpoint's int8 leaves changed dtype")
        outb = back.generate(prompts, max_new_tokens=new)
        check(outb == out8, "[int8] the reloaded int8 serving checkpoint "
              "serves other tokens")
        log(f"[int8] int8 serving checkpoint: {nbytes} bytes, save "
            f"{save_s!r} s, load {load_s!r} s; the reloaded engine serves "
            f"the same tokens")
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del eng8, engines
    torch.cuda.empty_cache()
    return runs


def phase_int8_train(preset="gpt2-1.3b"):
    """SwitchBack int8 training of a GPT-2 preset at full width and depth
    (phase train's configuration) against bf16 training from the same
    weights on the same batches: ``_int_mm`` exact at the forward and dx
    shapes, launch counts, finite losses within INT8_TRAIN_MARGIN of
    bf16's, step ms of both. Returns the runs' launch counts by name."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMModel, config_for
    from deepspeed_tpu_torch.ops.int8_training import switchback_matmul
    from deepspeed_tpu_torch.ops.quant_core import quantize_int8
    base = config_for(preset)
    L, T, C = base.n_layer, base.n_positions, base.n_embd
    micro, gas = 8, 2
    M = micro * T

    def quantized_weight(name, K, N, g):
        # as SwitchBack quantizes: the forward's per-column q(w) (row-major,
        # made column-major by int8_mm), dx's per-tensor q(w^T) (a
        # column-major view), the logits' q(wte^T)
        if name.startswith("dx"):
            w = torch.randn(N, K, generator=g, device="cuda",
                            dtype=torch.bfloat16)
            return quantize_int8(w.float().t(), None)[0]
        if name == "logits":
            w = torch.randn(N, K, generator=g, device="cuda",
                            dtype=torch.bfloat16).t()
        else:
            w = torch.randn(K, N, generator=g, device="cuda",
                            dtype=torch.bfloat16)
        return quantize_int8(w, 0)[0]
    _int_mm_exact("int8 train", [
        ("fwd c_attn", M, C, 3 * C), ("fwd c_fc", M, C, 4 * C),
        ("dx c_fc", M, 4 * C, C), ("dx c_attn", M, 3 * C, C),
        ("logits", M, C, base.padded_vocab_size)], quantized_weight)

    rng = np.random.default_rng(7)
    batches = [{"input_ids": rng.integers(0, base.vocab_size,
                                          (micro * gas, T), dtype=np.int32)}
               for _ in range(INT8_TRAIN_STEPS + 1)]
    res, runs = {}, {}
    for int8 in (False, True):
        name = "int8" if int8 else "bf16"
        model = GPT2LMModel(dataclasses.replace(base, int8_training=int8))
        check((model.module.h_0.mlp.c_fc.matmul is switchback_matmul) == int8,
              f"[int8 train] {name}: Dense products not routed as asked")
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=model,
            model_parameters=model.init(
                torch.Generator(device="cuda").manual_seed(0)),
            config={"train_micro_batch_size_per_gpu": micro,
                    "gradient_accumulation_steps": gas,
                    "gradient_clipping": 1.0, "bf16": {"enabled": True},
                    "optimizer": {"type": "AdamW", "params": {
                        "lr": 1e-4, "weight_decay": 0.01}}})
        torch.cuda.empty_cache()
        losses = [float(engine.train_batch(batches[0])["loss"])]   # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _launch_counts(reset=True)
        walls = []
        for b in batches[1:]:   # a main path
            t = time.perf_counter()
            losses.append(float(engine.train_batch(b)["loss"]))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        counts = _launch_counts()
        n = INT8_TRAIN_STEPS * gas
        check(counts["flash_attention_fwd"] == 2 * L * n
              and counts["flash_attention_bwd_dq"] == L * n
              and counts["flash_attention_bwd_dkv"] == L * n,
              f"[int8 train] {name}: launches {counts}")
        check(all(math.isfinite(x) for x in losses),
              f"[int8 train] {name}: non-finite loss {losses}")
        step = float(np.median(walls))
        tok_s = micro * gas * T / step
        mfu = model.flops_per_token() * tok_s / H100_BF16_FLOPS
        log(f"[int8 train] {preset} {name}: {INT8_TRAIN_STEPS} steps of "
            f"{micro} x {gas} x {T} tokens after a warm-up: step ms "
            f"{[x * 1e3 for x in walls]!r}, median {step * 1e3!r} ms; "
            f"{tok_s!r} tokens/s; MFU {mfu!r} (6N at 989 TFLOP/s); peak memory "
            f"{torch.cuda.max_memory_allocated()} bytes; losses {losses!r}")
        res[name] = (losses, step)
        runs[f"train {name} (int8 phase)"] = counts
        del engine, model
        torch.cuda.empty_cache()
    (l16, s16), (l8, s8) = res["bf16"], res["int8"]
    rel = [abs(a - b) / b for a, b in zip(l8, l16)]
    log(f"[int8 train] {preset}: int8 against bf16 on the same batches: "
        f"losses {l8!r} vs {l16!r}, relative differences {rel!r} (margin "
        f"{INT8_TRAIN_MARGIN}); step ms int8 {s8 * 1e3!r}, bf16 "
        f"{s16 * 1e3!r}")
    check(l8 != l16, "[int8 train] int8 losses equal bf16's bit for bit: "
          "SwitchBack did not run")
    check(max(rel) <= INT8_TRAIN_MARGIN,
          "[int8 train] int8 losses outside the margin of bf16's")
    return runs


def phase_model(tag, cfg, params, seed, eager=(), pools=("fp", "int8"),
                engine=None, n_ctx=None):
    """A served model at its published widths and depth: ``generate``
    through B1 and B4 (phase e2e's gates, over ``n_ctx`` tokens), then two
    paged servers a pool of ``pools`` (fp, int8) over one engine (``engine``
    or a new one over ``(cfg, params)``): prefix caching with 256-token
    chunks (B6/B6i and B5/B5i) and prompt-lookup speculation K=4 (B1 and
    B7/B7i; a speculative server verifies every round, so its decode runs
    through B7). Each server's launch counts are set to 0 just before it
    and read just after; each is held to the served-token oracle. The
    servers named in ``eager`` are run again with their step graphs off
    and must serve the same tokens. Returns the runs' launch counts by
    name."""
    import deepspeed_tpu_torch
    runs = {f"{tag} e2e": phase_e2e(cfg, params, tag=tag, engine=engine,
                                    n_ctx=n_ctx)}
    if engine is None:
        engine = deepspeed_tpu_torch.init_inference((cfg, params),
                                                    dtype="bfloat16")
    L, V, new = cfg.n_layer, cfg.vocab_size, 32
    rng = np.random.default_rng(seed)
    engine.generate([[1, 2, 3]], max_new_tokens=2)   # warm-up
    prefix = rng.integers(0, V, 512).tolist()
    shared = [prefix + rng.integers(0, V, n).tolist()
              for n in rng.integers(8, 200, 8)]
    cold = [rng.integers(0, V, n).tolist() for n in rng.integers(64, 701, 4)]
    phrase = rng.integers(0, V, 24).tolist()
    spec = [rng.integers(0, V, n).tolist() + phrase * r
            for n, r in zip(rng.integers(1, 40, 8), rng.integers(2, 8, 8))]

    def until_first_prefilled(srv, i):
        if i == 0:
            while srv.stats["prefills"] == 0:
                srv.step()
        return 0

    for pool in pools:
        sfx, tol = (("", E2E_MAX_TOL) if pool == "fp"
                    else ("_int8", INT8_E2E_MAX_TOL))
        knobs = {} if pool == "fp" else {"kv_cache_dtype": "int8"}
        name = f"{tag} {pool} prefix+chunked"
        b_knobs = {**knobs, "enable_prefix_caching": True,
                   "prefill_chunk_tokens": 256}
        b_batches = [shared[:1], shared[1:] + cold]
        srv, ids, out, counts, _ = _serve_run(
            engine, name, b_knobs, b_batches, new,
            between=until_first_prefilled)
        st = srv.stats
        check(st["prefix_cache_hits"] > 0, f"serve {name}: no prefix hit")
        if pool == "int8":
            check(sum(counts[k] for k in _PAGED_KERNELS[2:5]) == 0,
                  f"serve {name}: fp paged launches over an int8 pool")
        _check_served(engine, name, ids, out, shared + cold, counts, {
            f"paged_chunk_attention{sfx}": L * st["prefill_chunks"],
            f"paged_decode_attention{sfx}": L * (
                st["decode_steps"] + st["async_loop"]["garbage_steps"])},
            new, tol)
        runs[name] = counts
        srv.close()
        del srv
        if name in eager:
            _eager_control(engine, name, b_knobs, b_batches, new, ids, out,
                           between=until_first_prefilled)
        name = f"{tag} {pool} speculation K=4"
        c_knobs = {**knobs, "speculation_tokens": 4}
        srv, ids, out, counts, _ = _serve_run(engine, name, c_knobs,
                                              [spec], new)
        st = srv.stats
        tpf = st["speculation"]["tokens_per_forward"]
        check(tpf is not None and tpf > 1,
              f"serve {name}: {tpf} tokens per forward, not > 1")
        if pool == "int8":
            check(sum(counts[k] for k in _PAGED_KERNELS[2:5]) == 0,
                  f"serve {name}: fp paged launches over an int8 pool")
        _check_served(engine, name, ids, out, spec, counts, {
            "flash_attention_fwd": L * st["prefills"],
            f"paged_verify_attention{sfx}": L * (
                st["speculation"]["verify_steps"]
                + st["async_loop"]["garbage_steps"])}, new, tol)
        runs[name] = counts
        srv.close()
        del srv
        if name in eager:
            _eager_control(engine, name, c_knobs, [spec], new, ids, out)
    del engine
    return runs


def phase_pythia(eager=()):
    """Pythia-2.8B (32 heads of 80) at its published widths and depth,
    random weights from a seed, through ``phase_model``."""
    cfg = pythia_2p8b_config()
    params = make_params(cfg)
    n_params = sum(p.numel() for p in _leaves(params))
    check(n_params == PYTHIA_PARAMS,
          f"pythia-2.8b has {n_params} parameters, not {PYTHIA_PARAMS}")
    runs = phase_model("pythia", cfg, params, 15, eager)
    del params
    torch.cuda.empty_cache()
    return runs


def phase_gptj(eager=()):
    """GPT-J-6B (16 heads of 256: B1 and B4-B7, B5i-B7i on their 256-wide
    instantiation) at its published widths and depth, random weights from
    a seed (and a random head bias: GPT-J's head has one), through
    ``phase_model``. The parameter gate counts the leaves less the zero
    q, k, v and out biases ``init_params`` adds, which GPT-J lacks."""
    cfg = gptj_6b_config()
    params = make_params(cfg)
    g = torch.Generator(device="cuda").manual_seed(1)
    params["lm_head_bias"] = (0.02 * torch.randn(
        cfg.vocab_size, generator=g, device="cuda")).to(cfg.dtype)
    zero_biases = sum(lay["attn"][k].numel() for lay in params["layers"]
                      for k in ("bq", "bk", "bv", "bo"))
    n_params = sum(p.numel() for p in _leaves(params)) - zero_biases
    check(n_params == GPTJ_PARAMS,
          f"gpt-j-6b has {n_params} parameters, not {GPTJ_PARAMS}")
    check(cfg.head_dim == 256, f"gpt-j-6b head dim {cfg.head_dim}")
    runs = phase_model("gptj", cfg, params, 16, eager)
    del params
    torch.cuda.empty_cache()
    return runs


# HF mistralai/Mistral-7B-v0.2 config.json (the repo's llama-7b-gqa widths,
# JAX models/llama.py:111, with Mistral's context and rope_theta)
MISTRAL_7B = {
    "architectures": ["MistralForCausalLM"], "model_type": "mistral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "hidden_act": "silu",
    "max_position_embeddings": 32768, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "sliding_window": None,
    "tie_word_embeddings": False, "bos_token_id": 1, "eos_token_id": 2,
    "torch_dtype": "bfloat16"}
MISTRAL_PARAMS = 7241732096   # Mistral-7B's count (MistralForCausalLM)
HF_CTX = 2048                 # phase hf's generate and dense cache length
HF_FILE_LAYERS = 2            # the file route's depth (a cut for time)


def mistral_serving_config():
    """The serving config ``LlamaPolicy`` makes of ``MISTRAL_7B``."""
    from deepspeed_tpu_torch.model_implementations.transformer import \
        InferenceTransformerConfig
    return InferenceTransformerConfig(
        vocab_size=32000, n_positions=32768, n_embd=4096, n_layer=32,
        n_head=32, n_kv_head=8, intermediate_size=14336,
        positional="rotary", rotary_dim=128, rotary_base=1e6,
        activation="silu", norm_type="rmsnorm", gated_mlp=True,
        layer_norm_eps=1e-5, tied_lm_head=False, dtype=torch.bfloat16)


def mistral_state_dict(hf, seed, dev="cuda"):
    """HF-named Mistral weights from a seeded generator on the card, bf16:
    each projection ``[out, in]`` N(0, 1) / sqrt(in) (``init_params``'s
    scheme), the RMSNorm weights 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    E, F, V = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    H, KH = hf["num_attention_heads"], hf["num_key_value_heads"]
    D = E // H

    def dense(out, inp):
        w = torch.randn((out, inp), generator=g, device=dev,
                        dtype=torch.float32)
        return (w / math.sqrt(inp)).to(torch.bfloat16)

    def ones():
        return torch.ones(E, dtype=torch.bfloat16, device=dev)
    sd = {"model.embed_tokens.weight": dense(V, E), "model.norm.weight":
          ones(), "lm_head.weight": dense(V, E)}
    for i in range(hf["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": ones(),
            p + "post_attention_layernorm.weight": ones(),
            p + "self_attn.q_proj.weight": dense(H * D, E),
            p + "self_attn.k_proj.weight": dense(KH * D, E),
            p + "self_attn.v_proj.weight": dense(KH * D, E),
            p + "self_attn.o_proj.weight": dense(E, H * D),
            p + "mlp.gate_proj.weight": dense(F, E),
            p + "mlp.up_proj.weight": dense(F, E),
            p + "mlp.down_proj.weight": dense(E, F)})
    torch.cuda.synchronize()
    return sd


def _llama_tree_shapes(cfg):
    """The shapes of a converted LLaMA-layout tree of ``cfg``: what
    ``InferenceTransformerConfig`` prescribes (GQA k/v of ``kv_heads``,
    zero biases where the checkpoint has none)."""
    E, H, KH, D, F = (cfg.n_embd, cfg.n_head, cfg.kv_heads, cfg.head_dim,
                      cfg.ffn)
    layer = {"ln1": {"scale": (E,)}, "ln2": {"scale": (E,)},
             "attn": {"wq": (E, H, D), "wk": (E, KH, D), "wv": (E, KH, D),
                      "bq": (H, D), "bk": (KH, D), "bv": (KH, D),
                      "wo": (H, D, E), "bo": (E,)},
             "mlp": {"wg": (E, F), "bg": (F,), "wi": (E, F), "bi": (F,),
                     "wo": (F, E), "bo": (E,)}}
    return {"wte": (cfg.vocab_size, E), "ln_f": {"scale": (E,)},
            "lm_head": (E, cfg.vocab_size),
            "layers": [layer] * cfg.n_layer}


def _shape_tree(tree):
    if isinstance(tree, dict):
        return {k: _shape_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shape_tree(v) for v in tree]
    return tuple(tree.shape)


def _same_tree(a, b, path=""):
    """``a`` and ``b`` hold the same keys and bit-identical leaves."""
    if isinstance(b, dict):
        check(isinstance(a, dict) and set(a) == set(b),
              f"tree keys differ at {path or 'the root'}")
        for k in b:
            _same_tree(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        check(isinstance(a, list) and len(a) == len(b),
              f"tree lists differ at {path}")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}.{i}")
    else:
        check(a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a, b), f"leaf {path} differs")


def phase_hf(smi):
    """An HF checkpoint of the Mistral-7B-v0.2 layout served through the
    policy table. (a) At full width and depth: an HF-named bf16 state dict
    made from a seed on the card, wrapped with its config in a
    ``CheckpointModelView`` and converted by ``init_inference(view)``
    (``LlamaPolicy``, on the card); the state dict freed, phase e2e's
    ``generate`` and gates over ``HF_CTX`` tokens (B1, B4), then an fp-pool
    server with prefix caching and 256-token chunks (B6, B5) and a
    prompt-lookup server (B7), each with its launch counts and the
    served-token oracle. (b) At ``HF_FILE_LAYERS`` layers: the same layout
    written with the port's writers as sharded safetensors and as
    ``pytorch_model.bin`` under a temporary dir of ``build/`` (removed at
    the end), each loaded by ``init_inference(path)`` into a tree bit for
    bit the in-memory route's that serves its greedy tokens. Returns the
    runs' launch counts by name."""
    import tempfile
    from types import SimpleNamespace

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.module_inject.policies import convert_hf_model
    from deepspeed_tpu_torch.module_inject.state_dict_loader import \
        CheckpointModelView
    from deepspeed_tpu_torch.utils.safetensors_io import save_sharded

    # (a) the in-memory route at full width and depth
    t0 = time.perf_counter()
    sd = mistral_state_dict(MISTRAL_7B, seed=0)
    n_params = sum(t.numel() for t in sd.values())
    sd_bytes = sum(t.nbytes for t in sd.values())
    log(f"[hf] Mistral-7B-v0.2 layout state dict on the card: {n_params} "
        f"parameters, {sd_bytes} bytes in {time.perf_counter() - t0!r} s")
    check(n_params == MISTRAL_PARAMS,
          f"mistral-7b has {n_params} parameters, not {MISTRAL_PARAMS}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = deepspeed_tpu_torch.init_inference(
        CheckpointModelView(sd, SimpleNamespace(**MISTRAL_7B)),
        dtype="bf16", max_out_tokens=HF_CTX)
    torch.cuda.synchronize()
    t_conv = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    cfg = engine.model_config
    log(f"[hf] init_inference(CheckpointModelView) converted through "
        f"LlamaPolicy on the card in {t_conv!r} s (peak memory {peak} "
        f"bytes; {smi})")
    expect = mistral_serving_config()
    check(cfg == expect, f"converted config {cfg} is not {expect}")
    check(_shape_tree(engine.params) == _llama_tree_shapes(cfg),
          "the converted tree's shapes are not the config's")
    check(all(t.is_cuda and t.dtype == torch.bfloat16
              for t in _leaves(engine.params)),
          "a converted leaf is off the card or not bf16")
    runs = phase_model("hf", cfg, engine.params, 19, pools=("fp",),
                       engine=engine, n_ctx=HF_CTX)
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the file route at HF_FILE_LAYERS layers
    hf2 = {**MISTRAL_7B, "num_hidden_layers": HF_FILE_LAYERS}
    sd2 = mistral_state_dict(hf2, seed=1)
    ref_cfg, ref = convert_hf_model(
        CheckpointModelView(sd2, SimpleNamespace(**hf2)), torch.bfloat16)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in rng.integers(32, 400, 8)]
    mem = deepspeed_tpu_torch.init_inference((ref_cfg, ref), dtype="bf16",
                                             max_out_tokens=512)
    _launch_counts(reset=True)
    want = mem.generate(prompts, max_new_tokens=16)
    runs["hf file in-memory"] = _launch_counts()
    del mem
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="hf_smoke_", dir=root)
    try:
        host = {k: v.cpu() for k, v in sd2.items()}
        del sd2
        dirs = {"sharded safetensors": os.path.join(tmp, "safetensors"),
                "pytorch_model.bin": os.path.join(tmp, "bin")}
        t0 = time.perf_counter()
        os.makedirs(dirs["sharded safetensors"])
        files = save_sharded(host, dirs["sharded safetensors"], 512 * 2**20)
        os.makedirs(dirs["pytorch_model.bin"])
        torch.save(host, os.path.join(dirs["pytorch_model.bin"],
                                      "pytorch_model.bin"))
        for d in dirs.values():
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(hf2, f)
        log(f"[hf] wrote {len(files)} safetensors shards and an index, and "
            f"pytorch_model.bin, in {time.perf_counter() - t0!r} s")
        check(len(files) >= 2, f"{len(files)} shard files, not >= 2")
        del host
        for layout, d in dirs.items():
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng = deepspeed_tpu_torch.init_inference(d, dtype="bf16",
                                                     max_out_tokens=512)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            check(eng.model_config == ref_cfg,
                  f"{layout}: config {eng.model_config} != {ref_cfg}")
            _same_tree(eng.params, ref)
            _launch_counts(reset=True)
            out = eng.generate(prompts, max_new_tokens=16)
            counts = runs[f"hf file {layout}"] = _launch_counts()
            check(out == want, f"{layout}: generate's tokens differ from "
                  f"the in-memory route's")
            check(counts["flash_attention_fwd"] > 0
                  and counts["decode_attention"] > 0,
                  f"{layout}: generate launched {counts}")
            log(f"[hf] init_inference({layout} dir, {HF_FILE_LAYERS} "
                f"layers): {nbytes} bytes loaded and converted in "
                f"{t_load!r} s = {nbytes / t_load / 1e9!r} GB/s (page cache "
                f"warm: written just before); tree bit for bit the "
                f"in-memory route's; 8 x 16 greedy tokens equal; {smi}")
            del eng
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# the training runs of phase llama_bert, shared with
# scripts/profile_train_models.py: (preset, config overrides, micro, gas,
# T, parameters: JAX's trees counted with jax.eval_shape). llama-7b-gqa
# runs 8 of its 32 layers; bert-large's dropout ratios are 0 until A9
LLAMA_RUNS = (("llama-1b", {}, 4, 2, 2048, 940640256),
              ("llama-7b-gqa", {"n_layer": 8}, 2, 1, 4096, 2007044096))
BERT_RUN = ("bert-large", {"hidden_dropout_prob": 0.0,
                           "attention_probs_dropout_prob": 0.0},
            16, 2, 512, 336226108)
BERT_PAD = 64   # the masked step's padding keys at the end of every row


def bert_batch(cfg, rng, B, T):
    """A BERT pre-training batch of B rows of T tokens: random ids, token
    type 0 then 1 over the two halves, 15% live MLM labels, NSP labels."""
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) >= 0.15] = -100
    return {"input_ids": rng.integers(0, cfg.vocab_size, (B, T),
                                      dtype=np.int32),
            "token_type_ids": np.repeat(
                (np.arange(T) >= T // 2)[None].astype(np.int32), B, 0),
            "mlm_labels": labels,
            "nsp_labels": rng.integers(0, 2, (B,)).astype(np.int32)}


def bert_padding_mask(B, T):
    """A key padding mask whose last BERT_PAD keys of every row are
    padding: the BERT layer's einsum route."""
    mask = np.ones((B, T), np.int32)
    mask[:, T - BERT_PAD:] = 0
    return mask


def phase_llama_bert(smi):
    """LLaMA and BERT train on the card, and a trained LLaMA serves.
    (a) ``llama-1b`` (JAX's preset: 16 layers, 2048 wide, 16 heads of 128,
    FFN 5504, vocab 32000, untied) at full width and depth, bf16, micro 4
    x gas 2 x T 2048: phase train's path and oracles (B1-B3); then its
    trained weights through ``convert_trained_model`` into
    ``init_inference``: phase e2e's ``generate`` and gates over 2048
    tokens (B1, B4, the decode graph) and the served-token oracle.
    (b) ``llama-7b-gqa`` at full width (32 heads of 128 over 8 KV heads,
    FFN 14336) and 8 of its 32 layers, micro 2 x gas 1 x T 4096: B3's
    group sum at 4 query heads a KV head, the same oracles. (c)
    ``bert-large`` (24 layers, 1024 wide, 16 heads of 64, FFN 4096, T 512,
    NSP; dropout ratios 0) at full width and depth, micro 16 x gas 2,
    unmasked batches: B1, B2 and B3 non-causal; then one step of batches
    with a key padding mask, which takes the einsum route and launches
    none of them. Returns the runs' launch counts by name."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import bert as bert_mod
    from deepspeed_tpu_torch.models import llama as llama_mod
    from deepspeed_tpu_torch.module_inject import convert_trained_model
    runs = {}
    rng = np.random.default_rng(20)

    def llama(name, over, micro, gas, T, n_params):
        cfg = llama_mod.config_for(name, **over)
        model = llama_mod.LlamaLMModel(cfg)
        plain = llama_mod.LlamaLMModel(dataclasses.replace(
            cfg, use_flash_attention=False))
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device="cuda").manual_seed(20))
        n = model.param_count(params)
        check(n == n_params, f"{name}: {n} parameters, expected {n_params}")
        engine = train_engine(model, params, micro, gas)
        del params
        L = cfg.n_layer
        log(f"[llama_bert] {name}: {L} layers, {cfg.n_head} heads of "
            f"{cfg.head_dim} over {cfg.n_kv_head} KV heads, FFN "
            f"{cfg.intermediate_size}, {n} parameters, random weights and "
            f"engine in {time.perf_counter() - t0:.3f} s")
        batch = {"input_ids": rng.integers(0, cfg.vocab_size,
                                           (micro * gas, T), dtype=np.int32)}
        counts = _train_model_run(name, model, engine, batch, micro, gas,
                                  micro * gas * T, plain.loss_fn)
        k = TRAIN_STEPS * gas
        check(counts["flash_attention_fwd"] == 2 * L * k,
              f"{name}: flash forward launched "
              f"{counts['flash_attention_fwd']} times, expected "
              f"{2 * L * k} ({L} layers x 2 with remat x {k} micro-batches)")
        for kk in _BWD_KERNELS:
            check(counts[kk] == L * k,
                  f"{name}: {kk} launched {counts[kk]} times, expected "
                  f"{L * k}")
        # the gradient oracle on one sequence: the attention projections
        # of every layer, where a wrong dq or dk/dv (a wrong group sum)
        # shows
        mb = {"input_ids": torch.as_tensor(batch["input_ids"][:1],
                                           device="cuda")}
        names = [f"layers_{i}.attn.{w}.kernel" for i in range(L)
                 for w in ("wq", "wk", "wv")]
        _grad_oracle(name, model.loss_fn, plain.loss_fn, engine.params, mb,
                     names)
        return model, engine, counts

    (name_1b, *run_1b), (name_gqa, *run_gqa) = LLAMA_RUNS
    # (a) llama-1b trains, then serves
    model, engine, runs[f"train {name_1b}"] = llama(name_1b, *run_1b)
    t0 = time.perf_counter()
    icfg, tree = convert_trained_model(model, engine.params)
    del engine
    torch.cuda.empty_cache()
    serve = deepspeed_tpu_torch.init_inference(
        (icfg, tree), dtype="bfloat16", device="cuda", max_out_tokens=2048)
    del tree
    torch.cuda.synchronize()
    check(icfg.n_kv_head == 16 and icfg.norm_type == "rmsnorm"
          and icfg.gated_mlp and icfg.positional == "rotary"
          and not icfg.tied_lm_head,
          f"llama-1b: converted config {icfg}")
    log(f"[llama_bert] llama-1b: convert_trained_model + init_inference "
        f"in {time.perf_counter() - t0:.3f} s")
    runs["serve llama-1b"] = phase_e2e(icfg, serve.params, tag="llama-1b",
                                       engine=serve, n_ctx=2048)
    prompts = [rng.integers(0, icfg.vocab_size, n).tolist()
               for n in (300, 1500)]
    rows = serve.generate(prompts, max_new_tokens=32)
    _serve_oracle(serve, "llama-1b generate", prompts, rows, 32,
                  tag="llama_bert")
    del serve, rows, model
    torch.cuda.empty_cache()

    # (b) Mistral-7B's attention geometry at 8 of 32 layers
    _, engine, runs[f"train {name_gqa} x8"] = llama(name_gqa, *run_gqa)
    del engine
    torch.cuda.empty_cache()

    # (c) bert-large: unmasked batches through B1-B3 non-causal, then a
    # masked step through the einsum route
    name, over, micro, gas, T, n_params = BERT_RUN
    cfg = bert_mod.config_for(name, **over)
    model = bert_mod.BertPreTrainingModel(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(21))
    n = model.param_count(params)
    check(n == n_params, f"{name}: {n} parameters, expected {n_params}")
    engine = train_engine(model, params, micro, gas)
    del params
    L = cfg.num_hidden_layers
    log(f"[llama_bert] {name}: {L} layers, {cfg.num_attention_heads} "
        f"heads of {cfg.hidden_size // cfg.num_attention_heads}, {n} "
        f"parameters, random weights and engine in "
        f"{time.perf_counter() - t0:.3f} s")
    B = micro * gas
    batch = bert_batch(cfg, rng, B, T)

    # the plain route of the oracles: the same batch with a key mask of
    # ones (the einsum route, no kernel)
    def plain(p, mb):
        return model.loss_fn(p, dict(
            mb, attention_mask=torch.ones_like(mb["input_ids"])))
    counts = runs[f"train {name}"] = _train_model_run(
        name, model, engine, batch, micro, gas, B * T, plain)
    k = TRAIN_STEPS * gas
    for kk in ("flash_attention_fwd", *_BWD_KERNELS):
        check(counts[kk] == L * k,
              f"{name}: {kk} launched {counts[kk]} times, expected "
              f"{L * k} (non-causal, no remat)")
    # the gradient oracle on 2 sequences: every layer's fused qkv weight,
    # whose gradient goes through non-causal dq and dk/dv at this path's
    # [2, 512, 16, 64]
    mb = {key: torch.as_tensor(v[:2], device="cuda")
          for key, v in batch.items()}
    _grad_oracle(name, model.loss_fn, plain, engine.params, mb,
                 [f"layers.{i}.attn_qkvw" for i in range(L)])
    pad = dict(batch, attention_mask=bert_padding_mask(B, T))
    _launch_counts(reset=True)
    t = time.perf_counter()
    m = engine.train_batch(pad)   # THE masked path
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    counts = runs[f"{name} masked step"] = _launch_counts()
    check(math.isfinite(float(m["loss"])),
          f"{name} masked step: loss {m['loss']}")
    check(all(counts[kk] == 0 for kk in ("flash_attention_fwd",
                                         *_BWD_KERNELS)),
          f"{name} masked step launched {counts}")
    log(f"[llama_bert] {name}: one step with a key padding mask (the "
        f"einsum route) in {t * 1e3!r} ms, loss {float(m['loss'])!r}, "
        f"launches {counts}; {smi}")
    del engine
    torch.cuda.empty_cache()
    return runs


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch  # noqa: F401 — fails outside a checkout
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device="cuda")
    walls = {}

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t
    timed("build", phase_build)
    kernels = {"flash_attention_fwd": timed("flash", phase_flash, flush),
               "decode_attention": timed("decode", phase_decode, flush),
               **timed("paged", phase_paged, flush),
               **timed("flash_bwd", phase_flash_bwd, flush),
               "block_sparse_attention": timed("sparse", phase_sparse, flush),
               **timed("layer_norm", phase_layer_norm, flush)}
    cfg = gpt2_xl_config()
    params = timed("e2e", make_params, cfg)
    runs = {"e2e": timed("e2e", phase_e2e, cfg, params)}
    runs.update(timed("serve", phase_serve, cfg, params))
    runs.update(timed("spec", phase_spec, cfg, params, smi))
    runs.update(timed("int8", phase_int8, cfg, params, smi))
    del params, flush   # the serving weights; training needs the room
    torch.cuda.empty_cache()
    # the main-path runs at head dims outside {64, 128}: Pythia-2.8B (80),
    # GPT-J-6B (256), gpt2-760m (96), gpt2-2.7b (80), the sparse run at 32
    # heads of 80
    new_d = timed("pythia", phase_pythia)
    gptj = timed("gptj", phase_gptj)
    new_d.update(gptj)
    runs.update(new_d)
    runs.update(timed("hf", phase_hf, smi))
    runs.update(timed("llama_bert", phase_llama_bert, smi))
    runs["train"] = timed("train", phase_train, observe=True)
    runs.update(timed("int8 train", phase_int8_train))
    for preset in ("gpt2-760m", "gpt2-2.7b"):
        runs[f"train {preset}"] = new_d[f"train {preset}"] = timed(
            "train", phase_train, preset, n_layer=NEW_D_TRAIN_LAYERS)
    # heads of 256 in training and in the sparse run (Gemma-2B's query
    # geometry: 8 heads of 256 at 2048 wide)
    d256 = {"train gpt2-1.3b 8x256": timed("train", phase_train, "gpt2-1.3b",
                                           n_head=8)}
    runs.update(timed("checkpoint", phase_checkpoint))
    runs.update(timed("offload", phase_offload, smi))
    runs.update(timed("dist", phase_dist, smi))
    runs["sparse"] = timed("runs", run_sparse)
    runs["sparse 32 x 80"] = new_d["sparse 32 x 80"] = timed(
        "runs", run_sparse, 32, 80)
    d256["sparse 8 x 256"] = timed("runs", run_sparse, 8, 256)
    new_d.update(d256)
    runs.update(d256)
    runs["layer_norm"] = timed("runs", run_layer_norm)
    # launches: summed over the main-path runs, each read just after it
    launches = {k: sum(r.get(k, 0) for r in runs.values()) for k in kernels}
    for k, n in launches.items():
        check(n > 0, f"{k} was never launched on the main path")
    # every attention kernel, int8 ones included, also ran on a main path
    # at a head dim its instantiation is wider than (LayerNorm has none)
    for k in kernels:
        if not k.startswith("layer_norm"):
            check(sum(r.get(k, 0) for r in new_d.values()) > 0,
                  f"{k} never launched at head dim 80, 96 or 256 on a main "
                  f"path")
    # every serving kernel ran at head dim 256 on GPT-J-6B's path
    for k in _PAGED_KERNELS:
        check(sum(r.get(k, 0) for r in gptj.values()) > 0,
              f"{k} never launched at head dim 256 on the gptj path")
    # and B1-B3 and B8 at 256 on the training and sparse paths
    for k in ("flash_attention_fwd", *_BWD_KERNELS, "block_sparse_attention"):
        check(sum(r.get(k, 0) for r in d256.values()) > 0,
              f"{k} never launched at head dim 256 on the train gpt2-1.3b "
              f"8x256 or sparse 8 x 256 path")
    log(f"[launches] per run {runs}")
    meta = {
        "flash_attention_fwd": (
            "deepspeed_tpu_torch/ops/csrc/flash_attention_fwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:65"),
        "flash_attention_bwd_dq": (
            "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:167"),
        "flash_attention_bwd_dkv": (
            "deepspeed_tpu_torch/ops/csrc/flash_attention_bwd.cu",
            "deepspeed_tpu/ops/pallas/flash_attention.py:215"),
        "decode_attention": (
            "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:78"),
        "paged_decode_attention": (
            "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:164"),
        "paged_chunk_attention": (
            "deepspeed_tpu_torch/ops/csrc/paged_chunk_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:292"),
        "paged_verify_attention": (
            "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:421"),
        # the int8 branch (_deq_tile :46) of the same three TPU kernels
        "paged_decode_attention_int8": (
            "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:164"),
        "paged_chunk_attention_int8": (
            "deepspeed_tpu_torch/ops/csrc/paged_chunk_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:292"),
        "paged_verify_attention_int8": (
            "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
            "deepspeed_tpu/ops/pallas/decode_attention.py:421"),
        "block_sparse_attention": (
            "deepspeed_tpu_torch/ops/csrc/block_sparse_attention.cu",
            "deepspeed_tpu/ops/pallas/block_sparse_attention.py:44"),
        "layer_norm_fwd": (
            "deepspeed_tpu_torch/ops/csrc/layer_norm.cu",
            "deepspeed_tpu/ops/pallas/layer_norm.py:28"),
        "layer_norm_bwd": (
            "deepspeed_tpu_torch/ops/csrc/layer_norm.cu",
            "deepspeed_tpu/ops/pallas/layer_norm.py:41"),
    }
    rows = []
    for name, nums in kernels.items():
        src, rep = meta[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[name],
                     "max_abs_err": nums["max_abs_err"], "ms": nums["ms"],
                     "plain_ms": nums["plain_ms"],
                     "bound_ms": nums["bound_ms"],
                     "bound_by": nums["bound_by"],
                     "library_ms": nums["library_ms"],
                     **{k: v for k, v in nums.items() if k not in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")}})
    log(f"[wall] chip_smoke.py {time.perf_counter() - t_start!r} s; by "
        f"phase (s): {walls!r}")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
