"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any fault raises and exits non-zero; nothing is caught):

  1. device  - a CUDA card is required; prints its name and power limit.
  2. build   - compiles csrc/*.cu for sm_90a (one nvcc call) and prints
               the build seconds and the ptxas register report.
  3. kernels - each hand-written kernel against its plain PyTorch version on
               the card at the main path's shapes, then CUDA-event timings
               of kernel, plain version and library yardstick (device time
               per call, from a CUDA graph of many calls; ``eager_ms`` is
               the kernel's time per eager call, host issue included),
               printed as one JSON line {"kernels": [...]}.
               The Top-K kernels are checked too: fp32 Top-K at the routing
               shape (Q in {1, 512} x 4,096 topics x D+1 = 769, k = 3, rows
               at the routing mirror's 16-byte pitch of 772 floats) and
               over the slab (Q = 8, k in {1, 8, 16, 257}), every launch on
               the ring kernels of sim_topk_f32.cu; int8 Top-K over
               the slab (Q in {1, 512}, k = 8, scores bit-equal), and Top-1
               with a count read on the card (the fused rescore's shapes).
               The Eq. 1 kernels (B2, B3; csrc/eq1_value.cuh) at the main
               path's N = 65,537 and T = 4,096 and B3 at the arena's
               6,852 slots, each beside its launch floor (an empty kernel
               with the same grid and attributes); each wrapper must
               launch one eq1_kernel (profiler names).
               Top-1 scores in three-way TF32 (its bound: three TF32
               products, B1_PRODUCTS); its winning pair scores over the
               main replay's rows must be bit-equal across Q=512, Q=8,
               Q=1 N=1 and 8-row union blocks with a count on the card.
               The policy-stacked kernels too, at the arena's shapes (P = 15
               slabs of S = 6,852 rows: 10% of the trace's 68,510 unique
               contents plus the spare, D = 768): Top-1 and int8 Top-K
               (k = 8) at Q in {16, 512}, and the victim values over
               N = 6,852 slots and T = 4,096 topics; each policy's slice
               must equal a single-slab launch on that slab.
  4. parity  - the first 8,000 requests of the trace at D=768, capacity
               4,096, replayed on the kernel backend on the card and on the
               port's NumpyBackend host oracle: hit, admit and eviction
               sequences must be identical.
  5. approx  - the first 4,500 of those requests replayed one by one through
               lookup/admit with the quantized, the pruned (2 probes), the
               composed (fused) and the composed staged (fused=False)
               lookups, on the card and on the host oracle: every event
               sequence must equal the exact path's on the card.  The nine
               replays are independent and host-bound, so each runs in a
               worker process of its own.
  6. arena   - the 15 default_factories(seed=0) policies replayed in one
               pass (run_arena, semantic mode, chunk 512, D=768) over the
               trace's first ARENA_LEN requests at capacity 10% of their
               unique contents, on the card and on the host oracle (in a
               worker process, at the same time): every policy's hits,
               misses and evictions must be identical, and the stacked
               Top-1 must have launched once per chunk.  The stacked
               victim values of the three RAC variants' final tables are
               then checked in one launch.  The exact, quantized, pruned
               and composed arenas replay a shorter prefix, each in a
               worker process started before the card's arena and running
               beside it, and must make the same Stats; the stacked int8
               Top-K must have launched once per chunk.
  6b. sharded - the sharded backend (ShardedStore, ShardedKernelBackend):
               at the main path's geometry (capacity 65,536, D = 768,
               SHARDS = 4 shards of 16,385 rows) a 512-query chunk's
               top1_batch (identical cids, the same fp32 bits),
               decide_batch and rac_value (N = 65,537) against
               KernelBackend on the same rows in the same slots, on the
               one-card loop and on the multi-card code path
               (make_cache_mesh patched to cuda:0 for every shard: one
               mirror piece a shard, the chunked B3), with the CUDA-event
               ms a chunk of the 4-shard loop and of the single slab; the
               4 B1 and 4 B3 launches timed as § 6's rows; phase 4's
               8,000 requests at 2 and 4 shards against its host-oracle
               record; the quantized and the fused pruned lookups at 4
               shards (run as two more workers of phase 5, held to its
               exact record) and a 2-shard arena on phase 6's shorter
               prefix (a worker of phase 6, held to the host oracle's
               Stats there), with their launches.
  7. main    - the batched replay (RAC, backend="kernel", device="cuda") of
               the OASST-style trace's first 71,000 requests at D=768,
               capacity 65,536 (a 65,537 x 768 fp32 slab on the card),
               chunk 512, on a cache the smoke keeps; B1-B3 must have
               launched, every B2 and B3 launch on the vector path; B2
               and B3 are then checked and timed at the topic table the
               replay grew to (printed: the tables grow by doubling).
  8. approx main - that warmed cache is checkpointed and restored into an
               exact and a quantized+pruned (defaults) cache, which replay
               the next 300 requests one by one (the fused path
               at b = 1) and then peek 512 queries at once (the staged
               path): identical events and hit cids; B4, B5 and B1 with a
               count on the card must have launched, every B4 launch on
               sim_topk_f32.cu's kernels.
  9. attention - B8 (flash_attention) and B9 (decode_attention) against
               their plain versions on the card (bf16 within one bf16 ulp,
               2^-7 of the value plus 1e-6; fp32 within 2e-5; every bf16
               B8 call served by the wgmma + TMA kernel, fp32 by the SIMT
               one, each shape's row naming which), then timed
               beside the library yardstick (scaled_dot_product_attention:
               causal for B8, over a [0, pos] mask for B9, its max |err|
               recorded): B8 at bf16 (B,H,Hkv,S,D) =
               (1,15,5,4096,64), (2,15,5,1000,64) and smollm-360m's
               training batch (8,15,5,1024,64), fp32 (1,8,2,513,128),
               gemma-7b's heads (1,16,16,4096,256) and nemotron-4-340b's
               (1,96,8,4096,192) in bf16, a smoke variant's (2,4,2,4096,32)
               in fp32, and the kernel alone at S = 32,768; B9 at bf16
               (8,15,5,512,64), (8,15,5,2048,64), (8,16,16,2048,256),
               (8,96,8,2048,192) and (128,15,5,32768,64), and fp32
               (8,4,2,2048,32), with seeded pos including 0 and S_max - 1;
               then the MoE/MLA and hybrid families' shapes: B8 at
               deepseek-v2-lite-16b's MLA heads (Q/K 192, V 128), its
               smoke variant's (48/32) and hymba-1.5b's band of 2,048
               keys (25/5 heads of 64, also at S = 32,768) and its smoke
               variant's window of 64 (the yardstick: SDPA over the band
               as a boolean mask; at S = 32,768 a 1 GiB mask, K/V repeated
               to the 25 query heads and the memory-efficient backend,
               both outside the timing); B9 at MLA's absorbed decode (D =
               576, Dv = 512 as a view of the K rows, G = 16; the smoke
               variant's 80/64) and hymba's ring of 2,048 slots; then the
               encoder-decoder's: B8 without the causal mask at
               whisper-medium's encoder (16 heads of 64, S = T = 1,500
               frames) and cross attention (448 text rows over the 1,500
               frames), bf16 and fp32 (the yardstick: SDPA with
               is_causal=False), and B9 as its cross-attention decode (8
               slots, 16 heads, every row over all 1,500 frames).
 10. model   - the paper's served LM (configs/paper.py: 32 layers, d_model
               960, 15/5 heads of 64, bf16) on the card from a seeded
               generator: prefill and forward of B=2 x 1,000 tokens through
               B8 against the same model on plain attention, then the first
               MODEL_DECODE_STEPS (400) of those tokens teacher-forced one at
               a time through decode_step (B9, a 1,024-position cache)
               against forward at every position; B8 32 launches per
               forward (all 32 of the prefill on the wgmma kernel), B9 32
               per step.
 10b. gemma   - gemma-7b at full width and depth (28 layers, d_model 3,072,
               16 heads of 256, GeGLU 24,576, vocab 256,000, bf16, 8.5 B
               parameters drawn on the card from seed 0): prefill of B=1 x
               1,024 tokens (28 B8 launches, all on the wgmma kernel at
               D = 256) against the same model on plain attention, then 64
               teacher-forced decode steps through B9 against forward,
               both within LOGIT_TOL.
 10e. deepseek - deepseek-v2-lite-16b at full width and depth (27
               layers, d_model 2,048, MLA 16 heads of 128 + 64 rope over a
               512-wide latent, MoE 64 experts of 1,408 top 6 + 2 shared,
               vocab 102,400, bf16, 16.2 B parameters drawn on the card
               from seed 0, after gemma's are freed): prefill of B=1 x
               1,024 tokens (27 B8 launches at 192/128, all on wgmma), 64
               decode steps (27 B9 launches a step at 576/512, V a view of
               the latent rows), every layer's B8/B9 output held to its
               plain version; at fp32 compute, prefill against plain
               attention (routing flips printed) and decode against
               forward at the capacity factor E / k (no pair dropped),
               both within LOGIT_TOL; then ServingEngine over 32 requests
               of launch/serve.py's trace against the same engine on the
               plain versions (identical decisions and token counts).
 10f. hymba  - hymba-1.5b at full width and depth (32 layers, d_model
               1,600, 25/5 heads of 64, window 2,048, Mamba heads d_inner
               3,200 state 16, bf16): prefill of 4,096 tokens through the
               windowed B8 (every layer held to plain); at fp32 compute,
               prefill against plain attention and 2,112 teacher-forced
               decode steps through the ring of 2,048 slots, the last 64
               positions' logits within LOGIT_TOL of forward's.  The fp32
               gates (host-bound decode steps, the card ~7% busy) run in a
               child process (chip_smoke.py --hymba-child OUT.json) on the
               same seeded weights, started after phase 9 and joined (its
               lines printed) after phase 6: phases 4-6 time no kernel.
 10g. whisper - whisper-medium at full width and depth (24 encoder and 24
               decoder layers, d_model 1,024, 16 heads of 64, GELU 4,096,
               vocab 51,865, bf16, 0.91 B parameters drawn on the card
               from seed 0): prefill of 1,500 seeded frame embeddings
               through the encoder and 448 text tokens through the
               decoder (72 B8 launches, all on wgmma: 24 non-causal over
               the frames, 24 causal, 24 non-causal cross), every layer's
               output held to its plain version; 64 teacher-forced decode
               steps with the encoder's output (B9 twice a layer: self and
               cross over all 1,500 frames); at fp32 compute prefill
               against plain attention and decode against forward within
               LOGIT_TOL; the engine (the decoder alone, as the reference
               serves whisper) over 32 requests against the plain engine.
 10h. xlstm  - xlstm-125m at full width and depth (12 layers, d_model 768,
               4 heads, mLSTM of d_inner 1,536 with sLSTM at layers 5 and
               7, vocab 50,304, bf16): prefill of 512 tokens (the cells'
               token loops, plain PyTorch as in the reference: no kernel),
               64 teacher-forced decode steps against forward, in bf16 and
               at fp32 compute (within LOGIT_TOL); the engine over 32
               requests against the plain engine (B1-B3, no B8/B9).
 10i. internvl - internvl2-26b at full width and depth (48 layers,
               d_model 6,144, 48/8 heads of 128, SwiGLU 16,384, vocab
               92,553, bf16, 19.9 B parameters, 39.7 GB, drawn after
               deepseek's are freed): prefill of 256 seeded image rows and
               768 text tokens (48 B8 launches on wgmma at G = 6, each
               held to plain); 64 teacher-forced decode steps (B9) against
               the text-only forward; at fp32 compute both within
               LOGIT_TOL; the forward's peak memory in grad mode (its
               parameters need none) no higher than under no_grad.
 10j. train  - smollm-360m (launch/train.py's default arch) trained through
               launch/train.py's code path on the card: at full width
               with 2 layers in fp32 (B8's SIMT kernel), one step's loss
               and gradients against the same step on plain attention
               (loss within 1e-5 relative, each gradient leaf within 1e-4
               relative L2); at full width and depth in bf16, batch 8 x
               1,024 tokens, 20 steps checkpointed every 10 (the forward
               on B8, again in each block's remat recompute, all on
               wgmma: 64 launches a step; the gradient the plain
               attention's, recomputed), then a restart from step 10
               whose losses are bit-equal to the uninterrupted run's
               (torch.use_deterministic_algorithms), the loss falling;
               ms a step, tokens/s, MFU, the backward's share (CUDA
               events), the busy share of one profiled step (its device
               time over its wall, torch.profiler), peak memory,
               checkpoint save and restore seconds, and the plain
               attention backward at the training shape.  The phase runs
               in a child process, the only one with cuBLAS's fixed
               workspace (CUBLAS_WORKSPACE_CONFIG) that deterministic
               mode wants.
 10k. dryrun - launch/dryrun.py in a child process on the host (python3
               chip_smoke.py --dryrun-child OUT.json), started with the
               model phases and joined after 10j: make_local_mesh() on
               the card as a world of one (NCCL), checked; on it the dry
               run of 10j's train step (smollm-360m, batch 8 x 1,024;
               meta DTensors, nothing allocated), whose argument bytes
               must equal the train child's parameter, moment and batch
               bytes exactly, its predicted peak printed beside 10j's
               measured one; then smollm-360m prefill_32k on the fake
               16 x 16 world, xlstm-125m decode_32k on the fake 2 x 16 x 16
               one and deepseek-v2-lite-16b decode_32k (MoE) on 16 x 16,
               at full width and depth, one record a line.
 10c. tiers  - RAC at D=768 over the first 5,000 requests, device capacity
               1,024, a host tier of 2,048 rows and ghost lists of 8,192,
               request by request with a flush after each, queued
               (async_admit="sync") and with the worker thread (True): the
               events (kind, cid, t, tier) equal to the host oracle's
               queued replay exactly and to its inline replay at every
               flush; demotions, promotions, host hits, host evictions and
               ghost revivals all happen; one telemetry report printed.
 10d. kv     - the KV prefix-block cache at deployment size: KVBlockManager
               (65,536 blocks of 16 tokens, RadixRAC, the kernel backend on
               the card) over the first 10,000 requests of the trace, each
               prompt the token runs of its whole conversation (16-256
               tokens a message from default_rng([0, cid])): every request's
               hit tokens, new blocks, topic and evicted blocks equal to the
               plain B3's (device="cpu") and to the float64 oracle's (numpy;
               or parting first at an fp32 near-tie: the two victims'
               float64 values within 2^-22), both replayed in workers at the
               same time; radix validity every 1,000 requests; at least
               10,000 evictions, B3 launched for each (one launch, the mask
               in the kernel), B1 never.
               The host replays of 10c and 10d run in four worker
               processes while phases 10, 10b and 10e-10j use the card,
               beside 10k.
 11. serve   - ServingEngine at that width (kernel cache backend, D=768,
               capacity 64, 8 slots, max_seq 512, 16 new tokens) over the
               first SERVE_LEN requests of the synthetic trace
               launch/serve.py uses, prompts of 32-480 tokens; replayed at
               the same time on the host at smoke width (numpy backend) in
               a worker process: identical hit/miss/admit/evict events,
               cached flags and token counts; B1, B2, B3 and B9 must have
               launched; B2 and B3 are then checked and timed at the serve
               cache's slots and topic table.

The last line of standard output is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

DIM = 768                  # GPTCache's default ONNX embedder width
CAPACITY = 65_536
TRACE_LEN = 72_000
MAIN_LEN = 71_000          # the main replay: past capacity, so it evicts
CONT_LEN = 300             # the approximate continuation after the main run
CHUNK = 512
PEEK = 512                 # one staged peek_batch of this many queries
PARITY_LEN, PARITY_CAP = 8_000, 4_096
APPROX_PARITY_LEN = 4_500  # the approximate-parity phase's prefix
N_TOPICS = 4_096           # routing-table rows for the kernel check
N_POL = 15                 # default_factories(): 11 baselines, Belady, 3 RAC
ARENA_LEN = 8_000          # the arena's trace prefix (host-bound: its cost)
ARENA_APPROX_LEN = 1_200   # the approximate arenas' shorter prefix
SHARDS = 4                 # the sharded phase's shards at full geometry
SHARD_PARITY = (2, 4)      # shard counts of its 8,000-request parity
SHARD_ARENA = 2            # shards of its arena (on ARENA_APPROX_LEN)
SHARD_REPS = 20            # timed chunks a path
ALPHA = 0.001
TAU_HIT = 0.85             # CacheConfig's default hit threshold
DEVICE = "cuda"
# the approximate lookups the parity phase holds against the exact path
APPROX = {
    "quantized": dict(quantized_lookup=True),
    "pruned": dict(pruned_lookup={"probes": 2}),
    "both": dict(quantized_lookup=True, pruned_lookup=True),
    "both_staged": dict(quantized_lookup={"fused": False},
                        pruned_lookup={"fused": False}),
}

# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, TF32 and int8 on the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
# B1 scores in three-way TF32 (csrc/sim_top1.cu): three TF32 products of
# 2 * Q * N * D each, so its bound is max(bytes / PEAK_BYTES,
# 3 * 2 * Q * N * D / PEAK_TF32)
B1_PRODUCTS = 3

SIM_TOL = 1e-5             # fp32 dot products summed in another order
                           # (three-way TF32 against IEEE fp32: within
                           # ~1e-6, tests/test_torch_numerics.py)
VALUE_RTOL = 1e-6          # exp2f and the product order match the plain one
# attention outputs: fp32 sums in another order; in bf16 both round fp32
# values that agree to ~1e-6, so at most one bf16 ulp apart (2^-7 |x|
# bounds one ulp of x) plus that noise near zero
ATT_F32_TOL = 2e-5
# a model's bf16 activations: near zero the fp32 sums of p_j v_j carry
# noise relative to sum_j p_j |v_j|, not to the output.  Over
# internvl2-26b's 48 layers (v std 1.57, outputs down to ~1e-6) the kernel
# and the plain version sit up to 2^-18.36 and 2^-18.48 of that sum from
# float64 attention and 2^-17.84 from each other (_layer_noise, printed
# by phase 10i; an NVIDIA H100 80GB HBM3 at 700 W), past phase 9's fixed
# 1e-6; this allowance replaces it in that phase's B8 check alone (every
# other per-layer check keeps 1e-6, and passes it)
ATT_SUM_NOISE = 2.0 ** -17
PEAK_BF16 = 989e12         # dense bf16 on the tensor cores

# B8 at the model's prefill shapes, (B, H, Hkv, S, D, Dv, window), dtype,
# timing reps: the paper LM's heads (the last at prefill_32k's length,
# where the plain version does not fit; the third smollm-360m's training
# batch of 8 x 1,024), gemma-7b's (16 of 256) and
# nemotron-4-340b's (96/8 of 192) at S = 4,096, a smoke variant's (4/2 of
# 32, fp32), deepseek-v2-lite-16b's MLA prefill (16 heads, Q/K 192, V 128)
# and its smoke variant's (48/32), hymba-1.5b's band of 2,048 keys (25/5
# heads of 64; at S = 32,768 too, where the band skips 15 of 16 key tiles)
# and its smoke variant's window of 64 at head dim 32
FLASH_SHAPES = [((1, 15, 5, 4096, 64, 64, 0), torch.bfloat16, 5),
                ((2, 15, 5, 1000, 64, 64, 0), torch.bfloat16, 20),
                ((8, 15, 5, 1024, 64, 64, 0), torch.bfloat16, 10),
                ((1, 8, 2, 513, 128, 128, 0), torch.float32, 20),
                ((1, 16, 16, 4096, 256, 256, 0), torch.bfloat16, 5),
                ((1, 96, 8, 4096, 192, 192, 0), torch.bfloat16, 3),
                ((2, 4, 2, 4096, 32, 32, 0), torch.float32, 5),
                ((1, 15, 5, 32768, 64, 64, 0), torch.bfloat16, 2),
                ((1, 16, 16, 4096, 192, 128, 0), torch.bfloat16, 5),
                ((1, 16, 16, 1024, 192, 128, 0), torch.float32, 5),
                ((2, 4, 4, 4096, 48, 32, 0), torch.bfloat16, 5),
                ((2, 4, 4, 4096, 48, 32, 0), torch.float32, 5),
                ((1, 25, 5, 4096, 64, 64, 2048), torch.bfloat16, 5),
                ((1, 25, 5, 4096, 64, 64, 2048), torch.float32, 3),
                ((1, 25, 5, 32768, 64, 64, 2048), torch.bfloat16, 2),
                ((2, 4, 2, 4096, 32, 32, 64), torch.bfloat16, 5),
                ((2, 4, 2, 4096, 32, 32, 64), torch.float32, 5)]
PLAIN_MAX_S = 8192         # the plain B8 materialises (B, H, S, S) fp32
# B9, (B, H, Hkv, S_max, D, Dv), dtype and timing reps: the engine's 8
# slots, a longer cache, gemma-7b's and nemotron-4-340b's heads at 2,048
# positions, a smoke variant's (fp32), SHAPES["decode_32k"]'s batch and
# length (one layer), then MLA's absorbed decode (Dv < D: V is a view of
# the first Dv columns of the K rows, scale 1/sqrt(hd + rh)):
# deepseek-v2-lite-16b's 16 heads over 576-wide latent rows and its smoke
# variant's 4 over 80, and hymba-1.5b's ring of 2,048 slots (25/5 of 64)
DECODE_SHAPES = [((8, 15, 5, 512, 64, 64), torch.bfloat16, 50),
                 ((8, 15, 5, 2048, 64, 64), torch.bfloat16, 50),
                 ((8, 16, 16, 2048, 256, 256), torch.bfloat16, 50),
                 ((8, 96, 8, 2048, 192, 192), torch.bfloat16, 50),
                 ((8, 4, 2, 2048, 32, 32), torch.float32, 50),
                 ((128, 15, 5, 32768, 64, 64), torch.bfloat16, 5),
                 ((8, 16, 1, 2048, 576, 512), torch.bfloat16, 50),
                 ((8, 16, 1, 2048, 576, 512), torch.float32, 50),
                 ((8, 4, 1, 2048, 80, 64), torch.bfloat16, 50),
                 ((8, 4, 1, 2048, 80, 64), torch.float32, 50),
                 ((8, 25, 5, 2048, 64, 64), torch.bfloat16, 50)]
# B8 without the causal mask, (B, H, Hkv, S, T, D), dtype, timing reps:
# whisper-medium's encoder (1,500 frames over themselves) and its cross
# attention (448 text rows over the 1,500 frames), 16 heads of 64
FLASH_NONCAUSAL_SHAPES = [((1, 16, 16, 1500, 1500, 64), torch.bfloat16, 20),
                          ((1, 16, 16, 1500, 1500, 64), torch.float32, 5),
                          ((1, 16, 16, 448, 1500, 64), torch.bfloat16, 20),
                          ((1, 16, 16, 448, 1500, 64), torch.float32, 5)]
# B9 as whisper's cross-attention decode, (B, H, Hkv, T, D, Dv): 8 slots,
# one query row each over all 1,500 encoder positions (pos = T - 1)
CROSS_DECODE_SHAPES = [((8, 16, 16, 1500, 64, 64), torch.bfloat16, 50),
                       ((8, 16, 16, 1500, 64, 64), torch.float32, 50)]
# MLA's score scale 1/sqrt(hd + rope_head_dim) at its latent widths
MLA_SCALE = {576: (128 + 64) ** -0.5, 80: (32 + 16) ** -0.5}
# the kv phase: the KV prefix-block pool one H100 holds beside the paper
# LM (65,536 blocks of 16 tokens = 1,048,576 tokens x 40,960 bytes of
# bf16 KV a token = 42.9 GB), over the OASST-style trace's first KV_LEN
# requests (each prompt the whole conversation so far): the pool fills
# after ~8,100 requests, and 10,000 make 15,325 evictions
KV_BLOCKS, KV_BLOCK_TOKENS = 65_536, 16
KV_LEN = 10_000
KV_MIN_EVICTIONS = 10_000
KV_VOCAB = 49_152          # the paper LM's vocabulary
KV_CHECK_EVERY = 1_000     # radix validity checked every this many requests
KV_SAMPLE = 500            # every this many B3 launches, one is timed
KV_WINDOW = 2.0 ** -16     # re-scored in float64: values this near the min
KV_NEAR_TIE = 2.0 ** -22   # an fp32 near-tie: float64 values this close
# the tiers phase: RAC at D=768 over the trace's first TIERS_LEN requests,
# device capacity TIERS_CAP, a host tier of TIERS_HOST rows and ghost
# lists of TIERS_GHOST entries (cut in depth so every tier flow occurs)
TIERS_LEN = 5_000
TIERS_CAP, TIERS_HOST, TIERS_GHOST = 1_024, 2_048, 8_192
MODEL_ARCH = "paper"       # configs/paper.py: the paper's served LM
SMOKE_MODEL = False        # True: its smoke_variant (CPU rehearsals only)
PREFILL_B, PREFILL_S = 2, 1_000
MODEL_DECODE_STEPS = 400   # the prefill's first positions decoded (host-bound
                           # steps of 35-50 ms; the check's depth)
DECODE_MAX_SEQ = 1_024
SERVE_LEN = 104            # requests the serve phase answers (2,405 decode
                           # steps at ~40-56 ms each, host-bound; 26 hits,
                           # 14 evictions at capacity 64)
SERVE_DIM = 768
# the gemma-7b phase: the model at full width and depth (28 layers, head
# dim 256), prefill of B=1 x 1,024 tokens and 64 teacher-forced decode
# steps
GEMMA_ARCH = "gemma-7b"
GEMMA_S, GEMMA_STEPS = 1_024, 64
# the MoE/MLA and hybrid families at full width and depth: deepseek's
# prefill of B=1 x 1,024 tokens, 64 decode steps and the serving engine
# over 32 requests; hymba's prefill of 4,096 tokens (its band of 2,048
# active) and teacher-forced decode past position 2,048 + 64 on the ring
DEEPSEEK_ARCH = "deepseek-v2-lite-16b"
DEEPSEEK_S, DEEPSEEK_STEPS = 1_024, 64
DEEPSEEK_SERVE_LEN = 32         # 6 hits and 18 evictions at capacity 8
HYMBA_ARCH = "hymba-1.5b"
HYMBA_S = 4_096
HYMBA_DECODE = 2_048 + 64      # teacher-forced steps (positions 0..2,111)
HYMBA_BF16_STEPS = 64
# the last families at full width and depth: whisper's 448-token text
# context (arXiv:2212.04356) over its 1,500 frames (cfg.n_frontend_tokens),
# xlstm's prefill of 512 tokens, internvl2's 256 image rows
# (cfg.n_frontend_tokens) before 768 text tokens; 64 decode steps each,
# the engine over 32 requests for whisper and xlstm
WHISPER_ARCH, WHISPER_S, WHISPER_STEPS = "whisper-medium", 448, 64
XLSTM_ARCH, XLSTM_S, XLSTM_STEPS = "xlstm-125m", 512, 64
XLSTM_PROFILE_S = 64           # the profiled prefill's tokens (a loop)
INTERNVL_ARCH, INTERNVL_TEXT, INTERNVL_STEPS = "internvl2-26b", 768, 64
FAMILY_SERVE_LEN = 32
# training (phase 10j): smollm-360m, launch/train.py's default arch, at full
# width and depth in bf16, batch 8 x 1,024 tokens: TRAIN_STEPS steps
# checkpointed every TRAIN_CKPT_EVERY, then a restart from that step; the
# gradient check at full width with TRAIN_CHECK_LAYERS layers in fp32 (B8's
# SIMT kernel against the plain version: fp32 sums in another order, ~1e-6
# relative in the attention outputs)
TRAIN_ARCH, TRAIN_B, TRAIN_S = "smollm-360m", 8, 1024
TRAIN_STEPS, TRAIN_CKPT_EVERY = 20, 10
TRAIN_CHECK_LAYERS = 2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4         # relative L2 of each gradient leaf
TRAIN_CHILD = "--train-child"  # the argument that runs phase 10j alone
HYMBA_CHILD = "--hymba-child"  # the argument that runs 10f's fp32 gates
DRYRUN_CHILD = "--dryrun-child"  # the argument that runs phase 10k alone
# the dry run (phase 10k, on the host beside the model phases): the cells
# tests/test_dryrun.py compiles on the reference and one MoE cell, at full
# width and depth on fake 256/512-rank worlds: (arch, shape, multi-pod)
DRYRUN_CELLS = [("smollm-360m", "prefill_32k", False),
                ("xlstm-125m", "decode_32k", True),
                ("deepseek-v2-lite-16b", "decode_32k", False)]
# full-width bf16 logits (max |logit| ~3.3): the kernels' and the plain
# versions' roundings, and decode's and forward's GEMM shapes, differ in
# the last bf16 bit of some activations, and that spreads over 32 layers;
# measured 0.055 for both comparisons (NVIDIA H100 80GB HBM3, 700 W)
LOGIT_TOL = 0.1


def log(*a):
    print(*a, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    _no_tf32()
    return torch.cuda.get_device_name(0)


def _no_tf32():
    """The plain versions and the library yardstick run IEEE fp32
    products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"(nvcc {_build.build_seconds:.2f}s)")
    for line in _build.build_log.splitlines():
        if "entry function" in line or "registers" in line:
            log("  " + line.strip())


def _elapsed_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` eager calls back
    to back, after two warm-up calls: where the device outruns the host,
    this is the host's issue cost per call.  Each output is dropped before
    the next call, as a caller's would be (holding all of them made every
    call wait on the allocator for fresh memory)."""
    fn()
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _elapsed_ms(run) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn``: ``reps`` calls are
    captured in one CUDA graph and replayed, so the host's issue cost
    (argument checks, allocation, the ctypes call) is not in the time."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(g.replay) / reps


def timings(kernel, plain, library, reps: int,
            plain_reps: int | None = None, calls=None) -> dict:
    """Device time per call of the kernel, its plain version (None where it
    does not fit) and the library yardstick (CUDA graphs), and the
    kernel's eager time; with ``calls``, a second yardstick that computes
    the whole function in several PyTorch calls."""
    for fn in (plain, library, calls):
        if fn is not None:
            fn()                                # warm-up off the capture
    out = {"eager_ms": event_ms(kernel, reps), "ms": graph_ms(kernel, reps),
           "plain_ms": None if plain is None
           else graph_ms(plain, plain_reps or reps),
           "library_ms": None if library is None
           else graph_ms(library, reps)}
    if calls is not None:
        out["library_calls_ms"] = graph_ms(calls, reps)
    return out


def bound(nbytes: float, flops: float,
          peak: float = PEAK_FP32) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES, flops / peak
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def check_sim_top1(q, c, n_valid, reps):
    from repro_torch.kernels import ref, similarity_topk
    v, i = similarity_topk.sim_top1(q, c, n_valid)
    pv, pi = ref.sim_top1_ref(q, c, n_valid)
    torch.cuda.synchronize()
    err = float((v - pv).abs().max())
    if not err <= SIM_TOL:
        raise AssertionError(f"sim_top1 {tuple(q.shape)}x{tuple(c.shape)}: "
                             f"max |err| {err} > {SIM_TOL}")
    # indices must agree wherever the top-2 gap is wider than the tolerance
    scores = q @ c[:n_valid].T
    top2 = scores.topk(2, dim=1).values if n_valid > 1 else None
    clear = (top2[:, 0] - top2[:, 1] > 1e-4) if top2 is not None \
        else torch.ones_like(v, dtype=torch.bool)
    bad = int(((i != pi) & clear).sum())
    if bad:
        raise AssertionError(f"sim_top1: {bad} argmax disagreements")
    nq, d = q.shape
    nb, op = bound((nq * d + n_valid * d) * 4 + nq * 8,
                   B1_PRODUCTS * 2.0 * nq * n_valid * d, PEAK_TF32)
    return {
        "shape": f"Q={nq} N={c.shape[0]} D={d} n_valid={n_valid}",
        "max_abs_err": err, "bound_ms": nb, "bound_by": op,
        **timings(lambda: similarity_topk.sim_top1(q, c, n_valid),
                  lambda: ref.sim_top1_ref(q, c, n_valid),
                  lambda: torch.mm(q, c.T), reps),
    }


def check_pair_bits(chunk, slab) -> int:
    """I1 on the rows the main replay holds: a (query, row) pair scores the
    same fp32 bits whatever launches it.  The chunk's winners over the
    whole slab (Q = 512) must reappear bit for bit at Q = 8 (other
    splits), alone (Q = 1, N = 1), and in a union block of each query's 8
    best rows in reverse order with its count on the card (the fused
    rescore's launch).  Returns the number of pairs compared."""
    from repro_torch.kernels import similarity_topk as st
    n = slab.shape[0]
    v, i = st.sim_top1(chunk, slab, n)
    v8, i8 = st.sim_top1(chunk[:8].contiguous(), slab, n)
    if not (torch.equal(v8, v[:8]) and torch.equal(i8, i[:8])):
        raise AssertionError("sim_top1: Q=8 scores differ from Q=512's")
    eight = torch.tensor([8], dtype=torch.int32, device=slab.device)
    best8 = torch.mm(chunk[:32], slab.T).topk(8, dim=1).indices
    pairs = 8
    for r in range(32):
        q = chunk[r:r + 1].contiguous()
        w = int(i[r])
        one, _ = st.sim_top1(q, slab[w:w + 1].contiguous(), 1)
        rows = torch.cat([best8[r].flip(0), i[r:r + 1].long()])
        bv, _ = st.sim_top1(q, slab[rows[-8:]].contiguous(), eight)
        if not (torch.equal(one, v[r:r + 1]) and torch.equal(bv, v[r:r + 1])):
            raise AssertionError(f"sim_top1: query {r}'s winning score "
                                 "differs between launches")
        pairs += 2
    log(f"sim_top1: {pairs} winning pair scores bit-equal across Q=512, "
        "Q=8, Q=1 N=1 and 8-row union blocks (count on the card)")
    return pairs


def _clear_ranks(pv: torch.Tensor) -> torch.Tensor:
    """Ranks whose score is 1e-4 clear of both neighbours: there the index
    is pinned down whatever order the sums were taken in."""
    pad = torch.full_like(pv[:, :1], float("-inf"))
    nxt = torch.cat([pv[:, 1:], pad], dim=1)
    prv = torch.cat([-pad, pv[:, :-1]], dim=1)
    return torch.isfinite(pv) & (pv - nxt > 1e-4) & (prv - pv > 1e-4)


def check_topk(label: str, run, plain, library, nbytes: float, ops_: float,
               peak: float, exact: bool, reps: int, calls=None) -> dict:
    """A Top-K kernel against its plain version: the same -inf tail, then
    values bit-equal with equal indices (int8, ``exact``) or within
    SIM_TOL with equal indices at clear ranks (fp32).  For int8 the shape
    also names the kernel that ran (``q8_route``)."""
    from repro_torch.kernels import similarity_topk as st
    w0 = st.topk_q8_wgmma_launches + st.topk_q8_multi_wgmma_launches
    v, i = run()
    pv, pi = plain()
    torch.cuda.synchronize()
    if not torch.equal(torch.isneginf(v), torch.isneginf(pv)):
        raise AssertionError(f"{label}: -inf tails differ")
    fin = torch.isfinite(pv)
    err = float((v - pv)[fin].abs().max()) if bool(fin.any()) else 0.0
    if exact:
        if err != 0.0 or not torch.equal(i[fin], pi[fin]):
            raise AssertionError(f"{label}: not bit-equal (max |err| {err})")
    else:
        if not err <= SIM_TOL:
            raise AssertionError(f"{label}: max |err| {err} > {SIM_TOL}")
        clear = _clear_ranks(pv)
        if not torch.equal(i[clear], pi[clear]):
            raise AssertionError(f"{label}: index disagreements")
    nb, op = bound(nbytes, ops_, peak)
    out = {"shape": label, "max_abs_err": err, "bound_ms": nb,
           "bound_by": op}
    if exact:
        wgmma = st.topk_q8_wgmma_launches + st.topk_q8_multi_wgmma_launches
        out["q8_route"] = "wgmma" if wgmma > w0 else "dp4a"
    return {**out, **timings(run, plain, library, reps, calls=calls)}


def phase_topk(chunk, slab, reps_aug, q_aug):
    """B4 at the routing and slab shapes (every launch on the ring kernels
    of sim_topk_f32.cu), B5 over the slab, and B1 with a count read on the
    card at the fused rescore's shapes."""
    from repro_torch.kernels import ref, similarity_topk
    from repro_torch.kernels.quant import quantize_rows_int8
    dev = slab.device
    n, d = slab.shape
    t = reps_aug.shape[0]
    b4 = []
    f32_0 = similarity_topk.topk_f32_launches
    all_0 = similarity_topk.topk_launches
    for nq in (1, 512):
        q = q_aug[:nq]
        b4.append(check_topk(
            f"route Q={nq} T={t} D+1={d + 1} k=3",
            lambda q=q: similarity_topk.sim_topk(q, reps_aug, t, 3),
            lambda q=q: ref.sim_topk_ref(q, reps_aug, t, 3),
            lambda q=q: torch.topk(torch.mm(q, reps_aug.T), 3, dim=1),
            (nq * (d + 1) + t * (d + 1)) * 4 + nq * 3 * 8,
            2.0 * nq * t * (d + 1), PEAK_FP32, False, 50))
    q8rows = chunk[:8].contiguous()
    for k in (1, 8, 16, 257):
        b4.append(check_topk(
            f"slab Q=8 N={n} D={d} k={k}",
            lambda k=k: similarity_topk.sim_topk(q8rows, slab, n, k),
            lambda k=k: ref.sim_topk_ref(q8rows, slab, n, k),
            lambda k=k: torch.topk(torch.mm(q8rows, slab.T), k, dim=1),
            (8 * d + n * d) * 4 + 8 * k * 8, 2.0 * 8 * n * d, PEAK_FP32,
            False, 20))
    f32 = similarity_topk.topk_f32_launches - f32_0
    if f32 != similarity_topk.topk_launches - all_0 or f32 == 0:
        raise AssertionError(f"sim_topk: {f32} of "
                             f"{similarity_topk.topk_launches - all_0} "
                             "launches on the sim_topk_f32.cu kernels")

    c8n, csn, _ = quantize_rows_int8(slab.cpu().numpy())
    c8, cs = torch.from_numpy(c8n).to(dev), torch.from_numpy(csn).to(dev)
    # cuBLASLt's int8 product wants at least 17 rows and widths in 8s:
    # the yardstick takes the queries padded to 32 rows (at Q = 1) and the
    # slab's first 65,536 rows
    c8t = c8[: n - n % 8].T
    cst = cs[: n - n % 8]
    b5 = []
    for nq in (1, 512):
        q8n, qsn, _ = quantize_rows_int8(chunk[:nq].cpu().numpy())
        q8, qs = torch.from_numpy(q8n).to(dev), torch.from_numpy(qsn).to(dev)
        q8p = torch.cat([q8, q8.new_zeros((max(0, 32 - nq), d))])
        qsp = torch.cat([qs, qs.new_zeros(max(0, 32 - nq))])

        def library(q8p=q8p):
            return torch._int_mm(q8p, c8t)

        def calls(q8p=q8p, qsp=qsp):
            return torch.topk((torch._int_mm(q8p, c8t).float()
                               * qsp[:, None]) * cst[None, :], 8, dim=1)
        b5.append(check_topk(
            f"slab Q={nq} N={n} D={d} k=8",
            lambda q8=q8, qs=qs: similarity_topk.sim_topk_q8(
                q8, qs, c8, cs, n, 8),
            lambda q8=q8, qs=qs: ref.sim_topk_q8_ref(q8, qs, c8, cs, n, 8),
            library, nq * (d + 4) + n * (d + 4) + nq * 8 * 8,
            2.0 * nq * n * d, PEAK_INT8, True, 20, calls=calls))

    b1d = []
    for nq, nu in ((1, 8), (16, 128)):
        q = chunk[:nq].contiguous()
        blk = slab[:nu].contiguous()
        nv = torch.tensor([nu], dtype=torch.int32, device=dev)
        v, i = similarity_topk.sim_top1(q, blk, nv)
        hv, hi = similarity_topk.sim_top1(q, blk, nu)
        pv, pi = ref.sim_top1_ref(q, blk, nv)
        torch.cuda.synchronize()
        if not (torch.equal(v, hv) and torch.equal(i, hi)):
            raise AssertionError("sim_top1: a count on the card differs "
                                 "from the same count from the host")
        err = float((v - pv).abs().max())
        if not err <= SIM_TOL:
            raise AssertionError(f"sim_top1 (device n_valid): {err}")
        nb, op = bound((nq * d + nu * d) * 4 + nq * 8,
                       B1_PRODUCTS * 2.0 * nq * nu * d, PEAK_TF32)
        b1d.append({
            "shape": f"union Q={nq} N={nu} D={d}", "max_abs_err": err,
            "bound_ms": nb, "bound_by": op,
            **timings(lambda q=q, blk=blk, nv=nv: similarity_topk.sim_top1(
                q, blk, nv),
                lambda q=q, blk=blk, nv=nv: ref.sim_top1_ref(q, blk, nv),
                lambda q=q, blk=blk: torch.mm(q, blk.T), 200)})
    return b4, b5, b1d


def eq1_counts() -> dict:
    """The Eq. 1 kernels' launch counters (B2, B7, B3), each beside the
    launches of it whose bases took the vector path."""
    from repro_torch.kernels import decision, rac_value
    return {"victim_value": decision.launches,
            "victim_value (vector)": decision.vec_launches,
            "victim_value_multi": decision.multi_launches,
            "victim_value_multi (vector)": decision.multi_vec_launches,
            "rac_value": rac_value.launches,
            "rac_value (vector)": rac_value.vec_launches}


def eq1_reset() -> None:
    from repro_torch.kernels import decision, rac_value
    decision.launches = decision.vec_launches = 0
    decision.multi_launches = decision.multi_vec_launches = 0
    rac_value.launches = rac_value.vec_launches = 0


def eq1_floor_ms(kind: int, tables, reps: int) -> float:
    """Device ms of the Eq. 1 launch's floor: an empty kernel with this
    call's grid, shared memory and attributes (csrc/eq1_value.cuh)."""
    from repro_torch.kernels import decision
    tsi, tid, mask, tp, tl, t_now = tables
    n_pol = tsi.shape[0] if tsi.dim() == 2 else 1
    args, _ = decision.eq1_args(
        kind, tsi, tid, mask, tp, tl, torch.empty_like(tsi), tsi.shape[-1],
        tp.shape[-1], n_pol, t_now, float(t_now), -ALPHA)
    return graph_ms(lambda: decision.floor_launch(args), reps)


def value_rel(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max relative, max absolute) error of ``a`` against ``b`` over the
    finite entries; the +inf masks must be identical."""
    if not torch.equal(torch.isinf(a), torch.isinf(b)) \
            or not torch.equal(torch.isfinite(a), torch.isfinite(b)):
        raise AssertionError("+inf masks differ")
    fin = torch.isfinite(b)
    if not fin.any():
        return 0.0, 0.0
    return (float(((a - b).abs() / b.abs().clamp(min=1e-30))[fin].max()),
            float((a - b)[fin].abs().max()))


def check_values(rng, n: int, t: int, reps: int, kernels=("victim_value",
                                                          "rac_value")):
    """B2 and B3 over N entries and T topics against their plain versions
    (within VALUE_RTOL, identical +inf masks), timed beside their launch
    floor; one row each."""
    from repro_torch.kernels import decision, rac_value, ref
    dev = torch.device(DEVICE)
    tsi = torch.from_numpy(rng.random(n).astype(np.float32) * 8).to(dev)
    tid = torch.from_numpy(rng.integers(-1, t, n).astype(np.int32)).to(dev)
    occ = torch.from_numpy((rng.random(n) < 0.97).astype(np.int32)).to(dev)
    tp = torch.from_numpy(rng.random(t).astype(np.float32) * 20).to(dev)
    tl = torch.from_numpy(rng.integers(0, 60_000, t).astype(np.int32)).to(dev)
    t_now = 72_000
    out = {}
    if "victim_value" in kernels:
        vv = decision.victim_value(tsi, tid, occ, tp, tl, t_now, ALPHA)
        pv = ref.victim_value_ref(tsi, tid, occ, tp, tl, t_now, ALPHA)
        r, a = value_rel(vv, pv)
        if not r <= VALUE_RTOL:
            raise AssertionError(f"victim_value N={n} T={t}: rel err {r} > "
                                 f"{VALUE_RTOL}")
        nb, op = bound(n * 16 + t * 8, 6.0 * n)
        out["victim_value"] = {
            "shape": f"N={n} T={t}", "max_abs_err": a, "max_rel_err": r,
            "bound_ms": nb, "bound_by": op,
            "floor_ms": eq1_floor_ms(decision.KIND_VICTIM,
                                     (tsi, tid, occ, tp, tl, t_now), reps),
            **timings(lambda: decision.victim_value(
                tsi, tid, occ, tp, tl, t_now, ALPHA),
                lambda: ref.victim_value_ref(tsi, tid, occ, tp, tl, t_now,
                                             ALPHA),
                None, reps)}
    if "rac_value" in kernels:
        # the backend shifts time so t_now = 0 and passes t_last as int32
        # (cast to f32 in the kernel, as the TPU kernel's caller casts it)
        tid0 = tid.clamp(min=0)
        tls = tl - t_now
        rv = rac_value.rac_value(tsi, tid0, tp, tls, ALPHA, 0)
        pr = ref.rac_value_ref(tsi, tid0, tp, tls.float(), ALPHA, 0)
        r, a = value_rel(rv, pr)
        if not r <= VALUE_RTOL:
            raise AssertionError(f"rac_value N={n} T={t}: rel err {r} > "
                                 f"{VALUE_RTOL}")
        nb, op = bound(n * 12 + t * 8, 5.0 * n)
        out["rac_value"] = {
            "shape": f"N={n} T={t}", "max_abs_err": a, "max_rel_err": r,
            "bound_ms": nb, "bound_by": op,
            "floor_ms": eq1_floor_ms(decision.KIND_RAC_I32,
                                     (tsi, tid0, None, tp, tls, 0), reps),
            **timings(lambda: rac_value.rac_value(tsi, tid0, tp, tls, ALPHA,
                                                  0),
                      lambda: ref.rac_value_ref(tsi, tid0, tp, tls.float(),
                                                ALPHA, 0),
                      None, reps)}
    return out


def check_eq1_kernel_names() -> None:
    """Every Eq. 1 wrapper launches the eq1_kernel of csrc/eq1_value.cuh
    (B2, B3 with and without a mask, B7): one CUDA kernel a call, by its
    name in the profiler."""
    from repro_torch.kernels import decision, ops, rac_value
    dev = torch.device(DEVICE)
    # every input made before the profiled calls: each call is one launch
    z = torch.zeros(64, dtype=torch.int32, device=dev)
    occ, one, valid = z + 1, torch.ones(64, device=dev), z > 0
    z2, occ2, one2 = z.view(2, 32), occ.view(2, 32), one.view(2, 32)
    calls = {
        "victim_value": lambda: decision.victim_value(one, z, occ, one, z, 5,
                                                      ALPHA),
        "victim_value_multi": lambda: decision.victim_value_multi(
            one2, z2, occ2, one2, z2, 5, ALPHA),
        "rac_value": lambda: rac_value.rac_value(one, z, one, z, ALPHA, 0),
        "rac_value_masked": lambda: ops.rac_value_masked(
            one, z, one, z, valid, ALPHA, 0)}
    from torch.profiler import ProfilerActivity, profile
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        # a trace with no device event at all is the profiler missing the
        # call (seen once in a run on the card), not a launch: trace again
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            if events:
                break
        names = [e.name for e in events
                 if "memcpy" not in e.name.lower()
                 and "memset" not in e.name.lower()]
        if len(names) != 1 or "eq1_kernel" not in names[0]:
            raise AssertionError(f"{name}: launched {names}, not one "
                                 "eq1_kernel")
    log("eq1: B2, B3 (and masked) and B7 each one eq1_kernel launch")


def phase_multi(trace):
    """The policy-stacked kernels at the arena's shapes, each against its
    plain version and against P single-slab launches on the card."""
    from repro_torch.kernels import decision, ref
    from repro_torch.kernels import similarity_topk as st
    from repro_torch.kernels.quant import quantize_rows_int8
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(1)
    embs = np.stack([r.emb for r in trace.requests]).astype(np.float32)
    s = len({r.cid for r in trace.requests}) // 10 + 1   # capacity + spare
    d = embs.shape[1]
    # each policy holds its own sample of the trace's embeddings
    rows = np.stack([rng.choice(embs.shape[0], s, replace=False)
                     for _ in range(N_POL)])
    slabs = torch.from_numpy(embs[rows]).to(dev)           # (P, S, D)
    flat = slabs.view(N_POL * s, d)
    counts = torch.full((N_POL,), s, dtype=torch.int32, device=dev)
    n_live = N_POL * s
    chunk = torch.from_numpy(embs[-CHUNK:]).to(dev)
    b1, b5 = [], []
    for nq, reps in ((512, 10), (16, 20)):
        q = chunk[:nq].contiguous()
        nq = q.shape[0]
        v, i = st.sim_top1_multi(q, slabs, counts)
        pv, pi = ref.sim_top1_multi_ref(q, slabs, counts)
        torch.cuda.synchronize()
        err = float((v - pv).abs().max())
        if not err <= SIM_TOL:
            raise AssertionError(f"sim_top1_multi Q={nq}: max |err| {err}")
        top2 = torch.matmul(slabs, q.T).topk(2, dim=1).values   # (P, 2, Q)
        clear = top2[:, 0] - top2[:, 1] > 1e-4
        if not torch.equal(i[clear], pi[clear]):
            raise AssertionError(f"sim_top1_multi Q={nq}: argmax differs")
        for p in range(N_POL):
            sv, si = st.sim_top1(q, slabs[p], s)
            if not (torch.equal(v[p], sv) and torch.equal(i[p], si)):
                raise AssertionError(f"sim_top1_multi Q={nq}: policy {p} "
                                     "differs from its single-slab launch")
        nb, op = bound((nq * d + n_live * d) * 4 + N_POL * nq * 8,
                       B1_PRODUCTS * 2.0 * nq * n_live * d, PEAK_TF32)
        b1.append({
            "shape": f"Q={nq} P={N_POL} S={s} D={d}", "max_abs_err": err,
            "bound_ms": nb, "bound_by": op,
            **timings(lambda q=q: st.sim_top1_multi(q, slabs, counts),
                      lambda q=q: ref.sim_top1_multi_ref(q, slabs, counts),
                      lambda q=q: torch.mm(q, flat.T), reps)})
    log(f"sim_top1_multi: bit-equal to {N_POL} single-slab launches")

    c8n, csn, _ = quantize_rows_int8(flat.cpu().numpy())
    c8 = torch.from_numpy(c8n).to(dev).view(N_POL, s, d)
    cs = torch.from_numpy(csn).to(dev).view(N_POL, s)
    # cuBLASLt's int8 product wants at least 17 rows and widths in 8s
    c8t = c8.view(n_live, d)[: n_live - n_live % 8].T
    # the whole function in PyTorch calls takes each slab padded to S' rows
    # (a multiple of 8), the padding masked to -inf before the Top-K
    sp = -(-s // 8) * 8
    c8pt = torch.cat([c8, c8.new_zeros((N_POL, sp - s, d))], 1).view(
        N_POL * sp, d).T
    cspad = torch.cat([cs, cs.new_zeros((N_POL, sp - s))], 1).view(-1)
    pad = (torch.arange(sp, device=dev) >= s).repeat(N_POL)
    for nq, reps in ((512, 10), (16, 20)):
        q8n, qsn, _ = quantize_rows_int8(chunk[:nq].cpu().numpy())
        nq = q8n.shape[0]
        q8, qs = torch.from_numpy(q8n).to(dev), torch.from_numpy(qsn).to(dev)
        q8p = torch.cat([q8, q8.new_zeros((max(0, 32 - nq), d))])
        qsp = torch.cat([qs, qs.new_zeros(max(0, 32 - nq))])

        def calls(q8p=q8p, qsp=qsp):
            sc = (torch._int_mm(q8p, c8pt).float() * qsp[:, None]) \
                * cspad[None, :]
            return torch.topk(sc.masked_fill_(pad, float("-inf")).view(
                -1, N_POL, sp), 8, dim=2)

        def run(q8=q8, qs=qs):
            return st.sim_topk_q8_multi(q8, qs, c8, cs, counts, 8)
        v, i = run()
        for p in range(N_POL):
            sv, si = st.sim_topk_q8(q8, qs, c8[p], cs[p], s, 8)
            if not (torch.equal(v[p], sv) and torch.equal(i[p], si)):
                raise AssertionError(f"sim_topk_q8_multi Q={nq}: policy {p} "
                                     "differs from its single-slab launch")
        b5.append(check_topk(
            f"Q={nq} P={N_POL} S={s} D={d} k=8",
            lambda run=run, nq=nq: tuple(x.view(N_POL * nq, 8)
                                         for x in run()),
            lambda q8=q8, qs=qs, nq=nq: tuple(
                x.view(N_POL * nq, 8) for x in ref.sim_topk_q8_multi_ref(
                    q8, qs, c8, cs, counts, 8)),
            lambda q8p=q8p: torch._int_mm(q8p, c8t),
            nq * (d + 4) + n_live * (d + 4) + N_POL * nq * 8 * 8,
            2.0 * nq * n_live * d, PEAK_INT8, True, reps, calls=calls))
    log(f"sim_topk_q8_multi: bit-equal to {N_POL} single-slab launches")

    t = N_TOPICS
    tsi = torch.from_numpy(rng.random((N_POL, s)).astype(np.float32)
                           * 8).to(dev)
    tid = torch.from_numpy(rng.integers(-1, t, (N_POL, s)).astype(
        np.int32)).to(dev)
    occ = torch.from_numpy((rng.random((N_POL, s)) < 0.97).astype(
        np.int32)).to(dev)
    tp = torch.from_numpy(rng.random((N_POL, t)).astype(np.float32)
                          * 20).to(dev)
    tl = torch.from_numpy(rng.integers(0, 60_000, (N_POL, t)).astype(
        np.int32)).to(dev)
    t_now = 72_000
    vv = decision.victim_value_multi(tsi, tid, occ, tp, tl, t_now, ALPHA)
    pv = ref.victim_value_multi_ref(tsi, tid, occ, tp, tl, t_now, ALPHA)
    if not torch.equal(torch.isinf(vv), torch.isinf(pv)):
        raise AssertionError("victim_value_multi: +inf masks differ")
    fin = torch.isfinite(pv)
    rel = float(((vv - pv).abs() / pv.abs().clamp(min=1e-30))[fin].max())
    if not rel <= VALUE_RTOL:
        raise AssertionError(f"victim_value_multi: rel err {rel}")
    for p in range(N_POL):
        one = decision.victim_value(tsi[p], tid[p], occ[p], tp[p], tl[p],
                                    t_now, ALPHA)
        if not torch.equal(vv[p], one):
            raise AssertionError(f"victim_value_multi: policy {p} differs "
                                 "from its single-table launch")
    nb, op = bound(N_POL * (s * 16 + t * 8), 6.0 * N_POL * s)
    b2 = [{"shape": f"P={N_POL} N={s} T={t}",
           "max_abs_err": float((vv - pv)[fin].abs().max()),
           "max_rel_err": rel, "bound_ms": nb, "bound_by": op,
           "floor_ms": eq1_floor_ms(decision.KIND_VICTIM,
                                    (tsi, tid, occ, tp, tl, t_now), 200),
           **timings(lambda: decision.victim_value_multi(
               tsi, tid, occ, tp, tl, t_now, ALPHA),
               lambda: ref.victim_value_multi_ref(tsi, tid, occ, tp, tl,
                                                  t_now, ALPHA),
               None, 200)}]
    log(f"victim_value_multi: bit-equal to {N_POL} single-table launches")
    return b1, b5, b2


def phase_kernels(trace):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    embs = np.stack([r.emb for r in trace.requests]).astype(np.float32)
    slab = torch.from_numpy(embs[:CAPACITY + 1]).to(dev)
    chunk = torch.from_numpy(embs[-CHUNK:]).to(dev)
    reps = torch.from_numpy(unit_rows(rng, N_TOPICS, DIM)).to(dev)
    check_pair_bits(chunk, slab)
    sim = [check_sim_top1(chunk, slab, CAPACITY + 1, 20),
           check_sim_top1(chunk[:8].contiguous(), slab, CAPACITY + 1, 50),
           check_sim_top1(chunk, reps, N_TOPICS, 50)]
    # the ragged and masked edges: an all-masked row is (-inf, 0), and
    # duplicated candidates resolve to the lowest index
    from repro_torch.kernels import similarity_topk
    v, i = similarity_topk.sim_top1(chunk[:5].contiguous(), slab, 0)
    if not bool((v == float("-inf")).all()) or int(i.abs().sum()) != 0:
        raise AssertionError("an all-masked row must be (-inf, 0)")
    dup = slab[:1].repeat(3000, 1).contiguous()
    v, i = similarity_topk.sim_top1(chunk[:5].contiguous(), dup, 3000)
    if int(i.abs().sum()) != 0:
        raise AssertionError("ties must go to the lower index")
    check_eq1_kernel_names()
    main_v = check_values(rng, CAPACITY + 1, N_TOPICS, 200)
    # the arena's per-eviction B3 over a policy's slots (capacity + spare)
    arena_slots = len({r.cid for r in trace.requests}) // 10 + 1
    arena_v = check_values(rng, arena_slots, N_TOPICS, 200, ("rac_value",))
    values = {"victim_value": [main_v["victim_value"]],
              "rac_value": [main_v["rac_value"], arena_v["rac_value"]]}
    # the routing matrix [rep | spread] and norm-augmented queries, their
    # rows 772 floats apart as the routing mirror and route_topics keep
    # them (a 16-byte pitch)
    spread = torch.from_numpy(rng.uniform(0.05, 0.6, N_TOPICS).astype(
        np.float32)).to(dev)
    pitch = -(-(DIM + 1) // 4) * 4
    reps_aug = torch.zeros((N_TOPICS, pitch), device=dev)
    reps_aug[:, :DIM], reps_aug[:, DIM] = reps, spread
    q_aug = torch.zeros((CHUNK, pitch), device=dev)
    q_aug[:, :DIM], q_aug[:, DIM] = chunk, chunk.norm(dim=1)
    topk = phase_topk(chunk, slab, reps_aug[:, :DIM + 1],
                      q_aug[:, :DIM + 1])
    return sim, values, topk


def recording(factory, log_: list):
    """Wrap a policy factory so the policy logs its hit, admit and
    eviction decisions in order."""
    def make(capacity, store):
        pol = factory(capacity, store)
        on_hit, on_admit, victim = pol.on_hit, pol.on_admit, pol.victim

        def hit(cid, req, t):
            log_.append(("hit", int(cid), int(t)))
            return on_hit(cid, req, t)

        def admit(cid, req, t):
            log_.append(("admit", int(cid), int(t)))
            return on_admit(cid, req, t)

        def evict(t):
            v = victim(t)
            log_.append(("evict", int(v), int(t)))
            return v

        pol.on_hit, pol.on_admit, pol.victim = hit, admit, evict
        return pol
    make.__name__ = getattr(factory, "__name__", "policy")
    return make


def phase_parity(trace):
    from repro_torch.core import make_rac, run_policy_batched
    from repro_torch.core.types import Trace
    sub = Trace(requests=trace.requests[:PARITY_LEN],
                n_topics=trace.n_topics, meta=dict(trace.meta))
    runs = {}
    for backend, device in (("kernel", DEVICE), ("numpy", "cpu")):
        events: list = []
        t0 = time.perf_counter()
        st = run_policy_batched(sub, PARITY_CAP,
                                recording(make_rac(), events),
                                hit_mode="semantic", backend=backend,
                                device=device, chunk=CHUNK)
        runs[backend] = (st, events)
        log(f"parity {backend}/{device}: hits={st.hits} misses={st.misses} "
            f"evictions={st.evictions} wall={time.perf_counter() - t0:.2f}s")
    (sk, ek), (sn, en) = runs["kernel"], runs["numpy"]
    if (sk.hits, sk.misses, sk.evictions) != (sn.hits, sn.misses,
                                               sn.evictions):
        raise AssertionError("parity: Stats differ")
    if ek != en:
        first = next(j for j, (a, b) in enumerate(zip(ek, en)) if a != b)
        raise AssertionError(f"parity: event {first} differs: "
                             f"{ek[first]} vs {en[first]}")
    if sk.evictions == 0 or sk.hits == 0:
        raise AssertionError("parity prefix made no evictions or no hits")
    log(f"parity: {len(ek)} hit/admit/evict events identical")
    return en


def record(cache) -> list:
    """Subscribe to the facade's events: (kind, cid, t) in order."""
    log_: list = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda ev, _l=log_: _l.append(
            (ev.kind, int(ev.cid), int(ev.t))))
    return log_


def replay(cache, requests) -> None:
    """``run_policy``'s loop: one lookup per request, admit on a miss."""
    for req in requests:
        if not cache.lookup(req.emb, cid=req.cid, t=req.t, req=req).hit:
            cache.admit(req.cid, req.emb, t=req.t, req=req)


def first_diff(a: list, b: list) -> str:
    j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
             min(len(a), len(b)))
    return (f"event {j} differs: {a[j] if j < len(a) else None} vs "
            f"{b[j] if j < len(b) else None} ({len(a)} vs {len(b)} events)")


def _approx_replay(task):
    """One approximate-parity replay, in a worker process of its own."""
    name, backend, device, kw, cap, dim, reqs = task
    torch.set_num_threads(1)
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.core import make_rac
    cache = SemanticCache(CacheConfig(capacity=cap, dim=dim, backend=backend,
                                      device=device, **kw),
                          policy_factory=make_rac())
    ev = record(cache)
    t0 = time.perf_counter()
    replay(cache, reqs)
    wall = time.perf_counter() - t0
    snap = cache.metrics_snapshot()
    return (name, backend, ev, wall, cache.metrics.hits,
            cache.metrics.evictions,
            {k: snap.get(k) for k in ("quant", "prune", "sync")})


SHARD_COUNTERS = (("similarity_topk", "launches"),
                  ("similarity_topk", "topk_launches"),
                  ("similarity_topk", "topk_q8_launches"),
                  ("similarity_topk", "topk_q8_wgmma_launches"),
                  ("similarity_topk", "multi_launches"),
                  ("decision", "launches"), ("rac_value", "launches"))


def shard_counts(reset: bool = False) -> dict:
    """The launch counters the sharded path moves (reset to 0 first when
    ``reset``)."""
    import importlib
    out = {}
    for mod, attr in SHARD_COUNTERS:
        m = importlib.import_module("repro_torch.kernels." + mod)
        if reset:
            setattr(m, attr, 0)
        out[f"{mod}.{attr}"] = getattr(m, attr)
    return out


def _sharded_approx_replay(task):
    """An approximate replay on the sharded backend in a worker, with the
    launches the replay made."""
    shard_counts(reset=True)
    out = _approx_replay(task)
    return out + (shard_counts(),)


def phase_approx_parity(trace):
    """The exact path on the card and the four approximate configurations
    on the card and on the host oracle, each replay in its own process
    (they are independent and host-bound), all held to the exact events;
    and the sharded backend's quantized and fused pruned lookups at
    SHARDS shards (the sharded phase reads their results)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    reqs = trace.requests[:APPROX_PARITY_LEN]
    tasks = [("exact", "kernel", DEVICE, {}, PARITY_CAP, DIM, reqs)] + [
        (name, backend, device, kw, PARITY_CAP, DIM, reqs)
        for name, kw in APPROX.items()
        for backend, device in (("kernel", DEVICE), ("numpy", "cpu"))]
    shard_tasks = [(name, "sharded", DEVICE,
                    {**APPROX[name], "backend_kwargs": {"n_shards": SHARDS}},
                    PARITY_CAP, DIM, reqs) for name in ("quantized",
                                                        "pruned")]
    # one BLAS thread per worker: the workers share the host's cores
    threads = {k: os.environ.get(k) for k in
               ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")}
    os.environ.update({k: "1" for k in threads})
    try:
        with ProcessPoolExecutor(
                max_workers=len(tasks) + len(shard_tasks),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            shard_futs = [pool.submit(_sharded_approx_replay, t)
                          for t in shard_tasks]
            results = list(pool.map(_approx_replay, tasks))
            sharded = [f.result() for f in shard_futs]
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    _, _, exact, wall, hits, evictions, _ = results[0]
    log(f"approx parity exact/kernel: hits={hits} evictions={evictions} "
        f"events={len(exact)} wall={wall:.2f}s")
    if hits == 0 or evictions == 0:
        raise AssertionError("approx parity prefix made no hits or evictions")
    for name, backend, ev, wall, _, _, snap in results[1:]:
        if ev != exact:
            raise AssertionError(f"approx parity {name}/{backend}: "
                                 + first_diff(ev, exact))
        log(f"approx parity {name}/{backend}: {len(ev)} events identical "
            f"wall={wall:.2f}s quant={json.dumps(snap['quant'])} "
            f"prune={json.dumps(snap['prune'])} "
            f"sync={json.dumps(snap['sync'])}")
    return exact, sharded


def prefix(trace, n: int):
    """The first ``n`` requests as a trace of their own (copied, with
    Belady's next-use pointers taken within the prefix) and its capacity:
    10% of its unique contents."""
    import dataclasses
    from repro_torch.core.types import Trace
    reqs = [dataclasses.replace(r) for r in trace.requests[:n]]
    sub = Trace(requests=reqs, n_topics=trace.n_topics,
                meta=dict(trace.meta)).with_next_use()
    return sub, len({r.cid for r in reqs}) // 10


def _counts(stats) -> list:
    return [(s.policy, s.hits, s.misses, s.evictions) for s in stats]


def _arena_replay(task):
    """One arena replay in a worker process: per-policy counts, wall, the
    stacked kernels' launches and the approximate ledgers."""
    name, backend, device, approx, sub, cap = task
    from repro_torch.cache import ShardedKernelBackend, backends
    from repro_torch.core import default_factories, run_arena
    from repro_torch.kernels import similarity_topk as st
    if backend == "sharded":     # SHARD_ARENA shards (looped on one card)
        backend = ShardedKernelBackend(n_shards=SHARD_ARENA, device=device)
    made = []
    get_backend = backends.get_backend

    def keep(*a, **kw):
        made.append(get_backend(*a, **kw))
        return made[-1]
    st.multi_launches = st.topk_q8_multi_launches = 0
    st.topk_q8_multi_wgmma_launches = 0
    backends.get_backend = keep
    try:
        t0 = time.perf_counter()
        stats = run_arena(sub, cap, default_factories(seed=0),
                          hit_mode="semantic", tau_hit=TAU_HIT,
                          backend=backend, device=device, chunk=CHUNK,
                          **approx)
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        backends.get_backend = get_backend
    be = made[0]
    return (name, backend, _counts(stats), wall,
            {"sim_top1_multi": st.multi_launches,
             "sim_topk_q8_multi": st.topk_q8_multi_launches,
             "sim_topk_q8_multi (wgmma)": st.topk_q8_multi_wgmma_launches},
            {"quant": be.quant_stats, "prune": be.prune_stats})


@contextlib.contextmanager
def _workers(n: int, blas_threads: int):
    """A spawn pool of ``n`` workers with ``blas_threads`` BLAS threads
    each (they share the host's cores with this process)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    keys = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: str(blas_threads) for k in keys})
    try:
        with ProcessPoolExecutor(
                max_workers=n,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            yield pool
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def stacked_victims(policies, views, t_now: int):
    """B2-multi over the RAC variants' final tables (one launch), each
    policy's row held to its single-table launch and to the plain
    version."""
    from repro_torch.kernels import decision, ops, ref
    dev = torch.device(DEVICE)
    alpha = policies[0].alpha
    if any(p.alpha != alpha for p in policies):
        raise AssertionError("the RAC variants' alphas differ")
    t = max(p.table.tp_last.shape[0] for p in policies)

    def stack(arrs, dtype, width=None):
        out = np.zeros((len(arrs), width or arrs[0].shape[0]), dtype)
        for j, a in enumerate(arrs):
            out[j, :a.shape[0]] = a
        return torch.from_numpy(out).to(dev)
    tsi = stack([p.table.tsi for p in policies], np.float32)
    tid = stack([p.table.topic_of for p in policies], np.int32)
    occ = stack([v.occ for v in views], np.int32)
    tp = stack([p.table.tp_last for p in policies], np.float32, t)
    tl = stack([p.table.t_last for p in policies], np.int32, t)
    vv = ops.victim_value_multi(tsi, tid, occ, tp, tl, t_now, alpha=alpha)
    pv = ref.victim_value_multi_ref(tsi, tid, occ, tp, tl, t_now, alpha)
    torch.cuda.synchronize()
    if not torch.equal(torch.isinf(vv), torch.isinf(pv)):
        raise AssertionError("stacked victims: +inf masks differ")
    fin = torch.isfinite(pv)
    rel = float(((vv - pv).abs() / pv.abs().clamp(min=1e-30))[fin].max())
    if not rel <= VALUE_RTOL:
        raise AssertionError(f"stacked victims: rel err {rel}")
    for j in range(len(policies)):
        one = decision.victim_value(tsi[j], tid[j], occ[j], tp[j], tl[j],
                                    t_now, alpha)
        if not torch.equal(vv[j], one):
            raise AssertionError(f"stacked victims: policy {j} differs")
    log(f"arena: stacked victim values of {len(policies)} RAC tables "
        f"(N={tsi.shape[1]}, T={t}) match single launches, rel err {rel}")


def phase_arena(trace):
    """The 15-policy arena on the card against the host oracle (run at the
    same time in a worker), and the approximate arenas on a shorter prefix
    against the exact one (in workers started first: host-bound, they run
    beside the card's arena)."""
    from repro_torch.core import default_factories, run_arena
    from repro_torch.kernels import ops
    from repro_torch.kernels import similarity_topk as st
    sub, cap = prefix(trace, ARENA_LEN)
    n_chunks = -(-len(sub.requests) // CHUNK)
    log(f"arena: {N_POL} policies, {len(sub.requests)} requests, capacity "
        f"{cap}, chunk {CHUNK}, D={DIM}")
    kept = []

    def keeping(f):
        def make(capacity, store):
            kept.append((f(capacity, store), store))
            return kept[-1][0]
        return make
    facs = {n: keeping(f) for n, f in default_factories(seed=0).items()}
    # the approximate arenas on a shorter prefix, against the exact one,
    # side by side (host-bound: each rescans its flagged queries one by
    # one, the quantized ones through the fused lookup)
    sub2, cap2 = prefix(trace, ARENA_APPROX_LEN)
    n_chunks2 = -(-len(sub2.requests) // CHUNK)
    tasks = [(name, "kernel", DEVICE, kw, sub2, cap2) for name, kw in (
        ("exact", {}), ("quantized", {"quantized": True}),
        ("pruned", {"pruned": True}),
        ("both", {"quantized": True, "pruned": True}))] + [
        ("sharded", "sharded", DEVICE, {}, sub2, cap2),
        ("host oracle", "numpy", "cpu", {}, sub2, cap2)]
    with _workers(len(tasks), 1) as approx_pool:
        approx_arenas = [approx_pool.submit(_arena_replay, t)
                         for t in tasks]
        with _workers(1, 4) as pool:
            oracle = pool.submit(_arena_replay,
                                 ("exact", "numpy", "cpu", {}, sub, cap))
            counters = ((st, "multi_launches"), (st, "topk_q8_multi_launches"),
                        (st, "launches"))
            for mod, attr in counters:
                setattr(mod, attr, 0)
            eq1_reset()
            d0 = dict(ops.dispatch_stats)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats = run_arena(sub, cap, facs, hit_mode="semantic",
                              tau_hit=TAU_HIT, backend="kernel", device=DEVICE,
                              chunk=CHUNK)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            disp = {k: ops.dispatch_stats[k] - d0[k] for k in d0}
            peak = torch.cuda.max_memory_allocated()
            eq1_run = eq1_counts()
            rac = [(pol, v) for pol, v in kept if hasattr(pol, "table")]
            stacked_victims([p for p, _ in rac], [v for _, v in rac],
                            sub.requests[-1].t)
            eq1 = eq1_counts()
            launches = {f"{mod.__name__.split('.')[-1]}.{attr}":
                        getattr(mod, attr) for mod, attr in counters}
            launches.update({"rac_value.launches": eq1_run["rac_value"],
                             "rac_value.vec_launches":
                                 eq1_run["rac_value (vector)"],
                             "decision.multi_launches":
                                 eq1["victim_value_multi"],
                             "decision.multi_vec_launches":
                                 eq1["victim_value_multi (vector)"]})
            _, _, want, oracle_wall, _, _ = oracle.result()
        results = [f.result() for f in approx_arenas]
    got = _counts(stats)
    n = len(sub.requests)
    log(f"arena card: wall={wall:.2f}s ({N_POL * n / wall:.0f} "
        f"policy-requests/s), host oracle wall={oracle_wall:.2f}s")
    log(f"arena card: dispatch={json.dumps(disp)} per chunk: dispatches "
        f"{disp['launches'] / n_chunks:.2f}, host syncs "
        f"{disp['host_syncs'] / n_chunks:.2f}; kernel launches "
        f"{json.dumps(launches)} kernel_share_of_wall="
        f"{disp['kernel_s'] / wall:.4f} peak_device_bytes={peak}")
    log("arena hit ratios: " + json.dumps(
        {p: round(h / n, 6) for p, h, _, _ in got}))
    if got != want:
        bad = [(a, b) for a, b in zip(got, want) if a != b]
        raise AssertionError(f"arena: card and host oracle differ: {bad}")
    if any(e == 0 or h == 0 for _, h, _, e in got):
        raise AssertionError("arena: a policy made no hits or evictions")
    if launches["similarity_topk.multi_launches"] != n_chunks:
        raise AssertionError(f"arena: {launches} stacked launches for "
                             f"{n_chunks} chunks")
    if launches["rac_value.launches"] < 1 \
            or launches["decision.multi_launches"] < 1:
        raise AssertionError(f"arena: B3 or B7 did not launch: {launches}")
    log(f"arena: {N_POL} policies' hits, misses and evictions identical on "
        f"the card and the host oracle over {n} requests")

    exact = results[0][2]
    for name, _, cnt, w, kl, ledgers in results:
        log(f"arena {name}: {len(sub2.requests)} requests, capacity {cap2}, "
            f"wall={w:.2f}s launches={json.dumps(kl)} "
            f"quant={json.dumps(ledgers['quant'])} "
            f"prune={json.dumps(ledgers['prune'])}")
        if cnt != exact:
            bad = [(a, b) for a, b in zip(cnt, exact) if a != b]
            raise AssertionError(f"arena {name}: Stats differ from the "
                                 f"exact arena's: {bad}")
    q8_launches = results[1][4]["sim_topk_q8_multi"]
    if q8_launches != n_chunks2:
        raise AssertionError(f"arena quantized: {q8_launches} stacked int8 "
                             f"launches for {n_chunks2} chunks")
    on_wgmma = results[1][4]["sim_topk_q8_multi (wgmma)"]
    if on_wgmma != q8_launches:
        raise AssertionError(f"arena quantized: {q8_launches - on_wgmma} of "
                             f"{q8_launches} stacked int8 launches at "
                             f"D={DIM} missed the wgmma kernel")
    log(f"arena: the quantized, pruned, composed and sharded arenas and "
        f"the host oracle made the exact arena's Stats for all {N_POL} "
        "policies")
    return results[4], {"sim_top1_multi": launches["similarity_topk.multi_launches"],
            "victim_value_multi": launches["decision.multi_launches"],
            "victim_value_multi (vector)":
                launches["decision.multi_vec_launches"],
            "rac_value": launches["rac_value.launches"],
            "sim_topk_q8_multi": q8_launches,
            "sim_topk_q8_multi (wgmma)": on_wgmma}


def shard_twins(rng, trace_embs: np.ndarray):
    """A ShardedStore of SHARDS shards at the main path's geometry (capacity
    CAPACITY, so ceil((CAPACITY + 1) / SHARDS) rows a shard) filled with
    seeded unit rows, a dense ResidentStore holding the same rows in the
    same slots, a seeded policy table over those slots (the main path's
    T = 512 topics), and a chunk of queries: half near resident rows, half
    the trace's own."""
    from repro_torch.cache import ShardedStore
    from repro_torch.core.policy_table import PolicyTable
    from repro_torch.core.store import ResidentStore
    rows = unit_rows(rng, CAPACITY, DIM)
    sh = ShardedStore(CAPACITY, DIM, SHARDS)
    for i in range(CAPACITY):
        sh.insert(i, rows[i])
    n_slots = sh.emb.shape[0]
    dense = ResidentStore(CAPACITY, DIM, n_slots=n_slots)
    dense.emb[:], dense.occ[:], dense.cid[:] = sh.emb, sh.occ, sh.cid
    dense.slot_of, dense.hwm = dict(sh.slot_of), sh.hwm
    dense._free = [s for s in range(n_slots - 1, -1, -1) if not sh.occ[s]]
    t = 512
    table = PolicyTable(n_slots, DIM, n_topics=t)
    table.tsi[:] = np.where(sh.occ, rng.random(n_slots) * 8, 0.0)
    table.topic_of[:] = np.where(sh.occ, rng.integers(0, t, n_slots), -1)
    table.tp_last[:] = rng.random(t) * 20
    table.t_last[:] = rng.integers(0, 60_000, t)
    table.rep[:] = unit_rows(rng, t, DIM)
    table.rep_valid[:] = True
    table.topic_hwm = t
    near = rows[::CAPACITY // (CHUNK // 2)][:CHUNK // 2]
    near = near + 0.1 * unit_rows(rng, len(near), DIM)
    q = np.concatenate([near / np.linalg.norm(near, axis=1, keepdims=True),
                        trace_embs[:CHUNK // 2]])
    return sh, dense, table, q.astype(np.float32)


def bit_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """The same values bit for bit (on the card every entry of the sharded
    and the dense paths comes from the same arithmetic)."""
    return np.array_equal(a, b)


def check_shard_geometry(label: str, sh, dense, table, q) -> dict:
    """The sharded backend against KernelBackend on the same rows in the
    same slots: top1_batch (identical cids, the same fp32 bits),
    decide_batch (every column in the same bits) and rac_value at
    N = CAPACITY + 1 (the same bits as one B3), then the CUDA-event ms a
    chunk of both lookups and the launches a sharded lookup makes."""
    from repro_torch.cache import KernelBackend, ShardedKernelBackend
    from repro_torch.kernels import rac_value as rv_mod
    from repro_torch.kernels import similarity_topk as st
    be = ShardedKernelBackend(n_shards=SHARDS, device=DEVICE)
    kb = KernelBackend(DEVICE)
    on_mesh = be.mesh() is not None
    n0 = st.launches
    got = be.top1_batch(sh, q)
    b1_chunk = st.launches - n0
    want = kb.top1_batch(dense, q)
    if not (np.array_equal(got[0], want[0]) and bit_equal(got[1], want[1])):
        bad = int((got[0] != want[0]).sum() + (got[1] != want[1]).sum())
        raise AssertionError(f"sharded {label}: top1_batch differs from "
                             f"KernelBackend's in {bad} places")
    if b1_chunk != SHARDS:
        raise AssertionError(f"sharded {label}: {b1_chunk} B1 launches for "
                             f"{SHARDS} shards")
    t_now = 72_000
    ds = be.decide_batch(sh, table, q, alpha=ALPHA, t_now=t_now)
    dk = kb.decide_batch(dense, table, q, alpha=ALPHA, t_now=t_now)
    for f in ("hit_cid", "hit_sim", "route_tid", "route_sim",
              "victim_value"):
        if not bit_equal(getattr(ds, f), getattr(dk, f)):
            raise AssertionError(f"sharded {label}: decide_batch's {f} "
                                 "differs from KernelBackend's")
    rng = np.random.default_rng(29)
    n, t = CAPACITY + 1, 4_096
    args = (rng.random(n) * 8, rng.integers(0, t, n), rng.random(t) * 20,
            rng.integers(0, 60_000, t), ALPHA, t_now)
    n0 = rv_mod.launches
    vs = be.rac_value(*args)
    b3_call = rv_mod.launches - n0
    if not bit_equal(vs, kb.rac_value(*args)):
        raise AssertionError(f"sharded {label}: rac_value differs from one "
                             "B3's")
    if b3_call != (SHARDS if on_mesh else 1):
        raise AssertionError(f"sharded {label}: {b3_call} B3 launches")
    ms = event_ms(lambda: be.top1_batch(sh, q), SHARD_REPS)
    ms_dense = event_ms(lambda: kb.top1_batch(dense, q), SHARD_REPS)
    log(f"sharded {label}: {len(q)} queries x {SHARDS} shards of "
        f"{sh.rows_per_shard} rows (local hwm {sh.local_hwm.tolist()}): "
        f"cids identical, sims, decide_batch and rac_value (N={n}, "
        f"{b3_call} B3) bit-equal to KernelBackend; {ms:.3f} ms a chunk "
        f"({b1_chunk} B1 launches) against {ms_dense:.3f} ms on the single "
        f"slab (1 launch); sync={json.dumps(be.sync_stats)}")
    return {"ms_chunk": ms, "ms_chunk_dense": ms_dense,
            "b1_launches_chunk": b1_chunk, "b3_launches_call": b3_call}


def shard_kernel_rows(sh, q) -> tuple[dict, dict]:
    """§ 6's rows at the sharded shapes: the SHARDS B1 launches of one
    lookup (Q = CHUNK over SHARDS shards) and the SHARDS B3 launches of a
    chunked rac_value (N = CAPACITY + 1), each group timed as one call
    against its plain versions."""
    from repro_torch.kernels import rac_value as rv_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import similarity_topk as st
    dev = torch.device(DEVICE)
    r = sh.rows_per_shard
    slab = torch.from_numpy(sh.emb).to(dev)
    parts = [slab[s * r:(s + 1) * r] for s in range(SHARDS)]
    nv = [int(x) for x in sh.local_hwm]
    qd = torch.from_numpy(q).to(dev)

    def loop(fn):
        return lambda: [fn(qd, parts[s], nv[s]) for s in range(SHARDS)]
    err = max(float((a[0] - b[0]).abs().max()) for a, b in zip(
        loop(st.sim_top1)(), loop(ref.sim_top1_ref)()))
    if not err <= SIM_TOL:
        raise AssertionError(f"sharded B1: max |err| {err} > {SIM_TOL}")
    nq, n = qd.shape[0], sum(nv)
    nb, op = bound((nq * DIM + n * DIM) * 4 + SHARDS * nq * 8,
                   B1_PRODUCTS * 2.0 * nq * n * DIM, PEAK_TF32)
    b1 = {"shape": f"sharded: Q={nq} over {SHARDS} x {r} rows D={DIM} "
                   f"({SHARDS} launches a call)",
          "max_abs_err": err, "bound_ms": nb, "bound_by": op,
          **timings(loop(st.sim_top1), loop(ref.sim_top1_ref),
                    lambda: [torch.mm(qd, p.T) for p in parts], 50)}
    rng = np.random.default_rng(31)
    n, t = CAPACITY + 1, 4_096
    chunk = -(-n // SHARDS)
    tsi = torch.from_numpy(rng.random(n).astype(np.float32) * 8).to(dev)
    tid = torch.from_numpy(rng.integers(0, t, n).astype(np.int32)).to(dev)
    tp = torch.from_numpy(rng.random(t).astype(np.float32) * 20).to(dev)
    tl = torch.from_numpy((rng.integers(0, 60_000, t) - 72_000)
                          .astype(np.int32)).to(dev)
    # one tensor a chunk, as the backend uploads them
    cuts = [(tsi[lo:lo + chunk].clone(), tid[lo:lo + chunk].clone())
            for lo in range(0, n, chunk)]

    def b3(fn, tl_):
        return lambda: [fn(a, b, tp, tl_, ALPHA, 0) for a, b in cuts]
    got = torch.cat(b3(rv_mod.rac_value, tl)())
    one = rv_mod.rac_value(tsi, tid, tp, tl, ALPHA, 0)
    if not bit_equal(got.cpu().numpy(), one.cpu().numpy()):
        raise AssertionError("sharded B3: the chunks' values differ from "
                             "one launch's")
    rel, a = value_rel(got, torch.cat(b3(ref.rac_value_ref, tl.float())()))
    if not rel <= VALUE_RTOL:
        raise AssertionError(f"sharded B3: rel err {rel} > {VALUE_RTOL}")
    nb, op = bound(n * 12 + SHARDS * t * 8, 5.0 * n)
    b3_row = {"shape": f"sharded: N={n} in {len(cuts)} chunks of {chunk} "
                       f"T={t} ({len(cuts)} launches a call)",
              "max_abs_err": a, "max_rel_err": rel, "bound_ms": nb,
              "bound_by": op,
              **timings(b3(rv_mod.rac_value, tl),
                        b3(ref.rac_value_ref, tl.float()), None, 50)}
    log("sharded kernel rows: " + json.dumps({"sim_top1": b1,
                                              "rac_value": b3_row}))
    return b1, b3_row


def phase_sharded(trace, parity_events, approx, arena) -> dict:
    """The sharded backend (ShardedStore, ShardedKernelBackend): at full
    geometry against KernelBackend, on the one-card loop and on the
    multi-card code path (make_cache_mesh patched to cuda:0 for every
    shard); the 8,000-request parity at SHARD_PARITY shards against the
    numpy record of phase_parity; the approximate replays (run beside
    phase_approx_parity's) and the arena (beside phase_arena's) held to
    the host oracle's outcomes."""
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.core import make_rac, replay_batched
    from repro_torch.launch import mesh
    t_start = time.perf_counter()
    sh, dense, table, q = shard_twins(
        np.random.default_rng(23),
        np.stack([r.emb for r in trace.requests[:CHUNK]]))
    geo = {"loop": check_shard_geometry("loop", sh, dense, table, q)}
    orig = mesh.make_cache_mesh
    lead = torch.device("cuda", 0) if DEVICE == "cuda" else \
        torch.device(DEVICE)
    try:
        mesh.make_cache_mesh = lambda n, device="cuda": [lead] * n
        geo["mesh"] = check_shard_geometry(f"mesh ({lead} x {SHARDS})", sh,
                                           dense, table, q)
    finally:
        mesh.make_cache_mesh = orig
    b1_row, b3_row = shard_kernel_rows(sh, q)
    del sh, dense
    torch.cuda.empty_cache()

    sub = trace.requests[:PARITY_LEN]
    launches = {}
    for n_shards in SHARD_PARITY:
        events: list = []
        cache = SemanticCache(CacheConfig(
            capacity=PARITY_CAP, dim=DIM, backend="sharded", device=DEVICE,
            backend_kwargs={"n_shards": n_shards}),
            policy_factory=recording(make_rac(), events))
        shard_counts(reset=True)
        t0 = time.perf_counter()
        replay_batched(cache, sub, chunk=CHUNK, tau_hit=TAU_HIT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[n_shards] = shard_counts()
        m = cache.metrics
        log(f"sharded parity S={n_shards}: hits={m.hits} "
            f"evictions={m.evictions} wall={wall:.2f}s launches="
            f"{json.dumps(launches[n_shards])} "
            f"load={cache.store.load.tolist()}")
        if events != parity_events:
            raise AssertionError(f"sharded parity S={n_shards}: "
                                 + first_diff(events, parity_events))
        if m.evictions == 0 or m.hits == 0:
            raise AssertionError("sharded parity made no evictions or hits")
        for k in ("similarity_topk.launches", "decision.launches",
                  "rac_value.launches"):
            if launches[n_shards][k] < 1:
                raise AssertionError(f"sharded parity S={n_shards}: {k} "
                                     "never launched")
        del cache
    log(f"sharded parity: {len(parity_events)} events identical to the "
        f"host oracle's at S = {SHARD_PARITY}")

    exact, results = approx
    for name, _, ev, wall, hits, evictions, snap, kl in results:
        log(f"sharded approx {name} S={SHARDS}: {len(ev)} events, hits="
            f"{hits} evictions={evictions} wall={wall:.2f}s launches="
            f"{json.dumps(kl)} quant={json.dumps(snap['quant'])} "
            f"prune={json.dumps(snap['prune'])}")
        if ev != exact:
            raise AssertionError(f"sharded approx {name}: "
                                 + first_diff(ev, exact))
        ledger = snap["quant" if name == "quantized" else "prune"]
        if ledger["scans"] < 1:
            raise AssertionError(f"sharded approx {name}: no scans")
    q_kl, p_kl = results[0][7], results[1][7]
    if q_kl["similarity_topk.topk_q8_launches"] < SHARDS:
        raise AssertionError(f"sharded approx quantized: B5 launches {q_kl}")
    if q_kl["similarity_topk.topk_q8_wgmma_launches"] \
            != q_kl["similarity_topk.topk_q8_launches"]:
        raise AssertionError("sharded approx quantized: a B5 launch on a "
                             f"shard's rows at D={DIM} missed wgmma: {q_kl}")
    # the fused pruned lookup: B4 routes, B1 rescores the union (its int8
    # candidate scan is the pipeline's own glue, kernels/fused.py)
    if p_kl["similarity_topk.topk_launches"] < 1 \
            or p_kl["similarity_topk.launches"] < 1:
        raise AssertionError(f"sharded approx pruned: B4/B1 launches {p_kl}")

    _, _, counts, wall, kl, _ = arena
    n_chunks = -(-ARENA_APPROX_LEN // CHUNK)
    log(f"sharded arena S={SHARD_ARENA}: {ARENA_APPROX_LEN} requests, "
        f"wall={wall:.2f}s launches={json.dumps(kl)} (Stats equal to the "
        "host oracle's, phase 6)")
    # one B1-multi a shard for every chunk but the first (an empty arena
    # answers without a launch, as the reference's sharded backend does)
    if kl["sim_top1_multi"] != SHARD_ARENA * (n_chunks - 1):
        raise AssertionError(f"sharded arena: {kl['sim_top1_multi']} "
                             f"B1-multi launches for {n_chunks} chunks")
    wall = time.perf_counter() - t_start
    log(f"sharded: {wall:.1f}s")
    parity = {k: sum(launches[s][k] for s in SHARD_PARITY)
              for k in launches[SHARD_PARITY[0]]}
    return {"geometry": geo, "b1_row": b1_row, "b3_row": b3_row,
            "launches": {
                "sim_top1": parity["similarity_topk.launches"]
                + q_kl["similarity_topk.launches"]
                + p_kl["similarity_topk.launches"],
                "victim_value": parity["decision.launches"]
                + q_kl["decision.launches"] + p_kl["decision.launches"],
                "rac_value": parity["rac_value.launches"]
                + q_kl["rac_value.launches"] + p_kl["rac_value.launches"],
                "sim_topk": p_kl["similarity_topk.topk_launches"],
                "sim_topk_q8": q_kl["similarity_topk.topk_q8_launches"]
                + p_kl["similarity_topk.topk_q8_launches"],
                "sim_top1_multi": kl["sim_top1_multi"]},
            "wall_s": wall}


def phase_main(trace):
    """The batched replay of the trace's first MAIN_LEN requests, on a
    cache the smoke keeps for the approximate continuation; then B2 and B3
    at the topic table the replay grew to."""
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.core import make_rac, replay_batched
    from repro_torch.kernels import ops, similarity_topk
    reqs = trace.requests[:MAIN_LEN]
    cache = SemanticCache(CacheConfig(capacity=CAPACITY, dim=DIM,
                                      device=DEVICE),
                          policy_factory=make_rac())
    # the topic table each eviction's B3 sees (the tables grow by doubling)
    seen_t = []
    score = cache.policy.value_backend

    def value_backend(tsi, tids, tp_last, *a):
        seen_t.append(len(tp_last))
        return score(tsi, tids, tp_last, *a)
    cache.policy.value_backend = value_backend
    similarity_topk.launches = 0
    eq1_reset()
    before = dict(ops.dispatch_stats)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    replay_batched(cache, reqs, chunk=CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cache.policy.value_backend = score
    eq1 = eq1_counts()
    launches = {"sim_top1": similarity_topk.launches,
                "victim_value": eq1["victim_value"],
                "rac_value": eq1["rac_value"]}
    disp = {k: ops.dispatch_stats[k] - before[k] for k in before}
    n = len(reqs)
    m = cache.metrics
    log(f"main: requests={n} hits={m.hits} misses={m.misses} "
        f"evictions={m.evictions} hit_ratio={m.hit_ratio:.4f} "
        f"wall={wall:.2f}s ({n / wall:.1f} req/s)")
    log(f"main: dispatch={json.dumps(disp)} kernel_launches="
        f"{json.dumps(launches)} eq1={json.dumps(eq1)} kernel_share_of_wall="
        f"{disp['kernel_s'] / wall:.4f} peak_device_bytes="
        f"{torch.cuda.max_memory_allocated()}")
    if m.hits + m.misses != n:
        raise AssertionError("main: hits + misses != requests")
    if m.evictions <= 0 or m.hits <= 0:
        raise AssertionError("main: the replay made no evictions or no hits")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"main: kernels never launched: {missing}")
    for k in ("victim_value", "rac_value"):
        if eq1[k + " (vector)"] != eq1[k]:
            raise AssertionError(f"main: {eq1[k] - eq1[k + ' (vector)']} of "
                                 f"{eq1[k]} {k} launches missed the vector "
                                 "path")
    t_real = seen_t[-1]
    log(f"main: B3's topic table at the last eviction T={t_real} (first "
        f"{seen_t[0]}, {len(set(seen_t))} sizes over {len(seen_t)} "
        "evictions)")
    real = check_values(np.random.default_rng(3), CAPACITY + 1, t_real, 200)
    return launches, cache, real


def device_kernels(fn) -> int | None:
    """CUDA kernels one call of ``fn`` launches, from torch.profiler (None
    when the profiler records no device activity)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "memcpy" not in e.name.lower()
            and "memset" not in e.name.lower())
    return n or None


def timed(targets):
    """Patch each ``(owner, attribute)`` callable so it adds its wall time
    to a total; returns ``(totals, restore)``.  Nested calls count in each
    of their callers too."""
    totals, saved = {}, []
    for owner, name in targets:
        fn = getattr(owner, name)
        key = f"{owner.__name__.split('.')[-1]}.{name}"
        totals[key] = 0.0

        def wrap(*a, _fn=fn, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                totals[_key] += time.perf_counter() - t0
        setattr(owner, name, wrap)
        saved.append((owner, name, fn))

    def restore():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return totals, restore


def phase_approx_main(trace, warm):
    """Checkpoint the warmed full-width cache, restore it into an exact and
    a quantized+pruned cache, and continue both request by request, then
    with one staged peek of PEEK queries."""
    from repro_torch.cache import CacheConfig, SemanticCache
    from repro_torch.cache.backends import KernelBackend
    from repro_torch.cache.pruned import TopicBucketIndex
    from repro_torch.core.rac import RACPolicy
    from repro_torch.kernels import fused, ops, similarity_topk as st
    # where the host time of a request goes
    spans = ((RACPolicy, "on_admit"), (RACPolicy, "victim"),
             (KernelBackend, "top1_batch"),
             (KernelBackend, "_top1_batch_exact"),
             (TopicBucketIndex, "sync"), (TopicBucketIndex, "csr"),
             (fused, "fused_pruned_lookup"), (ops, "to_host_tuple"))
    t0 = time.perf_counter()
    state = warm.checkpoint()
    log(f"approx main: checkpoint of {len(warm)} entries "
        f"{time.perf_counter() - t0:.1f}s")
    cont = trace.requests[MAIN_LEN:MAIN_LEN + CONT_LEN]
    peek = np.stack([r.emb for r in trace.requests[MAIN_LEN:MAIN_LEN + PEEK]]
                    ).astype(np.float32)
    counters = ("topk_launches", "topk_f32_launches", "topk_q8_launches",
                "topk_q8_wgmma_launches", "launches", "dev_n_valid_launches")
    runs = {}
    for name, kw in (("exact", {}),
                     ("approx", dict(quantized_lookup=True,
                                     pruned_lookup=True))):
        cache = SemanticCache(CacheConfig(capacity=CAPACITY, dim=DIM,
                                          device=DEVICE, **kw))
        cache.restore(state)
        ev = record(cache)
        # the first lookup builds the int8 mirror, the bucket index and
        # their device copies from the journals: set-up, not timed
        cache.peek_batch(peek[:1])
        for c in counters:
            setattr(st, c, 0)
        eq1_reset()
        d0 = dict(ops.dispatch_stats)
        prune0 = dict(cache.metrics_snapshot()["prune"])
        totals, restore = timed(spans)
        t0 = time.perf_counter()
        try:
            replay(cache, cont)
            torch.cuda.synchronize()
        finally:
            restore()
        wall = time.perf_counter() - t0
        disp = {k: ops.dispatch_stats[k] - d0[k] for k in d0}
        t1 = time.perf_counter()
        pc, ps = cache.peek_batch(peek)
        peek_s = time.perf_counter() - t1
        kl = {c: getattr(st, c) for c in counters}
        kl.update(eq1_counts())
        snap = cache.metrics_snapshot()
        prune = {k: snap["prune"][k] - prune0[k] for k in prune0}
        runs[name] = dict(ev=ev, pc=pc, ps=ps, cache=cache, launches=kl)
        rows = (prune["scanned_rows"] / max(1, prune["queries"])
                if name == "approx" else float(cache.store.hwm))
        log(f"approx main {name}: {CONT_LEN} requests in {wall:.2f}s "
            f"({CONT_LEN / wall:.1f} req/s), rows scanned per query "
            f"{rows:.1f} of {cache.store.hwm}, launches per lookup "
            f"{disp['launches'] / CONT_LEN:.2f}, host syncs per lookup "
            f"{disp['host_syncs'] / CONT_LEN:.2f}, peek of {PEEK} "
            f"{peek_s:.2f}s, kernel launches {json.dumps(kl)}")
        log(f"approx main {name}: host seconds by function (nested "
            f"calls count in their callers too): "
            f"{json.dumps({k: round(v, 3) for k, v in totals.items()})}")
        log(f"approx main {name}: quant={json.dumps(snap['quant'])} "
            f"prune={json.dumps(snap['prune'])} "
            f"sync={json.dumps(snap.get('sync'))}")
    ex, ap = runs["exact"], runs["approx"]
    if ap["ev"] != ex["ev"]:
        raise AssertionError("approx main: " + first_diff(ap["ev"], ex["ev"]))
    hit = ex["ps"] >= TAU_HIT
    if not (np.array_equal(ap["ps"] >= TAU_HIT, hit)
            and np.array_equal(ap["pc"][hit], ex["pc"][hit])):
        raise AssertionError("approx main: peek hit cids differ")
    log(f"approx main: {len(ex['ev'])} events and {int(hit.sum())} peek hit "
        "cids identical")
    kl = ap["launches"]
    need = {"topk_launches": "sim_topk", "topk_q8_launches": "sim_topk_q8",
            "dev_n_valid_launches": "sim_top1 (device n_valid)",
            "rac_value": "rac_value"}
    missing = [v for k, v in need.items() if kl[k] < 1]
    if missing:
        raise AssertionError(f"approx main: kernels never launched: "
                             f"{missing}")
    if kl["topk_f32_launches"] != kl["topk_launches"]:
        raise AssertionError(
            f"approx main: {kl['topk_launches'] - kl['topk_f32_launches']} of "
            f"{kl['topk_launches']} fp32 Top-K launches missed the "
            "sim_topk_f32.cu kernels")
    if kl["topk_q8_wgmma_launches"] != kl["topk_q8_launches"]:
        raise AssertionError(
            f"approx main: {kl['topk_q8_launches'] - kl['topk_q8_wgmma_launches']}"
            f" of {kl['topk_q8_launches']} int8 Top-K launches at D={DIM} "
            "missed the wgmma kernel")
    # kernels and host syncs of one fused lookup at b = 1
    cache = ap["cache"]
    q = cont[-1].emb[None, :].astype(np.float32)
    s0 = ops.dispatch_stats["host_syncs"]
    n_kern = device_kernels(lambda: cache.backend.top1_batch(cache.store, q))
    log(f"approx main: one fused lookup = {n_kern} CUDA kernels, "
        f"{ops.dispatch_stats['host_syncs'] - s0} host sync(s)")
    return kl


# --------------------------------------------------------------- kv phase
def kv_prompts(cids, parent: dict) -> list:
    """Each request's prompt: the token runs of its parent chain, root
    first.  A message's run is 16-256 token ids below KV_VOCAB drawn from
    ``default_rng([0, cid])``."""
    runs: dict = {}

    def run(cid):
        if cid not in runs:
            rng = np.random.default_rng([0, cid])
            n = int(rng.integers(16, 257))
            runs[cid] = rng.integers(0, KV_VOCAB, size=n).tolist()
        return runs[cid]
    prompts = []
    for cid in cids:
        chain = [cid]
        while parent[chain[-1]] >= 0:
            chain.append(parent[chain[-1]])
        prompts.append([tok for c in reversed(chain) for tok in run(c)])
    return prompts


def kv_outcome(r: dict) -> tuple:
    return (r["hit_tokens"], len(r["new_blocks"]), r["topic"],
            tuple(r["evicted"]))


def _kv_replay(task):
    """The kv phase's replay on a host scorer, in a worker process: the
    plain B3 (``device="cpu"``) or the float64 oracle (numpy)."""
    backend, device, cids, parent = task
    torch.set_num_threads(1)
    from repro_torch.serving import KVBlockManager
    prompts = kv_prompts(cids, parent)
    mgr = KVBlockManager(KV_BLOCKS, KV_BLOCK_TOKENS, backend=backend,
                         device=device)
    t0 = time.perf_counter()
    out = [kv_outcome(mgr.on_request(p)) for p in prompts]
    return out, time.perf_counter() - t0


def kv_check_radix(mgr, where: str) -> None:
    """Radix validity: no resident block has an evicted parent, and the
    mirror holds exactly the cache's residents."""
    blocks = mgr.blocks
    orphans = [b for b, blk in blocks.items()
               if blk.parent >= 0 and blk.parent not in blocks]
    if orphans:
        raise AssertionError(f"kv {where}: {len(orphans)} resident blocks "
                             f"have an evicted parent, e.g. {orphans[:3]}")
    if set(blocks) != set(mgr.cache.store.keys()):
        raise AssertionError(f"kv {where}: the radix mirror and the cache's "
                             "residents differ")


def kv_near_ties(pol, record: list, where: list):
    """Wrap the policy's victim scan: for every eviction, the float64
    values (the host oracle's arithmetic) of the blocks whose card value
    lies within KV_WINDOW of the minimum; where the float64 order elects
    another victim than the card's, record (request, eviction, card
    victim, its float64 value, float64 victim, its value).  The card's
    values are fp32 within a few ulps (2^-21) of the float64 ones, so the
    float64 victim always lies inside the window."""
    scores = pol._scores

    def wrapped(t):
        values, valid = scores(t)          # by slot, +inf where invalid
        if valid.any():
            m = values.min()
            near = np.flatnonzero(values <= m + m * KV_WINDOW)
            tids = pol.topic_of[near]
            tsi = pol.freq[near] + pol.lam * pol.dep[near]
            v64 = (0.5 ** (pol.alpha * (t - pol.t_last[tids]))
                   * pol.tp_last[tids] * tsi)
            v32 = values[near]
            cids, lt = pol.store.cid[near], pol.last_t[near]
            a = np.lexsort((cids, lt, v32))[0]
            b = np.lexsort((cids, lt, v64))[0]
            if a != b:
                record.append((where[0], where[1], int(cids[a]),
                               float(v64[a]), int(cids[b]), float(v64[b])))
            where[1] += 1
        return values, valid
    pol._scores = wrapped
    return scores


def kv_workers(pool, trace) -> dict:
    """Start the kv phase's host replays in ``pool``: the plain B3
    (``device="cpu"``) and the float64 oracle (numpy)."""
    parent = {r.cid: r.parent_cid for r in trace.requests}
    cids = [r.cid for r in trace.requests[:KV_LEN]]
    return {name: pool.submit(_kv_replay, (backend, device, cids, parent))
            for name, backend, device in (("plain", "kernel", "cpu"),
                                          ("oracle", "numpy", "cpu"))}


def phase_kv(trace, hosts: dict):
    """The KV prefix-block cache at deployment size (KV_BLOCKS blocks of
    KV_BLOCK_TOKENS tokens: 42.9 GB of the paper LM's KV) on the card,
    held to the plain B3 and to the float64 host oracle (``hosts``, from
    :func:`kv_workers`)."""
    from repro_torch.kernels import ops, rac_value, similarity_topk
    from repro_torch.serving import KVBlockManager
    parent = {r.cid: r.parent_cid for r in trace.requests}
    t0 = time.perf_counter()
    prompts = kv_prompts([r.cid for r in trace.requests[:KV_LEN]], parent)
    lens = np.array([len(p) for p in prompts])
    log(f"kv: {KV_LEN} requests (KV_LEN), prompts {lens.mean():.1f} tokens "
        f"on average (median {np.median(lens):.0f}, longest {lens.max()}), "
        f"built in {time.perf_counter() - t0:.2f}s")
    mgr = KVBlockManager(KV_BLOCKS, KV_BLOCK_TOKENS, device=DEVICE)
    pol = mgr.policy
    flips: list = []
    where = [0, 0]                       # request, eviction
    kv_near_ties(pol, flips, where)
    # B3's device time on a sample of its launches (CUDA graphs of the
    # same call; their launches are taken back off the counters)
    sample_ms: list = []
    last: list = []
    masked = ops.rac_value_masked

    def sampled(tsi, tid, tp, tl, valid, alpha, t_now):
        out = masked(tsi, tid, tp, tl, valid, alpha, t_now)
        if rac_value.launches % KV_SAMPLE == 0:
            n0 = rac_value.launches, rac_value.vec_launches
            sample_ms.append(graph_ms(lambda: rac_value.rac_value(
                tsi, tid, tp, tl, alpha, t_now, valid), 20))
            rac_value.launches, rac_value.vec_launches = n0
            last[:] = [(tsi, tid, tp, tl, valid, alpha, t_now)]
        return out
    ops.rac_value_masked = sampled
    victim_s = [0.0]
    victim = pol.victim

    def timed_victim(t):
        t1 = time.perf_counter()
        try:
            return victim(t)
        finally:
            victim_s[0] += time.perf_counter() - t1
    pol.victim = timed_victim
    similarity_topk.launches = 0
    eq1_reset()
    torch.cuda.reset_peak_memory_stats()
    out = []
    t0 = time.perf_counter()
    try:
        for i, p in enumerate(prompts):
            where[0] = i
            out.append(kv_outcome(mgr.on_request(p)))
            if (i + 1) % KV_CHECK_EVERY == 0:
                kv_check_radix(mgr, f"request {i + 1}")
        torch.cuda.synchronize()
    finally:
        ops.rac_value_masked = masked
    wall = time.perf_counter() - t0
    b3 = rac_value.launches
    b1 = similarity_topk.launches
    kv_check_radix(mgr, "end")
    peak = torch.cuda.max_memory_allocated()
    plain, plain_wall = hosts["plain"].result()
    oracle, oracle_wall = hosts["oracle"].result()
    m = mgr.cache.metrics
    hit_tok = sum(o[0] for o in out)
    new_blocks = sum(o[1] for o in out)
    full = lens // KV_BLOCK_TOKENS * KV_BLOCK_TOKENS
    fails = int(sum(o[0] + KV_BLOCK_TOKENS * o[1] < f
                    for o, f in zip(out, full)))
    dev_ms = float(np.mean(sample_ms)) * b3 if sample_ms else float("nan")
    log(f"kv: {KV_LEN} requests in {wall:.2f}s ({KV_LEN / wall:.1f} req/s), "
        f"hit-token share {hit_tok / lens.sum():.4f}, blocks hit "
        f"{hit_tok // KV_BLOCK_TOKENS} new {new_blocks}, evictions "
        f"{m.evictions}, allocation failures {fails}, resident {mgr.used} "
        f"of {KV_BLOCKS}")
    log(f"kv: B3 launches {b3} ({rac_value.vec_launches} vector), B1 "
        f"launches {b1}; B3 device {np.mean(sample_ms) if sample_ms else 0:.5f}"
        f" ms a launch over {len(sample_ms)} sampled launches, "
        f"{dev_ms:.1f} ms summed ({dev_ms / 1e3 / wall:.4f} of the wall); "
        f"host {victim_s[0] / max(1, m.evictions) * 1e3:.3f} ms per eviction "
        f"({victim_s[0]:.2f}s in the victim scan, B3 included); largest T "
        f"{len(pol.tp_last)} ({pol._next_tid} topics); peak device bytes "
        f"{peak}; workers: plain B3 {plain_wall:.2f}s, float64 oracle "
        f"{oracle_wall:.2f}s")
    if out != plain:
        raise AssertionError("kv: the card and the plain B3 differ: "
                             + first_diff(out, plain))
    if (out == oracle) != (not flips) or (
            flips and flips[0][0] != first_diff_at(out, oracle)):
        raise AssertionError(
            "kv: the float64 oracle parts from the card "
            f"{'nowhere' if out == oracle else 'at request ' + str(first_diff_at(out, oracle))}"
            f" but the float64 re-scoring of the card's evictions elects "
            f"another victim at {flips[:3]}")
    if out == oracle:
        log(f"kv: {KV_LEN} request outcomes identical to the plain B3's and "
            "to the float64 oracle's")
    else:
        j = first_diff_at(out, oracle)
        r, e, ca, va, cb, vb = flips[0]
        rel = abs(va - vb) / max(abs(va), abs(vb))
        log(f"kv: identical to the plain B3's; the float64 oracle parts at "
            f"request {j} (eviction {e}): card victim {ca} at {va!r}, "
            f"float64 victim {cb} at {vb!r}, {rel:.3e} relative")
        if not rel <= KV_NEAR_TIE:
            raise AssertionError(f"kv: the oracle parts at request {j} on "
                                 f"values {rel:.3e} apart, more than an fp32 "
                                 "near-tie")
    if b3 < m.evictions:
        raise AssertionError(f"kv: {b3} B3 launches for {m.evictions} "
                             "evictions")
    if rac_value.vec_launches != b3:
        raise AssertionError(f"kv: {b3 - rac_value.vec_launches} of {b3} B3 "
                             "launches missed the vector path")
    if b1:
        raise AssertionError(f"kv: B1 launched {b1} times on content "
                             "lookups")
    if hit_tok <= 0 or m.evictions < KV_MIN_EVICTIONS:
        raise AssertionError(f"kv: hit tokens {hit_tok}, evictions "
                             f"{m.evictions} (at least {KV_MIN_EVICTIONS})")
    # B3 at the path's last sampled shape against its plain version
    from repro_torch.kernels import decision, ref
    tsi, tid, tp, tl, valid, alpha, t_now = last[0]
    got = rac_value.rac_value(tsi, tid, tp, tl, alpha, t_now, valid)

    def plain_b3():
        return torch.where(valid, ref.rac_value_ref(tsi, tid, tp, tl.float(),
                                                    alpha, t_now),
                           float("inf"))
    rel, err = value_rel(got, plain_b3())
    if not rel <= VALUE_RTOL:
        raise AssertionError(f"kv: B3 rel err {rel} > {VALUE_RTOL}")
    n, t = tsi.shape[0], tp.shape[0]
    nb, op = bound(n * 13 + t * 8, 5.0 * n)
    n0 = rac_value.launches, rac_value.vec_launches
    row = {"shape": f"kv masked N={n} T={t}", "max_abs_err": err,
           "max_rel_err": rel, "bound_ms": nb, "bound_by": op,
           "floor_ms": eq1_floor_ms(decision.KIND_RAC_I32,
                                    (tsi, tid, valid, tp, tl, t_now), 200),
           **timings(lambda: rac_value.rac_value(tsi, tid, tp, tl, alpha,
                                                 t_now, valid),
                     plain_b3, None, 200)}
    rac_value.launches, rac_value.vec_launches = n0
    return {"rac_value": b3}, row


def first_diff_at(a: list, b: list) -> int:
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# ------------------------------------------------------------ tiers phase
def _tiers_cache(backend: str, device: str, async_admit, tracker=None):
    from repro_torch.cache import CacheConfig, SemanticCache, TierConfig
    return SemanticCache(CacheConfig(
        capacity=TIERS_CAP, dim=DIM, backend=backend, device=device,
        async_admit=async_admit, tracker=tracker,
        tiers=TierConfig(host_capacity=TIERS_HOST,
                         ghost_capacity=TIERS_GHOST)))


def tiers_replay(cache, reqs) -> dict:
    """Request by request through lookup/admit, flushed after each: the
    events (kind, cid, t, tier), the stream's length after each flush,
    the tier counters and the wall."""
    ev: list = []
    for kind in ("hit", "miss", "admit", "evict"):
        cache.subscribe(kind, lambda e, _l=ev: _l.append(
            (e.kind, int(e.cid), int(e.t), e.tier)))
    bounds = []
    t0 = time.perf_counter()
    for r in reqs:
        if not cache.lookup(r.emb, cid=r.cid, t=r.t, req=r).hit:
            cache.admit(r.cid, r.emb, payload=(r.cid,), t=r.t, req=r)
        cache.flush()
        bounds.append(len(ev))
    cache.close()
    return {"events": ev, "bounds": bounds, "stats": cache.tier_stats,
            "hits": cache.metrics.hits, "wall": time.perf_counter() - t0}


def _tiers_host(task):
    """The tiers phase on the host oracle (numpy), in a worker."""
    async_admit, reqs = task
    torch.set_num_threads(1)
    return tiers_replay(_tiers_cache("numpy", "cpu", async_admit), reqs)


def settled(run: dict) -> list:
    """Each request's events with its host-tier hits first: inline
    admission emits such a hit after the promotion it triggers (the
    re-admission and its evictions run inside the lookup), a queued one
    before it; the state at every flush is the same."""
    out, lo = [], 0
    for hi in run["bounds"]:
        g = run["events"][lo:hi]
        out.append([e for e in g if e[0] == "hit" and e[3] == "host"]
                   + [e for e in g if not (e[0] == "hit" and e[3] == "host")])
        lo = hi
    return out


def tiers_workers(pool, trace) -> dict:
    """Start the tiers phase's host-oracle replays in ``pool``: inline
    and queued admission."""
    reqs = trace.requests[:TIERS_LEN]
    return {mode: pool.submit(_tiers_host, (mode, reqs))
            for mode in (False, "sync")}


def phase_tiers(trace, hosts: dict):
    """The tiered, asynchronous RAC facade on the card (B1 per device
    lookup, B3 per eviction, the host tier scanned on the host) over the
    trace's first TIERS_LEN requests: device capacity TIERS_CAP, host
    tier TIERS_HOST, ghost lists TIERS_GHOST.  Cut in depth only from the
    main path (71,000 requests, capacity 65,536), so that demotions,
    promotions, host evictions and ghost revivals all occur.  Held to the
    host oracle (numpy), inline and queued (``hosts``, from
    :func:`tiers_workers`)."""
    from repro_torch.kernels import rac_value, similarity_topk
    from repro_torch.telemetry import InMemoryTracker, render_text, summarize
    reqs = trace.requests[:TIERS_LEN]
    runs = {}
    for mode in ("sync", True):
        trk = InMemoryTracker() if mode == "sync" else None
        similarity_topk.launches = 0
        eq1_reset()
        runs[mode] = tiers_replay(_tiers_cache("kernel", DEVICE, mode,
                                               trk), reqs)
        torch.cuda.synchronize()
        runs[mode]["launches"] = {"sim_top1": similarity_topk.launches,
                                  "rac_value": rac_value.launches}
        if trk is not None:
            report = render_text(summarize(trk), title="tiers (card)")
    inline, queued = hosts[False].result(), hosts["sync"].result()
    for mode, run in runs.items():
        log(f"tiers card async_admit={mode!r}: {TIERS_LEN} requests in "
            f"{run['wall']:.2f}s, hits {run['hits']}, events "
            f"{len(run['events'])}, kernel launches "
            f"{json.dumps(run['launches'])}, tier_stats "
            f"{json.dumps(run['stats'])}")
    log(f"tiers host oracle: inline {inline['wall']:.2f}s, queued "
        f"{queued['wall']:.2f}s, hits {inline['hits']}")
    log(report)
    for mode, run in runs.items():
        if run["events"] != queued["events"]:
            raise AssertionError(f"tiers async_admit={mode!r}: "
                                 + first_diff(run["events"],
                                              queued["events"]))
        if settled(run) != settled(inline):
            j = first_diff_at(settled(run), settled(inline))
            raise AssertionError(f"tiers async_admit={mode!r}: request {j} "
                                 "differs from the inline oracle's")
        if run["stats"] != inline["stats"]:
            raise AssertionError(f"tiers: tier_stats {run['stats']} vs "
                                 f"{inline['stats']}")
        if run["launches"]["sim_top1"] < 1 or run["launches"]["rac_value"] < 1:
            raise AssertionError(f"tiers: kernels never launched: "
                                 f"{run['launches']}")
    st = runs["sync"]["stats"]
    zero = [k for k in ("demotions", "promotions", "host_hits",
                        "host_evictions", "ghost_revivals") if st[k] <= 0]
    if zero:
        raise AssertionError(f"tiers: no {zero}")
    log(f"tiers: {len(inline['events'])} events identical to the host "
        "oracle's (queued: exactly; inline: at every flush)")
    return runs["sync"]["launches"]


def attn_err(out: torch.Tensor, plain: torch.Tensor, label: str,
             mag: torch.Tensor | None = None) -> float:
    """Max |kernel - plain| in fp32, held to the stated tolerance: for bf16
    outputs one bf16 ulp plus the fp32 noise of the weighted sum near zero
    (1e-6; given ``mag``, the same attention over |v|, ATT_SUM_NOISE of
    it: internvl2's activations),
    ATT_F32_TOL for fp32."""
    err = (out.float() - plain.float()).abs()
    if out.dtype == torch.bfloat16:
        noise = 1e-6 if mag is None else ATT_SUM_NOISE * mag.float()
        ok = bool((err <= 2.0 ** -7 * plain.float().abs() + noise).all())
    else:
        ok = bool((err <= ATT_F32_TOL).all())
    if not ok:
        raise AssertionError(f"{label}: max |err| {float(err.max())} "
                             "beyond the tolerance")
    return float(err.max())


def _randn(gen, shape, dtype):
    """Standard normal draws made on the device (the largest B9 inputs are
    5.4 GB of fp32 draws), then cast."""
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def _band_pairs(s: int, window: int) -> int:
    """(query, key) pairs of a causal pass, banded to ``window`` keys."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _b8_row(label: str, dtype, run, plain, library, nbytes: float,
            flops: float, reps: int) -> dict:
    """One B8 shape: the kernel that served it (every bf16 call on the
    wgmma + TMA kernel, fp32 on SIMT), its max |err| against the plain
    version (None where that does not fit), its bound and timings."""
    from repro_torch.kernels import flash_attention
    wgmma = flash_attention.wgmma_launches
    out = run()
    kernel = "wgmma" if flash_attention.wgmma_launches > wgmma else "simt"
    if kernel != ("wgmma" if dtype == torch.bfloat16 else "simt"):
        raise AssertionError(f"flash_attention {label}: served by the "
                             f"{kernel} kernel")
    err = None if plain is None else attn_err(out, plain(), label)
    del out
    nb, op = bound(nbytes, flops,
                   PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
    row = {"shape": label, "kernel": kernel, "max_abs_err": err,
           "bound_ms": nb, "bound_by": op,
           **timings(run, plain, library, reps, 3)}
    log(f"flash_attention {label}: " + json.dumps(row))
    return row


def _sdpa_efficient(q, k, v, mask):
    """SDPA on the memory-efficient backend (an (S, S) mask without the
    math backend's (H, S, S) scores)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def phase_attention():
    """B8 and B9 against their plain versions at the model's shapes, then
    timed beside the library yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention, flash_attention, ref
    gen = torch.Generator(DEVICE).manual_seed(2)
    rng = np.random.default_rng(2)
    b8 = []
    for (b, h, hkv, s, d, dv, win), dtype, reps in FLASH_SHAPES:
        q = _randn(gen, (b, h, s, d), dtype)
        k = _randn(gen, (b, hkv, s, d), dtype)
        v = _randn(gen, (b, hkv, s, dv), dtype)
        label = (f"B={b} H={h} Hkv={hkv} S={s} D={d}"
                 + (f" Dv={dv}" if dv != d else "")
                 + (f" window={win}" if win else "") + f" {str(dtype)[6:]}")
        run = (lambda q=q, k=k, v=v, win=win:
               flash_attention.flash_attention(q, k, v, win))
        fits = s <= PLAIN_MAX_S
        plain = (lambda q=q, k=k, v=v, win=win:
                 ref.attention_ref(q, k, v, window=win)) if fits else None
        # the library yardstick: causal SDPA, or SDPA over the band as a
        # boolean mask built once, outside the timed graph (past
        # PLAIN_MAX_S, 1 GiB at S = 32,768, with K/V repeated to the H
        # query heads outside the timing for the memory-efficient
        # backend: the math backend's (H, S, S) scores do not fit)
        if not win:
            library = (lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True))
        else:
            i = torch.arange(s, device=DEVICE)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                  - win)
            if fits:
                library = (lambda q=q, k=k, v=v, band=band:
                           F.scaled_dot_product_attention(
                               q, k, v, attn_mask=band, enable_gqa=True))
            else:
                kx, vx = (x.repeat_interleave(h // hkv, dim=1)
                          for x in (k, v))
                library = (lambda q=q, kx=kx, vx=vx, band=band:
                           _sdpa_efficient(q, kx, vx, band))
        elt = q.element_size()
        b8.append(_b8_row(
            label, dtype, run, plain, library,
            (b * h * s * (d + dv) + b * hkv * s * (d + dv)) * elt,
            2.0 * b * h * (d + dv) * _band_pairs(s, win), reps))
        del q, k, v, library
    # without the causal mask: every query over all T keys
    for (b, h, hkv, s, t, d), dtype, reps in FLASH_NONCAUSAL_SHAPES:
        q = _randn(gen, (b, h, s, d), dtype)
        k = _randn(gen, (b, hkv, t, d), dtype)
        v = _randn(gen, (b, hkv, t, d), dtype)
        label = (f"B={b} H={h} Hkv={hkv} S={s} T={t} D={d} non-causal "
                 f"{str(dtype)[6:]}")
        elt = q.element_size()
        b8.append(_b8_row(
            label, dtype,
            lambda q=q, k=k, v=v: flash_attention.flash_attention(
                q, k, v, causal=False),
            lambda q=q, k=k, v=v: ref.attention_ref(q, k, v, causal=False),
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=False, enable_gqa=True),
            (2 * b * h * s * d + 2 * b * hkv * t * d) * elt,
            2.0 * b * h * 2 * d * s * t, reps))
        del q, k, v
    torch.cuda.empty_cache()
    b9 = []
    # the cross-attention decode: every row over all its T keys
    for ((b, h, hkv, s, d, dv), dtype, reps), cross in (
            [(x, False) for x in DECODE_SHAPES]
            + [(x, True) for x in CROSS_DECODE_SHAPES]):
        q = _randn(gen, (b, h, d), dtype)
        k = _randn(gen, (b, s, hkv, d), dtype)
        # Dv < D: MLA's V, the first Dv columns of the K rows (a view)
        v = k[..., :dv] if dv != d else _randn(gen, (b, s, hkv, d), dtype)
        scale = MLA_SCALE[d] if dv != d else None
        pos_np = rng.integers(0, s, b).astype(np.int32)
        pos_np[0], pos_np[-1] = 0, s - 1
        if cross:
            pos_np[:] = s - 1
        pos = torch.from_numpy(pos_np).to(DEVICE)
        label = (f"B={b} H={h} Hkv={hkv} S_max={s} D={d}"
                 + (f" Dv={dv} (V a view of K, scale {scale:.6f})"
                    if dv != d else "")
                 + (" cross (pos = S_max - 1)" if cross else "")
                 + f" {str(dtype)[6:]}")
        run = (lambda q=q, k=k, v=v, pos=pos, scale=scale:
               decode_attention.decode_attention(q, k, v, pos, scale))
        plain = (lambda q=q, k=k, v=v, pos=pos, scale=scale:
                 ref.decode_attention_ref(q, k, v, pos, scale))
        # the library yardstick: one SDPA call over views of the same
        # tensors, the G query heads of a KV head as its G query rows
        # (head h = kv * G + g, as B9 maps them) and keys [0, pos[b]]
        # through a boolean mask built once, outside the timed graph
        qg, kt, vt = q.view(b, hkv, h // hkv, d), k.transpose(1, 2), \
            v.transpose(1, 2)
        mask = (torch.arange(s, device=DEVICE)
                <= pos[:, None])[:, None, None, :]
        library = (lambda qg=qg, kt=kt, vt=vt, mask=mask, scale=scale:
                   F.scaled_dot_product_attention(qg, kt, vt,
                                                  attn_mask=mask,
                                                  scale=scale))
        want = plain()
        err = attn_err(run(), want, label)
        # recorded, not held to the kernels' tolerance: the library may
        # round the probabilities to bf16 before the product with V
        lib_err = float((library().reshape(b, h, dv).float()
                         - want.float()).abs().max())
        keys = int(np.minimum(pos_np.astype(np.int64) + 1, s).sum())
        elt = q.element_size()
        row = d if dv != d else 2 * d        # bytes a key reads: K (and V)
        nb, op = bound(keys * hkv * row * elt + b * h * (d + dv) * elt
                       + 4 * b, 2.0 * keys * h * (d + dv),
                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32)
        b9.append({"shape": label + f" sum(pos+1)={keys}",
                   "max_abs_err": err, "library_max_abs_err": lib_err,
                   "bound_ms": nb, "bound_by": op,
                   **timings(run, plain, library, reps,
                             3 if s > 4096 else reps)})
        del want, mask, qg, kt, vt
        log(f"decode_attention {label}: " + json.dumps(b9[-1]))
        del q, k, v
    torch.cuda.empty_cache()
    return b8, b9


@contextlib.contextmanager
def plain_attention():
    """The model's attention on the plain versions (the comparison run)."""
    from repro_torch.kernels import ops, ref
    saved = ops.flash_attention, ops.decode_attention
    ops.flash_attention = ref.attention_ref
    ops.decode_attention = ref.decode_attention_ref
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def model_config():
    """The served LM's config (its smoke variant in CPU rehearsals)."""
    from repro_torch.configs import get_config
    from repro_torch.models import smoke_variant
    cfg = get_config(MODEL_ARCH)
    return smoke_variant(cfg) if SMOKE_MODEL else cfg


def phase_model():
    """The paper's LM at full width in bf16: prefill/forward through B8
    against plain attention, and teacher-forced decode through B9 against
    forward."""
    from repro_torch.kernels import decode_attention, flash_attention
    from repro_torch.models import Model, make_prefill_step
    cfg = model_config()
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    n_par = sum(t.numel() for blk in params["blocks"] for p in blk.values()
                for t in p.values()) + sum(
        t.numel() if torch.is_tensor(t) else t["scale"].numel()
        for t in params["emb"].values())
    log(f"model: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} {cfg.param_dtype}, "
        f"{n_par} parameters, init {time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (PREFILL_B, PREFILL_S))).to(DEVICE)
    batch = {"tokens": tokens}
    prefill = make_prefill_step(model)
    prefill(params, batch)                    # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.wgmma_launches = 0
    t0 = time.perf_counter()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = flash_attention.launches
    if prefill_launches != cfg.n_layers:
        raise AssertionError(f"prefill: B8 launched {prefill_launches} "
                             f"times, not {cfg.n_layers}")
    if (cfg.compute_dtype == "bfloat16"
            and flash_attention.wgmma_launches != cfg.n_layers):
        raise AssertionError(f"prefill: the wgmma kernel launched "
                             f"{flash_attention.wgmma_launches} times, "
                             f"not {cfg.n_layers}")
    flash_attention.launches = 0
    full = model.forward(params, batch)
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("forward: B8 did not launch once per layer")
    with plain_attention():
        want = model.forward(params, batch)
    torch.cuda.synchronize()
    if not torch.equal(last, full[:, -1]):
        raise AssertionError("prefill differs from forward's last row")
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("forward: non-finite logits")
    d_plain = float((full.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    log(f"model prefill: B={PREFILL_B} S={PREFILL_S} "
        f"{PREFILL_B * PREFILL_S / prefill_s:.0f} tokens/s "
        f"({prefill_s * 1e3:.1f} ms), max |logit| {scale:.3f}, "
        f"max |B8 - plain| {d_plain:.5f} (tolerance {LOGIT_TOL})")
    if not d_plain <= LOGIT_TOL:
        raise AssertionError(f"prefill: logits {d_plain} off the plain "
                             "attention model's")
    step_profile(lambda: prefill(params, batch), "prefill", "flash_kernel")

    cache = model.init_cache(PREFILL_B, DECODE_MAX_SEQ)
    decode_attention.launches = 0
    steps = min(MODEL_DECODE_STEPS, PREFILL_S)
    errs = torch.zeros(steps, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(steps):
        logits, cache = model.decode_step(params, cache, {
            "tokens": tokens[:, p:p + 1],
            "pos": torch.full((PREFILL_B,), p, dtype=torch.int32,
                              device=DEVICE)})
        errs[p] = (logits.float() - full[:, p].float()).abs().max()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    if decode_attention.launches != cfg.n_layers * steps:
        raise AssertionError(f"decode: B9 launched "
                             f"{decode_attention.launches} times over "
                             f"{steps} steps of {cfg.n_layers} layers")
    d_dec = float(errs.max())
    log(f"model decode: {steps} teacher-forced steps of B={PREFILL_B} "
        f"in {decode_s:.2f}s ({PREFILL_B * steps / decode_s:.0f} "
        f"tokens/s, {decode_s / steps * 1e3:.2f} ms/step), max "
        f"|decode - forward| {d_dec:.5f} at position "
        f"{int(errs.argmax())} (tolerance {LOGIT_TOL}), mean "
        f"{float(errs.mean()):.5f}")
    if not d_dec <= LOGIT_TOL:
        raise AssertionError(f"decode: logits {d_dec} off forward's")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.full(
            (PREFILL_B,), steps - 1, dtype=torch.int32, device=DEVICE)}))
    del params, cache, full, want
    torch.cuda.empty_cache()
    return prefill_launches


def gemma_config():
    """gemma-7b at full width and depth (in CPU rehearsals its smoke
    variant with the head dim kept at 256)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import smoke_variant
    cfg = get_config(GEMMA_ARCH)
    if SMOKE_MODEL:
        return dataclasses.replace(smoke_variant(cfg), head_dim=cfg.head_dim)
    return cfg


def _attention_f64(q, k, v, causal=True, window=0):
    """Causal GQA attention (banded to ``window`` keys when positive) in
    float64, rounded once to q's dtype: a more exact plain version, to
    measure the bf16 model's own logit noise."""
    b, h, s, d = q.shape
    hkv = k.shape[1]
    qf = q.double().reshape(b, hkv, h // hkv, s, d) / d ** 0.5
    sc = torch.einsum("bkgsd,bktd->bkgst", qf, k.double())
    i = torch.arange(s, device=q.device)
    keep = i[None, :] <= i[:, None]
    if window > 0:
        keep &= i[None, :] > i[:, None] - window
    w = torch.softmax(sc.masked_fill(~keep, float("-inf")), dim=-1)
    return torch.einsum("bkgst,bktd->bkgsd", w, v.double()).reshape(
        b, h, s, v.shape[-1]).to(q.dtype)


def _clone_args(args) -> tuple:
    """Copies of a kernel call's tensors; V stays a view of the copied K
    where it was one of K (MLA's latent rows), as the kernel reads it."""
    from repro_torch.kernels import decode_attention
    out = [a.clone() if torch.is_tensor(a) else a for a in args]
    if args[0].dim() == 3 and decode_attention.v_in_k(args[1], args[2]):
        out[2] = out[1][..., :args[2].shape[-1]]
    return tuple(out)


@contextlib.contextmanager
def attention_as(prefill=None, decode=None, record=None):
    """The model's attention through other functions, or through the
    kernels with each call's inputs recorded in ``record`` as (function,
    args, keyword args)."""
    from repro_torch.kernels import ops
    saved = ops.flash_attention, ops.decode_attention

    def rec(fn):
        def call(*args, **kw):
            record.append((fn, _clone_args(args), dict(kw)))
            return fn(*args, **kw)
        return call
    ops.flash_attention = prefill or (rec(saved[0]) if record is not None
                                      else saved[0])
    ops.decode_attention = decode or (rec(saved[1]) if record is not None
                                      else saved[1])
    try:
        yield
    finally:
        ops.flash_attention, ops.decode_attention = saved


def _teacher_forced(model, params, tokens, steps: int, full,
                    extra: dict | None = None, calls: list | None = None):
    """``steps`` teacher-forced decode steps of ``tokens`` (each batch also
    holding ``extra``) from a fresh cache of ``steps`` positions, timed on
    the host clock, the last step's kernel calls recorded in ``calls``:
    (seconds, max |logits - full| a step, the cache)."""
    cache = model.init_cache(tokens.shape[0], steps)
    errs = torch.zeros(steps, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(steps):
        with attention_as(record=calls if p == steps - 1 else None):
            logits, cache = model.decode_step(params, cache, {
                "tokens": tokens[:, p:p + 1],
                "pos": torch.full((tokens.shape[0],), p, dtype=torch.int32,
                                  device=DEVICE), **(extra or {})})
        errs[p] = (logits.float() - full[:, p].float()).abs().max()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, errs, cache


def phase_gemma() -> dict:
    """gemma-7b (28 layers, d_model 3,072, 16 heads of 256, GeGLU 24,576,
    vocab 256,000, bf16) from seeded random weights on the card.

    In bf16 (its configuration): prefill of B=1 x GEMMA_S tokens through
    B8 (every launch on the wgmma kernel, D = 256) and GEMMA_STEPS
    teacher-forced decode steps through B9; every layer's B8 and B9
    output is held to its plain version on that layer's own inputs within
    the kernels' tolerance (one bf16 ulp).  The bf16 logits' distance
    from the plain-attention model is recorded beside that model's own
    distance from float64 attention: at gemma's logit scale it is ~0.2,
    above LOGIT_TOL, whatever computes the attention.  So the logit gates
    (LOGIT_TOL against plain attention, decode against forward) hold the
    same weights at fp32 compute, where B8 and B9 run in fp32."""
    import dataclasses

    from repro_torch.kernels import (decode_attention, flash_attention,
                                     ref)
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = gemma_config()
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_par = sum(t.numel() for blk in params["blocks"] for p in blk.values()
                for t in p.values()) + sum(
        t.numel() if torch.is_tensor(t) else t["scale"].numel()
        for t in params["emb"].values())
    log(f"gemma: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size} {cfg.param_dtype}, {n_par} parameters, "
        f"init {time.perf_counter() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated()} bytes")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, GEMMA_S))).to(DEVICE)
    batch = {"tokens": tokens}
    prefill_s, n_b8, last = _prefill(model, params, batch, "gemma")
    launches = {"b8": n_b8}
    calls: list = []
    with attention_as(record=calls):
        full = model.forward(params, batch)
    with attention_as(prefill=ref.attention_ref):
        want = model.forward(params, batch)
    with attention_as(prefill=_attention_f64):
        want64 = model.forward(params, batch)
    torch.cuda.synchronize()
    if not torch.equal(last, full[:, -1]):
        raise AssertionError("gemma: prefill differs from forward's last row")
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("gemma forward: non-finite logits")
    layer_err = _check_layers(calls, ref.attention_ref, "gemma B8")
    d_plain, floor = gap(full, want), gap(want, want64)
    log(f"gemma prefill: B=1 S={GEMMA_S} {GEMMA_S / prefill_s:.0f} "
        f"tokens/s ({prefill_s * 1e3:.1f} ms), max |logit| "
        f"{float(want.float().abs().max()):.3f}; {len(calls)} B8 outputs "
        f"within one bf16 ulp of plain on their own inputs (max |err| "
        f"{layer_err:.3g}); bf16 logits: max |B8 - plain| {d_plain:.5f}, "
        f"max |plain - float64 attention| {floor:.5f} (the bf16 model's "
        f"own floor), max |B8 - float64 attention| "
        f"{gap(full, want64):.5f}")
    del want, want64
    step_profile(lambda: model.prefill(params, batch), "gemma prefill",
                 "flash_kernel")

    decode_attention.launches = 0
    calls.clear()
    decode_s, errs, cache = _teacher_forced(model, params, tokens,
                                            GEMMA_STEPS, full, calls=calls)
    launches["b9"] = decode_attention.launches
    if launches["b9"] != cfg.n_layers * GEMMA_STEPS:
        raise AssertionError(f"gemma decode: B9 launched "
                             f"{launches['b9']} times")
    d_dec = float(errs.max())
    dec_err = _check_layers(calls, ref.decode_attention_ref, "gemma B9")
    with attention_as(decode=ref.decode_attention_ref):
        dec_floor = float(_teacher_forced(model, params, tokens,
                                          GEMMA_STEPS, full)[1].max())
    log(f"gemma decode: {GEMMA_STEPS} teacher-forced steps of B=1 in "
        f"{decode_s:.2f}s ({decode_s / GEMMA_STEPS * 1e3:.2f} ms/step); "
        f"{len(calls)} B9 outputs of the last step within one "
        f"bf16 ulp of plain (max |err| {dec_err:.3g}); bf16 logits: max "
        f"|decode - forward| {d_dec:.5f}, with plain decode attention "
        f"{dec_floor:.5f}")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.full(
            (1,), GEMMA_STEPS - 1, dtype=torch.int32, device=DEVICE)}),
        "gemma decode step", "decode_ring_kernel")
    del cache, full

    # the logit gates: the same weights at fp32 compute (B8, B9 in fp32)
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    DEVICE)
    flash_attention.launches = 0
    full32 = model32.forward(params, batch)
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("gemma fp32: B8 did not launch once per layer")
    with attention_as(prefill=ref.attention_ref):
        want32 = model32.forward(params, batch)
    d32 = gap(full32, want32)
    del want32
    dec32 = float(_teacher_forced(model32, params, tokens, GEMMA_STEPS,
                                  full32)[1].max())
    log(f"gemma fp32 compute: max |logit| "
        f"{float(full32.abs().max()):.3f}, max |B8 - plain| {d32:.6f}, "
        f"max |decode - forward| over {GEMMA_STEPS} steps {dec32:.6f} "
        f"(tolerance {LOGIT_TOL})")
    if not (d32 <= LOGIT_TOL and dec32 <= LOGIT_TOL):
        raise AssertionError(f"gemma fp32: logits {d32} / decode {dec32} "
                             "beyond the tolerance")
    del params, full32
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"gemma: phase {wall:.1f}s")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "d_plain_bf16": d_plain, "floor_bf16": floor,
            "d_plain_fp32": d32, "d_decode_fp32": dec32, "seconds": wall}


def _n_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(_n_params(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_params(v) for v in tree)
    return tree.numel()


def family_config(arch: str):
    """``arch`` at full width and depth (its smoke variant in CPU
    rehearsals)."""
    from repro_torch.configs import get_config
    from repro_torch.models import smoke_variant
    cfg = get_config(arch)
    return smoke_variant(cfg) if SMOKE_MODEL else cfg


@contextlib.contextmanager
def moe_recorder(out: list):
    """Each MoE layer's (experts (T,K), kept pairs) appended to ``out`` as
    the model runs."""
    from repro_torch.models import layers
    saved = layers.moe_slots

    def rec(topi, e, cap):
        slots = saved(topi, e, cap)
        out.append((topi, slots[2]))
        return slots
    layers.moe_slots = rec
    try:
        yield
    finally:
        layers.moe_slots = saved


def _drops(routes: list) -> int:
    return int(sum(int((~keep).sum()) for _, keep in routes))


def _check_layers(calls: list, plain, label: str,
                  scaled: bool = False) -> float:
    """Every recorded kernel call's output against its plain version on
    the same inputs, within the kernels' tolerance (``scaled``: the
    near-zero noise as ATT_SUM_NOISE of the plain attention over |v|,
    where _layer_noise measured it); the largest |err|."""
    return max(attn_err(fn(*args, **kw), plain(*args, **kw),
                        f"{label} layer {i}",
                        plain(args[0], args[1], args[2].abs(), *args[3:],
                              **kw) if scaled else None)
               for i, (fn, args, kw) in enumerate(calls))


def _layer_noise(calls: list) -> tuple[float, float, float]:
    """log2 of the largest near-zero noise over the recorded bf16 B8
    calls, each relative to sum_j p_j |v_j| (the plain attention over
    |v|): |kernel - plain| past one bf16 ulp, and |kernel - float64| and
    |plain - float64| past half an ulp (float64 attention the exact
    value): the measurement behind ATT_SUM_NOISE."""
    from repro_torch.kernels import ref
    worst = [0.0, 0.0, 0.0]
    for fn, args, kw in calls:
        out = fn(*args, **kw).double()
        plain = ref.attention_ref(*args, **kw).double()
        mag = ref.attention_ref(args[0], args[1], args[2].abs(),
                                **kw).double()
        exact = _attention_f64(args[0].double(), args[1].double(),
                               args[2].double(), **kw)
        for i, (a, b, ulp) in enumerate(((out, plain, 2.0 ** -7),
                                         (out, exact, 2.0 ** -8),
                                         (plain, exact, 2.0 ** -8))):
            over = ((a - b).abs() - ulp * b.abs()) / mag
            worst[i] = max(worst[i], float(over.max()))
    return tuple(float(np.log2(max(w, 1e-30))) for w in worst)


def _prefill(model, params, batch, label: str, expect: int | None = None):
    """A warm-up prefill, then one timed: (seconds, B8 launches counted in
    the timed run, its last-token logits).  B8 must launch ``expect``
    times (default: once a layer), every bf16 launch on the wgmma
    kernel."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import make_prefill_step
    prefill = make_prefill_step(model)
    prefill(params, batch)                    # warm-up (cuBLAS handles)
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.wgmma_launches = 0
    t0 = time.perf_counter()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    n, wg = flash_attention.launches, flash_attention.wgmma_launches
    want = model.cfg.n_layers if expect is None else expect
    if n != want or (model.cfg.compute_dtype == "bfloat16" and wg != want):
        raise AssertionError(f"{label} prefill: B8 launched {n} times, {wg}"
                             f" on wgmma, not {want}")
    return sec, n, last


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def _serve_family(cfg, params, n: int, b9_layers: int | None = None) -> dict:
    """``n`` requests of launch/serve.py's trace through ServingEngine on
    the card (the kernel backend, B8/B9 and B1-B3), then through the same
    engine on the plain versions (plain attention, the host oracle's
    cache): the hit/miss/admit/evict events, cached flags and token
    counts must be equal, and B9 must launch ``b9_layers`` times a decode
    step (default: once a layer)."""
    from repro_torch.core import SynthConfig, synthetic_trace
    from repro_torch.kernels import decode_attention, ref
    from repro_torch.serving import EngineConfig, ServingEngine
    trace = synthetic_trace(SynthConfig(trace_len=n, n_topics=24, seed=0))
    rng = np.random.default_rng(0)
    reqs = [(r.cid, r.emb, list(rng.integers(2, cfg.vocab_size,
                                             size=int(rng.integers(4, 12)))))
            for r in trace.requests]
    out = {}
    for kind in ("kernel", "plain"):
        engine = ServingEngine(cfg, EngineConfig(
            cache_capacity=8, max_new_tokens=8, device=DEVICE,
            cache_backend="kernel" if kind == "kernel" else "numpy"),
            params=params)
        events = record(engine.cache)
        decode_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "kernel":
            done = engine.run(reqs)
        else:
            with attention_as(prefill=ref.attention_ref,
                              decode=ref.decode_attention_ref):
                done = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[kind] = {**_serve_outcome(engine, events, done), "wall": wall,
                     "b9": decode_attention.launches,
                     "tokens": [tuple(r.out_tokens) for r in done]}
        engine.close()
    got, want = out["kernel"], out["plain"]
    for key in ("stats", "requests", "events"):
        if got[key] != want[key]:
            raise AssertionError(f"{cfg.name} serve: {key} differ from the "
                                 f"plain engine's: "
                                 f"{first_diff(got[key], want[key])}")
    st = got["stats"]
    if st["hits"] == 0 or st["evictions"] == 0:
        raise AssertionError(f"{cfg.name} serve: no hits or no evictions")
    b9_layers = cfg.n_layers if b9_layers is None else b9_layers
    if got["b9"] != st["batches"] * b9_layers:
        raise AssertionError(f"{cfg.name} serve: B9 launched {got['b9']} "
                             f"times over {st['batches']} steps")
    same = sum(a == b for a, b in zip(got["tokens"], want["tokens"]))
    log(f"{cfg.name} serve: {n} requests, {st['batches']} decode steps of "
        f"8 slots in {got['wall']:.2f}s ({got['wall'] / st['batches'] * 1e3:.2f}"
        f" ms/step; plain engine {want['wall'] / st['batches'] * 1e3:.2f} "
        f"ms/step), hits {st['hits']} misses {st['misses']} evictions "
        f"{st['evictions']}: {len(got['events'])} events, cached flags and "
        f"token counts equal to the plain engine's; {same}/{len(reqs)} "
        "requests with equal tokens (bf16 greedy tokens may part)")
    return {"ms_step": got["wall"] / st["batches"] * 1e3, "stats": st,
            "b9": got["b9"]}


def phase_deepseek() -> dict:
    """deepseek-v2-lite-16b (27 layers, d_model 2,048, MLA: 16 heads of 128
    + 64 rope columns over a 512-wide latent; MoE: 64 experts of 1,408, top
    6, 2 shared; vocab 102,400; bf16) from seeded random weights on the
    card.  Prefill of B=1 x DEEPSEEK_S tokens through B8 at Q/K 192, V 128
    (every launch on the wgmma kernel), DEEPSEEK_STEPS teacher-forced
    decode steps through B9 at 576/512 (G = 16, V a view of the latent
    rows); every layer's B8 and B9 output held to its plain version on
    that layer's own inputs.  In bf16 a near-tie in the router flips the
    Top-6 whatever computes the attention, so the logit gates hold the
    same weights at fp32 compute: prefill against plain attention within
    LOGIT_TOL (the routing flips between the two printed), and decode
    against forward at the capacity factor E / k, where no (token, k)
    pair can be dropped (cap = T), within LOGIT_TOL.  Then the serving
    engine over DEEPSEEK_SERVE_LEN requests of launch/serve.py's trace
    makes the plain engine's decisions."""
    import dataclasses

    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(DEEPSEEK_ARCH)
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    log(f"deepseek: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"MLA {cfg.n_heads} heads of {cfg.hd}+{cfg.rope_head_dim} over "
        f"r={cfg.kv_lora_rank}, MoE {cfg.n_experts}x{cfg.expert_d_ff} top "
        f"{cfg.top_k} + {cfg.n_shared_experts} shared, vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}, {_n_params(params)} "
        f"parameters, init {time.perf_counter() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated()} bytes")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, DEEPSEEK_S))).to(DEVICE)
    batch = {"tokens": tokens}
    prefill_s, n_b8, _ = _prefill(model, params, batch, "deepseek")
    launches = {"b8": n_b8}
    calls: list = []
    routes: list = []
    with attention_as(record=calls), moe_recorder(routes):
        full = model.forward(params, batch)
    with attention_as(prefill=ref.attention_ref):
        want = model.forward(params, batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("deepseek forward: non-finite logits")
    b8_err = _check_layers(calls, ref.attention_ref, "deepseek B8")
    if any(args[0].shape[-1] != cfg.hd + cfg.rope_head_dim
           or args[2].shape[-1] != cfg.hd for _, args, _ in calls):
        raise AssertionError("deepseek B8: not at MLA's head dims")
    d_plain = gap(full, want)
    log(f"deepseek prefill: B=1 S={DEEPSEEK_S} {DEEPSEEK_S / prefill_s:.0f} "
        f"tokens/s ({prefill_s * 1e3:.1f} ms), {len(calls)} B8 outputs at "
        f"Q/K {cfg.hd + cfg.rope_head_dim}, V {cfg.hd} within one bf16 ulp "
        f"of plain (max |err| {b8_err:.3g}); MoE drops at capacity factor "
        f"{cfg.capacity_factor}: {_drops(routes)} of "
        f"{sum(k.numel() for _, k in routes)} (token, k) pairs; bf16 "
        f"logits: max |logit| {float(want.float().abs().max()):.3f}, max "
        f"|B8 - plain| {d_plain:.5f}")
    del want
    step_profile(lambda: model.prefill(params, batch), "deepseek prefill",
                 "flash_kernel")

    # bf16 decode through B9 at 576/512
    calls.clear()
    decode_attention.launches = 0
    decode_s, errs, cache = _teacher_forced(model, params, tokens,
                                            DEEPSEEK_STEPS, full, calls=calls)
    launches["b9"] = decode_attention.launches
    if launches["b9"] != cfg.n_layers * DEEPSEEK_STEPS:
        raise AssertionError(f"deepseek decode: B9 launched "
                             f"{launches['b9']} times")
    from repro_torch.kernels.decode_attention import v_in_k
    if any(args[0].shape[-1] != cfg.kv_lora_rank + cfg.rope_head_dim
           or not v_in_k(args[1], args[2]) for _, args, _ in calls):
        raise AssertionError("deepseek B9: not the absorbed 576/512 path "
                             "with V a view of the latent rows")
    b9_err = _check_layers(calls, ref.decode_attention_ref, "deepseek B9")
    log(f"deepseek decode: {DEEPSEEK_STEPS} teacher-forced steps of B=1 in "
        f"{decode_s:.2f}s ({decode_s / DEEPSEEK_STEPS * 1e3:.2f} ms/step); "
        f"{len(calls)} B9 outputs of the last step (D "
        f"{cfg.kv_lora_rank + cfg.rope_head_dim}, Dv {cfg.kv_lora_rank}, G "
        f"{cfg.n_heads}) within one bf16 ulp of plain (max |err| "
        f"{b9_err:.3g}); bf16 max |decode - forward| {float(errs.max()):.5f}"
        " (decode drops other pairs than forward)")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.full(
            (1,), DEEPSEEK_STEPS - 1, dtype=torch.int32, device=DEVICE)}),
        "deepseek decode step", "decode_ring_kernel")
    del cache, full

    # the logit gates at fp32 compute
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = Model(cfg32, DEVICE)
    r_kernel: list = []
    r_plain: list = []
    flash_attention.launches = 0
    with moe_recorder(r_kernel):
        full32 = model32.forward(params, batch)
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("deepseek fp32: B8 did not launch once a layer")
    with attention_as(prefill=ref.attention_ref), moe_recorder(r_plain):
        want32 = model32.forward(params, batch)
    flips = int(sum(int((a != b).any(-1).sum())
                    for (a, _), (b, _) in zip(r_kernel, r_plain)))
    d32 = gap(full32, want32)
    del full32, want32
    nodrop = dataclasses.replace(
        cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    model_nd = Model(nodrop, DEVICE)
    r_fwd: list = []
    r_dec: list = []
    with moe_recorder(r_fwd):
        full_nd = model_nd.forward(params, batch)
    with moe_recorder(r_dec):
        dec32 = float(_teacher_forced(model_nd, params, tokens,
                                      DEEPSEEK_STEPS, full_nd)[1].max())
    log(f"deepseek fp32 compute: max |B8 - plain| {d32:.6f} ({flips} of "
        f"{DEEPSEEK_S * cfg.n_layers} token-layer routings differ between "
        f"the two); at capacity factor {nodrop.capacity_factor:.4f} (drops: "
        f"forward {_drops(r_fwd)}, decode {_drops(r_dec)}) max |decode - "
        f"forward| over {DEEPSEEK_STEPS} steps {dec32:.6f} (tolerance "
        f"{LOGIT_TOL})")
    if not (d32 <= LOGIT_TOL and dec32 <= LOGIT_TOL):
        raise AssertionError(f"deepseek fp32: logits {d32} / decode {dec32}"
                             " beyond the tolerance")
    del full_nd
    serve = _serve_family(cfg, params, DEEPSEEK_SERVE_LEN)
    del params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"deepseek: phase {wall:.1f}s")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "prefill_tok_s": DEEPSEEK_S / prefill_s,
            "decode_ms": decode_s / DEEPSEEK_STEPS * 1e3,
            "serve_ms_step": serve["ms_step"], "d_plain_bf16": d_plain,
            "d_plain_fp32": d32, "d_decode_fp32": dec32, "flips": flips,
            "seconds": wall}


def _hymba_tokens(cfg) -> torch.Tensor:
    """The (1, HYMBA_S) tokens every hymba check feeds (seed 0)."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, HYMBA_S))).to(DEVICE)


def phase_hymba(fp32: dict) -> dict:
    """hymba-1.5b (32 layers, d_model 1,600, 25/5 heads of 64 over a
    sliding window of 2,048 beside Mamba heads of d_inner 3,200 and state
    16, SwiGLU 5,504, vocab 32,001; bf16) from seeded random weights on
    the card.  Prefill of B=1 x HYMBA_S tokens through the windowed B8
    (every launch on the wgmma kernel; the band of 2,048 active), every
    layer's output held to its plain version on its own inputs;
    HYMBA_BF16_STEPS bf16 decode steps time the deployment dtype's step.
    ``fp32`` is the record of the gates at fp32 compute (_hymba_fp32, run
    in a child process beside phases 4-6: child_phase(HYMBA_CHILD)), whose
    lines were printed when it was joined."""
    from repro_torch.kernels import decode_attention, ref
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(HYMBA_ARCH)
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    log(f"hymba: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} window "
        f"{cfg.sliding_window}, Mamba d_inner {cfg.ssm_expand * cfg.d_model}"
        f" state {cfg.ssm_state}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
        f"{cfg.param_dtype}, {_n_params(params)} parameters, init "
        f"{time.perf_counter() - t0:.2f}s")
    tokens = _hymba_tokens(cfg)
    batch = {"tokens": tokens}
    prefill_s, n_b8, _ = _prefill(model, params, batch, "hymba")
    launches = {"b8": n_b8}
    calls: list = []
    with attention_as(record=calls):
        full = model.forward(params, batch)
    with attention_as(prefill=ref.attention_ref):
        want = model.forward(params, batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("hymba forward: non-finite logits")
    if any(kw.get("window") != cfg.sliding_window for _, _, kw in calls):
        raise AssertionError("hymba B8: not windowed")
    b8_err = _check_layers(calls, ref.attention_ref, "hymba B8")
    d_plain = gap(full, want)
    log(f"hymba prefill: B=1 S={HYMBA_S} {HYMBA_S / prefill_s:.0f} tokens/s"
        f" ({prefill_s * 1e3:.1f} ms), {len(calls)} windowed B8 outputs "
        f"within one bf16 ulp of plain (max |err| {b8_err:.3g}); bf16 "
        f"logits: max |logit| {float(want.float().abs().max()):.3f}, max "
        f"|B8 - plain| {d_plain:.5f}")
    del full, want, calls
    step_profile(lambda: model.prefill(params, batch), "hymba prefill",
                 "flash_kernel")

    # bf16 decode steps: the deployment dtype's ms per step
    cache = model.init_cache(1, HYMBA_DECODE)
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for p in range(HYMBA_BF16_STEPS):
        model.decode_step(params, cache, {
            "tokens": tokens[:, p:p + 1],
            "pos": torch.full((1,), p, dtype=torch.int32, device=DEVICE)})
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches["b9"] = decode_attention.launches
    if launches["b9"] != cfg.n_layers * HYMBA_BF16_STEPS:
        raise AssertionError(f"hymba bf16 decode: B9 launched "
                             f"{launches['b9']} times")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.full(
            (1,), HYMBA_BF16_STEPS - 1, dtype=torch.int32, device=DEVICE)}),
        "hymba decode step", "decode_ring_kernel")
    log(f"hymba bf16 decode: {decode_s / HYMBA_BF16_STEPS * 1e3:.2f} ms/step"
        f" over {HYMBA_BF16_STEPS} steps ({launches['b9']} B9 launches)")
    del params, cache
    torch.cuda.empty_cache()
    launches["b9_fp32"] = fp32["b9_fp32"]
    wall = time.perf_counter() - t_phase
    log(f"hymba: phase {wall:.1f}s (the fp32 gates' child "
        f"{fp32['seconds']:.1f}s, beside phases 4-6)")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "prefill_tok_s": HYMBA_S / prefill_s,
            "decode_ms": decode_s / HYMBA_BF16_STEPS * 1e3,
            "decode32_ms": fp32["decode32_ms"],
            "d_plain_bf16": d_plain, "d_plain_fp32": fp32["d_plain_fp32"],
            "d_decode_fp32": fp32["d_decode_fp32"], "seconds": wall}


def _hymba_fp32() -> dict:
    """hymba-1.5b's gates at fp32 compute (B8 and B9 in fp32), on the
    weights and tokens phase_hymba draws: prefill against plain attention
    within LOGIT_TOL, and HYMBA_DECODE teacher-forced decode steps through
    the ring of 2,048 slots (B9 over slots [0, min(pos, 2,047)]; the ring
    wraps at 2,048), B9 once a layer and step, the last step's B9 outputs
    held to plain, the last 64 positions' logits within LOGIT_TOL of
    forward's.  The steps are host-bound (~50 ms each, the card ~7% busy),
    so this runs in a child process beside phases 4-6, which time no
    kernel (child_phase); its ms a step is taken there."""
    import dataclasses

    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(HYMBA_ARCH)
    params = Model(cfg, DEVICE).init(torch.Generator(DEVICE).manual_seed(0))
    tokens = _hymba_tokens(cfg)
    batch = {"tokens": tokens}
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    DEVICE)
    flash_attention.launches = 0
    full32 = model32.forward(params, batch)
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("hymba fp32: B8 did not launch once a layer")
    with attention_as(prefill=ref.attention_ref):
        d32 = gap(full32, model32.forward(params, batch))
    calls: list = []
    decode_attention.launches = 0
    decode32_s, errs, cache = _teacher_forced(model32, params, tokens,
                                              HYMBA_DECODE, full32,
                                              calls=calls)
    ring = cache["kv"]["k"].shape[2]
    n_b9 = decode_attention.launches
    if n_b9 != cfg.n_layers * HYMBA_DECODE:
        raise AssertionError(f"hymba fp32 decode: B9 launched {n_b9} times")
    b9_err = _check_layers(calls, ref.decode_attention_ref, "hymba B9")
    last = float(errs[-64:].max())
    log(f"hymba fp32 compute: max |B8 - plain| {d32:.6f}; "
        f"{HYMBA_DECODE} teacher-forced steps through a ring of {ring} "
        f"slots in {decode32_s:.2f}s ({decode32_s / HYMBA_DECODE * 1e3:.2f}"
        f" ms/step, in a child process beside phases 4-6), {len(calls)} B9 "
        f"outputs of the last step within {ATT_F32_TOL} of plain (max |err| "
        f"{b9_err:.3g}); max |decode - forward| over the last 64 positions "
        f"{last:.6f}, over all {float(errs.max()):.6f} (tolerance "
        f"{LOGIT_TOL}); {n_b9} B9 launches")
    if not (d32 <= LOGIT_TOL and last <= LOGIT_TOL):
        raise AssertionError(f"hymba fp32: logits {d32} / decode {last} "
                             "beyond the tolerance")
    return {"b9_fp32": n_b9, "d_plain_fp32": d32, "d_decode_fp32": last,
            "decode32_ms": decode32_s / HYMBA_DECODE * 1e3,
            "seconds": time.perf_counter() - t_phase}


@contextlib.contextmanager
def child_phase(flag: str, **env):
    """Runs the phase ``flag`` names in a child process (``chip_smoke.py
    FLAG OUT.json``, its lines to a file, ``env`` added to its
    environment) and yields a function that waits for it, prints its lines
    and returns its record; a child still running when the block exits is
    killed."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_child")
    out, lines = os.path.join(tmp, "out.json"), os.path.join(tmp, "log")
    with open(lines, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 flag, out], cwd=ROOT, stdout=f,
                                env={**os.environ, **env})

    def result() -> dict:
        rc = proc.wait()
        with open(lines) as f:
            sys.stdout.write(f.read())
        sys.stdout.flush()
        if rc:
            raise AssertionError(f"chip_smoke.py {flag}: the child exited "
                                 f"{rc}")
        with open(out) as f:
            return json.load(f)
    try:
        yield result
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_whisper() -> dict:
    """whisper-medium (24 encoder and 24 decoder layers, d_model 1,024, 16
    heads of 64, GELU 4,096, vocab 51,865; bf16) from seeded random
    weights on the card.  Prefill of B=1: cfg.n_frontend_tokens (1,500)
    seeded frame embeddings through the encoder (B8 non-causal, S = T =
    1,500) and WHISPER_S text tokens through the decoder (B8 causal, then
    cross attention: B8 non-causal, S rows over the frames): 3 x 24
    launches, all on the wgmma kernel, every output held to its plain
    version on its own inputs.  WHISPER_STEPS teacher-forced decode steps
    with the encoder's output (B9 twice a layer: self over the cache,
    cross over every frame).  At fp32 compute, prefill against plain
    attention and decode against forward within LOGIT_TOL.  Then the
    serving engine over FAMILY_SERVE_LEN requests against the plain
    engine: the decoder alone, as the reference's engine serves whisper
    (it passes no encoder output)."""
    import dataclasses

    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(WHISPER_ARCH)
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    frames = cfg.n_frontend_tokens
    log(f"whisper: {cfg.name} {cfg.n_enc_layers} encoder + {cfg.n_layers} "
        f"decoder layers d_model {cfg.d_model} heads {cfg.n_heads}x{cfg.hd}"
        f" d_ff {cfg.d_ff} vocab {cfg.vocab_size} {cfg.param_dtype}, "
        f"{_n_params(params)} parameters, init "
        f"{time.perf_counter() - t0:.2f}s; {frames} frames, {WHISPER_S} "
        "text tokens")
    audio = torch.randn((1, frames, cfg.d_model), device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(1))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, WHISPER_S))).to(DEVICE)
    batch = {"tokens": tokens, "audio_embeds": audio}
    n8 = cfg.n_enc_layers + 2 * cfg.n_layers
    prefill_s, n_b8, _ = _prefill(model, params, batch, "whisper", n8)
    launches = {"b8": n_b8}
    calls: list = []
    with attention_as(record=calls):
        full = model.forward(params, batch)
    with attention_as(prefill=ref.attention_ref):
        want = model.forward(params, batch)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("whisper forward: non-finite logits")
    # (causal, query rows, key rows) of each launch: the encoder's, the
    # decoder's own and the cross attention's, one of each a layer
    kinds = [(kw.get("causal", True), args[0].shape[2], args[1].shape[2])
             for _, args, kw in calls]
    want_kinds = {(False, frames, frames): cfg.n_enc_layers,
                  (True, WHISPER_S, WHISPER_S): cfg.n_layers,
                  (False, WHISPER_S, frames): cfg.n_layers}
    if {k: kinds.count(k) for k in set(kinds)} != want_kinds:
        raise AssertionError(f"whisper B8: launches {kinds}")
    b8_err = _check_layers(calls, ref.attention_ref, "whisper B8")
    d_plain = gap(full, want)
    log(f"whisper prefill: {frames} frames + {WHISPER_S} tokens in "
        f"{prefill_s * 1e3:.1f} ms ({(frames + WHISPER_S) / prefill_s:.0f} "
        f"positions/s), {len(calls)} B8 outputs (non-causal {frames}x"
        f"{frames}, causal {WHISPER_S}, cross {WHISPER_S}x{frames}) within "
        f"one bf16 ulp of plain (max |err| {b8_err:.3g}); bf16 logits: max "
        f"|logit| {float(want.float().abs().max()):.3f}, max |B8 - plain| "
        f"{d_plain:.5f}")
    del want
    calls.clear()
    step_profile(lambda: model.prefill(params, batch), "whisper prefill",
                 "flash_kernel")

    # bf16 decode with the encoder's output: B9 self and cross
    enc_out = model._encode(params, audio)
    decode_attention.launches = 0
    decode_s, errs, cache = _teacher_forced(
        model, params, tokens, WHISPER_STEPS, full, {"enc_out": enc_out},
        calls)
    launches["b9"] = decode_attention.launches
    if launches["b9"] != 2 * cfg.n_layers * WHISPER_STEPS:
        raise AssertionError(f"whisper decode: B9 launched "
                             f"{launches['b9']} times")
    if sum(args[1].shape[1] == frames for _, args, _ in calls) \
            != cfg.n_layers:
        raise AssertionError("whisper B9: not one cross call a layer")
    b9_err = _check_layers(calls, ref.decode_attention_ref, "whisper B9")
    d_dec = float(errs.max())
    log(f"whisper decode: {WHISPER_STEPS} teacher-forced steps of B=1 in "
        f"{decode_s:.2f}s ({decode_s / WHISPER_STEPS * 1e3:.2f} ms/step); "
        f"{len(calls)} B9 outputs of the last step (self, and cross over "
        f"{frames} frames) within one bf16 ulp of plain (max |err| "
        f"{b9_err:.3g}); bf16 max |decode - forward| {d_dec:.5f}")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "enc_out": enc_out, "pos": torch.full(
            (1,), WHISPER_STEPS - 1, dtype=torch.int32, device=DEVICE)}),
        "whisper decode step", "decode_ring_kernel")
    del cache, full, enc_out, calls

    # the logit gates at fp32 compute
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    DEVICE)
    flash_attention.launches = 0
    full32 = model32.forward(params, batch)
    if flash_attention.launches != n8:
        raise AssertionError("whisper fp32: B8 did not launch 3 times a "
                             "layer")
    with attention_as(prefill=ref.attention_ref):
        d32 = gap(full32, model32.forward(params, batch))
    dec32 = float(_teacher_forced(
        model32, params, tokens, WHISPER_STEPS, full32,
        {"enc_out": model32._encode(params, audio)})[1].max())
    log(f"whisper fp32 compute: max |logit| {float(full32.abs().max()):.3f}"
        f", max |B8 - plain| {d32:.6f}, max |decode - forward| over "
        f"{WHISPER_STEPS} steps {dec32:.6f} (tolerance {LOGIT_TOL}, bf16's "
        "too)")
    if not max(d32, dec32, d_plain, d_dec) <= LOGIT_TOL:
        raise AssertionError(f"whisper: logits {d32} / decode {dec32} "
                             f"(bf16: {d_plain} / {d_dec}) beyond the "
                             "tolerance")
    del full32
    serve = _serve_family(cfg, params, FAMILY_SERVE_LEN)
    del params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"whisper: phase {wall:.1f}s")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_s / WHISPER_STEPS * 1e3,
            "serve_ms_step": serve["ms_step"], "serve_b9": serve["b9"],
            "d_plain_bf16": d_plain, "d_decode_bf16": d_dec,
            "d_plain_fp32": d32, "d_decode_fp32": dec32, "seconds": wall}


def phase_xlstm() -> dict:
    """xlstm-125m (12 layers, d_model 768, 4 heads, mLSTM of d_inner
    1,536, sLSTM at layers 5 and 7, no MLP, vocab 50,304; bf16) from
    seeded random weights on the card.  No kernel of the port is on its
    model path: the cells are plain PyTorch, as the reference's are XLA.
    Prefill of B=1 x XLSTM_S tokens (the cells' token loops), XLSTM_STEPS
    teacher-forced decode steps against forward in bf16 and at fp32
    compute (within LOGIT_TOL), a profiled prefill of XLSTM_PROFILE_S
    tokens and a profiled decode step, then the serving engine over
    FAMILY_SERVE_LEN requests against the plain engine (B1-B3 only)."""
    import dataclasses

    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(XLSTM_ARCH)
    if not cfg.slstm_at:       # the smoke variant keeps none: give it one
        cfg = dataclasses.replace(cfg, slstm_at=(1,))
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    log(f"xlstm: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}, mLSTM d_inner {cfg.xlstm_expand * cfg.d_model}"
        f", sLSTM at {tuple(cfg.slstm_at)}, vocab {cfg.vocab_size} "
        f"{cfg.param_dtype}, {_n_params(params)} parameters, init "
        f"{time.perf_counter() - t0:.2f}s")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(
        2, cfg.vocab_size, (1, XLSTM_S))).to(DEVICE)
    batch = {"tokens": tokens}
    prefill_s, _, _ = _prefill(model, params, batch, "xlstm", 0)
    full = model.forward(params, batch)
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("xlstm forward: non-finite logits")
    decode_s, errs, cache = _teacher_forced(model, params, tokens,
                                            XLSTM_STEPS, full)
    d_dec = float(errs.max())
    log(f"xlstm prefill: B=1 S={XLSTM_S} {XLSTM_S / prefill_s:.0f} tokens/s"
        f" ({prefill_s * 1e3:.1f} ms); decode: {XLSTM_STEPS} teacher-forced"
        f" steps in {decode_s:.2f}s ({decode_s / XLSTM_STEPS * 1e3:.2f} "
        f"ms/step); bf16 max |logit| {float(full.float().abs().max()):.3f},"
        f" max |decode - forward| {d_dec:.5f}")
    short = {"tokens": tokens[:, :XLSTM_PROFILE_S]}
    step_profile(lambda: model.prefill(params, short),
                 f"xlstm prefill of {XLSTM_PROFILE_S} tokens")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.zeros(
            (1,), dtype=torch.int32, device=DEVICE)}), "xlstm decode step")
    del cache, full
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    DEVICE)
    full32 = model32.forward(params, batch)
    dec32 = float(_teacher_forced(model32, params, tokens, XLSTM_STEPS,
                                  full32)[1].max())
    log(f"xlstm fp32 compute: max |logit| {float(full32.abs().max()):.3f}, "
        f"max |decode - forward| over {XLSTM_STEPS} steps {dec32:.6f} "
        f"(tolerance {LOGIT_TOL}, bf16's too)")
    if not max(dec32, d_dec) <= LOGIT_TOL:
        raise AssertionError(f"xlstm: decode {dec32} (bf16: {d_dec}) beyond "
                             "the tolerance")
    del full32
    serve = _serve_family(cfg, params, FAMILY_SERVE_LEN, b9_layers=0)
    del params
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"xlstm: phase {wall:.1f}s")
    return {"prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_s / XLSTM_STEPS * 1e3,
            "serve_ms_step": serve["ms_step"], "d_decode_bf16": d_dec,
            "d_decode_fp32": dec32, "seconds": wall}


def phase_internvl() -> dict:
    """internvl2-26b (48 layers, d_model 6,144, 48/8 heads of 128, SwiGLU
    16,384, vocab 92,553; bf16, 39.7 GB of weights) from seeded random
    weights on the card.  Prefill of B=1: cfg.n_frontend_tokens (256)
    seeded image rows (normal draws at the token table's scale, 0.02) in
    place of the first token embeddings, then INTERNVL_TEXT text tokens
    (48 B8 launches on the wgmma kernel at G = 6, each held to its plain
    version); INTERNVL_STEPS teacher-forced decode steps (B9) against the
    text-only forward (no image rows: decode reads tokens).  At fp32
    compute both within LOGIT_TOL."""
    import dataclasses

    from repro_torch.kernels import decode_attention, flash_attention, ref
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    cfg = family_config(INTERNVL_ARCH)
    model = Model(cfg, DEVICE)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_img = cfg.n_frontend_tokens
    log(f"internvl: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size} {cfg.param_dtype}, {_n_params(params)} "
        f"parameters, init {time.perf_counter() - t0:.2f}s, device memory "
        f"{torch.cuda.memory_allocated()} bytes")
    image = 0.02 * torch.randn((1, n_img, cfg.d_model), device=DEVICE,
                               generator=torch.Generator(
                                   DEVICE).manual_seed(1))
    rng = np.random.default_rng(0)
    s = n_img + INTERNVL_TEXT
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size,
                                           (1, s))).to(DEVICE)
    batch = {"tokens": tokens, "image_embeds": image}
    text = {"tokens": tokens, "image_embeds": image[:, :0]}
    prefill_s, n_b8, _ = _prefill(model, params, batch, "internvl")
    launches = {"b8": n_b8}
    # forward records a graph only where a parameter requires grad: its
    # peak memory in grad mode equals the peak under no_grad (the serving
    # forward before training could record one)
    peaks = []
    for grad_mode in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.set_grad_enabled(grad_mode):
            out = model.forward(params, batch)
        del out
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    log(f"internvl forward peak memory: {peaks[0]} bytes under no_grad, "
        f"{peaks[1]} bytes in grad mode (parameters need no grad)")
    if peaks[1] > peaks[0]:
        raise AssertionError("internvl forward: grad mode raised the peak "
                             f"memory from {peaks[0]} to {peaks[1]} bytes")
    calls: list = []
    with attention_as(record=calls):
        full = model.forward(params, batch)
    with attention_as(prefill=ref.attention_ref):
        want = model.forward(params, batch)
    with attention_as(prefill=_attention_f64):
        floor = gap(want, model.forward(params, batch))
    torch.cuda.synchronize()
    if not bool(torch.isfinite(full).all()):
        raise AssertionError("internvl forward: non-finite logits")
    b8_err = _check_layers(calls, ref.attention_ref, "internvl B8",
                           scaled=True)
    noise = _layer_noise(calls)
    d_plain = gap(full, want)
    log(f"internvl prefill: B=1 {n_img} image rows + {INTERNVL_TEXT} tokens"
        f" {s / prefill_s:.0f} positions/s ({prefill_s * 1e3:.1f} ms), "
        f"{len(calls)} B8 outputs within one bf16 ulp of plain (max |err| "
        f"{b8_err:.3g}; near-zero noise over sum p|v|, log2: kernel - plain "
        f"{noise[0]:.2f}, kernel - float64 {noise[1]:.2f}, plain - float64 "
        f"{noise[2]:.2f}; allowed {np.log2(ATT_SUM_NOISE):.0f}); bf16 "
        "logits: max |logit| "
        f"{float(want.float().abs().max()):.3f}, max |B8 - plain| "
        f"{d_plain:.5f}, max |plain - float64 attention| {floor:.5f} (the "
        "bf16 model's own floor)")
    del full, want
    calls.clear()
    step_profile(lambda: model.prefill(params, batch), "internvl prefill",
                 "flash_kernel")
    full_text = model.forward(params, text)
    decode_attention.launches = 0
    decode_s, errs, cache = _teacher_forced(model, params, tokens,
                                            INTERNVL_STEPS, full_text,
                                            calls=calls)
    launches["b9"] = decode_attention.launches
    if launches["b9"] != cfg.n_layers * INTERNVL_STEPS:
        raise AssertionError(f"internvl decode: B9 launched "
                             f"{launches['b9']} times")
    b9_err = _check_layers(calls, ref.decode_attention_ref, "internvl B9")
    d_dec = float(errs.max())
    log(f"internvl decode: {INTERNVL_STEPS} teacher-forced steps of B=1 in "
        f"{decode_s:.2f}s ({decode_s / INTERNVL_STEPS * 1e3:.2f} ms/step); "
        f"{len(calls)} B9 outputs of the last step within one bf16 ulp of "
        f"plain (max |err| {b9_err:.3g}); bf16 max |decode - text-only "
        f"forward| {d_dec:.5f}")
    step_profile(lambda: model.decode_step(params, cache, {
        "tokens": tokens[:, :1], "pos": torch.full(
            (1,), INTERNVL_STEPS - 1, dtype=torch.int32, device=DEVICE)}),
        "internvl decode step", "decode_ring_kernel")
    del cache, full_text, calls
    model32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                    DEVICE)
    flash_attention.launches = 0
    full32 = model32.forward(params, batch)
    if flash_attention.launches != cfg.n_layers:
        raise AssertionError("internvl fp32: B8 did not launch once a layer")
    with attention_as(prefill=ref.attention_ref):
        d32 = gap(full32, model32.forward(params, batch))
    del full32
    text32 = model32.forward(params, text)
    dec32 = float(_teacher_forced(model32, params, tokens, INTERNVL_STEPS,
                                  text32)[1].max())
    log(f"internvl fp32 compute: max |B8 - plain| {d32:.6f}, max |decode - "
        f"text-only forward| over {INTERNVL_STEPS} steps {dec32:.6f} "
        f"(tolerance {LOGIT_TOL})")
    if not (d32 <= LOGIT_TOL and dec32 <= LOGIT_TOL):
        raise AssertionError(f"internvl fp32: logits {d32} / decode {dec32}"
                             " beyond the tolerance")
    del params, text32
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"internvl: phase {wall:.1f}s")
    return {"launches": launches, "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_s / INTERNVL_STEPS * 1e3,
            "peak_bytes_no_grad": peaks[0], "peak_bytes_grad": peaks[1],
            "d_plain_bf16": d_plain, "floor_bf16": floor,
            "d_decode_bf16": d_dec, "d_plain_fp32": d32,
            "d_decode_fp32": dec32, "seconds": wall}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    b = b.float()
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def phase_train() -> dict:
    """_phase_train in a child process of its own, the only one that sets
    CUBLAS_WORKSPACE_CONFIG (the fixed cuBLAS workspace that
    torch.use_deterministic_algorithms wants from a process's first
    product on), so the other phases' products run as they did; it
    returns _phase_train's record."""
    torch.cuda.empty_cache()
    with child_phase(TRAIN_CHILD,
                     CUBLAS_WORKSPACE_CONFIG=":4096:8") as result:
        return result()


def _phase_train() -> dict:
    """Training through launch/train.py's code path on smollm-360m (32
    layers, d_model 960, 15/5 heads of 64, vocab 49,152; bf16; remat over
    every block), its B8 forward launched again in each block's
    recompute, the gradient the plain attention's.  (1) At full width
    with TRAIN_CHECK_LAYERS layers in fp32 (B8's SIMT kernel): one step's
    loss and gradients against the same step on plain attention, within
    TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL.  (2) Full depth, bf16, batch
    TRAIN_B x TRAIN_S: TRAIN_STEPS steps checkpointed every
    TRAIN_CKPT_EVERY, then a restart from a directory that holds only that
    step (a crash after its commit): its losses bit-equal to the
    uninterrupted run's under torch.use_deterministic_algorithms; the loss
    falls; every B8 launch on wgmma.  (3) A step split into forward,
    backward and optimizer by CUDA events, profiled once, and the plain
    attention backward timed at the training shape."""
    import dataclasses
    import shutil
    import statistics
    import tempfile

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention, ref
    from repro_torch.launch import train
    from repro_torch.models import (Model, make_loss_fn, make_train_step,
                                    value_and_grad)
    from repro_torch.optim import AdamWConfig, adamw_update
    from repro_torch.tree import tree_leaves, tree_unflatten
    t_phase = time.perf_counter()
    cfg = family_config(TRAIN_ARCH)
    per_step = cfg.n_layers * (2 if cfg.remat else 1)
    data = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=TRAIN_S, global_batch=TRAIN_B))

    def on_card(batch):
        return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}

    # (1) gradients on B8 against the plain path, fp32
    cfg32 = dataclasses.replace(cfg, n_layers=TRAIN_CHECK_LAYERS,
                                param_dtype="float32",
                                compute_dtype="float32")
    model32 = Model(cfg32, DEVICE)
    params32 = model32.init(torch.Generator(DEVICE).manual_seed(0))
    grad_fn = value_and_grad(make_loss_fn(model32))
    batch = on_card(data.batch_at(0))
    flash_attention.launches = flash_attention.wgmma_launches = 0
    loss_k, g_k = grad_fn(params32, batch)
    if flash_attention.launches != cfg32.n_layers * (2 if cfg.remat else 1) \
            or flash_attention.wgmma_launches:
        raise AssertionError(f"train fp32: {flash_attention.launches} B8 "
                             f"launches ({flash_attention.wgmma_launches} "
                             "on wgmma)")
    with attention_as(prefill=ref.attention_ref):
        loss_p, g_p = grad_fn(params32, batch)
    d_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    rel = [_rel_l2(a, b) for a, b in zip(tree_leaves(g_k),
                                         tree_leaves(g_p))]
    log(f"train fp32 check: {cfg.name} at full width, {cfg32.n_layers} "
        f"layers, B={TRAIN_B} S={TRAIN_S}: loss {float(loss_k):.6f} on B8 "
        f"against {float(loss_p):.6f} on plain attention (relative "
        f"{d_loss:.3g}, tolerance {TRAIN_LOSS_RTOL}); {len(rel)} gradient "
        f"leaves, max relative L2 {max(rel):.3g} (tolerance "
        f"{TRAIN_GRAD_RTOL})")
    if not (d_loss <= TRAIN_LOSS_RTOL and max(rel) <= TRAIN_GRAD_RTOL):
        raise AssertionError(f"train fp32: loss {d_loss} / gradients "
                             f"{max(rel)} beyond the tolerance")
    del model32, params32, g_k, g_p, grad_fn
    torch.cuda.empty_cache()

    # (2) the full run and a restart, through launch/train.py
    base = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_B), "--seq", str(TRAIN_S), "--log-every", "5",
            "--device", DEVICE] + (["--smoke"] if SMOKE_MODEL else [])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        flash_attention.launches = flash_attention.wgmma_launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        full = train.run(train.parse_args(base + [
            "--ckpt-dir", os.path.join(tmp, "a"),
            "--ckpt-every", str(TRAIN_CKPT_EVERY)]))
        full_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        n_b8, n_wgmma = (flash_attention.launches,
                         flash_attention.wgmma_launches)
        name = f"step_{TRAIN_CKPT_EVERY:08d}"
        os.makedirs(os.path.join(tmp, "b", name))
        for f in os.listdir(os.path.join(tmp, "a", name)):
            os.link(os.path.join(tmp, "a", name, f),
                    os.path.join(tmp, "b", name, f))
        open(os.path.join(tmp, "b", name + ".COMMIT"), "w").close()
        flash_attention.launches = flash_attention.wgmma_launches = 0
        resumed = train.run(train.parse_args(base + [
            "--ckpt-dir", os.path.join(tmp, "b"), "--ckpt-every",
            str(10 * TRAIN_STEPS)]))
        n_b8_resumed = flash_attention.launches
        resumed_wgmma = flash_attention.wgmma_launches
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    losses = full.losses
    # the bytes of what a step takes: parameters, AdamW's moments and step,
    # the batch (the dry run's argument bytes, phase 10k)
    arg_bytes = {k: sum(t.numel() * t.element_size() for t in tree_leaves(v))
                 for k, v in (("params", full.params),
                              ("opt_state", full.opt_state),
                              ("batch", on_card(data.batch_at(0))))}
    first, last = (float(np.mean(losses[:TRAIN_STEPS // 2])),
                   float(np.mean(losses[TRAIN_STEPS // 2:])))
    n_params = _n_params(full.params)
    step_s = statistics.median(full.step_s[1:])
    tokens = TRAIN_B * TRAIN_S
    mfu = 6.0 * n_params * tokens / (step_s * PEAK_BF16)
    log(f"train: {cfg.name} {cfg.n_layers} layers d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.hd} vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}, {n_params} parameters, B="
        f"{TRAIN_B} S={TRAIN_S}: {TRAIN_STEPS} steps in {full_s:.2f}s "
        f"(checkpoints included); losses {json.dumps(losses)}")
    log(f"train step: {step_s * 1e3:.2f} ms (median of steps 2-"
        f"{TRAIN_STEPS}; first {full.step_s[0] * 1e3:.1f} ms), "
        f"{tokens / step_s:.0f} tokens/s, MFU {mfu:.4f} (6 x {n_params} "
        f"parameters x {tokens} tokens over the step time x "
        f"{PEAK_BF16 / 1e12:.0f} TFLOP/s, dense bf16); peak memory "
        f"{peak} bytes; B8 {n_b8} launches ({n_b8 / TRAIN_STEPS:.0f} a "
        f"step), {n_wgmma} on wgmma; checkpoint saves "
        + ", ".join(f"{x:.2f}s" for x in full.save_s)
        + f", restore {resumed.restore_s:.2f}s")
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_STEPS:
        raise AssertionError(f"train: losses {losses}")
    if not last < first:
        raise AssertionError(f"train: the loss did not fall ({first} -> "
                             f"{last})")
    if n_b8 != per_step * TRAIN_STEPS or n_b8_resumed != per_step * (
            TRAIN_STEPS - TRAIN_CKPT_EVERY):
        raise AssertionError(f"train: B8 launched {n_b8} / {n_b8_resumed} "
                             f"times ({per_step} a step expected)")
    bf16 = cfg.cdtype == torch.bfloat16
    if (n_wgmma, resumed_wgmma) != ((n_b8, n_b8_resumed) if bf16
                                    else (0, 0)):
        raise AssertionError(f"train: {n_wgmma} / {resumed_wgmma} of the B8 "
                             "launches on wgmma")
    if resumed.start != TRAIN_CKPT_EVERY or len(full.save_s) != \
            TRAIN_STEPS // TRAIN_CKPT_EVERY:
        raise AssertionError(f"train: restored step {resumed.start}, "
                             f"{len(full.save_s)} saves")
    same = resumed.losses == losses[TRAIN_CKPT_EVERY:]
    log(f"train restart from step {TRAIN_CKPT_EVERY}: losses "
        f"{json.dumps(resumed.losses)}, bit-equal to the uninterrupted "
        f"run's: {same}; loss first {TRAIN_STEPS // 2} mean {first:.4f} -> "
        f"last {TRAIN_STEPS // 2} mean {last:.4f}")
    if not same:
        raise AssertionError("train: the restart's losses differ from the "
                             "uninterrupted run's")
    save_s, restore_s = full.save_s, resumed.restore_s
    del full

    # (3) where a step's time goes
    model = Model(cfg, DEVICE)
    loss_fn = make_loss_fn(model)
    opt_cfg = AdamWConfig(total_steps=TRAIN_STEPS,
                          warmup_steps=max(1, TRAIN_STEPS // 20))
    params, opt_state = resumed.params, resumed.opt_state
    batch = on_card(data.batch_at(TRAIN_STEPS))

    def split():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        ev[0].record()
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, live), batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, live)
        ev[2].record()
        adamw_update(opt_cfg, params, tree_unflatten(params, list(grads)),
                     opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    split()
    fwd_ms, bwd_ms, opt_ms = split()
    total = fwd_ms + bwd_ms + opt_ms
    log(f"train step split (CUDA events): forward + loss {fwd_ms:.2f} ms, "
        f"backward {bwd_ms:.2f} ms (share {bwd_ms / total:.4f}), AdamW "
        f"{opt_ms:.2f} ms")
    step_fn = make_train_step(model, opt_cfg)
    # the busy share: the profiled step's device time over that step's
    # wall (the profiler slows the host, so a floor of the unprofiled one)
    busy_ms, prof_ms = step_profile(lambda: step_fn(params, opt_state, batch),
                                    "train step", "flash_kernel")
    busy = busy_ms / prof_ms
    del params, opt_state, resumed, batch
    torch.cuda.empty_cache()
    # the plain attention backward at the training shape (B8's own time
    # there is phase 9's row)
    gen = torch.Generator(DEVICE).manual_seed(6)
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (_randn(gen, (TRAIN_B, TRAIN_S, n, hd), cfg.cdtype)
               .transpose(1, 2) for n in (h, hkv, hkv))
    dout = _randn(gen, (TRAIN_B, h, TRAIN_S, hd), cfg.cdtype)
    att_bwd_ms = event_ms(
        lambda: flash_attention.attention_grad(q, k, v, dout), 5)
    log(f"train attention at B={TRAIN_B} H={h} Hkv={hkv} S={TRAIN_S} "
        f"D={hd} {str(cfg.cdtype)[6:]}: the rematerialised plain backward "
        f"{att_bwd_ms:.3f} ms a call")
    del q, k, v, dout
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    log(f"train: phase {wall:.1f}s")
    return {"launches": n_b8, "launches_per_step": n_b8 // TRAIN_STEPS,
            "step_ms": step_s * 1e3, "tokens_s": tokens / step_s,
            "mfu": mfu, "backward_share": bwd_ms / total,
            "busy_share": busy, "peak_bytes": peak, "save_s": save_s,
            "restore_s": restore_s, "attention_backward_ms": att_bwd_ms,
            "argument_bytes": arg_bytes, "seconds": wall}


def _phase_dryrun() -> dict:
    """Phase 10k, the child's body (``python3 chip_smoke.py --dryrun-child
    OUT.json``; it runs on the host beside the model phases).  (1)
    launch/mesh.py's make_local_mesh() on the card, a world of one (NCCL,
    an in-process store), checked: one rank, the (1, 1) ("data",
    "model") mesh; on it the dry run of TRAIN_ARCH's train step at the
    train phase's batch and length (meta DTensors, nothing allocated),
    whose argument bytes the main process holds against the bytes of the
    train child's parameters, moments and batch, exactly.  (2) On fake
    256- and 512-rank worlds, the DRYRUN_CELLS at full width and depth,
    one record a line, each with flops and peak bytes above 0, a
    bottleneck and its world's rank count."""
    import torch.distributed as dist

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, fake_world,
                                         make_local_mesh)
    from repro_torch.models.config import ShapeConfig
    t0 = time.perf_counter()
    device_type = torch.device(DEVICE).type
    mesh = make_local_mesh(device_type)
    if (mesh.size(), tuple(mesh.shape), mesh.mesh_dim_names,
            mesh.device_type) != (1, (1, 1), ("data", "model"), device_type):
        raise AssertionError(f"dryrun: make_local_mesh() gave {mesh}")
    log(f"dryrun: make_local_mesh(): {mesh}, world {dist.get_world_size()}"
        f", backend {dist.get_backend()}")
    shape = ShapeConfig(f"train_b{TRAIN_B}_s{TRAIN_S}", "train", TRAIN_S,
                        TRAIN_B)
    train = dryrun.lower_cell(TRAIN_ARCH, shape, False, verbose=False,
                              mesh=mesh)
    dist.destroy_process_group()
    log(f"dryrun record: {json.dumps(train)}")
    cells = []
    for arch, cell, multi_pod in DRYRUN_CELLS:
        n = math.prod(PRODUCTION_SHAPES[multi_pod][0])
        with fake_world(n):
            rec = dryrun.lower_cell(arch, cell, multi_pod, verbose=False)
        log(f"dryrun record: {json.dumps(rec)}")
        if not (rec["flops"] > 0 and rec["peak_bytes_per_device"] > 0
                and rec["bottleneck"] in ("compute", "memory", "collective")
                and rec["n_chips"] == n):
            raise AssertionError(f"dryrun: {arch} {cell}: {rec}")
        cells.append(rec)
    wall = time.perf_counter() - t0
    log(f"dryrun: {len(cells) + 1} cells in {wall:.1f}s (the child's wall)")
    return {"train": train, "cells": cells, "seconds": wall}


def phase_dryrun(dry: dict, trained: dict) -> dict:
    """Phase 10k's gate, in the main process: the dry run's argument bytes
    of the train step equal the train child's parameter, moment and batch
    bytes exactly; its predicted peak is printed beside the train run's
    measured max_memory_allocated."""
    want = sum(trained["argument_bytes"].values())
    got = dry["train"]["argument_bytes_per_device"]
    log(f"dryrun vs train: argument bytes {got} predicted, {want} in the "
        f"train child ({trained['argument_bytes']}); peak "
        f"{dry['train']['peak_bytes_per_device']} bytes predicted for one "
        f"step, {trained['peak_bytes']} measured (max_memory_allocated over "
        f"the {TRAIN_STEPS}-step run); the child's wall {dry['seconds']:.1f}s")
    if got != want:
        raise AssertionError(f"dryrun: argument bytes {got} != {want}")
    return dry


def step_profile(step, label: str = "decode step",
                 kernel: str | None = None) -> tuple[float, float]:
    """One call of ``step`` under torch.profiler: its CUDA kernels, their
    summed device time against the call's wall (the card's busy share),
    the device time of the kernels whose name holds ``kernel``, and the
    aten dispatches the host made.  Returns (device ms, wall ms)."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    aten = sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("aten::"))
    mine = "" if kernel is None else ", {} {:.3f} ms of it".format(
        kernel, sum(e.time_range.elapsed_us() for e in kernels
                    if kernel in e.name) / 1e3)
    log(f"model {label} (profiled): {len(kernels)} CUDA kernels, "
        f"device busy {busy:.3f} ms of {wall * 1e3:.3f} ms wall (busy "
        f"share {busy / (wall * 1e3):.4f}){mine}, {aten} aten dispatches")
    return busy, wall * 1e3


def serve_requests(vocab: int, n: int):
    """The serve phase's ``n`` requests: the trace launch/serve.py uses at
    the main path's embedder width, prompts of 32-480 tokens below
    ``vocab``."""
    from repro_torch.core import SynthConfig, synthetic_trace
    trace = synthetic_trace(SynthConfig(trace_len=n, n_topics=24,
                                        dim=SERVE_DIM, seed=0))
    rng = np.random.default_rng(0)
    return [(r.cid, r.emb, [int(t) for t in rng.integers(
        2, vocab, size=int(rng.integers(32, 481)))])
        for r in trace.requests[:n]]


def _serve_engine_config(device: str, backend: str):
    from repro_torch.serving import EngineConfig
    return EngineConfig(cache_backend=backend, device=device,
                        emb_dim=SERVE_DIM, cache_capacity=64, max_batch=8,
                        max_seq=512, max_new_tokens=16)


def _serve_outcome(engine, events, done) -> dict:
    s = engine.stats
    return {"events": events,
            "requests": [(r.rid, r.cid, r.cached, len(r.out_tokens))
                         for r in done],
            "stats": {k: s[k] for k in ("hits", "misses", "evictions",
                                        "generated_tokens", "batches")}}


def _serve_host(n: int):
    """The serve phase's host replay of ``n`` requests at smoke width, in a
    worker."""
    torch.set_num_threads(2)
    from repro_torch.configs import get_config
    from repro_torch.models import smoke_variant
    from repro_torch.serving import ServingEngine
    cfg = smoke_variant(get_config(MODEL_ARCH))
    engine = ServingEngine(cfg, _serve_engine_config("cpu", "numpy"),
                           generator=torch.Generator().manual_seed(0))
    events = record(engine.cache)
    t0 = time.perf_counter()
    done = engine.run(serve_requests(cfg.vocab_size, n))
    out = _serve_outcome(engine, events, done)
    out["wall"] = time.perf_counter() - t0
    return out


def phase_serve():
    """The serving engine at the paper LM's full width on the card, held
    to the host replay's decisions."""
    from repro_torch.kernels import decode_attention, similarity_topk
    from repro_torch.models import smoke_variant
    from repro_torch.serving import ServingEngine
    cfg = model_config()
    with _workers(1, 2) as pool:
        host = pool.submit(_serve_host, SERVE_LEN)
        engine = ServingEngine(cfg, _serve_engine_config(DEVICE, "kernel"),
                               generator=torch.Generator(
                                   DEVICE).manual_seed(0))
        events = record(engine.cache)
        reqs = serve_requests(smoke_variant(cfg).vocab_size, SERVE_LEN)
        # where the wall goes: the model's decode steps (synchronised
        # inside the timer) against the cache's calls
        split = {"model": 0.0, "cache": 0.0}
        decode = engine.decode

        def timed_decode(*a):
            t = time.perf_counter()
            out = decode(*a)
            torch.cuda.synchronize()
            split["model"] += time.perf_counter() - t
            return out
        engine.decode = timed_decode
        for name in ("decide_batch", "peek_rows", "lookup", "admit",
                     "flush"):
            fn = getattr(engine.cache, name)

            def wrap(*a, _fn=fn, **kw):
                t = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    split["cache"] += time.perf_counter() - t
            setattr(engine.cache, name, wrap)
        counters = ((similarity_topk, "launches"),
                    (decode_attention, "launches"))
        for mod, attr in counters:
            setattr(mod, attr, 0)
        eq1_reset()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = engine.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {mod.__name__.split(".")[-1]: getattr(mod, attr)
                    for mod, attr in counters}
        eq1 = eq1_counts()
        launches.update(decision=eq1["victim_value"],
                        decision_vec=eq1["victim_value (vector)"],
                        rac_value=eq1["rac_value"],
                        rac_value_vec=eq1["rac_value (vector)"])
        peak = torch.cuda.max_memory_allocated()
        t_serve = len(engine.cache.policy.tp_last)
        n_slots = engine.cache.store.emb.shape[0]
        got = _serve_outcome(engine, events, done)
        want = host.result()
    st = got["stats"]
    n = len(reqs)
    log(f"serve: {n} requests in {wall:.2f}s ({n / wall:.2f} req/s), "
        f"{st['batches']} decode steps ({wall / max(1, st['batches']) * 1e3:.2f}"
        f" ms/step), {st['generated_tokens']} generated tokens "
        f"({st['generated_tokens'] / wall:.1f}/s), hits {st['hits']} misses "
        f"{st['misses']} evictions {st['evictions']} hit_ratio "
        f"{st['hits'] / max(1, st['hits'] + st['misses']):.4f}, peak device "
        f"bytes {peak}")
    log(f"serve: wall split model {split['model']:.2f}s, cache "
        f"{split['cache']:.2f}s, other "
        f"{wall - split['model'] - split['cache']:.2f}s; kernel launches "
        f"{json.dumps(launches)}; host replay (smoke width, numpy) "
        f"{want['wall']:.2f}s")
    for key in ("stats", "requests", "events"):
        if got[key] != want[key]:
            detail = (first_diff(got[key], want[key]) if key != "stats"
                      else f"{got[key]} vs {want[key]}")
            raise AssertionError(f"serve: {key} differ from the host "
                                 f"replay's: {detail}")
    if st["hits"] == 0 or st["evictions"] == 0:
        raise AssertionError("serve: no hits or no evictions")
    missing = [k for k in ("similarity_topk", "decision", "rac_value",
                           "decode_attention") if launches[k] < 1]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")
    if launches["decode_attention"] != st["batches"] * cfg.n_layers:
        raise AssertionError("serve: B9 did not launch once per layer and "
                             "decode step")
    log(f"serve: {len(got['events'])} events, {n} cached flags and token "
        "counts identical to the host replay's")
    # B3 over the serve cache's residents and B2 over its slots, at the
    # topic table the engine's RAC grew
    rng = np.random.default_rng(4)
    log(f"serve: RAC's topic table T={t_serve}, {n_slots} slots")
    rows = {"victim_value": check_values(rng, n_slots, t_serve, 200,
                                         ("victim_value",))["victim_value"],
            "rac_value": check_values(rng, n_slots - 1, t_serve, 200,
                                      ("rac_value",))["rac_value"]}
    return launches, rows


def main():
    t_start = time.perf_counter()
    kind = phase_device()
    phase_build()
    from repro_torch.core import OASSTConfig, oasst_style_trace
    t0 = time.perf_counter()
    trace = oasst_style_trace(OASSTConfig(dim=DIM, trace_len=TRACE_LEN,
                                          seed=0))
    log(f"trace: {len(trace.requests)} requests, "
        f"{len({r.cid for r in trace.requests})} unique, D={DIM} "
        f"({time.perf_counter() - t0:.1f}s)")
    sim, values, (b4, b5, b1d) = phase_kernels(trace)
    m1, m5, m2 = phase_multi(trace)
    b8, b9 = phase_attention()
    log(f"kernels: {time.perf_counter() - t_start:.1f}s")
    # hymba's fp32 gates (~2,100 host-bound decode steps) run in a child
    # process beside phases 4-6, which time no kernel
    with child_phase(HYMBA_CHILD) as hymba_fp32:
        parity_events = phase_parity(trace)
        log(f"parity: {time.perf_counter() - t_start:.1f}s")
        approx_parity = phase_approx_parity(trace)
        log(f"approx parity: {time.perf_counter() - t_start:.1f}s")
        arena_sharded, arena = phase_arena(trace)
        log(f"arena: {time.perf_counter() - t_start:.1f}s")
        hymba32 = hymba_fp32()
    log(f"hymba fp32 child joined: {time.perf_counter() - t_start:.1f}s")
    sharded = phase_sharded(trace, parity_events, approx_parity,
                            arena_sharded)
    sim.append(sharded["b1_row"])
    values["rac_value"].append(sharded["b3_row"])
    log(f"sharded phase: {time.perf_counter() - t_start:.1f}s")
    launches, warm, real_v = phase_main(trace)
    for k, row in real_v.items():
        values[k].insert(1, row)
    log(f"main: {time.perf_counter() - t_start:.1f}s")
    approx = phase_approx_main(trace, warm)
    del warm
    torch.cuda.empty_cache()
    log(f"approx main: {time.perf_counter() - t_start:.1f}s")
    # the host replays of the kv and tiers phases (the plain B3's is the
    # longest: ~100 s) run in workers while the model phases use the card,
    # and so does the dry run (10k)
    with _workers(4, 1) as pool, child_phase(DRYRUN_CHILD) as dry_child:
        kv_hosts, tiers_hosts = kv_workers(pool, trace), tiers_workers(
            pool, trace)
        fa_launches = phase_model()
        log(f"model: {time.perf_counter() - t_start:.1f}s")
        gemma = phase_gemma()
        log(f"gemma: {time.perf_counter() - t_start:.1f}s")
        deepseek = phase_deepseek()
        log(f"deepseek: {time.perf_counter() - t_start:.1f}s")
        hymba = phase_hymba(hymba32)
        log(f"hymba: {time.perf_counter() - t_start:.1f}s")
        whisper = phase_whisper()
        log(f"whisper: {time.perf_counter() - t_start:.1f}s")
        xlstm = phase_xlstm()
        log(f"xlstm: {time.perf_counter() - t_start:.1f}s")
        internvl = phase_internvl()
        log(f"internvl: {time.perf_counter() - t_start:.1f}s")
        trained = phase_train()
        log(f"train: {time.perf_counter() - t_start:.1f}s")
        phase_dryrun(dry_child(), trained)
        log(f"dryrun: {time.perf_counter() - t_start:.1f}s")
        tiers_launches = phase_tiers(trace, tiers_hosts)
        log(f"tiers: {time.perf_counter() - t_start:.1f}s")
        kv_launches, kv_row = phase_kv(trace, kv_hosts)
    values["rac_value"].append(kv_row)
    log(f"kv: {time.perf_counter() - t_start:.1f}s")
    serve, serve_v = phase_serve()
    for k, row in serve_v.items():
        values[k].append(row)
    log(f"serve: {time.perf_counter() - t_start:.1f}s")

    src = "src/repro_torch/csrc/"
    keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")

    def row(name, source, replaces, n_launch, shapes, library_call,
            **extra):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": "src/repro/kernels/" + replaces,
                "launches": n_launch, **{k: shapes[0][k] for k in keys},
                "max_abs_err": max(x["max_abs_err"] for x in shapes
                                   if x["max_abs_err"] is not None),
                "library_call": library_call, **extra, "shapes": shapes}

    q8_extra = dict(
        kernel="int8 wgmma fed by a TMA ring (sim_topk_q8.cu); rows TMA "
               "cannot read take __dp4a (sim_topk.cu)",
        library_calls="torch._int_mm + float + 2 mul + torch.topk (5 calls)")

    sl = sharded["launches"]
    rows = [row("sim_top1", "sim_top1.cu", "similarity_topk.py:67",
                launches["sim_top1"], sim,
                "torch.mm (product only, IEEE fp32)",
                tiers_launches=tiers_launches["sim_top1"],
                sharded_launches=sl["sim_top1"])]
    eq1_kernel = ("eq1_value.cuh's eq1_kernel: one wave, V entries a thread "
                  "from 16-byte loads, topic tables staged by a bulk copy "
                  "where they fit, programmatic dependent launch")
    for name, replaces in (("victim_value", "decision.py:50"),
                           ("rac_value", "rac_value.py:31")):
        extra = ({"kv_launches": kv_launches["rac_value"],
                  "tiers_launches": tiers_launches["rac_value"]}
                 if name == "rac_value" else {})
        extra["sharded_launches"] = sl[name]
        rows.append(row(name, name + ".cu", replaces, launches[name],
                        values[name], None, kernel=eq1_kernel,
                        floor_ms=values[name][0]["floor_ms"],
                        vec_launches=launches[name], **extra))
    rows += [
        row("sim_topk", "sim_topk_f32.cu", "similarity_topk.py:170",
            approx["topk_launches"], b4,
            "torch.mm + torch.topk (IEEE fp32)",
            f32_launches=approx["topk_f32_launches"],
            sharded_launches=sl["sim_topk"],
            kernel="fp32 SIMT, cp.async rings: Q <= 16 a warp's 32-row "
                   "tiles, Q > 16 128 x 128 tiles of 8 x 8 micro-tiles"),
        row("sim_topk_q8", "sim_topk_q8.cu", "similarity_topk.py:197",
            approx["topk_q8_launches"], b5,
            "torch._int_mm (product only; Q padded to 32 rows at Q=1, "
            "the slab's first 65,536 rows)",
            wgmma_launches=approx["topk_q8_wgmma_launches"],
            sharded_launches=sl["sim_topk_q8"],
            library_calls_ms=b5[0]["library_calls_ms"], **q8_extra),
        row("sim_top1 (device n_valid)", "sim_top1.cu",
            "similarity_topk.py:67", approx["dev_n_valid_launches"], b1d,
            "torch.mm (product only, IEEE fp32)"),
        row("sim_top1_multi", "sim_top1.cu", "ops.py:306",
            arena["sim_top1_multi"], m1,
            "torch.mm over the flat (P*S, D) slab (product only, IEEE fp32)",
            sharded_launches=sl["sim_top1_multi"]),
        row("sim_topk_q8_multi", "sim_topk_q8.cu", "ops.py:260",
            arena["sim_topk_q8_multi"], m5,
            "torch._int_mm over the flat (P*S, D) int8 slab (product only; "
            "Q padded to 32 rows at Q=16, the first rows in 8s)",
            wgmma_launches=arena["sim_topk_q8_multi (wgmma)"],
            library_calls_ms=m5[0]["library_calls_ms"],
            **{**q8_extra, "library_calls": "torch._int_mm over each slab "
               "padded to a multiple of 8 rows + float + 2 mul + "
               "masked_fill_ + torch.topk (6 calls)"}),
        row("victim_value_multi", "victim_value.cu", "decision.py:79",
            arena["victim_value_multi"], m2, None, kernel=eq1_kernel,
            floor_ms=m2[0]["floor_ms"],
            vec_launches=arena["victim_value_multi (vector)"]),
        row("flash_attention", "flash_attention.cu", "flash_attention.py:56",
            fa_launches, b8,
            "torch.nn.functional.scaled_dot_product_attention(is_causal="
            "True, enable_gqa=True); with a window, attn_mask = the band "
            "(built outside the timing; past S = 8,192 with K/V repeated "
            "to the query heads, on the memory-efficient backend); "
            "non-causal: is_causal=False",
            gemma_launches=gemma["launches"]["b8"],
            deepseek_launches=deepseek["launches"]["b8"],
            hymba_launches=hymba["launches"]["b8"],
            whisper_launches=whisper["launches"]["b8"],
            internvl_launches=internvl["launches"]["b8"],
            train_launches=trained["launches"],
            train_launches_per_step=trained["launches_per_step"]),
        row("decode_attention", "decode_attention.cu",
            "decode_attention.py:53", serve["decode_attention"], b9,
            "torch.nn.functional.scaled_dot_product_attention(q.view(B, "
            "Hkv, G, D), k.transpose(1, 2), v.transpose(1, 2), attn_mask="
            "arange(S_max) <= pos, scale) (mask built outside the timing)",
            gemma_launches=gemma["launches"]["b9"],
            deepseek_launches=deepseek["launches"]["b9"],
            hymba_launches=hymba["launches"]["b9"],
            hymba_fp32_launches=hymba["launches"]["b9_fp32"],
            whisper_launches=whisper["launches"]["b9"],
            whisper_serve_launches=whisper["serve_b9"],
            internvl_launches=internvl["launches"]["b9"])]
    for r in rows:
        r["kernel_ms"] = r["ms"]
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    children = {TRAIN_CHILD: _phase_train, HYMBA_CHILD: _hymba_fp32,
                DRYRUN_CHILD: _phase_dryrun}
    if sys.argv[1:2] and sys.argv[1] in children:
        _no_tf32()
        record = children[sys.argv[1]]()
        with open(sys.argv[2], "w") as f:
            json.dump(record, f)
    else:
        main()
