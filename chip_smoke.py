#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi) and builds the CUDA
   kernels from ``paddle_tpu_torch/kernels/csrc`` with nvcc, one process
   per source, all at once.
2. Kernel phases, in bf16: each kernel's wrapper against its plain PyTorch
   version on the same inputs, within a stated tolerance; its time (CUDA
   events, median of 30 launches), the plain version's time, one PyTorch
   library call's time as a yardstick, and its bound (bytes at 3.35 TB/s
   or flops at 989 TFLOP/s, whichever is larger, from this run's inputs).
   B1, B2, B3, B7's prefill path and the paged-decode kernels are also
   timed as CUDA-graph replays (no host launch overhead; B1, B7 and the
   decode kernels' library calls too), and B2 and B3 report the share of
   their bound that the graph replay reaches.
   The flash forward (B1) runs at Llama-3-8B's serving shapes (Hq 32, Hk 8,
   D 128), at GPT-2 medium's (B 8, S 1024, H 16, D 64) and at ViT-L/16's
   (B 32, S 197, H 16, D 64, non-causal: the last key tile holds 5
   keys), held per query row too and shown to fail without its last key
   tile; the flash backward kernels (B2 dQ, B3 dK/dV) at GPT-2 medium's,
   at Llama-3-8B's (B 1, S 2048, Hq 32, Hk 8, D 128) and at ViT-L/16's
   (with SDPA's backward as the yardstick); the paged-decode kernels at the
   serving path's, over bf16 pools (B4, B6) and int8 pools (B5, B6q), the
   per-page kernel timed beside the split route at its shape; the
   int8 weight matmul (B7) at decode (M 8) for each of Llama-3-8B's five
   projection shapes and at the longest prefill (M 1008) for each of the
   four layer shapes (and gate/up at the shortest, M 112, and at the
   frontend's extend buckets, M 16 and 256, and at a verify sweep's
   M 40 for every layer shape and the LM head), with its sums
   over one decode step's 225 launches and one prefill's 224 layer
   launches against their bounds. Every B7 shape is also a graph replay
   (with the wrapper's host time per call), one decode layer's seven B7
   launches are one graph (the step: 32 of them and the LM head's), and
   ``torch._weight_int8pack_mm`` is timed beside ``F.linear`` where this
   build has it for CUDA.
3. Varlen phase: packed sequences through the segment branch of B1-B3,
   bf16, ``requires_grad`` inputs, through the public entry points: V1
   ``nn.functional.flash_attn_unpadded`` at Llama-3-8B width (Hq 32, Hk 8,
   D 128, causal) over one row of 8192 tokens of seeded random lengths
   1..2048 (a 1-token sequence first); V2 the same at GPT-2 medium width
   (H 16, D 64) with each sequence's last min(L, 64) tokens as queries
   over a 4096-token kv row, one sequence with none (the bottom-right
   shift); V3 ``kernels.flash_attention.flash_attention`` with segment ids
   at B 2, S 2048, GPT-2 medium width, ids (pos // 96) % 3 and one query
   id no key has. Counts are zeroed before each public call and read
   after it: B1-seg, B2-seg and B3-seg once each, no dense launch. The
   forward is held per query row and dQ/dK/dV relatively against the
   plain pair (which takes its query rows in chunks), the check is shown
   to fail when one run of 64 keys of a sequence goes missing, and the
   kernels, their chain and the public forward + backward are timed
   (events and graph replays) beside the plain pair, the bound (over the
   visible pairs this run's ids and positions let through; B2's and B3's
   graph replays as a share of it) and one PyTorch call (``varlen_attn``,
   or masked SDPA where it cannot say the case); how B2 and B3 classify
   the case's (query block, key tile) pairs (skip, masked, full) is
   counted beside.
4. Serving phase: Llama-3-8B at full width and depth, bf16, random weights
   from a fixed generator, served by ``ContinuousBatchingEngine``:
   engine A (max_seq_len 2048: the split-KV decode route) and engine B
   (max_seq_len 240: the per-page route), then a profile of A's decode.
   Then the same model is converted in place to int8 weights by the port's
   ``QAT`` and served with an int8 KV cache by engines A8 and B8 (A's and
   B's prompts, routes and token counts), and A8's and B8's decode are
   profiled.
   One 1000-token prefill (padded to 1008) of A's and of A8's model is
   timed and profiled by kernel group, and so is one prefix-cache extend
   as engines S and S8 run it (a 200-token tail, bucket 256, over the
   512-token system prompt), with its tail attention's device time.
   The frontend: the same model behind ``serving.ServingEngine`` with the
   default flags (prefix cache, budget 512, bucket cap 1024, admission
   and brownout on), engine S (bf16) after engine B and engine S8 (int8
   weights and KV) after B8, ``max_seq_len`` 2048. Each is built not
   ready (a submit must raise ``NotReadyError``) and warmed up (every
   prefill bucket and the decode step), then takes 16 requests at once:
   a 512-token system prompt shared by 14 of them (one cold request that
   registers it, hits, a duplicate prompt, one extending another's), two
   unrelated misses, 32 new tokens each. Its ``serving.prefix.*``
   counters must move by what the traffic works out to on the host
   (``expected_prefix_counts``: two copy-on-writes), with no preemption,
   every request ``DONE``, 32 B1 launches per cold prefill and none per
   extend, 32 B6 (S) or B6q (S8) per decode step and, in S8, 225 B7 per
   prefill, extend and decode step; TTFT of hits and misses, decode
   tokens/s and peak memory are printed; the teacher-forced check holds
   its tokens. A ``background=True`` engine then serves its first four
   prompts through ``handle.result()``: the tokens must be engine S's.
   The speculative phase (after S, and after S8 with int8 weights and
   KV): the same frontend with ``spec=True`` and 4 drafts a slot
   (engines S-spec and S8-spec) and, first, with ``spec=False`` on the
   same traffic for the reference tokens: 8 requests at once
   (``spec_traffic``, seed 11: a 32-64-token phrase repeated to 400-900
   tokens plus a unique 5-20-token tail), 64 new tokens each. Gates:
   every request ``DONE``, no preemption, ``serving.spec.proposed`` =
   accepted + rejected with drafts proposed and verify sweeps run, one
   ``Llama.paged_spec_step`` per ``serving.spec.steps``; 32 B1 per cold
   prefill, 32 B6 (S) or B6q (S8) per plain decode step and none in a
   sweep, in S8 225 B7 (M 40 in a sweep) per prefill, extend, plain step
   and sweep; every accounted step closes (attributed + build + idle =
   step time, 1e-6 relative), the requests' ``CostReport.attributed_us``
   sum to the engine's, each request's ``spec_accepted`` equals the sum
   over its trace's ``serving.decode_step`` spans, ``export_trace``
   parses as JSON; the teacher-forced check on both engines, and the
   spec tokens equal the plain ones up to each request's first
   divergence, where the top-2 gap must be within the bf16 tolerance.
   Decode tokens/s, tokens per step, the acceptance rate, the MFU gauge
   and TTFT are printed, and one verify sweep of 8 slots x 5 rows is
   profiled beside a plain decode step (``profile_verify``: host ms,
   device busy, the plain verify attention's and B7's device ms).
   The random-weight model's greedy continuation never reproduces a
   token of its context, so prompt lookup proposes (almost) nothing on
   it: S-spec and S8-spec record how often it engaged. Engines R-spec
   and R8-spec run the same traffic on ``repeating_model`` (the same
   layers, the embedding at N(0, 1) and the LM head equal to it, so
   greedy decode repeats the last token; bf16, then converted in place
   to int8 weights with an int8 KV cache), where drafts must be proposed
   and accepted, with every gate above.
   Each engine's kernel launch counts are zeroed before it runs and must
   move by exactly the expected amounts; a teacher-forced dense forward of
   the model as served (bf16, or int8 weights through B7's plain version
   and attention over int8-rounded K/V for the decoded positions) must
   agree with every generated token whose top-2 logit gap exceeds the bf16
   tolerance.
5. Training phase: GPT-2 medium at full width and depth (24 layers, hidden
   1024, batch 8 x 1024), bf16 parameters with fp32 masters, AdamW 3e-4,
   global-norm clip 1.0, driven by ``TrainStep`` on one fixed batch. A
   gate holds one forward + backward on the kernel route against the plain
   route (``FLAGS_flash_kernel=plain``); then 2 warm-up and 10 timed steps
   (counts zeroed before, read after: B1, B2 and B3 must move by 24 per
   step; the loss must stay finite and fall), and a profile of 2 steps
   (device time by kernel group, attention backward per step among them).
   Then the reference's fp8 rung (``fp8_train``): first a route gate at
   each of GPT-2 medium's four linear shapes (M 8192): the forward, dx and
   dW products through ``amp.fp8.fp8_gemm`` (``torch._scaled_mm``, a
   library call) against the plain version on the same fp8 operands
   (relative 1e-3), each timed beside the plain version, the bf16 product
   of the same shape and its bound at the fp8 peak (1,979 TFLOP/s), and
   one fp8 layer forward + backward beside a bf16 one; then the same
   model and batch (the same generator) built with ``use_fp8=True``,
   trained by the same optimizer for the same steps: every loss finite
   and falling and within 0.15 of the bf16 run's at the same step, B1-B3
   24 a step and 288 fp8 products a step; tokens/s, MFU against both
   peaks, peak memory, and a profile with the fp8 products, the
   quantize/amax passes and the backward's transposed copies as groups.
5a. ``vit_train`` (after ``fp8_train``): the reference's vit_l_train
   rung. ViT-L/16 for 1000 classes (24 layers, hidden 1024, 16 heads,
   MLP 4096, 304,326,632 parameters) in bf16 with fp32 masters from
   generator seed 0, one batch of 32 random 224 x 224 images and labels
   from the same generator: a route gate as the training phase's, with
   a float32 copy of the model as the reference that says which layers'
   q_proj grads bf16 resolves (``route_gate``), then AdamW 3e-4, clip
   1.0, ``TrainStep``, 2
   warm-up and 10 timed steps. Gates: finite, falling losses; B1, B2 and
   B3 exactly 24 times a step, no segment, decode, int8 or fp8 launch and
   no call of the masked SDPA route. Prints images/s, step ms (the
   reference's names), MFU against 989 TFLOP/s (3 x the forward's
   product flops, ``vit_flops_per_image``) and peak memory, and profiles
   2 steps (busy, attention, matmuls with the patch convolution,
   optimizer, kernels a step, idle share).
5b. ``llama_fp8`` (after the serving phase): Llama-3-8B with
   ``use_fp8=True`` (seed 0), its delayed scales calibrated by one
   training-mode forward over B's first prompt and frozen (eval), serves
   B's prompts as engine B does: the teacher-forced check, B1 32 per
   prefill, B4 32 per decode step and 224 fp8 products per prefill and
   decode step, and a profile of its decode.
5d. ``llama_train`` (after ``vit_train``): the Llama training slice at
   Llama-3-8B width (vocab 128256, d 4096, MLP 14336, Hq 32, Hk 8, D 128,
   theta 5e5) cut to 4 layers (1,923,125,248 parameters; the 32-layer
   state with fp32 masters and moments would not fit one card), bf16
   with fp32 masters from generator seed 0, one batch of 2 x 2048 random
   ids: a route gate (kernel route vs plain route vs a float32 copy on
   the plain route, every layer's q_proj and k_proj grads), then
   ``TrainStep(lambda m, ids: m.loss(ids, ids))`` under AdamW 1e-3 with
   clip 1.0 (examples/hybrid_llama.py:64-68), 2 + 10 steps. Gates:
   finite, falling losses; B1, B2 and B3 exactly 4 times a step, no
   other kernel of the port, no call of the plain flash pair. Prints step
   ms, tokens/s, MFU (``flops_per_token(2048)`` x 4096 tokens a step /
   989 TFLOP/s), peak memory and a profile of 2 steps (busy, idle,
   kernels a step, the optimizer's range), the fused LM head's forward +
   backward at the step's shape; then the tensor checker
   (``amp.debugging``) on one forward (every hooked op checked, none
   flagged; a NaN weight raises naming ``linear``; checked vs unchecked
   time) and ``profiler.Profiler(scheduler=(1, 3))`` around 4 steps,
   whose exported device trace must name B1, B2 and B3's kernels.
5e. In the serving phase, before the int8 conversion: ``generate``,
   ``model.generate`` (greedy, contiguous cache, plain cached attention,
   no kernel of the port) on 4 prompts of 128 tokens, 32 new each,
   against ``ContinuousBatchingEngine`` on the same prompts: tokens
   equal up to a near-tie (``spec_divergence``), an eos case (rows run
   free up to their first eos and emit only eos after), tokens/s of
   both; and ``telemetry``, engine S's traffic on a ``ServingEngine``
   with ``serve_metrics(port=0)`` on 127.0.0.1: every route scraped with
   urllib (``/metrics`` counters equal to the registry's, ``/healthz``,
   ``/readyz``, ``/alerts`` with the five rules, ``/summary``'s
   sections, ``/traces/<worst TTFT exemplar>``), then a second window
   with the TTFT budget at 1 ms: ``slo.ttft_burn`` fires once with a
   trace id that resolves, one ``alert.slo.ttft_burn`` flight record,
   listed under "Recent incidents", resolved once the budget is
   restored; ``maybe_evaluate``'s host cost and the engine's decode
   tokens/s beside engine S's.
5f. Kernel cases above head dim 128: B1, B2 and B3 at D 256 (B1 a TMA
   producer and two wgmma consumers, B2 and B3 two warpgroups' wgmma),
   D 160 (zero-padded to 256), and D 384, 512 and 640 (B1 and B2 streaming
   the head dim a chunk at a time, B3 in slices of up to 256 columns
   over two warpgroups), B 1, Hq 16,
   Hk 4, S 2048 causal and S 197 non-causal, against the plain pair at
   the true D, with times, bounds and SDPA's times (null where SDPA
   refuses the head dim); and at the llama_train shape (B 2, S 2048, Hq
   32, Hk 8, D 128). Then the path above 256: ``FlashAttention`` at D 288
   (padded to 384), forward and backward, counts zeroed just before and
   read just after (B1-B3 once each, ``xl_launches``), against the plain
   route.
5g. ``faults`` (after the path above 256): calls the tensor-core kernels
   do not take, each sent to a route decided before any launch and
   counted there, counts zeroed before and read after.
   ``FlashAttention`` forward + backward at the llama_train shape in
   float32 and fp16 (route ``split`` both ways: three split passes, B1 on
   three bf16 pieces of q, k, v, then four split passes, B2 and B3 on
   the pieces; or ``f16``: B1-B3 on f16 wgmma), in float32 at G 3, D 80
   (``split`` on K, V expanded 3 times, D padded to 128), in float32 and
   fp16 at D 160 (B 1, S 1024, Hq 16, Hk 4), D 256 (B 1, S 2048, Hq 16,
   Hk 8: Gemma-2 9B's widths) and D 288 (B 1, S 2048, Hq 16, Hk 4): the
   forward ``split`` or ``f16`` on the tensor cores (float32: three
   splits and B1 on the pieces, the tc kernel padded to 256 or the xl
   kernel at 288; fp16: B1 at 256 or the xl kernel), the backward
   ``simt`` (``flash_simt.cu``'s dQ and dK/dV),
   all against the plain pair within SIMT_RTOL / SIMT_BWD_RTOL, and in
   bf16 at Hq 24 / Hk 8,
   G 3 (route ``expanded``: B1-B3 once each on K and V expanded 3 times,
   within B1-B3's limits), read from
   ``kernels.flash_attention.ROUTE_COUNTS`` and ``BWD_ROUTE_COUNTS``;
   ``paged_decode_attention`` at D 256 (G 2), D 80, G 16 and with float32
   and fp16 queries and pools, bf16 and int8 pools (``simt`` in the decode
   ``ROUTE_COUNTS``: one launch of ``paged_decode_simt.cuh``, against the
   dense version); ``ConvertedInt8Linear`` with float32 and fp16 x at K
   4096 (``split``: one split pass and B7 on three bf16 pieces of x;
   ``f16``: B7 on f16 products) and with bf16, fp16 and float32 x at K
   4100, M 300 and 8 (``unaligned``, ``f16_unaligned``,
   ``split_unaligned``: B7 through its ragged loader; float32 at M 300
   after one split pass), read from ``kernels.quant_matmul.ROUTE_COUNTS``,
   against ``quant_matmul_plain``;
   and a float32 Llama at Llama-3-8B width cut to 2 layers serving 2
   requests of 8 new tokens through ``ContinuousBatchingEngine``, with a
   float32 cache and again converted to int8 weights with an int8 cache:
   greedy tokens equal to the same model's with every route forced
   plain, and only the kernels of the float32 routes launched (B1 and B7
   on three pieces, the split pass, the CUDA cores' decode attention;
   each at least once); and the CUDA cores' forward and int8 matmul,
   which no route takes now, launched directly against their plain
   versions. Then each of those kernels is timed at one shape
   against its plain version, one PyTorch call and its bound (the CUDA
   cores' at the float32 peak outside the tensor cores, 67 TFLOP/s); the
   flash kernels at the llama_train shape: B1-B3 on three bf16 pieces
   beside the CUDA cores' forward, dQ and dK/dV, bounds at 165 TFLOP/s
   (six bf16 products a float32 one) and at 67, the split pass
   (bit-equal to its plain version), the whole float32 forward call
   (three splits + B1) beside SDPA's float32 forward and the whole
   backward call (Delta + split + dQ + dK/dV) beside SDPA's float32
   backward, and B1-B3 in fp16 beside the bf16 kernels in the same run,
   the CUDA cores' fp16 forward, SDPA's fp16 forward and backward and
   bounds at 989 TFLOP/s; the CUDA cores' dQ and dK/dV also at D 160
   (B 1, S 1024, Hq 16, Hk 4) beside SDPA's float32 backward there; B7
   for float32 x (bound at 330 TFLOP/s: three bf16 products a float32
   one) and fp16 x at M 300 and M 8, beside the CUDA cores' kernel,
   ``F.linear`` in x's dtype and bf16 B7 on the same shape; the CUDA
   cores' kernel also at K 4100 with float32, fp16 and bf16 x, and its
   dQ and dK/dV in fp16 at D 160 beside SDPA's fp16 backward. The new
   tensor-core kernels: B1 above head dim 128 in float32 and fp16 at D
   160 (the faults' shape), D 256 (Gemma-2 9B's widths) and D 384
   (``wide_fwd_phase``) beside the CUDA cores' forward, SDPA and the
   plain forward; B7 through its ragged loader at K 4100, M 300 and 8,
   in bf16, fp16 and float32 (``unaligned_qmm_phase``) beside the CUDA
   cores' kernel, ``F.linear`` and B7 at K 4096 in the same run.
5h. ``gpt_f32`` (after ``faults``): GPT at the port's default float32,
   GPT-2 medium width cut to 2 layers, batch 8 x 1024, AdamW 3e-4, clip
   1.0, 2 + 3 ``TrainStep``s: finite, falling losses; per layer a step
   one forward, one dQ and one dK/dV on the tensor cores on three bf16
   pieces and seven split passes, no other kernel; step ms.
5c. ``optimizers``: GPT-2 medium width at 4 layers (a reduced depth),
   bf16: each of the 14 optimizers takes 3 steps from the same weights
   under ``LinearWarmup(CosineAnnealingDecay)`` (LBFGS through a
   closure): losses finite, each step's rate the schedule's; then a
   float32 model under ``amp.decorate(level="O2")`` + ``auto_cast`` +
   ``GradScaler`` with AdamW for 4 steps, the third with an inf gradient:
   the skipped step leaves the weights, the scale goes 65536, 131072,
   65536, 65536 as its rules give.
6. Prints one ``{"kernels": [...]}`` line (B1-B7, B1-B3 with their
   ViT-L/16 case, their llama_train path and their head-dim-160/256
   cases (``d256``) beside, the segment entries B1-seg, B2-seg, B3-seg
   at V1, every case beside, and B1-xl, B2-xl, B3-xl: the kernels above
   head dim 256 at D 384, S 2048, every case and the D 288 path beside,
   and the kernels of the faults phase: flash_fwd_f32, flash_fwd_f16
   (B1 on three bf16 pieces and on f16 wgmma), flash_fwd_f32_xl,
   flash_fwd_f16_256, flash_fwd_f16_xl (B1 above head dim 128),
   flash_simt_fwd, flash_simt_dq, flash_simt_dkv, flash_bwd_dq_f32,
   flash_bwd_dkv_f32 (B2/B3 on three bf16 pieces), flash_bwd_dq_f16,
   flash_bwd_dkv_f16, split_bf16x3, paged_decode_simt(_q),
   quant_matmul_simt, quant_matmul_f32 and quant_matmul_f16 (B7 on three
   bf16 pieces of x and on f16 products), quant_matmul_unaligned,
   quant_matmul_f16_unaligned, quant_matmul_f32_unaligned (B7 through
   its ragged loader), their launches from the faults paths and
   ``gpt_f32``) and, last, the
   ``{"ok": true, "device": ...}`` line. Any failure exits non-zero before
   it. Without a GPU, or without the package beside this file, it exits 2.

Before the ``kernels`` line it prints the run's full record (every phase,
every engine, the training run, the profiles) as one ``record {...}`` JSON
line.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import gc
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor core peak
HQ, HK, D = 32, 8, 128        # Llama-3-8B attention shapes
LAYERS = 32
DEVICE = "cuda"
# bf16 tolerances (absolute). Outputs are convex combinations of V rows
# drawn N(0, 1), so |O| stays below ~4, where one bf16 ulp is 2^-6; the
# kernel rounds P (unnormalized) and the plain version rounds P
# (normalized), which moves O by a few ulps at most.
O_ATOL = 3e-2
LSE_ATOL = 2e-3
# flash forward (B1): also per (batch, position, head) row, max |kernel -
# plain| / max |plain| of the row within ROW_RTOL. A late row's |O| at
# S 1024 is ~0.03-0.1, as small as O_ATOL; 2e-2 is two and a half bf16
# ulps at the row's largest value (DECODE_RTOL's reasoning). Each flash
# phase proves that the check sees a fault: the plain version with the
# last 64-key tile of the last query block left out must fail it, and the
# LSE check too.
ROW_RTOL = 2e-2
FLASH_ROWS = 64               # folded (position, head) rows per B1 CTA
FLASH_KEYS = 64               # keys per B1 tile
# paged decode (B4-B6q): within O_ATOL, and per slot max |kernel - plain|
# / max |plain| within DECODE_RTOL. A slot's |O| falls as its length grows
# (~0.15 at 2048 tokens against ~3 at 1), so the absolute limit is loose
# for long slots. One bf16 ulp is at most 2^-7 of the value it rounds, so
# 2e-2 allows two and a half ulps at the slot's largest value; a slot
# missing one staged chunk of keys moves by ~0.3 of it, and the phase
# checks that on every run.
DECODE_RTOL = 2e-2
# backward kernels: max |kernel - plain| / max |plain| (dK and dV sum over
# the sequence; P and dS round to bf16 at slightly different points)
BWD_RTOL = 2e-2
# the CUDA cores' kernels (flash_simt.cu, paged_decode_simt.cuh,
# quant_matmul_simt.cu): max |kernel - plain| / max |plain| (per row for
# flash O, per slot for decode). In float32 both sides make the same
# float32 products, summed in another order; in fp16 both round at the
# same points (the kernels the unnormalized P, the plain versions the
# normalized one: an fp16 ulp is 2^-11 of the value); bf16 decode as
# DECODE_RTOL.
SIMT_RTOL = {"float32": 1e-4, "float16": 5e-3, "bfloat16": DECODE_RTOL}
SIMT_BWD_RTOL = {"float32": 2e-4, "float16": 1e-2}
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 peak outside the tensor cores
# float32 on the tensor cores as three bf16 pieces: six bf16 products for
# each float32 product (B2, B3 at D 64/128 in float32)
F32_SPLIT_FLOPS_PER_S = BF16_FLOPS_PER_S / 6
# B7 with float32 x: three bf16 pieces of x against the exact bf16 weight,
# three bf16 products for each float32 one
F32_QMM_FLOPS_PER_S = BF16_FLOPS_PER_S / 3
# the float32 GPT phase: GPT-2 medium width at the port's default float32,
# a reduced depth, batch 8 x 1024, AdamW, 2 + 3 steps
F32_GPT_LAYERS, F32_GPT_TIMED = 2, 3
# GPT-2 medium, the training phase's shapes
GPT_B, GPT_S, GPT_H, GPT_D, GPT_LAYERS = 8, 1024, 16, 64, 24
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 2, 10, 2
# ViT-L/16, the vit_train phase (the reference's vit_l_train rung,
# bench.py:907): 32 images of 224 x 224, patch 16, so S = 1 + 14 x 14 =
# 197 tokens (not a multiple of B1-B3's 64-row and 64-key tiles), 16
# heads of 64 over 16 KV heads, non-causal; 1000 classes
VIT_B, VIT_IMAGE, VIT_CLASSES = 32, 224, 1000
VIT_S, VIT_H, VIT_D, VIT_LAYERS = 197, 16, 64, 24
VIT_PARAMS = 304_326_632
# fp8 training (phase fp8_train): GPT-2 medium's block linears (name, N,
# K) at M = 8 x 1024 tokens. The card's fp8 product and its plain version
# multiply the same fp8 operands and differ in accumulation order only
# (FP8_ROUTE_RTOL, relative to the largest |plain|); the fp8 run's loss
# stays within the reference's own tolerance of the bf16 run's at every
# step (tests/framework/test_fp8.py:241)
FP8_LINEARS = (("qkv_proj", 3072, 1024), ("out_proj", 1024, 1024),
               ("fc_in", 4096, 1024), ("fc_out", 1024, 4096))
FP8_ROUTE_RTOL = 1e-3
FP8_LOSS_RTOL = 0.15
FP8_FLOPS_PER_S = 1979e12     # H100 SXM dense fp8 tensor core peak
# optimizers phase: GPT-2 medium width at a reduced depth, a few steps each
OPT_LAYERS, OPT_STEPS = 4, 3
# kernel route vs plain route, one forward + backward of GPT-2 medium in
# bf16: the two differ only in rounding inside attention
GATE_LOSS_RTOL = 1e-2
GATE_NORM_RTOL = 2e-2
GATE_MIN_COSINE = 0.99
# with a float32 reference (ViT): a layer is resolved when its plain-route
# grads are within half the cosine budget of float32's
GATE_RESOLVED_COSINE = 1 - (1 - GATE_MIN_COSINE) / 2
# teacher-forced check: positions whose top-2 logit gap is below this are
# too close to call in bf16 and are skipped
GAP_TOL = 0.25
MIN_CHECKED_SHARE = 0.10
# fp8 engines: e4m3 rounds at 2^-3 of a value against bf16's 2^-7. A
# bf16-level difference between the paged and the dense path flips an
# e4m3 rounding of the element with odds ~1/16, and a flip moves it 16x
# a bf16 step: sqrt(16) = 4x the bf16 noise in expectation, 16x if every
# difference flipped. Measured on the card (PERF.md, PR 12): the fp8
# engine's largest deficit 0.66-1.06, 5-11x the bf16 engines' and its
# bf16 twin's (0.09-0.25). So at every position
# the fp8 engine's token must have a dense logit within FP8_DEFICIT_TOL
# (half of the 16x bound) of the largest: of 128256 random-weight logits
# (std ~1.3) some 70 lie that close to the top, so a token off the path
# fails at once
FP8_DEFICIT_TOL = 8 * GAP_TOL
# int8 weight matmul (B7): max |kernel - plain| / max |plain|. The kernel
# multiplies the channel scale after the f32 sum, the plain version before
# it; the two differ by f32 rounding, then by one bf16 rounding of y.
QMM_RTOL = 1e-2
# Llama-3-8B's converted layers at decode (M = 8 slot rows): (N, K) and
# launches per decode step. The first is the kernel's record shape.
QMM_DECODE = (((14336, 4096), 64),   # gate_proj, up_proj x 32 layers
              ((4096, 4096), 64),    # q_proj, o_proj
              ((1024, 4096), 64),    # k_proj, v_proj
              ((4096, 14336), 32),   # down_proj
              ((128256, 4096), 1))   # lm_head
QMM_PREFILL_M = 1008                 # the longest padded prompt
QMM_SHORT_M = 112                    # the shortest padded prompt of A8
# the converted layers at prefill (M = the padded prompt) and launches
# per prefill; the LM head runs on the last position only (M 1, decode's
# kernel). Gate/up first: the kernel's prefill record shape.
QMM_PREFILL = QMM_DECODE[:4]
QMM_PER_FORWARD = 7 * LAYERS + 1     # B7 launches per prefill or decode step
# one layer's B7 launches at decode, in the model's order: (name, N, K)
QMM_LAYER = (("q_proj", 4096, 4096), ("k_proj", 1024, 4096),
             ("v_proj", 1024, 4096), ("o_proj", 4096, 4096),
             ("gate_proj", 14336, 4096), ("up_proj", 14336, 4096),
             ("down_proj", 4096, 14336))
PREFILL_PROFILE_LEN = 1000           # one prompt, padded to 1008
QMM_EXTEND_M = (16, 256)             # frontend extends: tail buckets 16..256
# frontend phase (serving.ServingEngine, engines S and S8): a 512-token
# system prompt (32 full blocks) shared by 14 of 16 requests, each asking
# for FRONT_NEW tokens; suffixes of 17-200 tokens, never a block multiple
FRONT_SYSTEM = 512
FRONT_NEW = 32
# varlen phase (segment branch of B1-B3): V1's packed row and longest
# sequence, V2's packed kv row and longest sequence, V3's sequence length
# speculative phase (engines S-spec and S8-spec, and the plain engines
# that give their reference tokens): SPEC_REQUESTS prompts, each a seeded
# 32-64-token phrase repeated to 400-900 tokens plus a unique 5-20-token
# tail, SPEC_NEW new tokens each, SPEC_TOKENS drafts a slot per sweep
SPEC_REQUESTS, SPEC_SEED, SPEC_NEW, SPEC_TOKENS = 8, 11, 64, 4
QMM_VERIFY_M = 8 * (1 + SPEC_TOKENS)  # B7's rows in a verify sweep
# repeating_model's embedding scale: a row's norm (16 x 64) against the
# layers' residual sum, which grows about as the square root of depth
REPEAT_EMBED_STD = 16.0
# every accounted step closes: attributed + build + idle = step time
CLOSURE_RTOL = 1e-6
# llama_train (the Llama training slice): Llama-3-8B width at 4 layers (a
# reduced depth: the 32-layer state would not fit one card with fp32
# masters and moments), batch 2 x 2048, AdamW 1e-3 and clip 1.0 as
# examples/hybrid_llama.py:64-66
LT_LAYERS, LT_B, LT_S, LT_LR = 4, 2, 2048, 1e-3
LT_PARAMS = 1_923_125_248
LT_PROFILER_STEPS = 4          # steps under profiler.Profiler(scheduler=(1, 3))
# generate: greedy model.generate against ContinuousBatchingEngine on the
# same prompts (examples/serve_llm.py:276-288 at full width)
GEN_PROMPTS, GEN_LEN, GEN_NEW, GEN_SEED = 4, 128, 32, 14
# telemetry: the second window's TTFT budget, below every measured TTFT
# (each is a prefill of 500-700 tokens behind a queue: tens of ms at least)
TELE_BUDGET_US = 1000
# the endpoint's A/B: front traffic on two engines built alike, one with
# serve_metrics attached, in this order (each engine once cold, once warm)
AB_ORDER = ("bare", "attached", "attached", "bare")
# B1-B3 above head dim 128: (S, D, causal) at B 1, Hq 16, Hk 4; D 160
# runs zero-padded to the kernels' 256; 384, 512 and 640 run the kernels
# above 256 (at 640 B3's last 256-column slice lies half past D)
WIDE_CASES = ((2048, 256, True), (197, 256, False), (2048, 160, True),
              (197, 160, False), (2048, 384, True), (197, 384, False),
              (2048, 512, True), (197, 512, False), (197, 640, False))
# the path above head dim 256: FlashAttention at D 288 (padded to 384),
# B 1, S 2048, Hq 16, Hk 4, causal, forward and backward
XL_D, XL_S = 288, 2048
WIDE_B, WIDE_HQ, WIDE_HK = 1, 16, 4
V1_TOKENS, V1_LONGEST = 8192, 2048
V2_TOKENS, V2_LONGEST = 4096, 1024
V3_SEQ = 2048
# V4: Gemma-2 9B's attention widths (Hq 16, Hk 8, D 256), the segment
# branch of the D 256 kernels
V4_TOKENS, V4_LONGEST, V4_HQ, V4_HK, V4_D = 4096, 1024, 16, 8, 256
# the faults phase: paged decode at (Hq, Hk, D, dtype, pages) the decode
# kernels do not take (D 256 at G 2, D 80, G 16, a float32 model); the
# float32 Llama at Llama-3-8B width cut to 2 layers, 2 requests
FAULT_DECODE = ((16, 8, 256, "bfloat16", 8), (32, 8, 80, "bfloat16", 32),
                (64, 4, 128, "bfloat16", 32), (32, 8, 128, "float32", 8),
                (32, 8, 128, "float16", 32))
FAULT_LAYERS, FAULT_REQUESTS, FAULT_NEW = 2, 2, 8
FAULT_PROMPTS = (100, 300)


def fail(msg, code=1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(nbytes, flops, peak=BF16_FLOPS_PER_S):
    """The least time (ms) for moving ``nbytes`` and doing ``flops`` at
    ``peak`` (the bf16 tensor cores' unless given), and which of the two
    sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median per-launch time with CUDA events; optionally evicts the
    50 MB L2 before each launch (decode reads a cold cache per layer) by
    reading a 64 MB buffer, which leaves the L2 full of clean lines, as the
    serving path does (it reads weights and writes little)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(64 << 20, dtype=torch.uint8, device=DEVICE)

    def graph(self, fn, iters=30, cold=False):
        """Median time of one replay of ``fn`` captured in a CUDA graph:
        the device's time for the call without the host's launch overhead
        (a Python wrapper's checks and ctypes call can outlast a short
        kernel, and the event timer then measures the host)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        ms = self(g.replay, iters=iters, cold=cold)
        del g
        return ms

    def host(self, fn, iters=100):
        """Mean host time of one call of ``fn`` (ms), enqueued back to back
        with no synchronize between calls: a wrapper's own cost on the
        host (checks, allocation, ctypes, launch)."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        secs = time.perf_counter() - t
        torch.cuda.synchronize()
        return secs / iters * 1e3

    def __call__(self, fn, iters=30, warmup=3, cold=False):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        for s, e in ev:
            if cold:
                self.flush.sum()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))


def sdpa_library(torch, q, k, v, **kw):
    """One PyTorch SDPA call on [B, H, S, D] views (the yardstick; the port
    never calls it). Uses enable_gqa where this torch has it, else
    expands KV once, outside the timed call."""
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
        return lambda: F.scaled_dot_product_attention(q, k, v,
                                                      enable_gqa=True, **kw)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        ke = k.repeat_interleave(g, dim=1)
        ve = v.repeat_interleave(g, dim=1)
        return lambda: F.scaled_dot_product_attention(q, ke, ve, **kw)


# ---------------------------------------------------------------------------
# kernel phases
# ---------------------------------------------------------------------------

def row_rel_err(out, ref):
    """Per (batch, position, head) row: max |out - ref| / max |ref|. A
    row with no visible key has ref == 0: a zero output there reads 0, any
    other output a huge error (non-finite outputs are checked apart)."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    scale = ref.float().abs().amax(-1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


def dropped_tile(q, k, v, o_ref, lse_ref, causal=True):
    """The plain version (Sq == Sk) with the last 64-key tile of the last
    query block left out: the block's positions (causal: those at or past
    that tile's first key) see only the keys before it. At S 197 that
    tile is ragged: keys 192-196."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain)
    S = q.shape[1]
    bq = FLASH_ROWS // (q.shape[2] // k.shape[2])
    t_last = (S - 1) // FLASH_KEYS * FLASH_KEYS
    p0 = (S - 1) // bq * bq
    if causal:
        p0 = max(p0, t_last)
    o, lse = o_ref.clone(), lse_ref.clone()
    o[:, p0:], lse[:, :, p0:] = flash_attention_plain(
        q[:, p0:], k[:, :t_last], v[:, :t_last], causal=False,
        return_lse=True)
    return o, lse


def flash_phase(torch, timer, S, B=1, hq=HQ, hk=HK, dh=D, causal=True,
                case=None):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_fwd_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(1000 + S + dh)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    q, k, v = mk(hq), mk(hk), mk(hk)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    o_cut, lse_cut = dropped_tile(q, k, v, o_ref, lse_ref, causal)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    err_row = row_rel_err(o, o_ref)
    cut_row = row_rel_err(o_cut, o_ref)
    cut_l = (lse_cut - lse_ref).abs().max().item()
    del o_cut, lse_cut
    ok = err_o <= O_ATOL and err_l <= LSE_ATOL and err_row <= ROW_RTOL \
        and bool(torch.isfinite(o.float()).all())
    if cut_row <= ROW_RTOL or cut_l <= LSE_ATOL:
        fail(f"flash_fwd S={S}: the check cannot see a missing key tile "
             f"(row {cut_row} <= {ROW_RTOL} or LSE {cut_l} <= {LSE_ATOL})")
    ms = timer(lambda: flash_fwd_cuda(q, k, v, causal=causal))
    graph_ms = timer.graph(lambda: flash_fwd_cuda(q, k, v, causal=causal))
    plain_ms = timer(lambda: flash_attention_plain(q, k, v, causal=causal,
                                                   return_lse=True))
    lib = sdpa_library(torch, q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), is_causal=causal)
    library_ms = timer(lib)
    library_graph_ms = timer.graph(lib)
    pairs = S * (S + 1) // 2 if causal else S * S
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * 2 \
        + lse.numel() * 4
    bms, by = bound(nbytes, 4 * B * hq * dh * pairs)
    rec = dict(case=case, B=B, S=S, Hq=hq, Hk=hk, D=dh, causal=causal,
               max_abs_err=err_o,
               lse_err=err_l, row_rel_err=err_row,
               missing_tile_row_rel_err=cut_row, missing_tile_lse_err=cut_l,
               ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
               library_ms=library_ms, library_graph_ms=library_graph_ms,
               bound_ms=bms, bound_by=by, ok=ok)
    print(f"flash_fwd B={B} S={S} Hq={hq} Hk={hk} D={dh} causal={causal}: "
          f"err O "
          f"{err_o:.3e} LSE {err_l:.3e} row {err_row:.3e} (a key tile "
          f"missing: row {cut_row:.3e} LSE {cut_l:.3e}) | kernel {ms:.4f} "
          f"ms (graph {graph_ms:.4f}) plain {plain_ms:.4f} ms sdpa "
          f"{library_ms:.4f} ms (graph {library_graph_ms:.4f}) bound "
          f"{bms:.4f} ms ({by})", flush=True)
    if not ok:
        fail(f"flash_fwd disagrees with its plain version at S={S}: "
             f"O {err_o} (atol {O_ATOL}), LSE {err_l} (atol {LSE_ATOL}), "
             f"row {err_row} (rtol {ROW_RTOL})")
    return rec


def sdpa_backward_library(torch, q, k, v, do, causal=True):
    """The backward of one PyTorch SDPA call on [B, H, S, D] views,
    through ``torch.autograd.grad``: the yardstick for B2 + B3 together
    (the port never calls it). KV is expanded for GQA where this torch has
    no ``enable_gqa``."""
    F = torch.nn.functional
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    try:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                             enable_gqa=True)
    except TypeError:
        g = q.shape[1] // k.shape[1]
        out = F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1),
            is_causal=causal)
    return lambda: torch.autograd.grad(out, (q, k, v), do,
                                       retain_graph=True)


def bwd_bounds(q, k, lse, pairs, idb=0):
    """Bounds of B2 and B3 from this run's inputs: ``pairs`` visible
    (query, key) pairs per query head, ``idb`` bytes of segment ids and
    positions. B2 makes 3 products over the pairs (S, dP, dQ) and moves
    q, dO, dQ, k, v, LSE and Delta; B3 makes 4 (S, dP, dV, dK) and moves
    q, dO, k, v, dK, dV, LSE and Delta."""
    fl = 2 * q.shape[-1] * q.shape[2] * pairs  # one product
    qb, kvb = q.numel() * 2, k.numel() * 2
    rows = lse.numel() * 4 * 2                 # LSE and Delta
    return {"flash_bwd_dq": bound(3 * qb + 2 * kvb + rows + idb, 3 * fl),
            "flash_bwd_dkv": bound(2 * qb + 4 * kvb + rows + idb, 4 * fl)}


def flash_bwd_phase(torch, timer, B, S, hq, hk, dh, causal=True,
                    case=None):
    """B2 and B3 against ``flash_attention_bwd_plain``, with the forward's
    O and LSE from B1. Returns one record per kernel."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
        flash_delta, flash_fwd_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(2000 + S + dh)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    o, lse = flash_fwd_cuda(q, k, v, causal=causal)
    delta = flash_delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    errs = {}
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        diff = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        errs[name] = (diff, diff / max(scale, 1e-6),
                      bool(torch.isfinite(out.float()).all()))
    del refs
    dq_call = lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                        causal=causal)
    dkv_call = lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                          causal=causal)
    times = {name: (timer(fn), timer.graph(fn))
             for name, fn in (("flash_bwd_dq", dq_call),
                              ("flash_bwd_dkv", dkv_call))}
    plain_ms = timer(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       causal=causal),
                     iters=20)
    lib = sdpa_backward_library(torch, q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), do.transpose(1, 2),
                                causal)
    library_ms = timer(lib, iters=20)
    bounds = bwd_bounds(q, k, lse, B * (S * (S + 1) // 2 if causal
                                        else S * S))
    shape = dict(case=case, B=B, S=S, Hq=hq, Hk=hk, D=dh, causal=causal)
    recs = {}
    for name, keys in (("flash_bwd_dq", ("dq",)),
                       ("flash_bwd_dkv", ("dk", "dv"))):
        ms, graph_ms = times[name]
        bms, by = bounds[name]
        abs_err = max(errs[k][0] for k in keys)
        rel_err = max(errs[k][1] for k in keys)
        ok = rel_err <= BWD_RTOL and all(errs[k][2] for k in keys)
        recs[name] = dict(shape, max_abs_err=abs_err, rel_err=rel_err,
                          ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bms, bound_by=by,
                          share_of_bound=bms / ms,
                          graph_share_of_bound=bms / graph_ms, ok=ok)
        print(f"{name} B={B} S={S} Hq={hq} Hk={hk} D={dh} causal={causal}: "
              f"err {abs_err:.3e} (rel {rel_err:.3e}) | kernel {ms:.4f} ms "
              f"(graph {graph_ms:.4f}) plain (whole backward) "
              f"{plain_ms:.4f} ms sdpa backward {library_ms:.4f} ms bound "
              f"{bms:.4f} ms ({by}; {bms / graph_ms:.1%} of it in the "
              f"graph)", flush=True)
        if not ok:
            fail(f"{name} disagrees with flash_attention_bwd_plain at "
                 f"S={S} D={dh}: relative error {rel_err} (limit "
                 f"{BWD_RTOL})")
    return recs


def wide_phase(torch, timer, S, dh, causal):
    """B1, B2 and B3 at a head dim above 128 (B 1, Hq 16, Hk 4): at D 256
    and above the kernels as they are, at D 160 zero-padded to 256 as
    ``FlashAttention`` pads it (the scale the true D's; the padding copies
    are outside the timed calls), against the plain pair at the true D;
    times (events and graph replays), bounds over the true D's work, the
    plain pair's and SDPA's (where it takes the shape). Returns one record
    per kernel."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda,
        pad_head_dim, padded_head_dim)
    B, hq, hk = WIDE_B, WIDE_HQ, WIDE_HK
    dp = padded_head_dim(dh)
    scale = 1.0 / math.sqrt(dh)
    g = torch.Generator(device=DEVICE).manual_seed(4000 + S + dh)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    qp, kp, vp, dop = (pad_head_dim(t, dp).contiguous()
                       for t in (q, k, v, do))
    fwd = lambda: flash_fwd_cuda(qp, kp, vp, causal=causal, scale=scale)
    o_p, lse = fwd()
    o = o_p[..., :dh]
    delta = flash_delta(o_p, dop)
    dq_call = lambda: flash_bwd_dq_cuda(qp, kp, vp, dop, lse, delta,
                                        causal=causal, scale=scale)
    dkv_call = lambda: flash_bwd_dkv_cuda(qp, kp, vp, dop, lse, delta,
                                          causal=causal, scale=scale)
    dq = dq_call()[..., :dh]
    dk, dv = (t[..., :dh] for t in dkv_call())
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    err_o = (o.float() - o_ref.float()).abs().max().item()
    err_l = (lse - lse_ref).abs().max().item()
    err_row = row_rel_err(o, o_ref)
    errs = {}
    for name, out, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        diff = (out.float() - ref.float()).abs().max().item()
        errs[name] = (diff, diff / max(ref.float().abs().max().item(), 1e-6),
                      bool(torch.isfinite(out.float()).all()))
    del refs
    ok_fwd = err_o <= O_ATOL and err_l <= LSE_ATOL and \
        err_row <= ROW_RTOL and bool(torch.isfinite(o.float()).all())
    times = {n: (timer(f), timer.graph(f)) for n, f in (
        ("flash_fwd", fwd), ("flash_bwd_dq", dq_call),
        ("flash_bwd_dkv", dkv_call))}
    plain_fwd = timer(lambda: flash_attention_plain(
        q, k, v, causal=causal, return_lse=True), iters=10)
    plain_bwd = timer(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal), iters=10)
    # B1's wrapper on the host alone (checks, allocation, ctypes, launch):
    # where it outlasts the kernel, the event time measures the host
    host_fwd = timer.host(fwd)
    lib_fwd = lib_bwd = lib_fwd_graph = None
    try:
        lib = sdpa_library(torch, q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), is_causal=causal)
        lib_fwd = timer(lib)
        lib_fwd_graph = timer.graph(lib)
        lib_bwd = timer(sdpa_backward_library(
            torch, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            do.transpose(1, 2), causal), iters=20)
    except RuntimeError as e:  # SDPA may not take this head dim
        print(f"sdpa at D {dh}: {e}", flush=True)
    pairs = B * (S * (S + 1) // 2 if causal else S * S)
    nbytes = (q.numel() + k.numel() + v.numel() + o.numel()) * 2 \
        + lse.numel() * 4
    bounds = dict(bwd_bounds(q, k, lse, pairs),
                  flash_fwd=bound(nbytes, 4 * hq * dh * pairs))
    shape = dict(case=f"d{dh}", B=B, S=S, Hq=hq, Hk=hk, D=dh,
                 padded_to=dp, causal=causal)
    recs = {}
    for name, keys in (("flash_fwd", None), ("flash_bwd_dq", ("dq",)),
                       ("flash_bwd_dkv", ("dk", "dv"))):
        ms, graph_ms = times[name]
        bms, by = bounds[name]
        if keys is None:
            rec = dict(shape, max_abs_err=err_o, lse_err=err_l,
                       row_rel_err=err_row, ok=ok_fwd, plain_ms=plain_fwd,
                       library_ms=lib_fwd, library_graph_ms=lib_fwd_graph,
                       host_ms=host_fwd)
        else:
            rel = max(errs[k][1] for k in keys)
            rec = dict(shape, max_abs_err=max(errs[k][0] for k in keys),
                       rel_err=rel, plain_ms=plain_bwd, library_ms=lib_bwd,
                       ok=rel <= BWD_RTOL and all(errs[k][2] for k in keys))
        rec.update(ms=ms, graph_ms=graph_ms, bound_ms=bms, bound_by=by,
                   graph_share_of_bound=bms / graph_ms)
        recs[name] = rec
        print(f"{name} D={dh} (run at {dp}) B={B} S={S} Hq={hq} Hk={hk} "
              f"causal={causal}: err {rec['max_abs_err']:.3e}"
              + (f" row {err_row:.3e} LSE {err_l:.3e} host {host_fwd:.4f} "
                 f"ms sdpa graph {lib_fwd_graph} ms" if keys is None
                 else f" (rel {rec['rel_err']:.3e})")
              + f" | kernel {ms:.4f} ms (graph {graph_ms:.4f}) plain "
              f"{rec['plain_ms']:.4f} ms sdpa {rec['library_ms']} ms bound "
              f"{bms:.4f} ms ({by}; {bms / graph_ms:.1%} of it)",
              flush=True)
        if not rec["ok"]:
            fail(f"{name} at head dim {dh} disagrees with its plain "
                 f"version: {rec}")
    return recs


def xl_path_phase(torch):
    """The kernels above head dim 256 on the path a user takes:
    ``scaled_dot_product_attention`` (``FlashAttention``) at head dim
    ``XL_D``, which the kernel route zero-pads to the next multiple of
    128, forward and backward, every count set to 0 just before and read
    just after (B1-B3 once each, all of them above 256), against the plain
    route (``FLAGS_flash_kernel=plain``) at the true D."""
    from paddle_tpu_torch.core import set_flags
    from paddle_tpu_torch.kernels.flash_attention import (
        padded_head_dim, scaled_dot_product_attention)
    B, hq, hk = WIDE_B, WIDE_HQ, WIDE_HK
    g = torch.Generator(device=DEVICE).manual_seed(4500)
    mk = lambda h: torch.randn(B, XL_S, h, XL_D, generator=g, device=DEVICE,
                               dtype=torch.bfloat16)
    base = [mk(hq), mk(hk), mk(hk)]
    do = mk(hq)
    outs, grads, counts = {}, {}, None
    for mode in ("plain", "auto"):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            ts = [t.clone().requires_grad_() for t in base]
            if mode == "auto":
                zero_counts()
            out = scaled_dot_product_attention(*ts, is_causal=True)
            out.backward(do)
            torch.cuda.synchronize()
            if mode == "auto":
                counts = read_counts()[0]
            outs[mode], grads[mode] = out.detach(), [t.grad for t in ts]
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
    err_o = (outs["auto"].float() - outs["plain"].float()).abs().max().item()
    err_row = row_rel_err(outs["auto"], outs["plain"])
    rel = {}
    for name, a, r in zip(("dq", "dk", "dv"), grads["auto"], grads["plain"]):
        rel[name] = ((a.float() - r.float()).abs().max() /
                     r.float().abs().max().clamp_min(1e-6)).item()
    launches = {n: counts[n] for n in ("B1-xl", "B2-xl", "B3-xl",
                                       "flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    rec = dict(D=XL_D, padded_to=padded_head_dim(XL_D), B=B, S=XL_S, Hq=hq,
               Hk=hk, causal=True, max_abs_err=err_o, row_rel_err=err_row,
               grad_rel_err=rel, launches=launches)
    print(f"xl path (FlashAttention at D {XL_D}, run at "
          f"{rec['padded_to']}): O err {err_o:.3e} row {err_row:.3e} "
          f"grads {rel} launches {launches}", flush=True)
    if launches != {"B1-xl": 1, "B2-xl": 1, "B3-xl": 1, "flash_fwd": 1,
                    "flash_bwd_dq": 1, "flash_bwd_dkv": 1}:
        fail(f"the D {XL_D} path did not launch B1-B3 above 256 once each: "
             f"{launches}")
    if not (err_o <= O_ATOL and err_row <= ROW_RTOL and
            max(rel.values()) <= BWD_RTOL):
        fail(f"the D {XL_D} path disagrees with the plain route: {rec}")
    return rec


# ---------------------------------------------------------------------------
# faults phase: shapes and dtypes the bf16 tensor-core kernels do not
# take, routed above them: float32 and fp16 to the tensor-core kernels'
# other instantiations where they take the shape, else to the CUDA cores'
# kernels (bf16 flash at a group not dividing 64: B1-B3 on expanded K and
# V)
# ---------------------------------------------------------------------------

# the kernels of the dtypes and shapes the bf16 tensor-core kernels do
# not take: B1-B3's and B7's other instantiations (float32 and fp16; B1
# at every head dim, B2-B3 up to 128; B7 at any K, through the ragged
# loader where K % 16 != 0) and the CUDA cores' (the backward above head
# dim 128; the forward and the int8 matmul, on no route now, launched
# directly) (name, source, the Pallas kernel it replaces)
SIMT_KERNELS = (
    ("flash_fwd_f32", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_fwd_f16", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_fwd_f32_xl", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_fwd_f16_256", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_fwd_f16_xl", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_simt_fwd", "paddle_tpu_torch/kernels/csrc/flash_simt.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_simt_dq", "paddle_tpu_torch/kernels/csrc/flash_simt.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("flash_simt_dkv", "paddle_tpu_torch/kernels/csrc/flash_simt.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
    ("flash_bwd_dq_f32", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("flash_bwd_dkv_f32", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
    ("flash_bwd_dq_f16", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("flash_bwd_dkv_f16", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
    # the float32 operands of B1-B3 and of B7's prefill, split into bf16
    # pieces
    ("split_bf16x3", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("paged_decode_simt",
     "paddle_tpu_torch/kernels/csrc/paged_decode_simt.cuh",
     "paddle_tpu/kernels/pallas/paged_attention.py:133"),
    ("paged_decode_simt_q",
     "paddle_tpu_torch/kernels/csrc/paged_decode_simt.cuh",
     "paddle_tpu/kernels/pallas/paged_attention.py:156"),
    ("quant_matmul_simt",
     "paddle_tpu_torch/kernels/csrc/quant_matmul_simt.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
    ("quant_matmul_f32", "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
    ("quant_matmul_f16", "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
    ("quant_matmul_unaligned",
     "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
    ("quant_matmul_f16_unaligned",
     "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
    ("quant_matmul_f32_unaligned",
     "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
)


def _route_deltas(before, after):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _route_state():
    """(flash routes, decode routes, kernel launch counts, B7 routes, flash
    backward routes) as plain dicts."""
    from paddle_tpu_torch.kernels.flash_attention import (BWD_ROUTE_COUNTS,
                                                          ROUTE_COUNTS)
    from paddle_tpu_torch.kernels.quant_matmul import ROUTE_COUNTS as QMM
    counts, decode = read_counts()
    return dict(ROUTE_COUNTS), decode, counts, dict(QMM), \
        dict(BWD_ROUTE_COUNTS)


def _dt(dtype):
    return str(dtype).split(".")[-1]


def fault_flash_launches(route, bwd_route, dh):
    """The launches of one FlashAttention forward on ``route`` and backward
    on ``bwd_route`` at head dim ``dh``: float32 (``split``) splits q, k, v
    for the forward (B1 on the pieces: the tc kernel up to head dim 256,
    the xl kernel above) and q, k, v, dO again for its backward; fp16
    (``f16``) runs B1 up to 128, at 256 (129-256 padded) or above; above
    128 both backwards run the CUDA cores' pair (``simt``); bf16 at a group
    not dividing 64 runs B1-B3 over expanded K and V."""
    from paddle_tpu_torch.kernels.flash_attention import padded_head_dim
    dp = padded_head_dim(dh)
    fwd = {"expanded": {"flash_fwd": 1},
           "f16": {"flash_fwd_f16" if dp <= 128 else "flash_fwd_f16_256"
                   if dp == 256 else "flash_fwd_f16_xl": 1},
           "split": {"flash_fwd_f32" if dp <= 256 else "flash_fwd_f32_xl":
                     1, "split_bf16x3": 3}}[route]
    bwd = {"expanded": {"flash_bwd_dq": 1, "flash_bwd_dkv": 1},
           "f16": {"flash_bwd_dq_f16": 1, "flash_bwd_dkv_f16": 1},
           "split": {"flash_bwd_dq_f32": 1, "flash_bwd_dkv_f32": 1,
                     "split_bf16x3": 4},
           "simt": {"flash_simt_dq": 1, "flash_simt_dkv": 1}}[bwd_route]
    out = dict(fwd)
    for name, n in bwd.items():
        out[name] = out.get(name, 0) + n
    return out


def fault_flash(torch, dtype, hq, hk, route, B=LT_B, S=LT_S, dh=D,
                bwd_route=None):
    """``FlashAttention`` forward + backward (at the llama_train shape
    unless given) in ``dtype`` over hq / hk heads: one count of ``route``
    forward and one of ``bwd_route`` (default ``route``) backward, and
    the kernels of ``fault_flash_launches`` launched that many times, no
    other, against the plain pair on the same inputs within those
    kernels' limits."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain,
        scaled_dot_product_attention)
    bwd_route = bwd_route or route
    g = torch.Generator(device=DEVICE).manual_seed(4600 + hq + dh - D)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE,
                               dtype=dtype)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    before = _route_state()
    out = scaled_dot_product_attention(*ts, is_causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    after = _route_state()
    routes = _route_deltas(before[0], after[0])
    bwd_routes = _route_deltas(before[4], after[4])
    launches = _route_deltas(before[2], after[2])
    o_ref, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    refs = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, causal=True)
    torch.cuda.synchronize()
    err_o = (out.float() - o_ref.float()).abs().max().item()
    rel = {n: rel_err(t.grad, r)[0]
           for n, t, r in zip(("dq", "dk", "dv"), ts, refs)}
    rec = dict(dtype=_dt(dtype), B=B, S=S, Hq=hq, Hk=hk, D=dh,
               routes=routes, bwd_routes=bwd_routes, launches=launches,
               max_abs_err=err_o, row_rel_err=row_rel_err(out, o_ref),
               grad_rel_err=rel)
    print(f"fault flash {rec}", flush=True)
    if routes != {route: 1} or bwd_routes != {bwd_route: 1} or \
            launches != fault_flash_launches(route, bwd_route, dh):
        fail(f"FlashAttention in {dtype} at {hq}/{hk} heads, D {dh} did "
             f"not take the {route} route forward and the {bwd_route} "
             f"route backward once each: {rec}")
    if route == "expanded":
        ok = err_o <= O_ATOL and rec["row_rel_err"] <= ROW_RTOL and \
            max(rel.values()) <= BWD_RTOL
    else:
        ok = rec["row_rel_err"] <= SIMT_RTOL[_dt(dtype)] and \
            max(rel.values()) <= SIMT_BWD_RTOL[_dt(dtype)]
    if not (ok and bool(torch.isfinite(out.float()).all())):
        fail(f"the {route} route disagrees with the plain pair: {rec}")
    return rec


def fault_decode(torch, hq, hk, dh, dtype, quantized, mbps):
    """``paged_decode_attention`` at a shape or dtype B4-B6q do not take:
    one ``simt`` count and one launch of ``paged_decode_simt.cuh``, no
    other, against the dense version within SIMT_RTOL a slot."""
    from paddle_tpu_torch.inference.paged import paged_decode_attention
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_dense)
    from paddle_tpu_torch.quantization import quantize_rows
    B, bs = 8, 16
    g = torch.Generator(device=DEVICE).manual_seed(4700 + dh + hq)
    kp = torch.randn(B * mbps + 1, bs, hk, dh, generator=g, device=DEVICE,
                     dtype=dtype)
    vp = torch.randn(B * mbps + 1, bs, hk, dh, generator=g, device=DEVICE,
                     dtype=dtype)
    q = torch.randn(B, hq, dh, generator=g, device=DEVICE, dtype=dtype)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    tbl = (1 + torch.arange(B * mbps, device=DEVICE, dtype=torch.int32)
           ).view(B, mbps)
    sl = torch.linspace(0, bs * mbps, B, device=DEVICE).to(torch.int32)
    before = _route_state()
    out = paged_decode_attention(q, kp, vp, tbl, sl, **scales)
    torch.cuda.synchronize()
    after = _route_state()
    routes = _route_deltas(before[1], after[1])
    launches = _route_deltas(before[2], after[2])
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    rec = dict(Hq=hq, Hk=hk, D=dh, dtype=_dt(dtype),
               pools="int8" if quantized else "float", pages=mbps,
               routes=routes, launches=launches,
               slot_rel_err=slot_rel_err(out, ref),
               max_abs_err=(out.float() - ref.float()).abs().max().item())
    print(f"fault decode {rec}", flush=True)
    name = "paged_decode_simt_q" if quantized else "paged_decode_simt"
    if routes != {"simt": 1} or launches != {name: 1}:
        fail(f"paged_decode_attention did not route {rec} to {name}")
    if rec["slot_rel_err"] > SIMT_RTOL[_dt(dtype)] or \
            not bool(torch.isfinite(out.float()).all()):
        fail(f"{name} disagrees with the dense version: {rec}")
    return rec


# B7's kernel by the int8 linear layer's route
FAULT_LINEAR_KERNELS = {"split": "quant_matmul_f32", "f16": "quant_matmul_f16",
                        "unaligned": "quant_matmul_unaligned",
                        "f16_unaligned": "quant_matmul_f16_unaligned",
                        "split_unaligned": "quant_matmul_f32_unaligned"}


def fault_linear_launches(route, M):
    """One launch of the route's kernel and, for float32 x at M >= 9, one
    split pass before it (at M <= 8 the decode kernel splits x itself)."""
    out = {FAULT_LINEAR_KERNELS[route]: 1}
    if route.startswith("split") and M > 8:
        out["split_bf16x3"] = 1
    return out


def fault_int8_linear(torch, dtype, K, route, M=64, N=4096):
    """``ConvertedInt8Linear`` with an x the bf16 kernel does not take:
    float32 or fp16 x with K a multiple of 16 (``split``: B7 on three bf16
    pieces of x after one split pass at M >= 9; ``f16``), or any x with K
    not a multiple of 16 (``unaligned``, ``f16_unaligned``,
    ``split_unaligned``: the same kernels through the ragged loader). One
    count of ``route`` in ``quant_matmul.ROUTE_COUNTS`` and the launches
    of ``fault_linear_launches``, no other, in x's dtype, against
    ``quant_matmul_plain`` within SIMT_RTOL."""
    from paddle_tpu_torch import quantization as TQ
    from paddle_tpu_torch.kernels.quant_matmul import quant_matmul_plain
    from paddle_tpu_torch.nn import Linear
    qat = lambda: TQ.QAT(TQ.QuantConfig(
        activation=None, weight=TQ.FakeQuanterWithAbsMaxObserver))
    layer = qat().convert(qat().quantize(torch.nn.Sequential(
        Linear(K, N, bias=False, device=DEVICE))))[0]
    g = torch.Generator(device=DEVICE).manual_seed(4800 + K)
    x = torch.randn(M, K, generator=g, device=DEVICE).to(dtype)
    before = _route_state()
    out = layer(x)
    torch.cuda.synchronize()
    after = _route_state()
    rel, diff = rel_err(out, quant_matmul_plain(x, layer.w_int8,
                                                layer.w_scales_f32))
    rec = dict(dtype=_dt(dtype), M=M, N=N, K=K,
               routes=_route_deltas(before[3], after[3]),
               launches=_route_deltas(before[2], after[2]),
               out_dtype=_dt(out.dtype), rel_err=rel, max_abs_err=diff)
    print(f"fault int8 linear {rec}", flush=True)
    if rec["routes"] != {route: 1} or \
            rec["launches"] != fault_linear_launches(route, M) or \
            out.dtype != dtype or rel > SIMT_RTOL[_dt(dtype)]:
        fail(f"ConvertedInt8Linear did not route {rec} to {route}, or "
             f"disagrees with the plain version")
    return rec


def _serve_tokens(torch, model, prompts, plain, **engine_kw):
    """Greedy tokens of ``prompts`` (``FAULT_NEW`` each) through
    ``ContinuousBatchingEngine``; with ``plain`` every route forced to
    the plain versions (FLAGS_flash_kernel=plain, FLAGS_paged_kernel=dense
    for the engine and each int8 layer). Returns (tokens, seconds, flash,
    decode and B7 route deltas, launch deltas)."""
    from paddle_tpu_torch import ContinuousBatchingEngine
    from paddle_tpu_torch.core import set_flags
    from paddle_tpu_torch.quantization import ConvertedInt8Linear
    int8 = [m for m in model.modules() if isinstance(m, ConvertedInt8Linear)]
    if plain:
        set_flags({"FLAGS_flash_kernel": "plain",
                   "FLAGS_paged_kernel": "dense"})
    for m in int8:
        m.kernel_mode = "dense" if plain else "auto"
    try:
        engine = ContinuousBatchingEngine(
            model, max_batch=FAULT_REQUESTS, block_size=16, max_seq_len=512,
            temperature=0.0, dtype=torch.float32, **engine_kw)
        before = _route_state()
        rids = [engine.add_request(p, FAULT_NEW) for p in prompts]
        t = time.perf_counter()
        out = engine.run_to_completion()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        after = _route_state()
    finally:
        set_flags({"FLAGS_flash_kernel": "auto",
                   "FLAGS_paged_kernel": "auto"})
        for m in int8:
            m.kernel_mode = "auto"
    del engine
    return ([list(map(int, out[r])) for r in rids], secs,
            _route_deltas(before[0], after[0]),
            _route_deltas(before[1], after[1]),
            _route_deltas(before[3], after[3]),
            _route_deltas(before[2], after[2]))


def fault_llama(torch):
    """A float32 Llama at Llama-3-8B width cut to ``FAULT_LAYERS`` layers
    serves ``FAULT_REQUESTS`` requests of ``FAULT_NEW`` new tokens through
    ``ContinuousBatchingEngine``: with a float32 cache (every prefill
    attention on ``split``: B1 on three bf16 pieces after the split
    passes; every decode attention on ``simt``), then converted to int8
    weights (the port's QAT) with an int8 cache (the linear layers on
    ``split``: B7 on three bf16 pieces of x, split by a pass at prefill
    and inside the decode kernel; decode attention on the int8-pool
    kernel). Each run's greedy tokens equal those of the same model with
    every route forced to the plain versions, and launch only the kernels
    named."""
    from paddle_tpu_torch import Llama, LlamaConfig
    from paddle_tpu_torch.quantization import (
        QAT, FakeQuanterWithAbsMaxObserver, QuantConfig)
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(),
                              num_layers=FAULT_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.float32, generator=gen)
    rng = np.random.default_rng(46)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in FAULT_PROMPTS]
    recs = {}
    for name, kv, want in (
            ("float32", None, {"flash_fwd_f32", "split_bf16x3",
                               "paged_decode_simt"}),
            ("w8_kv8", "int8", {"flash_fwd_f32", "split_bf16x3",
                                "paged_decode_simt_q", "quant_matmul_f32"})):
        if kv == "int8":
            qat = QAT(QuantConfig(activation=None,
                                  weight=FakeQuanterWithAbsMaxObserver))
            qat.convert(qat.quantize(model, inplace=True), inplace=True)
            gc.collect()
            torch.cuda.empty_cache()
        ref = _serve_tokens(torch, model, prompts, True, kv_cache_dtype=kv)
        run = _serve_tokens(torch, model, prompts, False, kv_cache_dtype=kv)
        tokens, secs, flash, decode, qmm, launches = run
        rec = dict(layers=FAULT_LAYERS, prompts=list(FAULT_PROMPTS),
                   new_tokens=FAULT_NEW, seconds=secs, plain_seconds=ref[1],
                   flash_routes=flash, decode_routes=decode,
                   int8_linear_routes=qmm, launches=launches,
                   generated=[len(t) for t in tokens],
                   equal_to_plain=tokens == ref[0])
        print(f"fault llama {name} {rec}", flush=True)
        if rec["generated"] != [FAULT_NEW] * FAULT_REQUESTS or \
                set(launches) != want or min(launches.values()) < 1 or \
                set(flash) != {"split"} or set(decode) != {"simt"} or \
                decode["simt"] % FAULT_LAYERS or \
                set(qmm) != ({"split"} if kv else set()) or \
                not rec["equal_to_plain"]:
            fail(f"the {name} Llama did not serve on the float32 routes' "
                 f"kernels as the plain routes do: {rec}")
        recs[name] = rec
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def _bwd_recs(name, dtype, shape, errs, times, plain_ms, library_ms,
              library, bounds, limit, **extra):
    """The records of one backward pair (dQ, dK/dV) from its errors
    {dq, dk, dv: (rel, abs)}, times {kernel: (events, graph)} and bounds
    {kernel: (ms, by)}; fails when an error passes ``limit``."""
    recs = {}
    for kernel, keys in zip(name, (("dq",), ("dk", "dv"))):
        rel = max(errs[k][0] for k in keys)
        diff = max(errs[k][1] for k in keys)
        ms, graph_ms = times[kernel]
        bms, by = bounds[kernel]
        recs[kernel] = dict(shape, dtype=dtype, max_abs_err=diff,
                            rel_err=rel, ms=ms, graph_ms=graph_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            library=library, bound_ms=bms, bound_by=by,
                            share_of_bound=bms / ms,
                            **{k: v[kernel] for k, v in extra.items()})
        print(f"{kernel} {dtype} {shape}: err {diff:.3e} (rel {rel:.3e}) | "
              f"kernel {ms:.4f} ms (graph {graph_ms:.4f}) plain (whole "
              f"backward) {plain_ms:.4f} ms {library} {library_ms:.4f} ms "
              f"bound {bms:.4f} ms ({by}; {bms / ms:.1%} of it)",
              flush=True)
        if not rel <= limit:
            fail(f"{kernel} disagrees with the plain pair: {recs[kernel]}")
    return recs


def simt_flash_phase(torch, timer, B=LT_B, S=LT_S, hq=HQ, hk=HK, dh=D):
    """The float32 and fp16 flash kernels at the llama_train shape,
    causal, against the plain pair (the backward kernels on the plain
    pair's O and LSE): ``flash_simt.cu``'s forward (in float32 and fp16)
    and, in float32, its dQ and dK/dV on the CUDA cores (which now serve
    head dims above 128 only; also timed at D 160, B 1, S 1024, Hq 16,
    Hk 4, beside SDPA's float32 backward there); the tensor-core B1-B3 in
    float32 as three bf16 pieces (the split pass, the whole forward call
    (three splits + B1) and the whole backward call (Delta + split + dQ +
    dK/dV) timed too) and in fp16 (beside the bf16 kernels on the same
    shape, in this run). Errors, times (CUDA events and graph replays),
    the plain pair's (the whole backward for every backward kernel), one
    SDPA call forward or backward in the same dtype (the library
    yardstick; the port never calls it) and bounds: float32 at the CUDA
    cores' 67 TFLOP/s and, on the tensor cores, at 165 (six bf16 products
    a float32 one); fp16 at 989."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_dkv_cuda,
        flash_bwd_dkv_x3_cuda, flash_bwd_dq_cuda, flash_bwd_dq_x3_cuda,
        flash_delta, flash_fwd_cuda, flash_fwd_x3_cuda, flash_simt_dkv_cuda,
        flash_simt_dq_cuda, flash_simt_fwd_cuda, flash_split_bwd_cuda,
        flash_split_fwd_cuda, split_bf16x3_cuda, split_bf16x3_plain)
    g = torch.Generator(device=DEVICE).manual_seed(4900)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g, device=DEVICE)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    shape = dict(B=B, S=S, Hq=hq, Hk=hk, D=dh, causal=True)
    sc = 1.0 / math.sqrt(dh)
    o, _ = flash_simt_fwd_cuda(q, k, v, causal=True)
    o_ref, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = flash_delta(o_ref, do)
    pieces = [split_bf16x3_cuda(t) for t in (q, k, v, do)]
    split_ok = torch.equal(pieces[0], split_bf16x3_plain(q))
    calls = {
        "flash_simt_fwd": lambda: flash_simt_fwd_cuda(q, k, v, causal=True),
        "flash_simt_dq": lambda: flash_simt_dq_cuda(q, k, v, do, lse, delta,
                                                    causal=True),
        "flash_simt_dkv": lambda: flash_simt_dkv_cuda(q, k, v, do, lse,
                                                      delta, causal=True),
        "flash_bwd_dq_f32": lambda: flash_bwd_dq_x3_cuda(
            *pieces, lse, delta, causal=True, scale=sc),
        "flash_bwd_dkv_f32": lambda: flash_bwd_dkv_x3_cuda(
            *pieces, lse, delta, causal=True, scale=sc),
        "flash_fwd_f32": lambda: flash_fwd_x3_cuda(*pieces[:3], causal=True,
                                                   scale=sc)}
    o3, lse3 = calls["flash_fwd_f32"]()
    dq = calls["flash_simt_dq"]()
    dk, dv = calls["flash_simt_dkv"]()
    dq3 = calls["flash_bwd_dq_f32"]()
    dk3, dv3 = calls["flash_bwd_dkv_f32"]()
    refs = flash_attention_bwd_plain(q, k, v, o_ref, lse, do, causal=True)
    torch.cuda.synchronize()
    errs = {"flash_simt_fwd": (row_rel_err(o, o_ref),
                               rel_err(o, o_ref)[1]),
            "flash_simt_dq": rel_err(dq, refs[0]),
            "flash_simt_dkv": max(rel_err(dk, refs[1]),
                                  rel_err(dv, refs[2]))}
    errs32 = dict(zip(("dq", "dk", "dv"), (rel_err(x, r) for x, r in zip(
        (dq3, dk3, dv3), refs))))
    err_f32 = (row_rel_err(o3, o_ref), rel_err(o3, o_ref)[1],
               (lse3 - lse).abs().max().item())
    del o, dq, dk, dv, dq3, dk3, dv3, refs, o3, lse3
    plain = {"fwd": timer(lambda: flash_attention_plain(
        q, k, v, causal=True, return_lse=True), iters=10),
        "bwd": timer(lambda: flash_attention_bwd_plain(
            q, k, v, o_ref, lse, do, causal=True), iters=10)}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = {"fwd": timer(sdpa_library(torch, qt, kt, vt, is_causal=True),
                            iters=10),
               "bwd": timer(sdpa_backward_library(
                   torch, qt, kt, vt, do.transpose(1, 2), True), iters=10)}
    fl = 2 * dh * hq * (B * S * (S + 1) // 2)  # one product over the pairs
    qb, kvb, rows = q.numel() * 4, k.numel() * 4, lse.numel() * 4
    bounds = {"flash_simt_fwd": bound(2 * qb + 2 * kvb + rows, 2 * fl,
                                      F32_FLOPS_PER_S),
              "flash_simt_dq": bound(3 * qb + 2 * kvb + 2 * rows, 3 * fl,
                                     F32_FLOPS_PER_S),
              "flash_simt_dkv": bound(2 * qb + 4 * kvb + 2 * rows, 4 * fl,
                                      F32_FLOPS_PER_S)}
    recs = {}
    for name in ("flash_simt_fwd", "flash_simt_dq", "flash_simt_dkv"):
        side = "fwd" if name == "flash_simt_fwd" else "bwd"
        rel, diff = errs[name]
        limit = SIMT_RTOL if side == "fwd" else SIMT_BWD_RTOL
        ms = timer(calls[name], iters=10)
        bms, by = bounds[name]
        recs[name] = dict(shape, dtype="float32", max_abs_err=diff,
                          rel_err=rel, ms=ms, plain_ms=plain[side],
                          library_ms=library[side],
                          library="F.scaled_dot_product_attention, float32",
                          bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
        print(f"{name} float32 B={B} S={S} Hq={hq} Hk={hk} D={dh} causal: "
              f"err {diff:.3e} (rel {rel:.3e}) | kernel {ms:.4f} ms plain "
              f"{plain[side]:.4f} ms sdpa {library[side]:.4f} ms bound "
              f"{bms:.4f} ms ({by}, float32 peak)", flush=True)
        if rel > limit["float32"]:
            fail(f"{name} disagrees with the plain pair: {recs[name]}")

    # B1 in float32 on the tensor cores (three pieces of q, k, v: 6 bytes
    # an element read, O float32 written), beside the CUDA cores' forward
    name = "flash_fwd_f32"
    ms, graph_ms = timer(calls[name], iters=10), timer.graph(calls[name],
                                                             iters=10)
    whole_fwd = timer(lambda: flash_split_fwd_cuda(q, k, v, True, scale=sc),
                      iters=10)
    bms, by = bound(q.numel() * 10 + k.numel() * 12 + rows, 2 * fl,
                    F32_SPLIT_FLOPS_PER_S)
    recs[name] = dict(
        shape, dtype="float32", max_abs_err=err_f32[1], rel_err=err_f32[0],
        lse_abs_err=err_f32[2], ms=ms, graph_ms=graph_ms,
        whole_call_ms=whole_fwd, plain_ms=plain["fwd"],
        library_ms=library["fwd"],
        library="F.scaled_dot_product_attention, float32", bound_ms=bms,
        bound_by=by, share_of_bound=bms / ms,
        bound_cuda_cores_ms=bounds["flash_simt_fwd"][0],
        cuda_cores_ms=recs["flash_simt_fwd"]["ms"])
    print(f"{name} {shape}: err {err_f32[1]:.3e} (row rel {err_f32[0]:.3e}, "
          f"LSE {err_f32[2]:.3e}) | kernel {ms:.4f} ms (graph "
          f"{graph_ms:.4f}), with its three splits {whole_fwd:.4f} ms, CUDA "
          f"cores {recs['flash_simt_fwd']['ms']:.4f} ms, plain "
          f"{plain['fwd']:.4f} ms, sdpa {library['fwd']:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; {bms / ms:.1%} of it)", flush=True)
    if not err_f32[0] <= SIMT_RTOL["float32"]:
        fail(f"{name} disagrees with the plain forward: {recs[name]}")

    # float32 on the tensor cores: the pieces are 6 bytes an element
    pair = ("flash_bwd_dq_f32", "flash_bwd_dkv_f32")
    pb, pkv = q.numel() * 6, k.numel() * 6
    times = {n: (timer(calls[n], iters=10), timer.graph(calls[n], iters=10))
             for n in pair}
    recs.update(_bwd_recs(
        pair, "float32", shape, errs32, times, plain["bwd"], library["bwd"],
        "F.scaled_dot_product_attention backward, float32 (B2 + B3)",
        {pair[0]: bound(2 * pb + 2 * pkv + qb + 2 * rows, 3 * fl,
                        F32_SPLIT_FLOPS_PER_S),
         pair[1]: bound(2 * pb + 2 * pkv + 2 * kvb + 2 * rows, 4 * fl,
                        F32_SPLIT_FLOPS_PER_S)},
        SIMT_BWD_RTOL["float32"],
        bound_cuda_cores_ms={pair[0]: bounds["flash_simt_dq"][0],
                             pair[1]: bounds["flash_simt_dkv"][0]},
        cuda_cores_ms={pair[0]: recs["flash_simt_dq"]["ms"],
                       pair[1]: recs["flash_simt_dkv"]["ms"]}))
    split_ms = timer(lambda: split_bf16x3_cuda(q), iters=10)
    split_four_ms = timer(lambda: [split_bf16x3_cuda(t)
                                   for t in (q, k, v, do)], iters=10)
    bms, by = bound(q.numel() * 10, 0)
    recs["split_bf16x3"] = dict(
        shape, dtype="float32", operand="q", max_abs_err=0.0,
        bit_equal_to_plain=split_ok, ms=split_ms, graph_ms=timer.graph(
            lambda: split_bf16x3_cuda(q), iters=10),
        four_ms=split_four_ms,
        plain_ms=timer(lambda: split_bf16x3_plain(q), iters=10),
        library_ms=None, bound_ms=bms, bound_by=by, share_of_bound=bms /
        split_ms)
    print(f"split_bf16x3 q {tuple(q.shape)}: bit-equal to the plain "
          f"version {split_ok} | kernel {split_ms:.4f} ms, q k v dO "
          f"{split_four_ms:.4f} ms, plain "
          f"{recs['split_bf16x3']['plain_ms']:.4f} ms bound {bms:.4f} ms "
          f"({by})", flush=True)
    if not split_ok:
        fail("split_bf16x3 differs from split_bf16x3_plain")
    whole_ms = timer(lambda: flash_split_bwd_cuda(
        q, k, v, o_ref, lse, do, True, scale=sc), iters=10)
    whole = dict(ms=whole_ms, sdpa_backward_ms=library["bwd"],
                 cuda_cores_ms=recs["flash_simt_dq"]["ms"] +
                 recs["flash_simt_dkv"]["ms"],
                 faster_than_sdpa=whole_ms < library["bwd"])
    print(f"float32 backward call (Delta + split + dQ + dK/dV): "
          f"{whole_ms:.4f} ms, SDPA float32 backward {library['bwd']:.4f} "
          f"ms, the CUDA cores' dQ + dK/dV {whole['cuda_cores_ms']:.4f} ms",
          flush=True)
    del pieces, o_ref, lse, delta

    # fp16 on f16 wgmma, beside bf16 on the same shape
    h = {dt: [t.to(dt) for t in (q, k, v, do)]
         for dt in (torch.float16, torch.bfloat16)}
    del q, k, v, do
    q, k, v, do = h[torch.float16]
    o, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = flash_delta(o, do)
    pair = ("flash_bwd_dq_f16", "flash_bwd_dkv_f16")
    calls = {pair[0]: lambda: flash_bwd_dq_cuda(q, k, v, do, lse, delta,
                                                causal=True),
             pair[1]: lambda: flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                                 causal=True)}
    outs = (calls[pair[0]](),) + calls[pair[1]]()
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    errs16 = dict(zip(("dq", "dk", "dv"), (rel_err(x, r) for x, r in zip(
        outs, refs))))
    del outs, refs
    times = {n: (timer(calls[n]), timer.graph(calls[n])) for n in pair}
    qb, kvb = q.numel() * 2, k.numel() * 2
    bf = h[torch.bfloat16]
    bf_calls = (lambda: flash_bwd_dq_cuda(*bf, lse, delta, causal=True),
                lambda: flash_bwd_dkv_cuda(*bf, lse, delta, causal=True))
    bf16 = {n: timer(c) for n, c in zip(pair, bf_calls)}
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib16 = timer(sdpa_backward_library(torch, qt, kt, vt,
                                        do.transpose(1, 2), True), iters=10)
    recs.update(_bwd_recs(
        pair, "float16", shape, errs16, times,
        timer(lambda: flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                causal=True), iters=10),
        lib16, "F.scaled_dot_product_attention backward, float16 (B2 + B3)",
        {pair[0]: bound(3 * qb + 2 * kvb + 2 * rows, 3 * fl),
         pair[1]: bound(2 * qb + 4 * kvb + 2 * rows, 4 * fl)},
        SIMT_BWD_RTOL["float16"], bf16_ms=bf16))
    f16_pair = times[pair[0]][0] + times[pair[1]][0]
    bf16_pair = bf16[pair[0]] + bf16[pair[1]]
    whole.update(f16_pair_ms=f16_pair, bf16_pair_ms=bf16_pair,
                 f16_over_bf16=f16_pair / bf16_pair)
    print(f"fp16 pair {f16_pair:.4f} ms against the bf16 pair "
          f"{bf16_pair:.4f} ms in this run ({f16_pair / bf16_pair:.3f}x)",
          flush=True)

    # B1 in fp16 on f16 wgmma, beside bf16 B1, the CUDA cores' fp16 forward
    # and SDPA's fp16 forward
    name = "flash_fwd_f16"
    run16 = lambda: flash_fwd_cuda(q, k, v, True)
    o16, _ = run16()
    torch.cuda.synchronize()
    e16 = (row_rel_err(o16, o), rel_err(o16, o)[1])
    del o16
    ms, graph_ms = timer(run16), timer.graph(run16)
    bf16_fwd = timer(lambda: flash_fwd_cuda(*bf[:3], True))
    simt16 = timer(lambda: flash_simt_fwd_cuda(q, k, v, True), iters=10)
    sdpa16 = timer(sdpa_library(torch, qt, kt, vt, is_causal=True))
    bms, by = bound(2 * qb + 2 * kvb + rows, 2 * fl)
    recs[name] = dict(
        shape, dtype="float16", max_abs_err=e16[1], rel_err=e16[0], ms=ms,
        graph_ms=graph_ms, plain_ms=timer(lambda: flash_attention_plain(
            q, k, v, causal=True, return_lse=True), iters=10),
        library_ms=sdpa16, library="F.scaled_dot_product_attention, float16",
        bound_ms=bms, bound_by=by, share_of_bound=bms / ms, bf16_ms=bf16_fwd,
        cuda_cores_ms=simt16)
    recs["flash_simt_fwd"].update(fp16_ms=simt16, sdpa_fp16_ms=sdpa16)
    whole.update(fwd_f16_ms=ms, fwd_bf16_ms=bf16_fwd,
                 fwd_f16_over_bf16=ms / bf16_fwd)
    print(f"{name} {shape}: err {e16[1]:.3e} (row rel {e16[0]:.3e}) | "
          f"kernel {ms:.4f} ms (graph {graph_ms:.4f}), bf16 B1 "
          f"{bf16_fwd:.4f} ms ({ms / bf16_fwd:.3f}x), CUDA cores' fp16 "
          f"forward {simt16:.4f} ms, sdpa fp16 {sdpa16:.4f} ms, bound "
          f"{bms:.4f} ms ({by})", flush=True)
    if not e16[0] <= SIMT_RTOL["float16"]:
        fail(f"{name} disagrees with the plain forward: {recs[name]}")
    del q, k, v, do, h, bf, o, lse, delta, qt, kt, vt
    for name, rec in simt_bwd_wide(torch, timer).items():
        recs[name]["d160"] = rec
    recs["flash_simt_fwd"]["d160"] = simt_fwd_wide(torch, timer)
    recs["whole"] = whole
    return recs


def simt_fwd_wide(torch, timer, B=1, S=1024, hq=WIDE_HQ, hk=WIDE_HK, dh=160):
    """The CUDA cores' forward (``flash_simt_fwd_cuda``) in float32 and
    fp16 at a head dim the tensor-core kernels do not take (the faults'
    D 160, causal): per-row error against the plain forward, CUDA events
    and graph replays, one SDPA forward in the same dtype, and the bound
    at the CUDA cores' 67 TFLOP/s (both dtypes multiply in float32 there).
    Returns {dtype: record}."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_simt_fwd_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(4961)
    out = {}
    for dtype in (torch.float32, torch.float16):
        mk = lambda h: torch.randn(B, S, h, dh, generator=g,
                                   device=DEVICE).to(dtype)
        q, k, v = mk(hq), mk(hk), mk(hk)
        run = lambda: flash_simt_fwd_cuda(q, k, v, causal=True)
        o, _ = run()
        o_ref = flash_attention_plain(q, k, v, causal=True)
        torch.cuda.synchronize()
        rel = row_rel_err(o, o_ref)
        diff = (o.float() - o_ref.float()).abs().max().item()
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = sdpa_library(torch, qt, kt, vt, is_causal=True)
        es = q.element_size()
        fl = 2 * dh * hq * (B * S * (S + 1) // 2)
        bms, by = bound(2 * q.numel() * es + 2 * k.numel() * es
                        + B * S * hq * 4, 2 * fl, F32_FLOPS_PER_S)
        ms = timer(run, iters=10)
        rec = dict(B=B, S=S, Hq=hq, Hk=hk, D=dh, causal=True, dtype=_dt(dtype),
                   rel_err=rel, max_abs_err=diff, ms=ms,
                   graph_ms=timer.graph(run, iters=10),
                   library_ms=timer(lib, iters=10),
                   library=f"F.scaled_dot_product_attention, {_dt(dtype)}",
                   bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
        out[_dt(dtype)] = rec
        print(f"flash_simt_fwd {_dt(dtype)} D {dh} B={B} S={S} Hq={hq} "
              f"Hk={hk} causal: err {diff:.3e} (row rel {rel:.3e}) | kernel "
              f"{ms:.4f} ms (graph {rec['graph_ms']:.4f}) sdpa "
              f"{rec['library_ms']:.4f} ms bound {bms:.4f} ms ({by}, float32 "
              f"peak)", flush=True)
        if rel > SIMT_RTOL[_dt(dtype)] or \
                not bool(torch.isfinite(o.float()).all()):
            fail(f"flash_simt_fwd at D {dh} disagrees with the plain "
                 f"forward: {rec}")
    return out


def simt_bwd_wide(torch, timer, B=1, S=1024, hq=WIDE_HQ, hk=WIDE_HK, dh=160):
    """The CUDA cores' dQ and dK/dV in float32 and fp16 at a head dim the
    tensor-core backward does not take (the faults' D 160, causal), on
    the plain forward's O and LSE: errors against the plain backward,
    times, SDPA's backward in the same dtype at that shape, bounds at 67
    TFLOP/s (both dtypes multiply in float32 there). Returns {kernel:
    {dtype: record}}."""
    out = {}
    for dtype in (torch.float32, torch.float16):
        for name, rec in _simt_bwd_wide(torch, timer, B, S, hq, hk, dh,
                                        dtype).items():
            out.setdefault(name, {})[_dt(dtype)] = rec
    return out


def _simt_bwd_wide(torch, timer, B, S, hq, hk, dh, dtype):
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_delta,
        flash_simt_dkv_cuda, flash_simt_dq_cuda)
    g = torch.Generator(device=DEVICE).manual_seed(4960)
    mk = lambda h: torch.randn(B, S, h, dh, generator=g,
                               device=DEVICE).to(dtype)
    q, k, v, do = mk(hq), mk(hk), mk(hk), mk(hq)
    o, lse = flash_attention_plain(q, k, v, causal=True, return_lse=True)
    delta = flash_delta(o, do)
    calls = {"flash_simt_dq": lambda: (flash_simt_dq_cuda(
        q, k, v, do, lse, delta, causal=True),),
        "flash_simt_dkv": lambda: flash_simt_dkv_cuda(
            q, k, v, do, lse, delta, causal=True)}
    outs = {n: c() for n, c in calls.items()}
    refs = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    errs = {"flash_simt_dq": rel_err(outs["flash_simt_dq"][0], refs[0]),
            "flash_simt_dkv": max(rel_err(outs["flash_simt_dkv"][0], refs[1]),
                                  rel_err(outs["flash_simt_dkv"][1],
                                          refs[2]))}
    del outs, refs
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    library = timer(sdpa_backward_library(torch, qt, kt, vt,
                                          do.transpose(1, 2), True), iters=10)
    fl = 2 * dh * hq * (B * S * (S + 1) // 2)
    es = q.element_size()
    qb, kvb, rows = q.numel() * es, k.numel() * es, lse.numel() * 4
    bounds = {"flash_simt_dq": bound(3 * qb + 2 * kvb + 2 * rows, 3 * fl,
                                     F32_FLOPS_PER_S),
              "flash_simt_dkv": bound(2 * qb + 4 * kvb + 2 * rows, 4 * fl,
                                      F32_FLOPS_PER_S)}
    out = {}
    for name, call in calls.items():
        rel, diff = errs[name]
        ms = timer(call, iters=10)
        bms, by = bounds[name]
        out[name] = dict(B=B, S=S, Hq=hq, Hk=hk, D=dh, causal=True,
                         dtype=_dt(dtype), rel_err=rel, max_abs_err=diff,
                         ms=ms, library_ms=library,
                         library="F.scaled_dot_product_attention backward, "
                                 f"{_dt(dtype)} (B2 + B3)",
                         bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
        print(f"{name} {_dt(dtype)} D {dh} B={B} S={S} Hq={hq} Hk={hk} "
              f"causal: err {diff:.3e} (rel {rel:.3e}) | kernel {ms:.4f} ms "
              f"sdpa backward {library:.4f} ms bound {bms:.4f} ms ({by}, "
              f"float32 peak)", flush=True)
        if rel > SIMT_BWD_RTOL[_dt(dtype)]:
            fail(f"{name} at D {dh} disagrees with the plain pair: "
                 f"{out[name]}")
    return out


def simt_decode_case(torch, timer, name, dtype, quantized, mbps, lens,
                     seed):
    """``paged_decode_simt.cuh`` at Llama-3-8B's heads (Hq 32, Hk 8, D
    128), B 8, on ``mbps``-page tables with ``lens``: queries in
    ``dtype`` over pools of it (or int8 rows with their scales), against
    the dense version within SIMT_RTOL a slot. CUDA events and graph
    replays with the L2 evicted, the plain version, SDPA over the gathered
    rows (dequantized outside the timed call) and the bound: each live row
    of K and V read once (an int8 row with its f32 scale), q read and the
    output written once, 4 Hq D flops a key at the CUDA cores' 67
    TFLOP/s."""
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_dense, paged_decode_attention_simt)
    from paddle_tpu_torch.quantization import quantize_rows
    B = len(lens)
    q, kp, vp, tbl, sl = decode_inputs(torch, B, mbps, lens, seed)
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    run = lambda: paged_decode_attention_simt(q, kp, vp, tbl, sl, **scales)
    dense = lambda: paged_decode_attention_dense(q, kp, vp, tbl, sl,
                                                 **scales)
    out, ref = run(), dense()
    torch.cuda.synchronize()
    rel = slot_rel_err(out, ref)
    diff = (out.float() - ref.float()).abs().max().item()
    bs = kp.shape[1]
    idx = tbl.long()

    def gathered(pool, scale):
        g = pool[idx]
        if scale is not None:
            g = (g.float() * scale[idx][..., None]).to(dtype)
        return g.reshape(B, mbps * bs, HK, D).transpose(1, 2)

    kg = gathered(kp, scales.get("k_scale"))
    vg = gathered(vp, scales.get("v_scale"))
    mask = (torch.arange(mbps * bs, device=DEVICE)[None, :]
            < sl[:, None])[:, None, None, :]
    lib = sdpa_library(torch, q[:, :, None, :], kg, vg, attn_mask=mask)
    total = int(np.sum(lens))
    es = q.element_size()
    row_bytes = D + 4 if quantized else D * es  # int8 row + its f32 scale
    nbytes = 2 * q.numel() * es + total * HK * row_bytes * 2 \
        + tbl.numel() * 4 + sl.numel() * 4
    bms, by = bound(nbytes, 4 * HQ * D * total, F32_FLOPS_PER_S)
    ms = timer(run, cold=True)
    # the plan's sizes (a checkout timed by tools/torch_decode_ab.py before
    # the kernel had a plan has none)
    plan = pa.simt_decode_plan(B, HK, HQ // HK, mbps, bs, D, es, quantized,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count) \
        if hasattr(pa, "simt_decode_plan") else ()
    rec = dict(dtype=_dt(dtype), pools="int8" if quantized else _dt(dtype),
               B=B, Hq=HQ, Hk=HK, D=D, mbps=mbps, lens=[int(x) for x in lens],
               plan=list(plan), max_abs_err=diff, rel_err=rel, ms=ms,
               graph_ms=timer.graph(run, cold=True),
               plain_ms=timer(dense, cold=True), library_ms=timer(
                   lib, cold=True), library_graph_ms=timer.graph(
                   lib, cold=True),
               library="F.scaled_dot_product_attention over the gathered "
                       f"{_dt(dtype)} rows", bound_ms=bms, bound_by=by,
               share_of_bound=bms / ms)
    print(f"{name} {_dt(dtype)} {rec['pools']} pools B={B} pages={mbps}: "
          f"err {diff:.3e} (slot rel {rel:.3e}) | kernel {ms:.4f} ms (graph "
          f"{rec['graph_ms']:.4f}) plain {rec['plain_ms']:.4f} ms sdpa "
          f"{rec['library_ms']:.4f} ms (graph {rec['library_graph_ms']:.4f}) "
          f"bound {bms:.4f} ms ({by}) plan {tuple(plan)}", flush=True)
    if rel > SIMT_RTOL[_dt(dtype)] or \
            not bool(torch.isfinite(out.float()).all()):
        fail(f"{name} disagrees with the dense version: {rec}")
    return rec


def simt_decode_phase(torch, timer, quantized, seed=4950):
    """``paged_decode_simt.cuh`` on float32 queries over float32 (or int8)
    pools at chip_smoke's shape (16-page tables, lens 1 to 256: the
    record of the kernel) and, under ``engine_a``, at engine A's shape
    (128-page tables, lens 1 to 2048) in float32 and fp16 pools (or int8
    pools with float32 queries), beside bf16 B6 (or B6q) on the same
    shape in this process (``beside``: its record from ``decode_phase``,
    the yardstick the tensor cores set)."""
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_chunked)
    name = "paged_decode_simt_q" if quantized else "paged_decode_simt"
    short = np.linspace(1, 256, 8).astype(np.int64)
    rec = simt_decode_case(torch, timer, name, torch.float32, quantized,
                           16, short, seed)
    long = np.linspace(1, 2048, 8).astype(np.int64)
    dtypes = (torch.float32,) if quantized else (torch.float32,
                                                 torch.float16)
    rec["engine_a"] = {
        _dt(dt): simt_decode_case(torch, timer, name, dt, quantized, 128,
                                  long, seed + 1) for dt in dtypes}
    rec["engine_a"]["beside"] = decode_phase(
        torch, timer, "paged_decode_split_q" if quantized else
        "paged_decode_split", paged_decode_attention_chunked, 8, 128, long,
        seed + 1, quantized=quantized)
    return rec


def simt_qmm_phase(torch, timer, M=FAULT_PROMPTS[-1], N=14336, K=4096,
                   seed=4980):
    """B7 for float32 and fp16 x at the float32 Llama's prefill gate/up
    shape (M 300) and at decode (M 8), against ``quant_matmul_plain``:
    ``quant_matmul_x3`` (three bf16 pieces of x; at M 300 with its split
    pass, also timed alone) and ``quant_matmul_f16``, each beside the CUDA
    cores' ``quant_matmul_simt`` on the same x, ``F.linear`` on a copy of
    w * s in x's dtype made outside the timed call (TF32 off), and bf16
    B7 at the same shape, in this run; bounds at 330 TFLOP/s (float32:
    three bf16 products a float32 one) and 989 (fp16). Also
    ``quant_matmul_simt`` itself (float32 x, M 300: the record of the
    CUDA cores' kernel) and at K 4100 with float32, fp16 and bf16 x, each
    beside ``F.linear`` on a copy of w * s in x's dtype. Cold L2. Returns
    the records by kernel name."""
    from paddle_tpu_torch.kernels.flash_attention import split_bf16x3_cuda
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_f16, quant_matmul_plain, quant_matmul_simt,
        quant_matmul_x3)
    F = torch.nn.functional
    _, w, s = qmm_inputs(torch, M, N, K, seed)
    # x in full float32 (a bf16 x's lower pieces would be zero)
    x = torch.randn(M, K, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(seed))
    xb = x.bfloat16()
    run = lambda: quant_matmul_simt(x, w, s)
    rel, diff = rel_err(run(), quant_matmul_plain(x, w, s))
    ms = timer(run, cold=True, iters=10)
    plain_ms = timer(lambda: quant_matmul_plain(x, w, s), cold=True,
                     iters=10)
    wf = w.float() * s[:, None]
    library_ms = timer(lambda: F.linear(x, wf), cold=True, iters=10)
    nbytes = M * K * 4 + N * K + N * 4 + M * N * 4
    bms, by = bound(nbytes, 2 * M * N * K, F32_FLOPS_PER_S)
    simt = dict(dtype="float32", M=M, N=N, K=K, max_abs_err=diff,
                rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library="F.linear on a float32 copy of w*s", bound_ms=bms,
                bound_by=by, share_of_bound=bms / ms)
    print(f"quant_matmul_simt float32 M={M} N={N} K={K}: err {diff:.3e} "
          f"(rel {rel:.3e}) | kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
          f"F.linear {library_ms:.4f} ms bound {bms:.4f} ms ({by})",
          flush=True)
    if rel > SIMT_RTOL["float32"]:
        fail(f"quant_matmul_simt disagrees with the plain version: {simt}")
    recs = {"quant_matmul_simt": simt}
    for name, dtype, fn, peak in (
            ("quant_matmul_f32", torch.float32, quant_matmul_x3,
             F32_QMM_FLOPS_PER_S),
            ("quant_matmul_f16", torch.float16, quant_matmul_f16,
             BF16_FLOPS_PER_S)):
        wd = wf.to(dtype)
        cases = {}
        for m in (M, 8):
            xm = x[:m].to(dtype)
            xbm = xb[:m].contiguous()
            run = lambda: fn(xm, w, s)
            rel, diff = rel_err(run(), quant_matmul_plain(xm, w, s))
            lib = lambda: F.linear(xm, wd)
            nb = xm.element_size()
            bms, by = bound(m * K * nb + N * K + N * 4 + m * N * nb,
                            2 * m * N * K, peak)
            ms = timer(run, cold=True)
            rec = dict(dtype=_dt(dtype), M=m, N=N, K=K, max_abs_err=diff,
                       rel_err=rel, ms=ms,
                       graph_ms=timer.graph(run, cold=True),
                       library_ms=timer(lib, cold=True),
                       library_graph_ms=timer.graph(lib, cold=True),
                       library=f"F.linear on a {_dt(dtype)} copy of w*s",
                       bf16_ms=timer(lambda: quant_matmul(xbm, w, s),
                                     cold=True),
                       bf16_graph_ms=timer.graph(
                           lambda: quant_matmul(xbm, w, s), cold=True),
                       cuda_cores_ms=timer(lambda: quant_matmul_simt(
                           xm, w, s), cold=True, iters=10),
                       bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
            if m == M:
                rec["plain_ms"] = timer(lambda: quant_matmul_plain(xm, w, s),
                                        cold=True, iters=10)
                if dtype == torch.float32:
                    rec["split_ms"] = timer(lambda: split_bf16x3_cuda(
                        xm.view(1, m, 1, K)), cold=True)
            print(f"{name} M={m} N={N} K={K}: err {diff:.3e} (rel "
                  f"{rel:.3e}) | kernel {ms:.4f} ms (graph "
                  f"{rec['graph_ms']:.4f}) bf16 B7 {rec['bf16_ms']:.4f} "
                  f"(graph {rec['bf16_graph_ms']:.4f}) CUDA cores "
                  f"{rec['cuda_cores_ms']:.4f} F.linear "
                  f"{rec['library_ms']:.4f} (graph "
                  f"{rec['library_graph_ms']:.4f}) bound {bms:.4f} ms ({by})"
                  + (f" split {rec['split_ms']:.4f}" if "split_ms" in rec
                     else ""), flush=True)
            if rel > SIMT_RTOL[_dt(dtype)] or \
                    not bool(torch.isfinite(run().float()).all()):
                fail(f"{name} disagrees with the plain version: {rec}")
            cases[m] = rec
        recs[name] = dict(cases[M], decode=cases[8])
        del wd
    del wf
    # the CUDA cores' kernel at a K not a multiple of 16, which it served
    # until the ragged loader (unaligned_qmm_phase times B7 there)
    k2 = K + 4
    x2, w2, s2 = qmm_inputs(torch, M, N, k2, seed + 1)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        xd = x2.to(dtype)
        run = lambda: quant_matmul_simt(xd, w2, s2)
        rel, diff = rel_err(run(), quant_matmul_plain(xd, w2, s2))
        nb = xd.element_size()
        bms, by = bound(M * k2 * nb + N * k2 + N * 4 + M * N * nb,
                        2 * M * N * k2, F32_FLOPS_PER_S)
        ms = timer(run, cold=True, iters=10)
        # the library yardstick: F.linear on a copy of w * s in x's dtype,
        # made outside the timed call
        wd = (w2.float() * s2[:, None]).to(dtype)
        library_ms = timer(lambda: F.linear(xd, wd), cold=True, iters=10)
        del wd
        simt[f"k{k2}_{_dt(dtype)}"] = dict(
            M=M, N=N, K=k2, rel_err=rel, max_abs_err=diff, ms=ms,
            library_ms=library_ms,
            library=f"F.linear on a {_dt(dtype)} copy of w*s",
            bound_ms=bms, bound_by=by)
        print(f"quant_matmul_simt {_dt(dtype)} M={M} N={N} K={k2}: err "
              f"{diff:.3e} (rel {rel:.3e}) | kernel {ms:.4f} ms F.linear "
              f"{library_ms:.4f} ms bound {bms:.4f} ms ({by})", flush=True)
        if rel > SIMT_RTOL[_dt(dtype)]:
            fail(f"quant_matmul_simt at K {k2} disagrees with the plain "
                 f"version: {simt}")
    return recs


# the forward above head dim 128, timed: (D, B, S, Hq, Hk) at the faults'
# D 160, at Gemma-2 9B's attention widths (D 256, Hq 16, Hk 8) and at D 384
# with the xl path's heads
WIDE_FWD_CASES = ((160, 1, 1024, WIDE_HQ, WIDE_HK), (256, 1, 2048, 16, 8),
                  (384, 1, XL_S, WIDE_HQ, WIDE_HK))


def wide_fwd_phase(torch, timer):
    """B1 in float32 (three bf16 pieces: the tc kernel's 16-key stages up
    to 256, the xl kernel above) and fp16 (the D 256 kernel, or the xl
    kernel above 256) above head dim 128, causal, at
    WIDE_FWD_CASES: the kernel on its padded operands (CUDA events and
    graph replays) and float32's whole call (three splits and B1), beside
    the CUDA cores' forward (``flash_simt_fwd_cuda``) at the true D, one
    SDPA forward in the same dtype and the plain forward; the per-row
    error and LSE's against the plain forward; bounds on the tensor cores
    at the true D (float32 at 165 TFLOP/s, six bf16 products a float32
    one; fp16 at 989). Returns {kernel name: its record at the first case
    it runs, the others under "cases"}."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_fwd_cuda, flash_fwd_x3_cuda,
        flash_simt_fwd_cuda, flash_split_fwd_cuda, pad_head_dim,
        padded_head_dim, split_bf16x3_cuda)
    recs = {}
    for dh, B, S, hq, hk in WIDE_FWD_CASES:
        dp = padded_head_dim(dh)
        sc = 1.0 / math.sqrt(dh)
        g = torch.Generator(device=DEVICE).manual_seed(5000 + dh)
        base = [torch.randn(B, S, h, dh, generator=g, device=DEVICE)
                for h in (hq, hk, hk)]
        fl = 2 * dh * hq * (B * S * (S + 1) // 2)
        for dtype in (torch.float32, torch.float16):
            q, k, v = (t.to(dtype) for t in base)
            if dtype == torch.float32:
                name = "flash_fwd_f32" if dp <= 256 else "flash_fwd_f32_xl"
                peak = F32_SPLIT_FLOPS_PER_S
                ops = [split_bf16x3_cuda(t, dp) for t in (q, k, v)]
                run = lambda: flash_fwd_x3_cuda(*ops, True, scale=sc)
                whole = lambda: flash_split_fwd_cuda(q, k, v, True, scale=sc,
                                                     dp=dp)
            else:
                name = "flash_fwd_f16_256" if dp == 256 else \
                    "flash_fwd_f16_xl"
                peak = BF16_FLOPS_PER_S
                ops = [pad_head_dim(t, dp) for t in (q, k, v)]
                run = whole = lambda: flash_fwd_cuda(*ops, True, scale=sc)
            o, lse = run()
            o_ref, lse_ref = flash_attention_plain(q, k, v, causal=True,
                                                   return_lse=True)
            torch.cuda.synchronize()
            o = o[..., :dh]
            rel = row_rel_err(o, o_ref)
            diff = (o.float() - o_ref.float()).abs().max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            finite = bool(torch.isfinite(o.float()).all())
            del o, lse, o_ref, lse_ref
            es = q.element_size()
            bms, by = bound(2 * q.numel() * es + 2 * k.numel() * es
                            + B * S * hq * 4, 2 * fl, peak)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ms = timer(run)
            rec = dict(
                B=B, S=S, Hq=hq, Hk=hk, D=dh, padded_to=dp, causal=True,
                dtype=_dt(dtype), rel_err=rel, max_abs_err=diff,
                lse_abs_err=lse_err, ms=ms, graph_ms=timer.graph(run),
                whole_call_ms=timer(whole),
                cuda_cores_ms=timer(lambda: flash_simt_fwd_cuda(
                    q, k, v, True), iters=10),
                plain_ms=timer(lambda: flash_attention_plain(
                    q, k, v, causal=True, return_lse=True), iters=10),
                library_ms=timer(sdpa_library(torch, qt, kt, vt,
                                              is_causal=True), iters=10),
                library=f"F.scaled_dot_product_attention, {_dt(dtype)}",
                bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
            print(f"{name} D {dh} (run at {dp}) B={B} S={S} Hq={hq} Hk={hk} "
                  f"causal: err {diff:.3e} (row rel {rel:.3e}, LSE "
                  f"{lse_err:.3e}) | kernel {ms:.4f} ms (graph "
                  f"{rec['graph_ms']:.4f}), whole call "
                  f"{rec['whole_call_ms']:.4f} ms, CUDA cores "
                  f"{rec['cuda_cores_ms']:.4f} ms, sdpa "
                  f"{rec['library_ms']:.4f} ms, plain {rec['plain_ms']:.4f} "
                  f"ms, bound {bms:.4f} ms ({by})", flush=True)
            if rel > SIMT_RTOL[_dt(dtype)] or lse_err > 1e-3 or not finite:
                fail(f"{name} at D {dh} disagrees with the plain forward: "
                     f"{rec}")
            if name in recs:
                recs[name].setdefault("cases", []).append(rec)
            else:
                recs[name] = rec
            del ops, q, k, v, qt, kt, vt
        del base
    return recs


def unaligned_qmm_phase(torch, timer, M=FAULT_PROMPTS[-1], N=14336, K=4100,
                        seed=4990):
    """B7 through the ragged loader at K 4100 (not a multiple of 16) for
    bf16, fp16 and float32 x at prefill (M 300; float32 with its split
    pass, which pads the pieces' K to 4112, also timed alone) and decode
    (M 8), against ``quant_matmul_plain``: CUDA events and graph replays,
    cold L2, beside the CUDA cores' ``quant_matmul_simt`` on the same x,
    ``F.linear`` on a copy of w * s in x's dtype made outside the timed
    call, and B7 at K 4096 (the aligned loaders) for the same M and x
    dtype, in this run; bounds at 989 TFLOP/s (bf16, fp16) and 330
    (float32: three bf16 products a float32 one). Returns the records by
    kernel name, the decode case under "decode"."""
    from paddle_tpu_torch.kernels.flash_attention import split_bf16x3_cuda
    from paddle_tpu_torch.kernels.quant_matmul import (
        K_ALIGN, quant_matmul, quant_matmul_f16, quant_matmul_plain,
        quant_matmul_simt, quant_matmul_x3)
    F = torch.nn.functional
    ka = K - K % K_ALIGN
    _, w, s = qmm_inputs(torch, M, N, K, seed)
    _, wa, sa = qmm_inputs(torch, M, N, ka, seed + 1)
    x = torch.randn(M, K, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(seed))
    wf = w.float() * s[:, None]
    recs = {}
    for name, dtype, fn, peak in (
            ("quant_matmul_unaligned", torch.bfloat16, quant_matmul,
             BF16_FLOPS_PER_S),
            ("quant_matmul_f16_unaligned", torch.float16, quant_matmul_f16,
             BF16_FLOPS_PER_S),
            ("quant_matmul_f32_unaligned", torch.float32, quant_matmul_x3,
             F32_QMM_FLOPS_PER_S)):
        wd = wf.to(dtype)
        cases = {}
        for m in (M, 8):
            xm = x[:m].to(dtype)
            xa = x[:m, :ka].to(dtype).contiguous()
            run = lambda: fn(xm, w, s)
            rel, diff = rel_err(run(), quant_matmul_plain(xm, w, s))
            lib = lambda: F.linear(xm, wd)
            aligned = lambda: fn(xa, wa, sa)
            nb = xm.element_size()
            bms, by = bound(m * K * nb + N * K + N * 4 + m * N * nb,
                            2 * m * N * K, peak)
            ms = timer(run, cold=True)
            rec = dict(dtype=_dt(dtype), M=m, N=N, K=K, max_abs_err=diff,
                       rel_err=rel, ms=ms,
                       graph_ms=timer.graph(run, cold=True),
                       plain_ms=timer(lambda: quant_matmul_plain(xm, w, s),
                                      cold=True, iters=10),
                       library_ms=timer(lib, cold=True),
                       library_graph_ms=timer.graph(lib, cold=True),
                       library=f"F.linear on a {_dt(dtype)} copy of w*s",
                       aligned_k=ka, aligned_ms=timer(aligned, cold=True),
                       aligned_graph_ms=timer.graph(aligned, cold=True),
                       cuda_cores_ms=timer(lambda: quant_matmul_simt(
                           xm, w, s), cold=True, iters=10),
                       bound_ms=bms, bound_by=by, share_of_bound=bms / ms)
            if m > 8 and dtype == torch.float32:
                rec["split_ms"] = timer(lambda: split_bf16x3_cuda(
                    xm.view(1, m, 1, K), -(-K // K_ALIGN) * K_ALIGN),
                    cold=True)
            print(f"{name} M={m} N={N} K={K}: err {diff:.3e} (rel "
                  f"{rel:.3e}) | kernel {ms:.4f} ms (graph "
                  f"{rec['graph_ms']:.4f}) at K {ka} "
                  f"{rec['aligned_ms']:.4f} (graph "
                  f"{rec['aligned_graph_ms']:.4f}) CUDA cores "
                  f"{rec['cuda_cores_ms']:.4f} F.linear "
                  f"{rec['library_ms']:.4f} (graph "
                  f"{rec['library_graph_ms']:.4f}) bound {bms:.4f} ms ({by})"
                  + (f" split {rec['split_ms']:.4f}" if "split_ms" in rec
                     else ""), flush=True)
            if rel > SIMT_RTOL[_dt(dtype)] or \
                    not bool(torch.isfinite(run().float()).all()):
                fail(f"{name} disagrees with the plain version: {rec}")
            cases[m] = rec
        recs[name] = dict(cases[M], decode=cases[8])
        del wd
    del wf
    return recs


def direct_simt(torch):
    """The CUDA cores' forward and int8 matmul are on no route (the tensor
    cores take float32 and fp16 at every head dim, and B7 every K): each
    is launched here directly (the forward in float32 and fp16 at the
    faults' D 160 over 256 positions; the matmul at K 4100, M 64, in
    float32, fp16 and bf16) and held against its plain version within
    SIMT_RTOL, so that every kernel of SIMT_KERNELS is launched; their
    times come from simt_flash_phase, simt_fwd_wide and simt_qmm_phase."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_plain, flash_simt_fwd_cuda)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_matmul_plain, quant_matmul_simt)
    g = torch.Generator(device=DEVICE).manual_seed(4970)
    _, w, s = qmm_inputs(torch, 64, 1024, 4100, 4971)
    recs = []
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        if dtype != torch.bfloat16:
            q, k, v = (torch.randn(1, 256, h, 160, generator=g,
                                   device=DEVICE).to(dtype)
                       for h in (WIDE_HQ, WIDE_HK, WIDE_HK))
            o, _ = flash_simt_fwd_cuda(q, k, v, causal=True)
            recs.append(dict(kernel="flash_simt_fwd", dtype=_dt(dtype),
                             D=160, S=256, rel_err=row_rel_err(
                                 o, flash_attention_plain(q, k, v,
                                                          causal=True))))
        x = torch.randn(64, 4100, generator=g, device=DEVICE).to(dtype)
        recs.append(dict(kernel="quant_matmul_simt", dtype=_dt(dtype), M=64,
                         K=4100, rel_err=rel_err(quant_matmul_simt(x, w, s),
                                                 quant_matmul_plain(x, w,
                                                                    s))[0]))
    torch.cuda.synchronize()
    for rec in recs:
        print(f"direct {rec}", flush=True)
        if not rec["rel_err"] <= SIMT_RTOL[rec["dtype"]]:
            fail(f"{rec['kernel']} disagrees with its plain version: {rec}")
    return recs


def faults_phase(torch):
    """The route faults: calls the bf16 tensor-core kernels do not take,
    each sent to its route before any launch and counted there. The
    counts are zeroed before the calls and read after (``launches``: the
    SIMT_KERNELS' launches on these paths, and the direct launches of the
    two CUDA-core kernels no route takes); then each of those kernels is
    timed (``timed``), launches not counted. FlashAttention above head dim
    128 runs at the faults' D 160 (B 1, S 1024, Hq 16, Hk 4), at Gemma-2
    9B's widths (D 256, B 1, S 2048, Hq 16, Hk 8) and at the xl path's
    D 288 (B 1, S 2048, Hq 16, Hk 4), in float32 and fp16: the forward on
    the tensor cores, the backward on the CUDA cores."""
    t0 = [time.perf_counter()]

    def lap(part):  # the seconds of each part, for the run's budget
        t = time.perf_counter()
        print(f"faults {part}: {t - t0[0]:.1f} s", flush=True)
        t0[0] = t

    zero_counts()
    wide = ((160, 1024, WIDE_HQ, WIDE_HK), (256, 2048, 16, 8),
            (XL_D, XL_S, WIDE_HQ, WIDE_HK))
    flash = [fault_flash(torch, torch.float32, HQ, HK, "split"),
             fault_flash(torch, torch.float16, HQ, HK, "f16"),
             fault_flash(torch, torch.float32, 24, HK, "split", dh=80),
             *(fault_flash(torch, dtype, hq, hk, route, B=1, S=S, dh=dh,
                           bwd_route="simt")
               for dh, S, hq, hk in wide
               for dtype, route in ((torch.float32, "split"),
                                    (torch.float16, "f16"))),
             fault_flash(torch, torch.bfloat16, 24, HK, "expanded")]
    lap("flash")
    decode = [fault_decode(torch, hq, hk, dh, getattr(torch, dt),
                           quantized, pages)
              for hq, hk, dh, dt, pages in FAULT_DECODE
              for quantized in (False, True)]
    linear = [fault_int8_linear(torch, torch.float32, 4096, "split"),
              fault_int8_linear(torch, torch.float16, 4096, "f16"),
              *(fault_int8_linear(torch, dtype, 4100, route, M=m)
                for m in (FAULT_PROMPTS[-1], 8)
                for dtype, route in ((torch.bfloat16, "unaligned"),
                                     (torch.float16, "f16_unaligned"),
                                     (torch.float32, "split_unaligned")))]
    lap("decode, int8 linear")
    llama = fault_llama(torch)
    direct = direct_simt(torch)
    launches, _ = read_counts()
    lap("llama, direct")
    missing = [n for n, _, _ in SIMT_KERNELS if launches[n] < 1]
    if missing:
        fail(f"the faults paths never launched {missing}: {launches}")
    timer = Timer(torch)
    timed = simt_flash_phase(torch, timer)
    lap("timed flash")
    timed["paged_decode_simt"] = simt_decode_phase(torch, timer, False)
    timed["paged_decode_simt_q"] = simt_decode_phase(torch, timer, True)
    timed.update(simt_qmm_phase(torch, timer))
    lap("timed decode, int8 linear")
    for name, rec in wide_fwd_phase(torch, timer).items():
        if name in timed:  # beside the kernel's record at D 128
            timed[name].setdefault("cases", []).extend(
                [rec] + rec.pop("cases", []))
        else:
            timed[name] = rec
    lap("timed wide forward")
    timed.update(unaligned_qmm_phase(torch, timer))
    lap("timed ragged B7")
    del timer
    torch.cuda.empty_cache()
    return dict(flash=flash, decode=decode, int8_linear=linear, llama=llama,
                direct=direct,
                launches={n: launches[n] for n, _, _ in SIMT_KERNELS},
                timed=timed)


def simt_records(faults, gpt32):
    """The ``kernels`` entries of SIMT_KERNELS: launches from the faults
    paths and the float32 GPT run, times and bounds from their timed
    shapes."""
    records = []
    for name, source, replaces in SIMT_KERNELS:
        r = faults["timed"][name]
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=faults["launches"][name] + gpt32["launches"][name],
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], timed_at={k: r[k] for k in r if k in (
                "dtype", "pools", "B", "S", "Hq", "Hk", "D", "M", "N", "K",
                "mbps", "causal")},
            **{k: r[k] for k in r if k in (
                "graph_ms", "share_of_bound", "library",
                "bound_cuda_cores_ms", "cuda_cores_ms", "bf16_ms",
                "bf16_graph_ms", "four_ms", "whole_call_ms", "split_ms",
                "library_graph_ms", "fp16_ms", "sdpa_fp16_ms", "decode",
                "d160", "engine_a", "plan", "cases", "padded_to",
                "aligned_k", "aligned_ms", "aligned_graph_ms",
                "lse_abs_err") or k.startswith("k4100")}))
    return records


# ---------------------------------------------------------------------------
# varlen phase: packed sequences through the segment branch of B1-B3
# ---------------------------------------------------------------------------

def varlen_lengths(seed, total, longest, ones=1):
    """Sequence lengths drawn uniform in 1..``longest`` from a seeded numpy
    generator until they fill ``total`` tokens, the last one cut to fit;
    ``ones`` 1-token sequences are put first."""
    rng = np.random.default_rng(seed)
    lens = [1] * ones
    while sum(lens) < total:
        lens.append(int(rng.integers(1, longest + 1)))
    lens[-1] -= sum(lens) - total
    return [n for n in lens if n > 0]


def visible_pairs(torch, seg, causal):
    """The (query, key) pairs the segment mask lets through, counted
    exactly from this run's ids and positions: per query, the keys of its
    segment (at a position not after its own, if causal), found by binary
    search over the keys sorted by (id, position)."""
    qseg, kseg, qpos, kpos = (t.long() for t in seg)
    off = 1 << 31   # positions may be negative (the bottom-right shift)
    total = 0
    for b in range(qseg.shape[0]):
        keys = torch.sort((kseg[b] << 32) + kpos[b] + off).values
        lo = torch.searchsorted(keys, qseg[b] << 32)
        hi = torch.searchsorted(
            keys, (qseg[b] << 32) + (qpos[b] + off if causal else
                                     (1 << 32) - 1), right=True)
        total += int((hi - lo).sum().item())
    return total


def varlen_library(torch, case, q, k, v, do):
    """One PyTorch call computing the case's function, and its backward:
    ``torch.nn.attention.varlen.varlen_attn`` on the packed row where this
    torch has it and can say the case (causal through ``window_size`` or
    ``is_causal``; KV expanded to Hq heads once, outside the timed call,
    where it has no ``enable_gqa``), else SDPA over the batch with a
    boolean mask built from the ids and positions. The port never calls
    either. Returns (what was timed, forward, backward) callables."""
    import inspect
    F = torch.nn.functional
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    why = "the case has no cu_seqlens"
    if case.get("cu_q") is not None:
        try:
            from torch.nn.attention.varlen import varlen_attn
            params = inspect.signature(varlen_attn).parameters
            kw, what = {}, "torch.nn.attention.varlen.varlen_attn"
            if "scale" in params:
                kw["scale"] = case["scale"]
            elif case["scale"] != 1.0 / math.sqrt(q.shape[-1]):
                raise TypeError("no scale argument")
            if "window_size" in params:
                kw["window_size"] = (-1, 0) if case["causal"] else (-1, -1)
            elif "is_causal" in params:
                kw["is_causal"] = case["causal"]
            elif case["causal"]:
                raise TypeError("no way to ask for causal masking")
            g = q.shape[2] // k.shape[2]
            kx, vx = ks[0], vs[0]
            if "enable_gqa" in params:
                kw["enable_gqa"] = True
            elif g > 1:
                kx = ks[0].repeat_interleave(g, dim=1)
                vx = vs[0].repeat_interleave(g, dim=1)
                what += f" (KV expanded {g}x outside the timed call)"
            args = (case["cu_q"], case["cu_k"], case["max_q"],
                    case["max_k"])
            fwd = lambda: varlen_attn(qs[0], kx, vx, *args, **kw)
            out = fwd()
            torch.autograd.grad(out, (qs, ks, vs), do[0], retain_graph=True)
            torch.cuda.synchronize()
            return (what, fwd,
                    lambda: torch.autograd.grad(out, (qs, ks, vs), do[0],
                                                retain_graph=True))
        except Exception as e:  # the yardstick only: record and go on
            why = f"varlen_attn refused it: {type(e).__name__}: {e}"[:300]
    print(f"varlen library: masked SDPA ({why})", flush=True)
    qseg, kseg, qpos, kpos = case["seg"]
    mask = qseg[:, :, None] == kseg[:, None, :]
    if case["causal"]:
        mask &= qpos[:, :, None] >= kpos[:, None, :]
    mask = mask[:, None]
    tr = lambda t: t.transpose(1, 2)
    fwd = lambda: F.scaled_dot_product_attention(
        tr(qs), tr(ks), tr(vs), attn_mask=mask, scale=case["scale"],
        enable_gqa=True)
    out = fwd()
    return ("F.scaled_dot_product_attention with a boolean segment mask",
            fwd, lambda: torch.autograd.grad(out, (qs, ks, vs), tr(do),
                                             retain_graph=True))


def tile_pair_counts(torch, seg, causal, hq, hk):
    """How the segment kernels classify this run's (query block, key
    tile) pairs (``pair_classes``): skip, masked and full counts over the
    batch, for the blocks of 64 / G positions that B1 and B2 share (``dq``)
    and B3's 64-row query tiles."""
    from paddle_tpu_torch.kernels.flash_attention import (
        FULL, MASKED, SKIP, pair_classes, tile_bounds)
    qseg, kseg, qpos, kpos = seg
    kb = tile_bounds(kseg, kpos)
    out = {}
    for name, block in (("dq", 64 * hk // hq), ("dkv", 64)):
        cls = pair_classes(tile_bounds(qseg, qpos, block), kb, causal)
        out[name] = {lab: int((cls == c).sum().item())
                     for lab, c in (("skip", SKIP), ("masked", MASKED),
                                    ("full", FULL))}
    return out


def varlen_case(torch, timer, name, case):
    """One varlen case: the public entry point with ``requires_grad``
    inputs (counts zeroed just before, read just after: B1-seg, B2-seg and
    B3-seg once each, no dense launch), then the kernels held against the
    plain pair (forward per query row, dQ/dK/dV relative), the proof that
    the check sees one missing 64-key run, times and bounds."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_plain, flash_bwd_cuda,
        flash_bwd_dkv_cuda, flash_bwd_dq_cuda, flash_delta, flash_fwd_cuda)
    q, k, v, do = case["q"], case["k"], case["v"], case["do"]
    causal, scale, seg = case["causal"], case["scale"], case["seg"]
    kw = dict(scale=scale, q_segment_ids=seg[0], kv_segment_ids=seg[1],
              q_positions=seg[2], kv_positions=seg[3])
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    zero_counts()
    out = case["call"](*leaves)
    out.backward(do[0] if case.get("cu_q") is not None else do)
    torch.cuda.synchronize()
    launches, _ = read_counts()
    want = dict.fromkeys(launches, 0)
    want.update({"B1-seg": 1, "B2-seg": 1, "B3-seg": 1})
    for kname, n in want.items():
        if launches[kname] != n:
            fail(f"varlen {name}: {kname} launched {launches[kname]} times "
                 f"on the public path, expected {n}")
    if case.get("cu_q") is not None:
        out = out[None]
    grads = [t.grad for t in leaves]

    o_k, lse_k = flash_fwd_cuda(q, k, v, causal, **kw)
    o_ref, lse_ref = flash_attention_plain(q, k, v, causal,
                                           return_lse=True, **kw)
    refs = flash_attention_bwd_plain(q, k, v, o_k, lse_k, do, causal, **kw)
    torch.cuda.synchronize()
    err_o = (out.float() - o_ref.float()).abs().max().item()
    err_row = row_rel_err(out, o_ref)
    err_l = (lse_k - lse_ref).abs().max().item()
    same = bool(torch.equal(out, o_k))
    finite = bool(torch.isfinite(out.float()).all())
    errs = {}
    for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
        diff = (g.float() - r.float()).abs().max().item()
        errs[gname] = (diff, diff / max(r.float().abs().max().item(), 1e-6),
                       bool(torch.isfinite(g.float()).all()))
    del refs, grads
    # the check must see one 64-key run of the longest sequence go missing
    cut = seg[1].clone()
    a, n = case["longest"]
    a += max(0, n - 64) // 2
    cut[:, a:a + 64] = -7
    o_cut = flash_attention_plain(q, k, v, causal, scale=scale,
                                  q_segment_ids=seg[0], kv_segment_ids=cut,
                                  q_positions=seg[2], kv_positions=seg[3])
    cut_row = row_rel_err(o_cut, o_ref)
    del o_cut, cut
    ok = err_row <= ROW_RTOL and err_o <= O_ATOL and err_l <= LSE_ATOL \
        and finite and same and all(
            e[1] <= BWD_RTOL and e[2] for e in errs.values())
    if cut_row <= ROW_RTOL:
        fail(f"varlen {name}: the check cannot see a missing run of 64 "
             f"keys ({cut_row} <= {ROW_RTOL})")

    delta = flash_delta(o_k, do)
    fwd = lambda: flash_fwd_cuda(q, k, v, causal, **kw)
    dq_call = lambda: flash_bwd_dq_cuda(q, k, v, do, lse_k, delta, causal,
                                        **kw)
    dkv_call = lambda: flash_bwd_dkv_cuda(q, k, v, do, lse_k, delta, causal,
                                          **kw)

    def fwd_bwd():
        o, lse = flash_fwd_cuda(q, k, v, causal, **kw)
        flash_bwd_cuda(q, k, v, o, lse, do, causal, **kw)

    def public():
        ls = [t.detach().requires_grad_() for t in (q, k, v)]
        o = case["call"](*ls)
        torch.autograd.grad(o, ls, do[0] if case.get("cu_q") is not None
                            else do)

    t = {}
    for key, fn in (("fwd", fwd), ("dq", dq_call), ("dkv", dkv_call),
                    ("fwd_bwd", fwd_bwd)):
        t[key] = timer(fn, iters=20)
        t[key + "_graph"] = timer.graph(fn, iters=20)
    t["public_fwd_bwd"] = timer(public, iters=10)
    t["plain_fwd"] = timer(lambda: flash_attention_plain(
        q, k, v, causal, return_lse=True, **kw), iters=3, warmup=1)
    t["plain_bwd"] = timer(lambda: flash_attention_bwd_plain(
        q, k, v, o_k, lse_k, do, causal, **kw), iters=3, warmup=1)
    lib_name, lib_fwd, lib_bwd = varlen_library(torch, case, q, k, v, do)
    t["library_fwd"] = timer(lib_fwd, iters=10)
    t["library_bwd"] = timer(lib_bwd, iters=10)
    t["library_fwd_bwd"] = t["library_fwd"] + t["library_bwd"]

    B, Sq, Hq, dh = q.shape
    pairs = visible_pairs(torch, seg, causal)
    fl = 2 * dh * Hq * pairs           # one product over the visible pairs
    qb, kvb = q.numel() * 2, k.numel() * 2
    idb = sum(x.numel() for x in seg) * 4
    bb = bwd_bounds(q, k, lse_k, pairs, idb)
    bounds = {"fwd": bound(2 * qb + 2 * kvb + idb, 2 * fl),
              "dq": bb["flash_bwd_dq"], "dkv": bb["flash_bwd_dkv"],
              "fwd_bwd": bound(2 * qb + 2 * kvb + idb, 7 * fl)}
    shares = {n: bounds[n][0] / t[n + "_graph"] for n in ("dq", "dkv")}
    dense_pairs = B * Sq * k.shape[1]
    if causal and Sq == k.shape[1]:
        dense_pairs = B * Sq * (Sq + 1) // 2
    rec = dict(B=B, Tq=Sq, Tk=k.shape[1], Hq=Hq, Hk=k.shape[2], D=dh,
               causal=causal, scale=scale, lens_q=case.get("lens_q"),
               lens_k=case.get("lens_k"), visible_pairs=pairs,
               dense_pairs=dense_pairs, max_abs_err=err_o, lse_err=err_l,
               row_rel_err=err_row, missing_run_row_rel_err=cut_row,
               grad_errs={n: dict(abs=e[0], rel=e[1])
                          for n, e in errs.items()},
               public_equals_kernel=same, launches=launches, times_ms=t,
               library=lib_name,
               bounds_ms={n: dict(ms=b[0], by=b[1])
                          for n, b in bounds.items()},
               graph_share_of_bound=shares,
               tile_pairs=tile_pair_counts(torch, seg, causal, Hq, k.shape[2]),
               ok=ok)
    print(f"varlen {name}: Tq {Sq} Tk {k.shape[1]} Hq {Hq} Hk "
          f"{k.shape[2]} D {dh} causal {causal}: {pairs} visible pairs "
          f"(dense {dense_pairs}) | err O {err_o:.3e} row {err_row:.3e} "
          f"LSE {err_l:.3e} dq/dk/dv rel "
          f"{'/'.join(f'{e[1]:.2e}' for e in errs.values())} (64 keys "
          f"missing: row {cut_row:.3e}) | ms {json.dumps(t)} | bound "
          f"{json.dumps({n: round(b[0], 5) for n, b in bounds.items()})} "
          f"(B2, B3 graphs at {shares['dq']:.1%}, {shares['dkv']:.1%} of "
          f"it) | tile pairs {json.dumps(rec['tile_pairs'])} | library: "
          f"{lib_name}", flush=True)
    if not ok:
        fail(f"varlen {name}: the kernels disagree with the plain pair: O "
             f"row {err_row} (limit {ROW_RTOL}), abs {err_o} ({O_ATOL}), "
             f"LSE {err_l} ({LSE_ATOL}), grads {errs} ({BWD_RTOL}), public "
             f"path equals the kernel: {same}")
    return rec


def varlen_cases(torch):
    """The varlen phase's cases, in order, as ``varlen_case`` takes them.
    V1: Llama-3-8B width (Hq 32, Hk 8, D 128), causal, one packed row of
    8192 tokens of random lengths 1..2048 (a 1-token sequence first);
    V2: GPT-2 medium width (H 16, D 64), causal, a packed kv row of 4096
    tokens whose queries are each sequence's last min(L, 64) tokens, one
    sequence with none (the bottom-right shift); V3: ``flash_attention``
    with segment ids at B 2, S 2048, GPT-2 medium width, causal, ids
    (pos // 96) % 3 on both sides and one query id no key has; V4: V1's
    layout at Gemma-2 9B's attention widths (Hq 16, Hk 8, D 256), a packed
    row of 4096 tokens of lengths 1..1024. V1, V2 and V4 go through
    ``nn.functional.flash_attn_unpadded``, V3 through
    ``kernels.flash_attention.flash_attention``, bf16."""
    from paddle_tpu_torch.kernels.flash_attention import (
        _segments, flash_attention, varlen_segments)
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    g = torch.Generator(device=DEVICE).manual_seed(4000)
    mk = lambda *s: torch.randn(*s, generator=g, device=DEVICE,
                                dtype=torch.bfloat16)

    def packed(name, lens_q, lens_k, hq, hk, dh):
        cu = lambda ls: torch.tensor(np.concatenate([[0], np.cumsum(ls)]),
                                     device=DEVICE, dtype=torch.int32)
        cu_q, cu_k = cu(lens_q), cu(lens_k)
        tq, tk = int(sum(lens_q)), int(sum(lens_k))
        scale = 1.0 / math.sqrt(dh)
        q, k, v, do = mk(1, tq, hq, dh), mk(1, tk, hk, dh), \
            mk(1, tk, hk, dh), mk(1, tq, hq, dh)
        seg = tuple(t[None] for t in varlen_segments(cu_q, cu_k, tq, tk,
                                                     q.device))
        # the longest kv sequence that has queries
        i = int(np.argmax(np.asarray(lens_k) * (np.asarray(lens_q) > 0)))
        mq, mk_ = int(max(lens_q)), int(max(lens_k))
        call = lambda a, b, c: flash_attn_unpadded(
            a[0], b[0], c[0], cu_q, cu_k, mq, mk_, scale, causal=True)[0]
        print(f"varlen {name} lengths: q {list(map(int, lens_q))} kv "
              f"{list(map(int, lens_k))}", flush=True)
        return dict(q=q, k=k, v=v, do=do, seg=seg, causal=True, scale=scale,
                    cu_q=cu_q, cu_k=cu_k, max_q=mq, max_k=mk_, call=call,
                    lens_q=list(map(int, lens_q)),
                    lens_k=list(map(int, lens_k)),
                    longest=(int(sum(lens_k[:i])), int(lens_k[i])))

    lens = varlen_lengths(6, V1_TOKENS, V1_LONGEST)
    if not any(n % 64 for n in lens[1:]) or lens[0] != 1:
        fail(f"V1 lengths lack a 1-token sequence or a length that is not "
             f"a multiple of 64: {lens}")
    yield "V1", packed("V1", lens, lens, HQ, HK, D)

    lens_k = varlen_lengths(7, V2_TOKENS, V2_LONGEST)
    lens_q = [min(n, 64) for n in lens_k]
    lens_q[1] = 0  # a kv sequence with no queries
    yield "V2", packed("V2", lens_q, lens_k, GPT_H, GPT_H, GPT_D)

    B, S = 2, V3_SEQ
    pos = torch.arange(S, device=DEVICE, dtype=torch.int32)
    kv_ids = ((pos // 96) % 3).expand(B, S).contiguous()
    q_ids = kv_ids.clone()
    q_ids[:, S // 2:S // 2 + 40] = 3  # a query id no key has
    q_pos = pos.expand(B, S).contiguous()
    q, k, v, do = (mk(B, S, GPT_H, GPT_D) for _ in range(4))
    call = lambda a, b, c: flash_attention(
        a, b, c, causal=True, q_segment_ids=q_ids, kv_segment_ids=kv_ids,
        q_positions=q_pos)
    yield "V3", dict(
        q=q, k=k, v=v, do=do, causal=True, scale=1.0 / math.sqrt(GPT_D),
        seg=_segments(q, k, q_ids, kv_ids, q_pos, None), call=call,
        longest=(0, 96))
    del q, k, v, do

    lens = varlen_lengths(8, V4_TOKENS, V4_LONGEST)
    yield "V4", packed("V4", lens, lens, V4_HQ, V4_HK, V4_D)


def varlen_phase(torch):
    """Each of ``varlen_cases`` through ``varlen_case``."""
    timer = Timer(torch)
    recs = {}
    for name, case in varlen_cases(torch):
        recs[name] = varlen_case(torch, timer, name, case)
        del case
        gc.collect()
        torch.cuda.empty_cache()
    del timer
    return recs


def decode_inputs(torch, B, mbps, lens, seed, bs=16):
    rng = np.random.RandomState(seed)
    nb = B * mbps + 1
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=DEVICE,
                                dtype=torch.bfloat16)
    kp, vp = mk(nb, bs, HK, D), mk(nb, bs, HK, D)
    q = mk(B, HQ, D)
    tbl = np.zeros((B, mbps), np.int32)
    for i in range(B):
        need = -(-int(lens[i]) // bs)
        tbl[i, :need] = rng.permutation(np.arange(
            1 + i * mbps, 1 + (i + 1) * mbps))[:need]  # scattered blocks
    return (q, kp, vp, torch.as_tensor(tbl, device=DEVICE),
            torch.as_tensor(np.asarray(lens, np.int32), device=DEVICE))


def slot_rel_err(out, ref):
    """Per slot: max |out - ref| / max |ref|. A slot with no keys has
    ref == 0: a zero output there reads 0, any other output a huge error
    (non-finite outputs are checked apart)."""
    diff = (out.float() - ref.float()).flatten(1).abs().amax(1)
    scale = ref.float().flatten(1).abs().amax(1)
    return (diff / scale).nan_to_num(nan=0.0).max().item()


def decode_phase(torch, timer, name, wrapper, B, mbps, lens, seed,
                 quantized=False, drop_pages=1, beside=None):
    """One paged-decode kernel against ``paged_decode_attention_dense``;
    with ``quantized`` the pools are int8 rows with float32 scales
    (``quantize_rows`` of the same bf16 pools), and the library yardstick
    is SDPA over the gathered KV dequantized outside the timed call. The
    check must see ``drop_pages`` pages go missing: the plain version over
    the longest slot cut short by that many pages has to fail it.
    ``beside``, another wrapper of the same function, is timed as a graph
    replay on the same inputs (``beside_graph_ms``: the per-page kernel
    beside the split route)."""
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_dense)
    from paddle_tpu_torch.quantization import quantize_rows
    q, kp, vp, tbl, sl = decode_inputs(torch, B, mbps, lens, seed)
    scales = {}
    if quantized:
        kp, ks = quantize_rows(kp)
        vp, vs = quantize_rows(vp)
        scales = dict(k_scale=ks, v_scale=vs)
    out = wrapper(q, kp, vp, tbl, sl, **scales)
    ref = paged_decode_attention_dense(q, kp, vp, tbl, sl, **scales)
    cut = sl.clone()
    cut[int(np.argmax(lens))] -= drop_pages * kp.shape[1]
    missing = slot_rel_err(
        paged_decode_attention_dense(q, kp, vp, tbl, cut, **scales), ref)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = slot_rel_err(out, ref)
    ok = rel <= DECODE_RTOL and err <= O_ATOL and \
        bool(torch.isfinite(out.float()).all())
    if missing <= DECODE_RTOL:
        fail(f"{name}: the check cannot see {drop_pages} missing pages "
             f"({missing} <= {DECODE_RTOL})")
    ms = timer(lambda: wrapper(q, kp, vp, tbl, sl, **scales), cold=True)
    graph_ms = timer.graph(lambda: wrapper(q, kp, vp, tbl, sl, **scales),
                           cold=True)
    host_ms = timer.host(lambda: wrapper(q, kp, vp, tbl, sl, **scales))
    plain_ms = timer(lambda: paged_decode_attention_dense(
        q, kp, vp, tbl, sl, **scales), cold=True)
    bs = kp.shape[1]
    idx = tbl.long()

    def gathered(pool, scale):
        g = pool[idx]
        if scale is not None:
            g = (g.float() * scale[idx][..., None]).to(torch.bfloat16)
        return g.reshape(B, mbps * bs, HK, D).transpose(1, 2)

    kg = gathered(kp, scales.get("k_scale"))
    vg = gathered(vp, scales.get("v_scale"))
    mask = (torch.arange(mbps * bs, device=DEVICE)[None, :]
            < sl[:, None])[:, None, None, :]
    lib = sdpa_library(torch, q[:, :, None, :], kg, vg, attn_mask=mask)
    library_ms = timer(lib, cold=True)
    library_graph_ms = timer.graph(lib, cold=True)
    extra = {}
    if beside is not None:
        extra["beside_graph_ms"] = timer.graph(
            lambda: beside(q, kp, vp, tbl, sl, **scales), cold=True)
    total = int(np.sum(lens))
    row_bytes = D + 4 if quantized else D * 2  # int8 row + its f32 scale
    nbytes = 2 * q.numel() * 2 + total * HK * row_bytes * 2 \
        + tbl.numel() * 4 + sl.numel() * 4
    bms, by = bound(nbytes, 4 * HQ * D * total)
    rec = dict(B=B, mbps=mbps, lens=[int(x) for x in lens],
               pools="int8" if quantized else "bf16", max_abs_err=err,
               slot_rel_err=rel, missing_pages=drop_pages,
               missing_pages_rel_err=missing, ms=ms, graph_ms=graph_ms,
               host_ms=host_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_graph_ms=library_graph_ms, bound_ms=bms, bound_by=by,
               **extra, ok=ok)
    print(f"{name} B={B} pages={mbps} lens={list(map(int, lens))} "
          f"pools={rec['pools']}: err {err:.3e} (slot rel {rel:.3e}; "
          f"{drop_pages} pages missing: {missing:.3e}) | kernel {ms:.4f} ms "
          f"(graph {graph_ms:.4f}, host {host_ms:.4f}) plain {plain_ms:.4f} "
          f"ms sdpa {library_ms:.4f} ms (graph {library_graph_ms:.4f}) "
          f"bound {bms:.4f} ms ({by})"
          + "".join(f" {k} {v:.4f}" for k, v in extra.items()), flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version: slot relative "
             f"error {rel} (limit {DECODE_RTOL}), absolute {err} (limit "
             f"{O_ATOL})")
    return rec


def int8pack_library(torch):
    """``torch._weight_int8pack_mm`` where this build has a CUDA kernel for
    it, else None: the one PyTorch call that computes B7's function on
    B7's own bytes (int8 [N, K] weight, per-channel scales, bf16 x). A
    yardstick only; the port never calls it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None or not torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::_weight_int8pack_mm", "CUDA"):
        return None
    return fn


def qmm_inputs(torch, M, N, K, seed):
    """x [M, K] bf16 and a weight [N, K] quantized by the port's own
    ``_quantize_weight`` (bf16 scales, handed to the kernel in float32, as
    ``ConvertedInt8Linear`` does)."""
    from paddle_tpu_torch.quantization import _quantize_weight
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=DEVICE, dtype=torch.bfloat16)
    w, s = _quantize_weight(
        torch.randn(N, K, generator=g, device=DEVICE,
                    dtype=torch.bfloat16) * 0.02, 0)
    return x, w, s.float()


def rel_err(out, ref):
    """max |out - ref| / max |ref| and max |out - ref|."""
    diff = (out.float() - ref.float()).abs().max().item()
    return diff / max(ref.float().abs().max().item(), 1e-6), diff


def qmm_phase(torch, timer, M, N, K, seed, plain=True, library=True):
    """B7 against ``quant_matmul_plain`` on ``qmm_inputs``. Error: max
    |kernel - plain| / max |plain|. Times: CUDA events around the wrapper
    (``ms``), a CUDA-graph replay (``graph_ms``: the device's time without
    the wrapper's host cost) and the wrapper's host time per call
    (``host_ms``). Library yardsticks (``library``): ``F.linear`` on a bf16
    copy of w * s made outside the timed call -- the same product,
    reading twice the weight bytes -- and, where this build has it for
    CUDA, ``torch._weight_int8pack_mm`` on the int8 weight with the scales
    in bf16 (exact: they come from bf16). Cold L2: at decode every weight
    is read once per step, far more than the 50 MB L2 holds. ``plain``
    times the plain version too."""
    from paddle_tpu_torch.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
    F = torch.nn.functional
    x, w, s = qmm_inputs(torch, M, N, K, seed)
    out = quant_matmul(x, w, s)
    ref = quant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    rel, diff = rel_err(out, ref)
    ok = rel <= QMM_RTOL and bool(torch.isfinite(out.float()).all()) and \
        out.shape == (M, N)
    del out
    run = lambda: quant_matmul(x, w, s)
    rec = dict(M=M, N=N, K=K, max_abs_err=diff, rel_err=rel,
               ms=timer(run, cold=True),
               graph_ms=timer.graph(run, cold=True), host_ms=timer.host(run))
    if plain:
        rec["plain_ms"] = timer(lambda: quant_matmul_plain(x, w, s),
                                cold=True, iters=10)
    if library:
        wb = (w.float() * s[:, None]).to(torch.bfloat16)
        lib = lambda: F.linear(x, wb)
        rec.update(library_ms=timer(lib, cold=True),
                   library_graph_ms=timer.graph(lib, cold=True),
                   library="F.linear on a bf16 copy of w*s (2x the weight "
                           "bytes)")
        del wb
        pack = int8pack_library(torch)
        if pack is not None:
            sb = s.bfloat16()
            prel, _ = rel_err(pack(x, w, sb), ref)
            lib = lambda: pack(x, w, sb)
            rec.update(int8pack_ms=timer(lib, cold=True),
                       int8pack_graph_ms=timer.graph(lib, cold=True),
                       int8pack_rel_err=prel)
        rec["int8pack_cuda"] = pack is not None
    del ref
    nbytes = M * K * 2 + N * K + N * 4 + M * N * 2
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2 * M * N * K)
    rec["ok"] = ok
    shown = "".join(f" {k} {rec[k]:.4f}" for k in (
        "graph_ms", "host_ms", "plain_ms", "library_ms", "library_graph_ms",
        "int8pack_ms", "int8pack_graph_ms") if k in rec)
    print(f"quant_matmul M={M} N={N} K={K}: err {diff:.3e} (rel "
          f"{rel:.3e}) | kernel {rec['ms']:.4f} ms{shown} bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})", flush=True)
    if not ok:
        fail(f"quant_matmul disagrees with quant_matmul_plain at M={M} "
             f"N={N} K={K}: relative error {rel} (limit {QMM_RTOL})")
    return rec


def qmm_layer_phase(torch, timer, M=8, seed=3300, library=True):
    """One Llama-3-8B layer's seven B7 launches at decode (``QMM_LAYER``,
    the model's order), x [M, K] of each input width, on the layer's own
    int8 weights (~218 MB), captured in one CUDA graph and replayed with
    the L2 evicted before each replay: the layer's B7 time without a
    per-launch event floor. Each output is held against the plain
    version. With ``library``, the same seven products through
    ``F.linear`` on bf16 copies and, where this build has it,
    ``torch._weight_int8pack_mm``, each as one graph too."""
    from paddle_tpu_torch.kernels.quant_matmul import (quant_matmul,
                                                       quant_matmul_plain)
    F = torch.nn.functional
    layer = []
    for i, (name, n, k) in enumerate(QMM_LAYER):
        x, w, s = qmm_inputs(torch, M, n, k, seed + i)
        if layer and layer[0][1].shape[1] == k:
            x = layer[0][1]  # q, k, v, gate, up read the same x
        layer.append((name, x, w, s))
    outs = [quant_matmul(x, w, s) for _, x, w, s in layer]
    errs = {name: rel_err(out, quant_matmul_plain(x, w, s))[0]
            for (name, x, w, s), out in zip(layer, outs)}
    del outs
    bad = {k: v for k, v in errs.items() if not v <= QMM_RTOL}
    if bad:
        fail(f"quant_matmul disagrees with quant_matmul_plain in the "
             f"decode layer (M={M}): {bad} (limit {QMM_RTOL})")
    rec = dict(M=M, rel_err=max(errs.values()), graph_ms=timer.graph(
        lambda: [quant_matmul(x, w, s) for _, x, w, s in layer], cold=True))
    if library:
        wbs = [(x, (w.float() * s[:, None]).to(torch.bfloat16))
               for _, x, w, s in layer]
        rec["library_graph_ms"] = timer.graph(
            lambda: [F.linear(x, wb) for x, wb in wbs], cold=True)
        del wbs
        pack = int8pack_library(torch)
        if pack is not None:
            sbs = [(x, w, s.bfloat16()) for _, x, w, s in layer]
            rec["int8pack_graph_ms"] = timer.graph(
                lambda: [pack(x, w, sb) for x, w, sb in sbs], cold=True)
    nbytes = sum(M * k * 2 + n * k + n * 4 + M * n * 2
                 for _, n, k in QMM_LAYER)
    rec["bound_ms"], rec["bound_by"] = bound(
        nbytes, sum(2 * M * n * k for _, n, k in QMM_LAYER))
    print(f"quant_matmul decode layer (M {M}, 7 launches in one graph): "
          + " ".join(f"{k} {rec[k]:.4f}" for k in (
              "graph_ms", "library_graph_ms", "int8pack_graph_ms",
              "bound_ms") if k in rec) + f" (rel err {rec['rel_err']:.3e})",
          flush=True)
    return rec


def qmm_decode_step(decode, layer):
    """One decode step's B7 time (225 launches) from the per-shape
    records ``decode`` (``QMM_DECODE``'s order) and the layer graph
    ``layer``: sums over the launches of events and of per-shape graph
    replays, and ``LAYERS`` x the layer graph + the LM head's graph."""
    head = decode[-1]
    per = [n for _, n in QMM_DECODE]
    rec = {key: sum(r[key] * n for r, n in zip(decode, per))
           for key in ("ms", "graph_ms", "bound_ms", "library_ms",
                       "library_graph_ms", "int8pack_ms",
                       "int8pack_graph_ms")
           if all(key in r for r in decode)}
    rec["layer_graph_ms"] = LAYERS * layer["graph_ms"] + head["graph_ms"]
    for lib in ("library", "int8pack"):
        key = lib + "_graph_ms"
        if key in layer and key in head:
            rec["layer_" + key] = LAYERS * layer[key] + head[key]
    print("quant_matmul per decode step (M 8, 225 launches): "
          + " ".join(f"{k} {v:.4f}" for k, v in rec.items()), flush=True)
    return rec


def kernel_phases(torch):
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_chunked, paged_decode_attention_kernel)
    timer = Timer(torch)
    gpt_shape = dict(B=GPT_B, hq=GPT_H, hk=GPT_H, dh=GPT_D)
    vit_shape = dict(B=VIT_B, hq=VIT_H, hk=VIT_H, dh=VIT_D, causal=False,
                     case="vit")
    flash = [flash_phase(torch, timer, GPT_S, **gpt_shape)] + \
        [flash_phase(torch, timer, S) for S in (1024, 304, 300)] + \
        [flash_phase(torch, timer, VIT_S, **vit_shape)]
    bwd = [flash_bwd_phase(torch, timer, GPT_B, GPT_S, GPT_H, GPT_H, GPT_D),
           flash_bwd_phase(torch, timer, 1, 2048, HQ, HK, D),
           flash_bwd_phase(torch, timer, VIT_B, VIT_S, VIT_H, VIT_H, VIT_D,
                           causal=False, case="vit")]
    # B1-B3 at the llama_train shape, and above head dim 128
    flash.append(flash_phase(torch, timer, LT_S, B=LT_B,
                             case="llama_train"))
    bwd.append(flash_bwd_phase(torch, timer, LT_B, LT_S, HQ, HK, D,
                               case="llama_train"))
    for S, dh, causal in WIDE_CASES:
        recs = wide_phase(torch, timer, S, dh, causal)
        flash.append(recs["flash_fwd"])
        bwd.append(recs)
    short = [0, 1, 16, 17, 100, 161, 239, 240]
    lens = np.linspace(1, 2048, 8).astype(np.int64)
    decode = {}
    for quantized, suffix in ((False, ""), (True, "_q")):
        decode["paged_decode" + suffix] = [decode_phase(
            torch, timer, "paged_decode" + suffix,
            paged_decode_attention_kernel, 8, 15, short, seed=1,
            quantized=quantized)]
        decode["paged_decode_split" + suffix] = [decode_phase(
            torch, timer, "paged_decode_split" + suffix,
            paged_decode_attention_chunked, 8, 128, lens, seed=2,
            quantized=quantized, beside=paged_decode_attention_kernel)]
    qmm = [qmm_phase(torch, timer, 8, n, k, seed=3000 + i)
           for i, ((n, k), _) in enumerate(QMM_DECODE)]
    layer = qmm_layer_phase(torch, timer)
    step = qmm_decode_step(qmm, layer)
    prefill = [qmm_phase(torch, timer, QMM_PREFILL_M, n, k, seed=3100 + i)
               for i, ((n, k), _) in enumerate(QMM_PREFILL)]
    sums = {key: sum(r[key] * per for r, (_, per) in zip(prefill,
                                                         QMM_PREFILL))
            for key in ("ms", "graph_ms", "bound_ms", "library_ms",
                        "library_graph_ms")}
    launches = sum(per for _, per in QMM_PREFILL)
    print(f"quant_matmul per {QMM_PREFILL_M}-token prefill (M "
          f"{QMM_PREFILL_M}, {launches} layer launches): kernel "
          f"{sums['ms']:.4f} ms (graph {sums['graph_ms']:.4f}), bound "
          f"{sums['bound_ms']:.4f} ms, F.linear on bf16 copies "
          f"{sums['library_ms']:.4f} ms (graph "
          f"{sums['library_graph_ms']:.4f})", flush=True)
    qmm += prefill
    qmm.append(qmm_phase(torch, timer, QMM_SHORT_M, *QMM_PREFILL[0][0],
                         seed=3200))
    qmm += [qmm_phase(torch, timer, m, *QMM_PREFILL[0][0], seed=3210 + m)
            for m in QMM_EXTEND_M]
    # a verify sweep: every layer shape and the LM head at M 40
    verify = [qmm_phase(torch, timer, QMM_VERIFY_M, n, k, seed=3400 + i)
              for i, ((n, k), _) in enumerate(QMM_DECODE)]
    vsums = {key: sum(r[key] * per for r, (_, per) in zip(verify,
                                                          QMM_DECODE))
             for key in ("ms", "graph_ms", "bound_ms", "plain_ms",
                         "library_ms", "library_graph_ms")}
    print(f"quant_matmul per verify sweep (M {QMM_VERIFY_M}, "
          f"{QMM_PER_FORWARD} launches): kernel {vsums['ms']:.4f} ms (graph "
          f"{vsums['graph_ms']:.4f}), bound {vsums['bound_ms']:.4f} ms, "
          f"F.linear on bf16 copies {vsums['library_ms']:.4f} ms (graph "
          f"{vsums['library_graph_ms']:.4f})", flush=True)
    qmm += verify
    del timer
    torch.cuda.empty_cache()
    return {"flash_fwd": flash,
            "flash_bwd_dq": [r["flash_bwd_dq"] for r in bwd],
            "flash_bwd_dkv": [r["flash_bwd_dkv"] for r in bwd],
            **decode, "quant_matmul": qmm,
            "quant_matmul_decode_step": step,
            "quant_matmul_decode_layer": layer,
            "quant_matmul_prefill": dict(M=QMM_PREFILL_M, launches=launches,
                                         **sums),
            "quant_matmul_verify": dict(M=QMM_VERIFY_M,
                                        launches=QMM_PER_FORWARD, **vsums)}


# ---------------------------------------------------------------------------
# slice phase: Llama-3-8B served by the continuous-batching engine
# ---------------------------------------------------------------------------

def _counters():
    """Kernel name -> (wrapper, attribute holding its launch count), and
    the decode routing counters. ``fp8_gemm`` counts the fp8 route's
    ``torch._scaled_mm`` products (a library call, not a kernel of this
    repository); ``sdpa_masked`` the calls of the plain masked SDPA route
    (attention with ``attn_mask``), which no phase should reach."""
    from paddle_tpu_torch.amp.fp8 import fp8_gemm
    from paddle_tpu_torch.inference.paged import ROUTE_COUNTS
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_bwd_dkv_cuda, flash_bwd_dkv_x3_cuda, flash_bwd_dq_cuda,
        flash_bwd_dq_x3_cuda, flash_fwd_cuda, flash_fwd_x3_cuda,
        flash_simt_dkv_cuda, flash_simt_dq_cuda, flash_simt_fwd_cuda,
        sdpa_masked_plain, split_bf16x3_cuda)
    from paddle_tpu_torch.kernels.paged_attention import (
        paged_decode_attention_chunked, paged_decode_attention_kernel,
        paged_decode_attention_simt)
    from paddle_tpu_torch.kernels.quant_matmul import (
        quant_matmul, quant_matmul_f16, quant_matmul_simt, quant_matmul_x3)
    return {"flash_fwd": (flash_fwd_cuda, "launches"),
            "flash_bwd_dq": (flash_bwd_dq_cuda, "launches"),
            "flash_bwd_dkv": (flash_bwd_dkv_cuda, "launches"),
            "B1-seg": (flash_fwd_cuda, "seg_launches"),
            "B2-seg": (flash_bwd_dq_cuda, "seg_launches"),
            "B3-seg": (flash_bwd_dkv_cuda, "seg_launches"),
            "B1-xl": (flash_fwd_cuda, "xl_launches"),
            "B2-xl": (flash_bwd_dq_cuda, "xl_launches"),
            "B3-xl": (flash_bwd_dkv_cuda, "xl_launches"),
            "paged_decode": (paged_decode_attention_kernel, "launches"),
            "paged_decode_split": (paged_decode_attention_chunked,
                                   "launches"),
            "paged_decode_q": (paged_decode_attention_kernel, "launches_q"),
            "paged_decode_split_q": (paged_decode_attention_chunked,
                                     "launches_q"),
            "quant_matmul": (quant_matmul, "launches"),
            "flash_simt_fwd": (flash_simt_fwd_cuda, "launches"),
            "flash_simt_dq": (flash_simt_dq_cuda, "launches"),
            "flash_simt_dkv": (flash_simt_dkv_cuda, "launches"),
            "flash_bwd_dq_f32": (flash_bwd_dq_x3_cuda, "launches"),
            "flash_bwd_dkv_f32": (flash_bwd_dkv_x3_cuda, "launches"),
            "flash_bwd_dq_f16": (flash_bwd_dq_cuda, "f16_launches"),
            "flash_bwd_dkv_f16": (flash_bwd_dkv_cuda, "f16_launches"),
            "split_bf16x3": (split_bf16x3_cuda, "launches"),
            "flash_fwd_f32": (flash_fwd_x3_cuda, "launches"),
            "flash_fwd_f16": (flash_fwd_cuda, "f16_launches"),
            "flash_fwd_f32_xl": (flash_fwd_x3_cuda, "xl_launches"),
            "flash_fwd_f16_256": (flash_fwd_cuda, "f16_256_launches"),
            "flash_fwd_f16_xl": (flash_fwd_cuda, "f16_xl_launches"),
            "quant_matmul_f32": (quant_matmul_x3, "launches"),
            "quant_matmul_f16": (quant_matmul_f16, "launches"),
            "quant_matmul_unaligned": (quant_matmul, "unaligned_launches"),
            "quant_matmul_f16_unaligned": (quant_matmul_f16,
                                           "unaligned_launches"),
            "quant_matmul_f32_unaligned": (quant_matmul_x3,
                                           "unaligned_launches"),
            "paged_decode_simt": (paged_decode_attention_simt, "launches"),
            "paged_decode_simt_q": (paged_decode_attention_simt,
                                    "launches_q"),
            "quant_matmul_simt": (quant_matmul_simt, "launches"),
            "fp8_gemm": (fp8_gemm, "launches"),
            "sdpa_masked": (sdpa_masked_plain, "calls")}, ROUTE_COUNTS


def zero_counts():
    fns, routes = _counters()
    for f, attr in fns.values():
        setattr(f, attr, 0)
    for r in routes:
        routes[r] = 0


def read_counts():
    fns, routes = _counters()
    return {n: getattr(f, attr) for n, (f, attr) in fns.items()}, \
        dict(routes)


class Instrumented:
    """Times the model's serving calls (host clock around work that ends in
    a synchronize) and counts prefills and decode steps."""

    KINDS = {"prefill": "paged_prefill", "extend": "paged_prefill_extend",
             "decode": "paged_decode_step", "verify": "paged_spec_step"}

    def __init__(self, torch, model):
        self.torch = torch
        self.model = model
        for kind, attr in self.KINDS.items():
            setattr(model, attr, self._wrap(getattr(model, attr), kind))
        self.reset()

    def reset(self):
        self.calls = {k: 0 for k in self.KINDS}
        self.secs = {k: 0.0 for k in self.KINDS}
        self.steps = {k: [] for k in self.KINDS}

    def _wrap(self, fn, kind):
        def run(*a, **kw):
            self.torch.cuda.synchronize()
            t = time.perf_counter()
            r = fn(*a, **kw)
            self.torch.cuda.synchronize()
            dt = time.perf_counter() - t
            self.secs[kind] += dt
            self.steps[kind].append(dt)
            self.calls[kind] += 1
            return r
        return run

    def restore(self):
        for attr in self.KINDS.values():
            delattr(self.model, attr)


def _first_token_done(engine, rid):
    for req in list(engine.running.values()) + list(engine.finished.values()):
        if req.rid == rid:
            return bool(req.generated)
    return False


def serve(torch, inst, engine, prompts, new_tokens, per_step=2):
    """Requests arrive ``per_step`` per engine step; returns the run's
    numbers. Counters are zeroed just before and read just after."""
    inst.reset()
    zero_counts()
    pending = list(prompts)
    t_add, t_first = {}, {}
    decoded = 0
    t0 = time.perf_counter()
    while pending or engine.has_work:
        for _ in range(per_step):
            if pending:
                rid = engine.add_request(pending.pop(0), new_tokens)
                t_add[rid] = time.perf_counter()
        decoded += len(engine.step())
        now = time.perf_counter()
        for rid in t_add:
            if rid not in t_first and _first_token_done(engine, rid):
                t_first[rid] = now - t_add[rid]
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    ttft = sorted(t_first.values())
    return dict(requests=len(prompts), wall_s=wall,
                prefills=inst.calls["prefill"],
                prefill_s=inst.secs["prefill"],
                decode_steps=inst.calls["decode"],
                decode_s=inst.secs["decode"], decode_tokens=decoded,
                decode_tok_per_s=decoded / max(inst.secs["decode"], 1e-9),
                ttft_median_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
                preemptions=engine.preemptions, launches=launches,
                routes=routes)


def kv8_attention(n):
    """The model's attention as an int8-cache engine computes it, for a
    dense forward over prompt + generated (prompt length ``n``): query
    positions before ``n`` attend the exact KV (prefill); later ones attend
    every K/V row rounded through int8 (``quantize_rows``, dequantized to
    bf16), as the decode steps read the int8 pools. Causal masks are
    bottom-right aligned, so the later queries keep their own positions."""
    from paddle_tpu_torch.kernels.flash_attention import (
        scaled_dot_product_attention)
    from paddle_tpu_torch.quantization import dequantize_rows, quantize_rows

    def attn(q, k, v, is_causal=False, **kw):
        out = scaled_dot_product_attention(q, k, v, is_causal=is_causal, **kw)
        if q.shape[1] > n:
            kq = dequantize_rows(*quantize_rows(k), dtype=k.dtype)
            vq = dequantize_rows(*quantize_rows(v), dtype=v.dtype)
            out[:, n:] = scaled_dot_product_attention(
                q[:, n:], kq, vq, is_causal=is_causal, **kw)
        return out
    return attn


def _dense_logits(torch, model, ids, attention=None):
    """The model's dense forward; its int8 layers (if any) run B7's plain
    version, ``quant_matmul_plain``, so the engine's B7 launches are held
    against it."""
    import paddle_tpu_torch.models.llama as llama_mod
    from paddle_tpu_torch.quantization import ConvertedInt8Linear
    orig = llama_mod.scaled_dot_product_attention
    int8 = [(m, m.kernel_mode) for m in model.modules()
            if isinstance(m, ConvertedInt8Linear)]
    if attention is not None:
        llama_mod.scaled_dot_product_attention = attention
    for m, _ in int8:
        m.kernel_mode = "dense"
    try:
        logits = model(torch.as_tensor(ids[None], device=DEVICE))[0].float()
    finally:
        llama_mod.scaled_dot_product_attention = orig
        for m, mode in int8:
            m.kernel_mode = mode
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits in the teacher-forced forward")
    return logits


def teacher_forced(torch, model, engine, kv8=False, exact=None,
                   deficit_tol=None):
    """Dense forward over prompt + generated for every finished request;
    where the top-2 gap exceeds GAP_TOL the argmax must be the engine's
    token. Holds the paged-decode kernels against the flash kernel, and
    B7 against its plain version. With ``kv8`` (an int8-cache engine) the
    forward attends as the engine does (``kv8_attention``): queries before
    ``exact[rid]`` (default: the prompt's length) attend the exact KV, as
    a cold prefill computed them; later ones attend int8-rounded KV, as
    decode steps and prefix-cache extends read the pools. With
    ``deficit_tol`` (fp8 engines) the rule is instead that at every
    position the engine's token has a dense logit within ``deficit_tol``
    of the largest; every position is then checked. Records, for every
    engine, the largest such deficit and the largest top-2 gap where the
    two disagree."""
    checked = total = disagree = 0
    min_gap_checked = float("inf")
    max_gap_disagree = max_deficit = 0.0
    with torch.inference_mode():
        for req in engine.finished.values():
            ids = np.concatenate([req.prompt, np.asarray(req.generated)])
            n = len(req.prompt)
            gen = torch.as_tensor(req.generated)
            span = slice(n - 1, n - 1 + len(req.generated))
            n_exact = (exact or {}).get(req.rid, n)
            logits = _dense_logits(torch, model, ids,
                                   kv8_attention(n_exact) if kv8 else None)
            top = logits[span].topk(2, dim=-1)
            gap = (top.values[:, 0] - top.values[:, 1]).cpu()
            arg = top.indices[:, 0].cpu()
            deficit = (top.values[:, 0] - logits[span].gather(
                -1, gen.to(logits.device)[:, None])[:, 0]).cpu()
            max_deficit = max(max_deficit, float(deficit.max()))
            differ = arg != gen
            disagree += int(differ.sum())
            if bool(differ.any()):
                max_gap_disagree = max(max_gap_disagree,
                                       float(gap[differ].max()))
            if deficit_tol is None:
                sure = gap > GAP_TOL
                bad = sure & differ
                what = f"gap {{:.3f}} > {GAP_TOL}"
                size = gap
            else:
                sure = torch.ones_like(differ)
                bad = deficit > deficit_tol
                what = f"its logit {{:.3f}} below the largest > {deficit_tol}"
                size = deficit
            if bool(bad.any()):
                i = int(bad.nonzero()[0, 0])
                fail(f"request {req.rid}: token {i} is {int(gen[i])}, the "
                     f"dense forward says {int(arg[i])} ("
                     + what.format(float(size[i])) + ")")
            checked += int(sure.sum())
            total += len(req.generated)
            if bool(sure.any()):
                min_gap_checked = min(min_gap_checked,
                                      float(gap[sure].min()))
    share = checked / max(total, 1)
    rec = dict(checked=checked, total=total, gap_tol=GAP_TOL,
               deficit_tol=deficit_tol, min_gap_checked=min_gap_checked,
               disagree=disagree, max_gap_disagree=max_gap_disagree,
               max_deficit=max_deficit,
               reference="int8-KV dense forward" if kv8 else "dense forward")
    rule = f"above gap {GAP_TOL}" if deficit_tol is None else \
        f"within {deficit_tol} of the largest logit"
    print(f"teacher-forced: {checked}/{total} positions {rule} agree "
          f"(smallest checked gap {min_gap_checked:.3f}): "
          f"{json.dumps(rec)}", flush=True)
    if share < MIN_CHECKED_SHARE:
        fail(f"teacher-forced check covered only {checked}/{total} "
             f"positions")
    return rec


# cuBLAS kernel-name fragments
_MATMUL_GROUPS = tuple((key, "matmul") for key in
                       ("nvjet", "gemm", "gemv", "cutlass", "xmma"))
_KERNEL_GROUPS = (
    ("quant_matmul", "int8 weight matmul (port)"),
    ("qmm_", "int8 weight matmul (port)"),
    ("paged_decode", "decode attention (port)"),
    ("flash_fwd", "flash forward (port)"),
) + _MATMUL_GROUPS


def profile_decode(torch, model, prompts, new_tokens, steps=4, label="A",
                   max_seq_len=2048, **engine_kw):
    """torch.profiler over ``steps`` decode-only steps of an engine with
    every slot live (``max_seq_len`` 2048: engine A's split route; 240:
    engine B's per-page route; ``engine_kw``: the int8 cache of A8 and
    B8): the device's busy share of the window, kernels per step, and
    device time per step by kernel group."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=max_seq_len,
                                      temperature=0.0, **engine_kw)
    for p in prompts:
        engine.add_request(p, new_tokens)
    engine.step()  # admits (prefills) every request and decodes once
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = []
    for e in prof.key_averages():
        if e.device_type != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    busy_ms = sum(ms for _, ms, _ in rows)
    groups = {}
    for name, ms, _ in rows:
        g = next((lab for key, lab in _KERNEL_GROUPS if key in name),
                 "other (elementwise, norms, rope, copies)")
        groups[g] = groups.get(g, 0.0) + ms / steps
    top = sorted(rows, key=lambda r: -r[1])[:8]
    rec = dict(steps=steps, live_slots=len(prompts),
               step_ms=wall_ms / steps, device_busy_ms_per_step=busy_ms / steps,
               device_busy_share=busy_ms / wall_ms if wall_ms else None,
               kernels_per_step=sum(c for _, _, c in rows) / steps,
               by_group_ms_per_step=groups,
               top=[dict(name=n[:80], ms_per_step=ms / steps,
                         launches_per_step=c / steps) for n, ms, c in top])
    print(f"profile (engine {label}, {len(prompts)} live slots, {steps} "
          f"decode steps): {json.dumps(rec)}", flush=True)
    if busy_ms == 0.0:
        print("profile: the profiler saw no device time; busy share not "
              "measured", flush=True)
    del engine
    return rec


_PREFILL_GROUPS = (
    ("quant_matmul", "B7 int8 weight matmul (port)"),
    ("qmm_", "B7 int8 weight matmul (port)"),
    ("flash_fwd", "B1 flash forward (port)"),
) + tuple((key, "cuBLAS bf16 matmul") for key, _ in _MATMUL_GROUPS)
_CACHE_WRITE = "cache writes (paged_prefill_write[_q])"
_PREFILL_OTHER = "elementwise, norms, rope, embedding, copies"


def profile_prefill(torch, model, prompt, label, prefix_len=0,
                    **engine_kw):
    """One prefill of ``prompt`` (padded to a block multiple) into a fresh
    engine's cache: its host-clock time (median of 3, synchronized), then
    torch.profiler over one more: device time by kernel group, the cache
    writes read from a ``record_function`` range around them. With
    ``prefix_len`` (a block multiple) one cold prefill registers the
    prompt's first ``prefix_len`` tokens in the prefix cache, and the call
    profiled is the prefix-cache extend of the rest, at the bucket the
    scheduler gives it; the tail attention's device time is read from a
    range around ``paged_prefix_attention_dense`` (its kernels also count
    in the groups)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import paddle_tpu_torch.inference.paged as paged_mod
    from paddle_tpu_torch import ContinuousBatchingEngine
    from paddle_tpu_torch.serving import bucket_length
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=2048, temperature=0.0,
                                      **engine_kw)
    cache = engine.cache
    padded = -(-len(prompt) // 16) * 16
    if prefix_len:
        head = prompt[:prefix_len]
        plan = cache.plan_prefix(head)
        slot = cache.alloc_slot_cached(plan)
        model.paged_prefill(cache, slot, head)
        cache.commit_prefix(slot, plan)
        cache.free_slot(slot)
        padded = bucket_length(len(prompt) - prefix_len, 16, 1024, 2048)

    def prefill():
        if prefix_len:
            plan = cache.plan_prefix(prompt)
            slot = cache.alloc_slot_cached(plan)
        else:
            slot = cache.alloc_slot(len(prompt))
        try:
            if prefix_len:
                model.paged_prefill_extend(cache, slot, prompt,
                                           plan.tail_start, plan.write_start,
                                           pad_to=padded)
            else:
                model.paged_prefill(cache, slot, prompt)
        finally:
            cache.free_slot(slot)

    secs = []
    for _ in range(4):  # the first warms up
        torch.cuda.synchronize()
        t = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    ranges = {"paged_prefill_write": "cache_write",
              "paged_prefill_write_q": "cache_write",
              "paged_prefill_write_masked": "cache_write",
              "paged_prefill_write_masked_q": "cache_write",
              "paged_prefix_attention_dense": "prefix_attention"}
    orig = {n: getattr(paged_mod, n) for n in ranges}

    def traced(fn, rng):
        def run(*a, **kw):
            with record_function(rng):
                return fn(*a, **kw)
        return run

    for n, fn in orig.items():
        setattr(paged_mod, n, traced(fn, ranges[n]))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for n, fn in orig.items():
            setattr(paged_mod, n, fn)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    groups, busy_us, n_kernels = {}, 0.0, 0
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n_kernels += 1
        grp = next((lab for key, lab in _PREFILL_GROUPS if key in e.name),
                   _PREFILL_OTHER)
        groups[grp] = groups.get(grp, 0.0) + us / 1e3
    def range_ms(name):
        return sum(getattr(e, "device_time_total", 0.0) for e in events
                   if e.device_type != cuda and e.name == name) / 1e3

    write_ms = range_ms("cache_write")
    groups[_CACHE_WRITE] = write_ms
    groups[_PREFILL_OTHER] = groups.get(_PREFILL_OTHER, 0.0) - write_ms
    rec = dict(tokens=len(prompt), prefix=prefix_len, padded=padded,
               prefill_ms=float(np.median(secs[1:])) * 1e3,
               profiled_ms=wall_ms, device_busy_ms=busy_us / 1e3,
               kernels=n_kernels, by_group_ms=groups)
    if prefix_len:
        rec["prefix_attention_ms"] = range_ms("prefix_attention")
    print(f"prefill profile (engine {label}): {json.dumps(rec)}", flush=True)
    if busy_us == 0.0:
        print("profile: the profiler saw no device time; prefill breakdown "
              "not measured", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def run_engine(torch, inst, model, name, prompts, new_tokens, tf=None,
               **kw):
    """Serve ``prompts`` on a fresh engine (counts zeroed just before,
    read just after), then the teacher-forced check (``tf``: its
    keyword arguments)."""
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      temperature=0.0, **kw)
    torch.cuda.reset_peak_memory_stats()
    r = serve(torch, inst, engine, prompts, new_tokens)
    r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    r["teacher_forced"] = teacher_forced(torch, model, engine,
                                         kv8=engine.cache.quantized,
                                         **(tf or {}))
    r["max_blocks_per_seq"] = engine.cache.max_blocks_per_seq
    r["num_blocks"] = engine.cache.num_blocks
    for req in engine.finished.values():
        if len(req.generated) != new_tokens:
            fail(f"engine {name}: request {req.rid} produced "
                 f"{len(req.generated)} tokens, wanted {new_tokens}")
    if len(engine.finished) != len(prompts):
        fail(f"engine {name}: {len(engine.finished)} of {len(prompts)} "
             f"requests finished")
    print(f"engine {name}: {json.dumps(r)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return r


def convert_int8(torch, model):
    """The port's QAT, in place: every projection and the LM head become
    ConvertedInt8Linear (int8 [out, in] + bf16 per-channel scales)."""
    from paddle_tpu_torch.quantization import (
        QAT, ConvertedInt8Linear, FakeQuanterWithAbsMaxObserver, QuantConfig)
    t = time.perf_counter()
    qat = QAT(QuantConfig(activation=None,
                          weight=FakeQuanterWithAbsMaxObserver))
    qat.convert(qat.quantize(model, inplace=True), inplace=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    conv = [m for m in model.modules() if isinstance(m, ConvertedInt8Linear)]
    want = 7 * model.config.num_layers + 1
    if len(conv) != want:
        fail(f"QAT.convert made {len(conv)} int8 layers, expected {want}")
    rec = dict(int8_layers=len(conv), secs=time.perf_counter() - t,
               int8_weight_bytes=sum(m.w_int8.numel() for m in conv),
               scale_bytes=sum(m.w_scales.numel() * m.w_scales.element_size()
                               + m.w_scales_f32.numel() * 4 for m in conv),
               bf16_param_bytes=sum(p.numel() * p.element_size()
                                    for p in model.parameters()),
               allocated_gib=torch.cuda.memory_allocated() / 2**30)
    print(f"Llama-3-8B converted in place: {json.dumps(rec)}", flush=True)
    return rec


# ---------------------------------------------------------------------------
# frontend phase: the same model behind serving.ServingEngine
# ---------------------------------------------------------------------------

def front_traffic(vocab, seed=10):
    """Engines S and S8's 16 prompts: r0 the system prompt plus a suffix
    (cold; it registers the prefix), r1, r3 and r5-r13 the system prompt
    plus distinct suffixes (hits on its 32 blocks), r2 r1's prompt exactly
    (full coverage), r4 r3's prompt plus 3 tokens (a partial match), r14
    and r15 unrelated prompts of 300-600 tokens (misses). Suffixes are
    17-200 tokens and no prompt is a block multiple."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, FRONT_SYSTEM)
    lens = [n for n in rng.permutation(np.arange(17, 201)) if n % 16 and
            (n + 3) % 16][:12]

    def tokens(n):
        return rng.integers(0, vocab, int(n))

    suffixed = [np.concatenate([system, tokens(n)]) for n in lens]
    prompts = suffixed[:2] + [suffixed[1].copy()] + [suffixed[2]] + \
        [np.concatenate([suffixed[2], tokens(3)])] + suffixed[3:]
    for n in (int(rng.integers(300, 601)), int(rng.integers(300, 601))):
        prompts.append(tokens(n + (n % 16 == 0)))
    assert len(prompts) == 16
    return [p.astype(np.int64) for p in prompts]


def expected_prefix_counts(prompts, bs=16):
    """The prefix cache's counters for FCFS admission of ``prompts`` into
    an empty cache, worked out from token contents alone (a chunk is
    resident once a prompt with the same tokens up to its end was
    admitted; a partial block likewise) -- independent of the port's
    hashing. Each shared partial block costs one copy at the first decode
    append, each partial match extended past its tokens one at
    admission. Returns the counters and each prompt's covered tokens."""
    full, part = set(), set()
    hits = misses = cow = 0
    covered_of = []
    for ids in prompts:
        ids = tuple(int(t) for t in ids)
        n, matched = len(ids), 0
        while (matched + 1) * bs <= n and ids[:(matched + 1) * bs] in full:
            matched += 1
        covered, partial, shared = matched * bs, False, False
        if covered < n:
            for p in range(min(bs - 1, n - covered), 0, -1):
                if ids[:covered + p] in part:
                    partial, shared = True, p == n - covered
                    covered += p
                    break
        hit = matched + partial
        hits += hit
        misses += -(-n // bs) - hit
        cow += partial  # at admission, or at the sharer's first append
        full.update(ids[:(c + 1) * bs] for c in range(n // bs))
        if n % bs and not shared:
            part.add(ids)
        covered_of.append(covered)
    return {"serving.prefix.hit_blocks": hits,
            "serving.prefix.miss_blocks": misses,
            "serving.prefix.cow_copies": cow}, covered_of


def frontend_engine(torch, model, name, **kw):
    """Engine S (or S8: ``kv_cache_dtype="int8"``) with the default flags,
    built not ready: a submit must raise NotReadyError, then ``warmup()``
    runs every prefill bucket and the decode step."""
    from paddle_tpu_torch.serving import NotReadyError, ServingEngine
    engine = ServingEngine(model, max_batch=8, block_size=16,
                           max_seq_len=2048, temperature=0.0,
                           background=False, ready=False, **kw)
    try:
        engine.submit(np.zeros(8, np.int64), max_new_tokens=1)
    except NotReadyError:
        pass
    else:
        fail(f"engine {name}: a WARMING engine took a submit")
    torch.cuda.synchronize()
    t = time.perf_counter()
    programs = engine.warmup()
    torch.cuda.synchronize()
    warm = dict(programs=programs, secs=time.perf_counter() - t,
                lifecycle=engine.lifecycle)
    print(f"engine {name} warm-up: {json.dumps(warm)}", flush=True)
    if engine.lifecycle != "READY":
        fail(f"engine {name}: warmup() left it {engine.lifecycle}")
    return engine, warm


def serve_frontend(torch, inst, model, name, prompts, **kw):
    """Serve ``prompts`` (all submitted at once) on a warmed engine; counts
    and ``serving.*`` counters zeroed or snapshot just before, read just
    after. Gates: every request DONE with FRONT_NEW tokens, no
    preemption, the prefix counters as ``expected_prefix_counts`` works
    them out, the teacher-forced check."""
    from paddle_tpu_torch.profiler import metrics
    engine, warm = frontend_engine(torch, model, name, **kw)
    want, covered = expected_prefix_counts(prompts)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inst.reset()
    zero_counts()
    before = metrics.snapshot("serving.")
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=FRONT_NEW) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    delta = metrics.window_delta(before, metrics.snapshot("serving."))
    peak = torch.cuda.max_memory_allocated() / 2**30
    sched = engine.scheduler
    reqs = [sched.finished[h.rid] for h in handles]
    for r in reqs:
        if r.status != "DONE" or len(r.generated) != FRONT_NEW:
            fail(f"engine {name}: request {r.rid} ended {r.status} with "
                 f"{len(r.generated)} tokens")
    counts = {k: delta.get(k, 0) for k in
              ("serving.prefix.hit_blocks", "serving.prefix.miss_blocks",
               "serving.prefix.cow_copies", "serving.prefix.evictions",
               "serving.preempt", "serving.admitted", "serving.completed",
               "serving.decoded_tokens", "serving.prefix.computed_tokens")}
    for k, v in want.items():
        if counts[k] != v:
            fail(f"engine {name}: {k} moved by {counts[k]}, the traffic "
                 f"works out to {v}")
    if counts["serving.prefix.cow_copies"] != 2 or \
            counts["serving.preempt"] != 0:
        fail(f"engine {name}: {counts}")
    hit = [i for i, c in enumerate(covered) if c]
    ttft = [r.first_token_at - r.submitted_at for r in reqs]
    ttft_hit = sorted(ttft[i] for i in hit)
    ttft_miss = sorted(t for i, t in enumerate(ttft) if i not in hit)
    decoded = sum(len(r.generated) - 1 for r in reqs)
    rec = dict(requests=len(prompts), wall_s=wall, warmup=warm,
               prefills=inst.calls["prefill"], extends=inst.calls["extend"],
               prefill_s=inst.secs["prefill"], extend_s=inst.secs["extend"],
               decode_steps=inst.calls["decode"],
               decode_s=inst.secs["decode"], decode_tokens=decoded,
               decode_tok_per_s=decoded / max(inst.secs["decode"], 1e-9),
               ttft_hit_median_s=float(np.median(ttft_hit)),
               ttft_hit_max_s=ttft_hit[-1],
               ttft_miss_median_s=float(np.median(ttft_miss)),
               ttft_miss_max_s=ttft_miss[-1], peak_mem_gib=peak,
               counters=counts, expected=want, launches=launches,
               routes=routes, num_blocks=engine.cache.num_blocks)
    if rec["prefills"] != len(prompts) - len(hit) or \
            rec["extends"] != len(hit):
        fail(f"engine {name}: {rec['prefills']} cold prefills and "
             f"{rec['extends']} extends for {len(hit)} hits")
    # a hit's first FRONT_SYSTEM positions came from r0's cold prefill;
    # the rest were computed by extends that read the pools
    exact = {h.rid: FRONT_SYSTEM for i, h in enumerate(handles) if i in hit}
    rec["teacher_forced"] = teacher_forced(
        torch, model, sched, kv8=engine.cache.quantized, exact=exact)
    rec["tokens"] = [list(map(int, r.generated)) for r in reqs]
    engine.close()
    print(f"engine {name}: " + json.dumps(
        {k: v for k, v in rec.items() if k != "tokens"}), flush=True)
    print(f"engine {name}: TTFT hits median {rec['ttft_hit_median_s']:.4f} "
          f"s max {rec['ttft_hit_max_s']:.4f} s, misses median "
          f"{rec['ttft_miss_median_s']:.4f} s max "
          f"{rec['ttft_miss_max_s']:.4f} s; decode "
          f"{rec['decode_tok_per_s']:.1f} tokens/s; peak "
          f"{peak:.2f} GiB", flush=True)
    del engine, sched, reqs, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def background_check(torch, model, prompts, want):
    """A ``background=True`` engine serves ``prompts`` through
    ``handle.result()`` on its driver thread; the tokens must be ``want``
    (engine S's for the same prompts)."""
    from paddle_tpu_torch.serving import ServingEngine
    t = time.perf_counter()
    with ServingEngine(model, max_batch=8, block_size=16, max_seq_len=2048,
                       temperature=0.0) as engine:
        handles = [engine.submit(p, max_new_tokens=FRONT_NEW)
                   for p in prompts]
        got = [list(map(int, h.result(timeout=600))) for h in handles]
        driver = engine._thread is not None and engine._thread.is_alive()
    rec = dict(requests=len(prompts), secs=time.perf_counter() - t,
               driver_thread=driver, equal=got == want)
    print(f"background driver: {json.dumps(rec)}", flush=True)
    if not driver or got != want:
        fail(f"the background engine's tokens differ from engine S's: "
             f"{got} vs {want}")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def check_frontend_launches(results):
    """Exactly 32 B1 launches per cold prefill and none per extend, 32
    B6 (S) or B6q (S8) per decode step, and in S8 225 B7 per prefill,
    extend and decode step."""
    for name, route in (("S", "paged_decode_split"),
                        ("S8", "paged_decode_split_q")):
        r = results[name]
        exp = {k: 0 for k in ("flash_bwd_dq", "flash_bwd_dkv",
                              "paged_decode", "paged_decode_split",
                              "paged_decode_q", "paged_decode_split_q",
                              "quant_matmul")}
        exp["flash_fwd"] = r["prefills"] * LAYERS
        exp[route] = r["decode_steps"] * LAYERS
        if name == "S8":
            exp["quant_matmul"] = (r["prefills"] + r["extends"]
                                   + r["decode_steps"]) * QMM_PER_FORWARD
        for k, n in exp.items():
            if r["launches"][k] != n:
                fail(f"engine {name}: {k} launched {r['launches'][k]} "
                     f"times, expected {n}")


# ---------------------------------------------------------------------------
# speculative phase: the frontend with spec=True on a repetitive corpus
# ---------------------------------------------------------------------------

def spec_traffic(vocab, seed=SPEC_SEED):
    """SPEC_REQUESTS prompts: a seeded 32-64-token phrase repeated to
    400-900 tokens, then a unique 5-20-token tail (a prompt-lookup
    proposer's best case: the context repeats itself)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(SPEC_REQUESTS):
        phrase = rng.integers(0, vocab, int(rng.integers(32, 65)))
        n = int(rng.integers(400, 901))
        body = np.tile(phrase, -(-n // len(phrase)))[:n]
        tail = rng.integers(0, vocab, int(rng.integers(5, 21)))
        out.append(np.concatenate([body, tail]).astype(np.int64))
    return out


def spec_accounting_gates(name, engine, handles):
    """Every step closes; the requests' attributed time sums to the
    engine's; each request's spec_accepted is the sum over its trace's
    ``serving.decode_step`` spans; one request's trace exports as JSON."""
    from paddle_tpu_torch.profiler import tracing
    acct = engine.accounting
    if not acct.armed or not acct.step_log:
        fail(f"engine {name}: accounting is not armed")
    worst = 0.0
    for e in acct.step_log:
        gap = abs(e["attributed_us"] + e["compile_us"] + e["idle_us"]
                  - e["step_us"])
        worst = max(worst, gap / max(e["step_us"], 1.0))
    if worst > CLOSURE_RTOL:
        fail(f"engine {name}: a step's attribution does not close "
             f"(relative gap {worst})")
    costs = [h.cost() for h in handles]
    billed = sum(c.attributed_us for c in costs)
    engine_us = acct.attributed_us + acct.compile_us
    if abs(billed - engine_us) > CLOSURE_RTOL * engine_us:
        fail(f"engine {name}: the requests' attributed time {billed} us is "
             f"not the engine's {engine_us} us")
    for h, c in zip(handles, costs):
        spans = [r for r in tracing.get_trace(h.trace_id)
                 if r["name"] == "serving.decode_step"]
        in_spans = sum(r.get("args", {}).get("spec_accepted", 0)
                       for r in spans)
        if not spans or in_spans != c.spec_accepted:
            fail(f"engine {name}: request {h.rid} accepted "
                 f"{c.spec_accepted} drafts, its spans say {in_spans}")
    doc = json.loads(json.dumps(tracing.export_trace(handles[0].trace_id)))
    if not doc["traceEvents"]:
        fail(f"engine {name}: request {handles[0].rid}'s trace is empty")
    report = acct.engine_report()
    return dict(steps=len(acct.step_log), closure_max_rel_gap=worst,
                requests_attributed_us=billed, engine_attributed_us=
                acct.attributed_us, compile_us=acct.compile_us,
                idle_us=acct.idle_us, mfu=report["mfu"],
                peak_flops=acct.peak_flops,
                tokens_processed=report["tokens_processed"],
                tokens_emitted=report["tokens"],
                trace_events=len(doc["traceEvents"]),
                cost_example=costs[0].as_dict())


def serve_spec(torch, inst, model, name, prompts, spec, engages=True, **kw):
    """The frontend (default flags: prefix cache, budget 512, bucket cap
    1024, admission, brownout, accounting, tracing) with ``spec`` and
    SPEC_TOKENS drafts, warmed up, then ``prompts`` submitted at once,
    SPEC_NEW tokens each. Counts, ``serving.*`` counters and the trace
    ring are zeroed or snapshot just before and read just after. Gates:
    every request DONE with SPEC_NEW tokens, no preemption, proposed =
    accepted + rejected, none of them moving in a plain engine, and with
    ``engages`` (a model whose greedy output repeats its context) drafts
    proposed and accepted in verify sweeps; the accounting gates; the
    teacher-forced check."""
    from paddle_tpu_torch.profiler import metrics, tracing
    engine, warm = frontend_engine(torch, model, name, spec=spec,
                                   spec_tokens=SPEC_TOKENS, **kw)
    sched = engine.scheduler
    if sched.spec != spec:
        fail(f"engine {name}: spec={spec} did not arm as asked")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    inst.reset()
    zero_counts()
    tracing.reset()
    before = metrics.snapshot("serving.")
    t0 = time.perf_counter()
    handles = [engine.submit(p, max_new_tokens=SPEC_NEW) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, routes = read_counts()
    delta = metrics.window_delta(before, metrics.snapshot("serving."))
    peak = torch.cuda.max_memory_allocated() / 2**30
    reqs = [sched.finished[h.rid] for h in handles]
    for r in reqs:
        if r.status != "DONE" or len(r.generated) != SPEC_NEW:
            fail(f"engine {name}: request {r.rid} ended {r.status} with "
                 f"{len(r.generated)} tokens")
    counts = {k: delta.get(k, 0) for k in (
        "serving.preempt", "serving.admitted", "serving.completed",
        "serving.decoded_tokens", "serving.steps", "serving.spec.proposed",
        "serving.spec.accepted", "serving.spec.rejected",
        "serving.spec.steps", "serving.prefix.hit_blocks")}
    proposed, accepted = counts["serving.spec.proposed"], \
        counts["serving.spec.accepted"]
    if counts["serving.preempt"]:
        fail(f"engine {name}: {counts['serving.preempt']} preemptions")
    if proposed != accepted + counts["serving.spec.rejected"]:
        fail(f"engine {name}: spec counters do not add up: {counts}")
    if spec and engages and (counts["serving.spec.steps"] == 0
                             or proposed == 0 or accepted == 0):
        fail(f"engine {name}: no draft was proposed, verified or "
             f"accepted: {counts}")
    if not spec and (proposed or counts["serving.spec.steps"]):
        fail(f"engine {name}: a plain engine speculated: {counts}")
    if inst.calls["verify"] != counts["serving.spec.steps"]:
        fail(f"engine {name}: {inst.calls['verify']} verify sweeps ran, "
             f"serving.spec.steps moved by {counts['serving.spec.steps']}")
    acct = spec_accounting_gates(name, engine, handles)
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    decoded = sum(len(r.generated) - 1 for r in reqs)
    dec_s = inst.secs["decode"] + inst.secs["verify"]
    dec_calls = inst.calls["decode"] + inst.calls["verify"]
    rec = dict(requests=len(prompts), spec=spec, wall_s=wall, warmup=warm,
               prefills=inst.calls["prefill"], extends=inst.calls["extend"],
               prefill_s=inst.secs["prefill"],
               decode_steps=inst.calls["decode"],
               verify_sweeps=inst.calls["verify"],
               decode_s=inst.secs["decode"], verify_s=inst.secs["verify"],
               decode_tokens=decoded,
               decode_tok_per_s=decoded / max(dec_s, 1e-9),
               tokens_per_step=decoded / max(dec_calls, 1),
               acceptance=accepted / proposed if proposed else None,
               ttft_median_s=float(np.median(ttft)), ttft_max_s=ttft[-1],
               peak_mem_gib=peak, counters=counts, accounting=acct,
               launches=launches, routes=routes,
               num_blocks=engine.cache.num_blocks)
    rec["teacher_forced"] = teacher_forced(torch, model, sched,
                                           kv8=engine.cache.quantized)
    rec["tokens"] = [list(map(int, r.generated)) for r in reqs]
    engine.close()
    print(f"engine {name}: " + json.dumps(
        {k: v for k, v in rec.items() if k != "tokens"}), flush=True)
    acc = "n/a" if rec["acceptance"] is None else f"{rec['acceptance']:.4f}"
    mfu = "n/a" if acct["mfu"] is None else f"{acct['mfu']:.6f}"
    print(f"engine {name}: decode {rec['decode_tok_per_s']:.2f} tokens/s, "
          f"{rec['tokens_per_step']:.3f} tokens per step "
          f"({rec['decode_steps']} plain steps, {rec['verify_sweeps']} "
          f"verify sweeps), acceptance {acc} ({accepted}/{proposed}), MFU "
          f"gauge {mfu}, TTFT median {rec['ttft_median_s']:.4f} s max "
          f"{rec['ttft_max_s']:.4f} s", flush=True)
    del engine, sched, reqs, handles
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def repeating_model(torch, cfg):
    """The frontend's model (the same seed, so the same layers) with its
    embedding drawn N(0, REPEAT_EMBED_STD) and the LM head set to the
    embedding's values: the token embedding then outweighs the 32
    layers' sum in the last hidden state, and greedy decode repeats the
    last token, the degenerate repetition prompt lookup is built for.
    (At the 0.02 scale the continuation of a random-weight model never
    reproduces a token of its context, so drafts never match.) Full
    width and depth, bf16."""
    from paddle_tpu_torch import Llama
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    with torch.no_grad():
        model.embed_tokens.weight.normal_(0.0, REPEAT_EMBED_STD,
                                          generator=gen)
        model.lm_head.weight.copy_(model.embed_tokens.weight)
    torch.cuda.synchronize()
    return model


def spec_divergence(torch, model, prompts, plain, spec, kv8=False):
    """Spec tokens against the plain engine's, request by request, up to
    the first position where they differ (past it the two contexts
    differ too). There the teacher-forced top-2 gap of the plain
    sequence must be within GAP_TOL: a near-tie that bf16 rounding may
    break either way (the sweep attends through the plain dense path,
    the plain step through B6/B6q). Returns the first divergences."""
    out = []
    with torch.inference_mode():
        for i, (p, a, b) in enumerate(zip(prompts, plain, spec)):
            j = next((t for t, (x, y) in enumerate(zip(a, b)) if x != y),
                     None)
            if j is None:
                continue
            ids = np.concatenate([p, np.asarray(a)])
            logits = _dense_logits(torch, model, ids,
                                   kv8_attention(len(p)) if kv8 else None)
            top = logits[len(p) - 1 + j].topk(2)
            gap = float(top.values[0] - top.values[1])
            out.append(dict(request=i, position=j, plain=a[j], spec=b[j],
                            gap=gap))
            if gap > GAP_TOL:
                fail(f"request {i}: spec token {j} is {b[j]}, plain decode "
                     f"gave {a[j]} with a top-2 gap of {gap:.3f} > {GAP_TOL}")
    first = min(out, key=lambda d: d["position"]) if out else None
    print(f"spec vs plain tokens: {len(out)} of {len(prompts)} requests "
          f"diverge; first divergence {json.dumps(first)}", flush=True)
    return out


def check_spec_launches(name, r, route, int8):
    """32 B1 launches per cold prefill, 32 B6 (S) or B6q (S8) per plain
    decode step and none in a verify sweep, and with int8 weights 225 B7
    per prefill, extend, plain step and verify sweep; nothing else."""
    exp = {k: 0 for k in ("flash_bwd_dq", "flash_bwd_dkv", "paged_decode",
                          "paged_decode_split", "paged_decode_q",
                          "paged_decode_split_q", "quant_matmul")}
    exp["flash_fwd"] = r["prefills"] * LAYERS
    exp[route] = r["decode_steps"] * LAYERS
    if int8:
        exp["quant_matmul"] = (r["prefills"] + r["extends"]
                               + r["decode_steps"] + r["verify_sweeps"]) \
            * QMM_PER_FORWARD
    for k, n in exp.items():
        if r["launches"][k] != n:
            fail(f"engine {name}: {k} launched {r['launches'][k]} times, "
                 f"expected {n}")


def spec_phase(torch, inst, model, prompts, label, engages=True, **kw):
    """Engine ``label`` plain on the spec traffic, then ``label``-spec;
    their tokens compared, their launches checked. ``kw``: the int8 KV
    cache of S8 and R8 (whose weights are int8 too)."""
    int8 = bool(kw)
    route = "paged_decode_split_q" if int8 else "paged_decode_split"
    plain = serve_spec(torch, inst, model, f"{label} (spec traffic)",
                       prompts, spec=False, **kw)
    spec = serve_spec(torch, inst, model, f"{label}-spec", prompts,
                      spec=True, engages=engages, **kw)
    check_spec_launches(f"{label} (spec traffic)", plain, route, int8)
    check_spec_launches(f"{label}-spec", spec, route, int8)
    spec["divergence"] = spec_divergence(torch, model, prompts,
                                         plain["tokens"], spec["tokens"],
                                         kv8=int8)
    spec["plain"] = plain
    print(f"engine {label}-spec vs plain: decode "
          f"{spec['decode_tok_per_s']:.2f} vs {plain['decode_tok_per_s']:.2f}"
          f" tokens/s, {spec['tokens_per_step']:.3f} vs "
          f"{plain['tokens_per_step']:.3f} tokens per step, burst "
          f"{spec['wall_s']:.3f} vs {plain['wall_s']:.3f} s", flush=True)
    return spec


_VERIFY_GROUPS = (
    ("quant_matmul", "B7 int8 weight matmul (port)"),
    ("qmm_", "B7 int8 weight matmul (port)"),
    ("paged_decode", "decode attention (port)"),
    ("flash_fwd", "B1 flash forward (port)"),
) + tuple((key, "cuBLAS bf16 matmul") for key, _ in _MATMUL_GROUPS)


def _profiled(torch, fn, steps, ranges):
    """torch.profiler over ``steps`` calls of ``fn``, with the module
    functions ``ranges`` ({name in paged: range}) wrapped in
    record_function ranges: wall ms, device busy ms, kernels and device
    ms by group, per call, and each range's device ms per call."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import paddle_tpu_torch.inference.paged as paged_mod
    orig = {n: getattr(paged_mod, n) for n in ranges}

    def traced(f, rng):
        def run(*a, **k):
            with record_function(rng):
                return f(*a, **k)
        return run

    for n, f in orig.items():
        setattr(paged_mod, n, traced(f, ranges[n]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        for n, f in orig.items():
            setattr(paged_mod, n, f)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    groups, busy_us, n_kernels = {}, 0.0, 0
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n_kernels += 1
        grp = next((lab for key, lab in _VERIFY_GROUPS if key in e.name),
                   "other (elementwise, norms, rope, gathers, copies)")
        groups[grp] = groups.get(grp, 0.0) + us / 1e3 / steps
    rng_ms = {rng: sum(getattr(e, "device_time_total", 0.0) for e in events
                       if e.device_type != cuda and e.name == rng)
              / 1e3 / steps for rng in set(ranges.values())}
    return dict(host_ms=wall_ms / steps, device_busy_ms=busy_us / 1e3 / steps,
                device_busy_share=busy_us / 1e3 / wall_ms if wall_ms
                else None, kernels=n_kernels / steps, by_group_ms=groups,
                ranges_ms=rng_ms)


def profile_verify(torch, model, prompts, label, steps=2, **engine_kw):
    """One verify sweep of 8 live slots (1 + SPEC_TOKENS positions each,
    every draft row real) beside one plain decode step on the same cache:
    host ms (synchronized, median of 3 sweeps or 2 steps), then
    torch.profiler over ``steps`` of each: device busy, kernels, device
    time by group, the plain verify attention's device ms
    (``paged_spec_attention_dense``) and the decode attention's."""
    from paddle_tpu_torch import ContinuousBatchingEngine
    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=2048, temperature=0.0,
                                      **engine_kw)
    for p in prompts:
        engine.add_request(p, 8)
    engine.step()  # prefills every request and decodes once
    cache = engine.cache
    active = np.array(cache._live)
    for slot in np.flatnonzero(active):
        # room for the sweep's rows and the plain steps after it
        if not cache.prepare_append_range(
                int(slot), int(cache.seq_lens[slot]) + 1 + SPEC_TOKENS):
            fail(f"profile_verify ({label}): no room for the sweep")
    last = np.zeros((cache.max_batch,), np.int64)
    drafts = np.zeros((cache.max_batch, SPEC_TOKENS), np.int64)
    n_in = np.full((cache.max_batch,), 1 + SPEC_TOKENS, np.int64)
    n_in[~active] = 0

    def sweep():
        model.paged_spec_step(cache, last, drafts, n_in, active)

    def step():
        model.paged_decode_step(cache, last, active)

    def host(fn, n):
        secs = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return float(np.median(secs)) * 1e3

    sweep()  # warm
    rec = dict(live_slots=int(active.sum()), rows=int(n_in.sum()),
               sweep_host_ms=host(sweep, 3))
    rec["sweep"] = _profiled(torch, sweep, steps, {
        "paged_spec_attention_dense": "verify_attention",
        "paged_spec_write": "cache_write", "paged_spec_write_q":
        "cache_write"})
    # the plain steps advance seq_lens: 2 + steps positions, within the
    # 1 + SPEC_TOKENS prepared above
    rec["step_host_ms"] = host(step, 2)
    rec["step"] = _profiled(torch, step, steps, {})
    sw = rec["sweep"]
    b7 = sw["by_group_ms"].get("B7 int8 weight matmul (port)")
    print(f"verify sweep profile (engine {label}, {rec['live_slots']} "
          f"slots x {1 + SPEC_TOKENS} rows): host {rec['sweep_host_ms']:.2f}"
          f" ms, device busy {sw['device_busy_ms']:.2f} ms, plain verify "
          f"attention {sw['ranges_ms']['verify_attention']:.2f} ms, B7 at M "
          f"{QMM_VERIFY_M} {b7} ms; plain decode step host "
          f"{rec['step_host_ms']:.2f} ms, device busy "
          f"{rec['step']['device_busy_ms']:.2f} ms: {json.dumps(rec)}",
          flush=True)
    if sw["device_busy_ms"] == 0.0:
        print("profile: the profiler saw no device time; verify breakdown "
              "not measured", flush=True)
    del engine
    torch.cuda.empty_cache()
    return rec


def slice_phase(torch):
    from paddle_tpu_torch import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    torch.cuda.synchronize()
    print(f"Llama-3-8B: {model.num_params() / 1e9:.3f}B params bf16, built "
          f"in {time.perf_counter() - t:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    rng = np.random.default_rng(0)

    def prompts(n, lo, hi):
        out = []
        while len(out) < n:
            s = int(rng.integers(lo, hi + 1))
            if s % 16:  # never a block multiple
                out.append(rng.integers(0, cfg.vocab_size, s).astype(
                    np.int64))
        return out

    # name, engine kwargs, requests, prompt lengths, new tokens; the int8
    # engines (A8, B8) take A's and B's prompts and token counts
    bf16_engines = (("A", dict(max_seq_len=2048), 8, 100, 1000, 32),
                    ("B", dict(max_seq_len=240), 4, 20, 180, 24))
    results, asked = {}, {}
    front = front_traffic(cfg.vocab_size)
    inst = Instrumented(torch, model)
    for name, kw, n, lo, hi, new in bf16_engines:
        asked[name] = (prompts(n, lo, hi), new)
        results[name] = run_engine(torch, inst, model, name, *asked[name],
                                   **kw)
    results["S"] = serve_frontend(torch, inst, model, "S", front)
    spec_prompts = spec_traffic(cfg.vocab_size)
    results["S-spec"] = spec_phase(torch, inst, model, spec_prompts, "S",
                                   engages=False)
    inst.restore()
    results["S"]["background"] = background_check(
        torch, model, front[:4], results["S"]["tokens"][:4])
    results["A"]["profile"] = profile_decode(torch, model, asked["A"][0], 8)
    long_prompt = prompts(1, PREFILL_PROFILE_LEN, PREFILL_PROFILE_LEN)[0]
    results["A"]["prefill_profile"] = profile_prefill(torch, model,
                                                      long_prompt, "A")
    # one extend as the frontend runs it: a 200-token tail (bucket 256)
    # over the 512-token system prompt
    ext_prompt = np.concatenate([front[0][:FRONT_SYSTEM],
                                 prompts(1, 200, 200)[0]])
    results["S"]["extend_profile"] = profile_prefill(
        torch, model, ext_prompt, "S, extend", prefix_len=FRONT_SYSTEM)
    results["S-spec"]["verify_profile"] = profile_verify(
        torch, model, spec_prompts, "S-spec")
    results["generate"] = generate_phase(torch, model, cfg.vocab_size)
    results["telemetry"] = telemetry_phase(
        torch, model, front, results["S"]["decode_tok_per_s"])

    # engines R-spec and R8-spec: the same traffic on a model whose greedy
    # output repeats itself, bf16 and then int8 weights + KV
    rmodel = repeating_model(torch, cfg)
    rinst = Instrumented(torch, rmodel)
    results["R-spec"] = spec_phase(torch, rinst, rmodel, spec_prompts, "R")
    results["R8-spec"] = dict(int8_model=convert_int8(torch, rmodel))
    results["R8-spec"].update(spec_phase(torch, rinst, rmodel, spec_prompts,
                                         "R8", kv_cache_dtype="int8"))
    rinst.restore()
    del rinst, rmodel
    gc.collect()
    torch.cuda.empty_cache()

    results["int8_model"] = convert_int8(torch, model)
    inst = Instrumented(torch, model)
    for name, kw, *_ in bf16_engines:
        results[name + "8"] = run_engine(torch, inst, model, name + "8",
                                         *asked[name], kv_cache_dtype="int8",
                                         **kw)
    results["S8"] = serve_frontend(torch, inst, model, "S8", front,
                                   kv_cache_dtype="int8")
    results["S8-spec"] = spec_phase(torch, inst, model, spec_prompts, "S8",
                                    engages=False, kv_cache_dtype="int8")
    inst.restore()
    prof8 = profile_decode(torch, model, asked["A"][0], 8, label="A8",
                           kv_cache_dtype="int8")
    results["A8"]["profile"] = prof8
    results["B8"]["profile"] = profile_decode(
        torch, model, asked["B"][0], 8, label="B8", max_seq_len=240,
        kv_cache_dtype="int8")
    results["A8"]["prefill_profile"] = profile_prefill(
        torch, model, long_prompt, "A8", kv_cache_dtype="int8")
    results["S8"]["extend_profile"] = profile_prefill(
        torch, model, ext_prompt, "S8, extend", prefix_len=FRONT_SYSTEM,
        kv_cache_dtype="int8")
    results["S8-spec"]["verify_profile"] = profile_verify(
        torch, model, spec_prompts, "S8-spec", kv_cache_dtype="int8")
    pa, p8 = results["A"]["prefill_profile"], results["A8"]["prefill_profile"]
    print(f"prefill of {pa['tokens']} tokens: A {pa['prefill_ms']:.2f} ms, "
          f"A8 {p8['prefill_ms']:.2f} ms (host clock); TTFT medians: A "
          f"{results['A']['ttft_median_s']:.4f} s, A8 "
          f"{results['A8']['ttft_median_s']:.4f} s, B "
          f"{results['B']['ttft_median_s']:.4f} s, B8 "
          f"{results['B8']['ttft_median_s']:.4f} s", flush=True)
    b7 = prof8["by_group_ms_per_step"].get("int8 weight matmul (port)")
    mm = results["A"]["profile"]["by_group_ms_per_step"].get("matmul")
    print(f"decode step device time, 8 live slots: B7 (engine A8) {b7} ms "
          f"vs bf16 cuBLAS matmuls (engine A) {mm} ms", flush=True)

    del inst, model
    gc.collect()
    torch.cuda.empty_cache()

    none = {k: 0 for k in ("flash_bwd_dq", "flash_bwd_dkv", "paged_decode",
                           "paged_decode_split", "paged_decode_q",
                           "paged_decode_split_q", "quant_matmul")}
    want = {}
    for name, route in (("A", "paged_decode_split"), ("B", "paged_decode"),
                        ("A8", "paged_decode_split_q"),
                        ("B8", "paged_decode_q")):
        r = results[name]
        want[name] = dict(none, flash_fwd=r["prefills"] * LAYERS,
                          **{route: r["decode_steps"] * LAYERS})
        if name.endswith("8"):
            want[name]["quant_matmul"] = \
                (r["prefills"] + r["decode_steps"]) * QMM_PER_FORWARD
    for name, exp in want.items():
        got = results[name]["launches"]
        for k, n in exp.items():
            if got[k] != n:
                fail(f"engine {name}: {k} launched {got[k]} times, "
                     f"expected {n}")
        if results[name]["decode_steps"] == 0:
            fail(f"engine {name} ran no decode step")
    check_frontend_launches(results)
    return results, asked["B"]


# ---------------------------------------------------------------------------
# generate phase: dense generation against the paged engine
# ---------------------------------------------------------------------------

def generate_phase(torch, model, vocab):
    """``model.generate`` (greedy, the contiguous cache, plain cached
    attention as in the JAX package) on GEN_PROMPTS prompts of GEN_LEN
    tokens, GEN_NEW new each, against ``ContinuousBatchingEngine`` on the
    same prompts (examples/serve_llm.py:276-288): tokens equal up to each
    request's first divergence, where the teacher-forced top-2 gap must
    lie within GAP_TOL (``spec_divergence``); and every generated token
    whose teacher-forced gap exceeds GAP_TOL equal to the dense
    forward's argmax (``teacher_forced``). Then one eos case: eos set
    to the token row 0 emits at its 6th new position: every row keeps its
    free-running tokens up to its first eos and emits only eos after.
    The dense path launches no kernel of the port; the engine's launches
    are counted."""
    from paddle_tpu_torch import ContinuousBatchingEngine
    rng = np.random.default_rng(GEN_SEED)
    prompts = rng.integers(0, vocab, (GEN_PROMPTS, GEN_LEN)).astype(np.int64)
    model.generate(prompts[:1, :16], max_new_tokens=2)  # first-call setup
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    gen_launches, _ = read_counts()
    if any(gen_launches.values()):
        fail(f"generate launched kernels of the port: {gen_launches}")
    gen = out[:, GEN_LEN:].cpu().numpy()
    if out.shape != (GEN_PROMPTS, GEN_LEN + GEN_NEW):
        fail(f"generate returned {tuple(out.shape)}")

    engine = ContinuousBatchingEngine(model, max_batch=8, block_size=16,
                                      max_seq_len=256, temperature=0.0)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rids = [engine.add_request(p, GEN_NEW) for p in prompts]
    while engine.has_work:
        engine.step()
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t
    eng_launches, _ = read_counts()
    paged = [list(map(int, engine.finished[r].generated)) for r in rids]
    del engine
    divergences = spec_divergence(torch, model, list(prompts), paged,
                                  [list(map(int, row)) for row in gen])
    equal = sum(a == list(map(int, b)) for a, b in zip(paged, gen))
    # generate's own tokens against the dense forward (B1) over prompt +
    # generated, every position where the top-2 gap is beyond GAP_TOL
    ran = types.SimpleNamespace(finished={
        i: types.SimpleNamespace(rid=i, prompt=p, generated=list(map(
            int, row))) for i, (p, row) in enumerate(zip(prompts, gen))})
    forced = teacher_forced(torch, model, ran)

    eos = int(gen[0, 5])
    with_eos = model.generate(prompts, max_new_tokens=GEN_NEW,
                              eos_token_id=eos)[:, GEN_LEN:].cpu().numpy()
    for i, (free, row) in enumerate(zip(gen, with_eos)):
        # up to its first eos a row runs free; from there on, only eos
        first = int(np.argmax(free == eos)) if (free == eos).any() \
            else GEN_NEW
        if not (row[:first] == free[:first]).all() or \
                not (row[first:] == eos).all():
            fail(f"generate with eos {eos}: row {i} {row.tolist()} against "
                 f"free-running {free.tolist()}")
    rec = dict(prompts=GEN_PROMPTS, prompt_len=GEN_LEN, new=GEN_NEW,
               generate_s=gen_s,
               generate_tok_per_s=GEN_PROMPTS * GEN_NEW / gen_s,
               engine_s=eng_s, engine_tok_per_s=GEN_PROMPTS * GEN_NEW / eng_s,
               equal_requests=equal, divergences=divergences, eos=eos,
               teacher_forced=forced,
               engine=dict(launches=eng_launches))
    print(f"generate: {json.dumps(rec)}", flush=True)
    print(f"generate (greedy, {GEN_PROMPTS} x {GEN_LEN} + {GEN_NEW}): "
          f"{rec['generate_tok_per_s']:.1f} tokens/s against the paged "
          f"engine's {rec['engine_tok_per_s']:.1f} (prefill included); "
          f"{equal} of {GEN_PROMPTS} requests equal", flush=True)
    if eng_launches["flash_fwd"] != GEN_PROMPTS * LAYERS:
        fail(f"generate's engine: {eng_launches['flash_fwd']} B1 launches "
             f"for {GEN_PROMPTS} prefills")
    return rec


# ---------------------------------------------------------------------------
# telemetry phase: a serving engine's alerts and metrics endpoint
# ---------------------------------------------------------------------------

def _scrape(url, expect=200):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            code, body = r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        code, body = e.code, e.read().decode()
    if code != expect:
        fail(f"telemetry: GET {url} gave {code}, expected {expect}: "
             f"{body[:300]}")
    return body


def _ttft_burn_records():
    from paddle_tpu_torch.distributed import watchdog
    return [r for r in watchdog.flight_recorder().records()
            if r["tag"] == "alert.slo.ttft_burn"]


def telemetry_phase(torch, model, prompts, s_decode):
    """Engine S's traffic (``front_traffic``) on a ``ServingEngine`` with
    ``serve_metrics(port=0)`` attached, two windows:

    1. default flags; then every route is scraped with urllib: the
       ``serving.*`` counters of ``/metrics`` equal the registry's,
       ``/healthz`` and ``/readyz`` 200, ``/alerts`` attached with the five
       default rules, ``/summary`` with its sections, and the worst TTFT
       exemplar's trace resolving at ``/traces/<id>``;
    2. ``FLAGS_slo_ttft_budget_us`` below every TTFT: the traffic again
       with the interval held long (no evaluation mid-window), then
       interval 0, so the ``/alerts`` scrape's nudge evaluates the whole
       window: ``slo.ttft_burn`` fires once, its trace resolves, the ring
       holds one ``alert.slo.ttft_burn`` record, the summary lists it;
       with the budget restored the next scrape resolves it into history.

    Flags are restored; the endpoint is gone after ``close()``. Prints
    ``maybe_evaluate``'s host cost when not due and of one evaluation,
    and the engine's decode tokens/s beside engine S's; then
    ``endpoint_ab``."""
    import urllib.error
    import urllib.request
    from paddle_tpu_torch.core import get_flags, set_flags
    from paddle_tpu_torch.profiler import export, metrics
    from paddle_tpu_torch.serving import ServingEngine
    names = ("FLAGS_slo_ttft_budget_us", "FLAGS_alert_interval_s")
    saved = get_flags(list(names))
    inst = Instrumented(torch, model)
    engine = ServingEngine(model, max_batch=8, block_size=16,
                           max_seq_len=2048, temperature=0.0,
                           background=False)
    srv = engine.serve_metrics(port=0)
    rec = dict(port=srv.port)
    # the latency histograms restart: exemplars never age, and an earlier
    # engine's larger TTFTs would hold every bucket with traces the ring
    # has rotated out
    for name in ("serving.ttft_us", "serving.itl_us",
                 "serving.queue_wait_us"):
        metrics.reset(name)
    try:
        # window 1: default flags
        zero_counts()
        inst.reset()
        for p in prompts:
            engine.submit(p, max_new_tokens=FRONT_NEW)
        engine.run_until_idle()
        torch.cuda.synchronize()
        launches, _ = read_counts()
        decoded = len(prompts) * (FRONT_NEW - 1)
        rec.update(launches=launches, decode_steps=inst.calls["decode"],
                   decode_tok_per_s=decoded / max(inst.secs["decode"],
                                                  1e-9))
        parsed = export.parse_prometheus(_scrape(srv.url("/metrics")))
        snap = metrics.snapshot("serving.")
        kinds = metrics.registry.kinds("serving.")
        counters = {n: v for n, v in snap.items()
                    if kinds[n] is metrics.Counter}
        off = {n: (v, parsed.get(export._pname(n), {}).get("value"))
               for n, v in counters.items()
               if parsed.get(export._pname(n), {}).get("value") != v}
        if off:
            fail(f"telemetry: /metrics disagrees with the registry: {off}")
        hz = json.loads(_scrape(srv.url("/healthz")))
        rz = json.loads(_scrape(srv.url("/readyz")))
        al = json.loads(_scrape(srv.url("/alerts")))
        if not al["attached"] or len(al["rules"]) != 5:
            fail(f"telemetry: /alerts {al}")
        summary = _scrape(srv.url("/summary"))
        sections = ("Serving / SLO View", "Slow requests", "Capacity View",
                    "Goodput")
        missing = [x for x in sections if x not in summary]
        if missing:
            fail(f"telemetry: /summary lacks {missing}")
        ex = snap["serving.ttft_us"]["exemplars"]
        worst = max(ex.values(), key=lambda e: e["value"])
        trace = json.loads(_scrape(srv.url(f"/traces/{worst['trace_id']}")))
        _scrape(srv.url("/traces/no-such-trace"), expect=404)
        json.loads(_scrape(srv.url("/traces")))
        json.loads(_scrape(srv.url("/metrics/delta")))
        rec.update(counters_checked=len(counters), healthz=hz["status"],
                   ready=rz["ready"], rules=[r["name"] for r in al["rules"]],
                   window1_incidents=[i["rule"] for i in al["active"]],
                   worst_ttft_us=worst["value"],
                   worst_trace_events=len(trace["traceEvents"]))

        # maybe_evaluate's host cost: not due, and one evaluation
        set_flags({"FLAGS_alert_interval_s": 3600.0})
        mgr = engine.alerts
        mgr.evaluate()
        n = 20000
        t = time.perf_counter()
        for _ in range(n):
            mgr.maybe_evaluate()
        rec["maybe_evaluate_not_due_us"] = \
            (time.perf_counter() - t) / n * 1e6
        t = time.perf_counter()
        for _ in range(50):
            mgr.evaluate()
        rec["evaluate_ms"] = (time.perf_counter() - t) / 50 * 1e3

        # window 2: the budget below every TTFT
        set_flags({"FLAGS_slo_ttft_budget_us": TELE_BUDGET_US})
        before = len(_ttft_burn_records())
        fired0 = metrics.counter("alerts.fired").value
        hist0 = sum(i["rule"] == "slo.ttft_burn" for i in mgr.history())
        mgr.evaluate()  # the window opens here
        for p in prompts:
            engine.submit(p, max_new_tokens=FRONT_NEW)
        engine.run_until_idle()
        if any(i["rule"] == "slo.ttft_burn" for i in mgr.active()):
            fail("telemetry: slo.ttft_burn evaluated mid-window")
        set_flags({"FLAGS_alert_interval_s": 0.0})
        al = json.loads(_scrape(srv.url("/alerts")))
        burn = [i for i in al["active"] if i["rule"] == "slo.ttft_burn"]
        if len(burn) != 1 or not burn[0].get("trace_id"):
            fail(f"telemetry: slo.ttft_burn did not fire once with a trace "
                 f"id: {al}")
        inc = burn[0]
        trace = json.loads(_scrape(srv.url(f"/traces/{inc['trace_id']}")))
        recs = _ttft_burn_records()
        if len(recs) != before + 1 or recs[-1].get("trace") != \
                inc["trace_id"]:
            fail(f"telemetry: the flight ring holds {len(recs) - before} "
                 f"new alert.slo.ttft_burn records: {recs[-2:]}")
        summary = _scrape(srv.url("/summary"))
        if "Recent incidents" not in summary or \
                "alert.slo.ttft_burn" not in summary:
            fail("telemetry: the summary lacks the incident")
        set_flags({"FLAGS_slo_ttft_budget_us":
                   saved["FLAGS_slo_ttft_budget_us"]})
        al = json.loads(_scrape(srv.url("/alerts")))
        resolved = [i for i in al["history"]
                    if i["rule"] == "slo.ttft_burn" and "resolved" in i]
        if any(i["rule"] == "slo.ttft_burn" for i in al["active"]) or \
                len(resolved) != hist0 + 1:
            fail(f"telemetry: slo.ttft_burn did not resolve: {al}")
        rec.update(burn=dict(value=inc["value"], detail=inc["detail"],
                             trace_events=len(trace["traceEvents"])),
                   fired_all_rules=metrics.counter("alerts.fired").value
                   - fired0, ttft_burn_fired=len(recs) - before,
                   ttft_burn_resolved=len(resolved) - hist0)
    finally:
        set_flags(saved)
        inst.restore()
        engine.close()
    try:
        urllib.request.urlopen(srv.url("/healthz"), timeout=5)
    except urllib.error.URLError:
        pass
    else:
        fail("telemetry: the endpoint answers after close()")
    print(f"telemetry: {json.dumps(rec)}", flush=True)
    print(f"telemetry: maybe_evaluate {rec['maybe_evaluate_not_due_us']:.3f}"
          f" us a step when not due, one evaluation "
          f"{rec['evaluate_ms']:.3f} ms; decode {rec['decode_tok_per_s']:.1f}"
          f" tokens/s with alerts and the endpoint (engine S this run "
          f"{s_decode:.1f})", flush=True)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    rec["endpoint_ab"] = endpoint_ab(torch, model, prompts)
    return rec


def endpoint_ab(torch, model, prompts):
    """The endpoint's cost on decode: ``prompts`` on two engines built
    alike (alerts armed on both), one with ``serve_metrics(port=0)``
    attached, in AB_ORDER, so that each is once cold and once warm (its
    prefix cache full). Returns each run's decode tokens/s and median
    decode step (host clock, synchronized)."""
    from paddle_tpu_torch.serving import ServingEngine
    inst = Instrumented(torch, model)
    engines = {label: ServingEngine(model, max_batch=8, block_size=16,
                                    max_seq_len=2048, temperature=0.0,
                                    background=False)
               for label in ("bare", "attached")}
    engines["attached"].serve_metrics(port=0)
    runs = []
    try:
        for label in AB_ORDER:
            inst.reset()
            for p in prompts:
                engines[label].submit(p, max_new_tokens=FRONT_NEW)
            engines[label].run_until_idle()
            torch.cuda.synchronize()
            steps = inst.steps["decode"]
            runs.append(dict(
                engine=label, decode_steps=len(steps),
                decode_tok_per_s=len(prompts) * (FRONT_NEW - 1)
                / max(sum(steps), 1e-9),
                decode_step_median_ms=float(np.median(steps)) * 1e3))
    finally:
        inst.restore()
        for e in engines.values():
            e.close()
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    by = {label: [r for r in runs if r["engine"] == label]
          for label in ("bare", "attached")}
    fmt = lambda key, f: " / ".join(
        f"{label} " + ", ".join(f.format(r[key]) for r in rs)
        for label, rs in by.items())
    print(f"telemetry A/B: {json.dumps(runs)}", flush=True)
    print(f"telemetry A/B (cold, warm): decode tokens/s "
          f"{fmt('decode_tok_per_s', '{:.1f}')}; median decode step ms "
          f"{fmt('decode_step_median_ms', '{:.2f}')}", flush=True)
    return runs

# ---------------------------------------------------------------------------
# training phase: GPT-2 medium trained by TrainStep
# ---------------------------------------------------------------------------

def route_gate(torch, model, batch, watched, label="qkv", reference=False):
    """One forward + backward (``model.loss(*batch)``) on the kernel route
    and one on the plain route (FLAGS_flash_kernel=plain), from the same
    weights and batch: the loss, the global grad norm and the least
    cosine between the two routes' grads of the parameters
    ``watched(model)`` names, one per layer (GPT: every qkv_proj weight;
    ViT: every q_proj weight).

    With ``reference`` a third run, a float32 copy of the model on the
    plain route, tells which layers' grads bf16 resolves: a layer whose
    plain-route grads are within half the cosine budget of float32's
    (GATE_RESOLVED_COSINE) must have the two routes within
    GATE_MIN_COSINE of each other. Two correct bf16 routes, each that far
    from the truth, stay within the budget of each other. Deeper layers,
    where the two routes' own rounding moves the grads more than the
    budget (ViT-L/16 at initialization: near-uniform attention, dP -
    Delta cancelling), are recorded with all three cosines and held by the
    loss and the global norm. At least one layer must be resolved."""
    from paddle_tpu_torch.core import set_flags
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    cosine = torch.nn.functional.cosine_similarity

    def run(m, args, mode):
        set_flags({"FLAGS_flash_kernel": mode})
        try:
            m.zero_grad(set_to_none=True)
            loss = m.loss(*args)
            loss.backward()
            norm = ClipGradByGlobalNorm.global_norm(
                [p.grad for p in m.parameters()]).item()
            return loss.item(), norm, [p.grad.float().flatten()
                                       for p in watched(m)]
        finally:
            set_flags({"FLAGS_flash_kernel": "auto"})
            m.zero_grad(set_to_none=True)

    (lk, nk, gk), (lp, np_, gp) = (run(model, batch, mode)
                                   for mode in ("auto", "plain"))
    cos = [cosine(a, b, dim=0).item() for a, b in zip(gk, gp)]
    key = f"{label}_grad_min_cosine"
    rec = {"loss_kernel": lk, "loss_plain": lp,
           "loss_rel_diff": abs(lk - lp) / abs(lp), "grad_norm_kernel": nk,
           "grad_norm_plain": np_, "grad_norm_rel_diff": abs(nk - np_) / np_,
           key: min(cos),
           "tolerances": dict(loss_rtol=GATE_LOSS_RTOL,
                              norm_rtol=GATE_NORM_RTOL,
                              min_cosine=GATE_MIN_COSINE)}
    if reference:
        m32 = copy.deepcopy(model).float()
        args32 = tuple(t.float() if t.is_floating_point() else t
                       for t in batch)
        l32, n32, g32 = run(m32, args32, "plain")
        del m32
        torch.cuda.empty_cache()
        vs32 = {r: [cosine(a, b, dim=0).item() for a, b in zip(g, g32)]
                for r, g in (("kernel", gk), ("plain", gp))}
        resolved = [i for i, c in enumerate(vs32["plain"])
                    if c >= GATE_RESOLVED_COSINE]
        rec.update({
            key: min((cos[i] for i in resolved), default=-1.0),
            "resolved_layers": resolved, "loss_f32": l32,
            "grad_norm_f32": n32,
            "per_layer_cosine": dict(kernel_vs_plain=cos,
                                     kernel_vs_f32=vs32["kernel"],
                                     plain_vs_f32=vs32["plain"])})
        rec["tolerances"]["resolved_cosine"] = GATE_RESOLVED_COSINE
    print(f"route gate (kernel vs plain, one fwd+bwd): {json.dumps(rec)}",
          flush=True)
    if not (math.isfinite(lk) and math.isfinite(nk)):
        fail("route gate: non-finite loss or grad norm on the kernel route")
    if rec["loss_rel_diff"] > GATE_LOSS_RTOL or \
            rec["grad_norm_rel_diff"] > GATE_NORM_RTOL or \
            rec[key] < GATE_MIN_COSINE:
        fail(f"route gate: the kernel route disagrees with the plain "
             f"route: {rec}")
    return rec


_TRAIN_GROUPS = (
    ("flash_fwd", "attention forward (port)"),
    ("flash_bwd", "attention backward (port)"),
) + _MATMUL_GROUPS
_OTHER = "elementwise, norms, reductions, copies (fwd/bwd)"
# the fp8 step's own groups: record_function ranges around amp.fp8's
# helpers (none calls another), each range's device time taken out of
# the group its kernels' names fall in: the products (cuBLASLt's nvjet
# kernels, and a memset) out of "matmul", the rest out of _OTHER
_FP8_MM = "fp8 matmul (torch._scaled_mm, cuBLASLt)"
_FP8_QUANT = "fp8 quantize/amax"
_FP8_COPIES = "fp8 transposed copies (backward layouts)"
_FP8_RANGES = {"fp8_gemm": _FP8_MM, "_update_scales": _FP8_QUANT,
               "_grad_scale": _FP8_QUANT, "_quantize": _FP8_QUANT,
               "_transposed": _FP8_COPIES, "_pad_rows": _FP8_COPIES}


def profile_train(torch, step, opt, batch, steps=PROFILED_STEPS, fp8=False,
                  label="GPT-2 medium", kernel_groups=_TRAIN_GROUPS):
    """torch.profiler over ``steps`` train steps (``step(*batch)``):
    device busy time per step by kernel group (``kernel_groups``), the
    optimizer's share (kernels launched inside its ``record_function``
    range: clip + update + write-back), kernel launches per step and the
    idle share of the window. With ``fp8`` the fp8 products, the
    quantize/amax passes and the transposed copies are groups of their own
    (``_FP8_RANGES``)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    import paddle_tpu_torch.amp.fp8 as fp8_mod
    update = opt._update_all
    ranges = _FP8_RANGES if fp8 else {}
    orig = {n: getattr(fp8_mod, n) for n in ranges}

    def traced(f, rng):
        # wraps: fp8_gemm counts into the attribute of whatever its module
        # name holds, here the wrapper (launches while profiled are not
        # the main path's and are read by no one)
        @functools.wraps(f)
        def run(*a, **k):
            with record_function(rng):
                return f(*a, **k)
        return run

    def traced_update():
        with record_function("optimizer"):
            update()

    opt._update_all = traced_update
    for n, f in orig.items():
        setattr(fp8_mod, n, traced(f, ranges[n]))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(steps):
                step(*batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    finally:
        del opt._update_all
        for n, f in orig.items():
            setattr(fp8_mod, n, f)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    busy_us, n_kernels, groups, by_name = 0.0, 0, {}, {}
    for e in events:
        if e.device_type != cuda or getattr(e, "is_user_annotation", False):
            continue
        us = e.time_range.end - e.time_range.start
        busy_us += us
        n_kernels += 1
        g = next((lab for key, lab in kernel_groups if key in e.name),
                 _OTHER)
        groups[g] = groups.get(g, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us

    def range_ms(name):
        return sum(getattr(e, "device_time_total", 0.0) for e in events
                   if e.device_type != cuda and e.name == name) / 1e3 / steps

    per_step = {g: us / 1e3 / steps for g, us in groups.items()}
    opt_ms = range_ms("optimizer")
    if opt_ms > 0:
        per_step["optimizer (clip + AdamW + write-back)"] = opt_ms
        per_step[_OTHER] = per_step.get(_OTHER, 0.0) - opt_ms
    for rng in sorted(set(ranges.values())):
        per_step[rng] = range_ms(rng)
        out_of = "matmul" if rng == _FP8_MM else _OTHER
        per_step[out_of] = per_step.get(out_of, 0.0) - per_step[rng]
    busy_ms = busy_us / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    rec = dict(steps=steps, step_ms=wall_ms / steps,
               device_busy_ms_per_step=busy_ms / steps,
               attention_bwd_ms_per_step=per_step.get(
                   "attention backward (port)", 0.0),
               idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               kernels_per_step=n_kernels / steps,
               by_group_ms_per_step=per_step,
               optimizer_measured=opt_ms > 0,
               top=[dict(name=n[:90], ms_per_step=us / 1e3 / steps)
                    for n, us in top])
    print(f"profile ({label} {'fp8' if fp8 else 'bf16'}, {steps} train "
          f"steps): {json.dumps(rec)}", flush=True)
    if busy_ms == 0.0:
        print("profile: the profiler saw no device time; busy share not "
              "measured", flush=True)
    return rec


def init_digest(model, ids):
    """Sums of the embedding, the first qkv weight and the batch: equal
    when two phases build the same model from the same generator."""
    return [float(model.wte.weight.detach().float().sum()),
            float(model.h[0].attn.qkv_proj.weight.detach().float().sum()),
            int(ids.sum())]


def run_steps(torch, model, batch, step_fn, lr=3e-4, timed=TIMED_STEPS):
    """AdamW ``lr``, clip 1.0, ``TrainStep`` on one batch: WARMUP_STEPS +
    ``timed`` steps, counts zeroed just before and read just after.
    Returns (losses, seconds of the timed steps, launches, step, opt)."""
    from paddle_tpu_torch import AdamW, TrainStep
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    opt = AdamW(learning_rate=lr, parameters=model.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = TrainStep(model, opt, step_fn)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses = [step(*batch) for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(timed):
        losses.append(step(*batch))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches, _ = read_counts()
    return [float(x) for x in losses], secs, launches, step, opt


def timed_steps(torch, model, ids):
    """GPT-2 medium's ``run_steps`` (next-token loss on ``ids``) and its
    record: tokens/s, MFU, peak memory, launches."""
    losses, secs, launches, step, opt = run_steps(
        torch, model, (ids,), lambda m, x: m.loss(x, x))
    tok_s = GPT_B * GPT_S * TIMED_STEPS / secs
    flops_tok = model.flops_per_token(GPT_S)
    rec = dict(config="gpt2_medium", batch=GPT_B, seq=GPT_S,
               steps=WARMUP_STEPS + TIMED_STEPS, losses=losses,
               step_ms=secs / TIMED_STEPS * 1e3, tokens_per_s=tok_s,
               flops_per_token=flops_tok,
               mfu=flops_tok * tok_s / BF16_FLOPS_PER_S,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    return rec, step, opt


def check_train(name, rec, fp8_per_step=0, layers=GPT_LAYERS):
    """Finite losses that fall on the repeated batch; B1, B2 and B3
    ``layers`` times a step, ``fp8_per_step`` fp8 products a step, nothing
    else (no segment launch, no decode or int8 kernel, no masked SDPA)."""
    losses, launches = rec["losses"], rec["launches"]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{name}: a loss is not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{name}: the loss did not fall on a repeated batch: {losses}")
    want = dict.fromkeys(launches, 0)
    steps = rec["steps"]
    want.update(flash_fwd=layers * steps,
                flash_bwd_dq=layers * steps,
                flash_bwd_dkv=layers * steps,
                fp8_gemm=fp8_per_step * steps)
    for k, n in want.items():
        if launches[k] != n:
            fail(f"{name}: {k} launched {launches[k]} times, expected {n}")


def gpt2_medium(torch, use_fp8=False):
    from paddle_tpu_torch import GPT, GPTConfig
    cfg = GPTConfig.gpt2_medium()
    if (cfg.num_layers, cfg.hidden_size, cfg.num_heads) != \
            (GPT_LAYERS, GPT_H * GPT_D, GPT_H):
        fail(f"GPTConfig.gpt2_medium() is not the shape this script "
             f"times its kernels at: {cfg}")
    cfg.use_fp8 = use_fp8
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GPT(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (GPT_B, GPT_S), device=DEVICE,
                        generator=gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"GPT-2 medium{' fp8' if use_fp8 else ''}: {n_params / 1e6:.1f}M "
          f"params bf16, built in {time.perf_counter() - t:.1f} s",
          flush=True)
    return model, ids


def train_phase(torch):
    gc.collect()
    torch.cuda.empty_cache()
    model, ids = gpt2_medium(torch)
    digest = init_digest(model, ids)
    gate = route_gate(torch, model, (ids, ids),
                      lambda m: [blk.attn.qkv_proj.weight for blk in m.h])
    rec, step, opt = timed_steps(torch, model, ids)
    rec.update(gate=gate, init_digest=digest)
    shown = {k: v for k, v in rec.items() if k != "gate"}
    print(f"train: {json.dumps(shown)}", flush=True)
    check_train("train", rec)
    rec["profile"] = profile_train(torch, step, opt, (ids,))
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def gpt_f32_phase(torch):
    """GPT at the port's default float32 (``GPT(cfg)`` without a dtype), GPT-2
    medium width cut to F32_GPT_LAYERS layers (a reduced depth: the path,
    not the model, is under test), batch 8 x 1024, AdamW 3e-4, clip 1.0,
    ``TrainStep``, 2 + F32_GPT_TIMED steps. Attention runs the float32
    route at head dim 64: forward and backward on the tensor cores as
    three bf16 pieces. Gates: finite, falling losses; per layer a step
    one forward, one dQ and one dK/dV and seven splits (q, k, v for the
    forward; q, k, v, dO for the backward), no other kernel of the port.
    Prints step ms."""
    from paddle_tpu_torch import GPT, GPTConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(GPTConfig.gpt2_medium(),
                              num_layers=F32_GPT_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GPT(cfg, device=DEVICE, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (GPT_B, GPT_S), device=DEVICE,
                        generator=gen)
    dtypes = {str(p.dtype) for p in model.parameters()}
    losses, secs, launches, step, opt = run_steps(
        torch, model, (ids,), lambda m, x: m.loss(x, x),
        timed=F32_GPT_TIMED)
    steps = WARMUP_STEPS + F32_GPT_TIMED
    rec = dict(config="gpt2_medium", layers=F32_GPT_LAYERS,
               param_dtypes=sorted(dtypes), batch=GPT_B, seq=GPT_S,
               steps=steps, losses=losses,
               step_ms=secs / F32_GPT_TIMED * 1e3,
               tokens_per_s=GPT_B * GPT_S * F32_GPT_TIMED / secs,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches)
    print(f"gpt_f32: {json.dumps(rec)}", flush=True)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    per = F32_GPT_LAYERS * steps
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd_f32=per, flash_bwd_dq_f32=per,
                flash_bwd_dkv_f32=per, split_bf16x3=7 * per)
    if dtypes != {"torch.float32"}:
        fail(f"gpt_f32: the model is not float32: {dtypes}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        fail(f"gpt_f32: the loss is not finite or did not fall: {losses}")
    bad = {n: (launches[n], c) for n, c in want.items() if launches[n] != c}
    if bad:
        fail(f"gpt_f32: launches (counted, expected) {bad}")
    return rec


# ---------------------------------------------------------------------------
# fp8 training phase: the reference's gpt_345m_fp8_train rung
# ---------------------------------------------------------------------------

def fp8_operands(torch, m, n, k, seed):
    """One linear's fp8 operands as amp.fp8 quantizes them: x [m, k] and
    W [n, k] (N(0, 0.02)) in e4m3, a gradient [m, n] in e5m2, the
    current-amax scales, and the bf16 tensors they came from."""
    from paddle_tpu_torch.amp import fp8
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE,
                           dtype=torch.bfloat16)

    x, w, g = randn(m, k), randn(n, k) * 0.02, randn(m, n)
    sx = fp8._amax(x) / fp8.E4M3_MAX
    sw = fp8._amax(w) / fp8.E4M3_MAX
    sg = fp8._grad_scale(g.float())
    q = dict(xq=fp8._quantize(x, sx, fp8.E4M3_MAX, torch.float8_e4m3fn),
             wq=fp8._quantize(w, sw, fp8.E4M3_MAX, torch.float8_e4m3fn),
             gq=fp8._quantize(g.float(), sg, fp8.E5M2_MAX,
                              torch.float8_e5m2))
    return q, (sx, sw, sg), (x, w, g)


def fp8_route_phase(torch, timer):
    """At each of GPT-2 medium's linear shapes (M 8192): the forward, dx
    and dW products through the card's route (``fp8_gemm``:
    torch._scaled_mm) against the plain version on the same fp8 operands
    (FP8_ROUTE_RTOL), timed beside the plain version, the bf16 product of
    the same shape (``F.linear`` / ``torch.matmul``) and the bound at the
    fp8 peak; then one FP8Linear forward + backward (quantize and amax
    included) against a bf16 Linear's."""
    from paddle_tpu_torch.amp import fp8
    from paddle_tpu_torch.nn import Linear
    F = torch.nn.functional
    m = GPT_B * GPT_S
    shapes = []
    for i, (lname, n, k) in enumerate(FP8_LINEARS):
        q, (sx, sw, sg), (x, w, g) = fp8_operands(torch, m, n, k, 4000 + i)
        xq, wq, gq = q["xq"], q["wq"], q["gq"]
        products = {
            # name: (fp8_gemm arguments, the bf16 product, (M, N, K))
            "fwd": ((xq, wq.t(), sx, sw), lambda: F.linear(x, w),
                    (m, n, k)),
            "dx": ((gq, fp8._transposed(wq).t(), sg, sw),
                   lambda: torch.matmul(g, w), (m, k, n)),
            "dw": ((fp8._transposed(gq), fp8._transposed(xq).t(), sg, sx),
                   lambda: torch.matmul(g.t(), x), (n, k, m)),
        }
        rec = dict(name=lname, M=m, N=n, K=k)
        for pname, (args, bf16_fn, (pm, pn, pk)) in products.items():
            out = fp8.fp8_gemm(*args)
            ref = fp8.fp8_gemm_plain(*args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max() / ref.abs().max())
            flops = 2.0 * pm * pn * pk
            t_ops = flops / FP8_FLOPS_PER_S * 1e3
            t_bytes = (pm * pk + pk * pn + 4 * pm * pn) / HBM_BYTES_PER_S \
                * 1e3
            rec[pname] = dict(
                rel_err=err, ms=timer(lambda: fp8.fp8_gemm(*args)),
                plain_ms=timer(lambda: fp8.fp8_gemm_plain(*args), iters=5),
                bf16_ms=timer(bf16_fn),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
            rec[pname]["tflops"] = flops / rec[pname]["ms"] / 1e9
            if not err <= FP8_ROUTE_RTOL:
                fail(f"fp8 route {lname} {pname}: card vs plain relative "
                     f"error {err:.3e} > {FP8_ROUTE_RTOL}")
        # the whole layer, forward + backward, quantize and amax included
        kw = dict(bias=True, device=DEVICE, dtype=torch.bfloat16,
                  requires_grad=True)
        layers = {"fp8": fp8.FP8Linear(k, n, **kw), "bf16": Linear(k, n,
                                                                  **kw)}
        xin = x.reshape(GPT_B, GPT_S, k).detach().requires_grad_()
        for key, layer in layers.items():
            def fwd_bwd(layer=layer):
                layer(xin).backward(g.reshape(GPT_B, GPT_S, n))
            rec[f"layer_{key}_ms"] = timer(fwd_bwd, iters=10)
        shapes.append(rec)
        del q, x, w, g, layers, xin
        print(f"fp8 route {lname} (M {m}, N {n}, K {k}): " + ", ".join(
            f"{p} {rec[p]['ms']:.4f} ms (bf16 {rec[p]['bf16_ms']:.4f}, "
            f"bound {rec[p]['bound_ms']:.4f}, err {rec[p]['rel_err']:.1e})"
            for p in products) + f"; layer fwd+bwd fp8 "
            f"{rec['layer_fp8_ms']:.4f} ms, bf16 {rec['layer_bf16_ms']:.4f}",
            flush=True)
    torch.cuda.empty_cache()
    return dict(shapes=shapes, tolerance=FP8_ROUTE_RTOL)


def fp8_train_phase(torch, bf16):
    """The reference's gpt_345m_fp8_train rung: GPT-2 medium with
    ``use_fp8=True`` from the bf16 phase's generator seed (the same
    weights and batch), the same optimizer and steps. Gates: the route
    gate per shape, finite and falling losses within FP8_LOSS_RTOL of the
    bf16 run's at every step, B1-B3 24 times a step and the fp8 route
    24 x 4 x 3 products a step."""
    from paddle_tpu_torch.amp.fp8 import FP8Linear
    gc.collect()
    torch.cuda.empty_cache()
    timer = Timer(torch)
    route = fp8_route_phase(torch, timer)
    del timer
    model, ids = gpt2_medium(torch, use_fp8=True)
    digest = init_digest(model, ids)
    if digest != bf16["init_digest"]:
        fail(f"fp8_train: the model or batch differs from the bf16 "
             f"phase's: {digest} vs {bf16['init_digest']}")
    n8 = sum(isinstance(mod, FP8Linear) for mod in model.modules())
    if n8 != 4 * GPT_LAYERS:
        fail(f"fp8_train: {n8} FP8Linear layers, expected {4 * GPT_LAYERS}")
    rec, step, opt = timed_steps(torch, model, ids)
    dev = [abs(a - b) / abs(b) for a, b in zip(rec["losses"],
                                                bf16["losses"])]
    rec.update(route=route, init_digest=digest,
               mfu_vs_bf16_peak=rec.pop("mfu"),
               mfu_vs_fp8_peak=rec["flops_per_token"] * rec["tokens_per_s"]
               / FP8_FLOPS_PER_S,
               loss_rel_dev_vs_bf16=dev, loss_rtol=FP8_LOSS_RTOL,
               step_ms_ratio_vs_bf16=rec["step_ms"] / bf16["step_ms"],
               tokens_per_s_ratio_vs_bf16=rec["tokens_per_s"]
               / bf16["tokens_per_s"])
    shown = {k: v for k, v in rec.items() if k != "route"}
    print(f"fp8_train: {json.dumps(shown)}", flush=True)
    check_train("fp8_train", rec, fp8_per_step=GPT_LAYERS * 4 * 3)
    if not max(dev) < FP8_LOSS_RTOL:
        fail(f"fp8_train: loss deviates from bf16's by {max(dev):.3f} "
             f"(limit {FP8_LOSS_RTOL}): {rec['losses']} vs "
             f"{bf16['losses']}")
    rec["profile"] = profile_train(torch, step, opt, (ids,), fp8=True)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# vit_train phase: the reference's vit_l_train rung
# ---------------------------------------------------------------------------

# cuDNN's convolution kernels (the patch embedding's forward and its two
# backward products) count as matmul work
_VIT_GROUPS = _TRAIN_GROUPS + tuple(
    (key, "matmul") for key in ("fprop", "dgrad", "wgrad", "conv2d",
                                "convolve", "cudnn"))


def vit_flops_per_image(cfg):
    """Forward flops of one image in its products: the patch convolution
    (a [patches, 3 p^2] x [3 p^2, d] product), per layer the q/k/v/out and
    the two MLP products over S tokens and the two attention products over
    S x S pairs, and the head on the class token. A training step makes
    three times as many."""
    d, p = cfg.hidden_size, cfg.patch_size
    n = (cfg.image_size // p) ** 2
    s, f = n + 1, int(d * cfg.mlp_ratio)
    layer = 2 * s * d * (4 * d + 2 * f) + 4 * s * s * d
    return 2 * n * 3 * p * p * d + cfg.num_layers * layer \
        + 2 * d * cfg.num_classes


def vit_l16(torch):
    """ViT-L/16 for 1000 classes in bf16 on the card from generator seed
    0, and one batch (images N(0, 1), labels uniform) from the same
    generator."""
    from paddle_tpu_torch.vision.models import vit_l_16
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = vit_l_16(num_classes=VIT_CLASSES, device=DEVICE,
                     dtype=torch.bfloat16, generator=gen)
    cfg = model.config
    shape = (cfg.num_layers, cfg.num_heads, cfg.hidden_size // cfg.num_heads,
             (cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.image_size)
    if shape != (VIT_LAYERS, VIT_H, VIT_D, VIT_S, VIT_IMAGE):
        fail(f"vit_l_16() is not the shape this script times its kernels "
             f"at: {cfg}")
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != VIT_PARAMS:
        fail(f"vit_l_16 has {n_params} parameters, expected {VIT_PARAMS}")
    x = torch.randn(VIT_B, 3, VIT_IMAGE, VIT_IMAGE, generator=gen,
                    device=DEVICE, dtype=torch.bfloat16)
    y = torch.randint(0, VIT_CLASSES, (VIT_B,), generator=gen, device=DEVICE)
    torch.cuda.synchronize()
    print(f"ViT-L/16: {n_params} params bf16, built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return model, x, y


def vit_train_phase(torch):
    """The reference's vit_l_train rung (``bench_vit_train(vit_l_16, 32,
    10)``): a route gate on the q_proj grads, then AdamW 3e-4 with clip
    1.0 through ``TrainStep``, 2 warm-up and 10 timed steps on one batch.
    Gates: finite and falling losses, B1-B3 24 times a step and nothing
    else of the port's kernels, no masked SDPA call. Then a profile of 2
    steps."""
    gc.collect()
    torch.cuda.empty_cache()
    model, x, y = vit_l16(torch)
    gate = route_gate(torch, model, (x, y),
                      lambda m: [blk.self_attention.q_proj.weight
                                 for blk in m.encoder],
                      label="q_proj", reference=True)
    losses, secs, launches, step, opt = run_steps(
        torch, model, (x, y), lambda m, a, b: m.loss(a, b))
    img_s = VIT_B * TIMED_STEPS / secs
    flops = 3 * vit_flops_per_image(model.config)
    rec = dict(config="vit_l_16", batch=VIT_B, image=VIT_IMAGE, seq=VIT_S,
               params=VIT_PARAMS, steps=WARMUP_STEPS + TIMED_STEPS,
               losses=losses, step_time_ms=secs / TIMED_STEPS * 1e3,
               images_per_s=img_s, flops_per_image=flops,
               mfu=flops * img_s / BF16_FLOPS_PER_S,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, gate=gate)
    shown = {k: v for k, v in rec.items() if k != "gate"}
    print(f"vit_train: {json.dumps(shown)}", flush=True)
    check_train("vit_train", rec, layers=VIT_LAYERS)
    prof = profile_train(torch, step, opt, (x, y), label="ViT-L/16",
                         kernel_groups=_VIT_GROUPS)
    groups = prof["by_group_ms_per_step"]
    attn = groups.get("attention forward (port)", 0.0) + \
        groups.get("attention backward (port)", 0.0)
    busy = prof["device_busy_ms_per_step"]
    prof.update(attention_ms_per_step=attn,
                attention_share_of_busy=attn / busy if busy else None,
                matmul_ms_per_step=groups.get("matmul", 0.0))
    rec["profile"] = prof
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# llama_train phase: Llama-3-8B width trained by TrainStep
# ---------------------------------------------------------------------------

def llama_train_model(torch):
    """Llama-3-8B's widths (vocab 128256, d 4096, MLP 14336, Hq 32, Hk 8,
    D 128, theta 5e5) at LT_LAYERS layers, bf16 and trainable, from
    generator seed 0, and one batch of LT_B x LT_S random ids from the
    same generator (examples/hybrid_llama.py:72-75 trains on random ids)."""
    from paddle_tpu_torch import Llama, LlamaConfig
    cfg = LlamaConfig.llama3_8b()
    cfg.num_layers = LT_LAYERS
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen,
                  requires_grad=True)
    ids = torch.randint(0, cfg.vocab_size, (LT_B, LT_S), device=DEVICE,
                        generator=gen)
    torch.cuda.synchronize()
    n = model.num_params()
    if n != LT_PARAMS or (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) \
            != (HQ, HK, D):
        fail(f"llama_train: {n} parameters (expected {LT_PARAMS}), {cfg}")
    print(f"Llama-3-8B x {LT_LAYERS} layers: {n} params bf16, built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return model, ids


class _PlainCalls:
    """Counts calls of the flash pair's plain versions while it is
    entered: the kernel route's main path must make none."""

    def __enter__(self):
        import paddle_tpu_torch.kernels.flash_attention as fa
        self.fa, self.calls = fa, 0
        self.orig = (fa.flash_attention_plain, fa.flash_attention_bwd_plain)

        def counted(f):
            def run(*a, **k):
                self.calls += 1
                return f(*a, **k)
            return run
        fa.flash_attention_plain, fa.flash_attention_bwd_plain = \
            (counted(f) for f in self.orig)
        return self

    def __exit__(self, *exc):
        self.fa.flash_attention_plain, self.fa.flash_attention_bwd_plain = \
            self.orig
        return False


def tensor_checker_check(torch, model, ids):
    """The tensor checker (``amp.debugging``) on one llama_train forward:
    armed, the hooked ops' outputs are checked and none flagged; one NaN
    weight raises ``FloatingPointError`` naming the op; the checked
    forward's time beside the unchecked one's."""
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.profiler import metrics

    def forward():
        with torch.no_grad():
            loss = model.loss(ids, ids)
        torch.cuda.synchronize()
        return loss

    forward()
    t = time.perf_counter()
    forward()
    plain_ms = (time.perf_counter() - t) * 1e3
    c_checked = metrics.counter("amp.check_naninf.checked")
    c_flagged = metrics.counter("amp.check_naninf.flagged")
    n0, f0 = c_checked.value, c_flagged.value
    debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
    try:
        t = time.perf_counter()
        forward()
        checked_ms = (time.perf_counter() - t) * 1e3
        checked, flagged = c_checked.value - n0, c_flagged.value - f0
        w = model.layers[0].self_attn.q_proj.weight
        keep = w[0, 0].item()
        with torch.no_grad():
            w[0, 0] = float("nan")
        try:
            forward()
        except FloatingPointError as e:
            raised = str(e)
        else:
            raised = None
        finally:
            with torch.no_grad():
                w[0, 0] = keep
    finally:
        debugging.disable_tensor_checker()
    rec = dict(checked=checked, flagged=flagged, raised=raised,
               unchecked_forward_ms=plain_ms, checked_forward_ms=checked_ms)
    print(f"tensor checker: {json.dumps(rec)}", flush=True)
    if checked <= 0 or flagged != 0:
        fail(f"tensor checker: {checked} checked, {flagged} flagged")
    if raised is None or "'linear'" not in raised:
        fail(f"tensor checker: a NaN q_proj weight raised {raised!r}")
    return rec


_FLASH_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel",
                  "flash_bwd_dkv_kernel")


def profiler_check(torch, step, ids):
    """``profiler.Profiler(scheduler=(1, 3))`` around LT_PROFILER_STEPS
    train steps with ``on_trace_ready=export_chrome_tracing``: the first
    window's exported device trace names B1, B2 and B3's kernels, its host
    trace the hooked ops."""
    import tempfile
    from paddle_tpu_torch import profiler
    with tempfile.TemporaryDirectory() as out:
        prof = profiler.Profiler(scheduler=(1, 3),
                                 on_trace_ready=profiler.
                                 export_chrome_tracing(out, "llama"))
        with prof:
            for _ in range(LT_PROFILER_STEPS):
                step(ids)
                prof.step()
        host = profiler.load_profiler_result(
            os.path.join(out, "llama_t0.json"))
        if host["device_trace"] is None:
            fail("profiler: the recording window exported no device trace")
        device = profiler.load_profiler_result(host["device_trace"])
        files = sorted(os.listdir(out))
    names = {e.get("name", "") for e in device.get("traceEvents", [])}
    found = {k: sum(k in n for n in names) > 0 for k in _FLASH_KERNELS}
    ops = sorted({e["name"] for e in host["traceEvents"]
                  if e.get("cat") == "Operator"})
    rec = dict(files=files, device_events=len(device.get("traceEvents",
                                                         [])),
               kernels_named=found, host_ops=ops)
    print(f"profiler: {json.dumps(rec)}", flush=True)
    if not all(found.values()):
        fail(f"profiler: the device trace lacks flash kernels: {found}")
    return rec


def fused_ce_time(torch, model, ids):
    """One fused LM-head cross entropy forward + backward at the step's
    shape ([LT_B x (LT_S - 1), 4096] against the [128256, 4096] head,
    float32 chunk products), CUDA events, median of 5."""
    from paddle_tpu_torch.nn import fused_linear_cross_entropy
    x = torch.randn(LT_B, LT_S - 1, model.config.hidden_size,
                    device=DEVICE, dtype=torch.bfloat16, requires_grad=True)
    w = model.lm_head.weight

    def run():
        loss = fused_linear_cross_entropy(x, w, ids[:, 1:],
                                          transpose_weight=True)
        torch.autograd.grad(loss, (x, w))
    return Timer(torch)(run, iters=5, warmup=1)


def llama_train_phase(torch):
    """Llama training at Llama-3-8B width (LT_LAYERS layers): a route gate
    (kernel vs plain vs a float32 copy, every layer's q_proj and k_proj
    grads), then ``TrainStep`` with ``lambda m, ids: m.loss(ids, ids)``
    under AdamW(1e-3) with clip 1.0 and fp32 masters, 2 + 10 steps on one
    batch. Gates: finite and falling losses; B1, B2 and B3 exactly
    LT_LAYERS times a step, nothing else of the port's kernels, and no
    call of the plain flash pair. Then the profile of 2 steps, the fused
    head's time, the tensor checker on one forward and the Profiler
    around 4 steps."""
    gc.collect()
    torch.cuda.empty_cache()
    model, ids = llama_train_model(torch)
    gate = route_gate(
        torch, model, (ids, ids),
        lambda m: [p for blk in m.layers for p in
                   (blk.self_attn.q_proj.weight, blk.self_attn.k_proj.weight)],
        label="qk_proj", reference=True)
    gc.collect()
    torch.cuda.empty_cache()
    with _PlainCalls() as plain:
        losses, secs, launches, step, opt = run_steps(
            torch, model, (ids,), lambda m, x: m.loss(x, x), lr=LT_LR)
    tok_s = LT_B * LT_S * TIMED_STEPS / secs
    flops_tok = model.flops_per_token(LT_S)
    # 6 N counts the untied embedding table as matmul work; it is a gather
    flops_gather = 0 if model.config.tie_word_embeddings else \
        6 * model.embed_tokens.weight.numel()
    rec = dict(config="llama3_8b", layers=LT_LAYERS, params=LT_PARAMS,
               batch=LT_B, seq=LT_S, steps=WARMUP_STEPS + TIMED_STEPS,
               losses=losses, step_ms=secs / TIMED_STEPS * 1e3,
               tokens_per_s=tok_s, flops_per_token=flops_tok,
               flops_per_step=flops_tok * LT_B * LT_S,
               mfu=flops_tok * tok_s / BF16_FLOPS_PER_S,
               mfu_without_embedding=(flops_tok - flops_gather) * tok_s
               / BF16_FLOPS_PER_S,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=launches, plain_flash_calls=plain.calls, gate=gate)
    shown = {k: v for k, v in rec.items() if k != "gate"}
    print(f"llama_train: {json.dumps(shown)}", flush=True)
    check_train("llama_train", rec, layers=LT_LAYERS)
    if plain.calls:
        fail(f"llama_train: the plain flash pair ran {plain.calls} times")
    prof = profile_train(torch, step, opt, (ids,), label="Llama-3-8B x4")
    groups = prof["by_group_ms_per_step"]
    prof["attention_ms_per_step"] = \
        groups.get("attention forward (port)", 0.0) + \
        groups.get("attention backward (port)", 0.0)
    rec["profile"] = prof
    rec["fused_ce_fwd_bwd_ms"] = fused_ce_time(torch, model, ids)
    rec["checker"] = tensor_checker_check(torch, model, ids)
    rec["profiler"] = profiler_check(torch, step, ids)
    print(f"llama_train (Llama-3-8B x {LT_LAYERS}, {LT_B} x {LT_S}): "
          f"{rec['step_ms']:.2f} ms a step, {tok_s:.0f} tokens/s, MFU "
          f"{rec['mfu']:.4f} ({rec['mfu_without_embedding']:.4f} without the "
          f"embedding gather), peak {rec['peak_mem_gib']:.2f} GiB; fused "
          f"head fwd+bwd {rec['fused_ce_fwd_bwd_ms']:.2f} ms, optimizer "
          f"{groups.get('optimizer (clip + AdamW + write-back)')} ms, "
          f"device busy {prof['device_busy_ms_per_step']:.2f} ms a step",
          flush=True)
    del step, opt, model
    gc.collect()
    torch.cuda.empty_cache()
    return rec

# ---------------------------------------------------------------------------
# llama_fp8 phase: Llama-3-8B with fp8 projections, served
# ---------------------------------------------------------------------------

def llama_fp8_phase(torch, prompts, new_tokens):
    """Llama-3-8B with ``use_fp8=True`` (seed 0: engine B's weights),
    its scales calibrated by one training-mode forward over the first
    prompt and frozen (eval), serving engine B's prompts with B's
    settings, after the same traffic with fp8 off (``fp8_autocast``: the
    bf16 twin whose teacher-forced deficits show the bf16 noise). Gates:
    run_engine's (the teacher-forced check against the dense forward,
    which uses the same frozen scales, at FP8_DEFICIT_TOL), no buffer
    moved while serving, no fp8 product with fp8 off, and B1 32 per
    prefill, B4 32 per decode step, 224 fp8 products per prefill and
    decode step (every projection; the LM head stays bf16)."""
    from paddle_tpu_torch import Llama, LlamaConfig
    from paddle_tpu_torch.amp.fp8 import FP8Linear, fp8_autocast
    gc.collect()
    torch.cuda.empty_cache()
    cfg = LlamaConfig.llama3_8b()
    cfg.use_fp8 = True
    t = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = Llama(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    n8 = sum(isinstance(mod, FP8Linear) for mod in model.modules())
    if n8 != 7 * LAYERS:
        fail(f"llama_fp8: {n8} FP8Linear layers, expected {7 * LAYERS}")
    model.train()
    with torch.no_grad():
        model(torch.as_tensor(prompts[0][None], device=DEVICE))
    model.eval()
    torch.cuda.synchronize()
    print(f"Llama-3-8B fp8: {n8} fp8 layers, built and calibrated in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    frozen = {n: b.clone() for n, b in model.named_buffers()}
    inst = Instrumented(torch, model)
    # the same model and traffic with every fp8 layer on F.linear: the
    # bf16 noise between the paged and the dense path, beside fp8's
    with fp8_autocast(enabled=False):
        off = run_engine(torch, inst, model, "B-fp8 (fp8 off)", prompts,
                         new_tokens, max_seq_len=240)
    r = run_engine(torch, inst, model, "B-fp8", prompts, new_tokens,
                   tf=dict(deficit_tol=FP8_DEFICIT_TOL),
                   max_seq_len=240)
    inst.restore()
    r["fp8_off"] = {k: off[k] for k in ("decode_tok_per_s", "ttft_median_s",
                                        "teacher_forced", "launches")}
    if off["launches"]["fp8_gemm"] != 0:
        fail("engine B-fp8 (fp8 off) launched fp8 products")
    moved = [n for n, b in model.named_buffers()
             if not torch.equal(b, frozen[n])]
    if moved:
        fail(f"engine B-fp8: eval-mode serving moved fp8 buffers {moved[:4]}")
    want = dict.fromkeys(r["launches"], 0)
    want.update(flash_fwd=r["prefills"] * LAYERS,
                paged_decode=r["decode_steps"] * LAYERS,
                fp8_gemm=(r["prefills"] + r["decode_steps"]) * 7 * LAYERS)
    for k, n in want.items():
        if r["launches"][k] != n:
            fail(f"engine B-fp8: {k} launched {r['launches'][k]} times, "
                 f"expected {n}")
    r["profile"] = profile_decode(torch, model, prompts, 8, label="B-fp8",
                                  max_seq_len=240)
    del inst, model
    gc.collect()
    torch.cuda.empty_cache()
    return r


# ---------------------------------------------------------------------------
# optimizers phase: every optimizer under a schedule, then O2 + GradScaler
# ---------------------------------------------------------------------------

def _schedule():
    from paddle_tpu_torch.optimizer import lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(3e-4, T_max=OPT_STEPS),
                           warmup_steps=2, start_lr=3e-5, end_lr=3e-4)


def _optimizers():
    """name -> (scheduler, parameters) -> optimizer, all 14."""
    from paddle_tpu_torch import optimizer as O
    no_decay = ("bias", "ln_", "wpe")
    return {
        "SGD": lambda s, ps: O.SGD(s, parameters=ps),
        "Momentum": lambda s, ps: O.Momentum(s, parameters=ps,
                                             use_nesterov=True),
        "Adagrad": lambda s, ps: O.Adagrad(s, parameters=ps),
        "Adadelta": lambda s, ps: O.Adadelta(s, parameters=ps),
        "RMSProp": lambda s, ps: O.RMSProp(s, parameters=ps, centered=True),
        "Rprop": lambda s, ps: O.Rprop(s, parameters=ps),
        "ASGD": lambda s, ps: O.ASGD(s, parameters=ps),
        "Adam": lambda s, ps: O.Adam(s, parameters=ps, amsgrad=True),
        "AdamW": lambda s, ps: O.AdamW(
            s, parameters=ps, apply_decay_param_fun=lambda n: not any(
                k in n for k in no_decay)),
        "Adamax": lambda s, ps: O.Adamax(s, parameters=ps),
        "NAdam": lambda s, ps: O.NAdam(s, parameters=ps),
        "RAdam": lambda s, ps: O.RAdam(s, parameters=ps),
        "Lamb": lambda s, ps: O.Lamb(s, parameters=ps),
        "LBFGS": lambda s, ps: O.LBFGS(s, max_iter=4, parameters=ps),
    }


def _rate_spy(opt, rates, lbfgs=False):
    """Records the rate each step hands its first parameter's update (for
    LBFGS: the rate its step reads)."""
    if lbfgs:
        get = opt.get_lr

        def read():
            rates.append(get())
            return rates[-1]
        opt.get_lr = read
        return
    apply = opt._apply_param
    first = opt._parameter_list[0]

    def spy(p32, g32, state, lr, group, t, param=None):
        if param is first:
            rates.append(lr)
        return apply(p32, g32, state, lr, group, t, param)
    opt._apply_param = spy


def optimizers_phase(torch):
    """GPT-2 medium width at OPT_LAYERS layers (reduced depth), bf16
    parameters, batch 8 x 1024: each of the 14 optimizers takes OPT_STEPS
    steps from the same weights under LinearWarmup(CosineAnnealingDecay)
    (LBFGS through a closure); then a float32 model under
    decorate(level="O2") + auto_cast() + GradScaler with AdamW, 4 steps,
    the third with an inf gradient. Gates: finite losses, each step's
    rate equal to the schedule's, the skipped step leaving the weights,
    the scaler's state as its rules give, B1-B3 4 per evaluation."""
    from paddle_tpu_torch import GPT, GPTConfig, amp
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.nn import LayerNorm
    gc.collect()
    torch.cuda.empty_cache()
    cfg = GPTConfig.gpt2_medium()
    cfg.num_layers = OPT_LAYERS
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GPT(cfg, device=DEVICE, dtype=torch.bfloat16, generator=gen)
    ids = torch.randint(0, cfg.vocab_size, (GPT_B, GPT_S), device=DEVICE,
                        generator=gen)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    expect = _schedule()
    expected = []
    for _ in range(OPT_STEPS):
        expected.append(expect.last_lr)
        expect.step()
    runs, evals = {}, 0
    zero_counts()
    for name, make in _optimizers().items():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        sched = _schedule()
        opt = make(sched, list(model.named_parameters()))
        rates, losses, secs = [], [], []
        _rate_spy(opt, rates, lbfgs=name == "LBFGS")

        def closure():
            loss = model.loss(ids, ids)
            loss.backward()
            return loss

        for _ in range(OPT_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if name == "LBFGS":
                loss = opt.step(closure)
            else:
                loss = closure()
                opt.step()
                opt.clear_grad()
                evals += 1
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
            losses.append(float(loss.detach()))
            sched.step()
        if name == "LBFGS":
            evals += opt._n_evals
            opt.clear_grad()
        runs[name] = dict(losses=losses, rates=rates,
                          step_ms=[x * 1e3 for x in secs])
        if not all(math.isfinite(x) for x in losses):
            fail(f"optimizers: {name}: a loss is not finite: {losses}")
        if rates != expected:
            fail(f"optimizers: {name}: rates {rates}, the schedule says "
                 f"{expected}")
        del opt
    launches, _ = read_counts()
    want = dict.fromkeys(launches, 0)
    want.update(flash_fwd=OPT_LAYERS * evals, flash_bwd_dq=OPT_LAYERS * evals,
                flash_bwd_dkv=OPT_LAYERS * evals)
    for k, n in want.items():
        if launches[k] != n:
            fail(f"optimizers: {k} launched {launches[k]} times, expected "
                 f"{n} ({evals} evaluations)")
    del model, init
    gc.collect()
    torch.cuda.empty_cache()

    # O2: a float32 model decorated to bf16 (LayerNorm kept float32)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    model = GPT(cfg, device=DEVICE, dtype=torch.float32, generator=gen)
    sched = _schedule()
    opt = O.AdamW(sched, parameters=model.parameters(),
                  multi_precision=False)
    model, opt = amp.decorate(model, opt, level="O2")
    for mod in model.modules():
        for p in mod.parameters(recurse=False):
            want_dt = torch.float32 if isinstance(mod, LayerNorm) \
                else torch.bfloat16
            if p.dtype != want_dt:
                fail(f"optimizers: decorate O2 left a {p.dtype} parameter "
                     f"in {type(mod).__name__}")
    scaler = amp.GradScaler(init_loss_scaling=2.0 ** 16,
                            incr_every_n_steps=2)
    rates, losses, scales, skipped_ok = [], [], [], None
    _rate_spy(opt, rates)
    o2_expected = []  # the schedule's rates at the steps that ran
    expect = _schedule()
    for i in range(4):
        with amp.auto_cast(level="O2"):
            loss = model.loss(ids, ids)
        scaler.scale(loss).backward()
        if i == 2:  # an overflow: the step is skipped, the scale halves
            w = model.h[0].mlp.fc_in.weight
            w.grad.view(-1)[0] = float("inf")
            before = w.detach().clone()
        else:
            o2_expected.append(expect.last_lr)
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        if i == 2:
            skipped_ok = bool(torch.equal(w.detach(), before))
        losses.append(float(loss.detach()))
        scales.append(scaler.state_dict()["scale"])
        sched.step()
        expect.step()
    state = scaler.state_dict()
    o2 = dict(losses=losses, scales=scales, state=state, rates=rates,
              skipped_step_left_weights=skipped_ok)
    runs["O2+GradScaler"] = o2
    print(f"optimizers ({OPT_LAYERS} layers at GPT-2 medium width, "
          f"{OPT_STEPS} steps each): {json.dumps(runs)}", flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"optimizers: O2: a loss is not finite: {losses}")
    if not skipped_ok:
        fail("optimizers: O2: the step with an inf gradient moved a weight")
    if rates != o2_expected:
        fail(f"optimizers: O2: rates {rates}, the schedule says "
             f"{o2_expected}")
    if scales != [2.0 ** 16, 2.0 ** 17, 2.0 ** 16, 2.0 ** 16] or \
            (state["good_steps"], state["bad_steps"]) != (1, 0):
        fail(f"optimizers: O2: scaler state {state}, scales {scales}; its "
             f"rules give 65536, 131072, 65536, 65536 and 1 good step")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=runs, launches=launches, evaluations=evals)


KERNELS = (
    ("flash_fwd", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("flash_bwd_dq", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("flash_bwd_dkv", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
    ("paged_decode", "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:133"),
    ("paged_decode_split",
     "paddle_tpu_torch/kernels/csrc/paged_decode_split.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:186"),
    ("paged_decode_q", "paddle_tpu_torch/kernels/csrc/paged_decode.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:156"),
    ("paged_decode_split_q",
     "paddle_tpu_torch/kernels/csrc/paged_decode_split.cu",
     "paddle_tpu/kernels/pallas/paged_attention.py:186"),
    ("quant_matmul", "paddle_tpu_torch/kernels/csrc/quant_matmul.cu",
     "paddle_tpu/kernels/pallas/quant_matmul.py:44"),
)


# the segment branch of B1-B3: (name, key of its time in the varlen
# records, source, the Pallas branch it replaces)
SEG_KERNELS = (
    ("B1-seg", "fwd", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:305"),
    ("B2-seg", "dq", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:382"),
    ("B3-seg", "dkv", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:435"),
)


def seg_records(varlen):
    """The ``kernels`` entries of B1-seg, B2-seg and B3-seg: times, bound,
    plain and library time at V1 (the main shape), every case beside."""
    records = []
    for name, key, source, replaces in SEG_KERNELS:
        errs = {"fwd": lambda r: r["max_abs_err"],
                "dq": lambda r: r["grad_errs"]["dq"]["abs"],
                "dkv": lambda r: max(r["grad_errs"]["dk"]["abs"],
                                     r["grad_errs"]["dv"]["abs"])}[key]
        plain = "plain_fwd" if key == "fwd" else "plain_bwd"
        lib = "library_fwd" if key == "fwd" else "library_bwd"
        cases = {c: dict(ms=r["times_ms"][key],
                         graph_ms=r["times_ms"][key + "_graph"],
                         plain_ms=r["times_ms"][plain],
                         bound_ms=r["bounds_ms"][key]["ms"],
                         bound_by=r["bounds_ms"][key]["by"],
                         library_ms=r["times_ms"][lib],
                         library=r["library"],
                         graph_share_of_bound=r["bounds_ms"][key]["ms"] /
                         r["times_ms"][key + "_graph"])
                 for c, r in varlen.items()}
        v1 = cases["V1"]
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(r["launches"][name] for r in varlen.values()),
            max_abs_err=max(errs(r) for r in varlen.values()),
            ms=v1["ms"], kernel_ms=v1["ms"], graph_ms=v1["graph_ms"],
            plain_ms=v1["plain_ms"], bound_ms=v1["bound_ms"],
            bound_by=v1["bound_by"], library_ms=v1["library_ms"],
            graph_share_of_bound=v1["graph_share_of_bound"], cases=cases))
    return records


# B1-B3 above head dim 256: (name, key of the kernel phases, source, the
# Pallas body it replaces, which pads D to a multiple of 128)
XL_KERNELS = (
    ("B1-xl", "flash_fwd", "paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:281"),
    ("B2-xl", "flash_bwd_dq", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:358"),
    ("B3-xl", "flash_bwd_dkv", "paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
     "paddle_tpu/kernels/pallas/flash_attention.py:408"),
)


def xl_records(phases, xl_path):
    """The ``kernels`` entries of B1-B3 above head dim 256: launches from
    the D 288 path run (``xl_path_phase``), times, bound, plain and SDPA's
    time (null where SDPA refuses the shape) at the first case above 256
    in ``WIDE_CASES`` (S 2048, D 384, causal), every case beside."""
    records = []
    for name, key, source, replaces in XL_KERNELS:
        cases = [{k: r[k] for k in (
            "case", "B", "S", "Hq", "Hk", "D", "padded_to", "causal",
            "max_abs_err", "ms", "graph_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "graph_share_of_bound") if k in r}
                 for r in phases[key] if r.get("padded_to", 0) > 256]
        main_rec = cases[0]
        records.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=xl_path["launches"][name],
            max_abs_err=max(r["max_abs_err"] for r in cases),
            ms=main_rec["ms"], kernel_ms=main_rec["ms"],
            graph_ms=main_rec["graph_ms"], plain_ms=main_rec["plain_ms"],
            bound_ms=main_rec["bound_ms"], bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"],
            graph_share_of_bound=main_rec["graph_share_of_bound"],
            cases=cases, path=xl_path))
    return records


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false", code=2)
    sys.path.insert(0, ROOT)
    try:
        from paddle_tpu_torch.kernels import _build
    except ImportError as e:
        fail(f"paddle_tpu_torch is not beside chip_smoke.py: {e}", code=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t
    print(f"built {len(_build.SOURCES)} kernels in {build_s:.1f} s",
          flush=True)
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log").read_text()
        for line in log.splitlines():
            if "registers" in line or "spill" in line.lower():
                print(f"  ptxas {name}: {line.strip()}")

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(torch, *args)
        print(f"phase {phase.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
        return out

    phases = timed(kernel_phases)
    xl_path = timed(xl_path_phase)
    faults = timed(faults_phase)
    gpt32 = timed(gpt_f32_phase)
    varlen = timed(varlen_phase)
    served, b_traffic = timed(slice_phase)
    llama8 = timed(llama_fp8_phase, *b_traffic)
    trained = timed(train_phase)
    fp8_trained = timed(fp8_train_phase, trained)
    vit = timed(vit_train_phase)
    llama_train = timed(llama_train_phase)
    optimizers = timed(optimizers_phase)
    print(f"fp8 vs bf16 training step (GPT-2 medium, 8 x 1024, same call): "
          f"{fp8_trained['step_ms']:.2f} vs {trained['step_ms']:.2f} ms, "
          f"{fp8_trained['tokens_per_s']:.0f} vs "
          f"{trained['tokens_per_s']:.0f} tokens/s, peak "
          f"{fp8_trained['peak_mem_gib']:.2f} vs "
          f"{trained['peak_mem_gib']:.2f} GiB", flush=True)
    print(f"ViT-L/16 training ({VIT_B} x {VIT_IMAGE}^2): "
          f"{vit['step_time_ms']:.2f} ms a step, "
          f"{vit['images_per_s']:.1f} images/s, MFU {vit['mfu']:.3f}, peak "
          f"{vit['peak_mem_gib']:.2f} GiB", flush=True)

    records = []
    for name, source, replaces in KERNELS:
        # the first record of each kernel is at its main path's shape
        main_rec = phases[name][0]
        launches = sum(served[e]["launches"][name]
                       for e in ("A", "B", "A8", "B8", "S", "S8")) \
            + sum(served[e]["launches"][name] + served[e]["plain"][
                "launches"][name] for e in ("S-spec", "S8-spec", "R-spec",
                                            "R8-spec")) \
            + trained["launches"][name] + fp8_trained["launches"][name] \
            + vit["launches"][name] + llama8["launches"][name] \
            + optimizers["launches"][name] \
            + llama_train["launches"][name] \
            + served["generate"]["engine"]["launches"][name] \
            + served["telemetry"]["launches"][name]
        paths = {}
        if name == "quant_matmul":  # decode (above) and prefill
            pre = next(r for r in phases[name] if r["M"] > 8)
            paths["prefill"] = dict(
                {k: pre[k] for k in ("M", "N", "K", "ms", "graph_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "library_graph_ms")},
                per_prefill=phases["quant_matmul_prefill"])
            paths["decode_step"] = phases["quant_matmul_decode_step"]
            paths["decode_layer"] = phases["quant_matmul_decode_layer"]
            paths["verify"] = phases["quant_matmul_verify"]
        vit_case = next((r for r in phases[name] if r.get("case") == "vit"),
                        None)
        if vit_case is not None:  # B1-B3 at ViT-L/16's shape
            paths["vit"] = {k: vit_case[k] for k in (
                "B", "S", "Hq", "Hk", "D", "causal", "max_abs_err", "ms",
                "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in vit_case}
            paths["vit"]["launches"] = vit["launches"][name]
        lt_case = next((r for r in phases[name]
                        if r.get("case") == "llama_train"), None)
        if lt_case is not None:  # B1-B3 at the llama_train shape
            paths["llama_train"] = {k: lt_case[k] for k in (
                "B", "S", "Hq", "Hk", "D", "causal", "max_abs_err", "ms",
                "graph_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in lt_case}
            paths["llama_train"]["launches"] = \
                llama_train["launches"][name]
        wide = [r for r in phases[name]
                if str(r.get("case", "")).startswith("d") and
                r["padded_to"] <= 256]
        if wide:  # B1-B3 above head dim 128, up to 256
            paths["d256"] = [{k: r[k] for k in (
                "case", "B", "S", "Hq", "Hk", "D", "padded_to", "causal",
                "max_abs_err", "ms", "graph_ms", "host_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_graph_ms")
                if k in r} for r in wide]
        # device-only times (CUDA-graph replays) where the phase took them,
        # and B7's second library yardstick
        graphs = {k: main_rec[k] for k in (
            "graph_ms", "library_graph_ms", "graph_share_of_bound",
            "host_ms", "int8pack_ms", "int8pack_graph_ms", "int8pack_cuda")
            if k in main_rec}
        records.append(dict(**paths, **graphs,
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches,
            max_abs_err=max(r["max_abs_err"] for r in phases[name]),
            ms=main_rec["ms"], kernel_ms=main_rec["ms"],
            plain_ms=main_rec["plain_ms"], bound_ms=main_rec["bound_ms"],
            bound_by=main_rec["bound_by"],
            library_ms=main_rec["library_ms"]))
    records += seg_records(varlen)
    records += xl_records(phases, xl_path)
    records += simt_records(faults, gpt32)
    print("record " + json.dumps({
        "card": card, "torch": torch.__version__, "build_s": build_s,
        "phases": phases, "xl_path": xl_path, "faults": faults,
        "gpt_f32": gpt32, "varlen": varlen,
        "served": served,
        "llama_fp8": llama8, "trained": trained, "fp8_trained": fp8_trained,
        "vit_trained": vit, "llama_trained": llama_train,
        "optimizers": optimizers}), flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
