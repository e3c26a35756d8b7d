#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``deepspeed_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device: the card's name and power limit, TF32 switched off;
  2. build: every kernel under ``deepspeed_tpu_torch/ops/csrc`` compiled by
     nvcc for sm_90a (one process per source, all started together), with
     ptxas's register, shared-memory and spill lines; for each kernel of
     the two attention libraries with wgmma kernels (ring_flash,
     flash_attention) its registers, spills, shared memory a block and
     HGMMA (wgmma) instructions from ``cuobjdump --dump-sass`` (the wgmma
     forward K13 and K3 and the wgmma K14/K15 must be there at D 64 and
     128, issue HGMMA and spill nothing); the same for K1, K2 and K6 (K1's
     split route spills nothing at D 64, 80, 96, 128, 256 and its wgmma
     route, mode PAGED, issues HGMMA and spills nothing at D 64, 128, 256,
     each with its shared memory a block; K6's wgmma route issues HGMMA and
     spills nothing at each bit width, K2 spills nothing at any head dim);
  3. kernel_check: K1 twice on each case against its plain PyTorch version
     on the card (atol = rtol = 2e-2, relative Frobenius <= 1e-2, pad rows
     0, finite, the two runs bit-identical, the route named), at the main
     path's shapes (llama3-8b: H=32, KVH=8, D=128, bs=128, bf16), the mixed
     128-wide serving step, window / ALiBi / softcap cases, every compiled
     instantiation (D=64/80/96/256, pages of 16/32 slots, MHA, MQA,
     falcon-7b's 71 query heads on one kv head), a decode the plan splits
     at bs 16, NaN parked in stale slots, trash block 0 and pad chunk
     rows, and the speculative widths (the draft's C = 2 re-feed, the
     verify's C = 3 and 5) at llama3-8b's and the 1B draft's (D 64)
     attention with NaN in every slot at or beyond each row's first chunk
     position, and one tp = 4 rank of llama2-70b (H 16, KVH 2, D 128:
     ``tp4_decode``, ``tp4_prefill``), each also replayed from a CUDA graph
     bit-identical;
  4. kernel_time: K1 on the decode, prefill and mixed steps, at the
     speculative widths (re-feed C 2, verify C 3 and 5) and at the tp = 4
     rank's decode and prefill steps by CUDA events
     and by CUDA-graph replay (a replayed call must give the eager call's
     bits), its plain version and one PyTorch library call (pages gather +
     scaled_dot_product_attention), beside the card's bound for the same
     work; k1_crossover: both routes forced as the chunk width grows;
  5. main_path: ``InferenceEngineV2.serve()`` on llama3-8b at full width
     and depth with random weights: 8 greedy requests over 3 frame
     boundaries, eagerly (a runner built with ``cuda_graphs=False``), then
     twice from CUDA graphs (the engine's default on the card: one captured
     step a shape key, replayed once a step; the first run captures), then
     from the graphs under torch.profiler; every request must complete
     with the same tokens in the same retirement order in each run, K1's
     launches (the wrapper's plus what the replays launched) must equal
     layers x steps, and so must the K1 kernels the trace shows on the
     card; captures, capture seconds and peak memory beside the eager
     run's; the KV pool must drain. A sampled serve() follows: its steps
     are never captured (they run eagerly by rule: any live temperature
     > 0). (After phase 7,
     phi2_path: ``serve()`` on phi-2 at full width and depth from graphs,
     head dim 80 on K1's split route, 4 greedy requests, K1 launches =
     layers x steps, the pool drained);
  6. reference_check: the paged forward (128-token chunks through the
     kernel, replayed from the ``run`` graphs) against a dense causal
     forward written out in this script, on a 300-token prompt:
     last-position logits within 5% of their range;
  7. step_profile (before the traced serve() run): one decode and one
     prefill step at the main path's shapes, eager and replayed from a
     CUDA graph: host wall time per step and the host's time to issue one
     (taken before any trace of the process), device time by kernel class
     (torch.profiler), the device's idle share, and layers K1 kernels a
     step on the card; v2_api_path: ``generate()``, ``generate_compiled()``
     (the main path's 8 prompts, 32 greedy new tokens) and a put / step /
     query / flush drive of two prompts across a chunk boundary, eagerly
     and from graphs, the same tokens both ways; generate_compiled()
     token-identical to serve() of the same program (8 slots, one arrival,
     12-step frames); the pool drained; tokens/s, first-token latency,
     captures and peak memory.
The serving engine is then freed, and the quantized and speculative
serving slice runs (before phi2_path):
  quant_check: ``quantize_kv_lanes`` / ``dequantize_kv_lanes`` and the
     weight quantizer's leaves on the card byte-identical to the CPU's
     (random, all-zero and NaN/inf-lane rows; layer 0's wq and the stacked
     wk of llama3-8b), and the page movers' round trip on an int8 pool;
  quant_serve_path: llama3-8b at full width and depth with int8 KV pages,
     int8 weights, and both, each serving the main path's 8 requests
     eagerly, from graphs and traced: the same tokens both ways, budgets
     met, the pool drained, K1 launches layers x steps on the float-KV
     engine and 0 on the int8-KV ones (JAX's gather route), last-position
     logits within 5 % of the range of the dense forward over the same
     weights (and of the bf16 one for bf16 weights), int8 weights within 5 %
     of bf16 at 2 layers (JAX's contract); param and block bytes, peak
     memory, tokens/s, TTFT, a decode step by kernel class;
  spec_path: the same requests with gamma 2 against a self-draft and a
     draft at Llama-3.2-1B's widths (random, seed 1), eagerly, from graphs
     and traced: the same tokens both ways, budgets met, both pools
     drained, accepted <= drafted = gamma x verify row-steps, K1 launches
     = target layers x (wide + verify steps) + draft layers x (wide +
     gamma x verify steps) by wrapper count and trace; then
     ``generate_compiled(speculate=True)`` eagerly and from graphs (the
     same tokens) and a sampled serve (eager by rule); acceptance, tokens
     per target forward, tokens/s and the verify step beside the plain
     graph serve().
The KV hierarchy and the scheduler follow, each on its own llama3-8b
engine (the main path's serving config, full width and depth, graphs):
  hier_path: ``prefix_cache=True``; 8 greedy requests sharing a
     1536-token prefix (12 pages) with 64-200 tokens of their own, one at
     boundary 0 and seven once its prefill committed; served to capture,
     cold (cache detached), with the cache (the seven map the 12 published
     pages and prefill from token 1536) and with it traced: budgets met,
     K1 launches = layers x steps by wrapper and trace, refcounts 0 and the
     pool drained after ``clear()``, and a never-served follower's
     last-position logits through the paged forward resuming at the mapped
     watermark within 5 % of the dense forward's range; TTFT p50 / p90 of
     the seven, tokens/s, prefill steps, hit tokens and pages;
  sched_path: ``kv_swap_dir`` (a temporary directory) and
     ``serve(scheduler=RequestScheduler())``; 16 batch requests (512-token
     prompts, budget 128) fill the table, then 4 interactive ones
     (``slo_ms``) preempt a row each: swap-in with every victim's pages
     compared byte for byte before eviction and after restore,
     re-prefill (``kv_swap_preempt=False``), swap-in timed; budgets met,
     the tier empty and the pool drained, K1 launches = layers x steps;
     preemptions, interactive and batch TTFT, pages and GB/s out and in
     through the port's aio engine, overlapped and blocking commits.
  fault_path: serving resilience on the main path's 8 requests (a
     llama3-8b engine and a ``nonfinite_policy="repair"`` engine over its
     weights, graphs): a warm fault-free run (``base``, and the watchdog at
     3x its longest replayed frame); two injected dispatch failures and a
     slow frame (tokens bit-identical to ``base``, 2 retries, 1 slow
     frame, no capture); a poisoned row, a deadline and a
     ``cancel_request`` (each retired with its kind, never yielded, the
     poisoned partial a prefix of ``base``); a crash past the retries and
     ``serve(resume_from=last_crash_snapshot)`` on the same engine (prefixes
     of ``base``, every row completed, recoveries counted, a resumed row's
     logits within 5 % of the dense range); a repair blip (completed) and
     a persistent fault (escalated). K1 launches = layers x steps and the
     pool drained in every run.
The training slice follows:
  8. train_kernel_check: flash attention forward, dq and dk/dv (K3, K4, K5)
     against their plain versions at gpt2-xl and llama3-8b shapes and on
     every mask (window, ALiBi, segments, non-causal, an S that is no tile
     multiple, D = 256), the forward run twice and bit-identical, each case
     naming the variant each kernel ran; the fused Adam step (K10) at
     gpt2-xl's largest leaf;
  9. train_kernel_time: each kernel, its plain version and one PyTorch
     library call by CUDA events, beside the card's bound;
 10. train_path: ``deepspeed_tpu_torch.initialize()`` on gpt2-xl at full
     width and depth (bf16, AdamW, WarmupLR, clipping, ZeRO-1, 16 x 1024
     tokens a step in micro-batches of 8), 2 warm-up and 6 timed
     ``train_batch`` steps and one through ``forward``/``backward``/``step``:
     finite falling loss, launches = layers x micro-steps for K3/K4/K5 and
     leaves x steps for K10;
 11. train_reference_check: one micro-batch through the flash kernels and
     through the reference attention: loss, gradient norm, leaf cosines;
 12. train_step_profile: device time of a train step by kernel class and
     the device's idle share.
The training engine is then freed, and the v1 inference and weight-only
quantization slice runs:
 13. v1_kernel_check / v1_kernel_time: fused decode attention (K2) against
     its plain version at llama3-8b decode shapes (cache_len 8192, 8065,
     4097, 1 and 0 in one batch; the main path's B = 4 full caches; head
     dims 64/192/256 and 1 to 16 query heads per kv head), each case run
     twice and bit-identical, timed beside its bound and SDPA (the main and
     mixed cases and B = 1 and 16 on full caches, by back-to-back events
     and by CUDA-graph replay); v1_crossover: K2 against the masked einsum
     at S_max 2048, 4096 and 8192;
 14. quant_kernel_check / quant_kernel_time: the int8 and int4 group
     quantizers (K7, K8) on llama3-8b's stacked wi_gate leaf, q and scales
     byte-identical to their plain versions;
 15. woq_kernel_time: the weight-only-quantized matmul (K6) at bits 8, 4, 6
     on the seven projection shapes at M = 4 and 2048 (relative Frobenius
     error <= 1e-2, each case twice and bit-identical, the route named),
     beside its bound and torch.matmul on the dequantized weight;
     woq_kernel_check: ragged M (1, 3, 17, 300) at N = 4096 and 1000 on
     every route; woq_crossover: the streaming and wgmma routes forced at
     M = 4 to 16 on the gate projection;
 16. v1_main_path: ``init_inference(llama3-8b).generate()`` at full width
     and depth, 4 prompts of 8064 tokens, 128 greedy new tokens over an
     8192-slot cache, the decode step replayed from a CUDA graph, then on
     an engine built with ``cuda_graphs=False``: the same tokens, 127 decode
     steps and K2 launches = layers x 127 in both (run + replayed); TTFT,
     decode tokens/s, captures, peak memory;
 17. v1_reference_check: the prefill's last logits against
     ``engine.forward`` (flash) and one decode step through K2 against the
     masked einsum, within 5 % of the logit range; v1_step_profile: the
     decode step eager and replayed (layers K2 kernels a step on the card);
 18. quant_path: ``quantize_model_params`` at bits 8 and 4 over llama3-8b
     (one K7/K8 launch per quantized leaf, every leaf within half a step),
     ``dequantize_model_params``, and ``QuantizedLinear`` at bits 8/4/6 on
     one layer's projections and SwiGLU MLP (K6).
The v1 engine is then freed, and the public-ops slice runs:
 19. ops_kernel_check: block-sparse attention (K11) against its plain
     version on the Fixed, BSLongformer and BigBird layouts at block 16,
     bidirectional at the main path's shape and causal, with GQA at
     D = 128 and a layout with empty rows (output 0 there); Evoformer
     attention (K12) with no bias, the mask bias, and both, at D = 64, 128,
     256 (a fully -1e9 MSA row included), at the main path's shape and at
     S = 512 with bf16 biases; the fp8 quantizer (K9) in e4m3 and e5m2,
     rounding to nearest and stochastic, from f32, bf16 and f16 (ties and a
     zero group included), codes and scales byte-identical to the plain
     version, which draws the same Philox bits, and stochastic codes also
     to the float law: at group 256, at group 100 on an x one element off
     16-byte alignment (route "runs"), at groups 8 to 2048; and on
     llama3-8b's stacked wi_gate leaf, every layer when rounding to
     nearest, the first and last when stochastic;
 20. ops_kernel_time: each kernel at the main path's shapes by CUDA events,
     beside its plain version, one library call (SDPA with the token mask
     for K11, SDPA with the summed biases for K12, none for K9) and the
     card's bound (K9's: bytes, f32 operations, or the Philox multiplies at
     the integer-multiply rate, the term that bounds named);
 21. ops_path: the public entry points with every count set to 0 before and
     read after. ``SparseSelfAttention`` at bert-large's attention width
     (16 heads of 64), bf16, B = 4, S = 4096, on the three layouts: forward
     through K11 and one dense-recompute backward each, the output against
     the dense masked form; ``DS4Sci_EvoformerAttention`` at AlphaFold 2's
     MSA row attention (1, 128, 256, 8, 32) with both biases (D = 32 is not
     eligible: no K12 launch) and at (1, 512, 256, 4, 64) (K12 forward,
     chunked backward), each against the chunked route, gradients finite;
     ``quantize_fp8`` on the wi_gate leaf in the four modes, dequantized
     within half an fp8 step (nearest) or one step (stochastic). Launches
     must equal the calls that reach each kernel.
The public ops are then freed, and the ring (sequence-parallel) slice runs:
 22. ring_kernel_check: one ring step of K13 (forward, into the carry), K14
     (dq) and K15 (dk/dv, the GQA group summed in the kernel) against their
     plain versions at the shard shapes of qwen2-7b over 4 shards (S = 8192
     a shard, H = 28, KVH = 4, D = 128, bf16) on the diagonal step (empty
     carry), a step below it and one above it (carry and accumulators back
     bit for bit), then window, ALiBi, segments and all three, GQA groups
     1, 4 and 7, D = 64 and 256, a shard of 1000 (masked tail tiles), and
     shards that are views of a (2, 4 S, H, D) sequence (strided batch);
     every case runs twice and must give every buffer bit for bit (the
     carry m, l, acc of K13 among them), and names the variant each kernel
     ran (K13: wgmma at every D; K14/K15: wgmma at D 64 and 128, wmma at
     256);
 23. ring_kernel_time: each kernel per step kind by CUDA events, beside its
     plain version, its bound and SDPA (forward beside K13, its autograd
     backward beside K14 + K15, with the kernels SDPA ran named);
 24. ring_train_path: ``initialize()`` on qwen2-7b at full width, 4 of 28
     layers, one 32768-token sequence a step over ``mesh {"seq": 4}`` with
     ``attn_impl="ring"``, bf16, AdamW, ZeRO-1, full recompute; every count
     set to 0 before and read after 1 warm-up and 3 timed ``train_batch``
     steps: finite falling loss, launches = 128 / 64 / 64 a step for
     K13 / K14 / K15 and one K10 a leaf; then ring_step_profile, the device
     time of one step by kernel class and the idle share;
 25. ring_reference_check: the sequence through the ring and through
     ``attn_impl="flash"`` on one shard (K3-K5): loss, gradient norm and
     per-leaf cosines.
Then the kernel summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero before
the last line. Without CUDA, or without the package beside it, it exits 1.

``python3 chip_smoke.py ring-nccl`` on a machine with four cards runs the
ring across them instead: one process per card over NCCL, each holding one
8192-token shard, against the one-process ring of the four shards on its
card; it needs four cards and is not part of the one-card run.

``python3 chip_smoke.py tp-nccl`` on four cards serves tensor-parallel
instead (one process per card, NCCL, every rank stopped when one fails):
  tp_serve_path: llama2-70b at full width and depth, tp = 4, bf16, each
     rank drawing only its shard, the main path's 8 greedy requests from
     CUDA graphs (NCCL captured in them), a capturing run and a timed one:
     the same tokens on every rank and in both runs, budgets met, the pool
     drained, K1 = 80 x steps on every rank; a decode step's wall and
     device ms by class (GEMMs, NCCL, K1, other), peak GB a card;
  tp_reference_check: 8 of the 80 layers against an f32 dense forward of the
     same bf16 weights on card 0 (no engine, no process group):
     teacher-forced logits over the prefill and 16 decode steps, tp = 4
     within 1.5 x tp = 1's own bf16 distance (relative Frobenius), and a
     control with wk / wv cut at the wrong rank offset outside it; tp 4
     vs tp 1 and greedy agreement printed;
  tp_collectives_check: the overlap ring within the same bound; int8 and
     fp8 collectives on JAX's probe and on the prefill's first chunk
     within 1.5 x (the quantized scheme's own distance, computed in f32
     on one card, + the exact tp = 4's), budgets met, JAX's contract
     (max |q - exact| <= 0.05 max |exact|) printed for the port and the
     scheme; every lowering on the wire against its arithmetic on one
     card; each variant's decode step beside exact's.
Its last line is the same ``ok`` line with ``count`` 4.

``python3 chip_smoke.py zero-nccl`` on four cards trains data-parallel
instead (one process per card, NCCL, every rank stopped when one fails);
rank 0 first runs the reference check's one-card run alone, before it
joins the group:
  zero_train_path: llama2-7b at full width and depth, ZeRO stage 3 over
     the four ranks (each drawing the seeded init whole and keeping its
     shard), bf16 activations over f32 parameters and Adam state, full
     recompute, S 4096, micro-batch 1 a rank, gas 2; 1 warm-up and 4 timed
     ``train_batch`` steps, counts set to 0 just before and read just
     after: the loss finite, falling and the same on every rank, K3 / K4
     / K5 = 128 / 64 / 64 and K10 one a leaf a step on every rank, the
     bytes the engine's tensors hold within its shards plus whole leaves;
     tokens/s, ms a step, MFU, peak GB a card, one step's device ms by
     class (GEMMs, NCCL all-gather, NCCL reduce-scatter, K3, K4 + K5, K10,
     other) and the idle share;
  zero_reference_check: 4 of its 32 layers, stages 0-3 over the four
     ranks, three steps each on 8 x 4096 tokens, against the one-card run
     (gas 8, the same batch and seed): step 1's reduced gradient within
     1e-5 (relative Frobenius, gathered) and each loss within 2e-4; a
     control that shifts every rank to the next rank's rows (the last
     keeps its own) must miss the gradient gate; the parameters' distance
     after three steps printed;
then on rank 0 K3-K5 at llama2-7b's attention and K10 at the largest
shard, each held against its plain version and timed beside it, and the
kernel line with the zero path's launches. The last line is the ``ok``
line with ``count`` 4.
"""

import gc
import json
import math
import statistics
import subprocess
import sys
import time

ATOL = RTOL = 2e-2        # bf16 kernel vs the plain version in f32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
REPLACES = "deepspeed_tpu/ops/pallas/paged_attention.py:35"
SOURCE = "deepspeed_tpu_torch/ops/csrc/paged_attention.cu"
H, KVH, D, BS = 32, 8, 128, 128          # llama3-8b attention shapes


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exit {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernel cases

def make_case(torch, name, *, ctx, c, valid=None, window=0, alibi=False,
              softcap=0.0, layers=1, seed=0, h=H, kvh=KVH, d=D, bs=BS):
    """One paged-attention input set on the card in bf16 (llama3-8b
    shapes unless given). ``ctx[i]``: tokens of sequence i already in the pool;
    the chunk holds the next ``valid[i]`` (default c) tokens, pad rows at
    -1. Pool pages are distinct per sequence and shuffled."""
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(ctx)
    valid = [c] * b if valid is None else valid
    mb = max(-(-(n + c) // bs) for n in ctx)
    nb = b * mb + 1
    perm = torch.randperm(nb - 1, generator=g)[:b * mb] + 1
    tables = perm.reshape(b, mb).to(torch.int32)
    pos = torch.full((b, c), -1, dtype=torch.int32)
    for i, (n, v) in enumerate(zip(ctx, valid)):
        pos[i, :v] = torch.arange(n, n + v, dtype=torch.int32)

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(torch.bfloat16)

    case = dict(
        name=name, ctx=list(ctx), valid=list(valid),
        q=rnd(b, c, h, d), kpool=rnd(layers, kvh, nb, bs, d),
        vpool=rnd(layers, kvh, nb, bs, d), block_tables=tables,
        positions=pos, chunk_k=rnd(b, c, kvh, d), chunk_v=rnd(b, c, kvh, d),
        window=window, softcap=softcap,
        alibi_slopes=(torch.linspace(0.5, 0.004, h) if alibi else None))
    return {k: (v.to(dev) if torch.is_tensor(v) else v) for k, v in case.items()}


def call(fn, case, layer=0, cast=None):
    cv = (lambda t: t) if cast is None else cast   # noqa: E731
    return fn(cv(case["q"]), cv(case["kpool"]), cv(case["vpool"]),
              case["block_tables"], case["positions"], cv(case["chunk_k"]),
              cv(case["chunk_v"]), layer=layer, window=case["window"],
              alibi_slopes=case["alibi_slopes"], softcap=case["softcap"])


def library_call(torch, case, layer=0):
    """The same function as one PyTorch library call: gather the table's
    pages, then scaled_dot_product_attention with a boolean mask. A
    yardstick only; the port never calls it."""
    import torch.nn.functional as F
    q, bt, pos = case["q"], case["block_tables"].long(), case["positions"].long()
    b, c, h, d = q.shape
    kvh, mb = case["kpool"].shape[1], bt.shape[1]
    keys = case["kpool"][layer][:, bt].reshape(kvh, b, mb * BS, d).transpose(0, 1)
    vals = case["vpool"][layer][:, bt].reshape(kvh, b, mb * BS, d).transpose(0, 1)
    keys = torch.cat([keys, case["chunk_k"].transpose(1, 2)], dim=2)
    vals = torch.cat([vals, case["chunk_v"].transpose(1, 2)], dim=2)
    cs = torch.where(pos >= 0, pos, 1 << 30).amin(dim=1)
    slot = torch.arange(mb * BS, device=q.device)
    kpos = torch.cat([torch.where(slot[None] < cs[:, None], slot[None], -1),
                      pos], dim=1)
    mask = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= pos[:, :, None])
    rep = h // kvh
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), keys.repeat_interleave(rep, dim=1),
        vals.repeat_interleave(rep, dim=1), attn_mask=mask[:, None])


def case_work(case):
    """(bytes, flops) the function needs on this case's data: each live key
    and value row (pool and chunk) read once, the q rows of live positions
    read once (a pad row's output is 0 whatever its q), out written once;
    4*D flops per (query row, visible key). Head counts and D are the
    case's own."""
    b, c, h, d = case["q"].shape
    kvh = case["kpool"].shape[1]
    live_q = int((case["positions"] >= 0).sum()) * h
    keys = sum(n + v for n, v in zip(case["ctx"], case["valid"]))
    elt = 2
    nbytes = (keys * kvh * d * 2 * elt           # K and V rows
              + live_q * d * elt                 # q in, live rows
              + b * c * h * d * elt              # out, every row
              + 4 * (case["positions"].numel() + case["block_tables"].numel()))
    flops = 0
    for n, v in zip(case["ctx"], case["valid"]):
        for j in range(v):
            visible = n + j + 1
            if case["window"] > 0:
                visible = min(visible, case["window"])
            flops += 4 * d * h * visible
    return nbytes, flops


def cuda_ms(torch, fn, reps=5, iters=20):
    """Median over ``reps`` of the mean per-call time of ``iters`` calls
    (after one warm-up), by CUDA events."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def graph_ms(torch, fn, iters=20, reps=5):
    """Median over ``reps`` of the mean per-call device time of ``iters``
    calls captured in one CUDA graph (after warm-up on the capturing stream),
    by CUDA events around each replay: the kernels' time without the host's
    time to launch them, which back-to-back calls (``cuda_ms``) include when
    a call is shorter than its launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


# the two step shapes of the main path: 16 slots, 8 of them live (the other
# 8 frozen, positions -1), decode at ragged contexts and a 128-token prefill
# chunk at staggered offsets; and a 128-wide step of the serving frame with
# 4 rows prefilling and 4 decoding (one live position and 127 pad rows
# each) at long contexts
K1_MAIN = {
    "decode": dict(ctx=[99, 1999, 732, 1499, 256, 1023, 1898, 411] + [0] * 8,
                   c=1, valid=[1] * 8 + [0] * 8),
    "prefill": dict(ctx=[0, 256, 512, 768, 1024, 1280, 1536, 1792] + [0] * 8,
                    c=128, valid=[128] * 7 + [57] + [0] * 8, seed=1),
    "mixed": dict(ctx=[1024, 1536, 2048, 3072, 3500, 2500, 1500, 3900] + [0] * 8,
                  c=128, valid=[128] * 4 + [1] * 4 + [0] * 8, seed=17),
}


# the speculative serving steps (16 slots, 8 live, 8 pad rows): the draft's
# width-2 re-feed (positions cached - 1 and cached) and the target's verify
# of gamma + 1 positions (gamma 2 and 4), with chunks that straddle a page
# boundary and rows at short and long contexts
K1_SPEC = {
    "refeed_c2": dict(ctx=[127, 255, 1000, 40, 1791, 383, 2, 640] + [0] * 8, c=2,
                      valid=[2] * 8 + [0] * 8, seed=30),
    "verify_c3": dict(ctx=[126, 1023, 300, 1790, 5, 767, 1151, 1500] + [0] * 8, c=3,
                      valid=[3] * 8 + [0] * 8, seed=31),
    "verify_c5": dict(ctx=[124, 2046, 77, 509, 1277, 30, 1020, 894] + [0] * 8, c=5,
                      valid=[5] * 7 + [2] + [0] * 8, seed=32),
}
DRAFT_DIMS = dict(h=32, kvh=8, d=64)     # Llama-3.2-1B's attention: the 1B draft

# one rank's attention of llama2-70b served at tp = 4 (64 / 4 query heads on
# 8 / 4 kv heads, a GQA group of 8), at the main path's decode and prefill
# steps: the shape ``python3 chip_smoke.py tp-nccl`` serves on each card
TP_DIMS = dict(h=16, kvh=2, d=128)
K1_TP = {f"tp4_{name}": {**K1_MAIN[name], **TP_DIMS} for name in ("decode", "prefill")}


def poison(torch, case):
    """NaN where no live row may look: every slot of trash block 0, every
    pool slot of a sequence at or beyond its chunk's first position (the
    chunk rides beside the pool; in serving those slots hold rejected
    speculation or nothing yet), table padding pointed at block 0, and the
    chunk's pad rows."""
    bs = case["kpool"].shape[3]
    nan = float("nan")
    for pool in ("kpool", "vpool"):
        case[pool][:, :, 0] = nan
        for i, n in enumerate(case["ctx"]):
            end = n + case["valid"][i]
            for page in range(n // bs, min(-(-end // bs), case["block_tables"].shape[1])):
                start = n % bs if page == n // bs else 0
                case[pool][:, :, case["block_tables"][i, page], start:] = nan
    for i, n in enumerate(case["ctx"]):
        case["block_tables"][i, -(-(n + case["valid"][i]) // bs):] = 0
    for t in ("chunk_k", "chunk_v"):
        case[t][case["positions"] < 0] = nan
    return case


def k1_check_cases(torch):
    """kernel_check's K1 cases: the main path's shapes, the options, every
    compiled head dim and page size, falcon-7b's 71 query rows a kv head, a
    decode the plan splits at bs 16, the mixed serving step, and NaN parked
    where no live row may look."""
    mk = make_case
    return [mk(torch, name, **kw) for name, kw in K1_MAIN.items()] + [
        mk(torch, "decode_window", ctx=[99, 1999, 700], c=1, window=256, seed=2),
        mk(torch, "prefill_window", ctx=[0, 900], c=128, valid=[128, 77], window=200, seed=3),
        mk(torch, "decode_alibi", ctx=[50, 1200], c=1, alibi=True, seed=4),
        mk(torch, "prefill_softcap", ctx=[0, 640], c=128, valid=[100, 128], softcap=50.0, seed=5),
        # the other compiled instantiations: head dims 64, 80, 96 and 256,
        # pages smaller than the 64-slot tile, MHA, MQA and G = 71
        mk(torch, "decode_d64_bs16_mha", ctx=[5, 300, 77], c=1, h=16, kvh=16, d=64, bs=16, seed=6),
        mk(torch, "prefill_d64_bs32_mqa", ctx=[0, 200], c=40, valid=[40, 23], h=8, kvh=1, d=64,
           bs=32, seed=7),
        mk(torch, "prefill_d256_bs16", ctx=[0, 333], c=96, valid=[96, 50], h=16, kvh=8, d=256,
           bs=16, window=64, seed=8),
        mk(torch, "decode_d256", ctx=[1000, 17], c=1, h=8, kvh=2, d=256, alibi=True, seed=9),
        mk(torch, "decode_d256_softcap", ctx=[1500, 40], c=1, h=16, kvh=8, d=256, softcap=50.0,
           seed=21),
        mk(torch, "decode_d80_phi2", ctx=[700, 5, 0], c=1, valid=[1, 1, 0], h=32, kvh=32, d=80,
           seed=10),
        mk(torch, "prefill_d80_phi2", ctx=[0, 300], c=128, valid=[128, 40], h=32, kvh=32, d=80,
           seed=11),
        mk(torch, "decode_d96_neox_bs16", ctx=[900, 33], c=1, h=64, kvh=64, d=96, bs=16,
           window=512, seed=12),
        mk(torch, "prefill_d96_neox", ctx=[0, 1000], c=64, valid=[64, 9], h=64, kvh=64, d=96,
           alibi=True, seed=13),
        mk(torch, "decode_g71_falcon", ctx=[1500, 3], c=1, h=71, kvh=1, d=64, bs=16, seed=14),
        mk(torch, "decode_bs16_split", ctx=[4000], c=1, bs=16, seed=15),
        poison(torch, mk(torch, "nan_decode", ctx=[99, 300, 0], c=1, valid=[1, 1, 0], seed=16)),
        poison(torch, mk(torch, "nan_prefill", ctx=[0, 130, 0], c=128, valid=[60, 128, 0],
                         seed=18)),
        poison(torch, mk(torch, "nan_d80", ctx=[77, 0], c=16, valid=[16, 0], h=32, kvh=32, d=80,
                         bs=16, seed=19)),
    ] + k1_spec_cases(torch) + [mk(torch, name, **kw) for name, kw in K1_TP.items()]


def k1_spec_cases(torch):
    """K1 at the speculative widths (C = 2, 3, 5) at llama3-8b's attention
    and at the 1B draft's (D 64), with NaN parked in every pool slot at or
    beyond each row's first chunk position (the rejected speculation a
    step must never read), in trash block 0 and in the pad rows."""
    return [poison(torch, make_case(torch, f"spec_{name}{tag}", **{**kw, **dims}))
            for name, kw in K1_SPEC.items()
            for tag, dims in (("", {}), ("_draft_d64", DRAFT_DIMS))]


def check_k1(torch, case):
    """K1 twice on the case against its plain version on f32 copies: within
    atol = rtol = 2e-2 and relative Frobenius <= 1e-2 on the live rows, pad
    rows exactly 0, every value finite, the two runs bit-identical, one
    launch each. Returns (max error, route)."""
    from deepspeed_tpu_torch.ops.paged_attention import (paged_ragged_attention,
                                                          paged_ragged_attention_plain)
    fn = paged_ragged_attention
    fn.launches = 0
    before = dict(fn.routes)
    first = call(fn, case)
    second = call(fn, case)
    ref = call(paged_ragged_attention_plain, case, cast=lambda t: t.float())
    torch.cuda.synchronize()
    way = [k for k in fn.routes if fn.routes[k] != before[k]]
    got = first.float()
    live = case["positions"] >= 0
    err = (got - ref).abs()[live]
    rel = float(torch.linalg.vector_norm(got[live] - ref[live])
                / torch.linalg.vector_norm(ref[live]))
    pad_zero = bool((got[~live] == 0).all()) if (~live).any() else True
    finite = bool(torch.isfinite(got).all())
    same = bool(torch.equal(first, second))
    ok = (bool((err <= ATOL + RTOL * ref.abs()[live]).all()) and rel <= FRO_TOL and pad_zero
          and finite and same and fn.launches == 2 and len(way) == 1)
    b, c, h, d = case["q"].shape
    emit("kernel_check", kernel="paged_attention", case=case["name"], route=way,
         shape=dict(B=b, C=c, H=h, KVH=case["kpool"].shape[1], D=d, bs=case["kpool"].shape[3]),
         max_abs_err=float(err.max()), rel_fro=rel, atol=ATOL, rtol=RTOL, fro_tol=FRO_TOL,
         pad_rows_zero=pad_zero, finite=finite, twice_bit_identical=same, within=ok)
    if not ok:
        fail(f"paged_attention {case['name']}: max_abs_err {float(err.max())}, rel {rel}, "
             f"pad rows zero {pad_zero}, finite {finite}, same {same}, route {way}")
    return float(err.max()), way[0]


def graph_bits(torch, fn):
    """One call captured in a CUDA graph and replayed gives the eager call's
    bits (no host sync or host-built data in the call)."""
    eager = fn(0).clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(0)
    graph.replay()
    torch.cuda.synchronize()
    same = bool(torch.equal(out, eager))
    del graph
    return same


def k1_crossover(torch):
    """Both K1 routes forced (through SPLIT_MAX_ROWS and SPLIT_MAX_C) as the chunk width C
    grows, on llama3-8b's shape (G 4) and falcon-7b's (71 query heads on one
    kv head, D 64), 8 sequences at contexts 512-1919: device ms by graph
    replay, and the route the chooser takes."""
    from deepspeed_tpu_torch.ops import paged_attention as PA
    keep = PA.SPLIT_MAX_ROWS, PA.SPLIT_MAX_C
    shapes = {"llama3-8b": (dict(h=H, kvh=KVH, d=D), (1, 2, 4, 8, 16, 32, 64)),
              "falcon-7b": (dict(h=71, kvh=1, d=64), (1, 2, 4))}
    out = {}
    try:
        for model, (dims, widths) in shapes.items():
            rows = {}
            for c in widths:
                case = make_case(torch, f"cross_{model}_c{c}", c=c, layers=8, seed=20 + c,
                                 ctx=[512 + 201 * i for i in range(8)], **dims)
                row = {}
                for way, limit in (("split", 1 << 30), ("wgmma", 0)):
                    PA.SPLIT_MAX_ROWS = PA.SPLIT_MAX_C = limit
                    row[way] = graph_ms(torch, lambda i: call(PA.paged_ragged_attention, case,
                                                              i % 8))
                PA.SPLIT_MAX_ROWS, PA.SPLIT_MAX_C = keep
                g = dims["h"] // dims["kvh"]
                row.update(rows_per_kv_head=c * g, chooser=PA.route(c, g, dims["d"], BS))
                rows[c] = row
                del case
            out[model] = rows
    finally:
        PA.SPLIT_MAX_ROWS, PA.SPLIT_MAX_C = keep
    torch.cuda.empty_cache()
    emit("k1_crossover", by_model_and_c=out, split_max_rows=keep[0], split_max_c=keep[1], bs=BS,
         note="graph-replay device ms, both routes forced; contexts 512 + 201 i, 8 layers cycled")


def kernel_phases(torch):
    """Phases 2-4 for the paged attention kernel (K1), and its crossover.
    Returns the kernel's summary entry (without ``launches``, which the main
    path fills)."""
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops.paged_attention import (paged_ragged_attention,
                                                          paged_ragged_attention_plain)

    t0 = time.perf_counter()
    secs = op_builder.build()
    emit("build", kernels=secs, wall_s=time.perf_counter() - t0,
         ptxas={k: [ln for ln in v.splitlines()
                    if any(w in ln for w in ("registers", "smem", "spill"))]
                for k, v in op_builder.BUILD_LOGS.items()},
         wgmma_kernels={lib: wgmma_build_report(op_builder, lib) for lib in WGMMA_LIBS},
         decode_woq_kernels={lib: decode_woq_build_report(op_builder, lib)
                             for lib in ("paged_attention", "decode_attention", "woq_matmul")})

    worst, routes = 0.0, {}
    for case in k1_check_cases(torch):
        err, routes[case["name"]] = check_k1(torch, case)
        worst = max(worst, err)
        if case["name"].startswith(("spec_", "tp4_")):
            # the speculative and tp steps replay from CUDA graphs: a replay
            # of the case must give the eager call's bits, NaN slots and all
            same = graph_bits(torch, lambda i, c=case: call(paged_ragged_attention, c))
            emit("kernel_check_graph", kernel="paged_attention", case=case["name"],
                 graph_bit_identical=same)
            if not same:
                fail(f"paged_attention {case['name']}: the graph replay differs from eager")
        del case
    torch.cuda.empty_cache()

    # timing: 8 layers of pool cycled, so a call finds its pages cold in L2
    # as each layer of a real step does
    shapes = {}
    for name, kw in list(K1_MAIN.items()) + list(K1_SPEC.items()) + list(K1_TP.items()):
        case = make_case(torch, name, layers=8, **kw)
        f32 = {k: case[k].float() for k in ("q", "kpool", "vpool", "chunk_k", "chunk_v")}
        plain_case = {**case, **f32}
        nbytes, flops = case_work(case)
        b_ms, b_by = bound(nbytes, flops)
        kernel = lambda i: call(paged_ragged_attention, case, i % 8)   # noqa: E731
        library = lambda i: library_call(torch, case, i % 8)           # noqa: E731
        row = dict(
            ms=cuda_ms(torch, kernel), graph_ms=graph_ms(torch, kernel),
            graph_bit_identical=graph_bits(torch, kernel),
            route=routes.get(name, routes.get(f"spec_{name}")),
            plain_ms=cuda_ms(torch, lambda i: call(
                paged_ragged_attention_plain, plain_case, i % 8), reps=3, iters=5),
            library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
            shape=dict(B=len(case["ctx"]), C=int(case["positions"].shape[1]),
                       H=int(case["q"].shape[2]), KVH=int(case["kpool"].shape[1]),
                       D=int(case["q"].shape[3]), bs=BS, dtype="bfloat16"))
        emit("kernel_time", kernel="paged_attention", case=name,
             library="pages gathered + F.scaled_dot_product_attention (boolean mask)",
             timing="ms: back-to-back calls by CUDA events (host launch time included); "
             "graph_ms: the same calls replayed from one CUDA graph (device time)", **row)
        if not row["graph_bit_identical"]:
            fail(f"paged_attention {name}: the graph replay differs from the eager call")
        shapes[name] = row
        del case, plain_case, f32
    torch.cuda.empty_cache()
    k1_crossover(torch)
    dec = shapes["decode"]
    return {"name": "paged_attention", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "max_abs_err": worst,
            "ms": dec["ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"], "bound_by": dec["bound_by"],
            "library_ms": dec["library_ms"], "device_ms": dec["graph_ms"],
            "library_device_ms": dec["library_graph_ms"], "shapes": shapes}


# ------------------------------------------------------------------ main path

def serve_counted(torch, eng, arrivals, time_narrow=False, trace=False, crash_ok=False,
                  **kw):
    """One ``eng.serve(arrivals, **kw)`` with every count set to 0 before:
    the (uid, tokens) pairs in retirement order, frames and steps
    dispatched (wide and width-1 apart), each request's first emission
    time (the host replay of a frame is where a token becomes visible),
    seconds, and K1's launches: the wrapper's (eager runs) plus the graph
    replays' (what each capture recorded, once a replay), with the
    captures and their seconds. ``time_narrow`` times each width-1 frame
    alone (a sync before it): wall and CUDA-event ms a step. ``trace``
    runs each frame under its own torch.profiler session and adds the K1
    kernels on the card and the device ms by kernel class. Sessions
    dropped kernel records of graph replays near their start and end (1
    to 195 of a frame's, or a whole step's), so each opens and closes on an
    idle card: a sync and ``TRACE_SETTLE_S`` of waiting on both sides of
    the frame. ``crash_ok``: a ``FrameDispatchError`` ends the run and is
    returned as ``error``, with the pairs yielded before it."""
    from torch.profiler import ProfilerActivity, profile
    from deepspeed_tpu_torch.inference.v2 import DeviceSlotTable
    from deepspeed_tpu_torch.inference.v2.faults import FrameDispatchError
    count = {"steps": 0, "frames": 0, "wide_steps": 0, "narrow_steps": 0}
    first_tok, narrow, traced = {}, [], {"k1": 0, "by_class": {}, "short": []}
    dispatch, absorb = DeviceSlotTable.dispatch_frame, DeviceSlotTable.absorb

    def k1_launched():
        return read_counts()["paged_attention"] + (
            graphs.replayed.get("paged_attention", 0) if graphs is not None else 0)

    def traced_dispatch(*args, **kw_):
        before = k1_launched()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_SETTLE_S)
            out = dispatch(*args, **kw_)
            torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S)
        by_class, k1 = trace_device_ms(torch, prof, _kernel_class)
        if k1 != k1_launched() - before:
            traced["short"].append((args[4], args[5], k1_launched() - before, k1))
        traced["k1"] += k1
        for cls, ms in by_class.items():
            traced["by_class"][cls] = traced["by_class"].get(cls, 0.0) + ms
        return out

    def counting_dispatch(self, runner, params, kv, width, steps, greedy, draft=None,
                          repair=False):
        count["steps"] += steps
        count["frames"] += 1
        count["wide_steps" if width > 1 else "narrow_steps"] += steps
        if trace:
            return traced_dispatch(self, runner, params, kv, width, steps, greedy, draft,
                                   repair=repair)
        if width > 1 or not time_narrow:
            return dispatch(self, runner, params, kv, width, steps, greedy, draft,
                            repair=repair)
        # a width-1 frame timed alone: host wall time to its end, and the
        # card's time between events recorded around it
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        out = dispatch(self, runner, params, kv, width, steps, greedy, draft, repair=repair)
        ev[1].record()
        ev[1].synchronize()
        narrow.append((steps, time.perf_counter() - t0, ev))
        return out

    def timed_absorb(self, *a, **kw_):
        emissions, finished = absorb(self, *a, **kw_)
        now = time.perf_counter()
        for uid in emissions:
            first_tok.setdefault(uid, now)
        return emissions, finished

    graphs = eng.runner.graphs
    g0 = graphs.stats() if graphs is not None else None
    DeviceSlotTable.dispatch_frame = counting_dispatch
    DeviceSlotTable.absorb = timed_absorb
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    got, error = [], None
    try:
        try:
            for pair in eng.serve(arrivals, **kw):
                got.append(pair)
        except FrameDispatchError as e:
            if not crash_ok:
                raise
            error = e
        torch.cuda.synchronize()
    finally:
        DeviceSlotTable.dispatch_frame = dispatch
        DeviceSlotTable.absorb = absorb
    narrow_steps = sum(n for n, _, _ in narrow)
    out = dict(got=got, error=error, steps=count["steps"], frames=count["frames"],
               first_tok=first_tok,
               wide_steps=count["wide_steps"], narrow_steps=count["narrow_steps"],
               narrow_step_wall_ms=(sum(w for _, w, _ in narrow) * 1e3 / narrow_steps
                                    if narrow_steps else None),
               narrow_step_event_ms=(sum(e[0].elapsed_time(e[1]) for _, _, e in narrow)
                                     / narrow_steps if narrow_steps else None),
               serve_s=time.perf_counter() - t0, counts=read_counts(),
               prefill_tokens=eng.serve_counters["prefill_tokens"],
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               captures=0, capture_s=0.0, replays=0, replayed=0,
               k1_on_card=traced["k1"] if trace else None,
               trace_short_frames=traced["short"] if trace else None,
               device_ms_by_class=traced["by_class"] if trace else None)
    if graphs is not None:
        g1 = graphs.stats()
        out.update(captures=g1["captures"] - g0["captures"],
                   capture_s=g1["capture_s"] - g0["capture_s"],
                   replays=g1["replays"] - g0["replays"],
                   replayed=(g1["replayed_launches"].get("paged_attention", 0)
                             - g0["replayed_launches"].get("paged_attention", 0)))
    out["launches"] = out["counts"]["paged_attention"] + out["replayed"]
    return out


K1_KERNELS = ("paged_split", "paged_fwd_wgmma")
TRACE_SETTLE_S = 0.5


def device_kernel_count(torch, prof, names):
    """Kernels whose name holds one of ``names`` in a torch.profiler trace,
    and every device kernel of the trace."""
    ours = every = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        every += 1
        ours += any(n in ev.name for n in names)
    return ours, every


def main_workload(torch, vocab):
    """The main path's requests: 8 prompts of 64 to 1500 tokens (seed 0),
    uid 5 with an EOS id (its prompt's first token), arriving over 3 frame
    boundaries. Returns (prompts, eos uid, eos id, arrivals(), the arrival
    times arrivals() records by uid)."""
    g = torch.Generator().manual_seed(0)
    lens = [64, 1500, 333, 900, 128, 1200, 77, 640]
    prompts = {u: torch.randint(0, vocab, (n,), generator=g).numpy()
               for u, n in enumerate(lens)}
    eos_uid, eos_id = 5, int(prompts[5][0])
    schedule = {0: [0, 1, 2], 1: [3, 4, 5], 2: [6, 7]}
    arrival_t = {}

    def arrivals():
        for k in range(3):
            batch = []
            for u in schedule[k]:
                arrival_t[u] = time.perf_counter()
                batch.append((u, prompts[u], None, None, eos_id)
                             if u == eos_uid else (u, prompts[u]))
            yield batch

    return prompts, eos_uid, eos_id, arrivals, arrival_t


def main_path(torch, smi):
    """Phase 5: serve 8 greedy requests through InferenceEngineV2.serve() on
    llama3-8b at full width and depth (random weights from seed 0): first
    eagerly (a runner built with ``cuda_graphs=False``), then from CUDA
    graphs (the engine's default on the card) twice, the first run
    capturing them, then once more from the captured graphs under
    torch.profiler. The tokens and the
    retirement order must be identical; K1's launches must equal layers x
    steps in each run, counted as the wrapper's launches plus what the
    replays launched, and in the traced run as K1 kernels on the device.
    reference_check and step_profile run before the traced run (no host
    time is taken after a trace: ``profile_modes``), a sampled serve()
    after it, then v2_api_path, all on the same engine. Returns K1's
    launches in the graph run and that run's tokens by uid."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.inference.v2.model_runner import PagedModelRunner
    from deepspeed_tpu_torch.models import build_model

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model("llama3-8b")
    cfg = model.cfg
    config = RaggedInferenceEngineConfig(
        max_ragged_batch_size=16, kv_block_size=BS, prefill_chunk_size=128,
        dtype="bfloat16")
    eng = InferenceEngineV2(model, config, max_seq_len=2048)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    graph_runner = eng.runner
    eager_runner = PagedModelRunner(eng.model, BS, eng.max_blocks_per_seq, eng.device,
                                    cuda_graphs=False)

    prompts, eos_uid, eos_id, arrivals, arrival_t = main_workload(torch, cfg.vocab_size)
    lens = [len(p) for p in prompts.values()]
    runs = {}
    for mode, runner in (("eager", eager_runner), ("graph_first", graph_runner),
                         ("graph", graph_runner)):
        eng.runner = runner
        runs[mode] = serve_counted(torch, eng, arrivals(), max_new_tokens=32)
        runs[mode]["ttft_first_request_s"] = runs[mode]["first_tok"][0] - arrival_t[0]
    eng.runner = graph_runner
    reference_check(torch, eng, prompts[1][:300])
    step_profile(torch, eng, eager_runner, smi)      # its host times precede any trace
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runs["traced"] = serve_counted(torch, eng, arrivals(), max_new_tokens=32)
    on_card, every_kernel = device_kernel_count(torch, prof, K1_KERNELS)
    del prof
    # sampled rows: their steps run eagerly, never captured
    sampled = serve_counted(torch, eng, iter([[(0, prompts[0], 8, 0.8), (6, prompts[6], 8, 0.8)]]),
                            max_new_tokens=8, rng=1)
    if sampled["captures"] or sorted(len(t) for _, t in sampled["got"]) != [8, 8]:
        fail(f"main path: sampled serve() made {sampled['captures']} captures, tokens "
             f"{[len(t) for _, t in sampled['got']]}")

    got = dict(runs["graph"]["got"])
    if set(got) != set(prompts):
        fail(f"main path: completed {sorted(got)}, expected {sorted(prompts)}")
    for uid, toks in got.items():
        if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
            fail(f"main path: uid {uid} emitted tokens outside [0, vocab)")
        want = 32
        if uid == eos_uid and eos_id in toks.tolist():
            want = toks.tolist().index(eos_id) + 1
        if len(toks) != want:
            fail(f"main path: uid {uid} emitted {len(toks)} tokens, expected {want}")
    for mode in ("eager", "graph_first", "traced"):
        other = runs[mode]["got"]
        if [u for u, _ in other] != [u for u, _ in runs["graph"]["got"]] or any(
                not np_equal(a, b) for (_, a), (_, b) in zip(other, runs["graph"]["got"])):
            fail(f"main path: the {mode} run's tokens or retirement order differ from "
                 "the graph run's")
    for mode, r in runs.items():
        if r["launches"] != cfg.num_layers * r["steps"]:
            fail(f"main path ({mode}): {r['launches']} paged attention launches "
                 f"({r['counts']['paged_attention']} run + {r['replayed']} replayed), "
                 f"expected {cfg.num_layers} layers x {r['steps']} steps")
    if runs["traced"]["captures"] or on_card != cfg.num_layers * runs["traced"]["steps"]:
        fail(f"main path (traced): {on_card} K1 kernels on the card of {every_kernel}, "
             f"{runs['traced']['captures']} captures; expected "
             f"{cfg.num_layers} x {runs['traced']['steps']} replayed")
    if eng.kv.free_blocks != eng.kv.num_blocks - 1 or eng.state.seqs:
        fail(f"main path: pool did not drain ({eng.kv.free_blocks} of "
             f"{eng.kv.num_blocks - 1} blocks free)")
    n_tok = sum(len(t) for t in got.values())
    by_mode = {mode: {"serve_s": r["serve_s"], "tokens_per_s": n_tok / r["serve_s"],
                      "ttft_first_request_s": r.get("ttft_first_request_s"),
                      "frames": r["frames"], "steps": r["steps"],
                      "paged_attention_launches": r["launches"],
                      "launches_run": r["counts"]["paged_attention"],
                      "launches_replayed": r["replayed"], "captures": r["captures"],
                      "capture_s": r["capture_s"], "replays": r["replays"],
                      "peak_memory_gb": r["peak_memory_gb"]}
               for mode, r in runs.items()}
    r = runs["graph"]
    emit("main_path", model="llama3-8b", layers=cfg.num_layers,
         hidden=cfg.hidden_size, requests=len(got), tokens=n_tok,
         prompt_tokens=sum(lens), frames=r["frames"], steps=r["steps"],
         paged_attention_launches=r["launches"], launches_per_step=r["launches"] / r["steps"],
         serve_s=r["serve_s"], tokens_per_s=n_tok / r["serve_s"],
         ttft_first_request_s=r["ttft_first_request_s"],
         prefill_tokens=r["prefill_tokens"],
         k1_kernels_on_card_traced=on_card, kernels_on_card_traced=every_kernel,
         tokens_identical_graph_eager=True, by_mode=by_mode,
         sampled_steps="eager by rule (any live temperature > 0); greedy steps replayed",
         sampled_run={"steps": sampled["steps"], "captures": sampled["captures"],
                       "k1_launches_run": sampled["counts"]["paged_attention"],
                       "serve_s": sampled["serve_s"]},
         engine_build_s=build_s, kv_blocks=eng.kv.num_blocks, card=smi)
    v2_api_path(torch, eng, eager_runner, prompts, smi)
    return r["launches"], {u: t.tolist() for u, t in got.items()}


def np_equal(a, b):
    return len(a) == len(b) and bool((a == b).all())


def first_divergence(a, b):
    """The first position where token lists a and b differ (None: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


V2_DRIVE = ((100, 2), (101, 0))   # (uid, main-path prompt): 333 and 64 tokens


def v2_api_calls(torch, eng, prompts):
    """generate() and generate_compiled() on the main path's 8 prompts (32
    greedy new tokens), then a put / step / query / flush drive of two
    prompts across a chunk boundary (8 tokens each), on ``eng`` as its
    runner stands. Returns ({call: tokens by uid}, {call: measurements},
    the drive's pending counts after each step)."""
    uids = sorted(prompts)
    toks, rows = {}, {}
    for name in ("generate", "generate_compiled"):
        graphs = eng.runner.graphs
        g0 = graphs.stats() if graphs is not None else None
        step, first = eng.step, {}

        def timed_step(*a, **kw):
            out = step(*a, **kw)
            if out:
                first.setdefault("t", time.perf_counter())
            return out

        eng.step = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            outs = getattr(eng, name)([prompts[u] for u in uids], max_new_tokens=32)
        finally:
            del eng.step
        secs = time.perf_counter() - t0
        toks[name] = {u: t.tolist() for u, t in zip(uids, outs)}
        rows[name] = {"s": secs, "tokens_per_s": sum(len(t) for t in outs) / secs,
                      # generate_compiled hands every token over at the end
                      "first_token_s": first.get("t", t0 + secs) - t0,
                      "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if graphs is not None:
            g1 = graphs.stats()
            rows[name].update(captures=g1["captures"] - g0["captures"],
                              capture_s=g1["capture_s"] - g0["capture_s"],
                              replays=g1["replays"] - g0["replays"])
    eng.put([u for u, _ in V2_DRIVE], [prompts[src] for _, src in V2_DRIVE])
    pending = [[eng.query(u)[0] for u, _ in V2_DRIVE]]
    while any(len(eng.query(u)[1]) < 8 for u, _ in V2_DRIVE):
        eng.step()
        pending.append([eng.query(u)[0] for u, _ in V2_DRIVE])
    toks["step"] = {u: eng.query(u)[1][:8] for u, _ in V2_DRIVE}
    eng.flush([u for u, _ in V2_DRIVE])
    if eng.kv.free_blocks != eng.kv.num_blocks - 1 or eng.state.seqs:
        fail(f"v2_api_path: pool did not drain ({eng.kv.free_blocks} of "
             f"{eng.kv.num_blocks - 1} blocks free)")
    return toks, rows, pending


def v2_api_path(torch, eng, eager_runner, prompts, smi):
    """Phase v2_api_path, on the main path's engine: ``v2_api_calls`` eagerly
    (its runner built with ``cuda_graphs=False``), then from CUDA graphs;
    the graph calls must give the eager calls' tokens, and the drive must
    report pending counts 333 -> 205 -> 77 -> 0 and 64 -> 0.
    generate_compiled() must give what serve() gives the same 8 prompts
    arriving at once in 8 slots with frames as long as the prefill (12
    steps of 128 tokens), which is its program: the same wide steps, then
    the same narrow ones, over the same rows. The serve() run of the main
    path has other steps (16 slots, three arrivals, an EOS row that
    freezes and so changes K1's split of the others' pages), and
    generate() and the drive decode at width 1 in other batches (another
    K1 route, other GEMM shapes): bf16 rounding that differs flips the
    near-tied argmaxes of random weights, so their agreement with the
    serve() run is reported, not required (the CPU tests hold every call
    token-identical to the JAX engine in f32)."""
    uids = sorted(prompts)
    wide = -(-max(len(p) for p in prompts.values()) // 128)
    served = dict(eng.serve(iter([[(u, prompts[u]) for u in uids]]), max_new_tokens=32,
                            frame_steps=wide, frame_slots=len(uids)))
    graph_runner = eng.runner
    eng.runner = eager_runner
    try:
        eager_toks, eager_rows, eager_pending = v2_api_calls(torch, eng, prompts)
    finally:
        eng.runner = graph_runner
    toks, rows, pending = v2_api_calls(torch, eng, prompts)
    if toks != eager_toks or pending != eager_pending:
        fail("v2_api_path: the graph calls' tokens differ from the eager calls'")
    firsts = [pending[i][0] for i in range(4)]
    if firsts != [333, 205, 77, 0] or pending[1][1] != 0:
        fail(f"v2_api_path: pending counts {pending[:4]}")
    for u, t in toks["generate_compiled"].items():
        if t != served[u].tolist():
            fail(f"v2_api_path: generate_compiled() uid {u} first differs from serve() at "
                 f"token {first_divergence(t, served[u].tolist())}")
    drive_src = dict(V2_DRIVE)
    agree = {name: {u: first_divergence(t, served[drive_src.get(u, u)].tolist()[:len(t)])
                    for u, t in toks[name].items()}
             for name in ("generate", "step")}
    emit("v2_api_path", model="llama3-8b", prompts=len(uids), new_tokens=32,
         graph_equals_eager=True, generate_compiled_equals_serve=True,
         serve_frame_steps=wide, first_divergence_from_serve=agree,
         step_drive_pending=pending[:5], step_drive_steps=len(pending) - 1,
         graph_keys=len(eng.runner.graphs.keys()), graph=rows, eager=eager_rows, card=smi)


def phi2_path(torch, smi):
    """Phase 5b: ``serve()`` on phi-2 at full width and depth (head dim 80:
    K1's split route at decode and prefill), 4 greedy requests from CUDA
    graphs with every count set to 0 before and read after: tokens in
    [0, vocab), K1 launches (run + replayed) = layers x steps, all on the
    split route, the pool drained."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.paged_attention import paged_ragged_attention
    model = build_model("phi-2")
    cfg = model.cfg
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        max_ragged_batch_size=16, kv_block_size=BS, prefill_chunk_size=128,
        dtype="bfloat16"), max_seq_len=2048)
    g = torch.Generator().manual_seed(3)
    lens = [300, 37, 900, 128]
    prompts = {u: torch.randint(0, cfg.vocab_size, (n,), generator=g).numpy()
               for u, n in enumerate(lens)}
    paged_ragged_attention.routes = {"split": 0, "wgmma": 0}
    r = serve_counted(torch, eng, iter([list(prompts.items())]), max_new_tokens=16)
    got = dict(r["got"])
    launches = r["launches"]
    if set(got) != set(prompts) or any(len(t) != 16 for t in got.values()):
        fail(f"phi-2 path: completed {sorted(got)} with {[len(t) for t in got.values()]} tokens")
    if not all(((t >= 0) & (t < cfg.vocab_size)).all() for t in got.values()):
        fail("phi-2 path: tokens outside [0, vocab)")
    if launches != cfg.num_layers * r["steps"] or paged_ragged_attention.routes["wgmma"]:
        fail(f"phi-2 path: {launches} K1 launches ({paged_ragged_attention.routes} run, "
             f"{r['replayed']} replayed), expected {cfg.num_layers} layers x {r['steps']} "
             "steps on the split route")
    if eng.kv.free_blocks != eng.kv.num_blocks - 1 or eng.state.seqs:
        fail(f"phi-2 path: pool did not drain ({eng.kv.free_blocks} of "
             f"{eng.kv.num_blocks - 1} blocks free)")
    n_tok = sum(len(t) for t in got.values())
    emit("phi2_path", model="phi-2", layers=cfg.num_layers, hidden=cfg.hidden_size,
         head_dim=cfg.dims_per_head, requests=len(got), tokens=n_tok, steps=r["steps"],
         paged_attention_launches=launches, launches_replayed=r["replayed"],
         routes_run=dict(paged_ragged_attention.routes), captures=r["captures"],
         other_launches={k: v for k, v in r["counts"].items() if v and k != "paged_attention"},
         serve_s=r["serve_s"], tokens_per_s=n_tok / r["serve_s"], card=smi)
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dense_logits(torch, eng, ids):
    """Last-position logits of ``ids`` by a dense causal forward written
    out here (no pages, no kernel; f32 softmax over every earlier token),
    with the engine's weights (int8 leaves dequantized by ``layers.dq``)
    and dtype."""
    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.models.transformer import layer_slice
    cfg, p, dev = eng.model.cfg, eng.params, eng.device
    dt, e, h, kvh, d = (cfg.act_dtype, cfg.hidden_size, cfg.num_heads,
                        cfg.kv_heads, cfg.dims_per_head)
    s = len(ids)
    x = p["embed"]["tok"][ids].to(dt)[None]
    pos = torch.arange(s, device=dev)[None]
    inv = eng.model.inv_freq(dev)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    for li in range(cfg.num_layers):
        lp = layer_slice(p["layers"], li)
        a = L.apply_norm(lp["norm1"], x, cfg)
        att = {n: L.dq(lp["attn"][n], dt) for n in ("wq", "wk", "wv", "wo")}
        q = (a @ att["wq"].reshape(e, h * d)).view(1, s, h, d)
        k = (a @ att["wk"].reshape(e, kvh * d)).view(1, s, kvh, d)
        v = (a @ att["wv"].reshape(e, kvh * d)).view(1, s, kvh, d)
        q, k = L.apply_rope(q, pos, inv), L.apply_rope(k, pos, inv)
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * d ** -0.5
        pr = sc.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr.to(dt).float(), v.float()).to(dt)
        x = x + (o.reshape(1, s, h * d) @ att["wo"].reshape(h * d, e))
        x = x + L.apply_mlp(lp["mlp"], L.apply_norm(lp["norm2"], x, cfg), cfg)
    x = L.apply_norm(p["final_norm"], x, cfg)
    return (x[0, -1] @ L.dq(p["embed"]["lm_head"], dt)).float()


def paged_logits(torch, eng, prompt):
    """Last-position logits of ``prompt`` through the engine's paged
    forward: 128-token chunks through ``runner.run``, each reading the
    earlier chunks back from the pool."""
    kv, dev = eng.kv, eng.device
    n, chunk = len(prompt), eng._config.prefill_chunk_size
    ids = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    blocks = kv.allocator.allocate(kv.blocks_for(n))
    try:
        table = torch.zeros((1, eng.max_blocks_per_seq), dtype=torch.int32, device=dev)
        table[0, :len(blocks)] = torch.tensor(blocks, dtype=torch.int32)
        for c0 in range(0, n, chunk):
            w = min(chunk, n - c0)
            cids = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
            cids[0, :w] = ids[c0:c0 + w]
            pos = torch.full((1, chunk), -1, dtype=torch.int32, device=dev)
            pos[0, :w] = torch.arange(c0, c0 + w, dtype=torch.int32, device=dev)
            valid = torch.tensor([w], dtype=torch.int32, device=dev)
            logits, _, _ = eng.runner.run(eng.params, cids, pos, table, valid, kv.k, kv.v)
    finally:
        kv.allocator.free(blocks)
    return logits[0]


def reference_check(torch, eng, prompt):
    """The paged path (the kernel, 128-token chunks reading earlier chunks
    back from the pool) against ``dense_logits`` on one prompt: the last
    position's logits must agree within 5% of their range (bf16 through
    32 layers), and both must be finite."""
    paged = paged_logits(torch, eng, prompt)
    n = len(prompt)
    dense = dense_logits(torch, eng, torch.as_tensor(prompt, device=eng.device).long())
    err = float((paged - dense).abs().max())
    span = float(dense.max() - dense.min())
    ok = bool(torch.isfinite(paged).all() and torch.isfinite(dense).all()) \
        and err <= 0.05 * span
    emit("reference_check", prompt_tokens=n, max_abs_logit_err=err,
         logit_range=span, tolerance=0.05 * span,
         paged_argmax=int(paged.argmax()), dense_argmax=int(dense.argmax()), within=ok)
    if not ok:
        fail(f"paged forward disagrees with the dense reference: {err} > 5% of {span}")


def _kernel_class(name):
    if any(k in name for k in ("paged_attention", "paged_split", "paged_fwd_wgmma")):
        return "paged_attention"
    if any(s in name.lower() for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def host_rows(torch, step, reps=10):
    """Host wall ms a step over ``reps`` synchronized steps, and the host's
    ms to issue one with the card idle at its start (median of 3)."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    issue = []
    for _ in range(3):
        t0 = time.perf_counter()
        step()
        issue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return dict(wall_ms=wall_ms, host_issue_ms=statistics.median(issue))


def device_rows(torch, step, classify, wall_ms):
    """Device ms by kernel class and by kernel name, and kernels by class,
    a step, from a torch.profiler trace of 3 steps; the idle share is
    1 - device busy / ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    by_class, by_name, count = {}, {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us() / 3
        cls = classify(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
        count[cls] = count.get(cls, 0) + 1
    busy_ms = sum(by_class.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:6]
    return dict(device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
                device_ms_by_class={k: v / 1e3 for k, v in by_class.items()},
                kernels_a_step_by_class={k: v / 3 for k, v in count.items()},
                top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])


def profile_modes(torch, steps, classify):
    """``host_rows`` of every step, then ``device_rows`` of each. A
    torch.profiler trace leaves CUPTI attached to the process, and every
    CUDA-graph launch after it costs the host more for each node, so host
    times are taken before the traces; tearing CUPTI down after a trace
    (TEARDOWN_CUPTI=1) hides graph kernels from later traces."""
    rows = {key: host_rows(torch, step) for key, step in steps.items()}
    for key, step in steps.items():
        rows[key].update(device_rows(torch, step, classify, rows[key]["wall_ms"]))
    return rows


def step_inputs(torch, eng, starts, c, n_slots, g, owned):
    """(ids, positions, tables, valid) on the card for one ``runner.run``
    step: row i holds a chunk of ``c`` tokens at position ``starts[i]`` over
    blocks it allocates (appended to ``owned``), the other slots pad rows."""
    kv = eng.kv
    table = torch.zeros((n_slots, eng.max_blocks_per_seq), dtype=torch.int32)
    pos = torch.full((n_slots, c), -1, dtype=torch.int32)
    for i, s0 in enumerate(starts):
        blk = kv.allocator.allocate(kv.blocks_for(s0 + c + 1))
        owned += blk
        table[i, :len(blk)] = torch.tensor(blk, dtype=torch.int32)
        pos[i] = torch.arange(s0, s0 + c, dtype=torch.int32)
    valid = (pos >= 0).sum(dim=1).to(torch.int32)
    ids = torch.randint(0, eng.model.cfg.vocab_size, (n_slots, c), generator=g,
                        dtype=torch.int32)
    return [t.to(eng.device) for t in (ids, pos, table, valid)]


def step_profile(torch, eng, eager_runner, smi):
    """Where a main-path step's time goes: one decode step (16 slots, the 8
    live rows at the kernel case's contexts) and one prefill step (8 rows of
    a 128-token chunk at offsets 0..1792), each through the eager runner and
    through the engine's runner replaying its CUDA graph (``run``'s key):
    host wall time over synchronized steps and the host's time to issue one
    (all four taken before any trace of this process: ``profile_modes``),
    then device time by kernel class (torch.profiler), the device's idle
    share (1 - device busy / step wall time), and K1 kernels a step."""
    kv, cfg = eng.kv, eng.model.cfg
    n_slots = 16
    g = torch.Generator().manual_seed(2)
    shapes = {"decode": ([99, 1999, 732, 1499, 256, 1023, 1898, 411], 1),
              "prefill": ([0, 256, 512, 768, 1024, 1280, 1536, 1792], 128)}
    owned, steps = [], {}
    try:
        for name, (starts, c) in shapes.items():
            args = step_inputs(torch, eng, starts, c, n_slots, g, owned)
            for mode, runner in (("eager", eager_runner), ("graph", eng.runner)):
                steps[name, mode] = (lambda r=runner, a=args: r.run(eng.params, *a, kv.k, kv.v))
        rows = profile_modes(torch, steps, _kernel_class)
    finally:
        kv.allocator.free(owned)
    for (name, mode), row in rows.items():
        k1 = row["kernels_a_step_by_class"].get("paged_attention", 0)
        if k1 != cfg.num_layers:
            fail(f"step_profile {name} ({mode}): {k1} K1 kernels a step on the card, "
                 f"expected {cfg.num_layers}")
        starts, c = shapes[name]
        emit("step_profile", step=name, mode=mode, live_rows=len(starts), slots=n_slots,
             width=c, **row, card=smi)


# ------------------------------------------------ quantized and speculative

def quant_check(torch, smi):
    """Phase quant_check: the int8 KV page rows and the weight quantizer on
    the card byte-identical to the same port functions on the CPU, and the
    page movers' round trip on an int8 pool at llama3-8b's shapes.
    Rows: random bf16 rows at llama3-8b's (KVH, D), all-zero rows, rows at
    three magnitudes; lanes holding NaN and inf bit patterns read back 0.
    Leaves: layer 0's ``wq`` (4096, 32, 128) and the stacked ``wk`` (32,
    4096, 8, 128), random at the model's init scale. Movers: ``read_pages``
    then ``scatter_pages`` into other blocks and ``copy_blocks`` give the
    source pages byte for byte; a bf16 payload into the int8 pool raises."""
    from deepspeed_tpu_torch.inference.v2.kv_cache import (BlockedKVCache,
                                                           dequantize_kv_lanes,
                                                           quantize_kv_lanes)
    from deepspeed_tpu_torch.inference.v2.model_implementations.quantize import (
        _quantize_leaf)
    g = torch.Generator().manual_seed(40)
    rows = torch.randn(64, BS, KVH, D, generator=g) * torch.tensor([1e-3, 1.0, 40.0]).repeat(
        22)[:64, None, None, None]
    rows[0, :5] = 0.0
    rows = rows.to(torch.bfloat16)
    cpu_q = quantize_kv_lanes(rows)
    card_q = quantize_kv_lanes(rows.cuda()).cpu()
    packed = cpu_q.clone()
    for i, bad in enumerate((float("nan"), float("inf"), -float("inf"))):
        packed[1, i, :, -4:] = torch.tensor([bad]).view(torch.int8)
    deq_same = all(torch.equal(dequantize_kv_lanes(packed, dt),
                               dequantize_kv_lanes(packed.cuda(), dt).cpu())
                   for dt in (torch.bfloat16, torch.float32))
    deq_zero = bool((dequantize_kv_lanes(packed.cuda(), torch.float32)[1, :3] == 0).all())
    leaves = {}
    for name, shape, red in (("wq_layer0", (4096, 32, 128), (0,)),
                             ("wk_stacked", (32, 4096, 8, 128), (1,))):
        w = (torch.randn(shape, generator=g) * 0.02).to(torch.bfloat16)
        w[..., :1] = 0.0                        # all-zero channels: scale 0
        cpu_l = _quantize_leaf(w, red)
        card_l = _quantize_leaf(w.cuda(), red)
        leaves[name] = all(torch.equal(cpu_l[k], card_l[k].cpu()) for k in ("q", "s"))
        del w, cpu_l, card_l
    kv = BlockedKVCache(32, KVH, D, num_blocks=9, block_size=BS, device="cuda", kv_dtype="int8")
    for pool in (kv.k, kv.v):
        pool.copy_(quantize_kv_lanes(torch.randn(pool.shape[:-1] + (D,), generator=g).cuda()))
    src = kv.read_pages([3, 5, 7])
    kv.scatter_pages(kv.k, kv.v, [2, 6, 8], *src)
    moved = all(torch.equal(a, b) for a, b in zip(kv.read_pages([2, 6, 8]), src))
    kv.copy_blocks(kv.k, kv.v, [2, 6], [1, 4])
    copied = all(torch.equal(a, b) for a, b in zip(kv.read_pages([1, 4]), kv.read_pages([3, 5])))
    try:
        kv.scatter_pages(kv.k, kv.v, [1], *(t.to(torch.bfloat16) for t in src))
        refused = False
    except ValueError:
        refused = True
    ok = (torch.equal(cpu_q, card_q) and deq_same and deq_zero and all(leaves.values())
          and moved and copied and refused)
    emit("quant_check", kv_rows=list(rows.shape), kv_lanes_identical=torch.equal(cpu_q, card_q),
         dequantize_identical=deq_same, nonfinite_lanes_read_zero=deq_zero,
         leaves_identical=leaves, movers_round_trip=moved, copy_blocks_identical=copied,
         mixed_dtype_scatter_refused=refused, pool_block_bytes=kv.block_bytes, card=smi)
    if not ok:
        fail("quant_check: the card's int8 rows, leaves or page moves differ from the CPU's")
    del kv
    torch.cuda.empty_cache()


def trace_device_ms(torch, prof, classify):
    """Device ms by kernel class over a torch.profiler trace, and the count
    of K1 kernels in it."""
    by_class, k1 = {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        cls = classify(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + ev.time_range.elapsed_us() / 1e3
        k1 += any(n in ev.name for n in K1_KERNELS)
    return by_class, k1


def served_runs(torch, eng, eager_runner, arrivals, arrival_t, **kw):
    """serve() eagerly (``eager_runner``), then twice from the engine's CUDA
    graphs (the first run captures), then once more traced frame by frame.
    Returns the runs by mode (``serve_counted``'s rows with the first
    request's TTFT) and the traced run's device ms by class and K1 kernels
    on the card."""
    graph_runner, runs = eng.runner, {}
    for mode, runner in (("eager", eager_runner), ("graph_first", graph_runner),
                         ("graph", graph_runner)):
        eng.runner = runner
        try:
            runs[mode] = serve_counted(torch, eng, arrivals(), time_narrow=mode == "graph", **kw)
        finally:
            eng.runner = graph_runner
        runs[mode]["ttft_first_request_s"] = runs[mode]["first_tok"][0] - arrival_t[0]
    runs["traced"] = serve_counted(torch, eng, arrivals(), trace=True, **kw)
    return runs, (runs["traced"]["device_ms_by_class"], runs["traced"]["k1_on_card"])


def same_serves(a, b):
    return [u for u, _ in a] == [u for u, _ in b] and all(
        np_equal(x, y) for (_, x), (_, y) in zip(a, b))


def check_budgets(name, got, prompts, eos_uid, eos_id, vocab, budget=32):
    """Every request completed with its full budget, or stopped at its EOS,
    with tokens in [0, vocab)."""
    got = dict(got)
    if set(got) != set(prompts):
        fail(f"{name}: completed {sorted(got)}, expected {sorted(prompts)}")
    for uid, toks in got.items():
        want = budget
        if uid == eos_uid and eos_id in toks.tolist():
            want = toks.tolist().index(eos_id) + 1
        if len(toks) != want or not ((toks >= 0) & (toks < vocab)).all():
            fail(f"{name}: uid {uid} emitted {len(toks)} tokens (expected {want}) or tokens "
                 "outside [0, vocab)")


def divergence_from(base, got):
    """By uid: the first position where ``got``'s tokens leave ``base``'s."""
    return {u: first_divergence(t.tolist(), base[u]) for u, t in dict(got).items() if u in base}


def run_rows(runs, n_tok):
    return {mode: {"serve_s": r["serve_s"], "tokens_per_s": n_tok / r["serve_s"],
                   "ttft_first_request_s": r.get("ttft_first_request_s"), "frames": r["frames"],
                   "wide_steps": r["wide_steps"], "narrow_steps": r["narrow_steps"],
                   "paged_attention_launches": r["launches"],
                   "launches_run": r["counts"]["paged_attention"],
                   "launches_replayed": r["replayed"], "captures": r["captures"],
                   "capture_s": r["capture_s"], "narrow_step_wall_ms": r["narrow_step_wall_ms"],
                   "narrow_step_event_ms": r["narrow_step_event_ms"],
                   "peak_memory_gb": r["peak_memory_gb"]}
            for mode, r in runs.items()}


QUANT_ENGINES = (("kv_int8", {"kv_dtype": "int8"}), ("weights_int8", {"weight_dtype": "int8"}),
                 ("both_int8", {"weight_dtype": "int8", "kv_dtype": "int8"}))


def serving_config(**over):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
    return RaggedInferenceEngineConfig(max_ragged_batch_size=16, kv_block_size=BS,
                                       prefill_chunk_size=128, dtype="bfloat16", **over)


def quant_serve_path(torch, smi, main_tokens):
    """Phase quant_serve_path: llama3-8b at full width and depth (random
    weights from seed 0, the main path's), three engines in turn: int8 KV
    pages; int8 weights; both. Each serves the main path's 8 greedy
    requests over 3 arrivals eagerly, from graphs (twice) and traced.
    Gates: the same tokens and retirement order eager and from graphs;
    every request complete and the pool drained; K1 launches layers x
    steps on the float-KV engine and 0 on the int8-KV engines (the int8
    pools take the gather route, JAX's own design for them), by wrapper
    count and in the trace; the last-position logits of a 300-token prompt
    through one paged forward within 5 % of the logit range of the dense
    forward over the weights the engine serves (the int8 leaves
    dequantized), and, for bf16 weights, of the bf16 dense forward; then
    JAX's contract for int8 weights at 2 layers (``int8_weight_contract``).
    At 32 layers of random weights int8 rounding alone moves the logits
    beyond 5 % of the range from the bf16 forward's, so that distance is
    reported, not gated. Reported: where each row's tokens first leave the
    bf16 main path's (``main_tokens``), resident param bytes, block bytes
    against bf16's, peak memory, tokens/s, TTFT, and a decode step's wall
    and device ms by kernel class (after earlier traces: its host times
    carry CUPTI's cost)."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.model_implementations import quantized_param_bytes
    from deepspeed_tpu_torch.inference.v2.model_runner import PagedModelRunner
    from deepspeed_tpu_torch.models import build_model
    model = build_model("llama3-8b")
    cfg = model.cfg
    prompts, eos_uid, eos_id, arrivals, arrival_t = main_workload(torch, cfg.vocab_size)
    ref_prompt = prompts[1][:300]
    dense = None
    bf16_block = 2 * cfg.num_layers * cfg.kv_heads * BS * cfg.dims_per_head * 2
    for name, over in QUANT_ENGINES:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = InferenceEngineV2(model, serving_config(**over), max_seq_len=2048)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if dense is None:       # the bf16 weights of seed 0, before any is quantized
            dense = dense_logits(torch, SimpleNamespace(model=eng.model, params=eng.params,
                                                        device=eng.device),
                                 torch.as_tensor(ref_prompt, device=eng.device).long())
        eager_runner = PagedModelRunner(eng.model, BS, eng.max_blocks_per_seq, eng.device,
                                        cuda_graphs=False)
        runs, (by_class, on_card) = served_runs(torch, eng, eager_runner, arrivals, arrival_t,
                                                max_new_tokens=32)
        for mode in ("eager", "graph_first", "traced"):
            if not same_serves(runs[mode]["got"], runs["graph"]["got"]):
                fail(f"quant_serve_path {name}: the {mode} run's tokens or retirement order "
                     "differ from the graph run's")
        check_budgets(f"quant_serve_path {name}", runs["graph"]["got"], prompts, eos_uid,
                      eos_id, cfg.vocab_size)
        per_step = 0 if eng.kv.quantized else cfg.num_layers
        for mode, r in runs.items():
            if r["launches"] != per_step * r["steps"]:
                fail(f"quant_serve_path {name} ({mode}): {r['launches']} K1 launches, "
                     f"expected {per_step} x {r['steps']} steps")
        if on_card != per_step * runs["traced"]["steps"]:
            fail(f"quant_serve_path {name}: {on_card} K1 kernels on the card in the trace, "
                 f"expected {per_step} x {runs['traced']['steps']}; frames traced short "
                 f"(width, steps, launched, traced): {runs['traced']['trace_short_frames']}")
        if eng.kv.free_blocks != eng.kv.num_blocks - 1 or eng.state.seqs:
            fail(f"quant_serve_path {name}: pool did not drain")
        paged = paged_logits(torch, eng, ref_prompt)
        ids = torch.as_tensor(ref_prompt, device=eng.device).long()
        own = dense_logits(torch, eng, ids) if "weight_dtype" in over else dense
        logit_rows = {ref: logit_gap(torch, paged, want) for ref, want in
                      (("bf16_dense", dense), ("dense_same_weights", own))}
        # the paged path on the card against its dense form over the weights
        # it serves, and, with bf16 weights, against the bf16 dense forward
        within = logit_rows["dense_same_weights"]["within"] and (
            "weight_dtype" in over or logit_rows["bf16_dense"]["within"])
        owned = []
        try:
            args = step_inputs(torch, eng, [99, 1999, 732, 1499, 256, 1023, 1898, 411], 1, 16,
                               torch.Generator().manual_seed(2), owned)
            step = profile_modes(torch, {"decode": lambda: eng.runner.run(
                eng.params, *args, eng.kv.k, eng.kv.v)}, _kernel_class)["decode"]
        finally:
            eng.kv.allocator.free(owned)
        q_bytes, total = quantized_param_bytes(eng.params)
        n_tok = sum(len(t) for _, t in runs["graph"]["got"])
        emit("quant_serve_path", engine=name, model="llama3-8b", config=over,
             layers=cfg.num_layers, requests=len(prompts), tokens=n_tok,
             tokens_identical_graph_eager=True, k1_launches_per_step=per_step,
             k1_kernels_on_card_traced=on_card, kv_route="gather + dequantize (JAX's int8 route)"
             if eng.kv.quantized else "K1",
             first_divergence_from_main_path=divergence_from(main_tokens, runs["graph"]["got"]),
             logits=logit_rows, logits_within=within,
             param_bytes=total, quantized_param_bytes=q_bytes,
             param_bytes_vs_bf16=total / (2 * sum(p.numel() for p in _leaves(
                 model.abstract_params()))),
             block_bytes=eng.kv.block_bytes, block_bytes_vs_bf16=eng.kv.block_bytes / bf16_block,
             by_mode=run_rows(runs, n_tok), traced_device_ms_by_class=by_class,
             decode_step=step, engine_build_s=build_s, card=smi)
        if not within:
            fail(f"quant_serve_path {name}: paged logits beyond 5 % of the range: {logit_rows}")
        del eng, eager_runner, runs
        gc.collect()
        torch.cuda.empty_cache()
    int8_weight_contract(torch, ref_prompt, smi)


def logit_gap(torch, got, want):
    """``got``'s largest distance from ``want``, against 5 % of ``want``'s
    range; both must be finite."""
    err = float((got - want).abs().max())
    span = float(want.max() - want.min())
    return {"max_abs_err": err, "range": span, "tolerance": 0.05 * span,
            "within": bool(torch.isfinite(got).all() and torch.isfinite(want).all())
            and err <= 0.05 * span, "argmax": int(got.argmax()), "ref_argmax": int(want.argmax())}


def int8_weight_contract(torch, prompt, smi):
    """JAX's contract for int8 weights (``tests/test_quantized_serving.py``:
    one forward's logits within 5 % of the float forward's, on its
    2-layer ``tiny``), at llama3-8b's widths and 2 layers: the dense
    forward over int8 weights against the dense forward over bf16 weights
    (random, seed 0). At 32 layers of random weights int8 rounding moves
    the logits further (``quant_serve_path`` reports it)."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference.v2.model_implementations import quantize_params
    from deepspeed_tpu_torch.models import build_model
    model = build_model("llama3-8b", num_layers=2)
    dev = torch.device("cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=model.cfg.act_dtype)
    ids = torch.as_tensor(prompt, device=dev).long()
    bf16 = dense_logits(torch, SimpleNamespace(model=model, params=params, device=dev), ids)
    quantized, _ = quantize_params(params, model.logical_axes())
    int8 = dense_logits(torch, SimpleNamespace(model=model, params=quantized, device=dev), ids)
    gap = logit_gap(torch, int8, bf16)
    emit("int8_weight_contract", model="llama3-8b widths, 2 layers", prompt_tokens=len(prompt),
         **gap, card=smi)
    if not gap["within"]:
        fail(f"int8_weight_contract: int8-weight logits {gap['max_abs_err']} from bf16's, "
             f"> 5% of {gap['range']}")
    del params, quantized
    torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def draft_1b_config():
    """Llama-3.2-1B's published widths (hidden 2048, 16 layers, 32 heads
    over 8 kv heads, head dim 64, FFN 8192, vocab 128256, tied embeddings,
    rope theta 500000, 131072 positions); its llama3 rope scaling is left
    out (the one reduction)."""
    from deepspeed_tpu_torch.models.config import get_config
    return get_config("llama3-8b").replace(
        hidden_size=2048, num_layers=16, num_heads=32, num_kv_heads=8,
        intermediate_size=8192, tie_embeddings=True, rope_theta=500000.0,
        max_seq_len=131072)


def spec_path(torch, smi, main_tokens):
    """Phase spec_path: the llama3-8b target serves the main path's 8
    greedy requests over 3 arrivals with gamma 2, first without a draft
    (graph runs: the baseline), then with (a) a self-draft (its own
    params) and (b) a draft at Llama-3.2-1B's widths (random weights from
    seed 1, so nearly every proposal is rejected), each eagerly, from
    graphs and traced; then ``generate_compiled(speculate=True)`` on (a)
    eagerly and from graphs, and a sampled serve on (a) (eager by rule).
    Gates: the same tokens eager and from graphs; every request at its
    budget or its EOS; both pools drained; accepted <= drafted = gamma x
    verify row-steps; K1 launches = target layers x (wide + verify steps)
    + draft layers x (wide + gamma x verify steps), by wrapper count and in
    the trace; sampled rows complete. Reported: acceptance, tokens per
    target forward, tokens/s, the verify step's wall and event ms beside
    the baseline's decode step, and where each row first leaves the
    baseline's tokens."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.model_runner import PagedModelRunner
    from deepspeed_tpu_torch.models import build_model
    gamma = 2
    model = build_model("llama3-8b")
    cfg = model.cfg
    prompts, eos_uid, eos_id, arrivals, arrival_t = main_workload(torch, cfg.vocab_size)
    eng = InferenceEngineV2(model, serving_config(speculate_gamma=gamma), max_seq_len=2048)
    eager_runner = PagedModelRunner(eng.model, BS, eng.max_blocks_per_seq, eng.device,
                                    cuda_graphs=False)
    base = {}
    for mode in ("graph_first", "graph"):
        base[mode] = serve_counted(torch, eng, arrivals(), time_narrow=mode == "graph",
                                   max_new_tokens=32)
    if not same_serves(base["graph_first"]["got"], base["graph"]["got"]):
        fail("spec_path: the baseline's two graph runs differ")
    base_toks = {u: t.tolist() for u, t in base["graph"]["got"]}
    n_base = sum(len(t) for t in base_toks.values())
    total_launches = 0
    for draft_name in ("self", "llama-3.2-1b"):
        if draft_name == "self":
            eng.attach_draft(eng.model, eng.params)
        else:
            eng.attach_draft(build_model(draft_1b_config()))
        dcfg = eng.draft_model.cfg
        runs, (by_class, on_card) = served_runs(torch, eng, eager_runner, arrivals, arrival_t,
                                                max_new_tokens=32, gamma=gamma)
        for mode in ("eager", "graph_first", "traced"):
            if not same_serves(runs[mode]["got"], runs["graph"]["got"]):
                fail(f"spec_path {draft_name}: the {mode} run's tokens or retirement order "
                     "differ from the graph run's")
        check_budgets(f"spec_path {draft_name}", runs["graph"]["got"], prompts, eos_uid,
                      eos_id, cfg.vocab_size)
        counters = dict(eng.serve_counters)
        for mode, r in runs.items():
            want = (cfg.num_layers * (r["wide_steps"] + r["narrow_steps"])
                    + dcfg.num_layers * (r["wide_steps"] + gamma * r["narrow_steps"]))
            if r["launches"] != want:
                fail(f"spec_path {draft_name} ({mode}): {r['launches']} K1 launches, expected "
                     f"{want} ({r['wide_steps']} wide, {r['narrow_steps']} verify steps)")
        tr = runs["traced"]
        if on_card != tr["launches"]:
            fail(f"spec_path {draft_name}: {on_card} K1 kernels on the card in the trace, "
                 f"expected {tr['launches']}; frames traced short ((width, steps, "
                 f"launched, traced): {tr['trace_short_frames']}")
        drafted, accepted = counters["drafted_tokens"], counters["accepted_draft_tokens"]
        verify = counters["target_forwards"]
        if drafted != gamma * verify or accepted > drafted:
            fail(f"spec_path {draft_name}: drafted {drafted}, accepted {accepted}, "
                 f"verify row-steps {verify}")
        if (eng.kv.free_blocks != eng.kv.num_blocks - 1 or eng.state.seqs
                or eng.draft_kv.allocator.free_blocks != eng.draft_kv.num_blocks):
            fail(f"spec_path {draft_name}: a pool did not drain")
        total_launches += runs["graph"]["launches"]
        n_tok = sum(len(t) for _, t in runs["graph"]["got"])
        extra = {}
        if draft_name == "self":
            extra = spec_calls(torch, eng, eager_runner, prompts, gamma, main_tokens)
        emit("spec_path", draft=draft_name, model="llama3-8b", gamma=gamma,
             draft_config={"layers": dcfg.num_layers, "hidden": dcfg.hidden_size,
                           "heads": dcfg.num_heads, "kv_heads": dcfg.kv_heads,
                           "head_dim": dcfg.dims_per_head, "ffn": dcfg.ffn_size,
                           "vocab": dcfg.vocab_size, "tied": dcfg.tie_embeddings},
             tokens=n_tok, tokens_identical_graph_eager=True, serve_counters=counters,
             acceptance_rate=accepted / drafted if drafted else None,
             tokens_per_target_forward=(verify + accepted) / verify if verify else None,
             k1_kernels_on_card_traced=on_card,
             first_divergence_from_nonspec=divergence_from(base_toks, runs["graph"]["got"]),
             by_mode=run_rows(runs, n_tok), traced_device_ms_by_class=by_class,
             traced_device_ms_a_step=sum(by_class.values()) / tr["steps"],
             trace_short_frames=tr["trace_short_frames"],
             nonspec_graph=run_rows({"graph": base["graph"]}, n_base)["graph"],
             draft_pool_block_bytes=eng.draft_kv.block_bytes, **extra, card=smi)
        del runs
    del eng, eager_runner
    gc.collect()
    torch.cuda.empty_cache()
    return total_launches


def spec_calls(torch, eng, eager_runner, prompts, gamma, main_tokens):
    """``generate_compiled(speculate=True)`` on the 8 prompts (32 new
    tokens) eagerly and from graphs (the same tokens), then a sampled
    serve() of two rows (temperature 0.8, 8 tokens; its steps run eagerly
    by rule): every row at its budget, no capture."""
    uids = sorted(prompts)
    outs, rows = {}, {}
    graph_runner = eng.runner
    for mode, runner in (("eager", eager_runner), ("graph", graph_runner)):
        eng.runner = runner
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = [t.tolist() for t in eng.generate_compiled(
                [prompts[u] for u in uids], max_new_tokens=32, speculate=True, gamma=gamma)]
            rows[mode] = {"s": time.perf_counter() - t0}
        finally:
            eng.runner = graph_runner
        rows[mode]["tokens_per_s"] = sum(len(t) for t in outs[mode]) / rows[mode]["s"]
    if outs["eager"] != outs["graph"] or any(len(t) != 32 for t in outs["graph"]):
        fail("spec_path: generate_compiled(speculate=True) differs eager and from graphs, or "
             "a row fell short of 32 tokens")
    sampled = serve_counted(torch, eng, iter([[(0, prompts[0], 8, 0.8), (6, prompts[6], 8, 0.8)]]),
                            max_new_tokens=8, gamma=gamma, rng=1)
    if sampled["captures"] or sorted(len(t) for _, t in sampled["got"]) != [8, 8]:
        fail(f"spec_path: sampled serve() made {sampled['captures']} captures, tokens "
             f"{[len(t) for _, t in sampled['got']]}")
    return {"generate_compiled": rows, "generate_compiled_equal_eager_graph": True,
            "generate_compiled_vs_nonspec_main_path": {
                u: first_divergence(t, main_tokens[u]) for u, t in zip(uids, outs["graph"])
                if u in main_tokens},
            "sampled_run": {"steps": sampled["steps"], "captures": sampled["captures"],
                            "serve_s": sampled["serve_s"], "tokens": [len(t) for _, t in
                                                                      sampled["got"]]}}


# ------------------------------------------------------------ training slice

# --------------------------------------------------- KV hierarchy, scheduler

HIER_PREFIX = 1536                # the shared prefix: 12 pages of 128
HIER_SUFFIX = (64, 200, 97, 150, 181, 73, 128, 111)    # the 8 rows' own tokens


def hier_workload(torch, vocab):
    """8 prompts of a 1536-token shared prefix and 64-200 tokens of their
    own (seed 15), a ninth, never served, for the logit check, and 1536
    tokens of another prompt for its control. Row 0 arrives at boundary
    0; the seven others at boundary 2, after row 0's prefill (13 chunks
    over two 8-step frames) has committed and its 12 prefix pages were
    published."""
    g = torch.Generator().manual_seed(15)
    shared = torch.randint(0, vocab, (HIER_PREFIX,), generator=g)
    prompts = {u: torch.cat([shared, torch.randint(0, vocab, (n,), generator=g)]).numpy()
               for u, n in enumerate(HIER_SUFFIX)}
    probe = torch.cat([shared, torch.randint(0, vocab, (150,), generator=g)]).numpy()
    foreign = torch.randint(0, vocab, (HIER_PREFIX,), generator=g).numpy()
    arrival_t = {}

    def arrivals():
        arrival_t[0] = time.perf_counter()
        yield [(0, prompts[0])]
        yield []
        now = time.perf_counter()
        for u in range(1, 8):
            arrival_t[u] = now
        yield [(u, prompts[u]) for u in range(1, 8)]

    return prompts, probe, foreign, arrivals, arrival_t


def resumed_logits(torch, eng, prompt, foreign=None):
    """Last-position logits of ``prompt`` through the paged forward that
    resumes at the prefix cache's watermark: ``_prefix_map`` maps the
    published pages read-only into a fresh block list, as admission does,
    and only the chunks past the watermark run (``runner.run``), reading
    the shared pages through the block table. With ``foreign`` (the tokens
    of another prompt, chunk-aligned) nothing is mapped: those tokens are
    prefilled into the first pages, and ``prompt`` resumes at their length
    over them. Returns (logits, watermark, pages mapped)."""
    from deepspeed_tpu_torch.inference.v2.ragged_manager import DSSequenceDescriptor
    kv, dev = eng.kv, eng.device
    n, chunk = len(prompt), eng._config.prefill_chunk_size
    seq = DSSequenceDescriptor(uid=-2)
    cached0 = eng._prefix_map(seq, prompt) if foreign is None else len(foreign)
    mapped = len(seq.blocks)
    try:
        seq.blocks += kv.allocator.allocate(kv.blocks_for(n) - len(seq.blocks))
        table = torch.zeros((1, eng.max_blocks_per_seq), dtype=torch.int32, device=dev)
        table[0, :len(seq.blocks)] = torch.tensor(seq.blocks, dtype=torch.int32)

        def run(tokens, start, end):
            ids = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
            logits = None
            for c0 in range(start, end, chunk):
                w = min(chunk, end - c0)
                cids = torch.zeros((1, chunk), dtype=torch.int32, device=dev)
                cids[0, :w] = ids[c0:c0 + w]
                pos = torch.full((1, chunk), -1, dtype=torch.int32, device=dev)
                pos[0, :w] = torch.arange(c0, c0 + w, dtype=torch.int32, device=dev)
                valid = torch.tensor([w], dtype=torch.int32, device=dev)
                logits, _, _ = eng.runner.run(eng.params, cids, pos, table, valid, kv.k, kv.v)
            return logits

        if foreign is not None:
            run(foreign, 0, cached0)
        logits = run(prompt, cached0, n)
    finally:
        kv.allocator.free(seq.blocks)
    return logits[0], cached0, mapped


def pool_clean(eng, cached=0):
    """Blocks in use are the cache's (``cached``) and the trash block's, and
    no request is tracked."""
    return eng.kv.num_blocks - eng.kv.free_blocks == cached + 1 and not eng.state.seqs \
        and not eng._ledger


def hier_path(torch, smi):
    """Phase hier_path: llama3-8b at full width and depth (random weights
    from seed 0), the main path's serving config with ``prefix_cache=True``
    and CUDA graphs, serves ``hier_workload`` (32 greedy new tokens each):
    once to capture, then with the cache detached (cold), with it (the
    seven followers map row 0's 12 published pages and prefill from token
    1536), and with it again traced frame by frame. Gates: every request
    completes its budget; K1 launches = layers x steps in every run, by
    wrapper and in the trace; after each cache run the blocks in use are
    exactly the cache's and, after ``clear()``, every refcount is 0 and the
    pool drained; the frames' own count of prefilled tokens is 7 x 1536
    lower with the cache than without, and the wide steps are those the
    workload gives each run; one follower's last-position logits through
    the paged forward that resumes at the mapped watermark over the shared
    pages within 5 % of their range of the dense forward over its whole
    prompt (a follower never served: its watermark is the 1536 shared
    tokens), and the same resume over another prompt's 12 pages outside
    that limit.
    Reported: TTFT p50 / p90 of the seven, tokens/s, prefill steps, hit
    tokens and pages, and where the cache run's tokens leave the cold
    run's (bf16 batch composition can flip near ties: not gated)."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    model = build_model("llama3-8b")
    cfg = model.cfg
    eng = InferenceEngineV2(model, serving_config(prefix_cache=True), max_seq_len=2048)
    prompts, probe, foreign, arrivals, arrival_t = hier_workload(torch, cfg.vocab_size)
    cache = eng.prefix_cache
    runs = {}
    for mode, on, trace in (("capture", False, False), ("cold", False, False),
                            ("cache", True, False), ("cache_traced", True, True)):
        eng.prefix_cache = cache if on else None
        runs[mode] = r = serve_counted(torch, eng, arrivals(), trace=trace, max_new_tokens=32)
        r["counters"] = dict(eng.telemetry.counters)
        r["serve_stats"] = {k: eng.serve_stats[k] for k in ("frames", "frame_steps_hist")}
        r["ttft_s"] = sorted(r["first_tok"][u] - arrival_t[u] for u in range(1, 8))
        check_budgets(f"hier_path ({mode})", r["got"], prompts, None, None, cfg.vocab_size)
        if r["launches"] != cfg.num_layers * r["steps"]:
            fail(f"hier_path ({mode}): {r['launches']} K1 launches, expected "
                 f"{cfg.num_layers} layers x {r['steps']} steps")
        if not pool_clean(eng, cache.resident_blocks() if on else 0):
            fail(f"hier_path ({mode}): {eng.kv.num_blocks - eng.kv.free_blocks} blocks in "
                 f"use, the cache holds {cache.resident_blocks() if on else 0}")
        if on and mode == "cache":
            logits, cached0, mapped = resumed_logits(torch, eng, probe)
            dense = dense_logits(torch, eng, torch.as_tensor(probe, device=eng.device).long())
            err, span = float((logits - dense).abs().max()), float(dense.max() - dense.min())
            ok = bool(torch.isfinite(logits).all()) and err <= 0.05 * span \
                and cached0 == HIER_PREFIX
            # the control: the same resume over another prompt's 12 pages
            # must miss the limit, or the limit cannot tell a wrong mapping
            flogits, _, _ = resumed_logits(torch, eng, probe, foreign=foreign)
            ferr = float((flogits - dense).abs().max())
            ref = dict(prompt_tokens=len(probe), watermark=cached0, pages_mapped=mapped,
                       max_abs_logit_err=err, logit_range=span, within=ok,
                       control_foreign_pages_err=ferr, control_missed=ferr > 0.05 * span)
            if not ok:
                fail(f"hier_path: resumed paged logits {err} from the dense forward's "
                     f"(range {span}), watermark {cached0}")
            if not ref["control_missed"]:
                fail(f"hier_path: resumed over another prompt's pages, the logits are {ferr} "
                     f"from the dense forward's (range {span}): within the 5 % limit")
        if on:
            cache.clear()
            if any(eng.kv.allocator.refcount(b) for b in range(1, eng.kv.num_blocks)) \
                    or not pool_clean(eng):
                fail("hier_path: refcounts or the pool not back to zero after clear()")
    tr = runs["cache_traced"]
    if tr["k1_on_card"] != tr["launches"]:
        fail(f"hier_path: {tr['k1_on_card']} K1 kernels on the card in the trace, expected "
             f"{tr['launches']}; frames traced short: {tr['trace_short_frames']}")
    c = runs["cache"]["counters"]
    if c["prefix_hits"] < 7 or c["prefix_hit_tokens"] < 7 * HIER_PREFIX:
        fail(f"hier_path: {c['prefix_hits']} hits for {c['prefix_hit_tokens']} tokens, "
             f"expected 7 of {HIER_PREFIX}")
    # the watermark reached the captured steps' static buffers: the frames'
    # own count of the tokens they prefilled drops by the seven mapped
    # prefixes, and the wide steps by the chunks skipped (row 0 prefills
    # alone over whole frames; the followers then take as many whole
    # frames as the longest of them has chunks left)
    skipped = runs["cold"]["prefill_tokens"] - runs["cache"]["prefill_tokens"]
    chunk, fs = eng._config.prefill_chunk_size, eng._config.frame_steps

    def wide(chunks):
        return fs * math.ceil(chunks / fs)

    row0 = wide(math.ceil(len(prompts[0]) / chunk))
    want_wide = {"cold": row0 + wide(max(math.ceil(len(prompts[u]) / chunk)
                                         for u in range(1, 8))),
                 "cache": row0 + wide(max(math.ceil((len(prompts[u]) - HIER_PREFIX) / chunk)
                                          for u in range(1, 8)))}
    got_wide = {m: runs[m]["wide_steps"] for m in want_wide}
    if skipped != 7 * HIER_PREFIX or got_wide != want_wide:
        fail(f"hier_path: the cache run prefilled {skipped} tokens fewer than the cold run "
             f"(expected 7 x {HIER_PREFIX}); wide steps {got_wide}, expected {want_wide}")
    n_tok = sum(len(t) for _, t in runs["cache"]["got"])
    rows = {}
    for mode, r in runs.items():
        t = r["ttft_s"]
        rows[mode] = {"serve_s": r["serve_s"], "tokens_per_s": n_tok / r["serve_s"],
                      "ttft_followers_p50_s": statistics.median(t),
                      "ttft_followers_p90_s": t[math.ceil(0.9 * len(t)) - 1],
                      "frames": r["frames"], "prefill_steps": r["wide_steps"],
                      "decode_steps": r["narrow_steps"], "prefill_tokens": r["prefill_tokens"],
                      "paged_attention_launches": r["launches"], "captures": r["captures"],
                      "prefix_hits": r["counters"]["prefix_hits"],
                      "prefix_hit_tokens": r["counters"]["prefix_hit_tokens"],
                      "prefix_hit_pages": r["counters"]["prefix_hit_tokens"] // BS,
                      "prefix_pages_published": r["counters"]["prefix_blocks_published"],
                      "serve_stats": r["serve_stats"], "peak_memory_gb": r["peak_memory_gb"]}
    emit("hier_path", model="llama3-8b", layers=cfg.num_layers, requests=8,
         shared_prefix_tokens=HIER_PREFIX, suffix_tokens=list(HIER_SUFFIX), tokens=n_tok,
         by_mode=rows, prefill_tokens_skipped=skipped, wide_steps_expected=want_wide,
         k1_kernels_on_card_traced=tr["k1_on_card"],
         traced_device_ms_by_class=tr["device_ms_by_class"], reference=ref,
         first_divergence_cache_vs_cold=divergence_from(
             {u: t.tolist() for u, t in runs["cold"]["got"]}, runs["cache"]["got"]),
         card=smi)
    launches = runs["cache"]["launches"]
    del eng, runs, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


SCHED_BATCH, SCHED_INTERACTIVE = 16, 4


def sched_workload(torch, vocab):
    """16 batch requests (512-token prompts, budget 128) fill the 16 slots at
    boundary 0; 4 interactive ones (256-token prompts, budget 32, slo_ms
    2000) arrive at boundary 3 (seed 16)."""
    g = torch.Generator().manual_seed(16)
    batch = {u: torch.randint(0, vocab, (512,), generator=g).numpy()
             for u in range(SCHED_BATCH)}
    inter = {100 + i: torch.randint(0, vocab, (256,), generator=g).numpy()
             for i in range(SCHED_INTERACTIVE)}
    arrival_t = {}

    def arrivals():
        now = time.perf_counter()
        arrival_t.update(dict.fromkeys(batch, now))
        yield [{"uid": u, "tokens": p, "max_new_tokens": 128, "priority": "batch"}
               for u, p in batch.items()]
        yield []
        yield []
        now = time.perf_counter()
        arrival_t.update(dict.fromkeys(inter, now))
        yield [{"uid": u, "tokens": p, "max_new_tokens": 32, "priority": "interactive",
                "slo_ms": 2000.0} for u, p in inter.items()]

    return batch, inter, arrivals, arrival_t


def watch_tier(torch, tier, check_pages):
    """Time the tier's page traffic: ``put_request`` (the victim's pages
    read to the host, one copy a pool, and their writes queued on the
    aio engine), every ``drain`` by mode (the wait for the writes and the
    commit), and ``restore_request`` (the files read and the pages
    scattered onto the card). ``check_pages`` also keeps each victim's
    pages as read before its blocks are freed and compares them, byte for
    byte, with its pages read back after the restore. Returns the stats
    dict the wrappers fill."""
    st = {"put_s": 0.0, "restore_s": 0.0, "drain_s": {"overlapped": 0.0, "blocking": 0.0},
          "pages_checked": 0, "mismatched": []}
    saved = {}
    put, restore, drain = tier.put_request, tier.restore_request, tier.drain

    def pages_bytes(kv, blocks):
        return [bytes(p.contiguous().view(torch.uint8).numpy()) for p in kv.read_pages(blocks)]

    def put_request(uid, tokens, kv, blocks, **kw):
        if check_pages:
            saved[uid] = pages_bytes(kv, blocks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        put(uid, tokens, kv, blocks, **kw)
        st["put_s"] += time.perf_counter() - t0

    def restore_request(uid, kv, dst_blocks, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore(uid, kv, dst_blocks, **kw)
        torch.cuda.synchronize()
        st["restore_s"] += time.perf_counter() - t0
        if check_pages:
            st["pages_checked"] += len(dst_blocks)
            if pages_bytes(kv, dst_blocks) != saved.pop(uid):
                st["mismatched"].append(uid)

    def drain_(blocking=True):
        t0 = time.perf_counter()
        try:
            return drain(blocking=blocking)
        finally:
            st["drain_s"]["blocking" if blocking else "overlapped"] += time.perf_counter() - t0

    tier.put_request, tier.restore_request, tier.drain = put_request, restore_request, drain_
    return st


def sched_path(torch, smi):
    """Phase sched_path: llama3-8b at full width and depth (random weights
    from seed 0), the main path's serving config with a ``kv_swap_dir`` in
    a temporary directory and CUDA graphs, serves ``sched_workload``
    through ``serve(scheduler=RequestScheduler())``: each interactive
    arrival finds the table full and preempts a batch row at a frame
    boundary, whose committed pages go to host files through the port's
    aio engine and come back when it is re-admitted. Runs: swap-in with
    the victims' pages checked (the first run, capturing), re-prefill
    (``kv_swap_preempt=False``), swap-in timed. Gates: every budget
    completes; each victim's pages read back after its swap-in are
    byte-identical to its pages read before eviction; the tier holds no
    record after serve and the pool drains; K1 launches = layers x steps.
    Reported: preemptions, interactive against batch TTFT, pages and GB/s
    swapped out and in, overlapped against blocking commits and their
    wait, and the re-prefill run beside the swap runs."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.scheduler import RequestScheduler
    from deepspeed_tpu_torch.models import build_model
    model = build_model("llama3-8b")
    cfg = model.cfg
    swap_dir = tempfile.mkdtemp(prefix="kv_swap_")
    try:
        eng = InferenceEngineV2(model, serving_config(kv_swap_dir=swap_dir), max_seq_len=2048)
        batch, inter, arrivals, arrival_t = sched_workload(torch, cfg.vocab_size)
        tier, runs, budgets = eng.kv_swap, {}, {**dict.fromkeys(batch, 128),
                                                **dict.fromkeys(inter, 32)}
        for mode, swap, check in (("swap_checked", True, True), ("reprefill", False, False),
                                  ("swap", True, False)):
            eng._config.kv_swap_preempt = swap
            st = watch_tier(torch, tier, check)
            sched = RequestScheduler()
            runs[mode] = r = serve_counted(torch, eng, arrivals(), scheduler=sched)
            del tier.put_request, tier.restore_request, tier.drain
            c = dict(eng.telemetry.counters)
            got = dict(r["got"])
            if {u: len(t) for u, t in got.items()} != budgets or any(
                    not ((t >= 0) & (t < cfg.vocab_size)).all() for t in got.values()):
                fail(f"sched_path ({mode}): budgets {({u: len(t) for u, t in got.items()})}")
            if r["launches"] != cfg.num_layers * r["steps"]:
                fail(f"sched_path ({mode}): {r['launches']} K1 launches, expected "
                     f"{cfg.num_layers} layers x {r['steps']} steps")
            if tier._index["requests"] or tier.pending_commits() or not pool_clean(eng):
                fail(f"sched_path ({mode}): records left in the tier "
                     f"({sorted(tier._index['requests'])}) or the pool not drained")
            if sched.summary["preempted"] < 1:
                fail(f"sched_path ({mode}): no preemption")
            if swap and (c["kv_swap_out_blocks"] != c["kv_swap_in_blocks"]
                         or not c["kv_swap_in_blocks"]):
                fail(f"sched_path ({mode}): {c['kv_swap_out_blocks']} pages out, "
                     f"{c['kv_swap_in_blocks']} in")
            if check and (st["mismatched"] or st["pages_checked"] != c["kv_swap_in_blocks"]):
                fail(f"sched_path: victims {st['mismatched']} came back with other page "
                     f"bytes ({st['pages_checked']} pages checked)")
            ttft = {u: r["first_tok"][u] - arrival_t[u] for u in got}
            gb_out = c["kv_swap_out_blocks"] * eng.kv.block_bytes / 1e9
            drain_s = st["drain_s"]["overlapped"] + st["drain_s"]["blocking"]
            r["row"] = {
                "serve_s": r["serve_s"],
                "tokens_per_s": sum(len(t) for t in got.values()) / r["serve_s"],
                "preempted": sched.summary["preempted"],
                "ttft_interactive_s": sorted(ttft[u] for u in inter),
                "ttft_batch_p50_s": statistics.median(ttft[u] for u in batch),
                "ttft_batch_max_s": max(ttft[u] for u in batch),
                "frames": r["frames"], "prefill_steps": r["wide_steps"],
                "decode_steps": r["narrow_steps"], "prefill_tokens": r["prefill_tokens"],
                "paged_attention_launches": r["launches"], "captures": r["captures"],
                "swap_out_pages": c["kv_swap_out_blocks"], "swap_in_pages": c["kv_swap_in_blocks"],
                "swap_gb": gb_out, "page_bytes": eng.kv.block_bytes,
                "swap_out_s": st["put_s"], "commit_wait_s": st["drain_s"],
                "swap_in_s": st["restore_s"],
                "swap_out_gb_per_s": gb_out / st["put_s"] if st["put_s"] else None,
                "swap_out_through_commit_gb_per_s": (gb_out / (st["put_s"] + drain_s)
                                                     if st["put_s"] else None),
                "swap_in_gb_per_s": gb_out / st["restore_s"] if st["restore_s"] else None,
                "commits_overlapped": c["kv_swap_commits_overlapped"],
                "commits_blocking": c["kv_swap_commits_blocking"],
                "pages_checked": st["pages_checked"], "peak_memory_gb": r["peak_memory_gb"]}
        emit("sched_path", model="llama3-8b", layers=cfg.num_layers, batch=SCHED_BATCH,
             interactive=SCHED_INTERACTIVE, by_mode={m: r["row"] for m, r in runs.items()},
             swapped_pages_byte_identical=True,
             first_divergence_swap_vs_reprefill=divergence_from(
                 {u: t.tolist() for u, t in runs["reprefill"]["got"]}, runs["swap"]["got"]),
             card=smi)
        launches = runs["swap"]["launches"]
        del eng, runs, tier
    finally:
        shutil.rmtree(swap_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


FAULT_POISON_UID, FAULT_DEADLINE_UID, FAULT_CANCEL_UID = 1, 6, 7
FAULT_BOUNDARY = 3        # the first width-1 frame of the main workload
WATCHDOG_X = 3.0          # the watchdog: this times the longest replayed frame


def timed_frames(eng):
    """Wrap ``eng._run_frame_resilient`` (the dispatch with its retries,
    the frame's replays and its one device-to-host copy) to record, per
    frame: its index, its start (``time.perf_counter``), its host ms and
    whether it captured a graph. Returns the list it fills; ``del
    eng._run_frame_resilient`` unwraps."""
    rows, inner, graphs = [], eng._run_frame_resilient, eng.runner.graphs

    def timed(slots, width, steps, greedy, draft, faults, frame):
        c0, t0 = graphs.captures, time.perf_counter()
        try:
            return inner(slots, width, steps, greedy, draft, faults, frame)
        finally:
            rows.append({"frame": frame, "width": width, "start": t0,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "captured": graphs.captures != c0})

    eng._run_frame_resilient = timed
    return rows


def fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t, deadline_ms=None,
                   cancel_at=None):
    """The main workload's arrivals (``main_workload``), with ``deadline_ms``
    on ``FAULT_DEADLINE_UID`` and ``eng.cancel_request(FAULT_CANCEL_UID)``
    at the poll of boundary ``cancel_at``; empty polls until then."""
    schedule = {0: [0, 1, 2], 1: [3, 4, 5], 2: [6, 7]}
    for k in range(max(3, (cancel_at or 0) + 1)):
        if k == cancel_at and not eng.cancel_request(FAULT_CANCEL_UID):
            fail(f"fault_path: uid {FAULT_CANCEL_UID} was not in flight at boundary {k}")
        batch = []
        for u in schedule.get(k, []):
            arrival_t[u] = time.perf_counter()
            item = {"uid": u, "tokens": prompts[u]}
            if u == eos_uid:
                item["eos_token_id"] = eos_id
            if u == FAULT_DEADLINE_UID and deadline_ms is not None:
                item["deadline_ms"] = deadline_ms
            batch.append(item)
        yield batch


def fault_path(torch, smi):
    """Phase fault_path: llama3-8b at full width and depth (random weights
    from seed 0), the main path's serving config (16 slots, CUDA graphs,
    no retry backoff) on the main path's 8 requests, 32 greedy tokens each;
    a second engine with ``nonfinite_policy="repair"`` over the first
    engine's weights. Runs, each through ``serve_counted``:
      1. warm: fault-free, capturing; its tokens are ``base``; then again
         from the graphs alone (the same tokens), and the watchdog is set to
         WATCHDOG_X times that run's longest frame;
      2. transient: a ``dispatch_exception`` twice at a width-1 boundary
         and a ``slow_frame`` past the watchdog at the next: no capture,
         tokens bit-identical to ``base``, 2 retries and 1 slow frame;
      3. fault: ``poison_row`` on a live row at the first width-1
         boundary, ``deadline_ms`` on one arrival (expiring between
         boundaries 3 and 5 by run 1's frame times) and
         ``cancel_request`` on another at boundary 5: each retired with
         its kind and never yielded, the poisoned row's partial a prefix
         of its ``base`` tokens, every other row at its budget or EOS;
      4. crash: a ``dispatch_exception`` past the retries at boundary 4
         raises ``FrameDispatchError`` with ``last_crash_snapshot``, whose
         committed tokens are prefixes of ``base``; ``serve(resume_from=)``
         on the same engine completes every row, ``recoveries`` counts the
         snapshot's rows, and a resumed row's last-position logits through
         the paged forward over its re-prefilled stream lie within 5 % of
         the dense forward's range;
      5. repair: a one-boundary blip (the row completes its budget), then
         limit + 1 consecutive poisoned boundaries (the row escalates to
         ``poison_row``).
    Every run: K1 launches = layers x steps, the pool drained. Reported:
    where the rows of runs 3-5 leave ``base`` (not gated: a frozen row
    changes K1's split and a re-prefill the bf16 rounding), the retried
    frame's host ms beside the run's other width-1 frames, the slow frame's,
    ``last_recovery_ms``, the resumed run's tokens/s beside ``base`` and
    the repair engine's captures."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.faults import FaultInjector
    from deepspeed_tpu_torch.models import build_model
    model = build_model("llama3-8b")
    cfg = model.cfg
    eng = InferenceEngineV2(model, serving_config(frame_retry_backoff_s=0.0), max_seq_len=2048)
    prompts, eos_uid, eos_id, _, arrival_t = main_workload(torch, cfg.vocab_size)
    rows_out = {}

    def served(name, e, arrivals, faults=None, **kw):
        """One run: serve_counted with the frames timed; K1 = layers x
        steps and the pool drained, or the phase fails."""
        frames = timed_frames(e)
        inj = None if faults is None else FaultInjector(faults)
        try:
            r = serve_counted(torch, e, arrivals, max_new_tokens=32, faults=inj, **kw)
        finally:
            del e._run_frame_resilient
        if r["launches"] != cfg.num_layers * r["steps"]:
            fail(f"fault_path ({name}): {r['launches']} K1 launches, expected "
                 f"{cfg.num_layers} layers x {r['steps']} steps")
        if not pool_clean(e):
            fail(f"fault_path ({name}): the pool did not drain")
        r["frame_rows"], r["fired"] = frames, inj.fired if inj is not None else []
        r["faults"] = [(f.uid, f.kind, f.frame) for f in e.fault_log]
        r["partials"] = {f.uid: f.partial or [] for f in e.fault_log if f.uid >= 0}
        r["counters"] = dict(e.telemetry.counters)
        e.fault_log.clear()
        n_tok = sum(len(t) for _, t in r["got"])
        rows_out[name] = {"serve_s": r["serve_s"], "tokens": n_tok,
                          "tokens_per_s": n_tok / r["serve_s"], "frames": r["frames"],
                          "steps": r["steps"], "paged_attention_launches": r["launches"],
                          "captures": r["captures"], "faults": r["faults"]}
        return r

    def never_yielded(name, r, kinds):
        got = dict(r["got"])
        for uid, kind in kinds.items():
            if uid in got or (uid, kind) not in [(u, k) for u, k, _ in r["faults"]]:
                fail(f"fault_path ({name}): uid {uid} not retired as {kind} "
                     f"(faults {r['faults']}, yielded {sorted(got)})")

    # 1. warm, fault-free: the first run captures, the second replays
    warm = served("warm", eng, fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t))
    check_budgets("fault_path (warm)", warm["got"], prompts, eos_uid, eos_id, cfg.vocab_size)
    again = served("base", eng, fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t))
    if not same_serves(again["got"], warm["got"]) or again["captures"]:
        fail(f"fault_path (base): tokens differ from the capturing run's, or "
             f"{again['captures']} captures")
    base = {u: t.tolist() for u, t in warm["got"]}
    watchdog_ms = WATCHDOG_X * max(f["ms"] for f in again["frame_rows"])
    if [f["width"] for f in warm["frame_rows"][FAULT_BOUNDARY - 1:FAULT_BOUNDARY + 3]] \
            != [128, 1, 1, 1]:
        fail(f"fault_path: boundary {FAULT_BOUNDARY} is not the first width-1 frame "
             f"({[(f['frame'], f['width']) for f in warm['frame_rows']]})")

    # 2. transient: two retries and one slow frame, the same frames
    eng._config.watchdog_frame_ms = watchdog_ms
    try:
        tr = served("transient", eng, fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t),
                    faults=[{"kind": "dispatch_exception", "frame": FAULT_BOUNDARY + 1,
                             "times": 2},
                            {"kind": "slow_frame", "frame": FAULT_BOUNDARY + 2,
                             "seconds": 2 * watchdog_ms / 1e3}])
    finally:
        eng._config.watchdog_frame_ms = None
    if not same_serves(tr["got"], warm["got"]) or tr["captures"]:
        fail(f"fault_path (transient): tokens differ from base, or {tr['captures']} captures")
    c = tr["counters"]
    if c["frame_retries"] != 2 or c["slow_frames"] != 1:
        fail(f"fault_path (transient): {c['frame_retries']} retries, {c['slow_frames']} "
             "slow frames; expected 2 and 1")
    tr_ms = {f["frame"]: f["ms"] for f in tr["frame_rows"]}
    # the deadline: from the row's arrival to halfway between boundaries 3
    # and 5 of this run (no capture in it; its stall comes after boundary 5)
    starts = {f["frame"]: f["start"] for f in tr["frame_rows"]}
    deadline_ms = ((starts[FAULT_BOUNDARY] + starts[FAULT_BOUNDARY + 2]) / 2
                   - arrival_t[FAULT_DEADLINE_UID]) * 1e3
    narrow_ms = [f["ms"] for f in tr["frame_rows"] if f["width"] == 1
                 and f["frame"] not in (FAULT_BOUNDARY + 1, FAULT_BOUNDARY + 2)]

    # 3. poison, deadline, cancel
    fr = served("fault", eng, fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t,
                                             deadline_ms=deadline_ms,
                                             cancel_at=FAULT_BOUNDARY + 2),
                faults=[{"kind": "poison_row", "frame": FAULT_BOUNDARY,
                         "uid": FAULT_POISON_UID}])
    never_yielded("fault", fr, {FAULT_POISON_UID: "poison_row",
                                FAULT_DEADLINE_UID: "deadline_expired",
                                FAULT_CANCEL_UID: "cancelled"})
    partial = fr["partials"][FAULT_POISON_UID]
    if partial != base[FAULT_POISON_UID][:len(partial)]:
        fail(f"fault_path (fault): the poisoned row's partial {partial} is no prefix of "
             "its base tokens")
    rest = {u: p for u, p in prompts.items()
            if u not in (FAULT_POISON_UID, FAULT_DEADLINE_UID, FAULT_CANCEL_UID)}
    check_budgets("fault_path (fault)", fr["got"], rest, eos_uid, eos_id, cfg.vocab_size)

    # 4. crash at boundary 4, then resume on the same engine
    crash = served("crash", eng, fault_arrivals(eng, prompts, eos_uid, eos_id, arrival_t),
                   faults=[{"kind": "dispatch_exception", "frame": FAULT_BOUNDARY + 1,
                            "times": 10}], crash_ok=True)
    snap = eng.last_crash_snapshot
    if crash["error"] is None or snap is None or not snap["requests"]:
        fail("fault_path (crash): no FrameDispatchError, or no snapshot of in-flight rows")
    for r in snap["requests"]:
        if r["generated"] != base[r["uid"]][:len(r["generated"])]:
            fail(f"fault_path (crash): uid {r['uid']}'s committed tokens are no prefix "
                 "of its base tokens")
    resumed = served("resume", eng, iter([[]]), resume_from=snap)
    done = dict(crash["got"]) | dict(resumed["got"])
    check_budgets("fault_path (resume)", list(done.items()), prompts, eos_uid, eos_id,
                  cfg.vocab_size)
    if resumed["counters"]["recoveries"] != len(snap["requests"]):
        fail(f"fault_path (resume): {resumed['counters']['recoveries']} recoveries of "
             f"{len(snap['requests'])} rows")
    row = max(snap["requests"], key=lambda r: len(r["generated"]))
    stream = list(row["prompt"]) + row["generated"]
    paged = paged_logits(torch, eng, stream)
    dense = dense_logits(torch, eng, torch.as_tensor(stream, device=eng.device).long())
    logit_err, span = float((paged - dense).abs().max()), float(dense.max() - dense.min())
    if not (torch.isfinite(paged).all() and logit_err <= 0.05 * span):
        fail(f"fault_path (resume): uid {row['uid']}'s resumed logits {logit_err} from the "
             f"dense forward, over 5 % of its range {span}")
    recovery_ms = eng.telemetry.gauges["last_recovery_ms"]

    # 5. repair: a blip, then a persistent fault
    rep = InferenceEngineV2(model, serving_config(frame_retry_backoff_s=0.0,
                                                  nonfinite_policy="repair"),
                            params=eng.params, max_seq_len=2048)
    limit = rep._config.nonfinite_repair_limit
    blip = served("repair_blip", rep, fault_arrivals(rep, prompts, eos_uid, eos_id, arrival_t),
                  faults=[{"kind": "poison_row", "frame": FAULT_BOUNDARY,
                           "uid": FAULT_POISON_UID}])
    check_budgets("fault_path (repair_blip)", blip["got"], prompts, eos_uid, eos_id,
                  cfg.vocab_size)
    if [k for u, k, _ in blip["faults"]] != ["nonfinite_repaired"]:
        fail(f"fault_path (repair_blip): faults {blip['faults']}")
    persist = served("repair_persistent", rep,
                     fault_arrivals(rep, prompts, eos_uid, eos_id, arrival_t),
                     faults=[{"kind": "poison_row", "frame": FAULT_BOUNDARY + i,
                              "uid": FAULT_POISON_UID} for i in range(limit + 1)])
    never_yielded("repair_persistent", persist, {FAULT_POISON_UID: "poison_row"})
    if [k for u, k, _ in persist["faults"]] != ["nonfinite_repaired"] * limit + ["poison_row"]:
        fail(f"fault_path (repair_persistent): faults {persist['faults']}")
    repair_keys = [k for k in rep.runner.graphs.keys() if k[0] == "frame"]
    if not repair_keys or not all(k[3] is True for k in repair_keys):
        fail(f"fault_path: the repair engine's frame keys {repair_keys}")

    emit("fault_path", model="llama3-8b", layers=cfg.num_layers, requests=len(prompts),
         watchdog_frame_ms=watchdog_ms, longest_replayed_frame_ms=watchdog_ms / WATCHDOG_X,
         retried_frame_ms=tr_ms.get(FAULT_BOUNDARY + 1),
         slow_frame_ms=tr_ms.get(FAULT_BOUNDARY + 2),
         other_narrow_frame_ms_median=statistics.median(narrow_ms) if narrow_ms else None,
         deadline_ms=deadline_ms, poisoned_partial_tokens=len(partial),
         snapshot_rows=len(snap["requests"]),
         last_recovery_ms=recovery_ms, resumed_row=row["uid"],
         resumed_row_committed=len(row["generated"]), resumed_logit_err=logit_err,
         resumed_logit_range=span,
         tokens_per_s={"base": rows_out["base"]["tokens_per_s"],
                       "resumed": rows_out["resume"]["tokens_per_s"]},
         repair_captures=blip["captures"], repair_keys=len(repair_keys),
         first_divergence_from_base={
             name: divergence_from(base, r["got"])
             for name, r in (("fault", fr), ("resume", resumed), ("repair_blip", blip),
                             ("repair_persistent", persist))},
         by_run=rows_out, card=smi)
    launches = sum(r["paged_attention_launches"] for r in rows_out.values())
    del eng, rep
    gc.collect()
    torch.cuda.empty_cache()
    return launches


FLASH_SOURCE = "deepspeed_tpu_torch/ops/csrc/flash_attention.cu"
ADAM_SOURCE = "deepspeed_tpu_torch/ops/csrc/fused_adam.cu"
FLASH_REPLACES = {"flash_attention_fwd": "deepspeed_tpu/ops/pallas/flash_attention.py:64",
                  "flash_attention_dq": "deepspeed_tpu/ops/pallas/flash_attention.py:159",
                  "flash_attention_dkv": "deepspeed_tpu/ops/pallas/flash_attention.py:211"}
ADAM_REPLACES = "deepspeed_tpu/ops/pallas/fused_adam.py:22"
TRAIN_MODEL = "gpt2-xl"
TRAIN_SEQ, TRAIN_MICRO, TRAIN_BATCH = 1024, 8, 16
FRO_TOL = 1e-2             # relative Frobenius error of each flash output
# f32 K10 vs the plain version, per buffer (p, m, v) and scaled to that
# buffer's change in the step: |got - plain| <= ADAM_REL |plain - before|
# + ADAM_FLOOR max |plain - before|. A kernel that leaves a buffer as it
# was, or drops a term of its update, misses this by orders of magnitude;
# f32 rounding stays below a tenth of it.
ADAM_REL, ADAM_FLOOR = 1e-3, 1e-4
F32_FLOPS = 67e12          # f32 outside the tensor cores, NVIDIA data sheet
# 32-bit integer multiplies: 64 a clock on each of 132 SMs (CUDA C++ Programming
# Guide, throughput of compute capability 9.0) at the 1,980 MHz boost clock
INT32_MULS = 132 * 64 * 1.98e9


def flash_case(torch, name, *, b, s, h, kvh, d, causal=True, window=0, alibi=False,
               seg=False, seed=0):
    """One flash-attention input set on the card in bf16: q already scaled
    by D^-0.5 (as the wrapper hands it to the kernels), k, v, the output
    cotangent do, and the mask options."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16).cuda()

    segs = None
    if seg:
        segs = torch.zeros(b, s, dtype=torch.int32)
        segs[:, s // 3:] = 1
        segs[:, (2 * s) // 3:] = 2
        segs[-1, s // 5:] = 3
        segs = segs.cuda()
    return dict(name=name, q=rnd(b, s, h, d, scale=d ** -0.5), k=rnd(b, s, kvh, d),
                v=rnd(b, s, kvh, d), do=rnd(b, s, h, d),
                kw=dict(causal=causal, window=window, segment_ids=segs,
                        alibi_slopes=torch.linspace(0.5, 0.01, h).cuda() if alibi else None))


def flash_work(case):
    """(bytes, flops) per kernel on this case's data: each input read once,
    each output written once; 4 D flops per visible (q, k) pair forward, 6 D
    for dq, 8 D for dk/dv (two products each per pair)."""
    import torch
    q, k, kw = case["q"], case["k"], case["kw"]
    b, s, h, d = q.shape
    kvh = k.shape[2]
    idx = torch.arange(s, device=q.device)
    vis = torch.ones(s, s, dtype=torch.bool, device=q.device)
    if kw["causal"]:
        vis &= idx[:, None] >= idx[None, :]
    if kw["window"]:
        vis &= idx[:, None] - idx[None, :] < kw["window"]
    if kw["segment_ids"] is not None:
        sg = kw["segment_ids"]
        pairs = int((vis[None] & (sg[:, :, None] == sg[:, None, :])).sum()) * h
    else:
        pairs = int(vis.sum()) * b * h
    q_b = b * s * h * d * 2
    kv_b = b * s * kvh * d * 2
    row_b = b * h * s * 4
    return {"flash_attention_fwd": (2 * q_b + 2 * kv_b + row_b, 4 * d * pairs),
            "flash_attention_dq": (3 * q_b + 2 * kv_b + 2 * row_b, 6 * d * pairs),
            "flash_attention_dkv": (2 * q_b + 4 * kv_b + 2 * row_b, 8 * d * pairs)}


def bound(nbytes, flops, peak_flops=BF16_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_flash(torch, case):
    """K3, K4, K5 once each on the case, against the plain versions on f32
    copies of the same inputs (the backward from the kernel's lse and
    delta). Forward: |out - plain| <= 2e-2 + 2e-2 |plain| (and lse);
    gradients: max |d - plain| <= 2e-2 max |plain| + 2e-2. The largest
    values sit in the first causal rows, so that limit alone would pass a
    kernel wrong on most rows: out, dq, dk and dv are also held to a
    relative Frobenius error ||got - plain|| / ||plain|| <= 1e-2, and the
    median |plain| is printed beside each limit. Each kernel runs a second
    time on the same inputs and must give out, lse, dq, dk and dv bit for
    bit; at D 64 and 128 all three must be the wgmma kernels."""
    from deepspeed_tpu_torch.ops import flash_attention as FA
    q, k, v, do, kw = case["q"], case["k"], case["v"], case["do"], case["kw"]
    before = [f.launches for f in (FA.flash_attention_fwd, FA.flash_attention_dq,
                                   FA.flash_attention_dkv)]
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    dq = FA.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    after = [f.launches for f in (FA.flash_attention_fwd, FA.flash_attention_dq,
                                  FA.flash_attention_dkv)]
    out2, lse2 = FA.flash_attention_fwd(q, k, v, **kw)   # the same inputs: bit for bit
    dq2 = FA.flash_attention_dq(q, k, v, do, lse, delta, **kw)
    dk2, dv2 = FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw)
    deterministic = {nm: bool(torch.equal(a, b_)) for nm, a, b_ in (
        ("out", out, out2), ("lse", lse, lse2), ("dq", dq, dq2), ("dk", dk, dk2),
        ("dv", dv, dv2))}
    del out2, lse2, dq2, dk2, dv2
    f32 = [t.float() for t in (q, k, v, do)]
    p_out, p_lse = FA.flash_attention_fwd_plain(*f32[:3], **kw)
    p_dq, p_dk, p_dv = FA.flash_attention_bwd_plain(*f32, lse, delta, **kw)
    d = q.shape[3]
    variant = {kind: FA.kernel_info(kind, d)["variant"] for kind in ("fwd", "dq", "dkv")}
    row = {"kernel_launches": [a - b for a, b in zip(after, before)],
           "deterministic": deterministic}
    ok = row["kernel_launches"] == [1, 1, 1] and all(deterministic.values())
    ok &= d not in (64, 128) or set(variant.values()) == {"wgmma"}
    for nm, got, ref in (("out", out, p_out), ("lse", lse, p_lse)):
        err = (got.float() - ref).abs()
        row[nm] = float(err.max())
        ok &= bool((err <= ATOL + RTOL * ref.abs()).all())
    for nm, got, ref in (("dq", dq, p_dq), ("dk", dk, p_dk), ("dv", dv, p_dv)):
        err, scale = float((got.float() - ref.float()).abs().max()), float(ref.abs().max())
        row[nm] = err
        row[nm + "_limit"] = RTOL * scale + ATOL
        row[nm + "_median_plain"] = float(ref.abs().median())
        ok &= err <= row[nm + "_limit"]
    for nm, got, ref in (("out", out, p_out), ("dq", dq, p_dq), ("dk", dk, p_dk),
                         ("dv", dv, p_dv)):
        rel = float(torch.linalg.vector_norm(got.float() - ref.float())
                    / torch.linalg.vector_norm(ref.float()))
        row[nm + "_rel_fro"] = rel
        ok &= rel <= FRO_TOL
    q_, k_ = case["q"], case["k"]
    emit("train_kernel_check", kernel="flash_attention", case=case["name"],
         shape=dict(B=q_.shape[0], S=q_.shape[1], H=q_.shape[2], KVH=k_.shape[2],
                    D=q_.shape[3], causal=kw["causal"], window=kw["window"],
                    alibi=kw["alibi_slopes"] is not None,
                    segments=kw["segment_ids"] is not None),
         variant=variant, max_abs_err=row, within=ok)
    if not ok:
        fail(f"flash attention {case['name']}: {row}")
    return row


def adam_inputs(torch, n, seed=0):
    """A mid-training state of one f32 leaf of n elements on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda") * 0.02
    grad = torch.randn(n, generator=g, device="cuda") * 1e-3
    m = torch.randn(n, generator=g, device="cuda") * 1e-4
    v = torch.rand(n, generator=g, device="cuda") * 1e-6
    return p, grad, m, v


ADAM_KW = dict(step=3.0, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.1)


def check_adam(torch, n, case):
    """K10 once on a mid-training state of ``n`` elements against its plain
    version (ADAM_REL / ADAM_FLOOR of each buffer's change); one
    train_kernel_check line. Returns (the four state tensors after the
    kernel's step, the largest error)."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat, fused_adam_flat_plain
    ap, ag, am, av = adam_inputs(torch, n)
    ref = [t.clone() for t in (ap, ag, am, av)]
    start = [t.clone() for t in (ap, am, av)]
    before = fused_adam_flat.launches
    fused_adam_flat(ap, ag, am, av, **ADAM_KW)
    fused_adam_flat_plain(*ref, **ADAM_KW)
    torch.cuda.synchronize()
    adam_err, adam_ok = 0.0, fused_adam_flat.launches == before + 1
    adam_rows = {}
    for nm, got, want, was in (("p", ap, ref[0], start[0]), ("m", am, ref[2], start[1]),
                               ("v", av, ref[3], start[2])):
        change = was.sub_(want).abs_()
        max_change = float(change.max())
        err = (got - want).abs_()
        max_err = float(err.max())
        adam_err = max(adam_err, max_err)
        # the largest err / (ADAM_REL |change| + ADAM_FLOOR max|change|)
        used = float(err.div_(change.mul_(ADAM_REL).add_(ADAM_FLOOR * max_change)).max())
        adam_rows[nm] = dict(max_abs_err=max_err, max_change=max_change,
                             share_of_limit=used)
        adam_ok &= used <= 1.0
        del change, err
    del start, ref
    emit("train_kernel_check", kernel="fused_adam", case=case, n=n, max_abs_err=adam_err,
         per_buffer=adam_rows, rel=ADAM_REL, floor=ADAM_FLOOR, within=adam_ok)
    if not adam_ok:
        fail(f"fused adam: {adam_rows}")
    return (ap, ag, am, av), adam_err


def flash_time_entries(torch, case, errs, shape):
    """K3, K4, K5 on ``case`` by CUDA events beside their plain versions,
    one SDPA call and their bounds; one train_kernel_time line each.
    Returns their kernel entries (without launches)."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import flash_attention as FA
    entries = []
    q, k, v, do, kw = case["q"], case["k"], case["v"], case["do"], case["kw"]
    f32 = [t.float() for t in (q, k, v, do)]
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_do = do.transpose(1, 2)
    # the library yardsticks once each, with the kernels' repetitions and
    # before the plain versions fill the allocator with large temporaries;
    # one SDPA backward computes dq, dk and dv, so it stands beside K4 and K5
    library_ms = {
        "fwd": cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bwd": cuda_ms(torch, lambda i: torch.autograd.grad(
            lib_out, (qt, kt, vt), lib_do, retain_graph=True))}
    timed = {
        "flash_attention_fwd": (
            lambda i: FA.flash_attention_fwd(q, k, v, **kw),
            lambda i: FA.flash_attention_fwd_plain(*f32[:3], **kw), "fwd"),
        "flash_attention_dq": (
            lambda i: FA.flash_attention_dq(q, k, v, do, lse, delta, **kw),
            lambda i: FA.flash_attention_bwd_plain(*f32, lse, delta, **kw), "bwd"),
        "flash_attention_dkv": (
            lambda i: FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
            lambda i: FA.flash_attention_bwd_plain(*f32, lse, delta, **kw), "bwd"),
    }
    work = flash_work(case)
    for name, (kern, plain, lib) in timed.items():
        nbytes, flops = work[name]
        b_ms, b_by = bound(nbytes, flops)
        row = dict(ms=cuda_ms(torch, kern),
                   plain_ms=cuda_ms(torch, plain, reps=3, iters=3),
                   library_ms=library_ms[lib],
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        row["tflops"] = flops / row["ms"] / 1e9
        emit("train_kernel_time", kernel=name, case=case["name"],
             variant=FA.kernel_info(name.split("_")[-1], shape["D"])["variant"],
             shape=shape,
             library=("F.scaled_dot_product_attention forward" if name.endswith("fwd") else
                      "autograd backward of F.scaled_dot_product_attention (dq, dk and dv "
                      "together)"), **row)
        entries.append({"name": name, "route": "cuda", "source": FLASH_SOURCE,
                        "replaces": FLASH_REPLACES[name], "max_abs_err": errs[name],
                        **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "library_ms")}})
    del f32, out, lse, delta, qt, kt, vt, lib_out, timed
    torch.cuda.empty_cache()
    return entries


def adam_time_entry(torch, state, adam_err, case):
    """K10 on ``state`` (``check_adam``'s) by CUDA events beside its plain
    version, ``AdamW(fused=True).step()`` and its bound; one
    train_kernel_time line. Returns its kernel entry (without launches)."""
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat, fused_adam_flat_plain
    ap, ag, am, av = state
    n = ap.numel()
    nbytes, flops = 28 * n, 15 * n
    b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
    lib_p = torch.nn.Parameter(ap)
    lib_p.grad = ag
    lib_opt = torch.optim.AdamW([lib_p], lr=ADAM_KW["lr"], betas=ADAM_KW["betas"],
                                eps=ADAM_KW["eps"], weight_decay=ADAM_KW["weight_decay"],
                                fused=True)
    lib_opt.step()
    row = dict(ms=cuda_ms(torch, lambda i: fused_adam_flat(ap, ag, am, av, **ADAM_KW)),
               plain_ms=cuda_ms(torch, lambda i: fused_adam_flat_plain(ap, ag, am, av, **ADAM_KW),
                                reps=3, iters=3),
               library_ms=cuda_ms(torch, lambda i: lib_opt.step(), reps=3, iters=10),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    emit("train_kernel_time", kernel="fused_adam", case=case, n=n,
         library="torch.optim.AdamW(fused=True).step()", **row)
    del lib_p, lib_opt
    torch.cuda.empty_cache()
    return {"name": "fused_adam", "route": "cuda", "source": ADAM_SOURCE,
            "replaces": ADAM_REPLACES, "max_abs_err": adam_err,
            **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}


def train_kernel_phases(torch, largest_leaf):
    """train_kernel_check and train_kernel_time. Returns the kernel entries
    (without launches) for K3, K4, K5 and K10."""
    main = dict(b=TRAIN_MICRO, s=TRAIN_SEQ, h=25, kvh=25, d=64)     # gpt2-xl, causal
    cases = [
        ("gpt2xl_causal", main),
        ("llama3_8b_gqa", dict(b=1, s=2048, h=32, kvh=8, d=128, seed=1)),
        ("d256", dict(b=1, s=512, h=4, kvh=2, d=256, seed=2)),
        ("window256", dict(b=2, s=1024, h=8, kvh=8, d=64, window=256, seed=3)),
        ("alibi", dict(b=2, s=512, h=8, kvh=4, d=64, alibi=True, seed=4)),
        ("segments", dict(b=2, s=512, h=4, kvh=2, d=128, seg=True, seed=5)),
        ("noncausal", dict(b=2, s=512, h=4, kvh=4, d=64, causal=False, seed=6)),
        ("tail_s1000", dict(b=2, s=1000, h=4, kvh=2, d=64, seed=7)),
        ("d128_noncausal_gqa_segments", dict(b=2, s=512, h=8, kvh=2, d=128, causal=False,
                                             seg=True, seed=8)),
        ("d128_window_gqa", dict(b=2, s=1024, h=16, kvh=4, d=128, window=384, seed=9)),
        ("d128_tail_gqa", dict(b=1, s=1000, h=8, kvh=2, d=128, seed=10)),
    ]
    worst = {"out": 0.0, "dq": 0.0, "dkv": 0.0}
    for name, kw in cases:
        row = check_flash(torch, flash_case(torch, name, **kw))
        worst["out"] = max(worst["out"], row["out"])
        worst["dq"] = max(worst["dq"], row["dq"])
        worst["dkv"] = max(worst["dkv"], row["dk"], row["dv"])
        torch.cuda.empty_cache()

    # K10 at the largest leaf of the main path, from a mid-training state
    state, adam_err = check_adam(torch, largest_leaf, f"{TRAIN_MODEL}_largest_leaf")

    # timing at the main path's shapes
    errs = {"flash_attention_fwd": worst["out"], "flash_attention_dq": worst["dq"],
            "flash_attention_dkv": worst["dkv"]}
    entries = flash_time_entries(
        torch, flash_case(torch, "gpt2xl_causal", **main), errs,
        dict(B=TRAIN_MICRO, S=TRAIN_SEQ, H=25, KVH=25, D=64, dtype="bfloat16"))
    entries.append(adam_time_entry(torch, state, adam_err, f"{TRAIN_MODEL}_largest_leaf"))
    del state
    torch.cuda.empty_cache()
    return entries


def train_config():
    return {
        "train_batch_size": TRAIN_BATCH,
        "train_micro_batch_size_per_gpu": TRAIN_MICRO,
        "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
        "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 8}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 1},
        "steps_per_print": 10 ** 9,
        "seed": 0,
    }


def train_path(torch, smi):
    """train_path: initialize() on gpt2-xl at full width and depth (random
    weights from seed 0, bf16 activations, f32 params and Adam state), then
    2 warm-up and 6 timed train_batch steps on one fixed random batch, and
    one more step through forward/backward/step. Returns (engine, batch,
    launches by kernel name, timed ms per step)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=build_model(TRAIN_MODEL), config=train_config())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = engine.model.cfg
    n_params = sum(p.numel() for p in tree_leaves(engine.module_params))
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), generator=g)
    batch = {"input_ids": ids[:, :-1].cuda(), "labels": ids[:, 1:].cuda()}

    counters = [FA.flash_attention_fwd, FA.flash_attention_dq, FA.flash_attention_dkv,
                fused_adam_flat]
    for f in counters:
        f.launches = 0
    warm, timed = 2, 6
    losses = [engine.train_batch(batch) for _ in range(warm)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(timed)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # one more step through the decomposed API, micro-batch by micro-batch
    micro_losses = []
    for i in range(engine.gradient_accumulation_steps()):
        loss = engine.forward({k: v[i * TRAIN_MICRO:(i + 1) * TRAIN_MICRO]
                               for k, v in batch.items()})
        engine.backward(loss)
        engine.step()
        micro_losses.append(loss.detach())
    losses.append(sum(micro_losses) / len(micro_losses))
    launches = {f.__name__: f.launches for f in counters}
    losses = [float(x) for x in losses]

    steps = warm + timed + 1
    micro = steps * engine.gradient_accumulation_steps()
    want = {"flash_attention_fwd": cfg.num_layers * micro,
            "flash_attention_dq": cfg.num_layers * micro,
            "flash_attention_dkv": cfg.num_layers * micro,
            "fused_adam_flat": len(tree_leaves(engine.module_params)) * steps}
    ms_step = wall * 1e3 / timed
    tokens_s = TRAIN_BATCH * TRAIN_SEQ * timed / wall
    flops_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * TRAIN_SEQ
    ok = (all(map(math.isfinite, losses)) and losses[-1] < losses[0] and launches == want)
    emit("train_path", model=TRAIN_MODEL, layers=cfg.num_layers, hidden=cfg.hidden_size,
         heads=cfg.num_heads, params=n_params, seq=TRAIN_SEQ, micro_batch=TRAIN_MICRO,
         gas=engine.gradient_accumulation_steps(), train_batch_size=TRAIN_BATCH,
         zero_stage=engine.zero_optimization_stage(), dtype="bfloat16 activations, f32 params",
         steps=steps, warmup_steps=warm, timed_steps=timed,
         losses=losses, last_step="forward/backward/step", launches=launches,
         launches_expected=want, ms_per_step=ms_step, tokens_per_s=tokens_s,
         mfu=flops_token * tokens_s / BF16_FLOPS,
         mfu_formula="(6 * params + 12 * layers * hidden * seq) * tokens/s / 989e12",
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, init_s=init_s, card=smi,
         within=ok)
    if not ok:
        fail(f"train path: losses {losses}, launches {launches} (expected {want})")
    return engine, batch, launches, ms_step


def train_reference_check(torch, engine, batch):
    """One 2 x 1024 micro-batch through the flash kernels and through
    attn_impl="reference", on the trained weights: loss within 1 %, global
    gradient norm within 2 %, per-leaf gradient cosine >= 0.99."""
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths
    leaves = tree_leaves(engine.module_params)
    mb = {k: v[:2] for k, v in batch.items()}
    results = {}
    for impl in ("flash", "reference"):
        model = build_model(engine.model.cfg.replace(attn_impl=impl))
        loss = model.loss(engine.module_params, mb)
        grads = torch.autograd.grad(loss, leaves)
        results[impl] = (float(loss), [g.float() for g in grads])
        del loss, grads
    (lf, gf), (lr, gr) = results["flash"], results["reference"]
    nf = float(torch.stack([g.norm() for g in gf]).norm())
    nr = float(torch.stack([g.norm() for g in gr]).norm())
    paths = [path for path, _ in tree_paths(engine.module_params)]
    # the key bias adds one q.bk to every score of a query row, which the
    # softmax cancels: its exact gradient is 0 and both paths give rounding
    # noise, so its cosine is not compared (its norms are reported)
    zero = {p: (float(a.norm()), float(b.norm()))
            for p, a, b in zip(paths, gf, gr) if p.endswith("attn.bk")}
    cos = {p: float(torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(), dim=0))
           for p, a, b in zip(paths, gf, gr) if p not in zero}
    worst = min(cos, key=cos.get)
    ok = (abs(lf - lr) <= 0.01 * abs(lr) and abs(nf - nr) <= 0.02 * nr
          and cos[worst] >= 0.99 and math.isfinite(lf))
    emit("train_reference_check", micro_batch=2, seq=TRAIN_SEQ, loss_flash=lf,
         loss_reference=lr, grad_norm_flash=nf, grad_norm_reference=nr,
         min_leaf_cosine=cos[worst], min_cosine_leaf=worst, leaf_cosines=cos,
         zero_gradient_leaf_norms=zero, within=ok)
    if not ok:
        fail(f"train reference check: loss {lf} vs {lr}, norm {nf} vs {nr}, "
             f"cosine {cos[worst]} at {worst}")


def _train_kernel_class(name):
    low = name.lower()
    if "ring_fwd" in low:
        return "ring_fwd"
    if "ring_dq" in low or "ring_dkv" in low:
        return "ring_bwd"
    if "flash_fwd" in low:
        return "flash_fwd"
    if "flash_dq" in low or "flash_dkv" in low:
        return "flash_bwd"
    if "adam_kernel" in low:
        return "adam"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
        return "gemm"
    return "other"


def train_step_profile(torch, engine, batch, ms_step, smi, model=TRAIN_MODEL,
                       phase="train_step_profile", steps=2):
    """Device time of ``steps`` train_batch steps by kernel class
    (torch.profiler) against the timed steps' wall time: the device's idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.train_batch(batch)
        torch.cuda.synchronize()
    by_class, by_name = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us() / steps
        cls = _train_kernel_class(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    busy_ms = sum(by_class.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]
    emit(phase, model=model, wall_ms=ms_step, device_busy_ms=busy_ms,
         idle_share=max(0.0, 1 - busy_ms / ms_step),
         device_ms_by_class={k: v / 1e3 for k, v in by_class.items()},
         top_kernels_ms=[(k[:80], v / 1e3) for k, v in top], card=smi)


def train_phases(torch, smi):
    """The training slice's phases; returns its kernel entries."""
    from deepspeed_tpu_torch.models import build_model
    cfg = build_model(TRAIN_MODEL).cfg
    largest_leaf = cfg.num_layers * cfg.hidden_size * cfg.ffn_size   # mlp.wi / mlp.wo
    entries = train_kernel_phases(torch, largest_leaf)
    engine, batch, launches, ms_step = train_path(torch, smi)
    train_reference_check(torch, engine, batch)
    train_step_profile(torch, engine, batch, ms_step, smi)
    for e in entries:
        e["launches"] = launches["fused_adam_flat" if e["name"] == "fused_adam" else e["name"]]
    del engine
    torch.cuda.empty_cache()
    return entries


# ------------------------------------------ v1 inference and quantization slice

V1_MODEL = "llama3-8b"
V1_B, V1_PROMPT, V1_NEW = 4, 8064, 128   # S_max = 8192: the fused decode route
DECODE_SOURCE = "deepspeed_tpu_torch/ops/csrc/decode_attention.cu"
DECODE_REPLACES = "deepspeed_tpu/ops/pallas/decode_attention.py:26"
QUANT_SOURCE = "deepspeed_tpu_torch/ops/csrc/quantizer.cu"
QUANT_REPLACES = {8: "deepspeed_tpu/ops/pallas/quantizer.py:43",     # quantize_int8's call
                  4: "deepspeed_tpu/ops/pallas/quantizer.py:70"}     # quantize_int4's call
WOQ_SOURCE = "deepspeed_tpu_torch/ops/csrc/woq_matmul.cu"
WOQ_REPLACES = "deepspeed_tpu/ops/pallas/woq_matmul.py:121"
WOQ_GROUP = 256            # QuantizedLinear's default group (fused at llama3-8b's K)
L2_BYTES = 50e6            # H100 L2: timed operands are cycled past it


def kernel_counters():
    """Every kernel wrapper of the port, by kernel name: each counts its own
    launches in ``.launches``."""
    from deepspeed_tpu_torch.ops import decode_attention as DA
    from deepspeed_tpu_torch.ops import evoformer_flash as EF
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    from deepspeed_tpu_torch.ops import fused_adam, paged_attention
    from deepspeed_tpu_torch.ops import quantizer as Q
    from deepspeed_tpu_torch.ops import woq_matmul as W
    from deepspeed_tpu_torch.sequence import ring_flash as RF
    return {"paged_attention": paged_attention.paged_ragged_attention,
            "flash_attention_fwd": FA.flash_attention_fwd,
            "flash_attention_dq": FA.flash_attention_dq,
            "flash_attention_dkv": FA.flash_attention_dkv,
            "fused_adam": fused_adam.fused_adam_flat,
            "fused_decode_attention": DA.fused_decode_attention,
            "woq_matmul": W.woq_matmul,
            "quantize_int8": Q.quantize_int8, "quantize_int4": Q.quantize_int4,
            "sparse_flash_fwd": SF.sparse_flash_fwd, "evoformer_flash_fwd": EF.evoformer_flash_fwd,
            "quantize_fp8": FQ.quantize_fp8, "ring_fwd_step": RF.ring_fwd_step,
            "ring_dq_step": RF.ring_dq_step, "ring_dkv_step": RF.ring_dkv_step}


def zero_counts():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def decode_case(torch, lens, s_max=8192, h=H, kvh=KVH, d=D, seed=0):
    """One fused-decode input set on the card in bf16: q (B, H, D), the
    (B, S_max, KVH, D) caches, cache_len (B,) int32."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    b = len(lens)
    return dict(q=rnd(b, h, d), k=rnd(b, s_max, kvh, d), v=rnd(b, s_max, kvh, d),
                lens=torch.tensor(lens, dtype=torch.int32, device="cuda"))


def decode_work(case):
    """(bytes, flops) of one fused decode on this case's data: each live K
    and V row read once, q read and out written once, cache_len read; 4 D
    flops per (query head, live slot)."""
    b, h, d = case["q"].shape
    s_max, kvh = case["k"].shape[1], case["k"].shape[2]
    live = int(case["lens"].clamp(0, s_max).sum())
    return 2 * live * kvh * d * 2 + 2 * b * h * d * 2 + 4 * b, 4 * d * h * live


def sdpa_decode(torch, case):
    """The library yardstick: scaled_dot_product_attention on (B, H, 1, D)
    q over (B, KVH, S, D) keys laid out beforehand, a boolean mask of the
    live slots and enable_gqa. Never called by the port."""
    import torch.nn.functional as F
    q = case["q"][:, :, None]
    k, v = (case[n].transpose(1, 2).contiguous() for n in ("k", "v"))
    mask = (torch.arange(k.shape[2], device="cuda")[None] < case["lens"][:, None])[:, None, None]
    return lambda i: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def check_decode(torch, name, case):
    """K2 twice against its plain version on f32 copies of the inputs:
    |out - plain| <= 2e-2 + 2e-2 |plain| everywhere, relative Frobenius error
    <= 1e-2, rows with cache_len 0 exactly 0, and the two runs bit-identical
    (the chunks merge in a fixed order whichever block finishes last)."""
    from deepspeed_tpu_torch.ops.decode_attention import (fused_decode_attention,
                                                          fused_decode_attention_plain)
    before = fused_decode_attention.launches
    first = fused_decode_attention(case["q"], case["k"], case["v"], case["lens"])
    second = fused_decode_attention(case["q"], case["k"], case["v"], case["lens"])
    got = first.float()
    ref = fused_decode_attention_plain(case["q"].float(), case["k"].float(),
                                       case["v"].float(), case["lens"])
    torch.cuda.synchronize()
    err = (got - ref).abs()
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    empty = case["lens"] == 0
    zero = bool((got[empty] == 0).all()) if empty.any() else True
    same = bool(torch.equal(first, second))
    ok = (bool((err <= ATOL + RTOL * ref.abs()).all()) and rel <= FRO_TOL and zero and same
          and fused_decode_attention.launches == before + 2)
    b, h, d = case["q"].shape
    emit("v1_kernel_check", kernel="fused_decode_attention", case=name,
         shape=dict(B=b, S_max=case["k"].shape[1], H=h, KVH=case["k"].shape[2], D=d,
                    cache_len=case["lens"].tolist(), dtype="bfloat16"),
         max_abs_err=float(err.max()), rel_fro=rel, atol=ATOL, rtol=RTOL, fro_tol=FRO_TOL,
         empty_rows_zero=zero, twice_bit_identical=same, within=ok)
    if not ok:
        fail(f"fused decode attention {name}: max err {float(err.max())}, rel {rel}")
    return float(err.max())


def v1_kernel_phases(torch):
    """v1_kernel_check / v1_kernel_time / v1_crossover for K2. Returns its
    kernel entry (without launches)."""
    from deepspeed_tpu_torch.ops.attention import masked_decode_attention
    from deepspeed_tpu_torch.ops.decode_attention import (fused_decode_attention,
                                                          fused_decode_attention_plain)
    main = dict(lens=[V1_PROMPT + V1_NEW] * V1_B)                      # the main path, full
    mixed = dict(lens=[8192, 8065, 4097, 1, 0], seed=1)
    cases = {"main": main, "mixed": mixed,
             # the other compiled head dims and query-group counts
             "d64_mha": dict(lens=[8192, 300], h=8, kvh=8, d=64, seed=2),
             "d192_g2": dict(lens=[129, 8000], h=4, kvh=2, d=192, seed=3),
             "d256_g16_s8320": dict(lens=[8320, 77], s_max=8320, h=16, kvh=1, d=256, seed=4)}
    worst, rows = 0.0, {}
    for name, kw in cases.items():
        worst = max(worst, check_decode(torch, name, decode_case(torch, **kw)))
        torch.cuda.empty_cache()
    # the main and mixed cases, then the batch sweep on full caches (B = 4
    # is the main case)
    timed = {"main": cases["main"], "mixed": cases["mixed"],
             "B1": dict(lens=[8192], seed=7), "B16": dict(lens=[8192] * 16, seed=8)}
    for name, kw in timed.items():
        case = decode_case(torch, **kw)
        f32 = {k: case[k].float() for k in ("q", "k", "v")}
        nbytes, flops = decode_work(case)
        b_ms, b_by = bound(nbytes, flops)
        kernel = lambda i: fused_decode_attention(case["q"], case["k"], case["v"], case["lens"])
        library = sdpa_decode(torch, case)
        row = dict(
            ms=cuda_ms(torch, kernel), graph_ms=graph_ms(torch, kernel),
            plain_ms=cuda_ms(torch, lambda i: fused_decode_attention_plain(
                f32["q"], f32["k"], f32["v"], case["lens"]), reps=3, iters=5),
            library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
        emit("v1_kernel_time", kernel="fused_decode_attention", case=name,
             cache_len=kw["lens"], library="F.scaled_dot_product_attention "
             "(boolean mask, enable_gqa) on pre-laid-out (B, H, 1, D) q",
             timing="ms: back-to-back calls by CUDA events (host launch time included); "
             "graph_ms: the same calls replayed from one CUDA graph (device time)", **row)
        rows[name] = row
        del case, f32
        torch.cuda.empty_cache()
    # the einsum branch against K2 on full caches: where the H100 crosses over
    cross = {}
    for s_max in (2048, 4096, 8192):
        case = decode_case(torch, [s_max] * V1_B, s_max=s_max, seed=5)
        q4 = case["q"][:, None]
        cross[s_max] = dict(
            fused_ms=cuda_ms(torch, lambda i: fused_decode_attention(
                case["q"], case["k"], case["v"], case["lens"])),
            einsum_ms=cuda_ms(torch, lambda i: masked_decode_attention(
                q4, case["k"], case["v"], case["lens"]), reps=3, iters=10))
        del case, q4
    emit("v1_crossover", B=V1_B, H=H, KVH=KVH, D=D, by_s_max=cross,
         note="full caches; the dispatch keeps the JAX rule (fused from S_max 8192)")
    torch.cuda.empty_cache()
    m = rows["main"]
    return {"name": "fused_decode_attention", "route": "cuda", "source": DECODE_SOURCE,
            "replaces": DECODE_REPLACES, "max_abs_err": worst,
            **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_ms": m["graph_ms"], "library_device_ms": m["library_graph_ms"],
            "batch_sweep_device_ms": {n: {"ms": rows[n]["graph_ms"],
                                          "library_ms": rows[n]["library_graph_ms"],
                                          "bound_ms": rows[n]["bound_ms"]}
                                      for n in ("B1", "main", "B16")}}


def v1_generate_counted(torch, eng, ids):
    """One greedy ``eng.generate(ids, V1_NEW)`` with every count set to 0
    before. The first ``apply_decode`` is the prefill: when it ends, its
    last logits and the cache it fills in place are kept. Returns the
    output, those, the seconds, K2's launches (the wrapper's plus what the
    graph replays launched), the decode steps run (eager calls past the
    prefill, less captures, plus replays), captures and peak memory."""
    seen = {"calls": 0}
    apply_decode = eng.model.apply_decode

    def watched(*a, **kw):
        out = apply_decode(*a, **kw)
        if seen["calls"] == 0:
            torch.cuda.synchronize()
            seen.update(prefill_end=time.perf_counter(), prefill_logits=out[0][:, -1].float(),
                        cache=out[1])
        seen["calls"] += 1
        return out

    graphs = eng.graphs
    g0 = graphs.stats() if graphs is not None else None
    eng.model.apply_decode = watched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t_start = time.perf_counter()
    try:
        out = eng.generate(ids, max_new_tokens=V1_NEW)
        torch.cuda.synchronize()
    finally:
        del eng.model.apply_decode
    t_end = time.perf_counter()
    counts = read_counts()
    r = dict(out=out, seen=seen, counts=counts, ttft_s=seen["prefill_end"] - t_start,
             decode_s=t_end - seen["prefill_end"], generate_s=t_end - t_start,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, captures=0,
             capture_s=0.0, replays=0, replayed=0)
    if graphs is not None:
        g1 = graphs.stats()
        r.update(captures=g1["captures"] - g0["captures"],
                 capture_s=g1["capture_s"] - g0["capture_s"],
                 replays=g1["replays"] - g0["replays"],
                 replayed=(g1["replayed_launches"].get("fused_decode_attention", 0)
                           - g0["replayed_launches"].get("fused_decode_attention", 0)))
    r["launches"] = counts["fused_decode_attention"] + r["replayed"]
    r["decode_steps"] = seen["calls"] - 1 - r["captures"] + r["replays"]
    return r


def v1_main_path(torch, smi):
    """v1_main_path: init_inference(llama3-8b, bf16).generate() at full
    width and depth, B = 4 prompts of 8064 random tokens (seed 0), 128
    greedy new tokens over an 8192-slot cache: first on an engine built
    with ``cuda_graphs=False``, then on one over the same weights with the
    decode step replayed from a CUDA graph (the default on the card). Both
    must give the same tokens, run 127 decode steps and launch K2 layers x
    127 times (run + replayed); then the two reference checks and the
    decode step's profile, eager and replayed. Returns (K2 launches of the
    graph run, the engine)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    t0 = time.perf_counter()
    eng = dst.init_inference(build_model(V1_MODEL), dtype="bfloat16")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eager = dst.init_inference(build_model(V1_MODEL), dtype="bfloat16",
                               params=eng.module_params, cuda_graphs=False)
    cfg = eng.model.cfg
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (V1_B, V1_PROMPT), generator=g, dtype=torch.int32)
    runs = {"eager": v1_generate_counted(torch, eager, ids)}
    del eager, runs["eager"]["seen"]["cache"]    # its cache goes before the graph run
    runs["graph"] = v1_generate_counted(torch, eng, ids)
    want = cfg.num_layers * (V1_NEW - 1)
    out = runs["graph"]["out"]
    new = out[:, V1_PROMPT:]
    ok = (tuple(out.shape) == (V1_B, V1_PROMPT + V1_NEW)
          and bool((out[:, :V1_PROMPT].cpu() == ids).all())
          and bool(((new >= 0) & (new < cfg.vocab_size)).all())
          and bool(torch.equal(out, runs["eager"]["out"]))
          and all(r["launches"] == want and r["decode_steps"] == V1_NEW - 1
                  for r in runs.values()))
    by_mode = {mode: {"ttft_s": r["ttft_s"], "decode_s": r["decode_s"],
                      "decode_tokens_per_s": V1_B * (V1_NEW - 1) / r["decode_s"],
                      "generate_s": r["generate_s"], "fused_decode_launches": r["launches"],
                      "launches_run": r["counts"]["fused_decode_attention"],
                      "launches_replayed": r["replayed"], "decode_steps": r["decode_steps"],
                      "captures": r["captures"], "capture_s": r["capture_s"],
                      "replays": r["replays"], "peak_memory_gb": r["peak_memory_gb"]}
               for mode, r in runs.items()}
    r = runs["graph"]
    emit("v1_main_path", model=V1_MODEL, layers=cfg.num_layers, hidden=cfg.hidden_size,
         batch=V1_B, prompt_tokens=V1_PROMPT, new_tokens=V1_NEW,
         cache_slots=V1_PROMPT + V1_NEW, dtype="bfloat16",
         ttft_s=r["ttft_s"], decode_s=r["decode_s"],
         decode_tokens_per_s=V1_B * (V1_NEW - 1) / r["decode_s"],
         generate_s=r["generate_s"], fused_decode_launches=r["launches"],
         launches_expected=want, launches_by_kernel=r["counts"],
         peak_memory_gb=r["peak_memory_gb"], init_s=init_s, by_mode=by_mode,
         tokens_identical_graph_eager=bool(torch.equal(out, runs["eager"]["out"])),
         sampled_steps="eager by rule (temperature > 0); greedy steps replayed",
         first_new_tokens=new[:, :8].tolist(), card=smi, within=ok)
    if not ok:
        fail(f"v1 main path: shape {tuple(out.shape)}, graph vs eager tokens "
             f"{'equal' if torch.equal(out, runs['eager']['out']) else 'differ'}, "
             f"launches {[x['launches'] for x in runs.values()]} (expected {want}), "
             f"decode steps {[x['decode_steps'] for x in runs.values()]}")
    v1_reference_checks(torch, eng, ids, out, r["seen"])
    v1_step_profile(torch, eng, out, r["seen"]["cache"], smi)
    return r["launches"], eng


def _within_span(torch, name, got, want, **extra):
    err = float((got - want).abs().max())
    span = float(want.max() - want.min())
    ok = (bool(torch.isfinite(got).all() and torch.isfinite(want).all())
          and err <= 0.05 * span)
    emit("v1_reference_check", check=name, max_abs_logit_err=err, logit_range=span,
         tolerance=0.05 * span, argmax=[int(got.argmax()), int(want.argmax())],
         within=ok, **extra)
    if not ok:
        fail(f"v1 reference check {name}: {err} > 5% of {span}")


def v1_reference_checks(torch, eng, ids, out, seen):
    """(1) the prefill's last-position logits (masked einsum over the
    cache) against engine.forward on the first prompt (the flash path);
    (2) one decode step through K2 against the same step through the plain
    einsum (the device rule patched off), on the cache generate() left:
    each within 5 % of the logit range."""
    from deepspeed_tpu_torch.ops import attention as A
    from deepspeed_tpu_torch.ops.decode_attention import fused_decode_attention
    fwd = eng.forward(ids[:1])[0, -1].float()
    _within_span(torch, "prefill_vs_forward", seen["prefill_logits"][0], fwd,
                 prompt_tokens=V1_PROMPT, forward="flash attention (K3)")
    del fwd
    cache = seen["cache"]
    cl = torch.full((V1_B,), V1_PROMPT + V1_NEW - 1, dtype=torch.int32, device="cuda")
    tok = out[:, -1:]
    before = fused_decode_attention.launches
    fused, _ = eng.model.apply_decode(eng.module_params, tok, cache, cl, last_only=True)
    k2 = fused_decode_attention.launches - before
    on_card = A._on_card
    A._on_card = lambda t: False
    try:
        plain, _ = eng.model.apply_decode(eng.module_params, tok, cache, cl, last_only=True)
    finally:
        A._on_card = on_card
    torch.cuda.synchronize()
    if k2 != eng.model.cfg.num_layers or fused_decode_attention.launches != before + k2:
        fail(f"v1 decode reference: {k2} fused launches in the fused step")
    for b in range(V1_B):
        _within_span(torch, "decode_step_fused_vs_einsum", fused[b, 0].float(), plain[b, 0].float(),
                     row=b, cache_len=V1_PROMPT + V1_NEW)


def _v1_kernel_class(name):
    low = name.lower()
    if "decode_kernel" in low:
        return "fused_decode_attention"
    if any(s in low for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass", "sm90_")):
        return "gemm"
    return "other"


def v1_step_profile(torch, eng, out, cache, smi):
    """One decode step of the main path (B = 4 at cache_len 8191), eager
    (``apply_decode``) and replayed from the generate() call's CUDA graph
    (its state set back to cache_len 8191 and output row 0 before each
    replay): host wall time over synchronized steps, the host's time to
    issue one, device time by kernel class (torch.profiler), the idle share
    (1 - device busy / wall), and K2 kernels a step on the card. The
    earlier phases' traces have left CUPTI attached by now, which adds to
    the host's cost of each graph node (``profile_modes``)."""
    cl = torch.full((V1_B,), V1_PROMPT + V1_NEW - 1, dtype=torch.int32, device="cuda")
    tok = out[:, -1:]

    def eager_step():
        with torch.no_grad():
            return eng.model.apply_decode(eng.module_params, tok, cache, cl, last_only=True)

    st = eng._decode_set
    key = ("decode", V1_B, V1_PROMPT + V1_NEW, True, False)

    def graph_step():
        st.cache_len.fill_(V1_PROMPT + V1_NEW - 1)
        st.rows.at.zero_()
        eng.graphs.run(key, None)

    rows = profile_modes(torch, {"eager": eager_step, "graph": graph_step}, _v1_kernel_class)
    for mode, row in rows.items():
        k2 = row["kernels_a_step_by_class"].get("fused_decode_attention", 0)
        if k2 != eng.model.cfg.num_layers:
            fail(f"v1_step_profile ({mode}): {k2} K2 kernels a step on the card, "
                 f"expected {eng.model.cfg.num_layers}")
        emit("v1_step_profile", step="decode", mode=mode, batch=V1_B,
             cache_len=V1_PROMPT + V1_NEW, **row, card=smi)


def quant_kernel_phases(torch):
    """quant_kernel_check / quant_kernel_time: K7 and K8 on llama3-8b's
    stacked wi_gate leaf (32 x 4096 x 14336 bf16, groups of 256) against
    their plain versions on the card: q and scales byte-identical (counted
    layer by layer). Returns the two kernel entries (without launches)."""
    from deepspeed_tpu_torch.ops import quantizer as Q
    cfg_l, e, f = 32, 4096, 14336
    gs = 256
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(cfg_l, e, f, generator=g, device="cuda", dtype=torch.bfloat16).mul_(0.02)
    n = w.numel()
    per_layer = e * f
    entries = {}
    for bits, fn in ((8, Q.quantize_int8), (4, Q.quantize_int4)):
        before = fn.launches
        q, s = Q.quantize_groups(w, bits, gs)
        torch.cuda.synchronize()
        launched = fn.launches - before
        qb = q.view(-1).view(torch.uint8)
        sb = s.view(-1).view(torch.int32)
        per_q = per_layer if bits == 8 else per_layer // 2
        diff_q = diff_s = 0
        for li in range(cfg_l):
            pq, ps = Q.quantize_groups_plain(w[li], bits, gs)
            diff_q += int((qb[li * per_q:(li + 1) * per_q] != pq.view(-1).view(torch.uint8)).sum())
            g0 = li * per_layer // gs
            diff_s += int((sb[g0:g0 + per_layer // gs] != ps.view(-1).view(torch.int32)).sum())
            del pq, ps
        ok = diff_q == 0 and diff_s == 0 and launched == 1
        emit("quant_kernel_check", kernel=fn.__name__, leaf="layers.mlp.wi_gate",
             shape=[cfg_l, e, f], group_size=gs, dtype="bfloat16", elements=n,
             differing_q_bytes=diff_q, differing_scales=diff_s, within=ok)
        if not ok:
            fail(f"{fn.__name__}: {diff_q} q bytes and {diff_s} scales differ from the plain "
                 f"version ({launched} launches)")
        del q, s, qb, sb
        torch.cuda.empty_cache()
        out_b = n if bits == 8 else n // 2
        nbytes = 2 * n + out_b + 4 * (n // gs)
        b_ms, b_by = bound(nbytes, 4 * n, F32_FLOPS)
        row = dict(ms=cuda_ms(torch, lambda i: Q.quantize_groups(w, bits, gs), reps=5, iters=5),
                   plain_ms=cuda_ms(torch, lambda i: Q.quantize_groups_plain(w, bits, gs),
                                    reps=2, iters=1),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=4 * n)
        emit("quant_kernel_time", kernel=fn.__name__, leaf="layers.mlp.wi_gate",
             library="none: no single PyTorch call computes it", **row)
        torch.cuda.empty_cache()
        entries[bits] = {"name": fn.__name__, "route": "cuda", "source": QUANT_SOURCE,
                         "replaces": QUANT_REPLACES[bits], "max_abs_err": 0.0,
                         **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")}}
    del w
    torch.cuda.empty_cache()
    return entries


# llama3-8b's seven projections of one layer as 2-D (K, N) weights
PROJ = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024), "o": (4096, 4096),
        "gate": (4096, 14336), "up": (4096, 14336), "down": (14336, 4096)}


def woq_kernel_phases(torch):
    """woq_kernel_check / woq_kernel_time / woq_crossover: K6 at bits 8, 4
    and 6 on the seven projection shapes at M = 4 and M = 2048 (random
    weights, group 256) against its plain version (the same bf16-rounded
    tiles, one f32 product): relative Frobenius error <= 1e-2, each case run
    twice and bit-identical. Times cycle through copies of the weight past
    the L2 cache, as a layer's weights are cold in a real step; each row
    names the route the shape takes. Then ragged shapes on every route and
    the crossover in M between the streaming and wgmma routes. Returns the
    kernel entry (the gate projection, int8, M = 4, with the worst M = 2048
    row beside it)."""
    from deepspeed_tpu_torch.ops import woq_matmul as W
    g = torch.Generator(device="cuda").manual_seed(4)

    def held(x, st):
        """K6 twice on (x, st) against the plain version: (rel, max err,
        bit-identical, launched twice)."""
        before = W.woq_matmul.launches
        first, second = W.woq_matmul(x, st), W.woq_matmul(x, st)
        ref = W.woq_matmul_plain(x, st).float()
        torch.cuda.synchronize()
        got = first.float()
        rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
        return (rel, float((got - ref).abs().max()), bool(torch.equal(first, second)),
                W.woq_matmul.launches == before + 2)

    worst, rows = 0.0, {}
    for pname, (k, n) in PROJ.items():
        w = torch.randn(k, n, generator=g, device="cuda").mul_(0.02).to(torch.bfloat16)
        for bits in (8, 4, 6):
            st = W.quantize_woq(w, bits, WOQ_GROUP)
            qbytes = st["q"].numel() + st["scales"].numel() * 4
            copies = [st] + [dict(st, q=st["q"].clone(), scales=st["scales"].clone())
                             for _ in range(int(2 * L2_BYTES // qbytes))]
            w_deq = W.woq_dequantize(st, torch.bfloat16)
            libs = [w_deq] + [w_deq.clone() for _ in range(int(2 * L2_BYTES // (2 * k * n)))]
            for m in (4, 2048):
                x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
                rel, err, same, counted = held(x, st)
                worst = max(worst, err)
                ok = rel <= FRO_TOL and same and counted
                nbytes = qbytes + m * k * 2 + m * n * 2
                b_ms, b_by = bound(nbytes, 2 * m * k * n)
                kernel = lambda i: W.woq_matmul(x, copies[i % len(copies)])
                library = lambda i: x @ libs[i % len(libs)]
                row = dict(
                    ms=cuda_ms(torch, kernel), graph_ms=graph_ms(torch, kernel),
                    plain_ms=cuda_ms(torch, lambda i: W.woq_matmul_plain(x, st), reps=3, iters=3),
                    library_ms=cuda_ms(torch, library), library_graph_ms=graph_ms(torch, library),
                    bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=2 * m * k * n)
                emit("woq_kernel_time", kernel="woq_matmul", proj=pname, K=k, N=n, M=m,
                     bits=bits, group_size=WOQ_GROUP, route=W.woq_route(m, n, bits), rel_fro=rel,
                     max_abs_err=err, fro_tol=FRO_TOL, twice_bit_identical=same, within=ok,
                     library="x @ the pre-dequantized bf16 weight (torch.matmul)",
                     timing="ms: back-to-back calls by CUDA events; graph_ms: the same calls "
                     "replayed from one CUDA graph (device time)", **row)
                if not ok:
                    fail(f"woq_matmul {pname} bits {bits} M {m}: rel {rel}, bit-identical {same}")
                rows[(pname, bits, m)] = row
                del x
            del copies, libs, w_deq, st
        del w
        torch.cuda.empty_cache()
    # ragged M on the streaming and wgmma routes (N = 4096) and the simt route
    # kept for an N that is no multiple of 16 (N = 1000)
    for n in (4096, 1000):
        w = torch.randn(4096, n, generator=g, device="cuda").mul_(0.02).to(torch.bfloat16)
        for bits in (8, 4, 6):
            st = W.quantize_woq(w, bits, WOQ_GROUP)
            for m in (1, 3, 17, 300):
                x = torch.randn(m, 4096, generator=g, device="cuda").to(torch.bfloat16)
                rel, err, same, counted = held(x, st)
                worst = max(worst, err)
                ok = rel <= FRO_TOL and same and counted
                emit("woq_kernel_check", kernel="woq_matmul", K=4096, N=n, M=m, bits=bits,
                     group_size=WOQ_GROUP, route=W.woq_route(m, n, bits), rel_fro=rel,
                     max_abs_err=err, fro_tol=FRO_TOL, twice_bit_identical=same, within=ok)
                if not ok:
                    fail(f"woq_matmul ragged N {n} M {m} bits {bits}: rel {rel}, "
                         f"bit-identical {same}")
            del st
        del w
    # the crossover: the gate projection with each route forced, by M
    k, n = PROJ["gate"]
    w = torch.randn(k, n, generator=g, device="cuda").mul_(0.02).to(torch.bfloat16)
    cross = {}
    for bits in (8, 4, 6):
        st = W.quantize_woq(w, bits, WOQ_GROUP)
        for m in (4, 8, 12, 16):
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            row = {}
            # the streaming kernel takes up to 16 rows at int8, 8 at int4 / fp6
            for route in (("stream", "wgmma") if m <= (16 if bits == 8 else 8) else ("wgmma",)):
                chosen = W.woq_route
                W.woq_route = lambda *args, r=route, **kw: r
                try:
                    row[route] = graph_ms(torch, lambda i: W.woq_matmul(x, st))
                finally:
                    W.woq_route = chosen
            cross[f"{bits}/{m}"] = row
            del x
        del st
    emit("woq_crossover", proj="gate", K=k, N=n, graph_ms_by_bits_and_M=cross,
         stream_max_m=W.STREAM_MAX_M, note="device time of each route forced; the wrapper "
         "takes the streaming route up to stream_max_m[bits] rows (16 the most it takes)")
    del w
    torch.cuda.empty_cache()
    m = rows[("gate", 8, 4)]
    big = max((key for key in rows if key[2] == 2048),
              key=lambda key: rows[key]["graph_ms"] / rows[key]["library_graph_ms"])
    return {"name": "woq_matmul", "route": "cuda", "source": WOQ_SOURCE,
            "replaces": WOQ_REPLACES, "max_abs_err": worst,
            **{k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "device_ms": m["graph_ms"], "library_device_ms": m["library_graph_ms"],
            "worst_m2048": {"proj": big[0], "bits": big[1], "device_ms": rows[big]["graph_ms"],
                            "library_device_ms": rows[big]["library_graph_ms"],
                            "bound_ms": rows[big]["bound_ms"], "ms": rows[big]["ms"],
                            "library_ms": rows[big]["library_ms"]}}


def _half_step_check(w, deq, scales, gs):
    """The largest |dequantized - w| over its limit (half the group's step
    plus one bf16 rounding of the dequantized value), chunked by groups."""
    wf, df = w.reshape(-1), deq.reshape(-1)
    scales = scales.reshape(-1)
    worst, chunk = 0.0, 1 << 20                       # groups a chunk
    for g0 in range(0, scales.numel(), chunk):
        g1 = min(scales.numel(), g0 + chunk)
        a = wf[g0 * gs:g1 * gs].float().view(-1, gs)
        d = df[g0 * gs:g1 * gs].float().view(-1, gs)
        lim = 0.5 * scales[g0:g1, None] * (1 + 1e-6) + d.abs() * 2.0 ** -8 + 1e-30
        worst = max(worst, float(((d - a).abs() / lim).max()))
    return worst


def quant_path(torch, params, smi):
    """quant_path: the weight-only quantization API on llama3-8b's weights
    (the v1 engine's, bf16). quantize_model_params at bits 8 and 4 over the
    whole tree (one K7 or K8 launch per quantized leaf), resident bytes,
    dequantize_model_params and every dequantized leaf within half a step of
    its group; then QuantizedLinear at bits 8, 4 and 6 on one layer's seven
    projections at M = 4 and 2048, and its SwiGLU MLP against the dense bf16
    one (gate at int8: max |y_q - y| < 0.15 max |y|, the JAX contract).
    Returns the K6, K7 and K8 launches."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.inference.quantization.layers import (QuantizedLinear,
                                                                   QuantizedParameter,
                                                                   dequantize_model_params,
                                                                   quantize_model_params)
    from deepspeed_tpu_torch.models.transformer import layer_slice
    from deepspeed_tpu_torch.ops import quantizer as Q
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths

    dense_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    zero_counts()
    launches = {}
    for bits in (8, 4):
        counter = Q.quantize_int8 if bits == 8 else Q.quantize_int4
        before = (Q.quantize_int8.launches, Q.quantize_int4.launches)
        t0 = time.perf_counter()
        qparams = quantize_model_params(params, bits=bits)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        qleaves = [(p, x) for p, x in tree_paths(qparams) if isinstance(x, QuantizedParameter)]
        n_launch = counter.launches - before[0 if bits == 8 else 1]
        other = (Q.quantize_int4.launches - before[1] if bits == 8
                 else Q.quantize_int8.launches - before[0])
        resident = sum(x.nbytes if isinstance(x, QuantizedParameter)
                       else x.numel() * x.element_size() for x in tree_leaves(qparams))
        t0 = time.perf_counter()
        deq = dequantize_model_params(qparams)
        torch.cuda.synchronize()
        deq_s = time.perf_counter() - t0
        originals = dict(tree_paths(params))
        dequant = dict(tree_paths(deq))
        worst = {}
        for p, x in qleaves:
            worst[p] = _half_step_check(originals[p], dequant[p], x.scales, x.group_size)
            if dequant[p].dtype != originals[p].dtype or dequant[p].shape != originals[p].shape:
                fail(f"quant path: {p} dequantized to {dequant[p].dtype} {tuple(dequant[p].shape)}")
        ok = (n_launch == len(qleaves) and other == 0 and max(worst.values()) <= 1.0)
        emit("quant_path", api="quantize_model_params", bits=bits, group_size=256,
             quantized_leaves=len(qleaves), kernel=counter.__name__, launches=n_launch,
             resident_bytes=resident, dense_bytes=dense_bytes,
             resident_share=resident / dense_bytes, quantize_s=quant_s, dequantize_s=deq_s,
             worst_share_of_half_step=max(worst.values()), per_leaf=worst, within=ok)
        if not ok:
            fail(f"quant path bits {bits}: {n_launch} launches for {len(qleaves)} leaves "
                 f"(other kernel {other}), worst share {max(worst.values())}")
        launches[counter.__name__] = n_launch
        del qparams, deq, dequant, qleaves
        torch.cuda.empty_cache()

    cfg_e = params["embed"]["tok"].shape[1]
    lp = layer_slice(params["layers"], 0)
    attn, mlp = lp["attn"], lp["mlp"]
    mats = {"q": attn["wq"].reshape(cfg_e, -1), "k": attn["wk"].reshape(cfg_e, -1),
            "v": attn["wv"].reshape(cfg_e, -1), "o": attn["wo"].reshape(-1, cfg_e),
            "gate": mlp["wi_gate"], "up": mlp["wi_up"], "down": mlp["wo"]}
    g = torch.Generator(device="cuda").manual_seed(5)
    for bits in (8, 4, 6):
        lins = {nm: QuantizedLinear(w, bits=bits) for nm, w in mats.items()}
        if not all(lin.fused is not None for lin in lins.values()):
            fail(f"QuantizedLinear bits {bits}: a projection took the flat path")
        for m in (4, 2048):
            proj = {}
            for nm, w in mats.items():
                x = torch.randn(m, w.shape[0], generator=g, device="cuda").to(torch.bfloat16)
                y, yq = x @ w, lins[nm](x)
                proj[nm] = float(torch.linalg.vector_norm((yq - y).float())
                                 / torch.linalg.vector_norm(y.float()))
            x = torch.randn(m, cfg_e, generator=g, device="cuda").to(torch.bfloat16)
            y = (F.silu(x @ mats["gate"]) * (x @ mats["up"])) @ mats["down"]
            yq = lins["down"](F.silu(lins["gate"](x)) * lins["up"](x))
            torch.cuda.synchronize()
            max_err = float((yq - y).abs().max().float())
            ratio = max_err / float(y.abs().max().float())
            rel = float(torch.linalg.vector_norm((yq - y).float())
                        / torch.linalg.vector_norm(y.float()))
            ok = math.isfinite(ratio) and (bits != 8 or ratio < 0.15)
            emit("quant_path", api="QuantizedLinear", bits=bits, M=m, group_size=256,
                 projection_rel_fro=proj, mlp_max_abs_over_max=ratio, mlp_rel_fro=rel,
                 gate="max |y_q - y| < 0.15 max |y| at int8", nbytes={
                     nm: lin.nbytes for nm, lin in lins.items()}, within=ok)
            if not ok:
                fail(f"QuantizedLinear SwiGLU bits {bits} M {m}: max err / max |y| = {ratio}")
        del lins
        torch.cuda.empty_cache()
    counts = read_counts()
    path = ("quantize_int8", "quantize_int4", "woq_matmul")
    ok = (all(counts[k] > 0 for k in path) and counts["quantize_int8"] == launches["quantize_int8"]
          and counts["quantize_int4"] == launches["quantize_int4"])
    emit("quant_path_launches", launches_by_kernel=counts, within=ok, card=smi)
    if not ok:
        fail(f"quant path launches {counts}")
    return counts


def v1_phases(torch, smi):
    """The v1 inference and weight-only quantization slice; returns its
    kernel entries."""
    k2 = v1_kernel_phases(torch)
    quant = quant_kernel_phases(torch)
    woq = woq_kernel_phases(torch)
    k2["launches"], eng = v1_main_path(torch, smi)
    launches = quant_path(torch, eng.module_params, smi)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    woq["launches"] = launches["woq_matmul"]
    quant[8]["launches"] = launches["quantize_int8"]
    quant[4]["launches"] = launches["quantize_int4"]
    return [k2, woq, quant[8], quant[4]]


# ------------------------------------------------------------------ ops slice
# block-sparse attention (K11), Evoformer attention (K12), the fp8 quantizer (K9)

SPARSE_SOURCE = "deepspeed_tpu_torch/ops/csrc/sparse_flash.cu"
SPARSE_REPLACES = "deepspeed_tpu/ops/pallas/sparse_flash.py:64"
EVO_SOURCE = "deepspeed_tpu_torch/ops/csrc/evoformer_flash.cu"
EVO_REPLACES = "deepspeed_tpu/ops/pallas/evoformer_flash.py:34"
FP8_SOURCE = "deepspeed_tpu_torch/ops/csrc/fp_quantizer.cu"
FP8_REPLACES = "deepspeed_tpu/ops/pallas/fp_quantizer.py:25"
SPARSE_MODEL = "bert-large"        # its attention width: 16 heads of 64
SPARSE_B, SPARSE_S, SPARSE_BLOCK = 4, 4096, 16   # 8x bert-large's 512 positions
# AlphaFold 2's MSA row attention with pair bias (supplementary Alg. 7,
# Table 4): 8 heads of 32, N_clust 128, N_res crop 256; (B, N, S, H, D)
EVO_AF2 = (1, 128, 256, 8, 32)
# the same 256-wide projection split as 4 heads of 64 at the fine-tuning
# cluster count 512: chosen to reach the kernel, not a published setting
EVO_MAIN = (1, 512, 256, 4, 64)
WI_GATE = (32, 4096, 14336)        # llama3-8b's stacked wi_gate leaf, bf16
FP8_GROUP = 256
FP8_RUNS_GROUP = 100                # no whole 16-byte vectors: K9's route "runs"
FP8_MODES = [(fmt, st) for fmt in ("e4m3", "e5m2") for st in (False, True)]
TILE = 128                         # the sparse layout tables' tile


def sparse_configs(h):
    """The three layouts of the main path at block 16: Fixed (4 local, 1
    global), BSLongformer and BigBird at their defaults, bidirectional."""
    from deepspeed_tpu_torch.ops import sparse_attention as SA
    return {"fixed": SA.FixedSparsityConfig(num_heads=h, block=SPARSE_BLOCK,
                                            num_local_blocks=4, num_global_blocks=1),
            "bslongformer": SA.BSLongformerSparsityConfig(num_heads=h, block=SPARSE_BLOCK),
            "bigbird": SA.BigBirdSparsityConfig(num_heads=h, block=SPARSE_BLOCK)}


def randn_bf16(torch, g, *shape):
    return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)


def compare(torch, got, ref):
    """(max |got - ref|, relative Frobenius error, every element within
    ATOL + RTOL |ref|), in f32."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
    return float(err.max()), rel, bool((err <= ATOL + RTOL * ref.abs()).all())


def sparse_inputs(torch, *, b, s, h, kvh, d, layout, causal, seed, block=SPARSE_BLOCK):
    """bf16 q (B, S, H, D) and k, v repeated to H heads (as
    sparse_flash_attention hands them to the kernel), with the layout's
    tables (layout blocks of ``block`` tokens) on the card and its tile
    masks packed to bits."""
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = randn_bf16(torch, g, b, s, h, d), randn_bf16(torch, g, b, s, kvh, d), \
        randn_bf16(torch, g, b, s, kvh, d)
    k, v = k.repeat_interleave(h // kvh, dim=2), v.repeat_interleave(h // kvh, dim=2)
    table, counts, masks = SF.precompile_layout(layout, block, causal)
    return dict(q=q, k=k, v=v, table=table, counts=counts, bits=SF.pack_mask_bits(masks),
                scale=d ** -0.5, causal=causal)


def sparse_call(fn, c):
    return fn(c["q"], c["k"], c["v"], c["table"], c["counts"], c["bits"], c["scale"])


def sparse_pairs(c):
    """The (query, key) pairs the layout lets through: the set bits of the
    live tiles' masks, padding slots excluded."""
    import torch
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    ma = c["table"].shape[1]
    valid = torch.arange(ma, device=c["counts"].device)[None, :] < c["counts"][:, None]
    return int(SF.unpack_mask_bits(c["bits"])[valid].sum())


def sparse_work(c):
    """(bytes, flops): q, k, v read and out written once, table and counts,
    the bits of each live tile (2 KB) once; 4 D flops per (query, key) pair
    that the token mask lets through, and no more (the kernel computes the
    pairs of every live 16-key block it gathers)."""
    b, s, h, d = c["q"].shape
    live = int(c["counts"].sum())
    nbytes = 4 * b * s * h * d * 2 + 4 * (c["table"].numel() + c["counts"].numel()) \
        + live * TILE * TILE // 8
    return nbytes, 4 * d * sparse_pairs(c) * b * h


def evo_inputs(torch, shape, *, biases="both", bias_dtype=None, seed=0, spare_rows=0):
    """bf16 q, k, v (B, N, S, H, D) as head-major views (as
    DS4Sci_EvoformerAttention hands them to the kernel), a mask bias with
    -1e9 at a tenth of the keys and one MSA row fully masked, and a pair
    bias, both f32 unless ``bias_dtype``. ``spare_rows`` > 0: q, k, v are
    the first N rows of storage with N + spare_rows, so that their batch
    stride is no multiple of their row stride."""
    b, n, s, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (randn_bf16(torch, g, b, n + spare_rows, s, h, d)[:, :n].movedim(3, 2)
               for _ in range(3))
    b1 = b2 = None
    if biases in ("b1", "both"):
        b1 = torch.where(torch.rand(b, n, 1, 1, s, generator=g, device="cuda") < 0.1, -1e9, 0.0)
        b1[:, -1] = -1e9
    if biases == "both":
        b2 = torch.randn(b, 1, h, s, s, generator=g, device="cuda")
    if bias_dtype is not None:
        b1, b2 = (None if t is None else t.to(bias_dtype) for t in (b1, b2))
    return dict(q=q, k=k, v=v, b1=b1, b2=b2, scale=d ** -0.5)


def evo_call(fn, c):
    return fn(c["q"], c["k"], c["v"], c["b1"], c["b2"], scale=c["scale"])


def evo_work(c):
    """(bytes, flops): q, k, v read and out written once, each bias read
    once (as stored); 4 D flops per (query, key) pair."""
    b, n, h, s, d = c["q"].shape
    nbytes = 4 * b * n * h * s * d * 2 + sum(t.numel() * t.element_size()
                                             for t in (c["b1"], c["b2"]) if t is not None)
    return nbytes, 4 * d * s * s * b * n * h


def fp8_probe(torch, dtype, seed=0):
    """(2048, 4096) in ``dtype``: rows at magnitudes spread over e^+-6, an
    all-zero group, groups at scale exactly 1 holding every tie between
    neighbouring e4m3 / e5m2 values that the dtype represents, and a group
    spanning the dtype's whole range, from its least subnormal to half its
    largest value (K9 divides such tiny elements with __fdiv_rn)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(2048, 4096, generator=g, device="cuda") * torch.exp(
        torch.rand(2048, 1, generator=g, device="cuda") * 12 - 6)
    x[5, :FP8_GROUP] = 0
    for row, (fp8, fmax) in ((7, (torch.float8_e4m3fn, 448.0)), (9, (torch.float8_e5m2, 57344.0))):
        vals = torch.arange(256, dtype=torch.uint8, device="cuda").view(fp8).float()
        grid = vals[torch.isfinite(vals) & (vals >= 0)].unique()
        mids = ((grid[:-1] + grid[1:]) / 2).to(dtype).float()     # < 127 of them
        x[row, :FP8_GROUP] = 0
        x[row, :mids.numel()] = mids
        x[row, FP8_GROUP - 1] = fmax                    # the group's absmax: scale 1
    fi = torch.finfo(dtype)
    span = torch.exp2(torch.linspace(math.log2(fi.tiny * fi.eps), math.log2(fi.max) - 1, FP8_GROUP,
                                     device="cuda"))
    x[11, :FP8_GROUP] = span * (1 - 2 * (torch.arange(FP8_GROUP, device="cuda") % 2))
    return x.to(dtype)


def fp8_diff(torch, q, s, pq, ps):
    return (int((q.reshape(-1).view(torch.uint8) != pq.reshape(-1).view(torch.uint8)).sum()),
            int((s.reshape(-1).view(torch.int32) != ps.reshape(-1).view(torch.int32)).sum()))


def fp8_held(torch, FQ, x, gs, fmt, st, seed, case, **extra):
    """K9 on ``x`` once through ``quantize_fp8`` against its plain version
    on the same inputs: codes and scales byte-identical and one launch; when
    stochastic, the codes also byte-identical to the float law's."""
    before = FQ.quantize_fp8.launches
    q, s = FQ.quantize_fp8(x, gs, fmt, st, seed=seed)
    torch.cuda.synchronize()
    launched = FQ.quantize_fp8.launches - before
    pq, ps = FQ.quantize_fp8_plain(x, gs, fmt, st, seed)
    diff_q, diff_s = fp8_diff(torch, q, s, pq, ps)
    del pq
    row = dict(differing_q_bytes=diff_q, differing_scales=diff_s, launches=launched)
    if st:
        lq, _ = FQ.quantize_fp8_plain(x, gs, fmt, st, seed, law=True)
        row["differing_law_bytes"] = fp8_diff(torch, q, s, lq, ps)[0]
        del lq
    ok = launched == 1 and not any(v for k, v in row.items() if k != "launches")
    emit("ops_kernel_check", kernel="quantize_fp8",
         case=f"{case}_{fmt}_{'stochastic' if st else 'nearest'}", dtype=str(x.dtype),
         shape=list(x.shape), group_size=gs, **extra, **row, within=ok)
    if not ok:
        fail(f"quantize_fp8 {case} {x.dtype} {fmt} stochastic={st}: {row}")


def fp8_kernel_check(torch):
    """K9 against its plain version on the card, bytes compared: the probe
    in f32, bf16 and f16 at group 256 (route "regs"); a group of 100 (no
    whole vectors) on an x one element off a 16-byte boundary (route
    "runs"), in the three dtypes; groups of 8, 64, 1024 and 2048 bf16 and
    1024 f32 (route "regs" from one lane a group to 8 vectors a lane over
    32 lanes); each in the four modes, stochastic codes also against the
    float law; then llama3-8b's stacked wi_gate leaf, every layer when
    rounding to nearest, the first and last layers (global Philox counters)
    when stochastic. Returns the worst error (0: every byte agrees)."""
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = fp8_probe(torch, dtype)
        for fmt, st in FP8_MODES:
            fp8_held(torch, FQ, x, FP8_GROUP, fmt, st, 11, "probe")
        flat = x.reshape(-1)
        runs = flat[1:1 + FP8_RUNS_GROUP * 8192]        # one element past 16-byte alignment
        for fmt, st in FP8_MODES:
            fp8_held(torch, FQ, runs, FP8_RUNS_GROUP, fmt, st, 12, "runs_offset1",
                     address_mod16=runs.data_ptr() % 16)
        for gs in {torch.bfloat16: (8, 64, 1024, 2048), torch.float32: (1024,)}.get(dtype, ()):
            for fmt, st in FP8_MODES:
                fp8_held(torch, FQ, flat[:1 << 21], gs, fmt, st, 13, f"regs_group{gs}")
        del x, flat, runs
    g = torch.Generator(device="cuda").manual_seed(3)
    w = torch.randn(*WI_GATE, generator=g, device="cuda", dtype=torch.bfloat16).mul_(0.02)
    per_layer = WI_GATE[1] * WI_GATE[2]
    for fmt, st in FP8_MODES:
        q, s = FQ.quantize_fp8(w, FP8_GROUP, fmt, st, seed=5)
        layers = [0, WI_GATE[0] - 1] if st else range(WI_GATE[0])
        diff_q = diff_s = 0
        for li in layers:
            pq, ps = FQ.quantize_fp8_plain(w[li], FP8_GROUP, fmt, st, 5, index0=li * per_layer)
            g0 = li * per_layer // FP8_GROUP
            dq, ds = fp8_diff(torch, q[li], s[g0:g0 + per_layer // FP8_GROUP], pq, ps)
            diff_q, diff_s = diff_q + dq, diff_s + ds
            del pq, ps
        ok = diff_q == diff_s == 0
        emit("ops_kernel_check", kernel="quantize_fp8", case=f"wi_gate_{fmt}_"
             f"{'stochastic' if st else 'nearest'}", dtype="torch.bfloat16", shape=list(WI_GATE),
             layers_compared=len(layers), differing_q_bytes=diff_q, differing_scales=diff_s,
             within=ok)
        if not ok:
            fail(f"quantize_fp8 wi_gate {fmt} stochastic={st}: {diff_q} codes, {diff_s} scales differ")
        del q, s
        torch.cuda.empty_cache()
    del w
    torch.cuda.empty_cache()
    return 0.0


def ops_kernel_check(torch):
    """K11, K12 and K9 against their plain versions on the card. Returns
    the worst error of each kernel."""
    import numpy as np
    from deepspeed_tpu_torch.ops import evoformer_flash as EF
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    worst = {"sparse_flash_fwd": 0.0, "evoformer_flash_fwd": 0.0, "quantize_fp8": 0.0}

    def held(kernel, case, shape, call, fn, plain, c, extra=None):
        """``call(fn, c)`` through the kernel's wrapper, twice (the second
        run bit-identical to the first), against ``call(plain, c)`` on the
        same inputs."""
        before = fn.launches
        got = call(fn, c)
        again = call(fn, c)
        torch.cuda.synchronize()
        launched = fn.launches - before
        same = bool(torch.equal(got.contiguous().view(torch.int16),
                                again.contiguous().view(torch.int16)))
        ref = call(plain, c)
        err, rel, ok = compare(torch, got, ref)
        ok = ok and rel <= FRO_TOL and launched == 2 and same and bool(torch.isfinite(got).all())
        extra = extra(got, ref) if extra else {}
        ok = ok and all(extra.values())
        worst[kernel] = max(worst[kernel], err)
        emit("ops_kernel_check", kernel=kernel, case=case, shape=shape, max_abs_err=err,
             rel_fro=rel, atol=ATOL, rtol=RTOL, fro_tol=FRO_TOL, launches=launched,
             bit_identical_rerun=same, within=ok, **extra)
        if not ok:
            fail(f"{kernel} {case}: max_abs_err {err}, rel_fro {rel}, launches {launched}, "
                 f"rerun bit-identical {same}, {extra}")

    # both kernels are the Hopper forward (flash_fwd_wgmma.cuh) at every head dim
    for module, dims in ((SF, SF.KERNEL_HEAD_DIMS), (EF, EF.KERNEL_HEAD_DIMS)):
        for dd in dims:
            info = module.kernel_info("fwd", dd)
            emit("ops_kernel_check", kernel=module.__name__.rsplit(".", 1)[1], case=f"kernel_info_d{dd}",
                 within=info["variant"] == "wgmma", **info)
            if info["variant"] != "wgmma":
                fail(f"{module.__name__} at D = {dd}: {info}, not the wgmma kernel")

    h, d = 16, 64
    for name, cfg in sparse_configs(h).items():
        for causal, (b, s) in ((False, (SPARSE_B, SPARSE_S)), (True, (2, 2048))):
            c = sparse_inputs(torch, b=b, s=s, h=h, kvh=h, d=d, layout=cfg.make_layout(s),
                              causal=causal, seed=1)
            held("sparse_flash_fwd", f"{name}_{'causal' if causal else 'bidirectional'}",
                 dict(B=b, S=s, H=h, D=d, live_tiles=int(c["counts"].sum())),
                 sparse_call, SF.sparse_flash_fwd, SF.sparse_flash_plain, c)
    # GQA at D = 128, and a random layout with empty block rows: a query tile
    # with no live key tile and rows that see no key must come out 0
    rng = np.random.default_rng(0)
    rand_layout = rng.random((64, 64)) < 0.2
    rand_layout[:8] = False
    rand_layout[20] = False
    for case, kw in (("bigbird_gqa_d128_causal",
                      dict(b=2, s=1024, h=16, kvh=4, d=128,
                           layout=sparse_configs(16)["bigbird"].make_layout(1024), causal=True)),
                     ("random_empty_rows_d128",
                      dict(b=1, s=1024, h=4, kvh=4, d=128, layout=rand_layout, causal=False))):
        c = sparse_inputs(torch, seed=2, **kw)
        empty = torch.from_numpy(np.repeat(~kw["layout"].any(axis=1), SPARSE_BLOCK)).cuda()
        held("sparse_flash_fwd", case, dict(B=kw["b"], S=kw["s"], H=kw["h"], KVH=kw["kvh"],
                                            D=kw["d"], live_tiles=int(c["counts"].sum())),
             sparse_call, SF.sparse_flash_fwd, SF.sparse_flash_plain, c,
             extra=lambda got, ref: {"empty_rows_zero": bool((got[:, empty] == 0).all())})
    # the three layouts at D = 128; Fixed at layout blocks of 32 and 64 (its
    # 16-key blocks come in runs); a causal Fixed layout, whose diagonal
    # blocks are partial
    from deepspeed_tpu_torch.ops import sparse_attention as SA
    s2 = 2048
    cases = [(f"{name}_d128", cfg.make_layout(s2), SPARSE_BLOCK, False, 128)
             for name, cfg in sparse_configs(h).items()]
    for blk in (32, 64):
        cfg = SA.FixedSparsityConfig(num_heads=h, block=blk, num_local_blocks=4,
                                     num_global_blocks=1)
        cases.append((f"fixed_block{blk}", cfg.make_layout(s2), blk, False, 64))
    cfg = SA.FixedSparsityConfig(num_heads=h, block=SPARSE_BLOCK, num_local_blocks=4,
                                 num_global_blocks=1, attention="unidirectional")
    cases.append(("fixed_unidirectional_causal", cfg.make_layout(s2), SPARSE_BLOCK, True, 64))
    for case, layout, blk, causal, dd in cases:
        c = sparse_inputs(torch, b=2, s=s2, h=h, kvh=h, d=dd, layout=layout, causal=causal,
                          seed=3, block=blk)
        kb = SF.key_blocks_of(c["table"], c["counts"], c["bits"])
        held("sparse_flash_fwd", case, dict(B=2, S=s2, H=h, D=dd, block=blk,
                                            stages=int(kb.stage_start[-1]),
                                            full_stages=int(kb.full.sum())),
             sparse_call, SF.sparse_flash_fwd, SF.sparse_flash_plain, c)
    torch.cuda.empty_cache()

    for d in (64, 128, 256):
        for biases in ("none", "b1", "both"):
            c = evo_inputs(torch, (1, 4, 256, 4, d), biases=biases, seed=d)
            held("evoformer_flash_fwd", f"d{d}_{biases}", dict(B=1, N=4, S=256, H=4, D=d),
                 evo_call, EF.evoformer_flash_fwd, EF.evoformer_flash_plain, c)
    for case, shape, kw in (("main_path", EVO_MAIN, {}),
                            ("s512_bf16_biases", (1, 2, 512, 2, 128), dict(bias_dtype=torch.bfloat16)),
                            ("s128_one_stage", (1, 4, 128, 4, 64), {}),
                            ("strides_unfolded_b2_n3", (2, 3, 256, 4, 64), dict(spare_rows=1))):
        c = evo_inputs(torch, shape, seed=3, **kw)
        held("evoformer_flash_fwd", case, dict(zip("BNSHD", shape)),
             evo_call, EF.evoformer_flash_fwd, EF.evoformer_flash_plain, c)
    # an MSA row whose mask bias is -inf everywhere outputs 0 (the row of
    # -1e9 in every case above averages V)
    for d in (64, 256):
        c = evo_inputs(torch, (1, 4, 256, 4, d), seed=4)
        c["b1"][:, 1] = float("-inf")
        held("evoformer_flash_fwd", f"d{d}_minus_inf_row", dict(B=1, N=4, S=256, H=4, D=d),
             evo_call, EF.evoformer_flash_fwd, EF.evoformer_flash_plain, c,
             extra=lambda got, ref: {"minus_inf_row_zero": bool((got[:, 1] == 0).all())})
    torch.cuda.empty_cache()

    worst["quantize_fp8"] = fp8_kernel_check(torch)
    return worst


def ops_kernel_time(torch):
    """K11 on the three layouts, K12 and K9 at the main path's shapes:
    kernel, plain version and one library call by CUDA events, beside the
    card's bound. Returns the rows by kernel and case."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops import evoformer_flash as EF
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    rows = {}
    h, d = 16, 64
    for name, cfg in sparse_configs(h).items():
        layout = cfg.make_layout(SPARSE_S)
        c = sparse_inputs(torch, b=SPARSE_B, s=SPARSE_S, h=h, kvh=h, d=d, layout=layout,
                          causal=False, seed=4)
        token = SF.token_mask_from_tiles(c["table"], c["counts"], c["bits"])
        qh, kh, vh = (c[x].transpose(1, 2) for x in "qkv")
        nbytes, flops = sparse_work(c)
        b_ms, b_by = bound(nbytes, flops)
        kb = SF.key_blocks_of(c["table"], c["counts"], c["bits"])
        row = dict(ms=cuda_ms(torch, lambda i: sparse_call(SF.sparse_flash_fwd, c)),
                   plain_ms=cuda_ms(torch, lambda i: sparse_call(SF.sparse_flash_plain, c),
                                    reps=2, iters=1),
                   library_ms=cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                       qh, kh, vh, attn_mask=token), reps=3, iters=5),
                   bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                   live_tiles=int(c["counts"].sum()), tiles=(SPARSE_S // TILE) ** 2,
                   fine_density=sparse_pairs(c) / SPARSE_S ** 2,
                   stages=int(kb.stage_start[-1]), full_stages=int(kb.full.sum()))
        row["tflops"] = flops / row["ms"] / 1e9
        emit("ops_kernel_time", kernel="sparse_flash_fwd", case=name,
             shape=dict(B=SPARSE_B, S=SPARSE_S, H=h, D=d, dtype="bfloat16"),
             library="F.scaled_dot_product_attention with the (S, S) boolean token mask", **row)
        rows[("sparse_flash_fwd", name)] = row
        del c, token, qh, kh, vh
        torch.cuda.empty_cache()

    c = evo_inputs(torch, EVO_MAIN, seed=5)
    b, n, s, hh, dd = EVO_MAIN
    qf, kf, vf = (c[x].reshape(b * n, hh, s, dd) for x in "qkv")
    bias = (c["b1"].reshape(b * n, 1, 1, s) + c["b2"].reshape(b, hh, s, s).repeat_interleave(n, 0)
            ).to(torch.bfloat16)
    nbytes, flops = evo_work(c)
    b_ms, b_by = bound(nbytes, flops)
    row = dict(ms=cuda_ms(torch, lambda i: evo_call(EF.evoformer_flash_fwd, c)),
               plain_ms=cuda_ms(torch, lambda i: evo_call(EF.evoformer_flash_plain, c),
                                reps=3, iters=3),
               library_ms=cuda_ms(torch, lambda i: F.scaled_dot_product_attention(
                   qf, kf, vf, attn_mask=bias, scale=dd ** -0.5)),
               bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops)
    row["tflops"] = flops / row["ms"] / 1e9
    emit("ops_kernel_time", kernel="evoformer_flash_fwd", case="main_path",
         shape=dict(zip("BNSHD", EVO_MAIN)), library="F.scaled_dot_product_attention with "
         "b1 + b2 summed beforehand into a (B*N, H, S, S) bf16 mask", **row)
    rows[("evoformer_flash_fwd", "main_path")] = row
    del c, qf, kf, vf, bias
    torch.cuda.empty_cache()

    rows.update(fp8_kernel_time(torch))
    return rows


def fp8_work(n_el, stochastic):
    """(bytes, f32 operations, 32-bit integer multiplies) of K9 on ``n_el``
    bf16 elements at group FP8_GROUP: x read and the codes and scales
    written once; absmax, divide and convert (4 f32 operations an element);
    stochastic adds a quarter of a Philox4x32-10 call an element, whose ten
    rounds take two 32 x 32 -> 64-bit products each (the low and the high
    word: 4 multiplies), so 10 multiplies an element."""
    return 2 * n_el + n_el + 4 * (n_el // FP8_GROUP), 4 * n_el, (10 * n_el if stochastic else 0)


def fp8_bound(n_el, stochastic):
    """K9's bound (ms), what bounds it ("bytes" or "operations") and the
    term ("bytes", "f32 operations" or "integer multiplies"), with each
    term's ms."""
    nbytes, flops, muls = fp8_work(n_el, stochastic)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "f32 operations": flops / F32_FLOPS * 1e3,
             "integer multiplies": muls / INT32_MULS * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], ("bytes" if term == "bytes" else "operations"), term, terms


def fp8_kernel_time(torch):
    """K9 on the wi_gate leaf in the four modes by CUDA events, beside its
    plain version (one layer at a time) and its bound. Returns the rows by
    (kernel, case)."""
    from deepspeed_tpu_torch.ops import fp_quantizer as FQ
    rows = {}
    g = torch.Generator(device="cuda").manual_seed(6)
    w = torch.randn(*WI_GATE, generator=g, device="cuda", dtype=torch.bfloat16).mul_(0.02)
    n_el, per_layer = w.numel(), WI_GATE[1] * WI_GATE[2]
    for fmt, st in FP8_MODES:
        nbytes, flops, muls = fp8_work(n_el, st)
        b_ms, b_by, b_term, terms = fp8_bound(n_el, st)

        def plain_leaf(i):
            for li in range(WI_GATE[0]):
                FQ.quantize_fp8_plain(w[li], FP8_GROUP, fmt, st, 5, index0=li * per_layer)

        row = dict(ms=cuda_ms(torch, lambda i: FQ.quantize_fp8(w, FP8_GROUP, fmt, st, seed=5),
                              reps=5, iters=5),
                   plain_ms=cuda_ms(torch, plain_leaf, reps=1, iters=1),
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, bound_term=b_term,
                   bound_terms_ms=terms, bytes=nbytes, flops=flops, int_muls=muls)
        case = f"{fmt}_{'stochastic' if st else 'nearest'}"
        emit("ops_kernel_time", kernel="quantize_fp8", case=case, leaf="layers.mlp.wi_gate",
             shape=list(WI_GATE), library="none: no single PyTorch call computes it",
             plain="one layer at a time over the leaf", **row)
        rows[("quantize_fp8", case)] = row
        torch.cuda.empty_cache()
    del w
    torch.cuda.empty_cache()
    return rows


def timed_ms(torch, fn):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def fp8_step(torch, a, fmt):
    """The spacing of fp8 values at magnitude a (>= the spacing just below)."""
    mbits, emin = (3, -6) if fmt == "e4m3" else (2, -14)
    e = torch.floor(torch.log2(torch.clamp(a, min=2.0 ** emin)))
    return torch.exp2(e - mbits)


def ops_path(torch, smi):
    """ops_path: the three public entry points at their main-path shapes,
    with every kernel count set to 0 before and read after. Returns the
    launches by kernel."""
    from deepspeed_tpu_torch.models.config import PRESETS
    from deepspeed_tpu_torch.ops import (DS4Sci_EvoformerAttention, SparseSelfAttention,
                                         dequantize_fp8, quantize_fp8)
    from deepspeed_tpu_torch.ops.evoformer import _chunked
    bert = PRESETS[SPARSE_MODEL]
    h, d = bert.num_heads, bert.hidden_size // bert.num_heads
    calls = {"sparse_flash_fwd": 0, "evoformer_flash_fwd": 0, "quantize_fp8": 0}
    g = torch.Generator(device="cuda").manual_seed(7)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()

    # (a) SparseSelfAttention at bert-large's attention width, S = 4096
    q, k, v = (randn_bf16(torch, g, SPARSE_B, SPARSE_S, h, d).requires_grad_() for _ in range(3))
    cot = randn_bf16(torch, g, SPARSE_B, SPARSE_S, h, d)
    # one untimed forward and backward first: the first dense recompute
    # pays one-time allocator and library set-up (3.1 s in a first reading)
    SparseSelfAttention(sparse_configs(h)["bslongformer"])(q, k, v).backward(cot)
    calls["sparse_flash_fwd"] += 1
    for t in (q, k, v):
        t.grad = None
    for name, cfg in sparse_configs(h).items():
        attn = SparseSelfAttention(cfg, max_seq_length=SPARSE_S)
        with torch.no_grad():
            attn(q, k, v)                                   # warm-up: layout tables built
            fwd = statistics.median(timed_ms(torch, lambda: attn(q, k, v))[0] for _ in range(3))
        out = attn(q, k, v)
        calls["sparse_flash_fwd"] += 5
        bwd_ms, _ = timed_ms(torch, lambda: out.backward(cot))
        grads_finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
        with torch.no_grad():
            dense = attn(q, k, v, use_kernel=False)         # the dense masked form
        err, rel, ok = compare(torch, out.detach(), dense)
        live = int(attn.config.make_layout(SPARSE_S).reshape(
            SPARSE_S // TILE, TILE // SPARSE_BLOCK, SPARSE_S // TILE, TILE // SPARSE_BLOCK)
            .any(axis=(1, 3)).sum())
        ok = ok and rel <= FRO_TOL and grads_finite and out.shape == q.shape
        emit("ops_path", api="SparseSelfAttention", model=SPARSE_MODEL, layout=name,
             shape=dict(B=SPARSE_B, S=SPARSE_S, H=h, D=d, dtype="bfloat16", block=SPARSE_BLOCK),
             live_tiles=live, tiles=(SPARSE_S // TILE) ** 2, forward_ms=fwd, backward_ms=bwd_ms,
             grads_finite=grads_finite, vs_dense_max_abs_err=err, vs_dense_rel_fro=rel,
             within=ok)
        if not ok:
            fail(f"SparseSelfAttention {name}: vs dense {err} / {rel}, grads finite {grads_finite}")
        for t in (q, k, v):
            t.grad = None
        del out, dense
        torch.cuda.empty_cache()
    del q, k, v, cot

    # (b) DS4Sci_EvoformerAttention: AF2's MSA row attention (D = 32: the
    # chunked route, no K12), then the kernel's 4 x 64 split
    for name, shape, launches in (("af2_msa_row_d32", EVO_AF2, 0), ("heads4x64_n512", EVO_MAIN, 5)):
        b, n, s, hh, _ = shape
        q, k, v = (randn_bf16(torch, g, *shape).requires_grad_() for _ in range(3))
        b1 = torch.where(torch.rand(b, n, 1, 1, s, generator=g, device="cuda") < 0.1, -1e9, 0.0)
        b2 = torch.randn(b, 1, hh, s, s, generator=g, device="cuda")
        b1.requires_grad_()
        b2.requires_grad_()
        with torch.no_grad():
            DS4Sci_EvoformerAttention(q, k, v, [b1, b2])
            fwd = statistics.median(timed_ms(torch, lambda: DS4Sci_EvoformerAttention(
                q, k, v, [b1, b2]))[0] for _ in range(3))
        out = DS4Sci_EvoformerAttention(q, k, v, [b1, b2])
        calls["evoformer_flash_fwd"] += launches
        bwd_ms, _ = timed_ms(torch, lambda: out.backward(torch.ones_like(out)))
        grads_finite = all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v, b1, b2))
        with torch.no_grad():
            ref = _chunked(q, k, v, b1, b2, 256)            # the chunked torch route
        err, rel, ok = compare(torch, out.detach(), ref)
        ok = ok and rel <= FRO_TOL and grads_finite
        emit("ops_path", api="DS4Sci_EvoformerAttention", case=name, shape=dict(zip("BNSHD", shape)),
             dtype="bfloat16", biases=["mask (B, N, 1, 1, S)", "pair (B, 1, H, S, S)"],
             route="K12 forward, chunked backward" if launches else "chunked (D not eligible)",
             forward_ms=fwd, backward_ms=bwd_ms, grads_finite=grads_finite,
             vs_chunked_max_abs_err=err, vs_chunked_rel_fro=rel, within=ok)
        if not ok:
            fail(f"DS4Sci_EvoformerAttention {name}: vs chunked {err} / {rel}, "
                 f"grads finite {grads_finite}")
        del q, k, v, b1, b2, out, ref
        torch.cuda.empty_cache()

    # (c) quantize_fp8 on llama3-8b's wi_gate leaf, four modes; dequantized
    # within half an fp8 step of x (nearest) or one step (stochastic), in
    # units of the scale
    w = torch.randn(*WI_GATE, generator=g, device="cuda", dtype=torch.bfloat16).mul_(0.02)
    per_layer = WI_GATE[1] * WI_GATE[2]
    for fmt, st in FP8_MODES:
        ms, (qc, sc) = timed_ms(torch, lambda: quantize_fp8(w, FP8_GROUP, fmt, st, seed=9))
        calls["quantize_fp8"] += 1
        worst = 0.0
        for li in range(WI_GATE[0]):
            s_l = sc[li * per_layer // FP8_GROUP:(li + 1) * per_layer // FP8_GROUP]
            x = w[li].float().reshape(-1, FP8_GROUP)
            deq = dequantize_fp8(qc[li], s_l, torch.float32, FP8_GROUP).reshape(-1, FP8_GROUP)
            # the step's share, plus the f32 roundings of x / scale and of
            # code * scale (2^-24 of each magnitude, doubled)
            lim = ((0.5 if not st else 1.0) * fp8_step(torch, x.abs() / s_l, fmt) * s_l
                   + 2.0 ** -23 * (x.abs() + deq.abs()))
            worst = max(worst, float(((deq - x).abs() / (lim + 1e-30)).max()))
        ok = worst <= 1.0 and qc.shape == w.shape
        emit("ops_path", api="quantize_fp8", leaf="layers.mlp.wi_gate", shape=list(WI_GATE),
             fmt=fmt, stochastic=st, group_size=FP8_GROUP, ms=ms,
             worst_err_over_limit=worst, limit="half a step" if not st else "one step",
             within=ok)
        if not ok:
            fail(f"quantize_fp8 {fmt} stochastic={st}: round trip {worst} of its limit")
        del qc, sc
        torch.cuda.empty_cache()
    del w
    counts = {name: read_counts()[name] for name in calls}
    ok = counts == calls and all(v == 0 for n_, v in read_counts().items() if n_ not in calls)
    emit("ops_path_launches", launches_by_kernel=counts, calls=calls, within=ok,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, card=smi)
    if not ok:
        fail(f"ops path launches {counts}, calls {calls}")
    return counts


def ops_phases(torch, smi):
    """The block-sparse, Evoformer and fp8 slice; returns its kernel
    entries."""
    worst = ops_kernel_check(torch)
    rows = ops_kernel_time(torch)
    launches = ops_path(torch, smi)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = []
    for name, source, replaces, case in (
            ("sparse_flash_fwd", SPARSE_SOURCE, SPARSE_REPLACES, "bslongformer"),
            ("evoformer_flash_fwd", EVO_SOURCE, EVO_REPLACES, "main_path"),
            ("quantize_fp8", FP8_SOURCE, FP8_REPLACES, "e4m3_stochastic")):
        row = rows[(name, case)]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": worst[name],
                        **{k: row[k] for k in keys}, "case": case,
                        "shapes": {c: {k: r[k] for k in keys} for (n_, c), r in rows.items()
                                   if n_ == name}})
    return entries


# ------------------------------------------------ ring (sequence-parallel) slice

RING_SOURCE = "deepspeed_tpu_torch/ops/csrc/ring_flash.cu"
RING_REPLACES = {"ring_fwd_step": "deepspeed_tpu/sequence/ring_flash.py:70",
                 "ring_dq_step": "deepspeed_tpu/sequence/ring_flash.py:180",
                 "ring_dkv_step": "deepspeed_tpu/sequence/ring_flash.py:237"}
RING_KINDS = {"ring_fwd_step": "fwd", "ring_dq_step": "dq", "ring_dkv_step": "dkv"}  # kernel_info
RING_MODEL, RING_LAYERS = "qwen2-7b", 4     # 28 layers with Adam state do not fit one card
RING_SEQ, RING_SHARDS = 32768, 4             # the preset's max_seq_len over 4 shards
RING_SHARD = RING_SEQ // RING_SHARDS
RING_H, RING_KVH, RING_D = 28, 4, 128        # qwen2-7b attention (group of 7)
RING_WARM, RING_TIMED = 1, 3
# step kinds at the shard shapes: (q_off, k_off) of one rank of the ring
RING_STEPS = {"diagonal": (RING_SHARD, RING_SHARD), "below": (2 * RING_SHARD, RING_SHARD),
              "above": (RING_SHARD, 2 * RING_SHARD)}


# the libraries with wgmma kernels: the module whose kernel_info describes
# them, and the wgmma kernels each must have at D 64 and 128
WGMMA_LIBS = {
    "ring_flash": ("deepspeed_tpu_torch.sequence.ring_flash",
                   ("ring_fwd_wgmma", "ring_dq_wgmma", "ring_dkv_wgmma")),
    "flash_attention": ("deepspeed_tpu_torch.ops.flash_attention",
                        ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma")),
    "sparse_flash": ("deepspeed_tpu_torch.ops.sparse_flash", ("sparse_fwd_wgmma",)),
    "evoformer_flash": ("deepspeed_tpu_torch.ops.evoformer_flash", ("evo_fwd_wgmma",)),
}


def decode_woq_build_report(op_builder, lib):
    """Registers, stack and spills of each kernel of K1 (paged_attention),
    K2 (decode_attention) or K6 (woq_matmul) from the build's ptxas report,
    and its HGMMA (wgmma) instructions from ``cuobjdump --dump-sass``; K1's
    also its dynamic shared memory and threads a block (kernel_info). Fails
    unless K6's wgmma route (woq_wgmma<bits, tile rows>) and K1's wgmma
    route (paged_fwd_wgmma<D>, mode PAGED) issue HGMMA and spill nothing at
    each instantiation, and K2's decode kernel and K1's split route
    (paged_split<D>) spill nothing at any head dim."""
    import re
    from pathlib import Path
    if lib not in op_builder.BUILD_LOGS:   # reused from an earlier run: rebuild
        (op_builder.BUILD_DIR / f"lib{lib}.so").unlink()
        op_builder.build([lib])

    def short(mangled):
        m = re.search(r"(woq_wgmma|woq_stream|woq_kernel|splitk_sum_kernel|decode_kernel|"
                      r"paged_split|paged_fwd_wgmma)"
                      r"(?:ILi(\d+)E(?:Li(\d+)E)?)?", mangled)
        if m is None:
            return mangled
        args = ",".join(a for a in m.groups()[1:] if a)
        return f"{m.group(1)}<{args}>" if args else m.group(1)

    rows, name = {}, None
    for ln in op_builder.BUILD_LOGS[lib].splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = short(m.group(1))
            rows[name] = {}
        elif name and "spill stores" in ln:
            st, ss, sl = map(int, re.findall(r"(\d+) bytes", ln)[:3])
            rows[name].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif name and "Used" in ln and "registers" in ln:
            rows[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    sass = subprocess.run(
        [str(Path(op_builder.nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(op_builder.BUILD_DIR / f"lib{lib}.so")],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump exit {sass.returncode}: {sass.stderr.strip()[-500:]}")
    name = None
    for ln in sass.stdout.splitlines():
        if "Function :" in ln:
            name = short(ln.split("Function :")[1].strip())
            rows.setdefault(name, {})["hgmma"] = 0
        elif name and "HGMMA" in ln:
            rows[name]["hgmma"] += 1
    want = {"woq_matmul": ["woq_wgmma<8,256>", "woq_wgmma<8,128>", "woq_wgmma<4,256>",
                           "woq_wgmma<4,128>", "woq_wgmma<6,128>"],
            "decode_attention": [f"decode_kernel<{d}>" for d in (64, 128, 192, 256)],
            "paged_attention": [f"paged_split<{d}>" for d in (64, 80, 96, 128, 256)]
            + [f"paged_fwd_wgmma<{d}>" for d in (64, 128, 256)]}[lib]
    if lib == "paged_attention":
        from deepspeed_tpu_torch.ops.paged_attention import kernel_info
        for name in want:
            rows.setdefault(name, {}).update(kernel_info(
                "split" if name.startswith("paged_split") else "wgmma",
                int(name.split("<")[1].rstrip(">"))))
    for name in want:
        row = rows.get(name)
        if row is None or "registers" not in row:
            fail(f"{name} missing from the ptxas report of {lib}")
        if row.get("spill_stores") or row.get("spill_loads"):
            fail(f"{name} spills: {row}")
        if "wgmma" in name and not row.get("hgmma"):
            fail(f"{name} issues no HGMMA: {row}")
    return rows


def wgmma_build_report(op_builder, lib):
    """Registers, spills and stack of each attention kernel of ``lib`` (a
    key of WGMMA_LIBS) from the build's ptxas report, its dynamic shared
    memory and threads a block from the library's kernel_info, and its HGMMA
    (wgmma) instructions from ``cuobjdump --dump-sass``. Fails unless ptxas
    kept setmaxnreg, every wgmma kernel issues HGMMA and spills nothing, and
    the library's wgmma kernels at D 64 and 128 (the forward K13 / K3 / K11
    / K12, and the backward K14 / K15, K4 / K5) are all there. A kernel with a causal
    template argument is named ``base<D, causal>`` or ``base<D, noncausal>``."""
    import importlib
    import re
    from pathlib import Path
    module, required = WGMMA_LIBS[lib]
    info = importlib.import_module(module).kernel_info
    if lib not in op_builder.BUILD_LOGS:   # reused from an earlier run: rebuild
        (op_builder.BUILD_DIR / f"lib{lib}.so").unlink()
        op_builder.build([lib])
    log = op_builder.BUILD_LOGS[lib]
    if "setmaxnreg ignored" in log:
        fail(f"ptxas ignored setmaxnreg in {lib}.cu")

    def short(mangled):
        m = re.search(r"((?:ring|flash|sparse|evo)_(?:fwd|dq|dkv)_(?:kernel|wgmma))ILi(\d+)E"
                      r"(?:Lb([01])E)?", mangled)
        if m is None:
            return mangled
        causal = {"1": ", causal", "0": ", noncausal", None: ""}[m.group(3)]
        return f"{m.group(1)}<{m.group(2)}{causal}>"

    rows, name, props = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = short(m.group(1))
            rows[name] = {}
        elif "Function properties for" in ln:
            props = short(ln.split("Function properties for")[1].strip())
        elif name and props == name and "spill stores" in ln:
            st, ss, sl = map(int, re.findall(r"(\d+) bytes", ln)[:3])
            rows[name].update(stack=st, spill_stores=ss, spill_loads=sl)
        elif name and "Used" in ln and "registers" in ln:
            rows[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    sass = subprocess.run(
        [str(Path(op_builder.nvcc()).parent / "cuobjdump"), "--dump-sass",
         str(op_builder.BUILD_DIR / f"lib{lib}.so")],
        capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump exit {sass.returncode}: {sass.stderr.strip()[-500:]}")
    name = None
    for ln in sass.stdout.splitlines():
        if "Function :" in ln:
            name = short(ln.split("Function :")[1].strip())
            rows.setdefault(name, {})["hgmma"] = 0
        elif name and "HGMMA" in ln:
            rows[name]["hgmma"] += 1
    bad = {}
    for name, row in rows.items():
        base, d = name.split("<")
        row.update(info(base.split("_")[1], int(d.rstrip(">").split(",")[0])))
        if base.endswith("_wgmma") and (row.get("hgmma", 0) == 0 or row.get("spill_stores")
                                        or row.get("spill_loads")):
            bad[name] = row
    if bad:
        fail(f"{bad} (the wgmma kernels must issue HGMMA and spill nothing)")
    for base in required:
        for d in (64, 128):
            if not any(n.split(",")[0].rstrip(">") == f"{base}<{d}" for n in rows):
                fail(f"{base}<{d}> missing from the ptxas report of {lib}")
    return rows


def ring_kernels():
    from deepspeed_tpu_torch.sequence import ring_flash as RF
    return RF, (RF.ring_fwd_step, RF.ring_dq_step, RF.ring_dkv_step)


def ring_case(torch, name, *, b, s, h, kvh, d, q_off, k_off, window=0, alibi=False, seg=False,
              carry=True, seed=0, view=(1, 0)):
    """One ring step's inputs on the card: q (already scaled), k, v, do in
    bf16; the carry (m, l, acc) entering the step, non-empty unless
    ``carry`` is False (the first step of a ring); lse and delta for the
    backward, and non-zero f32 dq, dk, dv accumulators. The lse counts the
    step's own scores (from the plain forward) and a share from other
    shards, so every p = exp(s - lse) is at most 1. ``view`` (n, i): q, k,
    v and do are shard i of n, views of (b, n * s, heads, d) tensors (batch
    stride n * s * heads * d), as the train path passes them."""
    RF, _ = ring_kernels()
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    f32 = torch.float32
    segs = (None, None)
    if seg:
        qs = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        ks = torch.zeros(b, s, dtype=torch.int32, device="cuda")
        qs[:, s // 3:] = 1                 # the query shard's document changes at s/3
        ks[:, : s // 2] = 1                # keys: the end of document 1, then document 2
        ks[:, s // 2:] = 2
        qs[-1, (3 * s) // 4:] = 2
        segs = (qs, ks)
    n, part = view[0], slice(view[1] * s, (view[1] + 1) * s)
    c = dict(name=name, q=rnd(b, n * s, h, d, scale=d ** -0.5)[:, part],
             k=rnd(b, n * s, kvh, d)[:, part], v=rnd(b, n * s, kvh, d)[:, part],
             do=rnd(b, n * s, h, d)[:, part],
             kw=dict(q_off=q_off, k_off=k_off, window=window, qseg=segs[0], kseg=segs[1],
                     slopes=torch.linspace(0.5, 0.01, h, device="cuda") if alibi else None))
    if carry:
        c["m"] = rnd(b, h, s, scale=0.5, dtype=f32) + 2.0
        c["l"] = torch.rand(b, h, s, generator=g, device="cuda") * 3 + 1
        c["acc"] = rnd(b, s, h, d, dtype=f32)
    else:
        c["m"] = torch.full((b, h, s), RF.NEG_INF, device="cuda")
        c["l"] = torch.zeros(b, h, s, device="cuda")
        c["acc"] = torch.zeros(b, s, h, d, device="cuda")
    m, l, acc = c["m"].clone(), c["l"].clone(), c["acc"].clone()
    RF.ring_fwd_step_plain(c["q"].float(), c["k"].float(), c["v"].float(), m, l, acc, **c["kw"])
    step = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), float("-inf"))
    c["lse"] = torch.logaddexp(step, rnd(b, h, s, scale=0.5, dtype=f32) + 1.0)
    c["delta"] = rnd(b, h, s, scale=0.3, dtype=f32)
    c["dq"] = rnd(b, s, h, d, scale=0.1, dtype=f32)
    c["dk"] = rnd(b, s, kvh, d, scale=0.1, dtype=f32)
    c["dv"] = rnd(b, s, kvh, d, scale=0.1, dtype=f32)
    return c


def ring_visible_pairs(torch, c):
    """Visible (q, k) pairs of the step summed over heads: what the
    function's work depends on (0 above the diagonal)."""
    q, k, kw = c["q"], c["k"], c["kw"]
    b, s, h, _ = q.shape
    rows = kw["q_off"] + torch.arange(s, device="cuda")[:, None]
    cols = kw["k_off"] + torch.arange(k.shape[1], device="cuda")[None, :]
    vis = rows >= cols
    if kw["window"]:
        vis &= rows - cols < kw["window"]
    if kw["qseg"] is not None:
        return int((vis[None] & (kw["qseg"][:, :, None] == kw["kseg"][:, None, :])).sum()) * h
    return int(vis.sum()) * b * h


def ring_work(torch, c):
    """(bytes, flops) per kernel on this step's data: 4 D flops per visible
    pair forward, 6 D for dq, 8 D for dk/dv (flash_work's convention); each
    input read once and each output written once, the f32 carry and
    accumulators read and written. A step that sees nothing needs neither."""
    q, k = c["q"], c["k"]
    b, s, h, d = q.shape
    pairs = ring_visible_pairs(torch, c)
    if pairs == 0:
        return {n: (0, 0) for n in RING_REPLACES}
    q_b, kv_b = q.numel() * 2, k.numel() * 2
    row_b = b * h * s * 4
    return {"ring_fwd_step": (q_b + 2 * kv_b + 4 * row_b + 2 * q.numel() * 4, 4 * d * pairs),
            "ring_dq_step": (2 * q_b + 2 * kv_b + 2 * row_b + 2 * q.numel() * 4, 6 * d * pairs),
            "ring_dkv_step": (2 * q_b + 2 * kv_b + 2 * row_b + 4 * k.numel() * 4, 8 * d * pairs)}


def ring_run(torch, c, plain=False):
    """One step of K13, K14 and K15 (or their plain versions on f32 copies)
    on fresh copies of the carry and accumulators. Returns the outputs."""
    RF, (fwd, dq_fn, dkv_fn) = ring_kernels()
    cv = (lambda t: t.float()) if plain else (lambda t: t)   # noqa: E731
    q, k, v, do = (cv(c[n]) for n in ("q", "k", "v", "do"))
    m, l, acc, dq, dk, dv = (c[n].clone() for n in ("m", "l", "acc", "dq", "dk", "dv"))
    if plain:
        RF.ring_fwd_step_plain(q, k, v, m, l, acc, **c["kw"])
        RF.ring_bwd_step_plain(q, k, v, do, c["lse"], c["delta"], dq, dk, dv, **c["kw"])
    else:
        fwd(q, k, v, m, l, acc, **c["kw"])
        dq_fn(q, k, v, do, c["lse"], c["delta"], dq, **c["kw"])
        dkv_fn(q, k, v, do, c["lse"], c["delta"], dk, dv, **c["kw"])
    return dict(m=m, l=l, acc=acc, dq=dq, dk=dk, dv=dv)


def check_ring(torch, c):
    """K13, K14, K15 once each against the plain versions on f32 copies of
    the same inputs, as check_flash holds K3-K5: m, l and the output the
    carry stands for (acc / l, K3's "out") within ATOL + RTOL |plain|
    everywhere; acc (an unnormalised sum of up to Sk terms) and each
    gradient's increment within RTOL max |plain| + ATOL; acc and every
    increment within a relative Frobenius error of FRO_TOL. A step that
    sees nothing must hand back the carry and the accumulators bit for
    bit."""
    RF, kernels = ring_kernels()
    before = [f.launches for f in kernels]
    got = ring_run(torch, c)
    torch.cuda.synchronize()
    row = {"kernel_launches": [f.launches - b_ for f, b_ in zip(kernels, before)]}
    ok = row["kernel_launches"] == [1, 1, 1]
    again = ring_run(torch, c)      # the same inputs again: every buffer bit for bit
    row["deterministic"] = {n: bool(torch.equal(got[n], again[n])) for n in got}
    ok &= all(row["deterministic"].values())
    del again
    if ring_visible_pairs(torch, c) == 0:
        same = {n: bool(torch.equal(got[n], c[n])) for n in got}
        row["unchanged"] = same
        ok &= all(same.values())
    else:
        ref = ring_run(torch, c, plain=True)
        for g_ in (got, ref):     # the output the carry stands for, as K3 writes it
            g_["out"] = g_["acc"] / torch.where(g_["l"] > 0, g_["l"], 1.0).transpose(1, 2)[..., None]
        for nm in ("m", "l", "out"):
            err = (got[nm] - ref[nm]).abs()
            row[nm] = float(err.max())
            ok &= bool((err <= ATOL + RTOL * ref[nm].abs()).all())
        for nm in ("acc", "dq", "dk", "dv"):
            start = 0.0 if nm == "acc" else c[nm]
            g_inc, r_inc = got[nm] - start, ref[nm] - start
            err, scale = float((g_inc - r_inc).abs().max()), float(r_inc.abs().max())
            rel = float(torch.linalg.vector_norm(g_inc - r_inc) / torch.linalg.vector_norm(r_inc))
            row[nm] = err
            row[nm + "_limit"] = RTOL * scale + ATOL
            row[nm + "_rel_fro"] = rel
            ok &= err <= row[nm + "_limit"] and rel <= FRO_TOL
        del ref
    q, k, kw = c["q"], c["k"], c["kw"]
    emit("ring_kernel_check", case=c["name"],
         shape=dict(B=q.shape[0], S=q.shape[1], H=q.shape[2], KVH=k.shape[2], D=q.shape[3],
                    q_off=kw["q_off"], k_off=kw["k_off"], window=kw["window"],
                    alibi=kw["slopes"] is not None, segments=kw["qseg"] is not None,
                    batch_stride=q.stride(0), contiguous=q.is_contiguous()),
         variant={n: RF.kernel_info(kind, q.shape[3])["variant"] for n, kind in RING_KINDS.items()},
         visible_pairs=ring_visible_pairs(torch, c), max_abs_err=row, atol=ATOL, rtol=RTOL,
         fro_tol=FRO_TOL, within=ok)
    if not ok:
        fail(f"ring flash {c['name']}: {row}")
    return row


def ring_kernel_check(torch):
    """Phase 22: every step kind at the shard shapes, then the mask, group
    and head-dim cases at small shapes. Returns the worst error by kernel."""
    main = dict(b=1, s=RING_SHARD, h=RING_H, kvh=RING_KVH, d=RING_D)
    cases = [ring_case(torch, f"shard_{kind}", **main, q_off=qo, k_off=ko,
                       carry=kind != "diagonal", seed=i)
             for i, (kind, (qo, ko)) in enumerate(RING_STEPS.items())]
    small = dict(b=2, s=512)
    for i, (name, kw) in enumerate([
            # the window straddles shards: the first rows see the previous shard's tail
            ("window_below", dict(h=8, kvh=8, d=64, window=300, q_off=1024, k_off=512)),
            ("window_far_below", dict(h=8, kvh=8, d=64, window=300, q_off=1536, k_off=512)),
            ("alibi_below", dict(h=8, kvh=2, d=64, alibi=True, q_off=1024, k_off=512)),
            ("segments_diagonal", dict(h=4, kvh=1, d=128, seg=True, q_off=512, k_off=512)),
            ("all_three_below", dict(h=8, kvh=2, d=128, window=700, alibi=True, seg=True,
                                     q_off=1024, k_off=512)),
            ("all_three_diagonal", dict(h=8, kvh=2, d=128, window=200, alibi=True, seg=True,
                                        q_off=512, k_off=512, carry=False)),
            ("group7_d128_tail", dict(s=1000, h=14, kvh=2, d=128, q_off=1000, k_off=0)),
            ("group4_d64", dict(h=16, kvh=4, d=64, q_off=512, k_off=512, carry=False)),
            ("group1_d256_below", dict(h=4, kvh=4, d=256, q_off=512, k_off=0)),
            ("d256_diagonal_window", dict(h=4, kvh=2, d=256, window=100, q_off=512,
                                          k_off=512)),
            ("above", dict(h=8, kvh=2, d=64, window=100, alibi=True, q_off=0, k_off=512)),
            # shard views of a (2, 4 S, H, D) sequence: the batch stride is 4 S H D
            ("strided_view_below", dict(h=8, kvh=2, d=128, q_off=1024, k_off=512, view=(4, 2))),
            ("strided_view_diagonal_d64", dict(h=8, kvh=4, d=64, q_off=512, k_off=512,
                                               carry=False, view=(4, 1)))]):
        cases.append(ring_case(torch, name, **{**small, **kw}, seed=10 + i))
    worst = {n: 0.0 for n in RING_REPLACES}
    for c in cases:
        row = check_ring(torch, c)
        worst["ring_fwd_step"] = max(worst["ring_fwd_step"], row.get("out", 0.0))
        worst["ring_dq_step"] = max(worst["ring_dq_step"], row.get("dq", 0.0))
        worst["ring_dkv_step"] = max(worst["ring_dkv_step"], row.get("dk", 0.0), row.get("dv", 0.0))
    del cases
    torch.cuda.empty_cache()
    return worst


def _sdpa_backend(torch, fn):
    """The names of the CUDA kernels one call of ``fn`` runs (the SDPA
    backend it took), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({ev.name for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA})
    return [n[:80] for n in names if any(w in n.lower() for w in
                                         ("flash", "fmha", "attention", "cudnn", "sdpa"))] or names


def ring_kernel_time(torch):
    """Phase 23: each kernel at the shard shapes per step kind, by CUDA
    events, beside its plain version, its bound and SDPA (forward beside
    K13, the autograd backward beside K14 + K15). Returns the rows by
    (kernel, step kind)."""
    import torch.nn.functional as F
    rows = {}
    for i, (kind, (qo, ko)) in enumerate(RING_STEPS.items()):
        c = ring_case(torch, f"shard_{kind}", b=1, s=RING_SHARD, h=RING_H, kvh=RING_KVH,
                      d=RING_D, q_off=qo, k_off=ko, seed=20 + i)
        RF, (fwd, dq_fn, dkv_fn) = ring_kernels()
        q, k, v, do, kw = c["q"], c["k"], c["v"], c["do"], c["kw"]
        f32 = [t.float() for t in (q, k, v, do)]
        m, l, acc, dq, dk, dv = (c[n].clone() for n in ("m", "l", "acc", "dq", "dk", "dv"))
        lse, delta = c["lse"], c["delta"]
        library, backend = {"fwd": None, "bwd": None}, None
        if kind != "above":     # above the diagonal nothing is visible: no library call
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
            causal = kind == "diagonal"
            sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
                qt, kt, vt, is_causal=causal, enable_gqa=True)
            lib_out = sdpa()
            lib_do = do.transpose(1, 2)
            backend = _sdpa_backend(torch, lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), lib_do))
            library = {"fwd": cuda_ms(torch, lambda i_: sdpa(), reps=3, iters=5),
                       "bwd": cuda_ms(torch, lambda i_: torch.autograd.grad(
                           lib_out, (qt, kt, vt), lib_do, retain_graph=True), reps=3, iters=5)}
            del qt, kt, vt, lib_out
        timed = {
            "ring_fwd_step": (lambda i_: fwd(q, k, v, m, l, acc, **kw),
                              lambda i_: RF.ring_fwd_step_plain(*f32[:3], m, l, acc, **kw),
                              "fwd"),
            "ring_dq_step": (lambda i_: dq_fn(q, k, v, do, lse, delta, dq, **kw),
                             lambda i_: RF.ring_bwd_step_plain(*f32, lse, delta, dq, None, None,
                                                               **kw), "bwd"),
            "ring_dkv_step": (lambda i_: dkv_fn(q, k, v, do, lse, delta, dk, dv, **kw),
                              lambda i_: RF.ring_bwd_step_plain(*f32, lse, delta, None, dk, dv,
                                                                **kw), "bwd"),
        }
        work = ring_work(torch, c)
        for name, (kern, plain, lib) in timed.items():
            nbytes, flops = work[name]
            b_ms, b_by = bound(nbytes, flops)
            row = dict(ms=cuda_ms(torch, kern, reps=3, iters=5),
                       plain_ms=cuda_ms(torch, plain, reps=3, iters=2),
                       library_ms=library[lib], bound_ms=b_ms,
                       bound_by=b_by if flops else "nothing visible",
                       bytes=nbytes, flops=flops)
            row["tflops"] = flops / row["ms"] / 1e9
            emit("ring_kernel_time", kernel=name, case=kind,
                 variant=RF.kernel_info(RING_KINDS[name], RING_D)["variant"],
                 shape=dict(B=1, S=RING_SHARD, H=RING_H, KVH=RING_KVH, D=RING_D, q_off=qo,
                            k_off=ko, dtype="bfloat16"),
                 library=(None if library[lib] is None else
                          "F.scaled_dot_product_attention forward (GQA, causal on the diagonal)"
                          if lib == "fwd" else
                          "autograd backward of F.scaled_dot_product_attention (dq, dk, dv)"),
                 sdpa_kernels=backend, **row)
            rows[(name, kind)] = row
        del c, f32, m, l, acc, dq, dk, dv, timed
        torch.cuda.empty_cache()
    return rows


def ring_config():
    return {
        "train_batch_size": 1,
        "train_micro_batch_size_per_gpu": 1,
        "bf16": {"enabled": True},
        "optimizer": {"type": "AdamW", "params": {"lr": 3e-5, "weight_decay": 0.1}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 1},
        "activation_checkpointing": {"policy": "full"},
        "mesh": {"seq": RING_SHARDS},
        "steps_per_print": 10 ** 9,
        "seed": 0,
    }


def ring_train_path(torch, smi):
    """Phase 24: initialize() on qwen2-7b at full width, 4 layers, one
    32768-token sequence a step over 4 sequence shards with
    attn_impl="ring", every count set to 0 before and read after; 1 warm-up
    and 3 timed train_batch steps on one fixed random sequence, then one
    profiled step. Returns (engine, batch, launches, ms per step)."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.utils.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(
        model=build_model(RING_MODEL, num_layers=RING_LAYERS, attn_impl="ring"),
        config=ring_config())
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = engine.model.cfg
    leaves = tree_leaves(engine.module_params)
    n_params = sum(p.numel() for p in leaves)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (1, RING_SEQ + 1), generator=g)
    batch = {"input_ids": ids[:, :-1].cuda(), "labels": ids[:, 1:].cuda()}

    zero_counts()
    losses = [engine.train_batch(batch) for _ in range(RING_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(RING_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x) for x in losses]
    steps = RING_WARM + RING_TIMED
    per_step = {"ring_fwd_step": RING_LAYERS * RING_SHARDS * RING_SHARDS * 2,   # + remat
                "ring_dq_step": RING_LAYERS * RING_SHARDS * RING_SHARDS,
                "ring_dkv_step": RING_LAYERS * RING_SHARDS * RING_SHARDS,
                "fused_adam": len(leaves)}
    want = {n: v * steps for n, v in per_step.items()}
    launched = {n: v for n, v in counts.items() if v}
    ms_step = wall * 1e3 / RING_TIMED
    tokens_s = RING_SEQ * RING_TIMED / wall
    flops_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * RING_SEQ
    ok = (all(map(math.isfinite, losses)) and losses[-1] < losses[0] and launched == want
          and groups.get_sequence_parallel_world_size() == RING_SHARDS)
    emit("ring_train_path", model=RING_MODEL, layers=cfg.num_layers, hidden=cfg.hidden_size,
         heads=cfg.num_heads, kv_heads=cfg.kv_heads, head_dim=cfg.dims_per_head,
         ffn=cfg.ffn_size, vocab=cfg.vocab_size, params=n_params, seq=RING_SEQ,
         seq_shards=RING_SHARDS, shard_tokens=RING_SHARD, micro_batch=1, attn_impl="ring",
         remat=cfg.remat, zero_stage=engine.zero_optimization_stage(),
         dtype="bfloat16 activations, f32 params",
         cuts={"layers": f"{RING_LAYERS} of 28 (28 layers with Adam state do not fit one card)",
               "seq": f"{RING_SEQ}, the preset's max_seq_len", "batch": 1,
               "seq_shards": f"{RING_SHARDS}, held by one process on one card"},
         steps=steps, warmup_steps=RING_WARM, timed_steps=RING_TIMED, losses=losses,
         launches=launched, launches_expected=want, launches_per_step=per_step,
         ms_per_step=ms_step, tokens_per_s=tokens_s, mfu=flops_token * tokens_s / BF16_FLOPS,
         mfu_formula="(6 * params + 12 * layers * hidden * seq) * tokens/s / 989e12",
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, init_s=init_s, card=smi,
         within=ok)
    if not ok:
        fail(f"ring train path: losses {losses}, launches {launched} (expected {want})")
    train_step_profile(torch, engine, batch, ms_step, smi, model=RING_MODEL,
                       phase="ring_step_profile", steps=1)
    return engine, batch, launched, ms_step


def ring_reference_check(torch, engine, batch):
    """Phase 25: the sequence through the ring (K13-K15 over 4 shards) and
    through the same engine's weights with attn_impl="flash" and one shard
    (K3-K5), as train_reference_check holds flash to the reference: loss
    within 1 %, global gradient norm within 2 %, per-leaf cosine >= 0.99."""
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.utils import groups
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths
    leaves = tree_leaves(engine.module_params)
    paths = [path for path, _ in tree_paths(engine.module_params)]
    results = {}
    for impl, shards in (("ring", RING_SHARDS), ("flash", 1)):
        groups.set_sequence_parallel(shards)
        model = build_model(engine.model.cfg.replace(attn_impl=impl))
        loss = model.loss(engine.module_params, batch)
        grads = torch.autograd.grad(loss, leaves)
        results[impl] = (float(loss), grads)
        del loss, grads
    groups.set_sequence_parallel(RING_SHARDS)
    (lr_, gr), (lf, gf) = results["ring"], results["flash"]
    nr = float(torch.stack([g.float().norm() for g in gr]).norm())
    nf = float(torch.stack([g.float().norm() for g in gf]).norm())
    # the key bias has an exactly-zero gradient (see train_reference_check)
    zero = {p: (float(a.norm()), float(b.norm()))
            for p, a, b in zip(paths, gr, gf) if p.endswith("attn.bk")}
    cos = {p: float(torch.nn.functional.cosine_similarity(a.flatten().float(),
                                                         b.flatten().float(), dim=0))
           for p, a, b in zip(paths, gr, gf) if p not in zero}
    worst = min(cos, key=cos.get)
    ok = (abs(lr_ - lf) <= 0.01 * abs(lf) and abs(nr - nf) <= 0.02 * nf
          and cos[worst] >= 0.99 and math.isfinite(lr_))
    emit("ring_reference_check", seq=RING_SEQ, loss_ring=lr_, loss_flash=lf,
         grad_norm_ring=nr, grad_norm_flash=nf, min_leaf_cosine=cos[worst],
         min_cosine_leaf=worst, leaf_cosines=cos, zero_gradient_leaf_norms=zero, within=ok)
    if not ok:
        fail(f"ring reference check: loss {lr_} vs {lf}, norm {nr} vs {nf}, "
             f"cosine {cos[worst]} at {worst}")


def ring_phases(torch, smi):
    """The ring slice's phases 22-25; returns its kernel entries."""
    worst = ring_kernel_check(torch)
    rows = ring_kernel_time(torch)
    engine, batch, launches, _ = ring_train_path(torch, smi)
    ring_reference_check(torch, engine, batch)
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return [{"name": name, "route": "cuda", "source": RING_SOURCE, "replaces": replaces,
             "launches": launches[name], "max_abs_err": worst[name],
             **{k: rows[(name, "below")][k] for k in keys}, "case": "below",
             "shapes": {kind: {k: r[k] for k in keys} for (n_, kind), r in rows.items()
                        if n_ == name}}
            for name, replaces in RING_REPLACES.items()]


# ------------------------------------------- the ring across four cards (NCCL)

NCCL_RANKS = 4
NCCL_TIMEOUT_S = 600


def ring_nccl_rank(torch):
    """One rank of ``python3 chip_smoke.py ring-nccl``: the ring attention
    of qwen2-7b's attention shapes at S = 32768 (bf16) over NCCL, this
    card holding shard RANK, against the one-process ring of all four
    shards on the same card: the same kernel launches with the same
    offsets. Whether outputs and gradients agree bit for bit is printed;
    they must agree within RTOL max |one-process| + ATOL. Prints one JSON
    line."""
    import os
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.sequence import ring_flash as RF
    from deepspeed_tpu_torch.sequence.ring_attention import ring_attention
    from deepspeed_tpu_torch.utils import groups
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(rank)
    comm.init_distributed(dist_backend="nccl")
    g = torch.Generator().manual_seed(5)
    q, k, v, cot = ((torch.randn(1, RING_SEQ, n, RING_D, generator=g) * sc).to(torch.bfloat16)
                    .cuda() for n, sc in ((RING_H, 1.0), (RING_KVH, 1.0), (RING_KVH, 1.0),
                                          (RING_H, 1.0)))
    part = slice(rank * RING_SHARD, (rank + 1) * RING_SHARD)

    def run(q_, k_, v_, cot_):
        q_, k_, v_ = (t.detach().clone().requires_grad_(True) for t in (q_, k_, v_))
        out = ring_attention(q_, k_, v_)
        out.backward(cot_)
        return [out.detach(), q_.grad, k_.grad, v_.grad]

    def timed(fn, reps=3):
        fn()
        times = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    groups.set_sequence_parallel(NCCL_RANKS, dist.group.WORLD)
    before = RF.ring_fwd_step.launches
    got = run(q[:, part], k[:, part], v[:, part], cot[:, part])
    launches = RF.ring_fwd_step.launches - before
    ms_nccl = timed(lambda: run(q[:, part], k[:, part], v[:, part], cot[:, part]))
    groups.set_sequence_parallel(NCCL_RANKS)          # every shard in this process
    want = run(q, k, v, cot)
    ms_one = timed(lambda: run(q, k, v, cot))
    same = {n: bool(torch.equal(a, b[:, part])) for n, a, b in zip(("out", "dq", "dk", "dv"),
                                                                    got, want)}
    diff = {n: float((a.float() - b[:, part].float()).abs().max())
            for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    limit = {n: RTOL * float(b[:, part].float().abs().max()) + ATOL
             for n, b in zip(("out", "dq", "dk", "dv"), want)}
    ok = all(diff[n] <= limit[n] for n in diff) and launches == NCCL_RANKS
    print(json.dumps({"phase": "ring_nccl", "rank": rank, "card": torch.cuda.get_device_name(rank),
                      "shape": dict(B=1, S=RING_SEQ, H=RING_H, KVH=RING_KVH, D=RING_D,
                                    shard=RING_SHARD, dtype="bfloat16"),
                      "k13_launches_fwd": launches, "bit_identical": same, "max_abs_diff": diff,
                      "limit": limit,
                      "fwd_bwd_ms_4_cards": ms_nccl, "fwd_bwd_ms_one_card_4_shards": ms_one,
                      "within": ok}), flush=True)
    dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def ring_nccl(torch, smi):
    """``python3 chip_smoke.py ring-nccl`` on a machine with four cards:
    builds the ring kernels, starts one process per card (RANK 0-3,
    NCCL over tcp://localhost), waits for them with a time limit and stops
    any that is left; every rank must report its ring bit-identical to the
    one-process ring."""
    import os
    import socket
    from deepspeed_tpu_torch.ops import op_builder
    if torch.cuda.device_count() < NCCL_RANKS:
        fail(f"ring-nccl needs {NCCL_RANKS} cards, found {torch.cuda.device_count()}")
    op_builder.build(["ring_flash"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": str(NCCL_RANKS), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    procs = [subprocess.Popen([sys.executable, __file__, "ring-nccl-rank"],
                              env={**env, "RANK": str(r)}) for r in range(NCCL_RANKS)]
    deadline = time.monotonic() + NCCL_TIMEOUT_S
    try:
        codes = [p_.wait(timeout=max(1.0, deadline - time.monotonic())) for p_ in procs]
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    if any(codes):
        fail(f"ring-nccl ranks exited {codes}")
    print(smi, flush=True)


# ------------------------------ tensor-parallel serving across four cards (NCCL)

TP_MODEL = "llama2-70b"
TP_RANKS = 4
TP_REF_LAYERS = 8          # tp_reference_check / tp_collectives_check depth
TP_FORCED = 16             # teacher-forced decode steps after the prefill
TP_TIMEOUT_S = 900


def tp_device(torch, rank):
    """A tp rank's card."""
    return torch.device("cuda", rank)


def tp_config(**over):
    """The tp phases' serving config: the main path's (16 slots, 128-token
    pages and chunks, bf16) at tp = 4."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineConfig
    return RaggedInferenceEngineConfig(**{"max_ragged_batch_size": 16, "kv_block_size": BS,
                                          "prefill_chunk_size": 128, "dtype": "bfloat16",
                                          "tp": TP_RANKS, **over})


def _tp_class(name):
    if "nccl" in name.lower():
        return "nccl"
    return _kernel_class(name)


def tp_gather(obj):
    """Every rank's ``obj``, in rank order, on every rank."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def tp_check(ok, msg):
    """A gate every rank takes together: the verdicts are gathered, so a
    failure on one rank fails all four (none waits in a collective for a
    rank that left)."""
    oks = tp_gather(bool(ok))
    if not all(oks):
        fail(f"{msg} (ranks ok: {oks})")


def tp_decode_step(torch, eng):
    """A decode step at the main path's 16-slot shape through the engine's
    runner (8 live rows at the K1 decode case's contexts), replayed from its
    CUDA graph; the blocks it holds are returned by ``release``."""
    owned = []
    g = torch.Generator().manual_seed(2)
    args = step_inputs(torch, eng, K1_MAIN["decode"]["ctx"][:8], 1, 16, g, owned)

    def step():
        return eng.runner.run(eng.params, *args, eng.kv.k, eng.kv.v)

    return step, lambda: eng.kv.allocator.free(owned)


def forced_logits(torch, eng, prompts, forced):
    """Teacher-forced logits through ``eng.runner.run``: the prompts' prefill
    in 128-token chunks (each row's last-token logits as its chunk ends),
    then ``forced.shape[1]`` decode steps feeding ``forced`` (B, n) tokens.
    Returns ((1 + n) x B, V) f32 logits, the first chunk's forward's
    (B, V) logits, and frees the blocks it took."""
    kv, dev = eng.kv, eng.device
    lens = [len(p) for p in prompts]
    b, n = len(prompts), forced.shape[1]
    owned = []
    tables = torch.zeros((b, eng.max_blocks_per_seq), dtype=torch.int32)
    for i, ln in enumerate(lens):
        blk = kv.allocator.allocate(kv.blocks_for(ln + n + 1))
        owned += blk
        tables[i, :len(blk)] = torch.tensor(blk, dtype=torch.int32)
    tables = tables.to(dev)
    last, first, rows = [None] * b, None, []
    try:
        for s0 in range(0, max(lens), 128):
            ids = torch.zeros((b, 128), dtype=torch.int32)
            pos = torch.full((b, 128), -1, dtype=torch.int32)
            for i, p in enumerate(prompts):
                seg = torch.as_tensor(p[s0:s0 + 128], dtype=torch.int32)
                ids[i, :len(seg)] = seg
                pos[i, :len(seg)] = torch.arange(s0, s0 + len(seg), dtype=torch.int32)
            valid = (pos >= 0).sum(dim=1).to(torch.int32)
            logits = eng.runner.run(eng.params, ids.to(dev), pos.to(dev), tables,
                                    valid.to(dev), kv.k, kv.v)[0]
            if first is None:
                first = logits.clone()
            for i, ln in enumerate(lens):
                if s0 <= ln - 1 < s0 + 128:
                    last[i] = logits[i].clone()
        rows.append(torch.stack(last))
        for t in range(n):
            ids = forced[:, t:t + 1].to(torch.int32)
            pos = torch.tensor([[ln + t] for ln in lens], dtype=torch.int32)
            logits = eng.runner.run(eng.params, ids.to(dev), pos.to(dev), tables,
                                    torch.ones((b,), dtype=torch.int32, device=dev),
                                    kv.k, kv.v)[0]
            rows.append(logits.clone())
        torch.cuda.synchronize()
    finally:
        kv.allocator.free(owned)
    return torch.cat(rows).float(), first.float()


def rel_fro(torch, got, want):
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def tp_serve_path(torch, rank, smi):
    """Phase tp_serve_path: llama2-70b at full width and depth over four
    cards (tp = 4, bf16, random weights, each rank drawing only its own shard
    on its card), the main path's 8 greedy requests from CUDA graphs: one
    capturing run, then one timed run. Every rank must emit the same tokens
    in the same order, every budget complete (uid 5 at its EOS), the pool
    drain, and K1 launch 80 x steps on every rank. Then a decode step's wall
    and device time by class (GEMMs, NCCL, K1, other) and the idle share.
    Returns K1's launches in the timed run."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.inference.v2.tp import build_tp_context, init_params_shard
    from deepspeed_tpu_torch.models import build_model
    dev = tp_device(torch, rank)
    model = build_model(TP_MODEL)
    cfg = model.cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_shard(model, build_tp_context(model, TP_RANKS), seed=0, device=dev,
                               dtype=torch.bfloat16)
    eng = InferenceEngineV2(model, tp_config(), params=params, max_seq_len=2048, device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * t.element_size() for t in _leaves(eng.params)) / 1e9
    prompts, eos_uid, eos_id, arrivals, arrival_t = main_workload(torch, cfg.vocab_size)
    runs = {}
    for mode in ("graph_first", "graph"):
        runs[mode] = serve_counted(torch, eng, arrivals(), max_new_tokens=32)
        runs[mode]["ttft_first_request_s"] = runs[mode]["first_tok"][0] - arrival_t[0]
    r = runs["graph"]
    mine = [(u, t.tolist()) for u, t in r["got"]]
    every = tp_gather(mine)
    tp_check(all(x == every[0] for x in every),
             "tp_serve_path: the ranks' tokens or retirement order differ")
    tp_check(mine == [(u, t.tolist()) for u, t in runs["graph_first"]["got"]],
             "tp_serve_path: the capturing run's tokens differ from the timed run's")
    check_budgets("tp_serve_path", r["got"], prompts, eos_uid, eos_id, cfg.vocab_size)
    tp_check(all(x["launches"] == cfg.num_layers * x["steps"] for x in runs.values()),
             f"tp_serve_path: K1 launches {[x['launches'] for x in runs.values()]} != "
             f"{cfg.num_layers} x steps {[x['steps'] for x in runs.values()]}")
    tp_check(eng.kv.free_blocks == eng.kv.num_blocks - 1 and not eng.state.seqs,
             "tp_serve_path: the pool did not drain")
    # what a frame boundary's deadline pass costs the host without deadlines:
    # the one-int all-reduce that tells whether any rank holds one (taken
    # before the trace below, which leaves CUPTI raising every launch's cost)
    guard = [eng._any_deadline_armed() for _ in range(5)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        guard.append(eng._any_deadline_armed())
    guard_us = (time.perf_counter() - t0) * 1e6 / 200
    tp_check(not any(guard), "tp_serve_path: a deadline is armed with none set")
    step, release = tp_decode_step(torch, eng)
    try:
        prof = profile_modes(torch, {"decode": step}, _tp_class)["decode"]
    finally:
        release()
    k1 = prof["kernels_a_step_by_class"].get("paged_attention", 0)
    tp_check(k1 == cfg.num_layers, f"tp decode step: {k1} K1 kernels a step on the card")
    n_tok = sum(len(t) for _, t in r["got"])
    row = dict(rank=rank, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               weights_gb=weights_gb, kv_blocks=eng.kv.num_blocks,
               kv_gb=2 * eng.kv.k.numel() * eng.kv.k.element_size() / 1e9,
               build_s=build_s, deadline_guard_us_a_boundary=guard_us, step=prof)
    rows = tp_gather(row)
    if rank == 0:
        emit("tp_serve_path", model=TP_MODEL, tp=TP_RANKS, layers=cfg.num_layers,
             hidden=cfg.hidden_size, heads_per_rank=cfg.num_heads // TP_RANKS,
             kv_heads_per_rank=cfg.kv_heads // TP_RANKS, requests=len(r["got"]), tokens=n_tok,
             cuda_graphs=True, frames=r["frames"], steps=r["steps"],
             wide_steps=r["wide_steps"], narrow_steps=r["narrow_steps"],
             paged_attention_launches=r["launches"], launches_per_step=r["launches"] / r["steps"],
             serve_s=r["serve_s"], tokens_per_s=n_tok / r["serve_s"],
             ttft_first_request_s=r["ttft_first_request_s"],
             tokens_identical_across_ranks=True, by_mode=run_rows(runs, n_tok),
             ranks=rows, card=smi)
    return r["launches"]


def probe_logits(torch, eng):
    """JAX's contract probe (tests/test_serving_tp.py:178-199): one token
    (id 5) at position 0 into block 1, one forward, the (1, V) logits."""
    dev = eng.device
    ids, pos, tbl = (torch.tensor([[v]], dtype=torch.int32, device=dev) for v in (5, 0, 1))
    one = torch.ones((1,), dtype=torch.int32, device=dev)
    return eng.runner._forward(eng.params, ids, pos, tbl, one, eng.kv.k, eng.kv.v)[0].float()


def tp_dense_logits(torch, model, params, ids, at, payload=None, degree=TP_RANKS):
    """f32 logits (len(at), V) at positions ``at`` of the token sequence
    ``ids`` by a dense causal forward written out here: no pages, no
    kernel, no process group, each layer's weights cast to f32 as it runs
    (TF32 off). ``payload`` ("int8" / "fp8"): every reduction a tp =
    ``degree`` engine makes with quantized collectives (the embedding
    lookup split over vocab, the attention and MLP output products split
    over heads and the intermediate dim, the logits split over vocab) is
    made here from the ``degree`` partials stacked, through the arithmetic
    of ``parallel.collectives`` (``psum_quantized``: per-chunk quantize,
    sum shard 0 first, requantize; ``all_gather_quantized``): the quantized
    scheme's function in f32 on one card. llama-style models (no biases)."""
    from deepspeed_tpu_torch.models import layers as L
    from deepspeed_tpu_torch.models.transformer import layer_slice
    from deepspeed_tpu_torch.parallel import collectives as TC
    cfg = model.cfg.replace(dtype="float32")
    f32, n = torch.float32, degree
    e, h, kvh, d, vocab = (cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.dims_per_head,
                           cfg.vocab_size)
    if payload is not None and cfg.use_bias:
        raise ValueError("tp_dense_logits: the quantized scheme is written for bias-free models")
    s, dev = len(ids), ids.device

    def psum_q(parts):               # (n, ..., D) partials -> the all-reduce's result
        chunks = parts.reshape(parts.shape[:-1] + (n, parts.shape[-1] // n))
        q, sc = TC._quantize(chunks, payload)
        red = TC._sum_shards(q.float() * sc, 0)
        q2, s2 = TC._quantize(red, payload)
        return (q2.float() * s2).reshape(parts.shape[1:])

    def row_parallel(x, w):          # x (..., K) @ w (K, N), K split over the ranks
        if payload is None:
            return x @ w
        k = x.shape[-1] // n
        return psum_q(torch.stack([x[..., r * k:(r + 1) * k] @ w[r * k:(r + 1) * k]
                                   for r in range(n)]))

    tok = params["embed"]["tok"]
    x = tok[ids].to(f32)[None]
    if payload is not None:
        owner = ids // (vocab // n)
        x = psum_q(torch.stack([x * (owner == r).to(f32)[None, :, None] for r in range(n)]))
    pos = torch.arange(s, device=dev)[None]
    inv = model.inv_freq(dev)
    causal = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
    for li in range(cfg.num_layers):
        lp = layer_slice(params["layers"], li)
        a = L.apply_norm(lp["norm1"], x, cfg)
        att = {k: lp["attn"][k].to(f32) for k in ("wq", "wk", "wv", "wo")}
        q = (a @ att["wq"].reshape(e, h * d)).view(1, s, h, d)
        k = (a @ att["wk"].reshape(e, kvh * d)).view(1, s, kvh, d)
        v = (a @ att["wv"].reshape(e, kvh * d)).view(1, s, kvh, d)
        q, k = L.apply_rope(q, pos, inv), L.apply_rope(k, pos, inv)
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * d ** -0.5
        pr = sc.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(1, s, h * d)
        x = x + row_parallel(o, att["wo"].reshape(h * d, e))
        mlp = {k_: w.to(f32) for k_, w in lp["mlp"].items()}
        y = L.apply_norm(lp["norm2"], x, cfg)
        if payload is None:
            x = x + L.apply_mlp(mlp, y, cfg)
        else:
            f = cfg.ffn_size // n
            x = x + psum_q(torch.stack([L.apply_mlp(
                {k_: (w[:, r * f:(r + 1) * f] if k_ != "wo" else w[r * f:(r + 1) * f])
                 for k_, w in mlp.items()}, y, cfg) for r in range(n)]))
    x = L.apply_norm(params["final_norm"], x, cfg)[0, at]
    logits = x @ params["embed"]["lm_head"].to(f32)
    if payload is not None:
        q, sc = TC._quantize(logits.reshape(len(at), n, vocab // n), payload)
        logits = (q.float() * sc).reshape(len(at), vocab)
    return logits


def tp_reference_logits(torch, model, params, prompts, forced, payload=None):
    """``tp_dense_logits`` laid out as ``forced_logits`` lays out the
    engine's: ((1 + n) x B, V) teacher-forced rows (step-major), and (B, V)
    at each prompt's first-chunk end. Without ``payload`` the whole
    sequence runs once a prompt; with it, only the first chunk (the
    scheme is read there and at the probe)."""
    dev, n = params["embed"]["tok"].device, forced.shape[1]
    forced = forced.to(dev)
    steps, first = [[] for _ in range(1 + n)], []
    for i, p in enumerate(prompts):
        ln, c = len(p), min(len(p), 128)
        ids = torch.cat([torch.as_tensor(p, dtype=torch.long, device=dev),
                         forced[i].long()])
        if payload is None:
            out = tp_dense_logits(torch, model, params, ids,
                                  [c - 1] + [ln - 1 + j for j in range(1 + n)])
            for j in range(1 + n):
                steps[j].append(out[1 + j])
        else:
            out = tp_dense_logits(torch, model, params, ids[:c], [c - 1], payload)
        first.append(out[0])
    rows = torch.stack([r for st in steps for r in st]) if payload is None else None
    return rows, torch.stack(first)


def tp_wire_check(torch, rank):
    """The tp collectives over NCCL held against the same arithmetic done on
    this card from every rank's inputs (gathered exactly): the int8 and fp8
    all-reduces, the ring and the quantized logit gather bit for bit, the
    exact all-reduce within two bf16 steps of the f32 sum. Shapes: a decode
    step's (16, 8192) bf16 activation and a (16, 8000) logit shard."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel import collectives as TC
    n, dev = TP_RANKS, tp_device(torch, rank)
    g = torch.Generator(device=dev).manual_seed(11 + rank)
    x = torch.randn(16, 8192, generator=g, device=dev).to(torch.bfloat16)
    lg = torch.randn(16, 8000, generator=g, device=dev).to(torch.bfloat16)
    xs = comm.all_gather_into_tensor(x[None], dim=0)             # (n, 16, 8192)
    out = {}
    chunks = xs.reshape(n, 16, n, 8192 // n)
    for payload in ("int8", "fp8"):
        got = TC.psum_quantized(x.clone(), None, n, payload)
        q, sc = TC._quantize(chunks, payload)                      # per source rank
        red = TC._sum_shards(q.float() * sc, 0)                    # (16, n, shard)
        q2, s2 = TC._quantize(red, payload)
        want = (q2.float() * s2).reshape(16, 8192).to(torch.bfloat16)
        out["psum_" + payload] = bool(torch.equal(got, want))
        ql, sl = TC._quantize(lg, payload)
        qg = comm.all_gather_into_tensor(ql[None], dim=0)
        sg = comm.all_gather_into_tensor(sl[None], dim=0)
        want = torch.cat(list((qg.float() * sg).to(torch.bfloat16).unbind(0)), dim=-1)
        out["gather_" + payload] = bool(torch.equal(TC.all_gather_quantized(lg, None, n, payload),
                                                    want))
    ring = TC.psum_ring(x.clone(), None, n)
    want = torch.empty_like(chunks[0])
    for j in range(n):                  # chunk j: rank j + 1 seeds it, then j + 2, ...
        acc = chunks[(j + 1) % n][:, j]
        for k in range(1, n):
            acc = acc + chunks[(j + 1 + k) % n][:, j]
        want[:, j] = acc
    out["ring"] = bool(torch.equal(ring, want.reshape(16, 8192)))
    exact = TC.psum_exact(x.clone(), None).float()
    f32 = xs.float().sum(dim=0)
    out["exact_max_abs_diff"] = float((exact - f32).abs().max())
    out["exact_limit"] = 2 * 2.0 ** -8 * float(f32.abs().max())
    out["exact"] = out["exact_max_abs_diff"] <= out["exact_limit"]
    return out


TP_REF_SLACK = 1.5          # tp 4 may sit this far from f32 beyond tp 1's bf16 distance


def tp_reference_phases(torch, rank, smi):
    """Phases tp_reference_check and tp_collectives_check at TP_REF_LAYERS of
    llama2-70b's 80 layers, full width: every rank draws the whole 8-layer
    model from one seed on its card and keeps its shard. The reference is
    ``tp_dense_logits`` in f32 on card 0 (the same bf16 weights, no engine,
    no process group): teacher-forced logits over the prompts' prefill and
    TP_FORCED decode steps. bf16 has an error of its own on them, read as
    tp = 1's distance from f32 (rank 0 serving the whole model, bf16 KV
    pages as at tp = 4). Gates, each in relative Frobenius against f32:
    tp = 4 within TP_REF_SLACK x tp = 1's distance, and a control that must
    miss it (tp = 4 with every rank's wk / wv cut at the next rank's
    offset: query heads against the wrong kv heads); the overlap ring
    within the same bound; the int8 and fp8 collectives, on JAX's probe
    (one token at position 0) and on the prefill's first chunk, within
    TP_REF_SLACK x (the scheme's own distance, computed in f32 by
    ``tp_dense_logits``, + the exact tp = 4's), and every budget met; the collectives
    on the wire against their arithmetic on one card (``tp_wire_check``).
    Printed beside them: tp 4 vs tp 1 in bf16 (the 1e-2 first set), greedy
    agreement, JAX's contract (max |q - exact| / max |exact| against 0.05)
    for the port and for the scheme in f32, and each variant's decode step
    time beside exact's. Every reading is printed before any gate is
    taken."""
    from deepspeed_tpu_torch.inference.v2 import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel import sharding as TS
    dev = tp_device(torch, rank)
    model = build_model(TP_MODEL, num_layers=TP_REF_LAYERS)
    cfg = model.cfg
    prompts, eos_uid, eos_id, arrivals, _ = main_workload(torch, cfg.vocab_size)
    plist = [prompts[u] for u in sorted(prompts)]
    forced = torch.randint(0, cfg.vocab_size, (len(plist), TP_FORCED),
                           generator=torch.Generator().manual_seed(3))

    def engine(params, **over):
        return InferenceEngineV2(model, tp_config(**over), params=params, max_seq_len=2048,
                                 device=dev)

    def step_ms(eng):
        step, release = tp_decode_step(torch, eng)
        try:
            return host_rows(torch, step)["wall_ms"]
        finally:
            release()

    def freed():
        gc.collect()
        torch.cuda.empty_cache()

    def jax_contract(got, want):
        return float((got - want).abs().max() / want.abs().max())

    full = model.init(torch.Generator(device=dev).manual_seed(7), device=dev,
                      dtype=torch.bfloat16)
    exact = engine(full)
    # the control's shard: wk and wv at the next rank's offset
    specs = TS.inference_tp_specs(model.abstract_params(), model.logical_axes(), TP_RANKS)
    wrong = TS.shard_params(full, specs, rank, TP_RANKS)
    for name in ("wk", "wv"):
        wrong["layers"]["attn"][name] = TS.shard_leaf(
            full["layers"]["attn"][name], specs["layers"]["attn"][name],
            (rank + 1) % TP_RANKS, TP_RANKS)
    if rank != 0:
        del full
    freed()
    want, want_first = forced_logits(torch, exact, plist, forced)
    want_probe = probe_logits(torch, exact)
    served = {"exact": serve_counted(torch, exact, arrivals(), max_new_tokens=32)}
    times = {"exact": step_ms(exact)}
    got = {}
    for name, over in (("int8", dict(tp_quantized_collectives=True)),
                       ("fp8", dict(tp_quantized_collectives=True,
                                    tp_collective_payload="fp8")),
                       ("overlap", dict(tp_overlap_collectives=True))):
        eng = engine(exact.params, **over)
        logits, first = forced_logits(torch, eng, plist, forced)
        got[name] = dict(all=logits, first=first, probe=probe_logits(torch, eng))
        served[name] = serve_counted(torch, eng, arrivals(), max_new_tokens=32)
        times[name] = step_ms(eng)
        del eng
        freed()
    eng = engine(wrong)
    del wrong
    control, _ = forced_logits(torch, eng, plist, forced)
    del eng
    freed()
    wire = tp_wire_check(torch, rank)
    exact_got = [(u, t.tolist()) for u, t in served["exact"]["got"]]
    del exact
    freed()
    readings = None
    if rank == 0:
        # the whole 8-layer model on this card, no collective, bf16 KV pages
        one = engine(full, tp=1)
        tp1, _ = forced_logits(torch, one, plist, forced)
        one_got = dict((u, t.tolist()) for u, t in serve_counted(
            torch, one, arrivals(), max_new_tokens=32)["got"])
        del one
        freed()
        ref, ref_first = tp_reference_logits(torch, model, full, plist, forced)
        ref_probe = tp_dense_logits(torch, model, full,
                                    torch.tensor([5], dtype=torch.long, device=dev), [0])
        exact_vs_f32 = dict(first_chunk=rel_fro(torch, want_first, ref_first),
                            probe=rel_fro(torch, want_probe, ref_probe))
        readings = dict(
            f32_ref="tp_dense_logits, f32 weights and activations, one card",
            tp1_bf16_vs_f32_rel_fro=rel_fro(torch, tp1, ref),
            tp4_vs_f32_rel_fro=rel_fro(torch, want, ref),
            control_vs_f32_rel_fro=rel_fro(torch, control, ref),
            overlap_vs_f32_rel_fro=rel_fro(torch, got["overlap"]["all"], ref),
            slack=TP_REF_SLACK,
            tp4_vs_tp1_bf16_rel_fro=rel_fro(torch, want, tp1),
            tp4_vs_tp1_max_abs_err=float((want - tp1).abs().max()),
            greedy_tokens_agreeing=sum(a == b for u, t in exact_got
                                       for a, b in zip(t, one_got[u])),
            greedy_tokens=sum(len(t) for _, t in exact_got),
            greedy_first_divergence={u: first_divergence(t, one_got[u])
                                     for u, t in exact_got},
            overlap_vs_exact_rel_fro=rel_fro(torch, got["overlap"]["all"], want),
            overlap_decode_step_ms=times["overlap"], exact_decode_step_ms=times["exact"],
            overlap_greedy_tokens_equal_exact=same_serves(served["overlap"]["got"],
                                                          served["exact"]["got"]))
        quant = {}
        for payload in ("int8", "fp8"):
            _, sim_first = tp_reference_logits(torch, model, full, plist, forced, payload)
            sim_probe = tp_dense_logits(torch, model, full,
                                        torch.tensor([5], dtype=torch.long, device=dev), [0],
                                        payload)
            g = got[payload]
            row = dict(decode_step_ms=times[payload], decode_step_ms_exact=times["exact"],
                       all_forwards_vs_exact_rel_fro=rel_fro(torch, g["all"], want),
                       greedy_tokens_equal_exact=same_serves(served[payload]["got"],
                                                             served["exact"]["got"]))
            for at, mine, sim, ref_at, exact_at in (
                    ("probe", g["probe"], sim_probe, ref_probe, want_probe),
                    ("first_chunk", g["first"], sim_first, ref_first, want_first)):
                row[at] = dict(
                    vs_f32_rel_fro=rel_fro(torch, mine, ref_at),
                    scheme_f32_vs_f32_rel_fro=rel_fro(torch, sim, ref_at),
                    exact_tp4_vs_f32_rel_fro=exact_vs_f32[at],
                    jax_contract_port=jax_contract(mine, exact_at),
                    jax_contract_scheme_f32=jax_contract(sim, ref_at))
                row[at]["limit"] = TP_REF_SLACK * (row[at]["scheme_f32_vs_f32_rel_fro"]
                                                   + exact_vs_f32[at])
            quant[payload] = row
        readings["quantized"] = quant
        del full
        freed()
    readings = tp_gather(readings)[0]
    wires = tp_gather(wire)
    if rank == 0:
        emit("tp_reference_check", model=TP_MODEL, layers=TP_REF_LAYERS, tp=TP_RANKS,
             forwards=1 + TP_FORCED, rows=len(plist),
             note="teacher-forced logits against an f32 dense forward of the same bf16 "
             "weights: tp 4 within slack x tp 1's distance, the control (wk / wv cut at the "
             "next rank's offset) outside it, the overlap ring within it; tp 4 vs tp 1 and "
             "greedy agreement printed", **{k: v for k, v in readings.items()
                                            if k != "quantized"}, card=smi)
        emit("tp_collectives_check", model=TP_MODEL, layers=TP_REF_LAYERS, tp=TP_RANKS,
             gate="rel. Frobenius against f32 <= slack x (the scheme's own, in f32, + "
             "the exact tp 4's), on JAX's probe (one token at position 0) and the prefill's first "
             "chunk; jax_contract_*: max |q - exact| / max |exact| (JAX's 0.05, "
             "tests/test_serving_tp.py:196-199), printed",
             slack=TP_REF_SLACK, variants=readings["quantized"], wire_by_rank=wires,
             card=smi)
    for name in ("int8", "fp8"):
        check_budgets(f"tp_collectives_check ({name})", served[name]["got"], prompts, eos_uid,
                      eos_id, cfg.vocab_size)
    check_budgets("tp_reference_check (tp 4)", served["exact"]["got"], prompts, eos_uid, eos_id,
                  cfg.vocab_size)
    # every gate's verdict, then one failure naming each that missed
    missed = []
    if not all(v for w in wires for v in w.values() if isinstance(v, bool)):
        missed.append(f"tp_collectives_check: the collectives on the wire differ from their "
                      f"arithmetic {wires}")
    bound = TP_REF_SLACK * readings["tp1_bf16_vs_f32_rel_fro"]
    for key, what in (("tp4_vs_f32_rel_fro", "tp_reference_check: tp 4"),
                      ("overlap_vs_f32_rel_fro", "tp_collectives_check (overlap)")):
        if not readings[key] <= bound:
            missed.append(f"{what} is {readings[key]} from f32 > {TP_REF_SLACK} x tp 1's "
                          f"{readings['tp1_bf16_vs_f32_rel_fro']}")
    if not readings["control_vs_f32_rel_fro"] > bound:
        missed.append(f"tp_reference_check: the control (wk / wv at the wrong rank offset) is "
                      f"{readings['control_vs_f32_rel_fro']} from f32, within {bound}: the "
                      "gate does not tell a wrong split")
    for name, row in readings["quantized"].items():
        for at in ("probe", "first_chunk"):
            if not row[at]["vs_f32_rel_fro"] <= row[at]["limit"]:
                missed.append(f"tp_collectives_check ({name}, {at}): {row[at]['vs_f32_rel_fro']}"
                              f" from f32 > {row[at]['limit']}")
    tp_check(not missed, "; ".join(missed))


def tp_nccl_rank(torch):
    """One rank of ``python3 chip_smoke.py tp-nccl``: its card, NCCL over
    tcp://localhost, then the three tp phases. The process ends with
    ``os._exit``, its code 0 only when every phase passed: tearing down a
    NCCL group whose collectives CUDA graphs captured can hang, and a rank
    that fails must leave at once so the launcher stops the others."""
    import datetime
    import os
    import traceback
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    code = 1
    try:
        rank = int(os.environ["RANK"])
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        comm.init_distributed(dist_backend="nccl",
                              timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
        smi = nvidia_smi()
        launches = tp_serve_path(torch, rank, smi)
        gc.collect()
        torch.cuda.empty_cache()
        tp_reference_phases(torch, rank, smi)
        if rank == 0:
            print(json.dumps({"kernels": [{"name": "paged_attention", "route": "cuda",
                                           "source": SOURCE, "replaces": REPLACES,
                                           "launches_tp_serve_path_rank0": launches,
                                           "note": "timed in the one-card run (tp4_* cases)"}]}),
                  flush=True)
        dist.barrier()
        code = 0
    except SystemExit as e:            # fail(): its message is printed already
        code = e.code or 1
    except BaseException:              # noqa: BLE001 (reported, then the rank exits)
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def tp_nccl(torch, smi):
    """``python3 chip_smoke.py tp-nccl`` on a machine with four cards: builds
    K1, starts one process per card (RANK 0-3, NCCL over tcp://localhost),
    and stops them all as soon as one fails or at TP_TIMEOUT_S."""
    import os
    import socket
    from deepspeed_tpu_torch.ops import op_builder
    if torch.cuda.device_count() < TP_RANKS:
        fail(f"tp-nccl needs {TP_RANKS} cards, found {torch.cuda.device_count()}")
    op_builder.build(["paged_attention"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": str(TP_RANKS), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    procs = [subprocess.Popen([sys.executable, __file__, "tp-nccl-rank"],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(TP_RANKS)]
    deadline = time.monotonic() + TP_TIMEOUT_S
    try:
        while any(p_.poll() is None for p_ in procs):
            if time.monotonic() > deadline or any(p_.poll() for p_ in procs):
                break
            time.sleep(1.0)
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    codes = [p_.returncode for p_ in procs]
    if any(codes):
        fail(f"tp-nccl ranks exited {codes}")
    print(smi, flush=True)


# --------------------------------- data-parallel ZeRO training across four cards (NCCL)

ZERO_MODEL = "llama2-7b"
ZERO_RANKS = 4
ZERO_SEQ, ZERO_GAS = 4096, 2          # micro-batch 1 a rank: 8 x 4096 tokens a step
ZERO_WARM, ZERO_TIMED = 1, 4
ZERO_REF_LAYERS, ZERO_REF_ROWS, ZERO_REF_STEPS = 4, 8, 3
ZERO_GRAD_TOL = 1e-5       # step 1's reduced gradient vs one card, relative Frobenius
ZERO_LOSS_TOL = 2e-4       # each loss vs one card, relative (JAX tests/test_engine.py:54-59)
ZERO_TIMEOUT_S = 480


def zero_config(stage, gas, dp=ZERO_RANKS):
    """The zero phases' training config: micro-batch 1 a rank, bf16
    activations over f32 parameters and Adam state (train_config's
    optimizer, schedule and clipping)."""
    return {"train_batch_size": gas * dp, "train_micro_batch_size_per_gpu": 1,
            "gradient_accumulation_steps": gas, "bf16": {"enabled": True},
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-4, "weight_decay": 0.1}},
            "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 8}},
            "gradient_clipping": 1.0, "zero_optimization": {"stage": stage},
            "steps_per_print": 10 ** 9, "seed": 0}


def _zero_class(name):
    """A device event's class, or None for c10d's ``nccl:*`` ranges, which
    span the NCCL kernels already counted."""
    low = name.lower()
    if low.startswith("nccl:"):
        return None
    if "nccl" in low:
        for key, cls in (("allgather", "nccl_all_gather"),
                         ("reducescatter", "nccl_reduce_scatter"),
                         ("allreduce", "nccl_all_reduce")):
            if key in low:
                return cls
        return "nccl_other"
    return _train_kernel_class(name)


def zero_held_bytes(engine):
    """(bytes the engine's tensors hold on this card: parameters, optimizer
    slots, gradients; the bytes of this rank's shards of them, whole leaves
    counted whole, from the full shapes and split dims; the full state's)."""
    from deepspeed_tpu_torch.ops.optimizers import is_slot
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths
    part = engine.partition
    held = 0
    for p, slot in zip(tree_leaves(engine.module_params),
                       tree_leaves(engine.opt_state["slots"], is_leaf=is_slot)):
        held += p.numel() * p.element_size()
        held += sum(t.numel() * t.element_size() for t in slot.values())
        if p.grad is not None:
            held += p.grad.numel() * p.grad.element_size()
    held += sum(g.numel() * g.element_size() for g in part.grad_shards.values())
    shapes = dict(tree_paths(part.full_shapes))
    allowed = full = 0
    for path, pd, od, gd in part.dims():
        n = math.prod(shapes[path])
        # f32 parameter, m and v, and the f32 gradient
        allowed += 4 * (n // (ZERO_RANKS if pd is not None else 1)
                        + 2 * n // (ZERO_RANKS if od is not None else 1)
                        + n // (ZERO_RANKS if gd is not None else 1))
        full += 16 * n
    return held, allowed, full


def zero_train_path(torch, rank, smi):
    """zero_train_path: ``initialize()`` on llama2-7b at full width and depth
    (random weights from seed 0, every rank drawing them whole and keeping
    its shard), ZeRO stage 3 over the four ranks, bf16 activations over f32
    parameters and Adam state, full recompute, S 4096, micro-batch 1 a rank,
    gas 2: one warm-up and four timed ``train_batch`` steps on one batch,
    every count set to 0 just before and read just after; then one step
    under torch.profiler. Returns K3 / K4 / K5 / K10 launches (this rank's)."""
    import torch.distributed as dist
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops.fused_adam import fused_adam_flat
    from deepspeed_tpu_torch.utils.tree import tree_leaves, tree_paths
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, _, _, _ = dst.initialize(model=build_model(ZERO_MODEL, remat="full"),
                                     config=zero_config(3, ZERO_GAS))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = engine.model.cfg
    n_params = sum(math.prod(s) for _, s in tree_paths(engine.partition.full_shapes))
    rows = ZERO_GAS * ZERO_RANKS
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (rows, ZERO_SEQ + 1), generator=g)
    batch = {"input_ids": ids[:, :-1].cuda(), "labels": ids[:, 1:].cuda()}

    counters = [FA.flash_attention_fwd, FA.flash_attention_dq, FA.flash_attention_dkv,
                fused_adam_flat]
    for f in counters:
        f.launches = 0
    losses = [engine.train_batch(batch) for _ in range(ZERO_WARM)]
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    losses += [engine.train_batch(batch) for _ in range(ZERO_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    losses = [float(x) for x in losses]
    held, allowed, full = zero_held_bytes(engine)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = ZERO_WARM + ZERO_TIMED
    micro = steps * ZERO_GAS
    leaves = len(tree_leaves(engine.module_params))
    want = {"flash_attention_fwd": 2 * cfg.num_layers * micro,     # forward and recompute
            "flash_attention_dq": cfg.num_layers * micro,
            "flash_attention_dkv": cfg.num_layers * micro,
            "fused_adam_flat": leaves * steps}
    ms_step = wall * 1e3 / ZERO_TIMED
    tokens_s = rows * ZERO_SEQ * ZERO_TIMED / wall
    flops_token = 6 * n_params + 12 * cfg.num_layers * cfg.hidden_size * ZERO_SEQ

    # one step under the profiler: device time by class
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.train_batch(batch)
        torch.cuda.synchronize()
    by_class, by_name = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        cls = _zero_class(ev.name)
        if cls is None:
            continue
        by_class[cls] = by_class.get(cls, 0.0) + us
        by_name[ev.name] = by_name.get(ev.name, 0.0) + us
    busy_ms = sum(by_class.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1])[:8]

    mine = dict(rank=rank, losses=losses, launches=launches, held_gb=held / 1e9,
                allowed_gb=allowed / 1e9, peak_gb=peak_gb, ms_step=ms_step, init_s=init_s,
                device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / ms_step),
                device_ms_by_class={k: v / 1e3 for k, v in sorted(by_class.items())},
                top_kernels_ms=[(k[:80], v / 1e3) for k, v in top])
    every = tp_gather(mine)
    if rank == 0:
        emit("zero_train_path", model=ZERO_MODEL, ranks=ZERO_RANKS, zero_stage=3,
             layers=cfg.num_layers, hidden=cfg.hidden_size, heads=cfg.num_heads,
             ffn=cfg.ffn_size, vocab=cfg.vocab_size, params=n_params, seq=ZERO_SEQ,
             micro_batch_per_rank=1, gas=ZERO_GAS, train_batch_size=rows,
             tokens_per_step=rows * ZERO_SEQ, remat="full",
             dtype="bfloat16 activations, f32 params and Adam state", warmup_steps=ZERO_WARM,
             timed_steps=ZERO_TIMED, launches_expected=want, ms_per_step=ms_step,
             tokens_per_s=tokens_s,
             mfu=flops_token * tokens_s / (BF16_FLOPS * ZERO_RANKS),
             mfu_formula="(6 * params + 12 * layers * hidden * seq) * tokens/s / "
                         "(989e12 * ranks)",
             full_state_gb=full / 1e9, per_rank=every, card=smi)
    tp_check(all(math.isfinite(x) for r in every for x in r["losses"]),
             "zero_train_path: a loss is not finite")
    tp_check(all(r["losses"] == every[0]["losses"] for r in every),
             "zero_train_path: the ranks' losses differ")
    tp_check(losses[-1] < losses[0], f"zero_train_path: the loss did not fall: {losses}")
    tp_check(launches == want, f"zero_train_path: launches {launches}, expected {want}")
    tp_check(held <= allowed, f"zero_train_path: the engine holds {held} bytes, its shards "
                              f"and whole leaves {allowed}")
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def zero_ref_model():
    from deepspeed_tpu_torch.models import build_model
    return build_model(ZERO_MODEL, num_layers=ZERO_REF_LAYERS, remat="full")


def zero_ref_batch(torch, vocab, shifted=False):
    """The reference check's global batch, 8 x 4096 tokens (seed 2).
    ``shifted``: each rank's slot of a global micro-batch holds the next
    rank's row and the last rank keeps its own (no wrap: a cyclic shift is
    a permutation of the rows and leaves the summed gradient as it was)."""
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, vocab, (ZERO_REF_ROWS, ZERO_SEQ + 1), generator=g)
    if shifted:
        ids = ids[[j + min(r + 1, ZERO_RANKS - 1)
                   for j in range(0, ZERO_REF_ROWS, ZERO_RANKS) for r in range(ZERO_RANKS)]]
    return {"input_ids": ids[:, :-1].cuda(), "labels": ids[:, 1:].cuda()}


def capture_first_grads(engine, n=2):
    """A list that receives, at the engine's first ``n`` updates, the
    gradients the optimizer is handed (reduced, unscaled, divided and
    clipped; f32, in the optimizer's layout), by dotted path."""
    from deepspeed_tpu_torch.utils.tree import tree_paths
    box = []
    apply = engine.optimizer.apply

    def first(grads, state, params, lr=None):
        if len(box) < n:
            box.append({k: t.clone() for k, t in tree_paths(grads)})
        return apply(grads, state, params, lr=lr)

    engine.optimizer.apply = first
    return box


def zero_reference_world1(torch):
    """The reference check's one-card run, in rank 0's process before it
    joins the group: 4 of llama2-7b's 32 layers at its widths, the engine
    at world 1 (gas 8 over the 8 rows), three steps on the global batch.
    Returns its losses, its first two reduced gradients and its parameters
    after each step (on the host)."""
    from deepspeed_tpu_torch.runtime.engine import DeepSpeedEngine
    from deepspeed_tpu_torch.utils.tree import tree_paths
    engine = DeepSpeedEngine(model=zero_ref_model(), config=zero_config(0, ZERO_REF_ROWS, 1),
                             device=torch.device("cuda", torch.cuda.current_device()))
    box = capture_first_grads(engine)
    batch = zero_ref_batch(torch, engine.model.cfg.vocab_size)
    losses, params = [], []
    for _ in range(ZERO_REF_STEPS):
        losses.append(float(engine.train_batch(batch)))
        params.append({k: t.detach().to("cpu", copy=True)
                       for k, t in tree_paths(engine.module_params)})
    ref = {"losses": losses, "grads": [{k: t.cpu() for k, t in g.items()} for g in box],
           "params": params}
    del engine, box, batch
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def zero_distance(torch, part, tree, dims, ref, rank):
    """(relative Frobenius distance over all leaves of ``tree`` (this rank's
    layout, split along ``dims``) from rank 0's whole ``ref``, the three
    leaves farthest from theirs by their own relative distance), each leaf
    gathered whole in turn; every rank gets both."""
    from deepspeed_tpu_torch.utils.tree import tree_paths
    dims = dict(tree_paths(dims))
    num = den = 0.0
    by_leaf = {}
    for path, t in tree_paths(tree):
        whole = part.gather(t.detach().float(), dims[path])
        if rank == 0:
            want = ref[path].to(whole.device).float()
            d, w = float((whole - want).square().sum()), float(want.square().sum())
            num, den = num + d, den + w
            by_leaf[path] = math.sqrt(d / w) if w else math.sqrt(d)
        del whole
    worst = sorted(by_leaf.items(), key=lambda kv_: -kv_[1])[:3]
    return tp_gather((math.sqrt(num / den), worst) if rank == 0 else None)[0]


def zero_reference_check(torch, rank, smi, ref):
    """zero_reference_check: stages 0-3 over the four ranks, three steps each
    on the one-card run's batch and weights (the same seed), against rank
    0's one-card run: step 1's reduced gradient within ZERO_GRAD_TOL
    (relative Frobenius, gathered) and each loss within ZERO_LOSS_TOL; a
    control (``zero_ref_batch(shifted=True)``, stage 0, one step) must miss
    the gradient gate. Step 2's gradient distance and the parameters'
    distance after each step are printed, with the farthest leaves."""
    import deepspeed_tpu_torch as dst
    ref_losses = tp_gather(ref["losses"] if rank == 0 else None)[0]
    rows = []
    for name, stage, shifted in (("stage0", 0, False), ("stage1", 1, False),
                                 ("stage2", 2, False), ("stage3", 3, False),
                                 ("control_next_rank_rows", 0, True)):
        engine, _, _, _ = dst.initialize(model=zero_ref_model(),
                                         config=zero_config(stage, ZERO_REF_ROWS // ZERO_RANKS))
        box = capture_first_grads(engine)
        batch = zero_ref_batch(torch, engine.model.cfg.vocab_size, shifted)
        steps = 1 if shifted else ZERO_REF_STEPS
        part = engine.partition
        losses, param_rel, wall = [], [], 0.0
        for i in range(steps):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            wall += time.perf_counter() - t0
            if not shifted:
                param_rel.append(zero_distance(torch, part, engine.module_params,
                                               part.param_dims,
                                               ref["params"][i] if rank == 0 else None, rank))
        grad_rel = [zero_distance(torch, part, got, part.opt_dims,
                                  ref["grads"][i] if rank == 0 else None, rank)
                    for i, got in enumerate(box)]
        loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        rows.append(dict(case=name, stage=stage, losses=losses, one_card_losses=ref_losses,
                         loss_rel=loss_rel, grad_rel_fro=grad_rel[0][0],
                         grad_rel_fro_by_step=[g[0] for g in grad_rel],
                         grad_worst_leaves_by_step=[g[1] for g in grad_rel],
                         param_rel_fro=param_rel[-1][0] if param_rel else None,
                         param_rel_fro_by_step=[p_[0] for p_ in param_rel],
                         param_worst_leaves_by_step=[p_[1] for p_ in param_rel],
                         wall_s=wall))
        del engine, box, batch
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        emit("zero_reference_check", model=ZERO_MODEL, layers=ZERO_REF_LAYERS,
             rows_per_step=ZERO_REF_ROWS, seq=ZERO_SEQ, ranks=ZERO_RANKS,
             one_card="world 1, gas 8, the same batch and seed", grad_tol=ZERO_GRAD_TOL,
             loss_tol=ZERO_LOSS_TOL, cases=rows, card=smi)
    for r in rows:
        if r["case"].startswith("control"):
            tp_check(r["grad_rel_fro"] > ZERO_GRAD_TOL,
                     f"zero_reference_check: the control met the gradient gate: {r}")
        else:
            tp_check(r["grad_rel_fro"] <= ZERO_GRAD_TOL and max(r["loss_rel"]) <= ZERO_LOSS_TOL,
                     f"zero_reference_check: {r}")


def zero_kernel_phases(torch):
    """K3-K5 at llama2-7b's attention (B 1, S 4096, H 32, D 128, causal)
    and K10 at the zero path's largest shard, each checked against its plain
    version and timed beside it, SDPA / AdamW and the bound. Returns their
    kernel entries (without launches)."""
    from deepspeed_tpu_torch.models import build_model
    cfg = build_model(ZERO_MODEL).cfg
    shape = dict(b=1, s=ZERO_SEQ, h=cfg.num_heads, kvh=cfg.kv_heads, d=cfg.dims_per_head)
    row = check_flash(torch, flash_case(torch, "llama2_7b_causal", **shape))
    errs = {"flash_attention_fwd": row["out"], "flash_attention_dq": row["dq"],
            "flash_attention_dkv": max(row["dk"], row["dv"])}
    torch.cuda.empty_cache()
    entries = flash_time_entries(
        torch, flash_case(torch, "llama2_7b_causal", **shape), errs,
        dict(B=1, S=ZERO_SEQ, H=cfg.num_heads, KVH=cfg.kv_heads, D=cfg.dims_per_head,
             dtype="bfloat16"))
    shard = cfg.num_layers * cfg.hidden_size * cfg.ffn_size // ZERO_RANKS   # mlp.wi_* / wo
    state, adam_err = check_adam(torch, shard, f"{ZERO_MODEL}_largest_shard")
    entries.append(adam_time_entry(torch, state, adam_err, f"{ZERO_MODEL}_largest_shard"))
    del state
    torch.cuda.empty_cache()
    return entries


def zero_nccl_rank(torch):
    """One rank of ``python3 chip_smoke.py zero-nccl``: its card; rank 0
    first runs the reference check's one-card run alone, then every rank
    joins the NCCL group over tcp://localhost and runs zero_train_path and
    zero_reference_check; rank 0 then checks and times the kernels at the
    path's shapes and prints the kernel line. The process ends with
    ``os._exit``, its code 0 only when every phase passed, so a rank that
    fails leaves at once and the launcher stops the others."""
    import datetime
    import os
    import traceback
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    code = 1
    try:
        rank = int(os.environ["RANK"])
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = zero_reference_world1(torch) if rank == 0 else None
        comm.init_distributed(dist_backend="nccl",
                              timeout=datetime.timedelta(seconds=ZERO_TIMEOUT_S))
        smi = nvidia_smi()
        launches = zero_train_path(torch, rank, smi)
        zero_reference_check(torch, rank, smi, ref)
        del ref
        if rank == 0:
            entries = zero_kernel_phases(torch)
            for e in entries:
                e["launches"] = launches["fused_adam_flat" if e["name"] == "fused_adam"
                                         else e["name"]]
                e["launches_counted_on"] = "zero_train_path, rank 0"
            print(json.dumps({"kernels": entries}), flush=True)
        dist.barrier()
        code = 0
    except SystemExit as e:            # fail(): its message is printed already
        code = e.code or 1
    except BaseException:              # noqa: BLE001 (reported, then the rank exits)
        traceback.print_exc()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def zero_nccl(torch, smi):
    """``python3 chip_smoke.py zero-nccl`` on a machine with four cards:
    builds K3-K5 and K10, prints the cards' links (``nvidia-smi topo -m``),
    starts one process per card (RANK 0-3, NCCL over tcp://localhost), and
    stops them all as soon as one fails or at ZERO_TIMEOUT_S."""
    import os
    import socket
    from deepspeed_tpu_torch.ops import op_builder
    if torch.cuda.device_count() < ZERO_RANKS:
        fail(f"zero-nccl needs {ZERO_RANKS} cards, found {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    op_builder.build(["flash_attention", "fused_adam"])
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    emit("zero_build", seconds=time.perf_counter() - t0, topology=topo.stdout.splitlines())
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {**os.environ, "WORLD_SIZE": str(ZERO_RANKS), "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    procs = [subprocess.Popen([sys.executable, __file__, "zero-nccl-rank"],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
             for r in range(ZERO_RANKS)]
    deadline = time.monotonic() + ZERO_TIMEOUT_S
    try:
        while any(p_.poll() is None for p_ in procs):
            if time.monotonic() > deadline or any(p_.poll() for p_ in procs):
                break
            time.sleep(1.0)
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
                p_.wait()
    codes = [p_.returncode for p_ in procs]
    if any(codes):
        fail(f"zero-nccl ranks exited {codes}")
    print(smi, flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the smoke runs on a GPU")
    try:
        import deepspeed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"deepspeed_tpu_torch not importable beside chip_smoke.py ({e})")
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if mode == "ring-nccl-rank":
        return ring_nccl_rank(torch)
    if mode == "tp-nccl-rank":
        return tp_nccl_rank(torch)
    if mode == "zero-nccl-rank":
        return zero_nccl_rank(torch)
    smi = nvidia_smi()
    if mode in ("ring-nccl", "tp-nccl", "zero-nccl"):
        {"ring-nccl": ring_nccl, "tp-nccl": tp_nccl, "zero-nccl": zero_nccl}[mode](torch, smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return
    if mode is not None:
        fail(f"unknown mode {mode!r}: run with no argument, or ring-nccl / tp-nccl / "
             "zero-nccl on four cards")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    entry = kernel_phases(torch)
    entry["launches"], main_tokens = main_path(torch, smi)
    gc.collect()                  # the serving engine is gone: its pools go back
    torch.cuda.empty_cache()
    quant_check(torch, smi)
    quant_serve_path(torch, smi, main_tokens)
    entry["launches_spec_path"] = spec_path(torch, smi, main_tokens)
    entry["launches_hier_path"] = hier_path(torch, smi)
    entry["launches_sched_path"] = sched_path(torch, smi)
    entry["launches_fault_path"] = fault_path(torch, smi)
    phi2_path(torch, smi)
    entries = train_phases(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    entries += v1_phases(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    entries += ops_phases(torch, smi)
    gc.collect()
    torch.cuda.empty_cache()
    entries += ring_phases(torch, smi)
    print(json.dumps({"kernels": [entry] + entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
