#!/usr/bin/env python3
"""Where the attention kernels' and the weight-only-quantized matmul's
time goes on the card: a clock64 count of each phase of the Hopper forward
(``ops/csrc/flash_fwd_wgmma.cuh``, K3, K13, K11 and K12), backward
(``ops/csrc/flash_bwd_wgmma.cuh``, K4 / K5 and K14 / K15) and of K6's
streaming and wgmma routes (``ops/csrc/woq_matmul.cu``).

    python3 chip_phase_count.py        # everything
    python3 chip_phase_count.py woq    # K6 only (builds only its library)

K6 first: the streaming route at M = 4 and the wgmma route at M = 2048 on
llama3-8b's gate and down projections at int8, int4 and fp6 (per warp
step: the wait for the step's bytes and the dequantization with its
products; per warp: staging x and the scales, and the sums across warps and
blocks; per wgmma batch: the stage wait, the byte loads, the
dequantization, the wait for the previous batch's products; per tile: the
epilogue and the producer's wait for free stages).

Copies the kernel sources into the build directory, adds clock64 counters
around each phase of the consumer loops and around the producer's wait for
a free stage, builds the copy (the repository's sources are left as they
are) and runs K3 at gpt2-xl's training shape (causal and not) and at a long
non-causal shape, K13 at qwen2-7b's shard shapes (the diagonal step and
a full one), K11 on the Fixed layout at bert-large's width (B 4, S 4096,
16 heads of 64, block 16; a warpgroup-tile is 64 rows by one stage of 8
key blocks) and K12 at (1, 512, 256, 4, 64); then K4 and K5 at gpt2-xl's training shape and K14 and K15 at
a full qwen2-7b step. Prints one JSON line per case: the clocks per
warpgroup-tile of each phase, summed over thread 0 of every consumer
warpgroup (and the producer's lane 0) and divided by the warpgroup-tiles
counted, then the card's name, power limit and SM clocks.
Forward phases: the item's set-up (carry loads, Q wait), the wait for a
full stage, S = Q K^T (issue to done), the wait for the element pass's
turn, the element pass, O += P V with its rescale (issue to done), the
item's epilogue, and the producer's wait for an empty stage. K11 and K12
form their logits (scale and mask; the two biases) outside the pass's
turn, so their "wait_turn" holds that work as well as the wait.
Backward phases (dq | dk/dv): the item's set-up (row loads, the Q/dO | K/V
wait), the wait for a full stage, S = Q K^T | S^T = K Q^T, the pass that
forms p | P^T, dP = dO V^T over both halves | dP^T = V dO^T with dv +=
P^T dO, the pass that forms ds | dS^T, dq += ds K | dk += dS^T Q (issue to
done), the item's epilogue, and the producer's wait for an empty stage. A
warpgroup-tile is 64 rows by 128 keys (dq) or 64 keys by 64 rows (dk/dv).
The counters cost a few instructions a phase, so the times are a little
above the uninstrumented kernel's. Exits 1 without a card, or if the
sources no longer have the text it patches.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = ["item_setup", "wait_full", "s_product", "wait_turn", "element_pass", "pv_product",
          "epilogue", "tiles", "producer_wait_empty"]

# (text in flash_fwd_wgmma.cuh, what replaces it): counters around each phase
PATCHES = [
    ("namespace flash_fwd {\n",
     "namespace flash_fwd {\n__device__ unsigned long long g_phase[9];\n"),
    ("    StageRing<SM::STAGES> ring;\n    uint32_t q_phase = 0;\n",
     "    StageRing<SM::STAGES> ring;\n    uint32_t q_phase = 0;\n    unsigned long long pp = 0;\n"),
    ("        mbar_wait(&empty[ring.s], ring.phase ^ 1);\n",
     "        long long tp = clock64();\n        mbar_wait(&empty[ring.s], ring.phase ^ 1);\n"
     "        pp += clock64() - tp;\n"),
    ("  } else {  // ---------------------------------------------------- consumers\n",
     "    if (lane == 0) atomicAdd(&g_phase[8], pp);\n"
     "  } else {  // ---------------------------------------------------- consumers\n"
     "    unsigned long long pf[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("      if (MODE == RING && it.lo >= it.hi) continue;  // no row sees this shard\n",
     "      if (MODE == RING && it.lo >= it.hi) continue;  // no row sees this shard\n"
     "      long long t_a = clock64();\n"),
    ("      for (int j = it.lo; j < it.hi; ++j, ring.next()) {\n"
     "        mbar_wait(&full[ring.s], ring.phase);\n",
     "      pf[0] += clock64() - t_a;\n      for (int j = it.lo; j < it.hi; ++j, ring.next()) {\n"
     "        long long t0 = clock64();\n        mbar_wait(&full[ring.s], ring.phase);\n"
     "        long long t1 = clock64();\n        pf[1] += t1 - t0;\n"),
    ("        if (j + 1 == it.hi) mbar_arrive(q_empty);  // Q is free for the next item\n",
     "        if (j + 1 == it.hi) mbar_arrive(q_empty);  // Q is free for the next item\n"
     "        long long t2 = clock64();\n        pf[2] += t2 - t1;\n"),
    ("        named_sync<CONSUMERS * WG>(own);\n        if (slope",
     "        named_sync<CONSUMERS * WG>(own);\n        long long tm = clock64();\n"
     "        pf[3] += tm - t2;\n        if (slope"),
    ("        named_arrive<CONSUMERS * WG>(other);\n\n",
     "        named_arrive<CONSUMERS * WG>(other);\n        long long t3 = clock64();\n"
     "        pf[4] += t3 - tm;\n\n"),
    ("        mbar_arrive(&empty[ring.s]);\n      }\n\n      // l across the quad",
     "        mbar_arrive(&empty[ring.s]);\n        pf[5] += clock64() - t3;\n        pf[7] += 1;\n"
     "      }\n      long long t_e = clock64();\n\n      // l across the quad"),
    ("                  __floats2bfloat162_rn(o[n][e] * inv[u], o[n][e + 1] * inv[u]);\n"
     "          }\n      }\n    }\n",
     "                  __floats2bfloat162_rn(o[n][e] * inv[u], o[n][e + 1] * inv[u]);\n"
     "          }\n      }\n      pf[6] += clock64() - t_e;\n    }\n"),
    ("    if (wg == 0) named_sync<CONSUMERS * WG>(own);\n  }\n}",
     "    if (wg == 0) named_sync<CONSUMERS * WG>(own);\n    if (t == 0)\n"
     "      for (int x = 0; x < 8; ++x) atomicAdd(&g_phase[x], pf[x]);\n  }\n}"),
]

BWD_PHASES = ["item_setup", "wait_full", "s_product", "wait_turn", "p_pass", "dp_product",
              "ds_pass", "grad_product", "epilogue", "tiles", "producer_wait_empty"]
# where flash_bwd_wgmma.cuh's dk/dv mainloop starts: patches name the
# mainloop ("dq" or "dkv") whose text they change, so that the two loops'
# like lines are told apart
BWD_SPLIT = "// dk and dv (K15 / K5)"
_BWD_END = ("      pf[8] += clock64() - t_e;\n    }\n    turns.finish();\n",
            "      pf[8] += clock64() - t_e;\n    }\n    turns.finish();\n    if (t == 0)\n"
            "      for (int x = 0; x < 10; ++x) atomicAdd(&g_bwd[x], pf[x]);\n")


def _bwd_common(loop, item_skip, item_wait, indent):
    """The patches both backward loops take alike: the producer's wait for
    an empty stage, the consumers' counters, the item's set-up, the wait
    for a full stage and for the pass's turn, and the pass (``indent``: the
    pass's indentation in the loop)."""
    return [
        (loop, "    StageRing<NS> ring;\n    StageRing<BUFS> buf;\n",
         "    StageRing<NS> ring;\n    StageRing<BUFS> buf;\n    unsigned long long pp = 0;\n"),
        (loop, "mbar_wait(&empty[ring.s], ring.phase ^ 1);\n",
         "long long tp = clock64();\nmbar_wait(&empty[ring.s], ring.phase ^ 1);\n"
         "pp += clock64() - tp;\n"),
        (loop, "  } else {  // ---------------------------------------------------- consumers\n",
         "    if (lane == 0) atomicAdd(&g_bwd[10], pp);\n"
         "  } else {  // ---------------------------------------------------- consumers\n"
         "    unsigned long long pf[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n"),
        (loop, item_skip, item_skip + "      long long t_a = clock64();\n"),
        (loop, item_wait, item_wait + "      pf[0] += clock64() - t_a;\n"),
        (loop, "mbar_wait(&full[ring.s], ring.phase);\n",
         "long long t0 = clock64();\nmbar_wait(&full[ring.s], ring.phase);\n"
         "long long t1 = clock64();\npf[1] += t1 - t0;\n"),
        (loop, f"{indent}turns.begin();\n",
         f"{indent}turns.begin();\n{indent}long long t2b = clock64();\n"
         f"{indent}pf[3] += t2b - t2;\n"),
        (loop, f"{indent}turns.end();\n",
         f"{indent}turns.end();\n{indent}long long t3 = clock64();\n{indent}pf[4] += t3 - t2b;\n"),
    ]


# (mainloop, text in flash_bwd_wgmma.cuh, what replaces it), applied in order
BWD_PATCHES = [
    ("dq", "namespace flash_bwd {\n",
     "namespace flash_bwd {\n__device__ unsigned long long g_bwd[11];\n"),
    ("dq", "          fence_regs(s);\n\n          // p = exp(s - lse)",
     "          fence_regs(s);\n          long long t2 = clock64();\n          pf[2] += t2 - t1;\n"
     "\n          // p = exp(s - lse)"),
    *_bwd_common("dq",
                 "      if (it.lo >= it.hi) continue;  // RING: nothing visible, dq gains 0 "
                 "(FLASH: never)\n",
                 "      mbar_wait(&q_full[buf.s], buf.phase);\n      buf.next();\n", " " * 10),
    ("dq", "            float dp[32];",
     "            long long t4 = clock64();\n            float dp[32];"),
    ("dq", "            if (PERSISTENT && hf == BK / 64 - 1 && last)",
     "            long long t5 = clock64();\n            pf[5] += t5 - t4;\n"
     "            if (PERSISTENT && hf == BK / 64 - 1 && last)"),
    ("dq", "            fence_regs(ds);\n            fence_regs(dq);\n",
     "            long long t6 = clock64();\n            pf[6] += t6 - t5;\n"
     "            fence_regs(ds);\n            fence_regs(dq);\n"),
    ("dq", "            wgmma_commit();\n          }\n          wgmma_wait<0>();\n",
     "            wgmma_commit();\n            pf[7] += clock64() - t6;\n          }\n"
     "          long long t7 = clock64();\n          wgmma_wait<0>();\n"),
    ("dq", "          fence_regs(dq);\n        } else {\n",
     "          fence_regs(dq);\n          pf[7] += clock64() - t7;\n          pf[9] += 1;\n"
     "        } else {\n"),
    ("dq", "      }\n\n      // the block owns its rows",
     "      }\n      long long t_e = clock64();\n\n      // the block owns its rows"),
    ("dq", "                            lane, r < p.Sq);\n        }\n      }\n",
     "                            lane, r < p.Sq);\n        }\n      }\n"
     "      pf[8] += clock64() - t_e;\n"),
    ("dq", *_BWD_END),
    ("dkv", "            fence_regs(s);\n\n            // P^T",
     "            fence_regs(s);\n            long long t2 = clock64();\n"
     "            pf[2] += t2 - t1;\n\n            // P^T"),
    *_bwd_common("dkv",
                 "      if (it.lo >= it.hi) continue;  // RING: no row sees these keys "
                 "(FLASH: never)\n",
                 "      mbar_wait(&kv_full[buf.s], buf.phase);\n      buf.next();\n", " " * 12),
    ("dkv", "            if (PERSISTENT && last) mbar_arrive(kv_free);  // K, V",
     "            long long t4 = clock64();\n            pf[5] += t4 - t3;\n"
     "            if (PERSISTENT && last) mbar_arrive(kv_free);  // K, V"),
    ("dkv", "            fence_regs(dst);\n            fence_regs(dk);\n",
     "            long long t5 = clock64();\n            pf[6] += t5 - t4;\n"
     "            fence_regs(dst);\n            fence_regs(dk);\n"),
    ("dkv", "            fence_regs(dk);\n          } else {\n",
     "            fence_regs(dk);\n            pf[7] += clock64() - t5;\n            pf[9] += 1;\n"
     "          } else {\n"),
    ("dkv", "      }\n\n      // the block owns its keys",
     "      }\n      long long t_e = clock64();\n\n      // the block owns its keys"),
    ("dkv", "dv, u, lane, c < p.Sk);\n        }\n      }\n",
     "dv, u, lane, c < p.Sk);\n        }\n      }\n      pf[8] += clock64() - t_e;\n"),
    ("dkv", *_BWD_END),
]


def patch_backward(text):
    """The backward header with BWD_PATCHES applied, each to the first
    occurrence of its text in its mainloop; None if one is missing."""
    cut = text.index(BWD_SPLIT) if BWD_SPLIT in text else -1
    if cut < 0:
        return None
    parts = {"dq": text[:cut], "dkv": text[cut:]}
    for loop, old, new in BWD_PATCHES:
        if old not in parts[loop]:
            print(f"chip_phase_count: FAILED: the backward's {loop} loop no longer has {old!r}",
                  file=sys.stderr)
            return None
        parts[loop] = parts[loop].replace(old, new, 1)
    return parts["dq"] + parts["dkv"]


# K6, the weight-only-quantized matmul (ops/csrc/woq_matmul.cu): clocks of
# the streaming route (small M) per warp step and of the wgmma route (large
# M) per consumer k16 step, from lane 0 of each warp (stream) or thread 0 of
# each consumer warpgroup and the producer (wgmma)
WOQ_STREAM_PHASES = ["stage", "wait_bytes", "dequant_mma", "reduce", "steps", "warps"]
WOQ_WGMMA_PHASES = ["wait_full", "lds_bytes", "dequant", "wgmma_wait", "epilogue", "batches",
                    "producer_wait_empty", "tiles"]
WOQ_PATCHES = [
    ("namespace stream {\n",
     "namespace stream {\n__device__ unsigned long long g_woq_stream[6];\n"),
    ("  float sc[F::PK][16];\n  int i = 0;",
     "  float sc[F::PK][16];\n  unsigned long long pc[4] = {0, 0, 0, 0}, nst = 0;\n"
     "  long long tph = 0;\n  int i = 0;"),
    ("    __syncthreads();   // the previous chunk's slice and scales are read\n",
     "    tph = clock64();\n"
     "    __syncthreads();   // the previous chunk's slice and scales are read\n"),
    ("    __syncthreads();\n    int gcur = -1;\n",
     "    __syncthreads();\n    pc[0] += clock64() - tph;\n    int gcur = -1;\n"),
    ("        if (i0 + u < n_w) {\n",
     "        if (i0 + u < n_w) {\n          const long long tw0 = clock64();\n"
     "#pragma unroll\n          for (int l = 0; l < LOADS; ++l)\n"
     "            asm volatile(\"mov.b32 %0, %0;\" : \"+r\"(raw[u][l].x));\n"
     "          const long long tw1 = clock64();\n          pc[1] += tw1 - tw0;\n"),
    ("          load(raw[u], i + u + F::U);\n",
     "          pc[2] += clock64() - tw1;\n          ++nst;\n"
     "          load(raw[u], i + u + F::U);\n"),
    ("  // the four warps' sums into `red`",
     "  tph = clock64();\n  // the four warps' sums into `red`"),
    ("  cluster_sync();   // no block leaves while another reads its shared memory\n",
     "  cluster_sync();   // no block leaves while another reads its shared memory\n"
     "  pc[3] += clock64() - tph;\n  if (lane == 0) {\n"
     "    for (int q = 0; q < 4; ++q) atomicAdd(&g_woq_stream[q], pc[q]);\n"
     "    atomicAdd(&g_woq_stream[4], nst);\n    atomicAdd(&g_woq_stream[5], 1ull);\n  }\n"),
    ("namespace wg {\n", "namespace wg {\n__device__ unsigned long long g_woq_wg[8];\n"),
    ("      StageRing<F::STAGES> ring;\n      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n",
     "      StageRing<F::STAGES> ring;\n      unsigned long long pp = 0;\n"
     "      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n"),
    ("          mbar_wait(&empty[ring.s], ring.phase ^ 1);\n",
     "          const long long tp = clock64();\n"
     "          mbar_wait(&empty[ring.s], ring.phase ^ 1);\n          pp += clock64() - tp;\n"),
    ("((hh * F::SL + pl) * a.Kp + ks * BR) / a.g);\n          }\n      }\n",
     "((hh * F::SL + pl) * a.Kp + ks * BR) / a.g);\n          }\n      }\n"
     "      atomicAdd(&g_woq_wg[6], pp);\n"),
    ("  uint32_t afr[2][FR][4];\n  StageRing<F::STAGES> ring;\n",
     "  uint32_t afr[2][FR][4];\n  StageRing<F::STAGES> ring;\n"
     "  unsigned long long pf[6] = {0, 0, 0, 0, 0, 0}, ntile = 0;\n"
     "  long long tq = 0, tr = 0;\n"),
    ("      mbar_wait(&full[ring.s], ring.phase);\n      const unsigned char* st",
     "      tq = clock64();\n      mbar_wait(&full[ring.s], ring.phase);\n"
     "      tr = clock64();\n      pf[0] += tr - tq;\n      const unsigned char* st"),
    ("      // batches of KB k16 steps",
     "      tq = clock64();\n      pf[1] += tq - tr;\n      // batches of KB k16 steps"),
    ("        const int buf = bt & 1;\n",
     "        const int buf = bt & 1;\n        tq = clock64();\n"),
    ("        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < KB; ++kk)",
     "        wgmma_fence();\n        tr = clock64();\n        pf[2] += tr - tq;\n"
     "        ++pf[5];\n#pragma unroll\n        for (int kk = 0; kk < KB; ++kk)"),
    ("        wgmma_wait<1>();   // the previous batch's products are done\n",
     "        tq = clock64();\n"
     "        wgmma_wait<1>();   // the previous batch's products are done\n"
     "        pf[3] += clock64() - tq;\n"),
    ("    wgmma_wait<0>();\n#pragma unroll\n    for (int f = 0; f < FR; ++f) {\n",
     "    tq = clock64();\n    wgmma_wait<0>();\n#pragma unroll\n    for (int f = 0; f < FR; ++f) {\n"),
    ("                pack_bf16(acc[mt][4 * jj + e], acc[mt][4 * jj + 2 + e]);\n        }\n  }\n",
     "                pack_bf16(acc[mt][4 * jj + e], acc[mt][4 * jj + 2 + e]);\n        }\n"
     "    pf[4] += clock64() - tq;\n    ++ntile;\n  }\n"
     "  if (tid == 0) {\n    for (int q = 0; q < 4; ++q) atomicAdd(&g_woq_wg[q], pf[q]);\n"
     "    atomicAdd(&g_woq_wg[4], pf[4]);\n    atomicAdd(&g_woq_wg[5], pf[5]);\n"
     "    atomicAdd(&g_woq_wg[7], ntile);\n  }\n"),
]
WOQ_READER = """
extern "C" int ds_phase_count_woq(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, stream::g_woq_stream, sizeof stream::g_woq_stream);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(out + 6, wg::g_woq_wg, sizeof wg::g_woq_wg);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(stream::g_woq_stream, zero, 6 * sizeof zero[0]);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(wg::g_woq_wg, zero, sizeof zero);
  return e;
}
"""


def patch_woq(text):
    """The K6 source with the counters in, or None (with the missing text
    printed) when a patched line is gone."""
    for old, new in WOQ_PATCHES:
        if old not in text:
            print(f"chip_phase_count: FAILED: woq_matmul.cu no longer has {old!r}",
                  file=sys.stderr)
            return None
        text = text.replace(old, new, 1)
    # the reader goes after the anonymous namespace that holds stream and wg
    cut = text.rindex("}  // namespace\n") + len("}  // namespace\n")
    return text[:cut] + WOQ_READER + text[cut:]


FWD_READER = '''
extern "C" int ds_phase_count(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, flash_fwd::g_phase, sizeof flash_fwd::g_phase);
  const unsigned long long zero[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(flash_fwd::g_phase, zero, sizeof zero);
  return e;
}
'''
BWD_READER = '''
extern "C" int ds_phase_count_bwd(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, flash_bwd::g_bwd, sizeof flash_bwd::g_bwd);
  const unsigned long long zero[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(flash_bwd::g_bwd, zero, sizeof zero);
  return e;
}
'''


ALL_LIBS = ("flash_attention", "ring_flash", "sparse_flash", "evoformer_flash", "woq_matmul")


def instrumented_build(op_builder, names=None):
    """Point op_builder at a patched copy of the sources and build the named
    libraries from it."""
    src = op_builder.CSRC
    root = op_builder.BUILD_DIR / "phase_count"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(src, root / "csrc")
    header = root / "csrc" / "flash_fwd_wgmma.cuh"
    text = header.read_text()
    for old, new in PATCHES:
        if old not in text:
            print(f"chip_phase_count: FAILED: the forward no longer has {old!r}", file=sys.stderr)
            sys.exit(1)
        text = text.replace(old, new, 1)
    header.write_text(text)
    bwd = root / "csrc" / "flash_bwd_wgmma.cuh"
    text = patch_backward(bwd.read_text())
    if text is None:
        sys.exit(1)
    bwd.write_text(text)
    for name, reader in (("flash_attention", FWD_READER + BWD_READER),
                         ("ring_flash", FWD_READER + BWD_READER),
                         ("sparse_flash", FWD_READER), ("evoformer_flash", FWD_READER)):
        path = root / "csrc" / f"{name}.cu"
        path.write_text(path.read_text() + reader)
    woq = root / "csrc" / "woq_matmul.cu"
    text = patch_woq(woq.read_text())
    if text is None:
        sys.exit(1)
    woq.write_text(text)
    op_builder.CSRC = root / "csrc"
    op_builder.BUILD_DIR = root / "build"
    op_builder.build(list(names or ALL_LIBS))


def count(torch, op_builder, lib, fn, calls, phases=PHASES, reader="ds_phase_count"):
    """Clocks per warpgroup-tile of each phase over ``calls`` calls."""
    buf = (ctypes.c_ulonglong * len(phases))()
    read = getattr(op_builder.load(lib), reader)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    fn()
    torch.cuda.synchronize()
    read(buf)                        # drops the warm-up call's counts
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    if read(buf) != 0:
        print("chip_phase_count: FAILED: reading the counters", file=sys.stderr)
        sys.exit(1)
    vals = dict(zip(phases, buf))
    tiles = vals.pop("tiles")
    out = {k: v / tiles for k, v in vals.items()}
    out["warpgroup_tiles_per_call"] = tiles / calls
    return out


def woq_counts(torch, op_builder):
    """K6 on llama3-8b's gate and down projections (group 256): the streaming
    route at M = 4 and the wgmma route at M = 2048, each bit width. Stream
    clocks are per warp step (16 k values of 128 columns; "stage" and
    "reduce" per warp), wgmma clocks per consumer batch of fragments (two
    k16 steps of each slab for int8 / int4, one step's four slabs for fp6,
    64 columns by BM rows; "wait_full" and "lds_bytes" once a stage of 4 k16
    steps, "epilogue" per tile, "producer_wait_empty" per tile)."""
    from deepspeed_tpu_torch.ops import woq_matmul as W
    g = torch.Generator(device="cuda").manual_seed(4)
    phases = WOQ_STREAM_PHASES + WOQ_WGMMA_PHASES
    for pname, (k, n) in (("gate", (4096, 14336)), ("down", (14336, 4096))):
        w = torch.randn(k, n, generator=g, device="cuda").mul_(0.02).to(torch.bfloat16)
        for bits in (8, 4, 6):
            st = W.quantize_woq(w, bits, 256)
            for m in (4, 2048):
                x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
                buf = (ctypes.c_ulonglong * len(phases))()
                read = op_builder.load("woq_matmul").ds_phase_count_woq
                read.argtypes = [ctypes.c_void_p]
                read.restype = ctypes.c_int
                W.woq_matmul(x, st)
                torch.cuda.synchronize()
                read(buf)
                calls = 10
                for _ in range(calls):
                    W.woq_matmul(x, st)
                torch.cuda.synchronize()
                if read(buf) != 0:
                    print("chip_phase_count: FAILED: reading the K6 counters", file=sys.stderr)
                    sys.exit(1)
                v = dict(zip(phases, buf))
                route = W.woq_route(m, n, bits)
                if route == "stream":
                    per_step = {p: v[p] / max(v["steps"], 1) for p in ("wait_bytes", "dequant_mma")}
                    per_warp = {p: v[p] / max(v["warps"], 1) for p in ("stage", "reduce")}
                    out = dict(per_step=per_step, per_warp=per_warp,
                               steps_per_warp=v["steps"] / max(v["warps"], 1),
                               warps_per_call=v["warps"] / calls)
                else:
                    nb = max(v["batches"], 1)
                    out = dict(per_batch={p: v[p] / nb for p in
                                          ("wait_full", "lds_bytes", "dequant", "wgmma_wait")},
                               epilogue_per_tile=v["epilogue"] / max(v["tiles"], 1),
                               producer_wait_empty_per_tile=v["producer_wait_empty"]
                               / max(v["tiles"] / 2, 1),
                               batches_per_tile=nb / max(v["tiles"], 1),
                               warpgroup_tiles_per_call=v["tiles"] / calls)
                print(json.dumps({"phase": "phase_count", "kernel": "woq_matmul", "proj": pname,
                                  "K": k, "N": n, "M": m, "bits": bits, "route": route,
                                  "clocks": out}), flush=True)
                del x
            del st
        del w
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_count: FAILED: no card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import evoformer_flash as EF
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.ops import sparse_flash as SF
    from deepspeed_tpu_torch.sequence import ring_flash as RF
    only_woq = sys.argv[1:] == ["woq"]
    instrumented_build(op_builder, ("woq_matmul",) if only_woq else None)
    woq_counts(torch, op_builder)
    if only_woq:
        return
    for b, s, h, causal in ((cs.TRAIN_MICRO, cs.TRAIN_SEQ, 25, True),
                            (cs.TRAIN_MICRO, cs.TRAIN_SEQ, 25, False), (2, 4096, 25, False)):
        c = cs.flash_case(torch, "k3", b=b, s=s, h=h, kvh=h, d=64, causal=causal)
        q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
        phases = count(torch, op_builder, "flash_attention",
                       lambda: FA.flash_attention_fwd(q, k, v, **kw), calls=20)
        print(json.dumps({"phase": "phase_count", "kernel": "flash_attention_fwd",
                          "shape": dict(B=b, S=s, H=h, D=64, causal=causal),
                          "clocks_per_warpgroup_tile": phases}), flush=True)
    for i, kind in enumerate(("diagonal", "below")):
        qo, ko = cs.RING_STEPS[kind]
        c = cs.ring_case(torch, kind, b=1, s=cs.RING_SHARD, h=cs.RING_H, kvh=cs.RING_KVH,
                         d=cs.RING_D, q_off=qo, k_off=ko, seed=20 + i)
        q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
        m, l, acc = (c[n].clone() for n in ("m", "l", "acc"))
        phases = count(torch, op_builder, "ring_flash",
                       lambda: RF.ring_fwd_step(q, k, v, m, l, acc, **kw), calls=5)
        print(json.dumps({"phase": "phase_count", "kernel": "ring_fwd_step", "case": kind,
                          "clocks_per_warpgroup_tile": phases}), flush=True)
    h = 16
    c = cs.sparse_inputs(torch, b=cs.SPARSE_B, s=cs.SPARSE_S, h=h, kvh=h, d=64,
                         layout=cs.sparse_configs(h)["fixed"].make_layout(cs.SPARSE_S),
                         causal=False, seed=4)
    phases = count(torch, op_builder, "sparse_flash",
                   lambda: cs.sparse_call(SF.sparse_flash_fwd, c), calls=20)
    print(json.dumps({"phase": "phase_count", "kernel": "sparse_flash_fwd", "case": "fixed",
                      "shape": dict(B=cs.SPARSE_B, S=cs.SPARSE_S, H=h, D=64),
                      "clocks_per_warpgroup_tile": phases}), flush=True)
    c = cs.evo_inputs(torch, cs.EVO_MAIN, seed=5)
    phases = count(torch, op_builder, "evoformer_flash",
                   lambda: cs.evo_call(EF.evoformer_flash_fwd, c), calls=20)
    print(json.dumps({"phase": "phase_count", "kernel": "evoformer_flash_fwd", "case": "main_path",
                      "shape": dict(zip("BNSHD", cs.EVO_MAIN)),
                      "clocks_per_warpgroup_tile": phases}), flush=True)
    del c
    bwd = dict(phases=BWD_PHASES, reader="ds_phase_count_bwd")
    c = cs.flash_case(torch, "k4_k5", b=cs.TRAIN_MICRO, s=cs.TRAIN_SEQ, h=25, kvh=25, d=64)
    q, k, v, do, kw = c["q"], c["k"], c["v"], c["do"], c["kw"]
    out, lse = FA.flash_attention_fwd(q, k, v, **kw)
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
    for name, fn in (("flash_attention_dq",
                      lambda: FA.flash_attention_dq(q, k, v, do, lse, delta, **kw)),
                     ("flash_attention_dkv",
                      lambda: FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw))):
        phases = count(torch, op_builder, "flash_attention", fn, calls=20, **bwd)
        print(json.dumps({"phase": "phase_count", "kernel": name,
                          "shape": dict(B=cs.TRAIN_MICRO, S=cs.TRAIN_SEQ, H=25, D=64, causal=True),
                          "clocks_per_warpgroup_tile": phases}), flush=True)
    del c, q, k, v, do, out, lse, delta
    qo, ko = cs.RING_STEPS["below"]
    c = cs.ring_case(torch, "below", b=1, s=cs.RING_SHARD, h=cs.RING_H, kvh=cs.RING_KVH,
                     d=cs.RING_D, q_off=qo, k_off=ko, seed=22)
    q, k, v, do, lse, delta, kw = (c[n] for n in ("q", "k", "v", "do", "lse", "delta", "kw"))
    dq, dk, dv = (c[n].clone() for n in ("dq", "dk", "dv"))
    for name, fn in (("ring_dq_step", lambda: RF.ring_dq_step(q, k, v, do, lse, delta, dq, **kw)),
                     ("ring_dkv_step",
                      lambda: RF.ring_dkv_step(q, k, v, do, lse, delta, dk, dv, **kw))):
        phases = count(torch, op_builder, "ring_flash", fn, calls=5, **bwd)
        print(json.dumps({"phase": "phase_count", "kernel": name, "case": "below",
                          "clocks_per_warpgroup_tile": phases}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
