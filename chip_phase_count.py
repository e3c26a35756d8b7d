#!/usr/bin/env python3
"""Where the attention forward's time goes on the card: a clock64 count of
each phase of the Hopper forward (``ops/csrc/flash_fwd_wgmma.cuh``, K3 and
K13).

    python3 chip_phase_count.py

Copies the kernel sources into the build directory, adds clock64 counters
around each phase of the forward's consumer loop and around the producer's
wait for a free stage, builds the copy (the repository's sources are left
as they are) and runs K3 at gpt2-xl's training shape (causal and not) and
at a long non-causal shape, and K13 at qwen2-7b's shard shapes (the
diagonal step and a full one). Prints one JSON line per case: the clocks
per warpgroup-tile of each phase, summed over thread 0 of every consumer
warpgroup (and the producer's lane 0) and divided by the warpgroup-tiles
counted, then the card's name, power limit and SM clocks. Phases: the
item's set-up (carry loads, Q wait), the wait for a full stage, S = Q K^T
(issue to done), the wait for the element pass's turn, the element pass,
O += P V with its rescale (issue to done), the item's epilogue, and the
producer's wait for an empty stage. The counters cost a few instructions a
phase, so the times are a little above the uninstrumented kernel's. Exits
1 without a card, or if the sources no longer have the text it patches.
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
    ("    Ring ring;\n    uint32_t q_phase = 0;\n",
     "    Ring ring;\n    uint32_t q_phase = 0;\n    unsigned long long pp = 0;\n"),
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

READER = '''
extern "C" int ds_phase_count(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, flash_fwd::g_phase, sizeof flash_fwd::g_phase);
  const unsigned long long zero[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(flash_fwd::g_phase, zero, sizeof zero);
  return e;
}
'''


def instrumented_build(op_builder):
    """Point op_builder at a patched copy of the sources and build it."""
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
    for name in ("flash_attention.cu", "ring_flash.cu"):
        path = root / "csrc" / name
        path.write_text(path.read_text() + READER)
    op_builder.CSRC = root / "csrc"
    op_builder.BUILD_DIR = root / "build"
    op_builder.build(["flash_attention", "ring_flash"])


def count(torch, op_builder, lib, fn, calls):
    """Clocks per warpgroup-tile of each phase over ``calls`` calls."""
    buf = (ctypes.c_ulonglong * 9)()
    read = op_builder.load(lib).ds_phase_count
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
    vals = dict(zip(PHASES, buf))
    tiles = vals.pop("tiles")
    out = {k: v / tiles for k, v in vals.items()}
    out["warpgroup_tiles_per_call"] = tiles / calls
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_phase_count: FAILED: no card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import flash_attention as FA
    from deepspeed_tpu_torch.ops import op_builder
    from deepspeed_tpu_torch.sequence import ring_flash as RF
    instrumented_build(op_builder)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
