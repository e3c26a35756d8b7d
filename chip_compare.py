#!/usr/bin/env python3
"""Time the two training slices, paged attention, the weight-only-quantized
matmul and fused decode attention, and the two block-sparse / Evoformer
kernels of this checkout against another tree of the repository on one
card.

    python3 chip_compare.py OTHER_DIR

OTHER_DIR holds another tree of the repository, for example the parent
commit (``git archive <commit> | tar -x -C OTHER_DIR``). Each tree runs in
a child process of its own, in the order other, this, this, other, so both
meet the card in the same states: first the tree's own
``chip_smoke.kernel_phases`` (phases 2-4: the build, K1 against its plain
version and timed beside gather + SDPA) and ``chip_smoke.main_path``
(phases 5-7: ``serve()`` on llama3-8b and its decode and prefill steps'
profile); then K1 (paged attention) on the decode, prefill and mixed
serving steps of llama3-8b (``chip_smoke.K1_MAIN``, 8 layers of pool
cycled) beside gather + SDPA; then K6 (the weight-only-quantized
matmul) on llama3-8b's gate, down and q projections at int8, int4 and fp6
and M = 4 and 2048, beside torch.matmul on the dequantized bf16 weight, and
K2 (fused decode attention) on the main (B 4, 8192 live slots a sequence)
and mixed cases and at B 1 and 16 on full caches, beside SDPA, all timed by
the same code in both trees: "ms" is device time (the calls replayed from
one CUDA graph), "event_ms" back-to-back calls by CUDA events; then K9 (the
fp8 quantizer) on llama3-8b's stacked wi_gate leaf (bf16, group 256) in
e4m3 and e5m2, rounding to nearest and stochastic, by CUDA events beside
its byte bound, by the same code in both trees; then K11 on the three layouts of the
public-ops slice (B 4, S 4096, 16 heads of 64, block 16) and K12 at
(1, 512, 256, 4, 64), each beside SDPA with the same mask or summed bias,
timed by the same code in both trees; then the tree's own
``chip_smoke.ring_kernel_time`` (phase 23: K13, K14 and K15 per step kind
at qwen2-7b's shard shapes beside SDPA) and ``chip_smoke.ring_train_path``
(phase 24: qwen2-7b at full width, 4 layers, one 32768-token sequence a
step over 4 shards, then its step profile); then the flash forward (K3) at
gpt2-xl's training shape beside SDPA's forward and the flash backward (K4,
K5) beside SDPA's autograd backward, timed by the same code in both trees
(the ``train_kernel_time`` rows of phase 9), and the tree's own
``chip_smoke.train_path`` (phase 10: gpt2-xl at full width and depth, then
its step profile). The children's JSON lines pass through; the last line
is a summary by tree, in run order: each kernel's ms per step kind (K1:
graph ms by serving step; K3, K4, K5: case gpt2xl_causal; K9 per format and
rounding; K11 per layout; K12: main_path) with the
library call's ms beside it, and
each train step's ms, tokens/s, MFU, peak memory and idle share. Exits 1
without a card or when a child fails.
"""

import json
import os
import subprocess
import sys

CHILD = """
import gc, sys, torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import flash_attention as FA
from deepspeed_tpu_torch.ops import evoformer_flash as EF
from deepspeed_tpu_torch.ops import sparse_flash as SF
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = cs.nvidia_smi()
cs.kernel_phases(torch)   # builds every kernel; K1 checked and timed
cs.main_path(torch, smi)  # the serving step on llama3-8b, then its profile
gc.collect()
torch.cuda.empty_cache()
import statistics
from deepspeed_tpu_torch.ops import woq_matmul as W
from deepspeed_tpu_torch.ops import decode_attention as DA


def graph_ms(fn, iters=20, reps=5):
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
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(times)


from deepspeed_tpu_torch.ops import paged_attention as PA
K1_CASES = {   # chip_smoke.K1_MAIN of this tree, spelled out so both trees run the same cases
    "decode": dict(ctx=[99, 1999, 732, 1499, 256, 1023, 1898, 411] + [0] * 8, c=1,
                   valid=[1] * 8 + [0] * 8),
    "prefill": dict(ctx=[0, 256, 512, 768, 1024, 1280, 1536, 1792] + [0] * 8, c=128,
                    valid=[128] * 7 + [57] + [0] * 8, seed=1),
    "mixed": dict(ctx=[1024, 1536, 2048, 3072, 3500, 2500, 1500, 3900] + [0] * 8, c=128,
                  valid=[128] * 4 + [1] * 4 + [0] * 8, seed=17)}
for name, kw in K1_CASES.items():
    c = cs.make_case(torch, name, layers=8, **kw)
    kern = lambda i: cs.call(PA.paged_ragged_attention, c, i % 8)
    lib = lambda i: cs.library_call(torch, c, i % 8)
    cs.emit("k1_kernel_time", kernel="paged_attention", case=name, ms=graph_ms(kern),
            event_ms=cs.cuda_ms(torch, kern), library_ms=graph_ms(lib),
            library_event_ms=cs.cuda_ms(torch, lib),
            library="pages gathered + F.scaled_dot_product_attention (boolean mask)",
            bound_ms=cs.bound(*cs.case_work(c))[0], card=smi)
    del c
    torch.cuda.empty_cache()
g = torch.Generator(device="cuda").manual_seed(4)
for pname in ("gate", "down", "q"):
    k, n = cs.PROJ[pname]
    w = torch.randn(k, n, generator=g, device="cuda").mul_(0.02).to(torch.bfloat16)
    for bits in (8, 4, 6):
        st = W.quantize_woq(w, bits, cs.WOQ_GROUP)
        qbytes = st["q"].numel() + st["scales"].numel() * 4
        copies = [st] + [dict(st, q=st["q"].clone(), scales=st["scales"].clone())
                         for _ in range(int(2 * cs.L2_BYTES // qbytes))]
        w_deq = W.woq_dequantize(st, torch.bfloat16)
        libs = [w_deq] + [w_deq.clone() for _ in range(int(2 * cs.L2_BYTES // (2 * k * n)))]
        for m in (4, 2048):
            x = torch.randn(m, k, generator=g, device="cuda").to(torch.bfloat16)
            kern = lambda i: W.woq_matmul(x, copies[i % len(copies)])
            lib = lambda i: x @ libs[i % len(libs)]
            nbytes = qbytes + m * k * 2 + m * n * 2
            cs.emit("woq_kernel_time", kernel="woq_matmul", case=f"{pname}/int{bits}/M{m}",
                    ms=graph_ms(kern), event_ms=cs.cuda_ms(torch, kern),
                    library_ms=graph_ms(lib), library_event_ms=cs.cuda_ms(torch, lib),
                    library="x @ the pre-dequantized bf16 weight (torch.matmul)",
                    bound_ms=cs.bound(nbytes, 2 * m * k * n)[0], card=smi)
            del x
        del st, copies, w_deq, libs
    del w
    torch.cuda.empty_cache()
for name, lens in (("main", [8192] * 4), ("mixed", [8192, 8065, 4097, 1, 0]),
                   ("B1", [8192]), ("B16", [8192] * 16)):
    c = cs.decode_case(torch, lens, seed=1)
    kern = lambda i: DA.fused_decode_attention(c["q"], c["k"], c["v"], c["lens"])
    lib = cs.sdpa_decode(torch, c)
    cs.emit("v1_kernel_time", kernel="fused_decode_attention", case=name, ms=graph_ms(kern),
            event_ms=cs.cuda_ms(torch, kern), library_ms=graph_ms(lib),
            library_event_ms=cs.cuda_ms(torch, lib),
            library="F.scaled_dot_product_attention (boolean mask, enable_gqa)",
            bound_ms=cs.bound(*cs.decode_work(c))[0], card=smi)
    del c
    torch.cuda.empty_cache()
from deepspeed_tpu_torch.ops import fp_quantizer as FQ
w = torch.randn(*cs.WI_GATE, generator=g, device="cuda", dtype=torch.bfloat16).mul_(0.02)
n_el = w.numel()
for fmt in ("e4m3", "e5m2"):
    for st in (False, True):
        cs.emit("ops_kernel_time", kernel="quantize_fp8",
                case=f"{fmt}_{'stochastic' if st else 'nearest'}",
                ms=cs.cuda_ms(torch, lambda i: FQ.quantize_fp8(w, cs.FP8_GROUP, fmt, st, seed=5),
                              reps=5, iters=5),
                bound_ms=cs.bound(3 * n_el + 4 * (n_el // cs.FP8_GROUP), 0)[0], card=smi)
del w
torch.cuda.empty_cache()
for name, cfg in cs.sparse_configs(16).items():
    c = cs.sparse_inputs(torch, b=cs.SPARSE_B, s=cs.SPARSE_S, h=16, kvh=16, d=64,
                         layout=cfg.make_layout(cs.SPARSE_S), causal=False, seed=4)
    token = SF.token_mask_from_tiles(c["table"], c["counts"], c["bits"])
    qh, kh, vh = (c[x].transpose(1, 2) for x in "qkv")
    nbytes, flops = cs.sparse_work(c)
    ms = cs.cuda_ms(torch, lambda i: cs.sparse_call(SF.sparse_flash_fwd, c))
    lib = cs.cuda_ms(torch, lambda i: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=token),
                     reps=3, iters=5)
    cs.emit("ops_kernel_time", kernel="sparse_flash_fwd", case=name, ms=ms, library_ms=lib,
            library="F.scaled_dot_product_attention with the (S, S) boolean token mask",
            bound_ms=cs.bound(nbytes, flops)[0], bytes=nbytes, flops=flops,
            tflops=flops / ms / 1e9, card=smi)
    del c, token, qh, kh, vh
c = cs.evo_inputs(torch, cs.EVO_MAIN, seed=5)
b, n, s, hh, dd = cs.EVO_MAIN
qf, kf, vf = (c[x].reshape(b * n, hh, s, dd) for x in "qkv")
bias = (c["b1"].reshape(b * n, 1, 1, s) + c["b2"].reshape(b, hh, s, s).repeat_interleave(n, 0)
        ).to(torch.bfloat16)
nbytes, flops = cs.evo_work(c)
ms = cs.cuda_ms(torch, lambda i: cs.evo_call(EF.evoformer_flash_fwd, c))
lib = cs.cuda_ms(torch, lambda i: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=bias,
                                                                 scale=dd ** -0.5))
cs.emit("ops_kernel_time", kernel="evoformer_flash_fwd", case="main_path", ms=ms, library_ms=lib,
        library="F.scaled_dot_product_attention with b1 + b2 summed into a bf16 mask",
        bound_ms=cs.bound(nbytes, flops)[0], bytes=nbytes, flops=flops,
        tflops=flops / ms / 1e9, card=smi)
del c, qf, kf, vf, bias
torch.cuda.empty_cache()
cs.ring_kernel_time(torch)
engine = cs.ring_train_path(torch, smi)[0]
del engine
gc.collect()
torch.cuda.empty_cache()
case = cs.flash_case(torch, "gpt2xl_causal", b=cs.TRAIN_MICRO, s=cs.TRAIN_SEQ, h=25, kvh=25, d=64)
q, k, v, kw = case["q"], case["k"], case["v"], case["kw"]
nbytes, flops = cs.flash_work(case)["flash_attention_fwd"]
ms = cs.cuda_ms(torch, lambda i: FA.flash_attention_fwd(q, k, v, **kw))
qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
lib = cs.cuda_ms(torch, lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
cs.emit("train_kernel_time", kernel="flash_attention_fwd", case="gpt2xl_causal", ms=ms,
        library_ms=lib, bound_ms=cs.bound(nbytes, flops)[0], bytes=nbytes, flops=flops,
        tflops=flops / ms / 1e9, card=smi)
do = case["do"]
out, lse = FA.flash_attention_fwd(q, k, v, **kw)
delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()
qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
lib = cs.cuda_ms(torch, lambda i: torch.autograd.grad(lib_out, (qg, kg, vg), do.transpose(1, 2),
                                                      retain_graph=True))
for name, fn in (("flash_attention_dq",
                  lambda i: FA.flash_attention_dq(q, k, v, do, lse, delta, **kw)),
                 ("flash_attention_dkv",
                  lambda i: FA.flash_attention_dkv(q, k, v, do, lse, delta, **kw))):
    nbytes, flops = cs.flash_work(case)[name]
    ms = cs.cuda_ms(torch, fn)
    cs.emit("train_kernel_time", kernel=name, case="gpt2xl_causal", ms=ms, library_ms=lib,
            library="autograd backward of F.scaled_dot_product_attention (dq, dk and dv)",
            bound_ms=cs.bound(nbytes, flops)[0], bytes=nbytes, flops=flops,
            tflops=flops / ms / 1e9, card=smi)
del case, q, k, v, kw, qt, kt, vt, do, out, lse, delta, qg, kg, vg, lib_out
torch.cuda.empty_cache()
engine, batch, _, ms_step = cs.train_path(torch, smi)
cs.train_step_profile(torch, engine, batch, ms_step, smi)
"""
TIMEOUT_S = 1200


def summarize(stdout):
    """A child's summary from its JSON lines: each kernel's ms by case and
    the library call's ms beside it (where the row has one), the serving
    run's tokens/s, peak memory and each step's wall, device and idle
    share, and each train step's ms, tokens/s, MFU, peak memory, idle share
    and device ms by class ("ring": qwen2-7b over 4 shards, "gpt2_xl")."""
    out = {"kernels": {}, "library": {}, "serving": {}, "ring": {}, "gpt2_xl": {}}
    for line in stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        phase = row.get("phase") if isinstance(row, dict) else None
        step = {"ring_train_path": "ring", "ring_step_profile": "ring",
                "train_path": "gpt2_xl", "train_step_profile": "gpt2_xl"}.get(phase)
        if phase == "main_path":
            out["serving"].update({k: row[k] for k in ("tokens_per_s", "serve_s",
                                                       "peak_memory_gb")})
        elif phase == "step_profile":
            out["serving"][f"{row['step']}_step"] = {
                k: row[k] for k in ("wall_ms", "host_issue_ms", "device_busy_ms", "idle_share")
                if k in row}
        elif phase in ("kernel_time", "ring_kernel_time", "train_kernel_time", "ops_kernel_time",
                       "woq_kernel_time", "v1_kernel_time", "k1_kernel_time"):
            out["kernels"].setdefault(row["kernel"], {})[row["case"]] = row["ms"]
            if row.get("library_ms") is not None:
                out["library"].setdefault(row["kernel"], {})[row["case"]] = row["library_ms"]
        elif phase in ("ring_train_path", "train_path"):
            out[step].update({k: row[k] for k in ("ms_per_step", "tokens_per_s", "mfu",
                                                  "peak_memory_gb")})
        elif step is not None:
            out[step]["idle_share"] = row["idle_share"]
            out[step]["device_ms_by_class"] = row["device_ms_by_class"]
    return out


def run(tree):
    """One child in ``tree``; returns its summary."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        print(f"chip_compare: FAILED: {tree} exited {proc.returncode}", file=sys.stderr)
        sys.exit(1)
    return summarize(proc.stdout)


def main():
    import torch
    if len(sys.argv) != 2 or not os.path.isfile(os.path.join(sys.argv[1], "chip_smoke.py")):
        print("usage: python3 chip_compare.py OTHER_DIR (a tree of the repository)",
              file=sys.stderr)
        sys.exit(1)
    if not torch.cuda.is_available():
        print("chip_compare: FAILED: no card", file=sys.stderr)
        sys.exit(1)
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(sys.argv[1])
    summary = []
    for name, tree in (("other", other), ("this", here), ("this", here), ("other", other)):
        summary.append({"tree": name, "dir": tree, **run(tree)})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, "runs": summary}), flush=True)


if __name__ == "__main__":
    main()
