#!/usr/bin/env python3
"""Time the two training slices of this checkout against another tree of
the repository on one card.

    python3 chip_compare.py OTHER_DIR

OTHER_DIR holds another tree of the repository, for example the parent
commit (``git archive <commit> | tar -x -C OTHER_DIR``). Each tree runs in
a child process of its own, in the order other, this, this, other, so both
meet the card in the same states: the tree's own
``chip_smoke.ring_kernel_time`` (phase 23: K13, K14 and K15 per step kind
at qwen2-7b's shard shapes beside SDPA) and ``chip_smoke.ring_train_path``
(phase 24: qwen2-7b at full width, 4 layers, one 32768-token sequence a
step over 4 shards, then its step profile); then the flash forward (K3) at
gpt2-xl's training shape beside SDPA's forward, timed by the same code in
both trees (the ``train_kernel_time`` row of phase 9), and the tree's own
``chip_smoke.train_path`` (phase 10: gpt2-xl at full width and depth, then
its step profile). The children's JSON lines pass through; the last line
is a summary by tree, in run order: each kernel's ms per step kind, K3's
ms, and each train step's ms, tokens/s, MFU, peak memory and idle share.
Exits 1 without a card or when a child fails.
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
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
op_builder.build(["ring_flash", "fused_adam", "flash_attention"])
smi = cs.nvidia_smi()
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
del case, q, k, v, kw, qt, kt, vt
torch.cuda.empty_cache()
engine, batch, _, ms_step = cs.train_path(torch, smi)
cs.train_step_profile(torch, engine, batch, ms_step, smi)
"""
TIMEOUT_S = 1200


def summarize(stdout):
    """A child's summary from its JSON lines: each kernel's ms by case, and
    each train step's ms, tokens/s, MFU, peak memory, idle share and device
    ms by class ("ring": qwen2-7b over 4 shards, "gpt2_xl")."""
    out = {"kernels": {}, "ring": {}, "gpt2_xl": {}}
    for line in stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        phase = row.get("phase") if isinstance(row, dict) else None
        step = {"ring_train_path": "ring", "ring_step_profile": "ring",
                "train_path": "gpt2_xl", "train_step_profile": "gpt2_xl"}.get(phase)
        if phase in ("ring_kernel_time", "train_kernel_time"):
            out["kernels"].setdefault(row["kernel"], {})[row["case"]] = row["ms"]
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
