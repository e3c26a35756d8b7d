#!/usr/bin/env python3
"""Time the ring slice of this checkout against another tree of the
repository on one card.

    python3 chip_compare.py OTHER_DIR

OTHER_DIR holds another tree of the repository, for example the parent
commit (``git archive <commit> | tar -x -C OTHER_DIR``). Each tree runs in
a child process of its own, in the order other, this, this, other, so both
meet the card in the same states: the tree's own
``chip_smoke.ring_kernel_time`` (phase 23: K13, K14 and K15 per step kind
at qwen2-7b's shard shapes beside SDPA) and ``chip_smoke.ring_train_path``
(phase 24: qwen2-7b at full width, 4 layers, one 32768-token sequence a
step over 4 shards, then its step profile). The children's JSON lines pass
through; the last line is a summary by tree, in run order: each kernel's
ms per step kind, and the train step's ms, tokens/s, MFU, peak memory and
idle share. Exits 1 without a card or when a child fails.
"""

import json
import os
import subprocess
import sys

CHILD = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from deepspeed_tpu_torch.ops import op_builder
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
op_builder.build(["ring_flash", "fused_adam"])
cs.ring_kernel_time(torch)
cs.ring_train_path(torch, cs.nvidia_smi())
"""
TIMEOUT_S = 900


def run(tree):
    """One child in ``tree``; returns its summary."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, capture_output=True,
                          text=True, timeout=TIMEOUT_S)
    sys.stdout.write(proc.stdout)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        print(f"chip_compare: FAILED: {tree} exited {proc.returncode}", file=sys.stderr)
        sys.exit(1)
    out = {"kernels": {}}
    for line in proc.stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        phase = row.get("phase") if isinstance(row, dict) else None
        if phase == "ring_kernel_time":
            out["kernels"].setdefault(row["kernel"], {})[row["case"]] = row["ms"]
        elif phase == "ring_train_path":
            out.update({k: row[k] for k in ("ms_per_step", "tokens_per_s", "mfu",
                                            "peak_memory_gb")})
        elif phase == "ring_step_profile":
            out["idle_share"] = row["idle_share"]
            out["device_ms_by_class"] = row["device_ms_by_class"]
    return out


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
