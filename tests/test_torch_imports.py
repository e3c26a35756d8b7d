"""The PyTorch port stands alone: no module of ``deepspeed_tpu_torch``
imports JAX or the JAX package (the machine with the GPU has no JAX).
Checked twice: by importing every module in a fresh interpreter, and by
scanning every import statement of the package's sources."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "deepspeed_tpu")


def _modules():
    names = ["deepspeed_tpu_torch"]
    for info in pkgutil.walk_packages([str(PKG)], prefix="deepspeed_tpu_torch."):
        names.append(info.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "deepspeed_tpu_torch.inference.v2.engine_v2" in mods
    assert "deepspeed_tpu_torch.runtime.engine" in mods
    for m in ("inference.engine", "inference.config", "inference.quantization.layers",
              "ops.decode_attention", "ops.quantizer", "ops.woq_matmul",
              "ops.sparse_attention", "ops.sparse_flash", "ops.fp_quantizer",
              "ops.evoformer_flash", "ops.evoformer", "comm.comm", "utils.groups",
              "sequence.ring_flash", "sequence.ring_attention", "sequence.layer",
              "sequence.cross_entropy", "parallel.collectives", "parallel.sharding",
              "inference.v2.tp", "inference.v2.model_implementations.archs",
              "runtime.zero", "runtime.zero.partition"):
        assert f"deepspeed_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_source_imports_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "chip_compare.py"]:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {name}")
    assert offenders == []
