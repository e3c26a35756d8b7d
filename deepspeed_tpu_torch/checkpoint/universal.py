"""Universal checkpoint: reshard-on-resume.

Mirrors ``deepspeed_tpu/checkpoint/universal.py``: the engine's whole state
as one ``.npy`` file a tensor, named ``<section>.<dotted path>.npy``, and
``universal_index.json`` listing each entry's section, path, file, shape and
dtype (a leaf Twin-Flow keeps on the other side is listed with
``"none": true`` and no file), and the meta (step counters, stage). The
files and the index are JAX's, so each package loads what the other wrote.

Sections: ``module`` (every parameter whole), ``optimizer`` (``step`` and
``slots`` with m, v and f32 masters: the device optimizer's, or the host
optimizer's under native offload) and, under Twin-Flow, ``twinflow`` (the
device half's state). The port writes split leaves gathered whole (every
rank takes part, rank 0 writes, one leaf at a time) and cuts each tensor to
the loading engine's degree and stage.
"""

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..comm import comm
from ..ops.optimizers import is_slot
from ..utils.tree import tree_from_paths, tree_paths

INDEX_FILE = "universal_index.json"


def _np(t):
    """A host numpy array of a tensor (bf16 as f32: numpy has no bf16), or
    of a step count (int32, as JAX's state holds it)."""
    if not torch.is_tensor(t):
        return np.asarray(t, np.int32)
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _state_sections(engine):
    """(section, dotted path, this rank's leaf, its split dim) of everything
    the checkpoint holds, in order."""
    layout = engine._layout()
    pdims, odims = layout["param_dims"], layout["opt_dims"]
    out = [("module", k, p, pdims[k]) for k, p in tree_paths(engine.module_params)]

    def opt(section, state):
        out.append((section, "step", state["step"], None))
        for k, slot in tree_paths(state["slots"], is_leaf=is_slot):
            if slot is None:
                out.append((section, f"slots.{k}", None, None))
                continue
            for f in sorted(slot):
                out.append((section, f"slots.{k}.{f}", slot[f], odims[k]))

    opt("optimizer", engine._optimizer_state())
    if engine._twinflow is not None:
        opt("twinflow", engine._twinflow["dev_state"])
    return out


@torch.no_grad()
def ds_to_universal(engine, output_dir: str):
    """Write the engine's state as the universal format (JAX
    ``ds_to_universal``). Every rank of the group calls it (split leaves
    are gathered); rank 0 writes and returns the index, the others None."""
    rank = comm.get_rank()
    if rank == 0:
        os.makedirs(output_dir, exist_ok=True)
    index = {"params": [], "meta": {"global_steps": engine.global_steps,
                                    "global_samples": engine.global_samples,
                                    "micro_steps": engine.micro_steps,
                                    "zero_stage": engine.zero_stage}}
    for section, path, leaf, dim in _state_sections(engine):
        if leaf is None:
            index["params"].append({"section": section, "path": path, "none": True})
            continue
        if torch.is_tensor(leaf) and dim is not None:
            leaf = engine.partition.gather(leaf.detach().to(engine.device), dim)
        if rank != 0:
            continue
        arr = _np(leaf)
        fname = f"{section}.{path}.npy".replace("/", "_")
        np.save(os.path.join(output_dir, fname), arr)
        index["params"].append({"section": section, "path": path, "file": fname,
                                "shape": list(arr.shape), "dtype": str(arr.dtype)})
    comm.barrier()
    if rank != 0:
        return None
    with open(os.path.join(output_dir, INDEX_FILE), "w") as f:
        json.dump(index, f, indent=1)
    return index


def read_universal(load_dir: str):
    """(sections: {section: {dotted path: numpy array or None}}, meta)."""
    with open(os.path.join(load_dir, INDEX_FILE)) as f:
        index = json.load(f)
    sections: Dict[str, Dict[str, Optional[np.ndarray]]] = {"module": {}, "optimizer": {}}
    for entry in index["params"]:
        arr = None if entry.get("none") else np.load(os.path.join(load_dir, entry["file"]))
        sections.setdefault(entry["section"], {})[entry["path"]] = arr
    return sections, index.get("meta", {})


def _local_state(engine, flat, like, what):
    """A saved ``{"step", "slots"}`` section of whole arrays cut to this
    rank's optimizer layout, in the dtypes of ``like`` (the engine's live
    state of that section)."""
    odims = engine._layout()["opt_dims"]
    step = flat.get("step")
    if step is None:
        raise ValueError(f"universal checkpoint: no {what} step")
    slots = []
    for k, slot in tree_paths(like["slots"], is_leaf=is_slot):
        if slot is None:
            slots.append((k, None))
            continue
        cut = {}
        for f, t in slot.items():
            arr = flat.get(f"slots.{k}.{f}")
            if arr is None:
                raise ValueError(f"universal checkpoint: no {what} entry slots.{k}.{f} for a "
                                 "leaf this engine holds (was it saved under another "
                                 "Twin-Flow split?)")
            full = torch.from_numpy(np.ascontiguousarray(arr)).to(t.dtype)
            cut[f] = engine.partition.cut(full, odims[k]) if engine.partition else full
        slots.append((k, cut))
    return {"step": int(step), "slots": tree_from_paths(slots)}


@torch.no_grad()
def load_universal_checkpoint(engine, load_dir: str, load_optimizer_states: bool = True):
    """Restore a universal checkpoint at the engine's current degree and
    stage (JAX ``load_universal_checkpoint``). Returns the meta."""
    sections, meta = read_universal(load_dir)
    engine._load_module(tree_from_paths(sections["module"].items()), True)
    if load_optimizer_states and sections["optimizer"]:
        host = engine._host_optimizer
        live = host.state_dict() if host is not None else engine._optimizer_state()
        opt = _local_state(engine, sections["optimizer"], live, "optimizer")
        if host is not None:
            dev = None
            if engine._twinflow is not None:
                if "twinflow" not in sections:
                    raise ValueError(
                        "universal checkpoint has no 'twinflow' section but this engine runs "
                        "Twin-Flow (offload ratio < 1): the checkpoint was saved under a "
                        "different host/device split; resume with the saving config")
                dev = _local_state(engine, sections["twinflow"], engine._twinflow["dev_state"],
                                   "twinflow")
            engine._restore_host_optimizer_state(opt, dev)
        else:
            engine._load_opt_state(opt)
    else:
        engine._resync_masters_from_params()
    engine.global_steps = int(meta.get("global_steps", 0))
    engine.global_samples = int(meta.get("global_samples", 0))
    engine.micro_steps = int(meta.get("micro_steps", 0))
    return meta
