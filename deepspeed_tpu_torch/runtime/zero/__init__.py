"""ZeRO public API.

Mirrors ``deepspeed_tpu/runtime/zero/__init__.py``: the config, the
``zero.Init`` context and ``GatheredParameters``. The port's engine draws
each parameter whole on every rank and keeps its shard at once
(``CausalLM.init``'s ``cut``), so a stage-3 model is born sharded and
``Init`` only records its arguments. ``GatheredParameters`` hands back the
whole tensors of split parameters (those an engine marked with ``ds_dim``)
gathered over the data-parallel group. ``Init(remote_device=...)`` (the
ZeRO-Infinity boot) raises: offload is not ported (ROADMAP.md section A,
item 16).
"""

from ...comm import comm
from ...utils import groups
from ...utils.tree import tree_map
from .config import DeepSpeedZeroConfig  # noqa: F401


class Init:
    """API-parity context (the JAX ``zero.Init``): model construction under
    it behaves as outside it."""

    def __init__(self, module=None, data_parallel_group=None, mem_efficient_linear=True,
                 remote_device=None, pin_memory=False, config_dict_or_path=None,
                 config=None, enabled=True, dtype=None, mpu=None, param_swapper=None):
        if enabled and remote_device not in (None, "none"):
            raise NotImplementedError(
                f"zero.Init(remote_device={remote_device!r}): parameter offload is not "
                "ported yet (ROADMAP.md section A, item 16)")
        self.enabled = enabled
        self.config = config_dict_or_path or config
        self.dtype = dtype

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _gathered(x):
    dim = getattr(x, "ds_dim", None)
    if dim is None:
        return x
    return comm.all_gather_into_tensor(x.detach(), dim=dim,
                                       group=groups.get_data_parallel_group())


class GatheredParameters:
    """Within the context, the whole tensors of the given parameters (one
    tensor, a list, or a tree of them): split parameters gathered over the
    data-parallel group, whole ones as they are. Every rank of the group
    must enter it together."""

    def __init__(self, params, modifier_rank=None, fwd_module=None, enabled=True):
        self.params = params
        self.enabled = enabled
        self.gathered = None

    def __enter__(self):
        if not self.enabled:
            return self.params
        if isinstance(self.params, (list, tuple)):
            self.gathered = type(self.params)(_gathered(p) for p in self.params)
        else:
            self.gathered = tree_map(_gathered, self.params)
        return self.gathered

    def __exit__(self, *exc):
        return False


def unwrap_model_for_generation(model):
    return model
