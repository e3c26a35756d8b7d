"""Model injection for the port: the JAX-to-torch weights bridge and the
v1 engine's model normalisation (mirrors ``deepspeed_tpu/module_inject``)."""

from .from_jax import (params_from_numpy, quantized_parameter_from_numpy,  # noqa: F401
                       woq_state_from_numpy)

NOT_PORTED_HF = ("HF modules and checkpoint files (init_inference checkpoint=...) are "
                 "not ported yet: ROADMAP.md section A, item 13")


def as_inference_model(model, config=None):
    """Normalize ``init_inference`` input to (model, params-or-None): a port
    ``CausalLM`` is taken as it is; a preset name or a ``TransformerConfig``
    is built. Checkpoint files (``config.checkpoint``) and HF modules raise
    ``NotImplementedError``."""
    from ..models.config import TransformerConfig
    from ..models.transformer import CausalLM, build_model

    if getattr(config, "checkpoint", None) is not None:
        raise NotImplementedError(NOT_PORTED_HF)
    if isinstance(model, CausalLM):
        return model, None
    if isinstance(model, (str, TransformerConfig)):
        return build_model(model), None
    if hasattr(model, "state_dict") and hasattr(model, "config"):
        raise NotImplementedError(NOT_PORTED_HF)
    raise TypeError(f"init_inference: unsupported model type {type(model)}")
