"""PyTorch/CUDA port of deepspeed_tpu.

``initialize()`` returns a training engine over one card;
``init_inference()`` the v1 inference engine (``generate``); the serving
engine is ``inference.v2.InferenceEngineV2``; weight-only quantization is
``inference.quantization``.
"""


def initialize(args=None,
               model=None,
               optimizer=None,
               model_parameters=None,
               training_data=None,
               lr_scheduler=None,
               distributed_port=29500,
               mpu=None,
               dist_init_required=None,
               collate_fn=None,
               config=None,
               config_params=None,
               device=None):
    """Initialize the training engine. Mirrors ``deepspeed_tpu.initialize``.

    Arguments:
        model: a ``deepspeed_tpu_torch`` ``CausalLM`` (``models.build_model``).
        optimizer: optional optimizer name or instance overriding the config.
        config: DeepSpeed-style JSON config (dict, path, or JSON string).
        device: where to train; None means the current CUDA device and
            raises without a GPU (``"cpu"`` runs the plain PyTorch path).

    Returns: ``engine, optimizer, training_dataloader, lr_scheduler``. The
    engine's dataloader is not ported yet: ``training_data`` raises.
    """
    from .runtime.engine import DeepSpeedEngine

    if config is None:
        config = config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a model")
    engine = DeepSpeedEngine(args=args, model=model, optimizer=optimizer,
                             model_parameters=model_parameters, training_data=training_data,
                             lr_scheduler=lr_scheduler, mpu=mpu, collate_fn=collate_fn,
                             config=config, device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


def init_inference(model=None, config=None, *, params=None, device=None, **kwargs):
    """Initialize the v1 inference engine. Mirrors
    ``deepspeed_tpu.init_inference``: ``config`` is a dict (updated with
    ``kwargs``) or a ``DeepSpeedInferenceConfig``. The port adds ``params``
    (port tensors, for example from ``module_inject.params_from_numpy``) and
    ``device`` (None: the current CUDA device, raising without a GPU)."""
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine

    if config is None:
        config = {}
    if isinstance(config, dict):
        config = DeepSpeedInferenceConfig.from_dict({**config, **kwargs})
    return InferenceEngine(model, config, params=params, device=device)


def default_inference_config():
    """The default inference config as a plain dict (field names, nested
    blocks as dicts)."""
    import dataclasses

    from .inference.config import DeepSpeedInferenceConfig
    return dataclasses.asdict(DeepSpeedInferenceConfig())
