"""Config key constants and defaults.

Mirrors ``deepspeed_tpu/runtime/constants.py`` (the port keeps its own
copy): one place for the config key strings, so the config system and the
engine agree. The ``mesh`` keys name the JAX package's device-mesh block;
the port's engine reads it only to refuse a layout over more than one card.
"""

#############################################
# Batch size
#############################################
TRAIN_BATCH_SIZE = "train_batch_size"
TRAIN_BATCH_SIZE_DEFAULT = None
TRAIN_MICRO_BATCH_SIZE_PER_GPU = "train_micro_batch_size_per_gpu"
TRAIN_MICRO_BATCH_SIZE_PER_GPU_DEFAULT = None
GRADIENT_ACCUMULATION_STEPS = "gradient_accumulation_steps"
GRADIENT_ACCUMULATION_STEPS_DEFAULT = None

#############################################
# Optimizer / scheduler
#############################################
OPTIMIZER = "optimizer"
OPTIMIZER_TYPE_DEFAULT = None
OPTIMIZER_PARAMS = "params"
TYPE = "type"
LEGACY_FUSION = "legacy_fusion"
SCHEDULER = "scheduler"
SCHEDULER_TYPE_DEFAULT = None
SCHEDULER_PARAMS = "params"
MAX_GRAD_NORM = "max_grad_norm"

ADAM_OPTIMIZER = "adam"
ADAMW_OPTIMIZER = "adamw"
FUSED_ADAM_OPTIMIZER = "fusedadam"
CPU_ADAM_OPTIMIZER = "cpuadam"
LAMB_OPTIMIZER = "lamb"
LION_OPTIMIZER = "lion"
ADAGRAD_OPTIMIZER = "adagrad"
SGD_OPTIMIZER = "sgd"
ONEBIT_ADAM_OPTIMIZER = "onebitadam"
ONEBIT_LAMB_OPTIMIZER = "onebitlamb"
ZERO_ONE_ADAM_OPTIMIZER = "zerooneadam"
DEEPSPEED_OPTIMIZERS = [
    ADAM_OPTIMIZER, ADAMW_OPTIMIZER, FUSED_ADAM_OPTIMIZER, CPU_ADAM_OPTIMIZER, LAMB_OPTIMIZER, LION_OPTIMIZER,
    ADAGRAD_OPTIMIZER, SGD_OPTIMIZER, ONEBIT_ADAM_OPTIMIZER, ONEBIT_LAMB_OPTIMIZER, ZERO_ONE_ADAM_OPTIMIZER
]

#############################################
# Precision
#############################################
FP16 = "fp16"
FP16_ENABLED = "enabled"
FP16_LOSS_SCALE = "loss_scale"
FP16_INITIAL_SCALE_POWER = "initial_scale_power"
FP16_LOSS_SCALE_WINDOW = "loss_scale_window"
FP16_HYSTERESIS = "hysteresis"
FP16_MIN_LOSS_SCALE = "min_loss_scale"
BFLOAT16 = "bf16"
BFLOAT16_OLD = "bfloat16"
BFLOAT16_ENABLED = "enabled"

#############################################
# Gradients
#############################################
GRADIENT_CLIPPING = "gradient_clipping"
GRADIENT_CLIPPING_DEFAULT = 0.0
PRESCALE_GRADIENTS = "prescale_gradients"
GRADIENT_PREDIVIDE_FACTOR = "gradient_predivide_factor"
SPARSE_GRADIENTS = "sparse_gradients"

#############################################
# ZeRO
#############################################
ZERO_OPTIMIZATION = "zero_optimization"

#############################################
# Logging / profiling
#############################################
STEPS_PER_PRINT = "steps_per_print"
STEPS_PER_PRINT_DEFAULT = 10
WALL_CLOCK_BREAKDOWN = "wall_clock_breakdown"
WALL_CLOCK_BREAKDOWN_DEFAULT = False
DUMP_STATE = "dump_state"
FLOPS_PROFILER = "flops_profiler"
COMMS_LOGGER = "comms_logger"
MONITOR_CSV = "csv_monitor"
MONITOR_TENSORBOARD = "tensorboard"
MONITOR_WANDB = "wandb"

#############################################
# Subsystems
#############################################
ACTIVATION_CHECKPOINTING = "activation_checkpointing"
GRADIENT_COMPRESSION = "compression_training"
DATA_EFFICIENCY = "data_efficiency"
CURRICULUM_LEARNING_LEGACY = "curriculum_learning"
ELASTICITY = "elasticity"
AUTOTUNING = "autotuning"
PIPELINE = "pipeline"
MOE = "moe"
SEQUENCE_PARALLEL = "sequence_parallel"
CHECKPOINT = "checkpoint"
LOAD_UNIVERSAL_CHECKPOINT = "load_universal"
DATALOADER_DROP_LAST = "dataloader_drop_last"
DATALOADER_DROP_LAST_DEFAULT = False

#############################################
# Mesh / parallelism (the JAX package's device-mesh block)
#############################################
MESH = "mesh"
MESH_DATA_AXIS = "data"
MESH_FSDP_AXIS = "fsdp"
MESH_TENSOR_AXIS = "tensor"
MESH_PIPE_AXIS = "pipe"
MESH_SEQ_AXIS = "seq"
MESH_EXPERT_AXIS = "expert"

#############################################
# Communication
#############################################
COMMUNICATION_DATA_TYPE = "communication_data_type"
SEQ_PARALLEL_COMMUNICATION_DATA_TYPE = "seq_parallel_communication_data_type"

#############################################
# Checkpoint tags
#############################################
LATEST_TAG = "latest"
