from repro_torch.configs.base import (  # noqa: F401
    ATTN, MLSTM, SLSTM, RGLRU, MLP_NONE, MLP_DENSE, MLP_MOE,
    TRAIN, PREFILL, DECODE,
    BlockSpec, ModelConfig, ShapeConfig, SHAPES, SHAPE_ORDER,
    shape_applicable, input_specs, param_count, active_param_count,
    model_flops,
)
from repro_torch.configs.registry import ARCH_IDS, get_config, all_configs  # noqa: F401
