from repro_torch.models.model import (  # noqa: F401
    ModelSettings, apply, init_params,
)
