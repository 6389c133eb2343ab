from .unet import (
    ModelConfig,
    apply_model,
    apply_model_flat_io,
    count_params,
    init_model,
)

__all__ = ["init_model", "apply_model", "apply_model_flat_io",
           "ModelConfig", "count_params"]
