from . import sd_unet
from .sd_unet import SDUNetConfig
from .unet import (
    ModelConfig,
    apply_model,
    apply_model_flat_io,
    count_params,
    init_model,
)

__all__ = ["init_model", "apply_model", "apply_model_flat_io",
           "ModelConfig", "count_params", "SDUNetConfig", "sd_unet"]
