from .codec import STFTConfig, limit_length_img, pfft2img, pfft2wav

__all__ = ["STFTConfig", "limit_length_img", "pfft2img", "pfft2wav"]
