from .ddim import ddim_coefficients, ddim_step
from .ddpm import ddpm_coefficients, ddpm_step
from .driver import ScanSampler
from .guidance import guidance_rows, guided_denoiser

__all__ = ["ddim_coefficients", "ddim_step", "ddpm_coefficients", "ddpm_step",
           "ScanSampler", "guidance_rows", "guided_denoiser"]
