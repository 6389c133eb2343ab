from .ddim import ddim_coefficients, ddim_step
from .driver import ScanSampler

__all__ = ["ddim_coefficients", "ddim_step", "ScanSampler"]
