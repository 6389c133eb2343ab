from .diffusion_runner import Diffusion

__all__ = ["Diffusion"]
