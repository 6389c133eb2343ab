"""ddim_audio_tpu_torch — the PyTorch / CUDA port of ``ddim_audio_tpu``.

The JAX package stays the reference; this package runs the same denoiser
and the sampling side (DDIM and DDPM, last-only and ``--sequence``
trajectories, the ``python -m ddim_audio_tpu_torch`` CLI) in PyTorch under
the production eval configuration, with the Pallas TPU conv kernels of that
path replaced by hand-written CUDA kernels for NVIDIA Hopper (``csrc/``).
Entry points run on the card unless the caller asks for the CPU. Module paths
mirror the JAX package. Public functions keep its layouts: the [B, C, T, F] model API and the unpadded flat sampler state
[B, T, F·C] (channels-last). Parameters are nested dicts of torch tensors in
the JAX package's storage conventions (HWIO convs, flipped equivalent-forward
transposed convs, [in, out] linears), so ``weights.params_from_jax`` carries
JAX weights across as they are.

Nothing here imports JAX.
"""

__version__ = "0.1.0"
