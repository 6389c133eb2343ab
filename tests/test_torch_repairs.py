"""Two faults of the port against the JAX package, on the CPU.

- ``config.parallel``: the JAX package builds a dp × sp mesh from it, and
  raises when there are fewer devices than dp·sp; the port builds its mesh
  over the ranks of the process group (``parallel/mesh.py``), so in one plain
  process ``Diffusion`` and the command line refuse dp·sp > 1 with the JAX
  package's message instead of running a different job on one device; the
  training step builds on every mesh shape (the ranks are the mesh's
  concern).
- The float resblock tail ``x + GN3(s)``: the port sums in the JAX package's
  order, ``x + s·scale3 + shift3`` (``ddim_audio_tpu/ops/flat_resblock.py``
  ``resblock_flat``), bit for bit against that expression under ``jax.jit``.
"""

import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ddim_audio_tpu_torch import cli
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.ops.flat_resblock import resblock_flat, resblock_tail
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "audio_tiny.yml")


def _config_file(tmp_path, dp, sp):
    with open(CONFIG) as fh:
        raw = yaml.safe_load(fh)
    raw["parallel"] = {"dp": dp, "sp": sp}
    path = tmp_path / f"tiny_dp{dp}_sp{sp}.yml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _args(tmp_path):
    return SimpleNamespace(seed=0, timesteps=2, skip_type="uniform", eta=0.0,
                           sample_type="generalized", sequence=False,
                           image_folder=str(tmp_path / "img"),
                           log_path=str(tmp_path / "log"))


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_runner_refuses_more_than_one_device(tmp_path, dp, sp):
    """One process is one rank: the mesh needs dp·sp of them (the JAX
    package's ``make_mesh`` message). A training step builds on a mesh of
    any shape, sp > 1 included."""
    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import ModelConfig, init_model
    from ddim_audio_tpu_torch.parallel.mesh import Mesh
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)

    config = load_config(_config_file(tmp_path, dp, sp))
    with pytest.raises(ValueError, match=f"mesh dp×sp = {dp}×{sp} needs "
                       f"{dp * sp} devices, have 1"):
        Diffusion(_args(tmp_path), config, device="cpu")
    cfg = ModelConfig.from_config(config)
    _, tx = init_train_state(init_model(torch.Generator().manual_seed(0), cfg,
                                        device="cpu"),
                             config.optimization, use_ema=False)
    mesh = Mesh(dp=dp, sp=sp, rank=0)
    alphas = make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod
    assert callable(make_train_step(cfg, config, alphas, tx, mesh=mesh))


def test_runner_builds_on_one_device(tmp_path):
    runner = Diffusion(_args(tmp_path), load_config(_config_file(tmp_path, 1, 1)),
                       device="cpu")
    assert runner.device.type == "cpu"


@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (1, 1)])
def test_cli_refuses_more_than_one_device(tmp_path, caplog, dp, sp):
    """The command line reaches the runner: in one plain process (no
    launcher) dp·sp > 1 fails the run (exit 1) with the mesh's ValueError in
    the log; with 1 × 1 it gets past the runner and fails only for want of a
    checkpoint."""
    argv = ["--config", _config_file(tmp_path, dp, sp), "--doc", "none",
            "--exp", str(tmp_path / "exp"), "--ni", "--device", "cpu",
            "--sample", "--timesteps", "2", "-i", "out"]
    try:
        with caplog.at_level(logging.ERROR):
            assert cli.main(argv) == 1
    finally:
        logging.getLogger().handlers.clear()  # the CLI adds one per call
    refused = (f"ValueError: mesh dp×sp = {dp}×{sp} needs {dp * sp} "
               "devices, have 1") in caplog.text
    assert refused == (dp * sp > 1), caplog.text[-2000:]
    if dp * sp == 1:
        assert "ckpt.npz" in caplog.text, caplog.text[-2000:]


@jax.jit
def _jax_tail(xv, sv, scale3_p, shift3_p):
    # ddim_audio_tpu/ops/flat_resblock.py resblock_flat, its tail expression
    return (xv.astype(jnp.float32) + sv.astype(jnp.float32) * scale3_p
            + shift3_p).astype(xv.dtype)


def test_float_tail_is_bit_equal_to_jax():
    b, t, f, c = 4, 64, 8, 32
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, t, f * c)).astype(np.float32)
    s = rng.standard_normal((b, t, f * c)).astype(np.float32)
    scale3 = rng.standard_normal((b, c)).astype(np.float32)
    shift3 = rng.standard_normal((b, c)).astype(np.float32)
    ref = np.asarray(_jax_tail(jnp.asarray(x), jnp.asarray(s),
                               jnp.tile(scale3, (1, f))[:, None, :],
                               jnp.tile(shift3, (1, f))[:, None, :]))
    got = resblock_tail(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(scale3), torch.from_numpy(shift3),
                        f=f, c=c).numpy()
    assert got.dtype == ref.dtype == np.float32
    differ = int((got.view(np.int32) != ref.view(np.int32)).sum())
    assert differ == 0, f"{differ} of {got.size} elements differ"


def test_resblock_flat_runs_the_tail(monkeypatch):
    """resblock_flat's output is resblock_tail's."""
    import ddim_audio_tpu_torch.ops.flat_resblock as fr

    seen = []

    def spy(*a, **kw):
        out = resblock_tail(*a, **kw)
        seen.append(out)
        return out
    monkeypatch.setattr(fr, "resblock_tail", spy)
    b, t, f, c = 1, 8, 8, 32
    g = torch.Generator().manual_seed(0)

    def conv(ci):
        return {"w": torch.randn(3, 3, ci, ci, generator=g) * 0.1,
                "b": torch.randn(ci, generator=g)}

    def norm(ci):
        return {"g": 1 + 0.2 * torch.randn(ci, generator=g),
                "b": 0.1 * torch.randn(ci, generator=g)}
    p = {"norm1": norm(c), "conv1": conv(c), "norm2": norm(c),
         "conv2": conv(c), "norm3": norm(c)}
    x = torch.randn(b, t, f * c, generator=g)
    out = resblock_flat(p, x, torch.randn(b, c, generator=g), f=f, c=c)
    assert len(seen) == 1 and torch.equal(out, seen[0])
