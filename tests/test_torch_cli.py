"""The port's sampling CLI end to end on the CPU, on a tiny checkpoint written
by the JAX package's ``checkpoint.save_checkpoint``: exit codes, the folder
layout under ``<exp>/image_samples``, file counts for last-only, ``--sequence``,
DDPM and ``--interpolation``, failing runs, and the kept x0 predictions of the
slice as a whole against the JAX runner from the same start noise."""

import logging
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ddim_audio_tpu.checkpoint import save_checkpoint
from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.runners import Diffusion as JaxDiffusion
from ddim_audio_tpu.training.train_step import TrainState
from ddim_audio_tpu_torch import cli
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.ops import launch_counts, reset_launch_counts
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "audio_tiny.yml")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """<exp>/logs/run/ckpt.npz with distinct raw and EMA weights (non-zero
    final GroupNorm weights, so the resblocks are no identities)."""
    exp = tmp_path_factory.mktemp("cli") / "exp"
    # the port's init makes the same tree as the JAX init
    # (tests/test_torch_model.py) and is much quicker on the CPU
    from ddim_audio_tpu_torch.models import unet

    cfg = unet.ModelConfig.from_config(load_config(CONFIG))
    tree = unet.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()), tree)
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in params[mod]["stages"]:
            for block in stage["blocks"]:
                c = block["norm3"]["g"].shape[0]
                block["norm3"]["g"] = jnp.asarray(
                    1.0 + 0.2 * rng.standard_normal(c).astype(np.float32))
    ema = jax.tree_util.tree_map(lambda v: v * 0.9, params)
    state = TrainState(params=params, opt_state=(), ema=ema,
                       step=jnp.zeros((), jnp.int32))
    save_checkpoint(str(exp / "logs" / "run"), state, 4)
    return str(exp), ema


def _run(exp, *extra, doc="run"):
    reset_launch_counts()
    try:
        return cli.main(["--config", CONFIG, "--doc", doc, "--exp", exp,
                         "--ni", "--device", "cpu", "--sample", *extra])
    finally:
        logging.getLogger().handlers.clear()  # the CLI adds one per call


def _files(exp, folder):
    return sorted(os.listdir(os.path.join(exp, "image_samples", folder)))


def test_cli_last_only(workspace):
    exp, _ = workspace
    assert _run(exp, "--timesteps", "4", "-i", "last") == 0
    assert _files(exp, "last") == ["0_final.png", "0_final.wav"]
    assert launch_counts() == {k: 0 for k in launch_counts()}  # CPU: twins
    from scipy.io import wavfile

    sr, wav = wavfile.read(os.path.join(exp, "image_samples", "last",
                                        "0_final.wav"))
    assert sr == 16000 and wav.dtype == np.int32 and np.abs(wav).max() > 0


@pytest.mark.parametrize("sequence,timesteps,steps", [
    ("3", 6, 3), ("-1", 5, 5), ("0", 7, 8)])  # 7 of 50: the uniform
def test_cli_sequence(workspace, sequence, timesteps, steps):  # grid overshoots
    exp, _ = workspace
    folder = f"seq{sequence}"
    assert _run(exp, "--timesteps", str(timesteps), "--sequence", sequence,
                "-i", folder) == 0
    want = [f"0_{i}.{ext}" for i in range(steps) for ext in ("png", "wav")]
    assert _files(exp, folder) == sorted(want)


def test_cli_ddpm_and_eta(workspace):
    exp, _ = workspace
    assert _run(exp, "--timesteps", "4", "--sequence", "2", "--sample_type",
                "ddpm_noisy", "-i", "ddpm") == 0
    assert len(_files(exp, "ddpm")) == 4
    assert _run(exp, "--timesteps", "4", "--eta", "0.5", "-i", "eta") == 0
    assert _files(exp, "eta") == ["0_final.png", "0_final.wav"]


def test_cli_interpolation(workspace):
    exp, _ = workspace
    assert _run(exp, "--timesteps", "3", "--interpolation", "-i", "interp") == 0
    want = [f"interp_{i:02d}.{ext}" for i in range(11) for ext in ("png", "wav")]
    assert _files(exp, "interp") == sorted(want)


def test_cli_overwrites_the_image_folder_with_ni(workspace):
    exp, _ = workspace
    folder = os.path.join(exp, "image_samples", "again")
    os.makedirs(folder)
    open(os.path.join(folder, "stale.txt"), "w").close()
    assert _run(exp, "--timesteps", "2", "-i", "again") == 0
    assert _files(exp, "again") == ["0_final.png", "0_final.wav"]


@pytest.mark.parametrize("extra,doc", [
    ((), "no_such_run"),                      # no checkpoint
    (("--use_pretrained",), "run"),
    (("--fid",), "run"),
    (("--sample_type", "nonsense"), "run"),
])
def test_cli_failing_run_exits_1(workspace, extra, doc):
    exp, _ = workspace
    assert _run(exp, "--timesteps", "2", "-i", "fail", *extra, doc=doc) == 1


@pytest.mark.parametrize("flags", [["--test"], [], ["--resume_training"]])
def test_cli_training_and_test_name_the_roadmap(workspace, flags, capsys):
    """Training and --test are dispatched (ROADMAP.md A8 is done): with no
    dataset folder each fails as a run (exit 1) with the reason in the log,
    not with a refusal. Only training writes the run folder's log file."""
    exp, _ = workspace
    doc = "train_" + "_".join(f.strip("-") for f in flags)
    if flags:  # --test and --resume_training read an existing run folder
        os.makedirs(os.path.join(exp, "logs", doc), exist_ok=True)
    try:
        code = cli.main(["--config", CONFIG, "--doc", doc, "--exp", exp,
                         "--ni", "--device", "cpu", *flags])
    finally:
        logging.getLogger().handlers.clear()
    assert code == 1
    err = capsys.readouterr().err
    assert "downloads is not a directory" in err and "A8" not in err
    assert os.path.exists(os.path.join(exp, "logs", doc, "stdout.txt")) == \
        (flags != ["--test"])


@pytest.mark.parametrize("buffer_dtype,atol", [("float32", 1e-3),
                                               ("float16", 3e-3)])
def test_sequence_slice_matches_jax_runner(workspace, tmp_path, buffer_dtype,
                                           atol):
    """The slice as a whole: checkpoint → EMA weights → flat-state sampler →
    kept x0 predictions, against the JAX runner (its XLA route on the CPU)
    from the same start noise, at 1e-3 of max|x0| (fp16 buffers add their
    rounding)."""
    exp, ema = workspace

    def args():
        return SimpleNamespace(seed=7, timesteps=6, skip_type="uniform",
                               eta=0.0, sample_type="generalized", sequence=3,
                               image_folder=str(tmp_path),
                               log_path=os.path.join(exp, "logs", "run"))

    x = np.random.default_rng(8).standard_normal((2, 2, 16, 16)).astype(np.float32)
    sel = {0, 3, 5}
    config = load_config(CONFIG)
    config.sampling.buffer_dtype = buffer_dtype
    runner = Diffusion(args(), config, device="cpu")
    params = runner._load_eval_params()
    leaf = params["down_modules"]["head"]["w"].numpy()
    np.testing.assert_array_equal(
        leaf, np.asarray(ema["down_modules"]["head"]["w"]))  # EMA, not raw
    _, got = runner.sample_image(torch.from_numpy(x), params, select_index=sel)

    jconfig = jax_load_config(CONFIG)
    jconfig.sampling.buffer_dtype = buffer_dtype
    _, ref = JaxDiffusion(args(), jconfig).sample_image(jnp.asarray(x), ema,
                                                        select_index=sel)
    assert len(got) == len(ref) == 3
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), rtol=0, atol=atol * scale)


def test_save_eval_checkpoint_round_trip(workspace, tmp_path):
    """The port's own writer of the checkpoint format (evaluation weights
    only) is read back by load_jax_checkpoint and uses the JAX writer's keys."""
    from ddim_audio_tpu.checkpoint import _flatten
    from ddim_audio_tpu_torch.models import unet
    from ddim_audio_tpu_torch.weights import (load_jax_checkpoint,
                                              params_from_jax,
                                              save_eval_checkpoint)

    _, ema = workspace
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ema),
                             device="cpu")
    path = save_eval_checkpoint(str(tmp_path), params, which="ema", step=9)
    loaded, meta = load_jax_checkpoint(path, "ema", device="cpu")
    assert meta["step"] == 9
    assert unet.count_params(loaded) == unet.count_params(params)
    w = params["up_modules"]["stages"][2]["blocks"][1]["conv2"]["w"]
    assert torch.equal(
        loaded["up_modules"]["stages"][2]["blocks"][1]["conv2"]["w"], w)
    with pytest.raises(KeyError):
        load_jax_checkpoint(path, "params", device="cpu")
    # the JAX writer's own keys for the same subtree of a TrainState
    state = TrainState(params=(), opt_state=(), ema=ema,
                       step=jnp.zeros((), jnp.int32))
    want = {k: v.shape for k, v in _flatten(state).items()
            if k.startswith(".ema")}
    with np.load(path) as data:
        got = {k: data[k].shape for k in data.files if k != "__meta__"}
    assert got == want
