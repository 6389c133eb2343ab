"""The port's training CLI end to end on the CPU at the tiny config: train
from a temporary folder of seed-made ``.npy`` waveforms, the run folder's
files, ``--resume_training``, ``--test``, ``--sample`` from the checkpoint the
port trained itself, and the emergency snapshot on a failing step."""

import logging
import os

import numpy as np
import pytest
import torch
import yaml

from ddim_audio_tpu_torch import cli
from ddim_audio_tpu_torch.runners import diffusion_runner
from ddim_audio_tpu_torch.weights import read_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WINDOW = 8 * 15  # t_size · hop of configs/audio_tiny.yml


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(exp folder, config path by n_iters): 20 clips (one of two windows) →
    21 items, 18 to train (9 batches of 2), 3 held out."""
    root = tmp_path_factory.mktemp("train_cli")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(20):
        n = WINDOW * (2 if i == 7 else 1)
        np.save(data / f"clip{i:02d}.npy",
                (0.1 * rng.standard_normal(n)).astype(np.float32))
    with open(os.path.join(REPO, "configs", "audio_tiny.yml")) as f:
        raw = yaml.safe_load(f)
    raw["data"]["path"] = str(data)
    raw["training"].update(snapshot_freq=2, validation_freq=2, grad_accum=2)
    configs = {}
    for n_iters in (3, 5):
        raw["training"]["n_iters"] = n_iters
        configs[n_iters] = str(root / f"tiny{n_iters}.yml")
        with open(configs[n_iters], "w") as f:
            yaml.safe_dump(raw, f)
    return str(root / "exp"), configs


def _run(exp, config, *flags, doc="run"):
    try:
        return cli.main(["--config", config, "--doc", doc, "--exp", exp,
                         "--ni", "--device", "cpu", *flags])
    finally:
        logging.getLogger().handlers.clear()  # the CLI adds its own per call


def _log(exp, doc="run"):
    with open(os.path.join(exp, "logs", doc, "stdout.txt")) as f:
        return f.read()


def test_train_resume_test_sample(workspace):
    exp, configs = workspace
    log_path = os.path.join(exp, "logs", "run")
    assert _run(exp, configs[3]) == 0
    assert sorted(os.listdir(log_path)) == [
        "ckpt.npz", "ckpt_1.npz", "ckpt_2.npz", "ckpt_3.npz", "config.yml",
        "stdout.txt"]
    text = _log(exp)
    assert "dataset: 18 train / 3 test items" in text
    for step in (1, 2, 3):
        assert f"step: {step}, loss: " in text
    assert "update_norm_default" in text and "grad_norm" in text
    assert "step: 2, val-loss: " in text and "nan" not in text
    arrays, meta = read_checkpoint(os.path.join(log_path, "ckpt.npz"))
    assert meta["step"] == 3 and len(arrays) == meta["num_leaves"] == 421
    assert int(arrays[".step"]) == 3
    head = ".params['down_modules']['head']['w']"
    assert not np.array_equal(arrays[head], arrays[head.replace("params", "ema")])
    with open(os.path.join(log_path, "config.yml")) as f:
        assert yaml.safe_load(f)["training"]["n_iters"] == 3

    # resume keeps the folder and goes on from the rolling checkpoint
    assert _run(exp, configs[5], "--resume_training") == 0
    text = _log(exp)
    assert "resumed from step 3" in text
    assert "step: 4, loss: " in text and "step: 5, loss: " in text
    assert "ckpt_1.npz" in os.listdir(log_path)
    _, meta = read_checkpoint(os.path.join(log_path, "ckpt.npz"))
    assert meta["step"] == 5

    size = os.path.getsize(os.path.join(log_path, "stdout.txt"))
    assert _run(exp, configs[5], "--test") == 0
    assert os.path.getsize(os.path.join(log_path, "stdout.txt")) == size

    assert _run(exp, configs[5], "--sample", "--timesteps", "3", "-i", "own") == 0
    assert sorted(os.listdir(os.path.join(exp, "image_samples", "own"))) == [
        "0_final.png", "0_final.wav"]


def test_test_reports_a_finite_loss(workspace, caplog):
    exp, configs = workspace
    if not os.path.exists(os.path.join(exp, "logs", "run", "ckpt.npz")):
        assert _run(exp, configs[3]) == 0
    with caplog.at_level(logging.INFO):
        assert _run(exp, configs[3], "--test") == 0
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("test: mean eps-loss")]
    assert len(lines) == 1
    value = float(lines[0].split()[3])
    assert np.isfinite(value) and value > 0
    assert "over 2 batches" in lines[0]  # 3 held-out items in batches of 2


def test_training_overwrites_the_run_folder_with_ni(workspace):
    exp, configs = workspace
    log_path = os.path.join(exp, "logs", "again")
    os.makedirs(log_path)
    open(os.path.join(log_path, "stale.txt"), "w").close()
    assert _run(exp, configs[3], doc="again") == 0
    assert "stale.txt" not in os.listdir(log_path)
    assert "ckpt_3.npz" in os.listdir(log_path)


def test_emergency_snapshot_on_a_failing_step(workspace, monkeypatch):
    exp, configs = workspace
    make = diffusion_runner.make_train_step

    def failing(*args, **kw):
        step_fn, calls = make(*args, **kw), []

        def step(state, x0, generator, **kwargs):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected failure")
            return step_fn(state, x0, generator, **kwargs)

        return step

    monkeypatch.setattr(diffusion_runner, "make_train_step", failing)
    assert _run(exp, configs[5], doc="crash") == 1  # the failure propagates
    log_path = os.path.join(exp, "logs", "crash")
    assert "ckpt_emergency.npz" in os.listdir(log_path)
    _, meta = read_checkpoint(os.path.join(log_path, "ckpt_emergency.npz"))
    assert meta["step"] == 3  # the step that failed; the state is step 2's
    arrays, _ = read_checkpoint(os.path.join(log_path, "ckpt.npz"))
    assert int(arrays[".step"]) == 2
    assert "injected failure" in _log(exp, "crash")


def test_training_needs_a_data_folder(workspace, tmp_path):
    exp, configs = workspace
    with open(configs[3]) as f:
        raw = yaml.safe_load(f)
    raw["data"]["path"] = str(tmp_path / "nothing")
    bad = str(tmp_path / "bad.yml")
    with open(bad, "w") as f:
        yaml.safe_dump(raw, f)
    assert _run(exp, bad, doc="nodata") == 1
    assert "is not a directory" in _log(exp, "nodata")
