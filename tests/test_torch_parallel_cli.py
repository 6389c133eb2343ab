"""The port's command line under a launcher, on the CPU: 2-step training
runs at the tiny config with ``parallel: {dp: 2}`` and with ``parallel:
{sp: 2}`` under ``python -m torch.distributed.run --nproc_per_node 2`` (two
gloo ranks, ``--device cpu``; the two launches run at once) against the same
run in one process with ``grad_accum: 2`` and 1 (through the runner, as the
command line drives it): the same checkpoint, and one run folder that rank 0
alone writes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from ddim_audio_tpu_torch import cli
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion
from ddim_audio_tpu_torch.weights import read_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The exp folder of both runs and the launcher's completed process."""
    root = tmp_path_factory.mktemp("dp_cli")
    data = root / "data"
    data.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):  # 8 items: 7 to train, 1 held out
        np.save(data / f"clip{i}.npy",
                (0.1 * rng.standard_normal(8 * 15)).astype(np.float32))
    with open(os.path.join(REPO, "configs", "audio_tiny.yml")) as fh:
        raw = yaml.safe_load(fh)
    raw["data"]["path"] = str(data)
    raw["training"].update(n_iters=2, snapshot_freq=2, validation_freq=2)
    paths = {}
    for name, dp, sp, accum in (("dp", 2, 1, 1), ("sp", 1, 2, 1),
                                ("one", 1, 1, 2), ("one1", 1, 1, 1)):
        raw["parallel"] = {"dp": dp, "sp": sp}
        raw["training"]["grad_accum"] = accum
        paths[name] = str(root / f"{name}.yml")
        with open(paths[name], "w") as fh:
            yaml.safe_dump(raw, fh)
    exp = str(root / "exp")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "ddim_audio_tpu_torch", "--config",
         paths[name], "--doc", name, "--exp", exp, "--ni", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in ("dp", "sp")}
    try:
        for name in ("one", "one1"):
            args = cli.build_parser().parse_args(
                ["--config", paths[name], "--doc", name, "--exp", exp])
            args.log_path = os.path.join(exp, "logs", name)
            Diffusion(args, load_config(paths[name]), device="cpu").train()
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, f"{name}: {err[-4000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return exp, procs


def test_launcher_run_equals_one_process(runs):
    """Parameters, optimizer state and EMA after 2 steps: within 5e-7
    absolute plus 1e-5 relative (tests/test_torch_train_step.py's
    tolerances; the ranks run one thread each, this process several, so the
    CPU's reductions block another way)."""
    _same_checkpoint(runs[0], "dp", "one")


def test_sp_launcher_run_equals_one_process(runs):
    """``parallel: {sp: 2}``: each rank trains on its time block of every
    batch; after 2 steps the same checkpoint as one process's grad_accum 1
    run, within the same tolerances (the sp ranks add their partial sums in
    another order)."""
    _same_checkpoint(runs[0], "sp", "one1")


def _same_checkpoint(exp, run, ref_run):
    got, meta = read_checkpoint(os.path.join(exp, "logs", run, "ckpt.npz"))
    ref, ref_meta = read_checkpoint(os.path.join(exp, "logs", ref_run,
                                                 "ckpt.npz"))
    assert meta["step"] == ref_meta["step"] == 2
    assert got.keys() == ref.keys()
    for k in ref:
        if k.startswith((".params", ".ema")):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=5e-7,
                                       err_msg=k)
        elif ref[k].ndim:
            scale = max(np.abs(ref[k]).max(), 1e-12)
            np.testing.assert_allclose(got[k] / scale, ref[k] / scale,
                                       rtol=1e-3, atol=1e-4, err_msg=k)


def test_launcher_run_folder_written_by_rank0(runs):
    """The files of a training run, each once; the log holds each step once
    (rank 1 logs warnings only, to its console); config.yml is the launcher
    run's."""
    _folder_of_rank0(runs[0], "dp", {"dp": 2, "sp": 1})


def test_sp_launcher_run_folder_written_by_rank0(runs):
    _folder_of_rank0(runs[0], "sp", {"dp": 1, "sp": 2})


def _folder_of_rank0(exp, run, parallel):
    folder = os.path.join(exp, "logs", run)
    assert sorted(os.listdir(folder)) == [
        "ckpt.npz", "ckpt_1.npz", "ckpt_2.npz", "config.yml", "stdout.txt"]
    with open(os.path.join(folder, "stdout.txt")) as fh:
        text = fh.read()
    for step in (1, 2):
        assert text.count(f"step: {step}, loss: ") == 1
    assert text.count("step: 2, val-loss: ") == 1
    with open(os.path.join(folder, "config.yml")) as fh:
        assert yaml.safe_load(fh)["parallel"] == parallel
