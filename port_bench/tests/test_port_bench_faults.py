"""A run with its timed path broken underneath comes out not correct: the
rest of a run (set-up, window, check) on the CPU at a tiny size, with the
program's answer altered where it is produced, a train step that leaves
its state unchanged, one that leaves its moving average unchanged, and one
that leaves half of the batch out."""

from __future__ import annotations

import pytest

from ddim_audio_tpu_torch.runners import diffusion_runner
from ddim_audio_tpu_torch.training import losses, train_step
from port_bench.harness.cell import execute
from port_bench.tests import tiny


def _run(tmp_path, cell):
    result, checks = execute(tiny.make(tmp_path), cell, 2 ** 35 + 1, 0.01,
                             False, device="cpu")
    return result["correct"], checks


def test_altered_clip(tmp_path, monkeypatch):
    real = diffusion_runner.denoise_2d

    def altered(x):
        out = real(x)
        out[0] *= 1.05  # one clip's answer, 5% off
        return out

    monkeypatch.setattr(diffusion_runner, "denoise_2d", altered)
    correct, checks = _run(tmp_path, "tiny-sample")
    assert not correct and checks["span_err_median"][0] > 1e-3


def test_unchanged_state(tmp_path, monkeypatch):
    monkeypatch.setattr(train_step, "apply_updates", lambda p, u: p)
    correct, checks = _run(tmp_path, "tiny-train")
    assert not correct and checks["move_gap"][0] == pytest.approx(1.0)


def test_unchanged_average(tmp_path, monkeypatch):
    monkeypatch.setattr(train_step, "ema_update", lambda shadow, p, mu: shadow)
    correct, checks = _run(tmp_path, "tiny-train")
    # every leaf whose reference move is the median's or more reads 1, so
    # the median of an even count of leaves reads over a half
    assert not correct and checks["ema_gap_median"][0] > 0.5


def test_half_batch(tmp_path, monkeypatch):
    real = losses.loss_registry["simple"]

    def half(apply_fn, params, x0, t, e, alphas, **kw):
        n = x0.shape[0] // 2
        return real(apply_fn, params, x0[:n], t[:n], e[:n], alphas, **kw)

    monkeypatch.setitem(losses.loss_registry, "simple", half)
    correct, checks = _run(tmp_path, "tiny-train")
    assert not correct and checks["loss_gap"][0] > 1e-2
