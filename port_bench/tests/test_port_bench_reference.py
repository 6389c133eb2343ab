"""The float32 reference against the program's plain route and its sampler
and train step at configs/audio_tiny.yml's geometry on the CPU (this test
may import the program; the reference may not)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch.models.unet import ModelConfig, apply_model
from ddim_audio_tpu_torch.ops.signal import denoise_2d
from ddim_audio_tpu_torch.utils.namespace import dict2namespace
from port_bench.harness.cell import execute
from port_bench.harness.params import make_params
from port_bench.reference.model import Geometry, Model, param_spec
from port_bench.reference.sampler import wiener_2d
from port_bench.tests import tiny


@pytest.mark.parametrize("seed", [1, 2 ** 40 + 3])
def test_forward_matches_plain_route(seed):
    raw = tiny.tiny_config()
    geom = Geometry.from_config(raw)
    cfg = dataclasses.replace(ModelConfig.from_config(dict2namespace(raw)),
                              conv_impl="xla")
    params = make_params(param_spec(geom), seed, "cpu")
    x = torch.randn(3, geom.channels, 32, geom.f_size,
                    generator=torch.Generator().manual_seed(seed % 97))
    t = torch.tensor([0, 17, 49])
    ref = Model(geom, "cpu")(params, x, t)
    got = apply_model(params, x, t, cfg)
    err = (got - ref).norm() / ref.norm()
    assert err < 1e-5


def test_filter_matches_program():
    x = torch.randn(2, 2, 64, 32, generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(wiener_2d(x).numpy(), denoise_2d(x).numpy(),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("cell", ["tiny-sample", "tiny-train"])
def test_sound_run_is_correct(tmp_path, cell):
    result, checks = execute(tiny.make(tmp_path), cell, 2 ** 33 + 5, 0.01,
                             False, device="cpu")
    assert result["correct"], checks
    assert all(v < lim / 10 for v, lim in checks.values()), checks
