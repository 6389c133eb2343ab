"""The int8-storage configuration as a whole: ``apply_model_flat_io`` with
``act_store: int8``, ``strided_int8`` and ``tap_int8`` against the JAX
package's flat forward (``_apply_model_flat_core``, Pallas kernels in
interpret mode), fp32 and bf16, at the parity geometry of
``test_torch_production.py`` (f_size 64, ch 32 and 64: both stages store
int8 under the TPU rule and the JAX package's CPU rule alike, and both
transitions run int8 taps). The twins' groups are set to the TPU kernels';
at these sizes every TPU tile is the whole sample."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models import unet as jax_unet
from ddim_audio_tpu.utils.namespace import dict2namespace
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops import twin_route
from ddim_audio_tpu_torch.weights import params_from_jax

from tests.test_torch_production import GEOMETRY, TRANSFORMERS, snr_db

torch.set_num_threads(2)

JAX_GROUPS = {"taps": ((None, None), (0, 0)), "store": (None, "lane"),
              "strided": ((None, None), (2, 0))}
OPTIONS = dict(tap_int8=True, act_store="int8", strided_int8=True)


@pytest.fixture(scope="module")
def weights():
    """JAX and port trees with non-zero final GroupNorm weights, x, t."""
    tcfg = dict2namespace(TRANSFORMERS)
    cfg_t = unet.ModelConfig(**GEOMETRY, transformers=tcfg, **OPTIONS)
    params_j = jax.tree_util.tree_map(
        lambda v: jnp.asarray(v.numpy()),
        unet.init_model(torch.Generator().manual_seed(0), cfg_t, device="cpu"))
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in params_j[mod]["stages"]:
            for block in stage["blocks"]:
                c = block["norm3"]["g"].shape[0]
                block["norm3"]["g"] = jnp.asarray(
                    1.0 + 0.2 * rng.standard_normal(c).astype(np.float32))
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               device="cpu")
    x = rng.standard_normal((1, 2, 8, 64)).astype(np.float32)
    return tcfg, cfg_t, params_j, params_t, x, np.array([17], np.int32)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_int8_storage_forward_matches_jax(weights, dtype):
    tcfg, cfg_t, params_j, params_t, x, t = weights
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "fp32"
                else (torch.bfloat16, jnp.bfloat16))
    cfg_j = jax_unet.ModelConfig(**GEOMETRY, transformers=tcfg,
                                 conv_impl="pallas", dtype=jdt, **OPTIONS)
    to_flat_j, _, _ = jax_unet.flat_io_adapters(cfg_j)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_unet.apply_model_flat_io(
            params_j, to_flat_j(jnp.asarray(x)), jnp.asarray(t), cfg_j)
            .astype(jnp.float32))
    cfg = dataclasses.replace(cfg_t, dtype=tdt)
    assert all(unet.act_store_int8_stage(cfg, c) for c in cfg.ch)
    to_flat, _ = unet.flat_io_adapters(cfg)
    xf, tt = to_flat(torch.from_numpy(x)), torch.from_numpy(t)
    prepared = unet.prepare_params(params_t, cfg)
    with twin_route(int8_group=JAX_GROUPS):
        out = unet.apply_model_flat_io(prepared, xf, tt, cfg)
    assert out.dtype == tdt and out.shape == ref.shape
    assert snr_db(out.float().numpy(), ref) >= 50.0
