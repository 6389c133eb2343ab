"""int8 activation storage in the port (``sampling.act_store: int8``): the
storage modes of conv3x3_flat, residual_affine_flat and resblock_flat_int8
against the JAX package's Pallas kernels (interpret mode), with the twins'
storage group set to the TPU kernels' (``(tile_t, "lane")``: a tile of time
rows × the lanes of the flat period lcm(C, 128)); the stage predicate; the
wrappers' own groups on the CPU; and a CPU command-line run with both int8
options. The whole-model forward is held against JAX in
``test_torch_int8_store_model.py``."""

import dataclasses
import logging
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.models.unet import _resblock_init
from ddim_audio_tpu.ops.flat_resblock import resblock_flat_int8 as jax_resblock
from ddim_audio_tpu.ops.pallas.conv_flat import conv3x3_flat as jax_conv3x3
from ddim_audio_tpu.ops.pallas.conv_flat import (
    flat_period,
    pack_conv_weights,
    residual_affine_flat as jax_res_affine,
    supports_flat_int8,
)
from ddim_audio_tpu_torch import cli
from ddim_audio_tpu_torch.config import load_config, production_eval_cfg
from ddim_audio_tpu_torch.models import unet
from ddim_audio_tpu_torch.ops import launch_counts, twin_route
from ddim_audio_tpu_torch.ops.conv_flat import (
    STORE_GROUP,
    conv3x3_flat,
    conv3x3_flat_plain,
    dequantize_store,
    quantize_store,
)
from ddim_audio_tpu_torch.ops.flat_resblock import resblock_flat, resblock_flat_int8
from ddim_audio_tpu_torch.ops.residual_affine import (
    residual_affine_flat,
    residual_affine_flat_plain,
)
from ddim_audio_tpu_torch.weights import params_from_jax, save_eval_checkpoint

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, TILE_T = 2, 16, 4
JAX_GROUP = (TILE_T, "lane")
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def snr_db(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return 10 * np.log10((ref ** 2).mean() / max(((out - ref) ** 2).mean(), 1e-300))


def _inputs(c, f, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((B, T, f * c)).astype(np.float32),
        res=rng.standard_normal((B, T, f * c)).astype(np.float32),
        w=(rng.standard_normal((3, 3, c, c)) * 0.1).astype(np.float32),
        scale=(1 + 0.1 * rng.standard_normal((B, c))).astype(np.float32),
        shift=(0.1 * rng.standard_normal((B, c))).astype(np.float32),
        add=rng.standard_normal((B, c)).astype(np.float32))


def _to_jax_scales(sc, c):
    """[B, n_T, P/C, C] → the TPU kernels' [B, n_T, 8, P] stripes."""
    b, n_t = sc.shape[:2]
    p = flat_period(c)
    return jnp.asarray(np.broadcast_to(
        sc.numpy().reshape(b, n_t, 1, p), (b, n_t, 8, p)))


def _from_jax_scales(sc, c):
    sc = np.asarray(sc)
    return sc[:, :, 0, :].reshape(sc.shape[0], sc.shape[1], -1, c)


def _fold(s, c):
    """per-lane [B, F·C] (or period-folded [B, P]) sums → per channel."""
    s = np.asarray(s)
    return s.reshape(s.shape[0], -1, c).sum(1)


def _assert_int8_close(q, ref):
    q, ref = q.numpy().astype(np.int32), np.asarray(ref).astype(np.int32)
    diff = np.abs(q - ref)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.999


def _assert_stats(s, ref, c):
    np.testing.assert_allclose(s.numpy(), _fold(ref, c), rtol=1e-5, atol=1e-3)


# mode: the operands of one storage-mode call, as resblock_flat_int8 makes
# them (conv1: float in, int8 out; conv2: int8 in and out) and the int8
# residual with a float output (fp32: a bf16 output differs from JAX's by
# whole bf16 ulps where the fp32 sums round to either side)
CASES = [("conv1", 32, 8, "fp32"), ("conv1", 64, 4, "bf16"),
         ("conv2", 32, 8, "bf16"), ("conv2", 64, 4, "fp32"),
         ("residual", 64, 4, "fp32")]


@pytest.mark.parametrize("mode,c,f,dt", CASES)
def test_storage_modes_match_jax_kernel(mode, c, f, dt):
    tdt, jdt = DTYPES[dt]
    d = _inputs(c, f, seed=c + len(mode))
    w = _t(d["w"], tdt)
    wp = pack_conv_weights(jnp.asarray(d["w"]), jdt)
    pre_j = (jnp.tile(d["scale"], (1, f)), jnp.tile(d["shift"], (1, f)))
    add_j = jnp.tile(d["add"], (1, f))
    kw = dict(c=c, pre=(_t(d["scale"]), _t(d["shift"])), pre_silu=True,
              add=_t(d["add"]), post_silu=True)
    jkw = dict(c=c, tile_t=TILE_T, pre=pre_j, pre_silu=True, add=add_j,
               post_silu=True, compute_dtype=jdt)
    x = _t(d["x"], tdt)
    if mode == "conv1":
        args, jargs = dict(quant_out=True), dict(quant_out=True)
    else:  # an int8 operand and its scales, quantised in the TPU group
        q, sc = quantize_store(_t(d["x" if mode == "conv2" else "res"])
                               .view(B, T, f, c), JAX_GROUP)
        if mode == "conv2":
            x, args = q, dict(in_scales=sc, quant_out=True)
            jargs = dict(in_scales=_to_jax_scales(sc, c), quant_out=True)
        else:
            args = dict(residual=q, res_scales=sc)
            jargs = dict(residual=jnp.asarray(q.numpy()),
                         res_scales=_to_jax_scales(sc, c))
    xj = jnp.asarray(x.float().numpy()).astype(jdt) if x.dtype != torch.int8 \
        else jnp.asarray(x.numpy())
    with pltpu.force_tpu_interpret_mode():
        ref = jax_conv3x3(xj, wp, want_stats=True, **jkw, **jargs)
    before = launch_counts()
    with twin_route(int8_group={"store": JAX_GROUP}):
        out = conv3x3_flat(x, w, want_stats=True, **kw, **args)
    assert launch_counts() == before  # CPU tensors never count a launch
    if mode == "residual":
        assert out[0].dtype == tdt
        r = np.asarray(ref[0].astype(jnp.float32))
        np.testing.assert_allclose(out[0].float().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    else:
        # a scale is its group's max|out| / 127, and the conv sums its 9·C
        # products in another order than the TPU kernel's packed matmuls:
        # the float outputs' tolerance (1e-5) holds for it, not 1e-6 (an
        # fp32 run read 2.7e-6 at the worst of 1,024 scales)
        assert out[0].dtype == torch.int8 and out[1].shape == (B, 4, 128 // c, c)
        _assert_int8_close(out[0], ref[0])
        np.testing.assert_allclose(out[1].numpy(), _from_jax_scales(ref[1], c),
                                   rtol=1e-5, atol=0)
    _assert_stats(out[-2], ref[-2], c)
    _assert_stats(out[-1], ref[-1], c)


@pytest.mark.parametrize("x_kind", ["int8", "bf16"])
@pytest.mark.parametrize("quant_out", [True, False])
def test_residual_affine_matches_jax_kernel(x_kind, quant_out):
    c, f = 32, 8
    p = flat_period(c)
    d = _inputs(c, f, seed=7)
    s, s_sc = quantize_store(_t(d["res"]).view(B, T, f, c), JAX_GROUP)
    if x_kind == "int8":
        x, x_sc = quantize_store(_t(d["x"]).view(B, T, f, c), JAX_GROUP)
        xj, xsj = jnp.asarray(x.numpy()), _to_jax_scales(x_sc, c)
    else:
        x, x_sc = _t(d["x"], torch.bfloat16), None
        xj, xsj = jnp.asarray(d["x"]).astype(jnp.bfloat16), None
    fpp = p // c
    aff_j = (jnp.tile(d["scale"], (1, fpp)), jnp.tile(d["shift"], (1, fpp)))
    with pltpu.force_tpu_interpret_mode():
        ref = jax_res_affine(
            xj.reshape(B, -1, p), jnp.asarray(s.numpy()).reshape(B, -1, p),
            aff_j, c=c, f=f, x_scales=xsj, s_scales=_to_jax_scales(s_sc, c),
            quant_out=quant_out, want_stats=True, out_dtype=jnp.bfloat16)
    with twin_route(int8_group={"store": JAX_GROUP}):
        out = residual_affine_flat(
            x, s, (_t(d["scale"]), _t(d["shift"])), c=c, x_scales=x_sc,
            s_scales=s_sc, quant_out=quant_out, want_stats=True,
            out_dtype=torch.bfloat16)
    if quant_out:
        _assert_int8_close(out[0].view(B, -1), np.asarray(ref[0]).reshape(B, -1))
        np.testing.assert_allclose(out[1].numpy(), _from_jax_scales(ref[1], c),
                                   rtol=1e-6, atol=0)
    else:
        r = np.asarray(ref[0].astype(jnp.float32)).reshape(B, T, -1)
        assert out[0].dtype == torch.bfloat16
        np.testing.assert_allclose(out[0].float().numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
    _assert_stats(out[-2], ref[-2], c)
    _assert_stats(out[-1], ref[-1], c)


def test_resblock_flat_int8_chain_matches_jax():
    """Two blocks as a stage chains them (float entry, int8 between, float
    exit): >= 50 dB against the JAX chain, and 20-50 dB against the float
    chain, so the int8 noise is really there."""
    c, f, t = 32, 8, 16
    p_fp = flat_period(c)
    rng = np.random.default_rng(11)
    blocks = []
    for k in range(2):
        blk = _resblock_init(jax.random.key(k), c, 3, jnp.float32)
        blk["norm3"]["g"] = jnp.asarray(
            1.0 + 0.2 * rng.standard_normal(c).astype(np.float32))
        blk["conv2"]["b"] = jnp.asarray(
            0.1 * rng.standard_normal(c).astype(np.float32))
        blocks.append(blk)
    x = rng.standard_normal((B, t, f * c)).astype(np.float32)
    temb = rng.standard_normal((2, B, c)).astype(np.float32)
    # JAX: the row view [B, T·G, P]
    hv, scales, stats = jnp.asarray(x).reshape(B, -1, p_fp), None, None
    with pltpu.force_tpu_interpret_mode():
        for k, blk in enumerate(blocks):
            last = k == 1
            hv, scales, stats = jax_resblock(
                blk, hv, jnp.asarray(temb[k]), f=f, c=c, tile_t=TILE_T,
                in_stats=stats, in_scales=scales, quant_out=not last,
                want_out_stats=not last, compute_dtype=jnp.float32)
    ref = np.asarray(hv).reshape(B, t, f * c)
    ptree = [params_from_jax(jax.tree_util.tree_map(np.asarray, blk),
                             device="cpu") for blk in blocks]
    h, scales, stats = _t(x), None, None
    with twin_route(int8_group={"store": JAX_GROUP}):
        for k, blk in enumerate(ptree):
            last = k == 1
            h, scales, stats = resblock_flat_int8(
                blk, h, _t(temb[k]), f=f, c=c, dtype=torch.float32,
                in_stats=stats, in_scales=scales, quant_out=not last,
                want_out_stats=not last)
            assert (h.dtype == torch.int8) != last
    assert snr_db(h.numpy(), ref) >= 50.0
    hf, st = _t(x), None
    for k, blk in enumerate(ptree):
        res = resblock_flat(blk, hf, _t(temb[k]), f=f, c=c, in_stats=st,
                            want_out_stats=k == 0)
        hf, st = res if k == 0 else (res, None)
    assert 20.0 <= snr_db(h.numpy(), hf.numpy()) <= 50.0


def test_stage_predicate_matches_jax():
    """int8 storage at the stages where the JAX package's
    ``supports_flat_int8`` holds on the TPU: C <= 128 at audio.yml (and at
    the parity geometry of the model test, where its CPU rule agrees)."""
    config = load_config(os.path.join(REPO, "configs", "audio.yml"))
    config.sampling.act_store = "int8"
    cfg = production_eval_cfg(config, unet.ModelConfig.from_config(config))
    assert cfg.act_store == "int8"
    f = cfg.f_size
    for c in cfg.ch:
        assert unet.act_store_int8_stage(cfg, c) == supports_flat_int8(c, f)
        f //= 2
    assert [unet.act_store_int8_stage(cfg, c) for c in cfg.ch] == \
        [True] * 4 + [False] * 2
    small = dataclasses.replace(cfg, ch=(32, 64), f_size=64)
    for c, f in ((32, 64), (64, 32)):
        assert unet.act_store_int8_stage(small, c)
        assert supports_flat_int8(c, f) and supports_flat_int8(c, f, hw=False)
    assert not unet.act_store_int8_stage(
        dataclasses.replace(cfg, act_store=None), 32)


def test_wrappers_default_to_the_kernel_group():
    """On the CPU the wrappers run their twins with the CUDA kernels'
    storage group (8 time rows × 16 columns × one channel) unless
    ``twin_route`` sets another."""
    c, f = 32, 32
    d = _inputs(c, f, seed=5)
    x, w = _t(d["x"]), _t(d["w"])
    q, sc, s1, s2 = conv3x3_flat(x, w, c=c, add=_t(d["add"]), quant_out=True,
                                 want_stats=True)
    assert sc.shape == (B, T // STORE_GROUP[0], f // STORE_GROUP[1], c)
    ref = conv3x3_flat_plain(x, w, c=c, add=_t(d["add"]), quant_out=True,
                             want_stats=True, store_group=STORE_GROUP)
    for a, b in zip((q, sc, s1, s2), ref):
        assert torch.equal(a, b)
    # every group's largest magnitude lands on ±127
    mx = q.view(B, 2, 8, 2, 16, c).abs().amax(dim=(2, 4))
    assert bool((mx == 127).all())
    deq = dequantize_store(q, sc, c)
    out32 = conv3x3_flat_plain(x, w, c=c, add=_t(d["add"]))
    assert float((deq - out32.view(B, T, f, c)).abs().max()) <= \
        0.5 * float(sc.max()) * 1.0001
    s = residual_affine_flat(q, q, None, c=c, x_scales=sc, s_scales=sc)
    assert s.dtype == torch.bfloat16  # the TPU wrapper's default
    with twin_route(int8_group={"store": (4, "lane")}):
        q4, sc4 = conv3x3_flat(x, w, c=c, quant_out=True)
    assert sc4.shape == (B, T // 4, 128 // c, c)
    ref4 = residual_affine_flat_plain(q4, q4, None, c=c, x_scales=sc4,
                                      s_scales=sc4, store_group=(4, "lane"))
    with twin_route(int8_group={"store": (4, "lane")}):
        assert torch.equal(residual_affine_flat(q4, q4, None, c=c,
                                                x_scales=sc4, s_scales=sc4),
                           ref4)


def test_cli_int8_storage_cpu(tmp_path):
    """The sampling command line on the CPU with ``sampling.act_store: int8``
    and ``sampling.strided_int8: true``: exit 0, the two files, finite."""
    with open(os.path.join(REPO, "configs", "audio_tiny.yml")) as fh:
        raw = yaml.safe_load(fh)
    raw["sampling"].update(act_store="int8", strided_int8=True)
    cfg_path = tmp_path / "int8.yml"
    cfg_path.write_text(yaml.safe_dump(raw))
    cfg = unet.ModelConfig.from_config(load_config(str(cfg_path)))
    params = unet.init_model(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    for mod in ("down_modules", "up_modules"):
        for stage in params[mod]["stages"]:
            for block in stage["blocks"]:
                block["norm3"]["g"].fill_(1.0)
    exp = tmp_path / "exp"
    save_eval_checkpoint(str(exp / "logs" / "run"), params)
    try:
        code = cli.main(["--config", str(cfg_path), "--doc", "run", "--exp",
                         str(exp), "--ni", "--device", "cpu", "--sample",
                         "--timesteps", "3", "-i", "int8"])
    finally:
        logging.getLogger().handlers.clear()
    assert code == 0
    folder = exp / "image_samples" / "int8"
    assert sorted(os.listdir(folder)) == ["0_final.png", "0_final.wav"]
    from scipy.io import wavfile

    _, wav = wavfile.read(folder / "0_final.wav")
    assert np.isfinite(wav.astype(np.float64)).all() and np.abs(wav).max() > 0
