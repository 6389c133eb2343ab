"""The port's head/tail convs against the JAX package's Pallas head/tail
kernels (interpret mode) and against the padded-square conv they replace (the
whole flat forward at a geometry where the JAX package uses its head/tail
kernels too is in tests/test_torch_production.py). CPU tensors run the plain
twins; the CUDA kernels are
held against the same twins on the card by the ``gpu``-marked test and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from ddim_audio_tpu.ops.pallas.conv_head_tail import (
    conv_head_flat as jax_head,
    conv_tail_flat as jax_tail,
    pack_head_weights,
    pack_tail_weights,
    supports_head_tail,
)
from ddim_audio_tpu_torch.ops import launch_counts
from ddim_audio_tpu_torch.ops.conv_flat import conv3x3_flat_plain
from ddim_audio_tpu_torch.ops.conv_head_tail import (
    conv_head_flat,
    conv_head_flat_plain,
    conv_tail_flat,
    conv_tail_flat_plain,
)

torch.set_num_threads(2)

def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def jax_pair():
    """Inputs from a numpy seed and the JAX kernels' outputs (fp32, the JAX
    package's own test geometry: the kernels need whole 128-lane rows)."""
    B, T, F, CIN, C0 = 2, 8, 256, 2, 32
    assert supports_head_tail(CIN, C0, F, hw=False)
    rng = np.random.default_rng(0)
    d = dict(
        x=rng.standard_normal((B, T, F * CIN)).astype(np.float32),
        wh=rng.standard_normal((3, 3, CIN, C0)).astype(np.float32) * 0.2,
        bh=rng.standard_normal(C0).astype(np.float32),
        h=rng.standard_normal((B, T, F * C0)).astype(np.float32),
        res=rng.standard_normal((B, T, F * C0)).astype(np.float32),
        wt=rng.standard_normal((3, 3, C0, CIN)).astype(np.float32) * 0.2,
        bt=rng.standard_normal(CIN).astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        out, s1, s2 = jax_head(jnp.asarray(d["x"]), pack_head_weights(d["wh"]),
                               d["bh"], c_in=CIN, c0=C0, f=F, want_stats=True)
        tail = jax_tail(jnp.asarray(d["h"]), pack_tail_weights(d["wt"], F),
                        d["bt"], c0=C0, c_out=CIN, f=F,
                        residual=jnp.asarray(d["res"]))
        tail_nores = jax_tail(jnp.asarray(d["h"]),
                              pack_tail_weights(d["wt"], F), d["bt"], c0=C0,
                              c_out=CIN, f=F)
    d.update(head=np.asarray(out).reshape(B, T, F * C0),
             s1=np.asarray(s1).reshape(B, F, C0).sum(1),
             s2=np.asarray(s2).reshape(B, F, C0).sum(1),
             tail=np.asarray(tail), tail_nores=np.asarray(tail_nores))
    return d


def test_head_matches_jax_kernel(jax_pair):
    d = jax_pair
    before = launch_counts()
    out, s1, s2 = conv_head_flat(_t(d["x"]), _t(d["wh"]), _t(d["bh"]), c_in=2,
                                 c0=32, want_stats=True)
    assert launch_counts() == before  # CPU tensors never count a launch
    np.testing.assert_allclose(out.numpy(), d["head"], atol=2e-5)
    # the JAX test's own tolerance (2e-4) per lane; 256 lanes fold per channel
    np.testing.assert_allclose(s1.numpy(), d["s1"], rtol=1e-5, atol=2e-4 * 16)
    np.testing.assert_allclose(s2.numpy(), d["s2"], rtol=1e-5, atol=2e-4 * 16)


def test_head_without_stats_returns_only_out(jax_pair):
    d = jax_pair
    out = conv_head_flat(_t(d["x"]), _t(d["wh"]), _t(d["bh"]), c_in=2, c0=32)
    np.testing.assert_allclose(out.numpy(), d["head"], atol=2e-5)


@pytest.mark.parametrize("with_res", [True, False])
def test_tail_matches_jax_kernel(jax_pair, with_res):
    d = jax_pair
    out = conv_tail_flat(_t(d["h"]), _t(d["wt"]), _t(d["bt"]), c0=32, c_out=2,
                         residual=_t(d["res"]) if with_res else None)
    ref = d["tail"] if with_res else d["tail_nores"]
    assert out.shape == (2, 8, 256 * 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=5e-5)


@pytest.mark.parametrize("t,f,cin,c0", [(6, 5, 2, 32), (4, 16, 1, 16),
                                        (8, 3, 4, 64)])
def test_head_tail_equal_the_padded_square_conv(t, f, cin, c0):
    """What the head and tail compute is the channel-padded square conv the
    flat forward ran before them (and the JAX package runs where its kernels
    do not apply), at any geometry."""
    rng = np.random.default_rng(t * f)
    x = _t(rng.standard_normal((2, t, f * cin)))
    wh = _t(rng.standard_normal((3, 3, cin, c0)) * 0.2)
    bh = _t(rng.standard_normal(c0))
    out, s1, s2 = conv_head_flat_plain(x, wh, bh, c_in=cin, c0=c0,
                                       want_stats=True)
    xp = torch.nn.functional.pad(x.view(2, t, f, cin), (0, c0 - cin))
    wp = torch.nn.functional.pad(wh, (0, 0, 0, c0 - cin))
    ref, r1, r2 = conv3x3_flat_plain(xp.reshape(2, t, f * c0), wp, c=c0,
                                     add=bh, want_stats=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(s1, r1, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(s2, r2, atol=1e-4, rtol=1e-5)

    h, res = _t(rng.standard_normal((2, 2, t, f * c0)))
    wt = _t(rng.standard_normal((3, 3, c0, cin)) * 0.1)
    bt = _t(rng.standard_normal(cin))
    out = conv_tail_flat_plain(h, wt, bt, c0=c0, c_out=cin, residual=res)
    ref = conv3x3_flat_plain(
        h, torch.nn.functional.pad(wt, (0, c0 - cin)), c=c0, residual=res,
        add=torch.nn.functional.pad(bt, (0, c0 - cin)))
    ref = ref.view(2, t, f, c0)[..., :cin].reshape(2, t, f * cin)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_tail_rounds_the_residual_sum_to_the_storage_dtype():
    """bf16: v = bf16(fp32(h) + fp32(res)) feeds the taps, and the output is
    rounded to bf16 once."""
    rng = np.random.default_rng(3)
    h, res = _t(rng.standard_normal((2, 1, 4, 3 * 32))).bfloat16()
    w = _t(rng.standard_normal((3, 3, 32, 2)) * 0.1).bfloat16()
    b = _t(rng.standard_normal(2))
    out = conv_tail_flat(h, w, b, c0=32, c_out=2, residual=res)
    assert out.dtype == torch.bfloat16
    v = (h.float() + res.float()).bfloat16().float()
    ref = conv_tail_flat_plain(v, w.float(), b, c0=32, c_out=2)
    torch.testing.assert_close(out, ref.bfloat16(), atol=0, rtol=0)


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,F", [(20, 12), (9, 40)])
def test_head_tail_kernels_match_twins_on_gpu(cuda, dtype, tol, T, F):
    """The CUDA head/tail kernels vs their twins at ragged tile edges;
    relative to max|twin|."""
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g, device=cuda)

    def close(a, b):
        err = (a.float() - b.float()).abs().max() / b.float().abs().max()
        assert err <= tol, err

    x, wh, bh = rnd(2, T, F * 2).to(dtype), (0.2 * rnd(3, 3, 2, 32)).to(dtype), rnd(32)
    before = sum(launch_counts().values())
    got = conv_head_flat(x, wh, bh, c_in=2, c0=32, want_stats=True)
    assert sum(launch_counts().values()) == before + 1
    for a, b in zip(got, conv_head_flat_plain(x, wh, bh, c_in=2, c0=32,
                                              want_stats=True)):
        close(a, b)
    h, res = rnd(2, 2, T, F * 32).to(dtype)
    wt, bt = (0.1 * rnd(3, 3, 32, 2)).to(dtype), rnd(2)
    close(conv_tail_flat(h, wt, bt, c0=32, c_out=2, residual=res),
          conv_tail_flat_plain(h, wt, bt, c0=32, c_out=2, residual=res))
    with pytest.raises(ValueError, match="C0 % 32"):
        conv_tail_flat(rnd(1, 4, 4 * 16).to(dtype),
                       rnd(3, 3, 16, 2).to(dtype), bt, c0=16, c_out=2)


@pytest.mark.gpu
def test_twin_route_and_its_shadow_on_gpu(cuda):
    """Inside ``twin_route`` a CUDA tensor runs the twin and launches nothing;
    with a shadow the kernel is launched once beside it, both results are
    handed over and the twin's is returned."""
    from ddim_audio_tpu_torch.ops import twin_route

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(2, 16, 24 * 2, generator=g, device=cuda)
    w = torch.randn(3, 3, 2, 32, generator=g, device=cuda) * 0.2
    b = torch.randn(32, generator=g, device=cuda)
    kw = dict(c_in=2, c0=32, want_stats=True)
    ref = conv_head_flat_plain(x, w, b, **kw)
    before = launch_counts()["conv_head_flat"]
    with twin_route():
        out = conv_head_flat(x, w, b, **kw)
    assert launch_counts()["conv_head_flat"] == before
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    seen = []
    with twin_route(shadow=lambda name, k, t: seen.append((name, k, t))):
        out = conv_head_flat(x, w, b, **kw)
    assert launch_counts()["conv_head_flat"] == before + 1
    (name, kern, twin), = seen
    assert name == "conv_head_flat" and all(
        torch.equal(o, r) for o, r in zip(out, twin))
    torch.testing.assert_close(kern[0], ref[0], atol=1e-5, rtol=1e-5)
    conv_head_flat(x, w, b, **kw)  # outside the block: the kernel again
    assert launch_counts()["conv_head_flat"] == before + 2
