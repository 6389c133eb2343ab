"""The port's sequence-parallel forward (``parallel/sp.py``) and its mesh
helpers (``parallel/mesh.py``, ``parallel/multihost.py``) on gloo ranks on
the CPU, against the JAX package at the tiny config: ``apply_model_sp`` at
sp = 2 and 4 and on a dp × sp = 2 × 2 mesh against JAX's ``apply_model`` and
JAX's own ``apply_model_sp`` (its XLA route on the virtual CPU mesh of
tests/conftest.py), within 2e-4 absolute, the JAX package's own tolerance
(tests/test_parallel.py). The port's resblocks run the conv3x3 kernels'
twins on each haloed block; ``conv_impl: xla`` runs the plain blocks.
Weights have non-zero final GroupNorm weights (zero-init GN3 would make
every resblock the identity and hide halo faults), and one case zeroes a
GN1 weight, where the boundary pad row's ridge fallback acts."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import mesh_utils
from jax.sharding import Mesh

from ddim_audio_tpu.models.unet import apply_model as jax_apply_model
from ddim_audio_tpu.parallel.sp import apply_model_sp as jax_apply_model_sp
from ddim_audio_tpu_torch.models import unet
from tests import torch_parallel_workers as workers
from tests.torch_dist import run_ranks

ATOL = 2e-4


def _params():
    """Numpy params of the tiny model, GN3 weights 1 ± 0.2
    (``workers.tiny_params``), a copy whose first block's GN1 weight is 0
    in channel 0, and the C = 32 model of the production case."""
    params = jax.tree_util.tree_map(lambda v: v.numpy().copy(),
                                    workers.tiny_params())
    zero = jax.tree_util.tree_map(np.copy, params)
    zero["down_modules"]["stages"][0]["blocks"][0]["norm1"]["g"][0] = 0.0
    c32 = unet.init_model(torch.Generator().manual_seed(0),
                          workers._tiny_cfg(**PROD), device="cpu")
    return {"gn3": params, "gamma0": zero,
            "c32": jax.tree_util.tree_map(lambda v: v.numpy().copy(), c32)}


def _inputs(seed, b, t):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 2, t, 16)).astype(np.float32),
            rng.integers(0, 50, size=b).astype(np.int64))


X2, T2 = _inputs(1, 2, 32)
X1, T1 = _inputs(2, 1, 16)
XBAD, TBAD = _inputs(4, 1, 24)

# the production knobs at a width that takes int8 taps (C = 32)
PROD = dict(ch=(32, 32, 32), dtype=torch.bfloat16, tap_int8=True)
CASES2 = [("sp2", 1, 2, X2, T2, {}, "gn3"),
          ("sp2_plain", 1, 2, X2, T2, {"conv_impl": "xla"}, "gn3"),
          ("sp2_gamma0", 1, 2, X1, T1, {}, "gamma0"),
          ("sp2_prod", 1, 2, X2, T2, dict(PROD, act_store="int8"), "c32")]
CASES4 = [("sp4", 1, 4, X2, T2, {}, "gn3"),
          ("dp2sp2", 2, 2, X2, T2, {}, "gn3"),
          ("sp4_bad_T", 1, 4, XBAD, TBAD, {}, "gn3")]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The ranks' results: a 2-rank world and a 4-rank world."""
    params = _params()
    tmp = tmp_path_factory.mktemp("sp")
    return (params, run_ranks(workers.sp_forward, 2, tmp, params, CASES2),
            run_ranks(workers.sp_forward, 4, tmp, params, CASES4))


def _jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@functools.lru_cache(maxsize=None)
def _jax_fn(n_sp):
    """JAX's forward under jit (its eager shard_map takes a minute on the
    CPU): apply_model, or apply_model_sp on an sp mesh of n_sp devices."""
    cfg = _jax_cfg()
    if not n_sp:
        return jax.jit(lambda p, xx, tt: jax_apply_model(p, xx, tt, cfg))
    mesh = _sp_mesh(n_sp)
    return jax.jit(lambda p, xx, tt: jax_apply_model_sp(p, xx, tt, cfg, mesh))


def _jax_forward(params, x, t, n_sp=0):
    return np.asarray(_jax_fn(n_sp)(_jax_tree(params), jnp.asarray(x),
                                    jnp.asarray(t)))


def _jax_cfg():
    from tests.conftest import tiny_model_config

    return tiny_model_config()


def _sp_mesh(n):
    return Mesh(mesh_utils.create_device_mesh((n,), jax.devices()[:n]),
                ("sp",))


@pytest.mark.parametrize("name", ["sp2", "sp2_plain", "sp2_gamma0", "sp4",
                                  "dp2sp2"])
def test_sp_forward_matches_jax_apply_model(port, name):
    params, res2, res4 = port
    case = {c[0]: c for c in CASES2 + CASES4}[name]
    _, _, _, x, t, _, pkey = case
    ref = _jax_forward(params[pkey], x, t)
    results = res2 if name in dict((c[0], c) for c in CASES2) else res4
    for rank, res in enumerate(results):  # every rank returns the whole ε
        assert res[name].shape == ref.shape
        np.testing.assert_allclose(res[name], ref, rtol=0, atol=ATOL,
                                   err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name,n", [("sp2", 2), ("sp4", 4)])
def test_sp_forward_matches_jax_apply_model_sp(port, name, n):
    params, res2, res4 = port
    ref = _jax_forward(params["gn3"], X2, T2, n)
    got = (res2 if n == 2 else res4)[0][name]
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_sp_refuses_indivisible_time(port):
    """T = 24 at sp = 4 and a total stride of 4: JAX's check, JAX's
    message."""
    _, _, res4 = port
    for res in res4:
        assert res["sp4_bad_T"] == ("ValueError: T=24 must be divisible by "
                                    "sp×stride = 16")
    with pytest.raises(ValueError, match="divisible"):
        jax_apply_model_sp(_jax_tree(_params()["gn3"]), jnp.asarray(XBAD),
                           jnp.asarray(TBAD), _jax_cfg(), _sp_mesh(4))


@pytest.mark.parametrize("world", [2, 4])
def test_make_mesh_and_shard_batch(port, world):
    """The ranks' layout (rank = d·sp + s), each rank's block of a batch of 8
    (its dp slice, its sp time slice), an indivisible batch left whole and
    the blocks gathered back; the mesh refused with more or fewer ranks
    than dp·sp, as JAX's make_mesh refuses too few devices
    (tests/test_parallel.py)."""
    from ddim_audio_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ddim_audio_tpu.utils.namespace import dict2namespace

    _, res2, res4 = port
    results = res2 if world == 2 else res4
    dp, sp = (1, 2) if world == 2 else (1, 4)
    x = np.arange(8 * 2 * 8 * 3, dtype=np.float32).reshape(8, 2, 8, 3)
    for rank, res in enumerate(results):
        h = res["helpers"]
        assert h["mesh"] == ({"dp": dp, "sp": sp}, rank, rank // sp, rank % sp)
        tl = 8 // sp
        np.testing.assert_array_equal(
            h["shard"], x[:, :, (rank % sp) * tl:(rank % sp + 1) * tl])
        assert h["odd_batch"] == (7, 2, tl, 3)
        assert h["gather_equal"]
        assert h[f"refuse_{world}x2"] == (f"mesh dp×sp = {world}×2 needs "
                                          f"{2 * world} devices, have {world}")
        assert h[f"refuse_{2 * world}x1"].startswith(
            f"mesh dp×sp = {2 * world}×1 needs")
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        jax_make_mesh(dict2namespace({"dp": 16, "sp": 1}))


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_helpers(port, world):
    """host_batch_slice: each rank its contiguous share of the global batch
    (JAX's: tests/test_parallel.py::test_multihost_helpers); the global batch
    gathered from the ranks' shards in rank order."""
    _, res2, res4 = port
    results = res2 if world == 2 else res4
    per = 8 // world
    shards = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
              for r in range(world)]
    for rank, res in enumerate(results):
        h = res["helpers"]
        assert h["slice"] == slice(rank * per, (rank + 1) * per)
        assert "not divisible" in h["slice_error"]
        np.testing.assert_array_equal(h["global"], np.concatenate(shards))


def test_sp_forward_bf16_int8_taps(port):
    """The production knobs on an sp mesh: bf16 with int8 taps at a width
    that takes them (C = 32), act_store set (ignored on sp meshes, as in the
    JAX package): finite, and within 25 dB SNR of the single-device flat
    forward of the same config on the same twins (the int8 quantisation
    tiles fall differently on a haloed block, and the pad row and the skip
    adds round in bf16: an SNR, not bits)."""
    from ddim_audio_tpu_torch.models.unet import (apply_model_flat_io,
                                                  flat_io_adapters,
                                                  prepare_params)

    params, res2, _ = port
    cfg = workers._tiny_cfg(**PROD)
    to_flat, from_flat = flat_io_adapters(cfg)
    ref = from_flat(apply_model_flat_io(
        prepare_params(workers._tensors(params["c32"]), cfg),
        to_flat(torch.from_numpy(X2)).contiguous(), torch.from_numpy(T2),
        cfg)).numpy().astype(np.float64)
    for res in res2:
        got = res["sp2_prod"]
        assert np.isfinite(got).all()
        snr = 10 * np.log10(np.mean(ref ** 2) / np.mean((got - ref) ** 2))
        assert snr > 25.0, snr


def test_initialize_one_rank(tmp_path, monkeypatch):
    """``multihost.initialize`` with an explicit rendezvous (the JAX
    package's ``initialize(coordinator, num_processes, process_id)``): gloo
    for the CPU device it returns; in a one-rank world ``make_mesh`` is
    None at 1 × 1 and refuses 2 × 1, ``host_batch_slice`` is the whole
    batch and the gathered batch is the rank's own; ``finalize`` leaves the
    group. ``launched`` reads the launcher's ``WORLD_SIZE``."""
    from ddim_audio_tpu_torch.parallel import multihost
    from ddim_audio_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("WORLD_SIZE", "2")
    assert multihost.launched()
    monkeypatch.delenv("WORLD_SIZE")
    assert not multihost.launched()
    device = multihost.initialize("file://" + str(tmp_path / "rdzv"), 1, 0,
                                  device="cpu")
    try:
        assert device == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert make_mesh(workers._ns(dp=1, sp=1)) is None
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(workers._ns(dp=2, sp=1))
        assert multihost.host_batch_slice(8) == slice(0, 8)
        shard = np.arange(24, dtype=np.float32).reshape(8, 3)
        np.testing.assert_array_equal(
            multihost.global_array_from_host_shards(None, shard, 8).numpy(),
            shard)
    finally:
        multihost.finalize()
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("local_rank", ["0", "1"])
def test_initialize_refuses_without_a_card(monkeypatch, local_rank):
    """Without a GPU, ``initialize`` asked for no device picks
    ``cuda:LOCAL_RANK`` and raises before it joins a group: the CPU runs
    only when the caller names it."""
    from ddim_audio_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", local_rank)
    with pytest.raises(RuntimeError, match=f"cuda:{local_rank} requested but "
                       "no CUDA GPU"):
        multihost.initialize()
    assert not torch.distributed.is_initialized()


def test_cli_under_a_launcher_refuses_without_a_card(monkeypatch):
    """The command line under a launcher, ``--device`` left at its default
    ``cuda``, raises on a machine without a GPU instead of joining a gloo
    group on the CPU."""
    from ddim_audio_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0"), ("MASTER_ADDR", "localhost"),
                        ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        cli.main(["--config", "audio.yml", "--doc", "none", "--ni",
                  "--sample"])
    assert not torch.distributed.is_initialized()
