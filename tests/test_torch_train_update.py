"""The train step's one-pass update (``training.train_step.update_fused``
over ``ops.train_update``) against the per-leaf route (``update_plain``).

On the CPU the kernel cannot run, so its four launches are replaced by
``KernelModel``, a numpy model of ``csrc/train_update.cu`` on the tensors'
memory: the same chunks (here of 8 elements, so that leaves span chunks) and
the same fp32 operation for each element. The host side runs as on the
card: tags, tables, pointers, scalars, flat outputs and their views, the
state's structure. With the clip not engaged it equals the per-leaf route
bit for bit. On the card (``gpu``, no JAX imported: ``python -m pytest
--noconftest tests/test_torch_train_update.py -m gpu``) the kernel itself is
held to the per-leaf route at audio.yml's whole tree."""

import ctypes
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ddim_audio_tpu_torch import checkpoint
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.ops import _cuda, train_update as tu
from ddim_audio_tpu_torch.training import optim
from ddim_audio_tpu_torch.training.ema import ema_update
from ddim_audio_tpu_torch.training.train_step import (TrainState,
                                                      fused_route,
                                                      init_train_state,
                                                      update_fused,
                                                      update_plain)
from ddim_audio_tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths
from ddim_audio_tpu_torch.weights import flatten_train_state

torch.set_num_threads(2)
CONFIG = "configs/audio_tiny.yml"
MU = 0.9999


# ------------------------------------------------ the kernel's model ----

def _floats(addr, n):
    n = int(n)
    return np.ctypeslib.as_array((ctypes.c_float * n).from_address(
        int(addr))) if n else np.zeros(0, np.float32)


def _ints(addr, rows):
    return np.ctypeslib.as_array(
        (ctypes.c_int32 * (4 * rows)).from_address(addr)).reshape(
            rows, 4).astype(np.int64)


def _ptrs(addr, n):
    return np.ctypeslib.as_array((ctypes.c_uint64 * n).from_address(addr))


class KernelModel:
    """The launches of ``csrc/train_update.cu`` in numpy over CPU memory,
    called as the wrapper calls the library: chunks, partials and every
    element's fp32 operations as the kernel has them (numpy rounds each
    float32 operation once, with no contraction)."""

    def __init__(self, chunk=8):
        self.chunk = chunk

    def ddim_train_update_limits(self, out):
        arr = (ctypes.c_int * 5).from_address(out)
        arr[:] = [tu.MAX_LEAVES, self.chunk, tu.MAX_GROUPS, tu.MAX_CLIPS,
                  ctypes.sizeof(tu._Config)]
        return 0

    def ddim_train_update_norm(self, grads, n_leaves, chunks, n_chunks, cfg,
                               partials, stream):
        cfg, g_ptr = tu._Config.from_address(cfg), _ptrs(grads, n_leaves)
        out = _floats(partials, n_chunks)
        for c, (leaf, start, n, _) in enumerate(_ints(chunks, n_chunks)):
            g = _floats(int(g_ptr[leaf]) + 4 * start, n)
            if cfg.divide:
                g = g * np.float32(cfg.inv_count)
            out[c] = np.sum(g * g, dtype=np.float32)
        return 0

    def ddim_train_update_norm_finish(self, partials, chunks, meta, n_chunks,
                                      cfg, norms, stream):
        cfg = tu._Config.from_address(cfg)
        parts, ch = _floats(partials, n_chunks), _ints(chunks, n_chunks)
        clip_of = _ints(meta, int(ch[:, 0].max()) + 1)[:, 1]
        out = _floats(norms, cfg.n_clips + 1)
        tot = [np.float32(parts[clip_of[ch[:, 0]] == k].sum(dtype=np.float32))
               for k in range(cfg.n_clips)]
        out[:cfg.n_clips] = np.sqrt(np.array(tot, np.float32))
        out[cfg.n_clips] = np.sqrt(np.sum(tot, dtype=np.float32))
        return 0

    def ddim_train_update_apply(self, ptrs, n_leaves, chunks, n_chunks, meta,
                                cfg, p_out, m_out, v_out, e_out, norms,
                                partials, stream):
        cfg = tu._Config.from_address(cfg)
        table = _ptrs(ptrs, 5 * n_leaves).reshape(5, n_leaves)
        ch = _ints(chunks, n_chunks)
        meta = _ints(meta, n_leaves)
        f32 = np.float32
        out = _floats(partials, n_chunks)
        for c, (leaf, start, n, ostart) in enumerate(ch):
            grp, clip_k = meta[leaf][:2]
            r = cfg.rules[grp]
            neg_lr, lr_wd, bc1, bc2 = (
                f32(ctypes.c_float.from_address(r.dev[j]).value) if r.dev[j]
                else f32(r.host[j]) for j in range(4))
            col = table[:, leaf]
            g, p, m, v = (_floats(int(a) + 4 * start, n) for a in col[:4])
            e = _floats(int(col[4]) + 4 * start, n) if cfg.has_ema else None
            po, mo, vo = (_floats(a + 4 * ostart, n)
                          for a in (p_out, m_out, v_out))
            eo = _floats(e_out + 4 * ostart, n) if cfg.has_ema else None
            if cfg.divide:
                g = g * f32(cfg.inv_count)
            if cfg.clip_on[clip_k]:
                norm = _floats(norms, clip_k + 1)[clip_k]
                if not norm < f32(cfg.clip_max[clip_k]):
                    g = (g / norm) * f32(cfg.clip_max[clip_k])
            if r.kind == 0:
                mn = f32(r.b1) * m + f32(r.omb1) * g
                d = g - mn
                vn = (f32(r.b2) * v + f32(r.omb2) * (d * d)) + f32(r.eps)
            else:
                if r.decay == 1:
                    g = g + f32(r.wd) * p
                mn = f32(r.omb1) * g + f32(r.b1) * m
                vn = f32(r.omb2) * (g * g) + f32(r.b2) * v
            mo[:], vo[:] = mn, vn
            x = (mn / bc1) / (np.sqrt(vn / bc2) + f32(r.eps))
            if r.kind == 0:
                u = neg_lr * x
                if r.decay:
                    u = u - lr_wd * p
            else:
                if r.decay == 2:
                    x = x + f32(r.wd) * p
                u = neg_lr * x
            out[c] = np.sum(u * u, dtype=np.float32)
            po[:] = p + u
            if cfg.has_ema:
                eo[:] = f32(cfg.ema_keep) * po + f32(cfg.ema_rate) * e
        return 0

    def ddim_train_update_finish(self, partials, meta, n_leaves, cfg,
                                 leaf_norms, update_norms, stream):
        cfg = tu._Config.from_address(cfg)
        meta = _ints(meta, n_leaves)
        parts = _floats(partials, int(meta[:, 3].max()))
        norms = np.array([np.sqrt(parts[z:w].sum(dtype=np.float32))
                          for _, _, z, w in meta], np.float32)
        _floats(leaf_norms, n_leaves)[:] = norms
        out = _floats(update_norms, cfg.n_groups)
        for grp in range(cfg.n_groups):
            if cfg.rules[grp].kind == 0:
                mine = norms[meta[:, 0] == grp]
                out[grp] = np.sum(mine, dtype=np.float32) / np.float32(
                    len(mine))
        return 0


@pytest.fixture
def model_lib(monkeypatch):
    """The wrapper's launches go to ``KernelModel`` on the CPU."""
    lib = KernelModel()
    monkeypatch.setattr(tu, "kernels", lambda: lib)
    monkeypatch.setattr(tu, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _NoDevice())
    return lib


class _NoDevice:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


# -------------------------------------------------------- the trees ----

def _params(rng):
    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    # sizes off multiples of 4 and of the 8-element chunks
    return {"transformer": {"dense": {"w": leaf(6, 5), "b": leaf(5)},
                            "out": {"w": leaf(3, 7)}},
            "temb": {"w": leaf(7, 3), "b": leaf(3)},
            "down_modules": {"stages": [{"conv": {"w": leaf(3, 3, 2, 4)}},
                                        {"norm": {"g": leaf(4)}}]},
            "head": {"w": leaf(1)}}


def _config(variant):
    """audio_tiny.yml's optimization (AdamW transformer, AdaBelief default,
    both clipped at norm 1), changed by ``variant``."""
    opt = load_config(CONFIG).optimization
    if variant == "adabelief_const_lr":
        opt.optimizer.default.warmup = None
    elif variant == "adam_l2_const_lr":
        opt.optimizer.transformer.optimizer = "Adam"
        opt.optimizer.transformer.warmup = None
    elif variant == "no_clip_no_decay":
        opt.grad_norm.default.grad_clip = None
        opt.optimizer.default.weight_decay = 0.0
    return opt


def _grads(params, rng, scale, count):
    return [torch.from_numpy((scale * count * rng.standard_normal(
        tuple(p.shape))).astype(np.float32)) for p in tree_leaves(params)]


def _per_leaf(tx, grads, params, opt_state, ema, count):
    """Today's per-leaf update, written out: the reference of
    ``update_plain``."""
    if count > 1:
        grads = [g / count for g in grads]
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    updates, opt_state = tx.update(grads, opt_state, params)
    new = optim.apply_updates(params, updates)
    return (new, opt_state, ema_update(ema, new, MU) if ema is not None
            else None, optim.global_norm(grads))


def _clone(tree):
    return tree_map(lambda t: t.clone(), tree)


def _equal_trees(a, b, norms=True):
    """Every leaf bit-equal; ``norms`` False leaves out AdaBelief's
    ``update_norm``, a sum in another order (held within 1e-6 apart)."""
    pa, pb = tree_paths(a), tree_paths(b)
    assert pa.keys() == pb.keys()
    return all(pa[k] is pb[k] is None or torch.equal(pa[k], pb[k])
               for k in pa if norms or not k.endswith("['update_norm']"))


def _within(got, ref, before):
    """Each entry within 1e-4 of its leaf's largest reference move plus one
    fp32 unit of its reference value (chip_smoke's ``_move_gaps``)."""
    g, r, b = tree_paths(got), tree_paths(ref), tree_paths(before)
    assert g.keys() == r.keys()
    for k in r:
        move = (r[k].double() - b[k].double()).abs().max()
        unit = torch.from_numpy(np.asarray(np.spacing(np.abs(r[k].numpy()))))
        gap = (g[k].double() - r[k].double()).abs()
        assert bool((gap <= 1e-4 * move + unit.double()).all()), k


# ------------------------------------------------------------ tests ----

@pytest.mark.parametrize("case,fused", [
    ("audio", True), ("audio_tiny", True), ("clip_step", False),
    ("adam_l2", True), ("amsgrad", False), ("adamw_amsgrad", False),
    ("rmsprop", False), ("sgd", False), ("clip_step_l1", False),
    ("bf16", False), ("cpu", False), ("twin_route", False),
    ("many_leaves", False)])
def test_fused_dispatch(case, fused, monkeypatch):
    """The route follows what the step can see: the chains' links (the
    groups' rules), the leaves' device and type and their number;
    audio.yml's AdamW and AdaBelief groups take the kernel; amsgrad,
    RMSProp, SGD, AdaBelief's clip_step (under any norm), bf16 leaves, CPU
    leaves, ``twin_route`` and a tree of more than MAX_LEAVES leaves do
    not."""
    config = load_config("configs/audio.yml" if case == "audio" else CONFIG)
    opt = config.optimization
    default, transformer = opt.optimizer.default, opt.optimizer.transformer
    if case == "clip_step":
        default.clip_step = 0.01
    elif case == "adam_l2":
        transformer.optimizer = "Adam"
    elif case == "amsgrad":
        default.amsgrad = True
    elif case == "adamw_amsgrad":
        transformer.amsgrad = True
    elif case in ("rmsprop", "sgd"):
        default.optimizer = case.replace("rmsprop", "RMSProp").replace(
            "sgd", "SGD")
    elif case == "clip_step_l1":
        default.clip_step, default.norm_ord = 0.01, 1
    params = _params(np.random.default_rng(0))
    tx = optim.build_optimizer(opt, params)
    assert (tx.update_rules() is not None) == (case not in (
        "amsgrad", "adamw_amsgrad", "rmsprop", "sgd", "clip_step",
        "clip_step_l1"))

    # stand-ins for the card's tensors: device and type are all it reads
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    on_card = SimpleNamespace(is_cuda=case != "cpu", dtype=dtype,
                              device=torch.device("cpu"))
    monkeypatch.setattr(tu, "use_twin", lambda t: case in ("cpu",
                                                           "twin_route"))
    tree = tree_map(lambda _: on_card, params)
    if case == "many_leaves":
        tree = {"head": [on_card] * (tu.MAX_LEAVES + 1)}
    assert fused_route(tx, tree_leaves(tree), tree, tree) == fused
    # and on the CPU's own tensors the per-leaf route always
    assert not fused_route(tx, tree_leaves(params), params, params)


@pytest.mark.parametrize("variant,count,scale", [
    ("audio_tiny", 1, 1e-3), ("audio_tiny", 2, 1e-3),
    ("audio_tiny", 1, 10.0), ("audio_tiny", 2, 10.0),
    ("adabelief_const_lr", 1, 1e-3), ("adam_l2_const_lr", 1, 1e-3),
    ("no_clip_no_decay", 2, 10.0), ("no_ema", 1, 1e-3)])
def test_fused_host_path_matches_per_leaf(model_lib, variant, count, scale):
    """Three steps through ``update_fused`` (its launches in
    ``KernelModel``) and through ``update_plain`` from the same state and
    gradient sums over ``count`` microbatches: with the clip not engaged
    (norm under 1) every parameter, moment, count and average leaf
    bit-equal; with it engaged (scale 10), each entry within 1e-4 of its
    leaf's move plus one fp32 unit; ``grad_norm`` and ``update_norm`` within
    1e-6; 4 launches a step. ``update_plain`` equals the per-leaf code
    written out."""
    _three_steps(torch.device("cpu"), variant, count, scale)


def _three_steps(device, variant, count, scale):
    rng = np.random.default_rng(len(variant) + count)
    params = tree_map(lambda t: t.to(device), _params(rng))
    use_ema = variant != "no_ema"
    state, tx = init_train_state(params, _config(variant), use_ema=use_ema)
    fused = plain = (state.params, state.opt_state, state.ema)
    exact = scale < 1
    before = tu.train_update.launches
    for step in range(3):
        grads = [g.to(device) for g in _grads(params, rng, scale, count)]
        f = update_fused(tx, grads, *fused, MU, count)
        p = update_plain(tx, grads, *plain, MU, count)
        ref = _per_leaf(tx, grads, *plain, count)
        assert _equal_trees(p[:3], ref[:3]) and torch.equal(p[3], ref[3])
        assert tree_paths(f[1]).keys() == tree_paths(p[1]).keys()
        if exact:
            assert _equal_trees(f[:3], p[:3], norms=False), step
        else:
            for got, want, old in zip(f[:3], p[:3], plain):
                if want is not None:
                    _within(*(tree_map(lambda t: t.cpu(), x)
                              for x in (got, want, old)))
        np.testing.assert_allclose(float(f[3]), float(p[3]), rtol=1e-6)
        np.testing.assert_allclose(float(f[1]["default"]["update_norm"]),
                                   float(p[1]["default"]["update_norm"]),
                                   rtol=1e-6)
        fused, plain = f[:3], p[:3]
    assert tu.train_update.launches == before + 3 * 4


@pytest.mark.parametrize("count", [1, 2])
def test_fused_update_leaves_its_input_untouched(model_lib, count):
    """The step is functional: the state it was given (parameters, every
    moment and count, the average) and the gradients read the same after
    it; its outputs share no memory with them."""
    rng = np.random.default_rng(7)
    params = _params(rng)
    state, tx = init_train_state(params, _config("audio_tiny"), use_ema=True)
    grads = _grads(params, rng, 10.0, count)
    given = (state.params, state.opt_state, state.ema, grads)
    kept = _clone(given)
    out = update_fused(tx, grads, state.params, state.opt_state, state.ema,
                       MU, count)
    assert _equal_trees(given, kept)
    mine = {t.untyped_storage().data_ptr() for t in tree_leaves(given)}
    assert not mine & {t.untyped_storage().data_ptr()
                       for t in tree_leaves(list(out))}


def test_fused_state_structure_and_checkpoint_round_trip(model_lib,
                                                         tmp_path):
    """After fused steps the TrainState has the per-leaf route's tree
    structure, keys, shapes and dtypes (leaves are views into flat buffers),
    and a checkpoint of it loads back into a fresh template leaf for leaf."""
    rng = np.random.default_rng(11)
    params = _params(rng)
    opt = _config("audio_tiny")
    state, tx = init_train_state(params, opt, use_ema=True)
    fused = plain = (state.params, state.opt_state, state.ema)
    for _ in range(2):
        grads = _grads(params, rng, 1e-3, 1)
        fused = update_fused(tx, grads, *fused, MU, 1)[:3]
        plain = update_plain(tx, grads, *plain, MU, 1)[:3]
    got = TrainState(*fused, step=torch.tensor(2, dtype=torch.int32))
    want = TrainState(*plain, step=torch.tensor(2, dtype=torch.int32))
    a, b = flatten_train_state(got), flatten_train_state(want)
    assert list(a) == list(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    path = checkpoint.save_checkpoint(str(tmp_path), got, step=2)
    template, _ = init_train_state(_params(np.random.default_rng(0)), opt,
                                   use_ema=True)
    loaded, meta = checkpoint.load_checkpoint(path, template)
    assert meta["step"] == 2
    c = flatten_train_state(loaded)
    assert list(c) == list(a)
    for k in a:
        np.testing.assert_array_equal(c[k], a[k], err_msg=k)


def test_kernel_signatures_are_registered():
    """Every ``extern "C"`` function of ``csrc/train_update.cu`` is in
    ``_cuda._SIGNATURES``, a pointer for each pointer parameter and an int
    for each int, as ctypes must pass them."""
    src = (Path(_cuda.CSRC) / "train_update.cu").read_text()
    body = src[src.index('extern "C"'):]
    found = re.findall(r"^int (ddim_train_update_\w+)\(([^)]*)\)", body,
                       re.M)
    assert {name for name, _ in found} == {
        "ddim_train_update_limits", "ddim_train_update_norm",
        "ddim_train_update_norm_finish", "ddim_train_update_apply",
        "ddim_train_update_finish"}
    for name, params in found:
        kinds = tuple(_cuda._P if "*" in p else _cuda._I
                      for p in " ".join(params.split()).split(","))
        assert _cuda._SIGNATURES[name] == kinds, name


# --------------------------------------------------- on the card (gpu) ----

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant,count,scale", [
    ("audio_tiny", 2, 1e-3), ("audio_tiny", 1, 10.0),
    ("adabelief_const_lr", 1, 1e-3), ("adam_l2_const_lr", 1, 1e-3),
    ("no_clip_no_decay", 2, 10.0), ("no_ema", 1, 1e-3)])
def test_fused_variants_on_gpu(cuda, variant, count, scale):
    """The CPU model's cases through the kernel on the small tree: leaves of
    1-72 entries (the kernel's scalar tails, 16-byte steps where they
    fit), Adam's L2 and constant learning rates (host scalars), no clip,
    no average; 4 launches a step."""
    _three_steps(cuda, variant, count, scale)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["unclipped", "clipped", "grad_accum2"])
def test_fused_update_on_gpu(cuda, case):
    """Three steps of audio.yml's optimizer at its whole tree (388 leaves,
    47,155,266 parameters) in the kernel and leaf by leaf on the same
    gradients: with the clip not engaged (norm under 1) every leaf of
    parameters, moments and average bit-equal; with it engaged, and with
    grad_accum 2 (engaged too), each entry within 1e-4 of its leaf's move
    plus one fp32 unit; ``grad_norm`` and ``update_norm_default`` within
    1e-6; 4 launches a step; the given state untouched."""
    from ddim_audio_tpu_torch.models.unet import ModelConfig, init_model

    config = load_config("configs/audio.yml")
    cfg = ModelConfig.from_config(config)
    params = init_model(torch.Generator().manual_seed(0), cfg, device=cuda)
    state, tx = init_train_state(params, config.optimization, use_ema=True)
    leaves = tree_leaves(params)
    assert len(leaves) == 388
    assert sum(p.numel() for p in leaves) == 47_155_266
    count = 2 if case == "grad_accum2" else 1
    # the norm of N(0, s²) over 47.2M entries is ~6,867·s
    scale = {"unclipped": 1e-5, "clipped": 1e-3, "grad_accum2": 1e-3}[case]
    gen = torch.Generator(cuda).manual_seed(5)
    fused = plain = (state.params, state.opt_state, state.ema)
    kept = _clone(fused)
    for step in range(3):
        grads = [count * scale * torch.randn(p.shape, generator=gen,
                                             device=cuda) for p in leaves]
        before = tu.train_update.launches
        f = update_fused(tx, grads, *fused, MU, count)
        assert tu.train_update.launches == before + 4
        p = update_plain(tx, grads, *plain, MU, count)
        torch.cuda.synchronize()
        if step == 0:
            assert _equal_trees(fused, kept)
        assert tree_paths(f[1]).keys() == tree_paths(p[1]).keys()
        if case == "unclipped":
            assert float(p[3]) < 1.0
            assert _equal_trees(f[:3], p[:3], norms=False), step
        else:
            assert float(p[3]) >= 1.0
            for got, want, old in zip(f[:3], p[:3], plain):
                _within(tree_map(lambda t: t.cpu(), got),
                        tree_map(lambda t: t.cpu(), want),
                        tree_map(lambda t: t.cpu(), old))
        np.testing.assert_allclose(float(f[3]), float(p[3]), rtol=1e-6)
        np.testing.assert_allclose(float(f[1]["default"]["update_norm"]),
                                   float(p[1]["default"]["update_norm"]),
                                   rtol=1e-6)
        fused, plain = f[:3], p[:3]
