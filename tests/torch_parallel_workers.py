"""Rank bodies of the port's parallel tests (``tests/test_torch_parallel_*``),
run by ``tests/torch_dist.run_ranks`` in gloo processes on the CPU. They
import no JAX; the tests hold what they save against the JAX package."""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch

from tests.torch_dist import save

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "configs", "audio_tiny.yml")


def _ns(**kw):
    from ddim_audio_tpu_torch.utils.namespace import dict2namespace

    return dict2namespace(kw)


def _tiny_cfg(**kw):
    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.models.unet import ModelConfig

    return dataclasses.replace(ModelConfig.from_config(load_config(TINY)),
                               **kw)


def _tensors(tree):
    from ddim_audio_tpu_torch.weights import params_from_jax

    return params_from_jax(tree, device="cpu")


def tiny_params():
    """The tiny model's params (torch, CPU) with non-zero final GroupNorm
    weights 1 ± 0.2 (seed 3): zero-init GN3 makes every resblock the
    identity and would hide a fault of the blocks."""
    from ddim_audio_tpu_torch.models.unet import init_model

    tree = init_model(torch.Generator().manual_seed(0), _tiny_cfg(),
                      device="cpu")
    rng = np.random.default_rng(3)
    for mod in ("down_modules", "up_modules"):
        for stage in tree[mod]["stages"]:
            for block in stage["blocks"]:
                g = block["norm3"]["g"]
                g.copy_(torch.from_numpy(
                    1 + 0.2 * rng.standard_normal(g.shape[0]).astype(np.float32)))
    return tree


# --------------------------------------------------------------- sp forward

def sp_forward(rank, world, out_dir, params_np, cases):
    """cases: [(name, dp, sp, x, t, cfg overrides, params key)] run through
    ``apply_model_sp`` on meshes of this world; plus the mesh helpers'
    answers. Saves {name: output} and the helpers' results."""
    from ddim_audio_tpu_torch.parallel import multihost
    from ddim_audio_tpu_torch.parallel.mesh import (gather_batch, make_mesh,
                                                    shard_batch)
    from ddim_audio_tpu_torch.parallel.sp import apply_model_sp

    params = {k: _tensors(v) for k, v in params_np.items()}
    meshes = {}
    res = {}
    for name, dp, sp, x, t, over, pkey in cases:
        if (dp, sp) not in meshes:
            meshes[(dp, sp)] = make_mesh(_ns(dp=dp, sp=sp))
        mesh = meshes[(dp, sp)]
        try:
            res[name] = apply_model_sp(params[pkey], torch.from_numpy(x),
                                       torch.from_numpy(t), _tiny_cfg(**over),
                                       mesh).numpy()
        except ValueError as e:
            res[name] = f"ValueError: {e}"
    mesh = next(iter(meshes.values()))
    x = torch.arange(8 * 2 * 8 * 3, dtype=torch.float32).reshape(8, 2, 8, 3)
    xs = shard_batch(mesh, x, time_axis=2)
    res["helpers"] = {
        "mesh": (mesh.shape, mesh.rank, mesh.dp_index, mesh.sp_index),
        "shard": xs.numpy(),
        "odd_batch": tuple(shard_batch(mesh, x[:7], time_axis=2).shape),
        "gather_equal": bool(torch.equal(
            gather_batch(mesh, xs, x.shape, time_axis=2), x)),
        "slice": multihost.host_batch_slice(8),
        "global": multihost.global_array_from_host_shards(
            mesh, np.arange(2 * 3, dtype=np.float32).reshape(2, 3)
            + 10 * rank, 2 * world).numpy(),
    }
    try:
        multihost.host_batch_slice(8 * world + 1)
    except ValueError as e:
        res["helpers"]["slice_error"] = str(e)
    for dp, sp in ((world, 2), (2 * world, 1)):
        try:
            make_mesh(_ns(dp=dp, sp=sp))
        except ValueError as e:
            res["helpers"][f"refuse_{dp}x{sp}"] = str(e)
    save(out_dir, rank, res)


# ------------------------------------------------------------- dp sampling

def sample_runs(exp, runs, tag):
    """runs: [(label, dp, sp, method, extra)] of the runner on the checkpoint
    under exp, device cpu, each writing into its own image folder (suffix
    ``tag``): ``sample_last_only`` ("last"), ``sample_sequence`` ("seq") or
    ``sample_interpolation`` ("interp"). Returns {label: the arrays the run
    handed to ``export``, in order (every rank gets them; rank 0 alone
    writes), label + "_files": the folder's files}."""
    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.runners.diffusion_runner import Diffusion

    res = {}
    for label, dp, sp, method, extra in runs:
        config = load_config(TINY)
        config.parallel = _ns(dp=dp, sp=sp)
        config.sampling.num_samples = extra.get("num_samples", 2)
        config.sampling.buffer_dtype = "float32"  # kept states bit for bit
        folder = os.path.join(exp, f"img_{label}_{tag}")
        args = SimpleNamespace(
            seed=5, timesteps=4, skip_type="uniform", eta=0.0,
            sample_type=extra.get("sample_type", "generalized"),
            sequence=extra.get("sequence"), image_folder=folder,
            log_path=os.path.join(exp, "logs", "run"), fid=False,
            interpolation=False, use_pretrained=False)
        runner = Diffusion(args, config, device="cpu")
        exported = []
        export = runner.export

        def keep(out, names, export=export, exported=exported):
            exported.append(np.array(out))
            return export(out, names)

        runner.export = keep
        params = runner._load_eval_params()
        {"last": runner.sample_last_only, "seq": runner.sample_sequence,
         "interp": runner.sample_interpolation}[method](params)
        res[label] = exported
        res[label + "_files"] = (sorted(os.listdir(folder))
                                 if os.path.isdir(folder) else [])
    return res


def runner_sampling(rank, world, out_dir, exp, runs):
    save(out_dir, rank, sample_runs(exp, runs, f"rank{rank}"))


# ---------------------------------------------------------- dp train step

def train_steps(params_np, x0, draws, seed, *, grad_accum: int, dp: int,
                sp: int = 1, labels=("drawn", "injected")):
    """One optimizer step from the same state, on a dp × sp mesh of the
    default group (1 × 1: one process, no mesh) with ``grad_accum``: with
    the port's own draws (a generator seeded ``seed``; FNet dropout on, as
    the tiny config ships it) and with the injected (t, e) of ``draws`` and
    no generator (no dropout); ``labels`` picks among the two. An
    fp64 x0 runs the whole step in fp64 (parameters, compute, FNet), where
    a changed order of summation stays far below any tolerance. Returns
    {label: (flattened state, metrics)}."""
    from ddim_audio_tpu_torch.config import load_config
    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import ModelConfig
    from ddim_audio_tpu_torch.parallel.mesh import make_mesh
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)
    from ddim_audio_tpu_torch.utils.tree import tree_map
    from ddim_audio_tpu_torch.weights import flatten_train_state

    config = load_config(TINY)
    config.training.grad_accum = grad_accum
    cfg = ModelConfig.from_config(config)
    wide = x0.dtype == np.float64
    if wide:
        config.model.transformers.dtype = torch.float64
        cfg = dataclasses.replace(ModelConfig.from_config(config),
                                  dtype=torch.float64)
    alphas = make_schedule("linear", 1e-4, 0.02, 50).alphas_cumprod
    mesh = make_mesh(_ns(dp=dp, sp=sp))
    res = {}
    for label, override in (("drawn", None), ("injected", draws)):
        if label not in labels:
            continue
        params = _tensors(params_np)
        if wide:
            params = tree_map(lambda v: v.double(), params)
        state, tx = init_train_state(params, config.optimization,
                                     use_ema=True)
        step = make_train_step(cfg, config, alphas, tx, mesh=mesh)
        gen = None
        if override is None:
            gen = torch.Generator().manual_seed(seed)
        else:
            override = tuple(torch.from_numpy(a) for a in override)
        state, metrics = step(state, torch.from_numpy(x0), gen,
                              noise_override=override)
        res[label] = (flatten_train_state(state),
                      {k: float(v) for k, v in metrics.items()})
    return res




DP_RUNS = [("last", "last", {}),
           ("seq", "seq", {"sequence": 2}),
           ("ddpm", "last", {"sample_type": "ddpm_noisy"}),
           ("interp", "interp", {})]


def dp_sampling(rank, world, out_dir, exp):
    """The runner's sampling on dp = 2 and sp = 2 meshes of the same two
    ranks."""
    runs = [(f"dp_{label}", 2, 1, method, extra)
            for label, method, extra in DP_RUNS]
    runs += [(f"sp_{label}", 1, 2, method, extra)
             for label, method, extra in DP_RUNS]
    save(out_dir, rank, sample_runs(exp, runs, f"rank{rank}"))


def dp_train(rank, world, out_dir, params_np, x0, draws, seed):
    """One train step at dp = world, grad_accum 1."""
    save(out_dir, rank, train_steps(params_np, x0, draws, seed, grad_accum=1,
                                    dp=world))


def sp_train(rank, world, out_dir, params_np, x0, draws, seed, dp, sp,
             labels=("drawn", "injected")):
    """One train step on a dp × sp mesh of this world, grad_accum 1."""
    save(out_dir, rank, train_steps(params_np, x0, draws, seed, grad_accum=1,
                                    dp=dp, sp=sp, labels=labels))


# ------------------------------------------------- sp training collectives

def _fd_grad(part, x, mesh, *, replicated=False, eps=1e-6):
    """(autograd, central finite differences) of a global loss with respect
    to a global x [B, T, …] split over T among the sp ranks of ``mesh`` (all
    the ranks): ``part(x_r)`` is rank r's share of the loss (the shares add up to
    it) or, ``replicated``, the whole loss on every rank. The autograd side
    is each rank's gradient of its own share, gathered along T."""
    import torch.distributed as dist

    from ddim_audio_tpu_torch.parallel.mesh import all_gather_cat

    rank, t = mesh.sp_index, x.shape[1] // mesh.sp
    mine = x[:, rank * t:(rank + 1) * t].clone().requires_grad_(True)
    grad = all_gather_cat(torch.autograd.grad(part(mine), mine)[0],
                          mesh.sp_group, 1)

    def total(xg):
        v = part(xg[:, rank * t:(rank + 1) * t]).detach().reshape(1)
        if not replicated:
            dist.all_reduce(v)
        return v

    fd = torch.zeros_like(x)
    for i in range(x.numel()):
        step = torch.zeros_like(x)
        step.view(-1)[i] = eps
        fd.view(-1)[i] = (total(x + step) - total(x - step)) / (2 * eps)
    return grad.numpy(), fd.numpy()


def sp_units(rank, world, out_dir):
    """The sp training collectives' backwards on a world of sp ranks, in
    fp64: each against central finite differences of the global loss; and
    ``gn_flat(sp_group=…)`` against the unsharded ``gn_flat``."""
    import torch.distributed as dist

    from ddim_audio_tpu_torch.ops.flat_grad import gn_flat
    from ddim_audio_tpu_torch.parallel import sp
    from ddim_audio_tpu_torch.parallel.mesh import all_gather_cat, make_mesh

    mesh = make_mesh(_ns(dp=1, sp=world))
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 4 * world, 3), generator=gen, dtype=torch.float64)
    # per-rank weights: every rank draws all of them, keeps its own
    res = {}
    for left, right in ((1, 1), (1, 2), (2, 1)):
        w = torch.randn((world, 2, 4 + left + right, 3), generator=gen,
                        dtype=torch.float64)

        def halo_part(xr, left=left, right=right, w=w):
            h = sp._halo(xr, left, right, mesh)
            return (w[rank] * h * h + w[rank].flip(1) * h).sum()

        res[f"halo_{left}_{right}"] = _fd_grad(halo_part, x, mesh)
    wp = torch.randn((2, 3), generator=gen, dtype=torch.float64)

    def psum_part(xr):
        return (wp * torch.sin(sp.psum_keep_sp((xr * xr).sum(dim=1),
                                               mesh))).sum()

    res["psum_keep_sp"] = _fd_grad(psum_part, x, mesh, replicated=True)
    wg = torch.randn((world, 2, 4 * world, 3), generator=gen,
                     dtype=torch.float64)

    def gather_part(xr):
        return (wg[rank] * torch.tanh(sp._GatherTimeT.apply(xr, mesh))).sum()

    res["gather_time"] = _fd_grad(gather_part, x, mesh)

    # gn_flat: [B, T, F·C] at F = 2, C = 16 (8 groups of 2)
    f, c = 2, 16
    xg = torch.randn((2, 4 * world, f * c), generator=gen, dtype=torch.float64)
    dy = torch.randn(xg.shape, generator=gen, dtype=torch.float64)
    pn = {"g": 1 + 0.3 * torch.randn((c,), generator=gen, dtype=torch.float64),
          "b": 0.3 * torch.randn((c,), generator=gen, dtype=torch.float64)}
    for v in pn.values():
        v.requires_grad_(True)
    t = xg.shape[1] // world
    xr = xg[:, rank * t:(rank + 1) * t].clone().requires_grad_(True)
    out = gn_flat(pn, xr, f=f, c=c, sp_group=mesh.sp_group)
    dx, dgamma, dbeta = torch.autograd.grad(
        (out * dy[:, rank * t:(rank + 1) * t]).sum(), (xr, pn["g"], pn["b"]))
    parts = torch.cat([dgamma, dbeta])
    dist.all_reduce(parts, group=mesh.sp_group)
    x1 = xg.clone().requires_grad_(True)
    out1 = gn_flat(pn, x1, f=f, c=c)
    ref = torch.autograd.grad((out1 * dy).sum(), (x1, pn["g"], pn["b"]))
    res["gn_flat"] = {
        "out": (all_gather_cat(out.detach(), mesh.sp_group, 1).numpy(),
                out1.detach().numpy()),
        "dx": (all_gather_cat(dx, mesh.sp_group, 1).numpy(),
               ref[0].numpy()),
        "dgamma_dbeta": (parts.numpy(), torch.cat(ref[1:]).numpy()),
    }
    save(out_dir, rank, res)
