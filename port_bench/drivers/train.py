"""Training window: the program's train step (``make_train_step`` over
``init_train_state``) called step after step, each on a new seed-made batch
x0 with its timesteps and noise (``noise_override``) and the step's
generator, which draws the FNet's dropout masks inside the step. The
window ends at the end of the step in progress once the run's seconds have
passed (``torch.cuda.synchronize``). ``train_samples_per_s`` is the clips
of those steps over the window's wall time.

Set-up: the program's model, optimizer state and EMA from seed-made
weights, then the first ``checked_steps`` steps through the same call and
feed (they warm every shape). With ``--trace 1`` more steps run under the
profiler after the window.

Check: the reference follows those first steps from the same weights,
batches, timesteps, noise and dropout masks. Compared: each step's loss,
the clipped gradient of the first step as the optimizer got it (its first
moment over 1 − b1) and each leaf's move over the checked steps, both by
the worst leaf's gap of norms, and the moving average's (EMA) move by the
median leaf's gap. The average moves by a ten-thousandth of the
parameters' move a step, a few float32 steps of its own value, so its
worst leaf reads one value rounded the other way (logged, with the count
of such values)."""

from __future__ import annotations

import copy
import gc
import time

import torch

from port_bench.harness.params import generator, make_params, seed_for
from port_bench.harness.trace import WINDOW, span, traced
from port_bench.harness.work import forward_flops
from port_bench.reference import check as ref_check
from port_bench.reference.model import param_spec
from port_bench.reference.train import leaves

LIMITS = ("loss_gap", "grad_gap", "move_gap", "ema_gap_median")

# The program's train step draws microbatch k's dropout masks from a
# generator seeded (initial seed of the step's generator · 1_000_003 + k + 1)
# mod 2^63 (``training.train_step.micro_generator``), in the order of the
# dropout sites, one ``torch.rand`` of the activation's shape each.
MICRO_STRIDE = 1_000_003


def _program(run):
    from ddim_audio_tpu_torch.diffusion.schedules import make_schedule
    from ddim_audio_tpu_torch.models.unet import ModelConfig
    from ddim_audio_tpu_torch.training.train_step import (init_train_state,
                                                          make_train_step)
    from ddim_audio_tpu_torch.utils.namespace import dict2namespace

    tr = run.traffic
    raw = copy.deepcopy(run.config["config"])
    raw["training"]["batch_size"] = tr["batch"]
    raw["training"]["grad_accum"] = tr["grad_accum"]
    config = dict2namespace(raw)
    d = config.diffusion
    schedule = make_schedule(d.beta_schedule, d.beta_start, d.beta_end,
                             d.num_diffusion_timesteps)
    state, tx = init_train_state(run.params, config.optimization,
                                 use_ema=bool(config.model.ema))
    step = make_train_step(ModelConfig.from_config(config), config,
                           schedule.alphas_cumprod, tx)
    return state, step


def batch(run, k: int):
    """Step k's (x0, t, e) on the card."""
    tr = run.traffic
    g = generator(run.device, run.seed, 4, k)
    shape = (tr["batch"], run.geom.channels, tr["t_size"], run.geom.f_size)
    x0 = tr["x0_scale"] * torch.randn(shape, generator=g, device=run.device)
    t = torch.randint(0, run.geom.num_timesteps, (tr["batch"],), generator=g,
                      device=run.device)
    e = torch.randn(shape, generator=g, device=run.device)
    return x0, t, e


def step_seed(run, k: int) -> int:
    return seed_for(run.seed, 5, k)


def _call(run, k: int):
    x0, t, e = batch(run, k)
    gen = torch.Generator(run.device).manual_seed(step_seed(run, k))
    run.state, metrics = run.step(run.state, x0, gen, noise_override=(t, e))
    return metrics


def dropout_masks(run, k: int) -> list:
    """The keep masks the program draws in step k (one microbatch)."""
    if run.traffic["grad_accum"] != 1:
        raise ValueError("the check follows steps of one microbatch")
    seed = (step_seed(run, k) * MICRO_STRIDE + 1) % (1 << 63)
    g = torch.Generator(run.device).manual_seed(seed)
    keep = 1.0 - run.geom.dropout
    shapes = run.geom.mask_shapes(run.batch, run.t_size)
    return [torch.rand(s, generator=g, device=run.device) < keep
            for s in shapes]


def first_gradient(run) -> dict:
    """{leaf path: the clipped gradient of the first step}, from the
    program's optimizer state after it: each group's first moment over
    1 − b1."""
    out = {}
    opt_cfg = run.config["config"]["optimization"]["optimizer"]
    for group, st in run.state.opt_state.items():
        links = st if isinstance(st, list) else [st]
        mu = next(link["mu"] for link in links if "mu" in link)
        b1 = opt_cfg[group]["beta"][0]
        out.update({k: v / (1.0 - b1) for k, v in leaves(mu).items()})
    return out


def setup(run):
    tr = run.traffic
    run.batch, run.t_size = tr["batch"], tr["t_size"]
    run.params = make_params(param_spec(run.geom), run.seed, run.device)
    run.state, run.step = _program(run)
    run.log("set-up: weights, optimizer state and step made")
    run.losses = []
    for k in range(tr["checked_steps"]):
        run.losses.append(_call(run, k)["loss"])
        if k == 0:
            run.first_grad = {path: g.clone()
                              for path, g in first_gradient(run).items()}
    run.params_after = run.state.params
    run.ema_after = run.state.ema
    run.losses = [float(v) for v in run.losses]
    run.sync()


def window(run, seconds: float) -> dict:
    tr = run.traffic
    k0 = k = tr["checked_steps"]
    t0 = time.perf_counter()
    while True:
        run.attempted += 1
        _call(run, k)
        k += 1
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    wall = time.perf_counter() - t0
    run.log(f"steps {k - k0} in {wall:.3f} s")
    run.next_step = k
    run.facts["wall_timed_s"] = wall
    run.facts["steps_timed"] = k - k0
    run.facts["flops_timed"] = 3 * forward_flops(
        run.geom, tr["batch"], tr["t_size"]) * (k - k0)
    return {"train_samples_per_s": tr["batch"] * (k - k0) / wall}


def trace(run):
    out = {}
    n = run.traffic["traced_steps"]
    with traced(out, run.device):
        with span(WINDOW):
            for i in range(n):
                with span("bench.step"):
                    _call(run, run.next_step + i)
            run.sync()
    run.trace = out["trace"]
    run.facts["steps_traced"] = n


def check(run) -> dict:
    tr = run.traffic
    n = tr["checked_steps"]
    del run.state, run.step
    gc.collect()
    torch.cuda.empty_cache()
    batches = [batch(run, k) for k in range(n)]
    masks = [dropout_masks(run, k) for k in range(n)]
    losses, grad, params, ema = ref_check.train_reference(
        run.config["config"], run.params, batches, masks,
        chunk=tr["reference_chunk"])
    p0 = leaves(run.params)
    got_move = {k: v - p0[k] for k, v in leaves(run.params_after).items()}
    ref_move = {k: v - p0[k] for k, v in params.items()}
    got_ema = {k: v - p0[k] for k, v in leaves(run.ema_after).items()}
    ref_ema = {k: v - p0[k] for k, v in ema.items()}
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(run.losses, losses))
    grad_gap, grad_leaf, n_leaves = ref_check.norm_gaps(run.first_grad, grad,
                                                        grad)
    move_gap, move_leaf, _ = ref_check.norm_gaps(got_move, ref_move, grad)
    ema_gap, ema_worst, ema_leaf = ref_check.median_gap(got_ema, ref_ema,
                                                        grad)
    flips, steps = ref_check.ulp_flips(leaves(run.ema_after), ema)
    run.log(f"losses {run.losses} vs reference {losses}; {n_leaves} leaves "
            f"compared; worst gradient leaf {grad_leaf}, worst move leaf "
            f"{move_leaf}, worst average leaf {ema_leaf} ({ema_worst}); "
            f"{flips} average values differ, by at most {steps} float32 "
            f"steps")
    lim = run.config["limits"]
    return {"loss_gap": (loss_gap, lim["loss_gap"]),
            "grad_gap": (grad_gap, lim["grad_gap"]),
            "move_gap": (move_gap, lim["move_gap"]),
            "ema_gap_median": (ema_gap, lim["ema_gap_median"])}
