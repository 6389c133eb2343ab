"""Readings that the comparison's limits are set from, at a cell's own
size: the program's number on many seeds (the harness's own set-up, one
window call and check a seed) and the control's (the reference in the
nearest lower precision than the configuration states, against the
float32 reference, on the same inputs).

    python3 -m port_bench.tests.control <cell> <program seeds> <control seeds>

prints one line a reading and a summary; the control of a sampling cell is
``reference.check.ControlOps`` (int4 where the configuration states int8,
float8 e4m3 where it states bf16, TF32 where it states float32), of a
training cell the reference in TF32 (it states float32)."""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from port_bench.harness.cell import Run
from port_bench.harness.registry import Registry
from port_bench.reference import check as ref_check
from port_bench.reference.train import leaves

SEED0 = 7_000_000_000


def program_reading(registry, cell: str, seed: int, device="cuda") -> dict:
    run = Run(registry, registry.cell(cell), seed, device)
    driver = registry.driver(run.traffic["driver"])
    driver.setup(run)
    driver.window(run, 0.0)
    out = {k: v for k, (v, _) in driver.check(run).items()}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def control_reading(registry, cell: str, seed: int, device="cuda") -> dict:
    """The control against the float32 reference on the inputs of ``seed``
    (the cell's first chain, or its checked steps); a driver that has a
    ``control(run)`` of its own reads it."""
    run = Run(registry, registry.cell(cell), seed, device)
    driver = registry.driver(run.traffic["driver"])
    if hasattr(driver, "control"):
        return driver.control(run)
    tr, conf = run.traffic, run.config["config"]
    from port_bench.harness.params import make_params, sampling_params
    from port_bench.reference.model import param_spec

    if run.mode == "sample":
        params = sampling_params(param_spec(run.geom), seed, device)
        x = driver.start_noise(run, 0)[:tr["check_clips"]]
        ref = ref_check.sample_clips(conf, params, x, tr["timesteps"])
        low = ref_check.sample_clips(
            conf, params, x, tr["timesteps"],
            ops=ref_check.ControlOps(run.config["declared"]), tf32=True)
        compared, logged = ref_check.clip_errors(low.cpu(), ref.cpu())
        return {**compared, **logged}
    params = make_params(param_spec(run.geom), seed, device)
    run.batch, run.t_size = tr["batch"], tr["t_size"]
    n = tr["checked_steps"]
    batches = [driver.batch(run, k) for k in range(n)]
    masks = [driver.dropout_masks(run, k) for k in range(n)]
    kw = dict(chunk=tr["reference_chunk"])
    l_ref, g_ref, p_ref, e_ref = ref_check.train_reference(
        conf, params, batches, masks, **kw)
    l_low, g_low, p_low, e_low = ref_check.train_reference(
        conf, params, batches, masks, tf32=True, **kw)
    p0 = leaves(params)
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l_low, l_ref)),
        "grad_gap": ref_check.norm_gaps(g_low, g_ref, g_ref)[0],
        "move_gap": ref_check.norm_gaps(
            {k: v - p0[k] for k, v in p_low.items()},
            {k: v - p0[k] for k, v in p_ref.items()}, g_ref)[0],
        "ema_gap_median": ref_check.median_gap(
            {k: v - p0[k] for k, v in e_low.items()},
            {k: v - p0[k] for k, v in e_ref.items()}, g_ref)[0]}


def half_batch_reading(registry, cell: str, seed: int, device="cuda") -> dict:
    """The program's numbers with a fault planted in its train step: the
    loss (and so the gradient) taken over the first half of the batch."""
    from ddim_audio_tpu_torch.training import losses

    real = losses.loss_registry["simple"]

    def half(apply_fn, params, x0, t, e, alphas, **kw):
        n = x0.shape[0] // 2
        return real(apply_fn, params, x0[:n], t[:n], e[:n], alphas, **kw)

    losses.loss_registry["simple"] = half
    try:
        return program_reading(registry, cell, seed, device)
    finally:
        losses.loss_registry["simple"] = real


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell")
    ap.add_argument("program_seeds", type=int)
    ap.add_argument("control_seeds", type=int)
    ap.add_argument("--fault_seeds", type=int, default=0,
                    help="seeds of the half-batch fault (training cells)")
    ap.add_argument("--seed0", type=int, default=SEED0,
                    help="the first seed; kind k's i-th is seed0 + 1000 i + k")
    ap.add_argument("--also", type=int, nargs="*", default=[],
                    help="further seeds of program readings")
    args = ap.parse_args(argv)
    reg = Registry()
    for kind, n, fn in (("program", args.program_seeds, program_reading),
                        ("control", args.control_seeds, control_reading),
                        ("half_batch", args.fault_seeds, half_batch_reading)):
        readings = []
        seeds = [args.seed0 + 1000 * i + {"program": 0, "control": 500,
                                          "half_batch": 700}[kind]
                 for i in range(n)]
        if kind == "program":
            seeds += args.also
        for seed in seeds:
            r = fn(reg, args.cell, seed)
            readings.append(r)
            print(json.dumps({"cell": args.cell, "kind": kind, "seed": seed,
                              **r}), flush=True)
        if readings:
            print(json.dumps({"cell": args.cell, "kind": kind,
                              "n": len(seeds), **{
                k: [min(r[k] for r in readings), max(r[k] for r in readings)]
                for k in readings[0]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
