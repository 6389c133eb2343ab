"""One run of one cell: set-up, the timed window, the traced window, the
check against the reference, and the result line."""

from __future__ import annotations

import functools
import os
import sys
import tempfile

import torch

# Top-level module names that a run must not have loaded: JAX and the JAX
# package this program was ported from (whole names: the program's own name
# begins with the latter's).
FORBIDDEN = ("jax", "jaxlib", "flax", "ddim_audio_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc; the interpreter's
    own start-up included)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a driver reads and fills for one run. Nothing here but the lazy
    ``geom`` is of one model: a driver reads its configuration's tree
    (``config["config"]``) as it needs."""

    def __init__(self, registry, cell: dict, seed: int, device):
        self.registry = registry
        self.seed = int(seed)
        self.device = torch.device(device)
        self.config = registry.config(cell["config"])
        self.traffic = registry.traffic(cell["traffic"])
        self.mode = self.traffic["driver"]
        self.tmp = tempfile.gettempdir()
        self.attempted = 0
        self.facts = {}
        self.trace = None

    @functools.cached_property
    def geom(self):
        """The U-Net + FNet's geometry (``reference.model.Geometry``), built
        on first access: the drivers, readers and kernel families of that
        model read it; a driver of another model never does."""
        from port_bench.reference.model import Geometry

        return Geometry.from_config(self.config["config"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, msg: str) -> None:
        print(f"[port_bench {process_age_s():.1f} s] {msg}", file=sys.stderr,
              flush=True)


def execute(registry, cell_name: str, seed: int, seconds: float,
            trace: bool, device="cuda") -> tuple:
    """(result, checks): the result line's object and the compared numbers
    {name: (value, limit)}."""
    cell = registry.cell(cell_name)
    run = Run(registry, cell, seed, device)
    driver = registry.driver(run.traffic["driver"])
    on_card = run.device.type == "cuda"
    run.log("set-up: imports done")
    driver.setup(run)
    setup_s = process_age_s()
    run.log(f"set-up {setup_s:.2f} s")
    e2e = driver.window(run, seconds)
    e2e["setup_s"] = setup_s
    if trace:
        driver.trace(run)
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0
    checks = driver.check(run)
    correct = all(v <= lim for v, lim in checks.values())

    if trace:
        group = registry.metrics_of(cell_name, "per_layer")
        values = {m["name"]: registry.metric(m["name"]).read(run)
                  for m in group}
    else:
        group = registry.metrics_of(cell_name, "end_to_end")
        values = {m["name"]: e2e.get(m["name"]) for m in group}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in group if values[m["name"]] is not None}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(run.device) if on_card
                    else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    # a call that raises ends the run without a result line, so none failed
    result = {"correct": bool(correct), "attempted": run.attempted,
              "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
