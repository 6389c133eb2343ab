"""Everything of one cell is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<name>.json``, its traffic mix in
``traffic/<name>.json``, the driver of its timed window in
``drivers/<name>.py``, each per-layer metric's reader in
``metrics/<name>.py`` and each kernel family in ``kernels/<name>.py``. A
later cell, mix, metric or family is a new file and a new entry; no file
here changes.

A configuration of another model than the U-Net + FNet adds, as new files:
``configs/<name>.json``, whose ``config`` is the program's YAML tree and
which keeps ``source``, ``reduced``, ``assumed``, ``deployment``,
``limits`` (one per name in its driver's ``LIMITS``) and
``mfu_peak_tflops`` keyed by its driver's name; ``traffic/<mix>.json``
naming that driver; ``drivers/<driver>.py`` with ``setup``, ``window``,
``trace``, ``check`` and ``LIMITS`` (a ``control`` of its own where the
tests' ``control_reading`` should read its control); its own float32
reference under ``reference/``; and its kernel families and metric
readers. In ``BENCHMARK.json`` it adds its configuration, its cells, and
the cells to the ``workloads`` of each metric they report. ``Run`` and
``execute`` hold nothing of one model: only the drivers of the U-Net +
FNet build its ``run.geom``."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]

DTYPES = {"float32": "fp32", "bfloat16": "bf16", "float16": "fp16"}


def stated_precisions(config: dict) -> dict:
    """The sampling precisions a configuration (the YAML's tree) states: the
    compute dtype (``sampling.dtype``, else ``model.dtype``, else the
    program's default float32), int8 taps, int8 activation storage and
    int8 strided transitions (none where the tree has no ``sampling``
    block). The widths these apply to, which the YAML does not state, stay
    in the file's ``declared``."""
    s = config.get("sampling") or {}
    dtype = s.get("dtype") or config.get("model", {}).get("dtype")
    return {"sample_dtype": DTYPES[dtype or "float32"],
            "tap_int8": bool(s.get("tap_int8", False)),
            "act_store": s.get("act_store"),
            "strided_int8": bool(s.get("strided_int8", False))}


class Registry:
    def __init__(self, bench_dir: Path = BENCH_DIR, spec_path: Path | None = None):
        self.dir = Path(bench_dir)
        self.spec_path = Path(spec_path or self.dir.parent / "BENCHMARK.json")
        with open(self.spec_path) as f:
            self.spec = json.load(f)
        self._modules = {}

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.spec_path}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        """The configuration file, its ``declared`` precisions completed
        from what its ``config`` states (``stated_precisions``)."""
        conf = self._json("configs", name)
        conf["declared"] = {**conf.get("declared", {}),
                            **stated_precisions(conf["config"])}
        return conf

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _module(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            if not path.is_file():
                raise KeyError(f"no {kind} file {path}")
            mod_name = f"port_bench_{kind}_" + "".join(
                ch if ch.isalnum() else "_" for ch in name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def driver(self, name: str):
        return self._module("drivers", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def kernel_family(self, name: str):
        return self._module("kernels", name)

    def metrics_of(self, cell: str, group: str) -> list:
        """The entries of ``end_to_end`` or ``per_layer`` that ``cell``
        reports: those that list it, and those that list no cells."""
        return [m for m in self.spec[group]
                if cell in m.get("workloads", [cell])]
