"""The import rule: a run loads neither JAX nor the JAX package (top-level
names compared whole: the program's name begins with the JAX package's),
and the reference loads nothing of the program either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from port_bench.harness import cell
from port_bench.harness.registry import BENCH_DIR

REPO = BENCH_DIR.parent


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ddim_audio_tpu_torch_x", sys)
    assert "ddim_audio_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ddim_audio_tpu.models", sys)
    assert cell.forbidden_modules() == ["ddim_audio_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    loaded = _loaded(
        "from pathlib import Path\n"
        "from port_bench.tests import tiny\n"
        "from port_bench.harness.cell import execute\n"
        f"reg = tiny.make(Path({str(tmp_path)!r}))\n"
        "for c in ('tiny-sample', 'tiny-train'):\n"
        "    r, _ = execute(reg, c, 3, 0.01, c == 'tiny-sample', 'cpu')\n"
        "    assert r['correct']\n")
    assert "ddim_audio_tpu_torch" in loaded
    assert not loaded & set(cell.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    files = sorted((BENCH_DIR / "reference").glob("*.py"))
    names = set()
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
    assert not names & {"ddim_audio_tpu_torch", *cell.FORBIDDEN}
    loaded = _loaded("import " + ", ".join(
        f"port_bench.reference.{f.stem}" for f in files
        if f.stem != "__init__"))
    assert not loaded & {"ddim_audio_tpu_torch", *cell.FORBIDDEN}
