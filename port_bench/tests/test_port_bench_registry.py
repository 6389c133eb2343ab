"""The harness finds every piece of a cell by name, a piece added in a copy
too, and ``BENCHMARK.json`` keeps to the names and keys the benchmark's
contract allows."""

from __future__ import annotations

import json
import re
import textwrap

from port_bench.harness.registry import BENCH_DIR, Registry
from port_bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_pieces():
    reg = Registry()
    for cell in reg.spec["workloads"]:
        conf = reg.config(cell["config"])
        traffic = reg.traffic(cell["traffic"])
        driver = reg.driver(traffic["driver"])
        for fn in ("setup", "window", "trace", "check"):
            assert callable(getattr(driver, fn))
        # the limits that check() in drivers/<name>.py compares, found
        # by the module's declaration and not by its name
        assert driver.LIMITS and all(isinstance(k, str) for k in
                                     driver.LIMITS)
        assert set(conf["limits"]) >= set(driver.LIMITS)
    for m in reg.spec["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
    fam = reg.kernel_family("conv3x3")
    assert fam.NAMES.search("void ddim::conv3x3_int8_kernel<__nv_bfloat16, 32>(")
    assert fam.NAMES.search("void ddim::conv_dw_tf32_kernel<0>(float const*")
    assert not fam.NAMES.search("void ddim::conv_dw_tf32_kernel<1>(float")
    assert not fam.NAMES.search("void ddim::conv_head_mma_kernel<2>(")


def test_spec_keeps_to_the_contract():
    reg = Registry()
    spec = reg.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        # a cut is written down, in both places alike, and not forbidden
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert isinstance(key, str) and key and NAME.match(key)
        assert reg.config(c["name"])["reduced"] == c["reduced"]
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    cells = [w["name"] for w in spec["workloads"]]
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        movers = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(movers)
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(cells) // 4)
    for cell in cells:
        reported = reg.metrics_of(cell, "end_to_end")
        assert len(reported) >= 2 and reg.metrics_of(cell, "per_layer")
    assert len(json.dumps(spec)) < 64 * 1024


def test_a_piece_added_in_a_copy_is_found(tmp_path):
    reg = tiny.make(tmp_path)
    bench = reg.dir
    (bench / "metrics" / "kernel_count.sample.py").write_text(textwrap.dedent(
        """
        from port_bench.harness import readers


        def read(run):
            return readers.launches_per_step(run)
        """))
    (bench / "kernels" / "head.py").write_text(textwrap.dedent(
        """
        import re
        NAMES = re.compile(r"conv_head")


        def bound_per_step(run):
            return 1.0
        """))
    (bench / "drivers" / "idle.py").write_text(textwrap.dedent(
        """
        def setup(run): pass
        def window(run, seconds): return {}
        def trace(run): pass
        def check(run): return {}
        """))
    spec = json.loads(reg.spec_path.read_text())
    spec["per_layer"].append(dict(spec["per_layer"][0],
                                  name="kernel_count.sample"))
    reg.spec_path.write_text(json.dumps(spec))
    reg = Registry(bench, reg.spec_path)
    assert reg.cell("tiny-sample")["config"] == "tiny"
    assert reg.config("tiny")["config"]["model"]["ch"] == [8, 16, 24]
    assert reg.traffic("tiny-train")["driver"] == "train"
    assert reg.metric("kernel_count.sample").read
    assert reg.kernel_family("head").bound_per_step(None) == 1.0
    assert reg.driver("idle").check(None) == {}
    assert "kernel_count.sample" in [
        m["name"] for m in reg.metrics_of("sample-ddim100-b8", "per_layer")]
    assert BENCH_DIR != bench
