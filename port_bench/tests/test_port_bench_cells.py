"""A configuration, a traffic mix, a traffic kind, a cell and a metric
added as new files and entries alone: the harness finds them by name and
runs the cell, with no file of the benchmark edited but BENCHMARK.json."""

import json

from port_bench import run
from port_bench.harness.cells import Cell


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def test_a_cell_added_as_files_runs(tiny_root, capsys):
    bench = tiny_root / "port_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "cornell.json").read_text())
    cfg.update(name="cornell_wide")
    cfg["ini"].update(cam_DOF=70.0)
    (bench / "configs" / "cornell_wide.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "render_once.json").write_text(json.dumps(
        {"kind": "render", "why": "a mix added as a file", "use_bvh": False}))
    (bench / "cells" / "cornell_wide.render_once.json").write_text(json.dumps(
        {"compare": {"renders": 1, "pixels": 64, "fork_abs": 0.001},
         "limits": {"fork_share": 0.05}}))
    (bench / "metrics" / "render_calls_per_s.py").write_text(
        "def read(run):\n    return run.window.calls / run.window.seconds\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cornell_wide", "source": "https://example.org/x",
                            "file": "port_bench/configs/cornell_wide.json", "reduced": [],
                            "why": "a wider view"})
    spec["workloads"].append({"name": "cornell_wide.render_once", "config": "cornell_wide",
                              "traffic": "render_once", "chips": 1, "why": "a test cell"})
    spec["end_to_end"].append({"name": "render_calls_per_s", "unit": "1/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": ["cornell_wide.render_once"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = Cell("cornell_wide.render_once", tiny_root)
    assert {m["name"] for m in cell.metrics(False)} == {"render_calls_per_s", "setup_s"}
    rc = run.main(["--workload", "cornell_wide.render_once", "--seed", "2147483650",
                   "--seconds", "0.3"], device="cpu", root=tiny_root, require_card=False)
    result = last_json(capsys.readouterr().out)
    assert rc == 0 and result["correct"] is True
    assert set(result["metrics"]) == {"render_calls_per_s", "setup_s"}
    assert list(result)[-1] == "checks" and set(result["checks"]) == {"fork_share"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


NEW_KIND = '''"""Renders at the mix's own samples per pixel (``spp``), the
reference at the same."""

import dataclasses
import sys

from port_bench.kinds import render


class Mix(render.Mix):
    def __init__(self, *args):
        super().__init__(*args)
        print("render_spp: set up", file=sys.stderr)

    def render(self, seed):
        spp = int(self.cell.traffic["spp"])
        self.spp = spp
        return self.render_scene(self.scene, seed=seed, overrides={"spp": spp}).cpu()

    def reference_scene(self):
        return dataclasses.replace(super().reference_scene(), spp=int(self.cell.traffic["spp"]))


def readings(cell, seed, device):
    return render.readings(cell, seed, device)
'''


def test_a_traffic_kind_added_as_a_file_runs(tiny_root, capsys):
    bench = tiny_root / "port_bench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "kinds" / "render_spp.py").write_text(NEW_KIND)
    (bench / "traffic" / "one_sample.json").write_text(json.dumps(
        {"kind": "render_spp", "why": "a kind added as a file", "spp": 1}))
    (bench / "cells" / "cornell.one_sample.json").write_text(json.dumps(
        {"compare": {"renders": 2, "pixels": 0, "fork_abs": 0.001},
         "limits": {"fork_share": 0.01, "mean_abs": 0.001}}))
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "cornell.one_sample", "config": "cornell",
                              "traffic": "one_sample", "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "render_mrays_per_s.host":
            m["workloads"].append("cornell.one_sample")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    rc = run.main(["--workload", "cornell.one_sample", "--seed", "2147483657",
                   "--seconds", "0.3"], device="cpu", root=tiny_root, require_card=False)
    out = capsys.readouterr()
    result = last_json(out.out)
    assert rc == 0 and result["correct"] is True
    assert "render_spp: set up" in out.err
    assert set(result["metrics"]) == {"render_mrays_per_s.host", "setup_s"}
    cell = Cell("cornell.one_sample", tiny_root)
    from port_bench.harness import control

    assert set(control.readings(cell, 2147483657, "cpu")) == {"control", "half_batch",
                                                             "altered"}
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_each_cell_reports_its_own_metrics():
    want = {
        "cornell.render": ({"render_mrays_per_s.host", "render_p95_ms.host", "setup_s"},
                           {"idle_share.render.host", "kernels_per_call.render.host",
                            "roofline.render.host"}),
        "outdoor15k.render": ({"render_mrays_per_s", "render_p95_ms", "setup_s"},
                              {"idle_share.render", "kernels_per_call.render", "roofline.render"}),
        "outdoor15k.tree": ({"render_mrays_per_s.host", "setup_s"},
                            {"idle_share.render.host", "kernels_per_call.render.host",
                             "roofline.render.host", "tree_p95_ms"}),
        "cornell.optimize": ({"opt_step_ms", "setup_s"},
                             {"idle_share.opt", "kernels_per_call.opt", "torch_op_ms.opt"}),
    }
    for name, (ends, layers) in want.items():
        cell = Cell(name)
        assert {m["name"] for m in cell.metrics(False)} == ends
        assert {m["name"] for m in cell.metrics(True)} == layers
        for m in cell.metrics(False) + cell.metrics(True):
            assert callable(cell.reader(m["name"]))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    spec = json.loads((Cell("cornell.render").root / "BENCHMARK.json").read_text())
    ends = {m["name"]: m for m in spec["end_to_end"]}
    cells = [w["name"] for w in spec["workloads"]]
    for m in spec["per_layer"]:
        moved = ends[m["moves"]]
        for c in m["workloads"]:
            assert c in moved.get("workloads", cells)
