"""No JAX in a run: the names compared whole, and a fresh interpreter that
imports the harness, the reference and every configuration, mix and metric
of the benchmark loads none of it."""

import json
import subprocess
import sys

from port_bench.harness.isolation import forbidden_modules
from port_bench.tests.conftest import ROOT


def test_top_level_names_are_compared_whole():
    names = ["ensem3a_openclraytracer_tpu_torch", "ensem3a_openclraytracer_tpu_torch.ops.fused",
             "jaxtyping", "jax_free", "torch"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["ensem3a_openclraytracer_tpu.ops", "jaxlib.xla_client",
                                      "flax", "jax"]) == ["ensem3a_openclraytracer_tpu", "flax",
                                                          "jax", "jaxlib"]


IMPORT_ALL = r"""
import importlib, json, pkgutil, sys
from pathlib import Path
root = Path(sys.argv[1]); sys.path.insert(0, str(root))
import port_bench, port_bench.run
from port_bench.harness.cells import Cell
for pkg in ("port_bench.harness", "port_bench.kinds", "port_bench.reference",
            "port_bench.scenes"):
    mod = importlib.import_module(pkg)
    for info in pkgutil.iter_modules(mod.__path__):
        importlib.import_module(pkg + "." + info.name)
spec = json.loads((root / "BENCHMARK.json").read_text())
for w in spec["workloads"]:
    cell = Cell(w["name"], root)
    importlib.import_module("port_bench.scenes." + cell.config["generator"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        cell.reader(m["name"])
import ensem3a_openclraytracer_tpu_torch.models.optimize
import ensem3a_openclraytracer_tpu_torch.models.pathtracer
from port_bench.harness.isolation import forbidden_modules
print(json.dumps(forbidden_modules()))
"""


def test_a_run_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL, str(ROOT)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
