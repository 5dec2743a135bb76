"""Fixtures of the benchmark's tests: a copy of the benchmark shrunk to a
size the CPU renders in a second, one torch thread a test, and the
``cuda`` marker."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY_INI = {"resolution": 16, "spp": 2}
TINY_SKY = {"width": 64, "height": 32, "quality": 90}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def few_threads():
    """One torch thread, so that parallel test workers share the CPU."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """Skips the test where torch sees no card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def shrink(root: Path) -> Path:
    """``root`` as a checkout of BENCHMARK.json and port_bench with every
    configuration at 16^2 and 2 spp, the outdoor scene at 30 cubes (2
    blocks), a 64 x 32 sky and the optimize mix at 16^2, 2 spp."""
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in (root / "port_bench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["ini"].update(TINY_INI)
        if "n_cubes" in cfg["params"]:
            cfg["params"]["n_cubes"] = 30
        if cfg.get("sky"):
            cfg["sky"] = TINY_SKY
        path.write_text(json.dumps(cfg))
    opt = root / "port_bench" / "traffic" / "optimize.json"
    mix = json.loads(opt.read_text())
    mix.update(resolution_cap=16, spp=2)
    opt.write_text(json.dumps(mix))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return shrink(tmp_path)
