"""The configuration ``outdoor600k`` and its cell ``outdoor600k.render``:
the outdoor stand-in at 50,000 cubes, 600,002 triangles in 2,344 blocks of
256 (above ``ops/pairs.AGG_BLOCKS`` and ``SEL_BLOCKS``), with everything
else as ``outdoor15k``; the cell reports the render cells' metrics of 2b."""

import json

import numpy as np
import pytest

from port_bench.harness.cells import Cell
from port_bench.scenes import files

RENDER_LAYERS = {"idle_share.render", "kernels_per_call.render", "roofline.render",
                 "grid_sync_share.render", "pairs_per_segment.render", "split_round_share.render",
                 "coop_select_share.render", "subtile_share.render", "select_share.render"}


def test_the_generator_gives_600002_triangles_in_2344_blocks():
    from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
    from ensem3a_openclraytracer_tpu_torch.ops import pairs as pp

    cfg = Cell("outdoor600k.render").config
    tris = files.generator(cfg["generator"]).triangles(cfg["params"], 2147483661)
    assert len(tris) == 12 * 50000 + 2 == 600002
    feats = ch.build_tri_features(*(np.asarray([t[k] for t in tris], np.float32)
                                    for k in range(3)), "cpu")
    blocks = feats.block_bounds.shape[0]
    assert blocks == 2344 and blocks > pp.SEL_BLOCKS > pp.AGG_BLOCKS


def test_the_configuration_is_outdoor15k_at_another_size():
    big, small = (Cell(c).config for c in ("outdoor600k.render", "outdoor15k.render"))
    assert big["reduced"] == [] and big["params"] == {"n_cubes": 50000, "geometry_seed": 7}
    for key in ("generator", "ini", "materials", "sky"):
        assert big[key] == small[key], key
    spec = json.loads((Cell("outdoor600k.render").root / "BENCHMARK.json").read_text())
    (entry,) = [c for c in spec["configs"] if c["name"] == "outdoor600k"]
    assert entry["file"] == "port_bench/configs/outdoor600k.json" and entry["reduced"] == []


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_reports_the_render_metrics_of_2b(trace):
    cell = Cell("outdoor600k.render")
    assert cell.chips == 1 and cell.traffic["kind"] == "render"
    want = RENDER_LAYERS if trace else {"render_mrays_per_s", "render_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.metrics(trace)} == want
    for m in cell.metrics(trace):
        assert callable(cell.reader(m["name"]))
