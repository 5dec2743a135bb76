"""Card-only tests of the port's CUDA closest-hit kernel: ``trace_blocks``
against its plain version ``trace_plain`` on the card, for each of the
three roles it takes (1, 61 and 586 triangle blocks).  They skip without
a card.  This file imports no JAX, so on a machine without JAX run it
without the suite's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.ops import closest_hit as ch
from ensem3a_openclraytracer_tpu_torch.ops.camera import camera_rays

pytestmark = pytest.mark.cuda

ROLES = {  # role -> (scene maker, expected triangle blocks)
    "one_block": (lambda dev: tt.make_cornell_scene(device=dev), 1),
    "61_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=1300, device=dev), 61),
    "586_blocks": (lambda dev: tt.make_outdoor_scene(n_cubes=12500, device=dev), 586),
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rays(geom, cam, dev, seed, res=128, n_bounce=16384):
    o, d = camera_rays(cam.position, cam.rotation_deg, cam.fov_deg, res, res)
    h = ch.trace_plain(geom.feats, o.contiguous(), d)
    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(rng.integers(0, o.shape[0], n_bounce), device=dev)
    bd = torch.as_tensor(rng.normal(size=(n_bounce, 3)).astype(np.float32), device=dev)
    bd = torch.nn.functional.normalize(bd, dim=-1)
    bo = o[pick] + d[pick] * h.t[pick, None]
    return torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous()


@pytest.mark.parametrize("role", sorted(ROLES))
def test_kernel_matches_plain(cuda, role):
    make, blocks = ROLES[role]
    g, _, _, c = make(cuda)
    assert g.feats.block_bounds.shape[0] == blocks
    o, d = _rays(g, c, cuda, seed=blocks)
    order = ch.coherent_order(o, d)
    o, d = o[order].contiguous(), d[order].contiguous()
    before = ch.LAUNCHES["closest_hit"]
    t, tri = ch.trace_blocks(g.feats, o, d)
    torch.cuda.synchronize()
    assert ch.LAUNCHES["closest_hit"] == before + 1
    ref = ch.trace_plain(g.feats, o, d)
    hit = t < ch.MISS_T
    same = tri.to(torch.int64) == ref.tri
    assert float(same.float().mean()) >= 0.999
    assert float((hit == ref.hit).float().mean()) >= 0.999
    err = (t - ref.t).abs()[same]
    assert bool((err <= 1e-4 * torch.clamp(ref.t[same], min=1.0)).all())
    assert bool(torch.all(t[~hit] == ch.MAX_DIST)) and bool(torch.all(tri[~hit] == 0))


def test_dispatch_and_stats(cuda):
    g, _, _, c = ROLES["61_blocks"][0](cuda)
    o, d = _rays(g, c, cuda, seed=5, res=64, n_bounce=4096)
    h = ch.trace(g, o, d)
    ref = ch.trace_plain(g.feats, o, d)
    assert float((h.tri == ref.tri).float().mean()) >= 0.999
    stats = torch.zeros(2, dtype=torch.int64, device=cuda)
    ch.trace_blocks(g.feats, o, d, stats=stats)
    pairs, stagings = (int(x) for x in stats.cpu())
    assert 0 < pairs < o.shape[0] * g.feats.edges.shape[-1]
    assert stagings > 0
    with pytest.raises(ValueError, match="contiguous"):
        ch.trace_blocks(g.feats, o.t().contiguous().t(), d)
