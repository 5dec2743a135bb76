"""Progressive, resumable rendering in the port (``models/progressive.py``)
on Cornell at 16^2-24^2 on the CPU.

Exact checks (bit for bit): the progressive image equals the float64 mean
of the chunk renders ``render_radiance(gen=iteration_generator(seed, i),
spp=chunk_spp)``; a render stopped and resumed from its checkpoint equals
one that ran through; a chunk retried after an injected ``RuntimeError``
reproduces the fault-free image; checkpoints cross between the two
packages.  ``state.spp_done`` never counts samples that are not folded.
Against the JAX ``ProgressiveRenderer`` (a different random stream) the
image means agree within 0.06 and the pixels correlate above 0.9: over
seeds 0-9 the 24^2, 16-spp image mean spread 0.0094 (JAX) and 0.0118
(port) about 0.848 and 0.840, so 0.06 is four standard deviations of the
difference of two such means."""

import os

import numpy as np
import pytest

from ensem3a_openclraytracer_tpu.models import progressive as jprog
from ensem3a_openclraytracer_tpu_torch import testing as tt
from ensem3a_openclraytracer_tpu_torch.models.optimize import iteration_generator
from ensem3a_openclraytracer_tpu_torch.models.pathtracer import render_radiance
from ensem3a_openclraytracer_tpu_torch.models.progressive import (
    ProgressiveRenderer,
    ProgressiveState,
)
from test_torch_replay import one_torch_thread  # noqa: F401  (an autouse fixture)

RES, MB, CHUNK, SEED = 16, 2, 2, 5
KW = dict(height=RES, width=RES, max_bounce=MB, chunk_spp=CHUNK, sun_enabled=False)


@pytest.fixture(scope="module")
def scene():
    return tt.make_cornell_scene(device="cpu")


def _renderer(scene, **kw):
    return ProgressiveRenderer(*scene, **{**KW, "base_seed": SEED, **kw})


def _chunk_sum(scene, indices, accum=None):
    """The float64 left fold of chunk renders, as the renderer adds them."""
    acc = np.zeros((RES, RES, 3)) if accum is None else accum
    for i in indices:
        chunk = render_radiance(*scene, iteration_generator(SEED, i, "cpu"), height=RES,
                                width=RES, spp=CHUNK, max_bounce=MB, sun_enabled=False)
        acc = acc + chunk.numpy().astype(np.float64) * CHUNK
    return acc


def test_progressive_equals_mean_of_chunk_renders(scene):
    img = _renderer(scene).render(4 * CHUNK)
    assert np.array_equal(img, (_chunk_sum(scene, range(4)) / (4 * CHUNK)).astype(np.float32))


@pytest.mark.parametrize("every", [1, 3])
def test_stop_and_resume_is_bit_equal(scene, tmp_path, every):
    ref = _renderer(scene)
    ref_img = ref.render(8 * CHUNK)
    ckpt = str(tmp_path / "r.npz")
    _renderer(scene).render(3 * CHUNK, checkpoint_path=ckpt, checkpoint_every=every)
    r = ProgressiveRenderer.resume(ckpt, *scene, **KW)
    assert r.state.spp_done == 3 * CHUNK and r.state.base_seed == SEED
    img = r.render(8 * CHUNK, checkpoint_path=ckpt, checkpoint_every=every)
    assert np.array_equal(r.state.accum, ref.state.accum) and np.array_equal(img, ref_img)
    assert ProgressiveState.load(ckpt).spp_done == 8 * CHUNK
    assert not list(tmp_path.glob("*.tmp"))


def test_retry_reproduces_the_fault_free_image(scene, capsys):
    r = _renderer(scene)
    real, calls = r._chunk_fn, []

    def flaky(gen):
        calls.append(1)
        if len(calls) == 2:  # the second chunk fails once
            raise RuntimeError("injected transient failure")
        return real(gen)

    r._chunk_fn = flaky
    img = r.render(3 * CHUNK)
    assert len(calls) == 4 and r.state.spp_done == 3 * CHUNK
    assert np.array_equal(img, _renderer(scene).render(3 * CHUNK))
    assert "chunk 1 failed (RuntimeError), retrying (1/2)" in capsys.readouterr().out


def test_a_chunk_that_keeps_failing_raises(scene):
    r = _renderer(scene)

    def broken(gen):
        raise RuntimeError("permanent failure")

    r._chunk_fn = broken
    with pytest.raises(RuntimeError, match="permanent failure"):
        r.render(CHUNK)
    assert r.state.spp_done == 0 and r.spp_pending == 0


def test_spp_done_counts_folded_samples_only(scene, tmp_path):
    """Between checkpoints the rendered samples wait on the device as
    ``spp_pending``; ``state`` always describes the folded chunks alone."""
    r = _renderer(scene)
    ckpt = str(tmp_path / "r.npz")
    seen = []

    def progress(done, total):
        st = ProgressiveState.load(ckpt) if os.path.exists(ckpt) else None
        seen.append((done, r.state.spp_done, r.spp_pending, None if st is None else st.spp_done))
        assert np.array_equal(r.state.accum, _chunk_sum(scene, range(r.state.spp_done // CHUNK)))

    r.render(5 * CHUNK, checkpoint_path=ckpt, checkpoint_every=2, progress=progress)
    c = CHUNK
    assert seen == [(c, 0, c, None), (2 * c, 2 * c, 0, 2 * c), (3 * c, 2 * c, c, 2 * c),
                    (4 * c, 4 * c, 0, 4 * c), (5 * c, 4 * c, c, 4 * c)]
    assert (r.state.spp_done, r.spp_pending) == (5 * c, 0)


def test_render_advances_in_whole_chunks(scene):
    r = _renderer(scene)
    r.render(CHUNK + 1)
    assert r.state.spp_done == 2 * CHUNK
    img = r.step()
    assert r.state.spp_done == 3 * CHUNK and img.dtype == np.float32


def test_jax_checkpoint_resumes_in_the_port(scene, tmp_path):
    rng = np.random.default_rng(2)
    accum = rng.random((RES, RES, 3)) * 4.0
    path = str(tmp_path / "jax.npz")
    jprog.ProgressiveState(accum=accum, spp_done=2 * CHUNK, base_seed=SEED).save(path)
    r = ProgressiveRenderer.resume(path, *scene, **KW)
    assert np.array_equal(r.state.accum, accum) and r.state.spp_done == 2 * CHUNK
    img = r.render(4 * CHUNK)
    assert np.array_equal(img, (_chunk_sum(scene, [2, 3], accum) / (4 * CHUNK))
                          .astype(np.float32))


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    path = str(tmp_path / "port.npz")
    r = _renderer(scene)
    r.render(2 * CHUNK, checkpoint_path=path)
    with np.load(path) as z:
        assert sorted(z.files) == ["accum", "base_seed", "spp_done"]
        assert (z["accum"].dtype, z["spp_done"].dtype, z["base_seed"].dtype) == (
            np.float64, np.int64, np.int64)
    st = jprog.ProgressiveState.load(path)
    assert (st.spp_done, st.base_seed) == (2 * CHUNK, SEED)
    assert np.array_equal(st.accum, r.state.accum) and np.array_equal(st.image, r.state.image)


def test_statistical_agreement_with_jax():
    """Cornell 24^2, 16 spp in chunks of 4: the port against the JAX
    ``ProgressiveRenderer`` on the same scene (two random streams)."""
    from ensem3a_openclraytracer_tpu.testing import make_cornell_scene

    kw = dict(height=24, width=24, max_bounce=MB, chunk_spp=4, sun_enabled=False)
    j_img = jprog.ProgressiveRenderer(*make_cornell_scene(use_bvh=False), base_seed=5,
                                      **kw).render(16)
    img = ProgressiveRenderer(*tt.make_cornell_scene(device="cpu"), base_seed=5,
                              **kw).render(16)
    assert img.shape == j_img.shape == (24, 24, 3) and np.isfinite(img).all()
    assert abs(float(img.mean()) - float(j_img.mean())) < 0.06
    assert np.corrcoef(img.ravel(), j_img.ravel())[0, 1] > 0.9
