"""The port's Philox stream (``ops/rng.py``): known answers, the stream
contract, and statistics.  The JAX package's TPU kernel (``uniforms_tpu``)
draws from the TPU's hardware PRNG, so the bits cannot agree; what is
held to it is its range and resolution: [0, 1) in steps of 2^-24, the top
24 bits of a 32-bit word."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ensem3a_openclraytracer_tpu_torch.ops import rng

# Random123's known-answer vectors for Philox4x32-10: (counter, key, output)
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _key(a, b):
    return torch.tensor(np.array([a, b], np.uint32).view(np.int32))


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_known_answers(case):
    ctr, key, want = KAT[case]
    got = rng.philox4x32_10(torch.tensor(ctr, dtype=torch.int64), torch.tensor(key))
    assert [int(x) for x in got] == list(want)


def test_stream_contract():
    """Element f of (key, sample) is philox((f >> 2, sample, 0, 0))[f & 3]
    >> 8, times 2^-24, for any shape."""
    key = _key(0xDEADBEEF, 0x01234567)
    u = rng.uniforms(key, (3, 7, 5), 9)
    assert u.shape == (3, 7, 5) and u.dtype == torch.float32
    flat = u.reshape(-1)
    for f in (0, 1, 2, 3, 4, 50, 104):
        w = rng.philox4x32_10(torch.tensor([f >> 2, 9, 0, 0]), torch.tensor([0xDEADBEEF, 0x01234567]))
        assert float(flat[f]) == (int(w[f & 3]) >> 8) * 2.0 ** -24
    # the same elements whatever the shape: a prefix of a longer stream
    assert torch.equal(rng.uniforms(key, (105,), 9), flat)
    assert torch.equal(rng.uniforms(key, (110,), 9)[:105], flat)


def test_determinism_and_independence():
    key = _key(7, 8)
    a = rng.uniforms(key, (4, 1000, 2), 0)
    assert torch.equal(a, rng.uniforms(key, (4, 1000, 2), 0))
    assert not torch.equal(a, rng.uniforms(key, (4, 1000, 2), 1))
    assert not torch.equal(a, rng.uniforms(_key(7, 9), (4, 1000, 2), 0))
    gen = torch.Generator().manual_seed(3)
    k1 = rng.key_from_generator(gen, torch.device("cpu"))
    assert k1.dtype == torch.int32 and k1.shape == (2,)
    assert torch.equal(k1, rng.key_from_generator(torch.Generator().manual_seed(3), "cpu"))
    with pytest.raises(ValueError, match="int32"):
        rng.uniforms(torch.zeros(2, dtype=torch.int64), (4,), 0)


def test_range_resolution_and_moments():
    n = 1_000_000
    u = rng.uniforms(_key(0x9E3779B9, 42), (n,), 5).double().numpy()
    assert u.min() >= 0.0 and u.max() < 1.0
    k = u * 2 ** 24
    assert np.array_equal(k, np.floor(k)), "not multiples of 2^-24"
    # within 5 sigma: sd of the mean sqrt(1/12/n), of the variance sqrt(1/180/n)
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / n)
    assert abs(((u - 0.5) ** 2).mean() - 1 / 12) < 5 * np.sqrt(1 / 180 / n)


def test_range_and_resolution_match_jax_kernel():
    """The JAX kernel maps a 32-bit word to a uniform as ``int32(bits >>
    8) * (1 / (1 << 24))`` (``ops/rng.py:_rng_kernel``); the port maps its
    Philox words the same way."""
    key = _key(11, 12)
    n = 4096
    words = rng.philox4x32_10(
        torch.stack([torch.arange(n // 4), torch.full((n // 4,), 2), torch.zeros(n // 4, dtype=torch.int64),
                     torch.zeros(n // 4, dtype=torch.int64)], dim=-1),
        torch.tensor([11, 12]).expand(n // 4, 2)).reshape(-1).numpy().astype(np.uint32)
    top = jnp.asarray(words >> 8).astype(jnp.int32)
    ref = np.asarray(top.astype(jnp.float32) * (1.0 / (1 << 24)))
    np.testing.assert_array_equal(rng.uniforms(key, (n,), 2).numpy(), ref)
