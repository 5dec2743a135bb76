"""Monte-Carlo uniforms from a counter-based Philox4x32-10 stream.

Counterpart of the JAX package's ``ops/rng.py`` (``_rng_kernel`` /
``uniforms_tpu``), which fills ``[rows, 128]`` with the top 24 bits of
the TPU core's hardware PRNG times ``2^-24``.  Hopper has no such unit;
here the bits come from Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC'11; the Random123 constants), computed
by ``csrc/rng.cu`` on the card and by :func:`philox4x32_10` in plain
torch elsewhere.  The range and resolution are the TPU kernel's ([0, 1),
multiples of ``2^-24``); the bits are not.

The stream contract, shared with the fused sample kernel's in-kernel
draws (``csrc/philox.cuh``): the element at flat index ``f`` of the
array ``uniforms(key, shape, sample)`` is

    philox4x32_10(ctr=(f >> 2, sample, 0, 0), key=(k0, k1))[f & 3] >> 8,
    times 2^-24,

with ``(k0, k1)`` the two uint32 words of ``key``.  So one key and one
sample index name one stream, every element of it can be computed on
its own, and the fused kernel fed ``uniforms(key, (mb + 1, N, n_u), s)``
explicitly reproduces its own draws for sample ``s``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from ensem3a_openclraytracer_tpu_torch.ops import launches

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK = 0xFFFFFFFF

# Launches of the CUDA kernel; only a launch on the card counts.
LAUNCHES = launches.counter({"uniforms": ("uniforms_kernel",)})


def philox4x32_10(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of counters ``ctr [..., 4]`` under keys ``key [..., 2]``
    (int64 tensors holding uint32 values) -> ``[..., 4]`` uint32 words in
    int64.  A product of two uint32 wraps in int64, but its low 64 bits
    stay exact, so the high word is ``(p >> 32) & 0xFFFFFFFF``."""
    c = [ctr[..., i].to(torch.int64) & _MASK for i in range(4)]
    k0 = key[..., 0].to(torch.int64) & _MASK
    k1 = key[..., 1].to(torch.int64) & _MASK
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        p0 = c[0] * _M0
        p1 = c[2] * _M1
        hi0, lo0 = (p0 >> 32) & _MASK, p0 & _MASK
        hi1, lo1 = (p1 >> 32) & _MASK, p1 & _MASK
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, dim=-1)


def fold_seed(seed: int, i: int) -> int:
    """64 bits of ``philox4x32_10(ctr=(i, 0, 0, 0), key=(seed mod 2^32,
    seed >> 32))``: a seed that is a pure function of (seed, i), the
    counterpart of JAX's ``fold_in(key, i)``."""
    ctr = torch.tensor([[int(i), 0, 0, 0]], dtype=torch.int64)
    key = torch.tensor([[int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]],
                       dtype=torch.int64)
    w = philox4x32_10(ctr, key)[0].tolist()
    return (w[0] << 32) | w[1]


def key_from_generator(gen: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """Two random key words ``[2]`` int32 (uint32 bit patterns) drawn from
    ``gen`` (``None``: a generator seeded 0) on ``device``: the kernels read
    them there, with no host sync."""
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
    return torch.randint(-(2 ** 31), 2 ** 31, (2,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def uniforms_plain(key: torch.Tensor, shape: Sequence[int], sample: int) -> torch.Tensor:
    """The stream of the module docstring in plain torch, on ``key``'s
    device: float32 ``shape`` in [0, 1), multiples of ``2^-24``."""
    n = _numel(shape)
    dev = key.device
    blocks = torch.arange(-(-n // 4), dtype=torch.int64, device=dev)
    ctr = torch.stack([blocks, torch.full_like(blocks, int(sample)),
                       torch.zeros_like(blocks), torch.zeros_like(blocks)], dim=-1)
    words = philox4x32_10(ctr, key.to(torch.int64).expand(blocks.shape[0], 2))
    top = (words.reshape(-1)[:n] >> 8).to(torch.float32)
    return (top * (1.0 / (1 << 24))).reshape(tuple(int(s) for s in shape))


def _check_key(key: torch.Tensor) -> None:
    if key.dtype != torch.int32 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"key: want a contiguous int32 tensor of shape (2,), got "
                         f"{key.dtype} {tuple(key.shape)}")


@functools.cache
def _launcher():
    """The kernel's C entry point, built and typed on first use."""
    from ensem3a_openclraytracer_tpu_torch import _build

    fn = _build.load("rng").uniforms_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def uniforms(key: torch.Tensor, shape: Sequence[int], sample: int) -> torch.Tensor:
    """The stream of the module docstring: through ``csrc/rng.cu`` for a
    key on the card, :func:`uniforms_plain` for a key on the CPU."""
    _check_key(key)
    if key.device.type == "cpu":
        return uniforms_plain(key, shape, sample)
    if key.device.type != "cuda":
        raise ValueError(f"uniforms runs on cuda or cpu, not {key.device}")
    n = _numel(shape)
    if n > 2 ** 34:
        raise ValueError(f"{n} uniforms exceed the 2^32 counters of one stream")
    out = torch.empty(tuple(int(s) for s in shape), dtype=torch.float32, device=key.device)
    if n == 0:
        return out
    err = _launcher()(key.data_ptr(), int(sample), out.data_ptr(), n,
             torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"uniforms kernel launch failed: CUDA error {err}")
    LAUNCHES["uniforms"] += 1
    return out
