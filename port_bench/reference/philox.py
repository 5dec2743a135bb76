"""Philox4x32-10 in plain torch, and the port's random-stream contract.

Frozen copy of ``ensem3a_openclraytracer_tpu_torch/ops/rng.py``
(``philox4x32_10`` :43-63, ``fold_seed`` :66-75, ``key_from_generator``
:78-87) with one addition, :func:`uniforms_at`, which draws single
elements of a stream by their flat index.  The contract (ops/rng.py:11-20):
element ``f`` of ``uniforms(key, shape, sample)`` is
``philox4x32_10(ctr=(f >> 2, sample, 0, 0), key=(k0, k1))[f & 3] >> 8``
times ``2^-24``.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK = 0xFFFFFFFF


def philox4x32_10(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of counters ``ctr [..., 4]`` under keys ``key [..., 2]``
    (int64 tensors holding uint32 values) -> ``[..., 4]`` uint32 words in
    int64."""
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
    """The seed of iteration ``i`` of a run with base ``seed``: 64 bits of
    ``philox4x32_10(ctr=(i, 0, 0, 0), key=(seed mod 2^32, seed >> 32))``."""
    ctr = torch.tensor([[int(i), 0, 0, 0]], dtype=torch.int64)
    key = torch.tensor([[int(seed) & _MASK, (int(seed) >> 32) & _MASK]], dtype=torch.int64)
    w = philox4x32_10(ctr, key)[0].tolist()
    return (w[0] << 32) | w[1]


def key_from_seed(seed: int, device) -> torch.Tensor:
    """The two key words ``[2]`` int32 that a ``torch.Generator`` on
    ``device`` seeded with ``seed`` gives first: the draw of
    ``key_from_generator``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return torch.randint(-(2 ** 31), 2 ** 31, (2,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def uniforms_at(key: torch.Tensor, sample: torch.Tensor, flat: torch.Tensor,
                width: int) -> torch.Tensor:
    """``width`` consecutive elements of sample ``sample``'s stream from flat
    index ``flat`` on: ``[..., width]`` float32 in [0, 1).  ``flat`` must be a
    multiple of ``width`` and ``width`` divide 4, so the elements share one
    Philox block (the estimator draws 2 per lane and bounce)."""
    block = flat >> 2
    ctr = torch.stack([block, sample.expand_as(block), torch.zeros_like(block),
                       torch.zeros_like(block)], dim=-1)
    words = philox4x32_10(ctr, key.to(torch.int64).expand(block.shape + (2,)))
    first = (flat & 3)[..., None] + torch.arange(width, device=flat.device)
    top = torch.gather(words, -1, first) >> 8
    return top.to(torch.float32) * (1.0 / (1 << 24))
