"""Row gathers whose backward pass is fast and deterministic.

Counterpart of the JAX package's ``ops/gathers.py``, which gathers rows by
a one-hot matmul because per-lane gathers are slow on the TPU.  On the
card the gather is cheap and its gradient, a scatter-add of every lane's
row gradient into the table, is the problem.  A replay gathers up to
262,144 lanes per bounce from tables of a few dozen rows (Cornell's faces)
to tens of millions (an 8k sky), often with most lanes on a few rows, and
the resumable optimisation of ``models/optimize`` needs the same gradient
bit for bit from the same inputs.  On the card (``chip_smoke.py`` phase
11, numbers in PERF.md) autograd's backward of ``table[idx]``,
``index_put_(accumulate=True)``, is deterministic but adds the duplicates
of a row serially, so concentrated indices take it hundreds of
milliseconds; the embedding backward and ``index_add_`` add with float
atomics and are not deterministic.

:func:`scatter_rows`, the backward of :func:`gather_rows`, adds in
fixed point: the gradients scaled by a power of two such that the sum of
all their magnitudes fits 62 bits, rounded to int64 and added with
``index_add_``.  Integer addition is exact, so the order in which the
atomics land does not matter, and unlike ``index_put_`` the atomics do
not serialize a row's duplicates.  The error is one quantum (2^-62 of
lanes x largest magnitude) per lane, below a float32 sum's.  A non-finite
gradient makes the whole table NaN.

Each sum counts itself (``utils/profiling.count``, ``"scatter"``): one
call, its lanes (index entries) and the table entries it writes, which is
every entry of the dense table however few lanes it has.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ensem3a_openclraytracer_tpu_torch.utils.profiling import count


def scatter_rows(grad: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of :func:`gather_rows` with respect to its table: each
    lane's row of ``grad`` (``idx.shape + row shape``) added into a
    ``[rows, ...]`` table in fixed point (module docstring)."""
    tail = grad.shape[idx.dim():]
    i = idx.reshape(-1).to(torch.int64)
    g = grad.reshape(i.numel(), -1).to(torch.float64)
    count("scatter", calls=1, lanes=i.numel(), entries=rows * g.shape[1])
    amax = g.abs().amax() if g.numel() else g.new_zeros(())
    scale = torch.floor(62.0 - torch.log2(torch.clamp(amax * i.numel(), min=2.0 ** -200)))
    q = torch.round(g * torch.exp2(scale)).to(torch.int64)
    total = torch.zeros((rows, g.shape[1]), dtype=torch.int64, device=g.device)
    out = total.index_add_(0, i, q).to(torch.float64)
    del total  # a sky-sized table: hold one int64 and one float64 copy at most
    out = out.mul_(torch.exp2(-scale)).add_(amax * 0.0)
    return out.to(grad.dtype).reshape((rows,) + tuple(tail))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_rows(grad, idx, ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for ``table`` ``[R, ...]`` and integer ``idx`` of any
    shape, with the backward pass of the module docstring
    (:func:`scatter_rows`: the same gradient bit for bit for the same
    inputs, on the card and the CPU)."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx]
    return _GatherRows.apply(table, idx)
