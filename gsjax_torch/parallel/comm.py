"""Collectives over a process group, with their gradients.

gsjax writes its sharded program once and lets ``shard_map`` and XLA
supply the collectives and their transposes (``lax.all_gather`` ->
``psum_scatter``, ``all_to_all`` -> the reverse ``all_to_all``,
``ppermute`` -> the inverse permutation). The port runs one process per
rank, so each collective that carries a gradient is a
``torch.autograd.Function`` here:

- :func:`all_gather` — rows of every rank, concatenated in rank order;
  backward: this rank's rows of the all-reduced (summed) gradient, i.e.
  psum-scatter, so each rank receives the gradient of the sum of all
  ranks' losses with respect to its own rows;
- :func:`all_to_all` — equal row blocks, block ``j`` to rank ``j``;
  backward: the same exchange of the gradient;
- :func:`halo_rows` — the previous rank's last ``halo`` rows on top, the
  next rank's first ``halo`` below, zeros at the ends (the SSIM halo);
  backward: each halo's gradient added back into its sender's rows.

plus :func:`psum`, :func:`pmean` and :func:`pmax` (no gradient).

Both backends take the device tensors as they are. gloo with CUDA tensors
(ranks sharing a card) stages them through host memory itself; on an
NVIDIA H100 with torch 2.11 it accepted all_gather, all_gather_into_tensor,
all_reduce (sum, max), all_to_all_single, reduce_scatter_tensor and
broadcast, while send / recv of a CUDA tensor aborted the process
(``writev ... Bad address``). So nothing here uses send / recv: the halo
travels by an all-gather of every rank's edge rows.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def gather_rows(x, group):
    """Every rank's ``x`` (same shape), concatenated along dim 0 in rank
    order. No gradient."""
    if x.dtype == torch.bool:  # bool travels as bytes
        return gather_rows(x.to(torch.uint8), group).to(torch.bool)
    src = x.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.cat(out)


def _all_reduce(x, op, group):
    buf = x.detach().clone().contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf


def psum(x, group):
    """Sum over the ranks of ``group`` (no gradient)."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmean(x, group):
    """Mean over the ranks of ``group`` (no gradient): ``lax.pmean``'s
    counterpart beside :func:`psum` and :func:`pmax`. The sharded step
    averages its gradients inside one fused :func:`psum`, so the port
    itself calls this nowhere."""
    return psum(x, group) / dist.get_world_size(group)


def pmax(x, group):
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def all_to_all_rows(x, group):
    """Row block ``j`` of ``x`` (``size`` equal blocks) to rank ``j``; the
    result's block ``i`` came from rank ``i``. No gradient."""
    src = x.detach().contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        total = psum(grad, ctx.group)
        r = dist.get_rank(ctx.group)
        return total[r * ctx.rows:(r + 1) * ctx.rows], None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_to_all_rows(grad, ctx.group), None


def _edge_rows(x, halo, group):
    """(size, 2 * halo, ...): every rank's first and last ``halo`` rows."""
    size = dist.get_world_size(group)
    edges = torch.cat([x[:halo], x[-halo:]])
    return gather_rows(edges, group).reshape((size, 2 * halo) + tuple(x.shape[1:]))


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        size, r = dist.get_world_size(group), dist.get_rank(group)
        edges = _edge_rows(x, halo, group)
        zeros = x.new_zeros((halo,) + tuple(x.shape[1:]))
        top = edges[r - 1, halo:] if r > 0 else zeros
        bot = edges[r + 1, :halo] if r < size - 1 else zeros
        return torch.cat([top, x, bot])

    @staticmethod
    def backward(ctx, grad):
        halo, size = ctx.halo, dist.get_world_size(ctx.group)
        r = dist.get_rank(ctx.group)
        # this rank's halo gradients, top then bottom, go back to their senders
        edges = _edge_rows(torch.cat([grad[:halo], grad[-halo:]]), halo, ctx.group)
        dx = grad[halo:-halo].clone()
        if r < size - 1:  # the next rank's top halo was my last rows
            dx[-halo:] += edges[r + 1, :halo]
        if r > 0:  # the previous rank's bottom halo was my first rows
            dx[:halo] += edges[r - 1, halo:]
        return dx, None, None


def all_gather(x, group):
    """Differentiable :func:`gather_rows` (see the module docstring)."""
    return _AllGather.apply(x, group)


def all_to_all(x, group):
    """Differentiable :func:`all_to_all_rows`."""
    return _AllToAll.apply(x, group)


def halo_rows(x, halo: int, group):
    """``x`` (rows, ...) with ``halo`` rows of each neighbour attached
    (zeros past the first and last rank). Differentiable. The halos travel
    by one all-gather of every rank's edge rows (a few KB), one route on
    every backend."""
    return _HaloRows.apply(x, halo, group)
