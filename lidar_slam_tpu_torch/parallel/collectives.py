"""The collectives of the JAX package's sharded code, over a `Mesh`, with
results that repeat to the bit from run to run at a given world size.

  jax.lax.psum                      -> all_sum
  jax.lax.psum_scatter(tiled=True)  -> sum_scatter
  jax.lax.all_gather(tiled=True)    -> all_gather
  jax.lax.axis_index                -> mesh.rank

Every sum runs in a fixed order. A backend's own reduction adds in an
order of its choosing (NCCL picks ring or tree by size), so no reduction
here adds two ranks' values: each rank writes its part into its own slot
of a zeroed `[world, ...]` tensor, an `all_reduce` moves the slots (adding
zeros is exact), and each rank adds the slots in rank order.

Every collective here is that `all_reduce` of the slots (or a `broadcast`),
on every backend: gloo takes CUDA tensors only in those two, so no
collective goes through a host copy. NCCL's `reduce_scatter_tensor` and
`all_gather_into_tensor` would move about half the bytes on several cards;
no run has shown that this matters, so they are not used.

A mesh with no process group (one rank) returns every input unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh


def _slots(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    s = x.new_zeros((mesh.size, *x.shape))
    s[mesh.rank] = x
    return s


def _in_rank_order(slots: torch.Tensor) -> torch.Tensor:
    out = slots[0]
    for r in range(1, slots.shape[0]):
        out = out + slots[r]
    return out


def all_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, the same bits on every rank."""
    if not mesh.distributed:
        return x
    s = _slots(x, mesh)
    dist.all_reduce(s)
    return _in_rank_order(s)


def sum_scatter(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's slab (rows rank * V / W onwards) of the sum of `x` [V, ...]
    over the ranks; V must divide the mesh size."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"leading dimension {x.shape[0]} must divide mesh size {mesh.size}")
    slab = x.shape[0] // mesh.size
    if not mesh.distributed:
        return x
    s = _slots(x, mesh)
    dist.all_reduce(s)
    return _in_rank_order(s[:, mesh.rank * slab:(mesh.rank + 1) * slab])


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's `x` [S, ...] stacked in rank order: [W * S, ...]
    (floating-point or integer tensors)."""
    if not mesh.distributed:
        return x
    s = _slots(x, mesh)
    dist.all_reduce(s)
    return s.reshape(mesh.size * x.shape[0], *x.shape[1:])


def broadcast(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`x` as rank 0 holds it, written into `x` on every rank."""
    if mesh.distributed:
        dist.broadcast(x, 0)
    return x
