"""Collectives over one axis of a ``(data, model)`` mesh: the port's
``jax.lax.psum``, ``jax.lax.axis_index`` and the reassembly that
``shard_map``'s ``out_specs`` do.

Every function takes the mesh (a ``DeviceMesh`` from :mod:`.mesh`, or
None) and an axis name. On a mesh of None, or an axis of size one, each
is a no-op, so the single-device path and a ``(1, 1)`` mesh run the same
arithmetic.

Gloo carries the ranks that share a card: it takes CUDA tensors for
``all_reduce`` and ``all_gather`` (fp32 and bf16; checked on the H100),
so nothing is staged through host memory here.

``psum`` counts its calls (``psum.calls``), as the kernel wrappers count
their launches.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS


def axis_size(mesh, axis: str) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (0 without a mesh)."""
    if mesh is None:
        return 0
    return int(mesh.get_local_rank(axis))


def psum(x: torch.Tensor, mesh, axis: str = MODEL_AXIS, *,
         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` on every rank of it (a new tensor).
    ``dtype``: reduce in this dtype and cast back to ``x``'s."""
    if axis_size(mesh, axis) == 1:
        return x
    psum.calls += 1
    out = x.to(dtype or x.dtype, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, group=mesh.get_group(axis))
    return out.to(x.dtype)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order of
    ``axis``: a tensor sharded along ``dim`` made whole."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def broadcast_object(obj, src: int = 0, group=None):
    """``obj`` of rank ``src`` on every rank of ``group`` (pickled)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


psum.calls = 0
