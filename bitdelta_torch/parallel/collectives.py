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

Under autograd (scale distillation over a mesh) the model axis takes
Megatron's pair of collectives in place of ``psum``, each an autograd
Function: :func:`copy_to_model` on the input of every column-parallel
projection (the identity forward, the gradient summed over the model
axis in backward) and :func:`reduce_from_model` after every row-parallel
one (the sum forward, the identity backward). ``jax.grad`` derives the
same from GSPMD. Each rank of the model axis holds the same replicated
loss, so the gradient reaching a sum's output is already whole: that is
why the backward of :func:`reduce_from_model` is the identity, and why
``torch.distributed.nn.functional.all_reduce`` (whose backward sums the
gradient too) would multiply every gradient by the axis size. Both run
their Function only while grad is enabled; under ``torch.no_grad`` (the
serving path) :func:`reduce_from_model` is ``psum`` and
:func:`copy_to_model` the identity. Each counts the all-reduces it
issues (``copy_to_model.calls`` in backward, ``reduce_from_model.calls``
in forward).
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
    return _all_reduce(x, mesh, axis, dtype)


def pmax(x: torch.Tensor, mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` on every rank of it (a
    new tensor; exact, as a max rounds nothing)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _all_reduce(x, mesh, axis, op=dist.ReduceOp.MAX)


def _all_reduce(x: torch.Tensor, mesh, axis: str, dtype=None,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.to(dtype or x.dtype, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, op=op, group=mesh.get_group(axis))
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        copy_to_model.calls += 1
        return _all_reduce(g, ctx.mesh, MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dtype):
        reduce_from_model.calls += 1
        return _all_reduce(x, mesh, MODEL_AXIS, dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the input of a column-parallel consumer: itself, with its
    gradient summed over the model axis in backward (Megatron's ``f``)."""
    if axis_size(mesh, MODEL_AXIS) == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh, *,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The sum of a row-parallel partial ``x`` over the model axis, with
    the identity backward (Megatron's ``g``); :func:`psum` without grad.
    ``dtype``: as :func:`psum`'s."""
    if not torch.is_grad_enabled():
        return psum(x, mesh, dtype=dtype)
    if axis_size(mesh, MODEL_AXIS) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh, dtype)


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
copy_to_model.calls = 0
reduce_from_model.calls = 0
