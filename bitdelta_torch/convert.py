"""Carry weights across from the JAX package: nested dicts / NamedTuples
of numpy arrays -> the port's torch tensors on a chosen device (and back
to numpy for comparisons).

This module never imports jax or ``bitdelta_tpu``: a JAX pytree is
handed over as numpy (``jax.tree.map(np.asarray, tree)``). bf16 arrays
(numpy's ``bfloat16`` extension dtype) cross as their 16-bit pattern, so
every value arrives bit-exact. NamedTuple leaves (``BinaryDelta``,
``PairedBinaryDelta``) are matched by their field names.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .core.compress import CompressedModel
from .core.delta import BinaryDelta, PairedBinaryDelta
from .device import resolve_device
from .serving.stacking import TenantStack

_TUPLES = {BinaryDelta._fields: BinaryDelta,
           PairedBinaryDelta._fields: PairedBinaryDelta,
           CompressedModel._fields: CompressedModel}


def tensor_from_numpy(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def tree_from_numpy(tree: Any, device) -> Any:
    """Convert every array leaf of dicts / lists / NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        cls = _TUPLES.get(tuple(fields))
        if cls is None:
            raise TypeError(f"unknown NamedTuple with fields {fields}")
        return cls(*(tree_from_numpy(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def params_from_numpy(params: Any, device="cuda") -> Any:
    """JAX-layout params (nested dicts of numpy arrays), deltas or a
    CompressedModel -> the port's tensors on ``device``."""
    return tree_from_numpy(params, resolve_device(device))


def stack_from_numpy(stack: Any, device="cuda") -> TenantStack:
    """A JAX ``TenantStack`` whose leaves were turned into numpy ->
    the port's TenantStack on ``device``."""
    device = resolve_device(device)
    return TenantStack(
        params=tree_from_numpy(stack.params, device),
        deltas=tree_from_numpy(stack.deltas, device),
        vocab_sizes=tensor_from_numpy(stack.vocab_sizes, device).to(
            torch.int32),
        num_tenants=int(stack.num_tenants))


def to_numpy(tree: Any) -> Any:
    """The port's tensors -> numpy (bf16 widened to fp32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree
