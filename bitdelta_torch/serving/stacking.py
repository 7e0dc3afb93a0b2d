"""Tenant stacking: N compressed fine-tunes -> one serving stack (port of
``bitdelta_tpu/serving/stacking.py``, single-device ``tp=1``).

Packed deltas of all tenants are stacked per projection into
``(L, T, K//32, N)``; per-tenant extras (embed / norms / lm_head) are
stacked on a tenant axis, with ragged vocabularies right-padded to the
largest (logits are masked per tenant at sampling).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch

from ..core.compress import LAYER_EXTRA_NAMES, CompressedModel
from ..core.delta import BinaryDelta, PairedBinaryDelta, pair_delta
from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.llama import Params
from ..ops.packing import PAIR_BLOCK


class TenantStack(NamedTuple):
    params: Params              # base projections + stacked extras
    deltas: Dict[str, object]   # packed (L, T, K//32, N), scale (L, T)
    vocab_sizes: torch.Tensor   # (T,) int32 — true vocab per tenant
    num_tenants: int


def _pad_vocab(arr: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    pad = target - arr.shape[axis]
    if pad == 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def stack_tenants(cfg: ModelConfig, base_params: Params,
                  tenants: Sequence[CompressedModel],
                  device="cuda") -> TenantStack:
    """Build the serving stack on ``device`` from a base model and N
    compressed tenants (tensors are moved there as they are stacked)."""
    device = resolve_device(device)
    if not tenants:
        raise ValueError("need at least one tenant")
    t = len(tenants)
    delta_keys = sorted(tenants[0].deltas.keys())
    ref_shapes = {n: tuple(tenants[0].deltas[n].packed.shape)
                  for n in delta_keys}
    for i, c in enumerate(tenants):
        if sorted(c.deltas.keys()) != delta_keys:
            raise ValueError(
                f"tenant {i} delta keys {sorted(c.deltas.keys())} != "
                f"{delta_keys} — all tenants must be compressed the same way")
        for n in delta_keys:
            if tuple(c.deltas[n].packed.shape) != ref_shapes[n]:
                raise ValueError(
                    f"tenant {i} has mismatched {n} shape "
                    f"{tuple(c.deltas[n].packed.shape)} != {ref_shapes[n]}"
                    f" — all tenants must share the base architecture")
    if "embed" in delta_keys or "lm_head" in delta_keys:
        raise NotImplementedError("compressed embeddings are not ported yet")

    deltas = {}
    for name in delta_keys:
        packed = torch.stack([c.deltas[name].packed.to(device)
                              for c in tenants], dim=1)
        scale = torch.stack([c.deltas[name].scale.to(device, torch.float32)
                             for c in tenants], dim=1)
        deltas[name] = BinaryDelta(packed=packed, scale=scale)

    vocab_sizes = [int(c.extras["embed"].shape[0]) for c in tenants]
    vmax = max(vocab_sizes)
    params: Params = {
        "final_norm": torch.stack([c.extras["final_norm"].to(device)
                                   for c in tenants]),
        "layers": {
            name: torch.stack([c.extras[name].to(device) for c in tenants],
                              dim=1)
            for name in LAYER_EXTRA_NAMES if name in tenants[0].extras
        },
    }
    for name, w in base_params["layers"].items():
        if name not in LAYER_EXTRA_NAMES:
            params["layers"][name] = w.to(device)
    params["embed"] = torch.stack(
        [_pad_vocab(c.extras["embed"].to(device), vmax, 0) for c in tenants])
    if all("lm_head" in c.extras for c in tenants):
        params["lm_head"] = torch.stack(
            [_pad_vocab(c.extras["lm_head"].to(device), vmax, 1)
             for c in tenants])
    elif any("lm_head" in c.extras for c in tenants):
        raise ValueError("mixing tied and untied lm_head tenants")
    return TenantStack(params=params, deltas=deltas,
                       vocab_sizes=torch.tensor(vocab_sizes,
                                                dtype=torch.int32,
                                                device=device),
                       num_tenants=t)


def to_pair_layout(stack: TenantStack) -> TenantStack:
    """Convert delta stacks to the pair-packed serving layout of the pair
    decode kernel (single device). Projections whose N is not a multiple
    of 256 stay canonical; the model dispatch handles a mixed dict.
    Already-paired leaves pass through."""
    deltas = {}
    for name, d in stack.deltas.items():
        if isinstance(d, PairedBinaryDelta) or d.packed.shape[-1] % PAIR_BLOCK:
            deltas[name] = d
        else:
            deltas[name] = pair_delta(d)
    return stack._replace(deltas=deltas)


def stack_nbytes(stack: TenantStack) -> Dict[str, float]:
    """Serving memory: shared base vs per-tenant increments."""
    def nbytes(t):
        return t.numel() * t.element_size()

    base = sum(nbytes(w) for n, w in stack.params["layers"].items()
               if n not in LAYER_EXTRA_NAMES)
    packed = sum(sum(nbytes(leaf) for leaf in d)
                 for d in stack.deltas.values())
    extras = nbytes(stack.params["final_norm"])
    extras += sum(nbytes(w) for n, w in stack.params["layers"].items()
                  if n in LAYER_EXTRA_NAMES)
    extras += sum(nbytes(stack.params[n]) for n in ("embed", "lm_head")
                  if n in stack.params)
    return {"base_bytes": float(base), "deltas_bytes": float(packed),
            "tenant_extras_bytes": float(extras),
            "per_tenant_bytes": float((packed + extras) / stack.num_tenants)}
