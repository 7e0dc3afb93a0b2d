"""Convert a reference BitDelta ``diff.pt`` artifact to the port's format
(port of ``bitdelta_tpu/tools/convert_reference.py``).

The reference saves a torch-pickled dict with, per compressed linear
``model.layers.{i}.<mod>.<proj>``:

  "<name>.mask"  — int32 packed signs ``(K//32, N)`` (K-axis LSB-first,
                   packed from the transposed weight: the layout of
                   ``ops/packing.py``), and
  "<name>.coeff" — fp32 scalar scale;

plus every trainable tensor of the student under its param name
(embeddings, norms, lm_head).

This tool maps those to a :class:`~bitdelta_torch.core.compress.
CompressedModel` (per-projection stacked ``(L, K//32, N)`` deltas +
extras) and writes a ``.safetensors`` delta artifact that either package
loads. The tensors stay torch from end to end (numpy arrays are
accepted too).

Usage:
  python -m bitdelta_torch.tools.convert_reference diff.pt out.safetensors
      [--device cpu]

Runs on the card; ``--device cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..core.compress import CompressedModel
from ..core.delta import BinaryDelta
from ..device import resolve_device, torch_dtype
from ..models.llama import PROJ_NAMES

_MASK_RE = re.compile(
    r"model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+_proj)\.(mask|coeff)")

_EXTRA_MAP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),   # (V, D) -> (D, V)
}
_LAYER_EXTRA_RE = re.compile(
    r"model\.layers\.(\d+)\.(input_layernorm|post_attention_layernorm)"
    r"\.weight")


def _host_tensor(val) -> torch.Tensor:
    """A torch tensor or numpy array as a CPU tensor; floating values
    widened to fp32 (the JAX converter's numpy step)."""
    t = (val.detach().to("cpu") if isinstance(val, torch.Tensor)
         else torch.from_numpy(np.array(val)))
    return t.float() if t.dtype.is_floating_point else t


def reference_dict_to_compressed(state: Dict[str, object],
                                 num_layers: Optional[int] = None,
                                 dtype=torch.bfloat16,
                                 device="cuda") -> CompressedModel:
    """Build a CompressedModel on ``device`` from a reference diff.pt dict.
    Extras take ``dtype``; the masks stay int32, the scales fp32."""
    device, dtype = resolve_device(device), torch_dtype(dtype)
    masks: Dict[str, dict] = {n: {} for n in PROJ_NAMES}
    coeffs: Dict[str, dict] = {n: {} for n in PROJ_NAMES}
    extras_raw: Dict[str, torch.Tensor] = {}
    layer_norms: Dict[str, dict] = {"attn_norm": {}, "mlp_norm": {}}

    for key, val in state.items():
        m = _MASK_RE.fullmatch(key)
        if m:
            idx, proj, field = int(m.group(1)), m.group(2), m.group(3)
            if proj not in PROJ_NAMES:
                raise ValueError(f"unknown projection in artifact: {key}")
            (masks if field == "mask" else coeffs)[proj][idx] = \
                _host_tensor(val)
            continue
        lm = _LAYER_EXTRA_RE.fullmatch(key)
        if lm:
            idx = int(lm.group(1))
            name = ("attn_norm" if lm.group(2) == "input_layernorm"
                    else "mlp_norm")
            layer_norms[name][idx] = _host_tensor(val)
            continue
        if key in _EXTRA_MAP:
            name, transpose = _EXTRA_MAP[key]
            t = _host_tensor(val)
            extras_raw[name] = t.t() if transpose else t
            continue
        # Unrecognized entries (e.g. LoRA A/B from the reference's hybrid
        # artifacts) are not representable as 1-bit deltas; surface them.
        raise ValueError(
            f"unsupported artifact entry {key!r}; convert LoRA factors "
            f"with research.variants.apply_lora before export")

    L = num_layers or (max(max(d) for d in masks.values() if d) + 1)
    deltas = {}
    for proj in PROJ_NAMES:
        missing = [i for i in range(L) if i not in masks[proj]]
        if missing:
            raise ValueError(f"missing {proj} masks for layers {missing}")
        packed = torch.stack([masks[proj][i] for i in range(L)])
        scale = torch.tensor([float(coeffs[proj][i]) for i in range(L)],
                             dtype=torch.float32)
        deltas[proj] = BinaryDelta(
            packed=packed.to(device=device, dtype=torch.int32),
            scale=scale.to(device))

    def on_device(t):
        return t.to(device=device, dtype=dtype).contiguous()

    extras = {}
    for name in ("embed", "final_norm", "lm_head"):
        if name in extras_raw:
            extras[name] = on_device(extras_raw[name])
    for name in ("attn_norm", "mlp_norm"):
        if len(layer_norms[name]) == L:
            extras[name] = on_device(
                torch.stack([layer_norms[name][i] for i in range(L)]))
    required = {"embed", "final_norm", "attn_norm", "mlp_norm"}
    missing = required - set(extras)
    if missing:
        raise ValueError(
            f"artifact lacks {sorted(missing)}; the reference stores these "
            f"for every compressed student — pass a complete diff.pt")
    return CompressedModel(deltas=deltas, extras=extras)


def convert(diff_pt_path: str, out_path: str, device="cuda") -> None:
    """Read a reference ``diff.pt`` and write the delta artifact."""
    from ..core.artifact import save_delta

    state = torch.load(diff_pt_path, map_location="cpu", weights_only=True)
    comp = reference_dict_to_compressed(state, device=device)
    save_delta(out_path, comp)
    print(f"wrote {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser("bitdelta_torch.tools.convert_reference")
    p.add_argument("diff_pt", help="the reference's diff.pt")
    p.add_argument("out", help="the .safetensors artifact to write")
    p.add_argument("--device", default="cuda",
                   help="where the tensors pass (default cuda)")
    args = p.parse_args(argv)
    convert(args.diff_pt, args.out, device=args.device)


if __name__ == "__main__":
    main()
