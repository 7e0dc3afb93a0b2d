"""Delta artifact (de)serialization in the safetensors format, read and
written here without the ``safetensors`` package (port of
``bitdelta_tpu/core/artifact.py``; same keys and metadata, so a file
written by either package loads bit-exact in the other).

One file holds::

  deltas.{proj}.packed   int32  (L, K//32, N)
  deltas.{proj}.scale    fp32   (L,)
  extras.{name}          non-bf16 fine-tuned tensors
  extras_bf16.{name}     bf16 tensors as their uint16 bit pattern

and a ``__metadata__`` header with ``format_version`` and
``model_config`` (JSON). The file layout: an 8-byte little-endian header
length, the JSON header (tensor name -> dtype, shape, data offsets), then
the raw little-endian buffers back to back.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Dict, Optional

import numpy as np
import torch

from .compress import CompressedModel
from .delta import BinaryDelta
from ..models.config import ModelConfig

FORMAT_VERSION = 1

_ST_DTYPES = {"I32": np.int32, "F32": np.float32, "U16": np.uint16,
              "F16": np.float16, "I64": np.int64, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "F64": np.float64}
_NP_TO_ST = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, np.ndarray],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays as a safetensors file."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        header[name] = {"dtype": _NP_TO_ST[arr.dtype],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)          # 8-byte aligned data start
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            f.write(arr.tobytes())


def read_safetensors(path: str):
    """Returns ``(tensors: name -> numpy array, metadata: dict)``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    meta = header.pop("__metadata__", None) or {}
    tensors = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        dtype = np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(data, dtype=dtype, count=(end - begin)
                            // dtype.itemsize, offset=begin)
        tensors[name] = arr.reshape(info["shape"]).copy()
    return tensors, meta


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def save_delta(path: str, compressed: CompressedModel,
               cfg: Optional[ModelConfig] = None) -> None:
    tensors = {}
    for name, d in compressed.deltas.items():
        tensors[f"deltas.{name}.packed"] = _to_numpy(d.packed)
        tensors[f"deltas.{name}.scale"] = _to_numpy(
            d.scale.to(torch.float32))
    for name, t in compressed.extras.items():
        if t.dtype == torch.bfloat16:
            # bf16 round-trips as its uint16 bit pattern (bit-exact).
            tensors[f"extras_bf16.{name}"] = _to_numpy(
                t.view(torch.int16)).view(np.uint16)
        else:
            tensors[f"extras.{name}"] = _to_numpy(t)
    meta = {"format_version": str(FORMAT_VERSION)}
    if cfg is not None:
        meta["model_config"] = json.dumps(dataclasses.asdict(cfg))
    write_safetensors(path, tensors, meta)


def load_delta(path: str, device="cpu"):
    """Returns ``(CompressedModel, ModelConfig | None)`` with tensors on
    ``device``."""
    raw, meta = read_safetensors(path)
    if int(meta.get("format_version", "1")) > FORMAT_VERSION:
        raise ValueError("artifact written by a newer format version")
    cfg = None
    if "model_config" in meta:
        cfg_raw = json.loads(meta["model_config"])
        if "num_experts" in cfg_raw:
            raise NotImplementedError("Mixtral artifacts are not ported yet")
        cfg = ModelConfig.from_dict(cfg_raw)
    deltas_raw: dict = {}
    extras: dict = {}
    for key, arr in raw.items():
        if key.startswith("deltas."):
            _, proj, field = key.split(".")
            deltas_raw.setdefault(proj, {})[field] = torch.from_numpy(arr)
        elif key.startswith("extras_bf16."):
            extras[key[len("extras_bf16."):]] = torch.from_numpy(
                arr.view(np.int16)).view(torch.bfloat16).to(device)
        elif key.startswith("extras."):
            extras[key[len("extras."):]] = torch.from_numpy(arr).to(device)
    deltas = {
        proj: BinaryDelta(packed=f["packed"].to(device),
                          scale=f["scale"].to(torch.float32).to(device))
        for proj, f in deltas_raw.items()
    }
    return CompressedModel(deltas=deltas, extras=extras), cfg
