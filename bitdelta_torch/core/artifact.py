"""Delta artifact (de)serialization in the safetensors format, read and
written here without the ``safetensors`` package (port of
``bitdelta_tpu/core/artifact.py``; same keys and metadata, so a file
written by either package loads bit-exact in the other).

One file holds::

  deltas.{proj}.packed   int32  (L, K//32, N); Mixtral experts (L, E, K//32, N)
  deltas.{proj}.scale    fp32   (L,); Mixtral experts (L, E)
  extras.{name}          non-bf16 fine-tuned tensors
  extras_bf16.{name}     bf16 tensors as their uint16 bit pattern

and a ``__metadata__`` header with ``format_version``, ``model_config``
(JSON) and, for deltas taken against a quantized base, ``base_quant``. The file layout: an 8-byte little-endian header
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
from ..device import resolve_device
from ..models.config import ModelConfig

FORMAT_VERSION = 1

_ST_DTYPES = {"I32": np.int32, "F32": np.float32, "U16": np.uint16,
              "F16": np.float16, "I64": np.int64, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "F64": np.float64}
_NP_TO_ST = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def _st_array(value):
    """``(safetensors dtype, little-endian C-order numpy array)`` of a
    numpy array or a torch tensor; a bf16 tensor is written as ``BF16``
    from its int16 bit pattern."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.int16).numpy()
        value = t.numpy()
    # np.asarray keeps a 0-d array (an embed delta's scale) 0-d, where
    # np.ascontiguousarray would make it 1-d.
    arr = np.asarray(value, order="C")
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    return _NP_TO_ST[arr.dtype], arr


def write_safetensors(path: str, tensors: Dict[str, object],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays or torch tensors as a safetensors file."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name in sorted(tensors):
        st_dtype, arr = _st_array(tensors[name])
        header[name] = {"dtype": st_dtype,
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
            f.write(arr.reshape(-1).view(np.uint8).data)


def _read_header(path: str):
    """``(tensor entries, metadata, byte offset of the data)``."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def read_safetensors(path: str):
    """Returns ``(tensors: name -> numpy array, metadata: dict)``; the
    arrays are copies (BF16 tensors are not numpy's: read them with
    :func:`iter_safetensors`)."""
    meta = _read_header(path)[1]
    return {name: t.numpy().copy()
            for name, t in iter_safetensors(path)}, meta


def iter_safetensors(path: str):
    """Yield ``(name, CPU tensor)`` for every tensor of a safetensors file
    (an HF checkpoint shard or an artifact), in file order. Each tensor is
    a view of a copy-on-write memory map of the file, so nothing is read
    until the tensor is used; ``BF16`` comes as ``torch.bfloat16`` (its
    int16 bit pattern viewed). Needs no ``safetensors`` package."""
    header, _, start = _read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        st_dtype = info["dtype"]
        if st_dtype != "BF16" and st_dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has unsupported "
                             f"dtype {st_dtype}")
        dtype = np.dtype(np.int16 if st_dtype == "BF16"
                         else _ST_DTYPES[st_dtype]).newbyteorder("<")
        begin, end = info["data_offsets"]
        raw = mm[start + begin:start + end]
        if (start + begin) % dtype.itemsize:
            raw = np.array(raw)                  # an aligned copy
        t = torch.from_numpy(raw.view(dtype).reshape(info["shape"]))
        yield name, (t.view(torch.bfloat16) if st_dtype == "BF16" else t)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def save_delta(path: str, compressed: CompressedModel,
               cfg: Optional[ModelConfig] = None,
               base_quant: Optional[str] = None) -> None:
    """``base_quant``: how the base must be quantized at load time for
    the deltas to be exact (``"int8"`` / ``"int4"``: the deltas were taken
    against the quantize-dequantized base, research/quantized_base.py)."""
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
    if base_quant is not None:
        meta["base_quant"] = base_quant
    write_safetensors(path, tensors, meta)


def load_delta(path: str, device="cuda", return_meta: bool = False):
    """Returns ``(CompressedModel, ModelConfig | None)`` with tensors on
    ``device`` (the card unless the caller passes ``"cpu"``); with
    ``return_meta=True``, also the raw metadata dict (e.g.
    ``base_quant``)."""
    device = resolve_device(device)
    raw, meta = read_safetensors(path)
    if int(meta.get("format_version", "1")) > FORMAT_VERSION:
        raise ValueError("artifact written by a newer format version")
    cfg = None
    if "model_config" in meta:
        cfg_raw = json.loads(meta["model_config"])
        cls = ModelConfig
        if "num_experts" in cfg_raw:           # a Mixtral artifact
            from ..models.mixtral import MixtralConfig as cls
        cfg = cls.from_dict(cfg_raw)
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
    result = CompressedModel(deltas=deltas, extras=extras)
    if return_meta:
        return result, cfg, meta
    return result, cfg
