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
import itertools
import json
import os
import struct
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .compress import CompressedModel
from .delta import BinaryDelta
from ..device import resolve_device
from ..models.config import ModelConfig
from ..parallel.mesh import MODEL_AXIS

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


class Deferred(NamedTuple):
    """A tensor :func:`write_safetensors` makes only as it writes it (so a
    file of many large tensors never has them all at once): its torch
    dtype, its shape and a function that returns it."""

    dtype: torch.dtype
    shape: Tuple[int, ...]
    make: Callable[[], torch.Tensor]


def _deferred_header(value: Deferred):
    probe = torch.empty((0,), dtype=value.dtype)
    st_dtype = ("BF16" if value.dtype == torch.bfloat16
                else _NP_TO_ST[probe.numpy().dtype])
    nbytes = int(np.prod(value.shape, dtype=np.int64)) * probe.element_size()
    return st_dtype, nbytes


def write_safetensors(path: str, tensors: Dict[str, object],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write numpy arrays, torch tensors or :class:`Deferred` tensors as a
    safetensors file."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name in sorted(tensors):
        value = tensors[name]
        if isinstance(value, Deferred):
            (st_dtype, nbytes), shape, arr = (_deferred_header(value),
                                              value.shape, value)
        else:
            st_dtype, arr = _st_array(value)
            nbytes, shape = arr.nbytes, arr.shape
        header[name] = {"dtype": st_dtype,
                        "shape": list(shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
        arrays.append(arr)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)          # 8-byte aligned data start
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for arr in arrays:
            if isinstance(arr, Deferred):
                want = (_deferred_header(arr)[0], tuple(arr.shape))
                st_dtype, arr = _st_array(arr.make())
                if (st_dtype, arr.shape) != want:
                    raise ValueError(f"deferred tensor made {st_dtype} "
                                     f"{arr.shape}, declared {want}")
            f.write(arr.reshape(-1).view(np.uint8).data)


def read_header(path: str):
    """``(tensor entries, metadata, byte offset of the data)`` of a
    safetensors file, from its header alone."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    meta = header.pop("__metadata__", None) or {}
    return header, meta, 8 + n


def _np_dtype(path: str, name: str, st_dtype: str) -> np.dtype:
    """The little-endian numpy dtype a tensor is read as (``BF16`` as its
    int16 bit pattern)."""
    if st_dtype != "BF16" and st_dtype not in _ST_DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has unsupported "
                         f"dtype {st_dtype}")
    return np.dtype(np.int16 if st_dtype == "BF16"
                    else _ST_DTYPES[st_dtype]).newbyteorder("<")


def _as_torch(arr: np.ndarray, st_dtype: str) -> torch.Tensor:
    if arr.dtype == np.uint16:          # bf16 extras' bit patterns
        arr = arr.view(np.int16)
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if st_dtype == "BF16" else t


def _pread_into(fd: int, buf: memoryview, offset: int) -> None:
    while len(buf):
        n = os.preadv(fd, [buf], offset)
        if n <= 0:
            raise EOFError(f"short read at byte {offset}")
        buf, offset = buf[n:], offset + n


class StoredTensor(NamedTuple):
    """One tensor of a safetensors file, known from the header alone;
    nothing of it is read until :meth:`read`."""

    path: str
    name: str
    st_dtype: str
    shape: Tuple[int, ...]
    offset: int                  # byte offset of its data in the file

    @property
    def nbytes(self) -> int:
        itemsize = _np_dtype(self.path, self.name, self.st_dtype).itemsize
        return int(np.prod(self.shape, dtype=np.int64)) * itemsize

    def read(self, block=None, meta: bool = False) -> torch.Tensor:
        """The block ``block`` (one ``(start, size)`` a dim; default the
        whole tensor) as a new CPU tensor, read run by run with
        ``os.preadv`` into a buffer of the block's size: nothing more is
        held and no page of the file is mapped into the process. Rows past
        the tensor's end come as zeros (a vocabulary padded to a larger
        one). ``meta=True``: the block's shape and dtype alone, nothing
        read."""
        dtype = _np_dtype(self.path, self.name, self.st_dtype)
        if block is None:
            block = [(0, n) for n in self.shape]
        out_shape = tuple(size for _, size in block)
        if meta:
            return _as_torch(np.zeros((0,), dtype), self.st_dtype).new_empty(
                out_shape, device="meta")
        # The part of the block inside the tensor; the rest stays zero.
        inner = [(start, max(0, min(start + size, n) - start))
                 for (start, size), n in zip(block, self.shape)]
        out = np.zeros(out_shape, dtype)
        if all(size for _, size in inner):
            dst = out if [s for _, s in inner] == list(out_shape) else \
                np.empty([s for _, s in inner], dtype)
            self._read_runs(inner, dst)
            if dst is not out:
                out[tuple(slice(0, s) for _, s in inner)] = dst
        return _as_torch(out, self.st_dtype)

    def _read_runs(self, inner, dst: np.ndarray) -> None:
        """Fill ``dst`` with the block ``inner``: one read for each run of
        bytes contiguous in the file (the dims after the last one taken
        in part are whole)."""
        shape = self.shape
        part = [d for d, ((start, size), n) in enumerate(zip(inner, shape))
                if (start, size) != (0, n)]
        p = part[-1] if part else -1
        strides = [int(np.prod(shape[d + 1:], dtype=np.int64))
                   for d in range(len(shape))]
        itemsize = dst.dtype.itemsize
        run = (inner[p][1] * strides[p] if p >= 0
               else int(np.prod(shape, dtype=np.int64))) * itemsize
        flat = memoryview(dst.reshape(-1).view(np.uint8))
        base = inner[p][0] * strides[p] if p >= 0 else 0
        with open(self.path, "rb", buffering=0) as f:
            fd = f.fileno()
            outer = itertools.product(*(range(start, start + size)
                                        for start, size in inner[:max(p, 0)]))
            for k, idx in enumerate(outer):
                elem = base + sum(i * st for i, st in zip(idx, strides))
                _pread_into(fd, flat[k * run:(k + 1) * run],
                            self.offset + elem * itemsize)


def stored_tensors(path: str):
    """``(name, StoredTensor)`` of every tensor of a safetensors file, in
    file order, from its header alone."""
    header, _, start = read_header(path)
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        _np_dtype(path, name, info["dtype"])
        yield name, StoredTensor(path, name, info["dtype"],
                                 tuple(info["shape"]),
                                 start + info["data_offsets"][0])


def read_safetensors(path: str):
    """Returns ``(tensors: name -> numpy array, metadata: dict)``; the
    arrays are copies (BF16 tensors are not numpy's: read them with
    :func:`iter_safetensors`)."""
    meta = read_header(path)[1]
    return {name: t.numpy().copy()
            for name, t in iter_safetensors(path)}, meta


def iter_safetensors(path: str):
    """Yield ``(name, CPU tensor)`` for every tensor of a safetensors file
    (an HF checkpoint shard or an artifact), in file order. Each tensor is
    a view of a copy-on-write memory map of the file, so nothing is read
    until the tensor is used; ``BF16`` comes as ``torch.bfloat16`` (its
    int16 bit pattern viewed). Needs no ``safetensors`` package."""
    header, _, start = read_header(path)
    mm = np.memmap(path, dtype=np.uint8, mode="c")
    for name, info in sorted(header.items(),
                             key=lambda kv: kv[1]["data_offsets"][0]):
        st_dtype = info["dtype"]
        dtype = _np_dtype(path, name, st_dtype)
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


def _config(meta) -> Optional[ModelConfig]:
    if "model_config" not in meta:
        return None
    cfg_raw = json.loads(meta["model_config"])
    cls = ModelConfig
    if "num_experts" in cfg_raw:           # a Mixtral artifact
        from ..models.mixtral import MixtralConfig as cls
    return cls.from_dict(cfg_raw)


def _stored_blocks(path: str, device: torch.device, mesh, vocab, cfg):
    """``(name -> this rank's block of each tensor, metadata)``: see
    :func:`load_delta`."""
    from ..parallel.sharding import block_of, delta_specs, extras_specs

    _, meta, _ = read_header(path)
    entries = list(stored_tensors(path))
    cfg = cfg or _config(meta)
    if mesh is not None and cfg is None:
        raise ValueError(f"{path} holds no model_config: pass cfg= to "
                         f"load it over a mesh")
    fields = [key.split(".") for key, _ in entries]
    dspecs = delta_specs(cfg, keys={f[1] for f in fields
                                    if f[0] == "deltas"}) if cfg else {}
    especs = extras_specs(cfg, keys={f[1] for f in fields
                                     if f[0] != "deltas"}) if cfg else {}
    raw = {}
    for (kind, name, *field), (key, stored) in zip(fields, entries):
        spec, shape = (), list(stored.shape)
        if kind == "deltas":
            spec = getattr(dspecs[name], field[0]) if cfg else ()
        elif cfg:
            spec = especs[name]
            if vocab is not None and name in ("embed", "lm_head"):
                # (V, D) / (D, V): the vocabulary dim is the sharded one.
                shape[spec.index(MODEL_AXIS)] = vocab
        raw[key] = stored.read(block_of(shape, spec, mesh),
                               meta=device.type == "meta").to(device)
    return raw, meta


def load_delta(path: str, device="cuda", return_meta: bool = False, *,
               mesh=None, vocab: Optional[int] = None,
               cfg: Optional[ModelConfig] = None):
    """Returns ``(CompressedModel, ModelConfig | None)`` with tensors on
    ``device`` (the card unless the caller passes ``"cpu"``); with
    ``return_meta=True``, also the raw metadata dict (e.g.
    ``base_quant``).

    ``mesh``: this rank's blocks alone (``parallel/sharding.py::
    shard_tree``'s of the whole under ``delta_specs`` and
    ``extras_specs``), each read straight from the file
    (:meth:`StoredTensor.read`); ``vocab``: the embed's rows and the
    head's columns are this rank's of the vocabulary padded with zeros to
    ``vocab`` (a serving stack's largest, ``stacking.stack_tenants``'s
    padding). ``cfg``: the model's config where the artifact holds none
    (the specs need it). ``device="meta"``: shapes and dtypes from the
    header alone, nothing read."""
    device = resolve_device(device)
    if mesh is None and device.type != "meta":
        arrays, meta = read_safetensors(path)
        raw = {key: torch.from_numpy(arr.view(np.int16)
                                     if arr.dtype == np.uint16 else arr)
               for key, arr in arrays.items()}
    else:
        raw, meta = _stored_blocks(path, device, mesh, vocab, cfg)
    if int(meta.get("format_version", "1")) > FORMAT_VERSION:
        raise ValueError("artifact written by a newer format version")
    cfg = _config(meta)
    deltas_raw: dict = {}
    extras: dict = {}
    for key, t in raw.items():
        if key.startswith("deltas."):
            _, proj, field = key.split(".")
            deltas_raw.setdefault(proj, {})[field] = t
        elif key.startswith("extras_bf16."):
            extras[key[len("extras_bf16."):]] = t.view(
                torch.bfloat16).to(device)
        elif key.startswith("extras."):
            extras[key[len("extras."):]] = t.to(device)
    deltas = {
        proj: BinaryDelta(packed=f["packed"].to(device),
                          scale=f["scale"].to(torch.float32).to(device))
        for proj, f in deltas_raw.items()
    }
    result = CompressedModel(deltas=deltas, extras=extras)
    if return_meta:
        return result, cfg, meta
    return result, cfg
