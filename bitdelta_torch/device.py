"""Device and dtype helpers shared by the port's entry points."""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float32": torch.float32, "float16": torch.float16}


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``. Entry points default to
    ``"cuda"``; asking for the card where there is none raises instead of
    quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """A ``ModelConfig.dtype`` string (or a torch dtype) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]
