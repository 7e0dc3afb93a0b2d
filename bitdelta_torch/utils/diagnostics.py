"""Weight-statistics diagnostics (port of
``bitdelta_tpu/utils/diagnostics.py``): the per-layer correlation between
base and fine-tuned weights and the stddev of their difference, averaged
over every projection and layer; the train CLI writes them under
``--debug``."""

from __future__ import annotations

from typing import Dict

import torch

from ..models.llama import PROJ_NAMES

# Mixtral's matrices beside the attention projections (experts: a
# layer's E matrices taken as one vector, as its projections are).
_MOE_NAMES = ("w1", "w3", "w2", "router")


def stat_names(cfg):
    """The matrices :func:`weight_corr_stddev` takes of ``cfg``'s params."""
    if getattr(cfg, "num_experts", 0):
        from ..models.mixtral import ATTN_PROJS

        return list(ATTN_PROJS) + list(_MOE_NAMES)
    return list(PROJ_NAMES)


def weight_corr_stddev(base, fine) -> Dict[str, float]:
    """``{"corr": mean Pearson correlation, "stddev": mean population
    stddev of fine - base}`` over (projection, layer), in fp32 one layer
    at a time. Llama-family params take JAX's projections; Mixtral params
    (which JAX's function cannot take) add the experts and the router.
    A leaf may be any iterable of its layers (``cli/train.py`` reads them
    from the checkpoints one at a time)."""
    corrs, stds = [], []
    names = [n for n in PROJ_NAMES + _MOE_NAMES if n in base["layers"]]
    for name in names:
        for b, f in zip(base["layers"][name], fine["layers"][name]):
            bf = b.reshape(-1).to(torch.float32)
            ff = f.reshape(-1).to(torch.float32)
            bc = bf - bf.mean()
            fc = ff - ff.mean()
            corrs.append(torch.sum(bc * fc) / (
                torch.linalg.norm(bc) * torch.linalg.norm(fc) + 1e-12))
            stds.append(torch.std(ff - bf, correction=0))
    return {"corr": float(torch.stack(corrs).mean()),
            "stddev": float(torch.stack(stds).mean())}
