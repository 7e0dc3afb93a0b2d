"""Strided sliding-window perplexity (port of ``bitdelta_tpu/eval/ppl.py``).

The reference evaluator's window protocol, unchanged:

  * the corpus is samples joined by "\\n\\n", tokenized once;
  * the token count is truncated to a multiple of ``stride`` (= the
    window size);
  * windows of ``context_size + window_size`` tokens start at every
    multiple of the stride while they still fit;
  * per window only the last ``stride`` targets count (shifted
    cross-entropy);
  * ppl = exp(mean over windows of each window's mean nll).

Windows run through the model one batch of ``batch_windows`` at a time,
on the device of the params.

Over a ``(data, model)`` mesh (``eval_ppl(mesh=)``, JAX's ``P(None,
"data")`` on each window) every rank takes a contiguous slice of each
window's positions and the weights are this rank's tensor-parallel
shards: the model gathers K/V over the data axis inside attention
(``forward(seq_group=)``), the logits are gathered over the model axis
before the softmax, each position's target comes from the whole window
(every rank holds it), and the windows' nll sums are summed over the data
axis.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from ..parallel.collectives import all_gather, axis_index, axis_size, psum
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import local_config


def window_starts(seq_len: int, context_size: int, window_size: int):
    """``(starts, max_length, stride)`` of the windows over ``seq_len``
    tokens."""
    stride = window_size
    max_length = context_size + window_size
    seq_len = seq_len - (seq_len % stride)
    starts = []
    for begin in range(0, seq_len, stride):
        if begin + max_length > seq_len:
            break
        starts.append(begin)
    return starts, max_length, stride


def _window_nll(cfg: ModelConfig, model, params, deltas,
                window: torch.Tensor, stride: int, compute_dtype,
                kernel: str, mesh=None) -> torch.Tensor:
    """Mean nll of the last ``stride`` targets of each row of a ``(B, T)``
    window batch. ``mesh``: this rank runs positions ``[t0, t0 + T/dp)``
    on its shard (``cfg`` its local one)."""
    t, dp = window.shape[1], axis_size(mesh, DATA_AXIS)
    chunk = t // dp
    t0 = axis_index(mesh, DATA_AXIS) * chunk
    kw = {} if mesh is None else dict(tp_group=mesh,
                                      seq_group=mesh if dp > 1 else None)
    logits = model.forward(cfg, params, window[:, t0:t0 + chunk],
                           deltas=deltas, compute_dtype=compute_dtype,
                           kernel=kernel, **kw).to(torch.float32)
    logits = all_gather(logits, mesh, MODEL_AXIS, dim=-1)
    # Shifted cross-entropy: logits at position p predict window[p + 1];
    # the window's last position predicts nothing.
    n = min(chunk, t - 1 - t0)
    logp = torch.log_softmax(logits[:, :n], dim=-1)
    targets = window[:, t0 + 1:t0 + 1 + n]
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    pos = t0 + torch.arange(n, device=window.device)
    keep = (pos >= t - 1 - stride).to(torch.float32)
    total = psum((nll * keep).sum(dim=-1), mesh, DATA_AXIS)
    return total / stride


def eval_ppl(cfg: ModelConfig, params, token_ids: np.ndarray, *,
             context_size: int = 1024, window_size: int = 512,
             deltas=None, compute_dtype=None, batch_windows: int = 1,
             model=None, kernel: str = "torch", mesh=None) -> float:
    """Perplexity of a 1-D token array under the model.

    ``deltas=None`` evaluates dense params (``core.compress.
    fuse_compressed`` first gives the reference's dense-fusion eval);
    passing a compressed model's deltas (with ``student_params``)
    evaluates through the delta path instead. ``model``: the decoder
    module (default llama; ``models.mixtral`` for MoE). ``kernel``: the
    model's dispatch (``"torch"`` is JAX's default ``"xla"``). The windows
    go to the device of ``params["embed"]``. ``mesh``: split each window's
    positions over the data axis, the params and deltas being this rank's
    shards already (``parallel/sharding.py``) and ``cfg`` the whole
    model's; the window length must divide by the data axis. With the
    sequence split (more than one rank on it) attention takes the plain
    path, as JAX's XLA attention."""
    model = model if model is not None else llama
    compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
    if mesh is not None:
        dp = axis_size(mesh, DATA_AXIS)
        if (context_size + window_size) % dp:
            raise ValueError(f"window length {context_size + window_size} "
                             f"must be a multiple of the data axis ({dp})")
        cfg = local_config(cfg, mesh)
    device = params["embed"].device
    token_ids = np.asarray(token_ids).reshape(-1)
    starts, max_length, stride = window_starts(len(token_ids), context_size,
                                               window_size)
    if not starts:
        raise ValueError(
            f"corpus too short: {len(token_ids)} tokens < window "
            f"{context_size + window_size}")
    windows = np.stack([token_ids[s:s + max_length] for s in starts])
    # Pad the window count to a batch multiple; padded windows weigh 0.
    nwin = len(windows)
    pad = (-nwin) % batch_windows
    if pad:
        reps = np.tile(windows, (pad // nwin + 1, 1))[:pad]
        windows = np.concatenate([windows, reps], axis=0)
    weights = np.concatenate([np.ones(nwin), np.zeros(pad)])
    nlls = []
    with torch.no_grad():
        for i in range(0, len(windows), batch_windows):
            w = torch.as_tensor(windows[i:i + batch_windows].astype(np.int64),
                                device=device)
            nlls.append(_window_nll(cfg, model, params, deltas, w, stride,
                                    compute_dtype, kernel, mesh
                                    ).cpu().numpy())
    nlls = np.concatenate(nlls)
    mean_nll = float((nlls * weights).sum() / weights.sum())
    return float(np.exp(mean_nll))


def tokenize_corpus(tokenizer, texts) -> np.ndarray:
    """Join samples with "\\n\\n" and tokenize once."""
    text = "".join(t + "\n\n" for t in texts)
    return np.asarray(tokenizer(text)["input_ids"], np.int64)
