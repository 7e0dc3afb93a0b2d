"""Scale distillation (port of ``bitdelta_tpu/train/distill.py``): refine
the per-matrix delta scales against the fine-tuned teacher's logits.

* teacher = the fine-tune (frozen, plain path, no gradient); student =
  base weights + 1-bit deltas whose scales are the only leaves with
  ``requires_grad``;
* loss = mean squared error over the full fp32 logits;
* AdamW (betas 0.9/0.999, eps 1e-8, weight decay 0.01: ``optax.adamw``'s
  defaults) with optax's cosine decay of the learning rate over
  ``num_steps`` (0 past the end, unlike ``CosineAnnealingLR``).

``kernel="cuda"`` runs the student through the CUDA kernels' autograd
Functions (the binary matmul forward and its transposed kernel backward,
flash prefill with its blockwise backward), the counterpart of JAX's
``"pallas_train"``; ``"torch"`` runs the plain path, JAX's ``"xla"``.
``model=`` picks the decoder (llama by default; ``models.mixtral``
distills the attention, expert and router scales: its attention
projections take the same kernel route, the experts and the router the
plain path, as JAX leaves them to XLA).

``mesh=`` runs the step over a ``(data, model)`` mesh, one process a rank
(JAX's ``make_distill_step(mesh=)``, where GSPMD splits the batch rows
over ``data`` and the weights over ``model``): each rank holds its
shards of the base, the fine-tune and the compressed model
(``parallel/sharding.py``) and takes its rows of every batch. The loss is
each rank's sum of squared logit differences over its rows and its
vocabulary slice, over the whole batch's ``B * S * V``, summed over the
model axis (Megatron's ``reduce_from_model``) and then over the data
axis. Before AdamW each scale's gradient is summed over the model axis
when its delta is split there (a delta whole on every rank, Mixtral's
router, already has its whole gradient on each) and over the data axis;
every rank then takes the same step, so the scales stay equal on every
rank. Rank 0 alone writes the checkpoint, which every rank reads.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.artifact import read_safetensors, write_safetensors
from ..core.compress import (CompressedModel, get_scales, student_params,
                             with_scales)
from ..core.delta import BinaryDelta
from ..device import torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from ..parallel.collectives import (axis_index, axis_size, psum,
                                    reduce_from_model)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import delta_specs, local_config
from ..utils.profiling import RECORDER

KERNELS = ("auto", "cuda", "torch")


class DistillConfig(NamedTuple):
    lr: float = 1e-4
    num_steps: int = 100
    weight_decay: float = 0.01
    compute_dtype: str = "bfloat16"
    kernel: str = "auto"      # "auto": "cuda" for params on the card


def cosine_lr(lr: float, num_steps: int, step: int) -> float:
    """``optax.cosine_decay_schedule(lr, num_steps)`` at ``step`` (counted
    from 0): ``lr * (1 + cos(pi * min(step, T) / T)) / 2``."""
    t = min(step, num_steps)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / num_steps))


def resolve_kernel(kernel: str, device: torch.device) -> str:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return kernel


def make_optimizer(scales: Dict[str, torch.Tensor], dcfg: DistillConfig
                   ) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(scales.values()), lr=dcfg.lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=dcfg.weight_decay)


def _adam_step(optimizer: torch.optim.Optimizer) -> int:
    """Updates taken so far (the schedule's count, as optax keeps it in
    the optimizer state)."""
    state = optimizer.state.get(optimizer.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def _sum_grads(scales: Dict[str, torch.Tensor], names, mesh,
               axis: str) -> None:
    """Sum the gradients of ``scales[names]`` over ``axis`` in place (one
    all-reduce for them all)."""
    names = [n for n in names if n in scales]
    if axis_size(mesh, axis) == 1 or not names:
        return
    grads = [scales[n].grad if scales[n].grad is not None
             else torch.zeros_like(scales[n]) for n in names]
    flat = psum(torch.cat([g.reshape(-1) for g in grads]), mesh, axis)
    for n, part in zip(names, flat.split([g.numel() for g in grads])):
        scales[n].grad = part.reshape(scales[n].shape)


def make_distill_step(cfg: ModelConfig, dcfg: DistillConfig, base_params,
                      finetuned_params, compressed: CompressedModel,
                      scales: Dict[str, torch.Tensor],
                      optimizer: torch.optim.Optimizer, model=None,
                      mesh=None):
    """The step ``batch (B, S) int64 -> loss`` (a detached 0-d fp32
    tensor). It updates ``scales`` in place through ``optimizer`` and
    leaves this step's gradients in ``scales[name].grad`` (over a mesh,
    summed as the step took them). ``model``: the decoder module (default
    llama; ``models.mixtral`` for MoE, whose student params come from
    ``mixtral_student_params``). ``mesh``: the params and ``compressed``
    are this rank's shards, ``cfg`` the whole model's, and ``batch`` the
    whole batch (``B`` a multiple of the data axis)."""
    model = model if model is not None else llama
    compute_dtype = torch_dtype(dcfg.compute_dtype)
    if model is llama:
        s_params = student_params(base_params, compressed)
    else:
        s_params = model.mixtral_student_params(base_params, compressed)
    packed = {name: d.packed for name, d in compressed.deltas.items()}
    kernel = resolve_kernel(dcfg.kernel, base_params["embed"].device)
    run_cfg, dp, sharded = cfg, 1, ()
    if mesh is not None:
        run_cfg = local_config(cfg, mesh)
        dp = axis_size(mesh, DATA_AXIS)
        specs = delta_specs(cfg, keys=packed.keys())
        sharded = [n for n in packed if MODEL_AXIS in specs[n].packed]

    def step(batch: torch.Tensor) -> torch.Tensor:
        with RECORDER.span("distill.step", tokens=batch.numel()):
            return phases(batch)

    def phases(batch: torch.Tensor) -> torch.Tensor:
        lr = cosine_lr(dcfg.lr, dcfg.num_steps, _adam_step(optimizer))
        for group in optimizer.param_groups:
            group["lr"] = lr
        b, s = batch.shape
        if b % dp:
            raise ValueError(f"batch {b} must be a multiple of the data "
                             f"axis ({dp})")
        rows = b // dp
        batch = batch[axis_index(mesh, DATA_AXIS) * rows:][:rows]
        with RECORDER.span("distill.teacher"), torch.no_grad():
            teacher = model.forward(run_cfg, finetuned_params, batch,
                                    compute_dtype=compute_dtype,
                                    kernel="torch", tp_group=mesh)
        with RECORDER.span("distill.student"):
            deltas = {name: BinaryDelta(packed=packed[name],
                                        scale=scales[name])
                      for name in packed}
            student = model.forward(run_cfg, s_params, batch, deltas=deltas,
                                    compute_dtype=compute_dtype,
                                    kernel=kernel, tp_group=mesh)
            diff = (teacher - student).to(torch.float32)
            if mesh is None:
                loss = torch.mean(diff * diff)
            else:
                whole = b * s * diff.shape[-1] * axis_size(mesh, MODEL_AXIS)
                loss = reduce_from_model((diff * diff).sum() / whole, mesh)
        with RECORDER.span("distill.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                _sum_grads(scales, sharded, mesh, MODEL_AXIS)
                _sum_grads(scales, list(scales), mesh, DATA_AXIS)
                loss = psum(loss.detach(), mesh, DATA_AXIS)
        with RECORDER.span("distill.optimizer"):
            optimizer.step()
        return loss.detach()

    return step


def save_distill_checkpoint(path: str, step: int,
                            scales: Dict[str, torch.Tensor],
                            optimizer: torch.optim.Optimizer) -> None:
    """Training state (scales, AdamW moments, step) as a safetensors file,
    written to a temporary name and moved into place."""
    state = optimizer.state_dict()["state"]
    tensors = {}
    for i, (name, s) in enumerate(scales.items()):
        tensors[f"scales.{name}"] = s.detach().cpu().numpy()
        tensors[f"exp_avg.{name}"] = state[i]["exp_avg"].cpu().numpy()
        tensors[f"exp_avg_sq.{name}"] = state[i]["exp_avg_sq"].cpu().numpy()
    tmp = f"{path}.tmp"
    write_safetensors(tmp, tensors, {"step": str(step)})
    os.replace(tmp, path)


def load_distill_checkpoint(path: str, scales: Dict[str, torch.Tensor],
                            optimizer: torch.optim.Optimizer) -> int:
    """Restore what :func:`save_distill_checkpoint` wrote into ``scales``
    (in place) and ``optimizer``; returns the step to resume at."""
    raw, meta = read_safetensors(path)
    step = int(meta["step"])
    state = {}
    with torch.no_grad():
        for i, (name, s) in enumerate(scales.items()):
            s.copy_(torch.from_numpy(raw[f"scales.{name}"]))
            state[i] = {"step": torch.tensor(float(step)),
                        "exp_avg": torch.from_numpy(raw[f"exp_avg.{name}"]),
                        "exp_avg_sq": torch.from_numpy(
                            raw[f"exp_avg_sq.{name}"])}
    sd = optimizer.state_dict()
    sd["state"] = state
    optimizer.load_state_dict(sd)
    return step


def distill_scales(cfg: ModelConfig, base_params, finetuned_params,
                   compressed: CompressedModel, batches,
                   dcfg: DistillConfig = DistillConfig(), *,
                   mesh=None, progress: bool = False, model=None,
                   checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 0
                   ) -> Tuple[CompressedModel, List[float]]:
    """Run scale distillation; returns (calibrated model, loss history).

    ``batches``: ``(B, S)`` token batches (an array or an iterable); the
    schedule spans ``dcfg.num_steps`` however many are given. The
    caller's ``compressed`` is untouched: training works on copies of
    its scales. With ``checkpoint_path`` and ``checkpoint_every`` the
    state is saved every ``checkpoint_every`` steps; when the file
    exists, the run resumes from it and, given the same batches, lands
    on the trajectory of a run without a break. ``model``: the decoder
    module and ``mesh`` the mesh, as :func:`make_distill_step` takes them
    (over a mesh the calibrated model returned is this rank's shard, and
    rank 0 alone writes the checkpoint).
    """
    device = base_params["embed"].device
    scales = {name: s.detach().to(torch.float32).clone().requires_grad_()
              for name, s in get_scales(compressed).items()}
    optimizer = make_optimizer(scales, dcfg)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        start = load_distill_checkpoint(checkpoint_path, scales, optimizer)
        if progress:
            print(f"[distill] resuming from {checkpoint_path} at step "
                  f"{start}", flush=True)
    step = make_distill_step(cfg, dcfg, base_params, finetuned_params,
                             compressed, scales, optimizer, model=model,
                             mesh=mesh)
    writer = mesh is None or dist.get_rank() == 0
    losses: List[float] = []
    for i, batch in enumerate(batches):
        if i < start:
            continue
        tokens = torch.as_tensor(np.asarray(batch), device=device).long()
        loss = step(tokens)
        with RECORDER.span("distill.readback"):
            losses.append(float(loss))
        if progress and i % 10 == 0:
            print(f"[distill] step {i}: loss {losses[-1]:.6f}", flush=True)
        if (checkpoint_path and checkpoint_every and writer
                and (i + 1) % checkpoint_every == 0):
            save_distill_checkpoint(checkpoint_path, i + 1, scales,
                                    optimizer)
    return with_scales(compressed, scales), losses
