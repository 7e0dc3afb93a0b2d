"""Shared CLI flags (port of ``bitdelta_tpu/cli/args.py``): the same flag
groups, with the port's kernel routes and a ``--device``.

``--kernel``: ``auto`` (``cuda`` on the card, ``torch`` on the CPU),
``cuda`` (the hand-written kernels), ``cuda_fused`` (base and delta in one
kernel at each decode projection over a dense base) or ``torch`` (the
plain paths). ``--device``: ``cuda`` by default; ``cpu`` runs on the CPU
(asking for the card where there is none raises). ``--mesh dp,tp``:
``serve`` and ``train`` run one process a rank under ``python -m
torch.distributed.run --nproc-per-node dp*tp`` (:func:`make_cli_mesh`);
``eval_ppl`` takes the flag and runs on one device, as JAX's does.
"""

from __future__ import annotations

import argparse

import torch

KERNELS = ("auto", "cuda", "cuda_fused", "torch")


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("--base_model", type=str, required=True,
                   help="local HF checkpoint dir of the base model")
    p.add_argument("--finetuned_model", type=str, default=None,
                   help="local HF checkpoint dir of the fine-tune")


def add_train_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset_name", type=str, default="c4")
    p.add_argument("--subset", type=str, default="en")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--text_file", type=str, default=None,
                   help="offline calibration text file")
    p.add_argument("--lr", type=float, default=1e-4,
                   help="scale-distillation AdamW lr")
    p.add_argument("--num_steps", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_length", type=int, default=128)
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--save_full_model", action="store_true")
    p.add_argument("--compress_embeddings", action="store_true",
                   help="also 1-bit-compress embeddings and lm_head "
                        "against the base (requires matching vocab)")
    p.add_argument("--zero_sign", type=str, default="positive",
                   choices=("positive", "balance"),
                   help="sign bit for exact-zero deltas: 'positive' = all "
                        "+1 (the reference's); 'balance' = checkerboard +-1")
    p.add_argument("--quantize_base", type=str, default=None,
                   choices=("int8", "int4"),
                   help="W8+W1 / W4+W1: quantize the base projections; "
                        "deltas are taken against the dequantized base and "
                        "serving streams the quantized base")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of the "
                        "distillation loop, with the program's host "
                        "spans on the kernels' clock, into this dir")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="save distillation state (scales + optimizer) to "
                        "save_dir/distill_ckpt.safetensors every N steps "
                        "and resume from it (0 = off)")


def add_ppl_args(p: argparse.ArgumentParser):
    p.add_argument("--dataset_name", type=str, default="wikitext")
    p.add_argument("--subset", type=str, default="wikitext-2-raw-v1")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--num_eval_samples", type=int, default=100)
    p.add_argument("--context_size", type=int, default=1024)
    p.add_argument("--window_size", type=int, default=512)
    p.add_argument("--model_diff", type=str, default=None,
                   help="delta artifact (.safetensors); omit = eval base")
    p.add_argument("--text_file", type=str, default=None,
                   help="offline corpus file instead of an HF dataset")
    p.add_argument("--save_dir", type=str, default=".")


def add_mesh_args(p: argparse.ArgumentParser):
    p.add_argument("--mesh", type=str, default=None,
                   help="'dp,tp' mesh shape: serve and train run one rank "
                        "a device under python -m torch.distributed.run "
                        "--nproc-per-node dp*tp; eval_ppl runs on one "
                        "device, as JAX's")
    p.add_argument("--dtype", type=str, default="bfloat16")
    p.add_argument("--kernel", type=str, default="auto", choices=KERNELS,
                   help="auto: cuda on the card, torch on the CPU")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")


def parse_mesh(spec):
    """``(dp, tp)`` of ``--mesh``, or None."""
    if spec is None:
        return None
    dp, tp = (int(x) for x in spec.split(","))
    return (dp, tp)


def make_cli_mesh(spec, device):
    """The ``(data, model)`` mesh of ``--mesh`` over a world of exactly
    ``dp * tp`` processes (None without the flag). Made before any weight
    loads: it puts the rank on its card. A world of another size exits,
    naming the launcher that starts one process a rank."""
    shape = parse_mesh(spec)
    if shape is None:
        return None
    import torch.distributed as dist

    from ..parallel import mesh as pmesh

    needed = shape[0] * shape[1]
    hint = (f"; start one process a rank with python -m "
            f"torch.distributed.run --nproc-per-node {needed}")
    try:
        mesh = pmesh.make_mesh(shape, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e}{hint}") from e
    if dist.get_world_size() != needed:
        raise SystemExit(f"--mesh {spec} needs {needed} processes, got "
                         f"{dist.get_world_size()}{hint}")
    return mesh


def resolve_kernel(kernel: str, device: torch.device) -> str:
    if kernel == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return kernel
