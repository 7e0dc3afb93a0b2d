"""Compression + scale-distillation pipeline CLI (port of
``bitdelta_tpu/cli/train.py``): load base and fine-tune, 1-bit-compress
the delta, distill the scales on calibration data, save
``diff_untrained.safetensors`` and ``diff.safetensors``, optionally
export the dense-fused model.

Usage:
  python -m bitdelta_torch.cli.train --base_model <dir> --finetuned_model \\
      <dir> --save_dir out/ [--num_steps 200 --batch_size 4]

Runs on the card; ``--device cpu`` runs on the CPU. The
``--checkpoint_every`` file is the port's own safetensors checkpoint
(``distill_ckpt.safetensors``), not JAX's npz.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

from . import args as A
from ..core.artifact import save_delta
from ..core.compress import compress_model, fuse_compressed
from ..device import resolve_device, torch_dtype
from ..models import llama, resolve_model_module
from ..models.hf_import import load_hf_params
from ..train.data import get_calibration_batches
from ..train.distill import DistillConfig, distill_scales
from ..utils.tokenizer import get_tokenizer


def main(argv=None):
    p = argparse.ArgumentParser("bitdelta_torch.train")
    A.add_model_args(p)
    A.add_train_args(p)
    A.add_mesh_args(p)
    args = p.parse_args(argv)
    A.refuse_mesh(args.mesh)
    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)

    dtype = torch_dtype(args.dtype)
    print(f"loading base {args.base_model} ...", flush=True)
    cfg, base = load_hf_params(args.base_model, dtype=dtype, device=device)
    print(f"loading fine-tune {args.finetuned_model} ...", flush=True)
    fcfg, fine = load_hf_params(args.finetuned_model, dtype=dtype,
                                device=device)
    if (fcfg.hidden_size, fcfg.num_layers) != (cfg.hidden_size, cfg.num_layers):
        raise ValueError("base and fine-tune architectures differ")

    model_mod = resolve_model_module(cfg)
    is_mixtral = model_mod is not llama
    if is_mixtral:
        for flag in ("quantize_base", "save_full_model"):
            if getattr(args, flag):
                raise SystemExit(f"--{flag} is not supported for Mixtral")

    if args.quantize_base:
        # W{8,4}+W1: replace the base projections with their quantized
        # round trip BEFORE compressing and distilling, so the deltas and
        # the distilled scales are exact for quantized-base serving.
        from ..research.quantized_base import roundtrip_base

        print(f"quantizing base projections ({args.quantize_base}) ...",
              flush=True)
        base = roundtrip_base(base, args.quantize_base, dtype)

    if args.debug:
        from ..utils.diagnostics import weight_corr_stddev
        stats = weight_corr_stddev(base, fine)
        with open(os.path.join(args.save_dir, "corr_stddev.csv"), "w") as f:
            f.write(f"corr,stddev\n{stats['corr']},{stats['stddev']}\n")

    print("compressing diff...", flush=True)
    if is_mixtral:  # attn + experts + router (+ embed/head) deltas
        comp = model_mod.compress_mixtral(
            base, fine, compress_embeddings=args.compress_embeddings,
            zero_sign=args.zero_sign)
    else:
        comp = compress_model(base, fine,
                              compress_embeddings=args.compress_embeddings,
                              zero_sign=args.zero_sign)
    save_delta(os.path.join(args.save_dir, "diff_untrained.safetensors"),
               comp, fcfg, base_quant=args.quantize_base)

    tokenizer = get_tokenizer(args.finetuned_model or args.base_model)
    batches = get_calibration_batches(
        tokenizer, num_steps=args.num_steps, batch_size=args.batch_size,
        max_length=args.max_length, dataset_name=args.dataset_name,
        subset=args.subset, split=args.split, text_file=args.text_file,
        vocab_size=cfg.vocab_size)

    # The fused route differs from "cuda" only at decode.
    kernel = A.resolve_kernel(args.kernel, device)
    kernel = "cuda" if kernel == "cuda_fused" else kernel
    dcfg = DistillConfig(lr=args.lr, num_steps=args.num_steps,
                         compute_dtype=args.dtype, kernel=kernel)
    profile_ctx = contextlib.nullcontext()
    if args.profile_dir:
        from ..utils.profiling import trace

        profile_ctx = trace(args.profile_dir)
    ckpt = (os.path.join(args.save_dir, "distill_ckpt.safetensors")
            if args.checkpoint_every else None)
    with profile_ctx:
        comp, losses = distill_scales(cfg, base, fine, comp, batches, dcfg,
                                      progress=True, model=model_mod,
                                      checkpoint_path=ckpt,
                                      checkpoint_every=args.checkpoint_every)
    print(f"distill loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    if args.debug:
        with open(os.path.join(args.save_dir, "train_loss.json"), "w") as f:
            json.dump(losses, f)

    save_delta(os.path.join(args.save_dir, "diff.safetensors"), comp, fcfg,
               base_quant=args.quantize_base)
    print(f"saved {os.path.join(args.save_dir, 'diff.safetensors')}")

    if args.save_full_model:
        from ..core.export import save_full_model
        save_full_model(cfg, fuse_compressed(base, comp),
                        os.path.join(args.save_dir, "calibrated_model"),
                        tokenizer_src=args.finetuned_model)
        print("exported calibrated model")


if __name__ == "__main__":
    main()
