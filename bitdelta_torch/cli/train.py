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

Data and tensor parallelism: ``--mesh dp,tp`` with one process a rank,
started by ``python -m torch.distributed.run --nproc-per-node dp*tp -m
bitdelta_torch.cli.train --mesh dp,tp ...``. Every rank reads its own
blocks of the base and the fine-tune straight from the checkpoints to its
card (``load_hf_params(mesh=)``; with ``--quantize_base`` the round trip
runs on the shards, bit for bit the whole base's, a W4 group straddling
ranks where the model axis splits one); the deltas are compressed on the
shards and distilled over the mesh (``train/distill.py``), each rank
taking its rows of every batch. Rank 0 alone writes the files: the
artifacts from the shards gathered leaf by leaf (the other ranks drop
each leaf at once); ``--debug``'s statistics read the checkpoints one
matrix at a time, so no rank holds either model whole.

``--save_full_model``'s export, with or without a mesh, reads the base
from its checkpoint one tensor at a time as it fuses and writes it
(``core/export.py::fused_checkpoint``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import torch.distributed as dist

from . import args as A
from ..core.artifact import save_delta
from ..core.compress import compress_model
from ..device import resolve_device, torch_dtype
from ..models import llama, resolve_model_module
from ..models.hf_import import load_hf_params
from ..train.data import get_calibration_batches
from ..train.distill import DistillConfig, distill_scales
from ..utils.tokenizer import get_tokenizer


def _whole(comp, cfg, fcfg, mesh, writer):
    """A compressed model's shards gathered whole to the writer's host,
    one leaf at a time; every other rank takes part and drops each leaf
    at once (its leaves come back None)."""
    from ..parallel.sharding import delta_specs, extras_specs, gather_tree

    if mesh is None:
        return comp
    return comp._replace(
        deltas=gather_tree(comp.deltas, delta_specs(
            cfg, keys=comp.deltas.keys()), mesh, "cpu", keep=writer),
        extras=gather_tree(comp.extras, extras_specs(
            fcfg, keys=comp.extras.keys()), mesh, "cpu", keep=writer))


def _streamed_layers(ckpt_dir, cfg, dtype, quantize=None):
    """``{"layers": {name: each layer's matrix, read whole in turn}}`` of a
    checkpoint's projections (``weight_corr_stddev`` takes one layer pair
    at a time), the base's round trip applied where ``quantize`` says."""
    from ..models.hf_import import checkpoint_index, read_layer
    from ..research.quantized_base import roundtrip_matrix
    from ..utils.diagnostics import stat_names

    index = checkpoint_index(ckpt_dir)

    def layers(name):
        for layer in range(cfg.num_layers):
            w = read_layer(index, cfg, name, layer, dtype, "cpu")
            yield w if quantize is None else roundtrip_matrix(w, quantize,
                                                              dtype)
    return {"layers": {name: layers(name) for name in stat_names(cfg)}}


def main(argv=None):
    p = argparse.ArgumentParser("bitdelta_torch.train")
    A.add_model_args(p)
    A.add_train_args(p)
    A.add_mesh_args(p)
    args = p.parse_args(argv)
    mesh = A.make_cli_mesh(args.mesh, args.device)
    device = resolve_device(args.device)
    writer = mesh is None or dist.get_rank() == 0
    os.makedirs(args.save_dir, exist_ok=True)
    dtype = torch_dtype(args.dtype)
    if mesh is not None:
        print(f"each rank reads its shards over mesh {tuple(mesh.shape)} "
              f"(data, model)", flush=True)
    print(f"loading base {args.base_model} ...", flush=True)
    cfg, base = load_hf_params(args.base_model, dtype=dtype, device=device,
                               mesh=mesh)
    print(f"loading fine-tune {args.finetuned_model} ...", flush=True)
    fcfg, fine = load_hf_params(args.finetuned_model, dtype=dtype,
                                device=device, mesh=mesh)
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
        base = roundtrip_base(base, args.quantize_base, dtype, mesh)

    if args.debug and writer:
        from ..utils.diagnostics import weight_corr_stddev
        if mesh is None:
            stats = weight_corr_stddev(base, fine)
        else:
            stats = weight_corr_stddev(
                _streamed_layers(args.base_model, cfg, dtype,
                                 args.quantize_base),
                _streamed_layers(args.finetuned_model, fcfg, dtype))
        with open(os.path.join(args.save_dir, "corr_stddev.csv"), "w") as f:
            f.write(f"corr,stddev\n{stats['corr']},{stats['stddev']}\n")

    print("compressing diff...", flush=True)
    if is_mixtral:  # attn + experts + router (+ embed/head) deltas
        comp = model_mod.compress_mixtral(
            base, fine, compress_embeddings=args.compress_embeddings,
            zero_sign=args.zero_sign, mesh=mesh)
    else:
        comp = compress_model(base, fine,
                              compress_embeddings=args.compress_embeddings,
                              zero_sign=args.zero_sign, mesh=mesh)
    whole = _whole(comp, cfg, fcfg, mesh, writer)
    if writer:
        save_delta(os.path.join(args.save_dir, "diff_untrained.safetensors"),
                   whole, fcfg, base_quant=args.quantize_base)
    del whole

    batches = None
    if writer:
        tokenizer = get_tokenizer(args.finetuned_model or args.base_model)
        batches = get_calibration_batches(
            tokenizer, num_steps=args.num_steps, batch_size=args.batch_size,
            max_length=args.max_length, dataset_name=args.dataset_name,
            subset=args.subset, split=args.split, text_file=args.text_file,
            vocab_size=cfg.vocab_size)
    if mesh is not None:
        # Rank 0's batches on every rank (a dataset read may fall back).
        from ..parallel.collectives import broadcast_object

        batches = broadcast_object(batches)

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
                                      mesh=mesh, progress=writer,
                                      model=model_mod, checkpoint_path=ckpt,
                                      checkpoint_every=args.checkpoint_every)
    whole = _whole(comp, cfg, fcfg, mesh, writer)
    if not writer:
        return
    print(f"distill loss {losses[0]:.6f} -> {losses[-1]:.6f}")
    if args.debug:
        with open(os.path.join(args.save_dir, "train_loss.json"), "w") as f:
            json.dump(losses, f)

    save_delta(os.path.join(args.save_dir, "diff.safetensors"), whole, fcfg,
               base_quant=args.quantize_base)
    print(f"saved {os.path.join(args.save_dir, 'diff.safetensors')}")

    if args.save_full_model:
        from ..core.export import fused_checkpoint, save_full_model

        # The base read from its checkpoint one tensor at a time as it is
        # fused and written, so it is never whole on the writer's host.
        save_full_model(cfg, fused_checkpoint(
            cfg, args.base_model, whole, dtype=dtype,
            base_quant=args.quantize_base, device=device),
            os.path.join(args.save_dir, "calibrated_model"),
            tokenizer_src=args.finetuned_model)
        print("exported calibrated model")


if __name__ == "__main__":
    main()
