"""Perplexity evaluation CLI (port of ``bitdelta_tpu/cli/eval_ppl.py``):
load the base model, fuse a delta artifact densely (so the PPL isolates
the quantization error from kernel numerics), run the strided-window
evaluator on wikitext-2 (default) or a local text file, and write
``ppl.txt``.

Usage:
  python -m bitdelta_torch.cli.eval_ppl --base_model <dir> \\
      --model_diff out/diff.safetensors [--text_file corpus.txt]

Runs on the card; ``--device cpu`` runs on the CPU. ``--mesh`` is taken
and, as in JAX's CLI, the eval runs on one device (the library's
``eval_ppl(mesh=)`` splits the windows over a mesh).
"""

from __future__ import annotations

import argparse
import os

from . import args as A
from ..core.artifact import load_delta
from ..core.compress import fuse_compressed
from ..device import resolve_device, torch_dtype
from ..eval.ppl import eval_ppl, tokenize_corpus
from ..models import resolve_model_module
from ..models.hf_import import load_hf_params
from ..utils.tokenizer import get_tokenizer


def main(argv=None):
    p = argparse.ArgumentParser("bitdelta_torch.eval_ppl")
    A.add_model_args(p)
    A.add_ppl_args(p)
    A.add_mesh_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    dtype = torch_dtype(args.dtype)

    cfg, params = load_hf_params(args.base_model, dtype=dtype, device=device)
    model_mod = resolve_model_module(cfg)
    if args.model_diff is not None:
        comp, _, meta = load_delta(args.model_diff, device=device,
                                   return_meta=True)
        if meta.get("base_quant") is not None:
            # W{8,4}+W1 artifact: fuse against the quantized round-tripped
            # base (what the deltas were taken against).
            from ..research.quantized_base import roundtrip_base

            params = roundtrip_base(params, meta["base_quant"], dtype)
        params = fuse_compressed(params, comp)

    tokenizer = get_tokenizer(args.base_model)
    if args.text_file:
        with open(args.text_file) as f:
            texts = [f.read()]
    else:
        from datasets import load_dataset
        ds = load_dataset(args.dataset_name, args.subset, split=args.split,
                          streaming=True).take(args.num_eval_samples)
        texts = [s["text"] for s in ds]
    token_ids = tokenize_corpus(tokenizer, texts)

    ppl = eval_ppl(cfg, params, token_ids, context_size=args.context_size,
                   window_size=args.window_size, model=model_mod,
                   kernel=A.resolve_kernel(args.kernel, device))
    print(f"ppl: {ppl}")
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, "ppl.txt"), "w") as f:
        f.write(str(ppl))
    return ppl


if __name__ == "__main__":
    main()
