"""bitdelta_torch — the PyTorch/CUDA port of bitdelta_tpu for NVIDIA Hopper.

Same system as the JAX package beside it: a fine-tune is stored as
``W_fine = W_base + scale * sign(delta)`` (1 bit per delta element plus
one fp32 scale per matrix), and one shared base serves many such
fine-tunes at once, each request routed to its tenant's delta.

This package mirrors ``bitdelta_tpu``'s layout and public names so each
module's counterpart is easy to find; it imports torch, numpy and the
standard library only — never jax, never ``bitdelta_tpu``.

Layering:
  ops/       bit packing, plain binary matmuls, KV quantization, and the
             hand-written CUDA kernels (csrc/) with their plain PyTorch
             versions
  core/      delta quantization, model compression, safetensors artifacts
  models/    the Llama/Mistral and Mixtral (MoE) decoders (forward /
             decode_step), GPTQ / bnb layer import
  research/  the W8 / W4 quantized base under the deltas; Mixtral
             mean-expert compression; the delta-fidelity variants
             (LoRA, ternary, per-column scales)
  serving/   tenant stacking, sampling, the engine and the HTTP server
  train/     calibration data and scale distillation (``distill_scales``)
  eval/      strided-window perplexity (``eval_ppl``)
  utils/     tokenizer loading, weight diagnostics, profiling, the
             serving check (``serving_compiled_check``)
  tools/     ``python -m bitdelta_torch.tools.convert_reference``
  cli/       ``python -m bitdelta_torch.cli.{train,serve,eval_ppl}``

Entry points (``Engine``, ``stack_tenants``, ``init_params``,
``load_delta``, ``load_hf_params``, ``load_gptq_params``, the converters,
the GPTQ / bnb imports, the CLIs) run on the card unless the caller
passes ``device="cpu"`` (``--device cpu``); ``distill_scales`` and
``eval_ppl`` run where their params lie.
"""

__version__ = "0.1.0"

# Public names loaded on first use (``bitdelta_torch.compress_model``,
# ``bitdelta_torch.Engine``): every name the JAX package's root resolves,
# eager or lazy, so ``import bitdelta_torch`` imports no torch module
# until a name is used. name -> submodule.
_LAZY = {
    "BinaryDelta": "core.delta",
    "apply_delta": "core.delta",
    "delta_linear": "core.delta",
    "dequantize_delta": "core.delta",
    "quantize_delta": "core.delta",
    "pack_signs": "ops.packing",
    "unpack_signs": "ops.packing",
    "unpack_to_pm1": "ops.packing",
    "binary_bmm": "ops.binary_matmul",
    "binary_matmul": "ops.binary_matmul",
    "tenant_binary_matmul": "ops.binary_matmul",
    "CompressedModel": "core.compress",
    "compress_model": "core.compress",
    "fuse_compressed": "core.compress",
    "student_params": "core.compress",
    "load_delta": "core.artifact",
    "save_delta": "core.artifact",
    "ColumnScaleDelta": "research.variants",
    "LoRADelta": "research.variants",
    "TernaryDelta": "research.variants",
    "fuse_variant_model": "research.variants",
    "Int4Weight": "research.quantized_base",
    "Int8Weight": "research.quantized_base",
    "quantize_base": "research.quantized_base",
    "roundtrip_base": "research.quantized_base",
    "load_gptq_params": "models.quant_import",
    "int4_from_gptq": "models.quant_import",
    "int8_from_bnb": "models.quant_import",
    "dequantize_gptq": "models.quant_import",
    "eval_ppl": "eval.ppl",
    "distill_scales": "train.distill",
    "Engine": "serving.engine",
    "EngineFullError": "serving.engine",
    "Request": "serving.engine",
    "stack_tenants": "serving.stacking",
    "quantize_kv": "ops.kv_quant",
    "dequantize_kv": "ops.kv_quant",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                       name)
    raise AttributeError(name)
