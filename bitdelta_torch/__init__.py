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
             mean-expert compression
  serving/   tenant stacking, sampling, the engine and the HTTP server
  train/     calibration data and scale distillation (``distill_scales``)

Entry points (``Engine``, ``stack_tenants``, ``init_params``,
``load_delta``, the converters, the GPTQ / bnb imports) run on the card
unless the caller passes ``device="cpu"``; ``distill_scales`` runs where
its params lie.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # The quantized-base names load on first use, as in the JAX package.
    if name in ("Int4Weight", "Int8Weight", "quantize_base",
                "roundtrip_base"):
        from .research import quantized_base
        return getattr(quantized_base, name)
    raise AttributeError(name)
