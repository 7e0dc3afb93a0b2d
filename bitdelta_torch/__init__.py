"""bitdelta_torch — the PyTorch/CUDA port of bitdelta_tpu for NVIDIA Hopper.

Same system as the JAX package beside it: a fine-tune is stored as
``W_fine = W_base + scale * sign(delta)`` (1 bit per delta element plus
one fp32 scale per matrix), and one shared base serves many such
fine-tunes at once, each request routed to its tenant's delta.

This package mirrors ``bitdelta_tpu``'s layout and public names so each
module's counterpart is easy to find; it imports torch, numpy and the
standard library only — never jax, never ``bitdelta_tpu``.

Layering:
  ops/       bit packing, plain binary matmuls, and the hand-written CUDA
             kernels (csrc/) with their plain PyTorch versions
  core/      delta quantization, model compression, safetensors artifacts
  models/    the Llama/Mistral decoder (forward / decode_step)
  serving/   tenant stacking, sampling, the engine and the HTTP server

Entry points (``Engine``, ``stack_tenants``, ``init_params``, the
converters) run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
