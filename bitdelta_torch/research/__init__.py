"""Beyond-the-reference serving modes (port of ``bitdelta_tpu/research``):
the W8 / W4 quantized base under the 1-bit deltas, Mixtral's
mean-expert compression, and the delta-fidelity variants (LoRA, ternary,
per-column scales)."""
