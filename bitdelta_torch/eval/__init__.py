"""Evaluation (port of ``bitdelta_tpu/eval``): strided sliding-window
perplexity."""
