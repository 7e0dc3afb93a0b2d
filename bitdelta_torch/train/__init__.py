"""Scale distillation (port of ``bitdelta_tpu/train``): calibration data
and the training loop that refines the per-matrix delta scales."""
