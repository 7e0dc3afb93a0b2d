"""Model configuration for the Llama/Mistral decoder family.

The port's own copy of ``bitdelta_tpu/models/config.py``: the same field
names, so an artifact's ``model_config`` JSON loads in either package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """RoPE frequency warping. ``rope_type``: "linear" (divide all
    frequencies by ``factor``) or "llama3" (Llama-3.1's wavelength-
    dependent warp between ``low_freq_factor`` and ``high_freq_factor``).
    """
    rope_type: str = "llama3"
    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    rope_scaling: Optional[RopeScaling] = None
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 4096
    sliding_window: Optional[int] = None  # Mistral-style local attention
    attention_bias: bool = False          # Qwen2-style q/k/v biases
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.hidden_size // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def from_dict(raw: dict) -> "ModelConfig":
        """Inverse of ``dataclasses.asdict`` (artifact metadata)."""
        raw = dict(raw)
        if raw.get("rope_scaling") is not None:
            raw["rope_scaling"] = RopeScaling(**raw["rope_scaling"])
        return ModelConfig(**raw)


def mistral_7b() -> ModelConfig:
    return ModelConfig(vocab_size=32000, hidden_size=4096,
                       intermediate_size=14336, num_layers=32, num_heads=32,
                       num_kv_heads=8, rope_theta=10000.0, max_seq_len=8192,
                       sliding_window=4096)


def tiny_test_config(**overrides) -> ModelConfig:
    """A deliberately small config for CPU tests."""
    kw = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
              num_layers=2, num_heads=4, num_kv_heads=2, max_seq_len=128,
              rms_norm_eps=1e-6)
    kw.update(overrides)
    return ModelConfig(**kw)
