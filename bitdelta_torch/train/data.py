"""Calibration data (port of ``bitdelta_tpu/train/data.py``).

Fixed-length (default 128-token) batches from a text corpus, default
C4/en, materialized as numpy int32 ``(num_batches, B, S)`` up front.
Every source falls back to an offline path (a text file, or seeded
synthetic ids), since calibration needs representative activations, not
a particular corpus.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def batches_from_texts(tokenizer, texts: List[str], batch_size: int,
                       max_length: int = 128) -> np.ndarray:
    """Tokenize each text to exactly ``max_length`` (pad and truncate) and
    stack into ``(num_batches, batch_size, max_length)`` int32."""
    enc = tokenizer(texts, padding="max_length", truncation=True,
                    max_length=max_length)
    ids = np.asarray(enc["input_ids"], np.int32)
    n = (len(ids) // batch_size) * batch_size
    if n == 0:
        raise ValueError("not enough texts for a single batch")
    return ids[:n].reshape(-1, batch_size, max_length)


def synthetic_batches(vocab_size: int, num_steps: int, batch_size: int,
                      max_length: int = 128, seed: int = 0) -> np.ndarray:
    """Seeded random token ids in ``[1, vocab_size)`` (the same ids as the
    JAX package for a seed)."""
    rng = np.random.default_rng(seed)
    return rng.integers(
        1, vocab_size, (num_steps, batch_size, max_length)).astype(np.int32)


def load_calibration_texts(dataset_name: str = "c4", subset: str = "en",
                           split: str = "train", size: int = 800
                           ) -> List[str]:
    """The first ``size`` texts of a streamed Hugging Face dataset (needs
    the ``datasets`` package, and the dataset in its local cache when
    offline)."""
    from datasets import load_dataset

    ds = load_dataset(dataset_name, subset, split=split, streaming=True)
    return [sample["text"] for sample in ds.take(size)]


def texts_from_file(path: str, size: int, chars_per_sample: int = 2048
                    ) -> List[str]:
    """Chop a local text file into pseudo-samples."""
    with open(path) as f:
        raw = f.read()
    return [raw[i:i + chars_per_sample]
            for i in range(0, min(len(raw), size * chars_per_sample),
                           chars_per_sample)]


def get_calibration_batches(tokenizer, *, num_steps: int, batch_size: int,
                            max_length: int = 128,
                            dataset_name: str = "c4", subset: str = "en",
                            split: str = "train",
                            text_file: Optional[str] = None,
                            vocab_size: Optional[int] = None,
                            seed: int = 0) -> np.ndarray:
    """Resolve a calibration source to ``(num_steps, B, S)`` int32 batches.

    Priority: a text file, then the dataset (``dataset_name="synthetic"``
    skips it), then seeded synthetic ids.
    """
    size = num_steps * batch_size
    if text_file is not None:
        texts = texts_from_file(text_file, size)
        return batches_from_texts(tokenizer, texts, batch_size,
                                  max_length)[:num_steps]
    if dataset_name != "synthetic":
        try:
            texts = load_calibration_texts(dataset_name, subset, split, size)
            return batches_from_texts(tokenizer, texts, batch_size,
                                      max_length)[:num_steps]
        except Exception as e:  # no package, no cache, no network, ...
            print(f"[bitdelta_torch] dataset '{dataset_name}' unavailable "
                  f"({type(e).__name__}: {e}); using synthetic calibration")
    if vocab_size is None:
        vocab_size = getattr(tokenizer, "vocab_size", 32000) or 32000
    return synthetic_batches(vocab_size, num_steps, batch_size, max_length,
                             seed)
