"""Tokenizer loading with the pad -> eos rule and an offline byte-level
fallback (port of ``bitdelta_tpu/utils/tokenizer.py``). ``transformers``
is imported here only, inside the try: without it (or without a
tokenizer in the directory) the fallback is used."""

from __future__ import annotations


def get_tokenizer(name_or_path: str, allow_fallback: bool = True):
    try:
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(name_or_path, use_fast=True)
    except Exception as e:
        if not allow_fallback:
            raise
        print(f"[bitdelta_torch] tokenizer for {name_or_path!r} unavailable "
              f"({type(e).__name__}); using byte-level fallback")
        from ..serving.server import ByteTokenizer

        return ByteTokenizer()
    if tok.pad_token is None:
        if tok.eos_token is not None:
            tok.pad_token = tok.eos_token
        else:
            tok.add_special_tokens({"pad_token": "[PAD]"})
    return tok
