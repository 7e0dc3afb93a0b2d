"""The plain references agree with the port's plain path at a tiny size:
the served model's logits (Mistral-style and a W8 Mixtral, each tenant
its base plus 1-bit deltas, norms, embed and head) and the frozen copy
of the sign layout."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import tiny
from perfbench import serving
from perfbench.reference import decoder
from perfbench.reference.unpack import unpack_pm1


def test_unpack_matches_the_port_layout():
    from bitdelta_torch.ops.packing import pack_signs, unpack_to_pm1

    signs = torch.rand((3, 64, 40), generator=torch.Generator().manual_seed(
        0)) > 0.5
    words = pack_signs(signs)
    assert torch.equal(unpack_pm1(words), unpack_to_pm1(words,
                                                        torch.float32))
    assert torch.equal(unpack_pm1(words) > 0, signs)


@pytest.mark.parametrize("config", ["tiny-llama", "tiny-mixtral-w8"])
def test_served_logits_match_the_port(config):
    cfg = tiny(config)
    dev = torch.device("cpu")
    stack = serving.make_stack(cfg, 5, dev)
    mcfg = serving.model_config(cfg)
    model = serving.model_module(cfg)
    rng = np.random.default_rng(0)
    seqs = [{"tenant": t, "tokens": rng.integers(1, 96, n).tolist(),
             "start": 3} for t, n in ((0, 21), (1, 9))]
    ref = decoder.served_logits(cfg, 5, seqs, dev)
    for q, r in zip(seqs, ref):
        tok = torch.as_tensor([q["tokens"]])
        got = model.forward(mcfg, stack.params, tok, deltas=stack.deltas,
                            tenant_ids=torch.as_tensor([q["tenant"]]),
                            compute_dtype=torch.float32, kernel="torch")
        torch.testing.assert_close(got[0, q["start"]:], r, rtol=1e-4,
                                   atol=1e-4)


def test_control_rounds_the_operands():
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    w = torch.randn(64, 32, generator=torch.Generator().manual_seed(2))
    exact = decoder.matmul(x, w, "fp32")
    low = decoder.matmul(x, w, "fp8")
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.2
    with pytest.raises(ValueError):
        decoder.matmul(x, w, "int3")
