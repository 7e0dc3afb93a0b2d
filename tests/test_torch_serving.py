"""PyTorch port: tenant stacking, sampling, the engine and the HTTP server
against the JAX package, and the port's import isolation.

Stacks are compared bit-exact; greedy tokens of the port's engine must
equal the JAX engine's (both fp32, kernel "torch" vs "xla")."""

import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bitdelta_tpu.serving.engine import Engine as JEngine
from bitdelta_tpu.serving.engine import Request as JRequest
from bitdelta_tpu.serving.stacking import to_pair_layout as jpair
from bitdelta_torch.convert import params_from_numpy, stack_from_numpy
from bitdelta_torch.serving import stacking as tst
from bitdelta_torch.serving.engine import Engine, Request
from bitdelta_torch.serving.sampling import sample_tokens
from bitdelta_torch.serving.server import (ByteTokenizer, ServingApp,
                                           TenantInfo, make_http_server)
from tests.test_serving import _make_world

REPO = Path(__file__).resolve().parents[1]


def _np_tree(tree):
    return jax.tree.map(np.array, tree)


@pytest.fixture(scope="module")
def world():
    cfg, base, tenants, stack = _make_world(num_tenants=3, vocab=258 + 30)
    tstack = stack_from_numpy(_np_tree(stack), "cpu")
    return cfg, base, tenants, stack, tstack


def _tcfg(cfg):
    import dataclasses

    from bitdelta_torch.models.config import ModelConfig

    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif hasattr(want, "_fields"):
        assert type(got).__name__ == type(want).__name__
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(got.numpy(), np.array(want))


def test_stack_and_pair_layout_match_jax(world):
    cfg, base, tenants, stack, _ = world
    got = tst.stack_tenants(_tcfg(cfg), params_from_numpy(_np_tree(base),
                                                          "cpu"),
                            [params_from_numpy(_np_tree(c), "cpu")
                             for c in tenants], device="cpu")
    _assert_tree_equal(got.params, stack.params)
    _assert_tree_equal(got.deltas, stack.deltas)
    np.testing.assert_array_equal(got.vocab_sizes.numpy(),
                                  np.array(stack.vocab_sizes))
    # Pair layout needs N % 256 == 0: widen to a layer that qualifies.
    from bitdelta_tpu.core.delta import BinaryDelta as JDelta

    rng = np.random.default_rng(0)
    packed = rng.integers(-2**31, 2**31 - 1, (2, 3, 4, 512), dtype=np.int32)
    scale = rng.uniform(size=(2, 3)).astype(np.float32)
    jwide = stack._replace(deltas={"q_proj": JDelta(packed, scale)})
    twide = got._replace(deltas={"q_proj": tst.BinaryDelta(
        torch.from_numpy(packed), torch.from_numpy(scale))})
    _assert_tree_equal(tst.to_pair_layout(twide).deltas,
                       jpair(jwide).deltas)


def test_stack_pads_ragged_vocab_like_jax(world):
    # A tenant with a grown vocabulary: both packages right-pad the other
    # tenants' embed / lm_head and record each true vocab size.
    from bitdelta_tpu.serving.stacking import stack_tenants as jstack

    cfg, base, tenants, _, _ = world
    grown = tenants[1]._replace(extras=dict(tenants[1].extras))
    rng = np.random.default_rng(9)
    for name, axis in (("embed", 0), ("lm_head", 1)):
        x = np.array(grown.extras[name])
        extra = list(x.shape)
        extra[axis] = 7
        grown.extras[name] = np.concatenate(
            [x, rng.standard_normal(extra).astype(x.dtype)], axis=axis)
    ragged = [tenants[0], grown, tenants[2]]
    want = jstack(cfg, base, jax.tree.map(jax.numpy.asarray, ragged))
    got = tst.stack_tenants(_tcfg(cfg), params_from_numpy(_np_tree(base),
                                                          "cpu"),
                            [params_from_numpy(_np_tree(c), "cpu")
                             for c in ragged], device="cpu")
    _assert_tree_equal(got.params, want.params)
    np.testing.assert_array_equal(got.vocab_sizes.numpy(),
                                  np.array(want.vocab_sizes))
    assert int(got.vocab_sizes[1]) == int(got.vocab_sizes[0]) + 7


def _requests(cls, n=5, max_new=6):
    prompts = [[5, 6, 7], [9, 3], [1, 2, 3, 4, 5], [40, 41], [7]]
    return [cls(prompt_ids=prompts[i % 5], tenant_id=i % 3,
                max_new_tokens=max_new + i) for i in range(n)]


def test_engine_greedy_matches_jax(world):
    cfg, _, _, stack, tstack = world
    want = JEngine(cfg, stack, max_slots=2, max_seq=64,
                   prefill_buckets=(16,), kernel="xla",
                   decode_chunk=4).generate(_requests(JRequest))
    eng = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=64,
                 prefill_buckets=(16,), kernel="torch", decode_chunk=4,
                 device="cpu")
    got = eng.generate(_requests(Request))
    assert got == want
    assert [len(g) for g in got] == [6, 7, 8, 9, 10]


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_engine_submit_step_matches_generate(world, kernel):
    # Serial admission (submit + step, the HTTP server's path) gives the
    # same greedy tokens as the batched generate() path; kernel="cuda"
    # walks the kernel branches (plain versions on CPU tensors).
    cfg, _, _, _, tstack = world
    eng = Engine(_tcfg(cfg), tstack, max_slots=3, max_seq=64,
                 prefill_buckets=(16,), kernel="torch", decode_chunk=3,
                 device="cpu")
    want = eng.generate(_requests(Request, n=3))
    eng = Engine(_tcfg(cfg), tstack, max_slots=3, max_seq=64,
                 prefill_buckets=(16,), kernel=kernel, decode_chunk=3,
                 device="cpu")
    reqs = _requests(Request, n=3)
    slots = [eng.submit(r) for r in reqs]
    got = {s: [r.first_token] for s, r in zip(slots, reqs)}
    done = set()
    for _ in range(50):
        for ev in eng.step():
            if ev.new_token:
                got[ev.slot].append(ev.token)
            if ev.finished:
                done.add(ev.slot)
        if len(done) == 3:
            break
    assert [got[s] for s in slots] == want


def test_generate_returns_when_cancelled_before_first_chunk(world):
    # A cancel landing after batched admission and before the first chunk
    # leaves no active lane and a deferred first token; generate() must
    # flush it and return instead of spinning.
    cfg, _, _, _, tstack = world
    eng = Engine(_tcfg(cfg), tstack, max_slots=2, max_seq=64,
                 prefill_buckets=(16,), kernel="torch", decode_chunk=4,
                 device="cpu")
    submit_batch = eng._submit_batch

    def submit_then_cancel(reqs):
        admitted = submit_batch(reqs)
        for _, r in admitted:
            assert eng.cancel(r.request_id)
        return admitted

    eng._submit_batch = submit_then_cancel
    out = {}
    t = threading.Thread(target=lambda: out.update(res=eng.generate(
        [Request(prompt_ids=[1, 2], tenant_id=0, max_new_tokens=8,
                 request_id="c")])), daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "generate() spun after the cancel"
    assert out["res"] == [[]]
    assert eng._pending_firsts is None


def test_sampling_masks_and_greedy():
    gen = torch.Generator().manual_seed(0)
    logits = torch.tensor([[0.0, 5.0, 1.0, float("-inf")],
                           [2.0, 1.0, 0.5, 0.1]])
    greedy = sample_tokens(gen, logits, torch.zeros(2), torch.zeros(2,
                           dtype=torch.int32), torch.ones(2))
    assert greedy.tolist() == [1, 0]
    # top_k=1 and a tiny top_p both reduce sampling to the argmax; a
    # masked (-inf) token is never drawn.
    for _ in range(20):
        s = sample_tokens(gen, logits, torch.ones(2),
                          torch.tensor([1, 0], dtype=torch.int32),
                          torch.tensor([1.0, 1e-3]))
        assert s.tolist() == [1, 0]
        hot = sample_tokens(gen, logits, torch.full((2,), 5.0),
                            torch.zeros(2, dtype=torch.int32), torch.ones(2))
        assert hot[0].item() != 3


def test_sampling_follows_the_softmax():
    # Random draws differ from JAX's RNG, so check the distribution:
    # 20000 draws at temperature 2 match softmax(logits / 2) to 0.015.
    gen = torch.Generator().manual_seed(1)
    logits = torch.tensor([1.0, 0.0, -1.0, 2.0, float("-inf")])
    n = 20000
    rows = logits.expand(n, -1).contiguous()
    draws = sample_tokens(gen, rows, torch.full((n,), 2.0),
                          torch.zeros(n, dtype=torch.int32), torch.ones(n))
    freq = torch.bincount(draws.long(), minlength=5).float() / n
    want = torch.softmax(logits / 2.0, dim=0)
    assert (freq - want).abs().max().item() < 0.015
    assert freq[4].item() == 0.0


@pytest.fixture(scope="module")
def served(world):
    cfg, _, _, _, tstack = world
    eng = Engine(_tcfg(cfg), tstack, max_slots=4, max_seq=64,
                 prefill_buckets=(32,), kernel="torch", device="cpu")
    tok = ByteTokenizer()
    app = ServingApp(eng, [TenantInfo("alpha", tok, stop_token_ids=()),
                           TenantInfo("beta", tok, stop_token_ids=()),
                           TenantInfo("gamma", tok, stop_token_ids=())])
    server = make_http_server(app, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    app.close()


def _post(url, body):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in r.read().splitlines()]


def test_http_models_and_stats(served):
    with urllib.request.urlopen(served + "/models", timeout=60) as r:
        assert json.loads(r.read()) == {"models": ["alpha", "beta", "gamma"]}
    with urllib.request.urlopen(served + "/stats", timeout=60) as r:
        stats = json.loads(r.read())
    assert stats["slots_total"] == 4 and stats["kernel"] == "torch"


def test_http_generate_single_and_broadcast(served):
    lines = _post(served, {"prompt": "hi", "tenant": "beta",
                           "max_new_tokens": 4})
    assert len(lines) == 4 and lines[-1]["done"] is True
    assert {line["tenant"] for line in lines} == {"beta"}
    lines = _post(served, {"messages": [{"role": "user", "content": "hey"}],
                           "max_new_tokens": 3})
    assert {line["tenant"] for line in lines} == {"alpha", "beta", "gamma"}
    assert sum(line["done"] for line in lines) == 3
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served, {"prompt": "x", "tenant": "nope"})
    assert e.value.code == 400


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, bitdelta_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "bitdelta_torch.__path__, 'bitdelta_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m.startswith('bitdelta_tpu'))\n"
        "assert len(mods) >= 15, mods\n"
        "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "BAD []"
