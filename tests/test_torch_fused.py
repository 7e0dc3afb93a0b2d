"""PyTorch port: the fused decode route (``kernel="cuda_fused"``) and its
two kernels, rows 9 and 10 of the kernel table, against the JAX package.

* The plain versions of ``fused_tenant_matmul`` (row 9) and
  ``fused_base_pair_matmul`` (row 10) against the Pallas kernels in
  interpret mode, as the JAX package's own tests run them on the CPU, at
  1e-4 of the output scale (``tests/test_pallas_kernels.py`` holds the
  Pallas kernels to the same): both sum the exact products of x and W
  (and the ±x delta terms) in fp32, in another order; row 10's epilogue
  terms cancel as row 1's do, which stays far inside that at these K.
* ``decode_step(kernel="cuda_fused")`` (the kernels' plain versions on
  the CPU) against JAX ``decode_step(kernel="xla")`` at the 2e-3 of
  ``tests/test_torch_model.py``, canonical and pair stacks, with spies on
  the wrappers showing which kernel each projection took.
* A W8 base under ``"cuda_fused"`` takes the ``"cuda"`` route: no fused
  kernel, and the same logits bit for bit.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_tpu.core.delta import BinaryDelta as JBinaryDelta
from bitdelta_tpu.core.delta import pair_delta as jpair_delta
from bitdelta_tpu.models import config as jcfg
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.ops import pallas_binary_gemm as jpb
from bitdelta_tpu.ops.packing import pack_signs as jpack
from bitdelta_tpu.serving.stacking import stack_tenants as jstack
from bitdelta_tpu.serving.stacking import to_pair_layout as jpair
from bitdelta_torch.convert import params_from_numpy, stack_from_numpy
from bitdelta_torch.convert import to_numpy
from bitdelta_torch.core.compress import compress_model
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.ops import binary_gemm as tbg
from bitdelta_torch.ops.packing import unpack_to_pm1

MODEL_TOL = 2e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(want):
    return 1e-4 * max(float(np.abs(want).max()), 1.0)


def _fused_world(seed, bsz, t, k, n, dtype=np.float32, ids=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, k)).astype(np.float32)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)
    signs = rng.integers(0, 2, (t, k, n)).astype(bool)
    packed = np.array(jpack(jnp.asarray(signs)))
    scales = rng.uniform(0.1, 2.0, (t,)).astype(np.float32)
    if ids is None:
        ids = rng.integers(0, t, (bsz,))
    ids = np.asarray(ids, np.int32)
    return x, w, packed, scales, ids


# ---------------------------------------------------------------------------
# Row 9: fused_tenant_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bsz,t,k,n", [(4, 3, 64, 128), (8, 6, 512, 256),
                                       (2, 2, 128, 512)])
def test_fused_tenant_plain_matches_pallas(bsz, t, k, n):
    x, w, packed, scales, ids = _fused_world(40, bsz, t, k, n)
    want = np.array(jpb.fused_tenant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(packed),
        jnp.asarray(scales), jnp.asarray(ids), interpret=True))
    got = tbg.fused_tenant_matmul(_t(x), _t(w), _t(packed), _t(scales),
                                  _t(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want))


def test_fused_tenant_repeated_ids_share_a_tenant():
    # Rows on one tenant all read that tenant's words (and a zero base
    # leaves the delta alone).
    x, w, packed, scales, ids = _fused_world(41, 6, 2, 64, 128,
                                             ids=[0, 0, 1, 1, 0, 1])
    w = np.zeros_like(w)
    want = np.array(jpb.fused_tenant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(packed),
        jnp.asarray(scales), jnp.asarray(ids), interpret=True))
    got = tbg.fused_tenant_matmul_plain(_t(x), _t(w), _t(packed), _t(scales),
                                        _t(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want))
    pm1 = unpack_to_pm1(_t(packed), torch.float32).numpy()     # (T, K, N)
    for b in range(6):
        np.testing.assert_allclose(got.numpy()[b],
                                   scales[ids[b]] * (x[b] @ pm1[ids[b]]),
                                   rtol=0, atol=_tol(want))


def test_fused_tenant_bf16_inputs_match_pallas():
    # bf16 x and W: the products are exact in fp32 on both sides, so the
    # fp32 outputs still agree to 1e-4 of their scale.
    x, w, packed, scales, ids = _fused_world(42, 4, 3, 256, 256)
    xb = jnp.asarray(x, jnp.bfloat16)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = np.array(jpb.fused_tenant_matmul_pallas(
        xb, wb, jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(ids),
        interpret=True, out_dtype=jnp.float32))
    tx = params_from_numpy(np.array(xb), "cpu")
    tw = params_from_numpy(np.array(wb), "cpu")
    got = tbg.fused_tenant_matmul(tx, tw, _t(packed), _t(scales), _t(ids),
                                  out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want))
    # The default output dtype is x's, as in JAX.
    assert tbg.fused_tenant_matmul(tx, tw, _t(packed), _t(scales),
                                   _t(ids)).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Row 10: fused_base_pair_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bsz,t,k,n", [(1, 2, 64, 256), (8, 4, 128, 512),
                                       (4, 2, 256, 1024)])
def test_fused_base_pair_plain_matches_pallas(bsz, t, k, n):
    x, w, packed, scales, ids = _fused_world(43, bsz, t, k, n)
    pd = jpair_delta(JBinaryDelta(packed=jnp.asarray(packed),
                                  scale=jnp.asarray(scales)))
    want = np.array(jpb.fused_base_pair_matmul_pallas(
        jnp.asarray(x), jnp.asarray(w), pd.packed_pairs, pd.colsum,
        jnp.asarray(scales), jnp.asarray(ids), interpret=True))
    got = tbg.fused_base_pair_matmul(_t(x), _t(w), _t(pd.packed_pairs),
                                     _t(pd.colsum), _t(scales), _t(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=_tol(want))


def test_fused_base_pair_plain_is_base_plus_row_1():
    # The plain version is the base matmul plus row 1's plain version,
    # exactly: the two kernels share row 1's integer sums and epilogue.
    x, w, packed, scales, ids = _fused_world(44, 3, 3, 128, 512)
    pd = jpair_delta(JBinaryDelta(packed=jnp.asarray(packed),
                                  scale=jnp.asarray(scales)))
    args = [_t(pd.packed_pairs), _t(pd.colsum), _t(scales), _t(ids)]
    got = tbg.fused_base_pair_matmul_plain(_t(x), _t(w), *args)
    want = _t(x) @ _t(w) + tbg.tenant_delta_matmul_pair_plain(_t(x), *args)
    assert torch.equal(got, want)


def test_fused_wrappers_check_dtype_and_shape_and_launch_nothing_on_cpu():
    x, w, packed, scales, ids = _fused_world(45, 2, 2, 64, 256)
    pd = jpair_delta(JBinaryDelta(packed=jnp.asarray(packed),
                                  scale=jnp.asarray(scales)))
    before = (tbg.fused_tenant_matmul.launches,
              tbg.fused_base_pair_matmul.launches)
    wb = _t(w).to(torch.bfloat16)
    with pytest.raises(ValueError, match="share a dtype"):
        tbg.fused_tenant_matmul(_t(x), wb, _t(packed), _t(scales), _t(ids))
    with pytest.raises(ValueError, match="share a dtype"):
        tbg.fused_base_pair_matmul(_t(x), wb, _t(pd.packed_pairs),
                                   _t(pd.colsum), _t(scales), _t(ids))
    with pytest.raises(ValueError):
        tbg.fused_tenant_matmul(_t(x), _t(w)[:, :128], _t(packed),
                                _t(scales), _t(ids))
    tbg.fused_tenant_matmul(_t(x), _t(w), _t(packed), _t(scales), _t(ids))
    tbg.fused_base_pair_matmul(_t(x), _t(w), _t(pd.packed_pairs),
                               _t(pd.colsum), _t(scales), _t(ids))
    assert (tbg.fused_tenant_matmul.launches,
            tbg.fused_base_pair_matmul.launches) == before


# ---------------------------------------------------------------------------
# decode_step(kernel="cuda_fused")
# ---------------------------------------------------------------------------

def _cfg():
    return jcfg.tiny_test_config(vocab_size=64, hidden_size=256,
                                 intermediate_size=512, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 dtype="float32", sliding_window=6)


def _tcfg(cfg):
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=["canonical", "paired"])
def world(request):
    # Base and fine-tunes from numpy seeds, compressed by the port
    # (bit-exact with JAX, tests/test_torch_delta_artifact.py); both
    # packages stack the same compressed tenants.
    from bitdelta_tpu.core.compress import CompressedModel as JCompressed

    cfg = _cfg()
    rng = np.random.default_rng(50)
    base = jax.tree.map(np.array, jl.init_params(cfg, jax.random.PRNGKey(5),
                                                 jnp.float32))
    tenants = []
    for _ in range(3):
        fine = dict(base)
        fine["layers"] = dict(base["layers"])
        for name in jl.PROJ_NAMES + ("mlp_norm",):
            w = base["layers"][name]
            fine["layers"][name] = (w + 0.01 * rng.standard_normal(w.shape)
                                    ).astype(np.float32)
        comp = compress_model(params_from_numpy(base, "cpu"),
                              params_from_numpy(fine, "cpu"))
        tenants.append(JCompressed(
            deltas={n: JBinaryDelta(jnp.asarray(d.packed.numpy()),
                                    jnp.asarray(d.scale.numpy()))
                    for n, d in comp.deltas.items()},
            extras={n: jnp.asarray(x.numpy())
                    for n, x in comp.extras.items()}))
    stack = jstack(cfg, jax.tree.map(jnp.asarray, base), tenants)
    if request.param == "paired":
        stack = jpair(stack)
    return cfg, stack, stack_from_numpy(jax.tree.map(np.array, stack), "cpu")


def _inputs():
    rng = np.random.default_rng(51)
    tokens = rng.integers(1, 64, (3, 12)).astype(np.int32)
    lengths = np.asarray([12, 9, 5], np.int32)
    ids = np.asarray([2, 0, 1], np.int32)
    nxt = rng.integers(1, 64, (3, 1)).astype(np.int32)
    return tokens, lengths, ids, nxt


class _Spy:
    """Counts the calls of wrappers of ``binary_gemm`` (the model calls
    them through the module, so a patched attribute sees every call)."""

    def __init__(self, monkeypatch, names):
        self.calls = dict.fromkeys(names, 0)
        for name in names:
            fn = getattr(tbg, name)

            def spy(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(tbg, name, spy)


SPIED = ("fused_tenant_matmul", "fused_base_pair_matmul",
         "tenant_delta_matmul", "tenant_delta_matmul_pair")


def _want_calls(tstack, cfg, pair_fn, canonical_fn):
    """Wrapper calls of one decode step: per projection, ``pair_fn`` for a
    pair-layout delta, ``canonical_fn`` for a canonical one."""
    want = dict.fromkeys(SPIED, 0)
    for name in tl.PROJ_NAMES:
        paired = isinstance(tstack.deltas[name], tl.PairedBinaryDelta)
        want[pair_fn if paired else canonical_fn] += cfg.num_layers
    return want


def _torch_steps(cfg, tstack, kernel, spy=None):
    tokens, lengths, ids, nxt = _inputs()
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    tcfg = _tcfg(cfg)
    logits, cache = tl.forward(
        tcfg, tstack.params, t(tokens).long(), lengths=t(lengths),
        deltas=tstack.deltas, tenant_ids=t(ids).long(),
        compute_dtype=torch.float32, return_cache=True, cache_max_seq=16,
        kernel=kernel)
    before = dict(spy.calls) if spy else None
    step, _ = tl.decode_step(tcfg, tstack.params, t(nxt).long(), cache,
                             deltas=tstack.deltas, tenant_ids=t(ids).long(),
                             compute_dtype=torch.float32, kernel=kernel)
    per_step = ({k: v - before[k] for k, v in spy.calls.items()}
                if spy else None)
    return logits, step, per_step


def test_fused_decode_step_matches_jax(world, monkeypatch):
    cfg, stack, tstack = world
    tokens, lengths, ids, nxt = _inputs()
    logits, cache = jl.forward(
        cfg, stack.params, jnp.asarray(tokens), lengths=jnp.asarray(lengths),
        deltas=stack.deltas, tenant_ids=jnp.asarray(ids),
        compute_dtype=jnp.float32, return_cache=True, cache_max_seq=16,
        kernel="xla")
    want, _ = jl.decode_step(cfg, stack.params, jnp.asarray(nxt), cache,
                             deltas=stack.deltas,
                             tenant_ids=jnp.asarray(ids),
                             compute_dtype=jnp.float32, kernel="xla")
    spy = _Spy(monkeypatch, SPIED)
    got_pre, got, per_step = _torch_steps(cfg, tstack, "cuda_fused", spy)
    np.testing.assert_allclose(to_numpy(got), np.array(want),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(to_numpy(got_pre)[row, :n],
                                   np.array(logits)[row, :n],
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    # Every projection of the step took its layout's fused kernel and
    # nothing else (the tenant-stacked head is dense: row 3). In the pair
    # stack k/v (N = 128) stayed canonical: a mixed dict.
    assert per_step == _want_calls(tstack, cfg, "fused_base_pair_matmul",
                                   "fused_tenant_matmul")


def test_fused_prefill_is_the_cuda_route(world):
    # The fused route changes only decode projections: a prefill under
    # "cuda_fused" is the "cuda" prefill, bit for bit.
    cfg, _, tstack = world
    a, _, _ = _torch_steps(cfg, tstack, "cuda_fused")
    b, _, _ = _torch_steps(cfg, tstack, "cuda")
    assert torch.equal(a, b)


def test_quantized_base_keeps_the_cuda_route(world, monkeypatch):
    # A W8 base leaf is not a dense tensor: "cuda_fused" takes the "cuda"
    # route at every projection (base matmul + row 1 / row 7), chosen by
    # the leaf's type, so both give the same logits bit for bit.
    from bitdelta_torch.research.quantized_base import quantize_base

    cfg, _, tstack = world
    w8 = tstack._replace(params=quantize_base(tstack.params, "int8"))
    assert isinstance(w8.params["layers"]["q_proj"], tuple)
    spy = _Spy(monkeypatch, SPIED)
    _, fused, calls = _torch_steps(cfg, w8, "cuda_fused", spy)
    _, plain, _ = _torch_steps(cfg, w8, "cuda")
    assert torch.equal(fused, plain)
    assert calls == _want_calls(tstack, cfg, "tenant_delta_matmul_pair",
                                "tenant_delta_matmul")


def test_engine_takes_the_fused_route_and_pairs_the_stack(world):
    from bitdelta_torch.serving.engine import Engine, Request

    cfg, _, tstack = world
    eng = Engine(_tcfg(cfg), tstack, max_slots=3, max_seq=32,
                 prefill_buckets=(16, 32), kernel="cuda_fused",
                 device="cpu")
    assert eng.kernel == "cuda_fused"
    assert isinstance(eng.stack.deltas["q_proj"], tl.PairedBinaryDelta)
    ref = Engine(_tcfg(cfg), tstack, max_slots=3, max_seq=32,
                 prefill_buckets=(16, 32), kernel="cuda", device="cpu")
    reqs = [Request(prompt_ids=[3, 5, 7, i + 1], tenant_id=i % 3,
                    max_new_tokens=4) for i in range(3)]
    got = eng.generate(reqs)
    assert all(len(o) == 4 for o in got)
    with pytest.raises(ValueError, match="unknown kernel"):
        Engine(_tcfg(cfg), tstack, kernel="fused", device="cpu")
    # Greedy tokens equal the unfused route's: on the pair layout the
    # fused plain version is the base matmul plus row 1's, op for op.
    assert got == ref.generate([Request(prompt_ids=r.prompt_ids,
                                        tenant_id=r.tenant_id,
                                        max_new_tokens=4) for r in reqs])
