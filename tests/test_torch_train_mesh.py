"""PyTorch port: data and tensor parallelism for distillation and the
perplexity eval (``make_distill_step(mesh=)`` / ``distill_scales(mesh=)``,
compression on shards, ``eval_ppl(mesh=)`` and ``forward(seq_group=)``,
Megatron's ``copy_to_model`` / ``reduce_from_model``) against the JAX
package's unsharded functions on the CPU.

Every case runs on one 4-rank gloo world (``tests/torch_mesh_worker.py``)
whose ranks join through a ``tcp://`` coordinator at a free port
(``parallel/mesh.py::initialize_multihost``, the counterpart of
``tests/test_multihost.py``); a case on a smaller mesh runs on its first
ranks. Tolerances, fp32 throughout:

* distillation: losses within rtol 1e-4 and scales within 1e-5 of JAX's
  ``distill_scales``, as ``tests/test_sharding.py::
  test_sharded_distill_step_matches_unsharded`` holds the sharded step;
  every rank's scales bit-equal to rank 0's;
* every scale's gradient at tp = 2, the router's included, within 1e-5
  of one process's (relative, and absolute in units of the tensor's
  largest gradient: the shards sum in another order); summing the
  router's over the model axis would double it;
* compression on shards: words bit-exact with JAX's ``compress_model`` /
  ``compress_mixtral``, scales within 1e-6;
* ``eval_ppl(mesh=)`` within rtol 1e-5 of JAX's unsharded PPL, and the
  sequence-sharded forward within 2e-5, as ``tests/test_seq_sharding.py``;
* the collectives' output and gradients within 1e-5 of one process's
  autograd (fp32 products of values up to about 80, summed over two
  shards in another order);
* each rank's ``load_hf_params(mesh=)`` of a checkpoint on disk (bf16
  and fp32 files, loaded as bf16 and fp32; a Mixtral), and a W8 / W4
  round trip on those shards, bit-equal to the shard of the whole.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.convert import tree_from_numpy
from bitdelta_torch.core import compress as tcomp
from bitdelta_torch.models import mixtral as tmx
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.train import distill as tdistill
from bitdelta_tpu.core.compress import compress_model
from bitdelta_tpu.eval.ppl import eval_ppl as jeval_ppl
from bitdelta_tpu.models import config as jcfgs
from bitdelta_tpu.models import llama as jl
from bitdelta_tpu.models import mixtral as jmx
from bitdelta_tpu.train.data import synthetic_batches
from bitdelta_tpu.train.distill import DistillConfig, distill_scales
from tests.torch_mesh_worker import free_port, spawn_world, write_checkpoint

LOSS_RTOL = 1e-4
SCALE_RTOL = 1e-5
PPL_RTOL = 1e-5
DISTILL_MESHES = [(2, 1), (1, 2), (2, 2)]
KERNELS = ["torch", "cuda"]


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(tree):
    return tree_from_numpy(_np(tree), "cpu")


def _tcfg(cfg):
    if isinstance(cfg, jmx.MixtralConfig):
        return tmx.MixtralConfig.from_dict(dataclasses.asdict(cfg))
    return ModelConfig.from_dict(dataclasses.asdict(cfg))


def _jax_distill(cfg, base, fine, comp, batches, model=None):
    dcfg = DistillConfig(lr=1e-3, num_steps=len(batches),
                         compute_dtype="float32")
    out, losses = distill_scales(cfg, base, fine, comp, batches, dcfg,
                                 model=model)
    return {"losses": np.asarray(losses),
            "scales": {n: np.asarray(d.scale)
                       for n, d in out.deltas.items()}}


def _distill_world(cfg, base, fine, comp, batches, model="llama"):
    return dict(cfg=_tcfg(cfg), base=_t(base), fine=_t(fine),
                comp=_t(comp), batches=np.asarray(batches), model=model)


def _sharding_world():
    """tests/test_sharding.py's world and batches."""
    from tests.test_sharding import _cfg, _pair

    cfg = _cfg()
    base, fine = _pair(cfg)
    comp = compress_model(base, fine)
    batches = synthetic_batches(cfg.vocab_size, 3, 4, 16, seed=1)
    return cfg, base, fine, comp, batches


def _multihost_world():
    """tests/test_multihost.py's world (its worker's config, weights and
    batches), for four processes on a (2, 2) mesh."""
    cfg = jcfgs.tiny_test_config(vocab_size=128, hidden_size=64,
                                 intermediate_size=256, num_layers=2,
                                 num_heads=4, num_kv_heads=4,
                                 dtype="float32")
    base = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32,
                          scale=0.25)
    fine = dict(base)
    fine["layers"] = dict(base["layers"])
    key = jax.random.PRNGKey(50)
    for name in jl.PROJ_NAMES:
        key, sub = jax.random.split(key)
        fine["layers"][name] = base["layers"][name] + (
            0.02 * jax.random.normal(sub, base["layers"][name].shape))
    comp = compress_model(base, fine)
    batches = synthetic_batches(cfg.vocab_size, 2, 4, 32, seed=1)
    return cfg, base, fine, comp, batches


def _mixtral_world():
    """tests/test_mixtral.py's tensor-parallel Mixtral and a fine-tune of
    every layer tensor, embed and head."""
    from tests.test_mixtral import _finetune, _tp_world

    cfg, base = _tp_world()
    fine = _finetune(base, 41)
    comp = jmx.compress_mixtral(base, fine)
    batches = synthetic_batches(cfg.vocab_size, 2, 2, 16, seed=3)
    return cfg, base, fine, comp, batches


def _embedding_finetune(base):
    """A fine-tune of tests/test_sharding.py's base whose embed and head
    move too (compressed embeddings have something to pack)."""
    rng = np.random.default_rng(7)
    fine = _np(base)
    fine["layers"] = {n: (w + 0.02 * rng.standard_normal(w.shape)).astype(
        np.float32) if n in jl.PROJ_NAMES else w
        for n, w in fine["layers"].items()}
    for name in ("embed", "lm_head"):
        fine[name] = (fine[name] + 0.02 * rng.standard_normal(
            fine[name].shape)).astype(np.float32)
    return fine


def _seq_world():
    """tests/test_seq_sharding.py's world: the PPL params, and the
    forward's params with a q_proj delta."""
    cfg = jcfgs.tiny_test_config(vocab_size=128, hidden_size=64,
                                 intermediate_size=128, num_layers=2,
                                 num_heads=4, num_kv_heads=2,
                                 max_seq_len=256, dtype="float32")
    base = jl.init_params(cfg, jax.random.PRNGKey(0), jnp.float32,
                          scale=0.25)
    fine = dict(base)
    fine["layers"] = dict(base["layers"])
    fine["layers"]["q_proj"] = base["layers"]["q_proj"] + 0.05
    comp = compress_model(base, fine)
    ppl_params = jl.init_params(cfg, jax.random.PRNGKey(3), jnp.float32,
                                scale=0.25)
    return cfg, base, comp, ppl_params


PPL_CASES = [  # (mesh, kernel, with deltas, tokens, context, window)
    ((2, 2), "torch", False, 2048, 96, 32),
    ((2, 1), "cuda", True, 512, 96, 32),
    ((1, 2), "cuda", True, 512, 96, 32),
]


BF16 = dict(dtype=torch.bfloat16)
LOAD_CASES = [  # (case id, world, mesh, case fields)
    ("load_bf16_2x2", "ckpt_bf16", (2, 2), {}),
    ("load_bf16_1x4_as_bf16", "ckpt_bf16", (1, 4), BF16),
    ("load_fp32_1x4_as_bf16", "ckpt_fp32", (1, 4), BF16),
    ("load_mixtral_1x2", "ckpt_mixtral", (1, 2), {}),
    ("load_mixtral_2x2", "ckpt_mixtral", (2, 2), {}),
    ("load_w8_1x4", "ckpt_fp32", (1, 4), dict(quantize="int8")),
    ("load_w8_2x2_bf16", "ckpt_bf16", (2, 2), dict(quantize="int8", **BF16)),
    ("load_w4_1x2", "ckpt_fp32", (1, 2), dict(quantize="int4")),
    ("load_w4_2x2_bf16", "ckpt_bf16", (2, 2), dict(quantize="int4", **BF16)),
    # train --quantize_base's round trip on the shards. At (1, 4) o_proj's
    # K of 256 gives each rank 64 rows, half of a W4 group.
    ("roundtrip_w8_1x4", "ckpt_fp32", (1, 4), dict(roundtrip="int8")),
    ("roundtrip_w4_1x4", "ckpt_fp32", (1, 4), dict(roundtrip="int4")),
    ("roundtrip_w4_1x4_bf16", "ckpt_bf16", (1, 4),
     dict(roundtrip="int4", **BF16)),
    ("roundtrip_w4_2x2", "ckpt_fp32", (2, 2), dict(roundtrip="int4")),
]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on one 4-rank world over tcp, and JAX's unsharded
    references."""
    worlds, cases, want = {}, [], {}

    cfg, base, fine, comp, batches = _sharding_world()
    worlds["sharding"] = _distill_world(cfg, base, fine, comp, batches)
    want["sharding"] = _jax_distill(cfg, base, fine, comp, batches)
    for m in DISTILL_MESHES:
        for k in KERNELS:
            cases.append(dict(kind="distill", id=f"distill_{m}_{k}",
                              world="sharding", mesh=m, kernel=k,
                              grads=True))

    cfg, base, fine, comp, batches = _multihost_world()
    worlds["multihost"] = _distill_world(cfg, base, fine, comp, batches)
    want["multihost"] = _jax_distill(cfg, base, fine, comp, batches)
    cases.append(dict(kind="distill", id="multihost", world="multihost",
                      mesh=(2, 2), kernel="torch"))

    cfg, base, fine, comp, batches = _mixtral_world()
    worlds["mixtral"] = _distill_world(cfg, base, fine, comp, batches,
                                       model="mixtral")
    want["mixtral"] = _jax_distill(cfg, base, fine, comp, batches, jmx)
    want["mixtral_comp"] = _np(comp)
    cases.append(dict(kind="distill", id="mixtral", world="mixtral",
                      mesh=(1, 2), kernel="torch", grads=True))
    cases.append(dict(kind="compress", id="compress_mixtral",
                      world="mixtral", mesh=(1, 2)))

    scfg, sbase, _, _, _ = _sharding_world()
    efine = _embedding_finetune(sbase)
    worlds["compress"] = dict(cfg=_tcfg(scfg), base=_t(sbase),
                              fine=tree_from_numpy(efine, "cpu"))
    for ce in (False, True):
        want[f"compress_{int(ce)}"] = _np(compress_model(
            sbase, jax.tree.map(jnp.asarray, efine), compress_embeddings=ce))
        for m in ((2, 2), (1, 4)):
            cases.append(dict(kind="compress", id=f"compress_{m}_{int(ce)}",
                              world="compress", mesh=m,
                              compress_embeddings=ce))

    qcfg, qbase, qcomp, ppl_params = _seq_world()
    worlds["ppl"] = dict(cfg=_tcfg(qcfg), params=_t(ppl_params))
    worlds["ppl_deltas"] = dict(cfg=_tcfg(qcfg), params=_t(qbase),
                                deltas=_t(qcomp.deltas))
    token_ids = np.random.default_rng(0).integers(0, 128, 2048)
    for m, k, with_deltas, n, ctx, win in PPL_CASES:
        cid = f"ppl_{m}_{k}"
        if with_deltas:
            want[cid] = jeval_ppl(qcfg, qbase, token_ids[:n],
                                  context_size=ctx, window_size=win,
                                  deltas=qcomp.deltas,
                                  compute_dtype=jnp.float32)
        else:
            want[cid] = jeval_ppl(qcfg, ppl_params, token_ids[:n],
                                  context_size=ctx, window_size=win,
                                  compute_dtype=jnp.float32)
        cases.append(dict(kind="ppl", id=cid,
                          world="ppl_deltas" if with_deltas else "ppl",
                          mesh=m, kernel=k, tokens=token_ids[:n],
                          context_size=ctx, window_size=win))
    mcfg, mbase = _mixtral_world()[:2]
    worlds["ppl_mixtral"] = dict(cfg=_tcfg(mcfg), params=_t(mbase),
                                 model="mixtral")
    want["ppl_mixtral"] = jeval_ppl(mcfg, mbase, token_ids[:512] % 96,
                                    context_size=96, window_size=32,
                                    compute_dtype=jnp.float32, model=jmx)
    cases.append(dict(kind="ppl", id="ppl_mixtral", world="ppl_mixtral",
                      mesh=(2, 2), kernel="torch",
                      tokens=token_ids[:512] % 96, context_size=96,
                      window_size=32))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (1, 128), 0, 128)
    want["seqfwd"] = np.asarray(jl.forward(qcfg, qbase, tokens,
                                           deltas=qcomp.deltas,
                                           compute_dtype=jnp.float32))
    for k in KERNELS:
        cases.append(dict(kind="seqfwd", id=f"seqfwd_{k}", world="ppl_deltas",
                          mesh=(4, 1), kernel=k,
                          tokens=torch.from_numpy(np.array(tokens))))

    g = torch.Generator().manual_seed(5)
    worlds["mlp"] = {"x": torch.randn((3, 8), generator=g),
                     "a": torch.randn((8, 16), generator=g),
                     "b": torch.randn((16, 8), generator=g)}
    cases.append(dict(kind="collectives", id="collectives", world="mlp",
                      mesh=(2, 2)))

    root = tmp_path_factory.mktemp("ckpts")
    lcfg = jcfgs.tiny_test_config(vocab_size=128, hidden_size=256,
                                  intermediate_size=512, num_layers=2,
                                  num_heads=4, num_kv_heads=4,
                                  dtype="float32")
    lbase = _np(jl.init_params(lcfg, jax.random.PRNGKey(11), jnp.float32,
                               scale=0.25))
    for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        worlds[f"ckpt_{name}"] = dict(cfg=_tcfg(lcfg), ckpt=write_checkpoint(
            root / name, _tcfg(lcfg), lbase, dtype))
    worlds["ckpt_mixtral"] = dict(cfg=_tcfg(mcfg), ckpt=write_checkpoint(
        root / "mixtral", _tcfg(mcfg), _np(mbase), torch.float32, files=3))
    for cid, wname, m, extra in LOAD_CASES:
        cases.append(dict(kind="load_params", id=cid, world=wname, mesh=m,
                          **extra))

    init = f"tcp://127.0.0.1:{free_port()}"
    ranks = spawn_world(dict(worlds=worlds, cases=cases), 4,
                        tmp_path_factory.mktemp("train_mesh"), init=init)
    return dict(ranks=ranks, want=want, worlds=worlds)


def _in_mesh(world, cid):
    return [r[cid] for r in world["ranks"] if r[cid] is not None]


def _assert_distill(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    assert set(got["scales"]) == set(want["scales"])
    for name, s in want["scales"].items():
        np.testing.assert_allclose(got["scales"][name].numpy(), s,
                                   rtol=SCALE_RTOL, err_msg=name)


def _one_process_grads(w, model=None):
    """The scale gradients of one single-process step from the world's
    initial scales, on its first batch."""
    scales = {n: s.detach().clone().requires_grad_()
              for n, s in tcomp.get_scales(w["comp"]).items()}
    dcfg = tdistill.DistillConfig(lr=1e-3, num_steps=len(w["batches"]),
                                  compute_dtype="float32", kernel="torch")
    tdistill.make_distill_step(
        w["cfg"], dcfg, w["base"], w["fine"], w["comp"], scales,
        tdistill.make_optimizer(scales, dcfg), model=model)(
            torch.as_tensor(w["batches"][0]).long())
    return {n: s.grad.numpy() for n, s in scales.items()}


def _assert_grads(got, want):
    """Summed gradients against one process's: the shards sum in another
    order, so each within 1e-5 of itself or of its tensor's largest."""
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=SCALE_RTOL,
                                   atol=SCALE_RTOL * np.abs(g).max(),
                                   err_msg=name)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("mesh", DISTILL_MESHES)
def test_meshed_distill_matches_jax_unsharded(world, mesh, kernel):
    """Losses and scales against JAX's unsharded distillation; the summed
    gradients of one step against one process's (AdamW's update hardly
    moves when a gradient is scaled, so only they show a sum over an
    axis taken once too often)."""
    results = _in_mesh(world, f"distill_{mesh}_{kernel}")
    assert len(results) == mesh[0] * mesh[1]
    _assert_distill(results[0], world["want"]["sharding"])
    want = _one_process_grads(world["worlds"]["sharding"])
    for r in results:
        _assert_grads(r["grads"], want)
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]
        for name, s in results[0]["scales"].items():
            assert torch.equal(r["scales"][name], s), name


def test_four_processes_over_tcp_distill_as_one(world):
    """tests/test_multihost.py on the port: four processes joined at a
    tcp:// coordinator distill over one global (2, 2) mesh; every rank
    reports the same losses, JAX's single-device ones."""
    results = _in_mesh(world, "multihost")
    assert len(results) == 4
    assert all(r["losses"] == results[0]["losses"] for r in results)
    assert np.all(np.isfinite(results[0]["losses"]))
    _assert_distill(results[0], world["want"]["multihost"])


def test_mixtral_router_gradient_is_not_summed_over_model(world):
    """At tp = 2 the router's delta is whole on both ranks and so is its
    gradient: the summed gradients equal one process's, the router's
    included (a sum over the model axis would double it)."""
    want = _one_process_grads(world["worlds"]["mixtral"], tmx)
    results = _in_mesh(world, "mixtral")
    assert len(results) == 2
    for r in results:
        _assert_grads(r["grads"], want)
        assert torch.all(r["grads"]["router"] != 0)
    _assert_distill(results[0], world["want"]["mixtral"])


def _assert_compressed(got, want, scale_rtol=1e-6):
    assert set(got.deltas) == set(want.deltas)
    for name, d in want.deltas.items():
        np.testing.assert_array_equal(got.deltas[name].packed.numpy(),
                                      np.asarray(d.packed), err_msg=name)
        np.testing.assert_allclose(got.deltas[name].scale.numpy(),
                                   np.asarray(d.scale), rtol=scale_rtol,
                                   err_msg=name)
    assert set(got.extras) == set(want.extras)
    for name, x in want.extras.items():
        np.testing.assert_array_equal(got.extras[name].numpy(),
                                      np.asarray(x), err_msg=name)


@pytest.mark.parametrize("embeddings", [False, True])
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
def test_compress_on_shards_matches_jax(world, mesh, embeddings):
    results = _in_mesh(world, f"compress_{mesh}_{int(embeddings)}")
    assert len(results) == 4
    for r in results:
        _assert_compressed(r, world["want"][f"compress_{int(embeddings)}"])


def test_compress_mixtral_on_shards_matches_jax(world):
    for r in _in_mesh(world, "compress_mixtral"):
        _assert_compressed(r, world["want"]["mixtral_comp"])


@pytest.mark.parametrize("mesh,kernel", [c[:2] for c in PPL_CASES])
def test_eval_ppl_on_a_mesh_matches_jax(world, mesh, kernel):
    cid = f"ppl_{mesh}_{kernel}"
    results = _in_mesh(world, cid)
    assert len(results) == mesh[0] * mesh[1]
    assert all(r == results[0] for r in results)
    np.testing.assert_allclose(results[0], world["want"][cid],
                               rtol=PPL_RTOL)


def test_mixtral_eval_ppl_on_a_mesh_matches_jax(world):
    """The Mixtral decoder's sequence split and tensor parallelism, at
    (2, 2)."""
    results = _in_mesh(world, "ppl_mixtral")
    assert len(results) == 4 and all(r == results[0] for r in results)
    np.testing.assert_allclose(results[0], world["want"]["ppl_mixtral"],
                               rtol=PPL_RTOL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_sequence_sharded_forward_matches_jax(world, kernel):
    results = _in_mesh(world, f"seqfwd_{kernel}")
    assert len(results) == 4
    for r in results:
        np.testing.assert_allclose(r.numpy(), world["want"]["seqfwd"],
                                   atol=2e-5, rtol=2e-5)


def test_megatron_collectives_give_one_process_gradients(world):
    """copy_to_model / reduce_from_model on a (2, 2) mesh (a model axis
    of two ranks): the output and the gradients of x and of both weights
    are one process's autograd; one all-reduce each way under grad, and
    the psum alone under no_grad."""
    w = world["worlds"]["mlp"]
    x, a, b = (w[k].clone().requires_grad_() for k in ("x", "a", "b"))
    y = torch.tanh(x @ a) @ b
    (y * y).sum().backward()
    for r in _in_mesh(world, "collectives"):
        for got, want in ((r["y"], y), (r["y_nograd"], y), (r["dx"], x.grad),
                          (r["da"], a.grad), (r["db"], b.grad)):
            np.testing.assert_allclose(got.numpy(), want.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
        assert r["calls"] == [1, 1, 1]


@pytest.mark.parametrize("cid", [c[0] for c in LOAD_CASES])
def test_shards_loaded_from_disk_are_the_whole_params_shards(world, cid):
    """Every rank of the mesh reads its own blocks of the checkpoint
    (``load_hf_params(mesh=)``; with ``quantize``, quantized on the shards,
    W8's row-parallel absmax taken over the model axis; with
    ``roundtrip``, ``train --quantize_base``'s round trip on the shards,
    a W4 group straddling two ranks at (1, 4)) and gets ``shard_tree`` of
    the whole params (quantized or round-tripped whole), every leaf equal
    in dtype and every bit."""
    mesh = next(m for c, _, m, _ in LOAD_CASES if c == cid)
    results = _in_mesh(world, cid)
    assert len(results) == mesh[0] * mesh[1]
    for r in results:
        assert r["leaves"] > 0 and r["differ"] == []
