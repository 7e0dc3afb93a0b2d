"""PyTorch port: shard on load. Each rank of a ``(data, model)`` mesh reads
only its own blocks of an HF checkpoint (``load_hf_params(mesh=)``) and of
a delta artifact (``load_delta(mesh=, vocab=)``), straight from the files
(``core/artifact.py::StoredTensor``), on the CPU in one process.

A rank here is a stand-in for a ``DeviceMesh``: its shape and one rank's
coordinates, all that ``parallel/sharding.py::block_of`` reads. Every
rank of each mesh is loaded in turn. The loaders' collectives (W8's
absmax over the model axis) and the engine on loaded shards run in the
rank worlds of ``tests/test_torch_serving_mesh.py`` and
``tests/test_torch_train_mesh.py``.

Tolerance: none. Every loaded leaf equals, in dtype and every bit, the
shard (``shard_tree``'s block under the leaf's spec) of the whole
tensor: JAX's ``load_hf_params`` for fp32 checkpoints, the port's whole
path (held to JAX by ``tests/test_torch_hf_import.py``) for bf16 and fp16
ones; the streamed export writes ``save_full_model``'s file byte for
byte.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bitdelta_torch.core import artifact as tart
from bitdelta_torch.core.compress import compress_model, fuse_compressed
from bitdelta_torch.core.export import fused_checkpoint, save_full_model
from bitdelta_torch.models import hf_import as thf
from bitdelta_torch.models import llama
from bitdelta_torch.models import mixtral as tmx
from bitdelta_torch.models.config import ModelConfig
from bitdelta_torch.models.mixtral import MixtralConfig
from bitdelta_torch.parallel import sharding as psh
from bitdelta_torch.research.quantized_base import roundtrip_base
from bitdelta_torch.serving import stacking
from tests.torch_mesh_worker import write_checkpoint

MESHES = [(1, 2), (2, 2), (1, 4)]


class Rank:
    """One rank of a ``(dp, tp)`` mesh, as ``parallel/collectives.py``
    reads a ``DeviceMesh``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank):
        self.shape = tuple(shape)
        self.coord = (rank // shape[1], rank % shape[1])

    def get_local_rank(self, axis):
        return self.coord[self.mesh_dim_names.index(axis)]


def _ranks(shape):
    return [Rank(shape, r) for r in range(shape[0] * shape[1])]


def _cfg(**kw):
    base = dict(vocab_size=96, hidden_size=128, intermediate_size=256,
                num_layers=2, num_heads=4, num_kv_heads=4, dtype="float32")
    base.update(kw)
    return ModelConfig(**base)


def _mixtral_cfg():
    return MixtralConfig(**dataclasses.asdict(_cfg(intermediate_size=128)),
                         num_experts=4, experts_per_token=2)


def _params(cfg, seed):
    """Params of ``cfg``'s shapes drawn from a numpy seed."""
    rng = np.random.default_rng(seed)
    model = tmx if isinstance(cfg, MixtralConfig) else llama
    shapes = model.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return jax.tree.map(lambda w: (0.25 * rng.standard_normal(
        tuple(w.shape))).astype(np.float32), shapes)


def _assert_equal(got, want):
    pairs = list(psh._pairs(got, want))
    assert pairs
    for path, a, b in pairs:
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Checkpoints of one llama and one Mixtral, stored fp32, bf16 and
    fp16 (llama, over two files) and fp32 (Mixtral, three files)."""
    root = tmp_path_factory.mktemp("shard_load")
    cfg, mcfg = _cfg(), _mixtral_cfg()
    params, mparams = _params(cfg, 1), _params(mcfg, 2)
    out = {"cfg": cfg, "mcfg": mcfg, "params": params, "root": root}
    for name, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16),
                        ("fp16", torch.float16)):
        out[name] = write_checkpoint(root / name, cfg, params, dtype)
    out["mixtral"] = write_checkpoint(root / "mixtral", mcfg, mparams,
                                      torch.float32, files=3)
    return out


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("kind", ["llama", "mixtral"])
def test_every_ranks_load_is_the_shard_of_jaxs_whole_params(ckpts, kind,
                                                           shape):
    """fp32 checkpoints: each rank's ``load_hf_params(mesh=)`` against the
    block of JAX's whole ``load_hf_params`` under ``param_specs``."""
    from bitdelta_tpu.models import hf_import as jhf

    ckpt = ckpts["fp32" if kind == "llama" else "mixtral"]
    cfg = ckpts["cfg" if kind == "llama" else "mcfg"]
    _, jwhole = jhf.load_hf_params(ckpt, dtype=jnp.float32)
    whole = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), jwhole)
    for rank in _ranks(shape):
        _, got = thf.load_hf_params(ckpt, cfg, torch.float32, "cpu",
                                    mesh=rank)
        _assert_equal(got, psh.shard_tree(whole, psh.param_specs(cfg), rank))


@pytest.mark.parametrize("stored,dtype", [("bf16", torch.bfloat16),
                                          ("bf16", torch.float32),
                                          ("fp16", torch.bfloat16)])
def test_load_casts_each_block_as_the_whole_path_casts(ckpts, stored, dtype):
    """bf16 and fp16 files, loaded as bf16 or fp32: the cast runs on the
    block and gives the whole path's values."""
    cfg = ckpts["cfg"]
    _, whole = thf.load_hf_params(ckpts[stored], cfg, dtype, "cpu")
    for rank in _ranks((2, 2)) + _ranks((1, 4)):
        _, got = thf.load_hf_params(ckpts[stored], cfg, dtype, "cpu",
                                    mesh=rank)
        _assert_equal(got, psh.shard_tree(whole, psh.param_specs(cfg), rank))


def test_meta_load_reads_nothing_and_gives_the_whole_shapes(ckpts,
                                                           monkeypatch):
    cfg = ckpts["cfg"]
    _, whole = thf.load_hf_params(ckpts["bf16"], cfg, torch.bfloat16, "cpu")
    monkeypatch.setattr(os, "preadv", None)     # any read would fail
    _, meta = thf.load_hf_params(ckpts["bf16"], cfg, torch.bfloat16, "meta")
    for _, m, w in psh._pairs(meta, whole):
        assert m.device.type == "meta"
        assert (m.shape, m.dtype) == (w.shape, w.dtype)


def test_loader_reads_and_keeps_only_the_block(ckpts, monkeypatch):
    """A rank of (1, 4) reads from the files exactly its shard's bytes (a
    row-parallel block is a column block of every HF row: one read a
    row), and every leaf it returns owns exactly its own bytes (no view
    of a larger buffer)."""
    cfg = ckpts["cfg"]
    read = []
    real = os.preadv

    def counting(fd, buffers, offset):
        read.append(sum(len(b) for b in buffers))
        return real(fd, buffers, offset)
    monkeypatch.setattr(os, "preadv", counting)
    rank = Rank((1, 4), 2)
    _, got = thf.load_hf_params(ckpts["bf16"], cfg, torch.bfloat16, "cpu",
                                mesh=rank)
    leaves = [t for _, t, _ in psh._pairs(got, got)]
    shard_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert sum(read) == shard_bytes
    # o_proj and down_proj: a read for each of HF's N rows, each layer.
    assert len(read) >= cfg.num_layers * 2 * cfg.hidden_size
    for t in leaves:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mesh_none_paths_return_what_they_did(ckpts):
    """``load_hf_params`` and ``load_delta`` without a mesh read through
    the memory-mapped whole path as before: the params are the exported
    ones, the artifact is what was saved, and a one-rank mesh's blocks
    (the new path) equal both."""
    cfg, params = ckpts["cfg"], ckpts["params"]
    _, got = thf.load_hf_params(ckpts["fp32"], cfg, torch.float32, "cpu")
    want = jax.tree.map(torch.from_numpy, params)
    _assert_equal(got, want)
    _, one = thf.load_hf_params(ckpts["fp32"], cfg, torch.float32, "cpu",
                                mesh=Rank((1, 1), 0))
    _assert_equal(one, want)
    comp = compress_model(want, _finetune(want, 3))
    path = str(ckpts["root"] / "one.safetensors")
    tart.save_delta(path, comp, cfg)
    loaded, lcfg = tart.load_delta(path, device="cpu")
    assert lcfg == cfg
    _assert_equal(loaded, comp)
    blocks, _ = tart.load_delta(path, device="cpu", mesh=Rank((1, 1), 0))
    _assert_equal(blocks, comp)


def _finetune(params, seed, vocab=None):
    g = torch.Generator().manual_seed(seed)

    def moved(w):
        return w + 0.02 * torch.randn(w.shape, generator=g, dtype=w.dtype)
    fine = dict(params)
    fine["layers"] = {n: moved(w) if n in llama.PROJ_NAMES else w
                      for n, w in params["layers"].items()}
    v = vocab or params["embed"].shape[0]
    fine["embed"] = moved(params["embed"][:v])
    if "lm_head" in params:
        fine["lm_head"] = moved(params["lm_head"][:, :v])
    return fine


@pytest.mark.parametrize("shape", MESHES)
def test_delta_blocks_are_the_shards_of_the_padded_whole(ckpts, shape):
    """Tenants of 96 and 90 rows padded to 96 (``stack_tenants``'s
    padding): each rank's deltas and extras from ``load_delta(mesh=,
    vocab=96)`` against the shard of the whole artifact, the embed's rows
    and head's columns past the tenant's own zero."""
    cfg, params = ckpts["cfg"], jax.tree.map(torch.from_numpy,
                                             ckpts["params"])
    for t, vocab in enumerate((96, 90)):
        comp = compress_model(params, _finetune(params, 10 + t, vocab))
        path = str(ckpts["root"] / f"tenant{t}.safetensors")
        tart.save_delta(path, comp, cfg)
        whole, _ = tart.load_delta(path, device="cpu")
        padded = whole.extras.copy()
        padded["embed"] = stacking._pad_vocab(whole.extras["embed"], 96, 0)
        padded["lm_head"] = stacking._pad_vocab(whole.extras["lm_head"],
                                                96, 1)
        for rank in _ranks(shape):
            got, _ = tart.load_delta(path, device="cpu", mesh=rank, vocab=96)
            _assert_equal(got.deltas, psh.shard_tree(
                whole.deltas, psh.delta_specs(cfg, keys=whole.deltas), rank))
            _assert_equal(got.extras, psh.shard_tree(
                padded, psh.extras_specs(cfg, keys=padded), rank))


def test_stored_tensor_reads_an_unaligned_block_and_zero_fills(tmp_path):
    """A tensor at an offset its dtype does not divide (the port's writer
    packs tensors back to back): a column block read exactly, and a block
    past the end zero-filled."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 10)).astype(np.float32)
    path = str(tmp_path / "odd.safetensors")
    tart.write_safetensors(path, {"a": np.arange(3, dtype=np.int8), "b": w})
    stored = dict(tart.stored_tensors(path))["b"]
    assert stored.offset % 4
    np.testing.assert_array_equal(stored.read([(1, 4), (3, 5)]).numpy(),
                                  w[1:5, 3:8])
    got = stored.read([(4, 4), (0, 10)]).numpy()
    np.testing.assert_array_equal(got[:2], w[4:])
    assert not got[2:].any()


def test_check_stack_shard_refuses_a_shard_of_other_shapes(ckpts):
    cfg, params = ckpts["cfg"], jax.tree.map(torch.from_numpy,
                                             ckpts["params"])
    tenants = [compress_model(params, _finetune(params, 20))]
    whole = stacking.stack_tenants(cfg, params, tenants, device="cpu")
    rank = Rank((1, 2), 1)
    local = psh.shard_stack(cfg, whole, rank)
    psh.check_stack_shard(cfg, local, whole, rank)
    layers = dict(local.params["layers"], o_proj=psh.shard_tensor(
        whole.params["layers"]["o_proj"], (None, None, "model"), rank))
    bad = local._replace(params=dict(local.params, layers=layers))
    with pytest.raises(ValueError, match="layers/o_proj"):
        psh.check_stack_shard(cfg, bad, whole, rank)


def test_engine_takes_a_stack_shard_only_over_its_mesh(ckpts):
    from bitdelta_torch.serving.engine import Engine

    cfg, params = ckpts["cfg"], jax.tree.map(torch.from_numpy,
                                             ckpts["params"])
    whole = stacking.stack_tenants(
        cfg, params, [compress_model(params, _finetune(params, 21))],
        device="cpu")
    with pytest.raises(ValueError, match="over its mesh"):
        Engine(cfg, stacking.StackShard(local=whole, whole=whole),
               device="cpu", kernel="torch")


@pytest.mark.parametrize("tied,embeddings,base_quant", [
    (False, False, None), (False, True, "int8"), (True, False, "int4"),
    (True, True, None)])
def test_streamed_export_writes_save_full_models_bytes(tmp_path, tied,
                                                      embeddings,
                                                      base_quant):
    """``train --mesh --save_full_model``'s writer, which reads the base
    from its checkpoint one tensor at a time, against ``save_full_model``
    of the whole fused params: the same file, byte for byte."""
    cfg = _cfg(tie_word_embeddings=tied, dtype="bfloat16")
    params = _params(cfg, 7)
    ckpt = write_checkpoint(tmp_path / "base", cfg, params, torch.bfloat16)
    _, base = thf.load_hf_params(ckpt, cfg, torch.bfloat16, "cpu")
    if base_quant:
        base = roundtrip_base(base, base_quant, torch.bfloat16)
    fine = _finetune(base, 30)
    fine["embed"] = base["embed"] + 0.01
    comp = compress_model(base, fine, compress_embeddings=embeddings)
    save_full_model(cfg, fuse_compressed(base, comp), str(tmp_path / "w"))
    save_full_model(cfg, fused_checkpoint(cfg, ckpt, comp,
                                          dtype=torch.bfloat16,
                                          base_quant=base_quant),
                    str(tmp_path / "s"))
    for name in ("model.safetensors", "config.json"):
        assert filecmp.cmp(tmp_path / "w" / name, tmp_path / "s" / name,
                           shallow=False)
