"""One rank of a CPU mesh for the port's tensor/data-parallel tests.

Run by ``tests/test_torch_parallel.py``,
``tests/test_torch_serving_mesh.py`` and ``tests/test_torch_train_mesh.py``
(never collected by pytest)::

    python tests/torch_mesh_worker.py RANK WORLD INIT JOB OUT

It imports ``bitdelta_torch`` and torch only. ``JOB`` is a ``torch.save``
file the test wrote: ``{"worlds": {name: {...}}, "cases": [...]}``.
The rank joins a gloo world through ``INIT`` (a ``file://`` store or a
``tcp://`` coordinator address), runs every case in order on a ``(dp,
tp)`` mesh of the first ``dp * tp`` ranks, and writes ``{case id:
result}`` to ``OUT`` (rank 0's engine tokens; every rank's host state for
a replay; None on a rank outside the case's mesh). Cases:

* ``engine``: greedy tokens of ``Engine(mesh=)`` on a stack (rank 0
  generates, the other ranks follow);
* ``refuse``: the ``ValueError`` message of an engine the mesh refuses;
* ``logits``: a model-level prefill and one decode step, batch rows over
  the data axis and the model over the model axis, logits gathered;
* ``replay``: a scripted sequence of engine calls on rank 0 (warmup,
  submit, pump, a refused request, cancel, step, generate); every rank
  reports its host state;
* ``roundtrip``: a serving stack in the pair layout sharded
  (``shard_stack``) and gathered back (``gather_tree``): True when every
  leaf comes back equal;
* ``distill``: ``distill_scales(mesh=)`` on the world's shards: the
  losses and the scales, and with ``"grads"`` the summed scale gradients
  of one step from the initial scales (``make_distill_step(mesh=)``);
* ``compress``: ``compress_model`` / ``compress_mixtral`` on the shards,
  gathered whole;
* ``ppl``: ``eval_ppl(mesh=)``; ``seqfwd``: one forward with the
  sequence split over the data axis, the logits gathered whole;
* ``collectives``: a column-parallel and a row-parallel matmul through
  ``copy_to_model`` / ``reduce_from_model``, its output, the gradients
  of its input and weights gathered whole, and the calls counted;
* ``shard_load``: a world written to disk (an HF checkpoint and delta
  artifacts): this rank's ``load_stack_shard``, paired with
  ``to_pair_layout(local=True)``, against ``shard_stack`` of the whole
  stack read by one process and paired for the model axis: the leaves
  that differ (dtype or any bit) and how many were compared; then the
  same for the shard an engine built on it paired in place
  (``"in_place"``), and whether a second engine on it shares the first
  one's deltas (``"shared"``);
* ``load_params``: ``load_hf_params(mesh=)`` of a checkpoint, with
  ``"quantize"`` quantized on the shards (``quantize_base(mesh=)``) or
  with ``"roundtrip"`` round-tripped on them (``roundtrip_base(mesh=)``),
  against the shard of the whole params treated so: the leaves that
  differ and how many were compared.

An ``engine`` or ``refuse`` case on a world written to disk builds its
engine on the rank's ``load_stack_shard``.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from bitdelta_torch.core.artifact import load_delta  # noqa: E402
from bitdelta_torch.core.compress import get_scales  # noqa: E402
from bitdelta_torch.eval.ppl import eval_ppl  # noqa: E402
from bitdelta_torch.models import llama, mixtral  # noqa: E402
from bitdelta_torch.models.hf_import import load_hf_params  # noqa: E402
from bitdelta_torch.parallel import collectives as coll  # noqa: E402
from bitdelta_torch.parallel import mesh as pmesh  # noqa: E402
from bitdelta_torch.parallel import sharding as psh  # noqa: E402
from bitdelta_torch.parallel.collectives import all_gather  # noqa: E402
from bitdelta_torch.train import distill  # noqa: E402
from bitdelta_torch.serving.engine import Engine, Request  # noqa: E402
from bitdelta_torch.research import quantized_base as qb  # noqa: E402
from bitdelta_torch.serving.stacking import (  # noqa: E402
    load_stack_shard, stack_tenants, to_pair_layout)

MODELS = {"llama": llama, "mixtral": mixtral}


def _disk_stack(world, mesh):
    """This rank's ``StackShard`` of a world written to disk."""
    return load_stack_shard(world["cfg"], world["base_dir"], world["deltas"],
                            mesh, dtype=torch.float32, device="cpu",
                            base_quant=world.get("base_quant"))


def _engine(world, case, mesh):
    kw = {} if case.get("kv_dtype") is None else {"kv_dtype": case["kv_dtype"]}
    stack = (_disk_stack(world, mesh) if "base_dir" in world
             else world["stack"])
    return Engine(world["cfg"], stack, max_slots=case["max_slots"],
                  max_seq=64, prefill_buckets=(16,), kernel=case["kernel"],
                  device="cpu", model=MODELS[world.get("model", "llama")],
                  mesh=mesh, **kw)


def _requests(case):
    return [Request(**r) for r in case["requests"]]


def run_engine(world, case, mesh):
    eng = _engine(world, case, mesh)
    if eng.rank != 0:
        eng.follow()
        return None
    try:
        return [list(map(int, o)) for o in eng.generate(_requests(case))]
    finally:
        eng.stop_followers()


def run_refuse(world, case, mesh):
    try:
        _engine(world, case, mesh)
    except ValueError as e:
        return str(e)
    return None


def run_logits(world, case, mesh):
    """Model-level forward (prefill with a cache) and decode step."""
    cfg = world["cfg"]
    model = MODELS[world.get("model", "llama")]
    local = psh.local_config(cfg, mesh)
    params = psh.shard_model(cfg, world["params"], mesh)
    deltas = psh.shard_deltas(cfg, world["deltas"], mesh)
    tokens = psh.shard_tensor(case["tokens"], psh.batch_spec(), mesh)
    nxt = psh.shard_tensor(case["next"], psh.batch_spec(), mesh)
    kw = dict(deltas=deltas, compute_dtype=torch.float32,
              kernel=case["kernel"], tp_group=mesh)
    with torch.no_grad():
        full = model.forward(local, params, tokens, **kw)
        _, cache = model.forward(local, params, tokens, return_cache=True,
                                 cache_max_seq=16, **kw)
        step, _ = model.decode_step(local, params, nxt, cache, **kw)

    def gather(x):
        x = all_gather(x, mesh, pmesh.MODEL_AXIS, dim=-1)
        return all_gather(x, mesh, pmesh.DATA_AXIS, dim=0)
    return {"forward": gather(full), "decode": gather(step)}


def _host_state(eng):
    return {"slots": [(s.active, list(s.generated), s.tenant_id, s.epoch)
                      for s in eng.slots],
            "tenant_ids": eng.tenant_ids.tolist(),
            "last_tokens": eng._last_tokens.tolist(),
            "cache_length": all_gather(eng.cache.length, eng.mesh,
                                       pmesh.DATA_AXIS, dim=0).tolist()}


def replay_script(eng):
    """The leader's calls (also run on one device for the reference)."""
    out = {"warmed": eng.warmup()}
    eng.submit(Request(prompt_ids=[3, 5, 7], tenant_id=0, max_new_tokens=6,
                       request_id="a"))
    out["pumped"] = [[(e.slot, e.token) for e in eng.pump()]
                     for _ in range(2)]
    try:
        eng.submit(Request(prompt_ids=[], tenant_id=0))
    except ValueError as e:
        out["refused"] = str(e)
    eng.submit(Request(prompt_ids=[2, 4], tenant_id=1, max_new_tokens=4,
                       request_id="b"))
    out["cancelled"] = eng.cancel("a")
    steps = []
    while any(s.active for s in eng.slots):
        steps.append([(e.slot, e.token, e.finished) for e in eng.step()])
    out["steps"] = steps
    out["generated"] = eng.generate(
        [Request(prompt_ids=[8, 1], tenant_id=t, max_new_tokens=3)
         for t in (0, 1)])
    return out


def run_replay(world, case, mesh):
    eng = _engine(world, case, mesh)
    if eng.rank == 0:
        try:
            out = replay_script(eng)
        finally:
            eng.stop_followers()
    else:
        eng.follow()
        out = {}
    out["state"] = _host_state(eng)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def run_roundtrip(world, case, mesh):
    cfg, tp = world["cfg"], case["mesh"][1]
    full = to_pair_layout(world["stack"], tp=tp)
    local = psh.shard_stack(cfg, full, mesh)
    back = (psh.gather_tree(local.params, psh.serving_param_specs(
                cfg, full.params, tp=tp), mesh),
            psh.gather_tree(local.deltas,
                            psh.serving_delta_specs(full.deltas), mesh))
    pairs = list(zip(_leaves(back), _leaves((full.params, full.deltas))))
    return len(pairs) > 0 and all(torch.equal(a, b) for a, b in pairs)


def _differ(got, want):
    """``{"leaves": how many, "differ": [indices of the leaves whose dtype
    or any bit differs]}`` of two trees of one structure."""
    pairs = list(zip(_leaves(got), _leaves(want)))
    return {"leaves": len(pairs),
            "differ": [i for i, (a, b) in enumerate(pairs)
                       if a.dtype != b.dtype or not torch.equal(a, b)]}


def run_shard_load(world, case, mesh):
    cfg, tp = world["cfg"], case["mesh"][1]
    shard = _disk_stack(world, mesh)
    psh.check_stack_shard(cfg, shard.local, shard.whole, mesh)
    got = to_pair_layout(shard.local, tp=tp, local=True)
    _, base = load_hf_params(world["base_dir"], cfg, torch.float32, "cpu")
    if world.get("base_quant"):
        base = qb.quantize_base(base, world["base_quant"])
    whole = stack_tenants(cfg, base, [load_delta(p, "cpu")[0]
                                      for p in world["deltas"]], "cpu")
    want = psh.shard_stack(cfg, to_pair_layout(whole, tp=tp), mesh)
    out = _differ((got.params, got.deltas, got.vocab_sizes),
                  (want.params, want.deltas, want.vocab_sizes))
    # An engine takes the shard over and pairs it in place; a second
    # engine on the same StackShard finds it paired and shares its leaves.
    kw = dict(max_slots=2, max_seq=64, prefill_buckets=(16,),
              kernel="cuda", device="cpu", mesh=mesh,
              model=MODELS[world.get("model", "llama")])
    first = Engine(cfg, shard, **kw)
    out["in_place"] = _differ(
        (shard.local.params, shard.local.deltas, shard.local.vocab_sizes),
        (want.params, want.deltas, want.vocab_sizes))
    second = Engine(cfg, shard, **kw)
    out["shared"] = all(a is b for a, b in zip(
        _leaves(first.stack.deltas), _leaves(second.stack.deltas)))
    return out


QUANTIZE = {"int8": lambda p, mesh: qb.quantize_base(p, "int8", mesh),
            "int4": lambda p, mesh: qb.quantize_base(p, "int4", mesh)}


def run_load_params(world, case, mesh):
    cfg, ckpt = world["cfg"], world["ckpt"]
    dtype = case.get("dtype", torch.float32)
    _, got = load_hf_params(ckpt, cfg, dtype, "cpu", mesh=mesh)
    _, whole = load_hf_params(ckpt, cfg, dtype, "cpu")
    if case.get("quantize"):
        quantize = QUANTIZE[case["quantize"]]
        got, whole = quantize(got, mesh), quantize(whole, None)
        specs = psh.serving_param_specs(cfg, whole, tp=case["mesh"][1])
    elif case.get("roundtrip"):
        got = qb.roundtrip_base(got, case["roundtrip"], dtype, mesh)
        whole = qb.roundtrip_base(whole, case["roundtrip"], dtype)
        specs = psh.param_specs(cfg)
    else:
        specs = psh.param_specs(cfg)
    return _differ(got, psh.shard_tree(whole, specs, mesh))


def _sharded_compressed(cfg, comp, mesh):
    return comp._replace(
        deltas=psh.shard_deltas(cfg, comp.deltas, mesh),
        extras=psh.shard_tree(comp.extras, psh.extras_specs(
            cfg, keys=comp.extras.keys()), mesh))


def run_distill(world, case, mesh):
    """Distillation over the mesh from the world's whole base, fine-tune
    and compressed model, each sharded here as JAX's tests shard them."""
    cfg = world["cfg"]
    model = MODELS[world.get("model", "llama")]
    base = psh.shard_model(cfg, world["base"], mesh)
    fine = psh.shard_model(cfg, world["fine"], mesh)
    comp = _sharded_compressed(cfg, world["comp"], mesh)
    dcfg = distill.DistillConfig(lr=1e-3, num_steps=len(world["batches"]),
                                 compute_dtype="float32",
                                 kernel=case["kernel"])
    out, losses = distill.distill_scales(cfg, base, fine, comp,
                                         world["batches"], dcfg, mesh=mesh,
                                         model=model)
    result = {"losses": losses, "scales": get_scales(out)}
    if case.get("grads"):
        scales = {n: s.detach().clone().requires_grad_()
                  for n, s in get_scales(comp).items()}
        distill.make_distill_step(
            cfg, dcfg, base, fine, comp, scales,
            distill.make_optimizer(scales, dcfg), model=model,
            mesh=mesh)(torch.as_tensor(world["batches"][0]).long())
        result["grads"] = {n: s.grad.clone() for n, s in scales.items()}
    return result


def run_compress(world, case, mesh):
    cfg = world["cfg"]
    base = psh.shard_model(cfg, world["base"], mesh)
    fine = psh.shard_model(cfg, world["fine"], mesh)
    kw = dict(compress_embeddings=case.get("compress_embeddings", False),
              mesh=mesh)
    if world.get("model") == "mixtral":
        comp = mixtral.compress_mixtral(base, fine, **kw)
    else:
        from bitdelta_torch.core.compress import compress_model

        comp = compress_model(base, fine, **kw)
    return comp._replace(
        deltas=psh.gather_tree(comp.deltas, psh.delta_specs(
            cfg, keys=comp.deltas.keys()), mesh),
        extras=psh.gather_tree(comp.extras, psh.extras_specs(
            cfg, keys=comp.extras.keys()), mesh))


def run_ppl(world, case, mesh):
    cfg = world["cfg"]
    deltas = world.get("deltas")
    if deltas is not None:
        deltas = psh.shard_deltas(cfg, deltas, mesh)
    return eval_ppl(cfg, psh.shard_model(cfg, world["params"], mesh),
                    case["tokens"], context_size=case["context_size"],
                    window_size=case["window_size"], deltas=deltas,
                    compute_dtype=torch.float32, kernel=case["kernel"],
                    model=MODELS[world.get("model", "llama")], mesh=mesh)


def run_seqfwd(world, case, mesh):
    cfg = world["cfg"]
    tokens = case["tokens"]
    chunk = tokens.shape[1] // coll.axis_size(mesh, pmesh.DATA_AXIS)
    t0 = coll.axis_index(mesh, pmesh.DATA_AXIS) * chunk
    with torch.no_grad():
        logits = llama.forward(
            psh.local_config(cfg, mesh),
            psh.shard_model(cfg, world["params"], mesh),
            tokens[:, t0:t0 + chunk],
            deltas=psh.shard_deltas(cfg, world["deltas"], mesh),
            compute_dtype=torch.float32, kernel=case["kernel"],
            tp_group=mesh, seq_group=mesh)
    logits = all_gather(logits, mesh, pmesh.MODEL_AXIS, dim=-1)
    return all_gather(logits, mesh, pmesh.DATA_AXIS, dim=1)


def run_collectives(world, case, mesh):
    """``y = reduce(tanh(copy(x) @ a_local) @ b_local)``, the loss
    ``sum(y^2)`` replicated on the model axis."""
    tp = coll.axis_size(mesh, pmesh.MODEL_AXIS)
    m = coll.axis_index(mesh, pmesh.MODEL_AXIS)
    x = world["x"].clone().requires_grad_()
    n = world["a"].shape[1] // tp
    a = world["a"][:, m * n:(m + 1) * n].clone().requires_grad_()
    b = world["b"][m * n:(m + 1) * n].clone().requires_grad_()
    calls = (coll.copy_to_model.calls, coll.reduce_from_model.calls,
             coll.psum.calls)
    y = coll.reduce_from_model(
        torch.tanh(coll.copy_to_model(x, mesh) @ a) @ b, mesh)
    (y * y).sum().backward()
    with torch.no_grad():
        y_nograd = coll.reduce_from_model(
            torch.tanh(coll.copy_to_model(x, mesh) @ a) @ b, mesh)
    return {"y": y.detach(), "y_nograd": y_nograd, "dx": x.grad,
            "da": all_gather(a.grad, mesh, pmesh.MODEL_AXIS, 1),
            "db": all_gather(b.grad, mesh, pmesh.MODEL_AXIS, 0),
            "calls": [after - before for after, before in zip(
                (coll.copy_to_model.calls, coll.reduce_from_model.calls,
                 coll.psum.calls), calls)]}


RUN = {"engine": run_engine, "refuse": run_refuse, "logits": run_logits,
       "replay": run_replay, "roundtrip": run_roundtrip,
       "distill": run_distill, "compress": run_compress, "ppl": run_ppl,
       "seqfwd": run_seqfwd, "collectives": run_collectives,
       "shard_load": run_shard_load, "load_params": run_load_params}


def write_checkpoint(path, cfg, params, dtype, files=2) -> str:
    """Params (the port's layout, numpy arrays) as an HF checkpoint under
    the new directory ``path``: ``config.json`` and ``files`` safetensors
    files in ``dtype``, by the port's exporter (``core/export.py``)."""
    import json

    from bitdelta_torch.convert import tree_from_numpy
    from bitdelta_torch.core.artifact import write_safetensors
    from bitdelta_torch.core.export import hf_config_dict, hf_state_dict

    path = Path(path)
    path.mkdir()
    (path / "config.json").write_text(
        json.dumps(hf_config_dict(cfg, dtype=dtype)))
    sd = hf_state_dict(cfg, tree_from_numpy(params, "cpu"), dtype)
    keys = sorted(sd)
    for i in range(files):
        write_safetensors(str(path / f"model-{i}.safetensors"),
                          {k: sd[k] for k in keys[i::files]})
    return str(path)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(job, world_size, tmp_path, timeout=240, init=None):
    """Run ``job`` on ``world_size`` ranks (this file, one process each,
    joined through a file store under ``tmp_path``, or through ``init``, a
    ``tcp://`` coordinator address). Returns each rank's results; raises
    with the ranks' output if one fails or any is still running after
    ``timeout`` seconds (all are killed then)."""
    tmp_path = Path(tmp_path)
    job_path = tmp_path / "job.pt"
    torch.save(job, job_path)
    init = init or f"file://{tmp_path / 'store'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(world_size), init,
         str(job_path), str(tmp_path / f"out{r}.pt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world_size)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"ranks failed {bad}:\n"
                           + "\n".join(log[-3000:] for log in logs))
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(world_size)]


def main(rank, world_size, init, job_path, out_path):
    torch.set_num_threads(1)
    pmesh.initialize_multihost(init, world_size, rank, device="cpu",
                               timeout=datetime.timedelta(seconds=60))
    job = torch.load(job_path, weights_only=False)
    meshes = {}
    results = {}
    for case in job["cases"]:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = pmesh.make_mesh(shape, device="cpu")
        if meshes[shape].get_coordinate() is None:
            results[case["id"]] = None     # this rank is outside the mesh
            continue
        results[case["id"]] = RUN[case["kind"]](
            job["worlds"][case["world"]], case, meshes[shape])
    dist.barrier()
    dist.destroy_process_group()
    torch.save(results, out_path)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
