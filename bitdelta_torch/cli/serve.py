"""Multi-tenant serving CLI (port of ``bitdelta_tpu/cli/serve.py``): load
one base model and N delta artifacts (one per tenant), stack them, and
serve ``/models`` + ``/generate`` (streaming NDJSON).

Tenants come from repeated ``--delta name=path`` flags or a JSON registry
file: ``[{"name": ..., "diff_path": ..., "system_prompt": ...}, ...]``.

Usage:
  python -m bitdelta_torch.cli.serve --base_model <dir> \\
      --delta vicuna=out/vicuna/diff.safetensors \\
      --delta zephyr=out/zephyr/diff.safetensors --port 8000

Runs on the card; ``--device cpu`` runs on the CPU.

Tensor and data parallelism: ``--mesh dp,tp`` with one process a rank,
started by ``python -m torch.distributed.run --nproc-per-node dp*tp -m
bitdelta_torch.cli.serve --mesh dp,tp ...``. Every rank reads its own
blocks of the base checkpoint and of the tenants' artifacts straight from
the files to its card (``serving/stacking.py::load_stack_shard``): no
rank holds the whole stack, and its host holds one checkpoint block at a
time. Rank 0 serves HTTP and the other
ranks replay its engine calls until it stops (on SIGTERM or SIGINT, which
the other ranks leave to it).
"""

from __future__ import annotations

import argparse
import json
import signal

from . import args as A
from ..core.artifact import load_delta, read_header
from ..device import resolve_device, torch_dtype
from ..models import llama, resolve_model_module
from ..models.hf_import import load_hf_config, load_hf_params
from ..serving.engine import Engine
from ..serving.server import ServingApp, TenantInfo, make_http_server
from ..serving.stacking import load_stack_shard, stack_nbytes, stack_tenants
from ..utils.tokenizer import get_tokenizer


def main(argv=None):
    p = argparse.ArgumentParser("bitdelta_torch.serve")
    A.add_model_args(p)
    A.add_mesh_args(p)
    p.add_argument("--delta", action="append", default=[],
                   metavar="NAME=PATH", help="tenant delta artifact")
    p.add_argument("--registry", type=str, default=None,
                   help="JSON tenant registry (supported_models.json shape)")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="tokenizer source (default: base model dir)")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--max_seq", type=int, default=1024)
    p.add_argument("--decode_chunk", type=int, default=8,
                   help="decode steps chained per host sync (stops "
                        "truncate host-side)")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip the warmup of the prefill buckets and "
                        "decode at boot")
    p.add_argument("--kv_dtype", type=str, default=None,
                   choices=("bf16", "int8"),
                   help="KV-cache storage: int8 halves the decode cache "
                        "traffic on the card and doubles capacity "
                        "(llama family)")
    p.add_argument("--smoke_test", action="store_true",
                   help="generate a few tokens from every tenant and exit")
    args = p.parse_args(argv)
    mesh = A.make_cli_mesh(args.mesh, args.device)
    device = resolve_device(args.device)

    tenant_specs = []
    for spec in args.delta:
        name, _, path = spec.partition("=")
        if not path:
            raise SystemExit(f"--delta expects NAME=PATH, got {spec!r}")
        tenant_specs.append({"name": name, "diff_path": path})
    if args.registry:
        with open(args.registry) as f:
            tenant_specs.extend(json.load(f))
    if not tenant_specs:
        raise SystemExit("no tenants: pass --delta or --registry")

    dtype = torch_dtype(args.dtype)
    # W{8,4}+W1 artifacts: serve the quantized base (the deltas were
    # taken against its dequantized values, so this is exact).
    base_quants = {read_header(spec["diff_path"])[1].get("base_quant")
                   for spec in tenant_specs}
    if len(base_quants) > 1:
        raise SystemExit(f"tenants disagree on base_quant: {base_quants}")
    base_quant = base_quants.pop()
    if base_quant not in (None, "int8", "int4"):
        raise SystemExit(f"unsupported artifact base_quant {base_quant!r}")
    if base_quant is not None:
        print(f"artifacts were built against an {base_quant} base — "
              f"serving the quantized base", flush=True)
    if mesh is not None:
        print(f"sharding stack over mesh {tuple(mesh.shape)} (data, model):"
              f" each rank reads its blocks of {args.base_model} and of "
              f"{len(tenant_specs)} tenants", flush=True)
        cfg = load_hf_config(args.base_model)
        stack = load_stack_shard(
            cfg, args.base_model, [s["diff_path"] for s in tenant_specs],
            mesh, dtype=dtype, device=device, base_quant=base_quant)
        mem = stack_nbytes(stack.local)
        scope = "this rank's shard: "
    else:
        stack, cfg = _load_whole(args, tenant_specs, dtype, device,
                                 base_quant)
        mem = stack_nbytes(stack)
        scope = ""
    print(f"{scope}base {mem['base_bytes']/1e9:.2f} GB + "
          f"{mem['per_tenant_bytes']/1e9:.3f} GB/tenant "
          f"x {len(tenant_specs)} tenants", flush=True)

    tokenizer = get_tokenizer(args.tokenizer or args.base_model)
    tenants = [TenantInfo(spec["name"], tokenizer,
                          system_prompt=spec.get("system_prompt", ""))
               for spec in tenant_specs]

    model_mod = resolve_model_module(cfg)
    if model_mod is not llama:
        print("mixtral checkpoint: serving the MoE decoder", flush=True)
    engine = Engine(cfg, stack, max_slots=args.max_slots,
                    max_seq=args.max_seq,
                    kernel=A.resolve_kernel(args.kernel, device),
                    compute_dtype=dtype, model=model_mod,
                    decode_chunk=args.decode_chunk, device=device,
                    kv_dtype=args.kv_dtype, mesh=mesh)
    del stack
    if engine.rank != 0:
        _follow(engine)
        return
    try:
        _lead(args, engine, tenants)
    finally:
        engine.stop_followers()
        if mesh is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _load_whole(args, tenant_specs, dtype, device, base_quant):
    """The whole stack on ``device`` (one process, no mesh)."""
    print(f"loading base {args.base_model} ...", flush=True)
    cfg, base = load_hf_params(args.base_model, dtype=dtype, device=device)
    compressed = []
    for spec in tenant_specs:
        print(f"loading tenant {spec['name']} ...", flush=True)
        compressed.append(load_delta(spec["diff_path"], device=device)[0])
    if base_quant is not None:
        from ..research.quantized_base import quantize_base

        base = quantize_base(base, base_quant)
    return stack_tenants(cfg, base, compressed, device=device), cfg


def _follow(engine: Engine) -> None:
    """A rank > 0: replay rank 0's calls; stop when rank 0 says so."""
    import torch.distributed as dist

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    print(f"[rank {engine.rank}] following rank 0", flush=True)
    engine.follow()
    dist.destroy_process_group()
    print(f"[rank {engine.rank}] stopped", flush=True)


def _lead(args, engine: Engine, tenants) -> None:
    if engine.mesh is not None and engine.mesh.size() > 1:
        # SIGTERM (torchrun's stop) ends serve_forever like Ctrl-C, so the
        # followers are released.
        signal.signal(signal.SIGTERM, signal.default_int_handler)
    if not args.no_warmup:
        print("warming prefill buckets "
              f"{list(engine.prefill_buckets)} + decode ...", flush=True)
        engine.warmup()
        print(f"warmed: {engine.warmed}", flush=True)
    app = ServingApp(engine, tenants)
    if args.smoke_test:
        try:
            for line in app.generate_stream({"prompt": "Hello",
                                             "max_new_tokens": 4}):
                print(line, end="", flush=True)
        finally:
            app.close()     # the stepper thread holds the engine
        print("[smoke ok]")
        return
    server = make_http_server(app, args.host, args.port)
    print(f"serving {len(tenants)} tenants on "
          f"http://{args.host}:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[rank 0] stopping", flush=True)
    finally:
        server.server_close()
        app.close()


if __name__ == "__main__":
    main()
