#!/usr/bin/env python3
"""Compare the Mistral-7B serving path of two or more trees on one card.

Run from the repository root on a machine with a card and nvcc::

    git archive <parent> | tar -x -C out/parent     # a git-ignored copy
    python3 scripts/ab_serving.py out/parent . . out/parent
    python3 scripts/ab_serving.py --fused out/parent . . out/parent
    python3 scripts/ab_serving.py --submit out/parent . . out/parent
    python3 scripts/ab_serving.py --density out/parent . . out/parent

Each argument is the root of a tree that holds the port
(``bitdelta_torch/``); the runs go in the order given (alternate the
trees, e.g. parent, change, change, parent, so that drift of the card or
the host falls on both). Each run is a fresh process in that tree: it
builds the tree's kernels and runs the serving phase of this
repository's ``chip_smoke.py`` (the same harness for every tree) on the
tree's package: a full-width 32-layer Mistral-7B with three synthetic
tenants behind ``Engine`` and the HTTP server (with ``--fused``, the
tenants compressed with their embeddings and served on
``kernel="cuda_fused"``, as ``chip_smoke.py``'s phase 9 serves them;
with ``--density``, the base quantized to W4 and served with the int8
KV cache, as phase 4b serves it). It prints one JSON line of the
end-to-end numbers: first token over HTTP (four rounds of one request a
tenant; the very first request warms the process up), ``generate``
tok/s, the 60- and 500-token ``submit`` times and the 500-token
prefill's device time, and a B=8 decode step's wall and device time
with its leading kernels by device time. With ``--submit`` (before
``--fused``) a run skips the HTTP phase and gives quartiles of many
samples instead: 40 single-request ``submit`` calls of a 45-token
prompt (the first-token path's prefill, bucket 64) with one's device
time, 30 B=8 decode steps, each timed alone, and the host cost of one
flash-decode wrapper call (500 calls back to back on one-key rows, five
times).
"""

import json
import subprocess
import sys
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1] / "chip_smoke.py"
RUN = """
import importlib.util, json, sys, torch
sys.path.insert(0, ".")                  # the tree's bitdelta_torch
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from bitdelta_torch.models.config import mistral_7b
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.build()
dev = torch.device("cuda")
cfg = mistral_7b()
fused = sys.argv[2] == "cuda_fused"
density = sys.argv[3] == "density"
world = cs.build_world(cfg, dev, seed=41 if fused else 0,
                       compress_embeddings=fused,
                       base_quant="int4" if density else None)
path = "fused" if fused else "density" if density else "serving"
_, rep = cs.serve(cfg, world, dev, torch.cuda.get_device_name(0),
                  path=path, kernel=sys.argv[2],
                  kv_dtype="int8" if density else None, http_rounds=4)
keys = ("http_ttft_ms", "generate_tok_s", "submit_prefill_ms",
        "prefill_500_device_ms", "decode_step_ms_b8",
        "decode_step_device_ms", "decode_step_top_kernels")
print("AB " + json.dumps({k: rep[k] for k in keys}), flush=True)
"""


RUN_SUBMIT = """
import importlib.util, json, statistics, sys, time, torch
sys.path.insert(0, ".")
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
from bitdelta_torch.models import llama
from bitdelta_torch.models.config import mistral_7b
from bitdelta_torch.serving.engine import Engine, Request
torch.backends.cuda.matmul.allow_tf32 = False
cs.build()
dev = torch.device("cuda")
cfg = mistral_7b()
eng = Engine(cfg, cs.build_world(cfg, dev), max_slots=8, max_seq=2048,
             decode_chunk=8, prefill_buckets=(64, 128, 256, 512, 1024, 2048),
             kernel=sys.argv[2], device=dev)
def submit(i, n):
    req = Request(prompt_ids=[7 + i % 50] * n, tenant_id=i % 3,
                  max_new_tokens=4, request_id=f"s{i}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.submit(req)
    ms = (time.perf_counter() - t0) * 1e3
    eng.cancel(req.request_id)
    return ms
def q(xs):
    a = statistics.quantiles(xs, n=4)
    return [a[0], statistics.median(xs), a[2]]
for i in range(3):
    submit(i, 45)
out = {"submit45_ms_q": q([submit(i, 45) for i in range(40)]),
       "submit45_device_ms": cs.device_breakdown(lambda: submit(99, 45),
                                                 "submit 45")[0]}
tids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], device=dev)
toks = torch.ones((8, 1), dtype=torch.int64, device=dev)
def step():
    llama.decode_step(cfg, eng.stack.params, toks, eng.cache,
                      deltas=eng.stack.deltas, tenant_ids=tids,
                      kernel=sys.argv[2])
walls = []
with torch.no_grad():
    for i in range(33):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
out["decode_step_ms_q"] = q(walls[3:])
# Host cost of one flash-decode wrapper call: 500 calls issued back to
# back on one-key rows (little device work), timed to a final sync.
from bitdelta_torch.ops import flash_decode as fd
kq = torch.randn((8, 32, 128), device=dev).to(torch.bfloat16)
kk = torch.randn((8, 2048, 8, 128), device=dev).to(torch.bfloat16)
one = torch.ones((8,), dtype=torch.int32, device=dev)
per_call = []
for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(500):
        fd.flash_decode_attention(kq, kk, kk, one, window=4096)
    torch.cuda.synchronize()
    per_call.append((time.perf_counter() - t0) / 500 * 1e6)
out["decode_wrapper_us_q"] = q(per_call)
print("AB " + json.dumps(out), flush=True)
"""


def main(argv):
    route, run, world = "cuda", RUN, "bf16"
    if argv[:1] == ["--submit"]:
        run, argv = RUN_SUBMIT, argv[1:]
    if argv[:1] == ["--fused"]:
        route, argv = "cuda_fused", argv[1:]
    elif argv[:1] == ["--density"] and run is RUN:
        world, argv = "density", argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, root in enumerate(argv):
        root = Path(root).resolve()
        proc = subprocess.run([sys.executable, "-c", run, str(HARNESS),
                               route, world], cwd=root,
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("AB ")]
        if proc.returncode or not lines:
            print(json.dumps({"run": i, "tree": str(root), "route": route,
                              "world": world, "failed": proc.returncode,
                              "stderr": proc.stderr[-3000:]}), flush=True)
            return 1
        print(json.dumps({"run": i, "tree": str(root), "route": route,
                          "world": world, **json.loads(lines[-1][3:])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
