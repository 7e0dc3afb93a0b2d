#!/usr/bin/env python3
"""Sweep the ring depth and K-split target of row 10's
tensor-core kernel (``fused_pair_tc_kernel`` in
``bitdelta_torch/csrc/binary_gemm.cu``) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_fused_pair.py

Each variant is the source with ``FP_STAGES`` (stages in the ring),
``FP_MAX_SPLITS`` (the largest K split, a cluster) and
``FP_HALF_BLOCKS_PER_SM`` (twice the blocks a multiprocessor the K split
aims at) replaced; the sources are built by nvcc at once under
``bitdelta_torch/build/sweep/`` (git-ignored), then each is loaded in
place of the library, held against the plain version (1e-4 of the
output scale, and exact over a zero W, as ``tests/test_torch_cuda.py``
holds it) and timed from torch.profiler device time at B = 8 over 3
tenants on the seven Mistral-7B projections (summed, one decoder layer):
``*_us`` the wrapper's two kernels' device times summed, ``*_main_us``
the main kernel's alone, ``*_queued_us`` a call's device time with the
calls queued back to back (``chip_smoke.queued_ms``). One JSON line per
variant, times in microseconds; a variant listed twice gives the
spread. The first line is the card's name and power limit, the second
the rate of a device-to-device copy of gate_proj's base weight.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from bitdelta_torch.core.delta import BinaryDelta, pair_delta  # noqa: E402
from bitdelta_torch.ops import _build  # noqa: E402
from bitdelta_torch.ops import binary_gemm as bg  # noqa: E402

# (FP_STAGES, FP_MAX_SPLITS, FP_HALF_BLOCKS_PER_SM)
VARIANTS = ((2, 8, 7), (2, 8, 8), (2, 4, 8), (2, 8, 4), (4, 8, 7),
            (2, 8, 7))
MACROS = ("FP_STAGES", "FP_MAX_SPLITS", "FP_HALF_BLOCKS_PER_SM")
MAIN = "fused_pair_tc_kernel"


def variant_name(stages, max_splits, half_per_sm):
    return f"stages{stages}_splits{max_splits}_halfpersm{half_per_sm}"


def make_sets(dev, gen, k, n, count, bsz=8, t=3):
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0][:bsz], device=dev)
    scales = torch.rand((t,), generator=gen, device=dev) * 0.01 + 0.001
    sets = []
    for _ in range(count):
        packed = torch.randint(-2**31, 2**31 - 1, (t, k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        pd = pair_delta(BinaryDelta(packed, scales))
        x = torch.randn((bsz, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        sets.append((x, w, pd.packed_pairs, pd.colsum, pd.scale, ids))
    return sets


def build_variants():
    src = (_build.CSRC / "binary_gemm.cu").read_text()
    work = _build.BUILD / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for variant in VARIANTS:
        name = variant_name(*variant)
        if name in procs:
            continue
        text = src
        for macro, value in zip(MACROS, variant):
            text, hits = re.subn(rf"constexpr int {macro} = \d+;",
                                 f"constexpr int {macro} = {value};", text)
            assert hits == 1, macro
        cu, so = work / f"fused_{name}.cu", work / f"fused_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(json.dumps({"variant": name, "build_failed": log[-2000:]}),
                  flush=True)
            continue
        built[name] = so
        print(json.dumps({"variant": name, "ptxas": cs.ptxas_by_kernel(
            log.splitlines(), (MAIN,))}), flush=True)
    return built


def main():
    if not torch.cuda.is_available():
        print("sweep_fused_pair: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    print(cs.smi_line(), flush=True)
    cases = {}
    for name, k, n in cs.PROJ_SHAPES:
        cases[name] = make_sets(dev, gen, k, n, cs.n_sets(2 * k * n))
    # Yardstick: a device-to-device copy of gate_proj's base weight (reads
    # and writes its bytes once each).
    w = cases["gate_proj"][0][1]
    dst = torch.empty_like(w)
    copy_ms, _ = cs.device_ms(lambda i: dst.copy_(w), 1, "copy")
    print(json.dumps({"copy_gate_w_us": copy_ms * 1e3,
                      "copy_gb_s": 2 * w.numel() * 2 / copy_ms / 1e6}),
          flush=True)
    del dst
    built = build_variants()
    for variant in VARIANTS:
        name = variant_name(*variant)
        if name not in built:
            continue
        _build._libs["binary_gemm"] = ctypes.CDLL(str(built[name]))
        row = {"variant": name, "layer_us": 0.0, "layer_main_us": 0.0,
               "layer_queued_us": 0.0, "held": True}
        for label, sets in cases.items():
            def call(i, sets=sets):
                return bg.fused_base_pair_matmul(*sets[i],
                                                 out_dtype=torch.float32)
            got = call(0)
            want = bg.fused_base_pair_matmul_plain(*sets[0])
            zero = torch.zeros_like(sets[0][1])
            got0 = bg.fused_base_pair_matmul(sets[0][0], zero, *sets[0][2:],
                                             out_dtype=torch.float32)
            want0 = bg.tenant_delta_matmul_pair_plain(sets[0][0],
                                                      *sets[0][2:])
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row["held"] &= (err <= 1e-4 * want.abs().max().item()
                            and bool(torch.equal(got0, want0)))
            del want, zero, got0, want0
            ms, main_ms = cs.device_ms(call, len(sets), f"{name} {label}",
                                       (MAIN,), iters=20)
            queued = cs.queued_ms(call, len(sets))
            row[f"{label}_us"] = ms * 1e3
            row[f"{label}_main_us"] = main_ms * 1e3
            row[f"{label}_queued_us"] = queued * 1e3
            row["layer_queued_us"] += queued * 1e3
            row["layer_us"] += ms * 1e3
            row["layer_main_us"] += main_ms * 1e3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
