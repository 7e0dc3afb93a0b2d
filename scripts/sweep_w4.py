#!/usr/bin/env python3
"""Sweep the block width, ring depth and split target of row 8's
tensor-core kernel (``w4_matmul_tc_kernel`` in
``bitdelta_torch/csrc/int4_gemm.cu``) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_w4.py

Each variant is the source with ``TC_WARPS`` (warps a block, 32 columns
each) and ``TC_STAGES`` (groups in the cp.async ring) replaced, and the
wrapper's K split aimed at another number of blocks (rounded up or down
to whole splits a column tile); all
variants are built by nvcc at once under ``bitdelta_torch/build/sweep/``
(git-ignored), then each is loaded in place of the library, held against
the plain version (1e-4 of the output's largest |value|, as
``chip_smoke.py`` holds it) and timed from torch.profiler device time:
bf16 x at M = 8 over the seven Mistral-7B projections (summed, one
decoder layer), and down_proj at M = 1 and 64; each time is the
wrapper's device time, and ``*_tc_us`` the tensor-core kernel's alone
(the rest is the split sum). One JSON line per variant, times in
microseconds; a variant listed twice gives the spread of the timing.
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
from bitdelta_torch.ops import _build  # noqa: E402
from bitdelta_torch.ops import int4 as i4  # noqa: E402
from bitdelta_torch.research.quantized_base import quantize_int4  # noqa: E402

# (TC_WARPS, TC_STAGES, _TARGET_BLOCKS, rounding of the split count:
# "ceil" fills at least the target, "floor" at most)
VARIANTS = ((4, 4, 528, "ceil"), (4, 3, 528, "ceil"), (4, 4, 528, "floor"),
            (4, 3, 528, "floor"), (4, 3, 396, "floor"), (4, 4, 528, "ceil"),
            (4, 2, 528, "floor"), (8, 3, 264, "floor"))
TC_KERNEL = "w4_matmul_tc_kernel"


def split_policy(target, rounding):
    """``ops/int4.py::_splits`` with another target and rounding."""
    def splits(n, n_groups):
        tiles = -(-n // i4._BLOCK_N)
        per = (-(-target // tiles) if rounding == "ceil"
               else target // tiles)
        return max(1, min(n_groups, per))
    return splits


def make_sets(dev, gen, m, k, n, count):
    sets = []
    for _ in range(count):
        w = quantize_int4(torch.randn((k, n), generator=gen, device=dev)
                          * 0.02)
        x = torch.randn((m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        sets.append((x, w.packed, w.scale))
    return sets


def main():
    if not torch.cuda.is_available():
        print("sweep_w4: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    print(cs.smi_line(), flush=True)
    cases = {}
    for name, k, n in cs.PROJ_SHAPES:
        count = cs.n_sets(k * n // 2 + (k // 128) * n * 4)
        cases[f"{name}_m8"] = make_sets(dev, gen, 8, k, n, count)
    for m in (1, 64):
        cases[f"down_proj_m{m}"] = make_sets(dev, gen, m, 14336, 4096, 6)
    # Yardstick: a device-to-device copy of gate_proj's words (reads and
    # writes their bytes once each).
    words = cases["gate_proj_m8"][0][1]
    dst = torch.empty_like(words)
    copy_ms, _ = cs.device_ms(lambda i: dst.copy_(words), 1, "copy")
    print(json.dumps({"copy_gate_words_us": copy_ms * 1e3,
                      "copy_gb_s": 2 * words.numel() * 4 / copy_ms / 1e6}),
          flush=True)
    del dst
    src = (_build.CSRC / "int4_gemm.cu").read_text()
    work = _build.BUILD / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    procs = {}
    for warps, stages, _, _ in VARIANTS:
        name = f"warps{warps}_stages{stages}"
        if name in procs:
            continue
        text = src
        for macro, value in (("TC_WARPS", warps), ("TC_STAGES", stages)):
            text, hits = re.subn(rf"constexpr int {macro} = \d+;",
                                 f"constexpr int {macro} = {value};", text)
            assert hits == 1, macro
        cu, so = work / f"w4_{name}.cu", work / f"w4_{name}.so"
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
        print(json.dumps({"variant": name, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "w4_matmul_tc" in ln or "registers" in ln]}), flush=True)
    for warps, stages, target, rounding in VARIANTS:
        name = f"warps{warps}_stages{stages}"
        if name not in built:
            continue
        _build._libs["int4_gemm"] = ctypes.CDLL(str(built[name]))
        i4._BLOCK_N = 32 * warps
        i4._splits = split_policy(target, rounding)
        row = {"variant": f"{name}_{rounding}{target}", "layer_m8_us": 0.0,
               "layer_m8_tc_us": 0.0}
        for label, sets in cases.items():
            got = i4.w4_matmul(*sets[0], out_dtype=torch.float32)
            want = i4.w4_matmul_plain(*sets[0])
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row[f"{label}_ok"] = err <= 1e-4 * want.abs().max().item()
            ms, tc_ms = cs.device_ms(
                lambda i: i4.w4_matmul(*sets[i], out_dtype=torch.float32),
                len(sets), f"{name} {label}", (TC_KERNEL,), iters=20)
            row[f"{label}_us"] = ms * 1e3
            row[f"{label}_tc_us"] = tc_ms * 1e3
            row[f"{label}_splits"] = i4._splits(sets[0][1].shape[1],
                                                sets[0][0].shape[1] // 128)
            if label.endswith("_m8"):
                row["layer_m8_us"] += ms * 1e3
                row["layer_m8_tc_us"] += tc_ms * 1e3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
