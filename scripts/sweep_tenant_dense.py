#!/usr/bin/env python3
"""Sweep the column tile, stage depth, ring depth and K-split target of
row 3's tensor-core kernel (``tenant_dense_tc_kernel`` in
``bitdelta_torch/csrc/binary_gemm.cu``) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_tenant_dense.py

Each variant is the source with ``DN_BOXES`` (64-column W boxes a block),
``DN_KS`` (K a ring stage), ``DN_STAGES`` (stages in the ring),
``DN_HALF_BLOCKS_PER_SM`` (twice the blocks a multiprocessor the K split
aims at) and ``DN_MAX_NT`` (n8 tiles a unit at most: 32 or 64 of a
tenant's rows a block) replaced; the sources are built by nvcc at once under
``bitdelta_torch/build/sweep/`` (git-ignored), then each is loaded in
place of the library, held against the plain version (1e-4 of the output
scale; at B = 64 against one matmul a distinct tenant, since the plain
version's gather would copy 17 GB) and timed at Mistral-7B's head (K =
4096, N = 32000, bf16) over 3 tenants: B = 8 (rows 0, 1, 2, 0, 1, 2, 0,
0), B = 1, and B = 64 with one tenant holding 40 rows. ``*_us`` is the
kernel's torch.profiler device time a launch (the trace's total over
the launches it recorded, ``*_records`` of ITERS: the profiler can drop
records), ``*_queued_us`` a call's device time with the calls queued
back to back (``chip_smoke.queued_ms``). One JSON line per variant, times in
microseconds; a variant listed twice gives the spread. The first line is
the card's name and power limit, the second the rate of a
device-to-device copy of one tenant's head, the third the source's own
kernel at B = 8 on one head stack and on two stacks taken in turn (the
second finds none of its head in the L2 cache).
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
from bitdelta_torch.ops import binary_gemm as bg  # noqa: E402

# (DN_BOXES, DN_KS, DN_STAGES, DN_HALF_BLOCKS_PER_SM, DN_MAX_NT)
VARIANTS = ((2, 128, 2, 7, 8), (2, 128, 2, 7, 4), (2, 128, 3, 7, 8),
            (2, 64, 3, 7, 8), (4, 128, 2, 7, 8), (4, 64, 2, 7, 8),
            (1, 128, 4, 7, 8), (2, 128, 2, 4, 8), (2, 128, 2, 14, 8),
            (2, 128, 2, 7, 4), (2, 128, 2, 7, 8))
MACROS = ("DN_BOXES", "DN_KS", "DN_STAGES", "DN_HALF_BLOCKS_PER_SM",
          "DN_MAX_NT")
MAIN = "tenant_dense_tc_kernel"
ITERS = 20
K, N, T = 4096, 32000, 3


def variant_name(boxes, ks, stages, half_per_sm, max_nt):
    return (f"boxes{boxes}_ks{ks}_stages{stages}_halfpersm{half_per_sm}"
            f"_maxnt{max_nt}")


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
        cu, so = work / f"dense_{name}.cu", work / f"dense_{name}.so"
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


def kernel_us(call, sets, label):
    """The MAIN kernel's device time a launch over ITERS calls (cycling
    ``sets`` inputs) after a warm-up call, and the launches recorded."""
    call(0)
    rows = cs.trace_entries(lambda: [call(i % sets) for i in range(ITERS)],
                            label)
    us = sum(r[0] for r in rows if MAIN in r[2])
    count = sum(r[1] for r in rows if MAIN in r[2])
    cs.require(count > 0, f"the trace of {label} holds no {MAIN}")
    return us / count, count


def main():
    if not torch.cuda.is_available():
        print("sweep_tenant_dense: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    print(cs.smi_line(), flush=True)
    w = (torch.randn((T, K, N), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    # Yardstick: a device-to-device copy of one tenant's head (reads and
    # writes its bytes once each).
    dst = torch.empty_like(w[0])
    copy_ms, _ = cs.device_ms(lambda i: dst.copy_(w[0]), 1, "copy")
    print(json.dumps({"copy_head_us": copy_ms * 1e3,
                      "copy_gb_s": 2 * dst.numel() * 2 / copy_ms / 1e6}),
          flush=True)
    del dst
    ids8 = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    x8 = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    stacks = [w, w.clone()]
    l2 = {}
    for count in (1, 2):
        l2[f"stacks{count}_us"], l2[f"stacks{count}_records"] = kernel_us(
            lambda i: bg.tenant_dense_matmul(x8, stacks[i], ids8,
                                             out_dtype=torch.float32),
            count, f"l2 stacks {count}")
    print(json.dumps({"b8_l2_check": l2}), flush=True)
    del stacks
    cases = {
        "b8": ids8,
        "b1": torch.tensor([1], device=dev),
        "b64": torch.tensor([0] * 40 + [1] * 12 + [2] * 12, device=dev)}
    inputs = {}
    for label, ids in cases.items():
        x = torch.randn((len(ids), K), generator=gen, device=dev).to(
            torch.bfloat16)
        want = (cs.per_tenant_matmul(x, w, cs.tenant_groups(ids))
                if len(ids) > 8
                else bg.tenant_dense_matmul_plain(x, w, ids))
        inputs[label] = (x, ids, want)
    built = build_variants()
    for variant in VARIANTS:
        name = variant_name(*variant)
        if name not in built:
            continue
        _build._libs["binary_gemm"] = ctypes.CDLL(str(built[name]))
        row = {"variant": name, "held": True}
        for label, (x, ids, want) in inputs.items():
            def call(i, x=x, ids=ids):
                return bg.tenant_dense_matmul(x, w, ids,
                                              out_dtype=torch.float32)
            got = call(0)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            row["held"] &= err <= 1e-4 * want.abs().max().item()
            row[f"{label}_us"], row[f"{label}_records"] = kernel_us(
                call, 1, f"{name} {label}")
            row[f"{label}_queued_us"] = cs.queued_ms(call, 1) * 1e3
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
