#!/usr/bin/env python3
"""Sweep the form, ring depth, stage length and K-split target of row 7's
tensor-core kernel (``canon_delta_tc_kernel`` in
``bitdelta_torch/csrc/binary_gemm.cu``) and the cluster of its x prep
(``canon_prep_kernel``: its blocks and their threads) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_canonical_delta.py

Each variant is the source with ``CANON_STAGES`` (stages in the cp.async
ring), ``CANON_KC`` (256-K chunks a stage), ``CANON_PREP_BLOCKS`` (the
prep's blocks, one cluster over the whole input; 16 is a non-portable
cluster), ``CANON_PREP_THREADS`` (a prep block's threads),
``CANON_PREP_CACHE`` (the items a prep warp keeps in registers) and
``CANON_BLOCKS_PER_SM`` (the live blocks a multiprocessor the K split
aims at), ``CANON_SMALL_SLAB`` and ``CANON_LARGE_SLAB`` (the main
kernel's form by the rows of its launch: <MT = 2, ROWS = 4>, 4 warps a
block, up to the small one; <1, 8> past the large one; <1, 4> between; 0
and 64 give one form to every launch) replaced; the sources are built by
nvcc at once under ``bitdelta_torch/build/sweep/`` (git-ignored), then
each is loaded in place of the library, held against the plain version
(exact, as ``chip_smoke.py`` holds it) and timed from torch.profiler
device time at the seven call sites of a Mixtral-8x7B decode layer at 1,
2, 8 and 65 slots (``chip_smoke.CANON_SHAPES`` at 8: q/k/v/o at B =
slots over 2 tenants, w1/w3/w2 at 2 x slots routed rows, top-2 over 16
(tenant, expert) matrices): ``s{slots}_{site}_us`` the wrapper's two
kernels' device times summed, ``*_prep_us`` the prep's alone,
``*_queued_us`` a call's device time with the calls queued back to back
(``chip_smoke.queued_ms``); ``s{slots}_us`` etc. the layer's seven sites
summed. ``prep_b130_us`` is the prep alone at 130 rows (w1 at 65 slots).
One JSON line per variant, times in microseconds; a variant listed twice
gives the spread.
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

# (CANON_STAGES, CANON_KC, CANON_PREP_BLOCKS, CANON_BLOCKS_PER_SM,
#  CANON_PREP_THREADS, CANON_PREP_CACHE, CANON_SMALL_SLAB,
#  CANON_LARGE_SLAB): the source's forms by slab, then <1, 4>, <2, 4> and
# <1, 8> alone.
VARIANTS = ((4, 2, 16, 1, 512, 4, 4, 16), (4, 2, 16, 1, 512, 4, 0, 64),
            (4, 2, 16, 1, 512, 4, 64, 64), (4, 2, 16, 1, 512, 4, 0, 0),
            (4, 2, 16, 1, 512, 4, 4, 16))
MACROS = ("CANON_STAGES", "CANON_KC", "CANON_PREP_BLOCKS",
          "CANON_BLOCKS_PER_SM", "CANON_PREP_THREADS", "CANON_PREP_CACHE",
          "CANON_SMALL_SLAB", "CANON_LARGE_SLAB")
SLOTS = (1, 2, 8, 65)
PREP, MAIN = cs.CANON_KERNELS


def variant_name(stages, kc, prep, per_sm, threads, cache, small, large):
    return (f"stages{stages}_kc{kc}_prep{prep}x{threads}c{cache}"
            f"_persm{per_sm}_forms{small}-{large}")


def layer_shapes(slots):
    """``chip_smoke.CANON_SHAPES`` (8 slots) at ``slots`` decode slots."""
    return tuple((name, slots if g == 2 else 2 * slots, g, k, n)
                 for name, _, g, k, n in cs.CANON_SHAPES)


def make_sets(dev, gen, rows, g, k, n):
    ids = (cs.routed_ids(dev, gen, bsz=rows // 2) if g == 16
           else torch.arange(rows, device=dev) % g)
    scales = torch.rand((g,), generator=gen, device=dev) * 0.01 + 0.001
    distinct = int(torch.unique(ids).numel())
    sets = []
    for _ in range(cs.n_sets(distinct * k * n // 8 + rows * k * 2)):
        packed = torch.randint(-2**31, 2**31 - 1, (g, k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        x = torch.randn((rows, k), generator=gen, device=dev).to(
            torch.bfloat16)
        sets.append((x, packed, scales, ids))
    return sets


def build(src, work):
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
        cu, so = work / f"canon_{name}.cu", work / f"canon_{name}.so"
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
            log.splitlines(), cs.CANON_KERNELS)}), flush=True)
    return built


def main():
    if not torch.cuda.is_available():
        print("sweep_canonical_delta: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    print(cs.smi_line(), flush=True)
    cases = {(slots, name): make_sets(dev, gen, rows, g, k, n)
             for slots in SLOTS
             for name, rows, g, k, n in layer_shapes(slots)}
    work = _build.BUILD / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    built = build((_build.CSRC / "binary_gemm.cu").read_text(), work)
    for variant in VARIANTS:
        name = variant_name(*variant)
        if name not in built:
            continue
        _build._libs["binary_gemm"] = ctypes.CDLL(str(built[name]))
        bg._canon_scratch_bytes.cache_clear()
        row = {"variant": name}
        for slots in SLOTS:
            for key in ("us", "prep_us", "queued_us"):
                row[f"s{slots}_{key}"] = 0.0
        for (slots, site), sets in cases.items():
            label = f"s{slots}_{site}"

            def call(i, sets=sets):
                return bg.tenant_delta_matmul(*sets[i],
                                              out_dtype=torch.float32)
            got = call(0)
            want = bg.tenant_delta_matmul_plain(*sets[0])
            torch.cuda.synchronize()
            row[f"{label}_exact"] = bool(torch.equal(got, want))
            del got, want
            split = cs.kernel_split_ms(call, len(sets), f"{name} {label}",
                                       cs.CANON_KERNELS, iters=20)
            queued = cs.queued_ms(call, len(sets))
            row[f"{label}_us"] = (split[PREP] + split[MAIN]) * 1e3
            row[f"{label}_prep_us"] = split[PREP] * 1e3
            row[f"{label}_queued_us"] = queued * 1e3
            for key in ("us", "prep_us", "queued_us"):
                row[f"s{slots}_{key}"] += row[f"{label}_{key}"]
        row["prep_b130_us"] = row["s65_w1_prep_us"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
