#!/usr/bin/env python3
"""Sweep the stage depth, ring depth and tenants a stage of row 9's
tensor-core kernel (``fused_tenant_tc_kernel`` in
``bitdelta_torch/csrc/binary_gemm.cu``) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_fused_tenant.py

Each variant is the source with ``FT_KS`` (K a stage), ``FT_STAGES``
(stages in the ring) and ``FT_DT`` (tenants' words a stage holds)
replaced; the sources are built by nvcc at once under
``bitdelta_torch/build/sweep/`` (git-ignored), then each is loaded in
place of the library, held against the plain version (1e-4 of the
output scale, as ``tests/test_torch_cuda.py`` holds it) and timed at B =
8 over 3 tenants on the seven Mistral-7B projections (summed, one decoder
layer): ``*_us`` torch.profiler device time a launch (the kernel's time
over the records the trace holds, ``*_records`` of 20 calls: the
profiler drops some), ``*_queued_us`` a call's device time with the
calls queued back to back (``chip_smoke.queued_ms``). One JSON line per variant, times in
microseconds, with each projection's W stream in TB/s (its bf16 base and
the 3 tenants' words over the queued time) and the SM clock (MHz) that
``nvidia-smi`` sampled every 100 ms while the variant ran; a variant
listed twice gives the spread; ``*_splits`` is the K split each
projection's launch takes (``bd_fused_tenant_tc_splits``). A fifth field
edits the source: a form (``unconditional``: every tenant of the pass
against every n8 tile, B masked; ``no_fit``: the K split from the block
aim alone, without the check that the card holds every cluster at once)
computes the same function and is held; an ablation removes work
to show what bounds the kernel (``no_delta``: no delta MMA, its words
still stream; ``no_base``: no base MMA, W still streams), and its wrong
output is not held. The
first line is the card's name and power limit, the second the rate of a
device-to-device copy of gate_proj's base weight.
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

# (FT_KS, FT_STAGES, FT_DT[, edit])
VARIANTS = ((128, 2, 4), (128, 2, 2), (128, 2, 8), (64, 3, 4), (96, 3, 4),
            (128, 2, 4, "unconditional"), (128, 2, 4, "no_fit"),
            (128, 2, 4, "no_delta"), (128, 2, 4, "no_base"), (128, 2, 4))
MACROS = ("FT_KS", "FT_STAGES", "FT_DT")
MAIN = cs.FUSED_TENANT_TC_KERNEL
ITERS = 20      # calls a profiler trace
TILE_SKIP = ("          if (((tm[nt] >> d) & 1u) == 0u) continue;   "
             "// uniform\n")
# Source edits: each replaces a text (once) by another. Ablations remove
# work (their outputs are not held); forms keep the function.
ABLATIONS = {
    "no_delta": ("        const int d = dp + j;\n",
                 "        const int d = dp + j;\n        break;\n"),
    "no_base": ("      if (pass == 0) {\n        uint32_t a0[4], a1[4];",
                "      if (false) {\n        uint32_t a0[4], a1[4];"),
}
FORMS = {
    # Every tenant of the pass against every tile, B masked (zero for
    # tenants a tile lacks).
    "unconditional": ((TILE_SKIP, ""),),
    # The split count from the block aim alone, without the check that
    # the card holds every cluster at once.
    "no_fit": (("    if (fit >= tiles) break;\n", "    break;\n"),),
}


def variant_name(ks, stages, dt, ablation=None):
    name = f"ks{ks}_stages{stages}_dt{dt}"
    return name + (f"_{ablation}" if ablation else "")


class SmClock:
    """``nvidia-smi`` sampling the SM clock every 100 ms while in use."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
             "nounits", "-lms", "100"], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        self.mhz = sorted(int(v) for v in out.split() if v.isdigit())


def make_sets(dev, gen, k, n, count, bsz=8, t=3):
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0][:bsz], device=dev)
    scales = torch.rand((t,), generator=gen, device=dev) * 0.01 + 0.001
    sets = []
    for _ in range(count):
        packed = torch.randint(-2**31, 2**31 - 1, (t, k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        x = torch.randn((bsz, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        sets.append((x, w, packed, scales, ids))
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
        if len(variant) > 3:
            edits = FORMS.get(variant[3], (ABLATIONS.get(variant[3]),))
            for old, new in edits:
                assert text.count(old) == 1, variant[3]
                text = text.replace(old, new)
        cu, so = work / f"tenant_{name}.cu", work / f"tenant_{name}.so"
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
        print("sweep_fused_tenant: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    print(cs.smi_line(), flush=True)
    cases = {}
    for name, k, n in cs.PROJ_SHAPES:
        cases[name] = (k, n, make_sets(dev, gen, k, n, cs.n_sets(2 * k * n)))
    # Yardstick: a device-to-device copy of gate_proj's base weight (reads
    # and writes its bytes once each).
    w = cases["gate_proj"][2][0][1]
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
        ablated = len(variant) > 3 and variant[3] in ABLATIONS
        row = {"variant": name, "layer_us": 0.0, "layer_queued_us": 0.0,
               "held": None if ablated else True}
        with SmClock() as clock:
            for label, (k, n, sets) in cases.items():
                def call(i, sets=sets):
                    return bg.fused_tenant_matmul(*sets[i],
                                                  out_dtype=torch.float32)
                if not ablated:
                    got = call(0)
                    want = bg.fused_tenant_matmul_plain(*sets[0])
                    torch.cuda.synchronize()
                    err = (got - want).abs().max().item()
                    row["held"] &= err <= 1e-4 * want.abs().max().item()
                    del got, want
                call(0)
                rows = cs.trace_entries(
                    lambda: [call(i % len(sets)) for i in range(ITERS)],
                    f"{name} {label}")
                count = sum(r[1] for r in rows if MAIN in r[2])
                cs.require(count > 0, f"the trace of {name} {label} holds "
                                      f"no {MAIN}")
                ms = sum(r[0] for r in rows if MAIN in r[2]) / count / 1e3
                queued = cs.queued_ms(call, len(sets))
                nbytes = k * n * 2 + 3 * k * n // 8
                fn = _build.library("binary_gemm").bd_fused_tenant_tc_splits
                fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
                row[f"{label}_splits"] = fn(8, k, n)
                row[f"{label}_us"] = ms * 1e3
                row[f"{label}_records"] = count
                row[f"{label}_queued_us"] = queued * 1e3
                row[f"{label}_tb_s"] = nbytes / queued / 1e9
                row["layer_us"] += ms * 1e3
                row["layer_queued_us"] += queued * 1e3
        if clock.mhz:
            row["sm_mhz_min"] = clock.mhz[0]
            row["sm_mhz_median"] = clock.mhz[len(clock.mhz) // 2]
            row["sm_mhz_max"] = clock.mhz[-1]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
