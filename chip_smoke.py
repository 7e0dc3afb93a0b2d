#!/usr/bin/env python3
"""Drive the PyTorch port (``bitdelta_torch``) on one CUDA card.

Run from the repository root::

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; no phase is skipped on error):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of ``bitdelta_torch/csrc`` with nvcc
   (one process per source, all at once);
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the serving path's Mistral-7B shapes, and time the kernel's
   wrapper, the plain version and (where one exists) a single PyTorch
   library call from torch.profiler device time, beside the least time
   the card could take (bound);
4. serving: a Mistral-7B base at its full width and 32 layers (random
   bf16 weights from a seeded generator) with three synthetic fine-tunes
   compressed by the port, one written and read back through the
   artifact I/O, stacked, and served by ``Engine`` behind the HTTP
   server; every kernel's launch counter must be > 0 afterwards;
5. parity: a 2-layer full-width model's prefill and decode logits with
   the kernels on the card against the same model on the CPU with the
   plain versions.

Prints one JSON line per kernel check, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and finally
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import torch

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3 bandwidth
PEAK_BF16_S = 989e12          # H100 SXM dense bf16/fp16 tensor rate
L2_BYTES = 50e6
TRACE_TRIES = 3              # profiler traces taken before one counts as lost

KERNELS = {
    # name -> (module, source, TPU kernel it replaces: pallas_call line)
    "tenant_delta_matmul_pair": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:436"),
    "flash_decode_attention": (
        "flash_decode", "bitdelta_torch/csrc/flash_decode.cu",
        "bitdelta_tpu/ops/flash_decode.py:228"),
    "tenant_dense_matmul": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:845"),
    "flash_prefill_attention": (
        "flash_prefill", "bitdelta_torch/csrc/flash_prefill.cu",
        "bitdelta_tpu/ops/flash_prefill.py:214"),
    "binary_matmul": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:95"),
}
PROJ_SHAPES = (("q_proj", 4096, 4096), ("k_proj", 4096, 1024),
               ("v_proj", 4096, 1024), ("o_proj", 4096, 4096),
               ("gate_proj", 4096, 14336), ("up_proj", 4096, 14336),
               ("down_proj", 14336, 4096))


class SmokeError(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeError(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def wrapper(name):
    import importlib

    mod = importlib.import_module(f"bitdelta_torch.ops.{KERNELS[name][0]}")
    return getattr(mod, name)


def reset_counts():
    for name in KERNELS:
        wrapper(name).launches = 0


def read_counts():
    return {name: wrapper(name).launches for name in KERNELS}


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_BF16_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def n_sets(set_bytes, cap=16):
    """Input copies to cycle so repeated launches find the L2 cold."""
    return max(1, min(cap, math.ceil(3 * L2_BYTES / max(set_bytes, 1))))


TIMING = ("torch.profiler device time per call, for ms (everything the "
          "wrapper launches: input prep, the CUDA kernels, output cast), "
          "kernel_ms (the port's CUDA kernels alone, same trace), plain_ms "
          "and library_ms; event_ms: CUDA events around back-to-back "
          "wrapper calls, host gaps included")


def trace_entries(run, label):
    """``(device us, count, symbol)`` of every device entry in a
    torch.profiler trace of ``run()``. A trace that comes back empty is
    taken again (reported on its own line), TRACE_TRIES times at most;
    then the script fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows = []
        for evt in prof.key_averages():
            us = getattr(evt, "device_time_total",
                         getattr(evt, "cuda_time_total", 0.0))
            if us > 0:
                rows.append((us, evt.count, evt.key))
        if rows:
            return rows
        emit({"empty_trace": label, "attempt": attempt})
    raise SmokeError(f"torch.profiler recorded no device time for {label} "
                     f"in {TRACE_TRIES} traces")


def device_ms(fn, sets, label, kernel_names=(), iters=10):
    """Device time per call over ``iters`` calls after a warm-up call,
    cycling input sets (``fn(i)`` runs one call on set ``i``): ``(all
    entries, the entries whose symbol contains one of kernel_names)``.
    Fails when the trace holds none of the named kernels."""
    fn(0)
    rows = trace_entries(lambda: [fn(i % sets) for i in range(iters)], label)
    total = sum(r[0] for r in rows) / iters / 1e3
    kern = sum(r[0] for r in rows
               if any(name in r[2] for name in kernel_names)) / iters / 1e3
    require(not kernel_names or kern > 0,
            f"the trace of {label} holds none of the kernels {kernel_names}")
    return total, kern


def event_ms(fn, sets, iters=10, reps=5, warmup=2):
    """Median over ``reps`` of CUDA-event time per call, cycling input
    sets; ``fn(i)`` runs one call on set ``i``."""
    for i in range(warmup):
        fn(i % sets)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(i % sets)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def time_wrapper(label, fn, sets, kernel_names, plain, library, iters=10):
    """ms, kernel_ms and event_ms of a kernel wrapper ``fn``; plain_ms and
    library_ms of ``plain`` and ``library`` (each ``f(i)`` on set ``i``;
    the library call on set 0 only)."""
    ms, kernel_ms = device_ms(fn, sets, f"{label} wrapper", kernel_names,
                              iters=iters)
    return {"ms": ms, "kernel_ms": kernel_ms,
            "event_ms": event_ms(fn, sets, iters=iters),
            "plain_ms": device_ms(plain, sets, f"{label} plain",
                                  iters=3)[0],
            "library_ms": device_ms(library, 1, f"{label} library",
                                    iters=3)[0]}


def attention_error(got, want, hd):
    """Max |got - want| of a bf16 attention output. Each (row, head) is
    held to 2^-7 of its own max |ref|, one bf16 ulp of its largest value:
    kernel and plain version both sum in fp32 and round once, so they
    differ by a rounding flip at most, on long rows and short ones
    alike."""
    diff = (got.float() - want.float()).reshape(-1, hd).abs().amax(-1)
    tol = 2 ** -7 * want.float().reshape(-1, hd).abs().amax(-1)
    bad = int((diff > tol).sum())
    return diff.max().item(), bad


def fp32_attention_error(fn, plain, args, window):
    """Max |kernel - plain| with q, k, v in fp32 (no bf16 rounding of the
    output, so a dropped or doubled key shows above 1e-4)."""
    a32 = [a.float() if a.is_floating_point() else a for a in args]
    got = fn(*a32, window=window)
    torch.cuda.synchronize()
    want = plain(*a32, window=window)
    torch.cuda.synchronize()
    return (got - want).abs().max().item()


def device_breakdown(fn, label, top=8):
    """Device time of one ``fn()`` from a torch.profiler trace: the summed
    kernel (and copy) time in ms and the ``top`` entries by device time.
    The wall time is taken separately, without the profiler, by the
    caller; their ratio is the device's busy share."""
    rows = sorted(trace_entries(fn, label), reverse=True)
    return (sum(r[0] for r in rows) / 1e3,
            [{"kernel": k[:80], "ms": us / 1e3, "count": c}
             for us, c, k in rows[:top]])


# ---------------------------------------------------------------------------
# 1-2. Device and build
# ---------------------------------------------------------------------------

def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build():
    from bitdelta_torch.ops import _build

    t0 = time.perf_counter()
    seconds = _build.build_all()
    total = time.perf_counter() - t0
    usage = {}
    for name in _build.KERNEL_SOURCES:
        log = _build.BUILD / f"{name}.log"
        if log.exists():
            usage[name] = [line.strip() for line in log.read_text()
                           .splitlines() if "registers" in line
                           or "spill" in line]
    emit({"phase": "build", "seconds": round(total, 3),
          "per_source_s": {k: round(v, 3) for k, v in seconds.items()},
          "ptxas": usage})


# ---------------------------------------------------------------------------
# 3. Kernel checks at the serving path's Mistral-7B shapes
# ---------------------------------------------------------------------------

def check_pair(dev, gen, results):
    from bitdelta_torch.core.delta import BinaryDelta, pair_delta
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    bsz, t = 8, 3
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    scales = torch.rand((t,), generator=gen, device=dev) * 0.01 + 0.001
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms"), 0.0)
    err, worst_ratio, shapes, by = 0.0, 0.0, [], set()
    for name, k, n in PROJ_SHAPES:
        set_bytes = t * k * n // 8 + bsz * k * 2
        sets, canonical = [], []
        for _ in range(n_sets(set_bytes)):
            packed = torch.randint(-2**31, 2**31 - 1, (t, k // 32, n),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            pd = pair_delta(BinaryDelta(packed, scales))
            x = torch.randn((bsz, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sets.append((x, pd.packed_pairs, pd.colsum, pd.scale, ids))
            canonical.append(packed)
        got = bg.tenant_delta_matmul_pair(*sets[0], out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = bg.tenant_delta_matmul_pair_plain(*sets[0])
        torch.cuda.synchronize()
        x = sets[0][0].float()
        term = float(scales.max()) * float((x.amax(1) - x.amin(1)).max()) * k
        tol = 4 * float(torch.finfo(torch.float32).eps) * 2 ** math.ceil(
            math.log2(term))
        e = (got - want).abs().max().item()
        err = max(err, e)
        worst_ratio = max(worst_ratio, e / tol)
        require(e <= tol, f"pair kernel {name}: max|err| {e} > tol {tol}")
        # The library call's ±1 stack is unpacked outside the timed call.
        pm1 = unpack_to_pm1(canonical[0], torch.bfloat16)      # (T, K, N)
        del canonical
        x0 = sets[0][0]
        row = time_wrapper(
            f"pair {name}",
            lambda i: bg.tenant_delta_matmul_pair(*sets[i],
                                                  out_dtype=torch.float32),
            len(sets), ("pair_delta_kernel",),
            plain=lambda i: bg.tenant_delta_matmul_pair_plain(*sets[i]),
            library=lambda i: torch.bmm(x0[:, None], pm1[ids]))
        del pm1
        nbytes = bsz * k * 2 + t * (k // 16) * (n // 2) * 4 + t * n * 4 \
            + bsz * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * bsz * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] += row[key]
        shapes.append({"proj": name, "k": k, "n": n, **row,
                       "max_abs_err": e, "tol": tol})
    results["tenant_delta_matmul_pair"] = dict(
        tot, max_abs_err=err, bound_by="+".join(sorted(by)),
        tolerance="4 ulp of alpha*(xmax-xmin)*K (the cancelling epilogue "
                  "terms); integer sums are exact",
        worst_err_over_tol=worst_ratio,
        shape="B=8 T=3, per decode layer: 7 projections",
        timing=TIMING + "; ms includes the plain-torch x prep "
               "(_pair_quantize) that the wrapper runs before the kernel",
        bound_basis="bytes: x bf16 + pair words and colsum of the 3 "
                    "tenants + fp32 out; ops: 2*B*K*N at the bf16 rate",
        library="torch.bmm(x[:, None], pm1[ids]) on the unpacked bf16 ±1 "
                "stack (gather + bmm; no 12-bit x grid, no scale)",
        detail=shapes)


def _sdpa_inputs(q, k, v, mask_bool):
    """SDPA operands prepared outside the timed call: heads-first, KV
    heads repeated for GQA, boolean mask."""
    g = q.shape[-3] // k.shape[-2]
    kk = k.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    vv = v.transpose(1, 2).repeat_interleave(g, dim=1).contiguous()
    return kk, vv, mask_bool


def check_decode(dev, gen, results):
    import torch.nn.functional as F

    from bitdelta_torch.ops import flash_decode as fd

    bsz, h, kvh, hd, s, window = 8, 32, 8, 128, 2048, 4096
    lengths = torch.tensor([2048, 1537, 1024, 777, 512, 300, 64, 1],
                           device=dev, dtype=torch.int32)
    live = int(lengths.sum())
    set_bytes = live * kvh * hd * 2 * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        q = torch.randn((bsz, h, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        sets.append((q, k, v, lengths))
    got = fd.flash_decode_attention(*sets[0], window=window)
    torch.cuda.synchronize()
    want = fd.flash_decode_attention_plain(*sets[0], window=window)
    torch.cuda.synchronize()
    err, bad = attention_error(got, want, hd)
    require(not bad, f"flash decode: {bad} (row, head) pairs off by more "
                     f"than 2^-7 of their max |ref| (max|err| {err})")
    err32 = fp32_attention_error(fd.flash_decode_attention,
                                 fd.flash_decode_attention_plain, sets[0],
                                 window)
    require(err32 <= 1e-4, f"flash decode fp32: max|err| {err32} > 1e-4")
    q, k, v, _ = sets[0]
    pos = torch.arange(s, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]
    kk, vv, mask = _sdpa_inputs(q[:, :, None, :], k, v, mask)
    q4 = q[:, :, None, :]
    row = time_wrapper(
        "flash decode",
        lambda i: fd.flash_decode_attention(*sets[i], window=window),
        len(sets), ("flash_decode_kernel", "merge_splits_kernel"),
        plain=lambda i: fd.flash_decode_attention_plain(*sets[i],
                                                        window=window),
        library=lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                         attn_mask=mask))
    nbytes = set_bytes + 2 * bsz * h * hd * 2
    b_ms, b_by = bound(nbytes, 4 * h * hd * live)
    results["flash_decode_attention"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fp32_max_abs_err=err32,
        tolerance="bf16: each (row, head) within 2^-7 of its own max|ref|; "
                  "fp32 inputs: 1e-4 absolute",
        bound_basis="bytes: live K/V rows + q + out (bf16); ops: 4*H*hd "
                    "per live key at the bf16 rate",
        shape="B=8 H=32 KV=8 hd=128 cache 2048, lengths "
              f"{lengths.tolist()}, window {window}",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(padded cache, boolean mask)")


def check_dense(dev, gen, results):
    from bitdelta_torch.ops import binary_gemm as bg

    bsz, t, k, n = 8, 3, 4096, 32000
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    x = torch.randn((bsz, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((t, k, n), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)
    got = bg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = bg.tenant_dense_matmul_plain(x, w, ids)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 1e-4 * want.abs().max().item()
    require(err <= tol, f"tenant dense: max|err| {err} > {tol}")
    row = time_wrapper(
        "tenant dense",
        lambda i: bg.tenant_dense_matmul(x, w, ids, out_dtype=torch.float32),
        1, ("tenant_dense_kernel", "sum_splits_kernel"),
        plain=lambda i: bg.tenant_dense_matmul_plain(x, w, ids),
        library=lambda i: torch.bmm(x[:, None, :], w[ids]))
    nbytes = t * k * n * 2 + bsz * k * 2 + bsz * n * 4
    b_ms, b_by = bound(nbytes, 2 * bsz * k * n)
    results["tenant_dense_matmul"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=err, tolerance="1e-4 * max|ref| (fp32 sums in another "
                                   "order)",
        shape="B=8 T=3 K=4096 N=32000 (lm_head), 3 distinct tenants",
        bound_basis="bytes: the 3 distinct tenants' (K, N) bf16 heads + x + "
                    "fp32 out; ops: 2*B*K*N at the bf16 rate",
        library="torch.bmm(x[:, None], W[ids]) (gather + bmm)")


def check_prefill(dev, gen, results):
    import torch.nn.functional as F

    from bitdelta_torch.ops import flash_prefill as fp

    bsz, sq, h, kvh, hd, window = 1, 512, 32, 8, 128, 4096
    lengths = torch.tensor([500], device=dev, dtype=torch.int32)
    set_bytes = sq * (h + 2 * kvh) * hd * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        q = torch.randn((bsz, sq, h, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((bsz, sq, kvh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn((bsz, sq, kvh, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        sets.append((q, k, v, lengths))
    got = fp.flash_prefill_attention(*sets[0], window=window)
    torch.cuda.synchronize()
    want = fp.flash_prefill_attention_plain(*sets[0], window=window)
    torch.cuda.synchronize()
    err, bad = attention_error(got, want, hd)
    require(not bad, f"flash prefill: {bad} (row, head) pairs off by more "
                     f"than 2^-7 of their max |ref| (max|err| {err})")
    require(not got[0, 500:].any().item(), "padding rows must be zeros")
    err32 = fp32_attention_error(fp.flash_prefill_attention,
                                 fp.flash_prefill_attention_plain, sets[0],
                                 window)
    require(err32 <= 1e-4, f"flash prefill fp32: max|err| {err32} > 1e-4")
    mask = fp.prefill_mask(sq, sq, lengths, window)
    visible = int(mask.sum())
    q, k, v, _ = sets[0]
    kk, vv, m4 = _sdpa_inputs(q.transpose(1, 2), k, v, mask[:, None])
    q4 = q.transpose(1, 2).contiguous()
    row = time_wrapper(
        "flash prefill",
        lambda i: fp.flash_prefill_attention(*sets[i], window=window),
        len(sets), ("flash_prefill_kernel",),
        plain=lambda i: fp.flash_prefill_attention_plain(*sets[i],
                                                         window=window),
        library=lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                         attn_mask=m4))
    nbytes = sq * h * hd * 2 * 2 + int(lengths.sum()) * kvh * hd * 2 * 2
    b_ms, b_by = bound(nbytes, 4 * hd * h * visible)
    results["flash_prefill_attention"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fp32_max_abs_err=err32,
        tolerance="bf16: each (query row, head) within 2^-7 of its own "
                  "max|ref|; fp32 inputs: 1e-4 absolute",
        bound_basis="ops: 4*hd per visible (query, key) pair and head at the "
                    "bf16 rate; bytes: q + live K/V + out (bf16)",
        shape=f"B=1 bucket 512 length 500 H=32 KV=8 hd=128, "
              f"{visible} visible (query, key) pairs per head",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(boolean mask)")


def check_binary(dev, gen, results):
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    m = 512
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms"), 0.0)
    err, shapes, by = 0.0, [], set()
    for name, k, n in PROJ_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        scale = torch.tensor(0.003, device=dev)
        got = bg.binary_matmul(x, packed, scale, out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = bg.binary_matmul_plain(x, packed, scale)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        require(e <= tol, f"binary matmul {name}: max|err| {e} > {tol}")
        err = max(err, e)
        pm1 = unpack_to_pm1(packed, torch.bfloat16)
        row = time_wrapper(
            f"binary matmul {name}",
            lambda i: bg.binary_matmul(x, packed, scale,
                                       out_dtype=torch.float32),
            1, ("binary_matmul_kernel",),
            plain=lambda i: bg.binary_matmul_plain(x, packed, scale),
            library=lambda i: torch.matmul(x, pm1), iters=5)
        nbytes = m * k * 2 + (k // 32) * n * 4 + m * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * m * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] += row[key]
        shapes.append({"proj": name, "k": k, "n": n, **row,
                       "max_abs_err": e})
    results["binary_matmul"] = dict(
        tot, max_abs_err=err, bound_by="+".join(sorted(by)),
        tolerance="1e-4 * max|ref| (fp32 sums in another order)",
        shape="M=512, per prefill layer: 7 projections", timing=TIMING,
        bound_basis="ops: 2*M*K*N at the bf16 rate (±1 is exact in bf16); "
                    "bytes: x bf16 + K/32*N words + fp32 out",
        library="torch.matmul(x, unpacked ±1 bf16 matrix)", detail=shapes)


def kernel_checks(dev):
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}
    for check in (check_pair, check_decode, check_dense, check_prefill,
                  check_binary):
        check(dev, gen, results)
        torch.cuda.empty_cache()
    for name, res in results.items():
        emit({"kernel_check": name, **res})
    return results


# ---------------------------------------------------------------------------
# 4. The serving path end to end
# ---------------------------------------------------------------------------

def synthetic_finetune(cfg, base, gen, scale=0.002):
    """base + seeded noise, one layer of one projection at a time (no fp32
    copy of a whole stack exists)."""
    fine = {"layers": {}}
    for name, w in base["layers"].items():
        out = torch.empty_like(w)
        for layer in range(w.shape[0]):
            noise = torch.randn(w[layer].shape, generator=gen,
                                device=w.device) * scale
            if name.endswith("norm"):
                noise = noise * 10
            out[layer] = (w[layer].float() + noise).to(w.dtype)
        fine["layers"][name] = out
    for name in ("embed", "lm_head", "final_norm"):
        w = base[name]
        noise = torch.randn(w.shape, generator=gen, device=w.device) * scale
        fine[name] = (w.float() + noise).to(w.dtype)
    return fine


def build_world(cfg, dev, n_tenants=3, seed=0):
    from bitdelta_torch.core.artifact import load_delta, save_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.llama import init_params
    from bitdelta_torch.serving.stacking import stack_tenants

    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    base = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    tenants, t_comp = [], 0.0
    for _ in range(n_tenants):
        t0 = time.perf_counter()
        fine = synthetic_finetune(cfg, base, gen)
        tenants.append(compress_model(base, fine))
        del fine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t_comp += time.perf_counter() - t0
    # One tenant through the artifact format and back, bit-exact.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tenant0.safetensors")
        save_delta(path, tenants[0], cfg)
        size = Path(path).stat().st_size
        loaded, cfg_back = load_delta(path, device=dev)
    require(cfg_back == cfg, "artifact config did not round-trip")
    for name, d in tenants[0].deltas.items():
        require(torch.equal(d.packed, loaded.deltas[name].packed)
                and torch.equal(d.scale, loaded.deltas[name].scale),
                f"artifact delta {name} did not round-trip")
    for name, x in tenants[0].extras.items():
        require(torch.equal(x, loaded.extras[name]),
                f"artifact extra {name} did not round-trip")
    tenants[0] = loaded
    t_art = time.perf_counter() - t0
    stack = stack_tenants(cfg, base, tenants, device=dev)
    del tenants
    torch.cuda.empty_cache()
    emit({"phase": "world", "layers": cfg.num_layers,
          "base_init_s": t_base, "compress_s_per_tenant": t_comp / n_tenants,
          "artifact_bytes": size, "artifact_roundtrip_s": t_art})
    return base, stack


def _post(url, body):
    req = urllib.request.Request(
        url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    lines, first_s = [], None
    with urllib.request.urlopen(req, timeout=600) as r:
        require(r.status == 200, f"/generate status {r.status}")
        for raw in r:
            if first_s is None:
                first_s = time.perf_counter() - t0
            lines.append(json.loads(raw))
    return lines, first_s, time.perf_counter() - t0


def serve(cfg, stack, dev, name):
    from bitdelta_torch.models import llama
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.server import (ByteTokenizer, ServingApp,
                                               TenantInfo, make_http_server)
    from bitdelta_torch.serving.stacking import stack_nbytes

    eng = Engine(cfg, stack, max_slots=8, max_seq=2048, decode_chunk=8,
                 prefill_buckets=(64, 128, 256, 512, 1024, 2048),
                 kernel="cuda", device=dev)
    del stack
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    mem = stack_nbytes(eng.stack)
    tok = ByteTokenizer()
    names = ["alpha", "beta", "gamma"]
    app = ServingApp(eng, [TenantInfo(n, tok) for n in names])
    server = make_http_server(app, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    vocab = cfg.vocab_size
    report = {}

    torch.cuda.synchronize()
    reset_counts()
    thread.start()
    try:
        with urllib.request.urlopen(url + "/models", timeout=60) as r:
            require(json.loads(r.read()) == {"models": names},
                    "/models answered wrongly")
        ttft, per_req = [], []
        for i, tenant in enumerate(names):
            lines, first_s, total_s = _post(url, {
                "prompt": f"Request {i}: tell tenant {tenant} a story.",
                "tenant": tenant, "max_new_tokens": 16})
            require(lines and lines[-1]["done"]
                    and all(line["tenant"] == tenant for line in lines)
                    and all(0 <= line["token_id"] < vocab for line in lines)
                    and len(lines) <= 16,
                    f"/generate for {tenant} streamed a bad answer")
            ttft.append(first_s * 1e3)
            per_req.append(len(lines))
        lines, _, b_total = _post(url, {
            "messages": [{"role": "user", "content": "One question for all"}],
            "max_new_tokens": 12})
        require({line["tenant"] for line in lines} == set(names)
                and sum(line["done"] for line in lines) == 3,
                "broadcast /generate did not answer from every tenant")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        app.close()
    prompts = [f"Batch prompt number {i} for the engine." for i in range(12)]
    reqs = [Request(prompt_ids=tok.encode(p), tenant_id=i % 3,
                    max_new_tokens=32) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    require(all(o is not None and len(o) <= 32 for o in outs),
            "Engine.generate returned a bad batch")
    require(all(0 <= t < vocab for o in outs for t in o),
            "Engine.generate produced out-of-vocab tokens")
    counts = read_counts()
    for kname, c in counts.items():
        require(c > 0, f"kernel {kname} was never launched on the main path")
    gen_tokens = sum(len(o) for o in outs)

    # Prefill and decode-step times through the same engine (after the
    # counted run).
    prefill_ms = {}
    for n_tok in (60, 500):
        req = Request(prompt_ids=[7] * n_tok, tenant_id=1, max_new_tokens=4,
                      request_id=f"p{n_tok}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.submit(req)
        prefill_ms[f"prompt_{n_tok}_tokens"] = (time.perf_counter() - t0) * 1e3
        eng.cancel(req.request_id)
    req = Request(prompt_ids=[7] * 500, tenant_id=1, max_new_tokens=4,
                  request_id="p500-profiled")
    prefill_device_ms, prefill_top = device_breakdown(
        lambda: eng.submit(req), "prefill 500")
    eng.cancel(req.request_id)
    tids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], device=dev)
    toks = torch.ones((8, 1), dtype=torch.int64, device=dev)
    cache = eng.cache

    def one_step():
        llama.decode_step(cfg, eng.stack.params, toks, cache,
                          deltas=eng.stack.deltas, tenant_ids=tids,
                          kernel="cuda")

    with torch.no_grad():
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 5
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        step_device_ms, step_top = device_breakdown(one_step,
                                                   "decode step")
    report.update(
        card=name, layers=cfg.num_layers, launches=counts,
        http_ttft_ms=ttft, http_tokens=per_req, broadcast_s=b_total,
        generate_requests=len(reqs), generate_tokens=gen_tokens,
        generate_s=gen_s, generate_tok_s=gen_tokens / gen_s,
        engine_timer=eng.timer.summary(), submit_prefill_ms=prefill_ms,
        prefill_500_device_ms=prefill_device_ms,
        prefill_500_top_kernels=prefill_top,
        decode_step_ms_b8=step_ms, decode_tok_s_b8=8e3 / step_ms,
        decode_step_device_ms=step_device_ms,
        decode_step_device_busy=step_device_ms / step_ms,
        decode_step_top_kernels=step_top,
        resident_bytes=resident,
        peak_bytes=torch.cuda.max_memory_allocated(), stack_bytes=mem)
    emit({"phase": "serving", **report})
    return counts, report


# ---------------------------------------------------------------------------
# 5. Whole step: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def parity(cfg_full, dev):
    import dataclasses

    from bitdelta_torch.models import llama
    from bitdelta_torch.serving.stacking import TenantStack, to_pair_layout

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    _, stack = build_world(cfg, dev, seed=7)
    stack = to_pair_layout(stack)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return type(tree)(*(to_cpu(v) for v in tree))
        return tree.cpu()

    cpu_stack = TenantStack(params=to_cpu(stack.params),
                            deltas=to_cpu(stack.deltas),
                            vocab_sizes=stack.vocab_sizes.cpu(),
                            num_tenants=stack.num_tenants)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(1, cfg.vocab_size, (1, 64), generator=g)
    lengths = torch.tensor([41], dtype=torch.int32)
    tids = torch.tensor([1])
    nxt = torch.tensor([[17]])

    def run(st, device):
        with torch.no_grad():
            logits, cache = llama.forward(
                cfg, st.params, tokens.to(device), lengths=lengths.to(device),
                deltas=st.deltas, tenant_ids=tids.to(device),
                return_cache=True, cache_max_seq=64, kernel="cuda")
            step, _ = llama.decode_step(cfg, st.params, nxt.to(device), cache,
                                        deltas=st.deltas,
                                        tenant_ids=tids.to(device),
                                        kernel="cuda")
        return logits[0, :41].float().cpu(), step[0, 0].float().cpu()

    reset_counts()
    gpu_pre, gpu_step = run(stack, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu_pre, cpu_step = run(cpu_stack, torch.device("cpu"))
    out = {"phase": "parity", "layers": 2, "launches": counts}
    for label, a, b in (("prefill", gpu_pre, cpu_pre),
                        ("decode", gpu_step, cpu_step)):
        require(torch.isfinite(a).all().item(), f"{label} logits not finite")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        out[label] = {"max_abs_err": err, "ref_max_abs": scale,
                      "rel_err": err / scale, "argmax_agreement": agree}
        # bf16 activations: the card and the CPU round each projection's
        # fp32 sum to bf16 after summing in different orders; 2 layers of
        # such rounding stay within 2% of the logit scale.
        require(err <= 2e-2 * scale,
                f"{label} logits: max|err| {err} > 2% of {scale}")
    for kname in ("tenant_delta_matmul_pair", "flash_decode_attention",
                  "tenant_dense_matmul", "flash_prefill_attention",
                  "binary_matmul"):
        require(counts[kname] > 0, f"parity run missed kernel {kname}")
    emit(out)


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every result as JSON to this file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    sys.path.insert(0, str(repo))
    import bitdelta_torch  # noqa: F401 — fails outside the repository
    from bitdelta_torch.models.config import mistral_7b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit({"phase": "device", "name": name, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    build()
    checks = kernel_checks(dev)
    report = {"checks": checks}
    cfg = mistral_7b()
    torch.cuda.reset_peak_memory_stats()
    # The stack is handed over without another reference, so the engine's
    # pair-layout copy replaces the canonical deltas.
    counts, report["serving"] = serve(cfg, build_world(cfg, dev)[1], dev,
                                      name)
    torch.cuda.empty_cache()
    parity(cfg, dev)
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        res = checks[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[kname],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "kernel_ms": res["kernel_ms"], "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    report["nvidia_smi"] = smi
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
