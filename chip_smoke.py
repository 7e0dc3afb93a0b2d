#!/usr/bin/env python3
"""Drive the PyTorch port (``bitdelta_torch``) on one CUDA card.

Run from the repository root::

    python3 chip_smoke.py [--out FILE]

Phases (any failure exits non-zero; no phase is skipped on error):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of ``bitdelta_torch/csrc`` with nvcc
   (one process per source, all at once);
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the Mistral-7B (Mixtral-8x7B for the canonical tenant delta)
   shapes of the path that runs it (the two fused base + delta kernels
   with bf16 and fp32 x and W, the binary matmul and its transpose with
   bf16 and fp32 input, also at a Llama-2-70B tp = 2 rank's seven
   projections (M = 512, untimed), flash decode also on a full cache,
   lengths S + 1, and timed at uniform lengths of 128, 512 and 2048
   keys; flash
   prefill's bf16 tensor-core kernel and its fp32 CUDA-core kernel each
   timed; flash decode and flash prefill also at Llama-2-7B's one query
   head a KV head (B = 8, H = KV = 32) and at a Llama-2-70B tp = 2
   rank's eight (B = 8, H = 32, KV = 4), bf16 and fp32, bf16 timed; the
   W4 matmul's bf16 tensor-core kernel and its fp32
   CUDA-core kernel each timed; the pair delta's x prep and its 1-bit
   tensor-core kernel timed apart, and the call back to back, and a NaN
   of x kept to its row (B = 8 and 65, bf16 and fp32 x); the fused
   pair kernel's bf16 calls (row 1's prep and the tensor-core kernel)
   likewise, with a NaN in the prep's 16-value tail; the fused canonical
   kernel's bf16 tensor-core kernel timed and queued, one launch a call
   at B = 8, also at B = 65 (three launches), with 8 distinct tenants
   and with a NaN in x; the canonical tenant delta's x prep and its 1-bit
   tensor-core kernel likewise, exact with bf16, fp16, fp32 and zero x,
   also at K = 102432 and at B = 130 (three main-kernel launches); the
   tenant dense lm_head's bf16 tensor-core kernel at B = 1, 8 and 64,
   each beside one matmul a distinct tenant, and its CUDA-core kernel
   on an fp32 head under bf16 x), and time
   the kernel's wrapper, the plain version and (where one exists) a single
   PyTorch library call from torch.profiler device time, beside the
   least time the card could take (bound); the int8-cache branch of
   flash decode is checked and timed as its own entry; then hold the
   gradients of the two autograd Functions of the training path (the
   trainable binary matmul, flash prefill) against autograd of their
   plain versions;
4. serving: a Mistral-7B base at its full width cut to 16 of its 32
   layers (``SERVE_LAYERS``; random bf16 weights from a seeded
   generator) with three synthetic fine-tunes
   compressed by the port, one written and read back through the
   artifact I/O, stacked, and served by ``Engine`` behind the HTTP
   server; every serving kernel's launch counter must be > 0 afterwards;
4b. density: the same base quantized to W4 (``quantize_base(base,
   "int4")``), three fine-tunes compressed against the dequantized base
   (one written with ``base_quant="int4"`` and read back), served by
   ``Engine(kv_dtype="int8")`` over HTTP; the W4 kernel must launch 112
   times (7 projections x 16 layers) per decode step, the int8 cache
   must reach flash decode, and every other serving kernel must launch;
5. parity: a 2-layer full-width model's prefill and decode logits with
   the kernels on the card against the same model on the CPU with the
   plain versions: a bf16 base with a bf16 cache, a W4 base with the
   int8 cache, a W8 base with a bf16 cache; and a 2-layer full-width
   Mixtral-8x7B (W8 base, bf16 cache, canonical decode), held at the
   positions whose top-2 routing agrees at every layer (at least 95% of
   them must); a bf16 base with compressed embeddings on the fused route
   (``kernel="cuda_fused"``); and, on the card, a 2-layer fp32 model's
   fused decode step against its unfused one in both layouts;
6. train: a 32-layer full-width Mistral-7B fine-tune (bf16) compressed,
   written as ``diff_untrained.safetensors``, scale-distilled for 3
   steps by ``distill_scales`` (batch 4, length 128, lr 1e-4) through the
   kernels, written as ``diff.safetensors`` and read back bit-exact;
   every training kernel's launch counter must be > 0 afterwards;
7. train parity: one distillation step of a 2-layer full-width fp32
   model through the kernels against the same step on the plain path;
8. mixtral: every earlier world freed, a full-width Mixtral-8x7B cut to
   16 of its 32 layers (``MIX_LAYERS``; depth only) over a W8 base with
   two synthetic fine-tunes, built one layer at a time on the card (no
   dense bf16 base), one tenant written and read back through the
   artifact I/O; a B=8 prefill and three canonical-layout decode steps
   (the canonical tenant delta kernel must launch 112 times, 7 a layer,
   a step); the stack converted to the pair layout in
   place and the same step taken again (logits within 2% of the
   canonical step's); then ``Engine(model=mixtral)`` over HTTP with both
   tenants, as phase 4;
9. fused: every earlier world freed, a full-width 32-layer Mistral-7B
   bf16 base with three synthetic fine-tunes compressed with
   ``compress_embeddings=True`` (one through the artifact I/O), stacked
   over the shared base embed / head; a B=8 decode step on ``"cuda"``
   and on ``"cuda_fused"`` in the canonical layout (row 9 launches 224
   times a fused step, row 7 once for the head), then in the pair layout
   after ``to_pair_layout(in_place=True)`` (row 10 224 times, row 1
   once), the pair layout's two steps' device times and top kernels
   side by side on one line; ``Engine(kernel="cuda_fused")`` over HTTP
   with the three tenants, as phase 4; then one tenant's perplexity (3 windows of
   1024 + 512 seeded tokens) densely fused by ``fuse_compressed`` and
   through its deltas, which must agree within 1%;
10. cli: every earlier world freed, a full-width Mistral-7B at 4 layers
   written as an HF checkpoint pair (``config.json`` and two ``BF16``
   shards each, in HF's names and ``(out, in)`` layout, by the port's
   exporter and writer; the fine-tune = base + seeded noise) and driven
   through the port's CLIs: ``load_hf_params`` timed; ``cli.train`` in this process
   (3 steps, batch 4, length 128, ``--checkpoint_every 2 --debug
   --save_full_model``: both artifacts, the checkpoint and three finite
   losses; ``diff_untrained``'s words bit-equal to ``compress_model``'s;
   rows 4, 5, 6 launched); ``calibrated_model/`` loaded back equal to
   ``fuse_compressed(base, diff)``; ``cli.serve --smoke_test`` with two
   tenants under ``cuda`` (rows 1, 2, 3, 4, 5) and ``cuda_fused`` (row
   10 for row 1); ``python -m bitdelta_torch.cli.serve`` as its own
   process, one broadcast ``/generate`` over HTTP (first-token ms);
   ``cli.eval_ppl`` on the byte tokenizer within 0.3% of the library's
   PPL through the deltas, while the base alone must score at least four
   times that far from it; a symmetric group-128 GPTQ checkpoint through
   ``load_gptq_params`` (every projection an ``Int4Weight``) and one B=8
   decode step under a tenant's deltas (row 8 28 times; logits within 2%
   of the dense dequantized base's); then a full-width 2-layer
   Mixtral-8x7B pair through the train (rows 5, 6), serve and eval CLIs.
   Each checkpoint is deleted once its step is done;
11. rest: every earlier world freed, (a) ``serving_compiled_check()``
   (the tiny fp32 two-tenant world greedy-decoded by ``Engine(kernel=
   "cuda")`` and ``"cuda_fused"`` against ``"torch"`` on the card, and
   over a W4 base; every row but 6 launches); (b) a full-width 2-layer
   Llama-2-7B (32 query and 32 KV heads: rows 2 and 4 at one query head
   a KV head), bf16, with one synthetic fine-tune written as a
   reference-format ``diff.pt`` and converted by ``python -m
   bitdelta_torch.tools.convert_reference`` in a subprocess (words
   bit-exact with ``compress_model``'s, scales within 1e-5), served by
   ``Engine(kernel="cuda")``: a B=8 prefill and decode step on its stack
   within 2% of the logit scale of the CPU's plain versions, then
   ``generate``; (c) ``fuse_variant_model`` for binary, binary_median,
   ternary (0.5), lora (16) and column at that width (each closer to the
   fine-tune than the base at every projection, column no worse than
   binary; one gate_proj's median scale and ternary planes equal to the
   CPU's; the seconds of one gate_proj's SVD), then each model's
   perplexity through ``kernel="cuda"`` (2 windows), and the binary
   deltas' within 1% of their dense fusion's;
12. tp: tensor and data parallelism, two ranks (``torch.multiprocessing``
   spawned processes over gloo) sharing the card, every earlier world
   freed: (a) the serving check's fp32 two-tenant world with 2 KV heads
   (``compiled_check.check_engines(mesh=)``) on ``(1, 2)`` and ``(2, 1)``
   meshes, both kernel routes, a cache of the compute dtype and the int8
   cache, and its W4 base, plus a tiny fp32 Mixtral at ``(1, 2)``: every
   meshed engine gives the single-process engine's greedy tokens (the
   Mixtral kernel routes' ``generate``: their sampled logits held call
   by call, a token differing only at a near tie), and every row but 6
   launches on each rank in the meshed runs alone, their single-process
   references counted apart (the ``(1, 1)`` mesh is phase 11a's check);
   (b, run first on each rank) Llama-2-70B at full width cut to 2
   layers (depth only), two tenants, written to disk by the parent (an
   HF checkpoint in bf16 by the port's exporter and two artifacts), each
   rank reading its own blocks of them to the card
   (``load_stack_shard``): its host's resident set (``VmRSS`` sampled
   every 2 ms while it loads and builds its first engine) may grow by no
   more than the largest checkpoint tensor and ``HOST_SLACK_BYTES`` (nor
   than its shard and that tensor), the first engine, which pairs the
   loaded shard in place, may peak on the card at no more than the
   shard and one leaf of it, and the stack so paired must equal the
   shard of the whole stack built from the same files, bit for bit; a
   B=8 prefill and one decode step at tp=2 on ``"cuda"`` and
   ``"cuda_fused"`` within 2% of the logit scale of the same world
   served by one process at tp=1 (the launches counted from the meshed
   engines alone), the share of agreeing greedy ``generate`` tokens
   printed, each meshed engine built on the loaded shard (the card
   holding no more than it and one leaf of it), and each
   rank's shard and peak bytes, a decode step's wall and device ms with
   its top kernels, and its psums timed alone; (a) ends with W8 and W4
   bases on disk quantized on each rank's shards, bit-equal to the
   shard of the whole quantized stack, their meshed engines' tokens the
   single-process engine's; (c) ``python -m
   torch.distributed.run --nproc-per-node 2 -m bitdelta_torch.cli.serve
   --mesh 1,2`` over a tiny fp32 checkpoint written by the phase: one
   broadcast ``/generate`` over HTTP equal to ``--mesh 1,1``'s tokens,
   then both ranks stop cleanly on SIGTERM;
13. tp_train: data and tensor parallelism for distillation and the eval,
   two spawned ranks sharing the card over gloo, every earlier world
   freed: (a) fp32 tiny worlds on ``kernel="cuda"``, each meshed run
   against the same run in one process: tests/test_sharding.py's distill
   world on ``(1, 2)`` and ``(2, 1)`` (losses within rtol 1e-4, scales
   1e-5, every rank's scales equal), a Mixtral at ``(1, 2)`` (its router
   scale included), and ``eval_ppl(mesh=)`` on ``(2, 1)`` (the sequence
   split) and ``(1, 2)`` (rtol 1e-5); (b) Llama-2-70B at full width cut
   to 2 layers, bf16: compressed on each rank's shards (words equal to
   the whole compression's shard), ``distill_scales`` for 3 steps at
   batch 4, length 128 at tp=2 against one process at tp=1 (each step's
   loss within 5e-3, every scale moved, each matrix's update and its
   gradient of one step from the initial scales within 10% of tp=1's),
   each rank's shard and peak bytes, a step's wall and
   device ms with its top kernels, and its collectives counted and timed
   alone; (c) ``eval_ppl`` on the same world, 2 windows of 1024 + 512
   tokens, on ``(2, 1)`` and ``(1, 2)``, each within 0.5% of one
   process's; rows 4, 5 and 6 launch on each rank in the meshed runs of
   (a) and of (b, c) alone; (d) ``python -m torch.distributed.run
   --nproc-per-node 2 -m bitdelta_torch.cli.train --mesh 1,2`` over a
   tiny fp32 HF pair written by the phase, each rank reading its own
   blocks: ``diff_untrained`` and ``diff`` equal to ``--mesh 1,1``'s
   (words bit-exact, scales within 1e-5), written by rank 0 alone, both
   ranks exiting 0; ``--save_full_model``'s export, streamed from the
   checkpoint, byte for byte ``save_full_model``'s of the whole base and
   the run's own deltas, and within 1e-5 of ``--mesh 1,1``'s.

Prints one JSON line per kernel check, a ``{"kernels": [...]}`` line, the
``nvidia-smi`` name/power-limit line, and finally
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import re
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
PEAK_FP32_S = 67e12           # H100 SXM fp32 outside the tensor cores
L2_BYTES = 50e6
TRACE_TRIES = 3              # profiler traces taken before one counts as lost
TRACE_PAD_S = 0.01           # host time traced before and after the work
QUEUE_SLEEP_CYCLES = 40_000_000   # about 20 ms: the host queues the calls

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
    "binary_matmul_t": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:721"),
    "w4_matmul": (
        "int4", "bitdelta_torch/csrc/int4_gemm.cu",
        "bitdelta_tpu/ops/pallas_int4.py:99"),
    "tenant_delta_matmul": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:254"),
    "fused_tenant_matmul": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:665"),
    "fused_base_pair_matmul": (
        "binary_gemm", "bitdelta_torch/csrc/binary_gemm.cu",
        "bitdelta_tpu/ops/pallas_binary_gemm.py:603"),
}
# The kernels each main path must launch.
PATHS = {
    "serving": ("tenant_delta_matmul_pair", "flash_decode_attention",
                "tenant_dense_matmul", "flash_prefill_attention",
                "binary_matmul"),
    "density": ("w4_matmul", "tenant_delta_matmul_pair",
                "flash_decode_attention", "tenant_dense_matmul",
                "flash_prefill_attention", "binary_matmul"),
    "train": ("flash_prefill_attention", "binary_matmul", "binary_matmul_t"),
    "mixtral": ("tenant_delta_matmul_pair", "flash_decode_attention",
                "tenant_dense_matmul", "binary_matmul"),
    "mixtral_canonical": ("tenant_delta_matmul", "flash_decode_attention",
                          "tenant_dense_matmul"),
    "fused": ("fused_base_pair_matmul", "flash_decode_attention",
              "flash_prefill_attention", "binary_matmul",
              "tenant_delta_matmul_pair"),
    "fused_canonical": ("fused_tenant_matmul", "tenant_delta_matmul",
                        "flash_decode_attention"),
}
# The CUDA kernels behind rows 2 and 4 (profiler filters, kernels line).
DECODE_KERNELS = ("flash_decode_split_kernel", "flash_decode_merge_kernel")
PREFILL_TC_KERNEL = "flash_prefill_tc_kernel"       # bf16, tensor cores
PREFILL_FP32_KERNEL = "flash_prefill_fp32_kernel"   # fp32, CUDA cores
# The two CUDA kernels of row 1: the x prep and the 1-bit MMA product.
PAIR_KERNELS = ("pair_prep_kernel", "pair_delta_tc_kernel")
# The two CUDA kernels of row 7: the global x grid with its bit planes, and
# the 1-bit MMA product.
CANON_KERNELS = ("canon_prep_kernel", "canon_delta_tc_kernel")
# Row 10 with bf16 x and W: row 1's prep and the tensor-core kernel; fp32
# x and W: the CUDA-core kernel and its epilogue.
FUSED_PAIR_KERNELS = ("pair_prep_kernel", "fused_pair_tc_kernel")
FUSED_PAIR_FP32_KERNELS = ("fused_pair_kernel", "fused_pair_epilogue_kernel")
# Row 9 with bf16 x and W (N a multiple of 8): one tensor-core kernel; fp32
# x and W: the CUDA-core kernel and its split sum.
FUSED_TENANT_TC_KERNEL = "fused_tenant_tc_kernel"
FUSED_TENANT_FP32_KERNELS = ("fused_tenant_kernel", "sum_splits_kernel")
# The CUDA kernels behind row 8, by x's dtype, and its K-split sum.
W4_TC_KERNEL = "w4_matmul_tc_kernel"                 # bf16, tensor cores
W4_FP32_KERNEL = "w4_matmul_fp32_kernel"             # fp32, CUDA cores
W4_SPLITS_KERNEL = "w4_sum_splits_kernel"
# Row 3: bf16 x and W on the tensor-core kernel; any other dtype pair (or
# K, N not multiples of 8) on the CUDA-core kernel and its split sum.
DENSE_TC_KERNEL = "tenant_dense_tc_kernel"
DENSE_CORE_KERNELS = ("tenant_dense_kernel", "sum_splits_kernel")
PROJ_SHAPES = (("q_proj", 4096, 4096), ("k_proj", 4096, 1024),
               ("v_proj", 4096, 1024), ("o_proj", 4096, 4096),
               ("gate_proj", 4096, 14336), ("up_proj", 4096, 14336),
               ("down_proj", 14336, 4096))
# A Llama-2-70B rank's local projections at tp=2 (phases 12b and 13b):
# their K and N take other split counts in rows 5 and 6 than Mistral's.
TP70_PROJ_SHAPES = (("q_proj", 8192, 4096), ("k_proj", 8192, 512),
                    ("v_proj", 8192, 512), ("o_proj", 4096, 8192),
                    ("gate_proj", 8192, 14336), ("up_proj", 8192, 14336),
                    ("down_proj", 14336, 8192))


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


def bound(n_bytes, n_ops, peak_ops=PEAK_BF16_S):
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
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
    torch.profiler trace of ``run()``. The trace opens TRACE_PAD_S before
    the work and closes TRACE_PAD_S after it: on the H100 the profiler
    drops device records that land near the edges of its window (a short
    trace then loses some or all of its kernels). A trace that comes back
    empty all the same is taken again (reported on its own line),
    TRACE_TRIES times at most; then the script fails."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            run()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
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


def full_cache_error(fn, plain, q, k, v, hd, **scales):
    """Row 2 on a full cache: every row's length S + 1 (a decode step
    whose own K/V write was dropped), without and with a window, each
    (row, head) held as :func:`attention_error` holds it. Returns the
    max |err|."""
    lengths = torch.full((q.shape[0],), k.shape[1] + 1, device=q.device,
                         dtype=torch.int32)
    worst = 0.0
    for window in (None, 100):
        got = fn(q, k, v, lengths, window=window, **scales)
        torch.cuda.synchronize()
        want = plain(q, k, v, lengths, window=window, **scales)
        torch.cuda.synchronize()
        err, bad = attention_error(got, want, hd)
        require(not bad, f"flash decode, lengths S + 1, window {window}: "
                         f"{bad} (row, head) pairs off by more than 2^-7 of "
                         f"their max |ref| (max|err| {err})")
        worst = max(worst, err)
    return worst


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
    usage, per_kernel = {}, {}
    for name in _build.KERNEL_SOURCES:
        log = _build.BUILD / f"{name}.log"
        if log.exists():
            lines = log.read_text().splitlines()
            usage[name] = [line.strip() for line in lines
                           if "registers" in line or "spill" in line]
            per_kernel.update(ptxas_by_kernel(
                lines, PAIR_KERNELS + FUSED_PAIR_KERNELS[1:]
                + CANON_KERNELS + (DENSE_TC_KERNEL,
                                   FUSED_TENANT_TC_KERNEL)))
    emit({"phase": "build", "seconds": round(total, 3),
          "per_source_s": {k: round(v, 3) for k, v in seconds.items()},
          "ptxas": usage, "ptxas_by_kernel": per_kernel})


def ptxas_by_kernel(lines, names):
    """``-Xptxas -v`` registers, spills and shared memory of each compiled
    entry whose (mangled) name contains one of ``names``."""
    out, current = {}, None
    for line in lines:
        if "Compiling entry function" in line:
            mangled = line.split("'")[1] if "'" in line else line
            current = mangled if any(n in mangled for n in names) else None
        elif current and ("Used" in line or "spill" in line):
            out.setdefault(current, []).append(line.split(":", 1)[-1]
                                               .strip())
    return out


# ---------------------------------------------------------------------------
# 3. Kernel checks at the serving path's Mistral-7B shapes
# ---------------------------------------------------------------------------

def kernel_split_ms(fn, sets, label, names, iters=10):
    """Device ms per call of each kernel in ``names`` (a symbol
    containing the name), from one torch.profiler trace of ``iters``
    calls cycling the input sets."""
    fn(0)
    rows = trace_entries(lambda: [fn(i % sets) for i in range(iters)], label)
    out = {}
    for name in names:
        out[name] = sum(r[0] for r in rows if name in r[2]) / iters / 1e3
        require(out[name] > 0, f"the trace of {label} holds no {name}")
    return out


def queued_ms(fn, sets, iters=50, reps=3):
    """Device ms per call with the calls back to back, median of
    ``reps``: a sleep kernel holds the card while the host queues
    ``iters`` calls, so CUDA events around them time the device alone.
    Row 1's MMA kernel is its prep's programmatic dependent and may start
    before the prep ends; a profiler's per-kernel sum counts that overlap
    twice, this does not."""
    for i in range(2):
        fn(i % sets)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for i in range(iters):
            fn(i % sets)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def kernel_counts(fn, label):
    """``{kernel symbol: launches}`` of one ``fn()``, from a torch.profiler
    trace."""
    return {sym: count for _, count, sym in trace_entries(fn, label)}


def fused_tenant_launches(fn, want, label):
    """Row 9's launches of one ``fn()``: the library's own count of
    ``fused_tenant_tc_kernel`` launches (it loses none) must be ``want``,
    and a profiler trace of one more call must hold that kernel and no
    other (the profiler may drop records, so it names the kernels and
    does not count them). Returns both."""
    from bitdelta_torch.ops import binary_gemm as bg

    torch.cuda.synchronize()
    before = bg.fused_tenant_tc_launched()
    fn()
    torch.cuda.synchronize()
    launched = bg.fused_tenant_tc_launched() - before
    names = sorted(kernel_counts(fn, f"{label} launches"))
    require(launched == want and names and all(
        FUSED_TENANT_TC_KERNEL in sym for sym in names),
        f"{label}: {launched} launches of {FUSED_TENANT_TC_KERNEL} (want "
        f"{want}); the trace holds {names}, want it alone")
    return {"launched": launched, "traced": [sym[:80] for sym in names]}


def nan_row_error(call, plain, x, row, col, label, exact):
    """One NaN at ``x[row, col]``: row ``row`` of the call and of the plain
    version must be NaN throughout, and every other row as without the
    NaN: bit-equal to the call on the clean x, and equal to the plain
    version (``exact``) or within 1e-4 of its largest |value|. Returns the
    other rows' max |kernel - plain|."""
    clean = call(x)
    xn = x.clone()
    xn[row, col] = float("nan")
    got = call(xn)
    want = plain(xn)
    torch.cuda.synchronize()
    require(bool(want[row].isnan().all()) and bool(got[row].isnan().all()),
            f"{label}: a NaN in x row {row} did not make that row NaN "
            f"({int(got[row].isnan().sum())} of {got.shape[1]} NaN)")
    keep = torch.arange(x.shape[0], device=x.device) != row
    require(torch.equal(got[keep], clean[keep]),
            f"{label}: a NaN in x row {row} moved other rows")
    err = (got[keep] - want[keep]).abs().max().item()
    tol = 0.0 if exact else 1e-4 * want[keep].abs().max().item()
    require(err <= tol, f"{label}: other rows max|err| {err} > {tol}")
    return err


def check_pair(dev, gen, results):
    """Row 1 at the seven Mistral-7B projections, B=8 over 3 tenants:
    its two kernels (the x prep, the 1-bit tensor-core product) exact
    against the plain version, and timed together and apart."""
    from bitdelta_torch.core.delta import BinaryDelta, pair_delta
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    bsz, t = 8, 3
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    scales = torch.rand((t,), generator=gen, device=dev) * 0.01 + 0.001
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms", "prep_ms", "main_ms",
                         "queued_ms"), 0.0)
    err, shapes, by = 0.0, [], set()
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
        e = (got - want).abs().max().item()
        err = max(err, e)
        require(torch.equal(got, want),
                f"pair kernel {name}: max|err| {e}, want 0 (exact)")
        # The library call's ±1 stack is unpacked outside the timed call.
        pm1 = unpack_to_pm1(canonical[0], torch.bfloat16)      # (T, K, N)
        del canonical
        x0 = sets[0][0]

        def call(i):
            return bg.tenant_delta_matmul_pair(*sets[i],
                                               out_dtype=torch.float32)

        row = time_wrapper(
            f"pair {name}", call, len(sets), PAIR_KERNELS,
            plain=lambda i: bg.tenant_delta_matmul_pair_plain(*sets[i]),
            library=lambda i: torch.bmm(x0[:, None], pm1[ids]))
        del pm1
        split = kernel_split_ms(call, len(sets), f"pair {name} kernels",
                                PAIR_KERNELS)
        row["prep_ms"], row["main_ms"] = (split[k_] for k_ in PAIR_KERNELS)
        # The MMA kernel may start before its prep ends: queued_ms is the
        # call's device time back to back, without the overlap the
        # profiler's sum (ms, as every row's) counts twice.
        row["queued_ms"] = queued_ms(call, len(sets))
        nbytes = bsz * k * 2 + t * (k // 16) * (n // 2) * 4 + t * n * 4 \
            + bsz * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * bsz * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] += row[key]
        shapes.append({"proj": name, "k": k, "n": n, **row,
                       "max_abs_err": e})
    # A NaN of x inside a 32-K step, at B = 8 and at B = 65 (the second
    # MMA slab), bf16 and fp32 x: that row NaN, every other row exact.
    nan_x = {}
    for nb, row in ((8, 3), (65, 64)):
        packed = torch.randint(-2**31, 2**31 - 1, (t, 4096 // 32, 1024),
                               generator=gen, device=dev, dtype=torch.int32)
        pd = pair_delta(BinaryDelta(packed, scales))
        args = (pd.packed_pairs, pd.colsum, pd.scale,
                torch.arange(nb, device=dev) % t)
        x = torch.randn((nb, 4096), generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            label = f"pair delta NaN B={nb} {str(dtype)[6:]}"
            nan_x[label] = nan_row_error(
                lambda xx: bg.tenant_delta_matmul_pair(
                    xx, *args, out_dtype=torch.float32),
                lambda xx: bg.tenant_delta_matmul_pair_plain(xx, *args),
                x.to(dtype), row, 100, label, exact=True)
    results["tenant_delta_matmul_pair"] = dict(
        tot, max_abs_err=err, bound_by="+".join(sorted(by)), nan_x=nan_x,
        kernel=" + ".join(PAIR_KERNELS),
        tolerance="exact (max|err| 0): the prep repeats the plain x grid "
                  "bit for bit, the sums are exact integers, the epilogue "
                  "rounds op for op as the plain version",
        shape="B=8 T=3, per decode layer: 7 projections",
        timing="ms / kernel_ms: the two kernels' torch.profiler device "
               "times summed (the wrapper launches nothing else); prep_ms / "
               "main_ms: pair_prep_kernel / pair_delta_tc_kernel alone, from "
               "one more trace; queued_ms: device ms per call with the calls "
               "queued back to back (CUDA events around 50 calls held behind "
               "a sleep kernel; the MMA kernel is the prep's programmatic "
               "dependent and may start before it ends, which the profiler's "
               "sum counts twice); " + TIMING,
        bound_basis="bytes: x bf16 + pair words and colsum of the 3 "
                    "tenants + fp32 out; ops: 2*B*K*N at the bf16 rate",
        library="torch.bmm(x[:, None], pm1[ids]) on the unpacked bf16 ±1 "
                "stack (gather + bmm; no 12-bit x grid, no scale)",
        detail=shapes)


# Row 7's calls in one Mixtral-8x7B decode layer of the canonical layout:
# (call site, rows, stacked matrices G, K, N). Attention: B = 8 rows over
# 2 tenants; routed experts: 8 rows x top-2, (tenant, expert) flattened
# into 2 x 8 = 16 matrices.
CANON_SHAPES = (("q_proj", 8, 2, 4096, 4096), ("k_proj", 8, 2, 4096, 1024),
                ("v_proj", 8, 2, 4096, 1024), ("o_proj", 8, 2, 4096, 4096),
                ("w1", 16, 16, 4096, 14336), ("w3", 16, 16, 4096, 14336),
                ("w2", 16, 16, 14336, 4096))


def routed_ids(dev, gen, bsz=8, n_tenants=2, experts=8, topk=2):
    """Flattened (tenant, expert) ids of ``bsz`` decode rows (row b is
    tenant b % n_tenants) that each route to ``topk`` distinct experts."""
    rows = [torch.randperm(experts, generator=gen, device=dev)[:topk]
            for _ in range(bsz)]
    tenant = torch.arange(bsz, device=dev) % n_tenants
    return (tenant[:, None] * experts + torch.stack(rows)).reshape(-1)


def check_canonical(dev, gen, results):
    """Row 7 at the seven call sites of a Mixtral decode layer: its two
    kernels (the global x grid with its bit planes, the 1-bit tensor-core
    product) exact against the plain version with bf16, fp16, fp32 and
    all-zero x; timed with bf16 x, together, apart and queued. Also exact
    at K = 102432 (bf16 and all-max x) and at Mixtral's 65 slots (130
    routed rows, three launches of the main kernel), its prep timed
    there."""
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms", "prep_ms", "main_ms",
                         "queued_ms"), 0.0)
    shapes, by = [], set()
    for name, rows, g, k, n in CANON_SHAPES:
        ids = (routed_ids(dev, gen) if g == 16
               else torch.arange(rows, device=dev) % g)
        scales = torch.rand((g,), generator=gen, device=dev) * 0.01 + 0.001
        distinct = int(torch.unique(ids).numel())
        set_bytes = distinct * k * n // 8 + rows * k * 2
        sets = []
        for _ in range(n_sets(set_bytes)):
            packed = torch.randint(-2**31, 2**31 - 1, (g, k // 32, n),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
            x = torch.randn((rows, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sets.append((x, packed, scales, ids))
        errs = {}
        x0 = sets[0][0]
        for label, xin in (("bf16", x0), ("fp16", x0.half()),
                           ("fp32", x0.float()),
                           ("zero", torch.zeros_like(x0))):
            got = bg.tenant_delta_matmul(xin, *sets[0][1:],
                                         out_dtype=torch.float32)
            torch.cuda.synchronize()
            want = bg.tenant_delta_matmul_plain(xin, *sets[0][1:])
            torch.cuda.synchronize()
            errs[label] = (got - want).abs().max().item()
            require(torch.equal(got, want),
                    f"canonical delta kernel {name} {label} x: max|err| "
                    f"{errs[label]}, want 0 (exact)")
            require(label != "zero" or not got.any().item(),
                    f"canonical delta kernel {name}: zero x gave nonzero y")
        # The library call's ±1 stack is unpacked outside the timed call.
        pm1 = unpack_to_pm1(sets[0][1], torch.bfloat16)        # (G, K, N)

        def call(i):
            return bg.tenant_delta_matmul(*sets[i], out_dtype=torch.float32)

        row = time_wrapper(
            f"canonical {name}", call, len(sets), CANON_KERNELS,
            plain=lambda i: bg.tenant_delta_matmul_plain(*sets[i]),
            library=lambda i: torch.bmm(x0[:, None], pm1[ids]))
        del pm1
        split = kernel_split_ms(call, len(sets), f"canonical {name} kernels",
                                CANON_KERNELS)
        row["prep_ms"], row["main_ms"] = (split[k_] for k_ in CANON_KERNELS)
        # The MMA kernel is the prep's programmatic dependent and may start
        # before it ends: queued_ms is the call's device time back to back.
        row["queued_ms"] = queued_ms(call, len(sets))
        del sets
        nbytes = rows * k * 2 + distinct * (k // 32) * n * 4 + rows * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * rows * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] += row[key]
        shapes.append({"site": name, "rows": rows, "matrices": g,
                       "distinct": distinct, "k": k, "n": n, **row,
                       "max_abs_err": errs})
    # Past the old K limit (K < 131072, K * 2 <= 200 KB): exact at K =
    # 102432, the smallest K it refused, with bf16 and all-max x.
    ids = torch.arange(8, device=dev) % 2
    scales = torch.rand((2,), generator=gen, device=dev) + 0.1
    packed = torch.randint(-2**31, 2**31 - 1, (2, 102432 // 32, 256),
                           generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn((8, 102432), generator=gen, device=dev).to(torch.bfloat16)
    large_k = {}
    for label, xin in (("bf16", x), ("all_max", torch.full_like(x, 0.75))):
        got = bg.tenant_delta_matmul(xin, packed, scales, ids,
                                     out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = bg.tenant_delta_matmul_plain(xin, packed, scales, ids)
        torch.cuda.synchronize()
        large_k[label] = (got - want).abs().max().item()
        require(torch.equal(got, want), f"canonical delta kernel at K = "
                                        f"102432, {label} x: max|err| "
                                        f"{large_k[label]}, want 0 (exact)")
    del packed, x
    # Mixtral at 65 slots: 130 routed rows over 16 (tenant, expert)
    # matrices at w1's shape, three launches of the main kernel.
    ids = routed_ids(dev, gen, bsz=65)
    scales = torch.rand((16,), generator=gen, device=dev) * 0.01 + 0.001
    packed = torch.randint(-2**31, 2**31 - 1, (16, 4096 // 32, 14336),
                           generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn((130, 4096), generator=gen, device=dev).to(torch.bfloat16)
    got = bg.tenant_delta_matmul(x, packed, scales, ids,
                                 out_dtype=torch.float32)
    torch.cuda.synchronize()
    want = bg.tenant_delta_matmul_plain(x, packed, scales, ids)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "canonical delta kernel at B = 130: "
            f"max|err| {(got - want).abs().max().item()}, want 0 (exact)")
    del want

    def call130(_):
        return bg.tenant_delta_matmul(x, packed, scales, ids,
                                      out_dtype=torch.float32)

    split = kernel_split_ms(call130, 1, "canonical B=130 kernels",
                            CANON_KERNELS)
    b130 = {"rows": 130, "matrices": 16, "k": 4096, "n": 14336,
            "max_abs_err": 0.0, "prep_ms": split[CANON_KERNELS[0]],
            "main_ms": split[CANON_KERNELS[1]],
            "queued_ms": queued_ms(call130, 1)}
    del packed, x, got
    results["tenant_delta_matmul"] = dict(
        tot, max_abs_err=0.0, bound_by="+".join(sorted(by)),
        kernel=" + ".join(CANON_KERNELS),
        large_k={"rows": 8, "k": 102432, "n": 256, "max_abs_err": large_k},
        b130=b130,
        tolerance="exact (0) against the plain version with bf16, fp16, "
                  "fp32 and all-zero x: the prep repeats the plain x grid "
                  "bit for bit, the sums are exact integers (int64 past "
                  "the MMA), the epilogue rounds op for op as the plain "
                  "version",
        shape="Mixtral-8x7B canonical decode layer: q/k/v/o at B=8 over 2 "
              "tenants, w1/w3/w2 at 8 rows x top-2 over 16 (tenant, expert) "
              "matrices",
        timing="ms / kernel_ms: the two kernels' torch.profiler device "
               "times summed (the wrapper launches nothing else); prep_ms / "
               "main_ms: canon_prep_kernel / canon_delta_tc_kernel alone, "
               "from one more trace; queued_ms: device ms per call with the "
               "calls queued back to back (CUDA events around 50 calls held "
               "behind a sleep kernel; the MMA kernel is the prep's "
               "programmatic dependent and may start before it ends, which "
               "the profiler's sum counts twice); " + TIMING,
        bound_basis="bytes: x bf16 + the words of the distinct matrices the "
                    "ids touch + fp32 out; ops: 2*rows*K*N at the bf16 rate",
        library="torch.bmm(x[:, None], pm1[ids]) on the unpacked bf16 ±1 "
                "stack (gather + bmm; no 14-bit x grid, no scale)",
        detail=shapes)


def check_fused(dev, gen, results, name):
    """Row 9 (``fused_tenant_matmul``, canonical) or row 10
    (``fused_base_pair_matmul``, pair layout) at the seven Mistral-7B
    projections, B=8 over T=3 tenants: against its plain version with
    bf16 and fp32 x and W, timed with bf16 (profiler and queued) and
    with fp32 (profiler, the CUDA-core kernels; ``results[name]["fp32"]``).
    Row 9
    also at B = 65 (three launches), with 8 distinct tenants in one slab
    (more than a stage holds words of), one launch a call at B = 8, and a
    NaN in x, and beside one cuBLAS matmul for the base and one a distinct
    tenant (``per_tenant_ms``); row 10 with a NaN in the prep's 16-value
    tail (K = 1040)."""
    from bitdelta_torch.core.delta import BinaryDelta, pair_delta
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    pair = name == "fused_base_pair_matmul"
    fn, plain_fn = getattr(bg, name), getattr(bg, name + "_plain")
    kernel_names = (FUSED_PAIR_KERNELS if pair
                    else (FUSED_TENANT_TC_KERNEL,))
    bsz, t = 8, 3
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    scales = torch.rand((t,), generator=gen, device=dev) * 0.01 + 0.001
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms", "queued_ms")
                        + (("prep_ms", "main_ms") if pair
                           else ("per_tenant_ms",)), 0.0)
    err, err32, shapes, by = 0.0, 0.0, [], set()
    # The fp32 x and W calls (the CUDA-core kernels), timed apart.
    fp32_names = (FUSED_PAIR_FP32_KERNELS if pair
                  else FUSED_TENANT_FP32_KERNELS)
    tot32 = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                           "library_ms", "bound_ms"), 0.0)
    by32 = set()

    def make(k, n, nb=bsz, nt=t):
        packed = torch.randint(-2**31, 2**31 - 1, (nt, k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        sc = scales if nt == t else (
            torch.rand((nt,), generator=gen, device=dev) * 0.01 + 0.001)
        x = torch.randn((nb, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
        ii = ids if nb == bsz and nt == t else (
            torch.arange(nb, device=dev) % nt)
        if pair:
            pd = pair_delta(BinaryDelta(packed, sc))
            return (x, w, pd.packed_pairs, pd.colsum, pd.scale, ii), packed
        return (x, w, packed, sc, ii), packed

    def held(args, label, dtype=torch.bfloat16):
        args = (args[0].to(dtype), args[1].to(dtype), *args[2:])
        got = fn(*args, out_dtype=torch.float32)
        torch.cuda.synchronize()
        want = plain_fn(*args)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        require(e <= tol, f"{name} {label}: max|err| {e} > {tol}")
        return e

    for proj, k, n in PROJ_SHAPES:
        set_bytes = k * n * 2 + t * k * n // 8 + bsz * k * 2
        sets, canonical = [], []
        for _ in range(n_sets(set_bytes)):
            args, packed = make(k, n)
            sets.append(args)
            canonical.append(packed)
        errs = {label: held(sets[0], proj + " " + label, dtype)
                for label, dtype in (("bf16", torch.bfloat16),
                                     ("fp32", torch.float32))}
        err, err32 = max(err, errs["bf16"]), max(err32, errs["fp32"])
        # The library calls' ±1 stack is unpacked outside the timed call.
        pm1 = unpack_to_pm1(canonical[0], torch.bfloat16)      # (T, K, N)
        del canonical
        x0, w0 = sets[0][0], sets[0][1]
        groups = tenant_groups(ids)
        if not pair:
            # Row 9's yardstick computes its function (row 10's delta
            # takes x on row 1's 12-bit grid: another function).
            yard = per_tenant_fused(x0, w0, pm1, scales, groups)
            want = plain_fn(*sets[0])
            torch.cuda.synchronize()
            e = (yard - want).abs().max().item()
            require(e <= 1e-4 * want.abs().max().item(),
                    f"{name} {proj}: the per-tenant yardstick is off by {e}")
            del yard, want

        def library(i):
            return torch.matmul(x0, w0), torch.bmm(x0[:, None], pm1[ids])

        def call(i):
            return fn(*sets[i], out_dtype=torch.float32)

        row = time_wrapper(
            f"{name} {proj}", call, len(sets), kernel_names,
            plain=lambda i: plain_fn(*sets[i]), library=library)
        if pair:
            # As row 1: the prep and the main kernel apart (the main
            # kernel is the prep's programmatic dependent; the profiler's
            # sum counts their overlap twice).
            split = kernel_split_ms(call, len(sets), f"{name} {proj} kernels",
                                    FUSED_PAIR_KERNELS)
            row["prep_ms"], row["main_ms"] = (split[k_] for k_ in
                                              FUSED_PAIR_KERNELS)
        # The call's device time with the calls queued back to back.
        row["queued_ms"] = queued_ms(call, len(sets))
        if not pair:
            row["per_tenant_ms"] = device_ms(
                lambda i: per_tenant_fused(x0, w0, pm1, scales, groups), 1,
                f"{name} {proj} per-tenant matmul", iters=5)[0]
        # fp32 x and W: the same inputs widened (exact), on the CUDA-core
        # kernels; the library call is the same two calls in fp32 (TF32
        # off).
        sets32 = [(a[0].float(), a[1].float(), *a[2:]) for a in sets]
        x32, w32, pm1_32 = x0.float(), w0.float(), pm1.float()
        row32 = time_wrapper(
            f"{name} {proj} fp32",
            lambda i: fn(*sets32[i], out_dtype=torch.float32), len(sets32),
            fp32_names, plain=lambda i: plain_fn(*sets32[i]),
            library=lambda i: (torch.matmul(x32, w32),
                               torch.bmm(x32[:, None], pm1_32[ids])))
        del pm1, sets, sets32, x32, w32, pm1_32
        distinct = int(torch.unique(ids).numel())
        words = distinct * k * n // 8 + (distinct * n * 4 if pair else 0)
        nbytes = k * n * 2 + words + bsz * k * 2 + bsz * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * (2 * bsz * k * n))
        by.add(b_by)
        row32["bound_ms"], b_by32 = bound(
            k * n * 4 + words + bsz * k * 4 + bsz * n * 4,
            2 * (2 * bsz * k * n), PEAK_FP32_S)
        by32.add(b_by32)
        for key in tot:
            tot[key] += row[key]
        for key in tot32:
            tot32[key] += row32[key]
        shapes.append({"proj": proj, "k": k, "n": n, **row,
                       "max_abs_err": errs, "fp32": row32})
    extra = {}
    if pair:
        # Row 1's prep keeps a NaN of x in its 16-value tail (K = 1040, a
        # multiple of 16, not 32): that row NaN, the others as before.
        k, n = 1040, 1024
        x = torch.randn((bsz, k), generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
        pairs = torch.randint(-2**31, 2**31 - 1, (t, k // 16, n // 2),
                              generator=gen, device=dev, dtype=torch.int32)
        colsum = torch.randint(-k, k + 1, (t, n), generator=gen,
                               device=dev).to(torch.float32)
        args = (x, w, pairs, colsum, scales, ids)
        extra["nan_x_tail"] = nan_row_error(
            lambda xx: fn(xx, *args[1:], out_dtype=torch.float32),
            lambda xx: plain_fn(xx, *args[1:]), args[0], 5, 1030,
            f"{name} NaN in the tail", exact=False)
    else:
        # One launch of the tensor-core kernel at B = 8, and nothing else.
        args, _ = make(4096, 4096)
        extra["launches_b8"] = fused_tenant_launches(
            lambda: fn(*args, out_dtype=torch.float32), 1, f"{name} B=8")
        extra["nan_x"] = nan_row_error(
            lambda xx: fn(xx, *args[1:], out_dtype=torch.float32),
            lambda xx: plain_fn(xx, *args[1:]), args[0], 3, 100,
            f"{name} NaN in x", exact=False)
        # Past one slab (B = 65: launches of 32, 32 and 1 rows), and 8
        # distinct tenants in a slab of 8 (two passes of 4 tenants' words).
        args, _ = make(4096, 4096, nb=65)
        extra["b65"] = held(args, "B=65")
        extra["launches_b65"] = fused_tenant_launches(
            lambda: fn(*args, out_dtype=torch.float32), 3, f"{name} B=65")
        args, _ = make(4096, 4096, nt=8)
        extra["t8_distinct"] = held(args, "8 distinct tenants")
        del args
    results[name] = dict(
        tot, max_abs_err=err, fp32_max_abs_err=err32,
        bound_by="+".join(sorted(by)), **extra,
        fp32=dict(tot32, max_abs_err=err32, bound_by="+".join(sorted(by32)),
                  kernel=" + ".join(fp32_names),
                  bound_basis="bytes: the fp32 base (K*N*4) + the distinct "
                              "tenants' words + x fp32 + fp32 out; ops: "
                              "4*B*K*N at the fp32 CUDA-core rate",
                  library="torch.matmul(x, W) + torch.bmm(x[:, None], "
                          "pm1[ids]) in fp32 (TF32 off)"),
        tolerance="1e-4 * max|ref| with bf16 and with fp32 x and W: bf16 "
                  "products are exact in fp32 and both sides sum in fp32, "
                  "in another order" + ("; the integer pair sums and row "
                                        "1's epilogue are exact" if pair
                                        else ""),
        shape="B=8 T=3 (3 distinct tenants), per decode layer: 7 "
              "projections", timing=TIMING + (
                  "; ms / kernel_ms: " + " + ".join(kernel_names)
                  + " (the wrapper launches nothing else with bf16 x)"
                  + ("; prep_ms / main_ms: each alone, from one more "
                     "trace" if pair else "")
                  + "; queued_ms: device ms per call with the calls queued "
                  "back to back (CUDA events around 50 calls held behind "
                  "a sleep kernel)"),
        bound_basis="bytes: the bf16 base (K*N*2, read once) + the "
                    "distinct tenants' words" + (" and colsums" if pair
                                                 else "")
                    + " + x bf16 + fp32 out; ops: 2*B*K*N for the base and "
                    "as many for the delta, at the bf16 rate",
        library="torch.matmul(x, W) (cuBLAS) + torch.bmm(x[:, None], "
                "pm1[ids]) on the unpacked bf16 ±1 stack (the unfused "
                "route's base call and the gather + bmm of rows 1 and 7)",
        **({} if pair else {"per_tenant": (
            "per_tenant_ms: cuBLAS x @ W (fp32 out) + one cuBLAS matmul a "
            "distinct tenant on its rows against its unpacked bf16 ±1 "
            "matrix, scaled and added (each matrix read once; unpacked "
            "outside the timed call)")}),
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
    full_err = full_cache_error(fd.flash_decode_attention,
                                fd.flash_decode_attention_plain, q, k, v, hd)
    pos = torch.arange(s, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]
    kk, vv, mask = _sdpa_inputs(q[:, :, None, :], k, v, mask)
    q4 = q[:, :, None, :]
    row = time_wrapper(
        "flash decode",
        lambda i: fd.flash_decode_attention(*sets[i], window=window),
        len(sets), DECODE_KERNELS,
        plain=lambda i: fd.flash_decode_attention_plain(*sets[i],
                                                        window=window),
        library=lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                         attn_mask=mask))
    nbytes = set_bytes + 2 * bsz * h * hd * 2
    b_ms, b_by = bound(nbytes, 4 * h * hd * live)
    results["flash_decode_attention"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fp32_max_abs_err=err32, full_cache_max_abs_err=full_err,
        tolerance="bf16: each (row, head) within 2^-7 of its own max|ref|, "
                  "also at lengths S + 1 (a full cache) with and without a "
                  "window of 100; fp32 inputs: 1e-4 absolute",
        bound_basis="bytes: live K/V rows + q + out (bf16); ops: 4*H*hd "
                    "per live key at the bf16 rate",
        shape="B=8 H=32 KV=8 hd=128 cache 2048, lengths "
              f"{lengths.tolist()}, window {window}",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(padded cache, boolean mask)",
        group1=check_decode_group(dev, gen, lengths, window, 32),
        group8=check_decode_group(dev, gen, lengths, window, 4))


def check_group(label, group, fn, plain, sets, hd, window, kernel_names,
                library, n_bytes, n_ops):
    """Rows 2 and 4 at ``group`` query heads a KV head, an instance the
    phase-1 checks (G = 4) do not run: G = 1 is Llama-2-7B's (phase 11b),
    G = 8 Llama-2-70B's at tp = 2 (32 / 4 heads a rank, phase 12b). bf16
    held per (row, head) as :func:`attention_error` holds it, fp32 inputs
    within 1e-4, and timed as the G = 4 rows are."""
    got = fn(*sets[0], window=window)
    torch.cuda.synchronize()
    want = plain(*sets[0], window=window)
    torch.cuda.synchronize()
    err, bad = attention_error(got, want, hd)
    require(not bad, f"{label} group {group}: {bad} (row, head) pairs off "
                     f"by more than 2^-7 of their max |ref| (max|err| "
                     f"{err})")
    err32 = fp32_attention_error(fn, plain, sets[0], window)
    require(err32 <= 1e-4,
            f"{label} group {group} fp32: max|err| {err32} > 1e-4")
    row = time_wrapper(f"{label} group {group}",
                       lambda i: fn(*sets[i], window=window), len(sets),
                       kernel_names,
                       plain=lambda i: plain(*sets[i], window=window),
                       library=library)
    b_ms, b_by = bound(n_bytes, n_ops)
    return dict(row, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                fp32_max_abs_err=err32)


def check_decode_group(dev, gen, lengths, window, kvh):
    """Row 2 at B=8, H=32, hd=128, cache 2048 over ``kvh`` KV heads: 32
    (G = 1, Llama-2-7B) or 4 (G = 8, a Llama-2-70B rank at tp = 2)."""
    import torch.nn.functional as F

    from bitdelta_torch.ops import flash_decode as fd

    bsz, h, hd, s = 8, 32, 128, 2048
    live = int(lengths.sum())
    set_bytes = live * kvh * hd * 2 * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((bsz, h, hd), (bsz, s, kvh, hd),
                                          (bsz, s, kvh, hd)))
        sets.append((q, k, v, lengths))
    q, k, v, _ = sets[0]
    pos = torch.arange(s, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]
    kk, vv, mask = _sdpa_inputs(q[:, :, None, :], k, v, mask)
    q4 = q[:, :, None, :]
    res = check_group(
        "flash decode", h // kvh, fd.flash_decode_attention,
        fd.flash_decode_attention_plain, sets, hd, window, DECODE_KERNELS,
        lambda i: F.scaled_dot_product_attention(q4, kk, vv, attn_mask=mask),
        set_bytes + 2 * bsz * h * hd * 2, 4 * h * hd * live)
    res["shape"] = (f"B=8 H=32 KV={kvh} hd=128 cache 2048, lengths "
                    f"{lengths.tolist()}, window {window}")
    return res


def check_decode_int8(dev, gen, results):
    """Row 2's int8-cache branch at row 2's shapes: K/V from quantize_kv
    of random bf16 values, scales folded in the kernel."""
    import torch.nn.functional as F

    from bitdelta_torch.ops import flash_decode as fd
    from bitdelta_torch.ops.kv_quant import dequantize_kv, quantize_kv

    bsz, h, kvh, hd, s, window = 8, 32, 8, 128, 2048, 4096
    lengths = torch.tensor([2048, 1537, 1024, 777, 512, 300, 64, 1],
                           device=dev, dtype=torch.int32)
    live = int(lengths.sum())
    set_bytes = live * kvh * (hd + 4) * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        q = torch.randn((bsz, h, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        k8, ks = quantize_kv(torch.randn((bsz, s, kvh, hd), generator=gen,
                                         device=dev).to(torch.bfloat16))
        v8, vs = quantize_kv(torch.randn((bsz, s, kvh, hd), generator=gen,
                                         device=dev).to(torch.bfloat16))
        sets.append((q, k8, v8, lengths, ks, vs))

    def kernel(q, k8, v8, lens, ks, vs):
        return fd.flash_decode_attention(q, k8, v8, lens, k_scale=ks,
                                         v_scale=vs, window=window)

    def plain(q, k8, v8, lens, ks, vs):
        return fd.flash_decode_attention_plain(q, k8, v8, lens, k_scale=ks,
                                               v_scale=vs, window=window)

    got = kernel(*sets[0])
    torch.cuda.synchronize()
    want = plain(*sets[0])
    torch.cuda.synchronize()
    err, bad = attention_error(got, want, hd)
    require(not bad, f"flash decode int8: {bad} (row, head) pairs off by "
                     f"more than 2^-7 of their max |ref| (max|err| {err})")
    q32 = sets[0][0].float()
    got32 = kernel(q32, *sets[0][1:])
    torch.cuda.synchronize()
    err32 = (got32 - plain(q32, *sets[0][1:])).abs().max().item()
    require(err32 <= 1e-4, f"flash decode int8, fp32 q: max|err| {err32} "
                           f"> 1e-4")
    q, k8, v8, _, ks, vs = sets[0]
    full_err = full_cache_error(fd.flash_decode_attention,
                                fd.flash_decode_attention_plain, q, k8, v8,
                                hd, k_scale=ks, v_scale=vs)
    pos = torch.arange(s, device=dev)
    mask = (pos[None] < lengths[:, None])[:, None, None, :]
    kk, vv, mask = _sdpa_inputs(q[:, :, None, :],
                                dequantize_kv(k8, ks, torch.bfloat16),
                                dequantize_kv(v8, vs, torch.bfloat16), mask)
    q4 = q[:, :, None, :]
    row = time_wrapper(
        "flash decode int8", lambda i: kernel(*sets[i]), len(sets),
        DECODE_KERNELS,
        plain=lambda i: plain(*sets[i]),
        library=lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                         attn_mask=mask))
    nbytes = set_bytes + 2 * bsz * h * hd * 2
    b_ms, b_by = bound(nbytes, 4 * h * hd * live)
    results["flash_decode_attention_int8"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fp32_max_abs_err=err32, full_cache_max_abs_err=full_err,
        tolerance="bf16 q: each (row, head) within 2^-7 of its own "
                  "max|ref|, also at lengths S + 1 with and without a "
                  "window of 100; fp32 q: 1e-4 absolute",
        bound_basis="bytes: live int8 K/V rows and their fp32 scales + q + "
                    "out (bf16); ops: 4*H*hd per live key at the bf16 rate",
        shape="B=8 H=32 KV=8 hd=128 int8 cache 2048 (K/V = quantize_kv of "
              f"random bf16), lengths {lengths.tolist()}, window {window}",
        library="torch.nn.functional.scaled_dot_product_attention on the "
                "dequantized bf16 cache (padded, boolean mask; the "
                "dequantization is not timed)")


def check_decode_lengths(dev, gen, results):
    """Row 2 at uniform lengths of 128, 512 and 2048 keys (B=8, a bf16
    cache of 2048 slots), each with its bound: the time should follow the
    live bytes."""
    from bitdelta_torch.ops import flash_decode as fd

    bsz, h, kvh, hd, s = 8, 32, 8, 128, 2048
    for n in (128, 512, 2048):
        lengths = torch.full((bsz,), n, device=dev, dtype=torch.int32)
        set_bytes = bsz * n * kvh * hd * 2 * 2
        sets = []
        for _ in range(n_sets(set_bytes, cap=8)):
            q = torch.randn((bsz, h, hd), generator=gen, device=dev).to(
                torch.bfloat16)
            k = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).to(
                torch.bfloat16)
            sets.append((q, k, torch.randn_like(k), lengths))
        ms, kernel_ms = device_ms(
            lambda i: fd.flash_decode_attention(*sets[i]), len(sets),
            f"flash decode, uniform length {n}", DECODE_KERNELS)
        b_ms, b_by = bound(set_bytes + 2 * bsz * h * hd * 2,
                           4 * h * hd * bsz * n)
        results[f"flash_decode_attention_uniform_{n}"] = dict(
            ms=ms, kernel_ms=kernel_ms, bound_ms=b_ms, bound_by=b_by,
            timing=TIMING, shape=f"B=8 H=32 KV=8 hd=128 bf16 cache 2048, "
                                 f"every length {n}, no window")
        del sets


def int4pack_ms(x, packed, scale):
    """Device ms of ``torch._weight_int4pack_mm`` at group 128 on the same
    weights, where this torch has it (a time only: it rounds the scales
    to bf16). Returns ``(ms or None, note)``."""
    if not (hasattr(torch, "_weight_int4pack_mm")
            and hasattr(torch, "_convert_weight_to_int4pack")):
        return None, "torch has no _weight_int4pack_mm"
    from bitdelta_torch.research.quantized_base import _unpack_nibbles

    # tinygemm's layout: (N, K/2) uint8 of unsigned nibbles q = nib + 8,
    # dequantized as (q - 8) * scale + zero with zero 0.
    q = (_unpack_nibbles(packed) + 8).transpose(0, 1).contiguous()
    w_u8 = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8)
    try:
        w_pack = torch._convert_weight_to_int4pack(w_u8, 8)
        sz = torch.stack([scale, torch.zeros_like(scale)], dim=-1).to(
            torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16)
        ms = device_ms(lambda i: torch._weight_int4pack_mm(xb, w_pack, 128,
                                                           sz),
                       1, "int4pack", iters=5)[0]
    except (RuntimeError, TypeError) as e:   # yardstick only
        return None, f"_weight_int4pack_mm failed: {e}"[:200]
    return ms, "torch._weight_int4pack_mm, group 128, bf16 scales"


def check_w4(dev, gen, results):
    """Row 8 at the seven Mistral-7B projections with M = 8 (a decode
    step's rows), and at M = 1 and 64 on down_proj, bf16 and fp32 x; the
    bf16 tensor-core kernel and the fp32 CUDA-core kernel timed apart."""
    from bitdelta_torch.ops import int4 as i4
    from bitdelta_torch.research.quantized_base import (Int4Weight,
                                                        dequantize_int4,
                                                        quantize_int4)

    def weights(k, n):
        return quantize_int4(torch.randn((k, n), generator=gen, device=dev)
                             * 0.02)

    def hold(x, w, label):
        errs = []
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            got = i4.w4_matmul(xd, w.packed, w.scale,
                               out_dtype=torch.float32)
            torch.cuda.synchronize()
            want = i4.w4_matmul_plain(xd, w.packed, w.scale)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            require(e <= tol, f"w4 matmul {label} {dtype}: max|err| {e} > "
                              f"{tol}")
            errs.append(e)
        return errs

    m = 8
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms", "int4pack_ms"), 0.0)
    tot32 = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                           "library_ms", "bound_ms"), 0.0)
    err, err32, shapes, by, by32, notes = 0.0, 0.0, [], set(), set(), set()
    for name, k, n in PROJ_SHAPES:
        set_bytes = k * n // 2 + (k // 128) * n * 4
        sets = []
        for _ in range(n_sets(set_bytes)):
            w = weights(k, n)
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            sets.append((x, w.packed, w.scale))
        e, e32 = hold(sets[0][0], Int4Weight(*sets[0][1:]), name)
        err, err32 = max(err, e), max(err32, e32)
        x0 = sets[0][0]
        w_deq = dequantize_int4(Int4Weight(*sets[0][1:]), torch.bfloat16)
        row = time_wrapper(
            f"w4 {name}",
            lambda i: i4.w4_matmul(*sets[i], out_dtype=torch.float32),
            len(sets), (W4_TC_KERNEL, W4_SPLITS_KERNEL),
            plain=lambda i: i4.w4_matmul_plain(*sets[i]),
            library=lambda i: torch.matmul(x0, w_deq))
        row["int4pack_ms"], note = int4pack_ms(*sets[0])
        notes.add(note)
        nbytes = m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4
        row["bound_ms"], b_by = bound(nbytes, 2 * m * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] = (None if tot[key] is None or row[key] is None
                        else tot[key] + row[key])
        # The fp32 branch (its own CUDA-core kernel) on set 0.
        x32, w32 = x0.float(), w_deq.float()
        del w_deq
        row32 = time_wrapper(
            f"w4 fp32 {name}",
            lambda i: i4.w4_matmul(x32, *sets[0][1:],
                                   out_dtype=torch.float32),
            1, (W4_FP32_KERNEL, W4_SPLITS_KERNEL),
            plain=lambda i: i4.w4_matmul_plain(x32, *sets[0][1:]),
            library=lambda i: torch.matmul(x32, w32), iters=5)
        del x32, w32
        row32["bound_ms"], b32_by = bound(nbytes + m * k * 2, 2 * m * k * n,
                                          PEAK_FP32_S)
        by32.add(b32_by)
        for key in tot32:
            tot32[key] += row32[key]
        shapes.append({"proj": name, "k": k, "n": n,
                       "splits": i4._splits(n, k // 128), **row,
                       "max_abs_err": e, "fp32_max_abs_err": e32,
                       "fp32": row32})
        del sets
    other_m = []
    k, n = 14336, 4096
    w = weights(k, n)
    for m2 in (1, 64):
        x = torch.randn((m2, k), generator=gen, device=dev).to(torch.bfloat16)
        e, e32 = hold(x, w, f"down_proj M={m2}")
        err, err32 = max(err, e), max(err32, e32)
        ms, kern = device_ms(lambda i: i4.w4_matmul(x, w.packed, w.scale,
                                                    out_dtype=torch.float32),
                             1, f"w4 down_proj M={m2}",
                             (W4_TC_KERNEL, W4_SPLITS_KERNEL))
        b_ms, b_by = bound(m2 * k * 2 + k * n // 2 + (k // 128) * n * 4
                           + m2 * n * 4, 2 * m2 * k * n)
        other_m.append({"proj": "down_proj", "m": m2, "ms": ms,
                        "kernel_ms": kern, "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": e, "fp32_max_abs_err": e32})
    results["w4_matmul_fp32"] = dict(
        tot32, max_abs_err=err32, bound_by="+".join(sorted(by32)),
        kernel=W4_FP32_KERNEL, timing=TIMING,
        bound_basis="ops: 2*M*K*N at the fp32 CUDA-core rate (67 "
                    "TFLOP/s); bytes: x fp32 + words + scales + fp32 out",
        shape="as w4_matmul, x in fp32",
        library="torch.matmul(x, dequantized matrix), both fp32")
    results["w4_matmul"] = dict(
        tot, max_abs_err=err, fp32_max_abs_err=err32, kernel=W4_TC_KERNEL,
        bound_by="+".join(sorted(by)),
        tolerance="1e-4 * max|ref| (fp32 sums in another order), bf16 and "
                  "fp32 x",
        shape="M=8, per decode layer: 7 projections; also M=1 and M=64 on "
              "down_proj (other_m)", timing=TIMING,
        bound_basis="bytes: x bf16 + K/8*N int32 words + K/128*N fp32 "
                    "scales + fp32 out; ops: 2*M*K*N at the bf16 rate",
        library="torch.matmul(x, dequantized bf16 matrix): the bf16 "
                "base's call",
        int4pack_note="; ".join(sorted(notes)), detail=shapes,
        other_m=other_m)


def tenant_groups(ids):
    """``[(tenant, row index tensor), ...]`` of each distinct tenant."""
    return [(t, (ids == t).nonzero()[:, 0])
            for t in torch.unique(ids).tolist()]


def per_tenant_matmul(x, w, groups):
    """Row 3's yardstick: one fp32-summed matmul (cuBLAS) a distinct
    tenant on that tenant's rows, reading each head once; ``groups`` is
    ``[(tenant, row index tensor), ...]``."""
    from bitdelta_torch.ops.binary_matmul import matmul_f32

    out = torch.empty((x.shape[0], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for t, rows in groups:
        out[rows] = matmul_f32(x[rows], w[t])
    return out


def per_tenant_fused(x, w, pm1, scales, groups):
    """Row 9's yardstick: ``x @ W`` (cuBLAS, fp32 out), then one
    cuBLAS matmul a distinct tenant on its rows against its unpacked bf16
    ±1 matrix ``pm1[t]``, scaled and added; ``groups`` as
    ``tenant_groups``."""
    from bitdelta_torch.ops.binary_matmul import matmul_f32

    out = matmul_f32(x, w)
    for t, rows in groups:
        out[rows] += scales[t] * matmul_f32(x[rows], pm1[t])
    return out


def check_dense(dev, gen, results):
    """Row 3 at Mistral-7B's head (K = 4096, N = 32000) over 3 tenants:
    bf16 on the tensor-core kernel at B = 8 (against the plain version),
    B = 1 and B = 64 with one tenant holding 40 rows (against one matmul
    a distinct tenant: the plain version's gather would copy 17 GB); the
    model's mixed case (bf16 x, fp32 head) on the CUDA-core kernel."""
    from bitdelta_torch.ops import binary_gemm as bg

    bsz, t, k, n = 8, 3, 4096, 32000
    ids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 0], device=dev)
    x = torch.randn((bsz, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((t, k, n), generator=gen, device=dev) * 0.02).to(
        torch.bfloat16)

    def hold(got, want, label):
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-4 * want.abs().max().item()
        require(err <= tol, f"tenant dense {label}: max|err| {err} > {tol}")
        return err

    def call(x, ids):
        return lambda i: bg.tenant_dense_matmul(x, w, ids,
                                                out_dtype=torch.float32)

    err = hold(call(x, ids)(0), bg.tenant_dense_matmul_plain(x, w, ids),
               "B=8")
    groups = tenant_groups(ids)
    row = time_wrapper(
        "tenant dense", call(x, ids), 1, (DENSE_TC_KERNEL,),
        plain=lambda i: bg.tenant_dense_matmul_plain(x, w, ids),
        library=lambda i: torch.bmm(x[:, None, :], w[ids]))
    row["queued_ms"] = queued_ms(call(x, ids), 1)
    row["per_tenant_ms"] = device_ms(
        lambda i: per_tenant_matmul(x, w, groups), 1,
        "tenant dense per-tenant matmul", iters=5)[0]
    b_ms, b_by = bound(t * k * n * 2 + bsz * k * 2 + bsz * n * 4,
                       2 * bsz * k * n)
    other_b = []
    for ids_b in (torch.tensor([1], device=dev),
                  torch.tensor([0] * 40 + [1] * 12 + [2] * 12, device=dev)):
        m = len(ids_b)
        xb = torch.randn((m, k), generator=gen, device=dev).to(
            torch.bfloat16)
        gb = tenant_groups(ids_b)
        want = (bg.tenant_dense_matmul_plain(xb, w, ids_b) if m == 1
                else per_tenant_matmul(xb, w, gb))
        e = hold(call(xb, ids_b)(0), want, f"B={m}")
        ms, kern = device_ms(call(xb, ids_b), 1, f"tenant dense B={m}",
                             (DENSE_TC_KERNEL,))
        ob_ms, ob_by = bound(len(gb) * k * n * 2 + m * k * 2 + m * n * 4,
                             2 * m * k * n)
        other_b.append({
            "b": m, "distinct_tenants": len(gb), "ms": ms, "kernel_ms": kern,
            "queued_ms": queued_ms(call(xb, ids_b), 1), "bound_ms": ob_ms,
            "bound_by": ob_by, "max_abs_err": e,
            "per_tenant_ms": device_ms(
                lambda i: per_tenant_matmul(xb, w, gb), 1,
                f"tenant dense B={m} per-tenant matmul", iters=5)[0]})
        del want
    # The model's mixed case: bf16 x under an fp32 head stack, on the
    # CUDA-core kernel and its split sum (the head is never cast).
    w32 = w.float()
    err32 = hold(bg.tenant_dense_matmul(x, w32, ids, out_dtype=torch.float32),
                 bg.tenant_dense_matmul_plain(x, w32, ids), "bf16 x, fp32 W")
    x32 = x.float()
    row32 = time_wrapper(
        "tenant dense fp32 W",
        lambda i: bg.tenant_dense_matmul(x, w32, ids,
                                         out_dtype=torch.float32),
        1, DENSE_CORE_KERNELS,
        plain=lambda i: bg.tenant_dense_matmul_plain(x, w32, ids),
        library=lambda i: torch.bmm(x32[:, None, :], w32[ids]), iters=5)
    del w32, x32
    b32_ms, b32_by = bound(t * k * n * 4 + bsz * k * 2 + bsz * n * 4,
                           2 * bsz * k * n, PEAK_FP32_S)
    results["tenant_dense_matmul_fp32"] = dict(
        row32, timing=TIMING, bound_ms=b32_ms, bound_by=b32_by,
        max_abs_err=err32, kernel=" + ".join(DENSE_CORE_KERNELS),
        shape="as tenant_dense_matmul, the head stack in fp32 (x bf16)",
        bound_basis="ops: 2*B*K*N at the fp32 CUDA-core rate (67 TFLOP/s); "
                    "bytes: the 3 fp32 heads + x + fp32 out",
        library="torch.bmm(x[:, None], W[ids]) in fp32 (gather + bmm)")
    results["tenant_dense_matmul"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=err, kernel=DENSE_TC_KERNEL,
        tolerance="1e-4 * max|ref| (fp32 sums in another order); at B=64 "
                  "against one matmul a distinct tenant",
        shape="B=8 T=3 K=4096 N=32000 (lm_head), 3 distinct tenants; also "
              "B=1 and B=64 (40 + 12 + 12 rows) in other_b",
        bound_basis="bytes: the distinct tenants' (K, N) bf16 heads + x + "
                    "fp32 out; ops: 2*B*K*N at the bf16 rate",
        library="torch.bmm(x[:, None], W[ids]) (gather + bmm)",
        per_tenant="per_tenant_ms: one cuBLAS matmul (fp32 out) a distinct "
                   "tenant on its rows, each head read once",
        queued="queued_ms: device ms per call with the calls queued back "
               "to back (chip_smoke.queued_ms)",
        other_b=other_b)


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
        len(sets), (PREFILL_TC_KERNEL,),
        plain=lambda i: fp.flash_prefill_attention_plain(*sets[i],
                                                         window=window),
        library=lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                         attn_mask=m4))
    nbytes = sq * h * hd * 2 * 2 + int(lengths.sum()) * kvh * hd * 2 * 2
    b_ms, b_by = bound(nbytes, 4 * hd * h * visible)
    # The fp32 branch (its own CUDA-core kernel) at the same shape.
    a32 = [t.float() for t in sets[0][:3]] + [lengths]
    q32, kk32, vv32 = q4.float(), kk.float(), vv.float()
    row32 = time_wrapper(
        "flash prefill fp32",
        lambda i: fp.flash_prefill_attention(*a32, window=window), 1,
        (PREFILL_FP32_KERNEL,),
        plain=lambda i: fp.flash_prefill_attention_plain(*a32,
                                                         window=window),
        library=lambda i: F.scaled_dot_product_attention(q32, kk32, vv32,
                                                         attn_mask=m4))
    b32_ms, b32_by = bound(2 * nbytes, 4 * hd * h * visible, PEAK_FP32_S)
    results["flash_prefill_attention_fp32"] = dict(
        row32, timing=TIMING, bound_ms=b32_ms, bound_by=b32_by,
        max_abs_err=err32, kernel=PREFILL_FP32_KERNEL,
        bound_basis="ops: 4*hd per visible (query, key) pair and head at "
                    "the fp32 CUDA-core rate (67 TFLOP/s); bytes: q + live "
                    "K/V + out (fp32)",
        shape="as flash_prefill_attention, q/k/v in fp32",
        library="torch.nn.functional.scaled_dot_product_attention in fp32 "
                "(boolean mask)")
    del a32, q32, kk32, vv32
    results["flash_prefill_attention"] = dict(
        row, timing=TIMING, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
        fp32_max_abs_err=err32, kernel=PREFILL_TC_KERNEL,
        tolerance="bf16: each (query row, head) within 2^-7 of its own "
                  "max|ref|; fp32 inputs: 1e-4 absolute",
        bound_basis="ops: 4*hd per visible (query, key) pair and head at the "
                    "bf16 rate; bytes: q + live K/V + out (bf16)",
        shape=f"B=1 bucket 512 length 500 H=32 KV=8 hd=128, "
              f"{visible} visible (query, key) pairs per head",
        library="torch.nn.functional.scaled_dot_product_attention "
                "(boolean mask)",
        group1=check_prefill_group(dev, gen, window, 32),
        group8=check_prefill_group(dev, gen, window, 4))


def check_prefill_group(dev, gen, window, kvh):
    """Row 4 at B=8, bucket 256, H=32, hd=128 over ``kvh`` KV heads: 32
    (G = 1, Llama-2-7B) or 4 (G = 8, a Llama-2-70B rank at tp = 2); one
    length a row from a full bucket down to 1."""
    import torch.nn.functional as F

    from bitdelta_torch.ops import flash_prefill as fp

    bsz, sq, h, hd = 8, 256, 32, 128
    lengths = torch.tensor([256, 200, 129, 128, 64, 33, 16, 1], device=dev,
                           dtype=torch.int32)
    set_bytes = bsz * sq * (h + 2 * kvh) * hd * 2
    sets = []
    for _ in range(n_sets(set_bytes)):
        q, k, v = (torch.randn((bsz, sq, heads, hd), generator=gen,
                               device=dev).to(torch.bfloat16)
                   for heads in (h, kvh, kvh))
        sets.append((q, k, v, lengths))
    mask = fp.prefill_mask(sq, sq, lengths, window)
    visible = int(mask.sum())
    q, k, v, _ = sets[0]
    q4 = q.transpose(1, 2).contiguous()
    kk, vv, _ = _sdpa_inputs(q4, k, v, None)
    res = check_group(
        "flash prefill", h // kvh, fp.flash_prefill_attention,
        fp.flash_prefill_attention_plain, sets, hd, window,
        (PREFILL_TC_KERNEL,),
        lambda i: F.scaled_dot_product_attention(q4, kk, vv,
                                                 attn_mask=mask[:, None]),
        bsz * sq * h * hd * 2 * 2 + int(lengths.sum()) * kvh * hd * 2 * 2,
        4 * hd * h * visible)
    res["shape"] = (f"B=8 bucket 256 H=32 KV={kvh} hd=128, lengths "
                    f"{lengths.tolist()}, {visible} visible (query, key) "
                    f"pairs per head")
    return res


def _hold_binary_at_tp70(dev, gen, label, wrapper, plain, transposed):
    """Row 5 (``transposed`` False) or row 6 at the 70B tp=2 local shapes
    and M=512: bf16 and fp32 input, each within 1e-4 of max|ref| of its
    plain version. Returns one detail entry a projection, with the
    reduction splits each input dtype took."""
    from bitdelta_torch.ops import binary_gemm as bg

    m = 512
    rows = []
    for name, k, n in TP70_PROJ_SHAPES:
        a = torch.randn((m, n if transposed else k), generator=gen,
                        device=dev).to(torch.bfloat16)
        packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        scale = torch.tensor(0.003, device=dev)
        n_out, red = (k, n) if transposed else (n, k)
        row = {"proj": name, "k": k, "n": n, "m": m}
        for dtype, key, per_sm in ((torch.bfloat16, "", 2),
                                   (torch.float32, "fp32_", 1)):
            ad = a.to(dtype)
            got = wrapper(ad, packed, scale, out_dtype=torch.float32)
            want = plain(ad, packed, scale)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            require(e <= tol, f"{label} {name} at the 70B tp=2 shape "
                              f"{dtype}: max|err| {e} > {tol}")
            row[key + "max_abs_err"] = e
            row[key + "splits"] = bg._gemm_splits(m, n_out, red, per_sm,
                                                  dev)[0]
            del got, want, ad
        rows.append(row)
    return rows


def check_binary(dev, gen, results):
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    m = 512
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms"), 0.0)
    err, err32, shapes, by = 0.0, 0.0, [], set()
    for name, k, n in PROJ_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        scale = torch.tensor(0.003, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            xd = x.to(dtype)
            got = bg.binary_matmul(xd, packed, scale,
                                   out_dtype=torch.float32)
            torch.cuda.synchronize()
            want = bg.binary_matmul_plain(xd, packed, scale)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            require(e <= tol, f"binary matmul {name} {dtype}: max|err| {e} "
                              f"> {tol}")
            if dtype == torch.bfloat16:
                err = max(err, e)
            else:
                err32 = max(err32, e)
        del got, want, xd
        pm1 = unpack_to_pm1(packed, torch.bfloat16)
        row = time_wrapper(
            f"binary matmul {name}",
            lambda i: bg.binary_matmul(x, packed, scale,
                                       out_dtype=torch.float32),
            1, ("binary_matmul_kernel", "binary_splits_kernel"),
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
        tot, max_abs_err=err, fp32_max_abs_err=err32,
        bound_by="+".join(sorted(by)),
        tolerance="1e-4 * max|ref| (fp32 sums in another order), bf16 and "
                  "fp32 x",
        shape="M=512, per prefill layer: 7 projections", timing=TIMING,
        bound_basis="ops: 2*M*K*N at the bf16 rate (±1 is exact in bf16); "
                    "bytes: x bf16 + K/32*N words + fp32 out",
        library="torch.matmul(x, unpacked ±1 bf16 matrix)", detail=shapes,
        tp70=_hold_binary_at_tp70(dev, gen, "binary matmul",
                                  bg.binary_matmul, bg.binary_matmul_plain,
                                  False))


def check_binary_t(dev, gen, results):
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops.packing import unpack_to_pm1

    m = 512
    tot = dict.fromkeys(("ms", "kernel_ms", "event_ms", "plain_ms",
                         "library_ms", "bound_ms"), 0.0)
    err, err32, shapes, by = 0.0, 0.0, [], set()
    for name, k, n in PROJ_SHAPES:
        # The activation gradient of projection (K -> N): g (M, N) in,
        # (M, K) out.
        g = torch.randn((m, n), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        scale = torch.tensor(0.003, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            gd = g.to(dtype)
            got = bg.binary_matmul_t(gd, packed, scale,
                                     out_dtype=torch.float32)
            torch.cuda.synchronize()
            want = bg.binary_matmul_t_plain(gd, packed, scale)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = 1e-4 * want.abs().max().item()
            require(e <= tol, f"binary matmul t {name} {dtype}: max|err| "
                              f"{e} > {tol}")
            if dtype == torch.bfloat16:
                err = max(err, e)
            else:
                err32 = max(err32, e)
        del got, want
        pm1 = unpack_to_pm1(packed, torch.bfloat16)               # (K, N)
        # As the trainable matmul's backward calls it: bf16 in and out.
        row = time_wrapper(
            f"binary matmul t {name}",
            lambda i: bg.binary_matmul_t(g, packed, scale),
            1, ("binary_matmul_t_kernel", "binary_splits_kernel"),
            plain=lambda i: bg.binary_matmul_t_plain(g, packed, scale),
            library=lambda i: torch.matmul(g, pm1.T), iters=5)
        del pm1
        nbytes = m * n * 2 + (k // 32) * n * 4 + m * k * 2
        row["bound_ms"], b_by = bound(nbytes, 2 * m * k * n)
        by.add(b_by)
        for key in tot:
            tot[key] += row[key]
        shapes.append({"proj": name, "k": k, "n": n, **row})
    results["binary_matmul_t"] = dict(
        tot, max_abs_err=err, fp32_max_abs_err=err32,
        bound_by="+".join(sorted(by)),
        tolerance="1e-4 * max|ref| (fp32 sums in another order), bf16 and "
                  "fp32 g",
        shape="M=512, per training layer: the 7 projections' activation "
              "gradients, bf16 in and out", timing=TIMING,
        bound_basis="ops: 2*M*K*N at the bf16 rate (±1 is exact in bf16); "
                    "bytes: g bf16 + K/32*N words + bf16 out",
        library="torch.matmul(g, unpacked ±1 bf16 matrix .T)",
        detail=shapes,
        tp70=_hold_binary_at_tp70(dev, gen, "binary matmul t",
                                  bg.binary_matmul_t,
                                  bg.binary_matmul_t_plain, True))


def grad_error(got, want, row):
    """Max |got - want| of a gradient, and the count of rows of ``row``
    values off by more than 2^-7 of their own max |want| (one bf16 ulp
    of the row's largest value: both sides compute in fp32 and round
    once)."""
    diff = (got.float() - want.float()).reshape(-1, row).abs()
    tol = 2 ** -7 * want.float().reshape(-1, row).abs().amax(-1)
    return diff.max().item(), int((diff.amax(-1) > tol).sum())


def check_grads(dev, gen, results):
    """The training path's autograd Functions on the card against
    autograd of their plain versions, at the training shapes."""
    import torch.nn.functional as F

    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.ops import flash_prefill as fp

    m = 512
    out = {"binary_matmul_trainable": [], "flash_prefill_attention": []}
    for name, k, n in PROJ_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(-2**31, 2**31 - 1, (k // 32, n),
                               generator=gen, device=dev, dtype=torch.int32)
        gy = torch.randn((m, n), generator=gen, device=dev).to(
            torch.bfloat16)
        s0 = torch.tensor(0.003, device=dev)
        x1, s1 = x.clone().requires_grad_(), s0.clone().requires_grad_()
        x2, s2 = x.clone().requires_grad_(), s0.clone().requires_grad_()
        bg.binary_matmul_trainable(x1, packed, s1).backward(gy)
        bg.binary_matmul_plain(x2, packed, s2).to(x.dtype).backward(gy)
        torch.cuda.synchronize()
        dx_err, bad = grad_error(x1.grad, x2.grad, k)
        require(not bad, f"trainable {name}: {bad} rows of d_x off by more "
                         f"than 2^-7 of their max (max|err| {dx_err})")
        u = bg.binary_matmul_plain(x, packed, torch.ones_like(s0))
        mag = (gy.float() * u).abs().sum().item()
        ds_err = abs(s1.grad.item() - s2.grad.item())
        require(ds_err <= 1e-5 * mag, f"trainable {name}: d_scale off by "
                                      f"{ds_err} > 1e-5 * {mag}")
        out["binary_matmul_trainable"].append(
            {"proj": name, "d_x_max_abs_err": dx_err,
             "d_scale_abs_err": ds_err, "d_scale": s2.grad.item(),
             "d_scale_tol": 1e-5 * mag})
        del x, x1, x2, u, gy, packed
    bsz, s, h, kvh, hd, window = 4, 128, 32, 8, 128, 4096
    lengths = torch.tensor([128, 128, 128, 77], device=dev,
                           dtype=torch.int32)
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.randn((bsz, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).to(
            dtype)
        v = torch.randn((bsz, s, kvh, hd), generator=gen, device=dev).to(
            dtype)
        go = torch.randn((bsz, s, h * hd), generator=gen, device=dev).to(
            dtype)
        ins1 = [t.clone().requires_grad_() for t in (q, k, v)]
        ins2 = [t.clone().requires_grad_() for t in (q, k, v)]
        o1 = fp.flash_prefill_attention(*ins1, lengths, window=window)
        o2 = fp.flash_prefill_attention_plain(*ins2, lengths, window=window)
        o1.backward(go)
        o2.backward(go)
        torch.cuda.synchronize()
        rec = {"dtype": str(dtype).replace("torch.", "")}
        if dtype == torch.bfloat16:
            e, bad = attention_error(o1.detach(), o2.detach(), hd)
            require(not bad, f"flash prefill at the training shape: {bad} "
                             f"(row, head) outputs off by more than 2^-7 of "
                             f"their max (max|err| {e})")
        else:
            e = (o1 - o2).abs().max().item()
            require(e <= 1e-4, f"flash prefill fp32 at the training shape: "
                               f"max|err| {e} > 1e-4")
        rec["out_max_abs_err"] = e
        for label, a, b in zip(("dq", "dk", "dv"), ins1, ins2):
            require(not a.grad[3, 77:].any().item(),
                    f"flash prefill {label}: padding rows not zero")
            if dtype == torch.bfloat16:
                e, bad = grad_error(a.grad, b.grad, hd)
                require(not bad, f"flash prefill {label}: {bad} (row, head) "
                                 f"gradients off by more than 2^-7 of "
                                 f"their max (max|err| {e})")
            else:
                e = (a.grad - b.grad).abs().max().item()
                tol = 1e-4 * b.grad.abs().max().item()
                require(e <= tol, f"flash prefill {label} fp32: max|err| "
                                  f"{e} > {tol}")
            rec[f"{label}_max_abs_err"] = e
        out["flash_prefill_attention"].append(rec)
        if dtype == torch.bfloat16:
            # The forward at the training shape (full lengths), timed.
            full = torch.full((bsz,), s, device=dev, dtype=torch.int32)
            mask = fp.prefill_mask(s, s, full, window)
            kk, vv, m4 = _sdpa_inputs(q.transpose(1, 2), k, v, mask[:, None])
            q4 = q.transpose(1, 2).contiguous()
            row = time_wrapper(
                "flash prefill train shape",
                lambda i: fp.flash_prefill_attention(q, k, v, full,
                                                     window=window),
                1, (PREFILL_TC_KERNEL,),
                plain=lambda i: fp.flash_prefill_attention_plain(
                    q, k, v, full, window=window),
                library=lambda i: F.scaled_dot_product_attention(
                    q4, kk, vv, attn_mask=m4))
            nbytes = bsz * s * (h + 2 * kvh) * hd * 2 + bsz * s * h * hd * 2
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, 4 * hd * h * int(mask.sum()))
            out["flash_prefill_forward_train_shape"] = row
            del kk, vv, q4
        del q, k, v, go, ins1, ins2, o1, o2
    results["autograd"] = dict(
        out, tolerance="d_x and bf16 attention gradients: each row within "
                       "2^-7 of its own max|ref|; fp32 attention gradients: "
                       "1e-4 of the tensor's max|ref|; d_scale: 1e-5 of "
                       "sum |g * u|",
        shape="binary matmul: M=512 at the 7 projections, bf16; flash "
              "prefill: B=4 S=128 H=32 KV=8 hd=128 window 4096, lengths "
              "128, 128, 128, 77, bf16 and fp32",
        reference="autograd of the plain versions on the same inputs")


def kernel_checks(dev):
    gen = torch.Generator(device=dev).manual_seed(1234)
    results = {}
    for check in (check_pair, check_canonical,
                  functools.partial(check_fused, name="fused_tenant_matmul"),
                  functools.partial(check_fused,
                                    name="fused_base_pair_matmul"),
                  check_decode, check_decode_int8, check_decode_lengths,
                  check_w4, check_dense,
                  check_prefill, check_binary, check_binary_t, check_grads):
        check(dev, gen, results)
        torch.cuda.empty_cache()
    for name, res in results.items():
        emit({"kernel_check": name, **res})
    return results


# ---------------------------------------------------------------------------
# 4. The serving path end to end
# ---------------------------------------------------------------------------

# Phases 4 and 4b serve Mistral-7B cut to 16 of its 32 layers (depth only,
# to make room for phase 12b's checkpoint on disk).
SERVE_LAYERS = 16


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


def same_delta(a, b, label):
    """Require two CompressedModels to be equal, bit for bit."""
    for name, d in a.deltas.items():
        require(torch.equal(d.packed, b.deltas[name].packed)
                and torch.equal(d.scale, b.deltas[name].scale),
                f"{label}: delta {name} did not round-trip")
    for name, x in a.extras.items():
        require(torch.equal(x, b.extras[name]),
                f"{label}: extra {name} did not round-trip")


def build_world(cfg, dev, n_tenants=3, seed=0, base_quant=None,
                compress_embeddings=False, dtype=torch.bfloat16,
                keep_tenant=False):
    """The serving stack: a seeded base of ``dtype``, ``n_tenants``
    synthetic fine-tunes of it, one through the artifact I/O. With
    ``base_quant`` (``"int4"`` / ``"int8"``) the stack's base is
    ``quantize_base(base, base_quant)`` and the fine-tunes are compressed
    against ``roundtrip_base(base, base_quant)``, the dequantized base;
    the dense base and its round trip are freed before the stack is
    built. ``compress_embeddings``: the embed / lm_head become 1-bit
    deltas over the shared base embed / head. ``keep_tenant``: also
    return the artifact tenant's CompressedModel."""
    from bitdelta_torch.core.artifact import load_delta, save_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.llama import init_params
    from bitdelta_torch.research.quantized_base import (quantize_base,
                                                        roundtrip_base)
    from bitdelta_torch.serving.stacking import stack_tenants

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    base = init_params(cfg, gen, dtype=dtype, device=dev)
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    t0 = time.perf_counter()
    if base_quant is None:
        stack_base, against = base, base
    else:
        stack_base = quantize_base(base, base_quant)
        against = roundtrip_base(base, base_quant)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    tenants, t_comp = [], 0.0
    for _ in range(n_tenants):
        t0 = time.perf_counter()
        fine = synthetic_finetune(cfg, base, gen)
        tenants.append(compress_model(
            against, fine, compress_embeddings=compress_embeddings))
        del fine
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t_comp += time.perf_counter() - t0
    del base, against
    # One tenant through the artifact format and back, bit-exact.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "tenant0.safetensors")
        save_delta(path, tenants[0], cfg, base_quant=base_quant)
        size = Path(path).stat().st_size
        loaded, cfg_back, meta = load_delta(path, device=dev,
                                            return_meta=True)
    require(cfg_back == cfg, "artifact config did not round-trip")
    require(meta.get("base_quant") == base_quant,
            f"artifact base_quant {meta.get('base_quant')!r} != "
            f"{base_quant!r}")
    same_delta(tenants[0], loaded, "artifact")
    tenants[0] = loaded
    t_art = time.perf_counter() - t0
    stack = stack_tenants(cfg, stack_base, tenants, device=dev)
    kept = tenants[0]
    del tenants, stack_base
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "world", "layers": cfg.num_layers,
          "base_quant": base_quant, "dtype": str(dtype).replace("torch.", ""),
          "compress_embeddings": compress_embeddings, "base_init_s": t_base,
          "quantize_s": t_quant, "compress_s_per_tenant": t_comp / n_tenants,
          "artifact_bytes": size, "artifact_roundtrip_s": t_art,
          "peak_bytes": torch.cuda.max_memory_allocated()})
    return (stack, kept) if keep_tenant else stack


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


def serve(cfg, stack, dev, name, path="serving", kv_dtype=None, model=None,
          n_generate=12, max_new=32, kernel="cuda", http_rounds=1):
    """Serve ``stack`` over HTTP and through ``Engine.generate`` (the
    counted run of ``path``), then time prefill and one decode step.
    ``model``: the decoder module (llama by default); ``kernel``: the
    engine's route (``"cuda_fused"`` for the fused decode projections);
    ``http_rounds``: rounds of one request a tenant over HTTP (each gives
    a first-token time)."""
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.server import (ByteTokenizer, ServingApp,
                                               TenantInfo, make_http_server)
    from bitdelta_torch.serving.stacking import stack_nbytes

    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, stack, max_slots=8, max_seq=2048, decode_chunk=8,
                 prefill_buckets=(64, 128, 256, 512, 1024, 2048),
                 kernel=kernel, device=dev, kv_dtype=kv_dtype, model=model)
    model = eng.model
    del stack
    torch.cuda.empty_cache()
    if kv_dtype == "int8":
        require(eng.cache.k.dtype == torch.int8
                and eng.cache.v.dtype == torch.int8 and eng.cache.quantized,
                f"{path}: the cache is not int8")
    resident = torch.cuda.memory_allocated()
    mem = stack_nbytes(eng.stack)
    tok = ByteTokenizer()
    names = ["alpha", "beta", "gamma"][:eng.stack.num_tenants]
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
        for i, tenant in enumerate(names * http_rounds):
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
                and sum(line["done"] for line in lines) == len(names),
                "broadcast /generate did not answer from every tenant")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        app.close()
    prompts = [f"Batch prompt number {i} for the engine."
               for i in range(n_generate)]
    reqs = [Request(prompt_ids=tok.encode(p), tenant_id=i % len(names),
                    max_new_tokens=max_new) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    require(all(o is not None and len(o) <= max_new for o in outs),
            "Engine.generate returned a bad batch")
    require(all(0 <= t < vocab for o in outs for t in o),
            "Engine.generate produced out-of-vocab tokens")
    counts = read_counts()
    for kname in PATHS[path]:
        require(counts[kname] > 0,
                f"kernel {kname} was never launched on the {path} path")
    if "w4_matmul" in PATHS[path]:
        # Every decode step launches flash decode once a layer and the W4
        # kernel at each of a layer's 7 projections; prefill launches no
        # W4 kernel (it is int4_matmul, as in JAX).
        require(counts["w4_matmul"] == 7 * counts["flash_decode_attention"],
                f"{path}: {counts['w4_matmul']} W4 launches for "
                f"{counts['flash_decode_attention']} flash-decode launches "
                f"(want 7 per layer and step)")
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
    tids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], device=dev) % len(names)
    toks = torch.ones((8, 1), dtype=torch.int64, device=dev)
    cache = eng.cache

    def one_step():
        model.decode_step(cfg, eng.stack.params, toks, cache,
                          deltas=eng.stack.deltas, tenant_ids=tids,
                          kernel=kernel)

    with torch.no_grad():
        for _ in range(2):
            one_step()
        torch.cuda.synchronize()
        before = read_counts()
        one_step()
        per_step = {k: v - before[k] for k, v in read_counts().items()
                    if v - before[k]}
        # The projections' kernel: row 10 under the fused route, row 1
        # otherwise; a compressed (shared) head adds one row-1 launch.
        proj_kernel = ("fused_base_pair_matmul" if kernel == "cuda_fused"
                       else "tenant_delta_matmul_pair")
        head = 1 if "lm_head" in eng.stack.deltas else 0
        want = {proj_kernel: 7 * cfg.num_layers}
        want["tenant_delta_matmul_pair"] = want.get(
            "tenant_delta_matmul_pair", 0) + head
        require(all(per_step.get(k) == v for k, v in want.items()),
                f"{path}: {per_step} launches in one decode step, want "
                f"{want}")
        if "w4_matmul" in PATHS[path]:
            require(per_step.get("w4_matmul") == 7 * cfg.num_layers,
                    f"{path}: {per_step.get('w4_matmul')} W4 launches in one "
                    f"decode step, want {7 * cfg.num_layers}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 5
        for _ in range(steps):
            one_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        step_device_ms, step_top = device_breakdown(one_step,
                                                   "decode step", top=16)
    report.update(
        card=name, layers=cfg.num_layers, kernel=kernel,
        kv_dtype=kv_dtype or "bf16",
        cache_dtype=str(eng.cache.k.dtype).replace("torch.", ""),
        base_leaf=type(eng.stack.params["layers"]["q_proj"]).__name__,
        launches=counts, launches_per_decode_step=per_step,
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
    emit({"phase": path, **report})
    return counts, report


# ---------------------------------------------------------------------------
# 5. Whole step: kernels on the card vs plain versions on the CPU
# ---------------------------------------------------------------------------

def stack_to_cpu(stack):
    """A copy of a TenantStack with every tensor on the CPU."""
    from bitdelta_torch.serving.stacking import stack_to

    return stack_to(stack, "cpu")


PARITY_RUNS = (  # (label, base_quant, kv_dtype, kernel, compress_embeddings)
    ("bf16", None, None, "cuda", False),
    ("w4_int8_cache", "int4", "int8", "cuda", False),
    ("w8_bf16_cache", "int8", None, "cuda", False),
    ("bf16_embeddings_fused", None, None, "cuda_fused", True))


def parity(cfg_full, dev, label, base_quant, kv_dtype, kernel="cuda",
           compress_embeddings=False):
    import dataclasses

    from bitdelta_torch.models import llama
    from bitdelta_torch.serving.stacking import to_pair_layout

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    stack = to_pair_layout(build_world(
        cfg, dev, seed=7, base_quant=base_quant,
        compress_embeddings=compress_embeddings))
    cpu_stack = stack_to_cpu(stack)
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
                return_cache=True, cache_max_seq=64, kernel=kernel,
                kv_quant=kv_dtype == "int8")
            require(cache.k.dtype == (torch.int8 if kv_dtype == "int8"
                                      else torch.bfloat16),
                    f"parity {label}: cache dtype {cache.k.dtype}")
            step, _ = llama.decode_step(cfg, st.params, nxt.to(device), cache,
                                        deltas=st.deltas,
                                        tenant_ids=tids.to(device),
                                        kernel=kernel)
        return logits[0, :41].float().cpu(), step[0, 0].float().cpu()

    reset_counts()
    gpu_pre, gpu_step = run(stack, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    cpu_pre, cpu_step = run(cpu_stack, torch.device("cpu"))
    out = {"phase": "parity", "run": label, "base_quant": base_quant,
           "kv_dtype": kv_dtype or "bf16", "kernel": kernel,
           "compress_embeddings": compress_embeddings, "layers": 2,
           "launches": counts}
    for which, a, b in (("prefill", gpu_pre, cpu_pre),
                        ("decode", gpu_step, cpu_step)):
        require(torch.isfinite(a).all().item(),
                f"parity {label} {which} logits not finite")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
        out[which] = {"max_abs_err": err, "ref_max_abs": scale,
                      "rel_err": err / scale, "argmax_agreement": agree}
        # bf16 activations: the card and the CPU round each projection's
        # fp32 sum to bf16 after summing in different orders; 2 layers of
        # such rounding stay within 2% of the logit scale.
        require(err <= 2e-2 * scale,
                f"parity {label} {which} logits: max|err| {err} > 2% "
                f"of {scale}")
    want = PATHS["density" if base_quant == "int4" else
                 "fused" if kernel == "cuda_fused" else "serving"]
    for kname in want:
        require(counts[kname] > 0, f"parity {label} missed kernel {kname}")
    if base_quant == "int4":
        require(counts["w4_matmul"] == 7 * cfg.num_layers,
                f"parity {label}: {counts['w4_matmul']} W4 launches for one "
                f"decode step of {cfg.num_layers} layers")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 6. The training path end to end
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_LEN, TRAIN_STEPS, TRAIN_LR = 4, 128, 3, 1e-4


def batch_loss(cfg, base, fine, compressed, tokens):
    """The distillation loss on one batch, without a gradient (student on
    the kernel path, teacher on the plain path, as in training)."""
    from bitdelta_torch.core.compress import student_params
    from bitdelta_torch.models import llama

    with torch.no_grad():
        t = llama.forward(cfg, fine, tokens, kernel="torch")
        s = llama.forward(cfg, student_params(base, compressed), tokens,
                          deltas=compressed.deltas, kernel="cuda")
        return torch.mean((t - s).float() ** 2).item()


def train(cfg, dev):
    """Compress a synthetic full-width fine-tune, distill its scales for
    TRAIN_STEPS steps through the kernels, save and reload the result,
    then time one more step on the same inputs."""
    from bitdelta_torch.core.artifact import load_delta, save_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.llama import init_params
    from bitdelta_torch.train.data import synthetic_batches
    from bitdelta_torch.train.distill import (DistillConfig, distill_scales,
                                              make_distill_step,
                                              make_optimizer)

    gen = torch.Generator(device=dev).manual_seed(11)
    t0 = time.perf_counter()
    base = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    fine = synthetic_finetune(cfg, base, gen)
    comp = compress_model(base, fine)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    batches = synthetic_batches(cfg.vocab_size, TRAIN_STEPS, TRAIN_BATCH,
                                TRAIN_LEN, seed=0)
    dcfg = DistillConfig(lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                         compute_dtype="bfloat16", kernel="cuda")
    report = {"layers": cfg.num_layers, "batch": TRAIN_BATCH,
              "length": TRAIN_LEN, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
              "setup_s": setup_s}
    tokens = torch.from_numpy(batches[0]).long().to(dev)
    report["batch0_loss_before"] = batch_loss(cfg, base, fine, comp, tokens)
    with tempfile.TemporaryDirectory() as tmp:
        untrained = str(Path(tmp) / "diff_untrained.safetensors")
        save_delta(untrained, comp, cfg)
        report["artifact_bytes"] = Path(untrained).stat().st_size
        torch.cuda.synchronize()
        report["resident_bytes"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        distilled, losses = distill_scales(cfg, base, fine, comp, batches,
                                           dcfg)
        torch.cuda.synchronize()
        report["distill_s"] = time.perf_counter() - t0
        counts = read_counts()
        report["peak_bytes"] = torch.cuda.max_memory_allocated()
        report["losses"] = losses
        require(all(math.isfinite(x) for x in losses),
                f"distillation losses not finite: {losses}")
        for kname in PATHS["train"]:
            require(counts[kname] > 0,
                    f"kernel {kname} was never launched on the training path")
        moved = {}
        for name, d in distilled.deltas.items():
            before = comp.deltas[name].scale
            require(bool((d.scale != before).all()),
                    f"{name}: some layer's scale did not move")
            moved[name] = (d.scale - before).abs().max().item()
        report["max_scale_change"] = moved
        report["batch0_loss_after"] = batch_loss(cfg, base, fine, distilled,
                                                 tokens)
        path = str(Path(tmp) / "diff.safetensors")
        save_delta(path, distilled, cfg)
        back, cfg_back = load_delta(path, device=dev)
        require(cfg_back == cfg, "distilled artifact config did not "
                                 "round-trip")
        same_delta(distilled, back, "diff.safetensors")
        back, _ = load_delta(untrained, device=dev)
        same_delta(comp, back, "diff_untrained.safetensors")
        del back

    # One more step, after the counted run, on a fresh optimizer over the
    # distilled scales: wall time (no profiler), then its device time.
    scales = {n: d.scale.clone().requires_grad_()
              for n, d in distilled.deltas.items()}
    step = make_distill_step(cfg, dcfg, base, fine, comp, scales,
                             make_optimizer(scales, dcfg))
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(tokens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms, top = device_breakdown(lambda: step(tokens), "distill step",
                                   top=10)
    report.update(launches=counts, step_wall_ms=walls,
                  step_device_ms=dev_ms,
                  step_device_busy=dev_ms / min(walls),
                  step_top_kernels=top,
                  launches_per_step={k: v // TRAIN_STEPS
                                     for k, v in counts.items()})
    emit({"phase": "train", **report})
    return counts, report


# ---------------------------------------------------------------------------
# 7. One distillation step: kernels against the plain path
# ---------------------------------------------------------------------------

def train_parity(cfg_full, dev):
    """A 2-layer full-width fp32 model: the loss and every scale's
    gradient of one step with kernel="cuda" against kernel="torch".

    Tolerances: both paths run in fp32 and differ only in summation
    order (the binary matmuls add exact ±x terms in sequence instead of
    cuBLAS's fp32 GEMM; flash prefill's online softmax instead of the
    dense one; the attention backward is the blockwise recompute instead
    of autograd of the dense version). That moves each logit by about
    1e-6 of its size: the loss to within 1e-5 relative, each gradient to
    within 1e-3 of its projection's largest |gradient|."""
    import dataclasses

    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.llama import init_params
    from bitdelta_torch.train.data import synthetic_batches
    from bitdelta_torch.train.distill import (DistillConfig,
                                              make_distill_step,
                                              make_optimizer)

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(5)
    base = init_params(cfg, gen, dtype=torch.float32, device=dev)
    fine = synthetic_finetune(cfg, base, gen)
    comp = compress_model(base, fine)
    tokens = torch.from_numpy(synthetic_batches(
        cfg.vocab_size, 1, TRAIN_BATCH, TRAIN_LEN, seed=1)[0]).long().to(dev)
    runs = {}
    for kernel in ("cuda", "torch"):
        dcfg = DistillConfig(lr=TRAIN_LR, num_steps=TRAIN_STEPS,
                             compute_dtype="float32", kernel=kernel)
        scales = {n: d.scale.clone().requires_grad_()
                  for n, d in comp.deltas.items()}
        step = make_distill_step(cfg, dcfg, base, fine, comp, scales,
                                 make_optimizer(scales, dcfg))
        reset_counts()
        loss = step(tokens).item()
        torch.cuda.synchronize()
        runs[kernel] = (loss, {n: s.grad.clone() for n, s in scales.items()},
                        read_counts())
    (l_k, g_k, c_k), (l_p, g_p, c_p) = runs["cuda"], runs["torch"]
    for kname in PATHS["train"]:
        require(c_k[kname] > 0, f"train parity: kernel path missed {kname}")
    require(not any(c_p.values()), f"train parity: plain path launched "
                                   f"kernels {c_p}")
    rel = abs(l_k - l_p) / abs(l_p)
    require(math.isfinite(l_k) and rel <= 1e-5,
            f"train parity: loss {l_k} vs {l_p} (rel {rel} > 1e-5)")
    grads = {}
    for name, gp in g_p.items():
        err = (g_k[name] - gp).abs().max().item()
        scale = gp.abs().max().item()
        require(err <= 1e-3 * scale, f"train parity: {name} gradient off by "
                                     f"{err} > 1e-3 * {scale}")
        grads[name] = {"max_abs_err": err, "max_abs": scale,
                       "rel_err": err / scale}
    out = {"phase": "train_parity", "layers": 2, "dtype": "float32",
           "loss_cuda": l_k, "loss_torch": l_p, "loss_rel_err": rel,
           "grads": grads, "launches": c_k,
           "tolerance": "loss: 1e-5 relative; each scale gradient: 1e-3 of "
                        "its projection's max |gradient| (fp32 sums in "
                        "another order)"}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# 8. Mixtral-8x7B over a W8 base: canonical decode (row 7), pair layout,
#    and the engine over HTTP
# ---------------------------------------------------------------------------

MIX_TENANTS, MIX_NOISE = 2, 0.002
# Mixtral-8x7B cut to 16 of its 32 layers (depth only, to make room for
# phase 12b's checkpoint on disk): every projection and expert at its
# full width.
MIX_LAYERS = 16


def build_mixtral_world(cfg, dev, seed=21):
    """A W8 Mixtral serving stack of MIX_TENANTS synthetic fine-tunes,
    built one layer at a time on the card, so no dense bf16 base (93 GB at
    full size) ever exists: for each layer, seeded fp32 weights are
    quantized with ``quantize_int8`` into preallocated int8 stacks (the
    router stays dense bf16), and each tenant's fine-tune of that layer
    (the dequantized layer plus seeded fp32 noise) is compressed by
    ``compress_mixtral`` on the one-layer pytree into preallocated packed
    stacks. The deltas stay in the canonical layout."""
    from bitdelta_torch.core.delta import BinaryDelta
    from bitdelta_torch.models import mixtral as mx
    from bitdelta_torch.research.quantized_base import (Int8Weight,
                                                        dequantize_int8,
                                                        quantize_int8)
    from bitdelta_torch.serving.stacking import TenantStack

    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    L, T, E = cfg.num_layers, MIX_TENANTS, cfg.num_experts
    D, V = cfg.hidden_size, cfg.vocab_size
    shapes = {"q_proj": (D, cfg.q_dim), "k_proj": (D, cfg.kv_dim),
              "v_proj": (D, cfg.kv_dim), "o_proj": (cfg.q_dim, D),
              "w1": (D, cfg.intermediate_size),
              "w3": (D, cfg.intermediate_size),
              "w2": (cfg.intermediate_size, D)}

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    def noise(shape, scale=MIX_NOISE):
        return torch.randn(shape, generator=gen, device=dev) * scale

    layers, deltas = {}, {}
    for name, (k, n) in shapes.items():
        lead = (E,) if name in mx.EXPERT_MATS else ()
        layers[name] = Int8Weight(q=empty((L, *lead, k, n), torch.int8),
                                  scale=empty((L, *lead, n), torch.float32))
        deltas[name] = BinaryDelta(
            packed=empty((L, T, *lead, k // 32, n), torch.int32),
            scale=empty((L, T, *lead), torch.float32))
    layers["router"] = empty((L, D, E), torch.bfloat16)
    deltas["router"] = BinaryDelta(packed=empty((L, T, D // 32, E),
                                                torch.int32),
                                   scale=empty((L, T), torch.float32))
    for name in ("attn_norm", "mlp_norm"):
        layers[name] = empty((L, T, D), torch.bfloat16)
    # Per-tenant extras: the base's embed / head plus noise, in bf16.
    extras = {"embed": empty((T, V, D), torch.bfloat16),
              "lm_head": empty((T, D, V), torch.bfloat16),
              "final_norm": empty((T, D), torch.bfloat16)}
    for name, shape in (("embed", (V, D)), ("lm_head", (D, V))):
        base_w = noise(shape, 0.02).to(torch.bfloat16)
        for t in range(T):
            extras[name][t] = (base_w.float() + noise(shape)).to(
                torch.bfloat16)
        del base_w
    for t in range(T):
        extras["final_norm"][t] = (1.0 + noise((D,), 10 * MIX_NOISE)).to(
            torch.bfloat16)

    for layer in range(L):
        deq = {}
        for name, (k, n) in shapes.items():
            lead = (E,) if name in mx.EXPERT_MATS else ()
            dq = empty((1, *lead, k, n), torch.float32)
            q_dst = layers[name].q[layer].reshape(-1, k, n)
            s_dst = layers[name].scale[layer].reshape(-1, n)
            for e, mat in enumerate(dq.reshape(-1, k, n)):
                qw = quantize_int8(noise((k, n), 0.02))
                q_dst[e], s_dst[e] = qw.q, qw.scale
                mat.copy_(dequantize_int8(qw))
            deq[name] = dq
        router = noise((D, E), 0.02).to(torch.bfloat16)
        layers["router"][layer] = router
        deq["router"] = router.float()[None]
        for name in ("attn_norm", "mlp_norm"):
            deq[name] = torch.ones((1, D), device=dev)
        for t in range(T):
            fine = {"layers": {
                name: w + noise(w.shape, MIX_NOISE * (10 if "norm" in name
                                                      else 1))
                for name, w in deq.items()}}
            fine.update({n_: extras[n_][t] for n_ in extras})
            comp = mx.compress_mixtral({"layers": deq}, fine)
            for name, d in comp.deltas.items():
                deltas[name].packed[layer, t] = d.packed[0]
                deltas[name].scale[layer, t] = d.scale[0]
            for name in ("attn_norm", "mlp_norm"):
                layers[name][layer, t] = comp.extras[name][0].to(
                    torch.bfloat16)
            del fine, comp
        del deq
    params = {"layers": layers, **extras}
    stack = TenantStack(params=params, deltas=deltas,
                        vocab_sizes=torch.full((T,), V, dtype=torch.int32,
                                               device=dev),
                        num_tenants=T)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    return stack, {"build_s": time.perf_counter() - t0,
                   "build_peak_bytes": torch.cuda.max_memory_allocated(),
                   "resident_bytes": torch.cuda.memory_allocated()}


def tenant_artifact(stack, t):
    """Tenant ``t`` of a canonical stack as a CompressedModel (views)."""
    from bitdelta_torch.core.compress import CompressedModel
    from bitdelta_torch.core.delta import BinaryDelta

    deltas = {name: BinaryDelta(d.packed[:, t], d.scale[:, t])
              for name, d in stack.deltas.items()}
    p = stack.params
    extras = {"embed": p["embed"][t], "lm_head": p["lm_head"][t],
              "final_norm": p["final_norm"][t],
              "attn_norm": p["layers"]["attn_norm"][:, t],
              "mlp_norm": p["layers"]["mlp_norm"][:, t]}
    return CompressedModel(deltas=deltas, extras=extras)


class RouteRecorder:
    """Records every top-k routing choice of ``mixtral._route`` (as CPU
    tensors, in call order: one call per layer and forward)."""

    def __init__(self):
        from bitdelta_torch.models import mixtral as mx

        self.mx, self.orig, self.calls = mx, mx._route, []

    def __enter__(self):
        def record(logits, k):
            vals, idx = self.orig(logits, k)
            self.calls.append(idx.sort(dim=-1).values.cpu())
            return vals, idx
        self.mx._route = record
        return self

    def __exit__(self, *exc):
        self.mx._route = self.orig


def routing_agreement(a, b):
    """Per position (the leading dims of one call's ``(..., k)``), True
    where both runs chose the same expert set at every layer."""
    agree = None
    for x, y in zip(a, b):
        same = (x == y).all(dim=-1)
        agree = same if agree is None else agree & same
    return agree


def held_logits(got, want, agree, label, limit=2e-2):
    """Require |got - want| <= ``limit`` of the logit scale at the
    positions whose routing agrees (no bound with ``limit=None``);
    returns the numbers."""
    scale = want.abs().max().item()
    err = ((got - want).abs().amax(-1) * agree).max().item()
    require(torch.isfinite(got).all().item(), f"{label}: logits not finite")
    require(limit is None or err <= limit * scale,
            f"{label}: max|err| {err} > {limit} of {scale} at positions "
            f"whose routing agrees")
    return {"max_abs_err_agreeing": err, "ref_max_abs": scale,
            "rel_err": err / scale,
            "positions_agreeing": int(agree.sum()),
            "positions": int(agree.numel()),
            "max_abs_err_all": (got - want).abs().max().item()}


def mixtral_parity(cfg_full, dev):
    """A 2-layer full-width Mixtral (8 experts, W8 base, bf16 cache):
    prefill and canonical-decode logits with the kernels on the card
    against the plain path on the CPU. Top-2 routing flips where two
    router logits nearly tie and the card and the CPU round differently;
    a flip moves a token's MoE output far more than 2%. So the (position,
    layer) choices are compared, the logits are held to 2% of the logit
    scale at the positions whose routing agrees at every layer, and at
    least 95% of positions must agree."""
    import dataclasses

    from bitdelta_torch.models import mixtral as mx
    from bitdelta_torch.serving.stacking import to_pair_layout

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    stack, _ = build_mixtral_world(cfg, dev, seed=31)
    cpu_stack = stack_to_cpu(stack)
    g = torch.Generator().manual_seed(4)
    tokens = torch.randint(1, cfg.vocab_size, (2, 24), generator=g)
    tids = torch.tensor([0, 1])
    nxt = torch.tensor([[17], [5]])

    def run(st, device):
        with torch.no_grad(), RouteRecorder() as rec:
            logits, cache = mx.forward(
                cfg, st.params, tokens.to(device), deltas=st.deltas,
                tenant_ids=tids.to(device), return_cache=True,
                cache_max_seq=32, kernel="cuda")
            step, _ = mx.decode_step(cfg, st.params, nxt.to(device), cache,
                                     deltas=st.deltas,
                                     tenant_ids=tids.to(device),
                                     kernel="cuda")
        n = cfg.num_layers
        return (logits.float().cpu(), step.float().cpu(), rec.calls[:n],
                rec.calls[n:], cache)

    reset_counts()
    gpu = run(stack, dev)
    torch.cuda.synchronize()
    counts = read_counts()
    # The same decode step in the pair layout, on the card.
    to_pair_layout(stack, in_place=True)
    with torch.no_grad(), RouteRecorder() as rec:
        paired, _ = mx.decode_step(cfg, stack.params, nxt.to(dev), gpu[4],
                                   deltas=stack.deltas,
                                   tenant_ids=tids.to(dev), kernel="cuda")
    pair = held_logits(paired.float().cpu(), gpu[1],
                       routing_agreement(gpu[3], rec.calls).float(),
                       "mixtral parity: pair vs canonical decode")
    del stack, paired
    t0 = time.perf_counter()
    cpu = run(cpu_stack, torch.device("cpu"))
    cpu_s = time.perf_counter() - t0
    agree_pre = routing_agreement(gpu[2], cpu[2])          # (2, 24)
    agree_dec = routing_agreement(gpu[3], cpu[3])          # (2, 1)
    n_agree = int(agree_pre.sum() + agree_dec.sum())
    n_pos = agree_pre.numel() + agree_dec.numel()
    out = {"phase": "parity", "run": "mixtral_w8", "base_quant": "int8",
           "kv_dtype": "bf16", "layers": 2, "experts": cfg.num_experts,
           "launches": counts, "cpu_s": cpu_s,
           "routing_positions_agreeing": n_agree, "routing_positions": n_pos,
           "prefill": held_logits(gpu[0], cpu[0], agree_pre.float(),
                                  "mixtral parity prefill"),
           "decode": held_logits(gpu[1], cpu[1], agree_dec.float(),
                                 "mixtral parity decode"),
           "pair_vs_canonical_decode": pair}
    require(n_agree >= 0.95 * n_pos,
            f"mixtral parity: routing agrees at {n_agree} of {n_pos} "
            f"positions (< 95%)")
    for kname in PATHS["mixtral_canonical"]:
        require(counts[kname] > 0, f"mixtral parity missed kernel {kname}")
    require(counts["tenant_delta_matmul"] == 7 * cfg.num_layers,
            f"mixtral parity: {counts['tenant_delta_matmul']} canonical "
            f"delta launches for one decode step of {cfg.num_layers} layers")
    emit(out)
    return out


def w8_cast_ms(stack):
    """Device ms of one W8 expert stack's ``int8 -> bf16`` cast (what
    ``_expert_matmul`` does at every call): w1 of layer 0."""
    q = stack.params["layers"]["w1"].q[0]
    return device_ms(lambda i: q.to(torch.bfloat16), 1, "w8 cast",
                     iters=5)[0]


def mixtral(dev, name):
    """Phase 8: the full-width Mixtral-8x7B world at MIX_LAYERS layers,
    its artifact, the canonical decode (row 7), the pair layout, then the
    engine over HTTP."""
    import dataclasses

    from bitdelta_torch.core.artifact import load_delta, save_delta
    from bitdelta_torch.models import mixtral as mx
    from bitdelta_torch.serving.stacking import to_pair_layout

    cfg = dataclasses.replace(mx.mixtral_8x7b(), num_layers=MIX_LAYERS)
    free_before, total = torch.cuda.mem_get_info()
    stack, report = build_mixtral_world(cfg, dev)
    report.update(card=name, layers=cfg.num_layers,
                  experts=cfg.num_experts, tenants=MIX_TENANTS,
                  free_bytes_before=free_before, card_bytes=total)

    # Tenant 0 through the artifact format and back, bit-exact.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "mixtral_tenant0.safetensors")
        comp = tenant_artifact(stack, 0)
        save_delta(path, comp, cfg, base_quant="int8")
        report["artifact_bytes"] = Path(path).stat().st_size
        back, cfg_back, meta = load_delta(path, device="cpu",
                                          return_meta=True)
    require(isinstance(cfg_back, mx.MixtralConfig) and cfg_back == cfg,
            f"mixtral artifact config came back as {cfg_back!r}")
    require(meta.get("base_quant") == "int8", "mixtral artifact base_quant")
    for label, a, b in (("deltas", comp.deltas, back.deltas),
                        ("extras", comp.extras, back.extras)):
        for key, x in a.items():
            for f_a, f_b in zip(x if isinstance(x, tuple) else (x,),
                                b[key] if isinstance(x, tuple)
                                else (b[key],)):
                require(torch.equal(f_a.cpu(), f_b),
                        f"mixtral artifact {label}.{key} did not round-trip")
    del comp, back
    report["artifact_roundtrip_s"] = time.perf_counter() - t0

    # Canonical decode: prefill B=8 over both tenants, 3 decode steps.
    g = torch.Generator(device=dev).manual_seed(8)
    tids = torch.arange(8, device=dev) % MIX_TENANTS
    prompt = torch.randint(1, cfg.vocab_size, (8, 32), generator=g,
                           device=dev)
    toks = torch.randint(1, cfg.vocab_size, (8, 1), generator=g, device=dev)
    with torch.no_grad():
        t0 = time.perf_counter()
        _, cache0 = mx.forward(cfg, stack.params, prompt, deltas=stack.deltas,
                               tenant_ids=tids, return_cache=True,
                               cache_max_seq=64, kernel="cuda")
        torch.cuda.synchronize()
        report["canonical_prefill_b8_s32_ms"] = (time.perf_counter()
                                                 - t0) * 1e3
        reset_counts()
        with RouteRecorder() as rec:
            first, cache = mx.decode_step(cfg, stack.params, toks, cache0,
                                          deltas=stack.deltas,
                                          tenant_ids=tids, kernel="cuda")
        route_canon = rec.calls
        after_first = read_counts()
        for _ in range(2):
            _, cache = mx.decode_step(cfg, stack.params, toks, cache,
                                      deltas=stack.deltas, tenant_ids=tids,
                                      kernel="cuda")
        torch.cuda.synchronize()
        canon_counts = read_counts()
        require(after_first["tenant_delta_matmul"] == 7 * cfg.num_layers,
                f"canonical decode: {after_first['tenant_delta_matmul']} row-7 "
                f"launches in one step, want {7 * cfg.num_layers}")
        require(canon_counts["tenant_delta_matmul"]
                == 3 * 7 * cfg.num_layers,
                f"canonical decode: {canon_counts['tenant_delta_matmul']} "
                f"row-7 launches in 3 steps")
        for kname in PATHS["mixtral_canonical"]:
            require(canon_counts[kname] > 0,
                    f"kernel {kname} was never launched on the canonical "
                    f"Mixtral decode")
        require(torch.isfinite(first).all().item(),
                "canonical decode logits not finite")

        def canon_step():
            mx.decode_step(cfg, stack.params, toks, cache0,
                           deltas=stack.deltas, tenant_ids=tids,
                           kernel="cuda")

        canon_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        canon_step()
        torch.cuda.synchronize()
        report["canonical_step_ms_b8"] = (time.perf_counter() - t0) * 1e3
        report["canonical_step_device_ms"], report[
            "canonical_step_top_kernels"] = device_breakdown(
            canon_step, "mixtral canonical decode step", top=10)
        report["w8_cast_ms_per_expert_stack"] = w8_cast_ms(stack)
        report["w8_casts_per_step"] = 3 * cfg.num_layers

        # The same canonical step in fp32 (lm_head widened for the dense
        # head kernel, which takes one dtype), for the layout comparison
        # below without bf16's rounding noise.
        p32 = dict(stack.params, lm_head=stack.params["lm_head"].float())
        _, cache32 = mx.forward(cfg, p32, prompt, deltas=stack.deltas,
                                tenant_ids=tids, compute_dtype=torch.float32,
                                return_cache=True, cache_max_seq=64,
                                kernel="cuda")
        with RouteRecorder() as rec:
            canon32, _ = mx.decode_step(cfg, p32, toks, cache32,
                                        deltas=stack.deltas, tenant_ids=tids,
                                        compute_dtype=torch.float32,
                                        kernel="cuda")
        route32 = rec.calls

        # The pair layout in place, then the same steps on the same caches.
        t0 = time.perf_counter()
        to_pair_layout(stack, in_place=True)
        torch.cuda.synchronize()
        report["pair_convert_s"] = time.perf_counter() - t0
        report["after_pair_bytes"] = torch.cuda.memory_allocated()
        reset_counts()
        with RouteRecorder() as rec:
            paired, _ = mx.decode_step(cfg, stack.params, toks, cache0,
                                       deltas=stack.deltas, tenant_ids=tids,
                                       kernel="cuda")
        torch.cuda.synchronize()
        pair_counts = read_counts()
        route_pair = rec.calls
        with RouteRecorder() as rec:
            pair32, _ = mx.decode_step(cfg, p32, toks, cache32,
                                       deltas=stack.deltas, tenant_ids=tids,
                                       compute_dtype=torch.float32,
                                       kernel="cuda")
    require(pair_counts["tenant_delta_matmul_pair"] == 7 * cfg.num_layers
            and pair_counts["tenant_delta_matmul"] == 0,
            f"pair decode launches {pair_counts}: want "
            f"{7 * cfg.num_layers} of row 1 and none of row 7")
    # Two x grids (the pair kernel's 12-bit per-row one, row 7's 14-bit
    # global one) of one function. In bf16 every layer rounds each
    # projection once, and over 16 layers the grids' one-ulp differences
    # grow as the card's and the CPU's do; that distance is recorded. In
    # fp32 the layouts are held to 2% of the logit scale at the rows
    # whose routing agrees at every layer (at least 6 of 8).
    agree = routing_agreement(route_canon, route_pair)[:, 0]  # (8,)
    report["pair_vs_canonical_bf16"] = held_logits(
        paired[:, 0].float(), first[:, 0].float(), agree.to(dev).float(),
        "pair vs canonical decode, bf16", limit=None)
    # How far bf16 alone moves the same canonical step over 16 layers.
    report["canonical_bf16_vs_fp32"] = held_logits(
        first[:, 0].float(), canon32[:, 0],
        routing_agreement(route_canon, route32)[:, 0].to(dev).float(),
        "canonical decode, bf16 vs fp32", limit=None)
    agree32 = routing_agreement(route32, rec.calls)[:, 0]
    report["pair_vs_canonical_fp32"] = held_logits(
        pair32[:, 0], canon32[:, 0], agree32.to(dev).float(),
        "pair vs canonical decode, fp32")
    require(int(agree32.sum()) >= 6, f"pair vs canonical (fp32): routing "
                                     f"agrees on only {int(agree32.sum())} "
                                     f"of 8 rows")
    report.update(canonical_launches=canon_counts,
                  canonical_launches_first_step=after_first,
                  pair_step_launches=pair_counts)
    del cache0, cache, first, paired, cache32, canon32, pair32, p32
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "mixtral_world", **report})
    counts, served = serve(cfg, stack, dev, name, path="mixtral", model=mx,
                           n_generate=8, max_new=16)
    del stack
    served["w8_cast_share_of_step"] = (
        report["w8_casts_per_step"] * report["w8_cast_ms_per_expert_stack"]
        / served["decode_step_device_ms"])
    served["build"] = report
    return canon_counts, counts, served


# ---------------------------------------------------------------------------
# 9. The fused route: Mistral-7B with compressed embeddings, rows 9 and 10
# ---------------------------------------------------------------------------

FUSED_PPL_WINDOWS = 3          # windows of 1024 + 512 tokens
FUSED_PPL_RTOL = 1e-2


def _want_step_counts(layers, layout, kernel):
    """Launches of one B=8 decode step of a compressed-embedding Mistral
    stack: the projections' kernel 7 a layer, the head delta's once."""
    head = "tenant_delta_matmul_pair" if layout == "pair" \
        else "tenant_delta_matmul"
    if kernel == "cuda_fused":
        proj = ("fused_base_pair_matmul" if layout == "pair"
                else "fused_tenant_matmul")
        return {proj: 7 * layers, head: 1, "flash_decode_attention": layers}
    return {head: 7 * layers + 1, "flash_decode_attention": layers}


def fused_step_parity(cfg_full, dev):
    """A 2-layer full-width fp32 model with compressed embeddings: the
    B=8 decode step under ``kernel="cuda_fused"`` against the same step
    under ``"cuda"`` on the card, canonical layout, then pair layout.

    Limits: the pair route's fused kernel (row 10) shares row 1's integer
    sums and epilogue with the unfused step and differs only in the order
    of the base's fp32 sums: 1e-3 of the logit scale. The canonical
    route's unfused step puts x on row 7's one 14-bit grid (each value
    moves by up to max|x| * 2^-15) where row 9 adds x exactly: 2e-3 of
    the logit scale, the limit of JAX's kernel-dispatch tests."""
    import dataclasses

    from bitdelta_torch.models import llama
    from bitdelta_torch.serving.stacking import to_pair_layout

    cfg = dataclasses.replace(cfg_full, num_layers=2)
    stack = build_world(cfg, dev, seed=13, compress_embeddings=True,
                        dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(6)
    tids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (8, 24), generator=g,
                           device=dev)
    toks = torch.randint(1, cfg.vocab_size, (8, 1), generator=g, device=dev)
    out = {"phase": "parity", "run": "fused_vs_unfused_fp32", "layers": 2,
           "dtype": "float32", "compress_embeddings": True}
    with torch.no_grad():
        _, cache0 = llama.forward(cfg, stack.params, prompt,
                                  deltas=stack.deltas, tenant_ids=tids,
                                  compute_dtype=torch.float32,
                                  return_cache=True, cache_max_seq=32,
                                  kernel="cuda")
        for layout, limit in (("canonical", 2e-3), ("pair", 1e-3)):
            if layout == "pair":
                to_pair_layout(stack, in_place=True)
            steps = {}
            for kernel in ("cuda", "cuda_fused"):
                reset_counts()
                logits, _ = llama.decode_step(
                    cfg, stack.params, toks, cache0, deltas=stack.deltas,
                    tenant_ids=tids, compute_dtype=torch.float32,
                    kernel=kernel)
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counts().items() if v}
                want = _want_step_counts(cfg.num_layers, layout, kernel)
                require(counts == want, f"fused parity {layout} {kernel}: "
                                        f"launches {counts}, want {want}")
                steps[kernel] = logits[:, 0].float()
            out[layout] = held_logits(
                steps["cuda_fused"], steps["cuda"],
                torch.ones(8, device=dev), f"fused parity {layout} (fp32)",
                limit=limit)
            out[layout]["limit"] = limit
    emit(out)
    return out


def fused(dev, name):
    """Phase 9: a 32-layer full-width Mistral-7B whose three fine-tunes
    are compressed with their embeddings; the B=8 decode step on both
    routes and both layouts; the fused engine over HTTP; then perplexity
    of one tenant densely fused and through its deltas."""
    from bitdelta_torch.core.compress import fuse_compressed, student_params
    from bitdelta_torch.eval.ppl import eval_ppl
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import mistral_7b
    from bitdelta_torch.ops import binary_gemm as bg
    from bitdelta_torch.serving.stacking import stack_nbytes, to_pair_layout

    import numpy as np

    cfg = mistral_7b()
    stack, tenant0 = build_world(cfg, dev, seed=41, compress_embeddings=True,
                                 keep_tenant=True)
    d32, vocab = cfg.hidden_size // 32, cfg.vocab_size
    require(stack.params["embed"].ndim == 2
            and tuple(stack.deltas["embed"].packed.shape) == (3, d32, vocab)
            and tuple(stack.deltas["lm_head"].packed.shape) == (3, d32, vocab),
            "fused world: the embed / head deltas are not stacked "
            "tenant-first over a shared base")
    report = {"card": name, "layers": cfg.num_layers, "tenants": 3,
              "stack_bytes": stack_nbytes(stack),
              "resident_bytes": torch.cuda.memory_allocated()}
    g = torch.Generator(device=dev).manual_seed(9)
    tids = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], device=dev)
    prompt = torch.randint(1, vocab, (8, 32), generator=g, device=dev)
    toks = torch.randint(1, vocab, (8, 1), generator=g, device=dev)
    step_counts = {}
    with torch.no_grad():
        _, cache0 = llama.forward(cfg, stack.params, prompt,
                                  deltas=stack.deltas, tenant_ids=tids,
                                  return_cache=True, cache_max_seq=64,
                                  kernel="cuda")
        for layout in ("canonical", "pair"):
            if layout == "pair":
                t0 = time.perf_counter()
                to_pair_layout(stack, in_place=True)
                torch.cuda.synchronize()
                report["pair_convert_s"] = time.perf_counter() - t0
            logits = {}
            for kernel in ("cuda", "cuda_fused"):
                def step(kernel=kernel):
                    return llama.decode_step(
                        cfg, stack.params, toks, cache0, deltas=stack.deltas,
                        tenant_ids=tids, kernel=kernel)[0]

                step()
                torch.cuda.synchronize()
                reset_counts()
                tc0 = bg.fused_tenant_tc_launched()
                logits[kernel] = step()[:, 0].float()
                torch.cuda.synchronize()
                counts = {k: v for k, v in read_counts().items() if v}
                want = _want_step_counts(cfg.num_layers, layout, kernel)
                require(counts == want, f"{layout} {kernel} decode step: "
                                        f"launches {counts}, want {want}")
                step_counts[(layout, kernel)] = read_counts()
                # Row 9's projections on its tensor-core kernel alone: one
                # launch each (the library's count), and no CUDA-core
                # kernel of row 9 in the step's trace.
                row9 = (layout, kernel) == ("canonical", "cuda_fused")
                tc = bg.fused_tenant_tc_launched() - tc0
                want_tc = 7 * cfg.num_layers if row9 else 0
                require(tc == want_tc, f"{layout} {kernel} decode step: "
                                       f"{tc} launches of "
                                       f"{FUSED_TENANT_TC_KERNEL}, want "
                                       f"{want_tc}")
                t0 = time.perf_counter()
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / 3
                dev_ms, top = device_breakdown(
                    step, f"fused phase {layout} {kernel} step", top=None)
                if row9:
                    syms = [r["kernel"] for r in top]
                    stray = [sym for sym in syms if any(
                        re.search(rf"(?<!\w){kn}\b", sym)
                        for kn in FUSED_TENANT_FP32_KERNELS)]
                    require(any(FUSED_TENANT_TC_KERNEL in sym
                                for sym in syms) and not stray,
                            f"{layout} {kernel} decode step: the trace holds "
                            f"{stray}, want {FUSED_TENANT_TC_KERNEL} alone "
                            "for row 9")
                report[f"{layout}_{kernel}_step"] = {
                    "launches": counts, "wall_ms_b8": wall,
                    "device_ms": dev_ms, "device_busy": dev_ms / wall,
                    "fused_tenant_tc_launches": tc, "top_kernels": top[:10]}
            # bf16 over 32 layers: recorded (the 2-layer runs hold limits).
            report[f"{layout}_fused_vs_unfused_bf16"] = held_logits(
                logits["cuda_fused"], logits["cuda"],
                torch.ones(8, device=dev),
                f"{layout} fused vs unfused step", limit=None)
    del cache0
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "fused_pair_steps", "layout": "pair", **{
        f"{kernel}_step": {key: report[f"pair_{kernel}_step"][key]
                           for key in ("device_ms", "wall_ms_b8",
                                       "top_kernels")}
        for kernel in ("cuda", "cuda_fused")}})
    emit({"phase": "fused_world", **report})
    base = {"embed": stack.params["embed"],
            "lm_head": stack.params["lm_head"],
            "layers": {n: stack.params["layers"][n]
                       for n in llama.PROJ_NAMES}}
    serve_counts, served = serve(cfg, stack, dev, name, path="fused",
                                 kernel="cuda_fused")
    del stack
    gc.collect()
    torch.cuda.empty_cache()

    # Perplexity of tenant 0: dense fused weights, then its deltas.
    tokens = np.random.default_rng(17).integers(
        0, vocab, 1024 + 512 * FUSED_PPL_WINDOWS)
    ppl = {"windows": FUSED_PPL_WINDOWS, "context": 1024, "window": 512,
           "tokens": int(tokens.size)}
    t0 = time.perf_counter()
    dense = fuse_compressed(base, tenant0)
    torch.cuda.synchronize()
    ppl["fuse_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl["dense"] = eval_ppl(cfg, dense, tokens, kernel="cuda")
    ppl["dense_s"] = time.perf_counter() - t0
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ppl["deltas"] = eval_ppl(cfg, student_params(base, tenant0), tokens,
                             deltas=tenant0.deltas, kernel="cuda")
    ppl["deltas_s"] = time.perf_counter() - t0
    rel = abs(ppl["deltas"] - ppl["dense"]) / ppl["dense"]
    ppl.update(rel_diff=rel, tolerance=FUSED_PPL_RTOL)
    require(all(math.isfinite(ppl[k]) and ppl[k] > 1.0
                for k in ("dense", "deltas")), f"perplexity {ppl}")
    # The dense weights are bf16(base + scale * sign); the delta path adds
    # scale * (x @ sign) to the base's fp32 sums: the two differ by bf16
    # rounding of the fused weights only.
    require(rel <= FUSED_PPL_RTOL, f"perplexity dense {ppl['dense']} vs "
                                   f"deltas {ppl['deltas']}: rel {rel} > "
                                   f"{FUSED_PPL_RTOL}")
    served["ppl"] = ppl
    served["world"] = report
    emit({"phase": "fused_ppl", **ppl})
    del base, tenant0
    gc.collect()
    torch.cuda.empty_cache()
    return step_counts[("canonical", "cuda_fused")], serve_counts, served


# ---------------------------------------------------------------------------
# 10. The entry points: checkpoints on disk through the CLIs
# ---------------------------------------------------------------------------

CLI_LAYERS = 4               # Mistral-7B's full width at 4 layers
CLI_MIXTRAL_LAYERS = 2       # Mixtral-8x7B's full width at 2 layers
CLI_PPL_RTOL = 3e-3          # the CLI's dense-fused PPL vs the deltas'
# The base alone (a CLI that ignored --model_diff) must score at least this
# many tolerances away from the deltas' PPL, or the check above could not
# tell the two apart.
CLI_PPL_MARGIN = 4
CLI_GPTQ_LIMIT = 2e-2        # W4 (GPTQ) step vs its dense dequantized base
# The kernels each CLI run must launch (phase 10's paths).
CLI_PATHS = {
    "train": PATHS["train"],
    "serve": ("tenant_delta_matmul_pair", "flash_decode_attention",
              "tenant_dense_matmul", "flash_prefill_attention",
              "binary_matmul"),
    "serve_fused": ("fused_base_pair_matmul", "flash_decode_attention",
                    "tenant_dense_matmul", "flash_prefill_attention",
                    "binary_matmul"),
    "mixtral_train": ("binary_matmul", "binary_matmul_t"),
    "mixtral_serve": PATHS["mixtral"],
}
def write_hf_checkpoint(cfg, params, out_dir, shards=2):
    """``params`` (the port's layout, on the card) as an HF checkpoint:
    ``config.json`` and ``shards`` BF16 safetensors files, both from the
    port's exporter (``core/export.py``: HF's names and ``(out, in)``
    layout, transposed on the card) and written by the port's writer, the
    layers split evenly over the shards. Returns the bytes written."""
    from bitdelta_torch.core.artifact import write_safetensors
    from bitdelta_torch.core.export import hf_config_dict, hf_state_dict

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True)
    (out_dir / "config.json").write_text(
        json.dumps(hf_config_dict(cfg, dtype=torch.bfloat16)))
    sd = hf_state_dict(cfg, params, dtype=torch.bfloat16)
    per = -(-cfg.num_layers // shards)

    def shard(key):
        m = re.match(r"model\.layers\.(\d+)\.", key)
        if m:
            return int(m.group(1)) // per
        return 0 if key == "model.embed_tokens.weight" else shards - 1

    for s in range(shards):
        write_safetensors(str(out_dir / f"model-{s + 1:05d}-of-"
                                        f"{shards:05d}.safetensors"),
                          {k: v for k, v in sd.items() if shard(k) == s},
                          {"format": "pt"})
    del sd
    return sum(f.stat().st_size for f in out_dir.glob("*.safetensors"))


def write_gptq_checkpoint(cfg, out_dir, gen, dev, group=128):
    """A symmetric AutoGPTQ checkpoint of ``cfg``'s shape (every zero point
    8, contiguous groups of ``group`` rows) from seeded draws: random
    nibbles, fp16 scales near 0.004, fp16 embed / norms / head."""
    from bitdelta_torch.core.artifact import write_safetensors
    from bitdelta_torch.core.export import HF_NAMES, hf_config_dict

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True)
    (out_dir / "config.json").write_text(
        json.dumps(hf_config_dict(cfg, dtype=torch.float16)))
    dims = {"q_proj": (cfg.hidden_size, cfg.q_dim),
            "k_proj": (cfg.hidden_size, cfg.kv_dim),
            "v_proj": (cfg.hidden_size, cfg.kv_dim),
            "o_proj": (cfg.q_dim, cfg.hidden_size),
            "gate_proj": (cfg.hidden_size, cfg.intermediate_size),
            "up_proj": (cfg.hidden_size, cfg.intermediate_size),
            "down_proj": (cfg.intermediate_size, cfg.hidden_size)}

    def f16(*shape, scale=0.02, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                + shift).to(torch.float16).cpu()

    t = {"model.embed_tokens.weight": f16(cfg.vocab_size, cfg.hidden_size),
         "model.norm.weight": f16(cfg.hidden_size, shift=1.0),
         "lm_head.weight": f16(cfg.vocab_size, cfg.hidden_size)}
    for layer in range(cfg.num_layers):
        pre = f"model.layers.{layer}"
        t[f"{pre}.input_layernorm.weight"] = f16(cfg.hidden_size, shift=1.0)
        t[f"{pre}.post_attention_layernorm.weight"] = f16(cfg.hidden_size,
                                                          shift=1.0)
        for name, (k, n) in dims.items():
            q = f"{pre}.{HF_NAMES[name][0]}"
            t[f"{q}.qweight"] = torch.randint(
                -2**31, 2**31 - 1, (k // 8, n), generator=gen, device=dev,
                dtype=torch.int32).cpu()
            t[f"{q}.qzeros"] = torch.full((k // group, n // 8), 0x77777777,
                                          dtype=torch.int32)
            t[f"{q}.scales"] = (torch.rand((k // group, n), generator=gen,
                                           device=dev) * 0.002
                                + 0.003).to(torch.float16).cpu()
            t[f"{q}.g_idx"] = (torch.arange(k, dtype=torch.int32) // group)
    write_safetensors(str(out_dir / "model.safetensors"), t,
                      {"format": "pt"})
    return sum(v.numel() * v.element_size() for v in t.values())


def seeded_corpus(path, n_words, seed):
    import numpy as np

    words = ("the of and to in is was for on as with by at from that "
             "model delta base tenant scale weight token layer sign bit "
             "serve train eval card memory kernel").split()
    rng = np.random.default_rng(seed)
    text = " ".join(words[i] for i in rng.integers(0, len(words), n_words))
    Path(path).write_text(text)


class CliCounts:
    """Launch counts summed over the CLI runs of phase 10 (each run reset
    just before and read just after; the checks between runs launch
    outside them)."""

    def __init__(self):
        self.total = dict.fromkeys(KERNELS, 0)
        self.by_run = {}

    def run(self, label, fn, want=()):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        for k, v in counts.items():
            self.total[k] += v
        self.by_run[label] = {k: v for k, v in counts.items() if v}
        for kname in want:
            require(counts[kname] > 0,
                    f"cli {label}: kernel {kname} was never launched")
        return out, seconds


def run_cli(main, argv):
    """``main(argv)`` in this process with its standard output captured
    (and echoed, shortened, to ours)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = main(argv)
    out = buf.getvalue()
    tail = out if len(out) < 4000 else out[:1500] + "\n...\n" + out[-2000:]
    print(tail, end="" if tail.endswith("\n") else "\n", flush=True)
    return ret, out


def smoke_lines(out, tenants, label):
    """The NDJSON lines of a ``--smoke_test`` run, checked well formed:
    every line's keys, ids in the vocabulary, each tenant done once."""
    require("[smoke ok]" in out, f"{label}: no [smoke ok]")
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    require(lines and all(set(line) == {"tenant", "token_id", "text",
                                        "done"} for line in lines),
            f"{label}: malformed NDJSON")
    require(sorted(line["tenant"] for line in lines if line["done"])
            == sorted(tenants), f"{label}: not every tenant finished")
    return {t: [line["token_id"] for line in lines if line["tenant"] == t]
            for t in tenants}


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_subprocess(base_dir, deltas, report):
    """``python -m bitdelta_torch.cli.serve`` in its own process: wait for
    its "serving" line, POST one broadcast ``/generate``, time the first
    NDJSON line, and terminate it. Fails if it exits on its own."""
    import os
    import queue

    port = free_port()
    repo = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "bitdelta_torch.cli.serve", "--base_model",
           base_dir, "--host", "127.0.0.1", "--port", str(port),
           "--max_seq", "1024"]
    for name, path in deltas.items():
        cmd += ["--delta", f"{name}={path}"]
    env = dict(os.environ, PYTHONPATH=str(repo))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(repo), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    log = []
    try:
        deadline = time.perf_counter() + 600
        while True:
            require(time.perf_counter() < deadline,
                    "serve subprocess: no 'serving' line in 600 s")
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                require(proc.poll() is None,
                        f"serve subprocess exited with {proc.returncode}: "
                        + "".join(log[-20:]))
                continue
            log.append(line)
            if line.startswith("serving "):
                break
        report["subprocess_ready_s"] = time.perf_counter() - t0
        url = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(url + "/models", timeout=60) as r:
            require(json.loads(r.read()) == {"models": list(deltas)},
                    "serve subprocess: /models answered wrongly")
        got, first_s, total_s = _post(url, {"prompt": "Hello from the card",
                                            "max_new_tokens": 8})
        require({line["tenant"] for line in got} == set(deltas)
                and sum(line["done"] for line in got) == len(deltas),
                "serve subprocess: the broadcast did not answer from every "
                "tenant")
        require(proc.poll() is None, "serve subprocess exited on its own")
        report["subprocess_first_token_ms"] = first_s * 1e3
        report["subprocess_broadcast_s"] = total_s
        report["subprocess_log"] = [line.rstrip() for line in log
                                    if not line.startswith("{")][-8:]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        reader.join(timeout=10)


@contextlib.contextmanager
def without_module(mod):
    """Make ``import mod`` fail inside the block, as on a machine without
    it, whatever this one has installed."""
    had, old = mod in sys.modules, sys.modules.get(mod)
    sys.modules[mod] = None
    try:
        yield
    finally:
        if had:
            sys.modules[mod] = old
        else:
            del sys.modules[mod]


def cli(dev, name):
    """Phase 10: full-width Mistral-7B (CLI_LAYERS layers) and Mixtral-8x7B
    (CLI_MIXTRAL_LAYERS) checkpoints written to disk and driven through
    the port's train, serve and eval CLIs; the export round trip; a GPTQ
    checkpoint through ``load_gptq_params`` and one decode step."""
    import dataclasses
    import shutil

    from bitdelta_torch.cli.eval_ppl import main as eval_main
    from bitdelta_torch.cli.serve import main as serve_main
    from bitdelta_torch.cli.train import main as train_main
    from bitdelta_torch.core.artifact import load_delta
    from bitdelta_torch.core.compress import (compress_model,
                                              fuse_compressed,
                                              student_params)
    from bitdelta_torch.eval.ppl import eval_ppl, tokenize_corpus
    from bitdelta_torch.models import llama, mixtral
    from bitdelta_torch.models.config import mistral_7b
    from bitdelta_torch.models.hf_import import load_hf_config, \
        load_hf_params
    from bitdelta_torch.models.quant_import import load_gptq_params
    from bitdelta_torch.research.quantized_base import Int4Weight
    from bitdelta_torch.serving.server import ByteTokenizer
    from bitdelta_torch.serving.stacking import stack_tenants

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tmp_root = tempfile.gettempdir()
    usage = shutil.disk_usage(tmp_root)
    report = {"card": name, "tmp": tmp_root,
              "disk_free_gb": usage.free / 1e9,
              "disk_total_gb": usage.total / 1e9}
    emit({"phase": "cli_disk", **report})
    counts = CliCounts()
    cfg = dataclasses.replace(mistral_7b(), num_layers=CLI_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(51)
    # The checkpoints carry no tokenizer files: every CLI here takes the
    # byte-level fallback, as on a machine without transformers (an
    # installed transformers may build a tokenizer from config.json alone).
    with tempfile.TemporaryDirectory() as tmp, without_module("transformers"):
        tmp = Path(tmp)
        base_dir, fine_dir = str(tmp / "base"), str(tmp / "fine")
        out = tmp / "out"
        # The checkpoints: seeded base, fine-tune = base + seeded noise.
        t0 = time.perf_counter()
        params = llama.init_params(cfg, gen, dtype=torch.bfloat16,
                                   device=dev)
        ckpt_bytes = write_hf_checkpoint(cfg, params, base_dir)
        fine = synthetic_finetune(cfg, params, gen)
        write_hf_checkpoint(cfg, fine, fine_dir)
        del params, fine
        torch.cuda.empty_cache()
        report["write_checkpoints_s"] = time.perf_counter() - t0
        report["checkpoint_bytes"] = ckpt_bytes
        require(load_hf_config(base_dir) == cfg,
                "config.json did not load as the Mistral config")

        # The import alone, timed (the files were just written, so they
        # are read from the page cache).
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, base = load_hf_params(base_dir, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        report["load_hf_params_s"] = load_s
        report["load_hf_params_gb_s"] = ckpt_bytes / load_s / 1e9
        _, fine = load_hf_params(fine_dir, dtype=torch.bfloat16, device=dev)
        want_untrained = compress_model(base, fine)
        del fine
        torch.cuda.empty_cache()

        # Train CLI.
        argv = ["--base_model", base_dir, "--finetuned_model", fine_dir,
                "--save_dir", str(out), "--num_steps", "3",
                "--batch_size", "4", "--max_length", "128",
                "--dataset_name", "synthetic", "--checkpoint_every", "2",
                "--debug", "--save_full_model"]
        _, report["train_cli_s"] = counts.run(
            "train", lambda: run_cli(train_main, argv), CLI_PATHS["train"])
        shutil.rmtree(fine_dir)
        for f in ("diff.safetensors", "diff_untrained.safetensors",
                  "distill_ckpt.safetensors", "corr_stddev.csv",
                  "train_loss.json", "calibrated_model/model.safetensors"):
            require((out / f).exists(), f"train CLI wrote no {f}")
        losses = json.loads((out / "train_loss.json").read_text())
        require(len(losses) == 3 and all(math.isfinite(x) for x in losses),
                f"train CLI losses {losses}")
        report["train_losses"] = losses
        untrained, _ = load_delta(str(out / "diff_untrained.safetensors"),
                                  device=dev)
        for pname, d in want_untrained.deltas.items():
            require(torch.equal(untrained.deltas[pname].packed, d.packed),
                    f"diff_untrained {pname}: packed words differ from "
                    "compress_model's")
        del want_untrained

        # Export round trip: calibrated_model/ == fuse_compressed(base, diff).
        diff, _ = load_delta(str(out / "diff.safetensors"), device=dev)
        want = fuse_compressed(base, diff)
        _, got = load_hf_params(str(out / "calibrated_model"),
                                dtype=torch.bfloat16, device=dev)
        for key in ("embed", "final_norm", "lm_head"):
            require(torch.equal(got[key], want[key]),
                    f"export round trip: {key} differs")
        for lname, w in want["layers"].items():
            require(torch.equal(got["layers"][lname], w),
                    f"export round trip: {lname} differs")
        del got, want
        shutil.rmtree(out / "calibrated_model")
        torch.cuda.empty_cache()
        deltas = {"tuned": str(out / "diff.safetensors"),
                  "untrained": str(out / "diff_untrained.safetensors")}

        # Serve CLI in this process, on both routes.
        serve_argv = ["--base_model", base_dir, "--max_seq", "1024",
                      "--smoke_test"]
        for tname, path in deltas.items():
            serve_argv += ["--delta", f"{tname}={path}"]
        for kernel, label in (("cuda", "serve"), ("cuda_fused",
                                                  "serve_fused")):
            (_, text), report[f"{label}_cli_s"] = counts.run(
                label, lambda: run_cli(serve_main,
                                       serve_argv + ["--kernel", kernel]),
                CLI_PATHS[label])
            report[f"{label}_tokens"] = smoke_lines(text, list(deltas),
                                                    label)
        # ... and as its own process over HTTP (not counted: another
        # process's launches).
        serve_subprocess(base_dir, deltas, report)

        # Eval CLI on the byte tokenizer, against the library's PPL
        # through the deltas on the card.
        corpus = str(tmp / "corpus.txt")
        seeded_corpus(corpus, 700, seed=52)
        ppl_argv = ["--base_model", base_dir, "--model_diff",
                    deltas["tuned"], "--text_file", corpus,
                    "--context_size", "1024", "--window_size", "512",
                    "--save_dir", str(out)]
        (ppl_cli, text), report["eval_cli_s"] = counts.run(
            "eval", lambda: run_cli(eval_main, ppl_argv))
        require("using byte-level fallback" in text,
                "eval CLI: not on the byte-level tokenizer")
        tokens = tokenize_corpus(ByteTokenizer(), [Path(corpus).read_text()])
        ppl_lib = eval_ppl(cfg, student_params(base, diff), tokens,
                           deltas=diff.deltas, kernel="cuda")
        ppl_base = eval_ppl(cfg, base, tokens, kernel="cuda")
        rel = abs(ppl_cli - ppl_lib) / ppl_lib
        base_rel = abs(ppl_base - ppl_lib) / ppl_lib
        report["ppl"] = {"cli_dense": ppl_cli, "library_deltas": ppl_lib,
                         "rel_diff": rel, "tolerance": CLI_PPL_RTOL,
                         "base_only": ppl_base, "base_rel_diff": base_rel,
                         "tokens": int(tokens.size)}
        require(math.isfinite(ppl_cli) and rel <= CLI_PPL_RTOL,
                f"eval CLI PPL {ppl_cli} vs library {ppl_lib}: rel {rel}")
        require(base_rel >= CLI_PPL_MARGIN * CLI_PPL_RTOL,
                f"base-only PPL {ppl_base} is within {base_rel} of the "
                f"deltas' {ppl_lib}: the CLI check cannot tell a CLI that "
                "ignored --model_diff")
        del base
        shutil.rmtree(base_dir)
        torch.cuda.empty_cache()

        # GPTQ: a symmetric group-128 checkpoint of the same shape, one B=8
        # decode step under the tuned tenant's deltas (the W4 kernel at
        # every projection) against its dense dequantized base.
        gptq_dir = str(tmp / "gptq")
        write_gptq_checkpoint(cfg, gptq_dir, gen, dev)
        _, w4 = load_gptq_params(gptq_dir, device=dev)
        require(all(isinstance(w4["layers"][p], Int4Weight)
                    for p in llama.PROJ_NAMES),
                "load_gptq_params: not every projection is an Int4Weight")
        _, dense = load_gptq_params(gptq_dir, native=False, device=dev)
        shutil.rmtree(gptq_dir)
        tids = torch.zeros(8, dtype=torch.int64, device=dev)
        toks = torch.randint(1, cfg.vocab_size, (8, 1), generator=gen,
                             device=dev)
        logits = {}
        for label, p in (("w4", w4), ("dense", dense)):
            stack = stack_tenants(cfg, p, [diff], device=dev)
            cache = llama.init_cache(cfg, 8, 64, torch.bfloat16, dev)

            def step():
                with torch.no_grad():
                    return llama.decode_step(
                        cfg, stack.params, toks, cache, deltas=stack.deltas,
                        tenant_ids=tids, kernel="cuda")[0][:, 0].float()

            if label == "w4":
                logits[label], _ = counts.run("gptq_step", step)
                n_w4 = counts.by_run["gptq_step"].get("w4_matmul", 0)
                require(n_w4 == 7 * cfg.num_layers,
                        f"GPTQ decode step: {n_w4} W4 launches, want "
                        f"{7 * cfg.num_layers}")
            else:
                logits[label] = step()
            del stack, cache
        err = (logits["w4"] - logits["dense"]).abs().max().item()
        scale = logits["dense"].abs().max().item()
        report["gptq"] = {"w4_launches": n_w4, "max_abs_err": err,
                          "logit_scale": scale, "limit": CLI_GPTQ_LIMIT}
        require(math.isfinite(err) and err <= CLI_GPTQ_LIMIT * scale,
                f"GPTQ step: max|err| {err} > {CLI_GPTQ_LIMIT} of {scale}")
        del w4, dense, diff, untrained, logits
        shutil.rmtree(out)
        gc.collect()
        torch.cuda.empty_cache()

        # Mixtral-8x7B: train, serve and eval CLIs.
        mcfg = dataclasses.replace(mixtral.mixtral_8x7b(),
                                   num_layers=CLI_MIXTRAL_LAYERS)
        mbase, mfine = str(tmp / "mx_base"), str(tmp / "mx_fine")
        mout = tmp / "mx_out"
        t0 = time.perf_counter()
        params = mixtral.init_params(mcfg, gen, dtype=torch.bfloat16,
                                     device=dev)
        report["mixtral_checkpoint_bytes"] = write_hf_checkpoint(
            mcfg, params, mbase)
        fine = synthetic_finetune(mcfg, params, gen)
        del params
        write_hf_checkpoint(mcfg, fine, mfine)
        del fine
        gc.collect()
        torch.cuda.empty_cache()
        report["mixtral_write_checkpoints_s"] = time.perf_counter() - t0
        require(load_hf_config(mbase) == mcfg,
                "config.json did not load as the Mixtral config")
        argv = ["--base_model", mbase, "--finetuned_model", mfine,
                "--save_dir", str(mout), "--num_steps", "2",
                "--batch_size", "4", "--max_length", "128",
                "--dataset_name", "synthetic", "--debug"]
        _, report["mixtral_train_cli_s"] = counts.run(
            "mixtral_train", lambda: run_cli(train_main, argv),
            CLI_PATHS["mixtral_train"])
        shutil.rmtree(mfine)
        losses = json.loads((mout / "train_loss.json").read_text())
        require(len(losses) == 2 and all(math.isfinite(x) for x in losses),
                f"Mixtral train CLI losses {losses}")
        report["mixtral_train_losses"] = losses
        # Every scale (attention, each expert, router) took a gradient
        # step: AdamW's first steps move a scale by about lr (1e-4); weight
        # decay alone would move it by about 1e-9.
        before, _ = load_delta(str(mout / "diff_untrained.safetensors"),
                               device=dev)
        after, _ = load_delta(str(mout / "diff.safetensors"), device=dev)
        least = {}
        for pname, d in after.deltas.items():
            least[pname] = (d.scale - before.deltas[pname].scale).abs().min(
            ).item()
            require(least[pname] > 1e-6,
                    f"Mixtral train CLI: a {pname} scale moved only "
                    f"{least[pname]} (no gradient reached it)")
        report["mixtral_least_scale_move"] = least
        del before, after
        gc.collect()
        torch.cuda.empty_cache()
        margv = ["--base_model", mbase, "--max_seq", "256", "--smoke_test",
                 "--delta", f"moe={mout / 'diff.safetensors'}",
                 "--delta", f"moe_untrained={mout / 'diff_untrained.safetensors'}"]
        (_, text), report["mixtral_serve_cli_s"] = counts.run(
            "mixtral_serve", lambda: run_cli(serve_main, margv),
            CLI_PATHS["mixtral_serve"])
        report["mixtral_serve_tokens"] = smoke_lines(
            text, ["moe", "moe_untrained"], "mixtral serve")
        gc.collect()
        torch.cuda.empty_cache()
        mppl_argv = ["--base_model", mbase, "--model_diff",
                     str(mout / "diff.safetensors"), "--text_file", corpus,
                     "--context_size", "1024", "--window_size", "512",
                     "--save_dir", str(mout)]
        (mppl, _), report["mixtral_eval_cli_s"] = counts.run(
            "mixtral_eval", lambda: run_cli(eval_main, mppl_argv))
        require(math.isfinite(mppl) and mppl > 1.0,
                f"Mixtral eval CLI PPL {mppl}")
        report["ppl"]["mixtral_cli_dense"] = mppl
    gc.collect()
    torch.cuda.empty_cache()
    report["launches_by_run"] = counts.by_run
    report["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "cli", "seconds": report["seconds"],
          "load_hf_params_gb_s": report["load_hf_params_gb_s"],
          "first_token_ms": report["subprocess_first_token_ms"],
          "ppl": report["ppl"], "launches": counts.by_run})
    emit({"phase": "cli_detail", **report})
    return counts.total, report


# ---------------------------------------------------------------------------
# 11. The rest: the serving check, a reference artifact converted at
#     Llama-2-7B's full width, and the delta-fidelity variants there
# ---------------------------------------------------------------------------

# The kernel rows the serving check launches: the pair delta, flash
# decode, flash prefill, the binary matmul (the W4 half's single-request
# prefill), the W4 matmul and the fused pair kernel ("cuda_fused"); the
# canonical tenant delta and the fused canonical kernel at k/v_proj (N =
# 128 does not pair, so those leaves keep the canonical layout); the
# dense head in the W4 half (its tenant's head is not compressed; the
# two-tenant half shares a compressed head). Every row but the training
# path's transposed binary matmul.
CHECK_KERNELS = ("tenant_delta_matmul_pair", "flash_decode_attention",
                 "flash_prefill_attention", "binary_matmul", "w4_matmul",
                 "fused_base_pair_matmul", "tenant_delta_matmul",
                 "fused_tenant_matmul", "tenant_dense_matmul")
# Llama-2-7B's B=8 prefill and decode through the engine's pair stack.
LLAMA_KERNELS = ("tenant_delta_matmul_pair", "flash_decode_attention",
                 "tenant_dense_matmul", "flash_prefill_attention")
# eval_ppl of the fused variants (row 4) and of the binary deltas (row 5).
VARIANT_KERNELS = ("flash_prefill_attention", "binary_matmul")
REST_LAYERS = 2
VARIANTS = (("binary", {}), ("binary_median", {}),
            ("ternary", {"fraction": 0.5}), ("lora", {"rank": 16}),
            ("column", {}))
VARIANT_PPL_WINDOWS = 2

def rest_check(smi):
    """11a: ``serving_compiled_check()`` on the card."""
    from bitdelta_torch.utils.compiled_check import serving_compiled_check

    reset_counts()
    t0 = time.perf_counter()
    out = serving_compiled_check(log=lambda msg: print(msg, flush=True))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    require(out["status"] == "ok", f"serving check: {out}")
    for kname in CHECK_KERNELS:
        require(counts[kname] > 0, f"serving check missed kernel {kname}")
    emit({"phase": "rest_check", "card": smi, "status": out["status"],
          "tokens": out["tokens"], "w4_tokens": out["w4_tokens"],
          "seconds": seconds,
          "rows_moved": sorted(k for k, v in counts.items() if v),
          "launches": counts})
    return counts


def reference_diff_dict(cfg, base, fine):
    """A reference-format ``diff.pt`` dict (the reference's ``save_diff``:
    ``{name}.mask`` packed int32 and ``{name}.coeff`` per projection, plus
    the student's trainable tensors under HF's names) from the port's
    ``(K, N)`` params, with the semantics tests/test_convert_reference.py
    builds from transformers models: per projection the fp32 diff of the
    transposed HF weight (the port's layout), ``coeff = mean |diff|``,
    ``mask`` the ``diff >= 0`` bits packed along K, LSB-first. Computed
    where the params lie, returned on the CPU."""
    from bitdelta_torch.models.llama import PROJ_NAMES

    out = {}
    shifts = torch.arange(32, device=base["embed"].device).view(1, 32, 1)
    for i in range(cfg.num_layers):
        for proj in PROJ_NAMES:
            mod = "mlp" if proj in ("gate_proj", "up_proj",
                                    "down_proj") else "self_attn"
            diff = (fine["layers"][proj][i].float()
                    - base["layers"][proj][i].float())          # (K, N)
            k, n = diff.shape
            bits = (diff >= 0).to(torch.int64).view(k // 32, 32, n)
            name = f"model.layers.{i}.{mod}.{proj}"
            out[f"{name}.mask"] = (bits << shifts).sum(1).to(
                torch.int32).cpu()
            out[f"{name}.coeff"] = diff.abs().mean().cpu()
            del diff, bits
        out[f"model.layers.{i}.input_layernorm.weight"] = \
            fine["layers"]["attn_norm"][i].cpu()
        out[f"model.layers.{i}.post_attention_layernorm.weight"] = \
            fine["layers"]["mlp_norm"][i].cpu()
    out["model.embed_tokens.weight"] = fine["embed"].cpu()
    out["model.norm.weight"] = fine["final_norm"].cpu()
    out["lm_head.weight"] = fine["lm_head"].t().contiguous().cpu()
    return out


def convert_subprocess(diff_pt, out_path):
    """``python -m bitdelta_torch.tools.convert_reference`` in its own
    process (on the card, its default device)."""
    import os

    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    proc = subprocess.run(
        [sys.executable, "-m", "bitdelta_torch.tools.convert_reference",
         str(diff_pt), str(out_path)], cwd=str(repo), env=env,
        capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0 and f"wrote {out_path}" in proc.stdout,
            f"convert_reference exited with {proc.returncode}: "
            f"{proc.stdout[-2000:]} {proc.stderr[-2000:]}")


def rest_llama(cfg, dev, smi, base, fine):
    """11b: the fine-tune through a reference ``diff.pt`` and the converter
    CLI; its words against ``compress_model``'s; the artifact served by
    ``Engine(kernel="cuda")``: a B=8 prefill and decode step on the
    engine's stack against the same steps on the CPU with the plain
    versions, then ``generate``."""
    from bitdelta_torch.core.artifact import load_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.stacking import stack_tenants

    report = {"phase": "rest_llama", "card": smi, "model": "llama2_7b",
              "layers": cfg.num_layers, "hidden": cfg.hidden_size,
              "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads}
    reset_counts()
    t0 = time.perf_counter()
    ref = reference_diff_dict(cfg, base, fine)
    report["reference_dict_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        diff_pt = Path(tmp) / "diff.pt"
        out_path = Path(tmp) / "diff.safetensors"
        torch.save(ref, diff_pt)
        report["diff_pt_bytes"] = diff_pt.stat().st_size
        del ref
        t0 = time.perf_counter()
        convert_subprocess(diff_pt, out_path)
        report["convert_cli_s"] = time.perf_counter() - t0
        report["artifact_bytes"] = out_path.stat().st_size
        comp, _ = load_delta(str(out_path), device=dev)
    ours = compress_model(base, fine)
    worst = 0.0
    for name, d in ours.deltas.items():
        got = comp.deltas[name]
        require(torch.equal(got.packed, d.packed),
                f"converted {name}: packed words differ from "
                "compress_model's")
        rel = ((got.scale - d.scale).abs() / d.scale.abs()).max().item()
        worst = max(worst, rel)
        require(rel <= 1e-5, f"converted {name}: scale rel err {rel} > 1e-5")
    for name, x in ours.extras.items():
        require(torch.equal(comp.extras[name], x),
                f"converted extra {name} differs from the fine-tune's")
    report["words_bit_exact"] = True
    report["scale_max_rel_err"] = worst
    del ours

    stack = stack_tenants(cfg, base, [comp], device=dev)
    eng = Engine(cfg, stack, max_slots=8, max_seq=64, prefill_buckets=(16,),
                 kernel="cuda", device=dev)
    del stack, comp
    g = torch.Generator().manual_seed(11)
    tokens = torch.randint(1, cfg.vocab_size, (8, 16), generator=g)
    lengths = torch.tensor([16, 9, 12, 5, 16, 7, 11, 14], dtype=torch.int32)
    tids = torch.zeros(8, dtype=torch.int64)
    nxt = torch.randint(1, cfg.vocab_size, (8, 1), generator=g)

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
        last = logits[torch.arange(8, device=device),
                      lengths.to(device).long() - 1]
        return last.float().cpu(), step[:, 0].float().cpu()

    t0 = time.perf_counter()
    card_pre, card_step = run(eng.stack, dev)
    torch.cuda.synchronize()
    report["card_steps_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_pre, cpu_step = run(stack_to_cpu(eng.stack), torch.device("cpu"))
    report["cpu_steps_s"] = time.perf_counter() - t0
    for which, a, b in (("prefill", card_pre, cpu_pre),
                        ("decode", card_step, cpu_step)):
        require(torch.isfinite(a).all().item(),
                f"llama2_7b {which} logits not finite")
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        report[which] = {"max_abs_err": err, "ref_max_abs": scale,
                         "rel_err": err / scale,
                         "argmax_agreement": (a.argmax(-1) == b.argmax(-1))
                         .float().mean().item()}
        # bf16 activations, sums in other orders: as phase 5, 2% of the
        # logit scale over 2 layers.
        require(err <= 2e-2 * scale, f"llama2_7b {which} logits: max|err| "
                                     f"{err} > 2% of {scale}")
    t0 = time.perf_counter()
    outs = eng.generate([Request(prompt_ids=tokens[b, :int(lengths[b])]
                                 .tolist(), tenant_id=0, max_new_tokens=4)
                         for b in range(8)])
    torch.cuda.synchronize()
    report["generate_s"] = time.perf_counter() - t0
    require([len(o) for o in outs] == [4] * 8
            and all(0 <= t < cfg.vocab_size for o in outs for t in o),
            f"llama2_7b generate: {outs}")
    report["generated"] = [list(map(int, o)) for o in outs]
    counts = read_counts()
    for kname in LLAMA_KERNELS:
        require(counts[kname] > 0, f"llama2_7b missed kernel {kname}")
    report["launches"] = counts
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    emit(report)
    return counts


def _proj_errors(fused, fine):
    """mean |W - W_fine| of each projection."""
    from bitdelta_torch.models.llama import PROJ_NAMES

    return {name: (fused["layers"][name].float()
                   - fine["layers"][name].float()).abs().mean().item()
            for name in PROJ_NAMES}


def rest_variants(cfg, dev, smi, base, fine):
    """11c: ``fuse_variant_model`` of every kind at full width; each fused
    model closer to the fine-tune than the base at every projection and
    ``column`` no worse than ``binary``; one gate_proj's median scale and
    ternary planes against the CPU's; each model's perplexity through
    ``kernel="cuda"``."""
    import numpy as np

    from bitdelta_torch.core.compress import compress_model, student_params
    from bitdelta_torch.eval.ppl import eval_ppl
    from bitdelta_torch.research import variants as rv

    report = {"phase": "rest_variants", "card": smi, "model": "llama2_7b",
              "layers": cfg.num_layers}
    # One gate_proj (4096 x 11008, 45,088,768 elements: above 2^24) on the
    # card and on the CPU.
    b0, f0 = base["layers"]["gate_proj"][0], fine["layers"]["gate_proj"][0]
    t0 = time.perf_counter()
    med = rv.quantize_ternary(b0, f0, binary_median=True)
    med_cpu = rv.quantize_ternary(b0.cpu(), f0.cpu(), binary_median=True)
    require(med.scale.item() == med_cpu.scale.item(),
            f"binary_median scale {med.scale.item()} on the card != "
            f"{med_cpu.scale.item()} on the CPU")
    ter = rv.quantize_ternary(b0, f0, fraction=0.5)
    ter_cpu = rv.quantize_ternary(b0.cpu(), f0.cpu(), fraction=0.5)
    require(torch.equal(ter.plus.cpu(), ter_cpu.plus)
            and torch.equal(ter.minus.cpu(), ter_cpu.minus),
            "ternary planes of gate_proj differ between the card and the CPU")
    report["gate_proj_card_vs_cpu"] = {
        "median_scale": med.scale.item(), "ternary_planes_equal": True,
        "ternary_scale": ter.scale.item(),
        "ternary_scale_cpu": ter_cpu.scale.item(),
        "seconds": time.perf_counter() - t0}
    del med, med_cpu, ter, ter_cpu

    diff = f0.float() - b0.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.linalg.svd(diff, full_matrices=False, driver="gesvd")
    torch.cuda.synchronize()
    report["svd_s_per_4096x11008_fp32"] = time.perf_counter() - t0
    del diff

    tokens = np.random.default_rng(23).integers(
        0, cfg.vocab_size, 1024 + 512 * VARIANT_PPL_WINDOWS)
    ppl_kw = dict(context_size=1024, window_size=512, kernel="cuda")
    reset_counts()
    report["ppl"] = {"base": eval_ppl(cfg, base, tokens, **ppl_kw),
                     "finetune": eval_ppl(cfg, fine, tokens, **ppl_kw)}
    report["mean_abs_err"] = {"base": _proj_errors(base, fine)}
    report["seconds"] = {}
    for kind, kw in VARIANTS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = rv.fuse_variant_model(base, fine, kind, **kw)
        torch.cuda.synchronize()
        report["seconds"][kind] = time.perf_counter() - t0
        err = _proj_errors(fused, fine)
        report["mean_abs_err"][kind] = err
        base_err = report["mean_abs_err"]["base"]
        for name, e in err.items():
            require(e < base_err[name],
                    f"{kind} {name}: mean|W - W_fine| {e} not below the "
                    f"base's {base_err[name]}")
        report["ppl"][kind] = eval_ppl(cfg, fused, tokens, **ppl_kw)
        del fused
        gc.collect()
        torch.cuda.empty_cache()
    for name, e in report["mean_abs_err"]["column"].items():
        b = report["mean_abs_err"]["binary"][name]
        require(e <= b, f"column {name}: {e} above binary's {b}")
    # The binary deltas unfused (rows 4 and 5), within 1% of the dense
    # fusion's perplexity, as phase 9 holds them.
    comp = compress_model(base, fine)
    report["ppl"]["binary_deltas"] = eval_ppl(
        cfg, student_params(base, comp), tokens, deltas=comp.deltas,
        **ppl_kw)
    del comp
    rel = (abs(report["ppl"]["binary_deltas"] - report["ppl"]["binary"])
           / report["ppl"]["binary"])
    require(rel <= FUSED_PPL_RTOL, f"binary PPL dense "
                                   f"{report['ppl']['binary']} vs deltas "
                                   f"{report['ppl']['binary_deltas']}")
    require(all(math.isfinite(p) and p > 1.0
                for p in report["ppl"].values()), f"PPL {report['ppl']}")
    torch.cuda.synchronize()
    counts = read_counts()
    for kname in VARIANT_KERNELS:
        require(counts[kname] > 0, f"variants missed kernel {kname}")
    report["launches"] = counts
    emit(report)
    return counts


def rest(dev, smi):
    """Phase 11: the serving check, then Llama-2-7B (full width, 2
    layers: 32 query and 32 KV heads, so rows 2 and 4 run at one query
    head a KV head) through a converted reference artifact and the
    variants. Returns the launches of the three sub-phases summed."""
    import dataclasses

    from bitdelta_torch.models.config import llama2_7b
    from bitdelta_torch.models.llama import init_params

    t_phase = time.perf_counter()
    counts = [rest_check(smi)]
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(llama2_7b(), num_layers=REST_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(51)
    base = init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    fine = synthetic_finetune(cfg, base, gen)
    counts.append(rest_llama(cfg, dev, smi, base, fine))
    counts.append(rest_variants(cfg, dev, smi, base, fine))
    del base, fine
    gc.collect()
    torch.cuda.empty_cache()
    total = {k: sum(c[k] for c in counts) for k in KERNELS}
    emit({"phase": "rest", "card": smi,
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in total.items() if v}})
    return total


# ---------------------------------------------------------------------------
# 12. Tensor and data parallelism: two ranks on the one card
# ---------------------------------------------------------------------------

TP_RANKS = 2
TP_LAYERS = 2                  # Llama-2-70B cut to 2 layers (depth only)
# What a 12b rank's host resident set may grow by over its load and first
# engine beyond the largest checkpoint tensor (a block of it at a time is
# read): libraries and buffers. The reading was 0.32 GB on the H100's
# machine; a memmap left resident (about 2.3 GB of a rank's pages) or
# the blocks kept on the host (its 2.97 GB shard) pass 0.5 GB, not this.
HOST_SLACK_BYTES = int(0.5e9)
TP_COLLECTIVE_TIMEOUT_S = 300  # a rank waiting longer on a peer fails
TP_PHASE_TIMEOUT_S = 900       # the parent kills ranks still running then
# The rows every rank of 12a must launch (all but 6, the training path).
TP_TINY_KERNELS = tuple(k for k in KERNELS if k != "binary_matmul_t")
TP_70B_KERNELS = ("tenant_delta_matmul_pair", "flash_decode_attention",
                  "tenant_dense_matmul", "flash_prefill_attention",
                  "binary_matmul", "fused_base_pair_matmul")


def _mesh_tokens(eng, requests):
    """Greedy tokens of a meshed engine: rank 0 generates while the other
    ranks follow; every rank returns rank 0's tokens."""
    from bitdelta_torch.parallel.collectives import broadcast_object

    out = None
    if eng.rank != 0:
        eng.follow()
    else:
        try:
            out = [list(map(int, o)) for o in eng.generate(requests)]
        finally:
            eng.stop_followers()
    return broadcast_object(out)


@contextlib.contextmanager
def counted(into):
    """Count the kernel launches of the block alone and add them to
    ``into``: the meshed runs of phase 12, apart from their single-process
    references."""
    reset_counts()
    try:
        yield
    finally:
        for name, n in read_counts().items():
            into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def sampled_logits(into):
    """Record the logits every engine samples from in the block (the
    prefill's last positions, then each decode step; ``(B, V)`` fp32,
    the vocabulary mask applied) into the list ``into``."""
    from bitdelta_torch.serving import engine as engine_mod

    real = engine_mod.sample_tokens

    def recording(gen, logits, *args):
        into.append(logits.detach().float().cpu())
        return real(gen, logits, *args)

    engine_mod.sample_tokens = recording
    try:
        yield
    finally:
        engine_mod.sample_tokens = real


def held_generate_logits(got, want, limit, label):
    """The meshed engine's sampled logits (``got``, one ``(B, V)`` a call)
    against the single-process engine's (``want``), call by call: each
    row within ``limit`` of the call's logit scale until its greedy token
    differs, which it may only at a near tie, where the single-process
    top-2 gap is within twice the row's measured error; that row is not
    compared after. Returns the readings."""
    diverged = {}
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        live = torch.isfinite(w)
        require(torch.equal(live, torch.isfinite(g)),
                f"{label} call {i}: the vocabulary masks differ")
        scale = w[live].abs().max().item()
        for b in range(w.shape[0]):
            if b in diverged:
                continue
            wb, gb = w[b][live[b]], g[b][live[b]]
            err = (gb - wb).abs().max().item()
            require(err <= limit * scale,
                    f"{label} call {i} row {b}: max|err| {err} > "
                    f"{limit} x {scale}")
            worst = max(worst, err / scale)
            if int(gb.argmax()) != int(wb.argmax()):
                top = wb.topk(2).values
                gap = (top[0] - top[1]).item()
                require(gap <= 2 * err,
                        f"{label} call {i} row {b}: greedy token differs "
                        f"at a top-2 gap of {gap}, beyond twice the "
                        f"measured error {err}")
                diverged[b] = {"call": i, "row": b, "top2_gap": gap,
                               "max_abs_err": err, "scale": scale}
    require(len(got) == len(want) or diverged,
            f"{label}: {len(got)} sampled calls against {len(want)}")
    require(len(got) > 1, f"{label}: no decode step was recorded")
    return {"calls": min(len(got), len(want)), "max_rel_err": worst,
            "near_ties": list(diverged.values())}


def tp_mixtral_stack(dev):
    """12a's Mixtral world: 2 layers, hidden 256, 4 experts, fp32, two
    seeded fine-tunes. At tp=2 the experts' w1/w3 (local N 128) keep the
    canonical layout (row 7) and w2 pairs with per-shard colsums (row 1)."""
    from bitdelta_torch.models import mixtral
    from bitdelta_torch.serving.stacking import stack_tenants

    cfg = mixtral.MixtralConfig(vocab_size=128, hidden_size=256,
                                intermediate_size=256, num_layers=2,
                                num_heads=4, num_kv_heads=2, max_seq_len=64,
                                num_experts=4, experts_per_token=2,
                                dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(61)
    base = mixtral.init_params(cfg, gen, scale=0.25, device=dev)
    tenants = []
    for _ in range(2):
        fine = dict(base)
        fine["layers"] = {k: v + 0.05 * torch.randn(v.shape, generator=gen,
                                                    device=dev)
                          for k, v in base["layers"].items()}
        tenants.append(mixtral.compress_mixtral(base, fine))
    return cfg, stack_tenants(cfg, base, tenants, device=dev)


def write_tp_tiny_worlds(root, dev):
    """12a's W8 and W4 worlds on disk: the serving check's base (2 KV
    heads) as an HF checkpoint (bf16, by the port's exporter) and, for
    each of ``int8`` and ``int4``, two tenants' artifacts taken against
    the round trip of the base read back (their ``base_quant`` set).
    Returns ``{"base": dir, "tenants": {mode: [paths]}}``."""
    from bitdelta_torch.core.artifact import save_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models.hf_import import load_hf_params
    from bitdelta_torch.research.quantized_base import roundtrip_base
    from bitdelta_torch.utils import compiled_check as cc

    cfg = cc.tp_check_config()
    write_hf_checkpoint(cfg, cc.check_world(cfg, dev), Path(root) / "base",
                        shards=1)
    _, base = load_hf_params(str(Path(root) / "base"), cfg, torch.float32,
                             dev)
    out = {"base": str(Path(root) / "base"), "tenants": {}}
    for mode in ("int8", "int4"):
        deq = roundtrip_base(base, mode, torch.float32)
        out["tenants"][mode] = []
        for t in range(2):
            fine = dict(deq)
            fine["layers"] = {k: v * (1.01 + 0.01 * t) if v.ndim == 3
                              else v for k, v in deq["layers"].items()}
            fine["embed"] = deq["embed"] * (1.01 + 0.01 * t)
            path = str(Path(root) / f"{mode}_{t}.safetensors")
            save_delta(path, compress_model(deq, fine), cfg, base_quant=mode)
            out["tenants"][mode].append(path)
    return out


def tp_quantized_from_disk(dev, mesh, launches, world):
    """12a's W8 and W4 worlds loaded on each rank's shards: the base
    quantized on the shards (``quantize_base(mesh=)``; W8's row-parallel
    absmax over the model axis) must give, paired, the shard of the whole
    stack quantized whole, bit for bit; the meshed engine on the loaded
    shard (its launches added to ``launches``) must give the
    single-process engine's tokens."""
    from bitdelta_torch.core.artifact import load_delta
    from bitdelta_torch.models.hf_import import load_hf_params
    from bitdelta_torch.parallel.sharding import shard_stack
    from bitdelta_torch.research.quantized_base import quantize_base
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.stacking import (load_stack_shard,
                                                 stack_tenants,
                                                 to_pair_layout)
    from bitdelta_torch.utils import compiled_check as cc

    cfg = cc.tp_check_config()
    reqs = [dict(prompt_ids=[3, 1, 4, 1, 5], tenant_id=t, max_new_tokens=4)
            for t in range(2)]
    out = {}
    for mode, paths in world["tenants"].items():
        shard = load_stack_shard(cfg, world["base"], paths, mesh,
                                 dtype=torch.float32, device=dev,
                                 base_quant=mode)
        _, base = load_hf_params(world["base"], cfg, torch.float32, dev)
        whole = stack_tenants(cfg, quantize_base(base, mode),
                              [load_delta(p, dev)[0] for p in paths], dev)
        want = shard_stack(cfg, to_pair_layout(whole, tp=TP_RANKS), mesh)
        got = to_pair_layout(shard.local, tp=TP_RANKS, local=True)
        pairs = list(zip(_tree_leaves((got.params, got.deltas)),
                         _tree_leaves((want.params, want.deltas))))
        require(pairs and all(a.dtype == b.dtype and torch.equal(a, b)
                              for a, b in pairs),
                f"12a {mode}: the base quantized on the shards differs from "
                f"the shard of the whole quantized stack")
        single = [list(map(int, o)) for o in Engine(
            cfg, whole, max_slots=2, max_seq=64, prefill_buckets=(16,),
            kernel="cuda", device=dev).generate([Request(**r)
                                                 for r in reqs])]
        with counted(launches):
            tokens = _mesh_tokens(Engine(
                cfg, shard, max_slots=2, max_seq=64, prefill_buckets=(16,),
                kernel="cuda", device=dev, mesh=mesh),
                [Request(**r) for r in reqs])
        require(tokens == single, f"12a {mode} from disk at (1, 2): "
                                  f"{tokens} != {single}")
        out[mode] = {"leaves_bit_equal": len(pairs), "tokens": tokens}
    return out


def tp_tiny(dev, meshes, launches, world):
    """12a on one rank: the serving check's fp32 two-tenant world (2 KV
    heads) on each mesh, both kernel routes, a cache of the compute dtype
    and the int8 one, and its W4 base: every meshed engine must give the
    single-process engine's tokens. Then the Mixtral world at (1, 2): a
    teacher-forced step's logits against one process's, and the meshed
    engine's ``generate`` held call by call to the single-process
    engine's (:func:`held_generate_logits`). Then the W8 and W4 worlds
    of ``world`` loaded on the shards (:func:`tp_quantized_from_disk`).
    The meshed runs' launches, and only theirs, are added to
    ``launches``."""
    from bitdelta_torch.models import llama, mixtral
    from bitdelta_torch.parallel.collectives import all_gather
    from bitdelta_torch.parallel.sharding import (gather_tree, local_config,
                                                  serving_delta_specs,
                                                  serving_param_specs,
                                                  shard_stack)
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.stacking import to_pair_layout
    from bitdelta_torch.utils import compiled_check as cc

    cfg = cc.tp_check_config()
    base = cc.check_world(cfg, dev)
    out = {}
    for kv in (None, "int8"):
        ref = cc.check_engines(cfg, base, lambda msg: None, device=dev,
                               kv_dtype=kv)
        for shape, mesh in meshes.items():
            with counted(launches):
                got = cc.check_engines(cfg, base, lambda msg: None,
                                       device=dev, mesh=mesh, kv_dtype=kv,
                                       want=ref)
            out[f"{shape[0]}x{shape[1]}_{kv or 'f32'}"] = [
                got["tokens"], got["w4_tokens"]]
    mcfg, mstack = tp_mixtral_stack(dev)
    mesh = meshes[(1, 2)]
    reqs = [dict(prompt_ids=[5, 11, 3, 7], tenant_id=t, max_new_tokens=5)
            for t in range(2)]
    local_cfg = local_config(mcfg, mesh)
    g = torch.Generator().manual_seed(17)
    tokens = torch.randint(1, mcfg.vocab_size, (4, 8), generator=g).to(dev)
    nxt = torch.randint(1, mcfg.vocab_size, (4, 1), generator=g).to(dev)
    tids = torch.tensor([0, 1, 1, 0], device=dev)

    def step_logits(kernel, tp, group):
        """Teacher-forced: a prefill and a decode step, the step's logits
        gathered over the model axis."""
        st = to_pair_layout(mstack, tp=tp) if kernel != "torch" else mstack
        if group is not None:
            st = shard_stack(mcfg, st, group)
        kw = dict(deltas=st.deltas, tenant_ids=tids, kernel=kernel,
                  tp_group=group)
        c = mcfg if group is None else local_cfg
        with torch.no_grad():
            _, cache = mixtral.forward(c, st.params, tokens,
                                       return_cache=True, cache_max_seq=16,
                                       **kw)
            step, _ = mixtral.decode_step(c, st.params, nxt, cache, **kw)
        return all_gather(step[:, 0].float(), group, "model", -1).cpu()

    def engine(kernel, m):
        return Engine(mcfg, mstack, max_slots=2, max_seq=64,
                      prefill_buckets=(16,), kernel=kernel, device=dev,
                      model=mixtral, mesh=m)

    for kernel in ("torch",) + llama.CARD_KERNELS:
        want_step = step_logits(kernel, 1, None)
        want_calls = []
        with sampled_logits(want_calls):
            want = [list(map(int, o)) for o in engine(kernel, None).generate(
                [Request(**r) for r in reqs])]
        got_calls = []
        with counted(launches):
            got_step = step_logits(kernel, 2, mesh)
            with sampled_logits(got_calls):
                got = _mesh_tokens(engine(kernel, mesh),
                                   [Request(**r) for r in reqs])
        err = _logit_err(got_step, want_step)
        # fp32 sums split in two, in another order: 1e-4 of the scale on
        # the plain route (4.7e-6 on the CPU). The kernel routes' rows 1
        # and 7 put x on a grid (a row's 12-bit one; the whole input's
        # 14-bit one) that spans a rank's K shard of o_proj and w2, twice
        # a layer: 2e-3 (6.8e-4 on the CPU's plain versions).
        limit = 1e-4 if kernel == "torch" else 2e-3
        require(err["max_abs_err"] <= limit * err["ref_max_abs"],
                f"mixtral {kernel} tp=2 step logits: {err}")
        require(kernel != "torch" or got == want,
                f"mixtral torch at (1, 2): {got} != {want}")
        # The same grids over generate's own inputs, call by call: 3.1e-3
        # of the scale at most (4.1e-6 on the plain route) on an NVIDIA
        # H100 80GB HBM3, 700.00 W; 2.6e-3 on the CPU's plain versions. A slot, row or replay fault
        # moves a row's logits by a share of the scale itself.
        gen_limit = 1e-4 if kernel == "torch" else 5e-3
        held = held_generate_logits(got_calls, want_calls, gen_limit,
                                    f"mixtral {kernel} at (1, 2) generate")
        same = sum(a == b for x, y in zip(got, want) for a, b in zip(x, y))
        out[f"mixtral_1x2_{kernel}"] = {
            "tokens": got, "single_process": want, "step_logits": err,
            "generate_logits": held,
            "token_agreement": same / sum(len(y) for y in want)}
    # Every rank's shard, gathered back, is the whole pair-layout stack.
    full = to_pair_layout(mstack, tp=2)
    local = shard_stack(mcfg, full, mesh)
    specs = (serving_param_specs(mcfg, full.params, tp=2),
             serving_delta_specs(full.deltas))
    back = (gather_tree(local.params, specs[0], mesh),
            gather_tree(local.deltas, specs[1], mesh))
    require(all(torch.equal(a, b) for a, b in zip(
        _tree_leaves(back), _tree_leaves((full.params, full.deltas)))),
        "12a: the gathered Mixtral shards differ from the whole stack")
    out["from_disk"] = tp_quantized_from_disk(dev, mesh, launches, world)
    return out


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _logit_err(got, want):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return {"max_abs_err": err, "ref_max_abs": scale, "rel_err": err / scale,
            "argmax_agreement": (got.argmax(-1) == want.argmax(-1))
            .float().mean().item()}


def vm_rss_bytes():
    """This process's resident set now (``VmRSS`` of
    ``/proc/self/status``: anonymous and file-backed pages alike)."""
    for line in Path("/proc/self/status").read_text().splitlines():
        if line.startswith("VmRSS:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


class PeakRss:
    """This process's resident set over a block: ``VmRSS`` read before
    it, every ``interval`` seconds by a thread while it runs, and after
    it. The card's machine gives no ``VmHWM``, and a spawned process's
    ``ru_maxrss`` starts at its parent's resident set (it carries over
    the fork), so the peak is sampled."""

    def __init__(self, interval=0.002):
        self.interval = interval
        self.samples = []
        self._stop = threading.Event()

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(vm_rss_bytes())
            self._stop.wait(self.interval)

    def __enter__(self):
        self.before = vm_rss_bytes()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.after = vm_rss_bytes()
        self.peak = max(self.samples + [self.before, self.after])

    def report(self):
        return {"vm_rss_before_bytes": self.before,
                "vm_rss_peak_bytes": self.peak,
                "vm_rss_after_bytes": self.after,
                "increase_bytes": self.peak - self.before,
                "samples": len(self.samples),
                "interval_s": self.interval}


def write_tp_70b_world(root, dev):
    """12b's world on disk: Llama-2-70B at full width, TP_LAYERS layers,
    built on the card from one seed, as an HF checkpoint in bf16 (two
    files, by the port's exporter) and two tenants' artifacts (synthetic
    fine-tunes, their embed and head kept dense). Returns ``{"base": dir,
    "tenants": [paths], "largest_tensor_bytes": n}``."""
    import dataclasses

    from bitdelta_torch.core.artifact import save_delta, stored_tensors
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import llama2_70b

    cfg = dataclasses.replace(llama2_70b(), num_layers=TP_LAYERS)
    Path(root).mkdir(parents=True)
    gen = torch.Generator(device=dev).manual_seed(71)
    base = llama.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    tenants = []
    for t in range(2):
        comp = compress_model(base, synthetic_finetune(cfg, base, gen))
        tenants.append(str(Path(root) / f"tenant{t}.safetensors"))
        save_delta(tenants[-1], comp, cfg)
        del comp
    write_hf_checkpoint(cfg, base, Path(root) / "base", shards=2)
    del base
    gc.collect()
    torch.cuda.empty_cache()
    files = list((Path(root) / "base").glob("*.safetensors")) + tenants
    largest = max(t.nbytes for f in files for _, t in stored_tensors(str(f)))
    return {"base": str(Path(root) / "base"), "tenants": tenants,
            "largest_tensor_bytes": largest,
            "bytes_on_disk": sum(Path(f).stat().st_size for f in files)}


def tp_70b(dev, mesh, rank, smi, world):
    """12b on one rank: Llama-2-70B at full width, 2 layers, two tenants,
    from ``world`` on disk (:func:`write_tp_70b_world`). Each rank reads
    its own blocks of the checkpoint and the artifacts to the card
    (``load_stack_shard``); its host's resident set (:class:`PeakRss`)
    may grow by no more than the largest checkpoint tensor and
    ``HOST_SLACK_BYTES``, nor than its shard and that tensor. Its first
    engine pairs the loaded shard in place, its card peaking at no more
    than the shard and one leaf; the stack so paired must equal the shard
    of the whole stack built from the same files, bit for bit; rank 0
    takes the tp=1 references from that whole stack. Then each route's
    engine runs on the loaded shard. Returns ``(report, the meshed
    engines' launches)``."""
    import dataclasses

    import torch.distributed as dist

    from bitdelta_torch.core.artifact import load_delta
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import llama2_70b
    from bitdelta_torch.models.hf_import import load_hf_params
    from bitdelta_torch.parallel import collectives
    from bitdelta_torch.parallel.mesh import MODEL_AXIS
    from bitdelta_torch.parallel.sharding import local_config, shard_stack
    from bitdelta_torch.serving.engine import Engine, Request
    from bitdelta_torch.serving.stacking import (load_stack_shard,
                                                 stack_nbytes,
                                                 stack_tenants,
                                                 to_pair_layout)

    cfg = dataclasses.replace(llama2_70b(), num_layers=TP_LAYERS)
    # Each rank's model sees its own heads.
    cfg_local = local_config(cfg, mesh)
    report = {"rank": rank, "card": smi, "model": "llama2_70b",
              "layers": TP_LAYERS, "tp": TP_RANKS,
              "checkpoint_bytes_on_disk": world["bytes_on_disk"],
              "largest_tensor_bytes": world["largest_tensor_bytes"]}
    torch.empty(1, device=dev).add_(1)          # CUDA is up
    torch.cuda.synchronize()

    def total(nb):
        return sum(nb[k] for k in ("base_bytes", "deltas_bytes",
                                   "tenant_extras_bytes"))

    def check_build(eng, label, rep):
        """The engine's build peak on the card against its stack (this
        rank's shard) and the stack's largest leaf."""
        rep.update(resident_bytes=torch.cuda.memory_allocated(),
                   build_peak_bytes=torch.cuda.max_memory_allocated(),
                   shard_bytes=stack_nbytes(eng.stack))
        shard_total = total(rep["shard_bytes"])
        largest = max(t.numel() * t.element_size() for t in _tree_leaves(
            (eng.stack.params, eng.stack.deltas)))
        rep["allowed_peak_bytes"] = shard_total + largest
        require(rep["build_peak_bytes"] <= shard_total + largest,
                f"70b tp {label}: rank {rank}'s engine build peaked at "
                f"{rep['build_peak_bytes']} bytes, over its shard "
                f"{shard_total} and largest leaf {largest}")

    with PeakRss() as rss:
        t0 = time.perf_counter()
        shard = load_stack_shard(cfg, world["base"], world["tenants"], mesh,
                                 dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        # The first engine pairs the loaded canonical shard in place.
        report["first_engine"] = {"loaded_bytes":
                                  torch.cuda.memory_allocated()}
        torch.cuda.reset_peak_memory_stats()
        first = Engine(cfg, shard, max_slots=8, max_seq=128,
                       prefill_buckets=(64,), kernel=llama.CARD_KERNELS[0],
                       device=dev, mesh=mesh)
        torch.cuda.synchronize()
    check_build(first, "first engine", report["first_engine"])
    del first

    shard_bytes = total(stack_nbytes(shard.local))
    whole = total(stack_nbytes(shard.whole))
    largest = world["largest_tensor_bytes"]
    report["host"] = dict(
        rss.report(), shard_bytes=shard_bytes,
        allowed_bytes=min(shard_bytes, HOST_SLACK_BYTES) + largest,
        whole_stack_bytes=whole)
    increase = report["host"]["increase_bytes"]
    require(increase <= min(shard_bytes, HOST_SLACK_BYTES) + largest,
            f"70b: rank {rank}'s host resident set grew by {increase} bytes "
            f"loading its shard, over the largest tensor {largest} and "
            f"the lesser of its shard {shard_bytes} and "
            f"{HOST_SLACK_BYTES} (the whole stack: {whole})")
    report["whole_stack_bytes"] = whole
    # The whole stack from the same files, on the card: this rank's
    # loaded shard, as the first engine paired it in place, must be its
    # shard bit for bit.
    t0 = time.perf_counter()
    _, base = load_hf_params(world["base"], cfg, torch.bfloat16, dev)
    stack = stack_tenants(cfg, base, [load_delta(p, dev)[0]
                                      for p in world["tenants"]], dev)
    del base
    want = shard_stack(cfg, to_pair_layout(stack, tp=TP_RANKS), mesh)
    got = shard.local
    pairs = list(zip(_tree_leaves((got.params, got.deltas,
                                   got.vocab_sizes)),
                     _tree_leaves((want.params, want.deltas,
                                   want.vocab_sizes))))
    differ = [i for i, (a, b) in enumerate(pairs)
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a, b)]
    require(pairs and not differ,
            f"70b: rank {rank}'s loaded shard differs from the whole "
            f"stack's shard at leaves {differ} of {len(pairs)}")
    report["shard_leaves_bit_equal"] = len(pairs)
    report["whole_build_s"] = time.perf_counter() - t0
    del want, got, pairs
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(13)
    tokens = torch.randint(1, cfg.vocab_size, (8, 64), generator=g).to(dev)
    lengths = torch.tensor([64, 33, 50, 17, 64, 9, 41, 58],
                           dtype=torch.int32, device=dev)
    tids = torch.tensor([0, 1] * 4, device=dev)
    nxt = torch.randint(1, cfg.vocab_size, (8, 1), generator=g).to(dev)
    reqs = [dict(prompt_ids=tokens[b, :int(lengths[b])].tolist(),
                 tenant_id=int(tids[b]), max_new_tokens=8) for b in range(8)]
    rows = torch.arange(8, device=dev)

    def steps(cfg_run, st, kernel, group):
        """B=8 prefill (last-position logits), one decode step, and the
        prefill of one request alone (``Engine.submit``'s, the server's
        admission: row 5 on its tenant), the logits gathered over the
        model axis."""
        kw = dict(deltas=st.deltas, tenant_ids=tids, kernel=kernel,
                  tp_group=group)
        one = int(lengths[1])
        with torch.no_grad():
            logits, cache = llama.forward(
                cfg_run, st.params, tokens, lengths=lengths,
                return_cache=True, cache_max_seq=128, **kw)
            step, _ = llama.decode_step(cfg_run, st.params, nxt, cache, **kw)
            alone = llama.forward(
                cfg_run, st.params, tokens[1:2, :one],
                **dict(kw, tenant_ids=tids[1:2]))[:, -1].float()
        pre = logits[rows, lengths.long() - 1].float()
        return tuple(collectives.all_gather(x, group, MODEL_AXIS, -1)
                     for x in (pre, step[:, 0].float(), alone))

    refs = {}
    if rank == 0:
        paired = to_pair_layout(stack)
        for kernel in llama.CARD_KERNELS:
            logits = [x.cpu() for x in steps(cfg, paired, kernel, None)]
            eng = Engine(cfg, stack, max_slots=8, max_seq=128,
                         prefill_buckets=(64,), kernel=kernel, device=dev)
            refs[kernel] = (logits, [
                list(map(int, o))
                for o in eng.generate([Request(**r) for r in reqs])])
            del eng
        del paired
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    # From here on only the meshed engines run, on the loaded shard:
    # their launches alone.
    reset_counts()
    for kernel in llama.CARD_KERNELS:
        torch.cuda.reset_peak_memory_stats()
        rep = {"loaded_bytes": torch.cuda.memory_allocated()}
        eng = Engine(cfg, shard, max_slots=8, max_seq=128,
                     prefill_buckets=(64,), kernel=kernel, device=dev,
                     mesh=mesh)
        if kernel == llama.CARD_KERNELS[-1]:
            del shard                       # the engine's stack alone stays
        gc.collect()
        torch.cuda.empty_cache()
        # The shard is paired already (the first engine did it in place):
        # the card never holds more than it and one leaf of it.
        check_build(eng, kernel, rep)
        logits = [x.cpu() for x in steps(cfg_local, eng.stack, kernel, mesh)]
        require(all(torch.isfinite(x).all().item() for x in logits),
                f"70b tp {kernel}: logits not finite")
        if rank == 0:
            for which, a, b in zip(("prefill", "decode", "prefill_alone"),
                                   logits, refs[kernel][0]):
                rep[which] = _logit_err(a, b)
                # bf16 activations, the row-parallel sums split over two
                # ranks: as phases 5 and 11, 2% of the logit scale.
                require(rep[which]["max_abs_err"]
                        <= 2e-2 * rep[which]["ref_max_abs"],
                        f"70b tp {kernel} {which}: {rep[which]}")
        # One decode step of the engine's batch, alone: wall, device time
        # and top kernels (each rank traces its own process once; both
        # ranks share the card), and the collectives it calls.
        step_toks = nxt
        tids_local = tids

        def one_step():
            with torch.no_grad():
                llama.decode_step(cfg_local, eng.stack.params,
                                  step_toks, eng.cache,
                                  deltas=eng.stack.deltas,
                                  tenant_ids=tids_local, kernel=kernel,
                                  tp_group=mesh)
        one_step()
        torch.cuda.synchronize()
        calls0 = collectives.psum.calls
        dist.barrier()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        rep["step_wall_ms"] = (time.perf_counter() - t0) * 1e3
        rep["psum_calls_per_step"] = collectives.psum.calls - calls0
        from torch.profiler import ProfilerActivity, profile

        dist.barrier()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            one_step()
            torch.cuda.synchronize()
            time.sleep(TRACE_PAD_S)
        rows_ = sorted(((getattr(e, "device_time_total", 0.0), e.count,
                         e.key) for e in prof.key_averages()), reverse=True)
        rows_ = [r for r in rows_ if r[0] > 0]
        rep["step_device_ms"] = sum(r[0] for r in rows_) / 1e3
        rep["step_top"] = [{"kernel": k[:80], "ms": us / 1e3, "count": c}
                           for us, c, k in rows_[:6]]
        # The step's collectives timed alone at its shapes: one psum of
        # the (8, 1, 8192) bf16 residual, synchronised around.
        x = torch.ones((8, 1, cfg.hidden_size), dtype=torch.bfloat16,
                       device=dev)
        times = []
        for _ in range(12):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            collectives.psum(x, mesh)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rep["psum_ms"] = statistics.median(times[2:])
        rep["collective_ms_per_step"] = (rep["psum_ms"]
                                         * rep["psum_calls_per_step"])
        rep["peak_bytes"] = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        got = _mesh_tokens(eng, [Request(**r) for r in reqs])
        rep["generate_s"] = time.perf_counter() - t0
        if rank == 0:
            want = refs[kernel][1]
            same = sum(a == b for x, y in zip(got, want)
                       for a, b in zip(x, y))
            rep["generate_tokens"] = got
            rep["token_agreement"] = same / sum(len(y) for y in want)
        report[kernel] = rep
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return report, read_counts()


def _tp_rank(rank, store, out_dir, worlds):
    """One rank of phase 12 (a spawned process): 12b first (its host
    memory is read from a process that has loaded nothing else), then
    12a. Writes its report, launches and any error to
    ``out_dir/rank{rank}.json``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from bitdelta_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    try:
        pmesh.initialize_multihost(
            f"file://{store}", TP_RANKS, rank, device="cuda",
            timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
        out["backend"] = dist.get_backend()
        dev = torch.device("cuda")
        meshes = {s: pmesh.make_mesh(s) for s in ((1, 2), (2, 1))}
        smi = smi_line()
        t0 = time.perf_counter()
        out["70b"], out["70b_launches"] = tp_70b(dev, meshes[(1, 2)], rank,
                                                 smi, worlds["70b"])
        out["70b_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["tiny_launches"] = {}
        out["tiny"] = tp_tiny(dev, meshes, out["tiny_launches"],
                              worlds["tiny"])
        out["tiny_s"] = time.perf_counter() - t0
        out["ok"] = True
        dist.barrier()
        dist.destroy_process_group()
    except Exception:                  # reported to the parent, which fails
        out["ok"] = False
        out["error"] = traceback.format_exc()[-4000:]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    sys.stdout.flush()
    sys.exit(0 if out["ok"] else 1)


def _spawn_ranks(target, phase, *args):
    """Run ``target(rank, store, out_dir, *args)`` in TP_RANKS spawned
    processes on the card (gloo). Each must finish within
    TP_PHASE_TIMEOUT_S; a rank still running then is killed and the phase
    fails, as does one that reports a failure. Returns each rank's
    report."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, str(Path(tmp) / "store"), tmp, *args))
                 for r in range(TP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_PHASE_TIMEOUT_S
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        reports = []
        for r in range(TP_RANKS):
            path = Path(tmp, f"rank{r}.json")
            reports.append(json.loads(path.read_text()) if path.exists()
                           else {"rank": r, "ok": False})
    for r, rep in enumerate(reports):
        print(json.dumps({"phase": f"rank of phase {phase}", "rank": r,
                          "ok": rep.get("ok"), "error": rep.get("error")}),
              flush=True)
    require(not hung, f"phase {phase} ranks {hung} still ran after "
                      f"{TP_PHASE_TIMEOUT_S} s")
    require(all(rep.get("ok") for rep in reports)
            and all(p.exitcode == 0 for p in procs),
            f"phase {phase} ranks failed: exit codes "
            f"{[p.exitcode for p in procs]}")
    return reports


def tp_ranks(dev):
    """12a and 12b: their worlds written to disk here, then two spawned
    ranks on the card. Returns ``(launches summed over ranks, reports,
    seconds writing the worlds)``."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        worlds = {"70b": write_tp_70b_world(Path(tmp) / "70b", dev),
                  "tiny": write_tp_tiny_worlds(Path(tmp) / "tiny", dev)}
        write_s = time.perf_counter() - t0
        reports = _spawn_ranks(_tp_rank, "12", worlds)
    for rep in reports:
        # The meshed runs' launches alone (no single-process reference).
        for kname in TP_TINY_KERNELS:
            require(rep["tiny_launches"].get(kname, 0) > 0,
                    f"12a rank {rep['rank']} missed kernel {kname}")
        for kname in TP_70B_KERNELS:
            require(rep["70b_launches"][kname] > 0,
                    f"12b rank {rep['rank']} missed kernel {kname}")
    require(reports[0]["tiny"] == reports[1]["tiny"],
            "12a: the ranks disagree on tokens")
    launches = {k: sum(rep["tiny_launches"].get(k, 0)
                       + rep["70b_launches"][k] for rep in reports)
                for k in KERNELS}
    return launches, reports, write_s


def _serve_tokens(cmd, env, label, deltas):
    """Start a serve CLI command, wait for its "serving" line, POST one
    broadcast ``/generate``, SIGTERM its process group and wait for every
    process of it. Returns ``(tokens by tenant, output lines)``."""
    import os
    import queue
    import signal

    port = cmd[cmd.index("--port") + 1]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout],
        daemon=True)
    reader.start()
    log = []
    try:
        deadline = time.perf_counter() + 300
        while True:
            require(time.perf_counter() < deadline,
                    f"{label}: no 'serving' line in 300 s")
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                require(proc.poll() is None,
                        f"{label} exited with {proc.returncode}: "
                        + "".join(log[-30:]))
                continue
            log.append(line)
            if line.startswith("serving "):
                break
        got, _, _ = _post(f"http://127.0.0.1:{port}",
                          {"prompt": "Two ranks, one card",
                           "max_new_tokens": 8})
    finally:
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        reader.join(timeout=10)
        while not lines.empty():
            log.append(lines.get())
    tokens = {t: [line["token_id"] for line in got if line["tenant"] == t]
              for t in deltas}
    require(all(tokens.values()), f"{label}: a tenant gave no tokens")
    return tokens, [line.rstrip() for line in log]


def tp_cli(dev):
    """12c: ``cli.serve --mesh 1,2`` under ``torch.distributed.run`` on a
    tiny fp32 checkpoint written here, against ``--mesh 1,1``."""
    import dataclasses
    import os

    from bitdelta_torch.core.artifact import save_delta
    from bitdelta_torch.core.compress import compress_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.utils import compiled_check as cc

    cfg = dataclasses.replace(cc.tp_check_config(), max_seq_len=256)
    gen = torch.Generator(device=dev).manual_seed(81)
    base = llama.init_params(cfg, gen, scale=0.25, device=dev)
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo), HF_HUB_OFFLINE="1")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_hf_checkpoint(cfg, base, Path(tmp) / "base", shards=1)
        deltas = {}
        for t in ("a", "b"):
            fine = synthetic_finetune(cfg, base, gen, scale=0.05)
            path = str(Path(tmp) / f"{t}.safetensors")
            save_delta(path, compress_model(base, fine), cfg)
            deltas[t] = path
        common = ["-m", "bitdelta_torch.cli.serve", "--base_model",
                  str(Path(tmp) / "base"), "--dtype", "float32",
                  "--max_slots", "2", "--max_seq", "128",
                  "--host", "127.0.0.1", "--device", dev.type]
        for name, path in deltas.items():
            common += ["--delta", f"{name}={path}"]
        t0 = time.perf_counter()
        want, _ = _serve_tokens(
            [sys.executable, *common, "--mesh", "1,1", "--port",
             str(free_port())], env, "serve --mesh 1,1", deltas)
        report["mesh_1x1_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, log = _serve_tokens(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node", "2", "--master-port", str(free_port()),
             *common, "--mesh", "1,2", "--port", str(free_port())],
            env, "serve --mesh 1,2", deltas)
        report["mesh_1x2_s"] = time.perf_counter() - t0
    require(got == want, f"serve --mesh 1,2 tokens {got} != --mesh 1,1 "
                         f"{want}")
    for needed in ("sharding stack over mesh (1, 2) (data, model)",
                   "[rank 0] stopping", "[rank 1] stopped"):
        require(any(needed in line for line in log),
                f"serve --mesh 1,2: no {needed!r} line")
    report["tokens"] = got
    report["log"] = [line for line in log if "rank" in line or
                     line.startswith("sharding")][-8:]
    return report


def tp(dev, smi):
    """Phase 12: 12a and 12b on two spawned ranks, then 12c."""
    t_phase = time.perf_counter()
    launches, reports, write_s = tp_ranks(dev)
    for rep in reports:
        emit({"phase": "tp_70b", "seconds": rep["70b_s"],
              "worlds_write_s": write_s, **rep["70b"],
              "launches": rep["70b_launches"]})
        emit({"phase": "tp_tiny", "rank": rep["rank"],
              "backend": rep["backend"], "seconds": rep["tiny_s"],
              "tokens": rep["tiny"], "launches": rep["tiny_launches"]})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_report = tp_cli(dev)
    emit({"phase": "tp_cli", "card": smi,
          "seconds": time.perf_counter() - t0, **cli_report})
    emit({"phase": "tp", "card": smi,
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


# ---------------------------------------------------------------------------
# 13. Data and tensor parallelism for distillation and the eval
# ---------------------------------------------------------------------------

TT_STEPS, TT_BATCH, TT_LEN = 3, 4, 128   # 13b's distillation, as phase 6
# 13b against tp=1, set from its first readings on the H100 (4.5e-4,
# 3.3%): each step's loss; each matrix's scale update (AdamW's step hardly
# moves when a gradient is scaled by a constant); and each matrix's
# gradient of one step from the initial scales, which a gradient summed
# once too often or not at all over the model axis puts 50-100% off.
TT_LOSS_RTOL, TT_UPDATE_RTOL, TT_GRAD_RTOL = 5e-3, 0.1, 0.1
TT_PPL_RTOL = 5e-3             # 13c: each meshed PPL against one process's
TT_PPL_TOKENS = 2048           # 13c: two windows of 1024 + 512 tokens
TINY_LOSS_RTOL, TINY_SCALE_RTOL, TINY_PPL_RTOL = 1e-4, 1e-5, 1e-5   # 13a
TT_COUNTERS = ("psum", "reduce_from_model", "copy_to_model")


def _collective_calls():
    from bitdelta_torch.parallel import collectives

    return {n: getattr(collectives, n).calls for n in TT_COUNTERS}


def _tiny_distill_world(dev):
    """tests/test_sharding.py's world (vocab 256, hidden 128, 2 layers, 8
    heads, 4 KV heads, fp32), drawn on the card: a fine-tune of every
    projection by 0.02 noise."""
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import ModelConfig

    cfg = ModelConfig(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=256, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(101)
    base = llama.init_params(cfg, gen, device=dev)
    fine = dict(base)
    fine["layers"] = dict(base["layers"])
    for name in llama.PROJ_NAMES:
        w = base["layers"][name]
        fine["layers"][name] = w + 0.02 * torch.randn(
            w.shape, generator=gen, device=dev)
    return cfg, base, fine


def _tiny_mixtral_world(dev):
    """tests/test_mixtral.py's tensor-parallel Mixtral (vocab 96, hidden
    64, 4 experts, top 2, fp32), drawn on the card: a fine-tune of every
    layer tensor (the router's too), the embed and the head."""
    from bitdelta_torch.models import mixtral

    cfg = mixtral.MixtralConfig(vocab_size=96, hidden_size=64,
                                intermediate_size=128, num_layers=2,
                                num_heads=4, num_kv_heads=2, max_seq_len=64,
                                num_experts=4, experts_per_token=2,
                                dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(103)
    base = mixtral.init_params(cfg, gen, scale=0.25, device=dev)

    def moved(w):
        return w + 0.01 * torch.randn(w.shape, generator=gen, device=dev)

    fine = {k: moved(v) for k, v in base.items() if k != "layers"}
    fine["layers"] = {k: moved(v) for k, v in base["layers"].items()}
    return cfg, base, fine


def _shard_world(cfg, base, fine, comp, mesh):
    """This rank's shards of a base, its fine-tune and their compressed
    model, as the JAX tests shard them."""
    from bitdelta_torch.parallel import sharding as psh

    specs = psh.param_specs(cfg)
    return (psh.shard_tree(base, specs, mesh),
            psh.shard_tree(fine, specs, mesh),
            comp._replace(
                deltas=psh.shard_deltas(cfg, comp.deltas, mesh),
                extras=psh.shard_tree(comp.extras, psh.extras_specs(
                    cfg, keys=comp.extras.keys()), mesh)))


def _held_distill(label, got, want, loss_rtol, scale_rtol=None):
    """Losses (and, with ``scale_rtol``, scales) of a meshed distillation
    against one process's; every rank's scales equal rank 0's, bit for
    bit. Returns the readings."""
    from bitdelta_torch.parallel.collectives import broadcast_object

    (losses, scales), (want_losses, want_scales) = got, want
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    require(len(losses) == len(want_losses) and loss_err <= loss_rtol,
            f"{label}: losses {losses} against one process's "
            f"{want_losses}")
    scale_err = max(((scales[n] - s).abs() / s.abs()).max().item()
                    for n, s in want_scales.items())
    require(scale_rtol is None or scale_err <= scale_rtol,
            f"{label}: scales {scale_err} off one process's")
    flat = torch.cat([scales[n].reshape(-1) for n in sorted(scales)]).cpu()
    require(torch.equal(broadcast_object(flat), flat),
            f"{label}: the ranks' scales differ")
    return {"losses": losses, "single_process": list(want_losses),
            "loss_rel_err": loss_err, "scale_rel_err": scale_err}


def train_tiny(dev, meshes, launches):
    """13a on one rank: fp32 tiny worlds, every meshed run against the
    same run in one process (each rank takes its own reference): the
    distill world on (1, 2) and (2, 1), the Mixtral at (1, 2), and the
    sequence-sharded eval on (2, 1) and (1, 2), all on ``kernel="cuda"``.
    The meshed runs' launches, and only theirs, go to ``launches``."""
    from bitdelta_torch.core.compress import compress_model, student_params
    from bitdelta_torch.eval.ppl import eval_ppl
    from bitdelta_torch.models import mixtral
    from bitdelta_torch.parallel import sharding as psh
    from bitdelta_torch.train.data import synthetic_batches
    from bitdelta_torch.train.distill import DistillConfig, distill_scales

    def scales_of(comp):
        return {n: d.scale for n, d in comp.deltas.items()}

    out = {}
    cfg, base, fine = _tiny_distill_world(dev)
    comp = compress_model(base, fine)
    batches = synthetic_batches(cfg.vocab_size, 3, 4, 16, seed=1)
    dcfg = DistillConfig(lr=1e-3, num_steps=3, compute_dtype="float32",
                         kernel="cuda")
    ref, ref_losses = distill_scales(cfg, base, fine, comp, batches, dcfg)
    for shape, mesh in meshes.items():
        b, f, c = _shard_world(cfg, base, fine, comp, mesh)
        with counted(launches):
            got, losses = distill_scales(cfg, b, f, c, batches, dcfg,
                                         mesh=mesh)
        out[f"distill_{shape[0]}x{shape[1]}"] = _held_distill(
            f"13a distill at {shape}", (losses, scales_of(got)),
            (ref_losses, scales_of(ref)), TINY_LOSS_RTOL, TINY_SCALE_RTOL)

    mcfg, mbase, mfine = _tiny_mixtral_world(dev)
    mcomp = mixtral.compress_mixtral(mbase, mfine)
    mbatches = synthetic_batches(mcfg.vocab_size, 2, 2, 16, seed=3)
    mdcfg = dcfg._replace(num_steps=2)
    ref, ref_losses = distill_scales(mcfg, mbase, mfine, mcomp, mbatches,
                                     mdcfg, model=mixtral)
    mesh = meshes[(1, 2)]
    b, f, c = _shard_world(mcfg, mbase, mfine, mcomp, mesh)
    with counted(launches):
        got, losses = distill_scales(mcfg, b, f, c, mbatches, mdcfg,
                                     mesh=mesh, model=mixtral)
    out["mixtral_1x2"] = _held_distill(
        "13a Mixtral at (1, 2)", (losses, scales_of(got)),
        (ref_losses, scales_of(ref)), TINY_LOSS_RTOL, TINY_SCALE_RTOL)
    out["mixtral_1x2"]["router_scales"] = got.deltas["router"].scale.tolist()

    tokens = torch.randint(0, cfg.vocab_size, (512,),
                           generator=torch.Generator().manual_seed(7))
    sp = student_params(base, comp)
    kw = dict(context_size=96, window_size=32, compute_dtype=torch.float32,
              kernel="cuda")
    want = eval_ppl(cfg, sp, tokens.numpy(), deltas=comp.deltas, **kw)
    for shape, mesh in meshes.items():
        with counted(launches):
            got = eval_ppl(cfg, psh.shard_model(cfg, sp, mesh),
                           tokens.numpy(), deltas=psh.shard_deltas(
                               cfg, comp.deltas, mesh), mesh=mesh, **kw)
        err = abs(got - want) / want
        require(err <= TINY_PPL_RTOL,
                f"13a eval_ppl at {shape}: {got} against one process's "
                f"{want}")
        out[f"ppl_{shape[0]}x{shape[1]}"] = {"ppl": got,
                                             "single_process": want,
                                             "rel_err": err}
    return out


def _update_err(got, want, before):
    """Each matrix's scale update (final - initial) at tp=2 against tp=1's:
    the largest difference over the largest tp=1 update."""
    return {n: ((got[n] - w).abs().max()
                / (w - before[n]).abs().max()).item()
            for n, w in want.items()}


def _first_grads(step, initial, batch):
    """Run ``step`` once and return the gradients it left on the scales
    ``initial`` it was made with (summed as the step sums them)."""
    step(batch)
    return {n: s.grad for n, s in initial.items()}


def train_70b(dev, meshes, rank, smi):
    """13b and 13c on one rank: Llama-2-70B at full width cut to 2 layers,
    bf16, one seeded fine-tune, built on the card from one seed on each
    rank. Rank 0 distills it alone (tp=1) and evaluates it alone; then
    both ranks evaluate it with the sequence split, (2, 1); then each
    keeps its shards alone, compresses on them (held against the shards
    of the whole compression), distills at tp=2 and evaluates at (1, 2).
    Returns ``(report, the meshed runs' launches)``."""
    import dataclasses

    import torch.distributed as dist

    from bitdelta_torch.core.compress import compress_model, student_params
    from bitdelta_torch.eval.ppl import eval_ppl
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.config import llama2_70b
    from bitdelta_torch.parallel import collectives
    from bitdelta_torch.train.data import synthetic_batches
    from bitdelta_torch.train.distill import (DistillConfig, distill_scales,
                                              make_distill_step,
                                              make_optimizer)

    cfg = dataclasses.replace(llama2_70b(), num_layers=TP_LAYERS)
    report = {"rank": rank, "card": smi, "model": "llama2_70b",
              "layers": TP_LAYERS, "batch": TT_BATCH, "length": TT_LEN,
              "steps": TT_STEPS}
    launches = {k: 0 for k in KERNELS}
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(91)
    base = llama.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
    fine = synthetic_finetune(cfg, base, gen)
    comp = compress_model(base, fine)
    torch.cuda.synchronize()
    report["build_s"] = time.perf_counter() - t0
    batches = synthetic_batches(cfg.vocab_size, TT_STEPS, TT_BATCH, TT_LEN,
                                seed=0)
    dcfg = DistillConfig(lr=TRAIN_LR, num_steps=TT_STEPS,
                         compute_dtype="bfloat16", kernel="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (TT_PPL_TOKENS,),
                           generator=torch.Generator().manual_seed(17))
    ppl_kw = dict(context_size=1024, window_size=512, kernel="cuda")
    initial = {n: d.scale.clone() for n, d in comp.deltas.items()}
    batch = torch.from_numpy(batches[0]).long().to(dev)
    ref = None
    if rank == 0:
        t0 = time.perf_counter()
        out, losses = distill_scales(cfg, base, fine, comp, batches, dcfg)
        ref = {"losses": losses,
               "scales": {n: d.scale.cpu() for n, d in out.deltas.items()},
               "distill_s": time.perf_counter() - t0,
               "ppl": eval_ppl(cfg, student_params(base, comp),
                               tokens.numpy(), deltas=comp.deltas, **ppl_kw)}
        fresh = {n: s.clone().requires_grad_() for n, s in initial.items()}
        ref["grads"] = {n: g.cpu() for n, g in _first_grads(
            make_distill_step(cfg, dcfg, base, fine, comp, fresh,
                              make_optimizer(fresh, dcfg)),
            fresh, batch).items()}
        del out, fresh
    ref = collectives.broadcast_object(ref)
    report["single_process"] = {k: ref[k] for k in ("losses", "distill_s",
                                                    "ppl")}
    report["limits"] = {"loss_rtol": TT_LOSS_RTOL,
                        "update_rtol": TT_UPDATE_RTOL,
                        "grad_rtol": TT_GRAD_RTOL}

    # 13c, sequence split: at (2, 1) a rank's shard is the whole model.
    mesh = meshes[(2, 1)]
    t0 = time.perf_counter()
    with counted(launches):
        ppl = eval_ppl(cfg, student_params(base, comp), tokens.numpy(),
                       deltas=comp.deltas, mesh=mesh, **ppl_kw)
    report["ppl_2x1"] = {"ppl": ppl, "rel_err": abs(ppl - ref["ppl"])
                         / ref["ppl"], "s": time.perf_counter() - t0}
    require(report["ppl_2x1"]["rel_err"] <= TT_PPL_RTOL,
            f"13c eval_ppl at (2, 1): {report['ppl_2x1']} against one "
            f"process's {ref['ppl']}")

    # 13b: each rank keeps its shards alone; the deltas are compressed on
    # them, as the train CLI compresses.
    mesh = meshes[(1, 2)]
    b, f, c = _shard_world(cfg, base, fine, comp, mesh)
    on_shards = compress_model(b, f, mesh=mesh)
    for name, d in c.deltas.items():
        mine = on_shards.deltas[name]
        require(torch.equal(mine.packed, d.packed),
                f"13b {name}: the words packed on a shard differ from the "
                f"whole compression's shard")
        require(((mine.scale - d.scale).abs() <= 1e-5 * d.scale.abs())
                .all().item(), f"13b {name}: the scale over the shards "
                               f"differs from the whole matrix's")
    c = c._replace(deltas=on_shards.deltas)
    del base, fine, comp, on_shards
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    report["shard_bytes"] = sum(t.numel() * t.element_size()
                                for t in _tree_leaves((b, f, c)))
    report["resident_bytes"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dist.barrier()
    t0 = time.perf_counter()
    with counted(launches):
        got, losses = distill_scales(cfg, b, f, c, batches, dcfg, mesh=mesh)
    torch.cuda.synchronize()
    report["distill_s"] = time.perf_counter() - t0
    report["peak_bytes"] = torch.cuda.max_memory_allocated()
    scales = {n: d.scale for n, d in got.deltas.items()}
    report["distill"] = _held_distill(
        "13b Llama-2-70B at tp=2", (losses, scales),
        (ref["losses"], {n: s.to(dev) for n, s in ref["scales"].items()}),
        TT_LOSS_RTOL)
    for name, s in scales.items():
        require(bool((s != initial[name]).all()),
                f"13b {name}: some layer's scale did not move")
    report["update_rel_err"] = _update_err(
        scales, {n: s.to(dev) for n, s in ref["scales"].items()}, initial)
    require(max(report["update_rel_err"].values()) <= TT_UPDATE_RTOL,
            f"13b: the scale updates are off tp=1's by "
            f"{report['update_rel_err']}")

    # One step from the initial scales on a fresh optimizer: its gradients
    # against tp=1's; then its wall, device time and top kernels (both
    # ranks trace their own process; they share the card), and the
    # collectives it calls, each timed alone at its shape.
    fresh = {n: s.clone().requires_grad_() for n, s in initial.items()}
    step = make_distill_step(cfg, dcfg, b, f, c, fresh,
                             make_optimizer(fresh, dcfg), mesh=mesh)
    grads = _first_grads(step, fresh, batch)
    report["grad_rel_err"] = {
        n: ((grads[n] - g.to(dev)).abs().max() / g.abs().max()).item()
        for n, g in ref["grads"].items()}
    require(max(report["grad_rel_err"].values()) <= TT_GRAD_RTOL,
            f"13b: the first step's gradients are off tp=1's by "
            f"{report['grad_rel_err']}")
    del grads
    torch.cuda.synchronize()
    calls0 = _collective_calls()
    dist.barrier()
    t0 = time.perf_counter()
    step(batch)
    torch.cuda.synchronize()
    report["step_wall_ms"] = (time.perf_counter() - t0) * 1e3
    report["collectives_per_step"] = {
        n: v - calls0[n] for n, v in _collective_calls().items()}
    from torch.profiler import ProfilerActivity, profile

    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        step(batch)
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    rows = sorted(((getattr(e, "device_time_total", 0.0), e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    report["step_device_ms"] = sum(r[0] for r in rows) / 1e3
    report["step_top"] = [{"kernel": k[:80], "ms": us / 1e3, "count": n}
                          for us, n, k in rows[:8]]
    # Every model-axis sum of the step moves one (rows, S, hidden) bf16
    # activation: the residual after o_proj / down_proj and the embedding
    # forward, the norms' inputs to the column-parallel layers backward.
    x = torch.ones((TT_BATCH, TT_LEN, cfg.hidden_size), dtype=torch.bfloat16,
                   device=dev)
    times = []
    for _ in range(10):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        collectives.psum(x, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    report["allreduce_ms"] = statistics.median(times[2:])
    # The step's other two sums (the loss over the model axis, the scale
    # gradients over it) move a few bytes each.
    per_step = report["collectives_per_step"]
    report["activation_collectives_per_step"] = (
        per_step["reduce_from_model"] + per_step["copy_to_model"]
        + per_step["psum"] - 2)
    report["collective_ms_per_step"] = (
        report["allreduce_ms"] * report["activation_collectives_per_step"])
    del step, fresh

    # 13c, tensor-parallel: the same world's shards at (1, 2).
    sp = student_params(b, c)
    t0 = time.perf_counter()
    with counted(launches):
        ppl = eval_ppl(cfg, sp, tokens.numpy(), deltas=c.deltas, mesh=mesh,
                       **ppl_kw)
    report["ppl_1x2"] = {"ppl": ppl, "rel_err": abs(ppl - ref["ppl"])
                         / ref["ppl"], "s": time.perf_counter() - t0}
    require(report["ppl_1x2"]["rel_err"] <= TT_PPL_RTOL,
            f"13c eval_ppl at (1, 2): {report['ppl_1x2']} against one "
            f"process's {ref['ppl']}")
    del b, f, c, sp, got
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches


def _train_rank(rank, store, out_dir):
    """One rank of phase 13 (a spawned process): 13a, then 13b and 13c.
    Writes its report, launches and any error to
    ``out_dir/rank{rank}.json``."""
    import datetime
    import traceback

    import torch.distributed as dist

    from bitdelta_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": rank}
    try:
        pmesh.initialize_multihost(
            f"file://{store}", TP_RANKS, rank, device="cuda",
            timeout=datetime.timedelta(seconds=TP_COLLECTIVE_TIMEOUT_S))
        out["backend"] = dist.get_backend()
        dev = torch.device("cuda")
        meshes = {s: pmesh.make_mesh(s) for s in ((1, 2), (2, 1))}
        smi = smi_line()
        t0 = time.perf_counter()
        out["tiny_launches"] = {k: 0 for k in KERNELS}
        out["tiny"] = train_tiny(dev, meshes, out["tiny_launches"])
        out["tiny_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["70b"], out["70b_launches"] = train_70b(dev, meshes, rank, smi)
        out["70b_s"] = time.perf_counter() - t0
        out["ok"] = True
        dist.barrier()
        dist.destroy_process_group()
    except Exception:                  # reported to the parent, which fails
        out["ok"] = False
        out["error"] = traceback.format_exc()[-4000:]
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    sys.stdout.flush()
    sys.exit(0 if out["ok"] else 1)


def train_cli_mesh(dev):
    """13d: ``cli.train --mesh 1,2 --save_full_model`` under
    ``torch.distributed.run`` on a tiny fp32 HF pair written here (each
    rank reading its own blocks of it), against ``--mesh 1,1``: the
    artifacts' words bit-exact and scales within 1e-5, written by rank 0
    alone, both ranks exiting 0; the exported model (rank 0 reads the base
    one tensor at a time as it writes) byte for byte the file
    ``save_full_model`` writes of the whole base fused with the run's own
    ``diff.safetensors``, and within 1e-5 of ``--mesh 1,1``'s export."""
    import dataclasses
    import filecmp
    import os

    from bitdelta_torch.core.artifact import load_delta, read_safetensors
    from bitdelta_torch.core.compress import fuse_compressed
    from bitdelta_torch.core.export import save_full_model
    from bitdelta_torch.models import llama
    from bitdelta_torch.models.hf_import import load_hf_params
    from bitdelta_torch.utils import compiled_check as cc

    cfg = dataclasses.replace(cc.tp_check_config(), max_seq_len=256)
    gen = torch.Generator(device=dev).manual_seed(83)
    base = llama.init_params(cfg, gen, scale=0.25, device=dev)
    fine = synthetic_finetune(cfg, base, gen, scale=0.05)
    repo = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(repo), HF_HUB_OFFLINE="1")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_hf_checkpoint(cfg, base, Path(tmp) / "base", shards=1)
        write_hf_checkpoint(cfg, fine, Path(tmp) / "fine", shards=1)
        common = ["-m", "bitdelta_torch.cli.train", "--base_model",
                  str(Path(tmp) / "base"), "--finetuned_model",
                  str(Path(tmp) / "fine"), "--num_steps", "3",
                  "--batch_size", "2", "--max_length", "16",
                  "--dataset_name", "synthetic", "--dtype", "float32",
                  "--kernel", "cuda", "--device", dev.type,
                  "--save_full_model"]
        runs = {"1x1": [sys.executable, *common, "--mesh", "1,1"],
                "1x2": [sys.executable, "-m", "torch.distributed.run",
                        "--nproc-per-node", "2", "--master-addr",
                        "127.0.0.1", "--master-port", str(free_port()),
                        *common, "--mesh", "1,2"]}
        # Both runs at once (three processes on the card): most of each
        # run is its processes starting.
        t0 = time.perf_counter()
        procs = {label: subprocess.Popen(
            cmd + ["--save_dir", str(Path(tmp) / label)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for label, cmd in runs.items()}
        outs = {}
        try:
            for label, proc in procs.items():
                outs[label] = proc.communicate(timeout=600)
                report[f"mesh_{label}_s"] = time.perf_counter() - t0
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        saved = {}
        for label, proc in procs.items():
            out, err = outs[label]
            out_dir = Path(tmp) / label
            require(proc.returncode == 0,
                    f"train --mesh {label} exited {proc.returncode}: "
                    + out[-2000:] + err[-2000:])
            report[f"mesh_{label}_saved_lines"] = out.count("saved ")
            require(report[f"mesh_{label}_saved_lines"] == 1,
                    f"train --mesh {label}: not one rank wrote")
            require(sorted(os.listdir(out_dir)) == [
                "calibrated_model", "diff.safetensors",
                "diff_untrained.safetensors"],
                f"train --mesh {label} wrote {os.listdir(out_dir)}")
            saved[label] = {name: read_safetensors(str(out_dir / name))[0]
                            for name in os.listdir(out_dir)
                            if name.endswith(".safetensors")}
            saved[label]["calibrated_model"] = read_safetensors(
                str(out_dir / "calibrated_model" / "model.safetensors"))[0]
        # The meshed run's export against the whole base fused with its
        # own deltas, written by save_full_model here.
        _, base = load_hf_params(str(Path(tmp) / "base"), cfg, torch.float32,
                                 dev)
        comp, _ = load_delta(str(Path(tmp) / "1x2" / "diff.safetensors"), dev)
        save_full_model(cfg, fuse_compressed(base, comp),
                        str(Path(tmp) / "want"))
        report["export_bytes_equal"] = filecmp.cmp(
            Path(tmp) / "want" / "model.safetensors",
            Path(tmp) / "1x2" / "calibrated_model" / "model.safetensors",
            shallow=False)
        require(report["export_bytes_equal"],
                "13d: train --mesh 1,2's export differs from save_full_model"
                " of the whole base and its own deltas")
        del base, comp
    worst = export_worst = 0.0
    for name, want in saved["1x1"].items():
        got = saved["1x2"][name]
        require(set(got) == set(want), f"13d {name}: other tensors")
        for key, w in want.items():
            if name == "calibrated_model":
                # Fused with scales 1e-7 apart: within 1e-5 of each
                # tensor's largest value.
                err = float(abs(got[key] - w).max() / abs(w).max())
                export_worst = max(export_worst, err)
                require(err <= 1e-5, f"13d export {key}: {err}")
            elif key.endswith(".scale"):
                err = float(abs(got[key] - w).max() / abs(w).max())
                worst = max(worst, err)
                require(err <= 1e-5, f"13d {name} {key}: {err}")
            else:
                require((got[key] == w).all(), f"13d {name} {key} differs")
    report["scale_rel_err"] = worst
    report["export_rel_err"] = export_worst
    return report


def tp_train(dev, smi):
    """Phase 13: 13a-c on two spawned ranks, then 13d."""
    t_phase = time.perf_counter()
    reports = _spawn_ranks(_train_rank, "13")
    for rep in reports:
        for part, kernels in (("tiny_launches", PATHS["train"]),
                              ("70b_launches", PATHS["train"])):
            for kname in kernels:
                require(rep[part].get(kname, 0) > 0,
                        f"13 rank {rep['rank']} {part}: {kname} never "
                        f"launched")
    launches = {k: sum(rep["tiny_launches"][k] + rep["70b_launches"][k]
                       for rep in reports) for k in KERNELS}
    for rep in reports:
        emit({"phase": "tp_train_tiny", "rank": rep["rank"],
              "backend": rep["backend"], "seconds": rep["tiny_s"],
              **rep["tiny"], "launches": rep["tiny_launches"]})
        emit({"phase": "tp_train_70b", "seconds": rep["70b_s"],
              **rep["70b"], "launches": rep["70b_launches"]})
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli_report = train_cli_mesh(dev)
    emit({"phase": "tp_train_cli", "card": smi,
          "seconds": time.perf_counter() - t0, **cli_report})
    emit({"phase": "tp_train", "card": smi,
          "seconds": time.perf_counter() - t_phase,
          "launches": {k: v for k, v in launches.items() if v}})
    return launches


# ---------------------------------------------------------------------------

def _timing_keys(res):
    return {key: res[key] for key in ("max_abs_err", "ms", "kernel_ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "library_ms")}


def main(argv=None):
    import dataclasses

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
    from bitdelta_torch.models.mixtral import mixtral_8x7b

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
    serve_cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS)
    # Each stack is handed over without another reference, so the
    # engine's pair-layout copy replaces the canonical deltas.
    serve_counts, report["serving"] = serve(
        serve_cfg, build_world(serve_cfg, dev), dev, name)
    gc.collect()
    torch.cuda.empty_cache()
    density_counts, report["density"] = serve(
        serve_cfg, build_world(serve_cfg, dev, base_quant="int4"), dev,
        name, path="density", kv_dtype="int8")
    gc.collect()
    torch.cuda.empty_cache()
    report["parity"] = []
    for run in PARITY_RUNS:
        report["parity"].append(parity(cfg, dev, *run))
        gc.collect()
        torch.cuda.empty_cache()
    report["parity"].append(fused_step_parity(cfg, dev))
    gc.collect()
    torch.cuda.empty_cache()
    report["parity"].append(mixtral_parity(mixtral_8x7b(), dev))
    gc.collect()
    torch.cuda.empty_cache()
    train_counts, report["train"] = train(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["train_parity"] = train_parity(cfg, dev)
    gc.collect()
    torch.cuda.empty_cache()
    canon_counts, mixtral_counts, report["mixtral"] = mixtral(dev, name)
    gc.collect()
    torch.cuda.empty_cache()
    fused_canon_counts, fused_counts, report["fused"] = fused(dev, name)
    gc.collect()
    torch.cuda.empty_cache()
    cli_counts, report["cli"] = cli(dev, name)
    gc.collect()
    torch.cuda.empty_cache()
    rest_counts = rest(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tp_counts = tp(dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    tp_train_counts = tp_train(dev, smi)
    kernels = []
    for kname, (_, source, replaces) in KERNELS.items():
        res = checks[kname]
        by_path = {"serving": serve_counts[kname],
                   "density": density_counts[kname],
                   "train": train_counts[kname],
                   "mixtral": mixtral_counts[kname],
                   "mixtral_canonical": canon_counts[kname],
                   "fused": fused_counts[kname],
                   "fused_canonical": fused_canon_counts[kname],
                   "cli": cli_counts[kname],
                   "rest": rest_counts[kname],
                   "tp": tp_counts[kname],
                   "tp_train": tp_train_counts[kname]}
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path}
        entry.update(_timing_keys(res))
        if kname == "flash_decode_attention":
            # Row 2's int8-cache branch, checked and timed on its own.
            entry["kernel"] = " + ".join(DECODE_KERNELS)
            entry["int8"] = _timing_keys(
                checks["flash_decode_attention_int8"])
        if kname in ("flash_decode_attention", "flash_prefill_attention"):
            # Rows 2 and 4 at one query head a KV head (phase 11b's).
            entry["group1"] = _timing_keys(res["group1"])
            # And at eight query heads a KV head (phase 12b's).
            entry["group8"] = _timing_keys(res["group8"])
        if kname == "tenant_delta_matmul_pair":
            # Row 1: the x prep and the integer MMA product, timed apart.
            entry["kernel"] = " + ".join(PAIR_KERNELS)
            entry["prep_ms"] = res["prep_ms"]
            entry["main_ms"] = res["main_ms"]
            entry["queued_ms"] = res["queued_ms"]
        if kname == "tenant_delta_matmul":
            # Row 7: the x prep and the integer MMA product, timed apart
            # and queued; B = 130 on its own.
            entry["kernel"] = " + ".join(CANON_KERNELS)
            entry["prep_ms"] = res["prep_ms"]
            entry["main_ms"] = res["main_ms"]
            entry["queued_ms"] = res["queued_ms"]
            entry["b130"] = res["b130"]
        if kname == "fused_base_pair_matmul":
            # Row 10: bf16 through row 1's prep and the tensor-core kernel,
            # timed apart and queued; fp32 on the CUDA-core kernel.
            entry["kernel"] = " + ".join(FUSED_PAIR_KERNELS)
            entry["prep_ms"] = res["prep_ms"]
            entry["main_ms"] = res["main_ms"]
            entry["queued_ms"] = res["queued_ms"]
            entry["fp32_kernel"] = " + ".join(FUSED_PAIR_FP32_KERNELS)
            entry["fp32"] = dict(_timing_keys(res["fp32"]),
                                 kernel=res["fp32"]["kernel"])
        if kname == "fused_tenant_matmul":
            # Row 9: bf16 on the tensor-core kernel, timed and queued; fp32
            # on the CUDA-core kernel and its split sum.
            entry["kernel"] = FUSED_TENANT_TC_KERNEL
            entry["queued_ms"] = res["queued_ms"]
            entry["per_tenant_ms"] = res["per_tenant_ms"]
            entry["fp32_kernel"] = " + ".join(FUSED_TENANT_FP32_KERNELS)
            entry["fp32"] = dict(_timing_keys(res["fp32"]),
                                 kernel=res["fp32"]["kernel"])
        if kname == "tenant_dense_matmul":
            # Row 3: bf16 on the tensor-core kernel (also at B=1 and B=64,
            # beside one matmul a tenant); the fp32 head on its own.
            entry["kernel"] = DENSE_TC_KERNEL
            entry["queued_ms"] = res["queued_ms"]
            entry["per_tenant_ms"] = res["per_tenant_ms"]
            entry["other_b"] = res["other_b"]
            entry["fp32"] = dict(
                _timing_keys(checks["tenant_dense_matmul_fp32"]),
                kernel=" + ".join(DENSE_CORE_KERNELS))
        if kname == "w4_matmul":
            # Row 8: bf16 on the tensor cores; the fp32 branch on its own.
            entry["kernel"] = W4_TC_KERNEL
            entry["fp32"] = dict(_timing_keys(checks["w4_matmul_fp32"]),
                                 kernel=W4_FP32_KERNEL)
        if kname in ("binary_matmul", "binary_matmul_t"):
            # Rows 5 and 6 held at a 70B tp=2 rank's shapes (untimed).
            entry["tp70"] = res["tp70"]
        if kname == "flash_prefill_attention":
            # Row 4: bf16 on the tensor cores; the fp32 branch on its own.
            entry["kernel"] = PREFILL_TC_KERNEL
            entry["fp32"] = dict(
                _timing_keys(checks["flash_prefill_attention_fp32"]),
                kernel=PREFILL_FP32_KERNEL)
        kernels.append(entry)
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
