#!/usr/bin/env python3
"""Sweep the split size, unroll and block size of row 2's kernel
(``bitdelta_torch/csrc/flash_decode.cu``) on one CUDA card.

Run from the repository root on a machine with a card and nvcc::

    python3 scripts/sweep_flash_decode.py

Each variant is the source with ``DEC_CHUNK`` (keys a split),
``DEC_UNROLL`` (keys a thread loads before using any) and
``DEC_THREADS`` replaced; it is built by nvcc under
``bitdelta_torch/build/sweep/`` (git-ignored), loaded in place of the
library, held against the plain version (each (row, head) within 2^-7 of
its largest value, as ``chip_smoke.py`` holds it) and timed from
torch.profiler device time at the B=8 Mistral-7B decode shape (H=32,
KV=8, hd=128, a 2048-slot cache): lengths 2048 … 1 with a bf16 and an
int8 cache, and uniform lengths of 128 and 2048 with a bf16 cache. One
JSON line per variant, times in microseconds.
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
from bitdelta_torch.ops import flash_decode as fd  # noqa: E402
from bitdelta_torch.ops.kv_quant import quantize_kv  # noqa: E402

# (DEC_CHUNK, DEC_UNROLL, DEC_THREADS)
VARIANTS = ((64, 4, 128), (64, 8, 128), (128, 8, 128), (128, 4, 256),
            (64, 2, 128), (128, 16, 128))
B, H, KV, HD, S = 8, 32, 8, 128, 2048


def make_sets(dev, gen, lengths, int8, count):
    sets = []
    for _ in range(count):
        q = torch.randn((B, H, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        k = torch.randn((B, S, KV, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        v = torch.randn_like(k)
        scales = {}
        if int8:
            (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
            scales = dict(k_scale=ks, v_scale=vs)
        sets.append((q, k, v, lengths, scales))
    return sets


def main():
    if not torch.cuda.is_available():
        print("sweep_flash_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    print(cs.smi_line(), flush=True)
    main_len = torch.tensor([2048, 1537, 1024, 777, 512, 300, 64, 1],
                            device=dev, dtype=torch.int32)

    def uniform(n):
        return torch.full((B,), n, device=dev, dtype=torch.int32)

    cases = {"bf16_main": make_sets(dev, gen, main_len, False, 6),
             "int8_main": make_sets(dev, gen, main_len, True, 6),
             "bf16_uniform_128": make_sets(dev, gen, uniform(128), False, 8),
             "bf16_uniform_2048": make_sets(dev, gen, uniform(2048), False,
                                            3)}
    src = (_build.CSRC / "flash_decode.cu").read_text()
    work = _build.BUILD / "sweep"
    work.mkdir(parents=True, exist_ok=True)
    for chunk, unroll, threads in VARIANTS:
        name = f"chunk{chunk}_unroll{unroll}_threads{threads}"
        text = src
        for macro, value in (("DEC_CHUNK", chunk), ("DEC_UNROLL", unroll),
                             ("DEC_THREADS", threads)):
            text = re.sub(rf"constexpr int {macro} = \d+;",
                          f"constexpr int {macro} = {value};", text)
        cu, so = work / f"{name}.cu", work / f"{name}.so"
        cu.write_text(text)
        build = subprocess.run(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC", "-o", str(so), str(cu)],
            capture_output=True, text=True)
        if build.returncode:
            print(json.dumps({"variant": name, "build_failed":
                              (build.stdout + build.stderr)[-2000:]}))
            continue
        _build._libs["flash_decode"] = ctypes.CDLL(str(so))
        fd._SPLIT_KEYS = chunk
        row = {"variant": name}
        for label, sets in cases.items():
            q, k, v, lens, scales = sets[0]
            got = fd.flash_decode_attention(q, k, v, lens, **scales)
            want = fd.flash_decode_attention_plain(q, k, v, lens, **scales)
            torch.cuda.synchronize()
            _, bad = cs.attention_error(got, want, HD)
            ms, _ = cs.device_ms(
                lambda i: fd.flash_decode_attention(*sets[i][:4],
                                                    **sets[i][4]),
                len(sets), f"{name} {label}", cs.DECODE_KERNELS, iters=20)
            row[f"{label}_us"] = ms * 1e3
            row[f"{label}_bad_pairs"] = bad
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
