"""Run one cell of the benchmark once and print its result line.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1``
installs the harness's wrappers, profiles part of the window and reports
the per-layer metrics whose end-to-end metric the cell reports. The last
line of standard output is one JSON object; the last lines of standard
error give each number compared with its limit. A run exits non-zero
and prints no result without enough CUDA cards, or when a module of the
JAX package (or JAX, Flax, transformers or safetensors) was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bitdelta_tpu", "transformers",
             "safetensors")
UNITS = {"output_tok_s": "tokens/s", "distill_tok_s": "tokens/s",
         "ttft_p90_ms": "ms", "tpot_p90_ms": "ms", "setup_s": "s"}
SMI_QUERY = "name,power.limit,clocks.sm,clocks.mem,temperature.gpu,power.draw"


def process_start() -> float:
    """This process's start on the monotonic clock (Linux: both count
    from boot), or now where /proc has no answer."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T_START = process_start()


def fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def smi() -> dict:
    """One ``nvidia-smi`` reading of card 0 (name, power limit, clocks,
    temperature, draw); empty where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_QUERY}",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    keys = SMI_QUERY.split(",")
    reading = {}
    for k, v in zip(keys, vals):
        try:
            reading[k] = v if k == "name" else float(v)
        except ValueError:
            reading[k] = v
    return reading


class Context:
    """What a driver gets: the cell's configuration and mix, the seed, the
    window's length, the device, the probe (``--trace 1`` only) and the
    places to put what it measured."""

    def __init__(self, cell: dict, cfg: dict, mix: dict, seed: int,
                 seconds: float, device, trace: bool):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds, self.device = seed, seconds, device
        self.t_start = T_START
        self.probe = None
        if trace:
            from .probe import Probe
            self.probe = Probe()
        self.window = None          # monotonic (start, end) of the window
        self.memory_peak = 0
        self.smi = []
        self._smi_threads = []
        self.marks = []             # (what, seconds since process start)

    def mark(self, what: str) -> None:
        """Note how far set-up has come, for standard error."""
        self.marks.append((what, time.monotonic() - self.t_start))

    def setup_s(self, t0: float) -> float:
        return t0 - self.t_start

    def sample_smi(self) -> None:
        """Read nvidia-smi in the background, beside the window."""
        if self.device.type != "cuda":
            return
        th = threading.Thread(target=lambda: self.smi.append(smi()),
                              daemon=True)
        th.start()
        self._smi_threads.append(th)

    def hold_window(self, t0: float) -> float:
        """Sleep through the window that starts at ``t0``, reading
        nvidia-smi at its start, middle and end, and under ``--trace 1``
        profiling a stretch in its middle third. Returns its end."""
        t1 = t0 + self.seconds
        self.window = (t0, t1)
        self.sample_smi()
        mid = t0 + self.seconds / 3
        time.sleep(max(0.0, mid - time.monotonic()))
        if self.probe is not None:
            with self.probe.profile():
                time.sleep(min(4.0, self.seconds / 3))
        else:
            self.sample_smi()
        time.sleep(max(0.0, t1 - time.monotonic()))
        self.sample_smi()
        return t1

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            import torch
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)

    def join_smi(self) -> None:
        for th in self._smi_threads:
            th.join(timeout=60)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def per_layer(ctx: Context, result: dict) -> dict:
    """Every reader under ``metrics/`` whose end-to-end metric this cell
    reports, and that found something to read."""
    out = {}
    ctx.probe.reduce()
    e2e = set(result["metrics"])
    for path in sorted((ROOT / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        mod = load_module(path)
        if mod.MOVES not in e2e:
            continue
        value = mod.read(ctx, result)
        if value is not None:
            out[path.stem] = {"value": value, "unit": mod.UNIT}
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import world

    try:
        cell = world.load_json("workloads", args.workload)
    except FileNotFoundError:
        fail(f"unknown workload {args.workload!r}")
    cfg = world.load_json("configs", cell["config"])
    mix = world.load_json("traffic", cell["traffic"])

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        fail(f"needs {cell['chips']} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    ctx = Context(cell, cfg, mix, args.seed, args.seconds, device,
                  bool(args.trace))
    driver = load_module(ROOT / "drivers" / f"{mix['driver']}.py")
    result = driver.run(ctx)
    ctx.join_smi()
    bad = forbidden_modules()
    if bad:
        fail(f"loaded forbidden modules: {', '.join(bad)}", 3)
    emit(ctx, cell, result, bool(args.trace))


def emit(ctx: Context, cell: dict, result: dict, trace: bool) -> None:
    import torch

    smi_keys = {"power_limit_w": "power.limit", "clocks_sm_mhz": "clocks.sm",
                "clocks_mem_mhz": "clocks.mem",
                "temperature_c": "temperature.gpu",
                "power_draw_w": "power.draw"}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    for key, smi_key in smi_keys.items():
        vals = [r[smi_key] for r in ctx.smi if isinstance(r.get(smi_key),
                                                          float)]
        if vals:
            device[key] = vals
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"]}
    if trace:
        tr = ctx.probe.reduce()
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["metrics"] = per_layer(ctx, result)
        line["breakdown"] = {"device_ops": tr.device_ops(),
                             "idle_gaps": tr.idle_gaps()}
    else:
        line["metrics"] = {k: {"value": v, "unit": UNITS[k]}
                           for k, v in result["metrics"].items()}
    line["device"] = device
    line.update(result.get("extra", {}))
    line["checks"] = result["checks"]
    print("set-up: " + ", ".join(f"{w} {t:.1f} s" for w, t in ctx.marks),
          file=sys.stderr)
    if trace:
        print("end-to-end readings of this traced run (not reported): "
              + json.dumps(result["metrics"]), file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
