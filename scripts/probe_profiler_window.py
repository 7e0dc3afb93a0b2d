#!/usr/bin/env python3
"""How often torch.profiler loses device records of a short trace, with
and without host time padded around the work, on one CUDA card.

Run from the repository root on a machine with a card::

    python3 scripts/probe_profiler_window.py [--traces 400] [--pad 0.005]

Two short workloads (five int8 -> bf16 casts of a W8 expert stack's
size, (8, 4096, 14336); three (512, 4096) x (4096, 1024) bf16 matmuls)
are traced ``--traces`` times each, alternating a trace that opens and
closes right at the work with one that sleeps ``--pad`` seconds on the
host before the work and after its synchronize (as
``chip_smoke.trace_entries`` does). A trace is lost when it holds fewer
kernel launches than the workload made. Prints one JSON line.
"""

import argparse
import json
import sys
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=400)
    ap.add_argument("--pad", type=float, default=0.005)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_profiler_window: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-127, 127, (8, 4096, 14336), generator=gen,
                      dtype=torch.int8, device=dev)
    a = torch.randn((512, 4096), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((4096, 1024), generator=gen, device=dev).to(torch.bfloat16)
    work = {"cast5": (lambda: [q.to(torch.bfloat16) for _ in range(5)], 5),
            "matmul3": (lambda: [a @ b for _ in range(3)], 3)}

    def launches(run, pad):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            run()
            torch.cuda.synchronize()
            time.sleep(pad)
        return sum(e.count for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0) > 0)

    out = {"device": torch.cuda.get_device_name(0), "traces": args.traces,
           "pad_s": args.pad}
    for name, (run, want) in work.items():
        run()
        for pad in (0.0, args.pad):
            out[f"{name}_pad{pad}_lost"] = 0
    for _ in range(args.traces):
        for name, (run, want) in work.items():
            for pad in (0.0, args.pad):
                out[f"{name}_pad{pad}_lost"] += int(launches(run, pad) != want)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
