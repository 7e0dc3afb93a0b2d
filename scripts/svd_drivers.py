"""How exact is the fp32 SVD behind ``research.variants.quantize_lora`` on
each route: LAPACK on the CPU and each cuSOLVER driver torch offers on the
card, held against an fp64 SVD of the same matrix. Also times one
Llama-2-7B gate_proj-sized (4096 x 11008) fp32 SVD per card driver.

Inputs (seeded): ``exact`` is a 512 x 384 rank-4 delta plus 1e-5 noise,
where the rank-4 truncation is unique; ``random`` is a 512 x 384 delta of
0.002-scale noise truncated to rank 16. For each route it prints the max
|a @ b - fp64 a @ b| relative to max |fp64 a @ b|, and the largest
relative error of the kept singular values.

    python scripts/svd_drivers.py [--out svd_drivers.json]

Needs a CUDA device for the card routes; on the CPU it prints the LAPACK
row only.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

DRIVERS = (None, "gesvd", "gesvdj", "gesvda")


def truncated(diff, rank, driver=None):
    kw = {} if diff.device.type == "cpu" else {"driver": driver}
    u, s, vt = torch.linalg.svd(diff, full_matrices=False, **kw)
    return (u[:, :rank] * s[:rank]) @ vt[:rank], s[:rank]


def inputs():
    g = torch.Generator().manual_seed(0)
    low = (torch.randn((512, 4), generator=g)
           @ torch.randn((4, 384), generator=g)) * 0.01
    exact = low + torch.randn((512, 384), generator=g) * 1e-5
    rand = torch.randn((512, 384), generator=g) * 0.002
    return {"exact": (exact, 4), "random": (rand, 16)}


def errors(diff, rank, device, driver):
    want, s_want = truncated(diff.double(), rank)
    got, s_got = truncated(diff.to(device), rank, driver)
    got, s_got = got.double().cpu(), s_got.double().cpu()
    return {"ab_rel_err": ((got - want).abs().max()
                           / want.abs().max()).item(),
            "sigma_rel_err": ((s_got - s_want).abs() / s_want).max().item()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    routes = [("cpu", None)]
    if torch.cuda.is_available():
        routes += [("cuda", d) for d in DRIVERS]
    out = {"routes": []}
    for device, driver in routes:
        row = {"device": device, "driver": driver or "default"}
        for name, (diff, rank) in inputs().items():
            row[name] = errors(diff, rank, device, driver)
        out["routes"].append(row)
        print(json.dumps(row), flush=True)
    if torch.cuda.is_available():
        import subprocess

        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
        g = torch.Generator(device="cuda").manual_seed(1)
        big = torch.randn((4096, 11008), generator=g, device="cuda") * 0.002
        out["seconds_4096x11008"] = {}
        for driver in DRIVERS:
            torch.linalg.svd(big[:256, :512], full_matrices=False,
                             driver=driver)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.linalg.svd(big, full_matrices=False, driver=driver)
            torch.cuda.synchronize()
            out["seconds_4096x11008"][driver or "default"] = (
                time.perf_counter() - t0)
        print(json.dumps({"card": out["card"],
                          "seconds_4096x11008": out["seconds_4096x11008"]}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
