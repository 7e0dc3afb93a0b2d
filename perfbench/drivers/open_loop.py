"""An open loop: requests are sent at the mix's Poisson arrival times,
whether or not earlier ones are done. Arrivals start ``ramp_s`` before
the window (the ramp is set-up) and stop at its end; the requests due in
the window are measured, each from its due time, and waited for up to
``drain_s`` after it. Reports ``ttft_p90_ms`` (due time to first token)
and ``tpot_p90_ms`` (a request's (last - first token) / (tokens - 1)),
each the 90th percentile over every request due in the window, one that
failed or was not done by the drain counted at the time the drain ended.
Also reports how late the generator sent (``generator_lag_ms``)."""

from __future__ import annotations

import threading
import time

from perfbench import serving, stats, world
from perfbench.generator import Mix


def serve(ctx, app, mix: dict) -> dict:
    """One open-loop window on a warm ``app`` at ``mix``'s rate: the ramp,
    the window and the drain. Returns the records, those due in the
    window and the window's times."""
    cfg = ctx.cfg
    gen = Mix(mix, ctx.seed, world.shapes(cfg)["vocab"],
              cfg["assumed"]["tenants"])
    ramp = mix["ramp_s"]
    offsets = gen.arrivals(ramp + ctx.seconds)
    stop = threading.Event()
    records, threads = [], []
    start = time.monotonic() + 0.05
    t0 = start + ramp

    def dispatch():
        for j, off in enumerate(offsets):
            due = start + off
            time.sleep(max(0.0, due - time.monotonic()))
            rec = serving.Record(gen.request(j), due)
            records.append(rec)
            th = threading.Thread(target=serving.stream,
                                  args=(app, rec, stop), daemon=True)
            th.start()
            threads.append(th)

    sender = threading.Thread(target=dispatch, daemon=True)
    sender.start()
    time.sleep(max(0.0, t0 - time.monotonic()))
    setup_s = ctx.setup_s(t0)
    t1 = ctx.hold_window(t0)
    sender.join()
    due = [r for r in records if t0 <= r.due < t1]
    deadline = t1 + mix["drain_s"]
    while (not all(r.done or r.error for r in due)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    drained = time.monotonic()
    stop.set()
    for th in threads:
        th.join(timeout=300)
    ok = [r for r in due if r.done and not r.error]
    missed = [r for r in due if not (r.done and not r.error)]
    ttft = [r.ttft for r in ok] + [drained - r.due for r in missed]
    tpot = [r.tpot for r in ok if r.tpot is not None]
    tpot += [drained - r.due for r in missed]
    return {"records": records, "due": due, "ok": ok, "missed": missed,
            "t0": t0, "t1": t1, "setup_s": setup_s,
            "ttft": ttft, "tpot": tpot,
            "lag": [r.sent - r.due for r in due if r.sent is not None]}


def run(ctx) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    app = serving.build_app(cfg, mix, ctx.seed, ctx.device)
    ctx.mark("engine")
    if ctx.probe is not None:
        serving.install_probes(ctx.probe, app.engine)
    serving.warm(app, mix, world.shapes(cfg)["vocab"])
    ctx.mark("warm-up")
    w = serve(ctx, app, mix)
    ctx.read_memory_peak()
    serving.free(app)
    lag = w["lag"]
    result = serving.finish(ctx, w["records"], w["ok"], w["t0"], w["t1"], {
        "ttft_p90_ms": stats.percentile(w["ttft"], 90) * 1e3,
        "tpot_p90_ms": stats.percentile(w["tpot"], 90) * 1e3,
        "setup_s": w["setup_s"]}, attempted=w["due"])
    result["failed"] = len(w["missed"])
    result["extra"].update({"requests_due": len(w["due"]),
                       "generator_lag_ms": {
                           "max": max(lag) * 1e3 if lag else None,
                           "p90": stats.percentile(lag, 90) * 1e3
                           if lag else None}})
    return result
