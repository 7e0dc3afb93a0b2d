"""Pure decode: ``lanes`` requests are admitted through ``ServingApp``
during set-up, each asking for more tokens than the window can give, so
every lane decodes through the whole window. The window opens once
every lane has its first token and closes ``--seconds`` later; then the
streams are closed. Reports ``output_tok_s``: the tokens that arrived in
the window over its length. The comparison reads the lanes' streams as
far as they got."""

from __future__ import annotations

import threading
import time

from perfbench import serving, world
from perfbench.generator import Mix


def run(ctx) -> dict:
    cfg, mix = ctx.cfg, ctx.mix
    s = world.shapes(cfg)
    app = serving.build_app(cfg, mix, ctx.seed, ctx.device)
    ctx.mark("engine")
    if ctx.probe is not None:
        serving.install_probes(ctx.probe, app.engine)
    serving.warm(app, mix, s["vocab"])
    ctx.mark("warm-up")
    gen = Mix(mix, ctx.seed, s["vocab"], cfg["assumed"]["tenants"])
    stop = threading.Event()
    records = [serving.Record(gen.request(j), time.monotonic())
               for j in range(mix["lanes"])]
    # Lane k is admitted once lane k - ramp_concurrency has its first
    # token, so the admissions do not all prefill at once.
    threads, lag = [], mix["ramp_concurrency"]
    for k in range(len(records) + lag):
        if k < len(records):
            th = threading.Thread(target=serving.stream,
                                  args=(app, records[k], stop), daemon=True)
            th.start()
            threads.append(th)
        if k >= lag:
            serving.wait_first(lambda: records[k - lag])
    ctx.mark("admissions")
    t0 = time.monotonic()
    setup_s = ctx.setup_s(t0)
    t1 = ctx.hold_window(t0)
    stop.set()
    for th in threads:
        th.join(timeout=300)
    ctx.read_memory_peak()
    serving.free(app)
    return serving.finish(ctx, records, records, t0, t1, {
        "output_tok_s": serving.tokens_in(records, t0, t1) / (t1 - t0),
        "setup_s": setup_s}, attempted=records)
