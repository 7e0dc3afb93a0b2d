"""A closed loop: ``clients`` clients each send their next request when
the last one is done. The window opens once every client has its first
token (the ramp is set-up) and closes ``--seconds`` later; then every
stream is closed, which cancels it. Reports ``output_tok_s``: the tokens
that arrived in the window over its length. The comparison samples
every request's served tokens, finished or closed at the window's end."""

from __future__ import annotations

import itertools
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
    mu = threading.Lock()
    records, firsts = [], {}
    clients = mix["clients"]

    def client(k):
        # Client k's r-th request is the mix's request r * clients + k,
        # whichever request ends first.
        for r in itertools.count():
            if stop.is_set():
                return
            rec = serving.Record(gen.request(r * clients + k),
                                 time.monotonic())
            with mu:
                records.append(rec)
                firsts.setdefault(k, rec)
            serving.stream(app, rec, stop)

    # The ramp: client k starts once client k - ramp_concurrency has its
    # first token, so the ramp's admissions do not all prefill at once.
    threads = []
    lag = mix["ramp_concurrency"]
    for k in range(clients + lag):
        if k < clients:
            th = threading.Thread(target=client, args=(k,), daemon=True)
            th.start()
            threads.append(th)
        if k >= lag:
            serving.wait_first(lambda: firsts.get(k - lag))
    ctx.mark("ramp")
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
        "setup_s": setup_s})
