"""The port's span recorder (``utils/profiling.py::RECORDER``) on the
CPU: its semantics (nesting, the ring's bound, the switch, the
counters), the spans the engine, the server and a distillation step
record and the counts they carry, ``trace()`` writing the spans on the
profiler's clock, and ``/stats``' decode rate fed per pump."""

import json
import os
import sys
import threading
import time
import urllib.request

import pytest
import torch

from bitdelta_torch.core import compress as tcomp
from bitdelta_torch.core.compress import compress_model
from bitdelta_torch.models import llama as tl
from bitdelta_torch.models.config import tiny_test_config
from bitdelta_torch.serving.engine import Engine, EngineFullError, Request
from bitdelta_torch.serving.server import (ServingApp, TenantInfo,
                                           make_http_server)
from bitdelta_torch.serving.stacking import stack_tenants
from bitdelta_torch.train import distill as tdistill
from bitdelta_torch.utils import profiling
from bitdelta_torch.utils.profiling import RECORDER, Recorder, trace


def _world(seed=0, n_tenants=2):
    cfg = tiny_test_config(vocab_size=64, hidden_size=64,
                           intermediate_size=128)
    gen = torch.Generator().manual_seed(seed)
    base = tl.init_params(cfg, gen, torch.float32, scale=0.1, device="cpu")
    fines = []
    for _ in range(n_tenants):
        layers = {n: w + 0.02 * torch.randn(w.shape, generator=gen)
                  if n in tl.PROJ_NAMES else w
                  for n, w in base["layers"].items()}
        fines.append(dict(base, layers=layers))
    return cfg, base, fines


def _engine(decode_chunk=3, max_slots=4):
    cfg, base, fines = _world()
    stack = stack_tenants(cfg, base, [compress_model(base, f) for f in fines],
                          device="cpu")
    return cfg, Engine(cfg, stack, max_slots=max_slots, max_seq=64,
                       prefill_buckets=(16, 64), kernel="torch",
                       compute_dtype=torch.float32, device="cpu",
                       decode_chunk=decode_chunk)


class _SmallTokenizer:
    """Byte tokens folded into the tiny model's vocabulary; no stop."""

    eos_token_id = None

    def encode(self, text):
        return [1 + b % 60 for b in text.encode()]

    def decode(self, ids):
        return "x" * len(ids)


def _app(**kw):
    _, engine = _engine(**kw)
    return ServingApp(engine, [TenantInfo(f"t{i}", _SmallTokenizer())
                               for i in range(2)])


def _since(t0, name, tid=None):
    return [s for s in RECORDER.spans(name, since_ns=t0)
            if tid is None or s.tid == tid]


# -- the recorder ---------------------------------------------------------

def test_spans_nest_per_thread_with_their_parent_and_attributes():
    rec = Recorder()
    with rec.span("outer", request_id="r1") as outer:
        with rec.span("inner") as inner:
            inner.set(tokens=7)
        done = []
        th = threading.Thread(target=lambda: done.append(
            rec.span("other").__enter__()), name="side")
        th.start()
        th.join(timeout=10)
    assert not th.is_alive()
    kept = rec.spans()
    assert [s.name for s in kept] == ["inner", "outer"]
    assert inner.parent is outer and outer.parent is None
    assert inner.attrs == {"tokens": 7}
    assert outer.attrs == {"request_id": "r1"}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert outer.tid == threading.get_native_id()
    assert outer.thread == threading.current_thread().name
    # A span opened on another thread does not take this thread's span
    # as its parent.
    assert done[0].parent is None and done[0].thread == "side"
    assert rec.spans("inner") == [inner]
    assert rec.spans("outer", since_ns=inner.start_ns) == []
    assert rec.spans("outer", until_ns=outer.end_ns) == [outer]


def test_cpu_time_is_the_threads_own_where_asked_for():
    rec = Recorder()
    # Spin until this thread has run 20 ms, however loaded the machine.
    with rec.span("busy", cpu=True) as busy:
        t = time.thread_time_ns()
        while time.thread_time_ns() - t < 20_000_000:
            pass
    with rec.span("asleep", cpu=True) as asleep:
        time.sleep(0.02)
    with rec.span("untimed") as untimed:
        pass
    assert 20_000_000 <= busy.cpu_ns <= busy.end_ns - busy.start_ns + 10**6
    assert asleep.cpu_ns < 5_000_000
    assert asleep.end_ns - asleep.start_ns >= 20_000_000
    assert untimed.cpu_ns is None and "cpu" not in untimed.attrs


def test_ring_keeps_the_newest_spans_and_counts_the_dropped():
    rec = Recorder(capacity=4)
    for i in range(10):
        with rec.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in rec.spans()] == [6, 7, 8, 9]
    assert rec.dropped == 6
    assert profiling.SPAN_CAPACITY >= 1 << 16


def test_threads_lose_no_span_and_no_count():
    rec = Recorder(capacity=1000)
    n_threads, per = 24, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(per):
                with rec.span("w", i=i):
                    rec.count("c")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    assert rec.totals == {"c": n_threads * per}
    assert len(rec.spans()) == 1000
    assert rec.dropped == n_threads * per - 1000
    assert all(s.parent is None for s in rec.spans())


def test_disabled_recorder_records_nothing():
    rec = Recorder()
    rec.enabled = False
    a, b = rec.span("x", request_id="r"), rec.span("y")
    assert a is b                       # one shared no-op context
    with a as span:
        span.set(tokens=3)
    rec.count("engine.tokens", 5)
    assert rec.spans() == [] and rec.totals == {} and rec.dropped == 0
    rec.enabled = True
    with rec.span("z"):
        pass
    rec.count("engine.tokens", 5)
    rec.count("engine.tokens")
    assert [s.name for s in rec.spans()] == ["z"]
    assert rec.totals == {"engine.tokens": 6}


# -- the engine -----------------------------------------------------------

def test_generate_records_pump_dispatch_steps_and_consume():
    cfg, engine = _engine()
    reqs = [Request(prompt_ids=[3, 5, 7, 9][:2 + i], tenant_id=i % 2,
                    max_new_tokens=4 + 3 * i) for i in range(3)]
    totals = dict(RECORDER.totals)
    t0 = time.monotonic_ns()
    out = engine.generate(reqs)
    me = threading.get_native_id()
    pumps = _since(t0, "engine.pump", me)
    dispatches = _since(t0, "engine.dispatch", me)
    steps = _since(t0, "engine.decode_step", me)
    consumes = _since(t0, "engine.consume", me)
    assert pumps and dispatches and steps and consumes
    assert sum(d.attrs["steps"] for d in dispatches) == len(steps)
    # Only the dispatch takes the thread's CPU time.
    assert all(d.cpu_ns is not None for d in dispatches)
    assert all(s.cpu_ns is None for s in steps + pumps + consumes)
    assert all(d.parent.name == "engine.pump" for d in dispatches)
    assert all(s.parent.name == "engine.dispatch" for s in steps)
    assert all(c.parent.name == "engine.pump" for c in consumes)
    assert max(d.attrs["lanes"] for d in dispatches) == 3
    # Each request's first token comes from its prefill, the rest from
    # the decode chunks.
    produced = sum(len(o) - 1 for o in out)
    assert [len(o) for o in out] == [r.max_new_tokens for r in reqs]
    assert sum(c.attrs["tokens"] for c in consumes) == produced
    layers = _since(t0, "model.attention", me)
    assert len(layers) == len(_since(t0, "model.mlp", me))
    assert {s.attrs["layer"] for s in layers} == set(range(cfg.num_layers))
    decode_layers = [s for s in layers if s.parent is not None
                     and s.parent.name == "engine.decode_step"]
    assert len(decode_layers) == cfg.num_layers * len(steps)
    grew = {k: RECORDER.totals.get(k, 0) - totals.get(k, 0)
            for k in RECORDER.totals}
    assert grew["engine.tokens"] == produced
    assert grew["engine.steps"] == len(steps)
    assert grew["engine.rows"] == engine.max_slots * len(steps)
    assert grew["engine.admissions"] == len(reqs)
    assert grew["engine.prompt_tokens"] == sum(len(r.prompt_ids)
                                               for r in reqs)
    # One batched prefill: every slot's row at the bucket.
    assert grew["engine.padded_tokens"] == engine.max_slots * 16


def test_submit_records_each_request_and_its_prefill():
    _, engine = _engine()
    t0 = time.monotonic_ns()
    ids = ["a", "b"]
    for i, rid in enumerate(ids):
        engine.submit(Request(prompt_ids=[1, 2, 3, 4][:3 + i], tenant_id=i,
                              max_new_tokens=3, request_id=rid))
    while any(s.active for s in engine.slots) or engine._inflight:
        engine.pump()
    subs = _since(t0, "engine.submit")
    assert [s.attrs["request_id"] for s in subs] == ids
    assert [s.attrs["prompt_tokens"] for s in subs] == [3, 4]
    assert [s.attrs["bucket"] for s in subs] == [16, 16]
    pre = _since(t0, "engine.prefill")
    assert [p.attrs["request_id"] for p in pre] == ids
    assert [p.parent for p in pre] == subs
    # A refused submit records its span without a bucket.
    full = Engine(engine.cfg, engine.stack, max_slots=1, max_seq=64,
                  prefill_buckets=(16,), kernel="torch",
                  compute_dtype=torch.float32, device="cpu")
    full.submit(Request(prompt_ids=[1], tenant_id=0, max_new_tokens=20))
    t1 = time.monotonic_ns()
    with pytest.raises(EngineFullError):
        full.submit(Request(prompt_ids=[1], tenant_id=0, request_id="c"))
    refused = _since(t1, "engine.submit")
    assert [s.attrs.get("bucket") for s in refused] == [None]


def test_a_disabled_recorder_leaves_the_engine_as_it_was():
    _, engine = _engine()
    reqs = [Request(prompt_ids=[3, 5, 7], tenant_id=i, max_new_tokens=5)
            for i in range(2)]
    want = engine.generate(reqs)
    t0 = time.monotonic_ns()
    RECORDER.enabled = False
    try:
        _, engine = _engine()
        got = engine.generate(reqs)
    finally:
        RECORDER.enabled = True
    assert got == want
    assert _since(t0, None, threading.get_native_id()) == []


# -- the server -----------------------------------------------------------

def test_stats_decode_rate_is_tokens_over_pump_wall():
    app = _app(decode_chunk=2)
    server = make_http_server(app, "127.0.0.1", 0)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        t0 = time.monotonic_ns()
        lines = []

        def client(i):
            lines.append(list(app.generate_stream(
                {"prompt": "ab" * (i + 1), "tenant": i % 2,
                 "max_new_tokens": 7})))

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(3)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=120)
        assert not any(c.is_alive() for c in clients)
        port = server.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        server.shutdown()
        app.close()
    stepper = app._stepper.native_id
    consumes = _since(t0, "engine.consume", stepper)
    produced = sum(c.attrs["tokens"] for c in consumes)
    # Every request streamed its 7 tokens: the first from its prefill.
    assert produced == 3 * 6 == sum(len(ls) - 1 for ls in lines)
    pumps = {c.parent for c in consumes}
    wall = sum(p.end_ns - p.start_ns for p in pumps) / 1e9
    rate = stats["decode"]["tokens_per_sec"]
    assert rate * wall == pytest.approx(produced, rel=0.01)
    assert stats["decode"]["steps_measured"] == sum(
        d.attrs["steps"] for d in _since(t0, "engine.dispatch", stepper))
    routes = _since(t0, "server.route", stepper)
    assert routes and sum(r.attrs["events"] for r in routes) >= produced
    assert stats["totals"]["engine.tokens"] >= produced


def test_a_request_that_waits_for_a_slot_records_its_wait():
    app = _app(max_slots=1)
    try:
        # The one slot is held until the client has begun to wait.
        app.engine.submit(Request(prompt_ids=[1, 2], tenant_id=0,
                                  max_new_tokens=30, request_id="hold"))
        waits = RECORDER.totals.get("server.slot_waits", 0)
        t0 = time.monotonic_ns()
        outs = []
        client = threading.Thread(target=lambda: outs.append(list(
            app.generate_stream({"prompt": "abc", "tenant": 1,
                                 "max_new_tokens": 6}))))
        client.start()
        deadline = time.monotonic() + 60
        while (RECORDER.totals.get("server.slot_waits", 0) == waits
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert app.engine.cancel("hold")
        client.join(timeout=120)
        assert not client.is_alive() and len(outs[0]) == 6
    finally:
        app.close()
    slot_waits = _since(t0, "server.slot_wait")
    assert len(slot_waits) == 1
    assert RECORDER.totals["server.slot_waits"] == waits + 1
    rid = slot_waits[0].attrs["request_id"]
    admitted = [s for s in _since(t0, "engine.submit")
                if s.attrs["request_id"] == rid and "bucket" in s.attrs]
    assert len(admitted) == 1 and admitted[0].parent is slot_waits[0]


# -- distillation ---------------------------------------------------------

def test_distill_step_records_its_four_phases_nested():
    cfg, base, fines = _world()
    comp = compress_model(base, fines[0])
    scales = {n: s.detach().clone().requires_grad_()
              for n, s in tcomp.get_scales(comp).items()}
    dcfg = tdistill.DistillConfig(lr=1e-3, num_steps=4,
                                  compute_dtype="float32", kernel="torch")
    opt = tdistill.make_optimizer(scales, dcfg)
    step = tdistill.make_distill_step(cfg, dcfg, base, fines[0], comp,
                                      scales, opt)
    t0 = time.monotonic_ns()
    batch = torch.randint(1, cfg.vocab_size, (2, 16))
    step(batch)
    step(batch)
    steps = _since(t0, "distill.step")
    assert len(steps) == 2 and all(s.attrs["tokens"] == 32 for s in steps)
    phases = ("distill.teacher", "distill.student", "distill.backward",
              "distill.optimizer")
    for s in steps:
        inside = [p for p in RECORDER.spans(since_ns=s.start_ns,
                                            until_ns=s.end_ns)
                  if p.parent is s]
        assert tuple(p.name for p in inside) == phases
        for a, b in zip(inside, inside[1:]):
            assert a.end_ns <= b.start_ns
    # Each forward's layers nest in its phase.
    mlps = _since(t0, "model.mlp")
    assert len(mlps) == 2 * 2 * cfg.num_layers
    assert {m.parent.name for m in mlps} == {"distill.teacher",
                                            "distill.student"}


def test_distill_scales_records_each_loss_readback():
    cfg, base, fines = _world()
    comp = compress_model(base, fines[0])
    t0 = time.monotonic_ns()
    batches = torch.randint(1, cfg.vocab_size, (3, 2, 8)).numpy()
    _, losses = tdistill.distill_scales(
        cfg, base, fines[0], comp, batches,
        tdistill.DistillConfig(lr=1e-3, num_steps=3,
                               compute_dtype="float32", kernel="torch"))
    reads = _since(t0, "distill.readback")
    steps = _since(t0, "distill.step")
    assert len(reads) == len(steps) == len(losses) == 3
    assert all(s.end_ns <= r.start_ns for s, r in zip(steps, reads))


# -- the trace ------------------------------------------------------------

def test_trace_puts_the_spans_on_the_kernels_clock(tmp_path):
    x, y = torch.randn(8, 8), torch.randn(8, 8)
    reps = 8
    with trace(str(tmp_path / "prof")) as d:
        for i in range(reps):
            with RECORDER.span("test.mm", i=i):
                torch.mm(x, y)
    events = json.load(open(os.path.join(d, "trace.json")))["traceEvents"]
    mms = sorted((e for e in events if e.get("name") == "aten::mm"
                  and e.get("ph") == "X"), key=lambda e: e["ts"])
    spans = sorted((e for e in events if e.get("name") == "test.mm"),
                   key=lambda e: e["ts"])
    assert len(mms) == len(spans) == reps
    assert [s["args"]["i"] for s in spans] == list(range(reps))
    lead = [m["ts"] - s["ts"] for s, m in zip(spans, mms)]
    trail = [s["ts"] + s["dur"] - m["ts"] - m["dur"]
             for s, m in zip(spans, mms)]
    # Each span encloses its op; the tightest within 50 us at each edge
    # (the rest carry the host's own jitter).
    assert min(lead) >= 0 and min(trail) >= 0, (lead, trail)
    assert min(lead) <= 50 and min(trail) <= 50, (lead, trail)
    pid = spans[0]["pid"]
    names = {(e["name"], e["args"]["name"]) for e in events
             if e.get("ph") == "M" and e.get("pid") == pid}
    assert ("process_name", profiling.SPAN_PROCESS) in names
    assert ("thread_name", threading.current_thread().name) in names
    assert spans[0]["tid"] == threading.get_native_id()
