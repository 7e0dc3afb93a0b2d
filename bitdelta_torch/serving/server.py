"""Multi-tenant HTTP serving API (port of
``bitdelta_tpu/serving/server.py``; same routes and NDJSON lines):

  GET  /          -> browser page (serving/frontend.py)
  GET  /models    -> {"models": [tenant names]}
  GET  /stats     -> engine slots, memory and decode rate
  POST /generate  -> NDJSON stream; body:
       {"prompt": str | "messages": [{role, content}, ...],
        "tenant": name-or-index | omitted = broadcast to ALL tenants,
        "max_new_tokens": int, "temperature": float, "top_k", "top_p"}

Each streamed line is ``{"tenant": name, "token_id": int, "text": str,
"done": bool}``. Stdlib ``http.server`` (threaded); one stepper thread
drives ``engine.pump()`` for every in-flight request.
"""

from __future__ import annotations

import itertools
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Sequence

from .engine import Engine, EngineFullError, Request, StepEvent

log = logging.getLogger(__name__)


class ByteTokenizer:
    """Dependency-free tokenizer (1 byte = 1 token; offset to keep 0 free
    as padding)."""

    vocab_size = 258
    eos_token_id = 257

    def encode(self, text: str) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - 1 for i in ids
                     if 1 <= i <= 256).decode("utf-8", errors="replace")


def render_chat(tokenizer, messages: List[dict], system_prompt: str = ""
                ) -> str:
    if hasattr(tokenizer, "apply_chat_template"):
        return tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True)
    parts = [system_prompt] if system_prompt else []
    for m in messages:
        parts.append(f"{m['role']}: {m['content']}")
    parts.append("assistant:")
    return "\n".join(parts)


class TenantInfo:
    def __init__(self, name: str, tokenizer, stop_token_ids=(),
                 system_prompt: str = ""):
        self.name = name
        self.tokenizer = tokenizer
        self.stop_token_ids = tuple(stop_token_ids)
        if not self.stop_token_ids:
            eos = getattr(tokenizer, "eos_token_id", None)
            if eos is not None:
                self.stop_token_ids = (eos,)
        self.system_prompt = system_prompt


class ServingApp:
    """Engine + tenant metadata + request orchestration. One stepper
    thread drives ``engine.pump()`` for ALL in-flight requests; each
    stream consumes its own event queue, so concurrent clients share the
    device batch."""

    def __init__(self, engine: Engine, tenants: List[TenantInfo]):
        if engine.stack.num_tenants != len(tenants):
            raise ValueError("tenant metadata count != stacked tenants")
        self.engine = engine
        self.tenants = tenants
        self._mu = threading.Lock()          # queue map
        self._slot_free = threading.Condition(self._mu)
        self._queues: Dict[str, "queue.Queue"] = {}   # request_id -> q
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._reqid = itertools.count()
        self.admission_timeout = 300.0       # seconds to wait for a slot
        self._stepper = threading.Thread(target=self._step_loop,
                                         daemon=True, name="engine-stepper")
        self._stepper.start()

    def close(self) -> None:
        """Stop the stepper thread."""
        self._stop.set()
        self._wake.set()
        self._stepper.join(timeout=60)

    def _step_loop(self):
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            try:
                events = self.engine.pump()
            except Exception:  # noqa: BLE001 — the stepper must not die:
                # a dead stepper would wedge every stream on q.get().
                log.exception("engine.pump failed")
                with self._mu:
                    for rid, q in list(self._queues.items()):
                        q.put(StepEvent(slot=-1, request_id=rid, token=-1,
                                        finished=True, finish_reason="error",
                                        new_token=False))
                    self._queues.clear()
                    for s in self.engine.slots:
                        s.active = False
                self._wake.clear()
                continue
            with self._mu:
                finished_any = False
                for ev in events:
                    finished_any |= ev.finished
                    q = self._queues.get(ev.request_id)
                    if q is not None:
                        q.put(ev)
                        if ev.finished:
                            self._queues.pop(ev.request_id, None)
                if finished_any:
                    self._slot_free.notify_all()
            busy = (any(s.active for s in self.engine.slots)
                    or self.engine._inflight)
            if not busy:
                # Clear-then-recheck: an admission activates its slot
                # before setting _wake, so no wakeup is lost.
                self._wake.clear()
                if any(s.active for s in self.engine.slots):
                    self._wake.set()

    def resolve_tenant(self, spec) -> int:
        if spec is None:
            raise ValueError("tenant required")
        if isinstance(spec, int):
            if not 0 <= spec < len(self.tenants):
                raise ValueError(f"tenant index {spec} out of range")
            return spec
        for i, t in enumerate(self.tenants):
            if t.name == spec:
                return i
        raise ValueError(f"unknown tenant {spec!r}")

    def model_names(self) -> List[str]:
        return [t.name for t in self.tenants]

    def _prompt_ids(self, tenant: TenantInfo, body: dict) -> List[int]:
        if "prompt" in body:
            text = body["prompt"]
        elif "messages" in body:
            text = render_chat(tenant.tokenizer, body["messages"],
                               tenant.system_prompt)
        else:
            raise ValueError("need 'prompt' or 'messages'")
        return list(tenant.tokenizer.encode(text))

    def generate_stream(self, body: dict):
        """Yields NDJSON lines. Without 'tenant' every tenant answers the
        same conversation (broadcast)."""
        max_new = int(body.get("max_new_tokens", 128))
        temp = float(body.get("temperature", 0.0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 1.0))
        if body.get("tenant") is not None:
            tenant_ids = [self.resolve_tenant(body["tenant"])]
        else:
            tenant_ids = list(range(len(self.tenants)))

        reqs, metas = [], []
        for tid in tenant_ids:
            tn = self.tenants[tid]
            reqs.append(Request(
                prompt_ids=self._prompt_ids(tn, body), tenant_id=tid,
                max_new_tokens=max_new, temperature=temp,
                top_k=top_k, top_p=top_p,
                stop_token_ids=tn.stop_token_ids))
            metas.append(tn)

        eng = self.engine
        q: "queue.Queue" = queue.Queue()
        rid_to_i: Dict[str, int] = {}
        texts = [""] * len(reqs)
        gens: List[List[int]] = [[] for _ in reqs]
        first_lines: List[str] = []
        deadline = time.monotonic() + self.admission_timeout
        try:
            for i, r in enumerate(reqs):
                r.request_id = f"req{next(self._reqid)}"
                # Register the queue BEFORE submitting so no event for
                # this request is emitted into the void.
                with self._mu:
                    self._queues[r.request_id] = q
                    rid_to_i[r.request_id] = i
                while True:
                    try:
                        eng.submit(r)
                        break
                    except EngineFullError:
                        with self._mu:
                            remaining = deadline - time.monotonic()
                            if remaining <= 0:
                                raise RuntimeError(
                                    "engine full (timed out waiting for "
                                    "a free slot)")
                            self._slot_free.wait(
                                timeout=min(0.25, remaining))
                self._wake.set()
                first = r.first_token
                if first not in metas[i].stop_token_ids:
                    gens[i].append(first)
                    texts[i] = metas[i].tokenizer.decode(gens[i])
                    first_lines.append(json.dumps(
                        {"tenant": metas[i].name, "token_id": first,
                         "text": texts[i], "done": False}) + "\n")
        except Exception:
            with self._mu:
                for rid in rid_to_i:
                    self._queues.pop(rid, None)
            raise
        try:
            yield from first_lines
            while rid_to_i:
                ev = q.get()
                i = rid_to_i.get(ev.request_id)
                if i is None:
                    continue
                is_stop = ev.finished and ev.finish_reason == "stop"
                if ev.new_token and not is_stop:
                    gens[i].append(ev.token)
                    texts[i] = metas[i].tokenizer.decode(gens[i])
                yield json.dumps({"tenant": metas[i].name,
                                  "token_id": ev.token,
                                  "text": texts[i],
                                  "done": ev.finished}) + "\n"
                if ev.finished:
                    del rid_to_i[ev.request_id]
        finally:
            # Client gone mid-stream: stop routing events and cancel.
            if rid_to_i:
                with self._mu:
                    for rid in rid_to_i:
                        self._queues.pop(rid, None)
                for rid in rid_to_i:
                    eng.cancel(rid)


def make_http_server(app: ServingApp, host: str = "0.0.0.0",
                     port: int = 8000) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, ctype: str, payload: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                from .frontend import INDEX_HTML

                self._send(200, "text/html; charset=utf-8",
                           INDEX_HTML.encode())
            elif self.path == "/models":
                self._send(200, "application/json", json.dumps(
                    {"models": app.model_names()}).encode())
            elif self.path == "/stats":
                from .stacking import stack_nbytes

                eng = app.engine
                self._send(200, "application/json", json.dumps({
                    "slots_total": eng.max_slots,
                    "slots_free": len(eng.free_slots()),
                    "max_seq": eng.max_seq,
                    "kernel": eng.kernel,
                    "device": str(eng.device),
                    "tenants": app.model_names(),
                    "memory_bytes": stack_nbytes(eng.stack),
                    "decode": eng.timer.summary(),
                    "decode_chunk": eng.decode_chunk,
                }).encode())
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                self.send_error(400, "bad json")
                return
            try:
                stream = app.generate_stream(body)
                first = next(stream)
            except (ValueError, RuntimeError) as e:
                self._send(400, "application/json",
                           json.dumps({"error": str(e)}).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            try:
                self.wfile.write(first.encode())
                self.wfile.flush()
                for line in stream:
                    self.wfile.write(line.encode())
                    self.wfile.flush()
            except BrokenPipeError:
                pass

    return ThreadingHTTPServer((host, port), Handler)
