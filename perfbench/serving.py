"""What the serving drivers share: the program's serving stack built from
the seed's inputs, clients that stream through
``ServingApp.generate_stream``, the warm-up through the served path, and
the comparison of served tokens with the plain reference."""

from __future__ import annotations

import gc
import json
import sys
import threading
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import stats, world
from .reference import decoder


class IdTokenizer:
    """The tenants' tokenizer: a prompt travels as its token ids written
    out in decimal, and decoded text has one character a token (the
    synthetic vocabulary has no text). No stop token: a request ends at
    its ``max_new_tokens``."""

    eos_token_id = None

    def encode(self, text: str) -> List[int]:
        return [int(t) for t in text.split()]

    def decode(self, ids) -> str:
        return "x" * len(ids)


class Record:
    """One request as its client saw it: monotonic seconds of its due
    time, of its send and of each served token's arrival."""

    def __init__(self, req: dict, due: float):
        self.req, self.due = req, due
        self.sent: Optional[float] = None
        self.tokens: List[int] = []
        self.stamps: List[float] = []
        self.done = False
        self.error: Optional[str] = None

    @property
    def ttft(self) -> float:
        return self.stamps[0] - self.due

    @property
    def tpot(self) -> Optional[float]:
        if len(self.stamps) < 2:
            return None
        return (self.stamps[-1] - self.stamps[0]) / (len(self.stamps) - 1)


def model_module(cfg: dict):
    from bitdelta_torch.models import llama, mixtral

    return mixtral if world.shapes(cfg)["experts"] else llama


def model_config(cfg: dict):
    """The program's config, read from the published ``config.json`` keys
    by the program's own importer."""
    from bitdelta_torch.models.config import ModelConfig
    from bitdelta_torch.models.mixtral import MixtralConfig

    hf = SimpleNamespace(**cfg["config"])
    if world.shapes(cfg)["experts"]:
        return MixtralConfig.from_hf_config(hf)
    return ModelConfig.from_hf_config(hf)


def make_stack(cfg: dict, seed: int, device):
    """The serving stack of the seed's inputs in the program's types: the
    base (W8 leaves as ``Int8Weight``), the tenants' canonical deltas,
    norms, embeds and heads. The engine derives its layout from it."""
    from bitdelta_torch.core.delta import BinaryDelta
    from bitdelta_torch.research.quantized_base import Int8Weight
    from bitdelta_torch.serving.stacking import TenantStack

    layers = {name: Int8Weight(*leaf) if isinstance(leaf, tuple) else leaf
              for name, leaf in world.base_leaves(cfg, seed, device).items()}
    ex = world.tenant_extras(cfg, seed, device)
    layers["attn_norm"], layers["mlp_norm"] = ex["attn_norm"], ex["mlp_norm"]
    params = {"embed": ex["embed"], "lm_head": ex["lm_head"],
              "final_norm": ex["final_norm"], "layers": layers}
    deltas = {name: BinaryDelta(packed=w, scale=s)
              for name, (w, s) in world.deltas(cfg, seed, device).items()}
    t = cfg["assumed"]["tenants"]
    vocab = torch.full((t,), world.shapes(cfg)["vocab"], dtype=torch.int32,
                       device=device)
    return TenantStack(params=params, deltas=deltas, vocab_sizes=vocab,
                       num_tenants=t)


def build_app(cfg: dict, mix: dict, seed: int, device):
    """``ServingApp`` over an ``Engine`` with the mix's engine settings
    (the kernel route is the engine's default for the device)."""
    from bitdelta_torch.serving.engine import Engine
    from bitdelta_torch.serving.server import ServingApp, TenantInfo

    e = mix["engine"]
    engine = Engine(model_config(cfg), make_stack(cfg, seed, device),
                    max_slots=e["max_slots"], max_seq=e["max_seq"],
                    prefill_buckets=e["prefill_buckets"],
                    decode_chunk=e["decode_chunk"], device=device,
                    model=model_module(cfg))
    tenants = [TenantInfo(f"tenant{i}", IdTokenizer())
               for i in range(cfg["assumed"]["tenants"])]
    return ServingApp(engine, tenants)


def stream(app, rec: Record, stop: threading.Event) -> None:
    """Send ``rec``'s request and read its stream to the end, or until
    ``stop`` is set (the stream is then closed, which cancels it)."""
    req = rec.req
    body = {"prompt": " ".join(map(str, req["prompt"])),
            "tenant": req["tenant"], "temperature": 0.0,
            "max_new_tokens": req["max_new_tokens"]}
    rec.sent = time.monotonic()
    gen = app.generate_stream(body)
    try:
        n_text = 0
        for line in gen:
            now = time.monotonic()
            msg = json.loads(line)
            # A finish-only line repeats the last token: its text is as
            # long as before.
            if len(msg["text"]) > n_text:
                n_text = len(msg["text"])
                rec.tokens.append(msg["token_id"])
                rec.stamps.append(now)
            if msg["done"]:
                rec.done = True
                return
            if stop.is_set():
                return
    except Exception as e:  # noqa: BLE001 — a failed request is counted
        rec.error = repr(e)
    finally:
        gen.close()


def wait_first(get_record) -> None:
    """Wait until ``get_record()`` is a record with its first token (or an
    error)."""
    while True:
        rec = get_record()
        if rec is not None and (rec.stamps or rec.error):
            return
        time.sleep(0.005)


def warm(app, mix: dict, vocab: int) -> None:
    """One request a prefill bucket the mix's prompts fall in, each long
    enough for two decode chunks: the shapes the window will run, through
    the served path."""
    lo = mix["prompt_tokens"]["min"]
    hi = mix["prompt_tokens"]["max"]
    buckets = mix["engine"]["prefill_buckets"]
    chunk = mix["engine"]["decode_chunk"]
    stop = threading.Event()
    prev = 0
    for b in buckets:
        if b >= lo and prev < hi:
            n = max(min(b, hi, app.engine.max_seq - 2 * chunk - 2), 1)
            rec = Record({"tenant": 0, "prompt": [1 + i % (vocab - 1)
                                                  for i in range(n)],
                          "max_new_tokens": 2 * chunk + 1}, time.monotonic())
            stream(app, rec, stop)
            if rec.error:
                raise RuntimeError(f"warm-up request failed: {rec.error}")
        prev = b


def release() -> None:
    """Return what the dropped program state held to the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def free(app) -> None:
    """Stop the stepper and drop the program's state from the card."""
    app.close()
    app.engine.stack = None
    app.engine.cache = None
    release()


def sample(records: List[Record], seed: int, min_tokens: int,
           max_requests: int) -> List[Record]:
    """Records to compare, drawn from the seed: the one with the most
    served tokens, then others at random until ``min_tokens`` served
    tokens or ``max_requests`` requests."""
    pool = sorted((r for r in records if len(r.tokens) >= 2),
                  key=lambda r: (-len(r.tokens), r.req["index"]))
    if not pool:
        return []
    chosen, rest = [pool[0]], pool[1:]
    order = np.random.default_rng(world.leaf_seed(seed, "sample")
                                  ).permutation(len(rest))
    for i in order:
        if (sum(len(r.tokens) for r in chosen) >= min_tokens
                or len(chosen) >= max_requests):
            break
        chosen.append(rest[i])
    return chosen


def gaps(ref: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """At each position, how far the reference's logit of the token
    picked there lies below the reference's best."""
    return ref.max(-1).values - ref.gather(1, picks[:, None])[:, 0]


SHARE_OVER = (0.05, 0.1, 0.2, 0.5)


def gap_numbers(g: torch.Tensor) -> Dict[str, float]:
    """The widest and the mean gap, and the share of positions whose gap
    is over each of ``SHARE_OVER``."""
    out = {"max_gap": float(g.max()), "mean_gap": float(g.mean())}
    for tau in SHARE_OVER:
        out[f"share_over_{tau}"] = float((g > tau).float().mean())
    return out


def served_gap(cfg: dict, seed: int, records: List[Record], device,
               precision: str = "fp32") -> Dict[str, float]:
    """:func:`gap_numbers` of the served tokens (:func:`gaps`) over the
    records, the reference teacher-forced on each prompt and its served
    tokens. With another ``precision`` also those of the tokens that the
    control, the reference in that precision, puts first at the same
    positions (``control_`` before each name)."""
    seqs = [{"tenant": r.req["tenant"],
             "tokens": r.req["prompt"] + r.tokens[:-1],
             "start": len(r.req["prompt"]) - 1} for r in records]
    ref = decoder.served_logits(cfg, seed, seqs, device)
    served = torch.cat([gaps(x, torch.as_tensor(r.tokens, device=device))
                        for x, r in zip(ref, records)])
    out = {**gap_numbers(served), "tokens_compared": int(served.numel())}
    if precision != "fp32":
        ctl = decoder.served_logits(cfg, seed, seqs, device, precision)
        picked = torch.cat([gaps(x, c.argmax(-1)) for x, c in zip(ref, ctl)])
        out.update({f"control_{k}": v
                    for k, v in gap_numbers(picked).items()})
    return out


def install_probes(probe, engine) -> None:
    """The harness's wrappers of a traced serving run (``probe.py``)."""
    from bitdelta_torch.models import llama, mixtral
    from bitdelta_torch.ops import binary_gemm

    probe.span(engine, "submit", "submit",
               extra=lambda e, req: len(req.prompt_ids))
    probe.span(engine, "pump", "pump",
               extra=lambda e: sum(s.active for s in e.slots))
    probe.steps(engine)
    probe.record(binary_gemm, "tenant_delta_matmul_pair", "row1",
                 lambda x, pairs, colsum, scales, ids, **kw: {
                     "ids": ids, "k": x.shape[1], "n": pairs.shape[-1] * 2,
                     "x_bytes": x.element_size()})
    probe.record(binary_gemm, "binary_matmul", "row5",
                 lambda x, packed, scale, **kw: {
                     "m": getattr(probe.local, "info", None) or x.shape[0],
                     "k": x.shape[1], "n": packed.shape[1],
                     "x_bytes": x.element_size()})
    for mod in (llama, mixtral):
        probe.record(mod, "flash_decode_attention", "row2",
                     lambda q, k, v, lengths, window=None, **kw: {
                         "lengths": lengths, "heads": q.shape[1],
                         "kv_heads": k.shape[2], "head_dim": q.shape[2],
                         "kv_bytes": k.element_size(),
                         "q_bytes": q.element_size(), "window": window})


def tokens_in(records: List[Record], t0: float, t1: float) -> float:
    """Output tokens produced in ``[t0, t1)`` over every stream
    (``stats.tokens_produced``)."""
    return sum(stats.tokens_produced(r.stamps, t0, t1) for r in records)


def finish(ctx, records: List[Record], candidates: List[Record], t0: float,
           t1: float, metrics: dict, attempted=None) -> dict:
    """The run's result: the requests sent in the window (``attempted``
    unless given) and those of them that failed, and the comparison of a
    sample of ``candidates`` with the plain reference, once the program's
    state is off the card: each of the cell's ``limits`` names a number
    of :func:`served_gap`. ``correct`` needs every one within its limit
    and no request that failed."""
    if attempted is None:
        attempted = [r for r in records
                     if r.sent is not None and t0 <= r.sent < t1]
    failed = [r for r in attempted if r.error is not None]
    errors = [r for r in records if r.error is not None]
    for err in sorted({r.error for r in errors})[:3]:
        print(f"request error: {err[:500]}", file=sys.stderr)
    chosen = sample(candidates, ctx.seed, ctx.mix["compare_tokens"],
                    ctx.mix["compare_requests"])
    limits = ctx.cell["limits"]
    got = (served_gap(ctx.cfg, ctx.seed, chosen, ctx.device) if chosen
           else {"tokens_compared": 0})
    checks = {k: {"value": got.get(k), "limit": v} for k, v in limits.items()}
    checks["tokens_compared"] = {"value": got["tokens_compared"],
                                 "limit": ctx.mix["compare_tokens"]}
    checks["request_errors"] = {"value": len(errors), "limit": 0}
    correct = bool(chosen) and not errors and all(
        checks[k]["value"] <= v for k, v in limits.items())
    return {"correct": correct, "attempted": len(attempted),
            "failed": len(failed), "metrics": metrics,
            "extra": {"gaps": got},
            "checks": checks,
            "layer": {"records": records, "window": (t0, t1),
                      "compared": chosen, "gaps": got}}
