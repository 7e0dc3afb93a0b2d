"""Multi-tenant continuous-batching generation engine (port of
``bitdelta_tpu/serving/engine.py``, single device, llama family, bf16
cache).

* ``max_slots`` decode lanes share one KV cache; each slot carries its
  own tenant id, length, sampling params and stop set;
* requests are admitted into free slots at any time (prefill into the
  slot's cache region) and leave when finished — continuous batching;
* decode runs in chunks of ``decode_chunk`` steps for the whole batch:
  tenant-routed 1-bit delta matmuls, per-tenant embeddings / norms /
  heads, per-slot sampling with per-tenant vocab masking, and stop ids
  checked on the device (``DEVICE_STOPS``) so a lane that stops is parked
  in place; one host sync per chunk reads its tokens back;
* prefill pads prompts to a small set of bucket lengths; single requests
  (``submit``) prefill alone, bursts (``generate``) prefill together and
  defer the first-token readback to the next chunk.

PyTorch runs eagerly, so JAX's ``jax.jit`` wrappers, ``_CompileOnce`` and
the compile locks have no counterpart here; the chunk's device
``while_loop`` is a Python loop over ``decode_step``. The cache is
updated in place, so every cache mutation (a chunk, an admission's
insert) happens under the engine lock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device, torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from .sampling import sample_tokens
from .stacking import TenantStack, to_pair_layout

NEG_INF = float("-inf")

# Stop-token ids checked ON DEVICE inside the chunk (per slot; -1 pads).
# Requests with more stop ids still stop correctly — the host re-check
# catches the rest — but their lanes may run on to the chunk's end.
DEVICE_STOPS = 4


class EngineFullError(RuntimeError):
    """No free slot for an admission (distinct from device errors)."""


@dataclasses.dataclass
class Request:
    prompt_ids: List[int]
    tenant_id: int
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: int = 0          # 0 = disabled
    top_p: float = 1.0      # 1.0 = disabled
    stop_token_ids: Sequence[int] = ()
    request_id: Optional[str] = None
    # Set at admission (the prefill-logits token).
    first_token: Optional[int] = None
    # Set when cancel() consumed this request mid-prefill.
    cancelled: bool = False


@dataclasses.dataclass
class SlotState:
    active: bool = False
    reserved: bool = False   # claimed by an in-flight prefill
    tenant_id: int = 0
    request: Optional[Request] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    prompt_len: int = 0
    # Batched admission defers the first-token readback; while True,
    # ``generated`` is one shorter than the tokens produced.
    pending_first: bool = False
    # Bumped at every admission: a chunk ticket only delivers tokens to
    # the request it was dispatched for.
    epoch: int = 0


@dataclasses.dataclass
class _ChunkTicket:
    """One dispatched chunk: ``toks`` (k, B) tokens (-1 where a lane was
    parked) — a host tensor filled asynchronously until ``ready`` (a CUDA
    event, None on the CPU) completes — and the slot-requests and step
    count it was dispatched for."""
    toks: torch.Tensor
    ready: Optional[torch.cuda.Event]
    active: np.ndarray
    epochs: np.ndarray
    steps: int


@dataclasses.dataclass
class StepEvent:
    slot: int
    request_id: Optional[str]
    token: int
    finished: bool
    finish_reason: Optional[str] = None  # "stop" | "length"
    # False for finish-only events whose token was already delivered.
    new_token: bool = True


class StepTimer:
    """Rolling decode step-time / tokens-per-second meter (host clock
    around each chunk readback)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list = []
        self.tokens: list = []

    def add(self, seconds: float, tokens: int) -> None:
        self.times.append(seconds)
        self.tokens.append(tokens)
        if len(self.times) > self.window:
            self.times.pop(0)
            self.tokens.pop(0)

    def summary(self) -> Dict[str, float]:
        total = sum(self.times)
        return {"mean_step_time_s": total / max(len(self.times), 1),
                "tokens_per_sec": sum(self.tokens) / total if total else 0.0,
                "steps_measured": len(self.times)}


class Engine:
    def __init__(self, cfg: ModelConfig, stack: TenantStack, *,
                 max_slots: int = 8, max_seq: int = 1024,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512, 1024),
                 kernel: str = "auto", compute_dtype=None, seed: int = 0,
                 decode_chunk: int = 1, device="cuda"):
        """``kernel``: ``"cuda"`` (the hand-written kernels; on CPU
        tensors their plain versions), ``"torch"`` (plain paths), or
        ``"auto"`` (``"cuda"`` on a CUDA device). ``device``: where the
        cache lives; the stack must already be there."""
        self.device = resolve_device(device)
        if kernel == "auto":
            kernel = "cuda" if self.device.type == "cuda" else "torch"
        if kernel not in ("cuda", "torch"):
            raise ValueError(f"unknown kernel {kernel!r}")
        if stack.vocab_sizes.device.type != self.device.type:
            raise ValueError(f"stack lives on {stack.vocab_sizes.device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.kernel = kernel
        # Decode hot path: pair-packed delta layout (prefill un-pairs on
        # the fly); same bytes as the canonical layout.
        self.stack = to_pair_layout(stack) if kernel == "cuda" else stack
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_buckets = sorted(b for b in prefill_buckets
                                      if b <= max_seq)
        self.compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
        self.decode_chunk = max(1, int(decode_chunk))

        self.slots = [SlotState() for _ in range(max_slots)]
        self.cache = llama.init_cache(cfg, max_slots, max_seq,
                                      self.compute_dtype, self.device)
        self._stop_ids = np.full((max_slots, DEVICE_STOPS), -1, np.int32)
        self.tenant_ids = np.zeros((max_slots,), np.int32)
        self.temps = np.zeros((max_slots,), np.float32)
        self.top_ks = np.zeros((max_slots,), np.int32)
        self.top_ps = np.ones((max_slots,), np.float32)
        self._last_tokens = np.zeros((max_slots,), np.int32)
        # Per-lane decode state (tokens, live, rem) carried ON DEVICE
        # between chunks; _dirty marks lanes whose host state changed
        # since the last dispatch and so override the carry.
        self._dirty = np.ones((max_slots,), bool)
        self._dev_tokens = None
        self._dev_live = None
        self._dev_rem = None
        # Batched admission's sampled first tokens, still on the device.
        self._pending_firsts = None
        # Finish events from a deferred-firsts flush, drained into the
        # next step()/pump() return.
        self._flush_events: List[StepEvent] = []
        self._inflight: List[_ChunkTicket] = []
        self._step_mutex = threading.Lock()   # serializes dispatch/consume
        self._batch_mutex = threading.Lock()  # serializes batched admission
        self._lock = threading.Lock()         # host state + cache mutation
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._cancelled: set = set()          # rids cancelled mid-prefill
        self.timer = StepTimer()

    # ------------------------------------------------------------------
    # Device functions
    # ------------------------------------------------------------------

    def _t(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype,
                               device=self.device)

    def _prefill(self, tokens: np.ndarray, lengths: np.ndarray,
                 tenant_ids: np.ndarray, temps, top_ks, top_ps):
        """Prefill rows, sample each row's first token. Returns
        ``(first (B,) int32 on device, rowcache)``; the row cache holds
        ``tokens.shape[1]`` slots (the bucket)."""
        tok = self._t(tokens, torch.int64)
        lens = self._t(lengths, torch.int32)
        tids = self._t(tenant_ids, torch.int64)
        with torch.no_grad():
            logits, rowcache = llama.forward(
                self.cfg, self.stack.params, tok, lengths=lens,
                deltas=self.stack.deltas, tenant_ids=tids,
                compute_dtype=self.compute_dtype, return_cache=True,
                cache_max_seq=tokens.shape[1], kernel=self.kernel)
            rows = torch.arange(tok.shape[0], device=self.device)
            last = logits[rows, lens.to(torch.int64) - 1].to(torch.float32)
            vmask = (torch.arange(last.shape[-1], device=self.device)[None]
                     < self.stack.vocab_sizes[tids][:, None])
            last = torch.where(vmask, last, torch.full_like(last, NEG_INF))
            first = sample_tokens(self._gen, last,
                                  self._t(temps, torch.float32),
                                  self._t(top_ks, torch.int32),
                                  self._t(top_ps, torch.float32))
        return first, rowcache

    def _insert(self, rowcache, rows, slots, lengths) -> None:
        """Copy prefilled rows into engine slots (under ``_lock``)."""
        n = rowcache.k.shape[2]
        src = torch.as_tensor(rows, device=self.device)
        dst = torch.as_tensor(slots, device=self.device)
        self.cache.k[:, dst, :n] = rowcache.k[:, src]
        self.cache.v[:, dst, :n] = rowcache.v[:, src]
        self.cache.length[dst] = self._t(lengths, torch.int32)

    def _parked(self, live: torch.Tensor, probe) -> bool:
        """True once the host can see, WITHOUT waiting for the device,
        that every lane is parked: on the CPU directly; on the card from
        a non-blocking copy of an earlier step's flag whose event has
        completed (a lagging, never-blocking probe)."""
        if self.device.type != "cuda":
            return not bool(live.any())
        return (probe is not None and probe[1].query()
                and not bool(probe[0]))

    def _run_chunk(self, steps: int, k: int, tokens, live_in, rem_in,
                   set_mask, set_tokens, set_live, set_rem):
        """Up to ``steps`` decode+sample steps (of a ``k``-row token
        buffer) with stop detection on the device: a lane that samples a
        stop id or exhausts ``rem`` is parked (its cache length frozen,
        -1 tokens after), and the loop ends once every lane is parked.
        Returns ``(toks (k, B), tokens, live, rem)``."""
        bsz = self.max_slots
        tenant_ids = self._t(self.tenant_ids, torch.int64)
        temps = self._t(self.temps, torch.float32)
        top_ks = self._t(self.top_ks, torch.int32)
        top_ps = self._t(self.top_ps, torch.float32)
        stop_ids = self._t(self._stop_ids, torch.int32)
        tokens = torch.where(set_mask[:, None], set_tokens[:, None], tokens)
        rem = torch.where(set_mask, set_rem, rem_in)
        live = torch.where(set_mask, set_live, live_in) & (rem > 0)
        toks = torch.full((k, bsz), -1, dtype=torch.int32,
                          device=self.device)
        vmask = (torch.arange(self.stack.params["embed"].shape[-2],
                              device=self.device)[None]
                 < self.stack.vocab_sizes[tenant_ids][:, None])
        probe = None
        with torch.no_grad():
            for i in range(steps):
                if self._parked(live, probe):
                    break
                old_len = self.cache.length
                logits, cache = llama.decode_step(
                    self.cfg, self.stack.params, tokens.to(torch.int64),
                    self.cache, deltas=self.stack.deltas,
                    tenant_ids=tenant_ids, compute_dtype=self.compute_dtype,
                    kernel=self.kernel)
                logits = logits[:, 0].to(torch.float32)
                logits = torch.where(vmask, logits,
                                     torch.full_like(logits, NEG_INF))
                nxt = sample_tokens(self._gen, logits, temps, top_ks, top_ps)
                # Parked / inactive lanes don't advance.
                self.cache = cache._replace(
                    length=torch.where(live, cache.length, old_len))
                toks[i] = torch.where(live, nxt, torch.full_like(nxt, -1))
                rem = torch.where(live, rem - 1, rem)
                hit_stop = (nxt[:, None] == stop_ids).any(dim=1)
                live = live & ~hit_stop & (rem > 0)
                tokens = torch.where(live[:, None], nxt[:, None], tokens)
                if self.device.type == "cuda":
                    flag = live.any().to("cpu", non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record()
                    probe = (flag, ev)
        return toks, tokens, live, rem

    # ------------------------------------------------------------------
    # Host-side scheduling
    # ------------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if not s.active and not s.reserved]

    def cancel(self, request_id: Optional[str]) -> bool:
        """Stop generating for ``request_id`` and free its slot. A request
        whose prefill is in flight is cancelled at admission completion.
        Returns True if anything was (or will be) cancelled."""
        if request_id is None:
            return False
        with self._lock:
            for i, st in enumerate(self.slots):
                if (st.active and st.request is not None
                        and st.request.request_id == request_id):
                    st.active = False
                    self._dirty[i] = True
                    return True
            for st in self.slots:
                if (st.reserved and st.request is not None
                        and st.request.request_id == request_id):
                    self._cancelled.add(request_id)
                    return True
        return False

    def submit(self, req: Request) -> int:
        """Admit a request: prefill its prompt into a free slot. Returns
        the slot. Raises EngineFullError when full. The prefill runs
        outside the engine lock; only the cache insert takes it."""
        self._validate(req)
        with self._lock:
            free = self.free_slots()
            if not free:
                raise EngineFullError("engine full")
            slot = self._pick_slot(free, req.tenant_id)
            self.slots[slot].reserved = True
            self.slots[slot].request = req
        try:
            self._admit(slot, req)
        finally:
            with self._lock:
                st = self.slots[slot]
                st.reserved = False
                if not st.active and st.request is req:
                    st.request = None
                    if req.request_id is not None:
                        self._cancelled.discard(req.request_id)
        return slot

    def _validate(self, req: Request):
        if not (0 <= req.tenant_id < self.stack.num_tenants):
            raise ValueError(
                f"tenant_id {req.tenant_id} out of range "
                f"[0, {self.stack.num_tenants})")
        if not req.prompt_ids:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1 (got {req.max_new_tokens})")
        if len(req.prompt_ids) > self.max_seq - 1:
            raise ValueError(f"prompt too long: {len(req.prompt_ids)} > "
                             f"{self.max_seq - 1}")

    def _bucket(self, n: int) -> int:
        return next((b for b in self.prefill_buckets if b >= n),
                    self.max_seq)

    def _submit_batch(self, reqs: Sequence[Request]):
        """Admit up to ``len(reqs)`` requests with ONE batched prefill and
        no readback (first tokens stay on the device). Returns the
        ``[(slot, request), ...]`` pairs actually activated."""
        for req in reqs:
            self._validate(req)
        with self._lock:
            batch = []
            for req in reqs:
                free = self.free_slots()
                if not free:
                    break
                slot = self._pick_slot(free, req.tenant_id)
                self.slots[slot].reserved = True
                self.slots[slot].request = req
                batch.append((slot, req))
        if not batch:
            return []
        try:
            with self._batch_mutex:
                self._admit_batch(batch)
        finally:
            with self._lock:
                for slot, req in batch:
                    st = self.slots[slot]
                    st.reserved = False
                    if not st.active:
                        st.request = None
                        if req.request_id is not None:
                            self._cancelled.discard(req.request_id)
        return [(s, r) for s, r in batch
                if self.slots[s].active and self.slots[s].request is r]

    def _admit_batch(self, batch):
        # All max_slots rows prefill together (row i == slot i; dummy rows
        # are one token long and not inserted), as in the JAX engine.
        B = self.max_slots
        bucket = max(self._bucket(len(req.prompt_ids)) for _, req in batch)
        tokens = np.zeros((B, bucket), np.int64)
        tokens[:, 0] = 1
        lengths = np.ones((B,), np.int32)
        tids = np.zeros((B,), np.int32)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        for slot, req in batch:
            ids = req.prompt_ids
            tokens[slot, :len(ids)] = ids
            lengths[slot] = len(ids)
            tids[slot] = req.tenant_id
            temps[slot] = req.temperature
            top_ks[slot] = req.top_k
            top_ps[slot] = req.top_p
        # At most one deferred-firsts vector at a time.
        self._flush_pending_firsts()
        first_dev, rowcache = self._prefill(tokens, lengths, tids, temps,
                                            top_ks, top_ps)
        with self._lock:
            slots = []
            for slot, req in batch:
                if (req.request_id is not None
                        and req.request_id in self._cancelled):
                    self._cancelled.discard(req.request_id)
                    req.cancelled = True
                    self.slots[slot].request = None
                    continue
                slots.append(slot)
            if slots:
                self._insert(rowcache, slots, slots, lengths[slots])
            for slot in slots:
                req = self.slots[slot].request
                self._activate(slot, req)
                self.slots[slot].generated = []
                self.slots[slot].pending_first = True
            self._pending_firsts = first_dev

    def _activate(self, slot: int, req: Request) -> None:
        """Slot bookkeeping of an admission (caller holds ``_lock``)."""
        st = self.slots[slot]
        st.active = True
        st.tenant_id = req.tenant_id
        st.request = req
        st.prompt_len = len(req.prompt_ids)
        st.epoch += 1
        self.tenant_ids[slot] = req.tenant_id
        self.temps[slot] = req.temperature
        self.top_ks[slot] = req.top_k
        self.top_ps[slot] = req.top_p
        self._stop_ids[slot] = -1
        ids_dev = list(req.stop_token_ids)[:DEVICE_STOPS]
        self._stop_ids[slot, :len(ids_dev)] = ids_dev
        self._dirty[slot] = True

    def _flush_pending_firsts(self) -> None:
        """Resolve a deferred batched-admission first-token vector: one
        host readback (outside the lock), fill each pending slot's first
        token and run the deferred finish checks. Finish events are
        queued on ``_flush_events``."""
        dev = self._pending_firsts
        if dev is None:
            return
        firsts = dev.cpu().numpy()             # host sync, no lock held
        with self._lock:
            if self._pending_firsts is not dev:
                return                         # concurrent flush won
            self._pending_firsts = None
            events = self._flush_events
            for i, st in enumerate(self.slots):
                if not st.pending_first:
                    continue
                st.pending_first = False
                if not st.active or st.request is None:
                    continue                   # cancelled while pending
                first = int(firsts[i])
                st.request.first_token = first
                st.generated.insert(0, first)
                if len(st.generated) == 1:
                    self._last_tokens[i] = first
                reason = self._finish_checks(i)
                if reason is not None:
                    st.active = False
                    st.epoch += 1              # drop speculated tokens
                    self._dirty[i] = True
                    events.append(StepEvent(
                        slot=i, request_id=st.request.request_id,
                        token=st.generated[-1], finished=True,
                        finish_reason=reason, new_token=False))

    def _drain_flush_events(self) -> List[StepEvent]:
        with self._lock:
            evs, self._flush_events = self._flush_events, []
            return evs

    def _pick_slot(self, free: List[int], tenant_id: int) -> int:
        """Prefer a free slot next to an active slot of the same tenant
        (ties resolve to the lowest slot)."""
        def score(s: int) -> int:
            return sum(
                1 for nb in (s - 1, s + 1)
                if 0 <= nb < self.max_slots and self.slots[nb].active
                and self.slots[nb].tenant_id == tenant_id)
        return max(free, key=score)

    def _admit(self, slot: int, req: Request):
        ids = list(req.prompt_ids)
        tokens = np.zeros((1, self._bucket(len(ids))), np.int64)
        tokens[0, :len(ids)] = ids
        first_dev, rowcache = self._prefill(
            tokens, np.asarray([len(ids)], np.int32),
            np.asarray([req.tenant_id], np.int32),
            [req.temperature], [req.top_k], [req.top_p])
        first = int(first_dev[0])              # the admission's host sync
        req.first_token = first
        with self._lock:
            if (req.request_id is not None
                    and req.request_id in self._cancelled):
                self._cancelled.discard(req.request_id)
                req.cancelled = True
                self.slots[slot].request = None
                return
            self._insert(rowcache, [0], [slot], [len(ids)])
            self._activate(slot, req)
            st = self.slots[slot]
            st.pending_first = False
            st.generated = [first]
            self._last_tokens[slot] = first

    def _finish_checks(self, slot: int) -> Optional[str]:
        st = self.slots[slot]
        if st.pending_first:
            return None                        # deferred to the flush
        req = st.request
        tok = st.generated[-1]
        if tok in req.stop_token_ids:
            return "stop"
        if len(st.generated) >= req.max_new_tokens:
            return "length"
        if st.prompt_len + len(st.generated) >= self.max_seq - 1:
            # One slot of headroom, mirrored in _slot_budget.
            return "length"
        return None

    def _slot_budget(self, slot: int) -> int:
        st = self.slots[slot]
        gen = len(st.generated) + (1 if st.pending_first else 0)
        return min(st.request.max_new_tokens - gen,
                   (self.max_seq - 1) - st.prompt_len - gen)

    def _dispatch_chunk(self):
        """Run ONE chunk for the current host state without reading its
        tokens back. Returns ``(ticket or None, pre_events)``. Lanes the
        host did not touch since the last dispatch continue from the
        device-carried (tokens, live, rem)."""
        with self._lock:
            active = np.asarray([s.active for s in self.slots], bool)
            pre_events: List[StepEvent] = []
            for i in np.nonzero(active)[0]:
                reason = self._finish_checks(int(i))
                if reason is not None:
                    st = self.slots[int(i)]
                    pre_events.append(StepEvent(
                        slot=int(i), request_id=st.request.request_id,
                        token=st.generated[-1], finished=True,
                        finish_reason=reason, new_token=False))
                    st.active = False
                    self._dirty[int(i)] = True
                    active[i] = False
            if not active.any():
                return None, pre_events

            B = self.max_slots
            first = self._dev_tokens is None
            set_mask = np.ones((B,), bool) if first else self._dirty.copy()
            set_rem = np.zeros((B,), np.int32)
            epochs = np.asarray([s.epoch for s in self.slots], np.int64)
            # No lane can use more steps than its remaining budget; a
            # lane carried from in-flight chunks has already spent their
            # steps (or is parked), so the chunk never runs past the
            # point where every lane is out of budget.
            steps = 0
            for i in np.nonzero(active)[0]:
                i = int(i)
                budget = self._slot_budget(i)
                if set_mask[i]:
                    set_rem[i] = budget
                else:
                    budget -= sum(t.steps for t in self._inflight
                                  if t.active[i] and t.epochs[i] == epochs[i])
                steps = max(steps, budget)
            steps = min(self.decode_chunk, max(steps, 0))
            if first:
                carry_tok = torch.zeros((B, 1), dtype=torch.int32,
                                        device=self.device)
                carry_live = torch.zeros((B,), dtype=torch.bool,
                                         device=self.device)
                carry_rem = torch.zeros((B,), dtype=torch.int32,
                                        device=self.device)
            else:
                carry_tok, carry_live, carry_rem = (
                    self._dev_tokens, self._dev_live, self._dev_rem)
            set_tok = self._t(self._last_tokens, torch.int32)
            if self._pending_firsts is not None:
                # Deferred batched-admission firsts feed the chunk
                # device-to-device (no readback on the dispatch path).
                pend = self._t([s.pending_first for s in self.slots],
                               torch.bool)
                set_tok = torch.where(pend, self._pending_firsts, set_tok)
            toks, self._dev_tokens, self._dev_live, self._dev_rem = \
                self._run_chunk(steps, self.decode_chunk, carry_tok,
                                carry_live, carry_rem,
                                self._t(set_mask, torch.bool), set_tok,
                                self._t(active, torch.bool),
                                self._t(set_rem, torch.int32))
            self._dirty[:] = False
            ready = None
            if self.device.type == "cuda":
                toks = toks.to("cpu", non_blocking=True)
                ready = torch.cuda.Event()
                ready.record()
            return _ChunkTicket(toks=toks, ready=ready, active=active,
                                epochs=epochs, steps=steps), pre_events

    def _consume_chunk(self, ticket: _ChunkTicket) -> List[StepEvent]:
        """Read back one chunk's tokens (the only host sync) and apply
        them to host state. Returns per-slot events in generation order."""
        t0 = time.perf_counter()
        # Deferred admission firsts precede this chunk's tokens.
        self._flush_pending_firsts()
        events: List[StepEvent] = self._drain_flush_events()
        if ticket.ready is not None:
            ticket.ready.synchronize()
        toks = ticket.toks.numpy()             # (k, B)
        produced = 0
        with self._lock:
            for i in np.nonzero(ticket.active)[0]:
                i = int(i)
                st = self.slots[i]
                if not st.active or st.epoch != ticket.epochs[i]:
                    continue   # cancelled or re-admitted mid-flight
                for j in range(toks.shape[0]):
                    tok = int(toks[j, i])
                    if tok < 0:
                        raise RuntimeError(
                            f"slot {i}: device parked after {j} tokens but "
                            f"host found no stop/length (budget desync)")
                    st.generated.append(tok)
                    self._last_tokens[i] = tok
                    produced += 1
                    reason = self._finish_checks(i)
                    events.append(StepEvent(
                        slot=i, request_id=st.request.request_id,
                        token=tok, finished=reason is not None,
                        finish_reason=reason))
                    if reason is not None:
                        st.active = False
                        self._dirty[i] = True
                        break  # tokens past the stop are discarded
        self.timer.add(time.perf_counter() - t0, produced)
        return events

    def _idle_flush(self) -> List[StepEvent]:
        """With no chunk to run or read, resolve deferred firsts anyway:
        a request cancelled between batched admission and its first chunk
        leaves ``pending_first`` set with nothing left to clear it, and a
        generate() waiting to reap that slot would spin forever."""
        if self._pending_firsts is None:
            return []
        self._flush_pending_firsts()
        return self._drain_flush_events()

    def step(self) -> List[StepEvent]:
        """One chunk for all active slots, read back at once. In-flight
        chunks left by :meth:`pump` are drained first."""
        with self._step_mutex:
            events: List[StepEvent] = self._drain_flush_events()
            while self._inflight:
                events += self._consume_chunk(self._inflight.pop(0))
            ticket, pre = self._dispatch_chunk()
            events += pre
            if ticket is not None:
                events += self._consume_chunk(ticket)
            else:
                events += self._idle_flush()
            return events

    def pump(self) -> List[StepEvent]:
        """Pipelined :meth:`step`: run the NEXT chunk before reading the
        previous one back, so the readback overlaps device work. The
        first call typically returns no events."""
        with self._step_mutex:
            ticket, events = self._dispatch_chunk()
            events = self._drain_flush_events() + events
            if ticket is not None:
                self._inflight.append(ticket)
            if self._inflight and (ticket is None
                                   or len(self._inflight) > 1):
                events = events + self._consume_chunk(
                    self._inflight.pop(0))
            elif ticket is None:
                events = events + self._idle_flush()
            return events

    def generate(self, requests: Sequence[Request]) -> List[List[int]]:
        """Run all requests to completion with continuous admission
        (batched prefill per burst, pipelined decode). Returns generated
        ids per request (stop token excluded)."""
        pending = list(enumerate(requests))
        outputs: List[Optional[List[int]]] = [None] * len(requests)
        slot_to_req: Dict[int, int] = {}

        def admit_pending():
            while pending and self.free_slots():
                take = min(len(pending), len(self.free_slots()))
                taken = [pending.pop(0) for _ in range(take)]
                admitted = self._submit_batch([r for _, r in taken])
                slot_by_req = {id(r): s for s, r in admitted}
                for idx, r in reversed(taken):
                    if id(r) in slot_by_req:
                        slot_to_req[slot_by_req[id(r)]] = idx
                    elif not r.cancelled:
                        pending.insert(0, (idx, r))
                if len(admitted) < take:
                    return

        admit_pending()
        while slot_to_req:
            for ev in self.pump():
                if ev.finished and ev.slot in slot_to_req:
                    idx = slot_to_req.pop(ev.slot)
                    gen = self.slots[ev.slot].generated
                    if ev.finish_reason == "stop":
                        gen = gen[:-1]  # drop the stop token itself
                    outputs[idx] = gen
            # cancel() deactivates a lane without an event: reap it.
            for s in [s for s in slot_to_req
                      if not self.slots[s].active
                      and not self.slots[s].pending_first
                      and not self.slots[s].reserved]:
                idx = slot_to_req.pop(s)
                if outputs[idx] is None:
                    outputs[idx] = list(self.slots[s].generated)
            admit_pending()
        return outputs
