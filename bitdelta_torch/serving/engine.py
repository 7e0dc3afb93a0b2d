"""Multi-tenant continuous-batching generation engine (port of
``bitdelta_tpu/serving/engine.py``: the llama family with a bf16 or int8
KV cache, or Mixtral with a bf16 cache; on one device or over a ``(data,
model)`` mesh).

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

Over a mesh (``mesh=``, ``parallel/mesh.py``) every rank runs an engine
on its shard: the weights and deltas split Megatron-style over the model
axis, the cache's slot rows over the data axis and its KV heads over the
model axis. A decode step runs each rank's rows through the model with
its LOCAL head counts and gathers the logits to the whole ``(B, V)`` on
every rank, which then samples the whole batch with the same seeded
generator: every rank's host state stays identical. Admission is the
single-device one: a prefill runs every row on every rank,
tensor-parallel over the model axis, and only the data rank that owns a
slot keeps its row (JAX admits one request at a time under TP, which its
shard_map prefill needs; here every rank replays the same batched
prefill). JAX drives all devices from one controller; here rank 0 is the
controller and the other ranks replay its calls (:meth:`Engine.follow`).
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device, torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from ..parallel.collectives import (all_gather, axis_index, axis_size,
                                    broadcast_object)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sharding import (check_stack_shard, check_stack_tp,
                                 local_config, shard_stack)
from ..utils.profiling import RECORDER, StepTimer
from .sampling import sample_tokens
from .stacking import StackShard, TenantStack, stack_to, to_pair_layout

NEG_INF = float("-inf")

# Stop-token ids checked ON DEVICE inside the chunk (per slot; -1 pads).
# Requests with more stop ids still stop correctly — the host re-check
# catches the rest — but their lanes may run on to the chunk's end.
DEVICE_STOPS = 4

# A follower waits on the control channel for as long as the leader's
# server stays idle.
FOLLOW_TIMEOUT = datetime.timedelta(days=365)


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
    event, None on the CPU) completes — the slot-requests and step count
    it was dispatched for, the steps it ran (fewer once every lane
    parked) and, once read back, the tokens it produced."""
    toks: torch.Tensor
    ready: Optional[torch.cuda.Event]
    active: np.ndarray
    epochs: np.ndarray
    steps: int
    ran: int
    produced: int = 0


@dataclasses.dataclass
class StepEvent:
    slot: int
    request_id: Optional[str]
    token: int
    finished: bool
    finish_reason: Optional[str] = None  # "stop" | "length"
    # False for finish-only events whose token was already delivered.
    new_token: bool = True


def _replicated(method):
    """An engine call that mutates state. Over a mesh of more than one
    rank, rank 0 broadcasts ``(name, args, kwargs)`` to the followers
    before it runs the call, under one lock, so every rank runs the same
    calls in the same order (their collectives then pair up); a call made
    from inside another (``generate`` submits and pumps) is not sent."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        if self._ctl is None:
            return method(self, *args, **kwargs)
        with self._op_lock:
            if self._op_depth == 0 and self.rank == 0:
                broadcast_object((method.__name__, args, kwargs),
                                 group=self._ctl)
            self._op_depth += 1
            try:
                return method(self, *args, **kwargs)
            finally:
                self._op_depth -= 1
    return call


def _count_admissions(n: int, prompt_tokens: int, padded: int) -> None:
    RECORDER.count("engine.admissions", n)
    RECORDER.count("engine.prompt_tokens", prompt_tokens)
    RECORDER.count("engine.padded_tokens", padded)


class Engine:
    def __init__(self, cfg: ModelConfig, stack: TenantStack, *,
                 max_slots: int = 8, max_seq: int = 1024,
                 prefill_buckets: Sequence[int] = (64, 128, 256, 512, 1024),
                 kernel: str = "auto", compute_dtype=None, seed: int = 0,
                 decode_chunk: int = 1, device="cuda",
                 kv_dtype: Optional[str] = None, model=None, mesh=None):
        """``kernel``: ``"cuda"`` (the hand-written kernels; on CPU
        tensors their plain versions), ``"cuda_fused"`` (the same, with
        base and delta in one kernel at each decode projection over a
        dense base), ``"torch"`` (plain paths), or ``"auto"`` (``"cuda"``
        on a CUDA device). The stack's ``vocab_sizes`` mask each tenant's
        logits (a compressed-embedding stack has the base's vocabulary). ``device``: where the
        cache lives; the stack must already be there. ``kv_dtype``:
        ``"int8"`` for the int8 KV cache (half the decode-time cache
        traffic under ``kernel="cuda"``, twice the capacity); None,
        ``"bf16"`` or ``"bfloat16"`` for a cache of the compute dtype.
        The stack's base projections may be dense, ``Int8Weight`` or
        ``Int4Weight`` (research/quantized_base.py). ``model``: the
        decoder module to serve, anything with ``forward`` /
        ``decode_step`` of the llama signatures (default
        :mod:`..models.llama`; :mod:`..models.mixtral` for multi-tenant
        MoE serving, whose cache stays bf16).

        ``mesh``: a ``(data, model)`` DeviceMesh (``parallel/mesh.py``)
        over the ranks that serve together, each of which builds its
        engine from the same whole stack in the same order; the engine
        keeps this rank's shard (``parallel/sharding.py::shard_stack``,
        after ``to_pair_layout(tp=)`` on a kernel route) and drops its
        reference to the rest. Over a mesh the stack may stay on the
        host: each leaf's shard alone is then copied to ``device``, so no
        rank's card ever holds the whole stack. A ``StackShard``
        (``stacking.load_stack_shard``) is this rank's shard already,
        marked as such by its type: the engine checks its shapes against
        the whole stack's it carries, pairs it in place with
        ``to_pair_layout(local=True, in_place=True)`` (the engine takes
        over the loaded shard: each canonical projection gives way to its
        pair layout, so a rank never holds both; a later engine on the
        same ``StackShard`` finds it paired) and moves it to ``device``,
        and the checks below run on the whole stack's sizes. ``max_slots`` must split over the data
        axis and the KV heads, query heads and padded vocabulary over the
        model axis (every route runs the same per-rank code here; JAX
        needs the last two on its Pallas route only), and a W4
        row-parallel K into whole 128-row groups a rank. Rank 0 takes the
        calls; the other ranks run :meth:`follow`."""
        self.device = resolve_device(device)
        if kernel == "auto":
            kernel = "cuda" if self.device.type == "cuda" else "torch"
        if kernel not in llama.CARD_KERNELS + ("torch",):
            raise ValueError(f"unknown kernel {kernel!r}")
        shard = isinstance(stack, StackShard)
        if shard:
            if mesh is None:
                raise ValueError("a StackShard is served over its mesh")
            check_stack_shard(cfg, stack.local, stack.whole, mesh)
            stack, whole = stack.local, stack.whole
        else:
            whole = stack
        if (stack.vocab_sizes.device.type != self.device.type
                and (mesh is None or stack.vocab_sizes.device.type != "cpu")):
            raise ValueError(f"stack lives on {stack.vocab_sizes.device}, "
                             f"engine on {self.device}")
        if kv_dtype not in (None, "bf16", "bfloat16", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.kv_quant = kv_dtype == "int8"
        self.model = model if model is not None else llama
        if self.kv_quant and self.model is not llama:
            raise ValueError("kv_dtype='int8' is wired for the llama "
                             "family only (mixtral keeps a bf16 cache)")
        if self.kv_quant and not llama.on_card(kernel):
            # Capacity still doubles, but the plain decode path reads a
            # dequantized full-cache view per step — MORE traffic than
            # bf16. Only the flash-decode kernel streams int8 end to end.
            print("[engine] kv_dtype=int8 with kernel="
                  f"{kernel!r}: cache capacity doubles but decode "
                  "traffic does NOT drop (the plain path dequantizes the "
                  "cache per step); use kernel='cuda' on the card for the "
                  "bandwidth win", flush=True)
        self.cfg = cfg
        self.kernel = kernel
        self.mesh = mesh
        dp, tp = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
        # Padded vocabulary (the sampler's mask width), before sharding.
        self._vocab = int(whole.params["embed"].shape[-2])
        if mesh is not None:
            self._check_mesh(cfg, whole, max_slots, dp, tp)
        del whole
        # Decode hot path: pair-packed delta layout (prefill un-pairs on
        # the fly); same bytes as the canonical layout. Under TP the
        # row-parallel colsums are per K shard.
        self.stack = (to_pair_layout(stack, tp=tp, local=shard,
                                     in_place=shard)
                      if llama.on_card(kernel) else stack)
        del stack
        if shard:
            self.stack = stack_to(self.stack, self.device)
        elif mesh is not None:
            self.stack = shard_stack(cfg, self.stack, mesh, self.device)
        # The per-rank model sees its LOCAL heads (JAX's cfg_local).
        self._cfg_local = local_config(cfg, mesh)
        # This rank's slot rows of the batch.
        local = max_slots // dp
        self._r0 = axis_index(mesh, DATA_AXIS) * local
        self._rows = slice(self._r0, self._r0 + local)
        # Leader / follower control (rank 0 broadcasts every call).
        self._ctl = None
        self.rank = 0
        self._op_lock = threading.RLock()
        self._op_depth = 0
        if mesh is not None and mesh.size() > 1:
            self.rank = dist.get_rank()
            self._ctl = dist.new_group(
                ranks=mesh.mesh.flatten().tolist(), backend="gloo",
                timeout=FOLLOW_TIMEOUT)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.prefill_buckets = sorted(b for b in prefill_buckets
                                      if b <= max_seq)
        self.compute_dtype = torch_dtype(compute_dtype or cfg.dtype)
        self.decode_chunk = max(1, int(decode_chunk))

        self.slots = [SlotState() for _ in range(max_slots)]
        # This rank's block of the cache (its rows, its KV heads).
        self.cache = llama.init_cache(self._cfg_local, local, max_seq,
                                      self.compute_dtype, self.device,
                                      kv_dtype=kv_dtype)
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
        self.warmed: Dict[str, list] = {"prefill": [], "decode": []}

    @staticmethod
    def _check_mesh(cfg, stack, max_slots, dp, tp):
        """JAX's mesh checks (``engine.py:216-257``) on the whole stack's
        sizes."""
        if max_slots % dp:
            raise ValueError(f"max_slots {max_slots} must be a "
                             f"multiple of the data axis ({dp})")
        check_stack_tp(cfg, stack, tp)

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
        kv_kw = {"kv_quant": True} if self.kv_quant else {}
        with torch.no_grad():
            logits, rowcache = self.model.forward(
                self._cfg_local, self.stack.params, tok, lengths=lens,
                deltas=self.stack.deltas, tenant_ids=tids,
                compute_dtype=self.compute_dtype, return_cache=True,
                cache_max_seq=tokens.shape[1], kernel=self.kernel,
                tp_group=self.mesh, **kv_kw)
            rows = torch.arange(tok.shape[0], device=self.device)
            last = logits[rows, lens.to(torch.int64) - 1].to(torch.float32)
            # Every data rank prefills the same rows: only the vocabulary
            # is sharded.
            last = all_gather(last, self.mesh, MODEL_AXIS, dim=-1)
            vmask = (torch.arange(last.shape[-1], device=self.device)[None]
                     < self.stack.vocab_sizes[tids][:, None])
            last = torch.where(vmask, last, torch.full_like(last, NEG_INF))
            first = sample_tokens(self._gen, last,
                                  self._t(temps, torch.float32),
                                  self._t(top_ks, torch.int32),
                                  self._t(top_ps, torch.float32))
        return first, rowcache

    def _insert(self, rowcache, rows, slots, lengths) -> None:
        """Copy prefilled rows into engine slots (under ``_lock``); over a
        data axis a rank keeps only the slots it holds."""
        mine = [i for i, s in enumerate(slots)
                if self._rows.start <= s < self._rows.stop]
        if not mine:
            return
        rows = [rows[i] for i in mine]
        slots = [slots[i] - self._r0 for i in mine]
        lengths = [lengths[i] for i in mine]
        n = rowcache.k.shape[2]
        src = torch.as_tensor(rows, device=self.device)
        dst = torch.as_tensor(slots, device=self.device)
        self.cache.k[:, dst, :n] = rowcache.k[:, src]
        self.cache.v[:, dst, :n] = rowcache.v[:, src]
        if self.kv_quant:
            self.cache.k_scale[:, dst, :n] = rowcache.k_scale[:, src]
            self.cache.v_scale[:, dst, :n] = rowcache.v_scale[:, src]
        self.cache.length[dst] = self._t(lengths, torch.int32)

    def _step(self, tokens, tenant_ids):
        """One decode step of the whole batch: this rank's rows through
        the model (in place in its cache), the logits gathered to ``(B,
        V)`` fp32 on every rank. Returns ``(logits, cache)``."""
        rows = self._rows
        logits, cache = self.model.decode_step(
            self._cfg_local, self.stack.params, tokens[rows], self.cache,
            deltas=self.stack.deltas, tenant_ids=tenant_ids[rows],
            compute_dtype=self.compute_dtype, kernel=self.kernel,
            tp_group=self.mesh)
        logits = all_gather(logits[:, 0].to(torch.float32), self.mesh,
                            MODEL_AXIS, dim=-1)
        return all_gather(logits, self.mesh, DATA_AXIS, dim=0), cache

    def _parked(self, live: torch.Tensor, probe) -> bool:
        """True once the host can see, WITHOUT waiting for the device,
        that every lane is parked: on the CPU directly; on the card from
        a non-blocking copy of an earlier step's flag whose event has
        completed (a lagging, never-blocking probe). Over a mesh every
        rank must stop at the same step, so the host reads the flag."""
        if self.device.type != "cuda" or self._ctl is not None:
            return not bool(live.any())
        return (probe is not None and probe[1].query()
                and not bool(probe[0]))

    def _run_chunk(self, steps: int, k: int, tokens, live_in, rem_in,
                   set_mask, set_tokens, set_live, set_rem):
        """Up to ``steps`` decode+sample steps (of a ``k``-row token
        buffer) with stop detection on the device: a lane that samples a
        stop id or exhausts ``rem`` is parked (its cache length frozen,
        -1 tokens after), and the loop ends once every lane is parked.
        Returns ``(toks (k, B), tokens, live, rem, steps run)``."""
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
        vmask = (torch.arange(self._vocab, device=self.device)[None]
                 < self.stack.vocab_sizes[tenant_ids][:, None])
        probe = None
        ran = 0
        with torch.no_grad():
            for i in range(steps):
                if self._parked(live, probe):
                    break
                with RECORDER.span("engine.decode_step"):
                    old_len = self.cache.length
                    logits, cache = self._step(tokens.to(torch.int64),
                                               tenant_ids)
                    logits = torch.where(vmask, logits,
                                         torch.full_like(logits, NEG_INF))
                    nxt = sample_tokens(self._gen, logits, temps, top_ks,
                                        top_ps)
                    # Parked / inactive lanes don't advance.
                    self.cache = cache._replace(length=torch.where(
                        live[self._rows], cache.length, old_len))
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
                ran += 1
        return toks, tokens, live, rem, ran

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------

    @_replicated
    def warmup(self) -> Dict[str, list]:
        """Run every path a request takes once before the first request:
        a dummy prefill at every bucket, alone (``submit``) and with all
        slots (``generate``'s burst), the insert into the engine's cache,
        and one decode step of the whole batch against it. In eager
        PyTorch nothing compiles, but the first call of each path loads
        the kernel libraries, creates the cuBLAS handles and grows the
        allocator's pools; this keeps that out of a live request. The
        cache lengths and the sampling generator are left as they were.
        Safe only while no request is in flight. Returns
        ``{"prefill": buckets, "decode": [decode_chunk]}``: one decode
        program serves every chunk size (the chunk is a Python loop over
        the same step)."""
        with self._lock:
            if any(s.active or s.reserved for s in self.slots):
                raise RuntimeError("warmup requires an idle engine")
        gen_state = self._gen.get_state()
        rowcache = None
        for bucket in self.prefill_buckets:
            for rows in sorted({1, self.max_slots}):
                tokens = np.zeros((rows, bucket), np.int64)
                tokens[:, 0] = 1
                _first, rowcache = self._prefill(
                    tokens, np.ones((rows,), np.int32),
                    np.zeros((rows,), np.int32), np.zeros((rows,), np.float32),
                    np.zeros((rows,), np.int32), np.ones((rows,), np.float32))
        bsz = self.max_slots
        with self._lock, torch.no_grad():
            if rowcache is not None:
                # Row length 0: the inserted row stays dead.
                self._insert(rowcache, [0], [0], [0])
            length = self.cache.length.clone()
            logits, cache = self._step(
                torch.zeros((bsz, 1), dtype=torch.int64, device=self.device),
                self._t(self.tenant_ids, torch.int64))
            sample_tokens(self._gen, logits,
                          self._t(self.temps, torch.float32),
                          self._t(self.top_ks, torch.int32),
                          self._t(self.top_ps, torch.float32))
            self.cache = cache._replace(length=length)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._gen.set_state(gen_state)
        self.warmed = {"prefill": list(self.prefill_buckets),
                       "decode": [self.decode_chunk]}
        return self.warmed

    # ------------------------------------------------------------------
    # Host-side scheduling
    # ------------------------------------------------------------------

    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if not s.active and not s.reserved]

    @_replicated
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

    @_replicated
    def submit(self, req: Request) -> int:
        """Admit a request: prefill its prompt into a free slot. Returns
        the slot. Raises EngineFullError when full. The prefill runs
        outside the engine lock; only the cache insert takes it."""
        with RECORDER.span("engine.submit", request_id=req.request_id,
                           prompt_tokens=len(req.prompt_ids)) as span:
            self._validate(req)
            with self._lock:
                free = self.free_slots()
                if not free:
                    raise EngineFullError("engine full")
                slot = self._pick_slot(free, req.tenant_id)
                self.slots[slot].reserved = True
                self.slots[slot].request = req
            bucket = self._bucket(len(req.prompt_ids))
            span.set(bucket=bucket)
            _count_admissions(1, len(req.prompt_ids), bucket)
            try:
                self._admit(slot, req, bucket)
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
        _count_admissions(len(batch),
                          sum(len(r.prompt_ids) for _, r in batch),
                          B * bucket)
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

    def _admit(self, slot: int, req: Request, bucket: int):
        ids = list(req.prompt_ids)
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :len(ids)] = ids
        with RECORDER.span("engine.prefill", request_id=req.request_id):
            first_dev, rowcache = self._prefill(
                tokens, np.asarray([len(ids)], np.int32),
                np.asarray([req.tenant_id], np.int32),
                [req.temperature], [req.top_k], [req.top_p])
            first = int(first_dev[0])          # the admission's host sync
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
        with RECORDER.span("engine.dispatch", cpu=True) as span:
            ticket, pre_events = self._dispatch()
            ran = ticket.ran if ticket is not None else 0
            span.set(steps=ran, lanes=0 if ticket is None
                     else int(ticket.active.sum()))
        RECORDER.count("engine.steps", ran)
        RECORDER.count("engine.rows", self.max_slots * ran)
        return ticket, pre_events

    def _dispatch(self):
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
            toks, self._dev_tokens, self._dev_live, self._dev_rem, ran = \
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
                                epochs=epochs, steps=steps,
                                ran=ran), pre_events

    def _consume_chunk(self, ticket: _ChunkTicket) -> List[StepEvent]:
        """Read back one chunk's tokens (the only host sync) and apply
        them to host state. Returns per-slot events in generation order."""
        if ticket.ready is not None:
            with RECORDER.span("engine.readback"):
                ticket.ready.synchronize()
        with RECORDER.span("engine.consume") as span:
            events = self._apply_chunk(ticket)
            span.set(tokens=ticket.produced)
        RECORDER.count("engine.tokens", ticket.produced)
        return events

    def _apply_chunk(self, ticket: _ChunkTicket) -> List[StepEvent]:
        # Deferred admission firsts precede this chunk's tokens.
        self._flush_pending_firsts()
        events: List[StepEvent] = self._drain_flush_events()
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
        ticket.produced = produced
        return events

    def _time_pump(self, t0: float, read: List[_ChunkTicket]) -> None:
        """Feed ``timer`` a pump (or step) begun at monotonic ``t0`` that
        read back the chunks ``read``: its wall time, their tokens and
        their steps."""
        if read:
            self.timer.add(time.monotonic() - t0,
                           sum(t.produced for t in read),
                           steps=sum(t.ran for t in read))

    def _idle_flush(self) -> List[StepEvent]:
        """With no chunk to run or read, resolve deferred firsts anyway:
        a request cancelled between batched admission and its first chunk
        leaves ``pending_first`` set with nothing left to clear it, and a
        generate() waiting to reap that slot would spin forever."""
        if self._pending_firsts is None:
            return []
        self._flush_pending_firsts()
        return self._drain_flush_events()

    @_replicated
    def step(self) -> List[StepEvent]:
        """One chunk for all active slots, read back at once. In-flight
        chunks left by :meth:`pump` are drained first."""
        with self._step_mutex, RECORDER.span("engine.pump"):
            t0 = time.monotonic()
            events: List[StepEvent] = self._drain_flush_events()
            read = []
            while self._inflight:
                read.append(self._inflight.pop(0))
                events += self._consume_chunk(read[-1])
            ticket, pre = self._dispatch_chunk()
            events += pre
            if ticket is not None:
                read.append(ticket)
                events += self._consume_chunk(ticket)
            else:
                events += self._idle_flush()
            self._time_pump(t0, read)
            return events

    @_replicated
    def pump(self) -> List[StepEvent]:
        """Pipelined :meth:`step`: run the NEXT chunk before reading the
        previous one back, so the readback overlaps device work. The
        first call typically returns no events."""
        with self._step_mutex, RECORDER.span("engine.pump"):
            t0 = time.monotonic()
            ticket, events = self._dispatch_chunk()
            events = self._drain_flush_events() + events
            if ticket is not None:
                self._inflight.append(ticket)
            read = []
            if self._inflight and (ticket is None
                                   or len(self._inflight) > 1):
                read.append(self._inflight.pop(0))
                events = events + self._consume_chunk(read[0])
            elif ticket is None:
                events = events + self._idle_flush()
            self._time_pump(t0, read)
            return events

    @_replicated
    def generate(self, requests: Sequence[Request]) -> List[List[int]]:
        """Run all requests to completion with continuous admission
        (batched prefill per burst; pipelined decode). Returns generated ids per request (stop token
        excluded)."""
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

    # ------------------------------------------------------------------
    # Leader and followers
    # ------------------------------------------------------------------

    def follow(self) -> None:
        """On a rank other than 0: replay the leader's calls, in its
        order, until :meth:`stop_followers`. A call that the leader's
        engine refused (a bad request, no free slot) was refused here
        too, before any collective, and is passed over."""
        if self._ctl is None or self.rank == 0:
            raise RuntimeError("follow() runs on a follower rank of a mesh")
        while True:
            msg = broadcast_object(None, group=self._ctl)
            if msg is None:
                return
            name, args, kwargs = msg
            with self._op_lock:
                self._op_depth += 1
                try:
                    getattr(self, name)(*args, **kwargs)
                except (ValueError, EngineFullError):
                    pass
                finally:
                    self._op_depth -= 1

    def stop_followers(self) -> None:
        """On rank 0: end the followers' :meth:`follow` (a no-op without
        followers)."""
        if self._ctl is not None and self.rank == 0:
            with self._op_lock:
                broadcast_object(None, group=self._ctl)
