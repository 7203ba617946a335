"""Iteration-level continuous-batching scheduler over the paged KV cache
(mirrors ``paddle_tpu/serving/scheduler.py``).

The single-threaded policy core of the serving frontend (thread safety
is ``serving.frontend.ServingEngine``'s job: one lock around every entry
point). Each ``step()`` is one scheduling iteration:

1. **sweep**: cancellations and expired deadlines
   (``core.resilience.Deadline``) finish at the step boundary and free
   their blocks; then the overload control (``serving/overload.py``)
   walks its brownout ladder and sheds queued requests under pressure;
2. **admit**: strict FCFS from a bounded queue, limited by free slots,
   free blocks and a per-step prefill token budget
   (``FLAGS_serving_prefill_budget``); admitted prompts prefill at a
   bucketed length (``serving.bucketing``) and stream their first token.
   With the prefix cache (``FLAGS_serving_prefix_cache``) a prompt's
   resident prefix blocks are mapped read-only: the budget is charged
   for the uncovered tail only, and ``Llama.paged_prefill_extend``
   computes just that tail;
3. **decode**: one batched ``Llama.paged_decode_step`` for every live
   slot, after ``prepare_append`` made each slot's next position
   writable (table growth, copy-on-write of a shared block; cold cached
   blocks are evicted before anyone is preempted). Pool exhaustion
   preempts a victim (its blocks freed, requeued at the front for a
   re-prefill of prompt + generated) instead of truncating anyone.

Every request ends in exactly one of ``DONE``, ``CANCELLED``,
``TIMEOUT``, ``SHED`` or ``ERROR``. The ``serving.*`` instruments of
``profiler.metrics`` carry the reference's names.

Not ported yet (ROADMAP.md §1, the next serving slices): cost accounting
and alerts (``accounting=True``), speculative decode (``spec=True``),
mesh-sharded serving (``mesh=``), disaggregated handoff
(``admit_handoff``) and tracing spans. The port's scheduler behaves as
the reference's does with ``accounting=False, spec=False``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import flags as flags_mod
from ..core import resilience
from ..inference.paged import (CapacityError, PagedKVCache, prefill_ids,
                               quant_block_ratio, resolve_kv_dtype,
                               resolve_paged_kernel, sized_num_blocks,
                               validate_request)
from ..profiler import metrics as _metrics
from . import overload as _overload
from .bucketing import bucket_length
from .overload import AdmissionRejected

__all__ = ["RequestStatus", "ServingRequest", "Scheduler",
           "QueueFullError", "AdmissionRejected"]


class QueueFullError(RuntimeError):
    """Admission queue at ``FLAGS_serving_max_queue``: back off and retry.
    ``queue_depth``, ``max_queue`` and ``retry_after_s`` (the overload
    controller's predicted drain time, None when disarmed or unprimed)
    let a caller back off by data."""

    def __init__(self, message, *, queue_depth=None, max_queue=None,
                 retry_after_s=None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.max_queue = max_queue
        self.retry_after_s = retry_after_s


class RequestStatus:
    QUEUED = "QUEUED"
    RUNNING = "RUNNING"
    DONE = "DONE"
    CANCELLED = "CANCELLED"
    TIMEOUT = "TIMEOUT"
    SHED = "SHED"
    ERROR = "ERROR"

    TERMINAL = (DONE, CANCELLED, TIMEOUT, SHED, ERROR)


class ServingRequest:
    """One request's lifecycle state. ``generated`` only ever appends
    (preemption keeps it), so handle readers see a stable prefix."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "deadline",
                 "on_token", "on_finish", "status", "generated", "slot",
                 "preempts", "admit_seq", "submitted_at", "admitted_at",
                 "first_token_at", "last_token_at", "cancel_requested",
                 "priority", "est_tokens", "retry_after_s")

    def __init__(self, rid, prompt, max_new_tokens, deadline=None,
                 on_token=None, on_finish=None,
                 priority=_overload.NORMAL):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.deadline = deadline
        self.on_token = on_token
        self.on_finish = on_finish
        self.status = RequestStatus.QUEUED
        self.generated = []
        self.slot = -1
        self.preempts = 0
        self.admit_seq = -1
        self.submitted_at = time.monotonic()
        self.admitted_at = None
        self.first_token_at = None
        self.last_token_at = None
        self.cancel_requested = False
        # overload control: priority class (smaller = more important),
        # the estimated uncovered-prefill tokens, and the back-off hint
        # set when this request is shed
        self.priority = priority
        self.est_tokens = 0
        self.retry_after_s = None

    @property
    def done(self):
        return self.status in RequestStatus.TERMINAL


_US_BOUNDS = (500, 1000, 2500, 5000, 10000, 25000, 50000, 100000,
              250000, 500000, 1000000, 5000000)
_m_admitted = _metrics.counter("serving.admitted")
_m_decoded = _metrics.counter("serving.decoded_tokens")
_m_preempt = _metrics.counter("serving.preempt")
_m_done = _metrics.counter("serving.completed")
_m_cancelled = _metrics.counter("serving.cancelled")
_m_timeout = _metrics.counter("serving.timeout")
_m_rejected = _metrics.counter("serving.rejected")
_m_shed = _metrics.counter("serving.shed")
_m_errors = _metrics.counter("serving.errors")
_m_cb_errors = _metrics.counter("serving.callback_errors")
_m_steps = _metrics.counter("serving.steps")
_h_ttft = _metrics.histogram("serving.ttft_us", bounds=_US_BOUNDS)
_h_itl = _metrics.histogram("serving.itl_us", bounds=_US_BOUNDS)
_h_queue_wait = _metrics.histogram("serving.queue_wait_us",
                                   bounds=_US_BOUNDS)
_h_step = _metrics.histogram("serving.step_us", bounds=_US_BOUNDS)
_g_queue = _metrics.gauge("serving.queue.depth")
_g_running = _metrics.gauge("serving.slots.running")
_g_blocks = _metrics.gauge("serving.kv.blocks_used")
_g_util = _metrics.gauge("serving.kv.utilization")
# prefix-cache economics: tokens the prefill computed (padded; covered
# tokens cost nothing), blocks backing more than one slot, reclaimable
# cached blocks
_m_prefix_computed = _metrics.counter("serving.prefix.computed_tokens")
_g_shared = _metrics.gauge("serving.kv.shared_blocks")
_g_cached = _metrics.gauge("serving.kv.cached_blocks")
_g_kv_quant_bits = _metrics.gauge("serving.kv.quant.bits")
_g_kv_quant_mult = _metrics.gauge(
    "serving.kv.quant.capacity_multiplier")


def _not_ported(what, item):
    return NotImplementedError(
        f"Scheduler: {what} is not ported yet (ROADMAP.md §1: {item})")


class Scheduler:
    """See the module docstring. Not thread-safe: callers serialize.
    The cache lives on the model's device; ``generator`` (a
    ``torch.Generator`` there) drives sampling at ``temperature > 0``."""

    def __init__(self, model, *, max_batch=8, block_size=16,
                 max_seq_len=2048, num_blocks=None, temperature=0.0,
                 eos_token_id=None, dtype=None,
                 prefill_token_budget=None, max_queue=None,
                 bucket_cap=None, prefix_cache=None, accounting=None,
                 admission=None, brownout=None, kv_cache_dtype=None,
                 spec=None, mesh=None, paged_kernel=None, generator=None):
        if accounting:
            raise _not_ported("cost accounting",
                              "the telemetry serving slice")
        if spec:
            raise _not_ported("speculative decode",
                              "the speculative-decode serving slice")
        if mesh is not None:
            raise _not_ported("mesh-sharded serving",
                              "the long tail, serving/mesh.py")
        cfg = model.config
        self.model = model
        self.temperature = temperature
        self.eos_token_id = eos_token_id
        self.max_seq_len = max_seq_len
        self.generator = generator
        mbps = math.ceil(max_seq_len / block_size)
        kv_dtype = resolve_kv_dtype(
            flags_mod.flag("FLAGS_kv_cache_dtype")
            if kv_cache_dtype is None else kv_cache_dtype)
        self.kernel_mode = resolve_paged_kernel(paged_kernel)
        compute_dt = dtype if dtype is not None else torch.bfloat16
        self.cache = PagedKVCache(
            cfg.num_layers, cfg.num_kv_heads, cfg.head_dim,
            num_blocks=sized_num_blocks(num_blocks, max_batch, mbps,
                                        kv_dtype, cfg.head_dim,
                                        compute_dt),
            block_size=block_size, max_blocks_per_seq=mbps,
            max_batch=max_batch, dtype=compute_dt, kv_dtype=kv_dtype,
            device=model.device)
        if self.cache.quantized:
            _g_kv_quant_bits.set(8)
            _g_kv_quant_mult.set(round(
                quant_block_ratio(cfg.head_dim, compute_dt), 4))
        self.prefill_token_budget = (
            flags_mod.flag("FLAGS_serving_prefill_budget")
            if prefill_token_budget is None else int(prefill_token_budget))
        self.max_queue = (flags_mod.flag("FLAGS_serving_max_queue")
                          if max_queue is None else int(max_queue))
        self.bucket_cap = (
            flags_mod.flag("FLAGS_serving_prefill_bucket_cap")
            if bucket_cap is None else int(bucket_cap))
        # read once: a mid-flight flip would mix shared and private
        # blocks; off, the cache never registers a chunk
        self.prefix_cache = (
            bool(flags_mod.flag("FLAGS_serving_prefix_cache"))
            if prefix_cache is None else bool(prefix_cache))
        adm = (bool(flags_mod.flag("FLAGS_serving_admission"))
               if admission is None else bool(admission))
        brw = (bool(flags_mod.flag("FLAGS_serving_brownout"))
               if brownout is None else bool(brownout))
        self.overload = _overload.OverloadController(
            admission=adm, brownout=brw) if (adm or brw) \
            else _overload.NULL
        self.queue: list[ServingRequest] = []
        self.running: dict[int, ServingRequest] = {}  # slot -> request
        self.finished: dict[int, ServingRequest] = {}  # rid -> request
        self._next_rid = 0
        self._next_admit_seq = 0
        self._last_tok = np.zeros((max_batch,), np.int64)
        self._remaining = np.zeros((max_batch,), np.int64)

    # -- submission / cancellation ------------------------------------

    def submit(self, prompt_ids, max_new_tokens=32, *, deadline=None,
               priority=None, on_token=None, on_finish=None):
        """Validate and enqueue; returns the ServingRequest. Raises
        ValueError on malformed or never-servable input, QueueFullError
        past the queue bound, and (overload control armed)
        AdmissionRejected for an unmeetable deadline or a priority the
        brownout stage refuses, all before any queueing. ``priority`` is
        an int class, smaller = more important (default
        ``overload.NORMAL``)."""
        prompt = validate_request(prompt_ids, max_new_tokens,
                                  self.max_seq_len, self.cache,
                                  who="serving.submit")
        pri = _overload.NORMAL if priority is None else int(priority)
        if self.max_queue and len(self.queue) >= self.max_queue:
            _m_rejected.inc()
            raise QueueFullError(
                f"serving.submit: admission queue full "
                f"({len(self.queue)} >= {self.max_queue})",
                queue_depth=len(self.queue), max_queue=self.max_queue,
                retry_after_s=self.overload.queue_retry_after(self))
        est, max_new_tokens = self.overload.admit(
            self, prompt, int(max_new_tokens), deadline, pri)
        req = ServingRequest(self._next_rid, prompt, max_new_tokens,
                             deadline=deadline, on_token=on_token,
                             on_finish=on_finish, priority=pri)
        req.est_tokens = est
        self._next_rid += 1
        self.queue.append(req)
        _g_queue.set(len(self.queue))
        return req

    def cancel(self, req):
        """Request cancellation; it takes effect (blocks freed, status
        CANCELLED, stream closed) at the next step boundary."""
        if not req.done:
            req.cancel_requested = True

    @property
    def has_work(self):
        return bool(self.queue or self.running)

    def inflight(self):
        """Live requests: queued + running."""
        return len(self.queue) + len(self.running)

    # -- the scheduling iteration -------------------------------------

    def step(self):
        """One iteration: sweep -> overload control -> admit -> decode.
        Returns the (rid, token) pairs emitted, prefill tokens included."""
        t0 = time.monotonic()
        self._sweep()
        # shed before admission, so a step never prefills work it is
        # about to shed
        self.overload.control(self)
        out = self._admit()
        out += self._decode()
        _m_steps.inc()
        _h_step.observe((time.monotonic() - t0) * 1e6)
        self._update_gauges()
        return out

    # -- internals -----------------------------------------------------

    def _sweep(self):
        for req in list(self.queue):
            if req.cancel_requested:
                self.queue.remove(req)
                self._finish(req, RequestStatus.CANCELLED)
            elif req.deadline is not None and req.deadline.expired():
                self.queue.remove(req)
                self._expire(req)
        for slot, req in list(self.running.items()):
            if req.cancel_requested:
                self._finish(req, RequestStatus.CANCELLED)
            elif req.deadline is not None and req.deadline.expired():
                self._expire(req)

    def _expire(self, req):
        resilience.degrade("serving.deadline")
        self._finish(req, RequestStatus.TIMEOUT)

    def shed(self, req, retry_after_s=None):
        """Load-shed a queued request (the overload controller's victim):
        terminal status SHED, blocks never allocated, ``retry_after_s``
        as the back-off hint. Running requests are untouched."""
        self.queue.remove(req)
        req.retry_after_s = retry_after_s
        resilience.degrade("serving.shed")
        self._finish(req, RequestStatus.SHED)

    def _admit(self):
        """Strict FCFS: stop at the first request that does not fit (a
        small late prompt never jumps an older large one). Budgeted:
        prefill tokens per step stay under the budget, except for the
        step's first admission, so an over-budget prompt still runs.
        Cache-aware: a request is charged (and computes) only its
        uncovered tokens. Plans hash the raw ids; bucket padding comes
        after and never reaches a chunk hash."""
        out = []
        used = 0
        budget = self.prefill_token_budget
        bs = self.cache.block_size
        while self.queue:
            if len(self.running) >= self.cache.max_batch:
                break  # before planning: no hashing while the batch is full
            req = self.queue[0]
            ids = prefill_ids(req)
            ids_len = len(ids)
            plan = self.cache.plan_prefix(ids) if self.prefix_cache \
                else None
            covered = plan.covered_tokens if plan is not None else 0
            # full coverage still computes the final token for its logits
            uncovered = max(ids_len - covered, 1)
            if used > 0 and budget and used + uncovered > budget:
                break
            slot = self.cache.alloc_slot_cached(plan) \
                if plan is not None else self.cache.alloc_slot(ids_len)
            if slot is None:
                break
            self.queue.pop(0)
            used += uncovered
            req.slot = slot
            req.status = RequestStatus.RUNNING
            req.admit_seq = self._next_admit_seq
            self._next_admit_seq += 1
            now = time.monotonic()
            if req.admitted_at is None:
                req.admitted_at = now
                _h_queue_wait.observe((now - req.submitted_at) * 1e6)
            self.running[slot] = req
            _m_admitted.inc()
            t_pf = time.perf_counter_ns()
            if covered:
                tail_start = plan.tail_start
                pad_to = bucket_length(ids_len - tail_start, bs,
                                       self.bucket_cap,
                                       max_len=self.max_seq_len)
                tok = int(self.model.paged_prefill_extend(
                    self.cache, slot, ids, tail_start, plan.write_start,
                    temperature=self.temperature,
                    generator=self.generator, pad_to=pad_to))
            else:
                pad_to = bucket_length(ids_len, bs, self.bucket_cap,
                                       max_len=self.max_seq_len)
                tok = int(self.model.paged_prefill(
                    self.cache, slot, ids, temperature=self.temperature,
                    generator=self.generator, pad_to=pad_to))
            # int(tok) waited for the device: the host clock is the
            # prefill's time
            pf_us = (time.perf_counter_ns() - t_pf) / 1000.0
            if plan is not None:
                _m_prefix_computed.inc(pad_to)
                self.cache.commit_prefix(slot, plan)
            self.overload.observe_prefill(pad_to, pf_us)
            self._last_tok[slot] = tok
            self._remaining[slot] = \
                req.max_new_tokens - len(req.generated) - 1
            self._emit(req, tok)
            out.append((req.rid, tok))
            self._maybe_finish(slot)
        return out

    def _choose_victim(self):
        """Preemption victim: with the overload control armed, lowest
        priority first and newest within a class; disarmed, newest
        admitted. Either way skip victims whose blocks are all shared
        (preempting them frees nothing)."""
        if self.overload.shedding:
            key = lambda s: (-self.running[s].priority,  # noqa: E731
                             -self.running[s].admit_seq)
        else:
            key = lambda s: -self.running[s].admit_seq  # noqa: E731
        cands = sorted(self.running, key=key)
        for s in cands:
            if self.cache.reclaimable_blocks(s) > 0:
                return s
        return cands[0]

    def _decode(self):
        if not self.running:
            return []
        # make each slot's next position writable (growth, evicting cold
        # cached blocks first; copy-on-write of shared blocks); preempt
        # a victim on true pool exhaustion, never truncate
        for slot in list(self.running):
            if slot not in self.running:  # preempted as a victim below
                continue
            while True:
                denied = self.cache.prepare_append(
                    slot, int(self.cache.seq_lens[slot]) + 1)
                if denied:
                    break
                if denied.reason == CapacityError.SEQ_LIMIT:
                    req = self.running[slot]
                    raise RuntimeError(
                        f"serving: request {req.rid} outgrew "
                        f"max_blocks_per_seq: {denied.detail}")
                if len(self.running) == 1:
                    # validate_request bounds each request's demand to
                    # the pool; an invariant guard
                    req = self.running[slot]
                    need = math.ceil(
                        (int(self.cache.seq_lens[slot]) + 1)
                        / self.cache.block_size)
                    raise RuntimeError(
                        f"serving: KV pool exhausted — request "
                        f"{req.rid} needs {need} blocks, pool has "
                        f"{self.cache.num_blocks - 1} usable and no "
                        "other running request to preempt; increase "
                        "num_blocks or lower max_seq_len")
                victim = self._choose_victim()
                self._preempt(victim)
                if victim == slot:
                    break  # the grower preempted itself
        if not self.running:
            return []
        active = np.zeros((self.cache.max_batch,), bool)
        for slot in self.running:
            active[slot] = True
        t_dec = time.perf_counter_ns()
        toks = self.model.paged_decode_step(
            self.cache, self._last_tok, active,
            temperature=self.temperature, kernel_mode=self.kernel_mode,
            generator=self.generator)
        # the tokens came back to the host: the step is done on the device
        self.overload.observe_decode(
            (time.perf_counter_ns() - t_dec) / 1000.0)
        out = []
        for slot, req in list(self.running.items()):
            t = int(toks[slot])
            self._last_tok[slot] = t
            self._remaining[slot] -= 1
            self._emit(req, t)
            out.append((req.rid, t))
            self._maybe_finish(slot)
        _m_decoded.inc(len(out))
        return out

    def _preempt(self, slot):
        """Free the victim's slot and blocks; requeue it at the front for
        a re-prefill of prompt + generated."""
        req = self.running.pop(slot)
        self.cache.free_slot(slot)
        req.slot = -1
        req.status = RequestStatus.QUEUED
        req.preempts += 1
        self.queue.insert(0, req)
        _m_preempt.inc()
        resilience.degrade("serving.preempt")

    def _emit(self, req, tok):
        req.generated.append(tok)
        now = time.monotonic()
        if req.first_token_at is None:
            req.first_token_at = now
            _h_ttft.observe((now - req.submitted_at) * 1e6)
        else:
            _h_itl.observe((now - req.last_token_at) * 1e6)
        req.last_token_at = now
        if req.on_token is not None:
            try:
                req.on_token(req, tok)
            except Exception:  # noqa: BLE001 — a user callback must not
                _m_cb_errors.inc()  # kill serving

    def _maybe_finish(self, slot):
        req = self.running.get(slot)
        if req is None:
            return
        if self._remaining[slot] <= 0 or (
                self.eos_token_id is not None and req.generated
                and req.generated[-1] == self.eos_token_id):
            self._finish(req, RequestStatus.DONE)

    def _finish(self, req, status):
        if req.slot >= 0:
            self.cache.free_slot(req.slot)
            self.running.pop(req.slot, None)
            req.slot = -1
        req.status = status
        self.finished[req.rid] = req
        {RequestStatus.DONE: _m_done,
         RequestStatus.CANCELLED: _m_cancelled,
         RequestStatus.TIMEOUT: _m_timeout,
         RequestStatus.SHED: _m_shed,
         RequestStatus.ERROR: _m_errors}[status].inc()
        if req.on_finish is not None:
            try:
                req.on_finish(req)
            except Exception:  # noqa: BLE001
                _m_cb_errors.inc()

    def fail_all(self):
        """The engine died: end every live request with ERROR so no
        consumer blocks forever (the frontend re-raises the cause)."""
        for req in list(self.queue):
            self._finish(req, RequestStatus.ERROR)
        self.queue.clear()
        for slot in list(self.running):
            self._finish(self.running[slot], RequestStatus.ERROR)
        self._update_gauges()

    def _update_gauges(self):
        usable = self.cache.num_blocks - 1
        # reclaimable cached blocks count as free: blocks_used is what
        # live requests pin
        used = usable - self.cache.num_free_blocks()
        _g_queue.set(len(self.queue))
        _g_running.set(len(self.running))
        _g_blocks.set(used)
        _g_util.set(round(used / usable, 4) if usable else 0.0)
        _g_shared.set(self.cache.num_shared_blocks())
        _g_cached.set(self.cache.num_cached_blocks())
