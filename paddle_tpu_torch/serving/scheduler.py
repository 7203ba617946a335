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
   re-prefill of prompt + generated) instead of truncating anyone. With
   speculation armed (``FLAGS_serving_spec``, greedy only) the step
   instead runs one batched verify sweep over prompt-lookup drafts
   (``_decode_spec``, ``Llama.paged_spec_step``): several tokens per
   request per step, the same greedy tokens, rejected rows rolled back.

Every request ends in exactly one of ``DONE``, ``CANCELLED``,
``TIMEOUT``, ``SHED`` or ``ERROR``. The ``serving.*`` instruments of
``profiler.metrics`` carry the reference's names. With accounting armed
(``FLAGS_serving_accounting``, on by default) each step's measured time
is apportioned across the requests that did work in it into per-request
``CostReport``s and engine goodput (``profiler/accounting.py``). Each
request is one trace (``profiler/tracing.py``): a root span from submit
to its terminal status, with its queue wait, prefills, its share of each
decode step, preemptions and the terminal status beneath.

Not ported yet (ROADMAP.md §1): the SLO burn-rate alerts that ride with
accounting in the reference (``profiler/alerts.py``), mesh-sharded
serving (``mesh=``) and disaggregated handoff (``admit_handoff``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..core import flags as flags_mod
from ..core import resilience
from ..inference.paged import (CapacityError, PagedKVCache, kernel_route,
                               prefill_ids, quant_block_ratio,
                               resolve_kv_dtype, resolve_paged_kernel,
                               sized_num_blocks, validate_request)
from ..kernels._build import thread_build_seconds
from ..profiler import accounting as _accounting
from ..profiler import metrics as _metrics
from ..profiler import tracing as _tracing
from . import overload as _overload
from . import spec as _spec
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
                 "span", "cost", "priority", "est_tokens", "retry_after_s")

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
        # the root span of this request's trace (submit to terminal
        # status); the null span when tracing is off or unsampled
        self.span = _tracing.NULL
        # the CostReport the accountant binds at submit; None disarmed
        self.cost = None
        # overload control: priority class (smaller = more important),
        # the estimated uncovered-prefill tokens, and the back-off hint
        # set when this request is shed
        self.priority = priority
        self.est_tokens = 0
        self.retry_after_s = None

    @property
    def trace_id(self):
        return self.span.trace_id

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
# speculative decode: draft tokens proposed, accepted and rejected by the
# verify sweep, sweeps run, and each request's per-sweep acceptance rate;
# silent with FLAGS_serving_spec off
_m_spec_proposed = _metrics.counter("serving.spec.proposed")
_m_spec_accepted = _metrics.counter("serving.spec.accepted")
_m_spec_rejected = _metrics.counter("serving.spec.rejected")
_m_spec_steps = _metrics.counter("serving.spec.steps")
_h_spec_accept = _metrics.histogram(
    "serving.spec.accept_rate",
    bounds=(0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0))
_g_kv_quant_bits = _metrics.gauge("serving.kv.quant.bits")
_g_kv_quant_mult = _metrics.gauge(
    "serving.kv.quant.capacity_multiplier")


def _not_ported(what, item):
    return NotImplementedError(
        f"Scheduler: {what} is not ported yet (ROADMAP.md §1: {item})")


class Scheduler:
    """See the module docstring. Not thread-safe: callers serialize.
    The cache lives on the model's device; ``generator`` (a
    ``torch.Generator`` there) drives sampling at ``temperature > 0``.
    ``accounting``, ``spec`` and ``spec_tokens`` default to their flags
    (read once, here)."""

    def __init__(self, model, *, max_batch=8, block_size=16,
                 max_seq_len=2048, num_blocks=None, temperature=0.0,
                 eos_token_id=None, dtype=None,
                 prefill_token_budget=None, max_queue=None,
                 bucket_cap=None, prefix_cache=None, accounting=None,
                 admission=None, brownout=None, kv_cache_dtype=None,
                 spec=None, spec_tokens=None, mesh=None, paged_kernel=None,
                 generator=None):
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
        # the decode_step span's route attribute
        self.kernel_route = kernel_route(self.kernel_mode, model.device)
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
        # self-speculative decode: greedy only (sampled decode has no
        # cheap accept rule that keeps the distribution exact), so a
        # temperature > 0 disarms it
        armed_spec = (bool(flags_mod.flag("FLAGS_serving_spec"))
                      if spec is None else bool(spec))
        self.spec_tokens = max(int(
            flags_mod.flag("FLAGS_serving_spec_tokens")
            if spec_tokens is None else spec_tokens), 1)
        self.spec_ngram = max(
            int(flags_mod.flag("FLAGS_serving_spec_ngram")), 1)
        self.spec = armed_spec and temperature == 0.0
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
        # cost attribution, read once like prefix_cache; disarmed, the
        # null accountant's hooks do nothing
        armed = (bool(flags_mod.flag("FLAGS_serving_accounting"))
                 if accounting is None else bool(accounting))
        self.accounting = _accounting.Accountant(
            config=cfg, device=model.device) if armed else _accounting.NULL
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
        req.span = _tracing.start_trace(
            "serving.request", rid=req.rid, prompt_len=len(prompt),
            max_new_tokens=int(max_new_tokens))
        self.accounting.attach(req)
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
        self.accounting.step_begin()
        self._sweep()
        # shed before admission, so a step never prefills work it is
        # about to shed
        self.overload.control(self)
        out = self._admit()
        out += self._decode()
        _m_steps.inc()
        step_us = (time.monotonic() - t0) * 1e6
        _h_step.observe(step_us)
        # apportion before the gauges, so the capacity view and the
        # attribution agree on the step boundary
        self.accounting.step_end(step_us)
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
        _tracing.record_span("serving.shed", req.span, 0.0,
                             priority=req.priority,
                             queue_depth=len(self.queue))
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
                wait_us = (now - req.submitted_at) * 1e6
                with _tracing.attach(req.span):  # exemplar -> trace_id
                    _h_queue_wait.observe(wait_us)
                _tracing.record_span("serving.queue_wait", req.span,
                                     wait_us)
                self.accounting.note_queue_wait(req, wait_us)
            self.running[slot] = req
            _m_admitted.inc()
            build0 = thread_build_seconds()  # builds bill to this request
            t_pf = time.perf_counter_ns()
            if covered:
                tail_start = plan.tail_start
                pad_to = bucket_length(ids_len - tail_start, bs,
                                       self.bucket_cap,
                                       max_len=self.max_seq_len)
                with _tracing.span("serving.prefill", parent=req.span,
                                   tokens=ids_len, pad_to=pad_to,
                                   reprefill=bool(req.generated),
                                   covered=covered,
                                   hit_blocks=plan.hit_blocks):
                    tok = int(self.model.paged_prefill_extend(
                        self.cache, slot, ids, tail_start,
                        plan.write_start, temperature=self.temperature,
                        generator=self.generator, pad_to=pad_to))
            else:
                pad_to = bucket_length(ids_len, bs, self.bucket_cap,
                                       max_len=self.max_seq_len)
                with _tracing.span("serving.prefill", parent=req.span,
                                   tokens=ids_len, pad_to=pad_to,
                                   reprefill=bool(req.generated),
                                   covered=0, hit_blocks=0):
                    tok = int(self.model.paged_prefill(
                        self.cache, slot, ids,
                        temperature=self.temperature,
                        generator=self.generator, pad_to=pad_to))
            # int(tok) waited for the device: the host clock is the
            # prefill's time
            pf_us = (time.perf_counter_ns() - t_pf) / 1000.0
            build_us = (thread_build_seconds() - build0) * 1e6
            if plan is not None:
                _m_prefix_computed.inc(pad_to)
                self.cache.commit_prefix(slot, plan)
            # covered prefix tokens are free; a re-prefill bills to the
            # preemption
            self.accounting.note_prefill(req, pad_to, covered, build_us,
                                         reprefill=req.preempts > 0)
            # the service-time model sees the build-free cost
            self.overload.observe_prefill(pad_to,
                                          max(pf_us - build_us, 0.0))
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

    def _timed_decode_dispatch(self, dispatch):
        """Run one batched decode program (plain step or verify sweep)
        under one instrumentation contract: kernel builds billed through
        the accountant, the build-free time fed to overload control.
        Returns (the program's output, its host microseconds)."""
        build0 = thread_build_seconds()
        t_dec = time.perf_counter_ns()
        out = dispatch()
        # the tokens came back to the host: the step is done on the device
        dec_us = (time.perf_counter_ns() - t_dec) / 1000.0
        build_us = (thread_build_seconds() - build0) * 1e6
        self.accounting.note_decode_compile(build_us)
        self.overload.observe_decode(max(dec_us - build_us, 0.0))
        return out, dec_us

    def _decode(self):
        if not self.running:
            return []
        if self.spec:
            out = self._decode_spec()
            if out is not None:
                return out
            # nothing proposed, or no room for the draft rows: this step
            # decodes plainly
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
        toks, dec_us = self._timed_decode_dispatch(
            lambda: self.model.paged_decode_step(
                self.cache, self._last_tok, active,
                temperature=self.temperature, kernel_mode=self.kernel_mode,
                generator=self.generator))
        out = []
        for slot, req in list(self.running.items()):
            t = int(toks[slot])
            self._last_tok[slot] = t
            self._remaining[slot] -= 1
            # one batched program: each live request's trace gets the
            # step's wall time
            _tracing.record_span("serving.decode_step", req.span,
                                 dec_us, token=len(req.generated),
                                 batch=len(self.running),
                                 route=self.kernel_route)
            self.accounting.note_decode(req)
            self._emit(req, t)
            out.append((req.rid, t))
            self._maybe_finish(slot)
        _m_decoded.inc(len(out))
        return out

    def _decode_spec(self):
        """One speculative decode iteration: propose up to
        ``spec_tokens`` drafts per running request from its own context
        (``serving/spec.py``), verify all of them in one batched sweep
        (``Llama.paged_spec_step``), accept the longest prefix that
        matches the sweep's greedy tokens, and roll rejected rows' blocks
        back. Every emitted token is the sweep's own argmax, so greedy
        outputs equal plain decode's.

        Returns the (rid, token) list, or None to decode plainly this
        step: nothing proposed anywhere, or the pool cannot hold the
        draft rows now (the plain path then evicts or preempts;
        speculation re-engages when room returns)."""
        k = self.spec_tokens
        bs = self.cache.block_size
        drafts = {}
        for slot, req in self.running.items():
            cap = min(k, int(self._remaining[slot]) - 1)
            drafts[slot] = _spec.propose_draft(
                prefill_ids(req), cap, self.spec_ngram) \
                if cap > 0 else np.empty((0,), np.int64)
        if not any(d.size for d in drafts.values()):
            return None
        # every slot needs positions [len, len + 1 + drafts) writable;
        # a failure part-way rolls every grown slot back, so the plain
        # path starts from untouched tables
        grown = []
        for slot in list(self.running):
            old = len(self.cache._slot_blocks[slot])
            need = int(self.cache.seq_lens[slot]) + 1 + int(drafts[slot].size)
            if not self.cache.prepare_append_range(slot, need):
                for s, n in grown:
                    self.cache.truncate_blocks(s, n)
                return None
            grown.append((slot, old))
        draft_mat = np.zeros((self.cache.max_batch, k), np.int64)
        n_inputs = np.zeros((self.cache.max_batch,), np.int64)
        active = np.zeros((self.cache.max_batch,), bool)
        for slot, d in drafts.items():
            active[slot] = True
            n_inputs[slot] = 1 + d.size
            draft_mat[slot, :d.size] = d
        outs, dec_us = self._timed_decode_dispatch(
            lambda: self.model.paged_spec_step(
                self.cache, self._last_tok, draft_mat, n_inputs, active))
        out = []
        for slot, req in list(self.running.items()):
            g = outs[slot]
            proposed = int(drafts[slot].size)
            # accept while each draft equals the sweep's argmax at the
            # position before it: the emitted run g[0..m] is what m + 1
            # sequential steps give
            m = 0
            while m < proposed and int(draft_mat[slot, m]) == int(g[m]):
                m += 1
            emitted = [int(g[i]) for i in range(m + 1)]
            if self.eos_token_id is not None \
                    and self.eos_token_id in emitted:
                # sequential decode stops at eos: later rows never were
                m = emitted.index(self.eos_token_id)
                emitted = emitted[:m + 1]
            # the inputs consumed (last token + m drafts) wrote exactly
            # the rows sequential decode would have; the rest roll back
            new_seq = int(self.cache.seq_lens[slot]) + len(emitted)
            self.cache.seq_lens[slot] = new_seq
            self.cache.truncate_blocks(slot, max(math.ceil(new_seq / bs), 1))
            self._last_tok[slot] = emitted[-1]
            self._remaining[slot] -= len(emitted)
            _m_spec_proposed.inc(proposed)
            _m_spec_accepted.inc(m)
            _m_spec_rejected.inc(proposed - m)
            if proposed:
                with _tracing.attach(req.span):  # exemplar -> trace_id
                    _h_spec_accept.observe(m / proposed)
            _tracing.record_span("serving.decode_step", req.span,
                                 dec_us, token=len(req.generated),
                                 batch=len(self.running),
                                 route=self.kernel_route,
                                 spec_proposed=proposed,
                                 spec_accepted=m)
            if proposed:
                self.accounting.note_spec(req, emitted=len(emitted),
                                          proposed=proposed, accepted=m)
            else:
                self.accounting.note_decode(req)
            for t in emitted:
                self._emit(req, t)
                out.append((req.rid, t))
            self._maybe_finish(slot)
        _m_spec_steps.inc()
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
        _tracing.record_span("serving.preempt", req.span, 0.0,
                             generated=len(req.generated),
                             preempts=req.preempts)
        resilience.degrade("serving.preempt")

    def _emit(self, req, tok):
        req.generated.append(tok)
        now = time.monotonic()
        # under the request's trace context, so the bucket's exemplar
        # names this trace
        with _tracing.attach(req.span):
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
        self.accounting.on_finish(req, status)
        _tracing.record_span("serving.terminal", req.span, 0.0,
                             terminal=status, tokens=len(req.generated))
        req.span.annotate(terminal=status, tokens=len(req.generated),
                          preempts=req.preempts)
        req.span.end(status)
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
        # armed accounting keeps its occupancy gauges and the device
        # memory sample fresh
        self.accounting.update_capacity(self.cache)
