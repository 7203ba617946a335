"""Per-request cost attribution, engine goodput and capacity accounting
(mirrors ``paddle_tpu/profiler/accounting.py``).

Iteration-level batching bills one device step to many concurrent
requests, so "how much did this request cost" is an attribution policy,
not a measurement. The serving scheduler applies this one every step:

- **Token-proportional apportionment.** Each step's measured wall time is
  split across the requests that did work in it, in proportion to the
  positions they computed: a prefill of 64 computed tokens weighs 64, a
  decode 1, a speculative verify of k drafts 1 + k. The split closes by
  construction: per-step attributed shares + directly billed build time
  + the idle remainder of empty steps sum to the measured step time.
- **Kernel builds billed to the trigger.** The seconds a prefill's
  dispatch spent waiting on ``nvcc`` (``kernels._build.
  thread_build_seconds``; the reference bills XLA compiles) bill to that
  request's ``compile_us``; the decode dispatch's split across the step's
  decode participants. On the CPU, and once ``ServingEngine.warmup()``
  has built every kernel, the axis is 0.
- **Re-prefill billed to the preemption.** A preempted victim's
  re-prefill lands in ``reprefill_us`` (and the engine's
  ``accounting.reprefill_us``), not ``prefill_us``.
- **Prefix hits billed at extend-only cost.** A hit's prefill note carries
  only its computed (uncovered, bucketed) tokens; covered tokens are
  free.

Each request accumulates a :class:`CostReport` (``RequestHandle.cost()``);
the engine aggregates goodput (deadline-met tokens per measured second of
stepping), tokens/s and an MFU estimate from the model's matmul FLOPs
over the card's peak (``detect_peak_flops``). Capacity accounting folds
the KV pool's occupancy and the device's allocated bytes into gauges.

Disarmed (``FLAGS_serving_accounting=0``, read when the scheduler is
built) the scheduler holds the preallocated :data:`NULL` accountant whose
hooks are no-ops. ``note_transfer`` and ``note_relay`` (disaggregated
handoff) and ``note_decode_aot_saved`` (an ahead-of-time program cache)
have no caller in the port yet; their axes stay 0.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from . import metrics as _metrics

__all__ = ["CostReport", "Accountant", "NULL", "flops_per_token",
           "matmul_params", "detect_peak_flops"]

# engine-level aggregates (several engines sum into one family)
_c_steps = _metrics.counter("accounting.steps")
_c_device_us = _metrics.counter("accounting.device_us")
_c_attributed_us = _metrics.counter("accounting.attributed_us")
_c_compile_us = _metrics.counter("accounting.compile_us")
_c_reprefill_us = _metrics.counter("accounting.reprefill_us")
_c_idle_us = _metrics.counter("accounting.idle_us")
_c_tokens = _metrics.counter("accounting.tokens_emitted")
_c_processed = _metrics.counter("accounting.tokens_processed")
_c_goodput = _metrics.counter("accounting.goodput_tokens")
_c_missed = _metrics.counter("accounting.deadline_missed_tokens")
# time an ahead-of-time program cache saved: informational, outside the
# closure (saved time never ran)
_c_aot_saved = _metrics.counter("accounting.aot_saved_us")
_g_mfu = _metrics.gauge("accounting.mfu")
_g_active = _metrics.gauge("serving.kv.active_blocks")
_g_free = _metrics.gauge("serving.kv.free_blocks")
_g_pool_bytes = _metrics.gauge("serving.kv.pool_bytes")
_g_live_bytes = _metrics.gauge("memory.live_bytes")


class CostReport:
    """One request's accumulated bill. Time fields are microseconds of
    attributed step wall time (they sum across concurrent requests to the
    engine's measured step time), except ``queue_us`` and ``ttft_us``,
    this request's own latencies."""

    __slots__ = ("rid", "status", "queue_us", "prefill_us",
                 "reprefill_us", "decode_us", "compile_us",
                 "aot_saved_us", "ttft_us", "transfer_us",
                 "transfer_bytes", "relay_us",
                 "tokens_prefilled", "tokens_decoded", "tokens_emitted",
                 "covered_tokens", "spec_proposed", "spec_accepted",
                 "preempts", "steps", "deadline_met")

    def __init__(self, rid):
        self.rid = rid
        self.status = None          # terminal RequestStatus, at finish
        self.queue_us = 0.0
        self.prefill_us = 0.0       # attributed first-prefill share
        self.reprefill_us = 0.0     # attributed re-prefill share
        self.decode_us = 0.0        # attributed decode-step shares
        self.compile_us = 0.0       # kernel builds this request triggered
        self.aot_saved_us = 0.0     # informational, outside attributed_us
        self.ttft_us = None
        self.transfer_us = 0.0      # KV handoff wall time (informational)
        self.transfer_bytes = 0
        self.relay_us = 0.0         # token-relay serve time (informational)
        self.tokens_prefilled = 0   # computed (padded) prefill tokens
        self.tokens_decoded = 0     # tokens from decode steps
        self.tokens_emitted = 0     # tokens streamed (prefill + decode)
        self.covered_tokens = 0     # prefix-cache tokens served free
        self.spec_proposed = 0      # draft tokens verified for it
        self.spec_accepted = 0      # ...of which greedy decode accepted
        self.preempts = 0
        self.steps = 0              # scheduler steps it was billed in
        self.deadline_met = None    # None: no deadline; else bool

    @property
    def attributed_us(self):
        """Total step time billed to this request."""
        return (self.prefill_us + self.reprefill_us + self.decode_us
                + self.compile_us)

    def as_dict(self):
        return {k: getattr(self, k) for k in self.__slots__} | {
            "attributed_us": self.attributed_us}

    def clone(self):
        c = CostReport(self.rid)
        for k in self.__slots__:
            setattr(c, k, getattr(self, k))
        return c

    def summary(self):
        """One human line: the request's bill."""
        dl = "" if self.deadline_met is None else \
            f" deadline_met={self.deadline_met}"
        ttft = f"{self.ttft_us / 1000.0:.1f}ms" \
            if self.ttft_us is not None else "n/a"
        return (f"rid={self.rid} status={self.status} "
                f"queue={self.queue_us / 1000.0:.1f}ms ttft={ttft} | "
                f"attributed={self.attributed_us / 1000.0:.2f}ms "
                f"(prefill={self.prefill_us / 1000.0:.2f} "
                f"decode={self.decode_us / 1000.0:.2f} "
                f"compile={self.compile_us / 1000.0:.2f} "
                f"reprefill={self.reprefill_us / 1000.0:.2f}) | "
                f"tokens={self.tokens_emitted} "
                f"prefilled={self.tokens_prefilled} "
                f"covered={self.covered_tokens} "
                + (f"spec={self.spec_accepted}/{self.spec_proposed} "
                   if self.spec_proposed else "")
                + f"preempts={self.preempts}{dl}")

    def __repr__(self):
        return f"CostReport({self.summary()})"


# -- model FLOPs / MFU ------------------------------------------------------

def matmul_params(config):
    """Matmul parameters of a transformer config (attention projections,
    MLP, LM head; norms and embeddings do no per-token matmul). None when
    a field is missing."""
    try:
        h = config.hidden_size
        head_dim = h // config.num_heads
        per_layer = (2 * h * config.num_heads * head_dim          # q, o
                     + 2 * h * config.num_kv_heads * head_dim     # k, v
                     + 3 * h * config.intermediate_size)          # mlp
        return (config.num_layers * per_layer
                + config.vocab_size * h)                          # lm head
    except AttributeError:
        return None


def flops_per_token(config):
    """Forward FLOPs per computed token: 2 x matmul parameters (attention
    scores, which grow with context, are left out, so the MFU derived
    from it reads slightly high at long context). None for an unknown
    config."""
    p = matmul_params(config)
    return None if p is None else 2.0 * p


# dense bf16 tensor-core peak by device name (NVIDIA's data sheets, dense
# rates without sparsity), for the MFU gauge; ACCOUNTING_PEAK_FLOPS
# overrides it
_PEAK_FLOPS = (
    ("h100 80gb hbm3", 989e12),   # H100 SXM
    ("h100 pcie", 756e12),
)


def detect_peak_flops(device=None):
    """Peak FLOP/s for the MFU estimate: the ``ACCOUNTING_PEAK_FLOPS``
    environment override, else the card's entry in the table above. None
    (MFU not reported) on the CPU, for a ``device`` that is not CUDA, and
    on a card the table does not know."""
    env = os.environ.get("ACCOUNTING_PEAK_FLOPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    import torch
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device).lower()
    for sub, peak in _PEAK_FLOPS:
        if sub in name:
            return peak
    return None


class _Note:
    """One unit of a step's work awaiting apportionment."""

    __slots__ = ("req", "kind", "tokens", "compile_us", "aot_saved_us",
                 "emitted")

    def __init__(self, req, kind, tokens, compile_us=0.0,
                 aot_saved_us=0.0, emitted=1):
        self.req = req
        self.kind = kind          # "prefill" | "reprefill" | "decode"
        self.tokens = tokens      # apportionment weight (computed positions)
        self.compile_us = compile_us
        self.aot_saved_us = aot_saved_us
        self.emitted = emitted    # tokens streamed to the caller


# seconds between two samples of the device's allocated bytes
_HBM_SAMPLE_S = 2.0


class Accountant:
    """One engine's attribution state machine. The scheduler drives it:
    ``step_begin`` -> ``note_*`` during the step -> ``step_end``
    (apportionment), ``on_finish`` at each terminal status. Not
    thread-safe by itself: the engine's lock serializes steps."""

    armed = True

    def __init__(self, config=None, peak_flops=None, step_log_cap=2048,
                 device=None):
        self.flops_per_token = flops_per_token(config) \
            if config is not None else None
        self.peak_flops = peak_flops if peak_flops is not None \
            else detect_peak_flops(device)
        self.device = device
        # engine-local totals (the registry counters sum engines)
        self.device_us = 0.0
        self.attributed_us = 0.0
        self.compile_us = 0.0
        self.aot_saved_us = 0.0
        self.reprefill_us = 0.0
        self.idle_us = 0.0
        self.tokens_emitted = 0    # tokens streamed to callers
        self.tokens_processed = 0  # computed (padded) prefill + decode
        self.goodput_tokens = 0
        self.missed_tokens = 0
        self.requests_finished = 0
        # per-step closure log
        self.step_log = deque(maxlen=step_log_cap)
        self._notes = []
        self._decode_compile_us = 0.0
        self._decode_aot_saved_us = 0.0
        self._last_hbm_sample = 0.0
        self._lock = threading.Lock()  # engine_report vs step_end

    # -- scheduler hooks (one step = begin .. notes .. end) ---------------

    def attach(self, req):
        """Bind a fresh CostReport at submit."""
        req.cost = CostReport(req.rid)

    def step_begin(self):
        self._notes = []
        self._decode_compile_us = 0.0
        self._decode_aot_saved_us = 0.0

    def note_queue_wait(self, req, wait_us):
        if req.cost is not None:
            req.cost.queue_us = float(wait_us)

    def note_prefill(self, req, computed_tokens, covered, compile_us,
                     reprefill, aot_saved_us=0.0):
        """A prefill ran for ``req`` this step: ``computed_tokens`` is the
        padded tail it computed (covered prefix tokens are not in it),
        ``compile_us`` the kernel builds its dispatch waited on (billed to
        this request)."""
        kind = "reprefill" if reprefill else "prefill"
        self._notes.append(_Note(req, kind, max(int(computed_tokens), 1),
                                 float(compile_us), float(aot_saved_us)))
        c = req.cost
        if c is not None:
            c.tokens_prefilled += int(computed_tokens)
            c.covered_tokens += int(covered)
            c.tokens_emitted += 1

    def note_decode(self, req):
        """``req`` got one token from this step's batched decode."""
        self._notes.append(_Note(req, "decode", 1))
        c = req.cost
        if c is not None:
            c.tokens_decoded += 1
            c.tokens_emitted += 1

    def note_spec(self, req, emitted, proposed, accepted):
        """``req`` took part in this step's speculative verify sweep: the
        device computed ``1 + proposed`` positions for it (the
        apportionment weight, so rejected drafts bill real device time to
        the request that proposed them) and ``emitted`` tokens (1 +
        accepted, cut at eos) streamed to the caller."""
        self._notes.append(_Note(req, "decode", 1 + int(proposed),
                                 emitted=int(emitted)))
        c = req.cost
        if c is not None:
            c.tokens_decoded += int(emitted)
            c.tokens_emitted += int(emitted)
            c.spec_proposed += int(proposed)
            c.spec_accepted += int(accepted)

    def note_transfer(self, req, transfer_us, transfer_bytes):
        """``req`` arrived by a disaggregated KV handoff: bill the fabric
        time and bytes (informational, outside the step closure)."""
        c = req.cost
        if c is not None:
            c.transfer_us += float(transfer_us)
            c.transfer_bytes += int(transfer_bytes)

    def note_relay(self, req, relay_us):
        """``req`` is served to a remote caller over a token relay: bill
        one pull's handling time (informational)."""
        c = req.cost
        if c is not None:
            c.relay_us += float(relay_us)

    def note_decode_compile(self, compile_us):
        """Kernel builds around the batched decode dispatch: split across
        this step's decode participants."""
        if compile_us > 0.0:
            self._decode_compile_us += float(compile_us)

    def note_decode_aot_saved(self, saved_us):
        """Build time a program cache avoided around the decode dispatch
        (informational axis, split like :meth:`note_decode_compile`)."""
        if saved_us > 0.0:
            self._decode_aot_saved_us += float(saved_us)

    def step_end(self, step_us):
        """Apportion the measured step time: direct build bills first
        (clamped to the step), the remainder across the notes by tokens.
        attributed + compile + idle == step_us holds by construction."""
        step_us = float(step_us)
        notes = self._notes
        dec_notes = sum(1 for n in notes if n.kind == "decode")
        if dec_notes and self._decode_compile_us > 0.0:
            share = self._decode_compile_us / dec_notes
            for n in notes:
                if n.kind == "decode":
                    n.compile_us += share
        if dec_notes and self._decode_aot_saved_us > 0.0:
            share = self._decode_aot_saved_us / dec_notes
            for n in notes:
                if n.kind == "decode":
                    n.aot_saved_us += share
        total_compile = sum(n.compile_us for n in notes)
        total_saved = sum(n.aot_saved_us for n in notes)
        scale = 1.0
        if total_compile > step_us:
            # two clocks can disagree at the edge: never bill past the step
            scale = step_us / total_compile
        direct = min(total_compile * scale, step_us)
        remainder = step_us - direct
        total_tokens = sum(n.tokens for n in notes)
        attributed = 0.0
        reprefill = 0.0
        stepped = set()  # billed twice in a step (prefill + decode): one step
        for n in notes:
            share = remainder * (n.tokens / total_tokens) \
                if total_tokens else 0.0
            bill = n.compile_us * scale
            c = n.req.cost
            if c is not None:
                if n.kind == "prefill":
                    c.prefill_us += share
                elif n.kind == "reprefill":
                    c.reprefill_us += share
                else:
                    c.decode_us += share
                c.compile_us += bill
                c.aot_saved_us += n.aot_saved_us
                if id(c) not in stepped:
                    stepped.add(id(c))
                    c.steps += 1
            attributed += share
            if n.kind == "reprefill":
                reprefill += share
        idle = step_us - attributed - direct if not notes else 0.0
        # emitted: tokens streamed (a verify note streams 1 + accepted);
        # the weights (padded tails, computed draft positions) are the
        # "processed" axis
        emitted = sum(n.emitted for n in notes)
        with self._lock:
            self.device_us += step_us
            self.attributed_us += attributed
            self.compile_us += direct
            self.aot_saved_us += total_saved
            self.reprefill_us += reprefill
            self.idle_us += idle
            self.tokens_emitted += emitted
            self.tokens_processed += total_tokens
        self.step_log.append({"step_us": step_us,
                              "attributed_us": attributed,
                              "compile_us": direct, "idle_us": idle,
                              "aot_saved_us": total_saved,
                              "notes": len(notes)})
        _c_steps.inc()
        _c_device_us.inc(step_us)
        _c_attributed_us.inc(attributed)
        _c_compile_us.inc(direct)
        if total_saved:
            _c_aot_saved.inc(total_saved)
        _c_reprefill_us.inc(reprefill)
        _c_idle_us.inc(idle)
        if notes:
            _c_tokens.inc(emitted)
            _c_processed.inc(total_tokens)
        self._notes = []
        self._decode_compile_us = 0.0
        self._decode_aot_saved_us = 0.0

    def on_finish(self, req, status):
        """Close the request's report at its terminal status and fold it
        into goodput: deadline-met tokens count (no deadline + DONE counts
        as met)."""
        c = req.cost
        if c is None:
            return
        c.status = status
        c.preempts = req.preempts
        if req.first_token_at is not None:
            c.ttft_us = (req.first_token_at - req.submitted_at) * 1e6
        tokens = len(req.generated)
        met = None
        if status == "DONE":
            met = True if req.deadline is None \
                else not req.deadline.expired()
        elif req.deadline is not None and req.deadline.expired():
            # a cancel or error before the deadline passed is no miss
            met = False
        c.deadline_met = met
        with self._lock:
            self.requests_finished += 1
            if status == "DONE" and met is not False:
                self.goodput_tokens += tokens
                _c_goodput.inc(tokens)
            elif met is False:
                self.missed_tokens += tokens
                _c_missed.inc(tokens)

    # -- capacity accounting ----------------------------------------------

    def update_capacity(self, cache):
        """Refresh the KV occupancy gauges from the pool's host state
        (every step), the MFU gauge, and, at most every ``_HBM_SAMPLE_S``
        seconds, the device's allocated bytes. Returns the occupancy."""
        occ = cache.occupancy()
        _g_active.set(occ["active"])
        _g_free.set(occ["free"])
        _g_pool_bytes.set(cache.pool_bytes())
        if self.flops_per_token and self.peak_flops and self.device_us:
            _g_mfu.set(round(
                (self.tokens_processed / (self.device_us / 1e6))
                * self.flops_per_token / self.peak_flops, 6))
        now = time.monotonic()
        if now - self._last_hbm_sample >= _HBM_SAMPLE_S:
            self._last_hbm_sample = now
            self._sample_hbm(cache.device)
        return occ

    @staticmethod
    def _sample_hbm(device):
        """``memory.live_bytes``: the bytes the caching allocator holds in
        tensors on a CUDA device (the reference sums JAX's live arrays);
        not set for the CPU."""
        import torch
        if torch.device(device).type == "cuda":
            _g_live_bytes.set(int(torch.cuda.memory_allocated(device)))

    # -- aggregates -------------------------------------------------------

    def engine_report(self):
        """Engine goodput: deadline-met tokens per measured second of
        stepping (build time and idle steps included), raw tokens/s and
        the MFU estimate (None without a known peak). Safe from any
        thread."""
        with self._lock:
            device_s = self.device_us / 1e6
            tokens = self.tokens_emitted
            goodput_tokens = self.goodput_tokens
            rep = {"device_s": device_s,
                   "tokens": tokens,
                   "tokens_processed": self.tokens_processed,
                   "goodput_tokens": goodput_tokens,
                   "missed_tokens": self.missed_tokens,
                   "requests_finished": self.requests_finished,
                   "attributed_us": self.attributed_us,
                   "compile_us": self.compile_us,
                   "aot_saved_us": self.aot_saved_us,
                   "reprefill_us": self.reprefill_us,
                   "idle_us": self.idle_us}
        tps = tokens / device_s if device_s > 0 else 0.0
        rep["tokens_per_device_s"] = tps
        rep["goodput_tokens_per_device_s"] = \
            goodput_tokens / device_s if device_s > 0 else 0.0
        mfu = None
        if self.flops_per_token and self.peak_flops and device_s > 0:
            # compute utilization: the processed-token axis (padded
            # prefill tails and draft positions included)
            mfu = (rep["tokens_processed"] / device_s) \
                * self.flops_per_token / self.peak_flops
            _g_mfu.set(round(mfu, 6))
        rep["mfu"] = mfu
        return rep

    def goodput_line(self):
        """The one-line engine summary."""
        r = self.engine_report()
        mfu = f"{r['mfu']:.3f}" if r["mfu"] is not None else "n/a"
        return (f"goodput: {r['goodput_tokens_per_device_s']:.1f} "
                f"deadline-met tok/s over {r['device_s']:.2f} device-s "
                f"({r['tokens_per_device_s']:.1f} tok/s raw, "
                f"mfu~{mfu}; compile {r['compile_us'] / 1000:.1f}ms, "
                f"reprefill waste {r['reprefill_us'] / 1000:.1f}ms, "
                f"idle {r['idle_us'] / 1000:.1f}ms)")


class _NullAccountant(Accountant):
    """Disarmed accounting: every hook is a no-op and ``req.cost`` stays
    None, so ``RequestHandle.cost()`` returns None."""

    armed = False

    def __init__(self):  # no registry traffic, no config math
        pass

    def attach(self, req):
        pass

    def step_begin(self):
        pass

    def note_queue_wait(self, req, wait_us):
        pass

    def note_prefill(self, req, computed_tokens, covered, compile_us,
                     reprefill, aot_saved_us=0.0):
        pass

    def note_decode(self, req):
        pass

    def note_spec(self, req, emitted, proposed, accepted):
        pass

    def note_transfer(self, req, transfer_us, transfer_bytes):
        pass

    def note_relay(self, req, relay_us):
        pass

    def note_decode_compile(self, compile_us):
        pass

    def note_decode_aot_saved(self, saved_us):
        pass

    def step_end(self, step_us):
        pass

    def on_finish(self, req, status):
        pass

    def update_capacity(self, cache):
        pass

    def engine_report(self):
        return None

    def goodput_line(self):
        return "goodput: accounting disarmed (FLAGS_serving_accounting=0)"


NULL = _NullAccountant()
