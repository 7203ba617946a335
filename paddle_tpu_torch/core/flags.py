"""The flags the port reads (mirrors ``paddle_tpu/core/flags.py``).

Each flag has a default whose type it keeps (bool, int, float or str),
may be overridden by an environment variable of the same name at import,
and by ``set_flags`` at run time (a value of another type is parsed as
the reference parses it: ``1``/``true``/``yes``/``on`` are a true bool).
Engines read them once, at construction; attention reads
``FLAGS_flash_kernel`` at each call.

Kernel routing and KV storage:

- ``FLAGS_paged_kernel``: ``auto`` (default) launches the paged-decode
  CUDA kernels for CUDA tensors (their plain PyTorch version for CPU
  tensors); ``kernel`` is the same route named explicitly; ``dense`` forces
  the plain gather-then-attend version everywhere. It routes the int8
  weight matmul of ``quantization.ConvertedInt8Linear`` the same way, read
  when a layer is converted.
- ``FLAGS_flash_kernel``: ``auto`` (default) sends CUDA tensors through the
  flash forward/backward CUDA kernels and CPU tensors through their plain
  PyTorch versions; ``plain`` sends CUDA tensors to the plain pair too.
  The A/B switch of the JAX package's ``PADDLE_FLASH_FORCE``;
  ``chip_smoke.py`` uses it to hold the whole model's kernel route against
  the plain one.
- ``FLAGS_kv_cache_dtype``: KV pool storage, read when an engine is
  built: ``""`` (default) keeps the pools in the compute dtype; ``int8``
  stores int8 rows with a float32 scale per (token, kv head) row.

The serving frontend (``serving/``), read when a ``Scheduler`` is built:

- ``FLAGS_serving_max_queue`` (256): admission-queue bound; a submit past
  it raises ``QueueFullError``; 0 = unbounded.
- ``FLAGS_serving_prefill_budget`` (512): prompt tokens (uncovered ones,
  with the prefix cache) prefilled per scheduler step; 0 = unlimited.
- ``FLAGS_serving_prefix_cache`` (True): content-addressed prefix
  caching in the paged pool (shared read-only blocks, copy-on-write, LRU
  reclamation); 0 gives every request private blocks.
- ``FLAGS_serving_prefill_bucket_cap`` (1024): prefill lengths round up to
  power-of-two buckets capped here; 0 pads to a block multiple only.
- ``FLAGS_serving_admission`` (True): deadline-aware admission and
  priority load shedding (``serving/overload.py``).
- ``FLAGS_serving_brownout`` (True): the brownout ladder.
- Overload tuning: ``FLAGS_admission_optimism`` (0.5),
  ``FLAGS_shed_min_queue`` (16), ``FLAGS_shed_queue_frac`` (0.75),
  ``FLAGS_shed_kv_frac`` (0.95), ``FLAGS_shed_wait_s`` (30.0),
  ``FLAGS_brownout_enter_steps`` (3), ``FLAGS_brownout_exit_steps`` (6),
  ``FLAGS_brownout_exit_pressure`` (0.7), ``FLAGS_brownout_clamp_tokens``
  (16).
- ``FLAGS_serving_accounting`` (True): per-request cost attribution and
  engine goodput accounting (``profiler/accounting.py``): each scheduler
  step's wall time is apportioned across the concurrent requests in
  proportion to the tokens they prefilled or decoded, kernel-build time
  billed to the triggering request, re-prefill billed to the preemption;
  0 holds the null accountant (every hook a no-op, ``handle.cost()``
  None).
- ``FLAGS_serving_spec`` (False): self-speculative decoding
  (``serving/spec.py`` and ``Scheduler._decode_spec``): a prompt-lookup
  n-gram proposer drafts up to ``FLAGS_serving_spec_tokens`` tokens per
  request (no second model) and one batched multi-position paged sweep
  verifies them, accepting the longest greedy-matching prefix and rolling
  back rejected rows' blocks before the next step; greedy outputs equal
  non-speculative decode's, and the tier engages only at temperature 0;
  0 keeps the ``serving.spec.*`` counters silent.
- ``FLAGS_serving_spec_tokens`` (4): the most draft tokens proposed per
  request per speculative step (the verify sweep computes 1 + this many
  positions per slot; min 1).
- ``FLAGS_serving_spec_ngram`` (3): the longest trailing n-gram the
  proposer matches against the request's own context (it falls back to
  shorter n-grams down to 1 before giving up).

Request tracing (``profiler/tracing.py``), read at each entry point
(refreshed when ``epoch()`` moves):

- ``FLAGS_trace_enable`` (True): record sampled spans (the serving
  request lifecycle) into the in-process ring; off, every tracing entry
  point is a single global read.
- ``FLAGS_trace_sample`` (1.0): the fraction of root traces sampled
  (decided once per trace at ``start_trace``); children of an unsampled
  root cost the same as disabled tracing.
- ``FLAGS_trace_ring`` (4096): span ring capacity; old spans age out, a
  resize drops the buffered history.

SLO alerts (``profiler/alerts.py``), read at each evaluation:

- ``FLAGS_slo_ttft_budget_us`` (500000): TTFT SLO budget in
  microseconds (burn-rate rule ``slo.ttft_burn``): observations above
  this bucket boundary burn the error budget.
- ``FLAGS_slo_itl_budget_us`` (100000): inter-token-latency SLO budget in
  microseconds (rule ``slo.itl_burn``).
- ``FLAGS_slo_target`` (0.99): SLO target fraction (0.99 = 99 % of
  requests within budget); the burn rate is bad-fraction / (1 - target).
- ``FLAGS_alert_burn_threshold`` (1.0): burn-rate level at which the
  ``slo.*_burn`` alerts fire (1.0 = consuming the whole error budget at
  exactly the rate that exhausts it over the SLO window).
- ``FLAGS_alert_interval_s`` (10.0): least seconds between automatic
  alert evaluations (``AlertManager.maybe_evaluate``: the scheduler calls
  it every step, the ``/alerts`` endpoint too); each interval is one
  rolling delta window.
- ``FLAGS_alert_queue_depth`` (8): the ``queue.growth`` floor: the
  admission queue must be at least this deep (and growing) to fire.

Numerics (``amp/debugging.py``), read by the functional ops' post hook
(``core/dispatch.py``, refreshed on every ``set_flags``):

- ``FLAGS_check_nan_inf`` (False): check every hooked op's output for
  NaN/Inf.
- ``FLAGS_check_nan_inf_level`` (0): 0 raises ``FloatingPointError`` on
  NaN/Inf; any other level warns.
"""

from __future__ import annotations

import os
import threading

_DEFAULTS = {
    "FLAGS_paged_kernel": "auto",
    "FLAGS_flash_kernel": "auto",
    "FLAGS_kv_cache_dtype": "",
    "FLAGS_serving_max_queue": 256,
    "FLAGS_serving_prefill_budget": 512,
    "FLAGS_serving_prefix_cache": True,
    "FLAGS_serving_prefill_bucket_cap": 1024,
    "FLAGS_serving_admission": True,
    "FLAGS_serving_brownout": True,
    "FLAGS_admission_optimism": 0.5,
    "FLAGS_shed_min_queue": 16,
    "FLAGS_shed_queue_frac": 0.75,
    "FLAGS_shed_kv_frac": 0.95,
    "FLAGS_shed_wait_s": 30.0,
    "FLAGS_brownout_enter_steps": 3,
    "FLAGS_brownout_exit_steps": 6,
    "FLAGS_brownout_exit_pressure": 0.7,
    "FLAGS_brownout_clamp_tokens": 16,
    "FLAGS_serving_accounting": True,
    "FLAGS_serving_spec": False,
    "FLAGS_serving_spec_tokens": 4,
    "FLAGS_serving_spec_ngram": 3,
    "FLAGS_trace_enable": True,
    "FLAGS_trace_sample": 1.0,
    "FLAGS_trace_ring": 4096,
    "FLAGS_slo_ttft_budget_us": 500000,
    "FLAGS_slo_itl_budget_us": 100000,
    "FLAGS_slo_target": 0.99,
    "FLAGS_alert_burn_threshold": 1.0,
    "FLAGS_alert_interval_s": 10.0,
    "FLAGS_alert_queue_depth": 8,
    "FLAGS_check_nan_inf": False,
    "FLAGS_check_nan_inf_level": 0,
}


def _parse(value, like):
    t = type(like)
    if isinstance(value, t):
        return value
    s = str(value)
    if t is bool:
        return s.strip().lower() in ("1", "true", "yes", "on")
    return t(s)


_values = {name: _parse(os.environ[name], default)
           if name in os.environ else default
           for name, default in _DEFAULTS.items()}


# bumped on every set_flags: readers that cache flag values (the tracing
# gate) re-read them only when it moves
_epoch = 0
_epoch_lock = threading.Lock()
# called after every set_flags: state that must follow a flag at once
# (the op post hook's armed bit) registers here
_listeners = []


def on_set(fn):
    """Call ``fn()`` after every ``set_flags``."""
    _listeners.append(fn)


def epoch():
    """The settings epoch: moves on every ``set_flags``."""
    return _epoch


def flag(name):
    if name not in _values:
        raise ValueError(f"unknown flag {name!r}")
    return _values[name]


def set_flags(flags: dict):
    for name in flags:
        if name not in _values:
            raise ValueError(f"unknown flag {name!r}")
    global _epoch
    for name, value in flags.items():
        _values[name] = _parse(value, _DEFAULTS[name])
    with _epoch_lock:
        _epoch += 1
    for fn in _listeners:
        fn()


def get_flags(names):
    """{name: value} of the named flags (one name or a list)."""
    if isinstance(names, str):
        names = [names]
    return {name: flag(name) for name in names}

