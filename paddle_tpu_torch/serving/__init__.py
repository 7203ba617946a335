"""LLM serving over the paged KV cache (mirrors ``paddle_tpu/serving``):
an iteration-level continuous-batching scheduler (FCFS admission with a
prefill token budget, the prefix cache, preemption instead of
truncation), a thread-safe streaming frontend with deadlines,
cancellation and a WARMING -> READY -> DRAINING -> CLOSED lifecycle,
prefill length bucketing, and overload control (deadline-aware
admission, priority shedding, a brownout ladder).

    from paddle_tpu_torch.serving import ServingEngine

    eng = ServingEngine(model, max_batch=8, max_seq_len=2048)
    h = eng.submit(prompt_ids, max_new_tokens=128, deadline_s=30.0)
    for tok in h.stream():
        ...
    assert h.status == "DONE"
"""

from . import overload
from .bucketing import bucket_length, bucket_lengths
from .frontend import (AdmissionRejected, Lifecycle, NotReadyError,
                       QueueFullError, RequestHandle, RequestStatus,
                       ServingEngine)
from .scheduler import Scheduler, ServingRequest

__all__ = ["ServingEngine", "RequestHandle", "RequestStatus",
           "QueueFullError", "AdmissionRejected", "Lifecycle",
           "NotReadyError", "Scheduler", "ServingRequest", "overload",
           "bucket_length", "bucket_lengths"]
