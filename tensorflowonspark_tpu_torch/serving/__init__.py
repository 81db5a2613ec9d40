"""Continuous-batching serving on PyTorch (slot-based in-flight decode).

* :class:`~tensorflowonspark_tpu_torch.serving.engine.ServingEngine` —
  submit/result/stream/generate/cancel over a persistent slot slab, with
  bounded admission, deadlines, crash-replay recovery and ``drain``.
* :class:`~tensorflowonspark_tpu_torch.serving.fleet.ServingFleet` — a
  router over N engine replicas: load-aware dispatch, admission retries,
  health ejection with failover replay, rolling zero-shed swaps.
* :class:`~tensorflowonspark_tpu_torch.serving.slots.SlotDecoder` /
  :func:`~tensorflowonspark_tpu_torch.serving.slots.chunk_plan` — the
  slab operations and the bucketed-prefill policy.
* :class:`~tensorflowonspark_tpu_torch.serving.scheduler.Request` /
  :class:`~tensorflowonspark_tpu_torch.serving.scheduler.RequestQueue` —
  the host-side bookkeeping.
"""

from tensorflowonspark_tpu_torch.serving.engine import (  # noqa: F401
    ENV_SERVE_HORIZON, ENV_SERVE_MAX_QUEUE, ENV_SERVE_MAX_QUEUED_TOKENS,
    ENV_SERVE_POLL, ENV_SERVE_SLOTS, ENV_SERVE_TTL, ServingEngine)
from tensorflowonspark_tpu_torch.serving.fleet import (  # noqa: F401
    ENV_FLEET_ADMIT_TIMEOUT, ENV_FLEET_MAX_FAILOVERS,
    ENV_FLEET_MAX_REPLICAS, ENV_FLEET_POLL, ENV_FLEET_PROBE_FAILS,
    ENV_FLEET_REPLICAS, FleetRequest, Replica, ServingFleet)
from tensorflowonspark_tpu_torch.serving.scheduler import (  # noqa: F401
    ENV_SERVE_BUCKETS, DeadlineExceeded, PoisonedRequest, Request,
    RequestCancelled, RequestQueue, ServingOverloaded, buckets_from_env,
    new_trace_id)
from tensorflowonspark_tpu_torch.serving.slots import (  # noqa: F401
    DEFAULT_BUCKETS, SlotDecoder, chunk_plan)
