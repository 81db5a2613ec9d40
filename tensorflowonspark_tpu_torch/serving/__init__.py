"""Continuous-batching serving on PyTorch (slot-based in-flight decode).

* :class:`~tensorflowonspark_tpu_torch.serving.engine.ServingEngine` —
  submit/result/stream/generate/cancel over a persistent slot slab, with
  bounded admission, deadlines, crash-replay recovery and ``drain``.
* :class:`~tensorflowonspark_tpu_torch.serving.fleet.ServingFleet` — a
  router over N engine replicas: load-aware dispatch, admission retries,
  health ejection with failover replay, rolling zero-shed swaps.
* :class:`~tensorflowonspark_tpu_torch.serving.registry.ModelRegistry` —
  the durable train→serve seam: atomic versioned publish, ``watch()``,
  quarantine, ref-counted GC.
* :class:`~tensorflowonspark_tpu_torch.serving.deploy.DeploymentController`
  — canary rollout: CANARY → VERIFY (greedy parity + counter/SLO
  deltas) → PROMOTE or ROLLBACK + quarantine, zero-shed, with
  ``resume`` converging the fleet after a controller death.
* :class:`~tensorflowonspark_tpu_torch.serving.host.ServingHost` /
  :class:`~tensorflowonspark_tpu_torch.serving.remote.RemoteReplica` —
  cross-host serving: engines in executor processes syncing over the
  rendezvous wire (SHREG/SHSYNC/SHBYE) behind driver-side replica
  proxies, so the same fleet routes, ejects, replays and swaps across
  process boundaries.
* :class:`~tensorflowonspark_tpu_torch.serving.slots.SlotDecoder` /
  :func:`~tensorflowonspark_tpu_torch.serving.slots.chunk_plan` — the
  slab operations and the bucketed-prefill policy.
* :class:`~tensorflowonspark_tpu_torch.serving.scheduler.Request` /
  :class:`~tensorflowonspark_tpu_torch.serving.scheduler.RequestQueue` /
  :class:`~tensorflowonspark_tpu_torch.serving.scheduler.PagePool` /
  :class:`~tensorflowonspark_tpu_torch.serving.scheduler.PrefixCache` —
  the host-side bookkeeping, the KV page allocator and the prefix trie.

The decode-speed stack: ``TOS_SERVE_PAGE_SIZE`` pages the KV slab,
``TOS_SERVE_PREFIX_PAGES`` turns on prefix sharing over it, and
``TOS_SERVE_SPEC_DEPTH`` enables self-speculative decoding; each keeps
every request's tokens equal to its single-request greedy decode.
"""

from tensorflowonspark_tpu_torch.serving.engine import (  # noqa: F401
    ENV_SERVE_HORIZON, ENV_SERVE_MAX_QUEUE, ENV_SERVE_MAX_QUEUED_TOKENS,
    ENV_SERVE_NUM_PAGES, ENV_SERVE_PAGE_SIZE, ENV_SERVE_POLL,
    ENV_SERVE_PREFIX_PAGES, ENV_SERVE_SLOTS, ENV_SERVE_SPEC_DEPTH,
    ENV_SERVE_SPEC_LAYERS, ENV_SERVE_TTL, ServingEngine)
from tensorflowonspark_tpu_torch.serving.deploy import (  # noqa: F401
    ENV_DEPLOY_BAKE, ENV_DEPLOY_POLL, ENV_DEPLOY_SLICE,
    ENV_DEPLOY_SPOT_CHECKS, ENV_DEPLOY_SWAP_TIMEOUT,
    ENV_DEPLOY_TTFT_RATIO, ControllerKilled, DeploymentController)
from tensorflowonspark_tpu_torch.serving.host import (  # noqa: F401
    ENV_HOST_BUILD, ENV_HOST_SYNC, ServingHost, build_engine_from_manifest,
    cfg_wire, make_serving_host_main, run_host_thread, start_host_process)
from tensorflowonspark_tpu_torch.serving.remote import (  # noqa: F401
    ENV_HOST_ADMIT, ENV_HOST_CHUNK, ENV_HOST_START, ENV_HOST_TIMEOUT,
    RemoteReplica, RemoteRequest, ServingHostPlane, attach_serving_plane,
    remote_engine_factory, wire_health_probe)
from tensorflowonspark_tpu_torch.serving.fleet import (  # noqa: F401
    ENV_FLEET_ADMIT_TIMEOUT, ENV_FLEET_MAX_FAILOVERS,
    ENV_FLEET_MAX_REPLICAS, ENV_FLEET_POLL, ENV_FLEET_PROBE_FAILS,
    ENV_FLEET_REPLICAS, FleetRequest, Replica, ServingFleet)
from tensorflowonspark_tpu_torch.serving.registry import (  # noqa: F401
    ENV_REGISTRY_KEEP, ENV_REGISTRY_POLL, ModelRegistry)
from tensorflowonspark_tpu_torch.serving.scheduler import (  # noqa: F401
    ENV_SERVE_BUCKETS, DeadlineExceeded, PagePool, PoisonedRequest,
    PrefixCache, Request, RequestCancelled, RequestQueue, ServingOverloaded,
    buckets_from_env, new_trace_id)
from tensorflowonspark_tpu_torch.serving.slots import (  # noqa: F401
    DEFAULT_BUCKETS, SlotDecoder, chunk_plan)
