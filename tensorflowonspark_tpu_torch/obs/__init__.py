"""Cluster-wide observability plane of the port.

Counterpart of ``tensorflowonspark_tpu/obs/``, with the reference's knob,
metric, span and alert names, so ``docs/OBSERVABILITY.md``'s catalogue
describes the port too:

- ``metrics``   — process-local counters/gauges/fixed-bucket histograms
                  and quantile sketches, snapshot/delta arithmetic
- ``quantiles`` — the mergeable streaming sketch behind ``serve.ttft_ms``
                  and the other latency objects
- ``spans``     — monotonic-clock span/event recording (bounded, never
                  blocking) + driver-anchored clock-offset estimation
                  piggybacked on rendezvous round-trips
- ``collector`` — executor-side delta shipper (the rendezvous ``OBS``
                  verb) and the driver-side ``ObsSink`` aggregation
- ``export``    — per-process JSONL event logs (``TOS_OBS_DIR``),
                  Prometheus text exposition, merged Chrome-trace JSON
- ``profiler``  — ``torch.profiler`` traces, ``StepTimer`` (feeds the
                  registry) and MFU accounting against the card's peak
- ``device``    — compile/device tier: the shape-keyed recompile
                  sentinel, native-build compile events, analytic cost
                  gauges, card-memory gauges on the shipper cadence
- ``slo``       — declared objectives (``TOS_SLO_*``) and burn-rate
                  verdicts over the merged sketches
- ``anomaly``   — the driver-side detector loop consuming the sink
                  online: straggler / feed-stall / recompile-storm /
                  serving-saturation / memory-slope / SLO-burn alerts and
                  the rest of the catalogue, fanned out to the registry,
                  the supervisor event stream, the driver JSONL and the
                  rendezvous ``HEALTH`` verb

Everything is off (one cached None check per seam) until ``TOS_OBS=1``.

Only the dependency-free core (``metrics``, ``spans``) is imported here:
``collector`` reaches into the rendezvous control plane, which itself
imports ``obs.spans``, so an eager re-export would cycle.
"""

from tensorflowonspark_tpu_torch.obs import metrics, spans  # noqa: F401
