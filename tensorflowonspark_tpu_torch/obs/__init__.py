"""The port's observability core: ``metrics``, ``spans`` and ``quantiles``.

Copies of the JAX package's ``obs/{metrics,spans,quantiles}.py``, which
the cluster runtime records into (the supervisor's counters and spans,
the rendezvous clock-offset estimate). The shipping plane and the driver
sink (``TOS_OBS=1``: ``collector``, ``device``, ``anomaly``, ``export``)
are ROADMAP Queue 1 item 7; ``cluster.run`` refuses ``TOS_OBS=1`` until
then.
"""

from tensorflowonspark_tpu_torch.obs import metrics, spans  # noqa: F401
