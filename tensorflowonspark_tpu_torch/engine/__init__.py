"""Executor-engine abstraction: the port's copy of the JAX package's
``engine/`` (``Engine``, ``EngineJob`` and the multi-process
``LocalEngine``).

``SparkEngine`` (the pyspark adapter) is ROADMAP Queue 1 item 11;
``get_engine("spark")`` refuses it by name until then.
"""

from tensorflowonspark_tpu_torch.engine.base import (  # noqa: F401
    Engine, EngineJob)
from tensorflowonspark_tpu_torch.engine.local import LocalEngine  # noqa: F401


def get_engine(name: str = "local", **kwargs) -> Engine:
  """Engine factory: ``'local'`` (``'spark'`` is not ported yet)."""
  if name == "local":
    return LocalEngine(**kwargs)
  if name == "spark":
    raise NotImplementedError(
        "SparkEngine is not ported to PyTorch yet (ROADMAP Queue 1 item 11); "
        "use LocalEngine")
  raise ValueError("unknown engine: %r" % name)
