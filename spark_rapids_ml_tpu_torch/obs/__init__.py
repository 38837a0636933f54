"""Observability for the port's serving path: the metrics registry
(``obs.metrics``), its quantile sketches (``obs.quantiles``) and the
pipelined serving program contract (``obs.serving``)."""

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry  # noqa: F401

__all__ = ["get_registry"]
