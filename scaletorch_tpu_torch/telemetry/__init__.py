"""Telemetry primitives of the PyTorch port (latency histograms)."""

from scaletorch_tpu_torch.telemetry.histogram import (  # noqa: F401
    DEFAULT_SCHEMA,
    BucketSchema,
    LogHistogram,
)
