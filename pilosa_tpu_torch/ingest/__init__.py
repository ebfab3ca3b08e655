"""Streaming bulk ingest (counterpart of pilosa_tpu/ingest/).

- ``codec``: the columnar binary wire format of the ingest route
  (``application/x-pilosa-ingest``) beside its JSON twin.
- ``pipeline``: the IngestPipeline — slice partitioning, the classify
  pass on the holder's device (ops/ingest.py) and the install that lands
  compressed containers.
"""
from pilosa_tpu_torch.ingest import codec  # noqa: F401
from pilosa_tpu_torch.ingest.pipeline import IngestPipeline  # noqa: F401
