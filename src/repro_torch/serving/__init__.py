"""Serving layer: autoregressive LM decode (ServeEngine, serve_step) and
batched QR-as-a-service (QRService) — bucket dynamic traffic into a
small set of padded shapes, keep a prepared plan per bucket, keep steady
state free of plan builds.

Counterpart of the reference's ``repro.serving``."""

from repro_torch.serving.bucketing import (
    BucketKey, BucketingPolicy, bucket_key, bucketize, group_shape_classes,
    pad_batch, pad_dim, pow2ish_edges)
from repro_torch.serving.engine import ServeEngine, serve_step
from repro_torch.serving.qr_service import QRRequest, QRResult, QRService

__all__ = [
    "BucketKey",
    "BucketingPolicy",
    "QRRequest",
    "QRResult",
    "QRService",
    "ServeEngine",
    "bucket_key",
    "bucketize",
    "group_shape_classes",
    "pad_batch",
    "pad_dim",
    "pow2ish_edges",
    "serve_step",
]
