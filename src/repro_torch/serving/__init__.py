"""Serving layer: batched QR-as-a-service (QRService) — bucket dynamic
traffic into a small set of padded shapes, keep a prepared plan per
bucket, keep steady state free of plan builds.

Counterpart of the reference's ``repro.serving`` without its LM decode
engine (``ServeEngine``, ``serve_step``), which belongs to the LM
workload's port."""

from repro_torch.serving.bucketing import (
    BucketKey, BucketingPolicy, bucket_key, bucketize, group_shape_classes,
    pad_batch, pad_dim, pow2ish_edges)
from repro_torch.serving.qr_service import QRRequest, QRResult, QRService

__all__ = [
    "BucketKey",
    "BucketingPolicy",
    "QRRequest",
    "QRResult",
    "QRService",
    "bucket_key",
    "bucketize",
    "group_shape_classes",
    "pad_batch",
    "pad_dim",
    "pow2ish_edges",
]
