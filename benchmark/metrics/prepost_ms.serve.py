"""Milliseconds of a request outside the encoder and the decoder: the
request's CUDA-event time (from handing the batch to ``infer`` to its depth
and intrinsics in host memory) less the two stages', averaged over every
request of the traced run's window."""

from benchmark.harness.readers import prepost_ms as read  # noqa: F401
