"""Milliseconds of a request in the encoder: CUDA events of forward
hooks on the module ``infer`` calls (``_serving_encoder()``), averaged over
every request of the traced run's window."""

from benchmark.harness.readers import stage_ms


def read(record):
    return stage_ms(record, "encoder")
