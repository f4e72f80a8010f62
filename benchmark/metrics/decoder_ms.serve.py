"""Milliseconds of a request in the decoder (``pixel_decoder``): CUDA
events of forward hooks, averaged over every request of the traced run's
window."""

from benchmark.harness.readers import stage_ms


def read(record):
    return stage_ms(record, "decoder")
