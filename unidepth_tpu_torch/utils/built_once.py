"""Tensors built from host data once per argument tuple.

Building a device tensor from host data (``torch.tensor(list, device=...)``,
``torch.as_tensor(array, device=...)``) copies from pageable memory, which
makes the host wait for the device, and cannot be captured into a CUDA
graph. ``built_once`` builds such a constant at its first call with given
arguments and returns the same tensor afterwards: built outside inference
mode, so autograd may save it, and never to be written in place. A trace
(``torch.export``, ``torch.compile``) builds its own each time, since a
tensor made under it is the trace's (fake under export) and must not be
kept for later calls.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["built_once"]


def built_once(maxsize: int | None = 64):
    """Decorator: ``fn(*args)``, which returns a tensor built from host
    data, built once per (hashable) argument tuple, the last ``maxsize``
    kept."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            if torch.compiler.is_compiling():
                return fn(*args, **kwargs)
            with torch.inference_mode(False):
                return cached(*args, **kwargs)

        get.cache_clear = cached.cache_clear
        return get

    return wrap
