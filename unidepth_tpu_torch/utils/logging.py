"""Training observability (counterpart of unidepth_tpu/utils/logging.py).

``MetricLogger`` writes one JSON record a ``log`` call to
``<out_dir>/<run_name>.jsonl`` and keeps the EMA of every finite value (the
reference's EMA loss dicts). ``log_image`` saves a (H, W, 3) uint8 artifact
as a PNG under ``<out_dir>/artifacts`` through the port's own codec
(``utils/png.py``, no PIL) and records its path in the stream;
``memory_stats`` reads the card's allocator (``torch.cuda.memory_stats``)
and the host's resident set.

The JAX logger also attaches wandb whenever it imports; the port's does
not (wandb's ``init`` reaches for its server), which is what the JAX logger
does where wandb is not installed.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from unidepth_tpu_torch.utils.png import write_png

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, run_name: str = "unidepth_tpu_torch", out_dir=None):
        self.run_name = run_name
        self.t0 = time.time()
        self._jsonl = None
        if out_dir:
            Path(out_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(Path(out_dir) / f"{run_name}.jsonl", "a")
        self.ema: dict[str, float] = {}

    def _write(self, record: dict) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def log(self, metrics: dict, step: int, prefix: str = "train") -> dict:
        """Record ``metrics`` (name -> number or 0-d tensor) under
        ``prefix/``; returns the EMA dict (0.99 a step; NaN and |v| >= 1e30
        are kept out of it)."""
        flat = {f"{prefix}/{k}": float(v) for k, v in metrics.items()}
        for k, v in flat.items():
            if v == v and abs(v) < 1e30:
                self.ema[k] = 0.99 * self.ema.get(k, v) + 0.01 * v
        self._write({"step": step, "t": round(time.time() - self.t0, 1), **flat})
        return self.ema

    def log_image(self, name: str, image, step: int) -> str | None:
        """Save ``image`` as ``artifacts/<name>_<step>.png`` beside the JSONL
        stream and record its path there; returns the path (None without an
        ``out_dir``)."""
        path = None
        if self._jsonl is not None:
            art_dir = Path(self._jsonl.name).parent / "artifacts"
            art_dir.mkdir(exist_ok=True)
            path = str(art_dir / f"{name}_{step}.png")
            write_png(path, np.asarray(image))
            self._write({"step": step, f"image/{name}": path})
        return path

    def memory_stats(self) -> dict:
        """The card's allocated and peak bytes (where there is a card) and the
        host's resident set in kB."""
        out = {}
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stats = torch.cuda.memory_stats()
            out["device_bytes_in_use"] = stats.get("allocated_bytes.all.current", 0)
            out["device_peak_bytes"] = stats.get("allocated_bytes.all.peak", 0)
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        out["host_rss_kb"] = int(line.split()[1])
        except OSError:
            pass
        return out

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
