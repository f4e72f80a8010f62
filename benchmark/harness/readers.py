"""What the per-layer metrics' readers (``benchmark/metrics/<name>.py``)
compute from a traced run's record (``harness/session.py`` describes it).
Each returns None where the record holds nothing to read."""

from __future__ import annotations


def _mean(values):
    return sum(values) / len(values) if values else None


def stage_ms(record, stage: str):
    """Mean CUDA-event milliseconds of ``stage`` over the window's requests."""
    return _mean([r[f"{stage}_ms"] for r in record["requests"] if f"{stage}_ms" in r])


def prepost_ms(record):
    """Mean milliseconds of a request outside the encoder and decoder."""
    return _mean([r["request_ms"] - r["encoder_ms"] - r["decoder_ms"] for r in record["requests"]
                  if "request_ms" in r and "encoder_ms" in r and "decoder_ms" in r])


def idle_share(record):
    """Percent of the traced span with no device operation running."""
    trace = record.get("trace")
    if not trace or trace["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["span_s"])


def _work(record, requests, key):
    return sum(record["work"]["{}x{}".format(*r["camera"])][key] * r["images"] for r in requests)


def mfu(record):
    """Percent of the bf16 peak: the reference's counted FLOPs of every image
    completed in the window, over the window's seconds."""
    if not record.get("peaks") or not record.get("work") or not record["requests"]:
        return None
    return 100.0 * _work(record, record["requests"], "flops") / record["window_s"] / record["peaks"]["bf16_flops"]


def roofline(record, kernels: tuple, flops_key: str, bytes_key: str):
    """Percent of the roofline the device operations whose names hold one of
    ``kernels`` reach in the traced span: the larger of the span's counted
    FLOPs over the bf16 peak and bytes over the HBM bandwidth, over their
    device time."""
    trace, peaks = record.get("trace"), record.get("peaks")
    if not trace or not peaks or not record.get("work"):
        return None
    seconds = sum(s for name, s in trace["device_ops"].items() if any(k in name for k in kernels))
    flops = _work(record, trace["requests"], flops_key)
    nbytes = _work(record, trace["requests"], bytes_key)
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"]) / seconds


#: the names the attention kernels K1/K3 (csrc/attention_wgmma.cu,
#: csrc/attention.cu) and the LN -> Linear -> GELU kernel K2
#: (csrc/ln_dense_wgmma.cu: a row-statistics launch and a GEMM launch;
#: csrc/ln_dense.cu) run under in a device trace
ATTENTION_KERNELS = ("attn_fwd_wgmma", "attn_fwd_bf16", "attn_fwd_simt")
LN_DENSE_KERNELS = ("ln_row_stats", "ln_dense_wgmma", "ln_dense_bf16", "ln_dense_simt")
