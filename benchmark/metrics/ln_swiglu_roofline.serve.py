"""Percent of the roofline that K2's gated body, LN -> w12 -> silu(a) * g,
reaches in the traced span: the reference's count (``reference/v2_swiglu.py``
``swiglu``), 2 M C F FLOPs a call with x, w12, its bias and the LN
parameters read and the (M, F / 2) result written once in bf16, over the
device time of its two launches, the row statistics (``ln_row_stats``) and
the GEMM (``ln_swiglu_wgmma``). None where no gated GEMM ran."""

from benchmark.harness.readers import roofline

GEMM = "ln_swiglu_wgmma"


def read(record):
    trace = record.get("trace")
    if not trace or not any(GEMM in name for name in trace["device_ops"]):
        return None
    return roofline(record, (GEMM, "ln_row_stats"), "ln_dense_flops", "ln_dense_bytes")
