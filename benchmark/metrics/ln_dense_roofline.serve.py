"""Percent of the roofline that K2, LN -> Linear -> GELU, reaches in the
traced span: the reference's count, 2 M C F FLOPs a call with x, the
weight, the bias and the LN parameters read and the output written once in
bf16, over the device time of K2's launches."""

from benchmark.harness.readers import LN_DENSE_KERNELS, roofline


def read(record):
    return roofline(record, LN_DENSE_KERNELS, "ln_dense_flops", "ln_dense_bytes")
