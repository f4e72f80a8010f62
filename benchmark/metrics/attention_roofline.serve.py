"""Percent of the roofline that the attention kernels K1 and K3 reach in the
traced span: the reference's count, 4 B H Nq Nk D FLOPs a
call with each input read and each output written once in bf16, over the
device time of their launches."""

from benchmark.harness.readers import ATTENTION_KERNELS, roofline


def read(record):
    return roofline(record, ATTENTION_KERNELS, "attention_flops", "attention_bytes")
