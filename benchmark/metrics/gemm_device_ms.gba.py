"""Device ms per LM iteration in every cuBLAS matrix product of the step
(GEMM and SYRK kernels, ``metrics_common.GEMM``); on the loop-closure path
the dense U gram's lead them."""

from benchmark import metrics_common as mc


def read(record):
    return mc.ms_per_iteration(record, mc.GEMM)
