"""Device ms per LM iteration in the Cholesky factorizations and triangular
solves of the step (cuSOLVER's and cuBLAS's ``potrf``, ``trsm``, ``trsv``
kernels, ``metrics_common.CHOL_TRSM``): the band solve's and S's Cholesky,
not the band solve's Woodbury products."""

from benchmark import metrics_common as mc


def read(record):
    return mc.ms_per_iteration(record, mc.CHOL_TRSM)
