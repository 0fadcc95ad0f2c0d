"""Mean ms a traced request spends in HEMatmul.matmul, the trace GEMM's tensor (the
benchmark's "gemm" span: CUDA events around the call)."""


def read(trace):
    return trace.span_mean_ms("gemm")
