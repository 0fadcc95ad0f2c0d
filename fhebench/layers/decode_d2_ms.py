"""Mean ms a traced request spends in HEMatmul.decrypt_and_decode, the Delta^2 decrypt and decode (the
benchmark's "decode_d2" span: CUDA events around the call)."""


def read(trace):
    return trace.span_mean_ms("decode_d2")
