"""Mean ms a traced request spends in the Encoder's decode_from_wntt_eval (the
benchmark's "decode" span: CUDA events around the call)."""


def read(trace):
    return trace.span_mean_ms("decode")
