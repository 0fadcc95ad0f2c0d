"""Mean ms a traced request spends in the Encoder's encode_to_wntt_eval (the
benchmark's "encode" span: CUDA events around the call)."""


def read(trace):
    return trace.span_mean_ms("encode")
