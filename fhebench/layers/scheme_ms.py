"""Mean ms a traced request spends in the HE scheme: encrypt_pair with
fresh randomness plus decrypt_pair_to_eval (the benchmark's "encrypt" and
"decrypt" spans)."""


def read(trace):
    parts = [trace.span_mean_ms(s) for s in ("encrypt", "decrypt")]
    return None if None in parts else sum(parts)
