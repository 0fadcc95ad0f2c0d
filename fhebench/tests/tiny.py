"""The tiny parameter set of the CPU tests (the program's "tiny" preset:
n 8, p 15, three 30-bit limbs, Delta 2^12) with limits for its size: at
Delta 2^12 a fresh noise of a few units is 1e-3 of a message, so the
precision contracts of the ref configuration do not apply."""

TINY = {
    "name": "tiny", "n": 8, "p": 15,
    "moduli": [1073742721, 1073745121, 1073753281],
    "delta_bits": 12, "sigma": 3.2,
    "p_moduli": [268434721, 268433761, 268429921, 268428961],
    "precision": {"roundtrip_max_abs_err": 0.2, "matmul_max_abs_err": 0.5,
                  "relin_noise": 1 << 20},
}


def traffic(kind: str, **over) -> dict:
    base = {"kind": kind, "pool": 4, "warmup": 1, "sample": 2,
            "trace_requests": 2, "message_bits": 20, "message_range": 1.0,
            "limits": {"enc_gap": 64.0, "dec_gap": 1e-9, "gemm_gap": 1e-9}}
    base.update(over)
    return base
