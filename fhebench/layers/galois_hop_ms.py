"""Device ms of one Galois key switch, the mean over the traced stretch's
"ks.galois" spans (GaloisKeys.apply): a hop's cost, free of how many hops
the drawn rotations took."""

from fhebench.program import named


def read(trace):
    recs = named("ks.galois")
    return sum(r.device_ms for r in recs) / len(recs) if recs else None
