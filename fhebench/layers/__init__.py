"""Per-layer metrics: one reader a file, found by the metric's name.  Each
module's read(trace) takes a fhebench.trace.Trace and returns the number,
or None where the traced stretch holds nothing for it to read."""
