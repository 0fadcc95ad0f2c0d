"""Run one cell of the benchmark once and print its result line.

    python -m fhebench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is looked up in BENCHMARK.json; its
configuration is fhebench/configs/<config>.json, its traffic mix
fhebench/traffic/<traffic>.json, whose "kind" names the request code in
fhebench/kinds/<kind>.py, and each per-layer metric's reader is
fhebench/layers/<metric>.py.  A new cell needs new files and entries
only.

A run: set-up (the program's contexts and tables, keys and the pool from
the seed on the card, `warmup` requests of the cell's own shapes), then a
closed loop of one caller for --seconds, each request ending in a
synchronise, then the check of a sample of the window's requests
(reservoir-drawn from the seed) against the plain reference in
fhebench/reference, once the peak memory is read and the program's state
is freed.  The process runs as a caller's would: torch's default threads,
Python's collector on.  Set-up's phases (import, device, the kind's own,
warm-up) are printed on standard error and kept under "setup_phases".
--trace 1 profiles `trace_requests` requests after the first two of the
window, with the benchmark's spans on, and prints the per-layer metrics
instead of the end-to-end ones.

The run fails, and prints no result, without a CUDA card, and when JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "fhebench")
FORBIDDEN = ("jax", "jaxlib", "flax", "matrix_fhe_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell(workload: str, spec=None):
    """(spec, workload entry, configuration, traffic) by name."""
    spec = spec or load_json(ROOT, "BENCHMARK.json")
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"have {sorted(entries)}")
    w = entries[workload]
    cfg = load_json(HERE, "configs", w["config"] + ".json")
    traffic = load_json(HERE, "traffic", w["traffic"] + ".json")
    return spec, w, cfg, traffic


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of k payloads of a stream, drawn from `rng`."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec=None, cfg=None, traffic=None,
             t_start: float = T_START) -> dict:
    """One run of a cell; returns the result (the line's dict).  `cfg` and
    `traffic` replace the files' contents (tests at small sizes)."""
    import torch

    from . import kinds
    from .trace import Spans, StageRecorder, Trace, breakdown, read_profile

    spec, w, cfg_file, traffic_file = cell(workload, spec)
    cfg, traffic = cfg or cfg_file, traffic or traffic_file
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = importlib.import_module(f"fhebench.kinds.{traffic['kind']}")
    kinds.PHASES[:] = [("start", t_start)]
    kinds.mark("harness")
    torch.zeros(1, device=dev)
    kinds.sync(dev)
    kinds.mark("device")

    st = kind.setup(cfg, traffic, seed, dev)
    spans = Spans(dev)
    for i in range(traffic["warmup"]):
        kind.request(st, -1 - i, spans)
        kinds.sync(dev)
    kinds.mark("warmup")
    setup_s = time.perf_counter() - t_start
    phases = {b[0]: b[1] - a[1]
              for a, b in zip(kinds.PHASES, kinds.PHASES[1:])}

    sample = Reservoir(traffic["sample"], random.Random(seed))
    lat = []
    skip, n_traced = 2, traffic["trace_requests"]
    prof = recorder = None
    traced = {}
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while True:
        if trace and i == skip:
            kinds.sync(dev)
            recorder = StageRecorder().__enter__()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            spans.enabled = True
            traced["t0"] = time.perf_counter()
        spans.request = i
        r0 = time.perf_counter()
        payload = kind.request(st, i, spans)
        kinds.sync(dev)
        r1 = time.perf_counter()
        lat.append(r1 - r0)
        sample.offer(payload)
        del payload
        i += 1
        if trace and i == skip + n_traced:
            traced["t1"] = time.perf_counter()
            spans.enabled = False
            prof.__exit__(None, None, None)
            recorder.__exit__()
        if r1 >= end and (not trace or i >= skip + n_traced):
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    result = {"correct": False, "attempted": i, "failed": 0,
              "window": {"requests": i, "seconds": window_s,
                         "latency_ms_min": 1e3 * min(lat),
                         "latency_ms_p50": 1e3 * statistics.median(lat),
                         "latency_ms_max": 1e3 * max(lat)},
              "setup_phases": phases}
    metrics = {}
    if trace:
        device_ops, host_ranges = read_profile(prof)
        tr = Trace(spans.per_request_ms(), n_traced,
                   traced["t1"] - traced["t0"], device_ops, host_ranges,
                   recorder.calls)
        for m in spec["per_layer"]:
            if w["name"] not in m.get("workloads", [w["name"]]):
                continue
            reader = importlib.import_module(f"fhebench.layers.{m['name']}")
            v = reader.read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy_s, traced_s = tr.busy_s(), tr.window_s
        result["breakdown"] = breakdown(tr)
        del prof, tr, device_ops, host_ranges
    else:
        values = {
            "matrices_per_s": _phi(cfg["p"]) * i / window_s,
            "latency_ms_p50": 1e3 * statistics.median(lat),
            "latency_ms_p90": 1e3 * _p90(lat),
            "peak_device_gib": peak / 2 ** 30,
            "setup_s": setup_s,
        }
        for m in spec["end_to_end"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}

    kind.release(st)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = kind.check(st, sample.items, cfg, traffic)
    result["correct"] = all(c.ok for c in checks)
    result["metrics"] = metrics
    result["device"] = _device(dev, peak)
    if trace:
        result["device"].update(busy_s=busy_s, window_s=traced_s)
        result["breakdown"] = result.pop("breakdown")   # after "device"
    result["checks"] = {c.name: {"value": _finite(c.value),
                                 "limit": c.limit} for c in checks}
    return result


def _phi(p: int) -> int:
    from .reference.modq import w_exponents
    return len(w_exponents(p))


def _finite(v: float):
    return v if math.isfinite(v) else None


def _p90(values) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[8]


def _device(dev, peak: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": kind, "count": 1, "memory_peak_bytes": peak}


def main(argv=None, t_start: float = T_START) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _, w, _, _ = cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"fhebench: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"fhebench: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("setup phases: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in res["setup_phases"].items()),
        file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
