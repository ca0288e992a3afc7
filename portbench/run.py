"""The benchmark of ``tensorbnn_tpu_torch`` on NVIDIA cards.

Run from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It makes the cell's inputs from the seed, warms up every shape the cell
uses (set-up), drives the program for ``--seconds`` (the window), then
checks what the window produced against the plain reference
(``check.py``) and prints one JSON line last on standard output: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics from a profiled sub-window run after the window. The
numbers compared, each beside its limit, are the last lines on standard
error and the result's last key.

``--control 1`` reads the control as well (``check.py``): the bfloat16
reference in the program's place, judged by the same numbers, under the
result's key ``control``. It exits with another code than 0, and prints
no result, without the cards the cell asks for, or where JAX or the JAX
package was loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every cache the program or torch builds stays at a fixed path inside the
# checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
for _p in (HERE, ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: top-level module names the program must not have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "tensorbnn_tpu")


class Run:
    """One run's arguments, specification and records."""

    def __init__(self, workload, seed, seconds, trace, devices=None,
                 root=ROOT):
        import spec
        self.root, self.here = root, os.path.join(root, "portbench")
        self.workload, self.seed = workload, int(seed)
        self.seconds, self.trace = float(seconds), bool(int(trace))
        self.bench = spec.benchmark(root)
        self.cell = spec.cell(self.bench, workload)
        self.config = spec.config_of(self.bench, self.cell, root)
        self.traffic = spec.traffic_of(self.cell, self.here)
        self.loop = spec.loop(self.traffic["loop"], self.here)
        self.devices = devices
        self.record = {"config": self.config, "traffic": self.traffic,
                       "cell": self.cell, "phases": {}}

    def mark(self, phase: str) -> None:
        """Seconds from the process's start to the end of ``phase`` of the
        set-up, for the record on standard error."""
        self.record["phases"][phase] = time.perf_counter() - T_START


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cards(n):
    """The first ``n`` cards; raises without them."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch sees no CUDA card; the benchmark "
                         "measures the program on NVIDIA cards only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"portbench: the cell needs {n} cards, torch sees "
                         f"{torch.cuda.device_count()}")
    return [torch.device("cuda", i) for i in range(n)]


def device_info(run) -> dict:
    import torch
    devs = run.devices
    out = {"platform": "gpu" if devs[0].type == "cuda" else devs[0].type,
           "kind": (torch.cuda.get_device_name(devs[0])
                    if devs[0].type == "cuda" else "cpu"),
           "count": len(devs),
           "memory_peak_bytes": run.record.get("memory_peak_bytes", 0)}
    if run.trace:
        out["busy_s"] = run.record["busy_s"]
        out["window_s"] = run.record["profile_s"]
    return out


def compared(readings: dict, limits: dict):
    """``(correct, [[name, value, limit], ...])``: every number at or
    under its limit."""
    rows = [[k, float(readings[k]), float(limits[k])] for k in limits]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows


def execute(run, control=False) -> dict:
    """Set-up, window, (trace), check; returns the result object."""
    import torch
    import spec
    state = run.loop.setup(run)
    run.record["setup_s"] = time.perf_counter() - T_START
    run.loop.window(run, state)
    peaks = [torch.cuda.max_memory_allocated(d) for d in run.devices
             if d.type == "cuda"]
    run.record["memory_peak_bytes"] = int(max(peaks)) if peaks else 0
    found = forbidden_modules()
    if found:
        print(f"portbench: the window closed with {', '.join(found)} "
              f"loaded", file=sys.stderr)
        raise SystemExit(3)
    if run.trace:
        run.loop.traced(run, state)
    t = time.perf_counter()
    readings = run.loop.check(run, state)
    run.record["check_s"] = time.perf_counter() - t
    low = run.loop.check(run, state, control=True) if control else None
    if forbidden_modules():
        raise SystemExit(3)
    limits = run.traffic["check"]["limits"]
    ok, rows = compared(readings, limits)
    metrics = {}
    for m in spec.metrics_for(run.bench, run.workload, run.trace):
        value = spec.reader(m["name"], run.here)(run.record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(ok), "attempted": run.record["attempted"],
           "failed": run.record.get("failed", 0), "metrics": metrics,
           "device": device_info(run)}
    if run.trace:
        out["breakdown"] = run.record["breakdown"]
    if control:
        out["control"] = low
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run = Run(args.workload, args.seed, args.seconds, args.trace)
    run.mark("imports")
    run.devices = cards(int(run.cell["chips"]))
    run.mark("cards")
    out = execute(run, control=bool(args.control))
    if args.control:
        print(json.dumps({k: run.record.get(k) for k in (
            "check_counts", "check_counts_control", "setup_s", "window_s",
            "check_s")}), file=sys.stderr)
    print(json.dumps({"setup_phases_s": run.record["phases"]}),
          file=sys.stderr)
    for name, row in out["compared"].items():
        print(f"compared {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
