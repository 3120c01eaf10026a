"""One run of one benchmark cell of the PyTorch port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  The cell, its configuration
(``portbench/configs/<config>.json``), its traffic mix
(``portbench/traffic/<traffic>.json``, whose ``kind`` names the driver
``portbench/kinds/<kind>.py``) and the readers of its metrics
(``portbench/metrics/<metric>.py``) are found by the names in
``BENCHMARK.json``.  Set-up makes the inputs from the seed and warms up
the cell's own shapes; then the window runs steps for ``--seconds``
(``--trace 0``: the end-to-end metrics; whole passes over the inputs,
the first pass boundary at or after ``--seconds``) or a few steps under
the profiler (``--trace 1``: the per-layer metrics).  After the window the
program's state is dropped and the plain reference judges a sample of
what the window produced.  The last line of standard output is one
JSON object; the numbers compared, each with its limit, end standard
error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repic_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (``sys.modules`` unless given) whose top-level
    name is forbidden, compared whole: ``repic_tpu_torch`` is not
    ``repic_tpu``."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def load_manifest(root: str = ".") -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(manifest: dict, workload: str) -> dict:
    """The cell's entry, configuration, traffic and metrics, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    with open(configs[cell["config"]]["file"]) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return {
        "cell": cell, "config": config, "traffic": traffic,
        "end_to_end": [m for m in manifest["end_to_end"] if applies(m)],
        "per_layer": [m for m in manifest["per_layer"] if applies(m)],
    }


def load_reader(name: str):
    """``portbench/metrics/<name>.py``'s ``read(ctx)``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    mod_name = "portbench.metrics." + name.replace(".", "__")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, ctx: dict) -> dict:
    out = {}
    for m in metrics:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def kind_module(traffic: dict):
    return importlib.import_module("portbench.kinds." + traffic["kind"])


def run_window(cell, seconds: float, sync) -> dict:
    """Whole passes over the cell's inputs (``cell.cycle`` steps each)
    until ``seconds`` have passed: every run does the same work, and
    the rate is all of it over all of the window's time.  (Steps cost
    unlike amounts, so a window cut at a step would count a costly
    step in one run and not in the next.)"""
    units = steps = 0
    t0 = time.perf_counter()
    while True:
        units += cell.step()
        steps += 1
        sync()
        t = time.perf_counter() - t0
        if t >= seconds and steps % cell.cycle == 0:
            return {"units": units, "steps": steps, "seconds": t}


def run(spec: dict, workload: str, seed: int, seconds: float,
        trace_on: bool, device: str = "cuda", t_start: float = T_START):
    """Set-up, the window and the check of one cell on ``device``;
    returns ``(result, rows)`` (the result without its last key)."""
    import torch

    on_card = device != "cpu"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    chips = int(spec["cell"]["chips"])
    kind = kind_module(spec["traffic"])
    cell = kind.Cell(spec["config"], spec["traffic"], seed, device)
    with torch.profiler.record_function("portbench.set-up"):
        cell.setup()
    sync()
    setup_s = time.perf_counter() - t_start

    ctx = {"cell": workload, "config": spec["config"],
           "traffic": spec["traffic"], "kind": spec["traffic"]["kind"],
           "setup_s": setup_s, "window": None, "trace": None,
           "counters": {}}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": chips}
    breakdown = None
    if trace_on:
        from portbench import trace

        cell.tracing = True
        n = int(spec["traffic"]["trace_steps"])
        units, host_s, reading = trace.run_traced(cell.step, n, sync)
        ctx["trace"] = dict(reading, units=units, host_s=host_s, steps=n)
        ctx["counters"] = cell.counters()
        ctx["work"] = cell.work()
        metrics = read_metrics(spec["per_layer"], ctx)
        dev.update(busy_s=reading["busy_s"], window_s=reading["window_s"])
        breakdown = {"device_ops": reading["device_ops"],
                     "idle_gaps": reading["idle_gaps"]}
    else:
        ctx["window"] = run_window(cell, seconds, sync)
        metrics = read_metrics(spec["end_to_end"], ctx)
    dev["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                if on_card else 0)

    from portbench import compare

    cell.release()
    t_check = time.perf_counter()
    numbers = cell.numbers()
    correct, rows = compare.judge(numbers, compare.load_limits(workload))
    units = (ctx["window"] or ctx["trace"])["units"]
    result = {
        "correct": bool(correct),
        "attempted": int(units),
        "failed": 0 if correct else int(units),
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check_s"] = time.perf_counter() - t_check
    return result, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's capacity sidecar (under HOME) stays off: every run
    # starts from the same state
    os.environ["REPIC_TPU_NO_CONFIG_CACHE"] = "1"
    spec = resolve(load_manifest(), args.workload)
    chips = int(spec["cell"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repic_tpu_torch  # noqa: F401  (the system under test)

    result, rows = run(spec, args.workload, args.seed, args.seconds,
                       bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 4
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in rows}
    for name, v, lim in rows:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
