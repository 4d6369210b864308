"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

BENCHMARK.json names the cells; a cell's configuration is
configs/<config>.json, its traffic traffic/<cell>.json, whose "kind"
names the driver drivers/<kind>.py; a per-layer metric is
metrics/<metric>.json, whose "reader" names readers/<reader>.py. Adding a
cell, a configuration, a traffic kind or a metric adds files and edits
none.

A driver module has `make(config, traffic, seed, device) -> cell` and the
cell has:
  setup()                      build, warm up, take the first steps; may set
                               reference_s, the seconds of it that the
                               reference spent making inputs (not setup_s's)
  window(seconds, units, spans) run the loop; returns {"units", "seconds",
                               "failed"} and whatever end_to_end reads
  end_to_end(raw)              {metric: value} of the cell's end-to-end metrics
  release()                    free the program's state
  check()                      [(name, value, limit)]: correct when each
                               value <= its limit
  work()                       {kernel: (bytes, operations)} for rooflines
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "rtwc_tpu")
SPAN_PREFIX = "portbench."


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(root, "BENCHMARK.json")


def cell_spec(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def cell_files(name: str, here: str = HERE) -> tuple[dict, dict]:
    """(configuration, traffic) of a cell, read from their files."""
    traffic = load_json(here, "traffic", f"{name}.json")
    return load_json(here, "configs", f"{traffic['config']}.json"), traffic


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (compared whole: rtwc_tpu_torch is not rtwc_tpu)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    """A module of JAX or of the JAX package was loaded."""


def assert_no_forbidden(when: str) -> None:
    loaded = forbidden_modules()
    if loaded:
        raise ForbiddenModules(f"modules of JAX or the JAX package loaded {when}: {loaded}")


class Spans:
    """Host spans of the harness's calls into the port, as
    torch.profiler.record_function ranges (on only in a traced run)."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(SPAN_PREFIX + name)


def device_info(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def kineto_trace(prof) -> dict:
    """The profiler's events as {"device": [(name, kind, start_ns, dur_ns)],
    "spans": [(name, start_ns, end_ns)]}: device kernels, copies and fills,
    and the harness's spans without their prefix."""
    device, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        annotation = getattr(e, "is_user_annotation", lambda: "#" in name)()
        if "CUDA" in str(e.device_type()):
            if annotation or name.startswith(SPAN_PREFIX):   # a span's marker on the device
                continue
            kind = ("gpu_memcpy" if name.startswith("Memcpy") else
                    "gpu_memset" if name.startswith("Memset") else "kernel")
            device.append((name, kind, e.start_ns(), e.duration_ns()))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name[len(SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns()))
    return {"device": device, "spans": spans}


def read_per_layer(bench: dict, cell: str, trace: dict, ctx: dict, here: str = HERE) -> dict:
    out = {}
    for m in per_layer_for(bench, cell):
        spec = load_json(here, "metrics", f"{m['name']}.json")
        reader = importlib.import_module(f"portbench.readers.{spec['reader']}")
        value = reader.read(trace, ctx, spec.get("params", {}))
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def merged(base: dict, overrides: dict | None) -> dict:
    """base with the keys of overrides replaced, a dict value merged one level deep."""
    if not overrides:
        return base
    return {**base, **{k: ({**base[k], **v} if isinstance(v, dict) else v)
                       for k, v in overrides.items()}}


def run(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_start: float | None = None, root: str = ROOT, here: str = HERE,
        overrides: dict | None = None, guard: bool = False) -> dict:
    """One run; returns {"result": the result line's object, "compared":
    [(name, value, limit)], "setup_split": seconds by part}. overrides:
    configuration keys replaced (tests shrink a cell on the CPU with
    them). guard: raise ForbiddenModules
    where set-up loaded a module of JAX or of the JAX package (a test
    process has JAX loaded by its own conftest)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark(root)
    cell_spec(bench, cell)
    config, traffic = cell_files(cell, here)
    config = merged(config, overrides)
    mod = driver(traffic["kind"])
    t_made = time.perf_counter()
    c = mod.make(config, traffic, seed, device)
    c.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start - getattr(c, "reference_s", 0.0)
    if guard:
        assert_no_forbidden("by set-up")
    split = {"imports_s": t_made - t_start, **getattr(c, "setup_split", {})}
    spans = Spans(trace)
    metrics, extra = {}, {}
    if not trace:
        raw = c.window(seconds=seconds, spans=spans)
        e2e = c.end_to_end(raw)
        metrics = {m["name"]: {"value": e2e[m["name"]] if m["name"] != "setup_s" else setup_s,
                               "unit": m["unit"]} for m in end_to_end_for(bench, cell)}
    else:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if torch.device(device).type == "cuda" else [])
        with profile(activities=acts) as prof:
            with spans("window"):
                raw = c.window(seconds=seconds, units=traffic["trace_units"], spans=spans)
        tr = kineto_trace(prof)
        del prof
    info = device_info(device)
    c.release()
    compared = c.check()
    if trace:
        ctx = {"units": raw["units"], "work": c.work(), "raw": raw}
        metrics = read_per_layer(bench, cell, tr, ctx, here)
        from portbench.readers import timeline

        busy, window = timeline.busy_and_window(tr)
        info["busy_s"], info["window_s"] = busy, window
        extra["breakdown"] = timeline.breakdown(tr)
    correct = all(v <= lim for _, v, lim in compared)
    result = {"correct": correct, "attempted": raw["units"], "failed": raw["failed"],
              "metrics": metrics, "device": info, **extra,
              "compared": {n: {"value": v, "limit": lim} for n, v, lim in compared}}
    return {"result": result, "compared": compared, "setup_split": split}
