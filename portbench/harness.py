"""The benchmark's engine: finds a cell's files by name, runs its set-up,
its window (tracing off) or its traced window, checks the outputs against
the plain reference, and builds the result line.

Everything that belongs to one configuration, cell, traffic kind or
metric is a file of its own, found by name under the harness directories
(`Bench.dirs`, the first that holds it wins):

    configs/<config>.json     the configuration (its recipe, sizes, camera)
    recipes/<recipe>.py       make(config, rng) -> the scene's numpy arrays
    workloads/<cell>.json     the cell's traffic kind, parameters and limits
    traffic/<kind>.py         prepare(bench, cell, seed, device) -> a job
    metrics/<metric>.py       read(run) -> a number, or None when the run has
                              nothing to read

The manifest (BENCHMARK.json) says which cells exist, on which
configuration and how many chips, and which metrics each reports.
"""

from __future__ import annotations

import ast
import bisect
import dataclasses
import importlib.util
import json
import math
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracingproject_tpu")
PROGRAM = "raytracingproject_tpu_torch"
WINDOW = "portbench.window"
UNIT = "portbench.unit"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    kind: str
    params: dict
    limits: dict
    chips: int
    cores: list | None = None  # each rank's cores, rank 0's first (run.py pins rank 0)


class Bench:
    """The manifest and the directories the cell files are found in."""

    def __init__(self, manifest: dict, dirs=(HERE,)):
        self.manifest = manifest
        self.dirs = [Path(d) for d in dirs]

    @classmethod
    def at(cls, root: Path) -> "Bench":
        return cls(json.loads((Path(root) / "BENCHMARK.json").read_text()))

    def path(self, sub: str, name: str, suffix: str) -> Path:
        for d in self.dirs:
            p = d / sub / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {sub}/{name}{suffix} under {', '.join(map(str, self.dirs))}")

    def data(self, sub: str, name: str) -> dict:
        return json.loads(self.path(sub, name, ".json").read_text())

    def module(self, sub: str, name: str):
        path = self.path(sub, name, ".py")
        key = f"portbench_{sub}_{name}".replace(".", "_")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.manifest["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in the manifest")
        spec = self.data("workloads", name)
        return Cell(name, self.data("configs", entry["config"]), spec["kind"], spec["params"],
                    spec["limits"], int(entry["chips"]))

    def metrics(self, cell: str, section: str) -> list[dict]:
        """The manifest's `section` metrics that cell `cell` reports."""
        return [m for m in self.manifest[section] if cell in m.get("workloads", [cell])]

    def scene_arrays(self, config: dict, seed: int) -> dict:
        """The scene of `config`, drawn from `seed` by its recipe."""
        return self.module("recipes", config["recipe"]).make(config, rng(seed, 0))


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of `seed` (any whole number) and a stream."""
    return np.random.default_rng([seed % 2**64, *stream])


def torch_seed(seed: int, *stream: int) -> int:
    """A 63-bit torch seed from `seed` and a stream."""
    return int(rng(seed, *stream).integers(0, 2**63 - 1))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def imports_of(root: Path, bad, pattern: str = "*.py") -> list[str]:
    """Imports of modules whose top-level name is in `bad`, in the sources
    under `root` that match `pattern`, its tests/ aside (a scan of their
    import statements)."""
    found = set()
    for src in sorted(Path(root).glob(pattern)):
        if src.relative_to(root).parts[0] == "tests":  # no run loads them
            continue
        for node in ast.walk(ast.parse(src.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names = [node.module]
            found |= {f"{src.relative_to(root)}: {n}" for n in names if n.split(".")[0] in bad}
    return sorted(found)


def reference_imports(root: Path = HERE / "reference") -> list[str]:
    """Modules of the program or of JAX that the reference's sources
    import."""
    return imports_of(root, set(FORBIDDEN) | {PROGRAM})


class Refused(RuntimeError):
    """A run that must print no result."""


def guard(dirs=(HERE,)) -> None:
    """Refuse the run if JAX or the JAX package is loaded, if a source of
    the harness directories `dirs` (cells, traffic, metrics, recipes, all)
    imports either, or if the reference imports the program."""
    bad = forbidden_modules()
    if bad:
        raise Refused(f"forbidden modules loaded: {', '.join(bad)}")
    bad = [f"{d}/{b}" for d in dirs for b in imports_of(d, FORBIDDEN, "**/*.py")]
    if bad:
        raise Refused(f"the benchmark's sources import JAX: {', '.join(bad)}")
    bad = [f"{d}/{b}" for d in dirs for b in reference_imports(Path(d) / "reference")]
    if bad:
        raise Refused(f"the reference imports the program or JAX: {', '.join(bad)}")


@dataclasses.dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    setup_s: float
    latencies: list = dataclasses.field(default_factory=list)
    window_s: float | None = None
    trace: "Trace | None" = None
    spans: dict = dataclasses.field(default_factory=dict)
    rank_spans: list = dataclasses.field(default_factory=list)  # each rank's, in a multi-card cell
    memory_peak_bytes: int = 0  # the fullest card's, read after the window (0 on the CPU)


@dataclasses.dataclass
class Trace:
    """A profiled window: device intervals and host events in the
    profiler's microseconds, the window, and the units run in it."""

    device: list        # (name, start, end)
    host: list          # (name, start, end, innermost function of the program on its stack)
    start: float
    end: float
    units: int

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device intervals inside the window."""
        spans = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device
                       if e > self.start and s < self.end)
        merged: list[list[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def device_s(self, contains: str) -> float:
        """Device seconds of the operations whose name holds `contains`."""
        return sum(min(e, self.end) - max(s, self.start) for n, s, e in self.device
                   if contains in n and e > self.start and s < self.end) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.start
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.end > t:
            out.append((t, self.end))
        return out


def read_profile(prof) -> Trace:
    """The Trace of a torch.profiler run whose window is the `WINDOW`
    annotation."""
    import torch

    device, host = [], []
    for ev in prof.events():
        rng_ = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            where = next((f for f in (ev.stack or []) if PROGRAM + "/" in f), "")
            host.append((*rng_, where))
        elif not ev.name.startswith("portbench."):  # the annotations' device-side copies
            device.append(rng_)
    win = [(s, e) for n, s, e, _ in host if n == WINDOW]
    if not win:
        raise RuntimeError("the profile holds no window annotation")
    units = sum(1 for n, _, _, _ in host if n == UNIT)
    return Trace(device, host, win[0][0], win[0][1], units)


# host events that say what the host did, in the names the breakdown prints
ANNOTATIONS = {UNIT: "host, in no traced function", WINDOW: "host, between units"}
HOST_LABELS = {
    "aten::_local_scalar_dense": "host read of a device scalar (seed read-back, item)",
    "aten::item": "host read of a device scalar (seed read-back, item)",
    "aten::nonzero": "nonzero (host read of its size)",
    "cudaStreamSynchronize": "host waits for the device",
    "cudaDeviceSynchronize": "host waits for the device",
    "cudaMemcpyAsync": "host-device copy",
}
PYFUNC = re.compile(r"(.*)\.py\(\d+\): (.+)")


def _label(name: str) -> str:
    """A host event's name as the breakdown prints it: a known wait, a
    Python function as module.function, else the event's own name."""
    if name in HOST_LABELS or name in ANNOTATIONS:
        return HOST_LABELS.get(name) or ANNOTATIONS[name]
    m = PYFUNC.fullmatch(name)
    if m:
        return f"{Path(m.group(1)).name}.{m.group(2)}"
    return name


def _host_activity(events, gs: float, ge: float) -> str:
    """What the host was doing in the gap [gs, ge]: of the host events that
    cover at least half of it (else the most of it), a known wait first,
    then the innermost function of the program (a Python function event,
    or the program's innermost frame on an operation's stack), then the
    innermost event."""
    cover = [(min(e, ge) - max(s, gs), e - s, n, w) for n, s, e, w in events]
    cover = [c for c in cover if c[0] > 0]
    if not cover:
        return "no host event"
    need = min(0.5 * (ge - gs), max(c[0] for c in cover))
    cover = sorted((c for c in cover if c[0] >= need), key=lambda c: c[1])
    for c in cover:
        if c[2] in HOST_LABELS:
            return _label(c[2])
    for c in cover:
        if PROGRAM + "/" in c[2] and PYFUNC.fullmatch(c[2]):
            return _label(c[2])
    # the first operation the host issued in the gap: where in the program it came from
    issued = sorted((s, w) for n, s, e, w in events if gs <= s < ge and w)
    if issued:
        return f"before {_label(issued[0][1])}"
    return _label(cover[0][2])


def _ranked(d: dict, top: int) -> list:
    return sorted(([k[:160], v] for k, v in d.items()), key=lambda x: -x[1])[:top]


def breakdown(ops: Trace, labelled: Trace, top: int = 10) -> dict:
    """The device operations of `ops` that took most time, and the idle
    time of `labelled` (a trace with operation stacks) summed by what the
    host was doing in each gap; at most `top` entries each."""
    by_op: dict[str, float] = {}
    for n, s, e in ops.device:
        if e > ops.start and s < ops.end:
            by_op[n] = by_op.get(n, 0.0) + (min(e, ops.end) - max(s, ops.start)) * 1e-6
    host = sorted(labelled.host, key=lambda x: x[1])
    starts = [h[1] for h in host]
    by_host: dict[str, float] = {}
    active: list = []
    i = 0
    for gs, ge in labelled.gaps():
        j = bisect.bisect_left(starts, ge)
        active.extend(host[i:j])
        i = max(i, j)
        active = [h for h in active if h[2] > gs]
        label = _host_activity(active, gs, ge)
        by_host[label] = by_host.get(label, 0.0) + (ge - gs) * 1e-6
    return {"device_ops": _ranked(by_op, top), "idle_gaps": _ranked(by_host, top)}


def _profiled(job, acts, units: int, seconds: float, with_stack: bool = False) -> Trace:
    """Run up to `units` units of `job` (or until `seconds` pass) under
    torch.profiler and read the trace."""
    import torch

    kw = {}
    if with_stack:
        # verbose keeps the Python stack on each operation (torch.profiler drops it otherwise)
        from torch._C._profiler import _ExperimentalConfig

        kw = dict(with_stack=True, experimental_config=_ExperimentalConfig(verbose=True))
    with torch.profiler.profile(activities=acts, **kw) as prof:
        with torch.profiler.record_function(WINDOW):
            t_start = time.perf_counter()
            for _ in range(units):
                with torch.profiler.record_function(UNIT):
                    job.unit()
                if time.perf_counter() - t_start >= seconds:
                    break
    return read_profile(prof)


def run_cell(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device: str,
             t0: float, log=print, cores=None) -> dict:
    """One run of cell `name`: set-up, the window, the output check; the
    result line as a dict. `t0` is the process's start on the host
    clock; `cores`, each rank's cores (run.py's plan), reach the traffic
    kind on the cell. A job over several ranks (portbench/ranks.py) may
    give each rank's peak of device bytes (`peaks()`) and spans
    (`rank_spans()`) once released."""
    import torch

    cell = dataclasses.replace(bench.cell(name), cores=cores)
    traffic = bench.module("traffic", cell.kind)
    job = traffic.prepare(bench, cell, seed, device)
    guard(bench.dirs)
    run = Run(setup_s=time.perf_counter() - t0)
    cuda = torch.device(device).type == "cuda"
    if not trace:
        t_start = time.perf_counter()
        while True:
            t = time.perf_counter()
            job.unit()
            run.latencies.append(time.perf_counter() - t)
            if time.perf_counter() - t_start >= seconds:
                break
        run.window_s = time.perf_counter() - t_start
    else:
        # the job's host-clock spans first, in a process the profiler has not touched yet
        run.spans = job.spans()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        run.trace = _profiled(job, acts, int(cell.params["trace_units"]), seconds)
        # one more unit with operation stacks, to label the idle gaps
        labelled = _profiled(job, acts, 1, seconds, with_stack=True)
    guard(bench.dirs)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = job.count
    job.release()
    if hasattr(job, "peaks"):  # the fullest card
        peak = max([peak, *job.peaks()])
    run.memory_peak_bytes = int(peak)
    if hasattr(job, "rank_spans"):
        run.rank_spans = job.rank_spans()
    checks = job.check()
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics(name, section):
        value = bench.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": sum(1 for v, lim in checks.values() if not v <= lim),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = breakdown(run.trace, labelled)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    # last: the metric readers and the check have run, and nothing after this loads a module
    guard(bench.dirs)
    for k, (v, lim) in checks.items():
        log(f"check {k} = {v!r} (limit {lim!r}): {'ok' if v <= lim else 'FAILED'}",
            file=sys.stderr)
    return out


# What the metric files read (metrics/<name>.py); each returns None when
# the run has nothing for it.

def per_unit_s(run: Run) -> float | None:
    """Seconds a unit: the window over the units completed in it."""
    return run.window_s / len(run.latencies) if run.latencies else None


def p90_s(run: Run) -> float | None:
    """The 90th percentile of the window's unit latencies."""
    return quantile(run.latencies, 0.9) if run.latencies else None


def span_ms(run: Run, span: str) -> float | None:
    """Median milliseconds of the traced run's host-clock spans `span`
    (the cell's job times them before the profiled window)."""
    calls = run.spans.get(span)
    return statistics.median(calls) * 1e3 if calls else None


def kernel_ms(run: Run) -> float | None:
    """Device milliseconds a unit of the megakernels (operations named
    trace_kernel) in the traced window."""
    tr = run.trace
    ms = tr.device_s("trace_kernel") * 1e3 if tr is not None and tr.units else 0.0
    return ms / tr.units if ms > 0 else None


def idle_share(run: Run) -> float | None:
    """The share of the traced window in which no operation ran on the
    device."""
    tr = run.trace
    return 1.0 - tr.busy_s() / tr.window_s if tr is not None and tr.device else None


def worst(values) -> float:
    """The largest of `values`, NaN if any is NaN (NaN fails every limit)."""
    return math.nan if any(math.isnan(v) for v in values) else max(values)


def quantile(values, q: float) -> float:
    """The q-quantile of `values` by linear interpolation (numpy's)."""
    return float(np.quantile(np.asarray(values, np.float64), q))

