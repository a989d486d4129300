"""The benchmark's machinery, shared by every cell: finding a cell's files
by name, wrapping the program's entries in spans, reading a profiler
trace, and printing the result.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(`configs/<config>.json`) under a traffic mix (`traffic/<traffic>.json`,
whose `kind` names the module in `kinds/` that drives that kind of job).
A per-layer metric is `metrics/<name>.py`: its `SPANS` maps span names to
the program entries (`module:qualname`) to wrap in the traced run, and its
`read(rec)` returns the value or None when it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "caliscope_tpu")


def load_json(path):
    return json.loads(Path(path).read_text())


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic mix, kind
    module and metrics. `root` is the checkout (the folder of BENCHMARK.json)
    and `here` the benchmark's folder."""

    def __init__(self, name, root, here=HERE):
        bench = load_json(Path(root) / "BENCHMARK.json")
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json (has {sorted(by_name)})")
        self.name, self.entry = name, by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(Path(root) / configs[self.entry["config"]]["file"])
        self.traffic = load_json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.kind = importlib.import_module(f"portbench.kinds.{self.traffic['kind']}")
        self.here = here

        def applies(m):
            return name in m["workloads"] if "workloads" in m else True

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
        ]

    def metric_module(self, name):
        path = self.here / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def resolve(target):
    """(owner object, attribute name) of 'package.module:Qual.name'."""
    mod_name, qual = target.split(":")
    owner = importlib.import_module(mod_name)
    parts = qual.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Recorder:
    """Spans (name, thread id, start, end, argument shapes) kept in memory
    while `recording` is set, from wrappers around program entries."""

    def __init__(self):
        self.spans = []
        self.recording = False
        self._lock = threading.Lock()

    @contextmanager
    def wrapped(self, targets):
        """Wrap the program entry of each {span name: target}. A target is
        'module:qualname', or {"target": ..., "shapes": true} to keep the
        shapes of the call's tensor arguments and its int arguments, or
        {"target": ..., "keep": "attr.path"} to keep that attribute of the
        call's result."""
        saved = []
        try:
            for span, spec in targets.items():
                spec = spec if isinstance(spec, dict) else {"target": spec}
                owner, attr = resolve(spec["target"])
                original = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
                saved.append((owner, attr, original))
                setattr(owner, attr, self._wrapper(span, original, spec.get("shapes", False), spec.get("keep")))
            yield self
        finally:
            for owner, attr, original in reversed(saved):
                setattr(owner, attr, original)

    def _wrapper(self, span, original, shapes, keep):
        func = original.__func__ if isinstance(original, (classmethod, staticmethod)) else original

        def wrapper(*args, **kwargs):
            if not self.recording:
                return func(*args, **kwargs)
            t0 = time.perf_counter()
            out = None
            try:
                out = func(*args, **kwargs)
                return out
            finally:
                t1 = time.perf_counter()
                info = None
                if shapes:
                    info = [tuple(a.shape) if hasattr(a, "shape") else a for a in (*args, *kwargs.values())
                            if hasattr(a, "shape") or isinstance(a, int)]
                elif keep and out is not None:
                    info = out
                    for part in keep.split("."):
                        info = getattr(info, part, None)
                with self._lock:
                    self.spans.append((span, threading.get_ident(), t0, t1, info))

        if isinstance(original, classmethod):
            return classmethod(wrapper)
        if isinstance(original, staticmethod):
            return staticmethod(wrapper)
        return wrapper

    def of(self, name, outside=None):
        """Spans called `name`, less those overlapping the interval `outside`."""
        out = [s for s in self.spans if s[0] == name]
        if outside is not None:
            a, b = outside
            out = [s for s in out if s[3] <= a or s[2] >= b]
        return out


class Trace:
    """What a torch.profiler stretch says: device busy seconds (the union of
    kernel, copy and set intervals), the stretch's length, kernels by name
    (count, seconds), GPU kernels, and the longest idle gaps named by the
    innermost host operation or portbench span over their middle."""

    def __init__(self, prof, wall_s, t_start, spans):
        from torch.autograd import DeviceType

        events = list(prof.events())
        dev = [e for e in events if e.device_type == DeviceType.CUDA]
        host = [e for e in events if e.device_type == DeviceType.CPU]
        self.window_s = wall_s
        self.kernels = {}
        intervals = []
        for e in dev:
            a, b = e.time_range.start, e.time_range.end
            intervals.append((a, b))
            n, s = self.kernels.get(e.name, (0, 0.0))
            self.kernels[e.name] = (n + 1, s + (b - a) / 1e6)
        self.n_kernels = sum(n for name, (n, _s) in self.kernels.items() if not name.startswith(("Memcpy", "Memset")))
        intervals.sort()
        merged = []
        for a, b in intervals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e6
        # idle gaps between device activity inside the stretch (profiler us)
        gaps = [(merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
        gaps.sort(reverse=True)
        self.idle_gaps = []
        # the profiler's clock: its first host event against perf_counter at its start
        origin = min((e.time_range.start for e in host), default=0)
        for length, a, b in gaps[:10]:
            mid = (a + b) / 2
            over = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
            if over:
                name = min(over, key=lambda e: e.time_range.end - e.time_range.start).name
            else:
                t = t_start + (mid - origin) / 1e6
                cover = [s for s in spans if s[2] <= t <= s[3]]
                name = min(cover, key=lambda s: s[3] - s[2])[0] if cover else "host (no span)"
            self.idle_gaps.append([name, length / 1e6])

    def top_kernels(self, n=10):
        return [[name, s] for name, (_n, s) in sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:n]]



def sync(device):
    """Wait for `device` (a no-op on the CPU, where the tests drive a run)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def profiled(holder, device):
    """torch.profiler (host and device) over the body; sets
    holder['profile'] to (profiler, seconds, start). The events are read
    into a Trace only once the window has closed (`Trace(*profile, spans)`),
    so that reading them takes no time from the program's threads in it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sync(device)
        t0 = time.perf_counter()
        yield
        sync(device)
        wall = time.perf_counter() - t0
    holder["profile"] = (prof, wall, t0)


def forbidden_modules():
    """Top-level module names loaded that belong to JAX or the JAX package,
    compared whole (caliscope_tpu_torch is not caliscope_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def checks_lines(checks):
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}, {'ok' if c['ok'] else 'FAILED'})" for name, c in checks.items()]


def judged(numbers, limits):
    """{name: {value, limit, ok}}: each number at most its limit."""
    out = {}
    for name, value in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit, "ok": bool(value == value and value <= limit)}
    return out
