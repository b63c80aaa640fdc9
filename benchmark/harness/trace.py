"""The `--trace 1` run's device trace: a torch.profiler trace of the
measured window, read back into device busy time, each kernel's time,
and the breakdown of the result line.

The interval arithmetic is a frozen copy of chip_smoke.py's
`device_busy` (:821): the union of the card's kernel, memcpy and memset
intervals. Here it is taken over the harness's "window" span rather
than over every event of the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the harness's own spans (record_function names) around its calls into
# the program; "window" covers the whole measured window
SPANS = ("window", "map_file", "feed", "write")


def span(name: str):
    """A span of the harness: a torch.profiler.record_function, which
    costs next to nothing while no profiler runs."""
    import torch

    return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(enabled: bool, out: dict):
    """Profile the block (CPU ops of every thread and the card's work)
    when `enabled`; afterwards `out["events"]` holds the trace's timed
    events. The trace file goes to a temporary directory under TMPDIR and
    is deleted once read."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    kwargs = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kwargs["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, **kwargs) as prof:
        yield
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = [e for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X" and "dur" in e]


def short_name(name: str, width: int = 120) -> str:
    """A device op's name without its return type, anonymous namespace
    and argument list, cut to `width` characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name[:width]


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


@dataclass
class DeviceTrace:
    """The card's work inside the window span, in seconds."""

    window_s: float
    busy_s: float
    kernel_s: Dict[str, float] = field(default_factory=dict)  # by kernel name
    op_s: Dict[str, float] = field(default_factory=dict)  # every device op by name
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_time(self, part: str) -> float:
        """Seconds of the kernels whose name holds `part`."""
        return sum(s for name, s in self.kernel_s.items() if part in name)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:top]
        ops = [(short_name(n), s) for n, s in ops]
        gaps = sorted(self.idle_gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in gaps]}


def read_trace(events: List[dict]) -> DeviceTrace:
    """Busy time, kernel times and idle gaps of the card within the
    harness's "window" span. Each idle gap is named by the harness spans
    open at its middle: "map_file", with ", write" while a `write`
    callback ran, or ", feeder blocked" while the feeder was writing into
    a full pipe (the host pipeline behind)."""
    windows = [e for e in events if e.get("name") == "window" and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError("the trace holds no 'window' span")
    w = max(windows, key=lambda e: float(e["dur"]))
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev = []
    kernel_s: Dict[str, float] = {}
    op_s: Dict[str, float] = {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(float(e["ts"]), t0), min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        dev.append((a, b))
        s = (b - a) / 1e6
        op_s[e["name"]] = op_s.get(e["name"], 0.0) + s
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + s
    busy = _merge(dev)
    busy_us = sum(b - a for a, b in busy)
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in SPANS[1:]]
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            open_ = {n for n, s0, s1 in spans if s0 <= mid <= s1}
            name = ("map_file, write" if "write" in open_ else
                    "map_file, feeder blocked" if "feed" in open_ else "map_file")
            gaps.append((name, (b - a) / 1e6))
    return DeviceTrace(window_s=(t1 - t0) / 1e6, busy_s=busy_us / 1e6, kernel_s=kernel_s,
                       op_s=op_s, idle_gaps=gaps)
