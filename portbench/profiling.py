"""The benchmark's profiler: a bounded sub-window under ``torch.profiler``
(the host's operations and the cards' kernels, copies and fills), read
into plain records that the per-layer readers take.

``Window`` starts and stops the profiler around the work it is given (the
cards synchronised at both ends) and keeps the host's clock over it. Its
``events()`` are ``(name, kind, device, start_s, end_s)`` with ``kind``
"device" for a card's kernel, copy or fill and "host" for an operation or
a span of the host; ``device`` is the card's index (-1 on the host).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

import yardstick

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


class Window:
    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in self.devices):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.t0 = self.t1 = None
        self.control_s = 0.0

    def _sync(self):
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def start(self):
        t = time.perf_counter()
        self._sync()
        self.prof.start()
        self.t0 = time.perf_counter()
        self.control_s += self.t0 - t

    def stop(self):
        t = time.perf_counter()
        self._sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.control_s += time.perf_counter() - t

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def events(self) -> List[tuple]:
        """The window's events as ``(name, kind, device, start_s, end_s)``,
        times in seconds from the trace's origin."""
        try:
            raw = self.prof.profiler.kineto_results.events()
            raw[0].activity_type
        except (AttributeError, IndexError):
            # torch builds whose events do not name their activity
            return self._events_from_json()
        out = []
        for e in raw:
            act = str(e.activity_type())
            dev_side = act in DEVICE_ACTIVITIES
            kind = "device" if dev_side else "host"
            if kind == "host" and act not in ("cpu_op", "user_annotation"):
                continue
            start = e.start_ns() * 1e-9
            out.append((e.name(), kind,
                        int(e.device_index()) if dev_side else -1, start,
                        start + e.duration_ns() * 1e-9))
        return out

    def _events_from_json(self) -> List[tuple]:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                raw = json.load(f)["traceEvents"]
        out = []
        for e in raw:
            if "dur" not in e:
                continue
            cat = e.get("cat", "")
            if cat in DEVICE_ACTIVITIES:
                dev = int(e.get("args", {}).get("device", e.get("pid", 0)))
                kind = "device"
            elif cat in ("cpu_op", "user_annotation"):
                dev, kind = -1, "host"
            else:
                continue
            start = float(e["ts"]) * 1e-6
            out.append((e["name"], kind, dev, start,
                        start + float(e["dur"]) * 1e-6))
        return out


def device_events(events, device: Optional[int] = None):
    return [e for e in events if e[1] == "device"
            and (device is None or e[2] == device)]


def busy_by_card(events) -> Dict[int, float]:
    """Seconds in which each card ran anything of ``events``."""
    cards = sorted({e[2] for e in device_events(events)})
    return {c: yardstick.busy_seconds((e[3], e[4])
                                      for e in device_events(events, c))
            for c in cards}


def kernel_seconds(events, pattern: str) -> Tuple[float, int]:
    """``(seconds, count)`` of the device events whose name matches the
    regular expression ``pattern``."""
    rx = re.compile(pattern)
    hits = [e for e in device_events(events) if rx.search(e[0])]
    return sum(e[4] - e[3] for e in hits), len(hits)


def breakdown(events, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps of the busiest card, each named by the shortest host
    operation or span that covers its middle."""
    by_name: Dict[str, float] = {}
    for e in device_events(events):
        by_name[e[0]] = by_name.get(e[0], 0.0) + (e[4] - e[3])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = busy_by_card(events)
    gaps = []
    if busy:
        card = max(busy, key=busy.get)
        spans = sorted((e[3], e[4]) for e in device_events(events, card))
        hi = spans[0][1]
        for s, e in spans[1:]:
            if s > hi:
                gaps.append((hi, s))
            hi = max(hi, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = [e for e in events if e[1] == "host"]
    named = []
    for lo, hi in gaps:
        mid = 0.5 * (lo + hi)
        cover = [e for e in host if e[3] <= mid <= e[4]]
        name = (min(cover, key=lambda e: e[4] - e[3])[0] if cover
                else "host: no operation recorded")
        named.append([name, hi - lo])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
