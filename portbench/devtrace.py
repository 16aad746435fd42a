"""The device side of a traced run, from ``torch.profiler`` (CUPTI):
every kernel, copy and set on the card between ``start`` and ``stop``.
The port launches its kernels through ctypes, not torch ops; CUPTI sees
them all the same."""

from __future__ import annotations

import subprocess
import time

from portbench.stats import union_length


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0
        #: (name, start_s, end_s) of every device activity
        self.events: list[tuple[str, float, float]] = []

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.events = device_events(self.prof)
        self.prof = None

    @property
    def busy_s(self) -> float:
        return union_length((a, b) for _, a, b in self.events)

    def seconds_by_name(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, a, b in self.events:
            out[name] = out.get(name, 0.0) + (b - a)
        return out


def device_events(prof) -> list[tuple[str, float, float]]:
    """(name, start_s, end_s) of the profile's device-side events."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        out.append((e.name, e.time_range.start / 1e6,
                    e.time_range.end / 1e6))
    return out


def power_limit_w() -> float | None:
    """The card's power limit, from nvidia-smi (None where it has none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
