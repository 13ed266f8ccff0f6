"""Timing helpers shared by the stage profiler and the primitive-op probes:
CUDA events on the card, the host clock on the CPU, and the card's name and
power limit for the lines that report a time."""

from __future__ import annotations

import subprocess
import time

import torch


def card_line(device: torch.device) -> str:
    """``name, power limit`` of the card as nvidia-smi prints them (the
    power limit decides the clocks under load); ``cpu`` for the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    if not lines:
        return f"{torch.cuda.get_device_name(device)}, power limit unknown"
    return lines[device.index or 0].strip()


class Span:
    """One timed span.  On a CUDA device: ``device_ms`` from CUDA events
    around the span, ``enqueue_ms`` the host clock until the span's last call
    returned, ``wall_ms`` the host clock until a final synchronize.  On the
    CPU all three are the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def __enter__(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.enqueue_ms = (time.perf_counter() - self.t0) * 1e3
        if self.cuda:
            self.e1.record()
            torch.cuda.synchronize(self.device)
        self.wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.device_ms = self.e0.elapsed_time(self.e1) if self.cuda else self.wall_ms
        return False


def bench(fn, device: torch.device, iters: int = 10) -> dict:
    """``fn()`` once to warm up, then ``iters`` times inside one span; ms per
    call (``device_ms``, and ``enqueue_ms`` for the host's share)."""
    fn()
    with Span(device) as span:
        for _ in range(iters):
            fn()
    return dict(device_ms=span.device_ms / iters, enqueue_ms=span.enqueue_ms / iters)
