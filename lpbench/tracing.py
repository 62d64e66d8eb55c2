"""The traced run's record: torch.profiler over the measured window.

The window is the span `lpbench.window`; the entry marks what the host does
inside a request with spans named `lpbench.<phase>` (the constructor, the
solve). From the trace come the device operations by name (launches and
device seconds), the seconds in which some operation ran on the device (the
union of their intervals inside the window), and the idle gaps, each
labelled with the host's span and the host operation under it at the gap's
start.
"""
from __future__ import annotations

import bisect
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "lpbench.window"
GAPS = 10           # entries of each list of the breakdown
SHORT_NS = 20_000   # gaps shorter than this are counted together, unlabelled


class Tracer:
    """A context manager that profiles the window; summary() reads it."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.span = record_function(WINDOW)

    def __enter__(self):
        self.prof.__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def events(self):
        """(host events, device events), each a list of (name, start_ns,
        end_ns)."""
        host, device = [], []
        for e in self.prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(item)
            elif not (getattr(e, "is_user_annotation", bool)()
                      or e.name().startswith("lpbench.")):
                # the spans' copies on the device's timeline are no work
                device.append(item)
        return host, device

    def summary(self) -> dict:
        host, device = self.events()
        return summarize(host, device)


def kernel_name(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.sub(r"\(.*$", "", name).strip()


def summarize(host, device) -> dict:
    """The window's record from its host and device events (name, start_ns,
    end_ns): kernels by name [(name, launches, seconds)], busy_s, window_s,
    the top device operations and the longest idle gaps by host activity."""
    win = [(s, e) for name, s, e in host if name == WINDOW]
    w0, w1 = win[0] if win else (min(s for _, s, _ in host),
                                 max(e for _, _, e in host))
    inside = sorted((max(s, w0), min(e, w1), name) for name, s, e in device
                    if e > w0 and s < w1)
    kernels = {}
    for s, e, name in inside:
        n, t = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, t + (e - s) * 1e-9)
    # the union of the device intervals, and the gaps between them
    busy, gaps, cur_s, cur_e = 0, [], None, w0
    for s, e, _ in inside:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, w1))
    labels = host_labels(host, w0, w1)
    by_label = {}
    for g0, g1 in gaps:
        if g1 > g0:
            label = (labels(g0) if g1 - g0 >= SHORT_NS else
                     f"gaps under {SHORT_NS // 1000} us between device ops")
            by_label[label] = by_label.get(label, 0.0) + (g1 - g0) * 1e-9
    ops = {}
    for name, (n, t) in kernels.items():
        short = kernel_name(name)
        ops[short] = ops.get(short, 0.0) + t
    return dict(
        kernels=[(name, n, t) for name, (n, t) in sorted(kernels.items())],
        busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
        device_ops=sorted(([k, v] for k, v in ops.items()),
                          key=lambda x: -x[1])[:GAPS],
        idle_gaps=sorted(([k, v] for k, v in by_label.items()),
                         key=lambda x: -x[1])[:GAPS])


def host_labels(host, w0, w1):
    """A function from a time to what the host was doing then: the
    innermost `lpbench.` span and the shortest other host event that covers
    it ("python" where none does)."""
    spans = sorted((s, e, n) for n, s, e in host
                   if n.startswith("lpbench.") and n != WINDOW)
    ops = sorted((s, e, n) for n, s, e in host
                 if not n.startswith("lpbench.") and e > w0 and s < w1)
    starts = [s for s, _, _ in ops]

    def label(t):
        span = min(((e - s, n) for s, e, n in spans if s <= t < e),
                   default=(0, "lpbench.other"))[1]
        # the host events that start before t, looked at from the latest
        i = bisect.bisect_right(starts, t)
        best = None
        for s, e, n in reversed(ops[max(0, i - 64):i]):
            if e > t and (best is None or e - s < best[0]):
                best = (e - s, n)
        return f"{span.removeprefix('lpbench.')}: " + (
            best[1] if best else "python")
    return label
