"""The profiler's trace reduced to what the per-layer metrics read: the
device's busy time over the traced window, kernels launched, device time
by kernel name and by launching operator, and the longest idle gaps by
what the host was doing.  The busy share follows
``tools/raster3d_profile.py``: device time of the CUDA activity ÷ the
window's wall time, here as the union of the activity intervals.
"""
from __future__ import annotations

import bisect
import time

import torch

NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def _device_us(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


def traced(fn, units: int, device) -> dict:
    """Run ``fn()`` ``units`` times under ``torch.profiler`` and reduce the
    trace (``reduce``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return reduce(prof.events(), window_s, units)


def reduce(events, window_s: float, units: int) -> dict:
    dev_type = torch.autograd.DeviceType.CUDA
    acts, cpu, op_dev = [], [], {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == dev_type:
            acts.append((s, t, e.name))
        else:
            cpu.append((s, t, e.name))
            us = _device_us(e)
            if us > 0:
                op_dev[e.name] = op_dev.get(e.name, 0.0) + us / 1e6
    acts.sort()
    busy, cur_s, cur_t = 0.0, None, None
    for s, t, _ in acts:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
    by_name = {}
    for s, t, n in acts:
        by_name[n] = by_name.get(n, 0.0) + (t - s) / 1e6
    kernels = [a for a in acts if not a[2].startswith(NOT_KERNELS)]
    return dict(units=units, window_s=window_s, busy_s=busy / 1e6,
                launches=len(kernels), by_name=by_name, op_device_s=op_dev,
                idle_gaps=idle_gaps(acts, cpu))


def idle_gaps(acts, cpu, top: int = 10) -> list:
    """Seconds of device idleness between consecutive activities, summed
    by the innermost host operator running at each gap's midpoint."""
    cpu = sorted(cpu)
    starts = [c[0] for c in cpu]
    by = {}
    end = None
    for s, t, _ in acts:
        if end is not None and s > end:
            mid = 0.5 * (s + end)
            label, i = "host: no operator", bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(i - 4000, -1), -1):
                if cpu[j][1] >= mid:
                    label = cpu[j][2]
                    break
            by[label] = by.get(label, 0.0) + (s - end) / 1e6
        end = t if end is None else max(end, t)
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def kernel_seconds(tr: dict, parts: tuple) -> float:
    """Device seconds of the activities whose names contain any of
    ``parts``."""
    return sum(s for n, s in tr["by_name"].items()
               if any(p in n for p in parts))


def breakdown(tr: dict) -> dict:
    ops = sorted(tr["by_name"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in tr["idle_gaps"]]}
