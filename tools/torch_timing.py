"""Timing helpers for the PyTorch port on a CUDA card, shared by
``chip_smoke.py`` and the ``tools/torch_*_timing.py`` scripts.

Import it with ``tools/`` on ``sys.path`` (a script in ``tools/`` has it
there already).  It imports only torch and numpy, and torch only inside the
functions, so a module that imports it needs no card until it times.
"""

from __future__ import annotations

import time

import numpy as np

# ~50 ms of the card's clock (torch.cuda._sleep counts cycles)
BACKLOG_CYCLES = 100_000_000


def cuda_ms(fn, reps: int, warm: int = 3) -> float:
    """Events around ``reps`` back-to-back calls of ``fn``, ms per call.
    Where the card is faster than the host, this is the host's pace."""
    import torch

    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_events(fn, reps: int = 1):
    """The card's operations during ``reps`` calls of ``fn``, from a
    ``torch.profiler`` trace of device activity only (so the host runs at
    its usual pace): sorted (start us, end us, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                  if e.device_type == DeviceType.CUDA)


def device_busy(fn, reps: int):
    """Device busy ms per call of ``fn`` and the busy share of the span from
    the first device operation to the last, over ``reps`` calls.  (None,
    None) where the trace records no device time."""
    spans = [(s, e) for s, e, _ in device_events(fn, reps) if e > s]
    if not spans:
        return None, None
    busy, end = 0.0, spans[0][0]
    for s, e in spans:  # the union of the device intervals, in us
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3 / reps, busy / (end - spans[0][0])


def span_ms(fn, reps: int, prefix: str):
    """Per ``torch.profiler.record_function`` span whose name starts with
    ``prefix`` (the prefix dropped): the device ms of the operations launched
    inside it and its host ms (under the profiler), per call of ``fn``, from
    a trace of ``reps`` calls.  The autograd engine runs a backward's
    operations on a thread of its own, outside the caller's spans: their
    device ms are under ``"autograd_engine"`` (host ms 0)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        device_ms = (e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total) / 1e3 / reps
        if e.name.startswith(prefix):
            key, host_ms = e.name[len(prefix):], e.cpu_time_total / 1e3 / reps
        elif e.cpu_parent is None and e.name.startswith("autograd::engine::evaluate_function"):
            key, host_ms = "autograd_engine", 0.0
        else:
            continue
        dev, host = out.get(key, (0.0, 0.0))
        out[key] = (dev + device_ms, host + host_ms)
    return out


def kernel_device_ms(fn, reps: int, name_part: str):
    """Mean device duration (ms) of one launch of the kernels whose name
    holds ``name_part`` over ``reps`` calls of ``fn``, and the launches seen
    per call; (None, 0) where the trace records none."""
    spans = [e - s for s, e, name in device_events(fn, reps) if name_part in name]
    return (float(np.mean(spans)) / 1e3 if spans else None), len(spans) / reps


def stage_kernels(fn, reps: int = 5):
    """Names of the kernels that ``reps`` calls of ``fn`` run on the card,
    each call between two marker kernels (torch.cuda._sleep), the markers
    known by the name a trace of markers alone gives them.  The profiler may
    drop an event, so this shows which kernels run, not how many: the launch
    counts do that."""
    import torch

    markers = {name for _, _, name in device_events(lambda: torch.cuda._sleep(1000), 3)}

    def marked():
        torch.cuda._sleep(1000)
        fn()
        torch.cuda._sleep(1000)

    return [name for _, _, name in device_events(marked, reps) if name not in markers]


def queued_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` with no host gaps: events around
    ``reps`` calls queued behind a ~50 ms backlog (torch.cuda._sleep)."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(BACKLOG_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dispatch_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn`` (its dispatch: the calls read nothing
    back), behind a ~50 ms backlog so that the card never waits on them."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(BACKLOG_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def tile_candidates(boxes, conf, cls_score, cls_idx, valid, b: int):
    """NMS candidates of a few images tiled to ``b`` images, in the layout
    they came in: where ``boxes`` is one of decode's strided views (rows of
    7 floats), boxes, conf and cls_score are views of one tiled (b, K, 7)
    tensor again; gathered tensors stay gathered."""
    import torch

    idx = torch.arange(b, device=valid.device) % valid.shape[0]
    if boxes.stride(1) != 4:
        rows = torch.cat([boxes, conf[..., None], cls_score[..., None],
                          cls_idx.to(torch.float32)[..., None]], -1)[idx]
        head = (rows[..., 0:4], rows[..., 4], rows[..., 5])
    else:
        head = (boxes[idx], conf[idx], cls_score[idx])
    return head + (cls_idx[idx], valid[idx])
