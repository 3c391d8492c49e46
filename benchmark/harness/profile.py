"""Reading a ``torch.profiler`` trace of the traced window: the union of
the device's busy spans, each device op's time and count, and the longest
idle gaps named by what the host was doing (the innermost host op that
covers the gap's start)."""

from torch.autograd import DeviceType


def read(prof) -> dict:
    device, host = [], []
    for evt in prof.events():
        span = (evt.time_range.start, evt.time_range.end, evt.name)
        if evt.device_type == DeviceType.CUDA:
            # the profiler's own step ranges are annotations, not work
            if evt.name.startswith("ProfilerStep") or getattr(
                    evt, "is_user_annotation", False):
                continue
            device.append(span)
        elif evt.device_type == DeviceType.CPU:
            host.append(span)
    device.sort()
    host.sort()
    busy, gaps, end = 0.0, [], None
    ops = {}
    for s, e, name in device:
        us, count = ops.get(name, (0.0, 0))
        ops[name] = (us + (e - s), count + 1)
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    gaps.sort(reverse=True)
    named_gaps = []
    for length, at in gaps[:10]:
        inner = None
        for s, e, name in host:
            if s > at:
                break
            if e >= at and (inner is None or s >= inner[0]):
                inner = (s, name)
        named_gaps.append([inner[1] if inner else "(no host op)",
                           length * 1e-6])
    top = sorted(ops.items(), key=lambda item: -item[1][0])
    return {
        "busy_s": busy * 1e-6,
        "ops": {name: (us * 1e-6, count) for name, (us, count) in ops.items()},
        "breakdown": {
            "device_ops": [[name[:120], us * 1e-6] for name, (us, _) in
                           top[:10]],
            "idle_gaps": named_gaps,
        },
    }
