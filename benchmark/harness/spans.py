"""The program's spans (``sanafe_tpu_torch/tracing.py``) of the traced
window: those that started between the first traced call's start and the
last one's end, on the clock both read (``time.perf_counter``). A program
that keeps no spans (one older than them) gives none."""


def named(run: dict, name: str):
    """The window's spans called ``name``; None where the program keeps no
    spans, kept none in the window, dropped some that may have started in
    it, or kept none of that name."""
    try:
        from sanafe_tpu_torch import tracing
    except ImportError:
        return None
    calls = run["calls"]
    since, until = int(calls[0].begin * 1e9), int(calls[-1].end * 1e9)
    if tracing.dropped(since):
        return None
    found = [s for s in tracing.spans(since, until) if s.name == name]
    return found or None


def total_ms(spans: list) -> float:
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans)
