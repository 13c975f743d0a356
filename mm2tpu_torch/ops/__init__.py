"""Device ops: hand-written Hopper kernels, their wrappers and their plain
PyTorch versions.

`count_lock` guards every module's `launches` and `reference_calls`
counters: the stream mode launches from several mapping threads. The
extension kernels set their dynamic shared-memory limit (a property of
the function, not of the launch) before each launch; `launching` holds
`launch_lock` over the set and the launch, so that a thread never
launches under the smaller limit another thread has just set.

Card time. Inside `card_spans()`, `launching` also records a CUDA event
just before and just after the launch, under the same lock: nothing of
another thread's lies between the two on the stream, so the spans of
all threads are disjoint on the card and their sum (`span_seconds`)
never exceeds the wall. A pair of events around a whole task (upload,
launch, readback) would also hold the other threads' work queued in
between, and the wait for the lock."""
import contextlib
import threading

count_lock = threading.Lock()
launch_lock = threading.Lock()
_spans = threading.local()


@contextlib.contextmanager
def card_spans(on: bool = True):
    """Collect the (start, end) CUDA events of the launches that the
    calling thread makes inside the block into the list it yields (None
    when `on` is false: nothing is recorded)."""
    if not on:
        yield None
        return
    spans = _spans.open = []
    try:
        yield spans
    finally:
        _spans.open = None


@contextlib.contextmanager
def launching():
    """Hold `launch_lock` over one kernel launch on the current stream;
    inside `card_spans`, record the launch's span (module docstring)."""
    spans = getattr(_spans, "open", None)
    with launch_lock:
        if spans is None:
            yield
            return
        import torch
        span = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        span[0].record()
        yield
        span[1].record()
    spans.append(span)


def span_seconds(spans) -> float:
    """Seconds of card time in `card_spans`' list (0 for None), waiting
    for the last span's end."""
    if not spans:
        return 0.0
    spans[-1][1].synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / 1e3
