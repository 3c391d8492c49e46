"""Spans of the port's host path: one tree per ``SpikingChip.sim`` call and
per ``ParameterSweep.run`` call, down to each CUDA-graph replay.

A span has a name, a start and an end on ``time.perf_counter_ns()`` (the
clock of ``time.perf_counter()``), its parent span's id and the id of the
call it belongs to: the chip's sim-call number (``chip.sim_calls``) or the
sweep's run number (``sweep.runs``). Counts go on the span that does the
work (``steps``, ``spikes``), as its fields. The names::

    sanafe.sim                      steps, timing_model
      sanafe.sim.prepare            traces opened, engine found, state adapted
        sanafe.setup.engine         a program and engine built (setup_wall)
        sanafe.setup.merge_sweep    the device sweep built (setup_wall)
      sanafe.chunk                  steps; the feeds, the engine's enqueue and
                                    the host copy's start (neuron_processing_wall)
        sanafe.replay               engine (scan / dag), steps: one graph replay
          sanafe.replay.feeds       the block's feed rows in (scan)
          sanafe.replay.state       the chunk's state in (dag)
          sanafe.replay.launch      the replay itself
          sanafe.replay.outputs     the outputs out
        sanafe.capture              a graph's first capture, in a replay's place
                                    and with its children
        sanafe.exchange             a sharded step's all_reduce (exchange_wall,
                                    exchanges)
      sanafe.book.wait              the host blocked on the chunk's copy
                                    (message_processing_wall)
      sanafe.book.decode            the rest of the outputs' decoding (the same)
      sanafe.book.stats             counters and energies (energy_stats_wall)
      sanafe.book.sweep             the timing sweep (scheduler_wall)
      sanafe.book.traces            spikes, source (the plane the in-memory
                                    spike trace was read from: masks or
                                    spike_log); the trace and perf rows
      sanafe.sim.finish             the writer drained, the totals, the result
    sanafe.sweep.run                steps, samples
      sanafe.chunk                  steps
        sanafe.replay ...           as above
        sanafe.sweep.readback       the wait for the chunk's stats on the host
    sanafe.setup.load               SpikingChip.load (setup_wall)
    sanafe.setup.sweep              ParameterSweep's build
    sanafe.setup.delivery           a program's block delivery built
                                    (ops/delivery.py:build_delivery): the
                                    live rows, or the edge cells where the
                                    kernel walks them faster, on the
                                    kernel's path (delivery_build_wall),
                                    within sanafe.setup.engine or
                                    .setup.sweep, or at a sim call's end
                                    where a program on the cells settles
                                    on the rows (CellBlocks.settle)

On the CPU a program built with ``graph`` set runs each block eagerly, in
a ``sanafe.replay`` span all the same. Spans go per call, chunk and replay,
not per simulated step; the one exception is ``sanafe.exchange``, one per
collective of a sharded (eager) step.

Two modes, switched by whether a ``torch.profiler`` is recording:

- off (the default): a span adds its duration to the wall field it feeds
  (``wall_time`` of ``SpikingChip.format_run_summary``), and its count, and
  keeps nothing else;
- on: a span also opens ``torch.profiler.record_function(name)``, so that
  it appears in the profiler's host timeline beside the device's kernels,
  and goes into a store of the last ``CAPACITY`` spans (``spans``), which
  counts the spans it drops (``dropped``).

To see the spans, run the calls under ``torch.profiler.profile`` and open
the file that ``prof.export_chrome_trace(path)`` writes (in Perfetto or
``chrome://tracing``); or read ``spans()`` in the same process.

In both modes the process also keeps every finished set-up span
(``sanafe.setup.*``, one a load or a build) for a reader in the same
process (the benchmark): ``setups()``. A ``sanafe.setup.delivery`` span
carries its program's delivery counters as fields: ``delivery.path``
(``cells`` where it holds the edge cells, else ``rows``),
``delivery.cells`` (the cells it holds), ``delivery.live_rows`` (the live
rows it holds; 0 where it holds the dense blocks or the cells) and
``delivery.stored_bytes`` (the bytes of its device arrays). A
``sanafe.setup.engine`` or ``sanafe.setup.sweep`` span carries
``neuron.path``: ``kernel`` where its program steps the neuron phase and
roll-up through the neuron kernel (``ops/neuron.py``), else ``plain``.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 65536
SETUP = "sanafe.setup."
SETUP_CAPACITY = 4096
_RecordFunction = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.profiler.record_function)


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    call: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    fields: dict


class _Thread(threading.local):
    """A thread's open call (its owner and id) and its open stored spans."""

    def __init__(self):
        self.owner = None
        self.call = None
        self.stack: list[int] = []


_thread = _Thread()
_lock = threading.Lock()
_store: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count(1)
_drops = [0, 0]  # spans dropped, and the end of the newest dropped
_setups: collections.deque = collections.deque(maxlen=SETUP_CAPACITY)


class span:
    """``with span(name, wall=None, count=None, owner=None, call=None,
    **fields) as s:`` times its block. ``wall`` (and ``count``) name an
    attribute of the owner that the span adds its seconds (and 1) to: the
    ``owner`` given, else that of the open call. A span given ``call`` is a
    call's root: for its block ``owner`` and ``call`` are the open call.
    ``s.fields`` takes counts known only after the work."""

    __slots__ = ("name", "wall", "count", "owner", "call", "fields",
                 "start", "_record", "_saved")

    def __init__(self, name: str, wall: Optional[str] = None,
                 count: Optional[str] = None, owner=None,
                 call: Optional[int] = None, **fields):
        self.name, self.wall, self.count = name, wall, count
        self.owner, self.call, self.fields = owner, call, fields

    def __enter__(self) -> "span":
        thread = _thread
        if self.call is not None:
            self._saved = (thread.owner, thread.call)
            thread.owner, thread.call = self.owner, self.call
        elif self.owner is None:
            self.owner = thread.owner
        self._record = None
        if _profiler._is_profiler_enabled:
            sid = next(_ids)
            parent = thread.stack[-1] if thread.stack else None
            thread.stack.append(sid)
            record = _RecordFunction(self.name)
            record.__enter__()
            self._record = (record, sid, parent, thread.call)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        owner = self.owner
        if owner is not None:
            if self.wall is not None:
                setattr(owner, self.wall, getattr(owner, self.wall)
                        + (end - self.start) * 1e-9)
            if self.count is not None:
                setattr(owner, self.count, getattr(owner, self.count) + 1)
        thread = _thread
        if self.call is not None:
            thread.owner, thread.call = self._saved
        if self._record is not None:
            record, sid, parent, call = self._record
            record.__exit__(None, None, None)
            thread.stack.pop()
            _keep(Span(sid, parent, call, self.name, self.start, end,
                       self.fields))
        if self.name.startswith(SETUP):
            with _lock:
                _setups.append(Span(0, None, None, self.name, self.start,
                                    end, self.fields))


def _keep(record: Span) -> None:
    with _lock:
        if len(_store) == CAPACITY:
            _drops[0] += 1
            _drops[1] = _store[0].end_ns
        _store.append(record)


def spans(since_ns: int = 0, until_ns: Optional[int] = None) -> list:
    """The stored spans that started in ``[since_ns, until_ns]``, in the
    order they ended."""
    with _lock:
        kept = list(_store)
    return [s for s in kept if s.start_ns >= since_ns
            and (until_ns is None or s.start_ns <= until_ns)]


def dropped(since_ns: int = 0) -> int:
    """The spans the full store has dropped, where the newest of them ended
    at or after ``since_ns`` (so some may have started there); else 0."""
    with _lock:
        return _drops[0] if _drops[0] and _drops[1] >= since_ns else 0


def setups() -> list:
    """Every set-up span (``sanafe.setup.*``) the process has finished,
    with or without a profiler, oldest first (the newest ``SETUP_CAPACITY``
    of them)."""
    with _lock:
        return list(_setups)
