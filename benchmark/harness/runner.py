"""One run of one cell: set-up, the measured (or traced) window, and the
comparison with the plain reference once the window has closed.

Every cell is a closed loop with one caller: the cell's request is issued
back to back on one loaded chip. A ``sim`` call continues from the chip's
state; a sweep's ``run`` starts every sample from the loaded chip's state.
The window opens at the first call, issues calls until ``seconds`` have
passed, and closes when the last call ends, each call ended by
``torch.cuda.synchronize()``: the rates are taken over every call and the
whole window, the tails over every call.

The comparison follows a sample of the window's calls drawn from the
seed. Each sampled ``sim`` call is checked together with the call after
it: the reference starts the sampled call from the state the program
held before it, then carries its own state into the next call, so a state
the program fails to hand from one call to the next shows there. The
set-up's first call is checked the same way, from the reference's own
initial state.

The reference is the module that the cell's configuration names
(``Cell.reference``, ``harness/spec.py``): its ``Layout`` and
``Reference`` follow the calls, and its ``STATE_KEYS`` and
``from_program`` read the program's state."""

import gc
import importlib
import os
import random
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import judge, network, profile
from ..reference import noc


@dataclass
class Call:
    begin: float
    end: float
    steps: int
    samples: int


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dtype_of(desc: dict):
    return {"float32": torch.float32, "float64": torch.float64}[desc["dtype"]]


class SimCalls:
    """``SpikingChip.sim(steps, timing_model, ...)`` back to back, with the
    traffic's ``kwargs`` passed to every call unchanged. A sampled call
    keeps the chip's state before it; the reference (the module
    ``reference``) follows the call from that state (the first call, from
    its own initial state) and carries its own state into the call after
    it."""

    samples = 1
    keep_all = False
    carries = True

    def __init__(self, chip, traffic: dict, reference):
        self.chip = chip
        self.reference = reference
        self.steps = traffic["steps"]
        self.detailed = traffic["timing_model"] == "detailed"
        self.spike_trace = bool(traffic.get("spike_trace"))
        self.sweep_workers = traffic.get("sweep_workers", 1)
        self.kwargs = {"timing_model": traffic["timing_model"],
                       "heartbeat": 0, **traffic.get("kwargs", {})}
        if self.spike_trace:
            self.kwargs["spike_trace"] = True

    def call(self):
        return self.chip.sim(self.steps, **self.kwargs)

    def snapshot(self) -> dict:
        """The state the reference models, of the program's state before
        a call; the program may hold more (the check of the call after
        covers whatever it carries). Copied to the host: how many samples
        the window holds at once depends on the calls the seed draws, and
        a copy on the card would add that to ``peak_device_mib``."""
        state = self.chip._device_state
        if state is None:
            return None
        return {key: state[key].to("cpu", copy=True)
                for key in self.reference.STATE_KEYS}

    def t0(self) -> int:
        return self.chip.total_timesteps + 1

    def walls(self) -> dict:
        c = self.chip
        return {"neuron_processing": c.neuron_processing_wall,
                "message_processing": c.message_processing_wall,
                "energy_stats": c.energy_stats_wall,
                "scheduler": c.scheduler_wall,
                "graph_replays": c.graph_replays}

    def release(self, layout) -> None:
        """Keep the reference index of each of the program's neuron slots,
        and let the chip go."""
        neurons = sorted(self.chip.compiled.neurons, key=lambda r: r.slot)
        self.order = torch.as_tensor(
            layout.order_of([(r.group_name, r.offset) for r in neurons]))
        self.chip = None

    def check(self, records: list, layout, device, dtype,
              raster: bool = False, log=None) -> tuple:
        """Readings over the checked calls (in call order), and with
        ``raster`` each call's fired neurons ``[steps, neurons]``. A call
        that follows a checked call continues from the reference's own
        state after it; any other starts from the program's state before
        it. Under detailed timing the reference sweeps every step's
        messages (``reference/noc.py``) for the call's ``sim_time``; with a
        spike trace, ``spike_trace`` is the share of spikes that differ
        from the reference's. ``log`` gets each call's readings."""
        found, rasters = {}, []
        sweeper = noc.Sweeper(noc.tables(layout) if self.detailed else None,
                              self.sweep_workers if self.detailed else 1)
        ref = self.reference.Reference(layout, device, dtype)
        carried, after = None, None
        with sweeper:
            for rec in records:
                follows = rec["index"] == after
                if follows:
                    state, t0 = carried
                else:
                    state, t0 = self.start_of(rec, ref, device, dtype), \
                        rec["t0"]
                one = {}
                carried = self.check_one(rec, ref, state, t0, layout,
                                         raster, sweeper, one, rasters)
                judge.merge(found, one)
                after = rec["index"] + 1
                if log is not None:
                    log(f"call {rec['index']} from step {t0} ("
                        + ("carried" if follows else "initial state"
                           if rec["start"] is None else "program's state")
                        + "): " + ", ".join(f"{k} {v!r}"
                                            for k, v in one.items()))
        return found, rasters

    def start_of(self, rec, ref, device, dtype) -> dict:
        """The program's state before a sampled call, in the reference's
        neuron order (the reference's initial state before the first)."""
        if rec["start"] is None:
            return ref.initial_state()
        return self.reference.from_program(rec["start"], self.order, device,
                                           dtype)

    def check_one(self, rec, ref, state, t0, layout, raster, sweeper, found,
                  rasters) -> tuple:
        """Follow one call from ``state`` at step ``t0`` and read its
        numbers; returns the reference's (state, step) after it."""
        want_raster = raster or self.detailed or self.spike_trace
        state, totals, planes = ref.run(state, t0, self.steps,
                                        raster=want_raster)
        if want_raster:
            fired = planes[0][:, 0].cpu().numpy()
            updated = planes[1][:, 0].cpu().numpy()
        if self.detailed:
            acc = 0.0
            for v in sweeper.times(fired, updated).tolist():
                acc += v
            totals["sim_time"] = np.array([acc])
        if self.spike_trace:
            judge.merge(found, {"spike_trace": judge.spike_gap(
                rec["result"]["spike_trace"], fired, layout)})
        judge.merge(found, judge.readings(rec["result"], totals))
        if raster:
            rasters.append(fired)
        return state, t0 + self.steps


class SweepCalls:
    """``ParameterSweep(chip, {parameter: values}).run(steps)`` back to
    back: the sample ``b`` scales the parameter of every group by the
    ``b``-th of ``samples`` values spaced evenly from ``scale_from`` to
    ``scale_to``; the traffic's ``kwargs`` go to every ``run`` unchanged.
    Every run starts from the loaded chip's state, so the reference runs
    once and every run is held to it."""

    keep_all = True
    carries = False

    def __init__(self, st, chip, traffic: dict, desc: dict, reference):
        self.reference = reference
        self.steps = traffic["steps"]
        sweep = traffic["sweep"]
        self.parameter = sweep["parameter"]
        self.scales = np.linspace(sweep["scale_from"], sweep["scale_to"],
                                  sweep["samples"])
        self.samples = len(self.scales)
        self.kwargs = traffic.get("kwargs", {})
        self.chip = chip
        if chip is not None:
            values = {g["name"]: g["attributes"][self.parameter]
                      * self.scales for g in desc["groups"]}
            self.sweep = st.ParameterSweep(chip, {
                self.parameter: st.expand_group_values(
                    chip.compiled, self.parameter, values)})

    def call(self):
        return self.sweep.run(self.steps, **self.kwargs)

    def snapshot(self):
        return None

    def t0(self) -> int:
        return 1

    def walls(self) -> dict:
        return {}

    def release(self, layout) -> None:
        self.chip = self.sweep = None

    def check(self, records: list, layout, device, dtype,
              raster: bool = False, log=None) -> tuple:
        """Readings over every run, and with ``raster`` each run's fired
        neurons ``[steps, samples, neurons]`` (the reference's, which every
        run is held to)."""
        base = layout.params[self.parameter]
        ref = self.reference.Reference(layout, device, dtype, overrides={
            self.parameter: self.scales[:, None] * base[None, :]})
        state, totals, planes = ref.run(ref.initial_state(self.samples), 1,
                                        self.steps, raster=raster)
        found = {}
        for rec in records:
            judge.merge(found, judge.readings(rec["result"], totals))
        return found, ([planes[0].cpu().numpy()] * len(records) if raster
                       else [])


def make_calls(st, chip, traffic: dict, desc: dict, reference):
    if traffic["entry"] == "sim":
        return SimCalls(chip, traffic, reference)
    if traffic["entry"] == "sweep":
        return SweepCalls(st, chip, traffic, desc, reference)
    raise ValueError(f"unknown entry {traffic['entry']!r}")


def build_kernels(st, device) -> float:
    """Build (or find built) every kernel library and the native scheduler
    in the checkout's ``sanafe_tpu_torch/build/``; returns the seconds."""
    start = time.perf_counter()
    if torch.device(device).type == "cuda":
        from sanafe_tpu_torch.ops import cuda_build

        cuda_build.build(*cuda_build.ALL)
    from sanafe_tpu_torch import native

    native.get_library()
    return time.perf_counter() - start


def launch_counts(cell) -> dict:
    """The launch counters that the cell's per-layer readers name, read
    now: each reader's ``WRAPPER`` (``"module:function"``, a kernel wrapper
    of the program whose ``launches`` attribute counts its launches)."""
    out = {}
    for metric in cell.per_layer:
        wrapper = getattr(cell.metric_reader(metric), "WRAPPER", None)
        if wrapper:
            module, name = wrapper.split(":")
            out[wrapper] = getattr(importlib.import_module(module),
                                   name).launches
    return out


class Reservoir:
    """``size`` calls drawn uniformly from the seed out of a stream of
    unknown length (algorithm R): ``offer(i)`` says whether call ``i``
    enters, and which kept slot it replaces."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = random.Random(seed)

    def offer(self, i: int):
        if i < self.size:
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.size else None


class Window:
    """The cell's calls issued back to back, each timed and ended by a
    synchronisation. The set-up's first call (call 0) and a sample of the
    window's calls (or every one, ``keep_all``) are kept with the state
    each started from, and where the calls carry state, so is the call
    after each, for the comparison."""

    def __init__(self, calls, device, sampler: Reservoir):
        self.calls, self.device, self.sampler = calls, device, sampler
        self.timed, self.timed_indices = [], set()
        self.sampled = [0]  # call indices: the first call, then the sample
        self.kept = {}  # call index -> record
        self.issued = 0

    def issue(self, timed: bool = True) -> float:
        """One call (untimed: set-up's, the profiler's warm-up or the one
        that completes the last sampled pair); returns the time it
        ended."""
        calls = self.calls
        index = self.issued
        slot = None
        if timed and calls.keep_all:
            slot = len(self.sampled)
        elif timed:
            drawn = self.sampler.offer(len(self.timed))
            if drawn is not None:
                slot = drawn + 1  # slot 0 holds the first call
        follows = calls.carries and index - 1 in self.sampled
        rec = None
        if index == 0 or slot is not None or follows:
            rec = {"index": index, "t0": calls.t0(), "start": None}
            if index == 0 or slot is not None:
                rec["start"] = calls.snapshot()
        begin = time.perf_counter()
        result = calls.call()
        sync(self.device)
        end = time.perf_counter()
        self.issued += 1
        if timed:
            self.timed.append(Call(begin, end, calls.steps, calls.samples))
            self.timed_indices.add(index)
        if rec is not None:
            rec["result"] = result
            self.kept[index] = rec
        if slot is not None:
            if slot < len(self.sampled):
                self.sampled[slot] = index
            else:
                self.sampled.append(index)
            live = set(self.sampled)
            if calls.carries:
                live |= {i + 1 for i in self.sampled}
            for i in [i for i in self.kept if i not in live]:
                del self.kept[i]
        return end

    def complete(self) -> None:
        """Issue one more (untimed) call where the last call was sampled
        and its successor is still due."""
        if self.calls.carries and self.issued - 1 in self.sampled:
            self.issue(timed=False)

    def records(self) -> list:
        return [self.kept[i] for i in sorted(self.kept)]


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=print, calls=None) -> dict:
    """Set up ``cell`` from ``seed``, measure it for ``seconds`` (or trace
    its ``trace_calls``), then compare what it produced with the reference.
    Returns the record the result line and the metric readers read.
    ``calls(desc, traffic, device, reference)`` puts something else in the
    program's place (``control.factory``)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    traffic = cell.traffic
    # the program's settings by environment (such as its merge kernel's
    # capacities), set before it is imported
    os.environ.update({k: str(v) for k, v in traffic.get("env", {}).items()})
    desc = cell.describe(seed)
    build_s = 0.0
    if calls is None:
        import sanafe_tpu_torch as st

        build_s = build_kernels(st, device)
        arch, net = network.build_network(st, desc)
        chip = st.SpikingChip(arch, device=device, dtype=dtype_of(desc))
        chip.load(net)
        calls = make_calls(st, chip, traffic, desc, cell.reference)
    else:
        calls = calls(desc, traffic, device, cell.reference)
    checked_calls = traffic.get(
        "trace_checked_calls" if trace else "checked_calls", 0)
    window = Window(calls, device, Reservoir(checked_calls, seed))
    window.issue(timed=False)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (kernel builds {build_s:.3f} s)")

    if trace:
        from torch.profiler import ProfilerActivity, schedule

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        n = traffic["trace_calls"]
        with torch.profiler.profile(
                activities=activities, acc_events=True,
                schedule=schedule(wait=0, warmup=1, active=n)) as prof:
            window.issue(timed=False)  # the profiler's warm-up, not traced
            prof.step()
            launches = launch_counts(cell)
            walls = calls.walls()
            opened = time.perf_counter()
            for _ in range(n):
                closed = window.issue()
                prof.step()
            launches = {name: count - launches[name]
                        for name, count in launch_counts(cell).items()}
            after = calls.walls()
        traced = profile.read(prof)
        traced["launches"] = launches
        traced["walls"] = {key: after[key] - walls[key] for key in walls}
        traced["window_s"] = closed - opened
    else:
        traced = None
        opened = time.perf_counter()
        while True:
            closed = window.issue()
            if closed >= opened + seconds:
                break
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    window.complete()

    # the window has closed: free the program, then follow it in the
    # reference
    layout = cell.reference.Layout(desc)
    calls.release(layout)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check_start = time.perf_counter()
    checked = window.records()
    found, rasters = calls.check(checked, layout, device, torch.float64,
                                 raster=trace, log=log)
    log(f"reference: {len(checked)} calls in "
        f"{time.perf_counter() - check_start:.3f} s")
    return {
        "cell": cell, "traffic": traffic, "desc": desc, "layout": layout,
        "seed": seed, "setup_s": setup_s, "build_s": build_s,
        "calls": window.timed, "window_s": closed - opened,
        "peak_bytes": peak,
        "found": found, "trace": traced,
        # the traced calls' rasters, [steps, neurons] or [steps, samples,
        # neurons] each, where every traced call was checked
        "rasters": [r for rec, r in zip(checked, rasters)
                    if rec["index"] in window.timed_indices] if trace
        else [],
        # a call that raises ends the run with no result
        "device": device, "attempted": len(window.timed), "failed": 0,
    }
