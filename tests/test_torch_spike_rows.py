"""The in-memory spike trace's pass over a packed plane
(sanafe_tpu_torch/native.py: ``spike_rows``, in ``csrc/scheduler.cpp``;
trace.py: ``spike_lists``).

``spike_rows`` is held to two plain versions kept here: the loop it
replaced (the plane's bits gathered into spike-log rows, ``np.nonzero``
over them and one append a spike) and the same pass in NumPy
(``plain_spike_rows``: only the nonzero bytes unpacked, one sort). Cases:
random planes with a permuted map holding -1 entries, empty steps and an
all-fired step, ``n % 8 != 0``, one step, pad bytes past the real neurons
(a sharded program's plane before ``book.decode`` trims it), the identity
map of a program's own spike log, and rows read from the fired half of a
``[T, 2, nbytes]`` masks buffer in place. ``counts`` and ``rows`` are
compared exactly, and the lists built from them by the identity of their
address objects.

Through ``SpikingChip.sim`` (300 detailed or simple steps in chunks of
128, which takes the detailed model's head and tail chunks) the port's
in-memory spike trace equals sanafe_tpu's step for step, in order, on
chips whose sorted group names differ from their slot order; the
``sanafe.book.traces`` span's ``source`` field names the plane read: the
fired masks (the DAG engine and the step scan under detailed timing) or
the program's spike log (the scan under simple timing, ``chunk_plain``).
sanafe_tpu and JAX are imported inside the tests that use them.
"""

import time

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st
from sanafe_tpu_torch import tracing
from sanafe_tpu_torch.native import spike_rows
from sanafe_tpu_torch.trace import NeuronAddress, spike_lists

from test_torch_chips import (
    example_chip,
    low_bulk_threshold,  # noqa: F401 (fixture)
    mini_dag_chip,
)


def plain_spike_lists(packed, n_bits, slots, addresses):
    """The loop ``SpikingChip`` booked the trace with: the log rows
    gathered from the plane by ``slots`` (each row's bit), their set bits
    in step-major order, one append a spike."""
    log = np.unpackbits(packed, axis=1)[:, :n_bits][:, slots]
    per_step = [[] for _ in range(packed.shape[0])]
    for i, j in zip(*np.nonzero(log)):
        per_step[i].append(addresses[j])
    return per_step


def plain_spike_rows(packed, n_bits, row_of_bit):
    """``spike_rows`` in NumPy: the nonzero bytes found and unpacked, each
    set bit mapped to its row, one sort on ``step * span + row``."""
    n_steps, n_bytes = packed.shape
    flat = np.ascontiguousarray(packed).reshape(-1)
    nonzero = np.flatnonzero(flat != 0)
    set_bits = np.flatnonzero(np.unpackbits(flat[nonzero]))
    where = nonzero[set_bits >> 3]
    steps = where // n_bytes
    bits = (where - steps * n_bytes) * 8 + (set_bits & 7)
    inside = bits < min(n_bits, len(row_of_bit))
    steps, bits = steps[inside], bits[inside]
    rows = np.asarray(row_of_bit, dtype=np.int64)[bits]
    logged = rows >= 0
    span = max(len(row_of_bit), 1)
    keys = np.sort(steps[logged] * span + rows[logged])
    steps, rows = np.divmod(keys, span)
    return np.bincount(steps, minlength=n_steps), rows


def _random_fired(rng, steps, n, density):
    return rng.random((steps, n)) < density


def _case(name):
    """(packed plane, n_bits, slots of the logged rows) for ``name``."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "random":
        n = 61
        fired = _random_fired(rng, 9, n, 0.3)
        slots = rng.permutation(n)[:45]  # 16 slots log no spikes
    elif name == "empty_and_full_steps":
        n = 40
        fired = _random_fired(rng, 6, n, 0.2)
        fired[[0, 3]] = False
        fired[4] = True
        slots = rng.permutation(n)[:33]
    elif name == "one_step":
        n = 13
        fired = _random_fired(rng, 1, n, 0.5)
        slots = rng.permutation(n)
    elif name == "pad_bytes":
        # a sharded program's plane: the real neurons' bytes, then pad
        # bytes; pad slots never fire, here every pad bit is set
        n = 27
        fired = _random_fired(rng, 5, n, 0.4)
        plane = np.packbits(fired, axis=1)
        plane[:, -1] |= 0x1F  # the bits past n in the last real byte
        pad = np.full((5, 3), 0xFF, dtype=np.uint8)
        return (np.concatenate([plane, pad], axis=1), n,
                rng.permutation(n)[:20])
    elif name == "masks_in_place":
        # the fired half of a [T, 2, nbytes] masks buffer, rows 2 * nbytes
        # apart; the updated half differs
        n = 45
        fired = np.packbits(_random_fired(rng, 8, n, 0.3), axis=1)
        updated = np.packbits(_random_fired(rng, 8, n, 0.6), axis=1)
        masks = np.stack([fired, updated], axis=1)
        return masks[:, 0, :], n, rng.permutation(n)[:40]
    elif name == "identity":
        n = 30
        fired = _random_fired(rng, 7, n, 0.25)
        slots = np.arange(n)
    else:
        raise ValueError(name)
    return np.packbits(fired, axis=1), n, slots


@pytest.mark.parametrize("name", ["random", "empty_and_full_steps",
                                  "one_step", "pad_bytes", "masks_in_place",
                                  "identity"])
def test_spike_rows_match_the_loop(name):
    """``spike_rows`` + ``spike_lists`` give the loop's lists: the same
    counts, rows and address objects, step for step; and the NumPy pass's
    counts and rows."""
    packed, n_bits, slots = _case(name)
    row_of_bit = np.full(n_bits, -1, dtype=np.int32)
    row_of_bit[slots] = np.arange(len(slots))
    addresses = np.empty(len(slots), dtype=object)
    addresses[:] = [NeuronAddress("g", int(s)) for s in slots]
    want = plain_spike_lists(packed, n_bits, slots, list(addresses))

    counts, rows = spike_rows(packed, n_bits, row_of_bit)
    assert counts.tolist() == [len(step) for step in want]
    log = np.unpackbits(packed, axis=1)[:, :n_bits][:, slots]
    assert rows.tolist() == np.nonzero(log)[1].tolist()
    plain_counts, plain_rows = plain_spike_rows(packed, n_bits, row_of_bit)
    assert counts.tolist() == plain_counts.tolist()
    assert rows.tolist() == plain_rows.tolist()
    got = spike_lists(addresses, counts, rows)
    assert len(got) == len(want) == packed.shape[0]
    for a, b in zip(got, want):
        assert len(a) == len(b)
        assert all(x is y for x, y in zip(a, b))
    if name == "empty_and_full_steps":
        assert counts[0] == counts[3] == 0 and counts[4] == len(slots)
    assert counts.sum() > 0


# name: (builder, timing model, the port's engine, the plane it reads)
SIMS = {
    "dag_detailed": (mini_dag_chip, "detailed", "dag", "masks"),
    "scan_detailed": (mini_dag_chip, "detailed", "scan", "masks"),
    "scan_simple": (mini_dag_chip, "simple", "scan", "spike_log"),
    "chunk_plain_detailed": (example_chip, "detailed", "chunk_plain",
                             "spike_log"),
}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_spike_trace_matches_jax(name, low_bulk_threshold, monkeypatch):
    """300 steps in chunks of 128 on one chip of each package: the port's
    in-memory spike trace equals sanafe_tpu's step for step, in order,
    and each ``sanafe.book.traces`` span names the plane it read."""
    import jax

    import sanafe_tpu

    builder, timing_model, engine, source = SIMS[name]
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        # sanafe_tpu on its own engine choice (its DAG engine's spikes
        # equal its scan's; its scan compiles for minutes on this net)
        arch, net = builder(sanafe_tpu)
        jax_chip = sanafe_tpu.SpikingChip(arch)
        jax_chip.load(net)
        want = jax_chip.sim(300, timing_model=timing_model, heartbeat=0,
                            spike_trace=True)
    finally:
        jax.config.update("jax_enable_x64", x64)

    if engine == "scan":
        monkeypatch.setenv("SANAFE_TPU_DAG", "0")
    arch, net = builder(st)
    chip = st.SpikingChip(arch, device="cpu")
    chip.load(net)
    start = time.perf_counter_ns()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = chip.sim(300, timing_model=timing_model, heartbeat=0,
                       chunk=128, spike_trace=True)
    assert got["device_engine"] == engine
    booked = [s for s in tracing.spans(start)
              if s.name == "sanafe.book.traces"]
    assert len(booked) == 3
    assert {s.fields["source"] for s in booked} == {source}
    assert sum(s.fields["spikes"] for s in booked) == got["neurons_fired"]

    trace = [[(a.group_name, a.neuron_offset) for a in step]
             for step in got["spike_trace"].data]
    ref = [[(a.group_name, a.neuron_offset) for a in step]
           for step in want["spike_trace"].data]
    assert len(trace) == len(ref) == 300
    assert trace == ref
    assert sum(map(len, trace)) == got["neurons_fired"] > 0
    # the lists hold the chip's shared address objects
    shared = {id(a) for a in chip._spike_maps()[0]}
    assert all(id(a) in shared for step in got["spike_trace"].data
               for a in step)
