"""The comparison that decides ``correct``, at small sizes on the CPU: the
program's CPU path passes against the plain reference; the reference put
in the program's place at a lower precision fails (the control), and so
does each fault a cell can have, planted in the reference put in the
program's place. The card's versions run the same at small sizes on the
card, with TF32 products as the control."""

import time

import pytest
import torch

from benchmark.harness import control, report, runner

CELLS = ("full.simple", "dvs.simple", "dvs.acceptance", "full.sweep16")
SIM_CELLS = CELLS[:3]


def shorten(cell):
    """A short call of DVS-gesture (the CPU steps it slowly), the sweep
    of the host's timing in this process."""
    traffic = dict(cell.traffic, checked_calls=1, trace_calls=2,
                   trace_checked_calls=2, sweep_workers=1)
    if cell.config["name"] == "dvs_gesture":
        traffic["steps"] = 40
    cell.traffic = traffic
    return cell


def run(cell, device="cpu", calls=None, trace=False):
    torch.set_num_threads(2)
    out = runner.run_cell(cell, 2**31 + 7, 0.2, trace, device,
                          time.perf_counter(), log=lambda text: None,
                          calls=calls)
    return report.result_line(cell, out, trace)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_passes_against_the_reference(small_cell, name):
    line = run(shorten(small_cell(name)))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_a_lower_precision_fails(small_cell, name):
    line = run(shorten(small_cell(name)),
               calls=control.factory(dtype=torch.bfloat16))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_fails(small_cell, name, fault):
    line = run(shorten(small_cell(name)),
               calls=control.factory(fault=fault))
    assert not line["correct"], (fault, line["checks"])


# In `full` every neuron's state repeats from step to step once the net
# is steady (a driven neuron fires each step, and so does each neuron it
# reaches), so the state after the last full block of 16 steps is the state
# after the last step there, and handing it on changes no answer.
@pytest.mark.parametrize("name, fault", [
    (name, fault) for name in SIM_CELLS for fault in control.CARRY_FAULTS
    if not (fault == "last_block_state" and name.startswith("full."))])
def test_a_state_not_handed_to_the_next_call_fails(small_cell, name, fault):
    line = run(shorten(small_cell(name)),
               calls=control.factory(fault=fault))
    assert not line["correct"], (fault, line["checks"])


def test_the_window_keeps_each_sampled_call_and_its_successor():
    class Calls:
        keep_all, carries, steps, samples = False, True, 1, 1

        def __init__(self):
            self.n = 0

        def call(self):
            self.n += 1
            return self.n

        def snapshot(self):
            return self.n

        def t0(self):
            return self.n + 1

    window = runner.Window(Calls(), "cpu", runner.Reservoir(3, 5))
    for _ in range(40):
        window.issue(timed=window.issued > 0)
    window.complete()
    kept = {rec["index"]: rec for rec in window.records()}
    heads = set(window.sampled)
    assert 0 in heads and len(heads) == 4
    assert set(kept) == heads | {i + 1 for i in heads}
    for i, rec in kept.items():
        assert rec["result"] == i + 1 and rec["t0"] == i + 1
        if i in heads:
            assert rec["start"] == i
        assert i in heads or i - 1 in heads
    assert window.issued == 40 + (39 in heads)
    assert len(window.timed) == 39


def test_the_reference_itself_in_the_programs_place_passes(small_cell):
    line = run(shorten(small_cell("full.simple")),
               calls=control.factory(dtype=torch.float64))
    assert line["correct"], line["checks"]


def test_a_traced_run_checks_and_reports_per_layer_metrics(small_cell):
    line = run(shorten(small_cell("full.simple")), trace=True)
    assert line["correct"], line["checks"]
    assert "chip.book_ms_per_call" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("full.simple", "full.sweep16"))
def test_on_the_card_program_passes_and_tf32_control_fails(cuda, small_cell,
                                                           name):
    assert run(shorten(small_cell(name)), device=cuda)["correct"]
    line = run(shorten(small_cell(name)), device=cuda,
               calls=control.factory(dtype=torch.float32,
                                     allow_tf32=True))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ("dvs.acceptance", "full.simple"))
def test_the_host_sweep_times_every_step_as_the_program_does(small_cell,
                                                              name):
    """reference/noc.py against the program's detailed sweep, step by step
    and bit for bit, on the reference's own raster: a near-tie between two
    messages' sent times turns on the last bit of a route's congestion."""
    import numpy as np

    import sanafe_tpu_torch as st
    from benchmark.harness import network
    from benchmark.reference import noc
    from benchmark.reference.chip import Layout, Reference

    torch.set_num_threads(2)
    cell = small_cell(name)
    desc = cell.describe(5)
    arch, net = network.build_network(st, desc)
    chip = st.SpikingChip(arch, device="cpu", dtype=torch.float32)
    chip.load(net)
    native = chip._get_native_scheduler()
    times = []
    sweep = native.run_chunk_packed

    def spy(masks, sync):
        out = sweep(masks, sync)
        times.append(np.array(out))
        return out

    native.run_chunk_packed = spy
    steps = 30
    chip.sim(steps, timing_model="detailed", heartbeat=0)
    program = np.concatenate(times)
    layout = Layout(desc)
    ref = Reference(layout, "cpu", torch.float64)
    _, _, planes = ref.run(ref.initial_state(), 1, steps, raster=True)
    with noc.Sweeper(noc.tables(layout), 1) as sweeper:
        reference = sweeper.times(planes[0][:, 0].numpy(),
                                  planes[1][:, 0].numpy())
    assert program.shape == reference.shape
    assert (program == reference).all(), np.flatnonzero(program != reference)
