"""Scale-out of the port over torch.distributed (sanafe_tpu_torch/parallel)
against one process of the port and against sanafe_tpu.

The ranks are processes started with ``torch.multiprocessing``'s spawn
method on the gloo backend, 2 and 3 of them, joined through a FileStore
under the test's temporary directory; each runs every case once
(``_rank_main``) and rank 0 leaves what the tests compare: trace files and
a pickle of results. A rank that fails, or outlives the join timeout (it is
killed), fails every test of its mesh. The rank workers import neither jax
nor sanafe_tpu (this module imports them inside the tests only).

- ``pad_compiled`` array for array against sanafe_tpu's; padding to a
  multiple of 7 is inert; each rank's blocks deliver its neurons as the
  whole chip's blocks do;
- ``tests/test_parallel.py::test_sim_sharded_trace_parity`` on
  ``active_chip``: spikes, potentials, perf and messages CSVs byte-identical
  to one process of the port and to sanafe_tpu, counters equal;
- the conv chip (conv delivery plus the dense head's blocks), the
  stochastic chip (LIF noise stream, Poisson feeds sliced by owner, perf
  columns), the delay and multitap chips (the scatter path's per-edge
  state) and the NeuroFEM chip without and with membrane noise (plugin
  compartments; each rank draws its own neurons' noise), padded at both
  mesh sizes, sharded: spike, potential and perf CSVs equal to one process;
- ``test_sim_sharded_resume_checkpoint_and_unshard``: single -> sharded ->
  ``.npz`` round trip -> single, a sharded sanafe_tpu ``.npz`` resumed on
  the mesh, and a ``torch.distributed.checkpoint`` directory round trip on
  the mesh, then read by one process;
- ``tests/test_batch.py::test_mesh_sharded_sweep_matches_unsharded`` (and a
  Hodgkin-Huxley plugin sweep) split over the ranks, with the ``B % world``
  ``ValueError``;
- the exchange's exactness: a -0.0 and a NaN payload cross the mesh with
  their bits.
"""

import pickle
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest
import torch

import sanafe_tpu_torch as st
from sanafe_tpu_torch.parallel import pad_chip, pad_compiled

from test_torch_chips import (
    active_chip,
    batch_chip,
    conv_chip,
    delay_chip,
    example_chip,
    hh_chip,
    low_bulk_threshold,  # noqa: F401 (a fixture)
    multitap_chip,
    neurofem_chip,
    random_chip,
    stochastic_chip,
)

WORLDS = (2, 3)
JOIN_S = 120  # a rank still alive after this is killed
STEPS = 120
CHUNK = 48
SEGMENT = 40  # the checkpoint case's three segments
CHIP_STEPS = 60
TRACES = ("spikes", "potentials", "perf", "messages")


def neurofem_quiet(mod):
    """37 neurons: padded on a mesh of 2 and of 3."""
    return neurofem_chip(mod, n_post=25)


def neurofem_noisy(mod):
    return neurofem_chip(mod, n_post=25, sigma_v=0.3)


# the chips sharded besides the active chip, each with the traces it has
# and whether sanafe_tpu draws the same run (the port's NeuroFEM noise is
# its own stream)
SHARDED = {
    "conv": (conv_chip, ("spikes", "perf"), True),
    "stochastic": (stochastic_chip, ("spikes", "potentials", "perf"), True),
    "delay": (delay_chip, ("spikes", "potentials", "perf"), True),
    "multitap": (multitap_chip, ("spikes", "potentials", "perf"), True),
    "neurofem": (neurofem_quiet, ("spikes", "potentials", "perf"), True),
    "neurofem_noisy": (neurofem_noisy, ("spikes", "potentials", "perf"),
                       False),
}
SWEEP_THRESHOLDS = np.linspace(1.0, 4.0, 6)
HH_CURRENTS = np.linspace(-320.0, -180.0, 6)


def _loaded(mod, builder, **kwargs):
    arch, net = builder(mod)
    chip = mod.SpikingChip(arch, **kwargs)
    chip.load(net)
    return chip


def _port(builder):
    return _loaded(st, builder, device="cpu", dtype=torch.float64)


def _sim_traces(chip, out: Path, names, steps, mesh=None,
                timing_model="detailed"):
    out.mkdir(parents=True, exist_ok=True)
    kwargs = {"spikes": "spike_trace", "potentials": "potential_trace",
              "perf": "perf_trace", "messages": "message_trace"}
    traces = {kwargs[name]: str(out / f"{name}.csv") for name in names}
    if mesh is not None:
        traces["mesh"] = mesh
    result = chip.sim(steps, timing_model=timing_model, heartbeat=0,
                      chunk=CHUNK, **traces)
    chip.close()
    return result


def _segments(chip, path: Path, plan):
    """Spike rows of consecutive sim() calls in one stream; ``plan`` is a
    list of (mesh or None, action before the call)."""
    with open(path, "w") as stream:
        for k, (mesh, before) in enumerate(plan):
            if before is not None:
                before(chip)
            chip.sim(SEGMENT, timing_model="detailed", heartbeat=0, chunk=32,
                     spike_trace=stream, write_trace_headers=k == 0,
                     mesh=mesh)
        chip.close()


def _rows(path: Path, first: int, last: int) -> list:
    """spikes.csv rows of timesteps ``first..last``."""
    rows = path.read_text().splitlines()[1:]
    return [r for r in rows if first <= int(r.rsplit(",", 1)[1]) <= last]


def _summary(result) -> dict:
    keep = ("spikes", "neurons_fired", "neurons_updated", "packets_sent",
            "sim_time", "energy", "device_engine", "timestep_start")
    return {key: result[key] for key in keep}


# --- the ranks ----------------------------------------------------------------

def _rank_main(rank: int, world: int, store: str, out: str, jax_npz: str):
    """One rank: every case on a ``world``-rank gloo mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import sanafe_tpu_torch.network as port_network

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=JOIN_S))
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("cores",))
        out = Path(out)
        res = {}

        # the exchange keeps every bit: -0.0 and a NaN payload
        from sanafe_tpu_torch.parallel import gather_state

        special = torch.tensor([-0.0, float("nan"), 1.5], dtype=torch.float64)
        special = special.view(torch.int64).clone()
        special[1] += 12345  # a NaN with another payload
        local = {"potential": special.view(torch.float64)[rank % 3:][:1]}
        whole = gather_state(local, mesh, world)["potential"]
        res["exchange_bits"] = whole.view(torch.int64).tolist()
        res["exchange_want"] = [int(special[r % 3]) for r in range(world)]

        chip = _port(active_chip)
        r = _sim_traces(chip, out / "active", TRACES, STEPS, mesh=mesh)
        res["active"] = _summary(r)
        res["active_n"] = chip._engines[next(iter(chip._engines))].prog.\
            compiled.n_neurons
        res["active_sticky"] = chip._mesh is mesh

        # a kernel-delivery program on each rank (the CPU runs the kernel's
        # sums), built from the rank's own edges: their blocks' cells, the
        # random chip's live rows being sparse
        import functools

        import sanafe_tpu_torch.chip as port_chip
        from sanafe_tpu_torch.ops.delivery import (
            CellBlocks,
            DenseBlocks,
            block_tiling,
            build_live_rows,
            cells_faster,
            pack_arrival_plane,
        )
        from sanafe_tpu_torch.parallel import block_edges, neuron_range

        build = port_chip.make_device_program
        port_chip.make_device_program = functools.partial(build,
                                                          use_kernel=True)
        try:
            chip = _port(random_chip)
            res["kernel_mesh"] = _summary(_sim_traces(
                chip, out / "kernel_mesh", ("spikes",), CHIP_STEPS,
                mesh=mesh))
        finally:
            port_chip.make_device_program = build
        prog = next(iter(chip._engines.values())).prog
        blk = prog.block
        c = prog.compiled
        owned, _ = block_edges(c, None, block_tiling(c.n_neurons)[0],
                               *neuron_range(c.n_neurons, rank, world))
        dense = DenseBlocks.build(c, prog.dtype, "cpu", owned)
        plane = pack_arrival_plane(dense.counts)
        rows = build_live_rows(dense.weights, plane)
        want = CellBlocks.build(c, prog.dtype, "cpu", owned).cells
        held = blk.cells
        (out / f"kernel_mesh_r{rank}.pkl").write_bytes(pickle.dumps({
            "kernel": prog.kernel_delivery and prog.shard is not None,
            "cells": (isinstance(blk, CellBlocks)
                      and cells_faster(want.count, want.longest, rows.count,
                                       blk.n_tiles, blk.tile, prog.dtype)),
            "count": held.count,
            "equal": (held.count == want.count == int(
                          (dense.counts > 0).sum())
                      and torch.equal(held.src, want.src)
                      and torch.equal(held.lengths, want.lengths)
                      and torch.equal(held.starts, want.starts)
                      and torch.equal(held.weights.view(torch.int64),
                                      want.weights.view(torch.int64))),
            "planned": blk.plan.cells is held,
            "tiles": sorted(set(blk.dest_tiles.tolist())),
        }))

        port_network.BULK_EDGE_THRESHOLD = 1  # conv_chip's structured path
        for name, (builder, names, _) in SHARDED.items():
            chip = _port(builder)
            r = _sim_traces(chip, out / name, names, CHIP_STEPS, mesh=mesh)
            res[name] = _summary(r)
            res[f"{name}_n"] = chip._padded_for(mesh).n_neurons
            if name == "conv":
                prog = next(iter(chip._engines.values())).prog
                res["conv_route"] = prog.conv_delivery is not None

        # checkpoints: single -> sharded -> .npz round trip -> single
        chip = _port(active_chip)
        ckpt = out / "state.npz"

        def save_and_load(c):
            c.save_state(ckpt)
            c.load_state(ckpt)
            c.set_mesh(None)

        _segments(chip, out / f"resume_r{rank}.csv",
                  [(None, None), (mesh, None), (None, save_and_load)])
        # sanafe_tpu's sharded .npz (its 8-device mesh pads to 168)
        chip = _port(active_chip)
        chip.load_state(jax_npz)
        res["jax_npz_t"] = chip.total_timesteps
        with open(out / f"from_jax_r{rank}.csv", "w") as stream:
            chip.sim(SEGMENT, timing_model="detailed", heartbeat=0,
                     chunk=32, spike_trace=stream, mesh=mesh)
            chip.close()
        # a torch.distributed.checkpoint directory on the mesh
        chip = _port(active_chip)
        chip.sim(SEGMENT, heartbeat=0, chunk=32, mesh=mesh)
        chip.save_state(out / "state.dcp")
        for k in (0, 1):
            if k:
                chip.load_state(out / "state.dcp")
            with open(out / f"dcp{k}_r{rank}.csv", "w") as stream:
                chip.sim(SEGMENT, timing_model="detailed", heartbeat=0,
                         chunk=32, spike_trace=stream)
                chip.close()

        # ParameterSweep(mesh=): the samples split over the ranks
        chip = _port(batch_chip)
        over = st.expand_group_values(chip.compiled, "threshold",
                                      {"a": SWEEP_THRESHOLDS})
        res["sweep"] = st.ParameterSweep(chip, {"threshold": over},
                                         mesh=mesh).run(30)
        try:
            st.ParameterSweep(chip, {"threshold": over[:world + 1]},
                              mesh=mesh)
        except ValueError as exc:
            res["sweep_error"] = str(exc)
        chip = _port(hh_chip)
        currents = st.expand_group_values(
            chip.compiled, "plugin_hodgkin_huxley_current",
            {"pop": HH_CURRENTS},
            base=chip.compiled.plugin_params["hodgkin_huxley"]["current"])
        res["hh_sweep"] = st.ParameterSweep(
            chip, {"plugin_hodgkin_huxley_current": currents},
            mesh=mesh).run(20)
        if rank == 0:
            (out / "result.pkl").write_bytes(pickle.dumps(res))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_npz():
    """sanafe_tpu's active chip after 40 detailed steps on its 8-device
    mesh, checkpointed to a .npz (padded to 168 neurons)."""
    import jax
    from jax.sharding import Mesh

    import sanafe_tpu as sf

    path = Path(tempfile.mkdtemp(prefix="sanafe_mesh_")) / "jax.npz"
    chip = _loaded(sf, active_chip)
    chip.sim(SEGMENT, timing_model="detailed", heartbeat=0, chunk=32,
             mesh=Mesh(np.array(jax.devices()), ("cores",)))
    chip.save_state(path)
    return path


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_npz, tmp_path_factory):
    """Run ``_rank_main`` on ``world`` spawned ranks; returns (world, the
    output directory, rank 0's results)."""
    world = request.param
    out = tmp_path_factory.mktemp(f"mesh{world}")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(out / "store"), str(out),
                               str(jax_npz)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    codes = [p.exitcode for p in procs]
    assert not alive and codes == [0] * world, f"ranks exited {codes}"
    return world, out, pickle.loads((out / "result.pkl").read_bytes())


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """One process of the port: the active chip's four traces and each
    sharded chip's, written once for every mesh."""
    import sanafe_tpu_torch.network as port_network

    out = tmp_path_factory.mktemp("single")
    results = {"active": _summary(_sim_traces(_port(active_chip),
                                              out / "active", TRACES,
                                              STEPS))}
    old = port_network.BULK_EDGE_THRESHOLD
    port_network.BULK_EDGE_THRESHOLD = 1
    try:
        for name, (builder, names, _) in SHARDED.items():
            results[name] = _summary(_sim_traces(
                _port(builder), out / name, names, CHIP_STEPS))
    finally:
        port_network.BULK_EDGE_THRESHOLD = old
    chip = _port(active_chip)
    _segments(chip, out / "continuous.csv", [(None, None)] * 3)
    return out, results


def assert_same_run(a: dict, b: dict, rel: float = 0.0):
    for key in ("spikes", "neurons_fired", "neurons_updated",
                "packets_sent"):
        assert a[key] == b[key], key
    for key in a["energy"]:
        assert abs(a["energy"][key] - b["energy"][key]) <= rel * abs(
            a["energy"][key]), key
    assert abs(a["sim_time"] - b["sim_time"]) <= rel * abs(a["sim_time"])


# --- the tests ------------------------------------------------------------------

PAD_CHIPS = {"example": example_chip, "random384": random_chip,
             "conv": conv_chip, "delay": delay_chip}


@pytest.mark.parametrize("name", sorted(PAD_CHIPS))
def test_pad_compiled_matches_jax(name, low_bulk_threshold):
    """The port's pad_compiled is sanafe_tpu's: every array equal."""
    import dataclasses

    import sanafe_tpu as sf
    from sanafe_tpu.compile import compile_chip as compile_jax
    from sanafe_tpu.parallel import pad_compiled as jax_pad

    from sanafe_tpu_torch.compile import compile_chip

    builder = PAD_CHIPS[name]
    for multiple in (3, 8):
        ours = pad_compiled(compile_chip(*builder(st)), multiple)
        theirs = jax_pad(compile_jax(*builder(sf)), multiple)
        assert ours.n_neurons % multiple == 0
        assert ours.n_neurons == theirs.n_neurons
        checked = 0
        for field in dataclasses.fields(theirs):
            x, y = getattr(theirs, field.name), getattr(ours, field.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=field.name)
                checked += 1
            elif field.name == "plugin_params":
                for model, params in x.items():
                    for param, values in params.items():
                        np.testing.assert_array_equal(
                            values, y[model][param])
        assert checked > 50


def test_padding_to_seven_is_inert():
    """A program of the chip padded to a multiple of 7 (``pad_chip``: the
    perf columns and the shared-unit ranks and strides too) gives the
    unpadded program's stats and masks (cut to the real neurons)."""
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops.scan import run_scan
    from sanafe_tpu_torch.ops.step import make_device_program

    for builder in (example_chip, active_chip, stochastic_chip, hh_chip):
        c = compile_chip(*builder(st))
        padded = pad_chip(c, 7)
        assert padded.n_neurons % 7 == 0 and padded.n_neurons > c.n_neurons
        outs = []
        for compiled in (c, padded):
            prog = make_device_program(compiled, "cpu", torch.float64,
                                       record_fired_axons=True)
            feeds = {}
            if compiled.has_poisson:
                k = sum(len(m) for _, m in compiled.input_units)
                feeds["poisson"] = np.random.default_rng(0).random(
                    (40, k)) < 0.3
            _, out = run_scan(prog, prog.init_state(), 1, 40, feeds)
            outs.append(out)
        nb = (c.n_neurons + 7) // 8
        assert torch.equal(outs[0]["stats"], outs[1]["stats"])
        assert torch.equal(outs[0]["masks_packed"],
                           outs[1]["masks_packed"][:, :, :nb])
        assert outs[0]["stats"][:, 4].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_block_edges_deliver_each_rank_whole(world):
    """A rank's blocks (the tiles that hold its neurons, ``block_edges``)
    deliver its neurons' currents and arrival bits bit for bit as the
    whole chip's blocks do, while a rank whose neurons span one tile
    builds that tile's blocks only; the route count is the chip's."""
    from sanafe_tpu_torch.compile import compile_chip
    from sanafe_tpu_torch.ops.delivery import (
        DenseBlocks,
        block_tiling,
        delivery_plain,
    )
    from sanafe_tpu_torch.parallel import block_edges, neuron_range

    c = pad_chip(compile_chip(*random_chip(st)), world)
    tile, n_tiles = block_tiling(c.n_neurons)
    assert n_tiles == 2
    fired = torch.from_numpy(
        (np.random.default_rng(world).random(n_tiles * tile) < 0.5)
        .astype(np.float64)).view(n_tiles, tile)

    def deliver(blk):
        cur, cnt = delivery_plain(fired, blk.weights, blk.counts,
                                  blk.src_tiles, blk.dest_offsets,
                                  blk.max_blocks_per_dest)
        return cur.reshape(-1), cnt.reshape(-1) > 0

    whole = DenseBlocks.build(c, torch.float64, "cpu")
    want_cur, want_any = deliver(whole)
    tiles_built = []
    for rank in range(world):
        lo, hi = neuron_range(c.n_neurons, rank, world)
        owned, total = block_edges(c, None, tile, lo, hi)
        assert total == whole.weights.shape[0]
        blk = DenseBlocks.build(c, torch.float64, "cpu", owned)
        cur, arrived = deliver(blk)
        assert torch.equal(cur[lo:hi].view(torch.int64),
                           want_cur[lo:hi].view(torch.int64))
        assert torch.equal(arrived[lo:hi], want_any[lo:hi])
        tiles_built.append(set(blk.dest_tiles.tolist()))
    assert tiles_built[0] == {0}
    assert set().union(*tiles_built) == {0, 1}


def test_kernel_program_on_the_mesh(ranks, tmp_path):
    """Each rank's kernel-delivery program holds the cells of its own
    blocks alone, the byte rule's choice for the random chip's sparse live
    rows (``build_live_rows`` of the dense blocks of the rank's edges): the
    cells its edges give, one a cell of those blocks; the ranks' destination
    tiles cover the chip, and the sharded run through the lists gives one
    process's spike raster and counters."""
    world, out, res = ranks
    ranks_seen = [pickle.loads((out / f"kernel_mesh_r{r}.pkl").read_bytes())
                  for r in range(world)]
    for info in ranks_seen:
        assert info["kernel"] and info["equal"] and info["planned"]
        assert info["cells"]
        assert info["count"] > 0
    assert ranks_seen[0]["tiles"] == [0]
    assert set().union(*(set(i["tiles"]) for i in ranks_seen)) == {0, 1}
    one = _sim_traces(_port(random_chip), tmp_path, ("spikes",), CHIP_STEPS)
    mesh_run = res["kernel_mesh"]
    assert mesh_run["device_engine"] == "scan"
    for key in ("spikes", "neurons_fired", "neurons_updated",
                "packets_sent", "sim_time"):
        assert mesh_run[key] == one[key], key
    assert mesh_run["neurons_fired"] > 0
    assert (out / "kernel_mesh" / "spikes.csv").read_bytes() == (
        tmp_path / "spikes.csv").read_bytes()


def test_exchange_keeps_every_bit(ranks):
    """A gather adds float bit patterns as integers: -0.0 and a NaN with a
    payload arrive as they left."""
    _, _, res = ranks
    assert res["exchange_bits"] == res["exchange_want"]


def test_sim_sharded_trace_parity(ranks, single):
    """The active chip on the mesh: the four CSVs byte-identical to one
    process of the port and to sanafe_tpu, counters and floats equal, the
    chip padded to a multiple of the mesh, the mesh sticky."""
    import sanafe_tpu as sf

    world, out, res = ranks
    base, singles = single
    assert res["active_sticky"]
    assert res["active_n"] % world == 0 and res["active_n"] >= 164
    assert res["active"]["device_engine"] == "scan"
    assert res["active"]["spikes"] > 10
    assert_same_run(singles["active"], res["active"])
    jax_dir = out / "jax_active"
    theirs = _sim_traces(_loaded(sf, active_chip), jax_dir, TRACES, STEPS)
    assert_same_run(theirs, res["active"])
    for name in TRACES:
        ours = (out / "active" / f"{name}.csv").read_bytes()
        assert ours == (base / "active" / f"{name}.csv").read_bytes(), name
        assert ours == (jax_dir / f"{name}.csv").read_bytes(), name
        assert ours.count(b"\n") > 1, name


@pytest.mark.parametrize("name", sorted(SHARDED))
def test_sharded_chips_match_one_process(ranks, single, name):
    """Conv delivery, host feeds cut by owner, delay rings, multitap
    cables, plugin compartments and per-neuron noise on the mesh: every
    trace byte-identical to one process of the port, counters equal to
    sanafe_tpu's where it draws the same run."""
    import sanafe_tpu as sf
    import sanafe_tpu.network as jax_network

    world, out, res = ranks
    base, singles = single
    assert_same_run(singles[name], res[name])
    assert res[name]["neurons_fired"] > 0
    if name == "conv":
        assert res["conv_route"]
    if name.startswith("neurofem"):
        assert res[f"{name}_n"] > 37  # padded
    builder, names, same_in_jax = SHARDED[name]
    for trace in names:
        assert (out / name / f"{trace}.csv").read_bytes() == (
            base / name / f"{trace}.csv").read_bytes(), trace
    if not same_in_jax:
        quiet = (base / "neurofem" / "potentials.csv").read_bytes()
        assert (out / name / "potentials.csv").read_bytes() != quiet
        return
    old = jax_network.BULK_EDGE_THRESHOLD
    jax_network.BULK_EDGE_THRESHOLD = 1
    try:
        theirs = _loaded(sf, builder).sim(CHIP_STEPS, heartbeat=0,
                                          chunk=CHUNK)
    finally:
        jax_network.BULK_EDGE_THRESHOLD = old
    assert_same_run(theirs, res[name], rel=1e-12)


def test_sim_sharded_resume_checkpoint_and_unshard(ranks, single):
    """Single -> sharded -> .npz round trip -> single gives the continuous
    raster; sanafe_tpu's sharded .npz resumes on the mesh; a
    torch.distributed.checkpoint directory written on the mesh resumes the
    same steps there and in one process."""
    _, out, res = ranks
    base, _ = single
    continuous = base / "continuous.csv"
    resumed = (out / "resume_r0.csv").read_bytes()
    assert resumed == continuous.read_bytes()
    assert resumed.count(b"\n") > 10
    want = _rows(continuous, SEGMENT + 1, 2 * SEGMENT)
    assert want
    assert res["jax_npz_t"] == SEGMENT
    assert _rows(out / "from_jax_r0.csv", 1, 10 ** 9) == want
    assert _rows(out / "dcp0_r0.csv", 1, 10 ** 9) == want
    assert _rows(out / "dcp1_r0.csv", 1, 10 ** 9) == want
    chip = _port(active_chip)
    chip.load_state(out / "state.dcp")
    assert chip.total_timesteps == SEGMENT
    result = chip.sim(SEGMENT, timing_model="detailed", heartbeat=0,
                      spike_trace=True)
    rows = [f"{a.group_name}.{a.neuron_offset},{SEGMENT + 1 + t}"
            for t, step in enumerate(result["spike_trace"].data)
            for a in step]
    assert rows == want


def test_mesh_sharded_sweep_matches_unsharded(ranks):
    """The sample axis split over the ranks equals one process's sweep and
    sanafe_tpu's (counters exact, floats within 1e-12); a sample count the
    mesh does not divide raises ValueError. A Hodgkin-Huxley current sweep
    splits alike."""
    import sanafe_tpu as sf
    from sanafe_tpu.batch import ParameterSweep as JaxSweep

    world, _, res = ranks
    chip = _port(batch_chip)
    over = st.expand_group_values(chip.compiled, "threshold",
                                  {"a": SWEEP_THRESHOLDS})
    base = st.ParameterSweep(chip, {"threshold": over}).run(30)
    jchip = _loaded(sf, batch_chip)
    theirs = JaxSweep(jchip, {"threshold": over}).run(30)
    for ref, rel in ((base, 0.0), (theirs, 1e-12)):
        for key in ("spikes", "neurons_fired", "neurons_updated",
                    "packets_sent"):
            np.testing.assert_array_equal(ref[key], res["sweep"][key])
        for key in ref["energy"]:
            np.testing.assert_allclose(res["sweep"]["energy"][key],
                                       ref["energy"][key], rtol=rel, atol=0)
        np.testing.assert_allclose(res["sweep"]["sim_time"],
                                   ref["sim_time"], rtol=rel, atol=0)
    assert len(set(res["sweep"]["spikes"].tolist())) > 1
    assert "must divide" in res["sweep_error"]
    assert f"({world} devices)" in res["sweep_error"]
    chip = _port(hh_chip)
    currents = st.expand_group_values(
        chip.compiled, "plugin_hodgkin_huxley_current", {"pop": HH_CURRENTS},
        base=chip.compiled.plugin_params["hodgkin_huxley"]["current"])
    hh = st.ParameterSweep(
        chip, {"plugin_hodgkin_huxley_current": currents}).run(20)
    for key in ("spikes", "neurons_fired", "packets_sent"):
        np.testing.assert_array_equal(hh[key], res["hh_sweep"][key])
    np.testing.assert_array_equal(hh["energy"]["total"],
                                  res["hh_sweep"]["energy"]["total"])
    np.testing.assert_array_equal(hh["sim_time"], res["hh_sweep"]["sim_time"])
