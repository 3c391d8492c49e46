"""Block-dense delivery of the port against sanafe_tpu's.

- ``DenseBlocks.build`` (sanafe_tpu_torch/ops/delivery.py, the plain
  route's layout) builds the same blocks as sanafe_tpu's
  ``build_block_delivery`` (ops/step.py:73), array for array, without the
  dense float64 host array: parallel edges summed in float64 in edge order,
  then cast; counts saturated at 127.
- ``delivery_plain`` (sanafe_tpu_torch/ops/delivery.py) equals sanafe_tpu's
  activity-gated Pallas kernel run in interpret mode
  (``make_delivery_fn(..., interpret=True)``) and its einsum + sorted
  segment-sum path, with the int8 count product, on seeded fired patterns
  that leave whole tiles silent: exactly on the chip's integer weights, and
  within rtol 1e-12 in float64 on seeded real-valued weights (the per-block
  products are summed by different matmul implementations).
- What the CUDA kernel reads instead of the int8 counts, the packed arrival
  plane (``pack_arrival_plane``), unpacked with numpy equals ``counts > 0``
  of sanafe_tpu's ``build_block_delivery``; ``delivery_packed_plain`` and
  the wrapper's path for CPU tensors (the same sum over the listed rows
  alone, ``compact_blocks``) equal ``delivery_plain``'s currents and
  ``cnt > 0``, and so does the layout's own ``deliver``. All exact: masks
  and integer weights.
- The ``cuda`` tests hold the CUDA kernel (given the listed rows of the
  blocks, ``compact_blocks``) to ``delivery_plain`` on the card
  (``python -m pytest tests/test_torch_delivery.py -m cuda --noconftest``),
  currents exact on integer weights and arrivals equal to ``cnt > 0``, and
  to ``delivery_live_plain`` bit for bit, on the random chip and on edge
  shapes (tiles under 256 and narrower than a warp's 128-column row, an
  empty destination tile, source tiles fired whole beside silent ones), in
  float32 and float64; they skip where there is no card.
  ``tests/test_torch_live_delivery.py`` holds the list's order.
"""

import numpy as np
import pytest
import torch

import sanafe_tpu_torch
from sanafe_tpu_torch.ops.delivery import (
    DenseBlocks,
    build_live_rows,
    compact_blocks,
    delivery_kernel,
    delivery_live_plain,
    delivery_packed_plain,
    delivery_plain,
    pack_arrival_plane,
    unpack_arrival_plane,
)

from test_torch_chips import _lif_arch, compile_both, random_chip

PATTERNS = ["none", "one_tile", "sparse", "all"]


def parallel_edges_chip(mod, n=12, seed=9):
    """Neurons joined by repeated (parallel) edges with seeded real
    weights, one pair by 130 of them, so cells sum several edges and the
    count saturates."""
    Attribute = mod.Attribute
    rng = np.random.default_rng(seed)
    arch = _lif_arch(mod, "accumulator")
    net = mod.SpikingNetwork("parallel")
    pop = net.create_neuron_group("pop", n, mod.NeuronConfiguration(
        model_attributes={"threshold": Attribute(1.0)}))
    pairs = [(int(s), int(d)) for s, d in rng.integers(0, n, (60, 2))]
    pairs += [(0, 1)] * 130
    weights = rng.uniform(-1.0, 1.0, len(pairs)).tolist()
    pop.connect_neurons_sparse(
        pop, {"weight": [Attribute(w) for w in weights]}, pairs)
    cores = arch.cores()
    for i, neuron in enumerate(pop):
        neuron.map_to_core(cores[i % len(cores)])
    return arch, net


BUILDS = {
    "example": lambda mod: mod.load_example(),
    "random1024": lambda mod: random_chip(mod, cores=16, neurons_per_core=64),
    "random2048": lambda mod: random_chip(mod, cores=16,
                                          neurons_per_core=128),
    "parallel": parallel_edges_chip,
}


def compile_named(name):
    import sanafe_tpu
    from sanafe_tpu.compile import compile_chip as compile_jax
    from sanafe_tpu_torch.compile import compile_chip as compile_port

    return (compile_jax(*BUILDS[name](sanafe_tpu)),
            compile_port(*BUILDS[name](sanafe_tpu_torch)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_block_build_matches_jax(name, dtype):
    from sanafe_tpu.ops.step import build_block_delivery as jax_build

    jax_compiled, port_compiled = compile_named(name)
    jb = jax_build(jax_compiled)
    pb = DenseBlocks.build(port_compiled, dtype, "cpu")
    assert (jb.tile, jb.n_tiles, jb.n_pad) == (pb.tile, pb.n_tiles, pb.n_pad)
    np.testing.assert_array_equal(np.asarray(jb.src_tiles), pb.src_tiles)
    np.testing.assert_array_equal(np.asarray(jb.dest_tiles), pb.dest_tiles)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    weights = np.asarray(jb.weights).astype(np_dtype)
    assert pb.weights.dtype == dtype
    np.testing.assert_array_equal(weights, pb.weights.numpy())
    assert pb.counts.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jb.counts), pb.counts.numpy())
    # the blocks of destination tile d are dest_offsets[d]:dest_offsets[d+1]
    dest = np.asarray(jb.dest_tiles)
    offsets = pb.dest_offsets.numpy()
    for d in range(pb.n_tiles):
        assert np.all(dest[offsets[d]:offsets[d + 1]] == d)
    assert offsets[-1] == len(dest)
    assert pb.max_blocks_per_dest == np.diff(offsets).max()
    if name == "parallel":
        assert np.asarray(jb.counts).max() == 127


def fired_pattern(n, tile, pattern, seed=0):
    rng = np.random.default_rng(seed)
    fired = np.zeros(n, dtype=bool)
    if pattern == "one_tile":
        fired[tile : 2 * tile] = rng.random(min(tile, n - tile)) < 0.5
    elif pattern == "sparse":
        fired = rng.random(n) < 0.05
        fired[: tile] = False  # a silent tile
        fired[2 * tile : 3 * tile] = False
    elif pattern == "all":
        fired[:] = True
    return fired


def jax_deliveries(block, x_tiles, weights):
    """sanafe_tpu's two delivery paths on the same inputs: the Pallas
    kernel (interpret mode) and the einsum + sorted segment sum, with the
    int8 count product (ops/step.py:1575-1608)."""
    import jax
    import jax.numpy as jnp

    from sanafe_tpu.ops.pallas_delivery import make_delivery_fn

    x = jnp.asarray(x_tiles)
    w = jnp.asarray(weights)
    pallas = np.asarray(
        make_delivery_fn(block, w.dtype, interpret=True)(x, w)
    )[: block.n_tiles]
    xs = x[block.src_tiles]
    y = jnp.einsum("bi,bij->bj", xs, w, preferred_element_type=w.dtype)
    einsum = jax.ops.segment_sum(y, block.dest_tiles,
                                 num_segments=block.n_tiles,
                                 indices_are_sorted=True)
    xi = xs.astype(jnp.int8)
    cnt = jax.lax.dot_general(
        xi, block.counts, dimension_numbers=(((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.int32,
    )
    counts = jax.ops.segment_sum(cnt, block.dest_tiles,
                                 num_segments=block.n_tiles,
                                 indices_are_sorted=True)
    return pallas, np.asarray(einsum), np.asarray(counts)


@pytest.mark.parametrize("weights_kind", ["chip", "real"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_delivery_plain_matches_jax(pattern, weights_kind):
    from sanafe_tpu.ops.step import build_block_delivery as jax_build

    jax_compiled, port_compiled = compile_both("random1024")
    jb = jax_build(jax_compiled)
    pb = DenseBlocks.build(port_compiled, torch.float64, "cpu")
    weights = np.asarray(jb.weights, dtype=np.float64)
    if weights_kind == "real":
        rng = np.random.default_rng(1)
        weights = rng.standard_normal(weights.shape)
    n = jax_compiled.n_neurons
    fired = fired_pattern(n, jb.tile, pattern)
    x = np.zeros(jb.n_pad)
    x[:n] = fired
    x_tiles = x.reshape(jb.n_tiles, jb.tile)

    pallas, einsum, counts = jax_deliveries(jb, x_tiles, weights)
    cur, cnt = delivery_plain(
        torch.from_numpy(x_tiles), torch.from_numpy(weights), pb.counts,
        pb.src_tiles, pb.dest_offsets, pb.max_blocks_per_dest,
    )
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), counts)
    if weights_kind == "chip":
        np.testing.assert_array_equal(cur.numpy(), pallas)
        np.testing.assert_array_equal(cur.numpy(), einsum)
    else:
        np.testing.assert_allclose(cur.numpy(), pallas, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(cur.numpy(), einsum, rtol=1e-12,
                                   atol=1e-12)
    silent = ~x_tiles.any(axis=1)
    if pattern != "all":
        assert silent.any()
    if pattern == "none":
        assert not cur.any() and not cnt.any()


@pytest.mark.parametrize("name", ["random1024", "random2048", "parallel"])
def test_arrival_plane_matches_jax_counts(name):
    """The packed plane the kernel reads, unpacked with numpy, equals
    ``counts > 0`` of sanafe_tpu's blocks (exact), 32 columns a word,
    little end first."""
    from sanafe_tpu.ops.step import build_block_delivery as jax_build

    jax_compiled, port_compiled = compile_named(name)
    jb = jax_build(jax_compiled)
    pb = DenseBlocks.build(port_compiled, torch.float32, "cpu")
    plane = pack_arrival_plane(pb.counts)
    words = -(-pb.tile // 32)
    assert plane.dtype == torch.int32
    assert tuple(plane.shape) == (pb.weights.shape[0], pb.tile, words)
    bits = np.unpackbits(
        np.ascontiguousarray(plane.numpy()).view(np.uint8), axis=-1,
        bitorder="little")[:, :, : pb.tile].astype(bool)
    np.testing.assert_array_equal(bits, np.asarray(jb.counts) > 0)
    assert torch.equal(unpack_arrival_plane(plane, pb.tile), pb.counts > 0)


def dense_args(pb, x):
    """``delivery_live_plain``'s arguments: the dense blocks, their packed
    plane and ``build_live_rows`` of them."""
    plane = pack_arrival_plane(pb.counts)
    return (x.view(pb.n_tiles, pb.tile), pb.weights, plane, pb.src_tiles,
            pb.dest_offsets, pb.max_blocks_per_dest,
            build_live_rows(pb.weights, plane))


def kernel_args(pb, x):
    """``delivery_kernel``'s arguments: the listed rows alone
    (``compact_blocks`` of ``dense_args``'s blocks)."""
    x, weights, plane, *meta, live = dense_args(pb, x)
    _, rows, words = compact_blocks(weights, plane, live)
    return (x, rows, words, *meta, live)


def plain_args(pb, x):
    return (x.view(pb.n_tiles, pb.tile), pb.weights, pb.counts,
            pb.src_tiles, pb.dest_offsets, pb.max_blocks_per_dest)


def test_delivery_kernel_takes_plain_for_cpu_tensors():
    """On CPU tensors the wrapper returns the plain version's result
    (delivery_live_plain's, equal to delivery_plain's currents and cnt > 0
    on the chip's integer weights) and launches nothing."""
    _, port_compiled = compile_both("random1024")
    pb = DenseBlocks.build(port_compiled, torch.float32, "cpu")
    n = port_compiled.n_neurons
    x = torch.zeros(pb.n_pad)
    x[:n] = torch.from_numpy(fired_pattern(n, pb.tile, "sparse"))
    before = delivery_kernel.launches
    a = delivery_kernel(*kernel_args(pb, x))
    b = delivery_plain(*plain_args(pb, x))
    c = delivery_packed_plain(*dense_args(pb, x)[:-1])
    d = delivery_live_plain(*dense_args(pb, x))
    e = pb.deliver(x.view(pb.n_tiles, pb.tile))
    assert delivery_kernel.launches == before
    assert a[1].dtype == torch.bool
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1] > 0)
    assert torch.equal(c[0], b[0]) and torch.equal(c[1], b[1] > 0)
    assert torch.equal(a[0], d[0]) and torch.equal(a[1], d[1])
    assert torch.equal(e[0], b[0]) and torch.equal(e[1], b[1] > 0)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hold_kernel_to_plain(pb, x):
    before = delivery_kernel.launches
    cur, arrived = delivery_kernel(*kernel_args(pb, x))
    torch.cuda.synchronize()
    assert delivery_kernel.launches == before + 1
    ref_cur, ref_cnt = delivery_plain(*plain_args(pb, x))
    assert cur.dtype == x.dtype and arrived.dtype == torch.bool
    assert torch.equal(cur, ref_cur)
    assert torch.equal(arrived, ref_cnt > 0)
    live_cur, live_arrived = delivery_live_plain(*dense_args(pb, x))
    assert torch.equal(cur.view(torch.uint8), live_cur.view(torch.uint8))
    assert torch.equal(arrived, live_arrived)
    return arrived


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_delivery_kernel_matches_plain(cuda, pattern, dtype):
    """The CUDA kernel against delivery_plain on the same card tensors:
    currents equal (integer weights) and arrivals equal to cnt > 0."""
    from sanafe_tpu_torch.compile import compile_chip

    compiled = compile_chip(*BUILDS["random1024"](sanafe_tpu_torch))
    pb = DenseBlocks.build(compiled, dtype, cuda)
    n = compiled.n_neurons
    x = torch.zeros(pb.n_pad, dtype=dtype, device=cuda)
    x[:n] = torch.from_numpy(fired_pattern(n, pb.tile, pattern)).to(cuda)
    hold_kernel_to_plain(pb, x)


def synthetic_blocks(tile, n_tiles, dtype, device, seed=5):
    """Seeded integer-weight blocks with tile ``tile``: about half of the
    (source, destination) pairs hold a block, destination tile 1 holds
    none, and a tenth of a block's cells hold an edge."""
    rng = np.random.default_rng(seed)
    pairs = [(d, s) for d in range(n_tiles) for s in range(n_tiles)
             if d != 1 and rng.random() < 0.5]
    dest = np.array([d for d, _ in pairs], dtype=np.int32)
    src = np.array([s for _, s in pairs], dtype=np.int32)
    counts = (rng.random((len(pairs), tile, tile)) < 0.1) * rng.integers(
        1, 4, (len(pairs), tile, tile))
    weights = counts * rng.integers(-8, 9, counts.shape)
    offsets = np.searchsorted(dest, np.arange(n_tiles + 1)).astype(np.int32)
    return DenseBlocks(
        tile=tile, n_tiles=n_tiles, n_pad=n_tiles * tile,
        src_tiles=torch.from_numpy(src).to(device),
        dest_tiles=torch.from_numpy(dest).to(device),
        weights=torch.from_numpy(weights).to(device=device, dtype=dtype),
        counts=torch.from_numpy(counts.astype(np.int8)).to(device),
        dest_offsets=torch.from_numpy(offsets).to(device),
        max_blocks_per_dest=int(np.diff(offsets).max()),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tile", [8, 20, 64, 128, 256])
def test_delivery_kernel_edge_shapes(cuda, tile, dtype):
    """Tiles under 256, narrower than a warp's 128-column row and (20) not
    a power of two; an empty destination tile; source tiles fired whole,
    in part and not at all, in one pattern."""
    n_tiles = 7
    pb = synthetic_blocks(tile, n_tiles, dtype, cuda)
    rng = np.random.default_rng(tile)
    fired = rng.random((n_tiles, tile)) < 0.3
    fired[0] = True
    fired[2] = False
    fired[3] = True
    fired[5] = False
    x = torch.from_numpy(fired).to(device=cuda, dtype=dtype).reshape(-1)
    arrived = hold_kernel_to_plain(pb, x)
    assert not arrived[1].any()  # no block reaches destination tile 1
    hold_kernel_to_plain(pb, torch.zeros_like(x))
    hold_kernel_to_plain(pb, torch.ones_like(x))


@pytest.mark.cuda
def test_delivery_kernel_rejects_bad_arguments(cuda):
    pb = synthetic_blocks(8, 3, torch.float32, cuda)
    x = torch.ones(pb.n_pad, device=cuda)
    args = list(kernel_args(pb, x))
    with pytest.raises(ValueError, match="arrivals"):
        delivery_kernel(args[0], args[1], pb.counts, *args[3:])
    with pytest.raises(ValueError, match="live_rows"):
        delivery_kernel(*args[:-1], None)
    odd = torch.ones((3, 6), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        delivery_kernel(odd, *args[1:])
