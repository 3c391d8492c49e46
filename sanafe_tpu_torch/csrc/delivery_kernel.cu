// Activity-gated block-dense spike delivery (Hopper, sm_90a).
//
// Replaces sanafe_tpu/ops/pallas_delivery.py:_delivery_kernel, the Pallas TPU
// kernel of the step scan's block delivery, together with the arrival test
// sanafe_tpu/ops/step.py:_block_deliver runs beside it. The Python side
// (sanafe_tpu_torch/ops/delivery.py) holds the plain PyTorch versions
// (delivery_plain, fired_rows_plain) this file is checked against.
//
// Per timestep, for each destination tile d:
//   cur[d]     = sum over blocks b of d whose source tile holds a fired neuron
//                of x[src_tile(b)] @ W[b]
//   arrived[d] = OR over the same blocks and their fired rows of the packed
//                arrival plane A[b] (bit j%32 of word j/32 of row i is set
//                where an edge joins row i to column j)
// where x is the 0/1 fired vector cut into [n_tiles, tile], and the blocks are
// sorted dest-major with dest_offsets[d]..dest_offsets[d+1] the blocks of d.
// Destination tiles no active block reaches are zero.
//
// Bound: device-memory bandwidth. The lhs is 0/1, so a block's product is the
// sum of its fired rows: no multiply, no tensor core, and the bytes read are
// the fired rows of the active blocks and nothing else (3.71 GB of float32
// weights and 0.12 GB of arrival bits for the 32k-neuron random chip when
// every neuron fires). The design is built around keeping that read stream
// full:
//
// 1. compact_kernel, one CTA per source tile, writes each tile's ascending
//    fired-row list and its length ONCE a step (warp ballots + a prefix over
//    the warp counts). The main loop has no ballot and no barrier.
// 2. delivery_kernel, one CTA of 8 warps per (destination tile, column
//    slice). A slice is 1, 2 or 4 chunks of 16 bytes a lane: the widest that
//    still gives 128 CTAs, so the 128 tiles of a 32k-neuron chip take whole
//    rows (1 KB) and a chip of few tiles is cut into more CTAs. The CTA's work
//    is the flattened list of (block, fired row) pairs of its tile, in sorted
//    block order and ascending row order; empty source lists drop out of it.
//    Warp g takes pairs g, g+8, g+16, ... A warp reads a row's slice at a time
//    with cp.async into a warp-private ring of kStages stages of R rows in
//    shared memory, and runs kStages-1 stages ahead of the adds ACROSS block
//    boundaries, so the memory pipe never drains inside a CTA. Each lane
//    consumes exactly the chunks it copied itself, so the ring needs no
//    barrier at all, only cp.async.wait_group. A stage holds up to R of the
//    warp's rows of ONE block: lanes 0..R-1 look the row indices up in one
//    load and hand them round by shuffle, so a stage costs one list lookup,
//    not R dependent ones; a stage's unused rows are zero-filled (src-size 0)
//    and add nothing. The (source tile, list length) of the CTA's blocks are
//    read into shared memory once, at the head of the kernel.
//    In flight per SM: 8 warps x 3 stages x 4 KB = 96 KB, against the about
//    20 KB an SM needs by Little's law (3.35 TB/s x ~0.8 us / 132 SMs).
// 3. The arrival test reads one bit where the step needs one bit: lanes
//    0..words-1 copy the row's packed words (32 bytes a 256-column row, not
//    256) into the same stage and OR them.
//
// Order of the sums: each warp adds its pairs in ascending flattened order
// into one accumulator per column, and the 8 warp partials are added in warp
// order. The order is fixed (no atomics), so the result repeats bit for bit;
// it equals the plain version exactly whenever the partial sums are exact
// (integer weights), and agrees to rounding otherwise.

#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"

namespace {

constexpr int kWarps = 8;     // warps per CTA of the main kernel
constexpr int kStages = 4;    // ring depth per warp (3 stages in flight)
constexpr int kMaxTile = 256;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory of a CTA
constexpr int kMinCtas = 128;  // cut rows into slices below this many CTAs
constexpr unsigned kFull = 0xffffffffu;

// --- phase 1: fired-row lists ------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kMaxTile)
compact_kernel(const T* __restrict__ x, uint8_t* __restrict__ rows,
               int* __restrict__ lens, int tile) {
  __shared__ int s_warp[kMaxTile / 32];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool fired = tid < tile && x[static_cast<size_t>(s) * tile + tid] != T(0);
  const unsigned ballot = __ballot_sync(kFull, fired);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int base = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kMaxTile / 32; ++k) {
    const int c = s_warp[k];
    base += k < warp ? c : 0;
    total += c;
  }
  if (fired) {
    rows[static_cast<size_t>(s) * tile + base +
         __popc(ballot & ((1u << lane) - 1u))] = static_cast<uint8_t>(tid);
  }
  if (tid == 0) lens[s] = total;
}

// --- phase 2: the sums -------------------------------------------------------

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A warp's place in its CTA's flattened (block, fired row) list.
struct Cursor {
  int b, b_end;  // current block, end of the tile's blocks
  int k, len;    // next row of the block's list this warp takes; list length
  int s;         // the block's source tile
};

// T: float or double. CPL: 16-byte chunks a lane copies per row, so a CTA's
// column slice is CPL * 512 bytes of each row; blockIdx.y is the slice. R:
// rows per stage.
template <typename T, int CPL, int R>
__global__ void __launch_bounds__(kWarps * 32)
delivery_kernel(const T* __restrict__ w, const uint32_t* __restrict__ arrive,
                const int* __restrict__ src_tiles,
                const int* __restrict__ dest_offsets,
                const uint8_t* __restrict__ rows, const int* __restrict__ lens,
                T* __restrict__ out_cur, uint8_t* __restrict__ out_arrived,
                int tile, int words, int blk_cap) {
  constexpr int kVec = 16 / sizeof(T);           // elements per chunk
  constexpr int kRowChunks = CPL * 32;           // ring row width in chunks
  constexpr int kStageChunks = R * kRowChunks;
  constexpr int kStageWords = R * (kMaxTile / 32);
  extern __shared__ uint4 smem[];
  // per warp: kStages stages of weights, then kStages stages of words
  uint4* ring = smem + static_cast<size_t>(threadIdx.y) * kStages * kStageChunks;
  uint32_t* ring_bits =
      reinterpret_cast<uint32_t*>(smem + kWarps * kStages * kStageChunks) +
      static_cast<size_t>(threadIdx.y) * kStages * kStageWords;

  const int d = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  // this CTA's slice of a weight row, in 16-byte chunks, and of a row of
  // arrival words
  const int chunk0 = blockIdx.y * kRowChunks;
  const int row_chunks = min(kRowChunks, tile / kVec - chunk0);
  const int col0 = chunk0 * kVec;
  const int word0 = col0 / 32;
  words = min(words - word0, kRowChunks * kVec / 32);
  const int row_words = (tile + 31) / 32;

  // the blocks of this tile: source tile and fired-row count of each
  const int b_begin = dest_offsets[d];
  int* s_blk_src = reinterpret_cast<int*>(
      reinterpret_cast<uint32_t*>(smem + kWarps * kStages * kStageChunks) +
      kWarps * kStages * kStageWords);
  int* s_blk_len = s_blk_src + blk_cap;
  if (dest_offsets[d + 1] - b_begin > blk_cap) __trap();  // caller's bound
  for (int i = g * 32 + lane; i < dest_offsets[d + 1] - b_begin;
       i += kWarps * 32) {
    const int s = src_tiles[b_begin + i];
    s_blk_src[i] = s;
    s_blk_len[i] = lens[s];
  }
  __syncthreads();

  Cursor cur;
  cur.b = b_begin;
  cur.b_end = dest_offsets[d + 1];
  cur.k = g;
  cur.len = 0;
  cur.s = 0;
  if (cur.b < cur.b_end) {
    cur.s = s_blk_src[0];
    cur.len = s_blk_len[0];
  }

  // Copy up to R of the warp's next rows (of one block) into ring stage
  // `slot`; returns 1 if the stage holds a row. Always commits one group, so
  // the group count is the same whether or not rows are left.
  auto fill_stage = [&](int slot) -> int {
    while (cur.b < cur.b_end && cur.k >= cur.len) {
      cur.k -= cur.len;
      if (++cur.b < cur.b_end) {
        cur.s = s_blk_src[cur.b - b_begin];
        cur.len = s_blk_len[cur.b - b_begin];
      }
    }
    if (cur.b >= cur.b_end) {
      cp_async_commit();  // nothing left: an empty group
      return 0;
    }
    // lane r < R looks up the r-th of the warp's next rows in this block
    const int mine = cur.k + kWarps * lane;
    const int looked = lane < R && mine < cur.len
        ? rows[static_cast<size_t>(cur.s) * tile + mine] : 0;
    const int n_rows = min(R, (cur.len - cur.k + kWarps - 1) / kWarps);
    cur.k += kWarps * n_rows;
    uint4* stage = ring + slot * kStageChunks;
    uint32_t* bits = ring_bits + slot * kStageWords;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = r < n_rows;
      const size_t row = static_cast<size_t>(cur.b) * tile +
                         __shfl_sync(kFull, looked, r);
      const uint4* src =
          reinterpret_cast<const uint4*>(w + row * tile + col0);
      const int n16 = valid ? 16 : 0;  // 0: zero-fill, nothing is read
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = lane + 32 * c;
        if (chunk < row_chunks) {
          cp_async_16(stage + r * kRowChunks + chunk, src + chunk, n16);
        }
      }
      if (lane < words) {
        cp_async_4(bits + r * (kMaxTile / 32) + lane,
                   arrive + row * row_words + word0 + lane, valid ? 4 : 0);
      }
    }
    cp_async_commit();
    return 1;
  };

  T acc[CPL][kVec];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[c][e] = T(0);
  }
  uint32_t seen = 0;  // lane < words: OR of the arrival words of its rows

  int n_live = 0;
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) n_live += fill_stage(p);
  for (int i = 0; i < n_live; ++i) {
    cp_async_wait<kStages - 2>();  // this lane's copies of stage i landed
    const int slot = i % kStages;
    const uint4* stage = ring + slot * kStageChunks;
    const uint32_t* bits = ring_bits + slot * kStageWords;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int chunk = lane + 32 * c;
        if (chunk < row_chunks) {
          const uint4 raw = stage[r * kRowChunks + chunk];
          const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[c][e] = acc[c][e] + v[e];
        }
      }
      if (lane < words) seen |= bits[r * (kMaxTile / 32) + lane];
    }
    // refill the slot consumed one iteration ago
    n_live += fill_stage((i + kStages - 1) % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it

  // --- add the warp partials in warp order ---
  T* part = reinterpret_cast<T*>(smem);  // [kWarps][slice columns]
  uint32_t* part_bits = reinterpret_cast<uint32_t*>(part + kWarps * kMaxTile);
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int chunk = lane + 32 * c;
    if (chunk < row_chunks) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        part[g * (kRowChunks * kVec) + chunk * kVec + e] = acc[c][e];
      }
    }
  }
  if (lane < words) part_bits[g * (kMaxTile / 32) + lane] = seen;
  __syncthreads();
  const int tid = g * 32 + lane;
  if (tid < row_chunks * kVec) {
    T sum = part[tid];
    // a slice narrower than a word (tile 8 or 16) starts at bit 0 of word 0
    uint32_t any = part_bits[tid >> 5];
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      sum = sum + part[k * (kRowChunks * kVec) + tid];
      any |= part_bits[k * (kMaxTile / 32) + (tid >> 5)];
    }
    out_cur[static_cast<size_t>(d) * tile + col0 + tid] = sum;
    out_arrived[static_cast<size_t>(d) * tile + col0 + tid] =
        (any >> (tid & 31)) & 1u;
  }
}

template <typename T, int CPL, int R>
cudaError_t launch_main(const void* w, const void* arrive, const void* src_tiles,
                        const void* dest_offsets, const void* rows,
                        const void* lens, void* out_cur, void* out_arrived,
                        int n_tiles, int tile, int words, int blk_cap,
                        cudaStream_t stream) {
  // the rings, then the (source tile, length) of at most blk_cap blocks
  const size_t ring = static_cast<size_t>(kWarps) * kStages *
                          (R * CPL * 32 * 16 + R * (kMaxTile / 32) * 4) +
                      2 * sizeof(int) * static_cast<size_t>(blk_cap);
  if (ring > kMaxSmem) return cudaErrorInvalidValue;
  const size_t tail = static_cast<size_t>(kWarps) * kMaxTile * sizeof(T) +
                      kWarps * (kMaxTile / 32) * 4;
  const size_t smem = ring > tail ? ring : tail;
  const cudaError_t err = sanafe::reserve_smem(
      reinterpret_cast<const void*>(&delivery_kernel<T, CPL, R>), smem);
  if (err != cudaSuccess) return err;
  const int slice = CPL * 32 * (16 / static_cast<int>(sizeof(T)));  // columns
  const dim3 grid(n_tiles, (tile + slice - 1) / slice);
  delivery_kernel<T, CPL, R><<<grid, dim3(32, kWarps), smem, stream>>>(
      static_cast<const T*>(w), static_cast<const uint32_t*>(arrive),
      static_cast<const int*>(src_tiles), static_cast<const int*>(dest_offsets),
      static_cast<const uint8_t*>(rows), static_cast<const int*>(lens),
      static_cast<T*>(out_cur), static_cast<uint8_t*>(out_arrived), tile, words,
      blk_cap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* arrive,
                   const void* src_tiles, const void* dest_offsets, void* rows,
                   void* lens, void* out_cur, void* out_arrived, int n_tiles,
                   int tile, int blk_cap, cudaStream_t stream) {
  compact_kernel<T><<<n_tiles, kMaxTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(rows),
      static_cast<int*>(lens), tile);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int words = (tile + 31) / 32;
  const int row_bytes = tile * static_cast<int>(sizeof(T));
  // the widest slice (fewest CTAs a tile) that still gives kMinCtas CTAs
  const auto enough = [&](int slice_bytes) {
    return n_tiles * ((row_bytes + slice_bytes - 1) / slice_bytes) >= kMinCtas;
  };
#define SANAFE_MAIN(CPL, R)                                                   \
  launch_main<T, CPL, R>(w, arrive, src_tiles, dest_offsets, rows, lens,      \
                         out_cur, out_arrived, n_tiles, tile, words, blk_cap,   \
                         stream)
  if (row_bytes <= 512 || !enough(1024)) return SANAFE_MAIN(1, 4);
  if (row_bytes <= 1024 || !enough(2048)) return SANAFE_MAIN(2, 4);
  return SANAFE_MAIN(4, 2);
#undef SANAFE_MAIN
}

}  // namespace

extern "C" {

// One delivery on `stream`, float (is_double = 0) or double: the compaction
// kernel, then the main kernel. `rows` ([n_tiles, tile] bytes) and `lens`
// ([n_tiles] int32) are scratch the caller allocates. `tile` must be a
// multiple of 4 (rows are read 16 bytes at a time); `blk_cap` is the largest
// number of blocks of one destination tile. Returns the CUDA error (0 on
// success).
int sanafe_delivery_launch(const void* x, const void* weights,
                           const void* arrive, const void* src_tiles,
                           const void* dest_offsets, void* rows, void* lens,
                           void* out_cur, void* out_arrived, int n_tiles,
                           int tile, int blk_cap, int is_double, int device,
                           void* stream) {
  if (n_tiles <= 0 || tile <= 0 || tile > kMaxTile || tile % 4 != 0 ||
      blk_cap < 0 || device < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(x, weights, arrive, src_tiles, dest_offsets, rows,
                          lens, out_cur, out_arrived, n_tiles, tile, blk_cap, s);
  }
  return launch<float>(x, weights, arrive, src_tiles, dest_offsets, rows, lens,
                       out_cur, out_arrived, n_tiles, tile, blk_cap, s);
}

const char* sanafe_delivery_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
