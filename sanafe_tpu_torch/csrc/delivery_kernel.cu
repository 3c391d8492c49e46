// Activity-gated block-dense spike delivery (Hopper, sm_90a).
//
// Replaces sanafe_tpu/ops/pallas_delivery.py:_delivery_kernel, the Pallas TPU
// kernel of the step scan's block delivery, together with the int8 count
// product sanafe_tpu/ops/step.py:_block_deliver runs beside it. The Python
// side (sanafe_tpu_torch/ops/delivery.py) holds the plain PyTorch version
// (delivery_plain) this kernel is checked against.
//
// Per timestep, for each destination tile d:
//   cur[d] = sum over blocks b of d whose source tile holds a fired neuron of
//            x[src_tile(b)] @ W[b]
//   cnt[d] = the same sum over the int8 edge-count blocks, in int32
// where x is the 0/1 fired vector cut into [n_tiles, tile], and the blocks are
// sorted dest-major with dest_offsets[d]..dest_offsets[d+1] the blocks of d.
// Destination tiles no active block reaches are zero.
//
// Design. The lhs is 0/1, so a block's product is the sum of its rows i with
// x[i] = 1: no multiply and no tensor core is needed, and the bytes read are
// the fired rows of the active blocks and nothing else. One CTA of 8 warps
// owns one (destination tile, 32-column slice). It walks its tile's blocks in
// sorted order; for each block it compacts the source tile's fired rows into
// shared memory (warp ballots + a prefix over the 8 warp counts) and skips the
// block when there are none, so an inactive weight block is never read. Warp
// g sums rows g, g+8, g+16, ... of that list; lane c reads column c, so each
// row read is 32 consecutive values (coalesced). After the last block the 8
// warp partials are added in warp order. The order of every sum is fixed, so
// the result is the same from run to run, with no atomics; it equals the
// plain version exactly whenever the partial sums are exact (integer
// weights), and agrees to rounding otherwise.
//
// Bound: device-memory bandwidth. A step reads (fired rows) x (tile) weights
// and counts per active block: at most 4.6 GB for the 32k-neuron random chip
// (14,166 blocks of 256x256) when every neuron fires. TMA, clusters and
// tuning are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 32;                 // columns per CTA (one warp wide)
constexpr int kGroups = 8;                // warps per CTA, each a row group
constexpr int kThreads = kCols * kGroups; // also the largest tile
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
delivery_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const int8_t* __restrict__ cnt, const int* __restrict__ src_tiles,
                const int* __restrict__ dest_offsets, T* __restrict__ out_cur,
                int* __restrict__ out_cnt, int tile) {
  __shared__ int s_rows[kThreads];  // fired rows of the block's source tile
  __shared__ int s_warp[kGroups];   // fired-row count of each warp's lanes
  __shared__ T s_cur[kGroups][kCols];
  __shared__ int s_cnt[kGroups][kCols];

  const int d = blockIdx.x;
  const int lane = threadIdx.x;
  const int g = threadIdx.y;
  const int tid = g * kCols + lane;
  const int col = blockIdx.y * kCols + lane;
  const bool own_col = col < tile;
  const size_t block_elems = static_cast<size_t>(tile) * tile;

  T acc = T(0);
  int acc_n = 0;
  const int b_end = dest_offsets[d + 1];
  for (int b = dest_offsets[d]; b < b_end; ++b) {
    // --- compact the source tile's fired rows, in ascending order ---
    const int s = src_tiles[b];
    const bool fired = tid < tile && x[static_cast<size_t>(s) * tile + tid] != T(0);
    const unsigned ballot = __ballot_sync(kFull, fired);
    if (lane == 0) s_warp[g] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int c = s_warp[k];
      base += k < g ? c : 0;
      total += c;
    }
    if (fired) s_rows[base + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();

    // --- sum this warp's share of the fired rows (none: block skipped) ---
    if (total > 0 && own_col) {
      const T* wb = w + static_cast<size_t>(b) * block_elems + col;
      const int8_t* cb = cnt + static_cast<size_t>(b) * block_elems + col;
      int k = g;
      for (; k + 3 * kGroups < total; k += 4 * kGroups) {
        const size_t r0 = static_cast<size_t>(s_rows[k]) * tile;
        const size_t r1 = static_cast<size_t>(s_rows[k + kGroups]) * tile;
        const size_t r2 = static_cast<size_t>(s_rows[k + 2 * kGroups]) * tile;
        const size_t r3 = static_cast<size_t>(s_rows[k + 3 * kGroups]) * tile;
        const T x0 = __ldg(wb + r0), x1 = __ldg(wb + r1);
        const T x2 = __ldg(wb + r2), x3 = __ldg(wb + r3);
        const int n0 = __ldg(cb + r0), n1 = __ldg(cb + r1);
        const int n2 = __ldg(cb + r2), n3 = __ldg(cb + r3);
        acc = acc + x0;
        acc = acc + x1;
        acc = acc + x2;
        acc = acc + x3;
        acc_n += n0 + n1 + n2 + n3;
      }
      for (; k < total; k += kGroups) {
        const size_t r = static_cast<size_t>(s_rows[k]) * tile;
        acc = acc + __ldg(wb + r);
        acc_n += __ldg(cb + r);
      }
    }
    __syncthreads();  // s_rows and s_warp are rewritten for the next block
  }

  // --- add the warp partials in warp order ---
  s_cur[g][lane] = acc;
  s_cnt[g][lane] = acc_n;
  __syncthreads();
  if (g == 0 && own_col) {
    T sum = s_cur[0][lane];
    int n = s_cnt[0][lane];
#pragma unroll
    for (int k = 1; k < kGroups; ++k) {
      sum = sum + s_cur[k][lane];
      n += s_cnt[k][lane];
    }
    out_cur[static_cast<size_t>(d) * tile + col] = sum;
    out_cnt[static_cast<size_t>(d) * tile + col] = n;
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* cnt, const void* src_tiles,
           const void* dest_offsets, void* out_cur, void* out_cnt, int n_tiles,
           int tile, cudaStream_t stream) {
  const dim3 grid(n_tiles, (tile + kCols - 1) / kCols);
  const dim3 block(kCols, kGroups);
  delivery_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int8_t*>(cnt), static_cast<const int*>(src_tiles),
      static_cast<const int*>(dest_offsets), static_cast<T*>(out_cur),
      static_cast<int*>(out_cnt), tile);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one delivery on `stream` in float (is_double = 0) or double;
// returns cudaGetLastError() (0 on success).
int sanafe_delivery_launch(const void* x, const void* weights,
                           const void* counts, const void* src_tiles,
                           const void* dest_offsets, void* out_cur,
                           void* out_cnt, int n_tiles, int tile, int is_double,
                           int device, void* stream) {
  if (n_tiles <= 0 || tile <= 0 || tile > kThreads) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(x, weights, counts, src_tiles, dest_offsets, out_cur,
                          out_cnt, n_tiles, tile, s);
  }
  return launch<float>(x, weights, counts, src_tiles, dest_offsets, out_cur,
                       out_cnt, n_tiles, tile, s);
}

const char* sanafe_delivery_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
