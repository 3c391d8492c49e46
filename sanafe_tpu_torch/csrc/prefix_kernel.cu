// Fixed-order prefix sum of the device sweep's neuron latencies (Hopper,
// sm_90a).
//
// The device sweep (sanafe_tpu_torch/ops/device_sweep.py) builds each step's
// message table from the running sum of the neuron latencies along the
// step's row: a message's generation delay is the difference of two entries.
// sanafe_tpu takes that sum with jnp.cumsum (sanafe_tpu/ops/device_sweep.py:
// 196); it has no Pallas kernel. A library scan (torch.cumsum on the card,
// CUB) adds in a tree order of its own, the CPU adds along the row, and the
// two float64 tables then differ in the last bits. This kernel adds in the
// one order that ops/device_sweep.py:prefix_sum_plain defines, so the
// card's float64 tables equal the CPU's bit for bit:
//
//   out[t, 0] = 0;  s = 0;
//   for k = 0 .. N-1:  s = s + x[t, k];  out[t, k + 1] = s
//
// each add rounded to nearest in float64. (Float32 tables keep the library
// scan: ops/device_sweep.py says why.)
//
// The order is serial along a row, so the parallelism is across rows: one
// thread a row. A CTA of kThreads threads owns kRows rows. All its threads
// copy a [kRows x kCols] tile of those rows into shared memory (thread i
// reads column i of every row: coalesced), then warp 0
// scans the tile (lane r walks row r in order, its running sum in a
// register) and writes the sums back in place, and all threads copy the tile
// out. The next tile's loads are issued into registers before the scan, so
// they are in flight while it runs. What bounds it: a row's chain of
// dependent float64 adds (N of them); the bytes (T x N read, T x (N + 1)
// written) take less.
// Build with -fmad=false (there is nothing to contract; the flag is the
// build's for every kernel).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 32;        // rows a CTA; warp 0 scans them
constexpr int kCols = kThreads;  // columns a tile; thread i holds column i

__global__ void __launch_bounds__(kThreads)
    prefix_kernel(const double* __restrict__ x, double* __restrict__ out,
                  int rows, int cols) {
  // +1: lanes walk rows with fewer bank conflicts
  __shared__ double tile[kRows][kCols + 1];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const size_t in_stride = static_cast<size_t>(cols);
  const size_t out_stride = in_stride + 1;
  double buf[kRows];

  auto load = [&](int c0) {
    const int c = c0 + tid;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = row0 + k;
      buf[k] = (r < rows && c < cols) ? x[r * in_stride + c] : 0.0;
    }
  };

  if (tid < kRows && row0 + tid < rows) {
    out[(row0 + tid) * out_stride] = 0.0;
  }
  double s = 0.0;  // lane r of warp 0: row r's running sum
  load(0);
  for (int c0 = 0; c0 < cols; c0 += kCols) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) tile[k][tid] = buf[k];
    __syncthreads();
    if (c0 + kCols < cols) load(c0 + kCols);
    if (tid < kRows) {
      const int n = min(kCols, cols - c0);
      if (n == kCols) {
#pragma unroll 16
        for (int c = 0; c < kCols; ++c) {
          s = s + tile[tid][c];
          tile[tid][c] = s;
        }
      } else {
        for (int c = 0; c < n; ++c) {
          s = s + tile[tid][c];
          tile[tid][c] = s;
        }
      }
    }
    __syncthreads();
    const int c = c0 + tid;
    if (c < cols) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = row0 + k;
        if (r < rows) out[r * out_stride + 1 + c] = tile[k][tid];
      }
    }
    // no barrier needed here: the next tile's store to tile[k][tid] is this
    // thread's own element, read just above in program order
  }
}

}  // namespace

extern "C" {

// Launch the prefix sum of the double `x` [rows, cols] into the double `out`
// [rows, cols + 1] on `stream` (no synchronisation). Returns the CUDA error
// code (0 = ok).
int sanafe_prefix_launch(const void* x, void* out, int rows, int cols,
                         int device, void* stream) {
  if (rows < 0 || cols < 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (rows == 0) return cudaSuccess;
  const int blocks = (rows + kRows - 1) / kRows;
  prefix_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), rows, cols);
  return cudaGetLastError();
}

const char* sanafe_prefix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
