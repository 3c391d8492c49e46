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
// What bounds it: a row is one chain of N dependent float64 adds, which no
// split or reassociation may shorten (both change the rounding), so rows
// are the only parallelism; the bytes (T x N read, T x (N + 1) written) are
// the other bound at large T. A warp issues in order, so any instruction of
// the chain's warp that waits (for a load, or for a store to read the
// register the next add overwrites) stalls the chain. The design keeps the
// chain fed and spreads the rows over the card:
//
// - A CTA owns R = ceil(rows / SMs) rows, at most kMaxRows, so DVS's 200
//   rows run on 100 SMs and the full chip's 1024 on all of them. It has
//   two warps, which hand the stages to each other through mbarriers, and
//   no block barrier in its loop.
// - The rows stream through a ring of kStages stages of kSeg doubles a row
//   in shared memory, filled by 1-D bulk copies (cp.async.bulk, the TMA's
//   tensor-map-free form), one a row a stage, completing on the stage's
//   `full` mbarrier.
// - Warp 0 scans: lane r adds row r in order, kBlock elements a block, the
//   block's inputs read with 16-byte shared loads a pair of blocks ahead.
//   It stores only the sum before each block, one store a block, and
//   arrives on the stage's `scanned` mbarrier.
// - Warp 1 re-adds each whole block from the sum before it, in the same
//   order (so every sum is bit for bit the scanner's), one lane a (row,
//   block), writing the sums in place; stores the stage with 16-byte
//   stores; and refills the slot with the stage kStages ahead (lane r
//   copies row r).
//
// Alignment. Bulk copies and 16-byte stores need 16-byte addresses. Input
// row t starts at element t * N and output row t at t * (N + 1), so either
// may start 8 bytes off. A row whose first input element is off is given a
// head element (read on its own), and one whose body would end on a lone
// element a tail element; the body between is a whole number of 16-byte
// pairs. Each slot row keeps two doubles before the body and four after it:
// the lane writes there the sums of the columns just before its segment
// (the previous stage's last sum, or column 0 and the head) and the tail's,
// so the store reads every column of the stage from one slot row. A column
// pair is stored as one 16-byte store when its output address is aligned,
// and each stage leaves at most one column (the pair's first half) for the
// next.
//
// The plain PyTorch version this kernel is held to bit for bit is
// ops/device_sweep.py:prefix_sum_plain. Build with -fmad=false (there is
// nothing to contract; the flag is the build's for every kernel).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "kernel_attrs.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kMaxRows = 2;   // rows a CTA (lanes that scan); with more,
                              // warp 1's re-adds fall behind the scan
constexpr int kStages = 4;    // ring depth
constexpr int kSeg = 256;     // body doubles a row a stage (2 KB)
constexpr int kPre = 2;       // slot doubles before the body
constexpr int kBlock = 16;    // elements a block of the scan
constexpr int kBlocks = kSeg / kBlock;
// the sums before each block of a slot row: kBlocks + 1, padded to 16 bytes
constexpr int kStartsStride = kBlocks + 2;
// slot row stride in doubles: kPre + kSeg + 4 after; 262 doubles = 2096 B
// puts rows 12 banks apart, so the lanes' 16-byte loads do not conflict
constexpr int kRowStride = kPre + kSeg + 4;
constexpr int kBarrierBytes = 2 * kStages * 8;  // two mbarriers a stage

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// One row's layout, the same for every lane that computes it.
struct RowPlan {
  long long in0;   // element index of x[row, 0] from x
  long long out0;  // element index of out[row, 0] from out
  int head;        // 1: x[row, 0] is read on its own (its address is off)
  int tail;        // 1: x[row, N - 1] is read on its own
  int body;        // N - head - tail, even
  int last;        // the row's last stage
  int parity;      // 1: out[row, 0] lies 8 bytes off a 16-byte boundary
};

__device__ __forceinline__ RowPlan plan_row(const double* x, const double* out,
                                            long long row, int cols) {
  RowPlan p;
  p.in0 = row * cols;
  p.out0 = row * (cols + 1LL);
  const long long in_elem = static_cast<long long>(
      reinterpret_cast<uintptr_t>(x) >> 3) + p.in0;
  const long long out_elem = static_cast<long long>(
      reinterpret_cast<uintptr_t>(out) >> 3) + p.out0;
  p.head = cols > 0 ? static_cast<int>(in_elem & 1) : 0;
  p.tail = (cols - p.head) & 1;
  p.body = cols - p.head - p.tail;
  const int stages = (p.body + kSeg - 1) / kSeg;
  p.last = stages > 0 ? stages - 1 : 0;
  p.parity = static_cast<int>(out_elem & 1);
  return p;
}

// Body doubles of stage j of a row (0 past the row's body).
__device__ __forceinline__ int stage_len(const RowPlan& p, int j) {
  return max(0, min(kSeg, p.body - j * kSeg));
}

// The first output column not yet stored after stage j: every column up to
// the row's end after its last stage, else the computed columns cut back to
// a 16-byte boundary of the output (so a pair is never split across two
// stages' stores). -1 gives 0.
__device__ __forceinline__ int stored_end(const RowPlan& p, int j, int cols) {
  if (j < 0) return 0;
  if (j >= p.last) return cols + 1;
  const int avail = p.head + (j + 1) * kSeg + 1;
  return avail - ((avail + p.parity) & 1);
}

__global__ void __launch_bounds__(2 * kWarp)
    prefix_kernel(const double* __restrict__ x, double* __restrict__ out,
                  int rows, int cols, int rows_per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // copies landed
  uint64_t* scanned = full + kStages;                   // sums written
  double* ring = reinterpret_cast<double*>(smem + kBarrierBytes);
  const int R = rows_per_cta;
  const int lane = threadIdx.x % kWarp;
  const bool scanner = threadIdx.x < kWarp;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int n_rows =
      static_cast<int>(rows - row0 < R ? rows - row0 : R);  // last CTA
  const bool has_row = lane < n_rows;
  const RowPlan mine = plan_row(x, out, row0 + (has_row ? lane : 0), cols);
  const int n_stages =
      __reduce_max_sync(0xffffffffu, has_row ? mine.last + 1 : 0);

  auto slot_row = [&](int j, int r) {
    return ring + (static_cast<size_t>(j % kStages) * R + r) * kRowStride;
  };
  double* starts_base = ring + static_cast<size_t>(kStages) * R * kRowStride;
  auto block_starts = [&](int j, int r) {
    return starts_base +
           (static_cast<size_t>(j % kStages) * R + r) * kStartsStride;
  };

  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&scanned[k], kWarp);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block barrier, before the loops

  if (scanner) {
    // warp 0: lane r adds row r's chain, in place in the slot
    double head = 0.0, tail = 0.0;
    if (has_row && mine.head) head = __ldg(x + mine.in0);
    if (has_row && mine.tail) tail = __ldg(x + mine.in0 + cols - 1);
    double s = 0.0;  // the row's running sum
    for (int j = 0; j < n_stages; ++j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      if (has_row && j <= mine.last) {
        double* rb = slot_row(j, lane);
        if (j == 0) {
          rb[0] = 0.0;  // column 0 when the head takes column 1
          if (mine.head) s = s + head;
        }
        rb[kPre - 1] = s;  // the column just before the segment
        double* seg = rb + kPre;
        const int len = stage_len(mine, j);
        // Whole blocks of kBlock elements, in pairs A and B, their inputs
        // loaded a pair of blocks ahead of the adds (the loads do not
        // depend on the running sum). Only the sum before each block goes
        // to shared memory: warp 1 re-adds each block from it, in the same
        // order, to write the block's sums. So the chain issues one store
        // a block, and no add waits for a store to read the register it
        // would overwrite.
        double* starts = block_starts(j, lane);
        double2 in_a[kBlock / 2], in_b[kBlock / 2];
        auto load = [&](double2* in, int at) {
#pragma unroll
          for (int m = 0; m < kBlock / 2; ++m)
            in[m] = reinterpret_cast<const double2*>(seg + at)[m];
        };
        auto add = [&](const double2* in) {
#pragma unroll
          for (int m = 0; m < kBlock / 2; ++m) {
            s = s + in[m].x;
            s = s + in[m].y;
          }
        };
        starts[0] = s;
        int i = 0, b = 0;
        if (len >= 2 * kBlock) {
          load(in_a, 0);
          load(in_b, kBlock);
        }
        for (; i + 2 * kBlock <= len; i += 2 * kBlock, b += 2) {
          const bool more = i + 4 * kBlock <= len;
          add(in_a);
          starts[b + 1] = s;
          if (more) load(in_a, i + 2 * kBlock);
          add(in_b);
          starts[b + 2] = s;
          if (more) load(in_b, i + 3 * kBlock);
        }
        if (i + kBlock <= len) {
          load(in_a, i);
          add(in_a);
          starts[b + 1] = s;
          i += kBlock;
        }
        // the rest of a short last segment: its sums in place
        for (; i < len; i += 2) {
          const double2 v = *reinterpret_cast<const double2*>(seg + i);
          s = s + v.x;
          seg[i] = s;
          s = s + v.y;
          seg[i + 1] = s;
        }
        if (j == mine.last && mine.tail) {
          s = s + tail;
          seg[len] = s;
        }
      }
      mbar_arrive(&scanned[j % kStages]);
    }
    return;
  }

  // warp 1: lane r copies row r's segments in; the warp stores the sums
  auto issue = [&](int j) {
    const int len = has_row ? stage_len(mine, j) : 0;
    const unsigned bytes = static_cast<unsigned>(len) * 8u;
    const unsigned total = __reduce_add_sync(0xffffffffu, bytes);
    if (lane == 0) mbar_expect_tx(&full[j % kStages], total);
    __syncwarp();
    if (len > 0) {
      bulk_copy(slot_row(j, lane) + kPre,
                x + mine.in0 + mine.head + static_cast<long long>(j) * kSeg,
                bytes, &full[j % kStages]);
    }
  };
  for (int j = 0; j < min(kStages, n_stages); ++j) issue(j);
  for (int j = 0; j < n_stages; ++j) {
    mbar_wait(&scanned[j % kStages], (j / kStages) & 1);
    // the sums of the stage's whole blocks, each re-added from the sum
    // before it in the scanner's order (so bit for bit the scanner's), one
    // lane a (row, block)
    for (int task = lane; task < n_rows * kBlocks; task += kWarp) {
      const int r = task / kBlocks;
      const int b = task % kBlocks;
      const RowPlan p = plan_row(x, out, row0 + r, cols);
      if (j > p.last || (b + 1) * kBlock > stage_len(p, j)) continue;
      double* seg = slot_row(j, r) + kPre + b * kBlock;
      double s = block_starts(j, r)[b];
      double2 in[kBlock / 2];
#pragma unroll
      for (int m = 0; m < kBlock / 2; ++m)
        in[m] = reinterpret_cast<const double2*>(seg)[m];
#pragma unroll
      for (int m = 0; m < kBlock / 2; ++m) {
        s = s + in[m].x;
        const double first = s;
        s = s + in[m].y;
        reinterpret_cast<double2*>(seg)[m] = make_double2(first, s);
      }
    }
    __syncwarp();
    for (int r = 0; r < n_rows; ++r) {
      const RowPlan p = plan_row(x, out, row0 + r, cols);
      if (j > p.last) continue;
      int c = stored_end(p, j - 1, cols);
      const int end = stored_end(p, j, cols);
      // column c of the row lies at slot index c - k0 + kPre - 1, where
      // k0 = head + j * kSeg is the stage's first body element
      const double* rb = slot_row(j, r) + kPre - 1 - (p.head + j * kSeg);
      double* o = out + p.out0;
      if (c < end && ((c + p.parity) & 1)) {
        if (lane == 0) o[c] = rb[c];
        ++c;
      }
      const int pairs = (end - c) >> 1;
      for (int q = lane; q < pairs; q += kWarp) {
        const int cc = c + 2 * q;
        *reinterpret_cast<double2*>(o + cc) = make_double2(rb[cc], rb[cc + 1]);
      }
      c += 2 * pairs;
      if (c < end && lane == 0) o[c] = rb[c];
    }
    __syncwarp();
    // refill the slot with stage j + kStages: order the generic-proxy
    // accesses of the slot before the bulk copy's writes
    if (j + kStages < n_stages) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(j + kStages);
    }
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
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  sms = std::max(sms, 1);
  const int per_cta = std::max(1, std::min(kMaxRows, (rows + sms - 1) / sms));
  const int blocks = (rows + per_cta - 1) / per_cta;
  const size_t smem = kBarrierBytes + static_cast<size_t>(kStages) * per_cta *
                                          (kRowStride + kStartsStride) *
                                          sizeof(double);
  err = sanafe::reserve_smem(reinterpret_cast<const void*>(&prefix_kernel),
                             smem);
  if (err != cudaSuccess) return err;
  prefix_kernel<<<blocks, 2 * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), rows, cols,
      per_cta);
  return cudaGetLastError();
}

const char* sanafe_prefix_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
