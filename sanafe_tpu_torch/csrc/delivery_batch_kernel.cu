// Sample-batched activity-gated block-dense spike delivery (Hopper, sm_90a).
//
// Replaces sanafe_tpu/ops/pallas_delivery.py:_delivery_kernel as
// sanafe_tpu/batch.py runs it: jax.vmap of the step batches that Pallas call
// over the B parameter samples of a ParameterSweep. The Python side
// (sanafe_tpu_torch/ops/delivery.py: delivery_batch_kernel) holds the plain
// PyTorch version (delivery_batch_plain) this file is checked against.
//
// Per timestep, for each sample b and destination tile d:
//   cur[b, d]     = sum over blocks k of d, over the rows i of k's source tile
//                   that fired in sample b, of W[k][i]
//   arrived[b, d] = OR over the same rows of the packed arrival plane A[k][i]
// with the blocks sorted dest-major (dest_offsets[d]..dest_offsets[d+1]).
// W and A are shared by every sample, or (a sweep that overrides the block
// weights or edge counts) one set a sample, w_stride / a_stride elements
// apart.
//
// Bound: device-memory bandwidth while B is small. A sweep's samples share
// the connectivity, so a weight row fired in any sample is read from HBM
// ONCE a step and added into every sample that fired it: the bytes stay
// those of one delivery (3.71 GB of float32 weights and 0.12 GB of arrival
// bits for the 32k-neuron random chip when every neuron fires) and the adds
// grow with B (one float add a cell a sample: 0.93 G adds a sample on that
// chip; at 3.35 TB/s and 33.5 T float adds/s that is 1.14 ms of bytes
// against 0.028 ms of adds a sample, so the bytes bound up to about 40
// samples). The design:
//
// 1. compact_kernel, one CTA per source tile: each row's B-bit sample mask
//    (mask_words 32-bit words a row) and the ascending list of the rows
//    fired in ANY sample, with its length, once a step.
// 2. batch_kernel, one CTA of 256 threads per (destination tile, column
//    slice, sample pass); slices are cut narrow enough to give about two
//    CTAs an SM. A thread owns one 16-byte chunk of the slice's columns
//    (c = tid % C) and S samples (group g = tid / C of G = 256 / C): S * 16
//    bytes of accumulators. The CTA walks the flattened list of (block,
//    listed row) pairs of its tile in order, kRows rows a stage, through a
//    ring of kStages stages in shared memory filled by cp.async kStages-1
//    stages ahead, one barrier a stage. The last warp finds a stage's rows
//    one stage before its copies start (the row lists of every source
//    tile, a byte a neuron, sit in shared memory, so that costs no global
//    load), and every thread then starts its copies with shifts and masks
//    only. A stage row carries the weight slice, the row's arrival words of
//    the slice and its sample mask. Each listed row is read from HBM once;
//    every thread adds its chunk into the accumulators of those of its
//    samples whose mask bit is set, and skips (never adds a zero for) the
//    others; a row all of the thread's samples fired takes a branch with
//    no per-sample test. Past G * 32 samples the CTA makes more passes
//    (blockIdx.z), each reading the weights again. With per-sample weights
//    a pass is one sample, and rows that sample did not fire are not read.
//
// Order of the sums: one accumulator per (sample, column), +0.0 at the
// start, adding that sample's fired rows in ascending order within a block
// and its blocks in ascending order: fixed, so the result repeats bit for
// bit, and equal to delivery_kernel and to the plain version wherever the
// partial sums are exact (integer weights).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads of a main-kernel CTA
constexpr int kStages = 4;     // ring depth (3 stages in flight)
constexpr int kMaxTile = 256;
constexpr int kRows = 32;      // rows a stage
constexpr int kBatchRows = 4;  // rows whose loads a thread starts together
constexpr int kMaxS = 32;      // samples a thread
constexpr long long kMaxSmem = 227 * 1024;
constexpr int kMinCtas = 256;  // cut rows into slices below this many CTAs
constexpr unsigned kFull = 0xffffffffu;

// --- phase 1: sample masks and the rows fired in any sample -----------------

template <typename T>
__global__ void __launch_bounds__(kMaxTile)
compact_kernel(const T* __restrict__ x, uint8_t* __restrict__ rows,
               int* __restrict__ lens, uint32_t* __restrict__ masks,
               int batch, int n_tiles, int tile, int mask_words) {
  __shared__ int s_warp[kMaxTile / 32];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  bool fired = false;
  if (tid < tile) {
    for (int q = 0; q < mask_words; ++q) {
      uint32_t m = 0;
      const int hi = min(32, batch - 32 * q);
      for (int k = 0; k < hi; ++k) {
        const size_t b = static_cast<size_t>(32 * q + k);
        if (x[(b * n_tiles + s) * tile + tid] != T(0)) m |= 1u << k;
      }
      masks[(static_cast<size_t>(s) * tile + tid) * mask_words + q] = m;
      fired |= m != 0u;
    }
  }
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

// How one launch cuts the work (host and device agree through this).
struct Plan {
  int vec;            // elements a 16-byte chunk
  int chunks;         // C: chunks a CTA's column slice (a power of two)
  int log_chunks;
  int slices;         // column slices a row (gridDim.y)
  int groups;         // G: sample groups a CTA
  int samples;        // S: samples a thread
  int passes;         // gridDim.z
  int arr_words;      // arrival words a stage row (a power of two)
  int log_arr_words;
  int mask_words;     // sample-mask words a row
  long long smem;     // dynamic shared memory bytes; -1 if over the limit
};

int log2_of(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

Plan plan_for(int chunks, int batch, int n_tiles, int tile, int blk_cap,
               int is_double, int per_sample) {
  Plan p;
  p.vec = is_double ? 2 : 4;
  p.chunks = chunks;
  const int row_chunks = tile / p.vec;
  p.log_chunks = log2_of(p.chunks);
  p.slices = row_chunks / p.chunks;
  p.groups = kThreads / p.chunks;
  if (per_sample) {
    p.samples = 1;
    p.passes = batch;
  } else {
    const int need = (batch + p.groups - 1) / p.groups;
    p.samples = 1;
    while (p.samples < need && p.samples < kMaxS) p.samples *= 2;
    p.passes = (batch + p.groups * p.samples - 1) / (p.groups * p.samples);
  }
  p.arr_words = (p.chunks * p.vec + 31) / 32;
  p.log_arr_words = log2_of(p.arr_words);
  p.mask_words = (batch + 31) / 32;
  const long long n_pad = static_cast<long long>(n_tiles) * tile;
  p.smem = static_cast<long long>(kStages) * kRows *
               (16LL * p.chunks + 4LL * p.arr_words + 4LL * p.mask_words) +
           4LL * 4 * kRows + 4LL * (2LL * blk_cap + 1) +
           (per_sample ? 4LL * ((n_pad + 31) / 32) : 0LL) + n_pad;
  return p;
}

Plan make_plan(int batch, int n_tiles, int tile, int blk_cap, int is_double,
               int per_sample) {
  const int row_chunks = tile / (is_double ? 2 : 4);
  // slices of at least 32 columns (whole arrival words), as narrow as it
  // takes to give kMinCtas CTAs and to fit a CTA's shared memory
  const int min_chunks = row_chunks < 32 / (is_double ? 2 : 4)
                             ? row_chunks : 32 / (is_double ? 2 : 4);
  int chunks = row_chunks;
  while (chunks > min_chunks && n_tiles * (row_chunks / chunks) < kMinCtas)
    chunks /= 2;
  Plan p = plan_for(chunks, batch, n_tiles, tile, blk_cap, is_double,
                    per_sample);
  while (p.smem > kMaxSmem && p.chunks > min_chunks) {
    p = plan_for(p.chunks / 2, batch, n_tiles, tile, blk_cap, is_double,
                 per_sample);
  }
  if (p.smem > kMaxSmem) p.smem = -1;
  return p;
}

// T: float or double. S: samples a thread (1, 2, 4, ..., 32).
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
batch_kernel(const T* __restrict__ w, const uint32_t* __restrict__ arrive,
             long long w_stride, long long a_stride,
             const int* __restrict__ src_tiles,
             const int* __restrict__ dest_offsets,
             const uint8_t* __restrict__ rows, const int* __restrict__ lens,
             const uint32_t* __restrict__ masks, T* __restrict__ out_cur,
             uint8_t* __restrict__ out_arrived, int batch, int n_tiles,
             int tile, int blk_cap, Plan p, int per_sample) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr uint32_t kAll = S < 32 ? (1u << (S % 32)) - 1u : 0xffffffffu;
  const int C = p.chunks, LC = p.log_chunks;
  const int AW = p.arr_words, LAW = p.log_arr_words, MW = p.mask_words;
  const int n_pad = n_tiles * tile;
  extern __shared__ uint4 smem[];
  uint4* ring = smem;  // [kStages][kRows][C] weight chunks
  uint32_t* ring_arr = reinterpret_cast<uint32_t*>(
      ring + static_cast<size_t>(kStages) * kRows * C);
  uint32_t* ring_msk = ring_arr + kStages * kRows * AW;  // [..][kRows][MW]
  // two stages' row descriptors: [2][weight row (-1: none) | neuron row]
  int* s_desc = reinterpret_cast<int*>(ring_msk + kStages * kRows * MW);
  int* s_src = s_desc + 4 * kRows;
  int* s_pre = s_src + blk_cap;  // [blk_cap + 1] pair offsets of the blocks
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(s_pre + blk_cap + 1);
  uint8_t* s_list = reinterpret_cast<uint8_t*>(
      s_bits + (per_sample ? (n_pad + 31) / 32 : 0));  // [n_pad]

  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int c = tid & (C - 1);
  const int g = tid >> LC;
  const int col0 = blockIdx.y * C * kVec;  // the slice's first column
  const int word0 = col0 / 32;
  const int row_words = (tile + 31) / 32;
  const int z = blockIdx.z;
  int s_first, s_count;
  if (per_sample) {
    s_first = z;
    s_count = g == 0 ? 1 : 0;
  } else {
    s_first = (z * p.groups + g) * S;
    s_count = min(S, max(0, batch - s_first));
  }
  // strides are 0 for shared weights and arrivals
  w += static_cast<long long>(z) * w_stride;
  arrive += static_cast<long long>(z) * a_stride;

  // --- the tile's blocks, the row lists, a pass's own fired bits ---
  const int b_begin = dest_offsets[d];
  const int nb = dest_offsets[d + 1] - b_begin;
  if (nb > blk_cap) __trap();  // caller's bound
  for (int i = tid; i < nb; i += kThreads) {
    const int s = src_tiles[b_begin + i];
    s_src[i] = s;
    s_pre[i + 1] = lens[s];
  }
  for (int i = tid; i < n_pad / 4; i += kThreads) {
    reinterpret_cast<uint32_t*>(s_list)[i] =
        reinterpret_cast<const uint32_t*>(rows)[i];
  }
  if (per_sample) {
    for (int i = tid; i < (n_pad + 31) / 32; i += kThreads) {
      uint32_t word = 0;
      for (int k = 0; k < 32 && i * 32 + k < n_pad; ++k) {
        const size_t row = static_cast<size_t>(i) * 32 + k;
        word |= ((masks[row * MW + (z >> 5)] >> (z & 31)) & 1u) << k;
      }
      s_bits[i] = word;
    }
  }
  __syncthreads();
  if (tid == 0) {
    s_pre[0] = 0;
    for (int i = 0; i < nb; ++i) s_pre[i + 1] += s_pre[i];
  }
  __syncthreads();
  const int n_pairs = s_pre[nb];
  const int n_stages = (n_pairs + kRows - 1) / kRows;

  // The last warp writes the rows of stage j into descriptor slot j & 1:
  // lane r finds pair j * kRows + r of the tile's flattened (block, listed
  // row) list from the block holding the stage's first pair. (The first
  // sample group, which does the adds when there are few samples, is
  // warp 0.)
  int cb = 0;
  const int lane = tid - (kThreads - 32);
  auto describe = [&](int j) {
    if (lane < 0) return;
    const int p0 = j * kRows;
    if (p0 < n_pairs) {
      while (s_pre[cb + 1] <= p0) ++cb;
    }
    if (lane < kRows) {
      const int pair = p0 + lane;
      int wrow = -1, nrow = 0;
      if (pair < n_pairs) {
        int b = cb;
        while (s_pre[b + 1] <= pair) ++b;
        const int s = s_src[b];
        const int row = s_list[s * tile + (pair - s_pre[b])];
        nrow = s * tile + row;
        wrow = (b_begin + b) * tile + row;
        if (per_sample && !((s_bits[nrow >> 5] >> (nrow & 31)) & 1u)) {
          wrow = -1;  // this pass's sample did not fire it: not read
        }
      }
      s_desc[(j & 1) * 2 * kRows + lane] = wrow;
      s_desc[(j & 1) * 2 * kRows + kRows + lane] = nrow;
    }
  };
  // Copy stage j's rows (weight slice, arrival words, sample mask) into
  // ring slot j % kStages from descriptor slot j & 1; rows past the list
  // are zero-filled. Always commits one group.
  auto copy_stage = [&](int j) {
    if (j < n_stages) {
      const size_t slot = static_cast<size_t>(j % kStages) * kRows;
      const int* dw = s_desc + (j & 1) * 2 * kRows;
      const int* dn = dw + kRows;
      for (int i = tid; i < kRows * C; i += kThreads) {
        const int r = i >> LC;
        const int wrow = dw[r];
        const int k = i & (C - 1);
        cp_async_16(ring + (slot + r) * C + k,
                    w + static_cast<size_t>(max(wrow, 0)) * tile + col0 +
                        k * kVec,
                    wrow >= 0 ? 16 : 0);
      }
      for (int i = tid; i < kRows * AW; i += kThreads) {
        const int r = i >> LAW;
        const int wrow = dw[r];
        const int k = i & (AW - 1);
        cp_async_4(ring_arr + (slot + r) * AW + k,
                   arrive + static_cast<size_t>(max(wrow, 0)) * row_words +
                       word0 + k,
                   wrow >= 0 ? 4 : 0);
      }
      for (int i = tid; i < kRows * MW; i += kThreads) {
        const int r = i / MW;
        const int k = i - r * MW;
        cp_async_4(ring_msk + (slot + r) * MW + k,
                   masks + static_cast<size_t>(dn[r]) * MW + k,
                   dw[r] >= 0 ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  T acc[S][kVec];
  uint32_t seen[S];  // bit e: column c * kVec + e had an arrival
  uint32_t seen_all = 0u;  // the same, from rows all S samples fired
#pragma unroll
  for (int s = 0; s < S; ++s) {
    seen[s] = 0u;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[s][e] = T(0);
  }
  const int arr_word = (c * kVec) >> 5;
  const int arr_shift = (c * kVec) & 31;
  const int mask_word = s_first >> 5;
  const int mask_shift = s_first & 31;

  // Add stage `slot`'s rows into this thread's samples that fired them,
  // kBatchRows rows at a time: their shared-memory loads first, then the
  // adds in row order.
  auto consume = [&](int slot) {
    const int base = slot * kRows;
    for (int r0 = 0; r0 < kRows; r0 += kBatchRows) {
      uint32_t m[kBatchRows], bits[kBatchRows];
      uint4 raw[kBatchRows];
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) {
        const int sr = base + r0 + q;
        m[q] = (ring_msk[sr * MW + mask_word] >> mask_shift) & kAll;
        raw[q] = ring[static_cast<size_t>(sr) * C + c];
        bits[q] = (ring_arr[sr * AW + arr_word] >> arr_shift) &
                  ((1u << kVec) - 1u);
      }
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) {
        const T* v = reinterpret_cast<const T*>(&raw[q]);
        if (m[q] == kAll) {  // every sample of the thread fired the row
          seen_all |= bits[q];
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[s][e] = acc[s][e] + v[e];
          }
        } else if (m[q] != 0u) {  // zero-filled rows have no bit set
#pragma unroll
          for (int s = 0; s < S; ++s) {
            if ((m[q] >> s) & 1u) {
#pragma unroll
              for (int e = 0; e < kVec; ++e) acc[s][e] = acc[s][e] + v[e];
              seen[s] |= bits[q];
            }
          }
        }
      }
    }
  };

  // Descriptors run one stage ahead of the copies, the copies kStages - 1
  // stages ahead of the adds; one barrier a stage.
  describe(0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    copy_stage(j);
    describe(j + 1);
    __syncthreads();
  }
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage i landed
    __syncthreads();  // everyone's did; slot i - 1 is consumed
    copy_stage(i + kStages - 1);
    describe(i + kStages);
    if (s_count > 0) consume(i % kStages);
  }
  cp_async_wait<0>();

  const int col = col0 + c * kVec;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    seen[s] |= seen_all;
    if (s < s_count) {
      const size_t o =
          (static_cast<size_t>(s_first + s) * n_tiles + d) * tile + col;
      uint4 packed;
      T* pv = reinterpret_cast<T*>(&packed);
#pragma unroll
      for (int e = 0; e < kVec; ++e) pv[e] = acc[s][e];
      *reinterpret_cast<uint4*>(out_cur + o) = packed;
      if constexpr (kVec == 4) {
        const uint32_t b = seen[s];
        *reinterpret_cast<uint32_t*>(out_arrived + o) =
            (b & 1u) | ((b >> 1 & 1u) << 8) | ((b >> 2 & 1u) << 16) |
            ((b >> 3 & 1u) << 24);
      } else {
        const uint32_t b = seen[s];
        *reinterpret_cast<uint16_t*>(out_arrived + o) =
            static_cast<uint16_t>((b & 1u) | ((b >> 1 & 1u) << 8));
      }
    }
  }
}

template <typename T, int S>
cudaError_t launch_main(const Plan& p, const void* w, const void* arrive,
                        long long w_stride, long long a_stride,
                        const void* src_tiles, const void* dest_offsets,
                        const void* rows, const void* lens, const void* masks,
                        void* out_cur, void* out_arrived, int batch,
                        int n_tiles, int tile, int blk_cap, int per_sample,
                        cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      batch_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, p.slices, p.passes);
  batch_kernel<T, S><<<grid, kThreads, p.smem, stream>>>(
      static_cast<const T*>(w), static_cast<const uint32_t*>(arrive),
      w_stride, a_stride, static_cast<const int*>(src_tiles),
      static_cast<const int*>(dest_offsets), static_cast<const uint8_t*>(rows),
      static_cast<const int*>(lens), static_cast<const uint32_t*>(masks),
      static_cast<T*>(out_cur), static_cast<uint8_t*>(out_arrived), batch,
      n_tiles, tile, blk_cap, p, per_sample);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* arrive,
                   const void* src_tiles, const void* dest_offsets, void* rows,
                   void* lens, void* masks, void* out_cur, void* out_arrived,
                   long long w_stride, long long a_stride, int batch,
                   int n_tiles, int tile, int blk_cap, cudaStream_t stream) {
  const int per_sample = w_stride != 0 || a_stride != 0;
  const Plan p = make_plan(batch, n_tiles, tile, blk_cap,
                           sizeof(T) == 8, per_sample);
  if (p.smem < 0) return cudaErrorInvalidValue;
  compact_kernel<T><<<n_tiles, kMaxTile, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint8_t*>(rows),
      static_cast<int*>(lens), static_cast<uint32_t*>(masks), batch, n_tiles,
      tile, p.mask_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define SANAFE_MAIN(S)                                                       \
  launch_main<T, S>(p, w, arrive, w_stride, a_stride, src_tiles,            \
                    dest_offsets, rows, lens, masks, out_cur, out_arrived,  \
                    batch, n_tiles, tile, blk_cap, per_sample, stream)
  switch (p.samples) {
    case 1: return SANAFE_MAIN(1);
    case 2: return SANAFE_MAIN(2);
    case 4: return SANAFE_MAIN(4);
    case 8: return SANAFE_MAIN(8);
    case 16: return SANAFE_MAIN(16);
    default: return SANAFE_MAIN(32);
  }
#undef SANAFE_MAIN
}

bool valid_shape(int batch, int n_tiles, int tile, int blk_cap) {
  return batch > 0 && n_tiles > 0 && tile >= 8 && tile <= kMaxTile &&
         (tile & (tile - 1)) == 0 && blk_cap >= 0 && batch <= 65535;
}

}  // namespace

extern "C" {

// Dynamic shared memory of a launch of this shape, or -1 where it does not
// fit a CTA (or the shape is refused).
long long sanafe_delivery_batch_smem(int batch, int n_tiles, int tile,
                                     int blk_cap, int is_double,
                                     int per_sample) {
  if (!valid_shape(batch, n_tiles, tile, blk_cap)) return -1;
  return make_plan(batch, n_tiles, tile, blk_cap, is_double, per_sample).smem;
}

// B deliveries on `stream`, float (is_double = 0) or double: the compaction
// kernel, then the main kernel. x is [batch, n_tiles, tile]; weights and
// arrive are one shared set (stride 0) or one set a sample (`w_stride`,
// `a_stride` elements apart). `rows` ([n_tiles, tile] bytes), `lens`
// ([n_tiles] int32) and `masks` ([n_tiles * tile, ceil(batch / 32)] int32)
// are scratch the caller allocates, 16-byte aligned. `tile` is a power of two
// in [8, 256]; `blk_cap` is the largest number of blocks of one destination
// tile. Returns the CUDA error (0 on success).
int sanafe_delivery_batch_launch(const void* x, const void* weights,
                                 const void* arrive, const void* src_tiles,
                                 const void* dest_offsets, void* rows,
                                 void* lens, void* masks, void* out_cur,
                                 void* out_arrived, long long w_stride,
                                 long long a_stride, int batch, int n_tiles,
                                 int tile, int blk_cap, int is_double,
                                 int device, void* stream) {
  if (!valid_shape(batch, n_tiles, tile, blk_cap) || device < 0 ||
      w_stride < 0 || a_stride < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(x, weights, arrive, src_tiles, dest_offsets, rows,
                          lens, masks, out_cur, out_arrived, w_stride,
                          a_stride, batch, n_tiles, tile, blk_cap, s);
  }
  return launch<float>(x, weights, arrive, src_tiles, dest_offsets, rows, lens,
                       masks, out_cur, out_arrived, w_stride, a_stride, batch,
                       n_tiles, tile, blk_cap, s);
}

const char* sanafe_delivery_batch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
