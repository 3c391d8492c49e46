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
// What bounds it: the bytes of the weight rows it must read. The TPU kernel
// multiplied whole blocks because its matrix unit wants them; of the
// 3,626,496 block rows of the 32k-neuron random chip only 32,552 (0.90%)
// hold an edge, and every other row adds +0.0. Each sum starts at +0.0, a
// round-to-nearest sum is -0.0 only when both addends are, so no sum is
// ever -0.0, and adding +-0.0 to it changes no bit. So a row whose weights
// are all +-0.0 and whose arrival bits are all 0 is skipped, for any
// weights, in both dtypes (a NaN or inf weight makes its row live). The
// caller passes each block's ascending list of such live rows, built once
// per sweep (ops/delivery.py: build_live_rows). What the kernel must read a
// step is then the live rows fired in any sample: 34 MB on that chip
// (0.01 ms at 3.35 TB/s) instead of 3.83 GB. Where every row is live
// (dense connectivity) the bytes bound it up to about 16 samples and the
// adds past that (one float add a cell a sample).
//
// The design: one CTA per (destination tile, sample pass) with three kinds
// of warps, which hand a ring of stages (kRows rows each) to each other on
// mbarriers, with no block barrier after the start.
//
// 1. mask_kernel, before the main kernel: each neuron's B-bit sample mask
//    (bit b: fired in sample b), ceil(B / 32) words a neuron.
// 2. The producer warp walks the tile's part of the live-row list (blocks
//    ascending, rows ascending), 256 entries a round, keeps the rows some
//    sample of the pass fired (their mask bits) and lists them, their
//    weight-row index and pass mask, in a free slot of the ring
//    (`described`). A slot is free once every adder warp added its last
//    rows (`empty`).
// 3. The copier warps copy each listed row's weights and arrival words
//    into the slot with cp.async, 16 bytes a lane (4 or 8 bytes for the
//    arrival words below tile 128), and arrive on the stage's `full`
//    mbarrier through cp.async.mbarrier.arrive, which holds the phase open
//    until the copies land. Copying takes warps of its own: one warp's
//    copies, 1-D bulk copies or cp.async, do not keep enough bytes in
//    flight to fill an SM's share of the memory's rate, and a warp whose
//    copies meet the memory's back-pressure stalls, with any adds it has
//    to do after them.
// 4. The 8 adder warps: a thread owns one 16-byte chunk of the row's
//    columns (the CTA spans the whole row, 64 chunks at tile 256 float32)
//    and S samples (up to 16 in float32, 8 in float64), with just enough
//    sample groups to keep 8 warps adding: each staged row is read from
//    shared memory once per sample group. A thread loads a batch of
//    kBatchRows rows, then branches once: a batch whose rows every sample
//    of the thread fired is added into all S accumulators with no test;
//    otherwise each row with predicates, never into a sample that did not
//    fire it. A pass takes at most 64 samples (past that, passes read the
//    rows again); with per-sample weights a pass is one sample and reads
//    its own weights.
//
// Order of the sums: one accumulator per (sample, column), +0.0 at the
// start, adding that sample's fired live rows in list order: blocks
// ascending, rows ascending within a block. The skipped rows change no bit,
// so this equals adding every fired row in that order, bit for bit for any
// weights. It is delivery_kernel's order, so a sample equals that kernel's
// delivery of its plane bit for bit, and the plain version wherever the
// partial sums are exact (integer weights). Two launches on the same inputs
// give the same bits. The mbarrier and cp.async helpers are shared with
// delivery_kernel.cu (async_copy.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "kernel_attrs.cuh"

namespace {

using sanafe::cp_async;
using sanafe::cp_async_arrive;
using sanafe::mbar_arrive;
using sanafe::mbar_init;
using sanafe::mbar_wait;

constexpr int kWarp = 32;
constexpr int kMaxTile = 256;
constexpr int kAdders = 256;  // threads that add (8 warps)
constexpr int kAdderWarps = kAdders / kWarp;
// Warps that copy: 8 where the adders' registers leave room, 4 beside the
// 64 accumulators of 16 float32 samples a thread
template <int S>
__host__ __device__ constexpr int copiers_for() {
  return S >= 16 ? 4 : 8;
}
template <int S>
__host__ __device__ constexpr int threads_for() {  // + the producer warp
  return kAdders + (copiers_for<S>() + 1) * kWarp;
}
constexpr int kRows = 32;  // rows a stage (at most kWarp)
constexpr int kBatchRows = 4;   // rows whose loads a thread starts together
constexpr int kMaxStages = 16;  // ring depth
constexpr int kPerLane = 8;     // list entries a producer lane takes a round
constexpr int kRound = kWarp * kPerLane;
constexpr int kQueue = 512;     // the producer's kept rows (> kRound + kRows)
constexpr int kMaxPass = 64;    // samples a pass (one 64-bit mask)
constexpr long long kMaxSmem = 227 * 1024;
// the mbarriers (described, full, empty), the stages' row counts and
// last-stage flags, and their weight-row indices
constexpr int kHeaderBytes =
    3 * kMaxStages * 8 + 2 * kMaxStages * 4 + kMaxStages * kRows * 4;
constexpr unsigned kFull = 0xffffffffu;

// --- step 1: the sample masks ------------------------------------------------

// masks[q * n_pad + i], bit k: x[32 q + k, i] != 0.
template <typename T>
__global__ void __launch_bounds__(256)
mask_kernel(const T* __restrict__ x, uint32_t* __restrict__ masks, int batch,
            int n_pad, int mask_words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pad) return;
  for (int q = 0; q < mask_words; ++q) {
    uint32_t m = 0;
    const int hi = min(32, batch - 32 * q);
    for (int k = 0; k < hi; ++k) {
      const size_t b = static_cast<size_t>(32 * q + k);
      if (x[b * n_pad + i] != T(0)) m |= 1u << k;
    }
    masks[static_cast<size_t>(q) * n_pad + i] = m;
  }
}

// --- step 2: the sums --------------------------------------------------------

// How one launch cuts the work (host and device agree through this).
struct Plan {
  int chunks;      // C: 16-byte chunks a row (a power of two)
  int log_chunks;
  int groups;      // G: sample groups a CTA
  int samples;     // S: samples a thread
  int per_pass;    // samples a pass (G * S, at most kMaxPass)
  int passes;      // gridDim.y
  int arr_words;   // arrival words a row
  int arr_slot;    // arrival words a stage row (at least 4: 16 bytes)
  int mask_words;  // sample-mask words a neuron
  int stages;      // ring depth
  long long smem;  // dynamic shared memory bytes; -1 if over the limit
};

int log2_of(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

long long stage_bytes(int tile, int size, int arr_slot) {
  return static_cast<long long>(kRows) *
         (static_cast<long long>(tile) * size + 4LL * arr_slot + 8LL);
}

Plan make_plan(int batch, int tile, int blk_cap, int is_double,
               int per_sample) {
  Plan p;
  const int size = is_double ? 8 : 4;
  p.chunks = tile * size / 16;
  p.log_chunks = log2_of(p.chunks);
  const int max_groups = kAdders / p.chunks;
  const int max_samples = is_double ? 8 : 16;
  if (per_sample) {
    p.samples = 1;
    p.groups = 1;
    p.per_pass = 1;
    p.passes = batch;
  } else {
    const int cap = max_groups * max_samples < kMaxPass
                        ? max_groups * max_samples : kMaxPass;
    const int want = batch < cap ? batch : cap;
    // the fewest samples a thread that keep at most 8 warps adding
    const int need = (want + max_groups - 1) / max_groups;
    p.samples = 1;
    while (p.samples < need) p.samples *= 2;
    p.groups = (want + p.samples - 1) / p.samples;
    p.per_pass = p.groups * p.samples;
    p.passes = (batch + p.per_pass - 1) / p.per_pass;
  }
  p.arr_words = (tile + 31) / 32;
  p.arr_slot = p.arr_words < 4 ? 4 : p.arr_words;
  p.mask_words = (batch + 31) / 32;
  const long long stage = stage_bytes(tile, size, p.arr_slot);
  const long long fixed =
      kHeaderBytes + 12LL * kQueue + 4LL * (2LL * blk_cap + 1);
  const long long fit = (kMaxSmem - fixed) / stage;
  p.stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  p.smem = p.stages >= 2 ? fixed + p.stages * stage : -1;
  return p;
}

// T: float or double. S: samples a thread (1, 2, 4, 8, 16).
template <typename T, int S>
__global__ void __launch_bounds__(threads_for<S>(), 1)
batch_kernel(const T* __restrict__ w, const uint32_t* __restrict__ arrive,
             long long w_stride, long long a_stride,
             const int* __restrict__ src_tiles,
             const int* __restrict__ dest_offsets,
             const uint8_t* __restrict__ live_rows,
             const int* __restrict__ live_offsets,
             const uint32_t* __restrict__ masks, T* __restrict__ out_cur,
             uint8_t* __restrict__ out_arrived, int batch, int n_tiles,
             int tile, int blk_cap, Plan p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr uint32_t kAllS = (1u << S) - 1u;
  constexpr int kCopiers = copiers_for<S>();
  constexpr int kThreads = threads_for<S>();
  const int K = p.stages;
  const int C = p.chunks;
  const int AS = p.arr_slot;
  const int n_pad = n_tiles * tile;
  const unsigned w_bytes = static_cast<unsigned>(tile) * sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* described = reinterpret_cast<uint64_t*>(smem);  // rows listed
  uint64_t* full = described + kMaxStages;  // the rows landed
  uint64_t* empty = full + kMaxStages;      // the rows added
  int* count_of = reinterpret_cast<int*>(empty + kMaxStages);
  int* last_of = count_of + kMaxStages;
  int* row_of = last_of + kMaxStages;  // [kMaxStages][kRows] weight rows
  unsigned char* ring_w = smem + kHeaderBytes;  // [K][kRows] weight rows
  uint32_t* ring_a = reinterpret_cast<uint32_t*>(
      ring_w + static_cast<size_t>(K) * kRows * w_bytes);  // [K][kRows][AS]
  uint64_t* ring_m = reinterpret_cast<uint64_t*>(
      ring_a + static_cast<size_t>(K) * kRows * AS);  // [K][kRows] pass masks
  uint64_t* q_m = ring_m + K * kRows;                 // [kQueue] kept rows
  int* q_row = reinterpret_cast<int*>(q_m + kQueue);
  int* s_off = q_row + kQueue;  // [blk_cap + 1] the blocks' list offsets
  int* s_src = s_off + blk_cap + 1;

  const int d = blockIdx.x;
  const int z = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int b_begin = dest_offsets[d];
  const int nb = dest_offsets[d + 1] - b_begin;
  if (nb > blk_cap) __trap();  // caller's bound
  const int e_base = live_offsets[b_begin];
  for (int i = tid; i <= nb; i += blockDim.x) {
    s_off[i] = live_offsets[b_begin + i] - e_base;
  }
  for (int i = tid; i < nb; i += blockDim.x) s_src[i] = src_tiles[b_begin + i];
  if (tid == 0) {
    for (int k = 0; k < K; ++k) {
      mbar_init(&described[k], 1);       // the producer
      // each copier warp, after its copies, which hold the phase open
      // until they land
      mbar_init(&full[k], kCopiers);
      mbar_init(&empty[k], kAdderWarps);  // each adder warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block barrier
  const int p0 = z * p.per_pass;  // the pass's first sample
  // strides are 0 for shared weights and arrivals; with per-sample ones a
  // pass is one sample
  w += static_cast<long long>(z) * w_stride;
  arrive += static_cast<long long>(z) * a_stride;

  if (tid >= kThreads - kWarp) {
    // --- the producer warp: which rows, in what order ---
    const int n_cand = s_off[nb];
    const int w_lo = p0 >> 5;
    const int shift = p0 & 31;
    const bool two = w_lo + 1 < p.mask_words && shift + p.per_pass > 32;
    const uint64_t pass_bits =
        p.per_pass >= 64 ? ~0ull : (1ull << p.per_pass) - 1ull;
    const uint32_t* m_lo = masks + static_cast<size_t>(w_lo) * n_pad;
    const uint32_t* m_hi = m_lo + n_pad;
    int head = 0, tail = 0;  // the queue's counters (the same in every lane)
    int j = 0;               // the next stage

    // Stage j: its `count` rows from the head of the queue into ring slot
    // j % K, once the consumers added the slot's last rows.
    auto emit = [&](int count, int last) {
      const int slot = j % K;
      if (j >= K) mbar_wait(&empty[slot], ((j / K) - 1) & 1);
      if (lane < kRows) {
        const int qi = (head + lane) & (kQueue - 1);
        const bool used = lane < count;
        row_of[slot * kRows + lane] = used ? q_row[qi] : 0;
        ring_m[slot * kRows + lane] = used ? q_m[qi] : 0ull;  // 0: unused
      }
      if (lane == 0) {
        count_of[slot] = count;
        last_of[slot] = last;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&described[slot]);
      head += count;
      ++j;
    };

    // A round takes kRound entries, kPerLane consecutive ones a lane: one
    // binary search for the lane's first block, then a walk. Its row bytes
    // are loaded a round ahead, and its mask words all together before the
    // first is used, so a round waits for about one load, not kPerLane.
    uint32_t row[kPerLane];
    auto load_rows = [&](int r0) {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int e = r0 + lane * kPerLane + k;
        row[k] = e < n_cand ? __ldg(live_rows + e_base + e) : 0u;
      }
    };
    load_rows(0);
    for (int r0 = 0; r0 < n_cand; r0 += kRound) {
      const int e0 = r0 + lane * kPerLane;
      // the block holding entry e0: s_off[b] <= e0 < s_off[b + 1]
      int b = 0, hi = nb;
      while (hi - b > 1) {
        const int mid = (b + hi) >> 1;
        if (s_off[mid] <= e0) b = mid; else hi = mid;
      }
      int wrow[kPerLane], nrow[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int e = e0 + k;
        nrow[k] = -1;
        if (e < n_cand) {
          while (s_off[b + 1] <= e) ++b;
          nrow[k] = s_src[b] * tile + static_cast<int>(row[k]);
        }
        wrow[k] = (b_begin + b) * tile + static_cast<int>(row[k]);
      }
      uint32_t lo_w[kPerLane], hi_w[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        lo_w[k] = nrow[k] >= 0 ? __ldg(m_lo + nrow[k]) : 0u;
        hi_w[k] = nrow[k] >= 0 && two ? __ldg(m_hi + nrow[k]) : 0u;
      }
      load_rows(r0 + kRound);  // the next round's, while these land
      // queue the rows some sample of the pass fired, in list order: the
      // lane's kept rows after those of the lanes before it
      uint64_t mk[kPerLane];
      int kept = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        mk[k] = ((static_cast<uint64_t>(hi_w[k]) << 32 | lo_w[k]) >> shift) &
                pass_bits;
        kept += mk[k] != 0;
      }
      int before = kept;  // inclusive scan over the lanes
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int v = __shfl_up_sync(kFull, before, o);
        if (lane >= o) before += v;
      }
      int at = tail + before - kept;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (mk[k] != 0) {
          q_m[at & (kQueue - 1)] = mk[k];
          q_row[at & (kQueue - 1)] = wrow[k];
          ++at;
        }
      }
      tail += __shfl_sync(kFull, before, kWarp - 1);
      __syncwarp();
      while (tail - head >= kRows) emit(kRows, 0);
    }
    emit(tail - head, 1);  // the rest, and the end (possibly no row)
    return;
  }

  if (tid >= kAdders) {
    // --- the copier warps: stage j's rows, once the producer listed them ---
    // Warp w copies rows w, w + kCopiers, ... (each weight row's 16-byte
    // chunks and its arrival words). The adders issue no copies: a warp
    // whose copies meet the memory's back-pressure stalls, and its adds
    // would wait with it.
    const int w_id = (tid - kAdders) / kWarp;
    const int a_chunks = p.arr_words / 4;  // 16-byte arrival chunks a row
    for (int j = 0;; ++j) {
      const int slot = j % K;
      mbar_wait(&described[slot], (j / K) & 1);
      const int count = count_of[slot];
      const int last = last_of[slot];
      for (int r = w_id; r < count; r += kCopiers) {
        const int sr = slot * kRows + r;
        const size_t wrow = row_of[sr];
        unsigned char* dst = ring_w + static_cast<size_t>(sr) * w_bytes;
        for (int k = lane; k < C; k += kWarp) {
          cp_async<16>(dst + 16 * k, w + wrow * tile + k * kVec);
        }
        uint32_t* a_dst = ring_a + sr * AS;
        const uint32_t* a_src = arrive + wrow * p.arr_words;
        if (lane < a_chunks) {
          cp_async<16>(a_dst + 4 * lane, a_src + 4 * lane);
        } else if (a_chunks == 0 && lane == kWarp - 1) {
          if (p.arr_words == 2) {
            cp_async<8>(a_dst, a_src);
          } else {
            cp_async<4>(a_dst, a_src);
          }
        }
      }
      cp_async_arrive(&full[slot]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[slot]);
      if (last) return;
    }
  }

  // --- the adder warps ---
  const int c = tid & (C - 1);
  const int g = tid >> p.log_chunks;
  const int s_first = p0 + g * S;
  const int s_count = g < p.groups ? min(S, max(0, batch - s_first)) : 0;
  const uint32_t mine_all = (1u << s_count) - 1u;
  const int m_shift = g * S;
  T acc[S][kVec];
  uint32_t seen[S];        // bit e: column c * kVec + e had an arrival
  uint32_t seen_all = 0u;  // the same, from rows all the samples fired
#pragma unroll
  for (int s = 0; s < S; ++s) {
    seen[s] = 0u;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[s][e] = T(0);
  }
  const int arr_word = (c * kVec) >> 5;
  const int arr_shift = (c * kVec) & 31;
  const uint4* rw = reinterpret_cast<const uint4*>(ring_w);

  // The thread's S bits of a row's pass mask lie in one 32-bit half.
  const uint32_t* ring_m32 = reinterpret_cast<const uint32_t*>(ring_m);
  const int m_half = m_shift >> 5;
  const int m_bit = m_shift & 31;

  // Add a stage's rows into this thread's samples that fired them,
  // kBatchRows rows at a time: the batch's shared-memory loads first, then
  // one branch: the adds of a batch whose rows every sample of the thread
  // fired run straight through, others test each row and sample.
  auto consume = [&](int slot) {
    const int base = slot * kRows;
#pragma unroll 1
    for (int r0 = 0; r0 < kRows; r0 += kBatchRows) {
      uint32_t m[kBatchRows], bits[kBatchRows];
      uint4 raw[kBatchRows];
      bool all = true;
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) {
        const int sr = base + r0 + q;
        m[q] = (ring_m32[2 * sr + m_half] >> m_bit) & kAllS;
        raw[q] = rw[sr * C + c];
        bits[q] = (ring_a[sr * AS + arr_word] >> arr_shift) &
                  ((1u << kVec) - 1u);
        all &= m[q] == mine_all;
      }
      if (all) {  // every sample of the thread fired every row
#pragma unroll
        for (int q = 0; q < kBatchRows; ++q) {
          const T* v = reinterpret_cast<const T*>(&raw[q]);
          seen_all |= bits[q];
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[s][e] = acc[s][e] + v[e];
          }
        }
        continue;
      }
#pragma unroll
      for (int q = 0; q < kBatchRows; ++q) {
        const T* v = reinterpret_cast<const T*>(&raw[q]);
        if (m[q] == mine_all) {
          seen_all |= bits[q];
#pragma unroll
          for (int s = 0; s < S; ++s) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[s][e] = acc[s][e] + v[e];
          }
        } else if (m[q] != 0u) {  // unused rows have no bit set
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

  int slot = 0;
  uint32_t phase = 0;
  for (;;) {
    mbar_wait(&full[slot], phase);
    const int last = last_of[slot];
    if (s_count > 0) consume(slot);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (last) break;
    if (++slot == K) {
      slot = 0;
      phase ^= 1u;
    }
  }

  const int col = c * kVec;
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
      const uint32_t b = seen[s];
      if constexpr (kVec == 4) {
        *reinterpret_cast<uint32_t*>(out_arrived + o) =
            (b & 1u) | ((b >> 1 & 1u) << 8) | ((b >> 2 & 1u) << 16) |
            ((b >> 3 & 1u) << 24);
      } else {
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
                        const void* live_rows, const void* live_offsets,
                        const void* masks, void* out_cur, void* out_arrived,
                        int batch, int n_tiles, int tile, int blk_cap,
                        cudaStream_t stream) {
  const cudaError_t err = sanafe::reserve_smem(
      reinterpret_cast<const void*>(&batch_kernel<T, S>),
      static_cast<size_t>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, p.passes);
  batch_kernel<T, S><<<grid, threads_for<S>(), p.smem, stream>>>(
      static_cast<const T*>(w), static_cast<const uint32_t*>(arrive),
      w_stride, a_stride, static_cast<const int*>(src_tiles),
      static_cast<const int*>(dest_offsets),
      static_cast<const uint8_t*>(live_rows),
      static_cast<const int*>(live_offsets),
      static_cast<const uint32_t*>(masks), static_cast<T*>(out_cur),
      static_cast<uint8_t*>(out_arrived), batch, n_tiles, tile, blk_cap, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* arrive,
                   const void* src_tiles, const void* dest_offsets,
                   const void* live_rows, const void* live_offsets,
                   void* masks, void* out_cur, void* out_arrived,
                   long long w_stride, long long a_stride, int batch,
                   int n_tiles, int tile, int blk_cap, cudaStream_t stream) {
  const int per_sample = w_stride != 0 || a_stride != 0;
  const Plan p = make_plan(batch, tile, blk_cap, sizeof(T) == 8, per_sample);
  if (p.smem < 0) return cudaErrorInvalidValue;
  const int n_pad = n_tiles * tile;
  mask_kernel<T><<<(n_pad + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<uint32_t*>(masks), batch, n_pad,
      p.mask_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define SANAFE_MAIN(S)                                                       \
  launch_main<T, S>(p, w, arrive, w_stride, a_stride, src_tiles,            \
                    dest_offsets, live_rows, live_offsets, masks, out_cur,  \
                    out_arrived, batch, n_tiles, tile, blk_cap, stream)
  switch (p.samples) {
    case 1: return SANAFE_MAIN(1);
    case 2: return SANAFE_MAIN(2);
    case 4: return SANAFE_MAIN(4);
    case 8: return SANAFE_MAIN(8);
    default:
      if constexpr (sizeof(T) == 4) return SANAFE_MAIN(16);
      return cudaErrorInvalidValue;
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
  return make_plan(batch, tile, blk_cap, is_double, per_sample).smem;
}

// B deliveries on `stream`, float (is_double = 0) or double: the mask
// kernel, then the main kernel. x is [batch, n_tiles, tile]; weights and
// arrive are one shared set (stride 0) or one set a sample (`w_stride`,
// `a_stride` elements apart). `live_rows` (uint8) and `live_offsets`
// ([n_blocks + 1] int32) list each block's live rows in ascending order
// (block k's are live_rows[live_offsets[k] .. live_offsets[k + 1]]); with
// per-sample weights or arrivals, the union over the samples. `masks`
// ([ceil(batch / 32), n_tiles * tile] uint32) is scratch the caller
// allocates. Every pointer is 16-byte aligned. `tile` is a power of two in
// [8, 256]; `blk_cap` is the largest number of blocks of one destination
// tile. Returns the CUDA error (0 on success).
int sanafe_delivery_batch_launch(const void* x, const void* weights,
                                 const void* arrive, const void* src_tiles,
                                 const void* dest_offsets,
                                 const void* live_rows,
                                 const void* live_offsets, void* masks,
                                 void* out_cur, void* out_arrived,
                                 long long w_stride, long long a_stride,
                                 int batch, int n_tiles, int tile,
                                 int blk_cap, int is_double, int device,
                                 void* stream) {
  if (!valid_shape(batch, n_tiles, tile, blk_cap) || device < 0 ||
      w_stride < 0 || a_stride < 0) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(x, weights, arrive, src_tiles, dest_offsets,
                          live_rows, live_offsets, masks, out_cur,
                          out_arrived, w_stride, a_stride, batch, n_tiles,
                          tile, blk_cap, s);
  }
  return launch<float>(x, weights, arrive, src_tiles, dest_offsets, live_rows,
                       live_offsets, masks, out_cur, out_arrived, w_stride,
                       a_stride, batch, n_tiles, tile, blk_cap, s);
}

const char* sanafe_delivery_batch_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
