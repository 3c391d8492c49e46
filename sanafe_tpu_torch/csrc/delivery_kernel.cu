// Activity-gated block-dense spike delivery over the live-row list (Hopper,
// sm_90a).
//
// Replaces sanafe_tpu/ops/pallas_delivery.py:_delivery_kernel, the Pallas TPU
// kernel of the step scan's block delivery, together with the arrival test
// sanafe_tpu/ops/step.py:_block_deliver runs beside it. The Python side
// (sanafe_tpu_torch/ops/delivery.py) holds the plain PyTorch version
// (delivery_live_plain) this file is checked against.
//
// Per timestep, for each destination tile d:
//   cur[d]     = sum over blocks b of d, over the rows i of b's source tile
//                that fired, of W[b][i]
//   arrived[d] = OR over the same rows of the packed arrival plane A[b][i]
//                (bit j%32 of word j/32 of row i is set where an edge joins
//                row i to column j)
// with the blocks sorted dest-major. Destination tiles no fired row reaches
// are zero.
//
// What bounds it: the bytes of the weight rows it must read. Of the
// 3,626,496 block rows of the 32k-neuron random chip only 32,552 (0.90%)
// hold an edge, and every other row adds +0.0. Each sum starts at +0.0, a
// round-to-nearest sum is -0.0 only when both addends are, so no sum is
// ever -0.0, and adding +-0.0 to it changes no bit. So a row whose weights
// are all +-0.0 and whose arrival bits are all 0 is skipped, for any
// weights, in both dtypes (a NaN or inf weight makes its row live). The
// program builds each block's ascending list of live rows once, and holds
// those rows alone: weights [count, tile] and arrival words [count, words],
// row r the list's r-th (ops/step.py: build_block_delivery, straight from
// the edges; 16.8M edges list 4.15M rows, 4.4 GB, where the dense blocks
// would take 80 GB). The wrapper's plan expands the list, once, into one
// (compact row, source neuron) pair an entry, in list order: blocks
// ascending, rows ascending within a block; a destination tile's entries
// are contiguous. Offsets into the rows are 64-bit. What the kernel must
// read a step is then the live rows that fired: 34 MB on that chip (0.01 ms
// at 3.35 TB/s) instead of the 3.83 GB of every fired row.
//
// One launch a step: one CTA per (destination tile, column slice), with
// three kinds of warps, which hand a ring of stages (up to kRows rows each)
// to each other on mbarriers, with no block barrier after the start.
//
// 1. Four producer warps walk the tile's entries, kRound a round, taking
//    rounds in turn: a lane loads kPerLane entries (those of the warp's
//    next round are in flight while a round is tested), then the fired
//    value of each entry's source neuron, all before the first is used.
//    The warp keeps the fired entries by ballot, then waits for its turn
//    (the rounds before its own queued) to queue them in list order and
//    list kRows of them at a time in a free slot of the ring
//    (`described`); a slot is free once every adder warp added its rows
//    (`empty`). So a stage holds fired rows only, and four rounds' loads
//    are in flight at once: where few of many live rows fire (DVS-gesture's
//    edges, 7% fired) the walk, not the copies, is the work. The fired
//    test is the kernel's own, so the compaction kernel of the earlier
//    design is gone.
// 2. The copier warps copy each listed row's slice into the slot, a row a
//    lane, in one 1-D bulk copy of the copy engine (cp.async.bulk), with
//    its arrival words, and arrive on the stage's `full` mbarrier expecting
//    the copies' bytes, which hold the phase open until they land: one
//    instruction a row, where cp.async takes one a 16-byte chunk a lane.
// 3. The adder warps: a thread owns one column of the slice (up to 8 warps
//    for a row of 256); it adds the stage's rows in order, eight rows'
//    shared-memory loads at a time, and ORs their arrival words.
//
// Few destination tiles (a 4,096-neuron chip has 16) would leave most SMs
// idle, so a row is cut into column slices of whole arrival words, as many
// as give kMinCtas CTAs; each slice walks the whole list and adds every
// listed fired row, so slicing changes no sum. A CTA has its SM to itself
// (its registers), and its ring holds at least two stages for every tile
// the kernel takes (float64 rows of 256: three stages of 66,560 bytes);
// sanafe_delivery_smem tells the wrapper, once, whether a shape fits.
//
// Order of the sums: one accumulator per column, +0.0 at the start, adding
// the fired live rows in list order. The skipped rows change no bit, so
// this equals adding every fired row in that order, bit for bit for any
// weights; it is delivery_batch_kernel's order, so the two kernels agree bit
// for bit at one sample, and both equal the plain version delivery_plain
// wherever the partial sums are exact (integer weights). Two launches on the
// same inputs give the same bits.
//
// The cells (a second live_kernel, over the same sums). Where a live row
// holds few edges the rows are mostly +0.0: TCAD'25's largest random network
// (131,072 neurons, 16.8M edges) lists 4.15M live rows of 256 columns with
// 4.04 edges each, 4.39 GB a step streamed for 134 MB of edges (8 B each).
// There the program holds the edge cells alone, destination-major
// (ops/delivery.py: DeliveryCells; a program holds them where the kernel's
// measured cost, delivery_us, makes them faster than the rows at the share
// of neurons that fire): each destination neuron's cells, a
// source neuron (int32) and a weight (the value its row holds at that
// column) each, in ascending source order, in slices of 32 destinations
// padded to the slice's longest list, a destination's cells in groups of 4
// side by side, so that lane j of a warp reads destination j's next 4 cells
// (16 bytes of sources) beside its neighbours'. One launch a step:
// - the fired plane as a bitmask in shared memory (a bit a neuron: 16 KB for
//   131,072 neurons). A cluster of kCellCluster CTAs packs it, a quarter
//   each from the plane (by ballot), and each CTA copies the others'
//   quarters out of their shared memory (distributed shared memory), so the
//   plane is read from L2 once a cluster, not once a CTA. A plane whose mask
//   passes a CTA's shared memory (over 1.8M neurons) is read for each cell
//   instead (the kMask = false kernel, no cluster);
// - persistent CTAs, as many as the card holds at once, 1024 threads each;
//   a warp takes a slice, a thread a destination: it loads 16 (float) or 8
//   (double) cells, sources and weights, in 16-byte loads, then adds those
//   whose source fired, in order, from +0.0, and ORs whether any did. The
//   order is the rows' (blocks ascending, rows ascending within a block:
//   source ascending), and the rows' other columns add +0.0 (no cell),
//   which changes no bit of a sum from +0.0: the same bits as the row path
//   for any weights.
// It reads each cell once (8 B in float32, plus the slices' padding: 20.1M
// slots for 16.8M cells on that network), the lengths and the plane;
// bounded by those bytes (on an H100: 0.075 ms a step there, 1.47 ms over
// the rows).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "kernel_attrs.cuh"

namespace {

namespace cg = cooperative_groups;
using sanafe::bulk_copy;
using sanafe::cp_async;
using sanafe::cp_async_arrive;
using sanafe::mbar_arrive;
using sanafe::mbar_arrive_expect_tx;
using sanafe::mbar_init;
using sanafe::mbar_wait;

constexpr int kWarp = 32;
constexpr int kMaxTile = 256;
constexpr int kRows = 32;      // rows a stage (at most kWarp)
constexpr int kCopiers = 8;    // copier warps a CTA
constexpr int kProducers = 4;  // producer warps, which take rounds in turn
constexpr int kMaxAdders = 8;  // a row of 256: one column a thread
constexpr int kBatchRows = 8;  // rows whose loads an adder starts together
constexpr int kMaxStages = 8;  // ring depth
constexpr int kPerLane = 8;    // list entries a producer lane takes a round
constexpr int kRound = kWarp * kPerLane;
constexpr int kQueue = 512;    // the producers' kept rows (> kRound + kRows)
constexpr int kMinCtas = 128;  // cut rows into slices below this many CTAs
constexpr long long kMaxSmem = 227 * 1024;  // dynamic shared memory of a CTA
// the mbarriers (described, full, empty), the stages' row counts and
// last-stage flags, their weight-row indices, the producers' queue and
// their shared counters (rounds queued, the queue's head and tail, the
// next stage)
constexpr int kHeaderBytes = 3 * kMaxStages * 8 + 2 * kMaxStages * 4 +
                             kMaxStages * kRows * 4 + kQueue * 4 + 16;
constexpr int kThreads = (kMaxAdders + kCopiers + kProducers) * kWarp;
constexpr unsigned kFull = 0xffffffffu;

// A producer's turn is taken and handed on through one shared counter: an
// acquiring load and a releasing store, no fence that would wait for the
// warp's loads in flight.
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];"
               : "=r"(v)
               : "r"(sanafe::smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.cta.shared::cta.b32 [%0], %1;" ::"r"(
                   sanafe::smem_addr(p)),
               "r"(v)
               : "memory");
}

// How one launch cuts the work (host and device agree through this).
struct Plan {
  int chunks;      // 16-byte chunks a row
  int slice;       // chunks a CTA's column slice: `chunks` or a divisor
  int slices;      // gridDim.y
  int adders;      // adder warps: one thread a column of the slice
  int row_words;   // arrival words a row
  int arr_words;   // arrival words a slice
  int stages;      // ring depth
  long long smem;  // dynamic shared memory bytes; -1 if over the limit
};

// A CTA of 640 threads at about 64 registers a thread fills an SM's
// register file, so a CTA has its SM to itself: the ring takes as much of
// its shared memory as kMaxStages stages need.
Plan make_plan(int n_tiles, int tile, int is_double) {
  Plan p;
  const int size = is_double ? 8 : 4;
  const int vec = 16 / size;
  p.chunks = tile * size / 16;
  p.slice = p.chunks;
  // halve the slice, keeping it whole arrival words, while there are fewer
  // than kMinCtas CTAs
  while (n_tiles * (p.chunks / p.slice) < kMinCtas && p.slice % 2 == 0 &&
         (p.slice / 2) * vec % 32 == 0) {
    p.slice /= 2;
  }
  p.slices = p.chunks / p.slice;
  p.adders = (p.slice * vec + kWarp - 1) / kWarp;
  p.row_words = (tile + 31) / 32;
  p.arr_words = (p.slice * vec + 31) / 32;
  const long long stage =
      static_cast<long long>(kRows) * (16LL * p.slice + 4LL * p.arr_words);
  const long long fit = (kMaxSmem - kHeaderBytes) / stage;
  p.stages = static_cast<int>(fit < kMaxStages ? fit : kMaxStages);
  p.smem = p.stages >= 2 ? kHeaderBytes + p.stages * stage : -1;
  return p;
}

// T: float or double.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
live_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const uint32_t* __restrict__ arrive,
            const int2* __restrict__ entries,
            const int* __restrict__ tile_entries, T* __restrict__ out_cur,
            uint8_t* __restrict__ out_arrived, int tile, Plan p) {
  constexpr int kVec = 16 / sizeof(T);
  const int K = p.stages;
  const int SC = p.slice;
  const int AW = p.arr_words;
  const int row_bytes = 16 * SC;  // a ring row: the slice's columns

  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* described = reinterpret_cast<uint64_t*>(smem);  // rows listed
  uint64_t* full = described + kMaxStages;  // the rows landed
  uint64_t* empty = full + kMaxStages;      // the rows added
  int* count_of = reinterpret_cast<int*>(empty + kMaxStages);
  int* last_of = count_of + kMaxStages;
  int* row_of = last_of + kMaxStages;  // [kMaxStages][kRows] weight rows
  int* queue = row_of + kMaxStages * kRows;     // [kQueue] kept weight rows
  // [4]: rounds queued, the queue's head and tail, the next stage
  int* counters = queue + kQueue;
  unsigned char* ring_w = smem + kHeaderBytes;  // [K][kRows][SC] chunks
  uint32_t* ring_a = reinterpret_cast<uint32_t*>(
      ring_w + static_cast<size_t>(K) * kRows * row_bytes);  // [K][kRows][AW]

  const int d = blockIdx.x;
  const int col0 = blockIdx.y * SC * kVec;  // the slice's first column
  const int w0 = col0 >> 5;                 // and its first arrival word
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  if (tid == 0) {
    for (int k = 0; k < K; ++k) {
      mbar_init(&described[k], 1);  // the producer that lists it
      // each copier warp, after its copies, which hold the phase open
      // until they land
      mbar_init(&full[k], kCopiers);
      mbar_init(&empty[k], p.adders);  // each adder warp
    }
    for (int k = 0; k < 4; ++k) counters[k] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block barrier

  if (warp >= p.adders + kCopiers) {
    // --- the producer warps: which rows, in list order ---
    // Producer q takes rounds q, q + kProducers, ...: it loads and tests a
    // round while the others load and test theirs, then waits for its turn
    // (`counters[0]`, the rounds queued so far) to queue the round's fired
    // rows and list the full stages.
    const int q = warp - (p.adders + kCopiers);
    const int e_begin = tile_entries[d];
    const int n_e = tile_entries[d + 1] - e_begin;
    const int n_rounds = (n_e + kRound - 1) / kRound;
    int head = 0, tail = 0;  // the queue's counters (the same in every lane)
    int j = 0;               // the next stage

    // Stage j: its `count` rows from the head of the queue into ring slot
    // j % K, once the adders added the slot's last rows.
    const auto emit = [&](int count, int last) {
      const int slot = j % K;
      if (j >= K) mbar_wait(&empty[slot], ((j / K) - 1) & 1);
      if (lane < count) {
        row_of[slot * kRows + lane] = queue[(head + lane) & (kQueue - 1)];
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

    // Entry r0 + k * kWarp + lane is lane's k-th of the round starting at
    // r0: each load is one coalesced read of the warp.
    int2 ent[kPerLane], next[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int e = q * kRound + k * kWarp + lane;
      ent[k] = e < n_e ? __ldg(entries + e_begin + e) : make_int2(-1, -1);
    }
    for (int r = q; r < n_rounds; r += kProducers) {
      // the warp's next round's entries, in flight while this round is
      // tested and queued
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int e = (r + kProducers) * kRound + k * kWarp + lane;
        next[k] = e < n_e ? __ldg(entries + e_begin + e) : make_int2(-1, -1);
      }
      bool fired[kPerLane];
      int wrow[kPerLane];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        fired[k] = ent[k].y >= 0 && __ldg(x + ent[k].y) != T(0);
        wrow[k] = ent[k].x;
      }
      // each fired entry's place among the round's fired ones, in list
      // order, before the turn: the turn itself only stores them
      int before[kPerLane];
      int n_kept = 0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const unsigned kept = __ballot_sync(kFull, fired[k]);
        before[k] = n_kept + __popc(kept & ((1u << lane) - 1u));
        n_kept += __popc(kept);
      }
      // this warp's turn: the rounds before r are queued
      while (load_acquire(&counters[0]) != r) __nanosleep(20);
      head = counters[1];
      tail = counters[2];
      j = counters[3];
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (fired[k]) queue[(tail + before[k]) & (kQueue - 1)] = wrow[k];
      }
      tail += n_kept;
      __syncwarp();
      while (tail - head >= kRows) emit(kRows, 0);
      if (r == n_rounds - 1) emit(tail - head, 1);  // the rest, and the end
      __syncwarp();
      if (lane == 0) {
        counters[1] = head;
        counters[2] = tail;
        counters[3] = j;
        store_release(&counters[0], r + 1);  // the next round's turn
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) ent[k] = next[k];
    }
    if (n_rounds == 0 && q == 0) emit(0, 1);  // no entry: the end alone
    return;
  }

  if (warp >= p.adders) {
    // --- the copier warps: stage j's rows, once a producer listed them ---
    // Lane l of warp w copies row w + kCopiers * l: its slice in one bulk
    // copy, and its arrival words in bulk too where they are a multiple of
    // 16 bytes (tiles of 128 and more), else a word a cp.async.
    const int cw = warp - p.adders;
    const bool bulk_words = (4 * AW) % 16 == 0;
    const uint32_t row_tx = row_bytes + (bulk_words ? 4 * AW : 0);
    for (int j = 0;; ++j) {
      const int slot = j % K;
      mbar_wait(&described[slot], (j / K) & 1);
      const int count = count_of[slot];
      const int last = last_of[slot];
      const int mine = count > cw ? (count - cw + kCopiers - 1) / kCopiers : 0;
      const int r = cw + kCopiers * lane;
      const bool copies = lane < mine;
      const size_t wrow =
          copies ? static_cast<size_t>(row_of[slot * kRows + r]) : 0;
      unsigned char* dst = ring_w + static_cast<size_t>(slot * kRows + r) *
                                        row_bytes;
      uint32_t* a_dst = ring_a + static_cast<size_t>(slot * kRows + r) * AW;
      const uint32_t* a_src = arrive + wrow * p.row_words + w0;
      if (!bulk_words) {
        if (copies) {
          for (int k = 0; k < AW; ++k) cp_async<4>(a_dst + k, a_src + k);
        }
        // counted on `full` before the warp's arrival below
        cp_async_arrive(&full[slot]);
      }
      __syncwarp();
      // the warp's arrival, with the bytes its bulk copies will bring
      if (lane == 0) mbar_arrive_expect_tx(&full[slot], mine * row_tx);
      __syncwarp();
      if (copies) {
        bulk_copy(dst, w + wrow * tile + col0, row_bytes, &full[slot]);
        if (bulk_words) bulk_copy(a_dst, a_src, 4 * AW, &full[slot]);
      }
      if (last) return;
    }
  }

  // --- the adder warps: thread c adds column c of the slice ---
  const int c = tid;
  const int cols = SC * kVec;  // the slice's columns, a ring row's values
  const bool mine = c < cols;
  const int col = col0 + c;
  const int a_word = (col >> 5) - w0;
  T acc = T(0);
  uint32_t seen = 0u;  // bit col % 32: column col had an arrival
  for (int j = 0;; ++j) {
    const int slot = j % K;
    mbar_wait(&full[slot], (j / K) & 1);
    const int last = last_of[slot];
    if (mine) {
      const int count = count_of[slot];
      const T* rows = reinterpret_cast<const T*>(
                          ring_w + static_cast<size_t>(slot) * kRows *
                                       row_bytes) + c;
      const uint32_t* bits =
          ring_a + static_cast<size_t>(slot) * kRows * AW + a_word;
#pragma unroll 1
      for (int r0 = 0; r0 < count; r0 += kBatchRows) {
        T v[kBatchRows];
        uint32_t b[kBatchRows];
#pragma unroll
        for (int q = 0; q < kBatchRows; ++q) {
          // rows past the count hold stale values: loaded, not added
          v[q] = rows[(r0 + q) * cols];
          b[q] = bits[(r0 + q) * AW];
        }
#pragma unroll
        for (int q = 0; q < kBatchRows; ++q) {
          if (r0 + q < count) {  // in order: the rows of the list
            acc = acc + v[q];
            seen |= b[q];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (last) break;
  }
  if (mine) {
    const size_t o = static_cast<size_t>(d) * tile + col;
    out_cur[o] = acc;
    out_arrived[o] = static_cast<uint8_t>((seen >> (col & 31)) & 1u);
  }
}

bool valid_shape(int n_tiles, int tile) {
  return n_tiles > 0 && tile > 0 && tile <= kMaxTile && tile % 4 == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* arrive,
                   const void* entries, const void* tile_entries,
                   void* out_cur, void* out_arrived, int n_tiles, int tile,
                   cudaStream_t stream) {
  const Plan p = make_plan(n_tiles, tile, sizeof(T) == 8);
  if (p.smem < 0 || p.adders > kMaxAdders) return cudaErrorInvalidValue;
  void (*const kernel)(const T*, const T*, const uint32_t*, const int2*,
                       const int*, T*, uint8_t*, int, Plan) = live_kernel<T>;
  const cudaError_t err = sanafe::reserve_smem(
      reinterpret_cast<const void*>(kernel), static_cast<size_t>(p.smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, p.slices);
  live_kernel<T><<<grid, (p.adders + kCopiers + kProducers) * kWarp, p.smem,
                   stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const uint32_t*>(arrive), static_cast<const int2*>(entries),
      static_cast<const int*>(tile_entries), static_cast<T*>(out_cur),
      static_cast<uint8_t*>(out_arrived), tile, p);
  return cudaGetLastError();
}

// --- the cells ---

constexpr int kCellThreads = 1024;
constexpr int kCellWarps = kCellThreads / kWarp;
constexpr int kCellBatch = 8;    // mask words a lane tests before its ballots
constexpr int kCellCluster = 4;  // CTAs that pack the fired mask together
constexpr int kSlice = 32;       // destinations a slice: a warp's lanes
constexpr int kGroup = 4;        // a destination's cells that lie together

// A group's 4 weights, in 16-byte loads.
__device__ __forceinline__ void load_group(const float* p, float (&v)[kGroup]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_group(const double* p,
                                           double (&v)[kGroup]) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ int group_at(const int4& g, int e) {
  return e == 0 ? g.x : e == 1 ? g.y : e == 2 ? g.z : g.w;
}

// The fired mask's shared memory for n neurons (a bit each, 16-byte rounded).
long long cell_smem(int n) {
  return (4LL * ((n + 31) / 32) + 15) / 16 * 16;
}

// T: float or double; kMask: the fired plane packed into a bitmask in shared
// memory by a cluster (else read for each cell). Slice s holds destinations
// 32s .. 32s + 31; cell k of destination 32s + j is slot starts[s] +
// 128 (k / 4) + 4j + k % 4 (ops/delivery.py: cell_slot), so lane j loads
// its cells 4 at a time, 16 bytes of sources, beside its neighbours'.
template <typename T, bool kMask>
__global__ void __launch_bounds__(kCellThreads, 1)
live_kernel(const T* __restrict__ x, const int* __restrict__ src,
            const T* __restrict__ w, const int* __restrict__ lengths,
            const long long* __restrict__ starts, T* __restrict__ out_cur,
            uint8_t* __restrict__ out_arrived, int n, int n_slices) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);  // bit i: i fired
  const int tid = threadIdx.x;
  const int lane = tid & (kWarp - 1);
  const int warp = tid / kWarp;
  if constexpr (kMask) {
    // rank r packs words [r * per, (r + 1) * per): lane l tests neuron l of
    // each of kCellBatch words, all loads in flight, then one ballot a word
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int ranks = static_cast<int>(cluster.num_blocks());
    const int words = (n + 31) / 32;
    const int per = (words + ranks - 1) / ranks;
    const int lo = rank * per;
    const int hi = min(words, lo + per);
    for (int w0 = lo + warp * kCellBatch; w0 < hi;
         w0 += kCellWarps * kCellBatch) {
      bool f[kCellBatch];
#pragma unroll
      for (int q = 0; q < kCellBatch; ++q) {
        const int i = (w0 + q) * 32 + lane;
        f[q] = w0 + q < hi && i < n && __ldg(x + i) != T(0);
      }
#pragma unroll
      for (int q = 0; q < kCellBatch; ++q) {
        const unsigned word = __ballot_sync(kFull, f[q]);
        if (lane == 0 && w0 + q < hi) mask[w0 + q] = word;
      }
    }
    cluster.sync();  // every rank's words written
    for (int peer = 0; peer < ranks; ++peer) {
      if (peer == rank) continue;
      const uint32_t* theirs = cluster.map_shared_rank(mask, peer);
      const int p_hi = min(words, (peer + 1) * per);
      for (int i = peer * per + tid; i < p_hi; i += kCellThreads) {
        mask[i] = theirs[i];
      }
    }
    cluster.sync();  // no CTA leaves while a peer reads its words
  }

  // groups a lane loads before it adds them: 64 bytes of weights
  constexpr int kInFlight = 16 / sizeof(T);
  for (int s = blockIdx.x * kCellWarps + warp; s < n_slices;
       s += gridDim.x * kCellWarps) {
    const int d = s * kSlice + lane;
    const int len = d < n ? __ldg(lengths + d) : 0;
    const long long first = __ldg(starts + s);
    // the slice's longest list, in whole groups
    const int groups = static_cast<int>(
        (__ldg(starts + s + 1) - first) / (kSlice * kGroup));
    const int* s_src = src + first + lane * kGroup;
    const T* s_w = w + first + lane * kGroup;
    T acc = T(0);
    bool seen = false;
    for (int g0 = 0; g0 < groups; g0 += kInFlight) {
      int4 sv[kInFlight];
      T wv[kInFlight][kGroup];
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
        const int g = g0 + q;
        const long long at = static_cast<long long>(g) * (kSlice * kGroup);
        if (g * kGroup < len) {
          sv[q] = __ldg(reinterpret_cast<const int4*>(s_src + at));
          load_group(s_w + at, wv[q]);
        } else {
          sv[q] = make_int4(0, 0, 0, 0);
#pragma unroll
          for (int e = 0; e < kGroup; ++e) wv[q][e] = T(0);
        }
      }
#pragma unroll
      for (int q = 0; q < kInFlight; ++q) {
#pragma unroll
        for (int e = 0; e < kGroup; ++e) {
          if ((g0 + q) * kGroup + e < len) {  // in order: the cells
            const int source = group_at(sv[q], e);
            bool fired;
            if constexpr (kMask) {
              fired = (mask[source >> 5] >> (source & 31)) & 1u;
            } else {
              fired = __ldg(x + source) != T(0);
            }
            if (fired) {
              acc = acc + wv[q][e];
              seen = true;
            }
          }
        }
      }
    }
    if (d < n) {
      out_cur[d] = acc;
      out_arrived[d] = static_cast<uint8_t>(seen);
    }
  }
}

template <typename T, bool kMask>
using CellKernel = void (*)(const T*, const int*, const T*, const int*,
                            const long long*, T*, uint8_t*, int, int);

// The CTAs one launch of the cell kernel takes for n neurons: those its
// slices need (a warp a slice), at most as many as the card holds at once,
// a multiple of the cluster with the mask; a CUDA error as its negative.
template <typename T, bool kMask>
int cell_ctas(int n) {
  const CellKernel<T, kMask> kernel = live_kernel<T, kMask>;
  const size_t smem = kMask ? static_cast<size_t>(cell_smem(n)) : 0;
  cudaError_t err =
      sanafe::reserve_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int n_slices = (n + kSlice - 1) / kSlice;
  int need = (n_slices + kCellWarps - 1) / kCellWarps;
  int most = 0;
  if (kMask) {
    need = (need + kCellCluster - 1) / kCellCluster * kCellCluster;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kCellCluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(kCellCluster);
    config.blockDim = dim3(kCellThreads);
    config.dynamicSmemBytes = smem;
    config.attrs = &attr;
    config.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(
        &clusters, reinterpret_cast<const void*>(kernel), &config);
    if (err != cudaSuccess) return -static_cast<int>(err);
    most = clusters * kCellCluster;
  } else {
    int per_sm = 0, device = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(kernel), kCellThreads, smem);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    }
    if (err != cudaSuccess) return -static_cast<int>(err);
    most = per_sm * sms;
  }
  if (most <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  return need < most ? need : most;
}

template <typename T, bool kMask>
cudaError_t launch_cells(const void* x, const void* src, const void* w,
                         const void* lengths, const void* starts,
                         void* out_cur, void* out_arrived, int n,
                         int n_slices, int ctas, cudaStream_t stream) {
  const CellKernel<T, kMask> kernel = live_kernel<T, kMask>;
  const size_t smem = kMask ? static_cast<size_t>(cell_smem(n)) : 0;
  cudaError_t err =
      sanafe::reserve_smem(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCellCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ctas);
  config.blockDim = dim3(kCellThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = kMask ? &attr : nullptr;
  config.numAttrs = kMask ? 1 : 0;
  err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(x), static_cast<const int*>(src),
      static_cast<const T*>(w), static_cast<const int*>(lengths),
      static_cast<const long long*>(starts), static_cast<T*>(out_cur),
      static_cast<uint8_t*>(out_arrived), n, n_slices);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool mask_fits(int n) { return cell_smem(n) <= kMaxSmem; }

}  // namespace

extern "C" {

// The dynamic shared memory one launch of `n_tiles` tiles of `tile` takes,
// or -1 where the shape does not fit (or is not one the kernel takes): the
// wrapper asks once, when a program is built.
long long sanafe_delivery_smem(int n_tiles, int tile, int is_double) {
  if (!valid_shape(n_tiles, tile)) return -1;
  const Plan p = make_plan(n_tiles, tile, is_double);
  return p.adders > kMaxAdders ? -1 : p.smem;
}

// One delivery on `stream`, float (is_double = 0) or double, in one launch.
// x [n_tiles, tile] is the fired plane; `weights` [count, tile] and
// `arrive` [count, words] are the live rows alone, in list order; `entries`
// (int32 pairs) are the list, each as (its compact row, source neuron
// src_tile(b) * tile + i of live row i of block b); destination tile d's
// entries are
// entries[tile_entries[d] .. tile_entries[d + 1]]. `out_arrived` is
// [n_tiles, tile] bytes. Every pointer is 16-byte aligned, `tile` a
// multiple of 4 up to 256. Returns the CUDA error (0 on success).
int sanafe_delivery_launch(const void* x, const void* weights,
                           const void* arrive, const void* entries,
                           const void* tile_entries, void* out_cur,
                           void* out_arrived, int n_tiles, int tile,
                           int is_double, int device, void* stream) {
  if (!valid_shape(n_tiles, tile) || device < 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(x, weights, arrive, entries, tile_entries, out_cur,
                          out_arrived, n_tiles, tile, s);
  }
  return launch<float>(x, weights, arrive, entries, tile_entries, out_cur,
                       out_arrived, n_tiles, tile, s);
}

// The CTAs a launch of the cell kernel takes for planes of n neurons on
// `device` (sanafe_delivery_cells_launch's `ctas`), or a CUDA error as its
// negative: the wrapper asks once, when a program is built.
int sanafe_delivery_cells_ctas(int n, int is_double, int device) {
  if (n <= 0 || device < 0) return -static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (is_double) {
    return mask_fits(n) ? cell_ctas<double, true>(n)
                        : cell_ctas<double, false>(n);
  }
  return mask_fits(n) ? cell_ctas<float, true>(n) : cell_ctas<float, false>(n);
}

// One delivery over the cells on `stream`, float (is_double = 0) or double,
// in one launch of `ctas` CTAs. x [n] is the fired plane; `src` (int32) and
// `weights` [slots] the cells in slices of 32 destinations, `lengths`
// (int32) [n] each destination's cells and `starts` (int64) [n_slices + 1]
// each slice's first slot (ops/delivery.py: DeliveryCells); `out_cur` [n],
// `out_arrived` [n] bytes. Returns the CUDA error (0 on success).
int sanafe_delivery_cells_launch(const void* x, const void* src,
                                 const void* weights, const void* lengths,
                                 const void* starts, void* out_cur,
                                 void* out_arrived, int n, int n_slices,
                                 int ctas, int is_double, int device,
                                 void* stream) {
  if (n <= 0 || n_slices != (n + kSlice - 1) / kSlice || ctas <= 0 ||
      device < 0 || (mask_fits(n) && ctas % kCellCluster)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return mask_fits(n)
               ? launch_cells<double, true>(x, src, weights, lengths, starts,
                                            out_cur, out_arrived, n,
                                            n_slices, ctas, s)
               : launch_cells<double, false>(x, src, weights, lengths, starts,
                                             out_cur, out_arrived, n,
                                             n_slices, ctas, s);
  }
  return mask_fits(n)
             ? launch_cells<float, true>(x, src, weights, lengths, starts,
                                         out_cur, out_arrived, n, n_slices,
                                         ctas, s)
             : launch_cells<float, false>(x, src, weights, lengths, starts,
                                          out_cur, out_arrived, n, n_slices,
                                          ctas, s);
}

const char* sanafe_delivery_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
