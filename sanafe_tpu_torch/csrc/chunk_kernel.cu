// Whole-chunk kernel: T timesteps of a small chip in one launch (Hopper, sm_90a).
//
// Replaces sanafe_tpu/ops/pallas_chunk.py:_kernel, the whole-chunk Pallas TPU
// kernel. The Python side (sanafe_tpu_torch/ops/chunk.py) builds the same
// extended matrix, parameter planes and input planes, and holds the plain
// PyTorch version (chunk_plain) this kernel is checked against.
//
// Per timestep t (1-based), for the Npad neuron lanes:
//   1. the LIF / TrueNorth / Input soma update (src/models.cpp:497-567,
//      724-830, 863-903), reading the per-step spike and additive-noise planes;
//   2. r = [fired | updated-or-fired] @ matrix + const, with matrix [2*Npad, M]:
//      r holds the 9 stats lanes, the per-core latency sums, the dense delivery
//      currents and arrival counts (next step's input), the fired/updated mask
//      bytes (power-of-two columns, MSB first) and the spike-log bytes;
//   3. int32 counter sums, Kahan float sums of the energies and of the simple
//      timing model's sim_time = max(per-core sums) + sync delay, and the
//      per-step outputs (mask bytes, spike-log bytes, potential/u log).
//
// Design: ONE thread-block cluster of C CTAs (1024 threads each, C up to 16)
// runs the whole chunk, and the step-to-step hand-off never leaves the chip.
//
// What bounds a step is the matvec: the lhs is 0/1, so r is the sum of the
// matrix rows whose lhs entry is 1 (up to 2*Npad rows of M floats, 4.7 MB for
// the 384-neuron chip, resident in the 50 MB L2), summed per column in
// ascending row order by ONE accumulator so that the result is bit-identical
// to a serial sum (no product rounds, the order is fixed). The design
// spreads that over the cluster and takes the loads out of the serial chain:
//
// - CTA q owns a slice of the matrix's columns (16-byte chunks of 4 columns,
//   ceil(M/4 / C) chunks a CTA) and reads only that slice from L2.
// - The slice's active rows are copied in panels of P rows into a ring of
//   three shared-memory buffers with cp.async by all 1024 threads, two
//   panels ahead of the adds, one __syncthreads a panel. One thread per
//   column then adds the panel's rows from shared memory in row order: the
//   dependent chain is an fp32 add per row, not an L2 round trip per row.
// - The soma update and the compaction of the active rows (at most 512
//   lanes; warp ballots + a scan) are cheap, so every CTA repeats them
//   identically in its own shared memory and registers: thread i owns
//   neuron lane i and keeps its potential, input current and refractory
//   count in registers across all steps.
// - The only exchange a step: each CTA writes its slice of r into every
//   CTA's shared memory (distributed shared memory, map_shared_rank), into
//   one of two r buffers by step parity, then ONE hardware cluster barrier.
//   A CTA can run at most one barrier ahead of its slowest peer, so the
//   buffer written in step j+2 is no longer read by anyone from step j.
// - Rank 0 keeps the counters, the Kahan sums and the per-step outputs.
//
// The cluster size comes from the caller (ops/chunk.py picks it from the
// chip's size: a tiny chip's step is bound by its barriers and round trips,
// gains nothing from 16 CTAs and would pay the cluster barrier, so it runs on
// a cluster of one, which synchronises with __syncthreads); ragged slices,
// empty slices and C = 1 are all the same code.
//
// What is left: a cluster lies within one GPC, and the 16 CTAs together read
// the matrix from L2 at about 0.67 TB/s (4.7 MB in 7 us of the 384-neuron
// chip's 10 us step, measured on an H100), so the step is now bound by that
// path and not by the adds. The matrix does not fit the cluster's shared
// memory in float32 (4.7 MB against 16 x 227 KB); a grid over all GPCs with
// the matrix resident in shared memory is the design that would lift it.
//
// Numerics match the JAX kernel: build with -fmad=false so u*decay + cur is
// not contracted into an FMA, never with --use_fast_math (it would break the
// Kahan compensation); LIF fires on v > threshold, TrueNorth on v >= threshold
// and reverse-resets on v <= reverse threshold; leak only when t > 1;
// trunc(v*64)/64 quantisation; refractory = max(0, refr - 1). Padded lanes
// have all model flags zero and never fire or update.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "kernel_attrs.cuh"
#include "lif_update.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Parameter-plane rows, as in ops/chunk.py (rows 20..23 are padding)
enum {
  P_BIAS, P_LEAK_DECAY, P_INPUT_DECAY, P_THRESH, P_RTHRESH, P_RESET,
  P_RRESET, P_REFR_DELAY, P_FORCE, P_IS_LIF, P_IS_TN, P_IS_INPUT,
  P_LEAK, P_LEAK_TZ, P_RM_HARD, P_RM_SOFT, P_RM_SAT, P_RRM_HARD,
  P_RRM_SOFT, P_RRM_SAT, P_USED
};
// State rows
enum { S_V, S_U, S_REFR, S_CUR, S_VALID, S_ROWS = 8 };

constexpr int kCounters = 5;  // spike_ops, packets, hops, updated, fired
constexpr int kSums = 5;      // synapse, dendrite, soma, network, sim_time

struct Args {
  const float* matrix;       // [2*npad, m_cols]
  const float* cst;          // [m_cols]
  const float* params;       // [24, npad]
  const float* state_in;     // [8, npad]
  float* state_out;          // [8, npad]
  const float* spike_plane;  // [T, npad] or null
  const float* add_plane;    // [T, npad] or null
  const int* log_index;      // [n_log] indices into [v | u]
  int* counters;             // [5]
  float* sums;               // [5] Kahan best estimates (acc - comp)
  uint8_t* masks;            // [T, 2, nbytes] or null
  uint8_t* spike_log;        // [T, sbytes] or null
  float* logs;               // [T, n_log] or null
  int npad, n_cores, m_cols, nbytes, sbytes, n_log;
  int g_lat, g_msg, g_deliver, g_count, g_pack_fired, g_pack_upd, g_spike;
  int has_lif, has_tn, has_input;
  float sync_delay;
  long long t0;
  int n_steps;
  // matvec tiling: 16-byte column chunks per CTA, threads per panel row
  // (a power of two >= chunks_per_cta), rows per panel
  int chunks_per_cta, row_threads, panel_rows;
};

constexpr int kPanels = 3;       // ring of panel buffers
constexpr int kColsPerThread = 2;  // a CTA's slice is at most 2048 columns

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint8_t to_byte(float x) {
  return static_cast<uint8_t>(__float2int_rn(x));
}

__global__ void __launch_bounds__(kThreads, 1) chunk_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int npad = a.npad;
  const int m = a.m_cols;
  // this CTA's column slice [c0, c0 + w)
  const int m4 = m / 4;
  const int chunk0 = min(rank * a.chunks_per_cta, m4);
  const int w4 = min(a.chunks_per_cta, m4 - chunk0);
  const int c0 = 4 * chunk0;
  const int w = 4 * w4;
  const int panel_elems = a.panel_rows * 4 * a.chunks_per_cta;
  float* s_panel = reinterpret_cast<float*>(smem4);  // [kPanels][panel_elems]
  float* s_par = s_panel + kPanels * panel_elems;           // [P_USED*npad]
  float* s_res2 = s_par + P_USED * npad;                    // [2][m]
  float* s_vu = s_res2 + 2 * m;                             // [2*npad]
  int* s_flag = reinterpret_cast<int*>(s_vu + 2 * npad);    // [2*npad]
  int* s_rows = s_flag + 2 * npad;                          // [2*npad]
  int* s_warp = s_rows + 2 * npad;                          // [kWarps]
  int* s_logidx = s_warp + kWarps;                          // [n_log]
  const bool lead = rank == 0;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool own = tid < npad;

  for (int k = tid; k < P_USED * npad; k += kThreads) s_par[k] = a.params[k];
  if (lead && a.logs) {
    for (int k = tid; k < a.n_log; k += kThreads) s_logidx[k] = a.log_index[k];
  }
  // the constant row's entries of this thread's columns
  float cst[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) {
    const int c = tid + i * kThreads;
    cst[i] = c < w ? a.cst[c0 + c] : 0.f;
  }
  // a single CTA needs no cluster barrier (it costs more than a CTA's own)
  auto step_barrier = [&]() {
    if (n_ranks > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
  };

  // neuron lane state, carried in registers across the chunk
  float v = 0.f, u = 0.f, refr = 0.f, cur = 0.f;
  bool valid = false;
  if (own) {
    v = a.state_in[S_V * npad + tid];
    u = a.state_in[S_U * npad + tid];
    refr = a.state_in[S_REFR * npad + tid];
    cur = a.state_in[S_CUR * npad + tid];
    valid = a.state_in[S_VALID * npad + tid] > 0.f;
  }
  // warp 0: lanes 0..4 hold the counter sums, lanes 5..9 the Kahan sums
  int acc_i = 0;
  float acc_f = 0.f, comp_f = 0.f;
  // the panel copy: thread (ty, tx) copies chunk tx of rows ty, ty + pass, ...
  const int tx = tid & (a.row_threads - 1);
  const int ty = tid / a.row_threads;
  const int pass = kThreads / a.row_threads;
  // this lane's input-plane entries, read one step ahead of their use so
  // that no global load sits on a step's critical path
  const bool read_add = own && a.add_plane;
  const bool read_spike = own && a.has_input && a.spike_plane;
  float next_add = read_add && a.n_steps > 0 ? a.add_plane[tid] : 0.f;
  float next_spike = read_spike && a.n_steps > 0 ? a.spike_plane[tid] : 0.f;
  // every CTA's shared memory exists before anyone writes into it
  cluster.sync();

  for (int j = 0; j < a.n_steps; ++j) {
    const long long t = a.t0 + j;
    float* s_res = s_res2 + (j & 1) * m;
    const float add = next_add;
    const float spike = next_spike;
    if (j + 1 < a.n_steps) {
      if (read_add) next_add = a.add_plane[(size_t)(j + 1) * npad + tid];
      if (read_spike) next_spike = a.spike_plane[(size_t)(j + 1) * npad + tid];
    }

    // --- 1. soma update (one neuron lane per thread) ---
    if (own) {
      const float* P = s_par + tid;
#define PAR(row) P[(row) * npad]
      const bool bias_nz = fabsf(PAR(P_BIAS)) > 0.f;
      const bool force = PAR(P_FORCE) > 0.f;
      const float in_cur = valid ? cur : 0.f;
      bool fired = false, updated = false;
      float v2 = v, u2 = u, refr2 = refr;

      if (a.has_lif) {
        // LoihiLifModel::update (src/models.cpp:497-567; lif_update.cuh)
        LifParams<float> lp;
        lp.bias = PAR(P_BIAS);
        lp.leak_decay = PAR(P_LEAK_DECAY);
        lp.input_decay = PAR(P_INPUT_DECAY);
        lp.threshold = PAR(P_THRESH);
        lp.reverse_threshold = PAR(P_RTHRESH);
        lp.reset = PAR(P_RESET);
        lp.reverse_reset = PAR(P_RRESET);
        lp.refractory_delay = PAR(P_REFR_DELAY);
        lp.force = force;
        lp.rm_hard = PAR(P_RM_HARD) > 0.f;
        lp.rm_soft = PAR(P_RM_SOFT) > 0.f;
        lp.rrm_hard = PAR(P_RRM_HARD) > 0.f;
        lp.rrm_soft = PAR(P_RRM_SOFT) > 0.f;
        lp.rrm_sat = PAR(P_RRM_SAT) > 0.f;
        const LifStep<float> l =
            lif_step(lp, v, u, refr, valid, cur, t, a.add_plane != nullptr,
                     add);
        if (PAR(P_IS_LIF) > 0.f) {
          v2 = l.v;
          u2 = l.u;
          refr2 = l.refractory;
          fired = fired || l.fired;
          updated = updated || l.updated;
        }
      }

      if (a.has_tn) {
        // TrueNorthModel::update (src/models.cpp:724-830)
        const bool upd_t = fabsf(v) > 0.f || valid || bias_nz || force;
        const float leak = PAR(P_LEAK);
        const float leak_tz = v > 0.f ? v - leak : (v < 0.f ? v + leak : v);
        float v_t = PAR(P_LEAK_TZ) > 0.f ? leak_tz : v + leak;
        v_t = (v_t + PAR(P_BIAS)) + in_cur;
        const float v_cmp = a.add_plane ? v_t + add : v_t;
        const bool fired_t = v_cmp >= PAR(P_THRESH);
        float v_after = v_t;
        if (fired_t && PAR(P_RM_HARD) > 0.f) v_after = PAR(P_RESET);
        if (fired_t && PAR(P_RM_SOFT) > 0.f) v_after = v_t - PAR(P_THRESH);
        if (fired_t && PAR(P_RM_SAT) > 0.f) v_after = PAR(P_THRESH);
        const bool rev_t = !fired_t && v_cmp <= PAR(P_RTHRESH);
        if (rev_t && PAR(P_RRM_HARD) > 0.f) v_after = PAR(P_RRESET);
        if (rev_t && PAR(P_RRM_SOFT) > 0.f) v_after = v_t + PAR(P_RTHRESH);
        if (rev_t && PAR(P_RRM_SAT) > 0.f) v_after = PAR(P_RTHRESH);
        if (PAR(P_IS_TN) > 0.f) {
          v2 = v_after;
          fired = fired || fired_t;
          updated = updated || upd_t;
        }
      }

      if (a.has_input && a.spike_plane && PAR(P_IS_INPUT) > 0.f &&
          spike > 0.f) {
        fired = true;
      }
#undef PAR
      v = v2;
      u = u2;
      refr = refr2;
      s_flag[tid] = fired;
      s_flag[npad + tid] = fired || updated;
      s_vu[tid] = v;
      s_vu[npad + tid] = u;
    }
    __syncthreads();

    // --- 2a. compact the active lhs rows, in ascending order ---
    const int flag = tid < 2 * npad ? s_flag[tid] : 0;
    const unsigned ballot = __ballot_sync(kFull, flag);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    // every warp scans the 32 warp counts itself: no third barrier
    const int count = s_warp[lane];
    int incl = count;
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    const int n_rows = __shfl_sync(kFull, incl, 31);
    const int warp_base = __shfl_sync(kFull, incl - count, warp);
    if (flag) s_rows[warp_base + __popc(ballot & ((1u << lane) - 1u))] = tid;
    if (lead && a.logs) {
      // s_vu is stable until the next step's soma update, past the barrier
      for (int k = tid; k < a.n_log; k += kThreads) {
        // + 0.f as in the JAX selection matvec: a -0.0 potential logs as 0
        a.logs[(size_t)j * a.n_log + k] = s_vu[s_logidx[k]] + 0.f;
      }
    }
    __syncthreads();

    // --- 2b. r = lhs @ matrix + const on this CTA's columns: panels of the
    // active rows through shared memory, then column sums in row order ---
    const int n_panels = (n_rows + a.panel_rows - 1) / a.panel_rows;
    auto copy_panel = [&](int q) {
      if (q < n_panels && tx < w4) {
        float* buf = s_panel + (q % kPanels) * panel_elems;
        const int k0 = q * a.panel_rows;
        const int k1 = min(n_rows, k0 + a.panel_rows);
        for (int k = k0 + ty; k < k1; k += pass) {
          cp_async_16(buf + (size_t)(k - k0) * w + 4 * tx,
                      a.matrix + (size_t)s_rows[k] * m + c0 + 4 * tx);
        }
      }
      cp_async_commit();  // one group a panel, empty or not
    };
    float acc[kColsPerThread];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.f;
    copy_panel(0);
    copy_panel(1);
    for (int q = 0; q < n_panels; ++q) {
      cp_async_wait<1>();  // this thread's copies of panel q landed
      __syncthreads();     // everyone's did; panel q - 1 is fully summed
      copy_panel(q + 2);   // into the buffer panel q - 1 used
      const float* buf = s_panel + (q % kPanels) * panel_elems;
      const int rows_q = min(a.panel_rows, n_rows - q * a.panel_rows);
#pragma unroll
      for (int i = 0; i < kColsPerThread; ++i) {
        const int c = tid + i * kThreads;
        if (c < w) {
          const float* col = buf + c;
          float sum = acc[i];
          int k = 0;
          for (; k + 8 <= rows_q; k += 8) {
            float x[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) x[u] = col[(size_t)(k + u) * w];
#pragma unroll
            for (int u = 0; u < 8; ++u) sum = sum + x[u];
          }
          for (; k < rows_q; ++k) sum = sum + col[(size_t)k * w];
          acc[i] = sum;
        }
      }
    }
    cp_async_wait<0>();
    // every CTA gets this slice of r, in the buffer of this step's parity
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int c = tid + i * kThreads;
      if (c < w) {
        const float value = acc[i] + cst[i];
        if (n_ranks == 1) {
          s_res[c0 + c] = value;
        } else {
          for (int peer = 0; peer < n_ranks; ++peer) {
            cluster.map_shared_rank(s_res, peer)[c0 + c] = value;
          }
        }
      }
    }
    // the one exchange of the step; also orders this CTA's own reads of
    // s_flag, s_rows, s_vu and the panels before the next step's writes
    step_barrier();

    // --- 3. consume r ---
    if (own) {
      cur = s_res[a.g_deliver + tid];
      valid = s_res[a.g_count + tid] > 0.f;
    }
    if (!lead) continue;
    if (warp == 0) {
      float mx = __int_as_float(0xff800000);  // -inf
      for (int c = lane; c < a.n_cores; c += 32) {
        mx = fmaxf(mx, fmaxf(s_res[a.g_lat + c], s_res[a.g_msg + c]));
      }
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float sim_time = mx + a.sync_delay;
      if (lane < kCounters) {
        acc_i += __float2int_rn(s_res[lane]);
      } else if (lane < kCounters + kSums) {
        const float en = lane < kCounters + kSums - 1 ? s_res[lane] : sim_time;
        const float y = en - comp_f;
        const float tn = acc_f + y;
        comp_f = (tn - acc_f) - y;
        acc_f = tn;
      }
    }
    if (a.masks) {
      uint8_t* row = a.masks + (size_t)j * 2 * a.nbytes;
      for (int b = tid; b < 2 * a.nbytes; b += kThreads) {
        row[b] = to_byte(b < a.nbytes ? s_res[a.g_pack_fired + b]
                                      : s_res[a.g_pack_upd + b - a.nbytes]);
      }
    }
    if (a.spike_log) {
      for (int b = tid; b < a.sbytes; b += kThreads) {
        a.spike_log[(size_t)j * a.sbytes + b] = to_byte(s_res[a.g_spike + b]);
      }
    }
  }

  if (!lead) return;
  if (own) {
    float* so = a.state_out;
    so[S_V * npad + tid] = v;
    so[S_U * npad + tid] = u;
    so[S_REFR * npad + tid] = refr;
    so[S_CUR * npad + tid] = cur;
    so[S_VALID * npad + tid] = valid ? 1.f : 0.f;
    for (int r = S_VALID + 1; r < S_ROWS; ++r) so[r * npad + tid] = 0.f;
  }
  if (warp == 0) {
    if (lane < kCounters) {
      a.counters[lane] = acc_i;
    } else if (lane < kCounters + kSums) {
      a.sums[lane - kCounters] = acc_f - comp_f;  // Kahan best estimate
    }
  }
}

}  // namespace

extern "C" {

// Launch one chunk on `stream` as one cluster of `cluster` CTAs (1..16; above
// 8 is the non-portable cluster size Hopper allows); returns the CUDA error
// (0 on success).
int sanafe_chunk_launch(
    const void* matrix, const void* cst, const void* params,
    const void* state_in, void* state_out, const void* spike_plane,
    const void* add_plane, const void* log_index, void* counters, void* sums,
    void* masks, void* spike_log, void* logs,
    int npad, int n_cores, int m_cols, int nbytes, int sbytes, int n_log,
    int g_lat, int g_msg, int g_deliver, int g_count, int g_pack_fired,
    int g_pack_upd, int g_spike, int has_lif, int has_tn, int has_input,
    float sync_delay, long long t0, int n_steps, int cluster, int device,
    void* stream) {
  if (2 * npad > kThreads || n_steps < 0 || m_cols % 4 != 0 || cluster < 1 ||
      cluster > 16) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  a.matrix = static_cast<const float*>(matrix);
  a.cst = static_cast<const float*>(cst);
  a.params = static_cast<const float*>(params);
  a.state_in = static_cast<const float*>(state_in);
  a.state_out = static_cast<float*>(state_out);
  a.spike_plane = static_cast<const float*>(spike_plane);
  a.add_plane = static_cast<const float*>(add_plane);
  a.log_index = static_cast<const int*>(log_index);
  a.counters = static_cast<int*>(counters);
  a.sums = static_cast<float*>(sums);
  a.masks = static_cast<uint8_t*>(masks);
  a.spike_log = static_cast<uint8_t*>(spike_log);
  a.logs = static_cast<float*>(logs);
  a.npad = npad;
  a.n_cores = n_cores;
  a.m_cols = m_cols;
  a.nbytes = nbytes;
  a.sbytes = sbytes;
  a.n_log = n_log;
  a.g_lat = g_lat;
  a.g_msg = g_msg;
  a.g_deliver = g_deliver;
  a.g_count = g_count;
  a.g_pack_fired = g_pack_fired;
  a.g_pack_upd = g_pack_upd;
  a.g_spike = g_spike;
  a.has_lif = has_lif;
  a.has_tn = has_tn;
  a.has_input = has_input;
  a.sync_delay = sync_delay;
  a.t0 = t0;
  a.n_steps = n_steps;
  // matvec tiling: each CTA's slice of 16-byte column chunks, a power-of-two
  // row of copy threads over it, and panels of up to 48 KB
  const int m4 = m_cols / 4;
  a.chunks_per_cta = (m4 + cluster - 1) / cluster;
  if (4 * a.chunks_per_cta > kColsPerThread * kThreads) {
    return cudaErrorInvalidValue;
  }
  a.row_threads = 1;
  while (a.row_threads < a.chunks_per_cta) a.row_threads *= 2;
  const int pass = kThreads / a.row_threads;
  const int budget_rows = (48 << 10) / (16 * a.chunks_per_cta);
  a.panel_rows = pass * (budget_rows / pass > 0 ? budget_rows / pass : 1);
  const size_t smem =
      sizeof(float) * ((size_t)kPanels * a.panel_rows * 4 * a.chunks_per_cta +
                       (size_t)P_USED * npad + 2 * (size_t)m_cols +
                       2 * (size_t)npad) +
      sizeof(int) * (4 * (size_t)npad + kWarps + (size_t)n_log);
  err = sanafe::reserve_smem(reinterpret_cast<const void*>(&chunk_kernel),
                             smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = sanafe::set_kernel_attribute(
        reinterpret_cast<const void*>(&chunk_kernel),
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(cluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, chunk_kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

const char* sanafe_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
