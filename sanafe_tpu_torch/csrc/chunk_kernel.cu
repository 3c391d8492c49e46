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
// Design: ONE persistent thread block of 1024 threads runs the whole chunk.
// Thread i owns neuron lane i and keeps its potential, input current and
// refractory count in registers across all steps; the parameter planes, the
// result row r and the [v | u] log row live in shared memory. The lhs is 0/1,
// so the matvec is a sum of the matrix rows whose lhs entry is 1: the active
// row indices are compacted in shared memory (warp ballots + a scan), then
// thread c sums column c over them in ascending row order with fp32 adds.
// No product rounds and the order is fixed, so results are deterministic from
// run to run.
//
// Bound: the matrix (at most 5 MiB) stays in the 50 MB L2 across steps, and
// each step reads its active rows (up to 2*Npad rows of M floats, ~3.5 MB for
// the 384-neuron chip) from L2 into ONE SM, behind a chain of steps that must
// run in order. So the kernel is bound by one SM's L2 read bandwidth plus the
// per-step synchronisation; spreading a step over several SMs (clusters or a
// grid sync), TMA and ballot-based bit packing are later work.
//
// Numerics match the JAX kernel: build with -fmad=false so u*decay + cur is
// not contracted into an FMA, never with --use_fast_math (it would break the
// Kahan compensation); LIF fires on v > threshold, TrueNorth on v >= threshold
// and reverse-resets on v <= reverse threshold; leak only when t > 1;
// trunc(v*64)/64 quantisation; refractory = max(0, refr - 1). Padded lanes
// have all model flags zero and never fire or update.

#include <cuda_runtime.h>

#include <cstdint>

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
};

__device__ __forceinline__ uint8_t to_byte(float x) {
  return static_cast<uint8_t>(__float2int_rn(x));
}

__global__ void __launch_bounds__(kThreads, 1) chunk_kernel(const Args a) {
  extern __shared__ float smem[];
  const int npad = a.npad;
  const int m = a.m_cols;
  float* s_par = smem;                                      // [P_USED*npad]
  float* s_res = s_par + P_USED * npad;                     // [m]
  float* s_vu = s_res + m;                                  // [2*npad]
  int* s_flag = reinterpret_cast<int*>(s_vu + 2 * npad);    // [2*npad]
  int* s_rows = s_flag + 2 * npad;                          // [2*npad]
  int* s_warp = s_rows + 2 * npad;                          // [kWarps + 1]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool own = tid < npad;

  for (int k = tid; k < P_USED * npad; k += kThreads) s_par[k] = a.params[k];

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
  __syncthreads();

  for (int j = 0; j < a.n_steps; ++j) {
    const long long t = a.t0 + j;

    // --- 1. soma update (one neuron lane per thread) ---
    if (own) {
      const float* P = s_par + tid;
#define PAR(row) P[(row) * npad]
      const bool bias_nz = fabsf(PAR(P_BIAS)) > 0.f;
      const bool force = PAR(P_FORCE) > 0.f;
      const float in_cur = valid ? cur : 0.f;
      const float add = a.add_plane ? a.add_plane[(size_t)j * npad + tid] : 0.f;
      bool fired = false, updated = false;
      float v2 = v, u2 = u, refr2 = refr;

      if (a.has_lif) {
        // LoihiLifModel::update (src/models.cpp:497-567)
        const bool upd_l = fabsf(v) > 0.f || valid || bias_nz || force;
        float u_l = t > 1 ? u * PAR(P_INPUT_DECAY) : u;
        float v_l = t > 1 ? v * PAR(P_LEAK_DECAY) : v;
        v_l = truncf(v_l * 64.f) / 64.f;
        if (a.add_plane) v_l = v_l + add;
        const bool active = !(refr > 0.f);
        const float u_new = u_l + in_cur;
        const float v_new = (v_l + PAR(P_BIAS)) + u_new;
        if (active) u_l = u_new;
        const bool fired_l = active && v_new > PAR(P_THRESH);
        float v_act = v_new;
        if (fired_l && PAR(P_RM_HARD) > 0.f) v_act = PAR(P_RESET);
        if (fired_l && PAR(P_RM_SOFT) > 0.f) v_act = v_act - PAR(P_THRESH);
        const bool rev = v_act < PAR(P_RTHRESH);
        if (rev && PAR(P_RRM_SOFT) > 0.f) v_act = v_act - PAR(P_RTHRESH);
        if (rev && PAR(P_RRM_HARD) > 0.f) v_act = PAR(P_RRESET);
        if (rev && PAR(P_RRM_SAT) > 0.f) v_act = PAR(P_RTHRESH);
        if (active) v_l = v_act;
        float refr_l = fired_l ? PAR(P_REFR_DELAY) : refr;
        refr_l = fmaxf(0.f, refr_l - 1.f);
        if (PAR(P_IS_LIF) > 0.f) {
          v2 = v_l;
          u2 = u_l;
          refr2 = refr_l;
          fired = fired || fired_l;
          updated = updated || upd_l;
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
          a.spike_plane[(size_t)j * npad + tid] > 0.f) {
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
    if (warp == 0) {
      const int count = s_warp[lane];
      int incl = count;
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += x;
      }
      s_warp[lane] = incl - count;
      if (lane == 31) s_warp[kWarps] = incl;
    }
    __syncthreads();
    if (flag) s_rows[s_warp[warp] + __popc(ballot & ((1u << lane) - 1u))] = tid;
    __syncthreads();
    const int n_rows = s_warp[kWarps];

    // --- 2b. r = lhs @ matrix + const: column sums over the active rows ---
    for (int c = tid; c < m; c += kThreads) {
      const float* col = a.matrix + c;
      float acc = 0.f;
      int k = 0;
      for (; k + 4 <= n_rows; k += 4) {
        const float x0 = __ldg(col + (size_t)s_rows[k] * m);
        const float x1 = __ldg(col + (size_t)s_rows[k + 1] * m);
        const float x2 = __ldg(col + (size_t)s_rows[k + 2] * m);
        const float x3 = __ldg(col + (size_t)s_rows[k + 3] * m);
        acc = acc + x0;
        acc = acc + x1;
        acc = acc + x2;
        acc = acc + x3;
      }
      for (; k < n_rows; ++k) acc = acc + __ldg(col + (size_t)s_rows[k] * m);
      s_res[c] = acc + __ldg(a.cst + c);
    }
    __syncthreads();

    // --- 3. consume r ---
    if (own) {
      cur = s_res[a.g_deliver + tid];
      valid = s_res[a.g_count + tid] > 0.f;
    }
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
    if (a.logs) {
      for (int k = tid; k < a.n_log; k += kThreads) {
        // + 0.f as in the JAX selection matvec: a -0.0 potential logs as 0
        a.logs[(size_t)j * a.n_log + k] = s_vu[a.log_index[k]] + 0.f;
      }
    }
    __syncthreads();  // s_vu, s_flag and s_res are rewritten next step
  }

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

// Launch one chunk on `stream`; returns cudaGetLastError() (0 on success).
int sanafe_chunk_launch(
    const void* matrix, const void* cst, const void* params,
    const void* state_in, void* state_out, const void* spike_plane,
    const void* add_plane, const void* log_index, void* counters, void* sums,
    void* masks, void* spike_log, void* logs,
    int npad, int n_cores, int m_cols, int nbytes, int sbytes, int n_log,
    int g_lat, int g_msg, int g_deliver, int g_count, int g_pack_fired,
    int g_pack_upd, int g_spike, int has_lif, int has_tn, int has_input,
    float sync_delay, long long t0, int n_steps, int device, void* stream) {
  if (2 * npad > kThreads || n_steps < 0) return cudaErrorInvalidValue;
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
  const size_t smem =
      sizeof(float) * ((size_t)P_USED * npad + m_cols + 2 * (size_t)npad) +
      sizeof(int) * (4 * (size_t)npad + kWarps + 1);
  err = cudaFuncSetAttribute(chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chunk_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* sanafe_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
