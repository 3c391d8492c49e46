// The neuron phase and the roll-up of one step of the step scan, in one
// launch (Hopper, sm_90a).
//
// Replaces no Pallas kernel. sanafe_tpu's step (sanafe_tpu/ops/step.py:
// _lif_update and _rollup_aggregates) gets its neuron phase and its stats
// row from XLA, which fuses the LIF update, the merges and the reductions
// into a few loops. The port's PyTorch route (sanafe_tpu_torch/ops/step.py:
// _lif_update, _rollup_aggregates) runs them as ~70 launches that write and
// re-read the planes, and two products against dense [N, n_cores] float32
// matrices (the core one-hot and the per-neuron message latencies: 128 MiB a
// step on a 131,072-neuron chip). That route stays the plain version this
// kernel is held to (tests/test_torch_neuron_kernel.py); the Python side is
// sanafe_tpu_torch/ops/neuron.py.
//
// Per step t (read from device memory, so a captured graph replays the
// launch for the step the tensor then holds), CTA c takes the neurons of
// core c, a run of slots (the compiler lays slots out core-major, whatever
// the network's mapping):
//
// 1. Update. Each lane runs lif_update.cuh's lif_step (bit-equal to
//    ops/step.py:lif_step under -fmad=false) on its neuron's potential,
//    input current, refractory count, current and arrival flag, and writes
//    the new state, the fired and updated-or-fired bytes and the fired
//    plane in float32 straight into the delivery's padded tile buffer (its
//    padding zeroed here). It adds its neurons' counters (spike_ops,
//    packets, hops, updated, fired) in int64 and their energies (synapse,
//    dendrite, soma, network) and neuron-processing latency in float64.
// 2. Message latencies. The messages whose source lies in core c are listed
//    once (ops/neuron.py:message_plan), one entry a (source neuron,
//    destination core) pair holding the pair's summed processing latency,
//    grouped by destination core into segments. With the core's fired flags
//    in shared memory, a group of kGroup lanes sums a segment's fired
//    entries in float64 and stores the sum in the segment's slot of a
//    destination-major array.
// 3. Partials, no float atomics. Each CTA writes its sums to its own slots;
//    the last CTA to finish (a counter and a fence) adds them in a fixed
//    order, a group of lanes a column (each counter or energy over the
//    CTAs) or a destination core (its neuron latency and its segments'
//    message latencies, contiguous). It takes sim_time = max(max_core
//    neuron latency, max_core message latency) + sync delay in float64,
//    rounds each value of the [11] stats row once to float32, keeps the
//    per-core sums (core_lat), and resets the counter. So the row is the
//    same bits on every run, and closer to the float64 sums than float32
//    tree sums.
//
// What bounds it: the latency of its chains more than its bytes. A step
// needs the state read and written (28 B a neuron), three flags a neuron
// and a message latency a fired message; it also reads ~85 B of
// per-neuron parameters and 8 B a listed message. On the 131,072-neuron
// chip that is ~23 MB, ~7 us at 3.35 TB/s, where the PyTorch route spent
// ~290 us. Its three phases (update, segment sums, the last CTA's sums)
// run one after another, each a few dependent loads: on an H100 it takes
// ~14 us a step on the 32,768-neuron chip and ~17 us on the 131,072-neuron
// one. A thread that walked the 128 CTAs' partials (and a destination's
// 128 segments through an index) alone took ~60 us a step, so every sum
// over memory is split over a group of lanes, each lane's share in a fixed
// order, the group's shares added by a fixed butterfly of shuffles.
//
// Build with -fmad=false (ops/cuda_build.py).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "lif_update.cuh"

namespace {

// NeuronResetMode (sanafe_tpu_torch/arch.py)
constexpr int kSoft = 1;
constexpr int kHard = 2;
constexpr int kSaturate = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
// lanes that share one sum over memory: a segment, a column, a core
constexpr int kGroup = 8;
// counters: spike_ops, packets, hops, updated, fired
constexpr int kCounts = 5;
// float64 sums: synapse, dendrite, soma, network energy; neuron latency
constexpr int kSums = 5;

struct Args {
  // LIF parameters [n], slot order
  const float* bias;
  const float* leak_decay;
  const float* input_decay;
  const float* threshold;
  const float* reverse_threshold;
  const float* reset;
  const float* reverse_reset;
  const int* refractory_delay;
  const int* reset_mode;
  const int* reverse_reset_mode;
  const uint8_t* force;
  // roll-up coefficients [n]
  const int* spike_ops;
  const int* n_axons;
  const int* hops;
  const float* synapse_energy;
  const float* dendrite_energy;
  const float* soma_update_energy;
  const float* soma_spike_energy;
  const float* network_energy;
  const float* lat_update;
  const float* lat_spike;
  const float* lat_out;
  // the state before the step [n]
  const float* v;
  const float* u;
  const int* r;
  const float* cur;
  const uint8_t* valid;
  // the state after it [n]
  float* v_out;
  float* u_out;
  int* r_out;
  // fired and updated-or-fired [n], the fired plane [n_pad], the stats [11]
  uint8_t* fired;
  uint8_t* updated;
  float* fired_pad;
  float* stats;
  // the plan (ops/neuron.py:message_plan)
  const int* core_start;  // [n_cores + 1] each core's run of slots
  const double* gen_const;  // [n_cores] constant neuron latency of a core
  const int* seg_start;   // [n_cores + 1] segments of each source core
  const int* seg_entry;   // [n_seg + 1]
  const int* msg_src;     // [n_msg] the source's place in its core's run
  const float* msg_lat;   // [n_msg]
  const int* dest_start;  // [n_cores + 1] each destination's slots
  const int* seg_slot;    // [n_seg] a segment's slot: by destination, then
                          // source core
  // scratch and results
  long long* part_count;  // [kCounts, n_cores]
  double* part_sum;       // [kSums, n_cores]
  double* part_seg;       // [n_seg], in slot order
  double* core_lat;       // [2, n_cores]: neuron, message latency sums
  unsigned* done;         // [1], 0 between launches
  const long long* t;     // the 1-based step []
  double energy_const[4];
  double sync_delay;
  int n, n_pad, n_cores;
};

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(kAll, x, off);
  return x;
}

// The sum over one group's kGroup lanes (`mask` the group's lanes), by a
// fixed butterfly: every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T group_sum(T x, unsigned mask) {
#pragma unroll
  for (int off = kGroup / 2; off; off >>= 1) {
    x += __shfl_xor_sync(mask, x, off, kGroup);
  }
  return x;
}

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmax(x, __shfl_xor_sync(kAll, x, off));
  return x;
}

__global__ void __launch_bounds__(kMaxThreads)
    neuron_kernel(const Args a) {
  extern __shared__ uint8_t fired_s[];  // the core's fired flags
  __shared__ long long warp_count[kMaxWarps][kCounts];
  __shared__ double warp_sum_s[kMaxWarps][kSums];
  __shared__ double warp_peak[kMaxWarps];
  __shared__ long long total_count[kCounts];
  __shared__ double total_sum[kSums];
  __shared__ bool last;
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int lo = a.core_start[c], hi = a.core_start[c + 1];
  const long long t = *a.t;

  // 1. the update of the core's neurons
  long long count[kCounts] = {0, 0, 0, 0, 0};
  double sum[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = lo + tid; i < hi; i += blockDim.x) {
    LifParams<int> p;
    p.bias = a.bias[i];
    p.leak_decay = a.leak_decay[i];
    p.input_decay = a.input_decay[i];
    p.threshold = a.threshold[i];
    p.reverse_threshold = a.reverse_threshold[i];
    p.reset = a.reset[i];
    p.reverse_reset = a.reverse_reset[i];
    p.refractory_delay = a.refractory_delay[i];
    p.force = a.force[i] != 0;
    const int rm = a.reset_mode[i];
    const int rrm = a.reverse_reset_mode[i];
    p.rm_hard = rm == kHard;
    p.rm_soft = rm == kSoft;
    p.rrm_hard = rrm == kHard;
    p.rrm_soft = rrm == kSoft;
    p.rrm_sat = rrm == kSaturate;
    // the roll-up's coefficients, loaded with the state (one round trip)
    const int spike_ops = a.spike_ops[i], n_axons = a.n_axons[i],
              hops = a.hops[i];
    const float synapse_e = a.synapse_energy[i],
                dendrite_e = a.dendrite_energy[i],
                update_e = a.soma_update_energy[i],
                spike_e = a.soma_spike_energy[i],
                network_e = a.network_energy[i],
                lat_update = a.lat_update[i], lat_spike = a.lat_spike[i],
                lat_out = a.lat_out[i];
    const LifStep<int> s = lif_step(p, a.v[i], a.u[i], a.r[i],
                                    a.valid[i] != 0, a.cur[i], t, false, 0.f);
    const bool upd = s.updated || s.fired;
    a.v_out[i] = s.v;
    a.u_out[i] = s.u;
    a.r_out[i] = s.refractory;
    a.fired[i] = s.fired;
    a.updated[i] = upd;
    a.fired_pad[i] = s.fired ? 1.f : 0.f;
    fired_s[i - lo] = s.fired;
    if (upd) {
      count[3] += 1;
      sum[2] += static_cast<double>(update_e);
      sum[4] += static_cast<double>(lat_update);
    }
    if (s.fired) {
      count[0] += spike_ops;
      count[1] += n_axons;
      count[2] += hops;
      count[4] += 1;
      sum[0] += static_cast<double>(synapse_e);
      sum[1] += static_cast<double>(dendrite_e);
      sum[2] += static_cast<double>(spike_e);
      sum[3] += static_cast<double>(network_e);
      sum[4] += static_cast<double>(lat_spike);
      sum[4] += static_cast<double>(lat_out);
    }
  }
  for (int i = a.n + c * blockDim.x + tid; i < a.n_pad;
       i += gridDim.x * blockDim.x) {
    a.fired_pad[i] = 0.f;
  }
  // the CTA's sums, in a fixed order: a butterfly a warp, then the warps
#pragma unroll
  for (int k = 0; k < kCounts; ++k) count[k] = warp_sum(count[k]);
#pragma unroll
  for (int k = 0; k < kSums; ++k) sum[k] = warp_sum(sum[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kCounts; ++k) warp_count[warp][k] = count[k];
#pragma unroll
    for (int k = 0; k < kSums; ++k) warp_sum_s[warp][k] = sum[k];
  }
  __syncthreads();  // also completes fired_s
  if (tid < kCounts) {
    long long x = 0;
    for (int w = 0; w < n_warps; ++w) x += warp_count[w][tid];
    a.part_count[tid * a.n_cores + c] = x;
  } else if (tid < kCounts + kSums) {
    const int k = tid - kCounts;
    double x = 0.0;
    for (int w = 0; w < n_warps; ++w) x += warp_sum_s[w][k];
    a.part_sum[k * a.n_cores + c] = x;
  }

  // 2. the latencies of the messages out of this core, a group a segment
  const int j = tid % kGroup, group = tid / kGroup;
  const int n_groups = blockDim.x / kGroup;
  const unsigned mask = 0xffu << (lane & ~(kGroup - 1));
  for (int s = a.seg_start[c] + group; s < a.seg_start[c + 1];
       s += n_groups) {
    const int end = a.seg_entry[s + 1];
    double x = 0.0;
#pragma unroll 4
    for (int k = a.seg_entry[s] + j; k < end; k += kGroup) {
      const float lat = a.msg_lat[k];
      if (fired_s[a.msg_src[k]]) x += static_cast<double>(lat);
    }
    x = group_sum(x, mask);
    if (j == 0) a.part_seg[a.seg_slot[s]] = x;
  }

  // 3. the last CTA adds the partials: a group a counter or energy column,
  // then a group a destination core
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_cores = a.n_cores;
  double peak = -INFINITY;
  for (int item = group; item < kCounts + 4 + n_cores; item += n_groups) {
    if (item < kCounts) {
      const long long* col = a.part_count + item * n_cores;
      long long x = 0;
      for (int b = j; b < n_cores; b += kGroup) x += __ldcg(col + b);
      x = group_sum(x, mask);
      if (j == 0) total_count[item] = x;
    } else if (item < kCounts + 4) {
      const int k = item - kCounts;
      const double* col = a.part_sum + k * n_cores;
      double x = 0.0;
      for (int b = j; b < n_cores; b += kGroup) x += __ldcg(col + b);
      x = group_sum(x, mask);
      if (j == 0) total_sum[k] = x + a.energy_const[k];
    } else {
      const int d = item - kCounts - 4;
      const int end = a.dest_start[d + 1];
      double msg = 0.0;
#pragma unroll 4
      for (int q = a.dest_start[d] + j; q < end; q += kGroup) {
        msg += __ldcg(a.part_seg + q);
      }
      msg = group_sum(msg, mask);
      if (j == 0) {
        const double gen = __ldcg(a.part_sum + 4 * n_cores + d) +
                           a.gen_const[d];
        a.core_lat[d] = gen;
        a.core_lat[n_cores + d] = msg;
        peak = fmax(peak, fmax(gen, msg));
      }
    }
  }
  peak = warp_max(peak);
  if (lane == 0) warp_peak[warp] = peak;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < n_warps; ++w) peak = fmax(peak, warp_peak[w]);
    for (int k = 0; k < kCounts; ++k) {
      a.stats[k] = static_cast<float>(total_count[k]);
    }
    for (int k = 0; k < 4; ++k) {
      a.stats[kCounts + k] = static_cast<float>(total_sum[k]);
    }
    a.stats[9] = static_cast<float>(total_sum[0] + total_sum[1] +
                                    total_sum[2] + total_sum[3]);
    a.stats[10] = static_cast<float>(peak + a.sync_delay);
    *a.done = 0u;
  }
}

}  // namespace

extern "C" {

// Launch one step on `stream` (no synchronisation). `ptrs` holds the Args
// pointers in declaration order from `bias` to `t` (48 of them); `consts`
// the four energy constants and the sync delay. `threads` is a multiple of
// 64 up to 512 and `smem` the largest core's neurons (its fired flags).
// Returns the CUDA error code (0 = ok).
int sanafe_neuron_launch(const void* const* ptrs, const double* consts,
                         int n, int n_pad, int n_cores, int threads, int smem,
                         int device, void* stream) {
  if (n <= 0 || n_pad < n || n_cores <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 64 || smem < 0 || smem > 40960) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Args a;
  int k = 0;
  auto in = [&](auto& field) {
    field = static_cast<std::remove_reference_t<decltype(field)>>(ptrs[k++]);
  };
  auto out = [&](auto& field) {
    field = static_cast<std::remove_reference_t<decltype(field)>>(
        const_cast<void*>(ptrs[k++]));
  };
  in(a.bias);
  in(a.leak_decay);
  in(a.input_decay);
  in(a.threshold);
  in(a.reverse_threshold);
  in(a.reset);
  in(a.reverse_reset);
  in(a.refractory_delay);
  in(a.reset_mode);
  in(a.reverse_reset_mode);
  in(a.force);
  in(a.spike_ops);
  in(a.n_axons);
  in(a.hops);
  in(a.synapse_energy);
  in(a.dendrite_energy);
  in(a.soma_update_energy);
  in(a.soma_spike_energy);
  in(a.network_energy);
  in(a.lat_update);
  in(a.lat_spike);
  in(a.lat_out);
  in(a.v);
  in(a.u);
  in(a.r);
  in(a.cur);
  in(a.valid);
  out(a.v_out);
  out(a.u_out);
  out(a.r_out);
  out(a.fired);
  out(a.updated);
  out(a.fired_pad);
  out(a.stats);
  in(a.core_start);
  in(a.gen_const);
  in(a.seg_start);
  in(a.seg_entry);
  in(a.msg_src);
  in(a.msg_lat);
  in(a.dest_start);
  in(a.seg_slot);
  out(a.part_count);
  out(a.part_sum);
  out(a.part_seg);
  out(a.core_lat);
  out(a.done);
  in(a.t);
  for (int j = 0; j < 4; ++j) a.energy_const[j] = consts[j];
  a.sync_delay = consts[4];
  a.n = n;
  a.n_pad = n_pad;
  a.n_cores = n_cores;
  neuron_kernel<<<n_cores, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}

const char* sanafe_neuron_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
