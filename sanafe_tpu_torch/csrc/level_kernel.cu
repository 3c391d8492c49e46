// Per-level LIF recurrence of the feed-forward (DAG) engine (Hopper, sm_90a).
//
// The DAG engine (sanafe_tpu_torch/ops/dag_chunk.py) runs a feed-forward
// chip level by level: the input of a whole level for a whole chunk is
// computed at once (a batched convolution, batched block delivery), and what
// is left sequential is each level's membrane recurrence over the chunk's T
// steps. sanafe_tpu runs that recurrence as a lax.scan that XLA compiles into
// one loop (sanafe_tpu/ops/dag_chunk.py:373-386); there is no Pallas kernel.
// Here it is one launch a level: one thread per neuron lane, which keeps the
// lane's potential, input current and refractory count in registers across
// the T steps and reads and writes the [T, size] planes row by row, so a
// warp's accesses of one step are contiguous.
//
// Per step t = t0 + j, lane i (lif_update.cuh, src/models.cpp:497-567):
//   in:  cur[j, i] float, valid[j, i] byte, add[j, i] float (the LIF noise
//        plane; absent on chips without noise)
//   out: fired[j, i], updated[j, i] bytes, v_seq[j, i], u_seq[j, i] floats
//        (only when the program logs potentials / input currents)
// and the lane's state after the last step.
//
// The loads of kUnroll steps are issued together ahead of their updates, so
// that kUnroll of a lane's global loads are in flight at once and only the
// recurrence itself is serial. The plain PyTorch version this kernel is held
// to bit for bit is ops/level_scan.py:level_plain. Build with -fmad=false.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lif_update.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

// Reset modes (arch.py:NeuronResetMode)
constexpr int kSoft = 1;
constexpr int kHard = 2;
constexpr int kSaturate = 3;

struct Args {
  // per-lane parameters [size]
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
  // the state before the chunk [size]
  const float* v0;
  const float* u0;
  const int* r0;
  // inputs [T, size]
  const float* cur;
  const uint8_t* valid;
  const float* add;  // or null
  // outputs [T, size]
  uint8_t* fired;
  uint8_t* updated;
  float* v_seq;  // or null
  float* u_seq;  // or null
  // the state after the chunk [size]
  float* v_out;
  float* u_out;
  int* r_out;
  int size, n_steps;
  long long t0;
};

__global__ void __launch_bounds__(kThreads) level_kernel(const Args a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.size) return;
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

  float v = a.v0[i];
  float u = a.u0[i];
  int r = a.r0[i];
  const bool has_add = a.add != nullptr;
  const size_t stride = static_cast<size_t>(a.size);

  for (int j0 = 0; j0 < a.n_steps; j0 += kUnroll) {
    float cur[kUnroll], add[kUnroll];
    bool valid[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 + k;
      const size_t o = static_cast<size_t>(j) * stride + i;
      cur[k] = j < a.n_steps ? a.cur[o] : 0.f;
      valid[k] = j < a.n_steps ? a.valid[o] != 0 : false;
      add[k] = has_add && j < a.n_steps ? a.add[o] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 + k;
      if (j >= a.n_steps) break;
      const LifStep<int> s =
          lif_step(p, v, u, r, valid[k], cur[k], a.t0 + j, has_add, add[k]);
      v = s.v;
      u = s.u;
      r = s.refractory;
      const size_t o = static_cast<size_t>(j) * stride + i;
      a.fired[o] = s.fired;
      a.updated[o] = s.updated;
      if (a.v_seq) a.v_seq[o] = v;
      if (a.u_seq) a.u_seq[o] = u;
    }
  }
  a.v_out[i] = v;
  a.u_out[i] = u;
  a.r_out[i] = r;
}

}  // namespace

extern "C" {

// Launch the recurrence of one level on `stream` (no synchronisation).
// `ptrs` holds the Args pointers in declaration order (24 of them, the
// optional ones null where absent). Returns the CUDA error code (0 = ok).
int sanafe_level_launch(const void* const* ptrs, int size, int n_steps,
                        long long t0, int device, void* stream) {
  if (size < 0 || n_steps < 0) return cudaErrorInvalidValue;
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
  in(a.v0);
  in(a.u0);
  in(a.r0);
  in(a.cur);
  in(a.valid);
  in(a.add);
  out(a.fired);
  out(a.updated);
  out(a.v_seq);
  out(a.u_seq);
  out(a.v_out);
  out(a.u_out);
  out(a.r_out);
  a.size = size;
  a.n_steps = n_steps;
  a.t0 = t0;
  if (size == 0) return cudaSuccess;
  const int blocks = (size + kThreads - 1) / kThreads;
  level_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

const char* sanafe_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
