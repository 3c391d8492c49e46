// Chain floors of the prefix and level kernels (Hopper, sm_90a): each
// kernel's recurrence run from registers, with no memory traffic in its
// loop, so its time is the latency of the dependent chain alone (plus one
// launch). Built and timed by scripts/chain_floor.py; not part of the
// package.
//
// - prefix_floor: one lane a row, N dependent float64 adds (the two
//   addends alternate, so no add can be folded into another).
// - level_floor: one lane a neuron, T steps of lif_step (lif_update.cuh,
//   the code the level kernel runs) with the lane's current, arrival and
//   noise of step 0 held in registers and the leak on, as in every batch of
//   the level kernel but the first; the state after the last step is
//   stored so that nothing is dead.
//
// Build with the package's flags (-fmad=false).

#include <cuda_runtime.h>

#include <cstdint>

#include "../sanafe_tpu_torch/csrc/lif_update.cuh"

namespace {

__global__ void prefix_floor(const double* __restrict__ x,
                             double* __restrict__ out, int rows, int cols) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const double a = x[2 * row];
  const double b = x[2 * row + 1];
  double s = 0.0;
  int k = 0;
#pragma unroll 16
  for (; k + 2 <= cols; k += 2) {
    s = s + a;
    s = s + b;
  }
  if (k < cols) s = s + a;
  out[row] = s;
}

constexpr int kSoft = 1;
constexpr int kHard = 2;
constexpr int kSaturate = 3;

// `ptrs`: the level kernel's 24 pointers (ops/level_scan.py:level_kernel's
// order); only the parameters, the state, step 0 of the inputs and the
// final state are touched.
__global__ void level_floor(const void* const* __restrict__ ptrs, int size,
                            int n_steps, int has_add) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  auto f = [&](int k) { return static_cast<const float*>(ptrs[k])[i]; };
  auto n = [&](int k) { return static_cast<const int*>(ptrs[k])[i]; };
  LifParams<int> p;
  p.bias = f(0);
  p.leak_decay = f(1);
  p.input_decay = f(2);
  p.threshold = f(3);
  p.reverse_threshold = f(4);
  p.reset = f(5);
  p.reverse_reset = f(6);
  p.refractory_delay = n(7);
  const int rm = n(8);
  const int rrm = n(9);
  p.force = static_cast<const uint8_t*>(ptrs[10])[i] != 0;
  p.rm_hard = rm == kHard;
  p.rm_soft = rm == kSoft;
  p.rrm_hard = rrm == kHard;
  p.rrm_soft = rrm == kSoft;
  p.rrm_sat = rrm == kSaturate;
  float v = f(11);
  float u = f(12);
  int r = n(13);
  const float cur = f(14);
  const bool valid = static_cast<const uint8_t*>(ptrs[15])[i] != 0;
  const float add = has_add ? f(16) : 0.f;
  if (has_add) {
#pragma unroll 8
    for (int j = 0; j < n_steps; ++j) {
      const LifStep<int> s = lif_step(p, v, u, r, valid, cur, 2, true, add);
      v = s.v;
      u = s.u;
      r = s.refractory;
    }
  } else {
#pragma unroll 8
    for (int j = 0; j < n_steps; ++j) {
      const LifStep<int> s = lif_step(p, v, u, r, valid, cur, 2, false, 0.f);
      v = s.v;
      u = s.u;
      r = s.refractory;
    }
  }
  static_cast<float*>(const_cast<void*>(ptrs[21]))[i] = v;
  static_cast<float*>(const_cast<void*>(ptrs[22]))[i] = u;
  static_cast<int*>(const_cast<void*>(ptrs[23]))[i] = r;
}

}  // namespace

extern "C" {

int chain_floor_prefix(const void* x, void* out, int rows, int cols,
                       void* stream) {
  if (rows <= 0) return cudaSuccess;
  prefix_floor<<<(rows + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), rows, cols);
  return cudaGetLastError();
}

// `ptrs` lies in device memory (the 24 pointers of the level kernel).
int chain_floor_level(const void* ptrs, int size, int n_steps, int has_add,
                      void* stream) {
  if (size <= 0) return cudaSuccess;
  level_floor<<<(size + 31) / 32, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const void* const*>(ptrs), size, n_steps, has_add);
  return cudaGetLastError();
}

}  // extern "C"
