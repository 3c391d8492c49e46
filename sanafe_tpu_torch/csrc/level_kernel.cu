// Per-level LIF recurrence of the feed-forward (DAG) engine (Hopper, sm_90a).
//
// The DAG engine (sanafe_tpu_torch/ops/dag_chunk.py) runs a feed-forward
// chip level by level: the input of a whole level for a whole chunk is
// computed at once (a batched convolution, batched block delivery), and what
// is left sequential is each level's membrane recurrence over the chunk's T
// steps. sanafe_tpu runs that recurrence as a lax.scan that XLA compiles into
// one loop (sanafe_tpu/ops/dag_chunk.py:373-386); there is no Pallas kernel.
// Here it is one launch a level, one thread per neuron lane, which keeps the
// lane's potential, input current and refractory count in registers across
// the T steps.
//
// Per step t = t0 + j, lane i (lif_update.cuh, src/models.cpp:497-567), t0
// being read from device memory (a 0-d int64 tensor) once by each lane of
// the recurrence's warp, so that a captured CUDA graph replays the launch
// for any start step (ops/dag_chunk.py:DagGraphs):
//   in:  cur[j, i] float, valid[j, i] byte, add[j, i] float (the LIF noise
//        plane; absent on chips without noise)
//   out: fired[j, i], updated[j, i] bytes, v_seq[j, i], u_seq[j, i] floats
//        (only when the program logs potentials / input currents)
// and the lane's state after the last step.
//
// What bounds it: a lane's T steps are one chain of dependent float and
// integer operations (lif_step: the decays, the quantisation, three adds,
// the compares and the reset selects), which cannot be split; the bytes are
// far below it. A warp issues in order, so any instruction of the chain's
// warp that waits (for a load, for a store to read its registers, at a
// branch) stalls the chain. The design keeps everything but the chain off
// that warp:
//
// - A CTA owns 32 lanes, so a level of 1,024 lanes runs on 32 SMs and one
//   of 7,744 on all 132. It has two warps, which hand batches of kBatch
//   steps to each other through mbarriers, and no block barrier in its
//   loop.
// - Warp 1 keeps a ring of kBatches batches of the lanes' cur, valid and
//   add rows in shared memory, filled with cp.async (4-byte granules: lane
//   l copies lane l's cur and add; the 32 valid bytes of a step are copied
//   as the 4-byte words that cover them, since `size` is not a multiple of
//   4 in general and a row may start anywhere), each batch completing on
//   its `full` barrier (cp.async.mbarrier.arrive). It also stores the
//   fired and updated rows, one byte a lane, once warp 0 has handed a
//   batch back on its `empty` barrier, and then refills that slot.
// - Warp 0 runs the recurrence. A batch is one straight-line block: the
//   kernel is templated on the noise plane and the v/u planes, a batch
//   whose steps all have t > 1 runs lif_step with the leak known at
//   compile time, a full batch has no bounds tests, and the flags leave
//   the chain as one bit a step in the lane's own registers (no warp-wide
//   vote, whose reconvergence would split the block; `updated` is taken
//   with bitwise ors for the same reason), written to shared memory once
//   a batch. The arithmetic is lif_update.cuh's lif_step, unchanged (the
//   chunk kernel shares it).
// - Outputs keep their layout ([T, size] bytes, optional float planes,
//   the final state); the v/u planes, when asked for, are stored by warp 0.
//
// The plain PyTorch version this kernel is held to bit for bit is
// ops/level_scan.py:level_plain. Build with -fmad=false.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "lif_update.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kBatch = 8;              // steps a batch
constexpr int kBatches = 8;            // batches in the ring
constexpr int kRing = kBatch * kBatches;
static_assert(kBatch <= 8, "a lane's flags of a batch fill one byte");
constexpr int kValidWords = 12;        // 4-byte words a step's valid row
                                       // takes (at most 9), padded

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
  const long long* t0;  // the 1-based step of row 0 [] (device memory)
  int size, n_steps;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// The barrier's arrival fires when this thread's earlier cp.async copies
// have landed (counted in the barrier's init count).
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
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

// The CTA's ring: the input rows of kRing steps, each lane's fired and
// updated flags of each batch, and two barriers a batch.
template <bool kAdd>
struct Ring {
  float cur[kRing][kWarp];
  float add[kAdd ? kRing : 1][kWarp];
  uint32_t valid[kRing][kValidWords];
  // each lane's fired and updated flags of a batch: bit k is step k's
  uint8_t fired[kBatches][kWarp];
  uint8_t updated[kBatches][kWarp];
  uint64_t full[kBatches];   // the batch's copies have landed
  uint64_t empty[kBatches];  // the batch has been read and its flags written
};

struct Lanes {
  int lane;    // this thread's lane in its warp
  int i0;      // the level's first lane of the CTA
  int lanes;   // lanes of the CTA below size
  int src;     // the lane whose inputs this lane copies: itself, or the
               // last real lane past the end of the level
  size_t stride;
};

// Warp 1: copy the rows of step j into its ring slot. Past the last step
// it copies the last step's rows again, and every lane copies something
// real, so the code has no branches.
template <bool kAdd>
__device__ __forceinline__ void prefetch(const Args& a, Ring<kAdd>& ring,
                                         const Lanes& w, int j) {
  const int slot = j % kRing;
  const size_t o =
      static_cast<size_t>(min(j, a.n_steps - 1)) * w.stride + w.i0;
  cp_async4(&ring.cur[slot][w.lane], a.cur + o + w.src);
  if (kAdd) cp_async4(&ring.add[slot][w.lane], a.add + o + w.src);
  // the valid words: lanes past the last copy the last one again, to the
  // same place
  const uintptr_t first = reinterpret_cast<uintptr_t>(a.valid + o);
  const uintptr_t word0 = first & ~uintptr_t{3};
  const int k = min(w.lane,
                    static_cast<int>((first + w.lanes + 3 - word0) >> 2) - 1);
  cp_async4(&ring.valid[slot][k], reinterpret_cast<const void*>(word0 + 4 * k));
}

// Warp 0: steps j0 .. j0 + n - 1 of the recurrence (n == kBatch when kFull).
// kLeak: every step of the batch has t > 1, else each step tests its own
// t. The shared loads come first and the chain after them in one block;
// each step's flags leave the chain as one bit each in the lane's own
// registers (`fired`, `updated`; bit k for step k), which the caller
// writes once a batch. No warp-wide operation, so no step waits for the
// others' lanes and the batch stays one block.
template <bool kAdd, bool kRecV, bool kRecU, bool kFull, bool kLeak>
__device__ __forceinline__ void run_batch(const Args& a, Ring<kAdd>& ring,
                                          const LifParams<int>& p,
                                          const Lanes& w, bool live,
                                          long long t0, int j0, int n,
                                          float& v, float& u, int& r,
                                          uint32_t& fired, uint32_t& updated) {
  float cur[kBatch], add[kBatch];
  bool valid[kBatch];
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    const int j = j0 + k;
    const int slot = j % kRing;
    // the step's first valid byte lies (its address mod 4) into the
    // slot's first word; only the low bits matter, so 32-bit arithmetic
    const int byte0 = static_cast<int>(
        (static_cast<uint32_t>(reinterpret_cast<uintptr_t>(a.valid)) +
         static_cast<uint32_t>(j) * static_cast<uint32_t>(w.stride) +
         static_cast<uint32_t>(w.i0)) & 3u);
    valid[k] =
        reinterpret_cast<const uint8_t*>(ring.valid[slot])[byte0 + w.lane] != 0;
    cur[k] = ring.cur[slot][w.lane];
    add[k] = kAdd ? ring.add[slot][w.lane] : 0.f;
  }
  fired = updated = 0;
  const bool always_updated = (fabsf(p.bias) > 0.f) | p.force;
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (!kFull && k >= n) break;
    const int j = j0 + k;
    const long long t = kLeak ? 2 : t0 + j;
    // lif_step's `updated`, with bitwise ors: the same flag, and no branch
    // to split the batch's block
    const bool upd = (fabsf(v) > 0.f) | valid[k] | always_updated;
    const LifStep<int> s =
        lif_step(p, v, u, r, valid[k], cur[k], t, kAdd, add[k]);
    v = s.v;
    u = s.u;
    r = s.refractory;
    fired |= static_cast<uint32_t>(s.fired) << k;
    updated |= static_cast<uint32_t>(upd) << k;
    if ((kRecV || kRecU) && live) {
      const size_t o = static_cast<size_t>(j) * w.stride + w.i0 + w.lane;
      if (kRecV) a.v_seq[o] = v;
      if (kRecU) a.u_seq[o] = u;
    }
  }
}

// Warp 1: write the fired and updated rows of batch b from warp 0's bits,
// lane l the byte of lane l.
template <bool kAdd>
__device__ __forceinline__ void store_flags(const Args& a,
                                            const Ring<kAdd>& ring,
                                            const Lanes& w, int b) {
  const int j0 = b * kBatch;
  const int n = min(kBatch, a.n_steps - j0);
  if (w.lane >= w.lanes) return;
  const int slot = b % kBatches;
  const uint32_t fired = ring.fired[slot][w.lane];
  const uint32_t updated = ring.updated[slot][w.lane];
  for (int k = 0; k < n; ++k) {
    const size_t o = static_cast<size_t>(j0 + k) * w.stride + w.i0 + w.lane;
    a.fired[o] = (fired >> k) & 1u;
    a.updated[o] = (updated >> k) & 1u;
  }
}

template <bool kAdd, bool kRecV, bool kRecU>
__global__ void __launch_bounds__(2 * kWarp) level_kernel(const Args a) {
  __shared__ Ring<kAdd> ring;
  const int warp = threadIdx.x / kWarp;
  Lanes w;
  w.lane = threadIdx.x % kWarp;
  w.i0 = blockIdx.x * kWarp;
  w.lanes = min(kWarp, a.size - w.i0);
  w.src = min(w.lane, w.lanes - 1);
  w.stride = static_cast<size_t>(a.size);
  const int n_batches = (a.n_steps + kBatch - 1) / kBatch;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kBatches; ++k) {
      mbar_init(&ring.full[k], kWarp);   // warp 1's copies
      mbar_init(&ring.empty[k], kWarp);  // warp 0's lanes
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the only block barrier, before the loops

  if (warp == 1) {
    // the ring's producer and the flags' store: batch b is copied into its
    // slot once batch b - kBatches, which held it, has been run and its
    // flags stored
    for (int b = 0; b < n_batches + kBatches; ++b) {
      const int slot = b % kBatches;
      if (b >= kBatches) {
        mbar_wait(&ring.empty[slot], ((b - kBatches) / kBatches) & 1);
        store_flags(a, ring, w, b - kBatches);
      }
      if (b < n_batches) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) prefetch(a, ring, w, b * kBatch + k);
        mbar_arrive_copies(&ring.full[slot]);
      }
    }
    return;
  }

  // warp 0: lane l runs neuron i0 + l
  const int i = w.i0 + w.lane;
  const bool live = i < a.size;
  const int q = live ? i : a.size - 1;  // parameters of a real lane
  LifParams<int> p;
  p.bias = a.bias[q];
  p.leak_decay = a.leak_decay[q];
  p.input_decay = a.input_decay[q];
  p.threshold = a.threshold[q];
  p.reverse_threshold = a.reverse_threshold[q];
  p.reset = a.reset[q];
  p.reverse_reset = a.reverse_reset[q];
  p.refractory_delay = a.refractory_delay[q];
  p.force = a.force[q] != 0;
  const int rm = a.reset_mode[q];
  const int rrm = a.reverse_reset_mode[q];
  p.rm_hard = rm == kHard;
  p.rm_soft = rm == kSoft;
  p.rrm_hard = rrm == kHard;
  p.rrm_soft = rrm == kSoft;
  p.rrm_sat = rrm == kSaturate;
  float v = a.v0[q];
  float u = a.u0[q];
  int r = a.r0[q];
  const long long t0 = *a.t0;
  for (int b = 0; b < n_batches; ++b) {
    const int slot = b % kBatches;
    mbar_wait(&ring.full[slot], (b / kBatches) & 1);
    const int j0 = b * kBatch;
    const int n = min(kBatch, a.n_steps - j0);
    const bool leak = t0 + j0 > 1;
    uint32_t fired, updated;
    if (n == kBatch) {
      if (leak) {
        run_batch<kAdd, kRecV, kRecU, true, true>(a, ring, p, w, live, t0, j0,
                                                  n, v, u, r, fired, updated);
      } else {
        run_batch<kAdd, kRecV, kRecU, true, false>(a, ring, p, w, live, t0,
                                                   j0, n, v, u, r, fired,
                                                   updated);
      }
    } else if (leak) {
      run_batch<kAdd, kRecV, kRecU, false, true>(a, ring, p, w, live, t0, j0,
                                                 n, v, u, r, fired, updated);
    } else {
      run_batch<kAdd, kRecV, kRecU, false, false>(a, ring, p, w, live, t0, j0,
                                                  n, v, u, r, fired, updated);
    }
    ring.fired[slot][w.lane] = static_cast<uint8_t>(fired);
    ring.updated[slot][w.lane] = static_cast<uint8_t>(updated);
    mbar_arrive(&ring.empty[slot]);
  }
  if (live) {
    a.v_out[i] = v;
    a.u_out[i] = u;
    a.r_out[i] = r;
  }
}

template <bool kAdd, bool kRecV, bool kRecU>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.size + kWarp - 1) / kWarp;
  level_kernel<kAdd, kRecV, kRecU><<<blocks, 2 * kWarp, 0, stream>>>(a);
  return cudaGetLastError();
}

template <bool kAdd, bool kRecV>
cudaError_t launch_u(const Args& a, cudaStream_t stream) {
  return a.u_seq ? launch<kAdd, kRecV, true>(a, stream)
                 : launch<kAdd, kRecV, false>(a, stream);
}

template <bool kAdd>
cudaError_t launch_v(const Args& a, cudaStream_t stream) {
  return a.v_seq ? launch_u<kAdd, true>(a, stream)
                 : launch_u<kAdd, false>(a, stream);
}

}  // namespace

extern "C" {

// Launch the recurrence of one level on `stream` (no synchronisation).
// `ptrs` holds the Args pointers in declaration order up to r_out (24 of
// them, the optional ones null where absent); `t0` points to the 1-based
// step of row 0 in device memory (an int64 the kernel reads, so a graph
// that captured the launch replays it for the step the pointer then holds).
// Returns the CUDA error code (0 = ok).
int sanafe_level_launch(const void* const* ptrs, int size, int n_steps,
                        const long long* t0, int device, void* stream) {
  if (t0 == nullptr) return cudaErrorInvalidValue;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.add ? launch_v<true>(a, s) : launch_v<false>(a, s);
}

const char* sanafe_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
