// The LIF soma update of one neuron lane, shared by the whole-chunk kernel
// (chunk_kernel.cu) and the per-level recurrence kernel (level_kernel.cu).
//
// LoihiLifModel::update (src/models.cpp:497-567), as sanafe_tpu_torch's
// ops/step.py:lif_step computes it: leak and input decay only when t > 1;
// trunc(v*64)/64 quantisation; the additive noise (when the caller has any)
// after it; u and v integrate only out of refractory; fire on v > threshold;
// hard/soft reset, then the reverse-threshold soft/hard/saturate resets;
// refractory = max(0, (fired ? delay : refractory) - 1). Every operation
// rounds once: build with -fmad=false so that u*decay + cur and v + bias +
// u_new are never contracted into fused multiply-adds.
#pragma once

// R is the refractory counter's type: float in the chunk kernel's state
// rows, int in the step scan's state.
template <typename R>
struct LifParams {
  float bias, leak_decay, input_decay, threshold, reverse_threshold, reset,
      reverse_reset;
  R refractory_delay;
  bool force, rm_hard, rm_soft, rrm_hard, rrm_soft, rrm_sat;
};

template <typename R>
struct LifStep {
  float v, u;
  R refractory;
  bool fired, updated;
};

template <typename R>
__device__ __forceinline__ LifStep<R> lif_step(const LifParams<R>& p, float v,
                                               float u, R refractory,
                                               bool valid, float cur,
                                               long long t, bool has_add,
                                               float add) {
  LifStep<R> s;
  s.updated = fabsf(v) > 0.f || valid || fabsf(p.bias) > 0.f || p.force;
  float u_l = t > 1 ? u * p.input_decay : u;
  float v_l = t > 1 ? v * p.leak_decay : v;
  v_l = truncf(v_l * 64.f) / 64.f;
  if (has_add) v_l = v_l + add;
  const bool active = !(refractory > R(0));
  const float u_new = u_l + (valid ? cur : 0.f);
  const float v_new = (v_l + p.bias) + u_new;
  if (active) u_l = u_new;
  s.fired = active && v_new > p.threshold;
  float v_act = v_new;
  if (s.fired && p.rm_hard) v_act = p.reset;
  if (s.fired && p.rm_soft) v_act = v_act - p.threshold;
  const bool rev = v_act < p.reverse_threshold;
  if (rev && p.rrm_soft) v_act = v_act - p.reverse_threshold;
  if (rev && p.rrm_hard) v_act = p.reverse_reset;
  if (rev && p.rrm_sat) v_act = p.reverse_threshold;
  s.v = active ? v_act : v_l;
  s.u = u_l;
  R r = s.fired ? p.refractory_delay : refractory;
  r = r - R(1);
  s.refractory = r > R(0) ? r : R(0);
  return s;
}
