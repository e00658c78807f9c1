// Host Adam / AdamW for the offloaded optimizer (runtime/zero/offload.py):
// one pass over a leaf's f32 parameters, gradients and moments, where the
// plain PyTorch update makes 14 passes.  The reference runs this update as
// an XLA:CPU program (deepspeed_tpu/runtime/zero/offload.py), which fuses
// it the same way.
//
// Each operation is optax's (scale_by_adam, add_decayed_weights,
// scale_by_learning_rate, apply_updates) in the order and f32 rounding of
// the port's plain update (runtime/optimizers.py Adam): no contraction into
// fused multiply-adds (built with -ffp-contract=off).  The host-side
// constants arrive already rounded to f32, as PyTorch rounds a Python
// scalar against an f32 tensor.
#include <cmath>
#include <cstdint>

extern "C" void ds_cpu_adam_step(float* p, const float* g, float* m, float* v,
                                 int64_t n, float b1, float one_b1, float b2,
                                 float one_b2, float bc1, float bc2,
                                 float eps, float neg_lr, float wd,
                                 int decay, int decoupled, int threads) {
  const bool l2 = decay && !decoupled;
  const bool decoupled_decay = decay && decoupled;
#pragma omp parallel for num_threads(threads) schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    const float pi = p[i];
    float gi = g[i];
    if (l2) gi = gi + pi * wd;  // classic L2: the decay joins the gradient
    const float mi = m[i] * b1 + gi * one_b1;
    const float vi = v[i] * b2 + one_b2 * gi * gi;
    m[i] = mi;
    v[i] = vi;
    float u = (mi / bc1) / (std::sqrt(vi / bc2) + eps);
    if (decoupled_decay) u = u + pi * wd;
    p[i] = u * neg_lr + pi;
  }
}
