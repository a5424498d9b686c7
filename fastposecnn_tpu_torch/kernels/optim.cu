// K3: the train step's optimizer as two multi-tensor kernels.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax's chain
// (`fastposecnn_tpu/train/optim.py::make_optimizer`), which XLA fuses into a
// few loops over the whole parameter tree. Eager PyTorch ran its counterpart
// as ops over each parameter tensor: about 2,400 ops a step for resnet18's
// 184 tensors and 3,700 for resnet50's 283, so the host's launches, not the
// card, set the optimizer's time. Here the gradient-to-parameter path is two
// launches, whatever the number of tensors:
//
//   optim_grad_stats_kernel (K3a): for each gradient tensor the sum of
//     squares of nan_to_num(g) (NaN as 0, +-inf as +-FLT_MAX, whose float32
//     square is inf) and the number of non-finite elements; then the logged
//     sum of squares (every tensor) and the clip's (without the frozen
//     tensors), each split into the tp-sharded tensors' part and the rest.
//   optim_update_kernel (K3b): the chain's elementwise update, in place:
//     freeze, clip, RAdam's moments and scaling, decoupled weight decay, the
//     per-module ratio, -lr, the plateau scale and Lookahead.
//
// Bound: bytes. K3a reads each gradient once (4 bytes an element). K3b reads
// g, p, mu and nu and writes p, mu and nu (28 bytes an element), and reads
// and writes the slow weights as well on a Lookahead sync (36). Each element
// costs a few dozen float32 operations, far below the card's rate.
//
// Design: the host keeps a table of the tensors (`train/optim.py::
// build_table`): their pointers, element counts, per-tensor multipliers and
// a chunk map. Every block takes one chunk of `chunk` elements of one tensor,
// so no block spans two tensors and the grid is the same for both kernels.
// The table is uploaded once per set of addresses, the gradients' pointers
// once a step (`grads`, 0 for a parameter without a gradient, read as
// zeros). K3a adds its chunk's squares in double and writes one partial a
// block; the last block to finish (an integer ticket) adds each tensor's
// partials in chunk order and the tensors in a fixed order. No float
// atomics: a step gives the same sums on every run (ROADMAP C12).
// K3b repeats the chain's float32 operations one by one with the
// round-to-nearest intrinsics (the library is also built with -fmad=false,
// so nothing is fused), so that given the same clip norm it is bit-equal to
// the chain (`Optimizer.plain_update`) elementwise.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

// The step's scalars, each rounded to float32 as PyTorch rounds a Python
// scalar it multiplies, divides or adds (`train/optim.py::StepScalars`).
struct FpcnnOptimStep {
  float one_minus_b1, b1, one_minus_b2, b2;  // RAdam's moment decays
  float inv_bc1, inv_bc2, r, eps;             // 1 / bias corrections, rectification
  float weight_decay, neg_lr, lr_scale;       // decay, -LEARNING_RATE, plateau
  float max_norm, slow_step;                  // GRADIENT_CLIP_VAL, Lookahead's
  int rectified, sync;                        // RAdam rectified; Lookahead syncs
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The table's int64 words for N tensors and C chunks, in this order:
//   param, mu, nu, slow pointers [N each]; numel [N]; first chunk of each
//   tensor [N + 1]; the tensor of each chunk [C].
// Its float32 multipliers: freeze [N] (0 or 1), ratio [N], sharded [N] (0/1).
struct Layout {
  const int64_t* param;
  const int64_t* mu;
  const int64_t* nu;
  const int64_t* slow;
  const int64_t* numel;
  const int64_t* first_chunk;
  const int64_t* chunk_tensor;
  __device__ Layout(const int64_t* t, int n)
      : param(t), mu(t + n), nu(t + 2 * n), slow(t + 3 * n), numel(t + 4 * n),
        first_chunk(t + 5 * n), chunk_tensor(t + 6 * n + 1) {}
};

template <typename T>
__device__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The block's sum of `v`, in a fixed order, valid in thread 0. Every thread
// of the block calls it.
template <typename T>
__device__ T block_sum(T v, T* s_warp) {
  v = warp_sum(v);
  __syncthreads();  // s_warp is free from a previous call
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
  }
  return total;
}

__device__ inline float nan_to_num(float x) {
  if (isnan(x)) return 0.0f;
  if (isinf(x)) return x > 0.0f ? FLT_MAX : -FLT_MAX;
  return x;
}

__global__ void __launch_bounds__(kThreads)
optim_grad_stats_kernel(const int64_t* __restrict__ table, const float* __restrict__ mult,
                        const int64_t* __restrict__ grads, int N, int chunk,
                        double* __restrict__ partial, int* __restrict__ partial_bad,
                        unsigned* __restrict__ done, float* __restrict__ sums,
                        float* __restrict__ totals, int* __restrict__ nonfinite) {
  __shared__ double s_d[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ bool s_last;
  const Layout L(table, N);
  const int c = blockIdx.x;
  const int i = (int)L.chunk_tensor[c];
  const int64_t start = (c - L.first_chunk[i]) * (int64_t)chunk;
  const int64_t left = L.numel[i] - start;
  const int n = (int)(left < chunk ? left : chunk);
  const float* g = reinterpret_cast<const float*>(grads[i]);

  double acc = 0.0;
  int bad = 0;
  if (g != nullptr) {
    g += start;
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const float x = g[k];
      bad += isfinite(x) ? 0 : 1;
      const float y = nan_to_num(x);
      acc += (double)__fmul_rn(y, y);  // the float32 square, as the chain's
    }
  }
  acc = block_sum(acc, s_d);
  bad = block_sum(bad, s_i);
  if (threadIdx.x == 0) {
    partial[c] = acc;
    partial_bad[c] = bad;
    __threadfence();  // the partials are visible before the ticket
    s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;  // uniform over the block

  // The last block: each tensor's sum over its chunks in order, then the
  // totals in a fixed order. Partials are read past L1 (`__ldcg`): other
  // SMs wrote them.
  __threadfence();
  const float* freeze = mult;
  const float* sharded = mult + 2 * N;
  double log_rest = 0.0, log_own = 0.0, clip_rest = 0.0, clip_own = 0.0;
  for (int j = threadIdx.x; j < N; j += kThreads) {
    double s = 0.0;
    for (int64_t q = L.first_chunk[j]; q < L.first_chunk[j + 1]; ++q) s += __ldcg(partial + q);
    sums[j] = (float)s;
    const bool own = sharded[j] != 0.0f;
    if (own) log_own += s; else log_rest += s;
    if (freeze[j] != 0.0f) {
      if (own) clip_own += s; else clip_rest += s;
    }
  }
  int total_bad = 0;
  for (int q = threadIdx.x; q < (int)gridDim.x; q += kThreads) total_bad += __ldcg(partial_bad + q);
  log_rest = block_sum(log_rest, s_d);
  log_own = block_sum(log_own, s_d);
  clip_rest = block_sum(clip_rest, s_d);
  clip_own = block_sum(clip_own, s_d);
  total_bad = block_sum(total_bad, s_i);
  if (threadIdx.x == 0) {
    totals[0] = (float)log_rest;
    totals[1] = (float)log_own;
    totals[2] = (float)clip_rest;
    totals[3] = (float)clip_own;
    *nonfinite = total_bad;
    *done = 0u;  // ready for the next launch, which the stream orders after this one
  }
}

__global__ void __launch_bounds__(kThreads)
optim_update_kernel(const int64_t* __restrict__ table, const float* __restrict__ mult,
                    const int64_t* __restrict__ grads, const float* __restrict__ clip_norm,
                    int N, int chunk, FpcnnOptimStep s) {
  const Layout L(table, N);
  const int c = blockIdx.x;
  const int i = (int)L.chunk_tensor[c];
  const int64_t start = (c - L.first_chunk[i]) * (int64_t)chunk;
  const int64_t left = L.numel[i] - start;
  const int n = (int)(left < chunk ? left : chunk);
  float* p = reinterpret_cast<float*>(L.param[i]) + start;
  float* mu = reinterpret_cast<float*>(L.mu[i]) + start;
  float* nu = reinterpret_cast<float*>(L.nu[i]) + start;
  float* slow = reinterpret_cast<float*>(L.slow[i]) + start;
  const float* g = reinterpret_cast<const float*>(grads[i]);
  if (g != nullptr) g += start;
  const float freeze = mult[i];
  const float ratio = mult[N + i];
  const float norm = *clip_norm;
  const bool keep = norm < s.max_norm;  // optax: unchanged below the clip

#pragma unroll 4
  for (int k = threadIdx.x; k < n; k += kThreads) {
    // 1. freeze; 2. clip: (u / norm) * max_norm unless below the clip
    float u = __fmul_rn(g != nullptr ? g[k] : 0.0f, freeze);
    if (!keep) u = __fmul_rn(__fdiv_rn(u, norm), s.max_norm);
    // 3. RAdam's moments
    const float m = __fadd_rn(__fmul_rn(u, s.one_minus_b1), __fmul_rn(mu[k], s.b1));
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(u, u), s.one_minus_b2), __fmul_rn(nu[k], s.b2));
    mu[k] = m;
    nu[k] = v;
    // 4. mu_hat, and the rectified step. PyTorch's CUDA foreach divides by
    // a scalar as a product with its float32 reciprocal, and so does this.
    u = __fmul_rn(m, s.inv_bc1);
    if (s.rectified) {
      const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(v, s.inv_bc2)), s.eps);
      u = __fdiv_rn(__fmul_rn(u, s.r), denom);
    }
    // 5. + wd * p; 6. ratio; 7. -lr; 8. plateau scale
    const float pk = p[k];
    u = __fadd_rn(u, __fmul_rn(pk, s.weight_decay));
    u = __fmul_rn(u, ratio);
    u = __fmul_rn(u, s.neg_lr);
    u = __fmul_rn(u, s.lr_scale);
    // 9. Lookahead: the fast weights p + u; on a sync the slow weights move
    // half way to them and the parameters land there
    const float fast = __fadd_rn(pk, u);
    if (s.sync) {
      const float sl = slow[k];
      const float moved = __fadd_rn(sl, __fmul_rn(__fsub_rn(fast, sl), s.slow_step));
      slow[k] = moved;
      u = __fsub_rn(moved, pk);
    } else {
      u = __fsub_rn(fast, pk);
    }
    // 10. p + u
    p[k] = __fadd_rn(pk, u);
  }
}

}  // namespace

extern "C" {

cudaError_t fpcnn_optim_grad_stats(const int64_t* table, const float* mult,
                                   const int64_t* grads, int n_tensors, int n_chunks,
                                   int chunk, double* partial, int* partial_bad,
                                   unsigned* done, float* sums, float* totals,
                                   int* nonfinite, cudaStream_t stream) {
  if (n_tensors < 1 || n_chunks < n_tensors || chunk < 1) return cudaErrorInvalidValue;
  optim_grad_stats_kernel<<<n_chunks, kThreads, 0, stream>>>(
      table, mult, grads, n_tensors, chunk, partial, partial_bad, done, sums, totals,
      nonfinite);
  return cudaGetLastError();
}

cudaError_t fpcnn_optim_update(const int64_t* table, const float* mult, const int64_t* grads,
                               const float* clip_norm, int n_tensors, int n_chunks, int chunk,
                               const FpcnnOptimStep* scalars, cudaStream_t stream) {
  if (n_tensors < 1 || n_chunks < n_tensors || chunk < 1 || scalars == nullptr)
    return cudaErrorInvalidValue;
  optim_update_kernel<<<n_chunks, kThreads, 0, stream>>>(table, mult, grads, clip_norm,
                                                         n_tensors, chunk, *scalars);
  return cudaGetLastError();
}

}  // extern "C"
