// RANSAC inlier counts:
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   a = hyp[m, h] - pt[m, p],  dot = a . dir[m, p],  vsq = |a|^2.
//
// Replaces the TPU kernel `_vote_count_kernel` (launched by
// `vote_counts_pallas`, fastposecnn_tpu/ops/voting.py:282-420), which tiles
// 8 slots x 128 hypotheses over the TPU's vector unit and skips blocks of
// inactive slots through a prefetched flag.
//
// Here one thread owns one (m, h) cell; a block of threads shares one slot m
// and stages the slot's points, directions and validity in shared memory,
// 1024 points at a time. A slot whose `active` flag is 0 writes zeros.
//
// Bound: about 9 FP32 operations per (m, h, p) cell and a few bytes per
// (m, h) -- at M=16, H=4096, P=1024 that is 6.7e7 cells, so the kernel is
// bound by FP32 throughput, not memory.
//
// Arithmetic: subtract first, then products and sums written as __fmul_rn /
// __fadd_rn so no multiply-add is fused (the library is also built with
// -fmad=false): a fused multiply-add flips borderline cells against the
// reference. Counts are sums of 0/1 values, exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__global__ void vote_count_kernel(const float2* __restrict__ hyps,
                                  const float2* __restrict__ pts,
                                  const float2* __restrict__ dirs,
                                  const float* __restrict__ pvalid,
                                  const int32_t* __restrict__ active,
                                  float* __restrict__ out, int M, int H, int P,
                                  float t2) {
  __shared__ float2 s_pt[kTile];
  __shared__ float2 s_dir[kTile];
  __shared__ float s_pv[kTile];

  const int m = blockIdx.y;
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (active != nullptr && active[m] == 0) {
    if (h < H) out[(int64_t)m * H + h] = 0.0f;
    return;  // uniform over the block: no barrier is skipped by some threads only
  }
  float2 hyp = make_float2(0.0f, 0.0f);
  if (h < H) hyp = hyps[(int64_t)m * H + h];
  const float2* mp = pts + (int64_t)m * P;
  const float2* md = dirs + (int64_t)m * P;
  const float* mv = pvalid + (int64_t)m * P;
  float acc = 0.0f;
  for (int base = 0; base < P; base += kTile) {
    const int n = min(kTile, P - base);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      s_pt[j] = mp[base + j];
      s_dir[j] = md[base + j];
      s_pv[j] = mv[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float ax = __fsub_rn(hyp.x, s_pt[j].x);
      const float ay = __fsub_rn(hyp.y, s_pt[j].y);
      const float dot = __fadd_rn(__fmul_rn(ax, s_dir[j].x), __fmul_rn(ay, s_dir[j].y));
      const float vsq = __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay));
      const bool inl = (dot > 0.0f) && (__fmul_rn(dot, dot) > __fmul_rn(t2, vsq));
      acc = __fadd_rn(acc, inl ? s_pv[j] : 0.0f);
    }
  }
  if (h < H) out[(int64_t)m * H + h] = acc;
}

}  // namespace

extern "C" int fpcnn_vote_count(const float* hyps, const float* pts,
                                const float* dirs, const float* pvalid,
                                const int32_t* active, float* out, int M, int H,
                                int P, float t2, void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  dim3 grid((unsigned)((H + kThreads - 1) / kThreads), (unsigned)M);
  vote_count_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, active, out, M, H, P, t2);
  return (int)cudaGetLastError();
}
