// RANSAC inlier counts in the expanded form, on the CUDA cores (probe P2):
//   dot = (hx*dx + hy*dy) - cc,  vsq = (hsq - 2*(hx*px + hy*py)) + qq,
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   cc = px*dx + py*dy, qq = px*px + py*py, hsq = hx*hx + hy*hy, in float32.
//
// Replaces the TPU probe kernel `kernel_c` (scripts/probe_vote_variants.py:165,
// launched by `variant_c` at :193, `pallas_call` at :207), which evaluated the
// same expressions as broadcasts on the TPU's vector unit.
//
// Bound: FP32 issue. Each (m, h, p) cell costs 12 unfused FP32 operations
// (7 mul, 3 add, 2 sub: 4 for dot, 6 for vsq, 2 for the test) plus two
// compares and the predicated add; the bytes are a few per (m, h) and per
// (m, p), so memory is far from the limit.
//
// Design: the simple mapping. A block of 256 threads owns one slot m and 256
// hypotheses, one a thread, with hx, hy and hsq in registers; the block
// stages 1024 points at a time in shared memory as (px, py, dx, dy) and
// (cc, qq, pv), cc and qq computed once per point, and every thread walks
// the tile reading each point as a broadcast.
//
// Exactness: every product and sum is written as __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's order (`vote_counts_expanded_bcast_reference`),
// and the library is built with -fmad=false, so each cell's test is the
// plain version's bit for bit; pv is 0 or 1, so every partial count is an
// integer below 2^24 and the counts equal the plain version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // hypotheses a block, one a thread
constexpr int kTile = 1024;    // points staged at a time

__global__ void __launch_bounds__(kThreads)
vote_expanded_bcast_kernel(const float2* __restrict__ hyps, const float2* __restrict__ pts,
                           const float2* __restrict__ dirs, const float* __restrict__ pvalid,
                           float* __restrict__ out, int M, int H, int P, float t2) {
  __shared__ float4 s_pd[kTile];  // px, py, dx, dy
  __shared__ float4 s_cq[kTile];  // cc, qq, pv, unused

  const int nx = (H + kThreads - 1) / kThreads;
  const int m = blockIdx.x / nx;
  const int h = (blockIdx.x % nx) * kThreads + threadIdx.x;
  const float2 hv = h < H ? hyps[(int64_t)m * H + h] : make_float2(0.0f, 0.0f);
  const float hx = hv.x, hy = hv.y;
  const float hsq = __fadd_rn(__fmul_rn(hx, hx), __fmul_rn(hy, hy));
  const int64_t mp = (int64_t)m * P;

  float acc = 0.0f;
  for (int base = 0; base < P; base += kTile) {
    const int n = min(kTile, P - base);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float2 p = pts[mp + base + i];
      const float2 d = dirs[mp + base + i];
      const float cc = __fadd_rn(__fmul_rn(p.x, d.x), __fmul_rn(p.y, d.y));
      const float qq = __fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y));
      s_pd[i] = make_float4(p.x, p.y, d.x, d.y);
      s_cq[i] = make_float4(cc, qq, pvalid[mp + base + i], 0.0f);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 q = s_pd[j];
      const float4 c = s_cq[j];
      const float dot =
          __fsub_rn(__fadd_rn(__fmul_rn(hx, q.z), __fmul_rn(hy, q.w)), c.x);
      const float hp = __fadd_rn(__fmul_rn(hx, q.x), __fmul_rn(hy, q.y));
      const float vsq = __fadd_rn(__fsub_rn(hsq, __fmul_rn(2.0f, hp)), c.y);
      // A predicated add: acc + 0 is acc, so skipping the add is exact.
      if ((dot > 0.0f) && (__fmul_rn(dot, dot) > __fmul_rn(t2, vsq)))
        acc = __fadd_rn(acc, c.z);
    }
  }
  if (h < H) out[(int64_t)m * H + h] = acc;
}

}  // namespace

extern "C" int fpcnn_vote_expanded_bcast(const float* hyps, const float* pts,
                                         const float* dirs, const float* pvalid,
                                         float* out, int M, int H, int P, float t2,
                                         void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)(((H + kThreads - 1) / kThreads) * M);
  vote_expanded_bcast_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, out, M, H, P, t2);
  return (int)cudaGetLastError();
}
