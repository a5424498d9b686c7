// RANSAC inlier counts in the expanded form, on the CUDA cores (probe P2):
//   dot = (hx*dx + hy*dy) - cc,  vsq = (hsq - 2*(hx*px + hy*py)) + qq,
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   cc = px*dx + py*dy, qq = px*px + py*py, hsq = hx*hx + hy*hy, in float32.
//
// Replaces the TPU probe kernel `kernel_c` (scripts/probe_vote_variants.py:165,
// launched by `variant_c` at :193, `pallas_call` at :207), which evaluated the
// same expressions as broadcasts on the TPU's vector unit.
//
// Bound: FP32 issue. Each valid (m, h, p) cell costs 11 unfused FP32
// operations as computed here (6 mul, 3 add, 2 sub: 4 for dot, 5 for vsq, 2
// for the test; `kernel_c`'s order has one multiply more) plus two compares
// and the count's integer add, 14 instructions; the bytes are a few per
// (m, h) and per (m, p), so memory is far from the limit.
//
// Design (K2's, `vote_count.cu`): a block owns one slot m and HB = 128
// hypotheses; its 16 warps split the slot's points into contiguous ranges,
// and each lane keeps R = 4 hypotheses (hx, hy, hsq) in registers, so one
// broadcast shared-memory read of a point feeds four independent chains and
// a thread walks P / 16 points: the few hypotheses of a slot still fill the
// card. Points are staged 1024 at a time, and only those with pv != 0 (an
// order-keeping compaction by warp ballots and one prefix sum), as
// (2px, 2py, dx, dy) and (cc, qq), each computed once per point. Counts are
// integers, each added by one predicated instruction (`count_inlier`): the
// `&&` of the test written in C++ compiles into a branch around vsq per cell,
// on which the warps diverge. Each warp leaves its partial counts in shared
// memory and HB threads add the 16 partials, so one launch writes every
// count: no atomics, no second pass.
//
// Exactness: every product and sum is written as __fmul_rn / __fadd_rn /
// __fsub_rn in the plain version's order (`vote_counts_expanded_bcast_reference`)
// and the library is built with -fmad=false, with one rearrangement that is
// bitwise the same: hx*(2px) + hy*(2py) in place of 2*(hx*px + hy*py), since
// scaling by 2 is exact for normal floats (the coordinates are far from the
// subnormal range). pv is 0 or 1, so a point counts 1 where the plain
// version adds pv = 1, and the counts, integers below 2^24, are the plain
// version's exactly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;                // points staged at a time
constexpr int kChunks = kTile / kThreads;  // points a thread stages per tile
constexpr int R = 4;                       // hypotheses a lane
constexpr int HB = 32 * R;                 // hypotheses a block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 32 * 32, "one warp scans the tile's 32 groups of 32 points");

// c += (dot > 0 && dd > tv), as two compares and one predicated add.
__device__ __forceinline__ void count_inlier(int& c, float dot, float dd, float tv) {
  asm("{\n.reg .pred p;\nsetp.gt.f32 p, %1, 0f00000000;\n"
      "setp.gt.and.f32 p, %2, %3, p;\n@p add.s32 %0, %0, 1;\n}\n"
      : "+r"(c)
      : "f"(dot), "f"(dd), "f"(tv));
}

__global__ void __launch_bounds__(kThreads)
vote_expanded_bcast_kernel(const float2* __restrict__ hyps, const float2* __restrict__ pts,
                           const float2* __restrict__ dirs, const float* __restrict__ pvalid,
                           float* __restrict__ out, int M, int H, int P, float t2) {
  __shared__ float4 s_pd[kTile];  // 2px, 2py, dx, dy
  __shared__ float2 s_cq[kTile];  // cc, qq
  __shared__ int s_off[32];
  __shared__ int s_n;
  __shared__ int s_part[kWarps][HB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nx = (H + HB - 1) / HB;
  const int m = blockIdx.x / nx;
  const int h0 = (blockIdx.x % nx) * HB;

  float hx[R], hy[R], hsq[R];
  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = h0 + r * 32 + lane;
    const float2 v = h < H ? hyps[(int64_t)m * H + h] : make_float2(0.0f, 0.0f);
    hx[r] = v.x;
    hy[r] = v.y;
    hsq[r] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    acc[r] = 0;
  }
  const float2* mp = pts + (int64_t)m * P;
  const float2* md = dirs + (int64_t)m * P;
  const float* mv = pvalid + (int64_t)m * P;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = 0; base < P; base += kTile) {
    const int n = min(kTile, P - base);
    // Point j of the tile is lane j % 32 of group j / 32 = c * kWarps + warp.
    float2 p[kChunks], d[kChunks];
    bool valid[kChunks];
    unsigned ball[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * kThreads + threadIdx.x;
      valid[c] = false;
      if (j < n) {
        p[c] = mp[base + j];
        d[c] = md[base + j];
        valid[c] = mv[base + j] != 0.0f;
      }
      ball[c] = __ballot_sync(kFull, valid[c]);
    }
    __syncthreads();  // the previous tile is consumed
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) s_off[c * kWarps + warp] = __popc(ball[c]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of the 32 groups' counts
      const int own = s_off[lane];
      int incl = own;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += o;
      }
      s_off[lane] = incl - own;
      if (lane == 31) s_n = incl;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (valid[c]) {
        const int at = s_off[c * kWarps + warp] + __popc(ball[c] & lanes_below);
        const float cc = __fadd_rn(__fmul_rn(p[c].x, d[c].x), __fmul_rn(p[c].y, d[c].y));
        const float qq = __fadd_rn(__fmul_rn(p[c].x, p[c].x), __fmul_rn(p[c].y, p[c].y));
        s_pd[at] = make_float4(__fmul_rn(2.0f, p[c].x), __fmul_rn(2.0f, p[c].y),
                               d[c].x, d[c].y);
        s_cq[at] = make_float2(cc, qq);
      }
    }
    __syncthreads();
    const int nv = s_n;
    const int per = (nv + kWarps - 1) / kWarps;
    const int j0 = min(nv, warp * per);
    const int j1 = min(nv, j0 + per);
#pragma unroll 2
    for (int j = j0; j < j1; ++j) {
      const float4 q = s_pd[j];
      const float2 c = s_cq[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dot =
            __fsub_rn(__fadd_rn(__fmul_rn(hx[r], q.z), __fmul_rn(hy[r], q.w)), c.x);
        const float hp2 = __fadd_rn(__fmul_rn(hx[r], q.x), __fmul_rn(hy[r], q.y));
        const float vsq = __fadd_rn(__fsub_rn(hsq[r], hp2), c.y);
        count_inlier(acc[r], dot, __fmul_rn(dot, dot), __fmul_rn(t2, vsq));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) s_part[warp][r * 32 + lane] = acc[r];
  __syncthreads();
  float* mo = out + (int64_t)m * H;
  for (int i = threadIdx.x; i < HB; i += kThreads) {
    if (h0 + i >= H) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += s_part[w][i];
    mo[h0 + i] = (float)s;
  }
}

}  // namespace

extern "C" int fpcnn_vote_expanded_bcast(const float* hyps, const float* pts,
                                         const float* dirs, const float* pvalid,
                                         float* out, int M, int H, int P, float t2,
                                         void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)(((H + HB - 1) / HB) * M);
  vote_expanded_bcast_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, out, M, H, P, t2);
  return (int)cudaGetLastError();
}
