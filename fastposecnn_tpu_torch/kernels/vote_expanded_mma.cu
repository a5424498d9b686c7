// RANSAC inlier counts in the expanded form, on the tensor cores (probe P1):
//   dot[m, h, p] = [hx, hy, 1] . [dx, dy, -cc]                    (K = 3)
//   vsq[m, h, p] = [hx^2, hy^2, hx, hy, 1] . [1, 1, -2px, -2py, qq]  (K = 5)
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   cc = px*dx + py*dy, qq = px^2 + py^2, hx^2 = hx*hx, in float32.
//
// Replaces the TPU probe kernel `kernel_b` (scripts/probe_vote_variants.py:106,
// launched by `variant_b` at :136, `pallas_call` at :146), which ran the two
// products on the TPU's matrix unit at Precision.HIGHEST.
//
// Bound: tensor-core issue. Each product is 3xTF32 (big*big + big*small +
// small*big, where big = tf32(x) and small = tf32(x - big)), so a cell needs
// 3 passes x (3 + 5) multiply-adds, 48 operations at the card's 495 TF32
// TFLOP/s, against 2 FP32 multiplies of the epilogue (dot^2, t2*vsq) at
// 33.5 T/s unfused: the tensor cores bound it. Bytes are a few per (m, h) and
// per (m, p). The design below pads both products to K = 8, so it issues
// twice the tensor-core work the bound counts.
//
// Design: one block of 4 warps owns one slot m and 128 hypotheses; each warp
// keeps two 16-hypothesis tiles in registers as A fragments of
// mma.sync.m16n8k8 (row = hypothesis, K = feature, padded to 8), split once
// into big and small halves. The block stages 128 points at a time in shared
// memory as ready B fragments (each feature already split; rows padded so the
// four k-rows a warp reads fall on distinct banks), computed once per block and
// shared by its 128 hypotheses. Per 8 points a warp issues 2 tiles x 2
// products x 3 mma.sync, and the inlier test and the pv-weighted sum run on
// the accumulator fragments in registers; at the end the 4 lanes of a quad
// (which hold the same two hypothesis rows) add their partial counts with
// two shuffles. Simple first: no wgmma, no TMA, every point staged (pv = 0
// points add 0).
//
// Exactness: 3xTF32 rounds differently from an FP32 product (the small*small
// term is dropped and the tensor core accumulates in its own order), so the
// counts are not those of the plain version bit for bit; the rounding band of
// `probes/vote_variants.py::expanded_vote_band` (c = 32, derived there) holds
// them. The operands are formed with __fmul_rn / __fadd_rn as the plain
// version forms them, the small products are added before the big one, and
// pv is 0 or 1, so the quad's and the tiles' sums are exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int R = 2;                     // 16-hypothesis tiles a warp
constexpr int HB = 16 * R * kWarps;      // hypotheses a block
constexpr int kPT = 128;                 // points staged at a time
constexpr int kPad = 8;                  // float2 padding of a k-row
constexpr unsigned kFull = 0xffffffffu;
static_assert(kPT == kThreads, "each thread stages one point");

// Round to TF32 (nearest, ties away) and clear the 13 low bits, so the value
// is exactly what the tensor core reads.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// (big, small) with big = tf32(x), small = tf32(x - big); x - big is exact.
__device__ __forceinline__ uint2 split(float x) {
  const uint32_t big = tf32_rna(x);
  return make_uint2(big, tf32_rna(__fsub_rn(x, __uint_as_float(big))));
}

// d += A (16x8, row) * B (8x8, col), TF32 in, FP32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads)
vote_expanded_mma_kernel(const float2* __restrict__ hyps, const float2* __restrict__ pts,
                         const float2* __restrict__ dirs, const float* __restrict__ pvalid,
                         float* __restrict__ out, int M, int H, int P, float t2) {
  // B fragments, k-rows 0..3 of each product (rows 4..7 are 0 but for vsq's
  // k = 4, qq): s_bd = dx, dy, -cc, 0; s_bv = 1, 1, -2px, -2py.
  __shared__ uint2 s_bd[4][kPT + kPad];
  __shared__ uint2 s_bv[4][kPT + kPad];
  __shared__ uint2 s_bq[kPT];
  __shared__ float2 s_pv[kPT / 2];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;  // fragment row (hypothesis) and B column (point)
  const int t = lane & 3;   // fragment k and output column pair
  const int nx = (H + HB - 1) / HB;
  const int m = blockIdx.x / nx;
  const int h0 = (blockIdx.x % nx) * HB + warp * 16 * R;

  // A fragments: a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4].
  // dot's A row is [hx, hy, 1, 0 ...] (a2 = a3 = 0); vsq's is
  // [hx^2, hy^2, hx, hy, 1, 0 ...] (a2 = a3 = 1 for t = 0, else 0; exact in TF32).
  uint2 ad[R][2], av[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int h = h0 + 16 * r + 8 * half + g;
      const float2 v = h < H ? hyps[(int64_t)m * H + h] : make_float2(0.0f, 0.0f);
      const float fd = t == 0 ? v.x : t == 1 ? v.y : t == 2 ? 1.0f : 0.0f;
      const float fv = t == 0 ? __fmul_rn(v.x, v.x) : t == 1 ? __fmul_rn(v.y, v.y)
                                                    : t == 2 ? v.x : v.y;
      ad[r][half] = split(fd);
      av[r][half] = split(fv);
    }
  }
  const uint32_t av_k4 = t == 0 ? __float_as_uint(1.0f) : 0u;

  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;

  const int64_t mp = (int64_t)m * P;
  const uint2 one = make_uint2(__float_as_uint(1.0f), 0u);
  for (int base = 0; base < P; base += kPT) {
    __syncthreads();  // the previous tile is consumed
    {
      const int i = threadIdx.x;
      float px = 0.0f, py = 0.0f, dx = 0.0f, dy = 0.0f, w = 0.0f;
      if (base + i < P) {
        const float2 p = pts[mp + base + i];
        const float2 d = dirs[mp + base + i];
        px = p.x, py = p.y, dx = d.x, dy = d.y;
        w = pvalid[mp + base + i];
      }
      const float cc = __fadd_rn(__fmul_rn(px, dx), __fmul_rn(py, dy));
      const float qq = __fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py));
      s_bd[0][i] = split(dx);
      s_bd[1][i] = split(dy);
      s_bd[2][i] = split(-cc);
      s_bd[3][i] = make_uint2(0u, 0u);
      s_bv[0][i] = one;
      s_bv[1][i] = one;
      s_bv[2][i] = split(__fmul_rn(-2.0f, px));
      s_bv[3][i] = split(__fmul_rn(-2.0f, py));
      s_bq[i] = split(qq);
      reinterpret_cast<float*>(s_pv)[i] = w;
    }
    __syncthreads();
    const int n = min(kPT, P - base);
    for (int j = 0; j < n; j += 8) {
      const uint2 bd = s_bd[t][j + g];
      const uint2 bv = s_bv[t][j + g];
      const uint2 bq = t == 0 ? s_bq[j + g] : make_uint2(0u, 0u);
      const float2 w = s_pv[(j >> 1) + t];  // points j + 2t and j + 2t + 1
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float dd[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float vv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        // small * big, big * small, then big * big.
        mma_tf32(dd, ad[r][0].y, ad[r][1].y, 0u, 0u, bd.x, 0u);
        mma_tf32(dd, ad[r][0].x, ad[r][1].x, 0u, 0u, bd.y, 0u);
        mma_tf32(dd, ad[r][0].x, ad[r][1].x, 0u, 0u, bd.x, 0u);
        mma_tf32(vv, av[r][0].y, av[r][1].y, 0u, 0u, bv.x, bq.x);
        mma_tf32(vv, av[r][0].x, av[r][1].x, av_k4, av_k4, bv.y, bq.y);
        mma_tf32(vv, av[r][0].x, av[r][1].x, av_k4, av_k4, bv.x, bq.x);
        // d[i] is row g + 8 * (i >> 1), point j + 2t + (i & 1).
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = dd[i];
          if ((d > 0.0f) && (__fmul_rn(d, d) > __fmul_rn(t2, vv[i])))
            acc[r][i >> 1] = __fadd_rn(acc[r][i >> 1], (i & 1) ? w.y : w.x);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = acc[r][half];
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 1));
      s = __fadd_rn(s, __shfl_xor_sync(kFull, s, 2));
      const int h = h0 + 16 * r + 8 * half + g;
      if (t == 0 && h < H) out[(int64_t)m * H + h] = s;
    }
  }
}

}  // namespace

extern "C" int fpcnn_vote_expanded_mma(const float* hyps, const float* pts,
                                       const float* dirs, const float* pvalid,
                                       float* out, int M, int H, int P, float t2,
                                       void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  const unsigned blocks = (unsigned)(((H + HB - 1) / HB) * M);
  vote_expanded_mma_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, out, M, H, P, t2);
  return (int)cudaGetLastError();
}
