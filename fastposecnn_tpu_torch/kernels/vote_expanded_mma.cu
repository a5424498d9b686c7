// RANSAC inlier counts in the expanded form, on the tensor cores (probe P1):
//   dot[m, h, p] = [hx, hy, 1] . [dx, dy, -cc]
//   t2 * vsq[m, h, p] = [hx, hy, 1, hsq] . t2 * [-2px, -2py, qq, 1]
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   cc = px*dx + py*dy, qq = px^2 + py^2, hsq = hx^2 + hy^2, in float32.
//
// Replaces the TPU probe kernel `kernel_b` (scripts/probe_vote_variants.py:106,
// launched by `variant_b` at :136, `pallas_call` at :146), which ran the same
// counts as two matrix products (K = 3 and K = 5) on the TPU's matrix unit at
// Precision.HIGHEST.
//
// Bound: tensor-core issue. 3xTF32 (big*big + big*small + small*big, big =
// tf32(x), small = tf32(x - big)) of the two products is counted as 3 passes
// x (3 + 5) multiply-adds, 48 operations a valid cell at the card's 495 TF32
// TFLOP/s, against the test's multiply at 33.5 T/s unfused. Bytes are a few
// per (m, h) and per (m, p). Two floors sit above it. The layout below issues
// 64 tensor operations a cell (two k8 steps of two columns), and with K = 8
// each wgmma reads and writes as many accumulator bytes as it does
// multiply-adds. At the probe's 16x4096x1024 the products take 8.1 us at
// the H100 SXM's TF32 peak and the test on the accumulators, 4
// instructions a cell on the CUDA cores, 7.5 us at its 1980 MHz boost
// clock (both computed); measured, the two add rather than overlap (two
// accumulator sets with `wgmma.wait_group 1` gained nothing), as both load
// the register file.
//
// Layout: one product computes both. A hypothesis row is shared by the two
// outputs, and each point owns two adjacent columns, (dot, t2*vsq), so in the
// accumulator layout of wgmma a thread holds one point's two values. t2 is
// folded into the vsq column (so the test needs no multiply by t2), and the
// 3xTF32 split into K = 16: features that are exact in TF32 (1, and the 0s)
// have no small part, so the eight nonzero small products fit in the first
// k8 step and the four big ones in the first half of the second, which adds
// them to the small sum as its C:
//   step 1 (small), A' = [hx_s, hx_b, hy_s, hy_b, 1, hsq_s, hsq_b, 0]
//     dot column  [dx_b, dx_s, dy_b, dy_s, ncc_s, 0, 0, 0]
//     vsq column  [npx_b, npx_s, npy_b, npy_s, tqq_s, t2_b, t2_s, 0]
//   step 2 (big),   A'' = [hx_b, hy_b, 1, hsq_b, 0, 0, 0, 0]
//     dot column  [dx_b, dy_b, ncc_b, 0, 0, 0, 0, 0]
//     vsq column  [npx_b, npy_b, tqq_b, t2_b, 0, 0, 0, 0]
// (ncc = -cc, npx = t2*(-2px), npy = t2*(-2py), tqq = t2*qq, each rounded to
// float32; _b big, _s small). In shared memory the B operand of a compacted
// point q sits K-major in core matrices of 8 columns x 4 features (16 bytes
// a column): word (q/4)*128 + kk*32 + (2*(q%4) + s)*4 + k%4, kk = 2*step +
// k/4, s = 0 for dot, 1 for vsq: wgmma's layout without swizzle (leading
// byte offset 128 between the two k-halves of a step, stride byte offset 512
// between 8-column groups).
//
// Design: a block of 4 warpgroups owns one slot m and `tpb` tiles of 64
// hypotheses (the launcher spreads a slot's tiles over about one block an
// SM: 8 tiles a block at the probe's shapes), so the slot's points are
// staged once for all of them. The
// block stages 1536 points at a time (once for P <= 1536), only those with
// pv != 0 (an order-keeping compaction by ballots and a prefix sum), as ready
// B features, each point split once by one thread, padded with zero columns
// to 64 points (a padded dot is exactly 0, so it never counts). A warpgroup
// keeps its tile's A fragments in registers and, per 64 points, issues two
// wgmma.mma_async m64n128k8 (A from registers, B from shared memory by
// descriptor), waits, and tests the 32 cells a thread holds with a predicated
// integer add. The 4 lanes that hold the same two hypothesis rows add their
// counts with two shuffles; a later chunk adds to the counts in `out`. A
// simpler block of 128 hypotheses that split its points itself (its 32
// blocks a slot split the same points 32 times), and an mma.sync design with
// the same layout (one m16n8k8 and one m16n8k4 per 4 points), were measured
// slower (PERF.md).
//
// Exactness: 3xTF32 rounds differently from an FP32 product, so the counts
// are not those of the plain version bit for bit; the rounding band of
// `probes/vote_variants.py::expanded_vote_band` (c = 32, derived there for
// this order) holds them. The operands are formed with __fmul_rn /
// __fadd_rn, the small products are summed before the big ones, and the big
// step holds four nonzero products within one half of its k8, so the bound
// holds however the tensor core groups a k8 step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 4;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                  // hypotheses a warpgroup tile
constexpr int kChunk = 1536;               // points staged at a time
constexpr int kPer = kChunk / kThreads;    // points a thread stages
constexpr int kGroups = kChunk / 32;       // ballot groups of a chunk
constexpr int kTilePts = 64;               // points a wgmma tile (N = 128)
constexpr int kGroupWords = 128;           // B words of 4 points
constexpr int kTileBytes = kTilePts / 4 * kGroupWords * 4;
constexpr int kSmemBytes = kChunk / 4 * kGroupWords * 4;  // 192 KB
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kOne = 0x3f800000u;     // 1.0f, exact in TF32
constexpr int kMaxDevices = 64;
static_assert(kChunk % kTilePts == 0, "padding stays inside the chunk");

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

__device__ __forceinline__ uint32_t pick(int t, uint32_t x0, uint32_t x1, uint32_t x2,
                                         uint32_t x3) {
  return t == 0 ? x0 : t == 1 ? x1 : t == 2 ? x2 : x3;
}

// c += (dot > 0 && dot^2 > tv), as two compares and one predicated add: in
// C++ the compiler branches, or selects, per cell.
__device__ __forceinline__ void count_inlier(int& c, float dot, float tv) {
  const float dd = __fmul_rn(dot, dot);
  asm("{\n.reg .pred p;\nsetp.gt.f32 p, %1, 0f00000000;\n"
      "setp.gt.and.f32 p, %2, %3, p;\n@p add.s32 %0, %0, 1;\n}\n"
      : "+r"(c)
      : "f"(dot), "f"(dd), "f"(tv));
}

// wgmma's shared-memory descriptor of a K-major operand without swizzle:
// start address, leading byte offset 128 (the next 4 features), stride byte
// offset 512 (the next 8 columns), all in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3ffffu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(512 >> 4) << 32);
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64x8, registers) * B (8x128, shared memory), TF32 in, FP32 out;
// scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__global__ void __launch_bounds__(kThreads, 1)
vote_expanded_mma_kernel(const float2* __restrict__ hyps, const float2* __restrict__ pts,
                         const float2* __restrict__ dirs, const float* __restrict__ pvalid,
                         float* __restrict__ out, int M, int H, int P, float t2, int bps,
                         int tpb) {
  extern __shared__ __align__(128) uint32_t s_b[];  // B features [kChunk / 4][128]
  __shared__ int s_off[kGroups];
  __shared__ int s_n;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp >> 2;
  const int g = lane >> 2;  // fragment row (hypothesis)
  const int t = lane & 3;   // fragment k and output column pair
  const int m = blockIdx.x / bps;
  const int tile0 = (blockIdx.x % bps) * tpb;
  const int tiles = (H + kRows - 1) / kRows;
  const float2* mp = pts + (int64_t)m * P;
  const float2* md = dirs + (int64_t)m * P;
  const float* mv = pvalid + (int64_t)m * P;
  float* mo = out + (int64_t)m * H;
  const unsigned lanes_below = (1u << lane) - 1u;
  uint4* s_b4 = reinterpret_cast<uint4*>(s_b);
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(s_b);
  const uint2 st2 = split(t2);

  for (int base = 0; base < P; base += kChunk) {
    const int n = min(kChunk, P - base);
    // Point j of the chunk is lane j % 32 of group j / 32 = c * kWarps + warp.
    float2 p[kPer], d[kPer];
    bool valid[kPer];
    unsigned ball[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = c * kThreads + threadIdx.x;
      valid[c] = false;
      if (j < n) {
        p[c] = mp[base + j];
        d[c] = md[base + j];
        valid[c] = mv[base + j] != 0.0f;
      }
      ball[c] = __ballot_sync(kFull, valid[c]);
    }
    __syncthreads();  // the previous chunk is consumed
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kPer; ++c) s_off[c * kWarps + warp] = __popc(ball[c]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive prefix sum of the groups' counts
      int carry = 0;
      for (int b0 = 0; b0 < kGroups; b0 += 32) {
        const int gi = b0 + lane;
        const int own = gi < kGroups ? s_off[gi] : 0;
        int incl = own;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, s);
          if (lane >= s) incl += o;
        }
        if (gi < kGroups) s_off[gi] = carry + incl - own;
        carry += __shfl_sync(kFull, incl, 31);
      }
      if (lane == 0) s_n = carry;
    }
    __syncthreads();
    const int nv = s_n;
    const int nvp = (nv + kTilePts - 1) / kTilePts * kTilePts;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      if (valid[c]) {
        const int q = s_off[c * kWarps + warp] + __popc(ball[c] & lanes_below);
        const float px = p[c].x, py = p[c].y, dx = d[c].x, dy = d[c].y;
        const uint2 sdx = split(dx), sdy = split(dy);
        const uint2 scc = split(-__fadd_rn(__fmul_rn(px, dx), __fmul_rn(py, dy)));
        const uint2 spx = split(__fmul_rn(t2, __fmul_rn(-2.0f, px)));
        const uint2 spy = split(__fmul_rn(t2, __fmul_rn(-2.0f, py)));
        const uint2 sqq =
            split(__fmul_rn(t2, __fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py))));
        uint4* at = s_b4 + (q >> 2) * 32 + 2 * (q & 3);  // + kk * 8 + s
        at[0] = make_uint4(sdx.x, sdx.y, sdy.x, sdy.y);
        at[1] = make_uint4(spx.x, spx.y, spy.x, spy.y);
        at[8] = make_uint4(scc.y, 0u, 0u, 0u);
        at[9] = make_uint4(sqq.y, st2.x, st2.y, 0u);
        at[16] = make_uint4(sdx.x, sdy.x, scc.x, 0u);
        at[17] = make_uint4(spx.x, spy.x, sqq.x, st2.x);
        at[24] = make_uint4(0u, 0u, 0u, 0u);
        at[25] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // Zero columns from nv up to the next multiple of 64 points.
    for (int q = nv + threadIdx.x; q < nvp; q += kThreads) {
      uint4* at = s_b4 + (q >> 2) * 32 + 2 * (q & 3);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        at[8 * kk] = at[8 * kk + 1] = make_uint4(0u, 0u, 0u, 0u);
    }
    // The tensor cores read shared memory through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    for (int r = wg; r < tpb; r += kWarpgroups) {
      const int tile = tile0 + r;
      if (tile >= tiles) break;  // uniform over the warpgroup
      const int hr = tile * kRows + 16 * (warp & 3) + g;  // rows hr and hr + 8
      // A fragments, features t and t + 4 of each step: a1 = A' (small
      // step), a2 = A'' (big step; features 4-7 are 0).
      uint32_t a1[4], a2[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int h = hr + 8 * half;
        const float2 v = h < H ? hyps[(int64_t)m * H + h] : make_float2(0.0f, 0.0f);
        const uint2 sx = split(v.x), sy = split(v.y);
        const uint2 sh = split(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y)));
        a1[half] = pick(t, sx.y, sx.x, sy.y, sy.x);
        a1[2 + half] = pick(t, kOne, sh.y, sh.x, 0u);
        a2[half] = pick(t, sx.x, sy.x, kOne, sh.x);
        a2[2 + half] = 0u;
      }
      int c0 = 0, c1 = 0;  // counts of rows hr and hr + 8
      float acc[64];
      for (int i = 0; i < nvp / kTilePts; ++i) {
        const uint32_t at = sbase + (uint32_t)(i * kTileBytes);
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_m64n128k8(acc, a1, b_desc(at), 0);        // the small products
        wgmma_m64n128k8(acc, a2, b_desc(at + 256), 1);  // the big ones, on top
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        // Column group c: acc[4c], acc[4c+1] are (dot, t2*vsq) of point
        // 4c + t at row hr, acc[4c+2], acc[4c+3] at row hr + 8.
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          count_inlier(c0, acc[4 * c], acc[4 * c + 1]);
          count_inlier(c1, acc[4 * c + 2], acc[4 * c + 3]);
        }
      }
      c0 += __shfl_xor_sync(kFull, c0, 1);
      c0 += __shfl_xor_sync(kFull, c0, 2);
      c1 += __shfl_xor_sync(kFull, c1, 1);
      c1 += __shfl_xor_sync(kFull, c1, 2);
      if (t == 0) {  // a later chunk adds to what this thread wrote
        if (hr < H) mo[hr] = base == 0 ? (float)c0 : mo[hr] + (float)c0;
        if (hr + 8 < H) mo[hr + 8] = base == 0 ? (float)c1 : mo[hr + 8] + (float)c1;
      }
    }
  }
}

}  // namespace

extern "C" int fpcnn_vote_expanded_mma(const float* hyps, const float* pts,
                                       const float* dirs, const float* pvalid,
                                       float* out, int M, int H, int P, float t2,
                                       void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once a device.
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(vote_expanded_mma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // About one block an SM: a slot's tiles go to `bps` blocks of `tpb` tiles
  // (a multiple of the 4 warpgroups), at least one tile a warpgroup.
  const int tiles = (H + kRows - 1) / kRows;
  int bps = (sms[dev] + M - 1) / M;
  bps = max(1, min(bps, (tiles + kWarpgroups - 1) / kWarpgroups));
  int tpb = (tiles + bps - 1) / bps;
  tpb = (tpb + kWarpgroups - 1) / kWarpgroups * kWarpgroups;
  bps = (tiles + tpb - 1) / tpb;
  vote_expanded_mma_kernel<<<(unsigned)(M * bps), kThreads, kSmemBytes,
                             (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, out, M, H, P, t2, bps, tpb);
  return (int)cudaGetLastError();
}
