// RANSAC inlier counts:
//   counts[m, h] = sum_p pv[m, p] * [dot > 0 && dot^2 > t2 * vsq],
//   a = hyp[m, h] - pt[m, p],  dot = a . dir[m, p],  vsq = |a|^2.
//
// Replaces the TPU kernel `_vote_count_kernel` (launched by
// `vote_counts_pallas`, fastposecnn_tpu/ops/voting.py:282-420), which tiles
// 8 slots x 128 hypotheses over the TPU's vector unit and skips blocks of
// inactive slots through a prefetched flag.
//
// Bound: FP32 issue. Each (m, h, p) cell costs 11 unfused FP32 operations
// (2 sub, 6 mul, 3 add) plus two compares and the predicated add; the bytes
// are a few per (m, h) and per (m, p), so memory is far from the limit.
//
// Design: a block owns one slot m and HB = 64 hypotheses; its 16 warps
// split the slot's points into contiguous ranges, and each lane keeps R = 2
// hypotheses in registers. So one broadcast shared-memory read of a point
// (px, py, dx, dy packed as one float4, plus pv) feeds two independent
// chains, and a thread walks P / 16 points instead of P: a slot with few
// hypotheses still keeps 16 warps of an SM busy. Points are staged 1024 at
// a time, and only those with pv != 0 (an order-keeping compaction by warp
// ballots and one prefix sum), since the others add nothing. Each warp
// leaves its partial counts in shared memory and HB threads add the 16
// partials in warp order, so one launch writes every count: no atomics, no
// second pass.
//
// Placement: the grid has a block for every (slot, hypothesis block), but
// block b takes the b-th unit of work with the active slots' units first
// (each block ranks the `active` flags itself), so the busy blocks are
// dispatched first. Each block also reserves more than a third of an SM's
// shared memory, so no SM holds more than two: with few active slots the
// busy blocks spread over all SMs, two at most on each, instead of three on
// some while others hold only the inactive slots' blocks. A block of an
// inactive slot writes zeros and returns before any barrier.
//
// Arithmetic: subtract first, then products and sums written as __fmul_rn /
// __fadd_rn so no multiply-add is fused (the library is also built with
// -fmad=false): a fused multiply-add flips borderline cells against the
// reference. pv is 0 or 1, so every partial count is an integer below 2^24
// and the split over warps and tiles gives exactly the reference's counts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 1024;
constexpr int kChunks = kTile / kThreads;  // points a thread stages per tile
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 32 * 32, "one warp scans the tile's 32 groups of 32 points");
// Each block asks for this much dynamic shared memory, of which the point
// tile uses 20 KB: more than a third of an SM's 227 KB, so at most two blocks
// share an SM and the busy blocks, dispatched first, spread over all SMs.
constexpr int kSmemBytes = 80 * 1024;
static_assert(kTile * (sizeof(float4) + sizeof(float)) <= kSmemBytes, "tile fits");
constexpr int R = 2;         // hypotheses a lane
constexpr int HB = 32 * R;   // hypotheses a block
constexpr int kMaxDevices = 64;

// The number of slots whose flag is nonzero; warp-uniform.
__device__ int count_active(const int32_t* active, int M) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int c = 0; c < M; c += 32)
    n += __popc(__ballot_sync(kFull, c + lane < M && active[c + lane] != 0));
  return n;
}

// The index of the k-th (from 0) slot whose flag is nonzero (busy) or zero
// (!busy); warp-uniform.
__device__ int kth_slot(const int32_t* active, int M, int k, bool busy) {
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < M; c += 32) {
    const bool hit = c + lane < M && (active[c + lane] != 0) == busy;
    const unsigned b = __ballot_sync(kFull, hit);
    if (k < __popc(b)) {
      const unsigned sel = __ballot_sync(
          kFull, hit && __popc(b & ((1u << lane) - 1u)) == k);
      return c + __ffs(sel) - 1;
    }
    k -= __popc(b);
  }
  return 0;  // not reached: k is below the number of such slots
}

__global__ void __launch_bounds__(kThreads)
vote_count_kernel(const float2* __restrict__ hyps, const float2* __restrict__ pts,
                  const float2* __restrict__ dirs, const float* __restrict__ pvalid,
                  const int32_t* __restrict__ active, float* __restrict__ out,
                  int M, int H, int P, float t2) {
  extern __shared__ float4 s_dyn[];
  float4* s_q = s_dyn;                                  // [kTile]
  float* s_pv = reinterpret_cast<float*>(s_dyn + kTile);  // [kTile]
  __shared__ int s_off[32];
  __shared__ int s_n;
  __shared__ float s_part[kWarps][HB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nx = (H + HB - 1) / HB;
  const int n_act = active == nullptr ? M : count_active(active, M);
  const int busy_blocks = n_act * nx;
  const bool busy = (int)blockIdx.x < busy_blocks;
  const int unit = busy ? (int)blockIdx.x : (int)blockIdx.x - busy_blocks;
  const int m = active == nullptr ? unit / nx : kth_slot(active, M, unit / nx, busy);
  const int h0 = (unit % nx) * HB;
  float* mo = out + (int64_t)m * H;
  if (!busy) {
    for (int i = threadIdx.x; i < HB; i += kThreads)
      if (h0 + i < H) mo[h0 + i] = 0.0f;
    return;  // uniform over the block: no barrier is skipped by some threads only
  }

  float hx[R], hy[R], acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = h0 + r * 32 + lane;
    const float2 v = h < H ? hyps[(int64_t)m * H + h] : make_float2(0.0f, 0.0f);
    hx[r] = v.x;
    hy[r] = v.y;
    acc[r] = 0.0f;
  }
  const float2* mp = pts + (int64_t)m * P;
  const float2* md = dirs + (int64_t)m * P;
  const float* mv = pvalid + (int64_t)m * P;
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int base = 0; base < P; base += kTile) {
    const int n = min(kTile, P - base);
    // Point j of the tile is lane j % 32 of group j / 32 = c * kWarps + warp.
    float4 q[kChunks];
    float v[kChunks];
    unsigned ball[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = c * kThreads + threadIdx.x;
      v[c] = 0.0f;
      if (j < n) {
        const float2 p = mp[base + j];
        const float2 d = md[base + j];
        q[c] = make_float4(p.x, p.y, d.x, d.y);
        v[c] = mv[base + j];
      }
      ball[c] = __ballot_sync(kFull, v[c] != 0.0f);
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
      for (int d = 1; d < 32; d <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += o;
      }
      s_off[lane] = incl - own;
      if (lane == 31) s_n = incl;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (v[c] != 0.0f) {
        const int at = s_off[c * kWarps + warp] + __popc(ball[c] & lanes_below);
        s_q[at] = q[c];
        s_pv[at] = v[c];
      }
    }
    __syncthreads();
    const int nv = s_n;
    const int per = (nv + kWarps - 1) / kWarps;
    const int j0 = min(nv, warp * per);
    const int j1 = min(nv, j0 + per);
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const float4 p = s_q[j];
      const float w = s_pv[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ax = __fsub_rn(hx[r], p.x);
        const float ay = __fsub_rn(hy[r], p.y);
        const float dot = __fadd_rn(__fmul_rn(ax, p.z), __fmul_rn(ay, p.w));
        const float vsq = __fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay));
        // A predicated add: acc + 0 is acc, so skipping the add is exact.
        if ((dot > 0.0f) && (__fmul_rn(dot, dot) > __fmul_rn(t2, vsq)))
          acc[r] = __fadd_rn(acc[r], w);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) s_part[warp][r * 32 + lane] = acc[r];
  __syncthreads();
  for (int i = threadIdx.x; i < HB; i += kThreads) {
    if (h0 + i >= H) continue;
    float s = s_part[0][i];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, s_part[w][i]);
    mo[h0 + i] = s;
  }
}

}  // namespace

extern "C" int fpcnn_vote_count(const float* hyps, const float* pts,
                                const float* dirs, const float* pvalid,
                                const int32_t* active, float* out, int M, int H,
                                int P, float t2, void* stream) {
  if (M == 0 || H == 0) return (int)cudaSuccess;
  // Above 48 KB of dynamic shared memory a kernel must opt in, once a device.
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(vote_count_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const unsigned blocks = (unsigned)(((H + HB - 1) / HB) * M);
  vote_count_kernel<<<blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      reinterpret_cast<const float2*>(hyps), reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float2*>(dirs), pvalid, active, out, M, H, P, t2);
  return (int)cudaGetLastError();
}
