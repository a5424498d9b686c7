// Connected-component labelling of 4-connected foreground, one label per
// pixel: the smallest row-major linear index of its component, -1 on
// background.
//
// Replaces the TPU kernel `_cc_pallas_kernel` (launched by
// `label_components_pallas`, fastposecnn_tpu/ops/connected_components.py:
// 85-196), which keeps the whole image in VMEM and repeats segmented
// run-min scans until nothing changes. A 480x640 int32 image is 1.2 MB and
// does not fit in one SM's shared memory, so this is union-find over the
// label array in device memory (ECL-CC style hooking), in four launches
// over the batch:
//   init          each fg pixel points at the start of its horizontal run;
//   merge         each run unions with the runs above it: a root is hooked
//                 under a smaller node of the other tree by atomicCAS,
//                 which only a root can pass, and finds shorten the paths
//                 they walk;
//   flatten_runs  each run start's label becomes its root, by pointer
//                 jumping;
//   flatten_rest  every other pixel takes its run start's label.
// Parents only ever decrease, so a root is its tree's smallest index; after
// the merge each component is one tree, so the label is the component's
// smallest index -- the output depends only on the partition.
//
// The mask is read as bytes (a bool tensor as is). Bound: the work is
// memory-bound (read the mask once, write the labels once: 1.5 MB at
// 480x640, under half a microsecond of HBM time); the walks cost more.
// Every device loop carries a hard step bound; passing it sets *err and the
// thread gives up, and the wrapper raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void flag_error(int32_t* err) { atomicExch(err, 1); }

__device__ __forceinline__ bool run_start(const uint8_t* f, int32_t p, int W) {
  return p % W == 0 || f[p - 1] == 0;
}

// Root of `x` during the merge (`L` points at one image's labels). Each node
// passed is re-pointed at its grandparent by a plain store. That is safe
// because only atomicCAS(L[r], r, .) changes a root: a stored node is no
// root and never becomes one, and trees only ever hang whole under other
// roots, so an ancestor stays an ancestor.
__device__ __forceinline__ int32_t find_compress(int32_t* L, int32_t x,
                                                 int64_t bound, int32_t* err) {
  int32_t cur = L[x];
  if (cur == x) return x;
  int32_t prev = x, next;
  for (int64_t s = 0; cur > (next = L[cur]); ++s) {
    if (s > bound) { flag_error(err); return cur; }
    L[prev] = next;
    prev = cur;
    cur = next;
  }
  return cur;
}

// Each fg pixel points at the start of its horizontal run. A warp covers
// 32 consecutive pixels: a ballot of the run starts among them gives each
// lane the nearest start at or left of it; lanes whose run began before the
// warp share one search over earlier 32-pixel segments (at most W/32 + 1;
// a pixel in column 0 is always a start, so runs never cross rows).
__global__ void cc_init(const uint8_t* __restrict__ fg, int32_t* __restrict__ L,
                        int B, int H, int W, int32_t* err) {
  const int64_t n = (int64_t)B * H * W;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t base = i - (threadIdx.x & 31);  // the warp's first pixel
  const unsigned lane = threadIdx.x & 31;
  // Whole warps run (blockDim is a multiple of 32); lanes past n hold bg.
  // `cj` is the column of pixel j (kept without a 64-bit modulo per step).
  auto is_start = [&](int64_t j, int32_t cj) {
    return j < n && fg[j] != 0 && (cj == 0 || fg[j - 1] == 0);
  };
  const int32_t col = (int32_t)(i % W);
  const bool on = i < n && fg[i] != 0;
  const unsigned starts = __ballot_sync(0xffffffffu, is_start(i, col));
  const unsigned mine = starts & (0xffffffffu >> (31 - lane));
  int64_t start = base + 31 - __clz(mine);  // unused when mine == 0
  if (__any_sync(0xffffffffu, on && mine == 0)) {
    int64_t far = -1;
    int32_t cj = col;
    for (int64_t seg = base - 32, s = 0; seg >= 0; seg -= 32, ++s) {
      if (s > W / 32 + 1) { flag_error(err); break; }
      for (cj -= 32; cj < 0;) cj += W;
      const unsigned st = __ballot_sync(0xffffffffu, is_start(seg + lane, cj));
      if (st) { far = seg + 31 - __clz(st); break; }
    }
    if (mine == 0) start = far;
  }
  if (i >= n) return;
  const int64_t image = i - i % ((int64_t)H * W);
  L[i] = on ? (int32_t)(start - image) : -1;
}

__global__ void cc_merge(const uint8_t* __restrict__ fg, int32_t* L,
                         int B, int H, int W, int32_t* err) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t hw = (int64_t)H * W;
  if (i >= (int64_t)B * hw) return;
  int32_t p = (int32_t)(i % hw);
  const uint8_t* f = fg + (i - p);
  int32_t* Li = L + (i - p);
  int32_t r = p / W, c = p % W;
  if (r == 0 || f[p] == 0 || f[p - W] == 0) return;
  // The run of the left neighbour already unions with the same run above.
  if (c > 0 && f[p - 1] != 0 && f[p - W - 1] != 0) return;
  const int64_t bound = 2 * hw + 2;
  // a: the root of this run's tree (found from the run start, init's
  // parent, so that the find's stores only touch run starts). b: the upper
  // run's start, a node of the other tree. A root may hang under any
  // smaller node of another tree, so when a > b no find of b is needed:
  // a chain of runs, one under the next, is then hooked without walking it
  // (the flatten resolves such chains).
  int32_t a = find_compress(Li, Li[p], hw, err);
  int32_t b = Li[p - W];
  for (int64_t s = 0; a != b; ++s) {
    if (s > bound) { flag_error(err); return; }
    if (a < b) {
      // b's root must hang under a, or a under it.
      b = find_compress(Li, b, hw, err);
      if (a == b) return;
      if (a < b) { int32_t t = a; a = b; b = t; }
    }
    // Hook root a under b < a. If a is no root any more, the CAS returns
    // its parent (smaller than a), and the union carries on from there.
    int32_t old = atomicCAS(&Li[a], a, b);
    if (old == a) return;
    a = old;
  }
}

// Run starts: pointer jumping. Each run start's thread sets its own label
// to its parent's current label until its parent is a root. Threads write
// only their own node, and every value read is an ancestor, so the label
// only climbs; as all run starts jump at once, each jump about doubles the
// reach (list ranking), and a chain of D hooked runs resolves in about
// log2(D) steps rather than D. Loads bypass L1 (__ldcg) to see the other
// threads' jumps.
__global__ void cc_flatten_runs(const uint8_t* __restrict__ fg, int32_t* L,
                                int B, int H, int W, int32_t* err) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t hw = (int64_t)H * W;
  if (i >= (int64_t)B * hw) return;
  int32_t p = (int32_t)(i % hw);
  const uint8_t* f = fg + (i - p);
  int32_t* Li = L + (i - p);
  if (f[p] == 0 || !run_start(f, p, W)) return;
  int32_t q = __ldcg(&Li[p]);
  for (int64_t s = 0;; ++s) {
    int32_t g = __ldcg(&Li[q]);
    if (g == q) return;  // q is the root, and Li[p] holds it
    if (s > hw) { flag_error(err); return; }
    Li[p] = g;
    q = g;
  }
}

// Every other fg pixel still points at its run start (every label value
// is a run start, and the merge writes only nodes on paths from run
// starts), which now holds the root.
__global__ void cc_flatten_rest(const uint8_t* __restrict__ fg, int32_t* L,
                                int B, int H, int W) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t hw = (int64_t)H * W;
  if (i >= (int64_t)B * hw) return;
  int32_t p = (int32_t)(i % hw);
  const uint8_t* f = fg + (i - p);
  int32_t* Li = L + (i - p);
  if (f[p] == 0 || run_start(f, p, W)) return;
  Li[p] = Li[Li[p]];
}

}  // namespace

extern "C" int fpcnn_cc_label(const uint8_t* fg, int32_t* labels, int32_t* err,
                              int B, int H, int W, void* stream) {
  int64_t n = (int64_t)B * H * W;
  if (n == 0) return (int)cudaSuccess;
  const int threads = 256;
  unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  cc_init<<<blocks, threads, 0, s>>>(fg, labels, B, H, W, err);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_merge<<<blocks, threads, 0, s>>>(fg, labels, B, H, W, err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_flatten_runs<<<blocks, threads, 0, s>>>(fg, labels, B, H, W, err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_flatten_rest<<<blocks, threads, 0, s>>>(fg, labels, B, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* fpcnn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
