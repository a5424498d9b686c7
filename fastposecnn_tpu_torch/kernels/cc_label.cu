// Connected-component labelling of 4-connected foreground, one label per
// pixel: the smallest row-major linear index of its component, -1 on
// background.
//
// Replaces the TPU kernel `_cc_pallas_kernel` (launched by
// `label_components_pallas`, fastposecnn_tpu/ops/connected_components.py:
// 85-196), which keeps the whole image in VMEM and repeats segmented
// run-min scans until nothing changes.
//
// Bound: bytes. The function reads the mask once (a bool tensor as is, one
// byte a pixel) and writes the labels once (four bytes a pixel): 1.5 MB at
// 480x640, under half a microsecond of HBM time. What costs more is the
// union-find's chains of dependent round trips to memory, and the launches.
// The design answers both: a 480x640 image of int32 labels (1.2 MB) does
// not fit in one SM's shared memory, so the image is cut into 32x32 tiles
// whose unions run in shared memory, and only the contacts across tile
// edges unite in device memory; and the whole batch takes three launches:
//   tile     one block a tile: the tile's mask as 32 row bitmasks (one warp
//            ballot a row), each foreground pixel pointing at its run's
//            start, the vertical contacts united by atomicCAS in shared
//            memory, pointer jumping to the tile-local roots; then each
//            pixel's global label is written: a tile-local root holds its
//            own index, any other pixel -2 - (its tile root's index);
//   border   only the contacts across tile edges (the pixels of a tile's
//            top row and left column), about 20k threads at 480x640 instead
//            of 307k: the tile roots' trees are united in device memory, a
//            root hooked under a smaller node of the other tree by
//            atomicCAS;
//   flatten  one block a tile again: each tile root climbs to its root by
//            pointer jumping, then the tile's other pixels copy their tile
//            root's label.
// Tile-local row-major order agrees with the image's, so a tile root is the
// smallest index of its part of the component, and parents only ever
// decrease: a root is its tree's smallest index, and after the border
// phase each component is one tree, so the label is the component's
// smallest index whatever order the unions ran in.
//
// Every device loop carries a hard step bound; passing it sets *err and the
// thread gives up, and the wrapper (or the entry point) raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;            // tile side: a warp's lanes span one tile row
constexpr int TILE_THREADS = 256;   // 8 warps, 4 tile rows each
constexpr int ROWS_PER_WARP = TILE / (TILE_THREADS / 32);
constexpr int TILE_PIXELS = TILE * TILE;
constexpr int BORDER_THREADS = 256;

__device__ __forceinline__ void flag_error(int32_t* err) { atomicExch(err, 1); }

__device__ __forceinline__ bool bit(unsigned bits, int i) { return (bits >> i) & 1u; }

// Tile-local column of the start of the run holding column `lane` of a tile
// row (`lane` must be foreground).
__device__ __forceinline__ int run_start(unsigned bits, int lane) {
  const unsigned starts = bits & ~(bits << 1);
  return 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
}

// Root of `x` in the tile's parent array, read while other threads hook.
// Path halving: each node passed is re-pointed at its grandparent, which is
// safe as only a root is ever hooked (by atomicCAS), so a node that is no
// root stays one and its ancestors stay its ancestors.
__device__ __forceinline__ int find_local(volatile int32_t* P, int x, int32_t* err) {
  for (int s = 0;; ++s) {
    const int px = P[x];
    if (px == x) return x;
    const int g = P[px];
    if (g == px) return px;
    if (s > TILE_PIXELS) { flag_error(err); return px; }
    P[x] = g;
    x = g;
  }
}

// Unite the trees of run starts a and b (b in the row above). A root is
// hooked under a smaller node of the other tree by atomicCAS, which only a
// root passes; b needs no find while a's root is larger than it, so in a
// tile full of foreground each row's run hooks under the row above without
// walking (the pointer jumping then resolves the chain).
__device__ void union_local(int32_t* P, int a, int b, int32_t* err) {
  volatile int32_t* V = P;
  a = find_local(V, a, err);
  for (int s = 0; a != b; ++s) {
    if (s > TILE_PIXELS) { flag_error(err); return; }
    if (a < b) {
      b = find_local(V, b, err);
      if (a == b) return;
      if (a < b) { const int t = a; a = b; b = t; }
    }
    const int old = atomicCAS(&P[a], a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void __launch_bounds__(TILE_THREADS)
cc_tile(const uint8_t* __restrict__ fg, int32_t* __restrict__ L, int H, int W,
        int32_t* err) {
  __shared__ unsigned rows[TILE];
  __shared__ int32_t P[TILE_PIXELS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * TILE, c0 = blockIdx.x * TILE, c = c0 + lane;
  const int64_t hw = (int64_t)H * W;
  const uint8_t* f = fg + blockIdx.z * hw;
  int32_t* Li = L + blockIdx.z * hw;

  // The tile's rows as bitmasks (all loads issued before the first
  // ballot); each pixel's parent is its run's start.
  uint8_t on[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = r0 + warp + 8 * k;
    on[k] = r < H && c < W ? f[r * W + c] : 0;
  }
  unsigned mine[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int lr = warp + 8 * k;
    mine[k] = __ballot_sync(0xffffffffu, on[k] != 0);
    if (lane == 0) rows[lr] = mine[k];
    if (on[k]) P[lr * TILE + lane] = lr * TILE + run_start(mine[k], lane);
  }
  __syncthreads();

  // Vertical contacts: the first column of each stretch of contacts between
  // two runs unites them (the next columns' contacts join the same runs).
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int lr = warp + 8 * k;
    if (lr == 0) continue;
    const unsigned up = rows[lr - 1];
    const unsigned contact = mine[k] & up;
    if (bit(contact & ~(contact << 1), lane))
      union_local(P, lr * TILE + run_start(mine[k], lane),
                  (lr - 1) * TILE + run_start(up, lane), err);
  }
  __syncthreads();

  // Pointer jumping over the run starts until each points at its root.
  for (int it = 0;; ++it) {
    bool changed = false;
#pragma unroll
    for (int k = 0; k < ROWS_PER_WARP; ++k) {
      const int lr = warp + 8 * k;
      if (bit(mine[k] & ~(mine[k] << 1), lane)) {
        const int x = lr * TILE + lane, px = P[x], g = P[px];
        if (g != px) { P[x] = g; changed = true; }
      }
    }
    if (!__syncthreads_or(changed)) break;
    if (it > TILE_PIXELS) { flag_error(err); break; }
  }

#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int lr = warp + 8 * k, r = r0 + lr;
    if (r >= H || c >= W) continue;
    int32_t v = -1;
    if (bit(mine[k], lane)) {
      const int x = P[lr * TILE + run_start(mine[k], lane)];
      const int32_t g = (r0 + x / TILE) * W + c0 + x % TILE;
      v = x == lr * TILE + lane ? g : -2 - g;
    }
    Li[r * W + c] = v;
  }
}

// Root of tile root `x` in one image's labels `L` during the border phase
// (`cur` is L[x] as the caller read it). Each node passed is re-pointed at
// its grandparent by a plain store. That is safe because only
// atomicCAS(L[r], r, .) changes a root: a stored node is no root and never
// becomes one, and trees only ever hang whole under other roots, so an
// ancestor stays an ancestor.
__device__ __forceinline__ int32_t find_compress(int32_t* L, int32_t x, int32_t cur,
                                                 int64_t bound, int32_t* err) {
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

// The tile root of pixel p, whose label is v: the root's index (p is a
// tile root) or -2 - it.
__device__ __forceinline__ int32_t tile_root(int32_t p, int32_t v) {
  return v >= 0 ? p : -2 - v;
}

// One thread a contact across a tile edge: first the pixels of the tile
// rows' top rows (below tile row 0), then those of the tile columns' left
// columns (right of tile column 0). As in the tile phase, a contact whose
// neighbours on the same side of the edge are in contact too is skipped
// (top rows: the contact to the left, inside one tile; left columns: the
// contact above, inside one tile), so each stretch of contacts unites once.
__global__ void __launch_bounds__(BORDER_THREADS)
cc_border(const uint8_t* __restrict__ fg, int32_t* L, int H, int W, int tiles_x,
          int tiles_y, int32_t* err) {
  const int64_t n_top = (int64_t)(tiles_y - 1) * W;
  const int64_t n = n_top + (int64_t)(tiles_x - 1) * H;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t hw = (int64_t)H * W;
  const uint8_t* f = fg + blockIdx.y * hw;
  int32_t* Li = L + blockIdx.y * hw;
  // p and q: the pixels either side of the edge; step: from them to their
  // neighbours on the same side, along the edge (none at a tile's start).
  int32_t p, q, step;
  if (i < n_top) {
    const int r = (int)(i / W + 1) * TILE, c = (int)(i % W);
    p = r * W + c;
    q = p - W;
    step = c % TILE != 0 ? 1 : 0;
  } else {
    const int64_t j = i - n_top;
    const int c = (int)(j / H + 1) * TILE, r = (int)(j % H);
    p = r * W + c;
    q = p - 1;
    step = r % TILE != 0 ? W : 0;
  }
  // The four loads are issued together (no short circuit between them).
  const uint8_t fp = f[p], fq = f[q];
  const uint8_t fp1 = step != 0 ? f[p - step] : 0, fq1 = step != 0 ? f[q - step] : 0;
  if (!(fp && fq) || (fp1 && fq1)) return;
  // a: the root of p's tree. b: q's tile root, a node of the other tree. A
  // root may hang under any smaller node of another tree, so when a > b no
  // find of b is needed: a chain of tiles, one under the next, is then
  // hooked without walking it (the flatten resolves such chains).
  const int32_t vp = Li[p], vq = Li[q];
  int32_t a = tile_root(p, vp);
  a = find_compress(Li, a, a == p ? vp : Li[a], hw, err);
  int32_t b = tile_root(q, vq);
  const int64_t bound = 2 * hw + 2;
  for (int64_t s = 0; a != b; ++s) {
    if (s > bound) { flag_error(err); return; }
    if (a < b) {
      // b's root must hang under a, or a under it.
      b = find_compress(Li, b, Li[b], hw, err);
      if (a == b) return;
      if (a < b) { const int32_t t = a; a = b; b = t; }
    }
    // Hook root a under b < a. If a is no root any more, the CAS returns
    // its parent (smaller than a), and the union carries on from there.
    const int32_t old = atomicCAS(&Li[a], a, b);
    if (old == a) return;
    a = old;
  }
}

// Tile roots first: pointer jumping, each tile root's thread setting its own
// label to its parent's current label until the parent is a root. Every
// value read is an ancestor, so a label only climbs, and as all tile roots
// jump at once a chain of D hooked tiles resolves in about log2(D) steps.
// Loads bypass L1 (__ldcg) to see the other blocks' jumps. Then every other
// pixel copies its tile root's label, written by a thread of this block.
__global__ void __launch_bounds__(TILE_THREADS)
cc_flatten(int32_t* L, int H, int W, int32_t* err) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.y * TILE, c = blockIdx.x * TILE + lane;
  const int64_t hw = (int64_t)H * W;
  int32_t* Li = L + blockIdx.z * hw;
  // Loads and stores are batched over the thread's four pixels (a store
  // to L could alias a later load, so the compiler would not reorder them).
  int32_t v[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int r = r0 + warp + 8 * k;
    v[k] = r < H && c < W ? __ldcg(&Li[r * W + c]) : -1;
  }
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k) {
    const int32_t p = (r0 + warp + 8 * k) * W + c;
    if (v[k] < 0 || v[k] == p) continue;  // background, or a root
    for (int64_t s = 0, q = v[k];; ++s) {
      const int32_t g = __ldcg(&Li[q]);
      if (g == q) break;  // q is the root, and Li[p] holds it
      if (s > hw) { flag_error(err); break; }
      Li[p] = g;
      q = g;
    }
  }
  __syncthreads();
  int32_t root[ROWS_PER_WARP];
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k)
    root[k] = v[k] <= -2 ? __ldcg(&Li[-2 - v[k]]) : 0;
#pragma unroll
  for (int k = 0; k < ROWS_PER_WARP; ++k)
    if (v[k] <= -2) Li[(r0 + warp + 8 * k) * W + c] = root[k];
}

__global__ void cc_empty() {}

struct Grids {
  dim3 tiles, border;
};

Grids grids(int B, int H, int W) {
  const int tiles_x = (W + TILE - 1) / TILE, tiles_y = (H + TILE - 1) / TILE;
  const int64_t n = (int64_t)(tiles_y - 1) * W + (int64_t)(tiles_x - 1) * H;
  const unsigned border_blocks = (unsigned)((n + BORDER_THREADS - 1) / BORDER_THREADS);
  return {dim3(tiles_x, tiles_y, B), dim3(border_blocks > 0 ? border_blocks : 1, B)};
}

}  // namespace

extern "C" int fpcnn_cc_label(const uint8_t* fg, int32_t* labels, int32_t* err,
                              int B, int H, int W, void* stream) {
  if ((int64_t)B * H * W == 0) return (int)cudaSuccess;
  const Grids g = grids(B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  cc_tile<<<g.tiles, TILE_THREADS, 0, s>>>(fg, labels, H, W, err);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_border<<<g.border, BORDER_THREADS, 0, s>>>(fg, labels, H, W, g.tiles.x,
                                                g.tiles.y, err);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cc_flatten<<<g.tiles, TILE_THREADS, 0, s>>>(labels, H, W, err);
  return (int)cudaGetLastError();
}

// The launches of one fpcnn_cc_label call, with the same grids and blocks,
// of a kernel that does nothing: the floor under the kernel's time.
extern "C" int fpcnn_cc_label_empty(int B, int H, int W, void* stream) {
  if ((int64_t)B * H * W == 0) return (int)cudaSuccess;
  const Grids g = grids(B, H, W);
  cudaStream_t s = (cudaStream_t)stream;
  cc_empty<<<g.tiles, TILE_THREADS, 0, s>>>();
  cc_empty<<<g.border, BORDER_THREADS, 0, s>>>();
  cc_empty<<<g.tiles, TILE_THREADS, 0, s>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* fpcnn_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
