// Host operators of fastposecnn_tpu_torch's training data path: the
// augmentation operators and the PNG row unfilter.
//
// A copy of the augmentation section of the JAX package's
// native/fpcnn_native.cpp (its fpcnn_aug_* functions and their helpers),
// without its PNG and connected-component functions, so the library needs
// neither libpng nor zlib. Each operator mirrors the float32 evaluation
// order of its numpy reference in fastposecnn_tpu_torch/data/augment.py
// (formula, operation grouping, rounding mode), so the two paths are
// bit-equal; that holds only without fused multiply-adds
// (-ffp-contract=off) and without -ffast-math. Built with g++ by
// fastposecnn_tpu_torch/native/augment_lib.py and loaded with ctypes.
// Images are contiguous float32 [h, w, 3] RGB in [0, 1] unless noted.
// fpcnn_png_unfilter, at the end, is the sequential step of PNG decoding
// (fastposecnn_tpu_torch/data/png.py, whose numpy unfilter is its plain
// version); zlib stays in Python.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

namespace {

inline float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// numpy's float32 `% 1.0` (result in [0, 1), sign of the divisor) for
// |x| < 2, which holds at every call site. The branches are bit-equal to
// fmodf (x-1 is Sterbenz-exact for x in [1,2); fmodf(x,1)==x for |x|<1,
// and the +1 adjustment is the same addition numpy's remainder performs)
// while costing ~30 fewer cycles per pixel.
inline float mod1(float x) {
  if (x >= 1.0f) x -= 1.0f;
  if (x < 0.0f) x += 1.0f;
  return x;
}

// augment._rgb_to_hsv: single-division piecewise hue. Inputs pre-clipped.
inline void rgb2hsv_px(float r, float g, float b, float* hh, float* ss,
                       float* vv) {
  float maxc = std::max(std::max(r, g), b);
  float minc = std::min(std::min(r, g), b);
  float delta = maxc - minc;
  *ss = maxc > 0.0f ? delta / std::max(maxc, 1e-8f) : 0.0f;
  float dd = std::max(delta, 1e-8f);
  float h;
  if (r == maxc)
    h = (g - b) / dd;
  else if (g == maxc)
    h = (b - r) / dd + 2.0f;
  else
    h = (r - g) / dd + 4.0f;
  h = mod1(h / 6.0f);
  *hh = delta == 0.0f ? 0.0f : h;
  *vv = maxc;
}

// augment._hsv_to_rgb's branch-free channel: v - v*s*clip(min(k, 4-k), 0, 1)
// with k = (n + 6h) mod 6.
inline float hsv_chan(float n, float h, float v, float vs) {
  float k = n + h * 6.0f;            // in [1, 12) for n in {1,3,5}, h in [0,1)
  if (k >= 6.0f) k -= 6.0f;          // exact, == fmodf(k, 6)
  float t = std::min(k, 4.0f - k);
  t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
  return v - vs * t;
}

}  // namespace

// augment.hsv_jitter fused: clip -> rgb2hsv -> (h+dh)%1, clip(s+ds),
// clip(v+dv) -> hsv2rgb. In place.
void fpcnn_aug_hsv_jitter(float* img, int h, int w, float dh, float ds,
                          float dv) {
  size_t n = (size_t)h * w;
  for (size_t i = 0; i < n; ++i) {
    float* p = img + 3 * i;
    float hh, ss, vv;
    rgb2hsv_px(clamp01(p[0]), clamp01(p[1]), clamp01(p[2]), &hh, &ss, &vv);
    hh = mod1(hh + dh);
    ss = clamp01(ss + ds);
    vv = clamp01(vv + dv);
    float vs = vv * ss;
    p[0] = hsv_chan(5.0f, hh, vv, vs);
    p[1] = hsv_chan(3.0f, hh, vv, vs);
    p[2] = hsv_chan(1.0f, hh, vv, vs);
  }
}

// augment.clahe fused: CLAHE on the HSV value channel (per-tile clipped
// 256-bin histogram CDFs, bilinearly interpolated between tile centers),
// h/s untouched. In place.
void fpcnn_aug_clahe(float* img, int h, int w, int tiles, float clip_limit) {
  const int t = tiles;
  const size_t n = (size_t)h * w;
  std::vector<float> harr(n), sarr(n);
  std::vector<uint8_t> vq(n);

  // Tile edges: np.linspace(0, dim, t+1).astype(int) — start + i*delta
  // with the endpoint pinned, truncated toward zero.
  std::vector<int> ys(t + 1), xs(t + 1);
  double dy = (double)h / t, dx = (double)w / t;
  for (int i = 0; i <= t; ++i) {
    ys[i] = (int)(i * dy);
    xs[i] = (int)(i * dx);
  }
  ys[t] = h;
  xs[t] = w;

  std::vector<int> row_tile(h), col_tile(w);
  for (int ti = 0; ti < t; ++ti)
    for (int y = ys[ti]; y < ys[ti + 1]; ++y) row_tile[y] = ti;
  for (int tj = 0; tj < t; ++tj)
    for (int x = xs[tj]; x < xs[tj + 1]; ++x) col_tile[x] = tj;

  // Pass 1a (vectorizable — no scatter in the body): hsv + quantized
  // value. Kept separate from the histogram accumulation below, whose
  // data-dependent increment would block vectorization of the hsv math.
  for (size_t i = 0; i < n; ++i) {
    const float* p = img + 3 * i;
    float hh, ss, vv;
    rgb2hsv_px(clamp01(p[0]), clamp01(p[1]), clamp01(p[2]), &hh, &ss, &vv);
    harr[i] = hh;
    sarr[i] = ss;
    int q = (int)(vv * 255.0f);  // truncation, matches astype(int32)
    vq[i] = (uint8_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
  }
  // Pass 1b (scalar): per-tile histograms.
  std::vector<double> hist((size_t)t * t * 256, 0.0);
  for (int y = 0; y < h; ++y) {
    double* hrow = hist.data() + (size_t)row_tile[y] * t * 256;
    const uint8_t* vrow = vq.data() + (size_t)y * w;
    for (int x = 0; x < w; ++x)
      hrow[(size_t)col_tile[x] * 256 + vrow[x]] += 1.0;
  }

  // Pass 2: clip + redistribute + CDF -> per-tile LUTs (float32).
  std::vector<float> luts((size_t)t * t * 256);
  for (int ti = 0; ti < t; ++ti) {
    for (int tj = 0; tj < t; ++tj) {
      double* hg = hist.data() + ((size_t)ti * t + tj) * 256;
      double tsize = (double)(ys[ti + 1] - ys[ti]) * (xs[tj + 1] - xs[tj]);
      double clip = std::max((double)clip_limit * std::max(tsize, 1.0) / 256.0,
                             1.0);
      double excess = 0.0;
      for (int b = 0; b < 256; ++b) excess += std::max(hg[b] - clip, 0.0);
      double cum = 0.0, add = excess / 256.0;
      float* lut = luts.data() + ((size_t)ti * t + tj) * 256;
      double total = 0.0;
      for (int b = 0; b < 256; ++b) total += std::min(hg[b], clip) + add;
      double denom = std::max(total, 1.0);
      for (int b = 0; b < 256; ++b) {
        cum += std::min(hg[b], clip) + add;
        lut[b] = (float)(cum / denom);
      }
    }
  }

  // Pixel -> fractional tile coordinates: np.interp over tile centers
  // (linear between, clamped outside), float64 like numpy.
  auto frac_coord = [t](int dim, const std::vector<int>& edges, int pos) {
    // centers c[k] = (edges[k] + edges[k+1]) / 2
    double p = (double)pos;
    double c0 = (edges[0] + edges[1]) / 2.0;
    double cl = (edges[t - 1] + edges[t]) / 2.0;
    if (p <= c0) return 0.0;
    if (p >= cl) return (double)(t - 1);
    int k = 0;
    while (k + 1 < t && (edges[k + 1] + edges[k + 2]) / 2.0 < p) ++k;
    double ck = (edges[k] + edges[k + 1]) / 2.0;
    double ck1 = (edges[k + 1] + edges[k + 2]) / 2.0;
    double slope = 1.0 / (ck1 - ck);
    return slope * (p - ck) + (double)k;
  };
  std::vector<int> i0(h), i1(h), j0(w), j1(w);
  std::vector<float> wi(h), wj(w);
  for (int y = 0; y < h; ++y) {
    double f = frac_coord(h, ys, y);
    i0[y] = (int)std::floor(f);
    i1[y] = std::min(i0[y] + 1, t - 1);
    wi[y] = (float)(f - i0[y]);
  }
  for (int x = 0; x < w; ++x) {
    double f = frac_coord(w, xs, x);
    j0[x] = (int)std::floor(f);
    j1[x] = std::min(j0[x] + 1, t - 1);
    wj[x] = (float)(f - j0[x]);
  }

  // Pass 3: bilinear LUT blend (float32, numpy grouping) + hsv2rgb.
  for (int y = 0; y < h; ++y) {
    const float* l00r = luts.data() + ((size_t)i0[y] * t) * 256;
    const float* l10r = luts.data() + ((size_t)i1[y] * t) * 256;
    float wiy = wi[y];
    for (int x = 0; x < w; ++x) {
      size_t i = (size_t)y * w + x;
      int q = vq[i];
      float v00 = l00r[(size_t)j0[x] * 256 + q];
      float v01 = l00r[(size_t)j1[x] * 256 + q];
      float v10 = l10r[(size_t)j0[x] * 256 + q];
      float v11 = l10r[(size_t)j1[x] * 256 + q];
      float wjx = wj[x];
      float veq = v00 * (1.0f - wiy) * (1.0f - wjx) +
                  v01 * (1.0f - wiy) * wjx + v10 * wiy * (1.0f - wjx) +
                  v11 * wiy * wjx;
      float vs = veq * sarr[i];
      float* p = img + 3 * i;
      p[0] = hsv_chan(5.0f, harr[i], veq, vs);
      p[1] = hsv_chan(3.0f, harr[i], veq, vs);
      p[2] = hsv_chan(1.0f, harr[i], veq, vs);
    }
  }
}

// augment.warp_image order=1: inverse-map bilinear warp with the
// out-of-bounds weight folded into the tap weight (fill 0). Coordinates
// use the float32 broadcast formula of augment._warp_coords. src/dst
// [h, w, c] float32, Hinv row-major 3x3 float64.
void fpcnn_aug_warp_bilinear(const float* src, float* dst, int h, int w,
                             int c, const double* Hinv) {
  float H00 = (float)Hinv[0], H01 = (float)Hinv[1], H02 = (float)Hinv[2];
  float H10 = (float)Hinv[3], H11 = (float)Hinv[4], H12 = (float)Hinv[5];
  float H20 = (float)Hinv[6], H21 = (float)Hinv[7], H22 = (float)Hinv[8];
  for (int y = 0; y < h; ++y) {
    float ax = H01 * (float)y + H02;
    float ay = H11 * (float)y + H12;
    float ad = H21 * (float)y + H22;
    float* drow = dst + (size_t)y * w * c;
    for (int x = 0; x < w; ++x) {
      float den = H20 * (float)x + ad;
      float sx = (H00 * (float)x + ax) / den;
      float sy = (H10 * (float)x + ay) / den;
      long long x0 = (long long)std::floor(sx);
      long long y0 = (long long)std::floor(sy);
      float fx = (float)((double)sx - (double)x0);
      float fy = (float)((double)sy - (double)y0);
      float w00 = (1.0f - fx) * (1.0f - fy);
      float w01 = fx * (1.0f - fy);
      float w10 = (1.0f - fx) * fy;
      float w11 = fx * fy;
      long long yc0 = std::min(std::max(y0, 0LL), (long long)h - 1);
      long long yc1 = std::min(std::max(y0 + 1, 0LL), (long long)h - 1);
      long long xc0 = std::min(std::max(x0, 0LL), (long long)w - 1);
      long long xc1 = std::min(std::max(x0 + 1, 0LL), (long long)w - 1);
      bool iny0 = y0 >= 0 && y0 < h, iny1 = y0 + 1 >= 0 && y0 + 1 < h;
      bool inx0 = x0 >= 0 && x0 < w, inx1 = x0 + 1 >= 0 && x0 + 1 < w;
      float g00 = (iny0 && inx0) ? w00 : 0.0f;
      float g01 = (iny0 && inx1) ? w01 : 0.0f;
      float g10 = (iny1 && inx0) ? w10 : 0.0f;
      float g11 = (iny1 && inx1) ? w11 : 0.0f;
      const float* s00 = src + (yc0 * w + xc0) * c;
      const float* s01 = src + (yc0 * w + xc1) * c;
      const float* s10 = src + (yc1 * w + xc0) * c;
      const float* s11 = src + (yc1 * w + xc1) * c;
      float* d = drow + (size_t)x * c;
      for (int ch = 0; ch < c; ++ch)
        d[ch] = s00[ch] * g00 + s01[ch] * g01 + s10[ch] * g10 +
                s11[ch] * g11;
    }
  }
}

// augment.warp_image order=0: nearest warp (np.round half-even), zero
// fill, element-size generic (uint8 masks, float32 depth/instance masks).
void fpcnn_aug_warp_nearest(const uint8_t* src, uint8_t* dst, int h, int w,
                            int c, int elem_size, const double* Hinv) {
  float H00 = (float)Hinv[0], H01 = (float)Hinv[1], H02 = (float)Hinv[2];
  float H10 = (float)Hinv[3], H11 = (float)Hinv[4], H12 = (float)Hinv[5];
  float H20 = (float)Hinv[6], H21 = (float)Hinv[7], H22 = (float)Hinv[8];
  size_t px = (size_t)c * elem_size;
  std::memset(dst, 0, (size_t)h * w * px);
  for (int y = 0; y < h; ++y) {
    float ax = H01 * (float)y + H02;
    float ay = H11 * (float)y + H12;
    float ad = H21 * (float)y + H22;
    uint8_t* drow = dst + (size_t)y * w * px;
    for (int x = 0; x < w; ++x) {
      float den = H20 * (float)x + ad;
      float sx = (H00 * (float)x + ax) / den;
      float sy = (H10 * (float)x + ay) / den;
      // np.round rounds half to even; nearbyintf under the default
      // FE_TONEAREST mode does the same.
      long long xi = (long long)std::nearbyintf(sx);
      long long yi = (long long)std::nearbyintf(sy);
      if (xi >= 0 && xi < w && yi >= 0 && yi < h)
        std::memcpy(drow + (size_t)x * px, src + ((size_t)yi * w + xi) * px,
                    px);
    }
  }
}

// 3x3 convolution with edge ("replicate") padding; out = scale * sum of
// kern-weighted taps in row-major tap order (zero-weight taps skipped, so
// box blur [kern=1, scale=1/9] and motion blur [kern=weights, scale=1]
// reproduce the numpy accumulation bit-for-bit).
void fpcnn_aug_conv3x3(const float* src, float* dst, int h, int w, int c,
                       const float* kern, float scale) {
  const int rowlen = w * c;
  const float k0 = kern[0], k1 = kern[1], k2 = kern[2];
  const float k3 = kern[3], k4 = kern[4], k5 = kern[5];
  const float k6 = kern[6], k7 = kern[7], k8 = kern[8];
  for (int y = 0; y < h; ++y) {
    const float* rm = src + (size_t)(y > 0 ? y - 1 : 0) * rowlen;
    const float* r0 = src + (size_t)y * rowlen;
    const float* rp = src + (size_t)(y < h - 1 ? y + 1 : h - 1) * rowlen;
    float* d = dst + (size_t)y * rowlen;
    // Interior columns: horizontal taps are fixed offsets {-c, 0, +c} in
    // the interleaved row — one channel-agnostic, vectorizable loop.
    // Tap order is row-major like the numpy slice adds (bit-equal sums;
    // zero-weight taps contribute an exact +0.0).
    for (int i = c; i < rowlen - c; ++i) {
      float acc = k0 * rm[i - c] + k1 * rm[i] + k2 * rm[i + c] +
                  k3 * r0[i - c] + k4 * r0[i] + k5 * r0[i + c] +
                  k6 * rp[i - c] + k7 * rp[i] + k8 * rp[i + c];
      d[i] = acc * scale;
    }
    // Edge columns x = 0 and x = w-1 (replicate padding clamps x +- 1).
    for (int e = 0; e < 2; ++e) {
      int x = e ? w - 1 : 0;
      int xm = x > 0 ? x - 1 : 0, xp = x < w - 1 ? x + 1 : w - 1;
      for (int ch = 0; ch < c; ++ch) {
        float acc = k0 * rm[xm * c + ch] + k1 * rm[x * c + ch] +
                    k2 * rm[xp * c + ch] + k3 * r0[xm * c + ch] +
                    k4 * r0[x * c + ch] + k5 * r0[xp * c + ch] +
                    k6 * rp[xm * c + ch] + k7 * rp[x * c + ch] +
                    k8 * rp[xp * c + ch];
        d[x * c + ch] = acc * scale;
      }
    }
  }
}

// augment.sharpen fused: out = img*(1-alpha) + clip(img + img*lightness -
// box_blur(img), 0, 1)*alpha, box blur = (sum of 9 replicate-padded taps)
// / 9 exactly as the numpy path computes it.
void fpcnn_aug_sharpen(const float* src, float* dst, int h, int w, int c,
                       double alpha, double lightness) {
  const int rowlen = w * c;
  const float af = (float)alpha;
  // numpy evaluates (1 - alpha) in float64 BEFORE the float32 multiply;
  // 1.0f - af can land one ulp away.
  const float oma = (float)(1.0 - alpha);
  const float lf = (float)lightness;
  for (int y = 0; y < h; ++y) {
    const float* rm = src + (size_t)(y > 0 ? y - 1 : 0) * rowlen;
    const float* r0 = src + (size_t)y * rowlen;
    const float* rp = src + (size_t)(y < h - 1 ? y + 1 : h - 1) * rowlen;
    float* d = dst + (size_t)y * rowlen;
    auto emit = [&](int i, int im, int ip) {
      float b = ((rm[im] + rm[i] + rm[ip] + r0[im] + r0[i] + r0[ip] +
                  rp[im] + rp[i] + rp[ip])) /
                9.0f;
      float x = r0[i];
      float sharpened = x + (x * lf - b);
      sharpened = sharpened < 0.0f ? 0.0f
                                   : (sharpened > 1.0f ? 1.0f : sharpened);
      d[i] = x * oma + sharpened * af;
    };
    for (int i = c; i < rowlen - c; ++i) emit(i, i - c, i + c);
    for (int ch = 0; ch < c; ++ch) {
      emit(ch, ch, w > 1 ? c + ch : ch);
      int last = (w - 1) * c + ch;
      emit(last, w > 1 ? last - c : last, last);
    }
  }
}

// PNG row unfilter (PNG spec, section 9): `src` holds `h` rows of one
// filter byte and `row_bytes` bytes, as zlib inflated them; `dst` receives
// the h * row_bytes reconstructed bytes. bpp: the bytes of one pixel (>= 1).
// Returns 0, or 1 + the index of the first row whose filter byte is not 0-4.
int fpcnn_png_unfilter(const uint8_t* src, uint8_t* dst, int h, int row_bytes,
                       int bpp) {
  for (int r = 0; r < h; ++r) {
    const uint8_t* in = src + (size_t)r * (row_bytes + 1) + 1;
    uint8_t* out = dst + (size_t)r * row_bytes;
    const uint8_t* up = r > 0 ? out - row_bytes : nullptr;
    switch (in[-1]) {
      case 0:
        std::memcpy(out, in, row_bytes);
        break;
      case 1:  // Sub
        for (int i = 0; i < row_bytes; ++i)
          out[i] = (uint8_t)(in[i] + (i >= bpp ? out[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < row_bytes; ++i)
          out[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          out[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < row_bytes; ++i) {
          int a = i >= bpp ? out[i - bpp] : 0, b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          out[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return r + 1;
    }
  }
  return 0;
}

}  // extern "C"
