// Shared pieces of the two fused-conv kernels (block_sparse_conv.cu and
// quant_conv.cu): the image band staged in shared memory, the patch offsets
// of a round of im2col rows, the accumulation over those rows and the pooled
// store.  Both kernels compute pool(act(conv(x, W) + b)) for an NHWC image
// that already carries its padding (VALID geometry); they differ only in how
// a round's weight rows are decoded and where the scale goes.
//
// Shared-memory layout of one CTA (floats unless noted):
//   img  [img_cap]          the CTA's band of input rows, f32 (H, W, C order)
//   acc  [acc_cap]          f32 accumulators, (conv row, conv col, column)
//   ws   [WCAP]             the round's decoded weight rows, (row, column)
//   koff [WCAP / bns] ints  each round row's patch offset inside `img`
#pragma once

#include "common.cuh"

namespace rt {

constexpr int CONV_NT = 256;    // threads per CTA
constexpr int CONV_WCAP = 2048; // floats of decoded weight rows per round

// Static geometry of one launch.  `band` conv output rows per CTA (a
// multiple of the pool window z, the last band may be shorter); `bns`
// output columns per CTA.
struct ConvGeom {
  int H, W, C;      // padded input
  int kh, kw;       // kernel taps
  int sh, sw;       // strides
  int dh, dw;       // dilation
  int Ho, Wo;       // conv output
  int z;            // pool window (1 = no pool)
  int pool_max;     // 1: max pool, 0: average (sum, then / z^2)
  int band;         // conv output rows per CTA
  int bns;          // output columns per CTA
};

__host__ __device__ inline int conv_in_rows(const ConvGeom& g, int nr) {
  return (nr - 1) * g.sh + (g.kh - 1) * g.dh + 1;
}

// Bytes of dynamic shared memory a launch of geometry g needs.
__host__ inline size_t conv_smem_bytes(const ConvGeom& g) {
  const size_t img = (size_t)conv_in_rows(g, g.band) * g.W * g.C;
  const size_t acc = (size_t)g.band * g.Wo * g.bns;
  return (img + acc + CONV_WCAP) * sizeof(float) +
         (size_t)(CONV_WCAP / g.bns) * sizeof(int);
}

struct ConvSmem {
  float* img;
  float* acc;
  float* ws;
  int* koff;
  int kcap;  // weight rows per round
};

__device__ inline ConvSmem conv_smem(float* base, const ConvGeom& g) {
  ConvSmem s;
  s.img = base;
  s.acc = s.img + (size_t)conv_in_rows(g, g.band) * g.W * g.C;
  s.ws = s.acc + (size_t)g.band * g.Wo * g.bns;
  s.koff = reinterpret_cast<int*>(s.ws + CONV_WCAP);
  s.kcap = CONV_WCAP / g.bns;
  return s;
}

// Stage rows [r0 * sh, r0 * sh + in_rows) of image b (contiguous in NHWC)
// as f32 and zero the accumulators of the band's nr conv rows.
template <typename XT>
__device__ inline void conv_stage_image(const XT* __restrict__ x, int b,
                                        int r0, int nr, const ConvGeom& g,
                                        const ConvSmem& s) {
  const int n = conv_in_rows(g, nr) * g.W * g.C;
  const XT* src = x + ((size_t)b * g.H + (size_t)r0 * g.sh) * g.W * g.C;
  for (int e = threadIdx.x; e < n; e += CONV_NT) s.img[e] = to_f32(src[e]);
  const int na = nr * g.Wo * g.bns;
  for (int e = threadIdx.x; e < na; e += CONV_NT) s.acc[e] = 0.f;
}

// Patch offset of im2col feature k, in the channel-major order of the
// reference (k = c * kh * kw + ih * kw + iw), relative to the top-left
// input element of an output position's receptive field.
__device__ inline int conv_koff(int k, const ConvGeom& g) {
  const int taps = g.kh * g.kw;
  const int c = k / taps;
  const int rem = k - c * taps;
  const int ih = rem / g.kw;
  const int iw = rem - ih * g.kw;
  return (ih * g.dh * g.W + iw * g.dw) * g.C + c;
}

// acc[p, j] += sum over the round's rows of img[patch(p) + koff[row]] *
// ws[row, j], rows in order, for the band's nr conv rows and nj columns.
__device__ inline void conv_accumulate(int nr, int nj, int nrows,
                                       const ConvGeom& g, const ConvSmem& s) {
  const int n = nr * g.Wo * nj;
  for (int e = threadIdx.x; e < n; e += CONV_NT) {
    const int p = e / nj, j = e - p * nj;
    const int orow = p / g.Wo, ocol = p - orow * g.Wo;
    const float* im = s.img + (orow * g.sh * g.W + ocol * g.sw) * g.C;
    const float* w = s.ws + j;
    float a = s.acc[p * g.bns + j];
    for (int row = 0; row < nrows; ++row)
      a = fmaf(im[s.koff[row]], w[row * g.bns], a);
    s.acc[p * g.bns + j] = a;
  }
}

// Pool the band's activated accumulators over non-overlapping z x z
// windows (z = 1: a copy) and store (B, Ho / z, Wo / z, N) at column n0.
template <typename XT>
__device__ inline void conv_pool_store(XT* __restrict__ out, int b, int r0,
                                       int nr, int nj, int n0, int N,
                                       const ConvGeom& g, const ConvSmem& s) {
  const int z = g.z;
  const int Hp = g.Ho / z, Wp = g.Wo / z;
  const int n = (nr / z) * Wp * nj;
  for (int e = threadIdx.x; e < n; e += CONV_NT) {
    const int q = e / nj, j = e - q * nj;
    const int qr = q / Wp, qc = q - qr * Wp;
    float v = g.pool_max ? -__int_as_float(0x7f800000) : 0.f;  // -inf
    for (int a = 0; a < z; ++a)
      for (int c = 0; c < z; ++c) {
        const float u = s.acc[((qr * z + a) * g.Wo + qc * z + c) * g.bns + j];
        v = g.pool_max ? fmaxf(v, u) : v + u;
      }
    if (!g.pool_max) v = v / (float)(z * z);
    const size_t row = (size_t)b * Hp + r0 / z + qr;
    out[(row * Wp + qc) * N + n0 + j] = from_f32<XT>(v);
  }
}

}  // namespace rt
