// The register-tiled body of the two fused-conv kernels (block_sparse_conv.cu
// and quant_conv.cu, route "reg_tile"): images staged once per CTA, the
// CTA's walk of decoded weight rows and patch offsets in shared memory,
// accumulators, the K-part reduce, epilogue and pool in registers.
//
// Work split (kernels/sparse_matmul/kernel.py ConvPlan, the rule that makes
// it): a thread owns one unit of one image — a 2 x 2 pooled window (z = 2)
// or REG_STRIP consecutive conv positions of a row (z = 1) — times CT output
// columns, over one of `ks` parts of the K walk.  Per walk step it loads the
// step's patch offset (a broadcast), REG_POS patch values (one per
// position, used by every column) and the step's CT weights (one 16- or
// 8-byte broadcast, used by every position), and issues REG_POS * CT
// independent FMAs.  Part 0 adds the other parts' accumulators in part order, then
// applies scale (quant), bias, activation and pool in registers and stores
// each output once.
//
// Shared-memory layout of one CTA (floats unless noted):
//   img  [round4(img * stride)]         the CTA's images, f32, channel-major
//                                       (C, H, W), `stride` apart
//   ws   [steps * CT]                    the walk's weight rows
//   ep   [2 * CT]                        the tile's emit scales, then biases
//   red  [(ks - 1) * REG_POS * CT * part] parts 1.. accumulators
//   koff [steps] ints                    each step's patch offset
#pragma once

#include <type_traits>

#include "conv_common.cuh"

namespace rt {

constexpr int REG_NT = 512;    // threads per CTA, at most
constexpr int REG_POS = 4;     // conv positions per thread
constexpr int REG_STRIP = 4;   // unpooled positions per unit, along a row

// The plan of one launch, in the order of ConvPlan.ints().
struct RegPlan {
  int ct;     // columns per thread (checked against the template value)
  int n_ct;   // column tiles (grid.y)
  int upr;    // units per row of units
  int units;  // units per image
  int img;    // images per CTA
  int part;   // threads per K part, a multiple of 32
  int ks;     // K parts
  int per;    // walk units per part (quant: k rows; block-sparse: blocks)
  int steps;  // walk steps a CTA stages, at most
};

// Floats from one staged image to the next: H*W*C, made odd when a CTA
// holds several, so that two images' patch reads fall on opposite halves of
// the banks.  Staged channel-major, the units of a warp read distinct
// banks where the pooled windows tile a row (conv2 of LeNet: 16 windows on
// the even banks, the next image's on the odd ones); in NHWC their offsets
// are multiples of C and rows 2 apart collide.
__host__ __device__ inline int reg_img_stride(const ConvGeom& g,
                                              const RegPlan& p) {
  const int hwc = g.H * g.W * g.C;
  return (p.img > 1 && hwc % 2 == 0) ? hwc + 1 : hwc;
}

__host__ __device__ inline size_t reg_img_floats(const ConvGeom& g,
                                                 const RegPlan& p) {
  return ((size_t)p.img * reg_img_stride(g, p) + 3) / 4 * 4;
}

// Bytes of dynamic shared memory (kernel.py _reg_smem).
__host__ inline size_t reg_smem_bytes(const ConvGeom& g, const RegPlan& p) {
  return (reg_img_floats(g, p) + (size_t)p.steps * p.ct + 2 * p.ct +
          (size_t)(p.ks - 1) * REG_POS * p.ct * p.part + p.steps) *
         sizeof(float);
}

struct RegSmem {
  float* img;
  float* ws;
  float* ep;
  float* red;
  int* koff;
};

__device__ inline RegSmem reg_smem(float* base, const ConvGeom& g,
                                   const RegPlan& p) {
  RegSmem s;
  s.img = base;
  s.ws = s.img + reg_img_floats(g, p);
  s.ep = s.ws + (size_t)p.steps * p.ct;
  s.red = s.ep + 2 * p.ct;
  s.koff = reinterpret_cast<int*>(s.red + (size_t)(p.ks - 1) * REG_POS *
                                              p.ct * p.part);
  return s;
}

__device__ __forceinline__ void reg_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void reg_cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}

__device__ __forceinline__ void reg_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start staging images b0 .. b0 + nimg - 1 of the NHWC x as f32 in s.img,
// channel-major, `stride` floats apart.  With one channel and no pad the
// layouts agree and the images are copied as they lie: 16-byte cp.async
// copies for f32 (bf16: 16-byte loads, converted) where the source is
// 16-byte aligned, the elements past the aligned part one by one.
// Otherwise f32 goes by 4-byte cp.async copies, each to its channel's plane
// (a thread takes whole pixels, so the index math runs once a pixel), and
// bf16 by 16-byte loads where the source and an image's length allow, else
// element by element.  reg_finish_images waits.
template <typename XT>
__device__ inline void reg_stage_images(const XT* __restrict__ x, int b0,
                                        int nimg, const ConvGeom& g,
                                        const RegPlan& pl, const RegSmem& s) {
  const int hw = g.H * g.W, hwc = hw * g.C;
  const int n = nimg * hwc;
  const int stride = reg_img_stride(g, pl);
  const XT* src = x + (size_t)b0 * hwc;
  float* dst = s.img;
  const bool al = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (g.C != 1 || stride != hwc) {
    if constexpr (std::is_same<XT, float>::value) {
      for (int t = threadIdx.x; t < nimg * hw; t += blockDim.x) {
        const int i = t / hw;  // pixel t of the CTA is pixel t - i * hw
        const float* sp = src + (size_t)t * g.C;
        float* dp = dst + i * stride + (t - i * hw);
        for (int c = 0; c < g.C; ++c) reg_cp_async4(dp + c * hw, sp + c);
      }
      return;
    }
    // each 16-byte load's elements go to their channels' planes: one divide
    // per load finds its image, pixel and channel, the rest count on
    constexpr int VE = 16 / sizeof(XT);  // elements per 16-byte load
    const int nq = al && hwc % VE == 0 ? hwc / VE : 0;  // loads per image
    for (int q = threadIdx.x; q < nimg * nq; q += blockDim.x) {
      const int i = q / nq, e = (q - i * nq) * VE;
      const uint4 raw =
          __ldg(reinterpret_cast<const uint4*>(src + (size_t)i * hwc) +
                (q - i * nq));
      const XT* v = reinterpret_cast<const XT*>(&raw);
      float* di = dst + i * stride;
      int px = e / g.C, c = e - px * g.C;
#pragma unroll
      for (int t = 0; t < VE; ++t) {
        di[c * hw + px] = to_f32(v[t]);
        if (++c == g.C) {
          c = 0;
          ++px;
        }
      }
    }
    if (nq == 0) {
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int i = e / hwc, r = e - i * hwc;
        const int px = r / g.C;
        dst[i * stride + (r - px * g.C) * hw + px] = to_f32(src[e]);
      }
    }
    return;
  }
  int done = 0;
  if constexpr (std::is_same<XT, float>::value) {
    if (al) {
      const int nv = n / 4;
      for (int i = threadIdx.x; i < nv; i += blockDim.x)
        reg_cp_async16(dst + 4 * i, src + 4 * i);
      done = 4 * nv;
    }
  } else {
    if (al) {
      const int nv = n / 8;
      const uint4* s8 = reinterpret_cast<const uint4*>(src);
      for (int i = threadIdx.x; i < nv; i += blockDim.x) {
        const uint4 raw = __ldg(s8 + i);
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
        float4* o = reinterpret_cast<float4*>(dst + 8 * i);
        o[0] = make_float4(a.x, a.y, b.x, b.y);
        o[1] = make_float4(c.x, c.y, d.x, d.y);
      }
      done = 8 * nv;
    }
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = to_f32(src[i]);
}

// Wait for the staged copies and sync: the images, weight rows, patch
// offsets and emit vectors are in place.
__device__ inline void reg_finish_images() {
  reg_cp_async_wait_all();
  __syncthreads();
}

// G consecutive container elements from p: one load of G * sizeof(T) bytes
// when `vec` (p aligned to that), else one by one.
template <typename T, int G>
__device__ __forceinline__ void reg_load_group(const T* __restrict__ p,
                                               bool vec, T (&v)[G]) {
  struct alignas(G * sizeof(T)) Pack {
    T e[G];
  };
  if (vec) {
    const Pack pk = *reinterpret_cast<const Pack*>(p);
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = pk.e[g];
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) v[g] = p[g];
  }
}

// Store G decoded weights of one walk step at p (16 bytes when G is 4).
template <int G>
__device__ __forceinline__ void reg_store_group(float* p, const float (&w)[G]) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) p[g] = w[g];
  }
}

// The emit scale (1 without) and bias (0 without) of column n0 + tid, for
// the first CT threads (past N: column N - 1's, never stored): loaded at the
// start of a kernel, stored to s.ep by reg_store_epilogue at the end of its
// staging, so that the loads overlap the rest.
template <int CT>
__device__ inline float2 reg_load_epilogue(const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           int n0, int N) {
  float2 e = make_float2(1.f, 0.f);
  if (threadIdx.x < CT) {
    const int n = min(n0 + (int)threadIdx.x, N - 1);
    if (scale != nullptr) e.x = scale[n];
    if (bias != nullptr) e.y = bias[n];
  }
  return e;
}

template <int CT>
__device__ inline void reg_store_epilogue(const RegSmem& s, float2 e) {
  if (threadIdx.x < CT) {
    s.ep[threadIdx.x] = e.x;
    s.ep[CT + threadIdx.x] = e.y;
  }
}

// Patch offset of im2col feature k, in the channel-major order of the
// reference (k = c * kh * kw + ih * kw + iw), in a channel-major staged
// image, relative to an output position's top-left input element.
__device__ inline int reg_koff(int k, const ConvGeom& g) {
  const int taps = g.kh * g.kw;
  const int c = k / taps;
  const int rem = k - c * taps;
  const int ih = rem / g.kw;
  const int iw = rem - ih * g.kw;
  return c * g.H * g.W + ih * g.dh * g.W + iw * g.dw;
}

// One walk step's CT weights from shared memory: 16-byte loads (8-byte for
// CT = 2), the same address across the warp.
template <int CT>
__device__ __forceinline__ void reg_load_row(const float* __restrict__ p,
                                             float (&w)[CT]) {
  if constexpr (CT % 4 == 0) {
#pragma unroll
    for (int j = 0; j < CT; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + j);
      w[j] = v.x;
      w[j + 1] = v.y;
      w[j + 2] = v.z;
      w[j + 3] = v.w;
    }
  } else {
    static_assert(CT == 2, "column tiles are 2 or 4");
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  }
}

// Store CT outputs of one position at dst (row-contiguous columns): vector
// stores of VW = 4 (CT % 4 == 0) or 2 elements when `vec`, else one by one
// for the first `nvalid`.
template <typename XT, int CT>
__device__ __forceinline__ void reg_store(XT* __restrict__ dst,
                                          const float (&v)[CT], int nvalid,
                                          bool vec) {
  constexpr int VW = CT % 4 == 0 ? 4 : 2;
  if (vec) {
#pragma unroll
    for (int j = 0; j < CT; j += VW) {
      if constexpr (std::is_same<XT, float>::value) {
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        else
          *reinterpret_cast<float2*>(dst + j) = make_float2(v[j], v[j + 1]);
      } else {
        const __nv_bfloat162 a = __floats2bfloat162_rn(v[j], v[j + 1]);
        if constexpr (VW == 4) {
          const __nv_bfloat162 b = __floats2bfloat162_rn(v[j + 2], v[j + 3]);
          uint2 u;
          u.x = *reinterpret_cast<const uint32_t*>(&a);
          u.y = *reinterpret_cast<const uint32_t*>(&b);
          *reinterpret_cast<uint2*>(dst + j) = u;
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + j) = a;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CT; ++j)
      if (j < nvalid) dst[j] = from_f32<XT>(v[j]);
  }
}

// Everything after staging: each thread's unit and K part, the walk over
// steps [kp * per * unit, (kp + 1) * per * unit) of `total`, the in-CTA
// reduce of the parts in part order, and the emit of part 0:
// act(acc * scale + bias) (`scaled`, the quant order; else act(acc +
// bias)), pooled over the 2 x 2 window (avg: sum, then / 4; max) or stored
// per position, for columns n0 .. n0 + nvalid - 1 of the N-wide output.
// `s` holds the staged images, weight rows, patch offsets and emit
// vectors (reg_store_epilogue), after reg_finish_images.
template <typename XT, int CT>
__device__ inline void reg_conv_tail(const ConvGeom& g, const RegPlan& pl,
                                     int B, const RegSmem& s, int total,
                                     int unit, int n0, int nvalid, int N,
                                     bool scaled, bool biased,
                                     XT* __restrict__ out, int act,
                                     float tau) {
  const int tid = threadIdx.x;
  const int kp = tid / pl.part, u = tid - kp * pl.part;
  const int ii = u / pl.units, un = u - ii * pl.units;
  const int b = blockIdx.x * pl.img + ii;
  const bool active = ii < pl.img && b < B;
  const int ur = un / pl.upr, uc = un - ur * pl.upr;
  const int stride = reg_img_stride(g, pl);

  // the unit's conv positions and their patch bases in s.img
  int orow[REG_POS], ocol[REG_POS], base[REG_POS];
  bool valid[REG_POS];
#pragma unroll
  for (int p = 0; p < REG_POS; ++p) {
    if (g.z == 2) {
      orow[p] = 2 * ur + (p >> 1);
      ocol[p] = 2 * uc + (p & 1);
      valid[p] = true;
    } else {
      orow[p] = ur;
      ocol[p] = REG_STRIP * uc + p;
      valid[p] = ocol[p] < g.Wo;
      if (!valid[p]) ocol[p] = REG_STRIP * uc;  // a loadable position
    }
    base[p] = ii * stride + orow[p] * g.sh * g.W + ocol[p] * g.sw;
  }

  float acc[REG_POS][CT];
#pragma unroll
  for (int p = 0; p < REG_POS; ++p)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[p][j] = 0.f;

  if (active) {
    const int s0 = min(total, kp * pl.per * unit);
    const int s1 = min(total, (kp + 1) * pl.per * unit);
    const float* __restrict__ im = s.img;
#pragma unroll 2
    for (int st = s0; st < s1; ++st) {
      const int ko = s.koff[st];
      float v[REG_POS], w[CT];
#pragma unroll
      for (int p = 0; p < REG_POS; ++p) v[p] = im[base[p] + ko];
      reg_load_row<CT>(s.ws + st * CT, w);
#pragma unroll
      for (int p = 0; p < REG_POS; ++p)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[p][j] = fmaf(v[p], w[j], acc[p][j]);
    }
  }

  if (pl.ks > 1) {  // uniform across the CTA
    if (kp > 0) {
#pragma unroll
      for (int p = 0; p < REG_POS; ++p)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          s.red[(((size_t)(kp - 1) * REG_POS + p) * CT + j) * pl.part + u] =
              acc[p][j];
    }
    __syncthreads();
    if (kp == 0) {
      for (int q = 1; q < pl.ks; ++q)
#pragma unroll
        for (int p = 0; p < REG_POS; ++p)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc[p][j] +=
                s.red[(((size_t)(q - 1) * REG_POS + p) * CT + j) * pl.part +
                      u];
    }
  }
  if (kp != 0 || !active) return;

  // emit: scale (quant), bias and activation per position, in registers
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const float sc = s.ep[j], bi = s.ep[CT + j];
#pragma unroll
    for (int p = 0; p < REG_POS; ++p) {
      float v = acc[p][j];
      if (scaled) v = v * sc;
      if (biased) v += bi;
      acc[p][j] = apply_act(v, act, tau);
    }
  }
  constexpr int VW = CT % 4 == 0 ? 4 : 2;
  const bool vec = nvalid >= CT && N % VW == 0 &&
                   (reinterpret_cast<uintptr_t>(out) % (VW * sizeof(XT))) == 0;
  if (g.z == 2) {
    const int Hp = g.Ho / 2, Wp = g.Wo / 2;
    float o[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      if (g.pool_max) {
        o[j] = fmaxf(fmaxf(fmaxf(acc[0][j], acc[1][j]), acc[2][j]),
                     acc[3][j]);
      } else {
        o[j] = (((acc[0][j] + acc[1][j]) + acc[2][j]) + acc[3][j]) / 4.f;
      }
    }
    reg_store<XT, CT>(out + (((size_t)b * Hp + ur) * Wp + uc) * N + n0, o,
                      nvalid, vec);
  } else {
#pragma unroll
    for (int p = 0; p < REG_POS; ++p) {
      if (!valid[p]) continue;
      float o[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) o[j] = acc[p][j];
      reg_store<XT, CT>(
          out + (((size_t)b * g.Ho + orow[p]) * g.Wo + ocol[p]) * N + n0, o,
          nvalid, vec);
    }
  }
}

// Launch configuration of a plan; cudaErrorInvalidValue when the plan does
// not fit the kernel (a column tile other than CT, too many threads).
template <int CT>
__host__ inline cudaError_t reg_check(const RegPlan& p) {
  if (p.ct != CT || p.ks < 1 || p.part % 32 != 0 ||
      p.ks * p.part > REG_NT || p.img * p.units > p.part)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace rt
