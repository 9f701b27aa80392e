// Fused quantised convolution: y = pool(act(conv(x, Wq) * s + b)) in one
// launch, Wq the dense im2col code matrix of a (kh, kw, cin, cout) conv
// with per-output-channel scales.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul/kernel.py
// (`quant_conv` / `_conv_kernel`).
//
// What it computes, as the TPU kernel does: the same in-kernel patch
// gather and pooled emit as block_sparse_conv.cu, over a dense walk of K.
// Codes (int8, or int4x2 / int2x4 packed along K) are decoded once per CTA
// and accumulated against the patches WITHOUT their scale; the scale
// multiplies the f32 accumulator at emit, acc * s + b, then the activation
// and the z x z pool (the reference's other operation order, kept).
//
// What bounds it on the H100: as for block_sparse_conv.cu, latency,
// shared-memory traffic and the launch at LeNet's shapes (a B = 256
// forward's two convs are 61 M FMAs, 1.8 us at the f32 rate); the walk
// takes most of a CTA's time, the code decode and staging the rest.  Two
// routes, picked by conv_route:
//   * reg_tile (qconv_reg_kernel, conv_reg.cuh): a thread owns one 2 x 2
//     pooled window (or 4 unpooled positions of a row) times CT columns
//     (the last tile masked past N): 4 * CT FMA chains in registers, each
//     patch value loaded once per k for every column, each code row a
//     shared broadcast for every position.  A CTA is one column tile of a
//     few images, its codes decoded once (vector loads of a stored row's
//     columns, several in flight), its images staged as in
//     block_sparse_conv.cu; K is cut into parts across the CTA's warps so
//     that conv2's 4,096 pooled windows at B = 256 still give the card
//     several warps an SM, part 0 adds the parts in order and runs scale,
//     bias, activation and pool in registers before one store per output.
//   * band (qconv_kernel, conv_common.cuh), the first design, for the
//     shapes the register tile does not cover: (image, column slice, band
//     of conv rows) per CTA, accumulators in shared memory.
// FMAs on the CUDA cores in f32 (LeNet is f32 and held to 1e-5 of
// max|ref|), no tensor cores.
#include "conv_reg.cuh"

namespace {

using rt::CONV_NT;
using rt::ConvGeom;
using rt::ConvSmem;

template <typename XT, int WK>
__global__ void __launch_bounds__(CONV_NT)
    qconv_kernel(const XT* __restrict__ x, ConvGeom g,
                 const typename rt::WTraits<WK>::T* __restrict__ w, int K,
                 int N, const float* __restrict__ scales,
                 const float* __restrict__ bias, XT* __restrict__ out,
                 int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  extern __shared__ float smem[];
  const ConvSmem s = rt::conv_smem(smem, g);

  const int b = blockIdx.x;
  const int n0 = blockIdx.y * g.bns;
  const int nj = min(g.bns, N - n0);
  const int r0 = blockIdx.z * g.band;
  const int nr = min(g.band, g.Ho - r0);

  rt::conv_stage_image(x, b, r0, nr, g, s);

  for (int kk = 0; kk < K; kk += s.kcap) {
    const int nrows = min(s.kcap, K - kk);
    __syncthreads();  // the previous round's rows are consumed
    for (int e = threadIdx.x; e < nrows * nj; e += CONV_NT) {
      const int row = e / nj, j = e - row * nj;
      const int k = kk + row;
      // the code alone: the scale comes after accumulation
      s.ws[row * g.bns + j] = W::get(w[(size_t)(k / R) * N + n0 + j], k % R);
    }
    for (int row = threadIdx.x; row < nrows; row += CONV_NT)
      s.koff[row] = rt::conv_koff(kk + row, g);
    __syncthreads();
    rt::conv_accumulate(nr, nj, nrows, g, s);
  }

  __syncthreads();
  for (int e = threadIdx.x; e < nr * g.Wo * nj; e += CONV_NT) {
    const int p = e / nj, j = e - p * nj;
    float v = s.acc[p * g.bns + j] * scales[n0 + j];
    if (bias != nullptr) v += bias[n0 + j];
    s.acc[p * g.bns + j] = rt::apply_act(v, act, tau);
  }
  __syncthreads();
  rt::conv_pool_store(out, b, r0, nr, nj, n0, N, g, s);
}

template <typename XT, int WK>
cudaError_t launch_t(const void* x, int B, const ConvGeom& g, const void* w,
                     int K, int N, const float* scales, const float* bias,
                     void* out, int act, float tau, cudaStream_t stream) {
  const int n_band = (g.Ho + g.band - 1) / g.band;
  const size_t smem = rt::conv_smem_bytes(g);
  auto kernel = qconv_kernel<XT, WK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, (N + g.bns - 1) / g.bns, n_band);
  kernel<<<grid, CONV_NT, smem, stream>>>(
      static_cast<const XT*>(x), g,
      static_cast<const typename rt::WTraits<WK>::T*>(w), K, N, scales, bias,
      static_cast<XT*>(out), act, tau);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_w(int wkind, const void* x, int B, const ConvGeom& g,
                     const void* w, int K, int N, const float* scales,
                     const float* bias, void* out, int act, float tau,
                     cudaStream_t stream) {
  switch (wkind) {
    case rt::W_I8:
      return launch_t<XT, rt::W_I8>(x, B, g, w, K, N, scales, bias, out, act,
                                    tau, stream);
    case rt::W_U4:
      return launch_t<XT, rt::W_U4>(x, B, g, w, K, N, scales, bias, out, act,
                                    tau, stream);
    case rt::W_U2:
      return launch_t<XT, rt::W_U2>(x, B, g, w, K, N, scales, bias, out, act,
                                    tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The register-tiled route: CTA (bx, by) covers images bx * img onward and
// columns by * CT .. by * CT + CT - 1 (masked past N); its threads walk the
// K rows of the code matrix.
template <typename XT, int WK, int CT>
__global__ void __launch_bounds__(rt::REG_NT)
    qconv_reg_kernel(const XT* __restrict__ x, int B, ConvGeom g,
                     rt::RegPlan pl,
                     const typename rt::WTraits<WK>::T* __restrict__ w, int K,
                     int N, const float* __restrict__ scales,
                     const float* __restrict__ bias, XT* __restrict__ out,
                     int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  extern __shared__ __align__(16) float reg_buf[];
  const rt::RegSmem s = rt::reg_smem(reg_buf, g, pl);
  const int n0 = blockIdx.y * CT;
  const float2 ep = rt::reg_load_epilogue<CT>(scales, bias, n0, N);
  const int b0 = blockIdx.x * pl.img;
  const int nimg = min(pl.img, B - b0);
  rt::reg_stage_images(x, b0, nimg, g, pl, s);

  // the tile's codes, decoded once into walk steps (k rows): a task loads
  // G columns of one stored row at once, several tasks in flight; the code
  // alone, as the scale comes after accumulation
  using T = typename W::T;
  constexpr int G = CT < 4 ? CT : 4;
  constexpr int NG = CT / G;
  const int KB = K / R;  // stored rows (K is a multiple of R)
  const bool vec = n0 + CT <= N && N % G == 0 &&
                   reinterpret_cast<uintptr_t>(w) % (G * sizeof(T)) == 0;
#pragma unroll 4
  for (int e = threadIdx.x; e < KB * NG; e += blockDim.x) {
    const int kb = e / NG, jg = (e - kb * NG) * G;
    const T* p = w + (size_t)kb * N + n0 + jg;
    T v[G];
    if (vec) {
      rt::reg_load_group<T, G>(p, true, v);
    } else {
#pragma unroll
      for (int gg = 0; gg < G; ++gg)
        v[gg] = n0 + jg + gg < N ? p[gg] : T(0);  // masked columns: code 0
    }
#pragma unroll
    for (int t = 0; t < R; ++t) {
      float c[G];
#pragma unroll
      for (int gg = 0; gg < G; ++gg) c[gg] = W::get(v[gg], t);
      rt::reg_store_group<G>(s.ws + (size_t)(kb * R + t) * CT + jg, c);
    }
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    s.koff[k] = rt::reg_koff(k, g);
  rt::reg_store_epilogue<CT>(s, ep);
  rt::reg_finish_images();
  rt::reg_conv_tail<XT, CT>(g, pl, B, s, K, 1, n0, min(CT, N - n0), N, true,
                            bias != nullptr, out, act, tau);
}

template <typename XT, int WK, int CT>
cudaError_t reg_launch_t(const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* w, int K, int N,
                         const float* scales, const float* bias, void* out,
                         int act, float tau, cudaStream_t stream) {
  cudaError_t e = rt::reg_check<CT>(pl);
  if (e != cudaSuccess) return e;
  if (pl.steps != K || K % rt::WTraits<WK>::R != 0 || pl.per < 1 ||
      pl.n_ct != (N + CT - 1) / CT)
    return cudaErrorInvalidValue;
  const size_t smem = rt::reg_smem_bytes(g, pl);
  auto kernel = qconv_reg_kernel<XT, WK, CT>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((B + pl.img - 1) / pl.img, pl.n_ct);
  kernel<<<grid, pl.ks * pl.part, smem, stream>>>(
      static_cast<const XT*>(x), B, g, pl,
      static_cast<const typename rt::WTraits<WK>::T*>(w), K, N, scales, bias,
      static_cast<XT*>(out), act, tau);
  return cudaGetLastError();
}

template <typename XT, int CT>
cudaError_t reg_launch_w(int wkind, const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* w, int K, int N,
                         const float* scales, const float* bias, void* out,
                         int act, float tau, cudaStream_t stream) {
  switch (wkind) {
    case rt::W_I8:
      return reg_launch_t<XT, rt::W_I8, CT>(x, B, g, pl, w, K, N, scales,
                                            bias, out, act, tau, stream);
    case rt::W_U4:
      return reg_launch_t<XT, rt::W_U4, CT>(x, B, g, pl, w, K, N, scales,
                                            bias, out, act, tau, stream);
    case rt::W_U2:
      return reg_launch_t<XT, rt::W_U2, CT>(x, B, g, pl, w, K, N, scales,
                                            bias, out, act, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t reg_launch_c(int wkind, const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* w, int K, int N,
                         const float* scales, const float* bias, void* out,
                         int act, float tau, cudaStream_t stream) {
  switch (pl.ct) {
    case 2:
      return reg_launch_w<XT, 2>(wkind, x, B, g, pl, w, K, N, scales, bias,
                                 out, act, tau, stream);
    case 4:
      return reg_launch_w<XT, 4>(wkind, x, B, g, pl, w, K, N, scales, bias,
                                 out, act, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (B, H, W, C) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), padded NHWC;
// out: (B, Ho / z, Wo / z, N) of the same type.  geom: kh, kw, sh, sw, dh,
// dw, Ho, Wo, z, pool_max, band, bns (12 ints).  w: (K / R, N) of the
// `wkind` container (int8, int4x2, int2x4), packed along K.  scales: (N,)
// f32; bias: (N,) f32 or null.  Returns the launch's cudaError_t.
extern "C" int qconv_launch(const void* x, int x_bf16, int B, int H, int W,
                            int C, const int* geom, const void* w, int wkind,
                            int K, int N, const float* scales,
                            const float* bias, void* out, int act, float tau,
                            void* stream) {
  const ConvGeom g{H,       W,       C,       geom[0], geom[1],
                   geom[2], geom[3], geom[4], geom[5], geom[6],
                   geom[7], geom[8], geom[9], geom[10], geom[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_w<__nv_bfloat16>(wkind, x, B, g, w, K, N, scales, bias,
                                        out, act, tau, s);
  return (int)launch_w<float>(wkind, x, B, g, w, K, N, scales, bias, out, act,
                              tau, s);
}

// The register-tiled route (reg_tile): the arguments of qconv_launch plus
// plan, the 9 ints of ConvPlan.ints() (ct, n_ct, upr, units, img, part, ks,
// per, steps); geom's band and bns are not read.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int qconv_reg_launch(const void* x, int x_bf16, int B, int H,
                                int W, int C, const int* geom,
                                const int* plan, const void* w, int wkind,
                                int K, int N, const float* scales,
                                const float* bias, void* out, int act,
                                float tau, void* stream) {
  const ConvGeom g{H,       W,       C,       geom[0], geom[1],
                   geom[2], geom[3], geom[4], geom[5], geom[6],
                   geom[7], geom[8], geom[9], geom[10], geom[11]};
  const rt::RegPlan pl{plan[0], plan[1], plan[2], plan[3], plan[4],
                       plan[5], plan[6], plan[7], plan[8]};
  if (g.z != 1 && g.z != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)reg_launch_c<__nv_bfloat16>(wkind, x, B, g, pl, w, K, N,
                                            scales, bias, out, act, tau, s);
  return (int)reg_launch_c<float>(wkind, x, B, g, pl, w, K, N, scales, bias,
                                  out, act, tau, s);
}
