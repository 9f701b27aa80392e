// Fused quantised convolution: y = pool(act(conv(x, Wq) * s + b)) in one
// launch, Wq the dense im2col code matrix of a (kh, kw, cin, cout) conv
// with per-output-channel scales.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul/kernel.py
// (`quant_conv` / `_conv_kernel`).
//
// What it computes, as the TPU kernel does: the same in-kernel patch
// gather and pooled emit as block_sparse_conv.cu, over a dense walk of K.
// Codes (int8, or int4x2 / int2x4 packed along K) are decoded in registers
// and accumulated against the patches WITHOUT their scale; the scale
// multiplies the f32 accumulator at emit, acc * s + b, then the activation
// and the z x z pool (the reference's other operation order, kept).
//
// What bounds it on the H100: as for block_sparse_conv.cu, latency and
// launch overhead at LeNet's shapes (a few KB of input and a few tens of
// thousands of FMAs per image).  The design is the same: a CTA owns
// (image, output column slice, band of conv rows), stages its image band
// once in shared memory, gathers patch values through a per-row offset
// table, accumulates in shared memory over rounds of decoded code rows,
// and pools inside the CTA before the one store.  FMAs on the CUDA cores
// in f32, no tensor cores.
#include "conv_common.cuh"

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
