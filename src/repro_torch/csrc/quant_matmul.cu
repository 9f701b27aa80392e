// Quantised dense matmul: y = act((x @ Wq) * s + b) with int8 codes or
// bit-packed int4x2 / int2x4 codes along K.
//
// Replaces the Pallas kernel repro/kernels/quant_matmul/kernel.py
// (`quant_matmul` / `_kernel` / `_kernel_packed_db`).
//
// What it computes, as the TPU kernel does: codes are decoded in registers
// and accumulated against x in f32 WITHOUT their scale; the per-output-
// channel scale is applied once to the accumulator at emit, followed by the
// bias and the activation.  (The block-sparse kernel applies its scale
// before the dot; the two orders are kept as they are in the reference.)
//
// What bounds it on the H100: bytes.  At decode shapes every weight byte
// feeds only M FMAs, so the floor is the code stream over HBM bandwidth, and
// the packed containers halve or quarter it.  The design reads the container
// once, in its packed form, decoding in registers.  Each CTA owns one
// (m-tile, 32-column slice) of the output and loops over K inside; its eight
// warps take interleaved byte rows of K, so eight times as many threads share
// the K walk of a column slice, and their partial sums are reduced once in
// shared memory.  x is staged in rounds of up to 32 KB (1024 columns of K at
// 8 rows), so a CTA waits on staging only a few times per call.  Rows >= M
// are masked.  This is the simple form: the FMAs run on the CUDA cores, with
// no wgmma, TMA or software pipeline yet.
#include "common.cuh"

namespace {

constexpr int BN_T = 32;         // output columns per CTA (one per lane)
constexpr int KG = 8;            // warps per CTA, each taking every KG-th row
constexpr int NT = BN_T * KG;    // threads per CTA
constexpr int XS = 8192;         // floats of x staged per round (32 KB)

template <typename XT, int WK, int TM>
__global__ void __launch_bounds__(NT)
    qmm_kernel(const XT* __restrict__ x, int M, int K,
               const typename rt::WTraits<WK>::T* __restrict__ w, int N,
               const float* __restrict__ scales, const float* __restrict__ bias,
               XT* __restrict__ out, int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  constexpr int KCAP = XS / TM;  // x columns per staged row
  __shared__ float xs[XS];       // xs[mm * KCAP + col]; reused for the reduction

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BN_T + tx;
  const int n = blockIdx.x * BN_T + tx;
  const bool nv = n < N;
  const int m0 = blockIdx.y * TM;

  float acc[TM];
#pragma unroll
  for (int mm = 0; mm < TM; ++mm) acc[mm] = 0.f;

  for (int kk = 0; kk < K; kk += KCAP) {
    const int kc = min(KCAP, K - kk);
    __syncthreads();
    for (int e = tid; e < TM * kc; e += NT) {
      const int mm = e / kc, t = e - mm * kc;
      const int m = m0 + mm;
      xs[mm * KCAP + t] = m < M ? rt::to_f32(x[(size_t)m * K + kk + t]) : 0.f;
    }
    __syncthreads();
    if (nv) {
      const int kr = kc / R;
      const typename W::T* wcol = w + (size_t)(kk / R) * N + n;
#pragma unroll 4
      for (int br = ty; br < kr; br += KG) {
        const typename W::T v = wcol[(size_t)br * N];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const float code = W::get(v, t);  // scale comes after accumulation
          const int k = br * R + t;
#pragma unroll
          for (int mm = 0; mm < TM; ++mm)
            acc[mm] = fmaf(xs[mm * KCAP + k], code, acc[mm]);
        }
      }
    }
  }

  __syncthreads();
  float* red = xs;  // red[(warp * TM + mm) * BN_T + lane]
#pragma unroll
  for (int mm = 0; mm < TM; ++mm) red[(ty * TM + mm) * BN_T + tx] = acc[mm];
  __syncthreads();
  for (int e = tid; e < TM * BN_T; e += NT) {
    const int mm = e / BN_T, jx = e - mm * BN_T;
    const int m = m0 + mm, nn = blockIdx.x * BN_T + jx;
    if (m < M && nn < N) {
      float a = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) a += red[(g * TM + mm) * BN_T + jx];
      float v = a * scales[nn];
      if (bias != nullptr) v += bias[nn];
      out[(size_t)m * N + nn] = rt::from_f32<XT>(rt::apply_act(v, act, tau));
    }
  }
}

template <typename XT, int WK, int TM>
cudaError_t launch_t(const void* x, int M, int K, const void* w, int N,
                     const float* scales, const float* bias, void* out, int act,
                     float tau, cudaStream_t stream) {
  dim3 grid((N + BN_T - 1) / BN_T, (M + TM - 1) / TM);
  dim3 block(BN_T, KG);
  qmm_kernel<XT, WK, TM><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), M, K,
      static_cast<const typename rt::WTraits<WK>::T*>(w), N, scales, bias,
      static_cast<XT*>(out), act, tau);
  return cudaGetLastError();
}

template <typename XT, int WK>
cudaError_t launch_m(int tm, const void* x, int M, int K, const void* w, int N,
                     const float* scales, const float* bias, void* out, int act,
                     float tau, cudaStream_t stream) {
  switch (tm) {
    case 1:
      return launch_t<XT, WK, 1>(x, M, K, w, N, scales, bias, out, act, tau, stream);
    case 8:
      return launch_t<XT, WK, 8>(x, M, K, w, N, scales, bias, out, act, tau, stream);
    case 16:
      return launch_t<XT, WK, 16>(x, M, K, w, N, scales, bias, out, act, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_w(int wkind, int tm, const void* x, int M, int K,
                     const void* w, int N, const float* scales,
                     const float* bias, void* out, int act, float tau,
                     cudaStream_t stream) {
  switch (wkind) {
    case rt::W_I8:
      return launch_m<XT, rt::W_I8>(tm, x, M, K, w, N, scales, bias, out, act, tau, stream);
    case rt::W_U4:
      return launch_m<XT, rt::W_U4>(tm, x, M, K, w, N, scales, bias, out, act, tau, stream);
    case rt::W_U2:
      return launch_m<XT, rt::W_U2>(tm, x, M, K, w, N, scales, bias, out, act, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), row-major; out: (M, N)
// of the same type.  w: (K / R, N) of the `wkind` container (int8, int4x2,
// int2x4).  scales: (N,) f32; bias: (N,) f32 or null.  tm: rows per CTA
// (1, 8, 16).  Returns the launch's cudaError_t (0 on success).
extern "C" int qmm_launch(const void* x, int x_bf16, int M, int K,
                          const void* w, int wkind, int N, const float* scales,
                          const float* bias, void* out, int tm, int act,
                          float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_w<__nv_bfloat16>(wkind, tm, x, M, K, w, N, scales, bias,
                                        out, act, tau, s);
  return (int)launch_w<float>(wkind, tm, x, M, K, w, N, scales, bias, out, act,
                              tau, s);
}
