// Fused FC stack: y = actL(... act1(x @ W1 + b1) ... @ WL + bL) in one
// launch, every intermediate activation kept on chip.
//
// Replaces the Pallas kernel repro/kernels/fc_stack.py (`_call` /
// `_stack_kernel`, reached through `fc_stack_matmul`).
//
// What it computes, as the TPU kernel does: the weights arrive densified
// f32 (K_i, N_i) with N_i = K_{i+1}; each layer adds its bias and applies
// its activation in f32 before feeding the next; only the last layer's
// output is written.
//
// What bounds it on the H100: at LeNet's widths (256 -> 120 -> 84 -> 10,
// 166 KB of f32 weights) the floor is the weight stream plus x over HBM,
// a few microseconds' worth, and at a batch of 256 rows the FMAs are still
// below the f32 rate's floor; in practice launch latency dominates.  What
// the TPU kernel kept out of HBM, the intermediates, stays out here too:
// one CTA owns a tile of TM rows and keeps the tile's activations of every
// layer in shared memory (two ping-pong buffers), so nothing between the
// layers touches device memory.  Each layer walks its output columns in
// slices of 32 (one per lane); the 8 warps split K and reduce once in
// shared memory.  Weight reads are coalesced along N and, at these sizes,
// come from L2 after the first CTA.  FMAs on the CUDA cores in f32.
#include "common.cuh"

namespace {

constexpr int LANES = 32;
constexpr int KG = 8;               // warps per CTA, each taking every KG-th k
constexpr int NT = LANES * KG;
constexpr int MAXL = 8;             // layers per stack

struct Stack {
  int n;
  int dims[MAXL + 1];               // K_0, N_0 = K_1, ..., N_{n-1}
  const float* w[MAXL];             // (dims[l], dims[l + 1]) row-major f32
  const float* b[MAXL];             // (dims[l + 1],) f32 or null
  int act[MAXL];
  float tau[MAXL];
};

template <typename XT, int TM>
__global__ void __launch_bounds__(NT)
    fcs_kernel(const XT* __restrict__ x, int M, Stack st, int wmax,
               XT* __restrict__ out) {
  extern __shared__ float smem[];
  float* hin = smem;                    // (TM, width) of the layer input
  float* hout = smem + TM * wmax;       // (TM, width) of the layer output
  float* red = smem + 2 * TM * wmax;    // (KG, TM, LANES) partial sums
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * LANES + tx;
  const int m0 = blockIdx.x * TM;

  const int K0 = st.dims[0];
  for (int e = tid; e < TM * K0; e += NT) {
    const int mm = e / K0, k = e - mm * K0;
    hin[e] = m0 + mm < M ? rt::to_f32(x[(size_t)(m0 + mm) * K0 + k]) : 0.f;
  }

  for (int l = 0; l < st.n; ++l) {
    const int K = st.dims[l], N = st.dims[l + 1];
    const float* __restrict__ W = st.w[l];
    const float* __restrict__ bias = st.b[l];
    for (int nb = 0; nb < N; nb += LANES) {
      const int n = nb + tx;
      float acc[TM];
#pragma unroll
      for (int mm = 0; mm < TM; ++mm) acc[mm] = 0.f;
      __syncthreads();  // hin complete; red free for this slice
      if (n < N) {
#pragma unroll 4
        for (int k = ty; k < K; k += KG) {
          const float w = W[(size_t)k * N + n];
#pragma unroll
          for (int mm = 0; mm < TM; ++mm)
            acc[mm] = fmaf(hin[mm * K + k], w, acc[mm]);
        }
      }
#pragma unroll
      for (int mm = 0; mm < TM; ++mm) red[(ty * TM + mm) * LANES + tx] = acc[mm];
      __syncthreads();
      for (int e = tid; e < TM * LANES; e += NT) {
        const int mm = e / LANES, jx = e - mm * LANES;
        const int nn = nb + jx;
        if (nn < N) {
          float v = 0.f;
#pragma unroll
          for (int g = 0; g < KG; ++g) v += red[(g * TM + mm) * LANES + jx];
          if (bias != nullptr) v += bias[nn];
          hout[mm * N + nn] = rt::apply_act(v, st.act[l], st.tau[l]);
        }
      }
    }
    float* t = hin;
    hin = hout;
    hout = t;
  }

  __syncthreads();
  const int NL = st.dims[st.n];
  for (int e = tid; e < TM * NL; e += NT) {
    const int mm = e / NL, n = e - mm * NL;
    if (m0 + mm < M)
      out[(size_t)(m0 + mm) * NL + n] = rt::from_f32<XT>(hin[mm * NL + n]);
  }
}

template <typename XT, int TM>
cudaError_t launch_t(const void* x, int M, const Stack& st, int wmax,
                     void* out, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * TM * wmax + KG * TM * LANES) * sizeof(float);
  auto kernel = fcs_kernel<XT, TM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 block(LANES, KG);
  kernel<<<(M + TM - 1) / TM, block, smem, stream>>>(
      static_cast<const XT*>(x), M, st, wmax, static_cast<XT*>(out));
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_m(int tm, const void* x, int M, const Stack& st, int wmax,
                     void* out, cudaStream_t stream) {
  switch (tm) {
    case 1:
      return launch_t<XT, 1>(x, M, st, wmax, out, stream);
    case 4:
      return launch_t<XT, 4>(x, M, st, wmax, out, stream);
    case 8:
      return launch_t<XT, 8>(x, M, st, wmax, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, dims[0]) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); out: (M,
// dims[n_layers]) of the same type.  dims: n_layers + 1 ints; ws / bs:
// n_layers device pointers (bs entries may be null); acts / taus: the
// activation code and threshold of each layer.  tm: rows per CTA (1, 4, 8).
// Returns the launch's cudaError_t (0 on success).
extern "C" int fcs_launch(const void* x, int x_bf16, int M, int n_layers,
                          const int* dims, const void* const* ws,
                          const void* const* bs, const int* acts,
                          const float* taus, void* out, int tm,
                          void* stream) {
  if (n_layers < 1 || n_layers > MAXL) return (int)cudaErrorInvalidValue;
  Stack st;
  st.n = n_layers;
  int wmax = 0;
  for (int l = 0; l <= n_layers; ++l) {
    st.dims[l] = dims[l];
    wmax = dims[l] > wmax ? dims[l] : wmax;
  }
  for (int l = 0; l < n_layers; ++l) {
    st.w[l] = static_cast<const float*>(ws[l]);
    st.b[l] = static_cast<const float*>(bs[l]);
    st.act[l] = acts[l];
    st.tau[l] = taus[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_m<__nv_bfloat16>(tm, x, M, st, wmax, out, s);
  return (int)launch_m<float>(tm, x, M, st, wmax, out, s);
}
