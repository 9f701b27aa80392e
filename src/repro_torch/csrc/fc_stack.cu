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
// 166 KB of f32 weights, 21.3 MFLOP at a batch of 256 rows) neither bytes
// nor FMAs: a few tenths of a microsecond each across the card.  The time
// goes to latency: the launch, getting the weights from L2 into every SM
// that needs them, and each layer's chain of shared-memory reads, FMAs and
// barriers.  What the TPU kernel kept out of HBM, the intermediates, stays
// out here too: a CTA keeps the activations of its row tile in shared
// memory, so nothing between the layers touches device memory.  Two routes
// (kernels/fc_stack.py `fcs_route`, a shape rule, picks one):
//
// "staged" (fcs_staged_kernel): a CTA of 512 threads owns a tile of tm
// rows and every column.  At the start it copies every layer's weights
// into shared memory once, by cp.async, one commit group a layer, so a
// layer waits only for its own.  A thread owns 2 rows x 4 columns of
// accumulators over one K part (of about 16 k rows; the split depends on
// K only), reading weight rows and activation rows as float4; the parts'
// sums go through shared memory and are added in part order, then bias
// and activation in f32.  FMAs stay f32 on the CUDA cores.
//
// "stream" (fcs_kernel, the first design): one CTA owns TM rows and every
// column; each layer walks its output columns in slices of 32 (one per
// lane), the 8 warps split K and reduce once in shared memory; weights are
// read from global memory (L2 after the first CTA) inside the K walk.  It
// takes any width whose two activation buffers fit shared memory.
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

// ------------------------------------------------------------ staged route

constexpr int ST_NT = 512;    // threads per CTA of the staged route
constexpr int ST_ARGS = 512;  // shared-memory bytes held for StagedArgs

// The plan of one staged launch (kernels/fc_stack.py FcsPlan.ints()).
struct StagedPlan {
  int tm;         // rows per CTA (even)
  int S;          // floats from one activation row to the next (S % 32 == 4)
  int ks[MAXL];   // per layer: K parts
  int per[MAXL];  // per layer: k rows per part, a multiple of 4
};

// The stack and the plan, copied into shared memory at the start of a CTA:
// one batch of parameter reads, and the layer loop indexes them without a
// copy of the structs in local memory (which indexing the parameters by a
// runtime layer number makes).
struct StagedArgs {
  Stack st;
  StagedPlan p;
};
static_assert(sizeof(StagedArgs) <= ST_ARGS && ST_ARGS % 16 == 0,
              "the stack and plan fit their shared-memory bytes");

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Bytes of dynamic shared memory, in the kernel's layout order (floats
// after the ST_ARGS bytes of StagedArgs; the kernel has no static shared
// memory):
//   act  [2][tm][S]                   the two activation buffers (ping-pong)
//   w    [l][round4(K_l)][round4(N_l)] each layer's weights, zero-padded
//   b    [l][round4(N_l)]              each layer's bias
//   red  [max_l ks_l * tm * round4(N_l)] the K parts' partial sums
__host__ inline size_t staged_smem(const Stack& st, const StagedPlan& p) {
  size_t f = (size_t)2 * p.tm * p.S, red = 0;
  for (int l = 0; l < st.n; ++l) {
    const size_t cols = round4(st.dims[l + 1]);
    f += (size_t)round4(st.dims[l]) * cols + cols;
    const size_t r = (size_t)p.ks[l] * p.tm * cols;
    red = r > red ? r : red;
  }
  return ST_ARGS + (f + red) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global `src` to shared `dst` (both 16-byte aligned); the
// bytes past `src_bytes` (0 or 16) are written as zeros, nothing is read
// for them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, zero when `src_bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Closes this thread's group of cp.async copies issued since the last.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `n` (0 to 7) of this thread's groups are still in
// flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0:
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      break;
    case 1:
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      break;
    case 2:
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
      break;
    case 3:
      asm volatile("cp.async.wait_group 3;\n" ::: "memory");
      break;
    case 4:
      asm volatile("cp.async.wait_group 4;\n" ::: "memory");
      break;
    case 5:
      asm volatile("cp.async.wait_group 5;\n" ::: "memory");
      break;
    case 6:
      asm volatile("cp.async.wait_group 6;\n" ::: "memory");
      break;
    default:
      asm volatile("cp.async.wait_group 7;\n" ::: "memory");
      break;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[j] += a * w[j] (one FMA each), j = 0..3
__device__ __forceinline__ void fma4(float (&acc)[4], float a, float4 w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// Rows m0 .. m0 + tm - 1 of x as f32 into a (tm, S) activation buffer:
// f32 rows by 16-byte cp.async copies where K0 and x allow (rows past M
// zero-filled), bf16 by 16-byte loads converted, else element by element;
// columns K0 .. round4(K0) - 1 are zeros.
template <typename XT>
__device__ inline void staged_load_x(const XT* __restrict__ x, int M, int K0,
                                     int m0, int tm, int S, float* act) {
  const int tid = threadIdx.x;
  constexpr int VE = 16 / sizeof(XT);
  if (K0 % VE == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const int nv = K0 / VE;
    for (int e = tid; e < tm * nv; e += ST_NT) {
      const int r = e / nv, v = e - r * nv;
      float* d = act + r * S + v * VE;
      const bool in = m0 + r < M;
      const XT* src = x + (in ? (size_t)(m0 + r) * K0 + v * VE : 0);
      if constexpr (VE == 4) {
        cp_async16(d, src, in ? 16 : 0);
      } else if (in) {
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]);
        const float2 b = __bfloat1622float2(h[1]);
        const float2 c = __bfloat1622float2(h[2]);
        const float2 dd = __bfloat1622float2(h[3]);
        st4(d, make_float4(a.x, a.y, b.x, b.y));
        st4(d + 4, make_float4(c.x, c.y, dd.x, dd.y));
      } else {
        st4(d, make_float4(0.f, 0.f, 0.f, 0.f));
        st4(d + 4, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  } else {
    for (int e = tid; e < tm * K0; e += ST_NT) {
      const int r = e / K0, k = e - r * K0;
      act[r * S + k] =
          m0 + r < M ? rt::to_f32(x[(size_t)(m0 + r) * K0 + k]) : 0.f;
    }
  }
  const int pad = round4(K0) - K0;
  for (int e = tid; e < tm * pad; e += ST_NT) {
    const int r = e / pad;
    act[r * S + K0 + (e - r * pad)] = 0.f;
  }
}

// One CTA of the staged route: row tile blockIdx.x, every column.  One
// loop body serves every layer; the stack and the plan are read from
// shared memory.
//
// Staging: x's rows, every layer's bias and layer 0's weights (round4(K)
// rows of round4(N) columns, zero past K and N) form the first cp.async
// group, each later layer's weights one more group; layer l waits for its
// group only, before the barrier that ends layer l - 1.
//
// Layer l, K_l -> N_l: slot s of [0, ks * items), items = (tm / 2) * G_l
// with G_l = round4(N_l) / 4, is K part kp = s / items, item it = s %
// items: rows 2 rp, 2 rp + 1 (rp = it / G_l) x columns 4 g .. 4 g + 3 (g =
// it % G_l).  It walks k = kp * per .. min(round4(K), (kp + 1) * per) - 1
// in order, one FMA per (row, column) and k, from 0, and stores its 8
// partial sums.  Then output (r, column) sums the parts in part order,
// ((p0 + p1) + p2) ..., adds the bias and applies the activation; the
// last layer stores to `out`, the others to the next activation buffer.
template <typename XT>
__global__ void __launch_bounds__(ST_NT)
    fcs_staged_kernel(const XT* __restrict__ x, int M,
                      const __grid_constant__ StagedArgs args,
                      XT* __restrict__ out) {
  extern __shared__ __align__(16) float smem_f[];
  StagedArgs& sa = *reinterpret_cast<StagedArgs*>(smem_f);
  const int tid = threadIdx.x;
  {
    static_assert(sizeof(StagedArgs) % 4 == 0, "word copy");
    constexpr int NW = sizeof(StagedArgs) / 4;
    const int* src = reinterpret_cast<const int*>(&args);
    int* dst = reinterpret_cast<int*>(&sa);
    if (tid < NW) dst[tid] = src[tid];
  }
  __syncthreads();
  const Stack& st = sa.st;
  const StagedPlan& p = sa.p;
  const int tm = p.tm, S = p.S, NL = st.n;
  const int m0 = blockIdx.x * tm;
  float* act0 = smem_f + ST_ARGS / sizeof(float);
  float* act1 = act0 + tm * S;
  float* wbase = act1 + tm * S;

  float* bias_sm = wbase;
  for (int l = 0; l < NL; ++l)
    bias_sm += round4(st.dims[l]) * round4(st.dims[l + 1]);
  float* red = bias_sm;
  for (int l = 0; l < NL; ++l) red += round4(st.dims[l + 1]);

  // cp.async groups: x, the biases and layer 0, then one per later layer
  staged_load_x(x, M, st.dims[0], m0, tm, S, act0);
  {
    float* b = bias_sm;
#pragma unroll 1
    for (int l = 0; l < NL; ++l) {
      const int N = st.dims[l + 1], cols = round4(N);
      const float* __restrict__ B = st.b[l];
      for (int c = tid; c < cols; c += ST_NT) {
        const bool in = B != nullptr && c < N;
        cp_async4(b + c, in ? B + c : st.w[0], in ? 4 : 0);
      }
      b += cols;
    }
  }
  float* w = wbase;
#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
    const int K = st.dims[l], N = st.dims[l + 1], cols = round4(N);
    const int G = cols / 4;
    const float* __restrict__ W = st.w[l];
    const bool vec =
        N % 4 == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;
    const int n = round4(K) * G;
    for (int e = tid; e < n; e += ST_NT) {
      const int k = e / G, g = e - k * G;
      float* dst = w + k * cols + 4 * g;
      const bool in = k < K;
      const float* src = in ? W + (size_t)k * N + 4 * g : W;
      if (vec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        for (int j = 0; j < 4; ++j) {
          const bool ij = in && 4 * g + j < N;
          cp_async4(dst + j, ij ? src + j : W, ij ? 4 : 0);
        }
      }
    }
    w += round4(K) * cols;
    cp_async_commit();
  }
  cp_async_wait(NL - 1);  // x, the biases and layer 0
  __syncthreads();

  const int RP = tm / 2;
  const float* wl = wbase;
  const float* bl = bias_sm;
#pragma unroll 1
  for (int l = 0; l < NL; ++l) {
    const float* cur = (l & 1) ? act1 : act0;
    float* nxt = (l & 1) ? act0 : act1;
    const int N = st.dims[l + 1], K4 = round4(st.dims[l]);
    const int cols = round4(N), Gl = cols / 4, ks = p.ks[l], per = p.per[l];
    const int items = RP * Gl;
    for (int s = tid; s < ks * items; s += ST_NT) {
      const int kp = s / items, it = s - kp * items;
      const int rp = it / Gl, g = it - rp * Gl;
      const int k0 = kp * per, k1 = min(K4, k0 + per);
      const float* a0 = cur + 2 * rp * S;
      const float* a1 = a0 + S;
      const float* wg = wl + 4 * g;
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int k = k0; k < k1; k += 4) {
        const float4 x0 = ld4(a0 + k), x1 = ld4(a1 + k);
        const float* wk = wg + k * cols;
        const float4 w0 = ld4(wk);
        const float4 w1 = ld4(wk + cols);
        const float4 w2 = ld4(wk + 2 * cols);
        const float4 w3 = ld4(wk + 3 * cols);
        fma4(acc0, x0.x, w0);
        fma4(acc1, x1.x, w0);
        fma4(acc0, x0.y, w1);
        fma4(acc1, x1.y, w1);
        fma4(acc0, x0.z, w2);
        fma4(acc1, x1.z, w2);
        fma4(acc0, x0.w, w3);
        fma4(acc1, x1.w, w3);
      }
      float* rd = red + (kp * tm + 2 * rp) * cols + 4 * g;
      st4(rd, make_float4(acc0[0], acc0[1], acc0[2], acc0[3]));
      st4(rd + cols, make_float4(acc1[0], acc1[1], acc1[2], acc1[3]));
    }
    __syncthreads();

    const bool last = l == NL - 1;
    const int act = st.act[l];
    const float tau = st.tau[l];
    for (int e = tid; e < tm * cols; e += ST_NT) {
      const int r = e / cols, c = e - r * cols;
      float v = red[r * cols + c];
      for (int kp = 1; kp < ks; ++kp) v += red[(kp * tm + r) * cols + c];
      v = rt::apply_act(v + bl[c], act, tau);
      if (last) {
        if (m0 + r < M && c < N)
          out[(size_t)(m0 + r) * N + c] = rt::from_f32<XT>(v);
        continue;
      }
      // columns N .. round4(N) - 1 feed the next layer's zero padding
      nxt[r * S + c] = c < N ? v : 0.f;
    }
    if (!last) {
      cp_async_wait(NL - 2 - l);  // layer l + 1's weights
      __syncthreads();
    }
    wl += K4 * cols;
    bl += cols;
  }
}

template <typename XT>
cudaError_t launch_staged(const void* x, int M, const Stack& st,
                          const StagedPlan& p, size_t smem, void* out,
                          cudaStream_t stream) {
  auto kernel = fcs_staged_kernel<XT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  StagedArgs args;
  args.st = st;
  args.p = p;
  kernel<<<(M + p.tm - 1) / p.tm, ST_NT, smem, stream>>>(
      static_cast<const XT*>(x), M, args, static_cast<XT*>(out));
  return cudaGetLastError();
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

// The staged route.  Arguments as fcs_launch, then `plan`: tm, S, then
// n_layers each of ks and per (FcsPlan.ints()), and
// `smem`, the plan's shared-memory bytes, checked against the kernel's
// layout.
// Returns cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int fcs_staged_launch(const void* x, int x_bf16, int M,
                                 int n_layers, const int* dims,
                                 const void* const* ws,
                                 const void* const* bs, const int* acts,
                                 const float* taus, void* out,
                                 const int* plan, long long smem,
                                 void* stream) {
  if (n_layers < 1 || n_layers > MAXL || M < 1)
    return (int)cudaErrorInvalidValue;
  Stack st;
  st.n = n_layers;
  for (int l = 0; l <= n_layers; ++l) st.dims[l] = dims[l];
  for (int l = 0; l < n_layers; ++l) {
    st.w[l] = static_cast<const float*>(ws[l]);
    st.b[l] = static_cast<const float*>(bs[l]);
    st.act[l] = acts[l];
    st.tau[l] = taus[l];
  }
  StagedPlan p;
  p.tm = plan[0];
  p.S = plan[1];
  for (int l = 0; l < n_layers; ++l) {
    p.ks[l] = plan[2 + l];
    p.per[l] = plan[2 + n_layers + l];
  }
  bool ok = p.tm >= 2 && p.tm % 2 == 0 && p.S % 4 == 0;
  for (int l = 0; ok && l < n_layers; ++l) {
    const int K4 = round4(st.dims[l]);
    ok = K4 <= p.S && p.per[l] % 4 == 0 && p.per[l] > 0 &&
         p.ks[l] * p.per[l] >= K4 && (p.ks[l] - 1) * p.per[l] < K4;
  }
  if (!ok || staged_smem(st, p) != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_staged<__nv_bfloat16>(x, M, st, p, (size_t)smem, out,
                                              s);
  return (int)launch_staged<float>(x, M, st, p, (size_t)smem, out, s);
}
