// Quantised dense matmul: y = act((x @ Wq) * s + b) with int8 codes or
// bit-packed int4x2 / int2x4 codes along K.  Three kernels, one per route of
// `qmm_route` in kernels/quant_matmul/kernel.py: the thin-M kernel for M <=
// 16 (decode) with N % 4 == 0; the tensor-core kernel for bf16 x past 16
// rows (full-sequence forwards, wide prefill chunks) with K % 64 == 0,
// N % 8 == 0 (the last 128-column tile may be ragged) and 16-byte aligned
// x and codes (8-byte aligned codes when N % 16 == 8); and the tiled
// kernel, the first design on the CUDA cores, for everything else (f32 x,
// odd widths).
//
// Replaces the Pallas kernel repro/kernels/quant_matmul/kernel.py:125
// (`quant_matmul`; bodies `_kernel` :42 and `_kernel_packed_db` :68).
//
// What it computes, as the TPU kernel does: codes are decoded in registers
// and accumulated against x in f32 WITHOUT their scale; the per-output-
// channel scale is applied once to the full K sum at emit, followed by the
// bias and the activation.  (The block-sparse kernels' CUDA-core routes
// apply their scale before the dot, as the reference does there; their
// tensor-core route applies it at emit too.)  Rows >= M are masked.
//
// What bounds it on the H100: bytes at decode shapes, operations past a
// few hundred rows.  At decode shapes every weight byte feeds only M FMAs,
// so the floor is the code stream over HBM bandwidth, and the packed
// containers halve or quarter it.  Every kernel reads the container once
// per tile, in its packed form.  At M = 512 each weight byte feeds 1024
// (int8) to 4096 (int2x4) operations, above the ~295 per byte where the
// tensor cores, not the memory, are the limit.
//
// The tensor-core kernel (`qmm_tc_kernel`) runs tc_matmul.cuh's pipeline:
// 64 or 128 rows by 128 columns per CTA, 64-code K steps of x and packed
// codes copied ahead by TMA from a producer warp, the codes decoded to
// exact bf16 in registers as wgmma's A operand of the transposed product,
// x read from shared memory, f32 accumulators.  TMA needs a row pitch in
// whole 16 bytes; codes of N % 16 == 8 columns (hubert-xlarge's 504-column
// head) are copied by the producer warp's lanes with cp.async in 8-byte
// pieces instead, into the same swizzled stage, x still by TMA: a template
// variant chosen by N, the decode and products unchanged.  A grid whose
// tiles alone are far from one wave of the card (one CTA per SM) is cut
// along K into splits whose f32 partials `tcm::reduce_kernel` adds in
// split order, then scales, biases and activates.
//
// The thin-M kernel (`qmm_thin_kernel`) is built to keep enough bytes in
// flight to approach the byte floor.  Each lane loads 4 bytes (4 columns) of a
// byte row, so a warp reads a whole 128-byte line; each CTA owns 128
// columns and one of `k_splits` ranges of whole byte rows, chosen so that
// even a 512-column leaf launches at least 2 x 132 CTAs; its 4 warps take
// interleaved byte rows, 16 loads in flight per lane (the first batch while
// x's slice is staged in shared memory as [k][m], so one 16-byte shared load
// feeds 16 FMAs; each later batch while the one before is used); codes
// become floats by an exponent trick (no integer conversion).  Each CTA sums
// its warps in shared memory and writes an f32 partial to a workspace; a
// second small kernel (`qmm_reduce_kernel`, a programmatic dependent launch,
// so it is resident before the first one ends) adds the partials in a fixed
// order (8 warps take interleaved splits, then their sums are added in warp
// order), which makes the result the same on every run, and applies scale,
// bias and activation.  With a single split the first kernel emits directly.
//
// The tiled kernel (`qmm_kernel`, the first design) owns one (m-tile,
// 32-column slice) of the output per CTA and loops over all of K; its eight
// warps take interleaved byte rows, one byte per lane per load, and their
// partial sums are reduced once in shared memory.  x is staged in rounds of
// up to 32 KB.  Its FMAs run on the CUDA cores with no software pipeline.
#include "common.cuh"
#include "tc_matmul.cuh"

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

// ------------------------------------------------------------ thin-M route

constexpr int TN_COLS = 128;              // output columns per CTA
constexpr int TN_WARPS = 4;               // warps per CTA, interleaved rows
constexpr int TN_NT = 32 * TN_WARPS;
constexpr int TN_KCAP = 512;              // codes of K per split, at most
constexpr int TN_U = 16;                  // byte rows in flight per lane

// Code `t` of byte `j` of a 4-byte word, as float: the field XOR its sign
// bit is the code + 2^(bits-1), placed in the mantissa of 2^23.
template <int BITS>
__device__ __forceinline__ float code_at(uint32_t word, int shift) {
  constexpr uint32_t MASK = (1u << BITS) - 1u, SIGN = 1u << (BITS - 1);
  const uint32_t f = ((word >> shift) & MASK) ^ SIGN;
  return __uint_as_float(0x4B000000u | f) - (8388608.f + (float)SIGN);
}

template <typename XT, int WK, int TM>
__global__ void __launch_bounds__(TN_NT)
    qmm_thin_kernel(const XT* __restrict__ x, int M, int K,
                    const uint8_t* __restrict__ w, int N, int rows_per_split,
                    const float* __restrict__ scales,
                    const float* __restrict__ bias, float* __restrict__ ws,
                    XT* __restrict__ out, int act, float tau) {
  constexpr int R = rt::WTraits<WK>::R;
  constexpr int BITS = 8 / R;
  // xs[k * TM + m] for the split's K range; reused for the warp reduction
  __shared__ __align__(16) float xs[TN_KCAP * TM];
  static_assert(TN_KCAP * TM >= TN_WARPS * TM * TN_COLS, "reduction fits");

  // the reduce kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y;
  const int nb = blockIdx.x * TN_COLS;
  const int br0 = split * rows_per_split;
  const int br1 = min(br0 + rows_per_split, K / R);
  const int kc = (br1 - br0) * R;
  const int k0 = br0 * R;
  // N % 4 == 0: a lane's 4 columns are all in or all out; lanes out of N
  // load nothing and add zeros
  const int n = nb + 4 * lane;
  const uint8_t* wcol = w + n;
  constexpr int STEP = TN_WARPS * TN_U;  // byte rows of one batch of a CTA

  // this lane's byte rows br0 + warp + TN_WARPS * u of one batch, as words
  auto load = [&](uint32_t(&word)[TN_U], int r) {
#pragma unroll
    for (int u = 0; u < TN_U; ++u) {
      const int rr = r + u * TN_WARPS;
      word[u] = rr < br1 && n < N ? __ldg(reinterpret_cast<const uint32_t*>(
                                        wcol + (size_t)rr * N))
                                  : 0u;
    }
  };
  uint32_t next[TN_U];
  load(next, br0 + warp);  // the first batch flies while x is staged

  // x[:, k0 : k0 + kc] -> xs, rows M .. TM - 1 zero; 8 loads in flight per
  // thread, all of them at decode shapes (TM * kc <= 8 * TN_NT)
  for (int e0 = tid; e0 < TM * kc; e0 += 8 * TN_NT) {
    float xv[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * TN_NT, mm = e / kc;
      xv[u] = e < TM * kc && mm < M
                  ? rt::to_f32(x[(size_t)mm * K + k0 + e - mm * kc])
                  : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * TN_NT, mm = e / kc;
      if (e < TM * kc) xs[(e - mm * kc) * TM + mm] = xv[u];
    }
  }
  __syncthreads();

  float acc[4][TM];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int mm = 0; mm < TM; ++mm) acc[j][mm] = 0.f;

  for (int r = br0 + warp; r < br1; r += STEP) {
    uint32_t word[TN_U];
#pragma unroll
    for (int u = 0; u < TN_U; ++u) word[u] = next[u];
    if (r + STEP < br1) load(next, r + STEP);  // the next batch flies now
#pragma unroll
    for (int u = 0; u < TN_U; ++u) {
      const int rr = r + u * TN_WARPS;
      if (rr >= br1) break;
      const float* xk = xs + (rr - br0) * R * TM;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        float xv[TM];
        if constexpr (TM % 4 == 0) {
#pragma unroll
          for (int mm = 0; mm < TM; mm += 4) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(xk + t * TM + mm);
            xv[mm] = x4.x;
            xv[mm + 1] = x4.y;
            xv[mm + 2] = x4.z;
            xv[mm + 3] = x4.w;
          }
        } else {
#pragma unroll
          for (int mm = 0; mm < TM; ++mm) xv[mm] = xk[t * TM + mm];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = code_at<BITS>(word[u], 8 * j + BITS * t);
#pragma unroll
          for (int mm = 0; mm < TM; ++mm)
            acc[j][mm] = fmaf(xv[mm], c, acc[j][mm]);
        }
      }
    }
  }

  __syncthreads();  // xs is read by every warp before it becomes red
  float* red = xs;  // red[(warp * TM + m) * TN_COLS + column]
#pragma unroll
  for (int mm = 0; mm < TM; ++mm)
    *reinterpret_cast<float4*>(red + (warp * TM + mm) * TN_COLS + 4 * lane) =
        make_float4(acc[0][mm], acc[1][mm], acc[2][mm], acc[3][mm]);
  __syncthreads();
  for (int e = tid; e < TM * TN_COLS; e += TN_NT) {
    const int mm = e / TN_COLS, jx = e - mm * TN_COLS;
    const int nn = nb + jx;
    if (mm >= M || nn >= N) continue;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < TN_WARPS; ++g) a += red[(g * TM + mm) * TN_COLS + jx];
    if (ws != nullptr) {
      ws[((size_t)split * M + mm) * N + nn] = a;
    } else {
      float v = a * scales[nn];
      if (bias != nullptr) v += bias[nn];
      out[(size_t)mm * N + nn] = rt::from_f32<XT>(rt::apply_act(v, act, tau));
    }
  }
}

// out[m, n] = act(sum over splits of ws[s, m, n] * s + b) for 32 outputs per
// CTA: warp w adds splits w, w + 8, ... (32 consecutive floats per load),
// then warp 0 adds the 8 warps' sums in warp order, so the order is the
// same on every run.  Launched as a programmatic dependent of the split
// kernel: its CTAs may start early and wait here for that grid's end.
constexpr int RD_WARPS = 8;

template <typename XT>
__global__ void __launch_bounds__(32 * RD_WARPS)
    qmm_reduce_kernel(const float* __restrict__ ws, int splits, int M, int N,
                      const float* __restrict__ scales,
                      const float* __restrict__ bias, XT* __restrict__ out,
                      int act, float tau) {
  __shared__ float part[RD_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const bool in = i < M * N;
  const size_t stride = (size_t)M * N;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  float a = 0.f;
  if (in) {
#pragma unroll 8
    for (int s = warp; s < splits; s += RD_WARPS) a += ws[s * stride + i];
  }
  part[warp][lane] = a;
  __syncthreads();
  if (warp != 0 || !in) return;
  a = part[0][lane];
#pragma unroll
  for (int w = 1; w < RD_WARPS; ++w) a += part[w][lane];
  const int nn = i % N;
  float v = a * scales[nn];
  if (bias != nullptr) v += bias[nn];
  out[i] = rt::from_f32<XT>(rt::apply_act(v, act, tau));
}

// The reduce pass over `splits` partials, a programmatic dependent of the
// kernel launched just before it.
template <typename XT>
cudaError_t reduce(const float* ws, int splits, int M, int N,
                   const float* scales, const float* bias, void* out, int act,
                   float tau, cudaStream_t stream) {
  return rt::launch_dependent(qmm_reduce_kernel<XT>, dim3((M * N + 31) / 32),
                              dim3(32 * RD_WARPS), stream, true, ws, splits,
                              M, N, scales, bias, static_cast<XT*>(out), act,
                              tau);
}

template <typename XT, int WK, int TM>
cudaError_t thin_t(const void* x, int M, int K, const void* w, int N,
                   int k_splits, int rows_per_split, const float* scales,
                   const float* bias, float* ws, void* out, int act, float tau,
                   cudaStream_t stream) {
  // the split's codes must fit the kernel's x stage
  if (k_splits < 1 || rows_per_split * rt::WTraits<WK>::R > TN_KCAP ||
      N % 4 != 0)
    return cudaErrorInvalidValue;
  dim3 grid((N + TN_COLS - 1) / TN_COLS, k_splits);
  qmm_thin_kernel<XT, WK, TM><<<grid, TN_NT, 0, stream>>>(
      static_cast<const XT*>(x), M, K, static_cast<const uint8_t*>(w), N,
      rows_per_split, scales, bias, k_splits > 1 ? ws : nullptr,
      static_cast<XT*>(out), act, tau);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || k_splits == 1) return err;
  return reduce<XT>(ws, k_splits, M, N, scales, bias, out, act, tau, stream);
}

template <typename XT, int WK>
cudaError_t thin_m(int tm, const void* x, int M, int K, const void* w, int N,
                   int k_splits, int rows_per_split, const float* scales,
                   const float* bias, float* ws, void* out, int act, float tau,
                   cudaStream_t s) {
  switch (tm) {
    case 1:
      return thin_t<XT, WK, 1>(x, M, K, w, N, k_splits, rows_per_split,
                               scales, bias, ws, out, act, tau, s);
    case 8:
      return thin_t<XT, WK, 8>(x, M, K, w, N, k_splits, rows_per_split,
                               scales, bias, ws, out, act, tau, s);
    case 16:
      return thin_t<XT, WK, 16>(x, M, K, w, N, k_splits, rows_per_split,
                                scales, bias, ws, out, act, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t thin_w(int wkind, int tm, const void* x, int M, int K,
                   const void* w, int N, int k_splits, int rows_per_split,
                   const float* scales, const float* bias, float* ws,
                   void* out, int act, float tau, cudaStream_t s) {
  switch (wkind) {
    case rt::W_I8:
      return thin_m<XT, rt::W_I8>(tm, x, M, K, w, N, k_splits, rows_per_split,
                                  scales, bias, ws, out, act, tau, s);
    case rt::W_U4:
      return thin_m<XT, rt::W_U4>(tm, x, M, K, w, N, k_splits, rows_per_split,
                                  scales, bias, ws, out, act, tau, s);
    case rt::W_U2:
      return thin_m<XT, rt::W_U2>(tm, x, M, K, w, N, k_splits, rows_per_split,
                                  scales, bias, ws, out, act, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------- tensor-core route

// One CTA per (128-column tile, m_tile-row tile, K split; the last column
// tile ragged when N % 128 != 0: its missing code columns arrive as zeros
// and its missing outputs are not written): the split's steps
// of 64 codes through tc_matmul.cuh's pipeline, then either the emit
// act(acc * s + b) in bf16 (one split) or the raw f32 partial, which the
// reduce pass scales, biases and activates.  tmx / tmc: the tensor maps of
// x and of the codes (tcm::tile_maps); with CP (N % 16 == 8: a code row
// pitch TMA cannot map) the codes `w` are copied by cp.async instead.
template <int BM, int WK, bool CP>
__global__ void __launch_bounds__(tcm::NT)
    qmm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmc,
                  const uint8_t* __restrict__ w, int M, int K, int N,
                  int steps_per_split, const float* __restrict__ scales,
                  const float* __restrict__ bias, float* __restrict__ ws,
                  __nv_bfloat16* __restrict__ out, int act, float tau) {
  constexpr int R = rt::WTraits<WK>::R;
  extern __shared__ uint8_t smem_raw[];
  // the reduce kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint32_t sbase;
  uint8_t* smem = tcm::aligned_smem(smem_raw, sbase);
  const int n0 = blockIdx.x * tcm::BN, m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int s0 = split * steps_per_split;
  const int nsteps = min(steps_per_split, K / tcm::BK - s0);
  tcm::init_stages<BM, WK, CP>(sbase);
  if (threadIdx.x >= tcm::NTC) {
    tcm::produce<BM, WK, CP>(sbase, &tmx, &tmc, w, N, N, m0, n0, nsteps,
                             [&](int s, int& kx, int& crow) {
                               kx = (s0 + s) * tcm::BK;
                               crow = kx / R;
                             });
    return;
  }
  float acc[BM / 2];
  tcm::consume<BM, WK>(smem, sbase, nsteps, acc);
  if (ws != nullptr)
    tcm::emit<BM>(acc, m0, M, n0, N, nullptr, nullptr,
                  ws + (size_t)split * M * N, nullptr, act, tau);
  else
    tcm::emit<BM>(acc, m0, M, n0, N, scales, bias, nullptr, out, act, tau);
}

template <int BM, int WK, bool CP>
cudaError_t tc_t(const void* x, int M, int K, const void* w, int N,
                 int k_splits, int steps_per_split, const float* scales,
                 const float* bias, float* ws, void* out, int act, float tau,
                 cudaStream_t stream) {
  const int steps = K / tcm::BK;
  if (K % tcm::BK != 0 || N % (CP ? 8 : 16) != 0 || k_splits < 1 ||
      steps_per_split < 1 || (k_splits - 1) * steps_per_split >= steps ||
      k_splits * steps_per_split < steps || (k_splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmc;
  if (!tcm::tile_maps<BM, WK, CP>(&tmx, &tmc, x, M, K, w,
                                  K / rt::WTraits<WK>::R, N))
    return cudaErrorInvalidValue;
  constexpr int bytes = tcm::smem_bytes<BM, WK>(0);
  auto kern = qmm_tc_kernel<BM, WK, CP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + tcm::BN - 1) / tcm::BN, (M + BM - 1) / BM, k_splits);
  kern<<<grid, tcm::NT, bytes, stream>>>(
      tmx, tmc, static_cast<const uint8_t*>(w), M, K, N, steps_per_split,
      scales, bias, k_splits > 1 ? ws : nullptr,
      static_cast<__nv_bfloat16*>(out), act, tau);
  err = cudaGetLastError();
  if (err != cudaSuccess || k_splits == 1) return err;
  return tcm::reduce(ws, M, N, k_splits, nullptr, 0, 1, scales, bias, out,
                     act, tau, stream);
}

// The code load by N: TMA for a 16-byte row pitch, cp.async for N % 16 == 8.
template <int BM, int WK>
cudaError_t tc_n(const void* x, int M, int K, const void* w, int N,
                 int k_splits, int steps_per_split, const float* scales,
                 const float* bias, float* ws, void* out, int act, float tau,
                 cudaStream_t s) {
  if (N % 16 == 0)
    return tc_t<BM, WK, false>(x, M, K, w, N, k_splits, steps_per_split,
                               scales, bias, ws, out, act, tau, s);
  return tc_t<BM, WK, true>(x, M, K, w, N, k_splits, steps_per_split, scales,
                            bias, ws, out, act, tau, s);
}

template <int WK>
cudaError_t tc_m(int m_tile, const void* x, int M, int K, const void* w,
                 int N, int k_splits, int steps_per_split,
                 const float* scales, const float* bias, float* ws, void* out,
                 int act, float tau, cudaStream_t s) {
  switch (m_tile) {
    case 64:
      return tc_n<64, WK>(x, M, K, w, N, k_splits, steps_per_split, scales,
                          bias, ws, out, act, tau, s);
    case 128:
      return tc_n<128, WK>(x, M, K, w, N, k_splits, steps_per_split, scales,
                           bias, ws, out, act, tau, s);
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

// The thin-M route: M <= 16 (tm = 1, 8 or 16 rows per CTA), N % 4 == 0, w
// 4-byte aligned.  The K byte rows are cut into k_splits ranges of
// rows_per_split (the last may be shorter; rows_per_split * R <= 512 codes).
// ws: (k_splits, M, N) f32 scratch, unused when k_splits == 1.  Other
// arguments as qmm_launch.  Returns the launches' cudaError_t.
extern "C" int qmm_thin_launch(const void* x, int x_bf16, int M, int K,
                               const void* w, int wkind, int N, int k_splits,
                               int rows_per_split, const float* scales,
                               const float* bias, float* ws, void* out, int tm,
                               int act, float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)thin_w<__nv_bfloat16>(wkind, tm, x, M, K, w, N, k_splits,
                                      rows_per_split, scales, bias, ws, out,
                                      act, tau, s);
  return (int)thin_w<float>(wkind, tm, x, M, K, w, N, k_splits, rows_per_split,
                            scales, bias, ws, out, act, tau, s);
}

// The tensor-core route: bf16 x (M, K) at a 16-byte aligned address, K % 64
// == 0, N % 8 == 0 (ceil(N / 128) column tiles), w 16-byte aligned (8-byte
// when N % 16 == 8: its codes are copied by cp.async, not TMA).
// m_tile: rows per CTA (64 or 128).
// The K / 64 steps are cut into k_splits ranges of steps_per_split (the
// last may be shorter); ws: (k_splits, M, N) f32 scratch, unused when
// k_splits == 1.  out: (M, N) bf16.  Other arguments as qmm_launch.
// Returns the launches' cudaError_t.
extern "C" int qmm_tc_launch(const void* x, int M, int K, const void* w,
                             int wkind, int N, int m_tile, int k_splits,
                             int steps_per_split, const float* scales,
                             const float* bias, float* ws, void* out, int act,
                             float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wkind) {
    case rt::W_I8:
      return (int)tc_m<rt::W_I8>(m_tile, x, M, K, w, N, k_splits,
                                 steps_per_split, scales, bias, ws, out, act,
                                 tau, s);
    case rt::W_U4:
      return (int)tc_m<rt::W_U4>(m_tile, x, M, K, w, N, k_splits,
                                 steps_per_split, scales, bias, ws, out, act,
                                 tau, s);
    case rt::W_U2:
      return (int)tc_m<rt::W_U2>(m_tile, x, M, K, w, N, k_splits,
                                 steps_per_split, scales, bias, ws, out, act,
                                 tau, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
