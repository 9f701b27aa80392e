// Engine-free static block-sparse matmul: y = act(x @ W + b) over a
// block-compacted W.
//
// Replaces the Pallas kernel repro/kernels/sparse_matmul/kernel.py
// (`_call` / `_kernel` / `_kernel_packed_db`, reached through
// `block_sparse_matmul` and the thin-M `block_sparse_matmul_decode`).
//
// What it computes, as the TPU kernel does:
//   * the schedule is static: present blocks sorted by (column, row), given
//     here in CSC form (col_ptr over output column blocks, then the block-row
//     and packed-block index of every present block).  It is uploaded once
//     per pattern by the wrapper, the analogue of scalar prefetch;
//   * each block is decoded (int4x2 nibbles / int2x4 crumbs along bk), then
//     multiplied by its output column's dequant scale, BEFORE the dot;
//   * the emit applies act(acc + b) in f32; a column with no present block
//     emits act(b) from the same launch.
//
// What bounds it on the H100: bytes.  At decode shapes (M = live slots,
// a handful of rows) every weight byte is used for M FMAs, far below the
// ~295 operations per byte the card needs before compute is the limit, so
// the time floor is the packed weight stream over HBM bandwidth.  The design
// keeps that stream as small as the container allows: blocks travel in their
// packed form and are decoded in registers, never expanded in memory, and
// only present blocks are read.  Each CTA owns one (m-tile, 32-column slice of
// an output column block); its eight warps split the rows of every block, so
// the decode and the FMAs spread over 256 threads, and the partial sums are
// reduced once through shared memory.  The x rows of several of the
// column's blocks are staged in shared memory per round (32 KB), so a CTA
// waits on staging once per few blocks, not once per block.  No atomics:
// every output element is written by exactly one CTA.  Thin M is masked
// (rows >= M read as zero and are never written) instead of padded.  This
// is the simple form: the FMAs run on the CUDA cores, with no wgmma, TMA
// or software pipeline yet.
#include "common.cuh"

namespace {

constexpr int BN_T = 32;         // output columns per CTA (one per lane)
constexpr int KG = 8;            // warps per CTA, each taking every KG-th row
constexpr int NT = BN_T * KG;    // threads per CTA
constexpr int XS = 8192;         // floats of x staged per round (32 KB)

template <typename XT, int WK, int TM>
__global__ void __launch_bounds__(NT)
    bsm_kernel(const XT* __restrict__ x, int M, int K,
               const typename rt::WTraits<WK>::T* __restrict__ blocks, int bk,
               int bn, const float* __restrict__ scales,
               const float* __restrict__ bias, const int* __restrict__ col_ptr,
               const int* __restrict__ rows, const int* __restrict__ pidx,
               int n_sub, XT* __restrict__ out, int N, int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  constexpr int KCAP = XS / TM;  // x columns per staged row
  __shared__ float xs[XS];       // xs[mm * KCAP + col]; reused for the reduction

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BN_T + tx;
  const int c = blockIdx.x / n_sub;
  const int jbase = (blockIdx.x % n_sub) * BN_T;
  const int j = jbase + tx;  // column inside the block
  const bool jv = j < bn;
  const int m0 = blockIdx.y * TM;
  const float s = (scales != nullptr && jv) ? scales[c * bn + j] : 1.f;
  const int bkp = bk / R;  // stored rows per block

  float acc[TM];
#pragma unroll
  for (int mm = 0; mm < TM; ++mm) acc[mm] = 0.f;

  // Rounds: up to `nb_max` of the column's blocks at a time (or one chunk
  // of `kch` rows of a block taller than KCAP), their x rows staged once.
  const int q0 = col_ptr[c], q1 = col_ptr[c + 1];
  const int kch = min(bk, KCAP);
  const int nb_max = max(1, KCAP / kch);
  for (int qb = q0; qb < q1; qb += nb_max) {
    const int nb = min(nb_max, q1 - qb);
    for (int kk = 0; kk < bk; kk += kch) {
      const int kc = min(kch, bk - kk);
      const int span = nb * kc;
      __syncthreads();
      for (int e = tid; e < TM * span; e += NT) {
        const int mm = e / span, rem = e - mm * span;
        const int b = rem / kc, t = rem - b * kc;
        const int m = m0 + mm;
        xs[mm * KCAP + rem] =
            m < M ? rt::to_f32(x[(size_t)m * K + (size_t)rows[qb + b] * bk + kk + t])
                  : 0.f;
      }
      __syncthreads();
      if (jv) {
        const int kr = kc / R;
        for (int b = 0; b < nb; ++b) {
          const typename W::T* blk =
              blocks + ((size_t)pidx[qb + b] * bkp + kk / R) * bn + j;
          const float* xb = xs + b * kc;
#pragma unroll 4
          for (int br = ty; br < kr; br += KG) {
            const typename W::T v = blk[(size_t)br * bn];
#pragma unroll
            for (int t = 0; t < R; ++t) {
              const float w = W::get(v, t) * s;  // dequant before the dot
              const int k = br * R + t;
#pragma unroll
              for (int mm = 0; mm < TM; ++mm)
                acc[mm] = fmaf(xb[mm * KCAP + k], w, acc[mm]);
            }
          }
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
    const int m = m0 + mm, jj = jbase + jx;
    if (m < M && jj < bn) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) v += red[(g * TM + mm) * BN_T + jx];
      const int n = c * bn + jj;
      if (bias != nullptr) v += bias[n];
      out[(size_t)m * N + n] = rt::from_f32<XT>(rt::apply_act(v, act, tau));
    }
  }
}

template <typename XT, int WK, int TM>
cudaError_t launch_t(const void* x, int M, int K, const void* blocks, int bk,
                     int bn, const float* scales, const float* bias,
                     const int* col_ptr, const int* rows, const int* pidx,
                     int n_col_blocks, void* out, int act, float tau,
                     cudaStream_t stream) {
  const int n_sub = (bn + BN_T - 1) / BN_T;
  dim3 grid(n_col_blocks * n_sub, (M + TM - 1) / TM);
  dim3 block(BN_T, KG);
  bsm_kernel<XT, WK, TM><<<grid, block, 0, stream>>>(
      static_cast<const XT*>(x), M, K,
      static_cast<const typename rt::WTraits<WK>::T*>(blocks), bk, bn, scales,
      bias, col_ptr, rows, pidx, n_sub, static_cast<XT*>(out),
      n_col_blocks * bn, act, tau);
  return cudaGetLastError();
}

template <typename XT, int WK>
cudaError_t launch_m(int tm, const void* x, int M, int K, const void* blocks,
                     int bk, int bn, const float* scales, const float* bias,
                     const int* col_ptr, const int* rows, const int* pidx,
                     int n_col_blocks, void* out, int act, float tau,
                     cudaStream_t stream) {
  switch (tm) {
    case 1:
      return launch_t<XT, WK, 1>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                                 rows, pidx, n_col_blocks, out, act, tau, stream);
    case 8:
      return launch_t<XT, WK, 8>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                                 rows, pidx, n_col_blocks, out, act, tau, stream);
    case 16:
      return launch_t<XT, WK, 16>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                                  rows, pidx, n_col_blocks, out, act, tau, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t launch_w(int wkind, int tm, const void* x, int M, int K,
                     const void* blocks, int bk, int bn, const float* scales,
                     const float* bias, const int* col_ptr, const int* rows,
                     const int* pidx, int n_col_blocks, void* out, int act,
                     float tau, cudaStream_t stream) {
#define RT_W(KIND)                                                              \
  case KIND:                                                                    \
    return launch_m<XT, KIND>(tm, x, M, K, blocks, bk, bn, scales, bias,        \
                              col_ptr, rows, pidx, n_col_blocks, out, act, tau, \
                              stream);
  switch (wkind) {
    RT_W(rt::W_F32)
    RT_W(rt::W_BF16)
    RT_W(rt::W_I8)
    RT_W(rt::W_U4)
    RT_W(rt::W_U2)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_W
}

}  // namespace

// x: (M, K) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), row-major; out: (M, N)
// of the same type.  blocks: (P, bk / R, bn) of the `wkind` container.
// scales / bias: (N,) f32 or null.  col_ptr: (n_col_blocks + 1,) int32;
// rows / pidx: (P,) int32 in schedule order.  tm: rows per CTA (1, 8, 16).
// Returns the launch's cudaError_t (0 on success).
extern "C" int bsm_launch(const void* x, int x_bf16, int M, int K,
                          const void* blocks, int wkind, int bk, int bn,
                          const float* scales, const float* bias,
                          const int* col_ptr, const int* rows, const int* pidx,
                          int n_col_blocks, void* out, int tm, int act,
                          float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_w<__nv_bfloat16>(wkind, tm, x, M, K, blocks, bk, bn,
                                        scales, bias, col_ptr, rows, pidx,
                                        n_col_blocks, out, act, tau, s);
  return (int)launch_w<float>(wkind, tm, x, M, K, blocks, bk, bn, scales, bias,
                              col_ptr, rows, pidx, n_col_blocks, out, act, tau,
                              s);
}
