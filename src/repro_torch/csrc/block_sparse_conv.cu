// Fused block-sparse convolution: y = pool(act(conv(x, W) + b)) in one
// launch, W the block-compacted im2col weight of a (kh, kw, cin, cout) conv.
//
// Replaces the Pallas kernel repro/kernels/sparse_matmul/kernel.py
// (`_conv_call` / `_conv_kernel` with `_im2col_tile` and `_pool_tile`,
// reached through `block_sparse_conv`).
//
// What it computes, as the TPU kernel does:
//   * the input is NHWC and already padded (VALID geometry); strides and
//     dilation are runtime arguments of the patch gather;
//   * the schedule is the block-sparse matmul's CSC schedule: each output
//     column block walks its present blocks in row order, no atomics;
//   * each block row is decoded (int8, int4x2 nibbles or int2x4 crumbs
//     along bk) and multiplied by its column's dequant scale BEFORE the dot;
//   * the emit applies act(acc + b) in f32, then the non-overlapping z x z
//     pool (avg: sum, then divide by z^2; max), and writes (B, Ho/z, Wo/z, N);
//   * a column with no present block emits act(b) from the same launch.
//
// What bounds it on the H100: at LeNet's shapes, neither bytes nor
// operations but latency and launch overhead.  Per image the input is a
// few KB and the work a few tens of thousands of FMAs (K = 25..150, N =
// 6..16), far from both HBM bandwidth and the f32 rate, so the design keeps
// every step on chip: the TPU kernel builds a (Ho*Wo, K) patch tile in VMEM;
// here a CTA stages its image band once in shared memory (3.1 KB for
// conv1, 3.4 KB for conv2) and gathers each patch value from it through a
// per-row offset table, so no patch matrix exists anywhere.  A CTA owns
// (image, output column slice, band of conv rows): its 256 threads each take
// (output position, column) items, accumulate in shared memory across
// rounds of decoded weight rows (up to 8 KB per round, so one round at
// LeNet's shapes), and pool inside the CTA before the one store.  This is
// the simple form: FMAs on the CUDA cores in f32, no tensor cores.
#include "conv_common.cuh"

namespace {

using rt::CONV_NT;
using rt::ConvGeom;
using rt::ConvSmem;

template <typename XT, int WK>
__global__ void __launch_bounds__(CONV_NT)
    bsc_kernel(const XT* __restrict__ x, ConvGeom g,
               const typename rt::WTraits<WK>::T* __restrict__ blocks, int bk,
               int bn, int n_sub, const float* __restrict__ scales,
               const float* __restrict__ bias, const int* __restrict__ col_ptr,
               const int* __restrict__ rows, const int* __restrict__ pidx,
               XT* __restrict__ out, int N, int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  extern __shared__ float smem[];
  const ConvSmem s = rt::conv_smem(smem, g);

  const int b = blockIdx.x;
  const int c = blockIdx.y / n_sub;
  const int jbase = (blockIdx.y % n_sub) * g.bns;
  const int nj = min(g.bns, bn - jbase);
  const int r0 = blockIdx.z * g.band;
  const int nr = min(g.band, g.Ho - r0);
  const int bkp = (bk + R - 1) / R;  // stored rows per block

  rt::conv_stage_image(x, b, r0, nr, g, s);

  // Rounds: up to nb_max of the column's blocks (or a chunk of kch rows of
  // a block taller than one round), decoded and scaled once per CTA.
  const int q0 = col_ptr[c], q1 = col_ptr[c + 1];
  const int kch = min(bk, s.kcap);
  const int nb_max = max(1, s.kcap / kch);
  for (int qb = q0; qb < q1; qb += nb_max) {
    const int nb = min(nb_max, q1 - qb);
    for (int kk = 0; kk < bk; kk += kch) {
      const int kc = min(kch, bk - kk);
      const int nrows = nb * kc;
      __syncthreads();  // the previous round's rows are consumed
      for (int e = threadIdx.x; e < nrows * nj; e += CONV_NT) {
        const int row = e / nj, j = e - row * nj;
        const int bi = row / kc, kr = kk + row - bi * kc;
        const typename W::T* blk = blocks + (size_t)pidx[qb + bi] * bkp * bn;
        float w = W::get(blk[(size_t)(kr / R) * bn + jbase + j], kr % R);
        if (scales != nullptr) w *= scales[c * bn + jbase + j];  // before the dot
        s.ws[row * g.bns + j] = w;
      }
      for (int row = threadIdx.x; row < nrows; row += CONV_NT) {
        const int bi = row / kc;
        s.koff[row] = rt::conv_koff(rows[qb + bi] * bk + kk + row - bi * kc, g);
      }
      __syncthreads();
      rt::conv_accumulate(nr, nj, nrows, g, s);
    }
  }

  __syncthreads();
  for (int e = threadIdx.x; e < nr * g.Wo * nj; e += CONV_NT) {
    const int p = e / nj, j = e - p * nj;
    float v = s.acc[p * g.bns + j];
    if (bias != nullptr) v += bias[c * bn + jbase + j];
    s.acc[p * g.bns + j] = rt::apply_act(v, act, tau);
  }
  __syncthreads();
  rt::conv_pool_store(out, b, r0, nr, nj, c * bn + jbase, N, g, s);
}

template <typename XT, int WK>
cudaError_t launch_t(const void* x, int B, const ConvGeom& g,
                     const void* blocks, int bk, int bn, const float* scales,
                     const float* bias, const int* col_ptr, const int* rows,
                     const int* pidx, int n_col_blocks, void* out, int act,
                     float tau, cudaStream_t stream) {
  const int n_sub = (bn + g.bns - 1) / g.bns;
  const int n_band = (g.Ho + g.band - 1) / g.band;
  const size_t smem = rt::conv_smem_bytes(g);
  auto kernel = bsc_kernel<XT, WK>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, n_col_blocks * n_sub, n_band);
  kernel<<<grid, CONV_NT, smem, stream>>>(
      static_cast<const XT*>(x), g,
      static_cast<const typename rt::WTraits<WK>::T*>(blocks), bk, bn, n_sub,
      scales, bias, col_ptr, rows, pidx, static_cast<XT*>(out),
      n_col_blocks * bn, act, tau);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_w(int wkind, const void* x, int B, const ConvGeom& g,
                     const void* blocks, int bk, int bn, const float* scales,
                     const float* bias, const int* col_ptr, const int* rows,
                     const int* pidx, int n_col_blocks, void* out, int act,
                     float tau, cudaStream_t stream) {
#define RT_W(KIND)                                                           \
  case KIND:                                                                 \
    return launch_t<XT, KIND>(x, B, g, blocks, bk, bn, scales, bias, col_ptr, \
                              rows, pidx, n_col_blocks, out, act, tau, stream);
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

// x: (B, H, W, C) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), padded NHWC;
// out: (B, Ho / z, Wo / z, n_col_blocks * bn) of the same type.  geom:
// kh, kw, sh, sw, dh, dw, Ho, Wo, z, pool_max, band, bns (12 ints).
// blocks: (P, ceil(bk / R), bn) of the `wkind` container, packed along bk.
// scales / bias: (N,) f32 or null.  col_ptr: (n_col_blocks + 1,) int32;
// rows / pidx: (P,) int32 in schedule order.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int bsc_launch(const void* x, int x_bf16, int B, int H, int W,
                          int C, const int* geom, const void* blocks,
                          int wkind, int bk, int bn, const float* scales,
                          const float* bias, const int* col_ptr,
                          const int* rows, const int* pidx, int n_col_blocks,
                          void* out, int act, float tau, void* stream) {
  const ConvGeom g{H,       W,       C,       geom[0], geom[1],
                   geom[2], geom[3], geom[4], geom[5], geom[6],
                   geom[7], geom[8], geom[9], geom[10], geom[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)launch_w<__nv_bfloat16>(wkind, x, B, g, blocks, bk, bn, scales,
                                        bias, col_ptr, rows, pidx,
                                        n_col_blocks, out, act, tau, s);
  return (int)launch_w<float>(wkind, x, B, g, blocks, bk, bn, scales, bias,
                              col_ptr, rows, pidx, n_col_blocks, out, act, tau,
                              s);
}
