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
// operations but latency, shared-memory traffic and the launch.  A B = 256
// forward's two convs are 0.9 us of FMAs at the f32 rate; stamped per CTA
// with clock64, a CTA spends about half its time in its prologue (chains
// of dependent global loads: the column's schedule entries, then its
// blocks) and most of the rest in its walk, where the 4 patch loads of
// each step are the shared-memory traffic.  No patch matrix exists
// anywhere: a CTA stages its images once in shared memory and gathers each
// patch value through a per-step offset table (the TPU kernel builds a
// (Ho*Wo, K) patch tile in VMEM instead).
//
// Two routes, picked by the shape rule conv_route (kernel.py):
//   * reg_tile (bsc_reg_kernel, conv_reg.cuh): a thread owns one 2 x 2
//     pooled window (or 4 unpooled positions of a row) times CT columns of
//     one column block, so 4 * CT independent FMA chains sit in registers;
//     each patch value is loaded once per step for every column, each
//     decoded weight row is a shared broadcast for every position.  A CTA
//     is one column tile of a few images: its column block's present blocks
//     are decoded (vector loads of a stored row's columns, several in
//     flight) and scaled once into a walk of weight rows that is uniform
//     across the CTA (absent blocks cost nothing); its images are staged
//     by cp.async, channel-major where there are several channels, so that
//     a warp's patch reads fall on distinct banks.  The walk is cut into K
//     parts across the CTA's warps so that a small batch's few pooled
//     windows still fill the card; part 0 adds the parts in order, then
//     bias, activation and pool run in registers and each output is stored
//     once, in vectors where the columns allow.
//   * band (bsc_kernel, conv_common.cuh), the first design, for what the
//     register tile does not cover (odd bn, pools of 3 and up, images too
//     large for one CTA): a CTA owns (image, column slice, band of conv
//     rows), accumulates (position, column) items in shared memory over
//     rounds of decoded weight rows, and pools inside the CTA.
// FMAs on the CUDA cores in f32: LeNet is f32 end to end and held to
// 1e-5 of max|ref|, which TF32 tensor cores do not keep.
#include "conv_reg.cuh"

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

// The register-tiled route: CTA (bx, by) covers images bx * img onward and
// CT columns of column block by / (bn / CT); its threads walk that column
// block's present blocks, staged as (block, row) steps.
template <typename XT, int WK, int CT>
__global__ void __launch_bounds__(rt::REG_NT)
    bsc_reg_kernel(const XT* __restrict__ x, int B, ConvGeom g,
                   rt::RegPlan pl,
                   const typename rt::WTraits<WK>::T* __restrict__ blocks,
                   int bk, int bn, const float* __restrict__ scales,
                   const float* __restrict__ bias,
                   const int* __restrict__ col_ptr,
                   const int* __restrict__ rows, const int* __restrict__ pidx,
                   XT* __restrict__ out, int N, int act, float tau) {
  using W = rt::WTraits<WK>;
  constexpr int R = W::R;
  extern __shared__ __align__(16) float reg_buf[];
  const rt::RegSmem s = rt::reg_smem(reg_buf, g, pl);
  const int n_sub = bn / CT;
  const int c = blockIdx.y / n_sub;
  const int jb = (blockIdx.y - c * n_sub) * CT;  // first column in the block
  const int n0 = c * bn + jb;
  const float2 ep = rt::reg_load_epilogue<CT>(nullptr, bias, n0, N);
  const int b0 = blockIdx.x * pl.img;
  const int nimg = min(pl.img, B - b0);
  rt::reg_stage_images(x, b0, nimg, g, pl, s);

  // the column block's present blocks in row order, decoded and scaled
  // (before the dot) into walk steps (block, row of the block); a task
  // loads G columns of one stored row at once, several tasks in flight
  const int q0 = col_ptr[c];
  const int nb = col_ptr[c + 1] - q0;  // present blocks
  const int bkp = (bk + R - 1) / R;    // stored rows per block
  using T = typename W::T;
  constexpr int G = CT < 4 ? CT : 4;
  constexpr int NG = CT / G;
  const bool vec = reinterpret_cast<uintptr_t>(blocks) % (G * sizeof(T)) == 0;
#pragma unroll 4
  for (int e = threadIdx.x; e < nb * bkp * NG; e += blockDim.x) {
    const int row = e / NG, jg = (e - row * NG) * G;
    const int bi = row / bkp, kb = row - bi * bkp;
    T v[G];
    rt::reg_load_group<T, G>(
        blocks + ((size_t)pidx[q0 + bi] * bkp + kb) * bn + jb + jg, vec, v);
    float sc[G];
#pragma unroll
    for (int gg = 0; gg < G; ++gg)
      sc[gg] = scales != nullptr ? scales[n0 + jg + gg] : 1.f;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int kr = kb * R + t;
      if (kr < bk) {
        float w[G];
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
          w[gg] = W::get(v[gg], t);
          if (scales != nullptr) w[gg] *= sc[gg];  // before the dot
        }
        rt::reg_store_group<G>(s.ws + (size_t)(bi * bk + kr) * CT + jg, w);
      }
    }
  }
  for (int st = threadIdx.x; st < nb * bk; st += blockDim.x) {
    const int bi = st / bk;
    s.koff[st] = rt::reg_koff(rows[q0 + bi] * bk + st - bi * bk, g);
  }
  rt::reg_store_epilogue<CT>(s, ep);
  rt::reg_finish_images();
  rt::reg_conv_tail<XT, CT>(g, pl, B, s, nb * bk, bk, n0, CT, N, false,
                            bias != nullptr, out, act, tau);
}

template <typename XT, int WK, int CT>
cudaError_t reg_launch_t(const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* blocks, int bk,
                         int bn, const float* scales, const float* bias,
                         const int* col_ptr, const int* rows, const int* pidx,
                         int n_col_blocks, void* out, int act, float tau,
                         cudaStream_t stream) {
  cudaError_t e = rt::reg_check<CT>(pl);
  if (e != cudaSuccess) return e;
  if (bn % CT != 0 || pl.n_ct != n_col_blocks * (bn / CT) ||
      pl.per < 1 || pl.steps % bk != 0)
    return cudaErrorInvalidValue;
  const size_t smem = rt::reg_smem_bytes(g, pl);
  auto kernel = bsc_reg_kernel<XT, WK, CT>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((B + pl.img - 1) / pl.img, pl.n_ct);
  kernel<<<grid, pl.ks * pl.part, smem, stream>>>(
      static_cast<const XT*>(x), B, g, pl,
      static_cast<const typename rt::WTraits<WK>::T*>(blocks), bk, bn,
      scales, bias, col_ptr, rows, pidx, static_cast<XT*>(out),
      n_col_blocks * bn, act, tau);
  return cudaGetLastError();
}

template <typename XT, int CT>
cudaError_t reg_launch_w(int wkind, const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* blocks, int bk,
                         int bn, const float* scales, const float* bias,
                         const int* col_ptr, const int* rows, const int* pidx,
                         int n_col_blocks, void* out, int act, float tau,
                         cudaStream_t stream) {
#define RT_W(KIND)                                                          \
  case KIND:                                                                \
    return reg_launch_t<XT, KIND, CT>(x, B, g, pl, blocks, bk, bn, scales,  \
                                      bias, col_ptr, rows, pidx,            \
                                      n_col_blocks, out, act, tau, stream);
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

template <typename XT>
cudaError_t reg_launch_c(int wkind, const void* x, int B, const ConvGeom& g,
                         const rt::RegPlan& pl, const void* blocks, int bk,
                         int bn, const float* scales, const float* bias,
                         const int* col_ptr, const int* rows, const int* pidx,
                         int n_col_blocks, void* out, int act, float tau,
                         cudaStream_t stream) {
#define RT_C(CT)                                                            \
  case CT:                                                                  \
    return reg_launch_w<XT, CT>(wkind, x, B, g, pl, blocks, bk, bn, scales, \
                                bias, col_ptr, rows, pidx, n_col_blocks, out, \
                                act, tau, stream);
  switch (pl.ct) {
    RT_C(2)
    RT_C(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef RT_C
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

// The register-tiled route (reg_tile): the arguments of bsc_launch plus
// plan, the 9 ints of ConvPlan.ints() (ct, n_ct, upr, units, img, part, ks,
// per, steps); geom's band and bns are not read.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int bsc_reg_launch(const void* x, int x_bf16, int B, int H, int W,
                              int C, const int* geom, const int* plan,
                              const void* blocks, int wkind, int bk, int bn,
                              const float* scales, const float* bias,
                              const int* col_ptr, const int* rows,
                              const int* pidx, int n_col_blocks, void* out,
                              int act, float tau, void* stream) {
  const ConvGeom g{H,       W,       C,       geom[0], geom[1],
                   geom[2], geom[3], geom[4], geom[5], geom[6],
                   geom[7], geom[8], geom[9], geom[10], geom[11]};
  const rt::RegPlan pl{plan[0], plan[1], plan[2], plan[3], plan[4],
                       plan[5], plan[6], plan[7], plan[8]};
  if (g.z != 1 && g.z != 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)reg_launch_c<__nv_bfloat16>(wkind, x, B, g, pl, blocks, bk,
                                            bn, scales, bias, col_ptr, rows,
                                            pidx, n_col_blocks, out, act, tau,
                                            s);
  return (int)reg_launch_c<float>(wkind, x, B, g, pl, blocks, bk, bn, scales,
                                  bias, col_ptr, rows, pidx, n_col_blocks, out,
                                  act, tau, s);
}
