// Engine-free static block-sparse matmul: y = act(x @ W + b) over a
// block-compacted W.  Three kernels, one per route of `bsm_route` in
// kernels/sparse_matmul/kernel.py: the thin-M kernel for decode rows
// (M <= 16; 1-byte containers: int8, int4x2, int2x4; and f32 and bf16
// blocks, as actsparse and the float sparse path store them); the
// tensor-core kernel for bf16 x past 16 rows (the compiled full-sequence
// forward, wide prefill chunks) over the same containers with bk % 64 ==
// 0, bn % 128 == 0 and 16-byte aligned operands; and the tiled kernel, the
// first design on the CUDA cores, for everything else (f32 x past 16 rows,
// LeNet's small blocks).
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
//     multiplied by its output column's dequant scale, BEFORE the dot (the
//     CUDA-core routes keep that order; the tensor-core route applies the
//     scale at emit instead: it is constant along K, so x . (codes * s) =
//     (x . codes) * s, and the two differ only in f32 rounding);
//   * the emit applies act(acc + b) in f32; a column with no present block
//     emits act(b) from the same launch.
//
// What bounds it on the H100: bytes at decode shapes, operations at the
// full-sequence forward's M = 512.  At decode shapes (M = live slots, a
// handful of rows) every weight byte is used for M FMAs, far below the
// ~295 operations per byte the card needs before compute is the limit, so
// the time floor is the packed weight stream over HBM bandwidth.  Blocks
// travel in their packed form and are decoded in registers, never expanded
// in memory, and only present blocks are read.  No atomics: every partial
// and every output element is written by exactly one CTA.  Thin M is masked
// (rows >= M read as zero and are never written) instead of padded.
//
// The thin-M kernel (`bsm_thin_kernel`) keeps enough of that stream in
// flight to approach the floor.  Each output column block's run of schedule
// entries is cut into ranges of `blocks_per_range` blocks (one, unless the
// grid would pass 8 x 132 CTAs); a CTA owns one range and 128 columns and
// first copies the range's block indices into shared memory, so no weight
// load waits on an index load.  Each lane loads its 4 columns of a block's
// stored row in one load (4 bytes of a 1-byte container, 8 of bf16, 16 of
// f32 blocks), so a warp reads a 128-, 256- or 512-byte line; its 4 warps
// take interleaved stored rows of the range, 16 loads in flight per lane (the
// first batch while the range's x rows are staged in shared memory with
// 16-byte loads, as [k][m], so one 16-byte shared load feeds 16 FMAs).
// Each CTA sums its warps in shared memory and writes an f32 partial per
// range; a second kernel (`bsm_reduce_kernel`, a programmatic dependent
// launch) adds a column's partials in range order, the same order on every
// run, then applies bias and activation once, and emits act(b) for columns
// with no block.
//
// The tensor-core kernel (`bsm_tc_kernel`) runs tc_matmul.cuh's pipeline
// over each column's present blocks: 64 or 128 rows by 128 columns of an
// output column block per CTA, each block bk / 64 steps whose x tile is the
// rectangle at (m0, row block * bk), the codes decoded to exact bf16 in
// registers as wgmma's A operand of the transposed product, f32
// accumulators.  bf16 blocks are their own A operand; f32 blocks come as
// four 32-column TMA boxes a step (a 32 KB code tile), each weight split
// into two bf16 terms whose products add into the same accumulators (the
// weight to 2^-16: kernels/sparse_matmul/ref.py `split_bf16`), the sum
// promoted to registers every step; one CTA an SM with 4 stages (bf16: two
// CTAs, 4 or 3 stages).  f32 blocks take 128-row tiles past 64 rows.  When the tiles alone
// are far from one wave of the card (one CTA per SM), each column's blocks
// are cut into ranges, whose scaled f32 partials `tcm::reduce_kernel` adds
// in range order.
//
// The tiled kernel (`bsm_kernel`) owns one (m-tile, 32-column slice of an
// output column block) per CTA; its eight warps split the rows of every
// block, one element per lane per load, and the partial sums are reduced
// once through shared memory.  The x rows of several of the column's
// blocks are staged in shared memory per round (32 KB).  Its FMAs run on
// the CUDA cores, with no wgmma, TMA or software pipeline yet.
#include "common.cuh"
#include "tc_matmul.cuh"

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

// ------------------------------------------------------------ thin-M route

namespace {

constexpr int TN_COLS = 128;              // output columns per CTA
constexpr int TN_WARPS = 4;               // warps per CTA, interleaved rows
constexpr int TN_NT = 32 * TN_WARPS;
constexpr int TN_U = 16;                  // byte rows in flight per lane
constexpr int TN_XCAP = 16384;            // floats of x staged per range

// Code `t` of each of the 4 bytes of a word, as floats: one mask and XOR
// turn the four fields into code + 2^(bits-1), and a byte permute places
// each in the mantissa of 2^23.
template <int BITS>
__device__ __forceinline__ void codes4(uint32_t word, int t, float (&c)[4]) {
  constexpr uint32_t MASK = (1u << BITS) - 1u, SIGN = 1u << (BITS - 1);
  const uint32_t v = ((word >> (BITS * t)) & (MASK * 0x01010101u)) ^
                     (SIGN * 0x01010101u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u + i)) -
           (8388608.f + (float)SIGN);
}

// A lane's 4 columns of one stored row: 4 bytes of a 1-byte container, 8
// of bf16 blocks, 16 of f32 blocks.
template <int WK>
struct Row4 {
  using T = uint32_t;
};
template <>
struct Row4<rt::W_BF16> {
  using T = uint2;
};
template <>
struct Row4<rt::W_F32> {
  using T = uint4;
};

// Weight `t` of each of the lane's 4 columns, as floats: decoded codes, or
// the f32 / bf16 weights themselves (t = 0).
template <int WK>
__device__ __forceinline__ void weights4(const typename Row4<WK>::T& v, int t,
                                         float (&c)[4]) {
  if constexpr (WK == rt::W_F32) {
    c[0] = __uint_as_float(v.x);
    c[1] = __uint_as_float(v.y);
    c[2] = __uint_as_float(v.z);
    c[3] = __uint_as_float(v.w);
  } else if constexpr (WK == rt::W_BF16) {
    c[0] = __uint_as_float(v.x << 16);
    c[1] = __uint_as_float(v.x & 0xFFFF0000u);
    c[2] = __uint_as_float(v.y << 16);
    c[3] = __uint_as_float(v.y & 0xFFFF0000u);
  } else {
    codes4<8 / rt::WTraits<WK>::R>(v, t, c);
  }
}

// 4-byte slots of a range's block metadata, rounded to keep x 16-byte aligned
__host__ __device__ inline int meta_floats(int per_range) {
  return (2 * per_range + 3) & ~3;
}

// Registers: at TM <= 8 the kernel may take what it needs (116 at TM 8,
// no spills); at TM 16 it is held to 128 so that four CTAs share an SM, or
// for f32 / bf16 blocks (2 or 4 times the bytes in flight) to 255, two
// CTAs an SM.
template <typename XT, int WK, int TM>
__global__ void __launch_bounds__(
    TN_NT, TM >= 16 ? (sizeof(typename Row4<WK>::T) > 4 ? 2 : 4) : 1)
    bsm_thin_kernel(const XT* __restrict__ x, int M, int K,
                    const uint8_t* __restrict__ blocks, int bk, int bn,
                    const float* __restrict__ scales,
                    const int* __restrict__ col_ptr,
                    const int* __restrict__ rows, const int* __restrict__ pidx,
                    int n_sub, int per_range, int xvec, float* __restrict__ ws,
                    int N) {
  constexpr int R = rt::WTraits<WK>::R;
  constexpr int E = (int)sizeof(typename rt::WTraits<WK>::T);
  using V = typename Row4<WK>::T;
  // meta: the range's packed-block indices, then their row blocks; then
  // xs[(b * bk + k) * TM + m] for the range's blocks, reused for the warps'
  // reduction
  extern __shared__ __align__(16) float smem[];
  int* meta = reinterpret_cast<int*>(smem);
  float* xs = smem + meta_floats(per_range);

  // the reduce kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x / n_sub;
  const int jbase = (blockIdx.x % n_sub) * TN_COLS;
  const int range = blockIdx.y;
  const int q0 = col_ptr[c] + range * per_range;
  const int q1 = min(q0 + per_range, col_ptr[c + 1]);
  if (q0 >= q1) return;  // past this column's blocks: nothing to add
  const int nb = q1 - q0;
  for (int b = tid; b < nb; b += TN_NT) {
    meta[b] = pidx[q0 + b];
    meta[per_range + b] = rows[q0 + b];
  }
  const int bkp = bk / R;
  const int total = nb * bkp;  // byte rows of the range
  // bn % 4 == 0: a lane's 4 columns are all in or all out; lanes out of bn
  // load nothing and add zeros
  const int j = jbase + 4 * lane;
  const bool jv = j < bn;
  float sj[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sj[i] = (scales != nullptr && jv) ? scales[c * bn + j + i] : 1.f;
  constexpr int STEP = TN_WARPS * TN_U;  // byte rows of one batch of a CTA
  __syncthreads();  // meta

  // this lane's stored rows r + TN_WARPS * u of one batch, as words (its 4
  // columns: 4, 8 or 16 bytes); stored row rr is row br of the range's
  // block b
  auto load = [&](V(&word)[TN_U], int r) {
    int b = r / bkp, br = r - b * bkp;
#pragma unroll
    for (int u = 0; u < TN_U; ++u) {
      V v{};
      if (r + u * TN_WARPS < total && jv)
        v = __ldg(reinterpret_cast<const V*>(
            blocks + (((size_t)meta[b] * bkp + br) * bn + j) * E));
      word[u] = v;
      for (br += TN_WARPS; br >= bkp; br -= bkp) ++b;
    }
  };
  V next[TN_U];
  load(next, warp);  // the first batch flies while x is staged

  // x rows of the range's blocks -> xs, rows M .. TM - 1 zero; neighbouring
  // lanes take neighbouring rows m, so their stores hit distinct banks
  if (xvec) {
    constexpr int V = 16 / sizeof(XT);
    const int nv = bk / V;  // vectors per block row
    for (int e = tid; e < TM * nb * nv; e += TN_NT) {
      const int mm = e % TM, rem = e / TM;
      const int b = rem / nv, kv = (rem - b * nv) * V;
      float v[V];
      if (mm < M) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            x + (size_t)mm * K + (size_t)meta[per_range + b] * bk + kv);
        const XT* xv = reinterpret_cast<const XT*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = rt::to_f32(xv[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) xs[(b * bk + kv + i) * TM + mm] = v[i];
    }
  } else {
    for (int e = tid; e < TM * nb * bk; e += TN_NT) {
      const int mm = e % TM, rem = e / TM;
      const int b = rem / bk, k = rem - b * bk;
      xs[rem * TM + mm] =
          mm < M ? rt::to_f32(x[(size_t)mm * K + (size_t)meta[per_range + b] * bk + k])
                 : 0.f;
    }
  }
  __syncthreads();

  float acc[4][TM];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int mm = 0; mm < TM; ++mm) acc[i][mm] = 0.f;

  for (int r = warp; r < total; r += STEP) {
    V word[TN_U];
#pragma unroll
    for (int u = 0; u < TN_U; ++u) word[u] = next[u];
    if (r + STEP < total) load(next, r + STEP);  // the next batch flies now
#pragma unroll
    for (int u = 0; u < TN_U; ++u) {
      const int rr = r + u * TN_WARPS;
      if (rr < total) {
        // the range's x rows are staged block after block: byte row rr's
        // R codes meet x rows rr * R .. rr * R + R - 1
        const float* xk = xs + rr * R * TM;
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
          float code[4];
          weights4<WK>(word[u], t, code);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float w = code[i] * sj[i];  // dequant before the dot
#pragma unroll
            for (int mm = 0; mm < TM; ++mm)
              acc[i][mm] = fmaf(xv[mm], w, acc[i][mm]);
          }
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
    const int jj = jbase + jx;
    if (mm >= M || jj >= bn) continue;
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < TN_WARPS; ++g) a += red[(g * TM + mm) * TN_COLS + jx];
    ws[((size_t)range * M + mm) * N + c * bn + jj] = a;
  }
}

// out[m, n] = act(sum over the ranges of n's column block of ws[s, m, n] +
// b), the ranges added in order; a column block with no present block
// emits act(b).  One thread per output element.  Launched as a programmatic
// dependent of the thin-M kernel: its CTAs may start early and wait here
// for that grid's end.
template <typename XT>
__global__ void __launch_bounds__(256)
    bsm_reduce_kernel(const float* __restrict__ ws, int M, int N, int bn,
                      const int* __restrict__ col_ptr, int per_range,
                      const float* __restrict__ bias, XT* __restrict__ out,
                      int act, float tau) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int n = i % N, c = n / bn;
  const int nr = (col_ptr[c + 1] - col_ptr[c] + per_range - 1) / per_range;
  const size_t stride = (size_t)M * N;
  float a = 0.f;
  for (int sp = 0; sp < nr; ++sp) a += ws[sp * stride + i];
  if (bias != nullptr) a += bias[n];
  out[i] = rt::from_f32<XT>(rt::apply_act(a, act, tau));
}

// The reduce pass over each column's range partials; with `pdl` a
// programmatic dependent of the kernel launched just before it.
template <typename XT>
cudaError_t reduce(const float* ws, int M, int N, int bn, const int* col_ptr,
                   int per_range, const float* bias, void* out, int act,
                   float tau, cudaStream_t stream, bool pdl) {
  return rt::launch_dependent(bsm_reduce_kernel<XT>, dim3((M * N + 255) / 256),
                              dim3(256), stream, pdl, ws, M, N, bn, col_ptr,
                              per_range, bias, static_cast<XT*>(out), act,
                              tau);
}

template <typename XT, int WK, int TM>
cudaError_t thin_t(const void* x, int M, int K, const void* blocks, int bk,
                   int bn, const float* scales, const float* bias,
                   const int* col_ptr, const int* rows, const int* pidx,
                   int n_col_blocks, int ranges, int per_range, float* ws,
                   void* out, int act, float tau, cudaStream_t stream) {
  constexpr int R = rt::WTraits<WK>::R;
  const int N = n_col_blocks * bn;
  const size_t stage = (size_t)per_range * bk * TM;
  if (bn % 4 != 0 || bk % R != 0 || per_range < 1 || stage > TN_XCAP ||
      M > TM)
    return cudaErrorInvalidValue;
  if (ranges > 0) {
    const int n_sub = (bn + TN_COLS - 1) / TN_COLS;
    const size_t red = (size_t)TN_WARPS * TM * TN_COLS;
    const int bytes = (int)(sizeof(float) * (meta_floats(per_range) +
                                             (stage > red ? stage : red)));
    auto kern = bsm_thin_kernel<XT, WK, TM>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    constexpr int V = 16 / sizeof(XT);
    const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % V == 0 &&
                     bk % V == 0;
    kern<<<dim3(n_col_blocks * n_sub, ranges), TN_NT, bytes, stream>>>(
        static_cast<const XT*>(x), M, K, static_cast<const uint8_t*>(blocks),
        bk, bn, scales, col_ptr, rows, pidx, n_sub, per_range, xvec, ws, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return reduce<XT>(ws, M, N, bn, col_ptr, per_range, bias, out, act, tau,
                    stream, ranges > 0);
}

template <typename XT, int WK>
cudaError_t thin_m(int tm, const void* x, int M, int K, const void* blocks,
                   int bk, int bn, const float* scales, const float* bias,
                   const int* col_ptr, const int* rows, const int* pidx,
                   int n_col_blocks, int ranges, int per_range, float* ws,
                   void* out, int act, float tau, cudaStream_t s) {
  switch (tm) {
    case 1:
      return thin_t<XT, WK, 1>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                               rows, pidx, n_col_blocks, ranges, per_range, ws,
                               out, act, tau, s);
    case 8:
      return thin_t<XT, WK, 8>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                               rows, pidx, n_col_blocks, ranges, per_range, ws,
                               out, act, tau, s);
    case 16:
      return thin_t<XT, WK, 16>(x, M, K, blocks, bk, bn, scales, bias, col_ptr,
                                rows, pidx, n_col_blocks, ranges, per_range,
                                ws, out, act, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename XT>
cudaError_t thin_w(int wkind, int tm, const void* x, int M, int K,
                   const void* blocks, int bk, int bn, const float* scales,
                   const float* bias, const int* col_ptr, const int* rows,
                   const int* pidx, int n_col_blocks, int ranges,
                   int per_range, float* ws, void* out, int act, float tau,
                   cudaStream_t s) {
#define RT_W(KIND)                                                             \
  case KIND:                                                                   \
    return thin_m<XT, KIND>(tm, x, M, K, blocks, bk, bn, scales, bias,         \
                            col_ptr, rows, pidx, n_col_blocks, ranges,         \
                            per_range, ws, out, act, tau, s);
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

// ------------------------------------------------------- tensor-core route

// One CTA per (128-column slice of an output column block, m_tile-row tile,
// range of per_range of the column's blocks): each block is bk / 64 steps
// through tc_matmul.cuh's pipeline, its x tile at its row block.  The
// range's block metadata is staged in shared memory first, so no copy waits
// on an index load.  Scale at emit: with one range per column the CTA emits
// act(acc * s + b) in bf16 (acc = 0 for a column with no block: act(b));
// with several, each live range writes acc * s in f32 and the reduce pass
// adds them in range order, then bias and activation.  tmx / tmb: the
// tensor maps of x and of the block stack as (P * bk / R, bn) bytes.
template <int BM, int WK>
__global__ void __launch_bounds__(tcm::NT)
    bsm_tc_kernel(const __grid_constant__ CUtensorMap tmx,
                  const __grid_constant__ CUtensorMap tmb, int M, int K,
                  int bk, int bn, const float* __restrict__ scales,
                  const float* __restrict__ bias,
                  const int* __restrict__ col_ptr,
                  const int* __restrict__ rows, const int* __restrict__ pidx,
                  const int* __restrict__ col_order, int n_sub, int per_range,
                  float* __restrict__ ws, __nv_bfloat16* __restrict__ out,
                  int N, int act, float tau) {
  constexpr int R = rt::WTraits<WK>::R;
  extern __shared__ uint8_t smem_raw[];
  // the reduce kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  uint32_t sbase;
  uint8_t* smem = tcm::aligned_smem(smem_raw, sbase);
  // blockIdx.x walks the m tiles, blockIdx.y the columns fullest first
  const int c = col_order[blockIdx.y / n_sub];
  const int jbase = (blockIdx.y % n_sub) * tcm::BN;
  const int m0 = blockIdx.x * BM, range = blockIdx.z;
  const int q0 = col_ptr[c] + range * per_range;
  const int q1 = min(q0 + per_range, col_ptr[c + 1]);
  if (ws != nullptr && q0 >= q1) return;  // past this column's blocks
  const int nb = max(q1 - q0, 0);
  // meta: each block's first x column, then its first code byte row
  int* meta = reinterpret_cast<int*>(smem + tcm::tile_bytes<BM, WK>());
  for (int b = threadIdx.x; b < nb; b += tcm::NT) {
    meta[b] = rows[q0 + b] * bk;
    meta[per_range + b] = pidx[q0 + b] * (bk / R);
  }
  tcm::init_stages<BM, WK>(sbase);  // also publishes meta
  const int spb = bk / tcm::BK;  // steps per block
  if (threadIdx.x >= tcm::NTC) {
    tcm::produce<BM, WK, false>(sbase, &tmx, &tmb, nullptr, 0, 0, m0,
                                jbase, nb * spb,
                                [&](int s, int& kx, int& crow) {
                                  const int b = s / spb;
                                  const int kk = (s - b * spb) * tcm::BK;
                                  kx = meta[b] + kk;
                                  crow = meta[per_range + b] + kk / R;
                                });
    return;
  }
  float acc[BM / 2];
  tcm::consume<BM, WK>(smem, sbase, nb * spb, acc);
  const int n0 = c * bn + jbase;
  if (ws != nullptr)
    tcm::emit<BM>(acc, m0, M, n0, N, scales, nullptr,
                  ws + (size_t)range * M * N, nullptr, act, tau);
  else
    tcm::emit<BM>(acc, m0, M, n0, N, scales, bias, nullptr, out, act, tau);
}

template <int BM, int WK>
cudaError_t tc_t(const void* x, int M, int K, const void* blocks,
                 int n_blocks, int bk, int bn, const float* scales,
                 const float* bias, const int* col_ptr, const int* rows,
                 const int* pidx, const int* col_order, int n_col_blocks,
                 int ranges, int per_range, float* ws, void* out, int act,
                 float tau, cudaStream_t stream) {
  const int N = n_col_blocks * bn;
  if (bk % tcm::BK != 0 || bn % tcm::BN != 0 || ranges < 1 ||
      per_range < 1 || (ranges > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  CUtensorMap tmx, tmb;
  if (!tcm::tile_maps<BM, WK>(&tmx, &tmb, x, M, K, blocks,
                              (uint64_t)n_blocks * (bk / rt::WTraits<WK>::R),
                              bn))
    return cudaErrorInvalidValue;
  const int bytes = tcm::smem_bytes<BM, WK>(8 * per_range);
  auto kern = bsm_tc_kernel<BM, WK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int n_sub = bn / tcm::BN;
  const dim3 grid((M + BM - 1) / BM, n_col_blocks * n_sub, ranges);
  kern<<<grid, tcm::NT, bytes, stream>>>(
      tmx, tmb, M, K, bk, bn, scales, bias, col_ptr, rows, pidx, col_order,
      n_sub, per_range, ranges > 1 ? ws : nullptr,
      static_cast<__nv_bfloat16*>(out), N, act, tau);
  err = cudaGetLastError();
  if (err != cudaSuccess || ranges == 1) return err;
  return tcm::reduce(ws, M, N, 0, col_ptr, bn, per_range, nullptr, bias, out,
                     act, tau, stream);
}

template <int WK>
cudaError_t tc_m(int m_tile, const void* x, int M, int K, const void* blocks,
                 int n_blocks, int bk, int bn, const float* scales,
                 const float* bias, const int* col_ptr, const int* rows,
                 const int* pidx, const int* col_order, int n_col_blocks,
                 int ranges, int per_range, float* ws, void* out, int act,
                 float tau, cudaStream_t s) {
  switch (m_tile) {
    case 64:
      return tc_t<64, WK>(x, M, K, blocks, n_blocks, bk, bn, scales, bias,
                          col_ptr, rows, pidx, col_order, n_col_blocks,
                          ranges, per_range, ws, out, act, tau, s);
    case 128:
      return tc_t<128, WK>(x, M, K, blocks, n_blocks, bk, bn, scales, bias,
                           col_ptr, rows, pidx, col_order, n_col_blocks,
                           ranges, per_range, ws, out, act, tau, s);
    default:
      return cudaErrorInvalidValue;
  }
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

// The thin-M route: M <= 16 (tm = 1, 8 or 16 rows per CTA), a 1-byte
// container (int8, int4x2, int2x4) or f32 / bf16 blocks with bn % 4 == 0,
// at an address aligned to 4 of its elements.  Column block c's schedule entries col_ptr[c] : col_ptr[c + 1]
// are cut into ranges of per_range blocks; `ranges` is the most any column
// has (0: no block at all, only the emit runs).  ws: (ranges, M, N) f32
// scratch.  Other arguments as bsm_launch.  Returns the launches'
// cudaError_t (0 on success).
extern "C" int bsm_thin_launch(const void* x, int x_bf16, int M, int K,
                               const void* blocks, int wkind, int bk, int bn,
                               const float* scales, const float* bias,
                               const int* col_ptr, const int* rows,
                               const int* pidx, int n_col_blocks, int ranges,
                               int per_range, float* ws, void* out, int tm,
                               int act, float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return (int)thin_w<__nv_bfloat16>(wkind, tm, x, M, K, blocks, bk, bn,
                                      scales, bias, col_ptr, rows, pidx,
                                      n_col_blocks, ranges, per_range, ws, out,
                                      act, tau, s);
  return (int)thin_w<float>(wkind, tm, x, M, K, blocks, bk, bn, scales, bias,
                            col_ptr, rows, pidx, n_col_blocks, ranges,
                            per_range, ws, out, act, tau, s);
}

// The tensor-core route: bf16 x (M, K) at a 16-byte aligned address, a
// 1-byte container (int8, int4x2, int2x4) or f32 / bf16 blocks, n_blocks
// of them at a 16-byte aligned address, bk % 64 == 0, bn % 128 == 0.  m_tile: rows per CTA (64
// or 128).  Column block c's schedule entries are cut into ranges of
// per_range blocks, `ranges` of them for the fullest column (at least 1);
// with ranges > 1, ws: (ranges, M, N) f32 scratch and a reduce pass.  out:
// (M, N) bf16.  col_order: (n_col_blocks,) int32, the order in which the
// column blocks are started.  Other arguments as bsm_launch.  Returns the
// launches' cudaError_t.
extern "C" int bsm_tc_launch(const void* x, int M, int K, const void* blocks,
                             int wkind, int n_blocks, int bk, int bn,
                             const float* scales, const float* bias,
                             const int* col_ptr, const int* rows,
                             const int* pidx, const int* col_order,
                             int n_col_blocks, int ranges, int per_range,
                             float* ws, void* out, int m_tile, int act,
                             float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_W(KIND)                                                            \
  case KIND:                                                                  \
    return (int)tc_m<KIND>(m_tile, x, M, K, blocks, n_blocks, bk, bn, scales, \
                           bias, col_ptr, rows, pidx, col_order,              \
                           n_col_blocks, ranges, per_range, ws, out, act,     \
                           tau, s);
  switch (wkind) {
    RT_W(rt::W_F32)
    RT_W(rt::W_BF16)
    RT_W(rt::W_I8)
    RT_W(rt::W_U4)
    RT_W(rt::W_U2)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_W
}
