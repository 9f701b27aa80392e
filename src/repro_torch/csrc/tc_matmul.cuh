// The tensor-core tile shared by the quantised matmuls' `tensor_core` routes
// (quant_matmul.cu `qmm_tc_kernel`, block_sparse_matmul.cu `bsm_tc_kernel`):
// bf16 x against 1-byte code containers (int8, int4x2, int2x4) on wgmma.
//
// A CTA owns BN = 128 output columns by BM rows of x (64 or 128) and walks a
// list of K steps of BK = 64 codes; the caller's step function names each
// step's x columns and its code rows.  Every code is an integer of at most
// 8 bits, so it is exact in bf16, and a bf16 x bf16 product is exact in
// f32: the f32 accumulators hold the plain version's f32 dot up to
// summation order.  Scales are applied by the caller at emit.
//
// The product is computed transposed, out^T = W^T . x^T: the decoded codes
// are wgmma's A operand, in registers, and x is B, from shared memory, so
// no decoded weight ever touches shared memory.  Each of the two
// warpgroups owns 64 of the CTA's columns as A's 64 rows; a lane's A
// fragment pairs consecutive k, so one int4x2 byte is exactly one bf16x2
// register.  Fragment rows r and r + 8 of a lane are mapped to adjacent
// columns n and n + 1, so each code load is 2 bytes and each store of the
// (transposed) accumulator writes two adjacent outputs of one row.
//
// The pipeline, warp-specialized: a producer warp copies each step's x
// tile (BM rows x 128 bytes) and packed code tile (BK / R byte rows x 128
// bytes) by TMA into a ring of NS stages, both in the 128-byte swizzle
// (16-byte chunk c of row r at c ^ (r % 8)), which wgmma reads for x and
// which keeps the code loads free of bank conflicts; a stage's "full"
// mbarrier counts its bytes in.  The two consumer warpgroups wait on it,
// decode their A fragments (16 registers a thread) from the code tile by an
// exponent trick, issue their 4 wgmma m64nBMk16 as one chain, wait for them
// and release the stage on its "empty" mbarrier, which the producer waits
// on before refilling it.  A warpgroup waits for its products before it
// decodes the next step: ptxas serializes every product of a warpgroup
// whose A (or descriptor) registers are written while one is in flight, so
// the tensor cores overlap one warpgroup's decode with the products of the
// SM's other warpgroups (two per CTA, two CTAs per SM) instead; only the
// stage barriers order the warpgroups.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked

#include "common.cuh"
#include "wgmma.cuh"

namespace tcm {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;       // codes of K per step: one 128-byte row of x
constexpr int BN = 128;      // output columns per CTA: two warpgroups of 64
constexpr int NTC = 256;     // consumer threads: warps 0..7
constexpr int NT = NTC + 32;  // and the producer warp
constexpr int NS = 4;        // stages of x and codes in shared memory

template <int BM>
__host__ __device__ constexpr int x_bytes() { return BM * 128; }
template <int WK>
__host__ __device__ constexpr int c_bytes() {
  return BK / rt::WTraits<WK>::R * BN;
}
// Shared memory of the pipeline: the stages, then a full and an empty
// mbarrier per stage.  A caller's own data starts at this offset from the
// aligned base.
template <int BM, int WK>
__host__ __device__ constexpr int tile_bytes() {
  return NS * (x_bytes<BM>() + c_bytes<WK>()) + 2 * NS * 8;
}
// Dynamic shared memory of a CTA: the pipeline's, the caller's `meta` bytes
// after it, and 1 KB to align the base.
template <int BM, int WK>
__host__ __device__ constexpr int smem_bytes(int meta) {
  return tile_bytes<BM, WK>() + meta + 1024;
}

// ---------------------------------------------------- mbarriers and TMA

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// The box of a 2-D tensor map at (c0 inner, c1 outer) into shared memory
// at `dst`, counted in on `bar`.
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Bytes `col`, `col + 1` of byte row `r` of a swizzled code tile.
__device__ __forceinline__ uint32_t code2(const uint8_t* cs, int r, int col) {
  return *reinterpret_cast<const uint16_t*>(
      cs + r * 128 + (((col >> 4) ^ (r & 7)) << 4) + (col & 15));
}

// Two bf16x2 registers from the four fields in bytes 0..3 of `v`: `lo`
// holds bytes 0 and 2, `hi` bytes 1 and 3.  Each field is a code plus SIGN
// (a small non-negative integer): placed in the mantissa of bf16 128 and
// taken off exactly.
template <int SIGN>
__device__ __forceinline__ void to_bf16x2(uint32_t v, uint32_t& lo,
                                          uint32_t& hi) {
  const __nv_bfloat162 off = __float2bfloat162_rn(128.f + (float)SIGN);
  uint32_t a = __byte_perm(v, 0x43u, 0x4240u);
  uint32_t b = __byte_perm(v, 0x43u, 0x4341u);
  __nv_bfloat162 x = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), off);
  __nv_bfloat162 y = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), off);
  lo = *reinterpret_cast<uint32_t*>(&x);
  hi = *reinterpret_cast<uint32_t*>(&y);
}

// The A fragment registers of k pair p (codes k = 2p, 2p + 1) for the
// lane's columns col (`a`) and col + 1 (`b`).
template <int WK>
__device__ __forceinline__ void pair(const uint8_t* cs, int p, int col,
                                     uint32_t& a, uint32_t& b) {
  if constexpr (WK == rt::W_U4) {  // byte row p holds the pair
    const uint32_t x = code2(cs, p, col) ^ 0x8888u;
    to_bf16x2<8>((x & 0x0F0Fu) | ((x & 0xF0F0u) << 12), a, b);
  } else if constexpr (WK == rt::W_U2) {  // byte row p / 2, fields 2 (p % 2)
    const uint32_t x = (code2(cs, p >> 1, col) ^ 0xAAAAu) >> (4 * (p & 1));
    to_bf16x2<2>((x & 0x0303u) | ((x & 0x0C0Cu) << 14), a, b);
  } else {  // int8: byte rows 2p and 2p + 1; 128 + code needs 8 bits, more
            // than bf16's mantissa, so the codes go through f32 2^23
    const uint32_t lo = code2(cs, 2 * p, col), hi = code2(cs, 2 * p + 1, col);
    const uint32_t v = (lo | (hi << 16)) ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540u + i)) -
             8388736.f;  // 2^23 + 128
    a = tc::pack_bf16(f[0], f[2]);
    b = tc::pack_bf16(f[1], f[3]);
  }
}

// The lane's A fragments of one step: for each 16-code slice kk, rows r
// (column col) and r + 8 (column col + 1) at k pairs 8 kk + t and
// 8 kk + t + 4 (t = lane % 4): registers {r, p}, {r + 8, p}, {r, p + 4},
// {r + 8, p + 4}.
template <int WK>
__device__ __forceinline__ void decode(const uint8_t* cs, int col, int t,
                                       uint32_t (&a)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pair<WK>(cs, 8 * kk + t, col, a[kk][0], a[kk][1]);
    pair<WK>(cs, 8 * kk + t + 4, col, a[kk][2], a[kk][3]);
  }
}

// The four products of one step: acc += W^T . x^T over its 64 codes.
template <int BM>
__device__ __forceinline__ void mma(float (&acc)[BM / 2],
                                    const uint32_t (&a)[BK / 16][4],
                                    uint32_t xb) {
  const uint64_t d = tc::sw128_desc(xb, 16, 1024);  // + 32 bytes per slice
  if constexpr (BM == 64)
    tc::wgmma_rs4_n64_kb(acc, a, d, d + 2, d + 4, d + 6);
  else
    tc::wgmma_rs4_n128_kb(acc, a, d, d + 2, d + 4, d + 6);
}

// Sets up the stage barriers; every thread of the CTA calls it, and it
// ends in a CTA barrier.
template <int BM, int WK>
__device__ __forceinline__ void init_stages(uint32_t sbase) {
  constexpr int B0 = NS * (x_bytes<BM>() + c_bytes<WK>());
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(sbase + B0 + 8 * st, 1);              // full: the producer
      mbar_init(sbase + B0 + 8 * (NS + st), NTC / 32);  // empty: 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: step s's x tile (x columns kx.., rows m0..; rows >= M
// arrive as zeros) and code tile (code columns ccol.., byte rows crow..),
// step(s, kx, crow) naming each step, into stage s % NS once the consumers
// have released it.
template <int BM, int WK, typename Step>
__device__ __forceinline__ void produce(uint32_t sbase, const CUtensorMap* tmx,
                                        const CUtensorMap* tmc, int m0,
                                        int ccol, int nsteps, Step step) {
  constexpr int XB = x_bytes<BM>(), CB = c_bytes<WK>();
  constexpr int C0 = NS * XB, B0 = NS * (XB + CB);
  if ((threadIdx.x & 31) != 0) return;
  for (int s = 0; s < nsteps; ++s) {
    const int st = s % NS;
    if (s >= NS) mbar_wait(sbase + B0 + 8 * (NS + st), ((s / NS) + 1) & 1);
    int kx, crow;
    step(s, kx, crow);
    const uint32_t full = sbase + B0 + 8 * st;
    mbar_expect_tx(full, XB + CB);
    tma_2d(sbase + st * XB, tmx, kx, m0, full);
    tma_2d(sbase + C0 + st * CB, tmc, ccol, crow, full);
  }
}

// A consumer warpgroup: acc (the transposed fragment: its 64 columns x BM
// rows) = (x[m0 : m0 + BM, the steps' columns] . W[the steps' rows, the
// columns])^T over `nsteps` steps.  `smem` / `sbase`: the 1024-aligned
// dynamic shared memory as a generic pointer and as a shared address.
template <int BM, int WK>
__device__ __forceinline__ void consume(const uint8_t* smem, uint32_t sbase,
                                        int nsteps, float (&acc)[BM / 2]) {
  constexpr int XB = x_bytes<BM>(), CB = c_bytes<WK>();
  constexpr int C0 = NS * XB, B0 = NS * (XB + CB);
  const int tid = threadIdx.x, lane = tid & 31;
  // this lane's columns col, col + 1 of the CTA's 128
  const int col = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  uint32_t a[BK / 16][4];
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % NS;
    mbar_wait(sbase + B0 + 8 * st, (i / NS) & 1);  // step i has landed
    decode<WK>(smem + C0 + st * CB, col, t, a);
    tc::fence_regs(acc);
    tc::wgmma_fence();
    mma<BM>(acc, a, sbase + st * XB);
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(sbase + B0 + 8 * (NS + st));  // release
  }
}

// The fragment's outputs: register 4 j + 2 e + h holds column
// n0 + col + e (col: the lane's first column, as in mainloop) of row
// m0 + 8 j + 2 (lane % 4) + h.  With `ws` null: out = act(acc * s + b) in
// bf16 (s and b may be null); else ws = acc * s (s may be null) in f32,
// for a reduce pass.  Rows >= M and columns >= N (the ragged last column
// tile; N is even) are not written; N is also the row stride of out / ws.
template <int BM>
__device__ __forceinline__ void emit(const float (&acc)[BM / 2], int m0,
                                     int M, int n0, int N,
                                     const float* __restrict__ scales,
                                     const float* __restrict__ bias,
                                     float* __restrict__ ws,
                                     bf16* __restrict__ out, int act,
                                     float tau) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n =
      n0 + 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * (lane >> 2);
  if (n >= N) return;
  const float s0 = scales != nullptr ? scales[n] : 1.f;
  const float s1 = scales != nullptr ? scales[n + 1] : 1.f;
  const float b0 = bias != nullptr && ws == nullptr ? bias[n] : 0.f;
  const float b1 = bias != nullptr && ws == nullptr ? bias[n + 1] : 0.f;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 8 * j + 2 * (lane & 3) + h;
      if (m >= M) continue;
      const float v0 = acc[4 * j + h] * s0, v1 = acc[4 * j + 2 + h] * s1;
      if (ws != nullptr) {
        *reinterpret_cast<float2*>(ws + (size_t)m * N + n) =
            make_float2(v0, v1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + n) =
            __floats2bfloat162_rn(rt::apply_act(v0 + b0, act, tau),
                                  rt::apply_act(v1 + b1, act, tau));
      }
    }
  }
}

// The reduce pass of the tensor-core routes: out[m, n] = act(sum of the
// partials ws[s, m, n] (* scale) + b) in bf16, the partials added in
// order s = 0, 1, ... on every run.  A thread takes 4 adjacent outputs of
// one row (N % 4 == 0), with 16-byte loads.  The partials of output column
// n are `parts` in number, or, with `col_ptr`, those of its column block c
// = n / bn: ceil(blocks of c / per_range), none for a column with no block
// (act(b)).  Launched as a programmatic dependent of the tile kernel: it
// may start early and waits here for that grid's end.
__global__ void __launch_bounds__(256)
    reduce_kernel(const float* __restrict__ ws, int M, int N, int parts,
                  const int* __restrict__ col_ptr, int bn, int per_range,
                  const float* __restrict__ scales,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  int act, float tau) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= M * N) return;
  const int n = i % N;
  if (col_ptr != nullptr) {
    const int c = n / bn;
    parts = (col_ptr[c + 1] - col_ptr[c] + per_range - 1) / per_range;
  }
  const size_t stride = (size_t)M * N;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < parts; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws + s * stride + i);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  float r[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (scales != nullptr) r[j] *= scales[n + j];
    if (bias != nullptr) r[j] += bias[n + j];
    r[j] = rt::apply_act(r[j], act, tau);
  }
  uint2 o;
  o.x = tc::pack_bf16(r[0], r[1]);
  o.y = tc::pack_bf16(r[2], r[3]);
  *reinterpret_cast<uint2*>(out + i) = o;
}

// Launches reduce_kernel over (M, N) as a programmatic dependent of the
// kernel launched just before it.
inline cudaError_t reduce(const float* ws, int M, int N, int parts,
                          const int* col_ptr, int bn, int per_range,
                          const float* scales, const float* bias, void* out,
                          int act, float tau, cudaStream_t stream) {
  return rt::launch_dependent(reduce_kernel, dim3((M * N / 4 + 255) / 256),
                              dim3(256), stream, true, ws, M, N, parts,
                              col_ptr, bn, per_range, scales, bias,
                              static_cast<bf16*>(out), act, tau);
}

// A 2-D tensor map over a row-major (rows, cols) array of `elem`-byte
// elements (a row of `pitch` bytes, a multiple of 16), with boxes of
// box_rows x box_cols and the 128-byte swizzle; out-of-range rows and
// columns read as zeros.  The encoder,
// cuTensorMapEncodeTiled, is fetched through the runtime's entry-point
// query, so libcuda need not be linked.
// Returns false if it cannot be encoded.
inline bool tensor_map(CUtensorMap* map, const void* base,
                       CUtensorMapDataType type, uint64_t rows,
                       uint64_t cols, uint64_t pitch, uint32_t box_rows,
                       uint32_t box_cols) {
  using Encode = CUresult (*)(
      CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
      const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
      CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
      CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<Encode>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dim[2] = {cols, rows}, stride[1] = {pitch};
  const cuuint32_t box[2] = {box_cols, box_rows}, one[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dim, stride, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of x (M, K) bf16 in BM-row x 64-column boxes and of a code
// array (rows, cols) uint8 in (64 / R)-row x 128-column boxes (cols a
// multiple of 16, the map's row pitch; the columns of a last box past
// cols arrive as zeros and count in its bytes).
template <int BM, int WK>
inline bool tile_maps(CUtensorMap* tmx, CUtensorMap* tmc, const void* x,
                      int M, int K, const void* codes, uint64_t rows,
                      int cols) {
  constexpr int R = rt::WTraits<WK>::R;
  *tmc = CUtensorMap{};
  return tensor_map(tmx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K,
                    2ull * K, BM, BK) &&
         (rows == 0 ||  // nothing to read: an empty pattern
          tensor_map(tmc, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, rows, cols,
                     cols, BK / R, BN));
}

// The 1024-aligned base of a kernel's dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw,
                                                 uint32_t& sbase) {
  const uint32_t s0 = tc::smem_u32(raw);
  sbase = (s0 + 1023u) & ~1023u;
  return raw + (sbase - s0);
}

}  // namespace tcm
