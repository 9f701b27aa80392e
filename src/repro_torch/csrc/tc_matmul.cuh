// The tensor-core tile shared by the matmuls' `tensor_core` routes
// (quant_matmul.cu `qmm_tc_kernel`, block_sparse_matmul.cu `bsm_tc_kernel`):
// bf16 x against 1-byte code containers (int8, int4x2, int2x4) or, for
// block_sparse_matmul, f32 and bf16 blocks, on wgmma.
//
// A CTA owns BN = 128 output columns by BM rows of x (64 or 128) and walks a
// list of K steps of BK = 64 codes; the caller's step function names each
// step's x columns and its code rows.  Every code is an integer of at most
// 8 bits, so it is exact in bf16, and a bf16 x bf16 product is exact in
// f32: the f32 accumulators hold the plain version's f32 dot up to
// summation order.  A bf16 weight is its own A operand, exact too.  An f32
// weight w is split into F32_TERMS = 2 bf16 terms, hi = bf16(w) and lo =
// bf16(w - hi), which hold w to 2^-16 of itself, and the step's products
// are issued once over each term into the same accumulators; x is exact in
// bf16.  For float weights the tensor cores' f32 sum is promoted into
// registers every step (64 codes) and started again from zero: the tensor
// cores do not round their f32 sums to nearest, and on the H100 their
// error grew with the number of products added into one sum (at K = 8192,
// M = 512: 3.1e-6 of the largest magnitude for int8 codes, 6.5e-6 with two
// terms, 9.2e-6 with three, unpromoted; promoted, two terms 2.4e-6 and
// three 1.3e-6, chip_smoke.py `tc_sum_error`, against the 5e-6 that the
// activation threshold's band allows).  Scales are applied by the caller
// at emit.
//
// The product is computed transposed, out^T = W^T . x^T: the decoded codes
// are wgmma's A operand, in registers, and x is B, from shared memory, so
// no decoded weight ever touches shared memory.  Each of the two
// warpgroups owns 64 of the CTA's columns as A's 64 rows; a lane's A
// fragment pairs consecutive k, so one int4x2 byte is exactly one bf16x2
// register.  Fragment rows r and r + 8 of a lane are mapped to adjacent
// columns n and n + 1, so each code load is 2 bytes (4 of bf16, 8 of f32
// weights) and each store of the (transposed) accumulator writes two
// adjacent outputs of one row.
//
// The pipeline, warp-specialized: a producer warp copies each step's x
// tile (BM rows x 128 bytes) and code tile (BK / R rows of BN elements) by
// TMA into a ring of stages, both in the 128-byte swizzle (16-byte chunk c
// of row r at c ^ (r % 8)), which wgmma reads for x and which keeps the
// code loads free of bank conflicts; a TMA box under that swizzle is at
// most 128 bytes wide, so a code tile of 2- or 4-byte elements arrives as
// 2 or 4 boxes of 64 or 32 columns, one after the other.  Codes whose row
// pitch is not a multiple of 16 bytes, which TMA cannot map (a quant
// matmul with N % 16 == 8, such as hubert-xlarge's 504-column head), are
// copied instead by the producer warp's 32 lanes with `cp.async` in 8-byte
// pieces into the same swizzled layout, columns past N zero-filled as TMA
// fills them; a stage's "full" mbarrier counts x's bytes and, in that
// variant, the lanes' `cp.async.mbarrier.arrive.noinc` too.  The two
// consumer warpgroups wait on it, decode their A fragments (16 registers
// a thread; 32 for f32 weights: two terms) from the code tile by an
// exponent trick, issue their 4 (f32: 8) wgmma m64nBMk16 as one chain, wait
// for them and release the stage on its "empty" mbarrier, which the
// producer waits on before refilling it.  A warpgroup waits for its
// products before it decodes the next step: ptxas serializes every product
// of a warpgroup whose A (or descriptor) registers are written while one
// is in flight, so the tensor cores overlap one warpgroup's decode with the
// products of the SM's other warpgroups (two per CTA, two CTAs per SM)
// instead; only the stage barriers order the warpgroups.  The ring holds as
// many stages (at most 4) as keep a CTA's stages within 96 KB, so two CTAs
// share an SM: 4 for every 1-byte container, 4 and 3 for bf16 blocks at
// 64- and 128-row tiles; f32 blocks (a 32 KB code tile a step) take 4
// stages in up to 192 KB, one CTA an SM (registers: 108 a thread at 64
// rows, 168 at 128, with 20 bytes of spill stores).
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
constexpr int F32_TERMS = 2;  // bf16 terms of an f32 weight

template <int WK>
__host__ __device__ constexpr int elem_bytes() {
  return (int)sizeof(typename rt::WTraits<WK>::T);
}
// f32 or bf16 weights (no codes: no decode, no scale)
template <int WK>
__host__ __device__ constexpr bool is_float() {
  return WK == rt::W_F32 || WK == rt::W_BF16;
}
// bf16 terms of one weight: F32_TERMS for f32 blocks, else 1
template <int WK>
__host__ __device__ constexpr int terms() {
  return WK == rt::W_F32 ? F32_TERMS : 1;
}
template <int BM>
__host__ __device__ constexpr int x_bytes() { return BM * 128; }
// A step's code tile: BK / R rows of BN elements, as boxes of 128-byte
// rows (one box for 1-byte containers, 2 for bf16, 4 for f32)
template <int WK>
__host__ __device__ constexpr int c_rows() {
  return BK / rt::WTraits<WK>::R;
}
template <int WK>
__host__ __device__ constexpr int c_boxes() {
  return elem_bytes<WK>() * BN / 128;
}
template <int WK>
__host__ __device__ constexpr int c_bytes() {
  return c_boxes<WK>() * c_rows<WK>() * 128;
}
// Bytes of stages a CTA, at most: 96 KB keeps two CTAs an SM; f32 blocks
// (a 32 KB code tile a step) take one CTA an SM and four stages, which
// measured faster on the H100 than two CTAs of two stages in a one-off
// comparison (their 128-row tiles need 168 registers a thread, one CTA an
// SM, anyway).
template <int WK>
__host__ __device__ constexpr int stage_cap() {
  return WK == rt::W_F32 ? 192 * 1024 : 96 * 1024;
}
// Stages of the ring: as many as fit stage_cap, at most 4.
template <int BM, int WK>
__host__ __device__ constexpr int stages() {
  return stage_cap<WK>() / (x_bytes<BM>() + c_bytes<WK>()) < 4
             ? stage_cap<WK>() / (x_bytes<BM>() + c_bytes<WK>())
             : 4;
}
// Shared memory of the pipeline: the stages, then a full and an empty
// mbarrier per stage.  A caller's own data starts at this offset from the
// aligned base.
template <int BM, int WK>
__host__ __device__ constexpr int tile_bytes() {
  return stages<BM, WK>() * (x_bytes<BM>() + c_bytes<WK>() + 16);
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

// 8 bytes global -> shared by cp.async; with `in` false nothing is read
// and the 8 bytes are zero-filled.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}
// An arrival on `bar` once every cp.async this thread issued before it has
// landed; the barrier's count must include it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
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

// Elements `col`, `col + 1` of row `k` of a float code tile: c_boxes boxes
// of 64 rows x 128 bytes (128 / E columns each), each swizzled.
template <int WK>
__device__ __forceinline__ const uint8_t* felem(const uint8_t* cs, int k,
                                                int col) {
  constexpr int E = elem_bytes<WK>(), BOXC = 128 / E;
  const int b = (col % BOXC) * E;  // byte of the pair in its box row
  return cs + (col / BOXC) * (BK * 128) + k * 128 +
         (((b >> 4) ^ (k & 7)) << 4) + (b & 15);
}

// The bf16 terms of two f32 weights, each pair as one bf16x2 register (w0
// low): t[0] = bf16(w), then each term the bf16 of what the earlier ones
// leave, every remainder exact in f32 (kernels/sparse_matmul/ref.py
// `split_bf16`).
template <int T>
__device__ __forceinline__ void split(float w0, float w1, uint32_t (&t)[T]) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    t[i] = tc::pack_bf16(w0, w1);
    w0 -= __uint_as_float(t[i] << 16);
    w1 -= __uint_as_float(t[i] & 0xFFFF0000u);
  }
}

// The lane's A fragments of one step of float weights, in the order of
// decode(): bf16 weights into a[0]; f32 weights split, their bf16 terms
// into a[0], a[1], ...
template <int WK>
__device__ __forceinline__ void decode_float(
    const uint8_t* cs, int col, int t, uint32_t (&a)[terms<WK>()][BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 8 * kk + t + 4 * h;  // k pair: rows 2p, 2p + 1
      if constexpr (WK == rt::W_BF16) {
        const uint32_t r0 =
            *reinterpret_cast<const uint32_t*>(felem<WK>(cs, 2 * p, col));
        const uint32_t r1 =
            *reinterpret_cast<const uint32_t*>(felem<WK>(cs, 2 * p + 1, col));
        a[0][kk][2 * h] = __byte_perm(r0, r1, 0x5410);      // column col
        a[0][kk][2 * h + 1] = __byte_perm(r0, r1, 0x7632);  // column col + 1
      } else {
        const float2 r0 =
            *reinterpret_cast<const float2*>(felem<WK>(cs, 2 * p, col));
        const float2 r1 =
            *reinterpret_cast<const float2*>(felem<WK>(cs, 2 * p + 1, col));
        uint32_t c0[terms<WK>()], c1[terms<WK>()];
        split(r0.x, r1.x, c0);
        split(r0.y, r1.y, c1);
#pragma unroll
        for (int i = 0; i < terms<WK>(); ++i) {
          a[i][kk][2 * h] = c0[i];
          a[i][kk][2 * h + 1] = c1[i];
        }
      }
    }
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
// ends in a CTA barrier.  With CP (codes by cp.async) a stage's "full"
// barrier also waits for the producer warp's 32 lanes.
template <int BM, int WK, bool CP = false>
__device__ __forceinline__ void init_stages(uint32_t sbase) {
  constexpr int NS = stages<BM, WK>();
  constexpr int B0 = NS * (x_bytes<BM>() + c_bytes<WK>());
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(sbase + B0 + 8 * st, CP ? 33 : 1);  // full: the producer
      mbar_init(sbase + B0 + 8 * (NS + st), NTC / 32);  // empty: 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer warp: step s's x tile (x columns kx.., rows m0..; rows >= M
// arrive as zeros) and code tile (code columns ccol.., rows crow..),
// step(s, kx, crow) naming each step, into stage s % NS once the consumers
// have released it.  The codes come by TMA through `tmc` or, with CP, from
// `codes` (row pitch `pitch` bytes, a multiple of 8; columns past `ncols`
// zero-filled) by cp.async, 8 bytes a lane at a time, into the swizzled
// layout TMA would give.
template <int BM, int WK, bool CP, typename Step>
__device__ __forceinline__ void produce(uint32_t sbase, const CUtensorMap* tmx,
                                        const CUtensorMap* tmc,
                                        const uint8_t* codes, int pitch,
                                        int ncols, int m0, int ccol,
                                        int nsteps, Step step) {
  constexpr int XB = x_bytes<BM>(), CB = c_bytes<WK>();
  constexpr int NS = stages<BM, WK>();
  constexpr int C0 = NS * XB, B0 = NS * (XB + CB);
  constexpr int BOX = c_rows<WK>() * 128, BOXC = 128 / elem_bytes<WK>();
  static_assert(!CP || elem_bytes<WK>() == 1, "cp.async codes are 1-byte");
  const int lane = threadIdx.x & 31;
  if (!CP && lane != 0) return;
  for (int s = 0; s < nsteps; ++s) {
    const int st = s % NS;
    if (s >= NS) mbar_wait(sbase + B0 + 8 * (NS + st), ((s / NS) + 1) & 1);
    int kx, crow;
    step(s, kx, crow);
    const uint32_t full = sbase + B0 + 8 * st, cdst = sbase + C0 + st * CB;
    if (lane == 0) {
      mbar_expect_tx(full, CP ? XB : XB + CB);
      tma_2d(sbase + st * XB, tmx, kx, m0, full);
      if constexpr (!CP) {
#pragma unroll
        for (int q = 0; q < c_boxes<WK>(); ++q)
          tma_2d(cdst + q * BOX, tmc, ccol + q * BOXC, crow, full);
      }
    }
    if constexpr (CP) {
      // piece i: row i / 16, bytes 8 (i % 16) .. of its 128; 16-byte chunk
      // (i % 16) / 2 swizzled, each half kept in its chunk
#pragma unroll
      for (int i = lane; i < c_rows<WK>() * 16; i += 32) {
        const int r = i >> 4, q = i & 15, col = ccol + 8 * q;
        const bool in = col < ncols;
        cp_async8(cdst + r * 128 + ((((q >> 1) ^ (r & 7)) << 4) |
                                    ((q & 1) << 3)),
                  codes + (size_t)(crow + r) * pitch + (in ? col : 0), in);
      }
      cp_async_arrive(full);
    }
  }
  if constexpr (CP) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A consumer warpgroup: acc (the transposed fragment: its 64 columns x BM
// rows) = (x[m0 : m0 + BM, the steps' columns] . W[the steps' rows, the
// columns])^T over `nsteps` steps.  `smem` / `sbase`: the 1024-aligned
// dynamic shared memory as a generic pointer and as a shared address.
template <int BM, int WK>
__device__ __forceinline__ void consume(const uint8_t* smem, uint32_t sbase,
                                        int nsteps, float (&acc)[BM / 2]) {
  constexpr int XB = x_bytes<BM>(), CB = c_bytes<WK>();
  constexpr int NS = stages<BM, WK>();
  constexpr int C0 = NS * XB, B0 = NS * (XB + CB);
  const int tid = threadIdx.x, lane = tid & 31;
  // this lane's columns col, col + 1 of the CTA's 128
  const int col = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + 2 * (lane >> 2);
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
  if constexpr (is_float<WK>()) {
    // the products' sum promoted to `acc` every step: the tensor cores'
    // own f32 sums drift with the number of products added into them
    float part[BM / 2];
    uint32_t a[terms<WK>()][BK / 16][4];
    for (int i = 0; i < nsteps; ++i) {
      const int st = i % NS;
      mbar_wait(sbase + B0 + 8 * st, (i / NS) & 1);  // step i has landed
      decode_float<WK>(smem + C0 + st * CB, col, t, a);
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) part[j] = 0.f;
      tc::fence_regs(part);
      tc::wgmma_fence();
#pragma unroll
      for (int term = 0; term < terms<WK>(); ++term)
        mma<BM>(part, a[term], sbase + st * XB);
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(sbase + B0 + 8 * (NS + st));  // release
#pragma unroll
      for (int j = 0; j < BM / 2; ++j) acc[j] += part[j];
    }
    return;
  }
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
// array (rows, cols) of the container's elements in c_rows-row boxes of
// 128 bytes (cols * elem_bytes a multiple of 16, the map's row pitch; the
// columns of a last box past cols arrive as zeros and count in its bytes).
// With CP the codes are read by cp.async, and only x's map is made.
template <int BM, int WK, bool CP = false>
inline bool tile_maps(CUtensorMap* tmx, CUtensorMap* tmc, const void* x,
                      int M, int K, const void* codes, uint64_t rows,
                      int cols) {
  constexpr int E = elem_bytes<WK>();
  constexpr CUtensorMapDataType T =
      E == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
             : E == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  *tmc = CUtensorMap{};
  return tensor_map(tmx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K,
                    2ull * K, BM, BK) &&
         (CP || rows == 0 ||  // nothing to read: an empty pattern
          tensor_map(tmc, codes, T, rows, cols, (uint64_t)cols * E,
                     c_rows<WK>(), 128 / E));
}

// The 1024-aligned base of a kernel's dynamic shared memory.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw,
                                                 uint32_t& sbase) {
  const uint32_t s0 = tc::smem_u32(raw);
  sbase = (s0 + 1023u) & ~1023u;
  return raw + (sbase - s0);
}

}  // namespace tcm
