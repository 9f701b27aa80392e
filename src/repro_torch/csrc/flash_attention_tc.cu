// Full-sequence flash attention forward on the tensor cores: bf16 q, k, v
// with Dh 64, 80, 96 or 128, causal or not, GQA, any Tq / Tk.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py:76
// (`flash_attention`, body `_kernel` at :31), the forward of the training
// path's attention, for the shapes `flash_route` in
// kernels/flash_attention/kernel.py sends here: bf16, Dh in {64, 80, 96,
// 128}, unit stride along Dh, every other stride a multiple of 8 elements
// and 16-byte aligned base pointers.  Everything else (f32, other Dh, odd
// strides) takes the CUDA-core kernel of flash_attention.cu, which computes
// the same thing.
//
// What it computes, as the TPU kernel does: o = softmax(q.k^T * scale) . v per
// (batch, head) with an online softmax over 64-key tiles (running max m, sum
// l and accumulator in f32), masked scores set to the finite -1e30, output
// acc / max(l, 1e-30) in bf16; causal masking keeps kpos <= q_offset + qpos
// (q's row 0 at absolute position q_offset: 0 for a whole sequence, a
// sequence-sharded rank's first row otherwise, not necessarily a multiple of
// a tile); head h reads kv head h / (H / Hkv).  bf16 x bf16
// products are exact in f32, so s = (q.k) * scale, with the scale applied in
// f32 after the product, matches the reference's q.float() * scale before
// the dot up to summation order.  The one new rounding is P to bf16 before
// P.V, as in every tensor-core flash kernel.  Softmax exponentials are taken
// as the hardware's exp2 (ex2.approx) of log2(e)-scaled scores, the scale
// and the running max folded into one FMA: the same function, rounded
// differently.
//
// What bounds it on the H100: operations.  At the training shape (B = 2,
// T = 2048, H = 32, Hkv = 8, Dh = 64, causal) it does 34 GFLOP of causal
// pairs against 42 MB of q, k, v and o: 0.035 ms at 989 TFLOP/s.  The design:
// one CTA per (batch.head, 128-row q tile), two warpgroups of 64 q rows each
// (wgmma takes 64 rows), the longest causal q tiles first.  The q tile is
// staged once in shared memory; K and V tiles of 64 keys arrive in a ring of
// two shared-memory stages through 16-byte cp.async copies (zero fill at the
// ragged edge), the next tile's copies in flight while this tile is
// computed.  All tiles are stored in the 128-byte-swizzled layout wgmma
// reads.  S = Q.K^T is one wgmma chain from shared memory (m64n64k16, f32
// accumulators); the online softmax runs on the accumulator fragment in
// registers, with the row max and sum over the 4 lanes of a quad; P is cast
// to bf16 in registers and is the A operand of O += P.V (V transposed from
// shared memory), so P never touches shared memory.  Key tiles wholly in a
// warpgroup's future are skipped, and only tiles on the diagonal or the
// ragged edge are masked element by element.  Two CTAs of two warpgroups
// share an SM at Dh 64, 80 and 96 (110 / 127 / 127 registers a thread, no
// spills), and it is across those four warpgroups that the tensor cores
// overlap the exponentials: overlapping a warpgroup's softmax with its own
// P.V (a third stage, both products issued every tile) measured slower at
// Dh 64 on an H100, and one CTA an SM (135-137 registers) 1.31-1.37x
// slower at Dh 80 over 1024-2048 keys and 1.13x at Dh 96
// (scripts/flash_tc_occupancy.py; NVIDIA H100 80GB HBM3, 700 W).  Dh 128
// keeps one CTA an SM (159 registers).
//
// Dh 80 and 96 (hubert-xlarge and zamba2-2.7b; phi-3-vision-4.2b) use the
// Dh 128 layout with the second 64-column half only partly filled: S takes
// the 5 or 6 k16 steps that hold data, and P.V is one wgmma of N = 80 or 96
// (m64n80k16 / m64n96k16) whose MN-major descriptor reads the first 16 or
// 32 columns of V's second half; the columns past Dh are never copied or
// read.  Exact 32- and 64-byte-swizzled column blocks (no unused columns,
// 61 / 73 KB of shared memory against 97 KB) gave the same results and
// timed slower on an H100 in a one-off comparison.  Not yet done: TMA
// loads from a producer warp with mbarriers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace tc;

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;  // q rows per CTA: two warpgroups of 64
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per CTA
constexpr int NS = 2;    // K/V stages in shared memory
constexpr float NEG_INF = -1e30f;

// One 64-column half of a tile: `rows` rows of 128 bytes.  A tile of Dh
// columns is ceil(Dh / 64) such halves one after another; at Dh 80 and 96
// the second half holds only 16 or 32 columns, and its other columns are
// never written or read.
__host__ __device__ constexpr int half_bytes(int rows) { return rows * 128; }
template <int DH>
__host__ __device__ constexpr int halves() { return (DH + 63) / 64; }
template <int DH>
__host__ __device__ constexpr int smem_bytes() {
  // q tile, NS stages of K and of V, 1 KB to align the base to 1024 bytes
  return halves<DH>() * (half_bytes(BQ) + 2 * NS * half_bytes(BK)) + 1024;
}

// Rows [r0, r0 + ROWS) of a (T, DH) bf16 matrix with row stride `ld`
// (elements) into shared memory at `dst`: 64-column halves of ROWS x 128
// bytes, 16-byte chunk c of row r stored at chunk c ^ (r % 8) (the 128-byte
// swizzle; `dst` is 1024-aligned).  Rows >= T are zero-filled.
template <int ROWS, int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* g,
                                          long long ld, int r0, int T,
                                          int tid) {
  constexpr int CPR = DH / 8;  // chunks per row
  constexpr int TOTAL = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (TOTAL % NT != 0 && e >= TOTAL) break;
    const int r = e / CPR, c = e % CPR;
    const int t = r0 + r;
    const bool in = t < T;
    const bf16* src = g + (in ? (long long)t * ld : 0) + c * 8;
    cp_async16(dst + (c / 8) * half_bytes(ROWS) + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src, in);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// O += P . V over 16 keys: one product of N = Dh columns.
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (DH == 64)
    wgmma_rs_n64(o, a, db, 1);
  else if constexpr (DH == 80)
    wgmma_rs_n80(o, a, db, 1);
  else if constexpr (DH == 96)
    wgmma_rs_n96(o, a, db, 1);
  else
    wgmma_rs_n128(o, a, db, 1);
}

// Fragment layout of a 64 x N wgmma accumulator: warp w of the warpgroup
// holds rows 16 w + lane / 4 (registers 4 j, 4 j + 1) and 16 w + lane / 4 + 8
// (4 j + 2, 4 j + 3), at columns 8 j + 2 (lane % 4) and the next one.
template <int DH>
__global__ void __launch_bounds__(NT, DH == 128 ? 1 : 2)
    flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out, int Tq,
                    int Tk, int H, int Hkv, long long sqb, long long sqt,
                    long long sqh, long long skb, long long skt, long long skh,
                    long long svb, long long svt, long long svh,
                    float scale_log2, int causal, int q_offset) {
  constexpr int KV_BYTES = halves<DH>() * half_bytes(BK);  // one K or V stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + halves<DH>() * half_bytes(BQ);
  const uint32_t sV = sK + NS * KV_BYTES;

  // blockIdx.x walks batch.head fastest; the longest causal q tiles first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7;                       // q rows [64 wg, 64 wg + 64)
  const int r0 = 16 * ((tid >> 5) & 3) + (lane >> 2);  // and r0 + 8
  const int cq = 2 * (lane & 3);
  const int wq0 = q0 + 64 * wg;                  // first q row of the warpgroup
  const int wp0 = q_offset + wq0;                // and its absolute position

  const bf16* qb = q + b * sqb + h * sqh;
  const bf16* kb = k + b * skb + hk * skh;
  const bf16* vb = v + b * svb + hk * svh;

  const int kend = causal ? min(Tk, q_offset + q0 + BQ) : Tk;
  const int ntiles = (kend + BK - 1) / BK;

  load_tile<BQ, DH>(sQ, qb, sqt, q0, Tq, tid);
  load_tile<BK, DH>(sK, kb, skt, 0, Tk, tid);
  load_tile<BK, DH>(sV, vb, svt, 0, Tk, tid);
  cp_async_commit();

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < ntiles) {  // the next tile's copies fly while this one runs
      const int st = (it + 1) % NS;
      load_tile<BK, DH>(sK + st * KV_BYTES, kb, skt, k0 + BK, Tk, tid);
      load_tile<BK, DH>(sV + st * KV_BYTES, vb, svt, k0 + BK, Tk, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and the q tile) has landed
    // the copies were generic-proxy writes; wgmma reads through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (!causal || k0 <= wp0 + 63) {  // else wholly in this warpgroup's future
      const uint32_t kst = sK + (it % NS) * KV_BYTES;
      const uint32_t vst = sV + (it % NS) * KV_BYTES;

      // S = Q . K^T: K = Dh in steps of 16 (32 bytes within a swizzled
      // row), only the steps that hold data (5 at Dh 80, 6 at Dh 96)
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t koff = (kk % 4) * 32;
        const uint64_t da = sw128_desc(
            sQ + (kk / 4) * half_bytes(BQ) + wg * half_bytes(64) + koff, 16,
            1024);
        const uint64_t db =
            sw128_desc(kst + (kk / 4) * half_bytes(BK) + koff, 16, 1024);
        wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (k0 + BK > Tk || (causal && k0 + BK - 1 > wp0)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int qpos = wp0 + r0 + 8 * ((i >> 1) & 1);
          if (key >= Tk || (causal && key > qpos)) s[i] = NEG_INF;
        }
      }

      // online softmax on the unscaled fragment (scale > 0 keeps the max);
      // l stays a per-lane partial sum (the quad's lanes share corr) and is
      // reduced once at emit
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float corr[2], ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        corr[e] = ex2((m[e] - mx[e]) * scale_log2);
        m[e] = mx[e];
        ms[e] = mx[e] * scale_log2;
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = ex2(fmaf(s[i], scale_log2, -ms[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) l[e] = l[e] * corr[e] + sum[e];
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i >> 1) & 1];

      // P (bf16) in registers is the A operand of O += P . V: the
      // accumulator's column pairs are exactly the A fragment's k pairs
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // O += P . V: K = 16 keys per step (2 KB of V rows); V is N-major,
      // one product of N = Dh over its halves (at Dh 80 / 96 the second
      // half's first 16 / 32 columns)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DH>(o, p[kk],
                     sw128_desc(vst + kk * 16 * 128, half_bytes(BK), 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncthreads();  // every warpgroup is done with this stage
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    const int t = wq0 + r0 + 8 * e;
    if (t >= Tq) continue;
    const float den = fmaxf(l[e], 1e-30f);
    bf16* orow = out + (((size_t)b * Tq + t) * H + h) * DH + cq;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
          o[4 * j + 2 * e] / den, o[4 * j + 2 * e + 1] / den);
    }
  }
}

template <int DH>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int B, int Tq, int Tk, int H, int Hkv,
                     const long long* sq, const long long* sk,
                     const long long* sv, float scale, int causal,
                     int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<DH>();
  auto kern = flash_tc_kernel<DH>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tq, Tk, H, Hkv,
      sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2],
      scale * 1.4426950408889634f, causal, q_offset);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Tq, H, Dh), k / v: (B, Tk, Hkv, Dh), all bf16, unit stride along
// Dh, the (batch, position, head) strides sq / sk / sv in elements, each a
// multiple of 8, base pointers 16-byte aligned.  out: (B, Tq, H, Dh)
// contiguous bf16.  Needs Dh in {64, 80, 96, 128} and H % Hkv == 0 (the
// wrapper's flash_route checks all of it).  q_offset: the absolute position
// of q's row 0 (causal only; 0 <= q_offset <= 2^30).  Returns the launch's
// cudaError_t.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Tq,
    int Tk, int H, int Hkv, int Dh, long long sqb, long long sqt,
    long long sqh, long long skb, long long skt, long long skh, long long svb,
    long long svt, long long svh, float scale, int causal, int q_offset,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sq[3] = {sqb, sqt, sqh}, sk[3] = {skb, skt, skh},
                  sv[3] = {svb, svt, svh};
  switch (Dh) {
    case 64:
      return (int)launch_t<64>(q, k, v, out, B, Tq, Tk, H, Hkv, sq, sk, sv,
                               scale, causal, q_offset, s);
    case 80:
      return (int)launch_t<80>(q, k, v, out, B, Tq, Tk, H, Hkv, sq, sk, sv,
                               scale, causal, q_offset, s);
    case 96:
      return (int)launch_t<96>(q, k, v, out, B, Tq, Tk, H, Hkv, sq, sk, sv,
                               scale, causal, q_offset, s);
    case 128:
      return (int)launch_t<128>(q, k, v, out, B, Tq, Tk, H, Hkv, sq, sk, sv,
                                scale, causal, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
