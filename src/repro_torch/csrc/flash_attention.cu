// Full-sequence flash attention, forward: causal or not, GQA, any Tq / Tk.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/kernel.py
// (`flash_attention` / `_kernel`), whose custom VJP (ops.py) runs it as the
// forward of the training path's attention.
//
// What it computes, as the TPU kernel does: o = softmax(q·kᵀ · scale) · v per
// (batch, head), with q taken as q.float() * scale (scale = 1/sqrt(Dh)), an
// online softmax over key tiles (running max m, running sum l, accumulator
// acc, all f32), masked scores set to the finite -1e30, and the output
// acc / max(l, 1e-30) cast to the input type.  Causal masking keeps
// kpos <= q_offset + qpos: q's row 0 sits at absolute position q_offset (0
// for a whole sequence; a sequence-sharded rank's first row otherwise, its
// k and v the whole sequence); key tiles entirely in the future of a q
// tile's last row are never read.  GQA: head h reads kv head h / (H /
// Hkv).  q, k and v are read in their (B, T, heads, Dh) layout
// through strides; the ragged edge of Tq and Tk is masked here, so any shape
// runs.
//
// What bounds it on the H100: operations.  At the training shape (B = 2,
// T = 2048, H = 32, Hkv = 8, Dh = 64, causal) it does 4·B·H·T²·Dh / 2 =
// 34 GFLOP against 42 MB of q, k, v and o, far above the ridge point even at
// the tensor cores' bf16 rate.  This first design computes in f32 on the CUDA
// cores, as the TPU kernel computes in f32: one CTA per (batch·head, 64-row q
// tile) stages the scaled q tile and one 64-key K/V tile at a time in shared
// memory; each warp owns 16 q rows, each lane a 4-row × 8-key block of the
// scores and the same 4 rows × Dh/8 columns of the accumulator, so every
// shared-memory word it loads feeds 4 or 8 FMAs.  The probabilities pass
// through shared memory to the P·V product.  Nothing of the (T, T) score
// matrix reaches device memory.  The step that approaches the bound exists
// for bf16 with Dh 64, 80, 96 or 128: those shapes take the tensor-core
// kernel of flash_attention_tc.cu (wgmma), as `flash_route` in
// kernels/flash_attention/kernel.py decides; this kernel keeps f32, the
// other head dims (16, 40, 256, ...) and strides that are not whole 16-byte
// rows.
#include "common.cuh"

namespace {

constexpr int BQ = 64;         // q rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // threads per CTA: 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;

// Shared memory, in floats: q[BQ][Dh + 1], k[BK][Dh + 1], v[BK][8 * DPL],
// p[BQ][BK + 1] (the +1 pads keep the lanes of a warp on distinct banks).
__host__ __device__ inline size_t smem_floats(int Dh, int dpl) {
  return (size_t)BQ * (Dh + 1) + (size_t)BK * (Dh + 1) + (size_t)BK * 8 * dpl +
         (size_t)BQ * (BK + 1);
}

// DPL: accumulator columns per lane, ceil(Dh / 8) rounded up to a power of 2.
template <typename T, int DPL>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tq,
                     int Tk, int H, int Hkv, int Dh, long long sqb,
                     long long sqt, long long sqh, long long skb, long long skt,
                     long long skh, long long svb, long long svt, long long svh,
                     float scale, int causal, int q_offset) {
  extern __shared__ float sm[];
  const int ldq = Dh + 1, ldk = Dh + 1, ldv = 8 * DPL, ldp = BK + 1;
  float* qs = sm;
  float* ks = qs + (size_t)BQ * ldq;
  float* vs = ks + (size_t)BK * ldk;
  float* ps = vs + (size_t)BK * ldv;

  // blockIdx.x walks batch·head fastest; the longest causal q tiles first
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane >> 3, kg = lane & 7;
  const int row0 = warp * 16 + rg * 4;  // this lane's 4 rows of the tile

  const T* qb = q + (size_t)b * sqb + (size_t)h * sqh;
  const T* kb = k + (size_t)b * skb + (size_t)hk * skh;
  const T* vb = v + (size_t)b * svb + (size_t)hk * svh;

  for (int e = tid; e < BQ * Dh; e += NT) {
    const int r = e / Dh, d = e - r * Dh;
    const int t = q0 + r;
    qs[r * ldq + d] = t < Tq ? rt::to_f32(qb[(size_t)t * sqt + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][DPL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  const int kend = causal ? min(Tk, q_offset + q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // previous tile consumed; q tile visible
    for (int e = tid; e < BK * ldv; e += NT) {
      const int c = e / ldv, d = e - c * ldv;
      const int t = k0 + c;
      const bool in = t < Tk && d < Dh;
      if (d < Dh) ks[c * ldk + d] = in ? rt::to_f32(kb[(size_t)t * skt + d]) : 0.f;
      vs[c * ldv + d] = in ? rt::to_f32(vb[(size_t)t * svt + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(row0 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = ks[(kg + 8 * j) * ldk + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + row0 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + kg + 8 * j;
        const bool ok = kpos < Tk && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 lanes of a row group hold the row's 64 keys
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(row0 + i) * ldp + kg + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
    }
    __syncwarp();  // a warp's p rows are written and read by that warp only

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(row0 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const float vv = vs[c * ldv + kg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + row0 + i;
    if (t >= Tq) continue;
    T* orow = out + (((size_t)b * Tq + t) * H + h) * Dh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = kg + 8 * j;
      if (d < Dh) orow[d] = rt::from_f32<T>(acc[i][j] / den);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int B, int Tq, int Tk, int H, int Hkv, int Dh,
                     const long long* sq, const long long* sk,
                     const long long* sv, float scale, int causal,
                     int q_offset, cudaStream_t stream) {
  const size_t bytes = smem_floats(Dh, DPL) * sizeof(float);
  auto kern = flash_fwd_kernel<T, DPL>;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tq, Tk, H, Hkv, Dh,
      sq[0], sq[1], sq[2], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2], scale,
      causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dpl(const void* q, const void* k, const void* v,
                         void* out, int B, int Tq, int Tk, int H, int Hkv,
                         int Dh, const long long* sq, const long long* sk,
                         const long long* sv, float scale, int causal,
                         int q_offset, cudaStream_t s) {
  const int need = (Dh + 7) / 8;
#define FA_CASE(N)                                                          \
  if (need <= N)                                                            \
    return launch_t<T, N>(q, k, v, out, B, Tq, Tk, H, Hkv, Dh, sq, sk, sv, \
                          scale, causal, q_offset, s);
  FA_CASE(1) FA_CASE(2) FA_CASE(4) FA_CASE(8) FA_CASE(16) FA_CASE(32)
#undef FA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Tq, H, Dh), k / v: (B, Tk, Hkv, Dh), all f32 (bf16 = 0) or all bf16
// (bf16 = 1), unit stride along Dh; sq / sk / sv hold each tensor's (batch,
// position, head) strides in elements.  out: (B, Tq, H, Dh) contiguous, in
// the input type.  q_offset: the absolute position of q's row 0 (causal
// only; 0 <= q_offset <= 2^30).  Needs 1 <= Dh <= 256 and H % Hkv == 0
// (the wrapper checks).  Returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int bf16, int B,
                                      int Tq, int Tk, int H, int Hkv, int Dh,
                                      long long sqb, long long sqt, long long sqh,
                                      long long skb, long long skt, long long skh,
                                      long long svb, long long svt, long long svh,
                                      float scale, int causal, int q_offset,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long sq[3] = {sqb, sqt, sqh}, sk[3] = {skb, skt, skh},
                  sv[3] = {svb, svt, svh};
  if (bf16)
    return (int)dispatch_dpl<__nv_bfloat16>(q, k, v, out, B, Tq, Tk, H, Hkv, Dh,
                                            sq, sk, sv, scale, causal,
                                            q_offset, s);
  return (int)dispatch_dpl<float>(q, k, v, out, B, Tq, Tk, H, Hkv, Dh, sq, sk,
                                  sv, scale, causal, q_offset, s);
}
