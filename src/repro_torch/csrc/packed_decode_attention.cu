// Attention read over the bit-packed int4x2 KV cache, for decode (C = 1)
// and prefill chunks (C > 1) alike.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/decode_packed.py
// (`packed_decode_attention` / `_decode_kernel`), and also covers the chunk
// read that the reference leaves to its jnp twin `tiled_packed_attention`.
//
// What it computes, as the TPU kernel does: K/V rows are stored as int4
// codes packed two per byte along Dh (even d = low nibble), with one f32
// scale per (slot, position, kv head).  q arrives pre-scaled by 1/sqrt(Dh) in
// f32.  The cache is walked in bt-row tiles with an online softmax (running
// max m, running sum l, accumulator acc); masked scores are -1e30; a tile
// whose first row is at or past the row's live length is never touched, so
// the result does not depend on the cache extent at a fixed bt; the output
// is acc / max(l, 1e-30).  GQA: the G = H / Hkv query heads of one kv head
// share every decoded tile.
//
// What bounds it on the H100: bytes.  Each live cache row costs Dh bytes of
// codes plus two scales and feeds 4·G·Dh operations, far below the card's
// ridge point.  The design reads each live tile of the packed cache once per
// (slot, kv head, query row) CTA, decodes and dequantises it into shared
// memory, and lets all G query heads of that kv head use it, so no
// dequantised copy of the cache ever reaches device memory; dead tiles cost
// nothing.  One warp per query head computes its scores, softmax update and
// P·V from shared memory.  This is the simple form: one tile in flight per
// CTA, no cp.async/TMA prefetch of the next tile yet.
#include "common.cuh"

namespace {

constexpr int NW = 4;  // warps per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: kf[bt][Dh + 1] (padded: lanes walk rows),
// vf[bt][Dh], ps[G][bt], qs[G][Dh], acc[G][Dh], m[G], l[G].
__host__ __device__ inline size_t smem_floats(int bt, int Dh, int G) {
  return (size_t)bt * (Dh + 1) + (size_t)bt * Dh + (size_t)G * bt +
         2 * (size_t)G * Dh + 2 * (size_t)G;
}

template <typename OT>
__global__ void __launch_bounds__(32 * NW)
    pda_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kp,
               const uint8_t* __restrict__ vp, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ lengths,
               OT* __restrict__ out, int C, int H, int Hkv, int Dh, int T,
               int bt, long long kv_bstride, long long s_bstride) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int Dhp = Dh / 2;
  const int ldk = Dh + 1;
  float* kf = sm;
  float* vf = kf + (size_t)bt * ldk;
  float* ps = vf + (size_t)bt * Dh;
  float* qs = ps + (size_t)G * bt;
  float* acc = qs + (size_t)G * Dh;
  float* m_s = acc + (size_t)G * Dh;
  float* l_s = m_s + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int length = lengths[b * C + c];
  const float* qrow = q + ((size_t)(b * C + c) * H + (size_t)h * G) * Dh;
  for (int e = tid; e < G * Dh; e += 32 * NW) {
    qs[e] = qrow[e];
    acc[e] = 0.f;
  }
  for (int g = tid; g < G; g += 32 * NW) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }

  const uint8_t* kpb = kp + (size_t)b * kv_bstride;
  const uint8_t* vpb = vp + (size_t)b * kv_bstride;
  const float* ksb = ks + (size_t)b * s_bstride;
  const float* vsb = vs + (size_t)b * s_bstride;

  for (int t0 = 0; t0 < length; t0 += bt) {
    __syncthreads();  // previous tile fully consumed (and init visible)
    for (int e = tid; e < bt * Dhp; e += 32 * NW) {
      const int t = e / Dhp, jb = e - t * Dhp;
      const int row = t0 + t;
      float k0 = 0.f, k1 = 0.f, v0 = 0.f, v1 = 0.f;
      if (row < T) {
        const size_t off = ((size_t)row * Hkv + h) * Dhp + jb;
        const uint8_t kb = kpb[off], vb = vpb[off];
        const float sk = ksb[(size_t)row * Hkv + h];
        const float sv = vsb[(size_t)row * Hkv + h];
        k0 = rt::WTraits<rt::W_U4>::get(kb, 0) * sk;
        k1 = rt::WTraits<rt::W_U4>::get(kb, 1) * sk;
        v0 = rt::WTraits<rt::W_U4>::get(vb, 0) * sv;
        v1 = rt::WTraits<rt::W_U4>::get(vb, 1) * sv;
      }
      kf[(size_t)t * ldk + 2 * jb] = k0;
      kf[(size_t)t * ldk + 2 * jb + 1] = k1;
      vf[(size_t)t * Dh + 2 * jb] = v0;
      vf[(size_t)t * Dh + 2 * jb + 1] = v1;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      const float* qg = qs + (size_t)g * Dh;
      float* pg = ps + (size_t)g * bt;
      float smax = NEG_INF;
      for (int t = lane; t < bt; t += 32) {
        const float* kr = kf + (size_t)t * ldk;
        float sc = 0.f;
        for (int d = 0; d < Dh; ++d) sc = fmaf(qg[d], kr[d], sc);
        sc = (t0 + t < length) ? sc : NEG_INF;
        pg[t] = sc;
        smax = fmaxf(smax, sc);
      }
      smax = warp_max(smax);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, smax);
      float psum = 0.f;
      for (int t = lane; t < bt; t += 32) {
        const float p = expf(pg[t] - m_new);
        pg[t] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      float* ag = acc + (size_t)g * Dh;
      for (int d = lane; d < Dh; d += 32) {
        float pv = 0.f;
        for (int t = 0; t < bt; ++t) pv = fmaf(pg[t], vf[(size_t)t * Dh + d], pv);
        ag[d] = ag[d] * corr + pv;
      }
      __syncwarp();
      if (lane == 0) {
        l_s[g] = l_s[g] * corr + psum;
        m_s[g] = m_new;
      }
    }
  }
  __syncthreads();

  OT* orow = out + ((size_t)(b * C + c) * H + (size_t)h * G) * Dh;
  for (int e = tid; e < G * Dh; e += 32 * NW) {
    const int g = e / Dh;
    orow[e] = rt::from_f32<OT>(acc[e] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename OT>
cudaError_t launch_t(const float* q, const uint8_t* kp, const uint8_t* vp,
                     const float* ks, const float* vs, const int* lengths,
                     void* out, int B, int C, int H, int Hkv, int Dh, int T,
                     int bt, long long kv_bstride, long long s_bstride,
                     cudaStream_t stream) {
  const size_t bytes = smem_floats(bt, Dh, H / Hkv) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pda_kernel<OT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(C, Hkv, B);
  pda_kernel<OT><<<grid, 32 * NW, bytes, stream>>>(
      q, kp, vp, ks, vs, lengths, static_cast<OT*>(out), C, H, Hkv, Dh, T, bt,
      kv_bstride, s_bstride);
  return cudaGetLastError();
}

}  // namespace

// q: (B, C, H, Dh) f32, pre-scaled, contiguous.  kp / vp: (B, T, Hkv, Dh/2)
// uint8 whose slot stride is kv_bstride bytes (the rest contiguous); ks / vs:
// (B, T, Hkv) f32 with slot stride s_bstride.  lengths: (B, C) int32.
// out: (B, C, H, Dh), f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).
// Returns the launch's cudaError_t (0 on success).
extern "C" int pda_launch(const float* q, const uint8_t* kp, const uint8_t* vp,
                          const float* ks, const float* vs, const int* lengths,
                          void* out, int out_bf16, int B, int C, int H, int Hkv,
                          int Dh, int T, int bt, long long kv_bstride,
                          long long s_bstride, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    return (int)launch_t<__nv_bfloat16>(q, kp, vp, ks, vs, lengths, out, B, C, H,
                                        Hkv, Dh, T, bt, kv_bstride, s_bstride, s);
  return (int)launch_t<float>(q, kp, vp, ks, vs, lengths, out, B, C, H, Hkv, Dh,
                              T, bt, kv_bstride, s_bstride, s);
}
