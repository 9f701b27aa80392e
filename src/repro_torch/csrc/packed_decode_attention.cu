// Attention read over the quantised KV cache, for decode (C = 1) and
// prefill chunks (C > 1) alike, over either container: int4x2 (two codes a
// byte) and int4 (one int8 code a byte).  Two routes, picked by `pda_plan` in
// kernels/flash_attention/decode_packed.py: the split kernel (`pda_split_*`,
// the cache cut into fixed runs of whole tiles across CTAs, then a combine
// pass) and the single kernel (`pda_kernel`, the first design, one CTA walks
// a slot's whole cache) for the shapes the plan does not take.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/decode_packed.py
// (`packed_decode_attention` / `_decode_kernel`), and also covers the chunk
// read that the reference leaves to its jnp twin `tiled_packed_attention`.
//
// What it computes, as the TPU kernel does: K/V rows are stored as int4
// codes packed two per byte along Dh (even d = low nibble), with one f32
// scale per (slot, position, kv head).  The int4 container holds the same
// codes one per signed byte; the reference reads it in its jnp twin
// (`tiled_packed_attention(packed=False)`).  Here the code format is a
// template parameter of the tile decode alone: everything after it (scale,
// online softmax, sum order, combine) is shared, so the two containers give
// the same bits for the same codes and scales.  q arrives pre-scaled by 1/sqrt(Dh) in
// f32.  The cache is walked in bt-row tiles with an online softmax (running
// max m, running sum l, accumulator acc); masked scores are -1e30; a tile
// whose first row is at or past the row's live length is never touched, so
// the result does not depend on the cache extent at a fixed bt; the output
// is acc / max(l, 1e-30).  GQA: the G = H / Hkv query heads of one kv head
// share every decoded tile.
//
// What bounds it on the H100: bytes.  Each live cache row costs Dh bytes of
// int4x2 codes (2·Dh as int8) plus two scales and feeds 4·G·Dh operations per query row, far below
// the card's ridge point, so the floor is the live cache over HBM bandwidth
// -- about 0.3 us at decode -- and what stands between a kernel and it is
// latency: how many bytes are in flight at once, and how long the chains of
// dependent operations are.
//
// The split kernel is built for that.  Its grid is (slot, kv head, split ×
// row group): a split is `tiles_per_split` whole bt tiles counted from cache
// row 0, a number fixed by bt alone, so the extent T sets only how many
// splits exist and never where one ends.  The R = C·G query rows of a slot
// and kv head fall into `n_groups` groups of `group_rows` (the plan's: at
// most 8, as equal as can be; the kernel takes up to 64); one CTA serves one
// group, so a prefill chunk reads each tile once a group, not C times, the
// groups of a split sharing it through L2.  A row's arithmetic does not
// depend on its group or on how many there are.  A split at or past every
// length of its group returns at once.  Tiles arrive through a two-stage
// cp.async ring (the codes in 16-byte copies, or 8-byte ones where a row's
// code bytes are not a multiple of 16, as Dh 80's 40 int4x2 bytes; each
// row's two scales once), the next tile in flight while the current one is
// used.  Dh and bt are compile-time, so every index is a constant or a
// shift.  A tile costs three barriers: (1) each lane decodes its slice of one
// K row (Dh · bt / 128 codes: whole 4-byte words, read in the widest loads
// the slice's alignment allows) into registers and sums its part of that
// key's score for every query row, the 128 / bt lanes of a key combining by
// shuffles, while the V tile is decoded to f32 in shared memory (a row
// stride ≡ 16 floats mod 32, `v_ld`); (2) one warp per query row updates the
// online softmax; (3) P·V, four output columns per lane in two independent
// partial sums (split over even and odd keys by a shuffle while there are
// few rows).  Each split writes f32 (m, l, acc) per query row; the combine
// pass (`pda_combine_kernel`, a programmatic dependent launch) rescales the
// live splits by exp(m_s - m) and adds them in split order, then divides by
// max(l, 1e-30): no atomics, the same bits on every run and at every extent
// that holds the live rows.  q is read in its own dtype and scaled in f32
// inside the kernel.
//
// The single kernel reads each live tile once per (slot, kv head, query row)
// CTA, decodes it into shared memory, and lets one warp per query head
// compute its scores, softmax update and P·V: one tile in flight, a Dh-long
// chain per score.
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

// code j of a cache row as float: a nibble of byte j / 2 (int4x2, even j =
// low nibble, as csrc/common.cuh's W_U4) or the signed byte j (int4)
template <bool PACKED>
__device__ __forceinline__ float row_code(const uint8_t* row, int j) {
  if constexpr (PACKED)
    return rt::WTraits<rt::W_U4>::get(row[j >> 1], j & 1);
  else
    return (float)(int8_t)row[j];
}

template <typename OT, bool PACKED>
__global__ void __launch_bounds__(32 * NW)
    pda_kernel(const float* __restrict__ q, const uint8_t* __restrict__ kp,
               const uint8_t* __restrict__ vp, const float* __restrict__ ks,
               const float* __restrict__ vs, const int* __restrict__ lengths,
               OT* __restrict__ out, int C, int H, int Hkv, int Dh, int T,
               int bt, long long kv_bstride, long long s_bstride) {
  extern __shared__ float sm[];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int Dhp = PACKED ? Dh / 2 : Dh;  // code bytes of a row
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
    for (int e = tid; e < bt * Dh; e += 32 * NW) {
      const int t = e / Dh, j = e - t * Dh;
      const int row = t0 + t;
      float kv = 0.f, vv = 0.f;
      if (row < T) {
        const size_t off = ((size_t)row * Hkv + h) * Dhp;
        kv = row_code<PACKED>(kpb + off, j) * ksb[(size_t)row * Hkv + h];
        vv = row_code<PACKED>(vpb + off, j) * vsb[(size_t)row * Hkv + h];
      }
      kf[(size_t)t * ldk + j] = kv;
      vf[(size_t)t * Dh + j] = vv;
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

template <typename OT, bool PACKED>
cudaError_t launch_t(const float* q, const uint8_t* kp, const uint8_t* vp,
                     const float* ks, const float* vs, const int* lengths,
                     void* out, int B, int C, int H, int Hkv, int Dh, int T,
                     int bt, long long kv_bstride, long long s_bstride,
                     cudaStream_t stream) {
  const size_t bytes = smem_floats(bt, Dh, H / Hkv) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pda_kernel<OT, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(C, Hkv, B);
  pda_kernel<OT, PACKED><<<grid, 32 * NW, bytes, stream>>>(
      q, kp, vp, ks, vs, lengths, static_cast<OT*>(out), C, H, Hkv, Dh, T, bt,
      kv_bstride, s_bstride);
  return cudaGetLastError();
}

}  // namespace

// q: (B, C, H, Dh) f32, pre-scaled, contiguous.  kp / vp: (B, T, Hkv, Dh/2)
// uint8 (packed = 1) or (B, T, Hkv, Dh) int8 codes (packed = 0) whose slot
// stride is kv_bstride bytes (the rest contiguous); ks / vs: (B, T, Hkv) f32
// with slot stride s_bstride.  lengths: (B, C) int32.  out: (B, C, H, Dh),
// f32 (out_bf16 = 0) or bf16 (out_bf16 = 1).  Returns the launch's
// cudaError_t (0 on success).
extern "C" int pda_launch(const float* q, const uint8_t* kp, const uint8_t* vp,
                          const float* ks, const float* vs, const int* lengths,
                          void* out, int out_bf16, int packed, int B, int C,
                          int H, int Hkv, int Dh, int T, int bt,
                          long long kv_bstride, long long s_bstride,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SINGLE(OT, P)                                                       \
  return (int)launch_t<OT, P>(q, kp, vp, ks, vs, lengths, out, B, C, H, Hkv,   \
                              Dh, T, bt, kv_bstride, s_bstride, s);
  if (out_bf16) {
    if (packed) RT_SINGLE(__nv_bfloat16, true)
    RT_SINGLE(__nv_bfloat16, false)
  }
  if (packed) RT_SINGLE(float, true)
  RT_SINGLE(float, false)
#undef RT_SINGLE
}

// ------------------------------------------------------------ split route

namespace {

constexpr int SP_NT = 128;          // threads per split CTA
constexpr int SP_NW = SP_NT / 32;
constexpr int SP_MAX_ROWS = 64;     // query rows of a row group, at most
constexpr size_t SP_SMEM_MAX = 232448;

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) & ~(size_t)15;
}

// Row stride of the decoded V tile in floats: the least value >= DH that
// is 16 mod 32 (80 at Dh 64 and 80, 112 at 96, 144 at 128), so the two
// keys P·V reads at once (rows t and t + 1) fall in different banks.
template <int DH>
__host__ __device__ constexpr int v_ld() { return DH + ((16 - DH) % 32 + 32) % 32; }
static_assert(v_ld<64>() == 80 && v_ld<80>() == 80 && v_ld<96>() == 112 &&
                  v_ld<128>() == 144, "v_ld");

// Bytes of one cp.async piece of a cache row's codes: 16 where the row's
// code bytes are a multiple of 16, else 8 (the codes must then be 8-byte
// aligned, not 16).
template <int CB>
__host__ __device__ constexpr int code_piece() { return CB % 16 == 0 ? 16 : 8; }

// Bytes of the widest load `load_words<W>` makes: 16, 8 or 4.
template <int W>
__host__ __device__ constexpr int word_load_bytes() {
  return W % 4 == 0 ? 16 : W % 2 == 0 ? 8 : 4;
}

// Shared memory of a split CTA, in bytes from the base: two ring stages of
// [k codes (BT, CB)][v codes][k scales (BT)][v scales], CB the code bytes
// of a row (DH / 2 int4x2, DH int8), then the f32 V tile (BT, v_ld<DH>),
// q rows and acc (R, DH), scores (R, BT), m / l / corr (R), and the rows'
// lengths (R ints); R the rows of a group.
template <int DH, int BT, int CB>
struct SplitSmem {
  static constexpr size_t codes = align16((size_t)2 * BT * CB);
  static constexpr size_t stage = codes + align16((size_t)8 * BT);
  static constexpr size_t vf = 2 * stage;
  static constexpr size_t qs = vf + (size_t)4 * BT * v_ld<DH>();
  size_t acc, ps, m, l, corr, lens, total;
  __host__ __device__ explicit SplitSmem(int R) {
    acc = qs + (size_t)4 * R * DH;
    ps = acc + (size_t)4 * R * DH;
    m = ps + align16((size_t)4 * R * BT);
    l = m + align16((size_t)4 * R);
    corr = l + align16((size_t)4 * R);
    lens = corr + align16((size_t)4 * R);
    total = lens + align16((size_t)4 * R);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The code formats of a 4-byte word: PER codes, code i as float.  int4x2:
// 8 nibbles, even d = low nibble, as csrc/common.cuh's W_U4; int4: 4 signed
// bytes.  Both give the same float for the same code.
template <bool PACKED>
struct Codes;
template <>
struct Codes<true> {
  static constexpr int PER = 8;
  __device__ __forceinline__ static float get(uint32_t word, int i) {
    return (float)((int)(((word >> (4 * i)) & 0xFu) ^ 8u) - 8);
  }
};
template <>
struct Codes<false> {
  static constexpr int PER = 4;
  __device__ __forceinline__ static float get(uint32_t word, int i) {
    return (float)(int8_t)((word >> (8 * i)) & 0xFFu);
  }
};

// the codes of `word` times `scl` into out[0..PER)
template <bool PACKED>
__device__ __forceinline__ void dequant_word(uint32_t word, float scl, float* out) {
#pragma unroll
  for (int i = 0; i < Codes<PACKED>::PER; ++i) out[i] = Codes<PACKED>::get(word, i) * scl;
}

// W 4-byte words from shared memory at `src` (4W-byte aligned), in the
// widest loads that alignment allows
template <int W>
__device__ __forceinline__ void load_words(const uint8_t* src, uint32_t* w) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[i / 4];
      w[i] = v.x;
      w[i + 1] = v.y;
      w[i + 2] = v.z;
      w[i + 3] = v.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const uint2 v = reinterpret_cast<const uint2*>(src)[i / 2];
      w[i] = v.x;
      w[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = reinterpret_cast<const uint32_t*>(src)[i];
  }
}

template <int DH, int BT, bool PACKED>
__global__ void __launch_bounds__(SP_NT, 1)
    pda_split_kernel(const void* __restrict__ q, int q_bf16, float q_scale,
                     const uint8_t* __restrict__ kp,
                     const uint8_t* __restrict__ vp, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ lengths, float* __restrict__ ws,
                     int C, int H, int Hkv, int T, int tiles_per_split,
                     int n_split, int n_groups, int group_rows,
                     long long kv_bstride, long long s_bstride) {
  constexpr int PER = Codes<PACKED>::PER;  // codes of a 4-byte word
  constexpr int DHP = DH * 4 / PER;        // code bytes of a row
  constexpr int DP = SP_NT / BT;           // lanes that sum one score
  constexpr int SL = DH / DP;              // d values per lane
  constexpr int SW = SL / PER;             // 4-byte words per lane
  constexpr int VLD = v_ld<DH>();
  constexpr int CP = code_piece<DHP>();    // bytes of a cp.async piece
  static_assert(SP_NT % BT == 0 && SL % 8 == 0, "one lane holds whole words");
  static_assert(DHP % CP == 0, "rows copy in whole pieces");
  static_assert(DHP % word_load_bytes<SW>() == 0 &&
                    (SW * 4) % word_load_bytes<SW>() == 0,
                "a lane's K slice is aligned to its loads");
  using Smem = SplitSmem<DH, BT, DHP>;
  // the combine pass may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) uint8_t smem[];
  const int s = blockIdx.x / n_groups, grp = blockIdx.x % n_groups;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv, R_all = C * G;
  // this CTA's query rows: [r0, r0 + R) of the slot and kv head's C·G
  const int r0 = grp * group_rows, R = min(group_rows, R_all - r0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int lmax = 0;
  for (int c = r0 / G; c <= (r0 + R - 1) / G; ++c)
    lmax = max(lmax, lengths[b * C + c]);
  const int n_t = (T + BT - 1) / BT;
  const int tile_lo = s * tiles_per_split;
  const int tile_hi =
      min(min(tile_lo + tiles_per_split, n_t), (lmax + BT - 1) / BT);
  if (tile_lo >= tile_hi) return;  // dead for every query row: no load
  const int row_end = min(T, lmax);  // rows at or past it are zero-filled

  const Smem L(R);
  float* vf = reinterpret_cast<float*>(smem + Smem::vf);
  float* qs = reinterpret_cast<float*>(smem + Smem::qs);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* ps = reinterpret_cast<float*>(smem + L.ps);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  float* corr_s = reinterpret_cast<float*>(smem + L.corr);
  int* lens = reinterpret_cast<int*>(smem + L.lens);

  const uint8_t* kpb = kp + (size_t)b * kv_bstride;
  const uint8_t* vpb = vp + (size_t)b * kv_bstride;
  const float* ksb = ks + (size_t)b * s_bstride;
  const float* vsb = vs + (size_t)b * s_bstride;

  // tile `tile` -> ring stage `st`: CP-byte copies of the codes, 4-byte
  // copies of the scales, zeros past row_end
  constexpr int CH = DHP / CP;  // pieces of a row
  uint8_t* const ring = smem;
  auto issue = [&](int tile, int st) {
    uint8_t* base = ring + st * Smem::stage;
    float* sc = reinterpret_cast<float*>(base + Smem::codes);
    const int t0 = tile * BT;
    const int live = min(BT, row_end - t0);
#pragma unroll
    for (int e = tid; e < 2 * BT * CH; e += SP_NT) {
      const int kv = e / (BT * CH), rem = e % (BT * CH);
      const int t = rem / CH, ch = rem % CH;
      uint8_t* dst = base + (kv * BT + t) * DHP + ch * CP;
      const uint8_t* src =
          (kv ? vpb : kpb) + ((size_t)(t0 + t) * Hkv + h) * DHP + ch * CP;
      if constexpr (CP == 16) {
        if (t < live)
          cp_async16(dst, src);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      } else {
        if (t < live)
          cp_async8(dst, src);
        else
          *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
      }
    }
    for (int e = tid; e < 2 * BT; e += SP_NT) {
      const int kv = e / BT, t = e % BT;
      if (t < live)
        cp_async4(sc + e, (kv ? vsb : ksb) + (size_t)(t0 + t) * Hkv + h);
      else
        sc[e] = 0.f;
    }
    cp_async_commit();
  };
  issue(tile_lo, 0);  // the first tile flies while q and the state are set

  // q: four values a load (16 bytes f32, 8 bf16; the wrapper aligns q)
  for (int e = tid; e < R * DH / 4; e += SP_NT) {
    const int r = e / (DH / 4), d = 4 * (e % (DH / 4));
    const int c = (r0 + r) / G, g = (r0 + r) - c * G;
    const size_t qi = ((size_t)(b * C + c) * H + h * G + g) * DH + d;
    float4 qv;
    if (q_bf16) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(q) + qi);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      qv = make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
    } else {
      qv = *reinterpret_cast<const float4*>(static_cast<const float*>(q) + qi);
    }
    // q.astype(f32) * (1 / sqrt(Dh)), as the reference
    reinterpret_cast<float4*>(qs)[e] = make_float4(
        qv.x * q_scale, qv.y * q_scale, qv.z * q_scale, qv.w * q_scale);
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int r = tid; r < R; r += SP_NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    lens[r] = lengths[b * C + (r0 + r) / G];
  }

  // scores: lane (key kt, part) holds SL decoded values of K row kt
  const int kt = tid / DP, part = tid % DP;
  // P·V: output items (row, 4 columns); two lanes per item (even and odd
  // keys) while the slot and kv head have few items -- counted over all
  // C·G rows, so a row's sum order does not depend on its group
  const int items = R * (DH / 4);
  const int KS = R_all * (DH / 4) * 2 <= SP_NT ? 2 : 1;
  const int n_live = tile_hi - tile_lo;
  for (int i = 0; i < n_live; ++i) {
    if (i + 1 < n_live) {
      issue(tile_lo + i + 1, (i + 1) & 1);  // the next tile flies now
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile landed; the last tile's P·V is done
    const int t0 = (tile_lo + i) * BT;
    const uint8_t* base = smem + (i & 1) * Smem::stage;
    const float* sc = reinterpret_cast<const float*>(base + Smem::codes);

    // V: one 4-byte word (PER codes) of a row per step, times its scale
#pragma unroll
    for (int e = tid; e < BT * (DHP / 4); e += SP_NT) {
      const int t = e / (DHP / 4), w = e % (DHP / 4);
      const uint32_t word = *reinterpret_cast<const uint32_t*>(
          base + (BT + t) * DHP + 4 * w);
      float v[PER];
      dequant_word<PACKED>(word, sc[BT + t], v);
      float4* dst = reinterpret_cast<float4*>(vf + t * VLD + PER * w);
#pragma unroll
      for (int i = 0; i < PER / 4; ++i)
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }

    // K: this lane's slice of row kt, dequantised in registers
    float kr[SL];
    {
      uint32_t words[SW];
      load_words<SW>(base + kt * DHP + part * (SW * 4), words);
      const float scl = sc[kt];
#pragma unroll
      for (int w = 0; w < SW; ++w) dequant_word<PACKED>(words[w], scl, kr + PER * w);
    }
    // scores of every query row against key kt: SL products per lane in
    // four independent sums, then the DP lanes of the key by shuffles
    for (int r = 0; r < R; ++r) {
      const float* qr = qs + r * DH + part * SL;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < SL; d += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(qr + d);
        a[0] = fmaf(q4.x, kr[d], a[0]);
        a[1] = fmaf(q4.y, kr[d + 1], a[1]);
        a[2] = fmaf(q4.z, kr[d + 2], a[2]);
        a[3] = fmaf(q4.w, kr[d + 3], a[3]);
      }
      float sum = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
      for (int o = DP / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (part == 0)
        ps[r * BT + kt] = (t0 + kt < lens[r]) ? sum : NEG_INF;
    }
    __syncthreads();

    // online softmax update, one warp per query row; a row this tile is
    // dead for keeps its state
    for (int r = warp; r < R; r += SP_NW) {
      if (t0 >= lens[r]) continue;
      float* pr = ps + r * BT;
      float mx = NEG_INF;
      for (int t = lane; t < BT; t += 32) mx = fmaxf(mx, pr[t]);
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < BT; t += 32) {
        const float p = expf(pr[t] - m_new);
        pr[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P·V: lane (item, ks) sums keys ks, ks + KS, ...
    // in two independent partial sums; the KS lanes of an item combine by
    // shuffle.  Every lane runs every step (the shuffles need the warp).
    for (int i0 = 0; i0 < items; i0 += SP_NT / KS) {
      const int it = i0 + tid / KS, ksel = tid % KS;
      const bool valid = it < items;
      const int r = valid ? it / (DH / 4) : 0;
      const int d = valid ? 4 * (it % (DH / 4)) : 0;
      const float* pr = ps + r * BT;
      float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0;
#pragma unroll 4
      for (int t = ksel; t < BT; t += 2 * KS) {
        const float p0 = pr[t], p1 = pr[t + KS];
        const float4 v0 = *reinterpret_cast<const float4*>(vf + t * VLD + d);
        const float4 v1 = *reinterpret_cast<const float4*>(vf + (t + KS) * VLD + d);
        s0.x = fmaf(p0, v0.x, s0.x);
        s0.y = fmaf(p0, v0.y, s0.y);
        s0.z = fmaf(p0, v0.z, s0.z);
        s0.w = fmaf(p0, v0.w, s0.w);
        s1.x = fmaf(p1, v1.x, s1.x);
        s1.y = fmaf(p1, v1.y, s1.y);
        s1.z = fmaf(p1, v1.z, s1.z);
        s1.w = fmaf(p1, v1.w, s1.w);
      }
      float4 pv = make_float4(s0.x + s1.x, s0.y + s1.y, s0.z + s1.z, s0.w + s1.w);
      if (KS == 2) {
        pv.x += __shfl_xor_sync(0xffffffffu, pv.x, 1);
        pv.y += __shfl_xor_sync(0xffffffffu, pv.y, 1);
        pv.z += __shfl_xor_sync(0xffffffffu, pv.z, 1);
        pv.w += __shfl_xor_sync(0xffffffffu, pv.w, 1);
      }
      if (valid && ksel == 0 && t0 < lens[r]) {
        const float corr = corr_s[r];
        float4* a = reinterpret_cast<float4*>(acc + r * DH + d);
        float4 v = *a;
        v.x = v.x * corr + pv.x;
        v.y = v.y * corr + pv.y;
        v.z = v.z * corr + pv.z;
        v.w = v.w * corr + pv.w;
        *a = v;
      }
    }
  }
  __syncthreads();

  // this split's (m, l, acc) per query row of the group
  const size_t row0 = ((size_t)(b * Hkv + h) * n_split + s) * R_all + r0;
  float4* ws_acc = reinterpret_cast<float4*>(ws + row0 * DH);
  for (int e = tid; e < R * DH / 4; e += SP_NT)
    ws_acc[e] = reinterpret_cast<const float4*>(acc)[e];
  float* ws_ml = ws + (size_t)gridDim.z * Hkv * n_split * R_all * DH + 2 * row0;
  for (int r = tid; r < R; r += SP_NT) {
    ws_ml[2 * r] = m_s[r];
    ws_ml[2 * r + 1] = l_s[r];
  }
}

// out[b, c, h, d] from the live splits of its query row, in split order:
// m = max m_s, then acc = sum acc_s · exp(m_s - m) and l likewise, then
// acc / max(l, 1e-30).  One thread per output element.  Where `lse` is not
// null, the d = 0 thread of a row also writes lse[b, c, h] = m + log l, the
// log-sum-exp of the row's scaled scores: -inf for a row with no live key
// (then no split is read, so no dead CTA's unwritten workspace either, and
// out is 0).  A sequence-sharded cache combines ranks' partial reads by it.
// Launched as a programmatic dependent of the split kernel: its CTAs may
// start early and wait here for that grid's end.
template <typename OT>
__global__ void __launch_bounds__(256)
    pda_combine_kernel(const float* __restrict__ ws,
                       const int* __restrict__ lengths, OT* __restrict__ out,
                       float* __restrict__ lse, int B, int C, int H, int Hkv,
                       int Dh, int n_split, int split_rows) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * C * H * Dh) return;
  const int d = (int)(i % Dh);
  const size_t row = i / Dh;
  const int hq = (int)(row % H);
  const int bc = (int)(row / H);
  const int c = bc % C, b = bc / C;
  const int G = H / Hkv, R = C * G;
  const int h = hq / G, g = hq - h * G;
  const int len = lengths[bc];
  const int ns = len > 0 ? min(n_split, (len + split_rows - 1) / split_rows) : 0;
  const size_t row0 = (size_t)(b * Hkv + h) * n_split * R + c * G + g;
  const float* ws_ml = ws + (size_t)B * Hkv * n_split * R * Dh;
  float m = NEG_INF;
  for (int sp = 0; sp < ns; ++sp) m = fmaxf(m, ws_ml[2 * (row0 + (size_t)sp * R)]);
  float a = 0.f, l = 0.f;
  for (int sp = 0; sp < ns; ++sp) {
    const size_t rs = row0 + (size_t)sp * R;
    const float w = expf(ws_ml[2 * rs] - m);
    a += ws[rs * Dh + d] * w;
    l += ws_ml[2 * rs + 1] * w;
  }
  out[i] = rt::from_f32<OT>(a / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0)  // -inf: no live key
    lse[row] = l > 0.f ? m + logf(l) : __int_as_float(0xff800000);
}

template <int DH, int BT, bool PACKED, typename OT>
cudaError_t split_t(const void* q, int q_bf16, float q_scale, const uint8_t* kp,
                    const uint8_t* vp, const float* ks, const float* vs,
                    const int* lengths, float* ws, void* out, float* lse,
                    int B, int C, int H, int Hkv, int T, int tiles_per_split,
                    int n_split,
                    int n_groups, int group_rows, long long kv_bstride,
                    long long s_bstride, cudaStream_t stream) {
  constexpr int CB = PACKED ? DH / 2 : DH;
  const int R = C * (H / Hkv);
  const SplitSmem<DH, BT, CB> L(group_rows);
  const uintptr_t addr = (uintptr_t)kp | (uintptr_t)vp | (uintptr_t)kv_bstride;
  if (group_rows < 1 || group_rows > SP_MAX_ROWS || n_groups < 1 ||
      (long long)n_groups * group_rows < R ||
      (long long)(n_groups - 1) * group_rows >= R || L.total > SP_SMEM_MAX ||
      addr % code_piece<CB>() || (uintptr_t)q % 16 || tiles_per_split < 1 ||
      n_split != ((T + BT - 1) / BT + tiles_per_split - 1) / tiles_per_split)
    return cudaErrorInvalidValue;
  auto kern = pda_split_kernel<DH, BT, PACKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  kern<<<dim3(n_split * n_groups, Hkv, B), SP_NT, L.total, stream>>>(
      q, q_bf16, q_scale, kp, vp, ks, vs, lengths, ws, C, H, Hkv, T,
      tiles_per_split, n_split, n_groups, group_rows, kv_bstride, s_bstride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t n_out = (size_t)B * C * H * DH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n_out + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pda_combine_kernel<OT>,
                           static_cast<const float*>(ws), lengths,
                           static_cast<OT*>(out), lse, B, C, H, Hkv, DH,
                           n_split, tiles_per_split * BT);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename OT, bool PACKED>
cudaError_t split_shape(int Dh, int bt, const void* q, int q_bf16,
                        float q_scale, const uint8_t* kp, const uint8_t* vp,
                        const float* ks, const float* vs, const int* lengths,
                        float* ws, void* out, float* lse, int B, int C, int H,
                        int Hkv,
                        int T, int tiles_per_split, int n_split, int n_groups,
                        int group_rows, long long kv_bstride,
                        long long s_bstride, cudaStream_t s) {
#define RT_SPLIT(DH, BT)                                                      \
  if (Dh == DH && bt == BT)                                                   \
    return split_t<DH, BT, PACKED, OT>(q, q_bf16, q_scale, kp, vp, ks, vs,    \
                                       lengths, ws, out, lse, B, C, H, Hkv, T,\
                                       tiles_per_split, n_split, n_groups,    \
                                       group_rows, kv_bstride, s_bstride, s);
  // the (Dh, bt) builds: SPLIT_SHAPES in decode_packed.py names these
  RT_SPLIT(64, 16)
  RT_SPLIT(64, 32)
  RT_SPLIT(64, 64)
  RT_SPLIT(64, 128)
  RT_SPLIT(80, 64)
  RT_SPLIT(80, 128)
  RT_SPLIT(96, 32)
  RT_SPLIT(96, 64)
  RT_SPLIT(96, 128)
  RT_SPLIT(128, 16)
  RT_SPLIT(128, 32)
  RT_SPLIT(128, 64)
#undef RT_SPLIT
  return cudaErrorInvalidValue;
}

}  // namespace

// The split route: (Dh, bt) in {64} x {16, 32, 64, 128}, {80} x {64, 128},
// {96} x {32, 64, 128} or {128} x {16, 32, 64}; kp / vp and their slot
// stride aligned to the build's copy piece (16 bytes, 8 where a row's code
// bytes are not a multiple of 16: Dh 80 int4x2); kp / vp hold int4x2 (packed
// = 1) or int8 codes (packed = 0) as pda_launch's.  q: (B, C, H, Dh) f32
// (q_bf16 = 0) or bf16, contiguous, 16-byte aligned, not yet scaled; the
// kernel multiplies it by q_scale in f32.  The cache is cut into n_split =
// ceil(ceil(T / bt) / tiles_per_split) splits of tiles_per_split bt-row
// tiles from row 0; the R = C·(H / Hkv) query rows of a (slot, kv head) into
// n_groups groups of group_rows (<= 64; the last may hold fewer, none is
// empty), one CTA each, a row's arithmetic the same in any group.  ws: f32
// scratch of B·Hkv·n_split·R·(Dh + 2) floats.  out: q's dtype.  lse: null,
// or f32 (B, C, H) for each row's log-sum-exp (pda_combine_kernel).  Other
// arguments as pda_launch.  Returns the launches' cudaError_t (0 on success).
extern "C" int pda_split_launch(const void* q, int q_bf16, float q_scale,
                                const uint8_t* kp, const uint8_t* vp,
                                const float* ks, const float* vs,
                                const int* lengths, float* ws, void* out,
                                float* lse, int packed, int B, int C, int H, int Hkv,
                                int Dh, int T, int bt, int tiles_per_split,
                                int n_split, int n_groups, int group_rows,
                                long long kv_bstride, long long s_bstride,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SPLIT_T(OT, P)                                                      \
  return (int)split_shape<OT, P>(Dh, bt, q, q_bf16, q_scale, kp, vp, ks, vs,  \
                                 lengths, ws, out, lse, B, C, H, Hkv, T,      \
                                 tiles_per_split, n_split, n_groups,          \
                                 group_rows, kv_bstride, s_bstride, s);
  if (q_bf16) {
    if (packed) RT_SPLIT_T(__nv_bfloat16, true)
    RT_SPLIT_T(__nv_bfloat16, false)
  }
  if (packed) RT_SPLIT_T(float, true)
  RT_SPLIT_T(float, false)
#undef RT_SPLIT_T
}
