// Shared helpers of the port's hand-written Hopper kernels: the
// fused-epilogue activations, the float conversions, the sub-byte code
// decoders and the launch of a programmatic dependent (a reduce pass).  Every formula here matches the plain PyTorch versions beside
// the kernels (repro_torch.kernels.sparse_matmul.kernel.apply_activation and
// repro_torch.core.quant.unpack_codes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Activation codes passed from Python (kernels/sparse_matmul/kernel.py
// _ACT_CODES); ACT_TRELU reads its threshold from `tau`.
enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_GELU = 3, ACT_TRELU = 4 };

__device__ __forceinline__ float apply_act(float v, int act, float tau) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(v, 0.f);
    case ACT_SILU:
      return v * (1.f / (1.f + expf(-v)));
    case ACT_GELU: {
      // the tanh form, as jax.nn.gelu computes it by default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * v * v * v))));
    }
    case ACT_TRELU:
      return v > tau ? v : 0.f;
    default:
      return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Weight containers.  R is the number of codes one stored element holds
// along the packed (K) axis; get(v, t) returns code t of element v as float.
// Sub-byte fields sit low field first and sign-extend as (c ^ s) - s.
enum WKind { W_F32 = 0, W_BF16 = 1, W_I8 = 2, W_U4 = 3, W_U2 = 4 };

template <int KIND>
struct WTraits;
template <>
struct WTraits<W_F32> {
  using T = float;
  static constexpr int R = 1;
  __device__ static float get(T v, int) { return v; }
};
template <>
struct WTraits<W_BF16> {
  using T = __nv_bfloat16;
  static constexpr int R = 1;
  __device__ static float get(T v, int) { return __bfloat162float(v); }
};
template <>
struct WTraits<W_I8> {
  using T = int8_t;
  static constexpr int R = 1;
  __device__ static float get(T v, int) { return (float)v; }
};
template <>
struct WTraits<W_U4> {  // int4x2: even row = low nibble
  using T = uint8_t;
  static constexpr int R = 2;
  __device__ static float get(T v, int t) {
    return (float)((int)(((v >> (4 * t)) & 0xF) ^ 8) - 8);
  }
};
template <>
struct WTraits<W_U2> {  // int2x4: four crumbs, low field first
  using T = uint8_t;
  static constexpr int R = 4;
  __device__ static float get(T v, int t) {
    return (float)((int)(((v >> (2 * t)) & 0x3) ^ 2) - 2);
  }
};

// Launches `kern` on `stream`; with `pdl` as a programmatic dependent of the
// kernel before it (its CTAs may start while that grid runs and wait for
// its end at `griddepcontrol.wait`).  Returns the launch's cudaError_t.
template <typename... KArgs, typename... Args>
cudaError_t launch_dependent(void (*kern)(KArgs...), dim3 grid, dim3 block,
                             cudaStream_t stream, bool pdl, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kern, static_cast<KArgs>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace rt
