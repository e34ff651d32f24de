// Bilinear backward warp on NHWC: out(x) = img(x + flow(x)), flow in
// pixels (flow[..., 0] along W, flow[..., 1] along H), align-corners pixel
// taps, "zeros" (out-of-image taps contribute 0) or "border" (taps clamp
// to the edge) padding, f32 weights and blend, output in the img dtype.
//
// Replaces: video_super_resolution_tpu/ops/pallas/warp_shift_tpu.py,
// _warp_shift_fwd / _warp_kernel (warp_shift_pallas). This kernel computes
// the exact per-pixel 4-tap gather of ops/warp.py _warp_xla, which the TPU
// kernel equals only inside its tap budget; it does not reproduce the TPU
// kernel's clamping of taps beyond that budget. It takes any C, so the
// flow net's feature warps (C = 32..96) run through it as well.
//
// What bounds it on an H100: it moves (2 C + 8) x 4 bytes a pixel in f32
// for about 7 C FLOP, far below the ridge, so memory bandwidth bounds it;
// the gathered taps of smooth flow fall on nearby rows and hit in L2. Under
// a flow that scatters neighbouring pixels' taps, each tap load of a warp
// touches up to 32 cache lines, and the L1's line rate bounds it instead.
//
// Design: a block covers a run of pixels of one image row (grid: x runs,
// rows, batch; 32-bit index math, no division). Each pixel gets G threads,
// each owning CV consecutive channels (CV = 4 f32 or 8 bf16: one 16-byte
// group; CV = 4 bf16 for C <= 4, 8 f32 for 5 <= C <= 8, so that a pixel of
// up to 8 channels is one thread). A thread reads its pixel's flow once,
// computes the four taps' coordinates, weights and validity once, loads
// each tap's channel group as one vector (16 or 8 bytes; two for f32 C 5..8)
// and stores its output group as one vector; a pixel that is one vector
// (f32 C = 4, bf16 C = 4 or 8) goes to a pair of lanes instead
// (warp_pair_kernel), which reads the two columns of a tap row together.
// Channels whose pixel rows are not whole vectors (C % CV != 0) take the
// scalar tail path. The blend is written with explicit round-to-nearest
// multiplies and adds (no fused multiply-add), in the order of the plain
// PyTorch version, so results match it bit for bit.
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <int BYTES>
struct VecOf;
template <>
struct VecOf<4> { using type = uint32_t; };
template <>
struct VecOf<8> { using type = uint2; };
template <>
struct VecOf<16> { using type = uint4; };

// Storage bits of T, so that the vector unions below hold trivial types.
__device__ __forceinline__ float bits_to_f32(float v) { return v; }
__device__ __forceinline__ float bits_to_f32(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
template <typename R>
__device__ __forceinline__ R f32_to_bits(float v);
template <>
__device__ __forceinline__ float f32_to_bits<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t f32_to_bits<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));   // round to nearest even
}

template <typename T, int CV>
struct Group {
  using R = typename std::conditional<sizeof(T) == 2, uint16_t, float>::type;
  static constexpr int BYTES = CV * (int)sizeof(T);
  static constexpr int NV = BYTES > 16 ? BYTES / 16 : 1;   // vectors a group
  using V = typename VecOf<(BYTES > 16 ? 16 : BYTES)>::type;
  union U {
    V v[NV];
    R e[CV];
  };
};

// A pixel's sample point x + flow(x): its top-left tap (x0, y0), the
// other column and row (x1, y1) and the weights of taps 00, 01, 10, 11,
// computed in the plain version's order.
struct Bilinear {
  float x0, y0, x1, y1, w[4];
};
__device__ __forceinline__ Bilinear bilinear(int x, int y, const float* f) {
  Bilinear b;
  const float sx = __fadd_rn((float)x, f[0]);
  const float sy = __fadd_rn((float)y, f[1]);
  b.x0 = floorf(sx);
  b.y0 = floorf(sy);
  const float wx = __fsub_rn(sx, b.x0), wy = __fsub_rn(sy, b.y0);
  b.x1 = __fadd_rn(b.x0, 1.f);
  b.y1 = __fadd_rn(b.y0, 1.f);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  b.w[0] = __fmul_rn(uy, ux);
  b.w[1] = __fmul_rn(uy, wx);
  b.w[2] = __fmul_rn(wy, ux);
  b.w[3] = __fmul_rn(wy, wx);
  return b;
}

// Index in its image of tap (yi, xi) clamped to the edge; `inside` says
// whether it lay in the image.
__device__ __forceinline__ int tap_index(float yi, float xi, int H, int W, bool& inside) {
  const float wmax = (float)(W - 1), hmax = (float)(H - 1);
  inside = xi >= 0.f && xi <= wmax && yi >= 0.f && yi <= hmax;
  return (int)fminf(fmaxf(yi, 0.f), hmax) * W + (int)fminf(fmaxf(xi, 0.f), wmax);
}

// out = w00 t00 + w01 t01 + w10 t10 + w11 t11, rounded at every step, left
// to right, as the plain version computes it.
__device__ __forceinline__ float blend(const float* w, float t00, float t01, float t10,
                                       float t11) {
  float v = __fmul_rn(w[0], t00);
  v = __fadd_rn(v, __fmul_rn(w[1], t01));
  v = __fadd_rn(v, __fmul_rn(w[2], t10));
  return __fadd_rn(v, __fmul_rn(w[3], t11));
}

template <typename T, int CV>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const T* __restrict__ img, const float* __restrict__ flow,
            T* __restrict__ out, int H, int W, int C, int zeros, int vec) {
  using Gr = Group<T, CV>;
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int c0 = threadIdx.x * CV;
  const size_t row = (size_t)blockIdx.z * H;
  const size_t p = (row + y) * W + x;

  const Bilinear bl = bilinear(x, y, flow + 2 * p);
  const float ty[4] = {bl.y0, bl.y0, bl.y1, bl.y1};
  const float tx[4] = {bl.x0, bl.x1, bl.x0, bl.x1};

  float v[4][CV];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    bool inside;
    const int q = tap_index(ty[t], tx[t], H, W, inside);
    const T* src = img + (row * W + q) * C + c0;
    if (zeros && !inside) {
#pragma unroll
      for (int e = 0; e < CV; ++e) v[t][e] = 0.f;
    } else if (vec) {
      typename Gr::U u;
#pragma unroll
      for (int i = 0; i < Gr::NV; ++i)
        u.v[i] = __ldg(reinterpret_cast<const typename Gr::V*>(src) + i);
#pragma unroll
      for (int e = 0; e < CV; ++e) v[t][e] = bits_to_f32(u.e[e]);
    } else {
#pragma unroll
      for (int e = 0; e < CV; ++e) v[t][e] = c0 + e < C ? vsr::to_f32(__ldg(src + e)) : 0.f;
    }
  }
  float acc[CV];
#pragma unroll
  for (int e = 0; e < CV; ++e) acc[e] = blend(bl.w, v[0][e], v[1][e], v[2][e], v[3][e]);

  T* dst = out + p * C + c0;
  if (vec) {
    typename Gr::U u;
#pragma unroll
    for (int e = 0; e < CV; ++e) u.e[e] = f32_to_bits<typename Gr::R>(acc[e]);
#pragma unroll
    for (int i = 0; i < Gr::NV; ++i)
      reinterpret_cast<typename Gr::V*>(dst)[i] = u.v[i];
  } else {
#pragma unroll
    for (int e = 0; e < CV; ++e)
      if (c0 + e < C) dst[e] = vsr::from_f32<T>(acc[e]);
  }
}

// Pixels of C = CV channels (one vector a tap): a pair of lanes shares a
// pixel, lane h loading the taps of column x0 + h in both rows, so one
// load instruction of the warp reads two adjacent taps a pixel, mostly one
// cache line, where one lane a pixel touches a line a tap. The pair swaps
// half of its taps with a shuffle; lane h blends and stores channels
// [h CV / 2, (h + 1) CV / 2) in the same order as warp_kernel.
template <typename T, int CV>
__global__ void __launch_bounds__(THREADS)
warp_pair_kernel(const T* __restrict__ img, const float* __restrict__ flow,
                 T* __restrict__ out, int H, int W, int zeros) {
  using Gr = Group<T, CV>;
  constexpr int HC = CV / 2;
  const int h = threadIdx.x;
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  if (x >= W) return;                     // both lanes of the pair
  const int y = blockIdx.y;
  const size_t row = (size_t)blockIdx.z * H;
  const size_t p = (row + y) * W + x;

  const Bilinear bl = bilinear(x, y, flow + 2 * p);
  const float xh = h ? bl.x1 : bl.x0;

  float t[2][CV];                         // rows y0, y1 at column xh
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    bool inside;
    const int q = tap_index(k ? bl.y1 : bl.y0, xh, H, W, inside);
    if (zeros && !inside) {
#pragma unroll
      for (int e = 0; e < CV; ++e) t[k][e] = 0.f;
    } else {
      typename Gr::U u;
      u.v[0] = __ldg(reinterpret_cast<const typename Gr::V*>(img + (row * W + q) * CV));
#pragma unroll
      for (int e = 0; e < CV; ++e) t[k][e] = bits_to_f32(u.e[e]);
    }
  }
  // mine: my column's taps of my channel half; theirs: the other column's
  const unsigned mask = __activemask();
  float mine[2][HC], theirs[2][HC];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int e = 0; e < HC; ++e) {
      mine[k][e] = h ? t[k][HC + e] : t[k][e];
      theirs[k][e] = __shfl_xor_sync(mask, h ? t[k][e] : t[k][HC + e], 1);
    }
  typename Group<T, HC>::U o;
#pragma unroll
  for (int e = 0; e < HC; ++e) {
    const float v = h ? blend(bl.w, theirs[0][e], mine[0][e], theirs[1][e], mine[1][e])
                      : blend(bl.w, mine[0][e], theirs[0][e], mine[1][e], theirs[1][e]);
    o.e[e] = f32_to_bits<typename Group<T, HC>::R>(v);
  }
  *reinterpret_cast<typename Group<T, HC>::V*>(out + p * CV + h * HC) = o.v[0];
}

template <typename T, int CV>
int launch(const void* img, const float* flow, void* out, int B, int H, int W,
           int C, int zeros, cudaStream_t s) {
  const int g = (C + CV - 1) / CV;                   // threads a pixel
  if (g > THREADS) return (int)cudaErrorInvalidValue;
  const int px = std::min(std::max(1, THREADS / g), W);   // pixels a block
  const uintptr_t align = CV * sizeof(T) > 16 ? 16 : CV * sizeof(T);
  const int vec = C % CV == 0 && (uintptr_t)img % align == 0 &&
                  (uintptr_t)out % align == 0;
  if constexpr (Group<T, CV>::NV == 1 && CV * sizeof(T) >= 8) {
    if (vec && C == CV && (uintptr_t)out % (CV * sizeof(T)) == 0) {
      const int pp = std::min(THREADS / 2, W);
      warp_pair_kernel<T, CV><<<dim3((W + pp - 1) / pp, H, B), dim3(2, pp), 0, s>>>(
          static_cast<const T*>(img), flow, static_cast<T*>(out), H, W, zeros);
      return (int)cudaGetLastError();
    }
  }
  const dim3 block(g, px);
  const dim3 grid((W + px - 1) / px, H, B);
  warp_kernel<T, CV><<<grid, block, 0, s>>>(
      static_cast<const T*>(img), flow, static_cast<T*>(out), H, W, C, zeros, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsr_warp(const void* img, const void* flow, void* out, int B,
                        int H, int W, int C, int zeros, int is_bf16,
                        void* stream) {
  if ((long long)B * H * W * C == 0) return 0;
  if (H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  if (is_bf16)
    return C <= 4 ? launch<__nv_bfloat16, 4>(img, f, out, B, H, W, C, zeros, s)
                  : launch<__nv_bfloat16, 8>(img, f, out, B, H, W, C, zeros, s);
  return (C > 4 && C <= 8) ? launch<float, 8>(img, f, out, B, H, W, C, zeros, s)
                           : launch<float, 4>(img, f, out, B, H, W, C, zeros, s);
}
