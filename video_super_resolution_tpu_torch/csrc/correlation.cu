// Local cost-volume correlation on NHWC features:
//   cost[b,y,x,k] = (1/C) * sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c],
// k row-major over (dy, dx) in [-d, d]^2, f2 zero outside the image,
// f32 accumulation and f32 output with K = (2d+1)^2 channels minor.
//
// Replaces: video_super_resolution_tpu/ops/pallas/correlation_tpu.py,
// _correlation_fwd_pallas / _corr_kernel (correlation_pallas).
//
// What bounds it on an H100: every f2 element is used (2d+1)^2 = 81 times
// and every output is 2C FLOP of f32 work, so at d = 4 it does 162 C FLOP
// for about 4 C + 324 bytes moved per pixel; the f32 CUDA-core rate bounds
// it for C >= 32, with the f32 output write (324 bytes a pixel) close.
//
// Design: one 128-thread block per 4 x 32 output tile of one batch item.
// The block stages a 16-channel slice of f1's tile and of f2's
// (4 + 2d) x (32 + 2d) halo in shared memory (zero outside the image and
// beyond C, so the boundary needs no branch in the inner loop), and each
// thread owns one output pixel with its 81 accumulators in registers,
// looping over channels and unrolled displacements. A warp reads one tile
// row, so shared-memory reads are conflict-free. The (2d+1)^2 outputs of a
// pixel are written as one contiguous run.
#include "common.cuh"

namespace {

constexpr int TH = 4;
constexpr int TW = 32;
constexpr int CC = 16;
constexpr int THREADS = TH * TW;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   float* __restrict__ out, int H, int W, int C, float inv_c) {
  constexpr int ND = 2 * D + 1;
  constexpr int K = ND * ND;
  constexpr int HH = TH + 2 * D;
  constexpr int HWD = TW + 2 * D;
  __shared__ float s1[CC][TH][TW];
  __shared__ float s2[CC][HH][HWD];

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const int ty = threadIdx.x / TW;
  const int tx = threadIdx.x - ty * TW;
  const long long plane = (long long)b * H * W;

  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = threadIdx.x; i < TH * TW * CC; i += THREADS) {
      const int c = i % CC;
      const int p = i / CC;
      const int py = p / TW;
      const int px = p - py * TW;
      const int gy = y0 + py, gx = x0 + px, gc = c0 + c;
      float v = 0.f;
      if (gy < H && gx < W && gc < C)
        v = vsr::to_f32(f1[(plane + (long long)gy * W + gx) * C + gc]);
      s1[c][py][px] = v;
    }
    for (int i = threadIdx.x; i < HH * HWD * CC; i += THREADS) {
      const int c = i % CC;
      const int p = i / CC;
      const int py = p / HWD;
      const int px = p - py * HWD;
      const int gy = y0 - D + py, gx = x0 - D + px, gc = c0 + c;
      float v = 0.f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && gc < C)
        v = vsr::to_f32(f2[(plane + (long long)gy * W + gx) * C + gc]);
      s2[c][py][px] = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CC; ++c) {
      const float a = s1[c][ty][tx];
#pragma unroll
      for (int dy = 0; dy < ND; ++dy)
#pragma unroll
        for (int dx = 0; dx < ND; ++dx)
          acc[dy * ND + dx] = fmaf(a, s2[c][ty + dy][tx + dx], acc[dy * ND + dx]);
    }
    __syncthreads();
  }

  const int y = y0 + ty, x = x0 + tx;
  if (y < H && x < W) {
    float* o = out + (plane + (long long)y * W + x) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) o[k] = acc[k] * inv_c;
  }
}

template <typename T>
int launch(const void* f1, const void* f2, float* out, int B, int H, int W,
           int C, int d, cudaStream_t s) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const float inv_c = 1.0f / (float)C;
  const T* a = static_cast<const T*>(f1);
  const T* b = static_cast<const T*>(f2);
  switch (d) {
    case 1: correlation_kernel<T, 1><<<grid, THREADS, 0, s>>>(a, b, out, H, W, C, inv_c); break;
    case 2: correlation_kernel<T, 2><<<grid, THREADS, 0, s>>>(a, b, out, H, W, C, inv_c); break;
    case 3: correlation_kernel<T, 3><<<grid, THREADS, 0, s>>>(a, b, out, H, W, C, inv_c); break;
    case 4: correlation_kernel<T, 4><<<grid, THREADS, 0, s>>>(a, b, out, H, W, C, inv_c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vsr_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int d, int is_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return is_bf16 ? launch<__nv_bfloat16>(f1, f2, o, B, H, W, C, d, s)
                 : launch<float>(f1, f2, o, B, H, W, C, d, s);
}
