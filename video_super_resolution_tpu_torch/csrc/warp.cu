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
// What bounds it on an H100: it moves (2 C + 8) x 4 bytes a pixel for
// about 7 C FLOP, far below the ridge, so memory bandwidth bounds it; the
// gathered taps of smooth flow fall on nearby rows and hit in L2.
//
// Design: one thread per output element (pixel, channel), channel
// fastest, so a warp's stores and the taps it reads for one pixel are
// contiguous runs of C. Each thread recomputes its pixel's coordinates
// (two loads of the flow, which neighbouring threads share through L1).
// The blend is written with explicit round-to-nearest multiplies and adds
// (no fused multiply-add), in the order of the plain PyTorch version, so
// that f32 results match it bit for bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
warp_kernel(const T* __restrict__ img, const float* __restrict__ flow,
            T* __restrict__ out, int H, int W, int C, int zeros,
            long long total) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const long long p = i / C;             // (b * H + y) * W + x
  const int c = (int)(i - p * C);
  const long long row = p / W;
  const int xq = (int)(p - row * W);
  const int yq = (int)(row % H);
  const long long base = (row / H) * H * (long long)W;

  const float sx = __fadd_rn((float)xq, flow[2 * p]);
  const float sy = __fadd_rn((float)yq, flow[2 * p + 1]);
  const float x0 = floorf(sx), y0 = floorf(sy);
  const float wx = __fsub_rn(sx, x0), wy = __fsub_rn(sy, y0);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);

  auto tap = [&](float yi, float xi) -> float {
    const bool valid = xi >= 0.f && xi <= (float)(W - 1) && yi >= 0.f &&
                       yi <= (float)(H - 1);
    if (zeros && !valid) return 0.f;
    const int xc = (int)fminf(fmaxf(xi, 0.f), (float)(W - 1));
    const int yc = (int)fminf(fmaxf(yi, 0.f), (float)(H - 1));
    return vsr::to_f32(img[(base + (long long)yc * W + xc) * C + c]);
  };
  const float t00 = tap(y0, x0), t01 = tap(y0, x1);
  const float t10 = tap(y1, x0), t11 = tap(y1, x1);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  const float w00 = __fmul_rn(uy, ux), w01 = __fmul_rn(uy, wx);
  const float w10 = __fmul_rn(wy, ux), w11 = __fmul_rn(wy, wx);
  float v = __fmul_rn(w00, t00);
  v = __fadd_rn(v, __fmul_rn(w01, t01));
  v = __fadd_rn(v, __fmul_rn(w10, t10));
  v = __fadd_rn(v, __fmul_rn(w11, t11));
  out[i] = vsr::from_f32<T>(v);
}

}  // namespace

extern "C" int vsr_warp(const void* img, const void* flow, void* out, int B,
                        int H, int W, int C, int zeros, int is_bf16,
                        void* stream) {
  const long long total = (long long)B * H * W * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  if (is_bf16) {
    warp_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(img), f,
        static_cast<__nv_bfloat16*>(out), H, W, C, zeros, total);
  } else {
    warp_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(img), f, static_cast<float*>(out), H, W, C,
        zeros, total);
  }
  return (int)cudaGetLastError();
}
