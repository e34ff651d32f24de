// Fused 3x3 SAME conv (stride 1, any dilation, any Cin) + bias + optional
// residual + LeakyReLU, on NHWC activations and HWIO weights.
//
// Replaces: video_super_resolution_tpu/ops/pallas/fused_conv.py,
// _fused_conv_fwd / _conv_kernel (fused_conv3x3), and the math of its
// pixel-pair-packed twin fused_conv3x3_packed / _ppack_conv, whose layout
// only served the TPU's 128 lanes.
//
// What bounds it on an H100: at the model's shapes (Cin, Cout 32..565 over
// 10^4..10^6 pixels) the conv is an implicit GEMM of M = B*H*W, N = Cout,
// K = 9*Cin with 100-400 FLOP per byte moved, so it is bounded by the
// tensor-core rate in bf16 and by the CUDA-core f32 rate in f32 (above the
// 295 FLOP/byte ridge in bf16 for the wide convs, below it for Cin = 3).
//
// Design: one 256-thread block per BM x BN = 128 x 64 output tile. The K
// loop stages a 128 x 32 im2col slice of x (zero outside the image, so the
// SAME padding costs no copy) and a 32 x 64 slice of the HWIO weights in
// shared memory; bf16 multiplies on the tensor cores through WMMA 16x16x16
// fragments (each warp a 32 x 32 sub-tile) with f32 accumulation, f32 on
// the CUDA cores (each thread an 8 x 4 micro-tile). The accumulator tile
// goes through shared memory to an epilogue that adds bias and the
// residual, applies LeakyReLU, rounds once to the storage type and writes
// coalesced rows of Cout. The residual `res` is (B / res_repeat, H, W,
// Cout), shared by res_repeat consecutive batch items, in the input dtype
// or f32. Simple first: scalar global loads, no cp.async/TMA pipeline and
// no wgmma yet.
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;   // padded shared-memory row pitches
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int SMEM_IN = (BM * A_LD + BK * B_LD) * 4;   // f32 worst case
constexpr int SMEM_OUT = BM * C_LD * 4;
constexpr int SMEM_BYTES = SMEM_IN > SMEM_OUT ? SMEM_IN : SMEM_OUT;

template <typename T, bool kTensorCore>
__global__ void __launch_bounds__(THREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, const void* __restrict__ res,
               T* __restrict__ out, int B, int H, int W, int Cin, int Cout,
               int dil, float slope, int res_repeat, int res_f32) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  T (*As)[A_LD] = reinterpret_cast<T (*)[A_LD]>(smem);
  T (*Bs)[B_LD] = reinterpret_cast<T (*)[B_LD]>(smem + sizeof(T) * BM * A_LD);
  float (*Cs)[C_LD] = reinterpret_cast<float (*)[C_LD]>(smem);

  const int tid = threadIdx.x;
  const long long HW = (long long)H * W;
  const long long M = (long long)B * HW;
  const int K = 9 * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T zero = vsr::from_f32<T>(0.f);

  // im2col loads: each thread fills 16 consecutive k of one tile row
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 16;
  const long long am = m0 + a_row;
  const bool a_valid = am < M;
  int ab = 0, ay = 0, ax = 0;
  if (a_valid) {
    ab = (int)(am / HW);
    const int r = (int)(am - (long long)ab * HW);
    ay = r / W;
    ax = r - ay * W;
  }
  const T* xb = x + (long long)ab * HW * Cin;
  // weight loads: each thread fills 8 consecutive n of one tile row
  const int b_k = tid >> 3;
  const int b_n = (tid & 7) * 8;

  // tensor-core path: 8 warps as 4 (M) x 2 (N), 32 x 32 each
  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  // CUDA-core path: 16 x 16 threads, rows ty + 16 i, cols tx + 16 j
  const int tx = tid & 15;
  const int ty = tid >> 4;

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc_tc[2][2];
  float acc[8][4];
  if constexpr (kTensorCore) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc_tc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    {
      const int k = k0 + a_k;
      int tap = k / Cin;
      int ci = k - tap * Cin;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        T v = zero;
        if (a_valid && tap < 9) {
          const int ky = tap / 3;
          const int kx = tap - ky * 3;
          const int iy = ay + (ky - 1) * dil;
          const int ix = ax + (kx - 1) * dil;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            v = xb[((long long)iy * W + ix) * Cin + ci];
        }
        As[a_row][a_k + i] = v;
        if (++ci == Cin) {
          ci = 0;
          ++tap;
        }
      }
    }
    {
      const int k = k0 + b_k;
      const T* wr = w + (long long)k * Cout;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + b_n + j;
        Bs[b_k][b_n + j] = (k < K && n < Cout) ? wr[n] : zero;
      }
    }
    __syncthreads();
    if constexpr (kTensorCore) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T,
                               nvcuda::wmma::row_major> fa[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T,
                               nvcuda::wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(fa[i], &As[wm * 32 + i * 16][kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::load_matrix_sync(fb[j], &Bs[kk][wn * 32 + j * 16], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            nvcuda::wmma::mma_sync(acc_tc[i][j], fa[i], fb[j], acc_tc[i][j]);
      }
    } else {
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = vsr::to_f32(As[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = vsr::to_f32(Bs[kk][tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // accumulators -> shared memory (aliases the input tiles, now dead)
  if constexpr (kTensorCore) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(&Cs[wm * 32 + i * 16][wn * 32 + j * 16],
                                        acc_tc[i][j], C_LD,
                                        nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[ty + 16 * i][tx + 16 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: + bias (+ res) -> LeakyReLU -> one rounding -> store
  for (int idx = tid; idx < BM * BN; idx += THREADS) {
    const int r = idx / BN;
    const int c = idx - r * BN;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= M || n >= Cout) continue;
    float v = Cs[r][c] + bias[n];
    if (res != nullptr) {
      const long long b = m / HW;
      const long long pix = m - b * HW;
      const long long ri = ((b / res_repeat) * HW + pix) * Cout + n;
      v += res_f32 ? static_cast<const float*>(res)[ri]
                   : vsr::to_f32(static_cast<const T*>(res)[ri]);
    }
    v = v >= 0.f ? v : slope * v;
    out[m * Cout + n] = vsr::from_f32<T>(v);
  }
}

}  // namespace

extern "C" int vsr_conv3x3(const void* x, const void* w, const void* bias,
                           const void* res, void* out, int B, int H, int W,
                           int Cin, int Cout, int dil, float slope,
                           int res_repeat, int res_f32, int is_bf16,
                           void* stream) {
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv3x3_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), res, static_cast<__nv_bfloat16*>(out),
        B, H, W, Cin, Cout, dil, slope, res_repeat, res_f32);
  } else {
    conv3x3_kernel<float, false><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), res, static_cast<float*>(out),
        B, H, W, Cin, Cout, dil, slope, res_repeat, res_f32);
  }
  return (int)cudaGetLastError();
}
