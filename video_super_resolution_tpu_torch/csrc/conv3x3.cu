// Fused 3x3 SAME conv (stride 1, any dilation, any Cin and Cout) + f32 bias
// + optional residual + LeakyReLU, on NHWC activations, as an implicit GEMM
// for Hopper (sm_90a): TMA tile loads into a ring of shared-memory stages,
// wgmma on the tensor cores for bf16, FFMA on the CUDA cores for f32.
//
// Replaces: video_super_resolution_tpu/ops/pallas/fused_conv.py,
// _fused_conv_fwd / _conv_kernel (fused_conv3x3), and the math of its
// pixel-pair-packed twin fused_conv3x3_packed / _ppack_conv, whose layout
// only served the TPU's 128 lanes.
//
// What bounds it on an H100: M = B*H*W output pixels, N = Cout, K = 9*Cin.
// At the model's shapes that is 100-400 FLOP per byte moved, so the bf16
// convs are bounded by the tensor-core rate (989 TFLOP/s) and the f32 ones
// by the CUDA-core rate (67 TFLOP/s); Cin = 3 sits below the ridge.
//
// Design. A work item is one BM-pixel x BN-channel output tile (and, with
// split-K, one range of its K steps); persistent blocks, as many as fit on
// the card, walk the items.
// - The BM pixels are a TH x TW rectangle of one image. K runs tap-major:
//   9 taps x ceil(Cin / KC) channel chunks of KC (16/32/64 in bf16, 32 in
//   f32: 32-128 bytes a pixel). For tap (ky, kx) the A tile is the input
//   rectangle shifted by ((ky-1)*d, (kx-1)*d), one 4-D TMA box over
//   (C, W, H, B); the SAME padding, the ragged W/H edge and the channels
//   past Cin are the box's out-of-bounds part, which TMA fills with zeros.
//   No im2col buffer. TMA needs 16-byte pixel strides, so x is read as it
//   is when Cin is a multiple of 8; else conv3x3_stage_kernel
//   first copies it once with its channels zero-padded to a multiple of 8.
//   For Cin <= 3 (the RGB convs) 9 steps of a 16-channel chunk would be
//   mostly padding: that copy folds the 9 taps into 32 channels instead,
//   and the tiled kernel runs one K step at the centre tap.
// - The weights arrive prepared once by the caller (ops/fused_conv.py:
//   prepare_conv3x3_weight) as [tap][chunk][Npad][KC] in the compute dtype,
//   zero past Cin and Cout, so each B tile is one 2-D TMA box.
// - One producer warp keeps up to STAGES (A, B) tile pairs in flight, each
//   completing on its stage's `full` mbarrier; the consumers release a
//   stage on its `empty` mbarrier. The ring runs on across a block's work
//   items, so the next item's loads overlap this item's epilogue. TMA
//   writes the tiles with the swizzle whose span is the row length (KC *
//   element bytes), and the wgmma descriptors name the same swizzle, so no
//   thread touches the operands.
// - bf16: two consumer warpgroups, each 64 rows x BN, issue
//   wgmma.m64nBNk16 with f32 accumulators in registers, one group kept in
//   flight while the previous stage is released. f32: the same ring, and
//   256 threads each accumulate a 16 x BN/16 register tile with FFMA from
//   float4 reads of the swizzled tiles (full f32, no TF32).
// - Split-K: where the output tiles alone would not fill the card, the
//   (tap, chunk) steps of each tile are split over several work items that
//   write f32 partial tiles to a workspace; conv3x3_splitk_reduce sums
//   them in a fixed order (no atomics: f32 results are reproducible) and
//   runs the epilogue.
// - Epilogue: the accumulators go through a shared-memory tile of their
//   own (so the ring keeps loading), then each thread finishes 8
//   consecutive channels of a pixel: + bias, + res (x's dtype or f32,
//   shared by res_repeat consecutive batch items), LeakyReLU, one rounding
//   to x's dtype, 16-byte stores. Where the ring and that tile leave room
//   for a second block on the SM, its products overlap this epilogue.
#include <cuda.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int CONSUMERS = 256;               // two warpgroups
constexpr int THREADS = CONSUMERS + 32;      // + one producer warp

struct Params {
  const float* bias;
  const void* res;
  void* out;
  float* ws;          // split-K partials [splits][M][Npad], or null
  int B, H, W, Cout, Npad, nchunk, taps, tw, tiles_w, tiles_h, dil, kper;
  int mtiles, ntiles, items;   // work items: m tile fastest, then n, split
  float slope;
  int res_repeat, res_f32;
};

template <typename T, int BM, int BN, int KC>
struct Cfg {
  static constexpr int ROW = KC * (int)sizeof(T);          // bytes per tile row
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int B_BYTES = BN * ROW;
  static constexpr int STAGE = (A_BYTES + B_BYTES + 1023) / 1024 * 1024;
  static constexpr int LDC = BN + 8;                       // f32 staging pitch
  static constexpr int EPI = BM * LDC * 4;
  // Four stages, or three where that leaves room for a second block on the
  // SM (its products then overlap this block's epilogue); f32 holds one
  // block an SM (its 16 x BN/16 register tile) and takes three.
  static constexpr int TWO = 112 * 1024;
  static constexpr int STAGES =
      sizeof(T) == 4 ? 3
      : (4 * STAGE + EPI <= TWO || 3 * STAGE + EPI > TWO ? 4 : 3);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + EPI + 2 * STAGES * 8;  // + align slack
};

// One work item: an output tile (TH x TW pixels of image b, channels
// n0 .. n0 + BN) and its split's (tap, chunk) steps kb0 .. kb0 + nk.
struct Tile {
  int b, h0, w0, n0, z, kb0, nk;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int item, int bm) {
  Tile t;
  int m = item % p.mtiles;
  const int rest = item / p.mtiles;
  t.n0 = (rest % p.ntiles) * (p.Npad / p.ntiles);
  t.z = rest / p.ntiles;
  t.w0 = (m % p.tiles_w) * p.tw;
  m /= p.tiles_w;
  t.h0 = (m % p.tiles_h) * (bm / p.tw);
  t.b = m / p.tiles_h;
  t.kb0 = t.z * p.kper;
  t.nk = min(p.taps * p.nchunk - t.kb0, p.kper);   // >= 1 by the host plan
  return t;
}

// 8 consecutive values with 16-byte accesses.
__device__ __forceinline__ void load8(const float* src, float* d) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 c = reinterpret_cast<const float4*>(src)[1];
  d[0] = a.x; d[1] = a.y; d[2] = a.z; d[3] = a.w;
  d[4] = c.x; d[5] = c.y; d[6] = c.z; d[7] = c.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* d) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    d[2 * e] = f.x;
    d[2 * e + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* dst, const float* r) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(r[0], r[1], r[2], r[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(r[4], r[5], r[6], r[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* r) {
  uint4 q;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = __floats2bfloat162_rn(r[2 * e], r[2 * e + 1]);
  *reinterpret_cast<uint4*>(dst) = q;
}

// + bias, + res, LeakyReLU, one rounding, store: 8 channels n .. n + 7 of
// output pixel m (batch item b, pixel index pix within its image), with
// 16-byte accesses when Cout is a multiple of 8, else masked at Cout.
template <typename T>
__device__ __forceinline__ void finish(const Params& p, const float* v,
                                       long long m, int n, int b,
                                       long long pix) {
  const long long HW = (long long)p.H * p.W;
  const long long ri = ((long long)(b / p.res_repeat) * HW + pix) * p.Cout + n;
  T* out = static_cast<T*>(p.out) + m * p.Cout + n;
  if (p.Cout % 8 == 0) {
    float r[8], q[8];
    load8(p.bias + n, r);
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] += v[e];
    if (p.res != nullptr) {
      if (p.res_f32)
        load8(static_cast<const float*>(p.res) + ri, q);
      else
        load8(static_cast<const T*>(p.res) + ri, q);
#pragma unroll
      for (int e = 0; e < 8; ++e) r[e] += q[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = r[e] >= 0.f ? r[e] : p.slope * r[e];
    store8(out, r);
    return;
  }
  for (int e = 0; e < 8 && n + e < p.Cout; ++e) {
    float x = v[e] + p.bias[n + e];
    if (p.res != nullptr)
      x += p.res_f32 ? static_cast<const float*>(p.res)[ri + e]
                     : vsr::to_f32(static_cast<const T*>(p.res)[ri + e]);
    x = x >= 0.f ? x : p.slope * x;
    out[e] = vsr::from_f32<T>(x);
  }
}

template <typename T, int BM, int BN, int KC>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w, const Params p) {
  using C = Cfg<T, BM, BN, KC>;
  constexpr int NS = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* cs = reinterpret_cast<float*>(smem + C::RING);   // epilogue staging
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::RING + C::EPI);
  uint64_t* empty = full + NS;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      vsr::mbar_init(&full[s], 1);
      vsr::mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent blocks: each walks the work items blockIdx.x, + gridDim.x,
  // ...; the ring's stage and phase run on across items, so the producer
  // loads the next item's first tiles while the consumers finish this one.
  if (tid >= CONSUMERS) {
    // producer warp: one thread issues every TMA load
    if (tid == CONSUMERS) {
      int it = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Tile t = tile_of(p, item, BM);
        for (int i = 0; i < t.nk; ++i, ++it) {
          const int s = it % NS;
          if (it >= NS) vsr::mbar_wait(&empty[s], ((it / NS) - 1) & 1);
          unsigned char* st = smem + s * C::STAGE;
          vsr::mbar_arrive_expect_tx(&full[s], C::A_BYTES + C::B_BYTES);
          const int kb = t.kb0 + i;
          // taps == 1: x holds the 9 taps folded, read at the centre tap
          const int tap = p.taps == 9 ? kb / p.nchunk : 4;
          const int ch = p.taps == 9 ? kb - tap * p.nchunk : kb;
          const int ky = tap / 3;
          const int kx = tap - ky * 3;
          vsr::tma_load_4d(st, &map_x, &full[s], ch * KC,
                           t.w0 + (kx - 1) * p.dil, t.h0 + (ky - 1) * p.dil,
                           t.b);
          vsr::tma_load_2d(st + C::A_BYTES, &map_w, &full[s], 0,
                           kb * p.Npad + t.n0);
        }
      }
    }
    return;
  }

  const int lane = tid & 31;
  int it = 0;
  for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
    const Tile t = tile_of(p, item, BM);
    if constexpr (std::is_same_v<T, float>) {
      // ---- f32: FFMA, 16 x BN/16 register tile a thread -----------------
      static_assert(BM == 256 && KC == 32 && BN % 16 == 0, "f32 tile");
      constexpr int NJ = BN / 16;
      const int tx = tid & 15;          // cols tx + 16 j
      const int ty = tid >> 4;          // rows ty + 16 i
      float acc[16][NJ];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
      for (int i = 0; i < t.nk; ++i, ++it) {
        const int s = it % NS;
        vsr::mbar_wait(&full[s], (it / NS) & 1);
        const float* As = reinterpret_cast<const float*>(smem + s * C::STAGE);
        const float* Bs = As + BM * KC;
#pragma unroll 1
        for (int k4 = 0; k4 < KC / 4; ++k4) {
          float4 bv[NJ];
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int n = tx + 16 * j;  // 128-byte rows, 16-byte chunks XOR row
            bv[j] = *reinterpret_cast<const float4*>(Bs + n * KC +
                                                     ((k4 ^ (n & 7)) << 2));
          }
#pragma unroll
          for (int ii = 0; ii < 16; ++ii) {
            const int r = ty + 16 * ii;
            const float4 a = *reinterpret_cast<const float4*>(
                As + r * KC + ((k4 ^ (r & 7)) << 2));
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              float v = acc[ii][j];
              v = fmaf(a.x, bv[j].x, v);
              v = fmaf(a.y, bv[j].y, v);
              v = fmaf(a.z, bv[j].z, v);
              v = fmaf(a.w, bv[j].w, v);
              acc[ii][j] = v;
            }
          }
        }
        __syncwarp();
        if (lane == 0) vsr::mbar_arrive(&empty[s]);
      }
      // the previous item's epilogue has read cs
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
#pragma unroll
      for (int ii = 0; ii < 16; ++ii)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          cs[(ty + 16 * ii) * C::LDC + tx + 16 * j] = acc[ii][j];
    } else {
      // ---- bf16: wgmma, each warpgroup 64 rows x BN ---------------------
      static_assert(BM == 128, "bf16 tile");
      const int wg = tid >> 7;
      float acc[BN / 2];
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) acc[e] = 0.f;
      int prev = 0;
      for (int i = 0; i < t.nk; ++i, ++it) {
        const int s = it % NS;
        vsr::mbar_wait(&full[s], (it / NS) & 1);
        const unsigned char* st = smem + s * C::STAGE;
        const uint64_t da = vsr::smem_desc(st + wg * 64 * C::ROW, C::ROW);
        const uint64_t db = vsr::smem_desc(st + C::A_BYTES, C::ROW);
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) vsr::fence_operand(acc[e]);
        vsr::wgmma_fence();
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)      // +32 bytes along K per step
          vsr::wgmma_bf16<BN>(acc, da + 2 * k, db + 2 * k);
        vsr::wgmma_commit();
#pragma unroll
        for (int e = 0; e < BN / 2; ++e) vsr::fence_operand(acc[e]);
        vsr::wgmma_wait<1>();               // the previous stage is read
        if (i > 0 && lane == 0) vsr::mbar_arrive(&empty[prev]);
        prev = s;
      }
      vsr::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) vsr::fence_operand(acc[e]);
      if (lane == 0) vsr::mbar_arrive(&empty[prev]);
      // the previous item's epilogue has read cs
      asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
      // wgmma D fragment: warp w of the group holds rows 16w..16w+15; per
      // 8-column block j, regs 4j, 4j+1 at (lane/4, 2*(lane%4) + {0, 1})
      // and 4j+2, 4j+3 eight rows lower
      const int row = wg * 64 + ((tid & 127) >> 5) * 16 + (lane >> 2);
      const int col = 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        *reinterpret_cast<float2*>(cs + row * C::LDC + 8 * j + col) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(cs + (row + 8) * C::LDC + 8 * j + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    // ---- epilogue: 8 channels of one pixel a thread, 16-byte stores ------
    constexpr int GROUPS = BN / 8;
    for (int idx = tid; idx < BM * GROUPS; idx += CONSUMERS) {
      const int r = idx / GROUPS;
      const int g = idx - r * GROUPS;
      const int h = t.h0 + r / p.tw;
      const int w = t.w0 + r % p.tw;
      const int n = t.n0 + 8 * g;
      if (h >= p.H || w >= p.W || n >= p.Cout) continue;
      const long long pix = (long long)h * p.W + w;
      const long long m = (long long)t.b * p.H * p.W + pix;
      float v[8];
      load8(cs + r * C::LDC + 8 * g, v);
      if (p.ws != nullptr) {
        store8(p.ws + ((long long)t.z * p.B * p.H * p.W + m) * p.Npad + n, v);
      } else {
        finish<T>(p, v, m, n, t.b, pix);
      }
    }
  }
}

// Staging copy for Cin that TMA cannot read as it is (a pixel row must be
// a multiple of 16 bytes): x (B, H, W, cin) -> xs (B, H, W, cx), channels
// past cin zero. With fold (Cin <= FOLD_CIN, the RGB convs, where 9 steps
// of a mostly empty chunk would be waste), channel (3 * ky + kx) * cin + c
// of xs holds the tap (ky, kx) neighbour's channel c instead (zero outside
// the image), and the tiled kernel runs one K step at the centre tap. One
// thread writes 8 channels of one pixel (a 16-byte store in bf16).
constexpr int FOLD_CIN = 3;
constexpr int FOLD_CX = 32;

template <typename T>
__global__ void __launch_bounds__(256)
conv3x3_stage_kernel(const T* __restrict__ x, T* __restrict__ xs, int B,
                     int H, int W, int cin, int cx, int dil, int fold) {
  const int groups = cx / 8;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;   // < 2^31: host
  const int m = idx / groups;
  if (m >= B * H * W) return;
  const int k0 = 8 * (idx - m * groups);
  const int b = m / (H * W);
  const int pix = m - b * H * W;
  const int h = pix / W;
  const int w = pix - h * W;
  int tap = fold ? k0 / cin : 4;                  // 4: the centre, no shift
  int c = fold ? k0 - tap * cin : k0;
  float v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int ih = h + (tap / 3 - 1) * dil;
    const int iw = w + (tap % 3 - 1) * dil;
    v[e] = tap < 9 && c < cin && ih >= 0 && ih < H && iw >= 0 && iw < W
               ? vsr::to_f32(x[(((long long)b * H + ih) * W + iw) * cin + c])
               : 0.f;
    if (++c == cin && fold) {
      c = 0;
      ++tap;
    }
  }
  store8(xs + (long long)m * cx + k0, v);
}

// Sums the split-K partials of each output in split order, then runs the
// epilogue. One thread per 8 channels of one pixel.
template <typename T>
__global__ void __launch_bounds__(256)
conv3x3_splitk_reduce(const Params p, int splits) {
  const long long HW = (long long)p.H * p.W;
  const long long M = (long long)p.B * HW;
  const int groups = (p.Cout + 7) / 8;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= M * groups) return;
  const long long m = idx / groups;
  const int n = 8 * (int)(idx - m * groups);
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int z = 0; z < splits; ++z) {
    float a[8];
    load8(p.ws + ((long long)z * M + m) * p.Npad + n, a);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += a[e];
  }
  const int b = (int)(m / HW);
  finish<T>(p, v, m, n, b, m - b * HW);
}

// ---- host side -------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ERR_ENCODE = 10000;   // + CUresult of a refused tensor map

struct Launch {
  const void *x, *w;
  int Cx, kc, tw, splits, sms;
  cudaStream_t stream;
};

template <typename T, int BM, int BN, int KC>
int launch(const Launch& L, Params p) {
  using Cf = Cfg<T, BM, BN, KC>;
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ERR_ENCODE + 999;
  const CUtensorMapDataType dt = std::is_same_v<T, float>
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle swz = Cf::ROW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : Cf::ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t es = sizeof(T);
  const int th = BM / L.tw;
  CUtensorMap map_x, map_w;
  {
    const cuuint64_t dims[4] = {(cuuint64_t)L.Cx, (cuuint64_t)p.W,
                                (cuuint64_t)p.H, (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {L.Cx * es, (cuuint64_t)p.W * L.Cx * es,
                                   (cuuint64_t)p.H * p.W * L.Cx * es};
    const cuuint32_t box[4] = {KC, (cuuint32_t)L.tw, (cuuint32_t)th, 1};
    const cuuint32_t one[4] = {1, 1, 1, 1};
    const CUresult r = encode(&map_x, dt, 4, const_cast<void*>(L.x), dims,
                              strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  }
  {
    const cuuint64_t dims[2] = {KC, (cuuint64_t)p.taps * p.nchunk * p.Npad};
    const cuuint64_t strides[1] = {KC * es};
    const cuuint32_t box[2] = {KC, BN};
    const cuuint32_t one[2] = {1, 1};
    const CUresult r = encode(&map_w, dt, 2, const_cast<void*>(L.w), dims,
                              strides, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  }
  auto kern = conv3x3_kernel<T, BM, BN, KC>;
  // per instantiation, once: the shared-memory opt-in and how many blocks
  // fit on an SM
  static int per_sm = 0;
  cudaError_t e = cudaSuccess;
  if (per_sm == 0) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cf::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS,
                                                        Cf::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  }
  p.tw = L.tw;
  p.tiles_w = (p.W + L.tw - 1) / L.tw;
  p.tiles_h = (p.H + th - 1) / th;
  p.mtiles = p.B * p.tiles_w * p.tiles_h;
  p.ntiles = p.Npad / BN;
  const long long items = (long long)p.mtiles * p.ntiles * L.splits;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.items = (int)items;
  const long long slots = (long long)per_sm * L.sms;
  const unsigned grid = (unsigned)(items < slots ? items : slots);
  kern<<<grid, THREADS, Cf::SMEM, L.stream>>>(map_x, map_w, p);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.ws == nullptr) return (int)e;
  const long long outs = (long long)p.B * p.H * p.W * ((p.Cout + 7) / 8);
  conv3x3_splitk_reduce<T><<<(unsigned)((outs + 255) / 256), 256, 0, L.stream>>>(
      p, L.splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stage(const void* x, void* xs, const Params& p, int cin, int cx,
                 int fold, cudaStream_t stream) {
  const long long items = (long long)p.B * p.H * p.W * (cx / 8);
  if (cx % 8 || (fold && (cin > FOLD_CIN || cx != FOLD_CX)) || cin > cx ||
      items > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  conv3x3_stage_kernel<T><<<(unsigned)((items + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(xs), p.B, p.H, p.W, cin, cx,
      p.dil, fold);
  return (int)cudaGetLastError();
}

template <int KC>
int launch_bf16(const Launch& L, const Params& p, int bn) {
  switch (bn) {
    case 16: return launch<__nv_bfloat16, 128, 16, KC>(L, p);
    case 32: return launch<__nv_bfloat16, 128, 32, KC>(L, p);
    case 48: return launch<__nv_bfloat16, 128, 48, KC>(L, p);
    case 64: return launch<__nv_bfloat16, 128, 64, KC>(L, p);
    case 96: return launch<__nv_bfloat16, 128, 96, KC>(L, p);
    case 128: return launch<__nv_bfloat16, 128, 128, KC>(L, p);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: (B, H, W, Cin), 16-byte aligned when read as it is (Cin = Cx, a
// multiple of 8); w: prepared [taps][nchunk][Npad][kc] in x's dtype; bias: f32
// (Cout); res: (B / res_repeat, H, W, Cout) or null; out: (B, H, W, Cout);
// ws: f32 [splits][B*H*W][Npad] when splits > 1, else null. staged: null
// (x read as it is, Cx = Cin), or (B, H, W, Cx) scratch that
// conv3x3_stage_kernel fills from x (Cin channels) first: zero-padded, or
// with fold the 9 taps folded into Cx = 32 channels (Cin <= FOLD_CIN; w
// then prepared as [1][1][Npad][32]). The tile plan (bn, kc, tw, splits)
// comes from ops/fused_conv.py:conv3x3_plan.
extern "C" int vsr_conv3x3(const void* x, const void* w, const void* bias,
                           const void* res, void* out, void* ws, void* staged,
                           int fold, int B, int H, int W, int Cin, int Cx,
                           int Cout, int Npad, int bn, int kc,
                           int tw, int splits, int dil, float slope,
                           int res_repeat, int res_f32, int is_bf16,
                           void* stream) {
  Params p{};
  p.bias = static_cast<const float*>(bias);
  p.res = res;
  p.out = out;
  p.ws = splits > 1 ? static_cast<float*>(ws) : nullptr;
  p.B = B; p.H = H; p.W = W; p.Cout = Cout; p.Npad = Npad;
  p.dil = dil;
  p.slope = slope;
  p.res_repeat = res_repeat;
  p.res_f32 = res_f32;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (staged != nullptr) {
    e = (cudaError_t)(is_bf16 ? launch_stage<__nv_bfloat16>(x, staged, p, Cin,
                                                            Cx, fold, st)
                              : launch_stage<float>(x, staged, p, Cin, Cx,
                                                    fold, st));
    if (e != cudaSuccess) return (int)e;
    x = staged;
  } else if (Cin != Cx || fold) {
    return (int)cudaErrorInvalidValue;
  }
  p.nchunk = (Cx + kc - 1) / kc;
  p.taps = fold ? 1 : 9;
  p.kper = (p.taps * p.nchunk + splits - 1) / splits;
  const Launch L{x, w, Cx, kc, tw, splits, sms, st};
  if (!is_bf16) {
    if (kc != 32) return (int)cudaErrorInvalidValue;
    switch (bn) {
      case 32: return launch<float, 256, 32, 32>(L, p);
      case 48: return launch<float, 256, 48, 32>(L, p);
      case 64: return launch<float, 256, 64, 32>(L, p);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (kc) {
    case 16: return launch_bf16<16>(L, p, bn);
    case 32: return launch_bf16<32>(L, p, bn);
    case 64: return launch_bf16<64>(L, p, bn);
  }
  return (int)cudaErrorInvalidValue;
}
