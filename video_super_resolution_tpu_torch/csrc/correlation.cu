// Local cost-volume correlation on NHWC features, with an optional fused
// LeakyReLU and an f32 or bf16 output:
//   cost[b,y,x,k] = act((1/C) * sum_c f1[b,y,x,c] * f2[b,y+dy,x+dx,c]),
// k row-major over (dy, dx) in [-d, d]^2, f2 zero outside the image, f32
// accumulation, K = (2d+1)^2 channels minor.
//
// Replaces: video_super_resolution_tpu/ops/pallas/correlation_tpu.py,
// _correlation_fwd_pallas / _corr_kernel (correlation_pallas), and the
// flow net's lrelu and cast of its result.
//
// What bounds it on an H100: at d = 4 each output channel is 2C FLOP of f32
// work (FFMA on the CUDA cores, 67 TFLOP/s), and each pixel moves 4C bytes
// of bf16 features in and 162 bytes of bf16 cost out. Bytes bound the small
// levels; at (2, 136, 240, 32) the two bounds are within 20 % of each other,
// so the inner loop must issue several FFMA per shared-memory load.
//
// Design:
// - A block owns a TH x 32 output tile (TH = 4, 2 or 1: the tallest that
//   still gives a block to every SM) of one batch item and ND / DG of its
//   ND = 2d+1 dy rows (DG > 1, dy groups in separate blocks, only where
//   the tiles are fewer than the SMs). Its threads are (8 pixel groups x TH rows) x (ND / DG) dy
//   rows x S channel splits: a thread owns P = 4 adjacent pixels of one row
//   and one dy, with 4 (2d+1) f32 accumulators. It reads each f2 value of
//   its (P + 2d)-pixel window once and uses it for every dx that reaches it
//   (9 FFMA a load at d = 4).
// - Staging: channel chunks of four 16-byte units a pixel (16 f32 or 32
//   bf16 channels) of the f1 tile and of the f2 halo go to shared memory
//   through cp.async (the L1-allocating form, a few percent faster here
//   than the L2-only one) with zero fill for pixels outside the image. All
//   chunks are staged at once when they fit (every level of the serving
//   model); otherwise a ring of up to four chunks loads ahead of the sums.
//   Shared memory holds one plane a unit, pixel p at slot p + p / 4: the 8
//   lanes of a quarter warp read pixels 4 apart, which this padding puts in
//   8 different bank groups, and every load of the inner loop is the
//   thread's base address plus a compile-time offset. bf16 threads read
//   8-byte halves, the two quarter warps of a half warp opposite halves.
//   Features whose pixel rows are not whole 16-byte units (C * size % 16)
//   take scalar loads into the same layout.
// - Channel splits: up to 16 splits of the units inside the block (within
//   32 (2d+1) threads a block and 1024 a SM; 4 / TH with a ring), summed by
//   a fixed-order tree in shared memory, so results are the same bit for
//   bit from call to call; one launch.
// - Epilogue: 1/C, the optional LReLU and the cast, through shared memory:
//   a block with all dy rows stores each output row as aligned 16-byte
//   runs, a block with a dy group each pixel's run of (2d+1) ND / DG
//   channels.
// Staging, sums and epilogue run one after another inside a block; blocks
// overlap only with the other block on their SM (breakdown in PERF.md).
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TW = 32;           // tile width, pixels
constexpr int P = 4;             // adjacent pixels a thread owns
constexpr int GROUPS = TW / P;   // pixel groups a tile row
constexpr int HWP = 40;          // halo row pitch, pixels (>= TW + 2d, d <= 4)
constexpr int UPP = 4;           // 16-byte units a pixel a chunk
constexpr int MAX_TH = 4;
constexpr int SMEM_LIMIT = 100 * 1024;


__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void wait_upto(int pending) {
  if (pending >= N) cp_async_wait<N>();
  else if constexpr (N > 0) wait_upto<N - 1>(pending);
}

__host__ __device__ constexpr int pad(int p) { return p + (p >> 2); }

// Four channels at byte address `a` of shared memory, as f32.
__device__ __forceinline__ void load4(const char* a, float (&f)[4], float) {
  const uint4 v = *reinterpret_cast<const uint4*>(a);
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void load4(const char* a, float (&f)[4], __nv_bfloat16) {
  const uint2 v = *reinterpret_cast<const uint2*>(a);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}

struct Geometry {
  int th, lg_th;          // tile rows
  int ndb, dg;            // dy rows a block, dy groups (blocks) a tile
  int splits;             // channel splits inside a block (a power of two)
  int chunks, units, vec_ok, stages;
  int hplane, tplane;     // slots a unit plane of the halo / of the f1 tile
};

template <typename T, int D>
__global__ void __launch_bounds__(32 * (2 * D + 1), 2)
correlation_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   void* __restrict__ out, int H, int W, int C, Geometry g,
                   float inv_c, float slope, int has_slope, int out_bf16) {
  constexpr int ND = 2 * D + 1;
  constexpr int K = ND * ND;
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int SUBS = VEC / 4;          // 4-channel pieces of a unit
  using Raw = typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type;
  extern __shared__ uint4 smem[];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int grp = tid & (GROUPS - 1);
  const int r = (tid >> 3) & (g.th - 1);
  const int rest = tid >> (3 + g.lg_th);
  const int dy = rest % g.ndb;           // block-local dy row
  const int s = rest / g.ndb;
  const int b = blockIdx.z / g.dg;
  const int dy0 = (blockIdx.z - b * g.dg) * g.ndb;
  const int y0 = blockIdx.y * g.th;
  const int x0 = blockIdx.x * TW;
  const int halo_px = (g.th + g.ndb - 1) * HWP;
  const int tile_px = g.th * TW;
  const int stage_slots = UPP * (g.hplane + g.tplane);

  // Stage channel chunk k (units [4k, 4k + 4)) into ring slot st.
  auto issue = [&](int k, int st) {
    uint4* S = smem + st * stage_slots;
    const int u0 = k * UPP;
    const int n = (halo_px + tile_px) * UPP;
    for (int i = tid; i < n; i += nthreads) {
      const int p = i >> 2;
      const int u = i & (UPP - 1);
      if (u0 + u >= g.units) continue;
      int gy, gx, dst;
      const T* src;
      if (p < halo_px) {
        const int hy = p / HWP;
        const int hx = p - hy * HWP;
        gy = y0 - D + dy0 + hy;
        gx = x0 - D + hx;
        if (hx >= TW + 2 * D) gx = -1;   // pitch padding: never read
        dst = u * g.hplane + pad(p);
        src = f2;
      } else {
        const int q = p - halo_px;
        gy = y0 + (q >> 5);
        gx = x0 + (q & (TW - 1));
        dst = UPP * g.hplane + u * g.tplane + pad(q);
        src = f1;
      }
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* px = src + ((size_t)((size_t)b * H + gy) * W + gx) * C;
      if (g.vec_ok) {
        cp_async16(S + dst, in ? (const void*)(px + (u0 + u) * VEC) : (const void*)src,
                   in ? 16 : 0);
      } else {
        union { uint4 v; Raw e[VEC]; } t;
        const Raw* pr = reinterpret_cast<const Raw*>(px);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int c = (u0 + u) * VEC + e;
          t.e[e] = (in && c < C) ? pr[c] : Raw(0);
        }
        S[dst] = t.v;
      }
    }
    cp_async_commit();
  };

  float acc[P][ND];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < ND; ++j) acc[i][j] = 0.f;

  // Byte offsets of this thread's first f2 and f1 pixel in a unit plane;
  // bf16: quarter warps 1 and 3 start with the upper 8-byte half.
  const int half = SUBS > 1 ? ((tid >> 3) & 1) * 8 : 0;
  const int hoff = pad((r + dy) * HWP + P * grp) * 16 + half;
  const int toff = (UPP * g.hplane + pad(r * TW + P * grp)) * 16 + half;
  auto sum_unit = [&](const char* S, int u) {
    const char* h2 = S + u * g.hplane * 16 + hoff;
    const char* h1 = S + u * g.tplane * 16 + toff;
#pragma unroll
    for (int h = 0; h < SUBS; ++h) {
      const int sub = h == 0 ? 0 : 8 - 2 * half;     // the other half
      float a[P][4];
#pragma unroll
      for (int i = 0; i < P; ++i) load4(h1 + i * 16 + sub, a[i], T());
#pragma unroll
      for (int j = 0; j < P + 2 * D; ++j) {
        float v[4];
        load4(h2 + pad(j) * 16 + sub, v, T());
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < P; ++i) {
            const int dx = j - i;
            if (dx >= 0 && dx < ND) acc[i][dx] = fmaf(a[i][e], v[e], acc[i][dx]);
          }
      }
    }
  };

  const char* base = reinterpret_cast<const char*>(smem);
  for (int k = 0; k < g.stages; ++k) issue(k, k);
  if (g.stages == g.chunks) {
    // Every chunk is resident: split s sums units s, s + S, ... of all.
    cp_async_wait<0>();
    __syncthreads();
    for (int U = s; U < g.units; U += g.splits)
      sum_unit(base + (U >> 2) * stage_slots * 16, U & (UPP - 1));
  } else {
    // Ring: chunk k + stages loads while chunk k is summed; split s sums
    // units s, s + S, ... of each chunk (S <= 4).
    for (int k = 0; k < g.chunks; ++k) {
      wait_upto<3>(min(g.stages - 1, g.chunks - 1 - k));
      __syncthreads();
      const int uend = min(UPP, g.units - k * UPP);
      for (int u = s; u < uend; u += g.splits)
        sum_unit(base + (k % g.stages) * stage_slots * 16, u);
      __syncthreads();
      if (k + g.stages < g.chunks) issue(k + g.stages, k % g.stages);
    }
  }
  __syncthreads();

  // Fixed-order tree reduction of the channel splits: at each step splits
  // [n, 2n) hand their sums to splits [0, n).
  float* part = reinterpret_cast<float*>(smem);
  const int per_split = (GROUPS * g.ndb) << g.lg_th;
  const int ts = tid - s * per_split;
  for (int n = g.splits >> 1; n > 0; n >>= 1) {
    if (s >= n && s < 2 * n) {
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j)
          part[(((s - n) * P + i) * ND + j) * per_split + ts] = acc[i][j];
    }
    __syncthreads();
    if (s < n) {
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < ND; ++j)
          acc[i][j] += part[((s * P + i) * ND + j) * per_split + ts];
    }
    __syncthreads();
  }

  auto act = [&](float v) {
    v *= inv_c;
    return has_slope && !(v > 0.f) ? v * slope : v;
  };
  const int cols = min(TW, W - x0);
  if (g.dg > 1) {
    // A block holds seg = ND / DG * ND of the K channels of each pixel:
    // stage them in shared memory, then store each pixel's run of seg.
    const int seg = g.ndb * ND;
    if (s == 0 && y0 + r < H) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (P * grp + i >= cols) break;
        const int e = (r * TW + P * grp + i) * seg + dy * ND;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          if (out_bf16)
            reinterpret_cast<__nv_bfloat16*>(smem)[e + j] = __float2bfloat16_rn(act(acc[i][j]));
          else
            reinterpret_cast<float*>(smem)[e + j] = act(acc[i][j]);
        }
      }
    }
    __syncthreads();
    const bool wide = nthreads >= seg;
    const int qs = wide ? nthreads / seg : 1;      // pixels stored at once
    const int q0 = wide ? tid / seg : 0;
    const int k0 = wide ? tid - q0 * seg : tid;
    const int ks = wide ? seg : nthreads;
    if (q0 >= qs) return;
    for (int q = q0; q < g.th * TW; q += qs) {
      const int rr = q >> 5, px = q & (TW - 1);
      if (px >= cols || y0 + rr >= H) continue;
      const size_t o = ((size_t)((size_t)b * H + y0 + rr) * W + x0 + px) * K + dy0 * ND;
      for (int k = k0; k < seg; k += ks) {
        if (out_bf16)
          static_cast<uint16_t*>(out)[o + k] = reinterpret_cast<const uint16_t*>(smem)[q * seg + k];
        else
          static_cast<float*>(out)[o + k] = reinterpret_cast<const float*>(smem)[q * seg + k];
      }
    }
    return;
  }

  // Output rows in shared memory, each placed so that element e has the
  // alignment (mod 16 bytes) of its place in `out`.
  const int vece = out_bf16 ? 8 : 4;
  const int row_stride = (TW * K + vece + vece - 1) / vece * vece;
  char* otile = reinterpret_cast<char*>(smem);
  const int esize = out_bf16 ? 2 : 4;
  if (s == 0 && y0 + r < H) {
    const size_t start = ((size_t)((size_t)b * H + y0 + r) * W + x0) * K;
    const int ob = r * row_stride + (int)(start & (vece - 1));
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (P * grp + i >= cols) break;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        const int e = ob + (P * grp + i) * K + dy * ND + j;
        if (out_bf16)
          reinterpret_cast<__nv_bfloat16*>(otile)[e] = __float2bfloat16_rn(act(acc[i][j]));
        else
          reinterpret_cast<float*>(otile)[e] = act(acc[i][j]);
      }
    }
  }
  __syncthreads();
  for (int rr = 0; rr < g.th && y0 + rr < H; ++rr) {
    const size_t start = ((size_t)((size_t)b * H + y0 + rr) * W + x0) * K;
    const int shift = (int)(start & (vece - 1));
    const char* srow = otile + (size_t)(rr * row_stride + shift) * esize;
    char* grow = static_cast<char*>(out) + start * esize;
    const int len = cols * K;
    const int head = min(len, (vece - shift) & (vece - 1));
    const int nvec = (len - head) / vece;
    auto copy1 = [&](int e) {
      if (out_bf16)
        reinterpret_cast<uint16_t*>(grow)[e] = reinterpret_cast<const uint16_t*>(srow)[e];
      else
        reinterpret_cast<uint32_t*>(grow)[e] = reinterpret_cast<const uint32_t*>(srow)[e];
    };
    for (int e = tid; e < head; e += nthreads) copy1(e);
    for (int v = tid; v < nvec; v += nthreads) {
      const int off = (head + v * vece) * esize;
      *reinterpret_cast<uint4*>(grow + off) = *reinterpret_cast<const uint4*>(srow + off);
    }
    for (int e = head + nvec * vece + tid; e < len; e += nthreads) copy1(e);
  }
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// A unit plane of n pixels, in slots, rounded up to 2 mod 8 so that the
// four planes of a pixel start in different bank groups.
int plane(int n) { return (pad(n) + 5) / 8 * 8 + 2; }

// Tile plan: the tallest tile (4, 2, 1 rows) that gives every SM a block;
// dy groups across blocks while the blocks are still fewer than the SMs;
// channel splits inside the block while the grid holds under 1024 threads
// an SM.
template <typename T, int D>
int launch(const void* f1, const void* f2, void* out, int B, int H, int W,
           int C, float slope, int has_slope, int out_bf16, cudaStream_t st) {
  constexpr int ND = 2 * D + 1;
  constexpr int K = ND * ND;
  Geometry g;
  g.units = (C * (int)sizeof(T) + 15) / 16;
  g.chunks = (g.units + UPP - 1) / UPP;
  g.vec_ok = (C * sizeof(T)) % 16 == 0 && (uintptr_t)f1 % 16 == 0 &&
             (uintptr_t)f2 % 16 == 0;
  const int xt = (W + TW - 1) / TW;
  const int sms = sm_count();
  g.lg_th = 2;
  while (g.lg_th > 0 && B * xt * ((H + (1 << g.lg_th) - 1) >> g.lg_th) < sms) --g.lg_th;
  g.th = 1 << g.lg_th;
  const int tiles = B * xt * ((H + g.th - 1) / g.th);
  g.dg = 1;
  while (tiles * g.dg < sms && g.dg < ND) {
    int n = g.dg + 1;
    while (ND % n) ++n;
    g.dg = n;
  }
  g.ndb = ND / g.dg;
  g.hplane = plane((g.th + g.ndb - 1) * HWP);
  g.tplane = plane(g.th * TW);
  const int stage_bytes = UPP * (g.hplane + g.tplane) * 16;
  g.stages = std::min(g.chunks, 4);
  while (g.stages > 1 && g.stages * stage_bytes > SMEM_LIMIT) --g.stages;
  const int per_split = GROUPS * g.th * g.ndb;
  g.splits = 1;
  const int blocks = tiles * g.dg;
  if (g.stages == g.chunks) {
    while (2 * g.splits <= std::min(g.units, 16) && 2 * g.splits * per_split <= 32 * ND &&
           blocks * per_split * g.splits < 1024 * sms)
      g.splits *= 2;
  } else {
    while (2 * g.splits <= MAX_TH / g.th) g.splits *= 2;
  }
  const int threads = per_split * g.splits;
  const int vece = out_bf16 ? 8 : 4;
  const int row_stride = (TW * K + 2 * vece - 1) / vece * vece;
  const int part = g.splits / 2 * P * ND * per_split * 4;
  const int tile = (g.dg > 1 ? g.th * TW * g.ndb * ND : g.th * row_stride) * (out_bf16 ? 2 : 4);
  const int smem = std::max({g.stages * stage_bytes, part, tile});
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(correlation_kernel<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    attr_set = true;
  }
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const dim3 grid(xt, (H + g.th - 1) / g.th, B * g.dg);
  correlation_kernel<T, D><<<grid, threads, smem, st>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), out, H, W, C, g,
      1.0f / (float)C, slope, has_slope, out_bf16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* f1, const void* f2, void* out, int B, int H, int W,
             int C, int d, float slope, int has_slope, int out_bf16,
             cudaStream_t s) {
  switch (d) {
    case 1: return launch<T, 1>(f1, f2, out, B, H, W, C, slope, has_slope, out_bf16, s);
    case 2: return launch<T, 2>(f1, f2, out, B, H, W, C, slope, has_slope, out_bf16, s);
    case 3: return launch<T, 3>(f1, f2, out, B, H, W, C, slope, has_slope, out_bf16, s);
    case 4: return launch<T, 4>(f1, f2, out, B, H, W, C, slope, has_slope, out_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vsr_correlation(const void* f1, const void* f2, void* out,
                               int B, int H, int W, int C, int d, int is_bf16,
                               float slope, int has_slope, int out_bf16,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch<__nv_bfloat16>(f1, f2, out, B, H, W, C, d, slope, has_slope, out_bf16, s)
             : dispatch<float>(f1, f2, out, B, H, W, C, d, slope, has_slope, out_bf16, s);
}
