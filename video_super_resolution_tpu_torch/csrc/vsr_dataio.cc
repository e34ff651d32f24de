// Native data path of the PyTorch port: a copy of the JAX package's
// native/vsr_dataio.cc with one part replaced. Kept as it is there: the C ABI
// (vsr_decode_png, vsr_free, vsr_resize_bicubic_aa, vsr_loader_create /
// next / destroy), the MATLAB-preset antialiased bicubic (a=-0.5, replicate
// edges), the frame cache with its own victim RNG and VSR_LOADER_CACHE_MB,
// splitmix64, make_sample (random crop, flips, window assembly) and the
// pthread worker pool with its bounded prefetch queue; so the same seed gives
// the same batches, bit for bit.
//
// Replaced: decode_png_rgb, which called libpng, now calls the
// self-contained decoder of png_decode.h. It yields the same bytes as the
// libpng transforms it replaces (save for a gray, RGB or palette image with
// tRNS, which the libpng reader scrambles: see png_decode.h), and the
// library needs only g++ and the C++ standard library (no png.h, no zlib),
// so it builds where libpng is absent. The bytes become float32 [0,1] as before, byte * (1/255.f).
//
// C ABI only (loaded via ctypes). All arrays are float32, HWC / T-major,
// caller-allocated unless stated.

#include "png_decode.h"

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <new>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ----------------------------- PNG decode --------------------------------

bool decode_png_rgb(const char* path, std::vector<float>* out, int* h,
                    int* w) {
  std::vector<uint8_t> file, rgb;
  try {
    if (!vsr_png::read_file(path, &file) ||
        !vsr_png::decode_rgb8(file.data(), file.size(), &rgb, h, w))
      return false;
    out->resize(rgb.size());
  } catch (const std::bad_alloc&) {
    return false;
  }
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0; i < rgb.size(); ++i) (*out)[i] = rgb[i] * inv;
  return true;
}

// --------------------- MATLAB-style bicubic resample ----------------------

inline double cubic(double x, double a) {
  double ax = std::fabs(x);
  if (ax <= 1.0) return (a + 2) * ax * ax * ax - (a + 3) * ax * ax + 1;
  if (ax < 2.0)
    return a * ax * ax * ax - 5 * a * ax * ax + 8 * a * ax - 4 * a;
  return 0.0;
}

struct ResampleWeights {
  int k;                      // taps per output index
  std::vector<int> idx;       // (out, k) clamped source indices
  std::vector<float> w;       // (out, k)
};

ResampleWeights make_weights(int in_size, int out_size, double a,
                             bool antialias) {
  ResampleWeights rw;
  double scale = double(in_size) / out_size;
  double support = 2.0;
  double s = (antialias && scale > 1.0) ? scale : 1.0;
  int k = int(std::ceil(support * s)) * 2 + 2;
  rw.k = k;
  rw.idx.resize(size_t(out_size) * k);
  rw.w.resize(size_t(out_size) * k);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) * scale - 0.5;
    long first = long(std::floor(center - support * s)) + 1;
    double wsum = 0.0;
    std::vector<double> tmp(k);
    for (int t = 0; t < k; ++t) {
      double dist = (center - (first + t)) / s;
      tmp[t] = cubic(dist, a);
      wsum += tmp[t];
    }
    for (int t = 0; t < k; ++t) {
      long src = first + t;
      if (src < 0) src = 0;
      if (src > in_size - 1) src = in_size - 1;
      rw.idx[size_t(i) * k + t] = int(src);
      rw.w[size_t(i) * k + t] = float(tmp[t] / wsum);
    }
  }
  return rw;
}

// Separable resample: H then W. src (h, w, 3) -> dst (oh, ow, 3).
void resize_bicubic_aa(const float* src, int h, int w, float* dst, int oh,
                       int ow, double a = -0.5) {
  ResampleWeights rh = make_weights(h, oh, a, true);
  ResampleWeights rw = make_weights(w, ow, a, true);
  std::vector<float> tmp(size_t(oh) * w * 3, 0.f);
  for (int y = 0; y < oh; ++y) {
    float* trow = tmp.data() + size_t(y) * w * 3;
    for (int t = 0; t < rh.k; ++t) {
      const float wt = rh.w[size_t(y) * rh.k + t];
      const float* srow = src + size_t(rh.idx[size_t(y) * rh.k + t]) * w * 3;
      for (int x = 0; x < w * 3; ++x) trow[x] += wt * srow[x];
    }
  }
  for (int y = 0; y < oh; ++y) {
    const float* trow = tmp.data() + size_t(y) * w * 3;
    float* drow = dst + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      float acc[3] = {0.f, 0.f, 0.f};
      for (int t = 0; t < rw.k; ++t) {
        const float wt = rw.w[size_t(x) * rw.k + t];
        const float* p = trow + size_t(rw.idx[size_t(x) * rw.k + t]) * 3;
        acc[0] += wt * p[0];
        acc[1] += wt * p[1];
        acc[2] += wt * p[2];
      }
      float* q = drow + size_t(x) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = acc[c];
        q[c] = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
      }
    }
  }
}

// ------------------------------ loader -----------------------------------

struct Sample {
  std::vector<float> lr;  // (T, ch, cw, 3)
  std::vector<float> hr;  // (ch*s, cw*s, 3)
};

uint64_t next_rand(uint64_t* s);

// Bounded cache of decoded HR frames and their LR degradations, keyed by
// global frame id. Without it every sample re-decodes window PNGs and
// re-runs the FULL-frame antialias bicubic (measured round 4: 2.8
// batches/s host-driven vs ~50 device-side — the loader, not the chip,
// was the training bottleneck). Typical epochs revisit every frame many
// times; with the cache a warm sample is crop+copy only. Eviction:
// random victim until under budget (an LRU chain buys little for uniform
// random sampling and costs a lock-held list splice per hit).
struct FrameCache {
  struct Entry {
    std::vector<float> hr, lr;
    int h = 0, w = 0;
  };
  std::unordered_map<uint64_t, std::shared_ptr<Entry>> map;
  std::mutex mu;
  size_t bytes = 0, max_bytes = size_t(1024) << 20;
  // Victim-selection RNG, OWN state (seeded from the loader seed at
  // create). Drawing victims from the calling worker's sample RNG made the
  // number of next_rand() calls per sample depend on shared cache state —
  // with multiple workers, each worker's sample/augmentation stream
  // (previously a pure function of (seed, wid)) became timing-dependent
  // once the cache filled, breaking fixed-seed reproducibility (ADVICE r4
  // low #1). Guarded by `mu` like everything else here.
  uint64_t rng = 0x243F6A8885A308D3ull;

  std::shared_ptr<Entry> get(uint64_t key) {
    std::lock_guard<std::mutex> lk(mu);
    auto it = map.find(key);
    return it == map.end() ? nullptr : it->second;
  }
  void put(uint64_t key, std::shared_ptr<Entry> e) {
    const size_t sz = (e->hr.size() + e->lr.size()) * sizeof(float);
    std::lock_guard<std::mutex> lk(mu);
    while (bytes + sz > max_bytes && !map.empty()) {
      auto victim = map.begin();
      std::advance(victim, next_rand(&rng) % map.size());
      bytes -= (victim->second->hr.size() + victim->second->lr.size()) *
               sizeof(float);
      map.erase(victim);
    }
    if (map.emplace(key, std::move(e)).second) bytes += sz;
  }
};

struct Loader {
  // dataset layout
  std::vector<std::vector<std::string>> clips;  // clip -> frame paths (HR)
  int window = 3, scale = 4, crop = 64;
  bool augment = true;
  // prefetch machinery
  int batch = 4;
  size_t max_queue = 4;
  std::deque<std::vector<Sample>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seed{0};
  std::string error;
  FrameCache cache;
  std::vector<int> clip_offsets;  // clip -> global frame id base

  ~Loader() { shutdown(); }

  void shutdown() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    workers.clear();
  }
};

uint64_t next_rand(uint64_t* s) {  // splitmix64
  *s += 0x9E3779B97f4A7C15ull;
  uint64_t z = *s;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Decoded+degraded frame via the loader cache (decode/degrade on miss).
std::shared_ptr<FrameCache::Entry> load_frame(Loader* L, int ci, int fi) {
  uint64_t key = uint64_t(L->clip_offsets[ci] + fi);
  if (auto e = L->cache.get(key)) return e;
  auto e = std::make_shared<FrameCache::Entry>();
  if (!decode_png_rgb(L->clips[ci][fi].c_str(), &e->hr, &e->h, &e->w))
    return nullptr;
  const int lh = e->h / L->scale, lw = e->w / L->scale;
  e->lr.resize(size_t(lh) * lw * 3);
  resize_bicubic_aa(e->hr.data(), e->h, e->w, e->lr.data(), lh, lw);
  L->cache.put(key, e);
  return e;
}

bool make_sample(Loader* L, uint64_t* rng, Sample* out) {
  const int T = L->window, s = L->scale, c = L->crop;
  int ci = int(next_rand(rng) % L->clips.size());
  const auto& frames = L->clips[ci];
  int nf = int(frames.size());
  int center = int(next_rand(rng) % nf);

  // load HR window (replicate edge policy) through the frame cache
  std::vector<std::shared_ptr<FrameCache::Entry>> win(T);
  int h = 0, w = 0;
  for (int t = 0; t < T; ++t) {
    int fi = center - T / 2 + t;
    if (fi < 0) fi = 0;
    if (fi > nf - 1) fi = nf - 1;
    win[t] = load_frame(L, ci, fi);
    if (!win[t]) return false;
    if (t == 0) {
      h = win[t]->h;
      w = win[t]->w;
    } else if (win[t]->h != h || win[t]->w != w) {
      return false;
    }
  }
  int lh = h / s, lw = w / s;
  if (lh < c || lw < c) return false;

  // crop the cached LR frames
  int y0 = int(next_rand(rng) % (lh - c + 1));
  int x0 = int(next_rand(rng) % (lw - c + 1));
  bool hflip = L->augment && (next_rand(rng) & 1);
  bool vflip = L->augment && (next_rand(rng) & 1);
  bool trev = L->augment && (next_rand(rng) & 1);

  out->lr.assign(size_t(T) * c * c * 3, 0.f);
  for (int t = 0; t < T; ++t) {
    int tt = trev ? (T - 1 - t) : t;
    const float* lr_full = win[tt]->lr.data();
    for (int y = 0; y < c; ++y) {
      int sy = vflip ? (y0 + c - 1 - y) : (y0 + y);
      for (int x = 0; x < c; ++x) {
        int sx = hflip ? (x0 + c - 1 - x) : (x0 + x);
        const float* p = lr_full + (size_t(sy) * lw + sx) * 3;
        float* q = out->lr.data() + ((size_t(t) * c + y) * c + x) * 3;
        q[0] = p[0];
        q[1] = p[1];
        q[2] = p[2];
      }
    }
  }
  // HR center crop (frame index center stays center under temporal reverse)
  const std::vector<float>& hc = win[T / 2]->hr;
  int C = c * s;
  out->hr.assign(size_t(C) * C * 3, 0.f);
  for (int y = 0; y < C; ++y) {
    int sy = vflip ? (y0 * s + C - 1 - y) : (y0 * s + y);
    for (int x = 0; x < C; ++x) {
      int sx = hflip ? (x0 * s + C - 1 - x) : (x0 * s + x);
      const float* p = hc.data() + (size_t(sy) * w + sx) * 3;
      float* q = out->hr.data() + (size_t(y) * C + x) * 3;
      q[0] = p[0];
      q[1] = p[1];
      q[2] = p[2];
    }
  }
  return true;
}

void worker_main(Loader* L, int wid) {
  uint64_t rng = L->seed.load() + 0x1234567ull * (wid + 1);
  while (!L->stop.load()) {
    std::vector<Sample> batch(L->batch);
    bool ok = true;
    for (int i = 0; i < L->batch && ok; ++i)
      ok = make_sample(L, &rng, &batch[i]);
    if (!ok) continue;  // skip bad samples (undersized clips etc.)
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_push.wait(lk, [L] {
      return L->stop.load() || L->queue.size() < L->max_queue;
    });
    if (L->stop.load()) return;
    L->queue.push_back(std::move(batch));
    L->cv_pop.notify_one();
  }
}

}  // namespace

extern "C" {

// Decode one PNG to float32 RGB [0,1]. Returns 0 on failure. On success the
// caller must free the buffer with vsr_free. h/w are outputs.
float* vsr_decode_png(const char* path, int* h, int* w) {
  auto* v = new std::vector<float>();
  if (!decode_png_rgb(path, v, h, w)) {
    delete v;
    return nullptr;
  }
  // Transfer ownership: stash the vector pointer just before the data? keep
  // it simple: copy into malloc'd memory.
  float* out = static_cast<float*>(malloc(v->size() * sizeof(float)));
  memcpy(out, v->data(), v->size() * sizeof(float));
  delete v;
  return out;
}

void vsr_free(void* p) { free(p); }

// MATLAB-preset antialias bicubic downscale, clamped to [0,1].
// src (h, w, 3) float32 -> dst (oh, ow, 3) float32 (caller-allocated).
void vsr_resize_bicubic_aa(const float* src, int h, int w, float* dst, int oh,
                           int ow) {
  resize_bicubic_aa(src, h, w, dst, oh, ow);
}

// ---- threaded sliding-window loader ----
// paths: flat array of frame paths; clip_sizes: frames per clip.
void* vsr_loader_create(const char** paths, const int* clip_sizes,
                        int num_clips, int window, int scale, int crop,
                        int batch, int augment, int num_workers,
                        uint64_t seed) {
  auto* L = new Loader();
  int off = 0;
  for (int i = 0; i < num_clips; ++i) {
    std::vector<std::string> fr;
    L->clip_offsets.push_back(off);
    for (int j = 0; j < clip_sizes[i]; ++j) fr.emplace_back(paths[off++]);
    L->clips.push_back(std::move(fr));
  }
  if (const char* mb = getenv("VSR_LOADER_CACHE_MB"))
    L->cache.max_bytes = size_t(atoll(mb)) << 20;
  L->window = window;
  L->scale = scale;
  L->crop = crop;
  L->batch = batch;
  L->augment = augment != 0;
  L->seed.store(seed);
  L->cache.rng = seed ^ 0x243F6A8885A308D3ull;  // own stream (see FrameCache)
  for (int i = 0; i < num_workers; ++i)
    L->workers.emplace_back(worker_main, L, i);
  return L;
}

// Blocks until a batch is ready; writes into caller buffers:
// lr (batch, T, crop, crop, 3), hr (batch, crop*s, crop*s, 3). Returns 0 on
// shutdown.
int vsr_loader_next(void* handle, float* lr, float* hr) {
  auto* L = static_cast<Loader*>(handle);
  std::vector<Sample> batch;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_pop.wait(lk, [L] { return L->stop.load() || !L->queue.empty(); });
    if (L->queue.empty()) return 0;
    batch = std::move(L->queue.front());
    L->queue.pop_front();
    L->cv_push.notify_one();
  }
  size_t lr_n = batch[0].lr.size(), hr_n = batch[0].hr.size();
  for (size_t i = 0; i < batch.size(); ++i) {
    memcpy(lr + i * lr_n, batch[i].lr.data(), lr_n * sizeof(float));
    memcpy(hr + i * hr_n, batch[i].hr.data(), hr_n * sizeof(float));
  }
  return int(batch.size());
}

void vsr_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->shutdown();
  delete L;
}

}  // extern "C"
