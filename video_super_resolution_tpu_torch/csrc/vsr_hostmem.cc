// A numpy memory handler (NEP 49) that recycles one large block of host
// memory, for the serving entry's returned clip.
//
// ``api.upscale_clip`` sets it only around the clip's one ``np.empty``.
// Each array keeps the handler it was allocated with, so numpy calls
// ``recycler_free`` when the clip's last view or export is gone. The
// handler keeps at most one idle block: the largest freed so far that is
// at least ``vsr_hostmem_floor`` bytes. A request that fits in it takes it,
// with its pages already faulted; any other request, and any block not
// kept, goes to numpy's default handler (``vsr_hostmem_init``), so a miss
// costs what ``np.empty`` costs. numpy reports only an array's own size on
// free, so each lent block's capacity is tracked here.
//
// The handler and its name are static: arrays hold them past the module
// that installed them, up to the interpreter's exit. The state is never
// destroyed for the same reason. Includes the C++ standard library only:
// the two structs below copy numpy's ``ndarraytypes.h``.

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>

namespace {

struct Allocator {                   // numpy's PyDataMemAllocator
  void* ctx;
  void* (*malloc)(void* ctx, size_t size);
  void* (*calloc)(void* ctx, size_t nelem, size_t elsize);
  void* (*realloc)(void* ctx, void* ptr, size_t new_size);
  void (*free)(void* ctx, void* ptr, size_t size);
};

struct Handler {                     // numpy's PyDataMem_Handler, version 1
  char name[127];
  uint8_t version;
  Allocator allocator;
};

struct State {
  std::mutex mu;
  const Allocator* base = nullptr;   // numpy's default handler
  void* idle = nullptr;              // the one kept block, or null
  size_t idle_cap = 0;
  std::unordered_map<void*, size_t> lent;   // block -> capacity
  unsigned long long hits = 0;       // requests served by the idle block
};

State& state() {
  static State* s = new State;       // never destroyed: see above
  return *s;
}

// Under s.mu: the idle block if ``size`` fits in it, else null.
void* take_idle(State& s, size_t size) {
  if (s.idle == nullptr || size > s.idle_cap) return nullptr;
  void* p = s.idle;
  s.lent[p] = s.idle_cap;
  s.idle = nullptr;
  s.idle_cap = 0;
  ++s.hits;
  return p;
}

void* lend(State& s, void* p, size_t cap) {
  if (p != nullptr) s.lent[p] = cap;
  return p;
}

}  // namespace

extern "C" {

size_t vsr_hostmem_floor = size_t(64) << 20;   // blocks below it are not kept

static void* recycler_malloc(void*, size_t size) {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  if (void* p = take_idle(s, size)) return p;
  return lend(s, s.base->malloc(s.base->ctx, size), size);
}

static void* recycler_calloc(void*, size_t nelem, size_t elsize) {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  if (elsize != 0 && nelem > SIZE_MAX / elsize) return nullptr;
  if (void* p = take_idle(s, nelem * elsize)) {
    std::memset(p, 0, nelem * elsize);
    return p;
  }
  return lend(s, s.base->calloc(s.base->ctx, nelem, elsize), nelem * elsize);
}

static void* recycler_realloc(void*, void* ptr, size_t new_size) {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  if (ptr == nullptr) {
    if (void* p = take_idle(s, new_size)) return p;
    return lend(s, s.base->malloc(s.base->ctx, new_size), new_size);
  }
  auto it = s.lent.find(ptr);
  if (it != s.lent.end() && new_size <= it->second) return ptr;   // fits
  void* p = s.base->realloc(s.base->ctx, ptr, new_size);
  if (p == nullptr) return nullptr;                  // ptr is still lent
  if (it != s.lent.end()) s.lent.erase(it);
  return lend(s, p, new_size);
}

static void recycler_free(void*, void* ptr, size_t size) {
  if (ptr == nullptr) return;
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  auto it = s.lent.find(ptr);
  if (it == s.lent.end()) {          // not lent here: nothing to keep
    s.base->free(s.base->ctx, ptr, size);
    return;
  }
  size_t cap = it->second;
  s.lent.erase(it);
  if (cap < vsr_hostmem_floor || cap <= s.idle_cap) {
    s.base->free(s.base->ctx, ptr, cap);
    return;
  }
  if (s.idle != nullptr) s.base->free(s.base->ctx, s.idle, s.idle_cap);
  s.idle = ptr;
  s.idle_cap = cap;
}

static Handler handler = {
    "vsr_clip_recycler", 1,
    {nullptr, recycler_malloc, recycler_calloc, recycler_realloc,
     recycler_free}};
static const char capsule_name[] = "mem_handler";

// The handler, after pointing it at numpy's default handler ``base``
// (a PyDataMem_Handler*); ``name`` gets the capsule name numpy expects.
void* vsr_hostmem_init(const void* base, const char** name) {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  s.base = &static_cast<const Handler*>(base)->allocator;
  *name = capsule_name;
  return &handler;
}

// stats: idle block's capacity (0: none), blocks lent, idle-block hits.
void vsr_hostmem_stats(unsigned long long* out) {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  out[0] = s.idle_cap;
  out[1] = s.lent.size();
  out[2] = s.hits;
}

// Give the idle block back to numpy's default handler.
void vsr_hostmem_release() {
  State& s = state();
  std::lock_guard<std::mutex> g(s.mu);
  if (s.idle != nullptr) s.base->free(s.base->ctx, s.idle, s.idle_cap);
  s.idle = nullptr;
  s.idle_cap = 0;
}

}  // extern "C"
