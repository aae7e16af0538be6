// Shared-memory object store: a single mmap'd arena shared by every process on a
// node, with an in-shm object index and allocator so create/seal/get/release are
// direct memory operations — no broker round-trip.
//
// Parity: reference `src/ray/object_manager/plasma/` (PlasmaStore store.h:55,
// dlmalloc arena, eviction_policy.h LRU, create_request_queue.h backpressure).
// Design departure: plasma brokers create/get through a unix-socket server and
// passes fds; here clients map the arena directly and synchronize through
// robust pthread mutexes in shm, which removes the per-op socket round trip
// (the main cost in plasma's put/get calls/s) while keeping zero-copy reads.
//
// Concurrency: the index and allocator are SHARDED. Object ids hash to one of
// N shards, each with its own robust mutex, slot-table segment, and small-block
// cache (fastbins + a free list refilled in chunks), so concurrent create/get/
// release from many clients only contend when their ids collide on a shard —
// the plasma-era single store mutex serialized every client on one lock.
// Large blocks (> small_max) come from a global extent allocator under its own
// mutex; its critical sections are pointer splices (microseconds), so even
// GB-scale puts from many clients overlap their copies fully.
//
// Layout:
//   [Header | shard headers[N] | slot tables (per-shard segments) | arena]
// Free blocks form address-ordered singly-linked lists (one global, one small-
// block list per shard) for O(1) coalescing; freed small blocks park in
// per-shard size-class fastbins, and shard caches consolidate back into the
// global list past a byte threshold or on allocation pressure — the dlmalloc
// fastbin design the reference's plasma store inherits, replicated per shard.
//
// All functions return 0 on success or a negative StoreStatus.

#include <errno.h>
#include <pthread.h>
#include <signal.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <unistd.h>

#include <algorithm>
#include <thread>
#include <utility>
#include <vector>

extern "C" {

// Parallel memcpy for large objects: a single core's memcpy (~14 GB/s) is
// half the put_gigabytes baseline; on multi-core hosts splitting the copy
// across threads saturates DRAM bandwidth instead. Caller releases the GIL
// (ctypes does this automatically), so worker threads run truly parallel.
void store_memcpy(void* dst, const void* src, uint64_t n, int nthreads) {
  if (nthreads <= 1 || n < (8u << 20)) {
    memcpy(dst, src, n);
    return;
  }
  uint64_t chunk = (n + nthreads - 1) / nthreads;
  chunk = (chunk + 63) & ~63ULL;  // cache-line aligned splits
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (uint64_t off = 0; off < n; off += chunk) {
    uint64_t len = off + chunk <= n ? chunk : n - off;
    ts.emplace_back([=] { memcpy((char*)dst + off, (const char*)src + off, len); });
  }
  for (auto& t : ts) t.join();
}

// Adaptive-width arena copy: divides the thread budget by the number of
// concurrent large copies into the SAME arena. One client copying 1GB
// wants every core; ten clients each copying 80MB already parallelize
// across processes, and giving each of them `max_threads` workers
// oversubscribes the box 10x (measured as the multi-client put collapse:
// more copy threads, less aggregate bandwidth). The counter lives in the
// shm header so separate client processes see each other.
void store_copy_adaptive(void* base, void* dst, const void* src, uint64_t n,
                         int max_threads);

enum StoreStatus {
  OK = 0,
  ERR_NOTFOUND = -1,
  ERR_AGAIN = -2,       // object exists but not sealed yet
  ERR_EXISTS = -3,
  ERR_FULL = -4,        // no space even after eviction
  ERR_TABLE_FULL = -5,
  ERR_BUSY = -6,        // delete refused: nonzero refcount
  ERR_CORRUPT = -7,
};

static const uint64_t MAGIC = 0x5241595F54505535ULL;  // "RAY_TPU5" (affinity)
static const uint64_t ALIGN = 64;
static const uint64_t MIN_BLOCK = 128;
static const uint32_t SHARD_CANARY = 0x53484152;      // "SHAR"
static const uint64_t MAX_SHARDS = 256;

enum SlotState : uint32_t {
  SLOT_EMPTY = 0,
  SLOT_CREATED = 1,
  SLOT_SEALED = 2,
  SLOT_TOMBSTONE = 3,
};

struct Slot {
  uint8_t id[16];
  uint64_t offset;     // arena-relative offset of data
  uint64_t data_size;
  uint64_t meta_size;  // metadata stored immediately after data
  uint32_t state;
  int32_t refcnt;
  uint64_t lru_tick;
  uint32_t pending_delete;
  uint32_t _pad;
};  // 64 bytes

struct FreeBlock {
  uint64_t size;
  uint64_t next;  // arena-relative offset of next free block, or 0 (arena off 0 is never free: we reserve first ALIGN bytes)
};

// Crash-consistency record for one live write-reservation extent: who
// carved it (pid) and how many of its bytes are still neither published
// nor released. Registered under the global mutex at store_reserve;
// store_publish / store_release_extent decrement `unpublished` and the
// record self-retires at zero. A client that dies mid-reservation leaves
// an active record whose pid no longer exists — store_reclaim_orphans
// finds those, returns the unaccounted gaps inside [off, off+size) to the
// global free list, and repairs rsv_unused_bytes, so a SIGKILLed client
// can no longer strand an extent (or wedge spill accounting) until the
// arena is unlinked.
static const uint64_t MAX_RSV_RECS = 256;
struct RsvRec {
  uint64_t pid;
  uint64_t off;          // arena-relative extent start
  uint64_t size;         // extent bytes
  uint64_t unpublished;  // bytes not yet published/released (atomic)
  uint64_t active;       // atomic 0/1; set last (release) at register
};

static const uint64_t MAX_AFF_RECS = 64;
struct AffRec {
  uint64_t pid;   // 0 = empty
  uint64_t off;   // arena-relative range start the pid last owned
  uint64_t size;
};

static const uint64_t FASTBIN_MAX = 2048;   // largest fastbinned block
static const uint64_t NUM_FASTBINS = FASTBIN_MAX / ALIGN;  // 64..2048 step 64
static const uint64_t SMALL_MAX = 256u << 10;  // shard-cache ceiling

struct Shard {
  pthread_mutex_t mutex;
  uint32_t canary;
  uint32_t _pad0;
  uint64_t free_head;              // small-block list, arena-relative, 0=none
  uint64_t fastbin[NUM_FASTBINS];  // arena-relative heads, 0 = empty
  uint64_t cache_bytes;            // bytes parked in fastbins + free list
  uint64_t num_objects;
  uint64_t num_evictions;
  uint64_t num_tombstones;
};

struct Header {
  uint64_t magic;
  uint64_t total_size;
  uint64_t nshards;          // power of two, <= MAX_SHARDS
  uint64_t slots_per_shard;  // power of two
  uint64_t table_offset;     // from base
  uint64_t arena_offset;     // from base
  uint64_t arena_size;
  uint64_t refill_chunk;     // shard cache refill granularity
  uint64_t small_max;        // allocations <= this ride the shard cache
  uint64_t cache_limit;      // per-shard cache consolidation threshold
  pthread_mutex_t mutex;     // global: extent list + bytes_from_global
  uint64_t free_head;        // global extent list, arena-relative, 0 = none
  uint64_t bytes_from_global;  // bytes carved out of the global list
  uint64_t lru_clock;          // advanced with atomics, no lock
  // Write-reservation plane (multi-client put bandwidth): extents carved
  // once and bump-filled client-side, published as sealed slots.
  uint64_t num_reserves;       // atomic counter (diagnostics/tests)
  uint64_t rsv_unused_bytes;   // atomic: reserved but not yet published —
                               // subtracted from stats "allocated" so the
                               // spill policy sees live bytes, not parked
                               // headroom
  uint64_t active_copiers;     // atomic: in-flight large arena copies;
                               // store_copy_adaptive divides its thread
                               // budget by this so N concurrent clients
                               // don't oversubscribe N*threads workers
  RsvRec rsv_recs[MAX_RSV_RECS];  // live-extent ownership (crash sweep)
  // Owner-affinity hints: the last extent range each pid drained (recorded
  // when a reservation record retires or a tail is released). store_reserve
  // prefers carving its next extent from free bytes inside the caller's
  // hinted range, so a refill lands on pages already in that process's page
  // table — BENCH_r06 isolated the cold-refill page faults as the 8.4->2.1
  // GB/s multi-writer collapse. Hints are advisory: torn reads just cost a
  // failed range probe, never a wrong allocation (the free list is the
  // truth). All fields accessed with relaxed atomics (TSan-clean).
  uint64_t num_aff_hits;           // atomic: affinity-satisfied reserves
  AffRec aff_recs[MAX_AFF_RECS];
};

static inline Shard* shard_at(Header* h, uint64_t i) {
  return (Shard*)((char*)h + sizeof(Header)) + i;
}
static inline Slot* shard_table(Header* h, uint64_t i) {
  return (Slot*)((char*)h + h->table_offset) + i * h->slots_per_shard;
}
static inline char* arena(Header* h) { return (char*)h + h->arena_offset; }

static inline uint64_t hash_id(const uint8_t* id) {
  uint64_t x;
  memcpy(&x, id, 8);
  x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
  return x;
}

static inline uint64_t shard_of(Header* h, const uint8_t* id) {
  return hash_id(id) & (h->nshards - 1);
}
// Probe start inside a shard's table segment: the low bits picked the
// shard, so the in-shard position uses a disjoint bit range.
static inline uint64_t slot_start(Header* h, const uint8_t* id) {
  return (hash_id(id) >> 20) & (h->slots_per_shard - 1);
}

static inline uint64_t next_tick(Header* h) {
  return __atomic_add_fetch(&h->lru_clock, 1, __ATOMIC_RELAXED);
}

static void lock_mu(pthread_mutex_t* mu) {
  int rc = pthread_mutex_lock(mu);
  if (rc == EOWNERDEAD) {
    // A process died holding the lock; shm metadata is still consistent
    // because every mutation completes all pointer updates before unlock and
    // a half-written object is just an unsealed slot (evictable).
    pthread_mutex_consistent(mu);
  }
}
static bool trylock_mu(pthread_mutex_t* mu) {
  int rc = pthread_mutex_trylock(mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(mu);
    return true;
  }
  return rc == 0;
}
static void unlock_mu(pthread_mutex_t* mu) { pthread_mutex_unlock(mu); }

// ---- free-list primitives (shared by the global list and shard lists) ----

static uint64_t align_up(uint64_t v) { return (v + ALIGN - 1) & ~(ALIGN - 1); }

static void list_insert_ordered(Header* h, uint64_t* headp, uint64_t off,
                                uint64_t size) {
  // insert address-ordered, coalesce with list neighbors
  uint64_t prev = 0, cur = *headp;
  while (cur && cur < off) {
    prev = cur;
    cur = ((FreeBlock*)(arena(h) + cur))->next;
  }
  FreeBlock* nb = (FreeBlock*)(arena(h) + off);
  nb->size = size;
  nb->next = cur;
  if (prev) {
    FreeBlock* pb = (FreeBlock*)(arena(h) + prev);
    pb->next = off;
    if (prev + pb->size == off) {  // coalesce prev+new
      pb->size += nb->size;
      pb->next = nb->next;
      nb = pb;
      off = prev;
    }
  } else {
    *headp = off;
  }
  if (nb->next && off + nb->size == nb->next) {  // coalesce new+next
    FreeBlock* nx = (FreeBlock*)(arena(h) + nb->next);
    nb->size += nx->size;
    nb->next = nx->next;
  }
}

// First-fit with split. All block sizes are ALIGN multiples, so a nonzero
// remainder is always splittable and the absorb branch only fires at
// rem == 0 (freeing align_up(data+meta) later returns exactly what was
// allocated — no leaked tail).
static int64_t list_alloc_first_fit(Header* h, uint64_t* headp,
                                    uint64_t need) {
  uint64_t prev = 0;
  uint64_t cur = *headp;
  while (cur) {
    FreeBlock* fb = (FreeBlock*)(arena(h) + cur);
    if (fb->size >= need) {
      uint64_t rem = fb->size - need;
      if (rem >= ALIGN) {
        uint64_t newoff = cur + need;
        FreeBlock* nb = (FreeBlock*)(arena(h) + newoff);
        nb->size = rem;
        nb->next = fb->next;
        if (prev) ((FreeBlock*)(arena(h) + prev))->next = newoff;
        else *headp = newoff;
      } else {
        if (prev) ((FreeBlock*)(arena(h) + prev))->next = fb->next;
        else *headp = fb->next;
      }
      return (int64_t)cur;
    }
    prev = cur;
    cur = fb->next;
  }
  return -1;
}

// ---- shard allocator ----
// Lock order: shard mutex -> (other shard via TRYLOCK only) -> global mutex.
// The global mutex is always innermost, and a second shard is only ever
// acquired with trylock, so no cycle can form.

// caller holds sh->mutex; returns bytes actually taken from the GLOBAL list
// (0 when none) via *taken so accounting stays exact.
static int64_t shard_alloc(Header* h, Shard* sh, uint64_t need_raw) {
  uint64_t need = align_up(need_raw < MIN_BLOCK ? MIN_BLOCK : need_raw);
  if (need <= FASTBIN_MAX) {
    uint64_t bin = need / ALIGN - 1;
    uint64_t off = sh->fastbin[bin];
    if (off) {  // exact-size hit: O(1), no list walk, no global lock
      FreeBlock* fb = (FreeBlock*)(arena(h) + off);
      sh->fastbin[bin] = fb->next;
      sh->cache_bytes -= need;
      return (int64_t)off;
    }
  }
  if (need <= h->small_max) {
    int64_t off = list_alloc_first_fit(h, &sh->free_head, need);
    if (off >= 0) {
      sh->cache_bytes -= need;
      return off;
    }
    // Refill the shard cache from the global list: one global-lock trip
    // buys refill_chunk/need future allocations lock-free.
    uint64_t chunk = h->refill_chunk > need ? h->refill_chunk : need;
    lock_mu(&h->mutex);
    int64_t g = list_alloc_first_fit(h, &h->free_head, chunk);
    if (g < 0 && chunk > need) {
      chunk = need;  // global list fragmented: take just what we need
      g = list_alloc_first_fit(h, &h->free_head, chunk);
    }
    if (g >= 0) h->bytes_from_global += chunk;
    unlock_mu(&h->mutex);
    if (g < 0) return -1;
    if (chunk > need) {
      list_insert_ordered(h, &sh->free_head, (uint64_t)g + need,
                          chunk - need);
      sh->cache_bytes += chunk - need;
    }
    return g;
  }
  // Large block: straight from the global extent list.
  lock_mu(&h->mutex);
  int64_t g = list_alloc_first_fit(h, &h->free_head, need);
  if (g >= 0) h->bytes_from_global += need;
  unlock_mu(&h->mutex);
  return g;
}

// caller holds sh->mutex. Flush the shard's cached free blocks back into
// the global list so neighbors from different shards can coalesce.
static void consolidate_shard(Header* h, Shard* sh) {
  lock_mu(&h->mutex);
  for (uint64_t b = 0; b < NUM_FASTBINS; b++) {
    uint64_t cur = sh->fastbin[b];
    sh->fastbin[b] = 0;
    while (cur) {
      FreeBlock* fb = (FreeBlock*)(arena(h) + cur);
      uint64_t next = fb->next;
      h->bytes_from_global -= fb->size;
      list_insert_ordered(h, &h->free_head, cur, fb->size);
      cur = next;
    }
  }
  uint64_t cur = sh->free_head;
  sh->free_head = 0;
  while (cur) {
    FreeBlock* fb = (FreeBlock*)(arena(h) + cur);
    uint64_t next = fb->next;
    h->bytes_from_global -= fb->size;
    list_insert_ordered(h, &h->free_head, cur, fb->size);
    cur = next;
  }
  unlock_mu(&h->mutex);
  sh->cache_bytes = 0;
}

// caller holds sh->mutex. to_global forces the block past the shard cache
// (used by eviction under global pressure, where parking freed bytes in a
// shard cache would strand them from the allocating shard).
static void shard_free(Header* h, Shard* sh, uint64_t off, uint64_t size_raw,
                       bool to_global) {
  uint64_t size = align_up(size_raw < MIN_BLOCK ? MIN_BLOCK : size_raw);
  if (to_global || size > h->small_max) {
    lock_mu(&h->mutex);
    h->bytes_from_global -= size;
    list_insert_ordered(h, &h->free_head, off, size);
    unlock_mu(&h->mutex);
    return;
  }
  if (size <= FASTBIN_MAX) {
    uint64_t bin = size / ALIGN - 1;
    FreeBlock* fb = (FreeBlock*)(arena(h) + off);
    fb->size = size;
    fb->next = sh->fastbin[bin];
    sh->fastbin[bin] = off;
  } else {
    list_insert_ordered(h, &sh->free_head, off, size);
  }
  sh->cache_bytes += size;
  if (sh->cache_bytes >= h->cache_limit) consolidate_shard(h, sh);
}

// ---- slot table (per-shard segments) ----

static Slot* find_slot(Header* h, uint64_t sidx, const uint8_t* id) {
  Slot* tab = shard_table(h, sidx);
  uint64_t mask = h->slots_per_shard - 1;
  uint64_t i = slot_start(h, id);
  for (uint64_t probes = 0; probes < h->slots_per_shard;
       probes++, i = (i + 1) & mask) {
    Slot* s = &tab[i];
    if (s->state == SLOT_EMPTY) return nullptr;
    if (s->state != SLOT_TOMBSTONE && memcmp(s->id, id, 16) == 0) return s;
  }
  return nullptr;
}

static Slot* insert_slot(Header* h, uint64_t sidx, const uint8_t* id) {
  Slot* tab = shard_table(h, sidx);
  uint64_t mask = h->slots_per_shard - 1;
  uint64_t i = slot_start(h, id);
  Slot* reuse = nullptr;
  for (uint64_t probes = 0; probes < h->slots_per_shard;
       probes++, i = (i + 1) & mask) {
    Slot* s = &tab[i];
    if (s->state == SLOT_EMPTY) return reuse ? reuse : s;
    if (s->state == SLOT_TOMBSTONE) { if (!reuse) reuse = s; continue; }
    if (memcmp(s->id, id, 16) == 0) return nullptr;  // exists
  }
  return reuse;  // segment may be all tombstones
}

// Rebuild one shard's segment in place once tombstones dominate: with
// linear probing, chains only terminate at SLOT_EMPTY, so a segment that
// has seen many delete cycles degrades every lookup MISS to O(segment)
// even when nearly empty. Rehashing live entries restores short chains.
static void rehash_shard(Header* h, uint64_t sidx) {
  Shard* sh = shard_at(h, sidx);
  Slot* tab = shard_table(h, sidx);
  uint64_t n = h->slots_per_shard;
  std::vector<Slot> live;
  live.reserve(sh->num_objects + 16);
  for (uint64_t i = 0; i < n; i++)
    if (tab[i].state == SLOT_CREATED || tab[i].state == SLOT_SEALED)
      live.push_back(tab[i]);
  memset(tab, 0, n * sizeof(Slot));
  uint64_t mask = n - 1;
  for (const Slot& s : live) {
    uint64_t i = slot_start(h, s.id);
    while (tab[i].state != SLOT_EMPTY) i = (i + 1) & mask;
    tab[i] = s;
  }
  sh->num_tombstones = 0;
}

// caller holds the shard's mutex
static void evict_entry(Header* h, uint64_t sidx, Slot* s, bool to_global) {
  Shard* sh = shard_at(h, sidx);
  shard_free(h, sh, s->offset, s->data_size + s->meta_size, to_global);
  s->state = SLOT_TOMBSTONE;
  s->refcnt = 0;
  sh->num_objects--;
  if (++sh->num_tombstones > h->slots_per_shard / 4) rehash_shard(h, sidx);
}

// caller holds shard sidx's mutex; oldest sealed refcnt==0 slot or null
static Slot* oldest_evictable(Header* h, uint64_t sidx) {
  Slot* tab = shard_table(h, sidx);
  Slot* victim = nullptr;
  for (uint64_t i = 0; i < h->slots_per_shard; i++) {
    Slot* s = &tab[i];
    if (s->state == SLOT_SEALED && s->refcnt == 0 &&
        (!victim || s->lru_tick < victim->lru_tick))
      victim = s;
  }
  return victim;
}

// Evict sealed refcnt==0 objects until `need` is allocatable: own shard's
// oldest first (exact LRU within the shard), then sweep sibling shards via
// trylock, consolidating their caches so freed bytes reach the global
// list. Approximate-global-LRU across shards — the per-victim full-table
// scan the single-lock store did under one mutex is now a segment scan
// under the victim shard's lock only. Returns offset or -1.
static int64_t alloc_with_eviction(Header* h, uint64_t sidx, uint64_t need) {
  Shard* sh = shard_at(h, sidx);
  bool to_global = align_up(need) > h->small_max;
  int64_t off = shard_alloc(h, sh, need);
  while (off < 0) {
    Slot* victim = oldest_evictable(h, sidx);
    if (victim != nullptr) {
      evict_entry(h, sidx, victim, to_global);
      sh->num_evictions++;
      off = shard_alloc(h, sh, need);
      continue;
    }
    // Own shard dry: flush our cache and sweep siblings for victims.
    consolidate_shard(h, sh);
    off = shard_alloc(h, sh, need);
    if (off >= 0) return off;
    bool progress = false;
    for (uint64_t i = 0; i < h->nshards && off < 0; i++) {
      if (i == sidx) continue;
      Shard* o = shard_at(h, i);
      if (!trylock_mu(&o->mutex)) continue;  // busy: it is making progress
      Slot* v = oldest_evictable(h, i);
      if (v != nullptr) {
        evict_entry(h, i, v, true);
        o->num_evictions++;
        progress = true;
      }
      consolidate_shard(h, o);
      unlock_mu(&o->mutex);
      off = shard_alloc(h, sh, need);
    }
    if (off >= 0) return off;
    if (!progress) return -1;
  }
  return off;
}

// ---- write reservations (per-client lock-free put extents) ----
//
// The multi-client put path: a client carves one large extent under the
// global mutex (store_reserve), bump-allocates object payloads inside it
// with NO shared lock, memcpys each payload lock-free, and publishes each
// finished object as an already-SEALED slot (store_publish — one short
// shard-lock critical section; the state store is the visibility point).
// Unused tail space returns via store_release_extent. Block geometry
// contract: every published object occupies align_up(max(data+meta,
// MIN_BLOCK)) bytes inside the extent — exactly what shard_free returns
// on later eviction/delete, so reservation-born blocks coalesce like any
// other.

static void sweep_evict_all_shards(Header* h, bool* progress) {
  *progress = false;
  for (uint64_t i = 0; i < h->nshards; i++) {
    Shard* sh = shard_at(h, i);
    lock_mu(&sh->mutex);
    Slot* v = oldest_evictable(h, i);
    if (v != nullptr) {
      evict_entry(h, i, v, true);
      sh->num_evictions++;
      *progress = true;
    }
    consolidate_shard(h, sh);
    unlock_mu(&sh->mutex);
  }
}

// ---- owner-affinity hints (process-local gates + in-shm hint table) ----

// Per-process knobs (store_reserve_config): compiled-in defaults ON; the
// Python side lowers them from the put_extent_affinity / put_extent_pretouch
// config knobs at configure time.
static int g_rsv_affinity = 1;
static int g_rsv_pretouch = 1;

void store_reserve_config(int affinity, int pretouch) {
  g_rsv_affinity = affinity;
  g_rsv_pretouch = pretouch;
}

static void aff_note(Header* h, uint64_t pid, uint64_t off, uint64_t size) {
  if (!pid) return;
  AffRec* r = &h->aff_recs[pid % MAX_AFF_RECS];
  __atomic_store_n(&r->off, off, __ATOMIC_RELAXED);
  __atomic_store_n(&r->size, size, __ATOMIC_RELAXED);
  __atomic_store_n(&r->pid, pid, __ATOMIC_RELAXED);
}

// Carve `need` bytes from a free block whose usable span intersects
// [lo, hi) — allocation starts at max(block_start, lo) so a hinted range
// coalesced into a larger block still yields the warm bytes (3-way split:
// head remainder, carve, tail remainder). Caller holds the global mutex.
static int64_t list_alloc_in_range(Header* h, uint64_t* headp, uint64_t lo,
                                   uint64_t hi, uint64_t need) {
  if (hi <= lo || hi - lo < need) return -1;
  uint64_t prev = 0, cur = *headp;
  while (cur) {
    FreeBlock* fb = (FreeBlock*)(arena(h) + cur);
    uint64_t b = cur, e = cur + fb->size, nxt = fb->next;
    uint64_t start = b > lo ? b : lo;
    if (start < hi && start + need <= e) {
      // unlink the block, re-insert the remainders
      if (prev) ((FreeBlock*)(arena(h) + prev))->next = nxt;
      else *headp = nxt;
      if (start > b) list_insert_ordered(h, headp, b, start - b);
      if (e > start + need)
        list_insert_ordered(h, headp, start + need, e - (start + need));
      return (int64_t)start;
    }
    prev = cur;
    cur = nxt;
  }
  return -1;
}

// Pre-fault a carved extent so the client's bump-fill memcpys never
// minor-fault mid-copy: MADV_POPULATE_WRITE where the kernel has it,
// else one write per page (the bytes are ours and uninitialized).
#ifndef MADV_POPULATE_WRITE
#define MADV_POPULATE_WRITE 23
#endif
static void pretouch(char* p, uint64_t n) {
  uint64_t page = 4096;
  uint64_t lo = (uint64_t)p & ~(page - 1);
  uint64_t hi = ((uint64_t)p + n + page - 1) & ~(page - 1);
  if (madvise((void*)lo, hi - lo, MADV_POPULATE_WRITE) == 0) return;
  for (volatile char* q = (volatile char*)p; q < (volatile char*)(p + n);
       q += page)
    *q = *q;
  if (n) { volatile char* q = (volatile char*)(p + n - 1); *q = *q; }
}

// Find the active record whose extent contains arena-relative `off`, or
// null. Records are few and mutate rarely; the scan is lock-free (active
// flips 0->1 with release ordering after the fields are written, and only
// the owner — or the sweeper, for a DEAD owner — flips it back).
static RsvRec* rsv_find(Header* h, uint64_t off) {
  for (uint64_t i = 0; i < MAX_RSV_RECS; i++) {
    RsvRec* r = &h->rsv_recs[i];
    if (!__atomic_load_n(&r->active, __ATOMIC_ACQUIRE)) continue;
    // Atomic field reads: a sibling thread may be re-initializing a
    // RETIRED record slot concurrently; active's acquire/release pairing
    // guarantees the fields are consistent whenever active reads 1, and
    // the atomics keep the (ignored) racing reads untorn.
    uint64_t ro = __atomic_load_n(&r->off, __ATOMIC_RELAXED);
    uint64_t rs = __atomic_load_n(&r->size, __ATOMIC_RELAXED);
    if (off >= ro && off < ro + rs) return r;
  }
  return nullptr;
}

// Owner-side accounting for bytes leaving the "reserved, unaccounted"
// state (a publish or an explicit release): the record self-retires when
// nothing unpublished remains, so a cleanly drained extent needs no
// explicit close call and the record slot recycles.
static void rsv_account(Header* h, uint64_t off, uint64_t bytes) {
  RsvRec* r = rsv_find(h, off);
  if (r == nullptr) return;  // unrecorded extent (table was full)
  uint64_t left =
      __atomic_sub_fetch(&r->unpublished, bytes, __ATOMIC_RELAXED);
  if (left == 0
      || left > __atomic_load_n(&r->size, __ATOMIC_RELAXED)) {
    // drained (or accounting drift): retire the record slot, leaving an
    // owner-affinity hint behind — the drained extent's pages are warm in
    // this pid's page table, so its NEXT reserve should carve from here.
    aff_note(h, __atomic_load_n(&r->pid, __ATOMIC_RELAXED),
             __atomic_load_n(&r->off, __ATOMIC_RELAXED),
             __atomic_load_n(&r->size, __ATOMIC_RELAXED));
    __atomic_store_n(&r->active, 0, __ATOMIC_RELEASE);
  }
}

// Carve a raw extent of `size` bytes; *out_offset is ABSOLUTE (from
// base), like store_create's. Evicts sealed refcnt==0 objects across all
// shards under pressure. Returns OK or ERR_FULL. The extent is recorded
// with this process's pid so store_reclaim_orphans can return it if the
// owner dies before publishing/releasing every byte.
int store_reserve(void* base, uint64_t size, uint64_t* out_offset) {
  Header* h = (Header*)base;
  uint64_t need = align_up(size < MIN_BLOCK ? MIN_BLOCK : size);
  uint64_t self = (uint64_t)getpid();
  // Owner-affinity probe (advisory hint; relaxed reads — the free list
  // walk below is the truth): prefer bytes this pid drained before.
  uint64_t aff_lo = 0, aff_hi = 0;
  if (g_rsv_affinity) {
    AffRec* ar = &h->aff_recs[self % MAX_AFF_RECS];
    if (__atomic_load_n(&ar->pid, __ATOMIC_RELAXED) == self) {
      aff_lo = __atomic_load_n(&ar->off, __ATOMIC_RELAXED);
      aff_hi = aff_lo + __atomic_load_n(&ar->size, __ATOMIC_RELAXED);
      if (aff_hi <= aff_lo || aff_hi > h->arena_size) aff_lo = aff_hi = 0;
    }
  }
  for (;;) {
    lock_mu(&h->mutex);
    int64_t off = -1;
    if (aff_hi > aff_lo) {
      off = list_alloc_in_range(h, &h->free_head, aff_lo, aff_hi, need);
      if (off >= 0)
        __atomic_add_fetch(&h->num_aff_hits, 1, __ATOMIC_RELAXED);
    }
    if (off < 0) off = list_alloc_first_fit(h, &h->free_head, need);
    if (off >= 0) {
      h->bytes_from_global += need;
      // Register ownership INSIDE the critical section: a death after
      // unlock leaves a consistent (counted + recorded) extent for the
      // sweeper. Table full => proceed unrecorded (no crash protection
      // for this extent; 256 concurrent extents per node is the bound).
      for (uint64_t i = 0; i < MAX_RSV_RECS; i++) {
        RsvRec* r = &h->rsv_recs[i];
        if (__atomic_load_n(&r->active, __ATOMIC_RELAXED)) continue;
        __atomic_store_n(&r->pid, (uint64_t)getpid(), __ATOMIC_RELAXED);
        __atomic_store_n(&r->off, (uint64_t)off, __ATOMIC_RELAXED);
        __atomic_store_n(&r->size, need, __ATOMIC_RELAXED);
        __atomic_store_n(&r->unpublished, need, __ATOMIC_RELAXED);
        __atomic_store_n(&r->active, 1, __ATOMIC_RELEASE);
        break;
      }
      __atomic_add_fetch(&h->num_reserves, 1, __ATOMIC_RELAXED);
      __atomic_add_fetch(&h->rsv_unused_bytes, need, __ATOMIC_RELAXED);
    }
    unlock_mu(&h->mutex);
    if (off >= 0) {
      *out_offset = h->arena_offset + (uint64_t)off;
      if (g_rsv_pretouch)
        pretouch(arena(h) + (uint64_t)off, need);
      return OK;
    }
    bool progress = false;
    sweep_evict_all_shards(h, &progress);
    if (!progress) return ERR_FULL;
  }
}

uint64_t store_aff_hits(void* base) {
  return __atomic_load_n(&((Header*)base)->num_aff_hits, __ATOMIC_RELAXED);
}

// Return an unused reservation slice (tail, aborted chunk, or the whole
// extent) to the global list. abs_offset/size must delimit bytes that
// were reserved and never published.
int store_release_extent(void* base, uint64_t abs_offset, uint64_t size) {
  Header* h = (Header*)base;
  if (size == 0) return OK;
  uint64_t off = abs_offset - h->arena_offset;
  lock_mu(&h->mutex);
  h->bytes_from_global -= size;
  list_insert_ordered(h, &h->free_head, off, size);
  unlock_mu(&h->mutex);
  __atomic_sub_fetch(&h->rsv_unused_bytes, size, __ATOMIC_RELAXED);
  // The released slice is warm in this pid's page table — hint the next
  // reserve at it even when the record has publishes still outstanding.
  aff_note(h, (uint64_t)getpid(), off, size);
  rsv_account(h, off, size);
  return OK;
}

// Publish a filled reservation chunk as a sealed object. The data +
// metadata bytes are already in place at abs_offset; this inserts the
// slot (SEALED, refcnt 0) under the shard lock — the single point where
// the object becomes visible to store_get.
int store_publish(void* base, const uint8_t* id, uint64_t abs_offset,
                  uint64_t data_size, uint64_t meta_size) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  uint64_t raw = data_size + meta_size;
  uint64_t block = align_up(raw < MIN_BLOCK ? MIN_BLOCK : raw);
  lock_mu(&sh->mutex);
  Slot* s = insert_slot(h, sidx, id);
  if (s == nullptr) {
    int rc = find_slot(h, sidx, id) ? ERR_EXISTS : ERR_TABLE_FULL;
    unlock_mu(&sh->mutex);
    return rc;
  }
  memcpy(s->id, id, 16);
  s->offset = abs_offset - h->arena_offset;
  s->data_size = data_size;
  s->meta_size = meta_size;
  if (s->state == SLOT_TOMBSTONE) sh->num_tombstones--;
  s->refcnt = 0;
  s->lru_tick = next_tick(h);
  s->pending_delete = 0;
  __atomic_store_n(&s->state, (uint32_t)SLOT_SEALED, __ATOMIC_RELEASE);
  sh->num_objects++;
  unlock_mu(&sh->mutex);
  __atomic_sub_fetch(&h->rsv_unused_bytes, block, __ATOMIC_RELAXED);
  rsv_account(h, abs_offset - h->arena_offset, block);
  return OK;
}

uint64_t store_num_reserves(void* base) {
  return __atomic_load_n(&((Header*)base)->num_reserves, __ATOMIC_RELAXED);
}

uint64_t store_rsv_unused(void* base) {
  return __atomic_load_n(&((Header*)base)->rsv_unused_bytes,
                         __ATOMIC_RELAXED);
}

// ---- orphaned-reservation reclamation (pid-liveness sweep) ----
//
// A client SIGKILLed between store_reserve and its final store_publish /
// store_release_extent leaves (a) the extent's unaccounted bytes carved
// out of the global list forever and (b) rsv_unused_bytes inflated by the
// same amount — stats under-report "allocated" and the spill policy can
// wedge. The sweep: for every active record whose pid no longer exists,
// compute which bytes of [off, off+size) are ACCOUNTED FOR elsewhere
// (live slots the client published before dying; free-list blocks from
// slices it released or published-then-evicted) and return every
// remaining gap to the global free list, repairing both counters.

static bool pid_alive(uint64_t pid) {
  if (pid == 0) return true;  // unknown owner: never reclaim
  if (kill((pid_t)pid, 0) == 0) return true;
  return errno != ESRCH;  // EPERM = alive under another uid
}

// Collect [lo,hi)-clamped intervals of one free list into `iv`.
static void collect_list(Header* h, uint64_t head, uint64_t lo, uint64_t hi,
                         std::vector<std::pair<uint64_t, uint64_t>>* iv) {
  for (uint64_t cur = head; cur;) {
    FreeBlock* fb = (FreeBlock*)(arena(h) + cur);
    uint64_t b = cur, e = cur + fb->size;
    if (b < hi && e > lo)
      iv->push_back({b < lo ? lo : b, e > hi ? hi : e});
    cur = fb->next;
  }
}

// Reclaim one dead record. Caller holds NO locks; takes every shard
// mutex then the global mutex (the store's shard->global lock order).
static int64_t reclaim_record(Header* h, uint64_t ri) {
  for (uint64_t i = 0; i < h->nshards; i++) lock_mu(&shard_at(h, i)->mutex);
  lock_mu(&h->mutex);
  RsvRec* rec = &h->rsv_recs[ri];
  int64_t freed = 0;
  if (__atomic_load_n(&rec->active, __ATOMIC_ACQUIRE)
      && !pid_alive(rec->pid)) {
    uint64_t lo = rec->off, hi = rec->off + rec->size;
    std::vector<std::pair<uint64_t, uint64_t>> iv;
    // Live slots published into the extent (block footprint, align_up —
    // the geometry contract shared with eviction).
    for (uint64_t si = 0; si < h->nshards; si++) {
      Slot* tab = shard_table(h, si);
      for (uint64_t i = 0; i < h->slots_per_shard; i++) {
        Slot* s = &tab[i];
        if (s->state != SLOT_CREATED && s->state != SLOT_SEALED) continue;
        uint64_t raw = s->data_size + s->meta_size;
        uint64_t blk = align_up(raw < MIN_BLOCK ? MIN_BLOCK : raw);
        uint64_t b = s->offset, e = s->offset + blk;
        if (b < hi && e > lo)
          iv.push_back({b < lo ? lo : b, e > hi ? hi : e});
      }
    }
    // Free bytes already returned (released slices, evicted publishes —
    // possibly coalesced across the extent boundary, hence the clamp).
    collect_list(h, h->free_head, lo, hi, &iv);
    for (uint64_t si = 0; si < h->nshards; si++) {
      Shard* sh = shard_at(h, si);
      collect_list(h, sh->free_head, lo, hi, &iv);
      for (uint64_t b = 0; b < NUM_FASTBINS; b++)
        collect_list(h, sh->fastbin[b], lo, hi, &iv);
    }
    std::sort(iv.begin(), iv.end());
    // Walk the gaps: bytes of the dead extent no structure accounts for.
    uint64_t cursor = lo;
    auto free_gap = [&](uint64_t b, uint64_t e) {
      if (e <= b) return;
      list_insert_ordered(h, &h->free_head, b, e - b);
      h->bytes_from_global -= e - b;
      freed += (int64_t)(e - b);
    };
    for (auto& p : iv) {
      if (p.first > cursor) free_gap(cursor, p.first);
      if (p.second > cursor) cursor = p.second;
    }
    free_gap(cursor, hi);
    if (freed > 0) {
      uint64_t cur =
          __atomic_load_n(&h->rsv_unused_bytes, __ATOMIC_RELAXED);
      uint64_t sub = (uint64_t)freed < cur ? (uint64_t)freed : cur;
      __atomic_sub_fetch(&h->rsv_unused_bytes, sub, __ATOMIC_RELAXED);
    }
    __atomic_store_n(&rec->active, 0, __ATOMIC_RELEASE);
  }
  unlock_mu(&h->mutex);
  for (uint64_t i = h->nshards; i-- > 0;)
    unlock_mu(&shard_at(h, i)->mutex);
  return freed;
}

// Sweep every active record for dead owners; returns bytes reclaimed.
// Cheap when nothing died: one lock-free record scan + one kill(pid, 0)
// per live extent — safe to call from heartbeat/pressure paths.
int64_t store_reclaim_orphans(void* base) {
  Header* h = (Header*)base;
  uint64_t self = (uint64_t)getpid();
  int64_t total = 0;
  for (uint64_t i = 0; i < MAX_RSV_RECS; i++) {
    RsvRec* rec = &h->rsv_recs[i];
    if (!__atomic_load_n(&rec->active, __ATOMIC_ACQUIRE)) continue;
    uint64_t pid = __atomic_load_n(&rec->pid, __ATOMIC_RELAXED);
    if (pid == self || pid_alive(pid)) continue;
    total += reclaim_record(h, i);
  }
  return total;
}

void store_copy_adaptive(void* base, void* dst, const void* src, uint64_t n,
                         int max_threads) {
  Header* h = (Header*)base;
  uint64_t active =
      __atomic_add_fetch(&h->active_copiers, 1, __ATOMIC_RELAXED);
  int threads = max_threads / (int)(active ? active : 1);
  if (threads < 1) threads = 1;
  store_memcpy(dst, src, n, threads);
  __atomic_sub_fetch(&h->active_copiers, 1, __ATOMIC_RELAXED);
}

// ---- public API ----

int store_init(void* base, uint64_t total_size, uint64_t num_slots,
               uint64_t nshards) {
  Header* h = (Header*)base;
  memset(h, 0, sizeof(Header));
  h->magic = MAGIC;
  h->total_size = total_size;
  if (nshards < 1) nshards = 1;
  if (nshards > MAX_SHARDS) nshards = MAX_SHARDS;
  while (nshards & (nshards - 1)) nshards &= nshards - 1;  // round down pow2
  h->nshards = nshards;
  uint64_t per = num_slots / nshards;
  uint64_t p2 = 64;
  while (p2 < per) p2 <<= 1;
  h->slots_per_shard = p2;
  uint64_t shards_bytes = nshards * sizeof(Shard);
  uint64_t table_bytes = nshards * h->slots_per_shard * sizeof(Slot);
  h->table_offset = align_up(sizeof(Header) + shards_bytes);
  h->arena_offset = align_up(h->table_offset + table_bytes);
  if (h->arena_offset + MIN_BLOCK * 2 > total_size) return ERR_FULL;
  h->arena_size = total_size - h->arena_offset;

  // Shard-cache tuning: refills large enough to amortize the global lock,
  // small enough that N idle caches can't strand a meaningful arena slice.
  uint64_t refill = h->arena_size / (nshards * 16);
  if (refill < (64u << 10)) refill = 64u << 10;
  if (refill > (4u << 20)) refill = 4u << 20;
  h->refill_chunk = align_up(refill);
  h->small_max = SMALL_MAX < h->refill_chunk ? SMALL_MAX : h->refill_chunk;
  h->cache_limit = h->refill_chunk * 4;

  pthread_mutexattr_t attr;
  pthread_mutexattr_init(&attr);
  pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mutex, &attr);
  memset((char*)h + sizeof(Header), 0, shards_bytes);
  memset(shard_table(h, 0), 0, table_bytes);
  for (uint64_t i = 0; i < nshards; i++) {
    Shard* sh = shard_at(h, i);
    pthread_mutex_init(&sh->mutex, &attr);
    sh->canary = SHARD_CANARY;
  }
  pthread_mutexattr_destroy(&attr);

  // Reserve the first ALIGN bytes so offset 0 means "no block".
  h->free_head = ALIGN;
  FreeBlock* fb = (FreeBlock*)(arena(h) + ALIGN);
  fb->size = align_up(h->arena_size - ALIGN) - ALIGN;
  if (fb->size > h->arena_size - ALIGN) fb->size = h->arena_size - ALIGN;
  fb->size &= ~(ALIGN - 1);
  fb->next = 0;
  return OK;
}

int store_validate(void* base) {
  Header* h = (Header*)base;
  if (h->magic != MAGIC) return ERR_CORRUPT;
  if (h->nshards < 1 || h->nshards > MAX_SHARDS ||
      (h->nshards & (h->nshards - 1)))
    return ERR_CORRUPT;
  if (h->arena_offset + h->arena_size > h->total_size) return ERR_CORRUPT;
  for (uint64_t i = 0; i < h->nshards; i++)
    if (shard_at(h, i)->canary != SHARD_CANARY) return ERR_CORRUPT;
  return OK;
}

uint64_t store_num_shards(void* base) { return ((Header*)base)->nshards; }

// Creates an unsealed object and returns the absolute byte offset (from base)
// where the caller should write data_size bytes of data then meta_size bytes
// of metadata, then call store_seal.
int store_create(void* base, const uint8_t* id, uint64_t data_size,
                 uint64_t meta_size, uint64_t* out_offset) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  if (find_slot(h, sidx, id)) { unlock_mu(&sh->mutex); return ERR_EXISTS; }
  // Allocate BEFORE claiming a slot: eviction inside the allocator can
  // trip the tombstone rehash, which relocates the shard's slot segment
  // and would invalidate a Slot* held across the call.
  int64_t off = alloc_with_eviction(h, sidx, data_size + meta_size);
  if (off < 0) { unlock_mu(&sh->mutex); return ERR_FULL; }
  Slot* s = insert_slot(h, sidx, id);
  if (!s) {
    shard_free(h, sh, (uint64_t)off, data_size + meta_size, false);
    unlock_mu(&sh->mutex);
    return ERR_TABLE_FULL;
  }
  memcpy(s->id, id, 16);
  s->offset = (uint64_t)off;
  s->data_size = data_size;
  s->meta_size = meta_size;
  if (s->state == SLOT_TOMBSTONE) sh->num_tombstones--;
  s->state = SLOT_CREATED;
  s->refcnt = 1;  // creator holds a ref until seal+release
  s->lru_tick = next_tick(h);
  s->pending_delete = 0;
  sh->num_objects++;
  *out_offset = h->arena_offset + (uint64_t)off;
  unlock_mu(&sh->mutex);
  return OK;
}

int store_seal(void* base, const uint8_t* id) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  if (!s) { unlock_mu(&sh->mutex); return ERR_NOTFOUND; }
  s->state = SLOT_SEALED;
  s->refcnt--;  // drop creator ref
  unlock_mu(&sh->mutex);
  return OK;
}

// On success takes a reference; caller must store_release when done with the
// memory. Returns absolute offset + sizes.
int store_get(void* base, const uint8_t* id, uint64_t* out_offset,
              uint64_t* out_data_size, uint64_t* out_meta_size) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  if (!s) { unlock_mu(&sh->mutex); return ERR_NOTFOUND; }
  if (s->state != SLOT_SEALED) { unlock_mu(&sh->mutex); return ERR_AGAIN; }
  s->refcnt++;
  s->lru_tick = next_tick(h);
  *out_offset = h->arena_offset + s->offset;
  *out_data_size = s->data_size;
  *out_meta_size = s->meta_size;
  unlock_mu(&sh->mutex);
  return OK;
}

int store_release(void* base, const uint8_t* id) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  if (!s) { unlock_mu(&sh->mutex); return ERR_NOTFOUND; }
  if (s->refcnt > 0) s->refcnt--;
  if (s->pending_delete && s->refcnt == 0)
    evict_entry(h, sidx, s, false);
  unlock_mu(&sh->mutex);
  return OK;
}

int store_contains(void* base, const uint8_t* id) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  int rc = (s && s->state == SLOT_SEALED) ? 1 : 0;
  unlock_mu(&sh->mutex);
  return rc;
}

// Abort an unsealed create (e.g. writer failed mid-copy).
int store_abort(void* base, const uint8_t* id) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  if (!s) { unlock_mu(&sh->mutex); return ERR_NOTFOUND; }
  if (s->state == SLOT_CREATED) {
    evict_entry(h, sidx, s, false);
    unlock_mu(&sh->mutex);
    return OK;
  }
  unlock_mu(&sh->mutex);
  return ERR_BUSY;
}

int store_delete(void* base, const uint8_t* id) {
  Header* h = (Header*)base;
  uint64_t sidx = shard_of(h, id);
  Shard* sh = shard_at(h, sidx);
  lock_mu(&sh->mutex);
  Slot* s = find_slot(h, sidx, id);
  if (!s) { unlock_mu(&sh->mutex); return ERR_NOTFOUND; }
  if (s->refcnt > 0) {
    s->pending_delete = 1;  // freed on last release
    unlock_mu(&sh->mutex);
    return OK;
  }
  evict_entry(h, sidx, s, false);
  unlock_mu(&sh->mutex);
  return OK;
}

// LOCK-FREE: stats feed monitoring and the spill-threshold heuristic,
// which tolerate a momentarily torn sum — taking the global plus every
// shard mutex here would re-serialize the very put path the sharding
// unlocked (the head-node spill check reads stats on EVERY worker put).
void store_stats(void* base, uint64_t* out_allocated, uint64_t* out_capacity,
                 uint64_t* out_num_objects, uint64_t* out_num_evictions) {
  Header* h = (Header*)base;
  uint64_t allocated =
      __atomic_load_n(&h->bytes_from_global, __ATOMIC_RELAXED);
  uint64_t nobj = 0, nevict = 0, cached = 0;
  for (uint64_t i = 0; i < h->nshards; i++) {
    Shard* sh = shard_at(h, i);
    nobj += __atomic_load_n(&sh->num_objects, __ATOMIC_RELAXED);
    nevict += __atomic_load_n(&sh->num_evictions, __ATOMIC_RELAXED);
    cached += __atomic_load_n(&sh->cache_bytes, __ATOMIC_RELAXED);
  }
  // Bytes parked in shard caches are free capacity, not live objects —
  // and so are reserved-but-unpublished reservation slices (counting
  // them would trip the spill policy on parked headroom).
  cached += __atomic_load_n(&h->rsv_unused_bytes, __ATOMIC_RELAXED);
  *out_allocated = allocated > cached ? allocated - cached : 0;
  *out_capacity = h->arena_size;
  *out_num_objects = nobj;
  *out_num_evictions = nevict;
}

uint64_t store_header_size() { return sizeof(Header); }

// Write the 16-byte ids of all sealed objects into `out` (room for
// max_ids). Returns the number written. Used to rebuild a restarted
// head's object directory from each node's surviving arena (parity:
// raylets resyncing object locations with a restarted GCS).
int64_t store_list_ids(void* base, uint8_t* out, uint64_t max_ids) {
  Header* h = (Header*)base;
  uint64_t n = 0;
  for (uint64_t si = 0; si < h->nshards; si++) {
    Shard* sh = shard_at(h, si);
    Slot* tab = shard_table(h, si);
    lock_mu(&sh->mutex);
    for (uint64_t i = 0; i < h->slots_per_shard && n < max_ids; i++) {
      if (tab[i].state == SLOT_SEALED) {
        memcpy(out + n * 16, tab[i].id, 16);
        n++;
      }
    }
    unlock_mu(&sh->mutex);
    if (n >= max_ids) break;
  }
  return (int64_t)n;
}

}  // extern "C"
