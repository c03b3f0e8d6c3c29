// ray_tpu_torch shared-memory object store.
//
// A plasma-equivalent (reference: src/ray/object_manager/plasma/
// store.h:55, object_lifecycle_manager.h:101, eviction_policy.h:105,
// plasma_allocator.h:44) redesigned serverless: instead of a store *server*
// process with fd-passing (fling.cc) and a flatbuffer wire protocol
// (plasma.fbs), every client maps one shared-memory file and coordinates
// through a process-shared robust mutex embedded in the mapping. This removes
// a per-operation IPC round-trip: create/seal/get are O(few hundred ns) of
// shared-memory work, and object payloads are zero-copy mmap views in every
// process. On TPU hosts the payloads feed jax.device_put directly (HBM
// staging), so the host store only needs to be a fast arena, not a transport.
//
// Layout of the mapping:
//   [StoreHeader][ObjectEntry x table_size][heap bytes ...]
//
// - Object table: open-addressing hash (linear probing, tombstones).
// - Heap: first-fit free list with boundary coalescing (plasma uses dlmalloc;
//   a bespoke allocator keeps us dependency-free and the access pattern --
//   few large buffers -- does not need size classes).
// - Eviction: LRU over sealed, refcount==0 objects (eviction_policy.h:160
//   LRUCache equivalent), triggered on allocation failure.
// - Crash-safety: pthread robust mutex; a died-holding-lock client leaves the
//   store usable (EOWNERDEAD -> consistency restore).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <vector>
#include <cstring>
#include <cstdio>
#include <cerrno>
#include <fcntl.h>
#include <pthread.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <ctime>
#include <unistd.h>

extern "C" {

static const uint64_t kMagic = 0x5241595F54505532ULL;  // "RAY_TPU2"
static const uint32_t kIdSize = 20;

enum EntryState : uint32_t {
  kFree = 0,
  kCreated = 1,   // allocated, not yet sealed (writer still filling)
  kSealed = 2,    // immutable, readable
  kTombstone = 3, // deleted slot (keeps probe chains intact)
};

struct ObjectEntry {
  uint8_t id[kIdSize];
  uint32_t state;
  uint64_t offset;      // into heap (absolute offset within mapping)
  uint64_t data_size;
  uint64_t meta_size;
  uint64_t alloc_size;  // actual bytes taken from the heap (may exceed
                        // align8(data+meta) when a whole free block was consumed)
  int32_t refcount;
  uint32_t _pad;
  uint64_t lru_tick;
};

// Free block header lives inside the heap at the block's offset.
struct FreeBlock {
  uint64_t size;        // total block size including header space usability
  uint64_t next;        // absolute offset of next free block, 0 = end
};

struct StoreHeader {
  uint64_t magic;
  uint64_t total_size;      // bytes of whole mapping
  uint64_t table_size;      // number of ObjectEntry slots (power of 2)
  uint64_t heap_start;      // absolute offset of heap
  uint64_t heap_size;
  uint64_t free_head;       // absolute offset of first free block, 0 = none
  uint64_t used_bytes;
  uint64_t lru_clock;
  uint64_t num_objects;
  uint64_t seal_count;      // bumped on every seal (cheap readiness signal)
  uint32_t event_gen;       // futex word: bumped on seal/delete/abort/evict so
                            // waiters (get, channel backpressure) block on a
                            // kernel futex instead of spin-polling. Plasma's
                            // analog is the per-client notification socket
                            // (reference: src/ray/object_manager/plasma/
                            // store.h:55); shared-memory futex needs no
                            // server round-trip.
  uint32_t _pad_ev;
  pthread_mutex_t mutex;
};

struct Handle {
  int fd;
  uint8_t* base;
  uint64_t map_size;
  StoreHeader* hdr;
  ObjectEntry* table;
};

static inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

static uint64_t hash_id(const uint8_t* id) {
  // FNV-1a over the 20-byte id.
  uint64_t h = 1469598103934665603ULL;
  for (uint32_t i = 0; i < kIdSize; i++) { h ^= id[i]; h *= 1099511628211ULL; }
  return h;
}

static void lock(StoreHeader* hdr) {
  int rc = pthread_mutex_lock(&hdr->mutex);
  if (rc == EOWNERDEAD) {
    // Previous owner died mid-section. Data structures may be mid-update;
    // we accept the (tiny) window because all mutations are ordered to keep
    // the table scannable: mark consistent and continue.
    pthread_mutex_consistent(&hdr->mutex);
  }
}

static void unlock(StoreHeader* hdr) { pthread_mutex_unlock(&hdr->mutex); }

// Advance the event generation and wake every futex waiter. Called after any
// state change a waiter could be blocked on (seal makes an object readable;
// delete/abort/evict frees a channel ring slot). No FUTEX_PRIVATE_FLAG: the
// word is shared across processes.
static void bump_event(StoreHeader* hdr) {
  __atomic_fetch_add(&hdr->event_gen, 1, __ATOMIC_ACQ_REL);
  syscall(SYS_futex, &hdr->event_gen, FUTEX_WAKE, INT32_MAX,
          nullptr, nullptr, 0);
}

// Find entry slot for id. Returns slot index or (uint64_t)-1.
static uint64_t find_slot(Handle* h, const uint8_t* id) {
  StoreHeader* hdr = h->hdr;
  uint64_t mask = hdr->table_size - 1;
  uint64_t i = hash_id(id) & mask;
  for (uint64_t probes = 0; probes < hdr->table_size; probes++, i = (i + 1) & mask) {
    ObjectEntry* e = &h->table[i];
    if (e->state == kFree) return (uint64_t)-1;
    if (e->state != kTombstone && memcmp(e->id, id, kIdSize) == 0) return i;
  }
  return (uint64_t)-1;
}

// Find slot to insert id (first free/tombstone on probe path).
static uint64_t find_insert_slot(Handle* h, const uint8_t* id) {
  StoreHeader* hdr = h->hdr;
  uint64_t mask = hdr->table_size - 1;
  uint64_t i = hash_id(id) & mask;
  uint64_t first_tomb = (uint64_t)-1;
  for (uint64_t probes = 0; probes < hdr->table_size; probes++, i = (i + 1) & mask) {
    ObjectEntry* e = &h->table[i];
    if (e->state == kFree) return first_tomb != (uint64_t)-1 ? first_tomb : i;
    if (e->state == kTombstone && first_tomb == (uint64_t)-1) first_tomb = i;
  }
  return first_tomb;
}

// ---------- allocator ----------

static void free_insert(Handle* h, uint64_t off, uint64_t size) {
  // Insert block sorted by offset, coalescing with neighbours.
  StoreHeader* hdr = h->hdr;
  uint64_t prev = 0;
  uint64_t cur = hdr->free_head;
  while (cur != 0 && cur < off) {
    prev = cur;
    cur = ((FreeBlock*)(h->base + cur))->next;
  }
  FreeBlock* nb = (FreeBlock*)(h->base + off);
  nb->size = size;
  nb->next = cur;
  if (prev == 0) hdr->free_head = off; else ((FreeBlock*)(h->base + prev))->next = off;
  // Coalesce with next.
  if (cur != 0 && off + size == cur) {
    FreeBlock* cb = (FreeBlock*)(h->base + cur);
    nb->size += cb->size;
    nb->next = cb->next;
  }
  // Coalesce with prev.
  if (prev != 0) {
    FreeBlock* pb = (FreeBlock*)(h->base + prev);
    if (prev + pb->size == off) {
      pb->size += nb->size;
      pb->next = nb->next;
    }
  }
}

// First-fit allocation. Returns absolute offset or 0 on failure; the actual
// granted size (>= requested) is written to *granted.
static uint64_t heap_alloc(Handle* h, uint64_t size, uint64_t* granted) {
  StoreHeader* hdr = h->hdr;
  size = align8(size);
  if (size < sizeof(FreeBlock)) size = align8(sizeof(FreeBlock));
  uint64_t prev = 0, cur = hdr->free_head;
  while (cur != 0) {
    FreeBlock* b = (FreeBlock*)(h->base + cur);
    if (b->size >= size) {
      uint64_t remaining = b->size - size;
      if (remaining >= align8(sizeof(FreeBlock))) {
        uint64_t newoff = cur + size;
        FreeBlock* nb = (FreeBlock*)(h->base + newoff);
        nb->size = remaining;
        nb->next = b->next;
        if (prev == 0) hdr->free_head = newoff; else ((FreeBlock*)(h->base + prev))->next = newoff;
      } else {
        size = b->size;  // consume whole block
        if (prev == 0) hdr->free_head = b->next; else ((FreeBlock*)(h->base + prev))->next = b->next;
      }
      hdr->used_bytes += size;
      *granted = size;
      return cur;
    }
    prev = cur;
    cur = b->next;
  }
  return 0;
}

static void heap_free(Handle* h, uint64_t off, uint64_t size) {
  h->hdr->used_bytes -= size;
  free_insert(h, off, size);
}

// Tombstones keep probe chains intact, but left forever they degrade misses
// to full-table scans. When the slot after a new tombstone is kFree the chain
// demonstrably ends there, so the tombstone run ending at it can revert to
// kFree.
static void prune_tombstones(Handle* h, uint64_t slot) {
  uint64_t mask = h->hdr->table_size - 1;
  if (h->table[(slot + 1) & mask].state != kFree) return;
  uint64_t i = slot;
  while (h->table[i].state == kTombstone) {
    h->table[i].state = kFree;
    i = (i - 1) & mask;
    if (i == slot) break;  // table entirely tombstones
  }
}

static void remove_entry(Handle* h, uint64_t slot) {
  ObjectEntry* e = &h->table[slot];
  heap_free(h, e->offset, e->alloc_size);
  e->state = kTombstone;
  h->hdr->num_objects--;
  prune_tombstones(h, slot);
}

// Evict the single least-recently-used sealed refcount==0 object.
// Must hold lock. Returns 1 if something was evicted, 0 if no candidate.
static int evict_one(Handle* h) {
  StoreHeader* hdr = h->hdr;
  uint64_t best = (uint64_t)-1;
  uint64_t best_tick = ~0ULL;
  for (uint64_t i = 0; i < hdr->table_size; i++) {
    ObjectEntry* e = &h->table[i];
    if (e->state == kSealed && e->refcount == 0 && e->lru_tick < best_tick) {
      best_tick = e->lru_tick;
      best = i;
    }
  }
  if (best == (uint64_t)-1) return 0;
  remove_entry(h, best);
  return 1;
}

// ---------- public API ----------

void* store_open(const char* path, uint64_t capacity, uint64_t table_size, int create) {
  int fd;
  uint64_t total = 0;
  if (create) {
    fd = open(path, O_RDWR | O_CREAT | O_EXCL, 0600);
    if (fd < 0) return nullptr;
    if (table_size == 0) table_size = 1 << 16;
    // round table_size to power of two
    uint64_t ts = 1; while (ts < table_size) ts <<= 1; table_size = ts;
    uint64_t hdr_bytes = align8(sizeof(StoreHeader));
    uint64_t table_bytes = align8(table_size * sizeof(ObjectEntry));
    total = hdr_bytes + table_bytes + capacity;
    if (ftruncate(fd, (off_t)total) != 0) { close(fd); unlink(path); return nullptr; }
  } else {
    fd = open(path, O_RDWR);
    if (fd < 0) return nullptr;
    // Racing the creator: wait (bounded) for ftruncate to size the file.
    struct stat st;
    int waited_ms = 0;
    for (;;) {
      if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
      if ((uint64_t)st.st_size > sizeof(StoreHeader)) break;
      if (waited_ms >= 10000) { close(fd); return nullptr; }
      usleep(2000);
      waited_ms += 2;
    }
    total = (uint64_t)st.st_size;
  }
  uint8_t* base = (uint8_t*)mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (base == MAP_FAILED) { close(fd); return nullptr; }
  Handle* h = new Handle();
  h->fd = fd;
  h->base = base;
  h->map_size = total;
  h->hdr = (StoreHeader*)base;
  if (create) {
    StoreHeader* hdr = h->hdr;
    memset(base, 0, align8(sizeof(StoreHeader)) + align8(table_size * sizeof(ObjectEntry)));
    hdr->total_size = total;
    hdr->table_size = table_size;
    hdr->heap_start = align8(sizeof(StoreHeader)) + align8(table_size * sizeof(ObjectEntry));
    hdr->heap_size = capacity;
    hdr->used_bytes = 0;
    hdr->lru_clock = 1;
    hdr->num_objects = 0;
    hdr->seal_count = 0;
    // free list = one big block
    FreeBlock* fb = (FreeBlock*)(base + hdr->heap_start);
    fb->size = capacity;
    fb->next = 0;
    hdr->free_head = hdr->heap_start;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&hdr->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    std::atomic_thread_fence(std::memory_order_seq_cst);
    hdr->magic = kMagic;
  } else {
    // The creator writes magic last (after a fence). A client racing the
    // creator's initialization waits bounded time for it to appear.
    int waited_ms = 0;
    while (((volatile StoreHeader*)h->hdr)->magic != kMagic) {
      if (waited_ms >= 10000) { munmap(base, total); close(fd); delete h; return nullptr; }
      usleep(2000);
      waited_ms += 2;
    }
  }
  h->table = (ObjectEntry*)(base + align8(sizeof(StoreHeader)));
  return h;
}

void store_close(void* vh) {
  Handle* h = (Handle*)vh;
  munmap(h->base, h->map_size);
  close(h->fd);
  delete h;
}

uint8_t* store_base(void* vh) { return ((Handle*)vh)->base; }
uint64_t store_capacity(void* vh) { return ((Handle*)vh)->hdr->heap_size; }
uint64_t store_used(void* vh) { return ((Handle*)vh)->hdr->used_bytes; }
uint64_t store_num_objects(void* vh) { return ((Handle*)vh)->hdr->num_objects; }
uint64_t store_seal_count(void* vh) { return ((Handle*)vh)->hdr->seal_count; }

// Current event generation; read it BEFORE a lookup, then pass it to
// store_wait_event so a state change between lookup and wait is never missed.
uint32_t store_event_gen(void* vh) {
  return __atomic_load_n(&((Handle*)vh)->hdr->event_gen, __ATOMIC_ACQUIRE);
}

// Block until the event generation differs from `seen` or timeout_ms elapses
// (timeout_ms < 0 = wait forever). rc: 0 = changed/woken, 1 = timed out.
int store_wait_event(void* vh, uint32_t seen, int timeout_ms) {
  StoreHeader* hdr = ((Handle*)vh)->hdr;
  struct timespec ts;
  struct timespec* tsp = nullptr;
  if (timeout_ms >= 0) {
    ts.tv_sec = timeout_ms / 1000;
    ts.tv_nsec = (long)(timeout_ms % 1000) * 1000000L;
    tsp = &ts;
  }
  if (__atomic_load_n(&hdr->event_gen, __ATOMIC_ACQUIRE) != seen) return 0;
  long rc = syscall(SYS_futex, &hdr->event_gen, FUTEX_WAIT, seen,
                    tsp, nullptr, 0);
  return (rc == -1 && errno == ETIMEDOUT) ? 1 : 0;
}

// rc: 0 ok; -1 already exists; -2 out of memory; -3 table full
// allow_evict=0 makes allocation failure return -2 immediately instead of
// dropping LRU objects, so the caller can spill them to disk first
// (local_object_manager.h:41 spill-before-evict semantics).
int store_create_object(void* vh, const uint8_t* id, uint64_t data_size,
                        uint64_t meta_size, uint64_t* offset_out,
                        int allow_evict) {
  Handle* h = (Handle*)vh;
  StoreHeader* hdr = h->hdr;
  uint64_t need = align8(data_size + meta_size);
  if (need == 0) need = 8;
  lock(hdr);
  if (find_slot(h, id) != (uint64_t)-1) { unlock(hdr); return -1; }
  // Evict one LRU object at a time until the (possibly fragmented) heap can
  // satisfy the request contiguously; freed neighbours coalesce as they go.
  uint64_t granted = 0;
  uint64_t off;
  int evicted_any = 0;
  for (;;) {
    off = heap_alloc(h, need, &granted);
    if (off != 0) break;
    if (!allow_evict || !evict_one(h)) { unlock(hdr); return -2; }
    evicted_any = 1;
  }
  uint64_t slot = find_insert_slot(h, id);
  if (slot == (uint64_t)-1) { heap_free(h, off, granted); unlock(hdr); return -3; }
  ObjectEntry* e = &h->table[slot];
  memcpy(e->id, id, kIdSize);
  e->state = kCreated;
  e->offset = off;
  e->data_size = data_size;
  e->meta_size = meta_size;
  e->alloc_size = granted;
  e->refcount = 1;  // creator holds a reference until seal+release
  e->lru_tick = hdr->lru_clock++;
  hdr->num_objects++;
  unlock(hdr);
  if (evicted_any) bump_event(hdr);
  *offset_out = off;
  return 0;
}

int store_seal(void* vh, const uint8_t* id) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  if (slot == (uint64_t)-1) { unlock(h->hdr); return -1; }
  ObjectEntry* e = &h->table[slot];
  if (e->state != kCreated) { unlock(h->hdr); return -2; }
  e->state = kSealed;
  e->refcount--;  // drop creator reference
  h->hdr->seal_count++;
  unlock(h->hdr);
  bump_event(h->hdr);
  return 0;
}

// Atomically look up a sealed object and take a read reference.
// rc: 0 ok; -1 not found; -2 exists but unsealed
int store_get(void* vh, const uint8_t* id, uint64_t* offset,
              uint64_t* data_size, uint64_t* meta_size) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  if (slot == (uint64_t)-1) { unlock(h->hdr); return -1; }
  ObjectEntry* e = &h->table[slot];
  if (e->state != kSealed) { unlock(h->hdr); return -2; }
  e->refcount++;
  e->lru_tick = h->hdr->lru_clock++;
  *offset = e->offset;
  *data_size = e->data_size;
  *meta_size = e->meta_size;
  unlock(h->hdr);
  return 0;
}

int store_contains(void* vh, const uint8_t* id) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  int rc = (slot != (uint64_t)-1 && h->table[slot].state == kSealed) ? 1 : 0;
  unlock(h->hdr);
  return rc;
}

int store_release(void* vh, const uint8_t* id) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  if (slot == (uint64_t)-1) { unlock(h->hdr); return -1; }
  ObjectEntry* e = &h->table[slot];
  if (e->refcount > 0) e->refcount--;
  unlock(h->hdr);
  return 0;
}

// Delete a sealed, unreferenced object.
// rc: 0 ok; -1 not found; -2 still referenced or not sealed
int store_delete(void* vh, const uint8_t* id) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  if (slot == (uint64_t)-1) { unlock(h->hdr); return -1; }
  ObjectEntry* e = &h->table[slot];
  if (e->refcount > 0 || e->state != kSealed) { unlock(h->hdr); return -2; }
  remove_entry(h, slot);
  unlock(h->hdr);
  bump_event(h->hdr);
  return 0;
}

// Abort an in-progress create (creator only: drops the creator reference and
// frees the buffer). rc: 0 ok; -1 not found; -2 not in created state
int store_abort(void* vh, const uint8_t* id) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t slot = find_slot(h, id);
  if (slot == (uint64_t)-1) { unlock(h->hdr); return -1; }
  ObjectEntry* e = &h->table[slot];
  if (e->state != kCreated) { unlock(h->hdr); return -2; }
  remove_entry(h, slot);
  unlock(h->hdr);
  bump_event(h->hdr);
  return 0;
}

// Fill out up to max ids (each kIdSize bytes) of sealed, unreferenced objects
// in LRU order (oldest tick first): the spill candidates. Returns count.
uint64_t store_lru_candidates(void* vh, uint8_t* ids_out, uint64_t max) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  struct Cand { uint64_t tick; uint64_t slot; };
  std::vector<Cand> cands;
  for (uint64_t i = 0; i < h->hdr->table_size; i++) {
    ObjectEntry* e = &h->table[i];
    if (e->state == kSealed && e->refcount == 0)
      cands.push_back({e->lru_tick, i});
  }
  std::sort(cands.begin(), cands.end(),
            [](const Cand& a, const Cand& b) { return a.tick < b.tick; });
  uint64_t n = 0;
  for (const Cand& c : cands) {
    if (n >= max) break;
    memcpy(ids_out + n * kIdSize, h->table[c.slot].id, kIdSize);
    n++;
  }
  unlock(h->hdr);
  return n;
}

// Fill out up to max ids (each kIdSize bytes) of sealed objects. Returns count.
uint64_t store_list(void* vh, uint8_t* ids_out, uint64_t max) {
  Handle* h = (Handle*)vh;
  lock(h->hdr);
  uint64_t n = 0;
  for (uint64_t i = 0; i < h->hdr->table_size && n < max; i++) {
    ObjectEntry* e = &h->table[i];
    if (e->state == kSealed) {
      memcpy(ids_out + n * kIdSize, e->id, kIdSize);
      n++;
    }
  }
  unlock(h->hdr);
  return n;
}

}  // extern "C"
