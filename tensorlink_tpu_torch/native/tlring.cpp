// tlring — shared-memory message ring for the ML↔network process bridge.
//
// The reference parks tensors in POSIX shared memory and polls queues at
// 1 kHz under a global lock (nodes/shared_memory.py, torch_node.py:838-851,
// nodes/nodes.py:201-235). This is the native replacement: a byte-message
// ring over shm_open+mmap with process-shared pthread mutex/condvars —
// blocking reads (no polling), one copy per side, no pickling.
//
// Layout: [Header][data bytes (capacity)]
// Messages are u64 length-prefixed and wrap around the ring. Single
// logical producer / single logical consumer per ring (the Python wrapper
// serializes same-process producers with a lock).
//
// Build: g++ -O2 -shared -fPIC -o libtlring.so tlring.cpp -lpthread -lrt

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x544c52494e470001ULL;  // "TLRING" v1

struct Header {
  uint64_t magic;
  uint64_t capacity;        // data area size in bytes
  uint64_t head;            // monotonic write offset (guarded by mu)
  uint64_t tail;            // monotonic read offset (guarded by mu)
  uint32_t closed;
  uint32_t _pad;
  pthread_mutex_t mu;
  pthread_cond_t nonempty;
  pthread_cond_t nonfull;
};

struct Ring {
  Header* hdr;
  uint8_t* data;
  uint64_t map_len;
  int owner;  // created (1) vs attached (0)
};

void abstime_in(double seconds, timespec* ts) {
  clock_gettime(CLOCK_REALTIME, ts);
  time_t sec = static_cast<time_t>(seconds);
  long nsec = static_cast<long>((seconds - static_cast<double>(sec)) * 1e9);
  ts->tv_sec += sec;
  ts->tv_nsec += nsec;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

uint64_t used(const Header* h) { return h->head - h->tail; }

void copy_in(Ring* r, uint64_t pos, const uint8_t* src, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t off = pos % cap;
  const uint64_t first = (off + len <= cap) ? len : cap - off;
  memcpy(r->data + off, src, first);
  if (first < len) memcpy(r->data, src + first, len - first);
}

void copy_out(Ring* r, uint64_t pos, uint8_t* dst, uint64_t len) {
  const uint64_t cap = r->hdr->capacity;
  const uint64_t off = pos % cap;
  const uint64_t first = (off + len <= cap) ? len : cap - off;
  memcpy(dst, r->data + off, first);
  if (first < len) memcpy(dst + first, r->data, len - first);
}

}  // namespace

extern "C" {

// Returns opaque handle or nullptr.
void* tlring_create(const char* name, uint64_t capacity) {
  shm_unlink(name);  // stale segment from a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(Header) + capacity;
  if (ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  Header* h = static_cast<Header*>(mem);
  memset(h, 0, sizeof(Header));
  h->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&h->mu, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&h->nonempty, &ca);
  pthread_cond_init(&h->nonfull, &ca);
  pthread_condattr_destroy(&ca);

  h->magic = MAGIC;  // last: attachers spin on it
  Ring* r = new Ring{h, reinterpret_cast<uint8_t*>(mem) + sizeof(Header),
                     total, 1};
  return r;
}

void* tlring_attach(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < static_cast<off_t>(sizeof(Header))) {
    close(fd);
    return nullptr;
  }
  void* mem =
      mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ | PROT_WRITE,
           MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* h = static_cast<Header*>(mem);
  if (h->magic != MAGIC) {
    munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  Ring* r = new Ring{h, reinterpret_cast<uint8_t*>(mem) + sizeof(Header),
                     static_cast<uint64_t>(st.st_size), 0};
  return r;
}

static int lock_mu(Header* h) {
  int rc = pthread_mutex_lock(&h->mu);
  if (rc == EOWNERDEAD) {  // peer died holding the lock; state is a byte
    pthread_mutex_consistent(&h->mu);  // ring — counters stay coherent
    return 0;
  }
  return rc;
}

// 0 ok, -1 timeout, -2 closed, -3 message larger than capacity, -4 error
int tlring_write(void* rp, const uint8_t* buf, uint64_t len, double timeout_s) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->hdr;
  const uint64_t need = len + 8;
  if (need > h->capacity) return -3;
  timespec deadline;
  abstime_in(timeout_s, &deadline);
  if (lock_mu(h) != 0) return -4;
  while (h->capacity - used(h) < need && !h->closed) {
    int rc = pthread_cond_timedwait(&h->nonfull, &h->mu, &deadline);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
    if (rc == EOWNERDEAD) {  // peer died holding the lock mid-wait
      pthread_mutex_consistent(&h->mu);
      continue;
    }
    if (rc != 0) {  // persistent error: don't spin
      pthread_mutex_unlock(&h->mu);
      return -4;
    }
  }
  if (h->closed) {
    pthread_mutex_unlock(&h->mu);
    return -2;
  }
  uint64_t le_len = len;  // little-endian hosts only (x86/ARM/TPU VMs)
  copy_in(r, h->head, reinterpret_cast<uint8_t*>(&le_len), 8);
  copy_in(r, h->head + 8, buf, len);
  h->head += need;
  pthread_cond_signal(&h->nonempty);
  pthread_mutex_unlock(&h->mu);
  return 0;
}

// >=0: size of next message (kept in ring); -1 timeout, -2 closed+drained, -4 err
int64_t tlring_next_size(void* rp, double timeout_s) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->hdr;
  timespec deadline;
  abstime_in(timeout_s, &deadline);
  if (lock_mu(h) != 0) return -4;
  while (used(h) == 0) {
    if (h->closed) {
      pthread_mutex_unlock(&h->mu);
      return -2;
    }
    int rc = pthread_cond_timedwait(&h->nonempty, &h->mu, &deadline);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&h->mu);
      return -1;
    }
    if (rc == EOWNERDEAD) {  // peer died holding the lock mid-wait
      pthread_mutex_consistent(&h->mu);
      continue;
    }
    if (rc != 0) {  // persistent error: don't spin
      pthread_mutex_unlock(&h->mu);
      return -4;
    }
  }
  uint64_t len = 0;
  copy_out(r, h->tail, reinterpret_cast<uint8_t*>(&len), 8);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len);
}

// Copies the next message into buf (must be >= its size) and advances.
// Returns message size, or -4 on usage error.
int64_t tlring_read(void* rp, uint8_t* buf, uint64_t buflen) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->hdr;
  if (lock_mu(h) != 0) return -4;
  if (used(h) == 0) {
    pthread_mutex_unlock(&h->mu);
    return -4;
  }
  uint64_t len = 0;
  copy_out(r, h->tail, reinterpret_cast<uint8_t*>(&len), 8);
  if (len > buflen) {
    pthread_mutex_unlock(&h->mu);
    return -4;
  }
  copy_out(r, h->tail + 8, buf, len);
  h->tail += len + 8;
  pthread_cond_signal(&h->nonfull);
  pthread_mutex_unlock(&h->mu);
  return static_cast<int64_t>(len);
}

void tlring_close(void* rp) {
  Ring* r = static_cast<Ring*>(rp);
  Header* h = r->hdr;
  if (lock_mu(h) == 0) {
    h->closed = 1;
    pthread_cond_broadcast(&h->nonempty);
    pthread_cond_broadcast(&h->nonfull);
    pthread_mutex_unlock(&h->mu);
  }
}

void tlring_detach(void* rp) {
  Ring* r = static_cast<Ring*>(rp);
  munmap(r->hdr, r->map_len);
  delete r;
}

int tlring_unlink(const char* name) { return shm_unlink(name); }

}  // extern "C"
