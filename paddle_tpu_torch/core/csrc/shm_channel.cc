// Shared-memory batch channel — the native transport of the DataLoader's
// multiprocess worker pool.  Counterpart of the reference's C++ dataloader
// core (python/paddle/io shared-memory path: `use_shared_memory=True` moves
// numpy batches through shm segments instead of pickling them over pipes;
// see fluid/memory/allocation + dataloader_iter's _shared_memory usage).
//
// Design: one POSIX shm segment per channel holding a ring of fixed-size
// slots plus a header with a process-shared ROBUST mutex + condvars (a
// worker SIGKILLed mid-send marks the channel closed instead of deadlocking
// the trainer).  Producers copy a serialized batch into a free slot; the
// consumer copies it out — bulk array bytes are never pickled and cross the
// process boundary through shm, not pipe syscalls.  Multiple producers are
// safe; the reading side is single-consumer (the DataLoader iterator).
//
// C ABI for ctypes.  Records larger than slot_bytes are rejected (the
// Python side sizes slots from the first batch, with headroom).

#include <errno.h>
#include <fcntl.h>
#include <pthread.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <new>
#include <string>

namespace {

struct Header {
  pthread_mutex_t mu;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
  uint64_t slots;
  uint64_t slot_bytes;
  uint64_t head;      // next slot to read
  uint64_t tail;      // next slot to write
  uint64_t count;     // filled slots
  uint32_t closed;    // producer-side EOF mark
  uint32_t magic;
};

constexpr uint32_t kMagic = 0x70746368;  // "ptch"

struct Channel {
  Header* hdr = nullptr;
  uint8_t* data = nullptr;
  size_t map_bytes = 0;
  std::string name;
  bool owner = false;
};

// Lock with robustness: a producer SIGKILLed inside the critical section
// (OOM killer) must not deadlock the trainer.  On EOWNERDEAD the slot state
// is suspect, so the channel is marked closed — the consumer then surfaces
// a worker-death error instead of hanging.
int lock_mu(Header* hd) {
  int rc = pthread_mutex_lock(&hd->mu);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(&hd->mu);
    hd->closed = 1;
    pthread_cond_broadcast(&hd->not_empty);
    pthread_cond_broadcast(&hd->not_full);
    return 0;
  }
  return rc;
}

uint64_t* slot_len_ptr(Channel* c, uint64_t slot) {
  return reinterpret_cast<uint64_t*>(c->data + slot * (c->hdr->slot_bytes + 8));
}

uint8_t* slot_data_ptr(Channel* c, uint64_t slot) {
  return c->data + slot * (c->hdr->slot_bytes + 8) + 8;
}

void abs_deadline(timespec* ts, int timeout_ms) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

}  // namespace

extern "C" {

// Create the channel (trainer side).  Returns handle or null.
void* ptc_create(const char* name, uint64_t slots, uint64_t slot_bytes) {
  size_t bytes = sizeof(Header) + slots * (slot_bytes + 8);
  ::shm_unlink(name);  // stale segment from a crashed run
  int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return nullptr;
  if (::ftruncate(fd, static_cast<off_t>(bytes)) != 0) {
    ::close(fd);
    ::shm_unlink(name);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, bytes, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) {
    ::shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) Header();
  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mu, &ma);
  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_cond_init(&hdr->not_full, &ca);
  hdr->slots = slots;
  hdr->slot_bytes = slot_bytes;
  hdr->head = hdr->tail = hdr->count = 0;
  hdr->closed = 0;
  hdr->magic = kMagic;
  auto* c = new Channel();
  c->hdr = hdr;
  c->data = static_cast<uint8_t*>(mem) + sizeof(Header);
  c->map_bytes = bytes;
  c->name = name;
  c->owner = true;
  return c;
}

// Attach to an existing channel (worker side).
void* ptc_open(const char* name) {
  int fd = ::shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, static_cast<size_t>(st.st_size),
                     PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<Header*>(mem);
  if (hdr->magic != kMagic) {
    ::munmap(mem, static_cast<size_t>(st.st_size));
    return nullptr;
  }
  auto* c = new Channel();
  c->hdr = hdr;
  c->data = static_cast<uint8_t*>(mem) + sizeof(Header);
  c->map_bytes = static_cast<size_t>(st.st_size);
  c->name = name;
  c->owner = false;
  return c;
}

// 0 ok, 1 timeout, 2 record too large, 3 closed, -1 error
int ptc_send(void* h, const uint8_t* buf, uint64_t len, int timeout_ms) {
  auto* c = static_cast<Channel*>(h);
  Header* hd = c->hdr;
  if (len > hd->slot_bytes) return 2;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  lock_mu(hd);
  while (hd->count == hd->slots && !hd->closed) {
    if (pthread_cond_timedwait(&hd->not_full, &hd->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&hd->mu);
      return 1;
    }
  }
  if (hd->closed) {
    pthread_mutex_unlock(&hd->mu);
    return 3;
  }
  uint64_t slot = hd->tail;
  hd->tail = (hd->tail + 1) % hd->slots;
  hd->count += 1;
  *slot_len_ptr(c, slot) = len;
  ::memcpy(slot_data_ptr(c, slot), buf, len);
  pthread_cond_signal(&hd->not_empty);
  pthread_mutex_unlock(&hd->mu);
  return 0;
}

// Returns record length (>0), 0 on closed-and-drained, -1 timeout,
// -2 caller buffer too small.
int64_t ptc_recv(void* h, uint8_t* out, uint64_t cap, int timeout_ms) {
  auto* c = static_cast<Channel*>(h);
  Header* hd = c->hdr;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  lock_mu(hd);
  while (hd->count == 0) {
    if (hd->closed) {
      pthread_mutex_unlock(&hd->mu);
      return 0;
    }
    if (pthread_cond_timedwait(&hd->not_empty, &hd->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&hd->mu);
      return -1;
    }
  }
  uint64_t slot = hd->head;
  uint64_t len = *slot_len_ptr(c, slot);
  if (len > cap) {
    pthread_mutex_unlock(&hd->mu);
    return -2;
  }
  ::memcpy(out, slot_data_ptr(c, slot), len);
  hd->head = (hd->head + 1) % hd->slots;
  hd->count -= 1;
  pthread_cond_signal(&hd->not_full);
  pthread_mutex_unlock(&hd->mu);
  return static_cast<int64_t>(len);
}

// Block until a record is available (0), closed-and-drained (2), or
// timeout (1) — lets the consumer wait WITHOUT allocating a receive buffer.
int ptc_wait_nonempty(void* h, int timeout_ms) {
  auto* c = static_cast<Channel*>(h);
  Header* hd = c->hdr;
  timespec ts;
  abs_deadline(&ts, timeout_ms);
  lock_mu(hd);
  while (hd->count == 0) {
    if (hd->closed) {
      pthread_mutex_unlock(&hd->mu);
      return 2;
    }
    if (pthread_cond_timedwait(&hd->not_empty, &hd->mu, &ts) == ETIMEDOUT) {
      pthread_mutex_unlock(&hd->mu);
      return 1;
    }
  }
  pthread_mutex_unlock(&hd->mu);
  return 0;
}

// Peek the next record's length without consuming (-1 if empty).
int64_t ptc_next_len(void* h) {
  auto* c = static_cast<Channel*>(h);
  Header* hd = c->hdr;
  lock_mu(hd);
  int64_t r = hd->count ? static_cast<int64_t>(*slot_len_ptr(c, hd->head)) : -1;
  pthread_mutex_unlock(&hd->mu);
  return r;
}

void ptc_mark_closed(void* h) {
  auto* c = static_cast<Channel*>(h);
  lock_mu(c->hdr);
  c->hdr->closed = 1;
  pthread_cond_broadcast(&c->hdr->not_empty);
  pthread_cond_broadcast(&c->hdr->not_full);
  pthread_mutex_unlock(&c->hdr->mu);
}

uint64_t ptc_slot_bytes(void* h) {
  return static_cast<Channel*>(h)->hdr->slot_bytes;
}

void ptc_close(void* h) {
  auto* c = static_cast<Channel*>(h);
  bool owner = c->owner;
  std::string name = c->name;
  void* base = reinterpret_cast<uint8_t*>(c->hdr);
  ::munmap(base, c->map_bytes);
  if (owner) ::shm_unlink(name.c_str());
  delete c;
}

}  // extern "C"
