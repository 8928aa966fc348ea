// Native host tracer — the counterpart of the reference's profiler host path
// (fluid/platform/profiler/host_tracer.cc RecordEvent collection,
// chrometracing_logger.cc chrome://tracing JSON export, event_node.cc tree
// assembly).  Device-side timing comes from the CUDA profiler; this
// library provides the low-overhead HOST annotation spans that bracket
// Python-side work (data loading, dispatch, checkpoint IO) without paying
// Python-level clock+append costs inside hot loops.
//
// Design: per-thread span stacks (thread_local, no lock on begin/end fast
// path except a once-per-thread registration), steady-clock nanosecond
// timestamps, completed spans appended to a per-thread buffer; export merges
// buffers into chrome-trace "X" (complete) events.  C ABI for ctypes.

#include <sys/syscall.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

inline uint64_t now_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

struct Span {
  std::string name;
  uint64_t start_ns;
  uint64_t end_ns;
  int64_t tid;
};

struct Counter {
  std::string name;
  uint64_t ts_ns;
  double value;
  int64_t tid;
};

struct ThreadBuf {
  // mu guards open/done/counters: the owning thread appends under it, and
  // export/clear/count (any thread, holding g_mu) read under it too — an
  // uncontended lock on the hot path, but drain can no longer race a
  // push_back's reallocation
  std::mutex mu;
  std::vector<Span> open;       // stack of in-flight spans
  std::vector<Span> done;
  std::vector<Counter> counters;
  int64_t tid = 0;
};

std::mutex g_mu;                       // guards g_bufs registration + export
std::vector<ThreadBuf*> g_bufs;        // one per thread ever seen
std::atomic<bool> g_enabled{false};

ThreadBuf* tls() {
  thread_local ThreadBuf* buf = nullptr;
  if (buf == nullptr) {
    buf = new ThreadBuf();
    buf->tid = static_cast<int64_t>(::syscall(SYS_gettid));
    std::lock_guard<std::mutex> g(g_mu);
    g_bufs.push_back(buf);
  }
  return buf;
}

void json_escape(const std::string& in, std::string* out) {
  for (char c : in) {
    switch (c) {
      case '"': *out += "\\\""; break;
      case '\\': *out += "\\\\"; break;
      case '\n': *out += "\\n"; break;
      case '\t': *out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          std::snprintf(buf, sizeof(buf), "\\u%04x", c);
          *out += buf;
        } else {
          *out += c;
        }
    }
  }
}

}  // namespace

extern "C" {

void ptt_enable() { g_enabled.store(true, std::memory_order_relaxed); }
void ptt_disable() { g_enabled.store(false, std::memory_order_relaxed); }
int ptt_enabled() { return g_enabled.load(std::memory_order_relaxed) ? 1 : 0; }

void ptt_begin(const char* name) {
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  ThreadBuf* b = tls();
  std::lock_guard<std::mutex> g(b->mu);
  b->open.push_back(Span{name, now_ns(), 0, b->tid});
}

void ptt_end() {
  // pop even when disabled: a span that straddles Profiler.stop() must not
  // linger on the open stack (it would surface later as a bogus huge span);
  // only the RECORDING of the completed span is gated on enabled
  ThreadBuf* b = tls();
  std::lock_guard<std::mutex> g(b->mu);
  if (b->open.empty()) return;  // unmatched end: drop (enable raced a begin)
  Span s = std::move(b->open.back());
  b->open.pop_back();
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  s.end_ns = now_ns();
  b->done.push_back(std::move(s));
}

void ptt_counter(const char* name, double value) {
  if (!g_enabled.load(std::memory_order_relaxed)) return;
  ThreadBuf* b = tls();
  std::lock_guard<std::mutex> g(b->mu);
  b->counters.push_back(Counter{name, now_ns(), value, b->tid});
}

// Record a pre-timed span (for wrapping host work timed externally).
void ptt_span(const char* name, uint64_t start_ns, uint64_t end_ns) {
  ThreadBuf* b = tls();
  std::lock_guard<std::mutex> g(b->mu);
  b->done.push_back(Span{name, start_ns, end_ns, b->tid});
}

uint64_t ptt_now_ns() { return now_ns(); }

int64_t ptt_num_events() {
  std::lock_guard<std::mutex> g(g_mu);
  int64_t n = 0;
  for (auto* b : g_bufs) {
    std::lock_guard<std::mutex> gb(b->mu);
    n += static_cast<int64_t>(b->done.size() + b->counters.size());
  }
  return n;
}

void ptt_clear() {
  std::lock_guard<std::mutex> g(g_mu);
  for (auto* b : g_bufs) {
    std::lock_guard<std::mutex> gb(b->mu);
    b->done.clear();
    b->counters.clear();
    // stale in-flight spans from a previous profiling session would pair
    // with a future ptt_end and emit garbage; a fresh session starts empty
    b->open.clear();
  }
}

// Export all completed spans as a chrome://tracing JSON file.
// pid is the caller's label (usually the OS pid / rank).  Returns 0 on
// success.  Timestamps are emitted in microseconds (chrome-trace unit),
// relative to the earliest span so traces start near t=0.
int ptt_export_chrome(const char* path, int64_t pid) {
  std::lock_guard<std::mutex> g(g_mu);
  uint64_t t0 = UINT64_MAX;
  for (auto* b : g_bufs) {
    std::lock_guard<std::mutex> gb(b->mu);
    for (auto& s : b->done) t0 = s.start_ns < t0 ? s.start_ns : t0;
    for (auto& c : b->counters) t0 = c.ts_ns < t0 ? c.ts_ns : t0;
  }
  if (t0 == UINT64_MAX) t0 = 0;
  std::FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fputs("{\"traceEvents\":[\n", f);
  bool first = true;
  std::string esc;
  for (auto* b : g_bufs) {
    std::lock_guard<std::mutex> gb(b->mu);
    for (auto& s : b->done) {
      esc.clear();
      json_escape(s.name, &esc);
      double ts_us = static_cast<double>(s.start_ns - t0) / 1e3;
      double dur_us = static_cast<double>(s.end_ns - s.start_ns) / 1e3;
      std::fprintf(f,
                   "%s{\"name\":\"%s\",\"ph\":\"X\",\"pid\":%lld,\"tid\":%lld,"
                   "\"ts\":%.3f,\"dur\":%.3f}",
                   first ? "" : ",\n", esc.c_str(),
                   static_cast<long long>(pid), static_cast<long long>(s.tid),
                   ts_us, dur_us);
      first = false;
    }
    for (auto& c : b->counters) {
      esc.clear();
      json_escape(c.name, &esc);
      double ts_us = static_cast<double>(c.ts_ns - t0) / 1e3;
      std::fprintf(f,
                   "%s{\"name\":\"%s\",\"ph\":\"C\",\"pid\":%lld,\"tid\":%lld,"
                   "\"ts\":%.3f,\"args\":{\"value\":%g}}",
                   first ? "" : ",\n", esc.c_str(),
                   static_cast<long long>(pid), static_cast<long long>(c.tid),
                   ts_us, c.value);
      first = false;
    }
  }
  std::fputs("\n]}\n", f);
  std::fclose(f);
  return 0;
}

}  // extern "C"
