// TCP key-value store for multi-host bootstrap — the native component playing
// the role of the reference's TCPStore (phi/core/distributed/store/tcp_store.h:121
// `class TCPStore : Store`, tcp_utils.cc socket helpers).
//
// Design: the device-level rendezvous belongs to torch.distributed; this
// store covers the HOST-side control plane the reference uses TCPStore
// for — launcher rendezvous, elastic membership, rpc worker registry,
// checkpoint coordination.  One coordinator (rank 0) serves a map
// key -> bytes over length-prefixed TCP; clients issue SET/GET/ADD/WAIT/DELETE.
// WAIT blocks server-side on a condition variable (no client polling), which is
// the same "wait until key appears" contract as the reference's Store::wait.
//
// Exposed as a C ABI for ctypes (environment has no pybind11).
//
// Wire protocol (length prefixes big-endian; integer VALUE payloads
// little-endian — every supported host is LE, and the Python fallback
// encodes them '<q'/'<I' to match):
//   request:  u8 cmd | u32 klen | key | [u32 vlen | value]   (value: SET only)
//             ADD carries an i64 delta as an 8-byte LE value.
//             WAIT carries a u32 timeout_ms as a 4-byte LE value.
//   response: u8 status (0 ok, 1 missing/timeout) | u32 vlen | value
//
// Concurrency: one thread per client connection (bootstrap-scale fan-in:
// hundreds of hosts, not millions), shared map under one mutex + condvar.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

enum Cmd : uint8_t { kSet = 1, kGet = 2, kAdd = 3, kWait = 4, kDelete = 5 };

bool send_all(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_u32(int fd, uint32_t v) {
  uint32_t be = htonl(v);
  return send_all(fd, &be, 4);
}

bool recv_u32(int fd, uint32_t* v) {
  uint32_t be;
  if (!recv_all(fd, &be, 4)) return false;
  *v = ntohl(be);
  return true;
}

bool send_bytes(int fd, const std::string& s) {
  return send_u32(fd, static_cast<uint32_t>(s.size())) &&
         (s.empty() || send_all(fd, s.data(), s.size()));
}

bool recv_bytes(int fd, std::string* out) {
  uint32_t n;
  if (!recv_u32(fd, &n)) return false;
  out->resize(n);
  return n == 0 || recv_all(fd, &(*out)[0], n);
}

class StoreServer {
 public:
  explicit StoreServer(int port) : port_(port) {}

  bool Start() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        ::listen(listen_fd_, 512) != 0) {
      ::close(listen_fd_);
      listen_fd_ = -1;
      return false;
    }
    if (port_ == 0) {  // report the kernel-assigned port
      socklen_t len = sizeof(addr);
      ::getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &len);
      port_ = ntohs(addr.sin_port);
    }
    accept_thread_ = std::thread([this] { AcceptLoop(); });
    return true;
  }

  void Stop() {
    stop_.store(true);
    if (listen_fd_ >= 0) {
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      listen_fd_ = -1;
    }
    cv_.notify_all();
    // join the accept thread FIRST: a connection accepted concurrently with
    // Stop() is guaranteed registered once this join returns, so the
    // client-fd shutdown pass below cannot miss it (and then hang on join)
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<Client*> clients;
    {
      std::lock_guard<std::mutex> g(threads_mu_);
      clients.swap(clients_);
    }
    for (auto* c : clients) {
      // unblock Serve threads parked in recv on a still-connected client;
      // without this, Stop() would hang until every peer disconnects
      ::shutdown(c->fd, SHUT_RDWR);
    }
    for (auto* c : clients) {
      if (c->thread.joinable()) c->thread.join();
      // fd closes only after its Serve thread exited — closing earlier
      // would let the kernel recycle the fd number while we still hold it
      ::close(c->fd);
      delete c;
    }
  }

  int port() const { return port_; }
  int num_keys() {
    std::lock_guard<std::mutex> g(mu_);
    return static_cast<int>(kv_.size());
  }

  ~StoreServer() { Stop(); }

 private:
  struct Client {
    int fd;
    std::thread thread;
    std::atomic<bool> done{false};
  };

  void ReapFinished() {
    // join Serve threads that already exited and release their fds, so a
    // long-lived coordinator serving churning clients (elastic membership,
    // checkpoint coordination) does not grow fds/threads monotonically
    std::vector<Client*> dead;
    {
      std::lock_guard<std::mutex> g(threads_mu_);
      for (auto it = clients_.begin(); it != clients_.end();) {
        if ((*it)->done.load()) {
          dead.push_back(*it);
          it = clients_.erase(it);
        } else {
          ++it;
        }
      }
    }
    for (auto* c : dead) {
      if (c->thread.joinable()) c->thread.join();
      ::close(c->fd);
      delete c;
    }
  }

  void AcceptLoop() {
    while (!stop_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (stop_.load()) return;
        continue;
      }
      ReapFinished();
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new Client{fd, {}, };
      std::lock_guard<std::mutex> g(threads_mu_);
      clients_.push_back(c);
      c->thread = std::thread([this, c] { Serve(c); });
    }
  }

  void Serve(Client* client) {
    const int fd = client->fd;
    while (!stop_.load()) {
      uint8_t cmd;
      if (!recv_all(fd, &cmd, 1)) break;
      std::string key;
      if (!recv_bytes(fd, &key)) break;
      bool ok = true;
      switch (cmd) {
        case kSet: {
          std::string val;
          if (!(ok = recv_bytes(fd, &val))) break;
          {
            std::lock_guard<std::mutex> g(mu_);
            kv_[key] = std::move(val);
          }
          cv_.notify_all();
          ok = send_all(fd, "\0", 1) && send_u32(fd, 0);
          break;
        }
        case kGet: {
          std::unique_lock<std::mutex> g(mu_);
          auto it = kv_.find(key);
          if (it == kv_.end()) {
            g.unlock();
            ok = send_all(fd, "\1", 1) && send_u32(fd, 0);
          } else {
            std::string val = it->second;
            g.unlock();
            ok = send_all(fd, "\0", 1) && send_bytes(fd, val);
          }
          break;
        }
        case kAdd: {
          std::string val;
          if (!(ok = recv_bytes(fd, &val)) || val.size() != 8) { ok = false; break; }
          int64_t delta;
          std::memcpy(&delta, val.data(), 8);  // client sends host order (same arch)
          int64_t now;
          {
            std::lock_guard<std::mutex> g(mu_);
            int64_t cur = 0;
            auto it = kv_.find(key);
            if (it != kv_.end() && it->second.size() == 8)
              std::memcpy(&cur, it->second.data(), 8);
            now = cur + delta;
            std::string enc(8, '\0');
            std::memcpy(&enc[0], &now, 8);
            kv_[key] = enc;
          }
          cv_.notify_all();
          std::string enc(8, '\0');
          std::memcpy(&enc[0], &now, 8);
          ok = send_all(fd, "\0", 1) && send_bytes(fd, enc);
          break;
        }
        case kWait: {
          std::string val;
          if (!(ok = recv_bytes(fd, &val)) || val.size() != 4) { ok = false; break; }
          uint32_t timeout_ms;
          std::memcpy(&timeout_ms, val.data(), 4);
          std::unique_lock<std::mutex> g(mu_);
          bool found = cv_.wait_for(g, std::chrono::milliseconds(timeout_ms), [&] {
            return stop_.load() || kv_.count(key) > 0;
          });
          bool have = found && kv_.count(key) > 0;
          g.unlock();
          ok = send_all(fd, have ? "\0" : "\1", 1) && send_u32(fd, 0);
          break;
        }
        case kDelete: {
          {
            std::lock_guard<std::mutex> g(mu_);
            kv_.erase(key);
          }
          ok = send_all(fd, "\0", 1) && send_u32(fd, 0);
          break;
        }
        default:
          ok = false;
      }
      if (!ok) break;
    }
    ::shutdown(fd, SHUT_RDWR);  // closed by ReapFinished()/Stop() after join
    client->done.store(true);
  }

  int port_;
  int listen_fd_ = -1;
  std::atomic<bool> stop_{false};
  std::thread accept_thread_;
  std::mutex threads_mu_;
  std::vector<Client*> clients_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> kv_;
};

class StoreClient {
 public:
  bool Connect(const char* host, int port, int timeout_ms) {
    addrinfo hints{}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    char portbuf[16];
    std::snprintf(portbuf, sizeof(portbuf), "%d", port);
    if (::getaddrinfo(host, portbuf, &hints, &res) != 0 || !res) return false;
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::milliseconds(timeout_ms);
    // retry until the coordinator is up (reference tcp_utils retries too)
    while (std::chrono::steady_clock::now() < deadline) {
      fd_ = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
      if (fd_ >= 0 && ::connect(fd_, res->ai_addr, res->ai_addrlen) == 0) {
        int one = 1;
        ::setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        ::freeaddrinfo(res);
        return true;
      }
      if (fd_ >= 0) ::close(fd_);
      fd_ = -1;
      std::this_thread::sleep_for(std::chrono::milliseconds(50));
    }
    ::freeaddrinfo(res);
    return false;
  }

  void Close() {
    if (fd_ >= 0) ::close(fd_);
    fd_ = -1;
  }

  bool Set(const std::string& key, const std::string& val) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kSet;
    if (!(send_all(fd_, &cmd, 1) && send_bytes(fd_, key) && send_bytes(fd_, val)))
      return false;
    uint8_t status;
    std::string ignore;
    return recv_all(fd_, &status, 1) && recv_bytes(fd_, &ignore) && status == 0;
  }

  // returns: 0 ok, 1 missing, -1 io error
  int Get(const std::string& key, std::string* out) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kGet;
    if (!(send_all(fd_, &cmd, 1) && send_bytes(fd_, key))) return -1;
    uint8_t status;
    if (!recv_all(fd_, &status, 1)) return -1;
    if (!recv_bytes(fd_, out)) return -1;
    return status == 0 ? 0 : 1;
  }

  bool Add(const std::string& key, int64_t delta, int64_t* result) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kAdd;
    std::string enc(8, '\0');
    std::memcpy(&enc[0], &delta, 8);
    if (!(send_all(fd_, &cmd, 1) && send_bytes(fd_, key) && send_bytes(fd_, enc)))
      return false;
    uint8_t status;
    std::string val;
    if (!(recv_all(fd_, &status, 1) && recv_bytes(fd_, &val)) || status != 0 ||
        val.size() != 8)
      return false;
    std::memcpy(result, val.data(), 8);
    return true;
  }

  // returns: 0 ok, 1 timeout, -1 io error
  int Wait(const std::string& key, int timeout_ms) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kWait;
    std::string enc(4, '\0');
    uint32_t t = static_cast<uint32_t>(timeout_ms);
    std::memcpy(&enc[0], &t, 4);
    if (!(send_all(fd_, &cmd, 1) && send_bytes(fd_, key) && send_bytes(fd_, enc)))
      return -1;
    uint8_t status;
    std::string ignore;
    if (!(recv_all(fd_, &status, 1) && recv_bytes(fd_, &ignore))) return -1;
    return status == 0 ? 0 : 1;
  }

  bool Delete(const std::string& key) {
    std::lock_guard<std::mutex> g(mu_);
    uint8_t cmd = kDelete;
    if (!(send_all(fd_, &cmd, 1) && send_bytes(fd_, key))) return false;
    uint8_t status;
    std::string ignore;
    return recv_all(fd_, &status, 1) && recv_bytes(fd_, &ignore) && status == 0;
  }

 private:
  int fd_ = -1;
  std::mutex mu_;  // one outstanding request per client handle
};

}  // namespace

extern "C" {

void* pts_server_start(int port) {
  auto* s = new StoreServer(port);
  if (!s->Start()) {
    delete s;
    return nullptr;
  }
  return s;
}

int pts_server_port(void* h) { return static_cast<StoreServer*>(h)->port(); }
int pts_server_num_keys(void* h) {
  return static_cast<StoreServer*>(h)->num_keys();
}

void pts_server_stop(void* h) {
  auto* s = static_cast<StoreServer*>(h);
  s->Stop();
  delete s;
}

void* pts_client_connect(const char* host, int port, int timeout_ms) {
  auto* c = new StoreClient();
  if (!c->Connect(host, port, timeout_ms)) {
    delete c;
    return nullptr;
  }
  return c;
}

void pts_client_close(void* h) {
  auto* c = static_cast<StoreClient*>(h);
  c->Close();
  delete c;
}

// Keys are length-delimited (klen), never NUL-terminated: binary keys with
// embedded NULs must behave identically to the Python fallback client.

static std::string pts_key(const uint8_t* key, int klen) {
  return std::string(reinterpret_cast<const char*>(key), klen);
}

int pts_set(void* h, const uint8_t* key, int klen, const uint8_t* val,
            int vlen) {
  return static_cast<StoreClient*>(h)->Set(pts_key(key, klen), std::string(
             reinterpret_cast<const char*>(val), vlen))
             ? 0
             : -1;
}

// Two-call get: pts_get fills a malloc'd buffer the caller frees via
// pts_buf_free.  Returns 0 ok / 1 missing / -1 error.
int pts_get(void* h, const uint8_t* key, int klen, uint8_t** out,
            int* out_len) {
  std::string val;
  int rc = static_cast<StoreClient*>(h)->Get(pts_key(key, klen), &val);
  if (rc != 0) {
    *out = nullptr;
    *out_len = 0;
    return rc;
  }
  *out = static_cast<uint8_t*>(std::malloc(val.size() ? val.size() : 1));
  std::memcpy(*out, val.data(), val.size());
  *out_len = static_cast<int>(val.size());
  return 0;
}

void pts_buf_free(uint8_t* p) { std::free(p); }

int pts_add(void* h, const uint8_t* key, int klen, int64_t delta,
            int64_t* result) {
  return static_cast<StoreClient*>(h)->Add(pts_key(key, klen), delta, result)
             ? 0
             : -1;
}

int pts_wait(void* h, const uint8_t* key, int klen, int timeout_ms) {
  return static_cast<StoreClient*>(h)->Wait(pts_key(key, klen), timeout_ms);
}

int pts_delete(void* h, const uint8_t* key, int klen) {
  return static_cast<StoreClient*>(h)->Delete(pts_key(key, klen)) ? 0 : -1;
}

}  // extern "C"
