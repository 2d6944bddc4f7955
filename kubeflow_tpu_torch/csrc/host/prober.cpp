// Concurrent slice-activity prober: the port's own copy of
// native/prober.cpp, built with g++ (not nvcc) by
// kubeflow_tpu_torch/ops/_build.py's build_host.
//
// The culler must observe Jupyter activity on EVERY host of a slice before
// each idleness verdict. Sequential probing makes the reconcile latency
// O(hosts x timeout) — a slice of many hosts and a 5s timeout could wedge a
// reconcile for minutes when hosts are partitioned. This prober issues all
// HTTP GETs concurrently from a thread pool, so wall time is one timeout
// regardless of slice size.
//
// Plain HTTP/1.0 over raw sockets: in-cluster pod traffic, same as the
// reference culler's http.Get. No TLS by design (NetworkPolicies scope who
// may reach 8888).
//
// C ABI (ctypes, kubeflow_tpu_torch/controller/prober.py):
//   pr_probe(urls, n, timeout_ms, bodies, body_cap, statuses) -> 0
//     urls:      array of n C strings "http://host:port/path"
//     bodies:    n * body_cap char buffer; body i at offset i*body_cap,
//                NUL-terminated, truncated to body_cap-1
//     statuses:  per-URL HTTP status, or -1 connect/timeout, -2 bad URL
//
// Determinism/safety: no globals, no signals; each probe owns its socket.

#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <memory>
#include <mutex>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <netdb.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>
#include <fcntl.h>

namespace {

struct Url {
  std::string host;
  std::string port;
  std::string path;
};

bool parse_url(const char* raw, Url* out) {
  std::string s(raw);
  const std::string scheme = "http://";
  if (s.rfind(scheme, 0) != 0) return false;
  s = s.substr(scheme.size());
  size_t slash = s.find('/');
  std::string hostport = slash == std::string::npos ? s : s.substr(0, slash);
  out->path = slash == std::string::npos ? "/" : s.substr(slash);
  size_t colon = hostport.rfind(':');
  if (colon == std::string::npos) {
    out->host = hostport;
    out->port = "80";
  } else {
    out->host = hostport.substr(0, colon);
    out->port = hostport.substr(colon + 1);
  }
  return !out->host.empty();
}

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// Milliseconds left before the absolute deadline; <= 0 means expired.
int remaining_ms(int64_t deadline) {
  int64_t left = deadline - now_ms();
  if (left <= 0) return 0;
  if (left > INT32_MAX) left = INT32_MAX;
  return static_cast<int>(left);
}

// getaddrinfo has no timeout parameter, and a hung resolver (kube-dns
// partition — precisely when the culler probes a partitioned slice) would
// otherwise wedge a worker thread past any deadline. Run it in a helper
// thread and wait with a deadline; on timeout the helper is detached and
// cleans up after itself whenever libc eventually returns.
struct ResolveState {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  bool abandoned = false;
  addrinfo* res = nullptr;
};

addrinfo* resolve_with_deadline(const std::string& host,
                                const std::string& port, int64_t deadline) {
  auto st = std::make_shared<ResolveState>();
  std::thread worker([st, host, port]() {
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    int rc = getaddrinfo(host.c_str(), port.c_str(), &hints, &res);
    std::lock_guard<std::mutex> lock(st->mu);
    st->done = true;
    if (st->abandoned) {
      // Probe gave up; nobody will read res.
      if (rc == 0 && res) freeaddrinfo(res);
    } else {
      st->res = rc == 0 ? res : nullptr;
    }
    st->cv.notify_one();
  });
  std::unique_lock<std::mutex> lock(st->mu);
  // now_ms() is steady_clock-based, so the deadline converts directly.
  auto abs_deadline = std::chrono::steady_clock::time_point(
      std::chrono::duration_cast<std::chrono::steady_clock::duration>(
          std::chrono::milliseconds(deadline)));
  bool finished =
      st->cv.wait_until(lock, abs_deadline, [&] { return st->done; });
  if (finished) {
    worker.join();
    return st->res;
  }
  st->abandoned = true;
  lock.unlock();
  worker.detach();  // bounded leak: one blocked resolver thread, self-freeing
  return nullptr;
}

// Connect before the absolute deadline; returns fd or -1. The deadline is
// shared across resolution AND every resolved address — a probe never gets
// more than its overall budget.
int connect_deadline(const Url& u, int64_t deadline) {
  addrinfo* res = resolve_with_deadline(u.host, u.port, deadline);
  if (!res) return -1;
  int fd = -1;
  for (addrinfo* ai = res; ai; ai = ai->ai_next) {
    int left = remaining_ms(deadline);
    if (left <= 0) break;
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL) | O_NONBLOCK);
    int rc = connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc == 0) break;
    if (errno == EINPROGRESS) {
      pollfd pfd{fd, POLLOUT, 0};
      if (poll(&pfd, 1, left) == 1 && (pfd.revents & POLLOUT)) {
        int err = 0;
        socklen_t len = sizeof(err);
        getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len);
        if (err == 0) break;
      }
    }
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  return fd;
}

// Read until EOF or the absolute deadline; appends to buf. Every poll gets
// only the REMAINING budget, so a host that trickles bytes cannot extend
// the probe past timeout_ms (the per-poll-restart pathology).
bool read_all(int fd, int64_t deadline, std::string* buf) {
  char chunk[4096];
  for (;;) {
    int left = remaining_ms(deadline);
    if (left <= 0) return false;
    pollfd pfd{fd, POLLIN, 0};
    int pr = poll(&pfd, 1, left);
    if (pr <= 0) return false;  // timeout or error
    ssize_t n = recv(fd, chunk, sizeof(chunk), 0);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
      return false;
    }
    if (n == 0) return true;  // orderly EOF
    buf->append(chunk, static_cast<size_t>(n));
    if (buf->size() > (16u << 20)) return true;  // 16 MiB safety cap
  }
}

// One probe: returns HTTP status (>0), -1 network failure, -2 bad URL.
// timeout_ms is the OVERALL budget for resolve+connect+send+read.
int probe_one(const char* raw_url, int timeout_ms, char* body_out,
              int body_cap) {
  if (body_cap > 0) body_out[0] = '\0';
  Url u;
  if (!parse_url(raw_url, &u)) return -2;
  const int64_t deadline = now_ms() + timeout_ms;
  int fd = connect_deadline(u, deadline);
  if (fd < 0) return -1;

  std::string req = "GET " + u.path + " HTTP/1.0\r\nHost: " + u.host +
                    "\r\nConnection: close\r\n\r\n";
  size_t sent = 0;
  while (sent < req.size()) {
    int left = remaining_ms(deadline);
    if (left <= 0) { close(fd); return -1; }
    pollfd pfd{fd, POLLOUT, 0};
    if (poll(&pfd, 1, left) <= 0) { close(fd); return -1; }
    ssize_t n = send(fd, req.data() + sent, req.size() - sent, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
      close(fd);
      return -1;
    }
    sent += static_cast<size_t>(n);
  }

  std::string resp;
  bool ok = read_all(fd, deadline, &resp);
  close(fd);
  if (!ok && resp.empty()) return -1;

  // "HTTP/1.x NNN ..."
  int status = -1;
  size_t sp = resp.find(' ');
  if (sp != std::string::npos && resp.size() >= sp + 4)
    status = std::atoi(resp.c_str() + sp + 1);
  if (status <= 0) return -1;

  size_t body_at = resp.find("\r\n\r\n");
  if (body_at != std::string::npos && body_cap > 0) {
    size_t n = resp.size() - (body_at + 4);
    if (n > static_cast<size_t>(body_cap - 1)) n = body_cap - 1;
    std::memcpy(body_out, resp.data() + body_at + 4, n);
    body_out[n] = '\0';
  }
  return status;
}

}  // namespace

extern "C" {

int pr_probe(const char** urls, int n, int timeout_ms, char* bodies,
             int body_cap, int* statuses) {
  if (n <= 0) return 0;
  if (!urls || !bodies || !statuses || body_cap <= 0 || timeout_ms <= 0)
    return -1;
  // One thread per URL, capped: each host contributes 2 URLs
  // (kernels+terminals), so 128 covers a slice of 64 hosts in ONE wave —
  // the "one timeout regardless of slice size" guarantee. Probes are
  // poll-bound, so a flat pool beats an event loop on simplicity.
  const int max_threads = 128;
  std::vector<std::thread> pool;
  std::atomic<int> next{0};
  int workers = n < max_threads ? n : max_threads;
  for (int w = 0; w < workers; ++w) {
    pool.emplace_back([&]() {
      for (;;) {
        int i = next.fetch_add(1);
        if (i >= n) return;
        statuses[i] = probe_one(urls[i], timeout_ms,
                                bodies + static_cast<size_t>(i) * body_cap,
                                body_cap);
      }
    });
  }
  for (auto& t : pool) t.join();
  return 0;
}

}  // extern "C"
