// The port's copy of acoustid_index_tpu/native/aitpu_loadgen.cc, built by
// acoustid_index_tpu_torch/utils/native.py.
//
// Standalone open-loop HTTP load generator (C++ twin of bench_client.py).
//
// On the 1-core dev box the Python client processes cost more CPU than the
// server under test — every "server qps" measured with them is really a
// client-throughput number.  This binary drives the same blobs protocol
// (msgpack [(expect_bytes, request_bytes), ...], closed-loop keep-alive
// connections, Content-Length framed responses) at a tiny fraction of the
// cycles, so the server's own ceiling dominates the measurement.
//
// CLI and the one-line JSON output match bench_client.py exactly; bench.py
// picks this binary when it exists and falls back to the Python client.
//
//   aitpu_loadgen --port P --seconds S --conns N --blobs FILE --seed K
//   -> {"count": n, "miss": m, "window_s": w, "p50_ms": ..., "p99_ms": ...}

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <sys/types.h>

#include <algorithm>
#include <cctype>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <unistd.h>
#include <vector>

namespace {

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// --- minimal msgpack reader for: array of [bin, bin] -----------------------
struct MpReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t be(int n) {
    if (end - p < n) { ok = false; return 0; }
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | *p++;
    return v;
  }
  uint64_t array_len() {
    if (p >= end) { ok = false; return 0; }
    uint8_t t = *p++;
    if ((t & 0xF0) == 0x90) return t & 0x0F;
    if (t == 0xdc) return be(2);
    if (t == 0xdd) return be(4);
    ok = false;
    return 0;
  }
  std::string bin() {
    if (p >= end) { ok = false; return {}; }
    uint8_t t = *p++;
    uint64_t n;
    if (t == 0xc4) n = be(1);
    else if (t == 0xc5) n = be(2);
    else if (t == 0xc6) n = be(4);
    else if ((t & 0xE0) == 0xA0) n = t & 0x1F;  // fixstr (str fallback)
    else if (t == 0xd9) n = be(1);
    else if (t == 0xda) n = be(2);
    else if (t == 0xdb) n = be(4);
    else { ok = false; return {}; }
    if (!ok || uint64_t(end - p) < n) { ok = false; return {}; }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

struct Blob {
  std::string expect;
  std::string request;
};

// xorshift for the pre-drawn request order (parity with bench_client's
// pre-drawn numpy indices: any uniform source works, determinism per seed).
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed * 6364136223846793005ULL + 1442695040888963407ULL) {}
  uint64_t next() {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    return s;
  }
};

struct Conn {
  int fd = -1;
  std::string in;        // receive buffer
  const Blob* blob = nullptr;
  const char* out = nullptr;  // unsent request tail
  size_t out_len = 0;
  double t_sent = 0.0;
  bool want_write = false;
};

int die(const char* msg) {
  std::perror(msg);
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  int port = 0, conns_n = 256;
  double seconds = 10.0;
  const char* blobs_path = nullptr;
  uint64_t seed = 0;
  for (int i = 1; i + 1 < argc; i += 2) {
    if (!std::strcmp(argv[i], "--port")) port = std::atoi(argv[i + 1]);
    else if (!std::strcmp(argv[i], "--seconds")) seconds = std::atof(argv[i + 1]);
    else if (!std::strcmp(argv[i], "--conns")) conns_n = std::atoi(argv[i + 1]);
    else if (!std::strcmp(argv[i], "--blobs")) blobs_path = argv[i + 1];
    else if (!std::strcmp(argv[i], "--seed")) seed = std::strtoull(argv[i + 1], nullptr, 10);
  }
  if (!port || !blobs_path) {
    std::fprintf(stderr, "usage: aitpu_loadgen --port P --seconds S --conns N --blobs FILE [--seed K]\n");
    return 2;
  }

  // Load blobs.
  FILE* f = std::fopen(blobs_path, "rb");
  if (!f) return die("blobs open");
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(fsize);
  if (std::fread(raw.data(), 1, fsize, f) != size_t(fsize)) return die("blobs read");
  std::fclose(f);
  MpReader r{raw.data(), raw.data() + raw.size()};
  uint64_t n_blobs = r.array_len();
  std::vector<Blob> blobs(n_blobs);
  for (uint64_t i = 0; i < n_blobs && r.ok; i++) {
    uint64_t two = r.array_len();
    if (two != 2) { r.ok = false; break; }
    blobs[i].expect = r.bin();
    blobs[i].request = r.bin();
  }
  if (!r.ok || n_blobs == 0) {
    std::fprintf(stderr, "bad blobs file\n");
    return 2;
  }

  Rng rng(seed + 1);
  int ep = epoll_create1(0);
  if (ep < 0) return die("epoll_create1");

  std::vector<Conn> conns(conns_n);
  uint64_t count = 0, miss = 0;
  std::vector<float> lats;
  lats.reserve(1 << 20);

  auto update_events = [&](Conn& c, bool want_write) {
    if (c.want_write == want_write) return;
    c.want_write = want_write;
    epoll_event ev{};
    ev.events = EPOLLIN | (want_write ? EPOLLOUT : 0u);
    ev.data.ptr = &c;
    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
  };

  auto pump_out = [&](Conn& c) {
    while (c.out_len) {
      ssize_t n = ::send(c.fd, c.out, c.out_len, MSG_NOSIGNAL);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) {
          // The server won't answer until the request tail arrives; watch
          // writability or the connection deadlocks.
          update_events(c, true);
          return;
        }
        std::fprintf(stderr, "send: %s\n", std::strerror(errno));
        std::exit(1);
      }
      c.out += n;
      c.out_len -= size_t(n);
    }
    update_events(c, false);
  };

  auto fire = [&](Conn& c) {
    c.blob = &blobs[rng.next() % n_blobs];
    c.out = c.blob->request.data();
    c.out_len = c.blob->request.size();
    c.t_sent = now_s();
    pump_out(c);
  };

  for (auto& c : conns) {
    c.fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (c.fd < 0) return die("socket");
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(port));
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (::connect(c.fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return die("connect");
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    fcntl(c.fd, F_SETFL, fcntl(c.fd, F_GETFL, 0) | O_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = &c;
    if (epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev) < 0) return die("epoll_ctl");
    fire(c);
  }

  const double t_start = now_s();
  const double deadline = t_start + seconds;
  std::vector<epoll_event> evs(256);
  char rbuf[262144];
  while (now_s() < deadline) {
    int n = epoll_wait(ep, evs.data(), int(evs.size()), 200);
    for (int i = 0; i < n; i++) {
      Conn& c = *static_cast<Conn*>(evs[i].data.ptr);
      if (evs[i].events & EPOLLOUT) pump_out(c);
      if (!(evs[i].events & (EPOLLIN | EPOLLERR | EPOLLHUP))) continue;
      ssize_t got = ::recv(c.fd, rbuf, sizeof(rbuf), 0);
      if (got == 0) {
        std::fprintf(stderr, "server closed a keep-alive connection\n");
        return 1;
      }
      if (got < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
        return die("recv");
      }
      c.in.append(rbuf, size_t(got));
      // One response per in-flight request; parse complete responses.
      for (;;) {
        size_t hend = c.in.find("\r\n\r\n");
        if (hend == std::string::npos) break;
        // Case-insensitive Content-Length scan within the header block.
        size_t cl = std::string::npos;
        for (size_t pos = 0; pos + 15 < hend; pos++) {
          if ((c.in[pos] == 'c' || c.in[pos] == 'C') &&
              !strncasecmp(c.in.data() + pos, "content-length:", 15)) {
            cl = pos + 15;
            break;
          }
        }
        if (cl == std::string::npos) {
          std::fprintf(stderr, "response without Content-Length\n");
          return 1;
        }
        size_t body_len = std::strtoul(c.in.data() + cl, nullptr, 10);
        size_t total = hend + 4 + body_len;
        if (c.in.size() < total) break;
        lats.push_back(float(now_s() - c.t_sent));
        count++;
        bool ok200 = c.in.compare(0, 12, "HTTP/1.1 200") == 0;
        // expect must appear inside THIS response's body
        size_t at = c.in.find(c.blob->expect, hend + 4);
        if (!ok200 || at == std::string::npos || at + c.blob->expect.size() > total)
          miss++;
        c.in.erase(0, total);
        fire(c);
      }
      pump_out(c);
    }
  }
  const double window_s = now_s() - t_start;

  double p50 = 0, p99 = 0;
  if (!lats.empty()) {
    std::vector<float> s(lats);
    size_t i50 = size_t(0.50 * double(s.size() - 1));
    size_t i99 = size_t(0.99 * double(s.size() - 1));
    std::nth_element(s.begin(), s.begin() + i50, s.end());
    p50 = s[i50] * 1e3;
    std::nth_element(s.begin(), s.begin() + i99, s.end());
    p99 = s[i99] * 1e3;
  }
  if (count)
    std::printf("{\"count\": %llu, \"miss\": %llu, \"window_s\": %.6f, \"p50_ms\": %.4f, \"p99_ms\": %.4f}\n",
                (unsigned long long)count, (unsigned long long)miss, window_s, p50, p99);
  else
    std::printf("{\"count\": 0, \"miss\": 0, \"window_s\": %.6f, \"p50_ms\": null, \"p99_ms\": null}\n",
                window_s);
  return 0;
}
