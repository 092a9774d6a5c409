// The benchmark's HTTP load generator.  It runs in a process of its own,
// so the clients never share the server's interpreter lock.
//
// Started from acoustid_index_tpu_torch/csrc/aitpu_loadgen.cc (epoll over
// keep-alive connections, Content-Length framing) and extended:
//
//   --mode closed   each of --conns connections sends its next request as
//                   soon as the previous one is answered, until --seconds
//                   have passed; latency is timed from the send.
//   --mode open     Poisson arrivals at --rate per second, drawn from
//                   --seed; a due request goes out on the first idle
//                   connection and is timed from when it was due, so a
//                   stall counts against every request it delays.  How late
//                   the generator sent (send - due) is reported.
//   --mode writer   request k is due at k * --period seconds and goes out
//                   in order on one connection (--conns 1); timed from due.
//   --mode once     every request once, in order, over --conns connections.
//
// Requests come pre-built (whole HTTP requests) from --requests FILE ("-"
// is standard input): u64 count, then per request u32 length and bytes.
// closed and open pick request indices uniformly from --seed; writer and
// once take them in order.  --start-at T (CLOCK_MONOTONIC seconds) holds
// the window's start until T, so that several generators start together.
// Every response is kept for the comparison that
// decides the run's correctness: the first answer to each request index is
// written to PREFIX.rec, and every later answer to the same index is
// compared with it byte for byte (`inconsistent`).  PREFIX.lat holds one
// latency (seconds, float64; +inf for a non-200 or a missing answer) per
// request sent in the window.  After the window no request is sent, and
// the answers in flight are awaited for up to --drain seconds.
//
// --control FD (a socket) pauses and resumes the load inside the window:
// the byte 'p' stops every send (closed: no next request; open and writer:
// no arrival is admitted and no due request goes out), and once no request
// is in flight the generator writes "drained <t>\n" back on FD; the byte
// 'r' resumes it.  A pause suspends the open and writer schedules: every
// due time not yet reached, and those of due requests not yet sent, move
// on by the pause's length, so nothing falls due while paused and a
// latency timed from due counts no paused time.  The window's end does
// not move.  Each pause is reported with the requests sent and admitted
// while it lasted (0 by construction).
//
// stdout, one JSON line: sent, answered, answered_in_window, non200,
// unanswered, inconsistent, window_s, late_p99_ms, late_max_ms, t0, the
// window's start (CLOCK_MONOTONIC seconds), per_s, the 200 answers
// received in each whole second of the window (a stall shows as a dip),
// cpu_s, the generator's own CPU seconds (a share near run_s means it
// was saturated), paused_s, the paused seconds inside the window, and
// pauses: pause, drained and resume (CLOCK_MONOTONIC seconds, null where
// it never came), sent, admitted.

#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/resource.h>
#include <sys/socket.h>
#include <sys/timerfd.h>
#include <sys/types.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <limits>
#include <string>
#include <strings.h>
#include <time.h>
#include <unistd.h>
#include <vector>

namespace {

double now_s() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return double(ts.tv_sec) + 1e-9 * double(ts.tv_nsec);
}

// splitmix64: the request order and the arrivals, from --seed.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed ^ 0x6A09E667F3BCC909ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (double(next() >> 11) + 0.5) * (1.0 / 9007199254740992.0); }
};

struct Conn {
  int fd = -1;
  std::string in;
  bool busy = false;
  uint64_t req = 0;     // request index in flight
  double t_due = 0.0;   // latency origin
  const char* out = nullptr;
  size_t out_len = 0;
  bool want_write = false;
};

struct Pause {
  double pause = 0.0, drained = -1.0, resume = -1.0;
  uint64_t sent = 0, admitted = 0;
};

bool read_all(FILE* f, void* dst, size_t n) { return std::fread(dst, 1, n, f) == n; }

std::string stamp_json(double t) {
  if (t < 0) return "null";
  char b[32];
  std::snprintf(b, sizeof(b), "%.6f", t);
  return b;
}

int fail(const char* msg) {
  std::fprintf(stderr, "loadgen: %s: %s\n", msg, std::strerror(errno));
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  std::string mode = "closed";
  int port = 0, conns_n = 256, control = -1;
  double seconds = 10.0, rate = 0.0, period = 0.0, drain = 60.0, start_at = 0.0;
  const char* requests_path = nullptr;
  const char* record = nullptr;
  uint64_t seed = 0;
  for (int i = 1; i + 1 < argc; i += 2) {
    const char* k = argv[i];
    const char* v = argv[i + 1];
    if (!std::strcmp(k, "--mode")) mode = v;
    else if (!std::strcmp(k, "--port")) port = std::atoi(v);
    else if (!std::strcmp(k, "--conns")) conns_n = std::atoi(v);
    else if (!std::strcmp(k, "--seconds")) seconds = std::atof(v);
    else if (!std::strcmp(k, "--rate")) rate = std::atof(v);
    else if (!std::strcmp(k, "--period")) period = std::atof(v);
    else if (!std::strcmp(k, "--drain")) drain = std::atof(v);
    else if (!std::strcmp(k, "--start-at")) start_at = std::atof(v);
    else if (!std::strcmp(k, "--control")) control = std::atoi(v);
    else if (!std::strcmp(k, "--requests")) requests_path = v;
    else if (!std::strcmp(k, "--record")) record = v;
    else if (!std::strcmp(k, "--seed")) seed = std::strtoull(v, nullptr, 10);
    else { std::fprintf(stderr, "loadgen: unknown option %s\n", k); return 2; }
  }
  const bool closed = mode == "closed", open = mode == "open", writer = mode == "writer", once = mode == "once";
  if (!port || !requests_path || !record || conns_n < 1 || !(closed || open || writer || once) ||
      (open && !(rate > 0)) || (writer && (!(period > 0) || conns_n != 1))) {
    std::fprintf(stderr,
                 "usage: loadgen --mode closed|open|writer|once --port P --requests FILE --record PREFIX "
                 "[--conns N] [--seconds S] [--rate R] [--period S] [--drain S] [--seed K] [--start-at T] [--control FD]\n");
    return 2;
  }

  FILE* f = std::strcmp(requests_path, "-") ? std::fopen(requests_path, "rb") : stdin;
  if (!f) return fail("open requests");
  uint64_t n_req = 0;
  if (!read_all(f, &n_req, 8) || n_req == 0) { std::fprintf(stderr, "loadgen: no requests\n"); return 2; }
  std::vector<std::string> reqs(n_req);
  for (auto& r : reqs) {
    uint32_t len = 0;
    if (!read_all(f, &len, 4)) { std::fprintf(stderr, "loadgen: truncated requests\n"); return 2; }
    r.resize(len);
    if (!read_all(f, r.data(), len)) { std::fprintf(stderr, "loadgen: truncated requests\n"); return 2; }
  }
  if (f != stdin) std::fclose(f);

  Rng rng(seed);
  int ep = epoll_create1(0);
  if (ep < 0) return fail("epoll_create1");
  int tfd = timerfd_create(CLOCK_MONOTONIC, TFD_NONBLOCK);
  if (tfd < 0) return fail("timerfd_create");
  {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = nullptr;  // the timer
    if (epoll_ctl(ep, EPOLL_CTL_ADD, tfd, &ev) < 0) return fail("epoll_ctl timer");
  }
  static char control_tag;
  if (control >= 0) {
    fcntl(control, F_SETFL, fcntl(control, F_GETFL, 0) | O_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = &control_tag;
    if (epoll_ctl(ep, EPOLL_CTL_ADD, control, &ev) < 0) return fail("epoll_ctl control");
  }

  std::vector<Conn> conns(conns_n);
  for (auto& c : conns) {
    c.fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (c.fd < 0) return fail("socket");
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(uint16_t(port));
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    if (::connect(c.fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) return fail("connect");
    int one = 1;
    setsockopt(c.fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    fcntl(c.fd, F_SETFL, fcntl(c.fd, F_GETFL, 0) | O_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.ptr = &c;
    if (epoll_ctl(ep, EPOLL_CTL_ADD, c.fd, &ev) < 0) return fail("epoll_ctl");
  }

  // Several generators start their windows together at --start-at
  // (CLOCK_MONOTONIC seconds), once their requests are read and their
  // connections open.
  while (now_s() < start_at) {
    double left = start_at - now_s();
    timespec ts{time_t(left), long((left - double(time_t(left))) * 1e9)};
    nanosleep(&ts, nullptr);
  }

  std::vector<std::string> first_body(n_req);
  std::vector<int> first_status(n_req, 0);
  std::vector<double> lats;  // in-window requests, filled on answer
  std::vector<double> lates;
  lats.reserve(1 << 20);
  uint64_t sent = 0, answered = 0, answered_in_window = 0, non200 = 0, inconsistent = 0;

  const double t0 = now_s();
  const double deadline = t0 + seconds;
  std::vector<uint64_t> per_s(size_t(std::ceil(seconds)), 0);
  // Arrivals: open mode draws exponential gaps; writer mode is periodic;
  // once sends every request at t0.
  std::deque<std::pair<uint64_t, double>> due;  // (request index, due time)
  double next_arrival = t0;
  double write_base = t0;  // writer: request k is due at write_base + k * period
  uint64_t next_seq = 0;  // writer / once: next request index
  bool paused = false, drained_told = false;
  std::vector<Pause> pauses;
  auto arm_timer = [&](double at) {
    itimerspec its{};
    if (at > 0) {
      its.it_value.tv_sec = time_t(at);
      its.it_value.tv_nsec = long((at - double(its.it_value.tv_sec)) * 1e9);
      if (its.it_value.tv_sec == 0 && its.it_value.tv_nsec == 0) its.it_value.tv_nsec = 1;
    }
    timerfd_settime(tfd, TFD_TIMER_ABSTIME, &its, nullptr);
  };
  auto admit_due = [&](double now) {
    const size_t before = due.size();
    if (open) {
      while (next_arrival < deadline && next_arrival <= now) {
        due.emplace_back(rng.next() % n_req, next_arrival);
        next_arrival += -std::log(rng.uniform()) / rate;
      }
    } else if (writer) {
      while (next_seq < n_req && write_base + double(next_seq) * period < deadline &&
             write_base + double(next_seq) * period <= now) {
        due.emplace_back(next_seq, write_base + double(next_seq) * period);
        next_seq++;
      }
    } else if (once) {
      while (next_seq < n_req) due.emplace_back(next_seq, t0), next_seq++;
    }
    if (paused) pauses.back().admitted += due.size() - before;
  };

  auto set_write = [&](Conn& c, bool on) {
    if (c.want_write == on) return;
    c.want_write = on;
    epoll_event ev{};
    ev.events = EPOLLIN | (on ? EPOLLOUT : 0u);
    ev.data.ptr = &c;
    epoll_ctl(ep, EPOLL_CTL_MOD, c.fd, &ev);
  };
  auto pump_out = [&](Conn& c) -> bool {
    while (c.out_len) {
      ssize_t n = ::send(c.fd, c.out, c.out_len, MSG_NOSIGNAL);
      if (n < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) { set_write(c, true); return true; }
        return false;
      }
      c.out += n;
      c.out_len -= size_t(n);
    }
    set_write(c, false);
    return true;
  };
  auto fire = [&](Conn& c, uint64_t idx, double t_due, double now) -> bool {
    c.busy = true;
    c.req = idx;
    c.t_due = t_due;
    c.out = reqs[idx].data();
    c.out_len = reqs[idx].size();
    sent++;
    if (paused) pauses.back().sent++;
    if (!closed) lates.push_back(now - t_due);
    return pump_out(c);
  };
  auto dispatch = [&](double now) -> bool {
    if (paused) return true;
    for (auto& c : conns) {
      if (c.busy) continue;
      if (closed) {
        if (now >= deadline) break;
        if (!fire(c, rng.next() % n_req, now, now)) return false;
      } else {
        if (due.empty()) break;
        auto [idx, t] = due.front();
        due.pop_front();
        if (!fire(c, idx, t, now)) return false;
      }
    }
    return true;
  };
  auto in_flight = [&]() {
    for (auto& c : conns) if (c.busy) return true;
    return false;
  };
  auto pending = [&]() {
    return in_flight() || !due.empty() || (open && next_arrival < deadline) ||
           ((writer && next_seq < n_req && write_base + double(next_seq) * period < deadline) ||
            (once && next_seq < n_req));
  };

  // Commands from --control: 'p' pauses, 'r' resumes; the far end closing
  // resumes too, so a run whose controller went away still ends.
  auto command = [&](char k, double now) {
    if (k == 'p' && !paused) {
      paused = true;
      drained_told = false;
      Pause p;
      p.pause = now;
      pauses.push_back(p);
    } else if (k == 'r' && paused) {
      const double len = now - pauses.back().pause;
      paused = false;
      pauses.back().resume = now;
      for (auto& d : due) d.second += len;
      next_arrival += len;
      write_base += len;
    }
  };
  auto on_control = [&](double now) -> bool {
    char buf[64];
    for (;;) {
      ssize_t got = ::read(control, buf, sizeof(buf));
      if (got > 0) {
        for (ssize_t i = 0; i < got; i++) command(buf[i], now);
        continue;
      }
      if (got == 0) {
        command('r', now);
        epoll_ctl(ep, EPOLL_CTL_DEL, control, nullptr);
        control = -1;
        return true;
      }
      return errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR;
    }
  };

  std::vector<epoll_event> evs(512);
  static char rbuf[1 << 18];
  admit_due(t0);
  if (!dispatch(t0)) return fail("send");
  double drain_until = deadline + drain;
  for (;;) {
    double now = now_s();
    bool sending = (closed && now < deadline) || (!closed && pending());
    if (!paused && !sending && !pending()) break;
    if (now >= deadline && now > drain_until) break;
    if (once && now > t0 + drain) break;
    double wake = closed ? deadline : (open ? std::min(next_arrival, deadline) : (writer ? write_base + double(next_seq) * period : 0.0));
    arm_timer(!paused && wake > now ? wake : 0.0);
    int n = epoll_wait(ep, evs.data(), int(evs.size()), 100);
    if (n < 0) {
      if (errno == EINTR) continue;
      return fail("epoll_wait");
    }
    now = now_s();
    for (int i = 0; i < n; i++) {
      if (evs[i].data.ptr == nullptr) {
        uint64_t x;
        while (::read(tfd, &x, 8) > 0) {}
        continue;
      }
      if (evs[i].data.ptr == &control_tag) {
        if (!on_control(now)) return fail("read control");
        continue;
      }
      Conn& c = *static_cast<Conn*>(evs[i].data.ptr);
      if ((evs[i].events & EPOLLOUT) && !pump_out(c)) return fail("send");
      if (!(evs[i].events & (EPOLLIN | EPOLLERR | EPOLLHUP))) continue;
      ssize_t got = ::recv(c.fd, rbuf, sizeof(rbuf), 0);
      if (got == 0) { std::fprintf(stderr, "loadgen: the server closed a keep-alive connection\n"); return 1; }
      if (got < 0) {
        if (errno == EAGAIN || errno == EWOULDBLOCK) continue;
        return fail("recv");
      }
      c.in.append(rbuf, size_t(got));
      for (;;) {
        size_t hend = c.in.find("\r\n\r\n");
        if (hend == std::string::npos) break;
        size_t cl = std::string::npos;
        for (size_t pos = 0; pos + 15 < hend; pos++) {
          if ((c.in[pos] == 'c' || c.in[pos] == 'C') && !strncasecmp(c.in.data() + pos, "content-length:", 15)) {
            cl = pos + 15;
            break;
          }
        }
        if (cl == std::string::npos) { std::fprintf(stderr, "loadgen: response without Content-Length\n"); return 1; }
        size_t total = hend + 4 + std::strtoul(c.in.data() + cl, nullptr, 10);
        if (c.in.size() < total) break;
        if (!c.busy) { std::fprintf(stderr, "loadgen: response without a request\n"); return 1; }
        double t_done = now_s();
        int status = c.in.size() >= 12 ? std::atoi(c.in.c_str() + 9) : 0;
        std::string body = c.in.substr(hend + 4, total - hend - 4);
        c.in.erase(0, total);
        answered++;
        if (t_done <= deadline) {
          answered_in_window++;
          size_t b = size_t(t_done - t0);
          if (status == 200 && b < per_s.size()) per_s[b]++;
        }
        if (status != 200) non200++;
        lats.push_back(status == 200 ? t_done - c.t_due : std::numeric_limits<double>::infinity());
        if (first_status[c.req] == 0) {
          first_status[c.req] = status;
          first_body[c.req] = std::move(body);
        } else if (first_status[c.req] != status || first_body[c.req] != body) {
          inconsistent++;
        }
        c.busy = false;
      }
    }
    if (!paused) admit_due(now);
    if (!dispatch(now)) return fail("send");
    if (paused && !drained_told && !in_flight()) {
      drained_told = true;
      pauses.back().drained = now_s();
      std::string msg = "drained " + stamp_json(pauses.back().drained) + "\n";
      if (::write(control, msg.data(), msg.size()) < 0) return fail("write control");
    }
  }
  const double t_end = now_s();
  // Every request sent was due in the window: closed sends only before
  // the deadline, open and writer admit only what falls due before it (a
  // pause that moves a held request's due time past the deadline does not
  // take it out of the window).
  uint64_t unanswered = sent - answered;
  // Requests due in the window that were never sent count as unanswered too.
  if (!closed) {
    admit_due(deadline);
    unanswered += due.size();
  }
  for (uint64_t i = 0; i < unanswered; i++) lats.push_back(std::numeric_limits<double>::infinity());

  std::string lat_path = std::string(record) + ".lat", rec_path = std::string(record) + ".rec";
  FILE* lf = std::fopen(lat_path.c_str(), "wb");
  if (!lf) return fail("open .lat");
  std::fwrite(lats.data(), sizeof(double), lats.size(), lf);
  std::fclose(lf);
  FILE* rf = std::fopen(rec_path.c_str(), "wb");
  if (!rf) return fail("open .rec");
  for (uint64_t i = 0; i < n_req; i++) {
    if (!first_status[i]) continue;
    uint32_t head[3] = {uint32_t(i), uint32_t(first_status[i]), uint32_t(first_body[i].size())};
    std::fwrite(head, 4, 3, rf);
    std::fwrite(first_body[i].data(), 1, first_body[i].size(), rf);
  }
  std::fclose(rf);

  double late_p99 = 0, late_max = 0;
  if (!lates.empty()) {
    std::vector<double> s(lates);
    size_t k = size_t(std::ceil(0.99 * double(s.size()))) - 1;
    std::nth_element(s.begin(), s.begin() + k, s.end());
    late_p99 = s[k] * 1e3;
    late_max = *std::max_element(lates.begin(), lates.end()) * 1e3;
  }
  rusage ru{};
  getrusage(RUSAGE_SELF, &ru);
  const double cpu_s = double(ru.ru_utime.tv_sec + ru.ru_stime.tv_sec) +
                       1e-6 * double(ru.ru_utime.tv_usec + ru.ru_stime.tv_usec);
  std::string per_s_json = "[";
  for (size_t i = 0; i < per_s.size(); i++) {
    if (i) per_s_json += ", ";
    per_s_json += std::to_string(per_s[i]);
  }
  per_s_json += "]";
  double paused_s = 0.0;
  std::string pauses_json = "[";
  for (size_t i = 0; i < pauses.size(); i++) {
    const Pause& p = pauses[i];
    const double until = p.resume < 0 ? t_end : p.resume;
    paused_s += std::max(0.0, std::min(until, deadline) - std::max(p.pause, t0));
    if (i) pauses_json += ", ";
    pauses_json += "{\"pause\": " + stamp_json(p.pause) + ", \"drained\": " + stamp_json(p.drained) +
                   ", \"resume\": " + stamp_json(p.resume) + ", \"sent\": " + std::to_string(p.sent) +
                   ", \"admitted\": " + std::to_string(p.admitted) + "}";
  }
  pauses_json += "]";
  std::printf(
      "{\"mode\": \"%s\", \"sent\": %llu, \"answered\": %llu, "
      "\"answered_in_window\": %llu, \"non200\": %llu, \"unanswered\": %llu, \"inconsistent\": %llu, "
      "\"window_s\": %.6f, \"run_s\": %.6f, \"late_p99_ms\": %.6f, \"late_max_ms\": %.6f, \"t0\": %.6f, \"cpu_s\": %.6f, \"per_s\": %s, "
      "\"paused_s\": %.6f, \"pauses\": %s}\n",
      mode.c_str(), (unsigned long long)sent, (unsigned long long)answered,
      (unsigned long long)answered_in_window, (unsigned long long)non200, (unsigned long long)unanswered,
      (unsigned long long)inconsistent, seconds, t_end - t0, late_p99, late_max, t0, cpu_s, per_s_json.c_str(),
      paused_s, pauses_json.c_str());
  for (auto& c : conns) ::close(c.fd);
  ::close(tfd);
  ::close(ep);
  return 0;
}
