// The port's copy of acoustid_index_tpu/native/aitpu_front.cc, built by
// acoustid_index_tpu_torch/utils/native.py.
//
// Native search-plane front end.
//
// The serving hot path's host cost is per-request Python work: HTTP parse,
// body decode, query dedup, row packing, response encode — measured at
// ~0.27ms/request under GIL contention (SERVING.md), which caps a Python
// front end around 15k qps while the device sustains 90k+.  This front end
// moves the ENTIRE per-request path into C++ threads: it owns the sockets,
// parses HTTP/1.1 + JSON/msgpack search requests, sorts/dedupes the query,
// packs the device input row, batches requests by (index, query bucket,
// out bucket), and encodes responses — the Python side only pumps packed
// row batches through the device (see server/native_front.py), so its
// per-REQUEST work is zero and its per-BATCH work is one ctypes call each
// way plus the JAX dispatch.
//
// Reference scope: the reference embeds a general-purpose async HTTP
// server (dusty) for ALL routes; here the control plane (CRUD, updates,
// snapshots, replication) stays on the Python server and only the search
// data plane gets the native fast path — the split mirrors how the legacy
// TCP protocol (upstream fpindex's src/legacy.zig) runs beside the REST API.
// Wire behavior mirrors server/app.py handle_search + server/api.py
// byte-for-byte (pinned by tests/test_native_front.py):
//   * content negotiation: explicit Accept wins, else mirrors Content-Type
//     (app.py response_type);
//   * sanitization: limit -> [1,100], timeout <= 10s, score_pct -> [0,100],
//     min_score >= 0 or derived ceil(|raw query|/20) (MultiIndex.zig:304);
//   * query: sorted + deduped u32, capped at 4096 (Index.zig:170-176);
//   * responses: {"results":[{"id":..,"score":..}]} JSON with Python's
//     default separators / {"r":[{"i":..,"s":..}]} msgpack short keys;
//   * errors: {"error":name} / {"e":name} with the api's status codes;
//   * absolute deadlines: a request never gets results after its timeout
//     (claimed-but-late batches resolve as SearchTimeout, searcher.py
//     _collect_loop semantics).
//
// C ABI (ctypes): aitpu_front_start/next/complete/fail/stat/stop.
// Tokens handed to the pump are opaque u64s owning a queued Req; every
// claimed token MUST be returned through complete() or fail() exactly once.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_set>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

using Clock = std::chrono::steady_clock;

constexpr int64_t MAX_BODY = 16 * 1024 * 1024;  // reference's body cap
constexpr uint32_t QUERY_BUCKETS[] = {64, 128, 256, 1024, 4096};
constexpr uint32_t MAX_QUERY_HASHES = 4096;
constexpr int64_t DEFAULT_TIMEOUT_MS = 500;
constexpr int64_t MAX_TIMEOUT_MS = 10000;
constexpr int64_t DEFAULT_LIMIT = 40;
constexpr int64_t MAX_LIMIT = 100;
// Upper bounds (ms) of the queue-wait histogram's bins; one more bin is +Inf.
constexpr int64_t QUEUE_WAIT_BUCKETS_MS[] = {1, 5, 10, 50, 100, 500};
constexpr int QUEUE_WAIT_BINS = 7;

enum ReqState { QUEUED = 0, CLAIMED = 1, DONE = 2, TIMEDOUT = 3 };

struct Conn;
struct Loop;

struct Req {
    // Lifecycle: a loop thread creates it, enqueues it on its group under
    // the server mutex, and owns encode/respond/delete; the pump claims it
    // (state CLAIMED) and hands it back through complete()/fail(), which
    // post it to its loop's completion queue.  state transitions are
    // guarded by the server mutex; conn/timer fields are loop-thread-only.
    int state = QUEUED;
    uint64_t seq = 0;
    std::string index;
    uint32_t bucket = 0, out_bucket = 0;
    std::vector<uint32_t> row;  // bucket + 4 words
    Clock::time_point deadline;  // time_point::max() = no deadline
    Clock::time_point queued;    // when it was queued for a pump
    // response (filled by complete/fail):
    int32_t status = 200;
    std::string err;                // non-empty => error response `name`
    std::vector<uint32_t> out;      // 2*out_len + 5 packed output words
    // v2 event-loop plumbing:
    Conn* conn = nullptr;  // nulled when the connection died first (orphan)
    Loop* loop = nullptr;
    std::string gkey;      // group key it was queued under
    bool resp_mp = false;
    bool keep_alive = true;
    bool has_timer = false;
    std::multimap<Clock::time_point, Req*>::iterator timer_it;
};

struct Group {
    std::deque<Req*> q;
};

struct Server {
    int listen_fd = -1;
    uint16_t port = 0;
    std::atomic<bool> stopping{false};
    std::vector<Loop*> loops;        // event loops (loop 0 also accepts)
    std::atomic<uint64_t> next_loop{0};
    std::mutex mu;                   // guards groups, req states, counters
    std::condition_variable pump_cv; // wakes front_next waiters
    std::map<std::string, Group> groups;
    uint64_t next_seq = 1;
    std::atomic<int64_t> conns{0};
    std::atomic<int64_t> accepted{0};   // search requests enqueued
    std::atomic<int64_t> responded{0};  // search responses written
    std::atomic<int64_t> timeouts{0};   // SearchTimeout responses
    std::atomic<int64_t> errors{0};     // non-timeout error responses
    // Claims by the pumps: batches claimed, and each claimed request's
    // wait from queued to claimed (sum in ns, count, and a histogram of
    // QUEUE_WAIT_BUCKETS_MS plus +Inf).
    std::atomic<int64_t> batches{0};
    std::atomic<int64_t> queue_wait_ns{0};
    std::atomic<int64_t> queue_waits{0};
    std::atomic<int64_t> queue_wait_hist[QUEUE_WAIT_BINS] = {};
    int64_t max_conns = 512;
};

// ---------------------------------------------------------------- parsing

struct Body {
    std::vector<uint32_t> query;
    bool bad = false;            // malformed / wrong types -> 400
    bool have_min_score = false;
    int64_t timeout = DEFAULT_TIMEOUT_MS;
    int64_t limit = DEFAULT_LIMIT;
    int64_t min_score = 0;
    int64_t score_pct = 10;
    bool have_query = false;
};

// --- minimal JSON parser (objects of numbers / number arrays; skips the
// rest).  Mirrors what json.loads accepts for the search request shape.
struct JsonParser {
    const char* p;
    const char* end;
    bool ok = true;

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) p++;
    }
    bool lit(const char* s) {
        size_t n = strlen(s);
        if (static_cast<size_t>(end - p) < n || memcmp(p, s, n) != 0) return false;
        p += n;
        return true;
    }
    // Parses a number with json.loads' grammar (leading-zero and bare-'-'
    // forms rejected, exponents need digits); integer-valued => *is_int.
    bool number(bool* is_int, int64_t* iv, double* dv) {
        const char* s = p;
        if (p < end && *p == '-') p++;
        const char* digits = p;
        while (p < end && *p >= '0' && *p <= '9') p++;
        if (p == digits) { p = s; return false; }  // bare '-' is not a number
        if (*digits == '0' && p - digits > 1) { p = s; return false; }  // 01
        bool frac = false;
        if (p < end && *p == '.') {
            frac = true;
            p++;
            const char* fd = p;
            while (p < end && *p >= '0' && *p <= '9') p++;
            if (p == fd) { p = s; return false; }  // "1." is not JSON
        }
        if (p < end && (*p == 'e' || *p == 'E')) {
            frac = true;
            p++;
            if (p < end && (*p == '+' || *p == '-')) p++;
            const char* ed = p;
            while (p < end && *p >= '0' && *p <= '9') p++;
            if (p == ed) { p = s; return false; }  // "1e" is not JSON
        }
        std::string tok(s, p - s);
        if (!frac) {
            errno = 0;
            long long v = strtoll(tok.c_str(), nullptr, 10);
            *is_int = true;
            *iv = v;
            *dv = static_cast<double>(v);
        } else {
            *is_int = false;
            *dv = strtod(tok.c_str(), nullptr);
            *iv = static_cast<int64_t>(*dv);
        }
        return true;
    }
    bool string(std::string* out) {
        if (p >= end || *p != '"') return false;
        p++;
        out->clear();
        while (p < end && *p != '"') {
            if (*p == '\\') {
                p++;
                if (p >= end) return false;
                switch (*p) {
                    case 'n': out->push_back('\n'); break;
                    case 't': out->push_back('\t'); break;
                    case 'r': out->push_back('\r'); break;
                    case 'b': out->push_back('\b'); break;
                    case 'f': out->push_back('\f'); break;
                    case 'u':
                        // \uXXXX: only needed for skipped string values.
                        if (end - p < 5) return false;
                        p += 4;
                        out->push_back('?');
                        break;
                    default: out->push_back(*p);
                }
            } else {
                out->push_back(*p);
            }
            p++;
        }
        if (p >= end) return false;
        p++;  // closing quote
        return true;
    }
    bool skip_value() {
        ws();
        if (p >= end) return false;
        char c = *p;
        if (c == '"') {
            std::string s;
            return string(&s);
        }
        if (c == '{') {
            p++;
            ws();
            if (p < end && *p == '}') { p++; return true; }
            while (true) {
                ws();
                std::string k;
                if (!string(&k)) return false;
                ws();
                if (p >= end || *p != ':') return false;
                p++;
                if (!skip_value()) return false;
                ws();
                if (p < end && *p == ',') { p++; continue; }
                if (p < end && *p == '}') { p++; return true; }
                return false;
            }
        }
        if (c == '[') {
            p++;
            ws();
            if (p < end && *p == ']') { p++; return true; }
            while (true) {
                if (!skip_value()) return false;
                ws();
                if (p < end && *p == ',') { p++; continue; }
                if (p < end && *p == ']') { p++; return true; }
                return false;
            }
        }
        if (lit("true") || lit("false") || lit("null")) return true;
        bool ii; int64_t iv; double dv;
        return number(&ii, &iv, &dv);
    }
};

// json.loads rejects trailing bytes after the top-level value.
bool json_at_end(JsonParser* j) {
    j->ws();
    return j->p == j->end;
}

bool parse_json_body(const char* data, size_t len, Body* b) {
    JsonParser j{data, data + len};
    j.ws();
    if (j.p >= j.end || *j.p != '{') return false;
    j.p++;
    j.ws();
    if (j.p < j.end && *j.p == '}') { j.p++; return json_at_end(&j); }
    while (true) {
        j.ws();
        std::string key;
        if (!j.string(&key)) return false;
        j.ws();
        if (j.p >= j.end || *j.p != ':') return false;
        j.p++;
        j.ws();
        if (key == "query" || key == "q") {
            if (j.p >= j.end || *j.p != '[') return false;
            j.p++;
            b->have_query = true;
            j.ws();
            if (j.p < j.end && *j.p == ']') {
                j.p++;
            } else {
                while (true) {
                    j.ws();
                    bool ii; int64_t iv; double dv;
                    // bools/strings/floats in the query -> 400 (api.py
                    // decode_search_request rejects non-int hashes).
                    if (j.p < j.end && (*j.p == 't' || *j.p == 'f' || *j.p == 'n' ||
                                        *j.p == '"')) {
                        b->bad = true;
                        if (!j.skip_value()) return false;
                    } else if (j.number(&ii, &iv, &dv)) {
                        if (!ii || iv < 0 || iv > 0xFFFFFFFFLL) b->bad = true;
                        else b->query.push_back(static_cast<uint32_t>(iv));
                    } else {
                        return false;
                    }
                    j.ws();
                    if (j.p < j.end && *j.p == ',') { j.p++; continue; }
                    if (j.p < j.end && *j.p == ']') { j.p++; break; }
                    return false;
                }
            }
        } else if (key == "timeout" || key == "t" || key == "limit" || key == "l" ||
                   key == "min_score" || key == "m" || key == "score_pct" ||
                   key == "s") {
            if (j.lit("null")) {
                // null min_score = derive; null elsewhere -> 400 (int(None)).
                if (!(key == "min_score" || key == "m")) b->bad = true;
            } else {
                bool ii; int64_t iv; double dv;
                if (j.p < j.end && (*j.p == 't' || *j.p == 'f')) {
                    // bool: int(True) == 1 in the Python path.
                    iv = j.lit("true") ? 1 : (j.lit("false") ? 0 : (b->bad = true, 0));
                } else if (!j.number(&ii, &iv, &dv)) {
                    b->bad = true;  // e.g. string: int("x") -> 400
                    if (!j.skip_value()) return false;
                    iv = 0;
                }
                if (key == "timeout" || key == "t") b->timeout = iv;
                else if (key == "limit" || key == "l") b->limit = iv;
                else if (key == "score_pct" || key == "s") b->score_pct = iv;
                else { b->min_score = iv; b->have_min_score = true; }
            }
        } else {
            if (!j.skip_value()) return false;
        }
        j.ws();
        if (j.p < j.end && *j.p == ',') { j.p++; continue; }
        if (j.p < j.end && *j.p == '}') { j.p++; break; }
        return false;
    }
    return json_at_end(&j);
}

// --- minimal msgpack parser for the same request shape.
struct MpParser {
    const uint8_t* p;
    const uint8_t* end;

    bool u8(uint8_t* v) { if (p >= end) return false; *v = *p++; return true; }
    bool big(int n, uint64_t* v) {
        if (end - p < n) return false;
        uint64_t r = 0;
        for (int i = 0; i < n; i++) r = (r << 8) | *p++;
        *v = r;
        return true;
    }
    // Reads any int-family value. kind: 0=int, 1=float, 2=bool, 3=nil, -1=other.
    bool value_head(uint8_t* tag) { if (p >= end) return false; *tag = *p; return true; }
    bool read_int(int64_t* out, int* kind) {
        uint8_t t;
        if (!u8(&t)) return false;
        *kind = 0;
        if (t <= 0x7f) { *out = t; return true; }
        if (t >= 0xe0) { *out = static_cast<int8_t>(t); return true; }
        uint64_t v;
        switch (t) {
            case 0xcc: if (!big(1, &v)) return false; *out = static_cast<int64_t>(v); return true;
            case 0xcd: if (!big(2, &v)) return false; *out = static_cast<int64_t>(v); return true;
            case 0xce: if (!big(4, &v)) return false; *out = static_cast<int64_t>(v); return true;
            case 0xcf: if (!big(8, &v)) return false; *out = static_cast<int64_t>(v); return true;
            case 0xd0: if (!big(1, &v)) return false; *out = static_cast<int8_t>(v); return true;
            case 0xd1: if (!big(2, &v)) return false; *out = static_cast<int16_t>(v); return true;
            case 0xd2: if (!big(4, &v)) return false; *out = static_cast<int32_t>(v); return true;
            case 0xd3: if (!big(8, &v)) return false; *out = static_cast<int64_t>(v); return true;
            case 0xc0: *kind = 3; *out = 0; return true;  // nil
            case 0xc2: *kind = 2; *out = 0; return true;  // false
            case 0xc3: *kind = 2; *out = 1; return true;  // true
            case 0xca: if (!big(4, &v)) return false; { float f; uint32_t u = static_cast<uint32_t>(v); memcpy(&f, &u, 4); *kind = 1; *out = static_cast<int64_t>(f); } return true;
            case 0xcb: if (!big(8, &v)) return false; { double d; memcpy(&d, &v, 8); *kind = 1; *out = static_cast<int64_t>(d); } return true;
            default: *kind = -1; p--; return true;  // not an int family value
        }
    }
    bool read_str(std::string* s) {
        uint8_t t;
        if (!u8(&t)) return false;
        uint64_t n;
        if ((t & 0xe0) == 0xa0) n = t & 0x1f;
        else if (t == 0xd9) { if (!big(1, &n)) return false; }
        else if (t == 0xda) { if (!big(2, &n)) return false; }
        else if (t == 0xdb) { if (!big(4, &n)) return false; }
        else return false;
        if (static_cast<uint64_t>(end - p) < n) return false;
        s->assign(reinterpret_cast<const char*>(p), n);
        p += n;
        return true;
    }
    bool read_array_len(uint64_t* n) {
        uint8_t t;
        if (!u8(&t)) return false;
        if ((t & 0xf0) == 0x90) { *n = t & 0x0f; return true; }
        if (t == 0xdc) return big(2, n);
        if (t == 0xdd) return big(4, n);
        return false;
    }
    bool read_map_len(uint64_t* n) {
        uint8_t t;
        if (!u8(&t)) return false;
        if ((t & 0xf0) == 0x80) { *n = t & 0x0f; return true; }
        if (t == 0xde) return big(2, n);
        if (t == 0xdf) return big(4, n);
        return false;
    }
    bool skip_value() {
        uint8_t t;
        if (!u8(&t)) return false;
        uint64_t n;
        if (t <= 0x7f || t >= 0xe0 || t == 0xc0 || t == 0xc2 || t == 0xc3) return true;
        if ((t & 0xe0) == 0xa0) { n = t & 0x1f; if (static_cast<uint64_t>(end - p) < n) return false; p += n; return true; }
        if ((t & 0xf0) == 0x90) { n = t & 0x0f; for (uint64_t i = 0; i < n; i++) if (!skip_value()) return false; return true; }
        if ((t & 0xf0) == 0x80) { n = t & 0x0f; for (uint64_t i = 0; i < 2 * n; i++) if (!skip_value()) return false; return true; }
        switch (t) {
            case 0xcc: case 0xd0: p += 1; return p <= end;
            case 0xcd: case 0xd1: p += 2; return p <= end;
            case 0xce: case 0xd2: case 0xca: p += 4; return p <= end;
            case 0xcf: case 0xd3: case 0xcb: p += 8; return p <= end;
            case 0xd9: if (!big(1, &n)) return false; p += n; return p <= end;
            case 0xda: if (!big(2, &n)) return false; p += n; return p <= end;
            case 0xdb: if (!big(4, &n)) return false; p += n; return p <= end;
            case 0xc4: if (!big(1, &n)) return false; p += n; return p <= end;
            case 0xc5: if (!big(2, &n)) return false; p += n; return p <= end;
            case 0xc6: if (!big(4, &n)) return false; p += n; return p <= end;
            case 0xdc: if (!big(2, &n)) return false; for (uint64_t i = 0; i < n; i++) if (!skip_value()) return false; return true;
            case 0xdd: if (!big(4, &n)) return false; for (uint64_t i = 0; i < n; i++) if (!skip_value()) return false; return true;
            case 0xde: if (!big(2, &n)) return false; for (uint64_t i = 0; i < 2 * n; i++) if (!skip_value()) return false; return true;
            case 0xdf: if (!big(4, &n)) return false; for (uint64_t i = 0; i < 2 * n; i++) if (!skip_value()) return false; return true;
            default: return false;
        }
    }
};

bool parse_msgpack_body(const uint8_t* data, size_t len, Body* b) {
    MpParser m{data, data + len};
    uint64_t nkeys;
    if (!m.read_map_len(&nkeys)) return false;
    for (uint64_t i = 0; i < nkeys; i++) {
        std::string key;
        if (!m.read_str(&key)) {
            // non-string key: skip key and value (strict_map_key=False).
            if (!m.skip_value() || !m.skip_value()) return false;
            continue;
        }
        if (key == "query" || key == "q") {
            uint64_t n;
            if (!m.read_array_len(&n)) {
                b->bad = true;  // query present but not a list -> 400
                if (!m.skip_value()) return false;
                continue;
            }
            b->have_query = true;
            for (uint64_t k = 0; k < n; k++) {
                int64_t v; int kind;
                if (!m.read_int(&v, &kind)) return false;
                if (kind == -1) { if (!m.skip_value()) return false; b->bad = true; continue; }
                if (kind != 0 || v < 0 || v > 0xFFFFFFFFLL) b->bad = true;
                else b->query.push_back(static_cast<uint32_t>(v));
            }
        } else if (key == "timeout" || key == "t" || key == "limit" || key == "l" ||
                   key == "min_score" || key == "m" || key == "score_pct" ||
                   key == "s") {
            int64_t v; int kind;
            if (!m.read_int(&v, &kind)) return false;
            if (kind == -1) { if (!m.skip_value()) return false; b->bad = true; continue; }
            if (kind == 3) {  // nil
                if (!(key == "min_score" || key == "m")) b->bad = true;
                continue;
            }
            if (key == "timeout" || key == "t") b->timeout = v;
            else if (key == "limit" || key == "l") b->limit = v;
            else if (key == "score_pct" || key == "s") b->score_pct = v;
            else { b->min_score = v; b->have_min_score = true; }
        } else {
            if (!m.skip_value()) return false;
        }
    }
    // msgpack.unpackb raises ExtraData on trailing bytes -> 400.
    return m.p == m.end;
}

// ------------------------------------------------------------- encoding

void mp_uint(std::string* out, uint64_t v) {
    if (v <= 0x7f) { out->push_back(static_cast<char>(v)); return; }
    if (v <= 0xff) { out->push_back(static_cast<char>(0xcc)); out->push_back(static_cast<char>(v)); return; }
    if (v <= 0xffff) {
        out->push_back(static_cast<char>(0xcd));
        out->push_back(static_cast<char>(v >> 8));
        out->push_back(static_cast<char>(v & 0xff));
        return;
    }
    out->push_back(static_cast<char>(0xce));
    for (int s = 24; s >= 0; s -= 8) out->push_back(static_cast<char>((v >> s) & 0xff));
}

void mp_fixstr(std::string* out, const char* s) {
    size_t n = strlen(s);
    out->push_back(static_cast<char>(0xa0 | n));
    out->append(s, n);
}

void mp_array_len(std::string* out, uint64_t n) {
    if (n <= 15) { out->push_back(static_cast<char>(0x90 | n)); return; }
    if (n <= 0xffff) {
        out->push_back(static_cast<char>(0xdc));
        out->push_back(static_cast<char>(n >> 8));
        out->push_back(static_cast<char>(n & 0xff));
        return;
    }
    out->push_back(static_cast<char>(0xdd));
    for (int s = 24; s >= 0; s -= 8) out->push_back(static_cast<char>((n >> s) & 0xff));
}

// Search results -> body bytes, matching api.encode_search_response +
// encode_body (json.dumps default separators; msgpack short keys).
std::string encode_results(const uint32_t* ids, const uint32_t* scores,
                           uint32_t count, bool is_msgpack) {
    std::string out;
    if (is_msgpack) {
        out.push_back(static_cast<char>(0x81));
        mp_fixstr(&out, "r");
        mp_array_len(&out, count);
        for (uint32_t i = 0; i < count; i++) {
            out.push_back(static_cast<char>(0x82));
            mp_fixstr(&out, "i");
            mp_uint(&out, ids[i]);
            mp_fixstr(&out, "s");
            mp_uint(&out, scores[i]);
        }
        return out;
    }
    out = "{\"results\": [";
    char buf[64];
    for (uint32_t i = 0; i < count; i++) {
        snprintf(buf, sizeof(buf), "%s{\"id\": %u, \"score\": %u}",
                 i ? ", " : "", ids[i], scores[i]);
        out += buf;
    }
    out += "]}";
    return out;
}

std::string encode_error_body(const std::string& name, bool is_msgpack) {
    std::string out;
    if (is_msgpack) {
        out.push_back(static_cast<char>(0x81));
        mp_fixstr(&out, "e");
        out.push_back(static_cast<char>(0xa0 | name.size()));
        out += name;
        return out;
    }
    return "{\"error\": \"" + name + "\"}";
}

const char* status_text(int code) {
    switch (code) {
        case 200: return "OK";
        case 400: return "Bad Request";
        case 403: return "Forbidden";
        case 404: return "Not Found";
        case 405: return "Method Not Allowed";
        case 409: return "Conflict";
        case 410: return "Gone";
        case 413: return "Payload Too Large";
        case 415: return "Unsupported Media Type";
        case 500: return "Internal Server Error";
        case 501: return "Not Implemented";
        case 503: return "Service Unavailable";
        default: return "";
    }
}

// ------------------------------------------------------------ connection
//
// v2: epoll event loops.  v1 detached one OS thread per connection; at
// serving in-flight depths (thousands of keep-alive connections) the
// scheduler cost of parking/waking a thread per request dominated the
// request work itself, and every request paid two context switches plus a
// global-mutex handoff.  Now a small fixed pool of event-loop threads owns
// all sockets: requests parse incrementally from per-connection buffers,
// queue to the pump groups, and completions post back to the owning loop
// (eventfd wakeup) which encodes and writes the response.  Wire behavior
// is unchanged (tests/test_native_front.py pins it byte-for-byte).

std::string lower(std::string s) {
    for (char& c : s) c = static_cast<char>(tolower(static_cast<unsigned char>(c)));
    return s;
}

// Content types, mirroring app.py request_type/response_type.
enum Ct { CT_NONE, CT_JSON, CT_MSGPACK, CT_OTHER };

Ct classify_ct(const std::string& header_value) {
    std::string base = lower(header_value.substr(0, header_value.find(';')));
    // trim
    size_t a = base.find_first_not_of(" \t");
    size_t z = base.find_last_not_of(" \t");
    if (a == std::string::npos) return CT_NONE;
    base = base.substr(a, z - a + 1);
    if (base == "application/json") return CT_JSON;
    if (base == "application/vnd.msgpack" || base == "application/msgpack" ||
        base == "application/x-msgpack")
        return CT_MSGPACK;
    return CT_OTHER;
}

struct Conn {
    int fd = -1;
    Loop* loop = nullptr;
    std::string in;        // unparsed request bytes
    std::string out;       // unwritten response bytes
    size_t out_off = 0;    // prefix of `out` already written
    bool want_close = false;  // close once `out` drains
    Req* pending = nullptr;   // search in flight through the pump
    uint32_t events = EPOLLIN;  // current epoll interest
};

struct Loop {
    Server* srv = nullptr;
    int epfd = -1;
    int efd = -1;  // eventfd: completion / new-conn / stop wakeups
    std::thread thread;
    std::mutex cmu;  // guards completions, newconns, running
    std::vector<Req*> completions;
    std::vector<Conn*> newconns;
    bool running = true;
    // Loop-thread-only state:
    std::multimap<Clock::time_point, Req*> timers;  // queued-req deadlines
    std::unordered_set<Conn*> conns;
    std::vector<Conn*> graveyard;  // closed this batch; freed at batch end
};

void set_nonblocking(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void conn_update_events(Conn* c, uint32_t ev) {
    if (c->events == ev) return;
    c->events = ev;
    epoll_event e{};
    e.events = ev;
    e.data.ptr = c;
    epoll_ctl(c->loop->epfd, EPOLL_CTL_MOD, c->fd, &e);
}

// Response bytes (header format identical to v1's write_response) are
// appended to the connection's out buffer; flush_out pushes them.
void append_response(Conn* c, int status, const char* content_type,
                     const std::string& body, bool keep_alive) {
    char head[256];
    int n = snprintf(head, sizeof(head),
                     "HTTP/1.1 %d %s\r\nContent-Type: %s\r\n"
                     "Content-Length: %zu\r\nConnection: %s\r\n\r\n",
                     status, status_text(status), content_type, body.size(),
                     keep_alive ? "keep-alive" : "close");
    c->out.append(head, static_cast<size_t>(n));
    c->out += body;
    if (!keep_alive) c->want_close = true;
}

// False => the peer is gone and the conn must close.
bool flush_out(Conn* c) {
    while (c->out_off < c->out.size()) {
        ssize_t w = send(c->fd, c->out.data() + c->out_off,
                         c->out.size() - c->out_off, MSG_NOSIGNAL);
        if (w > 0) {
            c->out_off += static_cast<size_t>(w);
            continue;
        }
        if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
            conn_update_events(c, EPOLLIN | EPOLLOUT);
            return true;
        }
        if (w < 0 && errno == EINTR) continue;
        return false;
    }
    if (c->out_off) {
        c->out.clear();
        c->out_off = 0;
    }
    conn_update_events(c, EPOLLIN);
    return true;
}

// Detach a dying connection from its in-flight request: a QUEUED request
// is removed from its group and freed; a CLAIMED one is orphaned (the
// pump still owns its token — the completion path frees it).
void detach_pending(Conn* c) {
    Req* r = c->pending;
    if (r == nullptr) return;
    c->pending = nullptr;
    Loop* lp = c->loop;
    if (r->has_timer) {
        lp->timers.erase(r->timer_it);
        r->has_timer = false;
    }
    Server* srv = lp->srv;
    std::lock_guard<std::mutex> lk(srv->mu);
    if (r->state == QUEUED) {
        auto it = srv->groups.find(r->gkey);
        if (it != srv->groups.end()) {
            auto& dq = it->second.q;
            dq.erase(std::remove(dq.begin(), dq.end(), r), dq.end());
        }
        delete r;
    } else {
        r->conn = nullptr;  // orphan: freed when the pump returns it
    }
}

void close_conn(Conn* c) {
    if (c->fd < 0) return;  // already closed earlier in this event batch
    detach_pending(c);
    epoll_ctl(c->loop->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    c->fd = -1;
    c->loop->conns.erase(c);
    c->loop->srv->conns.fetch_add(-1);
    // Freed at the end of the event batch: other events in the same
    // epoll_wait return may still carry this pointer.
    c->loop->graveyard.push_back(c);
}

// Encode + write one resolved request's response on its owning loop
// thread, then resume parsing any pipelined bytes.  Mirrors v1's
// post-wait logic exactly (timeout precedence, late-batch 503, count
// clamp).
bool parse_and_process(Conn* c);  // fwd

void maybe_close_drained(Conn* c) {
    if (c->fd >= 0 && c->want_close && c->out_off >= c->out.size())
        close_conn(c);
}

void respond_req(Loop* lp, Req* r) {
    Server* srv = lp->srv;
    Conn* c = r->conn;
    if (c == nullptr || c->fd < 0) {  // connection died first
        delete r;
        return;
    }
    const char* ct = r->resp_mp ? "application/vnd.msgpack" : "application/json";
    if (r->state == TIMEDOUT ||
        (r->err.empty() && r->deadline != Clock::time_point::max() &&
         Clock::now() > r->deadline)) {
        // Queued past the deadline, or the batch landed late: never serve
        // results after the timeout (searcher _collect_loop semantics).
        srv->timeouts.fetch_add(1);
        append_response(c, 503, ct, encode_error_body("SearchTimeout", r->resp_mp),
                        r->keep_alive);
    } else if (!r->err.empty()) {
        srv->errors.fetch_add(1);
        append_response(c, r->status, ct, encode_error_body(r->err, r->resp_mp),
                        r->keep_alive);
    } else {
        uint32_t out_len = r->out_bucket;
        uint32_t count = r->out[2 * out_len];
        if (count > out_len) count = out_len;
        srv->responded.fetch_add(1);
        append_response(c, 200, ct,
                        encode_results(r->out.data(), r->out.data() + out_len,
                                       count, r->resp_mp),
                        r->keep_alive);
    }
    c->pending = nullptr;
    delete r;
    if (!parse_and_process(c) || !flush_out(c)) {
        close_conn(c);
        return;
    }
    maybe_close_drained(c);
}

// Routes + processes ONE fully-buffered request (the old conn_loop body).
// Either appends an immediate response or enqueues a Req on the pump
// groups (setting c->pending).  Returns false when the conn must close.
bool handle_request(Conn* c, const std::string& method, std::string path,
                    bool http10, const std::string& ct_header,
                    const std::string& accept_header,
                    const std::string& conn_header, const std::string& body) {
    Server* srv = c->loop->srv;
    bool keep_alive =
        conn_header == "keep-alive" || (!http10 && conn_header != "close");

    // Negotiation (app.py request_type/response_type).
    Ct req_ct = ct_header.empty() ? CT_NONE : classify_ct(ct_header);
    if (req_ct == CT_NONE) req_ct = body.empty() ? CT_JSON : CT_MSGPACK;
    Ct acc = accept_header.empty() ? CT_NONE : classify_ct(accept_header);
    Ct resp_ct = (acc == CT_JSON || acc == CT_MSGPACK)
                     ? acc
                     : (req_ct == CT_OTHER ? CT_JSON : req_ct);
    bool resp_mp = resp_ct == CT_MSGPACK;
    const char* resp_ct_s =
        resp_mp ? "application/vnd.msgpack" : "application/json";

    // Routes.
    if (path == "/_health") {
        append_response(c, 200, "text/plain", "OK\n", keep_alive);
        return true;
    }
    std::string index;
    bool is_search = false;
    {
        const std::string suffix = "/_search";
        if (method == "POST" && path.size() > suffix.size() + 1 &&
            path[0] == '/' &&
            path.compare(path.size() - suffix.size(), suffix.size(), suffix) == 0) {
            index = path.substr(1, path.size() - suffix.size() - 1);
            is_search = !index.empty() && index.find('/') == std::string::npos;
        }
    }
    if (!is_search) {
        srv->errors.fetch_add(1);
        append_response(c, 404, resp_ct_s, encode_error_body("IndexNotFound", resp_mp),
                        keep_alive);
        return true;
    }

    // Body decode.
    Body b;
    bool parsed;
    if (req_ct == CT_OTHER) {
        srv->errors.fetch_add(1);
        append_response(c, 415, resp_ct_s,
                        encode_error_body("UnsupportedMediaType", resp_mp), keep_alive);
        return true;
    }
    if (body.empty()) {
        srv->errors.fetch_add(1);
        append_response(c, 400, resp_ct_s, encode_error_body("BadRequest", resp_mp),
                        keep_alive);
        return true;
    }
    if (req_ct == CT_JSON)
        parsed = parse_json_body(body.data(), body.size(), &b);
    else
        parsed = parse_msgpack_body(
            reinterpret_cast<const uint8_t*>(body.data()), body.size(), &b);
    if (!parsed || b.bad || !b.have_query) {
        srv->errors.fetch_add(1);
        append_response(c, 400, resp_ct_s, encode_error_body("BadRequest", resp_mp),
                        keep_alive);
        return true;
    }

    // Sanitize (app.py handle_search) + derive min_score
    // (multi_index.py: ceil(|raw query|/20) when unspecified).
    int64_t raw_len = static_cast<int64_t>(b.query.size());
    int64_t limit = std::max(std::min(b.limit, MAX_LIMIT), int64_t{1});
    int64_t timeout_ms = std::min(b.timeout, MAX_TIMEOUT_MS);
    int64_t min_score =
        b.have_min_score ? std::max(b.min_score, int64_t{0}) : (raw_len + 19) / 20;
    int64_t pct = std::max(std::min(b.score_pct, int64_t{100}), int64_t{0});

    // Query prep (searcher.prepare_query): sort + dedup + cap.
    std::sort(b.query.begin(), b.query.end());
    b.query.erase(std::unique(b.query.begin(), b.query.end()), b.query.end());
    if (b.query.size() > MAX_QUERY_HASHES) b.query.resize(MAX_QUERY_HASHES);
    uint32_t q_len = static_cast<uint32_t>(b.query.size());

    if (q_len == 0) {
        srv->responded.fetch_add(1);
        append_response(c, 200, resp_ct_s,
                        encode_results(nullptr, nullptr, 0, resp_mp), keep_alive);
        return true;
    }

    uint32_t bucket = QUERY_BUCKETS[4];
    for (uint32_t cand : QUERY_BUCKETS)
        if (cand >= q_len) { bucket = cand; break; }
    uint32_t out_bucket = limit <= 128 ? 128 : 512;

    Req* req = new Req();
    req->index = index;
    req->bucket = bucket;
    req->out_bucket = out_bucket;
    req->row.assign(bucket + 4, 0);
    memcpy(req->row.data(), b.query.data(), q_len * 4);
    req->row[bucket] = q_len;
    req->row[bucket + 1] = static_cast<uint32_t>(limit);
    req->row[bucket + 2] = static_cast<uint32_t>(min_score);
    req->row[bucket + 3] = static_cast<uint32_t>(pct);
    // timeout 0 = no deadline; negative = already expired (the Python
    // path treats any non-zero timeout as a deadline, so a negative one
    // lands in the past and answers SearchTimeout).
    req->deadline = timeout_ms > 0 ? Clock::now() + std::chrono::milliseconds(timeout_ms)
                    : timeout_ms == 0 ? Clock::time_point::max()
                                      : Clock::now() - std::chrono::milliseconds(1);
    req->conn = c;
    req->loop = c->loop;
    req->resp_mp = resp_mp;
    req->keep_alive = keep_alive;
    req->gkey = index;
    req->gkey.push_back('\0');
    req->gkey += std::to_string(bucket) + ":" + std::to_string(out_bucket);

    c->pending = req;
    if (req->deadline != Clock::time_point::max()) {
        req->timer_it = c->loop->timers.emplace(req->deadline, req);
        req->has_timer = true;
    }
    {
        std::lock_guard<std::mutex> lk(srv->mu);
        req->seq = srv->next_seq++;
        req->queued = Clock::now();
        srv->groups[req->gkey].q.push_back(req);
        srv->accepted.fetch_add(1);
        srv->pump_cv.notify_one();
    }
    return true;
}

// Consumes complete requests from c->in until one is pending on the pump,
// the conn is closing, or the bytes run out.  Returns false on protocol
// errors that must close the connection.
bool parse_and_process(Conn* c) {
    while (c->fd >= 0 && c->pending == nullptr && !c->want_close) {
        // Header block: lines up to the first empty line (v1 read_line
        // semantics: split on '\n', strip one trailing '\r'; blank lines
        // before the request line are skipped).
        size_t pos = 0;
        size_t head_end = 0;
        bool have_head = false;
        std::vector<std::pair<size_t, size_t>> lines;  // (start, len)
        while (true) {
            size_t nl = c->in.find('\n', pos);
            if (nl == std::string::npos) break;
            size_t len = nl - pos;
            if (len > 0 && c->in[pos + len - 1] == '\r') len--;
            if (len == 0) {
                if (lines.empty()) {  // leading blank line: skip
                    pos = nl + 1;
                    continue;
                }
                have_head = true;
                head_end = nl + 1;
                break;
            }
            lines.emplace_back(pos, len);
            pos = nl + 1;
        }
        if (!have_head) {
            // v1 capped its line buffer at MAX_BODY.
            if (c->in.size() > static_cast<size_t>(MAX_BODY)) return false;
            return true;  // need more bytes
        }

        // Request line.
        std::string line = c->in.substr(lines[0].first, lines[0].second);
        size_t sp1 = line.find(' ');
        size_t sp2 = line.rfind(' ');
        if (sp1 == std::string::npos || sp2 == sp1) return false;
        std::string method = line.substr(0, sp1);
        std::string path = line.substr(sp1 + 1, sp2 - sp1 - 1);
        bool http10 = line.compare(sp2 + 1, std::string::npos, "HTTP/1.0") == 0;
        size_t qpos = path.find('?');
        if (qpos != std::string::npos) path.resize(qpos);

        // Headers.
        int64_t content_length = 0;
        std::string ct_header, accept_header, conn_header;
        for (size_t i = 1; i < lines.size(); i++) {
            std::string h = c->in.substr(lines[i].first, lines[i].second);
            size_t col = h.find(':');
            if (col == std::string::npos) continue;
            std::string k = lower(h.substr(0, col));
            size_t v0 = h.find_first_not_of(" \t", col + 1);
            std::string v = v0 == std::string::npos ? "" : h.substr(v0);
            if (k == "content-length") content_length = atoll(v.c_str());
            else if (k == "content-type") ct_header = v;
            else if (k == "accept") accept_header = v;
            else if (k == "connection") conn_header = lower(v);
        }
        if (content_length < 0 || content_length > MAX_BODY) {
            append_response(c, 413, "application/json",
                            encode_error_body("BadRequest", false), false);
            c->in.clear();
            return true;  // want_close set; drains then closes
        }
        if (c->in.size() < head_end + static_cast<size_t>(content_length))
            return true;  // body not fully buffered yet
        std::string body = c->in.substr(head_end, static_cast<size_t>(content_length));
        c->in.erase(0, head_end + static_cast<size_t>(content_length));

        if (!handle_request(c, method, std::move(path), http10, ct_header,
                            accept_header, conn_header, body))
            return false;
    }
    return true;
}

// False => peer closed or a read error (or buffer overrun).
bool read_into(Conn* c) {
    char tmp[65536];
    while (true) {
        ssize_t r = recv(c->fd, tmp, sizeof(tmp), 0);
        if (r > 0) {
            c->in.append(tmp, static_cast<size_t>(r));
            if (c->in.size() > static_cast<size_t>(MAX_BODY) + 65536) return false;
            if (r < static_cast<ssize_t>(sizeof(tmp))) return true;
            continue;
        }
        if (r == 0) return false;
        if (errno == EAGAIN || errno == EWOULDBLOCK) return true;
        if (errno == EINTR) continue;
        return false;
    }
}

void handle_event(Conn* c, uint32_t ev) {
    if (c->fd < 0) return;  // closed earlier in this batch
    if (ev & (EPOLLHUP | EPOLLERR)) {
        close_conn(c);
        return;
    }
    if (ev & EPOLLIN) {
        if (!read_into(c) || !parse_and_process(c)) {
            close_conn(c);
            return;
        }
    }
    if (!flush_out(c)) {
        close_conn(c);
        return;
    }
    maybe_close_drained(c);
}

void drain_completions(Loop* lp) {
    std::vector<Req*> done;
    std::vector<Conn*> fresh;
    {
        std::lock_guard<std::mutex> lk(lp->cmu);
        done.swap(lp->completions);
        fresh.swap(lp->newconns);
    }
    for (Conn* c : fresh) {
        lp->conns.insert(c);
        epoll_event e{};
        e.events = c->events;
        e.data.ptr = c;
        epoll_ctl(lp->epfd, EPOLL_CTL_ADD, c->fd, &e);
    }
    for (Req* r : done) {
        if (r->has_timer) {
            lp->timers.erase(r->timer_it);
            r->has_timer = false;
        }
        respond_req(lp, r);
    }
}

void fire_timers(Loop* lp) {
    Server* srv = lp->srv;
    auto now = Clock::now();
    while (!lp->timers.empty() && lp->timers.begin()->first <= now) {
        Req* r = lp->timers.begin()->second;
        lp->timers.erase(lp->timers.begin());
        r->has_timer = false;
        bool expired = false;
        {
            std::lock_guard<std::mutex> lk(srv->mu);
            if (r->state == QUEUED) {
                // Deadline passed while still queued: remove ourselves and
                // answer SearchTimeout (the pump never saw this request).
                auto it = srv->groups.find(r->gkey);
                if (it != srv->groups.end()) {
                    auto& dq = it->second.q;
                    dq.erase(std::remove(dq.begin(), dq.end(), r), dq.end());
                }
                r->state = TIMEDOUT;
                expired = true;
            }
            // CLAIMED: the pump owns the token; the completion path
            // answers 503 if it lands past the deadline.
        }
        if (expired) respond_req(lp, r);
    }
}

void do_accept(Loop* lp) {
    Server* srv = lp->srv;
    while (true) {
        int fd = accept4(srv->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
        if (fd < 0) return;  // EAGAIN / stopping
        if (srv->conns.load() >= srv->max_conns) {
            const char* msg =
                "HTTP/1.1 503 Service Unavailable\r\nContent-Length: 0\r\n"
                "Connection: close\r\n\r\n";
            ssize_t ignored = send(fd, msg, strlen(msg), MSG_NOSIGNAL);
            (void)ignored;
            close(fd);
            continue;
        }
        int one = 1;
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        srv->conns.fetch_add(1);
        Loop* target =
            srv->loops[srv->next_loop.fetch_add(1) % srv->loops.size()];
        Conn* c = new Conn();
        c->fd = fd;
        c->loop = target;
        if (target == lp) {
            lp->conns.insert(c);
            epoll_event e{};
            e.events = c->events;
            e.data.ptr = c;
            epoll_ctl(lp->epfd, EPOLL_CTL_ADD, fd, &e);
        } else {
            // Hand off through the target's mailbox; it adds the fd to its
            // own epoll (single-threaded ownership of all conn state).
            bool wake = false;
            {
                std::lock_guard<std::mutex> lk(target->cmu);
                if (target->running) {
                    target->newconns.push_back(c);
                    wake = true;
                }
            }
            if (wake) {
                uint64_t onev = 1;
                ssize_t ignored = write(target->efd, &onev, sizeof(onev));
                (void)ignored;
            } else {
                close(fd);
                srv->conns.fetch_add(-1);
                delete c;
            }
        }
    }
}

void loop_run(Loop* lp, bool is_acceptor) {
    Server* srv = lp->srv;
    epoll_event evs[256];
    while (!srv->stopping.load(std::memory_order_relaxed)) {
        int timeout_ms = 200;
        if (!lp->timers.empty()) {
            auto dt = std::chrono::duration_cast<std::chrono::milliseconds>(
                          lp->timers.begin()->first - Clock::now())
                          .count();
            timeout_ms = dt <= 0 ? 0 : static_cast<int>(std::min<int64_t>(dt + 1, 200));
        }
        int n = epoll_wait(lp->epfd, evs, 256, timeout_ms);
        for (int i = 0; i < n; i++) {
            void* p = evs[i].data.ptr;
            if (p == nullptr) {  // eventfd wakeup
                uint64_t x;
                ssize_t ignored = read(lp->efd, &x, sizeof(x));
                (void)ignored;
                drain_completions(lp);
            } else if (p == reinterpret_cast<void*>(1)) {  // listen socket
                if (is_acceptor) do_accept(lp);
            } else {
                handle_event(static_cast<Conn*>(p), evs[i].events);
            }
        }
        drain_completions(lp);  // eventfd writes coalesce; drain every pass
        fire_timers(lp);
        for (Conn* c : lp->graveyard) delete c;
        lp->graveyard.clear();
    }
    // Shutdown: answer whatever completions are already posted (stop()
    // fails all queued requests and posts them here), then drop the rest.
    {
        std::lock_guard<std::mutex> lk(lp->cmu);
        lp->running = false;
    }
    drain_completions(lp);
    for (Conn* c : lp->graveyard) delete c;
    lp->graveyard.clear();
    std::vector<Conn*> remaining(lp->conns.begin(), lp->conns.end());
    for (Conn* c : remaining) {
        flush_out(c);  // best effort
        close_conn(c);
    }
    for (Conn* c : lp->graveyard) delete c;
    lp->graveyard.clear();
    close(lp->epfd);
    close(lp->efd);
}

// Hand a resolved request back to its owning loop (complete/fail/stop
// callers).  After the loop has exited (`running` false) the request is
// leaked — same teardown policy as the leaked Server (see front_stop).
void post_completion(Req* r) {
    Loop* lp = r->loop;
    bool wake = false;
    {
        std::lock_guard<std::mutex> lk(lp->cmu);
        if (lp->running) {
            lp->completions.push_back(r);
            wake = true;
        }
    }
    if (wake) {
        uint64_t onev = 1;
        ssize_t ignored = write(lp->efd, &onev, sizeof(onev));
        (void)ignored;
    }
}

}  // namespace

extern "C" {

// Starts the front end on `port`. Returns an opaque handle (>0) or -1.
int64_t aitpu_front_start(int32_t port, int32_t max_conns) {
    auto* srv = new Server();
    srv->max_conns = max_conns > 0 ? max_conns : 512;
    srv->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
    if (srv->listen_fd < 0) { delete srv; return -1; }
    int one = 1;
    setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
        listen(srv->listen_fd, 1024) != 0) {
        close(srv->listen_fd);
        delete srv;
        return -1;
    }
    sockaddr_in bound{};
    socklen_t blen = sizeof(bound);
    getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&bound), &blen);
    srv->port = ntohs(bound.sin_port);  // resolves port 0 to the real port
    set_nonblocking(srv->listen_fd);

    // Event loops: enough to spread parse/encode across cores without
    // burning threads the host doesn't have (IO work per request is a few
    // µs; one loop saturates well past 100k req/s).
    unsigned hw = std::thread::hardware_concurrency();
    unsigned n_loops = std::min(4u, std::max(1u, hw / 2));
    for (unsigned i = 0; i < n_loops; i++) {
        auto* lp = new Loop();
        lp->srv = srv;
        lp->epfd = epoll_create1(0);
        lp->efd = eventfd(0, EFD_NONBLOCK);
        epoll_event we{};
        we.events = EPOLLIN;
        we.data.ptr = nullptr;  // eventfd sentinel
        epoll_ctl(lp->epfd, EPOLL_CTL_ADD, lp->efd, &we);
        if (i == 0) {
            epoll_event le{};
            le.events = EPOLLIN;
            le.data.ptr = reinterpret_cast<void*>(1);  // listen sentinel
            epoll_ctl(lp->epfd, EPOLL_CTL_ADD, srv->listen_fd, &le);
        }
        srv->loops.push_back(lp);
    }
    for (unsigned i = 0; i < n_loops; i++) {
        Loop* lp = srv->loops[i];
        lp->thread = std::thread(loop_run, lp, i == 0);
    }
    return reinterpret_cast<int64_t>(srv);
}

// Claims up to max_rows queued requests of ONE (index, bucket, out_bucket)
// group — the group with the oldest head request.  Blocks up to timeout_ms.
// Fills: name_buf (<=256 bytes, returns length in meta[2]), meta[0]=bucket,
// meta[1]=out_bucket, rows (n * (bucket+4) u32), tokens (u64 each).
// Returns n, 0 on timeout, -1 when stopping.
int64_t aitpu_front_next(int64_t handle, uint8_t* name_buf, uint32_t* meta,
                         uint32_t* rows, uint64_t* tokens, int64_t max_rows,
                         int64_t timeout_ms) {
    auto* srv = reinterpret_cast<Server*>(handle);
    std::unique_lock<std::mutex> lk(srv->mu);
    auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
    while (true) {
        if (srv->stopping.load(std::memory_order_relaxed)) return -1;
        // Oldest-head group first (FIFO across groups).
        std::string best;
        uint64_t best_seq = UINT64_MAX;
        for (auto& kv : srv->groups) {
            if (!kv.second.q.empty() && kv.second.q.front()->seq < best_seq) {
                best_seq = kv.second.q.front()->seq;
                best = kv.first;
            }
        }
        if (best_seq != UINT64_MAX) {
            auto& dq = srv->groups[best].q;
            int64_t n = 0;
            uint32_t bucket = dq.front()->bucket;
            uint32_t words = bucket + 4;
            size_t name_len = strlen(best.c_str());  // up to the '\0' marker
            memcpy(name_buf, best.data(), std::min<size_t>(name_len, 255));
            meta[0] = bucket;
            meta[1] = dq.front()->out_bucket;
            meta[2] = static_cast<uint32_t>(std::min<size_t>(name_len, 255));
            auto now = Clock::now();
            int64_t wait_ns = 0;
            int64_t hist[QUEUE_WAIT_BINS] = {};
            while (n < max_rows && !dq.empty()) {
                Req* r = dq.front();
                dq.pop_front();
                r->state = CLAIMED;
                memcpy(rows + n * words, r->row.data(), words * 4);
                tokens[n] = reinterpret_cast<uint64_t>(r);
                int64_t w = std::chrono::duration_cast<std::chrono::nanoseconds>(now - r->queued).count();
                wait_ns += w;
                int bin = 0;
                while (bin < QUEUE_WAIT_BINS - 1 && w > QUEUE_WAIT_BUCKETS_MS[bin] * 1000000) bin++;
                hist[bin]++;
                n++;
            }
            srv->batches.fetch_add(1, std::memory_order_relaxed);
            srv->queue_wait_ns.fetch_add(wait_ns, std::memory_order_relaxed);
            srv->queue_waits.fetch_add(n, std::memory_order_relaxed);
            for (int b = 0; b < QUEUE_WAIT_BINS; b++)
                if (hist[b]) srv->queue_wait_hist[b].fetch_add(hist[b], std::memory_order_relaxed);
            return n;
        }
        if (srv->pump_cv.wait_until(lk, deadline) == std::cv_status::timeout)
            return 0;
    }
}

// Completes n claimed requests with packed output rows (out_words u32 per
// request: ids | scores | count | postings_scanned | truncated | max_ph |
// max_blocks_ph).
int64_t aitpu_front_complete(int64_t handle, const uint64_t* tokens,
                             const uint32_t* out_rows, int64_t n,
                             int64_t out_words) {
    auto* srv = reinterpret_cast<Server*>(handle);
    {
        std::lock_guard<std::mutex> lk(srv->mu);
        for (int64_t i = 0; i < n; i++) {
            Req* r = reinterpret_cast<Req*>(tokens[i]);
            r->out.assign(out_rows + i * out_words, out_rows + (i + 1) * out_words);
            r->state = DONE;
        }
    }
    for (int64_t i = 0; i < n; i++)
        post_completion(reinterpret_cast<Req*>(tokens[i]));
    return 0;
}

// Fails n claimed requests with an error name + HTTP status.
int64_t aitpu_front_fail(int64_t handle, const uint64_t* tokens, int64_t n,
                         int32_t status, const char* error_name) {
    auto* srv = reinterpret_cast<Server*>(handle);
    {
        std::lock_guard<std::mutex> lk(srv->mu);
        for (int64_t i = 0; i < n; i++) {
            Req* r = reinterpret_cast<Req*>(tokens[i]);
            r->status = status;
            r->err = error_name;
            r->state = DONE;
        }
    }
    for (int64_t i = 0; i < n; i++)
        post_completion(reinterpret_cast<Req*>(tokens[i]));
    return 0;
}

// which: 0=accepted, 1=responded, 2=timeouts, 3=errors, 4=open conns,
// 5=bound port (resolves port-0 binds), 6=batches claimed by the pumps,
// 7=claimed requests' queue wait in ns (summed), 8=claimed requests,
// 9..15=claimed requests by queue wait: <= 1, 5, 10, 50, 100, 500 ms, more.
int64_t aitpu_front_stat(int64_t handle, int32_t which) {
    auto* srv = reinterpret_cast<Server*>(handle);
    if (which >= 9 && which < 9 + QUEUE_WAIT_BINS) return srv->queue_wait_hist[which - 9].load();
    switch (which) {
        case 0: return srv->accepted.load();
        case 1: return srv->responded.load();
        case 2: return srv->timeouts.load();
        case 3: return srv->errors.load();
        case 4: return srv->conns.load();
        case 5: return srv->port;
        case 6: return srv->batches.load();
        case 7: return srv->queue_wait_ns.load();
        case 8: return srv->queue_waits.load();
        default: return -1;
    }
}

// Stops accepting, fails queued requests (the loops best-effort answer
// them with 503 before exiting), joins the event loops.
int64_t aitpu_front_stop(int64_t handle) {
    auto* srv = reinterpret_cast<Server*>(handle);
    srv->stopping.store(true);
    shutdown(srv->listen_fd, SHUT_RDWR);
    close(srv->listen_fd);
    std::vector<Req*> failed;
    {
        std::lock_guard<std::mutex> lk(srv->mu);
        for (auto& kv : srv->groups) {
            for (Req* r : kv.second.q) {
                r->status = 503;
                r->err = "IndexNotReady";
                r->state = DONE;
                failed.push_back(r);
            }
            kv.second.q.clear();
        }
        srv->pump_cv.notify_all();
    }
    for (Req* r : failed) post_completion(r);
    for (Loop* lp : srv->loops) {
        uint64_t onev = 1;
        ssize_t ignored = write(lp->efd, &onev, sizeof(onev));
        (void)ignored;
    }
    for (Loop* lp : srv->loops)
        if (lp->thread.joinable()) lp->thread.join();
    // srv (and its loops) are deliberately leaked: a pump thread may still
    // be parked inside aitpu_front_next (pump_cv.wait_until) or about to
    // call complete/fail for an in-flight batch, and there is no handshake
    // that proves all callers have drained — freeing here was a measured
    // use-after-free (corrupted-exception abort at exit).  One ~100KB
    // Server per start/stop cycle, process-lifetime bounded.
    return 0;
}

}  // extern "C"
