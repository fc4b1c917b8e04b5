// radio-mapper-tpu host ingest library.
//
// Native replacement for the reference's L0/L1 ingest stack: librtlsdr's
// async bulk-transfer engine (Code/src/librtlsdr.c:1769-1891) and
// rtl_tcp's buffered network transport (Code/src/rtl_tcp.c:144-365) —
// re-scoped for a compute host: the producer thread pulls raw uint8 I/Q from
// a source (file replay, TCP rtl_tcp stream, or an in-process generator),
// stamps block boundaries with CLOCK_REALTIME nanoseconds, and lands the
// bytes in a lock-free ring; the consumer (Python, via ctypes) drains
// fixed-size blocks ready for HBM upload. Optional decode converts uint8
// to float32 (u8 - 127.5) with SIMD-friendly inner loops so the host can
// hand the device either raw bytes or ready floats.
//
// C API (see python bindings in radio_mapper_tpu/ingest/native.py):
//   rmt_ingest_open_file / open_tcp / open_synthetic
//   rmt_ingest_read(handle, out_u8, nbytes, timeout_ms) -> bytes, ts_ns
//   rmt_ingest_decode(u8, n, out_f32)  (offset-center decode)
//   rmt_ingest_stats(handle, ...)
//   rmt_ingest_close(handle)

#include <arpa/inet.h>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>

#include "ring_buffer.hpp"

namespace rmt {
namespace {

int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

struct Source {
  virtual ~Source() = default;
  // Fill up to n bytes; return bytes produced, 0 on EOF/stall, <0 on error.
  virtual ssize_t pull(uint8_t* out, size_t n) = 0;
};

struct FileSource : Source {
  FILE* f = nullptr;
  bool loop;
  explicit FileSource(const char* path, bool loop_) : loop(loop_) {
    f = std::fopen(path, "rb");
  }
  ~FileSource() override {
    if (f) std::fclose(f);
  }
  ssize_t pull(uint8_t* out, size_t n) override {
    if (!f) return -1;
    size_t got = std::fread(out, 1, n, f);
    if (got == 0 && loop) {
      std::rewind(f);
      got = std::fread(out, 1, n, f);
    }
    return static_cast<ssize_t>(got);
  }
};

struct TcpSource : Source {
  int fd = -1;
  TcpSource(const char* host, int port, bool rtl_tcp_header) {
    struct addrinfo hints = {}, *res = nullptr;
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    char portstr[16];
    std::snprintf(portstr, sizeof portstr, "%d", port);
    if (getaddrinfo(host, portstr, &hints, &res) != 0) return;
    fd = socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd >= 0 && connect(fd, res->ai_addr, res->ai_addrlen) != 0) {
      close(fd);
      fd = -1;
    }
    freeaddrinfo(res);
    if (fd >= 0 && rtl_tcp_header) {
      uint8_t hdr[12];  // "RTL0" + tuner type + gain count
      size_t got = 0;
      while (got < sizeof hdr) {
        ssize_t r = recv(fd, hdr + got, sizeof hdr - got, 0);
        if (r <= 0) break;
        got += static_cast<size_t>(r);
      }
    }
  }
  ~TcpSource() override {
    if (fd >= 0) close(fd);
  }
  ssize_t pull(uint8_t* out, size_t n) override {
    if (fd < 0) return -1;
    ssize_t r = recv(fd, out, n, 0);
    return r;
  }
};

// Deterministic uint8 noise generator — hardware-free load testing.
// Fills by 64-bit xorshift words (8 bytes per state update) so the
// generator sustains multi-GB/s: it must be able to model the aggregate
// byte rate of hundreds of 2.4 MS/s receivers (SURVEY §7 hard-part (c)),
// not become the bottleneck itself.
struct SyntheticSource : Source {
  uint64_t state;
  explicit SyntheticSource(uint32_t seed) : state(seed * 0x9E3779B97F4A7C15ull | 1) {}
  ssize_t pull(uint8_t* out, size_t n) override {
    size_t i = 0;
    for (; i + 8 <= n; i += 8) {
      state ^= state << 13;
      state ^= state >> 7;
      state ^= state << 17;
      std::memcpy(out + i, &state, 8);
    }
    for (; i < n; i++) out[i] = static_cast<uint8_t>(state >> (8 * (i & 7)));
    return static_cast<ssize_t>(n);
  }
};

// Rate-paced wrapper: produces at most `bytes_per_s`, modelling a real
// SDR front-end's fixed sample clock (librtlsdr delivers at the tuned
// rate, `Code/src/librtlsdr.c:1075-1126`). With pacing, ring drops are a
// REAL signal — drops == 0 means the consumer kept up with real time —
// which is exactly the reference's `rtl_test` drop criterion
// (`Code/src/rtl_test.c:109-135`).
struct PacedSource : Source {
  std::unique_ptr<Source> inner;
  double bytes_per_s;
  std::chrono::steady_clock::time_point start;
  uint64_t produced = 0;
  PacedSource(std::unique_ptr<Source> in, double rate)
      : inner(std::move(in)), bytes_per_s(rate),
        start(std::chrono::steady_clock::now()) {}
  ssize_t pull(uint8_t* out, size_t n) override {
    double elapsed =
        std::chrono::duration<double>(std::chrono::steady_clock::now() - start)
            .count();
    uint64_t budget = static_cast<uint64_t>(elapsed * bytes_per_s);
    if (produced >= budget) {
      double wait_s = (produced + n - budget) / bytes_per_s;
      std::this_thread::sleep_for(std::chrono::duration<double>(
          std::min(wait_s, 0.010)));
      return 0;  // stall (producer loop retries)
    }
    size_t allowed = static_cast<size_t>(
        std::min<uint64_t>(n, budget - produced));
    ssize_t got = inner->pull(out, allowed);
    if (got > 0) produced += static_cast<uint64_t>(got);
    return got;
  }
};

struct Ingest {
  std::unique_ptr<Source> source;
  RingBuffer ring;
  std::thread producer;
  std::atomic<bool> running{true};
  std::atomic<int64_t> last_ts_ns{0};
  std::atomic<uint64_t> read_bytes{0};
  std::mutex mu;
  std::condition_variable cv;
  int error = 0;

  Ingest(std::unique_ptr<Source> src, size_t ring_bytes, size_t chunk)
      : source(std::move(src)), ring(ring_bytes) {
    // A chunk that can never fit would drop forever under the SPSC
    // drop-newest policy (ring_buffer.hpp); clamp to half the ring so
    // data always flows even with pathological caller sizes.
    chunk = std::min(chunk, ring.capacity() / 2);
    if (chunk == 0) chunk = 1;
    producer = std::thread([this, chunk] {
      std::vector<uint8_t> buf(chunk);
      while (running.load(std::memory_order_relaxed)) {
        ssize_t got = source->pull(buf.data(), buf.size());
        if (got < 0) {
          error = 1;
          break;
        }
        if (got == 0) {
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
          continue;
        }
        // Stamp BEFORE publishing the bytes: a consumer that sees data in
        // the ring must also see a nonzero timestamp (release pairs with
        // the reader's acquire load in rmt_ingest_read).
        last_ts_ns.store(now_ns(), std::memory_order_release);
        ring.write_overwrite(buf.data(), static_cast<size_t>(got));
        cv.notify_one();
      }
      cv.notify_all();
    });
  }

  ~Ingest() {
    running.store(false);
    if (producer.joinable()) producer.join();
  }
};

std::mutex g_mu;
std::map<int, std::unique_ptr<Ingest>> g_handles;
int g_next = 1;

int register_handle(std::unique_ptr<Ingest> ing) {
  std::lock_guard<std::mutex> lk(g_mu);
  int h = g_next++;
  g_handles[h] = std::move(ing);
  return h;
}

Ingest* get(int h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_handles.find(h);
  return it == g_handles.end() ? nullptr : it->second.get();
}

}  // namespace
}  // namespace rmt

extern "C" {

int rmt_ingest_open_file(const char* path, int loop, size_t ring_bytes,
                         size_t chunk_bytes) {
  auto src = std::make_unique<rmt::FileSource>(path, loop != 0);
  if (!src->f) return -1;
  return rmt::register_handle(std::make_unique<rmt::Ingest>(
      std::move(src), ring_bytes, chunk_bytes));
}

int rmt_ingest_open_tcp(const char* host, int port, int rtl_tcp_header,
                        size_t ring_bytes, size_t chunk_bytes) {
  auto src = std::make_unique<rmt::TcpSource>(host, port, rtl_tcp_header != 0);
  if (src->fd < 0) return -1;
  return rmt::register_handle(std::make_unique<rmt::Ingest>(
      std::move(src), ring_bytes, chunk_bytes));
}

int rmt_ingest_open_synthetic(unsigned seed, size_t ring_bytes,
                              size_t chunk_bytes) {
  return rmt::register_handle(std::make_unique<rmt::Ingest>(
      std::make_unique<rmt::SyntheticSource>(seed), ring_bytes, chunk_bytes));
}

// Synthetic source paced to bytes_per_s — models a real SDR sample clock
// so ring drop accounting becomes the real-time criterion (rtl_test's
// drop benchmark, `Code/src/rtl_test.c:109-135`).
int rmt_ingest_open_synthetic_paced(unsigned seed, double bytes_per_s,
                                    size_t ring_bytes, size_t chunk_bytes) {
  auto src = std::make_unique<rmt::PacedSource>(
      std::make_unique<rmt::SyntheticSource>(seed), bytes_per_s);
  return rmt::register_handle(std::make_unique<rmt::Ingest>(
      std::move(src), ring_bytes, chunk_bytes));
}

// Blocking read of exactly nbytes (or fewer on timeout/EOF). Returns bytes
// read; *ts_ns gets the producer's latest block timestamp.
long rmt_ingest_read(int handle, uint8_t* out, size_t nbytes, int timeout_ms,
                     int64_t* ts_ns) {
  rmt::Ingest* ing = rmt::get(handle);
  if (!ing) return -1;
  size_t got = 0;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (got < nbytes) {
    size_t r = ing->ring.read(out + got, nbytes - got);
    got += r;
    if (got >= nbytes) break;
    if (ing->error && ing->ring.readable() == 0) break;
    std::unique_lock<std::mutex> lk(ing->mu);
    if (ing->cv.wait_until(lk, deadline) == std::cv_status::timeout) break;
  }
  ing->read_bytes.fetch_add(got, std::memory_order_relaxed);
  if (ts_ns) *ts_ns = ing->last_ts_ns.load(std::memory_order_acquire);
  return static_cast<long>(got);
}

// Multi-threaded drain: same contract as rmt_ingest_read but the ring→out
// memcpy is split across `threads` ranges copied in parallel. The SPSC
// invariant holds — the consumer is still ONE logical reader: ranges are
// computed from a single tail snapshot and the tail advances once, after
// every worker joined. Worth it only for multi-MB blocks (the 64-ch
// flagship block is 16.8 MB; a single-thread memcpy leg measured
// ~3 GB/s on the dev host, ~4× short of the 256-ch aggregate byte rate).
long rmt_ingest_read_mt(int handle, uint8_t* out, size_t nbytes,
                        int timeout_ms, int64_t* ts_ns, int threads) {
  rmt::Ingest* ing = rmt::get(handle);
  if (!ing) return -1;
  if (threads < 2 || nbytes < (4u << 20)) {
    return rmt_ingest_read(handle, out, nbytes, timeout_ms, ts_ns);
  }
  if (threads > 16) threads = 16;
  size_t got = 0;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (got < nbytes) {
    size_t want = nbytes - got;
    size_t avail = ing->ring.readable();
    size_t n = std::min(want, avail);
    if (n >= (1u << 20) || (n > 0 && n == want)) {
      got += ing->ring.read_ranges(out + got, n, threads);
      if (got >= nbytes) break;
      continue;
    }
    if (ing->error && avail == 0) break;
    std::unique_lock<std::mutex> lk(ing->mu);
    if (ing->cv.wait_until(lk, deadline) == std::cv_status::timeout) break;
  }
  ing->read_bytes.fetch_add(got, std::memory_order_relaxed);
  if (ts_ns) *ts_ns = ing->last_ts_ns.load(std::memory_order_acquire);
  return static_cast<long>(got);
}

// uint8 interleaved I/Q -> float32 (u8 - 127.5) * scale, vector-friendly.
void rmt_ingest_decode(const uint8_t* in, size_t n, float scale, float* out) {
  for (size_t i = 0; i < n; i++) {
    out[i] = (static_cast<float>(in[i]) - 127.5f) * scale;
  }
}

void rmt_ingest_stats(int handle, uint64_t* written, uint64_t* dropped,
                      uint64_t* consumed, int* error) {
  rmt::Ingest* ing = rmt::get(handle);
  if (!ing) return;
  if (written) *written = ing->ring.total_written();
  if (dropped) *dropped = ing->ring.total_dropped();
  if (consumed) *consumed = ing->read_bytes.load(std::memory_order_relaxed);
  if (error) *error = ing->error;
}

void rmt_ingest_close(int handle) {
  std::lock_guard<std::mutex> lk(rmt::g_mu);
  rmt::g_handles.erase(handle);
}

}  // extern "C"
