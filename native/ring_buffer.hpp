// Lock-free single-producer/single-consumer byte ring buffer.
//
// Replacement for the reference's ingest queues: librtlsdr's
// 15x256KiB async USB transfer list (Code/src/librtlsdr.c:1769-1891) and
// rtl_tcp's mutex-guarded linked list of buffers with drop-oldest at 500
// entries (Code/src/rtl_tcp.c:144-247). One contiguous power-of-two ring,
// acquire/release atomics, no locks on the hot path, explicit drop
// accounting when the producer overruns the consumer.
#pragma once

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace rmt {

class RingBuffer {
 public:
  explicit RingBuffer(size_t capacity_pow2) {
    size_t cap = 1;
    while (cap < capacity_pow2) cap <<= 1;
    buf_.resize(cap);
    mask_ = cap - 1;
  }

  size_t capacity() const { return buf_.size(); }

  size_t readable() const {
    return head_.load(std::memory_order_acquire) -
           tail_.load(std::memory_order_acquire);
  }

  size_t writable() const { return capacity() - readable(); }

  // Producer: write n bytes, or DROP THE WHOLE CHUNK if it doesn't fit.
  //
  // Deliberate deviation from rtl_tcp's drop-oldest policy
  // (`Code/src/rtl_tcp.c:144-188`): drop-oldest requires the PRODUCER to
  // advance the consumer's tail pointer, which races a concurrent read
  // in a lock-free SPSC ring — the consumer can copy bytes mid-overwrite
  // and its tail store can rewind the producer's advance, corrupting
  // both data and accounting (rtl_tcp serializes with a mutex instead).
  // Dropping the *incoming* chunk keeps the SPSC invariant (only the
  // consumer moves tail), keeps whole chunks intact so interleaved-I/Q
  // byte alignment is never broken by an odd-length drop, and for the
  // real-time criterion the signal is identical: drops > 0 means the
  // consumer fell behind.
  void write_overwrite(const uint8_t* data, size_t n) {
    if (n > writable()) {
      dropped_.fetch_add(n, std::memory_order_relaxed);
      return;
    }
    size_t head = head_.load(std::memory_order_relaxed);
    size_t idx = head & mask_;
    size_t first = std::min(n, capacity() - idx);
    std::memcpy(buf_.data() + idx, data, first);
    if (n > first) std::memcpy(buf_.data(), data + first, n - first);
    head_.store(head + n, std::memory_order_release);
    written_.fetch_add(n, std::memory_order_relaxed);
  }

  // Consumer: read up to n bytes; returns bytes actually read.
  size_t read(uint8_t* out, size_t n) {
    size_t avail = readable();
    if (avail == 0) return 0;
    n = std::min(n, avail);
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t idx = tail & mask_;
    size_t first = std::min(n, capacity() - idx);
    std::memcpy(out, buf_.data() + idx, first);
    if (n > first) std::memcpy(out + first, buf_.data(), n - first);
    tail_.store(tail + n, std::memory_order_release);
    return n;
  }

  // Consumer: read exactly n (≤ readable()) bytes with the memcpy split
  // across `threads` parallel ranges. Still SPSC-correct: one tail
  // snapshot defines every range, workers touch disjoint spans of both
  // ring and destination, and the tail advances ONCE after all joined —
  // the producer never sees a partial read. Caller must ensure
  // n <= readable() (checked; excess is clamped).
  size_t read_ranges(uint8_t* out, size_t n, int threads) {
    size_t avail = readable();
    n = std::min(n, avail);
    if (n == 0) return 0;
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t per = (n + threads - 1) / threads;
    std::vector<std::thread> workers;
    workers.reserve(threads - 1);
    auto copy_span = [this](uint8_t* dst, size_t src_pos, size_t len) {
      size_t idx = src_pos & mask_;
      size_t first = std::min(len, capacity() - idx);
      std::memcpy(dst, buf_.data() + idx, first);
      if (len > first) std::memcpy(dst + first, buf_.data(), len - first);
    };
    for (int t = 1; t < threads; t++) {
      size_t off = static_cast<size_t>(t) * per;
      if (off >= n) break;
      size_t len = std::min(per, n - off);
      workers.emplace_back(copy_span, out + off, tail + off, len);
    }
    copy_span(out, tail, std::min(per, n));
    for (auto& w : workers) w.join();
    tail_.store(tail + n, std::memory_order_release);
    return n;
  }

  uint64_t total_written() const { return written_.load(std::memory_order_relaxed); }
  uint64_t total_dropped() const { return dropped_.load(std::memory_order_relaxed); }

 private:
  std::vector<uint8_t> buf_;
  size_t mask_ = 0;
  std::atomic<uint64_t> head_{0};
  std::atomic<uint64_t> tail_{0};
  std::atomic<uint64_t> written_{0};
  std::atomic<uint64_t> dropped_{0};
};

}  // namespace rmt
