// byteps_tpu DCN parameter server + worker client (C++17, POSIX sockets).
//
// TPU-native re-implementation of the reference's inter-node tier:
// byteps/server/server.cc (BytePSHandler, engine threads, parked pulls,
// sync/async modes) + the ps-lite ZPush/ZPull worker API used by
// byteps/common/core_loops.cc:538-618. The RDMA/ZMQ transport becomes
// length-prefixed TCP over DCN; zero-copy is approximated with one-copy
// into page-aligned stores (reference: PageAlignedMalloc, server.cc:266-295).
//
// Protocol (little-endian, same-arch assumption documented in server/README):
//   MsgHeader { magic u32; op u8; flags u8; sender u16; rid u32; key u64;
//               cmd u32; len u32; epoch u64; codec u32 }  -- 40 bytes, then
//   len payload bytes. epoch = (round << 16) | attempt stamps PUSH/PUSHPULL
//   for idempotent replay (see "Replay dedup" below); 0 = unstamped (init
//   pushes, legacy callers). codec = (plan_epoch << 8) | codec_id tags a
//   push with the wire codec the sender's adaptive plan chose for this
//   round (0 = untagged/static config, no validation): the server latches
//   the first fold's tag per round and LOUDLY rejects any disagreeing fold
//   — cross-worker plan skew must fail the round, never silently mis-sum
//   dense bytes with codec payloads. The magic was bumped when epoch was
//   added, and again for the codec tag, so a version-skewed peer fails
//   loudly on the first message instead of misparsing payload bytes as a
//   header.
// Ops: INIT_PUSH, PUSH, PULL, BARRIER, SHUTDOWN, IPC_HELLO from workers;
//      ACK, PULL_REPLY from the server. Every request carries a worker-side
//      request id (rid) echoed in the reply, so one connection multiplexes
//      concurrent blocking calls from many scheduler threads (the ps-lite
//      callback model, flattened to promise/wait). IPC_HELLO upgrades a
//      loopback connection to the colocated shm transport (see the
//      "Colocated shm transport" section below).
//
// Aggregation protocol per key (sync mode, mirrors server.cc:296-409):
//   - INIT_PUSH allocates the page-aligned store; the reply is withheld
//     until all num_workers init-pushes arrive (global barrier semantics).
//   - steady PUSH: first of a round memcpy's into accum, later ones sum
//     (dtype-aware), the last one copies accum->merged, bumps
//     completed_rounds and flushes parked pulls.
//   - PULL from worker w is answerable iff completed_rounds >= w's push
//     count (their contribution is folded in); otherwise parked.
//   - async mode (BYTEPS_ENABLE_ASYNC, server.cc:315-319): every push sums
//     straight into merged, pulls always answered.
//
// Engine threads: keys are load-balanced over N engine threads by
// accumulated bytes (reference: server.h:154-178); each thread owns a
// priority queue ordered by per-key completed push count when scheduling
// is enabled (reference: server/queue.h:31-105).

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sched.h>
#include <sys/epoll.h>  // edge-triggered deadline waits (recv_all_deadline)
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/uio.h>
#include <unistd.h>
#include <zlib.h>  // lossless wire tier's entropy stage (build.py links -lz)
#if defined(__linux__)
#include <linux/futex.h>
#include <sys/syscall.h>
#endif
#if defined(__x86_64__)
// Included unconditionally on x86-64: the runtime-dispatched SIMD fold
// kernels below are compiled with per-function target attributes
// (GCC >= 4.9 allows intrinsics inside target("avx2"/"avx512f")
// functions regardless of the baseline -m flags), while the
// compile-time __AVX2__ blocks in the codec keep their old gating.
#include <immintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cerrno>
#include <chrono>
#include <climits>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#if defined(__linux__)
#include <malloc.h>  // mallopt (the call itself is #ifdef-guarded too)
#endif
#include <cstring>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <tuple>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace bps {

static constexpr uint32_t kMagic = 0xB17E5003;  // 5002 + striped segments

// MsgHeader::flags bits. Bit 0 (error) is wire contract both
// transports. Bit 7 (out-of-band payload) is SHM-RING-ONLY framing: it
// marks a message whose payload bytes live in the shared arena segment
// (an 8-byte IpcDesc follows the header on the ring instead of the
// payload), and it is set and cleared entirely inside IpcChan — a
// header that crosses TCP, or that reaches the engine/waiter layers,
// NEVER carries it, so the Python header mirror is unaffected.
static constexpr uint8_t kFlagErr = 1;
static constexpr uint8_t kFlagOob = 0x80;
// Ring-only like kFlagOob: an ECHO reply whose descriptor names a
// block in the RECEIVER'S OWN tx arena — the single-worker fused
// fast path where the dense aggregate is bit-identical to the bytes
// the client just pushed, so the server sends 8 bytes instead of
// copying the payload back (see DoPush's echo tail).
static constexpr uint8_t kFlagOobEcho = 0x40;
// Wire framing (TCP only): the payload of this PUSH/PUSHPULL message is
// ONE SEGMENT of a larger striped payload — a 32-byte SegHdr follows
// the MsgHeader, then the chunk bytes (h.len covers both). Segments of
// one logical push fan out over the worker's striped data connections
// and reassemble server-side before the engine ever sees the message,
// so the flag never reaches the engine/waiter layers either.
static constexpr uint8_t kFlagSeg = 0x20;

// TSAN-visible mutex/condvar with EXPLICIT pthread init/destroy. glibc's
// std::mutex / std::condition_variable are zero-initialized (no
// pthread_*_init call), so TSAN cannot distinguish a fresh instance from
// whatever previously occupied the same heap address — any heap block
// landing where a destroyed lock once lived (a reaped CPython condition,
// an earlier native object) then reports "double lock of a destroyed
// mutex" on first use, the PR-6 sanitizer finding (tests/
// test_sanitize.py). pthread_mutex_init / pthread_cond_init ARE
// TSAN-intercepted and reset the sync-object state at construction, so
// every native mutex/cv goes through these wrappers. Cv waits run on
// CLOCK_MONOTONIC (wall-clock jumps must not stretch timeouts).
class Mu {
 public:
  Mu() { pthread_mutex_init(&m_, nullptr); }
  ~Mu() { pthread_mutex_destroy(&m_); }
  Mu(const Mu&) = delete;
  Mu& operator=(const Mu&) = delete;
  void lock() { pthread_mutex_lock(&m_); }
  void unlock() { pthread_mutex_unlock(&m_); }
  pthread_mutex_t* native() { return &m_; }
 private:
  pthread_mutex_t m_;
};

class Cv {
 public:
  Cv() {
    pthread_condattr_t a;
    pthread_condattr_init(&a);
    pthread_condattr_setclock(&a, CLOCK_MONOTONIC);
    pthread_cond_init(&c_, &a);
    pthread_condattr_destroy(&a);
  }
  ~Cv() { pthread_cond_destroy(&c_); }
  Cv(const Cv&) = delete;
  Cv& operator=(const Cv&) = delete;
  void notify_one() { pthread_cond_signal(&c_); }
  void notify_all() { pthread_cond_broadcast(&c_); }
  void wait(std::unique_lock<Mu>& lk) {
    pthread_cond_wait(&c_, lk.mutex()->native());
  }
  template <typename Pred>
  void wait(std::unique_lock<Mu>& lk, Pred p) {
    while (!p()) wait(lk);
  }
  // std::condition_variable::wait_for(pred) semantics: returns pred()
  // at exit (true = predicate satisfied, false = timed out).
  template <typename Pred>
  bool wait_for_ms(std::unique_lock<Mu>& lk, long ms, Pred p) {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    ts.tv_sec += ms / 1000;
    ts.tv_nsec += (ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
      ts.tv_sec += 1;
      ts.tv_nsec -= 1000000000L;
    }
    while (!p()) {
      if (pthread_cond_timedwait(&c_, lk.mutex()->native(), &ts) ==
          ETIMEDOUT)
        return p();
    }
    return true;
  }
 private:
  pthread_cond_t c_;
};

// ------------------------------------------------------------------ //
// payload buffers
//
// std::vector<uint8_t>::resize() VALUE-initializes — every received
// payload was being memset to zero immediately before recv() overwrote
// it, a full second write pass over multi-MB partitions on the server
// hot loop. Buf keeps vector semantics (moves, shared_ptr publish,
// capacity reuse) but default-initializes new bytes, so resize-then-
// recv touches the payload exactly once. Sites that NEED zeros keep
// saying so explicitly (assign(n, 0) / memset), which value-
// initializes as before.
// ------------------------------------------------------------------ //

template <typename T>
struct DefaultInitAlloc : std::allocator<T> {
  template <typename U>
  struct rebind {
    using other = DefaultInitAlloc<U>;
  };
  template <typename U, typename... Args>
  void construct(U* p, Args&&... args) {
    if constexpr (sizeof...(Args) == 0)
      ::new (static_cast<void*>(p)) U;  // default-init: no zero fill
    else
      ::new (static_cast<void*>(p)) U(std::forward<Args>(args)...);
  }
};

using Buf = std::vector<uint8_t, DefaultInitAlloc<uint8_t>>;

// Free list of payload buffers: the conn loops lease one per incoming
// message, the engine thread folds from it and returns it after the
// fold — the "fold scratch" tier of the zero-copy recv path. Together
// with the publish-by-move recycle in the handlers, steady-state dense
// traffic does no per-message heap allocation at all. Bounded so a
// burst of oversized leases can't pin memory forever.
class BufPool {
 public:
  Buf lease(size_t n) {
    {
      std::lock_guard<Mu> lk(mu_);
      // prefer a buffer already big enough (no realloc); else reuse
      // the last one's allocation as the growth seed
      for (size_t i = free_.size(); i-- > 0;) {
        if (free_[i].capacity() >= n) {
          Buf b = std::move(free_[i]);
          free_.erase(free_.begin() + (long)i);
          b.resize(n);
          return b;
        }
      }
      if (!free_.empty()) {
        Buf b = std::move(free_.back());
        free_.pop_back();
        b.resize(n);
        if (on_alloc_) on_alloc_(b.data(), b.capacity());
        return b;
      }
    }
    Buf b;
    b.resize(n);
    if (on_alloc_) on_alloc_(b.data(), b.capacity());
    return b;
  }

  void put(Buf&& b) {
    if (b.capacity() == 0) return;
    std::lock_guard<Mu> lk(mu_);
    if (free_.size() >= kMaxPooled) return;  // drop: bounded footprint
    b.clear();
    free_.push_back(std::move(b));
  }

  // RDMA-shaped registration hook (TransportReg): invoked with the
  // (base, capacity) of every block the lease path ALLOCATES (cache
  // hits recycle already-registered memory and skip it), so the
  // transport layer's registry tracks exactly the blocks the recv path
  // can land payloads in. Set once at Server construction, before any
  // conn thread leases.
  void set_alloc_hook(std::function<void(const void*, size_t)> h) {
    on_alloc_ = std::move(h);
  }

 private:
  static constexpr size_t kMaxPooled = 32;
  Mu mu_;
  std::vector<Buf> free_;  // guarded-by: mu_
  std::function<void(const void*, size_t)> on_alloc_;
};

enum Op : uint8_t {
  INIT_PUSH = 1,
  PUSH = 2,
  PULL = 3,
  BARRIER = 4,
  SHUTDOWN = 5,
  ACK = 6,
  PULL_REPLY = 7,
  COMP_INIT = 8,  // per-key compressor kwargs (operations.cc:396-408)
  IPC_HELLO = 9,  // colocated shm-transport upgrade (BYTEPS_ENABLE_IPC)
  IPC_CONFIRM = 10,  // client commit of the upgrade (3rd handshake leg)
  // Fused push+pull in ONE wire message (the THC observation, arxiv
  // 2302.08545: the PS exchange is a single aggregation round trip).
  // The payload is folded exactly like PUSH; the reply is withheld and
  // parked alongside parked pulls, streaming to every fused requester
  // the moment the aggregation round completes. Replaces a
  // PUSH + PULL pair (two wire transitions, one thread parked in recv
  // for the aggregation wait) with one request and a completion-queue
  // reply. A push-stage error replies ACK with flags=1 instead.
  PUSHPULL = 11,
  // Observability control plane (docs/timeline.md, docs/observability
  // .md "fleet"): header-only requests handled INLINE by the conn loop
  // — they must never queue behind data-plane folds (a stats poll that
  // waits out a 256MB fold would measure itself). Values are wire
  // contract, mirrored by server/client.py WIRE_CTRL_OPS.
  STATS_PULL = 12,    // reply: u64 slot vector (kStatSlotNames order)
  TRACE_DRAIN = 13,   // reply: packed TraceRec[] (destructive read)
  FLIGHT_DRAIN = 14,  // reply: packed FlightRec[] (snapshot, kept)
  CLOCK_PROBE = 15,   // reply: {recv_ns, send_ns} steady-clock echo
  // Elastic-fleet control plane (docs/fault-tolerance.md "Elasticity"),
  // riding the same inline conn-loop path as the observability ops:
  JOIN_PROBE = 16,  // reply: {num_workers, draining} — the scale-up
                    // join handshake: a worker verifies the newcomer is
                    // up and agrees on the worker count BEFORE the
                    // registry routes key subranges to it
  DRAIN_REQ = 17,   // mark this server draining (advisory flag + flight
                    // event); reply: {keys_held, 1} — the drain ACK a
                    // worker collects after migrating the keys away
  // Training-health plane (docs/observability.md "Training-health
  // plane"): per-key post-aggregation statistics computed by the
  // in-fold pass (BYTEPS_HEALTH). Header-only request carrying the key;
  // reply: one packed HealthRec for the key's last PUBLISHED round, or
  // an error ACK when the key is unknown / the health pass is off.
  HEALTH_PULL = 18,
  // Time-series plane (docs/observability.md "Time-series plane"):
  // per-conn / per-data-lane wire counters — the PR 17 stripe plane
  // DE-aggregated so a dead-slow lane stops hiding inside fleet
  // totals. Header-only request; reply: packed StripeRec[] (snapshot,
  // kept), one record per live connection, kCtrlStripeMax cap.
  STRIPE_PULL = 19,
};

enum ReqType : uint32_t {
  kDefaultPushPull = 0,
  kRowSparsePushPull = 1,
  kCompressedPushPull = 2,
};

// Wire codec ids for the adaptive-plan tag (MsgHeader::codec low byte).
// Values are wire contract — byteps_tpu.core.codec_plane.WIRE_CODEC_IDS
// mirrors them. 0 = untagged (static per-config codecs, no validation).
enum WireCodec : uint8_t {
  kCodecUntagged = 0,
  kCodecDense = 1,
  kCodecLossless = 2,
  kCodecOnebit = 3,
  kCodecTopk = 4,
  kCodecRandomk = 5,
  kCodecDithering = 6,
};

// DataType codes match byteps_tpu.core.types.DataType (mshadow order).
enum DType : uint32_t {
  F32 = 0, F64 = 1, F16 = 2, U8 = 3, I32 = 4, I8 = 5, I64 = 6,
  BF16 = 7, U16 = 8,
};

#pragma pack(push, 1)
struct MsgHeader {
  uint32_t magic;
  uint8_t op;
  uint8_t flags;
  uint16_t sender;
  uint32_t rid;
  uint64_t key;
  uint32_t cmd;   // cantor(request_type, dtype) — common.cc:98-101
  uint32_t len;
  // Replay-dedup stamp for PUSH/PUSHPULL: (round << 16) | attempt. The
  // round is the worker-side per-key submission ordinal (monotonic);
  // attempt counts wire retries of the same round. The server folds a
  // given (key, sender, round) at most once — a retried push after a
  // dropped reply must never double-count into the aggregation. 0 =
  // unstamped (init pushes, pulls, blocking legacy callers): no dedup.
  uint64_t epoch;
  // Adaptive-codec plan tag: (plan_epoch << 8) | WireCodec id. The first
  // fold of a round latches it; a later fold of the SAME round carrying a
  // different tag (codec id OR plan epoch) is rejected with a loud error
  // reply — the aggregation-safety net for cross-worker plan skew
  // (docs/compression.md). 0 = untagged: static-config traffic, no
  // validation. Trailing fields are declared last so every
  // aggregate-initialized reply header ({kMagic, ACK, ...}) zero-fills
  // them.
  uint32_t codec;
};
#pragma pack(pop)

static_assert(sizeof(MsgHeader) == 40, "header layout");

// Striped-segment subheader (kFlagSeg): follows the MsgHeader on the
// wire, before the chunk bytes. `seq` is the sender's per-key striped-
// send ordinal — the server dispatches reassembled messages of one
// (sender, key) stream in seq order, so segments racing across stripe
// connections cannot reorder two rounds of the same key. `off`/`total`
// place the chunk inside the reassembled payload (chunk length =
// h.len - sizeof(SegHdr)).
#pragma pack(push, 1)
struct SegHdr {
  uint32_t seq;
  uint32_t idx;
  uint32_t nseg;
  uint32_t rsvd;
  uint64_t off;
  uint64_t total;
};
#pragma pack(pop)
static_assert(sizeof(SegHdr) == 32, "segment header layout");
// reassembly bounds: a stripe group never cuts a payload finer than
// this many segments, and a claimed total past the cap is a protocol
// error (bounds the lease a malformed header can force)
static constexpr uint32_t kMaxSegs = 256;
static constexpr uint64_t kMaxStripeTotal = 1ull << 31;

// Reply/control header factory: the trailing epoch/codec fields are
// always 0 on server replies and handshake messages, and spelling that
// with 8-field aggregate initializers tripped
// -Wmissing-field-initializers at every site once the build went
// -Wall -Wextra -Werror (native/build.py). Value-init zero-fills
// everything first, so a future MsgHeader field is 0 on every reply by
// construction instead of by 30 hand-updated braces.
static inline MsgHeader ReplyHeader(uint8_t op, uint8_t flags,
                                    uint16_t sender, uint32_t rid,
                                    uint64_t key = 0, uint32_t cmd = 0,
                                    uint32_t len = 0) {
  MsgHeader h{};
  h.magic = kMagic;
  h.op = op;
  h.flags = flags;
  h.sender = sender;
  h.rid = rid;
  h.key = key;
  h.cmd = cmd;
  h.len = len;
  return h;
}

// Inverse Cantor pairing (common.cc:98-101).
static inline void decode_cmd(uint32_t cmd, uint32_t* req, uint32_t* dtype) {
  uint64_t w = (uint64_t)((std::sqrt(8.0 * cmd + 1) - 1) / 2);
  uint64_t t = w * (w + 1) / 2;
  *dtype = (uint32_t)(cmd - t);
  *req = (uint32_t)(w - *dtype);
}

// (send_all was deleted here: every send rides the gathered
// send_msg_iov path, and -Wextra -Werror flagged the dead helper.)

static bool recv_all(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

static bool recv_all_deadline(int fd, void* buf, size_t len,
                              int timeout_ms) {
  // Bounded, alignment-preserving receive: MSG_PEEK until the FULL
  // message is buffered, then one consuming read. On expiry NOTHING has
  // been consumed — even a partially-arrived message stays queued — so
  // the TCP byte stream remains message-aligned for the caller's
  // fallback path (a late-completing message is drained whole by the
  // normal read loop).
  //
  // Waiting rides an EDGE-TRIGGERED epoll: level-triggered POLLIN would
  // return instantly while a PARTIAL message sits buffered (the old
  // 1ms-nanosleep spin burned a core per idle conn), whereas EPOLLET
  // only wakes when NEW bytes arrive. The initial EPOLL_CTL_ADD reports
  // the current readiness once, which just costs one extra peek.
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  int ep = ::epoll_create1(EPOLL_CLOEXEC);
  if (ep < 0) return false;
  struct epoll_event ev{};
  ev.events = EPOLLIN | EPOLLET;
  if (::epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev) != 0) {
    ::close(ep);
    return false;
  }
  bool full = false;
  for (;;) {
    ssize_t n = ::recv(fd, buf, len, MSG_PEEK | MSG_DONTWAIT);
    if (n == 0) break;  // peer closed
    if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR)
      break;
    if (n >= (ssize_t)len) {
      full = true;
      break;
    }
    auto now = std::chrono::steady_clock::now();
    if (now >= deadline) break;
    int remain = (int)std::chrono::duration_cast<std::chrono::milliseconds>(
        deadline - now).count();
    struct epoll_event out;
    ::epoll_wait(ep, &out, 1, remain > 0 ? remain : 1);
    // EINTR / spurious wake / timeout all re-peek and re-check the clock
  }
  ::close(ep);
  return full && recv_all(fd, buf, len);
}

// header+payload in one gathered send; sendmsg (not writev) so
// MSG_NOSIGNAL applies — a peer disconnect must return an error, not
// SIGPIPE the training process
static bool send_msg_iov(int fd, const MsgHeader& h, const void* payload) {
  iovec iov[2];
  iov[0].iov_base = (void*)&h;
  iov[0].iov_len = sizeof(h);
  iov[1].iov_base = (void*)payload;
  iov[1].iov_len = payload ? h.len : 0;
  size_t total = iov[0].iov_len + iov[1].iov_len;
  size_t sent = 0;
  int idx = 0;
  while (sent < total) {
    msghdr msg{};
    msg.msg_iov = &iov[idx];
    msg.msg_iovlen = 2 - idx;
    ssize_t w = ::sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (w <= 0) return false;
    sent += (size_t)w;
    while (idx < 2 && iov[idx].iov_len <= (size_t)w) {
      w -= iov[idx].iov_len;
      idx++;
    }
    if (idx < 2 && w > 0) {
      iov[idx].iov_base = (char*)iov[idx].iov_base + w;
      iov[idx].iov_len -= (size_t)w;
    }
  }
  return true;
}

// N-entry generalization of send_msg_iov's short-write walk: one
// gathered sendmsg per kernel acceptance, advancing through the iovec
// array until every byte left. The submission-ring flushers (server tx
// ring, client stripe fan-out) stage whole batches through this — a
// round's worth of replies/segments is one syscall, not N.
static bool send_iovs(int fd, iovec* iov, int cnt) {
  int idx = 0;
  while (idx < cnt) {
    msghdr msg{};
    msg.msg_iov = &iov[idx];
    int take = cnt - idx;
    if (take > IOV_MAX) take = IOV_MAX;
    msg.msg_iovlen = (size_t)take;
    ssize_t w = ::sendmsg(fd, &msg, MSG_NOSIGNAL);
    if (w <= 0) {
      if (w < 0 && errno == EINTR) continue;
      return false;
    }
    while (idx < cnt && iov[idx].iov_len <= (size_t)w) {
      w -= (ssize_t)iov[idx].iov_len;
      idx++;
    }
    if (idx < cnt && w > 0) {
      iov[idx].iov_base = (char*)iov[idx].iov_base + w;
      iov[idx].iov_len -= (size_t)w;
    }
  }
  return true;
}

// BYTEPS_WIRE_RING (default 1): batched-submission wire plane — the
// per-conn tx rings + the buffered rx batcher. 0 restores the legacy
// one-syscall-per-message path, the A/B lever for bench --phase
// stripe_ab and the parity tests.
static bool wire_ring_enabled() {
  static const bool v = [] {
    const char* e = ::getenv("BYTEPS_WIRE_RING");
    return !(e && (e[0] == '0' || e[0] == 'f' || e[0] == 'F'));
  }();
  return v;
}

// BYTEPS_WIRE_STRIPES (default 4): data connections per worker<->server
// pair. >1 dedicates conn 0 to control ops and stripes large pushes
// over the rest. Takes precedence over the legacy BYTEPS_CLIENT_CONNS.
static int wire_stripes() {
  static const int v = [] {
    long n = 0;
    if (const char* e = ::getenv("BYTEPS_WIRE_STRIPES")) n = std::atol(e);
    if (n <= 0) return 0;  // unset: caller falls back to CLIENT_CONNS
    if (n > 16) n = 16;
    return (int)n;
  }();
  return v;
}

// BYTEPS_STRIPE_CHUNK_BYTES (default 1 MB): striping granularity. A
// payload shorter than 2 chunks is never striped (the SegHdr + fan-out
// overhead would exceed the head-of-line win).
static uint32_t stripe_chunk_bytes() {
  static const uint32_t v = [] {
    long n = 1 << 20;
    if (const char* e = ::getenv("BYTEPS_STRIPE_CHUNK_BYTES"))
      n = std::atol(e);
    if (n < (4 << 10)) n = 4 << 10;
    if (n > (256 << 20)) n = 256 << 20;
    return (uint32_t)n;
  }();
  return v;
}

// Multi-MB partition buffers churn every round; glibc's default
// M_MMAP_THRESHOLD (128KB) services each one with mmap and returns it
// with munmap, so every allocation re-faults ~1K pages — on a small-core
// host that dominates the loopback hot path. Raising the threshold keeps
// partition-sized blocks on the heap free-lists where they recycle.
static const bool malloc_tuned = [] {
#ifdef M_MMAP_THRESHOLD
  ::mallopt(M_MMAP_THRESHOLD, 64 << 20);
  ::mallopt(M_TRIM_THRESHOLD, 128 << 20);
#endif
  return true;
}();

static void tune_socket(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // BYTEPS_SOCK_BUF_BYTES: SO_SNDBUF/SO_RCVBUF per data connection, so
  // a cross-host deployment can size the buffers to its bandwidth-delay
  // product instead of inheriting the kernel default (or the 8 MB
  // loopback tuning). Clamped to sane bounds; the kernel doubles the
  // requested value and may cap it at net.core.{r,w}mem_max.
  static const int buf = [] {
    long v = 8 << 20;  // 8 MB default for multi-MB partitions
    if (const char* e = ::getenv("BYTEPS_SOCK_BUF_BYTES")) {
      long req = std::atol(e);
      if (req > 0) v = req;
    }
    if (v < (64 << 10)) v = 64 << 10;
    if (v > (256 << 20)) v = 256 << 20;
    return (int)v;
  }();
  ::setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &buf, sizeof(buf));
  ::setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
}

// ------------------------------------------------------------------ //
// Colocated shm transport (IPC upgrade)
//
// The reference's ps-lite offers an IPC shortcut for workers colocated
// with a server (BYTEPS_ENABLE_IPC, docs/best-practice.md:32) so loopback
// traffic skips the NIC/TCP stack. Same idea here, TPU-host grounded: a
// client connecting to a loopback server offers a POSIX shm segment
// holding two byte-stream rings (client->server, server->client) via an
// in-band IPC_HELLO; on ACK both sides move ALL protocol traffic to the
// rings. A message then costs one user-space copy per side instead of
// two kernel crossings + TCP, which on a small-core PS host roughly
// doubles attainable push_pull GB/s. The TCP connection stays open,
// silent, as the liveness signal: either side's death surfaces as EOF,
// observed by the ring reader's bounded futex waits, so the failure
// detection and shutdown semantics of the TCP path carry over unchanged.
// Wakeups are shared futexes (no syscalls in the streaming steady state:
// wake only when the peer registered as waiting); non-Linux builds fall
// back to short timed waits through the same code path.

// Bumped (..DC -> ..DD) when the descriptor/arena tier landed: the
// segment layout changed, and an old-build server mapping a new-build
// client's segment (or vice versa) must decline the upgrade loudly and
// stay on TCP instead of misreading ring offsets.
static constexpr uint32_t kIpcMagic = 0xB17E51DD;

// -- true zero-copy large-message tier --------------------------------
//
// The byte-stream rings move SMALL messages well, but a multi-MB
// partition costs a full memcpy into the ring and a full memcpy out —
// plus chunked futex ping-pong whenever the payload approaches the
// ring size. For messages >= kOobMinBytes the channel instead carries
// only a DESCRIPTOR: the payload is written once into a per-direction
// shared ARENA region of the same segment, the ring gets the header
// (flags |= kFlagOob) followed by an 8-byte IpcDesc naming the arena
// offset, and the consumer processes the bytes IN PLACE — the server
// folds straight from the arena (sum_into src = shm), the client
// copies an aggregate reply from the arena into the caller's buffer
// exactly once. The consumer releases the block when done; blocks are
// reclaimed in ring order by the producer (out-of-order completions
// park behind a done flag per block).
//
// Version-fencing: a block is immutable from descriptor-publish (ring
// head release-store) until the consumer's release; a wire RETRY never
// reuses a block — each attempt allocates fresh and carries the same
// PR-6 replay epoch, so the server's last_round dedup decides folding
// exactly as on TCP and a stale descriptor can never alias a newer
// round's bytes.

#pragma pack(push, 1)
struct IpcDesc {
  uint64_t payload_off;  // offset of the payload inside the arena
};
#pragma pack(pop)

static_assert(sizeof(IpcDesc) == 8, "descriptor layout");

static constexpr uint32_t kOobMinBytes = 64 << 10;

// Arena block header, 16 bytes before each payload. `state` flips
// 0 -> 1 (done) on the consumer side; the producer reclaims contiguous
// done blocks from the tail. Wrap fillers are born done.
struct ABlk {
  std::atomic<uint32_t> state;
  uint32_t reserved;
  uint64_t size;  // whole block incl. this header, 64-byte aligned
};

static_assert(sizeof(ABlk) == 16, "arena block header");

#if defined(__linux__)
static void futex_wait_u32(std::atomic<uint32_t>* addr, uint32_t expect,
                           long timeout_ns) {
  timespec ts{timeout_ns / 1000000000L, timeout_ns % 1000000000L};
  ::syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAIT,
            expect, &ts, nullptr, 0);
}
static void futex_wake_u32(std::atomic<uint32_t>* addr) {
  ::syscall(SYS_futex, reinterpret_cast<uint32_t*>(addr), FUTEX_WAKE,
            INT_MAX, nullptr, nullptr, 0);
}
#else
static void futex_wait_u32(std::atomic<uint32_t>*, uint32_t, long t_ns) {
  ::usleep((useconds_t)(t_ns / 1000 > 500 ? 500 : t_ns / 1000));
}
static void futex_wake_u32(std::atomic<uint32_t>*) {}
#endif

// One direction of the channel: an SPSC byte-stream ring (the writer side
// is serialized by the connection's write mutex). head/tail are monotonic
// byte positions; futex words signal "data arrived" / "space freed".
struct alignas(64) IpcRing {
  std::atomic<uint64_t> head;
  char pad0[56];
  std::atomic<uint64_t> tail;
  char pad1[56];
  std::atomic<uint32_t> data_seq;
  std::atomic<uint32_t> data_waiters;
  std::atomic<uint32_t> space_seq;
  std::atomic<uint32_t> space_waiters;
  char pad2[48];
};

// One direction's arena allocator state (head/tail are monotonic byte
// positions like the ring's; space_seq/waiters signal block releases).
struct alignas(64) ArenaHdr {
  std::atomic<uint64_t> head;
  char pad0[56];
  std::atomic<uint64_t> tail;
  char pad1[56];
  std::atomic<uint32_t> space_seq;
  std::atomic<uint32_t> space_waiters;
  char pad2[56];
};

struct IpcShm {
  uint32_t magic;
  uint32_t ring_size;
  uint64_t arena_size;  // per direction; 0 = ring-only (legacy shape)
  IpcRing c2s;
  IpcRing s2c;
  ArenaHdr c2s_arena;
  ArenaHdr s2c_arena;
  // followed by: uint8_t c2s_data[ring_size], s2c_data[ring_size],
  //              c2s_arena_data[arena_size], s2c_arena_data[arena_size]
};

static_assert(std::atomic<uint64_t>::is_always_lock_free &&
              std::atomic<uint32_t>::is_always_lock_free,
              "shm ring atomics must be address-free");

// A consumer-side reference to an out-of-band payload: points into the
// receiver's rx arena; released via IpcChan::oob_release when the
// bytes have been folded/copied out.
struct OobRef {
  const uint8_t* ptr = nullptr;
  uint64_t off = 0;
  uint32_t len = 0;
  // echo: `ptr`/`off` name a block in the receiver's OWN tx arena (its
  // pushed payload, handed back); release goes through
  // oob_echo_release instead of oob_release.
  bool echo = false;
};

class IpcChan {
 public:
  // Takes ownership of the mapping (munmaps on destruction), NOT of fd.
  IpcChan(void* base, size_t map_len, int fd, bool is_server)
      : base_(base), map_len_(map_len), fd_(fd) {
    IpcShm* s = reinterpret_cast<IpcShm*>(base);
    size_ = s->ring_size;
    arena_size_ = s->arena_size;
    uint8_t* d0 = reinterpret_cast<uint8_t*>(base) + sizeof(IpcShm);
    uint8_t* a0 = d0 + 2 * size_;
    if (is_server) {
      rx_ = &s->c2s; rx_data_ = d0;
      tx_ = &s->s2c; tx_data_ = d0 + size_;
      rx_ah_ = &s->c2s_arena; rx_arena_ = a0;
      tx_ah_ = &s->s2c_arena; tx_arena_ = a0 + arena_size_;
    } else {
      tx_ = &s->c2s; tx_data_ = d0;
      rx_ = &s->s2c; rx_data_ = d0 + size_;
      tx_ah_ = &s->c2s_arena; tx_arena_ = a0;
      rx_ah_ = &s->s2c_arena; rx_arena_ = a0 + arena_size_;
    }
  }
  ~IpcChan() {
    if (base_) ::munmap(base_, map_len_);
  }

  // Writer: serialized externally (connection write mutex) -> header and
  // payload (or descriptor) land contiguously in the byte stream. Large
  // payloads take the out-of-band arena path: ONE copy into the shared
  // arena, a descriptor on the ring, the consumer reads in place.
  bool send_msg(const MsgHeader& h, const void* payload) {
    if (payload && h.len >= kOobMinBytes && arena_size_) {
      uint64_t off;
      if (arena_alloc(h.len, &off)) {
        std::memcpy(tx_arena_ + off, payload, h.len);
        MsgHeader oh = h;
        oh.flags = (uint8_t)(oh.flags | kFlagOob);
        IpcDesc d{off};
        if (!send(&oh, sizeof(oh))) return false;
        oob_sent_.fetch_add(1, std::memory_order_relaxed);
        return send(&d, sizeof(d));
      }
      if (broken_.load()) return false;
      // payload larger than the arena can serve: stream via the ring
    }
    if (!send(&h, sizeof(h))) return false;
    return h.len == 0 || send(payload, h.len);
  }

  // Reader-side message entry: receive the header and, for an
  // out-of-band message, the descriptor — returning a validated arena
  // reference with the transport-internal flag bit cleared, so
  // everything above this layer sees the same header it would on TCP.
  bool recv_msg_begin(MsgHeader* h, OobRef* oob) {
    oob->ptr = nullptr;
    oob->echo = false;
    if (!recv(h, sizeof(*h))) return false;
    if (!(h->flags & (kFlagOob | kFlagOobEcho))) return true;
    bool echo = (h->flags & kFlagOobEcho) != 0;
    IpcDesc d;
    if (!recv(&d, sizeof(d))) return false;
    h->flags = (uint8_t)(h->flags & ~(kFlagOob | kFlagOobEcho));
    if (d.payload_off < sizeof(ABlk) || d.payload_off >= arena_size_ ||
        d.payload_off + (uint64_t)h->len > arena_size_) {
      // the >= arena_size_ test also kills the u64 wrap: a huge
      // payload_off plus a u32 len could otherwise sum small and pass
      // corrupt descriptor: fail the channel (same verdict as a torn
      // TCP stream) rather than read out of the mapping
      mark_broken();
      return false;
    }
    oob->ptr = (echo ? tx_arena_ : rx_arena_) + d.payload_off;
    oob->off = d.payload_off;
    oob->len = h->len;
    oob->echo = echo;
    oob_recvd_.fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  // Echo reply: header + descriptor naming a block in the PEER'S tx
  // arena (the bytes it pushed) — no payload copy at all. The peer
  // consumes and releases its own block.
  bool send_msg_echo(const MsgHeader& h, uint64_t peer_off) {
    MsgHeader oh = h;
    oh.flags = (uint8_t)(oh.flags | kFlagOobEcho);
    IpcDesc d{peer_off};
    if (!send(&oh, sizeof(oh))) return false;
    return send(&d, sizeof(d));
  }

  // Release one of OUR OWN tx-arena blocks after an echo reply handed
  // it back (the local sender parked in arena_alloc is the waiter).
  void oob_echo_release(uint64_t payload_off) {
    ABlk* b = reinterpret_cast<ABlk*>(
        tx_arena_ + payload_off - sizeof(ABlk));
    b->state.store(1, std::memory_order_release);
    tx_ah_->space_seq.fetch_add(1, std::memory_order_release);
    if (tx_ah_->space_waiters.load() != 0)
      futex_wake_u32(&tx_ah_->space_seq);
  }

  // Consumer release of an out-of-band block: after this the producer
  // may reclaim and overwrite the bytes — callers must be DONE with
  // OobRef::ptr.
  void oob_release(uint64_t payload_off) {
    ABlk* b = reinterpret_cast<ABlk*>(
        rx_arena_ + payload_off - sizeof(ABlk));
    b->state.store(1, std::memory_order_release);
    rx_ah_->space_seq.fetch_add(1, std::memory_order_release);
    if (rx_ah_->space_waiters.load() != 0)
      futex_wake_u32(&rx_ah_->space_seq);
  }

  uint64_t oob_sent() const {
    return oob_sent_.load(std::memory_order_relaxed);
  }
  uint64_t oob_recvd() const {
    return oob_recvd_.load(std::memory_order_relaxed);
  }

  bool send(const void* p, size_t n) {
    const uint8_t* src = static_cast<const uint8_t*>(p);
    while (n) {
      // fail fast once the channel is dead (peer EOF seen by the recv
      // loop, or teardown) — otherwise a send into a ring nobody reads
      // "succeeds" and the caller wedges until its request timeout,
      // where the TCP path would have errored in milliseconds
      if (broken_.load()) return false;
      uint64_t head = tx_->head.load(std::memory_order_relaxed);
      uint64_t tail = tx_->tail.load(std::memory_order_acquire);
      uint64_t free = size_ - (head - tail);
      if (free == 0) {
        if (!wait(tx_, &tx_->space_seq, &tx_->space_waiters,
                  [&] { return size_ - (tx_->head.load(std::memory_order_relaxed) -
                                        tx_->tail.load(std::memory_order_acquire)) != 0; },
                  /*check_peer=*/false))
          return false;
        continue;
      }
      size_t chunk = n < free ? n : (size_t)free;
      size_t off = (size_t)(head % size_);
      size_t first = chunk < size_ - off ? chunk : size_ - off;
      std::memcpy(tx_data_ + off, src, first);
      std::memcpy(tx_data_, src + first, chunk - first);
      tx_->head.store(head + chunk, std::memory_order_release);
      tx_->data_seq.fetch_add(1, std::memory_order_release);
      if (tx_->data_waiters.load() != 0) futex_wake_u32(&tx_->data_seq);
      src += chunk;
      n -= chunk;
    }
    return true;
  }

  // Reader: single thread per channel (the connection's recv loop).
  bool recv(void* p, size_t n) {
    uint8_t* dst = static_cast<uint8_t*>(p);
    while (n) {
      uint64_t head = rx_->head.load(std::memory_order_acquire);
      uint64_t tail = rx_->tail.load(std::memory_order_relaxed);
      uint64_t avail = head - tail;
      if (avail == 0) {
        if (!wait(rx_, &rx_->data_seq, &rx_->data_waiters,
                  [&] { return rx_->head.load(std::memory_order_acquire) !=
                               rx_->tail.load(std::memory_order_relaxed); },
                  /*check_peer=*/true))
          return false;
        continue;
      }
      size_t chunk = n < avail ? n : (size_t)avail;
      size_t off = (size_t)(tail % size_);
      size_t first = chunk < size_ - off ? chunk : size_ - off;
      std::memcpy(dst, rx_data_ + off, first);
      std::memcpy(dst + first, rx_data_, chunk - first);
      rx_->tail.store(tail + chunk, std::memory_order_release);
      rx_->space_seq.fetch_add(1, std::memory_order_release);
      if (rx_->space_waiters.load() != 0) futex_wake_u32(&rx_->space_seq);
      dst += chunk;
      n -= chunk;
    }
    return true;
  }

  // Unblocks every waiter on both rings and both arenas (local threads
  // AND the peer — the peer then notices EOF on its fd). Used on
  // Close/teardown.
  void mark_broken() {
    broken_.store(true);
    for (IpcRing* r : {tx_, rx_}) {
      r->data_seq.fetch_add(1);
      futex_wake_u32(&r->data_seq);
      r->space_seq.fetch_add(1);
      futex_wake_u32(&r->space_seq);
    }
    if (arena_size_) {
      for (ArenaHdr* a : {tx_ah_, rx_ah_}) {
        a->space_seq.fetch_add(1);
        futex_wake_u32(&a->space_seq);
      }
    }
  }
  bool broken() const { return broken_.load(); }

 private:
  // Producer-side arena allocation (serialized by the connection write
  // mutex, like the ring writer). Reclaims contiguous DONE blocks from
  // the tail, wrap-fills the end of the region so a block never
  // straddles the wrap, and parks on the arena's space futex when the
  // consumer is behind. Returns false for payloads the arena can never
  // hold (caller streams via the ring) or once the channel is broken.
  bool arena_alloc(uint32_t len, uint64_t* payload_off) {
    uint64_t need = (sizeof(ABlk) + (uint64_t)len + 63) & ~(uint64_t)63;
    if (need > arena_size_ / 2) return false;
    for (;;) {
      if (broken_.load()) return false;
      uint64_t head = tx_ah_->head.load(std::memory_order_relaxed);
      uint64_t tail = tx_ah_->tail.load(std::memory_order_relaxed);
      while (tail < head) {
        ABlk* b = reinterpret_cast<ABlk*>(
            tx_arena_ + (size_t)(tail % arena_size_));
        if (b->state.load(std::memory_order_acquire) != 1) break;
        tail += b->size;
      }
      tx_ah_->tail.store(tail, std::memory_order_relaxed);
      uint64_t free_total = arena_size_ - (head - tail);
      size_t off = (size_t)(head % arena_size_);
      uint64_t contig = arena_size_ - off;
      if (contig < need) {
        if (free_total >= contig + need) {
          ABlk* f = reinterpret_cast<ABlk*>(tx_arena_ + off);
          f->size = contig;
          f->state.store(1, std::memory_order_relaxed);  // born done
          tx_ah_->head.store(head + contig,
                             std::memory_order_relaxed);
          continue;
        }
      } else if (free_total >= need) {
        ABlk* b = reinterpret_cast<ABlk*>(tx_arena_ + off);
        b->size = need;
        b->reserved = 0;
        b->state.store(0, std::memory_order_relaxed);
        tx_ah_->head.store(head + need, std::memory_order_relaxed);
        *payload_off = off + sizeof(ABlk);
        return true;
      }
      // arena full: wait for the consumer to release blocks (bounded
      // futex waits through the same helper as the rings, with peer
      // liveness checks so a dead consumer fails the send). The
      // predicate mirrors the admission condition above EXACTLY —
      // including the wrap filler's extra `contig` bytes — so a wake
      // that frees less than admission needs parks again instead of
      // spinning the re-check loop.
      uint64_t admit = (contig < need) ? contig + need : need;
      if (!wait(nullptr, &tx_ah_->space_seq, &tx_ah_->space_waiters,
                [&] {
                  uint64_t t = tx_ah_->tail.load(
                      std::memory_order_relaxed);
                  while (t < head) {
                    ABlk* b = reinterpret_cast<ABlk*>(
                        tx_arena_ + (size_t)(t % arena_size_));
                    if (b->state.load(std::memory_order_acquire) != 1)
                      break;
                    t += b->size;
                  }
                  return arena_size_ - (head - t) >= admit;
                },
                /*check_peer=*/true))
        return false;
    }
  }
  template <typename Pred>
  bool wait(IpcRing*, std::atomic<uint32_t>* seq,
            std::atomic<uint32_t>* waiters, Pred ready, bool check_peer) {
    for (int i = 0; i < 32; ++i) {  // brief pre-futex window
      if (ready()) return true;
      if (broken_.load()) return false;
      ::sched_yield();
    }
    while (true) {
      if (ready()) return true;
      if (broken_.load()) return false;
      if (check_peer && !peer_alive()) {
        mark_broken();
        return false;
      }
      waiters->fetch_add(1);
      uint32_t s = seq->load();
      if (ready() || broken_.load()) {
        waiters->fetch_sub(1);
        continue;
      }
      futex_wait_u32(seq, s, 5'000'000);  // 5ms: liveness granularity
      waiters->fetch_sub(1);
    }
  }

  // After the upgrade the TCP fd is silent; readable-with-EOF or HUP
  // means the peer died (or closed cleanly without SHUTDOWN — elastic
  // suspend), which the TCP path would have seen as recv_all failing.
  bool peer_alive() {
    pollfd pfd{fd_, POLLIN, 0};
    if (::poll(&pfd, 1, 0) <= 0) return !(pfd.revents & (POLLERR | POLLNVAL));
    if (pfd.revents & (POLLHUP | POLLERR | POLLNVAL)) return false;
    if (pfd.revents & POLLIN) {
      char junk[64];
      ssize_t r = ::recv(fd_, junk, sizeof(junk), MSG_DONTWAIT);
      if (r == 0) return false;  // EOF
    }
    return true;
  }

  void* base_;
  size_t map_len_;
  int fd_;
  uint64_t size_;
  uint64_t arena_size_ = 0;
  IpcRing* tx_;
  IpcRing* rx_;
  uint8_t* tx_data_;
  uint8_t* rx_data_;
  ArenaHdr* tx_ah_ = nullptr;
  ArenaHdr* rx_ah_ = nullptr;
  uint8_t* tx_arena_ = nullptr;
  uint8_t* rx_arena_ = nullptr;
  std::atomic<uint64_t> oob_sent_{0};
  std::atomic<uint64_t> oob_recvd_{0};
  std::atomic<bool> broken_{false};
};

static bool ipc_enabled() {
  // Default ON — a deliberate divergence from the reference's opt-in
  // BYTEPS_ENABLE_IPC (documented in docs/env.md): the loopback shm
  // upgrade is negotiated in-band and strictly faster when colocated.
  // Explicit disable accepts the same falsy spellings as the Python
  // side's parse_bool_kwarg plus no/off, case-insensitively.
  const char* e = ::getenv("BYTEPS_ENABLE_IPC");
  if (!e || !*e) return true;
  std::string v(e);
  for (char& c : v) c = (char)std::tolower((unsigned char)c);
  return !(v == "0" || v == "f" || v == "false" || v == "n" || v == "no" ||
           v == "off");
}

static size_t ipc_ring_bytes() {
  if (const char* e = ::getenv("BYTEPS_IPC_RING_BYTES")) {
    long v = std::atol(e);
    if (v >= (64 << 10)) return (size_t)v;
  }
  return 8 << 20;
}

// Per-direction shared arena for the zero-copy large-message tier.
// 0 disables the tier (ring-only, the pre-descriptor behavior); the
// minimum keeps at least two kOobMinBytes blocks in flight.
static size_t ipc_arena_bytes() {
  if (const char* e = ::getenv("BYTEPS_IPC_ARENA_BYTES")) {
    long v = std::atol(e);
    if (v <= 0) return 0;
    if (v < (long)(2 * (kOobMinBytes + 64))) v = 2 * (kOobMinBytes + 64);
    // arena_alloc's block offsets stay 64-aligned only when the whole
    // region is a multiple of 64 (head % arena_size at the wrap) — and
    // the wrap filler needs >= sizeof(ABlk) contiguous bytes; round up
    // so a hand-set odd size can't write the filler past the region
    return (size_t)((v + 63) & ~63L);
  }
  return 64 << 20;
}

// 16-bit float conversions for summation. The reference's fp16 path
// converts to f32, adds, and rounds back per element (AVX F16C
// vcvtph2ps/vcvtps2ph, cpu_reducer.cc:59-120, cpu_reducer.h:83-179);
// these scalar versions implement the same round-to-nearest-even
// semantics portably so worker (numpy/JAX) and server agree bit-for-bit.
static inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ffu;
  uint32_t f;
  if (exp == 0) {
    if (man == 0) {
      f = sign;  // +-0
    } else {     // subnormal: renormalize
      exp = 113;  // 127 - 15 + 1
      while ((man & 0x400u) == 0) { man <<= 1; exp--; }
      f = sign | (exp << 23) | ((man & 0x3ffu) << 13);
    }
  } else if (exp == 0x1f) {
    f = sign | 0x7f800000u | (man << 13);  // inf / nan
  } else {
    f = sign | ((exp + 112) << 23) | (man << 13);
  }
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t float_to_half(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  uint32_t sign = (f >> 16) & 0x8000u;
  uint32_t fexp = (f >> 23) & 0xffu;
  uint32_t man = f & 0x7fffffu;
  if (fexp == 0xff)  // inf / nan
    return (uint16_t)(sign | 0x7c00u | (man ? 0x200u : 0));
  int32_t exp = (int32_t)fexp - 127 + 15;
  if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00u);  // overflow -> inf
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;  // underflows to zero
    man |= 0x800000u;                      // half subnormal, RNE
    uint32_t shift = (uint32_t)(14 - exp);
    uint32_t hman = man >> shift;
    uint32_t rem = man & ((1u << shift) - 1);
    uint32_t halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (hman & 1))) hman++;
    return (uint16_t)(sign | hman);
  }
  uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
  uint32_t rem = man & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (h & 1))) h++;  // RNE; carries
  return h;  // into exp correctly (mantissa overflow increments exponent)
}

static inline float bf16_to_float(uint16_t h) {
  uint32_t f = (uint32_t)h << 16;
  float out;
  std::memcpy(&out, &f, 4);
  return out;
}

static inline uint16_t float_to_bf16(float x) {
  uint32_t f;
  std::memcpy(&f, &x, 4);
  if ((f & 0x7fffffffu) > 0x7f800000u)      // nan: keep quiet, don't round
    return (uint16_t)((f >> 16) | 0x40u);
  f += 0x7fffu + ((f >> 16) & 1);           // round-to-nearest-even
  return (uint16_t)(f >> 16);
}

// ------------------------------------------------------------------ //
// SIMD fold: the server's accumulate loop, runtime-dispatched
//
// The aggregation hot loop (dst += src over fp32/bf16) is the single
// densest consumer of server CPU once the per-message copies are gone.
// Three tiers — scalar / AVX2 / AVX-512 — compiled with per-function
// target attributes so ONE binary carries all of them and picks at
// runtime (__builtin_cpu_supports), overridable per Server with
// BYTEPS_SIMD (auto | avx512 | avx2 | scalar/0/off; docs/env.md). The
// reference gets the same effect from hand-written AVX in
// cpu_reducer.cc:59-120.
//
// Numerics contract: BITWISE identity with the scalar loops. fp32 is
// an elementwise add either way. bf16 widens to f32 (<<16), adds, and
// narrows with EXACTLY float_to_bf16's round-to-nearest-even and NaN
// quieting — the widen-fold-narrow shape, vectorized as integer ops on
// the float bit patterns, so the SIMD-vs-scalar parity suite
// (tests/test_native_plane.py) can assert equality bit for bit.
// BYTEPS_SCALAR_ONLY (build.py BYTEPS_BUILD_SCALAR=1, the CI knob)
// compiles the scalar tier alone.
// ------------------------------------------------------------------ //

enum SimdTier : int { kSimdScalar = 0, kSimdAvx2 = 2, kSimdAvx512 = 3 };

static void fold_f32_scalar(float* d, const float* s, size_t n) {
  for (size_t i = 0; i < n; ++i) d[i] += s[i];
}

static void fold_bf16_scalar(uint16_t* d, const uint16_t* s, size_t n) {
  for (size_t i = 0; i < n; ++i)
    d[i] = float_to_bf16(bf16_to_float(d[i]) + bf16_to_float(s[i]));
}

#if defined(__x86_64__) && !defined(BYTEPS_SCALAR_ONLY) && \
    defined(__GNUC__)
#define BYTEPS_HAVE_SIMD_FOLD 1

__attribute__((target("avx2"))) static void fold_f32_avx2(
    float* d, const float* s, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8)
    _mm256_storeu_ps(d + i, _mm256_add_ps(_mm256_loadu_ps(d + i),
                                          _mm256_loadu_ps(s + i)));
  for (; i < n; ++i) d[i] += s[i];
}

// Narrow 8 f32 sums (bit patterns in `f`) to bf16 in the low 16 bits
// of each lane, replicating float_to_bf16 exactly: NaN (abs >
// 0x7f800000) -> (f >> 16) | 0x40 un-rounded; else f + 0x7fff +
// ((f >> 16) & 1) then >> 16 (the carry into the exponent is the same
// 32-bit wrap as the scalar's uint32_t add).
__attribute__((target("avx2"))) static inline __m256i bf16_narrow8_avx2(
    __m256i f) {
  const __m256i abs_mask = _mm256_set1_epi32(0x7FFFFFFF);
  const __m256i inf = _mm256_set1_epi32(0x7F800000);
  const __m256i quiet = _mm256_set1_epi32(0x40);
  const __m256i rnd = _mm256_set1_epi32(0x7FFF);
  const __m256i one = _mm256_set1_epi32(1);
  __m256i hi = _mm256_srli_epi32(f, 16);
  __m256i is_nan = _mm256_cmpgt_epi32(_mm256_and_si256(f, abs_mask), inf);
  __m256i nan_res = _mm256_or_si256(hi, quiet);
  __m256i rounded = _mm256_srli_epi32(
      _mm256_add_epi32(
          f, _mm256_add_epi32(rnd, _mm256_and_si256(hi, one))),
      16);
  return _mm256_blendv_epi8(rounded, nan_res, is_nan);
}

__attribute__((target("avx2"))) static void fold_bf16_avx2(
    uint16_t* d, const uint16_t* s, size_t n) {
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    // widen 16 bf16 -> 2x8 f32 bit patterns (<<16 == bf16_to_float)
    __m256i d32lo = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128((const __m128i*)(d + i))), 16);
    __m256i d32hi = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128((const __m128i*)(d + i + 8))), 16);
    __m256i s32lo = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128((const __m128i*)(s + i))), 16);
    __m256i s32hi = _mm256_slli_epi32(
        _mm256_cvtepu16_epi32(
            _mm_loadu_si128((const __m128i*)(s + i + 8))), 16);
    __m256i flo = _mm256_castps_si256(
        _mm256_add_ps(_mm256_castsi256_ps(d32lo),
                      _mm256_castsi256_ps(s32lo)));
    __m256i fhi = _mm256_castps_si256(
        _mm256_add_ps(_mm256_castsi256_ps(d32hi),
                      _mm256_castsi256_ps(s32hi)));
    // pack 2x8 lanes (values <= 0xFFFF, so packus never saturates);
    // packus interleaves 128-bit lanes -> permute restores order
    __m256i packed = _mm256_packus_epi32(bf16_narrow8_avx2(flo),
                                         bf16_narrow8_avx2(fhi));
    packed = _mm256_permute4x64_epi64(packed, 0xD8);
    _mm256_storeu_si256((__m256i*)(d + i), packed);
  }
  fold_bf16_scalar(d + i, s + i, n - i);
}

__attribute__((target("avx512f"))) static void fold_f32_avx512(
    float* d, const float* s, size_t n) {
  size_t i = 0;
  for (; i + 16 <= n; i += 16)
    _mm512_storeu_ps(d + i, _mm512_add_ps(_mm512_loadu_ps(d + i),
                                          _mm512_loadu_ps(s + i)));
  for (; i < n; ++i) d[i] += s[i];
}

__attribute__((target("avx512f,avx512bw"))) static void fold_bf16_avx512(
    uint16_t* d, const uint16_t* s, size_t n) {
  const __m512i abs_mask = _mm512_set1_epi32(0x7FFFFFFF);
  const __m512i inf = _mm512_set1_epi32(0x7F800000);
  const __m512i quiet = _mm512_set1_epi32(0x40);
  const __m512i rnd = _mm512_set1_epi32(0x7FFF);
  const __m512i one = _mm512_set1_epi32(1);
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m512i d32 = _mm512_slli_epi32(
        _mm512_cvtepu16_epi32(
            _mm256_loadu_si256((const __m256i*)(d + i))), 16);
    __m512i s32 = _mm512_slli_epi32(
        _mm512_cvtepu16_epi32(
            _mm256_loadu_si256((const __m256i*)(s + i))), 16);
    __m512i f = _mm512_castps_si512(
        _mm512_add_ps(_mm512_castsi512_ps(d32),
                      _mm512_castsi512_ps(s32)));
    __m512i hi = _mm512_srli_epi32(f, 16);
    __mmask16 is_nan = _mm512_cmpgt_epi32_mask(
        _mm512_and_si512(f, abs_mask), inf);
    __m512i rounded = _mm512_srli_epi32(
        _mm512_add_epi32(
            f, _mm512_add_epi32(rnd, _mm512_and_si512(hi, one))),
        16);
    __m512i res = _mm512_mask_mov_epi32(rounded, is_nan,
                                        _mm512_or_si512(hi, quiet));
    _mm256_storeu_si256((__m256i*)(d + i),
                        _mm512_cvtepi32_epi16(res));
  }
  fold_bf16_scalar(d + i, s + i, n - i);
}
#endif  // x86_64 && !BYTEPS_SCALAR_ONLY

// ------------------------------------------------------------------ //
// in-fold training-health statistics (BYTEPS_HEALTH, docs/
// observability.md "Training-health plane")
//
// Per-key per-round sum-of-squares, abs-max and nonfinite counts of
// the POST-AGGREGATION value, computed either fused into the round's
// LAST f32 fold (the dense multi-worker hot path: the same add
// instructions write the same bits — bitwise-neutral by construction —
// while the freshly-produced lanes feed the stat accumulators) or by a
// one-pass read-only scan of the published aggregate (adopt-first-push
// single-worker rounds, compressed/rowsparse publishes, bf16/f64).
// Contract: sumsq/absmax accumulate over FINITE elements only (summed
// in double); NaN/Inf elements are COUNTED, never folded into the
// norms — a single poisoned lane must read as "1 nonfinite", not as a
// NaN that erases the whole statistic. Off (the default) the pass does
// not run at all: zero marginal cost.
// ------------------------------------------------------------------ //

struct HStat {
  double sumsq = 0.0;     // over finite elements
  double absmax = 0.0;    // over finite elements
  uint64_t nonfinite = 0;
  uint64_t elems = 0;
  uint64_t round = 0;     // completed_rounds stamped at publish
};

static inline void stat_f32_one(float v, HStat* h) {
  uint32_t bits;
  std::memcpy(&bits, &v, 4);
  uint32_t abs = bits & 0x7FFFFFFFu;
  if (abs >= 0x7F800000u) {  // exponent all-ones: NaN or +-Inf
    h->nonfinite++;
    return;
  }
  double dv = (double)v;
  h->sumsq += dv * dv;
  double av = dv < 0 ? -dv : dv;
  if (av > h->absmax) h->absmax = av;
}

static void fold_f32_stat_scalar(float* d, const float* s, size_t n,
                                 HStat* h) {
  for (size_t i = 0; i < n; ++i) {
    d[i] += s[i];  // identical arithmetic to fold_f32_scalar: bitwise
    stat_f32_one(d[i], h);
  }
}

static void stat_scan_f32_scalar(const float* p, size_t n, HStat* h) {
  for (size_t i = 0; i < n; ++i) stat_f32_one(p[i], h);
}

#ifdef BYTEPS_HAVE_SIMD_FOLD
// Shared per-8-lane stat block: abs via sign-bit mask, finite lanes =
// (abs < inf) as a signed compare (both operands <= 0x7F800000 range),
// nonfinite lanes zeroed before the max/square so the accumulators
// stay finite and meaningful. Squares accumulate in 2x4 f64 lanes.
__attribute__((target("avx2"))) static inline void stat8_avx2(
    __m256 r, __m256* vmax, __m256d* acc0, __m256d* acc1,
    uint64_t* nonfin) {
  const __m256i abs_mask = _mm256_set1_epi32(0x7FFFFFFF);
  const __m256i inf = _mm256_set1_epi32(0x7F800000);
  __m256i abs = _mm256_and_si256(_mm256_castps_si256(r), abs_mask);
  __m256i isfin = _mm256_cmpgt_epi32(inf, abs);
  *nonfin += 8 - (uint64_t)__builtin_popcount(
      (unsigned)_mm256_movemask_ps(_mm256_castsi256_ps(isfin)));
  __m256 rf = _mm256_and_ps(_mm256_castsi256_ps(abs),
                            _mm256_castsi256_ps(isfin));
  *vmax = _mm256_max_ps(*vmax, rf);
  __m256d lo = _mm256_cvtps_pd(_mm256_castps256_ps128(rf));
  __m256d hi = _mm256_cvtps_pd(_mm256_extractf128_ps(rf, 1));
  *acc0 = _mm256_add_pd(*acc0, _mm256_mul_pd(lo, lo));
  *acc1 = _mm256_add_pd(*acc1, _mm256_mul_pd(hi, hi));
}

__attribute__((target("avx2"))) static inline void stat8_avx2_flush(
    __m256 vmax, __m256d acc0, __m256d acc1, uint64_t nonfin,
    HStat* h) {
  double tmp[4];
  _mm256_storeu_pd(tmp, _mm256_add_pd(acc0, acc1));
  h->sumsq += tmp[0] + tmp[1] + tmp[2] + tmp[3];
  float fm[8];
  _mm256_storeu_ps(fm, vmax);
  double m = h->absmax;
  for (int k = 0; k < 8; ++k)
    if ((double)fm[k] > m) m = (double)fm[k];
  h->absmax = m;
  h->nonfinite += nonfin;
}

__attribute__((target("avx2"))) static void fold_f32_stat_avx2(
    float* d, const float* s, size_t n, HStat* h) {
  __m256 vmax = _mm256_setzero_ps();
  __m256d acc0 = _mm256_setzero_pd(), acc1 = _mm256_setzero_pd();
  uint64_t nonfin = 0;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    // the exact fold_f32_avx2 add — the stored bits cannot differ
    __m256 r = _mm256_add_ps(_mm256_loadu_ps(d + i),
                             _mm256_loadu_ps(s + i));
    _mm256_storeu_ps(d + i, r);
    stat8_avx2(r, &vmax, &acc0, &acc1, &nonfin);
  }
  stat8_avx2_flush(vmax, acc0, acc1, nonfin, h);
  for (; i < n; ++i) {
    d[i] += s[i];
    stat_f32_one(d[i], h);
  }
}

__attribute__((target("avx2"))) static void stat_scan_f32_avx2(
    const float* p, size_t n, HStat* h) {
  __m256 vmax = _mm256_setzero_ps();
  __m256d acc0 = _mm256_setzero_pd(), acc1 = _mm256_setzero_pd();
  uint64_t nonfin = 0;
  size_t i = 0;
  for (; i + 8 <= n; i += 8)
    stat8_avx2(_mm256_loadu_ps(p + i), &vmax, &acc0, &acc1, &nonfin);
  stat8_avx2_flush(vmax, acc0, acc1, nonfin, h);
  for (; i < n; ++i) stat_f32_one(p[i], h);
}

__attribute__((target("avx512f"))) static void fold_f32_stat_avx512(
    float* d, const float* s, size_t n, HStat* h) {
  const __m512i abs_mask = _mm512_set1_epi32(0x7FFFFFFF);
  const __m512i inf = _mm512_set1_epi32(0x7F800000);
  __m512 vmax = _mm512_setzero_ps();
  __m512d acc0 = _mm512_setzero_pd(), acc1 = _mm512_setzero_pd();
  uint64_t nonfin = 0;
  size_t i = 0;
  for (; i + 16 <= n; i += 16) {
    __m512 r = _mm512_add_ps(_mm512_loadu_ps(d + i),
                             _mm512_loadu_ps(s + i));
    _mm512_storeu_ps(d + i, r);
    __m512i abs = _mm512_and_si512(_mm512_castps_si512(r), abs_mask);
    __mmask16 fin = _mm512_cmplt_epi32_mask(abs, inf);
    nonfin += 16 - (uint64_t)__builtin_popcount((unsigned)fin);
    __m512 rf = _mm512_maskz_mov_ps(fin, _mm512_castsi512_ps(abs));
    vmax = _mm512_max_ps(vmax, rf);
    // low/high 8-lane halves widen to f64 (extractf64x4 is AVX512F;
    // extractf32x8 would need DQ)
    __m256 lo = _mm512_castps512_ps256(rf);
    __m256 hi = _mm256_castpd_ps(
        _mm512_extractf64x4_pd(_mm512_castps_pd(rf), 1));
    __m512d dlo = _mm512_cvtps_pd(lo);
    __m512d dhi = _mm512_cvtps_pd(hi);
    acc0 = _mm512_add_pd(acc0, _mm512_mul_pd(dlo, dlo));
    acc1 = _mm512_add_pd(acc1, _mm512_mul_pd(dhi, dhi));
  }
  h->sumsq += _mm512_reduce_add_pd(acc0) + _mm512_reduce_add_pd(acc1);
  double m = (double)_mm512_reduce_max_ps(vmax);
  if (m > h->absmax) h->absmax = m;
  h->nonfinite += nonfin;
  for (; i < n; ++i) {
    d[i] += s[i];
    stat_f32_one(d[i], h);
  }
}
#endif  // BYTEPS_HAVE_SIMD_FOLD

static void stat_scan_bf16_scalar(const uint16_t* p, size_t n,
                                  HStat* h) {
  for (size_t i = 0; i < n; ++i) stat_f32_one(bf16_to_float(p[i]), h);
}

static void stat_scan_f16_scalar(const uint16_t* p, size_t n, HStat* h) {
  for (size_t i = 0; i < n; ++i) stat_f32_one(half_to_float(p[i]), h);
}

static void stat_scan_f64_scalar(const double* p, size_t n, HStat* h) {
  for (size_t i = 0; i < n; ++i) {
    double v = p[i];
    if (!std::isfinite(v)) {
      h->nonfinite++;
      continue;
    }
    h->sumsq += v * v;
    double av = v < 0 ? -v : v;
    if (av > h->absmax) h->absmax = av;
  }
}

struct FoldKernels {
  void (*f32)(float*, const float*, size_t) = fold_f32_scalar;
  void (*bf16)(uint16_t*, const uint16_t*, size_t) = fold_bf16_scalar;
  // health-plane variants (BYTEPS_HEALTH): the fused last-fold kernel
  // and the read-only aggregate scan, dispatched on the same tier
  void (*f32_stat)(float*, const float*, size_t, HStat*) =
      fold_f32_stat_scalar;
  void (*scan_f32)(const float*, size_t, HStat*) = stat_scan_f32_scalar;
  int tier = kSimdScalar;
};

static int simd_best_supported() {
#ifdef BYTEPS_HAVE_SIMD_FOLD
  if (__builtin_cpu_supports("avx512f") &&
      __builtin_cpu_supports("avx512bw"))
    return kSimdAvx512;
  if (__builtin_cpu_supports("avx2")) return kSimdAvx2;
#endif
  return kSimdScalar;
}

// Resolve the fold tier from a BYTEPS_SIMD-style string. Read per
// Server instance (like Throttle/Chaos) so SIMD-on and scalar servers
// coexist in one test process. An explicit request for an unsupported
// tier degrades to the best available rather than erroring: the knob
// is a ceiling, not an ISA assertion.
static FoldKernels resolve_fold_kernels(const char* want) {
  int tier = simd_best_supported();
  if (want && *want) {
    std::string v(want);
    for (char& c : v) c = (char)std::tolower((unsigned char)c);
    if (v == "0" || v == "off" || v == "scalar" || v == "false")
      tier = kSimdScalar;
    else if (v == "avx2" && tier > kSimdAvx2)
      tier = kSimdAvx2;
    // "auto"/"avx512"/anything else: keep the detected best
  }
  FoldKernels k;
  k.tier = tier;
#ifdef BYTEPS_HAVE_SIMD_FOLD
  if (tier == kSimdAvx512) {
    k.f32 = fold_f32_avx512;
    k.bf16 = fold_bf16_avx512;
    k.f32_stat = fold_f32_stat_avx512;
    k.scan_f32 = stat_scan_f32_avx2;  // AVX512F implies AVX2
  } else if (tier == kSimdAvx2) {
    k.f32 = fold_f32_avx2;
    k.bf16 = fold_bf16_avx2;
    k.f32_stat = fold_f32_stat_avx2;
    k.scan_f32 = stat_scan_f32_avx2;
  }
#endif
  return k;
}

// Read-only aggregate statistics scan (the publish-path half of the
// health plane: adopt-only rounds, compressed/rowsparse publishes and
// non-f32 dtypes). Unsupported dtypes publish an all-zero stat with
// elems=0 — identifiable as "no statistics", never stale.
static void stat_scan(const void* p, size_t bytes, uint32_t dtype,
                      const FoldKernels& k, HStat* h) {
  switch (dtype) {
    case F32:
      k.scan_f32((const float*)p, bytes / 4, h);
      h->elems += bytes / 4;
      break;
    case BF16:
      stat_scan_bf16_scalar((const uint16_t*)p, bytes / 2, h);
      h->elems += bytes / 2;
      break;
    case F16:
      stat_scan_f16_scalar((const uint16_t*)p, bytes / 2, h);
      h->elems += bytes / 2;
      break;
    case F64:
      stat_scan_f64_scalar((const double*)p, bytes / 8, h);
      h->elems += bytes / 8;
      break;
    default:
      break;  // integer dtypes: no float statistics to take
  }
}

// dtype-aware summation: dst += src. fp32/bf16 ride the dispatched
// SIMD kernels (bitwise-identical to the scalar loops by contract);
// everything else keeps the plain loops -O3 auto-vectorizes (the
// reference uses OpenMP SIMD pragmas, cpu_reducer.cc:59-120).
static void sum_into(void* dst, const void* src, size_t bytes,
                     uint32_t dtype, const FoldKernels& k) {
  switch (dtype) {
    case F32: {
      k.f32((float*)dst, (const float*)src, bytes / 4);
      break;
    }
    case F64: {
      double* d = (double*)dst;
      const double* s = (const double*)src;
      size_t n = bytes / 8;
      for (size_t i = 0; i < n; ++i) d[i] += s[i];
      break;
    }
    case I32: {
      int32_t* d = (int32_t*)dst;
      const int32_t* s = (const int32_t*)src;
      size_t n = bytes / 4;
      for (size_t i = 0; i < n; ++i) d[i] += s[i];
      break;
    }
    case I64: {
      int64_t* d = (int64_t*)dst;
      const int64_t* s = (const int64_t*)src;
      size_t n = bytes / 8;
      for (size_t i = 0; i < n; ++i) d[i] += s[i];
      break;
    }
    case U8: case I8: {
      uint8_t* d = (uint8_t*)dst;
      const uint8_t* s = (const uint8_t*)src;
      for (size_t i = 0; i < bytes; ++i) d[i] += s[i];
      break;
    }
    case F16: {
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
      size_t n = bytes / 2;
      for (size_t i = 0; i < n; ++i)
        d[i] = float_to_half(half_to_float(d[i]) + half_to_float(s[i]));
      break;
    }
    case BF16: {
      k.bf16((uint16_t*)dst, (const uint16_t*)src, bytes / 2);
      break;
    }
    case U16: {
      uint16_t* d = (uint16_t*)dst;
      const uint16_t* s = (const uint16_t*)src;
      size_t n = bytes / 2;
      for (size_t i = 0; i < n; ++i) d[i] += s[i];
      break;
    }
    default:
      // Unreachable from the wire: DoInit rejects out-of-enum dtypes with
      // an error reply before a store exists, and pushes use the store's
      // dtype. Kept as a log (not the reference's CHECK/abort) so a future
      // internal misuse can't let one bad request kill a shared server.
      std::fprintf(stderr, "[bps-server] unsupported dtype %u for sum\n",
                   dtype);
      break;
  }
}

// ------------------------------------------------------------------ //
// server-side compression mirror
//
// The reference server instantiates the worker's compressor from kwargs
// pushed in-band, decompresses each push, sums dense, and recompresses the
// aggregate for pulls (server.cc:92-118,228-257). Wire formats match
// byteps_tpu/ops/compression/host.py (the portable layouts, NOT the Pallas
// sublane-folded onebit layout). Bit-exactness contract: signs, levels and
// indices are bit-for-bit with the numpy golden; reduction-derived scalars
// (onebit scale, dithering l2 norm) may differ by an ulp — this side
// accumulates in double, numpy uses float32 pairwise summation.
// ------------------------------------------------------------------ //

// splitmix64 seeding shared with ops/compression/rng.py seed_state().
static void seed_state64(uint64_t seed, uint64_t* s0, uint64_t* s1) {
  uint64_t out[2];
  uint64_t z = seed;
  for (int i = 0; i < 2; ++i) {
    z += 0x9E3779B97F4A7C15ULL;
    uint64_t x = z;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    out[i] = x ^ (x >> 31);
  }
  *s0 = out[0];
  *s1 = out[1];
}

static inline uint32_t mm3_fin(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6BU;
  h ^= h >> 13;
  h *= 0xC2B2AE35U;
  h ^= h >> 16;
  return h;
}

// counter-based uniform, bit-exact with rng.np_uniform_parallel
static inline float uniform_at(uint32_t i, uint32_t base) {
  uint32_t h = mm3_fin(i * 0x9E3779B1U + base);
  return (float)((double)(h >> 8) / 16777216.0);
}

struct CompressorCfg {
  enum Type { NONE = 0, ONEBIT, TOPK, RANDOMK, DITHERING, LOSSLESS };
  int type = NONE;
  uint32_t n = 0;       // uncompressed f32 element count
  uint32_t k = 0;       // topk/randomk
  uint32_t s = 127;     // dithering levels
  uint64_t seed = 0;
  bool scaled = true;   // onebit
  bool natural = false; // dithering partition
  bool l2 = false;      // dithering normalize
  bool varint = false;  // dithering sparse index coding (delta+LEB128)

  // Lossless byte-plane wire header (little-endian, mirrored bit-for-bit
  // by ops/compression/lossless.py — the wire has three producers like
  // the lossy codecs): [u32 n][u8 mode][u8 nplanes=4][u16 rsvd]
  // [u32 plane_len[4]][plane bytes...]. mode 1 = zlib-deflated planes
  // (self-describing stream — producers need not emit identical bytes,
  // only decodable ones); mode 0 = raw passthrough when deflate did not
  // help, capping the wire at header + 4n.
  static constexpr uint32_t kLosslessHdr = 8 + 4 * 4;

  // Upper bound on a wire payload. Fixed formats use it exactly; the
  // varint dithering wire and the lossless byte-plane wire are
  // variable-length up to this bound (dithering worst case all-nonzero:
  // n 1-byte gaps + n levels + multi-byte-gap slack; lossless worst
  // case: raw-passthrough planes).
  uint32_t WireLen() const {
    switch (type) {
      case ONEBIT: return ((n + 31) / 32) * 4 + 4;
      case TOPK: case RANDOMK: return k * 8;
      case DITHERING:
        return varint ? 2 * n + n / 64 + 16 : n + 4;
      case LOSSLESS: return kLosslessHdr + 4 * n;
      default: return 0;
    }
  }

  bool ValidLen(size_t len) const {
    if (type == DITHERING && varint)
      return len >= 8 && len <= WireLen();
    if (type == LOSSLESS)
      return len >= kLosslessHdr && len <= WireLen();
    return len == WireLen();
  }

  bool operator==(const CompressorCfg& o) const {
    return type == o.type && n == o.n && k == o.k && s == o.s &&
           seed == o.seed && scaled == o.scaled && natural == o.natural &&
           l2 == o.l2 && varint == o.varint;
  }

  // kwargs string: "compressor=onebit;n=100;scaling=1;..."
  // (host.py kwargs_wire). Returns false on malformed/unknown input.
  static bool Parse(const std::string& kw, CompressorCfg* out) {
    CompressorCfg c;
    std::string name;
    size_t pos = 0;
    while (pos < kw.size()) {
      size_t semi = kw.find(';', pos);
      if (semi == std::string::npos) semi = kw.size();
      std::string pair = kw.substr(pos, semi - pos);
      size_t eq = pair.find('=');
      if (eq != std::string::npos) {
        std::string key = pair.substr(0, eq);
        std::string val = pair.substr(eq + 1);
        if (key == "compressor") name = val;
        else if (key == "n") c.n = (uint32_t)std::atoll(val.c_str());
        else if (key == "k") c.k = (uint32_t)std::atoll(val.c_str());
        else if (key == "s") c.s = (uint32_t)std::atoll(val.c_str());
        else if (key == "seed") c.seed = (uint64_t)std::atoll(val.c_str());
        else if (key == "scaling")
          c.scaled = (val == "1" || val == "true");
        else if (key == "partition_type") c.natural = (val == "natural");
        else if (key == "normalize_type") c.l2 = (val == "l2");
        else if (key == "index_coding") c.varint = (val == "varint");
      }
      pos = semi + 1;
    }
    if (name == "onebit") c.type = ONEBIT;
    else if (name == "topk") c.type = TOPK;
    else if (name == "randomk") c.type = RANDOMK;
    else if (name == "dithering") c.type = DITHERING;
    else if (name == "lossless") c.type = LOSSLESS;
    // "none" = explicit codec CLEAR: the adaptive plane de-escalating a
    // key back to dense sends COMP_INIT with compressor=none so later
    // dense pushes pass the mode gate (DoPush) instead of erroring
    // against a stale compressed cfg. n still validated against the
    // store like any other cfg.
    else if (name == "none") c.type = NONE;
    else return false;
    if (c.n == 0) return false;
    if ((c.type == TOPK || c.type == RANDOMK) &&
        (c.k == 0 || c.k > c.n)) return false;
    if (c.type == DITHERING && (c.s == 0 || c.s > 127)) return false;
    *out = c;
    return true;
  }

  // worker-side randomk index derivation for one aggregation round —
  // bit-parity with HostRandomk.indices (rng.np_uniform_parallel over
  // uniform_base(seed, step)); the server normally REUSES pushed indices
  // (round_idx), this is for the worker-tier codec exposed over the C ABI
  void RandomkIndices(uint64_t step, std::vector<int32_t>* out) const {
    uint64_t s0, s1;
    seed_state64(seed, &s0, &s1);
    uint32_t base = (uint32_t)(s0 & 0xFFFFFFFFULL) ^ (uint32_t)step;
    out->resize(k);
    for (uint32_t i = 0; i < k; ++i) {
      // full 32-bit hash modulo n (bit-parity with rng.np_index_parallel):
      // the float-uniform form had 24-bit granularity, capping distinct
      // indices at 2^24 — wrong past n = 16.7M elements
      uint32_t h = mm3_fin(i * 0x9E3779B1U + base);
      (*out)[i] = (int32_t)(h % n);
    }
  }

  // wire payload -> dense f32[n]; for randomk/topk also exposes the
  // payload's indices (randomk recompression reuses the round's shared
  // indices instead of re-deriving the xorshift stream)
  bool Decompress(const uint8_t* in, uint32_t len, float* out,
                  std::vector<int32_t>* idx_out) const {
    if (!ValidLen(len)) return false;
    switch (type) {
      case ONEBIT: {
        float scale;
        std::memcpy(&scale, in + len - 4, 4);
        const uint32_t* bits = (const uint32_t*)in;
        uint32_t i = 0;
#if defined(__AVX2__)
        // 8 lanes/byte of the packed word: test each selector bit and
        // blend +/-scale — ~memory speed vs ~1 elem/cycle scalar
        const __m256i sel = _mm256_setr_epi32(1, 2, 4, 8, 16, 32, 64, 128);
        const __m256 ps = _mm256_set1_ps(scale);
        const __m256 ns = _mm256_set1_ps(-scale);
        for (; i + 32 <= n; i += 32) {
          uint32_t word = bits[i / 32];
          for (int g = 0; g < 4; ++g) {
            __m256i b = _mm256_set1_epi32((int)((word >> (g * 8)) & 0xFF));
            __m256i m = _mm256_cmpeq_epi32(_mm256_and_si256(b, sel), sel);
            _mm256_storeu_ps(out + i + g * 8,
                             _mm256_blendv_ps(ns, ps,
                                              _mm256_castsi256_ps(m)));
          }
        }
#endif
        for (; i < n; ++i) {
          uint32_t w = bits[i / 32];
          out[i] = ((w >> (i % 32)) & 1) ? scale : -scale;
        }
        return true;
      }
      case TOPK: case RANDOMK: {
        const int32_t* idx = (const int32_t*)in;
        const float* val = (const float*)(in + 4 * k);
        std::memset(out, 0, n * sizeof(float));
        for (uint32_t i = 0; i < k; ++i) {
          if (idx[i] < 0 || (uint32_t)idx[i] >= n) return false;
          out[idx[i]] = val[i];  // duplicate idx: last wins (numpy parity)
        }
        if (idx_out) idx_out->assign(idx, idx + k);
        return true;
      }
      case DITHERING: {
        if (varint) {
          // [u32 nnz][LEB128 gaps][int8 levels][f32 norm]; gaps are
          // deltas with an implicit start index of -1 (first gap =
          // idx0 + 1, always >= 1). Bounds-checked: untrusted input.
          uint32_t nnz;
          std::memcpy(&nnz, in, 4);
          if (nnz > n) return false;
          std::memset(out, 0, (size_t)n * sizeof(float));
          size_t pos = 4;
          std::vector<uint32_t> idxs(nnz);
          int64_t idx = -1;
          for (uint32_t j = 0; j < nnz; ++j) {
            uint64_t g = 0;
            int shift = 0;
            for (;;) {
              if (pos >= len) return false;
              uint8_t b = in[pos++];
              g |= (uint64_t)(b & 0x7F) << shift;
              if (!(b & 0x80)) break;
              shift += 7;
              if (shift > 35) return false;
            }
            if (g == 0) return false;
            idx += (int64_t)g;
            if (idx >= (int64_t)n) return false;
            idxs[j] = (uint32_t)idx;
          }
          if (pos + nnz + 4 != len) return false;
          const int8_t* lv = (const int8_t*)(in + pos);
          float norm;
          std::memcpy(&norm, in + pos + nnz, 4);
          for (uint32_t j = 0; j < nnz; ++j) {
            float l = (float)lv[j];
            float a = std::fabs(l);
            float mag = !natural ? a / (float)s
                                 : (l == 0.0f ? 0.0f
                                              : std::exp2f(-(a - 1.0f)));
            float sgn = (l > 0) - (l < 0);
            out[idxs[j]] = sgn * mag * norm;
          }
          return true;
        }
        float norm;
        std::memcpy(&norm, in + n, 4);
        const int8_t* lv = (const int8_t*)in;
        for (uint32_t i = 0; i < n; ++i) {
          float l = (float)lv[i];
          float a = std::fabs(l);
          float mag;
          if (!natural) {
            mag = a / (float)s;
          } else {
            mag = (l == 0.0f) ? 0.0f : std::exp2f(-(a - 1.0f));
          }
          float sgn = (l > 0) - (l < 0);
          out[i] = sgn * mag * norm;
        }
        return true;
      }
      case LOSSLESS: {
        // byte-plane split + zlib inflate, bitwise-exact reconstruction
        // (ZipCCL's exponent/mantissa byte-plane observation, arxiv
        // 2604.27844). Bounds-checked: untrusted input.
        uint32_t wn;
        std::memcpy(&wn, in, 4);
        uint8_t mode = in[4], nplanes = in[5];
        if (wn != n || nplanes != 4 || mode > 1) return false;
        uint32_t plens[4];
        std::memcpy(plens, in + 8, 16);
        uint64_t total = 0;
        for (int j = 0; j < 4; ++j) total += plens[j];
        if (kLosslessHdr + total != len) return false;
        uint8_t* dst = (uint8_t*)out;
        std::vector<uint8_t> plane(n);
        size_t pos = kLosslessHdr;
        for (int j = 0; j < 4; ++j) {
          const uint8_t* src = in + pos;
          if (mode == 0) {
            if (plens[j] != n) return false;
            for (uint32_t i = 0; i < n; ++i) dst[i * 4 + j] = src[i];
          } else {
            uLongf dl = n;
            if (uncompress(plane.data(), &dl, src, plens[j]) != Z_OK ||
                dl != n)
              return false;
            for (uint32_t i = 0; i < n; ++i) dst[i * 4 + j] = plane[i];
          }
          pos += plens[j];
        }
        return true;
      }
      default: return false;
    }
  }

  // dense f32[n] -> wire payload; returns the ACTUAL payload length
  // (== WireLen() for the fixed formats; <= WireLen() for the varint
  // dithering wire). step = completed aggregation rounds before this one
  // (matches the worker's per-key push counter); round_idx = the shared
  // indices of this round's randomk payloads.
  uint32_t Compress(const float* in, uint8_t* out, uint64_t step,
                    const std::vector<int32_t>& round_idx) const {
    switch (type) {
      case ONEBIT: {
        // FUSED scale + pack: the input is read ONCE (4MB partitions are
        // far past L2, so a second pass would re-stream from RAM and
        // double the compress time — measured 66ms -> 35ms per 256MB).
        uint32_t words = (n + 31) / 32;
        uint32_t* bits = (uint32_t*)out;
        double acc = 0;
        uint32_t w = 0;
#if defined(__AVX2__)
        // sign bits via cmp_ge + movemask (8 bits/insn, exact ">= 0"
        // semantics: NaN -> 0, -0.0 -> 1, numpy parity); |x| accumulated
        // in 4 double lanes in the same pass (double keeps the
        // documented ulp contract vs numpy's f32 pairwise sum)
        const __m256 z = _mm256_setzero_ps();
        const __m256 absmask =
            _mm256_castsi256_ps(_mm256_set1_epi32(0x7FFFFFFF));
        __m256d acc4 = _mm256_setzero_pd();
        for (; (w + 1) * 32 <= n; ++w) {
          const float* p = in + w * 32;
          uint32_t word = 0;
          for (int g = 0; g < 4; ++g) {
            __m256 v = _mm256_loadu_ps(p + g * 8);
            word |= (uint32_t)_mm256_movemask_ps(
                        _mm256_cmp_ps(v, z, _CMP_GE_OQ))
                    << (g * 8);
            if (scaled) {
              __m256 a = _mm256_and_ps(v, absmask);
              acc4 = _mm256_add_pd(
                  acc4, _mm256_cvtps_pd(_mm256_castps256_ps128(a)));
              acc4 = _mm256_add_pd(
                  acc4, _mm256_cvtps_pd(_mm256_extractf128_ps(a, 1)));
            }
          }
          bits[w] = word;
        }
        double lanes[4];
        _mm256_storeu_pd(lanes, acc4);
        acc = lanes[0] + lanes[1] + lanes[2] + lanes[3];
#endif
        for (; w < words; ++w) {
          uint32_t word = 0;
          for (uint32_t b = 0; b < 32; ++b) {
            uint32_t i = w * 32 + b;
            // zero-padding beyond n packs as +1 (host.py parity)
            uint32_t bit = (i < n) ? (in[i] >= 0.0f) : 1u;
            if (i < n && scaled) acc += std::fabs(in[i]);
            word |= bit << b;
          }
          bits[w] = word;
        }
        float scale = scaled ? (float)(acc / n) : 1.0f;
        std::memcpy(out + words * 4, &scale, 4);
        return words * 4 + 4;
      }
      case TOPK: {
        // (|v| desc, idx asc) selection, emitted in ascending-index order
        // (host.py HostTopk.select)
        std::vector<int32_t> order(n);
        for (uint32_t i = 0; i < n; ++i) order[i] = (int32_t)i;
        auto cmp = [&](int32_t a, int32_t b) {
          float fa = std::fabs(in[a]), fb = std::fabs(in[b]);
          // NaN -> below every finite |v| (numpy lexsort places NaN
          // last); without this the comparator loses strict weak
          // ordering and nth_element/sort are UB on NaN gradients
          if (std::isnan(fa)) fa = -1.0f;
          if (std::isnan(fb)) fb = -1.0f;
          if (fa != fb) return fa > fb;
          return a < b;
        };
        std::nth_element(order.begin(), order.begin() + k, order.end(), cmp);
        std::sort(order.begin(), order.begin() + k);  // ascending index
        int32_t* idx = (int32_t*)out;
        float* val = (float*)(out + 4 * k);
        for (uint32_t i = 0; i < k; ++i) {
          idx[i] = order[i];
          val[i] = in[order[i]];
        }
        return k * 8;
      }
      case RANDOMK: {
        int32_t* idx = (int32_t*)out;
        float* val = (float*)(out + 4 * k);
        for (uint32_t i = 0; i < k; ++i) {
          int32_t j = i < round_idx.size() ? round_idx[i] : 0;
          idx[i] = j;
          val[i] = in[j];
        }
        return k * 8;
      }
      case DITHERING: {
        float m = 0.0f;
        for (uint32_t i = 0; i < n; ++i)
          m = std::max(m, std::fabs(in[i]));
        float norm = m;
        if (l2) {
          // scale-invariant two-pass l2 (host.py parity): raw x*x would
          // overflow for |x| near float32 max
          float safe_m = std::max(m, 1e-30f);
          double acc = 0;
          for (uint32_t i = 0; i < n; ++i) {
            double r = (double)(in[i] / safe_m);
            acc += r * r;
          }
          norm = safe_m * (float)std::sqrt(acc);
        }
        norm = std::max(norm, 1e-30f);
        uint64_t s0, s1;
        seed_state64(seed, &s0, &s1);
        uint32_t base = (uint32_t)(s0 & 0xFFFFFFFFULL) ^ (uint32_t)step;
        // dense: int8 levels in place. varint: [u32 nnz][LEB128 gaps
        // (first gap = idx0+1, then deltas)][int8 nonzero levels]
        // [f32 norm] — the reference's coded sparse dithering wire
        // (impl/dithering.cc:25-80, utils.h BitWriter), byte-aligned.
        int8_t* lv_dense = varint ? nullptr : (int8_t*)out;
        size_t gap_pos = 4;
        std::vector<int8_t> lvs;
        uint32_t last = 0, nnz = 0;
        bool first = true;
        for (uint32_t i = 0; i < n; ++i) {
          float scl = std::fabs(in[i]) / norm;
          float u = uniform_at(i, base);
          float level;
          if (!natural) {
            float pos = scl * (float)s;
            float fl = std::floor(pos);
            level = fl + (u < (pos - fl) ? 1.0f : 0.0f);
            // l2 norm can round below max|x| -> scl > 1; unclamped
            // level s+1 would wrap the int8 cast at s=127
            level = std::min(level, (float)s);
          } else {
            float safe = std::max(scl, 1e-30f);
            float j = std::floor(-std::log2f(safe));
            j = std::min(std::max(j, 0.0f), 30.0f);
            float low = std::exp2f(-j - 1.0f);
            float high = std::exp2f(-j);
            float frac = (scl - low) / (high - low);
            float e = (u < frac) ? j : j + 1.0f;
            level = (scl < std::exp2f(-31.0f)) ? 0.0f : e + 1.0f;
            level = std::min(std::max(level, 0.0f), 126.0f);
          }
          float sgn = (in[i] > 0) - (in[i] < 0);
          int8_t v = (int8_t)(sgn * level);
          if (!varint) {
            lv_dense[i] = v;
            continue;
          }
          if (v == 0) continue;
          uint64_t gap = first ? (uint64_t)i + 1 : (uint64_t)(i - last);
          first = false;
          last = i;
          while (gap >= 0x80) {
            out[gap_pos++] = (uint8_t)(gap & 0x7F) | 0x80;
            gap >>= 7;
          }
          out[gap_pos++] = (uint8_t)gap;
          lvs.push_back(v);
          ++nnz;
        }
        if (!varint) {
          std::memcpy(out + n, &norm, 4);
          return n + 4;
        }
        std::memcpy(out, &nnz, 4);
        if (nnz) std::memcpy(out + gap_pos, lvs.data(), nnz);
        std::memcpy(out + gap_pos + nnz, &norm, 4);
        return (uint32_t)(gap_pos + nnz + 4);
      }
      case LOSSLESS: {
        // byte-plane split (plane j = byte j of every f32) + zlib
        // deflate per plane; raw passthrough (mode 0) when deflate does
        // not pay, so the wire never exceeds WireLen(). Level 1: the
        // tier trades a cheap entropy pass for wire bytes — gradient
        // sign/exponent planes carry most of the redundancy and
        // compress well even at the fastest level, while higher levels
        // burn compress wall for little extra ratio on mantissa noise.
        const uint8_t* src = (const uint8_t*)in;
        std::vector<uint8_t> plane(n);
        std::vector<uint8_t> packed[4];
        uint64_t total = 0;
        bool deflated = true;
        for (int j = 0; j < 4 && deflated; ++j) {
          for (uint32_t i = 0; i < n; ++i) plane[i] = src[i * 4 + j];
          packed[j].resize(compressBound(n));
          uLongf dl = packed[j].size();
          if (compress2(packed[j].data(), &dl, plane.data(), n, 1)
              != Z_OK)
            deflated = false;
          packed[j].resize(dl);
          total += dl;
        }
        uint8_t mode = (deflated && total < 4ull * n) ? 1 : 0;
        std::memcpy(out, &n, 4);
        out[4] = mode;
        out[5] = 4;  // nplanes
        out[6] = out[7] = 0;
        size_t pos = kLosslessHdr;
        for (int j = 0; j < 4; ++j) {
          uint32_t pl = mode ? (uint32_t)packed[j].size() : n;
          std::memcpy(out + 8 + 4 * j, &pl, 4);
          if (mode) {
            std::memcpy(out + pos, packed[j].data(), pl);
          } else {
            for (uint32_t i = 0; i < n; ++i) out[pos + i] = src[i * 4 + j];
          }
          pos += pl;
        }
        return (uint32_t)pos;
      }
      default: return 0;
    }
  }
};

// ------------------------------------------------------------------ //
// server
// ------------------------------------------------------------------ //

// BYTEPS_SERVER_THROTTLE_MBPS: evidence/test knob — cap THIS server
// process's payload bandwidth (push ingress + pull egress combined) with
// a token bucket that SLEEPS the offending thread. Sleeping (not
// spinning) is the point: on a small-core host a throttled server yields
// its core to the worker / the other server, so the scaling rule the
// reference documents (throughput ∝ min(server bw, worker bw),
// docs/best-practice.md:41-44) becomes measurable independently of core
// count — cap one server at T and the worker's rate tracks T; split the
// keys over two throttled servers and it doubles. Off (no limit) unless
// the env var is a positive number. Read per-Server (not a process-wide
// static) so throttled and unthrottled servers coexist in one test
// process.
class Throttle {
 public:
  Throttle() {
    if (const char* e = ::getenv("BYTEPS_SERVER_THROTTLE_MBPS")) {
      double v = std::atof(e);
      if (v > 0) {
        rate_ = v * 1e6;           // bytes/s
        burst_ = rate_ * 0.05;     // 50ms of credit: smooths scheduler
                                   // jitter without distorting the rate
        tokens_ = burst_;
        last_ = std::chrono::steady_clock::now();
      }
    }
  }
  bool enabled() const { return rate_ > 0; }
  void charge(size_t nbytes) {
    if (rate_ <= 0 || nbytes == 0) return;
    double wait = 0;
    {
      std::lock_guard<Mu> lk(mu_);
      auto now = std::chrono::steady_clock::now();
      tokens_ = std::min(
          burst_, tokens_ + rate_ * std::chrono::duration<double>(
                                        now - last_).count());
      last_ = now;
      tokens_ -= (double)nbytes;   // debt allowed: the NEXT charge (or
                                   // this one, below) sleeps it off
      if (tokens_ < 0) wait = -tokens_ / rate_;
    }
    if (wait > 0)
      std::this_thread::sleep_for(std::chrono::duration<double>(wait));
  }

 private:
  double rate_ = 0;
  double burst_ = 0;
  Mu mu_;
  double tokens_ = 0;
  std::chrono::steady_clock::time_point last_;
};

// BYTEPS_CHAOS_*: fault-injection knobs for the chaos harness
// (docs/fault-tolerance.md). Read per-Server instance so chaos'd and
// clean servers coexist in one test process:
//   BYTEPS_CHAOS_KILL_AFTER_ROUNDS=N  — _exit(137) once N aggregation
//     rounds completed on this server (the SIGKILL shape: no teardown,
//     no flushes; subprocess servers only — the exit takes the whole
//     process);
//   BYTEPS_CHAOS_DROP_REPLY_RATE=R    — deterministically drop fraction
//     R (0..1] of aggregate replies (PULL_REPLY / fused completions),
//     via an error-free accumulator (no RNG: reruns drop the same
//     replies). Forces client timeouts + retries, which the epoch
//     replay-dedup must absorb without double-counting;
//   BYTEPS_CHAOS_DELAY_MS=M           — sleep M ms before each
//     aggregate reply (latency injection);
//   BYTEPS_CHAOS_SLOW_SERVER=M        — PERSISTENT per-server slowdown:
//     every data request sleeps M ms between dequeue and handling, so
//     the engine serializes behind the sleeps and the server's
//     queue-wait stage counters inflate continuously — the gray-failure
//     shape (slow-but-alive straggler) the autoscaler's eviction
//     detector keys on, unlike the reply-only DELAY_MS above.
class Chaos {
 public:
  Chaos() {
    if (const char* e = ::getenv("BYTEPS_CHAOS_DROP_REPLY_RATE")) {
      double v = std::atof(e);
      if (v > 0) drop_rate_ = v > 1.0 ? 1.0 : v;
    }
    if (const char* e = ::getenv("BYTEPS_CHAOS_DELAY_MS"))
      delay_ms_ = std::atol(e);
    if (const char* e = ::getenv("BYTEPS_CHAOS_KILL_AFTER_ROUNDS"))
      kill_rounds_ = std::atol(e);
    if (const char* e = ::getenv("BYTEPS_CHAOS_SLOW_SERVER"))
      slow_ms_ = std::atol(e);
  }

  // Called at engine dequeue, BEFORE the queue-wait accounting: the
  // injected latency lands in queue_ns (requests behind it also wait),
  // which is exactly the stage a real straggler inflates.
  void slow_point() {
    if (slow_ms_ > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(slow_ms_));
  }

  // Called before an aggregate reply is sent: inject latency, then
  // decide whether to drop it entirely.
  bool swallow_reply() {
    if (delay_ms_ > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(delay_ms_));
    if (drop_rate_ <= 0) return false;
    std::lock_guard<Mu> lk(mu_);
    acc_ += drop_rate_;
    if (acc_ >= 1.0) {
      acc_ -= 1.0;
      dropped_++;
      return true;
    }
    return false;
  }

  void round_completed() {
    if (kill_rounds_ <= 0) return;
    if (rounds_.fetch_add(1) + 1 >= kill_rounds_) {
      std::fprintf(stderr,
                   "[bps-server] CHAOS: kill-after-rounds reached (%ld); "
                   "_exit(137)\n", kill_rounds_);
      ::_exit(137);
    }
  }

 private:
  double drop_rate_ = 0;
  long delay_ms_ = 0;
  long kill_rounds_ = 0;
  long slow_ms_ = 0;
  Mu mu_;
  double acc_ = 0;
  long dropped_ = 0;
  std::atomic<long> rounds_{0};
};

// Per-stage server accounting (recv -> queue-wait -> fold -> reply),
// exposed over the C ABI (bps_server_stats) and mirrored into the
// Python metrics snapshot's `server` section — so the next bound stage
// of the data plane is measured, not guessed. All relaxed atomics:
// totals, not synchronization.
struct StageStats {
  std::atomic<uint64_t> recv_ns{0};
  std::atomic<uint64_t> recv_count{0};
  std::atomic<uint64_t> queue_ns{0};
  std::atomic<uint64_t> queue_count{0};
  std::atomic<uint64_t> fold_ns{0};
  std::atomic<uint64_t> fold_count{0};
  std::atomic<uint64_t> fold_bytes{0};
  std::atomic<uint64_t> reply_ns{0};
  std::atomic<uint64_t> reply_count{0};
  std::atomic<uint64_t> direct_recvs{0};  // zero-copy recv-into-store
  std::atomic<uint64_t> oob_msgs{0};      // descriptor-ring payloads
  // batched-submission wire plane (BYTEPS_WIRE_RING): syscall batches
  // vs messages on each side — tx_msgs/tx_batches is the per-sendmsg
  // reply batch depth, rx_msgs/rx_batches the per-recv message count.
  // The stripe_ab bench uses these to PROVE the per-message syscall
  // path retired, not just that throughput moved.
  std::atomic<uint64_t> tx_batches{0};
  std::atomic<uint64_t> tx_msgs{0};
  std::atomic<uint64_t> rx_batches{0};
  std::atomic<uint64_t> rx_msgs{0};
  // striped data connections: segments reassembled + their chunk bytes
  std::atomic<uint64_t> stripe_segs{0};
  std::atomic<uint64_t> stripe_bytes{0};
  // lossless pushes decoded straight into the accumulator (fused
  // decode-into-fold; BYTEPS_FUSED_DECODE)
  std::atomic<uint64_t> fused_decode_folds{0};
  // RDMA-shaped transport registration (TransportReg): blocks
  // registered at allocation; recv targets that missed the registry
  std::atomic<uint64_t> reg_blocks{0};
  std::atomic<uint64_t> reg_miss{0};
};

struct Conn {
  int fd;
  // worker id observed on this connection's first message; -1 until then
  // (failure detection: a worker is presumed dead when ALL its conns die)
  std::atomic<int> sender{-1};
  // set when this connection's recv loop exits, BEFORE the departure
  // rollback runs. Engine handlers re-check it under the key lock, so a
  // dead worker's still-queued message can never apply AFTER the
  // rollback (mutex ordering: dead=true happens-before the rollback's
  // ks.mu, which happens-before the handler's ks.mu). A reconnect is a
  // NEW Conn, so retried messages pass.
  std::atomic<bool> dead{false};
  ~Conn() {
    if (fd >= 0) ::close(fd);  // last ref (conn thread or parked pull) drops
  }
  Mu write_mu;
  // shm transport after a COMMITTED IPC upgrade; null = plain TCP
  std::unique_ptr<IpcChan> ipc;
  // mapped at IPC_HELLO, promoted to `ipc` only by the client's
  // IPC_CONFIRM (conn-loop thread only); abandoned — munmapped by the
  // IpcChan dtor — when any other message arrives first or the conn dies
  std::unique_ptr<IpcChan> ipc_pending;
  Throttle* thr = nullptr;  // server's bucket; null on the client side
  StageStats* stats = nullptr;  // server's counters; null client side

  // ---- per-lane wire counters (time-series plane) ------------------
  // The stripe plane's fleet totals (tx_batches / stripe_bytes) can't
  // show a dead-slow data lane; these de-aggregate them per connection.
  // lane_id is assigned monotonically at accept and is stable for the
  // conn's life; counters are relaxed atomics (tx side may be touched
  // by several engine threads through send_msg). Snapshot-read by
  // StripeSlots() answering STRIPE_PULL / bps_server_stripe_stats.
  uint64_t lane_id = 0;
  std::atomic<uint64_t> lane_tx_bytes{0};
  std::atomic<uint64_t> lane_tx_msgs{0};
  std::atomic<uint64_t> lane_rx_bytes{0};   // conn-loop thread only
  std::atomic<uint64_t> lane_rx_msgs{0};    // conn-loop thread only
  std::atomic<uint64_t> lane_seg_count{0};  // stripe segments reassembled
  std::atomic<uint64_t> lane_seg_bytes{0};

  // ---- tx submission ring (BYTEPS_WIRE_RING) -----------------------
  // Replies staged under write_mu, flushed kTxBatch at a time through
  // one gathered sendmsg each (send_iovs). Engine threads stage with
  // send_msg_queued and flush at their queue-drain boundary, so a
  // burst of N replies leaves in ~1 syscall instead of N. Blocking
  // send_msg drains the ring first — per-conn FIFO order is preserved
  // no matter how queued and direct sends interleave. The shm
  // transport bypasses the ring entirely (its send is already a
  // user-space copy, there is no syscall to batch).
  static constexpr size_t kTxBatch = 64;
  struct TxEntry {
    MsgHeader h;
    std::shared_ptr<const Buf> pin;  // keeps payload bytes alive
  };
  std::deque<TxEntry> tx_q;  // guarded by write_mu
  bool tx_failed = false;    // guarded by write_mu; conn is dying

  bool send_msg_queued(const MsgHeader& h,
                       std::shared_ptr<const Buf> pin) {
    if (ipc || !wire_ring_enabled())
      return send_msg(h, pin ? (const void*)pin->data() : nullptr);
    if (thr) thr->charge(h.len);
    std::lock_guard<Mu> lk(write_mu);
    tx_q.push_back({h, std::move(pin)});
    if (tx_q.size() >= kTxBatch) return flush_locked();
    return true;
  }
  bool tx_flush() {
    std::lock_guard<Mu> lk(write_mu);
    return flush_locked();
  }
  bool flush_locked() {
    if (tx_failed) {
      tx_q.clear();
      return false;
    }
    while (!tx_q.empty()) {
      size_t take = std::min(tx_q.size(), kTxBatch);
      iovec iov[2 * kTxBatch];
      int n = 0;
      uint64_t batch_bytes = 0;
      for (size_t i = 0; i < take; ++i) {
        TxEntry& e = tx_q[i];
        iov[n].iov_base = (void*)&e.h;
        iov[n].iov_len = sizeof(MsgHeader);
        n++;
        batch_bytes += sizeof(MsgHeader) + e.h.len;
        if (e.pin && e.h.len) {
          iov[n].iov_base = (void*)e.pin->data();
          iov[n].iov_len = e.h.len;
          n++;
        }
      }
      if (!send_iovs(fd, iov, n)) {
        tx_failed = true;
        tx_q.clear();
        return false;
      }
      if (stats) {
        stats->tx_batches.fetch_add(1, std::memory_order_relaxed);
        stats->tx_msgs.fetch_add(take, std::memory_order_relaxed);
      }
      lane_tx_bytes.fetch_add(batch_bytes, std::memory_order_relaxed);
      lane_tx_msgs.fetch_add(take, std::memory_order_relaxed);
      tx_q.erase(tx_q.begin(), tx_q.begin() + (long)take);
    }
    return true;
  }

  bool send_msg(const MsgHeader& h, const void* payload) {
    // charge OUTSIDE write_mu: a sleeping throttle must not also block
    // the other engine threads replying on this connection
    if (thr) thr->charge(h.len);
    std::lock_guard<Mu> lk(write_mu);
    if (ipc) return ipc->send_msg(h, payload);
    if (!tx_q.empty() && !flush_locked()) return false;
    if (!send_msg_iov(fd, h, payload)) return false;
    lane_tx_bytes.fetch_add(sizeof(MsgHeader) + h.len,
                            std::memory_order_relaxed);
    lane_tx_msgs.fetch_add(1, std::memory_order_relaxed);
    return true;
  }
  bool recv_bytes(void* p, size_t n) {  // conn-loop thread only
    if (ipc) return ipc->recv(p, n);
    return recv_all(fd, p, n);
  }
  // echo reply (shm only): hand the peer's own pushed block back as
  // the aggregate — 8 bytes on the ring, zero payload copies. The
  // reply "bandwidth" is still throttle-charged: the evidence knob
  // models served bytes, which the peer really does consume.
  bool send_echo(const MsgHeader& h, uint64_t peer_off) {
    if (thr) thr->charge(h.len);
    std::lock_guard<Mu> lk(write_mu);
    if (!ipc) return false;
    return ipc->send_msg_echo(h, peer_off);
  }
  // transport-neutral message entry (conn-loop thread only): on the shm
  // transport an out-of-band payload surfaces as an arena reference; on
  // TCP oob stays empty and the payload follows on the stream.
  bool recv_header(MsgHeader* h, OobRef* oob) {
    if (ipc) return ipc->recv_msg_begin(h, oob);
    oob->ptr = nullptr;
    return recv_all(fd, h, sizeof(*h));
  }
};

// Buffered receive batcher (BYTEPS_WIRE_RING), the rx half of the
// submission-ring plane: one recv() syscall pulls as many buffered wire
// messages as the kernel holds, and headers + small payloads parse out
// of the staging buffer with no further syscalls. Large payloads keep
// the zero-copy tier — the buffered prefix is copied out and the
// REMAINDER is received straight into the final target (direct_buf /
// pooled lease / stripe assembly buffer), so the staging copy is
// bounded by kBigPayload per message. Owned by one conn loop; no locks.
struct RxBuf {
  static constexpr size_t kCap = 256 << 10;
  static constexpr size_t kBigPayload = 16 << 10;
  int fd;
  StageStats* st;
  Buf buf;
  size_t head = 0, tail = 0;
  RxBuf(int f, StageStats* s) : fd(f), st(s) { buf.resize(kCap); }
  size_t avail() const { return tail - head; }
  bool fill() {  // blocks for >=1 fresh byte; false = conn dead/closed
    if (head == tail) {
      head = tail = 0;
    } else if (tail == buf.size()) {
      std::memmove(buf.data(), buf.data() + head, avail());
      tail -= head;
      head = 0;
    }
    ssize_t r = ::recv(fd, buf.data() + tail, buf.size() - tail, 0);
    if (r <= 0) return false;
    tail += (size_t)r;
    if (st) st->rx_batches.fetch_add(1, std::memory_order_relaxed);
    return true;
  }
  bool recv_exact(void* out, size_t n) {
    uint8_t* p = (uint8_t*)out;
    while (n) {
      if (avail() == 0 && !fill()) return false;
      size_t take = std::min(n, avail());
      std::memcpy(p, buf.data() + head, take);
      head += take;
      p += take;
      n -= take;
    }
    return true;
  }
  bool recv_payload(uint8_t* dst, size_t n) {
    size_t pre = std::min(n, avail());
    if (pre) {
      std::memcpy(dst, buf.data() + head, pre);
      head += pre;
    }
    size_t rest = n - pre;
    if (!rest) return true;
    if (rest >= kBigPayload) return recv_all(fd, dst + pre, rest);
    return recv_exact(dst + pre, rest);
  }
};

static inline uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// ------------------------------------------------------------------ //
// observability plane: wire-sampled trace ring + crash flight ring
// ------------------------------------------------------------------ //

// One sampled request's server-side life, the PR-11 stage counters
// DE-aggregated (BYTEPS_TRACE_SAMPLE = record every Nth data request;
// 0 = off). kind 0 is the request span — t0..t3 are recv (header
// seen), enqueue, dequeue (fold start) and handler-done on THIS
// server's steady clock; kind 1 is a reply-send event (t0 = send
// instant, the rest 0) emitted when this rid's aggregate finally
// leaves, which for a parked fused reply is a different engine
// invocation entirely — the worker-side fuser joins the two by
// (rid, sender). Layout is wire contract: drained over TRACE_DRAIN
// and parsed by server/__init__.py TRACE_REC_FMT (byteps-lint
// slot-layout diffs kTraceRecFields against the mirror).
#pragma pack(push, 1)
struct TraceRec {
  uint64_t key;
  uint64_t t0;
  uint64_t t1;
  uint64_t t2;
  uint64_t t3;
  uint32_t rid;
  uint16_t sender;
  uint8_t op;
  uint8_t kind;  // 0 = request span, 1 = reply send
};
#pragma pack(pop)
static_assert(sizeof(TraceRec) == 48, "trace record layout");
// append-only field manifest (bps-lint wire-layout: diffed against the
// Python mirror _TRACE_REC_FIELDS both directions)
static const char* const kTraceRecFields[] = {
    "key", "t0", "t1", "t2", "t3", "rid", "sender", "op", "kind"};

// One structured fault-plane event (always on, bounded, allocation-
// free): replay-dedup hits, codec-tag rejects, chaos injections,
// worker departures, pull aborts — the causal trail a crash dump needs
// where today there is only interleaved stderr. Snapshot-drained over
// FLIGHT_DRAIN (non-destructive: a metrics poll must not steal the
// events a later crash dump wants). Layout is wire contract, mirrored
// by server/__init__.py FLIGHT_REC_FMT.
#pragma pack(push, 1)
struct FlightRec {
  uint64_t ts_ns;
  uint64_t key;
  uint64_t detail;  // kind-specific: round, victim count, rate*1e6...
  uint32_t rid;
  uint16_t sender;
  uint8_t kind;
  uint8_t pad;
};
#pragma pack(pop)
static_assert(sizeof(FlightRec) == 32, "flight record layout");
static const char* const kFlightRecFields[] = {
    "ts_ns", "key", "detail", "rid", "sender", "kind", "pad"};

// One key's post-aggregation health statistics (HEALTH_PULL reply).
// The doubles travel as IEEE-754 bit patterns in u64 fields so the
// record stays fixed-width for the slot-layout lint; the Python mirror
// (server/__init__.py HEALTH_REC_FMT / _HEALTH_REC_FIELDS) reassembles
// them. round = completed_rounds at publish, so a worker can check the
// statistics describe the aggregate it just drained.
#pragma pack(push, 1)
struct HealthRec {
  uint64_t key;
  uint64_t round;
  uint64_t sumsq_bits;   // double bit pattern: sum of squares (finite)
  uint64_t absmax_bits;  // double bit pattern: max |x| (finite)
  uint64_t nonfinite;
  uint64_t elems;
};
#pragma pack(pop)
static_assert(sizeof(HealthRec) == 48, "health record layout");
static const char* const kHealthRecFields[] = {
    "key", "round", "sumsq_bits", "absmax_bits", "nonfinite", "elems"};

// One connection's (data lane's) cumulative wire counters — the
// STRIPE_PULL reply, one record per live conn. sender is ~0 until the
// lane's first data message identifies its worker. Counters are
// CUMULATIVE since accept; readers (the time-series plane's per-step
// sweep) difference them. Layout is wire contract, mirrored by
// server/__init__.py STRIPE_REC_FMT / _STRIPE_REC_FIELDS (byteps-lint
// slot-layout diffs kStripeRecFields against the mirror).
#pragma pack(push, 1)
struct StripeRec {
  uint64_t conn;      // lane id (monotone per accept, stable for life)
  uint64_t sender;    // worker id; ~0 until first message
  uint64_t tx_bytes;  // header+payload bytes sent on this lane
  uint64_t tx_msgs;
  uint64_t rx_bytes;  // header+payload bytes received on this lane
  uint64_t rx_msgs;
  uint64_t seg_count;  // stripe segments reassembled from this lane
  uint64_t seg_bytes;
};
#pragma pack(pop)
static_assert(sizeof(StripeRec) == 64, "stripe record layout");
static const char* const kStripeRecFields[] = {
    "conn", "sender", "tx_bytes", "tx_msgs", "rx_bytes", "rx_msgs",
    "seg_count", "seg_bytes"};
static constexpr size_t kNumStripeRecFields =
    sizeof(kStripeRecFields) / sizeof(kStripeRecFields[0]);

// bps_server_stats / STATS_PULL slot layout — the append-only contract
// with server/__init__.py _STAT_SLOTS, enforced until PR 10 only by a
// comment and now machine-checked: byteps-lint's slot-layout check
// diffs this manifest against the Python mirror both directions, and
// bps_server_stat_name() exposes it at runtime so a test can assert
// the loaded .so agrees with the mirror it was built from.
static const char* const kStatSlotNames[] = {
    "recv_ns", "recv_count", "queue_ns", "queue_count", "fold_ns",
    "fold_count", "fold_bytes", "reply_ns", "reply_count",
    "direct_recvs", "oob_msgs", "simd_tier", "engine_threads",
    "trace_records", "trace_dropped", "flight_records",
    "flight_dropped", "draining", "health_rounds",
    "health_nonfinite", "window_deferred", "window_rejected",
    // PR 17 wire plane: tx/rx submission-ring batching, stripe
    // reassembly, fused lossless decode, transport registration
    "tx_batches", "tx_msgs", "rx_batches", "rx_msgs", "stripe_segs",
    "stripe_bytes", "fused_decode_folds", "reg_blocks", "reg_miss"};
static constexpr size_t kNumStatSlots =
    sizeof(kStatSlotNames) / sizeof(kStatSlotNames[0]);

// Event kinds (wire contract; server/__init__.py FLIGHT_KIND_NAMES).
enum FlightKind : uint8_t {
  kFlightReplayDedup = 1,
  kFlightCodecReject = 2,
  kFlightChaosDrop = 3,
  kFlightWorkerDeparted = 4,
  kFlightPullAbort = 5,
  kFlightUnknownOp = 6,
  // a stamped fold carrying a different round than the one that opened
  // this aggregation round — the multi-worker partial-reply-window
  // hazard, rejected loudly instead of silently mis-summed
  kFlightRoundSkew = 7,
  // this server was told to drain (DRAIN_REQ): it should receive no
  // further data traffic once the workers migrated its keys away
  kFlightDrained = 8,
};

// Control-pull reply size limits — wire contract: the CLIENT sizes its
// reply buffers from the mirror (server/client.py WIRE_CTRL_LIMITS,
// machine-checked by the slot-layout lint), and an oversized reply is
// drained-not-delivered by the recv loop (silently empty drains). The
// trace drain pages in kCtrlDrainBatch batches (destructive: the
// client loops until short); the flight snapshot is one shot, so its
// cap must cover a whole default ring.
enum CtrlLimits : uint32_t {
  kCtrlDrainBatch = 1024,
  kCtrlFlightDrainMax = 4096,
  // STRIPE_PULL reply cap: one StripeRec per live conn; a fleet's
  // worker*stripe fan-in stays far under this.
  kCtrlStripeMax = 64,
};

// Fixed-capacity drop-oldest ring, preallocated at construction — the
// record path after warmup is one small mutex + a slot store (the
// trace path is sampled and the flight path is rare, so a leaf mutex
// beats a lock-free scheme nobody can audit). Readers either CONSUME
// (trace: each span fuses once) or SNAPSHOT (flight: the crash dump
// must still see what a poll already read).
template <typename Rec>
class EventRing {
 public:
  explicit EventRing(size_t cap) : cap_(cap < 16 ? 16 : cap) {
    buf_.resize(cap_);
  }

  void push(const Rec& r) {
    std::lock_guard<Mu> lk(mu_);
    buf_[w_ % cap_] = r;
    ++w_;
    ++total_;
    if (w_ - r_ > cap_) {
      dropped_ += (w_ - r_) - cap_;
      r_ = w_ - cap_;
    }
  }

  // Copy up to max_recs records into out; consume=true advances the
  // read cursor (trace: the client loops batches until the ring is
  // empty), false leaves the ring intact (flight) and returns the
  // NEWEST window — a crash dump that cannot take everything must get
  // the events nearest the crash, not the oldest survivors.
  size_t drain(Rec* out, size_t max_recs, bool consume) {
    std::lock_guard<Mu> lk(mu_);
    size_t avail = w_ - r_;
    size_t n = avail < max_recs ? avail : max_recs;
    uint64_t start = consume ? r_ : (w_ - n);
    for (size_t i = 0; i < n; ++i) out[i] = buf_[(start + i) % cap_];
    if (consume) r_ += n;
    return n;
  }

  uint64_t total() const {
    std::lock_guard<Mu> lk(mu_);
    return total_;
  }
  uint64_t dropped() const {
    std::lock_guard<Mu> lk(mu_);
    return dropped_;
  }

 private:
  size_t cap_;
  mutable Mu mu_;
  std::vector<Rec> buf_;  // guarded-by: mu_ (preallocated, never grows)
  uint64_t w_ = 0;        // guarded-by: mu_
  uint64_t r_ = 0;        // guarded-by: mu_
  uint64_t total_ = 0;    // guarded-by: mu_
  uint64_t dropped_ = 0;  // guarded-by: mu_
};

struct ParkedPull {
  std::shared_ptr<Conn> conn;
  uint32_t rid = 0;
  uint16_t sender = 0;
  bool compressed = false;
  // trace carry: the request was wire-sampled, so the (possibly much
  // later) reply send emits its kind-1 TraceRec — rid-joined with the
  // request span by the worker-side fuser
  uint8_t traced = 0;
  // key carried for the flight/trace planes (a chaos-dropped reply
  // names the partition it starved, rid+key-matchable worker-side)
  uint64_t key = 0;
  // round this pull must be answered WITH (epoch >> 16 of the fused
  // push; 0 = unstamped/two-op -> positional semantics). Under the
  // cross-barrier window two rounds of one key can be parked at once,
  // and round R's requester must get round R's aggregate even after
  // R+1 published over pub/pub_wire (KeyStore::pub_hist).
  uint64_t round = 0;
  ParkedPull() = default;
  // explicit ctor (not aggregate init): trailing fields grew twice now
  // and -Wmissing-field-initializers + 10 brace sites is exactly the
  // drift the ReplyHeader() factory exists to avoid
  ParkedPull(std::shared_ptr<Conn> c, uint32_t r, uint16_t s,
             bool comp = false, uint8_t tr = 0, uint64_t k = 0,
             uint64_t rnd = 0)
      : conn(std::move(c)), rid(r), sender(s), compressed(comp),
        traced(tr), key(k), round(rnd) {}
};

struct EngineMsg;  // defined below; KeyStore::deferred parks copies

struct KeyStore {
  Mu mu;                 // per-key lock: sums/copies of different
                                 // keys must not serialize each other
  Buf accum;                     // receiving buffer for the current round
  Buf merged;                    // async-mode authoritative weights
                                 // (mutated in place per push; sync-mode
                                 // pulls are served from `pub` instead)
  // Zero-copy recv tier: the conn loop reserves this buffer under `mu`
  // (direct_inflight guards a single reservation per key), receives
  // the payload INTO it off-lock, and the engine adopts it by move —
  // for the first push of a round the received bytes BECOME the
  // accumulator with no copy and no allocation (buffers rotate
  // direct_buf -> accum -> pub -> pool).
  Buf direct_buf;                // guarded-by: mu (reservation)
  bool direct_inflight = false;  // guarded-by: mu
  uint32_t len = 0;
  uint32_t dtype = F32;
  uint32_t init_count = 0;       // init pushes seen
  bool init_done = false;        // the init barrier completed once: later
                                 // same-length inits (elastic reconnect)
                                 // ACK immediately instead of re-parking
  std::vector<ParkedPull> parked_inits;
  uint32_t recv_count = 0;       // pushes folded this round
  uint64_t completed_rounds = 0;
  std::vector<uint64_t> worker_push_count;  // per worker
  // Replay dedup: highest epoch ROUND folded per worker. A stamped push
  // whose round is <= this is a retry of work already summed (the
  // reply was dropped / the requester timed out) — it must be answered
  // but NEVER folded again (the idempotence guarantee,
  // docs/fault-tolerance.md). Reset to 0 per worker on re-init and on
  // departure rollback, so a resumed/re-pushing worker's restarted
  // round numbering folds normally.
  std::vector<uint64_t> last_round;
  // set per worker when a departure aborts a round that worker had
  // already pushed: its next pull must error (retry) instead of being
  // served the PREVIOUS round's aggregate as if it were the new one
  std::vector<uint8_t> pull_abort;
  std::vector<ParkedPull> parked_pulls;
  // atomic: the conn-loop thread reads it for priority under stores_mu_
  // while engine threads increment under ks.mu — different mutexes, so
  // the field itself must carry the synchronization
  std::atomic<uint64_t> total_pushes{0};  // for priority scheduling
  // compression mirror (server.cc:92-118): set by COMP_INIT
  CompressorCfg comp;
  // Codec tag latched by the current round's FIRST fold (MsgHeader::
  // codec; 0 = round opened untagged). A later fold of the same round
  // carrying a different tag — codec id OR plan epoch — is rejected
  // loudly instead of summed: the adaptive plane's aggregation-safety
  // net. Reset at every ALL_RECV / rollback / re-init.
  uint32_t round_codec = 0;
  // Round number latched by the current aggregation round's FIRST
  // stamped fold (epoch >> 16; 0 = round opened unstamped). A later
  // sync-mode fold of the SAME positional round carrying a DIFFERENT
  // round number means the workers are folding different training
  // rounds into one aggregate — the multi-worker partial-reply-window
  // hazard after a migration (docs/fault-tolerance.md): rejected
  // loudly instead of silently mis-summed. Re-latched whenever
  // recv_count returns to 0 (ALL_RECV / rollback / re-init).
  uint64_t round_open = 0;
  std::vector<int32_t> round_idx;     // randomk: this round's indices
  std::vector<float> scratch;         // decompress buffer
  // randomk homomorphic fast path: the round's aggregate in WIRE form
  // ([k idx][k vals], vals summed in place). Non-empty only while a
  // fast-path round is in flight.
  Buf wire_accum;
  // Published aggregates (sync mode): swapped atomically under `mu` at
  // ALL_RECV, NEVER mutated afterwards — pulls send straight from the
  // shared buffer with no per-request copy (the reference caches per-key
  // response buffers for the same reason, server.cc:39-80); the refcount
  // keeps a buffer alive across an in-flight send when the next round
  // publishes a replacement.
  std::shared_ptr<const Buf> pub;       // dense
  std::shared_ptr<const Buf> pub_wire;  // compressed
  // Training-health statistics of the last PUBLISHED aggregate
  // (BYTEPS_HEALTH; guarded-by: mu). Overwritten at every publish,
  // served over HEALTH_PULL.
  HStat hstat;
  // ---- cross-barrier bounded-staleness window (BYTEPS_STALENESS) --- //
  // Stamped folds carrying a round AHEAD of the one currently
  // accepting — within window W — are PARKED here in owned storage and
  // redispatched when their round becomes current (publish of the
  // round before them). They are NEVER folded early, so a mis-sum of
  // two training rounds stays impossible by construction; rounds still
  // complete strictly in order. One entry per (sender, round), bounded
  // by W x num_workers; empty whenever the window is 0.
  std::vector<EngineMsg> deferred;  // guarded-by: mu
  // Round number of the newest PUBLISHED aggregate (0 = the last round
  // completed unstamped). Round-stamped parked pulls become answerable
  // when this reaches their round — positional push-count bookkeeping
  // can't distinguish two parked rounds of one key.
  uint64_t pub_round = 0;           // guarded-by: mu
  // Published-aggregate history (the W+1 newest rounds, oldest first):
  // a parked pull for round R must be answered with ROUND R's
  // aggregate even after R+1 published over pub/pub_wire. Populated
  // only when the server's window is nonzero.
  struct PubHist {
    uint64_t round;
    std::shared_ptr<const Buf> pub;
    std::shared_ptr<const Buf> pub_wire;
  };
  std::vector<PubHist> pub_hist;    // guarded-by: mu
};

struct EngineMsg {
  uint8_t op;
  uint64_t key;
  uint32_t req = 0;              // RequestType from cmd
  uint32_t dtype;
  uint32_t rid;
  uint16_t sender;
  uint64_t epoch = 0;            // (round << 16) | attempt; 0 = unstamped
  uint32_t codec = 0;            // (plan_epoch << 8) | codec id; 0 = untagged
  Buf payload;                   // push data (owned; pooled)
  // Out-of-band payload (shm descriptor tier): the bytes live in the
  // peer's arena and are read IN PLACE by the fold; released through
  // oob_chan after the handler runs. Mutually exclusive with payload.
  const uint8_t* oob = nullptr;
  uint32_t oob_len = 0;
  uint64_t oob_off = 0;
  IpcChan* oob_chan = nullptr;  // kept alive by `conn`
  // Direct-recv tier: the payload was received straight into the key's
  // reserved recv buffer (KeyStore::direct_buf) by the conn loop; the
  // engine adopts it under ks.mu before dispatch.
  bool direct = false;
  uint64_t enq_ns = 0;  // queue-wait stage timestamp
  // wire-sampled trace span (BYTEPS_TRACE_SAMPLE): recv_ns stamps the
  // header's arrival in the conn loop, deq_ns the engine dequeue; the
  // handler-done stamp closes the kind-0 TraceRec in EngineLoop
  uint8_t traced = 0;
  uint64_t recv_ns = 0;
  uint64_t deq_ns = 0;
  std::shared_ptr<Conn> conn;

  const uint8_t* data() const { return oob ? oob : payload.data(); }
  size_t size() const { return oob ? oob_len : payload.size(); }
};

class EngineQueue {
 public:
  explicit EngineQueue(bool priority) : priority_(priority) {}

  void push(EngineMsg&& m, uint64_t prio) {
    {
      std::lock_guard<Mu> lk(mu_);
      q_.push({prio, seq_++, std::move(m)});
    }
    cv_.notify_one();
  }

  bool wait_pop(EngineMsg* out) {
    std::unique_lock<Mu> lk(mu_);
    cv_.wait(lk, [&] { return stop_ || !q_.empty(); });
    if (q_.empty()) return false;
    // const_cast is safe: we pop immediately after moving
    *out = std::move(const_cast<Item&>(q_.top()).msg);
    q_.pop();
    return true;
  }

  // Nonblocking pop — the engine loop uses an empty queue as the
  // submission-ring flush boundary (a batch of queued replies is one
  // sendmsg once no further work is immediately runnable).
  bool try_pop(EngineMsg* out) {
    std::lock_guard<Mu> lk(mu_);
    if (q_.empty()) return false;
    *out = std::move(const_cast<Item&>(q_.top()).msg);
    q_.pop();
    return true;
  }

  void stop() {
    {
      std::lock_guard<Mu> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
  }

 private:
  struct Item {
    uint64_t prio;  // lower = first (push count when scheduling enabled)
    uint64_t seq;
    EngineMsg msg;
    bool operator<(const Item& o) const {
      if (prio != o.prio) return prio > o.prio;  // min-heap on prio
      return seq > o.seq;                        // FIFO within a level
    }
  };
  bool priority_;
  Mu mu_;
  Cv cv_;
  std::priority_queue<Item> q_;
  uint64_t seq_ = 0;
  bool stop_ = false;
};

// RDMA-shaped transport registration: every BufPool block is
// "registered" with the transport at allocation time — exactly where an
// RDMA provider would pin and key the memory. On TCP the registry is a
// range map plus two counters, but it makes the recv path
// registration-STABLE: reg_blocks plateaus once the pool warmed up
// (steady state allocates nothing new) and reg_miss counts recv targets
// a real NIC would have had to pin on the critical path (~0 after
// warmup is the signal a provider could rely on).
class TransportReg {
 public:
  void add(const void* base, size_t cap, StageStats* st) {
    std::lock_guard<Mu> lk(mu_);
    if (blocks_.size() >= kMaxBlocks) blocks_.clear();
    bool fresh = blocks_.insert_or_assign((uintptr_t)base, cap).second;
    if (fresh && st) st->reg_blocks.fetch_add(1, std::memory_order_relaxed);
  }
  // containing-range lookup: is [ptr, ptr+n) inside a registered block?
  bool covers(const void* ptr, size_t n) const {
    uintptr_t p = (uintptr_t)ptr;
    std::lock_guard<Mu> lk(mu_);
    auto it = blocks_.upper_bound(p);
    if (it == blocks_.begin()) return false;
    --it;
    return p >= it->first && p + n <= it->first + it->second;
  }
  void check(const void* ptr, size_t n, StageStats* st) const {
    if (!covers(ptr, n) && st)
      st->reg_miss.fetch_add(1, std::memory_order_relaxed);
  }

 private:
  static constexpr size_t kMaxBlocks = 8192;
  mutable Mu mu_;
  std::map<uintptr_t, size_t> blocks_;  // base -> capacity
};

class Server {
 public:
  Server(int port, int num_workers, int num_engine_threads, bool async_mode,
         bool enable_schedule, int64_t debug_key = -1)
      : port_(port), num_workers_(num_workers),
        async_(async_mode), schedule_(enable_schedule),
        debug_key_(debug_key),
        // per-Server fold tier (BYTEPS_SIMD; like Throttle/Chaos, read
        // per instance so SIMD and scalar servers coexist in one test
        // process)
        kernels_(resolve_fold_kernels(::getenv("BYTEPS_SIMD"))),
        // observability plane, read per instance like the chaos knobs:
        // BYTEPS_TRACE_SAMPLE = record every Nth data request into the
        // trace ring (0 = off); ring capacities bound the footprint
        trace_sample_([] {
          const char* e = ::getenv("BYTEPS_TRACE_SAMPLE");
          long v = e && *e ? std::atol(e) : 0;
          return v < 0 ? 0L : v;
        }()),
        trace_ring_([] {
          const char* e = ::getenv("BYTEPS_TRACE_RING");
          long v = e && *e ? std::atol(e) : 4096;
          return (size_t)(v < 16 ? 16 : v);
        }()),
        flight_ring_([] {
          const char* e = ::getenv("BYTEPS_FLIGHT_RING");
          long v = e && *e ? std::atol(e) : 2048;
          return (size_t)(v < 16 ? 16 : v);
        }()),
        // training-health in-fold statistics pass (BYTEPS_HEALTH, read
        // per instance like the chaos/SIMD knobs so health-on and
        // health-off servers coexist in one test process); off by
        // default — the pass then does not run at all
        health_([] {
          const char* e = ::getenv("BYTEPS_HEALTH");
          return e && *e && std::strcmp(e, "0") != 0;
        }()),
        // cross-barrier staleness window (read per instance like the
        // chaos knobs, so an A/B bench can run windowed and strict
        // servers in one process): BYTEPS_STALENESS wins when set;
        // otherwise BYTEPS_CROSS_BARRIER implies its default of 1.
        // 0 = today's strict RoundAligned gate, bit-for-bit.
        window_([] {
          const char* e = ::getenv("BYTEPS_STALENESS");
          if (e && *e) {
            long v = std::atol(e);
            return (uint64_t)(v < 0 ? 0 : v > 8 ? 8 : v);
          }
          const char* x = ::getenv("BYTEPS_CROSS_BARRIER");
          return (uint64_t)(x && *x && std::strcmp(x, "0") != 0 ? 1 : 0);
        }()),
        // decompress-on-the-fabric (BYTEPS_FUSED_DECODE, default on;
        // per instance so the bitwise A/B test runs fused and legacy
        // servers in one process): LOSSLESS pushes decode straight into
        // the accumulator / fold instead of a scratch pass + copy
        fused_decode_([] {
          const char* e = ::getenv("BYTEPS_FUSED_DECODE");
          return !(e && *e && (*e == '0' || *e == 'f' || *e == 'F'));
        }()) {
    // RDMA-shaped registration: pin every pool block as it is carved,
    // off the recv critical path
    pool_.set_alloc_hook([this](const void* base, size_t cap) {
      reg_.add(base, cap, &stats_);
    });
    n_engines_ = num_engine_threads < 1 ? 1 : num_engine_threads;
    engine_bytes_.reset(new std::atomic<uint64_t>[n_engines_]);
    for (int i = 0; i < n_engines_; ++i) {
      engine_bytes_[i].store(0);
      queues_.emplace_back(new EngineQueue(enable_schedule));
    }
    for (int i = 0; i < n_engines_; ++i) {
      engine_threads_.emplace_back([this, i] { EngineLoop(i); });
    }
  }

  // -- introspection (C ABI / metrics mirror) ----------------------- //
  const StageStats& stats() const { return stats_; }
  int simd_tier() const { return kernels_.tier; }
  int num_engines() const { return n_engines_; }

  // THE one slot-vector definition, shared by bps_server_stats (in-
  // process mirror) and the STATS_PULL wire reply so the two surfaces
  // cannot drift. Order is the append-only kStatSlotNames contract.
  int stat_slots(uint64_t* out, int max_n) const {
    const StageStats& st = stats_;
    uint64_t v[kNumStatSlots] = {
        st.recv_ns.load(),      st.recv_count.load(),
        st.queue_ns.load(),     st.queue_count.load(),
        st.fold_ns.load(),      st.fold_count.load(),
        st.fold_bytes.load(),   st.reply_ns.load(),
        st.reply_count.load(),  st.direct_recvs.load(),
        st.oob_msgs.load(),     (uint64_t)simd_tier(),
        (uint64_t)n_engines_,   trace_ring_.total(),
        trace_ring_.dropped(),  flight_ring_.total(),
        flight_ring_.dropped(), draining_.load() ? 1ull : 0ull,
        health_rounds_.load(),  health_nonfinite_.load(),
        window_deferred_.load(), window_rejected_.load(),
        st.tx_batches.load(),   st.tx_msgs.load(),
        st.rx_batches.load(),   st.rx_msgs.load(),
        st.stripe_segs.load(),  st.stripe_bytes.load(),
        st.fused_decode_folds.load(), st.reg_blocks.load(),
        st.reg_miss.load()};
    int n = max_n < (int)kNumStatSlots ? max_n : (int)kNumStatSlots;
    for (int i = 0; i < n; ++i) out[i] = v[i];
    return n;
  }
  uint64_t engine_fold_bytes(int i) const {
    return (i >= 0 && i < n_engines_)
               ? engine_bytes_[i].load(std::memory_order_relaxed)
               : 0;
  }

  // THE one per-lane record vector, shared by bps_server_stripe_stats
  // (in-process mirror) and the STRIPE_PULL wire reply. One StripeRec
  // per live conn, kStripeRecFields order; expired registry entries
  // (conn thread and every parked pull gone) are pruned in passing.
  int StripeSlots(StripeRec* out, int max_n) {
    std::lock_guard<Mu> lk(conns_mu_);
    int n = 0;
    for (size_t i = 0; i < all_conns_.size();) {
      std::shared_ptr<Conn> c = all_conns_[i].lock();
      if (!c) {
        all_conns_[i] = std::move(all_conns_.back());
        all_conns_.pop_back();
        continue;
      }
      if (!c->dead.load(std::memory_order_relaxed) && n < max_n) {
        StripeRec& r = out[n++];
        int snd = c->sender.load(std::memory_order_relaxed);
        r.conn = c->lane_id;
        r.sender = snd < 0 ? ~0ull : (uint64_t)snd;
        r.tx_bytes = c->lane_tx_bytes.load(std::memory_order_relaxed);
        r.tx_msgs = c->lane_tx_msgs.load(std::memory_order_relaxed);
        r.rx_bytes = c->lane_rx_bytes.load(std::memory_order_relaxed);
        r.rx_msgs = c->lane_rx_msgs.load(std::memory_order_relaxed);
        r.seg_count = c->lane_seg_count.load(std::memory_order_relaxed);
        r.seg_bytes = c->lane_seg_bytes.load(std::memory_order_relaxed);
      }
      ++i;
    }
    return n;
  }

  // In-process mirror of the HEALTH_PULL reply (bps_server_key_health):
  // fills {round, sumsq_bits, absmax_bits, nonfinite, elems}. Returns
  // false when the key is unknown or the health pass is off. The map
  // lock is released BEFORE taking ks.mu (the TryReserveDirect
  // pattern; stores_ never erases, so the pointer stays valid) — a
  // health poll waiting out a multi-MB fold must stall only its key,
  // never the whole key map.
  bool KeyHealth(uint64_t key, uint64_t out[5]) {
    if (!health_) return false;
    KeyStore* ks = nullptr;
    {
      std::lock_guard<Mu> lk(stores_mu_);
      auto it = stores_.find(key);
      if (it == stores_.end()) return false;
      ks = &it->second;
    }
    std::lock_guard<Mu> lk2(ks->mu);
    const HStat& h = ks->hstat;
    out[0] = h.round;
    std::memcpy(&out[1], &h.sumsq, 8);
    std::memcpy(&out[2], &h.absmax, 8);
    out[3] = h.nonfinite;
    out[4] = h.elems;
    return true;
  }

  int Run() {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    ::setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)port_);
    if (::bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) != 0) {
      std::perror("[bps-server] bind");
      ::close(listen_fd_);
      listen_fd_ = -1;
      // stop + join the engine threads: returning with them joinable
      // would std::terminate in the destructor instead of surfacing
      // rc=1 to the caller
      Join();
      return 1;
    }
    ::listen(listen_fd_, 64);
    while (!shutting_down_.load()) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) break;
      tune_socket(fd);
      auto conn = std::make_shared<Conn>();
      conn->fd = fd;
      conn->thr = &throttle_;
      conn->lane_id = lane_seq_.fetch_add(1, std::memory_order_relaxed);
      {
        // per-lane registry (STRIPE_PULL): weak refs — lifetime stays
        // with the conn thread / parked pulls; StripeSlots prunes
        std::lock_guard<Mu> lk(conns_mu_);
        all_conns_.emplace_back(conn);
      }
      // Conn threads self-reap: detached, with a shared tracker Join()
      // waits on. A worker that suspends (elastic close without SHUTDOWN,
      // client.py close(shutdown_servers=False)) ends its conn thread while
      // the server keeps serving — a joinable-until-Join thread would leak
      // (finished, never reaped) for the server's whole lifetime. The
      // tracker is a shared_ptr so the epilogue never touches `this` after
      // its decrement (the Server may be destroyed right after Join()).
      auto trk = conn_tracker_;
      {
        std::lock_guard<Mu> lk(trk->mu);
        trk->live++;
      }
      std::thread([this, conn, trk] {
        ConnLoop(conn);
        std::lock_guard<Mu> lk(trk->mu);
        trk->live--;
        trk->cv.notify_all();
      }).detach();
    }
    Join();
    return 0;
  }

  void Join() {
    for (auto& q : queues_) q->stop();
    for (auto& t : engine_threads_)
      if (t.joinable()) t.join();
    std::unique_lock<Mu> lk(conn_tracker_->mu);
    conn_tracker_->cv.wait(lk, [this] { return conn_tracker_->live == 0; });
  }

 private:
  int ThreadForKey(uint64_t key, uint32_t len) {
    // Assign new keys to the least-loaded engine by CUMULATIVE folded
    // bytes (reference: server.h:154-178). The table accumulates every
    // queued payload — not just each key's first message — so a key
    // arriving after traffic has skewed the engines lands away from
    // the hot one. The old assignment-time-only accounting tied on
    // equal init lengths and could co-locate a new heavy key with an
    // already-hot engine (tests/test_native_plane.py pins the one-hot
    // case). Placement stays static per key (migration would reorder
    // a key's folds across engine queues).
    // Accounting lives HERE, for assigned and fresh keys alike (every
    // message already holds assign_mu_ for the map lookup): one add per
    // queued payload, never double-counted with a caller-side add.
    std::lock_guard<Mu> lk(assign_mu_);
    auto it = key_thread_.find(key);
    if (it != key_thread_.end()) {
      engine_bytes_[it->second].fetch_add(len, std::memory_order_relaxed);
      return it->second;
    }
    int best = 0;
    for (int i = 1; i < n_engines_; ++i)
      if (engine_bytes_[i].load(std::memory_order_relaxed) <
          engine_bytes_[best].load(std::memory_order_relaxed))
        best = i;
    engine_bytes_[best].fetch_add(len, std::memory_order_relaxed);
    key_thread_[key] = best;
    return best;
  }

  // Attempt the zero-copy direct-recv reservation for a dense
  // steady-state push: under ks.mu, claim the key's recv buffer so the
  // payload lands straight in the bytes that will become (or fold
  // into) the accumulator. Returns false (caller uses the pooled path)
  // when the key is unknown/mismatched, compressed, async, or another
  // direct recv is already in flight on it.
  bool TryReserveDirect(const MsgHeader& h, uint32_t req, uint32_t dtype,
                        uint8_t** dst) {
    if (async_ || req != kDefaultPushPull || h.len == 0) return false;
    KeyStore* ksp;
    {
      std::lock_guard<Mu> lk(stores_mu_);
      auto it = stores_.find(h.key);
      if (it == stores_.end()) return false;
      ksp = &it->second;  // stable: stores_ never erases
    }
    std::lock_guard<Mu> lk(ksp->mu);
    if (ksp->direct_inflight || ksp->len != h.len ||
        ksp->dtype != dtype || !ksp->init_done ||
        ksp->comp.type != CompressorCfg::NONE)
      return false;
    if (ksp->direct_buf.size() != h.len) {
      if (ksp->direct_buf.capacity() < h.len)
        ksp->direct_buf = pool_.lease(h.len);
      else
        ksp->direct_buf.resize(h.len);
    }
    ksp->direct_inflight = true;
    *dst = ksp->direct_buf.data();
    return true;
  }

  void ClearDirect(uint64_t key) {
    KeyStore& ks = store_of(key);
    std::lock_guard<Mu> lk(ks.mu);
    ks.direct_inflight = false;
  }

  void ConnLoop(std::shared_ptr<Conn> conn) {
    conn->stats = &stats_;  // tx submission-ring accounting
    // rx half of the submission ring: one recv() syscall pulls as many
    // buffered wire messages as the kernel holds. TCP only — a conn
    // upgraded to shm keeps its own ring, and the switch is safe
    // because no TCP bytes ever follow IPC_CONFIRM (the staging buffer
    // is empty at the moment ipc engages).
    RxBuf rx(conn->fd, &stats_);
    const bool use_rx = wire_ring_enabled();
    auto next_msg = [&](MsgHeader* hh, OobRef* oo) {
      if (use_rx && !conn->ipc) {
        oo->ptr = nullptr;
        if (!rx.recv_exact(hh, sizeof(*hh))) return false;
        stats_.rx_msgs.fetch_add(1, std::memory_order_relaxed);
        return true;
      }
      return conn->recv_header(hh, oo);
    };
    auto recv_payload = [&](uint8_t* dst, size_t n) {
      if (use_rx && !conn->ipc) return rx.recv_payload(dst, n);
      return conn->recv_bytes(dst, n);
    };
    MsgHeader h;
    OobRef oob;
    while (next_msg(&h, &oob)) {
      if (h.magic != kMagic) {
        std::fprintf(stderr, "[bps-server] bad magic %08x\n", h.magic);
        break;
      }
      // per-lane rx accounting (time-series plane): conn-loop thread
      // only, so plain relaxed adds; covers segment messages too
      conn->lane_rx_msgs.fetch_add(1, std::memory_order_relaxed);
      conn->lane_rx_bytes.fetch_add(sizeof(MsgHeader) + h.len,
                                    std::memory_order_relaxed);
      if (conn->sender.load() < 0) {
        conn->sender.store((int)h.sender);
        std::lock_guard<Mu> lk(worker_conns_mu_);
        worker_conns_[(int)h.sender]++;
        // a reconnect (elastic resume) clears the clean-exit mark; stale
        // messages from before the death are fenced by their own (dead)
        // Conn, not by worker id
        clean_exit_.erase((int)h.sender);
      }
      // striped data message: the payload is a SegHdr-framed chunk of a
      // larger (sender, key, seq) message being reassembled across this
      // sender's data conns; never reaches the engine as-is
      if ((h.flags & kFlagSeg) && !oob.ptr) {
        if ((h.op != PUSH && h.op != PUSHPULL) || conn->ipc ||
            !HandleSegment(conn, h, rx, use_rx)) {
          std::fprintf(stderr, "[bps-server] bad stripe segment\n");
          break;
        }
        continue;
      }
      EngineMsg m;
      m.op = h.op;
      m.key = h.key;
      m.rid = h.rid;
      m.sender = h.sender;
      m.epoch = h.epoch;
      m.codec = h.codec;
      m.conn = conn;
      uint32_t req, dtype;
      decode_cmd(h.cmd, &req, &dtype);
      m.req = req;
      m.dtype = dtype;
      // wire-sampled trace span (BYTEPS_TRACE_SAMPLE = every Nth data
      // request): stamp arrival BEFORE the payload recv, so the span's
      // recv stage covers the payload transfer the aggregate recv_ns
      // counter also measures
      if (trace_sample_ > 0 &&
          (h.op == PUSH || h.op == PULL || h.op == PUSHPULL) &&
          trace_seq_.fetch_add(1, std::memory_order_relaxed) %
                  (uint64_t)trace_sample_ == 0) {
        m.traced = 1;
        m.recv_ns = now_ns();
      }
      if (oob.ptr) {
        // descriptor tier: the payload already sits in the shared
        // arena — no recv, no copy; the engine folds from it in place
        m.oob = oob.ptr;
        m.oob_len = oob.len;
        m.oob_off = oob.off;
        m.oob_chan = conn->ipc.get();
        stats_.oob_msgs.fetch_add(1, std::memory_order_relaxed);
        throttle_.charge(h.len);
      } else if (h.len) {
        uint64_t t0 = now_ns();
        uint8_t* direct_dst = nullptr;
        if ((h.op == PUSH || h.op == PUSHPULL) &&
            TryReserveDirect(h, req, dtype, &direct_dst)) {
          // zero-copy tier: the payload lands straight in the key's
          // reserved recv buffer, which the engine will adopt as (or
          // fold into) the accumulator
          reg_.check(direct_dst, h.len, &stats_);
          if (!recv_payload(direct_dst, h.len)) {
            ClearDirect(h.key);  // the key must not stay reserved
            break;
          }
          m.direct = true;
          stats_.direct_recvs.fetch_add(1, std::memory_order_relaxed);
        } else {
          m.payload = pool_.lease(h.len);
          reg_.check(m.payload.data(), h.len, &stats_);
          if (!recv_payload(m.payload.data(), h.len)) break;
        }
        stats_.recv_ns.fetch_add(now_ns() - t0,
                                 std::memory_order_relaxed);
        stats_.recv_count.fetch_add(1, std::memory_order_relaxed);
        throttle_.charge(h.len);  // ingress side of the bandwidth cap
      }
      if (h.op == IPC_HELLO) {
        HandleIpcHello(conn, h.rid, m.payload);
        continue;
      }
      if (h.op == IPC_CONFIRM) {
        // 3rd handshake leg: only NOW move the conn onto the rings. A
        // client that timed out waiting for the ACK never sends this,
        // so a late ACK cannot split the transport (client on TCP,
        // server on shm). write_mu: engine threads read `ipc` in
        // send_msg.
        std::lock_guard<Mu> lk(conn->write_mu);
        if (conn->ipc_pending) conn->ipc = std::move(conn->ipc_pending);
        continue;
      }
      if (conn->ipc_pending) {
        // any other message while the upgrade is pending means the
        // client declined (never confirmed) and moved on over TCP
        conn->ipc_pending.reset();
        std::fprintf(stderr,
                     "[bps-server] ipc upgrade abandoned (no confirm)\n");
      }
      if (h.op == CLOCK_PROBE) {
        HandleClockProbe(conn, h.rid);
        continue;
      }
      if (h.op == STATS_PULL || h.op == TRACE_DRAIN ||
          h.op == FLIGHT_DRAIN || h.op == JOIN_PROBE ||
          h.op == DRAIN_REQ || h.op == HEALTH_PULL ||
          h.op == STRIPE_PULL) {
        HandleControlPull(conn, h.rid, h.op, h.sender, h.key);
        continue;
      }
      if (h.op == BARRIER) {
        HandleBarrier(std::move(m));
        continue;
      }
      if (h.op == SHUTDOWN) {
        HandleShutdown(std::move(m));
        break;
      }
      EnqueueData(std::move(m), h.len);
    }
    // Failure detection (beyond the reference, which has none —
    // SURVEY.md §5.3): when the LAST connection of a worker closes and
    // the server is not shutting down, presume the worker dead/suspended
    // and fail every parked request immediately, so surviving workers
    // get an error in milliseconds instead of wedging on a sync round
    // that can never complete until their client timeout fires.
    if (conn->ipc) conn->ipc->mark_broken();  // fail engine sends too
    conn->dead.store(true);
    int snd = conn->sender.load();
    if (snd >= 0) {
      bool departed = false;
      {
        std::lock_guard<Mu> lk(worker_conns_mu_);
        if (--worker_conns_[snd] == 0) {
          worker_conns_.erase(snd);
          // a worker that announced SHUTDOWN is exiting cleanly: its
          // conn closures are expected, not a failure
          if (!clean_exit_.count(snd)) departed = true;
        }
      }
      // any conn death invalidates in-flight stripe assemblies of this
      // sender (a lost segment can never arrive) and resyncs its seq
      // gate so the surviving stripes don't wedge behind the gap
      StripeReset((uint16_t)snd, departed);
      if (departed && !shutting_down_.load()) OnWorkerDeparted(snd);
    }
  }

  // Shared dispatch tail for data messages — conn loops and the stripe
  // reassembly path both funnel here. ThreadForKey also accumulates
  // `len` into engine_bytes_: the placement signal AND the balance
  // proof surface (bps_server_engine_bytes).
  void EnqueueData(EngineMsg&& m, uint32_t len) {
    uint64_t prio = 0;
    if (schedule_) {
      std::lock_guard<Mu> lk(stores_mu_);
      auto it = stores_.find(m.key);
      // fewer completed pushes -> earlier (queue.h:31-105)
      prio = it == stores_.end()
                 ? 0
                 : it->second.total_pushes.load(std::memory_order_relaxed);
    }
    int eng = ThreadForKey(m.key, len);
    m.enq_ns = now_ns();
    queues_[eng]->push(std::move(m), prio);
  }

  // One striped segment: [MsgHeader (kFlagSeg)][SegHdr][chunk]. The
  // chunk is received straight into the shared assembly buffer
  // (disjoint [off, off+chunk) ranges, written OUTSIDE stripe_mu_); the
  // conn loop that lands the LAST segment rebuilds the message and
  // dispatches it through the (sender, key) seq gate. Returns false
  // only on protocol violation / dead conn (caller closes).
  bool HandleSegment(const std::shared_ptr<Conn>& conn, const MsgHeader& h,
                     RxBuf& rx, bool use_rx) {
    SegHdr sh;
    if (h.len < sizeof(SegHdr)) return false;
    if (!(use_rx ? rx.recv_exact(&sh, sizeof(sh))
                 : conn->recv_bytes(&sh, sizeof(sh))))
      return false;
    uint64_t chunk = (uint64_t)h.len - sizeof(SegHdr);
    if (sh.nseg == 0 || sh.nseg > kMaxSegs || sh.idx >= sh.nseg ||
        sh.total == 0 || sh.total > kMaxStripeTotal ||
        sh.off > sh.total || chunk > sh.total - sh.off)
      return false;
    throttle_.charge((uint32_t)chunk);  // ingress side of the cap
    uint64_t t0 = now_ns();
    auto akey = std::make_tuple(h.sender, h.key, sh.seq);
    std::shared_ptr<StripeAsm> as;
    {
      std::lock_guard<Mu> lk(stripe_mu_);
      auto it = stripe_asm_.find(akey);
      if (it == stripe_asm_.end()) {
        as = std::make_shared<StripeAsm>();
        as->base = h;
        as->seq = sh.seq;
        as->buf = pool_.lease((uint32_t)sh.total);
        as->nseg = sh.nseg;
        as->seen.assign(sh.nseg, 0);
        stripe_asm_[akey] = as;
      } else {
        as = it->second;
        // inconsistent framing or a duplicate segment is a protocol
        // violation (the client never re-sends a segment on a live
        // stream) — kill the conn rather than risk a torn payload
        if (as->nseg != sh.nseg || as->buf.size() != sh.total ||
            as->seen[sh.idx])
          return false;
      }
      as->seen[sh.idx] = 1;
      // segment 0 rides the sender's HOME conn for this key — where the
      // client registered its reply waiter
      if (sh.idx == 0) as->reply_conn = conn;
    }
    uint8_t* dst = as->buf.data() + sh.off;
    reg_.check(dst, (size_t)chunk, &stats_);
    if (!(use_rx ? rx.recv_payload(dst, (size_t)chunk)
                 : conn->recv_bytes(dst, (size_t)chunk)))
      return false;
    stats_.recv_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
    stats_.recv_count.fetch_add(1, std::memory_order_relaxed);
    stats_.stripe_segs.fetch_add(1, std::memory_order_relaxed);
    stats_.stripe_bytes.fetch_add(chunk, std::memory_order_relaxed);
    conn->lane_seg_count.fetch_add(1, std::memory_order_relaxed);
    conn->lane_seg_bytes.fetch_add(chunk, std::memory_order_relaxed);
    bool complete = false;
    {
      std::lock_guard<Mu> lk(stripe_mu_);
      auto it = stripe_asm_.find(akey);
      // a StripeReset raced this write: the assembly was dropped (the
      // shared_ptr kept the buffer alive for our write) — segment
      // discarded, conn stays healthy, client-side retry covers it
      if (it == stripe_asm_.end() || it->second.get() != as.get())
        return true;
      if (++as->got == as->nseg) {
        stripe_asm_.erase(it);
        complete = true;
      }
    }
    if (!complete) return true;
    MsgHeader bh = as->base;
    bh.flags = (uint8_t)(bh.flags & ~kFlagSeg);
    bh.len = (uint32_t)as->buf.size();
    EngineMsg m;
    m.op = bh.op;
    m.key = bh.key;
    m.rid = bh.rid;
    m.sender = bh.sender;
    m.epoch = bh.epoch;
    m.codec = bh.codec;
    m.conn = as->reply_conn ? as->reply_conn : conn;
    uint32_t req, dtype;
    decode_cmd(bh.cmd, &req, &dtype);
    m.req = req;
    m.dtype = dtype;
    m.payload = std::move(as->buf);
    DispatchSeq(bh.sender, bh.key, as->seq, std::move(m), bh.len);
    return true;
  }

  // Per-(sender, key) sequencing across the stripe group: the client
  // stamps each striped message with a monotone seq, and reassembled
  // messages enter the engine in exactly that order no matter which
  // conn loop finished last. After a stripe death the gate resyncs —
  // held survivors flush in ascending order and the next completion
  // adopts its seq — so the group never wedges behind a lost message
  // (the engine's replay/round gates own semantic correctness there).
  void DispatchSeq(uint16_t sender, uint64_t key, uint32_t seq,
                   EngineMsg&& m, uint32_t len) {
    std::vector<EngineMsg> ready;
    {
      std::lock_guard<Mu> lk(stripe_mu_);
      StripeGate& g = stripe_gates_[{sender, key}];
      if (g.resync) {
        g.held.emplace(seq, std::move(m));
        for (auto& [s, hm] : g.held) {
          ready.push_back(std::move(hm));
          g.next = s + 1;
        }
        g.held.clear();
        g.resync = false;
      } else if (seq == g.next) {
        ready.push_back(std::move(m));
        ++g.next;
        for (auto it = g.held.find(g.next); it != g.held.end();
             it = g.held.find(g.next)) {
          ready.push_back(std::move(it->second));
          g.held.erase(it);
          ++g.next;
        }
      } else if (seq > g.next) {
        g.held.emplace(seq, std::move(m));
        return;
      } else {
        // stale completion from before a resync: the client-side
        // request already failed over; drop it
        if (!m.payload.empty()) pool_.put(std::move(m.payload));
        return;
      }
    }
    for (auto& r : ready) {
      uint32_t l = r.payload.empty() ? len : (uint32_t)r.payload.size();
      EnqueueData(std::move(r), l);
    }
  }

  // Conn-death hook: drop this sender's in-flight assemblies (a lost
  // segment can never arrive; the shared_ptr keeps buffers alive for
  // any conn loop mid-write), flush held-but-unordered survivors, and
  // arm resync. Full departure erases the gates outright so a
  // reconnecting worker restarts cleanly at seq 0.
  void StripeReset(uint16_t sender, bool departed) {
    std::vector<EngineMsg> ready;
    {
      std::lock_guard<Mu> lk(stripe_mu_);
      for (auto it = stripe_asm_.begin(); it != stripe_asm_.end();) {
        if (std::get<0>(it->first) == sender)
          it = stripe_asm_.erase(it);
        else
          ++it;
      }
      for (auto it = stripe_gates_.begin(); it != stripe_gates_.end();) {
        if (it->first.first != sender) {
          ++it;
          continue;
        }
        StripeGate& g = it->second;
        if (departed) {
          // the worker is gone: its held folds must be dropped, not
          // folded into a round OnWorkerDeparted is about to roll back
          for (auto& [s, hm] : g.held) {
            (void)s;
            if (!hm.payload.empty()) pool_.put(std::move(hm.payload));
          }
          it = stripe_gates_.erase(it);
        } else {
          for (auto& [s, hm] : g.held) {
            ready.push_back(std::move(hm));
            g.next = s + 1;
          }
          g.held.clear();
          g.resync = true;
          ++it;
        }
      }
    }
    for (auto& r : ready) {
      uint32_t l = (uint32_t)r.payload.size();
      EnqueueData(std::move(r), l);
    }
  }

  void OnWorkerDeparted(int sender) {
    Flight(kFlightWorkerDeparted, 0, 0, (uint16_t)sender);
    std::fprintf(stderr,
                 "[bps-server] worker %d departed (all connections "
                 "closed); failing parked requests\n", sender);
    std::vector<ParkedPull> victims;
    {
      std::lock_guard<Mu> lk(stores_mu_);
      for (auto& [key, ks] : stores_) {
        (void)key;
        std::lock_guard<Mu> lk2(ks.mu);
        for (auto& p : ks.parked_pulls) victims.push_back(p);
        for (auto& p : ks.parked_inits) victims.push_back(p);
        // deferred folds belong to rounds AFTER the one the rollback
        // just dropped; their senders' last_round resets below, so the
        // retries (error-reply -> client resend) fold normally against
        // the re-armed round sequence
        for (auto& d : ks.deferred) {
          victims.push_back({d.conn, d.rid, d.sender});
          if (!d.payload.empty()) pool_.put(std::move(d.payload));
        }
        ks.deferred.clear();
        ks.parked_pulls.clear();
        ks.parked_inits.clear();
        // re-arm: the incomplete round's partial sum is dropped (next
        // round's first push re-seeds the accumulator) and the init
        // barrier restarts; push counts roll back to the last COMPLETED
        // round so survivors' PullReady bookkeeping stays consistent
        // when they retry after elastic resume.
        ks.init_count = 0;
        ks.recv_count = 0;
        ks.round_codec = 0;
        ks.wire_accum.clear();  // drop a half-summed randomk wire round
        if (ks.pull_abort.size() != ks.worker_push_count.size())
          ks.pull_abort.assign(ks.worker_push_count.size(), 0);
        if (ks.last_round.size() != ks.worker_push_count.size())
          ks.last_round.assign(ks.worker_push_count.size(), 0);
        for (size_t w = 0; w < ks.worker_push_count.size(); ++w) {
          if (ks.worker_push_count[w] > ks.completed_rounds) {
            // this worker already pushed the aborted round; its next
            // pull must NOT be satisfied by the previous round's
            // aggregate (PullReady would say ready after the rollback)
            ks.pull_abort[w] = 1;
            ks.worker_push_count[w] = ks.completed_rounds;
            // its re-push of the aborted round must FOLD, not dedup:
            // the partial sum it contributed to was just dropped
            ks.last_round[w] = 0;
          }
        }
      }
    }
    {
      std::lock_guard<Mu> lk(barrier_mu_);
      for (auto& p : barrier_waiters_) victims.push_back(p);
      barrier_waiters_.clear();
    }
    for (auto& p : victims) {
      MsgHeader r = ReplyHeader(ACK, 1, 0, p.rid);  // flags=1: error
      p.conn->send_msg(r, nullptr);
    }
  }

  void HandleIpcHello(const std::shared_ptr<Conn>& conn, uint32_t rid,
                      const Buf& payload) {
    // Client offered a shm segment (its first message on this conn; no
    // requests are in flight). Map + validate, ACK over TCP, then hold
    // the mapping PENDING until the client's IPC_CONFIRM — the ACK must
    // not ride the ring the client only trusts after seeing it, and the
    // conn must not switch before the client has committed. Any failure
    // error-ACKs and the conn simply stays TCP.
    std::string name(reinterpret_cast<const char*>(payload.data()),
                     payload.size());
    bool ok = false;
    int sfd = name.empty() ? -1 : ::shm_open(name.c_str(), O_RDWR, 0);
    if (sfd >= 0) {
      struct stat st {};
      void* base = MAP_FAILED;
      if (::fstat(sfd, &st) == 0 && st.st_size > (off_t)sizeof(IpcShm)) {
        base = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                      MAP_SHARED, sfd, 0);
      }
      ::close(sfd);
      if (base != MAP_FAILED) {
        IpcShm* s = reinterpret_cast<IpcShm*>(base);
        if (s->magic == kIpcMagic && s->ring_size >= (64 << 10) &&
            (size_t)st.st_size == sizeof(IpcShm) +
                                      2 * (size_t)s->ring_size +
                                      2 * (size_t)s->arena_size) {
          MsgHeader r = ReplyHeader(ACK, 0, 0, rid);
          conn->send_msg(r, nullptr);  // still TCP: ipc not yet set
          // pending until the client's IPC_CONFIRM commits it — the
          // client may time out on our ACK and stay TCP
          conn->ipc_pending.reset(
              new IpcChan(base, (size_t)st.st_size, conn->fd, true));
          ok = true;
        } else {
          ::munmap(base, (size_t)st.st_size);
        }
      }
    }
    if (!ok) {
      std::fprintf(stderr,
                   "[bps-server] ipc upgrade declined (shm %s)\n",
                   name.c_str());
      MsgHeader r = ReplyHeader(ACK, 1, 0, rid);
      conn->send_msg(r, nullptr);
    }
  }

  // ---- observability control ops (conn-loop inline: these must not
  // queue behind data-plane folds — a stats poll that waits out a
  // 256MB fold would be measuring itself) ---------------------------- //

  void HandleClockProbe(const std::shared_ptr<Conn>& conn, uint32_t rid) {
    // NTP-style echo on THIS server's steady clock: t1 = request seen
    // (header-only op, so handler entry IS arrival to within the op
    // dispatch), t2 = reply about to hit the transport. The client
    // brackets with its own t0/t3; offset = ((t1-t0)+(t2-t3))/2 with
    // error bounded by rtt/2 (utils/tracing.py estimate_clock_offset).
    uint64_t echo[2];
    echo[0] = now_ns();
    MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                              (uint32_t)sizeof(echo));
    echo[1] = now_ns();
    conn->send_msg(r, echo);
  }

  void HandleControlPull(const std::shared_ptr<Conn>& conn, uint32_t rid,
                         uint8_t op, uint16_t sender = 0,
                         uint64_t key = 0) {
    if (op == HEALTH_PULL) {
      // per-key post-aggregation statistics (the training-health
      // plane's wire surface): one fixed-width HealthRec for the key's
      // last published round. Unknown key / health off -> error ACK,
      // so a worker can tell "no statistics" from "all zeros". The
      // ks.mu hold is a 5-word copy — no send happens under it.
      HealthRec rec{};
      rec.key = key;
      uint64_t v[5];
      if (!KeyHealth(key, v)) {
        MsgHeader r = ReplyHeader(ACK, 1, 0, rid, key);
        conn->send_msg(r, nullptr);
        return;
      }
      rec.round = v[0];
      rec.sumsq_bits = v[1];
      rec.absmax_bits = v[2];
      rec.nonfinite = v[3];
      rec.elems = v[4];
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, key, 0,
                                (uint32_t)sizeof(rec));
      conn->send_msg(r, &rec);
      return;
    }
    if (op == JOIN_PROBE) {
      // scale-up join handshake: the worker verifies the newcomer is
      // reachable and agrees on the worker count BEFORE the registry
      // re-routes key subranges here (a num_workers mismatch would
      // wedge every aggregation round on the new store)
      uint64_t v[2] = {(uint64_t)num_workers_,
                       draining_.load() ? 1ull : 0ull};
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                                (uint32_t)sizeof(v));
      conn->send_msg(r, v);
      return;
    }
    if (op == DRAIN_REQ) {
      // graceful scale-down: latch the advisory draining flag (visible
      // in STATS_PULL / bps_server_stats as the `draining` slot) and
      // ACK with the number of key stores held — the worker has
      // already migrated the keys away, so the count is forensic, not
      // a gate. The flag is advisory by design: a drained server that
      // still receives traffic (operator error, stale worker) serves
      // it correctly rather than corrupting anything.
      bool first = !draining_.exchange(true);
      if (first) {
        Flight(kFlightDrained, 0, rid, sender);
        std::fprintf(stderr,
                     "[bps-server] drain requested by worker %u; "
                     "draining flag latched\n", (unsigned)sender);
      }
      uint64_t v[2];
      {
        std::lock_guard<Mu> lk(stores_mu_);
        v[0] = (uint64_t)stores_.size();
      }
      v[1] = 1;
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                                (uint32_t)sizeof(v));
      conn->send_msg(r, v);
      return;
    }
    if (op == STATS_PULL) {
      // full per-stage registry snapshot over the wire: the remote
      // half of bps.get_fleet_metrics() (same slot vector as the
      // in-process bps_server_stats mirror, by construction)
      uint64_t v[kNumStatSlots];
      int n = stat_slots(v, (int)kNumStatSlots);
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                                (uint32_t)(n * sizeof(uint64_t)));
      conn->send_msg(r, v);
      return;
    }
    if (op == STRIPE_PULL) {
      // per-lane wire counters (time-series plane): one StripeRec per
      // live conn, snapshot — cumulative counters the worker's sweep
      // differences into per-stripe series
      std::vector<StripeRec> recs(kCtrlStripeMax);
      int n = StripeSlots(recs.data(), (int)kCtrlStripeMax);
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                                (uint32_t)(n * sizeof(StripeRec)));
      conn->send_msg(r, recs.data());
      return;
    }
    if (op == TRACE_DRAIN) {
      // destructive batch drain: each sampled span fuses into exactly
      // one timeline; the client loops until a short batch
      std::vector<TraceRec> recs(kCtrlDrainBatch);
      size_t n = trace_ring_.drain(recs.data(), kCtrlDrainBatch, true);
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                                (uint32_t)(n * sizeof(TraceRec)));
      conn->send_msg(r, recs.data());
      return;
    }
    // FLIGHT_DRAIN: snapshot, never consumes — a metrics poll must not
    // steal the events a later crash dump needs. One shot, NEWEST
    // window (EventRing::drain non-consume): the cap covers a whole
    // default ring, and an over-provisioned ring still dumps the
    // events nearest the fault.
    std::vector<FlightRec> recs(kCtrlFlightDrainMax);
    size_t n = flight_ring_.drain(recs.data(), kCtrlFlightDrainMax,
                                  false);
    MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, rid, 0, 0,
                              (uint32_t)(n * sizeof(FlightRec)));
    conn->send_msg(r, recs.data());
  }

  // flight-plane event (bounded ring, drop-oldest): the structured
  // counterpart of the stderr lines the fault paths already print
  void Flight(uint8_t kind, uint64_t key, uint32_t rid, uint16_t sender,
              uint64_t detail = 0) {
    FlightRec r{};
    r.ts_ns = now_ns();
    r.key = key;
    r.detail = detail;
    r.rid = rid;
    r.sender = sender;
    r.kind = kind;
    flight_ring_.push(r);
  }

  void HandleBarrier(EngineMsg&& m) {
    std::vector<ParkedPull> release;
    {
      std::lock_guard<Mu> lk(barrier_mu_);
      barrier_waiters_.push_back({m.conn, m.rid, m.sender});
      // release on DISTINCT workers, not message count: a worker whose
      // threads barrier concurrently sends duplicates, and counting
      // those would release before every worker arrived
      std::unordered_set<uint16_t> uniq;
      for (auto& w : barrier_waiters_) uniq.insert((uint16_t)w.sender);
      if ((int)uniq.size() == num_workers_) {
        release.swap(barrier_waiters_);
      }
    }
    for (auto& w : release) {
      MsgHeader r = ReplyHeader(ACK, 0, 0, w.rid);
      w.conn->send_msg(r, nullptr);
    }
  }

  void HandleShutdown(EngineMsg&& m) {
    {
      // clean exit: the stripe conns of this worker will close right
      // after the ACK; that must not read as a failure
      std::lock_guard<Mu> lk(worker_conns_mu_);
      clean_exit_.insert((int)m.sender);
    }
    MsgHeader r = ReplyHeader(ACK, 0, 0, m.rid);
    m.conn->send_msg(r, nullptr);
    if (++shutdown_count_ >= num_workers_) {
      shutting_down_.store(true);
      ::shutdown(listen_fd_, SHUT_RDWR);
      ::close(listen_fd_);
      for (auto& q : queues_) q->stop();
    }
  }

  // tx half of the submission ring: data-plane replies queue on the
  // destination conn's tx ring (QueueReply) and leave as ONE gathered
  // sendmsg when the engine's queue momentarily drains — a round's
  // worth of ACKs/aggregates is one syscall batch, not N. Registered
  // per engine thread; null on conn-loop/control threads, which keep
  // blocking sends.
  inline static thread_local std::vector<std::shared_ptr<Conn>>*
      t_touched_ = nullptr;

  void QueueReply(const std::shared_ptr<Conn>& conn, const MsgHeader& r,
                  std::shared_ptr<const Buf> pin) {
    if (t_touched_ && !conn->ipc && wire_ring_enabled()) {
      if (conn->send_msg_queued(r, std::move(pin))) {
        auto& v = *t_touched_;
        for (auto& c : v)
          if (c.get() == conn.get()) return;
        v.push_back(conn);
      }
      return;
    }
    conn->send_msg(r, pin ? (const void*)pin->data() : nullptr);
  }

  void EngineLoop(int idx) {
    std::vector<std::shared_ptr<Conn>> touched;
    t_touched_ = &touched;
    EngineMsg m;
    while ([&] {
      if (queues_[idx]->try_pop(&m)) return true;
      // drain boundary: no immediately-runnable work — flush every
      // conn holding queued replies before blocking
      for (auto& c : touched) c->tx_flush();
      touched.clear();
      return queues_[idx]->wait_pop(&m);
    }()) {
      // gray-failure injection (BYTEPS_CHAOS_SLOW_SERVER): the sleep
      // sits between dequeue and the queue-wait accounting below, so it
      // COUNTS as queue-wait — the stage a real straggler inflates
      chaos_.slow_point();
      if (m.enq_ns) {
        stats_.queue_ns.fetch_add(now_ns() - m.enq_ns,
                                  std::memory_order_relaxed);
        stats_.queue_count.fetch_add(1, std::memory_order_relaxed);
      }
      if (m.traced) m.deq_ns = now_ns();
      if (m.direct) {
        // adopt the direct-recv buffer as the message payload (O(1)
        // move — the received bytes travel pointer-only from here into
        // the accumulator). Done BEFORE the dead-conn check so a dying
        // conn's reservation is always consumed and the key unblocked.
        KeyStore& ks = store_of(m.key);
        std::lock_guard<Mu> lk(ks.mu);
        m.payload = std::move(ks.direct_buf);
        ks.direct_inflight = false;
        m.direct = false;
      }
      if (m.conn->dead.load()) {
        // queued behind a connection that already died: processing it
        // would re-pollute the round state OnWorkerDeparted rolled back
        // (e.g. a stale push adopted as the first push of the re-armed
        // round). This dequeue-time check is the fast path; the handlers
        // re-check under ks.mu to close the check-then-act window.
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
      } else {
        switch (m.op) {
          case INIT_PUSH: DoInit(m); break;
          case PUSH: DoPush(m); break;
          case PULL: DoPull(m); break;
          case PUSHPULL: DoPush(m, /*fused=*/true); break;
          case COMP_INIT: DoCompInit(m); break;
          default: {
            // Unknown op (version skew: a newer client against this
            // server). Error-reply instead of dropping — a fused client
            // would otherwise wait out its full request timeout on a
            // request this server can never answer.
            Flight(kFlightUnknownOp, m.key, m.rid, m.sender, m.op);
            MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
            m.conn->send_msg(r, nullptr);
            break;
          }
        }
      }
      if (m.traced) {
        // kind-0 request span: recv → enqueue → dequeue → handler done
        // (the de-aggregated recv/queue-wait/fold stage counters); the
        // reply leg, which for a parked fused reply happens in a later
        // engine invocation, records as its own kind-1 event rid-joined
        // by the worker-side fuser
        TraceRec t{};
        t.key = m.key;
        t.t0 = m.recv_ns;
        t.t1 = m.enq_ns;
        t.t2 = m.deq_ns;
        t.t3 = now_ns();
        t.rid = m.rid;
        t.sender = m.sender;
        t.op = m.op;
        t.kind = 0;
        trace_ring_.push(t);
      }
      // epilogue: out-of-band arena blocks release only AFTER the fold
      // consumed them; un-adopted payload buffers recycle to the pool
      // (the "fold scratch" of the zero-copy recv path)
      if (m.oob_chan) {
        m.oob_chan->oob_release(m.oob_off);
        m.oob_chan = nullptr;
        m.oob = nullptr;
      }
      if (!m.payload.empty()) pool_.put(std::move(m.payload));
      m.conn.reset();
    }
    for (auto& c : touched) c->tx_flush();
    t_touched_ = nullptr;
  }

  KeyStore& store_of(uint64_t key) {
    // unordered_map guarantees reference stability across rehash
    std::lock_guard<Mu> lk(stores_mu_);
    return stores_[key];
  }

  // Replay dedup (call under ks.mu): true when this stamped push's round
  // was already folded for this sender — the caller must SKIP the fold
  // (but still answer: ACK for plain PUSH, FusedReply for PUSHPULL, so
  // the retrying worker gets the round's aggregate it never received).
  bool IsReplay(KeyStore& ks, const EngineMsg& m) {
    uint64_t rnd = m.epoch >> 16;
    if (!rnd) return false;  // unstamped: legacy semantics, no dedup
    if (ks.last_round.size() != ks.worker_push_count.size())
      ks.last_round.assign(ks.worker_push_count.size(), 0);
    if (m.sender >= ks.last_round.size() ||
        rnd > ks.last_round[m.sender])
      return false;
    Flight(kFlightReplayDedup, m.key, m.rid, m.sender, rnd);
    std::fprintf(stderr,
                 "[bps-server] dedup: replayed push key=%llu sender=%u "
                 "round=%llu attempt=%llu (already folded)\n",
                 (unsigned long long)m.key, (unsigned)m.sender,
                 (unsigned long long)rnd,
                 (unsigned long long)(m.epoch & 0xFFFF));
    return true;
  }

  // Codec-tag gate (call under ks.mu, after IsReplay, before folding):
  // a tagged push must match (a) the store's ACTIVE codec — a dense
  // payload summed into a compressed accumulator (or vice versa) is
  // silent corruption — and (b) the tag that OPENED this round, codec
  // id and plan epoch alike, so cross-worker adaptive-plan skew fails
  // the fold loudly instead of mis-summing. Untagged pushes (codec=0,
  // static configs / legacy callers) skip validation entirely.
  bool CodecTagOk(KeyStore& ks, const EngineMsg& m) {
    if (m.codec == 0) return true;
    uint8_t id = (uint8_t)(m.codec & 0xFF);
    uint8_t want = kCodecDense;
    switch (ks.comp.type) {
      case CompressorCfg::ONEBIT: want = kCodecOnebit; break;
      case CompressorCfg::TOPK: want = kCodecTopk; break;
      case CompressorCfg::RANDOMK: want = kCodecRandomk; break;
      case CompressorCfg::DITHERING: want = kCodecDithering; break;
      case CompressorCfg::LOSSLESS: want = kCodecLossless; break;
      default: break;
    }
    if (id != want) {
      std::fprintf(stderr,
                   "[bps-server] codec tag mismatch key=%llu sender=%u: "
                   "push tagged codec=%u but the store's active codec is "
                   "%u — refusing to fold (plan skew / missing "
                   "COMP_INIT)\n",
                   (unsigned long long)m.key, (unsigned)m.sender,
                   (unsigned)id, (unsigned)want);
      Flight(kFlightCodecReject, m.key, m.rid, m.sender, m.codec);
      return false;
    }
    if (!async_) {
      if (ks.recv_count == 0) {
        ks.round_codec = m.codec;
      } else if (ks.round_codec != 0 && m.codec != ks.round_codec) {
        std::fprintf(stderr,
                     "[bps-server] codec tag mismatch key=%llu sender=%u: "
                     "round opened with tag 0x%x, this push carries 0x%x "
                     "(worker codec plans disagree) — refusing to fold\n",
                     (unsigned long long)m.key, (unsigned)m.sender,
                     ks.round_codec, m.codec);
        Flight(kFlightCodecReject, m.key, m.rid, m.sender, m.codec);
        return false;
      }
    }
    return true;
  }

  // Round-alignment gate verdicts. kGateAligned folds now; kGateDefer
  // parks the message for a later round (cross-barrier window only);
  // kGateReject error-replies — the fold never happens.
  enum GateVerdict { kGateAligned = 0, kGateDefer, kGateReject };

  // Round-alignment gate (call under ks.mu, after IsReplay, before the
  // fold): sync-mode stamped folds summing into ONE aggregation round
  // must all carry the SAME round number. The first fold of a round
  // latches it; a disagreeing later fold is the partial-reply-window
  // hazard — after a migration, a worker that consumed round N's reply
  // pushes N+1 while a worker whose reply was lost re-pushes N, and
  // positional counting would silently sum the two rounds together.
  // The cross-barrier GENERALIZATION (window_ > 0): a fold up to
  // window_ rounds AHEAD of the accepting round is kGateDefer — parked
  // by DeferFold, folded only when its round becomes current, so the
  // mis-sum stays impossible by construction — and anything beyond the
  // window is still the loud reject. window_ == 0 keeps these exact
  // semantics: rnd ahead mid-round rejects, and a fresh round latches
  // whatever opens it. Unstamped folds (legacy) and async mode keep
  // positional semantics throughout.
  GateVerdict RoundGate(KeyStore& ks, const EngineMsg& m) {
    if (async_) return kGateAligned;
    uint64_t rnd = m.epoch >> 16;
    if (ks.recv_count == 0) {
      if (window_ && rnd) {
        // between rounds, the next stamped round that may OPEN is the
        // one after the last PUBLISHED round (pub_round survives a
        // departure rollback; round_open does not roll back, so it
        // would mis-read an aborted round as completed). A stamped
        // fold further ahead is a pipelined worker running ahead of a
        // straggler — park it (within W) instead of latching a round
        // the slow worker could never join; beyond W is the loud
        // reject. No stamped history at all (fresh store / migration
        // landing) latches freely, as the strict gate always has.
        uint64_t expect = ks.pub_round
                              ? ks.pub_round + 1
                              : (ks.round_open ? ks.round_open + 1 : rnd);
        if (rnd > expect) {
          if (rnd <= expect + window_) return kGateDefer;
          return RejectSkew(ks, m, rnd);
        }
      }
      ks.round_open = rnd;  // rnd==0: round opened unstamped, no gate
      return kGateAligned;
    }
    if (!rnd || ks.round_open == 0 || rnd == ks.round_open)
      return kGateAligned;
    if (window_ && rnd > ks.round_open && rnd <= ks.round_open + window_)
      return kGateDefer;
    return RejectSkew(ks, m, rnd);
  }

  GateVerdict RejectSkew(KeyStore& ks, const EngineMsg& m, uint64_t rnd) {
    std::fprintf(stderr,
                 "[bps-server] round skew key=%llu sender=%u: round "
                 "opened at %llu, this push carries %llu (window %llu) "
                 "— refusing to fold (workers are folding different "
                 "training rounds; partial-reply window after a "
                 "migration, or staleness beyond the bound?)\n",
                 (unsigned long long)m.key, (unsigned)m.sender,
                 (unsigned long long)ks.round_open,
                 (unsigned long long)rnd,
                 (unsigned long long)window_);
    Flight(kFlightRoundSkew, m.key, m.rid, m.sender, rnd);
    if (window_)
      window_rejected_.fetch_add(1, std::memory_order_relaxed);
    return kGateReject;
  }

  // Park a within-window future-round fold (call under ks.mu, verdict
  // kGateDefer). The message moves into OWNED storage: an out-of-band
  // payload is copied out so its shm arena block releases through the
  // normal engine epilogue (a parked fold must never pin the peer's
  // arena across rounds), and a moved-out owned payload leaves
  // m.payload empty so the epilogue's pool recycle skips it. One
  // parked fold per (sender, round): a retry of an already-parked
  // round REPLACES the original — its rid is newer, and the client
  // abandoned the old one. Overflow past W x workers is a protocol
  // violation (the worker-side staleness credit should make it
  // impossible) and rejects loudly. Returns false on overflow; the
  // caller error-replies.
  bool DeferFold(KeyStore& ks, EngineMsg& m) {
    uint64_t rnd = m.epoch >> 16;
    EngineMsg d;
    d.op = m.op;
    d.key = m.key;
    d.req = m.req;
    d.dtype = m.dtype;
    d.rid = m.rid;
    d.sender = m.sender;
    d.epoch = m.epoch;
    d.codec = m.codec;
    d.traced = m.traced;
    d.conn = m.conn;
    if (m.oob) {
      d.payload.assign(m.data(), m.data() + m.size());
    } else {
      d.payload = std::move(m.payload);
    }
    for (auto& e : ks.deferred) {
      if (e.sender == m.sender && (e.epoch >> 16) == rnd) {
        e = std::move(d);
        window_deferred_.fetch_add(1, std::memory_order_relaxed);
        return true;
      }
    }
    size_t cap = (size_t)window_ *
                 (size_t)(num_workers_ > 0 ? num_workers_ : 1);
    if (ks.deferred.size() >= cap) {
      m.payload = std::move(d.payload);  // give the bytes back for the
                                         // epilogue's pool recycle
      RejectSkew(ks, m, rnd);
      return false;
    }
    ks.deferred.push_back(std::move(d));
    window_deferred_.fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  // Publish epilogue (call under ks.mu at EVERY aggregate publish,
  // after completed_rounds++ / PublishHealth): flush the parked pulls
  // this publish satisfies and hand back any deferred folds for
  // redispatch. With the window off (or async) this is exactly the old
  // flush.swap — every parked pull was waiting for this one round.
  // Windowed, the just-completed round is recorded (pub_round +
  // history ring) and only the parked pulls whose round has now
  // published flush; a pull parked for a round still aggregating stays
  // parked — answering it with this round's bytes would hand a
  // pipelined worker round N's aggregate stamped as N+1.
  void WindowPublishLocked(KeyStore& ks, std::vector<ParkedPull>* flush,
                           std::vector<EngineMsg>* defer) {
    if (window_ == 0 || async_) {
      flush->swap(ks.parked_pulls);
      return;
    }
    ks.pub_round = ks.round_open;
    ks.pub_hist.push_back({ks.pub_round, ks.pub, ks.pub_wire});
    if (ks.pub_hist.size() > (size_t)window_ + 1)
      ks.pub_hist.erase(ks.pub_hist.begin());
    std::vector<ParkedPull> keep;
    for (auto& p : ks.parked_pulls) {
      if (ParkedReadyLocked(ks, p))
        flush->push_back(p);
      else
        keep.push_back(p);
    }
    ks.parked_pulls.swap(keep);
    if (!ks.deferred.empty()) defer->swap(ks.deferred);
  }

  // Re-run parked future-round folds after their blocking round
  // published. Call WITHOUT ks.mu held: each redispatch re-enters
  // DoPush and takes the key lock itself; a fold whose round is STILL
  // ahead simply re-parks. Recursion (a redispatched fold completing
  // its round redispatches the next) is bounded by the window, <= 8.
  // The deferred copies own their payloads, so the engine epilogue's
  // recycle is replayed here by hand.
  void RedispatchDeferred(std::vector<EngineMsg>& msgs) {
    for (auto& dm : msgs) {
      DoPush(dm, /*fused=*/dm.op == PUSHPULL);
      if (!dm.payload.empty()) pool_.put(std::move(dm.payload));
      dm.conn.reset();
    }
    msgs.clear();
  }

  // Record a successful fold's round (call under ks.mu, next to the
  // worker_push_count increment).
  static void RecordRound(KeyStore& ks, const EngineMsg& m) {
    uint64_t rnd = m.epoch >> 16;
    if (!rnd) return;
    if (ks.last_round.size() != ks.worker_push_count.size())
      ks.last_round.assign(ks.worker_push_count.size(), 0);
    if (m.sender < ks.last_round.size()) ks.last_round[m.sender] = rnd;
  }

  void DoInit(EngineMsg& m) {
    // first push of a key allocates; reply withheld until every worker's
    // init push arrived (server.cc:266-295)
    if (m.dtype > U16) {
      // reject out-of-enum dtypes here, where the store would be created:
      // a later steady-state push would hit sum_into's no-op default and
      // silently publish the first worker's un-summed data as the
      // aggregate (error-reply pattern as the length-mismatch path below)
      std::fprintf(stderr, "[bps-server] init rejected key=%llu: unknown "
                   "dtype %u\n", (unsigned long long)m.key, m.dtype);
      MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
      m.conn->send_msg(r, nullptr);
      return;
    }
    std::vector<ParkedPull> release;
    std::vector<ParkedPull> stale;  // parked under the OLD length: error out
    {
      KeyStore& ks = store_of(m.key);
      std::lock_guard<Mu> lk(ks.mu);
      if (m.conn->dead.load()) {  // fenced: see Conn::dead
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (ks.len != (uint32_t)m.size() || ks.dtype != m.dtype) {
        // fresh key, or re-init with a new length (tensor resize) OR a
        // new dtype (two 4-byte types swap under one key): reset the
        // whole aggregation state — a mere dtype retag would keep
        // serving the old-typed aggregate and sum in-flight old-typed
        // pushes with the new kernel. Anything parked against the old
        // length must be error-replied, NOT left parked — an old-length
        // pull answered later with new-length bytes is silently discarded
        // by the client (out_len mismatch) and reads as success with an
        // unwritten output buffer.
        stale.reserve(ks.parked_pulls.size() + ks.parked_inits.size() +
                      ks.deferred.size());
        for (auto& p : ks.parked_pulls) stale.push_back(p);
        for (auto& p : ks.parked_inits) stale.push_back(p);
        // deferred future-round folds were parked against the OLD
        // length/round numbering: error-reply so the workers retry
        // them against the re-initialized store
        for (auto& d : ks.deferred) {
          stale.push_back({d.conn, d.rid, d.sender});
          if (!d.payload.empty()) pool_.put(std::move(d.payload));
        }
        ks.deferred.clear();
        ks.pub_round = 0;
        ks.pub_hist.clear();
        ks.parked_pulls.clear();
        ks.parked_inits.clear();
        ks.init_count = 0;
        ks.init_done = false;
        ks.len = (uint32_t)m.size();
        ks.dtype = m.dtype;
        ks.accum.assign(ks.len, 0);
        // init value (typically zeros or weights); assign() covers both
        // the owned-payload and the shm-arena (out-of-band) cases
        ks.merged.assign(m.data(), m.data() + m.size());
        ks.pub = std::make_shared<Buf>(ks.merged);
        ks.worker_push_count.assign(num_workers_, 0);
        ks.pull_abort.assign(num_workers_, 0);
        ks.last_round.assign(num_workers_, 0);
        ks.recv_count = 0;
        ks.round_codec = 0;
        ks.completed_rounds = 0;
        // a resize invalidates any compressor (stale n): workers must
        // re-send COMP_INIT for the new length
        ks.comp = CompressorCfg();
        ks.pub_wire.reset();
        ks.round_idx.clear();
        ks.scratch.clear();
        ks.wire_accum.clear();
      }
      if (ks.init_done) {
        // the cold-start barrier already completed for this store; a
        // same-length init is an idempotent re-declaration (elastic
        // reconnect after suspend or a peer's departure) — ACK now,
        // survivors that never re-init must not be waited on. A
        // re-initing worker restarts its round numbering (fresh client
        // = fresh scheduler counters), so its dedup baseline resets:
        // without this every post-resume stamped push would read as a
        // replay of the pre-suspend rounds and be silently dropped.
        if (ks.last_round.size() != ks.worker_push_count.size())
          ks.last_round.assign(ks.worker_push_count.size(), 0);
        if (m.sender < ks.last_round.size())
          ks.last_round[m.sender] = 0;
        release.push_back({m.conn, m.rid, m.sender});
      } else {
        ks.init_count++;
        ks.parked_inits.push_back({m.conn, m.rid, m.sender});
        if ((int)ks.init_count >= num_workers_) {
          release.swap(ks.parked_inits);
          ks.init_count = 0;  // allow re-init (elastic)
          ks.init_done = true;
        }
      }
    }
    for (auto& w : stale) {
      MsgHeader r = ReplyHeader(ACK, 1, 0, w.rid, m.key);  // flags=1: error
      w.conn->send_msg(r, nullptr);
    }
    for (auto& w : release) {
      MsgHeader r = ReplyHeader(ACK, 0, 0, w.rid, m.key);
      w.conn->send_msg(r, nullptr);
    }
  }

  void DoCompInit(EngineMsg& m) {
    // per-key compressor from in-band kwargs (server.cc:228-257).
    // Requires: sync mode, store already init-pushed dense f32, matching
    // element count. Idempotent — every worker sends it.
    KeyStore& ks = store_of(m.key);
    bool ok = false;
    {
      std::lock_guard<Mu> lk(ks.mu);
      if (m.conn->dead.load()) {  // fenced: see Conn::dead
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      CompressorCfg cfg;
      if (!async_ &&
          CompressorCfg::Parse(
              std::string((const char*)m.data(), m.size()),
              &cfg) &&
          ks.len == cfg.n * 4 && ks.dtype == F32) {
        ok = true;
        // idempotent re-registration (every worker sends it) MUST be a
        // no-op — a reset here can race a peer's in-flight round and
        // clear the captured randomk indices mid-aggregation
        if (!(ks.comp == cfg)) {
          ks.comp = cfg;
          ks.scratch.resize(cfg.n);
          ks.round_idx.clear();
          // a half-summed randomk wire round under the OLD config must
          // not be reinterpreted with the new k (out-of-bounds reads and
          // scatter writes); drop it and restart the round count
          ks.wire_accum.clear();
          ks.recv_count = 0;
          ks.round_codec = 0;
          // the dense ALL_RECV publishes by MOVING accum out; a key that
          // ran dense rounds before COMP_INIT arrives here with an empty
          // accum, and the compressed first-recv memcpys into it — make
          // sure it is full-size again
          if (ks.accum.size() != ks.len) ks.accum.assign(ks.len, 0);
          if (cfg.type == CompressorCfg::NONE) {
            // explicit codec CLEAR (compressor=none): the adaptive
            // plane de-escalated this key to dense — drop the
            // compressed published view so a stale wire can never
            // answer a later compressed pull as if it were current
            ks.pub_wire.reset();
          } else {
            // publish a compressed view of the current aggregate so a
            // pull that precedes the first compressed round is
            // answerable
            auto w = std::make_shared<Buf>(cfg.WireLen());
            uint32_t wl = ks.comp.Compress((const float*)ks.pub->data(),
                                           w->data(), ks.completed_rounds,
                                           ks.round_idx);
            w->resize(wl);  // varint wires are variable-length
            ks.pub_wire = std::move(w);
          }
        }
      }
    }
    MsgHeader r = ReplyHeader(ACK, (uint8_t)(ok ? 0 : 1), 0, m.rid, m.key);
    m.conn->send_msg(r, nullptr);
  }

  // [k idx][k vals] wire -> dense f32[n] scatter with duplicate-index
  // last-wins (numpy parity) — the ONE definition of the wire-to-dense
  // convention, shared by the fast path's degrade and publish steps
  // (CompressorCfg::Decompress keeps its own bounds-checked variant for
  // untrusted input).
  static void ScatterWire(const uint8_t* wire, uint32_t k, float* dst,
                          uint32_t n) {
    const int32_t* idx = (const int32_t*)wire;
    const float* val = (const float*)(wire + 4 * (size_t)k);
    std::memset(dst, 0, (size_t)n * sizeof(float));
    for (uint32_t i = 0; i < k; ++i) dst[idx[i]] = val[i];
  }

  // randomk homomorphic aggregation: every worker of a round derives the
  // SAME index vector from (seed, round), so the sum of the decompressed
  // tensors equals the scatter of the elementwise-summed wire values —
  // including duplicate-index last-wins semantics, since the duplicate
  // positions align across workers. Summing k floats per push replaces
  // the generic path's O(n) scatter+add (the THC observation: linear
  // codecs aggregate without decompression). Returns false (untouched
  // state) when the payload's indices don't match the round's — e.g.
  // worker-side round counters skewed by an elastic resume — after
  // expanding the wire accumulator into the dense accumulator so the
  // caller's generic path finishes the round correctly.
  bool RandomkFastPush(EngineMsg& m, KeyStore& ks) {
    const uint32_t k = ks.comp.k;
    const uint8_t* payload = m.data();
    const int32_t* idx = (const int32_t*)payload;
    const float* val = (const float*)(payload + 4 * (size_t)k);
    if (ks.recv_count == 0) {
      ks.wire_accum.assign(payload, payload + m.size());
      ks.round_idx.assign(idx, idx + k);
      return true;
    }
    if (!ks.wire_accum.empty() &&
        std::memcmp(ks.wire_accum.data(), idx, 4 * (size_t)k) == 0) {
      float* acc = (float*)(ks.wire_accum.data() + 4 * (size_t)k);
      kernels_.f32(acc, val, k);
      return true;
    }
    if (!ks.wire_accum.empty()) {
      // degrade mid-round: expand wire form to dense, then generic path
      if (ks.accum.size() != ks.len) ks.accum.assign(ks.len, 0);
      ScatterWire(ks.wire_accum.data(), k, (float*)ks.accum.data(),
                  ks.comp.n);
      ks.wire_accum.clear();
    }
    return false;
  }

  // Fused PUSHPULL tail after a SUCCESSFUL fold: park the reply
  // alongside the parked pulls, or answer it now when this worker's
  // contribution is already covered (it completed the round, or async
  // mode). Runs its readiness check in its own ks.mu section — if a
  // peer completes the round between the fold's unlock and this lock,
  // the parked_pulls flush ran without us but the re-check then sees
  // completed_rounds caught up and answers immediately, so the race is
  // benign (no lost reply).
  // Fold-stage accounting (per-stage server timing + the fold_ab
  // bench's HARD bytes-folded proof): one call per payload folded.
  void RecordFold(uint64_t t0, size_t bytes) {
    stats_.fold_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
    stats_.fold_count.fetch_add(1, std::memory_order_relaxed);
    stats_.fold_bytes.fetch_add(bytes, std::memory_order_relaxed);
  }

  // Training-health publish (call under ks.mu, AFTER completed_rounds
  // was bumped, with `agg` the just-published dense aggregate): latch
  // the round's statistics on the store and bump the server counters.
  // `fused` carries the stats the round's LAST f32 fold computed
  // in-pass (the dense multi-worker hot path); every other publish
  // shape takes the read-only scan. No-op when BYTEPS_HEALTH is off.
  void PublishHealth(KeyStore& ks, const void* agg, uint32_t len,
                     uint32_t dtype, const HStat* fused) {
    if (!health_) return;
    HStat h;
    if (fused != nullptr) {
      h = *fused;
    } else {
      stat_scan(agg, len, dtype, kernels_, &h);
    }
    h.round = ks.completed_rounds;
    ks.hstat = h;
    health_rounds_.fetch_add(1, std::memory_order_relaxed);
    if (h.nonfinite)
      health_nonfinite_.fetch_add(h.nonfinite,
                                  std::memory_order_relaxed);
  }


  void FusedReply(KeyStore& ks, EngineMsg& m, bool compressed) {
    // the fused reply is FOR the round this push folded into: carry
    // the stamp so a windowed park waits for (and answers with) that
    // round's aggregate, not whichever publishes first
    ParkedPull p{m.conn, m.rid,    m.sender, compressed,
                 m.traced, m.key, m.epoch >> 16};
    bool ready;
    {
      std::lock_guard<Mu> lk(ks.mu);
      ready = PullReady(ks, p);
      if (!ready) ks.parked_pulls.push_back(p);
    }
    if (ready) AnswerPull(ks, p);
  }

  // Decompress-on-the-fabric (BYTEPS_FUSED_DECODE, tentpole move 3):
  // decode the LOSSLESS byte-plane wire straight into the accumulator.
  // The legacy path materializes a full dense scratch (inflate ->
  // scatter n*4 bytes -> memcpy/fold n*4 bytes, re-streamed from RAM);
  // here the first push of a round scatters the decoded floats IN
  // PLACE of the accumulator (no scratch, no memcpy) and later pushes
  // scatter one cache-sized block at a time with the SIMD fold
  // consuming it while L1/L2-hot — one full memory pass removed per
  // push. Fold order is unchanged (kernels_.f32 is elementwise
  // left-to-right), so the aggregate is bitwise-identical to the
  // legacy path — the fused/legacy A/B test pins that. Atomicity: the
  // byte planes inflate into thread-local staging FIRST, exhausting
  // every failure mode (zlib errors, bad lengths) before the first
  // accumulator write, so a rejected wire leaves the round exactly as
  // the legacy scratch path would. Call under ks.mu.
  bool LosslessDecodeInto(const uint8_t* in, uint32_t len, KeyStore& ks) {
    const uint32_t n = ks.comp.n;
    if (len < CompressorCfg::kLosslessHdr) return false;
    uint32_t wn;
    std::memcpy(&wn, in, 4);
    uint8_t mode = in[4], nplanes = in[5];
    if (wn != n || nplanes != 4 || mode > 1) return false;
    uint32_t plens[4];
    std::memcpy(plens, in + 8, 16);
    uint64_t total = 0;
    for (int j = 0; j < 4; ++j) total += plens[j];
    if (CompressorCfg::kLosslessHdr + total != len) return false;
    static thread_local std::vector<uint8_t> tl_planes[4];
    const uint8_t* plane[4];
    size_t pos = CompressorCfg::kLosslessHdr;
    for (int j = 0; j < 4; ++j) {
      const uint8_t* src = in + pos;
      if (mode == 0) {  // raw planes ride the wire: zero-copy pointers
        if (plens[j] != n) return false;
        plane[j] = src;
      } else {
        tl_planes[j].resize(n);
        uLongf dl = n;
        if (uncompress(tl_planes[j].data(), &dl, src, plens[j]) != Z_OK ||
            dl != n)
          return false;
        plane[j] = tl_planes[j].data();
      }
      pos += plens[j];
    }
    const bool first = ks.recv_count == 0;
    if (first && ks.accum.size() != ks.len) {
      if ((uint64_t)n * 4 == ks.len) {
        // the scatter below writes every byte: skip the zero-fill
        if (ks.accum.capacity() >= ks.len)
          ks.accum.resize(ks.len);
        else
          ks.accum = pool_.lease(ks.len);
      } else {
        ks.accum.assign(ks.len, 0);
      }
    }
    static thread_local std::vector<float> tl_block;
    constexpr uint32_t kChunk = 16384;  // 64 KiB of f32 per block
    float* accum = (float*)ks.accum.data();
    if (!first) tl_block.resize(kChunk);
    for (uint32_t off = 0; off < n; off += kChunk) {
      uint32_t c = n - off < kChunk ? n - off : kChunk;
      uint8_t* dst =
          first ? (uint8_t*)(accum + off) : (uint8_t*)tl_block.data();
      for (int j = 0; j < 4; ++j) {
        const uint8_t* p = plane[j] + off;
        for (uint32_t i = 0; i < c; ++i) dst[i * 4 + j] = p[i];
      }
      if (!first) kernels_.f32(accum + off, tl_block.data(), c);
    }
    stats_.fused_decode_folds.fetch_add(1, std::memory_order_relaxed);
    return true;
  }

  void DoPushCompressed(EngineMsg& m, KeyStore& ks, bool fused) {
    std::vector<ParkedPull> flush;
    std::vector<EngineMsg> defer;
    {
      std::lock_guard<Mu> lk(ks.mu);
      if (m.conn->dead.load()) {  // fenced: see Conn::dead
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (IsReplay(ks, m)) goto ack;  // fold at most once per round
      // RoundGate BEFORE CodecTagOk: a deferred future-round fold must
      // not be validated against (or latch) the CURRENT round's codec
      // tag — its own round re-checks the tag at redispatch
      switch (RoundGate(ks, m)) {
        case kGateDefer:
          if (DeferFold(ks, m)) return;  // answered at redispatch
          [[fallthrough]];               // overflow: rejected loudly
        case kGateReject: {
          MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
          m.conn->send_msg(r, nullptr);
          return;
        }
        default: break;
      }
      if (!CodecTagOk(ks, m)) {
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (ks.comp.type == CompressorCfg::RANDOMK &&
          m.size() == ks.comp.WireLen()) {
        // bounds-check indices, then try the O(k) wire-form aggregation
        bool valid = true;
        const int32_t* idx = (const int32_t*)m.data();
        for (uint32_t i = 0; i < ks.comp.k; ++i)
          if (idx[i] < 0 || (uint32_t)idx[i] >= ks.comp.n) {
            valid = false;
            break;
          }
        if (!valid) {
          std::fprintf(stderr, "[bps-server] compressed push rejected "
                       "key=%llu (bad indices)\n",
                       (unsigned long long)m.key);
          MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
          m.conn->send_msg(r, nullptr);
          return;
        }
        uint64_t t0 = now_ns();
        if (RandomkFastPush(m, ks)) {
          RecordFold(t0, m.size());
          ks.total_pushes++;
          if (m.sender < ks.worker_push_count.size())
            ks.worker_push_count[m.sender]++;
          if (m.sender < ks.pull_abort.size()) ks.pull_abort[m.sender] = 0;
          RecordRound(ks, m);
          ks.recv_count++;
          if ((int)ks.recv_count >= num_workers_) {
            // ALL_RECV: the wire accumulator IS the compressed
            // aggregate; scatter it once for the dense published view
            auto w = std::make_shared<Buf>(
                std::move(ks.wire_accum));
            ks.wire_accum.clear();
            auto d = std::make_shared<Buf>();
            d->resize(ks.len);  // ScatterWire zero-fills it whole
            ScatterWire(w->data(), ks.comp.k, (float*)d->data(),
                        ks.comp.n);
            DebugPrint("RECOMPRESS", m.key, d->data(), ks.len, F32);
            ks.pub = std::move(d);
            ks.pub_wire = std::move(w);
            ks.recv_count = 0;
            ks.round_codec = 0;
            ks.completed_rounds++;
            PublishHealth(ks, ks.pub->data(), ks.len, F32, nullptr);
            chaos_.round_completed();
            WindowPublishLocked(ks, &flush, &defer);
          }
          goto ack;  // shared ACK + parked-pull flush tail
        }
        // fell back: wire_accum expanded into dense accum; the generic
        // path below decompresses THIS payload and adds it
      }
      if (num_workers_ == 1 && ks.recv_count == 0 &&
          (ks.comp.type == CompressorCfg::ONEBIT ||
           ks.comp.type == CompressorCfg::TOPK) &&
          ks.comp.ValidLen(m.size())) {
        // single-worker round: the aggregate IS the payload, and for
        // these codecs recompress(decompress(p)) is bit-stable (onebit:
        // signs unchanged, scale = mean|±scale| = scale; topk: same
        // support and values), so publish the pushed wire by MOVE and
        // decompress once for the dense view — skipping the accum
        // memcpy and the recompress pass. The 1-worker analogue of the
        // dense path's first-copy publish. (randomk has its own wire-
        // form path above; dithering is NOT requantization-stable.)
        auto d = std::make_shared<Buf>();
        // buffer-steal only for onebit: its Decompress is infallible
        // after ValidLen, so the published aggregate can't be clobbered
        // by a failing decode (topk can reject bad indices mid-scatter)
        if (ks.comp.type == CompressorCfg::ONEBIT && ks.pub &&
            ks.pub.use_count() == 1 && ks.pub->size() == ks.len) {
          *d = std::move(
              *std::const_pointer_cast<Buf>(ks.pub));
          ks.pub.reset();
        } else {
          d->resize(ks.len);
        }
        uint64_t t0 = now_ns();
        if (ks.comp.Decompress(m.data(), (uint32_t)m.size(),
                               (float*)d->data(), &ks.round_idx)) {
          RecordFold(t0, m.size());
          ks.total_pushes++;
          if (m.sender < ks.worker_push_count.size())
            ks.worker_push_count[m.sender]++;
          if (m.sender < ks.pull_abort.size()) ks.pull_abort[m.sender] = 0;
          RecordRound(ks, m);
          DebugPrint("RECOMPRESS", m.key, d->data(), ks.len, F32);
          // publish the pushed wire by move (owned payload) or by one
          // copy out of the shm arena (out-of-band payload)
          auto w = std::make_shared<Buf>();
          if (m.oob)
            w->assign(m.data(), m.data() + m.size());
          else
            *w = std::move(m.payload);
          ks.pub = std::move(d);
          ks.pub_wire = std::move(w);
          ks.round_codec = 0;  // round completed without recv_count ever
                               // incrementing (single-worker publish)
          ks.completed_rounds++;
          PublishHealth(ks, ks.pub->data(), ks.len, F32, nullptr);
          chaos_.round_completed();
          WindowPublishLocked(ks, &flush, &defer);
          goto ack;
        }
        // invalid wire: fall through to the generic path's error report
      }
      uint64_t t_fold = now_ns();
      bool fused_decoded = false;
      if (ks.comp.type == CompressorCfg::LOSSLESS && fused_decode_) {
        // decompress-on-the-fabric: decode straight into the
        // accumulator / fold, skipping the dense scratch pass (and on
        // the first push of a round, the scratch->accum memcpy too)
        fused_decoded = LosslessDecodeInto(m.data(), (uint32_t)m.size(),
                                           ks);
      }
      if (!fused_decoded &&
          !ks.comp.Decompress(m.data(), (uint32_t)m.size(),
                              ks.scratch.data(),
                              ks.recv_count == 0 ? &ks.round_idx : nullptr)) {
        // Decompress validates the length itself (exact for the fixed
        // formats, bounded for the variable varint dithering wire)
        std::fprintf(stderr,
                     "[bps-server] compressed push rejected key=%llu "
                     "len=%zu bound=%u\n",
                     (unsigned long long)m.key, m.size(),
                     ks.comp.WireLen());
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      ks.total_pushes++;
      if (m.sender < ks.worker_push_count.size())
        ks.worker_push_count[m.sender]++;
      if (m.sender < ks.pull_abort.size()) ks.pull_abort[m.sender] = 0;
      RecordRound(ks, m);
      if (!fused_decoded) {
        DebugPrint("DECOMPRESS", m.key, ks.scratch.data(),
                   ks.comp.n * 4, F32);
        // defensive resize: accum can be moved-out empty after a dense
        // round on this key (ALL_RECV publish-by-move); the first recv
        // of a compressed round writes the full dense length
        if (ks.recv_count == 0 && ks.accum.size() != ks.len)
          ks.accum.assign(ks.len, 0);
        float* accum = (float*)ks.accum.data();
        if (ks.recv_count == 0) {
          std::memcpy(accum, ks.scratch.data(),
                      ks.comp.n * sizeof(float));
        } else {
          kernels_.f32(accum, ks.scratch.data(), ks.comp.n);
        }
      }
      RecordFold(t_fold, m.size());
      ks.recv_count++;
      if ((int)ks.recv_count >= num_workers_) {
        // ALL_RECV: recompress the dense aggregate (server.cc:345-375 with
        // the compression hook of server.cc:92-118); publish the dense
        // view by MOVING the accumulator (diagnostics + un-compressed
        // pulls keep working), then restore a full-size accum for the
        // next round's first scratch memcpy — stealing the previous
        // published buffer when no in-flight send still references it
        auto d = std::make_shared<Buf>(
            std::move(ks.accum));
        DebugPrint("RECOMPRESS", m.key, d->data(), ks.len, F32);
        auto w = std::make_shared<Buf>(ks.comp.WireLen());
        uint32_t wl = ks.comp.Compress((const float*)d->data(), w->data(),
                                       ks.completed_rounds, ks.round_idx);
        w->resize(wl);  // varint wires are variable-length
        if (ks.pub && ks.pub.use_count() == 1 &&
            ks.pub->size() == ks.len) {
          ks.accum = std::move(
              *std::const_pointer_cast<Buf>(ks.pub));
        } else {
          ks.accum.assign(ks.len, 0);
        }
        ks.pub = std::move(d);
        ks.pub_wire = std::move(w);
        ks.recv_count = 0;
        ks.round_codec = 0;
        ks.completed_rounds++;
        PublishHealth(ks, ks.pub->data(), ks.len, F32, nullptr);
        chaos_.round_completed();
        WindowPublishLocked(ks, &flush, &defer);
      }
    }
  ack:
    if (!fused) {
      MsgHeader r = ReplyHeader(ACK, 0, 0, m.rid, m.key);
      QueueReply(m.conn, r, nullptr);
    }
    for (auto& p : flush) AnswerPull(ks, p);
    // fused: the compressed-wire aggregate IS the reply — parked (or
    // answered now) instead of the push ACK
    if (fused) FusedReply(ks, m, /*compressed=*/true);
    // a publish unblocks the NEXT round: fold its parked (deferred)
    // pushes now that their round is current
    RedispatchDeferred(defer);
  }

  void DoPushSparse(EngineMsg& m, KeyStore& ks, bool fused) {
    // kRowSparsePushPull — the op the reference reserves but never
    // implements (common.h:267-271, server.h:39-41). Self-describing
    // payload: [u32 nrows][u32 width_f32s][i32 ids[nrows]]
    // [f32 rows[nrows*width]]; the server scatter-adds the rows into the
    // dense store, so sparse pushes (embedding gradients) and dense pulls
    // compose with the normal round protocol — and with dense pushes
    // from other workers in the same round.
    std::vector<ParkedPull> flush;
    std::vector<EngineMsg> defer;
    bool ok = false;
    {
      std::lock_guard<Mu> lk(ks.mu);
      do {
        if (m.conn->dead.load()) break;  // fenced: see Conn::dead
        if (IsReplay(ks, m)) {
          ok = true;  // already folded: answer, don't double-count
          break;
        }
        {
          GateVerdict g = RoundGate(ks, m);
          if (g == kGateDefer && DeferFold(ks, m))
            return;  // answered at redispatch
          if (g != kGateAligned) break;
        }
        if (!CodecTagOk(ks, m)) break;  // rowsparse rides the dense mode
        if (ks.len == 0 || ks.dtype != F32) break;
        if (ks.comp.type != CompressorCfg::NONE) break;  // no comp mixing
        if (m.size() < 8) break;
        uint32_t nrows, width;
        std::memcpy(&nrows, m.data(), 4);
        std::memcpy(&width, m.data() + 4, 4);
        if (width == 0) break;
        size_t want = 8 + (size_t)nrows * 4 + (size_t)nrows * width * 4;
        if (m.size() != want) break;
        uint64_t total_rows = ks.len / ((uint64_t)width * 4);
        if (total_rows * width * 4 != ks.len) break;  // width mismatch
        const int32_t* ids = (const int32_t*)(m.data() + 8);
        const float* vals =
            (const float*)(m.data() + 8 + (size_t)nrows * 4);
        bool bad = false;  // validate BEFORE touching the store
        for (uint32_t i = 0; i < nrows; ++i)
          if (ids[i] < 0 || (uint64_t)ids[i] >= total_rows) { bad = true;
            break; }
        if (bad) break;
        ks.total_pushes++;
        if (m.sender < ks.worker_push_count.size())
          ks.worker_push_count[m.sender]++;
        if (m.sender < ks.pull_abort.size()) ks.pull_abort[m.sender] = 0;
        RecordRound(ks, m);
        if (async_) {
          // async: fold rows straight into the authoritative weights
          // (per-row SIMD f32 fold, like the sync path below)
          uint64_t t0 = now_ns();
          float* w = (float*)ks.merged.data();
          for (uint32_t i = 0; i < nrows; ++i)
            kernels_.f32(w + (size_t)ids[i] * width,
                         vals + (size_t)i * width, width);
          RecordFold(t0, m.size());
          ks.completed_rounds++;
          chaos_.round_completed();
          WindowPublishLocked(ks, &flush, &defer);
          ok = true;
          break;
        }
        if (ks.recv_count == 0) {
          // first push of the round: a previous ALL_RECV moved accum out
          if (ks.accum.size() != ks.len) ks.accum.assign(ks.len, 0);
          std::memset(ks.accum.data(), 0, ks.len);
        }
        uint64_t t0 = now_ns();
        float* accum = (float*)ks.accum.data();
        for (uint32_t i = 0; i < nrows; ++i)
          kernels_.f32(accum + (size_t)ids[i] * width,
                       vals + (size_t)i * width, width);
        RecordFold(t0, m.size());
        ks.recv_count++;
        if ((int)ks.recv_count >= num_workers_) {
          auto d = std::make_shared<Buf>(
              std::move(ks.accum));
          DebugPrint("ALL_RECV", m.key, d->data(), ks.len, ks.dtype);
          ks.pub = std::move(d);
          ks.recv_count = 0;
          ks.round_codec = 0;
          ks.completed_rounds++;
          PublishHealth(ks, ks.pub->data(), ks.len, ks.dtype, nullptr);
          chaos_.round_completed();
          WindowPublishLocked(ks, &flush, &defer);
        }
        ok = true;
      } while (false);
    }
    if (!ok)
      std::fprintf(stderr, "[bps-server] sparse push rejected key=%llu "
                   "len=%zu\n", (unsigned long long)m.key, m.size());
    if (!ok || !fused) {
      MsgHeader r =
          ReplyHeader(ACK, (uint8_t)(ok ? 0 : 1), 0, m.rid, m.key);
      m.conn->send_msg(r, nullptr);
    }
    for (auto& p : flush) AnswerPull(ks, p);
    // fused rowsparse: the reply is the DENSE aggregate (exactly what
    // the two-op path pulls with cmd_dense after its sparse push)
    if (ok && fused) FusedReply(ks, m, /*compressed=*/false);
    RedispatchDeferred(defer);
  }

  void DoPush(EngineMsg& m, bool fused = false) {
    std::vector<ParkedPull> flush;
    std::vector<EngineMsg> defer;
    bool echo_ok = false;  // single-worker fused shm echo fast path
    KeyStore& ks = store_of(m.key);
    if (m.req == kRowSparsePushPull) {
      DoPushSparse(m, ks, fused);
      return;
    }
    {
      std::lock_guard<Mu> lk(ks.mu);
      bool has_comp = ks.comp.type != CompressorCfg::NONE;
      bool is_comp = m.req == kCompressedPushPull;
      if (has_comp != is_comp) {
        // mixing dense and compressed pushes on one key would corrupt the
        // accumulator (dense bytes vs decompressed f32 share it)
        std::fprintf(stderr,
                     "[bps-server] push mode mismatch key=%llu comp=%d "
                     "req=%u\n",
                     (unsigned long long)m.key, (int)has_comp, m.req);
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
    }
    if (m.req == kCompressedPushPull) {
      DoPushCompressed(m, ks, fused);
      return;
    }
    {
      std::lock_guard<Mu> lk(ks.mu);
      if (m.conn->dead.load()) {  // fenced: see Conn::dead
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (ks.len == 0 || m.size() != ks.len) {
        // uninitialized OR size mismatch (stale partitioning after a
        // tensor resize): error-reply; memcpy/sum with the wrong length
        // would corrupt the heap
        std::fprintf(stderr,
                     "[bps-server] push rejected key=%llu len=%zu store=%u\n",
                     (unsigned long long)m.key, m.size(), ks.len);
        // flags bit0 = error: reply instead of dropping, so the client
        // raises instead of hanging on a never-acked request
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (!IsReplay(ks, m)) {
        // RoundGate before CodecTagOk: a deferred future-round fold
        // must not latch (or be judged by) the current round's codec
        switch (RoundGate(ks, m)) {
          case kGateDefer:
            if (DeferFold(ks, m)) return;  // answered at redispatch
            [[fallthrough]];               // overflow: rejected loudly
          case kGateReject: {
            MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
            m.conn->send_msg(r, nullptr);
            return;
          }
          default: break;
        }
        if (!CodecTagOk(ks, m)) {
          MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
          m.conn->send_msg(r, nullptr);
          return;
        }
        ks.total_pushes++;
        if (m.sender < ks.worker_push_count.size())
          ks.worker_push_count[m.sender]++;
        if (m.sender < ks.pull_abort.size()) ks.pull_abort[m.sender] = 0;
        RecordRound(ks, m);
        if (async_) {
          // async: sum straight into merged (server.cc:315-319)
          uint64_t t0 = now_ns();
          sum_into(ks.merged.data(), m.data(), m.size(), ks.dtype,
                   kernels_);
          RecordFold(t0, m.size());
          ks.completed_rounds++;
          chaos_.round_completed();
          WindowPublishLocked(ks, &flush, &defer);
        } else {
          DebugPrint(ks.recv_count == 0 ? "COPY_FIRST" : "SUM_RECV",
                     m.key, m.data(), (uint32_t)m.size(), ks.dtype);
          uint64_t t0 = now_ns();
          // captured BEFORE the adopt-move below empties m.payload
          size_t fold_len = m.size();
          // in-fold health statistics (BYTEPS_HEALTH): the round's
          // LAST f32 fold runs the fused stat kernel — same add
          // instructions, same stored bits, the freshly-written lanes
          // feed the accumulators in the same pass. Adopt-only rounds
          // (first push, num_workers==1) and bf16 take the publish
          // scan instead.
          HStat hs;
          bool hs_fused = false;
          if (ks.recv_count == 0) {
            if (m.oob) {
              // out-of-band first push: ONE copy out of the shared
              // arena into the (pool-recycled) accumulator — the shm
              // analogue of the direct-recv adopt below
              if (ks.accum.size() != ks.len) {
                if (ks.accum.capacity() < ks.len)
                  ks.accum = pool_.lease(ks.len);
                else
                  ks.accum.resize(ks.len);
              }
              std::memcpy(ks.accum.data(), m.data(), m.size());
            } else {
              // first push of the round ADOPTS the payload buffer (no
              // copy; the reference memcpys here, server.cc:329-333).
              // On the direct-recv tier the bytes were received
              // STRAIGHT into this buffer — socket to accumulator with
              // zero intermediate copies.
              ks.accum = std::move(m.payload);
            }
          } else if (health_ && ks.dtype == F32 &&
                     (int)ks.recv_count + 1 >= num_workers_) {
            kernels_.f32_stat((float*)ks.accum.data(),
                              (const float*)m.data(), m.size() / 4,
                              &hs);
            hs.elems = m.size() / 4;
            hs_fused = true;
          } else {
            sum_into(ks.accum.data(), m.data(), m.size(), ks.dtype,
                     kernels_);
          }
          RecordFold(t0, fold_len);
          ks.recv_count++;
          if ((int)ks.recv_count >= num_workers_) {
            // ALL_RECV: publish by MOVING the accumulator into the
            // shared published slot (no copy); accum is left empty —
            // the next round's first push adopts its own payload buffer
            // anyway. The REPLACED published buffer, once no in-flight
            // send pins it, recycles into the payload pool — closing
            // the pool -> direct_buf/payload -> accum -> pub -> pool
            // rotation at zero steady-state allocations.
            auto d = std::make_shared<Buf>(
                std::move(ks.accum));
            DebugPrint("ALL_RECV", m.key, d->data(), ks.len, ks.dtype);
            auto old = std::move(ks.pub);
            ks.pub = std::move(d);
            if (old && old.use_count() == 1)
              pool_.put(std::move(*std::const_pointer_cast<Buf>(old)));
            ks.recv_count = 0;
            ks.round_codec = 0;
            ks.completed_rounds++;
            PublishHealth(ks, ks.pub->data(), ks.len, ks.dtype,
                          hs_fused ? &hs : nullptr);
            chaos_.round_completed();
            WindowPublishLocked(ks, &flush, &defer);
            // Echo eligibility: a single-worker round just completed
            // from THIS out-of-band payload, so the published
            // aggregate is bit-identical to the bytes still sitting
            // in the client's c2s arena block — the fused reply can
            // hand that block back as a descriptor instead of copying
            // the payload into the s2c arena (m.oob implies the conn
            // committed the shm upgrade).
            echo_ok = fused && m.oob != nullptr && num_workers_ == 1;
          }
        }
      }
      // replay: nothing folded — the ACK / FusedReply tail below still
      // answers, so the retrying worker gets the aggregate its dropped
      // reply carried
    }
    if (!fused) {
      // ack the push (ZPush completion callback)
      MsgHeader r = ReplyHeader(ACK, 0, 0, m.rid, m.key);
      QueueReply(m.conn, r, nullptr);
    }
    for (auto& p : flush) AnswerPull(ks, p);
    // fused: the aggregate IS the reply — park or answer instead of ACK
    if (fused) {
      if (echo_ok) {
        // zero-copy echo reply: 8 ring bytes instead of a payload
        // copy; on success the c2s block's ownership transfers to the
        // client (it releases after copying into its own out buffer),
        // so the engine epilogue must NOT release it here. A chaos
        // drop or send failure keeps ownership local — the epilogue
        // release then runs as usual and the client retries.
        if (chaos_.swallow_reply()) {
          Flight(kFlightChaosDrop, m.key, m.rid, m.sender);
          std::fprintf(stderr,
                       "[bps-server] CHAOS: dropped echo reply rid=%u "
                       "sender=%u\n", m.rid, (unsigned)m.sender);
        } else {
          MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, m.rid, 0, 0,
                                    (uint32_t)m.size());
          uint64_t t0 = now_ns();
          bool sent = m.conn->send_echo(r, m.oob_off);
          stats_.reply_ns.fetch_add(now_ns() - t0,
                                    std::memory_order_relaxed);
          stats_.reply_count.fetch_add(1, std::memory_order_relaxed);
          if (sent) {
            m.oob_chan = nullptr;  // client now owns the block
            m.oob = nullptr;
          }
          TraceReply({m.conn, m.rid, m.sender, false, m.traced, m.key});
        }
      } else {
        FusedReply(ks, m, /*compressed=*/false);
      }
    }
    RedispatchDeferred(defer);
  }

  // Readiness of a parked (or about-to-park) pull — call under ks.mu.
  // Round-stamped pulls under the cross-barrier window wait for THEIR
  // round to publish (pub_round): the positional push-count rule
  // cannot distinguish two parked rounds of one key. Everything else —
  // unstamped pulls, window off — keeps the positional bookkeeping:
  // ready once every round this worker pushed has completed.
  bool PullReady(KeyStore& ks, const ParkedPull& p) {
    if (async_) return true;
    if (window_ && p.round) return ks.pub_round >= p.round;
    uint64_t pushed = p.sender < ks.worker_push_count.size()
                          ? ks.worker_push_count[p.sender] : 0;
    return ks.completed_rounds >= pushed;
  }
  bool ParkedReadyLocked(KeyStore& ks, const ParkedPull& p) {
    return PullReady(ks, p);
  }

  // kind-1 reply trace event for a sampled request whose aggregate just
  // left — rid-joins with its kind-0 request span in the fused timeline
  void TraceReply(const ParkedPull& p) {
    if (!p.traced) return;
    TraceRec t{};
    t.t0 = now_ns();
    t.rid = p.rid;
    t.sender = p.sender;
    t.op = PULL_REPLY;
    t.kind = 1;
    trace_ring_.push(t);
  }

  void AnswerPull(KeyStore& ks, const ParkedPull& p) {
    // chaos injection point: delay, then (deterministically) drop the
    // aggregate reply — the requester times out and retries; the epoch
    // dedup above guarantees the retry can't double-count
    if (chaos_.swallow_reply()) {
      Flight(kFlightChaosDrop, p.key, p.rid, p.sender);
      std::fprintf(stderr,
                   "[bps-server] CHAOS: dropped reply rid=%u sender=%u\n",
                   p.rid, (unsigned)p.sender);
      return;
    }
    if (async_) {
      // async: merged mutates in place on every push; snapshot under the
      // key lock so the send reads a consistent weight vector
      Buf snapshot;
      {
        std::lock_guard<Mu> lk(ks.mu);
        snapshot = ks.merged;
      }
      MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, p.rid, 0, 0,
                                (uint32_t)snapshot.size());
      uint64_t t0 = now_ns();
      p.conn->send_msg(r, snapshot.data());
      stats_.reply_ns.fetch_add(now_ns() - t0,
                                std::memory_order_relaxed);
      stats_.reply_count.fetch_add(1, std::memory_order_relaxed);
      TraceReply(p);
      return;
    }
    // sync: zero-copy — ALL_RECV swaps the published shared_ptr and never
    // mutates the published bytes, so the send can read the buffer
    // outside the key lock; the refcount pins it across the send even if
    // the next round publishes a replacement (reference: cached per-key
    // response buffers, server.cc:39-80)
    std::shared_ptr<const Buf> snap;
    {
      std::lock_guard<Mu> lk(ks.mu);
      snap = p.compressed ? ks.pub_wire : ks.pub;
      if (window_ && p.round) {
        // windowed round-stamped reply: serve the EXACT round the pull
        // waited for from the history ring — the live pub may already
        // be a newer round. Missing from the ring (evicted; only
        // possible across a migration/re-init) falls back to the
        // newest published view, matching the post-migration legacy
        // behavior.
        for (auto& h : ks.pub_hist) {
          if (h.round == p.round) {
            snap = p.compressed ? h.pub_wire : h.pub;
            break;
          }
        }
      }
    }
    if (!snap) {  // defensive: pull answered before any init
      MsgHeader r = ReplyHeader(ACK, 1, 0, p.rid);
      p.conn->send_msg(r, nullptr);
      return;
    }
    MsgHeader r = ReplyHeader(PULL_REPLY, 0, 0, p.rid, 0, 0,
                              (uint32_t)snap->size());
    // reply stage: on an engine thread the header + shared aggregate
    // become a tx-ring entry (the snap shared_ptr pins the published
    // buffer until the batch flushes) and leave with the rest of the
    // round's replies in one gathered sendmsg; elsewhere — and on shm —
    // the legacy single gathered send / arena write
    uint64_t t0 = now_ns();
    QueueReply(p.conn, r, snap);
    stats_.reply_ns.fetch_add(now_ns() - t0, std::memory_order_relaxed);
    stats_.reply_count.fetch_add(1, std::memory_order_relaxed);
    TraceReply(p);
  }

  void DoPull(EngineMsg& m) {
    KeyStore& ks = store_of(m.key);
    bool ready;
    bool uninit = false;
    bool comp = m.req == kCompressedPushPull;
    {
      std::lock_guard<Mu> lk(ks.mu);
      if (m.conn->dead.load()) {  // fenced: see Conn::dead
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      if (m.sender < ks.pull_abort.size() && ks.pull_abort[m.sender]) {
        // this worker's round was aborted by a peer departure after it
        // pushed: serving the previous round's aggregate would be a
        // silent stale read — error so the worker retries the round
        ks.pull_abort[m.sender] = 0;
        Flight(kFlightPullAbort, m.key, m.rid, m.sender);
        MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
        m.conn->send_msg(r, nullptr);
        return;
      }
      uninit = ks.len == 0 ||
               (comp && ks.comp.type == CompressorCfg::NONE);
      ParkedPull p{m.conn, m.rid,   m.sender, comp,
                   m.traced, m.key, m.epoch >> 16};
      ready = !uninit && PullReady(ks, p);
      if (!uninit && !ready) ks.parked_pulls.push_back(p);
    }
    if (uninit) {
      // pull before init: error reply (DoInit never flushes parked pulls,
      // so parking here would hang the client forever)
      std::fprintf(stderr, "[bps-server] pull before init key=%llu\n",
                   (unsigned long long)m.key);
      MsgHeader r = ReplyHeader(ACK, 1, 0, m.rid, m.key);
      m.conn->send_msg(r, nullptr);
      return;
    }
    if (ready)
      AnswerPull(ks, {m.conn, m.rid, m.sender, comp, m.traced, m.key,
                      m.epoch >> 16});
  }

  // per-stage value printing for one key (reference: BYTEPS_SERVER_DEBUG
  // + BYTEPS_SERVER_DEBUG_KEY, server.cc:120-144)
  void DebugPrint(const char* stage, uint64_t key, const void* data,
                  uint32_t len, uint32_t dtype) {
    if (debug_key_ < 0 || (uint64_t)debug_key_ != key) return;
    double first = 0;
    if (len >= 4 && dtype == F32) first = *(const float*)data;
    else if (len >= 8 && dtype == F64) first = *(const double*)data;
    else if (len >= 1) first = *(const uint8_t*)data;
    std::fprintf(stderr, "[bps-server-debug] key=%llu stage=%s len=%u "
                 "first=%g\n", (unsigned long long)key, stage, len, first);
  }

  int port_;
  int num_workers_;
  bool async_;
  bool schedule_;
  int64_t debug_key_ = -1;
  Throttle throttle_;  // BYTEPS_SERVER_THROTTLE_MBPS, off by default
  Chaos chaos_;        // BYTEPS_CHAOS_*, off by default
  // latched by DRAIN_REQ (advisory; surfaced as the `draining` stat
  // slot so detectors/operators can see the lifecycle state remotely)
  std::atomic<bool> draining_{false};
  int listen_fd_ = -1;
  std::atomic<bool> shutting_down_{false};
  std::atomic<int> shutdown_count_{0};

  std::vector<std::unique_ptr<EngineQueue>> queues_;
  std::vector<std::thread> engine_threads_;
  int n_engines_ = 1;
  // cumulative queued payload bytes per engine: written once per
  // message inside ThreadForKey (under assign_mu_); atomic because
  // bps_server_engine_bytes reads without the lock
  std::unique_ptr<std::atomic<uint64_t>[]> engine_bytes_;
  std::unordered_map<uint64_t, int> key_thread_;
  Mu assign_mu_;
  FoldKernels kernels_;  // BYTEPS_SIMD, resolved per Server
  StageStats stats_;     // per-stage data-plane accounting
  // observability plane (members are mutable-free: EventRing locks
  // internally, so handlers record from any thread)
  long trace_sample_;               // BYTEPS_TRACE_SAMPLE; 0 = off
  std::atomic<uint64_t> trace_seq_{0};
  EventRing<TraceRec> trace_ring_;
  EventRing<FlightRec> flight_ring_;
  // training-health plane (BYTEPS_HEALTH): in-fold statistics pass +
  // the cumulative counters behind the health_rounds/health_nonfinite
  // stat slots
  bool health_;
  std::atomic<uint64_t> health_rounds_{0};
  std::atomic<uint64_t> health_nonfinite_{0};
  // cross-barrier staleness window (BYTEPS_STALENESS /
  // BYTEPS_CROSS_BARRIER): how many rounds AHEAD of the currently
  // accepting one a stamped fold may arrive and be parked instead of
  // rejected. 0 = strict same-round gate (today's semantics).
  uint64_t window_;
  // cumulative window verdicts behind the window_deferred /
  // window_rejected stat slots (engaged-proof for the barrier_ab
  // bench; a rejection is also a kFlightRoundSkew flight event)
  std::atomic<uint64_t> window_deferred_{0};
  std::atomic<uint64_t> window_rejected_{0};
  BufPool pool_;         // recycled payload/fold-scratch buffers
  // decompress-on-the-fabric flag (BYTEPS_FUSED_DECODE; per instance)
  bool fused_decode_;
  // RDMA-shaped registration of pool blocks (see TransportReg)
  TransportReg reg_;

  // ---- stripe reassembly plane (kFlagSeg) ------------------------- //
  // A striped message of one (sender, key, seq) arrives as nseg
  // segments spread over the sender's data connections. Each conn loop
  // receives its segment's chunk straight into the shared assembly
  // buffer (disjoint [off, off+chunk) ranges, written OUTSIDE the
  // lock); the loop that lands the last segment dispatches the
  // reassembled message. The per-(sender,key) seq gate re-establishes
  // the sender's send order across conns — without it two rounds of one
  // key racing different stripes could reach the engine inverted.
  struct StripeAsm {
    MsgHeader base;                 // header with kFlagSeg cleared later
    uint32_t seq = 0;
    Buf buf;                        // pooled; becomes EngineMsg payload
    uint32_t nseg = 0;
    uint32_t got = 0;               // guarded-by: stripe_mu_
    std::vector<uint8_t> seen;      // per-segment dup guard
    std::shared_ptr<Conn> reply_conn;  // segment 0's conn = home conn
  };
  struct StripeGate {
    uint32_t next = 0;     // next seq to dispatch for this (sender,key)
    bool resync = false;   // a stripe conn died: adopt the next
                           // completed seq instead of waiting forever
    std::map<uint32_t, EngineMsg> held;  // completed but out-of-order
  };
  Mu stripe_mu_;
  std::map<std::tuple<uint16_t, uint64_t, uint32_t>,
           std::shared_ptr<StripeAsm>> stripe_asm_;
  std::map<std::pair<uint16_t, uint64_t>, StripeGate> stripe_gates_;

  std::unordered_map<uint64_t, KeyStore> stores_;
  Mu stores_mu_;  // guards only the map itself; data ops take the
                          // per-key KeyStore::mu (finer than the
                          // reference's single handle_mu_, server.cc:208)

  struct ConnTracker {
    Mu mu;
    Cv cv;
    int live = 0;
  };
  std::shared_ptr<ConnTracker> conn_tracker_ =
      std::make_shared<ConnTracker>();

  // per-lane registry (time-series plane): weak refs so conn lifetime
  // stays with the conn thread / parked pulls; StripeSlots prunes
  // expired entries in passing. lane_seq_ hands each accepted conn a
  // stable monotone lane id.
  Mu conns_mu_;
  std::vector<std::weak_ptr<Conn>> all_conns_;  // guarded-by: conns_mu_
  std::atomic<uint64_t> lane_seq_{0};

  Mu barrier_mu_;
  std::vector<ParkedPull> barrier_waiters_;

  // failure detection: live connection count per worker id, workers
  // presumed dead (their still-queued engine messages must be dropped —
  // a stale push landing in a re-armed round would corrupt it), and
  // workers that announced a clean SHUTDOWN (their conn closures are
  // graceful, not failures)
  Mu worker_conns_mu_;
  std::unordered_map<int, int> worker_conns_;
  std::unordered_set<int> clean_exit_;
};

// ------------------------------------------------------------------ //
// client
// ------------------------------------------------------------------ //

// One fused-request completion, drained in batches by the worker's
// Python reactor thread (bps_client_cq_poll). status: 0 ok, -1 failed
// (server error reply, oversized reply, or connection death), -2 the
// client-side request timeout expired.
struct CompletionRec {
  uint64_t ticket;
  int32_t status;
  uint32_t len;
};

// MPSC completion queue: per-connection recv loops push, ONE reactor
// thread pops. This is what replaces the thread-parked-in-recv model —
// any number of fused requests can be in flight while the reactor is
// the only thread that ever blocks.
class CompletionQueue {
 public:
  void push(const CompletionRec& r) {
    {
      std::lock_guard<Mu> lk(mu_);
      if (closed_) return;  // teardown: nobody will read it
      q_.push_back(r);
    }
    cv_.notify_one();
  }

  // Blocks up to timeout_ms for >=1 record; returns the batch size,
  // 0 on timeout, -1 once closed AND drained (reactor exit signal).
  int pop_batch(CompletionRec* out, int max_n, int timeout_ms) {
    std::unique_lock<Mu> lk(mu_);
    cv_.wait_for_ms(lk, timeout_ms,
                    [&] { return closed_ || !q_.empty(); });
    if (q_.empty()) return closed_ ? -1 : 0;
    int n = 0;
    while (n < max_n && !q_.empty()) {
      out[n++] = q_.front();
      q_.pop_front();
    }
    return n;
  }

  int depth() {
    std::lock_guard<Mu> lk(mu_);
    return (int)q_.size();
  }

  void close() {
    {
      std::lock_guard<Mu> lk(mu_);
      closed_ = true;
    }
    cv_.notify_all();
  }

 private:
  Mu mu_;
  Cv cv_;
  std::deque<CompletionRec> q_;
  bool closed_ = false;
};

// Request ids are unique across EVERY connection of this process (not
// merely per conn, the waiter-table requirement): a server-side trace
// record's rid then names exactly one worker request, which is what
// lets the fused timeline draw a flow arrow from a worker PUSHPULL
// span to the server's recv/queue/fold spans without guessing which
// striped conn carried it. u32 wrap at 4B requests is fine — live
// rids are only ever the handful in flight.
static std::atomic<uint32_t> g_next_rid{1};

struct Waiter {
  // Raw pthread primitives with EXPLICIT init/destroy — not std::mutex.
  // glibc's Mu is zero-initialized and never calls
  // pthread_mutex_init, so TSAN cannot distinguish a fresh mutex from
  // whatever previously lived at the same heap address: once any
  // destroyed lock (a reaped CPython Future's condition, say) occupied
  // the block, every later Waiter there reports "double lock of a
  // destroyed mutex" (the PR-6 finding's second half; the first half —
  // mid-life Waiter churn — is fixed by the conn's Waiter pool). The
  // explicit pthread_mutex_init/cond_init are TSAN-intercepted and
  // reset the sync-object state at construction.
  pthread_mutex_t mu;
  pthread_cond_t cv;
  Waiter() {
    pthread_mutex_init(&mu, nullptr);
    pthread_condattr_t a;
    pthread_condattr_init(&a);
    pthread_condattr_setclock(&a, CLOCK_MONOTONIC);
    pthread_cond_init(&cv, &a);
    pthread_condattr_destroy(&a);
  }
  ~Waiter() {
    pthread_mutex_destroy(&mu);
    pthread_cond_destroy(&cv);
  }
  bool done = false;
  void* out = nullptr;
  uint32_t out_len = 0;
  uint32_t got_len = 0;
  bool ok = true;
  // detached = fire-and-forget request (async push): nobody waits on cv;
  // an error reply instead poisons the connection (fail-fast for the
  // paired pull, which would otherwise park server-side forever)
  bool detached = false;
  // fused = PUSHPULL: no thread waits on cv either — the reply lands in
  // `out` and a CompletionRec carrying `ticket` goes to the client's
  // completion queue (status -1 on any failure, -2 on timeout expiry)
  bool fused = false;
  uint64_t ticket = 0;
  std::chrono::steady_clock::time_point sent_at;
};

// Wait until w->done or `timeout_s` elapses (<=0 = infinite); caller
// holds w->mu. Returns the done flag (false = timed out).
static bool waiter_wait_done(Waiter* w, long timeout_s) {
  if (timeout_s <= 0) {
    while (!w->done) pthread_cond_wait(&w->cv, &w->mu);
    return true;
  }
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  ts.tv_sec += timeout_s;
  while (!w->done) {
    if (pthread_cond_timedwait(&w->cv, &w->mu, &ts) == ETIMEDOUT)
      return w->done;
  }
  return true;
}

class ServerConn {
 public:
  // completion queue for fused requests (owned by the Client, shared by
  // every conn); set once before Connect
  void set_cq(CompletionQueue* cq) { cq_ = cq; }

  ~ServerConn() {
    // a partially-connected group destroyed on Connect failure must not
    // abort the process: Close() joins the recv thread (std::thread's
    // destructor terminates on a joinable thread) and releases the fd
    Close();
  }

  bool Connect(const std::string& host, int port, uint16_t sender) {
    fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (::inet_pton(AF_INET, host.c_str(), &addr.sin_addr) != 1) {
      ::close(fd_);
      fd_ = -1;
      return false;
    }
    for (int attempt = 0; attempt < 200; ++attempt) {
      if (::connect(fd_, (sockaddr*)&addr, sizeof(addr)) == 0) {
        tune_socket(fd_);
        // loopback => same machine: offer the shm transport before any
        // other traffic (so the upgrade handshake never races in-flight
        // requests). Falls back to TCP if the server declines. The hello
        // must carry the real worker id — the server latches a conn's
        // owner from its FIRST message (failure detection counts live
        // conns per worker).
        if (ipc_enabled() && ntohl(addr.sin_addr.s_addr) >> 24 == 127)
          TryIpcUpgrade(sender);
        recv_thread_ = std::thread([this] { RecvLoop(); });
        return true;
      }
      // POSIX leaves a socket unspecified after a failed connect():
      // close and recreate before retrying (some kernels fail every
      // subsequent attempt on the stale fd)
      ::close(fd_);
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
      ::usleep(50 * 1000);  // server may not be up yet (rendezvous retry)
    }
    ::close(fd_);
    fd_ = -1;
    return false;
  }

  bool ipc_active() const { return chan_ != nullptr; }

  void Close() {
    // shutdown() wakes the recv thread without invalidating the fd; the
    // close() must wait for the join — closing an fd another thread is
    // blocked on is a race (and could close a reused descriptor). For an
    // ipc conn, mark_broken unblocks a recv parked in a futex wait and
    // the fd shutdown doubles as the death signal to the server.
    if (chan_) chan_->mark_broken();
    if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
    if (recv_thread_.joinable()) recv_thread_.join();
    if (fd_ >= 0) {
      ::close(fd_);
      fd_ = -1;
    }
  }

  // ---- Waiter pool ---------------------------------------------------
  // Waiters are RECYCLED through a per-conn free list, never freed while
  // the connection lives. Heap-churning them was the PR-6 TSAN finding
  // ("double lock of a destroyed Waiter mutex", tests/test_sanitize.py):
  // a completed Waiter's block is freed the instant the last shared_ptr
  // drops, the allocator hands the same address to the next request's
  // make_shared, and the new Mu at that address begins life with
  // no init call (glibc's Mu is zero-initialized) while a
  // straggling notify_one from the previous occupant may still be in
  // flight on the old cv. Pooling keeps every mutex/cv alive for the
  // conn's lifetime, so the worst case is a benign spurious wakeup that
  // the wait predicates absorb — and the per-request allocation on the
  // wire hot path disappears with it. Pool size is bounded by peak
  // request concurrency (scheduling credit / pool threads).
  std::shared_ptr<Waiter> AcquireWaiter() {
    std::shared_ptr<Waiter> w;
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      if (!waiter_pool_.empty()) {
        w = std::move(waiter_pool_.back());
        waiter_pool_.pop_back();
      }
    }
    if (!w) w = std::make_shared<Waiter>();
    // reset under w->mu: orders the re-arm after any straggler from the
    // previous occupancy (a late notify / final predicate read)
    pthread_mutex_lock(&w->mu);
    w->done = false;
    w->out = nullptr;
    w->out_len = 0;
    w->got_len = 0;
    w->ok = true;
    w->detached = false;
    w->fused = false;
    w->ticket = 0;
    pthread_mutex_unlock(&w->mu);
    return w;
  }

  // Return a waiter whose operation FULLY completed (its rid is out of
  // waiters_ and exactly one thread — the completer — calls this). Never
  // called on conn-death paths: those waiters just stay alive in the
  // Python-side refs until teardown, which is fine — the pool exists to
  // prevent mid-life address reuse, not to reclaim a dying conn.
  void RecycleWaiter(std::shared_ptr<Waiter> w) {
    std::lock_guard<Mu> lk(waiters_mu_);
    waiter_pool_.push_back(std::move(w));
  }

  // fire-and-forget request (async push): sends and returns immediately.
  // The reply is drained by RecvLoop (detached waiter); an error reply
  // poisons the conn. Per-key ordering with the paired pull comes from
  // connection FIFO — callers MUST route the pull over the SAME conn
  // (Client::pick is key-affine for exactly this reason). Removes the
  // ACK round-trip from the worker's critical path: the pull is the
  // only synchronization (the reference's ps-lite ZPush is equally
  // async, its callback firing off the van thread).
  bool RequestAsync(uint8_t op, uint64_t key, uint32_t cmd, uint16_t sender,
                    const void* data, uint32_t len, uint64_t epoch = 0,
                    uint32_t codec = 0) {
    if (sticky_err_.load()) return false;
    auto w = AcquireWaiter();
    pthread_mutex_lock(&w->mu);
    w->detached = true;
    pthread_mutex_unlock(&w->mu);
    uint32_t rid = g_next_rid.fetch_add(1);
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      // re-check under the sweep's mutex: a poison landing between the
      // entry check and this insert has already run the fail-all sweep,
      // so a waiter registered now would never be completed. sticky is
      // stored BEFORE the sweep takes waiters_mu_, so under this lock
      // either we see it here, or the sweep runs after the insert and
      // fails the waiter.
      if (sticky_err_.load()) return false;
      waiters_[rid] = w;
    }
    MsgHeader h{kMagic, op, 0, sender, rid, key, cmd, len, epoch, codec};
    bool sent;
    {
      std::lock_guard<Mu> lk(send_mu_);
      sent = chan_ ? chan_->send_msg(h, data)
                   : send_msg_iov(fd_, h, data);
    }
    if (!sent) {
      bool ours;
      {
        std::lock_guard<Mu> lk2(waiters_mu_);
        ours = waiters_.erase(rid) != 0;
      }
      if (ours) RecycleWaiter(std::move(w));
    }
    return sent;
  }

  // Fused PUSHPULL: enqueue and RETURN — no thread parks for the reply.
  // The recv loop lands the aggregated payload in `out` and pushes a
  // CompletionRec carrying `ticket` onto the client's completion queue.
  // Returns false when the send failed or the conn is poisoned (the
  // caller raises; no record will ever surface for the ticket).
  bool RequestFused(uint64_t key, uint32_t cmd, uint16_t sender,
                    const void* data, uint32_t len, void* out,
                    uint32_t out_len, uint64_t ticket,
                    uint64_t epoch = 0, uint32_t codec = 0,
                    uint32_t* rid_out = nullptr) {
    if (sticky_err_.load()) return false;
    auto w = AcquireWaiter();
    pthread_mutex_lock(&w->mu);
    w->fused = true;
    w->ticket = ticket;
    w->out = out;
    w->out_len = out_len;
    w->sent_at = std::chrono::steady_clock::now();
    pthread_mutex_unlock(&w->mu);
    uint32_t rid = g_next_rid.fetch_add(1);
    if (rid_out) *rid_out = rid;  // the trace-plane flow-link id
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      // same re-check-under-lock as RequestAsync: a poison landing
      // between the entry check and this insert already ran the
      // fail-all sweep, which would never complete this waiter
      if (sticky_err_.load()) return false;
      waiters_[rid] = w;
    }
    MsgHeader h{kMagic, PUSHPULL, 0, sender, rid, key, cmd, len, epoch,
                codec};
    bool sent;
    {
      std::lock_guard<Mu> lk(send_mu_);
      sent = chan_ ? chan_->send_msg(h, data)
                   : send_msg_iov(fd_, h, data);
    }
    if (!sent) {
      {
        std::lock_guard<Mu> lk2(waiters_mu_);
        if (waiters_.erase(rid) == 0) {
          // the recv loop's fail-all sweep already claimed this waiter
          // and pushed its failure record: report success here so the
          // ticket fails through the completion queue ONCE — returning
          // false too would double-fail the request (caller raise AND
          // reactor callback)
          return true;
        }
      }
      RecycleWaiter(std::move(w));
    }
    return sent;
  }

  // ---- connection striping (kFlagSeg) ------------------------------
  // One striped message spreads over the group's data conns as
  // [MsgHeader|SegHdr|chunk] segments; THIS conn's share leaves as one
  // gathered sendmsg under send_mu_ (the client half of the batched
  // submission ring). The reply rides segment 0's conn — the home conn,
  // where the waiter was registered.
  struct SegPart {
    uint32_t idx;
    uint64_t off;
    uint32_t len;
    const uint8_t* ptr;
  };

  bool SendSegments(MsgHeader base, uint32_t seq, uint32_t nseg,
                    uint64_t total, const SegPart* parts, int np) {
    if (np <= 0) return true;
    if (sticky_err_.load() || chan_) return false;  // TCP-only framing
    std::vector<MsgHeader> hs((size_t)np);
    std::vector<SegHdr> ss((size_t)np);
    std::vector<iovec> iov(3 * (size_t)np);
    uint64_t payload = 0;
    int n = 0;
    for (int i = 0; i < np; ++i) {
      hs[i] = base;
      hs[i].flags |= kFlagSeg;
      hs[i].len = (uint32_t)(sizeof(SegHdr) + parts[i].len);
      ss[i] = SegHdr{seq, parts[i].idx, nseg, 0, parts[i].off, total};
      iov[n].iov_base = &hs[i];
      iov[n++].iov_len = sizeof(MsgHeader);
      iov[n].iov_base = &ss[i];
      iov[n++].iov_len = sizeof(SegHdr);
      iov[n].iov_base = (void*)parts[i].ptr;
      iov[n++].iov_len = parts[i].len;
      payload += parts[i].len;
    }
    std::lock_guard<Mu> lk(send_mu_);
    if (!send_iovs(fd_, iov.data(), n)) return false;
    tx_bytes_.fetch_add(
        payload + (uint64_t)np * (sizeof(MsgHeader) + sizeof(SegHdr)),
        std::memory_order_relaxed);
    return true;
  }

  // Register a fused waiter WITHOUT sending — striped requests
  // transmit their payload themselves via SendSegments across several
  // conns; the waiter (and the reply) live on this, the home conn.
  bool RegisterFused(uint64_t ticket, void* out, uint32_t out_len,
                     uint32_t* rid_out) {
    if (sticky_err_.load()) return false;
    auto w = AcquireWaiter();
    pthread_mutex_lock(&w->mu);
    w->fused = true;
    w->ticket = ticket;
    w->out = out;
    w->out_len = out_len;
    w->sent_at = std::chrono::steady_clock::now();
    pthread_mutex_unlock(&w->mu);
    uint32_t rid = g_next_rid.fetch_add(1);
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      if (sticky_err_.load()) return false;
      waiters_[rid] = w;
    }
    *rid_out = rid;
    return true;
  }

  // Abandon a registered-but-unsent fused waiter. Returns true when
  // THIS call claimed it (caller may fail over to another conn);
  // false means the conn-death sweep already failed the ticket
  // through the completion queue — the caller must NOT double-fail.
  bool UnregisterFused(uint32_t rid) {
    std::shared_ptr<Waiter> w;
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      auto it = waiters_.find(rid);
      if (it == waiters_.end()) return false;
      w = std::move(it->second);
      waiters_.erase(it);
    }
    RecycleWaiter(std::move(w));
    return true;
  }

  // striped-payload bytes this conn carried (headers included) — the
  // bench's per-stripe byte-conservation proof reads these per conn
  uint64_t tx_bytes() const {
    return tx_bytes_.load(std::memory_order_relaxed);
  }

  // fault-injection hook (tests): kill the transport under the group.
  // shutdown() makes every later send fail fast and pops the server's
  // conn loop, without closing an fd the recv thread still owns.
  void KillForTest() {
    if (chan_) chan_->mark_broken();
    if (fd_ >= 0) ::shutdown(fd_, SHUT_RDWR);
  }

  // Expire fused waiters older than `timeout_s` (called from the
  // reactor's poll loop): each expired waiter is REMOVED first (the
  // recv loop's claim point is the waiters_ erasure, so a late reply
  // drains as unknown-rid junk and can never write into an `out`
  // buffer the Python side has already released) and then reported as
  // status -2. Returns how many expired.
  int SweepExpiredFused(long timeout_s) {
    if (timeout_s <= 0) return 0;
    auto cutoff = std::chrono::steady_clock::now() -
                  std::chrono::seconds(timeout_s);
    std::vector<CompletionRec> expired;
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      for (auto it = waiters_.begin(); it != waiters_.end();) {
        auto& w = it->second;
        if (w->fused && w->sent_at < cutoff) {
          expired.push_back({w->ticket, -2, 0});
          // claimed by this sweep (erased before the record is pushed,
          // so a late reply drains as unknown-rid junk): the sweep is
          // the completer — recycle straight back to the pool
          waiter_pool_.push_back(std::move(it->second));
          it = waiters_.erase(it);
        } else {
          ++it;
        }
      }
    }
    for (auto& r : expired) {
      std::fprintf(stderr, "[bps-client] fused pushpull timeout "
                   "(ticket=%llu) after %lds\n",
                   (unsigned long long)r.ticket, timeout_s);
      if (cq_) cq_->push(r);
    }
    return (int)expired.size();
  }

  // Fail every outstanding fused waiter NOW (teardown): records land in
  // the completion queue so the reactor can resolve their callbacks
  // before the native client is destroyed.
  void AbortFused() {
    std::vector<CompletionRec> victims;
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      for (auto it = waiters_.begin(); it != waiters_.end();) {
        if (it->second->fused) {
          victims.push_back({it->second->ticket, -1, 0});
          it = waiters_.erase(it);
        } else {
          ++it;
        }
      }
    }
    for (auto& r : victims)
      if (cq_) cq_->push(r);
  }

  // Whether this conn can never carry traffic again (recv loop exited
  // on transport death, or a rejected async push poisoned it). When
  // EVERY conn of a server's group reports dead, the server itself is
  // presumed dead — the signal the worker-side failover consumes.
  bool dead() const { return sticky_err_.load(); }

  // blocking request: returns got_len or ~0u on failure.
  // ``timeout_s_override`` > 0 bounds THIS request's wait instead of
  // the process-latched BYTEPS_CLIENT_TIMEOUT_S — control-plane pulls
  // (stats/trace/flight/clock) ride it so a wedged server costs a
  // metrics poll seconds, never the data plane's 600s budget.
  uint32_t Request(uint8_t op, uint64_t key, uint32_t cmd, uint16_t sender,
                   const void* data, uint32_t len, void* out,
                   uint32_t out_len, uint64_t epoch = 0,
                   uint32_t codec = 0, long timeout_s_override = -1) {
    if (sticky_err_.load()) return ~0u;
    auto w = AcquireWaiter();
    pthread_mutex_lock(&w->mu);
    w->out = out;
    w->out_len = out_len;
    pthread_mutex_unlock(&w->mu);
    uint32_t rid = g_next_rid.fetch_add(1);
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      // same re-check-under-lock as RequestAsync: close the window
      // between the entry check and the insert, where the fail-all
      // sweep may already have run (a stranded waiter here would block
      // for the full BYTEPS_CLIENT_TIMEOUT_S).
      if (sticky_err_.load()) return ~0u;
      waiters_[rid] = w;
    }
    MsgHeader h{kMagic, op, 0, sender, rid, key, cmd, len, epoch, codec};
    {
      std::lock_guard<Mu> lk(send_mu_);
      bool sent = chan_ ? chan_->send_msg(h, data)
                        : send_msg_iov(fd_, h, data);
      if (!sent) {
        bool ours;
        {
          std::lock_guard<Mu> lk2(waiters_mu_);
          ours = waiters_.erase(rid) != 0;
        }
        if (ours) RecycleWaiter(std::move(w));
        return ~0u;
      }
    }
    // Bounded wait: a live-but-silent server (e.g. a stale process from a
    // previous job parked on an init barrier that can never complete)
    // would otherwise wedge the worker forever. A dead connection already
    // fails fast (RecvLoop's fail-all); this bounds the wedge case.
    // BYTEPS_CLIENT_TIMEOUT_S <= 0 restores infinite waits.
    static const long env_timeout_s = [] {
      const char* e = ::getenv("BYTEPS_CLIENT_TIMEOUT_S");
      return e && *e ? std::atol(e) : 600L;
    }();
    const long timeout_s =
        timeout_s_override > 0 ? timeout_s_override : env_timeout_s;
    pthread_mutex_lock(&w->mu);
    bool done = waiter_wait_done(w.get(), timeout_s);
    if (!done) {
      // abandon the request. Lock order: never take waiters_mu_ while
      // holding w->mu (RecvLoop takes them in the other order).
      pthread_mutex_unlock(&w->mu);
      bool still_ours;
      {
        std::lock_guard<Mu> lk2(waiters_mu_);
        still_ours = waiters_.erase(rid) != 0;
      }
      pthread_mutex_lock(&w->mu);
      if (still_ours) {
        std::fprintf(stderr, "[bps-client] request timeout op=%u key=%llu "
                     "after %lds\n", op, (unsigned long long)key, timeout_s);
        // a late reply drains as unknown-rid junk; this thread claimed
        // the waiter by winning the erase, so it recycles it
        pthread_mutex_unlock(&w->mu);
        RecycleWaiter(std::move(w));
        return ~0u;
      }
      // RecvLoop claimed the waiter concurrently: the reply is being
      // filled into `out` right now — must wait for done (imminent; a
      // dying connection also sets it via fail-all).
      waiter_wait_done(w.get(), 0);
    }
    // the blocking path's completer is THIS thread: read the verdict,
    // release the lock, recycle. RecvLoop's only later touch can be a
    // straggling signal, which a pooled (never-destroyed) cv absorbs.
    uint32_t rc = w->ok ? w->got_len : ~0u;
    pthread_mutex_unlock(&w->mu);
    RecycleWaiter(std::move(w));
    return rc;
  }

 public:
  // client-side transport proof surface: out-of-band descriptor
  // messages sent/received on this conn's shm channel (0 on TCP)
  uint64_t oob_sent() const { return chan_ ? chan_->oob_sent() : 0; }
  uint64_t oob_recvd() const { return chan_ ? chan_->oob_recvd() : 0; }

 private:
  bool rx(void* p, size_t n) {
    return chan_ ? chan_->recv(p, n) : recv_all(fd_, p, n);
  }

  // transport-neutral reply entry: on the shm channel an out-of-band
  // aggregate surfaces as an arena reference (copied ONCE into the
  // waiter's caller-owned buffer below); on TCP oob stays empty.
  bool rx_header(MsgHeader* h, OobRef* oob) {
    if (chan_) return chan_->recv_msg_begin(h, oob);
    oob->ptr = nullptr;
    return recv_all(fd_, h, sizeof(*h));
  }

  // Offer a fresh shm segment over the just-established TCP conn and wait
  // for the verdict synchronously (no recv thread yet, no other traffic).
  // Any failure cleans up and leaves the conn plain TCP.
  void TryIpcUpgrade(uint16_t sender) {
    static std::atomic<uint32_t> seq{0};
    char name[64];
    std::snprintf(name, sizeof(name), "/bps-ipc-%d-%u", (int)::getpid(),
                  seq.fetch_add(1));
    size_t ring = ipc_ring_bytes();
    size_t arena = ipc_arena_bytes();
    size_t total = sizeof(IpcShm) + 2 * ring + 2 * arena;
    int sfd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (sfd < 0) return;
    if (::ftruncate(sfd, (off_t)total) != 0) {
      ::close(sfd);
      ::shm_unlink(name);
      return;
    }
    void* base = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                        sfd, 0);
    ::close(sfd);
    if (base == MAP_FAILED) {
      ::shm_unlink(name);
      return;
    }
    IpcShm* s = reinterpret_cast<IpcShm*>(base);  // pages arrive zeroed
    s->ring_size = (uint32_t)ring;
    s->arena_size = (uint64_t)arena;
    s->magic = kIpcMagic;
    MsgHeader h = ReplyHeader(IPC_HELLO, 0, sender, 0, 0, 0,
                              (uint32_t)std::strlen(name));
    MsgHeader r{};
    // Bound the handshake: a server that stalls or predates IPC_HELLO
    // (version skew) must not wedge Connect() forever. The peeking
    // receive never consumes a partial ACK, so on expiry the byte
    // stream is intact for plain TCP (a late ACK is drained by
    // RecvLoop's unknown-rid path). The upgrade commits on BOTH sides
    // only via the IPC_CONFIRM third leg below — a timed-out client
    // never sends it, so the server abandons its half instead of
    // splitting the transport (client on TCP, server on shm).
    bool ok = send_msg_iov(fd_, h, name) &&
              recv_all_deadline(fd_, &r, sizeof(r), 10000) &&
              r.op == ACK && (r.flags & 1) == 0;
    ::shm_unlink(name);  // server has it mapped (or declined): name gone
    if (!ok) {
      ::munmap(base, total);
      std::fprintf(stderr, "[bps-client] ipc upgrade declined, using TCP\n");
      return;
    }
    MsgHeader c = ReplyHeader(IPC_CONFIRM, 0, sender, 0);
    if (!send_msg_iov(fd_, c, nullptr)) {
      ::munmap(base, total);
      return;
    }
    chan_.reset(new IpcChan(base, total, fd_, false));
  }

  void RecvLoop() {
    MsgHeader h;
    OobRef oob;
    while (rx_header(&h, &oob)) {
      std::shared_ptr<Waiter> w;
      {
        std::lock_guard<Mu> lk(waiters_mu_);
        auto it = waiters_.find(h.rid);
        if (it != waiters_.end()) {
          w = it->second;
          waiters_.erase(it);
        }
      }
      if (!w) {  // unknown rid: drain (or release) the payload
        if (oob.ptr) {
          if (oob.echo)
            chan_->oob_echo_release(oob.off);
          else
            chan_->oob_release(oob.off);
        } else if (h.len) {
          junk_.resize(h.len);  // reused scratch: recv loop is 1 thread
          if (!rx(junk_.data(), h.len)) break;
        }
        continue;
      }
      bool ok = true;
      bool len_mismatch = false;
      if (h.len) {
        if (oob.ptr) {
          // descriptor-tier reply: the aggregate sits in the shared
          // arena — ONE copy into the caller's (arena-leased) buffer,
          // then release; no ring transit, no intermediate staging
          if (w->out && h.len <= w->out_len)
            std::memcpy(w->out, oob.ptr, h.len);
          else if (w->out)
            len_mismatch = true;
          if (oob.echo)
            chan_->oob_echo_release(oob.off);
          else
            chan_->oob_release(oob.off);
        } else if (w->out && h.len <= w->out_len) {
          ok = rx(w->out, h.len);
        } else {
          junk_.resize(h.len);
          ok = rx(junk_.data(), h.len);
          // a reply LARGER than the waiter's buffer was drained, not
          // delivered (e.g. a tensor resize raced an in-flight pull):
          // reporting success would hand the caller h.len > out_len
          // with the output buffer unwritten
          if (w->out) len_mismatch = true;
        }
      }
      bool server_err = (h.flags & 1) != 0;
      if (w->fused) {
        // fused completion: payload already landed in w->out above (or
        // was drained on a size mismatch); hand the verdict to the
        // reactor via the completion queue — no cv, no parked thread
        if (cq_)
          cq_->push({w->ticket,
                     (ok && !server_err && !len_mismatch) ? 0 : -1,
                     h.len});
        if (!ok) break;  // transport died mid-payload: fail-all below
        RecycleWaiter(std::move(w));  // record pushed: rid done for good
        continue;
      }
      if (w->detached) {
        // async push ACK: success is silent; an error poisons the conn
        // (sticky) and fails everything in flight on it NOW — the
        // paired pull can never be answered (the server didn't count
        // the push), so prompt failure beats a 600s client timeout
        if (!(ok && !server_err)) {
          sticky_err_.store(true);
          std::fprintf(stderr, "[bps-client] async push rejected "
                       "key=%llu; failing conn\n",
                       (unsigned long long)h.key);
          break;  // drop to the fail-all tail below
        }
        RecycleWaiter(std::move(w));  // silent success: nobody else waits
        continue;
      }
      pthread_mutex_lock(&w->mu);
      w->got_len = h.len;
      w->ok = ok && !server_err && !len_mismatch;
      w->done = true;
      pthread_mutex_unlock(&w->mu);
      pthread_cond_signal(&w->cv);
      if (!ok) break;
    }
    // connection dead: poison first (nothing will ever read a reply off
    // this conn again — without this, a Request registered after the
    // sweep below would block for the full client timeout even though
    // the recv thread is gone), then fail all waiters
    sticky_err_.store(true);
    {
      std::lock_guard<Mu> lk(waiters_mu_);
      for (auto& [rid, w] : waiters_) {
        if (w->fused) continue;  // reported via the cq below
        pthread_mutex_lock(&w->mu);
        w->ok = false;
        w->done = true;
        pthread_mutex_unlock(&w->mu);
        pthread_cond_signal(&w->cv);
      }
      for (auto& [rid, w] : waiters_) {
        if (w->fused && cq_) cq_->push({w->ticket, -1, 0});
      }
      waiters_.clear();
    }
  }

  int fd_ = -1;
  std::unique_ptr<IpcChan> chan_;  // set before recv_thread_ spawns
  Buf junk_;  // RecvLoop-only drain scratch (reused, never per-message)
  CompletionQueue* cq_ = nullptr;  // Client-owned; set before Connect
  Mu send_mu_;
  std::thread recv_thread_;
  Mu waiters_mu_;
  std::unordered_map<uint32_t, std::shared_ptr<Waiter>> waiters_;
  // free list for the Waiter pool (see AcquireWaiter): recycled, never
  // freed while the conn lives — the TSAN-verified fix for the
  // destroyed-mutex address-reuse report
  std::vector<std::shared_ptr<Waiter>> waiter_pool_;
  // (rids come from the process-global g_next_rid: see its comment)
  // set by a rejected detached (async) push: the conn is poisoned —
  // every later Request fails fast instead of wedging on a round the
  // server will never complete
  std::atomic<bool> sticky_err_{false};
  // striped bytes (payload + framing) sent on this conn (SendSegments)
  std::atomic<uint64_t> tx_bytes_{0};
};

class Client {
 public:
  // Upper bound on servers per client. The connection-group table is a
  // FIXED array of owning pointers with an atomic count, so a runtime
  // AddServer (elastic scale-up) publishes a fully-built group with one
  // release store and the data-plane readers (pick(), the reactor
  // sweeps, ServerDead probes) never race a vector reallocation.
  static constexpr int kMaxServers = 256;

  bool Connect(const std::vector<std::pair<std::string, int>>& servers,
               int worker_id) {
    worker_id_ = (uint16_t)worker_id;
    // Stripe traffic over several TCP connections per server: one stream
    // serializes all partitions on one send mutex + one kernel TCP flow;
    // K streams spread the copy/checksum work over cores and keep the
    // pipe full while a peer stream waits on an ack (the reference gets
    // the same effect from ps-lite's multi-connection van). Per-key
    // ordering comes from key-affine conn picking (pick(server, key)):
    // a key's async push and its pull share one FIFO stream; unordered
    // ops (init/comp_init) block on their ACK and may round-robin.
    conns_per_server_ = 4;
    if (const char* e = ::getenv("BYTEPS_CLIENT_CONNS")) {
      conns_per_server_ = std::atoi(e);
      if (conns_per_server_ < 1) conns_per_server_ = 1;
      if (conns_per_server_ > 16) conns_per_server_ = 16;
    }
    if (int ws = wire_stripes()) {
      // BYTEPS_WIRE_STRIPES=N -> N data conns plus the conn-0 control
      // lane; N=1 pins the group to one data conn and PushPullStriped
      // never engages (the stripes-off A/B arm)
      conns_per_server_ = ws + 1;
      if (conns_per_server_ < 2) conns_per_server_ = 2;
      if (conns_per_server_ > 16) conns_per_server_ = 16;
    }
    if ((int)servers.size() > kMaxServers) return false;
    for (size_t i = 0; i < servers.size(); ++i) {
      auto g = BuildGroup(servers[i].first, servers[i].second);
      if (!g) return false;
      groups_[i] = std::move(g);
    }
    n_groups_.store((int)servers.size(), std::memory_order_release);
    return true;
  }

  // Runtime scale-up: connect a NEW server's striped conn group and
  // publish it at the next index. The group is fully constructed (all
  // conns up, recv loops running) BEFORE the count's release store, so
  // a concurrent reader either doesn't see the server yet or sees it
  // whole. Returns the new server index, or -1.
  int AddServer(const std::string& host, int port) {
    std::lock_guard<Mu> lk(grow_mu_);
    int n = n_groups_.load(std::memory_order_relaxed);
    if (n >= kMaxServers || conns_per_server_ <= 0) return -1;
    auto g = BuildGroup(host, port);
    if (!g) return -1;
    groups_[n] = std::move(g);
    n_groups_.store(n + 1, std::memory_order_release);
    return n;
  }

  void Close() {
    int n = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < n; ++i)
      for (auto& c : groups_[i]->conns)
        if (c) c->Close();
    cq_.close();
  }

  // fused PUSHPULL over the key-affine conn (same FIFO stream as the
  // two-op push->pull pair, so server-side ordering is unchanged).
  // `codec`: adaptive-plan wire tag, 0 = untagged (MsgHeader::codec).
  // Large TCP payloads stripe across the group's data conns instead
  // (PushPullStriped) — one partition no longer head-of-line-blocks
  // everything behind it on a single kernel flow.
  int PushPull(int server, uint64_t key, const void* data, uint32_t len,
               uint32_t cmd, void* out, uint32_t out_len,
               uint64_t ticket, uint64_t epoch, uint32_t codec = 0,
               uint32_t* rid_out = nullptr) {
    int rc = PushPullStriped(server, key, data, len, cmd, out, out_len,
                             ticket, epoch, codec, rid_out);
    if (rc != kNotStriped) return rc;
    return pick(server, key)->RequestFused(key, cmd, worker_id_, data,
                                           len, out, out_len, ticket,
                                           epoch, codec, rid_out)
               ? 0
               : -1;
  }

  // ---- observability control plane --------------------------------- //

  // Blocking control pull (STATS_PULL / TRACE_DRAIN / FLIGHT_DRAIN) on
  // conn 0 of the server's group, with its OWN bounded timeout so a
  // wedged server costs a poll seconds, not the data-plane budget.
  // Returns the reply length or -1.
  int Ctrl(int server, uint8_t op, void* out, uint32_t out_cap,
           long timeout_s) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return -1;
    uint32_t r = groups_[server]->conns[0]->Request(
        op, 0, 0, worker_id_, nullptr, 0, out, out_cap, 0, 0,
        timeout_s > 0 ? timeout_s : 5);
    return r == ~0u ? -1 : (int)r;
  }

  // Keyed control pull (HEALTH_PULL): like Ctrl but the request header
  // names a key, so the server can answer per-store questions inline.
  int CtrlKey(int server, uint8_t op, uint64_t key, void* out,
              uint32_t out_cap, long timeout_s) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return -1;
    uint32_t r = groups_[server]->conns[0]->Request(
        op, key, 0, worker_id_, nullptr, 0, out, out_cap, 0, 0,
        timeout_s > 0 ? timeout_s : 5);
    return r == ~0u ? -1 : (int)r;
  }

  // One NTP-style clock probe: out = {t0 client-send, t1 server-recv,
  // t2 server-send, t3 client-recv}, all steady-clock ns (t0/t3 on the
  // client's clock, t1/t2 on the server's). Returns 0 or -1.
  int ClockProbe(int server, uint64_t* out4, long timeout_s) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return -1;
    uint64_t echo[2] = {0, 0};
    out4[0] = now_ns();
    uint32_t r = groups_[server]->conns[0]->Request(
        CLOCK_PROBE, 0, 0, worker_id_, nullptr, 0, echo, sizeof(echo),
        0, 0, timeout_s > 0 ? timeout_s : 5);
    out4[3] = now_ns();
    if (r != sizeof(echo)) return -1;
    out4[1] = echo[0];
    out4[2] = echo[1];
    return 0;
  }

  // True when every striped connection to `server` is dead (transport
  // EOF or poisoned): the worker-side server-death verdict that drives
  // key migration. Out-of-range indices read as dead.
  int ServerDead(int server) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return 1;
    for (auto& c : groups_[server]->conns)
      if (c && !c->dead()) return 0;
    return 1;
  }

  // Reactor drain: blocks up to timeout_ms for completions, sweeping
  // expired fused requests between waits so a silent server can't
  // strand a ticket forever. Returns batch size, 0 on timeout, -1 once
  // the queue is closed and drained.
  int CqPoll(CompletionRec* out, int max_n, int timeout_ms) {
    static const long timeout_s = [] {
      const char* e = ::getenv("BYTEPS_CLIENT_TIMEOUT_S");
      return e && *e ? std::atol(e) : 600L;
    }();
    int remain = timeout_ms;
    for (;;) {
      int chunk = remain > 500 ? 500 : remain;
      int n = cq_.pop_batch(out, max_n, chunk > 0 ? chunk : 0);
      if (n != 0) return n;
      int ng = n_groups_.load(std::memory_order_acquire);
      for (int i = 0; i < ng; ++i)
        for (auto& c : groups_[i]->conns)
          if (c) c->SweepExpiredFused(timeout_s);
      remain -= chunk;
      if (remain <= 0) return 0;
    }
  }

  int CqDepth() { return cq_.depth(); }

  // Teardown half-step for the Python reactor: fail every outstanding
  // fused request into the queue, then close it — the reactor drains
  // the failures and exits on -1 BEFORE the native client is destroyed.
  void CqAbort() {
    int n = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < n; ++i)
      for (auto& c : groups_[i]->conns)
        if (c) c->AbortFused();
    cq_.close();
  }

  int InitKey(int server, uint64_t key, const void* data, uint32_t len,
              uint32_t cmd) {
    uint32_t r = pick(server)->Request(INIT_PUSH, key, cmd, worker_id_,
                                       data, len, nullptr, 0);
    return r == ~0u ? -1 : 0;
  }

  int CompInit(int server, uint64_t key, const char* kwargs) {
    uint32_t r = pick(server)->Request(COMP_INIT, key, 0, worker_id_,
                                       kwargs, (uint32_t)strlen(kwargs),
                                       nullptr, 0);
    return r == ~0u ? -1 : 0;
  }

  int Push(int server, uint64_t key, const void* data, uint32_t len,
           uint32_t cmd, uint64_t epoch, uint32_t codec = 0) {
    uint32_t r = pick(server, key)->Request(PUSH, key, cmd, worker_id_,
                                            data, len, nullptr, 0, epoch,
                                            codec);
    return r == ~0u ? -1 : 0;
  }

  // async push: returns once the bytes are on the wire; the ACK drains
  // in the background (an error ACK poisons the conn). The paired Pull
  // rides the same key-affine conn, so per-key push->pull FIFO holds
  // end-to-end (conn stream -> server per-key engine queue).
  int PushAsync(int server, uint64_t key, const void* data, uint32_t len,
                uint32_t cmd, uint64_t epoch, uint32_t codec = 0) {
    return pick(server, key)->RequestAsync(PUSH, key, cmd, worker_id_,
                                           data, len, epoch, codec)
               ? 0
               : -1;
  }

  int Pull(int server, uint64_t key, void* out, uint32_t out_len,
           uint32_t cmd) {
    uint32_t r = pick(server, key)->Request(PULL, key, cmd, worker_id_,
                                            nullptr, 0, out, out_len);
    return r == ~0u ? -1 : (int)r;
  }

  int Barrier() {
    // barrier rides connection 0 (the root server coordinates)
    uint32_t r = groups_[0]->conns[0]->Request(BARRIER, 0, 0, worker_id_,
                                               nullptr, 0, nullptr, 0);
    return r == ~0u ? -1 : 0;
  }

  int IpcConns() const {
    int n = 0;
    int ng = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < ng; ++i)
      for (auto& c : groups_[i]->conns)
        if (c && c->ipc_active()) n++;
    return n;
  }

  // Out-of-band descriptor traffic summed over every striped conn —
  // the client-side proof that the zero-copy shm tier engaged.
  void TransportStats(uint64_t* oob_sent, uint64_t* oob_recvd) const {
    uint64_t snt = 0, rcv = 0;
    int ng = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < ng; ++i)
      for (auto& c : groups_[i]->conns)
        if (c) {
          snt += c->oob_sent();
          rcv += c->oob_recvd();
        }
    *oob_sent = snt;
    *oob_recvd = rcv;
  }

  int TotalConns() const {
    int n = 0;
    int ng = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < ng; ++i) n += (int)groups_[i]->conns.size();
    return n;
  }

  // cumulative striped-send accounting (bench byte-conservation proof:
  // sum of per-conn tx_bytes == bytes + 72 * segs, exactly)
  void StripeStats(uint64_t* segs, uint64_t* bytes) const {
    *segs = stripe_segs_sent_.load(std::memory_order_relaxed);
    *bytes = stripe_bytes_sent_.load(std::memory_order_relaxed);
  }

  // per-conn striped byte counters for one server's group (slot 0 =
  // the control-lane conn, always 0)
  int StripeBytes(int server, uint64_t* out, int max_n) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return -1;
    ConnGroup& g = *groups_[server];
    int n = 0;
    for (auto& c : g.conns) {
      if (n >= max_n) break;
      out[n++] = c ? c->tx_bytes() : 0;
    }
    return n;
  }

  // fault-injection hook (tests): kill one conn of a server's group
  int KillStripe(int server, int idx) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return -1;
    ConnGroup& g = *groups_[server];
    if (idx < 0 || idx >= (int)g.conns.size() || !g.conns[idx])
      return -1;
    g.conns[idx]->KillForTest();
    return 0;
  }

  int Shutdown() {
    // exactly ONE shutdown per server per worker: the server counts
    // SHUTDOWN messages against num_workers, so the stripe conns must
    // not inflate the count (their sockets just close afterwards).
    // Runtime-joined servers are included — they were created with the
    // same worker count and exit on the same rendezvous.
    int rc = 0;
    int ng = n_groups_.load(std::memory_order_acquire);
    for (int i = 0; i < ng; ++i) {
      if (groups_[i]->conns[0]->Request(SHUTDOWN, 0, 0, worker_id_,
                                        nullptr, 0, nullptr, 0) == ~0u)
        rc = -1;
    }
    return rc;
  }

 private:
  struct ConnGroup {
    std::vector<std::unique_ptr<ServerConn>> conns;
    std::atomic<uint32_t> rr{0};
    // per-key striped-send ordinal: the server's (sender, key) seq
    // gate re-establishes this order across the group's conn loops
    Mu seq_mu;
    std::unordered_map<uint64_t, uint32_t> seqs;
  };

  // sentinel: the message was not eligible for striping — caller
  // routes it down the legacy single-conn path
  static constexpr int kNotStriped = -2;

  // Striped fused PUSHPULL (tentpole move 2): eligibility is decided
  // per message — a TCP group with >= 2 LIVE data conns (conn 0 stays
  // the control lane: STATS_PULL/CLOCK_PROBE/JOIN_PROBE/HEALTH_PULL
  // never queue behind a multi-MB partition) and a payload of at least
  // two stripe chunks. A dead stripe just drops out of the live set —
  // single-stripe death degrades width, never the request — and an
  // shm-upgraded conn never stripes (the arena tier already beats it).
  int PushPullStriped(int server, uint64_t key, const void* data,
                      uint32_t len, uint32_t cmd, void* out,
                      uint32_t out_len, uint64_t ticket, uint64_t epoch,
                      uint32_t codec, uint32_t* rid_out) {
    if (server < 0 ||
        server >= n_groups_.load(std::memory_order_acquire))
      return kNotStriped;
    ConnGroup& g = *groups_[server];
    int nd = (int)g.conns.size() - 1;
    uint32_t csz = stripe_chunk_bytes();
    if (nd < 2 || (uint64_t)len < 2ull * csz) return kNotStriped;
    std::vector<int> live;
    live.reserve((size_t)nd);
    for (int j = 1; j <= nd; ++j)
      if (!g.conns[j]->dead() && !g.conns[j]->ipc_active())
        live.push_back(j);
    if ((int)live.size() < 2) return kNotStriped;
    uint64_t nseg64 = ((uint64_t)len + csz - 1) / csz;
    if (nseg64 > kMaxSegs) {
      csz = (uint32_t)(((uint64_t)len + kMaxSegs - 1) / kMaxSegs);
      nseg64 = ((uint64_t)len + csz - 1) / csz;
    }
    uint32_t nseg = (uint32_t)nseg64;
    size_t hbase = (size_t)((key ^ (key >> 16)) % live.size());
    ServerConn* home = g.conns[live[hbase]].get();
    uint32_t rid = 0;
    if (!home->RegisterFused(ticket, out, out_len, &rid))
      return kNotStriped;  // home poisoned: legacy path picks another
    if (rid_out) *rid_out = rid;
    uint32_t seq;
    {
      std::lock_guard<Mu> lk(g.seq_mu);
      seq = g.seqs[key]++;
    }
    MsgHeader base{kMagic, PUSHPULL, 0, worker_id_, rid, key, cmd, 0,
                   epoch, codec};
    // segment s -> live[(hbase + s) % live]; segment 0 lands on the
    // home conn, where the reply waiter is registered
    std::vector<std::vector<ServerConn::SegPart>> parts(live.size());
    const uint8_t* p = (const uint8_t*)data;
    for (uint32_t s = 0; s < nseg; ++s) {
      uint64_t off = (uint64_t)s * csz;
      uint32_t clen = (uint32_t)(off + csz <= len ? csz : len - off);
      parts[(hbase + s) % live.size()].push_back({s, off, clen, p + off});
    }
    std::vector<ServerConn::SegPart> failed;
    for (size_t j = 0; j < live.size(); ++j) {
      if (j == hbase || parts[j].empty()) continue;
      if (!g.conns[live[j]]->SendSegments(base, seq, nseg, len,
                                          parts[j].data(),
                                          (int)parts[j].size()))
        failed.insert(failed.end(), parts[j].begin(), parts[j].end());
    }
    // home's own share — plus any segments whose stripe died mid-send
    // (failover: the message completes on the home conn; the server's
    // StripeReset dropped nothing we still need on the live conns)
    std::vector<ServerConn::SegPart> homeparts = std::move(parts[hbase]);
    homeparts.insert(homeparts.end(), failed.begin(), failed.end());
    if (!home->SendSegments(base, seq, nseg, len, homeparts.data(),
                            (int)homeparts.size())) {
      // home transport failed: reclaim the waiter unless the death
      // sweep already failed the ticket through the completion queue —
      // mirrors RequestFused's fail-exactly-once contract
      if (home->UnregisterFused(rid)) return -1;
      return 0;
    }
    stripe_segs_sent_.fetch_add(nseg, std::memory_order_relaxed);
    stripe_bytes_sent_.fetch_add(len, std::memory_order_relaxed);
    return 0;
  }

  // Build one server's fully-connected striped group (recv loops
  // running); nullptr on any connect failure.
  std::unique_ptr<ConnGroup> BuildGroup(const std::string& host,
                                        int port) {
    auto g = std::make_unique<ConnGroup>();
    for (int j = 0; j < conns_per_server_; ++j) {
      auto c = std::make_unique<ServerConn>();
      c->set_cq(&cq_);
      if (!c->Connect(host, port, worker_id_)) return nullptr;
      g->conns.push_back(std::move(c));
    }
    return g;
  }

  // round-robin pick: ops with no ordering requirement (init/comp_init
  // block on their ACK, so cross-conn reorder can't hurt them)
  ServerConn* pick(int server) {
    ConnGroup& g = *groups_[server];
    return g.conns[g.rr.fetch_add(1) % g.conns.size()].get();
  }

  // key-affine pick: a key's push and pull MUST share a conn so async
  // pushes stay FIFO with their pull. Mix the high half in — partition
  // keys are (declared << 16) | part, so bare key % k would pile every
  // single-partition tensor onto conn 0.
  ServerConn* pick(int server, uint64_t key) {
    ConnGroup& g = *groups_[server];
    return g.conns[(size_t)((key ^ (key >> 16)) % g.conns.size())].get();
  }

  uint16_t worker_id_ = 0;
  int conns_per_server_ = 4;
  // fixed slots [0, n_groups_): a group pointer is written BEFORE the
  // count's release store, so readers loading the count with acquire
  // see only fully-built groups and never race a container growth
  std::unique_ptr<ConnGroup> groups_[kMaxServers];
  std::atomic<int> n_groups_{0};
  Mu grow_mu_;  // serializes AddServer calls (readers stay lock-free)
  CompletionQueue cq_;  // fused-request completions, all conns
  // wire-plane ledger: byte conservation for the stripe_ab bench —
  // sum(per-conn tx_bytes) == stripe_bytes_sent + 72 * stripe_segs_sent
  std::atomic<uint64_t> stripe_segs_sent_{0};
  std::atomic<uint64_t> stripe_bytes_sent_{0};
};

}  // namespace bps

// ------------------------------------------------------------------ //
// C ABI (loaded from Python via ctypes)
// ------------------------------------------------------------------ //

extern "C" {

void* bps_server_create(int port, int num_workers, int engine_threads,
                        int async_mode, int enable_schedule) {
  return new bps::Server(port, num_workers, engine_threads, async_mode != 0,
                         enable_schedule != 0);
}

void* bps_server_create_dbg(int port, int num_workers, int engine_threads,
                            int async_mode, int enable_schedule,
                            int64_t debug_key) {
  return new bps::Server(port, num_workers, engine_threads, async_mode != 0,
                         enable_schedule != 0, debug_key);
}

int bps_server_run(void* s) { return ((bps::Server*)s)->Run(); }

// Per-stage server data-plane counters (docs/observability.md `server`
// section). Slot order is the append-only kStatSlotNames contract —
// machine-checked against the Python _STAT_SLOTS mirror by byteps-lint
// and readable at runtime via bps_server_stat_name(). Returns slots
// filled. The SAME vector answers the STATS_PULL wire op, so the
// in-process and remote surfaces cannot drift.
int bps_server_stats(void* s, uint64_t* out, int max_n) {
  return ((bps::Server*)s)->stat_slots(out, max_n);
}

// Runtime view of the slot-layout manifest: name of slot i (nullptr
// out of range) and the slot count — lets a test assert the LOADED .so
// agrees with the Python mirror it is parsed by.
const char* bps_server_stat_name(int i) {
  if (i < 0 || (size_t)i >= bps::kNumStatSlots) return nullptr;
  return bps::kStatSlotNames[i];
}

int bps_server_stat_count() { return (int)bps::kNumStatSlots; }

// In-process mirror of the HEALTH_PULL reply: out5 = {round,
// sumsq_bits, absmax_bits, nonfinite, elems} for `key`'s last
// published round (doubles as IEEE-754 bit patterns, like the wire
// record). Returns 0, or -1 when the key is unknown / health off —
// the loopback test surface for the in-fold statistics pass.
int bps_server_key_health(void* s, uint64_t key, uint64_t* out5) {
  return ((bps::Server*)s)->KeyHealth(key, out5) ? 0 : -1;
}

// In-process mirror of the STRIPE_PULL reply: per-conn / per-data-lane
// wire counters (time-series plane). `out` receives up to max_recs
// packed StripeRec records (8 u64 each, kStripeRecFields order);
// returns records filled. Same StripeSlots vector as the wire reply,
// so the two surfaces cannot drift.
int bps_server_stripe_stats(void* s, uint64_t* out, int max_recs) {
  return ((bps::Server*)s)->StripeSlots((bps::StripeRec*)out, max_recs);
}

// Runtime view of the stripe-record manifest (like
// bps_server_stat_name): field name of column i, and the field count.
const char* bps_server_stripe_field(int i) {
  if (i < 0 || (size_t)i >= bps::kNumStripeRecFields) return nullptr;
  return bps::kStripeRecFields[i];
}

int bps_server_stripe_field_count() {
  return (int)bps::kNumStripeRecFields;
}

// Cumulative queued payload bytes per engine thread — the balance
// proof for byte-weighted key placement. Returns engines filled.
int bps_server_engine_bytes(void* s, uint64_t* out, int max_n) {
  auto* srv = (bps::Server*)s;
  int n = srv->num_engines() < max_n ? srv->num_engines() : max_n;
  for (int i = 0; i < n; ++i) out[i] = srv->engine_fold_bytes(i);
  return n;
}

void bps_server_destroy(void* s) { delete (bps::Server*)s; }

void* bps_client_create(const char* servers_csv, int worker_id) {
  // servers_csv: "host:port,host:port,..."
  std::vector<std::pair<std::string, int>> servers;
  std::string csv(servers_csv);
  size_t pos = 0;
  while (pos < csv.size()) {
    size_t comma = csv.find(',', pos);
    if (comma == std::string::npos) comma = csv.size();
    std::string entry = csv.substr(pos, comma - pos);
    size_t colon = entry.rfind(':');
    if (colon == std::string::npos) return nullptr;
    servers.emplace_back(entry.substr(0, colon),
                         std::atoi(entry.c_str() + colon + 1));
    pos = comma + 1;
  }
  auto* c = new bps::Client();
  if (!c->Connect(servers, worker_id)) {
    delete c;
    return nullptr;
  }
  return c;
}

// Runtime scale-up (elastic fleet, docs/fault-tolerance.md): connect a
// NEW server's striped conn group and publish it at the next index.
// `host_port` = "host:port". Returns the new server index or -1. The
// caller (server/client.py PSClient.add_server) then runs the
// JOIN_PROBE handshake before the registry routes any key here.
int bps_client_add_server(void* c, const char* host_port) {
  std::string entry(host_port);
  size_t colon = entry.rfind(':');
  if (colon == std::string::npos) return -1;
  return ((bps::Client*)c)->AddServer(entry.substr(0, colon),
                                      std::atoi(entry.c_str() + colon + 1));
}

int bps_client_init_key(void* c, int server, uint64_t key, const void* data,
                        uint32_t len, uint32_t cmd) {
  return ((bps::Client*)c)->InitKey(server, key, data, len, cmd);
}

int bps_client_comp_init(void* c, int server, uint64_t key,
                         const char* kwargs) {
  return ((bps::Client*)c)->CompInit(server, key, kwargs);
}

// `epoch` = (round << 16) | attempt replay-dedup stamp (0 = unstamped;
// see MsgHeader::epoch). A retried push carrying the same round as an
// already-folded one is answered but never double-counted.
// `codec` = (plan_epoch << 8) | codec-id adaptive-plan wire tag (0 =
// untagged, no server-side validation; see MsgHeader::codec and
// docs/compression.md).
int bps_client_push(void* c, int server, uint64_t key, const void* data,
                    uint32_t len, uint32_t cmd, uint64_t epoch,
                    uint32_t codec) {
  return ((bps::Client*)c)->Push(server, key, data, len, cmd, epoch,
                                 codec);
}

int bps_client_push_async(void* c, int server, uint64_t key,
                          const void* data, uint32_t len, uint32_t cmd,
                          uint64_t epoch, uint32_t codec) {
  return ((bps::Client*)c)->PushAsync(server, key, data, len, cmd, epoch,
                                      codec);
}

int bps_client_pull(void* c, int server, uint64_t key, void* out,
                    uint32_t out_len, uint32_t cmd) {
  return ((bps::Client*)c)->Pull(server, key, out, out_len, cmd);
}

// Fused PUSHPULL: push `data` and receive the aggregated reply into
// `out` in ONE wire round trip. Returns 0 once the request is on the
// wire (-1 on send failure); completion surfaces as a CompletionRec
// carrying `ticket` via bps_client_cq_poll. `out` must stay alive (and
// unreleased) until the ticket's record is drained.
int bps_client_pushpull_async(void* c, int server, uint64_t key,
                              const void* data, uint32_t len, uint32_t cmd,
                              void* out, uint32_t out_len,
                              uint64_t ticket, uint64_t epoch,
                              uint32_t codec) {
  return ((bps::Client*)c)->PushPull(server, key, data, len, cmd, out,
                                     out_len, ticket, epoch, codec);
}

// Fused PUSHPULL with the wire rid reported back through `rid_out` —
// the flow-link id the fused timeline uses to tie this worker span to
// the server's trace spans. A NEW export rather than a new parameter
// on bps_client_pushpull_async: an older Python against this .so keeps
// its exact old signature, and a newer Python against an older .so
// falls back via hasattr (the usual version-skew discipline).
int bps_client_pushpull_async2(void* c, int server, uint64_t key,
                               const void* data, uint32_t len,
                               uint32_t cmd, void* out, uint32_t out_len,
                               uint64_t ticket, uint64_t epoch,
                               uint32_t codec, uint32_t* rid_out) {
  return ((bps::Client*)c)->PushPull(server, key, data, len, cmd, out,
                                     out_len, ticket, epoch, codec,
                                     rid_out);
}

// Blocking observability control pull against one server: `op` is
// STATS_PULL (12), TRACE_DRAIN (13) or FLIGHT_DRAIN (14); the reply
// payload lands in `out` and the call returns its length (-1 on
// failure). `timeout_s` bounds THIS request (<=0 -> 5s) independently
// of BYTEPS_CLIENT_TIMEOUT_S — a wedged server costs a poll seconds.
int bps_client_ctrl(void* c, int server, int op, void* out,
                    uint32_t out_cap, int timeout_s) {
  return ((bps::Client*)c)->Ctrl(server, (uint8_t)op, out, out_cap,
                                 timeout_s);
}

// Keyed control pull (HEALTH_PULL = 18): one packed HealthRec for
// `key`'s last published aggregation round. Returns the reply length
// (48) or -1 (unknown key / BYTEPS_HEALTH off on the server / stale
// peer). Same bounded-timeout discipline as bps_client_ctrl.
int bps_client_ctrl_key(void* c, int server, int op, uint64_t key,
                        void* out, uint32_t out_cap, int timeout_s) {
  return ((bps::Client*)c)->CtrlKey(server, (uint8_t)op, key, out,
                                    out_cap, timeout_s);
}

// One NTP-style clock probe against `server`: fills out4 with {t0
// client-send, t1 server-recv, t2 server-send, t3 client-recv} steady-
// clock ns. The Python side aggregates several probes and keeps the
// min-RTT one (utils/tracing.py estimate_clock_offset). Returns 0/-1.
int bps_client_clock_probe(void* c, int server, uint64_t* out4,
                           int timeout_s) {
  return ((bps::Client*)c)->ClockProbe(server, out4, timeout_s);
}

// 1 when every striped connection to `server` is dead (transport EOF /
// poisoned) — the worker-side server-death verdict consumed by the
// scheduler's failover path (re-route the dead server's keys).
int bps_client_server_dead(void* c, int server) {
  return ((bps::Client*)c)->ServerDead(server);
}

// Drain up to max_n fused completions into the three parallel arrays;
// blocks up to timeout_ms. Returns the batch size, 0 on timeout, -1
// once the queue is closed and drained (reactor exit).
int bps_client_cq_poll(void* c, uint64_t* tickets, int32_t* statuses,
                       uint32_t* lens, int max_n, int timeout_ms) {
  if (max_n <= 0) return 0;
  std::vector<bps::CompletionRec> recs(max_n);
  int n = ((bps::Client*)c)->CqPoll(recs.data(), max_n, timeout_ms);
  for (int i = 0; i < n; ++i) {
    tickets[i] = recs[i].ticket;
    statuses[i] = recs[i].status;
    lens[i] = recs[i].len;
  }
  return n;
}

int bps_client_cq_depth(void* c) { return ((bps::Client*)c)->CqDepth(); }

// Fail all outstanding fused requests and close the completion queue:
// the Python reactor drains the failures, sees -1, and exits — call
// BEFORE bps_client_destroy.
void bps_client_cq_abort(void* c) { ((bps::Client*)c)->CqAbort(); }

int bps_client_barrier(void* c) { return ((bps::Client*)c)->Barrier(); }

int bps_client_ipc_conns(void* c) { return ((bps::Client*)c)->IpcConns(); }

// Client transport counters: out[0]=ipc conns, out[1]=total conns,
// out[2]=oob descriptor messages sent, out[3]=oob received,
// out[4]=striped segments sent, out[5]=striped payload bytes sent.
// Returns how many slots were filled (layout is append-only).
int bps_client_transport_stats(void* c, uint64_t* out, int max_n) {
  auto* cl = (bps::Client*)c;
  uint64_t v[6] = {(uint64_t)cl->IpcConns(), (uint64_t)cl->TotalConns(),
                   0, 0, 0, 0};
  cl->TransportStats(&v[2], &v[3]);
  cl->StripeStats(&v[4], &v[5]);
  int n = max_n < 6 ? max_n : 6;
  for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

// Per-conn cumulative TX bytes (payload + stripe framing) for one
// server's conn group; slot 0 is the control lane. Returns slots
// filled, or -1 for a bad server index. Bench-side byte-conservation
// proof: sum over data slots == transport_stats[5] + 72*[4].
int bps_client_stripe_bytes(void* c, int server, uint64_t* out,
                            int max_n) {
  return ((bps::Client*)c)->StripeBytes(server, out, max_n);
}

// Test hook: hard-kill one conn of a server's group (shutdown(2) the
// socket) to exercise single-stripe death failover.
int bps_client_kill_stripe(void* c, int server, int idx) {
  return ((bps::Client*)c)->KillStripe(server, idx);
}

int bps_client_total_conns(void* c) {
  return ((bps::Client*)c)->TotalConns();
}

int bps_client_shutdown(void* c) { return ((bps::Client*)c)->Shutdown(); }

void bps_client_destroy(void* c) {
  ((bps::Client*)c)->Close();
  delete (bps::Client*)c;
}

// ---------------------------------------------------------------- //
// standalone codec API: the SAME CompressorCfg the server mirrors,
// exposed to the worker host tier (ops/compression/native.py) so the
// worker-side pack/unpack runs the vectorized C++ instead of numpy
// (reference: the worker's OpenMP C++ compressors, onebit.cc:34-66)
// ---------------------------------------------------------------- //

void* bps_codec_create(const char* kwargs) {
  auto* c = new bps::CompressorCfg();
  if (!bps::CompressorCfg::Parse(kwargs, c)) {
    delete c;
    return nullptr;
  }
  return c;
}

// allocation bound for a wire payload (== actual length for fixed formats)
uint32_t bps_codec_wire_bound(void* h) {
  return ((bps::CompressorCfg*)h)->WireLen();
}

// dense f32[n] -> wire payload in `out` (capacity >= wire_bound);
// returns the actual payload length, or -1 on error
int64_t bps_codec_compress(void* h, const float* in, uint8_t* out,
                           uint64_t step) {
  auto* c = (bps::CompressorCfg*)h;
  std::vector<int32_t> idx;
  if (c->type == bps::CompressorCfg::RANDOMK) c->RandomkIndices(step, &idx);
  return (int64_t)c->Compress(in, out, step, idx);
}

// wire payload -> dense f32[n] in `out`; returns 0 ok, -1 on bad wire
int bps_codec_decompress(void* h, const uint8_t* in, uint32_t len,
                         float* out) {
  return ((bps::CompressorCfg*)h)->Decompress(in, len, out, nullptr)
             ? 0
             : -1;
}

void bps_codec_destroy(void* h) { delete (bps::CompressorCfg*)h; }

// ---------------------------------------------------------------- //
// SIMD fold probe: the parity-test surface for the dispatched
// accumulate kernels (tests/test_native_plane.py asserts every
// available tier is BITWISE identical to the scalar loop).
// ---------------------------------------------------------------- //

// Best tier this host+build supports: 0 scalar, 2 AVX2, 3 AVX-512.
int bps_simd_best() { return bps::simd_best_supported(); }

// dst += src over nbytes of `dtype` (DataType wire code) using the
// requested tier (-1 = auto). Returns the tier actually used, or -1
// when the request names a tier this host/build cannot run (the
// parity suite skips, never silently tests the wrong kernel).
int bps_fold_probe(int dtype, void* dst, const void* src,
                   uint64_t nbytes, int tier) {
  int best = bps::simd_best_supported();
  if (tier > best) return -1;
  const char* want = nullptr;
  if (tier == bps::kSimdScalar) want = "scalar";
  else if (tier == bps::kSimdAvx2) want = "avx2";
  else if (tier == bps::kSimdAvx512) want = "avx512";
  bps::FoldKernels k = bps::resolve_fold_kernels(want);
  if (tier >= 0 && k.tier != tier) return -1;
  bps::sum_into(dst, src, (size_t)nbytes, (uint32_t)dtype, k);
  return k.tier;
}

}  // extern "C"
