// Shared machinery of the native scheduling cores (the raylet-split's
// C++ halves): cpp/agent_core.cc owns the AGENT's select round,
// cpp/head_core.cc owns the HEAD's — both are built from the pieces
// here so the wire contract lives in exactly one place:
//
//   * the FRAME PUMP (`FramePump`) — epoll readiness, MSG_DONTWAIT
//     reads into per-connection buffers, outer-frame splitting (the
//     <Q len><I nbufs>[<Q blen>...] framing of core/transport.py,
//     proto-flag frames included), accept-socket readiness surfacing,
//     and the pickle-prefix op sniffer;
//   * the RESTRICTED UNPICKLER (`PickleWalk`) — walks the C-pickler
//     output of the few hot frame shapes and BAILS on any opcode
//     outside its contract, so an unexpected payload is a slow frame,
//     never a wrong one;
//   * the NATIVE PICKLE WRITERS — hand-rolled protocol-5 builds of the
//     fixed hot-frame shapes (exec_raw / reg_fn / node_done_raw /
//     node_exec_raw) into complete outer frames.
//
// Wire-contract note (tools/staticcheck wire-drift): the AgentFrame
// oneof tags used by the proto sniffer (kAgentFrameTags) are pinned
// BOTH WAYS against ray_tpu_torch/protocol/raytpu.proto — a renumber or
// rename on either side is a tier-1 failure, not a silent misroute.
//
// Everything is `static`/header-local: each core compiles into its own
// .so through the content-hash g++ cache (ray_tpu_torch/_native/build.py
// hashes this header alongside the .cc, so edits here rebuild both).

#ifndef RAY_TPU_TORCH_FRAME_CORE_H_
#define RAY_TPU_TORCH_FRAME_CORE_H_

#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <deque>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace framecore {

// ---- outer framing (must match core/transport.py) ----
static const uint32_t PROTO_FLAG = 0x80000000u;

// AgentFrame oneof field tags (ray_tpu_torch/protocol/raytpu.proto). The pump
// labels proto-framed control messages by their outermost tag so Python
// can route without a trial decode; staticcheck pins these both ways
// against the .proto. Wire type is always 2 (length-delimited
// submessage).
struct AgentFrameTag { int field; const char* name; };
static const AgentFrameTag kAgentFrameTags[] = {
    {1, "register_node"}, {2, "heartbeat"}, {3, "node_ack"},
    {4, "worker_death"}, {5, "spawn_worker"}, {6, "kill_worker"},
    {7, "fetch"}, {8, "fetched"}, {9, "free_object"}, {10, "seq_skip"},
    {11, "cluster_view"}, {12, "lease_spilled"}, {13, "task_events"},
    {14, "metrics_update"},
};

static inline int agent_frame_tag_count() {
  return (int)(sizeof(kAgentFrameTags) / sizeof(kAgentFrameTags[0]));
}

static inline int agent_frame_tag_entry(int i, int* field,
                                        const char** name) {
  if (i < 0 || i >= agent_frame_tag_count()) return -1;
  *field = kAgentFrameTags[i].field;
  *name = kAgentFrameTags[i].name;
  return 0;
}

// ---- pickle opcodes (protocol 5, CPython C pickler output) ----
enum : uint8_t {
  OP_PROTO = 0x80, OP_FRAME = 0x95, OP_STOP = '.',
  OP_NONE = 'N', OP_NEWTRUE = 0x88, OP_NEWFALSE = 0x89,
  OP_BININT = 'J', OP_BININT1 = 'K', OP_BININT2 = 'M', OP_LONG1 = 0x8a,
  OP_BINFLOAT = 'G',
  OP_SHORT_BINBYTES = 'C', OP_BINBYTES = 'B', OP_BINBYTES8 = 0x8e,
  OP_SHORT_BINUNICODE = 0x8c, OP_BINUNICODE = 'X', OP_BINUNICODE8 = 0x8d,
  OP_EMPTY_LIST = ']', OP_EMPTY_TUPLE = ')', OP_MARK = '(',
  OP_TUPLE1 = 0x85, OP_TUPLE2 = 0x86, OP_TUPLE3 = 0x87, OP_TUPLE = 't',
  OP_APPEND = 'a', OP_APPENDS = 'e',
  OP_MEMOIZE = 0x94, OP_BINGET = 'h', OP_LONG_BINGET = 'j',
  OP_NEXT_BUFFER = 0x97, OP_READONLY_BUFFER = 0x98,
};

struct PVal {
  enum Kind { NONE, BOOL, INT, FLOAT, BYTES, STR, LIST, TUPLE,
              OPAQUE } kind;
  int64_t i = 0;
  double f = 0.0;              // FLOAT (BINFLOAT payloads)
  const uint8_t* p = nullptr;  // BYTES/STR view into the frame buffer
  uint64_t len = 0;
  std::vector<int> items;      // LIST/TUPLE arena ids
};

// Restricted pickle walker: builds an arena of PVals (stack holds arena
// ids so memo aliasing — a BINGET of a list later APPENDS-mutated —
// stays correct). Returns the arena id of the root value, or -1 to bail.
struct PickleWalk {
  std::deque<PVal> arena;
  std::vector<int> stack;
  std::vector<int> marks;
  std::vector<int> memo;

  int push(PVal&& v) {
    arena.emplace_back(std::move(v));
    stack.push_back((int)arena.size() - 1);
    return stack.back();
  }

  int parse(const uint8_t* d, uint64_t n) {
    uint64_t i = 0;
    while (i < n) {
      uint8_t op = d[i++];
      switch (op) {
        case OP_PROTO: if (i + 1 > n) return -1; i += 1; break;
        case OP_FRAME: if (i + 8 > n) return -1; i += 8; break;
        case OP_NONE: push({PVal::NONE}); break;
        case OP_NEWTRUE: { PVal v{PVal::BOOL}; v.i = 1; push(std::move(v)); break; }
        case OP_NEWFALSE: { PVal v{PVal::BOOL}; v.i = 0; push(std::move(v)); break; }
        case OP_BININT: {
          if (i + 4 > n) return -1;
          int32_t x; memcpy(&x, d + i, 4); i += 4;
          PVal v{PVal::INT}; v.i = x; push(std::move(v)); break;
        }
        case OP_BININT1: {
          if (i + 1 > n) return -1;
          PVal v{PVal::INT}; v.i = d[i]; i += 1; push(std::move(v)); break;
        }
        case OP_BININT2: {
          if (i + 2 > n) return -1;
          uint16_t x; memcpy(&x, d + i, 2); i += 2;
          PVal v{PVal::INT}; v.i = x; push(std::move(v)); break;
        }
        case OP_LONG1: {
          if (i + 1 > n) return -1;
          uint8_t k = d[i]; i += 1;
          if (i + k > n || k > 8) return -1;
          int64_t x = 0;
          for (int b = 0; b < k; b++) x |= (int64_t)d[i + b] << (8 * b);
          if (k && (d[i + k - 1] & 0x80))  // sign-extend
            for (int b = k; b < 8; b++) x |= (int64_t)0xff << (8 * b);
          i += k;
          PVal v{PVal::INT}; v.i = x; push(std::move(v)); break;
        }
        case OP_BINFLOAT: {
          if (i + 8 > n) return -1;
          // big-endian IEEE double (pickle spec)
          uint64_t u = 0;
          for (int b = 0; b < 8; b++) u = (u << 8) | d[i + b];
          i += 8;
          PVal v{PVal::FLOAT};
          memcpy(&v.f, &u, 8);
          push(std::move(v)); break;
        }
        case OP_SHORT_BINBYTES: case OP_SHORT_BINUNICODE: {
          if (i + 1 > n) return -1;
          uint64_t k = d[i]; i += 1;
          if (i + k > n) return -1;
          PVal v{op == OP_SHORT_BINBYTES ? PVal::BYTES : PVal::STR};
          v.p = d + i; v.len = k; i += k; push(std::move(v)); break;
        }
        case OP_BINBYTES: case OP_BINUNICODE: {
          if (i + 4 > n) return -1;
          uint32_t k; memcpy(&k, d + i, 4); i += 4;
          if (i + k > n) return -1;
          PVal v{op == OP_BINBYTES ? PVal::BYTES : PVal::STR};
          v.p = d + i; v.len = k; i += k; push(std::move(v)); break;
        }
        case OP_BINBYTES8: case OP_BINUNICODE8: {
          if (i + 8 > n) return -1;
          uint64_t k; memcpy(&k, d + i, 8); i += 8;
          if (k > n || i + k > n) return -1;
          PVal v{op == OP_BINBYTES8 ? PVal::BYTES : PVal::STR};
          v.p = d + i; v.len = k; i += k; push(std::move(v)); break;
        }
        case OP_EMPTY_LIST: push({PVal::LIST}); break;
        case OP_EMPTY_TUPLE: push({PVal::TUPLE}); break;
        case OP_MARK: marks.push_back((int)stack.size()); break;
        case OP_APPEND: {
          if (stack.size() < 2) return -1;
          int it = stack.back(); stack.pop_back();
          PVal& l = arena[stack.back()];
          if (l.kind != PVal::LIST) return -1;
          l.items.push_back(it); break;
        }
        case OP_APPENDS: {
          if (marks.empty()) return -1;
          int m = marks.back(); marks.pop_back();
          if ((int)stack.size() < m || m < 1) return -1;
          PVal& l = arena[stack[m - 1]];
          if (l.kind != PVal::LIST) return -1;
          for (int j = m; j < (int)stack.size(); j++) l.items.push_back(stack[j]);
          stack.resize(m); break;
        }
        case OP_TUPLE1: case OP_TUPLE2: case OP_TUPLE3: {
          int k = op - OP_TUPLE1 + 1;
          if ((int)stack.size() < k) return -1;
          PVal v{PVal::TUPLE};
          v.items.assign(stack.end() - k, stack.end());
          stack.resize(stack.size() - k);
          push(std::move(v)); break;
        }
        case OP_TUPLE: {
          if (marks.empty()) return -1;
          int m = marks.back(); marks.pop_back();
          if ((int)stack.size() < m) return -1;
          PVal v{PVal::TUPLE};
          v.items.assign(stack.begin() + m, stack.end());
          stack.resize(m);
          push(std::move(v)); break;
        }
        case OP_MEMOIZE:
          if (stack.empty()) return -1;
          memo.push_back(stack.back()); break;
        case OP_BINGET: {
          if (i + 1 > n) return -1;
          uint8_t k = d[i]; i += 1;
          if (k >= memo.size()) return -1;
          stack.push_back(memo[k]); break;
        }
        case OP_LONG_BINGET: {
          if (i + 4 > n) return -1;
          uint32_t k; memcpy(&k, d + i, 4); i += 4;
          if (k >= memo.size()) return -1;
          stack.push_back(memo[k]); break;
        }
        case OP_NEXT_BUFFER: push({PVal::OPAQUE}); break;
        case OP_READONLY_BUFFER: break;  // wraps top in place
        case OP_STOP:
          if (stack.size() != 1) return -1;
          return stack.back();
        default:
          return -1;  // outside the contract: Python owns this frame
      }
    }
    return -1;
  }
};

// Cheap op sniff: the first string literal pushed in a C-pickled tuple
// ("op", ...) is the op. Returns length of op copied into out (0 = unknown).
static int sniff_op(const uint8_t* d, uint64_t n, char* out, int cap) {
  uint64_t i = 0;
  if (i + 2 <= n && d[i] == OP_PROTO) i += 2;
  if (i + 9 <= n && d[i] == OP_FRAME) i += 9;
  while (i < n && d[i] == OP_MARK) i += 1;  // 4+-tuples open with MARK
  if (i >= n) return 0;
  uint64_t k = 0;
  if (d[i] == OP_SHORT_BINUNICODE) {
    if (i + 2 > n) return 0;
    k = d[i + 1]; i += 2;
  } else if (d[i] == OP_BINUNICODE) {
    if (i + 5 > n) return 0;
    uint32_t kk; memcpy(&kk, d + i + 1, 4); k = kk; i += 5;
  } else {
    return 0;
  }
  if (k == 0 || k >= (uint64_t)cap || i + k > n) return 0;
  memcpy(out, d + i, k);
  out[k] = 0;
  return (int)k;
}

// ---- native pickle writers for the fixed hot-frame shapes ----

static void put_u64(std::string& o, uint64_t v) { o.append((const char*)&v, 8); }
static void put_u32(std::string& o, uint32_t v) { o.append((const char*)&v, 4); }

static void pk_bytes(std::string& o, const uint8_t* p, uint64_t n) {
  if (n < 256) {
    o.push_back((char)OP_SHORT_BINBYTES);
    o.push_back((char)n);
  } else if (n <= 0xffffffffu) {
    o.push_back((char)OP_BINBYTES);
    put_u32(o, (uint32_t)n);
  } else {
    o.push_back((char)OP_BINBYTES8);
    put_u64(o, n);
  }
  o.append((const char*)p, n);
}

static void pk_str(std::string& o, const char* s) {
  size_t n = strlen(s);
  o.push_back((char)OP_SHORT_BINUNICODE);
  o.push_back((char)n);
  o.append(s, n);
}

static void pk_strn(std::string& o, const uint8_t* p, uint64_t n) {
  if (n < 256) {
    o.push_back((char)OP_SHORT_BINUNICODE);
    o.push_back((char)n);
  } else {
    o.push_back((char)OP_BINUNICODE);
    put_u32(o, (uint32_t)n);
  }
  o.append((const char*)p, n);
}

static void pk_none(std::string& o) { o.push_back((char)OP_NONE); }

static void pk_int(std::string& o, int64_t v) {
  if (v >= 0 && v < 256) {
    o.push_back((char)OP_BININT1);
    o.push_back((char)v);
  } else if (v >= 0 && v < 65536) {
    o.push_back((char)OP_BININT2);
    o.push_back((char)(v & 0xff));
    o.push_back((char)(v >> 8));
  } else if (v >= INT32_MIN && v <= INT32_MAX) {
    o.push_back((char)OP_BININT);
    int32_t x = (int32_t)v;
    o.append((const char*)&x, 4);
  } else {
    o.push_back((char)OP_LONG1);
    o.push_back((char)8);
    o.append((const char*)&v, 8);
  }
}

static void pk_proto(std::string& o) {
  o.push_back((char)OP_PROTO);
  o.push_back((char)5);
}

// One complete outer frame carrying pickled `payload` (no oob buffers).
static void frame_wrap(std::string& out, const std::string& payload) {
  put_u64(out, payload.size());
  put_u32(out, 0);
  out += payload;
}

// ("exec_raw", <spec bytes>) as a complete outer frame.
static void build_exec_raw(std::string& out, const std::string& spec) {
  std::string p;
  pk_proto(p);
  pk_str(p, "exec_raw");
  pk_bytes(p, (const uint8_t*)spec.data(), spec.size());
  p.push_back((char)OP_TUPLE2);
  p.push_back((char)OP_STOP);
  frame_wrap(out, p);
}

// ("reg_fn", <fn bytes>, <blob bytes>) as a complete outer frame.
static void build_reg_fn(std::string& out, const std::string& fn,
                         const std::string& blob) {
  std::string p;
  pk_proto(p);
  pk_str(p, "reg_fn");
  pk_bytes(p, (const uint8_t*)fn.data(), fn.size());
  pk_bytes(p, (const uint8_t*)blob.data(), blob.size());
  p.push_back((char)OP_TUPLE3);
  p.push_back((char)OP_STOP);
  frame_wrap(out, p);
}

// ("node_done_raw", <worker hex str>, [<raw frame bytes>, ...]).
static void build_node_done_raw(std::string& out, const std::string& whex,
                                const std::vector<std::string>& raws) {
  std::string p;
  pk_proto(p);
  pk_str(p, "node_done_raw");
  pk_str(p, whex.c_str());
  p.push_back((char)OP_EMPTY_LIST);
  p.push_back((char)OP_MARK);
  for (const auto& r : raws)
    pk_bytes(p, (const uint8_t*)r.data(), r.size());
  p.push_back((char)OP_APPENDS);
  p.push_back((char)OP_TUPLE3);
  p.push_back((char)OP_STOP);
  frame_wrap(out, p);
}

// ---- the frame pump ----

// Connection modes: PICKLE conns are outer-frame split, RAW conns hand
// their chunks to Python unsplit (the cpp-worker protobuf plane), ACCEPT
// conns are listening sockets — readiness surfaces as a KIND_ACCEPT
// record and Python runs accept() (the fd is never recv()'d here).
enum ConnMode { CONN_PICKLE = 0, CONN_RAW = 1, CONN_ACCEPT = 2 };

struct Conn {
  int fd = -1;
  uint64_t tag = 0;
  int mode = CONN_PICKLE;
  bool eof = false;
  bool accept_ready = false;  // ACCEPT conns: readiness latched this round
  std::string buf;            // unconsumed inbound bytes
  size_t scan = 0;            // split cursor into buf
};

// Frame kinds surfaced to Python (mirrored in the ctypes bindings).
enum FrameKind { KIND_PICKLE = 0, KIND_PROTO = 1, KIND_RAW = 2,
                 KIND_EOF = 3, KIND_ACCEPT = 4 };

struct Frame {
  uint64_t tag;
  int kind;               // FrameKind
  int proto_tag = 0;      // KIND_PROTO: AgentFrame oneof field tag (0 unknown)
  const uint8_t* whole = nullptr;  // full frame incl. outer header
  uint64_t whole_len = 0;
  const uint8_t* payload = nullptr;
  uint64_t payload_len = 0;
  std::vector<std::pair<const uint8_t*, uint64_t>> bufs;
  char op[24] = {0};      // sniffed op ("" = not sniffable)
  bool consumed = false;
};

// The epoll pump + splitter. NOT internally synchronized: the owning
// core's mutex guards every method except poll()'s epoll_wait (which
// runs unlocked on the single pump thread; only the buffer drain takes
// the lock — both cores keep that discipline).
struct FramePump {
  int ep = -1;
  std::unordered_map<int, Conn> conns;          // fd -> conn
  std::vector<epoll_event> events;
  std::vector<Frame> frames;
  // Buffers of conns del_fd'ed mid-round: frame views may still point
  // into them, so ownership parks here until round_end() (a del_fd from
  // a death path running inside the round must never dangle a view).
  std::vector<std::string> dead_bufs;

  void init() { ep = epoll_create1(EPOLL_CLOEXEC); }
  void close_ep() {
    if (ep >= 0) close(ep);
    ep = -1;
  }

  int add_fd(int fd, uint64_t tag, int mode) {
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = fd;
    if (epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ev) != 0) return -1;
    Conn& cn = conns[fd];
    cn.fd = fd;
    cn.tag = tag;
    cn.mode = mode;
    cn.eof = false;
    cn.accept_ready = false;
    cn.buf.clear();
    cn.scan = 0;
    return 0;
  }

  int del_fd(int fd) {
    epoll_ctl(ep, EPOLL_CTL_DEL, fd, nullptr);
    auto it = conns.find(fd);
    if (it != conns.end()) {
      if (!it->second.buf.empty())
        dead_bufs.emplace_back(std::move(it->second.buf));
      conns.erase(it);
    }
    return 0;
  }

  // epoll_wait half of poll(): runs WITHOUT the core lock.
  int wait(int timeout_ms) {
    events.resize(64);
    return epoll_wait(ep, events.data(), (int)events.size(), timeout_ms);
  }

  // Drain half of poll(): caller holds the core lock. Returns the number
  // of conns with new data / EOF / pending accepts.
  int drain(int nev) {
    int active = 0;
    char tmp[1 << 18];
    for (int i = 0; i < nev; i++) {
      int fd = events[i].data.fd;
      auto it = conns.find(fd);
      if (it == conns.end()) continue;
      Conn& cn = it->second;
      if (cn.mode == CONN_ACCEPT) {
        cn.accept_ready = true;
        active++;
        continue;
      }
      bool got = false;
      for (;;) {
        ssize_t r = recv(fd, tmp, sizeof(tmp), MSG_DONTWAIT);
        if (r > 0) {
          cn.buf.append(tmp, (size_t)r);
          got = true;
          if ((size_t)r < sizeof(tmp)) break;
          continue;
        }
        if (r == 0) {
          cn.eof = true;
          got = true;
          break;
        }
        if (errno == EINTR) continue;
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        cn.eof = true;  // hard error: surface as EOF, Python runs death path
        got = true;
        break;
      }
      if (got) active++;
    }
    return active;
  }

  // Split buffered bytes into frames (per conn, in order). Raw-mode conns
  // yield one KIND_RAW chunk per round; accept-ready conns one
  // KIND_ACCEPT record; EOF yields a trailing KIND_EOF record.
  // Frame views stay valid until round_end().
  int split() {
    frames.clear();
    for (auto& kv : conns) {
      Conn& cn = kv.second;
      if (cn.mode == CONN_ACCEPT) {
        if (cn.accept_ready) {
          cn.accept_ready = false;
          Frame f;
          f.tag = cn.tag;
          f.kind = KIND_ACCEPT;
          frames.push_back(std::move(f));
        }
        continue;
      }
      if (cn.mode == CONN_RAW) {
        if (cn.scan < cn.buf.size()) {
          Frame f;
          f.tag = cn.tag;
          f.kind = KIND_RAW;
          f.payload = (const uint8_t*)cn.buf.data() + cn.scan;
          f.payload_len = cn.buf.size() - cn.scan;
          cn.scan = cn.buf.size();
          frames.push_back(std::move(f));
        }
      } else {
        const uint8_t* d = (const uint8_t*)cn.buf.data();
        size_t n = cn.buf.size();
        while (cn.scan + 12 <= n) {
          uint64_t plen;
          uint32_t nbufs;
          memcpy(&plen, d + cn.scan, 8);
          memcpy(&nbufs, d + cn.scan + 8, 4);
          Frame f;
          f.tag = cn.tag;
          if (nbufs & PROTO_FLAG) {
            uint64_t total = 12 + plen;
            if (cn.scan + total > n) break;
            f.kind = KIND_PROTO;
            f.whole = d + cn.scan;
            f.whole_len = total;
            f.payload = d + cn.scan + 12;
            f.payload_len = plen;
            // outermost submessage tag of the AgentFrame (varint key)
            if (plen >= 1) {
              uint8_t key = f.payload[0];
              if ((key & 7) == 2) f.proto_tag = key >> 3;
            }
            cn.scan += total;
          } else {
            if (nbufs > 4096) { cn.eof = true; break; }  // corrupt header
            uint64_t lens_end = 12 + 8ull * nbufs;
            if (cn.scan + lens_end > n) break;
            uint64_t total = lens_end + plen;
            std::vector<uint64_t> blens(nbufs);
            for (uint32_t b = 0; b < nbufs; b++) {
              memcpy(&blens[b], d + cn.scan + 12 + 8ull * b, 8);
              total += blens[b];
            }
            if (cn.scan + total > n) break;
            f.kind = KIND_PICKLE;
            f.whole = d + cn.scan;
            f.whole_len = total;
            f.payload = d + cn.scan + lens_end;
            f.payload_len = plen;
            uint64_t off = cn.scan + lens_end + plen;
            for (uint32_t b = 0; b < nbufs; b++) {
              f.bufs.emplace_back(d + off, blens[b]);
              off += blens[b];
            }
            sniff_op(f.payload, f.payload_len, f.op, sizeof(f.op));
            cn.scan += total;
          }
          frames.push_back(std::move(f));
        }
      }
      if (cn.eof && cn.scan >= cn.buf.size()) {
        Frame f;
        f.tag = cn.tag;
        f.kind = KIND_EOF;
        frames.push_back(std::move(f));
      }
    }
    return (int)frames.size();
  }

  // End of round: drop consumed bytes from conn buffers and clear the
  // frame list (all frame views become invalid).
  void round_end() {
    frames.clear();
    dead_bufs.clear();
    for (auto& kv : conns) {
      Conn& cn = kv.second;
      if (cn.scan > 0) {
        cn.buf.erase(0, cn.scan);
        cn.scan = 0;
      }
    }
  }

  int frame_info(int i, uint64_t* tag, int* kind, int* proto_tag,
                 const uint8_t** payload, uint64_t* plen,
                 const uint8_t** whole, uint64_t* wlen, int* nbufs,
                 int* consumed) {
    if (i < 0 || i >= (int)frames.size()) return -1;
    Frame& f = frames[i];
    *tag = f.tag;
    *kind = f.kind;
    *proto_tag = f.proto_tag;
    *payload = f.payload;
    *plen = f.payload_len;
    *whole = f.whole;
    *wlen = f.whole_len;
    *nbufs = (int)f.bufs.size();
    *consumed = f.consumed ? 1 : 0;
    return 0;
  }

  int frame_buf(int i, int j, const uint8_t** p, uint64_t* n) {
    if (i < 0 || i >= (int)frames.size()) return -1;
    Frame& f = frames[i];
    if (j < 0 || j >= (int)f.bufs.size()) return -1;
    *p = f.bufs[j].first;
    *n = f.bufs[j].second;
    return 0;
  }
};

struct Lock {
  pthread_mutex_t* m;
  explicit Lock(pthread_mutex_t* mm) : m(mm) { pthread_mutex_lock(m); }
  ~Lock() { pthread_mutex_unlock(m); }
};

}  // namespace framecore

#endif  // RAY_TPU_TORCH_FRAME_CORE_H_
