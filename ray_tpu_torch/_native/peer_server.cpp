// Native object-transfer peer server: serves cross-node object pulls
// straight out of the node's shm arena, no Python (or GIL) on the send path.
//
// Parity: reference `src/ray/object_manager/` — the PushManager side of the
// chunked object transfer protocol (push_manager.h:32, object_manager.h:119).
// Design departure: requests are pull-driven whole objects over persistent
// TCP connections; the server reads sealed objects zero-copy from the same
// mmap'd arena the store clients use (store_get/store_release from
// object_store.cpp, compiled into this .so).
//
// Wire protocol (little endian):
//   request:  16-byte object id
//   response: u8 ok; if ok: u64 data_size, u64 meta_size, meta bytes,
//             data bytes
//   range request (multi-stream pulls): 16-byte RANGE_MAGIC, 16-byte
//   object id, u64 offset, u64 length; response carries the TOTAL
//   data_size/meta_size + meta, then only the requested byte slice.
// Connections are persistent (many requests) and closed on peer EOF.
//
// Threading: one accept thread + one detached thread per connection —
// node counts are small and blocking IO in native threads costs no GIL.

#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <arpa/inet.h>

#include <atomic>
#include <mutex>
#include <set>

extern "C" {

// from object_store.cpp (same .so)
int store_get(void* base, const uint8_t* id, uint64_t* out_offset,
              uint64_t* out_data_size, uint64_t* out_meta_size);
int store_release(void* base, const uint8_t* id);

struct PeerState {
  void* store_base;
  int listen_fd;
  std::atomic<int> active{0};
  std::atomic<bool> stopping{false};
  std::mutex conn_mu;
  std::set<int> conn_fds;
};

struct ConnCtx {
  PeerState* st;
  int fd;
};

static int read_exact(int fd, void* buf, size_t n) {
  char* p = (char*)buf;
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r < 0 && errno == EINTR) continue;  // CPython signals lack SA_RESTART
    if (r <= 0) return -1;
    p += r;
    n -= (size_t)r;
  }
  return 0;
}

static int write_all(int fd, const void* buf, size_t n) {
  const char* p = (const char*)buf;
  while (n) {
    ssize_t w = write(fd, p, n);
    if (w < 0 && errno == EINTR) continue;
    if (w <= 0) return -1;
    p += w;
    n -= (size_t)w;
  }
  return 0;
}

static void* conn_main(void* arg) {
  ConnCtx* ctx = (ConnCtx*)arg;
  PeerState* st = ctx->st;
  int fd = ctx->fd;
  void* base = st->store_base;
  delete ctx;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // Mirrors objxfer.RANGE_MAGIC: 0xff "RAYTPU_RANGE_1" 0xff.
  static const uint8_t kRangeMagic[16] = {
      0xff, 'R', 'A', 'Y', 'T', 'P', 'U', '_',
      'R', 'A', 'N', 'G', 'E', '_', '1', 0xff};
  uint8_t oid[16];
  while (!st->stopping.load() && read_exact(fd, oid, 16) == 0) {
    uint64_t want_off = 0, want_len = 0;
    bool ranged = false;
    if (memcmp(oid, kRangeMagic, 16) == 0) {
      uint8_t req[16 + 8 + 8];
      if (read_exact(fd, req, sizeof(req)) != 0) break;
      memcpy(oid, req, 16);
      memcpy(&want_off, req + 16, 8);
      memcpy(&want_len, req + 24, 8);
      ranged = true;
    }
    uint64_t off = 0, dsize = 0, msize = 0;
    int rc = store_get(base, oid, &off, &dsize, &msize);
    if (rc != 0) {
      // -2 (ERR_AGAIN) = created but not yet sealed: tell the client to
      // retry shortly instead of reporting the object absent.
      uint8_t ok = (rc == -2) ? 2 : 0;
      if (write_all(fd, &ok, 1) != 0) break;
      continue;
    }
    uint64_t s_off = 0, s_len = dsize;
    if (ranged) {
      s_off = want_off > dsize ? dsize : want_off;
      s_len = dsize - s_off;
      if (want_len < s_len) s_len = want_len;
    }
    uint8_t hdr[1 + 8 + 8];
    hdr[0] = 1;
    memcpy(hdr + 1, &dsize, 8);
    memcpy(hdr + 9, &msize, 8);
    const char* data = (const char*)base + off;
    int err = write_all(fd, hdr, sizeof(hdr));
    if (!err && msize) err = write_all(fd, data + dsize, msize);
    if (!err && s_len) err = write_all(fd, data + s_off, s_len);
    store_release(base, oid);
    if (err) break;
  }
  {
    // Erase BEFORE close: once closed, the fd number can be reused by a
    // brand-new accepted connection — erasing after would delete the live
    // connection's entry and hide it from peer_server_stop.
    std::lock_guard<std::mutex> g(st->conn_mu);
    st->conn_fds.erase(fd);
  }
  close(fd);
  st->active.fetch_sub(1);
  return nullptr;
}

static void* accept_main(void* arg) {
  PeerState* st = (PeerState*)arg;
  for (;;) {
    int fd = accept(st->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;  // listen socket closed: shut down
    }
    if (st->stopping.load()) {
      close(fd);
      continue;
    }
    ConnCtx* cc = new ConnCtx{st, fd};
    st->active.fetch_add(1);
    {
      std::lock_guard<std::mutex> g(st->conn_mu);
      st->conn_fds.insert(fd);
    }
    pthread_t t;
    if (pthread_create(&t, nullptr, conn_main, cc) == 0) {
      pthread_detach(t);
    } else {
      close(fd);
      {
        std::lock_guard<std::mutex> g(st->conn_mu);
        st->conn_fds.erase(fd);
      }
      st->active.fetch_sub(1);
      delete cc;
    }
  }
  st->active.fetch_sub(1);  // accept thread's own ref
  return nullptr;
}

// Stops the server behind `handle` (from peer_server_start): closes the
// listener, shuts down live connections, and waits (bounded) for server
// threads to leave the arena — REQUIRED before unmapping the store.
void peer_server_stop(void* handle, int timeout_ms) {
  PeerState* st = (PeerState*)handle;
  if (!st) return;
  st->stopping.store(true);
  shutdown(st->listen_fd, SHUT_RDWR);
  close(st->listen_fd);
  {
    std::lock_guard<std::mutex> g(st->conn_mu);
    for (int fd : st->conn_fds) shutdown(fd, SHUT_RDWR);
  }
  for (int waited = 0; st->active.load() > 0 && waited < timeout_ms;
       waited += 10) {
    usleep(10 * 1000);
  }
  // Leak st if threads are wedged past the timeout — a freed PeerState
  // under a live thread would be worse.
  if (st->active.load() == 0) delete st;
}

// Starts the server; returns the bound port (>0) or -1; *out_handle gets
// the opaque server handle for peer_server_stop.
int peer_server_start(void* store_base, const char* bind_ip, int port,
                      void** out_handle) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, bind_ip, &addr.sin_addr) != 1) {
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
  }
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) != 0 || listen(fd, 64) != 0) {
    close(fd);
    return -1;
  }
  socklen_t len = sizeof(addr);
  if (getsockname(fd, (sockaddr*)&addr, &len) != 0) {
    close(fd);
    return -1;
  }
  PeerState* st = new PeerState;
  st->store_base = store_base;
  st->listen_fd = fd;
  st->active.store(1);  // the accept thread itself
  pthread_t t;
  if (pthread_create(&t, nullptr, accept_main, st) != 0) {
    close(fd);
    delete st;
    return -1;
  }
  pthread_detach(t);
  if (out_handle) *out_handle = st;
  return ntohs(addr.sin_port);
}

}  // extern "C"
