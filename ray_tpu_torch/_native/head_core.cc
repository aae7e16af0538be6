// Native select-round core for the HEAD's scheduling hot loop — the
// second half of the raylet split whose agent side is agent_core.cc
// (shared machinery in frame_core.h). Owns, per head process:
//
//   * the NODE-LISTENER FRAME PUMP — framecore::FramePump over every
//     node-agent TCP link, head-local worker socket and the cluster's
//     accept socket (accept readiness surfaces as a KIND_ACCEPT record;
//     Python runs accept() and registers the new conn);
//   * the COMPLETION LEDGER — in-place `node_done_raw` parse (outer
//     tuple, each forwarded raw worker frame, the done/done_batch
//     payloads inside) into flat completion records, plus the
//     (task_id, lease_seq) per-node inflight table that makes lease
//     re-drives idempotent from the head side too: a grant records the
//     pair, a completion pops it, and a duplicate completion (redrive
//     raced the original) surfaces with known=0 so Python's
//     authoritative pop stays the single decider;
//   * the GRANT BUILDER — native `node_exec_raw` frame builds from raw
//     spec bytes into per-node double-buffered outboxes (the head never
//     re-pickles the grant batch; the spec payload was pickled exactly
//     once by encode_payload).
//
// Python keeps all policy (placement, spill decisions, placement
// groups, dep gating, retries) and every cold path keeps its
// object-form frames (`lease_return` / `lease_spilled` / reclaim /
// cpp-language leases / the lease-redrive watchdog). Chaos-armed
// processes keep this ledger but route every send through per-frame
// send_msg and skip native consumption, so all seeded sites fire
// exactly as in the pure-Python loop (ray_tpu_torch/core/runtime.py gates on
// `native_head`).

#include "frame_core.h"

#include <string>
#include <unordered_map>
#include <vector>

using namespace framecore;

namespace {

struct OutRec {
  const uint8_t* rid = nullptr;
  uint64_t rid_len = 0;
  int status = 0;  // 0 inline, 1 err, 2 location (e.g. "shm")
  const uint8_t* payload = nullptr;
  uint64_t plen = 0;
  int payload_none = 0;
};

struct DoneRec {
  int nidx = -1;            // node conn the frame arrived on
  int known = 0;            // popped a live inflight entry
  const uint8_t* tid = nullptr;
  uint64_t tlen = 0;
  const uint8_t* whex = nullptr;  // executing worker hex (outer tuple)
  uint64_t wlen = 0;
  int tev_present = 0;
  int64_t tev_attempt = 0;
  double tev[4] = {0, 0, 0, 0};   // exec_start, args_ready, exec_done, ts
  int outs_off = 0;
  int n_outs = 0;
};

struct NodeRec {
  uint64_t tag = 0;
  bool gone = true;
  std::string entries;      // staged grant-entry pickles (no list header)
  uint64_t n_entries = 0;
  std::string outbox, outbox_scratch;  // double-buffered grant frames
};

struct Ctx {
  pthread_mutex_t mu = PTHREAD_MUTEX_INITIALIZER;
  FramePump pump;
  std::vector<NodeRec> nodes;
  std::unordered_map<uint64_t, int> tag2nidx;
  // task_id -> (nidx, lease_seq): the head-side grant ledger.
  std::unordered_map<std::string, std::pair<int, uint64_t>> inflight;
  // round scratch (views die at hdc_round_end)
  std::vector<DoneRec> recs;
  std::vector<OutRec> outs_pool;
  std::string rec_pack;  // bulk-drain scratch (hdc_recs_take)
  uint64_t stat_grants = 0, stat_dones = 0, stat_frames = 0;
};

// ---- node_done_raw walk (caller holds mu) ----

// Parse ONE forwarded raw worker frame (complete outer frame bytes) into
// staged records. Returns false to bail the whole node_done_raw frame to
// Python (oob buffers, foreign shapes — a bail is a slow frame, never a
// wrong one).
static bool walk_raw_done(int nidx, const uint8_t* whex,
                          uint64_t wlen, const uint8_t* raw, uint64_t rn,
                          std::vector<DoneRec>* recs,
                          std::vector<OutRec>* outs_pool) {
  if (rn < 12) return false;
  uint64_t plen;
  uint32_t nbufs;
  memcpy(&plen, raw, 8);
  memcpy(&nbufs, raw + 8, 4);
  if (nbufs != 0) return false;  // proto-flag or oob buffers: Python owns
  if (12 + plen != rn) return false;
  PickleWalk w;
  int root = w.parse(raw + 12, plen);
  if (root < 0) return false;
  PVal& tup = w.arena[root];
  if (tup.kind != PVal::TUPLE || tup.items.size() < 2) return false;
  PVal& opv = w.arena[tup.items[0]];
  if (opv.kind != PVal::STR) return false;
  std::string op((const char*)opv.p, opv.len);

  // One completion entry: (tid, actor_id, outs[, tev]) with the leading
  // "done" op already stripped for the single-done case.
  auto walk_entry = [&](const std::vector<int>& items, int base) -> bool {
    if ((int)items.size() < base + 3) return false;
    PVal& tid = w.arena[items[base]];
    PVal& actor = w.arena[items[base + 1]];
    PVal& outs = w.arena[items[base + 2]];
    if (tid.kind != PVal::BYTES) return false;
    if (actor.kind != PVal::NONE) return false;  // actor dones: head path
    if (outs.kind != PVal::LIST) return false;
    DoneRec r;
    r.nidx = nidx;
    r.tid = tid.p;
    r.tlen = tid.len;
    r.whex = whex;
    r.wlen = wlen;
    r.outs_off = (int)outs_pool->size();
    for (int oid : outs.items) {
      PVal& e = w.arena[oid];
      if (e.kind != PVal::TUPLE || e.items.size() != 4) return false;
      PVal& rid = w.arena[e.items[0]];
      PVal& st = w.arena[e.items[1]];
      PVal& pay = w.arena[e.items[2]];
      PVal& bufs = w.arena[e.items[3]];
      if (rid.kind != PVal::BYTES || st.kind != PVal::STR) return false;
      if (!(bufs.kind == PVal::NONE
            || (bufs.kind == PVal::LIST && bufs.items.empty())))
        return false;  // in-band buffer lists: Python owns
      OutRec o;
      o.rid = rid.p;
      o.rid_len = rid.len;
      if (st.len == 6 && memcmp(st.p, "inline", 6) == 0) o.status = 0;
      else if (st.len == 3 && memcmp(st.p, "err", 3) == 0) o.status = 1;
      else o.status = 2;
      if (pay.kind == PVal::BYTES) {
        o.payload = pay.p;
        o.plen = pay.len;
      } else if (pay.kind == PVal::NONE) {
        o.payload_none = 1;
      } else {
        return false;
      }
      outs_pool->push_back(o);
      r.n_outs++;
    }
    if ((int)items.size() > base + 3) {
      PVal& tev = w.arena[items[base + 3]];
      if (tev.kind == PVal::TUPLE) {
        if (tev.items.size() != 5) return false;
        PVal& att = w.arena[tev.items[0]];
        if (att.kind != PVal::INT) return false;
        r.tev_attempt = att.i;
        for (int k = 0; k < 4; k++) {
          PVal& v = w.arena[tev.items[k + 1]];
          if (v.kind == PVal::FLOAT) r.tev[k] = v.f;
          else if (v.kind == PVal::INT) r.tev[k] = (double)v.i;
          else return false;
        }
        r.tev_present = 1;
      } else if (tev.kind != PVal::NONE) {
        return false;
      }
    }
    recs->push_back(r);
    return true;
  };

  if (op == "done") {
    return walk_entry(tup.items, 1);
  }
  if (op == "done_batch") {
    PVal& lst = w.arena[tup.items[1]];
    if (lst.kind != PVal::LIST) return false;
    for (int id : lst.items) {
      PVal& e = w.arena[id];
      if (e.kind != PVal::TUPLE) return false;
      if (!walk_entry(e.items, 0)) return false;
    }
    return true;
  }
  return false;
}

}  // namespace

extern "C" {

void* hdc_new() {
  Ctx* c = new Ctx();
  c->pump.init();
  return c;
}

void hdc_free(void* h) {
  Ctx* c = (Ctx*)h;
  c->pump.close_ep();
  delete c;
}

// mode: 0 = pickle-framed conn (nodes, workers, clients), 2 = accept
// socket (readiness only; Python runs accept()).
int hdc_add_fd(void* h, int fd, uint64_t tag, int mode) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  return c->pump.add_fd(fd, tag, mode);
}

int hdc_del_fd(void* h, int fd) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  return c->pump.del_fd(fd);
}

int hdc_poll(void* h, int timeout_ms) {
  Ctx* c = (Ctx*)h;
  int n = c->pump.wait(timeout_ms);
  if (n <= 0) return n;
  Lock l(&c->mu);
  return c->pump.drain(n);
}

int hdc_split(void* h) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  return c->pump.split();
}

int hdc_frame_count(void* h) {
  Ctx* c = (Ctx*)h;
  return (int)c->pump.frames.size();
}

int hdc_frame_info(void* h, int i, uint64_t* tag, int* kind, int* proto_tag,
                   const uint8_t** payload, uint64_t* plen,
                   const uint8_t** whole, uint64_t* wlen, int* nbufs,
                   int* consumed) {
  Ctx* c = (Ctx*)h;
  return c->pump.frame_info(i, tag, kind, proto_tag, payload, plen, whole,
                            wlen, nbufs, consumed);
}

int hdc_frame_buf(void* h, int i, int j, const uint8_t** p, uint64_t* n) {
  Ctx* c = (Ctx*)h;
  return c->pump.frame_buf(i, j, p, n);
}

void hdc_round_end(void* h) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  c->recs.clear();
  c->outs_pool.clear();
  c->pump.round_end();
}

// ---- node ledger ----

int hdc_node_add(void* h, uint64_t tag) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  NodeRec n;
  n.tag = tag;
  n.gone = false;
  c->nodes.push_back(std::move(n));
  int nidx = (int)c->nodes.size() - 1;
  c->tag2nidx[tag] = nidx;
  return nidx;
}

void hdc_node_remove(void* h, int nidx) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  if (nidx < 0 || nidx >= (int)c->nodes.size()) return;
  NodeRec& n = c->nodes[nidx];
  n.gone = true;
  c->tag2nidx.erase(n.tag);
  n.entries.clear();
  n.n_entries = 0;
  n.outbox.clear();
  // Python requeues the dead node's leases itself (node.leases is the
  // authoritative table); drop the native mirror so re-grants re-record.
  for (auto it = c->inflight.begin(); it != c->inflight.end();) {
    if (it->second.first == nidx) it = c->inflight.erase(it);
    else ++it;
  }
}

// ---- grant builder ----

// Stage one grant entry for `nidx` and record (tid, seq) inflight. The
// entry pickles to the same 7-tuple the Python grant path ships:
// (task_id, fn_id|None, lease_seq, blob|None, spec_bytes, attempt,
// name|None). Re-staging an inflight (tid, seq) — a lease re-drive —
// updates the ledger in place (idempotent), never duplicates it.
void hdc_grant_add(void* h, int nidx, const uint8_t* tid, int tlen,
                   const uint8_t* fn, int flen, uint64_t seq,
                   const uint8_t* blob, uint64_t blen, int has_blob,
                   const uint8_t* spec, uint64_t slen, int64_t attempt,
                   const uint8_t* name, int nlen) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  if (nidx < 0 || nidx >= (int)c->nodes.size()) return;
  NodeRec& n = c->nodes[nidx];
  if (n.gone) return;
  std::string& o = n.entries;
  o.push_back((char)OP_MARK);
  pk_bytes(o, tid, tlen);
  if (fn && flen > 0) pk_bytes(o, fn, flen);
  else pk_none(o);
  pk_int(o, (int64_t)seq);
  if (has_blob) pk_bytes(o, blob, blen);
  else pk_none(o);
  pk_bytes(o, spec, slen);
  pk_int(o, attempt);
  if (name && nlen > 0) pk_strn(o, name, nlen);
  else pk_none(o);
  o.push_back((char)OP_TUPLE);
  n.n_entries++;
  std::string k((const char*)tid, tlen);
  c->inflight[std::move(k)] = {nidx, seq};
  c->stat_grants++;
}

// Swap out the staged grant batch as ONE complete node_exec_raw outer
// frame. View valid until the next take for the same node. Call under
// the node conn's send lock (the same per-destination write ordering as
// the Python path).
int hdc_grant_take(void* h, int nidx, const uint8_t** p, uint64_t* n) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  *p = nullptr;
  *n = 0;
  if (nidx < 0 || nidx >= (int)c->nodes.size()) return -1;
  NodeRec& nd = c->nodes[nidx];
  nd.outbox_scratch.clear();
  if (!nd.n_entries) return 0;
  std::string payload;
  pk_proto(payload);
  pk_str(payload, "node_exec_raw");
  payload.push_back((char)OP_EMPTY_LIST);
  payload.push_back((char)OP_MARK);
  payload += nd.entries;
  payload.push_back((char)OP_APPENDS);
  payload.push_back((char)OP_TUPLE2);
  payload.push_back((char)OP_STOP);
  frame_wrap(nd.outbox_scratch, payload);
  nd.entries.clear();
  nd.n_entries = 0;
  *p = (const uint8_t*)nd.outbox_scratch.data();
  *n = nd.outbox_scratch.size();
  return 0;
}

// Drop a node's staged-but-untaken grants (send failed before take; the
// node-death path requeues the leases from Python's tables).
void hdc_grant_drop(void* h, int nidx) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  if (nidx < 0 || nidx >= (int)c->nodes.size()) return;
  c->nodes[nidx].entries.clear();
  c->nodes[nidx].n_entries = 0;
}

// ---- completion ledger ----

// Natively consume every node_done_raw frame in the split set arriving
// on a registered node conn: parse outer tuple + each forwarded raw
// worker frame in place, pop the inflight ledger, and stage flat
// completion records for Python's policy pass. A frame with ANY
// surprising shape is left untouched for the Python path. Returns the
// number of frames consumed.
int hdc_consume_hot(void* h) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  int consumed = 0;
  for (auto& f : c->pump.frames) {
    if (f.kind != KIND_PICKLE || f.consumed) continue;
    if (strcmp(f.op, "node_done_raw") != 0) continue;
    auto nit = c->tag2nidx.find(f.tag);
    if (nit == c->tag2nidx.end()) continue;  // not a registered node
    if (!f.bufs.empty()) continue;
    int nidx = nit->second;
    PickleWalk w;
    int root = w.parse(f.payload, f.payload_len);
    if (root < 0) continue;
    PVal& tup = w.arena[root];
    if (tup.kind != PVal::TUPLE || tup.items.size() != 3) continue;
    PVal& whex = w.arena[tup.items[1]];
    PVal& raws = w.arena[tup.items[2]];
    if (whex.kind != PVal::STR || raws.kind != PVal::LIST) continue;
    // Two-phase: validate + stage into scratch, commit only when the
    // WHOLE frame parses (a half-consumed frame would double-handle).
    std::vector<DoneRec> recs;
    std::vector<OutRec> outs;
    bool ok = true;
    for (int rid : raws.items) {
      PVal& raw = w.arena[rid];
      if (raw.kind != PVal::BYTES
          || !walk_raw_done(nidx, whex.p, whex.len, raw.p, raw.len,
                            &recs, &outs)) {
        ok = false;
        break;
      }
    }
    if (!ok) continue;
    int out_base = (int)c->outs_pool.size();
    for (auto& r : recs) {
      std::string k((const char*)r.tid, r.tlen);
      auto inf = c->inflight.find(k);
      if (inf != c->inflight.end()) {
        r.known = 1;
        c->inflight.erase(inf);
      }
      r.outs_off += out_base;
      c->recs.push_back(r);
      c->stat_dones++;
    }
    c->outs_pool.insert(c->outs_pool.end(), outs.begin(), outs.end());
    f.consumed = true;
    consumed++;
    c->stat_frames++;
  }
  return consumed;
}

int hdc_rec_count(void* h) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  return (int)c->recs.size();
}

// Bulk drain: every staged completion record packed into ONE buffer so
// Python reads the round with a single ctypes call + struct unpacks
// (the per-field accessor chatter measurably hit the 16-agent storm).
// Little-endian layout per record:
//   <i nidx><B known><B tev_present><H tlen><H wlen><q tev_attempt>
//   <4d tev><H n_outs> tid whex
//   then per out: <B status><B payload_none><I rid_len><Q plen>
//                 rid payload
// View valid until the next take / hdc_round_end.
int hdc_recs_take(void* h, const uint8_t** p, uint64_t* n) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  std::string& o = c->rec_pack;
  o.clear();
  for (auto& r : c->recs) {
    int32_t nidx = r.nidx;
    o.append((const char*)&nidx, 4);
    o.push_back((char)(r.known ? 1 : 0));
    o.push_back((char)(r.tev_present ? 1 : 0));
    uint16_t tlen = (uint16_t)r.tlen, wlen = (uint16_t)r.wlen;
    o.append((const char*)&tlen, 2);
    o.append((const char*)&wlen, 2);
    o.append((const char*)&r.tev_attempt, 8);
    o.append((const char*)r.tev, 32);
    uint16_t nouts = (uint16_t)r.n_outs;
    o.append((const char*)&nouts, 2);
    o.append((const char*)r.tid, r.tlen);
    o.append((const char*)r.whex, r.wlen);
    for (int j = r.outs_off; j < r.outs_off + r.n_outs; j++) {
      OutRec& e = c->outs_pool[j];
      o.push_back((char)e.status);
      o.push_back((char)e.payload_none);
      uint32_t rl = (uint32_t)e.rid_len;
      o.append((const char*)&rl, 4);
      uint64_t pl = e.plen;
      o.append((const char*)&pl, 8);
      o.append((const char*)e.rid, e.rid_len);
      if (!e.payload_none) o.append((const char*)e.payload, e.plen);
    }
  }
  *p = (const uint8_t*)o.data();
  *n = o.size();
  return (int)c->recs.size();
}

int hdc_rec_info(void* h, int i, int* nidx, int* known,
                 const uint8_t** tid, uint64_t* tlen,
                 const uint8_t** whex, uint64_t* wlen, int* tev_present,
                 int64_t* tev_attempt, double* tev4, int* outs_off,
                 int* n_outs) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  if (i < 0 || i >= (int)c->recs.size()) return -1;
  DoneRec& r = c->recs[i];
  *nidx = r.nidx;
  *known = r.known;
  *tid = r.tid;
  *tlen = r.tlen;
  *whex = r.whex;
  *wlen = r.wlen;
  *tev_present = r.tev_present;
  *tev_attempt = r.tev_attempt;
  for (int k = 0; k < 4; k++) tev4[k] = r.tev[k];
  *outs_off = r.outs_off;
  *n_outs = r.n_outs;
  return 0;
}

int hdc_rec_out(void* h, int j, const uint8_t** rid, uint64_t* rlen,
                int* status, const uint8_t** payload, uint64_t* plen,
                int* payload_none) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  if (j < 0 || j >= (int)c->outs_pool.size()) return -1;
  OutRec& o = c->outs_pool[j];
  *rid = o.rid;
  *rlen = o.rid_len;
  *status = o.status;
  *payload = o.payload;
  *plen = o.plen;
  *payload_none = o.payload_none;
  return 0;
}

// Cold-path pop (lease_fail / lease_return / reclaim / node death /
// Python-path completion): idempotent, returns the granted nidx or -1.
int hdc_inflight_pop(void* h, const uint8_t* tid, int tlen) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  auto it = c->inflight.find(std::string((const char*)tid, tlen));
  if (it == c->inflight.end()) return -1;
  int nidx = it->second.first;
  c->inflight.erase(it);
  return nidx;
}

uint64_t hdc_inflight(void* h) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  return c->inflight.size();
}

void hdc_stats(void* h, uint64_t* grants, uint64_t* dones,
               uint64_t* frames) {
  Ctx* c = (Ctx*)h;
  Lock l(&c->mu);
  *grants = c->stat_grants;
  *dones = c->stat_dones;
  *frames = c->stat_frames;
}

// The shared AgentFrame oneof tag table (frame_core.h) — the drift gate
// reads it through this core too, so both .so's provably compile the
// same pin.
int hdc_proto_tag_count() {
  return agent_frame_tag_count();
}

int hdc_proto_tag_entry(int i, int* field, const char** name) {
  return agent_frame_tag_entry(i, field, name);
}

}  // extern "C"
