// Native runtime helpers for mysticeti-tpu (CPython C API, no pybind11).
//
// The reference implements its storage/wire hot paths in Rust
// (mysticeti-core/src/wal.rs, network.rs); this extension is the C++
// equivalent for the paths where pure Python measurably costs: the WAL
// recovery scan (header walk + crc over every entry at node restart) and
// scatter-gather entry framing.  Little-endian hosts only (x86-64 / aarch64
// — same assumption the <IIII struct framing in wal.py already makes).
//
// Build: see mysticeti_tpu_torch/native/__init__.py (g++ -O2 -shared -fPIC
// -pthread -lz).
// Python fallbacks exist for every function; the extension is an
// acceleration, not a requirement.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <sched.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <system_error>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr uint32_t kWalMagic = 0x314C4157;  // b"WAL1"
constexpr Py_ssize_t kHeaderSize = 16;      // magic, crc32, len, tag (u32 LE)

// wal_scan(buffer, end) -> list[(pos, tag, payload_off, payload_len)]
//
// Walks entry headers from offset 0, validating magic and payload crc32.
// Stops cleanly at the first invalid/torn entry — the crash-recovery
// contract of WalReader.iter_until (wal.rs:270-293 semantics).  Offsets are
// returned instead of payload copies so the caller can slice the mmap
// zero-copy.
PyObject* wal_scan(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned long long end_arg;
  if (!PyArg_ParseTuple(args, "y*K", &buf, &end_arg)) return nullptr;

  const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
  Py_ssize_t limit = static_cast<Py_ssize_t>(end_arg);
  if (limit > buf.len) limit = buf.len;

  PyObject* out = PyList_New(0);
  if (out == nullptr) {
    PyBuffer_Release(&buf);
    return nullptr;
  }

  Py_ssize_t pos = 0;
  while (pos + kHeaderSize <= limit) {
    uint32_t magic, crc, length, tag;
    std::memcpy(&magic, data + pos, 4);
    std::memcpy(&crc, data + pos + 4, 4);
    std::memcpy(&length, data + pos + 8, 4);
    std::memcpy(&tag, data + pos + 12, 4);
    if (magic != kWalMagic) break;
    Py_ssize_t payload_off = pos + kHeaderSize;
    if (payload_off + static_cast<Py_ssize_t>(length) > limit) break;

    uint32_t actual;
    Py_BEGIN_ALLOW_THREADS
    actual = static_cast<uint32_t>(
        crc32(0L, data + payload_off, static_cast<uInt>(length)));
    Py_END_ALLOW_THREADS
    if (actual != crc) break;

    PyObject* item =
        Py_BuildValue("(KIKI)", static_cast<unsigned long long>(pos), tag,
                      static_cast<unsigned long long>(payload_off), length);
    if (item == nullptr || PyList_Append(out, item) < 0) {
      Py_XDECREF(item);
      Py_DECREF(out);
      PyBuffer_Release(&buf);
      return nullptr;
    }
    Py_DECREF(item);
    pos = payload_off + static_cast<Py_ssize_t>(length);
  }

  PyBuffer_Release(&buf);
  return out;
}

// frame_entry(tag, parts) -> bytes
//
// Assemble one WAL entry (16-byte header + concatenated parts) with the
// crc computed in a single pass — replaces the per-part Python crc loop +
// struct.pack + join in WalWriter.writev.
PyObject* frame_entry(PyObject*, PyObject* args) {
  unsigned int tag;
  PyObject* parts;
  if (!PyArg_ParseTuple(args, "IO", &tag, &parts)) return nullptr;
  PyObject* seq = PySequence_Fast(parts, "parts must be a sequence");
  if (seq == nullptr) return nullptr;

  // Acquire every part's buffer up front: total is computed from the SAME
  // views the copy uses (PyObject_Length counts items, not bytes — sizing
  // from it would overflow the output for itemsize > 1 buffers), and holding
  // the views pins the lengths against concurrent mutation.
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<Py_buffer> views(static_cast<size_t>(n));
  Py_ssize_t total = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* part = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(part, &views[i], PyBUF_SIMPLE) < 0) {
      for (Py_ssize_t j = 0; j < i; ++j) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      return nullptr;
    }
    total += views[i].len;
  }

  PyObject* out = PyBytes_FromStringAndSize(nullptr, kHeaderSize + total);
  if (out == nullptr) {
    for (Py_ssize_t i = 0; i < n; ++i) PyBuffer_Release(&views[i]);
    Py_DECREF(seq);
    return nullptr;
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  uint8_t* payload = dst + kHeaderSize;
  for (Py_ssize_t i = 0; i < n; ++i) {
    std::memcpy(payload, views[i].buf, views[i].len);
    payload += views[i].len;
    PyBuffer_Release(&views[i]);
  }

  uint32_t crc;
  Py_BEGIN_ALLOW_THREADS
  crc = static_cast<uint32_t>(
      crc32(0L, dst + kHeaderSize, static_cast<uInt>(total)));
  Py_END_ALLOW_THREADS

  uint32_t magic = kWalMagic;
  uint32_t length = static_cast<uint32_t>(total);
  std::memcpy(dst, &magic, 4);
  std::memcpy(dst + 4, &crc, 4);
  std::memcpy(dst + 8, &length, 4);
  std::memcpy(dst + 12, &tag, 4);

  Py_DECREF(seq);
  return out;
}

// ---------------------------------------------------------------------------
// VoteAggregator — the TransactionAggregator hot core (committee.rs:364-482
// analog).  Replaces the per-offset Python objects (TransactionLocator
// namedtuples, StakeAggregator instances, set hashing) that dominate the
// engine profile at load.  Semantics mirror TransactionAggregator in committee.py
// exactly, including RangeMap's split-on-overlap behavior (range_map.py:38),
// so state() snapshots are byte-identical to the pure-Python path.
// ---------------------------------------------------------------------------

constexpr int kMaskWords = 8;  // 512-bit authority mask (AuthoritySet cap)

struct VaEntry {
  uint64_t start, end;  // half-open offset range
  uint64_t stake;
  uint8_t kind;  // 0 quorum / 1 validity (round-trips the state encoding)
  uint64_t mask[kMaskWords];
};

struct VaBlock {
  std::vector<VaEntry> ranges;               // sorted, disjoint, non-empty
  std::map<uint64_t, uint64_t> processed;    // merged [start, end) intervals
};

struct VoteAgg {
  bool track_processed = true;
  bool bound = false;
  uint8_t kind = 0;
  std::vector<uint64_t> stakes;
  uint64_t threshold = 0;
  std::unordered_map<std::string, VaBlock> blocks;
  size_t pending_count = 0;  // blocks with non-empty ranges
};

void va_destroy(PyObject* cap) {
  delete static_cast<VoteAgg*>(PyCapsule_GetPointer(cap, "mysticeti.va"));
}

VoteAgg* va_from(PyObject* cap) {
  return static_cast<VoteAgg*>(PyCapsule_GetPointer(cap, "mysticeti.va"));
}

// Merged-interval helpers over VaBlock::processed.
void processed_mark(VaBlock& b, uint64_t s, uint64_t e) {
  auto it = b.processed.upper_bound(s);
  if (it != b.processed.begin()) {
    --it;
    if (it->second >= s) {
      s = it->first;
      e = std::max(e, it->second);
      it = b.processed.erase(it);
    } else {
      ++it;
    }
  }
  while (it != b.processed.end() && it->first <= e) {
    e = std::max(e, it->second);
    it = b.processed.erase(it);
  }
  b.processed.emplace(s, e);
}

bool processed_contains(const VaBlock& b, uint64_t off) {
  auto it = b.processed.upper_bound(off);
  if (it == b.processed.begin()) return false;
  --it;
  return it->first <= off && off < it->second;
}

// Append the sub-intervals of [s, e) NOT in the processed set.  These are
// the violation ranges the Python wrapper feeds through the overridable
// handler hooks offset-by-offset — exact parity with the pure path, which
// calls the hook for every violating offset.
void unprocessed_intervals(const VaBlock& b, uint64_t s, uint64_t e,
                           std::vector<std::pair<uint64_t, uint64_t>>& out) {
  uint64_t cur = s;
  while (cur < e) {
    auto it = b.processed.upper_bound(cur);
    if (it != b.processed.begin()) {
      auto prev = std::prev(it);
      if (prev->first <= cur && cur < prev->second) {
        cur = prev->second;
        continue;
      }
    }
    uint64_t gap_end = e;
    if (it != b.processed.end()) gap_end = std::min(gap_end, it->first);
    if (cur < gap_end) out.emplace_back(cur, gap_end);
    cur = gap_end;
  }
}

PyObject* intervals_to_list(
    const std::vector<std::pair<uint64_t, uint64_t>>& ivs) {
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  for (auto& iv : ivs) {
    PyObject* item =
        Py_BuildValue("(KK)", static_cast<unsigned long long>(iv.first),
                      static_cast<unsigned long long>(iv.second));
    if (item == nullptr || PyList_Append(out, item) < 0) {
      Py_XDECREF(item);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(item);
  }
  return out;
}

// va_new(track_processed, kind) -> capsule
PyObject* va_new(PyObject*, PyObject* args) {
  int track, kind;
  if (!PyArg_ParseTuple(args, "pi", &track, &kind)) return nullptr;
  auto* agg = new VoteAgg();
  agg->track_processed = track != 0;
  agg->kind = static_cast<uint8_t>(kind);
  return PyCapsule_New(agg, "mysticeti.va", va_destroy);
}

// va_bind(cap, stakes_list, threshold)
PyObject* va_bind(PyObject*, PyObject* args) {
  PyObject* cap;
  PyObject* stakes;
  unsigned long long threshold;
  if (!PyArg_ParseTuple(args, "OOK", &cap, &stakes, &threshold)) return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  PyObject* seq = PySequence_Fast(stakes, "stakes must be a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  if (n > kMaskWords * 64) {
    Py_DECREF(seq);
    PyErr_SetString(PyExc_ValueError, "committee exceeds 512 authorities");
    return nullptr;
  }
  agg->stakes.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i) {
    agg->stakes[static_cast<size_t>(i)] = PyLong_AsUnsignedLongLong(
        PySequence_Fast_GET_ITEM(seq, i));
    if (PyErr_Occurred()) {
      Py_DECREF(seq);
      return nullptr;
    }
  }
  Py_DECREF(seq);
  agg->threshold = threshold;
  agg->bound = true;
  Py_RETURN_NONE;
}

// The shared sweep structure of RangeMap.mutate_range (range_map.py:38-80):
// fragments of existing entries overlapping [start, end) and the gaps
// between them, visited in offset order.  `OnFrag` returns true to keep the
// (possibly modified) fragment, false to drop it; `OnGap` returns true to
// materialize a fresh entry for the gap (initialized by it).
template <typename OnFrag, typename OnGap>
void sweep(VaBlock& b, uint64_t start, uint64_t end, OnFrag on_frag,
           OnGap on_gap) {
  std::vector<VaEntry> out;
  out.reserve(b.ranges.size() + 4);
  uint64_t cursor = start;
  for (VaEntry& entry : b.ranges) {
    if (entry.end <= start || entry.start >= end) {
      out.push_back(entry);
      continue;
    }
    if (entry.start < start) {
      VaEntry head = entry;
      head.end = start;
      out.push_back(head);
    }
    uint64_t ov_s = std::max(entry.start, start);
    uint64_t ov_e = std::min(entry.end, end);
    if (cursor < ov_s) {
      VaEntry fresh;
      if (on_gap(cursor, ov_s, fresh)) {
        fresh.start = cursor;
        fresh.end = ov_s;
        out.push_back(fresh);
      }
    }
    VaEntry frag = entry;  // POD clone — RangeMap clones on split
    frag.start = ov_s;
    frag.end = ov_e;
    if (on_frag(frag)) out.push_back(frag);
    cursor = ov_e;
    if (entry.end > end) {
      VaEntry tail = entry;
      tail.start = end;
      out.push_back(tail);
    }
  }
  if (cursor < end) {
    VaEntry fresh;
    if (on_gap(cursor, end, fresh)) {
      fresh.start = cursor;
      fresh.end = end;
      out.push_back(fresh);
    }
  }
  std::sort(out.begin(), out.end(),
            [](const VaEntry& a, const VaEntry& c) { return a.start < c.start; });
  b.ranges = std::move(out);
}

bool va_check_author(VoteAgg* agg, unsigned long long author) {
  if (!agg->bound) {
    PyErr_SetString(PyExc_RuntimeError, "VoteAggregator not bound to a committee");
    return false;
  }
  if (author >= agg->stakes.size()) {
    PyErr_SetString(PyExc_ValueError, "authority index out of range");
    return false;
  }
  return true;
}

// va_register(cap, key, start, end, author) -> [(s, e) violation ranges]
//
// committee.py register(): gaps get a fresh aggregator seeded with the
// author's vote; existing fragments are duplicate-share violations unless
// every offset is already processed.
PyObject* va_register(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* key;
  Py_ssize_t keylen;
  unsigned long long start, end, author;
  if (!PyArg_ParseTuple(args, "Oy#KKK", &cap, &key, &keylen, &start, &end,
                        &author))
    return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr || !va_check_author(agg, author)) return nullptr;
  std::vector<std::pair<uint64_t, uint64_t>> violations;
  if (start < end) {
    VaBlock& b = agg->blocks[std::string(key, static_cast<size_t>(keylen))];
    bool was_empty = b.ranges.empty();
    sweep(
        b, start, end,
        [&](VaEntry& frag) {
          if (agg->track_processed) {
            unprocessed_intervals(b, frag.start, frag.end, violations);
          }
          return true;  // keep the existing aggregation untouched
        },
        [&](uint64_t, uint64_t, VaEntry& fresh) {
          std::memset(fresh.mask, 0, sizeof(fresh.mask));
          fresh.mask[author / 64] = 1ULL << (author % 64);
          fresh.stake = agg->stakes[author];
          fresh.kind = agg->kind;
          return true;
        });
    if (was_empty && !b.ranges.empty()) agg->pending_count++;
  }
  return intervals_to_list(violations);
}

// va_vote(cap, key, start, end, author)
//   -> ([(s, e) certified...], [(s, e) violations...], block_retired)
//
// committee.py vote(): gaps are unknown-transaction violations unless
// processed; fragments accumulate the vote and certify at the threshold
// (certified fragments are dropped and marked processed).  `block_retired`
// tells the wrapper the block record was dropped entirely (only possible
// when track_processed is off — with tracking on, the processed intervals
// must outlive the pending ranges, exactly like the pure path's `processed`
// set).
PyObject* va_vote(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* key;
  Py_ssize_t keylen;
  unsigned long long start, end, author;
  if (!PyArg_ParseTuple(args, "Oy#KKK", &cap, &key, &keylen, &start, &end,
                        &author))
    return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr || !va_check_author(agg, author)) return nullptr;
  std::vector<std::pair<uint64_t, uint64_t>> done;
  std::vector<std::pair<uint64_t, uint64_t>> violations;
  bool retired = false;
  if (start < end) {
    auto found = agg->blocks.find(std::string(key, static_cast<size_t>(keylen)));
    if (found == agg->blocks.end()) {
      // No record for this block at all: nothing pending and nothing ever
      // processed (committee.py vote():380-384).
      if (agg->track_processed) violations.emplace_back(start, end);
    } else {
      VaBlock& b = found->second;
      bool was_nonempty = !b.ranges.empty();
      sweep(
          b, start, end,
          [&](VaEntry& frag) {
            uint64_t bit = 1ULL << (author % 64);
            if (!(frag.mask[author / 64] & bit)) {
              frag.mask[author / 64] |= bit;
              frag.stake += agg->stakes[author];
            }
            if (frag.stake >= agg->threshold) {
              done.emplace_back(frag.start, frag.end);
              return false;  // certified: drop from pending
            }
            return true;
          },
          [&](uint64_t gs, uint64_t ge, VaEntry&) {
            if (agg->track_processed) unprocessed_intervals(b, gs, ge, violations);
            return false;  // gaps stay gaps
          });
      if (agg->track_processed) {
        for (auto& range : done) processed_mark(b, range.first, range.second);
      }
      if (was_nonempty && b.ranges.empty()) {
        agg->pending_count--;
        if (!agg->track_processed) {
          // Nothing left to remember for this block: drop the record so a
          // long-running certified-log node (track_processed off) stays
          // flat on memory, like the pure path deleting its RangeMap.
          agg->blocks.erase(found);
          retired = true;
        }
      }
    }
  }
  PyObject* certified = intervals_to_list(done);
  if (certified == nullptr) return nullptr;
  PyObject* viol = intervals_to_list(violations);
  if (viol == nullptr) {
    Py_DECREF(certified);
    return nullptr;
  }
  PyObject* out = Py_BuildValue("(NNO)", certified, viol,
                                retired ? Py_True : Py_False);
  if (out == nullptr) {
    Py_DECREF(certified);
    Py_DECREF(viol);
  }
  return out;
}

// va_is_processed(cap, key, offset) -> bool
PyObject* va_is_processed(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* key;
  Py_ssize_t keylen;
  unsigned long long off;
  if (!PyArg_ParseTuple(args, "Oy#K", &cap, &key, &keylen, &off)) return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  auto found = agg->blocks.find(std::string(key, static_cast<size_t>(keylen)));
  if (found == agg->blocks.end()) Py_RETURN_FALSE;
  if (processed_contains(found->second, off)) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

// va_pending_len(cap) -> number of blocks with live aggregations
PyObject* va_pending_len(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  return PyLong_FromSize_t(agg->pending_count);
}

// va_items(cap) -> [(key, [(start, end, stake, kind, mask_bytes)...])...]
// for blocks with live ranges (state snapshot source; caller sorts by ref).
PyObject* va_items(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  for (auto& kv : agg->blocks) {
    if (kv.second.ranges.empty()) continue;
    PyObject* ranges = PyList_New(0);
    if (ranges == nullptr) goto fail;
    for (const VaEntry& e : kv.second.ranges) {
      PyObject* item = Py_BuildValue(
          "(KKKiy#)", static_cast<unsigned long long>(e.start),
          static_cast<unsigned long long>(e.end),
          static_cast<unsigned long long>(e.stake), static_cast<int>(e.kind),
          reinterpret_cast<const char*>(e.mask),
          static_cast<Py_ssize_t>(sizeof(e.mask)));
      if (item == nullptr || PyList_Append(ranges, item) < 0) {
        Py_XDECREF(item);
        Py_DECREF(ranges);
        goto fail;
      }
      Py_DECREF(item);
    }
    {
      PyObject* pair = Py_BuildValue(
          "(y#N)", kv.first.data(), static_cast<Py_ssize_t>(kv.first.size()),
          ranges);
      if (pair == nullptr) {
        Py_DECREF(ranges);
        goto fail;
      }
      if (PyList_Append(out, pair) < 0) {
        Py_DECREF(pair);
        goto fail;
      }
      Py_DECREF(pair);
    }
  }
  return out;
fail:
  Py_DECREF(out);
  return nullptr;
}

// va_load(cap, key, start, end, stake, kind, mask_bytes) — state restore.
PyObject* va_load(PyObject*, PyObject* args) {
  PyObject* cap;
  const char* key;
  Py_ssize_t keylen;
  unsigned long long start, end, stake;
  int kind;
  const char* mask;
  Py_ssize_t masklen;
  if (!PyArg_ParseTuple(args, "Oy#KKKiy#", &cap, &key, &keylen, &start, &end,
                        &stake, &kind, &mask, &masklen))
    return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  if (masklen > static_cast<Py_ssize_t>(sizeof(uint64_t) * kMaskWords)) {
    PyErr_SetString(PyExc_ValueError, "vote mask too wide");
    return nullptr;
  }
  VaBlock& b = agg->blocks[std::string(key, static_cast<size_t>(keylen))];
  bool was_empty = b.ranges.empty();
  VaEntry e;
  e.start = start;
  e.end = end;
  e.stake = stake;
  e.kind = static_cast<uint8_t>(kind);
  std::memset(e.mask, 0, sizeof(e.mask));
  std::memcpy(e.mask, mask, static_cast<size_t>(masklen));
  auto pos = std::upper_bound(
      b.ranges.begin(), b.ranges.end(), e,
      [](const VaEntry& a, const VaEntry& c) { return a.start < c.start; });
  b.ranges.insert(pos, e);
  if (was_empty) agg->pending_count++;
  Py_RETURN_NONE;
}

// va_state(cap) -> bytes — the canonical aggregator snapshot, byte-identical
// to committee.py TransactionAggregator._nat_state(): u32 block count; per
// block, sorted by (authority, round, digest): the 48-byte reference
// encoding — which IS the map key verbatim (LE u64 authority + LE u64 round
// + 32-byte digest, exactly BlockReference.encode's layout); u32 range
// count; per range: u64 start, u64 end, u8 kind, u64 stake, u32 mask length
// + mask bytes.  Serializing here instead of round-tripping va_items through
// Python removes the dominant cost of the per-commit state snapshot (tens
// of ms at deep pending backlogs -> tens of µs).
PyObject* va_state(PyObject*, PyObject* args) {
  PyObject* cap;
  if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
  VoteAgg* agg = va_from(cap);
  if (agg == nullptr) return nullptr;
  std::vector<std::pair<const std::string*, const VaBlock*>> items;
  items.reserve(agg->blocks.size());
  for (const auto& kv : agg->blocks) {
    if (kv.second.ranges.empty()) continue;
    if (kv.first.size() != 48) {
      PyErr_SetString(PyExc_ValueError, "aggregator key is not a block ref");
      return nullptr;
    }
    items.emplace_back(&kv.first, &kv.second);
  }
  // Sort order must match Python's BlockReference dataclass ordering:
  // numeric (authority, round) then lexicographic digest.  LE host assumed
  // (module-wide assumption), so the packed u64s decode with memcpy.
  std::sort(items.begin(), items.end(),
            [](const std::pair<const std::string*, const VaBlock*>& x,
               const std::pair<const std::string*, const VaBlock*>& y) {
              uint64_t xa, xr, ya, yr;
              std::memcpy(&xa, x.first->data(), 8);
              std::memcpy(&xr, x.first->data() + 8, 8);
              std::memcpy(&ya, y.first->data(), 8);
              std::memcpy(&yr, y.first->data() + 8, 8);
              if (xa != ya) return xa < ya;
              if (xr != yr) return xr < yr;
              return std::memcmp(x.first->data() + 16, y.first->data() + 16,
                                 32) < 0;
            });
  std::string out;
  auto put_u32 = [&out](uint32_t v) {
    out.append(reinterpret_cast<const char*>(&v), 4);
  };
  auto put_u64 = [&out](uint64_t v) {
    out.append(reinterpret_cast<const char*>(&v), 8);
  };
  put_u32(static_cast<uint32_t>(items.size()));
  for (const auto& item : items) {
    out.append(*item.first);  // 48-byte ref encoding == the key bytes
    put_u32(static_cast<uint32_t>(item.second->ranges.size()));
    for (const VaEntry& e : item.second->ranges) {
      put_u64(e.start);
      put_u64(e.end);
      out.push_back(static_cast<char>(e.kind));
      put_u64(e.stake);
      put_u32(static_cast<uint32_t>(sizeof(e.mask)));
      out.append(reinterpret_cast<const char*>(e.mask), sizeof(e.mask));
    }
  }
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

// ---------------------------------------------------------------------------
// Block decoding (types.py:StatementBlock.from_bytes hot path).
//
// At saturated load a node decodes ~20+ MB/s of peer blocks; the Python
// inline decoder costs ~77 ms per 5 MB block (tens of thousands of
// interpreter-loop slice+construct steps).  This walks the same wire format
// in C and builds the same frozen-dataclass statement objects, which the
// caller assembles into a StatementBlock.  Registered classes are module
// state (decode_register, called by types.py at import).

PyObject* g_cls_block_ref = nullptr;
PyObject* g_cls_share = nullptr;
PyObject* g_cls_vote = nullptr;
PyObject* g_cls_vote_range = nullptr;
PyObject* g_cls_locator = nullptr;
PyObject* g_cls_locator_range = nullptr;

// Interned attribute keys for the fast construction path.
PyObject* g_empty_tuple = nullptr;
PyObject* k_authority = nullptr;
PyObject* k_round = nullptr;
PyObject* k_digest = nullptr;
PyObject* k_transaction = nullptr;
PyObject* k_locator = nullptr;
PyObject* k_accept = nullptr;
PyObject* k_conflict = nullptr;
PyObject* k_range = nullptr;
PyObject* k_block = nullptr;
PyObject* k_offset = nullptr;
PyObject* k_start = nullptr;
PyObject* k_end = nullptr;
// Fast construction verified safe for the registered classes?
bool g_fast = false;

// Build an instance of a plain (non-__slots__) frozen dataclass WITHOUT
// running its __init__: tp_new + direct instance-dict population.  The
// frozen __init__ costs ~1 µs/instance in object.__setattr__ calls — at
// ~10k statements per block that IS the decode cost.  decode_register
// self-verifies this path against a normal constructor call and falls back
// to PyObject_CallFunction when the classes change shape.  Steals vals
// references (also on failure).
PyObject* fast_instance(PyObject* cls, PyObject* const keys[],
                        PyObject* vals[], int n) {
  PyTypeObject* tp = reinterpret_cast<PyTypeObject*>(cls);
  PyObject* inst = tp->tp_new(tp, g_empty_tuple, nullptr);
  PyObject* dict =
      inst != nullptr ? PyObject_GenericGetDict(inst, nullptr) : nullptr;
  if (dict == nullptr) {
    Py_XDECREF(inst);
    for (int i = 0; i < n; i++) Py_XDECREF(vals[i]);
    return nullptr;
  }
  for (int i = 0; i < n; i++) {
    if (vals[i] == nullptr || PyDict_SetItem(dict, keys[i], vals[i]) < 0) {
      for (int j = i; j < n; j++) Py_XDECREF(vals[j]);
      Py_DECREF(dict);
      Py_DECREF(inst);
      return nullptr;
    }
    Py_DECREF(vals[i]);
  }
  Py_DECREF(dict);
  return inst;
}

constexpr Py_ssize_t kDigestSize = 32;
constexpr Py_ssize_t kSignatureSize = 64;
constexpr uint64_t kLocatorRangeMaxLen = 1ull << 20;
constexpr uint8_t kVoteAccept = 0;
constexpr uint8_t kVoteReject = 1;
constexpr uint8_t kStShare = 0;
constexpr uint8_t kStVote = 1;
constexpr uint8_t kStVoteRange = 2;

PyObject* make_block_ref(const uint8_t* p);  // fwd

PyObject* decode_register(PyObject*, PyObject* args) {
  PyObject *block_ref, *share, *vote, *vote_range, *locator, *locator_range;
  if (!PyArg_ParseTuple(args, "OOOOOO", &block_ref, &share, &vote,
                        &vote_range, &locator, &locator_range))
    return nullptr;
  Py_INCREF(block_ref);
  Py_INCREF(share);
  Py_INCREF(vote);
  Py_INCREF(vote_range);
  Py_INCREF(locator);
  Py_INCREF(locator_range);
  g_cls_block_ref = block_ref;
  g_cls_share = share;
  g_cls_vote = vote;
  g_cls_vote_range = vote_range;
  g_cls_locator = locator;
  g_cls_locator_range = locator_range;
  if (g_empty_tuple == nullptr) {
    g_empty_tuple = PyTuple_New(0);
    k_authority = PyUnicode_InternFromString("authority");
    k_round = PyUnicode_InternFromString("round");
    k_digest = PyUnicode_InternFromString("digest");
    k_transaction = PyUnicode_InternFromString("transaction");
    k_locator = PyUnicode_InternFromString("locator");
    k_accept = PyUnicode_InternFromString("accept");
    k_conflict = PyUnicode_InternFromString("conflict");
    k_range = PyUnicode_InternFromString("range");
    k_block = PyUnicode_InternFromString("block");
    k_offset = PyUnicode_InternFromString("offset");
    k_start = PyUnicode_InternFromString("offset_start_inclusive");
    k_end = PyUnicode_InternFromString("offset_end_exclusive");
  }
  // Self-verify the fast construction path: build one BlockReference both
  // ways and compare.  Any class-shape change (e.g. __slots__) flips the
  // decoder to plain constructor calls instead of miscreating objects.
  g_fast = true;
  uint8_t probe[48];
  std::memset(probe, 0, sizeof probe);
  probe[0] = 3;
  probe[8] = 7;
  PyObject* fast = make_block_ref(probe);
  PyObject* digest = fast != nullptr
      ? PyBytes_FromStringAndSize(reinterpret_cast<const char*>(probe + 16),
                                  kDigestSize)
      : nullptr;
  PyObject* slow = digest != nullptr
      ? PyObject_CallFunction(g_cls_block_ref, "iiN", 3, 7, digest)
      : nullptr;
  int eq = (fast != nullptr && slow != nullptr)
               ? PyObject_RichCompareBool(fast, slow, Py_EQ)
               : -1;
  Py_XDECREF(fast);
  Py_XDECREF(slow);
  if (eq != 1) {
    PyErr_Clear();
    g_fast = false;
  }
  Py_RETURN_NONE;
}

inline uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

PyObject* truncated(const char* what) {
  PyErr_Format(PyExc_ValueError, "truncated input: %s", what);
  return nullptr;
}

// Builds BlockReference(authority, round, digest) from 48 bytes.
PyObject* make_block_ref(const uint8_t* p) {
  PyObject* digest =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(p + 16),
                                kDigestSize);
  if (digest == nullptr) return nullptr;
  if (g_fast) {
    PyObject* const keys[] = {k_authority, k_round, k_digest};
    PyObject* vals[] = {PyLong_FromUnsignedLongLong(read_u64(p)),
                        PyLong_FromUnsignedLongLong(read_u64(p + 8)), digest};
    return fast_instance(g_cls_block_ref, keys, vals, 3);
  }
  return PyObject_CallFunction(
      g_cls_block_ref, "KKN", static_cast<unsigned long long>(read_u64(p)),
      static_cast<unsigned long long>(read_u64(p + 8)), digest);
}

// TransactionLocator(block=ref, offset) — steals ref.
PyObject* make_locator(PyObject* ref, uint64_t offset) {
  if (ref == nullptr) return nullptr;
  if (g_fast) {
    PyObject* const keys[] = {k_block, k_offset};
    PyObject* vals[] = {ref, PyLong_FromUnsignedLongLong(offset)};
    return fast_instance(g_cls_locator, keys, vals, 2);
  }
  return PyObject_CallFunction(g_cls_locator, "NK", ref,
                               static_cast<unsigned long long>(offset));
}

// decode_block(data)
//   -> (authority, round, includes, statements, meta_ns, epoch_marker,
//       epoch, signature, share_runs, stamps)
// share_runs: tuple of (start, end) half-open spans of contiguous Share
// statements (committee.shared_ranges precompute).
// stamps: bytes, 8 per Share statement — the payload's first 8 bytes, or
// zeros for sub-8-byte payloads (commit-observer latency input).
// Raises ValueError on any malformed input (same cases as the Python
// decoder; types.py maps it to SerdeError).
PyObject* decode_block(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  if (g_cls_block_ref == nullptr) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_RuntimeError, "decode_register was never called");
    return nullptr;
  }
  const uint8_t* d = static_cast<const uint8_t*>(buf.buf);
  const Py_ssize_t n = buf.len;
  Py_ssize_t pos = 0;
  PyObject* includes = nullptr;
  PyObject* statements = nullptr;
  PyObject* result = nullptr;

  auto fail = [&](const char* what) -> PyObject* {
    Py_XDECREF(includes);
    Py_XDECREF(statements);
    PyBuffer_Release(&buf);
    if (!PyErr_Occurred())
      PyErr_Format(PyExc_ValueError, "truncated input: %s", what);
    return nullptr;
  };

  if (n < 20) return fail("header");
  const uint64_t authority = read_u64(d);
  const uint64_t round = read_u64(d + 8);
  pos = 16;
  uint32_t cnt = read_u32(d + pos);
  pos += 4;
  // Counts are attacker-controlled: bound them by the bytes that could
  // possibly back them BEFORE allocating (a 24-byte frame claiming 2^32
  // includes must not preallocate a 34 GB list).
  if (static_cast<uint64_t>(cnt) * 48 > static_cast<uint64_t>(n - pos))
    return fail("include digest");
  includes = PyList_New(cnt);
  if (includes == nullptr) return fail("includes alloc");
  for (uint32_t i = 0; i < cnt; i++) {
    if (pos + 48 > n) return fail("include digest");
    PyObject* ref = make_block_ref(d + pos);
    if (ref == nullptr) return fail("include ref");
    PyList_SET_ITEM(includes, i, ref);
    pos += 48;
  }
  if (pos + 4 > n) return fail("statement count");
  cnt = read_u32(d + pos);
  pos += 4;
  // Every statement costs at least 1 byte (its tag).
  if (static_cast<uint64_t>(cnt) > static_cast<uint64_t>(n - pos))
    return fail("statement tag");
  statements = PyList_New(cnt);
  if (statements == nullptr) return fail("statements alloc");
  // Share run-length spans (committee.shared_ranges precompute): collected
  // for free while walking statements.
  std::vector<std::pair<uint32_t, uint32_t>> share_runs;
  // Benchmark submission stamps: first 8 bytes of every Share payload
  // (zero for sub-8-byte payloads) — the commit observer's latency input,
  // collected for free during the parse.
  std::string stamps;
  for (uint32_t i = 0; i < cnt; i++) {
    if (pos + 1 > n) return fail("statement tag");
    const uint8_t tag = d[pos];
    pos += 1;
    PyObject* st = nullptr;
    if (tag == kStShare) {
      if (!share_runs.empty() && share_runs.back().second == i) {
        share_runs.back().second = i + 1;
      } else {
        share_runs.emplace_back(i, i + 1);
      }
      if (pos + 4 > n) return fail("share length");
      const uint32_t ln = read_u32(d + pos);
      pos += 4;
      if (pos + static_cast<Py_ssize_t>(ln) > n) return fail("share payload");
      if (ln >= 8) {
        stamps.append(reinterpret_cast<const char*>(d + pos), 8);
      } else {
        stamps.append(8, '\0');
      }
      PyObject* payload = PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(d + pos), ln);
      if (payload == nullptr) return fail("share alloc");
      if (g_fast) {
        PyObject* const keys[] = {k_transaction};
        PyObject* vals[] = {payload};
        st = fast_instance(g_cls_share, keys, vals, 1);
      } else {
        st = PyObject_CallFunction(g_cls_share, "N", payload);
      }
      pos += ln;
    } else if (tag == kStVote) {
      if (pos + 57 > n) return fail("vote locator");
      PyObject* locator =
          make_locator(make_block_ref(d + pos), read_u64(d + pos + 48));
      pos += 56;
      if (locator == nullptr) return fail("vote locator obj");
      const uint8_t vote_byte = d[pos];
      pos += 1;
      if (vote_byte != kVoteAccept && vote_byte != kVoteReject) {
        Py_DECREF(locator);
        PyErr_Format(PyExc_ValueError, "invalid vote byte %d", vote_byte);
        return fail("vote byte");
      }
      PyObject* conflict = Py_None;
      Py_INCREF(conflict);
      if (vote_byte == kVoteReject) {
        if (pos + 1 > n) {
          Py_DECREF(locator);
          Py_DECREF(conflict);
          return fail("conflict presence");
        }
        const uint8_t presence = d[pos];
        pos += 1;
        if (presence != 0 && presence != 1) {
          Py_DECREF(locator);
          Py_DECREF(conflict);
          PyErr_Format(PyExc_ValueError,
                       "invalid conflict-presence byte %d", presence);
          return fail("conflict presence byte");
        }
        if (presence == 1) {
          if (pos + 56 > n) {
            Py_DECREF(locator);
            Py_DECREF(conflict);
            return fail("conflict");
          }
          Py_DECREF(conflict);
          conflict =
              make_locator(make_block_ref(d + pos), read_u64(d + pos + 48));
          pos += 56;
          if (conflict == nullptr) {
            Py_DECREF(locator);
            return fail("conflict obj");
          }
        }
      }
      if (g_fast) {
        PyObject* accept = vote_byte == kVoteAccept ? Py_True : Py_False;
        Py_INCREF(accept);
        PyObject* const keys[] = {k_locator, k_accept, k_conflict};
        PyObject* vals[] = {locator, accept, conflict};
        st = fast_instance(g_cls_vote, keys, vals, 3);
      } else {
        st = PyObject_CallFunction(
            g_cls_vote, "NON", locator,
            vote_byte == kVoteAccept ? Py_True : Py_False, conflict);
      }
    } else if (tag == kStVoteRange) {
      if (pos + 64 > n) return fail("range digest");
      const uint64_t start = read_u64(d + pos + 48);
      const uint64_t end = read_u64(d + pos + 56);
      if (end < start) {
        PyErr_Format(PyExc_ValueError,
                     "invalid locator range: end %llu < start %llu",
                     static_cast<unsigned long long>(end),
                     static_cast<unsigned long long>(start));
        return fail("range order");
      }
      if (end - start > kLocatorRangeMaxLen || end > kLocatorRangeMaxLen) {
        PyErr_Format(PyExc_ValueError, "locator range too long/large: %llu",
                     static_cast<unsigned long long>(end));
        return fail("range bound");
      }
      PyObject* ref = make_block_ref(d + pos);
      if (ref == nullptr) return fail("range ref");
      PyObject* rng;
      if (g_fast) {
        PyObject* const rkeys[] = {k_block, k_start, k_end};
        PyObject* rvals[] = {ref, PyLong_FromUnsignedLongLong(start),
                             PyLong_FromUnsignedLongLong(end)};
        rng = fast_instance(g_cls_locator_range, rkeys, rvals, 3);
      } else {
        rng = PyObject_CallFunction(
            g_cls_locator_range, "NKK", ref,
            static_cast<unsigned long long>(start),
            static_cast<unsigned long long>(end));
      }
      pos += 64;
      if (rng == nullptr) return fail("range obj");
      if (g_fast) {
        PyObject* const keys[] = {k_range};
        PyObject* vals[] = {rng};
        st = fast_instance(g_cls_vote_range, keys, vals, 1);
      } else {
        st = PyObject_CallFunction(g_cls_vote_range, "N", rng);
      }
    } else {
      PyErr_Format(PyExc_ValueError, "unknown statement tag %d", tag);
      return fail("tag");
    }
    if (st == nullptr) return fail("statement obj");
    PyList_SET_ITEM(statements, i, st);
  }
  if (pos + 8 + 1 + 8 + kSignatureSize > n) return fail("trailer");
  const uint64_t meta_ns = read_u64(d + pos);
  pos += 8;
  const uint8_t epoch_marker = d[pos];
  pos += 1;
  const uint64_t epoch = read_u64(d + pos);
  pos += 8;
  PyObject* signature = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(d + pos), kSignatureSize);
  pos += kSignatureSize;
  if (signature == nullptr) return fail("signature alloc");
  if (pos != n) {
    Py_DECREF(signature);
    PyErr_Format(PyExc_ValueError, "trailing garbage: %zd bytes", n - pos);
    return fail("trailer garbage");
  }
  PyObject* runs = PyTuple_New(static_cast<Py_ssize_t>(share_runs.size()));
  if (runs == nullptr) {
    Py_DECREF(signature);
    return fail("runs alloc");
  }
  for (size_t i = 0; i < share_runs.size(); i++) {
    PyObject* pair = Py_BuildValue("(II)", share_runs[i].first,
                                   share_runs[i].second);
    if (pair == nullptr) {
      Py_DECREF(runs);
      Py_DECREF(signature);
      return fail("runs pair");
    }
    PyTuple_SET_ITEM(runs, static_cast<Py_ssize_t>(i), pair);
  }
  PyObject* stamp_bytes = PyBytes_FromStringAndSize(
      stamps.data(), static_cast<Py_ssize_t>(stamps.size()));
  if (stamp_bytes == nullptr) {
    Py_DECREF(runs);
    Py_DECREF(signature);
    return fail("stamps alloc");
  }
  result = Py_BuildValue(
      "(KKNNKBKNNN)", static_cast<unsigned long long>(authority),
      static_cast<unsigned long long>(round), includes, statements,
      static_cast<unsigned long long>(meta_ns), epoch_marker,
      static_cast<unsigned long long>(epoch), signature, runs, stamp_bytes);
  if (result == nullptr) {
    // includes/statements ownership consumed on success only.
    PyBuffer_Release(&buf);
    return nullptr;
  }
  PyBuffer_Release(&buf);
  return result;
}

// ---------------------------------------------------------------------------
// BLAKE2b-256 (RFC 7693) — embedded so the batched digest path links against
// nothing beyond zlib (the build contract of native/__init__.py).  Unkeyed,
// no salt/personal, 32-byte output: exactly
// ``hashlib.blake2b(data, digest_size=32)``, pinned byte-for-byte by the
// parity corpus test against crypto.blake2b_256.
// ---------------------------------------------------------------------------

namespace blake2b {

constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

struct Ctx {
  uint64_t h[8];
  uint64_t t0, t1;
  uint8_t buf[128];
  size_t buflen;
};

inline void compress(Ctx& c, const uint8_t* block, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; i++) std::memcpy(&m[i], block + 8 * i, 8);
  for (int i = 0; i < 8; i++) v[i] = c.h[i];
  for (int i = 0; i < 8; i++) v[i + 8] = kIV[i];
  v[12] ^= c.t0;
  v[13] ^= c.t1;
  if (last) v[14] = ~v[14];
#define B2B_G(a, b, cc, d, x, y)              \
  v[a] = v[a] + v[b] + (x);                   \
  v[d] = rotr64(v[d] ^ v[a], 32);             \
  v[cc] = v[cc] + v[d];                       \
  v[b] = rotr64(v[b] ^ v[cc], 24);            \
  v[a] = v[a] + v[b] + (y);                   \
  v[d] = rotr64(v[d] ^ v[a], 16);             \
  v[cc] = v[cc] + v[d];                       \
  v[b] = rotr64(v[b] ^ v[cc], 63);
// Rounds unrolled with literal indices: kSigma is constexpr, so every
// m[kSigma[r][i]] folds to a direct load — the loop-carried indirect
// indexing was the compress bottleneck under -O2/-O3.
#define B2B_ROUND(r)                                      \
  B2B_G(0, 4, 8, 12, m[kSigma[r][0]], m[kSigma[r][1]]);   \
  B2B_G(1, 5, 9, 13, m[kSigma[r][2]], m[kSigma[r][3]]);   \
  B2B_G(2, 6, 10, 14, m[kSigma[r][4]], m[kSigma[r][5]]);  \
  B2B_G(3, 7, 11, 15, m[kSigma[r][6]], m[kSigma[r][7]]);  \
  B2B_G(0, 5, 10, 15, m[kSigma[r][8]], m[kSigma[r][9]]);  \
  B2B_G(1, 6, 11, 12, m[kSigma[r][10]], m[kSigma[r][11]]); \
  B2B_G(2, 7, 8, 13, m[kSigma[r][12]], m[kSigma[r][13]]);  \
  B2B_G(3, 4, 9, 14, m[kSigma[r][14]], m[kSigma[r][15]]);
  B2B_ROUND(0); B2B_ROUND(1); B2B_ROUND(2); B2B_ROUND(3);
  B2B_ROUND(4); B2B_ROUND(5); B2B_ROUND(6); B2B_ROUND(7);
  B2B_ROUND(8); B2B_ROUND(9); B2B_ROUND(10); B2B_ROUND(11);
#undef B2B_ROUND
#undef B2B_G
  for (int i = 0; i < 8; i++) c.h[i] ^= v[i] ^ v[i + 8];
}

inline void init256(Ctx& c) {
  for (int i = 0; i < 8; i++) c.h[i] = kIV[i];
  c.h[0] ^= 0x01010000ULL ^ 32ULL;  // digest_size=32, no key, fanout/depth 1
  c.t0 = c.t1 = 0;
  c.buflen = 0;
}

inline void update(Ctx& c, const uint8_t* in, size_t len) {
  while (len > 0) {
    if (c.buflen == 128) {
      // The buffer only compresses once MORE input is known to follow —
      // the final block must flow through the last-block flag instead.
      c.t0 += 128;
      if (c.t0 < 128) c.t1++;
      compress(c, c.buf, false);
      c.buflen = 0;
    }
    size_t take = std::min(len, 128 - c.buflen);
    std::memcpy(c.buf + c.buflen, in, take);
    c.buflen += take;
    in += take;
    len -= take;
  }
}

inline void final256(Ctx& c, uint8_t out[32]) {
  c.t0 += c.buflen;
  if (c.t0 < c.buflen) c.t1++;
  std::memset(c.buf + c.buflen, 0, 128 - c.buflen);
  compress(c, c.buf, true);
  for (int i = 0; i < 32; i++)
    out[i] = static_cast<uint8_t>(c.h[i / 8] >> (8 * (i % 8)));
}

inline void hash256(const uint8_t* in, size_t len, uint8_t out[32]) {
  Ctx c;
  init256(c);
  update(c, in, len);
  final256(c, out);
}

// Both StatementBlock digests in ~one pass: the block digest covers the
// full bytes, the signature pre-hash covers the bytes minus the 64-byte
// trailer — the two streams are IDENTICAL up to the pre-hash message's
// final partial block, so hash the shared prefix once and fork the state.
// Cuts the hashing work per block from len + (len-64) to ~len + 128.
inline void hash256_pair(const uint8_t* in, size_t len, uint8_t full_out[32],
                         uint8_t signed_out[32]) {
  const size_t sig = static_cast<size_t>(kSignatureSize);
  if (len < sig) {
    hash256(in, len, full_out);
    hash256(in, 0, signed_out);  // Python's data[:-64] on short input: b""
    return;
  }
  const size_t msg_len = len - sig;
  // All full 128-byte blocks strictly before the pre-hash's final block;
  // `update` keeps a full buffered block uncompressed until more input
  // arrives, so the forked copies continue bit-identically to streaming.
  const size_t prefix = msg_len == 0 ? 0 : ((msg_len - 1) / 128) * 128;
  Ctx c;
  init256(c);
  update(c, in, prefix);
  Ctx cs = c;
  update(cs, in + prefix, msg_len - prefix);
  final256(cs, signed_out);
  update(c, in + prefix, len - prefix);
  final256(c, full_out);
}

}  // namespace blake2b

// A frame's hashing fans out over several threads only when each gets at
// least kDigestBytesPerThread, so a frame under 2 MiB keeps the serial loop.
// While the calling thread hashes, the GIL is free for the process's other
// threads; a fanned call takes it back sooner.  The rule sees only the
// frame's bytes, not whether those threads wait on the GIL, so the constant
// is a floor on each thread's share, set between points measured on an
// 8-core H100 host: 16-MB frames of 1-MB blocks gained ~50%; 50-validator
// catch-ups, their dispatch bound by the GIL, lost ~15% at 0.47 MB a thread
// (1.9-MB frames on 4 threads), showed no loss beyond their runs' spread at
// 1.15-1.2 MB a thread (2.3- and 3.6-MB frames on 2 and 3 threads) and
// gained ~12% at 1.75 MB a thread (7-MB frames on 4).
// kDigestMaxThreads caps the fan-out, which also takes at most half the
// CPUs the process may run on, leaving the rest to the event loop, the
// dispatch threads and CUDA's own threads.
constexpr size_t kDigestBytesPerThread = 1024 * 1024;
constexpr int kDigestMaxThreads = 4;

// Frames hashed, by the number of threads that hashed them (index 1..max);
// process-wide, read by _digest_frame_counts().
std::atomic<unsigned long long> g_digest_frames[kDigestMaxThreads + 1];

using Part = std::pair<const uint8_t*, size_t>;

void hash_parts(const Part* parts, size_t count, uint8_t* out) {
  for (size_t i = 0; i < count; ++i, out += 64)
    blake2b::hash256_pair(parts[i].first, parts[i].second, out, out + 32);
}

// k = min(cap, total_bytes / kDigestBytesPerThread, n_blocks), at least 1,
// where cap is half the CPUs in the process's affinity mask, at most
// kDigestMaxThreads.
int digest_threads(size_t total_bytes, size_t n_blocks) {
  const size_t by_size =
      std::min(total_bytes / kDigestBytesPerThread, n_blocks);
  if (by_size < 2) return 1;
  cpu_set_t mask;
  const int cpus =
      sched_getaffinity(0, sizeof(mask), &mask) == 0 ? CPU_COUNT(&mask) : 1;
  const int cap = std::clamp(cpus / 2, 1, kDigestMaxThreads);
  return static_cast<int>(std::min(by_size, static_cast<size_t>(cap)));
}

// Hashes every part into its own 64-byte slot of `out` on up to k threads,
// the calling one included: contiguous ranges of parts split by bytes.
// Every thread is joined before the return.  Returns the number of threads
// that hashed a range (1 for k = 1: the serial loop).
int hash_frame(const std::vector<Part>& parts, size_t total_bytes, int k,
               uint8_t* out) {
  std::vector<size_t> bounds{0};
  size_t acc = 0, i = 0;
  for (int j = 1; j < k; ++j) {
    const size_t target = total_bytes / k * j;
    // A part joins the range its midpoint falls in.
    while (i < parts.size() && acc + parts[i].second / 2 < target)
      acc += parts[i++].second;
    if (i > bounds.back()) bounds.push_back(i);
  }
  if (parts.size() > bounds.back()) bounds.push_back(parts.size());
  std::vector<std::thread> workers;
  workers.reserve(bounds.size());
  for (size_t r = 1; r + 1 < bounds.size(); ++r) {
    const Part* first = parts.data() + bounds[r];
    const size_t count = bounds[r + 1] - bounds[r];
    uint8_t* slots = out + bounds[r] * 64;
    try {
      workers.emplace_back(hash_parts, first, count, slots);
    } catch (const std::system_error&) {
      hash_parts(first, count, slots);  // no thread to be had: hash here
    }
  }
  hash_parts(parts.data(), bounds.size() > 1 ? bounds[1] : 0, out);
  for (std::thread& t : workers) t.join();
  return 1 + static_cast<int>(workers.size());
}

// block_digests(parts) -> [(digest32, signed_digest32)...]
//
// Batched StatementBlock digest path (types.py): for each serialized block,
// the canonical blake2b-256 over the full bytes (the reference digest) AND
// over the bytes minus the 64-byte signature trailer (the message Ed25519
// signs — crypto.rs:77-84 layering).  One GIL round-trip hashes the whole
// frame batch; the hashing itself runs with the GIL released, so the event
// loop keeps scheduling while the offload thread grinds.  A large frame's
// blocks are hashed on several threads (digest_threads), each into its own
// slots, all joined before the GIL is taken back; the output is the same
// either way.  Sub-64-byte parts hash an EMPTY trimmed message, matching
// Python's ``data[:-64]`` slice semantics (such parts fail decode anyway;
// the slice parity keeps this function order-independent from the decode
// step).
PyObject* block_digests(PyObject*, PyObject* args) {
  PyObject* parts;
  if (!PyArg_ParseTuple(args, "O", &parts)) return nullptr;
  PyObject* seq = PySequence_Fast(parts, "parts must be a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<Py_buffer> views(static_cast<size_t>(n));
  std::vector<Part> spans(static_cast<size_t>(n));
  size_t total = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* part = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(part, &views[i], PyBUF_SIMPLE) < 0) {
      for (Py_ssize_t j = 0; j < i; ++j) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      return nullptr;
    }
    spans[i] = {static_cast<const uint8_t*>(views[i].buf),
                static_cast<size_t>(views[i].len)};
    total += spans[i].second;
  }
  std::vector<uint8_t> digests(static_cast<size_t>(n) * 64);
  int threads;
  Py_BEGIN_ALLOW_THREADS
  threads = hash_frame(spans, total, digest_threads(total, spans.size()),
                       digests.data());
  Py_END_ALLOW_THREADS
  if (n > 0) g_digest_frames[threads].fetch_add(1, std::memory_order_relaxed);
  for (Py_ssize_t i = 0; i < n; ++i) PyBuffer_Release(&views[i]);
  Py_DECREF(seq);
  PyObject* out = PyList_New(n);
  if (out == nullptr) return nullptr;
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* d = reinterpret_cast<const char*>(digests.data() +
                                                  static_cast<size_t>(i) * 64);
    PyObject* pair = Py_BuildValue("(y#y#)", d, (Py_ssize_t)32, d + 32,
                                   (Py_ssize_t)32);
    if (pair == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, pair);
  }
  return out;
}

// _digest_frame_counts() -> {threads: frames}
//
// The frames block_digests hashed in this process, by the number of threads
// that hashed them (1 = the serial loop); thread counts never used are left
// out.  An empty call is no frame.
PyObject* digest_frame_counts(PyObject*, PyObject*) {
  PyObject* out = PyDict_New();
  if (out == nullptr) return nullptr;
  for (int threads = 1; threads <= kDigestMaxThreads; ++threads) {
    const unsigned long long frames =
        g_digest_frames[threads].load(std::memory_order_relaxed);
    if (frames == 0) continue;
    PyObject* key = PyLong_FromLong(threads);
    PyObject* value = PyLong_FromUnsignedLongLong(frames);
    if (key == nullptr || value == nullptr ||
        PyDict_SetItem(out, key, value) < 0) {
      Py_XDECREF(key);
      Py_XDECREF(value);
      Py_DECREF(out);
      return nullptr;
    }
    Py_DECREF(key);
    Py_DECREF(value);
  }
  return out;
}

// encode_blocks_frame(tag, stamped, mono_ns, wall_ns, parts) -> bytes
//
// Whole-frame payload for the Blocks-shaped wire messages (tags 2/4/12):
// tag u8 [+ u64 sender-monotonic + u64 sender-wall when stamped] + u32
// count + per block u32 length + raw bytes — byte-identical to
// network.encode_message's Writer path (golden corpus pins it).  One call
// replaces the per-block Writer append loop the FrameCache paid per
// encode-once build; the copy runs with the GIL released.
PyObject* encode_blocks_frame(PyObject*, PyObject* args) {
  unsigned int tag;
  int stamped;
  unsigned long long mono_ns, wall_ns;
  PyObject* parts;
  if (!PyArg_ParseTuple(args, "IpKKO", &tag, &stamped, &mono_ns, &wall_ns,
                        &parts))
    return nullptr;
  PyObject* seq = PySequence_Fast(parts, "blocks must be a sequence");
  if (seq == nullptr) return nullptr;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  std::vector<Py_buffer> views(static_cast<size_t>(n));
  Py_ssize_t total = 1 + (stamped ? 16 : 0) + 4;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* part = PySequence_Fast_GET_ITEM(seq, i);
    if (PyObject_GetBuffer(part, &views[i], PyBUF_SIMPLE) < 0) {
      for (Py_ssize_t j = 0; j < i; ++j) PyBuffer_Release(&views[j]);
      Py_DECREF(seq);
      return nullptr;
    }
    total += 4 + views[i].len;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, total);
  if (out == nullptr) {
    for (Py_ssize_t i = 0; i < n; ++i) PyBuffer_Release(&views[i]);
    Py_DECREF(seq);
    return nullptr;
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  Py_BEGIN_ALLOW_THREADS
  uint8_t* p = dst;
  *p++ = static_cast<uint8_t>(tag);
  if (stamped) {
    std::memcpy(p, &mono_ns, 8);
    std::memcpy(p + 8, &wall_ns, 8);
    p += 16;
  }
  uint32_t count = static_cast<uint32_t>(n);
  std::memcpy(p, &count, 4);
  p += 4;
  for (Py_ssize_t i = 0; i < n; ++i) {
    uint32_t len = static_cast<uint32_t>(views[i].len);
    std::memcpy(p, &len, 4);
    std::memcpy(p + 4, views[i].buf, views[i].len);
    p += 4 + views[i].len;
  }
  Py_END_ALLOW_THREADS
  for (Py_ssize_t i = 0; i < n; ++i) PyBuffer_Release(&views[i]);
  Py_DECREF(seq);
  return out;
}

// split_frames(buffer, start, have, max_frame)
//   -> ([(payload_off, payload_len)...], new_start, oversized_len)
//
// The _FrameReceiver assembly-buffer walk (network.py:_parse): split
// [start, have) into complete 4-byte-length-prefixed frames.  Returns the
// payload spans (the caller wraps them as memoryviews — the last step that
// must touch Python objects), the new parse cursor, and the offending
// length when a prefix exceeds ``max_frame`` (0 = none; the caller severs
// exactly as the pure path does).
PyObject* split_frames(PyObject*, PyObject* args) {
  Py_buffer buf;
  unsigned long long start_arg, have_arg, max_frame;
  if (!PyArg_ParseTuple(args, "y*KKK", &buf, &start_arg, &have_arg,
                        &max_frame))
    return nullptr;
  const uint8_t* data = static_cast<const uint8_t*>(buf.buf);
  Py_ssize_t start = static_cast<Py_ssize_t>(start_arg);
  Py_ssize_t have = static_cast<Py_ssize_t>(have_arg);
  if (have > buf.len) have = buf.len;
  std::vector<std::pair<Py_ssize_t, Py_ssize_t>> spans;
  unsigned long long oversized = 0;
  Py_BEGIN_ALLOW_THREADS
  while (have - start >= 4) {
    uint32_t length = read_u32(data + start);
    if (static_cast<unsigned long long>(length) > max_frame) {
      oversized = length;
      break;
    }
    Py_ssize_t end = start + 4 + static_cast<Py_ssize_t>(length);
    if (end > have) break;
    spans.emplace_back(start + 4, static_cast<Py_ssize_t>(length));
    start = end;
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&buf);
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(spans.size()));
  if (out == nullptr) return nullptr;
  for (size_t i = 0; i < spans.size(); ++i) {
    PyObject* pair =
        Py_BuildValue("(nn)", spans[i].first, spans[i].second);
    if (pair == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), pair);
  }
  return Py_BuildValue("(NnK)", out, start, oversized);
}

// parse_blocks_spans(payload) -> (tag, mono_ns, wall_ns, [(off, len)...])
//
// Native sibling of decode_message's Blocks-shaped branches (tags 2/4/12):
// validates the whole payload body and returns per-block (offset, length)
// spans — the caller builds zero-copy sub-views, deferring Python object
// creation to the last step.  Rejection cases and MESSAGES are
// byte-identical to serde.Reader's ("truncated input: need N bytes at P,
// have H", "trailing garbage: N bytes"), so torn-frame error shapes stay
// indistinguishable across the native/fallback paths (parity corpus).
PyObject* parse_blocks_spans(PyObject*, PyObject* args) {
  Py_buffer buf;
  if (!PyArg_ParseTuple(args, "y*", &buf)) return nullptr;
  const uint8_t* d = static_cast<const uint8_t*>(buf.buf);
  const Py_ssize_t n = buf.len;
  Py_ssize_t pos = 0;
  auto fail_need = [&](Py_ssize_t need) -> PyObject* {
    PyErr_Format(PyExc_ValueError,
                 "truncated input: need %zd bytes at %zd, have %zd", need,
                 pos, n);
    PyBuffer_Release(&buf);
    return nullptr;
  };
  if (n < 1) return fail_need(1);
  const uint8_t tag = d[0];
  pos = 1;
  unsigned long long mono = 0, wall = 0;
  if (tag == 12) {  // _MSG_BLOCKS_TIMESTAMPED: two u64 sender stamps first
    if (pos + 8 > n) return fail_need(8);
    mono = read_u64(d + pos);
    pos += 8;
    if (pos + 8 > n) return fail_need(8);
    wall = read_u64(d + pos);
    pos += 8;
  } else if (tag != 2 && tag != 4) {  // _MSG_BLOCKS / _MSG_RESPONSE
    PyErr_Format(PyExc_ValueError, "not a blocks-shaped frame: tag %d", tag);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  if (pos + 4 > n) return fail_need(4);
  const uint32_t count = read_u32(d + pos);
  pos += 4;
  std::vector<std::pair<Py_ssize_t, Py_ssize_t>> spans;
  for (uint32_t i = 0; i < count; ++i) {
    if (pos + 4 > n) return fail_need(4);
    const uint32_t len = read_u32(d + pos);
    pos += 4;
    if (pos + static_cast<Py_ssize_t>(len) > n)
      return fail_need(static_cast<Py_ssize_t>(len));
    spans.emplace_back(pos, static_cast<Py_ssize_t>(len));
    pos += static_cast<Py_ssize_t>(len);
  }
  if (pos != n) {
    PyErr_Format(PyExc_ValueError, "trailing garbage: %zd bytes", n - pos);
    PyBuffer_Release(&buf);
    return nullptr;
  }
  PyBuffer_Release(&buf);
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(spans.size()));
  if (out == nullptr) return nullptr;
  for (size_t i = 0; i < spans.size(); ++i) {
    PyObject* pair = Py_BuildValue("(nn)", spans[i].first, spans[i].second);
    if (pair == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), pair);
  }
  return Py_BuildValue("(BKKN)", tag, mono, wall, out);
}

PyMethodDef kMethods[] = {
    {"decode_register", decode_register, METH_VARARGS,
     "Register the Python statement/reference classes for decode_block."},
    {"decode_block", decode_block, METH_VARARGS,
     "Decode a StatementBlock wire frame into its component tuple."},
    {"wal_scan", wal_scan, METH_VARARGS,
     "Scan crc-framed WAL entries; returns (pos, tag, off, len) tuples."},
    {"frame_entry", frame_entry, METH_VARARGS,
     "Assemble one framed WAL entry (header + parts) with single-pass crc."},
    {"va_new", va_new, METH_VARARGS, "New vote-aggregator core."},
    {"va_bind", va_bind, METH_VARARGS, "Bind committee stakes + threshold."},
    {"va_register", va_register, METH_VARARGS,
     "Register a shared range with the author's self-vote."},
    {"va_vote", va_vote, METH_VARARGS,
     "Tally a vote range; returns (certified ranges, violation offset)."},
    {"va_is_processed", va_is_processed, METH_VARARGS,
     "Was this (block, offset) certified?"},
    {"va_pending_len", va_pending_len, METH_VARARGS,
     "Number of blocks with pending aggregations."},
    {"va_items", va_items, METH_VARARGS, "Snapshot pending ranges."},
    {"va_state", va_state, METH_VARARGS,
     "Canonical state snapshot bytes (committee.py state() layout)."},
    {"va_load", va_load, METH_VARARGS, "Restore one pending range."},
    {"block_digests", block_digests, METH_VARARGS,
     "Batched blake2b-256 (digest, signed-prehash) pairs over N blocks."},
    {"_digest_frame_counts", digest_frame_counts, METH_NOARGS,
     "Frames block_digests hashed, by the number of threads that hashed them."},
    {"encode_blocks_frame", encode_blocks_frame, METH_VARARGS,
     "Serialize a whole Blocks-shaped frame payload in one call."},
    {"split_frames", split_frames, METH_VARARGS,
     "Split a length-prefixed assembly buffer into payload spans."},
    {"parse_blocks_spans", parse_blocks_spans, METH_VARARGS,
     "Validate a Blocks-shaped payload; returns per-block (off, len) spans."},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native runtime helpers (WAL framing/scan, decode, data plane).", -1,
    kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&kModule); }
