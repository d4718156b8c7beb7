// Native host compiler for phfpfac_tpu: PFAC trie construction and
// FFDM perfect-hash packing.
//
// Semantics contracts (must match the NumPy reference implementations
// in compile/trie.py and compile/phf.py, which in turn replicate
// CreateTable/create_table_reorder.c:277-378 and PHF/phf.c:151-291 of
// the reference):
//
//   * trie: patterns arrive sorted; final state for pattern i is i
//     (duplicates overwrite), initial state = k+1, interiors from k+2
//     in insertion order; dense int32 table [state][256], -1 = dead.
//   * FFDM: keys = state*256+ch for live transitions; rows of `width`;
//     rows processed in descending fullness, ties by ascending row
//     number; first-fit displacement from -min_col; r[row]=offset,
//     HT[slot]=row, val[slot]=next; HTSize = last occupied slot + 1.
//
// The C ABI below is allocation-free: Python (ctypes) allocates
// upper-bound buffers, C++ fills them and returns sizes.  Exact-parity
// tests in tests/test_native.py diff every table against the NumPy
// path.

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {
constexpr int kCharSet = 256;
}

extern "C" {

// Build the failureless-AC dense table for one shard.
//
//   blob/offsets: concatenated pattern bytes; pattern i occupies
//                 blob[offsets[i], offsets[i+1]).  Patterns must be
//                 pre-sorted (memcmp order, shorter-first ties).
//   table:        caller buffer [cap_states * 256] int32, pre-filled -1.
//   cap_states:   must be >= k + 2 + total_pattern_bytes.
//   max_pat_len:  out param.
//
// Returns state_count, or -1 on capacity overflow.
int64_t pfac_build_trie(const uint8_t* blob, const int64_t* offsets,
                        int64_t n_patterns, int32_t* table,
                        int64_t cap_states, int32_t* max_pat_len) {
  const int64_t initial_state = n_patterns + 1;
  int64_t state_count = initial_state + 1;
  int32_t maxlen = 0;
  if (state_count > cap_states) return -1;

  for (int64_t i = 0; i < n_patterns; ++i) {
    const int64_t lo = offsets[i], hi = offsets[i + 1];
    const int64_t len = hi - lo;
    if (len <= 0) return -2;  // empty patterns unsupported
    if (len > maxlen) maxlen = static_cast<int32_t>(len);
    int64_t state = initial_state;
    for (int64_t j = lo; j < hi - 1; ++j) {
      const int c = blob[j];
      int32_t nxt = table[state * kCharSet + c];
      if (nxt == -1) {
        if (state_count >= cap_states) return -1;
        table[state * kCharSet + c] = static_cast<int32_t>(state_count);
        state = state_count++;
      } else {
        state = nxt;
      }
    }
    table[state * kCharSet + blob[hi - 1]] = static_cast<int32_t>(i);
  }
  *max_pat_len = maxlen;
  return state_count;
}

// FFDM perfect-hash packing of a dense table.
//
//   table:     int32 [state_num * 256], -1 = dead.
//   width:     power of two.
//   r:         caller buffer [(state_num*256)/width + 1] int32; filled
//              with displacements (-1 for empty rows).
//   ht, val:   caller buffers [ht_cap] int32 (pre-filled -1).
//   stats:     out int64[4] = {num_keys, max_key, max_offset, ht_size}.
//
// Returns ht_size, or -1 when a row cannot be placed within ht_cap
// (caller should raise "try increasing the hash table size").
int64_t pfac_ffdm(const int32_t* table, int64_t state_num, int64_t width,
                  int32_t* r, int64_t r_len, int32_t* ht, int32_t* val,
                  int64_t ht_cap, int64_t* stats) {
  const int64_t n_keys_space = state_num * kCharSet;
  // collect keys per row; rows are contiguous since keys ascend
  struct Row {
    int32_t number;
    std::vector<int32_t> cols;
    std::vector<int32_t> vals;
  };
  std::vector<Row> rows;
  int64_t num_keys = 0, max_key = 0;
  int64_t cur_row = -1;
  for (int64_t key = 0; key < n_keys_space; ++key) {
    const int32_t v = table[key];
    if (v < 0) continue;
    const int64_t rowno = key / width;
    if (rowno != cur_row) {
      rows.push_back(Row{static_cast<int32_t>(rowno), {}, {}});
      cur_row = rowno;
    }
    rows.back().cols.push_back(static_cast<int32_t>(key % width));
    rows.back().vals.push_back(v);
    ++num_keys;
    max_key = key;
  }
  std::fill(r, r + r_len, -1);

  // descending fullness, ties by ascending row number (stable)
  std::vector<int32_t> order(rows.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return rows[a].cols.size() > rows[b].cols.size();
  });

  // occupancy bitset over ht slots
  std::vector<uint64_t> occ((ht_cap + 63) / 64 + 1, 0);
  auto occupied = [&](int64_t s) {
    return (occ[s >> 6] >> (s & 63)) & 1u;
  };
  auto occupy = [&](int64_t s) { occ[s >> 6] |= (uint64_t{1} << (s & 63)); };
  // first slot >= s that is free (word-scan)
  auto next_free = [&](int64_t s) {
    int64_t w = s >> 6;
    uint64_t m = ~occ[w] & (~uint64_t{0} << (s & 63));
    while (m == 0) m = ~occ[++w];
    return (w << 6) + static_cast<int64_t>(__builtin_ctzll(m));
  };

  // Two EXACT accelerations of the reference's first-fit scan
  // (phf.c:184-222 tries every offset from -cols[0] upward):
  //  * first_free: slots below it are all occupied, so offsets with
  //    offset+cols[0] < first_free are provably blocked — the long
  //    tail of 1-col rows lands at the first hole instead of
  //    rescanning the table front (this removes the quadratic term);
  //  * run jump: when column c is blocked at slot offset+c, every
  //    offset until that occupied run ends is blocked at c too, so
  //    jump straight past it.
  int64_t max_offset = 0, max_slot = -1;
  const int64_t max_off_excl = ht_cap - width;
  int64_t first_free = 0;
  for (int32_t oi : order) {
    const Row& row = rows[oi];
    while (first_free < ht_cap && occupied(first_free)) ++first_free;
    const int64_t base = -static_cast<int64_t>(row.cols[0]);
    int64_t offset = std::max(base, first_free - row.cols[0]);
    while (offset < max_off_excl) {
      bool ok = true;
      for (int32_t c : row.cols) {
        const int64_t s = offset + c;
        if (occupied(s)) {
          offset = next_free(s) - c;
          ok = false;
          break;
        }
      }
      if (ok) break;
    }
    if (offset >= max_off_excl) return -1;
    r[row.number] = static_cast<int32_t>(offset);
    for (size_t i = 0; i < row.cols.size(); ++i) {
      const int64_t slot = offset + row.cols[i];
      occupy(slot);
      ht[slot] = row.number;
      val[slot] = row.vals[i];
      if (slot > max_slot) max_slot = slot;
    }
    if (offset > max_offset) max_offset = offset;
  }

  const int64_t ht_size = max_slot + 1;
  stats[0] = num_keys;
  stats[1] = max_key;
  stats[2] = max_offset;
  stats[3] = ht_size;
  return ht_size;
}

// Level-wise suffix minimization of a leveled automaton
// (compile/depth.py::_minimize_levels).  Deepest level first, each
// level-state's signature is (finality, 256 child CLASS ids); equal
// signatures merge.  Class ids are assigned in order of first
// occurrence within the level (a DIFFERENT numbering than the NumPy
// path's lexicographic np.unique order — semantically equivalent
// partitions; tests check partition equality, not id equality).
//
//   dense:       int32 [state_num * 256], -1 = dead.
//   levels_blob: int64 concatenated per-level state lists,
//                level li = levels_blob[level_offs[li], level_offs[li+1]).
//   nf:          states < nf are final.
//   inv_blob:    out int32, aligned with levels_blob — class id of each
//                level-state within its level.
//   rep_blob:    out int32, aligned with levels_blob — for class k of
//                level li, rep_blob[level_offs[li] + k] = index into the
//                LEVEL's state list of the class representative (its
//                first occurrence); entries past n_classes[li] unused.
//   n_classes:   out int64 [D].
//
// Returns 0.
int64_t pfac_minimize_levels(const int32_t* dense, int64_t state_num,
                             const int64_t* levels_blob,
                             const int64_t* level_offs, int64_t D,
                             int64_t nf, int32_t* inv_blob,
                             int32_t* rep_blob, int64_t* n_classes) {
  // class_arr[s] = s's class at the level just below the one being
  // processed (valid for children, which live one level down)
  std::vector<int32_t> class_arr(state_num, -1);
  std::vector<int32_t> pending_states;  // this level's states (update
  std::vector<int32_t> pending_inv;     // class_arr AFTER signatures)
  for (int64_t li = D - 1; li >= 0; --li) {
    const int64_t lo = level_offs[li], hi = level_offs[li + 1];
    const int64_t n = hi - lo;
    std::unordered_map<uint64_t, std::vector<int32_t>> buckets;
    buckets.reserve(static_cast<size_t>(n) * 2);
    pending_states.clear();
    pending_inv.clear();
    int32_t next_cls = 0;
    for (int64_t i = 0; i < n; ++i) {
      const int64_t s = levels_blob[lo + i];
      const int32_t* row = dense + s * kCharSet;
      const int32_t fin = s < nf ? 1 : 0;
      // FNV-1a over the 257-int32 signature
      uint64_t h = 1469598103934665603ull;
      auto mix = [&h](int32_t v) {
        h ^= static_cast<uint32_t>(v);
        h *= 1099511628211ull;
      };
      mix(fin);
      for (int c = 0; c < kCharSet; ++c) {
        const int32_t t = row[c];
        mix(t >= 0 ? class_arr[t] : -1);
      }
      int32_t cls = -1;
      auto it = buckets.find(h);
      if (it != buckets.end()) {
        for (int32_t cand : it->second) {
          // full signature compare against the candidate class rep
          const int64_t rs =
              levels_blob[lo + rep_blob[lo + cand]];
          if ((rs < nf ? 1 : 0) != fin) continue;
          const int32_t* rrow = dense + rs * kCharSet;
          bool eq = true;
          for (int c = 0; c < kCharSet; ++c) {
            const int32_t a = row[c], b = rrow[c];
            const int32_t ca = a >= 0 ? class_arr[a] : -1;
            const int32_t cb = b >= 0 ? class_arr[b] : -1;
            if (ca != cb) { eq = false; break; }
          }
          if (eq) { cls = cand; break; }
        }
      }
      if (cls < 0) {
        cls = next_cls++;
        rep_blob[lo + cls] = static_cast<int32_t>(i);
        buckets[h].push_back(cls);
      }
      inv_blob[lo + i] = cls;
      pending_states.push_back(static_cast<int32_t>(s));
      pending_inv.push_back(cls);
    }
    n_classes[li] = next_cls;
    for (size_t i = 0; i < pending_states.size(); ++i)
      class_arr[pending_states[i]] = pending_inv[i];
  }
  return 0;
}

// Distinct-offset first-fit-descending layout
// (compile/depth.py::_layout_distinct) — EXACT same placement: rows in
// stable descending-count order; first offset >= start satisfying (a)
// offset unused by any prior row, (b) all main cols free, (c) all side
// cols free in the side occupancy; offsets rebased to min 0.
//
//   cols_blob/cols_offs:  per-row sorted main columns (int64).
//   side_blob/side_offs:  per-row side columns (int64); pass the same
//                         pointer with all-equal offs for "no sides".
//   force:                uint8 [n] (may be null): rows with no cols
//                         and no sides still get an offset when set.
//   colspan, cap:         as in the NumPy path.
//   side_alias_mask:      0 = side entries verified by the FULL code
//                         (byte storage).  Otherwise (e.g. 7) side
//                         entries store only (code & mask) + 1 —
//                         probe codes range over [0, side_span) — and
//                         the layout must prevent cross-row aliasing:
//                         a probe of code a' at a slot owned by a
//                         foreign (row, a) entry must not satisfy
//                         a' == a (mod mask+1).  Enforced two ways:
//                         (1) `shadow` marks offsets any future row
//                         must avoid because an existing side slot
//                         would alias one of its probes; (2) placing
//                         new side slots checks used_off at every
//                         aliasing probe origin.
//   priority:             int64 [n] or null.  When set, rows are
//                         placed in DESCENDING priority order (ties:
//                         descending count) — the profile-guided
//                         layout: hot rows land at low displacements
//                         so the kernel's grouped bank scan stops
//                         early.  Null keeps the classic
//                         first-fit-descending-count order.
//   out_offsets:          int64 [n]; rows with no placement get `empty`.
//
// Returns ht_len (>= 1), or -1 on overflow (caller doubles cap).
int64_t pfac_layout_distinct(const int64_t* cols_blob,
                             const int64_t* cols_offs,
                             const int64_t* side_blob,
                             const int64_t* side_offs, int64_t n,
                             const uint8_t* force, int64_t colspan,
                             int64_t cap, int64_t empty,
                             int64_t side_alias_mask, int64_t side_span,
                             const int64_t* priority,
                             int64_t* out_offsets) {
  // stable descending (priority,) main-column count
  std::vector<int32_t> order(n);
  for (int64_t i = 0; i < n; ++i) order[i] = static_cast<int32_t>(i);
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    if (priority != nullptr && priority[a] != priority[b])
      return priority[a] > priority[b];
    return (cols_offs[a + 1] - cols_offs[a]) >
           (cols_offs[b + 1] - cols_offs[b]);
  });

  // occupancy bitsets in biased slot space (slot = offset + col +
  // colspan, always >= 0 since offset >= -(colspan-1))
  const int64_t span = cap + 3 * colspan + 64;
  std::vector<uint64_t> occ((span + 63) / 64 + 1, 0);
  std::vector<uint64_t> side_occ((span + 63) / 64 + 1, 0);
  std::vector<uint64_t> used_off((span + 63) / 64 + 1, 0);
  std::vector<uint64_t> shadow;
  if (side_alias_mask) shadow.assign((span + 63) / 64 + 1, 0);
  // aliases of code a under the verify mask, within [0, colspan)
  const int64_t period = side_alias_mask + 1;
  auto test = [](const std::vector<uint64_t>& bs, int64_t s) {
    return (bs[s >> 6] >> (s & 63)) & 1u;
  };
  auto set = [](std::vector<uint64_t>& bs, int64_t s) {
    bs[s >> 6] |= (uint64_t{1} << (s & 63));
  };
  auto next_free = [](const std::vector<uint64_t>& bs, int64_t s) {
    int64_t w = s >> 6;
    uint64_t m = ~bs[w] & (~uint64_t{0} << (s & 63));
    while (m == 0) m = ~bs[++w];
    return (w << 6) + static_cast<int64_t>(__builtin_ctzll(m));
  };

  std::fill(out_offsets, out_offsets + n, empty);
  int64_t first_free = 0;  // biased slot space, main occ only
  bool any_live = false;
  int64_t min_off = 0, max_end = 0;  // over live rows (raw offsets)
  std::vector<std::pair<int64_t, int64_t>> placed;  // (row, raw offset)
  placed.reserve(n);
  for (int32_t i : order) {
    const int64_t clo = cols_offs[i], chi = cols_offs[i + 1];
    const int64_t slo = side_offs[i], shi = side_offs[i + 1];
    const int64_t nc = chi - clo, ns = shi - slo;
    if (nc == 0 && ns == 0 && (force == nullptr || !force[i])) continue;
    int64_t start;  // raw candidate offset
    if (nc > 0) {
      while (test(occ, first_free + colspan)) ++first_free;
      const int64_t c0 = cols_blob[clo];
      start = std::max(-c0, first_free - c0);
    } else {
      start = 0;
    }
    int64_t offset = start;
    while (offset < cap) {
      // offset-uniqueness first (mirrors the NumPy "bad" init)
      if (test(used_off, offset + colspan)) {
        offset = next_free(used_off, offset + colspan) - colspan;
        continue;
      }
      if (side_alias_mask && test(shadow, offset + colspan)) {
        offset = next_free(shadow, offset + colspan) - colspan;
        continue;
      }
      bool ok = true;
      for (int64_t j = clo; j < chi; ++j) {
        const int64_t s = offset + cols_blob[j] + colspan;
        if (test(occ, s)) {
          offset = next_free(occ, s) - cols_blob[j] - colspan;
          ok = false;
          break;
        }
      }
      if (!ok) continue;
      for (int64_t j = slo; j < shi; ++j) {
        const int64_t s = offset + side_blob[j] + colspan;
        if (test(side_occ, s)) {
          offset = next_free(side_occ, s) - side_blob[j] - colspan;
          ok = false;
          break;
        }
        if (side_alias_mask) {
          // an existing row whose offset is s - a' (a' an alias of
          // this code) would read this new slot as a false positive
          const int64_t a = side_blob[j];
          for (int64_t ap = a % period; ap < side_span; ap += period) {
            if (ap == a || s - ap < 0) continue;
            if (test(used_off, s - ap)) {  // s is already biased
              ok = false;
              break;
            }
          }
          if (!ok) {
            ++offset;
            break;
          }
        }
      }
      if (ok) break;
    }
    if (offset >= cap) return -1;
    for (int64_t j = clo; j < chi; ++j) set(occ, offset + cols_blob[j] + colspan);
    for (int64_t j = slo; j < shi; ++j) {
      const int64_t s = offset + side_blob[j] + colspan;
      set(side_occ, s);
      if (side_alias_mask) {
        // block every future offset whose probe of an aliasing code
        // would land on this slot
        const int64_t a = side_blob[j];
        for (int64_t ap = a % period; ap < side_span; ap += period)
          if (s - ap >= 0) set(shadow, s - ap);
      }
    }
    set(used_off, offset + colspan);
    placed.emplace_back(i, offset);
    const int64_t end = offset + (nc ? cols_blob[chi - 1] : 0);
    if (!any_live || offset < min_off) min_off = offset;
    if (!any_live || end > max_end) max_end = end;
    any_live = true;
  }
  if (!any_live) return 1;
  for (auto& [row, off] : placed) out_offsets[row] = off - min_off;
  return max_end - min_off + 1;
}

// Decode match bitmaps by re-walking hit positions (the host half of
// the kernels' bitmap contract, see ops/bitmap.py).  Match-dense
// corpora (english dict over english text: ~0.4 matches/byte) make
// this the end-to-end bottleneck in NumPy — the reference has the same
// host hot loop at main.cc:303-324.  Each hit position walks the
// automaton only to its bitmap's highest set bit; threads own disjoint
// position ranges with exact output offsets precomputed from popcounts
// (every set bit yields exactly one output triple).
//
//   dense:  int32 [state_num * 256] transition table, or null to use
//           the PHF probe (r/ht/val, reference master_kernel.cu:52-64).
//   out:    int64 [3 * total_popcount(hb)] — (pos, t, state) triples,
//           (pos, t)-ordered.
//
// Returns the number of triples written.
int64_t pfac_decode_hits(
    const uint8_t* data, int64_t n,
    const int64_t* hit_pos, const uint32_t* hb, int64_t h,
    const int32_t* s0, int64_t k,
    const int32_t* dense,
    const int32_t* r, int64_t r_len, const int32_t* ht, const int32_t* val,
    int64_t ht_size, int64_t width_bit,
    int64_t max_t, int64_t n_threads, int64_t* out) {
  if (h == 0) return 0;
  const int64_t width_m1 = (int64_t(1) << width_bit) - 1;
  if (max_t > 32) max_t = 32;

  auto walk_range = [&](int64_t lo, int64_t hi, int64_t* o) -> int64_t {
    int64_t* base = o;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t p = hit_pos[i];
      uint32_t rem = hb[i];
      if (!rem) continue;
      int64_t state = s0[data[p]];
      for (int64_t t = 0; t < max_t && rem; ++t) {
        if (t > 0) {
          if (state < 0 || p + t >= n) break;
          const int c = data[p + t];
          if (dense) {
            state = dense[state * kCharSet + c];
          } else {
            const int64_t key = state * kCharSet + c;
            const int64_t row = key >> width_bit;
            int64_t nxt = -1;
            if (row < r_len) {
              const int64_t idx = int64_t(r[row]) + (key & width_m1);
              if (idx >= 0 && idx < ht_size && ht[idx] == row)
                nxt = val[idx];
            }
            state = nxt;
          }
        }
        if (rem & (uint32_t(1) << t)) {
          rem &= ~(uint32_t(1) << t);
          if (state >= 0 && state < k) {
            *o++ = p;
            *o++ = t;
            *o++ = state;
          }
        }
      }
    }
    return (o - base) / 3;
  };

  if (n_threads <= 1 || h < (int64_t(1) << 16)) {
    return walk_range(0, h, out);
  }
  // exact per-chunk output offsets from bit counts (each set bit is at
  // most one triple; invalid-state bits leave a gap compacted below)
  std::vector<int64_t> starts(n_threads + 1, 0);
  std::vector<int64_t> chunk_lo(n_threads + 1, 0);
  const int64_t per = (h + n_threads - 1) / n_threads;
  {
    int64_t acc = 0, i = 0;
    for (int64_t c = 0; c < n_threads; ++c) {
      chunk_lo[c] = i;
      starts[c] = acc;
      const int64_t hi = std::min(h, i + per);
      for (; i < hi; ++i) acc += __builtin_popcount(hb[i]);
    }
    chunk_lo[n_threads] = h;
    starts[n_threads] = acc;
  }
  std::vector<int64_t> written(n_threads, 0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t c = 0; c < n_threads; ++c) {
    threads.emplace_back([&, c]() {
      written[c] =
          walk_range(chunk_lo[c], chunk_lo[c + 1], out + 3 * starts[c]);
    });
  }
  for (auto& t : threads) t.join();
  // compact the (rare) gaps left by defensive invalid-state skips
  int64_t total = written[0];
  for (int64_t c = 1; c < n_threads; ++c) {
    if (total != starts[c] && written[c]) {
      std::memmove(out + 3 * total, out + 3 * starts[c],
                   sizeof(int64_t) * 3 * written[c]);
    }
    total += written[c];
  }
  return total;
}

// Hash-probe bitmap decode: bit t set at position p means
// data[p..p+t] IS a pattern of this shard (PFAC final at depth t+1
// along the path <=> the substring equals a pattern), so the decode
// is one open-addressed lookup per set bit instead of a trie walk —
// one ~L2-resident table probe vs per-step dense-table cache misses.
// Table built host-side (compile/native.py): FNV-1a 64 keys, linear
// probing, slot values = the pattern's FINAL STATE from the real trie
// walk (so output triples are byte-identical to pfac_decode_hits).
static inline uint64_t fnv1a(const uint8_t* s, int64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (int64_t i = 0; i < len; ++i) {
    h = (h ^ s[i]) * 1099511628211ULL;
  }
  return h;
}

int64_t pfac_decode_hits_hash(
    const uint8_t* data, int64_t n,
    const int64_t* hit_pos, const uint32_t* hb, int64_t h,
    const uint8_t* blob, const int64_t* slot_off,
    const int32_t* slot_len, const int32_t* slot_state,
    int64_t tsize_log2,
    int64_t max_t, int64_t n_threads, int64_t* out) {
  if (h == 0) return 0;
  if (max_t > 32) max_t = 32;
  const uint64_t mask = (uint64_t(1) << tsize_log2) - 1;

  auto probe_range = [&](int64_t lo, int64_t hi, int64_t* o) -> int64_t {
    int64_t* base = o;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t p = hit_pos[i];
      uint32_t rem = hb[i];
      while (rem) {
        const int t = __builtin_ctz(rem);
        rem &= rem - 1;
        if (t >= max_t) break;
        const int64_t len = t + 1;
        if (p + len > n) continue;  // defensive: pad bits
        uint64_t slot = fnv1a(data + p, len) & mask;
        while (slot_off[slot] >= 0) {
          if (slot_len[slot] == len &&
              std::memcmp(blob + slot_off[slot], data + p, len) == 0) {
            *o++ = p;
            *o++ = t;
            *o++ = slot_state[slot];
            break;
          }
          slot = (slot + 1) & mask;
        }
      }
    }
    return (o - base) / 3;
  };

  if (n_threads <= 1 || h < (int64_t(1) << 16)) {
    return probe_range(0, h, out);
  }
  std::vector<int64_t> starts(n_threads + 1, 0);
  std::vector<int64_t> chunk_lo(n_threads + 1, 0);
  const int64_t per = (h + n_threads - 1) / n_threads;
  {
    int64_t acc = 0, i = 0;
    for (int64_t c = 0; c < n_threads; ++c) {
      chunk_lo[c] = i;
      starts[c] = acc;
      const int64_t hi = std::min(h, i + per);
      for (; i < hi; ++i) acc += __builtin_popcount(hb[i]);
    }
    chunk_lo[n_threads] = h;
    starts[n_threads] = acc;
  }
  std::vector<int64_t> written(n_threads, 0);
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (int64_t c = 0; c < n_threads; ++c) {
    threads.emplace_back([&, c]() {
      written[c] =
          probe_range(chunk_lo[c], chunk_lo[c + 1], out + 3 * starts[c]);
    });
  }
  for (auto& t : threads) t.join();
  int64_t total = written[0];
  for (int64_t c = 1; c < n_threads; ++c) {
    if (total != starts[c] && written[c]) {
      std::memmove(out + 3 * total, out + 3 * starts[c],
                   sizeof(int64_t) * 3 * written[c]);
    }
    total += written[c];
  }
  return total;
}

}  // extern "C"
