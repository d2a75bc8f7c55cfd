// Native sequence packer: fixed ctx_len rows from variable-length lines.
//
// C++ twin of data/loader.py pack_sequences (reference get_sequence,
// the reference's training/loader.py:118-163), bit-identical for a given
// line order, including the reference's drop semantics:
//   * truncate mode: the overflowing line is cut to fill the row; its
//     remainder is discarded;
//   * padding mode: the overflowing line is discarded; lines longer than
//     ctx_len are skipped;
//   * the line pulled right after a row fills to exactly ctx_len is dropped
//     (the row is only emitted once that next line has been consumed, so an
//     exactly-full row at end-of-input stays pending, as in the generator).
// Also emits segment ids (exclusive running EOS count per row) so the host
// pipeline produces kernel-ready batches in one pass.
//
// Streaming contract: *consumed_lines is the index of the first line whose
// tokens are NOT yet materialised in a completed row. Re-feeding from that
// index reproduces the pending partial row exactly (packing is
// deterministic in line order).
#include <cstdint>
#include <cstring>

namespace {
constexpr int32_t kEos = 3;
constexpr int32_t kPad = 1;
}

extern "C" {

long obt_pack_lines(const int32_t* lines, const long* offsets, long n_lines,
                    int ctx_len, int use_padding, int32_t* out_rows,
                    int32_t* out_segs, long cap_rows, long* consumed_lines) {
  long row = 0;
  int fill = 0;
  int32_t* cur = out_rows;
  long li = 0;
  long row_start_line = 0;  // first line feeding the current row

  auto finish_row = [&]() {
    int32_t seg = 0;
    int32_t* segp = out_segs + row * (long)ctx_len;
    for (int t = 0; t < ctx_len; ++t) {
      segp[t] = seg;
      if (cur[t] == kEos) ++seg;
    }
    ++row;
    cur = out_rows + row * (long)ctx_len;
    fill = 0;
  };

  while (li < n_lines && row < cap_rows) {
    const int32_t* line = lines + offsets[li];
    long len = offsets[li + 1] - offsets[li];

    if (fill == ctx_len) {
      // exact fill: this freshly pulled line is dropped (loader.py:131-136)
      ++li;
      finish_row();
      row_start_line = li;
      continue;
    }
    ++li;
    if (fill == 0) row_start_line = li - 1;

    if (fill + len > ctx_len) {
      if (use_padding) {
        if (fill == 0) {
          row_start_line = li;  // oversized line skipped entirely
          continue;
        }
        for (int t = fill; t < ctx_len; ++t) cur[t] = kPad;
      } else {
        std::memcpy(cur + fill, line, (ctx_len - fill) * sizeof(int32_t));
      }
      finish_row();
      row_start_line = li;
      continue;
    }
    std::memcpy(cur + fill, line, len * sizeof(int32_t));
    fill += (int)len;
  }

  // fill > 0 covers the exactly-full pending row too (it is only emitted
  // after the next line is pulled and dropped)
  *consumed_lines = (fill > 0) ? row_start_line : li;
  return row;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Chunk-level pipeline: EOS split + banned filter + shuffle + pack in one
// native pass (the round-trip through Python lists is the host bottleneck
// at pod scale). Order is its own seeded shuffle (std::mt19937_64
// Fisher-Yates) — deterministic given (seed), independent of numpy.
// ---------------------------------------------------------------------------
#include <random>
#include <vector>

extern "C" {

// block: one reader chunk (concatenated shards). carry: partial-row tokens
// from the previous chunk (inout, capacity ctx_len, length *carry_len).
// Returns rows written.
long obt_pack_chunk(const int32_t* block, long n_tokens,
                    const int32_t* banned, int n_banned,
                    uint64_t shuffle_seed, int ctx_len, int use_padding,
                    int32_t* carry, int* carry_len,
                    int32_t* out_rows, int32_t* out_segs, long cap_rows) {
  // 1. split after each EOS
  std::vector<std::pair<long, long>> lines;
  long start = 0;
  for (long i = 0; i < n_tokens; ++i) {
    if (block[i] == kEos) {
      lines.emplace_back(start, i + 1);
      start = i + 1;
    }
  }
  if (start < n_tokens) lines.emplace_back(start, n_tokens);

  // 2. shuffle line order
  std::mt19937_64 rng(shuffle_seed);
  for (long i = (long)lines.size() - 1; i > 0; --i) {
    long j = (long)(rng() % (uint64_t)(i + 1));
    std::swap(lines[i], lines[j]);
  }

  // 3. filter + pack (same row semantics as obt_pack_lines)
  long row = 0;
  int fill = *carry_len;
  int32_t* cur = out_rows;
  if (fill > 0) std::memcpy(cur, carry, fill * sizeof(int32_t));

  std::vector<int32_t> lbuf;
  lbuf.reserve(4096);

  auto finish_row = [&]() {
    int32_t seg = 0;
    int32_t* segp = out_segs + row * (long)ctx_len;
    for (int t = 0; t < ctx_len; ++t) {
      segp[t] = seg;
      if (cur[t] == kEos) ++seg;
    }
    ++row;
    cur = out_rows + row * (long)ctx_len;
    fill = 0;
  };

  for (size_t li = 0; li < lines.size(); ++li) {
    // banned-token filter into lbuf
    lbuf.clear();
    for (long i = lines[li].first; i < lines[li].second; ++i) {
      int32_t t = block[i];
      bool is_banned = false;
      for (int b = 0; b < n_banned; ++b)
        if (t == banned[b]) { is_banned = true; break; }
      if (!is_banned) lbuf.push_back(t);
    }
    if (lbuf.empty()) continue;
    long len = (long)lbuf.size();

    if (row >= cap_rows) {
      // out of capacity: stash what we have and stop (tokens of remaining
      // lines are lost — callers size cap_rows to the chunk)
      break;
    }
    if (fill == ctx_len) {     // drop this line, emit the row
      finish_row();
      continue;
    }
    if (fill + len > ctx_len) {
      if (use_padding) {
        if (fill == 0) continue;
        for (int t = fill; t < ctx_len; ++t) cur[t] = kPad;
      } else {
        std::memcpy(cur + fill, lbuf.data(),
                    (ctx_len - fill) * sizeof(int32_t));
      }
      finish_row();
      continue;
    }
    std::memcpy(cur + fill, lbuf.data(), len * sizeof(int32_t));
    fill += (int)len;
  }

  if (fill == ctx_len) {
    // pending exactly-full row: keep as carry so the next chunk's first
    // line is dropped, matching the generator semantics
    std::memcpy(carry, cur, ctx_len * sizeof(int32_t));
    *carry_len = ctx_len;
  } else {
    std::memcpy(carry, cur, fill * sizeof(int32_t));
    *carry_len = fill;
  }
  return row;
}

}  // extern "C"
