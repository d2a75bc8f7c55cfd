// SentencePiece-compatible BPE core. See spm.h.
#include "spm.h"

#include <algorithm>
#include <cstring>
#include <map>
#include <queue>
#include <set>

namespace obt {

// ---------------------------------------------------------------------------
// Protobuf wire-format helpers (no protobuf dependency)
// ---------------------------------------------------------------------------

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t Varint() {
    uint64_t r = 0;
    int s = 0;
    while (p < end) {
      uint8_t b = *p++;
      r |= static_cast<uint64_t>(b & 0x7f) << s;
      if (!(b & 0x80)) return r;
      s += 7;
      if (s > 63) break;
    }
    ok = false;
    return 0;
  }

  std::string Bytes() {
    uint64_t n = Varint();
    // compare against the REMAINING length: `p + n > end` overflows the
    // pointer for a corrupt huge varint and bypasses the bounds check
    if (!ok || n > static_cast<uint64_t>(end - p)) {
      ok = false;
      return {};
    }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }

  float Float32() {
    if (p + 4 > end) {
      ok = false;
      return 0;
    }
    float f;
    std::memcpy(&f, p, 4);
    p += 4;
    return f;
  }

  void Skip(int wire) {
    switch (wire) {
      case 0: Varint(); break;
      case 1: p += 8; break;
      case 2: {
        uint64_t n = Varint();
        if (n > static_cast<uint64_t>(end - p)) { ok = false; break; }
        p += n;
        break;
      }
      case 5: p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

void AppendVarint(std::string* out, uint64_t v) {
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

void AppendTag(std::string* out, int field, int wire) {
  AppendVarint(out, (static_cast<uint64_t>(field) << 3) | wire);
}

void AppendBytes(std::string* out, int field, const std::string& s) {
  AppendTag(out, field, 2);
  AppendVarint(out, s.size());
  out->append(s);
}

constexpr const char* kSpaceSymbol = "\xe2\x96\x81";  // '▁'
constexpr const char* kUnkSurface = " \xe2\x81\x87 ";  // ' ⁇ '

int Utf8CharLen(unsigned char b) {
  if (b < 0x80) return 1;
  if ((b >> 5) == 0x6) return 2;
  if ((b >> 4) == 0xe) return 3;
  if ((b >> 3) == 0x1e) return 4;
  return 1;  // invalid byte: treat as single
}

}  // namespace

// ---------------------------------------------------------------------------
// Darts double-array charsmap (darts_clone unit layout)
// ---------------------------------------------------------------------------

namespace {
inline bool UnitHasLeaf(uint32_t u) { return (u >> 8) & 1; }
inline int32_t UnitValue(uint32_t u) {
  return static_cast<int32_t>(u & 0x7fffffff);
}
inline uint32_t UnitLabel(uint32_t u) { return u & ((1u << 31) | 0xFF); }
inline uint32_t UnitOffset(uint32_t u) {
  return (u >> 10) << ((u & (1u << 9)) >> 6);
}
}  // namespace

void CharsMap::Load(const std::string& blob) {
  units_.clear();
  values_.clear();
  if (blob.size() < 4) return;
  uint32_t trie_bytes;
  std::memcpy(&trie_bytes, blob.data(), 4);
  if (4 + trie_bytes > blob.size()) return;
  size_t n = trie_bytes / 4;
  units_.resize(n);
  std::memcpy(units_.data(), blob.data() + 4, trie_bytes);
  values_.assign(blob.data() + 4 + trie_bytes,
                 blob.size() - 4 - trie_bytes);
}

int CharsMap::LongestMatch(const char* s, int len, std::string* out) const {
  if (units_.empty()) return 0;
  uint32_t node_pos = 0;
  uint32_t unit = units_[0];
  node_pos ^= UnitOffset(unit);
  int best_len = 0;
  int32_t best_val = -1;
  for (int i = 0; i < len; ++i) {
    uint8_t c = static_cast<uint8_t>(s[i]);
    if (c == 0) break;
    node_pos ^= c;
    if (node_pos >= units_.size()) break;
    unit = units_[node_pos];
    if (UnitLabel(unit) != c) break;
    node_pos ^= UnitOffset(unit);
    if (UnitHasLeaf(unit)) {
      if (node_pos >= units_.size()) break;
      best_val = UnitValue(units_[node_pos]);
      best_len = i + 1;
    }
  }
  if (best_len == 0) return 0;
  if (best_val < 0 || static_cast<size_t>(best_val) >= values_.size())
    return 0;
  const char* v = values_.data() + best_val;
  out->assign(v);  // NUL-terminated replacement
  return best_len;
}

// ---------------------------------------------------------------------------
// Model loading
// ---------------------------------------------------------------------------

bool SpmModel::Load(const std::string& path, std::string* err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    *err = "cannot open " + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string data(sz, '\0');
  size_t got = std::fread(data.data(), 1, sz, f);
  std::fclose(f);
  if (static_cast<long>(got) != sz) {
    *err = "short read on " + path;
    return false;
  }
  return LoadFromString(data, err);
}

bool SpmModel::LoadFromString(const std::string& data, std::string* err) {
  pieces_.clear();
  piece_index_.clear();
  matcher_ids_.clear();
  matcher_first_bytes_.clear();
  charsmap_ = CharsMap();
  unk_id_ = 0;
  Cursor c{reinterpret_cast<const uint8_t*>(data.data()),
           reinterpret_cast<const uint8_t*>(data.data()) + data.size()};
  while (c.p < c.end && c.ok) {
    uint64_t tag = c.Varint();
    int field = static_cast<int>(tag >> 3);
    int wire = static_cast<int>(tag & 7);
    if (field == 1 && wire == 2) {  // SentencePiece
      std::string sub = c.Bytes();
      Cursor sc{reinterpret_cast<const uint8_t*>(sub.data()),
                reinterpret_cast<const uint8_t*>(sub.data()) + sub.size()};
      Piece piece;
      while (sc.p < sc.end && sc.ok) {
        uint64_t t2 = sc.Varint();
        int f2 = static_cast<int>(t2 >> 3);
        int w2 = static_cast<int>(t2 & 7);
        if (f2 == 1 && w2 == 2) piece.piece = sc.Bytes();
        else if (f2 == 2 && w2 == 5) piece.score = sc.Float32();
        else if (f2 == 3 && w2 == 0) piece.type = static_cast<int32_t>(sc.Varint());
        else sc.Skip(w2);
      }
      pieces_.push_back(std::move(piece));
    } else if (field == 3 && wire == 2) {  // NormalizerSpec
      std::string sub = c.Bytes();
      Cursor sc{reinterpret_cast<const uint8_t*>(sub.data()),
                reinterpret_cast<const uint8_t*>(sub.data()) + sub.size()};
      while (sc.p < sc.end && sc.ok) {
        uint64_t t2 = sc.Varint();
        int f2 = static_cast<int>(t2 >> 3);
        int w2 = static_cast<int>(t2 & 7);
        if (f2 == 2 && w2 == 2) charsmap_.Load(sc.Bytes());
        else if (f2 == 3 && w2 == 0) add_dummy_prefix_ = sc.Varint() != 0;
        else if (f2 == 4 && w2 == 0) remove_extra_whitespaces_ = sc.Varint() != 0;
        else if (f2 == 5 && w2 == 0) escape_whitespaces_ = sc.Varint() != 0;
        else sc.Skip(w2);
      }
    } else {
      c.Skip(wire);
    }
  }
  if (!c.ok) {
    *err = "malformed model proto";
    return false;
  }
  for (int i = 0; i < static_cast<int>(pieces_.size()); ++i) {
    piece_index_.emplace(pieces_[i].piece, i);
    if (pieces_[i].type == kUnknown) unk_id_ = i;
    // USER_DEFINED only: real sentencepiece never extracts CONTROL
    // pieces from raw text (text containing a literal "<s>" tokenizes as
    // characters), and matching them would let plain text inject control
    // ids
    if (pieces_[i].type == kUserDefined)
      matcher_ids_.push_back(i);
  }
  // longest-first for prefix matching
  std::sort(matcher_ids_.begin(), matcher_ids_.end(), [this](int a, int b) {
    return pieces_[a].piece.size() > pieces_[b].piece.size();
  });
  matcher_first_bytes_.assign(256, false);
  for (int id : matcher_ids_)
    if (!pieces_[id].piece.empty())
      matcher_first_bytes_[static_cast<unsigned char>(
          pieces_[id].piece[0])] = true;
  return true;
}

int SpmModel::piece_to_id(const std::string& p) const {
  auto it = piece_index_.find(p);
  return it == piece_index_.end() ? unk_id_ : it->second;
}

// ---------------------------------------------------------------------------
// Normalization
// ---------------------------------------------------------------------------

std::string SpmModel::Normalize(
    const std::string& input,
    std::vector<std::pair<int, int>>* user_spans) const {
  // Stage 1: charsmap replacement with user-symbol protection.
  // Chunks: (text, is_user_symbol)
  std::vector<std::pair<std::string, bool>> chunks;
  size_t i = 0;
  const int n = static_cast<int>(input.size());
  while (i < input.size()) {
    // user-defined symbol match (longest first; only USER_DEFINED matters
    // for raw-text matching, but control symbols like <s> are also atomic
    // if they appear literally)
    int matched = -1;
    if (!matcher_ids_.empty() && matcher_first_bytes_[
            static_cast<unsigned char>(input[i])]) {
      for (int id : matcher_ids_) {
        const std::string& p = pieces_[id].piece;
        if (p.size() <= input.size() - i &&
            std::memcmp(input.data() + i, p.data(), p.size()) == 0) {
          matched = id;
          break;
        }
      }
    }
    if (matched >= 0) {
      chunks.emplace_back(pieces_[matched].piece, true);
      i += pieces_[matched].piece.size();
      continue;
    }
    std::string rep;
    int m = charsmap_.LongestMatch(input.data() + i, n - static_cast<int>(i),
                                   &rep);
    if (m > 0) {
      if (!chunks.empty() && !chunks.back().second)
        chunks.back().first += rep;
      else
        chunks.emplace_back(rep, false);
      i += m;
    } else {
      int cl = Utf8CharLen(static_cast<unsigned char>(input[i]));
      cl = std::min<int>(cl, input.size() - i);
      if (!chunks.empty() && !chunks.back().second)
        chunks.back().first.append(input, i, cl);
      else
        chunks.emplace_back(input.substr(i, cl), false);
      i += cl;
    }
  }

  // Stage 2: whitespace rules + dummy prefix + escaping, tracking user spans.
  std::string flat;
  std::vector<std::pair<int, int>> spans;  // byte spans in `flat`
  bool prev_space = remove_extra_whitespaces_;  // strips leading spaces
  auto append_text = [&](const std::string& t) {
    for (size_t j = 0; j < t.size();) {
      if (t[j] == ' ') {
        if (!(remove_extra_whitespaces_ && prev_space)) flat.push_back(' ');
        prev_space = true;
        ++j;
      } else {
        int cl = Utf8CharLen(static_cast<unsigned char>(t[j]));
        cl = std::min<size_t>(cl, t.size() - j);
        flat.append(t, j, cl);
        prev_space = false;
        j += cl;
      }
    }
  };
  for (auto& [text, is_user] : chunks) {
    if (is_user) {
      int s = static_cast<int>(flat.size());
      flat += text;
      spans.emplace_back(s, static_cast<int>(flat.size()));
      prev_space = false;
    } else {
      append_text(text);
    }
  }
  if (remove_extra_whitespaces_) {
    while (!flat.empty() && flat.back() == ' ') {
      // never strip inside a trailing user span
      if (!spans.empty() && spans.back().second == static_cast<int>(flat.size()))
        break;
      flat.pop_back();
    }
  }
  if (add_dummy_prefix_ && !flat.empty()) {
    flat.insert(flat.begin(), ' ');
    for (auto& sp : spans) {
      sp.first += 1;
      sp.second += 1;
    }
  }
  if (escape_whitespaces_) {
    std::string esc;
    esc.reserve(flat.size() + 8);
    std::vector<std::pair<int, int>> esc_spans = spans;
    size_t si = 0;
    std::vector<int> delta(flat.size() + 1, 0);
    int shift = 0;
    for (size_t j = 0; j < flat.size(); ++j) {
      delta[j] = shift;
      if (flat[j] == ' ') {
        // spaces inside user spans don't exist (symbols have no spaces)
        esc += kSpaceSymbol;
        shift += 2;  // 3-byte symbol replaces 1-byte space
      } else {
        esc.push_back(flat[j]);
      }
    }
    delta[flat.size()] = shift;
    for (auto& sp : esc_spans) {
      sp.first += delta[sp.first];
      sp.second += delta[sp.second];
    }
    flat.swap(esc);
    spans.swap(esc_spans);
  }
  if (user_spans) *user_spans = std::move(spans);
  return flat;
}

// ---------------------------------------------------------------------------
// BPE encode
// ---------------------------------------------------------------------------

namespace {

struct Sym {
  int start;   // byte offset in normalized string
  int end;
  int prev;
  int next;
  bool active;
  bool frozen;  // user-defined/control: never merges
};

struct Cand {
  float score;
  int left;     // symbol index
  int size;     // merged byte length at push time (staleness check)
  int piece_id;
};

struct CandCmp {
  // max-heap: higher score first; ties -> leftmost symbol first
  bool operator()(const Cand& a, const Cand& b) const {
    if (a.score != b.score) return a.score < b.score;
    return a.left > b.left;
  }
};

}  // namespace

std::vector<int> SpmModel::EncodeNormalized(
    const std::string& norm,
    const std::vector<std::pair<int, int>>& user_spans) const {
  std::vector<int> out;
  if (norm.empty()) return out;

  std::vector<Sym> syms;
  syms.reserve(norm.size());
  size_t span_i = 0;
  int i = 0;
  const int n = static_cast<int>(norm.size());
  while (i < n) {
    while (span_i < user_spans.size() && user_spans[span_i].second <= i)
      ++span_i;
    if (span_i < user_spans.size() && user_spans[span_i].first == i) {
      syms.push_back({i, user_spans[span_i].second, 0, 0, true, true});
      i = user_spans[span_i].second;
      ++span_i;
      continue;
    }
    int cl = Utf8CharLen(static_cast<unsigned char>(norm[i]));
    cl = std::min(cl, n - i);
    syms.push_back({i, i + cl, 0, 0, true, false});
    i += cl;
  }
  const int ns = static_cast<int>(syms.size());
  for (int s = 0; s < ns; ++s) {
    syms[s].prev = s - 1;
    syms[s].next = s + 1 < ns ? s + 1 : -1;
  }

  std::priority_queue<Cand, std::vector<Cand>, CandCmp> heap;
  auto maybe_push = [&](int left) {
    if (left < 0) return;
    int right = syms[left].next;
    if (right < 0) return;
    if (syms[left].frozen || syms[right].frozen) return;
    std::string_view merged(norm.data() + syms[left].start,
                            syms[right].end - syms[left].start);
    auto it = piece_index_.find(merged);
    if (it == piece_index_.end()) return;
    if (pieces_[it->second].type != kNormal) return;
    heap.push({pieces_[it->second].score, left,
               syms[right].end - syms[left].start, it->second});
  };
  for (int s = 0; s < ns; ++s) maybe_push(s);

  while (!heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    Sym& L = syms[c.left];
    if (!L.active) continue;
    int r = L.next;
    if (r < 0) continue;
    Sym& R = syms[r];
    if (!R.active || R.end - L.start != c.size) continue;
    // merge R into L
    L.end = R.end;
    R.active = false;
    L.next = R.next;
    if (R.next >= 0) syms[R.next].prev = c.left;
    maybe_push(L.prev);
    maybe_push(c.left);
  }

  for (int s = 0; s >= 0 && s < ns; s = syms[s].next) {
    if (!syms[s].active) continue;
    std::string_view piece(norm.data() + syms[s].start,
                           syms[s].end - syms[s].start);
    auto it = piece_index_.find(piece);
    out.push_back(it == piece_index_.end() ? unk_id_ : it->second);
  }
  return out;
}

std::vector<int> SpmModel::Encode(const std::string& input) const {
  std::vector<std::pair<int, int>> spans;
  std::string norm = Normalize(input, &spans);
  return EncodeNormalized(norm, spans);
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

std::string SpmModel::Decode(const std::vector<int>& ids) const {
  std::string joined;
  for (int id : ids) {
    if (id < 0 || id >= vocab_size()) continue;
    const Piece& p = pieces_[id];
    if (p.type == kControl) continue;
    if (p.type == kUnknown) {
      joined += kUnkSurface;
      continue;
    }
    joined += p.piece;
  }
  // '▁' -> ' '
  std::string out;
  out.reserve(joined.size());
  for (size_t i = 0; i < joined.size();) {
    if (joined.compare(i, 3, kSpaceSymbol) == 0) {
      out.push_back(' ');
      i += 3;
    } else {
      out.push_back(joined[i]);
      ++i;
    }
  }
  if (add_dummy_prefix_ && !out.empty() && out[0] == ' ') out.erase(0, 1);
  return out;
}

// ---------------------------------------------------------------------------
// Serialization (trainer output)
// ---------------------------------------------------------------------------

std::string SpmModel::Serialize(const std::vector<Piece>& pieces,
                                const std::string& normalizer_name,
                                bool add_dummy_prefix,
                                bool remove_extra_whitespaces) {
  std::string out;
  for (const Piece& p : pieces) {
    std::string sub;
    AppendBytes(&sub, 1, p.piece);
    AppendTag(&sub, 2, 5);
    char buf[4];
    std::memcpy(buf, &p.score, 4);
    sub.append(buf, 4);
    if (p.type != kNormal) {
      AppendTag(&sub, 3, 0);
      AppendVarint(&sub, p.type);
    }
    AppendBytes(&out, 1, sub);
  }
  // TrainerSpec: model_type = BPE(2)
  std::string trainer;
  AppendTag(&trainer, 3, 0);
  AppendVarint(&trainer, 2);
  AppendBytes(&out, 2, trainer);
  // NormalizerSpec (no charsmap: identity + whitespace rules)
  std::string norm;
  AppendBytes(&norm, 1, normalizer_name);
  AppendTag(&norm, 3, 0);
  AppendVarint(&norm, add_dummy_prefix ? 1 : 0);
  AppendTag(&norm, 4, 0);
  AppendVarint(&norm, remove_extra_whitespaces ? 1 : 0);
  AppendBytes(&out, 3, norm);
  return out;
}

// ---------------------------------------------------------------------------
// BPE trainer
// ---------------------------------------------------------------------------

namespace {

struct TrainPrep {
  std::vector<Piece> pieces;  // specials prefix
  std::vector<std::vector<std::string>> corpus;
  std::map<std::string, int64_t> char_freq;
  int64_t n_merges = 0;
};

TrainPrep PrepTrainCorpus(const std::vector<std::string>& sentences,
                          int vocab_size,
                          const std::vector<std::string>& user_defined,
                          const std::vector<std::string>& control) {
  TrainPrep prep;
  // Specials first: <unk>, <s>, </s>, then user-defined symbols — the layout
  // of the reference tokenizers (tokenizers/mixed_bpe.vocab:1-20).
  auto& pieces = prep.pieces;
  pieces.push_back({"<unk>", 0.0f, kUnknown});
  pieces.push_back({"<s>", 0.0f, kControl});
  pieces.push_back({"</s>", 0.0f, kControl});
  for (const auto& c : control) pieces.push_back({c, 0.0f, kControl});
  for (const auto& u : user_defined) pieces.push_back({u, 0.0f, kUserDefined});

  // Normalize corpus the same way encode will see it: dummy prefix + escape.
  // (identity charsmap; biological corpora are ASCII)
  std::set<std::string> protect(user_defined.begin(), user_defined.end());
  for (const auto& c : control) protect.insert(c);

  // Each sentence -> list of unicode chars, with protected symbols removed
  // from training (they're atomic).
  auto& corpus = prep.corpus;
  auto& char_freq = prep.char_freq;
  for (const auto& raw : sentences) {
    std::string s = " " + raw;  // dummy prefix
    std::vector<std::string> chars;
    size_t i = 0;
    while (i < s.size()) {
      bool matched = false;
      for (const auto& p : protect) {
        if (s.compare(i, p.size(), p) == 0) {
          if (!chars.empty()) corpus.push_back(std::move(chars));
          chars.clear();
          i += p.size();
          matched = true;
          break;
        }
      }
      if (matched) continue;
      if (s[i] == ' ') {
        chars.push_back(kSpaceSymbol);
        ++i;
        continue;
      }
      int cl = Utf8CharLen(static_cast<unsigned char>(s[i]));
      cl = std::min<size_t>(cl, s.size() - i);
      chars.push_back(s.substr(i, cl));
      i += cl;
    }
    if (!chars.empty()) corpus.push_back(std::move(chars));
  }
  for (auto& w : corpus)
    for (auto& ch : w) char_freq[ch]++;

  prep.n_merges = vocab_size - static_cast<int64_t>(pieces.size()) -
                  static_cast<int64_t>(char_freq.size());
  return prep;
}

// Reference-shaped merge loop: recount-free but applies each merge with a
// full corpus scan — O(n_merges * corpus). Kept as the semantics oracle the
// fast path is parity-tested against (tests/test_tokenizer.py).
std::vector<std::string> MergeLoopNaive(
    std::vector<std::vector<std::string>>& corpus, int64_t n_merges,
    int max_piece_len) {
  // Agglomerative merging with incremental pair counts.
  struct PairInfo {
    int64_t count = 0;
  };
  std::map<std::pair<std::string, std::string>, PairInfo> pair_counts;
  auto count_all = [&]() {
    pair_counts.clear();
    for (auto& w : corpus)
      for (size_t j = 0; j + 1 < w.size(); ++j)
        pair_counts[{w[j], w[j + 1]}].count++;
  };
  count_all();

  std::vector<std::string> merged_pieces;
  for (int64_t m = 0; m < n_merges; ++m) {
    // best pair by count; ties resolve to the lexicographically smallest
    // pair BECAUSE std::map iterates keys in ascending order (the first
    // max-count pair seen wins via the strict '>'), matching
    // MergeLoopFast's explicit tie-break. NOTE for porters: with an
    // unordered container this implicit tie-break disappears.
    std::pair<std::string, std::string> best;
    int64_t best_count = 0;
    for (auto& [pr, info] : pair_counts) {
      if (info.count > best_count) {
        std::string cat = pr.first + pr.second;
        if (static_cast<int>(cat.size()) > max_piece_len) continue;
        best = pr;
        best_count = info.count;
      }
    }
    if (best_count < 2) break;
    std::string merged = best.first + best.second;
    merged_pieces.push_back(merged);
    // apply merge in corpus (simple scan; fine for moderate corpora)
    for (auto& w : corpus) {
      for (size_t j = 0; j + 1 < w.size();) {
        if (w[j] == best.first && w[j + 1] == best.second) {
          if (j > 0) {
            pair_counts[{w[j - 1], w[j]}].count--;
            pair_counts[{w[j - 1], merged}].count++;
          }
          if (j + 2 < w.size()) {
            pair_counts[{w[j + 1], w[j + 2]}].count--;
            pair_counts[{merged, w[j + 2]}].count++;
          }
          w[j] = merged;
          w.erase(w.begin() + j + 1);
        } else {
          ++j;
        }
      }
    }
    pair_counts.erase(best);
  }
  return merged_pieces;
}

// Fast merge loop: same selection and application semantics as
// MergeLoopNaive, but O((corpus + merges) log) instead of
// O(n_merges * corpus):
//   * symbols interned to int ids; each word is a doubly-linked list, so a
//     merge touches only its own occurrences;
//   * pair counts in a hash map (authoritative) with per-pair occurrence
//     lists; every count increment also records the occurrence;
//   * best-pair selection through a lazy max-heap ordered exactly like the
//     naive linear scan (count desc, then lexicographically smallest pair):
//     stale entries are re-pushed with their current count on pop, so for
//     every pair the heap always holds an entry >= its live count.
std::vector<std::string> MergeLoopFast(
    std::vector<std::vector<std::string>>& corpus, int64_t n_merges,
    int max_piece_len) {
  std::vector<std::string> syms;
  std::vector<int> slen;
  std::unordered_map<std::string, int32_t> intern;
  auto sym_id = [&](const std::string& s) -> int32_t {
    auto it = intern.find(s);
    if (it != intern.end()) return it->second;
    int32_t id = static_cast<int32_t>(syms.size());
    intern.emplace(s, id);
    syms.push_back(s);
    slen.push_back(static_cast<int>(s.size()));
    return id;
  };

  struct Word {
    std::vector<int32_t> sym, nxt, prv;
  };
  std::vector<Word> words;
  words.reserve(corpus.size());
  for (auto& w : corpus) {
    Word W;
    int n = static_cast<int>(w.size());
    W.sym.resize(n);
    W.nxt.resize(n);
    W.prv.resize(n);
    for (int i = 0; i < n; ++i) {
      W.sym[i] = sym_id(w[i]);
      W.nxt[i] = (i + 1 < n) ? i + 1 : -1;
      W.prv[i] = i - 1;
    }
    words.push_back(std::move(W));
  }

  auto pkey = [](int32_t a, int32_t b) {
    return (static_cast<uint64_t>(static_cast<uint32_t>(a)) << 32) |
           static_cast<uint32_t>(b);
  };
  std::unordered_map<uint64_t, int64_t> count;
  std::unordered_map<uint64_t, std::vector<std::pair<int32_t, int32_t>>> occ;

  struct Entry {
    int64_t c;
    int32_t a, b;
  };
  // priority_queue keeps the LARGEST element on top under this "worse-than"
  // comparator; ids compare through their strings to reproduce the naive
  // tie-break (lexicographically smallest pair wins at equal count).
  auto worse = [&syms](const Entry& x, const Entry& y) {
    if (x.c != y.c) return x.c < y.c;
    if (x.a != y.a) return syms[x.a] > syms[y.a];
    return syms[x.b] > syms[y.b];
  };
  std::priority_queue<Entry, std::vector<Entry>, decltype(worse)> heap(worse);

  auto inc = [&](int32_t a, int32_t b, int32_t w, int32_t i) {
    uint64_t k = pkey(a, b);
    int64_t c = ++count[k];
    occ[k].push_back({w, i});
    heap.push({c, a, b});
  };
  auto dec = [&](int32_t a, int32_t b) { --count[pkey(a, b)]; };

  for (int32_t w = 0; w < static_cast<int32_t>(words.size()); ++w) {
    auto& W = words[w];
    for (int32_t i = 0; i + 1 < static_cast<int32_t>(W.sym.size()); ++i)
      inc(W.sym[i], W.sym[i + 1], w, i);
  }

  std::vector<std::string> merged_pieces;
  while (static_cast<int64_t>(merged_pieces.size()) < n_merges &&
         !heap.empty()) {
    Entry e = heap.top();
    heap.pop();
    uint64_t k = pkey(e.a, e.b);
    auto it = count.find(k);
    int64_t cur = (it == count.end()) ? 0 : it->second;
    if (cur != e.c) {
      // Stale snapshot. Re-push at the live count so the pair stays
      // selectable after decrements (increments push their own entries).
      if (cur >= 2) heap.push({cur, e.a, e.b});
      continue;
    }
    // Valid top == the global max live count; nothing mergeable remains.
    if (cur < 2) break;
    // Over-long concatenations are never merged (naive skips them in its
    // scan); drop the entry — future increments re-push, and get dropped.
    if (slen[e.a] + slen[e.b] > max_piece_len) continue;

    const int32_t A = e.a, B = e.b;
    const int32_t M = sym_id(syms[A] + syms[B]);
    merged_pieces.push_back(syms[M]);

    auto list = std::move(occ[k]);
    // Greedy left-to-right application within each word, exactly as the
    // naive scan: in a self-pair chain "A A A" the (0,1) occurrence merges
    // and (1,2) dies. Creation-order appends can be unsorted, so sort.
    std::sort(list.begin(), list.end());
    for (auto [w, i] : list) {
      auto& W = words[w];
      if (W.sym[i] != A) continue;  // node dead or rewritten since recording
      int32_t j = W.nxt[i];
      if (j < 0 || W.sym[j] != B) continue;
      int32_t p = W.prv[i], q = W.nxt[j];
      if (p >= 0) {
        dec(W.sym[p], A);
        inc(W.sym[p], M, w, p);
      }
      if (q >= 0) {
        dec(B, W.sym[q]);
        inc(M, W.sym[q], w, i);
      }
      W.sym[i] = M;
      W.nxt[i] = q;
      if (q >= 0) W.prv[q] = i;
      W.sym[j] = -1;  // dead
    }
    count.erase(k);
    occ.erase(k);
  }
  return merged_pieces;
}

}  // namespace

std::vector<Piece> TrainBpe(const std::vector<std::string>& sentences,
                            int vocab_size,
                            const std::vector<std::string>& user_defined,
                            const std::vector<std::string>& control,
                            int max_piece_len, bool naive) {
  TrainPrep prep =
      PrepTrainCorpus(sentences, vocab_size, user_defined, control);
  std::vector<std::string> merged_pieces =
      naive ? MergeLoopNaive(prep.corpus, prep.n_merges, max_piece_len)
            : MergeLoopFast(prep.corpus, prep.n_merges, max_piece_len);
  std::vector<Piece>& pieces = prep.pieces;
  std::map<std::string, int64_t>& char_freq = prep.char_freq;

  // merged pieces: score = -rank (matches the reference vocab layout)
  float score = 0.0f;
  for (const auto& mp : merged_pieces) pieces.push_back({mp, score--, kNormal});
  // single chars at the end, frequency order (ties lexicographic)
  std::vector<std::pair<int64_t, std::string>> chars_sorted;
  for (auto& [ch, f] : char_freq) chars_sorted.push_back({-f, ch});
  std::sort(chars_sorted.begin(), chars_sorted.end());
  for (auto& [negf, ch] : chars_sorted) {
    if (static_cast<int>(pieces.size()) >= vocab_size) break;
    bool dup = false;
    for (auto& p : pieces)
      if (p.piece == ch) { dup = true; break; }
    if (!dup) pieces.push_back({ch, score--, kNormal});
  }
  return pieces;
}

}  // namespace obt
