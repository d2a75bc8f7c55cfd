// SentencePiece-compatible BPE tokenizer core (C++17, no dependencies).
//
// Native replacement for the sentencepiece C++ library used by the
// reference (sentencepiece==0.2.0; every eval loads tokenizers/*.model,
// e.g. the reference's evals/gue.py:275). Implements:
//   * ModelProto wire-format parsing (pieces, trainer spec, normalizer spec)
//   * nmt_nfkc normalization via the precompiled Darts charsmap
//   * user-defined symbol extraction (control/user pieces are atomic)
//   * BPE encode (score-ordered agglomerative merging, sentencepiece
//     tie-breaking), decode, piece queries
//   * a BPE trainer that produces compatible .model files (fills the
//     reference's missing tokenizer-training step, SURVEY.md C4)
//
// Written from the published SentencePiece file formats and algorithm
// descriptions; no sentencepiece source is copied.
#pragma once

#include <cstdint>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace obt {

enum PieceType : int32_t {
  kNormal = 1,
  kUnknown = 2,
  kControl = 3,
  kUserDefined = 4,
  kByte = 6,
  kUnused = 5,
};

struct Piece {
  std::string piece;
  float score = 0.0f;
  int32_t type = kNormal;
};

// Darts double-array trie over the precompiled charsmap blob.
class CharsMap {
 public:
  // blob = NormalizerSpec.precompiled_charsmap
  void Load(const std::string& blob);
  bool empty() const { return units_.empty(); }
  // Longest-prefix replacement lookup. Returns matched byte length (0 = no
  // match) and sets *out to the replacement string.
  int LongestMatch(const char* s, int len, std::string* out) const;

 private:
  std::vector<uint32_t> units_;
  std::string values_;  // '\0'-separated replacement strings
};

class SpmModel {
 public:
  bool Load(const std::string& path, std::string* err);
  bool LoadFromString(const std::string& data, std::string* err);

  int vocab_size() const { return static_cast<int>(pieces_.size()); }
  const std::string& id_to_piece(int id) const { return pieces_[id].piece; }
  float score(int id) const { return pieces_[id].score; }
  int32_t type(int id) const { return pieces_[id].type; }
  int piece_to_id(const std::string& p) const;
  int unk_id() const { return unk_id_; }

  // Normalize raw text (charsmap + whitespace rules + dummy prefix +
  // whitespace escaping), recording which spans are user-defined symbols.
  std::string Normalize(const std::string& input,
                        std::vector<std::pair<int, int>>* user_spans) const;

  // Full pipeline: normalize + BPE merge + id lookup.
  std::vector<int> Encode(const std::string& input) const;
  // Encode pre-normalized text (no normalization pass).
  std::vector<int> EncodeNormalized(
      const std::string& norm,
      const std::vector<std::pair<int, int>>& user_spans) const;

  // ids -> surface text (control pieces dropped, '▁'->' ', leading space
  // stripped when add_dummy_prefix).
  std::string Decode(const std::vector<int>& ids) const;

  // Serialize a ModelProto (used by the trainer).
  static std::string Serialize(const std::vector<Piece>& pieces,
                               const std::string& normalizer_name,
                               bool add_dummy_prefix,
                               bool remove_extra_whitespaces);

  bool add_dummy_prefix() const { return add_dummy_prefix_; }

 private:
  struct SvHash {
    using is_transparent = void;
    size_t operator()(std::string_view sv) const {
      return std::hash<std::string_view>{}(sv);
    }
  };
  struct SvEq {
    using is_transparent = void;
    bool operator()(std::string_view a, std::string_view b) const {
      return a == b;
    }
  };

  std::vector<Piece> pieces_;
  std::unordered_map<std::string, int, SvHash, SvEq> piece_index_;
  CharsMap charsmap_;
  bool add_dummy_prefix_ = true;
  bool remove_extra_whitespaces_ = true;
  bool escape_whitespaces_ = true;
  int unk_id_ = 0;
  // user-defined / control pieces for prefix matching during normalization
  std::vector<int> matcher_ids_;  // sorted by piece length desc
  std::vector<bool> matcher_first_bytes_;
};

// BPE trainer: builds a vocab of `vocab_size` pieces from sentences.
// character coverage is implicit (all seen chars become single-char pieces).
// naive=true runs the O(n_merges * corpus) reference-shaped loop (the
// semantics oracle); the default fast path is the linked-list + lazy-heap
// trainer with identical output (full-corpus vocab training, DESIGN.md §6).
std::vector<Piece> TrainBpe(const std::vector<std::string>& sentences,
                            int vocab_size,
                            const std::vector<std::string>& user_defined,
                            const std::vector<std::string>& control,
                            int max_piece_len, bool naive = false);

}  // namespace obt
