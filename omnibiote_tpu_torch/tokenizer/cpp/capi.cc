// C ABI for the tokenizer core (consumed via ctypes from Python).
// Batch encode runs on a std::thread pool — the host-side packing pipeline
// must keep a TPU fed (SURVEY.md "hard parts": host tokenization throughput).
#include <cstdio>
#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

#include "spm.h"

extern "C" {

void* obt_spm_load(const char* path, char* err_buf, int err_len) {
  auto* m = new obt::SpmModel();
  std::string err;
  if (!m->Load(path, &err)) {
    std::snprintf(err_buf, err_len, "%s", err.c_str());
    delete m;
    return nullptr;
  }
  return m;
}

void obt_spm_free(void* h) { delete static_cast<obt::SpmModel*>(h); }

int obt_spm_vocab_size(void* h) {
  return static_cast<obt::SpmModel*>(h)->vocab_size();
}

int obt_spm_unk_id(void* h) {
  return static_cast<obt::SpmModel*>(h)->unk_id();
}

// Encode one string; returns number of ids (clipped to max_ids).
int obt_spm_encode(void* h, const char* text, int text_len, int* out_ids,
                   int max_ids) {
  auto* m = static_cast<obt::SpmModel*>(h);
  std::vector<int> ids = m->Encode(std::string(text, text_len));
  int n = std::min<int>(ids.size(), max_ids);
  std::memcpy(out_ids, ids.data(), n * sizeof(int));
  return static_cast<int>(ids.size());
}

// Batch encode with a thread pool. texts: concatenated; offsets: n+1 entries.
// out_ids: flat buffer of capacity `cap` per item at stride `cap`.
// out_lens receives true lengths (may exceed cap -> truncated output).
void obt_spm_encode_batch(void* h, const char* texts, const long* offsets,
                          int n, int* out_ids, int cap, int* out_lens,
                          int n_threads) {
  auto* m = static_cast<obt::SpmModel*>(h);
  std::atomic<int> next{0};
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      std::string text(texts + offsets[i], offsets[i + 1] - offsets[i]);
      std::vector<int> ids = m->Encode(text);
      int k = std::min<int>(ids.size(), cap);
      std::memcpy(out_ids + static_cast<long>(i) * cap, ids.data(),
                  k * sizeof(int));
      out_lens[i] = static_cast<int>(ids.size());
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// Decode ids to text; returns bytes written (clipped to max_len).
int obt_spm_decode(void* h, const int* ids, int n, char* out, int max_len) {
  auto* m = static_cast<obt::SpmModel*>(h);
  std::string s = m->Decode(std::vector<int>(ids, ids + n));
  int k = std::min<int>(s.size(), max_len);
  std::memcpy(out, s.data(), k);
  return static_cast<int>(s.size());
}

// Surface form of one piece; returns byte length.
int obt_spm_id_to_piece(void* h, int id, char* out, int max_len) {
  auto* m = static_cast<obt::SpmModel*>(h);
  if (id < 0 || id >= m->vocab_size()) return -1;
  const std::string& p = m->id_to_piece(id);
  int k = std::min<int>(p.size(), max_len);
  std::memcpy(out, p.data(), k);
  return static_cast<int>(p.size());
}

int obt_spm_piece_to_id(void* h, const char* piece) {
  return static_cast<obt::SpmModel*>(h)->piece_to_id(piece);
}

float obt_spm_score(void* h, int id) {
  return static_cast<obt::SpmModel*>(h)->score(id);
}

int obt_spm_piece_type(void* h, int id) {
  return static_cast<obt::SpmModel*>(h)->type(id);
}

// Train a BPE model from newline-joined sentences; writes model file.
// Returns 0 on success. naive != 0 selects the O(merges * corpus) oracle
// loop; 0 the fast trainer (identical output, parity-tested).
int obt_spm_train_ex(const char* sentences, long sentences_len,
                     int vocab_size, const char* user_defined_csv,
                     const char* control_csv, int max_piece_len,
                     const char* out_path, int naive) {
  std::vector<std::string> sents;
  const char* p = sentences;
  const char* end = sentences + sentences_len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) nl = end;
    if (nl > p) sents.emplace_back(p, nl - p);
    p = nl + 1;
  }
  auto split_csv = [](const char* s) {
    std::vector<std::string> out;
    if (!s) return out;
    std::string cur;
    for (; *s; ++s) {
      if (*s == ',') {
        if (!cur.empty()) out.push_back(cur);
        cur.clear();
      } else {
        cur.push_back(*s);
      }
    }
    if (!cur.empty()) out.push_back(cur);
    return out;
  };
  auto pieces = obt::TrainBpe(sents, vocab_size, split_csv(user_defined_csv),
                              split_csv(control_csv), max_piece_len,
                              naive != 0);
  std::string blob =
      obt::SpmModel::Serialize(pieces, "identity", true, true);
  FILE* f = std::fopen(out_path, "wb");
  if (!f) return 1;
  // a short write (disk full / quota) must fail loudly: a truncated model
  // would otherwise report training success and fail only at load time
  size_t written = std::fwrite(blob.data(), 1, blob.size(), f);
  int close_rc = std::fclose(f);
  if (written != blob.size() || close_rc != 0) {
    std::remove(out_path);
    return 2;
  }
  return 0;
}

int obt_spm_train(const char* sentences, long sentences_len, int vocab_size,
                  const char* user_defined_csv, const char* control_csv,
                  int max_piece_len, const char* out_path) {
  return obt_spm_train_ex(sentences, sentences_len, vocab_size,
                          user_defined_csv, control_csv, max_piece_len,
                          out_path, 0);
}

}  // extern "C"
