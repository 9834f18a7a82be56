// Native text encoding: tokenize + vocab lookup + sos/truncate/eos/pad in
// one pass over a batch of ASCII strings.
//
// The reference runs tokenization inside its training loops
// (pytorch_lstm.py:148, pytorch_machine_translator.py:156-161) on
// torchtext's native pipelines; this framework hoists preprocessing out of
// the hot loop (SURVEY.md §7 hard parts), and this translation unit is the
// C++ fast path for that host-side work — the exact semantics of
// data/text.py's TextPipeline chain (VocabTransform → AddToken(sos) →
// Truncate → AddToken(eos) → PadToLength) for the two built-in tokenizers.
// Parity with the Python path is pinned by tests/test_native.py; any byte
// sequence outside ASCII falls back to Python at the call site.
//
// C ABI only (ctypes caller; no pybind11 in the image — see native/__init__).

#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

std::mutex g_mu;
std::unordered_map<int64_t, std::unordered_map<std::string, int32_t>> g_vocabs;
int64_t g_next_handle = 1;

inline bool is_word(char c) {
  return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_';
}

inline char ascii_lower(char c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32) : c;
}

inline bool is_space(char c) {
  // Python str whitespace within ASCII: \t\n\v\f\r, space, and the
  // \x1c-\x1f separator controls (chr(i).isspace() — re \s matches them on
  // str patterns too).
  return c == ' ' || (c >= '\t' && c <= '\r') ||
         (static_cast<unsigned char>(c) >= 0x1c &&
          static_cast<unsigned char>(c) <= 0x1f);
}

// (ptr, len) views; owned tokens live in the deque (reference-stable).
using TokenSink = std::vector<std::pair<const char*, size_t>>;

// word_punct: lowercase, then \w+|[^\w\s] (ASCII semantics of the Python
// regex in data/text.py — the call site guarantees ASCII input).
void tokenize_word_punct(const std::string& text, TokenSink& out) {
  size_t i = 0, n = text.size();
  while (i < n) {
    char c = text[i];
    if (is_space(c)) {
      ++i;
    } else if (is_word(c)) {
      size_t start = i;
      while (i < n && is_word(text[i])) ++i;
      out.emplace_back(text.data() + start, i - start);
    } else {
      out.emplace_back(text.data() + i, 1);
      ++i;
    }
  }
}

// basic_english: the torchtext rule set reproduced by data/text.py
// (_BASIC_PATTERNS) — sequential substitutions whose only observable effect
// after the final whitespace split is: "'" becomes its own token,
// double-quotes are REMOVED (gluing neighbors), . , ( ) ! ? become their
// own tokens, "<br />" ; : become separators. The caller must pass text
// with double-quotes ALREADY stripped: the Python rule order deletes them
// (pattern 3) before the "<br />" match (pattern 5), so a quote embedded
// in the tag ('<br" />') must not defeat the tag scan.
void tokenize_basic_english(const std::string& text, TokenSink& out,
                            std::deque<std::string>& owned) {
  std::string cur;
  size_t i = 0, n = text.size();
  auto flush = [&]() {
    if (!cur.empty()) {
      owned.emplace_back(std::move(cur));
      out.emplace_back(owned.back().data(), owned.back().size());
      cur.clear();
    }
  };
  while (i < n) {
    // literal "<br />" acts as a separator
    if (text[i] == '<' && i + 6 <= n &&
        std::memcmp(text.data() + i, "<br />", 6) == 0) {
      flush();
      i += 6;
      continue;
    }
    char c = text[i];
    if (is_space(c)) {
      flush();
    } else if (c == '\'' || c == '.' || c == ',' || c == '(' || c == ')' ||
               c == '!' || c == '?') {
      flush();
      out.emplace_back(text.data() + i, 1);
    } else if (c == ';' || c == ':') {
      flush();
    } else {
      cur.push_back(c);
    }
    ++i;
  }
  flush();
}

}  // namespace

extern "C" {

// blob: '\n'-separated tokens in index order (tokens never contain '\n' —
// they come from whitespace-splitting tokenizers).
int64_t mlspark_text_vocab_create(const char* blob, int64_t len) {
  std::unordered_map<std::string, int32_t> m;
  int32_t idx = 0;
  const char* start = blob;
  const char* end = blob + len;
  for (const char* p = blob;; ++p) {
    if (p == end || *p == '\n') {
      m.emplace(std::string(start, static_cast<size_t>(p - start)), idx++);
      start = p + 1;
      if (p == end) break;
    }
  }
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next_handle++;
  g_vocabs[h] = std::move(m);
  return h;
}

void mlspark_text_vocab_free(int64_t handle) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_vocabs.erase(handle);
}

// Encode n texts (concatenated in buf; offsets has n+1 entries) into
// out[n, fixed_len]. mode: 0 = basic_english, 1 = word_punct. Sequence per
// row: ([sos?] + ids) truncated to max_seq_len, then [eos?], everything
// clipped to fixed_len (the PadToLength clip — eos silently dropped when
// it lands past the width), then pad. Returns 0, or -1 (bad handle) /
// -2 (bad mode).
int64_t mlspark_text_encode(
    int64_t handle, const char* buf, const int64_t* offsets, int64_t n,
    int32_t mode, int32_t max_seq_len, int32_t fixed_len, int32_t add_sos,
    int32_t add_eos, int32_t sos_id, int32_t eos_id, int32_t pad_id,
    int32_t default_index, int32_t* out) {
  const std::unordered_map<std::string, int32_t>* vocab;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_vocabs.find(handle);
    if (it == g_vocabs.end()) return -1;
    vocab = &it->second;
  }
  if (mode != 0 && mode != 1) return -2;

  std::string lowered, key;
  TokenSink tokens;
  std::deque<std::string> owned;
  // All writes are bounded by the row width: ([sos?] + ids) truncates to
  // max_seq_len (the Truncate step), and PadToLength's final clip means
  // nothing — eos included — lands at or past fixed_len. Mirrors the
  // Python chain exactly even for fixed_len < max_seq_len.
  const int32_t limit = max_seq_len < fixed_len ? max_seq_len : fixed_len;
  for (int64_t row = 0; row < n; ++row) {
    lowered.clear();
    const char* src = buf + offsets[row];
    const size_t srclen = static_cast<size_t>(offsets[row + 1] - offsets[row]);
    lowered.reserve(srclen);
    for (size_t k = 0; k < srclen; ++k) {
      char c = ascii_lower(src[k]);
      // basic_english deletes double-quotes BEFORE any other rule (see
      // tokenize_basic_english's contract); word_punct keeps them.
      if (mode == 0 && c == '"') continue;
      lowered.push_back(c);
    }
    tokens.clear();
    owned.clear();
    if (mode == 0) {
      tokenize_basic_english(lowered, tokens, owned);
    } else {
      tokenize_word_punct(lowered, tokens);
    }

    int32_t* dst = out + row * fixed_len;
    int32_t pos = 0;
    if (add_sos && pos < limit) dst[pos++] = sos_id;
    for (auto& tok : tokens) {
      if (pos >= limit) break;
      key.assign(tok.first, tok.second);
      auto it = vocab->find(key);
      dst[pos++] = (it == vocab->end()) ? default_index : it->second;
    }
    if (add_eos && pos < fixed_len) dst[pos++] = eos_id;
    while (pos < fixed_len) dst[pos++] = pad_id;
  }
  return 0;
}

}  // extern "C"
