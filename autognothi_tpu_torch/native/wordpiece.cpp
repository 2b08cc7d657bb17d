// Native WordPiece tokenizer: the host-side hot path of the text pipeline
// (a copy of autognothi_tpu/native/wordpiece.cpp, with one repair).
//
// The pure-Python WordPiece (autognothi_tpu_torch/data/tokenizer.py) is
// the reference implementation; this C++ core is the fast path: greedy
// longest-match WordPiece with "##" continuations over an ASCII basic
// tokenizer (lowercase, whitespace/punct splitting).  Non-ASCII inputs
// fall back to the Python path at the call site, keeping the ids
// identical.  The repair: Python's str.isspace also counts the ASCII
// separators 0x1c-0x1f as whitespace, C's isspace does not, so the copied
// core split "a\x1cb" as one word where the Python path splits it in two;
// is_space below counts them as Python does.
//
// C ABI (ctypes): wp_create / wp_encode / wp_encode_batch / wp_destroy.

#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int64_t> vocab;
  int64_t pad_id = -1, unk_id = -1, cls_id = -1, sep_id = -1;
  size_t max_piece_len = 1;
};

bool is_punct(unsigned char c) {
  return std::ispunct(c) != 0;
}

// str.isspace on ASCII: C's isspace plus the separators 0x1c-0x1f
bool is_space(unsigned char c) {
  return std::isspace(c) != 0 || (c >= 0x1c && c <= 0x1f);
}

// Greedy longest-match wordpiece of a single lowercase word.
void wordpiece(const Tokenizer& tk, const std::string& word,
               std::vector<int64_t>* out) {
  if (word.size() > 100) {
    out->push_back(tk.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int64_t> pieces;
  std::string buf;
  while (start < word.size()) {
    size_t end = word.size();
    int64_t found = -1;
    while (start < end) {
      buf.clear();
      if (start > 0) buf = "##";
      buf.append(word, start, end - start);
      auto it = tk.vocab.find(buf);
      if (it != tk.vocab.end()) {
        found = it->second;
        break;
      }
      --end;
    }
    if (found < 0) {
      out->push_back(tk.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_data, int64_t vocab_len) {
  auto* tk = new Tokenizer();
  std::string data(vocab_data, static_cast<size_t>(vocab_len));
  size_t pos = 0;
  int64_t index = 0;
  while (pos < data.size()) {
    size_t nl = data.find('\n', pos);
    if (nl == std::string::npos) nl = data.size();
    std::string token = data.substr(pos, nl - pos);
    pos = nl + 1;
    if (token.empty()) continue;
    tk->vocab.emplace(token, index);
    if (token.size() > tk->max_piece_len) tk->max_piece_len = token.size();
    if (token == "[PAD]") tk->pad_id = index;
    else if (token == "[UNK]") tk->unk_id = index;
    else if (token == "[CLS]") tk->cls_id = index;
    else if (token == "[SEP]") tk->sep_id = index;
    ++index;
  }
  if (tk->pad_id < 0 || tk->unk_id < 0 || tk->cls_id < 0 || tk->sep_id < 0) {
    delete tk;
    return nullptr;
  }
  return tk;
}

// Encode one ASCII text into ids[max_length] ([CLS] ... [SEP] [PAD]...).
// Returns the number of non-pad positions, or -1 on error.
int64_t wp_encode(void* handle, const char* text, int64_t text_len,
                  int64_t max_length, int64_t* out_ids) {
  if (handle == nullptr) return -1;
  const auto& tk = *static_cast<Tokenizer*>(handle);

  std::vector<int64_t> ids;
  ids.reserve(static_cast<size_t>(max_length));
  ids.push_back(tk.cls_id);

  std::string word;
  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece(tk, word, &ids);
      word.clear();
    }
  };
  for (int64_t i = 0; i < text_len; ++i) {
    unsigned char c = static_cast<unsigned char>(text[i]);
    if (c >= 0x80) return -1;  // non-ASCII: caller falls back to Python
    c = static_cast<unsigned char>(std::tolower(c));
    if (is_space(c)) {
      flush_word();
    } else if (is_punct(c)) {
      flush_word();
      word.push_back(static_cast<char>(c));
      flush_word();
    } else {
      word.push_back(static_cast<char>(c));
    }
  }
  flush_word();

  if (static_cast<int64_t>(ids.size()) > max_length - 1) {
    ids.resize(static_cast<size_t>(max_length - 1));
  }
  ids.push_back(tk.sep_id);
  int64_t real = static_cast<int64_t>(ids.size());
  for (int64_t i = 0; i < max_length; ++i) {
    out_ids[i] = (i < real) ? ids[static_cast<size_t>(i)] : tk.pad_id;
  }
  return real;
}

// Batch encode: texts are NUL-separated; returns number encoded or -1 if any
// text is non-ASCII (caller retries the whole batch in Python).
int64_t wp_encode_batch(void* handle, const char* texts, int64_t texts_len,
                        int64_t n_texts, int64_t max_length,
                        int64_t* out_ids) {
  const char* cursor = texts;
  const char* end = texts + texts_len;
  for (int64_t i = 0; i < n_texts; ++i) {
    size_t len = strnlen(cursor, static_cast<size_t>(end - cursor));
    int64_t got = wp_encode(handle, cursor, static_cast<int64_t>(len),
                            max_length, out_ids + i * max_length);
    if (got < 0) return -1;
    cursor += len + 1;
  }
  return n_texts;
}

void wp_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

}  // extern "C"
