// Native streaming reader for the 13-key columnar dataset JSON
// (the read side of native/dataset_writer.cpp; schema defined by the
// reference's datagen output, OpenPyStruct_BeamOpt_training_SingleCore.py:73-87).
//
// The grammar is a strict subset of JSON: one top-level object whose values
// are arrays of numbers or arrays of arrays of numbers.  A hand-rolled
// single-pass parser fills per-key flat value buffers plus row offsets —
// ~10x faster than CPython's json.load on multi-GB datasets and without the
// per-element PyObject overhead (a 1M-sample file holds ~500M floats; as
// Python lists that is tens of GB of boxed objects).
//
// Plain-C ABI for ctypes (pybind11 is not available in the build image).

#include <cctype>
#include <charconv>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Column {
  std::vector<double> vals;
  std::vector<long long> offs;  // rows + 1 boundaries into vals
  bool scalar = false;          // rows are bare numbers, not arrays
};

struct Doc {
  std::unordered_map<std::string, Column> cols;
};

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool expect(char c) {
    ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    ok = false;
    return false;
  }

  bool peek(char c) {
    ws();
    return p < end && *p == c;
  }

  bool parse_string(std::string& out) {
    ws();
    if (p >= end || *p != '"') return ok = false;
    ++p;
    out.clear();
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) ++p;  // keys are plain ASCII here
      out.push_back(*p++);
    }
    if (p >= end) return ok = false;
    ++p;  // closing quote
    return true;
  }

  bool parse_number(double& out) {
    ws();
    const char* q;
    auto res = std::from_chars(p, end, out);
    q = res.ptr;
    if (res.ec != std::errc() || q == p) {
      // from_chars handles the JSON number grammar incl. exponents; a
      // failure here is malformed input
      return ok = false;
    }
    p = q;
    return true;
  }

  // skip any non-numeric value (true/false/null/string/object) so unknown
  // keys don't abort the parse
  void skip_value() {
    ws();
    if (p >= end) return;
    char c = *p;
    if (c == '"') {
      std::string s;
      parse_string(s);
    } else if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      bool instr = false;
      while (p < end) {
        char d = *p++;
        if (instr) {
          if (d == '\\' && p < end) ++p;
          else if (d == '"') instr = false;
        } else if (d == '"') {
          instr = true;
        } else if (d == open) {
          ++depth;
        } else if (d == close) {
          if (--depth == 0) break;
        }
      }
    } else {
      while (p < end && *p != ',' && *p != '}' && *p != ']') ++p;
    }
  }

  bool parse_column(Column& col) {
    if (!expect('[')) return false;
    col.offs.push_back(0);
    ws();
    if (peek(']')) {
      ++p;
      return true;
    }
    while (ok) {
      ws();
      if (p < end && *p == '[') {
        ++p;  // row array
        ws();
        if (!peek(']')) {
          double v;
          while (ok) {
            if (!parse_number(v)) return false;
            col.vals.push_back(v);
            ws();
            if (peek(',')) {
              ++p;
              continue;
            }
            break;
          }
        }
        if (!expect(']')) return false;
      } else {
        double v;
        if (!parse_number(v)) return false;
        col.vals.push_back(v);
        col.scalar = true;
      }
      col.offs.push_back((long long)col.vals.size());
      ws();
      if (peek(',')) {
        ++p;
        continue;
      }
      break;
    }
    return expect(']');
  }

  bool parse_doc(Doc& doc) {
    if (!expect('{')) return false;
    ws();
    if (peek('}')) {
      ++p;
      return true;
    }
    std::string key;
    while (ok) {
      if (!parse_string(key)) return false;
      if (!expect(':')) return false;
      ws();
      if (p < end && *p == '[') {
        Column col;
        if (!parse_column(col)) return false;
        // last occurrence wins, matching Python json.load on duplicate keys
        doc.cols[key] = std::move(col);
      } else {
        skip_value();
      }
      ws();
      if (peek(',')) {
        ++p;
        continue;
      }
      break;
    }
    return expect('}');
  }
};

}  // namespace

extern "C" {

// Returns an opaque handle (nullptr on failure: unreadable file or
// malformed JSON).
void* opsio_read_open(const char* path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return nullptr;
  auto size = f.tellg();
  f.seekg(0);
  std::string buf;
  buf.resize((size_t)size);
  if (!f.read(buf.data(), size)) return nullptr;

  auto* doc = new Doc();
  Parser ps{buf.data(), buf.data() + buf.size()};
  if (!ps.parse_doc(*doc) || !ps.ok) {
    delete doc;
    return nullptr;
  }
  return doc;
}

// rows in a column; -1 if the key is absent
long long opsio_read_rows(void* h, const char* key) {
  auto& cols = static_cast<Doc*>(h)->cols;
  auto it = cols.find(key);
  if (it == cols.end()) return -1;
  return (long long)it->second.offs.size() - 1;
}

long long opsio_read_nvals(void* h, const char* key) {
  auto& cols = static_cast<Doc*>(h)->cols;
  auto it = cols.find(key);
  if (it == cols.end()) return -1;
  return (long long)it->second.vals.size();
}

int opsio_read_is_scalar(void* h, const char* key) {
  auto& cols = static_cast<Doc*>(h)->cols;
  auto it = cols.find(key);
  if (it == cols.end()) return -1;
  return it->second.scalar ? 1 : 0;
}

// Caller allocates vals[nvals] and offs[rows + 1].
int opsio_read_fill(void* h, const char* key, double* vals,
                    long long* offs) {
  auto& cols = static_cast<Doc*>(h)->cols;
  auto it = cols.find(key);
  if (it == cols.end()) return -1;
  const Column& c = it->second;
  std::memcpy(vals, c.vals.data(), c.vals.size() * sizeof(double));
  std::memcpy(offs, c.offs.data(), c.offs.size() * sizeof(long long));
  return 0;
}

void opsio_read_close(void* h) { delete static_cast<Doc*>(h); }

}  // extern "C"
