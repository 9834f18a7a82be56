// Fast libsvm parser — the C++ ingestion path (reference parity: Spark's
// libsvm reader is JVM-native Scala, SURVEY.md §2.2; the framework's
// equivalent is native too).
//
// Format per line:  <label> <index>:<value> ...   (1-based sparse indices,
// '#' comments, blank lines skipped) — the layout of
// $SPARK_HOME/data/mllib/sample_multiclass_classification_data.txt read at
// mllib_multilayer_perceptron_classifier.py:22-23.
//
// C ABI, two-phase: parse_file() returns an opaque handle + dims, copy()
// writes into caller-allocated (numpy) buffers, free() releases. Errors are
// reported through the err buffer; the handle is null on failure.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ParseResult {
  std::vector<double> labels;
  // CSR-ish: per-row list of (col, value)
  std::vector<int64_t> row_offsets;  // size n_rows + 1
  std::vector<int64_t> cols;         // 0-based
  std::vector<float> vals;
  int64_t n_features = 0;
};

void set_err(char* err, int64_t err_len, const std::string& msg) {
  if (err && err_len > 0) {
    std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
  }
}

// strtod sets ERANGE for subnormal results too (which are valid values the
// Python parser accepts); only overflow to ±HUGE_VAL is a real error.
bool strtod_failed(const char* start, const char* after, double value) {
  if (after == start) return true;
  return errno == ERANGE && std::fabs(value) == HUGE_VAL;
}

}  // namespace

extern "C" {

void* mlspark_libsvm_parse(const char* text, int64_t text_len,
                           int64_t* n_rows, int64_t* n_features,
                           char* err, int64_t err_len) {
  auto result = new ParseResult();
  result->row_offsets.push_back(0);

  const char* p = text;
  const char* end = text + text_len;
  int64_t lineno = 0;

  while (p < end) {
    ++lineno;
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;

    // Strip comments.
    const char* eff_end = static_cast<const char*>(
        std::memchr(p, '#', static_cast<size_t>(line_end - p)));
    if (!eff_end) eff_end = line_end;

    // Skip leading whitespace.
    while (p < eff_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    if (p >= eff_end) {  // blank / comment-only line
      p = line_end + 1;
      continue;
    }

    char* after = nullptr;
    errno = 0;
    double label = std::strtod(p, &after);
    if (strtod_failed(p, after, label)) {
      set_err(err, err_len,
              "malformed libsvm line " + std::to_string(lineno) +
                  ": bad label");
      delete result;
      return nullptr;
    }
    p = after;
    result->labels.push_back(label);

    // index:value pairs
    while (true) {
      while (p < eff_end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
      if (p >= eff_end) break;
      errno = 0;
      long long idx = std::strtoll(p, &after, 10);
      if (after == p || *after != ':' || idx < 1 || errno == ERANGE) {
        set_err(err, err_len,
                "malformed libsvm line " + std::to_string(lineno) +
                    ": bad index (must be 1-based int followed by ':')");
        delete result;
        return nullptr;
      }
      p = after + 1;  // past ':'
      // The value must start immediately after ':' within this line —
      // strtod's own whitespace skip would otherwise run across the newline
      // and silently consume the NEXT line's label as this value.
      if (p >= eff_end || *p == ' ' || *p == '\t' || *p == '\r') {
        set_err(err, err_len,
                "malformed libsvm line " + std::to_string(lineno) +
                    ": missing value after ':'");
        delete result;
        return nullptr;
      }
      errno = 0;
      double value = std::strtod(p, &after);
      if (after > eff_end || strtod_failed(p, after, value)) {
        set_err(err, err_len,
                "malformed libsvm line " + std::to_string(lineno) +
                    ": bad value");
        delete result;
        return nullptr;
      }
      p = after;
      result->cols.push_back(idx - 1);
      result->vals.push_back(static_cast<float>(value));
      if (idx > result->n_features) result->n_features = idx;
    }
    result->row_offsets.push_back(
        static_cast<int64_t>(result->cols.size()));
    p = line_end + 1;
  }

  *n_rows = static_cast<int64_t>(result->labels.size());
  *n_features = result->n_features;
  return result;
}

// Densify into caller-allocated buffers: features [n_rows, n_features]
// float32 zero-initialized by the caller, labels [n_rows] float64.
void mlspark_libsvm_copy(void* handle, float* features, double* labels,
                         int64_t n_features) {
  auto* r = static_cast<ParseResult*>(handle);
  const int64_t n = static_cast<int64_t>(r->labels.size());
  std::memcpy(labels, r->labels.data(), sizeof(double) * r->labels.size());
  for (int64_t i = 0; i < n; ++i) {
    float* row = features + i * n_features;
    for (int64_t k = r->row_offsets[i]; k < r->row_offsets[i + 1]; ++k) {
      row[r->cols[static_cast<size_t>(k)]] = r->vals[static_cast<size_t>(k)];
    }
  }
}

void mlspark_libsvm_free(void* handle) {
  delete static_cast<ParseResult*>(handle);
}

}  // extern "C"
