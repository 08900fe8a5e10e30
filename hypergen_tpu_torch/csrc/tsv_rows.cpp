// Native row formatter for the `dist` and `search` TSVs.
//
// Writes each row `ref_name \t query_name \t ANI \n` into one caller-owned
// byte buffer (reference:src/utils.rs:276-286 prints the ANI as "{:.3f}").
// The names come pre-encoded: one byte array per name list, each name
// followed by its tab, and an offsets array [n + 1] into it.
//
// The ANI is printed from its integer thousandths llrint((double)v * 1000):
// a float32's 24-bit significand times 1000 (7 significant bits) is exact in
// a double, so rounding that product to the nearest integer, ties to even,
// is the correctly rounded '%.3f' of the float32's value, ties included.
//
// Exposed via a C ABI for ctypes:
//   hg_tsv_capacity(...) -> an upper bound of the rows' bytes, or < 0
//   hg_tsv_rows(...)     -> the bytes written
//
// Build: hypergen_tpu_torch/ops/kernels/build.py at first use
// (g++ -O3 -shared -fPIC tsv_rows.cpp)

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// "1000.000\n": the widest value line, once v rounds up to 1000
constexpr long long kMaxValueBytes = 9;

inline bool printable(float v) {
  return std::isfinite(v) && !std::signbit(v) && v < 1000.0f;
}

}  // namespace

extern "C" {

// An upper bound of the bytes hg_tsv_rows writes for these n rows: the
// names' bytes and kMaxValueBytes a row. -1 if an index lies outside its
// name list, -2 if a value is not finite, is negative (-0.0 included) or
// is 1000 or more; the caller then formats these rows another way.
long long hg_tsv_capacity(const int64_t* ref_off, long long n_ref,
                          const int64_t* q_off, long long n_q,
                          const int64_t* ref_idx, const int64_t* q_idx,
                          const float* vals, long long n) {
  long long total = 0;
  for (long long i = 0; i < n; i++) {
    const int64_t r = ref_idx[i], q = q_idx[i];
    if (r < 0 || r >= n_ref || q < 0 || q >= n_q) return -1;
    if (!printable(vals[i])) return -2;
    total += (ref_off[r + 1] - ref_off[r]) + (q_off[q + 1] - q_off[q]) +
             kMaxValueBytes;
  }
  return total;
}

// Write the rows into out, which holds hg_tsv_capacity's bytes for the
// same arguments (which must have returned >= 0). Returns the bytes
// written.
long long hg_tsv_rows(const uint8_t* ref_bytes, const int64_t* ref_off,
                      const uint8_t* q_bytes, const int64_t* q_off,
                      const int64_t* ref_idx, const int64_t* q_idx,
                      const float* vals, long long n, uint8_t* out) {
  uint8_t* p = out;
  for (long long i = 0; i < n; i++) {
    const int64_t r = ref_idx[i], q = q_idx[i];
    const size_t lr = static_cast<size_t>(ref_off[r + 1] - ref_off[r]);
    memcpy(p, ref_bytes + ref_off[r], lr);
    p += lr;
    const size_t lq = static_cast<size_t>(q_off[q + 1] - q_off[q]);
    memcpy(p, q_bytes + q_off[q], lq);
    p += lq;
    const long long t = llrint(static_cast<double>(vals[i]) * 1000.0);
    long long whole = t / 1000;
    const int frac = static_cast<int>(t % 1000);
    char digits[8];
    int nd = 0;
    do {
      digits[nd++] = static_cast<char>('0' + whole % 10);
      whole /= 10;
    } while (whole);
    while (nd) *p++ = static_cast<uint8_t>(digits[--nd]);
    p[0] = '.';
    p[1] = static_cast<uint8_t>('0' + frac / 100);
    p[2] = static_cast<uint8_t>('0' + frac / 10 % 10);
    p[3] = static_cast<uint8_t>('0' + frac % 10);
    p[4] = '\n';
    p += 5;
  }
  return static_cast<long long>(p - out);
}

}  // extern "C"
