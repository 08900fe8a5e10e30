// Native FASTA -> 2-bit base-code parser (runtime data-loader component).
//
// Equivalent role to the reference's needletail-based reader + GPU merged
// reader (reference:src/fastx_reader.rs:6-29, reference:src/sketch.rs:76-95):
// parses (optionally gzipped) FASTA, normalizes bases (case-insensitive
// ACGT, U->T), maps everything else to the invalid code 4, and joins records
// with a single invalid separator so k-mers never span records.
//
// Exposed via a C ABI for ctypes (no pybind11 dependency):
//   hg_read_genome_codes(path, &buf, errbuf, errlen) -> n_codes or -1
//   hg_free(buf)
//
// Build: hypergen_tpu_torch/ops/kernels/build.py at first use
// (g++ -O3 -shared -fPIC fastx.cpp -lz)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

constexpr uint8_t INVALID = 4;
constexpr size_t CHUNK = 1 << 20;

struct CodeTable {
  uint8_t map[256];
  CodeTable() {
    for (int i = 0; i < 256; i++) map[i] = INVALID;
    map['A'] = map['a'] = 0;
    map['C'] = map['c'] = 1;
    map['G'] = map['g'] = 2;
    map['T'] = map['t'] = 3;
    map['U'] = map['u'] = 3;  // uridine normalizes to thymine
  }
};
const CodeTable kTable;

struct Buf {
  uint8_t* data = nullptr;
  size_t len = 0;
  size_t cap = 0;
  bool push(uint8_t c) {
    if (len == cap) {
      size_t ncap = cap ? cap * 2 : (1 << 22);
      uint8_t* nd = static_cast<uint8_t*>(realloc(data, ncap));
      if (!nd) return false;
      data = nd;
      cap = ncap;
    }
    data[len++] = c;
    return true;
  }
  bool reserve(size_t extra) {
    if (len + extra <= cap) return true;
    size_t ncap = cap ? cap : (1 << 22);
    while (ncap < len + extra) ncap *= 2;
    uint8_t* nd = static_cast<uint8_t*>(realloc(data, ncap));
    if (!nd) return false;
    data = nd;
    cap = ncap;
    return true;
  }
};

void set_err(char* errbuf, int errlen, const char* msg) {
  if (errbuf && errlen > 0) {
    snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg);
  }
}

}  // namespace

extern "C" {

// Parse a FASTA file into a malloc'd code array. Returns the number of
// codes, or -1 on error (message in errbuf). Caller frees with hg_free.
long long hg_read_genome_codes(const char* path, uint8_t** out,
                               char* errbuf, int errlen) {
  *out = nullptr;
  gzFile f = gzopen(path, "rb");  // transparently handles plain + gzip
  if (!f) {
    set_err(errbuf, errlen, "cannot open file");
    return -1;
  }
  gzbuffer(f, 1 << 20);

  Buf buf;
  uint8_t* chunk = static_cast<uint8_t*>(malloc(CHUNK));
  if (!chunk) {
    gzclose(f);
    set_err(errbuf, errlen, "out of memory");
    return -1;
  }

  bool in_header = false;
  bool at_line_start = true;
  long long n_records = 0;
  bool ok = true;
  const char* err = nullptr;

  int n;
  while (ok && (n = gzread(f, chunk, CHUNK)) > 0) {
    if (!buf.reserve(static_cast<size_t>(n) + 1)) {
      ok = false;
      err = "out of memory";
      break;
    }
    for (int i = 0; i < n; i++) {
      uint8_t c = chunk[i];
      if (c == '\n') {
        in_header = false;
        at_line_start = true;
        continue;
      }
      if (c == '\r') continue;
      if (at_line_start && c == '>') {
        if (n_records > 0) buf.data[buf.len++] = INVALID;  // record separator
        n_records++;
        in_header = true;
        at_line_start = false;
        continue;
      }
      at_line_start = false;
      if (in_header) continue;
      if (n_records == 0) {
        ok = false;
        err = "sequence data before FASTA header";
        break;
      }
      buf.data[buf.len++] = kTable.map[c];
    }
  }
  if (ok && n < 0) {
    ok = false;
    err = "read/decompress error";
  }
  if (ok && n_records == 0) {
    ok = false;
    err = "no FASTA records found";
  }
  free(chunk);
  gzclose(f);
  if (!ok) {
    free(buf.data);
    set_err(errbuf, errlen, err ? err : "parse error");
    return -1;
  }
  *out = buf.data;
  return static_cast<long long>(buf.len);
}

void hg_free(uint8_t* p) { free(p); }

// Fused parse + pack: FASTA bytes -> 2-bit packed codes + invalid-run list
// in ONE streaming pass, no intermediate code array (the codes array was a
// 4x-size temporary that every genome paid for twice: C++ write + numpy
// copy). Returns the genome length in codes (n), with ceil(n/4) bytes in
// *packed_out (2-bit fields little-endian within each byte; invalid
// positions carry code&3 — validity comes solely from the run list) and
// *n_runs_out [start,end) int64 pairs in *runs_out covering every invalid
// position in [0, n) (int64: a genome may hold 2^31 codes or more). -1 on
// error. Caller frees both with hg_free.
long long hg_read_genome_packed(const char* path, uint8_t** packed_out,
                                int64_t** runs_out, long long* n_runs_out,
                                char* errbuf, int errlen) {
  *packed_out = nullptr;
  *runs_out = nullptr;
  *n_runs_out = 0;
  gzFile f = gzopen(path, "rb");
  if (!f) {
    set_err(errbuf, errlen, "cannot open file");
    return -1;
  }
  gzbuffer(f, 1 << 20);

  Buf packed;
  Buf runs;  // raw bytes holding int64 pairs
  uint8_t* chunk = static_cast<uint8_t*>(malloc(CHUNK));
  if (!chunk) {
    gzclose(f);
    set_err(errbuf, errlen, "out of memory");
    return -1;
  }

  bool in_header = false;
  bool at_line_start = true;
  long long n_records = 0;
  long long n = 0;          // codes emitted
  uint8_t cur = 0;          // current packed byte under construction
  long long run_start = -1; // open invalid run
  bool ok = true;
  const char* err = nullptr;

  auto emit = [&](uint8_t code) -> bool {
    bool inv = code >= INVALID;
    if (inv && run_start < 0) run_start = n;
    if (!inv && run_start >= 0) {
      if (!runs.reserve(16)) return false;
      int64_t* r = reinterpret_cast<int64_t*>(runs.data + runs.len);
      r[0] = static_cast<int64_t>(run_start);
      r[1] = static_cast<int64_t>(n);
      runs.len += 16;
      run_start = -1;
    }
    cur = static_cast<uint8_t>(cur | ((code & 3) << (2 * (n & 3))));
    n++;
    if ((n & 3) == 0) {
      if (!packed.push(cur)) return false;
      cur = 0;
    }
    return true;
  };

  int rd;
  while (ok && (rd = gzread(f, chunk, CHUNK)) > 0) {
    for (int i = 0; i < rd; i++) {
      uint8_t c = chunk[i];
      if (c == '\n') {
        in_header = false;
        at_line_start = true;
        continue;
      }
      if (c == '\r') continue;
      if (at_line_start && c == '>') {
        if (n_records > 0 && !emit(INVALID)) {  // record separator
          ok = false;
          err = "out of memory";
          break;
        }
        n_records++;
        in_header = true;
        at_line_start = false;
        continue;
      }
      at_line_start = false;
      if (in_header) continue;
      if (n_records == 0) {
        ok = false;
        err = "sequence data before FASTA header";
        break;
      }
      if (!emit(kTable.map[c])) {
        ok = false;
        err = "out of memory";
        break;
      }
    }
  }
  if (ok && rd < 0) {
    ok = false;
    err = "read/decompress error";
  }
  if (ok && n_records == 0) {
    ok = false;
    err = "no FASTA records found";
  }
  if (ok && (n & 3) != 0) ok = packed.push(cur);  // flush partial byte
  if (ok && run_start >= 0) {                     // close trailing run
    ok = runs.reserve(16);
    if (ok) {
      int64_t* r = reinterpret_cast<int64_t*>(runs.data + runs.len);
      r[0] = static_cast<int64_t>(run_start);
      r[1] = static_cast<int64_t>(n);
      runs.len += 16;
    } else {
      err = "out of memory";
    }
  }
  free(chunk);
  gzclose(f);
  if (!ok) {
    free(packed.data);
    free(runs.data);
    set_err(errbuf, errlen, err ? err : "parse error");
    return -1;
  }
  *packed_out = packed.data;
  *runs_out = reinterpret_cast<int64_t*>(runs.data);
  *n_runs_out = static_cast<long long>(runs.len / 16);
  return n;
}

}  // extern "C"
