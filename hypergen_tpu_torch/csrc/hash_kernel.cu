// The two hash kernels of the sketch path on Hopper, K1 and K2. They share
// the window math below (Window, roll, hash_window, t1ha2, mm_hash64), which
// must exist once, as in the TPU package (hash_kernel.py, _advance_hash).
//
// K1: the fused front half of the sketch step.
//
// Replaces the TPU Pallas kernel
// hypergen_tpu/ops/pallas/hash_kernel.py::_rolling_packed_kernel, launched
// by hash_packed_rows_pallas. Per cell it unpacks the 2-bit bases, rolls the
// fwd/rc 2-bit keys and the fwd/rc ASCII byte windows, picks the canonical
// strand (rc < fwd), hashes it with t1ha2_atonce (or mm_hash64 of the key),
// keeps h < threshold && pos < pos_end, and writes the survivors into `cap`
// slots per cell together with the true per-cell count. Nothing is dropped
// silently: a count above cap makes the caller rerun with a larger cap.
//
// Geometry and output contract are the JAX launcher's: cell c of chunk i owns
// the k-mer starts [c*lsub, (c+1)*lsub) of that chunk, slot s of (row-chunk
// bn, cell c) lives at [bn][s][c], so the stores of one slot coalesce over
// cells. With the same `cells` the outputs are bit-identical to the TPU
// kernel's, slot for slot.
//
// What bounds it on this card: integer multiply throughput. At k=21 each
// emitting position runs about six 64x64 products (three t1ha2 mixups, each a
// low and a high half, plus the final mix), against 2 bits of input per
// position, so memory traffic is negligible. Native uint64_t and __umul64hi replace the
// TPU's u32-pair emulation. As on the TPU, the k-1 warm-up positions of a
// cell only roll the window and are never hashed; positions past the
// genome's end (the all-'A' padding tail) are not hashed at all.
//
// A simple layout was chosen first: one thread per cell, walking its lsub
// positions in order. Neighbouring threads read packed words lsub/16 apart,
// so the loads do not coalesce; staging a block's words through shared
// memory is later work. The TPU launcher's word relayout (cell-major
// transpose) and its unroll factor have no counterpart here: each thread
// indexes the packed row directly, and the compiler schedules the loop.
//
// K2: the position-dense chunk hash (see rolling_chunks_kernel below).
//
// Replaces the TPU Pallas kernel
// hypergen_tpu/ops/pallas/hash_kernel.py:158 (_rolling_kernel), launched by
// hash_chunks_pallas, whose caller on this path is the sequence-parallel
// sketch (parallel/seqpar.py). Input: uint8 codes [nc, C + k - 1], a code
// >= 4 invalid. Output, position-dense: h u64 [nc, C] and keep u8 [nc, C];
// keep = (the k codes of the window are all valid) && h < threshold, and h
// holds the U64_MAX sentinel where keep is false. A run counter, reset by an
// invalid code, replaces K1's optimistic hashing plus run postfilter; a
// window whose run is short is not hashed at all.
//
// Geometry: one thread per (chunk, cell) of kChunkLsub = 64 positions (the
// last cell of a chunk may be shorter), plus a k-1 warm-up that only rolls.
// The output is dense in positions, so the geometry cannot change it; 64
// positions give 2048 cells for a 131072-position chunk, 2M threads at the
// full-size 1024 chunks (about eight waves of the card's 270K resident
// threads), and keep the warm-up at (k-1)/64 of the rolls.
//
// What bounds it: at 1024 x 131072 positions and k=21 the function reads
// 134 MB of codes and writes 1.07 GB of hashes and 134 MB of keep flags,
// 1.34 GB in all, 0.40 ms at 3.35 TB/s; it does about 50 32-bit integer
// multiply-adds per hashed position (ten 64-bit products of t1ha2 at k=21:
// six low halves of three each, four high halves of about eight), 6.7 G in
// all, 0.40 ms at the 16.7 T/s of 132 SMs x 64 INT32 lanes at 1.98 GHz.
// Bytes bound, by under one per cent: on chip_smoke.py's 2^27 bp genome the
// 1.342 GB take 0.4007 ms and the 6.69 G multiply-adds (one hash for each
// window whose k codes are valid) 0.3995 ms. Each thread writes 64
// consecutive hashes, so the stores of a warp land 512 bytes apart and do
// not coalesce; staging them through shared memory is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kP0 = 0xEC99BF0D8372CAABull;
constexpr uint64_t kP1 = 0x82434FE90EDCEF39ull;
constexpr uint64_t kP2 = 0xD4F06DB99D67BE4Bull;
constexpr uint64_t kP3 = 0xBD9CACC22C6E9571ull;
constexpr uint64_t kP4 = 0x9C06FAF4D023E3ABull;
constexpr uint64_t kP5 = 0xC060724A8424F345ull;
constexpr uint64_t kP6 = 0xCB5AF53AE3AAAC31ull;

__device__ __forceinline__ uint64_t rotr64(uint64_t v, int s) {
  return (v >> s) | (v << (64 - s));
}

// a ^= lo128((b + v) * prime); b += hi128
__device__ __forceinline__ void mixup64(uint64_t& a, uint64_t& b, uint64_t v,
                                        uint64_t prime) {
  const uint64_t t = b + v;
  a ^= t * prime;
  b += __umul64hi(t, prime);
}

__device__ __forceinline__ uint64_t final64(uint64_t a, uint64_t b) {
  const uint64_t x = (a + rotr64(b, 41)) * kP0;
  const uint64_t y = (rotr64(a, 23) + b) * kP6;
  const uint64_t v = x ^ y;
  return (v * kP5) ^ __umul64hi(v, kP5);
}

__device__ __forceinline__ uint64_t mm_hash64(uint64_t key) {
  key = ~key + (key << 21);
  key ^= key >> 24;
  key = key + (key << 3) + (key << 8);
  key ^= key >> 14;
  key = key + (key << 2) + (key << 4);
  key ^= key >> 28;
  return key + (key << 31);
}

// 2-bit code -> ASCII base (A=65 C=67 G=71 T=84)
__device__ __forceinline__ uint64_t ascii_of(uint32_t c) {
  return 65u + (c << 1) + ((c >> 1) << 1) + (c == 3u ? 11u : 0u);
}

// NW = ceil(k/8) little-endian u64 words hold a k-byte ASCII window; bytes
// at index >= k are kept zero, so the last word is already masked to k % 8
// bytes as t1ha2's tail read expects.
template <int NW>
struct Window {
  uint64_t f2 = 0, r2 = 0;  // fwd / rc 2-bit keys, first base most significant
  uint64_t fw[NW] = {};     // fwd bytes: newest at index k-1
  uint64_t rw[NW] = {};     // rc bytes: newest at index 0
};

struct Shape {
  uint64_t kmask;     // low 2k bits
  uint64_t top_mask;  // bytes of the last window word that lie below k
  int rc_shift;       // 2k-2: where the newest rc base enters
  int new_shift;      // 8*((k-1)%8): where the newest fwd byte enters
};

template <int NW>
__device__ __forceinline__ Shape make_shape(int k) {
  Shape sh;
  sh.kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int top_bytes = k - 8 * (NW - 1);
  sh.top_mask = top_bytes == 8 ? ~0ull : (1ull << (8 * top_bytes)) - 1;
  sh.rc_shift = 2 * k - 2;
  sh.new_shift = 8 * ((k - 1) % 8);
  return sh;
}

template <int NW>
__device__ __forceinline__ void roll(Window<NW>& st, uint32_t cb,
                                     const Shape& sh, bool ascii) {
  st.f2 = ((st.f2 << 2) | cb) & sh.kmask;
  st.r2 = (st.r2 >> 2) | (static_cast<uint64_t>(3u - cb) << sh.rc_shift);
  if (!ascii) return;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    uint64_t w = st.fw[q] >> 8;
    if (q + 1 < NW) w |= st.fw[q + 1] << 56;
    st.fw[q] = w;
  }
  st.fw[NW - 1] |= ascii_of(cb) << sh.new_shift;
#pragma unroll
  for (int q = NW - 1; q >= 0; --q) {
    uint64_t w = st.rw[q] << 8;
    if (q > 0) w |= st.rw[q - 1] >> 56;
    st.rw[q] = w;
  }
  st.rw[0] |= ascii_of(3u - cb);
  st.rw[NW - 1] &= sh.top_mask;
}

// t1ha2_atonce over the canonical window, k in (8*(NW-1), 8*NW]: the
// length > 24 / > 16 / > 8 / > 0 branches become static word counts.
template <int NW>
__device__ __forceinline__ uint64_t hash_window(const Window<NW>& st, int k,
                                                uint64_t seed, bool canonical,
                                                bool mmhash) {
  const bool is_rc = canonical && st.r2 < st.f2;
  if (mmhash) return mm_hash64(is_rc ? st.r2 : st.f2);
  uint64_t w[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) w[q] = is_rc ? st.rw[q] : st.fw[q];
  uint64_t a = seed, b = static_cast<uint64_t>(k);
  if constexpr (NW == 4) mixup64(a, b, w[0], kP4);
  if constexpr (NW >= 3) mixup64(b, a, w[NW - 3], kP3);
  if constexpr (NW >= 2) mixup64(a, b, w[NW - 2], kP2);
  mixup64(b, a, w[NW - 1], kP1);
  return final64(a, b);
}

__device__ __forceinline__ uint32_t base_at(const uint32_t* __restrict__ row,
                                            long long p) {
  return (__ldg(row + (p >> 4)) >> ((p & 15) * 2)) & 3u;
}

// One thread per (row, chunk, cell).
template <int NW>
__global__ void __launch_bounds__(128) rolling_packed_kernel(
    const uint32_t* __restrict__ words, long long W,
    const int32_t* __restrict__ n_pos, int n_chunks, int C, int k,
    uint64_t seed, uint64_t threshold, bool canonical, bool mmhash, int cells,
    int cap, long long n_threads, uint64_t* __restrict__ out_h,
    int32_t* __restrict__ out_pos, int32_t* __restrict__ out_cnt) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const int cell = static_cast<int>(tid % cells);
  const long long bn = tid / cells;  // row * n_chunks + chunk
  const int chunk = static_cast<int>(bn % n_chunks);
  const long long b = bn / n_chunks;
  const int lsub = C / cells;
  const int lp0 = cell * lsub;  // chunk-local start of this cell

  // pos_end = clip(n_pos - chunk*C, 0, C); positions at or past it never
  // emit, so the cell hashes only up to there
  long long end = static_cast<long long>(n_pos[b]) -
                  static_cast<long long>(chunk) * C;
  end = end < 0 ? 0 : (end > C ? C : end);
  const int n_emit = static_cast<int>(end) - lp0 < lsub
                         ? static_cast<int>(end) - lp0
                         : lsub;
  int cnt = 0;
  if (n_emit > 0) {
    const Shape sh = make_shape<NW>(k);
    const bool ascii = !mmhash;

    const uint32_t* row = words + b * W;
    const long long p0 = static_cast<long long>(chunk) * C + lp0;
    Window<NW> st;
    for (int t = 0; t < k - 1; ++t) roll(st, base_at(row, p0 + t), sh, ascii);

    const long long slot0 = bn * cap * cells + cell;
    for (int t = 0; t < n_emit; ++t) {
      roll(st, base_at(row, p0 + k - 1 + t), sh, ascii);
      const uint64_t h = hash_window(st, k, seed, canonical, mmhash);
      if (h < threshold) {
        if (cnt < cap) {
          out_h[slot0 + static_cast<long long>(cnt) * cells] = h;
          out_pos[slot0 + static_cast<long long>(cnt) * cells] = lp0 + t;
        }
        ++cnt;
      }
    }
  }
  out_cnt[bn * cells + cell] = cnt;
}


constexpr int kChunkLsub = 64;  // K2 positions per thread

// K2: one thread per (chunk, cell); cell c of a chunk owns the positions
// [c*kChunkLsub, min((c+1)*kChunkLsub, C)).
template <int NW>
__global__ void __launch_bounds__(128) rolling_chunks_kernel(
    const uint8_t* __restrict__ codes, int C, int k, int cells,
    uint64_t seed, uint64_t threshold, bool canonical, bool mmhash,
    long long n_threads, uint64_t* __restrict__ out_h,
    uint8_t* __restrict__ out_keep) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  const int cell = static_cast<int>(tid % cells);
  const long long chunk = tid / cells;
  const int lp0 = cell * kChunkLsub;
  const int n = C - lp0 < kChunkLsub ? C - lp0 : kChunkLsub;
  const Shape sh = make_shape<NW>(k);
  const bool ascii = !mmhash;

  const uint8_t* in = codes + chunk * (C + k - 1) + lp0;
  Window<NW> st;
  int run = 0;  // valid codes ending here, within this cell's window
  for (int t = 0; t < k - 1; ++t) {
    const uint32_t c = __ldg(in + t);
    run = c < 4u ? run + 1 : 0;
    roll(st, c & 3u, sh, ascii);
  }
  uint64_t* oh = out_h + chunk * C + lp0;
  uint8_t* ok = out_keep + chunk * C + lp0;
  for (int t = 0; t < n; ++t) {
    const uint32_t c = __ldg(in + k - 1 + t);
    run = c < 4u ? run + 1 : 0;
    roll(st, c & 3u, sh, ascii);
    uint64_t h = ~0ull;
    if (run >= k) {
      const uint64_t v = hash_window(st, k, seed, canonical, mmhash);
      if (v < threshold) h = v;
    }
    oh[t] = h;
    ok[t] = h != ~0ull;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Pointers are device pointers of
// contiguous tensors: words u32 [B, W], n_pos i32 [B]; out_h u64 and out_pos
// i32 [B*n_chunks, cap, cells], pre-filled with the empty-slot markers;
// out_cnt i32 [B*n_chunks, cells]. Launches on `stream` without
// synchronising and returns cudaGetLastError(); the caller makes the
// tensors' device current.
extern "C" int hg_hash_packed_rows(
    const void* words, long long W, const void* n_pos, int B, int n_chunks,
    int C, int k, unsigned long long seed, unsigned long long threshold,
    int canonical, int mmhash, int cells, int cap, void* out_h, void* out_pos,
    void* out_cnt, void* stream) {
  const long long n_threads = static_cast<long long>(B) * n_chunks * cells;
  constexpr int kBlock = 128;
  const unsigned grid =
      static_cast<unsigned>((n_threads + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* np = static_cast<const int32_t*>(n_pos);
  auto* oh = static_cast<uint64_t*>(out_h);
  auto* op = static_cast<int32_t*>(out_pos);
  auto* oc = static_cast<int32_t*>(out_cnt);
#define HG_LAUNCH(NW)                                                       \
  rolling_packed_kernel<NW><<<grid, kBlock, 0, s>>>(                        \
      w, W, np, n_chunks, C, k, seed, threshold, canonical != 0,            \
      mmhash != 0, cells, cap, n_threads, oh, op, oc)
  switch ((k + 7) / 8) {
    case 1: HG_LAUNCH(1); break;
    case 2: HG_LAUNCH(2); break;
    case 3: HG_LAUNCH(3); break;
    case 4: HG_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point of K2, bound with ctypes. Pointers are device pointers
// of contiguous tensors: codes u8 [nc, C + k - 1]; out_h u64 and out_keep u8
// [nc, C], every element written by the kernel. Launches on `stream`
// without synchronising and returns cudaGetLastError().
extern "C" int hg_hash_chunks(const void* codes, long long nc, int C, int k,
                              unsigned long long seed,
                              unsigned long long threshold, int canonical,
                              int mmhash, void* out_h, void* out_keep,
                              void* stream) {
  const int cells = (C + kChunkLsub - 1) / kChunkLsub;
  const long long n_threads = nc * cells;
  constexpr int kBlock = 128;
  const unsigned grid =
      static_cast<unsigned>((n_threads + kBlock - 1) / kBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* in = static_cast<const uint8_t*>(codes);
  auto* oh = static_cast<uint64_t*>(out_h);
  auto* ok = static_cast<uint8_t*>(out_keep);
#define HG_LAUNCH(NW)                                                       \
  rolling_chunks_kernel<NW><<<grid, kBlock, 0, s>>>(                        \
      in, C, k, cells, seed, threshold, canonical != 0, mmhash != 0,        \
      n_threads, oh, ok)
  switch ((k + 7) / 8) {
    case 1: HG_LAUNCH(1); break;
    case 2: HG_LAUNCH(2); break;
    case 3: HG_LAUNCH(3); break;
    case 4: HG_LAUNCH(4); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HG_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
