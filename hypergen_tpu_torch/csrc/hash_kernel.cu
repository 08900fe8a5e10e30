// The two hash kernels of the sketch path on Hopper, K1 and K2. They share
// the window math below (Window, roll, hash_window, t1ha2, mm_hash64), which
// must exist once, as in the TPU package (hash_kernel.py, _advance_hash).
//
// The window math. A window keeps only the fwd and rc 2-bit keys (first
// base most significant), rolled by one base per position. t1ha2 reads the
// canonical strand's k ASCII bytes; they are built from the 2-bit key only
// for the position being hashed: the rc key XOR the k-mask is the fwd
// strand with base i at bits 2i (and the fwd key XOR the mask the rc strand
// so), so one key holds the canonical strand in byte order, and a 256-entry
// table in shared memory turns each byte of it (four codes) into four ASCII
// bytes. This replaces rolling two NW-word byte windows at every position
// (about 37 instructions a roll, 212 in the emitting loop, counted in the
// SASS of the first CUDA version of these kernels, sm_90a). Both kernels
// are bound by this hashing, not by the multiplies alone: the table lookups
// move work from the integer ALU to the load/store pipe, which made both
// faster on the H100 than spreading the codes to nibbles and mapping them
// with PRMT (PERF.md).
//
// K1: the fused front half of the sketch step.
//
// Replaces the TPU Pallas kernel
// hypergen_tpu/ops/pallas/hash_kernel.py::_rolling_packed_kernel, launched
// by hash_packed_rows_pallas. Per cell it unpacks the 2-bit bases, rolls the
// window, picks the canonical strand (rc < fwd), hashes it with t1ha2_atonce
// (or mm_hash64 of the key), keeps h < threshold && pos < pos_end, and
// writes the survivors into `cap` slots per cell. It also writes what the
// wrapper used to add in passes of its own: the empty-slot sentinels (h -1,
// pos -1, valid 0), the chunk offset of each position, and the largest true
// count of a cell per row (cell_max; a count above cap makes the caller
// rerun with a larger cap, nothing is dropped silently).
//
// Geometry and output contract are the JAX launcher's: cell c of chunk i owns
// the k-mer starts [c*lsub, (c+1)*lsub) of that chunk, slot s of (row-chunk
// bn, cell c) lives at [bn][s][c], so the stores of one slot coalesce over
// cells. With the same `cells` the outputs are bit-identical to the TPU
// kernel's, slot for slot.
//
// What bounds it on this card: instruction issue in the hash loop. Memory
// traffic is negligible (2 bits in per position). The bound chip_smoke.py
// states counts the t1ha2 multiply-adds alone; the loop also rolls, builds
// the ASCII words and tests the threshold, and those logic, shift and add
// instructions outnumber the multiplies. So the design cuts instructions
// per position: one thread per cell loads the cell's packed words once (per
// 64 positions a uint4, lanes on neighbouring addresses, and a uint2 of
// halo, when lsub is a multiple of 64; two u32 per 16 positions otherwise)
// and shifts the codes out of registers; the k-1 warm-up positions of a
// cell only roll the two keys, a few instructions each. Neither more
// independent hashes in flight nor a higher occupancy changed its time on
// the H100 (1 to 8 hashes, 48 to 80 registers; PERF.md). Resources
// at k=21, as the CUDA runtime reports them on the H100
// (hg_kernel_resources, chip_smoke.py phase 2): 72 registers, 1 KB of
// shared memory, 7 blocks of 128 threads an SM (occupancy 0.44); 145 static
// SASS instructions a position in the hot loop (cuobjdump), against 212 in
// the first one.
//
// K2: the position-dense chunk hash.
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
// What bounds it: bytes. At 1024 x 131072 positions and k=21 it reads
// 134 MB of codes and writes 1.07 GB of hashes and 134 MB of keep flags,
// 0.40 ms at 3.35 TB/s. Its first version (one thread per 64 positions,
// writing its own hashes) took 9.5 ms there, nearly all of it in its
// stores (PERF.md): each warp store touched 32 sectors 512 bytes
// apart, a few bytes each.
//
// Design: one warp per strip of kStrip = 2048 consecutive positions of a
// chunk, 4 warps a block, no block barrier after the ASCII table's. The warp
// stages the strip's codes and their k-1 halo into shared memory with
// 16-byte loads (lanes on neighbouring addresses). Lane l rolls positions
// [64 l, 64 l + 64) of the strip (a warm-up of k-1 rolls, 31 % more rolls at
// k=21, each a few instructions) and reads its codes 4 at a time: shared
// memory holds the strip with one pad word every 16 words, so the 32 lanes,
// 64 bytes apart, read 32 different banks. It stages its hashes for
// kRound = 16 positions at a time (128 bytes, one line) in shared memory,
// XOR-swizzled so that neither the lanes' 8-byte writes nor the warp's
// 16-byte reads conflict, and the warp writes each round out as full
// 128-byte lines with 16-byte stores on neighbouring addresses. Keep flags
// are packed in registers and written once per strip the same way. Ragged
// shapes: a short last strip, a C that is no multiple of anything, a row
// start that is not 16-byte aligned (its edges then take narrower stores),
// k from 1 to 32. With the stores coalesced, the hashing bounds it, as K1.
// Resources at k=21, as the CUDA runtime reports them on the H100: 79
// registers, 36,560 bytes of static shared memory a block, 6 blocks an SM
// (occupancy 0.375); 145 static SASS instructions a position in the hot
// loop (cuobjdump).

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
constexpr uint32_t kAcgt = 0x54474341u;  // 'A' 'C' 'G' 'T' as bytes 0..3
constexpr int kBlock = 128;

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

struct Window {
  uint64_t f2 = 0, r2 = 0;  // fwd / rc 2-bit keys, first base most significant
};

struct Shape {
  uint64_t kmask;   // low 2k bits
  uint64_t top_mask;  // bytes of the last ASCII word below k
  int rc_shift;     // 2k-2: where the newest rc base enters
  int k;
};

template <int NW>
__device__ __forceinline__ Shape make_shape(int k) {
  Shape sh;
  sh.kmask = k == 32 ? ~0ull : (1ull << (2 * k)) - 1;
  const int top_bytes = k - 8 * (NW - 1);
  sh.top_mask = top_bytes == 8 ? ~0ull : (1ull << (8 * top_bytes)) - 1;
  sh.rc_shift = 2 * k - 2;
  sh.k = k;
  return sh;
}

__device__ __forceinline__ void roll(Window& st, uint32_t cb, const Shape& sh) {
  st.f2 = ((st.f2 << 2) | cb) & sh.kmask;
  st.r2 = (st.r2 >> 2) | (static_cast<uint64_t>(cb ^ 3u) << sh.rc_shift);
}

// The ASCII table: entry i holds the four bases of i (code j at bits 2j)
// as bytes 0..3. Filled by each block before its first hash.
__device__ __forceinline__ void fill_ascii(uint32_t* tbl) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t v = 0;
    for (int j = 0; j < 4; ++j)
      v |= ((kAcgt >> (8 * ((i >> (2 * j)) & 3))) & 0xFFu) << (8 * j);
    tbl[i] = v;
  }
}

// Eight codes (bits 0-15 of src, or bits 16-31 when kHi16) as eight ASCII
// bytes, code j in byte j.
template <bool kHi16>
__device__ __forceinline__ uint64_t ascii8(uint32_t src, const uint32_t* tbl) {
  const uint32_t lo = tbl[kHi16 ? (src >> 16) & 0xFFu : src & 0xFFu];
  const uint32_t hi = tbl[kHi16 ? src >> 24 : (src >> 8) & 0xFFu];
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// t1ha2_atonce over the canonical window, k in (8*(NW-1), 8*NW]: the
// length > 24 / > 16 / > 8 / > 0 branches become static word counts. Word q
// holds bases 8q..8q+7, little-endian; bytes at index >= k are zero, as
// t1ha2's tail read expects.
template <int NW, bool kMm>
__device__ __forceinline__ uint64_t hash_window(const Window& st,
                                                const Shape& sh,
                                                uint64_t seed, bool canonical,
                                                const uint32_t* tbl) {
  const bool is_rc = canonical && st.r2 < st.f2;
  if constexpr (kMm) return mm_hash64(is_rc ? st.r2 : st.f2);
  // the canonical strand, base i at bits 2i
  const uint64_t key = (is_rc ? st.f2 : st.r2) ^ sh.kmask;
  const uint32_t lo = static_cast<uint32_t>(key);
  const uint32_t hi = static_cast<uint32_t>(key >> 32);
  uint64_t w[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    const uint32_t src = q < 2 ? lo : hi;
    w[q] = q % 2 ? ascii8<true>(src, tbl) : ascii8<false>(src, tbl);
  }
  w[NW - 1] &= sh.top_mask;
  uint64_t a = seed, b = static_cast<uint64_t>(sh.k);
  if constexpr (NW == 4) mixup64(a, b, w[0], kP4);
  if constexpr (NW >= 3) mixup64(b, a, w[NW - 3], kP3);
  if constexpr (NW >= 2) mixup64(a, b, w[NW - 2], kP2);
  mixup64(b, a, w[NW - 1], kP1);
  return final64(a, b);
}

// -- K1 -----------------------------------------------------------------------

// One thread per (row, chunk, cell); kVec: the cell's words come as a uint4
// and a uint2 of halo per 64 positions (lsub a multiple of 64, rows 16-byte
// aligned); kMm: mm_hash64 instead of t1ha2. The grid is exactly
// B*n_chunks*cells threads (cells is a multiple of kBlock), so a block never
// spans two rows.
template <int NW, bool kVec, bool kMm>
__global__ void __launch_bounds__(kBlock) rolling_packed_kernel(
    const uint32_t* __restrict__ words, long long W,
    const int32_t* __restrict__ n_pos, int n_chunks, int C, int k,
    uint64_t seed, uint64_t threshold, bool canonical, int cells, int cap,
    uint64_t* __restrict__ out_h, int32_t* __restrict__ out_pos,
    uint8_t* __restrict__ out_valid, int32_t* __restrict__ out_cell_max) {
  __shared__ uint32_t s_ascii[256];
  fill_ascii(s_ascii);
  __syncthreads();
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cell = static_cast<int>(tid % cells);
  const long long bn = tid / cells;  // row * n_chunks + chunk
  const int chunk = static_cast<int>(bn % n_chunks);
  const long long b = bn / n_chunks;
  const int lsub = C / cells;
  const int lp0 = cell * lsub;  // chunk-local start of this cell
  const long long gp0 = static_cast<long long>(chunk) * C + lp0;

  // pos_end = clip(n_pos - chunk*C, 0, C); positions at or past it never
  // emit, so the cell hashes only up to there
  long long end = static_cast<long long>(n_pos[b]) -
                  static_cast<long long>(chunk) * C;
  end = end < 0 ? 0 : (end > C ? C : end);
  const int n_emit = static_cast<int>(end) - lp0 < lsub
                         ? static_cast<int>(end) - lp0
                         : lsub;
  const long long slot0 = bn * cap * cells + cell;
  int cnt = 0;
  if (n_emit > 0) {
    const Shape sh = make_shape<NW>(k);
    const uint32_t* src = words + b * W + (gp0 >> 4);
    Window st;
    {  // warm-up: codes [0, k-1) of the cell only roll
      uint64_t buf = __ldg(src);
      if (k - 1 > 16) buf |= static_cast<uint64_t>(__ldg(src + 1)) << 32;
      for (int j = 0; j < k - 1; ++j, buf >>= 2) roll(st, buf & 3u, sh);
    }
    // position t rolls code t + k - 1: group g of 16 positions takes its
    // codes from words g + sw and g + sw + 1, shifted right by fs bits
    const int sw = (k - 1) >> 4, fs = 2 * ((k - 1) & 15);
    const int n_groups = (n_emit + 15) >> 4;
    uint32_t v[6];  // kVec: words g .. g + 5
#pragma unroll 1
    for (int g = 0; g < n_groups; ++g) {
      uint32_t lo, hi;
      if constexpr (kVec) {
        if ((g & 3) == 0) {
          const uint4 q = __ldg(reinterpret_cast<const uint4*>(src + g));
          const uint2 r = __ldg(reinterpret_cast<const uint2*>(src + g + 4));
          v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w; v[4] = r.x;
          v[5] = r.y;
        }
        lo = sw ? v[1] : v[0];
        hi = sw ? v[2] : v[1];
#pragma unroll
        for (int m = 0; m < 5; ++m) v[m] = v[m + 1];
      } else {
        lo = __ldg(src + g + sw);
        hi = fs ? __ldg(src + g + sw + 1) : 0u;
      }
      const uint32_t codes = __funnelshift_r(lo, hi, fs);
#pragma unroll
      for (int s = 0; s < 16; ++s) {
        roll(st, (codes >> (2 * s)) & 3u, sh);
        const uint64_t h =
            hash_window<NW, kMm>(st, sh, seed, canonical, s_ascii);
        const int t = 16 * g + s;  // the window's k-mer start
        if (h < threshold && t < n_emit) {
          if (cnt < cap) {
            const long long o = slot0 + static_cast<long long>(cnt) * cells;
            out_h[o] = h;
            out_pos[o] = static_cast<int32_t>(gp0 + t);
            out_valid[o] = 1;
          }
          ++cnt;
        }
      }
    }
  }
  for (int s = cnt; s < cap; ++s) {  // the empty slots' sentinels
    const long long o = slot0 + static_cast<long long>(s) * cells;
    out_h[o] = ~0ull;
    out_pos[o] = -1;
    out_valid[o] = 0;
  }
  const int warp_max = __reduce_max_sync(0xFFFFFFFFu, cnt);
  if ((threadIdx.x & 31) == 0 && warp_max > 0)
    atomicMax(out_cell_max + b, warp_max);
}

// -- K2 -----------------------------------------------------------------------

constexpr int kLanePos = 64;               // positions a lane rolls
constexpr int kStrip = 32 * kLanePos;      // positions a warp owns
constexpr int kRound = 16;                 // positions staged per round
constexpr int kWarps = kBlock / 32;
// strip codes + halo (<= 31) + the 16-byte misalignment, in 4-byte words,
// with one pad word after every 16
constexpr int kCodeWords = (kStrip + 31 + 15 + 15) / 16 * 4;
constexpr int kCodeSmem = kCodeWords + kCodeWords / 16 + 1;

__device__ __forceinline__ int pad16(int word) { return word + (word >> 4); }

// word `word` of the staged strip (logical numbering), from padded smem
__device__ __forceinline__ uint32_t code_word(const uint32_t* s, int word) {
  return s[pad16(word)];
}

// Four codes of the lane's stream: bytes [4g + bs, 4g + bs + 4) counted from
// logical word `base` (bs in 0..3).
__device__ __forceinline__ uint32_t four_codes(const uint32_t* s, int base,
                                               int g, int bs) {
  return __funnelshift_r(code_word(s, base + g), code_word(s, base + g + 1),
                         8 * bs);
}

// One warp per strip of kStrip positions of one chunk.
template <int NW, bool kMm>
__global__ void __launch_bounds__(kBlock) rolling_chunks_kernel(
    const uint8_t* __restrict__ codes, long long nc, int C, int k,
    int strips, uint64_t seed, uint64_t threshold, bool canonical,
    uint64_t* __restrict__ out_h,
    uint8_t* __restrict__ out_keep) {
  __shared__ uint32_t s_ascii[256];
  __shared__ uint32_t s_codes[kWarps][kCodeSmem];
  __shared__ __align__(16) uint64_t s_hash[kWarps][32 * kRound];
  // keep flags of the strip, 16 bytes per lane-round, one 16-byte pad per
  // 64 bytes so that the lanes' 16-byte writes do not conflict
  __shared__ __align__(16) uint4 s_keep[kWarps][kStrip / 16 + kStrip / 64];
  fill_ascii(s_ascii);
  __syncthreads();  // the only block barrier: before any warp returns

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long gw = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (gw >= nc * strips) return;  // whole warps only
  const long long chunk = gw / strips;
  const int strip0 = static_cast<int>(gw % strips) * kStrip;
  const int n_s = C - strip0 < kStrip ? C - strip0 : kStrip;  // positions
  const int width = C + k - 1;
  uint32_t* sc = s_codes[warp];

  // stage codes [strip0, strip0 + n_s + k - 1) of this chunk: aligned
  // 16-byte blocks from the one holding the first byte; a block that would
  // leave the tensor is read byte by byte
  {
    const uint8_t* first = codes + chunk * width + strip0;
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(first) & ~uintptr_t{15};
    const uintptr_t lo = reinterpret_cast<uintptr_t>(codes);
    const uintptr_t hi = lo + static_cast<uintptr_t>(nc) * width;
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(first) - a0);
    const int n_blocks = (off + n_s + k - 1 + 15) >> 4;
    for (int q = lane; q < n_blocks; q += 32) {
      const uintptr_t a = a0 + 16 * static_cast<uintptr_t>(q);
      uint32_t v[4];
      if (a >= lo && a + 16 <= hi) {
        const uint4 x = __ldg(reinterpret_cast<const uint4*>(a));
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t w = 0;
          for (int i = 0; i < 4; ++i) {
            const uintptr_t p = a + 4 * m + i;
            if (p >= lo && p < hi)
              w |= static_cast<uint32_t>(
                       __ldg(reinterpret_cast<const uint8_t*>(p)))
                   << (8 * i);
          }
          v[m] = w;
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) sc[pad16(4 * q + m)] = v[m];
    }
    __syncwarp();

    const Shape sh = make_shape<NW>(k);
    const int lp = lane * kLanePos;  // strip-local first position
    const int n = n_s - lp < kLanePos ? (n_s - lp > 0 ? n_s - lp : 0)
                                      : kLanePos;
    Window st;
    int run = 0;  // valid codes ending here, within this lane's stream
    // warm-up: codes [lp, lp + k - 1) only roll
    {
      const int byte0 = off + lp;
      const int base = byte0 >> 2, bs = byte0 & 3;
      for (int g = 0; 4 * g < k - 1; ++g) {
        const uint32_t f = four_codes(sc, base, g, bs);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (4 * g + s < k - 1) {
            const uint32_t c = (f >> (8 * s)) & 0xFFu;
            run = c < 4u ? run + 1 : 0;
            roll(st, c & 3u, sh);
          }
        }
      }
    }
    const int byte0 = off + lp + k - 1;  // the first emitting code
    const int base = byte0 >> 2, bs = byte0 & 3;
    const long long e0 = chunk * C + strip0;  // global index of the strip
    uint64_t* hs = s_hash[warp];
    uint4* ks = s_keep[warp];
    const int sw = lane & 15;  // this lane's hash swizzle
#pragma unroll 1
    for (int r = 0; r < kLanePos / kRound; ++r) {
      uint32_t keep4[4] = {0u, 0u, 0u, 0u};
      if (r * kRound < n) {
#pragma unroll
        for (int g = 0; g < kRound / 4; ++g) {
          const uint32_t f = four_codes(sc, base, r * (kRound / 4) + g, bs);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int i = 4 * g + s;  // position in the round
            const uint32_t c = (f >> (8 * s)) & 0xFFu;
            run = c < 4u ? run + 1 : 0;
            roll(st, c & 3u, sh);
            uint64_t h = ~0ull;
            if (run >= k) {
              const uint64_t v =
                  hash_window<NW, kMm>(st, sh, seed, canonical, s_ascii);
              if (v < threshold) h = v;
            }
            hs[lane * kRound + (i ^ sw)] = h;
            keep4[g] |= static_cast<uint32_t>(h != ~0ull) << (8 * s);
          }
        }
      }
      const int kq = (lp + r * kRound) >> 4;  // the lane-round's keep block
      ks[kq + (kq >> 2)] = make_uint4(keep4[0], keep4[1], keep4[2], keep4[3]);
      __syncwarp();
      // write the round: 32 segments of kRound hashes, segment `sg` at
      // strip position sg * kLanePos + r * kRound, n_seg of them real
      const long long eg0 = e0 + r * kRound;
      if ((reinterpret_cast<uintptr_t>(out_h + eg0) & 15) == 0) {
        // 16-byte stores: 8 lanes per 128-byte segment
        for (int u = lane; u < 32 * kRound / 2; u += 32) {
          const int sg = u / (kRound / 2), m = u % (kRound / 2);
          const int left = n_s - sg * kLanePos - r * kRound;  // real in seg
          if (2 * m >= left) continue;
          const int x = sg & 15;
          const int v0 = (2 * m) ^ (x & ~1);
          ulonglong2 pr =
              *reinterpret_cast<const ulonglong2*>(hs + sg * kRound + v0);
          if (x & 1) {
            const unsigned long long t = pr.x;
            pr.x = pr.y;
            pr.y = t;
          }
          uint64_t* dst = out_h + eg0 + sg * kLanePos + 2 * m;
          if (2 * m + 1 < left) {
            *reinterpret_cast<ulonglong2*>(dst) = pr;
          } else {
            dst[0] = pr.x;
          }
        }
      } else {
        // 8-byte stores: the row start leaves the pairs misaligned
        for (int u = lane; u < 32 * kRound; u += 32) {
          const int sg = u / kRound, i = u % kRound;
          if (i >= n_s - sg * kLanePos - r * kRound) continue;
          out_h[eg0 + sg * kLanePos + i] = hs[sg * kRound + (i ^ (sg & 15))];
        }
      }
      __syncwarp();
    }
    // keep flags of the strip: 16-byte stores where the global address is
    // aligned, bytes at the edges
    {
      const uint8_t* kb = reinterpret_cast<const uint8_t*>(ks);
      uint8_t* dst = out_keep + e0;
      const int head = static_cast<int>(
          (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15);
      if (head == 0) {
        for (int q = lane; q < (n_s >> 4); q += 32)
          *reinterpret_cast<uint4*>(dst + 16 * q) = ks[q + (q >> 2)];
        for (int i = (n_s & ~15) + lane; i < n_s; i += 32) {
          const int q = i >> 4;
          dst[i] = kb[16 * (q + (q >> 2)) + (i & 15)];
        }
      } else {
        for (int i = lane; i < n_s; i += 32) {
          const int q = i >> 4;
          dst[i] = kb[16 * (q + (q >> 2)) + (i & 15)];
        }
      }
    }
  }
}

// The instantiations of one kernel share one signature; NW = ceil(k / 8)
// t1ha2 words, and k outside [1, 32] has none (null).
using PackedKernel = decltype(&rolling_packed_kernel<1, false, false>);
using ChunksKernel = decltype(&rolling_chunks_kernel<1, false>);

template <int NW>
PackedKernel packed_nw(bool vec, bool mm) {
  if (vec)
    return mm ? &rolling_packed_kernel<NW, true, true>
              : &rolling_packed_kernel<NW, true, false>;
  return mm ? &rolling_packed_kernel<NW, false, true>
            : &rolling_packed_kernel<NW, false, false>;
}

PackedKernel packed_kernel(int k, bool vec, bool mm) {
  switch ((k + 7) / 8) {
    case 1: return packed_nw<1>(vec, mm);
    case 2: return packed_nw<2>(vec, mm);
    case 3: return packed_nw<3>(vec, mm);
    case 4: return packed_nw<4>(vec, mm);
    default: return nullptr;
  }
}

template <int NW>
ChunksKernel chunks_nw(bool mm) {
  return mm ? &rolling_chunks_kernel<NW, true>
            : &rolling_chunks_kernel<NW, false>;
}

ChunksKernel chunks_kernel(int k, bool mm) {
  switch ((k + 7) / 8) {
    case 1: return chunks_nw<1>(mm);
    case 2: return chunks_nw<2>(mm);
    case 3: return chunks_nw<3>(mm);
    case 4: return chunks_nw<4>(mm);
    default: return nullptr;
  }
}

// K1 takes its words as a uint4 and a uint2 of halo per 64 positions when
// they are 16-byte aligned (lsub a multiple of 64, a row stride of whole
// uint4s, an aligned base) and two words of slack follow the last cell
bool packed_vec(const void* words, long long W, int n_chunks, int C,
                int cells) {
  return (C / cells) % 64 == 0 && W % 4 == 0 &&
         W >= static_cast<long long>(n_chunks) * (C / 16) + 2 &&
         reinterpret_cast<uintptr_t>(words) % 16 == 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, long long n_threads, cudaStream_t s, Args... args) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid =
      static_cast<unsigned>((n_threads + kBlock - 1) / kBlock);
  kernel<<<grid, kBlock, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point of K1, bound with ctypes. Pointers are device
// pointers of contiguous tensors: words u32 [B, W], n_pos i32 [B]; out_h u64,
// out_pos i32 and out_valid u8 [B*n_chunks, cap, cells], every element
// written by the kernel; out_cell_max i32 [B], zeroed by the caller. cells
// must be a multiple of 128. Launches on `stream` without synchronising and
// returns cudaGetLastError(); the caller makes the tensors' device current.
extern "C" int hg_hash_packed_rows(
    const void* words, long long W, const void* n_pos, int B, int n_chunks,
    int C, int k, unsigned long long seed, unsigned long long threshold,
    int canonical, int mmhash, int cells, int cap, void* out_h, void* out_pos,
    void* out_valid, void* out_cell_max, void* stream) {
  if (cells % kBlock != 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(
      packed_kernel(k, packed_vec(words, W, n_chunks, C, cells), mmhash != 0),
      static_cast<long long>(B) * n_chunks * cells,
      static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(words),
      W, static_cast<const int32_t*>(n_pos), n_chunks, C, k,
      static_cast<uint64_t>(seed), static_cast<uint64_t>(threshold),
      canonical != 0, cells, cap, static_cast<uint64_t*>(out_h),
      static_cast<int32_t*>(out_pos), static_cast<uint8_t*>(out_valid),
      static_cast<int32_t*>(out_cell_max));
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
  const int strips = (C + kStrip - 1) / kStrip;
  return launch(chunks_kernel(k, mmhash != 0), nc * strips * 32,
                static_cast<cudaStream_t>(stream),
                static_cast<const uint8_t*>(codes), nc, C, k, strips,
                static_cast<uint64_t>(seed), static_cast<uint64_t>(threshold),
                canonical != 0, static_cast<uint64_t*>(out_h),
                static_cast<uint8_t*>(out_keep));
}

// What the CUDA runtime reports, on the current device, for the kernel that
// hg_hash_chunks (chunks != 0) or hg_hash_packed_rows (with `vec`, see
// packed_vec) launches for k and mmhash: out = {registers a thread, static
// shared bytes a block, resident blocks an SM, threads a block, threads an
// SM}. Returns a CUDA error code, 0 on success.
extern "C" int hg_kernel_resources(int chunks, int k, int mmhash, int vec,
                                   int* out) {
  const void* fn =
      chunks ? reinterpret_cast<const void*>(chunks_kernel(k, mmhash != 0))
             : reinterpret_cast<const void*>(
                   packed_kernel(k, vec != 0, mmhash != 0));
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  int blocks = 0, dev = 0, per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kBlock, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = blocks;
  out[3] = kBlock;
  out[4] = per_sm;
  return 0;
}
