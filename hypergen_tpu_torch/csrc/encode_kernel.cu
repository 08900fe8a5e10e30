// The HV encode of the sketch step on Hopper: one kernel that bundles each
// row's valid hashes into per-dimension bit counts and turns them into the
// int16 HV and its norm², in one launch, with no memset and no
// per-dimension global atomic.
//
// Replaces XLA code, not a Pallas kernel: hypergen_tpu/ops/encode.py::
// encode_hv (the wyrng expand and its carry-save-adder column counts) with
// hv_to_i16 and hv_norm2_i32, which XLA fuses into the sketch step
// (hypergen_tpu/models/sketcher.py, make_sketch_step), the tiled route's
// encode and the sequence-parallel encode. Per row b, for D = 64 W:
//
//   hv[b, i*64 + j] = sum over valid hashes h of (2 bit_j(word_i(h)) - 1),
//   word_i(h) = wymum(s ^ P1, s), s = h + (i+1) P0 (mod 2^64),
//
// wrapped to int16, and norm2[b] = the wrapping-int32 sum of the squares of
// the int16 values. wymum(a, b) is the low half of the 128-bit product
// XOR its high half.
//
// What bounds it on this card: operations. Input bytes are few (9 a hash
// slot; at the 16-genome step's 8 x 6,144 slots, 0.44 MB); each (valid
// hash, word) pair needs one 64 x 64 -> 128-bit product, four 32 x 32 ->
// 64 partial products (the low half comes from the same partials; the
// carries and the offset's add are ALU adds), which chip_smoke.py counts
// as the bound.
//
// Layout: the grid is (S slabs, G word groups, B rows), S <= 64 chosen by
// the wrapper (ops/kernels/encode_kernel.py::slab_plan). A block of
// kThreads threads takes one row, one group of kWords wyrng words (512
// dimensions) and one slab of the row's tiles of kThreads hash slots:
// tiles s, s + S, s + 2S, ..., so that the valid slots, which the step
// packs at the front of a row, spread evenly over the slabs. Its threads
// are kGroups hash groups of kWords words, thread (q, i) adding hashes q,
// q + kGroups, ... to word i. A tile is loaded with one 8-byte load a
// thread, kAhead tiles ahead of its use; its valid slots are compacted by
// a block-wide ballot into a ring in shared memory, so invalid slots
// (padding and repeats, about 55 % of the step's width) cost no
// arithmetic. Whenever the ring holds a batch of kBatch hashes, each
// thread adds its 16 words of the batch to its counters; the slab's last
// partial batch is padded with zero words, which add no bits.
//
// The carry-save loop: a thread keeps its word's 64 counts bit-sliced in
// kPlanes 64-bit registers. A batch of 16 words enters the planes of
// weight 1, 2, 4 and 8 through a Harley-Seal tree of 15 full adders (one
// LOP3 for the sum and one for the majority on each 32-bit half), and the
// weight-16 carry it leaves ripples once into the kUpper planes above:
// about 5.5 logic operations a word (8-plane ripple before: 32), the bits
// never expanded. When the planes are full (kMaxCount words, or the end of
// the slab) the four threads of a warp that share a word add their planes
// by a butterfly of shuffles and each expands a quarter of the 64
// dimensions, only as many planes as the words seen can fill, into the
// block's counts in shared memory.
//
// The merge, a ticket per word group: each block stores 2 count - n_slab
// (mod 2^32) for its 512 dimensions, plainly and coalesced, into its own
// slot of the scratch (u32 [B, G, S, 512]), then its thread 0 takes a
// ticket on tickets[b, g] behind a __threadfence. The block that draws
// S - 1 sums the S slots (read from L2, __ldcg) into the int16 HV, stores
// its 512 values' sum of squares, resets its ticket and takes one on
// tickets[b, G]; the last of the row's G groups sums the G squares into
// norm2[b] (a uint32 sum, whose wrap is the wrapping-int32 sum) and resets
// that ticket. So a call is one launch, no memset, and at most two atomics
// a block; integer sums are exact in any order, so the result is the same
// bits run after run. The tickets are zero when a launch starts and when
// it ends: the wrapper zeroes them once when it makes its buffer (one per
// device and stream), and every launch leaves them so. No cooperative
// launch and no grid-wide barrier: no block waits for another.
//
// Resources, as the CUDA runtime reports them on the H100
// (hg_encode_resources, chip_smoke.py phase 2): 80 registers, 6,436 B of
// static shared memory, 6 blocks of 128 threads an SM (occupancy 0.375).
// Its times against its bound are in PERF.md §6.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kWyP0 = 0xA0761D6478BD642Full;
constexpr uint64_t kWyP1 = 0xE7037ED1A0B428DBull;
constexpr int kThreads = 128;                 // threads a block, slots a tile
constexpr int kWords = 8;                     // wyrng words a word group
constexpr int kGroups = kThreads / kWords;    // hash groups a block: 16
constexpr int kDims = kWords * 64;            // dimensions a word group
constexpr int kBatch = kGroups * 16;          // hashes a batch: 16 a thread
constexpr int kRing = 512;                    // >= kBatch + kThreads
constexpr int kUpper = 7;                     // planes of weight 16 .. 1024
constexpr int kPlanes = 4 + kUpper;
constexpr int kMaxCount = (1 << kPlanes) - 1;  // words the planes hold
constexpr int kPitch = kWords + 1;            // odd: no bank conflicts
constexpr int kMaxSlabs = 64;
constexpr int kAhead = 4;                     // tiles loaded ahead

// word = wymum(s ^ P1, s), s = h + (i+1) P0: the wyrng word i of hash h
__device__ __forceinline__ uint64_t wyrng_word(uint64_t h, uint64_t off) {
  const uint64_t s = h + off;
  const uint64_t x = s ^ kWyP1;
  return (x * s) ^ __umul64hi(x, s);
}

// full adder on 64 bit lanes: a + b + c = 2 hi + lo
__device__ __forceinline__ void csa(uint64_t& hi, uint64_t& lo, uint64_t a,
                                    uint64_t b, uint64_t c) {
  hi = (a & b) | (a & c) | (b & c);
  lo = a ^ b ^ c;
}

// the word of queued hash q of the batch at head for this thread's hash
// group (0 past the last of a partial batch)
template <bool kPartial>
__device__ __forceinline__ uint64_t batch_word(const uint64_t* ring,
                                               unsigned head, int grp, int k,
                                               int count, uint64_t off) {
  const int q = grp + kGroups * k;
  if (kPartial && q >= count) return 0;
  return wyrng_word(ring[(head + q) & (kRing - 1)], off);
}

// Adds this thread's 16 words of a batch (count hashes queued at head) to
// its planes: pl[0..3] weigh 1, 2, 4, 8 and pl[4 + u] weighs 16 << u.
template <bool kPartial>
__device__ __forceinline__ void add_batch(uint64_t (&pl)[kPlanes],
                                          const uint64_t* ring, unsigned head,
                                          int grp, int count, uint64_t off) {
  uint64_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, sixteens;
#define HG_W(k) batch_word<kPartial>(ring, head, grp, k, count, off)
  csa(twos_a, pl[0], pl[0], HG_W(0), HG_W(1));
  csa(twos_b, pl[0], pl[0], HG_W(2), HG_W(3));
  csa(fours_a, pl[1], pl[1], twos_a, twos_b);
  csa(twos_a, pl[0], pl[0], HG_W(4), HG_W(5));
  csa(twos_b, pl[0], pl[0], HG_W(6), HG_W(7));
  csa(fours_b, pl[1], pl[1], twos_a, twos_b);
  csa(eights_a, pl[2], pl[2], fours_a, fours_b);
  csa(twos_a, pl[0], pl[0], HG_W(8), HG_W(9));
  csa(twos_b, pl[0], pl[0], HG_W(10), HG_W(11));
  csa(fours_a, pl[1], pl[1], twos_a, twos_b);
  csa(twos_a, pl[0], pl[0], HG_W(12), HG_W(13));
  csa(twos_b, pl[0], pl[0], HG_W(14), HG_W(15));
  csa(fours_b, pl[1], pl[1], twos_a, twos_b);
  csa(eights_b, pl[2], pl[2], fours_a, fours_b);
  csa(sixteens, pl[3], pl[3], eights_a, eights_b);
#undef HG_W
#pragma unroll
  for (int p = 4; p < kPlanes; ++p) {
    const uint64_t next = pl[p] & sixteens;
    pl[p] ^= sixteens;
    sixteens = next;
  }
}

constexpr int kSumPlanes = kPlanes + 2;  // four threads' counts

// The counts of the planes of the four threads of a warp that share word
// il (lanes il, il + 8, il + 16, il + 24), added bit-sliced across them by
// a butterfly of shuffles into kNP planes (their sum is below 2^kNP), then
// expanded a quarter of the dimensions a thread into the block's counts
// (dimension j of word il at counts[j * kPitch + il]); the planes are
// cleared. Every lane of the warp calls it.
template <int kNP>
__device__ __forceinline__ void flush_planes(uint64_t (&pl)[kPlanes],
                                             uint32_t* counts, int il) {
  uint64_t a[kNP];
#pragma unroll
  for (int p = 0; p < kNP; ++p) a[p] = p < kPlanes ? pl[p] : 0;
#pragma unroll
  for (int m = 8; m <= 16; m <<= 1) {
    uint64_t carry = 0;
#pragma unroll
    for (int p = 0; p < kNP; ++p) {
      const uint64_t o = __shfl_xor_sync(0xffffffffu, a[p], m);
      const uint64_t sum = a[p] ^ o ^ carry;
      carry = (a[p] & o) | (a[p] & carry) | (o & carry);
      a[p] = sum;
    }
  }
  const int j0 = 16 * ((threadIdx.x & 31) >> 3);
  for (int j = j0; j < j0 + 16; ++j) {
    uint32_t cnt = 0;
#pragma unroll
    for (int p = 0; p < kNP; ++p)
      cnt |= static_cast<uint32_t>((a[p] >> j) & 1u) << p;
    atomicAdd(&counts[j * kPitch + il], cnt);
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) pl[p] = 0;
}

// flush_planes with as many planes as four threads' counts of c words
// each (at most 4c) can fill
__device__ __forceinline__ void flush(uint64_t (&pl)[kPlanes],
                                      uint32_t* counts, int il, int c) {
  if (c < 32) flush_planes<7>(pl, counts, il);
  else if (c < 128) flush_planes<9>(pl, counts, il);
  else if (c < 512) flush_planes<11>(pl, counts, il);
  else flush_planes<kSumPlanes>(pl, counts, il);
}

// The block's sum of v, returned to every thread (red: kThreads / 32).
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();  // every earlier reader of red is done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

// Grid (S, G, B). h u64 [B, N], valid u8 [B, N]; part u32 [B, G, S,
// kDims] then [B, G] (uninitialised); tickets i32 [B, G + 1], zero; hv
// i16 [B, W*64] and norm2 u32 [B], every element written.
__global__ void __launch_bounds__(kThreads) encode_hv_kernel(
    const uint64_t* __restrict__ h, const uint8_t* __restrict__ valid,
    long long N, int W, uint32_t* __restrict__ part,
    int* __restrict__ tickets, int16_t* __restrict__ hv,
    uint32_t* __restrict__ norm2) {
  __shared__ uint64_t ring[kRing];
  __shared__ uint32_t counts[64 * kPitch];
  __shared__ int warp_n[kThreads / 32];
  __shared__ uint32_t red[kThreads / 32];
  __shared__ int last;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int il = t % kWords, grp = t / kWords;
  const int S = gridDim.x, G = gridDim.y;
  const int s = blockIdx.x, g = blockIdx.y;
  const long long b = blockIdx.z, B = gridDim.z;
  const int D = W * 64;
  const int word = g * kWords + il;
  const bool active = word < W;
  const long long tiles = (N + kThreads - 1) / kThreads;
  const uint64_t* hr = h + b * N;
  const uint8_t* vr = valid + b * N;
  for (int e = t; e < 64 * kPitch; e += kThreads) counts[e] = 0;
  __syncthreads();

  const uint64_t off = static_cast<uint64_t>(word + 1) * kWyP0;
  uint64_t pl[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) pl[p] = 0;
  int c = 0;              // words in the planes since the last flush
  uint32_t n_slab = 0;    // valid slots of the slab
  unsigned head = 0, tail = 0;  // queued hashes: ring[head .. tail)
  // this thread's slot of the slab's next kAhead tiles, loaded ahead
  uint64_t xq[kAhead];
  bool vq[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const long long e = (s + static_cast<long long>(k) * S) * kThreads + t;
    vq[k] = e < N && vr[e] != 0;
    xq[k] = e < N ? hr[e] : 0;
  }
  for (long long tile0 = s; tile0 < tiles;
       tile0 += static_cast<long long>(kAhead) * S) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const long long tile = tile0 + static_cast<long long>(k) * S;
      if (tile >= tiles) break;
      const bool v = vq[k];
      const uint64_t x = xq[k];
      const long long en =
          (tile + static_cast<long long>(kAhead) * S) * kThreads + t;
      vq[k] = en < N && vr[en] != 0;
      xq[k] = en < N ? hr[en] : 0;
      // (the last tile's readers of warp_n and writers of the ring are
      // past its second barrier)
      const unsigned ballot = __ballot_sync(0xffffffffu, v);
      if (lane == 0) warp_n[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, n = 0;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        n += warp_n[w];
      }
      if (v)
        ring[(tail + before + __popc(ballot & ((1u << lane) - 1u))) &
             (kRing - 1)] = x;
      __syncthreads();
      tail += n;
      n_slab += n;
      if (tail - head >= static_cast<unsigned>(kBatch)) {
        if (c + 16 > kMaxCount) {
          flush(pl, counts, il, c);
          c = 0;
        }
        if (active) add_batch<false>(pl, ring, head, grp, kBatch, off);
        c += 16;
        head += kBatch;
      }
    }
  }
  if (tail != head) {
    if (c + 16 > kMaxCount) {
      flush(pl, counts, il, c);
      c = 0;
    }
    if (active)
      add_batch<true>(pl, ring, head, grp, static_cast<int>(tail - head),
                      off);
    c += 16;
  }
  flush(pl, counts, il, c);
  __syncthreads();

  // this block's slot of the scratch: for dimensions e = 4t .. 4t + 3 of
  // the group (e = il * 64 + j), 2 count - n_slab mod 2^32, whose sum over
  // the slabs is 2 count - n_valid; one 16-byte store a thread
  static_assert(kDims == 4 * kThreads, "a thread stores 4 dimensions");
  const long long bg = b * G + g;
  uint32_t* gsq = part + B * G * S * kDims;
  const int il4 = t >> 4;  // the word of e = 4t
  uint4 mine;
  mine.x = 2u * counts[((4 * t) & 63) * kPitch + il4] - n_slab;
  mine.y = 2u * counts[((4 * t + 1) & 63) * kPitch + il4] - n_slab;
  mine.z = 2u * counts[((4 * t + 2) & 63) * kPitch + il4] - n_slab;
  mine.w = 2u * counts[((4 * t + 3) & 63) * kPitch + il4] - n_slab;
  reinterpret_cast<uint4*>(part + (bg * S + s) * kDims)[t] = mine;
  __syncthreads();
  if (t == 0) {
    __threadfence();  // the block's stores, seen through the barrier
    last = atomicAdd(&tickets[b * (G + 1) + g], 1) == S - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // the last slab of (b, g): the S slots summed into the int16 HV (a
  // count wraps mod 2^32 only above 2^32 hashes; the int16 wrap keeps the
  // value mod 2^16 either way), and their squares into gsq[b, g]
  const uint4* slots = reinterpret_cast<const uint4*>(part + bg * S * kDims);
  uint4 sum = make_uint4(0, 0, 0, 0);
#pragma unroll 8
  for (int q = 0; q < S; ++q) {
    const uint4 u = __ldcg(&slots[q * kThreads + t]);
    sum.x += u.x;
    sum.y += u.y;
    sum.z += u.z;
    sum.w += u.w;
  }
  const uint32_t four[4] = {sum.x, sum.y, sum.z, sum.w};
  uint64_t packed = 0;
  uint32_t sq = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint16_t v16 = static_cast<uint16_t>(four[k]);
    const int32_t sv = static_cast<int16_t>(v16);
    packed |= static_cast<uint64_t>(v16) << (16 * k);
    sq += static_cast<uint32_t>(sv * sv);
  }
  const int d = g * kDims + 4 * t;  // a word's 64 dimensions: all or none
  if (d < D) *reinterpret_cast<uint64_t*>(hv + b * D + d) = packed;
  else sq = 0;
  sq = block_sum(sq, red);
  if (t == 0) {
    gsq[bg] = sq;
    tickets[b * (G + 1) + g] = 0;
    __threadfence();
    last = atomicAdd(&tickets[b * (G + 1) + G], 1) == G - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // the row's last group: norm2[b], the sum of its groups' squares mod 2^32
  uint32_t total = 0;
  for (int q = t; q < G; q += kThreads) total += __ldcg(&gsq[b * G + q]);
  total = block_sum(total, red);
  if (t == 0) {
    norm2[b] = total;
    tickets[b * (G + 1) + G] = 0;
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers of contiguous
// tensors: h u64 [B, N], valid u8 [B, N] (0 or 1); scratch u32 of
// scratch_words >= B*G*(S*512 + 1) (G = ceil(D / 512); uninitialised,
// 16-byte aligned); tickets i32 of ticket_words >= B*(G+1), zero on entry
// and left zero; out_hv i16 [B, D] and out_norm2 i32 [B], every element
// written. D a positive multiple of 64 with G at most 65535, B at most
// 65535; S slabs a row, 1 to 64. Launches one kernel on `stream` without
// synchronising (none for B = 0) and returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments outside these bounds; the caller
// makes the tensors' device current.
extern "C" int hg_encode_hv_i16(const void* h, const void* valid,
                                long long B, long long N, int D, int S,
                                void* scratch, long long scratch_words,
                                void* tickets, long long ticket_words,
                                void* out_hv, void* out_norm2, void* stream) {
  const long long G = (D + kDims - 1) / kDims;
  if (D <= 0 || D % 64 != 0 || G > 65535 || B < 0 || B > 65535 || N < 0 ||
      S < 1 || S > kMaxSlabs || scratch_words < B * G * (S * kDims + 1) ||
      ticket_words < B * (G + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const dim3 grid(S, static_cast<unsigned>(G), static_cast<unsigned>(B));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  encode_hv_kernel<<<grid, kThreads, 0, st>>>(static_cast<const uint64_t*>(h), static_cast<const uint8_t*>(valid), N, D / 64, static_cast<uint32_t*>(scratch), static_cast<int*>(tickets), static_cast<int16_t*>(out_hv), static_cast<uint32_t*>(out_norm2));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's geometry, which the wrapper's slab plan and buffer sizes
// assume: out = {hash slots a tile, dimensions a word group, slabs a row
// at most}.
extern "C" void hg_encode_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kDims;
  out[2] = kMaxSlabs;
}

// What the CUDA runtime reports, on the current device, for the encode
// kernel: out = {registers a thread, static shared bytes a block, resident
// blocks an SM, threads a block, threads an SM}. Returns a CUDA error
// code, 0 on success.
extern "C" int hg_encode_resources(int* out) {
  const void* fn = reinterpret_cast<const void*>(encode_hv_kernel);
  cudaFuncAttributes attr;
  int blocks = 0, dev = 0, per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = per_sm;
  return 0;
}
