// The HV encode of the sketch step on Hopper: one kernel that bundles each
// row's valid hashes into per-dimension bit counts, and a small tail kernel
// that turns the counts into the int16 HV and its norm².
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
// as the bound. The JAX package's CSA tree spends the TPU's vector lanes
// on the 64 bits; here one thread owns one word index i (64 dimensions)
// and keeps its 64 counts bit-sliced in
// kPlanes 64-bit registers: a word is added to them with a ripple of
// kPlanes AND/XOR pairs, 32 32-bit logic operations, the bits never
// expanded. Every 255 hashes at most (the planes' range) the planes are
// expanded once into counts in shared memory.
//
// Layout: a block of kThreads threads takes one row and a slab of hash
// slots. Its threads are `groups` groups of `wpb` words (wpb = min(W,
// kThreads); gridDim.y covers W > kThreads): thread (g, i) adds hashes g,
// g + groups, ... of each tile to word i. A tile of kThreads slots is
// loaded with one 8-byte load a thread (neighbouring threads on
// neighbouring addresses), its valid slots compacted into shared memory by
// a block-wide ballot, so invalid slots (padding and repeats, about 55 % of
// the step's width) cost no arithmetic and every thread's loop over the
// tile is the same length. The slab is chosen on the host so that the
// launch has about kTargetBlocks blocks (the 16-genome step's 8 x 6,144
// slots: 192 blocks of 256 slots; the 2.18 Gbp genome's 1.45 M hashes:
// 947 of 1,536). A block's counts go to an int32 [B, D] accumulator
// with one integer atomicAdd a dimension; integer sums are exact in any
// order, so the result is the same bits run after run. The accumulator
// and the norms are zeroed on the stream (cudaMemsetAsync), so nothing
// reads the device from the host. The tail kernel writes 2 acc - n_valid
// wrapped to int16 and adds the squares into norm2 with unsigned
// atomicAdd, whose wrap mod 2^32 is the wrapping-int32 sum. Resources at
// D=4096, as the CUDA runtime reports them on the H100 (hg_encode_resources,
// chip_smoke.py phase 2): 46 registers, 1,040 B static and 16,640 B dynamic
// shared memory, 10 blocks of 128 threads an SM (occupancy 0.625). Its time
// against its bound is in PERF.md: about 120x at the step's shape (launch
// latency), about 15x at 1.45 M hashes (the ripple's logic operations and
// the 64-bit product's carries, beside four multiplies a word).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint64_t kWyP0 = 0xA0761D6478BD642Full;
constexpr uint64_t kWyP1 = 0xE7037ED1A0B428DBull;
constexpr int kThreads = 128;  // threads a block, and hash slots a tile
constexpr int kPlanes = 8;     // bit planes a thread: counts up to 255
constexpr int kMaxCount = (1 << kPlanes) - 1;
constexpr int kMinTiles = 2;   // tiles a slab at least
constexpr long long kTargetBlocks = 1024;
constexpr int kTailThreads = 256;

// word = wymum(s ^ P1, s), s = h + (i+1) P0: the wyrng word i of hash h
__device__ __forceinline__ uint64_t wyrng_word(uint64_t h, uint64_t off) {
  const uint64_t s = h + off;
  const uint64_t x = s ^ kWyP1;
  return (x * s) ^ __umul64hi(x, s);
}

// The counts of the planes, one dimension j at a time, added into the
// block's counts (dimension j of local word il at counts[j * pitch + il]:
// neighbouring threads on neighbouring words); the planes are cleared.
__device__ __forceinline__ void flush(uint64_t (&plane)[kPlanes],
                                      uint32_t* counts, int il, int pitch) {
  for (int j = 0; j < 64; ++j) {
    uint32_t cnt = 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      cnt |= static_cast<uint32_t>((plane[p] >> j) & 1u) << p;
    atomicAdd(&counts[j * pitch + il], cnt);
  }
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) plane[p] = 0;
}

// Grid (slabs, word blocks, rows). h u64 [B, N], valid u8 [B, N]; acc u32
// [B, W*64] and n_valid u32 [B] zeroed beforehand. Dynamic shared memory:
// 64 * (wpb | 1) u32 counts.
__global__ void __launch_bounds__(kThreads) encode_hv_kernel(
    const uint64_t* __restrict__ h, const uint8_t* __restrict__ valid,
    long long N, int W, int wpb, long long slab, uint32_t* __restrict__ acc,
    uint32_t* __restrict__ n_valid) {
  extern __shared__ uint32_t counts[];
  __shared__ uint64_t tile[kThreads];
  __shared__ int warp_n[kThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int groups = kThreads / wpb;
  const int g = t / wpb;
  const int il = t % wpb;
  const int word = blockIdx.y * wpb + il;
  const bool active = g < groups && word < W;
  const int pitch = wpb | 1;  // odd: neither pass over counts conflicts
  const long long row = blockIdx.z;
  const long long lo = blockIdx.x * slab;
  const long long hi = lo + slab < N ? lo + slab : N;
  const uint64_t* hr = h + row * N;
  const uint8_t* vr = valid + row * N;
  for (int e = t; e < 64 * pitch; e += kThreads) counts[e] = 0;
  const uint64_t off = static_cast<uint64_t>(word + 1) * kWyP0;
  uint64_t plane[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) plane[p] = 0;
  int c = 0;             // hashes added to the planes since the last flush
  uint32_t n_slab = 0;   // valid slots of the slab
  for (long long base = lo; base < hi; base += kThreads) {
    const long long e = base + t;
    const bool v = e < hi && vr[e] != 0;
    const uint64_t x = v ? hr[e] : 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, v);
    __syncthreads();  // the previous tile's readers are done
    if (lane == 0) warp_n[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (v) tile[before + __popc(ballot & ((1u << lane) - 1u))] = x;
    __syncthreads();
    n_slab += n;
    if (!active) continue;
    const int mine = (n - g + groups - 1) / groups;  // 0 when n <= g
    if (c + mine > kMaxCount) {
      flush(plane, counts, il, pitch);
      c = 0;
    }
    for (int j = g; j < n; j += groups) {
      uint64_t carry = wyrng_word(tile[j], off);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const uint64_t next = plane[p] & carry;
        plane[p] ^= carry;
        carry = next;
      }
    }
    c += mine;
  }
  if (active) flush(plane, counts, il, pitch);
  __syncthreads();
  // dimension d = word * 64 + j: neighbouring threads on neighbouring d
  const int W64 = W * 64;
  uint32_t* ar = acc + row * W64;
  for (int e = t; e < wpb * 64; e += kThreads) {
    const int wl = e >> 6, j = e & 63;
    const int wd = blockIdx.y * wpb + wl;
    if (wd < W) atomicAdd(&ar[wd * 64 + j], counts[j * pitch + wl]);
  }
  if (t == 0 && blockIdx.y == 0) atomicAdd(&n_valid[row], n_slab);
}

// Grid (ceil(D / kTailThreads), rows): hv = 2 acc - n_valid wrapped to
// int16; norm2 (zeroed beforehand) += the squares, mod 2^32.
__global__ void __launch_bounds__(kTailThreads) encode_tail_kernel(
    const uint32_t* __restrict__ acc, const uint32_t* __restrict__ n_valid,
    int D, int16_t* __restrict__ hv, uint32_t* __restrict__ norm2) {
  __shared__ uint32_t part[kTailThreads / 32];
  const long long row = blockIdx.y;
  const int d = blockIdx.x * kTailThreads + threadIdx.x;
  uint32_t sq = 0;
  if (d < D) {
    const uint32_t v = 2u * acc[row * D + d] - n_valid[row];
    const int16_t v16 = static_cast<int16_t>(static_cast<uint16_t>(v));
    hv[row * D + d] = v16;
    sq = static_cast<uint32_t>(static_cast<int32_t>(v16) * v16);
  }
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = sq;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t s = 0;
    for (int w = 0; w < kTailThreads / 32; ++w) s += part[w];
    atomicAdd(&norm2[row], s);
  }
}

int words_per_block(int W) { return W < kThreads ? W : kThreads; }

size_t counts_bytes(int wpb) {
  return 64 * static_cast<size_t>(wpb | 1) * sizeof(uint32_t);
}

}  // namespace

// Plain C entry point, bound with ctypes. Device pointers of contiguous
// tensors: h u64 [B, N], valid u8 [B, N] (0 or 1); scratch u32 [B*D + B]
// (the accumulator and the valid counts, zeroed here on the stream);
// out_hv i16 [B, D] and out_norm2 i32 [B], every element written. D a
// positive multiple of 64, B at most 65535. Launches the two kernels on
// `stream` without synchronising and returns cudaGetLastError(); the
// caller makes the tensors' device current.
extern "C" int hg_encode_hv_i16(const void* h, const void* valid,
                                long long B, long long N, int D,
                                void* scratch, void* out_hv, void* out_norm2,
                                void* stream) {
  if (D <= 0 || D % 64 != 0 || B < 0 || B > 65535 || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* acc = static_cast<uint32_t*>(scratch);
  uint32_t* n_valid = acc + B * D;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (B * D + B) * 4, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(out_norm2, 0, B * 4, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int W = D / 64;
  if (N > 0) {
    const int wpb = words_per_block(W);
    const int gy = (W + wpb - 1) / wpb;
    const long long tiles = (N + kThreads - 1) / kThreads;
    long long want = kTargetBlocks / (B * gy);  // slabs a row
    if (want < 1) want = 1;
    long long per = (tiles + want - 1) / want;  // tiles a slab
    if (per < kMinTiles) per = kMinTiles;
    const long long slab = per * kThreads;
    const dim3 grid(static_cast<unsigned>((N + slab - 1) / slab), gy,
                    static_cast<unsigned>(B));
    encode_hv_kernel<<<grid, kThreads, counts_bytes(wpb), s>>>(static_cast<const uint64_t*>(h), static_cast<const uint8_t*>(valid), N, W, wpb, slab, acc, n_valid);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 tail((D + kTailThreads - 1) / kTailThreads,
                  static_cast<unsigned>(B));
  encode_tail_kernel<<<tail, kTailThreads, 0, s>>>(acc, n_valid, D, static_cast<int16_t*>(out_hv), static_cast<uint32_t*>(out_norm2));
  return static_cast<int>(cudaGetLastError());
}

// What the CUDA runtime reports, on the current device, for the encode
// kernel at hv_d = D: out = {registers a thread, static shared bytes a
// block, dynamic shared bytes a block, resident blocks an SM, threads a
// block, threads an SM}. Returns a CUDA error code, 0 on success.
extern "C" int hg_encode_resources(int D, int* out) {
  if (D <= 0 || D % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = reinterpret_cast<const void*>(encode_hv_kernel);
  const size_t dyn = counts_bytes(words_per_block(D / 64));
  cudaFuncAttributes attr;
  int blocks = 0, dev = 0, per_sm = 0;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                      dyn);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&per_sm, cudaDevAttrMaxThreadsPerMultiProcessor,
                               dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = static_cast<int>(dyn);
  out[3] = blocks;
  out[4] = kThreads;
  out[5] = per_sm;
  return 0;
}
