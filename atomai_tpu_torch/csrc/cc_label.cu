// 4-neighbour connected-component labels of a binary (H, W) mask, and the
// per-component pixel counts and first moments, in one pipeline.
//
// Replaces the TPU kernel atomai_tpu/ops/pallas_cc.py:27 (_cc_kernel),
// which keeps the whole label image in VMEM and sweeps min-propagation up
// to 4096 times, and the segment sums of atomai_tpu/ops/cc_label.py
// (_blob_moments) that follow it. A 512^2 image of labels is 1 MB against
// 227 KB of shared memory per block here, so that design does not carry
// over. This is a block-based union-find (Allegretti, Bolelli & Grana,
// "Optimized Block-Based Algorithms to Label Connected Components on GPUs",
// IEEE TPDS 2020; Playne & Hawick, IEEE TPDS 2018) in four launches:
//
//   1. cc_local:  one block per 32 x 64 tile, one row segment of 8 pixels a
//                 thread (one 8-byte load). The row's eight threads share
//                 its 64 foreground bits, so each horizontal run is one
//                 node from the start: a union-find over the runs in shared
//                 memory (shared atomics, the larger root linked to the
//                 smaller) joins runs that overlap the row above, one union
//                 at the first column of each overlap. Each pixel gets the
//                 global flat index of its tile-local root: in raster order
//                 the tile-local minimum is the global minimum of the
//                 tile's part of the component. With moments, each run's
//                 pixel count and local row, column and band-wrap sums are
//                 added into its root's 64-bit word in shared memory (see
//                 kRowShift), one atomic a run or a warp; each tile-local
//                 root goes to the tile's stretch of a root list, with its
//                 partial sums unpacked at the tile's origin beside it;
//   2. cc_border: for the pixel pairs across each tile's top and left
//                 borders, the two trees are joined in device memory
//                 (atomicCAS links of the larger root to the smaller, path
//                 halving); pairs implied by the neighbouring pair are
//                 skipped, so a fully foreground tile costs two unions;
//   3. cc_roots:  each listed tile-local root finds its final root and is
//                 re-pointed to it; with moments, a final root lists itself
//                 as a component (a device counter), and any other root
//                 adds its partial sums into its final root's: one 64-bit
//                 integer atomic per tile-local component and sum, not one
//                 per pixel. Integer sums do not depend on the order of the
//                 adds, so they are exact and the same run to run;
//   4. cc_relabel: each foreground pixel whose tile-local root moved takes
//                 the final root (two reads; a write only where it moved).
//
// Every link points to a smaller flat index, so each component's root is
// its minimal flat index whatever order the threads run in: the labels are
// deterministic and equal the JAX contract (root = minimal flat index of
// the component, background = H*W) with no iteration cap. A tiled stack of
// frames, (N*(H+1), W) with one background row between frames, is a taller
// image; with band = H+1 the row sums are band-local (row % band), as
// _blob_moments(band) sums them.
//
// What bounds it on this card: device-memory bytes (the one-byte mask in,
// the int32 labels out, 28 bytes a component for the moments): 21 MB, 6.3
// us at 3.35 TB/s, for config A's 16448 x 256 tiled stack. The global
// union-find it replaces spent its time in contended atomics and long
// pointer chains in device memory (125x its bound on a mask that is one
// component a frame). Here pointer chasing and almost all atomics stay in
// shared memory, and the work of a tile grows with its runs, not its
// pixels: bit operations on the row masks find runs, overlaps and run
// starts. Device memory sees the labels written once, read and rewritten
// once where a tile's root moved, and about 2/tile-side of the pixels in
// border unions. What is left over the bound: the local pass's instruction
// throughput and the four launches' latency (the border unions walk short
// chains in L2). 32 x 64 tiles keep a tile's partial sums in one 64-bit word
// without overflow and a block's shared memory at 24 KB.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, so nvcc
// builds it in seconds. The caller allocates the labels and the scratch
// (sizes from ops/cc_kernel.py:root_capacity, 1024 roots a tile) and passes
// PyTorch's current stream; each launch is checked with cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kTilePx = kTileH * kTileW;
constexpr int kSegW = 8;                        // pixels a thread, one row
constexpr int kSegsPerRow = kTileW / kSegW;
constexpr int kLocalThreads = kTilePx / kSegW;  // 256
constexpr int kMaxTileRoots = kTilePx / 2;      // 4-connected: a checkerboard
constexpr int kBorderPx = kTileW + kTileH;      // pairs across top and left
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// A tile-local component's partial sums packed in one 64-bit word: pixel
// count (<= 2048, 12 bits), sum of tile-local rows (<= 31 * 2048, 16
// bits), of tile-local columns (<= 63 * 2048, 17 bits) and of band wraps
// (rows' band index less the tile's first row's, <= 31 * 2048, 16 bits).
// Each field's total over a tile stays below its width, so adds never
// carry from one field into the next.
constexpr int kRowShift = 12;
constexpr int kColShift = 28;
constexpr int kWrapShift = 45;
constexpr unsigned long long kCountMask = (1ull << 12) - 1;
constexpr unsigned long long kRowMask = (1ull << 16) - 1;
constexpr unsigned long long kColMask = (1ull << 17) - 1;
constexpr unsigned long long kWrapMask = (1ull << 16) - 1;

static_assert(kTileW % kSegW == 0, "a row holds whole segments");
static_assert(kLocalThreads % 32 == 0, "whole warps");

// Where node i of a forest lives in its array: device memory holds the
// labels in raster order; shared memory holds a tile's parents segment-major
// (pixel k of thread t's segment at k * kLocalThreads + t), so that the
// threads of a warp touching the same pixel of their segments hit 32
// different banks.
struct Flat {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};
struct SegmentMajor {
  __device__ __forceinline__ int operator()(int i) const {
    return (i % kSegW) * kLocalThreads + i / kSegW;
  }
};

// Finds the root of x and halves the path on the way: x is re-pointed
// from its parent to its grandparent only if it still points to that
// parent (atomicCAS). Every link points to a smaller index, so the walk
// ends while other threads work on the same trees, and since a shortcut
// only skips an ancestor, trees never split. Works on device and shared
// memory alike.
template <class At>
__device__ __forceinline__ int find_root(int* lab, int x, At at) {
  volatile int* vlab = lab;
  while (true) {
    int parent = vlab[at(x)];
    if (parent == x) return x;
    int grand = vlab[at(parent)];
    if (grand == parent) return parent;
    atomicCAS(&lab[at(x)], parent, grand);
    x = grand;
  }
}

// Joins the trees of a and b: the larger root is linked to the smaller
// one, and only while it is still a root (atomicCAS); if another thread
// linked it first, the union starts again from the new roots (the
// lock-free union-find of Anderson & Woll, STOC 1991).
template <class At>
__device__ __forceinline__ void unite(int* lab, int a, int b, At at) {
  while (true) {
    a = find_root(lab, a, at);
    b = find_root(lab, b, at);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(&lab[at(b)], b, a) == b) return;
  }
}

// Bit k of the result is set where byte k of x is not zero (k < 4).
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The first column of the run of set bits of `row` that holds column c.
__device__ __forceinline__ int run_start(unsigned long long row, int c) {
  const unsigned long long gaps = ~row & ((1ull << c) - 1);
  return gaps ? 64 - __clzll((long long)gaps) : 0;
}

template <bool kMoments>
__global__ void __launch_bounds__(kLocalThreads)
cc_local(const uint8_t* __restrict__ mask, int* __restrict__ lab, int H,
         int W, int band, int tiles_x, bool vec_mask, bool vec_lab,
         int* __restrict__ tile_roots, int* __restrict__ roots,
         int* __restrict__ slot_of, long long* __restrict__ sums,
         long long capacity, int* __restrict__ n_blobs) {
  // parents and partial sums of the tile's run starts (the only nodes of
  // its forest), segment-major; each tile row's foreground bits
  __shared__ int par[kTilePx];
  __shared__ unsigned long long acc[kMoments ? kTilePx : 1];
  __shared__ unsigned long long row_fg[kTileH];
  __shared__ int s_count;
  const SegmentMajor at;
  const int row0 = (blockIdx.x / tiles_x) * kTileH;
  const int col0 = (blockIdx.x % tiles_x) * kTileW;
  const int t = threadIdx.x;
  const int lr = t / kSegsPerRow;
  const int lc0 = (t % kSegsPerRow) * kSegW;
  const int row = row0 + lr;
  const int col = col0 + lc0;
  const int base = lr * kTileW + lc0;  // local index of the segment's start
  const bool in_rows = row < H;
  const bool full = in_rows && col + kSegW <= W;
  const long long g0 = (long long)row * W + col;

  // 1. the segment's mask bytes as one bit a pixel; the tile row's bits
  // from the row's eight threads; the runs that start in the segment
  unsigned fg = 0;
  if (full && vec_mask) {
    const uint2 v = *reinterpret_cast<const uint2*>(mask + g0);
    fg = nonzero_bytes(v.x) | (nonzero_bytes(v.y) << 4);
  } else if (in_rows) {
#pragma unroll
    for (int k = 0; k < kSegW; ++k)
      if (col + k < W && mask[g0 + k]) fg |= 1u << k;
  }
  unsigned long long row_bits = (unsigned long long)fg << lc0;
#pragma unroll
  for (int o = 1; o < kSegsPerRow; o <<= 1)
    row_bits |= __shfl_xor_sync(0xffffffffu, row_bits, o);
  if (lc0 == 0) row_fg[lr] = row_bits;
  const unsigned starts =
      (unsigned)((row_bits & ~(row_bits << 1)) >> lc0) & 0xffu;

  // 2. every run is a one-node tree in shared memory: horizontal
  // neighbours need no union
  for (unsigned b = starts; b; b &= b - 1) {
    const int i = base + __ffs(b) - 1;
    par[at(i)] = i;
    if constexpr (kMoments) acc[at(i)] = 0;
  }
  if (t == 0) s_count = 0;
  if (kMoments && blockIdx.x == 0 && t == 0) *n_blobs = 0;
  __syncthreads();

  // 3. where this row's runs overlap the row above's, one union at the
  // first column of each overlap (shared atomics)
  if (lr > 0) {
    const unsigned long long up = row_fg[lr - 1];
    const unsigned long long both = row_bits & up;
    for (unsigned u = (unsigned)((both & ~(both << 1)) >> lc0) & 0xffu; u;
         u &= u - 1) {
      const int c = lc0 + __ffs(u) - 1;
      unite(par, lr * kTileW + run_start(row_bits, c),
            (lr - 1) * kTileW + run_start(up, c), at);
    }
  }
  __syncthreads();

  // 4. each run's tile-local root (the trees no longer change), the
  // pixels' global labels and, per run, the partial sums
  int out[kSegW];
  unsigned is_root = 0;
  int cur = -1;  // the current run's root
  int label = 0;
  unsigned long long val = 0;
  const int total = H * W;
  const unsigned long long wrap =
      kMoments && band > 0 && in_rows
          ? (unsigned long long)(row / band - row0 / band) : 0ull;
  const unsigned long long row_part = ((unsigned long long)lr << kRowShift) |
                                      (wrap << kWrapShift) | 1ull |
                                      ((unsigned long long)lc0 << kColShift);
#pragma unroll
  for (int k = 0; k < kSegW; ++k) {
    out[k] = total;
    if (!((fg >> k) & 1u)) continue;
    if (k == 0 || !((fg >> (k - 1)) & 1u)) {  // a run enters the segment
      const int s0 = lr * kTileW + (k == 0 ? run_start(row_bits, lc0)
                                           : lc0 + k);
      int r = s0;
      while (par[at(r)] != r) r = par[at(r)];
      if (r == base + k) is_root |= 1u << k;
      if constexpr (kMoments) {
        if (r != cur && cur >= 0) {  // the previous root's pixels, at once
          atomicAdd(&acc[at(cur)], val);
          val = 0;
        }
      }
      cur = r;
      label = (row0 + r / kTileW) * W + col0 + r % kTileW;
    }
    out[k] = label;
    if constexpr (kMoments)
      val += row_part + ((unsigned long long)k << kColShift);
  }
  if (full && vec_lab) {
    int4* dst = reinterpret_cast<int4*>(lab + g0);
    dst[0] = make_int4(out[0], out[1], out[2], out[3]);
    dst[1] = make_int4(out[4], out[5], out[6], out[7]);
  } else if (in_rows) {
#pragma unroll
    for (int k = 0; k < kSegW; ++k)
      if (col + k < W) lab[g0 + k] = out[k];
  }
  if constexpr (kMoments) {
    // the last run: one atomic a warp when the whole warp holds one root
    const int lead = __shfl_sync(0xffffffffu, cur, 0);
    if (__all_sync(0xffffffffu, cur == lead) && lead >= 0) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        val += __shfl_xor_sync(0xffffffffu, val, o);
      if ((t & 31) == 0) atomicAdd(&acc[at(lead)], val);
    } else if (cur >= 0) {
      atomicAdd(&acc[at(cur)], val);
    }
  }

  // 5. the tile's roots into the tile's own stretch of the root list, their
  // number beside it; with moments, each root's partial count, row sum and
  // column sum (unpacked at the tile's origin) in its slot of the list, and
  // the slot at the root's pixel
  const int pos = is_root ? atomicAdd(&s_count, __popc(is_root)) : 0;
  __syncthreads();
  if (t == 0) tile_roots[blockIdx.x] = s_count;
  long long j = (long long)blockIdx.x * kMaxTileRoots + pos;
#pragma unroll
  for (int k = 0; k < kSegW; ++k) {
    if (!((is_root >> k) & 1u)) continue;
    roots[j] = out[k];
    if constexpr (kMoments) {
      const unsigned long long p = acc[at(base + k)];
      const long long cnt = (long long)(p & kCountMask);
      const long long wraps = (long long)((p >> kWrapShift) & kWrapMask);
      // sum of (row0 + lr) % band = row0 + lr - band * (row0 / band + wrap)
      long long row_sum = (long long)((p >> kRowShift) & kRowMask) +
                          cnt * row0;
      if (band > 0)
        row_sum -= (long long)band * (cnt * (row0 / band) + wraps);
      sums[j] = cnt;
      sums[capacity + j] = row_sum;
      sums[2 * capacity + j] =
          (long long)((p >> kColShift) & kColMask) + cnt * col0;
      slot_of[out[k]] = (int)j;
    }
    ++j;
  }
}

// One thread a pixel pair across a tile's top border (kTileW of them) or
// its left border (kTileH), kBorderPx a tile.
__global__ void __launch_bounds__(kThreads)
cc_border(const uint8_t* __restrict__ mask, int* lab, int H, int W,
          int tiles_x, int pairs) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= pairs) return;
  const int tile = idx / kBorderPx;
  const int t = idx % kBorderPx;
  const int row0 = (tile / tiles_x) * kTileH;
  const int col0 = (tile % tiles_x) * kTileW;
  if (t < kTileW) {  // the top border against the tile above
    const int c = col0 + t;
    if (row0 == 0 || c >= W) return;
    const long long p = (long long)row0 * W + c;
    if (!mask[p] || !mask[p - W]) return;
    if (t > 0 && mask[p - 1] && mask[p - 1 - W]) return;
    unite(lab, (int)p, (int)(p - W), Flat());
  } else {  // the left border
    const int r = row0 + t - kTileW;
    if (col0 == 0 || r >= H) return;
    const long long p = (long long)r * W + col0;
    if (!mask[p] || !mask[p - 1]) return;
    if (r > row0 && mask[p - W] && mask[p - W - 1]) return;
    unite(lab, (int)p, (int)(p - 1), Flat());
  }
}

// A warp a tile: lane l takes the tile's listed roots l, l + 32, ... Each
// finds its final root and is re-pointed to it; with moments, a final root
// records its slot in the list of components, and any other root adds its
// partial sums into its final root's slot (one 64-bit atomic a sum; no one
// adds into the slot of a root that is not final, so reading it is safe).
template <bool kMoments>
__global__ void __launch_bounds__(kThreads)
cc_roots(int* lab, const int* __restrict__ roots,
         const int* __restrict__ tile_roots, int tiles,
         const int* __restrict__ slot_of, unsigned long long* sums,
         long long capacity, int* __restrict__ blob_slot, int* n_blobs) {
  const int tile = blockIdx.x * kWarps + threadIdx.x / 32;
  if (tile >= tiles) return;
  const int n = tile_roots[tile];
  volatile int* vlab = lab;
  for (int j = threadIdx.x % 32; j < n; j += 32) {
    const long long i = (long long)tile * kMaxTileRoots + j;
    const int r = roots[i];
    int R = r;
    while (true) {
      const int p = vlab[R];
      if (p == R) break;
      R = p;
    }
    if (R != r) vlab[r] = R;  // points to an ancestor: safe under walks
    if constexpr (kMoments) {
      if (R == r) {
        blob_slot[atomicAdd(n_blobs, 1)] = (int)i;
      } else {
        const long long s = slot_of[R];
        atomicAdd(&sums[s], sums[i]);
        atomicAdd(&sums[capacity + s], sums[capacity + i]);
        atomicAdd(&sums[2 * capacity + s], sums[2 * capacity + i]);
      }
    }
  }
}

// A foreground pixel's label is a tile-local root, whose own label is now
// its final root; roots are never written here, so reads see final values.
// Four pixels a thread (int4) where the row length allows it.
__device__ __forceinline__ int relabel_one(const int* lab, int v, int total) {
  if (v == total) return v;
  return lab[v];
}

__global__ void __launch_bounds__(kThreads)
cc_relabel(int* lab, long long total, bool vec) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    if (idx * 4 >= total) return;
    int4 v = reinterpret_cast<const int4*>(lab)[idx];
    const int4 w = make_int4(relabel_one(lab, v.x, (int)total),
                             relabel_one(lab, v.y, (int)total),
                             relabel_one(lab, v.z, (int)total),
                             relabel_one(lab, v.w, (int)total));
    if (w.x != v.x || w.y != v.y || w.z != v.z || w.w != v.w)
      reinterpret_cast<int4*>(lab)[idx] = w;
  } else {
    if (idx >= total) return;
    const int v = lab[idx];
    const int w = relabel_one(lab, v, (int)total);
    if (w != v) lab[idx] = w;
  }
}

unsigned int blocks_for(long long items) {
  return (unsigned int)((items + kThreads - 1) / kThreads);
}

}  // namespace

// Labels the (H, W) mask into `labels`. `tile_roots` (one int a 32 x 64
// tile) and `roots` (kMaxTileRoots ints a tile: `capacity`) hold each
// tile's roots. With `moments` != 0 also `slot_of` (H*W ints), `sums`
// (3 x `capacity` int64: counts, row sums (band-local if band > 0), column
// sums, at the roots' slots of the list) and `blob_slot` (`capacity` ints);
// `n_blobs` (1 int) receives the number of components: component k's root
// is roots[blob_slot[k]] and its sums are at slot blob_slot[k].
extern "C" int cc_label_launch(const uint8_t* mask, int32_t* labels, int H,
                               int W, int band, int moments, int* n_blobs,
                               int* tile_roots, int* roots, int* slot_of,
                               long long* sums, int* blob_slot,
                               long long capacity, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int tiles = tiles_x * ((H + kTileH - 1) / kTileH);
  const bool vec_mask =
      (reinterpret_cast<uintptr_t>(mask) % 8 == 0) && (W % 8 == 0);
  const bool vec_lab =
      (reinterpret_cast<uintptr_t>(labels) % 16 == 0) && (W % 4 == 0);
  const unsigned int warp_blocks = (tiles + kWarps - 1) / kWarps;
  int* lab = reinterpret_cast<int*>(labels);
  cudaError_t err;
  if (moments)
    cc_local<true><<<tiles, kLocalThreads, 0, s>>>(
        mask, lab, H, W, band, tiles_x, vec_mask, vec_lab, tile_roots, roots,
        slot_of, sums, capacity, n_blobs);
  else
    cc_local<false><<<tiles, kLocalThreads, 0, s>>>(
        mask, lab, H, W, band, tiles_x, vec_mask, vec_lab, tile_roots, roots,
        slot_of, sums, capacity, n_blobs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (tiles > 1) {
    const int pairs = tiles * kBorderPx;  // H*W < 2^31: fits
    cc_border<<<blocks_for(pairs), kThreads, 0, s>>>(mask, lab, H, W,
                                                     tiles_x, pairs);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (moments)
    cc_roots<true><<<warp_blocks, kThreads, 0, s>>>(
        lab, roots, tile_roots, tiles, slot_of,
        reinterpret_cast<unsigned long long*>(sums), capacity, blob_slot,
        n_blobs);
  else
    cc_roots<false><<<warp_blocks, kThreads, 0, s>>>(
        lab, roots, tile_roots, tiles, slot_of,
        reinterpret_cast<unsigned long long*>(sums), capacity, blob_slot,
        n_blobs);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = (long long)H * W;
  const bool vec = vec_lab;  // W % 4 == 0: H*W too
  cc_relabel<<<blocks_for(vec ? total / 4 : total), kThreads, 0, s>>>(
      lab, total, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
