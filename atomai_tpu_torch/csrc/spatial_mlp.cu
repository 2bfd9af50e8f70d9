// Fused spatial-decoder MLP of the rVAE: forward and backward.
//
// Replaces the TPU kernels of atomai_tpu/ops/pallas_mlp.py: _fwd_kernel
// (called by _fwd) and _bwd_kernel (called by _bwd_rule, the custom VJP).
// For M = B * n pixel rows, with sample s = row / n:
//
//   h0 = tanh(x @ Wc + bc + zb[s])      x: (2,) coordinates of the row
//   hl = tanh(h(l-1) @ Ws[l] + bs[l])   l = 1..L, Ws[l]: (H, H) (in, out)
//   y  = hL @ Wo + bo                   Wo: (H, 1)
//
// Only y leaves the chip in the forward; the backward recomputes h0..hL
// per tile instead of reading stored activations, as the TPU kernel does.
// Layouts are the JAX kernel's: xT (B, 2, n), y and gy (B, 1, n), dx
// (B, 2, n); weights float32 and contiguous.
//
// What bounds it on an H100: arithmetic, not memory. At the rVAE's bench
// shapes (B = 128, n = 1024, H = 128, L = 2) the forward is about
// 8.6 GFLOP and the backward about three times that (recompute, dh and
// dW), against some 1.5 MB of x, y and weights. So the design keeps every
// activation on chip and feeds the tensor cores:
//   - a block owns a tile of kTM = 64 rows of one sample; four warps own
//     16 rows each. Activations live in shared memory as bf16 (the TPU
//     kernel's operand type), accumulation is f32;
//   - each hidden layer is a (64 x H) x (H x H) product on nvcuda::wmma
//     bf16 16x16x16 fragments. Weights are staged into shared memory as
//     bf16 in chunks of at most 128 x 128, so H = 512 (512 KB of f32
//     weights a layer) fits the 227 KB budget;
//   - the K = 2 coordinate product, the biases, tanh and the head are f32
//     FMAs.
// This first version is far from that bound: a block barrier per staged
// weight chunk and, in the backward, a read-modify-write of the f32
// weight-gradient partials per tile hold it back (PERF.md has the times;
// wgmma, TMA and larger tiles are the next step).
// The TPU backward sums dW over a sequential grid in revisited output
// blocks; Hopper blocks run in no order. Here a fixed number of blocks
// (the SMs times the blocks that fit on one, at most two) each walk a
// contiguous range of tiles and keep per-block f32 partials of dWs, dbs,
// dWo, dbo, dWc and dbc in global memory; dzb is kept per (sample,
// segment), where a segment is the part of one sample that one block
// walks. A second launch sums the partials in block order. No atomics:
// on one card the result does not depend on launch order.
//
// Range: H a multiple of 16 with 16 <= H <= 512, any L >= 0, any n >= 1
// (the tail tile is masked: no padding of n), any B >= 1.
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The caller
// allocates every output and the backward's workspace, and passes
// PyTorch's current stream; each launch is checked with
// cudaGetLastError() and an error code is returned, never thrown.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTM = 64;          // rows per tile
constexpr int kWarps = 4;        // each owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrag = 8;      // accumulator fragments a warp keeps: 128 columns
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxH = 512;

constexpr int kErrShape = 1001;  // H, L, n or B outside the kernel's range
constexpr int kErrSmem = 1002;   // the forward's tile would not fit in shared memory
constexpr int kErrWorkspace = 1003;  // the caller's workspace is too small

typedef __nv_bfloat16 bf16;

// Column (and K) chunk of a layer product: 16 times the largest divisor of
// H / 16 that is at most kMaxFrag.
__host__ __device__ inline int chunk_of(int H) {
  int q = H / 16;
  for (int d = kMaxFrag; d >= 1; --d)
    if (q % d == 0) return 16 * d;
  return 16;
}

__host__ __device__ inline size_t round128(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory layout, in bytes, of both kernels. Every region starts on
// a 128-byte boundary, so every wmma pointer below is 32-byte aligned.
struct Layout {
  int H, L, CC, ldh, ldw, lds;
  size_t wt, stage, xs, gys, bias0, colpart, dxacc, acts, total;
  bool acts_global;  // backward only: the (L + 3) activation tiles live in global scratch

  __host__ __device__ Layout(int H_, int L_, bool backward) : H(H_), L(L_) {
    CC = chunk_of(H);
    ldh = H + 8;   // bf16 rows padded by 16 bytes against bank conflicts
    ldw = CC + 8;
    lds = CC + 4;
    size_t off = 0;
    wt = off;      off += round128(sizeof(bf16) * CC * ldw);
    stage = off;   off += round128(sizeof(float) * kTM * lds);
    xs = off;      off += round128(sizeof(float) * 2 * kTM);
    gys = off;     off += round128(sizeof(float) * kTM);
    bias0 = off;   off += round128(sizeof(float) * H);
    colpart = off;
    if (backward) off += round128(sizeof(float) * kWarps * 3 * H);
    dxacc = off;
    if (backward) off += round128(sizeof(float) * kTM * 2);
    acts = off;
    const int n_acts = backward ? L + 3 : 2;
    const size_t acts_bytes = round128(sizeof(bf16) * (size_t)n_acts * kTM * ldh);
    acts_global = backward && off + acts_bytes > (size_t)kSmemLimit;
    if (!acts_global) off += acts_bytes;
    total = off;
  }
  __host__ __device__ size_t act_tile_elems() const { return (size_t)kTM * ldh; }
};

// How the backward spreads its tiles over blocks.
struct BwdPlan {
  int T;          // tiles per sample
  int total;      // tiles in all
  int per;        // tiles per block: a divisor of T, or a multiple of T
  int seg_len;    // tiles per dzb segment: min(per, T)
  int segs;       // dzb segments per sample
  int nblocks;
  int P;          // floats per block partial (rounded up to 8)
  int P_used;     // L*H*H + L*H + H + 1 + 2*H + H
  size_t part_bytes, dzb_bytes, scratch_bytes, total_bytes;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// out = A @ op(W) for this warp's 16 rows, one column chunk at a time.
// A: kTM x H bf16 (row-major, ld lda), W: f32 (H, H) in (in, out) layout in
// global memory. kTrans = false multiplies by W (the forward's layers);
// kTrans = true by W^T (dh = G @ W^T in the backward). After each chunk
// the warp's 16 x CC f32 result is in `stage` and epi(c0) runs on it.
// Every thread of the block must call this (it synchronises the block).
template <bool kTrans, typename Epi>
__device__ void layer_product(const Layout& lay, const bf16* A, const float* __restrict__ W,
                              bf16* wt, float* stage, Epi epi) {
  const int H = lay.H, CC = lay.CC, ldw = lay.ldw, lds = lay.lds, lda = lay.ldh;
  const int warp = threadIdx.x / 32;
  const int nf = CC / 16;
  for (int c0 = 0; c0 < H; c0 += CC) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxFrag];
#pragma unroll
    for (int f = 0; f < kMaxFrag; ++f) wmma::fill_fragment(acc[f], 0.0f);
    for (int k0 = 0; k0 < H; k0 += CC) {
      __syncthreads();  // the previous chunk's readers of wt are done
      // forward: wt[k][c] = W[k0 + k][c0 + c]; backward: wt[i][o] = W[c0 + i][k0 + o]
      const int row0 = kTrans ? c0 : k0;
      const int col0 = kTrans ? k0 : c0;
      for (int e = threadIdx.x; e < CC * CC; e += kThreads) {
        const int r = e / CC, c = e % CC;
        wt[r * ldw + c] = __float2bfloat16(W[(size_t)(row0 + r) * H + col0 + c]);
      }
      __syncthreads();
      for (int kk = 0; kk < CC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + (size_t)(warp * 16) * lda + k0 + kk, lda);
#pragma unroll
        for (int f = 0; f < kMaxFrag; ++f) {
          if (f >= nf) continue;
          if (kTrans) {
            // B(k, n) = W[c0 + 16 f + n][k0 + kk + k] = wt[(16 f + n) * ldw + kk + k]
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
            wmma::load_matrix_sync(b, wt + (f * 16) * ldw + kk, ldw);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          } else {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(b, wt + kk * ldw + f * 16, ldw);
            wmma::mma_sync(acc[f], a, b, acc[f]);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < kMaxFrag; ++f)
      if (f < nf)
        wmma::store_matrix_sync(stage + (warp * 16) * lds + f * 16, acc[f], lds,
                                wmma::mem_row_major);
    __syncwarp();
    epi(c0);
    __syncwarp();
  }
}

// h0 = tanh(x @ Wc + bias0) for all kTM rows of the tile (all threads).
__device__ void first_layer(const Layout& lay, const float* xs, const float* bias0,
                            const float* __restrict__ Wc, bf16* h0) {
  const int H = lay.H, ldh = lay.ldh;
  for (int e = threadIdx.x; e < kTM * H; e += kThreads) {
    const int r = e / H, c = e % H;
    const float v = fmaf(xs[r], __ldg(Wc + c), fmaf(xs[kTM + r], __ldg(Wc + H + c), bias0[c]));
    h0[r * ldh + c] = __float2bfloat16(tanhf(v));
  }
}

// Recomputes (backward) or computes (forward) h1..hL from h0 = acts[0]:
// acts[l + 1] = tanh(acts[l] @ Ws[l] + bs[l]). With `pingpong` only two
// buffers are used (acts[l & 1]); returns the buffer holding hL.
__device__ bf16* hidden_layers(const Layout& lay, bf16* acts0, bool pingpong,
                               const float* __restrict__ Ws, const float* __restrict__ bs,
                               bf16* wt, float* stage) {
  const int H = lay.H, CC = lay.CC, ldh = lay.ldh, lds = lay.lds;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t tile = lay.act_tile_elems();
  bf16* cur = acts0;
  for (int l = 0; l < lay.L; ++l) {
    bf16* nxt = acts0 + (pingpong ? ((l + 1) & 1) : (l + 1)) * tile;
    const float* b = bs + (size_t)l * H;
    layer_product<false>(lay, cur, Ws + (size_t)l * H * H, wt, stage, [&](int c0) {
      const float* st = stage + (warp * 16) * lds;
      bf16* out = nxt + (warp * 16) * ldh + c0;
      for (int e = lane; e < 16 * CC; e += 32) {
        const int r = e / CC, c = e % CC;
        out[r * ldh + c] = __float2bfloat16(tanhf(st[r * lds + c] + __ldg(b + c0 + c)));
      }
    });
    cur = nxt;
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads)
fwd_kernel(const float* __restrict__ xT, const float* __restrict__ zb,
           const float* __restrict__ Wc, const float* __restrict__ bc,
           const float* __restrict__ Ws, const float* __restrict__ bs,
           const float* __restrict__ Wo, const float* __restrict__ bo,
           float* __restrict__ y, int n, int H, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(H, L, false);
  bf16* wt = reinterpret_cast<bf16*>(smem + lay.wt);
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* bias0 = reinterpret_cast<float*>(smem + lay.bias0);
  bf16* acts = reinterpret_cast<bf16*>(smem + lay.acts);
  const int s = blockIdx.y;
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kTM; i += kThreads) {
    const bool ok = r0 + i < n;   // the tail of n is masked
    xs[i] = ok ? xT[((size_t)s * 2) * n + r0 + i] : 0.f;
    xs[kTM + i] = ok ? xT[((size_t)s * 2 + 1) * n + r0 + i] : 0.f;
  }
  for (int c = threadIdx.x; c < H; c += kThreads) bias0[c] = bc[c] + zb[(size_t)s * H + c];
  __syncthreads();
  first_layer(lay, xs, bias0, Wc, acts);
  const bf16* hL = hidden_layers(lay, acts, true, Ws, bs, wt, stage);
  __syncthreads();
  const int ldh = lay.ldh;
  const float b_out = bo[0];
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    float acc = 0.f;
    for (int c = lane; c < H; c += 32) acc = fmaf(__bfloat162float(hL[r * ldh + c]), __ldg(Wo + c), acc);
    acc = warp_sum(acc);
    if (lane == 0 && r0 + r < n) y[(size_t)s * n + r0 + r] = acc + b_out;
  }
}

// Adds src to the block's partial, or stores it on the block's first tile.
__device__ __forceinline__ void accum(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

__global__ void __launch_bounds__(kThreads)
bwd_kernel(const float* __restrict__ xT, const float* __restrict__ zb,
           const float* __restrict__ Wc, const float* __restrict__ bc,
           const float* __restrict__ Ws, const float* __restrict__ bs,
           const float* __restrict__ Wo, const float* __restrict__ bo,
           const float* __restrict__ gy, float* __restrict__ dx,
           float* __restrict__ part, float* __restrict__ dzb_part,
           bf16* __restrict__ scratch, int n, int H, int L, int T, int total,
           int per, int seg_len, int segs, int P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout lay(H, L, true);
  const int CC = lay.CC, ldh = lay.ldh, lds = lay.lds;
  bf16* wt = reinterpret_cast<bf16*>(smem + lay.wt);
  float* stage = reinterpret_cast<float*>(smem + lay.stage);
  float* xs = reinterpret_cast<float*>(smem + lay.xs);
  float* gys = reinterpret_cast<float*>(smem + lay.gys);
  float* bias0 = reinterpret_cast<float*>(smem + lay.bias0);
  float* colpart = reinterpret_cast<float*>(smem + lay.colpart);
  float* dxacc = reinterpret_cast<float*>(smem + lay.dxacc);
  const size_t tile = lay.act_tile_elems();
  bf16* acts = lay.acts_global ? scratch + (size_t)blockIdx.x * (L + 3) * tile
                               : reinterpret_cast<bf16*>(smem + lay.acts);
  // acts[0..L] = h0..hL; acts[L + 1], acts[L + 2] = G ping-pong (bf16)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float* mypart = part + (size_t)blockIdx.x * P;
  float* dWs_p = mypart;
  float* dbs_p = dWs_p + (size_t)L * H * H;
  float* dWo_p = dbs_p + (size_t)L * H;
  float* dbo_p = dWo_p + H;
  float* dWc_p = dbo_p + 1;
  float* dbc_p = dWc_p + 2 * H;

  const int t_begin = blockIdx.x * per;
  const int t_end = min(t_begin + per, total);
  for (int t = t_begin; t < t_end; ++t) {
    const int s = t / T, j = t % T, r0 = j * kTM;
    const bool first = t == t_begin;
    const bool first_in_seg = first || j % seg_len == 0;
    float* dzb_seg = dzb_part + ((size_t)s * segs + j / seg_len) * H;

    __syncthreads();  // the previous tile is done with shared memory
    for (int i = threadIdx.x; i < kTM; i += kThreads) {
      const bool ok = r0 + i < n;  // masked rows get x = 0 and gy = 0: they add nothing
      xs[i] = ok ? xT[((size_t)s * 2) * n + r0 + i] : 0.f;
      xs[kTM + i] = ok ? xT[((size_t)s * 2 + 1) * n + r0 + i] : 0.f;
      gys[i] = ok ? gy[(size_t)s * n + r0 + i] : 0.f;
      dxacc[2 * i] = 0.f;
      dxacc[2 * i + 1] = 0.f;
    }
    for (int c = threadIdx.x; c < H; c += kThreads) bias0[c] = bc[c] + zb[(size_t)s * H + c];
    __syncthreads();
    first_layer(lay, xs, bias0, Wc, acts);
    hidden_layers(lay, acts, false, Ws, bs, wt, stage);
    __syncthreads();

    // G = dh * (1 - h^2) at `level` (the pre-activation gradient of
    // h_level), for this warp's rows and the chunk in `stage` (dh on
    // entry, G on exit). Writes G as bf16 to gout for the next products,
    // the warp's column sums to colpart and, at level 0, the x-weighted
    // sums (dWc) and the rows' dx.
    auto epilogue_g = [&](int level, int c0, bf16* gout) {
      float* st = stage + (warp * 16) * lds;
      const bf16* h = acts + level * tile + (warp * 16) * ldh + c0;
      for (int e = lane; e < 16 * CC; e += 32) {
        const int r = e / CC, c = e % CC;
        const float hv = __bfloat162float(h[r * ldh + c]);
        const float g = st[r * lds + c] * (1.f - hv * hv);
        st[r * lds + c] = g;
        if (level > 0) gout[(warp * 16 + r) * ldh + c0 + c] = __float2bfloat16(g);
      }
      __syncwarp();
      const float* xw0 = xs + warp * 16;
      const float* xw1 = xs + kTM + warp * 16;
      for (int c = lane; c < CC; c += 32) {
        float a = 0.f, b0 = 0.f, b1 = 0.f;
        for (int r = 0; r < 16; ++r) {
          const float g = st[r * lds + c];
          a += g;
          b0 = fmaf(xw0[r], g, b0);
          b1 = fmaf(xw1[r], g, b1);
        }
        colpart[(warp * 3) * H + c0 + c] = a;
        colpart[(warp * 3 + 1) * H + c0 + c] = b0;
        colpart[(warp * 3 + 2) * H + c0 + c] = b1;
      }
      if (level == 0) {
        for (int r = 0; r < 16; ++r) {
          float d0 = 0.f, d1 = 0.f;
          for (int c = lane; c < CC; c += 32) {
            const float g = st[r * lds + c];
            d0 = fmaf(__ldg(Wc + c0 + c), g, d0);
            d1 = fmaf(__ldg(Wc + H + c0 + c), g, d1);
          }
          d0 = warp_sum(d0);
          d1 = warp_sum(d1);
          if (lane == 0) {
            dxacc[2 * (warp * 16 + r)] += d0;
            dxacc[2 * (warp * 16 + r) + 1] += d1;
          }
        }
      }
      __syncwarp();
    };

    // Sums the warps' column partials in warp order into the block's
    // partials of `level`: dbs[level - 1], or dbc, dWc and dzb at level 0.
    // Called after a block barrier.
    auto consume = [&](int level) {
      for (int c = threadIdx.x; c < H; c += kThreads) {
        float a = 0.f, b0 = 0.f, b1 = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          a += colpart[(w * 3) * H + c];
          b0 += colpart[(w * 3 + 1) * H + c];
          b1 += colpart[(w * 3 + 2) * H + c];
        }
        if (level > 0) {
          accum(dbs_p + (size_t)(level - 1) * H + c, a, first);
        } else {
          accum(dbc_p + c, a, first);
          accum(dWc_p + c, b0, first);
          accum(dWc_p + H + c, b1, first);
          accum(dzb_seg + c, a, first_in_seg);
        }
      }
    };

    // head: dWo += hL^T gy, dbo += sum gy, dh_L = gy Wo^T
    const bf16* hL = acts + L * tile;
    for (int c = threadIdx.x; c < H; c += kThreads) {
      float a = 0.f;
      for (int r = 0; r < kTM; ++r) a = fmaf(__bfloat162float(hL[r * ldh + c]), gys[r], a);
      accum(dWo_p + c, a, first);
    }
    if (threadIdx.x == 0) {
      float a = 0.f;
      for (int r = 0; r < kTM; ++r) a += gys[r];
      accum(dbo_p, a, first);
    }
    bf16* gcur = acts + (L + 1) * tile;
    bf16* gnext = acts + (L + 2) * tile;
    for (int c0 = 0; c0 < H; c0 += CC) {
      float* st = stage + (warp * 16) * lds;
      for (int e = lane; e < 16 * CC; e += 32) {
        const int r = e / CC, c = e % CC;
        st[r * lds + c] = __ldg(Wo + c0 + c) * gys[warp * 16 + r];
      }
      __syncwarp();
      epilogue_g(L, c0, gcur);
    }
    __syncthreads();
    consume(L);

    for (int m = L; m >= 1; --m) {
      const int l = m - 1;  // the layer that maps h_l to h_m
      __syncthreads();      // gcur is complete; colpart is consumed
      // dWs[l] += h_l^T G over the tile's rows: (H/16)^2 fragments shared by the warps
      {
        const bf16* hprev = acts + l * tile;
        float* dst = dWs_p + (size_t)l * H * H;
        const int nq = H / 16;
        for (int f = warp; f < nq * nq; f += kWarps) {
          const int i0 = (f / nq) * 16, o0 = (f % nq) * 16;
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          if (first)
            wmma::fill_fragment(acc, 0.0f);
          else
            wmma::load_matrix_sync(acc, dst + (size_t)i0 * H + o0, H, wmma::mem_row_major);
          for (int k = 0; k < kTM; k += 16) {
            // A(i, r) = h_l[r][i0 + i]: col-major; B(r, o) = G[r][o0 + o]: row-major
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
            wmma::load_matrix_sync(a, hprev + (size_t)k * ldh + i0, ldh);
            wmma::load_matrix_sync(b, gcur + (size_t)k * ldh + o0, ldh);
            wmma::mma_sync(acc, a, b, acc);
          }
          wmma::store_matrix_sync(dst + (size_t)i0 * H + o0, acc, H, wmma::mem_row_major);
        }
      }
      // dh_l = G @ Ws[l]^T, then G at level l
      layer_product<true>(lay, gcur, Ws + (size_t)l * H * H, wt, stage,
                          [&](int c0) { epilogue_g(l, c0, gnext); });
      __syncthreads();
      consume(l);
      bf16* tmp = gcur;
      gcur = gnext;
      gnext = tmp;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTM; i += kThreads) {
      if (r0 + i < n) {
        dx[((size_t)s * 2) * n + r0 + i] = dxacc[2 * i];
        dx[((size_t)s * 2 + 1) * n + r0 + i] = dxacc[2 * i + 1];
      }
    }
  }
}

// Second launch of the backward: sums the per-block partials (in block
// order) into the weight gradients and the dzb segments into dzb.
__global__ void reduce_kernel(const float* __restrict__ part, int nblocks, int P,
                              int P_used, float* __restrict__ dW,
                              const float* __restrict__ dzb_part, int segs, int BH,
                              int H, float* __restrict__ dzb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < P_used) {
    float a = 0.f;
    for (int b = 0; b < nblocks; ++b) a += part[(size_t)b * P + i];
    dW[i] = a;
  } else if (i - P_used < BH) {
    const int k = i - P_used, s = k / H, c = k % H;
    float a = 0.f;
    for (int q = 0; q < segs; ++q) a += dzb_part[((size_t)s * segs + q) * H + c];
    dzb[k] = a;
  }
}

int grad_floats(int H, int L) { return L * H * H + L * H + 4 * H + 1; }

int make_plan(int B, int n, int H, int L, BwdPlan* p) {
  Layout lay(H, L, true);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, bwd_kernel, kThreads,
                                                      lay.total);
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return kErrSmem;
  const int target = sms * (occ < 2 ? occ : 2);
  p->T = (n + kTM - 1) / kTM;
  p->total = B * p->T;
  const int want = (p->total + target - 1) / target;
  if (want <= p->T) {
    int per = want;
    while (p->T % per) ++per;   // smallest divisor of T that is >= want
    p->per = per;
  } else {
    p->per = (want + p->T - 1) / p->T * p->T;
  }
  p->seg_len = p->per < p->T ? p->per : p->T;
  p->segs = p->T / p->seg_len;
  p->nblocks = (p->total + p->per - 1) / p->per;
  p->P_used = grad_floats(H, L);
  p->P = (p->P_used + 7) / 8 * 8;
  p->part_bytes = round128(sizeof(float) * (size_t)p->nblocks * p->P);
  p->dzb_bytes = round128(sizeof(float) * (size_t)B * p->segs * H);
  p->scratch_bytes = lay.acts_global
      ? round128(sizeof(bf16) * (size_t)p->nblocks * (L + 3) * lay.act_tile_elems())
      : 0;
  p->total_bytes = p->part_bytes + p->dzb_bytes + p->scratch_bytes;
  return 0;
}

bool shape_ok(int B, int n, int H, int L) {
  return B >= 1 && B <= 65535 && n >= 1 && L >= 0 && H >= 16 && H <= kMaxH && H % 16 == 0;
}

}  // namespace

extern "C" {

// y (B, 1, n) from the inputs; see the file comment for the shapes.
int spatial_mlp_forward(const float* xT, const float* zb, const float* Wc,
                        const float* bc, const float* Ws, const float* bs,
                        const float* Wo, const float* bo, float* y, int B, int n,
                        int H, int L, void* stream) {
  if (!shape_ok(B, n, H, L)) return kErrShape;
  const Layout lay(H, L, false);
  if (lay.total > (size_t)kSmemLimit) return kErrSmem;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTM - 1) / kTM, B);
  fwd_kernel<<<grid, kThreads, lay.total, static_cast<cudaStream_t>(stream)>>>(
      xT, zb, Wc, bc, Ws, bs, Wo, bo, y, n, H, L);
  return (int)cudaGetLastError();
}

// Bytes of workspace the backward needs for these shapes on the current device.
int spatial_mlp_backward_workspace(int B, int n, int H, int L, long long* bytes) {
  if (!shape_ok(B, n, H, L)) return kErrShape;
  BwdPlan p;
  const int err = make_plan(B, n, H, L, &p);
  if (err) return err;
  *bytes = (long long)p.total_bytes;
  return 0;
}

// dx (B, 2, n), dzb (B, H), and dW = [dWs (L,H,H) | dbs (L,H) | dWo (H) |
// dbo (1) | dWc (2,H) | dbc (H)] flat, from the inputs and gy (B, 1, n).
int spatial_mlp_backward(const float* xT, const float* zb, const float* Wc,
                         const float* bc, const float* Ws, const float* bs,
                         const float* Wo, const float* bo, const float* gy,
                         float* dx, float* dzb, float* dW, void* workspace,
                         long long workspace_bytes, int B, int n, int H, int L,
                         void* stream) {
  if (!shape_ok(B, n, H, L)) return kErrShape;
  BwdPlan p;
  int err = make_plan(B, n, H, L, &p);
  if (err) return err;
  if ((long long)p.total_bytes > workspace_bytes) return kErrWorkspace;
  const Layout lay(H, L, true);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  float* part = reinterpret_cast<float*>(ws);
  float* dzb_part = reinterpret_cast<float*>(ws + p.part_bytes);
  bf16* scratch = lay.acts_global
      ? reinterpret_cast<bf16*>(ws + p.part_bytes + p.dzb_bytes) : nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bwd_kernel<<<p.nblocks, kThreads, lay.total, st>>>(
      xT, zb, Wc, bc, Ws, bs, Wo, bo, gy, dx, part, dzb_part, scratch, n, H, L,
      p.T, p.total, p.per, p.seg_len, p.segs, p.P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int BH = B * H;
  const int items = p.P_used + BH;
  reduce_kernel<<<(items + 255) / 256, 256, 0, st>>>(part, p.nblocks, p.P, p.P_used,
                                                     dW, dzb_part, p.segs, BH, H, dzb);
  return (int)cudaGetLastError();
}

const char* spatial_mlp_error_string(int code) {
  switch (code) {
    case kErrShape:
      return "shapes outside the kernel's range (H a multiple of 16 in [16, 512], L >= 0, "
             "n >= 1, B >= 1)";
    case kErrSmem:
      return "the tile does not fit in shared memory";
    case kErrWorkspace:
      return "workspace smaller than spatial_mlp_backward_workspace() asked for";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
