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
// The residual variant (rDecoderNet(skip=True), AtomAI's generative skip
// decoder) is this source built with SPATIAL_MLP_SKIP defined, into a
// library of its own, with the same kernels under the same names:
//
//   h0 = x @ Wc + bc + zb[s]            (no tanh)
//   hl = tanh(h(l-1) @ Ws[l] + bs[l]) + h0
//
// h0 is K = 2 work, so every use recomputes it in f32 rather than keeping
// it. The backward's tanh' is 1 - t^2 with t = hl - h0, and h0 gathers
// dh0 = a1 Ws[0]^T + sum_l dhl (a_l = dhl (1 - tl^2), no tanh' at h0).
// Its consumers (dx, dbc, dzb, dWc) are linear in dh0, so each level's
// share goes into their sums as the level is reached, and nothing the
// size of a tile is kept: dh_L = gy Wo^T is rank one and is recomputed
// into level 0's.
//
// What bounds it on an H100: the tensor cores. At the rVAE's config C
// (B 128, n 1024, H 128, L 2) the forward is 8.7 GFLOP and the backward
// 26.0 GFLOP against about 2 MB of inputs and outputs: 8.8 and 26.3 us at
// 989 bf16 TFLOP/s. Next come the 50 M tanh a pass on the MUFU units and
// the epilogues between the layer products.
//
// Design (the wgmma path, H rounded up to HP, a multiple of 64, HP <= 256
// forward and HP <= 128 backward, whenever its shared memory fits):
//   - a pack launch converts the f32 weights to bf16 once per call, into
//     the 128-byte-swizzled image wgmma reads: 64 x 64 pieces, 8 KB each,
//     ordered (input-row block, output-column block). Zero padding from H
//     to HP is exact: padded units stay tanh(0) = 0 and feed nothing;
//   - persistent blocks walk row tiles (a warpgroup's 64 rows are one wgmma
//     M; the tail of n is masked, never padded). The forward's blocks are
//     one warpgroup; they bulk-copy (cp.async.bulk + mbarrier) all L
//     layers once and keep them resident;
//   - layer products are wgmma.mma_async m64n64k16, bf16 in, f32
//     accumulate. The activation chain stays in registers: an f32
//     accumulator, after bias, tanh.approx and the cast to bf16, is already
//     the register A operand of the next product. h0 is K = 2 FMAs, the
//     head a register dot product and a quad shuffle;
//   - the backward (bwd_wgmma, HP 64 or 128, L up to 6 or 2): one
//     persistent block an SM, each walking a contiguous run of
//     B * ceil(n / 128) / SMs 128-row tiles (runs cross sample
//     boundaries); 64 rows of a tile to each of two consumer warpgroups,
//     plus a producer warpgroup (384 threads; setmaxnreg moves registers
//     to the consumers, 232 a thread). Each consumer recomputes its
//     rows' h1..hL, keeps h1..h(L-1) and G in shared memory as bf16 (h0 is
//     recomputed into h1's tile when the last level needs it), forms
//     G = dh (1 - h^2) in registers, and gets dh = G Ws[l]^T from the
//     weight image through the B descriptor's transpose bit;
//   - one producer thread streams the weight pieces (layers 0..L-1 for the
//     recompute, then L-1..0 for dh, per tile) with bulk copies into a ring
//     of 3 to 8 stages, as many as fit (3 at HP 128 L 2 and at HP 64 L 6),
//     each with a full and an empty mbarrier. A consumer warpgroup waits on
//     full, starts the piece's four m64n64k16, and hands the stage back
//     (one arrival a warp on empty) once wgmma.wait_group 1 shows the
//     group done, so the next piece's group is already in flight. Pieces
//     go output block by output block, and a block's epilogue (the
//     recompute's bias and tanh, dh's (1 - h^2)) runs while the next
//     block's group is in flight;
//   - dWs[l] += h_l^T G over the tile's 128 rows (K = both warpgroups'
//     rows, both operands in shared memory): at HP 128 each warpgroup
//     owns 64 rows of dW, one m64n128k16 a 16-row step; at HP 64 the
//     layer's parity picks the warpgroup. The hand-off between the two is
//     named barriers of the 256 consumers only: X_w (warpgroup w's G and h
//     tiles are stored) is arrived at before its dh product and waited on
//     by the other after it; Y_w (w's dW product has read the tiles) is
//     arrived at after the product and waited on before the other next
//     overwrites a tile. 2L such waits a tile, none for the weights;
//   - dW's f32 partial lives in shared memory, row-swizzled, for the
//     block's whole run: L * HP^2 * 4 bytes. A warpgroup reads its 64 x HP
//     rows into the wgmma accumulator, adds the tile's K = 128, and writes
//     them back: one round trip per 128 rows (32 KB each way a warpgroup,
//     layer and tile at HP 128). At HP 128 L 2 the partial is 128 KB, the
//     ring 3 x 8 KB, the tiles 2 warpgroups x 2 slots x 16 KB and the
//     biases 2.5 KB: 224,816 of 232,448 bytes; at HP 64 L 6, 96 + 24 + 96
//     + 2.3 KB: 224,560. So neither the 64 KB image can be resident nor a
//     second tile's K = 256 kept (64 KB more of tiles), and a layer's
//     partial in registers would take 64 more a consumer thread, beyond
//     its 232. The product is in flight while the warpgroup forms the
//     next level's column sums;
//   - column sums (dbs, dbc, dzb, dWc, dWo) are reduce-scattered over the
//     eight lanes of a column group (28 shuffles for 32 values at HP 128)
//     and kept in registers, HP / 32 columns a lane, for the whole run: no
//     barrier. dzb's sums go out a warp at a time when the run leaves a
//     sample, one piece per (block, sample); dx by quad shuffles;
//   - per-block partials go to global memory once per block, and a second
//     launch (reduce_kernel) sums them, and each sample's dzb pieces, in
//     one fixed order: no atomics, so the backward is bit-identical run
//     to run.
//   At rvae48's shapes (B 100, n 2,304, H 128, L 2) that is 1,800 tiles,
//   13 or 14 a block on all 132 SMs. A tile holds 6,144 cycles of tensor
//   work (25.2 MFLOP at an SM's share of the peak), but the two consumers
//   run their epilogues in step, so what bounds the kernel is the rate at
//   which they get through the epilogues' instructions, not the tensor
//   cores, nor the weights' latency (measured on an H100 80GB HBM3, 700 W: 15 us a tile and 11 us
//   a block fixed; removing every wgmma saves 13% of the time, the column
//   sums' shuffles 11%, the dW round trips 11%, the (1 - h^2) and the
//   recompute's bias-and-tanh epilogues 7% each, h0's recompute 5%, the
//   full-barrier waits nothing). The ring's depth is what shared memory
//   leaves: the 128 KB dW partial is what keeps the image from being
//   resident and the consumers from running out of phase.
// Shapes outside that range (H above 256 forward or above 128 backward,
// or L deep enough that the shared memory does not fit) take the staged
// path below it: wmma 16x16x16
// tiles with each 128 x 128 weight chunk converted per tile (the first
// port's design, kept so that the range stays H a multiple of 16 in
// [16, 512], any L >= 0, any n >= 1, any B <= 65535).
//
// Plain C interface (loaded with ctypes): no PyTorch headers. The caller
// allocates every output and the workspace (spatial_mlp_workspace) and
// passes PyTorch's current stream; each launch is checked with
// cudaGetLastError() and an error code is returned, never thrown. Launch
// plans and kernel attributes are computed once per shape and device.

#include <cstdint>
#include <mutex>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

#ifdef SPATIAL_MLP_SKIP
constexpr bool kSkip = true;     // the residual variant (file comment)
#else
constexpr bool kSkip = false;
#endif

constexpr int kTM = 64;          // rows per tile
constexpr int kWarps = 4;        // each owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxFrag = 8;      // accumulator fragments a warp keeps: 128 columns
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxH = 512;
// column partials a warp of the staged backward keeps: sum G, sum x0 G and
// sum x1 G; with the residual, the plain sum of dh besides
constexpr int kColQ = kSkip ? 4 : 3;

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

// ---------------------------------------------------------------------------
// The staged path: shapes outside the wgmma path's range.
// ---------------------------------------------------------------------------

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
    if (backward) off += round128(sizeof(float) * kWarps * kColQ * H);
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
  int per;        // staged: tiles per block, a divisor of T or a multiple of T
  int seg_len;    // staged: tiles per dzb segment, min(per, T)
  int segs;       // dzb segments per sample (at most; pipelined: blocks a sample spans)
  int ways;       // dzb partials a segment: 1, or the pipelined kernel's warps
  int runs;       // 1: the pipelined kernel's contiguous runs, one block an SM
  int nblocks;
  int P;          // floats per block partial (rounded up to 8)
  int P_used;     // L*H*H + L*H + H + 1 + 2*H + H
  size_t img_bytes, part_bytes, dzb_bytes, scratch_bytes, total_bytes;
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

// x @ Wc + bias0 at row r and column c of the tile: h0 before its tanh.
__device__ __forceinline__ float h0_linear(const float* xs, const float* bias0,
                                           const float* __restrict__ Wc, int H, int r, int c) {
  return fmaf(xs[r], __ldg(Wc + c), fmaf(xs[kTM + r], __ldg(Wc + H + c), bias0[c]));
}

// h0 = tanh(x @ Wc + bias0) (with the residual, no tanh) for all kTM rows
// of the tile (all threads).
__device__ void first_layer(const Layout& lay, const float* xs, const float* bias0,
                            const float* __restrict__ Wc, bf16* h0) {
  const int H = lay.H, ldh = lay.ldh;
  for (int e = threadIdx.x; e < kTM * H; e += kThreads) {
    const int r = e / H, c = e % H;
    const float v = h0_linear(xs, bias0, Wc, H, r, c);
    h0[r * ldh + c] = __float2bfloat16(kSkip ? v : tanhf(v));
  }
}

// Recomputes (backward) or computes (forward) h1..hL from h0 = acts[0]:
// acts[l + 1] = tanh(acts[l] @ Ws[l] + bs[l]) (plus h0 in f32, from xs,
// bias0 and Wc, with the residual). With `pingpong` only two buffers are
// used (acts[l & 1]); returns the buffer holding hL.
__device__ bf16* hidden_layers(const Layout& lay, bf16* acts0, bool pingpong,
                               const float* __restrict__ Ws, const float* __restrict__ bs,
                               bf16* wt, float* stage, const float* xs, const float* bias0,
                               const float* __restrict__ Wc) {
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
        float v = tanhf(st[r * lds + c] + __ldg(b + c0 + c));
        if constexpr (kSkip) v += h0_linear(xs, bias0, Wc, H, warp * 16 + r, c0 + c);
        out[r * ldh + c] = __float2bfloat16(v);
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
  const bf16* hL = hidden_layers(lay, acts, true, Ws, bs, wt, stage, xs, bias0, Wc);
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
    hidden_layers(lay, acts, false, Ws, bs, wt, stage, xs, bias0, Wc);
    __syncthreads();

    float* st = stage + (warp * 16) * lds;
    const float* xw0 = xs + warp * 16;
    const float* xw1 = xs + kTM + warp * 16;
    // The chunk in `stage`'s sums by column: plain into slot `plain`, and
    // x-weighted (dWc's) into slots 1 and 2.
    auto column_sums = [&](int c0, int plain, bool weighted) {
      for (int c = lane; c < CC; c += 32) {
        float a = 0.f, b0 = 0.f, b1 = 0.f;
        for (int r = 0; r < 16; ++r) {
          const float g = st[r * lds + c];
          a += g;
          b0 = fmaf(xw0[r], g, b0);
          b1 = fmaf(xw1[r], g, b1);
        }
        colpart[(warp * kColQ + plain) * H + c0 + c] = a;
        if (weighted) {
          colpart[(warp * kColQ + 1) * H + c0 + c] = b0;
          colpart[(warp * kColQ + 2) * H + c0 + c] = b1;
        }
      }
    };
    // The rows' dx from the chunk in `stage`, added to dxacc.
    auto dx_rows = [&](int c0) {
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
    };

    // G = dh * (1 - h^2) at `level` (the pre-activation gradient of
    // h_level), for this warp's rows and the chunk in `stage` (dh on
    // entry, G on exit). Writes G as bf16 to gout for the next products,
    // the warp's column sums to colpart and, at level 0, the x-weighted
    // sums (dWc) and the rows' dx. With the residual, dh above level 0
    // reaches h0 as it is: its sums (slot 3 and the x-weighted) and dx go
    // first, then G = dh (1 - t^2), t = h - h0; at level 0, G = dh.
    auto epilogue_g = [&](int level, int c0, bf16* gout) {
      const bf16* h = acts + level * tile + (warp * 16) * ldh + c0;
      const bool resid = kSkip && level > 0;
      if (resid) {
        column_sums(c0, 3, true);
        dx_rows(c0);
        __syncwarp();
      }
      for (int e = lane; e < 16 * CC; e += 32) {
        const int r = e / CC, c = e % CC;
        const float hv = __bfloat162float(h[r * ldh + c]);
        float f = 1.f - hv * hv;
        if constexpr (kSkip) {
          const float t = hv - h0_linear(xs, bias0, Wc, H, warp * 16 + r, c0 + c);
          f = level > 0 ? 1.f - t * t : 1.f;
        }
        const float g = st[r * lds + c] * f;
        st[r * lds + c] = g;
        if (level > 0) gout[(warp * 16 + r) * ldh + c0 + c] = __float2bfloat16(g);
      }
      __syncwarp();
      column_sums(c0, 0, !resid);
      if (level == 0) dx_rows(c0);
      __syncwarp();
    };

    // Sums the warps' column partials in warp order into the block's
    // partials of `level`: dbs[level - 1], or dbc, dWc and dzb at level 0;
    // with the residual, each level's share of h0's too (the tile's first
    // share, at level L, stores on the block's first tile).
    // Called after a block barrier.
    auto consume = [&](int level) {
      for (int c = threadIdx.x; c < H; c += kThreads) {
        float a = 0.f, b0 = 0.f, b1 = 0.f, d = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          a += colpart[(w * kColQ) * H + c];
          b0 += colpart[(w * kColQ + 1) * H + c];
          b1 += colpart[(w * kColQ + 2) * H + c];
          if constexpr (kSkip) d += colpart[(w * kColQ + 3) * H + c];
        }
        if (level > 0) {
          accum(dbs_p + (size_t)(level - 1) * H + c, a, first);
          if constexpr (kSkip) {
            const bool lead = level == L;
            accum(dbc_p + c, d, first && lead);
            accum(dWc_p + c, b0, first && lead);
            accum(dWc_p + H + c, b1, first && lead);
            accum(dzb_seg + c, d, first_in_seg && lead);
          }
        } else {
          const bool lead = !kSkip || L == 0;
          accum(dbc_p + c, a, first && lead);
          accum(dWc_p + c, b0, first && lead);
          accum(dWc_p + H + c, b1, first && lead);
          accum(dzb_seg + c, a, first_in_seg && lead);
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

// Second launch of the backward: sums the per-block partials into the
// weight gradients and each sample's dzb pieces into dzb. A sample has
// `segs` pieces of `ways` partials (the staged kernel's segments); with
// `runs`, as many pieces as blocks its tiles fall in (the pipelined
// kernel's contiguous runs). A block of kReduceThreads sums 32 outputs:
// each of its 8 warps a contiguous eighth of the terms, in order, with
// several loads in flight, then the eighths in order, so the sums are the
// same run to run.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
reduce_kernel(const float* __restrict__ part, int nblocks, int P, int P_used,
              float* __restrict__ dW, const float* __restrict__ dzb_part, int segs,
              int ways, int runs, int T, int total, int BH, int H,
              float* __restrict__ dzb) {
  __shared__ float eighth[8][32];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float a = 0.f;
  if (i < P_used) {
    const int b1 = (w + 1) * nblocks / 8;
#pragma unroll 8
    for (int b = w * nblocks / 8; b < b1; ++b) a += part[(size_t)b * P + i];
  } else if (i - P_used < BH) {
    const int k = i - P_used, s = k / H, c = k % H;
    int pieces = segs;
    if (runs) {
      const long long t0 = (long long)s * T;
      pieces = (int)(((t0 + T) * nblocks - 1) / total - ((t0 + 1) * nblocks - 1) / total) + 1;
    }
    const int terms = pieces * ways, r1 = (w + 1) * terms / 8;
    for (int r = w * terms / 8; r < r1; ++r)
      a += dzb_part[((size_t)s * segs * ways + r) * H + c];
  }
  eighth[w][lane] = a;
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int e = 1; e < 8; ++e) a += eighth[e][lane];
    if (i < P_used)
      dW[i] = a;
    else if (i - P_used < BH)
      dzb[i - P_used] = a;
  }
}

// ---------------------------------------------------------------------------
// The wgmma path.
// ---------------------------------------------------------------------------

constexpr int kPiece = 8192;     // bytes of one 64 x 64 bf16 piece

__host__ __device__ constexpr int round64(int h) { return (h + 63) / 64 * 64; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in a 64-row tile stored as 64 x 64 pieces
// with the 128-byte swizzle (16-byte chunk index XOR row within 8 rows).
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * kPiece + (r >> 3) * 1024 + (r & 7) * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// wgmma matrix descriptor, 128-byte swizzle; lbo and sbo in bytes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_D32(d)                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
  "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
  "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
  "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
  "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
  "+f"(d[31])
#define WG_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64 f32, the warpgroup's accumulator) += A (64 x 16 bf16, four
// registers a thread) @ B (16 x 64 from shared memory). kTransB = 1: B is
// stored with N contiguous (MN-major); 0: with K contiguous.
template <int kTransB>
__device__ __forceinline__ void mma_rs(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : WG_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(kTransB));
}

// d += A @ B with both from shared memory, both MN-major (A stored with M
// contiguous, B with N contiguous).
__device__ __forceinline__ void mma_ss_mn(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : WG_D32(d)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: expect `bytes` on the barrier and bulk-copy them, in pieces
// of at most 32 KB, from global src to shared dst.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  for (uint32_t off = 0; off < bytes; off += 32768) {
    const uint32_t len = bytes - off < 32768 ? bytes - off : 32768;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(static_cast<unsigned char*>(dst) + off)),
           "l"(static_cast<const unsigned char*>(src) + off), "r"(len), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n"
      :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_addr(p);
  return p + ((1024 - (a & 1023)) & 1023);
}

// The packed weight image: layer l at l * HP * HP * 2 bytes, piece (ib, ob)
// (input rows 64 ib.., output columns 64 ob..) at (ib * HP / 64 + ob) * 8 KB,
// rows of 128 bytes swizzled as swz(). One thread per 8 columns.
__global__ void pack_kernel(const float* __restrict__ Ws, bf16* __restrict__ img, int H,
                            int HP, int L) {
  const int groups = HP / 8;
  const long long total = (long long)L * HP * groups;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total;
       g += (long long)gridDim.x * blockDim.x) {
    const int l = (int)(g / ((long long)HP * groups));
    const int rem = (int)(g % ((long long)HP * groups));
    const int i = rem / groups, o0 = (rem % groups) * 8;
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int o = o0 + 2 * k;
      const float* src = Ws + ((size_t)l * H + i) * H;
      const float lo = (i < H && o < H) ? src[o] : 0.f;
      const float hi = (i < H && o + 1 < H) ? src[o + 1] : 0.f;
      __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      w[k] = *reinterpret_cast<uint32_t*>(&v);
    }
    // piece (i / 64, o0 / 64): rows i % 64 inside it
    const size_t off = (size_t)l * HP * HP * 2 + (size_t)((i >> 6) * (HP >> 6)) * kPiece +
                       swz(i & 63, o0);
    *reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(img) + off) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Thread geometry of a wgmma accumulator: element 4 j + e of a thread sits
// at row rowA (e < 2) or rowA + 8, column 8 j + 2 q + (e & 1).
struct Geo {
  int warp, lane, q, rowA;
  __device__ Geo() {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    q = lane & 3;
    rowA = (warp & 3) * 16 + lane / 4;   // the row in the warpgroup's 64
  }
};

// h0 = tanh(x0 Wc[0] + x1 Wc[1] + bc + zb) (with the residual, no tanh)
// into the accumulator layout.
template <int HP>
__device__ __forceinline__ void first_layer_regs(float* acc, const Geo& g, const float* wc0,
                                                 const float* wc1, const float* bias,
                                                 const float* zrow, int H, float xa0,
                                                 float xa1, float xb0, float xb1) {
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * g.q + e;
      const float b = bias[c] + (c < H ? __ldg(zrow + c) : 0.f);
      const float va = fmaf(xa0, wc0[c], fmaf(xa1, wc1[c], b));
      const float vb = fmaf(xb0, wc0[c], fmaf(xb1, wc1[c], b));
      acc[4 * j + e] = kSkip ? va : tanh_fast(va);
      acc[4 * j + 2 + e] = kSkip ? vb : tanh_fast(vb);
    }
  }
}

// h0 = x0 Wc[0] + x1 Wc[1] + bc + zb, then tanh where kAct, at columns c,
// c + 1 (c even) of the thread's two rows: {(rowA, c), (rowA, c + 1),
// (rowA + 8, c), (rowA + 8, c + 1)}; the arithmetic of first_layer_regs,
// with 8-byte loads. Without tanh (the residual forward's, in every layer's
// epilogue) the load of zb is not branched around: a padded column reads
// zb[0] and drops it (measured 7% faster a forward at rvae48's shapes).
template <bool kAct>
__device__ __forceinline__ float4 h0_pair(int c, const float* wc0, const float* wc1,
                                          const float* bcv, const float* zrow, int H,
                                          float xa0, float xa1, float xb0, float xb1) {
  const float2 w0 = *reinterpret_cast<const float2*>(wc0 + c);
  const float2 w1 = *reinterpret_cast<const float2*>(wc1 + c);
  float2 b = *reinterpret_cast<const float2*>(bcv + c);
  if constexpr (kAct) {
    if (c < H) {
      const float2 z = __ldg(reinterpret_cast<const float2*>(zrow + c));
      b.x += z.x;
      b.y += z.y;
    }
  } else {
    const float2 z = __ldg(reinterpret_cast<const float2*>(zrow + (c < H ? c : 0)));
    const float keep = c < H ? 1.f : 0.f;
    b.x = fmaf(keep, z.x, b.x);
    b.y = fmaf(keep, z.y, b.y);
  }
  const float4 v = make_float4(fmaf(xa0, w0.x, fmaf(xa1, w1.x, b.x)),
                               fmaf(xa0, w0.y, fmaf(xa1, w1.y, b.y)),
                               fmaf(xb0, w0.x, fmaf(xb1, w1.x, b.x)),
                               fmaf(xb0, w0.y, fmaf(xb1, w1.y, b.y)));
  if constexpr (kAct)
    return make_float4(tanh_fast(v.x), tanh_fast(v.y), tanh_fast(v.z), tanh_fast(v.w));
  return v;
}

// h0 = x0 Wc[0] + x1 Wc[1] + bz at columns c, c + 1 (c even) of the
// thread's two rows (h0_pair's layout), bz = bc + zb of the rows' sample
// in shared memory: h0_pair<false>'s value, with no global load and no
// branch.
__device__ __forceinline__ float4 h0_lin(int c, const float* wc0, const float* wc1,
                                         const float* bz, float xa0, float xa1, float xb0,
                                         float xb1) {
  const float2 w0 = *reinterpret_cast<const float2*>(wc0 + c);
  const float2 w1 = *reinterpret_cast<const float2*>(wc1 + c);
  const float2 b = *reinterpret_cast<const float2*>(bz + c);
  return make_float4(fmaf(xa0, w0.x, fmaf(xa1, w1.x, b.x)), fmaf(xa0, w0.y, fmaf(xa1, w1.y, b.y)),
                     fmaf(xb0, w0.x, fmaf(xb1, w1.x, b.x)), fmaf(xb0, w0.y, fmaf(xb1, w1.y, b.y)));
}

// With the residual: acc += h0 over the thread's column pairs j0..j1 - 1.
__device__ __forceinline__ void add_h0(float* acc, int j0, int j1, const Geo& g,
                                       const float* wc0, const float* wc1, const float* bcv,
                                       const float* zrow, int H, float xa0, float xa1,
                                       float xb0, float xb1) {
#pragma unroll
  for (int j = j0; j < j1; ++j) {
    const float4 h = h0_pair<false>(8 * j + 2 * g.q, wc0, wc1, bcv, zrow, H, xa0, xa1, xb0, xb1);
    acc[4 * j] += h.x;
    acc[4 * j + 1] += h.y;
    acc[4 * j + 2] += h.z;
    acc[4 * j + 3] += h.w;
  }
}

// The bf16 A operand of the next product from an f32 accumulator.
template <int HP>
__device__ __forceinline__ void to_a_operand(const float* acc, uint32_t* a) {
#pragma unroll
  for (int k = 0; k < HP / 16; ++k) {
    a[4 * k + 0] = pack_bf16(acc[8 * k + 0], acc[8 * k + 1]);
    a[4 * k + 1] = pack_bf16(acc[8 * k + 2], acc[8 * k + 3]);
    a[4 * k + 2] = pack_bf16(acc[8 * k + 4], acc[8 * k + 5]);
    a[4 * k + 3] = pack_bf16(acc[8 * k + 6], acc[8 * k + 7]);
  }
}

// acc = tanh(acc + b) over the thread's columns.
template <int HP>
__device__ __forceinline__ void bias_tanh(float* acc, const Geo& g, const float* b) {
#pragma unroll
  for (int j = 0; j < HP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = tanh_fast(acc[4 * j + e] + b[8 * j + 2 * g.q + (e & 1)]);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Index of dW[i][o] in the backward's f32 partial: rows of HP floats whose
// 32-byte groups are XOR-swizzled by the row, so that the eight rows of an
// accumulator access fall in eight bank groups.
__host__ __device__ __forceinline__ int dw_index(int HP, int i, int o) {
  return i * HP + ((((o >> 3) ^ (i & 7))) << 3) + (o & 7);
}

// Keeps the compiler from moving reads of wgmma accumulators above the
// wait that makes them valid.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Forward: persistent blocks of one warpgroup; all L layers' bf16 images
// resident in shared memory, loaded once per block.
template <int HP>
__global__ void __launch_bounds__(128)
fwd_wgmma(const float* __restrict__ xT, const float* __restrict__ zb,
          const float* __restrict__ Wc, const float* __restrict__ bc,
          const bf16* __restrict__ img, const float* __restrict__ bs,
          const float* __restrict__ Wo, const float* __restrict__ bo,
          float* __restrict__ y, int n, int H, int L, int T, int total) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* wimg = align1024(smem_raw);
  const size_t layer_bytes = (size_t)HP * HP * 2;
  float* wc0 = reinterpret_cast<float*>(wimg + L * layer_bytes);
  float* wc1 = wc0 + HP;
  float* bcv = wc1 + HP;
  float* wo = bcv + HP;
  float* bsv = wo + HP;                    // L * HP
  uint64_t* bar = reinterpret_cast<uint64_t*>(bsv + L * HP);
  const Geo g;
  const int tid = threadIdx.x;
  if (tid == 0) mbar_init(bar, 1);
  for (int c = tid; c < HP; c += 128) {
    const bool ok = c < H;
    wc0[c] = ok ? Wc[c] : 0.f;
    wc1[c] = ok ? Wc[H + c] : 0.f;
    bcv[c] = ok ? bc[c] : 0.f;
    wo[c] = ok ? Wo[c] : 0.f;
  }
  for (int e = tid; e < L * HP; e += 128) {
    const int l = e / HP, c = e % HP;
    bsv[e] = c < H ? bs[(size_t)l * H + c] : 0.f;
  }
  __syncthreads();
  if (L > 0) {
    if (tid == 0) bulk_load(wimg, img, (uint32_t)(L * layer_bytes), bar);
    mbar_wait(bar, 0);
  }
  const float b_out = bo[0];
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    const int s = t / T, r0 = (t % T) * 64;
    const int ra = r0 + g.rowA, rb = ra + 8;
    const float* xs = xT + (size_t)s * 2 * n;
    const float xa0 = ra < n ? xs[ra] : 0.f, xa1 = ra < n ? xs[n + ra] : 0.f;
    const float xb0 = rb < n ? xs[rb] : 0.f, xb1 = rb < n ? xs[n + rb] : 0.f;
    float acc[HP / 2];
    first_layer_regs<HP>(acc, g, wc0, wc1, bcv, zb + (size_t)s * H, H, xa0, xa1, xb0, xb1);
    for (int l = 0; l < L; ++l) {
      uint32_t a[HP / 4];
      to_a_operand<HP>(acc, a);
#pragma unroll
      for (int e = 0; e < HP / 2; ++e) acc[e] = 0.f;
      const uint32_t base = smem_addr(wimg + l * layer_bytes);
      wg_fence();
#pragma unroll
      for (int nc = 0; nc < HP / 64; ++nc)
#pragma unroll
        for (int ks = 0; ks < HP / 16; ++ks)
          mma_rs<1>(acc + 32 * nc, a + 4 * ks,
                    desc(base + ((ks >> 2) * (HP / 64) + nc) * kPiece + (ks & 3) * 2048,
                         kPiece, 1024));
      wg_commit();
      wg_wait();
      fence_regs<HP / 2>(acc);
      bias_tanh<HP>(acc, g, bsv + l * HP);
      if constexpr (kSkip)
        add_h0(acc, 0, HP / 8, g, wc0, wc1, bcv, zb + (size_t)s * H, H, xa0, xa1, xb0, xb1);
    }
    float pa = 0.f, pb = 0.f;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float w = wo[8 * j + 2 * g.q + e];
        pa = fmaf(acc[4 * j + e], w, pa);
        pb = fmaf(acc[4 * j + 2 + e], w, pb);
      }
    pa = quad_sum(pa);
    pb = quad_sum(pb);
    if (g.q == 0) {
      if (ra < n) y[(size_t)s * n + ra] = pa + b_out;
      if (rb < n) y[(size_t)s * n + rb] = pb + b_out;
    }
  }
}

__host__ __device__ inline size_t fwd_smem_bytes(int HP, int L) {
  return 1024 + (size_t)L * HP * HP * 2 + sizeof(float) * (4 + L) * HP + 16;
}

// The backward's pipelined kernel: a producer thread streams the weight
// pieces through a ring; two consumer warpgroups compute (header).
constexpr int kConsumers = 256;                 // two warpgroups
constexpr int kBwdThreads = kConsumers + 128;   // and the producer's warpgroup
constexpr int kBwdWarps = kConsumers / 32;      // consumer warps
// registers a thread: the consumers take what the producer's warpgroup,
// one thread of it busy, gives up (2 x 128 x 232 + 128 x 40 <= 65,536)
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kMinStages = 3;
constexpr int kMaxStages = 8;
// Named barriers of the consumers (0 is __syncthreads): kBarX + w, the
// stores of warpgroup w's tiles are done; kBarY + w, warpgroup w's dW
// product has read both warpgroups' tiles; kBarAll, all consumers.
constexpr int kBarX = 1, kBarY = 3, kBarAll = 5;
// with the residual, kBarZ + w: warpgroup w's own threads (its bz copy)
constexpr int kBarZ = 6;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}
// Lane 0 arrives on bar: a predicate, not a branch, so that no divergent
// path lies between the wgmma groups in flight.
__device__ __forceinline__ void mbar_arrive_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_addr(bar)), "r"(lane) : "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

#define WG_D64(d) WG_D32(d), WG_D32((d + 32))
#define WG_REGS64                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "   \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128) += A @ B, both from shared memory and MN-major; B's two
// 64-column halves lie kPiece apart (the descriptor's leading offset).
__device__ __forceinline__ void mma_ss_mn128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_REGS64
      ", %64, %65, p, 1, 1, 1, 1;\n}\n"
      : WG_D64(d)
      : "l"(da), "l"(db), "r"(1));
}

// The deepest stack the kernel takes at each width (shared memory).
__host__ __device__ constexpr int bwd_lmax(int HP) { return HP == 64 ? 6 : 2; }

// Tiles of 64 x HP bf16 a warpgroup keeps: G, then h_1..h_(L-1); h_0 is
// recomputed into h_1's tile (its own for L = 1) when the last level needs
// it.
__host__ __device__ inline int bwd_slots(int L) { return L == 0 ? 1 : (L < 2 ? 2 : L); }

// Shared memory but the ring: alignment, the tiles, the f32 dW partial,
// and wc0, wc1, bc, bs padded to HP (with the residual, bc + zb of each
// warpgroup's sample too).
__host__ __device__ inline size_t bwd_fixed_bytes(int HP, int L) {
  return 1024 + (size_t)2 * bwd_slots(L) * HP * 128 + (size_t)L * HP * HP * 4 +
         sizeof(float) * (size_t)(3 + L + (kSkip ? 2 : 0)) * HP;
}

// Ring stages: as many 8 KB pieces (each with a full and an empty
// barrier) as fit beside the rest, at most kMaxStages.
__host__ __device__ inline int bwd_stages(int HP, int L) {
  const size_t fixed = bwd_fixed_bytes(HP, L);
  if (fixed >= (size_t)kSmemLimit) return 0;
  const int ns = (int)(((size_t)kSmemLimit - fixed) / (kPiece + 16));
  return ns < kMaxStages ? ns : kMaxStages;
}

__host__ __device__ inline size_t bwd_smem_bytes(int HP, int L) {
  return bwd_fixed_bytes(HP, L) + (size_t)bwd_stages(HP, L) * (kPiece + 16);
}

// Image piece (input-row block, output-column block) of the i-th piece a
// layer product takes off the ring: output block by output block, so that
// a block's epilogue can run while the next block's pieces are in flight.
// The recompute's output blocks are the image's columns; dh's (G W^T) its
// rows.
template <int KC>
__host__ __device__ __forceinline__ int piece_of(int i, bool dh) {
  return dh ? i : (i % KC) * KC + i / KC;
}

// One layer product off the ring: acc = A (registers a) @ the layer's
// image (kDh: @ its transpose, dh = G W^T), one 8 KB piece a group. Each
// stage goes back to the producer as soon as the group that read it is
// done, one group behind the newest; then, once an output block of acc
// (32 floats, 64 columns) is complete, epi(block) runs on it while the
// next block's group is still in flight.
template <int HP, bool kDh, typename Epi>
__device__ __forceinline__ void ring_product(float* acc, const uint32_t* a,
                                             unsigned char* ring, uint64_t* full,
                                             uint64_t* empty, int NS, int& st,
                                             uint32_t& ph, int lane, Epi epi) {
  constexpr int KC = HP / 64;
#pragma unroll
  for (int e = 0; e < HP / 2; ++e) acc[e] = 0.f;
  int prev = 0;
#pragma unroll
  for (int p = 0; p < KC * KC; ++p) {
    const int img = piece_of<KC>(p, kDh);
    const int ib = img / KC, ob = img % KC;   // input-row and output-column blocks
    mbar_wait(full + st, ph);
    wg_fence();
    const uint32_t base = smem_addr(ring + (size_t)st * kPiece);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kDh)   // K-major through the transpose bit; output block ib
        mma_rs<0>(acc + 32 * ib, a + 4 * (4 * ob + k), desc(base + k * 32, 16, 1024));
      else
        mma_rs<1>(acc + 32 * ob, a + 4 * (4 * ib + k), desc(base + k * 2048, kPiece, 1024));
    }
    wg_commit();
    if (p > 0) {
      wg_wait_n<1>();
      mbar_arrive_lane0(empty + prev, lane);
      if ((p - 1) % KC == KC - 1) {       // piece p - 1 completed its output block
        const int blk = (p - 1) / KC;
        fence_regs<32>(acc + 32 * blk);
        epi(blk);
      }
    }
    prev = st;
    if (++st == NS) {
      st = 0;
      ph ^= 1;
    }
  }
  wg_wait_n<0>();
  mbar_arrive_lane0(empty + prev, lane);
  fence_regs<32>(acc + 32 * (KC - 1));
  epi(KC - 1);
}

// One round of the lanes' reduce-scatter: the lanes that differ in bit
// kMask each keep one half of v, adding the partner's copy of it.
template <int kHalf, int kMask>
__device__ __forceinline__ void scatter_round(float* v, int lane) {
  const bool up = lane & kMask;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
  }
}

// Column of the i-th of the HP / 32 sums a lane holds after col_sum.
template <int HP>
__device__ __forceinline__ int scatter_col(const Geo& g, int i) {
  const int k = (g.lane >> 2) * (HP / 32) + i;
  return 8 * (k >> 1) + 2 * g.q + (k & 1);
}

// Sums over the warp's 16 rows of f(j, e) (a thread's two rows at column
// 8 j + 2 q + e), reduce-scattered over the eight lanes of each q: out[i]
// is column scatter_col(i). 14 or 28 shuffles for HP / 4 values.
template <int HP, typename F>
__device__ __forceinline__ void col_sum(const Geo& g, float* out, F f) {
  constexpr int H1 = HP / 8;
  float v[H1];
  const bool up = g.lane & 16;
#pragma unroll
  for (int i = 0; i < H1; ++i) {
    const float lo = f(i >> 1, i & 1), hi = f((i + H1) >> 1, (i + H1) & 1);
    v[i] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, 16);
  }
  scatter_round<H1 / 2, 8>(v, g.lane);
  scatter_round<H1 / 4, 4>(v, g.lane);
#pragma unroll
  for (int i = 0; i < HP / 32; ++i) out[i] = v[i];
}

// Stores the bf16 A operand (to_a_operand's layout) into a swizzled tile.
template <int HP>
__device__ __forceinline__ void store_a_tile(const uint32_t* a, const Geo& g, unsigned char* tile) {
#pragma unroll
  for (int k = 0; k < HP / 16; ++k) {
    const int c = 16 * k + 2 * g.q;
    *reinterpret_cast<uint32_t*>(tile + swz(g.rowA, c)) = a[4 * k];
    *reinterpret_cast<uint32_t*>(tile + swz(g.rowA + 8, c)) = a[4 * k + 1];
    *reinterpret_cast<uint32_t*>(tile + swz(g.rowA, c + 8)) = a[4 * k + 2];
    *reinterpret_cast<uint32_t*>(tile + swz(g.rowA + 8, c + 8)) = a[4 * k + 3];
  }
}

// The block's contiguous run of 128-row tiles: [run_begin(b), run_begin(b + 1)).
__host__ __device__ __forceinline__ int run_begin(int b, int nblocks, int total) {
  return (int)((long long)b * total / nblocks);
}

// The block whose run holds tile t.
__host__ __device__ __forceinline__ int run_of(long long t, int nblocks, int total) {
  return (int)(((t + 1) * nblocks - 1) / total);
}

// Backward: one persistent block an SM walks a contiguous run of 128-row
// tiles (64 rows to a consumer warpgroup), across sample boundaries, while
// its producer thread streams the weight pieces (header).
template <int HP>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_wgmma(const float* __restrict__ xT, const float* __restrict__ zb,
          const float* __restrict__ Wc, const float* __restrict__ bc,
          const bf16* __restrict__ img, const float* __restrict__ bs,
          const float* __restrict__ Wo, const float* __restrict__ gy,
          float* __restrict__ dx, float* __restrict__ part, float* __restrict__ dzb_part,
          int n, int H, int L, int T, int total, int segs, int P) {
  constexpr int KC = HP / 64;
  constexpr int TILE = HP * 128;           // bytes of a 64 x HP bf16 tile
  constexpr int NC = HP / 32;              // column sums a lane keeps
  constexpr int LMAX = bwd_lmax(HP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const int S = bwd_slots(L), NS = bwd_stages(HP, L);
  unsigned char* tiles = ring + (size_t)NS * kPiece;    // [warpgroup][slot]
  float* dW = reinterpret_cast<float*>(tiles + (size_t)2 * S * TILE);
  float* wc0 = dW + (size_t)L * HP * HP;
  float* wc1 = wc0 + HP;
  float* bcv = wc1 + HP;
  float* bsv = bcv + HP;                   // L * HP
  float* bzv = bsv + L * HP;               // with the residual: 2 * HP
  uint64_t* full = reinterpret_cast<uint64_t*>(bzv + (kSkip ? 2 * HP : 0));
  uint64_t* empty = full + NS;
  const int tid = threadIdx.x;
  const int b = blockIdx.x, nb = gridDim.x;
  const int t_begin = run_begin(b, nb, total), t_end = run_begin(b + 1, nb, total);

  if (tid == 0)
    for (int st = 0; st < NS; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, kBwdWarps);
    }
  for (int c = tid; c < HP; c += kBwdThreads) {
    const bool ok = c < H;
    wc0[c] = ok ? Wc[c] : 0.f;
    wc1[c] = ok ? Wc[H + c] : 0.f;
    bcv[c] = ok ? bc[c] : 0.f;
  }
  for (int e = tid; e < L * HP; e += kBwdThreads) {
    const int l = e / HP, c = e % HP;
    bsv[e] = c < H ? bs[(size_t)l * H + c] : 0.f;
  }
  for (size_t e = tid; e < (size_t)L * HP * HP; e += kBwdThreads) dW[e] = 0.f;
  __syncthreads();

  // warpgroup index, made warp-uniform for the compiler (a broadcast)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // The producer: a tile's pieces are layers 0..L-1 (the recompute),
    // then L-1..0 (dh), each in image order; a stage is refilled once all
    // eight consumer warps have released it.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    if (tid == kConsumers) {
      const int kk = KC * KC, per_tile = 2 * L * kk;
      const long long count = (long long)(t_end - t_begin) * per_tile;
      const unsigned char* src0 = reinterpret_cast<const unsigned char*>(img);
      int st = 0, idx = 0;
      uint32_t ph = 0;
      for (long long k = 0; k < count; ++k) {
        if (k >= NS) mbar_wait(empty + st, ph ^ 1);
        const bool dh = idx >= L * kk;
        const int layer = dh ? L - 1 - (idx - L * kk) / kk : idx / kk;
        bulk_load(ring + (size_t)st * kPiece,
                  src0 + (size_t)layer * HP * HP * 2 +
                      (size_t)piece_of<KC>(idx % kk, dh) * kPiece,
                  kPiece, full + st);
        if (++idx == per_tile) idx = 0;
        if (++st == NS) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
  const Geo g;
  const int other = 1 - wg;
  float* bz = bzv + wg * HP;               // with the residual
  auto tile = [&](int w, int slot) { return tiles + (size_t)(w * S + slot) * TILE; };
  // h_l's tile: slot l for l >= 1, slot 1 for h_0; G in slot 0
  auto h_slot = [&](int l) { return l == 0 ? 1 : l; };
  int st = 0;                              // the ring position, as the producer's
  uint32_t ph = 0;

  // this warp's column sums over its rows of the run, HP / 32 columns a lane
  float dbs_acc[LMAX][NC], dwo_acc[NC], dbc_acc[NC], dwc0_acc[NC], dwc1_acc[NC], dzb_acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int l = 0; l < LMAX; ++l) dbs_acc[l][i] = 0.f;
    dwo_acc[i] = dbc_acc[i] = dwc0_acc[i] = dwc1_acc[i] = dzb_acc[i] = 0.f;
  }
  float dbo_acc = 0.f;
  auto add_dbs = [&](int l, const float* v) {
#pragma unroll
    for (int i = 0; i < LMAX; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) dbs_acc[i][c] += i == l ? v[c] : 0.f;
  };

  for (int t = t_begin; t < t_end; ++t) {
    const int s = t / T, jt = t % T, r0 = jt * 128 + 64 * wg;
    const int ra = r0 + g.rowA, rb = ra + 8;
    const float* xs = xT + (size_t)s * 2 * n;
    // masked rows get x = 0 and gy = 0: they add nothing
    const float xa0 = ra < n ? xs[ra] : 0.f, xa1 = ra < n ? xs[n + ra] : 0.f;
    const float xb0 = rb < n ? xs[rb] : 0.f, xb1 = rb < n ? xs[n + rb] : 0.f;
    const float ga = ra < n ? gy[(size_t)s * n + ra] : 0.f;
    const float gb = rb < n ? gy[(size_t)s * n + rb] : 0.f;
    const float* zrow = zb + (size_t)s * H;
    if constexpr (kSkip) {
      if (t == t_begin || jt == 0) {      // a new sample: bc + zb for h0
        if (t > t_begin) bar_sync_wg(kBarZ + wg);   // the last one's readers are done
        for (int c = tid - 128 * wg; c < HP; c += 128)
          bz[c] = bcv[c] + (c < H ? zrow[c] : 0.f);
        bar_sync_wg(kBarZ + wg);
      }
    }
    // h0 at the thread's column pair c (h0_pair's layout): with the
    // residual, linear and from bz; otherwise through its tanh
    auto h0_at = [&](int c) {
      if constexpr (kSkip)
        return h0_lin(c, wc0, wc1, bz, xa0, xa1, xb0, xb1);
      else
        return h0_pair<true>(c, wc0, wc1, bcv, zrow, H, xa0, xa1, xb0, xb1);
    };
    // the other warpgroup's last dW product is done with this one's tiles
    if (L > 0 && t > t_begin) bar_sync(kBarY + other);

    float acc[HP / 2];
    uint32_t a[HP / 4];
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const float4 h = h0_at(8 * j + 2 * g.q);
      acc[4 * j] = h.x;
      acc[4 * j + 1] = h.y;
      acc[4 * j + 2] = h.z;
      acc[4 * j + 3] = h.w;
    }
    for (int l = 0; l < L; ++l) {          // recompute h1..hL; keep h1..h(L-1)
      to_a_operand<HP>(acc, a);
      if (l > 0) store_a_tile<HP>(a, g, tile(wg, h_slot(l)));
      const float* bl = bsv + l * HP;
      ring_product<HP, false>(acc, a, ring, full, empty, NS, st, ph, g.lane, [&](int blk) {
#pragma unroll
        for (int j = 8 * blk; j < 8 * blk + 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * j + e] = tanh_fast(acc[4 * j + e] + bl[8 * j + 2 * g.q + (e & 1)]);
        if constexpr (kSkip) {
#pragma unroll
          for (int j = 8 * blk; j < 8 * blk + 8; ++j) {
            const float4 h = h0_at(8 * j + 2 * g.q);
            acc[4 * j] += h.x;
            acc[4 * j + 1] += h.y;
            acc[4 * j + 2] += h.z;
            acc[4 * j + 3] += h.w;
          }
        }
      });
    }

    // head: dWo += hL^T gy, dbo += sum gy, G_L = gy Wo^T (1 - hL^2)
    dbo_acc += g.q == 0 ? ga + gb : 0.f;
    {
      float v[NC];
      col_sum<HP>(g, v, [&](int j, int e) { return acc[4 * j + e] * ga + acc[4 * j + 2 + e] * gb; });
#pragma unroll
      for (int i = 0; i < NC; ++i) dwo_acc[i] += v[i];
    }
    if constexpr (kSkip) {
      // dh_L = gy Wo^T; tanh' at t_L = h_L - h0 (none at h0 itself: L = 0)
#pragma unroll
      for (int j = 0; j < HP / 8; ++j) {
        const float4 h = h0_at(8 * j + 2 * g.q);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * g.q + e;
          const float w = c < H ? __ldg(Wo + c) : 0.f;
          const float tu = acc[4 * j + e] - (e ? h.y : h.x);
          const float tv = acc[4 * j + 2 + e] - (e ? h.w : h.z);
          acc[4 * j + e] = L > 0 ? ga * w * (1.f - tu * tu) : ga * w;
          acc[4 * j + 2 + e] = L > 0 ? gb * w * (1.f - tv * tv) : gb * w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < HP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * g.q + e;
          const float w = c < H ? __ldg(Wo + c) : 0.f;
          float& u = acc[4 * j + e];
          float& v = acc[4 * j + 2 + e];
          u = ga * w * (1.f - u * u);
          v = gb * w * (1.f - v * v);
        }
    }

    // h0's gradients from acc (G0, or with the residual a level's share of
    // it): dx by rows (h0_dx), dbc, dzb and dWc by columns (h0_cols). With
    // the residual, dx gathers the levels' shares in dxp and goes out at
    // level 0 (`last`).
    float dxp[4] = {0.f, 0.f, 0.f, 0.f};
    auto h0_dx = [&](bool last) {
      float sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < HP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * g.q + e;
          sx[0] = fmaf(acc[4 * j + e], wc0[c], sx[0]);
          sx[1] = fmaf(acc[4 * j + e], wc1[c], sx[1]);
          sx[2] = fmaf(acc[4 * j + 2 + e], wc0[c], sx[2]);
          sx[3] = fmaf(acc[4 * j + 2 + e], wc1[c], sx[3]);
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        sx[k] = quad_sum(sx[k]);
        if constexpr (kSkip) {
          dxp[k] += sx[k];
          sx[k] = dxp[k];
        }
      }
      if (last && g.q == 0) {
        float* dxs = dx + (size_t)s * 2 * n;
        if (ra < n) { dxs[ra] = sx[0]; dxs[n + ra] = sx[1]; }
        if (rb < n) { dxs[rb] = sx[2]; dxs[n + rb] = sx[3]; }
      }
    };
    auto h0_cols = [&]() {
      float v[NC];
      col_sum<HP>(g, v, [&](int j, int e) { return acc[4 * j + e] + acc[4 * j + 2 + e]; });
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        dbc_acc[i] += v[i];
        dzb_acc[i] += v[i];
      }
      col_sum<HP>(g, v, [&](int j, int e) {
        return fmaf(xa0, acc[4 * j + e], xb0 * acc[4 * j + 2 + e]); });
#pragma unroll
      for (int i = 0; i < NC; ++i) dwc0_acc[i] += v[i];
      col_sum<HP>(g, v, [&](int j, int e) {
        return fmaf(xa1, acc[4 * j + e], xb1 * acc[4 * j + 2 + e]); });
#pragma unroll
      for (int i = 0; i < NC; ++i) dwc1_acc[i] += v[i];
    };

    if (L > 0) {
      float v[NC];
      col_sum<HP>(g, v, [&](int j, int e) { return acc[4 * j + e] + acc[4 * j + 2 + e]; });
      add_dbs(L - 1, v);
    } else {
      h0_dx(true);
      h0_cols();
    }

    for (int m = L; m >= 1; --m) {
      const int l = m - 1;                 // the layer that maps h_l to h_m
      if (m < L) bar_sync(kBarY + other);  // both dW[m] products are done with the tiles
      if (l == 0) {                        // h_0 again, into its tile
#pragma unroll
        for (int j = 0; j < HP / 8; ++j) {
          const float4 h = h0_at(8 * j + 2 * g.q);
          a[4 * (j >> 1) + 2 * (j & 1)] = pack_bf16(h.x, h.y);
          a[4 * (j >> 1) + 2 * (j & 1) + 1] = pack_bf16(h.z, h.w);
        }
        store_a_tile<HP>(a, g, tile(wg, h_slot(0)));
      }
      to_a_operand<HP>(acc, a);            // G_m, bf16: dh's A operand and dW's B tile
      store_a_tile<HP>(a, g, tile(wg, 0));
      fence_async_smem();
      bar_arrive(kBarX + wg);

      // dh_l = G_m Ws[l]^T, then G_l = dh_l (1 - h_l^2), an output block at
      // a time (with the residual, after dh_l's share of h0's gradients)
      const unsigned char* ht = tile(wg, h_slot(l));
      ring_product<HP, true>(acc, a, ring, full, empty, NS, st, ph, g.lane, [&](int blk) {
        if constexpr (kSkip) return;
#pragma unroll
        for (int j = 8 * blk; j < 8 * blk + 8; ++j) {
          const int c = 8 * j + 2 * g.q;
          const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ht + swz(g.rowA, c)));
          const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ht + swz(g.rowA + 8, c)));
          acc[4 * j] *= 1.f - fa.x * fa.x;
          acc[4 * j + 1] *= 1.f - fa.y * fa.y;
          acc[4 * j + 2] *= 1.f - fb.x * fb.x;
          acc[4 * j + 3] *= 1.f - fb.y * fb.y;
        }
      });
      if constexpr (kSkip) {
        // before the dW product, whose accumulator would crowd the
        // registers: dh_l's share of h0's gradients, then G_l = dh_l (1 -
        // t_l^2), t_l = h_l (its tile) - h0; at level 0, G0 = dh_0 with
        // dh_L = gy Wo^T folded in, the share no level has taken (rank
        // one, so recomputed here), and dx (G0's column sums run in the
        // product's shadow, as without the residual)
        if (l > 0) {
          h0_dx(false);
          h0_cols();
#pragma unroll
          for (int j = 0; j < HP / 8; ++j) {
            const int c = 8 * j + 2 * g.q;
            const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ht + swz(g.rowA, c)));
            const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(ht + swz(g.rowA + 8, c)));
            const float4 h = h0_at(c);
            const float t0 = fa.x - h.x, t1 = fa.y - h.y, t2 = fb.x - h.z, t3 = fb.y - h.w;
            acc[4 * j] *= 1.f - t0 * t0;
            acc[4 * j + 1] *= 1.f - t1 * t1;
            acc[4 * j + 2] *= 1.f - t2 * t2;
            acc[4 * j + 3] *= 1.f - t3 * t3;
          }
        } else {
#pragma unroll
          for (int j = 0; j < HP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 8 * j + 2 * g.q + e;
              const float w = c < H ? __ldg(Wo + c) : 0.f;
              acc[4 * j + e] = fmaf(ga, w, acc[4 * j + e]);
              acc[4 * j + 2 + e] = fmaf(gb, w, acc[4 * j + 2 + e]);
            }
          h0_dx(true);                     // dx out: dxp is dead in the shadow
        }
      }

      // dWs[l] += h_l^T G_m over the tile's 128 rows (both warpgroups'):
      // rows 64 mc.. of the f32 partial, all HP columns; at HP = 128 each
      // warpgroup owns one half, at HP = 64 the layer's parity picks one
      bar_sync(kBarX + other);
      const bool mine = KC == 2 || (l & 1) == wg;
      const int mc = KC == 2 ? wg : 0;
      float* dw = dW + (size_t)l * HP * HP;
      float d[HP / 2];
      if (mine) {
#pragma unroll
        for (int jj = 0; jj < HP / 8; ++jj) {
          const int o = 8 * jj + 2 * g.q;
          const float2 u = *reinterpret_cast<const float2*>(dw + dw_index(HP, 64 * mc + g.rowA, o));
          const float2 v = *reinterpret_cast<const float2*>(dw + dw_index(HP, 64 * mc + g.rowA + 8, o));
          d[4 * jj] = u.x;
          d[4 * jj + 1] = u.y;
          d[4 * jj + 2] = v.x;
          d[4 * jj + 3] = v.y;
        }
        wg_fence();
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const uint32_t hl = smem_addr(tile(k >> 2, h_slot(l))) + mc * kPiece + (k & 3) * 2048;
          const uint32_t gt = smem_addr(tile(k >> 2, 0)) + (k & 3) * 2048;
          if constexpr (KC == 2)
            mma_ss_mn128(d, desc(hl, kPiece, 1024), desc(gt, kPiece, 1024));
          else
            mma_ss_mn(d, desc(hl, kPiece, 1024), desc(gt, kPiece, 1024));
        }
        wg_commit();
      }
      // the next level's column sums while the product runs
      if (l > 0) {
        float v[NC];
        col_sum<HP>(g, v, [&](int j, int e) { return acc[4 * j + e] + acc[4 * j + 2 + e]; });
        add_dbs(l - 1, v);
      } else {
        if constexpr (!kSkip) h0_dx(true);
        h0_cols();
      }
      if (mine) {
        wg_wait();
        fence_regs<HP / 2>(d);
#pragma unroll
        for (int jj = 0; jj < HP / 8; ++jj) {
          const int o = 8 * jj + 2 * g.q;
          *reinterpret_cast<float2*>(dw + dw_index(HP, 64 * mc + g.rowA, o)) =
              make_float2(d[4 * jj], d[4 * jj + 1]);
          *reinterpret_cast<float2*>(dw + dw_index(HP, 64 * mc + g.rowA + 8, o)) =
              make_float2(d[4 * jj + 2], d[4 * jj + 3]);
        }
      }
      bar_arrive(kBarY + wg);
    }

    // the run's last tile of sample s: this warp's dzb piece of the sample
    if (jt == T - 1 || t == t_end - 1) {
      const int first = run_of((long long)s * T, nb, total);
      float* dst = dzb_part + (((size_t)s * segs + (b - first)) * kBwdWarps + g.warp) * H;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = scatter_col<HP>(g, i);
        if (c < H) dst[c] = dzb_acc[i];
        dzb_acc[i] = 0.f;
      }
    }
  }
  if (L > 0 && t_end > t_begin) bar_sync(kBarY + other);
  bar_sync(kBarAll);                       // every dW product and store is done

  // the warps' column sums, through the tiles' memory: [warp][quantity][HP]
  // with quantities dbs (L), dWo, dbc, dWc[0], dWc[1]; then dbo a warp
  const int Q = L + 4;
  float* sw = reinterpret_cast<float*>(tiles);
  float* sdbo = sw + (size_t)kBwdWarps * Q * HP;
  auto put = [&](int qn, const float* v) {
#pragma unroll
    for (int i = 0; i < NC; ++i) sw[(g.warp * Q + qn) * HP + scatter_col<HP>(g, i)] = v[i];
  };
#pragma unroll
  for (int l = 0; l < LMAX; ++l)
    if (l < L) put(l, dbs_acc[l]);
  put(L, dwo_acc);
  put(L + 1, dbc_acc);
  put(L + 2, dwc0_acc);
  put(L + 3, dwc1_acc);
  const float dbo_w = warp_sum(dbo_acc);
  if (g.lane == 0) sdbo[g.warp] = dbo_w;
  bar_sync(kBarAll);
  auto warps_sum = [&](int qn, int c) {
    float v = sw[qn * HP + c];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) v += sw[(w * Q + qn) * HP + c];
    return v;
  };

  // the block's partials, once: [dWs | dbs | dWo | dbo | dWc | dbc]
  // (by rows of H a warp: no division of an index by H)
  float* out = part + (size_t)b * P;
  for (int r = g.warp; r < L * H; r += kBwdWarps) {
    const int l = r / H, i = r - l * H;
    const float* src = dW + (size_t)l * HP * HP;
    for (int o = g.lane; o < H; o += 32) out[(size_t)r * H + o] = src[dw_index(HP, i, o)];
  }
  out += (size_t)L * H * H;
  for (int r = g.warp; r < L; r += kBwdWarps)
    for (int c = g.lane; c < H; c += 32) out[r * H + c] = warps_sum(r, c);
  out += L * H;
  for (int c = tid; c < H; c += kConsumers) {
    out[c] = warps_sum(L, c);
    out[H + 1 + c] = warps_sum(L + 2, c);
    out[2 * H + 1 + c] = warps_sum(L + 3, c);
    out[3 * H + 1 + c] = warps_sum(L + 1, c);
  }
  if (tid == 0) {
    float v = sdbo[0];
    for (int w = 1; w < kBwdWarps; ++w) v += sdbo[w];
    out[H] = v;
  }
}

int grad_floats(int H, int L) { return L * H * H + L * H + 4 * H + 1; }

// Which path a shape takes, and the bytes of its packed weight image.
bool fwd_fast(int H, int L) {
  const int HP = round64(H);
  return HP <= 256 && fwd_smem_bytes(HP, L) <= (size_t)kSmemLimit;
}

// The pipelined backward takes HP 64 and 128 wherever a ring of at least
// kMinStages fits beside its tiles and partials.
bool bwd_fast(int H, int L) {
  const int HP = round64(H);
  return (HP == 64 || HP == 128) && L <= bwd_lmax(HP) && bwd_stages(HP, L) >= kMinStages;
}

size_t image_bytes(int H, int L) {
  const int HP = round64(H);
  return round128((size_t)L * HP * HP * sizeof(bf16));
}

const void* fwd_fast_fn(int HP) {
  switch (HP) {
    case 64: return (const void*)fwd_wgmma<64>;
    case 128: return (const void*)fwd_wgmma<128>;
    case 192: return (const void*)fwd_wgmma<192>;
    default: return (const void*)fwd_wgmma<256>;
  }
}

const void* bwd_fast_fn(int HP) {
  return HP == 64 ? (const void*)bwd_wgmma<64> : (const void*)bwd_wgmma<128>;
}

// Host-side state computed once: the SM count of each device, and for each
// (kernel, device, shared memory) the attribute set and the occupancy.
std::mutex g_mu;
constexpr int kMaxDev = 64;
int g_sms[kMaxDev];
struct Prepared { const void* fn; int dev; int smem; int occ; };
Prepared g_prepared[128];
int g_n_prepared = 0;
struct PlanEntry { int B, n, H, L, dev; BwdPlan p; };
PlanEntry g_plans[32];
int g_n_plans = 0;

int current_device(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= kMaxDev) return kErrShape;
  std::lock_guard<std::mutex> lock(g_mu);
  if (g_sms[*dev] == 0) {
    err = cudaDeviceGetAttribute(&g_sms[*dev], cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = g_sms[*dev];
  return 0;
}

// Sets the kernel's dynamic shared memory ceiling once and returns its
// blocks per SM at `smem`.
int prepare(const void* fn, int dev, int smem, int threads, int* occ) {
  std::lock_guard<std::mutex> lock(g_mu);
  for (int i = 0; i < g_n_prepared; ++i) {
    const Prepared& e = g_prepared[i];
    if (e.fn == fn && e.dev == dev && e.smem == smem) {
      *occ = e.occ;
      return 0;
    }
  }
  // the attribute is a ceiling: at the limit, so that a smaller request of
  // the same kernel never lowers it below a larger one's
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, fn, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (*occ < 1) return kErrSmem;
  g_prepared[g_n_prepared % 128] = Prepared{fn, dev, smem, *occ};
  if (g_n_prepared < 128) ++g_n_prepared;
  return 0;
}

int make_plan(int B, int n, int H, int L, BwdPlan* p) {
  int dev = 0, sms = 0, occ = 0;
  int err = current_device(&dev, &sms);
  if (err) return err;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    for (int i = 0; i < g_n_plans; ++i) {
      const PlanEntry& e = g_plans[i];
      if (e.B == B && e.n == n && e.H == H && e.L == L && e.dev == dev) {
        *p = e.p;
        return 0;
      }
    }
  }
  const bool fast = bwd_fast(H, L);
  Layout lay(H, L, true);
  const int HP = round64(H);
  err = fast ? prepare(bwd_fast_fn(HP), dev, (int)bwd_smem_bytes(HP, L), kBwdThreads, &occ)
             : prepare((const void*)bwd_kernel, dev, (int)lay.total, kThreads, &occ);
  if (err) return err;
  if (fast) {
    // one block an SM, each a contiguous run of 128-row tiles; a sample's
    // dzb has a piece from each block its tiles fall in, one a warp
    p->T = (n + 127) / 128;
    p->total = B * p->T;
    p->nblocks = p->total < sms * occ ? p->total : sms * occ;
    p->per = p->seg_len = 0;
    p->segs = 1;
    for (int s = 0; s < B; ++s) {
      const long long t0 = (long long)s * p->T;
      const int pieces = run_of(t0 + p->T - 1, p->nblocks, p->total) -
                         run_of(t0, p->nblocks, p->total) + 1;
      if (pieces > p->segs) p->segs = pieces;
    }
    p->ways = kBwdWarps;
    p->runs = 1;
  } else {
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
    p->ways = 1;
    p->runs = 0;
  }
  p->P_used = grad_floats(H, L);
  p->P = (p->P_used + 7) / 8 * 8;
  p->img_bytes = fast ? image_bytes(H, L) : 0;
  p->part_bytes = round128(sizeof(float) * (size_t)p->nblocks * p->P);
  p->dzb_bytes = round128(sizeof(float) * (size_t)B * p->segs * p->ways * H);
  p->scratch_bytes = !fast && lay.acts_global
      ? round128(sizeof(bf16) * (size_t)p->nblocks * (L + 3) * lay.act_tile_elems())
      : 0;
  p->total_bytes = p->img_bytes + p->part_bytes + p->dzb_bytes + p->scratch_bytes;
  std::lock_guard<std::mutex> lock(g_mu);
  g_plans[g_n_plans % 32] = PlanEntry{B, n, H, L, dev, *p};
  if (g_n_plans < 32) ++g_n_plans;
  return 0;
}

int pack_weights(const float* Ws, bf16* img, int H, int L, cudaStream_t st) {
  if (L == 0) return 0;
  const int HP = round64(H);
  const long long groups = (long long)L * HP * (HP / 8);
  const int blocks = (int)((groups + 255) / 256 < 1024 ? (groups + 255) / 256 : 1024);
  pack_kernel<<<blocks, 256, 0, st>>>(Ws, img, H, HP, L);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int n, int H, int L) {
  return B >= 1 && B <= 65535 && n >= 1 && L >= 0 && H >= 16 && H <= kMaxH && H % 16 == 0;
}

}  // namespace

extern "C" {

// Workspace bytes of the forward and of the backward for these shapes on
// the current device.
int spatial_mlp_workspace(int B, int n, int H, int L, long long* fwd_bytes,
                          long long* bwd_bytes) {
  if (!shape_ok(B, n, H, L)) return kErrShape;
  BwdPlan p;
  const int err = make_plan(B, n, H, L, &p);
  if (err) return err;
  *fwd_bytes = fwd_fast(H, L) ? (long long)image_bytes(H, L) : 0;
  *bwd_bytes = (long long)p.total_bytes;
  return 0;
}

// y (B, 1, n) from the inputs; see the file comment for the shapes.
int spatial_mlp_forward(const float* xT, const float* zb, const float* Wc,
                        const float* bc, const float* Ws, const float* bs,
                        const float* Wo, const float* bo, float* y, void* workspace,
                        long long workspace_bytes, int B, int n, int H, int L,
                        void* stream) {
  if (!shape_ok(B, n, H, L)) return kErrShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, occ = 0;
  int err = current_device(&dev, &sms);
  if (err) return err;
  if (fwd_fast(H, L)) {
    const int HP = round64(H);
    if ((long long)image_bytes(H, L) > workspace_bytes) return kErrWorkspace;
    const int smem = (int)fwd_smem_bytes(HP, L);
    err = prepare(fwd_fast_fn(HP), dev, smem, kThreads, &occ);
    if (err) return err;
    bf16* img = static_cast<bf16*>(workspace);
    err = pack_weights(Ws, img, H, L, st);
    if (err) return err;
    const int T = (n + kTM - 1) / kTM, total = B * T;
    const int grid = total < sms * occ ? total : sms * occ;
#define SPATIAL_MLP_FWD(HPV)                                                         \
  fwd_wgmma<HPV><<<grid, kThreads, smem, st>>>(xT, zb, Wc, bc, img, bs, Wo, bo, y, n, \
                                                H, L, T, total)
    switch (HP) {
      case 64: SPATIAL_MLP_FWD(64); break;
      case 128: SPATIAL_MLP_FWD(128); break;
      case 192: SPATIAL_MLP_FWD(192); break;
      default: SPATIAL_MLP_FWD(256); break;
    }
#undef SPATIAL_MLP_FWD
    return (int)cudaGetLastError();
  }
  const Layout lay(H, L, false);
  if (lay.total > (size_t)kSmemLimit) return kErrSmem;
  err = prepare((const void*)fwd_kernel, dev, (int)lay.total, kThreads, &occ);
  if (err) return err;
  const dim3 grid((n + kTM - 1) / kTM, B);
  fwd_kernel<<<grid, kThreads, lay.total, st>>>(xT, zb, Wc, bc, Ws, bs, Wo, bo, y, n, H, L);
  return (int)cudaGetLastError();
}

// dx (B, 2, n), dzb (B, H), and dW = [dWs (L,H,H) | dbs (L,H) | dWo (H) |
// dbo (1) | dWc (2,H) | dbc (H)] flat, from the inputs and gy (B, 1, n).
// *pipelined is set to 1 when the launch took bwd_wgmma, 0 for the staged
// bwd_kernel.
int spatial_mlp_backward(const float* xT, const float* zb, const float* Wc,
                         const float* bc, const float* Ws, const float* bs,
                         const float* Wo, const float* bo, const float* gy,
                         float* dx, float* dzb, float* dW, void* workspace,
                         long long workspace_bytes, int B, int n, int H, int L,
                         void* stream, int* pipelined) {
  *pipelined = 0;
  if (!shape_ok(B, n, H, L)) return kErrShape;
  BwdPlan p;
  int err = make_plan(B, n, H, L, &p);
  if (err) return err;
  if ((long long)p.total_bytes > workspace_bytes) return kErrWorkspace;
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  bf16* img = reinterpret_cast<bf16*>(ws);
  float* part = reinterpret_cast<float*>(ws + p.img_bytes);
  float* dzb_part = reinterpret_cast<float*>(ws + p.img_bytes + p.part_bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.runs) {
    err = pack_weights(Ws, img, H, L, st);
    if (err) return err;
    const int HP = round64(H);
    const int smem = (int)bwd_smem_bytes(HP, L);
    if (HP == 64)
      bwd_wgmma<64><<<p.nblocks, kBwdThreads, smem, st>>>(
          xT, zb, Wc, bc, img, bs, Wo, gy, dx, part, dzb_part, n, H, L, p.T, p.total,
          p.segs, p.P);
    else
      bwd_wgmma<128><<<p.nblocks, kBwdThreads, smem, st>>>(
          xT, zb, Wc, bc, img, bs, Wo, gy, dx, part, dzb_part, n, H, L, p.T, p.total,
          p.segs, p.P);
  } else {
    const Layout lay(H, L, true);
    bf16* scratch = lay.acts_global
        ? reinterpret_cast<bf16*>(ws + p.img_bytes + p.part_bytes + p.dzb_bytes) : nullptr;
    bwd_kernel<<<p.nblocks, kThreads, lay.total, st>>>(
        xT, zb, Wc, bc, Ws, bs, Wo, bo, gy, dx, part, dzb_part, scratch, n, H, L,
        p.T, p.total, p.per, p.seg_len, p.segs, p.P);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int BH = B * H;
  const int items = p.P_used + BH;
  reduce_kernel<<<(items + 31) / 32, kReduceThreads, 0, st>>>(
      part, p.nblocks, p.P, p.P_used, dW, dzb_part, p.segs, p.ways, p.runs, p.T, p.total, BH,
      H, dzb);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *pipelined = p.runs;
  return 0;
}

const char* spatial_mlp_error_string(int code) {
  switch (code) {
    case kErrShape:
      return "shapes outside the kernel's range (H a multiple of 16 in [16, 512], L >= 0, "
             "n >= 1, B >= 1)";
    case kErrSmem:
      return "the tile does not fit in shared memory";
    case kErrWorkspace:
      return "workspace smaller than spatial_mlp_workspace() asked for";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
