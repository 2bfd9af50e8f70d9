// The exact GP's marginal-likelihood terms and their closed-form gradient,
// for N up to a few thousand: a forward and a backward kernel.
//
// Replaces no TPU kernel: the JAX package leaves the Cholesky factor, the
// solve and autograd's Cholesky backward to XLA. On an H100 the library
// route for these sizes (cuSOLVER's potrf, cuBLAS's triangular solves and
// autograd's cholesky_backward) is dozens of latency-bound launches a
// training step at 0.4-4 TFLOP/s; this pair is two launches.
//
// Forward (spd_mll_forward_kernel): the lower Cholesky factor of the
// augmented matrix A = [[K, r], [r^T, 1]], padded with an identity to P
// rows, a multiple of the tile (32). Its factor is [[L, 0], [v^T, 1]] (the
// pivots from row N on are set to 1), so v = L^-1 r is the factor's row N
// and needs no solve of its own. The inverse of the factor, W = [[L^-1,
// 0], [-alpha^T, 1]], alpha = K^-1 r, is swept along in the same steps (a
// right-looking block forward substitution of L X = I), so the backward
// needs no step of its own. A persistent grid, at most one block an SM and
// started as a cooperative launch (so every block is resident at once, or
// the launch fails), walks the nt = P / 32 tile columns; phase c of it:
//   - the look-ahead tasks, a block each: the diagonal tile (c, c), the
//     rest of tile column c of A and tile row c of W. Each updates the
//     diagonal tile with tile column c - 1, factors it (one warp, a row a
//     lane, unscaled so that a pivot waits only on a shuffle, a
//     reciprocal and a multiply-add) and inverts it (two 16-wide halves,
//     one a half-warp, joined by two products), all in shared memory, the
//     same bits in every block, so no flag passes between them; then it
//     updates its own tile and turns it into L_ic = A_ic D^T or
//     W_cj = D B_cj (D the inverted diagonal tile); the diagonal's task
//     writes W_cc, and L_cc to a side buffer (A_cc is read by the phase's
//     other tasks) that the last phase copies into A;
//   - the trailing tasks on the other blocks: A_ij -= L_i,c-1 L_j,c-1^T
//     and B_ij -= L_i,c-1 W_c-1,j, in runs sized so that they end with the
//     look-ahead tasks;
// then one grid barrier (an atomic counter, reset by a memset before the
// launch, so the launch can be replayed from a CUDA graph). A pivot of K
// that is not positive (or NaN) marks the output failed; the last phase
// then fills its L, W, q and h with NaN, as cholesky_ex's failure and a NaN
// factor do on the library route. q = |v|^2 and h = sum log L_ii are summed
// in double, in a fixed order.
//
// Backward (spd_mll_backward_kernel): from W alone, one block a lower tile
// (i, j) of K^-1 = W^T W over W's first N rows (row N, -alpha, masked),
// heaviest tiles first; the epilogue writes dK = g_h K^-1 / 2 - g_q alpha
// alpha^T into both (i, j) and (j, i), and the diagonal tiles write
// dr = 2 g_q alpha.
//
// Arithmetic: float32 FMA on the CUDA cores (TF32 is off for the GP); the
// pivots' reciprocals by the hardware's approximation (the factor's
// scaling by 1 / sqrt(pivot) with a Newton step). Every sum runs in a fixed
// order with no atomics, so a launch gives the same bits as the last,
// whatever the grid size, and a CUDA-graph replay is the eager step bit
// for bit.
//
// What bounds it. The work is small: the factor P^3/3 and the inverse
// P^3/3 multiply-adds, 0.78 GFLOP at N = 1,024 (12 us at 67 TFLOP/s), the
// backward's N^3/3, 0.36 GFLOP (5 us). What sets the time is the chain of
// dependent steps: P pivots one after another (a shuffle, a reciprocal and
// a multiply-add each, ~70 cycles at best, ~17 us at N = 1,024; measured
// ~270 cycles a pivot with the rank-one updates between them), and nt
// phases, each a tile update, the diagonal's factor and inverse, a tile
// product and a grid barrier (~10 us a phase on an H100). The design
// shortens that chain: the diagonal is factored where it is used instead
// of being passed on (no flag, no extra round trip through L2), the panel
// is a product by the inverted diagonal tile rather than a triangular
// solve, the solve of r rides in the factor, and the inverse's steps ride
// the factor's barriers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;
// a look-ahead task's time in trailing tasks (its two tile updates, the
// diagonal's factor and inverse, its product: ~7 us against ~0.8 us)
constexpr int kLookCost = 8;

struct Params {
  const float* K;
  const float* r;
  float* A;        // (b, P, P): the augmented matrix, then its factor
  float* W;        // (b, P, P): the factor's inverse
  float* Ld;       // (b, P, 32): the factor's diagonal tiles, in A at the end
  float* q;
  float* h;
  int* counter;    // grid barrier
  int* failed;     // (b,)
  int b, n, p, nt;
};

__device__ __forceinline__ int ld_acquire(const int* ptr) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(ptr) : "memory");
  return v;
}


// Spins until *flag reaches value. The cooperative launch makes every block
// resident, so the wait ends; a wait of some 2^24 reads (seconds) would mean
// it was not, and traps rather than hangs.
__device__ void spin_until(const int* flag, int value) {
  for (unsigned spins = 0; ld_acquire(flag) < value; ++spins)
    if (spins == (1u << 24)) __trap();
}

// Every block of the grid arrives, then leaves once all have; the k-th
// barrier of a launch waits for the counter to reach k * gridDim.x. The
// arrival is a release (after the block's barrier, it publishes every
// write of the block) and the wait an acquire, so no full fence is needed.
__device__ void grid_barrier(int* counter, int& epoch) {
  __syncthreads();
  ++epoch;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.s32 [%0], 1;"
                 :: "l"(counter) : "memory");
    spin_until(counter, epoch * static_cast<int>(gridDim.x));
  }
  __syncthreads();
}


// 1 / sqrt(d): the hardware's estimate and one Newton step
__device__ __forceinline__ float rsqrt_nr(float d) {
  float y = rsqrtf(d);
  return y * fmaf(-0.5f * d * y, y, 1.5f);
}


// ---------------------------------------------------------- tile products
// Shared tiles are T x (T + 1) floats; the operands of a product are kept
// k-major, s[k * (T + 1) + m]. Thread (ty, tx) of a 16 x 16 grid owns the
// outputs (ty + 16 a, tx + 16 c), a, c < T / 16.

template <int T>
__device__ void load_tile(float* s, const float* g, int ld, bool trans) {
  for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
    const int r = idx / T, c = idx % T;
    const float v = __ldcg(g + static_cast<size_t>(r) * ld + c);
    s[trans ? c * (T + 1) + r : r * (T + 1) + c] = v;
  }
}

// acc += As^T Bs over the tile's k
template <int T>
__device__ __forceinline__ void tile_mm(const float* As, const float* Bs,
                                        float (&acc)[T / 16][T / 16]) {
  constexpr int R = T / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 8
  for (int k = 0; k < T; ++k) {
    float av[R], bv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) av[a] = As[k * (T + 1) + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = Bs[k * (T + 1) + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
  }
}

template <int T>
__device__ __forceinline__ void zero(float (&acc)[T / 16][T / 16]) {
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c) acc[a][c] = 0.f;
}

// acc = op(X) op(Y) for global T x T tiles: op(X) = X^T where xt, op(Y) =
// Y^T where yt
template <int T>
__device__ void global_mm(float* smem, const float* X, int ldx, bool xt,
                          const float* Y, int ldy, bool yt,
                          float (&acc)[T / 16][T / 16]) {
  float* As = smem;
  float* Bs = smem + T * (T + 1);
  load_tile<T>(As, X, ldx, !xt);
  load_tile<T>(Bs, Y, ldy, yt);
  __syncthreads();
  zero<T>(acc);
  tile_mm<T>(As, Bs, acc);
  __syncthreads();
}

// C = C - acc (sub) or C = acc, for a global tile C
template <int T>
__device__ void store_tile(float* C, int ld, const float (&acc)[T / 16][T / 16],
                           bool sub) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
      float* at = C + static_cast<size_t>(ty + 16 * a) * ld + tx + 16 * c;
      *at = sub ? __ldcg(at) - acc[a][c] : acc[a][c];
    }
}

// ------------------------------------------------------- diagonal tiles
__device__ __forceinline__ float rcp_approx(float d) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// One warp factors a 32 x 32 tile of shared memory (row stride ld) in
// place: lane i holds row i. The elimination runs unscaled (A = L D L^T
// with D the pivots), so each step's shuffles of column j do not wait for
// its pivot, and each lane keeps its own running diagonal: the chain from
// one pivot to the next is a shuffle, a reciprocal and one multiply-add
// (~60 cycles). The columns are scaled by 1 / sqrt(pivot) at the end.
// Rows at or beyond n (global index first + j) take the pivot 1. The
// upper part is zeroed; invd[j] = 1 / L_jj. Returns whether a pivot of K
// was not positive.
__device__ bool factor32(float* S, int ld, float* invd, int first, int n) {
  const int i = threadIdx.x & 31;
  float a[32], piv[32];
  float dd = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    a[c] = S[i * ld + c];
    if (c == i) dd = a[c];
  }
  bool fail = false;
  float d = __shfl_sync(kFull, dd, 0);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float aij = a[j];
    const bool real = first + j < n;
    if (real) fail |= !(d > 0.f);
    piv[j] = real ? d : 1.f;
    const float rd = real ? rcp_approx(d) : 1.f;
    if (i > j) dd = fmaf(-aij * aij, rd, dd);
    // the next pivot goes out first, ahead of this column's updates
    if (j < 31) d = __shfl_sync(kFull, dd, j + 1);
    const float t = aij * rd;
#pragma unroll
    for (int c = j + 1; c < 32; ++c) {
      const float ac = __shfl_sync(kFull, aij, c);
      if (i > c) a[c] = fmaf(-t, ac, a[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float rs = rsqrt_nr(piv[c]);
    S[i * ld + c] = c < i ? a[c] * rs : (c == i ? piv[c] * rs : 0.f);
    if (i == 0) invd[c] = rs;
  }
  __syncwarp();
  return fail;
}

// The inverse D (row stride ldd) of a lower 32 x 32 factor L (row stride
// ld), invd[j] = 1 / L_jj, by the whole block: two 16 x 16 inverses, one a
// half-warp (lane j solves L x = e_j), then D10 = -D11 L10 D00 in two
// products over the block. Scratch: tmp (16 x 17).
__device__ void invert32(const float* L, int ld, const float* invd, float* D,
                         int ldd, float* tmp) {
  if (threadIdx.x < 32) {
    const int o = 16 * (threadIdx.x >> 4), j = threadIdx.x & 15;
    float x[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = i == j ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float w = x[k] * invd[o + k];
      x[k] = w;
#pragma unroll
      for (int i = k + 1; i < 16; ++i)
        x[i] = fmaf(-L[(o + i) * ld + o + k], w, x[i]);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      D[(o + i) * ldd + o + j] = x[i];
      if (o == 0) D[i * ldd + 16 + j] = 0.f;
    }
  }
  __syncthreads();
  const int m = threadIdx.x >> 4, c = threadIdx.x & 15;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s = fmaf(L[(16 + m) * ld + k], D[k * ldd + c], s);
  tmp[m * 17 + c] = s;
  __syncthreads();
  s = 0.f;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    s = fmaf(D[(16 + m) * ldd + 16 + k], tmp[k * 17 + c], s);
  D[(16 + m) * ldd + c] = -s;
  __syncthreads();
}

// ---------------------------------------------------------------- forward
// tile (i, j) of output e's A or W
template <int T>
struct Tiles {
  const Params& P;
  int e;
  __device__ size_t at(int i, int j) const {
    return (static_cast<size_t>(e) * P.p + static_cast<size_t>(i) * T) * P.p +
           static_cast<size_t>(j) * T;
  }
  __device__ float* a(int i, int j) const { return P.A + at(i, j); }
  __device__ float* w(int i, int j) const { return P.W + at(i, j); }
};

// a thread's own outputs of a global tile C (row stride ld)
template <int T>
__device__ __forceinline__ void load_own(float (&v)[T / 16][T / 16],
                                         const float* C, int ld) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c)
      v[a][c] = __ldcg(C + static_cast<size_t>(ty + 16 * a) * ld + tx + 16 * c);
}

template <int T>
__device__ __forceinline__ void sub(float (&v)[T / 16][T / 16],
                                    const float (&acc)[T / 16][T / 16]) {
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c) v[a][c] -= acc[a][c];
}

// a thread's own outputs into a shared tile, row-major or transposed
template <int T>
__device__ __forceinline__ void put_own(float* s, const float (&v)[T / 16][T / 16],
                                        bool trans) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
      const int r = ty + 16 * a, col = tx + 16 * c;
      s[trans ? col * (T + 1) + r : r * (T + 1) + col] = v[a][c];
    }
}

// Look-ahead task u of phase c of output e. Every such task updates the
// diagonal tile (c, c) with tile column c - 1 and factors and inverts it
// on its own (the same bits in each, so no flag passes between blocks);
// task 0 writes L_cc and W_cc, and the others their own tile: A_ic (u =
// i - c) updated and turned into L_ic = A_ic D^T, or B_cj (u = 1 + m + j)
// updated and turned into W_cj = D B_cj. Shared memory: R0 (L_c,c-1, then
// the diagonal tile, then D^T), R1 (the own tile's operand, then the own
// tile), R2 (D), invd (T), tmp16 (16 x 17).
template <int T>
__device__ void look_task(const Params& P, float* smem, int e, int c, int u) {
  constexpr int ld = T + 1, R = T / 16;
  const int m = P.nt - 1 - c;
  const Tiles<T> t{P, e};
  float* R0 = smem;
  float* R1 = smem + T * ld;
  float* R2 = smem + 2 * T * ld;
  float* invd = smem + 3 * T * ld;
  float* tmp16 = invd + T;
  const bool on_a = u >= 1 && u <= m;
  float* own = u == 0 ? nullptr : on_a ? t.a(c + u, c) : t.w(c, u - 1 - m);
  float vd[R][R], vo[R][R], acc[R][R];
  load_own<T>(vd, t.a(c, c), P.p);
  if (own) load_own<T>(vo, own, P.p);
  if (c > 0) {
    load_tile<T>(R0, t.a(c, c - 1), P.p, true);
    if (own && on_a)
      load_tile<T>(R1, t.a(c + u, c - 1), P.p, true);
    else if (own)
      load_tile<T>(R1, t.w(c - 1, u - 1 - m), P.p, false);
    __syncthreads();
    zero<T>(acc);
    tile_mm<T>(R0, R0, acc);                  // L_c,c-1 L_c,c-1^T
    sub<T>(vd, acc);
    if (own) {
      zero<T>(acc);
      if (on_a)
        tile_mm<T>(R1, R0, acc);              // L_i,c-1 L_c,c-1^T
      else
        tile_mm<T>(R0, R1, acc);              // L_c,c-1 W_c-1,j
      sub<T>(vo, acc);
    }
    __syncthreads();
  }
  put_own<T>(R0, vd, false);
  __syncthreads();
  bool fail = false;
  if (threadIdx.x < 32) fail = factor32(R0, ld, invd, c * T, P.n);
  __syncthreads();
  invert32(R0, ld, invd, R2, ld, tmp16);
  if (!own) {
    // L_cc waits in Ld: the phase's other look-ahead tasks read A_cc
    float* Lcc = P.Ld + (static_cast<size_t>(e) * P.p + c * T) * T;
    for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
      const int r = idx / T, col = idx % T;
      Lcc[idx] = R0[r * ld + col];
      t.w(c, c)[static_cast<size_t>(r) * P.p + col] = R2[r * ld + col];
    }
    if (threadIdx.x == 0 && fail) P.failed[e] = 1;
    __syncthreads();
    return;
  }
  for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
    const int r = idx / T, col = idx % T;
    R0[col * ld + r] = R2[r * ld + col];      // D^T, k-major
  }
  put_own<T>(R1, vo, on_a);
  __syncthreads();
  zero<T>(acc);
  if (on_a)
    tile_mm<T>(R1, R0, acc);                  // A_ic D^T
  else
    tile_mm<T>(R0, R1, acc);                  // D B_cj
  store_tile<T>(own, P.p, acc, false);
  __syncthreads();
}

__device__ __forceinline__ int tri_row(int u) {
  int i = static_cast<int>((sqrtf(8.f * u + 1.f) - 1.f) * 0.5f);
  while ((i + 1) * (i + 2) / 2 <= u) ++i;
  while (i * (i + 1) / 2 > u) --i;
  return i;
}

// C -= op(X) op(Y), all global tiles of row stride ld; C is read ahead, so
// its load shares the operands' latency
template <int T>
__device__ void update_tile(float* smem, float* C, const float* X, bool xt,
                            const float* Y, bool yt, int ld) {
  float acc[T / 16][T / 16], v[T / 16][T / 16];
  load_own<T>(v, C, ld);
  global_mm<T>(smem, X, ld, xt, Y, ld, yt, acc);
  sub<T>(v, acc);
  store_tile<T>(C, ld, v, false);
}

// Trailing task u of phase c of output e: A_ij -= L_i,c-1 L_j,c-1^T for
// the tiles c < j <= i, then B_ij -= L_i,c-1 W_c-1,j for i > c, j < c.
template <int T>
__device__ void bulk_task(const Params& P, float* smem, int e, int c, int u) {
  const Tiles<T> t{P, e};
  const int m = P.nt - 1 - c, bulk_a = m * (m + 1) / 2;
  if (u < bulk_a) {
    const int ii = tri_row(u);
    const int i = c + 1 + ii, j = c + 1 + u - ii * (ii + 1) / 2;
    update_tile<T>(smem, t.a(i, j), t.a(i, c - 1), false, t.a(j, c - 1), true,
                   P.p);
  } else {
    const int i = c + 1 + (u - bulk_a) / c, j = (u - bulk_a) % c;
    update_tile<T>(smem, t.w(i, j), t.a(i, c - 1), false, t.w(c - 1, j),
                   false, P.p);
  }
}

// tasks of phase c, per output: look-ahead (the diagonal, column c of A,
// row c of W) and trailing
__host__ __device__ __forceinline__ void phase_tasks(int nt, int c, int& look,
                                                     int& bulk) {
  const int m = nt - 1 - c;
  look = 1 + m + c;
  bulk = c > 0 ? m * (m + 1) / 2 + m * c : 0;
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
spd_mll_forward_kernel(const __grid_constant__ Params P) {
  __shared__ __align__(16) float smem[3 * T * (T + 1) + T + 16 * 17];
  const int G = gridDim.x, blk = blockIdx.x;
  const size_t pp = static_cast<size_t>(P.p) * P.p;
  int epoch = 0;
  // the augmented matrix's lower part, zeros above; W zeroed
  for (size_t idx = static_cast<size_t>(blk) * kThreads + threadIdx.x;
       idx < P.b * pp; idx += static_cast<size_t>(G) * kThreads) {
    const int e = static_cast<int>(idx / pp);
    const int row = static_cast<int>(idx % pp / P.p);
    const int col = static_cast<int>(idx % P.p);
    float v = 0.f;
    if (col <= row) {
      if (row < P.n)
        v = P.K[(static_cast<size_t>(e) * P.n + row) * P.n + col];
      else if (row == P.n)
        v = col < P.n ? P.r[static_cast<size_t>(e) * P.n + col] : 1.f;
      else
        v = row == col ? 1.f : 0.f;
    }
    P.A[idx] = v;
    P.W[idx] = 0.f;
  }
  grid_barrier(P.counter, epoch);
  for (int c = 0; c < P.nt; ++c) {
    int look, bulk;
    phase_tasks(P.nt, c, look, bulk);
    const int n_look = P.b * look, n_bulk = P.b * bulk;
    int from, to;
    if (G > n_look) {
      // a block for each look-ahead task, which carries the phase's chain;
      // the trailing tasks in runs of q to the other blocks, and to the
      // look-ahead blocks beyond the kLookCost that their task takes
      int q = (n_bulk + G - n_look - 1) / (G - n_look);
      if (q > kLookCost) q = (n_bulk + kLookCost * n_look + G - 1) / G;
      const int rest = (G - n_look) * q;
      if (blk < n_look) {
        look_task<T>(P, smem, blk / look, c, blk % look);
        from = rest + blk * (q - kLookCost);
        to = from + q - kLookCost;
      } else {
        from = (blk - n_look) * q;
        to = from + q;
      }
    } else {
      for (int task = blk; task < n_look; task += G)
        look_task<T>(P, smem, task / look, c, task % look);
      from = blk * ((n_bulk + G - 1) / G);
      to = from + (n_bulk + G - 1) / G;
    }
    for (int task = from; task < to && task < n_bulk; ++task)
      bulk_task<T>(P, smem, task / bulk, c, task % bulk);
    grid_barrier(P.counter, epoch);
  }
  // the diagonal tiles into A; a failed output's factor, inverse and terms
  // are NaN
  const size_t pt = static_cast<size_t>(P.p) * T;
  for (int e = 0; e < P.b; ++e) {
    if (__ldcg(P.failed + e)) {
      for (size_t idx = static_cast<size_t>(blk) * kThreads + threadIdx.x;
           idx < pp; idx += static_cast<size_t>(G) * kThreads) {
        P.A[e * pp + idx] = NAN;
        P.W[e * pp + idx] = NAN;
      }
    } else {
      for (size_t idx = static_cast<size_t>(blk) * kThreads + threadIdx.x;
           idx < pt; idx += static_cast<size_t>(G) * kThreads) {
        const size_t row = idx / T;
        P.A[e * pp + row * P.p + row / T * T + idx % T] = __ldcg(P.Ld + e * pt + idx);
      }
    }
  }
  double* red = reinterpret_cast<double*>(smem);
  for (int e = blk; e < P.b; e += G) {
    if (__ldcg(P.failed + e)) {
      if (threadIdx.x == 0) P.q[e] = P.h[e] = NAN;
      continue;
    }
    // h from Ld's diagonals, q from row n of A (of Ld in n's own tile)
    const float* Ae = P.A + e * pp;
    const float* Le = P.Ld + e * pt;
    double hs = 0.0, qs = 0.0;
    for (int i = threadIdx.x; i < P.n; i += kThreads) {
      hs += log(static_cast<double>(__ldcg(Le + static_cast<size_t>(i) * T + i % T)));
      const double v = i / T == P.n / T
                           ? __ldcg(Le + static_cast<size_t>(P.n) * T + i % T)
                           : __ldcg(Ae + static_cast<size_t>(P.n) * P.p + i);
      qs += v * v;
    }
    for (int part = 0; part < 2; ++part) {
      __syncthreads();
      red[threadIdx.x] = part == 0 ? hs : qs;
      __syncthreads();
      for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
      }
      if (threadIdx.x == 0) (part == 0 ? P.h : P.q)[e] = static_cast<float>(red[0]);
    }
    __syncthreads();
  }
}

// --------------------------------------------------------------- backward
template <int T>
__device__ void load_rows(float* s, const float* g, int ld, int masked) {
  for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
    const int r = idx / T, c = idx % T;
    s[r * (T + 1) + c] =
        r == masked ? 0.f : __ldg(g + static_cast<size_t>(r) * ld + c);
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
spd_mll_backward_kernel(const float* W, const float* gq, const float* gh,
                        float* dK, float* dr, int n, int p) {
  __shared__ __align__(16) float smem[2 * T * (T + 1)];
  const int e = blockIdx.y;
  const int u = blockIdx.x;
  const int i = tri_row(u), j = u - i * (i + 1) / 2;
  const int ntn = (n + T - 1) / T;
  const float* We = W + static_cast<size_t>(e) * p * p;
  float acc[T / 16][T / 16];
  zero<T>(acc);
  float* As = smem;
  float* Bs = smem + T * (T + 1);
  // (K^-1)_ij = sum_k W_ki^T W_kj over the tiles k >= i, row n masked
  for (int k = i; k < ntn; ++k) {
    const float* rows = We + static_cast<size_t>(k) * T * p;
    load_rows<T>(As, rows + i * T, p, n - k * T);
    load_rows<T>(Bs, rows + j * T, p, n - k * T);
    __syncthreads();
    tile_mm<T>(As, Bs, acc);
    __syncthreads();
  }
  const float g_q = gq[e], half_gh = 0.5f * gh[e];
  const float* alpha_neg = We + static_cast<size_t>(n) * p;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* dKe = dK + static_cast<size_t>(e) * n * n;
#pragma unroll
  for (int a = 0; a < T / 16; ++a)
#pragma unroll
    for (int c = 0; c < T / 16; ++c) {
      const int r = ty + 16 * a, col = tx + 16 * c;
      const int gr = i * T + r, gc = j * T + col;
      const float s = alpha_neg[gr] * alpha_neg[gc];
      const float v = fmaf(-g_q, s, half_gh * acc[a][c]);
      As[r * (T + 1) + col] = v;
      if (gr < n && gc < n) dKe[static_cast<size_t>(gr) * n + gc] = v;
    }
  __syncthreads();
  if (i != j) {
    for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
      const int r = idx / T, col = idx % T;     // row r of tile (j, i)
      const int gr = j * T + r, gc = i * T + col;
      if (gr < n && gc < n)
        dKe[static_cast<size_t>(gr) * n + gc] = As[col * (T + 1) + r];
    }
  } else if (threadIdx.x < T && i * T + threadIdx.x < n) {
    const int g = i * T + threadIdx.x;
    dr[static_cast<size_t>(e) * n + g] = -2.f * g_q * alpha_neg[g];
  }
}

// the most tasks a phase has: the grid needs no more blocks
int tasks_most(int b, int nt) {
  int most = 1;
  for (int c = 0; c < nt; ++c) {
    int look, bulk;
    phase_tasks(nt, c, look, bulk);
    most = std::max(most, b * (look + bulk));
  }
  return most;
}

}  // namespace

// K (b, n, n) and r (b, n) in; A, W (b, P, P), q and h (b,) out; Ld:
// (b, P, 32) floats and sync: 1 + b ints of scratch, sync zeroed here on
// the stream. A cooperative launch, which a CUDA graph captures: it fails
// (cudaErrorCooperativeLaunchTooLarge) rather than start a grid whose
// blocks cannot all be resident, as when other work holds the SMs.
// Returns a cudaError_t.
extern "C" int spd_mll_forward(const float* K, const float* r, float* A,
                               float* W, float* Ld, float* q, float* h,
                               int* sync, int b, int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = (n + kTile) / kTile * kTile;
  const int nt = p / kTile;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = std::min(sms, tasks_most(b, nt));
  err = cudaMemsetAsync(sync, 0, sizeof(int) * (1 + b), s);
  if (err != cudaSuccess) return err;
  const Params P{K, r, A, W, Ld, q, h, sync, sync + 1, b, n, p, nt};
  void* args[] = {const_cast<Params*>(&P)};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&spd_mll_forward_kernel<kTile>), grid,
      kThreads, args, 0, s);
}

// W (b, P, P) of the forward, g_q and g_h (b,) in; dK (b, n, n) and dr
// (b, n) out. Returns a cudaError_t.
extern "C" int spd_mll_backward(const float* W, const float* gq,
                                const float* gh, float* dK, float* dr, int b,
                                int n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = (n + kTile) / kTile * kTile;
  const int ntn = (n + kTile - 1) / kTile;
  const dim3 grid(ntn * (ntn + 1) / 2, b);
  spd_mll_backward_kernel<kTile><<<grid, kThreads, 0, s>>>(W, gq, gh, dK, dr, n,
                                                           p);
  return cudaGetLastError();
}

extern "C" const char* spd_mll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
