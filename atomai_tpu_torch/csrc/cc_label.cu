// 4-neighbour connected-component labels of a binary (H, W) mask.
//
// Replaces the TPU kernel atomai_tpu/ops/pallas_cc.py:_cc_kernel, which
// keeps the whole label image in VMEM and sweeps min-propagation up to
// 4096 times. A 512^2 image of float32 labels is 1 MB, against 227 KB of
// shared memory per block here, so that design does not carry over.
// This is a lock-free union-find in three launches (Playne & Hawick, "A New
// Algorithm for Parallel Connected-Component Labelling on GPUs", IEEE TPDS
// 2018):
//
//   1. init:     lab[p] = p for foreground pixels, total for background;
//   2. merge:    each foreground pixel unions with its foreground left and
//                up neighbours; a union links the LARGER root to the
//                smaller one with atomicCAS, and every find halves the
//                path it walks;
//   3. compress: lab[p] = find(p) for foreground pixels.
//
// Every link points to a smaller flat index, so each component's root is
// its minimal flat index whatever order the threads run in: the output is
// deterministic and equals the JAX contract (root = minimal flat index of
// the component, background = H*W) with no iteration cap. A tiled stack of
// frames, (N*(H+1), W) with one background row between frames, is just a
// taller image: the separator rows keep the frames apart.
//
// What bounds it: memory traffic. Each pixel reads its mask byte and its
// two neighbours' and a few int32 labels, and writes its label two or
// three times: the main path's tiled stack, 64 x 257 x 256 = 4.2 M px, is
// some 50 MB of traffic, and 64 x 513 x 512 = 16.8 M px some 0.2 GB, well
// inside the 50 MB L2 for the labels of the smaller one. A later version
// can cut the global atomics and the long find() chains of big components
// by labelling each tile in shared memory first and merging only across
// tile borders (the block-based union-find of Allegretti et al.), and can
// fuse the centre-of-mass moments into the compress pass.
//
// Plain C interface (loaded with ctypes): no PyTorch headers, so nvcc
// builds it in seconds. The caller allocates `labels` and passes PyTorch's
// current stream; each launch is checked with cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Finds the root of x and halves the path on the way: x is re-pointed
// from its parent to its grandparent only if it still points to that
// parent (atomicCAS). Every link points to a smaller index, so the walk
// ends while other threads work on the same trees, and since a shortcut
// only skips an ancestor, trees never split.
__device__ __forceinline__ int find_root(int* lab, int x) {
  volatile int* vlab = lab;
  while (true) {
    int parent = vlab[x];
    if (parent == x) return x;
    int grand = vlab[parent];
    if (grand == parent) return parent;
    atomicCAS(&lab[x], parent, grand);
    x = grand;
  }
}

// Joins the trees of a and b: the larger root is linked to the smaller
// one, and only while it is still a root (atomicCAS); if another thread
// linked it first, the union starts again from the new roots (the
// lock-free union-find of Anderson & Woll, STOC 1991).
__device__ __forceinline__ void unite(int* lab, int a, int b) {
  while (true) {
    a = find_root(lab, a);
    b = find_root(lab, b);
    if (a == b) return;
    if (a > b) {
      int t = a;
      a = b;
      b = t;
    }
    if (atomicCAS(&lab[b], b, a) == b) return;
  }
}

__global__ void cc_init(const uint8_t* __restrict__ mask,
                        int* __restrict__ lab, int total) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  lab[p] = mask[p] ? (int)p : total;
}

__global__ void cc_merge(const uint8_t* __restrict__ mask, int* lab,
                         int H, int W) {
  long long p64 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p64 >= (long long)H * W) return;
  int p = (int)p64;
  if (!mask[p]) return;
  int col = p % W;
  if (col > 0 && mask[p - 1]) unite(lab, p, p - 1);
  if (p >= W && mask[p - W]) unite(lab, p, p - W);
}

// After the merge the roots are final, so each foreground pixel takes its
// root. Another thread's halving can only re-point p while p still points
// to a non-root, so it never undoes this store.
__global__ void cc_compress(const uint8_t* __restrict__ mask, int* lab,
                            int total) {
  long long p64 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p64 >= total) return;
  int p = (int)p64;
  if (!mask[p]) return;
  lab[p] = find_root(lab, p);
}

}  // namespace

extern "C" int cc_label_launch(const uint8_t* mask, int32_t* labels, int H,
                               int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int total = H * W;  // the wrapper keeps H*W below 2^31
  unsigned int blocks =
      (unsigned int)(((long long)total + kThreads - 1) / kThreads);
  int* lab = reinterpret_cast<int*>(labels);
  cudaError_t err;
  cc_init<<<blocks, kThreads, 0, s>>>(mask, lab, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cc_merge<<<blocks, kThreads, 0, s>>>(mask, lab, H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  cc_compress<<<blocks, kThreads, 0, s>>>(mask, lab, total);
  return (int)cudaGetLastError();
}

extern "C" const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
