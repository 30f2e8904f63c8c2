// What the split-K kernels (dense_relu.cu, mlp_megakernel.cu,
// quant_dense.cu) share: shared-memory tile loads (cp.async 16-byte
// copies where a matrix's rows are 16-byte aligned, a masked element-wise
// copy where they are not) and how a cluster deals out the elements it
// reduces; its barriers; and the launch attributes each card needs once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace split_k {

// A kernel's function attributes (its dynamic shared memory size, a
// non-portable cluster size) belong to one device's context: a process
// that launches on several cards (a serving fleet, a replica a card) must
// set them on each. One DeviceOnce per attribute set, a static of its
// launch site, runs `set` on the first launch on each device and keeps
// that result for the device's later launches.
class DeviceOnce {
 public:
  template <typename F>
  cudaError_t get(F set) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(mu_);
    if (!done_[dev]) {
      result_[dev] = set();
      done_[dev] = true;
    }
    return result_[dev];
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::mutex mu_;
  bool done_[kMaxDevices] = {};
  cudaError_t result_[kMaxDevices] = {};
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without stalling the thread;
// the last 16 - src_bytes bytes are filled with zeros (src_bytes may be 0).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait for every cp.async of this thread, committed or not.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

// True when every row of a row-major matrix with `cols` elements of
// `elem` bytes starts on a 16-byte boundary, so whole 16-byte chunks can
// be copied with cp.async. (A matrix of one row needs only aligned16.)
inline bool rows_aligned(const void* base, int cols, int elem) {
  return aligned16(base) && (static_cast<long long>(cols) * elem) % 16 == 0;
}

// Load the ROWS x COLS tile whose top-left element is (row0, col0) of the
// row-major (nrows, ncols) matrix `g` into shared memory `s` (row stride
// SSTRIDE elements). Elements outside the matrix become zero. With `vec`
// (rows_aligned) the copy is asynchronous, 16 bytes a chunk, a chunk
// crossing the matrix's right edge reading only its valid bytes; without
// it, each element is a plain load and store; for 1-byte elements every
// load of a thread is issued before its first store, so that the copy
// waits for one round trip to memory rather than one per element.
// THREADS threads share the work; `tid` is this thread's index among
// them.
template <typename T, int ROWS, int COLS, int SSTRIDE, int THREADS>
__device__ __forceinline__ void load_tile(T* s, const T* g, int nrows,
                                          int ncols, int row0, int col0,
                                          bool vec, int tid) {
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4,
                "1-, 2- or 4-byte elements");
  constexpr int V = 16 / sizeof(T);
  static_assert(COLS % V == 0 && SSTRIDE % V == 0, "16-byte chunks");
  if (vec) {
    constexpr int CPR = COLS / V;  // chunks per row
    for (int c = tid; c < ROWS * CPR; c += THREADS) {
      const int r = c / CPR, cc = (c % CPR) * V;
      const int gr = row0 + r, gc = col0 + cc;
      int valid = gr < nrows ? ncols - gc : 0;
      valid = valid < 0 ? 0 : (valid > V ? V : valid);
      const T* src = valid > 0 ? g + static_cast<size_t>(gr) * ncols + gc : g;
      cp_async16(s + r * SSTRIDE + cc, src,
                 valid * static_cast<int>(sizeof(T)));
    }
  } else if constexpr (sizeof(T) == 1) {
    constexpr int N = (ROWS * COLS + THREADS - 1) / THREADS;
    const unsigned char* gb = reinterpret_cast<const unsigned char*>(g);
    unsigned char* sb = reinterpret_cast<unsigned char*>(s);
    unsigned char v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      const int gr = row0 + e / COLS, gc = col0 + e % COLS;
      v[i] = (e < ROWS * COLS && gr < nrows && gc < ncols)
                 ? gb[static_cast<size_t>(gr) * ncols + gc]
                 : 0;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * THREADS;
      if (e < ROWS * COLS) sb[e / COLS * SSTRIDE + e % COLS] = v[i];
    }
  } else {
    using U = typename std::conditional<sizeof(T) == 2, unsigned short,
                                        unsigned>::type;
    const U* gu = reinterpret_cast<const U*>(g);
    U* su = reinterpret_cast<U*>(s);
    for (int e = tid; e < ROWS * COLS; e += THREADS) {
      const int r = e / COLS, cc = e % COLS;
      const int gr = row0 + r, gc = col0 + cc;
      su[r * SSTRIDE + cc] = (gr < nrows && gc < ncols)
                                 ? gu[static_cast<size_t>(gr) * ncols + gc]
                                 : U(0);
    }
  }
}

// Elements [0, total) dealt to `parts` owners in contiguous slices of
// floor or ceil(total / parts): the owner of element e, and the first
// element of owner r's slice.
__device__ __forceinline__ int slice_owner(int e, int parts, int total) {
  return e * parts / total;
}

__device__ __forceinline__ int slice_first(int r, int parts, int total) {
  return (r * total + parts - 1) / parts;
}

// The two halves of a cluster barrier. arrive_relaxed() at the start of a
// kernel and wait() before the first store into another CTA's shared
// memory make sure that CTA has started; sync() (arrive with release,
// wait with acquire) makes every CTA's shared-memory stores, its own and
// those into other CTAs, visible to the whole cluster.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

}  // namespace split_k
