// The parameter gradients of LeNet-5's first convolution, float32, on
// Hopper (sm_90a): dW (5, 5, 1, 6) HWIO and db (6,) of a stride-1, SAME
// convolution of one-channel 28 x 28 images by six 5 x 5 filters, from
// the images x (B, 28, 28, 1) and the output gradient g (B, 28, 28, 6),
// both NHWC:
//   dW[kh][kw][0][f] = sum over b, i, j of
//                      x[b][i + kh - 2][j + kw - 2] * g[b][i][j][f]
//   db[f]            = sum over b, i, j of g[b][i][j][f]
// (x zero outside the image).
//
// Replaces no TPU kernel: the JAX package leaves this convolution's
// backward to XLA. It was added because training restricts cuDNN to its
// deterministic algorithms (utils/device.training_numerics, so that a run
// repeats bit for bit), and cuDNN's deterministic weight-gradient engine
// took 3.8 ms of a 6.6 ms LeNet-5 step at 4,096 rows on the H100: 0.7% of
// its roofline. The shape is what its tiles do not fit: one input
// channel, 150 weights, a reduction over 3.2 M positions.
//
// What bounds it on this card: HBM bytes. Each row is read once, its
// image (784 floats) and its output gradient (4,704 floats), 21,952
// bytes; at 4,096 rows 89.9 MB, 26.8 us at 3.35 TB/s, against 14.4 us for
// its 482 M multiply-adds at the 67 TFLOP/s float32 peak. float32 stays
// true float32: FMAs on the CUDA cores, no tensor cores.
//
// Design:
// - Pass 1 (wgrad_partials): a fixed grid, sized from the row count
//   alone (at most MAX_BLOCKS blocks, each a contiguous run of rows) and
//   never from the card's SM count, so that every sum is taken in the
//   same order on any card. At 4,096 rows: 512 blocks of 8 rows, all
//   resident at once (4 blocks an SM). A block copies each of its rows
//   into shared memory with 16-byte cp.async, two stages deep (row n+1 in
//   flight while row n is reduced): the image into a zero-bordered tile,
//   so that SAME's padding costs no test, and the gradient as it lies.
// - Threads: warp kw owns kernel column kw, lane j image column j. Down
//   the column, a thread keeps the five image values under its taps in
//   registers (one new load a row) and reads a position's six gradients
//   as three 8-byte loads (consecutive lanes, consecutive 24-byte runs:
//   no bank conflict); 30 FMAs a position into its 30 accumulators (five
//   kernel rows x six filters), and, on every fifth row, six bias sums:
//   36 accumulators a thread.
// - The reduction, in a fixed order everywhere: a thread over its rows in
//   turn; a warp's lanes by a butterfly of shuffles; the warps' bias sums
//   in warp order; each block writes 156 partial sums to a scratch array
//   that the caller allocates. Pass 2 (wgrad_sum, one block) adds them up
//   in six interleaved chains and then the chains in turn, and writes dW
//   and db. No atomics: two calls on the same inputs give the same bits.

#include <cuda_runtime.h>

#include "split_k.cuh"

namespace {

constexpr int H = 28, W = 28, KS = 5, F = 6;
constexpr int PAD = KS / 2;
constexpr int THREADS = KS * 32;        // a warp a kernel column
// The shared-memory tile of one image: rows -PAD..H+PAD-1 of the
// padded image, the image's columns starting at XOFF (a 16-byte
// boundary, for cp.async), zeros around it.
constexpr int XOFF = 4;
constexpr int PITCH = XOFF + W + 4;
constexpr int TILE = (H + 2 * PAD) * PITCH;
constexpr int IMG = H * W;
constexpr int GRAD = H * W * F;
constexpr int STAGE = TILE + GRAD;      // floats
constexpr int NW = KS * KS * F;         // dW's elements, HWIO
constexpr int NPART = NW + F;           // a block's partial sums
constexpr int MAX_BLOCKS = 512;
constexpr int CHAINS = 6;
static_assert(W <= 32, "a lane an image column");
static_assert(XOFF >= PAD && XOFF % 4 == 0 && PITCH % 4 == 0 &&
                  PITCH >= XOFF + W + PAD,
              "the tile's borders hold the padding; rows 16-byte aligned");
static_assert(W % 4 == 0 && GRAD % 4 == 0, "16-byte chunks");
static_assert(F % 2 == 0, "gradients read two at a time");
static_assert(NPART * CHAINS <= 1024, "pass 2 in one block");

// Start the cp.async copies of row n's image and gradient into `stage`.
__device__ __forceinline__ void load_row(float* stage, const float* x,
                                         const float* g, size_t n,
                                         int tid) {
  constexpr int XCH = IMG / 4;          // the image's 16-byte chunks
  constexpr int CH = XCH + GRAD / 4;
  const float* xs = x + n * IMG;
  const float* gs = g + n * GRAD;
  for (int c = tid; c < CH; c += THREADS) {
    if (c < XCH) {
      const int r = c / (W / 4), q = c % (W / 4);
      split_k::cp_async16(stage + (r + PAD) * PITCH + XOFF + 4 * q,
                          xs + 4 * c, 16);
    } else {
      const int e = 4 * (c - XCH);
      split_k::cp_async16(stage + TILE + e, gs + e, 16);
    }
  }
}

// Add one staged row's products into this thread's accumulators:
// kernel column kw, image column j, every image row in turn.
__device__ __forceinline__ void accumulate(const float* stage, int kw, int j,
                                           float (&acc)[KS][F],
                                           float (&bacc)[F]) {
  const float* xc = stage + XOFF - PAD + kw + j;
  const float* gc = stage + TILE + j * F;
  float win[KS];                        // win[kh] = padded x[i + kh][.]
#pragma unroll
  for (int k = 0; k < KS - 1; ++k) win[k] = xc[k * PITCH];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    win[KS - 1] = xc[(i + KS - 1) * PITCH];
    float gv[F];
#pragma unroll
    for (int f = 0; f < F; f += 2) {
      const float2 v = *reinterpret_cast<const float2*>(gc + i * W * F + f);
      gv[f] = v.x;
      gv[f + 1] = v.y;
    }
#pragma unroll
    for (int kh = 0; kh < KS; ++kh)
#pragma unroll
      for (int f = 0; f < F; ++f) acc[kh][f] = fmaf(win[kh], gv[f], acc[kh][f]);
    if (i % KS == kw) {
#pragma unroll
      for (int f = 0; f < F; ++f) bacc[f] += gv[f];
    }
#pragma unroll
    for (int k = 0; k < KS - 1; ++k) win[k] = win[k + 1];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 4 blocks an SM: 46.8 KB of shared memory each, at most 102 registers
// a thread
__global__ void __launch_bounds__(THREADS, 4)
    wgrad_partials(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ part, int rows, int per) {
  __shared__ __align__(16) float smem[2 * STAGE];
  const int tid = threadIdx.x, kw = tid / 32, j = tid % 32;
  // the tiles' borders are the padding: zero both tiles once
  for (int e = tid; e < TILE; e += THREADS) {
    smem[e] = 0.0f;
    smem[STAGE + e] = 0.0f;
  }
  __syncthreads();

  const int first = blockIdx.x * per;
  const int last = min(first + per, rows);
  float acc[KS][F], bacc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    bacc[f] = 0.0f;
#pragma unroll
    for (int kh = 0; kh < KS; ++kh) acc[kh][f] = 0.0f;
  }
  load_row(smem, x, g, first, tid);
  split_k::commit();
  for (int n = first; n < last; ++n) {
    const int s = (n - first) & 1;
    if (n + 1 < last) load_row(smem + (s ^ 1) * STAGE, x, g, n + 1, tid);
    split_k::commit();
    split_k::wait<1>();                 // row n has landed
    __syncthreads();
    if (j < W) accumulate(smem + s * STAGE, kw, j, acc, bacc);
    __syncthreads();                    // stage s is free again
  }
  split_k::wait_all();

#pragma unroll
  for (int kh = 0; kh < KS; ++kh)
#pragma unroll
    for (int f = 0; f < F; ++f) acc[kh][f] = warp_sum(acc[kh][f]);
#pragma unroll
  for (int f = 0; f < F; ++f) bacc[f] = warp_sum(bacc[f]);
  // a warp's sums, by kernel column kw: red[kw][kh * F + f], then the
  // bias sums red[kw][KS * F + f]
  float* red = smem;
  constexpr int RS = KS * F + F;
  if (j == 0) {
#pragma unroll
    for (int kh = 0; kh < KS; ++kh)
#pragma unroll
      for (int f = 0; f < F; ++f) red[kw * RS + kh * F + f] = acc[kh][f];
#pragma unroll
    for (int f = 0; f < F; ++f) red[kw * RS + KS * F + f] = bacc[f];
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * NPART;
  if (tid < NW) {
    const int kh = tid / (KS * F), c = tid % (KS * F);
    out[tid] = red[(c / F) * RS + kh * F + c % F];
  } else if (tid < NPART) {
    const int f = tid - NW;
    float s = 0.0f;
    for (int w = 0; w < KS; ++w) s += red[w * RS + KS * F + f];
    out[tid] = s;
  }
}

__global__ void __launch_bounds__(NPART * CHAINS)
    wgrad_sum(const float* __restrict__ part, int blocks,
              float* __restrict__ dw, float* __restrict__ db) {
  __shared__ float chain[CHAINS][NPART];
  const int t = threadIdx.x, k = t % NPART, c = t / NPART;
  float s = 0.0f;
#pragma unroll 8
  for (int b = c; b < blocks; b += CHAINS)
    s += part[static_cast<size_t>(b) * NPART + k];
  chain[c][k] = s;
  __syncthreads();
  if (t < NPART) {
    float total = chain[0][t];
    for (int i = 1; i < CHAINS; ++i) total += chain[i][t];
    if (t < NW)
      dw[t] = total;
    else
      db[t - NW] = total;
  }
}

}  // namespace

// x (rows, 28, 28, 1) and g (rows, 28, 28, 6), float32, contiguous and
// 16-byte aligned; part holds part_blocks x 156 floats of scratch; dw
// (5, 5, 1, 6) and db (6,) are written. h, w, ks and filters restate the
// shape, which must be the one compiled here.
extern "C" int conv_wgrad_1ch_f32(const void* x, const void* g, void* part,
                                  void* dw, void* db, int rows, int h, int w,
                                  int ks, int filters, int part_blocks,
                                  void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (rows < 1 || h != H || w != W || ks != KS || filters != F)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!split_k::aligned16(x) || !split_k::aligned16(g))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int per = (rows + MAX_BLOCKS - 1) / MAX_BLOCKS;
  const int blocks = (rows + per - 1) / per;
  if (blocks > part_blocks) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  wgrad_partials<<<blocks, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g),
      static_cast<float*>(part), rows, per);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_sum<<<1, NPART * CHAINS, 0, s>>>(static_cast<const float*>(part),
                                         blocks, static_cast<float*>(dw),
                                         static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
