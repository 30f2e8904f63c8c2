// relu(x @ w + b) for float32 and bfloat16 operands, on Hopper (sm_90a).
//
// Replaces: distributedmnist_tpu/ops/fused.py::_dense_relu_kernel (the
// Pallas kernel launched through _tiled_dense_call), which takes 128x128
// output tiles with the whole K in one VMEM block, accumulates in f32
// (preferred_element_type) and rounds once to x's dtype.
//
// What bounds it on this card, at the MLP's hidden layer (k=784, n=128):
// at b=1 the bytes of w (401 KB in f32, 201 KB in bf16: 0.12 / 0.06 us at
// 3.35 TB/s); at b=512 the f32 arithmetic (103 MFLOP at the 67 TFLOP/s
// CUDA-core peak, 1.5 us) and, in bf16, the bytes again (1.1 MB, 0.34 us).
// Below a few microseconds, what a kernel actually pays is latency: the
// launch, the global-memory round trips of its K loop, its barriers.
//
// Design (measured with chip_smoke.py, kernel_profile.py and
// kernel_variants.py; the numbers are in PERF.md):
// - Split-K over a thread-block cluster. Each cluster owns one BM x BN
//   output tile, and each of its `split` CTAs takes a contiguous run of K
//   stages and accumulates a partial tile in f32. split is one CTA per
//   stage, at most 16 (a non-portable cluster size); a 64x64 tile, heavy
//   in arithmetic, goes past 8 only while the grid fits on the SMs at
//   once. Tiles are 64x64 when that gives >= 128 CTAs, else 16x64 (f32)
//   or 32x64 (bf16), else 16x32 (m <= 16 costs 16 rows, not 64). At
//   k=784, n=128: 52 CTAs at b=1 in f32 (28 in bf16), 208 (224) at b=128
//   and 128 (224) at b=512.
// - A 2-stage ring in shared memory, each stage 256 bytes of every x row
//   (64 K rows in f32, 128 in bf16) and the matching w rows, kept in x's
//   dtype and filled by cp.async: 16-byte chunks where rows are 16-byte
//   aligned, zero-filled past the matrix edge, masked element copies
//   otherwise. The copy of stage i+1 is in flight while stage i is
//   multiplied. At k=784 a rank holds one or two stages: fewer, larger
//   stages and more CTAs measured faster than four stages of half the
//   depth, since each stage costs a wait and a barrier.
// - float32 stays true f32: FMA on the CUDA cores, no TF32 and no tensor
//   cores. The float32 engine is the reference every serving variant's
//   parity gate is judged against, and TF32 keeps 10 mantissa bits. Each
//   of 128 threads owns a TM x 4 register tile; on the 16-row tiles the
//   threads also split each stage's K rows into groups (summed in a fixed
//   order), so a w element is read from shared memory twice, not by every
//   row of threads: that read, not the FMAs, bounded the small tiles.
// - bfloat16 runs on the tensor cores: mma.sync m16n8k16 bf16 x bf16 with
//   an f32 accumulator, fragments loaded with ldmatrix (w transposed on
//   the way, as it is stored k-major); every product of two bf16 values is
//   exact in f32, as on the TPU's MXU.
// - The reduction: each rank owns a contiguous slice of the tile's
//   elements. After its K loop, every rank stores its partial of each
//   slice into the owner's shared memory (its own row of the owner's
//   receive buffer); one cluster barrier later, the
//   owner sums the rows in the fixed order 0, 1, ..., split-1. So the
//   result is the same bits on every run, with no atomics and one barrier
//   (plus an arrive at the start that the pushes wait on, so that no CTA
//   writes into one that has not started). Bias, relu and the one
//   rounding to x's dtype run once, on the summed value, before the store.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;      // 4 warps
constexpr int STAGES = 2;
constexpr int TARGET_CTAS = 128;  // about one CTA per SM (132)

// K rows per pipeline stage: 256 bytes of each x row, so 64 in float32
// and 128 in bfloat16.
template <typename T>
constexpr int BK = 256 / sizeof(T);

// CTAs per cluster at most: 16, a non-portable cluster size, which the
// H100 allows.
constexpr int MAX_SPLIT = 16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One stage of the ring: the x tile (BM x BK) and the w tile (BK x BN),
// rows padded by 16 bytes so that they stay 16-byte aligned and reads of
// eight consecutive rows fall in different banks.
template <typename T, int BM, int BN>
struct Stage {
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int XS = BK<T> + PAD;  // x row stride
  static constexpr int WS = BN + PAD;  // w row stride
  static constexpr int X_ELEMS = BM * XS;
  static constexpr int ELEMS = BM * XS + BK<T> * WS;
};

// float32 on the CUDA cores. Thread tid owns columns 4tx..4tx+3 of rows
// rg, rg + RG, ... and, when the tile has few rows, only a 1/KG share of
// each stage's K rows: K groups let each w element be read from shared
// memory by two threads rather than by every row group. The K groups'
// sums are then added in the order 0..KG-1 through `scratch`.
template <int BM, int BN>
struct F32Math {
  using S = Stage<float, BM, BN>;
  static constexpr int TX = BN / 4;
  static constexpr int GROUPS = THREADS / TX;
  static constexpr int KG = BM >= 64 ? 1 : GROUPS / 2;
  static constexpr int RG = GROUPS / KG;
  static constexpr int TM = BM / RG;
  static constexpr int KK = BK<float> / KG;  // K rows per group and stage
  static_assert(TM >= 1 && BM % RG == 0 && KK % 4 == 0, "thread tiling");
  static constexpr int SCRATCH_FLOATS = KG > 1 ? KG * BM * BN : 0;
  float acc[TM][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ __forceinline__ void step(const float* xs, const float* ws,
                                       int tid) {
    const int tx = tid % TX, grp = tid / TX, kg = grp % KG, rg = grp / KG;
    const float* xr = xs + rg * S::XS + kg * KK;
    const float* wr = ws + kg * KK * S::WS + 4 * tx;
#pragma unroll
    for (int kk = 0; kk < KK; kk += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xr + RG * i * S::XS + kk);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wr + (kk + q) * S::WS);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][0] = fmaf(a[i][q], wv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][q], wv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][q], wv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][q], wv.w, acc[i][3]);
        }
      }
    }
  }

  // Hand every float4 of this CTA's partial tile (index row * BN/4 +
  // col/4) to sink.put4.
  template <typename Sink>
  __device__ __forceinline__ void finish(float* scratch, int tid,
                                         const Sink& sink) const {
    const int tx = tid % TX, grp = tid / TX, kg = grp % KG, rg = grp / KG;
    if constexpr (KG == 1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        sink.put4((rg + RG * i) * TX + tx,
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    } else {
      float4* s4 = reinterpret_cast<float4*>(scratch);
#pragma unroll
      for (int i = 0; i < TM; ++i)
        s4[(kg * BM + rg + RG * i) * TX + tx] =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();
      for (int e = tid; e < BM * TX; e += THREADS) {
        float4 s = s4[e];
#pragma unroll
        for (int g = 1; g < KG; ++g) {
          const float4 p = s4[g * BM * TX + e];
          s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
        }
        sink.put4(e, s);
      }
    }
  }
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(split_k::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(split_k::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bfloat16 on the tensor cores: the 4 warps tile the output WARPS_M x
// WARPS_N; each warp owns MT x NT mma tiles of 16 x 8.
template <int BM, int BN>
struct Bf16Math {
  using S = Stage<__nv_bfloat16, BM, BN>;
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 8 == 0, "mma tile shape");
  static constexpr int SCRATCH_FLOATS = 0;
  float acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  }

  __device__ __forceinline__ void step(const __nv_bfloat16* xs,
                                       const __nv_bfloat16* ws, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int ks = 0; ks < BK<__nv_bfloat16>; ks += 16) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xs + (wm * WM + 16 * i + (lane & 15)) * S::XS +
                              ks + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned b[2];
        ldmatrix_x2_trans(b, ws + (ks + (lane & 15)) * S::WS + wn * WN + 8 * j);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(acc[i][j], a[i], b);
      }
    }
  }

  // Hand every pair of this CTA's partial tile to sink.put2 (the float4
  // index row * BN/4 + col/4 and which half of it).
  template <typename Sink>
  __device__ __forceinline__ void finish(float*, int tid,
                                         const Sink& sink) const {
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm * WM + 16 * i + g, c = wn * WN + 8 * j + 2 * t;
        const int e = r * (BN / 4) + c / 4, half = (c % 4) / 2;
        sink.put2(e, half, make_float2(acc[i][j][0], acc[i][j][1]));
        sink.put2(e + 8 * (BN / 4), half,
                  make_float2(acc[i][j][2], acc[i][j][3]));
      }
  }
};

template <typename T, int BM, int BN>
using MathOf = typename std::conditional<std::is_same<T, float>::value,
                                         F32Math<BM, BN>,
                                         Bf16Math<BM, BN>>::type;

// Dynamic shared memory, in bytes: the ring (after the K loop, the K
// groups' scratch), the receive buffer of this rank's slice of the tile
// (one slice from every rank), the tile's bias.
template <typename T, int BM, int BN>
struct Smem {
  static constexpr size_t RING =
      size_t(STAGES) * Stage<T, BM, BN>::ELEMS * sizeof(T);
  static constexpr size_t SCRATCH =
      size_t(MathOf<T, BM, BN>::SCRATCH_FLOATS) * sizeof(float);
  static constexpr size_t RECV = RING > SCRATCH ? RING : SCRATCH;
  static constexpr size_t BIAS =
      RECV + size_t(BM * BN / 4 + MAX_SPLIT) * sizeof(float4);
  static constexpr size_t BYTES = BIAS + BN * sizeof(T);
};

// Stores each float4 (or half of one) of a rank's partial tile into the
// receive buffer of the rank that owns it, at this rank's row.
struct Push {
  float* recv;
  int rank, split, total4, cap4;

  __device__ __forceinline__ float* slot(int e) const {
    const int owner = split_k::slice_owner(e, split, total4);
    const int i = e - split_k::slice_first(owner, split, total4);
    return cg::this_cluster().map_shared_rank(recv, owner) +
           4 * (rank * cap4 + i);
  }
  __device__ __forceinline__ void put4(int e, float4 v) const {
    *reinterpret_cast<float4*>(slot(e)) = v;
  }
  __device__ __forceinline__ void put2(int e, int half, float2 v) const {
    *reinterpret_cast<float2*>(slot(e) + 2 * half) = v;
  }
};

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(THREADS)
dense_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ out, int m, int n,
                  int k, int vec_x, int vec_w, int vec_b) {
  using S = Stage<T, BM, BN>;
  using L = Smem<T, BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* scratch = reinterpret_cast<float*>(smem);  // after the K loop
  float* recv = reinterpret_cast<float*>(smem + L::RECV);
  T* bias = reinterpret_cast<T*>(smem + L::BIAS);

  split_k::cluster_arrive_relaxed();  // this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int col0 = (blockIdx.x / split) * BN;
  const int row0 = blockIdx.y * BM;

  // this rank's contiguous run of K tiles
  const int ktiles = (k + BK<T> - 1) / BK<T>;
  const int t0 = rank * ktiles / split;
  const int nt = (rank + 1) * ktiles / split - t0;

  auto load = [&](int stage, int tile) {
    T* xs = ring + stage * S::ELEMS;
    const int k0 = (t0 + tile) * BK<T>;
    split_k::load_tile<T, BM, BK<T>, S::XS, THREADS>(xs, x, m, k, row0, k0,
                                                     vec_x, tid);
    split_k::load_tile<T, BK<T>, BN, S::WS, THREADS>(
        xs + S::X_ELEMS, w, k, n, k0, col0, vec_w, tid);
  };

  MathOf<T, BM, BN> mm;
  mm.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s, s);
    split_k::commit();
  }
  // the tile's bias, for the epilogue (complete by wait_all below)
  split_k::load_tile<T, 1, BN, BN, THREADS>(bias, b, 1, n, 0, col0, vec_b,
                                            tid);
  for (int t = 0; t < nt; ++t) {
    split_k::wait<STAGES - 2>();  // tile t has landed (this thread's part)
    __syncthreads();              // ... and everyone's; stage t-1 is free
    if (t + STAGES - 1 < nt) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    split_k::commit();
    const T* xs = ring + (t % STAGES) * S::ELEMS;
    mm.step(xs, xs + S::X_ELEMS, tid);
  }
  split_k::wait_all();
  __syncthreads();  // the ring is free for the K groups' scratch

  // Every rank owns a slice of the tile's float4s; each rank stores its
  // partial of that slice into the owner's receive buffer.
  constexpr int TOTAL4 = BM * BN / 4;
  const int cap4 = (TOTAL4 + split - 1) / split;
  split_k::cluster_wait();  // every CTA of the cluster has started
  mm.finish(scratch, tid, Push{recv, rank, split, TOTAL4, cap4});
  split_k::cluster_sync();  // every slice has arrived

  // Sum the slice over ranks 0, 1, ..., split-1 in that order, then bias,
  // relu and the one rounding to T.
  const int first = split_k::slice_first(rank, split, TOTAL4);
  const int count = split_k::slice_first(rank + 1, split, TOTAL4) - first;
  const float4* r4 = reinterpret_cast<const float4*>(recv);
  for (int i = tid; i < count; i += THREADS) {
    float4 s = r4[i];
#pragma unroll
    for (int q0 = 1; q0 < MAX_SPLIT; q0 += 8) {
      float4 p[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (q0 + j < split) p[j] = r4[(q0 + j) * cap4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (q0 + j < split)
          s.x += p[j].x, s.y += p[j].y, s.z += p[j].z, s.w += p[j].w;
    }
    const int e = first + i;
    const int r = row0 + e / (BN / 4);
    const int c = (e % (BN / 4)) * 4;
    if (r >= m) continue;
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col0 + c + j < n)
        out[static_cast<size_t>(r) * n + col0 + c + j] =
            from_f32<T>(fmaxf(v[j] + to_f32(bias[c + j]), 0.0f));
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

long long tiles(int m, int n, int bm, int bn) {
  return static_cast<long long>((n + bn - 1) / bn) * ((m + bm - 1) / bm);
}

template <typename T, int BM, int BN>
cudaError_t set_attributes() {
  auto kernel = dense_relu_kernel<T, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<T, BM, BN>::BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <typename T, int BM, int BN>
int launch_tiles(const void* x, const void* w, const void* b, void* out,
                 int m, int n, int k, int split, cudaStream_t stream) {
  static split_k::DeviceOnce attributes;
  const cudaError_t attr = attributes.get(set_attributes<T, BM, BN>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int mtiles = (m + BM - 1) / BM;
  if (mtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * ((n + BN - 1) / BN), mtiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = Smem<T, BM, BN>::BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const int vec_x = split_k::rows_aligned(x, k, sizeof(T));
  const int vec_w = split_k::rows_aligned(w, n, sizeof(T));
  const int vec_b = split_k::aligned16(b);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, dense_relu_kernel<T, BM, BN>, static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(out), m, n, k, vec_x, vec_w, vec_b));
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* out, int m,
           int n, int k, cudaStream_t stream) {
  cudaGetLastError();  // start from a clean error state
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  // One CTA of the cluster per K tile, up to MAX_SPLIT. A 64x64 tile
  // carries enough arithmetic to keep an SM busy, so its cluster grows
  // past 8 only while the grid still fits on the SMs at once.
  const int ktiles = (k + BK<T> - 1) / BK<T>;
  const int split = ktiles < MAX_SPLIT ? ktiles : MAX_SPLIT;
  const long long big = tiles(m, n, 64, 64);
  long long big_split = sm_count() / big;
  big_split = split <= 8 ? split
                         : (big_split < 8 ? 8
                                          : (big_split < split ? big_split
                                                               : split));
  // the largest tile that still fills the card, else the smallest; the
  // middle one is 16x64 in f32 (K groups need the rows few) and 32x64 in
  // bf16 (two mma row tiles a warp pair)
  constexpr int MID = std::is_same<T, float>::value ? 16 : 32;
  if (big_split * big >= TARGET_CTAS)
    return launch_tiles<T, 64, 64>(x, w, b, out, m, n, k,
                                   static_cast<int>(big_split), stream);
  if (split * tiles(m, n, MID, 64) >= TARGET_CTAS)
    return launch_tiles<T, MID, 64>(x, w, b, out, m, n, k, split, stream);
  return launch_tiles<T, 16, 32>(x, w, b, out, m, n, k, split, stream);
}

}  // namespace

extern "C" int dense_relu_f32(const void* x, const void* w, const void* b,
                              void* out, int m, int n, int k, void* stream) {
  return launch<float>(x, w, b, out, m, n, k,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int dense_relu_bf16(const void* x, const void* w, const void* b,
                               void* out, int m, int n, int k, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, out, m, n, k,
                               static_cast<cudaStream_t>(stream));
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
