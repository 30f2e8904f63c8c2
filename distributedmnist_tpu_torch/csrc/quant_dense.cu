// (x_q @ w_q) * scale + b, optionally relu'd: int8 x int8 -> int32 with a
// float32 dequant epilogue, on Hopper (sm_90a).
//
// Replaces: distributedmnist_tpu/ops/fused.py::_quant_dense_kernel (the
// Pallas kernel launched by quant_dense through _tiled_dense_call), which
// accumulates int8 products in int32 on the MXU and applies the per-
// output-channel scale and f32 bias before the tile leaves VMEM.
//
// What bounds it on this card: the int8 MLP layers (k=784 -> n=128 with
// relu, k=128 -> n=10 without) do 2*m*k*n integer operations against
// 1,979 TOP/s of int8 tensor-core peak, but read only m*k + k*n bytes, so
// at every serving batch size the bound is the bytes (w_q is 100 KB:
// 0.03 us at 3.35 TB/s) and what a kernel actually pays is latency: the
// launch, the global-memory round trip of its loads, its barriers.
//
// Design (measured with chip_smoke.py, kernel_profile.py and
// kernel_variants.py; the numbers are in PERF.md), after dense_relu.cu:
// - Split-K over a thread-block cluster. Each cluster owns one BM x BN
//   output tile, and each of its `split` CTAs takes a contiguous run of
//   64-deep K stages: one CTA per stage, at most 16 (a non-portable
//   cluster size). Tiles are 64x64 when that gives >= 128 CTAs, else
//   32x32, else 16x16 (m <= 16 costs 16 rows, not 64); a 64x64 tile's
//   partials are 16 KB a rank, so its cluster grows past 4 CTAs only
//   while the grid still fits on the SMs at once. At k=784, n=128: 104
//   CTAs at b=1 and b=7, 208 at b=128, 128 at b=512. Even at k=128 (the
//   MLP's 128->10 layer) two CTAs of one stage each beat one CTA of two:
//   a second stage in one CTA costs more than the cluster's barrier.
// - A 3-stage ring in shared memory, filled by cp.async: 16-byte chunks
//   where rows are 16-byte aligned, zero-filled past the matrix edge,
//   masked byte copies otherwise (the 10-byte rows of the MLP's w2, the
//   120- and 84-byte rows of LeNet's layers, an x that does not start on
//   a 16-byte boundary). Zero bytes add nothing to an integer sum, so any
//   k and n work; n is padded to the tile's width with zeros.
// - int8 tensor cores: mma.sync m16n8k32 s8 x s8 with an s32 accumulator.
//   x rows are contiguous in k, so one ldmatrix.x4 (b16 view) of 16 rows
//   x 32 bytes is the A fragment. The B fragment wants 4 consecutive k of
//   one column in each register, but w_q is stored (k, n) with n
//   contiguous and ldmatrix's .trans exists only for 16-bit elements: each
//   stage's w rows are repacked in shared memory into an [n][k] tile,
//   4x4 bytes at a time with __byte_perm, and then read with ldmatrix.
//   wgmma is left for a later design: its 64-row tiles would waste most of
//   their work at the serving path's b <= 16.
// - The reduction: each rank owns a contiguous slice of the tile's int32
//   elements. After its K loop, every rank writes its partial tile into
//   its own shared memory, then copies each owner's slice into that
//   owner's receive buffer (its own row there) through distributed shared
//   memory, 16 contiguous bytes a thread and a warp's 512 bytes in one
//   run, rather than the mma fragments' scattered 8-byte pairs; each
//   thread reads all its chunks before its first remote store.
//   One cluster barrier later, the owner sums the rows in the order 0, 1,
//   ..., split-1 (plus an arrive at the start that the copies wait on, so
//   that no CTA writes into one that has not started).
//   The int32 sum is exact in any order, so it equals the plain version's
//   bit for bit. The epilogue rounds exactly as the plain version's
//   separate multiply and add do: __int2float_rn, then __fmul_rn, then
//   __fadd_rn — never a fused multiply-add, whose single rounding could
//   move a hidden activation by one ulp and flip the round() of the static
//   activation quantization that follows it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;      // 4 warps
constexpr int STAGES = 3;
constexpr int BK = 64;            // K values (bytes of an x row) per stage
constexpr int TARGET_CTAS = 128;  // about one CTA per SM (132)

// CTAs per cluster at most: 16, a non-portable cluster size, which the
// H100 allows.
constexpr int MAX_SPLIT = 16;

// Row strides in bytes, 16 more than a row so that rows stay 16-byte
// aligned and ldmatrix's eight rows fall in different banks.
constexpr int XS = BK + 16;       // x stage tile [BM][BK]
constexpr int WTS = BK + 16;      // repacked w tile [BN][BK]

// Shared memory, in bytes: the ring of stages (x tile, then w tile as
// stored, [BK][BN]; after the K loop, this rank's partial tile), the
// repacked w tile, the receive buffer of this rank's slice of the tile
// (one slice from every rank), scale and bias.
template <int BM, int BN>
struct Smem {
  static constexpr int WS = BN + 16;  // w stage row stride
  static constexpr int X_BYTES = BM * XS;
  static constexpr int STAGE = X_BYTES + BK * WS;
  static constexpr int PS = BN + 4;   // partial tile row stride, in int32
  static_assert(BM * PS * 4 <= STAGES * STAGE, "partial tile fits the ring");
  static constexpr size_t WT = size_t(STAGES) * STAGE;
  static constexpr size_t RECV = WT + size_t(BN) * WTS;
  static constexpr size_t SCALE =
      RECV + size_t(BM * BN / 4 + MAX_SPLIT) * sizeof(int4);
  static constexpr size_t BIAS = SCALE + BN * sizeof(float);
  static constexpr size_t BYTES = BIAS + BN * sizeof(float);
};

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(split_k::smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The w stage ([BK][BN], n contiguous) into the [BN][BK] tile the B
// fragments are loaded from (k contiguous): each thread transposes 4x4
// blocks, four words of four k rows into four words of four columns.
template <int BN>
__device__ __forceinline__ void repack_w(unsigned char* wt,
                                         const unsigned char* ws, int tid) {
  constexpr int WS = Smem<16, BN>::WS;
  constexpr int NQ = BN / 4;
  for (int e = tid; e < (BK / 4) * NQ; e += THREADS) {
    const int nq = e % NQ, kq = e / NQ;
    const unsigned char* src = ws + 4 * kq * WS + 4 * nq;
    const unsigned r0 = *reinterpret_cast<const unsigned*>(src);
    const unsigned r1 = *reinterpret_cast<const unsigned*>(src + WS);
    const unsigned r2 = *reinterpret_cast<const unsigned*>(src + 2 * WS);
    const unsigned r3 = *reinterpret_cast<const unsigned*>(src + 3 * WS);
    // (k0n0 k1n0 k0n1 k1n1), (k0n2 k1n2 k0n3 k1n3), and for k2, k3
    const unsigned t0 = __byte_perm(r0, r1, 0x5140);
    const unsigned t1 = __byte_perm(r0, r1, 0x7362);
    const unsigned t2 = __byte_perm(r2, r3, 0x5140);
    const unsigned t3 = __byte_perm(r2, r3, 0x7362);
    unsigned char* dst = wt + 4 * nq * WTS + 4 * kq;
    *reinterpret_cast<unsigned*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<unsigned*>(dst + WTS) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<unsigned*>(dst + 2 * WTS) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<unsigned*>(dst + 3 * WTS) = __byte_perm(t1, t3, 0x7632);
  }
}

// The mma warps tile the output WARPS_M x WARPS_N; each owns MT x NT mma
// tiles of 16 x 8 (NT even: B fragments are loaded two n-tiles at a
// time). On a 16x16 tile one warp does all the mma work and the other
// three only copy and repack.
template <int BM, int BN>
struct Mma {
  static constexpr int WARPS_M = BM >= 32 ? 2 : 1;
  static constexpr int WARPS_N = BN / 16 < 4 / WARPS_M ? BN / 16 : 4 / WARPS_M;
  static constexpr int WARPS = WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M;
  static constexpr int WN = BN / WARPS_N;
  static constexpr int MT = WM / 16;
  static constexpr int NT = WN / 8;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "mma tile shape");
  int acc[MT][NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  }

  __device__ __forceinline__ void step(const unsigned char* xs,
                                       const unsigned char* wt, int tid) {
    const int warp = tid / 32, lane = tid % 32;
    if (warp >= WARPS) return;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xs + (wm * WM + 16 * i + (lane & 15)) * XS + ks +
                              (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // n rows 0-7 at k 0-15 and 16-31, then n rows 8-15 likewise
        unsigned b[4];
        ldmatrix_x4(b, wt + (wn * WN + 8 * j + (lane & 7) + (lane >> 4) * 8) *
                               WTS + ks + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_s8(acc[i][j], a[i], b[0], b[1]);
          mma_s8(acc[i][j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // This CTA's partial tile into `part` ([BM][PS] int32).
  __device__ __forceinline__ void store(int* part, int tid) const {
    constexpr int PS = Smem<BM, BN>::PS;
    const int warp = tid / 32, lane = tid % 32;
    if (warp >= WARPS) return;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        int* p = part + (wm * WM + 16 * i + g) * PS + wn * WN + 8 * j + 2 * t;
        *reinterpret_cast<int2*>(p) = make_int2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<int2*>(p + 8 * PS) =
            make_int2(acc[i][j][2], acc[i][j][3]);
      }
  }
};

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS)
quant_dense_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ b, float* __restrict__ out,
                   int m, int n, int k, int relu, int vec_x, int vec_w,
                   int vec_sb) {
  using L = Smem<BM, BN>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* wt = smem + L::WT;
  int* recv = reinterpret_cast<int*>(smem + L::RECV);
  float* scale_s = reinterpret_cast<float*>(smem + L::SCALE);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);

  split_k::cluster_arrive_relaxed();  // this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int col0 = (blockIdx.x / split) * BN;
  const int row0 = blockIdx.y * BM;

  // this rank's contiguous run of K tiles
  const int ktiles = (k + BK - 1) / BK;
  const int t0 = rank * ktiles / split;
  const int nt = (rank + 1) * ktiles / split - t0;

  auto load = [&](int stage, int tile) {
    int8_t* xs = reinterpret_cast<int8_t*>(smem + stage * L::STAGE);
    const int k0 = (t0 + tile) * BK;
    split_k::load_tile<int8_t, BM, BK, XS, THREADS>(xs, x, m, k, row0, k0,
                                                    vec_x, tid);
    split_k::load_tile<int8_t, BK, BN, L::WS, THREADS>(
        xs + L::X_BYTES, w, k, n, k0, col0, vec_w, tid);
  };

  Mma<BM, BN> mm;
  mm.zero();
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s, s);
    split_k::commit();
  }
  // the tile's scale and bias, for the epilogue (complete by wait_all)
  split_k::load_tile<float, 1, BN, BN, THREADS>(scale_s, scale, 1, n, 0, col0,
                                                vec_sb, tid);
  split_k::load_tile<float, 1, BN, BN, THREADS>(bias_s, b, 1, n, 0, col0,
                                                vec_sb, tid);
  for (int t = 0; t < nt; ++t) {
    split_k::wait<STAGES - 2>();  // tile t has landed (this thread's part)
    __syncthreads();              // ... and everyone's; stage t-1 is free
    if (t + STAGES - 1 < nt) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    split_k::commit();
    const unsigned char* xs = smem + (t % STAGES) * L::STAGE;
    repack_w<BN>(wt, xs + L::X_BYTES, tid);
    __syncthreads();              // the [n][k] tile is whole
    mm.step(xs, wt, tid);
  }
  split_k::wait_all();
  __syncthreads();  // the ring is free for the partial tile
  int* part = reinterpret_cast<int*>(smem);
  mm.store(part, tid);
  __syncthreads();

  // Every rank owns a slice of the tile's int4s (index row * BN/4 +
  // col/4). Each thread reads its int4s of this rank's partial tile, all
  // before its first remote store (a local load behind a remote store
  // waits for it), then stores each into the owner's receive buffer.
  constexpr int TOTAL4 = BM * BN / 4;
  constexpr int PER = (TOTAL4 + THREADS - 1) / THREADS;
  const int cap4 = (TOTAL4 + split - 1) / split;
  int4 v[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * THREADS;
    if (e < TOTAL4)
      v[u] = *reinterpret_cast<const int4*>(part + e / (BN / 4) * L::PS +
                                            e % (BN / 4) * 4);
  }
  split_k::cluster_wait();  // every CTA of the cluster has started
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * THREADS;
    if (e >= TOTAL4) continue;
    const int owner = split_k::slice_owner(e, split, TOTAL4);
    const int i = e - split_k::slice_first(owner, split, TOTAL4);
    int* slot = cluster.map_shared_rank(recv, owner) + 4 * (rank * cap4 + i);
    *reinterpret_cast<int4*>(slot) = v[u];
  }
  split_k::cluster_sync();  // every slice has arrived

  // Sum the slice over ranks 0, 1, ..., split-1 in that order, then the
  // epilogue, rounded as the plain version rounds it.
  const int first = split_k::slice_first(rank, split, TOTAL4);
  const int count = split_k::slice_first(rank + 1, split, TOTAL4) - first;
  const int4* r4 = reinterpret_cast<const int4*>(recv);
  for (int i = tid; i < count; i += THREADS) {
    int4 s = r4[i];
#pragma unroll
    for (int q0 = 1; q0 < MAX_SPLIT; q0 += 8) {
      int4 p[8];
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
    const int acc[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (col0 + c + j >= n) continue;
      float v = __fadd_rn(__fmul_rn(__int2float_rn(acc[j]), scale_s[c + j]),
                          bias_s[c + j]);
      if (relu) v = fmaxf(v, 0.0f);
      out[static_cast<size_t>(r) * n + col0 + c + j] = v;
    }
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

template <int BM, int BN>
cudaError_t set_attributes() {
  auto kernel = quant_dense_kernel<BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Smem<BM, BN>::BYTES));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <int BM, int BN>
int launch_tiles(const void* x, const void* w, const void* scale,
                 const void* b, void* out, int m, int n, int k, int relu,
                 int split, cudaStream_t stream) {
  static split_k::DeviceOnce attributes;
  const cudaError_t attr = attributes.get(set_attributes<BM, BN>);
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
  cfg.dynamicSmemBytes = Smem<BM, BN>::BYTES;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const int vec_x = split_k::rows_aligned(x, k, 1);
  const int vec_w = split_k::rows_aligned(w, n, 1);
  const int vec_sb = split_k::aligned16(scale) && split_k::aligned16(b);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, quant_dense_kernel<BM, BN>, static_cast<const int8_t*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(b), static_cast<float*>(out), m, n, k, relu,
      vec_x, vec_w, vec_sb));
}

}  // namespace

extern "C" int quant_dense_s8(const void* x, const void* w, const void* scale,
                              const void* b, void* out, int m, int n, int k,
                              int relu, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (m < 1 || n < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  // One CTA of the cluster per K tile, up to MAX_SPLIT.
  const int ktiles = (k + BK - 1) / BK;
  const int split = ktiles < MAX_SPLIT ? ktiles : MAX_SPLIT;
  // the largest tile that still fills the card, else the smallest
  const long long big = tiles(m, n, 64, 64);
  if (split * big >= TARGET_CTAS) {
    long long cap = sm_count() / big;
    cap = cap < 4 ? 4 : cap;
    const int big_split = cap < split ? static_cast<int>(cap) : split;
    return launch_tiles<64, 64>(x, w, scale, b, out, m, n, k, relu,
                                big_split, s);
  }
  if (split * tiles(m, n, 32, 32) >= TARGET_CTAS)
    return launch_tiles<32, 32>(x, w, scale, b, out, m, n, k, relu, split, s);
  return launch_tiles<16, 16>(x, w, scale, b, out, m, n, k, relu, split, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
