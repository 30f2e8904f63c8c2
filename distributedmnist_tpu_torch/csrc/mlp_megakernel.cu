// relu(x @ w1 + b1) @ w2 + b2 — the whole MLP forward in one launch, in
// float32, on Hopper (sm_90a).
//
// Replaces: distributedmnist_tpu/ops/fused.py::_mlp_mega_kernel (the
// Pallas kernel launched by mlp_megakernel), which holds both weight
// matrices whole in VMEM, tiles the batch rows only, pads the 10 logits
// to a 128-wide lane tile, and never lets the hidden activation leave
// VMEM.
//
// What bounds it on this card: at b=1 the bytes of w1 (784x128 f32 =
// 401 KB, 0.12 us at 3.35 TB/s) for 0.2 MFLOP of work; at b=512 the f32
// arithmetic (104 MFLOP at the 67 TFLOP/s CUDA-core peak, 1.6 us). Below
// a few microseconds what the kernel pays is latency: the launch, the
// global-memory round trips of its K loop, and its cluster barriers.
//
// Design (measured with chip_smoke.py, kernel_profile.py and
// kernel_variants.py; the numbers are in PERF.md): w1 does not fit in the
// 227 KB of shared memory one CTA may use, so it is spread over a cluster
// of 8 CTAs.
// - One cluster per tile of BM batch rows: 8 rows when m <= 128, else 32
//   (so b=128 and b=512 both run 128 CTAs; b=1 runs 8).
// - Layer 1, split over K: rank r takes a contiguous eighth of w1's
//   64-row stages (1 or 2 of the 13 at k=784, about 50 KB in all) and
//   streams them with the matching x columns through a 2-stage cp.async
//   ring (32 KB of w1 a stage), so the copy of stage i+1 overlaps the
//   FMAs on stage i. Lane l of each warp owns hidden columns 4l..4l+3;
//   the 8 warps split the rows and each stage's K rows between them
//   (8 K groups at BM=8, 2 at BM=32), so each w1 element is read from
//   shared memory by one or four warps, not eight: with eight, that read
//   bounded layer 1. The K groups are summed in a fixed order.
// - Hidden reduction: rank r owns hidden columns 16r..16r+15. Every rank
//   stores its partial of those columns from its own shared memory into
//   rank r's receive buffer (distributed shared memory); after a cluster
//   barrier rank r sums the 8 rows in the fixed rank order 0..7, adds b1
//   and applies relu. The hidden activation never goes to device memory,
//   as on the TPU.
// - Layer 2: rank r multiplies its 16 hidden columns by its 16 rows of w2
//   (staged in shared memory while layer 1 runs) into partial (BM x n2)
//   logits, stored into the receive buffers of the ranks that own them;
//   after a second barrier each rank sums its eighth of the logits over
//   ranks 0..7 in that order, adds b2 and stores them. Fixed orders and no
//   atomics: the same bits on every run.
// - Everything is f32 FMA on the CUDA cores: the megakernel variant's
//   parity gate holds it to the float32 engine at 1% of the logit scale,
//   and its CPU twin at 1e-5; TF32 would keep 10 mantissa bits.
// The kernel's own limits (HID == 128 hidden units, n2 <= 32 logits) are
// checked once, in mlp_megakernel_f32 below.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "split_k.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HID = 128;              // hidden width the kernel is built for
constexpr int MAX_OUT = 32;           // n2 limit of the logit buffers
constexpr int CLUSTER = 8;            // CTAs per cluster (portable maximum)
constexpr int COLS = HID / CLUSTER;   // hidden columns owned by each rank
constexpr int BK = 64;                // w1 rows per pipeline stage
constexpr int STAGES = 2;
constexpr int THREADS = 256;          // 8 warps; lane l owns columns 4l..4l+3
constexpr int SMALL_M = 128;          // up to here, 8-row tiles

// Warp w of a BM-row tile takes rows rg, rg + RG, ... (rg = w / KG) and
// a 1/KG share of each stage's K rows (kg = w % KG).
template <int BM>
struct Tiling {
  static constexpr int KG = BM == 8 ? 8 : 2;
  static constexpr int RG = 8 / KG;
  static constexpr int TM = BM / RG;  // rows per thread
  static constexpr int KK = BK / KG;  // K rows per group and stage
};

// Shared memory, in floats.
template <int BM>
struct Layout {
  static constexpr int XS = BK + 4;   // x tile row stride (16-byte rows)
  static constexpr int X_ELEMS = BM * XS;
  static constexpr int STAGE = X_ELEMS + BK * HID;
  static constexpr int SCRATCH = Tiling<BM>::KG * BM * HID;  // K groups
  static constexpr int RING = STAGES * STAGE > SCRATCH ? STAGES * STAGE
                                                       : SCRATCH;
  static constexpr int LCAP = (BM * MAX_OUT + CLUSTER - 1) / CLUSTER;
  static constexpr int RECV_H = RING;   // [8][BM][COLS], a row per rank
  static constexpr int RECV_L = RECV_H + CLUSTER * BM * COLS;  // [8][LCAP]
  static constexpr int HS = RECV_L + CLUSTER * LCAP;  // [BM][COLS] hidden
  static constexpr int W2S = HS + BM * COLS;          // [COLS][n2] w2 rows
  static constexpr int B1S = W2S + COLS * MAX_OUT;    // [COLS] b1 slice
  static constexpr int B2S = B1S + COLS;              // [MAX_OUT] b2
  static constexpr size_t BYTES = sizeof(float) * (B2S + MAX_OUT);
};

template <int BM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
mlp_megakernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int m,
               int k, int n2, int vec_x, int vec_w1, int vec_small) {
  using L = Layout<BM>;
  using G = Tiling<BM>;
  extern __shared__ __align__(16) float smem[];
  float4* scratch = reinterpret_cast<float4*>(smem);  // after the K loop
  float* recv_h = smem + L::RECV_H;
  float* recv_l = smem + L::RECV_L;
  float* hs = smem + L::HS;
  float* w2s = smem + L::W2S;
  float* b1s = smem + L::B1S;
  float* b2s = smem + L::B2S;

  split_k::cluster_arrive_relaxed();  // this CTA has started
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int kg = warp % G::KG, rg = warp / G::KG;
  const int row0 = (blockIdx.x / CLUSTER) * BM;

  const int ktiles = (k + BK - 1) / BK;
  const int t0 = rank * ktiles / CLUSTER;
  const int nt = (rank + 1) * ktiles / CLUSTER - t0;

  auto load = [&](int stage, int tile) {
    float* xs = smem + stage * L::STAGE;
    const int k0 = (t0 + tile) * BK;
    split_k::load_tile<float, BM, BK, L::XS, THREADS>(xs, x, m, k, row0, k0,
                                                      vec_x, tid);
    split_k::load_tile<float, BK, HID, HID, THREADS>(
        xs + L::X_ELEMS, w1, k, HID, k0, 0, vec_w1, tid);
  };

  float acc[G::TM][4];
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) load(s, s);
    split_k::commit();
  }
  // this rank's 16 rows of w2 (contiguous: one row of 16*n2 floats), its
  // slice of b1, and b2, for after the K loop (complete by wait_all)
  split_k::load_tile<float, 1, COLS * MAX_OUT, COLS * MAX_OUT, THREADS>(
      w2s, w2 + rank * COLS * n2, 1, COLS * n2, 0, 0, vec_small, tid);
  split_k::load_tile<float, 1, COLS, COLS, THREADS>(
      b1s, b1 + rank * COLS, 1, COLS, 0, 0, vec_small, tid);
  split_k::load_tile<float, 1, MAX_OUT, MAX_OUT, THREADS>(
      b2s, b2, 1, n2, 0, 0, vec_small, tid);
  for (int t = 0; t < nt; ++t) {
    split_k::wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < nt) load((t + STAGES - 1) % STAGES, t + STAGES - 1);
    split_k::commit();
    const float* xs = smem + (t % STAGES) * L::STAGE;
    const float* xr = xs + rg * L::XS + kg * G::KK;
    const float* wr = xs + L::X_ELEMS + kg * G::KK * HID + 4 * lane;
#pragma unroll
    for (int kk = 0; kk < G::KK; kk += 4) {
      float a[G::TM][4];
#pragma unroll
      for (int i = 0; i < G::TM; ++i) {
        const float4 v =
            *reinterpret_cast<const float4*>(xr + G::RG * i * L::XS + kk);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(wr + (kk + q) * HID);
#pragma unroll
        for (int i = 0; i < G::TM; ++i) {
          acc[i][0] = fmaf(a[i][q], wv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i][q], wv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i][q], wv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i][q], wv.w, acc[i][3]);
        }
      }
    }
  }
  split_k::wait_all();
  __syncthreads();  // the ring is free for the K groups' scratch
  constexpr int Q = HID / 4;  // float4s in a hidden row
#pragma unroll
  for (int i = 0; i < G::TM; ++i)
    scratch[(kg * BM + rg + G::RG * i) * Q + lane] =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();

  // This rank's partial hidden tile, its K groups summed in order 0..KG-1;
  // columns 16r..16r+15 go to rank r's receive buffer.
  split_k::cluster_wait();  // every CTA of the cluster has started
  for (int e = tid; e < BM * Q; e += THREADS) {
    float4 s = scratch[e];
#pragma unroll
    for (int g = 1; g < G::KG; ++g) {
      const float4 p = scratch[g * BM * Q + e];
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    const int row = e / Q, col = 4 * (e % Q);
    *reinterpret_cast<float4*>(
        cluster.map_shared_rank(recv_h, col / COLS) +
        (rank * BM + row) * COLS + col % COLS) = s;
  }
  split_k::cluster_sync();

  // hidden columns 16*rank .. +15: the 8 partials summed in rank order
  // 0..7, then b1 and relu. The hidden activation stays on chip.
  for (int e = tid; e < BM * COLS / 4; e += THREADS) {
    const int row = e / (COLS / 4), c = 4 * (e % (COLS / 4));
    float4 s = *reinterpret_cast<const float4*>(recv_h + row * COLS + c);
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(
          recv_h + (q * BM + row) * COLS + c);
      s.x += p.x, s.y += p.y, s.z += p.z, s.w += p.w;
    }
    float* h = hs + row * COLS + c;
    h[0] = fmaxf(s.x + b1s[c], 0.0f);
    h[1] = fmaxf(s.y + b1s[c + 1], 0.0f);
    h[2] = fmaxf(s.z + b1s[c + 2], 0.0f);
    h[3] = fmaxf(s.w + b1s[c + 3], 0.0f);
  }
  __syncthreads();

  // partial logits of this rank's 16 hidden columns, each to the rank
  // that owns its slice of the (BM x n2) logits
  const int total = BM * n2;
  const int cap = (total + CLUSTER - 1) / CLUSTER;
  for (int e = tid; e < total; e += THREADS) {
    const int r = e / n2, j = e % n2;
    float o = 0.0f;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      o = fmaf(hs[r * COLS + c], w2s[c * n2 + j], o);
    const int owner = split_k::slice_owner(e, CLUSTER, total);
    const int i = e - split_k::slice_first(owner, CLUSTER, total);
    cluster.map_shared_rank(recv_l, owner)[rank * cap + i] = o;
  }
  split_k::cluster_sync();

  // this rank's logits: summed in rank order 0..7, then b2
  const int first = split_k::slice_first(rank, CLUSTER, total);
  const int count = split_k::slice_first(rank + 1, CLUSTER, total) - first;
  for (int i = tid; i < count; i += THREADS) {
    const int e = first + i, r = e / n2, j = e % n2;
    if (row0 + r >= m) continue;
    float s = recv_l[i];
#pragma unroll
    for (int q = 1; q < CLUSTER; ++q) s += recv_l[q * cap + i];
    out[static_cast<size_t>(row0 + r) * n2 + j] = s + b2s[j];
  }
}

template <int BM>
int launch(const float* x, const float* w1, const float* b1, const float* w2,
           const float* b2, float* out, int m, int k, int n2,
           cudaStream_t stream) {
  constexpr size_t smem = Layout<BM>::BYTES;
  static split_k::DeviceOnce attributes;
  const cudaError_t attr = attributes.get([] {
    return cudaFuncSetAttribute(mlp_megakernel<BM>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(Layout<BM>::BYTES));
  });
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int grid = CLUSTER * ((m + BM - 1) / BM);
  mlp_megakernel<BM><<<grid, THREADS, smem, stream>>>(
      x, w1, b1, w2, b2, out, m, k, n2,
      split_k::rows_aligned(x, k, sizeof(float)),
      split_k::rows_aligned(w1, HID, sizeof(float)),
      split_k::aligned16(w2) && split_k::aligned16(b1) &&
          split_k::aligned16(b2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mlp_megakernel_f32(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, void* out, int m, int k,
                                  int hidden, int n2, void* stream) {
  cudaGetLastError();  // start from a clean error state
  if (m < 1 || k < 1 || hidden != HID || n2 < 1 || n2 > MAX_OUT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto cast = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  return m <= SMALL_M
             ? launch<8>(cast(x), cast(w1), cast(b1), cast(w2), cast(b2), o,
                         m, k, n2, s)
             : launch<32>(cast(x), cast(w1), cast(b1), cast(w2), cast(b2), o,
                          m, k, n2, s);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
