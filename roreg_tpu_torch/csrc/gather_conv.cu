// Gather-GEMM sparse convolution for NVIDIA Hopper (sm_90a).
//
//   out[i, :] = sum_k feats[nbr[i, k], :] @ w[k]      (nbr[i, k] == -1 adds 0)
//
// feats (N, Cin) bf16, nbr (M, K) int32, out (M, Cout) f32. The weights w
// (K, Cin, Cout) bf16 come packed by the caller (kernels/halo_conv.py
// pack_weights, tap-major) as K x Cin/16 stages of 16 input channels in
// wgmma's K-major layout of 8x8 core matrices without swizzle (hopper.cuh
// b_desc); the two 16-channel stages of a 32-channel step lie side by side.
// Cin is a multiple of 32, Cout 32, 64, 128 or 256, K at most 32. An entry
// >= N traps (__trap(): the launch's next synchronisation raises a CUDA
// error and the context is unusable), as an out-of-range index raises in
// the plain version.
//
// Replaces the TPU kernel roreg_tpu/sparse/window_conv.py
// window_gather_conv (Pallas body _kernel, lines 79-95). The TPU version
// slices one contiguous window of source rows per 128-row output tile and
// turns each gather into a one-hot (tile x window) MXU product; that slab
// and its locality bound are TPU workarounds and are not carried over.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): a
// conv does 2*Cin*Cout operations per valid (row, offset) entry and must
// read each referenced source row (Cin bf16), the whole table (M*K*4),
// w once, and write the (M, Cout) f32 output. On the main path most rows
// are padding (the smoke's 20000-point cloud fills 11728/5230/1594/412 of
// the 32768/16384/8192/4096 rows per level), whose table entries are all
// -1, so every one of the 11 shapes of one rotation chunk is bound by
// bytes, mostly the int32 table and the f32 output, both sized to
// capacity; the chunk's 20 convs are bound at about 0.44 ms. chip_smoke.py
// computes each shape's bound from the tables of its run
// (kernels/gather_conv.py conv_work). What holds a kernel back is latency:
// a live tile runs (used offsets) x Cin/32 dependent gather-and-multiply
// steps, up to 216 at Cin 256, and the coarse levels have few live tiles.
//
// Design: a thread block owns a 64-row output tile, with one consumer
// warpgroup and one producer warp. The block brings the tile's 64 x K
// indices in by cp.async in one round trip, lists the offsets some row of
// the tile uses (the others are skipped), and a tile of padding rows writes
// zeros and leaves. The tile's steps, one per (used offset, chunk of 32
// input channels, or 64 at Cout 128), run through a ring of 4-8 slots,
// each a gathered A stage (64 rows, dense, in the K-major core-matrix
// layout) and a weight stage (chunk x Cout). The consumer warpgroup gathers
// the A stages itself, two steps ahead of the one it multiplies: each
// thread brings 2-4 16-byte pieces of rows by cp.async and zeroes the
// pieces of absent (-1) rows with shared-memory stores, then one named
// barrier a step (after a proxy fence) hands the stage to wgmma.mma_async
// m64nNk16, with A and B from shared-memory descriptors, f32 accumulators
// in registers and N covering all of Cout, so rows are gathered once per
// tile; one step's products stay in flight. The producer warp streams the
// weight stages by cp.async.bulk through mbarriers (full: bytes landed;
// empty: every consumer warp's wgmma has read the slot). Where a tile has
// many steps and the grid is small (the coarse levels and one rotation's
// tables), its used offsets are split between the 2 or 4 thread blocks of a
// cluster; each multiplies its share into an f32 partial tile in its shared
// memory, and after a cluster barrier each block sums its rows' partials
// from every block of the cluster through distributed shared memory, in
// rank order. So two launches on the same inputs are bit-equal, and no
// float atomics are used. Knock-out runs on the card showed that no one
// component (gathers, weight copies, products) holds the time: the
// per-step barrier and waits and the per-tile prologue do.
//
// The f32 entry (gather_conv_f32) takes f32 feats and f32 weights, the
// latter packed by the caller (kernels/gather_conv.py pack_split_weights,
// tap-major, two stages a step) as the two bf16 terms Wh = bf16(w), Wl =
// bf16(w - Wh) of each step side by side, [Wh ; Wl]. It runs 32 channels a
// step. Each gathered f32 row piece is read from device memory once: the
// consumer's cp.async gathers bring a step's rows as f32 into its ring
// slot, and at the step each thread splits the pieces it gathered itself
// into a hi and a lo bf16 A stage (Xh = bf16(x), Xl = bf16(x - Xh)) in the
// K-major core-matrix layout, before the step's proxy fence and named
// barrier; the step then runs the three products Xh Wh + Xh Wl + Xl Wh into
// the same f32 accumulators (the arithmetic of kernels/split.py, about 3 *
// 2^-18 of a product lost). The split stages rotate through three (hi, lo)
// pairs, so the step that wrote a pair three steps earlier has finished its
// products for every warp by the previous step's barrier, and one barrier a
// step still suffices. The ring keeps three or more slots (two steps
// gathered ahead of the one multiplied): 96-98 KB at Cout <= 128, two
// thread blocks an SM; 144 KB at Cout 256.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;
namespace cg = cooperative_groups;

constexpr int kBM = 64;             // output rows per tile: wgmma's M
constexpr int kMaxK = 32;           // largest kernel volume taken
constexpr int kLDI = kMaxK + 1;     // index row pitch: a column's reads hit 32 banks
constexpr int kWG = 128;            // the consumer warpgroup
constexpr int kThreads = kWG + 32;  // and the producer warp

// KC input channels per step (KC / 16 wgmma K steps); F32: the f32 entry
template <int COUT, int KC, bool F32>
struct Layout {
  static constexpr int kAStage = kBM * KC * 2;  // a bf16 A stage
  static constexpr int kASbo = KC * 16;         // bytes between its 8-row core matrix groups
  static constexpr int kBStage = KC * COUT * 2;  // one term's weights of a step
  // a ring slot: the step's gathered rows (bf16 A stage, or f32) and its
  // weights (one stage, or [Wh ; Wl])
  static constexpr int kGather = F32 ? kBM * KC * 4 : kAStage;
  static constexpr int kSlot = kGather + (F32 ? 2 : 1) * kBStage;
  static constexpr int kSplitBytes = F32 ? 3 * 2 * kAStage : 0;  // three (hi, lo) A stage pairs
  // a ring of at most 100 KB with the split stages, so that two thread
  // blocks share an SM; three slots at f32 and Cout 256
  static constexpr int kRingBytes = F32 && COUT == 256 ? 3 * kSlot : 102400 - kSplitBytes;
  static constexpr int kStages = kRingBytes / kSlot < 8 ? kRingBytes / kSlot : 8;
  static constexpr int kPitch = COUT + 8;  // f32 row pitch of a partial tile
  static constexpr int kSplitOff = kStages * kSlot;
  static constexpr int kBarOff = kSplitOff + kSplitBytes;
  static constexpr int kBytes = kBarOff + 2 * kStages * 8;
  static_assert(kStages >= 3, "two steps gathered ahead of the one multiplied");
  static_assert(kBM * kPitch * 4 <= kBarOff, "a partial tile fits in the drained ring");
};

template <int COUT, int KC, int SPLIT, bool F32>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ feats,
                   const int32_t* __restrict__ nbr, const __nv_bfloat16* __restrict__ wp,
                   float* __restrict__ out, int64_t m, int64_t n, int cin, int kvol) {
  using L = Layout<COUT, KC, F32>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int idx_s[kBM * kLDI];
  __shared__ int flag_s[kMaxK];  // offset k is used by some row of the tile
  __shared__ int used_s[kMaxK];  // the used offsets, in order
  __shared__ int nused_s;

  const int tid = threadIdx.x;
  int rank = 0;
  if constexpr (SPLIT > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / SPLIT) * kBM;
  const int rows = m - row0 < kBM ? static_cast<int>(m - row0) : kBM;
  const uint32_t full0 = smem_addr(smem + L::kBarOff);
  const uint32_t empty0 = full0 + 8 * kStages;

  // The tile's index rows are contiguous in the table: they come in at once
  // by cp.async, 16 bytes a copy where the table allows it, into the ring's
  // space (unused until the steps start), one round trip. A negative entry
  // is absent; an entry >= n is an error.
  int* raw = reinterpret_cast<int*>(smem);
  const int32_t* tile_nbr = nbr + row0 * kvol;
  const int count = rows * kvol;
  const int nvec = (reinterpret_cast<uintptr_t>(tile_nbr) & 15) == 0 ? count / 4 : 0;
  for (int e = tid; e < nvec; e += kThreads) {
    cp_async_16(smem_addr(raw + 4 * e), tile_nbr + 4 * e, 16);
  }
  for (int e = 4 * nvec + tid; e < count; e += kThreads) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(raw + e)),
                 "l"(tile_nbr + e)
                 : "memory");
  }
  cp_async_commit();
  if (tid < kMaxK) flag_s[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the weight stage's bulk copy
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < kBM * kvol; e += kThreads) {
    const int r = e / kvol;
    const int k = e - r * kvol;
    int src = r < rows ? raw[e] : -1;
    if (src >= n) __trap();
    if (src < 0) {
      src = -1;
    } else {
      flag_s[k] = 1;
    }
    idx_s[r * kLDI + k] = src;
  }
  __syncthreads();
  if (tid < 32) {  // the used offsets, listed in order
    const bool used = tid < kvol && flag_s[tid] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, used);
    if (used) used_s[__popc(ballot & ((1u << tid) - 1u))] = tid;
    if (tid == 0) nused_s = __popc(ballot);
  }
  __syncthreads();
  const int nused = nused_s;
  constexpr int kRows = kBM / SPLIT;  // the rows this block writes

  if (nused == 0) {  // a tile of padding rows: zeros, no gathers, no products
    for (int e = tid; e < kRows * (COUT / 4); e += kThreads) {
      const int64_t row = row0 + rank * kRows + e / (COUT / 4);
      if (row < m) reinterpret_cast<float4*>(out + row * COUT)[e % (COUT / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // this block's share of the used offsets, and its steps
  const int j0 = rank * nused / SPLIT;
  const int chunks = cin / KC;
  const int steps = (((rank + 1) * nused / SPLIT) - j0) * chunks;

  if (tid >= kWG) {  // producer warp: one thread streams the weight stages
    if (tid == kWG) {
      fence_proxy_async();  // the index rows' reads of the ring's space come first
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty0 + 8 * slot, (s / kStages - 1) & 1);
        const int k = used_s[j0 + s / chunks];
        const int c = s - (s / chunks) * chunks;
        constexpr int kBBytes = L::kSlot - L::kGather;
        mbar_arrive_expect_tx(full0 + 8 * slot, kBBytes);
        bulk_copy(smem_addr(smem + slot * L::kSlot + L::kGather),
                  wp + (static_cast<int64_t>(k) * (cin / 16) + (KC / 16) * c) * (F32 ? 2 : 1) * 16 * COUT,
                  kBBytes, full0 + 8 * slot);
      }
    }
  } else {  // consumer warpgroup: gathers the A stages and multiplies
    const int warp = tid / 32;
    const int lane = tid % 32;
    // step s's gather into its slot, one cp.async group (empty past the
    // end); an absent row is zeroed by shared-memory stores and reads
    // nothing. bf16: row r's 16-byte piece j (channels 8j..8j+7 of the
    // chunk) goes to core matrix (r / 8, j), byte (r / 8) * 16 KC + j * 128
    // + (r % 8) * 16. f32: this thread's unit e (row r, channels 8j..8j+7)
    // comes as two 16-byte halves to bytes (h * kUnits + e) * 16, h = 0, 1,
    // for this thread alone to split; eight consecutive threads take one
    // piece of eight consecutive rows, so the split stages' stores of a
    // quarter warp fill 128 contiguous bytes
    constexpr int kUnits = kBM * (KC / 8);  // (row, 8-channel piece) units of a step
    auto unit = [](int e, int& r, int& j) {
      if constexpr (F32) {
        r = (e / KC) * 8 + (e & 7);
        j = (e >> 3) % (KC / 8);
      } else {
        r = e / (KC / 8);
        j = e % (KC / 8);
      }
    };
    auto gather = [&](int s) {
      if (s < steps) {
        const int k = used_s[j0 + s / chunks];
        const int c = s - (s / chunks) * chunks;
        const uint32_t a_s = smem_addr(smem + (s % kStages) * L::kSlot);
#pragma unroll
        for (int i = 0; i < kUnits / kWG; ++i) {
          const int e = tid + i * kWG;
          int r, j;
          unit(e, r, j);
          const int src = idx_s[r * kLDI + k];
          if constexpr (F32) {
            const float* from = feats + static_cast<int64_t>(src < 0 ? 0 : src) * cin + c * KC + j * 8;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t dst = a_s + (h * kUnits + e) * 16;
              if (src >= 0) {
                cp_async_16(dst, from + 4 * h, 16);
              } else {
                st_shared_zero16(dst);
              }
            }
          } else {
            const uint32_t dst = a_s + (r >> 3) * L::kASbo + j * 128 + (r & 7) * 16;
            if (src >= 0) {
              cp_async_16(dst, feats + static_cast<int64_t>(src) * cin + c * KC + j * 8, 16);
            } else {
              st_shared_zero16(dst);
            }
          }
        }
      }
      cp_async_commit();
    };
    // f32: this thread's units of step s, split into the hi and lo A stages
    // of pair s % 3
    auto split = [&](int s) {
      const float* g = reinterpret_cast<const float*>(smem + (s % kStages) * L::kSlot);
      unsigned char* hi = smem + L::kSplitOff + (s % 3) * 2 * L::kAStage;
#pragma unroll
      for (int i = 0; i < kUnits / kWG; ++i) {
        const int e = tid + i * kWG;
        int r, j;
        unit(e, r, j);
        const float4 v0 = *reinterpret_cast<const float4*>(g + 4 * e);
        const float4 v1 = *reinterpret_cast<const float4*>(g + 4 * (kUnits + e));
        uint4 h, l;
        split_bf16x2(v0.x, v0.y, h.x, l.x);
        split_bf16x2(v0.z, v0.w, h.y, l.y);
        split_bf16x2(v1.x, v1.y, h.z, l.z);
        split_bf16x2(v1.z, v1.w, h.w, l.w);
        const int at = (r >> 3) * L::kASbo + j * 128 + (r & 7) * 16;
        *reinterpret_cast<uint4*>(hi + at) = h;
        *reinterpret_cast<uint4*>(hi + L::kAStage + at) = l;
      }
    };
    float acc[COUT / 2];
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc[j] = 0.f;
    // Steps s + 1 and s + 2 are in flight while s is multiplied. After
    // step s's barrier every warp has waited for step s - 2's products, so
    // step s + kStages - 2 may gather into that slot.
    for (int s = 0; s < kStages - 2; ++s) gather(s);
    for (int s = 0; s < steps; ++s) {
      const int slot = s % kStages;
      cp_async_wait<kStages - 3>();  // this thread's rows of step s have landed
      if constexpr (F32) split(s);   // and are split into the A stages
      fence_proxy_async();           // its writes, to wgmma's reads
      named_barrier(1, kWG);         // and every other thread's
      gather(s + kStages - 2);
      mbar_wait(full0 + 8 * slot, (s / kStages) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const uint32_t b_s = smem_addr(smem + slot * L::kSlot + L::kGather);
      const uint32_t a_s = F32 ? smem_addr(smem + L::kSplitOff + (s % 3) * 2 * L::kAStage)
                               : smem_addr(smem + slot * L::kSlot);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const uint64_t a_desc = smem_desc(a_s + kk * 256, 128, L::kASbo);
        wgmma_tile_ss<COUT>(acc, a_desc, b_s + kk * 16 * COUT * 2);
        if constexpr (F32) {
          wgmma_tile_ss<COUT>(acc, a_desc, b_s + L::kBStage + kk * 16 * COUT * 2);  // Xh Wl
          wgmma_tile_ss<COUT>(acc, smem_desc(a_s + L::kAStage + kk * 256, 128, L::kASbo),
                              b_s + kk * 16 * COUT * 2);  // Xl Wh
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products have read its slot
      if (s > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % kStages));
      __syncwarp();
    }
    wgmma_wait<0>();

    // accumulator element 4j + e: row 16 warp + lane / 4 + 8 (e / 2),
    // column 8j + 2 (lane % 4) + e % 2
    const int row_a = 16 * warp + (lane >> 2);
    const int col = (lane & 3) * 2;
    if constexpr (SPLIT == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = row0 + row_a + 8 * h;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j) {
          *reinterpret_cast<float2*>(out + row * COUT + j * 8 + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    } else {
      // the partial tile, over the drained ring: every slot's products
      // have been read (all four warps are past their last wgmma)
      named_barrier(1, kWG);
      fence_proxy_async();
      float* part = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < COUT / 8; ++j) {
          *reinterpret_cast<float2*>(part + (row_a + 8 * h) * L::kPitch + j * 8 + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }

  if constexpr (SPLIT > 1) {
    // every block of the cluster sums its rows' partials, in rank order
    __syncwarp();
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    float* part = reinterpret_cast<float*>(smem);
    for (int e = tid; e < kRows * (COUT / 4); e += kThreads) {
      const int r = rank * kRows + e / (COUT / 4);
      const int c4 = e % (COUT / 4);
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < SPLIT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part, q) + r * L::kPitch + c4 * 4);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
      if (row0 + r < m) reinterpret_cast<float4*>(out + (row0 + r) * COUT)[c4] = sum;
    }
    cluster.sync();  // no block leaves while another reads its partial
  }
}

// the cluster size for a call: a tile's offsets are split between 2 or 4
// thread blocks where each keeps at least 27 steps of 32 channels and the
// grid stays within 2048 thread blocks (on the card, splitting the
// capacity-sized tables of the fine levels lost time, and splitting the
// coarse levels' and one rotation's tables gained)
int default_split(int64_t m, int cin, int kvol) {
  const int64_t tiles = (m + kBM - 1) / kBM;
  const int steps = kvol * (cin / 32);  // 32-channel steps
  for (int split = 4; split > 1; split /= 2) {
    if (steps >= 27 * split && tiles * split <= 2048) return split;
  }
  return 1;
}

// channels per step: 64 at Cout 128 where Cin allows (fewer steps, the
// same two thread blocks an SM); 32 elsewhere, where 64 would cost a thread
// block an SM (Cout 64) or leave too few ring slots (Cout 256)
int default_kc(int cin, int cout) { return cin % 64 == 0 && cout == 128 ? 64 : 32; }

template <int COUT, int KC, int SPLIT, bool F32>
int launch(const void* feats, const void* nbr, const void* wp, void* out, int64_t m, int64_t n,
           int cin, int kvol, cudaStream_t stream) {
  using L = Layout<COUT, KC, F32>;
  using Feat = std::conditional_t<F32, float, __nv_bfloat16>;
  auto kernel = gather_conv_kernel<COUT, KC, SPLIT, F32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((m + kBM - 1) / kBM) * SPLIT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = SPLIT > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const Feat*>(feats),
                           static_cast<const int32_t*>(nbr), static_cast<const __nv_bfloat16*>(wp),
                           static_cast<float*>(out), m, n, cin, kvol);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// calls f(Int<COUT>, Int<KC>, Int<SPLIT>) for a call of the bf16 or (f32)
// the f32 entry, which runs 32 channels a step; false for arguments the
// kernel does not take
template <typename F>
bool dispatch(int64_t m, int cin, int cout, int kvol, bool f32, F&& f) {
  if (m < 0 || cin <= 0 || cin % 32 != 0 || kvol < 1 || kvol > kMaxK) return false;
  const int split = default_split(m, cin, kvol);
  const bool wide = !f32 && default_kc(cin, cout) == 64;
  auto by_split = [&](auto co, auto kc) {
    switch (split) {
      case 1: f(co, kc, Int<1>{}); return true;
      case 2: f(co, kc, Int<2>{}); return true;
      default: f(co, kc, Int<4>{}); return true;
    }
  };
  switch (cout) {
    case 32: return by_split(Int<32>{}, Int<32>{});
    case 64: return by_split(Int<64>{}, Int<32>{});
    case 128: return wide ? by_split(Int<128>{}, Int<64>{}) : by_split(Int<128>{}, Int<32>{});
    case 256: return by_split(Int<256>{}, Int<32>{});
    default: return false;
  }
}

template <bool F32>
int run(const void* feats, const void* nbr, const void* wp, void* out, int64_t m, int64_t n,
        int cin, int cout, int kvol, void* stream) {
  if (n < 0 || n > 0x7fffffff || m / kBM * 4 > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  const bool ok = dispatch(m, cin, cout, kvol, F32, [&](auto co, auto kc, auto sp) {
    if constexpr (!F32 || decltype(kc)::value == 32) {
      if (m > 0) {
        rc = launch<decltype(co)::value, decltype(kc)::value, decltype(sp)::value, F32>(
            feats, nbr, wp, out, m, n, cin, kvol, s);
      }
    }
  });
  return ok ? rc : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The launch shape for a call of the bf16 (f32 = 0) or the f32 entry:
// output rows per tile, input channels per step, slots in the ring, thread
// blocks per tile (the cluster split), and dynamic shared memory bytes.
// Returns cudaErrorInvalidValue for arguments the kernel does not take.
int gather_conv_launch_shape(int64_t m, int cin, int cout, int kvol, int f32, int* rows,
                             int* channels, int* stages, int* split, int* smem_bytes) {
  const bool ok = dispatch(m, cin, cout, kvol, f32 != 0, [&](auto co, auto kc, auto sp) {
    auto fill = [&](auto layout) {
      using L = decltype(layout);
      *rows = kBM;
      *channels = decltype(kc)::value;
      *stages = L::kStages;
      *split = decltype(sp)::value;
      *smem_bytes = L::kBytes;
    };
    if constexpr (decltype(kc)::value == 32) {  // the f32 entry's only width a step
      if (f32) return fill(Layout<decltype(co)::value, 32, true>{});
    }
    fill(Layout<decltype(co)::value, decltype(kc)::value, false>{});
  });
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches on `stream` without synchronising; wp is w packed as the header
// says. Returns the CUDA error of the launch (0 on success) or
// cudaErrorInvalidValue for arguments the kernel does not take. The caller
// owns every buffer; feats, wp and out are 16-byte aligned.
int gather_conv_bf16(const void* feats, const void* nbr, const void* wp, void* out, int64_t m,
                     int64_t n, int cin, int cout, int kvol, void* stream) {
  return run<false>(feats, nbr, wp, out, m, n, cin, cout, kvol, stream);
}

// The f32 entry (the header's last paragraph): feats (N, Cin) f32, wp the
// [Wh ; Wl] steps of the split f32 weights; otherwise as gather_conv_bf16.
int gather_conv_f32(const void* feats, const void* nbr, const void* wp, void* out, int64_t m,
                    int64_t n, int cin, int cout, int kvol, void* stream) {
  return run<true>(feats, nbr, wp, out, m, n, cin, cout, kvol, stream);
}

}  // extern "C"
