// Gradients of the gather-GEMM sparse convolution for NVIDIA Hopper (sm_90a).
//
// The forward (gather_conv.cu) computes, with nbr[m, k] == -1 adding 0,
//
//   y[m, :] = sum_k x[nbr[m, k], :] @ w[k]
//
// for x (N, Cin) bf16, nbr (M, K) int32, w (K, Cin, Cout) bf16, y (M, Cout)
// f32. Given dy (M, Cout) f32, this file computes its two gradients:
//
//   dgrad:  dx[n, :]  = sum_{(m, k): nbr[m, k] = n} dy[m, :] @ w[k]^T   (N, Cin) f32
//   wgrad:  dw[k]     = sum_{m: nbr[m, k] >= 0} x[nbr[m, k], :]^T dy[m, :]   (K, Cin, Cout) f32
//
// dgrad takes Cin 32, 64, 128 or 256 and Cout a multiple of 4 up to 256;
// wgrad Cin a multiple of 8 up to 256 and any Cout up to 256; both any K
// up to 65535 (kernels/gather_conv.py pads other widths). An entry >= N
// traps (__trap(): the launch's next synchronisation raises a CUDA error
// and the context is unusable), as the forward does.
//
// Replaces the gradient of the TPU kernel roreg_tpu/sparse/window_conv.py
// window_gather_conv. The JAX package trains through roreg_tpu/sparse/conv.py
// gather_conv, whose gradient XLA derives: the transpose of jnp.take (a
// scatter-add) for dx and the transposed dot for w. Under bf16 compute
// JAX's cotangents are bf16 and its scatter-add sums in bf16; both kernels
// here sum in f32 and the caller rounds once, to the operand's type.
//
// What bounds them on an H100 (3.35 TB/s HBM; the operations fit the
// tensor cores many times over): each must read the f32 dy rows that have
// a valid entry and the whole table, and dgrad the bf16 weights and the
// f32 dx it writes, wgrad each referenced bf16 row of x and the f32 dw it
// writes. chip_smoke.py computes each shape's bound from the tables of its
// run (kernels/gather_conv.py bwd_work). On the training path most rows
// are capacity padding, all -1; the coarse levels have few live tiles.
//
// Arithmetic: wgmma multiplies bf16 by bf16 into f32, and dy is f32. Each
// dy value is split, where it is staged, into three bf16 terms hi + mid +
// lo that leave 2^-24 of it (hopper.cuh split_bf16x3); the three are
// multiplied by the same bf16 w or x into one f32 accumulator. So both
// kernels keep f32's precision on the tensor cores (one bf16 term would be
// 2^-9, against the checks' tolerances), at three times the products.
//
// dgrad: a work item is a 64-row tile of dy, a tile of at most 128 dx
// channels, and a group of at most 8 offsets; the offsets are cut into as
// many groups as keep about 1024 thread blocks in a launch, so the coarse
// levels' few live tiles spread over the SMs (two to four offsets a block
// at the coarsest). A thread block (one consumer warpgroup, one producer warp)
// reads its tile's entries of its offsets, lists the offsets some row
// uses, and leaves if there are none (the capacity padding's tiles). The
// consumers stage the tile's dy once, as the three bf16 terms in wgmma's
// K-major layout (K = Cout), while the producer streams the used offsets'
// w[k]^T (packed by the wrapper, K = Cout in slots of 32, N = the channel
// tile) with cp.async.bulk through an mbarrier ring. wgmma.mma_async
// m64nNk16 runs A (the dy terms) and B (w[k]^T) from shared-memory
// descriptors into f32 registers; after an offset's last slot, each warp
// adds its 16 rows of the 64 x N product to dx at the rows the table names
// (skipping -1) with 8-byte vector reductions, four lanes covering 32
// contiguous bytes of a row. The atomics make any table right, repeated
// targets included, and make dgrad run-to-run nondeterministic in the last
// bits.
//
// wgrad: first a split pass writes, for each 32-row group with a valid
// entry, the three bf16 terms of its dy rows in wgmma's B layout (K = the
// rows, N = Cout padded to 32, 64, 128 or 256), into scratch the wrapper
// allocates. A work item is then an offset k, a 64-channel Cin tile, and a
// range of row groups sized so a launch has about 2048 thread blocks. A
// thread block lists its range's groups with a valid entry at k (the
// others are skipped). Its producer warp streams each live group's dy
// terms by cp.async.bulk; its consumer warpgroup gathers the group's 32 x
// rows (64 channels, zero for -1) by 16-byte cp.async one to six groups
// ahead (the ring's slots less two), reads them transposed (M = Cin, K = rows) into registers with
// ldmatrix.trans, and runs wgmma m64nCoutk16 against each dy term. So each
// gathered x row is fetched once per Cin tile and each dy row once per
// (k, Cin tile). At the end the 64 x Cout tile is added to dw with 8-byte
// vector reductions (run-to-run nondeterministic like dgrad).
//
// The f32 entries (gather_conv_dgrad_f32, gather_conv_wgrad_f32) take f32
// W (dgrad) or f32 X (wgrad), the operand the bf16 entries read as bf16,
// and make one launch a call (wgrad's split pass aside). Each splits that
// operand into two bf16 terms, hi = bf16(v) and lo = bf16(v - hi), and dY
// into its first two terms hi and mid (the first two of split_bf16x3,
// which are split_bf16x2's), and runs the three products dYh Oh + dYh Ol +
// dYm Oh (O = W or X) into the same f32 accumulators: the rule of
// kernels/split.py, the forward's entries' too. The dropped products dYl
// Oh, dYm Ol and dYl Ol are each under 2^-17 of a product, far under the
// f32 checks' 1e-4 of the output's largest magnitude, so dY's lo term is
// never staged and an f32 step runs as many products as a bf16 one.
// - dgrad_f32: W comes split and packed once by the caller
//   (kernels/gather_conv.py pack_dgrad_split_weights) as a [Wh^T ; Wl^T]
//   pair for each (offset, channel tile, 32-row Cout slot): a ring slot
//   holds both terms of one step, 2 x 32 x tile bf16, and the producer
//   streams it as one bulk copy. The consumers stage dY's two terms once
//   a tile; the atomic epilogue into dx runs once.
// - wgrad_f32: X is read once, as f32. The consumers' cp.async gathers
//   bring each 32-row group's f32 pieces (zero for -1, 8 KB at 64
//   channels) into its ring slot; at the step each thread splits the
//   pieces it gathered itself into a hi and a lo bf16 stage in the
//   transposed reads' layout, before the step's named barrier, and
//   ldmatrix.trans reads both. The (hi, lo) stage pairs alternate between
//   two, since ldmatrix has read a pair into registers before the next
//   step's barrier. The split pass writes dY's two terms, so the scratch
//   and each group's bulk copy are two thirds of the bf16 entry's. The
//   ring of an f32 wgrad keeps at most 72 KB and the split stages 16 KB,
//   two thread blocks an SM, but at Cout 256, whose three slots of 40 KB
//   take one SM alone (as the bf16 entry's do).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWG = 128;            // the consumer warpgroup
constexpr int kThreads = kWG + 32;  // and the producer warp
constexpr int kMaxC = 256;
constexpr int kMaxK = 65535;

// dgrad: 64 dy rows a tile (wgmma's M), at most 128 dx channels a thread
// block (wgmma's N; 256 would take 250 registers a thread and one thread
// block an SM), w^T in slots of 32 Cout rows (two wgmma K steps), at most
// 8 offsets a thread block, about 1024 thread blocks a launch (the
// fastest of the counts measured on the card)
constexpr int kBM = 64;
constexpr int kMaxCiTile = 128;
constexpr int kKC = 32;
constexpr int kMaxOffsets = 8;
constexpr int kLDI = kMaxOffsets + 1;  // index row pitch
constexpr int kDgradBlocks = 1024;

// wgrad: 32 rows a step (two wgmma K steps), 64 input channels a thread
// block (wgmma's M), at most 32 row groups a thread block (listed in one
// warp), about 2048 thread blocks a launch
constexpr int kWgradBlocks = 2048;
constexpr int kWRows = 32;
constexpr int kWKSteps = kWRows / 16;
constexpr int kWCi = 64;
constexpr int kMaxGroups = 32;
constexpr int kSplitThreads = 256;

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// the bf16 terms of a dy value a kernel stages: three, or two at f32 (the
// header's f32 paragraph)
template <bool F32>
constexpr int kDyTerms = F32 ? 2 : 3;

// 8 f32 values -> their first NT bf16 terms, 8 to a 16-byte word each
template <int NT>
__device__ __forceinline__ void split8(const float (&v)[8], uint4 (&out)[NT]) {
  if constexpr (NT == 3) {
    split8_bf16x3(v, out);
  } else {
    split_bf16x2(v[0], v[1], out[0].x, out[1].x);
    split_bf16x2(v[2], v[3], out[0].y, out[1].y);
    split_bf16x2(v[4], v[5], out[0].z, out[1].z);
    split_bf16x2(v[6], v[7], out[0].w, out[1].w);
  }
}

template <int CI, bool F32>
struct DgradLayout {
  static constexpr int kWTerms = F32 ? 2 : 1;         // w's bf16 terms a slot
  static constexpr int kSlot = kWTerms * kKC * CI * 2;  // 32 rows (Cout) of w[k]^T, each term
  static constexpr int kStages = 32768 / kSlot < 4 ? 4 : (32768 / kSlot > 8 ? 8 : 32768 / kSlot);
  // dynamic shared memory: the dy tile's terms (64 x coutp each), the
  // ring, and its full and empty mbarriers
  static constexpr size_t bytes(int coutp) {
    return static_cast<size_t>(kDyTerms<F32> * kBM * 2) * coutp + kStages * kSlot + 16 * kStages;
  }
  static_assert(bytes(kMaxC) <= 232448, "fits a thread block's shared memory");
};

template <int CI, bool F32>
__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const float* __restrict__ dy, const int32_t* __restrict__ nbr,
             const __nv_bfloat16* __restrict__ wt, float* __restrict__ dx, int64_t m, int64_t n,
             int cin, int cout, int kvol, int groups) {
  using L = DgradLayout<CI, F32>;
  constexpr int kStages = L::kStages;
  constexpr int kTerms = kDyTerms<F32>;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int idx_s[kBM * kLDI];
  __shared__ int flag_s[kMaxOffsets];  // offset j of the group is used by some row of the tile
  __shared__ int used_s[kMaxOffsets];  // the used offsets, in order
  __shared__ int nused_s;

  const int tid = threadIdx.x;
  const int coutp = (cout + kKC - 1) / kKC * kKC;
  const int ctiles = cin / CI;
  const int ct = static_cast<int>(blockIdx.x % ctiles);  // the block's CI channels of dx
  const int item = static_cast<int>(blockIdx.x / ctiles);
  const int64_t row0 = static_cast<int64_t>(item / groups) * kBM;
  const int per = static_cast<int>(cdiv(kvol, groups));
  const int k0 = (item % groups) * per;
  const int nk = kvol - k0 < per ? kvol - k0 : per;
  const int rows = m - row0 < kBM ? static_cast<int>(m - row0) : kBM;
  const int term_bytes = kBM * coutp * 2;
  const uint32_t a0 = smem_addr(smem);
  const uint32_t ring0 = a0 + kTerms * term_bytes;
  const uint32_t full0 = ring0 + kStages * L::kSlot;
  const uint32_t empty0 = full0 + 8 * kStages;

  if (tid < kMaxOffsets) flag_s[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the slot's bulk copy
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  // the tile's entries of this group's offsets; a negative entry is absent,
  // an entry >= n an error
  for (int e = tid; e < kBM * nk; e += kThreads) {
    const int r = e / nk;
    const int j = e - r * nk;
    int src = -1;
    if (r < rows) {
      src = nbr[(row0 + r) * kvol + k0 + j];
      if (src >= n) __trap();
      if (src < 0) {
        src = -1;
      } else {
        flag_s[j] = 1;
      }
    }
    idx_s[r * kLDI + j] = src;
  }
  __syncthreads();
  if (tid < 32) {  // the used offsets, listed in order
    const bool used = tid < nk && flag_s[tid] != 0;  // nk <= kMaxOffsets
    const unsigned ballot = __ballot_sync(0xffffffffu, used);
    if (used) used_s[__popc(ballot & ((1u << tid) - 1u))] = tid;
    if (tid == 0) nused_s = __popc(ballot);
  }
  __syncthreads();
  const int nused = nused_s;
  if (nused == 0) return;  // a tile of padding rows for these offsets
  const int cs = coutp / kKC;  // slots an offset
  const int steps = nused * cs;

  if (tid >= kWG) {  // producer warp: one thread streams w[k]^T's slots
    if (tid == kWG) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty0 + 8 * slot, (s / kStages - 1) & 1);
        const int k = k0 + used_s[s / cs];
        mbar_arrive_expect_tx(full0 + 8 * slot, L::kSlot);
        bulk_copy(ring0 + slot * L::kSlot,
                  wt + ((static_cast<int64_t>(k) * ctiles + ct) * cs + s % cs) * L::kWTerms * kKC * CI,
                  L::kSlot, full0 + 8 * slot);
      }
    }
    return;
  }

  // The dy tile's terms, each in wgmma's K-major layout: element
  // (r, c) at byte (r / 8) * 16 coutp + (c / 8) * 128 + (r % 8) * 16 +
  // (c % 8) * 2. A thread takes one row's 8 columns, so a warp's 16-byte
  // stores fill 512 contiguous bytes; rows past m and columns past cout
  // are zero.
  const int c8n = coutp / 8;
  for (int e = tid; e < kBM * c8n; e += kWG) {
    const int r8 = e & 7;
    const int c8 = (e >> 3) % c8n;
    const int rg = (e >> 3) / c8n;
    const int r = rg * 8 + r8;
    float v[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c8 * 8 + 4 * h;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows && c < cout) q = *reinterpret_cast<const float4*>(dy + (row0 + r) * cout + c);
      v[4 * h] = q.x;
      v[4 * h + 1] = q.y;
      v[4 * h + 2] = q.z;
      v[4 * h + 3] = q.w;
    }
    uint4 t[kTerms];
    split8<kTerms>(v, t);
    const int off = rg * coutp * 16 + c8 * 128 + r8 * 16;
#pragma unroll
    for (int i = 0; i < kTerms; ++i) *reinterpret_cast<uint4*>(smem + i * term_bytes + off) = t[i];
  }
  fence_proxy_async();  // the stores, to wgmma's reads
  named_barrier(1, kWG);

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = (lane & 3) * 2;
  const uint32_t sbo = coutp * 16;
  float acc[CI / 2];
#pragma unroll
  for (int i = 0; i < CI / 2; ++i) acc[i] = 0.f;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kStages;
    const int c = s % cs;
    mbar_wait(full0 + 8 * slot, (s / kStages) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint32_t b = ring0 + slot * L::kSlot + kk * 16 * CI * 2;
      auto dy_term = [&](int i) { return smem_desc(a0 + i * term_bytes + (2 * c + kk) * 256, 128, sbo); };
      if constexpr (F32) {  // dYh Wh + dYh Wl + dYm Wh; Wl^T is the slot's second half
        wgmma_tile_ss<CI>(acc, dy_term(0), b);
        wgmma_tile_ss<CI>(acc, dy_term(0), b + kKC * CI * 2);
        wgmma_tile_ss<CI>(acc, dy_term(1), b);
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) wgmma_tile_ss<CI>(acc, dy_term(i), b);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have read its slot
    if (c != 0 && lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % kStages));
    if (c == cs - 1) {  // the offset's last slot: its product is complete
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * slot);
      const int j = used_s[s / cs];
      // accumulator element 4q + e: row 16 warp + lane / 4 + 8 (e / 2),
      // column 8q + 2 (lane % 4) + e % 2
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = idx_s[(16 * warp + (lane >> 2) + 8 * h) * kLDI + j];
        if (src >= 0) {
          float* dst = dx + static_cast<int64_t>(src) * cin + ct * CI + col;
#pragma unroll
          for (int q = 0; q < CI / 8; ++q) red_add_v2(dst + 8 * q, acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
        }
      }
#pragma unroll
      for (int i = 0; i < CI / 2; ++i) acc[i] = 0.f;
    }
    __syncwarp();
  }
}

int dgrad_ci_tile(int cin) { return cin < kMaxCiTile ? cin : kMaxCiTile; }

// offset groups a dgrad tile is cut into: about kDgradBlocks thread blocks
// a launch, at most kMaxOffsets offsets a block
int dgrad_groups(int64_t m, int cin, int kvol) {
  const int64_t items = cdiv(m, kBM) * (cin / dgrad_ci_tile(cin));
  int64_t g = cdiv(kDgradBlocks, items > 0 ? items : 1);
  if (g < cdiv(kvol, kMaxOffsets)) g = cdiv(kvol, kMaxOffsets);
  if (g > kvol) g = kvol;
  return static_cast<int>(cdiv(kvol, cdiv(kvol, g)));
}

// the split pass's B stages: for each kWRows-row group, term t and K step
// kk (rows 16 kk .. 16 kk + 15) hold a stage of 16 x co in hopper.cuh
// b_desc's layout, at (t * kWKSteps + kk) * 16 * co elements of the
// group's kDyTerms * kWRows * co
template <int CO, bool F32>
struct WgradLayout {
  static constexpr int kAStage = kWRows * kWCi * 2;  // a bf16 stage: a group's rows x 64 channels
  static constexpr int kGather = F32 ? 2 * kAStage : kAStage;  // the rows as gathered, bf16 or f32
  static constexpr int kBStage = kDyTerms<F32> * kWRows * CO * 2;  // their dy rows' terms
  static constexpr int kSlot = kGather + kBStage;
  // 3 thread blocks an SM below Cout 128 (bf16); 2 below Cout 256 with
  // the f32 entry's split stages, two (hi, lo) pairs
  static constexpr int kFit = (F32 ? 73728 : 65536) / kSlot;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > 8 ? 8 : kFit);
  static constexpr int kSplitOff = kStages * kSlot;
  static constexpr int kBarOff = kSplitOff + (F32 ? 4 * kAStage : 0);
  static constexpr int kBytes = kBarOff + 16 * kStages;
  static_assert(kBytes <= 232448, "fits a thread block's shared memory");
};

template <int CO, int NT>
__global__ void __launch_bounds__(kSplitThreads)
wgrad_split_kernel(const float* __restrict__ dy, const int32_t* __restrict__ nbr,
                   __nv_bfloat16* __restrict__ dys, int64_t m, int cout, int kvol) {
  const int64_t g = blockIdx.x;
  const int64_t r0 = g * kWRows;
  const int rows = m - r0 < kWRows ? static_cast<int>(m - r0) : kWRows;
  // a group none of whose entries is valid is never read: its table rows
  // are contiguous, and read once
  const int32_t* tbl = nbr + r0 * kvol;
  bool live = false;
  for (int e = threadIdx.x; e < rows * kvol; e += kSplitThreads) live |= tbl[e] >= 0;
  if (!__syncthreads_or(live)) return;
  uint4* out = reinterpret_cast<uint4*>(dys + g * (NT * kWRows * CO));
  // a thread takes 8 rows of one column (a warp reads 32 consecutive
  // columns of a row at a time) and writes each of the NT terms' 8 values
  // as one 16-byte word
  for (int e = threadIdx.x; e < (kWRows / 8) * CO; e += kSplitThreads) {
    const int col = e % CO;
    const int q = e / CO;  // rows 8q .. 8q + 7
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * q + i;
      v[i] = r < rows && col < cout ? dy[(r0 + r) * cout + col] : 0.f;
    }
    uint4 t[NT];
    split8<NT>(v, t);
    const int off = (col >> 3) * 128 + (q & 1) * 64 + (col & 7) * 8;
#pragma unroll
    for (int i = 0; i < NT; ++i) out[((i * kWKSteps + (q >> 1)) * 16 * CO + off) / 8] = t[i];
  }
}

template <int CO, bool F32>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ x,
             const int32_t* __restrict__ nbr, const __nv_bfloat16* __restrict__ dys,
             float* __restrict__ dw, int64_t m, int64_t n, int cin, int cout, int kvol,
             int groups_per_block) {
  using L = WgradLayout<CO, F32>;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int idx_s[kMaxGroups * kWRows];
  __shared__ int live_s[kMaxGroups];  // the range's groups with a valid entry at k, in order
  __shared__ int nlive_s;

  const int tid = threadIdx.x;
  const int k = blockIdx.y;
  const int ci0 = blockIdx.z * kWCi;
  const int64_t g0 = static_cast<int64_t>(blockIdx.x) * groups_per_block;
  const int64_t r0 = g0 * kWRows;
  const int64_t left = m - r0;
  const int nrows = left < groups_per_block * kWRows ? static_cast<int>(left) : groups_per_block * kWRows;
  const uint32_t full0 = smem_addr(smem + L::kBarOff);
  const uint32_t empty0 = full0 + 8 * kStages;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the dy terms' bulk copy
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  for (int e = tid; e < groups_per_block * kWRows; e += kThreads) {
    int src = -1;
    if (e < nrows) {
      src = nbr[(r0 + e) * kvol + k];
      if (src >= n) __trap();
      if (src < 0) src = -1;
    }
    idx_s[e] = src;
  }
  __syncthreads();
  if (tid < 32) {  // the live groups, listed in order
    bool live = false;
    if (tid < groups_per_block) {
      for (int r = 0; r < kWRows; ++r) live |= idx_s[tid * kWRows + r] >= 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (live) live_s[__popc(ballot & ((1u << tid) - 1u))] = tid;
    if (tid == 0) nlive_s = __popc(ballot);
  }
  __syncthreads();
  const int steps = nlive_s;
  if (steps == 0) return;

  if (tid >= kWG) {  // producer warp: one thread streams the dy terms
    if (tid == kWG) {
      for (int s = 0; s < steps; ++s) {
        const int slot = s % kStages;
        if (s >= kStages) mbar_wait(empty0 + 8 * slot, (s / kStages - 1) & 1);
        mbar_arrive_expect_tx(full0 + 8 * slot, L::kBStage);
        bulk_copy(smem_addr(smem + slot * L::kSlot + L::kGather),
                  dys + (g0 + live_s[s]) * (L::kBStage / 2), L::kBStage, full0 + 8 * slot);
      }
    }
    return;
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  // step s's gather into its slot, one cp.async group (empty past the
  // end); an absent row, and channels past cin, are zeroed by
  // shared-memory stores. bf16: row r's 16-byte piece j (channels ci0 + 8j
  // .. + 7) goes to core matrix (r / 8, j), byte (r / 8) * 1024 + j * 128 +
  // (r % 8) * 16. f32: this thread's unit e (row r, channels ci0 + 8j ..
  // + 7) comes as two 16-byte halves to bytes (h * kUnits + e) * 16, h =
  // 0, 1, for this thread alone to split; eight consecutive threads take
  // one piece of eight consecutive rows, so the split stages' stores of a
  // quarter warp fill 128 contiguous bytes
  constexpr int kUnits = kWRows * (kWCi / 8);  // (row, 8-channel piece) units of a step
  auto unit = [](int e, int& r, int& j) {
    if constexpr (F32) {
      r = (e >> 6) * 8 + (e & 7);
      j = (e >> 3) & 7;
    } else {
      r = e >> 3;
      j = e & 7;
    }
  };
  auto gather = [&](int s) {
    if (s < steps) {
      const int g = live_s[s];
      const uint32_t a_s = smem_addr(smem + (s % kStages) * L::kSlot);
#pragma unroll
      for (int i = 0; i < kUnits / kWG; ++i) {
        const int e = tid + i * kWG;
        int r, j;
        unit(e, r, j);
        const int src = idx_s[g * kWRows + r];
        const int ci = ci0 + 8 * j;
        const bool in = src >= 0 && ci < cin;
        if constexpr (F32) {
          const float* from = x + static_cast<int64_t>(in ? src : 0) * cin + (in ? ci : 0);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t dst = a_s + (h * kUnits + e) * 16;
            if (in) {
              cp_async_16(dst, from + 4 * h, 16);
            } else {
              st_shared_zero16(dst);
            }
          }
        } else {
          const uint32_t dst = a_s + (r >> 3) * 1024 + j * 128 + (r & 7) * 16;
          if (in) {
            cp_async_16(dst, x + static_cast<int64_t>(src) * cin + ci, 16);
          } else {
            st_shared_zero16(dst);
          }
        }
      }
    }
    cp_async_commit();
  };
  // f32: this thread's units of step s, split into the hi and lo bf16
  // stages of pair s % 2 in the bf16 gather's layout
  auto split = [&](int s) {
    const float* got = reinterpret_cast<const float*>(smem + (s % kStages) * L::kSlot);
    unsigned char* hi = smem + L::kSplitOff + (s & 1) * 2 * L::kAStage;
#pragma unroll
    for (int i = 0; i < kUnits / kWG; ++i) {
      const int e = tid + i * kWG;
      int r, j;
      unit(e, r, j);
      const float4 v0 = *reinterpret_cast<const float4*>(got + 4 * e);
      const float4 v1 = *reinterpret_cast<const float4*>(got + 4 * (kUnits + e));
      uint4 h, l;
      split_bf16x2(v0.x, v0.y, h.x, l.x);
      split_bf16x2(v0.z, v0.w, h.y, l.y);
      split_bf16x2(v1.x, v1.y, h.z, l.z);
      split_bf16x2(v1.z, v1.w, h.w, l.w);
      const int at = (r >> 3) * 1024 + j * 128 + (r & 7) * 16;
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(hi + L::kAStage + at) = l;
    }
  };
  float acc[CO / 2];
#pragma unroll
  for (int i = 0; i < CO / 2; ++i) acc[i] = 0.f;
  // lane l of ldmatrix_x4_trans names row 16 kk + (l % 8) + 8 (l / 16) of
  // piece 2 warp + (l / 8) % 2: the four 8x8 matrices are the warp's 16
  // channels by the K step's 16 rows, transposed into wgmma's A fragment
  const int lrow = (lane & 7) + ((lane >> 4) << 3);
  const uint32_t lcol = (2 * warp + ((lane >> 3) & 1)) * 128;
  // Steps s + 1 .. s + kStages - 2 are in flight while s is multiplied;
  // after step s's barrier every warp is past step s - 1's ldmatrix, so
  // step s + kStages - 2 may gather into step s - 2's slot, and (f32) step
  // s + 1 may split into step s - 1's stage pair. A fragments (one set, or
  // hi and lo) alternate between two register sets so one step's products
  // stay in flight.
  constexpr int kATerms = F32 ? 2 : 1;
  auto step = [&](int s, uint32_t (&a)[kATerms][kWKSteps][4]) {
    const int slot = s % kStages;
    cp_async_wait<kStages - 3>();  // this thread's rows of step s have landed
    if constexpr (F32) split(s);   // and are split into the stage pair
    named_barrier(1, kWG);         // and every other thread's
    gather(s + kStages - 2);
    const uint32_t a_s = F32 ? smem_addr(smem + L::kSplitOff + (s & 1) * 2 * L::kAStage)
                             : smem_addr(smem + slot * L::kSlot);
#pragma unroll
    for (int t = 0; t < kATerms; ++t) {
#pragma unroll
      for (int kk = 0; kk < kWKSteps; ++kk) {
        const int r = 16 * kk + lrow;
        ldmatrix_x4_trans(a_s + t * L::kAStage + (r >> 3) * 1024 + lcol + (r & 7) * 16, a[t][kk]);
      }
    }
    mbar_wait(full0 + 8 * slot, (s / kStages) & 1);
    __syncwarp();  // converged for the .aligned wgmma instructions
    wgmma_fence();
    const uint32_t b_s = smem_addr(smem + slot * L::kSlot + L::kGather);
    if constexpr (F32) {  // Xh dYh + Xh dYm + Xl dYh
#pragma unroll
      for (int kk = 0; kk < kWKSteps; ++kk) {
        wgmma_tile<CO>(acc, a[0][kk], b_s + kk * 16 * CO * 2);
        wgmma_tile<CO>(acc, a[0][kk], b_s + (kWKSteps + kk) * 16 * CO * 2);
        wgmma_tile<CO>(acc, a[1][kk], b_s + kk * 16 * CO * 2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int kk = 0; kk < kWKSteps; ++kk) {
          wgmma_tile<CO>(acc, a[0][kk], b_s + (i * kWKSteps + kk) * 16 * CO * 2);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products have read its slot and A
    if (s > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % kStages));
    __syncwarp();
  };
  uint32_t a_even[kATerms][kWKSteps][4], a_odd[kATerms][kWKSteps][4];
  for (int s = 0; s < kStages - 2; ++s) gather(s);
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    step(s, a_even);
    step(s + 1, a_odd);
  }
  if (s < steps) step(s, a_even);
  wgmma_wait<0>();

  // accumulator element 4q + e: row (channel) 16 warp + lane / 4 + 8 (e /
  // 2), column 8q + 2 (lane % 4) + e % 2
  const int col = (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = ci0 + 16 * warp + (lane >> 2) + 8 * h;
    if (ci >= cin) continue;
    float* row = dw + (static_cast<int64_t>(k) * cin + ci) * cout;
#pragma unroll
    for (int q = 0; q < CO / 8; ++q) {
      const int co = 8 * q + col;
      const float a = acc[4 * q + 2 * h];
      const float b = acc[4 * q + 2 * h + 1];
      if (co + 1 < cout && (cout & 1) == 0) {
        red_add_v2(row + co, a, b);
      } else {
        if (co < cout) atomicAdd(row + co, a);
        if (co + 1 < cout) atomicAdd(row + co + 1, b);
      }
    }
  }
}

// the launch shape of a wgrad call: row groups a thread block, and thread
// blocks along the rows, for about kWgradBlocks thread blocks a launch
void wgrad_grid(int64_t m, int cin, int kvol, int* groups_per_block, int64_t* ranges) {
  const int64_t groups = cdiv(m, kWRows);
  const int64_t other = static_cast<int64_t>(kvol) * cdiv(cin, kWCi);
  int64_t r = cdiv(kWgradBlocks, other);
  if (r > groups) r = groups;
  if (r < 1) r = 1;
  int64_t gpb = cdiv(groups, r);
  if (gpb > kMaxGroups) gpb = kMaxGroups;
  if (gpb < 1) gpb = 1;
  *groups_per_block = static_cast<int>(gpb);
  *ranges = cdiv(groups, gpb);
}

int co_tile(int cout) { return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 128 ? 128 : 256; }

// calls f(Int<C>) for a width of 32, 64, 128 or 256; false for another
template <typename F>
bool by_width(int c, F&& f) {
  switch (c) {
    case 32: f(Int<32>{}); return true;
    case 64: f(Int<64>{}); return true;
    case 128: f(Int<128>{}); return true;
    case 256: f(Int<256>{}); return true;
    default: return false;
  }
}

bool dgrad_ok(int64_t m, int64_t n, int cin, int cout, int kvol) {
  return m >= 0 && n >= 0 && n <= 0x7fffffff && (cin == 32 || cin == 64 || cin == 128 || cin == 256) &&
         cout >= 4 && cout <= kMaxC && cout % 4 == 0 && kvol >= 1 && kvol <= kMaxK &&
         cdiv(m, kBM) * dgrad_groups(m, cin, kvol) * (cin / dgrad_ci_tile(cin)) <= 0x7fffffff;
}

bool wgrad_ok(int64_t m, int64_t n, int cin, int cout, int kvol) {
  return m >= 0 && n >= 0 && n <= 0x7fffffff && cin >= 8 && cin <= kMaxC && cin % 8 == 0 &&
         cout >= 1 && cout <= kMaxC && kvol >= 1 && kvol <= kMaxK && cdiv(m, kWRows) <= 0x7fffffff;
}

template <bool F32>
int run_dgrad(const void* dy, const void* nbr, const void* wt, void* dx, int64_t m, int64_t n, int cin,
              int cout, int kvol, void* stream) {
  if (!dgrad_ok(m, n, cin, cout, kvol)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * n * cin, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return 0;
  const int groups = dgrad_groups(m, cin, kvol);
  const int64_t blocks = cdiv(m, kBM) * groups * (cin / dgrad_ci_tile(cin));
  const int coutp = (cout + kKC - 1) / kKC * kKC;
  int rc = 0;
  by_width(dgrad_ci_tile(cin), [&](auto ci) {
    constexpr int CI = decltype(ci)::value;
    const size_t smem = DgradLayout<CI, F32>::bytes(coutp);
    cudaError_t e = cudaFuncSetAttribute(dgrad_kernel<CI, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e == cudaSuccess) {
      dgrad_kernel<CI, F32><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
          static_cast<const float*>(dy), static_cast<const int32_t*>(nbr),
          static_cast<const __nv_bfloat16*>(wt), static_cast<float*>(dx), m, n, cin, cout, kvol, groups);
      e = cudaGetLastError();
    }
    rc = static_cast<int>(e);
  });
  return rc;
}

template <bool F32>
int run_wgrad(const void* x, const void* nbr, const void* dy, void* dw, void* scratch, int64_t m,
              int64_t n, int cin, int cout, int kvol, void* stream) {
  if (!wgrad_ok(m, n, cin, cout, kvol)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dw, 0, sizeof(float) * kvol * cin * cout, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  int gpb = 1;
  int64_t ranges = 1;
  wgrad_grid(m, cin, kvol, &gpb, &ranges);
  int rc = 0;
  by_width(co_tile(cout), [&](auto co) {
    constexpr int CO = decltype(co)::value;
    using L = WgradLayout<CO, F32>;
    using X = std::conditional_t<F32, float, __nv_bfloat16>;
    constexpr int NT = kDyTerms<F32>;
    auto dys = static_cast<__nv_bfloat16*>(scratch);
    wgrad_split_kernel<CO, NT><<<static_cast<unsigned>(cdiv(m, kWRows)), kSplitThreads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const int32_t*>(nbr), dys, m, cout, kvol);
    cudaError_t e = cudaGetLastError();
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(wgrad_kernel<CO, F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    }
    if (e == cudaSuccess) {
      const dim3 grid(static_cast<unsigned>(ranges), static_cast<unsigned>(kvol),
                      static_cast<unsigned>(cdiv(cin, kWCi)));
      wgrad_kernel<CO, F32><<<grid, kThreads, L::kBytes, s>>>(
          static_cast<const X*>(x), static_cast<const int32_t*>(nbr), dys, static_cast<float*>(dw), m, n,
          cin, cout, kvol, gpb);
      e = cudaGetLastError();
    }
    rc = static_cast<int>(e);
  });
  return rc;
}

}  // namespace

extern "C" {

// The launch shape of a call (which: 0 dgrad, 1 wgrad; f32: the f32
// entry): thread blocks, offsets (dgrad) or rows (wgrad) a thread block,
// slots of the ring, the bytes of scratch gather_conv_wgrad needs (0 for
// dgrad), and dynamic shared memory bytes. Returns cudaErrorInvalidValue
// for arguments the kernel does not take.
int gather_conv_bwd_launch_shape(int which, int64_t m, int cin, int cout, int kvol, int f32,
                                 int64_t* blocks, int* per_block, int* stages, int64_t* scratch_bytes,
                                 int* smem_bytes) {
  auto by_f32 = [&](auto&& g) {
    if (f32) {
      g(std::true_type{});
    } else {
      g(std::false_type{});
    }
  };
  if (which == 0) {
    if (!dgrad_ok(m, 0, cin, cout, kvol)) return static_cast<int>(cudaErrorInvalidValue);
    const int groups = dgrad_groups(m, cin, kvol);
    *blocks = cdiv(m, kBM) * groups * (cin / dgrad_ci_tile(cin));
    *per_block = static_cast<int>(cdiv(kvol, groups));
    *scratch_bytes = 0;
    by_width(dgrad_ci_tile(cin), [&](auto ci) {
      by_f32([&](auto f) {
        using L = DgradLayout<decltype(ci)::value, decltype(f)::value>;
        *stages = L::kStages;
        *smem_bytes = static_cast<int>(L::bytes((cout + kKC - 1) / kKC * kKC));
      });
    });
    return 0;
  }
  if (!wgrad_ok(m, 0, cin, cout, kvol)) return static_cast<int>(cudaErrorInvalidValue);
  int gpb = 1;
  int64_t ranges = 1;
  wgrad_grid(m, cin, kvol, &gpb, &ranges);
  *blocks = ranges * kvol * cdiv(cin, kWCi);
  *per_block = gpb * kWRows;
  by_width(co_tile(cout), [&](auto co) {
    by_f32([&](auto f) {
      using L = WgradLayout<decltype(co)::value, decltype(f)::value>;
      *stages = L::kStages;
      *scratch_bytes = cdiv(m, kWRows) * L::kBStage;
      *smem_bytes = L::kBytes;
    });
  });
  return 0;
}

// Every entry launches on `stream` without synchronising, zeroes its
// output first (an asynchronous memset), and returns the CUDA error of the
// last launch (0 on success) or cudaErrorInvalidValue for arguments it
// does not take. The caller owns every buffer: dy, wt and dx 16-byte
// aligned for dgrad, wt being w^T zero-padded to (K, coutp, cin), coutp
// the next multiple of 32, cut into tiles of min(cin, 128) columns (ci)
// and packed in 16-row stages as (K, cin / tile, coutp / 16, tile / 8, 2,
// 8, 8) (kernels/gather_conv.py pack_dgrad_weights); x and dw 16-byte
// aligned for wgrad, with scratch of the bytes the launch shape names.

int gather_conv_dgrad(const void* dy, const void* nbr, const void* wt, void* dx, int64_t m,
                      int64_t n, int cin, int cout, int kvol, void* stream) {
  return run_dgrad<false>(dy, nbr, wt, dx, m, n, cin, cout, kvol, stream);
}

// The f32 entry (the header's f32 paragraph): wt is the f32 w's two bf16
// terms, each packed as gather_conv_dgrad's, with the Wl^T slot of each
// (offset, tile, 32 Cout rows) after its Wh^T slot, (K, cin / tile, coutp
// / 32, 2, 2, tile / 8, 2, 8, 8) (kernels/gather_conv.py
// pack_dgrad_split_weights); otherwise as gather_conv_dgrad.
int gather_conv_dgrad_f32(const void* dy, const void* nbr, const void* wt, void* dx, int64_t m,
                          int64_t n, int cin, int cout, int kvol, void* stream) {
  return run_dgrad<true>(dy, nbr, wt, dx, m, n, cin, cout, kvol, stream);
}

int gather_conv_wgrad(const void* x, const void* nbr, const void* dy, void* dw, void* scratch,
                      int64_t m, int64_t n, int cin, int cout, int kvol, void* stream) {
  return run_wgrad<false>(x, nbr, dy, dw, scratch, m, n, cin, cout, kvol, stream);
}

// The f32 entry: x (N, cin) f32, read once and split on chip; otherwise as
// gather_conv_wgrad (with the f32 launch shape's scratch).
int gather_conv_wgrad_f32(const void* x, const void* nbr, const void* dy, void* dw, void* scratch,
                          int64_t m, int64_t n, int cin, int cout, int kvol, void* stream) {
  return run_wgrad<true>(x, nbr, dy, dw, scratch, m, n, cin, cout, kvol, stream);
}

}  // extern "C"
