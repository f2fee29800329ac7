// Block-dense halo convolution for NVIDIA Hopper (sm_90a).
//
//   out[b, u, :] = cell_mask[b, u] * sum_o halo_b[STRIDE * u + o, :] @ w[o]
//
// over the 27 taps o = (ox, oy, oz) in [0, 3)^3 (dx slowest, the kernel
// layout of roreg_tpu.sparse.kernel_map.hypercube_offsets), where halo_b is
// the SPAN^3-cell neighbourhood of output block b: halo position
// h = (hx, hy, hz) is unit a = h - 1 relative to the block's first source
// unit, i.e. cell (a mod 4) of the neighbour block tbl[b, koff(a div 4)],
// zero where that entry is -1. SPAN = 6, STRIDE = 1 is the same-level conv
// (conv_same); SPAN = 9, STRIDE = 2 the stride-2 conv to the next level
// (conv_down), whose table lists the source blocks at 2B + delta.
//
// feats (Nsrc * 64, Cin) bf16 (block-major rows, cell c = cx*16 + cy*4 + cz),
// tbl (B, 27) int32, cell_mask (B, 64) uint8, out (B, 64, Cout) f32. The
// weights w (27, Cin, Cout) bf16 come packed by the caller
// (kernels/halo_conv.py pack_weights) as Cin/16 x 27 stages, one per
// (16-channel chunk c, tap), in the order the kernel consumes them; stage
// (c, tap) holds w[tap, 16c:16c+16, :] as wgmma's canonical K-major layout
// without swizzle: element (k, n) at byte (n/8)*256 + (k/8)*128 + (n%8)*16
// + (k%8)*2, so 8x8 core matrices of 128 contiguous bytes, the two K halves
// 128 bytes apart, consecutive 8-column groups 256 bytes apart. Cin is a
// multiple of 16, Cout 32, 64, 128 or 256. A table entry of an occupied
// output block that is >= Nsrc traps (__trap(): the launch's next
// synchronisation raises a CUDA error and the context is unusable), as an
// out-of-range index raises in the plain version.
//
// Replaces the TPU kernel scripts/experiment_pallas_primitives.py
// tap_loop(pad) (Pallas body `kernel`, line 93): per block, 27 taps x 4
// aligned (4*pad)-row slice GEMMs from a z-padded halo scratch against
// w[tap], accumulated in an f32 scratch: the contraction of the
// aligned-slice conv_same of docs/fused_halo_conv_design.md (formulation 4).
// As a timing stand-in it leaves dz out of the slice offset; this kernel
// computes the real convolution, conv_same and conv_down of
// roreg_tpu/sparse/block.py, including the halo gather that the TPU
// version took as given.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): the
// products are 2 * Cin * Cout operations per (occupied output cell, tap
// into an existing source block), and it must read the source cells those
// taps reach, the table, the mask and w, and write the whole f32 output
// (chip_smoke.py computes each shape's bound from the tables of its run:
// kernels/halo_conv.py halo_work). On the smoke's tables the bound is bytes,
// mostly the f32 output. The kernel multiplies all 64 cells of an occupied
// block by all 27 taps, masked rows included, so its tensor-core work is a
// dense tile per live block, and every live block needs every weight.
//
// Design: a thread block holds two consumer warpgroups and one producer
// warp, and owns 2 or 4 consecutive output blocks: each warpgroup takes one
// block, or two at SPAN 6 with Cout <= 64, where their accumulators and
// halos fit. A block's 64 cells are the M = 64 rows of wgmma.mma_async
// m64nNk16 (bf16 in, f32 accumulators in registers), N covering all of
// Cout (m64n64k16 pieces, or one m64n32k16 at Cout 32), so the halo is
// gathered once per block. Warp w of the warpgroup holds rows 16w..16w+15,
// the x-slab ux = w, and reads its A fragment of a tap (16 scattered halo
// rows) with ldmatrix by per-lane row addresses from the halo in shared
// memory: A comes from registers, since a shared-memory descriptor cannot
// express scattered rows. B, one stage of the weights, comes from shared
// memory through a descriptor. The producer warp streams the 27 * Cin/16
// weight stages through a ring of up to 16 slots (48 KB, 32 KB beside two
// blocks a warpgroup) with cp.async.bulk and mbarriers (full: bytes landed;
// empty: every consumer warp's wgmma has read the slot), so the 2 or 4
// blocks of a thread block share every weight byte read from L2. A
// warpgroup issues each tap's products as one commit group and keeps two
// taps in flight. It double-buffers its halo by 16-channel chunk: the next
// chunk's SPAN^3 rows come in by 16-byte cp.async (src-size 0 zero-fills
// absent neighbours) while this chunk's taps run. The blocks' mask bytes and
// table rows are loaded together at the start, before their liveness is
// known. A thread block whose blocks have no occupied cell (capacity
// padding; the host builder packs each level's live blocks at the front of
// each rotation's capacity, so they come in runs) writes its zeros and
// leaves without starting the producer; a block without occupied cells
// beside a live one takes no neighbour, so its halo is zero-filled and its
// output masked. Dynamic shared memory is at most 195 KB (SPAN 9, Cout 256).
//
// The f32 entry (halo_conv_f32) takes f32 feats and f32 weights, the latter
// packed by the caller (kernels/halo_conv.py pack_split_weights) as the two
// bf16 terms Wh = bf16(w), Wl = bf16(w - Wh) of each stage, side by side in
// one ring slot, [Wh ; Wl], with the 16 input rows of both in the order
// F32_K_ORDER. Each f32 source row of a chunk is read from device memory
// once, into the halo in shared memory (64-byte rows, no padding: at
// STRIDE 2 the halo position h sits at row h ^ ((h >> 1) & 1), so the two
// rows an 8-lane phase of a 16-byte load reads lie in different halves of
// the banks). Each lane loads its four channels of its two A rows of a tap
// as two 16-byte words, K index k of the stage being channel F32_K_ORDER[k]
// so that those four are adjacent, and splits them in registers into a hi
// and a lo A fragment (Xh = bf16(x), Xl = bf16(x - Xh)); a tap runs the
// three products Xh Wh + Xh Wl + Xl Wh into the same f32 accumulators, the
// arithmetic of kernels/split.py (about 3 * 2^-18 of a product lost; Xl Wl
// is dropped). The halo is double-buffered where that leaves room for four
// weight slots, else (SPAN 9, Cout 256) single-buffered, the next chunk's
// rows then loading after this chunk's taps. Dynamic shared memory is at
// most 226 KB (SPAN 9, Cout 128). The f32 entry does three times the bf16
// entry's products on twice its halo bytes and no other pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kCells = 64;
constexpr int kTaps = 27;
constexpr int kKC = 16;        // input channels per chunk: one wgmma K step
constexpr int kLDH = kKC + 8;  // bf16 halo row pitch in bf16: 48 bytes
constexpr int kWG = 128;       // threads of a warpgroup

constexpr int kBPC = 2;  // output blocks (consumer warpgroups) per thread block: a pair
// dynamic shared memory a thread block may take, beside its static arrays
constexpr int kSmemBudget = 232448 - 1024;

template <int SPAN, int COUT, bool F32>
struct Layout {
  // output blocks per consumer warpgroup: two where their accumulators and
  // halos fit
  static constexpr int kBPW = SPAN == 6 && COUT <= 64 ? 2 : 1;
  static constexpr int kBlocks = kBPC * kBPW;  // output blocks per thread block
  static constexpr int kSpan3 = SPAN * SPAN * SPAN;
  static constexpr int kThreads = kWG * kBPC + 32;
  static constexpr int kStageBytes = COUT * kKC * 2;  // one bf16 weight stage
  // a ring slot: one stage, or at f32 the two terms' stages [Wh ; Wl]
  static constexpr int kSlotBytes = F32 ? 2 * kStageBytes : kStageBytes;
  static constexpr int kRowBytes = F32 ? kKC * 4 : kLDH * 2;  // a halo row of one chunk
  static constexpr int kHaloBytes = kSpan3 * kRowBytes;        // one chunk of one block
  static constexpr int kRowTableBytes = kBlocks * kSpan3 * 4;
  // halo buffers: two (the next chunk loads while this one's taps run),
  // or at f32 one where two would leave less than four weight slots
  static constexpr int kBufs =
      !F32 || kBlocks * 2 * kHaloBytes + kRowTableBytes + 4 * kSlotBytes + 256 <= kSmemBudget ? 2 : 1;
  // weight ring: bf16 48 KB, or 32 KB beside the halos of two blocks a
  // warpgroup; f32 what the halos leave, at most 16 slots
  static constexpr int kFree = kSmemBudget - kBlocks * kBufs * kHaloBytes - kRowTableBytes - 256;
  static constexpr int kRingBytes = F32 ? kFree : (kBPW == 2 ? 32768 : 49152);
  static constexpr int kStages = kRingBytes / kSlotBytes < 16 ? kRingBytes / kSlotBytes : 16;
  // shared memory: weight ring | halo [kBlocks][kBufs] | halo rows [kBlocks] | barriers
  static constexpr int kHaloOff = kStages * kSlotBytes;
  static constexpr int kRowOff = kHaloOff + kBlocks * kBufs * kHaloBytes;
  static constexpr int kBarOff = (kRowOff + kRowTableBytes + 7) / 8 * 8;
  static constexpr int kBytes = kBarOff + 2 * kStages * 8;
  static_assert(kStages >= 4 || !F32, "four weight slots at f32");
  static_assert(kBytes <= kSmemBudget, "shared memory of one thread block");
};

// the shared-memory row of halo position h: at f32 and STRIDE 2 rows h and
// h + 2, which one 8-lane phase of a 16-byte load reads, fall in different
// 64-byte halves of the 128 bytes of banks
template <int STRIDE, bool F32>
__device__ __forceinline__ int halo_row(int h) {
  if constexpr (F32 && STRIDE == 2) {
    return h ^ ((h >> 1) & 1);
  } else {
    return h;
  }
}

template <int SPAN, int STRIDE, int COUT, bool F32>
__global__ void __launch_bounds__(Layout<SPAN, COUT, F32>::kThreads, 1)
halo_conv_kernel(const std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ feats,
                 const int32_t* __restrict__ tbl,
                 const __nv_bfloat16* __restrict__ wp,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int64_t nb, int64_t nsrc, int cin) {
  using L = Layout<SPAN, COUT, F32>;
  using Feat = std::conditional_t<F32, float, __nv_bfloat16>;
  constexpr int kSpan3 = L::kSpan3;
  constexpr int kBPW = L::kBPW;
  constexpr int kPieces = F32 ? 4 : 2;  // 16-byte pieces of a halo row of one chunk
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ int live_s[L::kBlocks];
  __shared__ int nbr_s[L::kBlocks][kTaps];

  const int tid = threadIdx.x;
  const int g = tid / kWG;  // consumer warpgroup, or kBPC for the producer warp
  const int t = tid % kWG;
  // warpgroup g owns blocks b0 .. b0 + kBPW - 1
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * L::kBlocks + g * kBPW;
  const int steps = kTaps * (cin / kKC);
  const uint32_t full0 = smem_addr(smem + L::kBarOff);
  const uint32_t empty0 = full0 + 8 * L::kStages;

  // the blocks' mask bytes and, before their liveness is known, their table
  // entries: the loads are in flight together
  bool cell_live[kBPW];
  int entry[kBPW];
#pragma unroll
  for (int i = 0; i < kBPW; ++i) {
    const bool mine = g < kBPC && b0 + i < nb;
    cell_live[i] = mine && t < kCells && mask[(b0 + i) * kCells + t] != 0;
    entry[i] = mine && t < kTaps ? tbl[(b0 + i) * kTaps + t] : -1;
  }
  if (tid == 0) {
    for (int i = 0; i < L::kBlocks; ++i) live_s[i] = 0;
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * kBPC);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kBPW; ++i) {
    if (cell_live[i]) live_s[g * kBPW + i] = 1;
  }
  __syncthreads();
  bool any_live = false;
#pragma unroll
  for (int i = 0; i < L::kBlocks; ++i) any_live |= live_s[i] != 0;

  if (g == kBPC) {  // producer: one thread streams the weight slots
    if (!any_live || tid % 32 != 0) return;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % L::kStages;
      const int round = s / L::kStages;
      if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
      mbar_arrive_expect_tx(full0 + 8 * slot, L::kSlotBytes);
      bulk_copy(smem_addr(smem + slot * L::kSlotBytes),
                wp + static_cast<int64_t>(s) * (L::kSlotBytes / 2), L::kSlotBytes,
                full0 + 8 * slot);
    }
    return;
  }

  if (!any_live) {  // capacity padding: zeros, no gather, no products
#pragma unroll
    for (int i = 0; i < kBPW; ++i) {
      if (b0 + i >= nb) break;
      float4* o = reinterpret_cast<float4*>(out + (b0 + i) * kCells * COUT);
      for (int e = t; e < kCells * (COUT / 4); e += kWG) o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  // Both warpgroups of a live thread block run every weight stage. A block
  // with no occupied cell (or past the end) beside a live one takes no
  // neighbour: its halo is zero-filled and its output masked.
  const int bar_id = 1 + g;  // this warpgroup's named barrier
  if (t < kTaps) {
#pragma unroll
    for (int i = 0; i < kBPW; ++i) {
      const bool live = live_s[g * kBPW + i] != 0;
      if (live && entry[i] >= nsrc) __trap();
      nbr_s[g * kBPW + i][t] = live && entry[i] >= 0 ? entry[i] : -1;
    }
  }
  named_barrier(bar_id, kWG);
  // halo position -> source row (block * 64 + cell), -1 where absent
  int* row_s = reinterpret_cast<int*>(smem + L::kRowOff) + g * kBPW * kSpan3;
  for (int e = t; e < kBPW * kSpan3; e += kWG) {
    const int i = e / kSpan3;
    const int p = e - i * kSpan3;
    const int ax = p / (SPAN * SPAN) - 1;
    const int ay = (p / SPAN) % SPAN - 1;
    const int az = p % SPAN - 1;
    // floor division by 4 of a unit in [-1, 4 * STRIDE - 1]
    const int dx = (ax + 4) / 4 - 1, dy = (ay + 4) / 4 - 1, dz = (az + 4) / 4 - 1;
    const int blk = nbr_s[g * kBPW + i][(dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)];
    const int cell = (ax - 4 * dx) * 16 + (ay - 4 * dy) * 4 + (az - 4 * dz);
    row_s[e] = blk < 0 ? -1 : blk * kCells + cell;
  }
  named_barrier(bar_id, kWG);

  // halo buffers of this warpgroup: [buffer][block]
  unsigned char* halo_s = smem + L::kHaloOff + g * kBPW * L::kBufs * L::kHaloBytes;
  auto halo_buf = [&](int chunk) {
    return halo_s + (L::kBufs == 2 ? chunk & 1 : 0) * kBPW * L::kHaloBytes;
  };
  auto load_halo = [&](int chunk) {
    unsigned char* dst = halo_buf(chunk);
    for (int e = t; e < kBPW * kSpan3 * kPieces; e += kWG) {
      const int p = e / kPieces;  // block * kSpan3 + halo position
      const int part = e % kPieces;
      const int i = p / kSpan3;
      const int src = row_s[p];
      const Feat* from = src >= 0 ? feats + static_cast<int64_t>(src) * cin + chunk * kKC +
                                        part * (16 / static_cast<int>(sizeof(Feat)))
                                  : feats;
      const int row = i * kSpan3 + halo_row<STRIDE, F32>(p - i * kSpan3);
      cp_async_16(smem_addr(dst + row * L::kRowBytes + part * 16), from, src >= 0 ? 16 : 0);
    }
    cp_async_commit();
  };

  const int warp = t / 32;
  const int lane = t % 32;
  // bf16: this lane's ldmatrix row, output cell warp*16 + r, r = uy*4 + uz,
  // ux = warp; its halo position for tap (ox, oy, oz) is a_base +
  // ox*SPAN^2 + oy*SPAN + oz. f32: this lane's two A rows lane/4 and
  // lane/4 + 8 (uy 2 further) and its four channels 4 (lane % 4) ..
  // 4 (lane % 4) + 3 of the chunk (K indices 2q, 2q + 1, 8 + 2q, 9 + 2q)
  const int r = F32 ? lane >> 2 : lane & 15;
  const int half = lane >> 4;  // bf16: which 8 of the 16 channels
  const int a_base = STRIDE * (warp * SPAN * SPAN + (r >> 2) * SPAN + (r & 3));

  float acc[kBPW][COUT / 2];
#pragma unroll
  for (int i = 0; i < kBPW; ++i) {
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc[i][j] = 0.f;
  }

  const int chunks = cin / kKC;
  load_halo(0);
  for (int c = 0; c < chunks; ++c) {
    if (L::kBufs == 2 && c + 1 < chunks) {  // the next chunk's halo loads while this one's taps run
      load_halo(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    named_barrier(bar_id, kWG);  // chunk c's halo is in shared memory
    const unsigned char* buf = halo_buf(c);
    uint32_t a[2][kBPW][4];               // A fragments (f32: the hi terms)
    uint32_t a_lo[2][kBPW][F32 ? 4 : 1];  // f32: the lo terms
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int s = c * kTaps + tap;
      const int slot = s % L::kStages;
      const int off = (tap / 9) * SPAN * SPAN + ((tap / 3) % 3) * SPAN + tap % 3;
#pragma unroll
      for (int i = 0; i < kBPW; ++i) {
        const unsigned char* blk = buf + i * L::kHaloBytes;
        if constexpr (F32) {
          const int q = lane & 3;
          const float4 x0 = *reinterpret_cast<const float4*>(
              blk + halo_row<STRIDE, F32>(a_base + off) * L::kRowBytes + q * 16);
          const float4 x1 = *reinterpret_cast<const float4*>(
              blk + halo_row<STRIDE, F32>(a_base + 2 * STRIDE * SPAN + off) * L::kRowBytes + q * 16);
          uint32_t(&h)[4] = a[tap & 1][i];
          uint32_t(&l)[4] = a_lo[tap & 1][i];
          split_bf16x2(x0.x, x0.y, h[0], l[0]);
          split_bf16x2(x1.x, x1.y, h[1], l[1]);
          split_bf16x2(x0.z, x0.w, h[2], l[2]);
          split_bf16x2(x1.z, x1.w, h[3], l[3]);
        } else {
          ldmatrix_x4(smem_addr(blk + (a_base + off) * L::kRowBytes + half * 16), a[tap & 1][i]);
        }
      }
      mbar_wait(full0 + 8 * slot, (s / L::kStages) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const uint32_t stage = smem_addr(smem + slot * L::kSlotBytes);
#pragma unroll
      for (int i = 0; i < kBPW; ++i) {
        wgmma_tile<COUT>(acc[i], a[tap & 1][i], stage);
        if constexpr (F32) {
          wgmma_tile<COUT>(acc[i], a[tap & 1][i], stage + L::kStageBytes);  // Xh Wl
          wgmma_tile<COUT>(acc[i], a_lo[tap & 1][i], stage);                 // Xl Wh
        }
      }
      wgmma_commit();
      if (tap > 0) {
        wgmma_wait<1>();  // the previous tap's products have read its stage and A
        if (lane == 0) mbar_arrive(empty0 + 8 * ((s - 1) % L::kStages));
        __syncwarp();
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((c * kTaps + kTaps - 1) % L::kStages));
    named_barrier(bar_id, kWG);  // every read of this halo buffer is done
    if (L::kBufs == 1 && c + 1 < chunks) load_halo(c + 1);
  }

  const int cell_a = warp * 16 + (lane >> 2);
  const int cell_b = cell_a + 8;
#pragma unroll
  for (int i = 0; i < kBPW; ++i) {
    const int64_t b = b0 + i;
    if (b >= nb) break;
    float* out_b = out + b * kCells * COUT;
    const bool keep_a = mask[b * kCells + cell_a] != 0;
    const bool keep_b = mask[b * kCells + cell_b] != 0;
#pragma unroll
    for (int j = 0; j < COUT / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(out_b + cell_a * COUT + col) =
          keep_a ? make_float2(acc[i][4 * j], acc[i][4 * j + 1]) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(out_b + cell_b * COUT + col) =
          keep_b ? make_float2(acc[i][4 * j + 2], acc[i][4 * j + 3]) : make_float2(0.f, 0.f);
    }
  }
}

template <int SPAN, int STRIDE, int COUT, bool F32>
int launch(const void* feats, const void* tbl, const void* wp, const void* mask, void* out,
           int64_t nb, int64_t nsrc, int cin, cudaStream_t stream) {
  using L = Layout<SPAN, COUT, F32>;
  using Feat = std::conditional_t<F32, float, __nv_bfloat16>;
  auto kernel = halo_conv_kernel<SPAN, STRIDE, COUT, F32>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((nb + L::kBlocks - 1) / L::kBlocks);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const Feat*>(feats), static_cast<const int32_t*>(tbl),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), nb, nsrc, cin);
  return static_cast<int>(cudaGetLastError());
}

// calls f(Int<SPAN>, Int<STRIDE>, Int<COUT>) for a call the kernel takes;
// false for the others
template <typename F>
bool dispatch(int span, int stride, int cin, int cout, F&& f) {
  const bool geometry = (span == 6 && stride == 1) || (span == 9 && stride == 2);
  if (!geometry || cin <= 0 || cin % kKC != 0) return false;
  auto by_cout = [&](auto sp, auto st) {
    switch (cout) {
      case 32: f(sp, st, Int<32>{}); return true;
      case 64: f(sp, st, Int<64>{}); return true;
      case 128: f(sp, st, Int<128>{}); return true;
      case 256: f(sp, st, Int<256>{}); return true;
      default: return false;
    }
  };
  return span == 6 ? by_cout(Int<6>{}, Int<1>{}) : by_cout(Int<9>{}, Int<2>{});
}

template <bool F32>
int run(const void* feats, const void* tbl, const void* wp, const void* mask, void* out,
        int64_t nb, int64_t nsrc, int cin, int cout, int span, int stride, void* stream) {
  if (nb < 0 || nsrc < 0 || nb > 0x7fffffff || nsrc * kCells > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int rc = 0;
  const bool ok = dispatch(span, stride, cin, cout, [&](auto sp, auto st, auto co) {
    if (nb > 0) {
      rc = launch<decltype(sp)::value, decltype(st)::value, decltype(co)::value, F32>(
          feats, tbl, wp, mask, out, nb, nsrc, cin, static_cast<cudaStream_t>(stream));
    }
  });
  return ok ? rc : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. span/stride is 6/1 (same
// level) or 9/2 (down); wp is w packed as the header says. Returns the CUDA
// error of the launch (0 on success) or cudaErrorInvalidValue for arguments
// the kernel does not take. The caller owns every buffer; feats, wp and out
// are 16-byte aligned.
int halo_conv_bf16(const void* feats, const void* tbl, const void* wp, const void* mask,
                   void* out, int64_t nb, int64_t nsrc, int cin, int cout, int span,
                   int stride, void* stream) {
  return run<false>(feats, tbl, wp, mask, out, nb, nsrc, cin, cout, span, stride, stream);
}

// The f32 entry (the header's last paragraph): feats (Nsrc * 64, Cin) f32,
// wp the [Wh ; Wl] slots of the split f32 weights; otherwise as
// halo_conv_bf16.
int halo_conv_f32(const void* feats, const void* tbl, const void* wp, const void* mask, void* out,
                  int64_t nb, int64_t nsrc, int cin, int cout, int span, int stride,
                  void* stream) {
  return run<true>(feats, tbl, wp, mask, out, nb, nsrc, cin, cout, span, stride, stream);
}

// The launch shape for a call of the bf16 (f32 = 0) or the f32 entry:
// output blocks per thread block, weight slots in the ring, halo buffers a
// block, and dynamic shared memory bytes. Returns cudaErrorInvalidValue for
// arguments the kernel does not take.
int halo_conv_launch_shape(int span, int stride, int cin, int cout, int f32, int* bpc,
                           int* stages, int* bufs, int* smem_bytes) {
  const bool ok = dispatch(span, stride, cin, cout, [&](auto sp, auto, auto co) {
    auto fill = [&](auto layout) {
      using L = decltype(layout);
      *bpc = L::kBlocks;
      *stages = L::kStages;
      *bufs = L::kBufs;
      *smem_bytes = L::kBytes;
    };
    if (f32) {
      fill(Layout<decltype(sp)::value, decltype(co)::value, true>{});
    } else {
      fill(Layout<decltype(sp)::value, decltype(co)::value, false>{});
    }
  });
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
