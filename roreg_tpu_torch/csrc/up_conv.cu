// Transposed (up) convolution of the block decoder for NVIDIA Hopper
// (sm_90a), after its region gather.
//
//   out[b, u, :] = mask[b, u] * sum_{d : u + d even} reg[b, R(u, d), :] @ w[d]
//
// over the taps d = (dx, dy, dz) in {-1, 0, 1}^3 (row (dx+1)*9 + (dy+1)*3 +
// (dz+1) of w) for which every axis of u + d is even, where u is a cell of
// the 4x4x4 fine block (x-major id ux*16 + uy*4 + uz) and R(u, d) =
// ((ux+dx)/2)*9 + ((uy+dy)/2)*3 + (uz+dz)/2 the coarse cell of the fine
// block's 3^3 coarse region that the tap reads. reg (B, 27, Cin) bf16 (f32
// at the f32 entry) is that region, gathered by block_gather (zero rows for
// absent cells), mask
// (B, 64) uint8 (0 or 1), out (B, 64, Cout) f32. The weights w (27, Cin, Cout) bf16
// come packed by the caller (kernels/halo_conv.py pack_weights, chunk-major)
// as Cin/16 x 27 stages: stage (c, tap) holds w[tap, 16c:16c+16, :] in
// wgmma's K-major layout of 8x8 core matrices without swizzle (hopper.cuh
// b_desc). Cin is a multiple of 32 up to 256, Cout 32, 64 or 128.
//
// The taps of a cell depend only on its parity: an even axis takes d = 0,
// an odd one d = -1 and +1. So the 64 cells fall into 8 parity classes of 8
// cells, class (px, py, pz) with 2^(px+py+pz) taps (1, 2, 2, 2, 4, 4, 4, 8:
// 27 in all), and every weight row belongs to exactly one class. The
// classes' cells, weight rows and region rows, and their split between the
// two consumer warpgroups, are static; the wrapper copies them into
// __constant__ memory from the same Python function the plain version uses
// (kernels/up_conv.py up_parity_classes, up_class_table, up_class_split).
//
// Replaces the TPU kernel scripts/experiment_pallas_primitives.py p4
// (Pallas body p4_kernel, line 143): a per-block one-hot assembly GEMM
// (48, 144) @ (144, C), a static 0/1 selection of rows, which assembles the
// parity-class im2col rows of conv_up (roreg_tpu/sparse/block.py:379-408)
// on the TPU's matrix unit. Here the selection is an address: the class
// GEMMs read their rows from the region in shared memory, and the assembly,
// the 8 class GEMMs, the class-to-cell permutation and the mask are one
// kernel.
//
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM):
// bytes, mostly the f32 output of every capacity block. A live fine block
// is 216 (cell, tap) products of 2 * Cin * Cout operations; the three up
// convs of one rotation chunk (conv4_tr 5120 blocks 256 -> 128, conv3_tr
// 10240 blocks 256 -> 64, conv2_tr 30720 blocks 128 -> 64) write about
// 0.84 GB of f32 output (0.25 ms) and multiply far less.
// chip_smoke.py computes each shape's bound from the tables and masks of
// its run (kernels/up_conv.py up_work). Beside the bound, each thread
// block reads all 27 * Cin * Cout weights once from L2, so the weights are
// shared by all the fine blocks of a thread block.
//
// Design: a thread block owns 8 consecutive fine blocks and holds two
// consumer warpgroups and two producer warps. A class's 8 cells in each of
// the 8 fine blocks make the M = 64 rows of wgmma.mma_async m64nNk16 (bf16
// in, f32 accumulators in registers), N covering all of Cout, so the region
// is read once per fine block. Warpgroup g runs the 4 classes
// up_class_split gives it (13 and 14 taps), one after another, with one
// class's accumulators live at a time (Cout/2 f32 a thread), and writes each
// class's cells as it finishes. Warp w of a warpgroup holds rows
// 16w..16w+15, the class cells of fine blocks 2w and 2w+1, and reads its A
// fragment of a tap (16 scattered region rows) with ldmatrix by per-lane row
// addresses: A comes from registers, as in halo_conv. Producer warp g
// streams warpgroup g's weight stages (class by class, 16-channel chunk,
// tap) through its own mbarrier ring with cp.async.bulk, so every weight
// byte is read once per thread block. The fine blocks' whole bf16 region
// (27 rows x Cin) stays in shared memory for all classes; it comes in by
// 16-byte cp.async in two channel halves, and the first class starts on the
// first half while the second lands. At Cin <= 128 the bf16 entry's rings
// are halved so that two thread blocks share an SM (on the card that beat
// 16 fine blocks a thread block, which shares each weight byte twice as
// widely). A thread
// block whose fine blocks have no occupied cell (capacity padding, which the
// host builder packs in runs after the live blocks) writes its zeros with
// 16-byte stores and leaves without starting the producers; a block without
// occupied cells beside live ones reads no region row (zero-filled) and its
// output is masked.
//
// The f32 entry (up_conv_f32) takes the f32 region as it is and f32
// weights, the latter packed by the caller (kernels/halo_conv.py
// pack_split_weights) as the two bf16 terms Wh = bf16(w), Wl = bf16(w - Wh)
// of each (chunk, tap) stage side by side in one ring slot, [Wh ; Wl], with
// the 16 input rows of both in the order F32_K_ORDER. Each f32 region row
// that a live fine block needs is read from device memory once, into the
// region in shared memory. Each lane loads its four channels of its two A
// rows of a tap as two 16-byte words (K index k of the stage being channel
// F32_K_ORDER[k], so that those four are adjacent) and splits them in
// registers into a hi and a lo A fragment (Xh = bf16(x), Xl = bf16(x -
// Xh)); a tap runs the three products Xh Wh + Xh Wl + Xl Wh into the
// class's f32 accumulators, the arithmetic of kernels/split.py (about 3 *
// 2^-18 of a product lost; Xl Wl is dropped), as halo_conv's f32 entry
// does. A call is one launch and one pass over the weights.
//
// Shared memory at f32: the whole f32 region, 8 fine blocks x 27 rows x
// Cin x 4 bytes, is 221 KB at Cin 256 and cannot sit beside two weight
// rings of [Wh ; Wl] slots. So the region comes in parts of at most 128
// channels (110.6 KB), one after another in the same buffer: Cin <= 128
// is one part; Cin 160-256 two, channels 0-127 then the rest. Every class
// runs over the first part's chunks and stores its sums; after a barrier of
// both warpgroups the second part is staged, and each class adds the sums
// it stored as it stores again (each thread reads back exactly the output
// elements it wrote). That is still one launch and one read of each region
// element; for the two Cin-256 layers of the decoder it costs one more
// write and read of the f32 output (about 0.34 GB a chunk, 0.1-0.2 ms at
// 3.35 TB/s), where streaming the region by chunk and re-reading it from
// L2 for each class would read it 4 times from L2, and keeping the 4
// classes' sums in registers across the parts needs 4 x Cout/2 f32 a
// thread (256 at Cout 128). The rings take what the widest part leaves:
// 7 slots a warpgroup at Cout 128, 14 at Cout 64; the small rings of two
// thread blocks an SM do not fit beside an f32 region. An f32 region row
// part is 64-byte chunks without padding, and an 8-lane phase of a 16-byte
// load reads one chunk of two rows that differ by one (the class's cells
// 2j and 2j + 1 differ by 2 along z, their region rows by 1): chunk c of
// region row r sits at chunk c ^ (r & 1) of its row, so the two halves of
// a phase fall in different 64-byte halves of the 128 bytes of banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kCells = 64;
constexpr int kTaps = 27;
constexpr int kClasses = 8;
constexpr int kKC = 16;     // input channels per chunk: one wgmma K step
constexpr int kWG = 128;    // threads of a warpgroup
constexpr int kGroups = 2;  // consumer warpgroups, each with its producer warp
constexpr int kClassesPerGroup = kClasses / kGroups;
constexpr int kPartCh = 128;  // f32: channels of a region part
// shared memory a thread block may take, static arrays included
constexpr int kSmemBudget = 232448;
// per class: cells[8], ntaps, wrows[8], ridx[8 cells][8 taps]
constexpr int kMapWords = 8 + 1 + 8 + 64;

__constant__ int c_maps[kClasses * kMapWords];
__constant__ int c_split[kClasses];  // warpgroup g runs classes c_split[4g .. 4g + 3]

template <int COUT, bool SMALL, bool F32>
struct Layout {
  static constexpr int kFB = 8;  // fine blocks per thread block: one wgmma M tile
  static constexpr int kThreads = kGroups * kWG + kGroups * 32;
  static constexpr int kStageBytes = COUT * kKC * 2;  // one bf16 weight stage
  // a ring slot: one stage, or at f32 the two terms' stages [Wh ; Wl]
  static constexpr int kSlotBytes = F32 ? 2 * kStageBytes : kStageBytes;
  static constexpr int kStatic = kFB * kCells + kFB * 4;
  // a weight ring per warpgroup: bf16 32 KB, or 16 KB where two thread
  // blocks share an SM; f32 what the widest region part leaves; at most 16
  // slots
  static constexpr int kRingBytes =
      F32 ? (kSmemBudget - kStatic - kFB * kTaps * kPartCh * 4 - 2 * kGroups * 16 * 8) / kGroups
          : (SMALL ? 16384 : 32768);
  static constexpr int kStages = kRingBytes / kSlotBytes < 16 ? kRingBytes / kSlotBytes : 16;
  // shared memory: rings [2][kStages] | region [kFB][27][pitch] | barriers
  static constexpr int kRegionOff = kGroups * kStages * kSlotBytes;
  // a region row in bytes: bf16 cin + 8 channels, f32 one part's channels
  static constexpr __host__ __device__ int pitch(int cin) {
    return F32 ? (cin < kPartCh ? cin : kPartCh) * 4 : (cin + 8) * 2;
  }
  // the region's parts, staged one after another
  static constexpr __host__ __device__ int parts(int cin) {
    return F32 ? (cin + kPartCh - 1) / kPartCh : 1;
  }
  static constexpr __host__ __device__ int bar_off(int cin) {
    return (kRegionOff + kFB * kTaps * pitch(cin) + 7) / 8 * 8;
  }
  static constexpr __host__ __device__ int bytes(int cin) {
    return bar_off(cin) + 2 * kGroups * kStages * 8;
  }
};
static_assert(Layout<128, false, false>::bytes(256) + Layout<128, false, false>::kStatic <= kSmemBudget,
              "shared memory of one thread block at the widest shape");
static_assert(2 * (Layout<128, true, false>::bytes(128) + Layout<128, true, false>::kStatic + 1024) <=
                  233472,
              "two thread blocks an SM with the small rings");
template <int COUT>
constexpr bool f32_fits() {
  using L = Layout<COUT, false, true>;
  return L::bytes(256) + L::kStatic <= kSmemBudget && L::kStages >= 4;
}
static_assert(f32_fits<32>() && f32_fits<64>() && f32_fits<128>(),
              "f32: a region part and at least four [Wh ; Wl] slots a ring");

// 16 bytes of shared memory as four f32
__device__ __forceinline__ float4 ld_shared_f32x4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}

// F32: f32 region, [Wh ; Wl] slots, three products a tap, the region in
// parts (the header's last two paragraphs); else bf16 operands
template <int COUT, bool SMALL, bool F32>
__global__ void __launch_bounds__(Layout<COUT, SMALL, F32>::kThreads, SMALL ? 2 : 1)
up_conv_kernel(const std::conditional_t<F32, float, __nv_bfloat16>* __restrict__ reg,
               const __nv_bfloat16* __restrict__ wp, const uint8_t* __restrict__ mask,
               float* __restrict__ out, int64_t nb, int cin) {
  using L = Layout<COUT, SMALL, F32>;
  using In = std::conditional_t<F32, float, __nv_bfloat16>;
  constexpr int kFB = L::kFB;
  constexpr int kStages = L::kStages;
  constexpr int kPieces = 16 / sizeof(In);  // elements of a 16-byte piece
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(16) uint8_t mask_s[kFB * kCells];
  __shared__ int live_s[kFB];

  const int tid = threadIdx.x;
  const int g = tid / kWG;  // consumer warpgroup, or kGroups for the producer warps
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kFB;
  const int pitch = L::pitch(cin);  // region row in bytes
  const int chunks = cin / kKC;
  const int parts = L::parts(cin);
  const int part_chunks = F32 ? kPartCh / kKC : chunks;  // chunks of a full part
  const uint32_t full0 = smem_addr(smem + L::bar_off(cin));  // [ring][slot]
  const uint32_t empty0 = full0 + 8 * kGroups * kStages;

  if (tid < kFB) live_s[tid] = 0;
  if (tid == 0) {
    for (int s = 0; s < kGroups * kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  bool mine = false;  // an occupied cell among this thread's 16 mask bytes
  for (int e = tid; e < kFB * kCells / 16; e += L::kThreads) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + e / 4 < nb) v = reinterpret_cast<const uint4*>(mask + b0 * kCells)[e];
    reinterpret_cast<uint4*>(mask_s)[e] = v;
    if (v.x | v.y | v.z | v.w) {
      live_s[e / 4] = 1;
      mine = true;
    }
  }
  const bool any_live = __syncthreads_or(mine);

  if (g == kGroups) {  // producers: one thread each streams its warpgroup's weight slots
    if (!any_live || tid % 32 != 0) return;
    const int ring = (tid - kGroups * kWG) / 32;
    const uint32_t full = full0 + 8 * ring * kStages;
    const uint32_t empty = empty0 + 8 * ring * kStages;
    const uint32_t ring_s = smem_addr(smem + ring * kStages * L::kSlotBytes);
    // the slots in the consumers' order: region part, class, chunk, tap
    int s = 0;
    for (int p = 0; p < parts; ++p) {
      const int c1 = min(chunks, (p + 1) * part_chunks);
      for (int ci = 0; ci < kClassesPerGroup; ++ci) {
        const int* map = c_maps + c_split[ring * kClassesPerGroup + ci] * kMapWords;
        const int nt = map[8];
        for (int c = p * part_chunks; c < c1; ++c) {
          for (int t = 0; t < nt; ++t, ++s) {
            const int slot = s % kStages;
            if (s >= kStages) mbar_wait(empty + 8 * slot, (s / kStages - 1) & 1);
            mbar_arrive_expect_tx(full + 8 * slot, L::kSlotBytes);
            bulk_copy(ring_s + slot * L::kSlotBytes,
                      wp + (static_cast<int64_t>(c) * kTaps + map[9 + t]) * (L::kSlotBytes / 2),
                      L::kSlotBytes, full + 8 * slot);
          }
        }
      }
    }
    return;
  }

  if (!any_live) {  // capacity padding: zeros, no loads, no products
    for (int e = tid; e < kFB * kCells * (COUT / 4); e += kGroups * kWG) {
      const int64_t row = b0 * kCells + e / (COUT / 4);
      if (row < nb * kCells) {
        reinterpret_cast<float4*>(out + row * COUT)[e % (COUT / 4)] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // part p of the fine blocks' regions, in two channel halves (two cp.async
  // groups); a block without occupied cells reads nothing and stays zero.
  // f32: chunk c of row r lands at chunk c ^ (r & 1) of its row (piece
  // index ^ 4), the part's chunk count being even
  unsigned char* region = smem + L::kRegionOff;
  auto stage_region = [&](int p) {
    const int c0 = p * part_chunks;
    const int half = min(chunks - c0, part_chunks) / 2 * (kKC / kPieces);  // pieces of half a row
    for (int h = 0; h < 2; ++h) {
      for (int e = tid; e < kFB * kTaps * half; e += kGroups * kWG) {
        const int row = e / half;  // fine block * 27 + region cell
        const int piece = h * half + (e - row * half);
        const bool live = live_s[row / kTaps] != 0;
        const In* src = live ? reg + (b0 * kTaps + row) * cin + c0 * kKC + piece * kPieces : reg;
        const int at = F32 ? piece ^ ((row & 1) << 2) : piece;
        cp_async_16(smem_addr(region + row * pitch + at * 16), src, live ? 16 : 0);
      }
      cp_async_commit();
    }
  };
  stage_region(0);

  const int warp = (tid % kWG) / 32;
  const int lane = tid % 32;
  // bf16: this lane's ldmatrix row, class cell lane % 8 of fine block
  // 2 warp + (lane % 16) / 8, channels 8 (lane / 16) .. of a chunk. f32: its
  // two A rows, class cell lane / 4 of fine blocks 2 warp and 2 warp + 1,
  // channels 4 (lane % 4) .. 4 (lane % 4) + 3 of a chunk (K indices 2q,
  // 2q + 1, 8 + 2q, 9 + 2q in F32_K_ORDER)
  const int cell_row = F32 ? lane >> 2 : lane & 7;
  const uint32_t region_lane =
      F32 ? smem_addr(region + 2 * warp * kTaps * pitch + (lane & 3) * 16)
          : smem_addr(region + (2 * warp + ((lane & 15) >> 3)) * kTaps * pitch + (lane >> 4) * 16);
  const uint32_t full = full0 + 8 * g * kStages;
  const uint32_t empty = empty0 + 8 * g * kStages;
  const uint32_t ring_s = smem_addr(smem + g * kStages * L::kSlotBytes);
  int s = 0;  // this warpgroup's weight slot

  // this thread's accumulator element 4j + 2h + e: class cell lane / 4 of
  // fine block 2 warp + h, column 8j + 2 (lane % 4) + e
  auto out_at = [&](int cell, int h) {
    return out + ((b0 + 2 * warp + h) * kCells + cell) * COUT + (lane & 3) * 2;
  };

  // one class of NT taps over the NCH chunks of a region part: chunk by
  // chunk, tap by tap, one commit group per (chunk, tap) with one more in
  // flight; the A registers alternate by the tap's parity, which the
  // unrolled (chunk pair, tap) loop makes static. With carry the sums
  // this thread stored for the part before are added as it stores (loaded
  // into the accumulators before the products, they made ptxas serialise
  // the wgmma pipeline at Cout 32 and 64).
  auto run_class = [&](auto nt_c, const int* map, bool first, bool carry, int nch) {
    constexpr int NT = decltype(nt_c)::value;
    float acc[COUT / 2];
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc[j] = 0.f;
    uint32_t a_row[NT];
    int odd = 0;  // f32: bit t set where tap t's region row of fine block 2 warp is odd
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int r = map[17 + cell_row * 8 + t];
      a_row[t] = region_lane + r * pitch;
      odd |= (r & 1) << t;
    }
    uint32_t a[2][4];                                // A fragments (f32: the hi terms)
    [[maybe_unused]] uint32_t a_lo[2][F32 ? 4 : 1];  // f32: the lo terms
    const int s0 = s;
    // one slot's products with the A registers of buffer `buf`
    auto mma = [&](int buf) {
      const int slot = s % kStages;
      mbar_wait(full + 8 * slot, (s / kStages) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const uint32_t stage = ring_s + slot * L::kSlotBytes;
      wgmma_tile<COUT>(acc, a[buf], stage);
      if constexpr (F32) {
        wgmma_tile<COUT>(acc, a[buf], stage + L::kStageBytes);  // Xh Wl
        wgmma_tile<COUT>(acc, a_lo[buf], stage);                 // Xl Wh
      }
      wgmma_commit();
      if (s > s0) {
        wgmma_wait<1>();  // the previous slot's products have read it and its A
        if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % kStages));
        __syncwarp();
      }
      ++s;
    };
    if (first) {  // the part's first channel half has landed, for both warpgroups
      cp_async_wait<1>();
      named_barrier(1, kGroups * kWG);
    }
    for (int c = 0; c < nch; c += 2) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (first && c + cc == nch / 2) {
          cp_async_wait<0>();
          named_barrier(1, kGroups * kWG);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int buf = (cc * NT + t) & 1;
          if constexpr (F32) {
            // chunk c + cc (c even) of a row sits at chunk slot c + (cc ^
            // the row's parity); fine block 2 warp + 1's row is 27 rows on,
            // of the other parity
            const int sw = ((odd >> t) ^ cc) & 1;
            const float4 x0 = ld_shared_f32x4(a_row[t] + (c + sw) * kKC * 4);
            const float4 x1 = ld_shared_f32x4(a_row[t] + kTaps * pitch + (c + (sw ^ 1)) * kKC * 4);
            uint32_t(&hi)[4] = a[buf];
            uint32_t(&lo)[4] = a_lo[buf];
            split_bf16x2(x0.x, x0.y, hi[0], lo[0]);
            split_bf16x2(x1.x, x1.y, hi[1], lo[1]);
            split_bf16x2(x0.z, x0.w, hi[2], lo[2]);
            split_bf16x2(x1.z, x1.w, hi[3], lo[3]);
          } else {
            ldmatrix_x4(a_row[t] + (c + cc) * kKC * 2, a[buf]);
          }
          mma(buf);
        }
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % kStages));

    const int cell = map[lane >> 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fb = 2 * warp + h;
      if (b0 + fb >= nb) continue;
      const bool keep = mask_s[fb * kCells + cell] != 0;
      float* o = out_at(cell, h);
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j) {
        float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        if (F32 && carry) {
          const float2 before = *reinterpret_cast<const float2*>(o + j * 8);
          v.x += before.x;
          v.y += before.y;
        }
        *reinterpret_cast<float2*>(o + j * 8) = keep ? v : make_float2(0.f, 0.f);
      }
    }
  };

  for (int p = 0; p < parts; ++p) {
    if (p > 0) {  // the sums over part p - 1 are stored; part p takes its place
      named_barrier(1, kGroups * kWG);  // both warpgroups are done with part p - 1
      stage_region(p);
    }
    const int nch = min(chunks - p * part_chunks, part_chunks);
    for (int ci = 0; ci < kClassesPerGroup; ++ci) {
      const int* map = c_maps + c_split[g * kClassesPerGroup + ci] * kMapWords;
      const bool first = ci == 0;
      const bool carry = p > 0;
      switch (map[8]) {
        case 1: run_class(Int<1>{}, map, first, carry, nch); break;
        case 2: run_class(Int<2>{}, map, first, carry, nch); break;
        case 4: run_class(Int<4>{}, map, first, carry, nch); break;
        default: run_class(Int<8>{}, map, first, carry, nch); break;
      }
    }
  }
}

// the small rings, two thread blocks an SM, where the bf16 region is small
bool small_ring(int cin) { return cin <= 128; }

template <int COUT, bool SMALL, bool F32>
int launch(const void* reg, const void* wp, const void* mask, void* out, int64_t nb, int cin,
           cudaStream_t stream) {
  using L = Layout<COUT, SMALL, F32>;
  using In = std::conditional_t<F32, float, __nv_bfloat16>;
  auto kernel = up_conv_kernel<COUT, SMALL, F32>;
  const int bytes = L::bytes(cin);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((nb + L::kFB - 1) / L::kFB);
  kernel<<<grid, L::kThreads, bytes, stream>>>(
      static_cast<const In*>(reg), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), nb, cin);
  return static_cast<int>(cudaGetLastError());
}

// calls f(Int<COUT>, Int<SMALL>) for these widths; false for widths the
// kernel does not take (Cin a multiple of 32 up to 256, Cout 32, 64, 128).
// The f32 entry never takes the small rings.
template <bool F32, typename F>
bool dispatch(int cin, int cout, F&& f) {
  if (cin < 32 || cin > 256 || cin % 32 != 0) return false;
  auto by_ring = [&](auto co) {
    if constexpr (F32) {
      f(co, Int<0>{});
    } else if (small_ring(cin)) {
      f(co, Int<1>{});
    } else {
      f(co, Int<0>{});
    }
    return true;
  };
  switch (cout) {
    case 32: return by_ring(Int<32>{});
    case 64: return by_ring(Int<64>{});
    case 128: return by_ring(Int<128>{});
    default: return false;
  }
}

template <bool F32>
int run(const void* reg, const void* wp, const void* mask, void* out, int64_t nb, int cin, int cout,
        void* stream) {
  if (nb < 0 || nb > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  int rc = 0;
  const bool ok = dispatch<F32>(cin, cout, [&](auto co, auto small) {
    if (nb > 0) {
      rc = launch<decltype(co)::value, decltype(small)::value != 0, F32>(
          reg, wp, mask, out, nb, cin, static_cast<cudaStream_t>(stream));
    }
  });
  return ok ? rc : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Copies the parity classes' static maps (kClasses * kMapWords int32, the
// layout of kernels/up_conv.py up_class_table) and the class split between
// the two warpgroups (kClasses int32, up_class_split) into constant memory
// of the current device. Returns the CUDA error (0 on success) or
// cudaErrorInvalidValue for tables of another size or with an entry out of
// range.
int up_conv_set_maps(const int* maps, int count, const int* split, int nsplit) {
  if (count != kClasses * kMapWords || nsplit != kClasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int seen = 0;
  for (int i = 0; i < kClasses; ++i) {
    if (split[i] < 0 || split[i] >= kClasses || (seen >> split[i]) & 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    seen |= 1 << split[i];
  }
  for (int c = 0; c < kClasses; ++c) {
    const int* m = maps + c * kMapWords;
    if (m[8] != 1 && m[8] != 2 && m[8] != 4 && m[8] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int i = 0; i < 8; ++i) {
      if (m[i] < 0 || m[i] >= kCells || m[9 + i] < 0 || m[9 + i] >= kTaps) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    for (int i = 0; i < 64; ++i) {
      if (m[17 + i] < 0 || m[17 + i] >= kTaps) return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  cudaError_t err = cudaMemcpyToSymbol(c_maps, maps, sizeof(int) * kClasses * kMapWords);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaMemcpyToSymbol(c_split, split, sizeof(int) * kClasses));
}

// The launch shape of the bf16 (f32 = 0) or the f32 entry for these widths:
// fine blocks per thread block, weight slots in each warpgroup's ring, the
// region's parts and dynamic shared memory bytes. Returns
// cudaErrorInvalidValue for widths the kernel does not take.
int up_conv_launch_shape(int cin, int cout, int f32, int* fine_blocks, int* stages, int* parts,
                         int* smem_bytes) {
  auto fill = [&](auto co, auto small, auto is_f32) {
    using L = Layout<decltype(co)::value, decltype(small)::value != 0, decltype(is_f32)::value != 0>;
    *fine_blocks = L::kFB;
    *stages = L::kStages;
    *parts = L::parts(cin);
    *smem_bytes = L::bytes(cin);
  };
  const bool ok = f32 ? dispatch<true>(cin, cout, [&](auto co, auto small) { fill(co, small, Int<1>{}); })
                      : dispatch<false>(cin, cout, [&](auto co, auto small) { fill(co, small, Int<0>{}); });
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches on `stream` without synchronising; the maps must have been set
// on this device, and wp is w packed as the header says. Returns the CUDA
// error of the launch (0 on success) or cudaErrorInvalidValue for arguments
// the kernel does not take. The caller owns every buffer; reg, wp, mask and
// out are 16-byte aligned.
int up_conv_bf16(const void* reg, const void* wp, const void* mask, void* out, int64_t nb,
                 int cin, int cout, void* stream) {
  return run<false>(reg, wp, mask, out, nb, cin, cout, stream);
}

// The f32 entry (the header's last two paragraphs): reg (B, 27, Cin) f32,
// wp the [Wh ; Wl] slots of the split f32 weights; otherwise as
// up_conv_bf16.
int up_conv_f32(const void* reg, const void* wp, const void* mask, void* out, int64_t nb, int cin,
                int cout, void* stream) {
  return run<true>(reg, wp, mask, out, nb, cin, cout, stream);
}

}  // extern "C"
