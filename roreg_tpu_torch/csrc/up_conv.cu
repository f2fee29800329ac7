// Transposed (up) convolution of the block decoder for NVIDIA Hopper
// (sm_90a), after its region gather.
//
//   out[b, u, :] = mask[b, u] * sum_{d : u + d even} reg[b, R(u, d), :] @ w[d]
//
// over the taps d = (dx, dy, dz) in {-1, 0, 1}^3 (row (dx+1)*9 + (dy+1)*3 +
// (dz+1) of w) for which every axis of u + d is even, where u is a cell of
// the 4x4x4 fine block (x-major id ux*16 + uy*4 + uz) and R(u, d) =
// ((ux+dx)/2)*9 + ((uy+dy)/2)*3 + (uz+dz)/2 the coarse cell of the fine
// block's 3^3 coarse region that the tap reads. reg (B, 27, Cin) bf16 is
// that region, gathered by block_gather (zero rows for absent cells), mask
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
// byte is read once per thread block. The fine blocks' whole region (27
// rows x Cin) stays in shared memory for all classes; it comes in by
// 16-byte cp.async in two channel halves, and the first class starts on the
// first half while the second lands. At Cin <= 128 the rings are halved so
// that two thread blocks share an SM (on the card that beat 16 fine blocks a
// thread block, which shares each weight byte twice as widely). A thread
// block whose fine blocks have no occupied cell (capacity padding, which the
// host builder packs in runs after the live blocks) writes its zeros with
// 16-byte stores and leaves without starting the producers; a block without
// occupied cells beside live ones reads no region row (zero-filled) and its
// output is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
// per class: cells[8], ntaps, wrows[8], ridx[8 cells][8 taps]
constexpr int kMapWords = 8 + 1 + 8 + 64;

__constant__ int c_maps[kClasses * kMapWords];
__constant__ int c_split[kClasses];  // warpgroup g runs classes c_split[4g .. 4g + 3]

template <int COUT, bool SMALL>
struct Layout {
  static constexpr int kFB = 8;  // fine blocks per thread block: one wgmma M tile
  static constexpr int kThreads = kGroups * kWG + kGroups * 32;
  static constexpr int kStageBytes = COUT * kKC * 2;
  // a weight ring per warpgroup of 32 KB, or 16 KB where two thread blocks
  // share an SM; at most 16 stages
  static constexpr int kRingBytes = SMALL ? 16384 : 32768;
  static constexpr int kStages = kRingBytes / kStageBytes < 16 ? kRingBytes / kStageBytes : 16;
  // shared memory: rings [2][kStages] | region [kFB][27][cin + 8] | barriers
  static constexpr int kRegionOff = kGroups * kStages * kStageBytes;
  static constexpr int kStatic = kFB * kCells + kFB * 4;
  static constexpr __host__ __device__ int bar_off(int cin) {
    return (kRegionOff + kFB * kTaps * (cin + 8) * 2 + 7) / 8 * 8;
  }
  static constexpr __host__ __device__ int bytes(int cin) {
    return bar_off(cin) + 2 * kGroups * kStages * 8;
  }
};
static_assert(Layout<128, false>::bytes(256) + Layout<128, false>::kStatic <= 232448,
              "shared memory of one thread block at the widest shape");
static_assert(2 * (Layout<128, true>::bytes(128) + Layout<128, true>::kStatic + 1024) <= 233472,
              "two thread blocks an SM with the small rings");

template <int COUT, bool SMALL>
__global__ void __launch_bounds__(Layout<COUT, SMALL>::kThreads, SMALL ? 2 : 1)
up_conv_kernel(const __nv_bfloat16* __restrict__ reg, const __nv_bfloat16* __restrict__ wp,
               const uint8_t* __restrict__ mask, float* __restrict__ out, int64_t nb, int cin) {
  using L = Layout<COUT, SMALL>;
  constexpr int kFB = L::kFB;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(16) uint8_t mask_s[kFB * kCells];
  __shared__ int live_s[kFB];

  const int tid = threadIdx.x;
  const int g = tid / kWG;  // consumer warpgroup, or kGroups for the producer warps
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kFB;
  const int pitch = cin + 8;  // region row pitch in bf16
  const int chunks = cin / kKC;
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

  if (g == kGroups) {  // producers: one thread each streams its warpgroup's weight stages
    if (!any_live || tid % 32 != 0) return;
    const int ring = (tid - kGroups * kWG) / 32;
    const uint32_t full = full0 + 8 * ring * kStages;
    const uint32_t empty = empty0 + 8 * ring * kStages;
    const uint32_t ring_s = smem_addr(smem + ring * kStages * L::kStageBytes);
    int s = 0;
    for (int ci = 0; ci < kClassesPerGroup; ++ci) {
      const int* map = c_maps + c_split[ring * kClassesPerGroup + ci] * kMapWords;
      const int nt = map[8];
      for (int c = 0; c < chunks; ++c) {
        for (int t = 0; t < nt; ++t, ++s) {
          const int slot = s % kStages;
          if (s >= kStages) mbar_wait(empty + 8 * slot, (s / kStages - 1) & 1);
          mbar_arrive_expect_tx(full + 8 * slot, L::kStageBytes);
          bulk_copy(ring_s + slot * L::kStageBytes,
                    wp + (static_cast<int64_t>(c) * kTaps + map[9 + t]) * (L::kStageBytes / 2),
                    L::kStageBytes, full + 8 * slot);
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

  // the fine blocks' regions, in two channel halves (two cp.async groups);
  // a block without occupied cells reads nothing and stays zero
  __nv_bfloat16* region = reinterpret_cast<__nv_bfloat16*>(smem + L::kRegionOff);
  const int parts = cin / 16;  // 16-byte pieces of a row's channel half
  for (int h = 0; h < 2; ++h) {
    for (int e = tid; e < kFB * kTaps * parts; e += kGroups * kWG) {
      const int row = e / parts;  // fine block * 27 + region cell
      const int part = h * parts + (e - row * parts);
      const bool live = live_s[row / kTaps] != 0;
      const __nv_bfloat16* src = live ? reg + (b0 * kTaps + row) * cin + part * 8 : reg;
      cp_async_16(smem_addr(region + row * pitch + part * 8), src, live ? 16 : 0);
    }
    cp_async_commit();
  }

  const int warp = (tid % kWG) / 32;
  const int lane = tid % 32;
  // this lane's A row: class cell lane % 8 of fine block 2 warp + (lane %
  // 16) / 8, channels 8 (lane / 16) ..
  const uint32_t region_lane =
      smem_addr(region + (2 * warp + ((lane & 15) >> 3)) * kTaps * pitch + (lane >> 4) * 8);
  const uint32_t full = full0 + 8 * g * kStages;
  const uint32_t empty = empty0 + 8 * g * kStages;
  const uint32_t ring_s = smem_addr(smem + g * kStages * L::kStageBytes);
  int s = 0;  // this warpgroup's weight stage

  // one class of NT taps: chunk by chunk, tap by tap, one commit group per
  // (chunk, tap) with one more in flight; the A registers alternate by the
  // stage's parity, which the unrolled (chunk pair, tap) loop makes static
  auto run_class = [&](auto nt_c, const int* map, bool first) {
    constexpr int NT = decltype(nt_c)::value;
    float acc[COUT / 2];
#pragma unroll
    for (int j = 0; j < COUT / 2; ++j) acc[j] = 0.f;
    uint32_t a_row[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) a_row[t] = region_lane + map[17 + (lane & 7) * 8 + t] * pitch * 2;
    uint32_t a[2][4];
    const int s0 = s;
    if (first) {  // the first channel half has landed, for both warpgroups
      cp_async_wait<1>();
      named_barrier(1, kGroups * kWG);
    }
    for (int c = 0; c < chunks; c += 2) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        if (first && c + cc == chunks / 2) {
          cp_async_wait<0>();
          named_barrier(1, kGroups * kWG);
        }
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int buf = (cc * NT + t) & 1;
          ldmatrix_x4(a_row[t] + (c + cc) * kKC * 2, a[buf]);
          const int slot = s % kStages;
          mbar_wait(full + 8 * slot, (s / kStages) & 1);
          __syncwarp();  // converged for the .aligned wgmma instructions
          wgmma_fence();
          wgmma_tile<COUT>(acc, a[buf], ring_s + slot * L::kStageBytes);
          wgmma_commit();
          if (s > s0) {
            wgmma_wait<1>();  // the previous stage's products have read it and its A
            if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % kStages));
            __syncwarp();
          }
          ++s;
        }
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + 8 * ((s - 1) % kStages));

    // accumulator element 4j + 2h + e: class cell lane / 4 of fine block
    // 2 warp + h, column 8j + 2 (lane % 4) + e
    const int cell = map[lane >> 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int fb = 2 * warp + h;
      if (b0 + fb >= nb) continue;
      const bool keep = mask_s[fb * kCells + cell] != 0;
      float* o = out + ((b0 + fb) * kCells + cell) * COUT + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < COUT / 8; ++j) {
        *reinterpret_cast<float2*>(o + j * 8) =
            keep ? make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]) : make_float2(0.f, 0.f);
      }
    }
  };

  for (int ci = 0; ci < kClassesPerGroup; ++ci) {
    const int* map = c_maps + c_split[g * kClassesPerGroup + ci] * kMapWords;
    const bool first = ci == 0;
    switch (map[8]) {
      case 1: run_class(Int<1>{}, map, first); break;
      case 2: run_class(Int<2>{}, map, first); break;
      case 4: run_class(Int<4>{}, map, first); break;
      default: run_class(Int<8>{}, map, first); break;
    }
  }
}

// the small rings, two thread blocks an SM, where the region is small
bool small_ring(int cin) { return cin <= 128; }

template <int COUT, bool SMALL>
int launch(const void* reg, const void* wp, const void* mask, void* out, int64_t nb, int cin,
           cudaStream_t stream) {
  using L = Layout<COUT, SMALL>;
  auto kernel = up_conv_kernel<COUT, SMALL>;
  const int bytes = L::bytes(cin);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((nb + L::kFB - 1) / L::kFB);
  kernel<<<grid, L::kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(reg), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out), nb, cin);
  return static_cast<int>(cudaGetLastError());
}

// calls f(Int<COUT>, Int<SMALL>) for these widths; false for widths the
// kernel does not take (Cin a multiple of 32 up to 256, Cout 32, 64, 128)
template <typename F>
bool dispatch(int cin, int cout, F&& f) {
  if (cin < 32 || cin > 256 || cin % 32 != 0) return false;
  auto by_ring = [&](auto co) {
    if (small_ring(cin)) {
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

// The launch shape for a call: fine blocks per thread block and weight
// stages in each warpgroup's ring. Returns cudaErrorInvalidValue for widths
// the kernel does not take.
int up_conv_launch_shape(int cin, int cout, int* fine_blocks, int* stages) {
  const bool ok = dispatch(cin, cout, [&](auto co, auto small) {
    using L = Layout<decltype(co)::value, decltype(small)::value != 0>;
    *fine_blocks = L::kFB;
    *stages = L::kStages;
  });
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// Launches on `stream` without synchronising; the maps must have been set
// on this device, and wp is w packed as the header says. Returns the CUDA
// error of the launch (0 on success) or cudaErrorInvalidValue for arguments
// the kernel does not take. The caller owns every buffer; reg, wp, mask and
// out are 16-byte aligned.
int up_conv_bf16(const void* reg, const void* wp, const void* mask, void* out, int64_t nb,
                 int cin, int cout, void* stream) {
  if (nb < 0 || nb > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  const bool ok = dispatch(cin, cout, [&](auto co, auto small) {
    if (nb > 0) {
      rc = launch<decltype(co)::value, decltype(small)::value != 0>(reg, wp, mask, out, nb, cin, s);
    }
  });
  return ok ? rc : static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
