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
// that region, gathered by block_gather (zero rows for absent cells), w
// (27, Cin, Cout) bf16, mask (B, 64) uint8, out (B, 64, Cout) f32. Cin is a
// multiple of 16, Cout of 32.
//
// The taps of a cell depend only on its parity: an even axis takes d = 0,
// an odd one d = -1 and +1. So the 64 cells fall into 8 parity classes of 8
// cells, class (px, py, pz) with 2^(px+py+pz) taps, 216 (cell, tap) pairs a
// block. The classes' cells, weight rows and region rows are static; the
// wrapper copies them into __constant__ memory from the same Python
// function the plain version uses (kernels/up_conv.py up_parity_classes).
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
// What bounds it on an H100 (989 TFLOP/s bf16 dense, 3.35 TB/s HBM): bytes.
// At full capacity a block is 216 (cell, tap) products of 2 * Cin * Cout
// operations; the three up convs of one rotation chunk (conv4_tr 5120
// blocks 256 -> 128, conv3_tr 10240 blocks 256 -> 64, conv2_tr 30720 blocks
// 128 -> 64) are about 0.25 TFLOP at most (0.26 ms), while the bf16 regions
// in and the f32 outputs of every capacity block are about 1.26 GB
// (0.38 ms). chip_smoke.py computes each shape's bound from the tables and
// masks of its run (kernels/up_conv.py up_work).
//
// Design: one thread block (8 warps) owns 4 fine blocks and a 32- or
// 64-column slice of Cout; warp c computes parity class c. A class's 8 cells
// of two fine blocks make one 16-row tile, so each warp holds two such tiles
// (16 x BN f32 accumulators each, in registers). The thread block first
// reads its blocks' 256 mask bytes; if no cell is occupied (capacity
// padding) it writes zeros and leaves. Otherwise, for each 16-channel step,
// it loads the occupied blocks' 27 region rows (16 channels, 16-byte loads)
// and the 16 rows of all 27 w[d] slices into shared memory, and each warp
// runs its class's taps as 16-row x 16-deep x 8-column bf16 tensor-core
// products (mma.sync m16n8k16, f32 accumulation). A tap's A operand is 16
// region rows, which ldmatrix reads directly by per-lane row addresses, so
// no im2col copy is made. The epilogue writes each class cell's row to its
// x-major place, zero where the cell is empty. This is the simple kernel
// that is right; reading the region through the block table in place of
// the separate gather, cp.async pipelining and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCells = 64;
constexpr int kTaps = 27;
constexpr int kClasses = 8;
constexpr int kThreads = 32 * kClasses;  // one warp per parity class
constexpr int kPairs = 2;                // 16-row tiles per warp
constexpr int kBlocks = 2 * kPairs;      // fine blocks per thread block
constexpr int kKC = 16;                  // input channels per step
constexpr int kLDR = kKC + 8;            // region row pitch in bf16: 48 bytes
// per class: cells[8], ntaps, wrows[8], ridx[8 cells][8 taps]
constexpr int kMapWords = 8 + 1 + 8 + 64;

__constant__ int c_maps[kClasses * kMapWords];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0,
                                            uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// d += a (16x16 bf16, row) @ b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BN>
constexpr int smem_bytes() {
  return kTaps * kKC * (BN + 8) * 2 + kBlocks * kTaps * kLDR * 2;
}

template <int BN>
__global__ void __launch_bounds__(kThreads)
up_conv_kernel(const __nv_bfloat16* __restrict__ reg,
               const __nv_bfloat16* __restrict__ w,
               const uint8_t* __restrict__ mask, float* __restrict__ out,
               int64_t nb, int cin, int cout) {
  constexpr int kLDW = BN + 8;  // weight row pitch in bf16
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* reg_s = w_s + kTaps * kKC * kLDW;
  __shared__ int occ_s[kBlocks];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kBlocks;
  const int n0 = blockIdx.y * BN;

  if (tid < kBlocks) occ_s[tid] = 0;
  __syncthreads();
  {
    const int blk = tid / kCells;  // kBlocks * 64 == kThreads
    if (b0 + blk < nb && mask[(b0 + blk) * kCells + tid % kCells]) occ_s[blk] = 1;
  }
  __syncthreads();
  bool any = false;
#pragma unroll
  for (int i = 0; i < kBlocks; ++i) any |= occ_s[i] != 0;
  if (!any) {  // capacity padding: zeros, no loads, no products
    for (int e = tid; e < kBlocks * kCells * (BN / 4); e += kThreads) {
      const int row = e / (BN / 4);  // blk * 64 + cell
      const int c = (e % (BN / 4)) * 4;
      if (b0 + row / kCells < nb) {
        *reinterpret_cast<float4*>(out + (b0 * kCells + row) * cout + n0 + c) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // this warp's class; this lane's A row r is class cell r % 8 of fine
  // block 2 * pair + r / 8
  const int* map = c_maps + warp * kMapWords;
  const int ntaps = map[8];
  const int r = lane & 15;
  const int half = lane >> 4;  // which 8 of the 16 channels (A) or columns (B)
  int rrow[8], wrow[8];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    rrow[t] = map[17 + (r & 7) * 8 + t];
    wrow[t] = map[9 + t];
  }
  const int a_blk = r >> 3;

  float acc[kPairs][BN / 8][4];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int t = 0; t < BN / 8; ++t) {
      acc[p][t][0] = acc[p][t][1] = acc[p][t][2] = acc[p][t][3] = 0.f;
    }
  }

  for (int c0 = 0; c0 < cin; c0 += kKC) {
    __syncthreads();  // the previous step's reads are done
    for (int e = tid; e < kBlocks * kTaps * 2; e += kThreads) {
      const int row = e >> 1;  // blk * 27 + region cell
      const int part = e & 1;
      const int blk = row / kTaps;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (occ_s[blk]) {  // an occupied block lies below nb
        v = __ldg(reinterpret_cast<const uint4*>(
            reg + (b0 * kTaps + row) * cin + c0 + part * 8));
      }
      *reinterpret_cast<uint4*>(reg_s + row * kLDR + part * 8) = v;
    }
    for (int e = tid; e < kTaps * kKC * (BN / 8); e += kThreads) {
      const int col8 = e % (BN / 8);
      const int row = e / (BN / 8);  // tap * kKC + k
      const int tap = row / kKC;
      const int k = row - tap * kKC;
      *reinterpret_cast<uint4*>(w_s + row * kLDW + col8 * 8) =
          __ldg(reinterpret_cast<const uint4*>(
              w + (static_cast<int64_t>(tap) * cin + c0 + k) * cout + n0 +
              col8 * 8));
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t >= ntaps) break;  // uniform across the warp
      uint32_t a[kPairs][4];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int row = (2 * p + a_blk) * kTaps + rrow[t];
        ldmatrix_x4(smem_addr(reg_s + row * kLDR + half * 8), a[p][0], a[p][1],
                    a[p][2], a[p][3]);
      }
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t b0f, b1f, b2f, b3f;
        ldmatrix_x4_trans(
            smem_addr(w_s + (wrow[t] * kKC + r) * kLDW + j * 16 + half * 8),
            b0f, b1f, b2f, b3f);
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          mma_bf16(acc[p][2 * j], a[p][0], a[p][1], a[p][2], a[p][3], b0f, b1f);
          mma_bf16(acc[p][2 * j + 1], a[p][0], a[p][1], a[p][2], a[p][3], b2f,
                   b3f);
        }
      }
    }
  }

  // accumulator layout (m16n8): rows lane/4 and lane/4 + 8, columns
  // 2*(lane%4) and +1 of each 8-column tile; row i < 8 is class cell i of
  // the pair's first block, row i + 8 the same cell of its second
  const int cell = map[lane >> 2];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t blk = b0 + 2 * p + h;
      if (blk >= nb) continue;
      const bool keep = mask[blk * kCells + cell] != 0;
      float* o = out + (blk * kCells + cell) * cout + n0;
#pragma unroll
      for (int t = 0; t < BN / 8; ++t) {
        const int col = t * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(o + col) =
            keep ? make_float2(acc[p][t][2 * h], acc[p][t][2 * h + 1])
                 : make_float2(0.f, 0.f);
      }
    }
  }
}

template <int BN>
int launch(const void* reg, const void* w, const void* mask, void* out,
           int64_t nb, int cin, int cout, cudaStream_t stream) {
  auto kernel = up_conv_kernel<BN>;
  constexpr int bytes = smem_bytes<BN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((nb + kBlocks - 1) / kBlocks);
  kernel<<<dim3(tiles, cout / BN), kThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(reg),
      static_cast<const __nv_bfloat16*>(w), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), nb, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Copies the parity classes' static maps (kClasses * kMapWords int32, the
// layout of kernels/up_conv.py up_class_table) into constant memory of the
// current device. Returns the CUDA error (0 on success) or
// cudaErrorInvalidValue for a table of another size or with an entry out
// of range.
int up_conv_set_maps(const int* maps, int count) {
  if (count != kClasses * kMapWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int c = 0; c < kClasses; ++c) {
    const int* m = maps + c * kMapWords;
    if (m[8] < 1 || m[8] > 8) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 8; ++i) {
      if (m[i] < 0 || m[i] >= kCells || m[9 + i] < 0 || m[9 + i] >= kTaps) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    for (int i = 0; i < 64; ++i) {
      if (m[17 + i] < 0 || m[17 + i] >= kTaps) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  return static_cast<int>(
      cudaMemcpyToSymbol(c_maps, maps, sizeof(int) * kClasses * kMapWords));
}

// Launches on `stream` without synchronising; the maps must have been set
// on this device. Returns the CUDA error of the launch (0 on success) or
// cudaErrorInvalidValue for arguments the kernel does not take. The caller
// owns every buffer; reg, w and out are 16-byte aligned.
int up_conv_bf16(const void* reg, const void* w, const void* mask, void* out,
                 int64_t nb, int cin, int cout, void* stream) {
  if (cin <= 0 || cin % kKC != 0 || cout <= 0 || cout % 32 != 0 || nb < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout % 64 == 0) return launch<64>(reg, w, mask, out, nb, cin, cout, s);
  return launch<32>(reg, w, mask, out, nb, cin, cout, s);
}

}  // extern "C"
