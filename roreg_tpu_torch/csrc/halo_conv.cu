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
// tbl (B, 27) int32, w (27, Cin, Cout) bf16, cell_mask (B, 64) uint8,
// out (B, 64, Cout) f32. Cin a multiple of 16, Cout of 32. A table entry
// of an occupied output block that is >= Nsrc traps (__trap(): the launch's
// next synchronisation raises a CUDA error and the context is unusable), as
// an out-of-range index raises in the plain version. A device-side assert
// in its place made the kernel slower by about a tenth.
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
// kernels/halo_conv.py halo_work). The kernel itself multiplies all 64
// cells of an occupied block by all 27 taps, masked rows included.
//
// Design: one thread block (4 warps) owns one output block and a 32- or
// 64-column slice of Cout. It reads the block's 64 mask bytes first; a
// block with no occupied cell (capacity padding) writes its zeros and
// leaves. Otherwise it resolves its SPAN^3 halo cells to source rows once
// (27 table entries, one shared-memory array), then for each 16-channel
// step gathers the halo's 16 channels into shared memory with 16-byte loads
// (zeros for absent neighbours) together with those 16 rows of all 27
// w[tap] slices, and runs the 27 taps as 16-row x 16-deep x 8-column bf16
// tensor-core products (mma.sync m16n8k16, f32 accumulators in registers).
// Each warp owns 16 output cells (one x-slab of the 4x4x4 block); the A
// operand of a tap is 16 scattered halo rows, which ldmatrix reads directly
// from shared memory by per-lane row addresses, so no im2col copy is made.
// The halo is gathered once per block, not once per (row, tap) as the
// gather-conv kernel does. Dynamic shared memory (about 100 KB at SPAN 9)
// is requested above the 48 KB default. This is the simple kernel that is
// right; cp.async pipelining, several output blocks per thread block and
// wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCells = 64;
constexpr int kTaps = 27;
constexpr int kThreads = 128;  // 4 warps x 16 output cells
constexpr int kKC = 16;        // input channels per step
constexpr int kLDH = kKC + 8;  // halo row pitch in bf16: 48 bytes

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

template <int SPAN, int BN>
constexpr int smem_bytes() {
  return SPAN * SPAN * SPAN * kLDH * 2 + kTaps * kKC * (BN + 8) * 2 +
         SPAN * SPAN * SPAN * 4;
}

template <int SPAN, int STRIDE, int BN>
__global__ void __launch_bounds__(kThreads)
halo_conv_kernel(const __nv_bfloat16* __restrict__ feats,
                 const int32_t* __restrict__ tbl,
                 const __nv_bfloat16* __restrict__ w,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int64_t nsrc, int cin, int cout) {
  constexpr int kSpan3 = SPAN * SPAN * SPAN;
  constexpr int kLDW = BN + 8;  // weight row pitch in bf16
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* halo_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w_s = halo_s + kSpan3 * kLDH;
  int* row_s = reinterpret_cast<int*>(w_s + kTaps * kKC * kLDW);
  __shared__ int nbr_s[kTaps];
  __shared__ int occupied_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  float* out_b = out + b * kCells * cout + n0;

  if (tid == 0) occupied_s = 0;
  __syncthreads();
  if (tid < kCells && mask[b * kCells + tid]) occupied_s = 1;
  __syncthreads();
  if (!occupied_s) {  // capacity padding: zeros, no gather, no products
    for (int e = tid; e < kCells * (BN / 4); e += kThreads) {
      const int r = e / (BN / 4);
      const int c = (e % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(out_b + r * cout + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  if (tid < kTaps) {
    const int s = tbl[b * kTaps + tid];
    if (s >= nsrc) __trap();
    nbr_s[tid] = s >= 0 ? s : -1;
  }
  __syncthreads();
  // halo position -> source row (block * 64 + cell), -1 where absent
  for (int p = tid; p < kSpan3; p += kThreads) {
    const int ax = p / (SPAN * SPAN) - 1;
    const int ay = (p / SPAN) % SPAN - 1;
    const int az = p % SPAN - 1;
    // floor division by 4 of a unit in [-1, 4 * STRIDE - 1]
    const int dx = (ax + 4) / 4 - 1, dy = (ay + 4) / 4 - 1, dz = (az + 4) / 4 - 1;
    const int blk = nbr_s[(dx + 1) * 9 + (dy + 1) * 3 + (dz + 1)];
    const int cell = (ax - 4 * dx) * 16 + (ay - 4 * dy) * 4 + (az - 4 * dz);
    row_s[p] = blk < 0 ? -1 : blk * kCells + cell;
  }

  // this lane's A row: output cell warp*16 + r, r = uy*4 + uz, ux = warp;
  // its halo position for tap (ox, oy, oz) is a_base + ox*SPAN^2 + oy*SPAN + oz
  const int r = lane & 15;
  const int half = lane >> 4;  // which 8 of the 16 channels (A) or columns (B)
  const int a_base = STRIDE * (warp * SPAN * SPAN + (r >> 2) * SPAN + (r & 3));

  float acc[BN / 8][4];
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
    acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
  }

  for (int c0 = 0; c0 < cin; c0 += kKC) {
    __syncthreads();  // row_s ready; the previous step's reads are done
    for (int e = tid; e < kSpan3 * 2; e += kThreads) {
      const int p = e >> 1;
      const int part = e & 1;
      const int src = row_s[p];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (src >= 0) {
        v = __ldg(reinterpret_cast<const uint4*>(
            feats + static_cast<int64_t>(src) * cin + c0 + part * 8));
      }
      *reinterpret_cast<uint4*>(halo_s + p * kLDH + part * 8) = v;
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
#pragma unroll 3
    for (int tap = 0; tap < kTaps; ++tap) {
      const int ox = tap / 9, oy = (tap / 3) % 3, oz = tap % 3;
      const int hrow = a_base + ox * SPAN * SPAN + oy * SPAN + oz;
      uint32_t a0, a1, a2, a3;
      ldmatrix_x4(smem_addr(halo_s + hrow * kLDH + half * 8), a0, a1, a2, a3);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(
            smem_addr(w_s + (tap * kKC + r) * kLDW + j * 16 + half * 8), b0,
            b1, b2, b3);
        mma_bf16(acc[2 * j], a0, a1, a2, a3, b0, b1);
        mma_bf16(acc[2 * j + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

  // accumulator layout (m16n8): rows lane/4 and lane/4 + 8, columns
  // 2*(lane%4) and +1 of each 8-column tile
  const int cell_a = warp * 16 + (lane >> 2);
  const int cell_b = cell_a + 8;
  const bool keep_a = mask[b * kCells + cell_a] != 0;
  const bool keep_b = mask[b * kCells + cell_b] != 0;
#pragma unroll
  for (int t = 0; t < BN / 8; ++t) {
    const int col = t * 8 + (lane & 3) * 2;
    *reinterpret_cast<float2*>(out_b + cell_a * cout + col) =
        keep_a ? make_float2(acc[t][0], acc[t][1]) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(out_b + cell_b * cout + col) =
        keep_b ? make_float2(acc[t][2], acc[t][3]) : make_float2(0.f, 0.f);
  }
}

template <int SPAN, int STRIDE, int BN>
int launch(const void* feats, const void* tbl, const void* w, const void* mask,
           void* out, int64_t nb, int64_t nsrc, int cin, int cout,
           cudaStream_t stream) {
  auto kernel = halo_conv_kernel<SPAN, STRIDE, BN>;
  constexpr int bytes = smem_bytes<SPAN, BN>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(nb), cout / BN), kThreads, bytes,
           stream>>>(static_cast<const __nv_bfloat16*>(feats),
                     static_cast<const int32_t*>(tbl),
                     static_cast<const __nv_bfloat16*>(w),
                     static_cast<const uint8_t*>(mask),
                     static_cast<float*>(out), nsrc, cin, cout);
  return static_cast<int>(cudaGetLastError());
}

template <int SPAN, int STRIDE>
int launch_bn(const void* feats, const void* tbl, const void* w,
              const void* mask, void* out, int64_t nb, int64_t nsrc, int cin,
              int cout, cudaStream_t stream) {
  if (cout % 64 == 0) {
    return launch<SPAN, STRIDE, 64>(feats, tbl, w, mask, out, nb, nsrc, cin,
                                    cout, stream);
  }
  return launch<SPAN, STRIDE, 32>(feats, tbl, w, mask, out, nb, nsrc, cin,
                                  cout, stream);
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. span/stride is 6/1 (same
// level) or 9/2 (down). Returns the CUDA error of the launch (0 on
// success) or cudaErrorInvalidValue for arguments the kernel does not take.
// The caller owns every buffer; feats, w and out are 16-byte aligned.
int halo_conv_bf16(const void* feats, const void* tbl, const void* w,
                   const void* mask, void* out, int64_t nb, int64_t nsrc,
                   int cin, int cout, int span, int stride, void* stream) {
  const bool geometry = (span == 6 && stride == 1) || (span == 9 && stride == 2);
  if (!geometry || cin % kKC != 0 || cin <= 0 || cout % 32 != 0 || cout <= 0 ||
      nb < 0 || nsrc < 0 || nb > 0x7fffffff || nsrc * kCells > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 1) {
    return launch_bn<6, 1>(feats, tbl, w, mask, out, nb, nsrc, cin, cout, s);
  }
  return launch_bn<9, 2>(feats, tbl, w, mask, out, nb, nsrc, cin, cout, s);
}

}  // extern "C"
