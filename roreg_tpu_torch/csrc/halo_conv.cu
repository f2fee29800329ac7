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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kCells = 64;
constexpr int kTaps = 27;
constexpr int kKC = 16;        // input channels per chunk: one wgmma K step
constexpr int kLDH = kKC + 8;  // halo row pitch in bf16: 48 bytes
constexpr int kWG = 128;       // threads of a warpgroup

constexpr int kBPC = 2;  // output blocks (consumer warpgroups) per thread block: a pair

template <int SPAN, int COUT>
struct Layout {
  // output blocks per consumer warpgroup: two where their accumulators and
  // halos fit
  static constexpr int kBPW = SPAN == 6 && COUT <= 64 ? 2 : 1;
  static constexpr int kBlocks = kBPC * kBPW;  // output blocks per thread block
  static constexpr int kSpan3 = SPAN * SPAN * SPAN;
  static constexpr int kThreads = kWG * kBPC + 32;
  static constexpr int kStageBytes = COUT * kKC * 2;
  // weight ring: 48 KB, or 32 KB beside the halos of two blocks a warpgroup
  static constexpr int kRingBytes = kBPW == 2 ? 32768 : 49152;
  static constexpr int kStages = kRingBytes / kStageBytes < 16 ? kRingBytes / kStageBytes : 16;
  static constexpr int kHaloBytes = kSpan3 * kLDH * 2;  // one chunk of one block
  // shared memory: weight ring | halo [kBlocks][2] | halo rows [kBlocks] | barriers
  static constexpr int kHaloOff = kStages * kStageBytes;
  static constexpr int kRowOff = kHaloOff + kBlocks * 2 * kHaloBytes;
  static constexpr int kBarOff = (kRowOff + kBlocks * kSpan3 * 4 + 7) / 8 * 8;
  static constexpr int kBytes = kBarOff + 2 * kStages * 8;
  static_assert(kBytes <= 232448, "shared memory of one thread block");
};

template <int SPAN, int STRIDE, int COUT>
__global__ void __launch_bounds__(Layout<SPAN, COUT>::kThreads, 1)
halo_conv_kernel(const __nv_bfloat16* __restrict__ feats,
                 const int32_t* __restrict__ tbl,
                 const __nv_bfloat16* __restrict__ wp,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int64_t nb, int64_t nsrc, int cin) {
  using L = Layout<SPAN, COUT>;
  constexpr int kSpan3 = L::kSpan3;
  constexpr int kBPW = L::kBPW;
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

  if (g == kBPC) {  // producer: one thread streams the weight stages
    if (!any_live || tid % 32 != 0) return;
    for (int s = 0; s < steps; ++s) {
      const int slot = s % L::kStages;
      const int round = s / L::kStages;
      if (round > 0) mbar_wait(empty0 + 8 * slot, (round - 1) & 1);
      mbar_arrive_expect_tx(full0 + 8 * slot, L::kStageBytes);
      bulk_copy(smem_addr(smem + slot * L::kStageBytes),
                wp + static_cast<int64_t>(s) * (L::kStageBytes / 2), L::kStageBytes,
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

  // halo buffers of this warpgroup: [chunk parity][block]
  __nv_bfloat16* halo_s =
      reinterpret_cast<__nv_bfloat16*>(smem + L::kHaloOff) + g * kBPW * 2 * kSpan3 * kLDH;
  auto load_halo = [&](int chunk) {
    __nv_bfloat16* dst = halo_s + (chunk & 1) * kBPW * kSpan3 * kLDH;
    for (int e = t; e < kBPW * kSpan3 * 2; e += kWG) {
      const int p = e >> 1;  // block * kSpan3 + halo position
      const int part = e & 1;
      const int src = row_s[p];
      const __nv_bfloat16* from =
          src >= 0 ? feats + static_cast<int64_t>(src) * cin + chunk * kKC + part * 8 : feats;
      cp_async_16(smem_addr(dst + p * kLDH + part * 8), from, src >= 0 ? 16 : 0);
    }
    cp_async_commit();
  };

  // this lane's A row: output cell warp*16 + r, r = uy*4 + uz, ux = warp;
  // its halo position for tap (ox, oy, oz) is a_base + ox*SPAN^2 + oy*SPAN + oz
  const int warp = t / 32;
  const int lane = t % 32;
  const int r = lane & 15;
  const int half = lane >> 4;  // which 8 of the 16 channels
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
    if (c + 1 < chunks) {  // the next chunk's halo loads while this one's taps run
      load_halo(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    named_barrier(bar_id, kWG);  // chunk c's halo is in shared memory
    const uint32_t a_addr =
        smem_addr(halo_s + (c & 1) * kBPW * kSpan3 * kLDH + a_base * kLDH + half * 8);
    uint32_t a[2][kBPW][4];
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int s = c * kTaps + tap;
      const int slot = s % L::kStages;
      const int off = ((tap / 9) * SPAN * SPAN + ((tap / 3) % 3) * SPAN + tap % 3) * kLDH * 2;
#pragma unroll
      for (int i = 0; i < kBPW; ++i) {
        ldmatrix_x4(a_addr + i * kSpan3 * kLDH * 2 + off, a[tap & 1][i]);
      }
      mbar_wait(full0 + 8 * slot, (s / L::kStages) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      wgmma_fence();
      const uint32_t stage = smem_addr(smem + slot * L::kStageBytes);
#pragma unroll
      for (int i = 0; i < kBPW; ++i) wgmma_tile<COUT>(acc[i], a[tap & 1][i], stage);
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

template <int SPAN, int STRIDE, int COUT>
int launch(const void* feats, const void* tbl, const void* wp, const void* mask, void* out,
           int64_t nb, int64_t nsrc, int cin, cudaStream_t stream) {
  using L = Layout<SPAN, COUT>;
  auto kernel = halo_conv_kernel<SPAN, STRIDE, COUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((nb + L::kBlocks - 1) / L::kBlocks);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(feats), static_cast<const int32_t*>(tbl),
      static_cast<const __nv_bfloat16*>(wp), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), nb, nsrc, cin);
  return static_cast<int>(cudaGetLastError());
}

template <int SPAN, int STRIDE>
int launch_cout(const void* feats, const void* tbl, const void* wp, const void* mask, void* out,
                int64_t nb, int64_t nsrc, int cin, int cout, cudaStream_t stream) {
  switch (cout) {
    case 32: return launch<SPAN, STRIDE, 32>(feats, tbl, wp, mask, out, nb, nsrc, cin, stream);
    case 64: return launch<SPAN, STRIDE, 64>(feats, tbl, wp, mask, out, nb, nsrc, cin, stream);
    case 128: return launch<SPAN, STRIDE, 128>(feats, tbl, wp, mask, out, nb, nsrc, cin, stream);
    default: return launch<SPAN, STRIDE, 256>(feats, tbl, wp, mask, out, nb, nsrc, cin, stream);
  }
}

template <int SPAN, int COUT>
void shape_of(int* bpc, int* stages) {
  *bpc = Layout<SPAN, COUT>::kBlocks;
  *stages = Layout<SPAN, COUT>::kStages;
}

template <int SPAN>
void shape_of_cout(int cout, int* bpc, int* stages) {
  switch (cout) {
    case 32: return shape_of<SPAN, 32>(bpc, stages);
    case 64: return shape_of<SPAN, 64>(bpc, stages);
    case 128: return shape_of<SPAN, 128>(bpc, stages);
    default: return shape_of<SPAN, 256>(bpc, stages);
  }
}

bool takes(int span, int stride, int cin, int cout) {
  const bool geometry = (span == 6 && stride == 1) || (span == 9 && stride == 2);
  return geometry && cin > 0 && cin % kKC == 0 &&
         (cout == 32 || cout == 64 || cout == 128 || cout == 256);
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
  if (!takes(span, stride, cin, cout) || nb < 0 || nsrc < 0 || nb > 0x7fffffff ||
      nsrc * kCells > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 1) return launch_cout<6, 1>(feats, tbl, wp, mask, out, nb, nsrc, cin, cout, s);
  return launch_cout<9, 2>(feats, tbl, wp, mask, out, nb, nsrc, cin, cout, s);
}

// The launch shape for a call: output blocks per thread block and weight
// stages in the ring. Returns cudaErrorInvalidValue for arguments the
// kernel does not take.
int halo_conv_launch_shape(int span, int stride, int cin, int cout, int* bpc, int* stages) {
  if (!takes(span, stride, cin, cout)) return static_cast<int>(cudaErrorInvalidValue);
  if (span == 6) {
    shape_of_cout<6>(cout, bpc, stages);
  } else {
    shape_of_cout<9>(cout, bpc, stages);
  }
  return 0;
}

}  // extern "C"
