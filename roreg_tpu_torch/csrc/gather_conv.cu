// Gather-GEMM sparse convolution for NVIDIA Hopper (sm_90a).
//
//   out[i, :] = sum_k feats[nbr[i, k], :] @ w[k]      (nbr[i, k] == -1 adds 0)
//
// feats (N, Cin) bf16, nbr (M, K) int32, w (K, Cin, Cout) bf16,
// out (M, Cout) f32. Cin and Cout are multiples of 32, K <= 32. An entry
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
// w once, and write the (M, Cout) f32 output. At full capacity with every
// entry valid, the 20 convs of one rotation would be about 147 GFLOP (about
// 18 ms per pair of 60-rotation clouds at the bf16 peak). On the main path
// they are not: the smoke's 20000-point cloud fills 11728/5230/1594/412 of
// the 32768/16384/8192/4096 rows per level, and the rest are padding rows
// whose table entries are all -1. At those counts, for one chunk of 10
// rotations (one launch per conv), every one of the 11 shapes is bound by
// bytes, at 16-40 us each, most of them the int32 table and the f32
// output, both sized to capacity; the operations take 1-9 us. The chunk's 20 convs are bound
// at about 0.44 ms. chip_smoke.py computes each shape's bound from the
// tables of its run (kernels/gather_conv.py conv_work).
//
// Design: one block owns a 64-row output tile and a 32- or 64-column slice
// of Cout. It loads its 64 x K indices once into shared memory (coalesced:
// the tile's table rows are contiguous) and marks the offsets no row of the
// tile uses, which it then skips (padding rows past the voxel count are all
// -1, so whole tiles of padding cost one index load). For each remaining
// offset and each 32-channel step it gathers the 64 source rows into shared
// memory with 16-byte loads (zeros for -1), loads the matching 32 x BN slice
// of w[k], and accumulates with bf16 WMMA (mma.sync) into f32 fragments held
// in registers across all offsets. The tile is written once, through shared
// memory, so ragged edges need no masking in the tensor-core store.
// This is the simple kernel that is right; cp.async pipelining, wgmma and
// TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kBM = 64;        // output rows per block (4 warps x 16)
constexpr int kBK = 32;        // input channels per step
constexpr int kMaxK = 32;      // largest kernel volume taken
constexpr int kThreads = 128;  // 4 warps
constexpr int kLDA = kBK + 8;  // bf16 row pitch of the gathered tile

template <int BN>
__global__ void __launch_bounds__(kThreads)
gather_conv_kernel(const __nv_bfloat16* __restrict__ feats,
                   const int32_t* __restrict__ nbr,
                   const __nv_bfloat16* __restrict__ w,
                   float* __restrict__ out, int64_t m, int64_t n, int cin,
                   int cout, int kvol) {
  constexpr int kLDB = BN + 8;
  constexpr int kLDC = BN + 4;
  __shared__ __align__(128) __nv_bfloat16 a_s[kBM * kLDA];
  __shared__ __align__(128) __nv_bfloat16 b_s[kBK * kLDB];
  __shared__ __align__(128) float c_s[kBM * kLDC];
  __shared__ int idx_s[kBM * kMaxK];
  __shared__ int used_s[kMaxK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  // The tile's index rows are contiguous in the table: read them coalesced.
  // A negative entry is absent; an entry >= n is an error.
  for (int e = tid; e < kBM * kvol; e += kThreads) {
    const int r = e / kvol;
    const int k = e - r * kvol;
    int src = -1;
    if (row0 + r < m) {
      src = nbr[row0 * kvol + e];
      if (src >= n) __trap();
      if (src < 0) src = -1;
    }
    idx_s[r * kMaxK + k] = src;
  }
  __syncthreads();
  if (tid < kvol) {
    int used = 0;
    for (int r = 0; r < kBM; ++r) used |= idx_s[r * kMaxK + tid] >= 0;
    used_s[tid] = used;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k = 0; k < kvol; ++k) {
    if (!used_s[k]) continue;  // uniform across the block
    const __nv_bfloat16* wk = w + static_cast<int64_t>(k) * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += kBK) {
      // gather: kBM rows x kBK channels, 8 bf16 (16 bytes) per load
      for (int e = tid; e < kBM * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8);
        const int part = e % (kBK / 8);
        const int src = idx_s[r * kMaxK + k];
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (src >= 0) {
          v = *reinterpret_cast<const uint4*>(
              feats + static_cast<int64_t>(src) * cin + c0 + part * 8);
        }
        *reinterpret_cast<uint4*>(a_s + r * kLDA + part * 8) = v;
      }
      // weights: kBK rows x BN columns of w[k]
      for (int e = tid; e < kBK * (BN / 8); e += kThreads) {
        const int r = e / (BN / 8);
        const int part = e % (BN / 8);
        *reinterpret_cast<uint4*>(b_s + r * kLDB + part * 8) =
            *reinterpret_cast<const uint4*>(
                wk + static_cast<int64_t>(c0 + r) * cout + n0 + part * 8);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, a_s + warp * 16 * kLDA + kk, kLDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              b;
          wmma::load_matrix_sync(b, b_s + kk * kLDB + j * 16, kLDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::store_matrix_sync(c_s + warp * 16 * kLDC + j * 16, acc[j], kLDC,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < kBM * BN; e += kThreads) {
    const int r = e / BN;
    const int c = e % BN;
    if (row0 + r < m) out[(row0 + r) * cout + n0 + c] = c_s[r * kLDC + c];
  }
}

void launch(const void* feats, const void* nbr, const void* w, void* out,
            int64_t m, int64_t n, int cin, int cout, int kvol,
            cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((m + kBM - 1) / kBM);
  const auto* f = static_cast<const __nv_bfloat16*>(feats);
  const auto* t = static_cast<const int32_t*>(nbr);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  auto* o = static_cast<float*>(out);
  if (cout % 64 == 0) {
    gather_conv_kernel<64><<<dim3(tiles, cout / 64), kThreads, 0, stream>>>(
        f, t, wb, o, m, n, cin, cout, kvol);
  } else {
    gather_conv_kernel<32><<<dim3(tiles, cout / 32), kThreads, 0, stream>>>(
        f, t, wb, o, m, n, cin, cout, kvol);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. Returns cudaGetLastError()
// (0 on success) or cudaErrorInvalidValue for arguments the kernel does not
// take. The caller owns every buffer.
int gather_conv_bf16(const void* feats, const void* nbr, const void* w,
                     void* out, int64_t m, int64_t n, int cin, int cout,
                     int kvol, void* stream) {
  if (cin % kBK != 0 || cout % 32 != 0 || kvol < 1 || kvol > kMaxK ||
      m < 0 || n < 0 || n > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  launch(feats, nbr, w, out, m, n, cin, cout, kvol, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
