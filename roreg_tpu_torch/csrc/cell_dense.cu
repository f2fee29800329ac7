// Per-cell dense layer of the block decoder for NVIDIA Hopper (sm_90a).
//
//   out[r, :] = act(a[r, :] @ w[:Ca] + b[r, :] @ w[Ca:] + bias)
//
// a (R, Ca) f32, b (R, Cb) f32 or absent (Cb = 0), w (Ca + Cb, N) f32,
// given as weight = w^T (N, Ca + Cb) as torch.nn.Linear holds it, bias (N,)
// f32 or absent, act ReLU or the identity, out (R, N) f32. Ca and Cb are
// multiples of 16, N of 32.
// Products and sums are f32 (FFMA): the JAX package computes these layers as
// f32 nn.Dense, and so does the port.
//
// Replaces the TPU kernel scripts/experiment_pallas_primitives.py p1
// (Pallas body p1_kernel, line 68): the per-cell dense layer
// (T, 64, C) @ (C, Cout) with the 64 cells folded into M and f32
// accumulation. On the block engine it is conv1_tr (K 96 = 64 + 32, N 64,
// ReLU, no bias) and final (K 64, N 32, bias) at the end of the decoder
// (roreg_tpu/sparse/block.py:679-680), over every capacity cell. The two
// K-slices let conv1_tr read the decoder features and the level-0 skip
// features in place of their concatenation (block.py:678).
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s f32 FFMA): bytes.
// Per rotation chunk the rows are 30720 blocks x 64 cells = 1.97 M. conv1_tr
// reads 96 and writes 64 f32 a row (1.26 GB), final reads 64 and writes 32
// (0.76 GB): about 0.60 ms at the memory rate. The operations are
// 2 x 1.97 M x (96 x 64 + 64 x 32) = 32 GFLOP, about 0.48 ms at the f32
// rate. That is about 16 operations a byte, below the f32 ridge of about 20
// (67 TFLOP/s over 3.35 TB/s), so the layer is bound by bytes: bf16
// tensor-core operands would buy nothing and would move the numbers away
// from the JAX package's f32.
//
// Design: a tiled SIMT GEMM. One thread block (256 threads) owns 128 rows
// and a 32- or 64-column slice of N. For each 16-deep step of K (over the
// two slices in turn) it loads the 128 x 16 input tile with coalesced
// 16-byte loads into shared memory, transposed so a thread reads its rows'
// values as one 16-byte vector, together with the 16 x BN slice of w. Each
// thread accumulates a 4-row x (BN / 8)-column tile in registers. The
// epilogue adds the bias, applies the ReLU and writes each row's BN columns
// as 16-byte stores, so eight neighbouring threads write one row's
// contiguous slice. This is the simple kernel that is right; skipping the
// rows of capacity padding and pipelining the loads are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;        // rows per thread block (32 row groups x 4)
constexpr int kTM = 4;          // rows per thread
constexpr int kKC = 16;         // K per step
constexpr int kLDA = kBM + 4;   // f32 pitch of the transposed input tile

template <int BN>
__global__ void __launch_bounds__(kThreads)
cell_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ weight, const float* __restrict__ bias,
                  float* __restrict__ out, int64_t rows, int ca, int cb,
                  int n, int relu) {
  constexpr int kTN = BN / 8;  // columns per thread
  __shared__ __align__(16) float a_s[kKC * kLDA];
  __shared__ __align__(16) float w_s[kKC * BN];

  const int tid = threadIdx.x;
  const int tx = tid % 8;   // column group
  const int ty = tid / 8;   // row group
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;
  const int k = ca + cb;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int slice = 0; slice < 2; ++slice) {
    const float* src = slice == 0 ? a : b;
    const int width = slice == 0 ? ca : cb;
    const int wrow0 = slice == 0 ? 0 : ca;
    for (int k0 = 0; k0 < width; k0 += kKC) {
      __syncthreads();  // the previous step's reads are done
      // input tile: 128 rows x 16 columns, four 16-byte pieces a row
      for (int e = tid; e < kBM * (kKC / 4); e += kThreads) {
        const int r = e / (kKC / 4);
        const int part = e % (kKC / 4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < rows) {
          v = __ldg(reinterpret_cast<const float4*>(
              src + (row0 + r) * width + k0 + part * 4));
        }
        a_s[(part * 4 + 0) * kLDA + r] = v.x;
        a_s[(part * 4 + 1) * kLDA + r] = v.y;
        a_s[(part * 4 + 2) * kLDA + r] = v.z;
        a_s[(part * 4 + 3) * kLDA + r] = v.w;
      }
      // weights: 16 rows x BN columns of w, read from the (N, K) layout
      for (int e = tid; e < BN * (kKC / 4); e += kThreads) {
        const int c = e / (kKC / 4);
        const int part = e % (kKC / 4);
        const float4 v = __ldg(reinterpret_cast<const float4*>(
            weight + static_cast<int64_t>(n0 + c) * k + wrow0 + k0 + part * 4));
        w_s[(part * 4 + 0) * BN + c] = v.x;
        w_s[(part * 4 + 1) * BN + c] = v.y;
        w_s[(part * 4 + 2) * BN + c] = v.z;
        w_s[(part * 4 + 3) * BN + c] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kKC; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(a_s + kk * kLDA + ty * kTM);
        const float ar[kTM] = {av.x, av.y, av.z, av.w};
        float wr[kTN];
#pragma unroll
        for (int q = 0; q < kTN / 4; ++q) {
          const float4 wv = *reinterpret_cast<const float4*>(w_s + kk * BN + tx * kTN + q * 4);
          wr[q * 4 + 0] = wv.x;
          wr[q * 4 + 1] = wv.y;
          wr[q * 4 + 2] = wv.z;
          wr[q * 4 + 3] = wv.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(ar[i], wr[j], acc[i][j]);
        }
      }
    }
  }

  float bv[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) bv[j] = bias != nullptr ? bias[n0 + tx * kTN + j] : 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + ty * kTM + i;
    if (row >= rows) continue;
    float* o = out + row * n + n0 + tx * kTN;
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][q * 4 + j] + bv[q * 4 + j];
        if (relu) v[j] = fmaxf(v[j], 0.f);
      }
      *reinterpret_cast<float4*>(o + q * 4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. b and bias may be null (cb
// must then be 0). Returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue for arguments the kernel does not take. The caller
// owns every buffer; every pointer is 16-byte aligned.
int cell_dense_f32(const void* a, const void* b, const void* weight,
                   const void* bias, void* out, int64_t rows, int ca, int cb,
                   int n, int relu, void* stream) {
  if (rows < 0 || ca <= 0 || ca % kKC != 0 || cb < 0 || cb % kKC != 0 ||
      (cb > 0) != (b != nullptr) || n <= 0 || n % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const unsigned tiles = static_cast<unsigned>((rows + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* wf = static_cast<const float*>(weight);
  const auto* biasf = static_cast<const float*>(bias);
  auto* o = static_cast<float*>(out);
  if (n % 64 == 0) {
    cell_dense_kernel<64><<<dim3(tiles, n / 64), kThreads, 0, s>>>(
        af, bf, wf, biasf, o, rows, ca, cb, n, relu);
  } else {
    cell_dense_kernel<32><<<dim3(tiles, n / 32), kThreads, 0, s>>>(
        af, bf, wf, biasf, o, rows, ca, cb, n, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
