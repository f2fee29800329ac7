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
// Any Cin and Cout from 1 to 256 and any K >= 1 (the forward takes Cin in
// multiples of 32, Cout 32..256 and K <= 32; its wrapper pads and splits).
// An entry >= N traps (__trap(): the launch's next synchronisation raises
// a CUDA error and the context is unusable), as the forward does.
//
// Replaces the gradient of the TPU kernel roreg_tpu/sparse/window_conv.py
// window_gather_conv. The JAX package trains through roreg_tpu/sparse/conv.py
// gather_conv, whose gradient XLA derives: the transpose of jnp.take (a
// scatter-add) for dx and the transposed dot for w. Under bf16 compute
// JAX's cotangents are bf16 and its scatter-add sums in bf16; both kernels
// here sum in f32 and the caller rounds once, to the operand's type.
//
// What bounds them on an H100 (67 TFLOP/s f32 FFMA, 3.35 TB/s HBM): each
// does 2*Cin*Cout operations per valid (row, offset) entry in f32 and must
// read dy (M x Cout f32), the table and w (dgrad) or the referenced rows of
// x (wgrad), and write dx (N x Cin f32) or dw (K x Cin x Cout f32).
// chip_smoke.py computes each shape's bound from the tables of its run
// (kernels/gather_conv.py bwd_work).
//
// Design: plain SIMT f32, no tensor cores; a simple kernel that is right.
// dgrad: a thread block owns a 64-row tile of dy and a 32-channel slice of
// dx. It stages the tile's dy rows in shared memory once, then walks the K
// offsets: it reads the tile's 64 indices of offset k, skips the offset when
// none is valid (the capacity padding's rows are all -1), stages w[k]'s
// slice (Cout x 32, as f32), and each of its 8 warps computes 8 rows' 32
// channels (one channel a lane, the dy values broadcast) and adds them to
// dx with f32 atomics: dgrad is run-to-run nondeterministic in the last
// bits (the order of the atomic adds). wgrad: a thread block owns one
// offset, a 64 x 32 (Cin x Cout) tile of dw and a range of rows; it stages
// 32 rows at a time (the gathered x rows as f32, zero for -1, and their dy
// rows), skipping a group whose 32 entries are all -1, and keeps 8 partial
// sums a thread in registers (one Cout column a lane, 8 Cin rows a warp);
// at the end it adds the tile to dw with f32 atomics, so wgrad is
// nondeterministic in the same way. The row ranges are sized so that a
// launch has about 2000 thread blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 256;

// dgrad tile: 64 dy rows x 32 dx channels
constexpr int kDRows = 64;
constexpr int kDCi = 32;
constexpr int kDRowsPerWarp = kDRows / kWarps;  // 8

// wgrad tile: 64 Cin x 32 Cout, rows staged 32 at a time
constexpr int kWCi = 64;
constexpr int kWCo = 32;
constexpr int kWRows = 32;
constexpr int kWCiPerWarp = kWCi / kWarps;  // 8

__host__ __device__ inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

inline size_t dgrad_smem(int cout) {
  return sizeof(float) * (static_cast<size_t>(kDRows) * cout + static_cast<size_t>(cout) * (kDCi + 1));
}

__global__ void __launch_bounds__(kThreads)
dgrad_kernel(const float* __restrict__ dy, const int32_t* __restrict__ nbr,
             const __nv_bfloat16* __restrict__ w, float* __restrict__ dx, int64_t m, int64_t n,
             int cin, int cout, int kvol) {
  extern __shared__ float smem[];
  float* dys = smem;                               // [kDRows][cout]
  float* ws = smem + static_cast<size_t>(kDRows) * cout;  // [cout][kDCi + 1]
  __shared__ int32_t idx[kDRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kDRows;
  const int ci0 = blockIdx.y * kDCi;
  const int ci = ci0 + lane;

  for (int e = tid; e < kDRows * cout; e += kThreads) {
    const int r = e / cout;
    const int64_t row = m0 + r;
    dys[e] = row < m ? dy[row * cout + (e - r * cout)] : 0.0f;
  }

  for (int k = 0; k < kvol; ++k) {
    int32_t v = -1;
    if (tid < kDRows && m0 + tid < m) {
      v = nbr[(m0 + tid) * kvol + k];
      if (v >= n) __trap();
    }
    __syncthreads();  // the previous offset's readers of idx and ws are done
    if (tid < kDRows) idx[tid] = v;
    if (!__syncthreads_or(v >= 0)) continue;
    for (int e = tid; e < kDCi * cout; e += kThreads) {
      const int c = e / cout;
      const int co = e - c * cout;
      const float val = ci0 + c < cin
          ? __bfloat162float(w[(static_cast<int64_t>(k) * cin + ci0 + c) * cout + co]) : 0.0f;
      ws[co * (kDCi + 1) + c] = val;
    }
    __syncthreads();
    float acc[kDRowsPerWarp];
#pragma unroll
    for (int j = 0; j < kDRowsPerWarp; ++j) acc[j] = 0.0f;
    for (int co = 0; co < cout; ++co) {
      const float wv = ws[co * (kDCi + 1) + lane];
#pragma unroll
      for (int j = 0; j < kDRowsPerWarp; ++j) {
        acc[j] = fmaf(dys[(warp + j * kWarps) * cout + co], wv, acc[j]);
      }
    }
    if (ci < cin) {
#pragma unroll
      for (int j = 0; j < kDRowsPerWarp; ++j) {
        const int32_t src = idx[warp + j * kWarps];
        if (src >= 0) atomicAdd(dx + static_cast<int64_t>(src) * cin + ci, acc[j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ nbr,
             const float* __restrict__ dy, float* __restrict__ dw, int64_t m, int64_t n, int cin,
             int cout, int kvol, int64_t rows_per_block) {
  __shared__ float xs[kWRows][kWCi];
  __shared__ float dys[kWRows][kWCo];
  __shared__ int32_t idx[kWRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = blockIdx.y;
  const int co_tiles = static_cast<int>(cdiv(cout, kWCo));
  const int ci0 = (blockIdx.z / co_tiles) * kWCi;
  const int co0 = (blockIdx.z % co_tiles) * kWCo;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r_end = r_begin + rows_per_block < m ? r_begin + rows_per_block : m;

  float acc[kWCiPerWarp];
#pragma unroll
  for (int j = 0; j < kWCiPerWarp; ++j) acc[j] = 0.0f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kWRows) {
    int32_t v = -1;
    if (tid < kWRows && r0 + tid < r_end) {
      v = nbr[(r0 + tid) * kvol + k];
      if (v >= n) __trap();
    }
    __syncthreads();  // the previous group's readers are done
    if (tid < kWRows) idx[tid] = v;
    if (!__syncthreads_or(v >= 0)) continue;
    for (int e = tid; e < kWRows * kWCi; e += kThreads) {
      const int r = e / kWCi;
      const int c = e - r * kWCi;
      const int32_t src = idx[r];
      xs[r][c] = src >= 0 && ci0 + c < cin
          ? __bfloat162float(x[static_cast<int64_t>(src) * cin + ci0 + c]) : 0.0f;
    }
    for (int e = tid; e < kWRows * kWCo; e += kThreads) {
      const int r = e / kWCo;
      const int c = e - r * kWCo;
      dys[r][c] = idx[r] >= 0 && co0 + c < cout ? dy[(r0 + r) * cout + co0 + c] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kWRows; ++r) {
      const float g = dys[r][lane];
#pragma unroll
      for (int j = 0; j < kWCiPerWarp; ++j) {
        acc[j] = fmaf(xs[r][warp * kWCiPerWarp + j], g, acc[j]);
      }
    }
  }
  const int co = co0 + lane;
  if (co < cout) {
#pragma unroll
    for (int j = 0; j < kWCiPerWarp; ++j) {
      const int ci = ci0 + warp * kWCiPerWarp + j;
      if (ci < cin) atomicAdd(dw + (static_cast<int64_t>(k) * cin + ci) * cout + co, acc[j]);
    }
  }
}

bool widths_ok(int64_t m, int64_t n, int cin, int cout, int kvol) {
  return m >= 0 && n >= 0 && n <= 0x7fffffff && cin >= 1 && cin <= kMaxC && cout >= 1 &&
         cout <= kMaxC && kvol >= 1 && kvol <= 65535;
}

// rows a wgrad thread block sums: about 2000 thread blocks a launch, at
// least one 32-row group each
int64_t wgrad_rows_per_block(int64_t m, int cin, int cout, int kvol) {
  const int64_t other = static_cast<int64_t>(kvol) * cdiv(cin, kWCi) * cdiv(cout, kWCo);
  int64_t blocks = cdiv(2048, other);
  const int64_t groups = cdiv(m, kWRows);
  if (blocks > groups) blocks = groups;
  if (blocks < 1) blocks = 1;
  return cdiv(groups, blocks) * kWRows;
}

}  // namespace

extern "C" {

// Both entries launch on `stream` without synchronising, zero their output
// first (an asynchronous memset), and return the CUDA error of the launch
// (0 on success) or cudaErrorInvalidValue for arguments they do not take.
// The caller owns every buffer.

int gather_conv_dgrad(const void* dy, const void* nbr, const void* w, void* dx, int64_t m,
                      int64_t n, int cin, int cout, int kvol, void* stream) {
  if (!widths_ok(m, n, cin, cout, kvol) || cdiv(m, kDRows) > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dx, 0, sizeof(float) * n * cin, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return 0;
  const size_t smem = dgrad_smem(cout);
  err = cudaFuncSetAttribute(dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(cdiv(m, kDRows)), static_cast<unsigned>(cdiv(cin, kDCi)));
  dgrad_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(dy), static_cast<const int32_t*>(nbr),
      static_cast<const __nv_bfloat16*>(w), static_cast<float*>(dx), m, n, cin, cout, kvol);
  return static_cast<int>(cudaGetLastError());
}

int gather_conv_wgrad(const void* x, const void* nbr, const void* dy, void* dw, int64_t m,
                      int64_t n, int cin, int cout, int kvol, void* stream) {
  if (!widths_ok(m, n, cin, cout, kvol)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(dw, 0, sizeof(float) * kvol * cin * cout, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  const int64_t rows = wgrad_rows_per_block(m, cin, cout, kvol);
  const dim3 grid(static_cast<unsigned>(cdiv(m, rows)), static_cast<unsigned>(kvol),
                  static_cast<unsigned>(cdiv(cin, kWCi) * cdiv(cout, kWCo)));
  wgrad_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(dy), static_cast<float*>(dw), m, n, cin, cout, kvol, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
