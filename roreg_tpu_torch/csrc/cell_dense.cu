// Per-cell dense layer of the block decoder for NVIDIA Hopper (sm_90a).
//
//   out[r, :] = row_mask[r] ? act(a[r, :] @ w[:Ca] + b[r, :] @ w[Ca:] + bias) : 0
//
// a (R, Ca) f32, b (R, Cb) f32 or absent (Cb = 0), w (Ca + Cb, N) f32,
// given as weight = w^T (N, Ca + Cb) as torch.nn.Linear holds it, bias (N,)
// f32 or absent, act ReLU or the identity, row_mask (R,) bytes or absent
// (every row kept), out (R, N) f32. Ca and Cb are multiples of 16, N is 32
// or 64. Products and sums are f32 (FFMA): the JAX package computes these
// layers as f32 nn.Dense, and so does the port.
//
// Replaces the TPU kernel scripts/experiment_pallas_primitives.py p1
// (Pallas body p1_kernel, line 68): the per-cell dense layer
// (T, 64, C) @ (C, Cout) with the 64 cells folded into M and f32
// accumulation. On the block engine it is conv1_tr (K 96 = 64 + 32, N 64,
// ReLU, no bias) and final (K 64, N 32, bias) at the end of the decoder
// (roreg_tpu/sparse/block.py:679-680). The JAX package masks the decoder's
// output at the end (block.py:684), so the port passes the level-0 cell
// mask here and the rows of unoccupied cells are zeros from the start: the
// backbone's output is the same, and only occupied rows are read and
// multiplied. The two K-slices let conv1_tr read the decoder features and
// the level-0 skip features in place of their concatenation (block.py:678).
//
// What bounds it on an H100 (3.35 TB/s HBM, 67 TFLOP/s f32 FFMA): bytes,
// and of those mostly the f32 output, which is written for every row. Per
// rotation chunk the rows are 30720 blocks x 64 cells = 1.97 M, and the two
// layers write (64 + 32) x 4 bytes a row: 0.76 GB, about 0.23 ms. They read
// (96 + 64) x 4 bytes and do 2 x (96 x 64 + 64 x 32) operations for each
// occupied row only (kernels/cell_dense.py dense_work).
//
// Design: a persistent grid (the SMs times the thread blocks that fit on
// one) of 64-thread blocks (two warps), each walking 32-row tiles with a
// grid stride. Small blocks let four of them share an SM (about 50 KB of
// shared memory each at K 96), so one block's waits overlap the others'
// work. The whole weight matrix (at most 96 x 64 f32) and the bias are
// loaded into shared memory once per thread block, transposed to (K, N).
// The mask bytes of a block's tiles come in windows of 8 tiles, the next
// window loading while this one's tiles are processed. A tile with no kept
// row writes its zeros with 16-byte stores and loads nothing. For a live
// tile, a warp ballot over its mask bytes lists the kept rows in order;
// only those rows come in, packed into the first slots of a stage of a
// two-stage cp.async ring (both K-slices, row-major, so each thread reads a
// row as 16-byte vectors), while the previous live tile is multiplied; the
// slots up to the next multiple of 8 are zero-filled with src-size 0, which
// reads nothing from device memory. Thread (ty, tx) accumulates slots
// ty + 8m (m < 4) x N / 8 columns in registers, and only the groups of 8
// slots that hold kept rows are multiplied (a template on their number, so
// no product of an empty group is issued). The epilogue adds the bias,
// applies the ReLU and writes each kept row's columns as 16-byte stores,
// eight neighbouring threads writing 128 contiguous bytes; the tile's
// masked rows get zeros.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;  // two warps: four thread blocks fit on an SM
constexpr int kGroup = kThreads / 8;  // slots per group: one per row group ty
constexpr int kTM = 4;                // slot groups (kept rows) per thread: ty + kGroup m
constexpr int kBM = kTM * kGroup;     // rows per tile
constexpr int kStages = 2;
constexpr int kWin = 8;   // tiles per window of mask bytes loaded ahead

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the keep bytes of rows row .. row + 15 (1 kept, 0 masked or past the
// end); a null mask keeps every row
__device__ __forceinline__ uint4 load16(const uint8_t* mask, int64_t row, int64_t rows) {
  if (row + 16 <= rows) {
    if (mask == nullptr) return make_uint4(0x01010101u, 0x01010101u, 0x01010101u, 0x01010101u);
    return __ldg(reinterpret_cast<const uint4*>(mask + row));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 16 && row + i < rows; ++i) {
    const uint32_t kept = mask == nullptr || mask[row + i] != 0;
    w[i / 4] |= kept << (8 * (i % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int BN>
size_t smem_bytes(int k) {
  return static_cast<size_t>(k * BN + BN + kStages * kBM * k) * sizeof(float);
}

// Slots ty + kGroup m, m < P, of a stage times the weights, with bias and
// activation, stored to their rows: P is the number of slot groups holding
// kept rows, a template parameter so that no product of an empty group is
// issued.
template <int BN, int P>
__device__ __forceinline__ void multiply_store(const float* xs, const float* w_s,
                                               const float* bias_s, const int* list, int n,
                                               float* out_tile, int k, int relu, int tx, int ty) {
  constexpr int kTN = BN / 8;  // columns per thread: tx * 4 + 32 * q + (0..3)
  float acc[P][kTN];
#pragma unroll
  for (int m = 0; m < P; ++m) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[m][j] = 0.f;
  }
  xs += ty * k;
#pragma unroll 2
  for (int kk = 0; kk < k; kk += 4) {
    float4 av[P];
#pragma unroll
    for (int m = 0; m < P; ++m) av[m] = *reinterpret_cast<const float4*>(xs + m * kGroup * k + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float wr[kTN];
#pragma unroll
      for (int q = 0; q < kTN / 4; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(w_s + (kk + u) * BN + q * 32 + tx * 4);
        wr[q * 4 + 0] = wv.x;
        wr[q * 4 + 1] = wv.y;
        wr[q * 4 + 2] = wv.z;
        wr[q * 4 + 3] = wv.w;
      }
#pragma unroll
      for (int m = 0; m < P; ++m) {
        const float am = u == 0 ? av[m].x : u == 1 ? av[m].y : u == 2 ? av[m].z : av[m].w;
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[m][j] = fmaf(am, wr[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const int slot = ty + kGroup * m;
    if (slot >= n) continue;
    float* o = out_tile + static_cast<int64_t>(list[slot]) * BN;
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q) {
      const int col = q * 32 + tx * 4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = acc[m][q * 4 + e] + bias_s[col + e];
        if (relu) v[e] = fmaxf(v[e], 0.f);
      }
      *reinterpret_cast<float4*>(o + col) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
cell_dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ weight, const float* __restrict__ bias,
                  const uint8_t* __restrict__ mask, float* __restrict__ out,
                  int64_t rows, int ca, int cb, int relu) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int list_s[kStages][kBM];              // slot -> row of the tile, kept rows in order
  __shared__ uint32_t bits_s[kStages][kBM / 32];    // kept rows of the tile
  __shared__ int count_s[kStages];                  // kept rows of the tile
  __shared__ __align__(16) uint8_t mask_s[2][kWin * kBM];  // windows of mask bytes
  const int k = ca + cb;
  float* w_s = smem;             // (K, BN)
  float* bias_s = w_s + k * BN;  // (BN,)
  float* x_s = bias_s + BN;      // kStages x (kBM slots, K)

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tx = tid % 8;  // column group
  const int ty = tid / 8;  // row group: slots ty + kGroup m of a tile
  const int64_t tiles = (rows + kBM - 1) / kBM;

  for (int e = tid; e < BN * k; e += kThreads) {
    const int n = e / k;
    const int kk = e - n * k;
    w_s[kk * BN + n] = weight[e];
  }
  if (tid < BN) bias_s[tid] = bias != nullptr ? bias[tid] : 0.f;

  // The mask bytes of this block's tiles blockIdx.x + q * gridDim.x come in
  // windows of kWin tiles (q / kWin): window win is in mask_s[win & 1],
  // window win + 1 is in flight in registers.
  const int64_t stride = gridDim.x;
  auto load_window = [&](int64_t window) -> uint4 {
    if (tid >= kWin * kBM / 16) return make_uint4(0u, 0u, 0u, 0u);
    const int64_t t = blockIdx.x + (window * kWin + tid / (kBM / 16)) * stride;
    return load16(mask, t * kBM + (tid % (kBM / 16)) * 16, rows);
  };
  int64_t win = 0;
  if (tid < kWin * kBM / 16) reinterpret_cast<uint4*>(mask_s[0])[tid] = load_window(0);
  uint4 ahead = load_window(1);
  __syncthreads();  // window 0, the weights and the bias are in shared memory
  auto to_window = [&](int64_t window) {  // make this window current
    while (win < window) {
      __syncthreads();
      if (tid < kWin * kBM / 16) reinterpret_cast<uint4*>(mask_s[(win + 1) & 1])[tid] = ahead;
      ahead = load_window(win + 2);
      __syncthreads();
      ++win;
    }
  };

  // The first live tile at or after t in this block's stride, its kept
  // rows listed in stage buf; the dead ones on the way get their zeros.
  auto next_live = [&](int64_t t, int buf) -> int64_t {
    for (; t < tiles; t += stride) {
      const int64_t row0 = t * kBM;
      const int64_t q = (t - blockIdx.x) / stride;
      to_window(q / kWin);
      const bool keep = tid < kBM && mask_s[win & 1][(q % kWin) * kBM + tid] != 0;
      if (tid < kBM) {
        const uint32_t bits = __ballot_sync(0xffffffffu, keep);
        if (lane == 0) bits_s[buf][warp] = bits;
      }
      if (__syncthreads_or(keep)) {
        if (keep) {
          int slot = __popc(bits_s[buf][warp] & ((1u << lane) - 1u));
          for (int w = 0; w < warp; ++w) slot += __popc(bits_s[buf][w]);
          list_s[buf][slot] = tid;
        }
        if (tid == 0) {
          int n = 0;
          for (int w = 0; w < kBM / 32; ++w) n += __popc(bits_s[buf][w]);
          count_s[buf] = n;
        }
        __syncthreads();
        return t;
      }
      const int64_t n_rows = rows - row0 < kBM ? rows - row0 : kBM;
      float4* o = reinterpret_cast<float4*>(out + row0 * BN);
      for (int64_t e = tid; e < n_rows * (BN / 4); e += kThreads) {
        o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return t;
  };

  // the kept rows of tile t into stage buf, packed into slots 0..n-1; the
  // slots up to the next multiple of kGroup are zero-filled (src-size 0)
  auto issue = [&](int64_t t, int buf) {
    const int64_t row0 = t * kBM;
    const int parts = k / 4;
    const int parts_a = ca / 4;
    const int n = count_s[buf];
    const int slots = (n + kGroup - 1) / kGroup * kGroup;
    float* dst = x_s + buf * kBM * k;
    for (int e = tid; e < slots * parts; e += kThreads) {
      const int i = e / parts;
      const int q = e - i * parts;
      const float* src = a;  // a valid address for the zero-fill
      if (i < n) {
        const int64_t row = row0 + list_s[buf][i];
        src = q < parts_a ? a + row * ca + q * 4 : b + row * cb + (q - parts_a) * 4;
      }
      cp_async_16(smem_addr(dst + i * k + q * 4), src, i < n ? 16 : 0);
    }
  };

  int stage = 0;
  int64_t t = next_live(blockIdx.x, stage);
  if (t < tiles) issue(t, stage);
  cp_async_commit();
  while (t < tiles) {
    const int64_t t_next = next_live(t + gridDim.x, stage ^ 1);
    if (t_next < tiles) issue(t_next, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int64_t row0 = t * kBM;
    const int n = count_s[stage];
    const float* xs = x_s + stage * kBM * k;
    float* out_tile = out + row0 * BN;
    switch ((n + kGroup - 1) / kGroup) {  // slot groups that hold kept rows
      case 1:
        multiply_store<BN, 1>(xs, w_s, bias_s, list_s[stage], n, out_tile, k, relu, tx, ty);
        break;
      case 2:
        multiply_store<BN, 2>(xs, w_s, bias_s, list_s[stage], n, out_tile, k, relu, tx, ty);
        break;
      case 3:
        multiply_store<BN, 3>(xs, w_s, bias_s, list_s[stage], n, out_tile, k, relu, tx, ty);
        break;
      default:
        multiply_store<BN, 4>(xs, w_s, bias_s, list_s[stage], n, out_tile, k, relu, tx, ty);
        break;
    }
    // zeros for the tile's masked rows
    const int64_t n_rows = rows - row0 < kBM ? rows - row0 : kBM;
    for (int64_t e = tid; e < n_rows * (BN / 4); e += kThreads) {
      const int r = static_cast<int>(e / (BN / 4));
      if (!((bits_s[stage][r / 32] >> (r % 32)) & 1u)) {
        reinterpret_cast<float4*>(out + row0 * BN)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncthreads();  // this stage's reads are done before it is refilled
    t = t_next;
    stage ^= 1;
  }
  cp_async_wait<0>();
}

template <int BN>
int launch(const float* a, const float* b, const float* w, const float* bias,
           const uint8_t* mask, float* out, int64_t rows, int ca, int cb, int relu,
           cudaStream_t stream) {
  auto kernel = cell_dense_kernel<BN>;
  const size_t bytes = smem_bytes<BN>(ca + cb);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const int64_t tiles = (rows + kBM - 1) / kBM;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = static_cast<unsigned>(tiles < slots ? tiles : slots);
  kernel<<<grid, kThreads, bytes, stream>>>(a, b, w, bias, mask, out, rows, ca, cb, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. b, bias and mask may be null
// (cb must be 0 where b is; a null mask keeps every row). Returns
// cudaGetLastError() (0 on success) or cudaErrorInvalidValue for arguments
// the kernel does not take. The caller owns every buffer; a, b, weight and
// out are 16-byte aligned.
int cell_dense_f32(const void* a, const void* b, const void* weight,
                   const void* bias, const void* mask, void* out, int64_t rows,
                   int ca, int cb, int n, int relu, void* stream) {
  if (rows < 0 || ca <= 0 || ca % 16 != 0 || cb < 0 || cb % 16 != 0 ||
      (cb > 0) != (b != nullptr) || (n != 32 && n != 64) ||
      smem_bytes<64>(ca + cb) > 232448) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* af = static_cast<const float*>(a);
  const auto* bf = static_cast<const float*>(b);
  const auto* wf = static_cast<const float*>(weight);
  const auto* biasf = static_cast<const float*>(bias);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<float*>(out);
  if (n == 64) return launch<64>(af, bf, wf, biasf, m, o, rows, ca, cb, relu, s);
  return launch<32>(af, bf, wf, biasf, m, o, rows, ca, cb, relu, s);
}

}  // extern "C"
