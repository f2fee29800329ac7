// Whole-row block-table gather for NVIDIA Hopper (sm_90a).
//
//   out[b, j, :] = tbl[b, j] >= 0 ? src[tbl[b, j], :] : 0
//
// src (Nsrc, R) rows of row_bytes bytes (any element type; row_bytes a
// multiple of 16), tbl (B, 27) int32 with -1 for absent, out (B, 27, R).
// An entry >= Nsrc traps (__trap(): the launch's next synchronisation
// raises a CUDA error and the context is unusable), as an out-of-range
// index raises in the plain version.
//
// Replaces the TPU kernel scripts/experiment_pallas_gather.py gather_p
// (Pallas body `kernel`, line 38): a whole-block slab gather that starts
// one DMA per 16-row (64 * C)-lane slab through a scalar-prefetched flat
// table, 8 blocks per grid step. On the block engine it is the gather of
// conv1_occupancy (the neighbour blocks' 64 cell occupancies, R = 64) and
// of conv_up (the 27 coarse cells of the 3^3 region, R = Cin).
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. It does no arithmetic;
// it must read each referenced source row once, the table once, and write
// the whole (B, 27, R) output, including the zero rows of absent entries
// and of the capacity padding (most of B on the main path).
//
// Design: the copy is flattened to one thread per 16-byte vector of the
// output, so consecutive threads write consecutive addresses and read
// consecutive addresses of one source row: a warp covers one row of 512
// bytes (R = 256 bf16) or 4 rows of 128 bytes (R = 64 bf16), and every
// load and store is a full 16-byte access. The threads of one row read the
// same table entry, which the hardware serves as one broadcast load per
// warp. No shared memory, no synchronisation; a grid-stride loop bounds
// the grid.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_gather_kernel(const uint4* __restrict__ src, const int32_t* __restrict__ tbl,
                    uint4* __restrict__ out, int64_t entries, int64_t nsrc,
                    int vecs_per_row) {
  const int64_t total = entries * vecs_per_row;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += step) {
    const int64_t e = t / vecs_per_row;
    const int v = static_cast<int>(t - e * vecs_per_row);
    const int64_t s = tbl[e];
    if (s >= nsrc) __trap();
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s >= 0) val = __ldg(src + s * vecs_per_row + v);
    out[t] = val;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. Returns cudaGetLastError()
// (0 on success) or cudaErrorInvalidValue for arguments the kernel does not
// take. The caller owns every buffer; src and out are 16-byte aligned.
int block_gather(const void* src, const void* tbl, void* out, int64_t entries,
                 int64_t nsrc, int64_t row_bytes, void* stream) {
  if (row_bytes <= 0 || row_bytes % 16 != 0 || entries < 0 || nsrc < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (entries == 0) return 0;
  const int vecs = static_cast<int>(row_bytes / 16);
  const int64_t total = entries * vecs;
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sv = static_cast<const uint4*>(src);
  auto* ov = static_cast<uint4*>(out);
  block_gather_kernel<<<blocks, kThreads, 0, s>>>(
      sv, static_cast<const int32_t*>(tbl), ov, entries, nsrc, vecs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
