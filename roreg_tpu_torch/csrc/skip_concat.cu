// Skip concatenation of the block decoder for NVIDIA Hopper (sm_90a).
//
//   out[r, :] = bf16([a[r, :], b[r, :]])
//
// a (R, Ca) f32, b (R, Cb) f32, out (R, Ca + Cb) bf16, round to nearest
// even (the rounding of torch's and JAX's f32 -> bf16 casts). Ca and Cb are
// multiples of 8.
//
// Replaces the TPU kernel scripts/experiment_pallas_primitives.py p5
// (Pallas body p5_kernel, line 173): the lane concatenation of two
// (T * 64, C) halves into (T * 64, 2C). On the block engine it is the
// concatenation of the decoder's upsampled features with the encoder's
// skip features ahead of conv3_tr and conv2_tr
// (roreg_tpu/sparse/block.py:662, 670), whose consumer conv_up casts its
// input to bf16 first; writing the bf16 concatenation computes the same
// function in one pass.
//
// What bounds it on an H100 (3.35 TB/s HBM): bytes. It does no arithmetic
// but the casts; it reads both f32 inputs once and writes the bf16 output
// once: 6 bytes per output element.
//
// Design: one thread per 16-byte vector of the output (8 bf16), so
// consecutive threads write consecutive addresses; each thread reads the 8
// f32 (two 16-byte loads) of one input row that the vector covers. A
// vector never straddles the two halves, since Ca is a multiple of 8. No
// shared memory, no synchronisation; a grid-stride loop bounds the grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kThreads)
skip_concat_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                   uint4* __restrict__ out, int64_t rows, int va, int vb) {
  // va, vb: 8-element vectors per row of a and b
  const int vrow = va + vb;
  const int64_t total = rows * vrow;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       t < total; t += step) {
    const int64_t r = t / vrow;
    const int v = static_cast<int>(t - r * vrow);
    const float4* src = v < va ? a + (r * va + v) * 2 : b + (r * vb + v - va) * 2;
    const float4 x = __ldg(src);
    const float4 y = __ldg(src + 1);
    out[t] = make_uint4(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w),
                        pack_bf16x2(y.x, y.y), pack_bf16x2(y.z, y.w));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising. Returns cudaGetLastError()
// (0 on success) or cudaErrorInvalidValue for arguments the kernel does not
// take. The caller owns every buffer; a, b and out are 16-byte aligned.
int skip_concat_bf16(const void* a, const void* b, void* out, int64_t rows,
                     int ca, int cb, void* stream) {
  if (rows < 0 || ca <= 0 || cb <= 0 || ca % 8 != 0 || cb % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return 0;
  const int64_t total = rows * ((ca + cb) / 8);
  const int64_t want = (total + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  skip_concat_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<uint4*>(out), rows, ca / 8, cb / 8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
