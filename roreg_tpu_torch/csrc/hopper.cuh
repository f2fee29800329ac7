// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels:
// shared-memory addresses and named barriers, mbarriers, the bulk-copy
// engine, 16-byte cp.async, ldmatrix (plain and transposed), vector f32
// reductions in global memory, the split of f32 values into two or three
// bf16 terms, and wgmma.mma_async (bf16 in, f32 accumulators in registers) with
// A from registers or from a shared-memory descriptor and B from a
// shared-memory descriptor.
//
// Operand layout in shared memory (wgmma's K-major layout without swizzle):
// 8x8 core matrices of 128 contiguous bytes (8 rows of 16 bytes, 8 bf16
// along K each); a descriptor names the byte distance between core
// matrices adjacent in K (leading byte offset) and adjacent in M or N
// (stride byte offset).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

// a compile-time int as a value, for dispatching a runtime width to a
// kernel template through a generic lambda
template <int N>
struct Int {
  static constexpr int value = N;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// bytes global -> shared by the bulk-copy engine, completion counted on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
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

// 16 zero bytes to shared memory
__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(0) : "memory");
}

// orders this thread's generic-proxy view of shared memory (cp.async and
// st.shared writes) with the async proxy (wgmma operand reads, bulk copies)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// the transposed load: lane t receives, of each 8x8 matrix whose 8 rows of
// 16 bytes lanes 8i..8i+7 name, the elements (row 2 (t % 4) + e, column
// t / 4) for e = 0, 1, e = 0 in the low half
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// dst[0] += a, dst[1] += b in global memory as one vector reduction
// (sm_90); dst is 8-byte aligned
__device__ __forceinline__ void red_add_v2(float* dst, float a, float b) {
  atomicAdd(reinterpret_cast<float2*>(dst), make_float2(a, b));
}

// v = hi + mid + lo + r with |r| <= 2^-24 |v|: three bf16 terms, each the
// rounding of what the ones before leave (the differences are exact in
// f32), so products with a bf16 operand summed in f32 carry f32's precision
__device__ __forceinline__ void split_bf16x3(float v, uint32_t (&t)[3]) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(hi);
  const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
  const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
  t[0] = __bfloat16_as_ushort(hi);
  t[1] = __bfloat16_as_ushort(mid);
  t[2] = __bfloat16_as_ushort(lo);
}

// 8 f32 values -> their three bf16 terms, 8 to a 16-byte word each (value
// i in the i-th bf16 of the word)
__device__ __forceinline__ void split8_bf16x3(const float (&v)[8], uint4 (&out)[3]) {
  uint32_t w[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t a[3], b[3];
    split_bf16x3(v[2 * i], a);
    split_bf16x3(v[2 * i + 1], b);
#pragma unroll
    for (int t = 0; t < 3; ++t) w[t][i] = a[t] | (b[t] << 16);
  }
#pragma unroll
  for (int t = 0; t < 3; ++t) out[t] = make_uint4(w[t][0], w[t][1], w[t][2], w[t][3]);
}

// a, b -> their two bf16 terms as bf16x2 words (a in the low half): hi =
// bf16(v), lo = bf16(v - hi), the difference exact in f32, so hi + lo
// leaves about 2^-17 of v (kernels/split.py split_bf16x2)
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a);
  const __nv_bfloat16 hb = __float2bfloat16_rn(b);
  const __nv_bfloat16 la = __float2bfloat16_rn(a - __bfloat162float(ha));
  const __nv_bfloat16 lb = __float2bfloat16_rn(b - __bfloat162float(hb));
  hi = static_cast<uint32_t>(__bfloat16_as_ushort(ha)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(hb)) << 16);
  lo = static_cast<uint32_t>(__bfloat16_as_ushort(la)) |
       (static_cast<uint32_t>(__bfloat16_as_ushort(lb)) << 16);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// descriptor of a K-major, unswizzled operand tile at shared address addr:
// core matrices adjacent in K lbo bytes apart, adjacent in M or N sbo
// bytes apart (all in 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// a B stage of 16 rows (K) x N columns: element (k, n) at byte (n/8)*256 +
// (k/8)*128 + (n%8)*16 + (k%8)*2, the layout of the wrappers' pack_weights
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) { return smem_desc(addr, 128, 256); }

#define HOPPER_ACC16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define HOPPER_ACC32(d)                                                                      \
  HOPPER_ACC16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),        \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 32 f32) += a (64 x 16 bf16, registers) @ B (16 x 32 bf16, desc)
__device__ __forceinline__ void wgmma_n32(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64 f32) += a (64 x 16 bf16, registers) @ B (16 x 64 bf16, desc)
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 32 f32) += A (64 x 16 bf16, desc) @ B (16 x 32 bf16, desc)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC16(d)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, desc) @ B (16 x 64 bf16, desc)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t adesc, uint64_t bdesc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : HOPPER_ACC32(d)
      : "l"(adesc), "l"(bdesc), "r"(1));
}

#undef HOPPER_ACC32
#undef HOPPER_ACC16

// acc (64 x COUT) += a @ stage, with the B stage in b_desc's layout;
// accumulator element 4j + e of a thread is column 8j + 2 (lane % 4) + e % 2
// of row 16 warp + lane / 4 + 8 (e / 2)
template <int COUT>
__device__ __forceinline__ void wgmma_tile(float (&acc)[COUT / 2], const uint32_t (&a)[4],
                                           uint32_t stage) {
  if constexpr (COUT == 32) {
    wgmma_n32(acc, a, b_desc(stage));
  } else {
#pragma unroll
    for (int i = 0; i < COUT / 64; ++i) {
      wgmma_n64(acc + 32 * i, a, b_desc(stage + i * 8 * 256));  // 8 column groups on
    }
  }
}

// the same with A from a shared-memory descriptor
template <int COUT>
__device__ __forceinline__ void wgmma_tile_ss(float (&acc)[COUT / 2], uint64_t adesc,
                                              uint32_t stage) {
  if constexpr (COUT == 32) {
    wgmma_ss_n32(acc, adesc, b_desc(stage));
  } else {
#pragma unroll
    for (int i = 0; i < COUT / 64; ++i) {
      wgmma_ss_n64(acc + 32 * i, adesc, b_desc(stage + i * 8 * 256));
    }
  }
}

}  // namespace hopper
