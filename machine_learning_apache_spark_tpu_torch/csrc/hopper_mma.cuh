// Building blocks shared by the attention kernels, sm_90a: the tensor-core
// products of flash_attention_fwd.cu and flash_attention_bwd.cu (dQ and
// dK/dV), and the cp.async helpers that ragged_paged_attention.cu uses too.
//
// - 3xTF32 products on mma.sync.m16n8k8: every fp32 operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi), and a product accumulates
//   lo*hi + hi*lo + hi*hi in fp32 (CUTLASS's OpMultiplyAddFastF32). The
//   dropped lo*lo term is ~2^-22 relative, so the result keeps fp32's
//   accuracy; one TF32 pass keeps ~3 decimal digits, which the port's 1e-4
//   kernel-vs-plain gates and its card-vs-CPU gradient gate do not admit.
// - The tensor core's fp32 accumulation does not round to nearest (it
//   truncates), so an accumulator carried through every k-step and every
//   pass drifts: on an H100 that left the kernels ~10x further from fp32
//   than an FMA loop, and the card-vs-CPU step-0 gradients at 4e-4. So
//   each k-step's three passes go into a fresh zero fragment, which is
//   then added to the running sum by an ordinary fp32 add.
// - cp.async copies into shared memory (16-byte .cg, 4-byte .ca), with a
//   zero fill when the source row lies outside the tensor.
//
// Fragment layouts of m16n8k8 (PTX ISA, "Matrix Fragments for mma.m16n8k8"
// with .tf32), with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k x n):       b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):             c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t)
//                           c3 (g + 8, 2t + 1)
// A C fragment becomes the A operand of the next product without a
// shuffle when the k index is permuted: k = t stands for column 2t and
// k = t + 4 for column 2t + 1 of the 8-wide tile, so (a0, a1, a2, a3) =
// (c0, c2, c1, c3), and the B operand's rows are read in the same order:
// b0 from row 2t, b1 from row 2t + 1. A sum over k does not depend on
// its order of terms, only on which terms pair up, so this is exact.
//
// bf16 products (the kernels' bf16 instantiations) run on
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands,
// exact products, a float32 accumulator. Each 32-bit register holds two
// bf16 values, the lower index in the low half. Fragment layouts (PTX ISA,
// "Matrix Fragments for mma.m16n8k16" with .bf16), g = lane / 4, t =
// lane % 4:
//   A (16 x 16, row-major): a0a1 (g, 2t..2t+1)  a2a3 (g + 8, 2t..2t+1)
//                           a4a5 (g, 2t+8..2t+9) a6a7 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n):      b0b1 (k 2t..2t+1, n g)  b2b3 (k 2t+8..2t+9, n g)
//   C (16 x 8):             as m16n8k8's above.
// So two neighbouring C fragments (n-tiles 2j and 2j + 1) are the A
// operand of a k16 step over their 16 columns with no shuffle: a0a1 =
// pack(c0, c1) and a2a3 = pack(c2, c3) of tile 2j, a4a5 and a6a7 the same
// of tile 2j + 1. Packing rounds to nearest even: that is where P (and
// dS) become bf16, as the reference rounds them before their products.
// - No fresh fragment per k-step at bf16: the accumulator's truncation
//   costs ~2^-23 relative per mma, a few dozen mma per output at these
//   sites, ~2^-18 in all, while the bf16 output itself rounds at 2^-9.
//   The fp32 kernels need the fresh fragment because their gates are
//   1e-4 of fp32 sums; the bf16 ones are bf16 ulps.
// - cp.async moves 16 bytes: 8 bf16 values where it moved 4 floats, so a
//   bf16 row stride is a multiple of 8 elements; shared rows pad by 8
//   bf16 (16 bytes), which keeps the stride at 4 mod 32 words and the
//   fragment loads free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace hopper {

constexpr unsigned kFull = 0xffffffffu;

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split_tf32(b0, f.hi[0], f.lo[0]);
  split_tf32(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32, the small terms first, summed in a fresh fragment
// and added to c in fp32 (round to nearest).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a,
                                           const FragB& b) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(p, a.lo, b.hi);
  mma_tf32(p, a.hi, b.lo);
  mma_tf32(p, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += p[i];
}

// Two floats as one bf16x2 register (x in the low half), rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring bf16 values as one register (p 4-byte aligned).
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 values of one column from rows p and p + stride (a B operand
// read along k from a row-major tile).
__device__ __forceinline__ uint32_t ld_bf16_col2(const __nv_bfloat16* p,
                                                 int stride) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return lo | (hi << 16);
}

// c += a * b on bf16 tensor cores, the accumulator in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A fragment of rows r (g) and r + 8 (g + 8), columns c0 .. c0 + 15,
// of a row-major bf16 tile: p points at (row g, column c0 + 2t).
__device__ __forceinline__ void frag_a_bf16(uint32_t (&a)[4],
                                            const __nv_bfloat16* p,
                                            int stride) {
  a[0] = ld_bf16x2(p);
  a[1] = ld_bf16x2(p + 8 * stride);
  a[2] = ld_bf16x2(p + 8);
  a[3] = ld_bf16x2(p + 8 * stride + 8);
}

// The A fragment of a k16 step from two accumulator fragments (n-tiles
// 2j and 2j + 1), rounded to bf16.
__device__ __forceinline__ void frag_a_from_c(uint32_t (&a)[4],
                                              const float (&c0)[4],
                                              const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// 16 bytes global -> shared, bypassing L1; zeros when !in (the source
// address must still be a valid one).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared (for per-row statistics and per-slot scales,
// which need not be 16-byte aligned); zero when !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Above 48 KB a block's dynamic shared memory must be asked for, once per
// kernel and device: a size already granted is not asked for again. So a
// launch recorded into a CUDA graph makes no attribute call while the graph
// is captured, as long as an eager run at the same size came first (the
// program cache's warm run).
inline cudaError_t allow_smem_bytes(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, size_t> granted;
  std::lock_guard<std::mutex> guard(lock);
  size_t& have = granted[{device, kernel}];
  if (bytes <= have) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) have = bytes;
  return err;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return allow_smem_bytes(reinterpret_cast<const void*>(kernel), bytes);
}

}  // namespace hopper
