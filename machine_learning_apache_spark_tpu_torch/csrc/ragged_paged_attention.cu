// Ragged paged-attention decode step, for Hopper (sm_90a): fp32 queries
// over fp32 or int8 pages, and (the bf16 instantiations) bf16 queries over
// bf16 or int8 pages.
//
// Replaces machine_learning_apache_spark_tpu/ops/pallas_attention.py::
// _ragged_paged_kernel (launched from ragged_paged_attention_kernel). Same
// function: every request row r attends its one query vector over the
// first lengths[r] cached positions, gathered page by page through its
// block table from a shared page store [num_pages, page, H*dh] whose page
// 0 is the never-allocated null page. int8 stores carry one fp32 scale
// per slot ([num_pages, page], addressed through the same table) and are
// dequantised slot by slot before the dot products, the reference's
// order. An optional cur_k / cur_v [R, H*dh] (the step's own K/V, the
// causal diagonal) is folded in after the pages. A row with length 0 and
// no cur writes zeros.
//
// What bounds it on this card. Each cached position's K and V head slice
// is read once and used for 2*dh flops each: the kernel is bound by bytes,
// the K/V (and scale) bytes the rows' lengths need over 3.35 TB/s. At the
// serving slice's shapes (32 rows x 8 heads of 64, lengths up to 64,
// pages of 16) that is ~1.3 us of traffic spread over the whole card, so
// what a (row, head) costs is its chain of dependent steps: the table and
// length, one round trip for the K/V it needs, the arithmetic, the write.
// The design keeps that chain short: no reduction per position, no load
// that waits on another, and the positions of a long row split between
// warps.
//
// Why no tensor cores. One query per (row, head) is an M of 1: an m16n8k8
// tile would waste 15 of its 16 rows, and there is no rate to win, only
// latency.
//
// Design.
// - A block covers one (row, head) with `splits` warps (flash-decoding):
//   the row's positions go in chunks of 32, chunk c to split c % splits,
//   so a row of up to 32 * splits positions is one chunk per warp. The
//   wrapper picks the splits from the shapes
//   (ops/hopper_attention.ragged_launch_params).
// - The start is one round trip: the length and each lane's table entry
//   for its first position are loaded together, then the chunk's K and V
//   head slices go to shared memory by cp.async (16-byte pieces, 8 where an
//   int8 slice is not a multiple of 16; neighbouring lanes on neighbouring
//   addresses), with the int8 scales and the warp's q row beside them.
//   Positions past the length are zero-filled, never read. Where a warp
//   walks more than one chunk the next chunk is in flight while this one
//   computes (two stages), its table entries one chunk further ahead.
// - Scores without a reduction per position: lane j computes the whole
//   dot product of position j from its staged K row (fp32 rows at a
//   stride of dh + 4 floats, so the 32 lanes' float4 reads are free of
//   bank conflicts) and q broadcast from shared memory, in four
//   independent partial sums. A chunk then needs one warp max and one
//   warp sum for the online softmax (m, l), not one reduction per
//   position.
// - P.V: lane owns dh/32 adjacent columns (a float2 at dh <= 64, a float4
//   at dh <= 128) and walks the chunk's positions with two independent
//   accumulators (even and odd positions), p and the int8 V scales
//   broadcast from shared memory.
// - The splits merge their (m, l, acc) in shared memory, in split order,
//   into the first split's warp; cur_k/cur_v (loaded into
//   registers at the start) are folded in last, and the row is written.
//   No atomics: a result repeats bit for bit, and rows with the same
//   query, pages and length give the same bits.
// - bf16 (a bf16 model's decode): the query, cur and out are bf16, the
//   pages bf16 (staged at 2 * dh + 16 bytes a row, read 8 values at a
//   time) or int8. Every value is widened to float32 exactly and the math
//   is the fp32 kernel's, on the CUDA cores: the reference does its dots
//   with float32 accumulation and no rounding of P, and rounds the output
//   to the query's dtype once, as this kernel does.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

constexpr int kChunk = 32;  // positions per chunk: one per lane
constexpr int kMaxSplits = 4;
constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

// Shared memory, per warp (ops/hopper_attention.ragged_smem_bytes mirrors
// this): `stages` x [K rows kChunk x row_bytes | V rows | k scales | v
// scales | slots], then its q row (float32 whatever the query's dtype),
// the chunk's p and its merge state (m, l, acc[d]); every piece 16-byte
// aligned. A staged row is padded by 16 bytes: fp32 rows by 4 floats,
// bf16 rows by 8 bf16 (row strides of 4 mod 32 words), int8 rows to a
// multiple of 16 and 16 more. `elem` is the page element's size: 4
// (fp32), 2 (bf16) or 1 (int8).
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline int row_bytes(int d, int elem) {
  return elem == 1 ? round16(d) + 16 : elem * d + 16;
}

__host__ __device__ inline int stage_bytes(int d, int elem) {
  return 2 * kChunk * row_bytes(d, elem) + 3 * kChunk * 4;
}

__host__ __device__ inline int warp_bytes(int d, int elem, int stages) {
  return stages * stage_bytes(d, elem) + round16(4 * d) + 4 * kChunk +
         round16(4 * (d + 2));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 8 bytes global -> shared by cp.async, for int8 slices whose width is
// not a multiple of 16 (the 16- and 4-byte copies are hopper_mma.cuh's);
// zeros when !in, the source address then never read but a valid one.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(in ? 8 : 0) : "memory");
}

// Signed byte i of a little-endian word, as a float.
__device__ __forceinline__ float byte_at(int w, int i) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * i)) & 0xff));
}

// CPL adjacent floats from shared memory (CPL = 2 or 4).
template <int CPL>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[CPL]) {
  if constexpr (CPL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
}

// CPL adjacent int8 values, dequantised with the slot's scale.
template <int CPL>
__device__ __forceinline__ void load_cols(const int8_t* p, float s,
                                          float (&x)[CPL]) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) x[i] = static_cast<float>(p[i]) * s;
}

// CPL adjacent bf16 values as floats (exact).
template <int CPL>
__device__ __forceinline__ void load_cols(const bf16* p, float (&x)[CPL]) {
#pragma unroll
  for (int i = 0; i < CPL; i += 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    x[i] = v.x;
    x[i + 1] = v.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// T: the page element (float, int8_t or bf16); Q: the query's, cur's and
// out's (float, or bf16 for a bf16 model). The math is float32 whatever
// they are: a bf16 query and bf16 pages are widened exactly, int8 pages
// dequantised slot by slot, and the output rounded to Q once at the end
// (the reference takes P.V in float32 against the values, no rounding of
// P, and casts the output to the query's dtype).
template <typename T, typename Q, int CPL>
__global__ void __launch_bounds__(kMaxSplits * 32)
ragged_paged_kernel(const Q* __restrict__ q, long long q_row_stride,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_table, int pages_per_row,
                    const int* __restrict__ lengths,
                    const Q* __restrict__ cur_k,
                    const Q* __restrict__ cur_v, long long cur_row_stride,
                    Q* __restrict__ out, int heads, int head_dim,
                    int page_size, float scale, int splits, int stages) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kElem = sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = threadIdx.x >> 5;  // this warp's share of the row's chunks
  const int lane = threadIdx.x & 31;
  const int d = head_dim;
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int rb = row_bytes(d, kElem);
  const int sb = stage_bytes(d, kElem);
  const int wb = warp_bytes(d, kElem, stages);
  unsigned char* base = smem + sp * wb;
  float* q_s = reinterpret_cast<float*>(base + stages * sb);
  float* p_s = q_s + round16(4 * d) / 4;
  float* state_s = p_s + kChunk;
  const long long d_model = static_cast<long long>(heads) * d;
  const int cap = pages_per_row * page_size;  // positions the table covers
  const int* tbl = block_table + static_cast<long long>(r) * pages_per_row;
  const int c0 = lane * CPL;                  // this lane's P.V columns
  const bool col_live = c0 < d;

  // One round trip to begin with: the length, this lane's table entry for
  // its first position, the q row, and (first split) cur's columns.
  auto table_entry = [&](int chunk) {
    const int pos = chunk * kChunk + lane;
    return pos < cap ? tbl[pos / page_size] : 0;
  };
  const int len = lengths[r];
  int pg = table_entry(sp);
  const Q* qr = q + r * q_row_stride + static_cast<long long>(h) * d;
  if constexpr (std::is_same<Q, float>::value) {
    for (int c = 4 * lane; c < d; c += 4 * 32) hopper::cp_async16(q_s + c, qr + c, true);
  } else {  // widened into the float row; visible after the first __syncwarp
    for (int c = lane; c < d; c += 32) q_s[c] = to_float(qr[c]);
  }
  hopper::cp_async_commit();
  float ck[CPL] = {}, cv[CPL] = {};
  const bool with_cur = cur_k != nullptr && sp == 0;
  if (with_cur && col_live) {
    const long long off = r * cur_row_stride + static_cast<long long>(h) * d + c0;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      ck[i] = to_float(cur_k[off + i]);
      cv[i] = to_float(cur_v[off + i]);
    }
  }

  // Chunk `chunk` into stage `st`: slots, (int8) scales, K and V slices.
  auto issue = [&](int chunk, int st, int page) {
    unsigned char* k_s = base + st * sb;
    unsigned char* v_s = k_s + kChunk * rb;
    float* ks_s = reinterpret_cast<float*>(v_s + kChunk * rb);
    float* vs_s = ks_s + kChunk;
    int* slot_s = reinterpret_cast<int*>(vs_s + kChunk);
    const int pos = chunk * kChunk + lane;
    const int slot = pos < len ? page * page_size + pos % page_size : -1;
    slot_s[lane] = slot;
    if (kQuant) {
      const int sl = slot < 0 ? 0 : slot;
      hopper::cp_async4(ks_s + lane, k_scale + sl, slot >= 0);
      hopper::cp_async4(vs_s + lane, v_scale + sl, slot >= 0);
    }
    __syncwarp();
    const int piece = (kQuant && (d & 15)) ? 8 : 16;
    const int per_row = d * static_cast<int>(sizeof(T)) / piece;
    for (int i = lane; i < kChunk * per_row; i += 32) {
      const int j = i / per_row;
      const int off = (i - j * per_row) * piece;  // bytes into the slice
      const int s = slot_s[j];
      const long long e = (s < 0 ? 0 : static_cast<long long>(s) * d_model) +
                          static_cast<long long>(h) * d;
      const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(k_pages + e) + off;
      const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(v_pages + e) + off;
      if (piece == 16) {
        hopper::cp_async16(k_s + j * rb + off, ksrc, s >= 0);
        hopper::cp_async16(v_s + j * rb + off, vsrc, s >= 0);
      } else {
        cp_async8(k_s + j * rb + off, ksrc, s >= 0);
        cp_async8(v_s + j * rb + off, vsrc, s >= 0);
      }
    }
    hopper::cp_async_commit();
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

  // This warp's chunks: sp, sp + splits, ... below ceil(len / kChunk).
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const int n_mine = n_chunks > sp ? (n_chunks - 1 - sp) / splits + 1 : 0;
  if (n_mine > 0) issue(sp, 0, pg);
  if (n_mine > 1) pg = table_entry(sp + splits);

  for (int it = 0; it < n_mine; ++it) {
    const int chunk = sp + it * splits;
    const int st = stages == 2 ? (it & 1) : 0;
    if (stages == 2 && it + 1 < n_mine) {
      issue(chunk + splits, st ^ 1, pg);
      if (it + 2 < n_mine) pg = table_entry(chunk + 2 * splits);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of this chunk are in shared memory

    const unsigned char* k_s = base + st * sb;
    const unsigned char* v_s = k_s + kChunk * rb;
    const float* ks_s = reinterpret_cast<const float*>(v_s + kChunk * rb);
    const float* vs_s = ks_s + kChunk;
    const int n = min(kChunk, len - chunk * kChunk);  // warp-uniform, >= 1

    // Scores: lane j's whole dot product, four independent partial sums.
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kQuant) {
      const int8_t* kr = reinterpret_cast<const int8_t*>(k_s + lane * rb);
      const float ks = ks_s[lane];
      for (int c = 0; c < d; c += 8) {
        const int2 raw = *reinterpret_cast<const int2*>(kr + c);
        const float4 qa = *reinterpret_cast<const float4*>(q_s + c);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + c + 4);
        part[0] += qa.x * (byte_at(raw.x, 0) * ks);
        part[1] += qa.y * (byte_at(raw.x, 1) * ks);
        part[2] += qa.z * (byte_at(raw.x, 2) * ks);
        part[3] += qa.w * (byte_at(raw.x, 3) * ks);
        part[0] += qb.x * (byte_at(raw.y, 0) * ks);
        part[1] += qb.y * (byte_at(raw.y, 1) * ks);
        part[2] += qb.z * (byte_at(raw.y, 2) * ks);
        part[3] += qb.w * (byte_at(raw.y, 3) * ks);
      }
    } else if constexpr (std::is_same<T, bf16>::value) {
      const bf16* kr = reinterpret_cast<const bf16*>(k_s + lane * rb);
      for (int c = 0; c < d; c += 8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c);
        const float4 qa = *reinterpret_cast<const float4*>(q_s + c);
        const float4 qb = *reinterpret_cast<const float4*>(q_s + c + 4);
        const float2 k0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 k1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.z));
        const float2 k3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.w));
        part[0] += qa.x * k0.x;
        part[1] += qa.y * k0.y;
        part[2] += qa.z * k1.x;
        part[3] += qa.w * k1.y;
        part[0] += qb.x * k2.x;
        part[1] += qb.y * k2.y;
        part[2] += qb.z * k3.x;
        part[3] += qb.w * k3.y;
      }
    } else {
      const float* kr = reinterpret_cast<const float*>(k_s + lane * rb);
#pragma unroll 4
      for (int c = 0; c < d; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        const float4 qv = *reinterpret_cast<const float4*>(q_s + c);
        part[0] += qv.x * kv.x;
        part[1] += qv.y * kv.y;
        part[2] += qv.z * kv.z;
        part[3] += qv.w * kv.w;
      }
    }
    const bool ok = lane < n;
    const float s = ok ? ((part[0] + part[1]) + (part[2] + part[3])) * scale : kNegInf;

    // Online softmax: one warp max and one warp sum per chunk.
    const float m_new = fmaxf(m, warp_max(s));
    const float p = ok ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = l * alpha + warp_sum(p);
    m = m_new;
    p_s[lane] = p;
    __syncwarp();

    // P.V over the chunk's positions, even and odd ones apart.
    if (col_live) {
      float a0[CPL], a1[CPL];
#pragma unroll
      for (int i = 0; i < CPL; ++i) a0[i] = a1[i] = 0.f;
      for (int j = 0; j < n; j += 2) {
        float x[CPL];
        if constexpr (kQuant) {
          load_cols<CPL>(reinterpret_cast<const int8_t*>(v_s + j * rb) + c0, vs_s[j], x);
        } else {
          load_cols<CPL>(reinterpret_cast<const T*>(v_s + j * rb) + c0, x);
        }
        const float pj = p_s[j];
#pragma unroll
        for (int i = 0; i < CPL; ++i) a0[i] += pj * x[i];
        if (j + 1 < n) {
          if constexpr (kQuant) {
            load_cols<CPL>(reinterpret_cast<const int8_t*>(v_s + (j + 1) * rb) + c0, vs_s[j + 1], x);
          } else {
            load_cols<CPL>(reinterpret_cast<const T*>(v_s + (j + 1) * rb) + c0, x);
          }
          const float pk = p_s[j + 1];
#pragma unroll
          for (int i = 0; i < CPL; ++i) a1[i] += pk * x[i];
        }
      }
#pragma unroll
      for (int i = 0; i < CPL; ++i) acc[i] = acc[i] * alpha + (a0[i] + a1[i]);
    }
    __syncwarp();  // the stage and p_s are read out before they refill

    if (stages == 1 && it + 1 < n_mine) {
      issue(chunk + splits, 0, pg);
      if (it + 2 < n_mine) pg = table_entry(chunk + 2 * splits);
    }
  }
  hopper::cp_async_wait<0>();  // the q row, for a warp that walked nothing
  __syncwarp();

  // The splits merge into the first warp, in split order.
  if (splits > 1) {
    if (sp > 0) {
      if (lane == 0) {
        state_s[0] = m;
        state_s[1] = l;
      }
      if (col_live) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) state_s[2 + c0 + i] = acc[i];
      }
    }
    __syncthreads();
    if (sp > 0) return;
    for (int w = 1; w < splits; ++w) {
      const float* st = reinterpret_cast<const float*>(
          smem + w * wb + stages * sb + round16(4 * d) + 4 * kChunk);
      const float mw = st[0];
      const float mn = fmaxf(m, mw);
      const float a = expf(m - mn);
      const float b = expf(mw - mn);
      l = l * a + st[1] * b;
      m = mn;
      if (col_live) {
#pragma unroll
        for (int i = 0; i < CPL; ++i) acc[i] = acc[i] * a + st[2 + c0 + i] * b;
      }
    }
  }

  if (with_cur) {
    // The current step's K/V: always attendable, folded in last.
    float part = 0.f;
    if (col_live) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) part += q_s[c0 + i] * ck[i];
    }
    const float s = warp_sum(part) * scale;
    const float m_new = fmaxf(m, s);
    const float p = expf(s - m_new);
    const float alpha = expf(m - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = acc[i] * alpha + p * cv[i];
  }

  if (!col_live) return;
  const float safe_l = l == 0.f ? 1.f : l;
  Q* o = out + (static_cast<long long>(r) * heads + h) * d + c0;
#pragma unroll
  for (int i = 0; i < CPL; ++i) store(o + i, acc[i] / safe_l);
}

template <typename T, typename Q, int CPL>
cudaError_t launch(const dim3& grid, size_t bytes, cudaStream_t s,
                   const Q* q, long long q_row_stride, const void* k_pages,
                   const void* v_pages, const float* k_scale,
                   const float* v_scale, const int* tbl, int pages_per_row,
                   const int* lens, const Q* ck, const Q* cv,
                   long long cur_row_stride, Q* out, int heads,
                   int head_dim, int page_size, float scale, int splits,
                   int stages) {
  cudaError_t err = hopper::allow_smem(ragged_paged_kernel<T, Q, CPL>, bytes);
  if (err != cudaSuccess) return err;
  ragged_paged_kernel<T, Q, CPL><<<grid, 32 * splits, bytes, s>>>(
      q, q_row_stride, static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), k_scale, v_scale, tbl, pages_per_row,
      lens, ck, cv, cur_row_stride, out, heads, head_dim, page_size, scale,
      splits, stages);
  return cudaGetLastError();
}

}  // namespace

namespace {

// The entry points' shared body: checks, then the instantiation for the
// page type (int8 when pages_int8, else P) and the head dim's columns per
// lane.
template <typename P, typename Q>
int ragged_entry(const void* q, long long q_row_stride, const void* k_pages,
                 const void* v_pages, const void* k_scale, const void* v_scale,
                 int pages_int8, const void* block_table, int pages_per_row,
                 const void* lengths, const void* cur_k, const void* cur_v,
                 long long cur_row_stride, void* out, int rows, int heads,
                 int head_dim, int page_size, float scale, int splits,
                 int stages, void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > kMaxHeadDim ||
      page_size < 1 || (splits != 1 && splits != 2 && splits != 4) ||
      (stages != 1 && stages != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pages_int8 && (k_scale == nullptr || v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int elem = pages_int8 ? 1 : static_cast<int>(sizeof(P));
  const size_t bytes = static_cast<size_t>(splits) * warp_bytes(head_dim, elem, stages);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || heads == 0) return 0;
  const dim3 grid(heads, rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Q* qf = static_cast<const Q*>(q);
  const int* tbl = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  const Q* ck = static_cast<const Q*>(cur_k);
  const Q* cv = static_cast<const Q*>(cur_v);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  Q* o = static_cast<Q*>(out);
  const bool wide = head_dim > 64;
  cudaError_t err;
  if (pages_int8) {
    err = wide ? launch<int8_t, Q, 4>(grid, bytes, s, qf, q_row_stride, k_pages, v_pages, ks, vs,
                                      tbl, pages_per_row, lens, ck, cv, cur_row_stride, o, heads,
                                      head_dim, page_size, scale, splits, stages)
               : launch<int8_t, Q, 2>(grid, bytes, s, qf, q_row_stride, k_pages, v_pages, ks, vs,
                                      tbl, pages_per_row, lens, ck, cv, cur_row_stride, o, heads,
                                      head_dim, page_size, scale, splits, stages);
  } else {
    err = wide ? launch<P, Q, 4>(grid, bytes, s, qf, q_row_stride, k_pages, v_pages, nullptr,
                                 nullptr, tbl, pages_per_row, lens, ck, cv, cur_row_stride, o,
                                 heads, head_dim, page_size, scale, splits, stages)
               : launch<P, Q, 2>(grid, bytes, s, qf, q_row_stride, k_pages, v_pages, nullptr,
                                 nullptr, tbl, pages_per_row, lens, ck, cv, cur_row_stride, o,
                                 heads, head_dim, page_size, scale, splits, stages);
  }
  return static_cast<int>(err);
}

}  // namespace

// Plain C entry points (loaded with ctypes). query rows are [H, dh]
// contiguous, q_row_stride elements apart, each row start 16-byte
// aligned; block_table [R, pages_per_row] and lengths [R] are int32;
// cur_k / cur_v are [R, H*dh] rows cur_row_stride apart, or both null; out
// is a contiguous [R, H, dh] tensor. ragged_paged_attention: query, cur
// and out fp32, pages [num_pages, page, H*dh] fp32 (pages_int8 == 0) or
// int8 with k_scale / v_scale [num_pages, page] fp32.
// ragged_paged_attention_bf16: query, cur and out bf16, pages bf16 or int8
// with the same fp32 scales. A block covers one (row, head): `splits` (1,
// 2 or 4) warps share out its positions, `stages` (1 or 2) is how many
// chunks a warp keeps in flight; dh is a multiple of 8 up to 128; anything
// else is refused with cudaErrorInvalidValue. Each launches on `stream`
// and returns cudaGetLastError() — nonzero means the launch was refused.
extern "C" int ragged_paged_attention(
    const void* q, long long q_row_stride, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    int pages_int8, const void* block_table, int pages_per_row,
    const void* lengths, const void* cur_k, const void* cur_v,
    long long cur_row_stride, void* out, int rows, int heads, int head_dim,
    int page_size, float scale, int splits, int stages, void* stream) {
  return ragged_entry<float, float>(
      q, q_row_stride, k_pages, v_pages, k_scale, v_scale, pages_int8,
      block_table, pages_per_row, lengths, cur_k, cur_v, cur_row_stride, out,
      rows, heads, head_dim, page_size, scale, splits, stages, stream);
}

extern "C" int ragged_paged_attention_bf16(
    const void* q, long long q_row_stride, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    int pages_int8, const void* block_table, int pages_per_row,
    const void* lengths, const void* cur_k, const void* cur_v,
    long long cur_row_stride, void* out, int rows, int heads, int head_dim,
    int page_size, float scale, int splits, int stages, void* stream) {
  return ragged_entry<bf16, bf16>(
      q, q_row_stride, k_pages, v_pages, k_scale, v_scale, pages_int8,
      block_table, pages_per_row, lengths, cur_k, cur_v, cur_row_stride, out,
      rows, heads, head_dim, page_size, scale, splits, stages, stream);
}
