// Ragged paged-attention decode step, for Hopper (sm_90a).
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
// Design. One thread block of one warp per (head, row): grid (H, R). A
// block per row with a warp per head was the other choice; it would share
// the block table between heads, but a decode batch has few rows (the
// engine's max_active), and R blocks would leave most of the 132 SMs
// idle, while R*H one-warp blocks spread over all of them. The warp reads
// its own block_table[r] and lengths[r] (no scalar prefetch) and walks
// positions 0..len-1 in chunks of 32, one position per lane, so it
// touches ceil(len/page) pages and never the null padding of the table.
// A head's slice of a slot is the contiguous dh run at h*dh of that
// slot's H*dh row, read by the 32 lanes together (dh/32 values each). For
// each chunk the warp first computes the 32 scores (lane j keeps the
// score of position j), then does one online-softmax update (running max
// m, denominator l, fp32 accumulator in registers) and accumulates P*V.
//
// What bounds it on this card. Each position's K and V are read once and
// used for 2*dh flops each, so the kernel is bound by bytes: the bound is
// the K/V (plus scale) bytes the rows' lengths need over 3.35 TB/s. At
// the serving slice's shapes (32 rows, 8 heads, lengths of tens of
// positions) that is a few microseconds of traffic, so launch latency and
// the serial warp-reduction per position dominate; splitting long rows
// over several warps (split-K) and deeper load pipelines are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kDimPerLane = kMaxHeadDim / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float load_value(const float* p, float) {
  return *p;
}

__device__ __forceinline__ float load_value(const int8_t* p, float s) {
  return static_cast<float>(*p) * s;
}

template <typename T, bool kQuant>
__global__ void __launch_bounds__(32)
ragged_paged_kernel(const float* __restrict__ q, long long q_row_stride,
                    const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_table, int pages_per_row,
                    const int* __restrict__ lengths,
                    const float* __restrict__ cur_k,
                    const float* __restrict__ cur_v, long long cur_row_stride,
                    float* __restrict__ out, int heads, int head_dim,
                    int page_size, float scale) {
  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int lane = threadIdx.x;
  const long long d_model = static_cast<long long>(heads) * head_dim;
  const int len = lengths[r];
  const int* tbl = block_table + static_cast<long long>(r) * pages_per_row;

  const float* qr = q + r * q_row_stride + h * head_dim;
  float qv[kDimPerLane];
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) {
    const int c = lane + 32 * i;
    qv[i] = c < head_dim ? qr[c] : 0.f;
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kDimPerLane];
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) acc[i] = 0.f;

  for (int base = 0; base < len; base += 32) {
    const int n = min(32, len - base);  // warp-uniform
    // This lane's position, as a slot index into the page store.
    long long slot = 0;
    if (lane < n) {
      const int pos = base + lane;
      const int page = tbl[pos / page_size];
      slot = static_cast<long long>(page) * page_size + pos % page_size;
    }

    float s_mine = kNegInf;
    for (int j = 0; j < n; ++j) {
      const long long sj = __shfl_sync(kFull, slot, j);
      const T* kp = k_pages + sj * d_model + h * head_dim;
      const float ks = kQuant ? k_scale[sj] : 1.f;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < head_dim) part += qv[i] * load_value(kp + c, ks);
      }
      part = warp_sum(part);
      if (lane == j) s_mine = part * scale;
    }

    const bool mask = lane < n;
    const float m_cur = fmaxf(m, warp_max(s_mine));
    const float p = mask ? expf(s_mine - m_cur) : 0.f;
    const float alpha = expf(m - m_cur);
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[i] *= alpha;
    for (int j = 0; j < n; ++j) {
      const float pj = __shfl_sync(kFull, p, j);
      const long long sj = __shfl_sync(kFull, slot, j);
      const T* vp = v_pages + sj * d_model + h * head_dim;
      const float vs = kQuant ? v_scale[sj] : 1.f;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < head_dim) acc[i] += pj * load_value(vp + c, vs);
      }
    }
    m = m_cur;
  }

  if (cur_k != nullptr) {
    // The current step's K/V: always attendable, folded in last.
    const float* ck = cur_k + r * cur_row_stride + h * head_dim;
    const float* cv = cur_v + r * cur_row_stride + h * head_dim;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < head_dim) part += qv[i] * ck[c];
    }
    const float s = warp_sum(part) * scale;
    const float m_cur = fmaxf(m, s);
    const float p = expf(s - m_cur);
    const float alpha = expf(m - m_cur);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) {
      const int c = lane + 32 * i;
      acc[i] = acc[i] * alpha + (c < head_dim ? p * cv[c] : 0.f);
    }
  }

  const float safe_l = l == 0.f ? 1.f : l;
  float* o = out + (static_cast<long long>(r) * heads + h) * head_dim;
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) {
    const int c = lane + 32 * i;
    if (c < head_dim) o[c] = acc[i] / safe_l;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). query rows are [H, dh]
// contiguous, q_row_stride elements apart; pages are [num_pages, page,
// H*dh] fp32 (pages_int8 == 0) or int8 with k_scale / v_scale [num_pages,
// page] fp32; block_table [R, pages_per_row] and lengths [R] are int32;
// cur_k / cur_v are [R, H*dh] rows cur_row_stride apart, or both null;
// out is a contiguous [R, H, dh] fp32 tensor. Launches on `stream` and
// returns cudaGetLastError() — nonzero means the launch was refused.
extern "C" int ragged_paged_attention(
    const void* q, long long q_row_stride, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    int pages_int8, const void* block_table, int pages_per_row,
    const void* lengths, const void* cur_k, const void* cur_v,
    long long cur_row_stride, void* out, int rows, int heads, int head_dim,
    int page_size, float scale, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim || page_size < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (pages_int8 && (k_scale == nullptr || v_scale == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0 || heads == 0) return 0;
  const dim3 grid(heads, rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const int* tbl = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  const float* ck = static_cast<const float*>(cur_k);
  const float* cv = static_cast<const float*>(cur_v);
  float* o = static_cast<float*>(out);
  if (pages_int8) {
    ragged_paged_kernel<int8_t, true><<<grid, 32, 0, s>>>(
        qf, q_row_stride, static_cast<const int8_t*>(k_pages),
        static_cast<const int8_t*>(v_pages),
        static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
        tbl, pages_per_row, lens, ck, cv, cur_row_stride, o, heads, head_dim,
        page_size, scale);
  } else {
    ragged_paged_kernel<float, false><<<grid, 32, 0, s>>>(
        qf, q_row_stride, static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), nullptr, nullptr, tbl,
        pages_per_row, lens, ck, cv, cur_row_stride, o, heads, head_dim,
        page_size, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
