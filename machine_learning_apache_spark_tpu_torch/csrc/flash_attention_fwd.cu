// Blockwise online-softmax attention forward, fp32, for Hopper (sm_90a).
//
// Replaces machine_learning_apache_spark_tpu/ops/pallas_attention.py::
// _flash_kernel (launched from _flash_forward). Same function: for every
// (batch, head, query row) a softmax over the keys that the row may see,
// never materialising the [Sq, Sk] score matrix. Keys are masked by
// k < kv_len, by the optional per-key kv_valid [B, Sk], and under
// `causal` by the bottom-right-aligned diagonal k <= q + (Sk - Sq).
// Masked entries get an explicit zero probability, so a row that sees no
// key keeps l == 0 and writes zeros, not NaN. NEG_INF is -1e30 as in the
// reference.
//
// Optional lse output. When the caller passes an `lse` pointer ([B, H, Sq]
// fp32), each row also writes its softmax normalizer in log space,
// m + log(l), or NEG_INF where l == 0 (a row that sees no key): the
// `return_lse` output of _flash_kernel, from which the backward kernels
// (flash_attention_bwd.cu) recompute probabilities. A null pointer keeps
// the serving path exactly as it was.
//
// Design. One thread block per (batch*head, tile of kBlockQ query rows);
// four warps, each owning kRowsPerWarp rows. The block walks the keys in
// tiles of kBlockK = 32 (one key per lane), staging each K and V tile in
// shared memory once for all of its rows; the running max m, denominator
// l and the fp32 output accumulator of every row stay in registers. Under
// causality the walk stops at the last key the tile's bottom row can see,
// so tiles above the diagonal are never loaded, and a tile whose keys are
// all masked by kv_valid (the padded tail of a batch row) is skipped
// whole. Nothing of the TPU tiling
// is carried over: no 128-lane head padding, no (8, 128) block shapes;
// any head_dim up to kMaxHeadDim works, including the MT model's 64.
//
// What bounds it on this card. At the serving slice's shapes (one prompt
// of <= 64 tokens per prefill, 8 heads of 64) the kernel moves a few
// hundred KB and does a few MFLOP, so it is bound by launch latency and
// by how few blocks the grid has, far from the 3.35 TB/s or the fp32
// rate. At long sequence lengths it does 4*Sq*Sk*d flops on the fp32
// CUDA cores (67 TFLOP/s), not on the tensor cores; wgmma tiles and TMA
// loads are the work of a later change. K rows sit in shared memory with
// a one-float pad so that lane j reading row j is free of bank conflicts.
// At the MT training sites ([32, 8, 200, 64], ~7 % of keys valid) the
// skip of all-masked key tiles leaves most rows one tile of seven: ~105 us
// per call against an 8.4 us bytes bound, where walking every tile took
// ~550 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
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

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse,
                 Strides qs, Strides ks, Strides vs,
                 int heads, int q_len, int kv_len, int head_dim, int causal,
                 float scale) {
  __shared__ float q_s[kBlockQ][kMaxHeadDim];
  __shared__ float k_s[kBlockK][kMaxHeadDim + 1];
  __shared__ float v_s[kBlockK][kMaxHeadDim];
  __shared__ uint8_t valid_s[kBlockK];

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int causal_offset = kv_len - q_len;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  for (int i = threadIdx.x; i < kBlockQ * head_dim; i += blockDim.x) {
    const int r = i / head_dim;
    const int c = i - r * head_dim;
    const int qi = q0 + r;
    q_s[r][c] = qi < q_len ? qb[qi * qs.s + c] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] = 0.f;
  }

  // Under causality the tile's bottom row sees keys up to q_last + offset:
  // later key tiles lie wholly above the diagonal and are skipped.
  int k_end = kv_len;
  if (causal) {
    const int q_last = min(q0 + kBlockQ, q_len) - 1;
    k_end = min(kv_len, q_last + causal_offset + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile (and the Q tile) are settled
    int ok = 0;
    if (threadIdx.x < kBlockK) {
      const int kj = k0 + threadIdx.x;
      ok = kj < kv_len;
      if (ok && kv_valid != nullptr) {
        ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
      }
      valid_s[threadIdx.x] = ok ? 1 : 0;
    }
    // A tile whose keys are all masked changes no row's m, l or acc
    // (every p is an explicit zero and alpha is 1): skip its loads and
    // its work. Padded batches end in such tiles.
    if (!__syncthreads_or(ok)) continue;
    for (int i = threadIdx.x; i < kBlockK * head_dim; i += blockDim.x) {
      const int j = i / head_dim;
      const int c = i - j * head_dim;
      const int kj = k0 + j;
      const bool in = kj < kv_len;
      k_s[j][c] = in ? kb[kj * ks.s + c] : 0.f;
      v_s[j][c] = in ? vb[kj * vs.s + c] : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi < q_len) {  // warp-uniform
        bool mask = valid_s[lane] != 0;
        if (causal) mask = mask && (kj <= qi + causal_offset);
        float s = 0.f;
        for (int c = 0; c < head_dim; ++c) s += q_s[r][c] * k_s[lane][c];
        s = mask ? s * scale : kNegInf;
        const float m_cur = fmaxf(m[rr], warp_max(s));
        const float p = mask ? expf(s - m_cur) : 0.f;
        const float alpha = expf(m[rr] - m_cur);
        l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] *= alpha;
        for (int j = 0; j < kBlockK; ++j) {
          const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
          for (int i = 0; i < kDimPerLane; ++i) {
            const int c = lane + 32 * i;
            if (c < head_dim) acc[rr][i] += pj * v_s[j][c];
          }
        }
        m[rr] = m_cur;
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi < q_len) {
      const float safe_l = l[rr] == 0.f ? 1.f : l[rr];
      const long long row = static_cast<long long>(bh) * q_len + qi;
      if (lse != nullptr && lane == 0) {
        lse[row] = l[rr] == 0.f ? kNegInf : m[rr] + logf(safe_l);
      }
      float* o = out + row * head_dim;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < head_dim) o[c] = acc[rr][i] / safe_l;
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q/k/v are [B, H, S, d] fp32
// with the head dim contiguous and the other strides given in elements;
// kv_valid is [B, Sk] bytes (0 = masked) or null; out is a contiguous
// [B, H, Sq, d] fp32 tensor; lse is a contiguous [B, H, Sq] fp32 tensor or
// null. Launches on `stream` and returns
// cudaGetLastError() — nonzero means the launch was refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int batch, int heads, int q_len, int kv_len, int head_dim,
    int causal, float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const dim3 grid((q_len + kBlockQ - 1) / kBlockQ, batch * heads);
  flash_fwd_kernel<<<grid, kWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const uint8_t*>(kv_valid),
      static_cast<float*>(out), static_cast<float*>(lse),
      Strides{q_sb, q_sh, q_ss},
      Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss}, heads, q_len,
      kv_len, head_dim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}
