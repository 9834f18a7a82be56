// Flash-2 attention backward, fp32, for Hopper (sm_90a): a dQ kernel and a
// dK/dV kernel.
//
// Replaces machine_learning_apache_spark_tpu/ops/pallas_attention.py::
// _flash_bwd_dq_kernel and ::_flash_bwd_dkv_kernel (both launched from
// _flash_backward). Same function: from q, k, v, dO, the forward's
// per-row lse = m + log(l) and delta = rowsum(dO * O), recompute each
// probability p = exp(s * scale - lse) instead of reading a saved [Sq, Sk]
// matrix, then
//   dp = dO . v,   ds = p * (dp - delta),
//   dQ = sum_k ds * K * scale,  dK = sum_q ds * Q * scale,  dV = sum_q p * dO.
// Masks are the forward's: k < kv_len, the optional per-key kv_valid
// [B, Sk], bottom-right causal k <= q + (Sk - Sq), plus the finite-lse guard
// lse > NEG_INF / 2 (a row that saw no key has lse == NEG_INF, and exp
// would overflow before the mask). Masked entries get an explicit zero p
// and ds, so a key that no row sees gets exactly zero dK and dV.
//
// Design. The TPU kernels walk a sequential grid and carry dq (or dk/dv)
// in VMEM scratch from one grid step to the next; here each block owns its
// rows and loops over the other side inside the block, so nothing is
// carried between blocks and there are no atomics: every output element is
// summed by one thread in a fixed order, and results repeat bit for bit.
//   dQ:    one block per (batch*head, tile of 16 query rows); four warps of
//          four rows each. The block walks the keys in tiles of 32 (one key
//          per lane), staging K and V in shared memory; dq accumulates in
//          fp32 registers (lane owns head-dim columns lane, lane+32, ...).
//          Under causality key tiles above the tile's bottom row are never
//          loaded, and a tile whose keys are all masked by kv_valid is
//          skipped whole, as in the forward.
//   dK/dV: one block per (batch*head, tile of 16 keys); four warps of four
//          keys each. The block walks the query rows in tiles of 32 (one row
//          per lane), staging Q, dO, lse and delta in shared memory; dk and
//          dv accumulate in fp32 registers. A warp skips its masked keys;
//          under causality query tiles that lie wholly above the diagonal
//          for the block's first key are skipped.
// The streamed tile's rows sit in shared memory with a one-float pad so
// that lane j reading row j is free of bank conflicts; the block's own rows
// are read as broadcasts. Any head_dim that is a multiple of 8 up to 128
// works (the MT model's 64 included); shared memory is sized by it.
//
// What bounds it on this card. At the MT training sites ([32, 8, 200, 64]
// fp32 fixture batches) only ~7 % of the keys are valid, so the work the
// masks leave is small: each kernel must move ~40-55 MB and do 0.2-0.4
// GFLOP, bound by bytes at 12-16 us. Both take 180-400 us: each row's dot
// products are a dependent chain of shared-memory loads on the fp32 CUDA
// cores, and dK/dV walks every query row (pad rows too) for each valid
// key. The tile skip above cut dQ from ~1.2 ms to ~0.2 ms at these sites.
// mma.sync / wgmma tiles, bf16 inputs and skipping rows whose dO is zero
// are the work of a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeadDim = 128;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockRows = kWarps * kRowsPerWarp;  // rows a block owns
constexpr int kTile = 32;                           // streamed rows per tile
constexpr int kDimPerLane = kMaxHeadDim / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

// Dynamic shared memory of either kernel: the block's own two row sets
// [kBlockRows][d] each, the streamed tile's two row sets [kTile][d + 1]
// each, and kTile floats of per-row statistics (dK/dV: lse and delta;
// dQ: key validity bytes).
size_t smem_bytes(int head_dim) {
  return sizeof(float) *
         (2 * kBlockRows * head_dim + 2 * kTile * (head_dim + 1) + 2 * kTile);
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < d; ++c) s += a[c] * b[c];
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ kv_valid,
                    float* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, int heads, int q_len, int kv_len,
                    int head_dim, int causal, float scale) {
  extern __shared__ float smem[];
  const int d = head_dim;
  const int dp1 = d + 1;
  float* q_s = smem;                   // [kBlockRows][d]
  float* do_s = q_s + kBlockRows * d;  // [kBlockRows][d]
  float* k_s = do_s + kBlockRows * d;  // [kTile][d + 1]
  float* v_s = k_s + kTile * dp1;      // [kTile][d + 1]
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(v_s + kTile * dp1);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int causal_offset = kv_len - q_len;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dob = d_out + b * dos.b + h * dos.h;

  for (int i = threadIdx.x; i < kBlockRows * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    const int qi = q0 + r;
    const bool in = qi < q_len;
    q_s[i] = in ? qb[qi * qs.s + c] : 0.f;
    do_s[i] = in ? dob[qi * dos.s + c] : 0.f;
  }

  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimPerLane];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    const long long row = static_cast<long long>(bh) * q_len + qi;
    const bool in = qi < q_len;
    lse_r[rr] = in ? lse[row] : kNegInf;
    delta_r[rr] = in ? delta[row] : 0.f;
    live[rr] = in && lse_r[rr] > 0.5f * kNegInf;  // the finite-lse guard
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] = 0.f;
  }

  int k_end = kv_len;
  if (causal) {
    const int q_last = min(q0 + kBlockRows, q_len) - 1;
    k_end = min(kv_len, q_last + causal_offset + 1);
  }

  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile (and the own rows) are settled
    int ok = 0;
    if (threadIdx.x < kTile) {
      const int kj = k0 + threadIdx.x;
      ok = kj < kv_len;
      if (ok && kv_valid != nullptr) {
        ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
      }
      valid_s[threadIdx.x] = ok ? 1 : 0;
    }
    // A tile whose keys are all masked adds exact zeros to dq: skip it.
    if (!__syncthreads_or(ok)) continue;
    for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
      const int j = i / d;
      const int c = i - j * d;
      const int kj = k0 + j;
      const bool in = kj < kv_len;
      k_s[j * dp1 + c] = in ? kb[kj * ks.s + c] : 0.f;
      v_s[j * dp1 + c] = in ? vb[kj * vs.s + c] : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (!live[rr]) continue;  // warp-uniform
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      bool mask = valid_s[lane] != 0;
      if (causal) mask = mask && (kj <= qi + causal_offset);
      const float s = dot(q_s + r * d, k_s + lane * dp1, d);
      const float dp = dot(do_s + r * d, v_s + lane * dp1, d);
      const float p = mask ? expf(s * scale - lse_r[rr]) : 0.f;
      const float ds = mask ? p * (dp - delta_r[rr]) : 0.f;
      for (int j = 0; j < kTile; ++j) {
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < d) acc[rr][i] += dsj * k_s[j * dp1 + c];
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int qi = q0 + warp * kRowsPerWarp + rr;
    if (qi < q_len) {
      float* o = dq + (static_cast<long long>(bh) * q_len + qi) * d;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) o[c] = acc[rr][i] * scale;
      }
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ d_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kv_valid,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     int heads, int q_len, int kv_len, int head_dim,
                     int causal, float scale) {
  extern __shared__ float smem[];
  const int d = head_dim;
  const int dp1 = d + 1;
  float* k_s = smem;                   // [kBlockRows][d]
  float* v_s = k_s + kBlockRows * d;   // [kBlockRows][d]
  float* q_s = v_s + kBlockRows * d;   // [kTile][d + 1]
  float* do_s = q_s + kTile * dp1;     // [kTile][d + 1]
  float* lse_s = do_s + kTile * dp1;   // [kTile]
  float* delta_s = lse_s + kTile;      // [kTile]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int causal_offset = kv_len - q_len;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dob = d_out + b * dos.b + h * dos.h;

  for (int i = threadIdx.x; i < kBlockRows * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    const int kj = k0 + r;
    const bool in = kj < kv_len;
    k_s[i] = in ? kb[kj * ks.s + c] : 0.f;
    v_s[i] = in ? vb[kj * vs.s + c] : 0.f;
  }

  float dk_acc[kRowsPerWarp][kDimPerLane], dv_acc[kRowsPerWarp][kDimPerLane];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int kj = k0 + warp * kRowsPerWarp + rr;
    bool ok = kj < kv_len;
    if (ok && kv_valid != nullptr) {
      ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
    }
    live[rr] = ok;  // a masked key keeps exactly zero dk and dv
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) dk_acc[rr][i] = dv_acc[rr][i] = 0.f;
  }

  // Under causality row qi sees key k0 only when qi >= k0 - offset: earlier
  // query tiles are wholly above the diagonal for every key of the block.
  int q_begin = 0;
  if (causal) q_begin = (max(0, k0 - causal_offset) / kTile) * kTile;

  for (int i0 = q_begin; i0 < q_len; i0 += kTile) {
    __syncthreads();  // the previous tile (and the own rows) are settled
    for (int i = threadIdx.x; i < kTile * d; i += blockDim.x) {
      const int j = i / d;
      const int c = i - j * d;
      const int qi = i0 + j;
      const bool in = qi < q_len;
      q_s[j * dp1 + c] = in ? qb[qi * qs.s + c] : 0.f;
      do_s[j * dp1 + c] = in ? dob[qi * dos.s + c] : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int qi = i0 + threadIdx.x;
      const long long row = static_cast<long long>(bh) * q_len + qi;
      const bool in = qi < q_len;
      lse_s[threadIdx.x] = in ? lse[row] : kNegInf;
      delta_s[threadIdx.x] = in ? delta[row] : 0.f;
    }
    __syncthreads();

    const int qi = i0 + lane;
    const float lse_l = lse_s[lane];
    const float delta_l = delta_s[lane];
    const bool row_ok = qi < q_len && lse_l > 0.5f * kNegInf;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      if (!live[rr]) continue;  // warp-uniform
      const int r = warp * kRowsPerWarp + rr;
      const int kj = k0 + r;
      bool mask = row_ok;
      if (causal) mask = mask && (kj <= qi + causal_offset);
      const float s = dot(k_s + r * d, q_s + lane * dp1, d);
      const float dp = dot(v_s + r * d, do_s + lane * dp1, d);
      const float p = mask ? expf(s * scale - lse_l) : 0.f;
      const float ds = mask ? p * (dp - delta_l) : 0.f;
      for (int j = 0; j < kTile; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float dsj = __shfl_sync(kFull, ds, j);
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int c = lane + 32 * i;
          if (c < d) {
            dv_acc[rr][i] += pj * do_s[j * dp1 + c];
            dk_acc[rr][i] += dsj * q_s[j * dp1 + c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int kj = k0 + warp * kRowsPerWarp + rr;
    if (kj < kv_len) {
      const long long off = (static_cast<long long>(bh) * kv_len + kj) * d;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int c = lane + 32 * i;
        if (c < d) {
          dk[off + c] = dk_acc[rr][i] * scale;
          dv[off + c] = dv_acc[rr][i];
        }
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Plain C entry points (loaded with ctypes). q/k/v/d_out are [B, H, S, d]
// fp32 with the head dim contiguous and the other strides given in
// elements; lse and delta are contiguous [B, H, Sq] fp32; kv_valid is
// [B, Sk] bytes (0 = masked) or null; dq/dk/dv are contiguous [B, H, S, d]
// fp32 tensors. Each launches on `stream` and returns cudaGetLastError()
// (or the attribute call's error) — nonzero means the launch was refused.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, const void* kv_valid, void* dq,
    int batch, int heads, int q_len, int kv_len, int head_dim, int causal,
    float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const size_t bytes = smem_bytes(head_dim);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((q_len + kBlockRows - 1) / kBlockRows, batch * heads);
  flash_bwd_dq_kernel<<<grid, kWarps * 32, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(kv_valid), static_cast<float*>(dq),
      Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
      Strides{v_sb, v_sh, v_ss}, Strides{do_sb, do_sh, do_ss}, heads, q_len,
      kv_len, head_dim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, const void* kv_valid, void* dk,
    void* dv, int batch, int heads, int q_len, int kv_len, int head_dim,
    int causal, float scale, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, void* stream) {
  if (head_dim < 1 || head_dim > kMaxHeadDim) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || kv_len == 0) return 0;
  const size_t bytes = smem_bytes(head_dim);
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((kv_len + kBlockRows - 1) / kBlockRows, batch * heads);
  flash_bwd_dkv_kernel<<<grid, kWarps * 32, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(d_out),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(kv_valid), static_cast<float*>(dk),
      static_cast<float*>(dv), Strides{q_sb, q_sh, q_ss},
      Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss},
      Strides{do_sb, do_sh, do_ss}, heads, q_len, kv_len, head_dim, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}
