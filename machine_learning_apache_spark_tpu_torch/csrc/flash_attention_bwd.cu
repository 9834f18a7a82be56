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
// The TPU kernels walk a sequential grid and carry dq (or dk/dv) in VMEM
// scratch from one grid step to the next; here each block owns its rows
// and loops over the other side inside the block, so nothing is carried
// between blocks and there are no atomics: every output element is summed
// by one thread in a fixed order, and results repeat bit for bit.
//
// What bounds them on this card. At the MT training sites ([32, 8, 200, 64]
// fp32 fixture batches) only ~7 % of the keys are valid, so the work the
// masks leave is small: each kernel must move ~40-55 MB and do 0.2-0.4
// GFLOP, bound by bytes at 12-16 us (0.4 GFLOP is ~2.4 us at the 3xTF32
// rate of 495/3 TFLOP/s). What they take beyond that is latency: the
// length of each block's serial chain and the loads that wait on it.
//
// dQ (unchanged since it was first written): one block per (batch*head,
// tile of 16 query rows); four warps of four rows each. The block walks
// the keys in tiles of 32 (one key per lane), staging K and V in shared
// memory; dq accumulates in fp32 registers (lane owns head-dim columns
// lane, lane+32, ...), each row's dot products a dependent chain of
// shared-memory loads on the fp32 CUDA cores. Under causality key tiles
// above the tile's bottom row are never loaded, and a tile whose keys are
// all masked by kv_valid is skipped whole. The streamed tile's rows sit in
// shared memory with a one-float pad (lane j reading row j is free of bank
// conflicts). Any head_dim that is a multiple of 8 up to 128 works.
//
// dK/dV, on the tensor cores:
// - One block of W warps (W = 1, 2 or 4) per (batch*head, 16*G keys),
//   W = G x C: each of G key groups owns one m16 tile of 16 keys, and its
//   C warps (C = 1 or 2, the query splits) share out the query tiles, so a
//   block's serial walk is C times shorter. The splits of a key group add
//   their dK/dV in shared memory at the end, in a fixed order. The wrapper
//   picks G = C = 2 where the walk has two tiles or more (the training
//   sites: blocks of 32 keys, seven 32-row tiles walked in four steps).
// - Dead blocks exit first. Before any load the block reads its keys'
//   validity (k < kv_len and kv_valid). A block whose keys are all masked
//   writes zero dK/dV rows and returns; a warp whose 16 keys are all
//   masked writes zeros and does no math. At the training sites that is
//   ~6 of every 7 blocks of 32 keys; the first design staged every query
//   tile for them. Exact: the contract asks for zeros there.
// - Per 32-row query tile, mma.sync m16n8k8 in 3xTF32 (hopper_mma.cuh):
//   S^T = K Q^T and dP^T = V dO^T as accumulator fragments; then
//   P^T = exp(S^T * scale - lse) under the masks and dS^T = P^T (dP^T -
//   delta) on the fragments; then dV += P^T dO and dK += dS^T Q, with the
//   accumulators turned into A operands without a shuffle (the k-order
//   permutation). dK and dV stay in registers for the whole walk.
// - Q, dO, lse and delta tiles arrive by cp.async, double-buffered (the
//   next step's copies run under this step's mma); the block's own K and V
//   rows likewise, once. Query tiles wholly above the causal diagonal are
//   skipped; rows sit in shared memory with a 4-float pad (row stride 4
//   mod 32 words), so fragment loads are free of bank conflicts.
// - Instantiated for a padded head dim of 64 or 128; loops stop at the
//   real d (a multiple of 8). The wrapper checks 16-byte row alignment.
// Why mma.sync and not wgmma/TMA: wgmma's 64-row M tile would make a
// warpgroup own 64 keys, most of them masked at these sites, and the work
// is latency-bound, not bound by the tensor-core rate; TMA pays off over
// long tile streams, and a block here walks at most seven tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

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

// Dynamic shared memory of the dQ kernel: the block's own two row sets
// [kBlockRows][d] each, the streamed tile's two row sets [kTile][d + 1]
// each, and kTile floats for the key validity bytes (a size that also
// held the first dK/dV kernel's lse and delta, kept as it was).
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

using hopper::FragA;
using hopper::allow_smem;

// -- dK/dV: tensor-core tiles -------------------------------------------------

constexpr int kDkvMaxWarps = 4;
constexpr int kTileQ = 32;  // streamed query rows per tile

// Dynamic shared memory of the dK/dV kernel: the block's own K and V rows
// [16G][D_PAD + 4] each, then [2 buffers][C splits] staged query tiles,
// each Q and dO [kTileQ][D_PAD + 4] and lse and delta [kTileQ].
size_t dkv_smem_bytes(int warps, int splits, int d_pad) {
  const int stride = d_pad + 4;
  return sizeof(float) * (2 * 16 * (warps / splits) * stride +
                          2 * splits * (2 * kTileQ * stride + 2 * kTileQ));
}

// Zeros into rows [row0, row0 + n) of the contiguous [*, d] dk and dv.
__device__ __forceinline__ void zero_rows(float* dk, float* dv,
                                          long long row0, int n, int d,
                                          int tid, int threads) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  float4* k4 = reinterpret_cast<float4*>(dk + row0 * d);
  float4* v4 = reinterpret_cast<float4*>(dv + row0 * d);
  for (int i = tid; i < n * (d >> 2); i += threads) {
    k4[i] = z;
    v4[i] = z;
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(kDkvMaxWarps * 32)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ d_out,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const uint8_t* __restrict__ kv_valid,
                     float* __restrict__ dk, float* __restrict__ dv,
                     Strides qs, Strides ks, Strides vs, Strides dos,
                     int heads, int q_len, int kv_len, int head_dim,
                     int causal, float scale, int splits) {
  constexpr int S = D_PAD + 4;      // shared row stride, 4 mod 32 words
  constexpr int KD = D_PAD / 8;     // 8-wide head-dim steps
  constexpr int NQ = kTileQ / 8;    // 8-row query groups per tile
  constexpr int QT = 2 * kTileQ * S + 2 * kTileQ;  // one staged query tile
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int groups = warps / splits;  // key groups of 16
  const int keys = 16 * groups;
  float* k_s = smem;                       // [keys][S]
  float* v_s = k_s + keys * S;             // [keys][S]
  float* tiles_s = v_s + keys * S;         // [2][splits][QT]

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * keys;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int grp = warp % groups;      // this warp's 16 keys
  const int sp = warp / groups;       // and its share of the query tiles
  const int offset = kv_len - q_len;  // causal diagonal: k <= q + offset
  const int d = head_dim;
  const int chunks = d >> 2;          // 16-byte chunks per row
  const int kd = d >> 3;              // 8-wide steps in use
  const long long out0 = static_cast<long long>(bh) * kv_len;
  const int kw0 = k0 + 16 * grp;      // this warp's first key

  // The keys' validity comes first: bit j of kbits is key kw0 + j.
  bool ok = false;
  if (lane < 16) {
    const int kj = kw0 + lane;
    ok = kj < kv_len;
    if (ok && kv_valid != nullptr) {
      ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
    }
  }
  const unsigned kbits = __ballot_sync(hopper::kFull, ok);
  // A block whose keys are all masked writes exact zeros and loads nothing.
  if (!__syncthreads_or(kbits != 0u)) {
    zero_rows(dk, dv, out0 + k0, min(keys, kv_len - k0), d, threadIdx.x,
              blockDim.x);
    return;
  }
  const bool warp_live = kbits != 0u;
  if (!warp_live && sp == 0) {  // still takes part in copies and barriers
    zero_rows(dk, dv, out0 + kw0, max(0, min(16, kv_len - kw0)), d, lane, 32);
  }

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dob = d_out + b * dos.b + h * dos.h;
  const float* lseb = lse + static_cast<long long>(bh) * q_len;
  const float* deltab = delta + static_cast<long long>(bh) * q_len;

  // The block's own K and V rows, past kv_len zero-filled.
  for (int i = threadIdx.x; i < keys * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) << 2;
    const int kj = k0 + r;
    const bool in = kj < kv_len;
    const long long row = in ? kj : 0;
    hopper::cp_async16(k_s + r * S + c, kb + row * ks.s + c, in);
    hopper::cp_async16(v_s + r * S + c, vb + row * vs.s + c, in);
  }
  hopper::cp_async_commit();

  // Under causality row qi sees key k0 only when qi >= k0 - offset: earlier
  // query tiles are wholly above the diagonal for every key of the block.
  // The rest go `splits` at a time, one to each split.
  int q_begin = 0;
  if (causal) q_begin = (max(0, k0 - offset) / kTileQ) * kTileQ;
  const int n_qtiles = q_begin < q_len ? (q_len - q_begin + kTileQ - 1) / kTileQ : 0;
  const int n_steps = (n_qtiles + splits - 1) / splits;

  auto load_rows = [&](int step, int buf) {
    for (int c = 0; c < splits; ++c) {
      const int i0 = q_begin + (step * splits + c) * kTileQ;
      if (i0 >= q_len) break;
      float* qd = tiles_s + (buf * splits + c) * QT;
      float* dd = qd + kTileQ * S;
      float* ld = dd + kTileQ * S;
      for (int i = threadIdx.x; i < kTileQ * chunks; i += blockDim.x) {
        const int r = i / chunks;
        const int col = (i - r * chunks) << 2;
        const int qi = i0 + r;
        const bool in = qi < q_len;
        const long long row = in ? qi : 0;
        hopper::cp_async16(qd + r * S + col, qb + row * qs.s + col, in);
        hopper::cp_async16(dd + r * S + col, dob + row * dos.s + col, in);
      }
      if (threadIdx.x < kTileQ) {
        const int qi = i0 + threadIdx.x;
        const bool in = qi < q_len;
        const int row = in ? qi : 0;
        hopper::cp_async4(ld + threadIdx.x, lseb + row, in);
        hopper::cp_async4(ld + kTileQ + threadIdx.x, deltab + row, in);
      }
    }
    hopper::cp_async_commit();
  };

  float dk_acc[KD][4], dv_acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  }

  if (n_steps > 0) load_rows(0, 0);
  int buf = 0;
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load_rows(step + 1, buf ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // own rows and this step's tiles are in shared memory

    const int i0 = q_begin + (step * splits + sp) * kTileQ;
    bool work = warp_live && i0 < q_len;
    if (causal) work = work && (min(i0 + kTileQ, q_len) - 1 + offset >= kw0);
    if (work) {
      const float* qt = tiles_s + (buf * splits + sp) * QT;
      const float* dt = qt + kTileQ * S;
      const float* lt = dt + kTileQ * S;
      const float* et = lt + kTileQ;
      const float* kr = k_s + (16 * grp + g) * S + t;
      const float* vr = v_s + (16 * grp + g) * S + t;

      // S^T = K Q^T and dP^T = V dO^T: rows are this warp's 16 keys,
      // columns the tile's query rows, NQ n-tiles of 8.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KD; ++s) {
        if (s < kd) {
          const int c = 8 * s;
          const FragA ka =
              hopper::frag_a(kr[c], kr[8 * S + c], kr[c + 4], kr[8 * S + c + 4]);
          const FragA va =
              hopper::frag_a(vr[c], vr[8 * S + c], vr[c + 4], vr[8 * S + c + 4]);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const float* qr = qt + (8 * n + g) * S + c + t;
            const float* dr = dt + (8 * n + g) * S + c + t;
            hopper::mma_3xtf32(st[n], ka, hopper::frag_b(qr[0], qr[4]));
            hopper::mma_3xtf32(dpt[n], va, hopper::frag_b(dr[0], dr[4]));
          }
        }
      }

      // P^T = exp(S^T * scale - lse) and dS^T = P^T (dP^T - delta), with
      // the forward's masks and the finite-lse guard; explicit zeros
      // elsewhere. Element e of n-tile n is key kw0 + g + 8 (e >> 1),
      // query row i0 + 8n + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          const int qi = i0 + col;
          const int kr_ = g + 8 * (e >> 1);
          const float l_ = lt[col];
          bool m = ((kbits >> kr_) & 1u) && qi < q_len && l_ > 0.5f * kNegInf;
          if (causal) m = m && (kw0 + kr_ <= qi + offset);
          const float p = m ? expf(st[n][e] * scale - l_) : 0.f;
          dpt[n][e] = m ? p * (dpt[n][e] - et[col]) : 0.f;
          st[n][e] = p;
        }
      }

      // dV += P^T dO and dK += dS^T Q: k-steps of 8 query rows (the
      // accumulators are A operands in the permuted k-order: dO and Q
      // rows 2t and 2t + 1), n-tiles of 8 head-dim columns.
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const FragA pa = hopper::frag_a(st[j][0], st[j][2], st[j][1], st[j][3]);
        const FragA sa =
            hopper::frag_a(dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3]);
        const float* dor = dt + (8 * j + 2 * t) * S + g;
        const float* qr = qt + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            hopper::mma_3xtf32(dv_acc[n], pa,
                               hopper::frag_b(dor[8 * n], dor[8 * n + S]));
            hopper::mma_3xtf32(dk_acc[n], sa,
                               hopper::frag_b(qr[8 * n], qr[8 * n + S]));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it refills
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  // The query splits of one key group add into its first warp, in split
  // order, through the (now idle) tile buffers.
  if (splits > 1) {
    constexpr int STATE = 8 * KD;  // dk_acc and dv_acc per lane
    if (sp > 0 && warp_live) {
      float* st = tiles_s + ((sp - 1) * groups + grp) * 32 * STATE + lane;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[(4 * n + e) * 32] = dk_acc[n][e];
          st[(4 * KD + 4 * n + e) * 32] = dv_acc[n][e];
        }
      }
    }
    __syncthreads();
    if (sp > 0) return;
    if (warp_live) {
      for (int c = 1; c < splits; ++c) {
        const float* sc = tiles_s + ((c - 1) * groups + grp) * 32 * STATE + lane;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dk_acc[n][e] += sc[(4 * n + e) * 32];
            dv_acc[n][e] += sc[(4 * KD + 4 * n + e) * 32];
          }
        }
      }
    }
  }

  if (!warp_live || sp > 0) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = kw0 + g + 8 * i;
    if (kj >= kv_len) continue;
    float* dkr = dk + (out0 + kj) * d + 2 * t;
    float* dvr = dv + (out0 + kj) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<float2*>(dkr + 8 * n) =
            make_float2(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
        *reinterpret_cast<float2*>(dvr + 8 * n) =
            make_float2(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch_dkv(const dim3& grid, int warps, int splits, size_t bytes,
                       cudaStream_t stream, const float* q, const float* k,
                       const float* v, const float* d_out, const float* lse,
                       const float* delta, const uint8_t* kv_valid, float* dk,
                       float* dv, Strides qs, Strides ks, Strides vs,
                       Strides dos, int heads, int q_len, int kv_len,
                       int head_dim, int causal, float scale) {
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, d_out, lse, delta, kv_valid, dk, dv, qs, ks, vs, dos, heads,
      q_len, kv_len, head_dim, causal, scale, splits);
  return cudaGetLastError();
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
    int causal, float scale, int warps, int splits, int d_pad,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long do_sb, long long do_sh, long long do_ss,
    void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > d_pad ||
      (d_pad != 64 && d_pad != 128) ||
      (warps != 1 && warps != 2 && warps != 4) ||
      (splits != 1 && splits != 2) || warps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || kv_len == 0) return 0;
  const size_t bytes = dkv_smem_bytes(warps, splits, d_pad);
  const int keys = 16 * (warps / splits);
  const dim3 grid((kv_len + keys - 1) / keys, batch * heads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const float*>(q);
  const auto kp = static_cast<const float*>(k);
  const auto vp = static_cast<const float*>(v);
  const auto dop = static_cast<const float*>(d_out);
  const auto lp = static_cast<const float*>(lse);
  const auto dp = static_cast<const float*>(delta);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto dkp = static_cast<float*>(dk);
  const auto dvp = static_cast<float*>(dv);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{do_sb, do_sh, do_ss};
  const cudaError_t err =
      d_pad == 64
          ? launch_dkv<64>(grid, warps, splits, bytes, s, qp, kp, vp, dop, lp,
                           dp, valid, dkp, dvp, qs, ks, vs, dos, heads, q_len,
                           kv_len, head_dim, causal, scale)
          : launch_dkv<128>(grid, warps, splits, bytes, s, qp, kp, vp, dop,
                            lp, dp, valid, dkp, dvp, qs, ks, vs, dos, heads,
                            q_len, kv_len, head_dim, causal, scale);
  return static_cast<int>(err);
}
