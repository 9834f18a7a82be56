// Flash-2 attention backward for Hopper (sm_90a): a dQ kernel and a dK/dV
// kernel, each fp32 (3xTF32 products) and bf16 (bf16 products, below).
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
// dQ, on the tensor cores (it walks the forward's tiles):
// - One block of W warps (W = 1, 2 or 4) per (batch*head, 16*G query
//   rows), W = G x C: each of G row groups owns one m16 tile of 16 rows,
//   and its C warps (C = 1 or 2, the key splits) share out the 32-key
//   tiles; the splits of a row group add their dQ in shared memory at the
//   end, in a fixed order. The wrapper picks G and C as the forward's
//   (dq_launch_params): at the training sites four row groups, one split.
// - Per key tile, mma.sync m16n8k8 in 3xTF32 (hopper_mma.cuh): S = Q K^T
//   and dP = dO V^T as accumulator fragments; P = exp(S * scale - lse)
//   and dS = P (dP - delta) on the fragments under the masks; then
//   dQ += dS K with dS's accumulator as the A operand (the k-order
//   permutation, no shuffles). dQ stays in registers for the whole walk
//   and is multiplied by `scale` once, at the end.
// - The start is one round trip, as the forward's: Q, dO, lse, delta and
//   the first step's K/V tiles are requested by cp.async together, while
//   the block reads the validity of its keys into a bitmap; key tiles
//   whose keys are all masked are never loaded, later live tiles are
//   double-buffered, and the causal walk stops at the block's last
//   visible key. Within a tile, an 8-key group that no row of the warp
//   sees takes none of the three products: at the training sites (5-29
//   valid keys at the front of each row) that is about half of them.
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
// warpgroup own 64 keys (dK/dV), most of them masked at these sites, or
// 64 query rows (dQ) against one or two live key tiles, and the work is
// latency-bound, not bound by the tensor-core rate; TMA pays off over long
// tile streams, and a block here walks at most seven tiles.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kMaxHeadDim = 128;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

using hopper::FragA;
using hopper::allow_smem;

// -- dQ: tensor-core tiles ----------------------------------------------------

constexpr int kDqMaxWarps = 4;
constexpr int kBlockK = 32;  // keys per K/V tile

// Dynamic shared memory of the dQ kernel: the block's Q and dO rows
// [16G][D_PAD + 4] each and their lse and delta [16G]; K and V tiles
// [2 buffers][C splits][K, V][kBlockK][D_PAD + 4]; one validity word per
// key tile and the list of live tiles past the first step
// (ops/hopper_attention.dq_smem_bytes mirrors this).
size_t dq_smem_bytes(int warps, int splits, int d_pad, int kv_len) {
  const int stride = d_pad + 4;
  const int rows = 16 * (warps / splits);
  const int tiles = (kv_len + kBlockK - 1) / kBlockK;
  return sizeof(float) * (2 * rows * stride + 2 * rows +
                          2 * splits * 2 * kBlockK * stride) +
         2 * sizeof(uint32_t) * tiles;
}

template <int D_PAD>
__global__ void __launch_bounds__(kDqMaxWarps * 32)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ d_out,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const uint8_t* __restrict__ kv_valid,
                    float* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, int heads, int q_len, int kv_len,
                    int head_dim, int causal, float scale, int splits) {
  constexpr int S = D_PAD + 4;     // shared row stride, 4 mod 32 words
  constexpr int KD = D_PAD / 8;    // 8-wide head-dim steps
  constexpr int NK = kBlockK / 8;  // 8-key groups per tile
  constexpr int TILE = kBlockK * S;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int row_warps = warps / splits;
  const int rows = 16 * row_warps;
  float* q_s = smem;                  // [rows][S]
  float* do_s = q_s + rows * S;       // [rows][S]
  float* lse_s = do_s + rows * S;     // [rows]
  float* delta_s = lse_s + rows;      // [rows]
  float* kv_s = delta_s + rows;       // [2][splits][2][kBlockK][S]
  const int tiles_alloc = (kv_len + kBlockK - 1) / kBlockK;
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(kv_s + 4 * splits * TILE);
  int* live_s = reinterpret_cast<int*>(bits_s + tiles_alloc);
  __shared__ int n_live_s;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = warp % row_warps;    // this warp's 16-row group
  const int sp = warp / row_warps;    // and its share of the key tiles
  const int offset = kv_len - q_len;  // causal diagonal: k <= q + offset
  const int d = head_dim;
  const int chunks = d >> 2;          // 16-byte chunks per row
  const int kd = d >> 3;              // 8-wide steps in use

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  const float* dob = d_out + b * dos.b + h * dos.h;
  const float* lseb = lse + static_cast<long long>(bh) * q_len;
  const float* deltab = delta + static_cast<long long>(bh) * q_len;

  // Under causality the block's bottom row sees keys up to
  // q_last + offset: later key tiles are never read.
  int k_end = kv_len;
  if (causal) k_end = min(kv_len, min(q0 + rows, q_len) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  // Tile `tile` into slot `c` of buffer `buf` (rows past kv_len zeroed).
  auto load_kv = [&](int tile, int buf, int c) {
    const int k0 = tile * kBlockK;
    float* kd_s = kv_s + ((buf * splits + c) * 2) * TILE;
    float* vd_s = kd_s + TILE;
    for (int i = threadIdx.x; i < kBlockK * chunks; i += blockDim.x) {
      const int j = i / chunks;
      const int col = (i - j * chunks) << 2;
      const int kj = k0 + j;
      const bool in = kj < kv_len;
      const long long row = in ? kj : 0;
      hopper::cp_async16(kd_s + j * S + col, kb + row * ks.s + col, in);
      hopper::cp_async16(vd_s + j * S + col, vb + row * vs.s + col, in);
    }
  };

  // One round trip to begin with: the block's Q and dO rows, their lse
  // and delta, and the first step's key tiles 0 .. splits-1 go out before
  // the keys' validity is known (a tile that turns out dead is a no-op).
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int col = (i - r * chunks) << 2;
    const int qi = q0 + r;
    const bool in = qi < q_len;
    const long long row = in ? qi : 0;
    hopper::cp_async16(q_s + r * S + col, qb + row * qs.s + col, in);
    hopper::cp_async16(do_s + r * S + col, dob + row * dos.s + col, in);
  }
  if (threadIdx.x < rows) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < q_len;
    const int row = in ? qi : 0;
    hopper::cp_async4(lse_s + threadIdx.x, lseb + row, in);
    hopper::cp_async4(delta_s + threadIdx.x, deltab + row, in);
  }
  for (int c = 0; c < splits && c < n_tiles; ++c) load_kv(c, 0, c);
  hopper::cp_async_commit();

  // One word per key tile, bit j = key k0 + j is in range and valid.
  for (int tile = warp; tile < n_tiles; tile += warps) {
    const int kj = tile * kBlockK + lane;
    bool ok = kj < kv_len;
    if (ok && kv_valid != nullptr) {
      ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
    }
    const unsigned word = __ballot_sync(hopper::kFull, ok);
    if (lane == 0) bits_s[tile] = word;
  }
  __syncthreads();
  // The live tiles past the first step, in order; a tile whose keys are
  // all masked adds exact zeros to dQ and is never loaded.
  if (warp == 0) {
    int n = 0;
    for (int base = splits; base < n_tiles; base += 32) {
      const int tile = base + lane;
      const bool live = tile < n_tiles && bits_s[tile] != 0u;
      const unsigned m = __ballot_sync(hopper::kFull, live);
      if (live) live_s[n + __popc(m & ((1u << lane) - 1u))] = tile;
      n += __popc(m);
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_walk = n_tiles > 0 ? 1 + (n_live + splits - 1) / splits : 0;
  auto step_tile = [&](int step, int c) {
    if (step == 0) return c < n_tiles ? c : -1;
    const int i = (step - 1) * splits + c;
    return i < n_live ? live_s[i] : -1;
  };

  // This warp's rows, and this thread's two of them (g and g + 8).
  const int r0 = q0 + 16 * rw;
  const bool warp_live = r0 < q_len;
  const int warp_last = min(r0 + 15, q_len - 1);

  float dq_acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  }

  int buf = 0;
  for (int step = 0; step < n_walk; ++step) {
    if (step + 1 < n_walk) {
      for (int c = 0; c < splits; ++c) {
        const int tile = step_tile(step + 1, c);
        if (tile >= 0) load_kv(tile, buf ^ 1, c);
      }
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles (and the own rows) are in place

    const int tile = step_tile(step, sp);
    const int k0 = tile * kBlockK;
    const bool dq_work = tile >= 0 && warp_live && bits_s[tile] != 0u &&
                         (!causal || k0 <= warp_last + offset);
    if (dq_work) {
      const float* kt = kv_s + ((buf * splits + sp) * 2) * TILE;
      const float* vt = kt + TILE;
      const unsigned word = bits_s[tile];
      const float* qr = q_s + (16 * rw + g) * S + t;
      const float* dr = do_s + (16 * rw + g) * S + t;
      // The tile's 8-key groups that some row of this warp sees; the
      // others take no products (their p and dS are exact zeros).
      unsigned live8 = 0;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        if (((word >> (8 * n)) & 0xffu) && (!causal || k0 + 8 * n <= warp_last + offset)) {
          live8 |= 1u << n;
        }
      }

      // S = Q K^T and dP = dO V^T over this tile: NK n-tiles of 8 keys.
      float s_acc[NK][4], dp_acc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[n][e] = dp_acc[n][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KD; ++s) {
        if (s < kd) {
          const int c = 8 * s;
          const FragA qa = hopper::frag_a(qr[c], qr[8 * S + c], qr[c + 4], qr[8 * S + c + 4]);
          const FragA da = hopper::frag_a(dr[c], dr[8 * S + c], dr[c + 4], dr[8 * S + c + 4]);
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            if ((live8 >> n) & 1u) {
              const float* kr = kt + (8 * n + g) * S + c + t;
              const float* vr = vt + (8 * n + g) * S + c + t;
              hopper::mma_3xtf32(s_acc[n], qa, hopper::frag_b(kr[0], kr[4]));
              hopper::mma_3xtf32(dp_acc[n], da, hopper::frag_b(vr[0], vr[4]));
            }
          }
        }
      }

      // P = exp(S * scale - lse) and dS = P (dP - delta), with the
      // forward's masks and the finite-lse guard; explicit zeros
      // elsewhere. Element e of n-tile n is row r0 + g + 8 (e >> 1), key
      // k0 + 8n + 2t + (e & 1).
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          const int ri = 16 * rw + g + 8 * (e >> 1);
          const int row = q0 + ri;
          const float l_ = lse_s[ri];
          bool ok = ((word >> j) & 1u) && row < q_len && l_ > 0.5f * kNegInf;
          if (causal) ok = ok && (k0 + j <= row + offset);
          const float p = ok ? expf(s_acc[n][e] * scale - l_) : 0.f;
          dp_acc[n][e] = ok ? p * (dp_acc[n][e] - delta_s[ri]) : 0.f;
        }
      }

      // dQ += dS K: k-steps of 8 keys (dS's accumulator is the A operand
      // in the permuted k-order: K rows 2t and 2t + 1), n-tiles of 8
      // head-dim columns.
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (!((live8 >> j) & 1u)) continue;
        const FragA sa = hopper::frag_a(dp_acc[j][0], dp_acc[j][2], dp_acc[j][1], dp_acc[j][3]);
        const float* kr = kt + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            hopper::mma_3xtf32(dq_acc[n], sa, hopper::frag_b(kr[8 * n], kr[8 * n + S]));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it refills
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  // The key splits of one row group add into its first warp, in split
  // order, through the (now idle) tile buffers.
  if (splits > 1) {
    constexpr int STATE = 4 * KD;  // dq_acc per lane
    if (sp > 0 && warp_live) {
      float* st = kv_s + ((sp - 1) * row_warps + rw) * 32 * STATE + lane;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[(4 * n + e) * 32] = dq_acc[n][e];
      }
    }
    __syncthreads();
    if (sp > 0) return;
    if (warp_live) {
      for (int c = 1; c < splits; ++c) {
        const float* sc = kv_s + ((c - 1) * row_warps + rw) * 32 * STATE + lane;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq_acc[n][e] += sc[(4 * n + e) * 32];
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= q_len) continue;
    float* o = dq + (static_cast<long long>(bh) * q_len + row) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<float2*>(o + 8 * n) =
            make_float2(dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch_dq(const dim3& grid, int warps, int splits, size_t bytes,
                      cudaStream_t stream, const float* q, const float* k,
                      const float* v, const float* d_out, const float* lse,
                      const float* delta, const uint8_t* kv_valid, float* dq,
                      Strides qs, Strides ks, Strides vs, Strides dos,
                      int heads, int q_len, int kv_len, int head_dim,
                      int causal, float scale) {
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, d_out, lse, delta, kv_valid, dq, qs, ks, vs, dos, heads,
      q_len, kv_len, head_dim, causal, scale, splits);
  return cudaGetLastError();
}

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


// -- bf16 ----------------------------------------------------------------------
//
// The bf16 instantiations: q/k/v/dO in and dQ/dK/dV out bf16, lse and delta
// float32, P and dS in float32. The products run on mma.sync m16n8k16 with
// bf16 operands and float32 accumulators (hopper_mma.cuh): S and dP from
// bf16 rows; dS (dQ's and dK's A operand) and P^T (dV's) are rounded to
// bf16 as they become A operands, as the reference's
// ds.astype(k.dtype) / p_t.astype(do.dtype) round them; dQ, dK and dV are
// summed in float32 registers and cast once at the end, as the
// reference's float32 scratch is. The blocks, splits, masks, skipping and
// merges are the fp32 kernels'. Rows sit in shared memory at D_PAD + 8
// bf16; the head dim's k-steps are 16 wide, a row zero-filled past d.

using bf16 = __nv_bfloat16;

// Dynamic shared memory of the bf16 dQ kernel: Q and dO rows [16G][D_PAD
// + 8] bf16, lse and delta [16G] float32, K/V tiles [2][C][2][kBlockK]
// [D_PAD + 8] bf16, the validity words and the live-tile list
// (ops/hopper_attention.dq_smem_bytes mirrors this).
size_t dq_bf16_smem_bytes(int warps, int splits, int d_pad, int kv_len) {
  const int stride = d_pad + 8;
  const int rows = 16 * (warps / splits);
  const int tiles = (kv_len + kBlockK - 1) / kBlockK;
  return sizeof(bf16) * (2 * rows * stride + 2 * splits * 2 * kBlockK * stride) +
         sizeof(float) * 2 * rows + 2 * sizeof(uint32_t) * tiles;
}

template <int D_PAD>
__global__ void __launch_bounds__(kDqMaxWarps * 32)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ d_out,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const uint8_t* __restrict__ kv_valid,
                         bf16* __restrict__ dq, Strides qs, Strides ks,
                         Strides vs, Strides dos, int heads, int q_len,
                         int kv_len, int head_dim, int causal, float scale,
                         int splits) {
  constexpr int S = D_PAD + 8;     // shared row stride in bf16, 4 mod 32 words
  constexpr int KD = D_PAD / 8;    // 8-wide output column tiles
  constexpr int KS = D_PAD / 16;   // 16-wide head-dim k-steps
  constexpr int NK = kBlockK / 8;  // 8-key n-tiles per tile
  constexpr int TILE = kBlockK * S;
  extern __shared__ __align__(16) unsigned char dq_bf16_smem[];
  const int warps = blockDim.x >> 5;
  const int row_warps = warps / splits;
  const int rows = 16 * row_warps;
  bf16* q_s = reinterpret_cast<bf16*>(dq_bf16_smem);  // [rows][S]
  bf16* do_s = q_s + rows * S;                        // [rows][S]
  float* lse_s = reinterpret_cast<float*>(do_s + rows * S);  // [rows]
  float* delta_s = lse_s + rows;                              // [rows]
  bf16* kv_s = reinterpret_cast<bf16*>(delta_s + rows);  // [2][splits][2][kBlockK][S]
  const int tiles_alloc = (kv_len + kBlockK - 1) / kBlockK;
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(kv_s + 4 * splits * TILE);
  int* live_s = reinterpret_cast<int*>(bits_s + tiles_alloc);
  __shared__ int n_live_s;

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int q0 = blockIdx.x * rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int rw = warp % row_warps;
  const int sp = warp / row_warps;
  const int offset = kv_len - q_len;
  const int d = head_dim;
  const int ks16 = (d + 15) >> 4;  // 16-wide k-steps in use
  const int chunks = ks16 << 1;    // 16-byte chunks per row, zero past d
  const int kd = d >> 3;           // 8-wide output tiles in use

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* dob = d_out + b * dos.b + h * dos.h;
  const float* lseb = lse + static_cast<long long>(bh) * q_len;
  const float* deltab = delta + static_cast<long long>(bh) * q_len;

  int k_end = kv_len;
  if (causal) k_end = min(kv_len, min(q0 + rows, q_len) + offset);
  const int n_tiles = k_end > 0 ? (k_end + kBlockK - 1) / kBlockK : 0;

  auto load_kv = [&](int tile, int buf, int c) {
    const int k0 = tile * kBlockK;
    bf16* kd_s = kv_s + ((buf * splits + c) * 2) * TILE;
    bf16* vd_s = kd_s + TILE;
    for (int i = threadIdx.x; i < kBlockK * chunks; i += blockDim.x) {
      const int j = i / chunks;
      const int col = (i - j * chunks) << 3;
      const int kj = k0 + j;
      const bool in = kj < kv_len && col < d;
      hopper::cp_async16(kd_s + j * S + col, kb + (in ? kj * ks.s + col : 0), in);
      hopper::cp_async16(vd_s + j * S + col, vb + (in ? kj * vs.s + col : 0), in);
    }
  };

  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int col = (i - r * chunks) << 3;
    const int qi = q0 + r;
    const bool in = qi < q_len && col < d;
    hopper::cp_async16(q_s + r * S + col, qb + (in ? qi * qs.s + col : 0), in);
    hopper::cp_async16(do_s + r * S + col, dob + (in ? qi * dos.s + col : 0), in);
  }
  if (threadIdx.x < rows) {
    const int qi = q0 + threadIdx.x;
    const bool in = qi < q_len;
    const int row = in ? qi : 0;
    hopper::cp_async4(lse_s + threadIdx.x, lseb + row, in);
    hopper::cp_async4(delta_s + threadIdx.x, deltab + row, in);
  }
  for (int c = 0; c < splits && c < n_tiles; ++c) load_kv(c, 0, c);
  hopper::cp_async_commit();

  for (int tile = warp; tile < n_tiles; tile += warps) {
    const int kj = tile * kBlockK + lane;
    bool ok = kj < kv_len;
    if (ok && kv_valid != nullptr) {
      ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
    }
    const unsigned word = __ballot_sync(hopper::kFull, ok);
    if (lane == 0) bits_s[tile] = word;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = splits; base < n_tiles; base += 32) {
      const int tile = base + lane;
      const bool live = tile < n_tiles && bits_s[tile] != 0u;
      const unsigned m = __ballot_sync(hopper::kFull, live);
      if (live) live_s[n + __popc(m & ((1u << lane) - 1u))] = tile;
      n += __popc(m);
    }
    if (lane == 0) n_live_s = n;
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int n_walk = n_tiles > 0 ? 1 + (n_live + splits - 1) / splits : 0;
  auto step_tile = [&](int step, int c) {
    if (step == 0) return c < n_tiles ? c : -1;
    const int i = (step - 1) * splits + c;
    return i < n_live ? live_s[i] : -1;
  };

  const int r0 = q0 + 16 * rw;
  const bool warp_live = r0 < q_len;
  const int warp_last = min(r0 + 15, q_len - 1);

  float dq_acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) {
    dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;
  }

  int buf = 0;
  for (int step = 0; step < n_walk; ++step) {
    if (step + 1 < n_walk) {
      for (int c = 0; c < splits; ++c) {
        const int tile = step_tile(step + 1, c);
        if (tile >= 0) load_kv(tile, buf ^ 1, c);
      }
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();

    const int tile = step_tile(step, sp);
    const int k0 = tile * kBlockK;
    const bool dq_work = tile >= 0 && warp_live && bits_s[tile] != 0u &&
                         (!causal || k0 <= warp_last + offset);
    if (dq_work) {
      const bf16* kt = kv_s + ((buf * splits + sp) * 2) * TILE;
      const bf16* vt = kt + TILE;
      const unsigned word = bits_s[tile];
      const bf16* qr = q_s + (16 * rw + g) * S + 2 * t;
      const bf16* dr = do_s + (16 * rw + g) * S + 2 * t;
      unsigned live8 = 0;
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        if (((word >> (8 * n)) & 0xffu) && (!causal || k0 + 8 * n <= warp_last + offset)) {
          live8 |= 1u << n;
        }
      }

      // S = Q K^T and dP = dO V^T over this tile, k-steps of 16.
      float s_acc[NK][4], dp_acc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s_acc[n][e] = dp_acc[n][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ks16) {
          uint32_t qa[4], da[4];
          hopper::frag_a_bf16(qa, qr + 16 * s, S);
          hopper::frag_a_bf16(da, dr + 16 * s, S);
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            if ((live8 >> n) & 1u) {
              const bf16* kr = kt + (8 * n + g) * S + 16 * s + 2 * t;
              const bf16* vr = vt + (8 * n + g) * S + 16 * s + 2 * t;
              const uint32_t kf[2] = {hopper::ld_bf16x2(kr), hopper::ld_bf16x2(kr + 8)};
              const uint32_t vf[2] = {hopper::ld_bf16x2(vr), hopper::ld_bf16x2(vr + 8)};
              hopper::mma_bf16(s_acc[n], qa, kf);
              hopper::mma_bf16(dp_acc[n], da, vf);
            }
          }
        }
      }

      // P = exp(S * scale - lse) and dS = P (dP - delta) under the masks.
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          const int ri = 16 * rw + g + 8 * (e >> 1);
          const int row = q0 + ri;
          const float l_ = lse_s[ri];
          bool ok = ((word >> j) & 1u) && row < q_len && l_ > 0.5f * kNegInf;
          if (causal) ok = ok && (k0 + j <= row + offset);
          const float p = ok ? expf(s_acc[n][e] * scale - l_) : 0.f;
          dp_acc[n][e] = ok ? p * (dp_acc[n][e] - delta_s[ri]) : 0.f;
        }
      }

      // dQ += dS K: k-steps of 16 keys (two of dS's fragments, rounded to
      // bf16, are the A operand), K read down its columns.
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        if (!((live8 >> (2 * j)) & 3u)) continue;
        uint32_t sa[4];
        hopper::frag_a_from_c(sa, dp_acc[2 * j], dp_acc[2 * j + 1]);
        const bf16* kr = kt + (16 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            const uint32_t kf[2] = {hopper::ld_bf16_col2(kr + 8 * n, S),
                                    hopper::ld_bf16_col2(kr + 8 * S + 8 * n, S)};
            hopper::mma_bf16(dq_acc[n], sa, kf);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();

  if (splits > 1) {
    constexpr int STATE = 4 * KD;
    float* state_s = reinterpret_cast<float*>(kv_s);
    if (sp > 0 && warp_live) {
      float* st = state_s + ((sp - 1) * row_warps + rw) * 32 * STATE + lane;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[(4 * n + e) * 32] = dq_acc[n][e];
      }
    }
    __syncthreads();
    if (sp > 0) return;
    if (warp_live) {
      for (int c = 1; c < splits; ++c) {
        const float* sc = state_s + ((c - 1) * row_warps + rw) * 32 * STATE + lane;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dq_acc[n][e] += sc[(4 * n + e) * 32];
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= q_len) continue;
    bf16* o = dq + (static_cast<long long>(bh) * q_len + row) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * n) = __floats2bfloat162_rn(
            dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch_dq_bf16(const dim3& grid, int warps, int splits, size_t bytes,
                           cudaStream_t stream, const bf16* q, const bf16* k,
                           const bf16* v, const bf16* d_out, const float* lse,
                           const float* delta, const uint8_t* kv_valid, bf16* dq,
                           Strides qs, Strides ks, Strides vs, Strides dos,
                           int heads, int q_len, int kv_len, int head_dim,
                           int causal, float scale) {
  cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_bf16_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, d_out, lse, delta, kv_valid, dq, qs, ks, vs, dos, heads,
      q_len, kv_len, head_dim, causal, scale, splits);
  return cudaGetLastError();
}

// Dynamic shared memory of the bf16 dK/dV kernel: the block's K and V rows
// [16G][D_PAD + 8] bf16, then [2][C] staged query tiles, each Q and dO
// [kTileQ][D_PAD + 8] bf16 and lse and delta [kTileQ] float32.
__host__ __device__ inline size_t dkv_bf16_tile_bytes(int d_pad) {
  return sizeof(bf16) * 2 * kTileQ * (d_pad + 8) + sizeof(float) * 2 * kTileQ;
}

size_t dkv_bf16_smem_bytes(int warps, int splits, int d_pad) {
  return sizeof(bf16) * 2 * 16 * (warps / splits) * (d_pad + 8) +
         2 * splits * dkv_bf16_tile_bytes(d_pad);
}

// Zeros into rows [row0, row0 + n) of the contiguous [*, d] bf16 dk and dv.
__device__ __forceinline__ void zero_rows_bf16(bf16* dk, bf16* dv,
                                               long long row0, int n, int d,
                                               int tid, int threads) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  uint4* k4 = reinterpret_cast<uint4*>(dk + row0 * d);
  uint4* v4 = reinterpret_cast<uint4*>(dv + row0 * d);
  for (int i = tid; i < n * (d >> 3); i += threads) {
    k4[i] = z;
    v4[i] = z;
  }
}

template <int D_PAD>
__global__ void __launch_bounds__(kDkvMaxWarps * 32)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ d_out,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const uint8_t* __restrict__ kv_valid,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          Strides qs, Strides ks, Strides vs, Strides dos,
                          int heads, int q_len, int kv_len, int head_dim,
                          int causal, float scale, int splits) {
  constexpr int S = D_PAD + 8;      // shared row stride in bf16, 4 mod 32 words
  constexpr int KD = D_PAD / 8;     // 8-wide output column tiles
  constexpr int KS = D_PAD / 16;    // 16-wide head-dim k-steps
  constexpr int NQ = kTileQ / 8;    // 8-row query n-tiles per tile
  extern __shared__ __align__(16) unsigned char dkv_bf16_smem[];
  const int warps = blockDim.x >> 5;
  const int groups = warps / splits;
  const int keys = 16 * groups;
  const size_t tile_bytes = dkv_bf16_tile_bytes(D_PAD);
  bf16* k_s = reinterpret_cast<bf16*>(dkv_bf16_smem);  // [keys][S]
  bf16* v_s = k_s + keys * S;                          // [keys][S]
  unsigned char* tiles_s = reinterpret_cast<unsigned char*>(v_s + keys * S);

  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const int k0 = blockIdx.x * keys;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int grp = warp % groups;
  const int sp = warp / groups;
  const int offset = kv_len - q_len;
  const int d = head_dim;
  const int ks16 = (d + 15) >> 4;
  const int chunks = ks16 << 1;
  const int kd = d >> 3;
  const long long out0 = static_cast<long long>(bh) * kv_len;
  const int kw0 = k0 + 16 * grp;

  bool ok = false;
  if (lane < 16) {
    const int kj = kw0 + lane;
    ok = kj < kv_len;
    if (ok && kv_valid != nullptr) {
      ok = kv_valid[static_cast<long long>(b) * kv_len + kj] != 0;
    }
  }
  const unsigned kbits = __ballot_sync(hopper::kFull, ok);
  if (!__syncthreads_or(kbits != 0u)) {
    zero_rows_bf16(dk, dv, out0 + k0, min(keys, kv_len - k0), d, threadIdx.x,
                   blockDim.x);
    return;
  }
  const bool warp_live = kbits != 0u;
  if (!warp_live && sp == 0) {
    zero_rows_bf16(dk, dv, out0 + kw0, max(0, min(16, kv_len - kw0)), d, lane, 32);
  }

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;
  const bf16* dob = d_out + b * dos.b + h * dos.h;
  const float* lseb = lse + static_cast<long long>(bh) * q_len;
  const float* deltab = delta + static_cast<long long>(bh) * q_len;

  for (int i = threadIdx.x; i < keys * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int c = (i - r * chunks) << 3;
    const int kj = k0 + r;
    const bool in = kj < kv_len && c < d;
    hopper::cp_async16(k_s + r * S + c, kb + (in ? kj * ks.s + c : 0), in);
    hopper::cp_async16(v_s + r * S + c, vb + (in ? kj * vs.s + c : 0), in);
  }
  hopper::cp_async_commit();

  int q_begin = 0;
  if (causal) q_begin = (max(0, k0 - offset) / kTileQ) * kTileQ;
  const int n_qtiles = q_begin < q_len ? (q_len - q_begin + kTileQ - 1) / kTileQ : 0;
  const int n_steps = (n_qtiles + splits - 1) / splits;

  auto tile_q = [&](int buf, int c) {
    return reinterpret_cast<bf16*>(tiles_s + (buf * splits + c) * tile_bytes);
  };
  auto load_rows = [&](int step, int buf) {
    for (int c = 0; c < splits; ++c) {
      const int i0 = q_begin + (step * splits + c) * kTileQ;
      if (i0 >= q_len) break;
      bf16* qd = tile_q(buf, c);
      bf16* dd = qd + kTileQ * S;
      float* ld = reinterpret_cast<float*>(dd + kTileQ * S);
      for (int i = threadIdx.x; i < kTileQ * chunks; i += blockDim.x) {
        const int r = i / chunks;
        const int col = (i - r * chunks) << 3;
        const int qi = i0 + r;
        const bool in = qi < q_len && col < d;
        hopper::cp_async16(qd + r * S + col, qb + (in ? qi * qs.s + col : 0), in);
        hopper::cp_async16(dd + r * S + col, dob + (in ? qi * dos.s + col : 0), in);
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
    __syncthreads();

    const int i0 = q_begin + (step * splits + sp) * kTileQ;
    bool work = warp_live && i0 < q_len;
    if (causal) work = work && (min(i0 + kTileQ, q_len) - 1 + offset >= kw0);
    if (work) {
      const bf16* qt = tile_q(buf, sp);
      const bf16* dt = qt + kTileQ * S;
      const float* lt = reinterpret_cast<const float*>(dt + kTileQ * S);
      const float* et = lt + kTileQ;
      const bf16* kr = k_s + (16 * grp + g) * S + 2 * t;
      const bf16* vr = v_s + (16 * grp + g) * S + 2 * t;

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys by the tile's
      // query rows, k-steps of 16 over the head dim.
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ks16) {
          uint32_t ka[4], va[4];
          hopper::frag_a_bf16(ka, kr + 16 * s, S);
          hopper::frag_a_bf16(va, vr + 16 * s, S);
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const bf16* qr = qt + (8 * n + g) * S + 16 * s + 2 * t;
            const bf16* dr = dt + (8 * n + g) * S + 16 * s + 2 * t;
            const uint32_t qf[2] = {hopper::ld_bf16x2(qr), hopper::ld_bf16x2(qr + 8)};
            const uint32_t df[2] = {hopper::ld_bf16x2(dr), hopper::ld_bf16x2(dr + 8)};
            hopper::mma_bf16(st[n], ka, qf);
            hopper::mma_bf16(dpt[n], va, df);
          }
        }
      }

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

      // dV += P^T dO and dK += dS^T Q: k-steps of 16 query rows (two of
      // P^T's and dS^T's fragments, rounded to bf16, are the A operands),
      // dO and Q read down their columns.
#pragma unroll
      for (int j = 0; j < NQ / 2; ++j) {
        uint32_t pa[4], sa[4];
        hopper::frag_a_from_c(pa, st[2 * j], st[2 * j + 1]);
        hopper::frag_a_from_c(sa, dpt[2 * j], dpt[2 * j + 1]);
        const bf16* dor = dt + (16 * j + 2 * t) * S + g;
        const bf16* qr = qt + (16 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            const uint32_t df[2] = {hopper::ld_bf16_col2(dor + 8 * n, S),
                                    hopper::ld_bf16_col2(dor + 8 * S + 8 * n, S)};
            const uint32_t qf[2] = {hopper::ld_bf16_col2(qr + 8 * n, S),
                                    hopper::ld_bf16_col2(qr + 8 * S + 8 * n, S)};
            hopper::mma_bf16(dv_acc[n], pa, df);
            hopper::mma_bf16(dk_acc[n], sa, qf);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();

  if (splits > 1) {
    constexpr int STATE = 8 * KD;
    float* state_s = reinterpret_cast<float*>(tiles_s);
    if (sp > 0 && warp_live) {
      float* st = state_s + ((sp - 1) * groups + grp) * 32 * STATE + lane;
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
        const float* sc = state_s + ((c - 1) * groups + grp) * 32 * STATE + lane;
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
    bf16* dkr = dk + (out0 + kj) * d + 2 * t;
    bf16* dvr = dv + (out0 + kj) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * n) = __floats2bfloat162_rn(
            dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * n) =
            __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch_dkv_bf16(const dim3& grid, int warps, int splits, size_t bytes,
                            cudaStream_t stream, const bf16* q, const bf16* k,
                            const bf16* v, const bf16* d_out, const float* lse,
                            const float* delta, const uint8_t* kv_valid, bf16* dk,
                            bf16* dv, Strides qs, Strides ks, Strides vs,
                            Strides dos, int heads, int q_len, int kv_len,
                            int head_dim, int causal, float scale) {
  cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_bf16_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, d_out, lse, delta, kv_valid, dk, dv, qs, ks, vs, dos, heads,
      q_len, kv_len, head_dim, causal, scale, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). q/k/v/d_out are [B, H, S, d]
// fp32 with the head dim contiguous, every row start 16-byte aligned, and
// the other strides given in elements; lse and delta are contiguous
// [B, H, Sq] fp32; kv_valid is [B, Sk] bytes (0 = masked) or null;
// dq/dk/dv are contiguous [B, H, S, d] fp32 tensors. Both take `warps`
// (1, 2 or 4), `splits` (1 or 2, dividing warps: dQ's key splits, dK/dV's
// query splits) and `d_pad` (64 or 128, with d a multiple of 8 and
// d <= d_pad); anything else is refused with cudaErrorInvalidValue. Each
// launches on `stream` and returns cudaGetLastError() (or the attribute
// call's error) — nonzero means the launch was refused.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, const void* kv_valid, void* dq,
    int batch, int heads, int q_len, int kv_len, int head_dim, int causal,
    float scale, int warps, int splits, int d_pad, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > d_pad ||
      (d_pad != 64 && d_pad != 128) ||
      (warps != 1 && warps != 2 && warps != 4) ||
      (splits != 1 && splits != 2) || warps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const size_t bytes = dq_smem_bytes(warps, splits, d_pad, kv_len);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * (warps / splits);
  const dim3 grid((q_len + rows - 1) / rows, batch * heads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const float*>(q);
  const auto kp = static_cast<const float*>(k);
  const auto vp = static_cast<const float*>(v);
  const auto dop = static_cast<const float*>(d_out);
  const auto lp = static_cast<const float*>(lse);
  const auto dp = static_cast<const float*>(delta);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto dqp = static_cast<float*>(dq);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{do_sb, do_sh, do_ss};
  const cudaError_t err =
      d_pad == 64
          ? launch_dq<64>(grid, warps, splits, bytes, s, qp, kp, vp, dop, lp,
                          dp, valid, dqp, qs, ks, vs, dos, heads, q_len,
                          kv_len, head_dim, causal, scale)
          : launch_dq<128>(grid, warps, splits, bytes, s, qp, kp, vp, dop, lp,
                           dp, valid, dqp, qs, ks, vs, dos, heads, q_len,
                           kv_len, head_dim, causal, scale);
  return static_cast<int>(err);
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

// The bf16 instantiations' entry points: the arguments and checks of
// flash_attention_bwd_dq / flash_attention_bwd_dkv, with q/k/v/d_out and
// dq/dk/dv bf16 (rows 16-byte aligned) and lse/delta float32.
extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* d_out,
    const void* lse, const void* delta, const void* kv_valid, void* dq,
    int batch, int heads, int q_len, int kv_len, int head_dim, int causal,
    float scale, int warps, int splits, int d_pad, long long q_sb,
    long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss, void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > d_pad ||
      (d_pad != 64 && d_pad != 128) ||
      (warps != 1 && warps != 2 && warps != 4) ||
      (splits != 1 && splits != 2) || warps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const size_t bytes = dq_bf16_smem_bytes(warps, splits, d_pad, kv_len);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * (warps / splits);
  const dim3 grid((q_len + rows - 1) / rows, batch * heads);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{do_sb, do_sh, do_ss};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const bf16*>(q);
  const auto kp = static_cast<const bf16*>(k);
  const auto vp = static_cast<const bf16*>(v);
  const auto dop = static_cast<const bf16*>(d_out);
  const auto lp = static_cast<const float*>(lse);
  const auto dp = static_cast<const float*>(delta);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto dqp = static_cast<bf16*>(dq);
  const cudaError_t err =
      d_pad == 64
          ? launch_dq_bf16<64>(grid, warps, splits, bytes, s, qp, kp, vp, dop,
                               lp, dp, valid, dqp, qs, ks, vs, dos, heads,
                               q_len, kv_len, head_dim, causal, scale)
          : launch_dq_bf16<128>(grid, warps, splits, bytes, s, qp, kp, vp, dop,
                                lp, dp, valid, dqp, qs, ks, vs, dos, heads,
                                q_len, kv_len, head_dim, causal, scale);
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkv_bf16(
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
  const size_t bytes = dkv_bf16_smem_bytes(warps, splits, d_pad);
  const int keys = 16 * (warps / splits);
  const dim3 grid((kv_len + keys - 1) / keys, batch * heads);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, dos{do_sb, do_sh, do_ss};
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const bf16*>(q);
  const auto kp = static_cast<const bf16*>(k);
  const auto vp = static_cast<const bf16*>(v);
  const auto dop = static_cast<const bf16*>(d_out);
  const auto lp = static_cast<const float*>(lse);
  const auto dp = static_cast<const float*>(delta);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto dkp = static_cast<bf16*>(dk);
  const auto dvp = static_cast<bf16*>(dv);
  const cudaError_t err =
      d_pad == 64
          ? launch_dkv_bf16<64>(grid, warps, splits, bytes, s, qp, kp, vp, dop,
                                lp, dp, valid, dkp, dvp, qs, ks, vs, dos,
                                heads, q_len, kv_len, head_dim, causal, scale)
          : launch_dkv_bf16<128>(grid, warps, splits, bytes, s, qp, kp, vp,
                                 dop, lp, dp, valid, dkp, dvp, qs, ks, vs, dos,
                                 heads, q_len, kv_len, head_dim, causal, scale);
  return static_cast<int>(err);
}
