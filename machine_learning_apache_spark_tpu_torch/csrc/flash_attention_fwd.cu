// Blockwise online-softmax attention forward on Hopper's tensor cores
// (sm_90a): fp32 in and out (3xTF32 products), and a bf16 instantiation
// (bf16 products, below) for a bf16 model.
//
// Replaces machine_learning_apache_spark_tpu/ops/pallas_attention.py::
// _flash_kernel (launched from _flash_forward). Same function: for every
// (batch, head, query row) a softmax over the keys that the row may see,
// never materialising the [Sq, Sk] score matrix. Keys are masked by
// k < kv_len, by the optional per-key kv_valid [B, Sk], and under
// `causal` by the bottom-right-aligned diagonal k <= q + (Sk - Sq).
// Masked entries get an explicit zero probability, so a row that sees no
// key keeps l == 0 and writes zeros, not NaN. NEG_INF is -1e30 as in the
// reference. When the caller passes an `lse` pointer ([B, H, Sq] fp32),
// each row also writes m + log(l), or NEG_INF where l == 0: the
// `return_lse` output from which the backward recomputes probabilities.
//
// What bounds it on this card. At every site the port runs (serving
// prefill [1, 8, <=64, 64]; the MT training sites [32, 8, 200, 64] with
// ~7 % of keys valid; eval decode at Sq = 1) the bytes bound is 0.1-9 us
// and the operations bound far below it, so the kernel is bound by
// latency: how fast a block gets its tiles in and how long its serial
// chain of dependent steps is. The design shortens that chain.
//
// Design.
// - One block of W warps (W = 1, 2 or 4) per (batch*head, 16*R query
//   rows), W = R x C: each of R row groups owns one m16 tile of 16 rows,
//   and its C warps (C = 1 or 2, the key splits) share out the key tiles.
//   The block stages each 32-key K/V tile in shared memory once for all
//   its row groups, so K and V are fetched once per 16*R rows. The
//   wrapper picks R and C: R = 4 where that still fills the card (the
//   training sites: 1,024 blocks), else C = 2 when there are two key
//   tiles or more and as many row groups as fit in four warps (the
//   serving prefill: 16 blocks of 2 x 2, each row group walking its two
//   tiles side by side instead of one after the other; measured fastest
//   of the five choices). The splits of a row group merge their (m, l, O)
//   in shared memory at the end, in a fixed order, so a result repeats
//   bit for bit.
// - S = Q K^T and O += P V run on the tensor cores: mma.sync m16n8k8 with
//   TF32 operands in 3xTF32 (hopper_mma.cuh), so the products keep fp32
//   accuracy. The Q fragments (hi and lo) are read once per block into
//   registers and reused for every K tile. The online softmax works on
//   the accumulator fragments: a row's values sit in one lane quad, so
//   its max is two __shfl_xor_sync steps; m, l and O stay in registers.
//   P goes from accumulator to A operand with no shuffle (the k-order
//   permutation in hopper_mma.cuh).
// - K and V tiles arrive by cp.async (16-byte .cg), double-buffered: the
//   next step's copies are in flight while this one's mma run. The
//   wrapper checks that every row start is 16-byte aligned.
// - A block's time is one dependent chain, so its start takes a single
//   round trip: the Q tile and the first step's key tiles (0 .. C-1) are
//   requested before their validity is known; meanwhile the block reads
//   the validity of all its keys into a bitmap in shared memory (one word
//   per 32-key tile) and lists the live tiles after the first step. A tile
//   whose keys are all masked is then never loaded (or, in the first
//   step, not computed on); the causal walk stops at the last key the
//   block's bottom row can see, and a warp whose rows see none of a
//   tile's keys does no math on it.
// - Rows sit in shared memory with a 4-float pad (row stride = 4 mod 32
//   words), which makes every fragment load free of bank conflicts.
// - Head dims: the kernel is instantiated for a padded head dim D_PAD of
//   64 or 128 (register arrays are sized by it); the head-dim loops stop
//   at the real d (a multiple of 8), so no padding is read.
//
// Why mma.sync and not wgmma/TMA. wgmma's M tile is 64 rows of one
// warpgroup: it would pad the serving prefill (Sq 32 or 64, batch 1) and
// the eval decode (Sq = 1) several-fold, and the sites are latency-bound,
// not bound by the tensor-core rate. TMA and warp specialisation pay off
// over long tile streams; here a block sees one to seven tiles. They are
// left for a later change, if measurements ever point there.

#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using hopper::FragA;

constexpr int kMaxWarps = 4;
constexpr int kBlockK = 32;  // keys per K/V tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, s;  // elements; the head-dim stride is 1
};

// Dynamic shared memory: the Q tile [16R][D_PAD + 4]; K and V tiles
// [2 buffers][C splits][K, V][kBlockK][D_PAD + 4]; one validity word per
// key tile and the list of live tiles past the first step.
size_t fwd_smem_bytes(int warps, int splits, int d_pad, int kv_len) {
  const int stride = d_pad + 4;
  const int tiles = (kv_len + kBlockK - 1) / kBlockK;
  return sizeof(float) * (16 * (warps / splits) * stride +
                          2 * splits * 2 * kBlockK * stride) +
         2 * sizeof(uint32_t) * tiles;
}

template <int D_PAD>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const uint8_t* __restrict__ kv_valid,
                 float* __restrict__ out, float* __restrict__ lse,
                 Strides qs, Strides ks, Strides vs,
                 int heads, int q_len, int kv_len, int head_dim, int causal,
                 float scale, int splits) {
  constexpr int S = D_PAD + 4;    // shared row stride, 4 mod 32 words
  constexpr int KD = D_PAD / 8;   // 8-wide head-dim steps
  constexpr int NK = kBlockK / 8; // 8-key groups per tile
  constexpr int TILE = kBlockK * S;
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int row_warps = warps / splits;
  const int rows = 16 * row_warps;
  float* q_s = smem;                         // [rows][S]
  float* kv_s = q_s + rows * S;              // [2][splits][2][kBlockK][S]
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

  // One round trip to begin with: the Q tile and the first step's key
  // tiles 0 .. splits-1 go out before their validity is known (keys sit
  // at the front of a padded row; a tile that turns out dead is a no-op).
  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int col = (i - r * chunks) << 2;
    const int qi = q0 + r;
    const bool in = qi < q_len;
    hopper::cp_async16(q_s + r * S + col, qb + (in ? qi : 0) * qs.s + col, in);
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
  // The live tiles past the first step, in order: the later steps walk
  // them `splits` at a time, so a tile whose keys are all masked is
  // never loaded.
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
  const int n_steps =
      n_tiles > 0 ? 1 + (n_live + splits - 1) / splits : 0;
  auto step_tile = [&](int step, int c) {
    if (step == 0) return c < n_tiles ? c : -1;
    const int i = (step - 1) * splits + c;
    return i < n_live ? live_s[i] : -1;
  };

  // This warp's rows, and this thread's two of them (g and g + 8).
  const int r0 = q0 + 16 * rw;
  const bool warp_live = r0 < q_len;
  const int row_a = r0 + g;
  const int row_b = row_a + 8;
  const int warp_last = min(r0 + 15, q_len - 1);

  FragA qf[KD];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int buf = 0;
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      for (int c = 0; c < splits; ++c) {
        const int tile = step_tile(step + 1, c);
        if (tile >= 0) load_kv(tile, buf ^ 1, c);
      }
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles (and Q) are in shared memory

    if (step == 0 && warp_live) {  // Q fragments, once per block
      const float* qr = q_s + (16 * rw + g) * S + t;
#pragma unroll
      for (int s = 0; s < KD; ++s) {
        if (s < kd) {
          const float* p = qr + 8 * s;
          qf[s] = hopper::frag_a(p[0], p[8 * S], p[4], p[8 * S + 4]);
        }
      }
    }

    const int tile = step_tile(step, sp);
    const int k0 = tile * kBlockK;
    if (tile >= 0 && warp_live && bits_s[tile] != 0u &&
        (!causal || k0 <= warp_last + offset)) {
      const float* kt = kv_s + ((buf * splits + sp) * 2) * TILE;
      const float* vt = kt + TILE;
      const unsigned word = bits_s[tile];

      // S = Q K^T over this tile: NK n-tiles of 8 keys.
      float s_acc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s_acc[n][0] = s_acc[n][1] = s_acc[n][2] = s_acc[n][3] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KD; ++s) {
        if (s < kd) {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            const float* kr = kt + (8 * n + g) * S + 8 * s + t;
            hopper::mma_3xtf32(s_acc[n], qf[s], hopper::frag_b(kr[0], kr[4]));
          }
        }
      }

      // Masks, then the online softmax on the fragments. Element e of
      // n-tile n is row (e < 2 ? row_a : row_b), key k0 + 8n + 2t + (e & 1).
      unsigned ok_bits = 0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          bool ok = (word >> j) & 1u;
          if (causal) ok = ok && (k0 + j <= row + offset);
          if (ok) ok_bits |= 1u << (4 * n + e);
          s_acc[n][e] = ok ? s_acc[n][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[n][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(hopper::kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(hopper::kFull, mx[i], 2));
      }
      const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
      m[0] = mx[0];
      m[1] = mx[1];
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok_bits >> (4 * n + e)) & 1u
                              ? expf(s_acc[n][e] - mx[e >> 1])
                              : 0.f;
          s_acc[n][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: k-steps of 8 keys (P's accumulator is the A operand in
      // the permuted k-order: V rows 2t and 2t + 1), n-tiles of 8 columns.
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const FragA pa = hopper::frag_a(s_acc[j][0], s_acc[j][2],
                                        s_acc[j][1], s_acc[j][3]);
        const float* vr = vt + (8 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            hopper::mma_3xtf32(o[n], pa,
                               hopper::frag_b(vr[8 * n], vr[8 * n + S]));
          }
        }
      }
    }
    __syncthreads();  // every warp is done with `buf` before it refills
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();  // no copy outlives the block

  // The key splits of one row group merge into its first warp, in split
  // order: (m, l, O) of split c are rescaled to the common max and added.
  if (splits > 1) {
    constexpr int STATE = 4 + 4 * KD;  // m[2], l[2], o[KD][4] per lane
    if (sp > 0) {
      float* st = kv_s + ((sp - 1) * row_warps + rw) * 32 * STATE + lane;
      st[0] = m[0];
      st[32] = m[1];
      st[64] = l[0];
      st[96] = l[1];
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[(4 + 4 * n + e) * 32] = o[n][e];
      }
    }
    __syncthreads();
    if (sp > 0) return;
    for (int c = 1; c < splits; ++c) {
      const float* sc = kv_s + ((c - 1) * row_warps + rw) * 32 * STATE + lane;
      float a[2], w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mc = sc[32 * i];
        const float mn = fmaxf(m[i], mc);
        a[i] = expf(m[i] - mn);
        w[i] = expf(mc - mn);
        l[i] = l[i] * a[i] + sc[64 + 32 * i] * w[i];
        m[i] = mn;
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[n][e] = o[n][e] * a[e >> 1] + sc[(4 + 4 * n + e) * 32] * w[e >> 1];
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(hopper::kFull, l[i], 1);
    l[i] += __shfl_xor_sync(hopper::kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= q_len) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const float inv_l = 1.f / safe_l;
    const long long off = static_cast<long long>(bh) * q_len + row;
    if (lse != nullptr && t == 0) {
      lse[off] = l[i] == 0.f ? kNegInf : m[i] + logf(safe_l);
    }
    float* orow = out + off * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<float2*>(orow + 8 * n) =
            make_float2(o[n][2 * i] * inv_l, o[n][2 * i + 1] * inv_l);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch(const dim3& grid, int warps, int splits, size_t bytes,
                   cudaStream_t stream, const float* q, const float* k,
                   const float* v, const uint8_t* kv_valid, float* out,
                   float* lse, Strides qs, Strides ks, Strides vs, int heads,
                   int q_len, int kv_len, int head_dim, int causal,
                   float scale) {
  cudaError_t err = hopper::allow_smem(flash_fwd_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, kv_valid, out, lse, qs, ks, vs, heads, q_len, kv_len,
      head_dim, causal, scale, splits);
  return cudaGetLastError();
}


// -- bf16 ----------------------------------------------------------------------
//
// The bf16 instantiation: q/k/v/out bf16, lse float32, the online softmax
// in float32. S = Q K^T and O += P V on mma.sync m16n8k16 with bf16
// operands and float32 accumulators (hopper_mma.cuh); P is rounded to bf16
// when it becomes the A operand of P V, as _flash_kernel rounds it
// (p.astype(v.dtype)) before its product, while l sums the unrounded
// float32 p, as the reference's l does. The design is the fp32 kernel's:
// the same blocks, splits, bitmap, live-tile list, causal walk, merge and
// one-row launch rule; only the products and the row layout differ. Rows
// sit in shared memory at D_PAD + 8 bf16 (4 mod 32 words). The head dim
// goes in k-steps of 16: a row's columns past d up to the next multiple of
// 16 are zero-filled by the copies, so d only has to be a multiple of 8.

using bf16 = __nv_bfloat16;

// Dynamic shared memory of the bf16 forward: fwd_smem_bytes' pieces with
// bf16 rows of D_PAD + 8 (ops/hopper_attention.fwd_smem_bytes mirrors
// both).
size_t fwd_bf16_smem_bytes(int warps, int splits, int d_pad, int kv_len) {
  const int stride = d_pad + 8;
  const int tiles = (kv_len + kBlockK - 1) / kBlockK;
  return sizeof(bf16) * (16 * (warps / splits) * stride +
                         2 * splits * 2 * kBlockK * stride) +
         2 * sizeof(uint32_t) * tiles;
}

template <int D_PAD>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const uint8_t* __restrict__ kv_valid,
                      bf16* __restrict__ out, float* __restrict__ lse,
                      Strides qs, Strides ks, Strides vs, int heads,
                      int q_len, int kv_len, int head_dim, int causal,
                      float scale, int splits) {
  constexpr int S = D_PAD + 8;     // shared row stride in bf16, 4 mod 32 words
  constexpr int KD = D_PAD / 8;    // 8-wide output column tiles
  constexpr int KS = D_PAD / 16;   // 16-wide head-dim k-steps
  constexpr int NK = kBlockK / 8;  // 8-key n-tiles per tile
  constexpr int TILE = kBlockK * S;
  extern __shared__ __align__(16) unsigned char fwd_bf16_smem[];
  const int warps = blockDim.x >> 5;
  const int row_warps = warps / splits;
  const int rows = 16 * row_warps;
  bf16* q_s = reinterpret_cast<bf16*>(fwd_bf16_smem);  // [rows][S]
  bf16* kv_s = q_s + rows * S;  // [2][splits][2][kBlockK][S]
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
      const long long src = in ? kj * ks.s + col : 0;
      const long long vsrc = in ? kj * vs.s + col : 0;
      hopper::cp_async16(kd_s + j * S + col, kb + src, in);
      hopper::cp_async16(vd_s + j * S + col, vb + vsrc, in);
    }
  };

  for (int i = threadIdx.x; i < rows * chunks; i += blockDim.x) {
    const int r = i / chunks;
    const int col = (i - r * chunks) << 3;
    const int qi = q0 + r;
    const bool in = qi < q_len && col < d;
    hopper::cp_async16(q_s + r * S + col, qb + (in ? qi * qs.s + col : 0), in);
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
  const int n_steps = n_tiles > 0 ? 1 + (n_live + splits - 1) / splits : 0;
  auto step_tile = [&](int step, int c) {
    if (step == 0) return c < n_tiles ? c : -1;
    const int i = (step - 1) * splits + c;
    return i < n_live ? live_s[i] : -1;
  };

  const int r0 = q0 + 16 * rw;
  const bool warp_live = r0 < q_len;
  const int row_a = r0 + g;
  const int row_b = row_a + 8;
  const int warp_last = min(r0 + 15, q_len - 1);

  uint32_t qf[KS][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float o[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int buf = 0;
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
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

    if (step == 0 && warp_live) {  // Q fragments, once per block
      const bf16* qr = q_s + (16 * rw + g) * S + 2 * t;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ks16) hopper::frag_a_bf16(qf[s], qr + 16 * s, S);
      }
    }

    const int tile = step_tile(step, sp);
    const int k0 = tile * kBlockK;
    if (tile >= 0 && warp_live && bits_s[tile] != 0u &&
        (!causal || k0 <= warp_last + offset)) {
      const bf16* kt = kv_s + ((buf * splits + sp) * 2) * TILE;
      const bf16* vt = kt + TILE;
      const unsigned word = bits_s[tile];

      // S = Q K^T over this tile: NK n-tiles of 8 keys, k-steps of 16.
      float s_acc[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        s_acc[n][0] = s_acc[n][1] = s_acc[n][2] = s_acc[n][3] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s < ks16) {
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            const bf16* kr = kt + (8 * n + g) * S + 16 * s + 2 * t;
            const uint32_t kf[2] = {hopper::ld_bf16x2(kr), hopper::ld_bf16x2(kr + 8)};
            hopper::mma_bf16(s_acc[n], qf[s], kf);
          }
        }
      }

      // Masks and the online softmax, as the fp32 kernel's.
      unsigned ok_bits = 0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 8 * n + 2 * t + (e & 1);
          const int row = e < 2 ? row_a : row_b;
          bool ok = (word >> j) & 1u;
          if (causal) ok = ok && (k0 + j <= row + offset);
          if (ok) ok_bits |= 1u << (4 * n + e);
          s_acc[n][e] = ok ? s_acc[n][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], s_acc[n][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(hopper::kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(hopper::kFull, mx[i], 2));
      }
      const float alpha[2] = {expf(m[0] - mx[0]), expf(m[1] - mx[1])};
      m[0] = mx[0];
      m[1] = mx[1];
      l[0] *= alpha[0];
      l[1] *= alpha[1];
#pragma unroll
      for (int n = 0; n < NK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = (ok_bits >> (4 * n + e)) & 1u
                              ? expf(s_acc[n][e] - mx[e >> 1])
                              : 0.f;
          s_acc[n][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: k-steps of 16 keys (two of P's accumulator fragments,
      // rounded to bf16, are the A operand), n-tiles of 8 columns; V's
      // B operand is read down its columns (rows 2t, 2t + 1, +8, +9).
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) {
        uint32_t pa[4];
        hopper::frag_a_from_c(pa, s_acc[2 * j], s_acc[2 * j + 1]);
        const bf16* vr = vt + (16 * j + 2 * t) * S + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          if (n < kd) {
            const uint32_t vf[2] = {hopper::ld_bf16_col2(vr + 8 * n, S),
                                    hopper::ld_bf16_col2(vr + 8 * S + 8 * n, S)};
            hopper::mma_bf16(o[n], pa, vf);
          }
        }
      }
    }
    __syncthreads();
    buf ^= 1;
  }
  hopper::cp_async_wait<0>();

  // The key splits of one row group merge into its first warp, in split
  // order, through the (now idle) K/V buffers.
  if (splits > 1) {
    constexpr int STATE = 4 + 4 * KD;
    float* state_s = reinterpret_cast<float*>(kv_s);
    if (sp > 0) {
      float* st = state_s + ((sp - 1) * row_warps + rw) * 32 * STATE + lane;
      st[0] = m[0];
      st[32] = m[1];
      st[64] = l[0];
      st[96] = l[1];
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) st[(4 + 4 * n + e) * 32] = o[n][e];
      }
    }
    __syncthreads();
    if (sp > 0) return;
    for (int c = 1; c < splits; ++c) {
      const float* sc = state_s + ((c - 1) * row_warps + rw) * 32 * STATE + lane;
      float a[2], w[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float mc = sc[32 * i];
        const float mn = fmaxf(m[i], mc);
        a[i] = expf(m[i] - mn);
        w[i] = expf(mc - mn);
        l[i] = l[i] * a[i] + sc[64 + 32 * i] * w[i];
        m[i] = mn;
      }
#pragma unroll
      for (int n = 0; n < KD; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[n][e] = o[n][e] * a[e >> 1] + sc[(4 + 4 * n + e) * 32] * w[e >> 1];
        }
      }
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(hopper::kFull, l[i], 1);
    l[i] += __shfl_xor_sync(hopper::kFull, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? row_a : row_b;
    if (row >= q_len) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    const float inv_l = 1.f / safe_l;
    const long long off = static_cast<long long>(bh) * q_len + row;
    if (lse != nullptr && t == 0) {
      lse[off] = l[i] == 0.f ? kNegInf : m[i] + logf(safe_l);
    }
    bf16* orow = out + off * d + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n) {
      if (n < kd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[n][2 * i] * inv_l, o[n][2 * i + 1] * inv_l);
      }
    }
  }
}

template <int D_PAD>
cudaError_t launch_bf16(const dim3& grid, int warps, int splits, size_t bytes,
                        cudaStream_t stream, const bf16* q, const bf16* k,
                        const bf16* v, const uint8_t* kv_valid, bf16* out,
                        float* lse, Strides qs, Strides ks, Strides vs,
                        int heads, int q_len, int kv_len, int head_dim,
                        int causal, float scale) {
  cudaError_t err = hopper::allow_smem(flash_fwd_bf16_kernel<D_PAD>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D_PAD><<<grid, 32 * warps, bytes, stream>>>(
      q, k, v, kv_valid, out, lse, qs, ks, vs, heads, q_len, kv_len,
      head_dim, causal, scale, splits);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). q/k/v are [B, H, S, d] fp32
// with the head dim contiguous, every row start 16-byte aligned, and the
// other strides given in elements; kv_valid is [B, Sk] bytes (0 = masked)
// or null; out is a contiguous [B, H, Sq, d] fp32 tensor; lse is a
// contiguous [B, H, Sq] fp32 tensor or null. `warps` (1, 2 or 4) is the
// warps per block, `splits` (1 or 2, dividing warps) how many of them share
// out the key tiles of one 16-row group, `d_pad` (64 or 128) the
// instantiation, with d a multiple of 8 and d <= d_pad; anything else is
// refused with cudaErrorInvalidValue. Launches on `stream` and returns
// cudaGetLastError() — nonzero means the launch was refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int batch, int heads, int q_len, int kv_len,
    int head_dim, int causal, float scale, int warps, int splits, int d_pad,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > d_pad ||
      (d_pad != 64 && d_pad != 128) ||
      (warps != 1 && warps != 2 && warps != 4) ||
      (splits != 1 && splits != 2) || warps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const size_t bytes = fwd_smem_bytes(warps, splits, d_pad, kv_len);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * (warps / splits);
  const dim3 grid((q_len + rows - 1) / rows, batch * heads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const float*>(q);
  const auto kp = static_cast<const float*>(k);
  const auto vp = static_cast<const float*>(v);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto op = static_cast<float*>(out);
  const auto lp = static_cast<float*>(lse);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const cudaError_t err =
      d_pad == 64
          ? launch<64>(grid, warps, splits, bytes, s, qp, kp, vp, valid, op,
                       lp, qs, ks, vs, heads, q_len, kv_len, head_dim,
                       causal, scale)
          : launch<128>(grid, warps, splits, bytes, s, qp, kp, vp, valid, op,
                        lp, qs, ks, vs, heads, q_len, kv_len, head_dim,
                        causal, scale);
  return static_cast<int>(err);
}

// The bf16 instantiation's entry point: flash_attention_fwd's arguments
// and checks, with q/k/v/out bf16 (every row start 16-byte aligned, the
// strides in elements) and lse float32.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* kv_valid,
    void* out, void* lse, int batch, int heads, int q_len, int kv_len,
    int head_dim, int causal, float scale, int warps, int splits, int d_pad,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, void* stream) {
  if (head_dim < 8 || head_dim % 8 != 0 || head_dim > d_pad ||
      (d_pad != 64 && d_pad != 128) ||
      (warps != 1 && warps != 2 && warps != 4) ||
      (splits != 1 && splits != 2) || warps % splits != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || heads == 0 || q_len == 0) return 0;
  const size_t bytes = fwd_bf16_smem_bytes(warps, splits, d_pad, kv_len);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 16 * (warps / splits);
  const dim3 grid((q_len + rows - 1) / rows, batch * heads);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto qp = static_cast<const bf16*>(q);
  const auto kp = static_cast<const bf16*>(k);
  const auto vp = static_cast<const bf16*>(v);
  const auto valid = static_cast<const uint8_t*>(kv_valid);
  const auto op = static_cast<bf16*>(out);
  const auto lp = static_cast<float*>(lse);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss};
  const cudaError_t err =
      d_pad == 64
          ? launch_bf16<64>(grid, warps, splits, bytes, s, qp, kp, vp, valid,
                            op, lp, qs, ks, vs, heads, q_len, kv_len,
                            head_dim, causal, scale)
          : launch_bf16<128>(grid, warps, splits, bytes, s, qp, kp, vp, valid,
                             op, lp, qs, ks, vs, heads, q_len, kv_len,
                             head_dim, causal, scale);
  return static_cast<int>(err);
}
