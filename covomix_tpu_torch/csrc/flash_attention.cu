// Flash attention for Hopper (sm_90a), with a per-row key-prefix mask
// (valid_len), an optional causal mask and optional in-kernel halfsplit
// rotary: the forward (with an optional per-row logsumexp output) and the two
// backward kernels.
//
// Replaces, in covomix_tpu/ops/flash_attention.py:
//   * `_flash_kernel` (reached through `_flash_forward`) in all its forms:
//     non-causal or causal, fused halfsplit rotary or none, valid_len of
//     shape [1] or [B], with or without the logsumexp output the training
//     backward reads;
//   * `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel` (reached through
//     `_flash_backward`): dQ, and dK / dV, from the saved logsumexp, also
//     causal.
//
// A key j is live for query row i when j < valid_len[b] and, in the causal
// form (the T2S training decoder; queries and keys share one T), j <= i.
// Forward: out[b,h,i] = sum_j softmax_j(s_ij) v[b,h,j], with
//   s_ij = <rot(q_i), rot(k_j)> * dh^-0.5 and dead keys set to -1e30 before
//   the exp (valid_len clamped to [1, T] by the caller);
//   out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)) (f32 [B, H, T]),
//   the TPU kernel's arithmetic.
// Backward (q, k already rotated by the caller; delta = rowsum(dO * O) in f32):
//   p_ij = exp(where(live_ij, s_ij, -1e30) - lse_i)   (0 for dead pairs)
//   ds_ij = p_ij * (dO_i . v_j - delta_i), rounded to the input type
//   dq_i = scale * sum_j ds_ij k_j
//   dv_j = sum_i bf16(p_ij) dO_i,   dk_j = scale * sum_i ds_ij q_i
// Every query row < T takes part in dK / dV, also rows past valid_len (as on
// the TPU; causal: every row i >= j); key rows past valid_len get exact zeros.
//
// Causal is a template argument, so the non-causal kernels compile to the
// code they had before the causal form existed (a run-time flag costs
// registers, and a register more can cost a resident block per SM). The
// causal kernels skip the tiles that hold no live pair: the forward and dQ
// stop the key loop at the block's last query row, dK/dV starts the query
// loop at the tile of the block's first key. That is exact, not an
// approximation: key 0 is live for every row, so the first tile gives a
// finite running max, and a skipped tile would only add exp(-1e30 - m) = 0
// (forward) or p = 0 (backward). It halves the work.
//
// What bounds it on the card: at the training shape [8, 16, 832, 64] bf16 the
// forward does 4*B*H*T^2*dh = 22.7 GFLOP, dQ 6x and dK/dV 8x that over
// B*H*T^2*dh, against 54-82 MB of q/k/v/dO/out/lse/delta traffic: all three
// are bound by the tensor cores, not by memory. The TPU kernels held whole key
// rows in VMEM and carried sums across a sequential grid; an SM has 227 KB of
// shared memory and blocks run in parallel with nothing carried between them.
// So every kernel here owns one (b, h, row tile) and walks 64-wide tiles of
// the other axis through shared memory:
//   * forward: 64 query rows per block, online softmax (running max m,
//     running sum l, rescaled accumulator), the [T, T] scores never written;
//   * dQ: one block per 64 query rows walks the key tiles below valid_len,
//     recomputing s and p from lse;
//   * dK/dV: one block per 64 key rows walks every query tile.
// Keeping the TPU's two-kernel split means no block writes what another
// block writes: there are no atomics, and the gradients are deterministic.
// The products run on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
// accumulate); p and ds are re-packed in registers as A operands (no shared
// memory round trip); the B operands that need the other orientation (K for
// dQ, Q and dO for dK/dV, V for the forward) are stored transposed in shared
// memory. Head dims above 64 split each 16-row group's output columns over
// two warps (32 rows per block) so the f32 accumulators stay in registers,
// and above 128 the A fragments are read from shared memory instead of being
// held in registers. No TMA, wgmma or double buffering yet: this is the
// simple, right version.
//
// f32 inputs (tests, comparisons) take scalar-FMA kernels with the same
// masking and the same arithmetic in f32, one row per thread.
//
// Rotary: rot(x)[j] = x[j]*cos[j] + x[(j+d)%dh]*sin_signed[j], two f32
// products and one f32 sum, each rounded (no FMA contraction), then rounded
// once to the input type: the same operations as the plain version's
// `_rotary_plain`, so the backward's re-rotation in PyTorch gives the very
// scores the forward's lse was computed on.
//
// One library per head dim: build with -DFLASH_DH=<dh>, a multiple of 16 (the
// mma k-step) in [16, 256] (the dispatch rule's limit).
//
// C interface (ctypes): each covomix_flash_attention_* function returns the
// CUDA error code of its launch (0 on success), -1 for a head dim other than
// the one the library was built for.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef FLASH_DH
#error "build with -DFLASH_DH=<head dim>"
#endif
static_assert(FLASH_DH % 16 == 0 && FLASH_DH >= 16 && FLASH_DH <= 256,
              "FLASH_DH must be a multiple of 16 in [16, 256]");

namespace {

constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of one 16-wide k step from a row-major shared-memory tile:
// `p` points at (fragment row qr, column qc) of the warp's 16 rows.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p, int ld, int ks) {
  a[0] = ld32(p + ks * 16);
  a[1] = ld32(p + 8 * ld + ks * 16);
  a[2] = ld32(p + ks * 16 + 8);
  a[3] = ld32(p + 8 * ld + ks * 16 + 8);
}

// The C fragments of two adjacent 8-column tiles (c0 = columns 16kk..16kk+7,
// c1 = the next 8) as the A fragment of one 16-wide k step, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4], const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Copy rows [r0, r0+ROWS) of a [T, DH] bf16 matrix into shared memory with
// row stride LD (elements); rows past T are zero. 16-byte vector loads.
template <int ROWS, int DH, int LD, int NT>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int r0, int T) {
  constexpr int VPR = DH / 8;  // uint4 vectors per row
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// load_rows_bf16 that also stores the tile transposed, [DH][LT] (the B
// operand of a product over the rows). A function of its own: folding the
// transposed copy into load_rows_bf16 behind a null check raised the
// forward's register count enough to cost it a resident block per SM.
template <int ROWS, int DH, int LD, int NT, int LT>
__device__ __forceinline__ void load_rows_bf16_t(__nv_bfloat16* dst, __nv_bfloat16* dst_t,
                                                 const __nv_bfloat16* src, int r0, int T) {
  constexpr int VPR = DH / 8;
  for (int idx = threadIdx.x; idx < ROWS * VPR; idx += NT) {
    const int r = idx / VPR, c = (idx % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst_t[(c + i) * LT + r] = e[i];
  }
}

// In-place halfsplit rotary on shared-memory rows holding positions r0+r:
// x'[j] = x[j]*cos[j] + x[(j+d)%DH]*sin_signed[j], with both products and the
// sum rounded in f32 (no FMA) and one rounding to TT. Each thread owns a
// (j, j+d) pair, so in-place is safe.
template <int ROWS, int DH, int LD, int NT, typename TT>
__device__ __forceinline__ void rotate_rows(TT* tile, const TT* cos_t, const TT* sin_t,
                                            int r0, int T) {
  constexpr int D = DH / 2;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NT) {
    const int r = idx / D, j = idx % D, t = r0 + r;
    if (t >= T) continue;
    const float a = (float)tile[r * LD + j], b = (float)tile[r * LD + j + D];
    const TT* c = cos_t + (size_t)t * DH;
    const TT* s = sin_t + (size_t)t * DH;
    tile[r * LD + j] = (TT)__fadd_rn(__fmul_rn(a, (float)c[j]), __fmul_rn(b, (float)s[j]));
    tile[r * LD + j + D] = (TT)__fadd_rn(__fmul_rn(b, (float)c[j + D]), __fmul_rn(a, (float)s[j + D]));
  }
}

__device__ __forceinline__ int clamp_valid(const int* valid, int valid_n, int b, int T) {
  const int vl = valid[valid_n == 1 ? 0 : b];
  return min(max(vl, 1), T);
}

// ---------------------------------------------------------------------------
// forward

template <int DH>
struct Bf16Cfg {
  static constexpr int BM = 64, BN = 64, NT = 128;  // 4 warps x 16 query rows
  static constexpr int LQ = DH + 8;                  // padded row stride (q, k)
  static constexpr int LV = BN + 8;                  // padded row stride (v^T)
  static constexpr size_t smem = (size_t)(BM * LQ + BN * LQ + DH * LV) * 2;
};

// LSE: write the per-row logsumexp (the training form). A template argument,
// so that the inference form compiles to the code it had before the lse
// output existed. CAUSAL: also mask key j > query i.
template <int DH, bool LSE, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ valid, int valid_n,
               const __nv_bfloat16* __restrict__ cos_t, const __nv_bfloat16* __restrict__ sin_t,
               int H, int T, float scale) {
  using C = Bf16Cfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT, LQ = C::LQ, LV = C::LV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LQ]
  __nv_bfloat16* Ks = Qs + BM * LQ;                                 // [BN][LQ]
  __nv_bfloat16* Vt = Ks + BN * LQ;                                 // [DH][LV]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const size_t base = ((size_t)b * H + h) * (size_t)T * DH;
  int vl = valid[valid_n == 1 ? 0 : b];
  vl = min(max(vl, 1), T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;  // fragment row / column pair

  load_rows_bf16<BM, DH, LQ, NT>(Qs, q + base, q0, T);
  __syncthreads();
  if (cos_t != nullptr) {
    rotate_rows<BM, DH, LQ, NT>(Qs, cos_t, sin_t, q0, T);
    __syncthreads();
  }
  uint32_t qf[DH / 16][4];
  {
    const __nv_bfloat16* qw = Qs + (warp * 16 + qr) * LQ + qc;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      qf[ks][0] = ld32(qw + ks * 16);
      qf[ks][1] = ld32(qw + 8 * LQ + ks * 16);
      qf[ks][2] = ld32(qw + ks * 16 + 8);
      qf[ks][3] = ld32(qw + 8 * LQ + ks * 16 + 8);
    }
  }

  float acc[DH / 8][4];
#pragma unroll
  for (int i = 0; i < DH / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;  // rows qr and qr+8
  // the live keys of the rows qr and qr+8 are j < lim0 / lim1 (the rows'
  // indices are computed again for the epilogue: holding them across the
  // loop cost the non-causal forms 18-32 registers)
  int lim0 = vl, lim1 = vl;
  if constexpr (CAUSAL) {
    const int r0 = q0 + warp * 16 + qr;
    lim0 = min(vl, r0 + 1);
    lim1 = min(vl, r0 + 9);
  }

  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the previous tile is consumed
    load_rows_bf16<BN, DH, LQ, NT>(Ks, k + base, k0, T);
    for (int idx = threadIdx.x; idx < BN * (DH / 8); idx += NT) {  // v tile, transposed
      const int r = idx / (DH / 8), c = (idx % (DH / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (k0 + r < T) val = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * DH + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(c + i) * LV + r] = e[i];
    }
    __syncthreads();
    if (cos_t != nullptr) {
      rotate_rows<BN, DH, LQ, NT>(Ks, cos_t, sin_t, k0, T);
      __syncthreads();
    }

    // s = q k^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + qr) * LQ + qc;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks)
        mma_bf16(s[nt], qf[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = k0 + nt * 8 + qc;
      s[nt][0] = col < lim0 ? s[nt][0] * scale : kMaskValue;
      s[nt][1] = col + 1 < lim0 ? s[nt][1] * scale : kMaskValue;
      s[nt][2] = col < lim1 ? s[nt][2] * scale : kMaskValue;
      s[nt][3] = col + 1 < lim1 ? s[nt][3] * scale : kMaskValue;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - mx0);
      s[nt][1] = __expf(s[nt][1] - mx0);
      s[nt][2] = __expf(s[nt][2] - mx1);
      s[nt][3] = __expf(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
    }
    m0 = mx0;
    m1 = mx1;
    l0 = l0 * a0 + rs0;  // per-lane partial sums; the quad is summed at the end
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int dt = 0; dt < DH / 8; ++dt) {
      acc[dt][0] *= a0;
      acc[dt][1] *= a0;
      acc[dt][2] *= a1;
      acc[dt][3] *= a1;
    }
    // acc += p v: the C fragments of two adjacent 8-key tiles form the A
    // fragment of one 16-key step (p rounded to bf16, as the TPU kernel does)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt) {
        const __nv_bfloat16* vr = Vt + (dt * 8 + qr) * LV + kk * 16 + qc;
        mma_bf16(acc[dt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + qr, row1 = row0 + 8;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * DH + dt * 8 + qc) =
          __floats2bfloat162_rn(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * DH + dt * 8 + qc) =
          __floats2bfloat162_rn(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if constexpr (LSE) {
    if (qc == 0) {  // m and l are the same in the 4 lanes of a quad
      const size_t rbase = ((size_t)b * H + h) * (size_t)T;
      if (row0 < T) lse[rbase + row0] = m0 + logf(fmaxf(l0, 1e-30f));
      if (row1 < T) lse[rbase + row1] = m1 + logf(fmaxf(l1, 1e-30f));
    }
  }
}

template <int DH>
struct F32Cfg {
  static constexpr int BM = 128, BN = 32, NT = 128;  // one row per thread
  static constexpr size_t smem = (size_t)(2 * BN * DH + 2 * BN) * 4;
};

// Rows [r0, r0+BN) of two [T, DH] f32 matrices into shared memory (zero past
// T), 16-byte loads.
template <int BN, int DH, int NT>
__device__ __forceinline__ void load_pair_f32(float* a_s, float* b_s, const float* a, const float* b,
                                              int r0, int T) {
  for (int idx = threadIdx.x; idx < BN * DH / 4; idx += NT) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (r0 + r < T) {
      av = *reinterpret_cast<const float4*>(a + (size_t)(r0 + r) * DH + c);
      bv = *reinterpret_cast<const float4*>(b + (size_t)(r0 + r) * DH + c);
    }
    *reinterpret_cast<float4*>(a_s + r * DH + c) = av;
    *reinterpret_cast<float4*>(b_s + r * DH + c) = bv;
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              const int* __restrict__ valid, int valid_n,
              const float* __restrict__ cos_t, const float* __restrict__ sin_t,
              int H, int T, float scale) {
  using C = F32Cfg<DH>;
  constexpr int BN = C::BN, NT = C::NT, D = DH / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BN][DH]
  float* Vs = Ks + BN * DH;                        // [BN][DH]

  const int b = blockIdx.z, h = blockIdx.y;
  const size_t base = ((size_t)b * H + h) * (size_t)T * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int q0 = blockIdx.x * C::BM, row = q0 + threadIdx.x;
  const bool live = row < T;
  const int lim = CAUSAL ? min(vl, row + 1) : vl;  // the row's live keys are j < lim

  float qv[DH], acc[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) {
    qv[j] = live ? q[base + (size_t)row * DH + j] : 0.f;
    acc[j] = 0.f;
  }
  if (cos_t != nullptr && live) {
    const float* c = cos_t + (size_t)row * DH;
    const float* s = sin_t + (size_t)row * DH;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float a = qv[j], bb = qv[j + D];
      qv[j] = __fadd_rn(__fmul_rn(a, c[j]), __fmul_rn(bb, s[j]));
      qv[j + D] = __fadd_rn(__fmul_rn(bb, c[j + D]), __fmul_rn(a, s[j + D]));
    }
  }
  float m = kMaskValue, l = 0.f;
  const int n_tiles = ((CAUSAL ? min(vl, q0 + C::BM) : vl) + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_pair_f32<BN, DH, NT>(Ks, Vs, k + base, v + base, k0, T);
    __syncthreads();
    if (cos_t != nullptr) {
      rotate_rows<BN, DH, DH, NT>(Ks, cos_t, sin_t, k0, T);
      __syncthreads();
    }
    float s[BN];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qv[d], Ks[j * DH + d], dot);
      s[j] = (k0 + j < lim) ? dot * scale : kMaskValue;
      mx = fmaxf(mx, s[j]);
    }
    const float alpha = expf(m - mx);
    l *= alpha;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = expf(s[j] - mx);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, Vs[j * DH + d], acc[d]);
    }
    m = mx;
  }
  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DH; ++d) o[base + (size_t)row * DH + d] = acc[d] * inv;
    if (lse != nullptr) lse[((size_t)b * H + h) * (size_t)T + row] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// backward, bf16 (tensor cores)

template <int DH>
struct BwdCfg {
  static constexpr int CS = DH <= 64 ? 1 : 2;   // warps sharing one 16-row group (output column split)
  static constexpr int BM = 16 * (4 / CS);      // rows per block: query rows (dQ) or key rows (dK/dV)
  static constexpr int BN = 64, NT = 128;       // walked tile; 4 warps
  static constexpr int DC = DH / CS;            // output columns per warp
  static constexpr bool A_REGS = DH <= 128;     // A fragments held in registers (else read from smem)
  static constexpr int LR = DH + 8;             // row stride of row-major tiles
  static constexpr int LT = BN + 8;             // row stride of transposed [DH][BN] tiles
  // dQ: Q, dO [BM][LR]; K, V [BN][LR]; K^T [DH][LT]
  static constexpr size_t smem_dq = (size_t)(2 * BM * LR + 2 * BN * LR + DH * LT) * 2;
  // dK/dV: K, V [BM][LR]; Q, dO [BN][LR]; Q^T, dO^T [DH][LT]; lse, delta [BN] f32
  static constexpr size_t smem_dkv = (size_t)(2 * BM * LR + 2 * BN * LR + 2 * DH * LT) * 2 + 2 * BN * 4;
};

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, const int* __restrict__ valid, int valid_n,
                  int H, int T, float scale) {
  using C = BwdCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT, LR = C::LR, LT = C::LT, CS = C::CS, DC = C::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LR]
  __nv_bfloat16* Ds = Qs + BM * LR;                                 // dO [BM][LR]
  __nv_bfloat16* Ks = Ds + BM * LR;                                 // [BN][LR]
  __nv_bfloat16* Vs = Ks + BN * LR;                                 // [BN][LR]
  __nv_bfloat16* Kt = Vs + BN * LR;                                 // [DH][LT]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const size_t rbase = ((size_t)b * H + h) * (size_t)T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int rg = warp / CS, c0 = (warp % CS) * DC;  // 16-row group, first output column

  load_rows_bf16<BM, DH, LR, NT>(Qs, q + base, q0, T);
  load_rows_bf16<BM, DH, LR, NT>(Ds, dout + base, q0, T);
  __syncthreads();
  const __nv_bfloat16* qa = Qs + (rg * 16 + qr) * LR + qc;
  const __nv_bfloat16* da = Ds + (rg * 16 + qr) * LR + qc;
  uint32_t qf[C::A_REGS ? DH / 16 : 1][4], df[C::A_REGS ? DH / 16 : 1][4];
  if constexpr (C::A_REGS) {
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      load_a(qf[ks], qa, LR, ks);
      load_a(df[ks], da, LR, ks);
    }
  }
  const int row0 = q0 + rg * 16 + qr, row1 = row0 + 8;
  const float lse0 = row0 < T ? lse[rbase + row0] : 0.f, lse1 = row1 < T ? lse[rbase + row1] : 0.f;
  const float dl0 = row0 < T ? delta[rbase + row0] : 0.f, dl1 = row1 < T ? delta[rbase + row1] : 0.f;
  int lim0 = vl, lim1 = vl;  // the live keys of rows row0 / row1 are j < lim
  if constexpr (CAUSAL) {
    lim0 = min(vl, row0 + 1);
    lim1 = min(vl, row1 + 1);
  }

  float acc[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // tiles wholly past valid_len (causal: past the block's last row) hold only p = 0
  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_rows_bf16_t<BN, DH, LR, NT, LT>(Ks, Kt, k + base, k0, T);
    load_rows_bf16<BN, DH, LR, NT>(Vs, v + base, k0, T);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this warp's 16 rows x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (nt * 8 + qr) * LR + qc;
      const __nv_bfloat16* vr = Vs + (nt * 8 + qr) * LR + qc;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        if constexpr (C::A_REGS) {
          mma_bf16(s[nt], qf[ks], ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
          mma_bf16(dp[nt], df[ks], ld32(vr + ks * 16), ld32(vr + ks * 16 + 8));
        } else {
          uint32_t a[4];
          load_a(a, qa, LR, ks);
          mma_bf16(s[nt], a, ld32(kr + ks * 16), ld32(kr + ks * 16 + 8));
          load_a(a, da, LR, ks);
          mma_bf16(dp[nt], a, ld32(vr + ks * 16), ld32(vr + ks * 16 + 8));
        }
      }
    }
    // p = exp(s - lse) on live keys (exactly 0 on masked ones); ds = p (dp - delta)
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = k0 + nt * 8 + qc;
      const float p0 = col < lim0 ? __expf(s[nt][0] * scale - lse0) : 0.f;
      const float p1 = col + 1 < lim0 ? __expf(s[nt][1] * scale - lse0) : 0.f;
      const float p2 = col < lim1 ? __expf(s[nt][2] * scale - lse1) : 0.f;
      const float p3 = col + 1 < lim1 ? __expf(s[nt][3] * scale - lse1) : 0.f;
      s[nt][0] = p0 * (dp[nt][0] - dl0);
      s[nt][1] = p1 * (dp[nt][1] - dl0);
      s[nt][2] = p2 * (dp[nt][2] - dl1);
      s[nt][3] = p3 * (dp[nt][3] - dl1);
    }
    // dq += ds k (ds rounded to bf16, as the TPU kernel does)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dt = 0; dt < DC / 8; ++dt) {
        const __nv_bfloat16* kr = Kt + (c0 + dt * 8 + qr) * LT + kk * 16 + qc;
        mma_bf16(acc[dt], pa, ld32(kr), ld32(kr + 8));
      }
    }
  }
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt) {
    const int col = c0 + dt * 8 + qc;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row0 * DH + col) =
          __floats2bfloat162_rn(acc[dt][0] * scale, acc[dt][1] * scale);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(dq + base + (size_t)row1 * DH + col) =
          __floats2bfloat162_rn(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                   const int* __restrict__ valid, int valid_n, int H, int T, float scale) {
  using C = BwdCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT, LR = C::LR, LT = C::LT, CS = C::CS, DC = C::DC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][LR]
  __nv_bfloat16* Vs = Ks + BM * LR;                                 // [BM][LR]
  __nv_bfloat16* Qs = Vs + BM * LR;                                 // [BN][LR]
  __nv_bfloat16* Ds = Qs + BN * LR;                                 // dO [BN][LR]
  __nv_bfloat16* Qt = Ds + BN * LR;                                 // [DH][LT]
  __nv_bfloat16* Dt = Qt + DH * LT;                                 // dO^T [DH][LT]
  float* Ls = reinterpret_cast<float*>(Dt + DH * LT);               // lse [BN]
  float* Es = Ls + BN;                                              // delta [BN]

  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BM;
  const size_t rbase = ((size_t)b * H + h) * (size_t)T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const int rg = warp / CS, c0 = (warp % CS) * DC;
  const int key0 = k0 + rg * 16 + qr, key1 = key0 + 8;
  const bool live0 = key0 < vl, live1 = key1 < vl;

  float ak[DC / 8][4], av[DC / 8][4];  // dk, dv accumulators
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) {
    ak[i][0] = ak[i][1] = ak[i][2] = ak[i][3] = 0.f;
    av[i][0] = av[i][1] = av[i][2] = av[i][3] = 0.f;
  }

  if (k0 < vl) {  // a block wholly past valid_len writes exact zeros
    load_rows_bf16<BM, DH, LR, NT>(Ks, k + base, k0, T);
    load_rows_bf16<BM, DH, LR, NT>(Vs, v + base, k0, T);
    __syncthreads();
    const __nv_bfloat16* ka = Ks + (rg * 16 + qr) * LR + qc;
    const __nv_bfloat16* va = Vs + (rg * 16 + qr) * LR + qc;
    uint32_t kf[C::A_REGS ? DH / 16 : 1][4], vf[C::A_REGS ? DH / 16 : 1][4];
    if constexpr (C::A_REGS) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        load_a(kf[ks], ka, LR, ks);
        load_a(vf[ks], va, LR, ks);
      }
    }

    // every query row takes part (causal: from the tile of the block's first key on)
    const int n_tiles = (T + BN - 1) / BN;
    for (int it = CAUSAL ? k0 / BN : 0; it < n_tiles; ++it) {
      const int i0 = it * BN;
      __syncthreads();
      load_rows_bf16_t<BN, DH, LR, NT, LT>(Qs, Qt, q + base, i0, T);
      load_rows_bf16_t<BN, DH, LR, NT, LT>(Ds, Dt, dout + base, i0, T);
      for (int j = threadIdx.x; j < BN; j += NT) {
        Ls[j] = i0 + j < T ? lse[rbase + i0 + j] : 0.f;
        Es[j] = i0 + j < T ? delta[rbase + i0 + j] : 0.f;
      }
      __syncthreads();

      // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x BN queries
      float st[BN / 8][4], dpt[BN / 8][4];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
        dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
        const __nv_bfloat16* qrow = Qs + (nt * 8 + qr) * LR + qc;
        const __nv_bfloat16* drow = Ds + (nt * 8 + qr) * LR + qc;
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          if constexpr (C::A_REGS) {
            mma_bf16(st[nt], kf[ks], ld32(qrow + ks * 16), ld32(qrow + ks * 16 + 8));
            mma_bf16(dpt[nt], vf[ks], ld32(drow + ks * 16), ld32(drow + ks * 16 + 8));
          } else {
            uint32_t a[4];
            load_a(a, ka, LR, ks);
            mma_bf16(st[nt], a, ld32(qrow + ks * 16), ld32(qrow + ks * 16 + 8));
            load_a(a, va, LR, ks);
            mma_bf16(dpt[nt], a, ld32(drow + ks * 16), ld32(drow + ks * 16 + 8));
          }
        }
      }
      // p^T = exp(s^T - lse) on live keys and query rows < T (causal: and
      // query row >= key row); ds^T = p^T (dp^T - delta)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = nt * 8 + qc, qi = i0 + col;
        const bool ok0 = qi < T, ok1 = qi + 1 < T;
        const float la = Ls[col], lb = Ls[col + 1], ea = Es[col], eb = Es[col + 1];
        const float p0 = live0 && ok0 && (!CAUSAL || qi >= key0) ? __expf(st[nt][0] * scale - la) : 0.f;
        const float p1 = live0 && ok1 && (!CAUSAL || qi + 1 >= key0) ? __expf(st[nt][1] * scale - lb) : 0.f;
        const float p2 = live1 && ok0 && (!CAUSAL || qi >= key1) ? __expf(st[nt][2] * scale - la) : 0.f;
        const float p3 = live1 && ok1 && (!CAUSAL || qi + 1 >= key1) ? __expf(st[nt][3] * scale - lb) : 0.f;
        st[nt][0] = p0;
        st[nt][1] = p1;
        st[nt][2] = p2;
        st[nt][3] = p3;
        dpt[nt][0] = p0 * (dpt[nt][0] - ea);
        dpt[nt][1] = p1 * (dpt[nt][1] - eb);
        dpt[nt][2] = p2 * (dpt[nt][2] - ea);
        dpt[nt][3] = p3 * (dpt[nt][3] - eb);
      }
      // dv += bf16(p^T) dO, dk += bf16(ds^T) q
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t pa[4], sa[4];
        pack_a(pa, st[2 * kk], st[2 * kk + 1]);
        pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dt = 0; dt < DC / 8; ++dt) {
          const int r = (c0 + dt * 8 + qr) * LT + kk * 16 + qc;
          mma_bf16(av[dt], pa, ld32(Dt + r), ld32(Dt + r + 8));
          mma_bf16(ak[dt], sa, ld32(Qt + r), ld32(Qt + r + 8));
        }
      }
    }
  }
#pragma unroll
  for (int dt = 0; dt < DC / 8; ++dt) {
    const int col = c0 + dt * 8 + qc;
    if (key0 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)key0 * DH + col) =
          __floats2bfloat162_rn(ak[dt][0] * scale, ak[dt][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (size_t)key0 * DH + col) =
          __floats2bfloat162_rn(av[dt][0], av[dt][1]);
    }
    if (key1 < T) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + (size_t)key1 * DH + col) =
          __floats2bfloat162_rn(ak[dt][2] * scale, ak[dt][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + (size_t)key1 * DH + col) =
          __floats2bfloat162_rn(av[dt][2], av[dt][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward, f32 (scalar FMA, one row per thread)

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 const int* __restrict__ valid, int valid_n, int H, int T, float scale) {
  using C = F32Cfg<DH>;
  constexpr int BN = C::BN, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);  // [BN][DH]
  float* Vs = Ks + BN * DH;                        // [BN][DH]

  const int b = blockIdx.z, h = blockIdx.y;
  const size_t rbase = ((size_t)b * H + h) * (size_t)T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int q0 = blockIdx.x * C::BM, row = q0 + threadIdx.x;
  const bool live = row < T;
  const int lim = CAUSAL ? min(vl, row + 1) : vl;  // the row's live keys are j < lim

  float qv[DH], dov[DH], acc[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) {
    qv[j] = live ? q[base + (size_t)row * DH + j] : 0.f;
    dov[j] = live ? dout[base + (size_t)row * DH + j] : 0.f;
    acc[j] = 0.f;
  }
  const float l_r = live ? lse[rbase + row] : 0.f, d_r = live ? delta[rbase + row] : 0.f;
  const int n_tiles = ((CAUSAL ? min(vl, q0 + C::BM) : vl) + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_pair_f32<BN, DH, NT>(Ks, Vs, k + base, v + base, k0, T);
    __syncthreads();
    for (int j = 0; j < BN; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(qv[d], Ks[j * DH + d], s);
        dp = fmaf(dov[d], Vs[j * DH + d], dp);
      }
      const float p = (k0 + j < lim) ? expf(s * scale - l_r) : 0.f;
      const float ds = p * (dp - d_r);
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(ds, Ks[j * DH + d], acc[d]);
    }
  }
  if (live) {
#pragma unroll
    for (int d = 0; d < DH; ++d) dq[base + (size_t)row * DH + d] = acc[d] * scale;
  }
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                  const int* __restrict__ valid, int valid_n, int H, int T, float scale) {
  using C = F32Cfg<DH>;
  constexpr int BN = C::BN, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // [BN][DH]
  float* Ds = Qs + BN * DH;                        // dO [BN][DH]
  float* Ls = Ds + BN * DH;                        // lse [BN]
  float* Es = Ls + BN;                             // delta [BN]

  const int b = blockIdx.z, h = blockIdx.y;
  const size_t rbase = ((size_t)b * H + h) * (size_t)T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int row = blockIdx.x * C::BM + threadIdx.x;  // key row
  const bool in_t = row < T, live = row < vl;

  float kv[DH], vv[DH], ak[DH], av[DH];
#pragma unroll
  for (int j = 0; j < DH; ++j) {
    kv[j] = in_t ? k[base + (size_t)row * DH + j] : 0.f;
    vv[j] = in_t ? v[base + (size_t)row * DH + j] : 0.f;
    ak[j] = av[j] = 0.f;
  }
  // causal: the query tiles below the block's first key see none of its keys
  const int n_tiles = (T + BN - 1) / BN;
  for (int it = CAUSAL ? blockIdx.x * C::BM / BN : 0; it < n_tiles; ++it) {
    const int i0 = it * BN;
    __syncthreads();
    load_pair_f32<BN, DH, NT>(Qs, Ds, q + base, dout + base, i0, T);
    for (int j = threadIdx.x; j < BN; j += NT) {
      Ls[j] = i0 + j < T ? lse[rbase + i0 + j] : 0.f;
      Es[j] = i0 + j < T ? delta[rbase + i0 + j] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < BN; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        s = fmaf(kv[d], Qs[i * DH + d], s);
        dp = fmaf(vv[d], Ds[i * DH + d], dp);
      }
      const float p = (live && i0 + i < T && (!CAUSAL || i0 + i >= row)) ? expf(s * scale - Ls[i]) : 0.f;
      const float ds = p * (dp - Es[i]);
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        av[d] = fmaf(p, Ds[i * DH + d], av[d]);
        ak[d] = fmaf(ds, Qs[i * DH + d], ak[d]);
      }
    }
  }
  if (in_t) {
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[base + (size_t)row * DH + d] = ak[d] * scale;
      dv[base + (size_t)row * DH + d] = av[d];
    }
  }
}

// ---------------------------------------------------------------------------
// launches

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH, bool CAUSAL>
int run_fwd(int is_f32, const void* q, const void* k, const void* v, void* o, float* lse,
            const int* valid, int valid_n, const void* cos_t, const void* sin_t, int B, int H, int T,
            float scale, cudaStream_t stream) {
  if (is_f32) {
    using C = F32Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_fwd_f32<DH, CAUSAL>, C::smem);
    if (e) return e;
    flash_fwd_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, valid, valid_n, static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), H, T, scale);
  } else {
    using C = Bf16Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    auto kernel = lse != nullptr ? flash_fwd_bf16<DH, true, CAUSAL> : flash_fwd_bf16<DH, false, CAUSAL>;
    int e = allow_smem(kernel, C::smem);
    if (e) return e;
    kernel<<<grid, C::NT, C::smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, valid, valid_n,
        static_cast<const __nv_bfloat16*>(cos_t), static_cast<const __nv_bfloat16*>(sin_t), H, T,
        scale);
  }
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL>
int run_bwd_dq(int is_f32, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, const int* valid, int valid_n, int B,
               int H, int T, float scale, cudaStream_t stream) {
  if (is_f32) {
    using C = F32Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_bwd_dq_f32<DH, CAUSAL>, C::smem);
    if (e) return e;
    flash_bwd_dq_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), valid, valid_n, H, T,
        scale);
  } else {
    using C = BwdCfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_bwd_dq_bf16<DH, CAUSAL>, C::smem_dq);
    if (e) return e;
    flash_bwd_dq_bf16<DH, CAUSAL><<<grid, C::NT, C::smem_dq, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dq), valid, valid_n, H, T, scale);
  }
  return (int)cudaGetLastError();
}

template <int DH, bool CAUSAL>
int run_bwd_dkv(int is_f32, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, const int* valid,
                int valid_n, int B, int H, int T, float scale, cudaStream_t stream) {
  if (is_f32) {
    using C = F32Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_bwd_dkv_f32<DH, CAUSAL>, C::smem);
    if (e) return e;
    flash_bwd_dkv_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
        valid, valid_n, H, T, scale);
  } else {
    using C = BwdCfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_bwd_dkv_bf16<DH, CAUSAL>, C::smem_dkv);
    if (e) return e;
    flash_bwd_dkv_bf16<DH, CAUSAL><<<grid, C::NT, C::smem_dkv, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout), lse, delta,
        static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), valid, valid_n, H, T, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o (and dout/dq/dk/dv): contiguous [B, H, T, dh], bf16 (is_f32 == 0)
// or f32 (is_f32 == 1), 16-byte aligned. lse, delta: contiguous f32 [B, H, T].
// valid: int32 device array of valid_n (1 or B) entries. cos_t/sin_t:
// [>= T, dh] rotary tables of the input type, or both null. lse may be null
// in the forward (no logsumexp output). causal != 0 picks the causal
// instantiation (key j <= query i).
int covomix_flash_attention_fwd(int is_f32, int causal, const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* valid, int valid_n, const void* cos_t,
                                const void* sin_t, int B, int H, int T, int dh, float scale,
                                void* stream) {
  if (dh != FLASH_DH) return -1;
  auto run = causal ? run_fwd<FLASH_DH, true> : run_fwd<FLASH_DH, false>;
  return run(is_f32, q, k, v, o, lse, valid, valid_n, cos_t, sin_t, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

int covomix_flash_attention_bwd_dq(int is_f32, int causal, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta, void* dq,
                                   const int* valid, int valid_n, int B, int H, int T, int dh,
                                   float scale, void* stream) {
  if (dh != FLASH_DH) return -1;
  auto run = causal ? run_bwd_dq<FLASH_DH, true> : run_bwd_dq<FLASH_DH, false>;
  return run(is_f32, q, k, v, dout, lse, delta, dq, valid, valid_n, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

int covomix_flash_attention_bwd_dkv(int is_f32, int causal, const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta, void* dk,
                                    void* dv, const int* valid, int valid_n, int B, int H, int T,
                                    int dh, float scale, void* stream) {
  if (dh != FLASH_DH) return -1;
  auto run = causal ? run_bwd_dkv<FLASH_DH, true> : run_bwd_dkv<FLASH_DH, false>;
  return run(is_f32, q, k, v, dout, lse, delta, dk, dv, valid, valid_n, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

const char* covomix_cuda_error_string(int code) {
  if (code == -1) return "head dim differs from the FLASH_DH this library was built for";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
