// Flash-attention forward for Hopper (sm_90a), non-causal, with a per-row
// key-prefix mask (valid_len) and optional in-kernel halfsplit rotary.
//
// Replaces: the forward Pallas kernel `_flash_kernel` of
// covomix_tpu/ops/flash_attention.py (reached through `_flash_forward`), in the
// form the acoustic flow model's serving path runs: non-causal, fused
// halfsplit rotary, valid_len of shape [1] or [B], no logsumexp output.
//
// Function: out[b,h,i] = sum_j softmax_j(s_ij) v[b,h,j], with
//   s_ij = <rot(q_i), rot(k_j)> * dh^-0.5 and keys j >= valid_len[b] set to
//   -1e30 before the exp (valid_len clamped to [1, T] by the caller);
//   out = acc / max(l, 1e-30), the TPU kernel's arithmetic.
//
// What bounds it on the card: at the serving shape [8, 16, 912, 64] bf16 the
// work is 4*B*H*T^2*dh = 27 GFLOP against ~60 MB of q/k/v/out traffic, so the
// bound is the tensor cores (compute), not memory. The TPU kernel held a whole
// key row in VMEM (one-shot softmax); an SM has 227 KB of shared memory and
// blocks run in parallel with nothing carried between them, so here one block
// owns (b, h, 64 query rows), walks 64-key tiles through shared memory with an
// online softmax (running max m, running sum l, rescaled accumulator), and
// never writes the [T, T] scores. The products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate); the probabilities are
// re-packed in registers as the A operand of the P.V product (no shared-memory
// round trip). Key tiles that lie wholly past valid_len are skipped: their
// exp(-1e30 - m) terms are exactly 0. No TMA, wgmma or double buffering yet:
// this is the simple, right version.
//
// f32 inputs (tests, comparisons) take a scalar-FMA kernel with the same
// masking and the same online softmax in f32.
//
// One library per head dim: build with -DFLASH_DH=<dh>, a multiple of 16 (the
// mma k-step) in [16, 256] (the dispatch rule's limit).
//
// C interface (ctypes): covomix_flash_attention_fwd(...) returns the CUDA
// error code of the launch (0 on success), -1 for a head dim other than the
// one the library was built for.

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

// In-place halfsplit rotary on shared-memory rows holding positions r0+r:
// x'[j] = x[j]*cos[j] + x[(j+d)%DH]*sin_signed[j], computed in f32 and
// rounded once. Each thread owns a (j, j+d) pair, so in-place is safe.
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
    tile[r * LD + j] = (TT)(a * (float)c[j] + b * (float)s[j]);
    tile[r * LD + j + D] = (TT)(b * (float)c[j + D] + a * (float)s[j + D]);
  }
}

template <int DH>
struct Bf16Cfg {
  static constexpr int BM = 64, BN = 64, NT = 128;  // 4 warps x 16 query rows
  static constexpr int LQ = DH + 8;                  // padded row stride (q, k)
  static constexpr int LV = BN + 8;                  // padded row stride (v^T)
  static constexpr size_t smem = (size_t)(BM * LQ + BN * LQ + DH * LV) * 2;
};

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               const int* __restrict__ valid, int valid_n,
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

  const int n_tiles = (vl + BN - 1) / BN;
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
      s[nt][0] = col < vl ? s[nt][0] * scale : kMaskValue;
      s[nt][1] = col + 1 < vl ? s[nt][1] * scale : kMaskValue;
      s[nt][2] = col < vl ? s[nt][2] * scale : kMaskValue;
      s[nt][3] = col + 1 < vl ? s[nt][3] * scale : kMaskValue;
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
}

template <int DH>
struct F32Cfg {
  static constexpr int BM = 128, BN = 32, NT = 128;  // one query row per thread
  static constexpr size_t smem = (size_t)(2 * BN * DH) * 4;
};

template <int DH>
__global__ void __launch_bounds__(128)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
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
  int vl = valid[valid_n == 1 ? 0 : b];
  vl = min(max(vl, 1), T);
  const int row = blockIdx.x * C::BM + threadIdx.x;
  const bool live = row < T;

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
      qv[j] = a * c[j] + bb * s[j];
      qv[j + D] = bb * c[j + D] + a * s[j + D];
    }
  }
  float m = kMaskValue, l = 0.f;
  const int n_tiles = (vl + BN - 1) / BN;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    for (int idx = threadIdx.x; idx < BN * DH / 4; idx += NT) {
      const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < T) {
        kv = *reinterpret_cast<const float4*>(k + base + (size_t)(k0 + r) * DH + c);
        vv = *reinterpret_cast<const float4*>(v + base + (size_t)(k0 + r) * DH + c);
      }
      *reinterpret_cast<float4*>(Ks + r * DH + c) = kv;
      *reinterpret_cast<float4*>(Vs + r * DH + c) = vv;
    }
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
      s[j] = (k0 + j < vl) ? dot * scale : kMaskValue;
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
  }
}

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DH>
int run(int is_f32, const void* q, const void* k, const void* v, void* o, const int* valid,
        int valid_n, const void* cos_t, const void* sin_t, int B, int H, int T, float scale,
        cudaStream_t stream) {
  if (is_f32) {
    using C = F32Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_fwd_f32<DH>, C::smem);
    if (e) return e;
    flash_fwd_f32<DH><<<grid, C::NT, C::smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), valid, valid_n, static_cast<const float*>(cos_t),
        static_cast<const float*>(sin_t), H, T, scale);
  } else {
    using C = Bf16Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    int e = allow_smem(flash_fwd_bf16<DH>, C::smem);
    if (e) return e;
    flash_fwd_bf16<DH><<<grid, C::NT, C::smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), valid, valid_n,
        static_cast<const __nv_bfloat16*>(cos_t), static_cast<const __nv_bfloat16*>(sin_t), H, T,
        scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v/o: contiguous [B, H, T, dh], bf16 (is_f32 == 0) or f32 (is_f32 == 1),
// 16-byte aligned. valid: int32 device array of valid_n (1 or B) entries.
// cos_t/sin_t: [>= T, dh] rotary tables of the same type, or both null.
int covomix_flash_attention_fwd(int is_f32, const void* q, const void* k, const void* v, void* o,
                                const int* valid, int valid_n, const void* cos_t,
                                const void* sin_t, int B, int H, int T, int dh, float scale,
                                void* stream) {
  if (dh != FLASH_DH) return -1;
  return run<FLASH_DH>(is_f32, q, k, v, o, valid, valid_n, cos_t, sin_t, B, H, T, scale,
                       static_cast<cudaStream_t>(stream));
}

const char* covomix_cuda_error_string(int code) {
  if (code == -1) return "head dim differs from the FLASH_DH this library was built for";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
