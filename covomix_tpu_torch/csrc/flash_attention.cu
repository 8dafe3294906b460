// Flash attention for Hopper (sm_90a), with a per-row key-prefix mask
// (valid_len), an optional causal mask and optional halfsplit rotary (a
// pre-pass kernel in bf16, in the kernel in f32): the forward (with an
// optional per-row logsumexp output) and the two backward kernels.
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
// B*H*T^2*dh, against 54-82 MB of q/k/v/dO/out/lse/delta traffic: at the
// non-causal shapes all three are bound by the tensor cores, not by memory;
// the causal forward at [6, 8, 1026, 64] (half the pairs, no rotary) is
// bound by its 25 MB of bytes. The TPU kernels held whole key rows in VMEM
// and carried sums across a sequential grid; an SM has 227 KB of shared
// memory and blocks run in parallel with nothing carried between them. So
// every kernel here owns one (b, h, row tile) and walks tiles of the other
// axis through shared memory, with an online softmax in the forward (running
// max m, running sum l, rescaled accumulator; the [T, T] scores never
// written). Keeping the TPU's two-kernel backward means no block writes what
// another block writes: no atomics, deterministic gradients.
//
// The bf16 forward:
//   * rotary once per call: `flash_rotary_halfsplit_bf16` writes rotated
//     copies of q and k (one read and one write of each, byte-bound), and the
//     attention kernels take q and k already rotated (rotating each key tile
//     in every query block, behind two barriers, cost 47 % of the time).
//   * head dims 64 and 128 (`flash_fwd_wgmma`, WgCfg): one block per 64
//     query rows, 160 threads. One producer warp loads the Q tile and walks
//     the K/V tiles (128 keys at dh 64, 64 at dh 128) through a ring of
//     three (dh 64) or two (dh 128) shared-memory stages with TMA (3-D
//     tensor maps [B*H, T, dh], boxes of 64 columns with the 128-byte
//     swizzle, rows past T zero-filled; three maps encoded on the host per
//     launch with cuTensorMapEncodeTiled, fetched through
//     cudaGetDriverEntryPoint; TMA rather than cp.async, whose per-thread
//     copies and address math would sit in the consumers' instruction
//     stream; the tile sizes are held to the card's limits by the
//     static_asserts beside WgCfg), each
//     stage guarded by a "full" and an "empty" mbarrier, so the next tiles'
//     loads run under the current tile's products. One consumer warpgroup
//     runs S = Q K^T as wgmma m64nBNk16 from shared memory (both K-major),
//     the online softmax on the accumulator registers (2^x with the scale
//     folded in), then O += P V as wgmma with P as register A fragments
//     (rounded to bf16) and V read MN-major in its natural [keys, dh] layout
//     (no transposed copy, no bank conflicts). Tile j's scores and softmax
//     run while tile j-1's P V is in flight, and two blocks share an SM, so
//     one block's softmax also runs under the other's products. Causal row
//     blocks are launched longest first.
//   * the other head dims (16, 32, 48, 80-112, 144-256; no configuration in
//     the repo uses them) keep the mma.sync m16n8k16 forward (Bf16Cfg):
//     64-key tiles loaded with 16-byte loads, V stored transposed.
// What still bounds the wgmma forward: the scores of a tile wait for their
// own wgmma (only the P V overlaps the softmax), each K/V tile feeds only 64
// query rows (two consumer warpgroups sharing a tile measured slower), and
// the rotary pre-pass is a second pass over q and k (byte-bound, a quarter
// of the forward at the serving shape).
//
// The bf16 backward (dQ, and dK / dV):
//   * dQ at head dims 64 and 128, dK/dV at 64 (`flash_bwd_dq_wgmma`,
//     `flash_bwd_dkv_wgmma`, BwdWgCfg): the forward's design. One block per
//     (b, h, 64 query rows) for dQ or 64 key rows for dK/dV, 160 threads: a
//     producer warp loads the block's own two tiles once (Q and dO, or K and
//     V) and streams 64-row tiles of the other axis (K and V, or Q and dO
//     with their lse and delta) through a three-stage (dh 64) or two-stage
//     TMA + mbarrier ring; one consumer warpgroup runs all five products as
//     wgmma. S = Q K^T, dP = dO V^T (dQ) and S^T = K Q^T, dP^T = V dO^T
//     (dK/dV) read both operands K-major; dQ += dS K, dV += P^T dO and
//     dK += dS^T Q take P / dS as bf16 register fragments and read K, dO and
//     Q MN-major (the transpose bit) from the very swizzled tiles the scores
//     read K-major, so no operand is copied transposed. A tile's products
//     run one after another (scores, then P / dS on the registers, then the
//     accumulating products), and the SM's other block keeps the tensor
//     cores busy meanwhile: overlapping the two inside the warpgroup, as the
//     forward does, needs more than the 168 registers ptxas gives a thread
//     at two blocks per SM, and measured slower. The non-causal kernels take the halfsplit rotary tables as a template
//     form and apply the rotary's transpose to dQ and dK in their epilogue
//     (the forward's pre-pass output is what autograd saves, so the
//     backward neither re-rotates q and k nor counter-rotates in PyTorch).
//     dK/dV at dh 128 would need 224 accumulator registers (kBwdAccRegs) and
//     keeps mma.sync.
//   * the other head dims (no configuration in the repo uses them): one block
//     per 64 query rows (dQ) or key rows (dK/dV) walks 64-wide tiles of the
//     other axis with mma.sync m16n8k16; p and ds are re-packed in registers
//     as A operands; the B operands that need the other orientation (K for
//     dQ, Q and dO for dK/dV) are stored transposed in shared memory. Head
//     dims above 64 split each 16-row group's output columns over two warps
//     (32 rows per block), and above 128 the A fragments are read from
//     shared memory. With tables, `flash_rotary_transpose_bf16` follows them
//     (and the causal wgmma kernels) in place.
//
// f32 inputs (HuBERT extraction's default, f32 training: the recipes' own
// precision, tests, comparisons) take CUDA-core FMA kernels (no TF32) with the
// same masking and the same arithmetic in f32: at head dim 64 the forward is
// `flash_fwd_f32_tile` (F32TileCfg) and the backward `flash_bwd_dq_f32_tile`
// and `flash_bwd_dkv_f32_tile` (F32BwdCfg), SIMT register tiles of 8 rows x 4
// columns per thread, as in an SGEMM, the backward with the rotary's
// transpose in its epilogue; the other head dims keep one row per thread.
//
// Rotary (the bf16 pre-pass, and in place in the f32 forward): rot(x)[j] =
// x[j]*cos[j] + x[(j+d)%dh]*sin_signed[j], two f32 products and one f32 sum,
// each rounded (no FMA contraction), then rounded once to the input type:
// the same operations as the plain version's `_rotary_plain`, so every
// path (the pre-pass, the f32 kernel, `_rotary_plain` on the CPU) scores the
// same rotated q and k. Its transpose (the backward's epilogue with tables,
// and `flash_rotary_transpose_bf16`) is `_rotary_transpose`'s arithmetic.
//
// One library per head dim: build with -DFLASH_DH=<dh>, a multiple of 16 (the
// mma k-step) in [16, 256] (the dispatch rule's limit).
//
// C interface (ctypes): each covomix_flash_* launch function returns the
// CUDA error code of its launch (0 on success), or one of this library's
// negative codes (covomix_cuda_error_string names each).

#include <cuda.h>  // CUtensorMap and its enums (the encoder is fetched at run time)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

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
// rotary pre-pass (bf16): q and k rotated once per call

// qr/kr[r] = rot(q/k[r]) for the rows r of [rows, DH] (row r at position
// r % T), 8 pairs (j, j + DH/2) per thread with 16-byte loads and stores;
// blockIdx.y picks q (0) or k (1). rotate_rows's arithmetic: two f32
// products and one f32 sum, each rounded, then one rounding to bf16.
template <int DH>
__global__ void __launch_bounds__(256)
flash_rotary_halfsplit_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ cos_t, const __nv_bfloat16* __restrict__ sin_t,
                            __nv_bfloat16* __restrict__ qr, __nv_bfloat16* __restrict__ kr, long long rows,
                            int T) {
  constexpr int D = DH / 2, VPH = D / 8;  // 8-element vectors per half row
  const __nv_bfloat16* src = blockIdx.y == 0 ? q : k;
  __nv_bfloat16* dst = blockIdx.y == 0 ? qr : kr;
  const long long n = rows * VPH;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / VPH;
    const int j = (int)(i % VPH) * 8, t = (int)(r % T);
    const uint4 a4 = *reinterpret_cast<const uint4*>(src + r * DH + j);
    const uint4 b4 = *reinterpret_cast<const uint4*>(src + r * DH + j + D);
    const uint4 c_lo4 = *reinterpret_cast<const uint4*>(cos_t + (size_t)t * DH + j);
    const uint4 c_hi4 = *reinterpret_cast<const uint4*>(cos_t + (size_t)t * DH + j + D);
    const uint4 s_lo4 = *reinterpret_cast<const uint4*>(sin_t + (size_t)t * DH + j);
    const uint4 s_hi4 = *reinterpret_cast<const uint4*>(sin_t + (size_t)t * DH + j + D);
    const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(&a4);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&b4);
    const __nv_bfloat16* c_lo = reinterpret_cast<const __nv_bfloat16*>(&c_lo4);
    const __nv_bfloat16* c_hi = reinterpret_cast<const __nv_bfloat16*>(&c_hi4);
    const __nv_bfloat16* s_lo = reinterpret_cast<const __nv_bfloat16*>(&s_lo4);
    const __nv_bfloat16* s_hi = reinterpret_cast<const __nv_bfloat16*>(&s_hi4);
    uint4 lo4, hi4;
    __nv_bfloat16* lo = reinterpret_cast<__nv_bfloat16*>(&lo4);
    __nv_bfloat16* hi = reinterpret_cast<__nv_bfloat16*>(&hi4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float x = __bfloat162float(a[e]), y = __bfloat162float(b[e]);
      lo[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(x, __bfloat162float(c_lo[e])),
                                            __fmul_rn(y, __bfloat162float(s_lo[e]))));
      hi[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(y, __bfloat162float(c_hi[e])),
                                            __fmul_rn(x, __bfloat162float(s_hi[e]))));
    }
    *reinterpret_cast<uint4*>(dst + r * DH + j) = lo4;
    *reinterpret_cast<uint4*>(dst + r * DH + j + D) = hi4;
  }
}

// ---------------------------------------------------------------------------
// forward, bf16, head dims 64 and 128: TMA + mbarrier ring + wgmma

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (the layout a
// TMA box of 64 bf16 columns with CU_TENSOR_MAP_SWIZZLE_128B writes, the box
// 1024-byte aligned): start address, leading / stride byte offsets.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the wgmma issue / wait (the asm above does not name them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for register A fragments: a wgmma reads them until its wait.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x N, f32, the m16n8 C-fragment layout per warp: warp w holds rows
// 16w..16w+15) = A (64 x 16) * B (16 x N) + (scale_d ? D : 0), bf16 inputs.
// ss: A and B from shared memory, both K-major (the rows of Q and of K).
// rs: A from registers (the m16n8k16 A-fragment layout), B from shared
// memory MN-major (V's rows in their natural [keys, dh] order).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// S = Q K^T for one K tile: DH/16 k steps of 16 columns (32 bytes into the
// 128-byte swizzled rows; the next 64-column chunk past 4 steps).
template <int DH, int BN, int BM>
__device__ __forceinline__ void fwd_scores(float (&sc)[BN / 2], uint32_t sq, uint32_t sk) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    const uint32_t off = (ks % 4) * 32;
    Wgmma<BN>::ss(sc, wgmma_desc(sq + (ks / 4) * BM * 128 + off, 16, 1024),
                  wgmma_desc(sk + (ks / 4) * BN * 128 + off, 16, 1024), ks);
  }
}

// O += P V for one V tile: BN/16 k steps of 16 keys (two 8-row swizzle
// groups, 2048 bytes); V MN-major, its 64-column chunks BN*128 bytes apart.
template <int DH, int BN>
__device__ __forceinline__ void fwd_pv(float (&acc)[DH / 2], const uint32_t (&pa)[BN / 16][4], uint32_t sv) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) Wgmma<DH>::rs(acc, pa[kk], wgmma_desc(sv + kk * 2048, BN * 128, 1024), 1);
}

// The online softmax of one score tile (rows qr and qr+8 of each warp's 16;
// keys k0..k0+BN-1), in place: dead keys (j >= lim) at -1e30, the running
// max m (of raw scores) and sum l updated, sc becomes p = exp((s - m) *
// scale) = 2^(s*c2 - m*c2), and (a0, a1) the factors that rescale the old
// accumulators. l takes p before its rounding to bf16.
template <int BN>
__device__ __forceinline__ void fwd_softmax(float (&sc)[BN / 2], float& m0, float& m1, float& l0, float& l1,
                                            float& a0, float& a1, int k0, int lim0, int lim1, bool mask,
                                            float c2, int qc) {
  if (mask) {
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = k0 + nt * 8 + qc;
      if (col >= lim0) sc[nt * 4 + 0] = kMaskValue;
      if (col + 1 >= lim0) sc[nt * 4 + 1] = kMaskValue;
      if (col >= lim1) sc[nt * 4 + 2] = kMaskValue;
      if (col + 1 >= lim1) sc[nt * 4 + 3] = kMaskValue;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    mx0 = fmaxf(mx0, fmaxf(sc[nt * 4 + 0], sc[nt * 4 + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[nt * 4 + 2], sc[nt * 4 + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a quad share a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mc0 = mx0 * c2, mc1 = mx1 * c2;
  a0 = ex2(fmaf(m0, c2, -mc0));
  a1 = ex2(fmaf(m1, c2, -mc1));
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    sc[nt * 4 + 0] = ex2(fmaf(sc[nt * 4 + 0], c2, -mc0));
    sc[nt * 4 + 1] = ex2(fmaf(sc[nt * 4 + 1], c2, -mc0));
    sc[nt * 4 + 2] = ex2(fmaf(sc[nt * 4 + 2], c2, -mc1));
    sc[nt * 4 + 3] = ex2(fmaf(sc[nt * 4 + 3], c2, -mc1));
    rs0 += sc[nt * 4 + 0] + sc[nt * 4 + 1];
    rs1 += sc[nt * 4 + 2] + sc[nt * 4 + 3];
  }
  m0 = mx0;
  m1 = mx1;
  l0 = l0 * a0 + rs0;  // per-lane partial sums; the quad is summed at the end
  l1 = l1 * a1 + rs1;
}

template <int DH>
__device__ __forceinline__ void fwd_rescale(float (&acc)[DH / 2], float a0, float a1) {
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    acc[dt * 4 + 0] *= a0;
    acc[dt * 4 + 1] *= a0;
    acc[dt * 4 + 2] *= a1;
    acc[dt * 4 + 3] *= a1;
  }
}

// p rounded to bf16 as the A fragments of P V: the C fragments of key
// columns 16kk..16kk+15 (two 8-column tiles) are the A fragment of k step kk.
template <int BN>
__device__ __forceinline__ void fwd_pack(uint32_t (&pa)[BN / 16][4], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(sc[nt * 4 + 0], sc[nt * 4 + 1]);
    pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(sc[nt * 4 + 2], sc[nt * 4 + 3]);
  }
}

template <int DH>
struct WgCfg {
  static constexpr int BM = 64;                   // query rows per block: one consumer warpgroup
  static constexpr int BN = DH <= 64 ? 128 : 64;  // keys per tile
  // K/V tiles in flight; two blocks of 2 x 3 x 16 KB (dh 64) or 2 x 2 x 16 KB
  // (dh 128) plus Q share an SM's 228 KB
  static constexpr int STAGES = DH <= 64 ? 3 : 2;
  static constexpr int CH = DH / 64;              // 64-column (128-byte) chunks of a row
  static constexpr int NT = 160;                  // 4 consumer warps + 1 producer warp
  static constexpr int Q_BYTES = BM * DH * 2, KV_BYTES = BN * DH * 2;
  // 1024 bytes of slack to align the tiles (the swizzle's period)
  static constexpr size_t smem = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + (1 + 2 * STAGES) * 8;

  // wgmma: M 64 (one warpgroup); N of S (keys) and of O (dh) multiples of 8
  // up to 256; K steps of 16 over dh and over the keys
  static_assert(BM == 64 && NT == 4 * 32 + 32, "one consumer warpgroup and one producer warp");
  static_assert(BN % 16 == 0 && BN <= 256 && DH % 16 == 0 && DH <= 256, "wgmma N / K rules");
  // TMA boxes: one 128-byte swizzle row (64 bf16 columns) wide, at most 256 rows
  static_assert(DH % 64 == 0 && BM <= 256 && BN <= 256, "TMA box rules");
  // every tile is whole 1024-byte swizzle periods, so its swizzle phase is the TMA's
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0 && (BM * 128) % 1024 == 0 && (BN * 128) % 1024 == 0,
                "tiles must be 1024-byte aligned");
  // two blocks per SM: 228 KB of shared memory, 1 KB of it reserved per block
  static_assert(smem <= 232448 && 2 * (smem + 1024) <= 233472, "two blocks must share an SM's shared memory");
  // the f32 accumulators of S (BN/2) and O (DH/2) and P's bf16 A fragments
  // (BN/4) in at most 128 of the 200 registers a thread has at two blocks of
  // 160 threads per SM (__launch_bounds__(160, 2))
  static_assert(DH / 2 + BN / 2 + BN / 4 <= 128, "accumulators must fit the register budget");
};

// The head dims the TMA + wgmma forward serves: a row is whole 128-byte
// swizzle rows (64 bf16 columns each), and the accumulators of O (DH/2 f32)
// and S (BN/2) fit in registers at two blocks per SM. The others take the
// mma.sync forward. The backward: dQ takes its wgmma kernel at the same head
// dims, dK/dV only where its accumulators fit too (`wgmma_bwd_dkv`: dh 64);
// the others keep the mma.sync backward.
constexpr bool wgmma_fwd(int dh) { return dh % 64 == 0 && dh <= 128; }

// One block per (b, h, 64-query-row tile). Warp 4 (one thread) is the
// producer: it loads the Q tile, then walks the K/V tiles through a ring of
// STAGES shared-memory stages with TMA, each stage guarded by a "full"
// (bytes arrived) and an "empty" (consumed) mbarrier. Warps 0-3, one
// warpgroup, consume: S = Q K^T with wgmma from shared memory, the online
// softmax on the accumulator registers, O += P V with P as register A
// fragments and V read MN-major; tile j's scores and softmax run while tile
// j-1's P V is in flight, so the exps overlap the tensor cores. Rows past T
// are zero-filled by TMA (the map is 3-D, [B*H, T, DH]) and never written.
template <int DH, bool LSE, bool CAUSAL>
__global__ void __launch_bounds__(160, 2)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, const int* __restrict__ valid, int valid_n, int H, int T,
                float scale) {
  using C = WgCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, CH = C::CH;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;   // Q [CH][BM][64]
  const uint32_t sk = sq + C::Q_BYTES;                          // K stages [ST][CH][BN][64]
  const uint32_t sv = sk + ST * C::KV_BYTES;                    // V stages [ST][CH][BN][64]
  const uint32_t bar_q = sv + ST * C::KV_BYTES;                 // then full[ST], empty[ST]
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * ST;

  const int bh = blockIdx.x, b = bh / H;
  // causal: the longest row blocks start first
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp; it never meets the consumers at a barrier again
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < CH; ++c) tma_load_3d(sq + c * BM * 128, &tm_q, bar_q, c * 64, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(bar_empty + 8 * s, (j / ST - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(sk + s * C::KV_BYTES + c * BN * 128, &tm_k, bar_full + 8 * s, c * 64, j * BN, bh);
          tma_load_3d(sv + s * C::KV_BYTES + c * BN * 128, &tm_v, bar_full + 8 * s, c * 64, j * BN, bh);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;  // fragment row / column pair
  const float c2 = scale * 1.4426950408889634f;  // exp(x * scale) = 2^(x * c2)
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  // running max of the raw scores (s, not s * scale) of rows qr and qr+8
  float m0 = kMaskValue, m1 = kMaskValue, l0 = 0.f, l1 = 0.f;
  int lim0 = vl, lim1 = vl;  // the live keys of the two rows are j < lim
  if constexpr (CAUSAL) {
    const int r0 = q0 + warp * 16 + qr;
    lim0 = min(vl, r0 + 1);
    lim1 = min(vl, r0 + 9);
  }
  // a tile holds a dead key of some row when it reaches past the smallest limit
  const int lim_min = CAUSAL ? min(vl, q0 + 1) : vl;

  mbar_wait(bar_q, 0);
  float sc[BN / 2];
  uint32_t pa[BN / 16][4];
  float a0, a1;
  // tile j's scores and softmax run while tile j-1's P V is in flight: the
  // exps (SFU) overlap the tensor cores inside the warpgroup
  mbar_wait(bar_full, 0);
  wgmma_fence();
  fwd_scores<DH, BN, BM>(sc, sq, sk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  fwd_softmax<BN>(sc, m0, m1, l0, l1, a0, a1, 0, lim0, lim1, BN > lim_min, c2, qc);
  fwd_pack<BN>(pa, sc);
  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % ST, sp = (j - 1) % ST;
    mbar_wait(bar_full + 8 * s, (j / ST) & 1);
    wgmma_fence();
    fwd_scores<DH, BN, BM>(sc, sq, sk + s * C::KV_BYTES);
    wgmma_commit();
    fwd_pv<DH, BN>(acc, pa, sv + sp * C::KV_BYTES);
    wgmma_commit();
    wgmma_wait<1>();  // the scores (the older group) are in
    fence_regs(sc);
    fwd_softmax<BN>(sc, m0, m1, l0, l1, a0, a1, j * BN, lim0, lim1, j * BN + BN > lim_min, c2, qc);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(bar_empty + 8 * sp);  // tile j-1's stage may be refilled
    fwd_rescale<DH>(acc, a0, a1);
    fwd_pack<BN>(pa, sc);
  }
  wgmma_fence();
  fwd_pv<DH, BN>(acc, pa, sv + ((n_tiles - 1) % ST) * C::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int row0 = q0 + warp * 16 + qr, row1 = row0 + 8;
  const size_t base = (size_t)bh * T * DH;
#pragma unroll
  for (int dt = 0; dt < DH / 8; ++dt) {
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row0 * DH + dt * 8 + qc) =
          __floats2bfloat162_rn(acc[dt * 4 + 0] * inv0, acc[dt * 4 + 1] * inv0);
    if (row1 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row1 * DH + dt * 8 + qc) =
          __floats2bfloat162_rn(acc[dt * 4 + 2] * inv1, acc[dt * 4 + 3] * inv1);
  }
  if constexpr (LSE) {
    if (qc == 0) {  // m and l are the same in the 4 lanes of a quad
      const size_t rbase = (size_t)bh * T;
      if (row0 < T) lse[rbase + row0] = m0 * scale + logf(fmaxf(l0, 1e-30f));
      if (row1 < T) lse[rbase + row1] = m1 * scale + logf(fmaxf(l1, 1e-30f));
    }
  }
}

// ---------------------------------------------------------------------------
// forward, bf16, the other head dims (16, 32, 48, 80-112, 144-256): mma.sync

template <int DH>
struct Bf16Cfg {
  static constexpr int BM = 64, BN = 64, NT = 128;  // 4 warps x 16 query rows
  static constexpr int LQ = DH + 8;                  // padded row stride (q, k)
  static constexpr int LV = BN + 8;                  // padded row stride (v^T)
  static constexpr size_t smem = (size_t)(BM * LQ + BN * LQ + DH * LV) * 2;
  static_assert(smem <= 232448, "one block may take at most 227 KB of shared memory");
};

// q and k arrive rotated (the pre-pass). LSE: write the per-row logsumexp
// (the training form); CAUSAL: also mask key j > query i. Both are template
// arguments: a run-time flag costs registers.
template <int DH, bool LSE, bool CAUSAL>
__global__ void __launch_bounds__(128)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ valid, int valid_n, int H, int T,
               float scale) {
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
// forward, f32, head dim 64: SIMT register tiles (F32TileCfg)
//
// The f32 forward takes true f32 FMAs on the CUDA cores (no TF32), so it is
// bound by the card's f32 FMA rate (67 TFLOP/s), and what keeps a scalar
// kernel from it is everything that is not an FMA. One row per thread (the
// kernel above) held q and the accumulator as 128 registers (spilled), read
// every K or V operand of an FMA from shared memory and took two or three
// block barriers per 32 keys. Here, as in an SGEMM:
//   * one block per 64 query rows, 128 threads; thread (rg, c) owns rows
//     8 rg .. 8 rg + 7 and, of each 64-key tile, the scores of keys c + 16 i
//     (i < 4), then the output columns 4 c .. 4 c + 3: 32 accumulators for S
//     and 32 for O, 8 + 4 operands loaded per 32 FMAs (S: Q^T two float4
//     per d, a key's row one float4 per 4 d; O: P^T two float4 and V one
//     float4 per key), so at most a quarter of the issue goes to loads;
//   * Q rotated once per block into a d-major copy Q^T (rows padded to 68
//     floats, so the 16 lanes of a row's key slots read distinct banks);
//     K (rows of 68 floats) and V tiles double-buffered by cp.async, the
//     next tile in flight during the current one's products; with rotary
//     tables the K tile is rotated in shared memory (rotate_rows), the very
//     arithmetic of `_rotary_plain`;
//   * the row max over the 16 lanes of a row by warp shuffles (each row's
//     16 key slots lie in one half-warp), the row sum kept per lane and
//     summed once at the end; scores pre-scaled by scale * log2(e) and
//     exponentiated with ex2; P goes through a [keys][rows] shared tile
//     into the P V product, each half-warp reading only the rows it wrote
//     (a warp barrier): one block barrier per 64 keys (two with rotary);
//   * 100 KB of shared memory: two blocks per SM; causal blocks stop the key
//     loop at their last row, as the other kernels do.
// Its masking and output (out = acc / max(l, 1e-30), lse = m + log(max(l,
// 1e-30))) are those of the kernel above.
struct F32TileCfg {
  static constexpr int DH = 64, BM = 64, BN = 64, NT = 128;
  static constexpr int LQ = BM + 4;    // row stride of Q^T [DH][BM] and P^T [BN][BM]
  static constexpr int LK = DH + 4;    // row stride of a K tile [BN][DH]
  static constexpr int LV = DH;        // row stride of a V tile [BN][DH]
  static constexpr size_t smem = (size_t)(DH * LQ + 2 * BN * LK + 2 * BN * LV + BN * LQ) * 4;
};
static_assert(2 * (F32TileCfg::smem + 1024) <= 233472, "two f32 tile blocks per SM");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128, 2)
flash_fwd_f32_tile(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                   const int* __restrict__ valid, int valid_n,
                   const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                   int H, int T, float scale) {
  using C = F32TileCfg;
  static_assert(DH == C::DH, "the tiled f32 forward is written for head dim 64");
  constexpr int BM = C::BM, BN = C::BN, NT = C::NT, LQ = C::LQ, LK = C::LK, LV = C::LV, D = DH / 2;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);   // [DH][LQ]
  float* Ks = Qt + DH * LQ;                         // 2 x [BN][LK]
  float* Vs = Ks + 2 * BN * LK;                     // 2 x [BN][LV]
  float* Pt = Vs + 2 * BN * LV;                     // [BN][LQ]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BM;
  const size_t base = ((size_t)b * H + h) * (size_t)T * DH;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) * 2 + (lane >> 4), c = lane & 15;   // rows 8 rg .., key slot / column group c
  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;

  // K / V rows [k0, k0 + BN) into buffer `buf` (rows past T zero-filled)
  auto load_tile = [&](int k0, int buf) {
#pragma unroll
    for (int i = 0; i < BN * DH / 4 / NT; ++i) {
      const int idx = tid + i * NT, r = idx / (DH / 4), c4 = (idx % (DH / 4)) * 4;
      const bool in = k0 + r < T;
      const size_t g = base + (size_t)(in ? k0 + r : 0) * DH + c4;
      cp_async16(Ks + buf * BN * LK + r * LK + c4, k + g, in);
      cp_async16(Vs + buf * BN * LV + r * LV + c4, v + g, in);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // Q^T: the block's rows, rotated, d-major (rows past T zero)
  for (int idx = tid; idx < BM * D; idx += NT) {
    const int r = idx / D, j = idx % D, row = q0 + r;
    float a = 0.f, bb = 0.f;
    if (row < T) {
      a = q[base + (size_t)row * DH + j];
      bb = q[base + (size_t)row * DH + j + D];
      if (cos_t != nullptr) {
        const float* cr = cos_t + (size_t)row * DH;
        const float* sr = sin_t + (size_t)row * DH;
        const float a2 = __fadd_rn(__fmul_rn(a, cr[j]), __fmul_rn(bb, sr[j]));
        bb = __fadd_rn(__fmul_rn(bb, cr[j + D]), __fmul_rn(a, sr[j + D]));
        a = a2;
      }
    }
    Qt[j * LQ + r] = a;
    Qt[(j + D) * LQ + r] = bb;
  }

  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = kMaskValue;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN, buf = kt & 1;
    float* Kb = Ks + buf * BN * LK;
    const float* Vb = Vs + buf * BN * LV;
    cp_async_wait_all();
    __syncthreads();   // tile kt (and Q^T) in; every thread done with tile kt - 1
    if (kt + 1 < n_tiles) load_tile(k0 + BN, buf ^ 1);
    if (cos_t != nullptr) {
      rotate_rows<BN, DH, LK, NT>(Kb, cos_t, sin_t, k0, T);
      __syncthreads();
    }
    // S = Q K^T on the thread's 8 rows x 4 keys
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[r][i] = 0.f;
    const float* qp = Qt + rg * 8;
    const float* kp = Kb + c * LK;
#pragma unroll 4
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      float4 kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) kf[i] = *reinterpret_cast<const float4*>(kp + 16 * i * LK + 4 * d4);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 qa = *reinterpret_cast<const float4*>(qp + (4 * d4 + dd) * LQ);
        const float4 qb = *reinterpret_cast<const float4*>(qp + (4 * d4 + dd) * LQ + 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kv = lane_of(kf[i], dd);
#pragma unroll
          for (int r = 0; r < 8; ++r) s[r][i] = fmaf(qv[r], kv, s[r][i]);
        }
      }
    }
    // online softmax in base 2; P^T [key][row]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + rg * 8 + r;
      const int lim = CAUSAL ? min(vl, row + 1) : vl;
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[r][i] = k0 + c + 16 * i < lim ? s[r][i] * sl2 : kMaskValue;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = ex2(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[r][i] = ex2(s[r][i] - mx);
        l[r] += s[r][i];
      }
    }
    __syncwarp();   // the half-warp's reads of the last tile's P^T rows are done
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* pp = Pt + (c + 16 * i) * LQ + rg * 8;
      *reinterpret_cast<float4*>(pp) = make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      *reinterpret_cast<float4*>(pp + 4) = make_float4(s[4][i], s[5][i], s[6][i], s[7][i]);
    }
    __syncwarp();   // P^T in: a half-warp reads only the rows it wrote
    // O += P V on the thread's 8 rows x 4 columns
    const float* pp = Pt + rg * 8;
    const float* vp = Vb + 4 * c;
#pragma unroll 16
    for (int j = 0; j < BN; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(pp + j * LQ);
      const float4 pb = *reinterpret_cast<const float4*>(pp + j * LQ + 4);
      const float4 vv = *reinterpret_cast<const float4*>(vp + j * LV);
      const float pv[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(pv[r], vv.x, acc[r][0]);
        acc[r][1] = fmaf(pv[r], vv.y, acc[r][1]);
        acc[r][2] = fmaf(pv[r], vv.z, acc[r][2]);
        acc[r][3] = fmaf(pv[r], vv.w, acc[r][3]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    const int row = q0 + rg * 8 + r;
    if (row >= T) continue;
    const float ll = fmaxf(l[r], 1e-30f), inv = 1.f / ll;
    *reinterpret_cast<float4*>(o + base + (size_t)row * DH + 4 * c) =
        make_float4(acc[r][0] * inv, acc[r][1] * inv, acc[r][2] * inv, acc[r][3] * inv);
    if (lse != nullptr && c == 0) lse[((size_t)b * H + h) * (size_t)T + row] = m[r] * kLn2 + logf(ll);
  }
}

// ---------------------------------------------------------------------------
// backward, bf16, the head dims without the wgmma kernels: mma.sync

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
// backward, bf16, head dims 64 and 128: TMA + mbarrier ring + wgmma

// The accumulator registers (f32 accumulators and bf16 A fragments) a
// backward thread may name. At two blocks of 160 threads per SM
// (__launch_bounds__(160, 2)) ptxas gives a thread at most 168 registers; a
// tile's products run one after another, so not all of these are live at
// once, and the rest go to addresses, limits, lse / delta and loop state
// (dK/dV at dh 64 uses all 168, without spills; a loop that overlapped a
// tile's scores with the previous tile's products held them all live at
// once and spilled).
constexpr int kBwdAccRegs = 160;

template <int DH>
struct BwdWgCfg {
  static constexpr int BM = 64;  // rows per block: query rows (dQ) or key rows (dK/dV); one consumer warpgroup
  static constexpr int BN = 64;  // rows per streamed tile: keys (dQ) or queries (dK/dV)
  // streamed tiles in flight; two blocks of ~66 KB (dh 64) or ~97 KB (dh 128) share an SM's 228 KB
  static constexpr int STAGES = DH <= 64 ? 3 : 2;
  static constexpr int CH = DH / 64;  // 64-column (128-byte) chunks of a row
  static constexpr int NT = 160;      // 4 consumer warps + 1 producer warp
  static constexpr int TILE = BN * DH * 2;  // bytes of one [64, DH] bf16 tile
  // 1024 bytes of slack to align the tiles (the swizzle's period)
  // dQ: Q, dO once; K, V per stage
  static constexpr size_t smem_dq = 1024 + 2 * TILE + 2 * STAGES * TILE + (1 + 2 * STAGES) * 8;
  // dK/dV: K, V once; Q, dO and the tile's lse / delta (f32) per stage
  static constexpr size_t smem_dkv = 1024 + 2 * TILE + STAGES * (2 * TILE + 2 * BN * 4) + (1 + 2 * STAGES) * 8;
  // dQ: the S and dP accumulators (BN/2 each), dQ's (DH/2), dS's bf16 fragments (BN/4)
  static constexpr int DQ_REGS = BN + DH / 2 + BN / 4;
  // dK/dV: the dK and dV accumulators (DH/2 each), S^T's and dP^T's (BN/2
  // each), and the bf16 fragments of P^T and dS^T (BN/4 each)
  static constexpr int DKV_REGS = DH + BN + BN / 2;

  // wgmma: M 64 (one warpgroup); N of S (BN) and of dQ / dK / dV (DH)
  // multiples of 8 up to 256; K steps of 16 over DH and over BN
  static_assert(BM == 64 && BN == BM && NT == 4 * 32 + 32, "one consumer warpgroup and one producer warp");
  static_assert(BN % 16 == 0 && BN <= 256 && DH % 16 == 0 && DH <= 256, "wgmma N / K rules");
  // TMA boxes: one 128-byte swizzle row (64 bf16 columns) wide, at most 256 rows
  static_assert(DH % 64 == 0 && BN <= 256, "TMA box rules");
  // every tile is whole 1024-byte swizzle periods, so its swizzle phase is the TMA's
  static_assert(TILE % 1024 == 0 && (BN * 128) % 1024 == 0 && (2 * BN * 4 * STAGES) % 16 == 0,
                "tiles must be 1024-byte aligned");
  // two blocks per SM: 228 KB of shared memory, 1 KB of it reserved per block
  static_assert(smem_dq <= 232448 && 2 * (smem_dq + 1024) <= 233472 && smem_dkv <= 232448 &&
                    2 * (smem_dkv + 1024) <= 233472,
                "two blocks must share an SM's shared memory");
  static_assert(DQ_REGS <= kBwdAccRegs, "dQ's accumulators must fit the register budget");
};

// Whether dK/dV at head dim DH takes the wgmma kernel: its accumulators must
// fit the register budget (dh 64: 160; dh 128: 224 does not, and keeps
// mma.sync). dQ takes it wherever the forward does (dh 64 and 128: 112 and
// 144).
template <int DH>
constexpr bool wgmma_bwd_dkv() {
  if constexpr (wgmma_fwd(DH))
    return BwdWgCfg<DH>::DKV_REGS <= kBwdAccRegs;
  else
    return false;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float bf16_round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// dS = P (dP - delta) in place of the score tile (rows qr, qr+8 of each
// warp's 16 query rows; keys k0..k0+BN-1): P = exp(s * scale - lse) =
// 2^(s*c2 - lse*log2e) (l0, l1: the rows' lse in log2 units), 0 for a dead
// key (j >= lim, checked only where `mask`: a select, so a dead key's
// overflowing exp never reaches dS).
template <int BN>
__device__ __forceinline__ void bwd_ds(float (&sc)[BN / 2], const float (&dp)[BN / 2], int k0, int lim0, int lim1,
                                       bool mask, float c2, float l0, float l1, float d0, float d1, int qc) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    float p0 = ex2(fmaf(sc[nt * 4 + 0], c2, -l0)), p1 = ex2(fmaf(sc[nt * 4 + 1], c2, -l0));
    float p2 = ex2(fmaf(sc[nt * 4 + 2], c2, -l1)), p3 = ex2(fmaf(sc[nt * 4 + 3], c2, -l1));
    if (mask) {
      const int col = k0 + nt * 8 + qc;
      if (col >= lim0) p0 = 0.f;
      if (col + 1 >= lim0) p1 = 0.f;
      if (col >= lim1) p2 = 0.f;
      if (col + 1 >= lim1) p3 = 0.f;
    }
    sc[nt * 4 + 0] = p0 * (dp[nt * 4 + 0] - d0);
    sc[nt * 4 + 1] = p1 * (dp[nt * 4 + 1] - d0);
    sc[nt * 4 + 2] = p2 * (dp[nt * 4 + 2] - d1);
    sc[nt * 4 + 3] = p3 * (dp[nt * 4 + 3] - d1);
  }
}

// P^T and dS^T = P^T (dP^T - delta) in place of the transposed tiles (rows:
// key0 = the thread's key row and key0 + 8; columns: query rows i0 + c of the
// tile, whose lse (log2 units) and delta are ls[c], es[c] in shared memory).
// A pair is dead when its key row is past valid_len (live0 / live1), its
// query row is past T (TMA zero-fills those rows, and a zero row still gives
// p = exp(-lse) != 0), or, causal, the query precedes the key; checked only
// where `mask`.
template <int BN, bool CAUSAL>
__device__ __forceinline__ void bwd_pt_dst(float (&st)[BN / 2], float (&dpt)[BN / 2], const float* ls,
                                           const float* es, int i0, int key0, bool live0, bool live1, int T,
                                           bool mask, float c2, int qc) {
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    const int c = nt * 8 + qc;
    const float2 la = *reinterpret_cast<const float2*>(ls + c), ea = *reinterpret_cast<const float2*>(es + c);
    float p0 = ex2(fmaf(st[nt * 4 + 0], c2, -la.x)), p1 = ex2(fmaf(st[nt * 4 + 1], c2, -la.y));
    float p2 = ex2(fmaf(st[nt * 4 + 2], c2, -la.x)), p3 = ex2(fmaf(st[nt * 4 + 3], c2, -la.y));
    if (mask) {
      const int qi = i0 + c;
      const bool ok0 = qi < T, ok1 = qi + 1 < T;
      if (!(live0 && ok0 && (!CAUSAL || qi >= key0))) p0 = 0.f;
      if (!(live0 && ok1 && (!CAUSAL || qi + 1 >= key0))) p1 = 0.f;
      if (!(live1 && ok0 && (!CAUSAL || qi >= key0 + 8))) p2 = 0.f;
      if (!(live1 && ok1 && (!CAUSAL || qi + 1 >= key0 + 8))) p3 = 0.f;
    }
    st[nt * 4 + 0] = p0;
    st[nt * 4 + 1] = p1;
    st[nt * 4 + 2] = p2;
    st[nt * 4 + 3] = p3;
    dpt[nt * 4 + 0] = p0 * (dpt[nt * 4 + 0] - ea.x);
    dpt[nt * 4 + 1] = p1 * (dpt[nt * 4 + 1] - ea.y);
    dpt[nt * 4 + 2] = p2 * (dpt[nt * 4 + 2] - ea.x);
    dpt[nt * 4 + 3] = p3 * (dpt[nt * 4 + 3] - ea.y);
  }
}

// Rows row0 and row0 + 8 (< T) of a [T, DH] bf16 output from a wgmma
// accumulator (C-fragment layout: columns dt*8 + qc, +1): bf16(acc * scale).
// ROT: then the transpose of the halfsplit rotary, `_rotary_transpose`'s
// arithmetic on those bf16 values (x'[j] = x[j] cos[j] + x[j+d] sin[j+d],
// x'[j+d] = x[j+d] cos[j+d] + x[j] sin[j], each product and the sum rounded
// in f32, then one rounding to bf16), so the result is bit-equal to
// `_rotary_transpose` of the output without tables. A thread holds column c
// and c + DH/2 of its rows, so the rotation needs no exchange.
template <int DH, bool ROT>
__device__ __forceinline__ void bwd_store(__nv_bfloat16* out, const float (&acc)[DH / 2], float scale, int row0,
                                          int T, int qc, const __nv_bfloat16* cos_t, const __nv_bfloat16* sin_t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= T) continue;
    __nv_bfloat16* o = out + (size_t)row * DH;
    if constexpr (ROT) {
      constexpr int D = DH / 2, DT = DH / 16;  // 8-column tiles per half row
      const __nv_bfloat16* cr = cos_t + (size_t)row * DH;
      const __nv_bfloat16* sr = sin_t + (size_t)row * DH;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int col = dt * 8 + qc;
        const float2 cl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cr + col));
        const float2 ch = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(cr + col + D));
        const float2 sl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + col));
        const float2 sh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sr + col + D));
        const float a0 = bf16_round(acc[dt * 4 + 2 * h] * scale), a1 = bf16_round(acc[dt * 4 + 2 * h + 1] * scale);
        const float b0 = bf16_round(acc[(dt + DT) * 4 + 2 * h] * scale);
        const float b1 = bf16_round(acc[(dt + DT) * 4 + 2 * h + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(a0, cl.x), __fmul_rn(b0, sh.x)), __fadd_rn(__fmul_rn(a1, cl.y), __fmul_rn(b1, sh.y)));
        *reinterpret_cast<__nv_bfloat162*>(o + col + D) = __floats2bfloat162_rn(
            __fadd_rn(__fmul_rn(b0, ch.x), __fmul_rn(a0, sl.x)), __fadd_rn(__fmul_rn(b1, ch.y), __fmul_rn(a1, sl.y)));
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < DH / 8; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(o + dt * 8 + qc) =
            __floats2bfloat162_rn(acc[dt * 4 + 2 * h] * scale, acc[dt * 4 + 2 * h + 1] * scale);
    }
  }
}

// dQ for one (b, h, 64-query-row tile). Warp 4 (one thread) is the producer:
// it loads the Q and dO tiles once, then walks the K/V tiles through a ring
// of STAGES shared-memory stages with TMA, each stage guarded by a "full"
// and an "empty" mbarrier. Warps 0-3, one warpgroup, consume: S = Q K^T and
// dP = dO V^T with wgmma from shared memory (all K-major), dS = P (dP - delta)
// on the accumulator registers, then dQ += dS K with dS as register A
// fragments (rounded to bf16) and K read MN-major from the same swizzled tile
// that S read K-major (no K^T copy). Causal row blocks are launched longest
// first and stop at their last query row; rows past T are zero-filled and
// never written. ROT: dQ leaves through the rotary transpose (`bwd_store`).
template <int DH, bool CAUSAL, bool ROT>
__global__ void __launch_bounds__(160, 2)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                   const int* __restrict__ valid, int valid_n, const __nv_bfloat16* __restrict__ cos_t,
                   const __nv_bfloat16* __restrict__ sin_t, int H, int T, float scale) {
  using C = BwdWgCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, CH = C::CH, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // Q [CH][BM][64]
  const uint32_t sdo = sq + TILE;                               // dO [CH][BM][64]
  const uint32_t sk = sdo + TILE;                               // K stages [ST][CH][BN][64]
  const uint32_t sv = sk + ST * TILE;                           // V stages [ST][CH][BN][64]
  const uint32_t bar_q = sv + ST * TILE;                        // then full[ST], empty[ST]
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * ST;

  const int bh = blockIdx.x, b = bh / H;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;  // causal: longest first
  const int vl = clamp_valid(valid, valid_n, b, T);
  // tiles wholly past valid_len (causal: past the block's last row) hold only p = 0
  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp; it never meets the consumers at a barrier again
    if (threadIdx.x == 128) {
      mbar_expect_tx(bar_q, 2 * TILE);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load_3d(sq + c * BM * 128, &tm_q, bar_q, c * 64, q0, bh);
        tma_load_3d(sdo + c * BM * 128, &tm_do, bar_q, c * 64, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        if (j >= ST) mbar_wait(bar_empty + 8 * s, (j / ST - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE);
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(sk + s * TILE + c * BN * 128, &tm_k, bar_full + 8 * s, c * 64, j * BN, bh);
          tma_load_3d(sv + s * TILE + c * BN * 128, &tm_v, bar_full + 8 * s, c * 64, j * BN, bh);
        }
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;  // fragment row / column pair
  const float c2 = scale * kLog2e;               // exp(x * scale) = 2^(x * c2)
  const int row0 = q0 + warp * 16 + qr, row1 = row0 + 8;
  const size_t rbase = (size_t)bh * T;
  const float l0 = row0 < T ? lse[rbase + row0] * kLog2e : 0.f, l1 = row1 < T ? lse[rbase + row1] * kLog2e : 0.f;
  const float d0 = row0 < T ? delta[rbase + row0] : 0.f, d1 = row1 < T ? delta[rbase + row1] : 0.f;
  int lim0 = vl, lim1 = vl;  // the live keys of the two rows are j < lim
  if constexpr (CAUSAL) {
    lim0 = min(vl, row0 + 1);
    lim1 = min(vl, row1 + 1);
  }
  // a tile holds a dead key of some row when it reaches past the smallest limit
  const int lim_min = CAUSAL ? min(vl, q0 + 1) : vl;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float sc[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];
  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST;
    mbar_wait(bar_full + 8 * s, (j / ST) & 1);
    wgmma_fence();
    fwd_scores<DH, BN, BM>(sc, sq, sk + s * TILE);
    fwd_scores<DH, BN, BM>(dp, sdo, sv + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    bwd_ds<BN>(sc, dp, j * BN, lim0, lim1, j * BN + BN > lim_min, c2, l0, l1, d0, d1, qc);
    fwd_pack<BN>(da, sc);
    wgmma_fence();
    fwd_pv<DH, BN>(acc, da, sk + s * TILE);  // dQ += dS K, K MN-major
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    mbar_arrive(bar_empty + 8 * s);
  }
  bwd_store<DH, ROT>(dq + rbase * DH, acc, scale, row0, T, qc, cos_t, sin_t);
}

// dK and dV for one (b, h, 64-key-row tile). The producer warp loads the K
// and V tiles once (TMA), then walks the Q and dO tiles through the ring;
// its 32 lanes also copy each tile's 64 lse (times log2 e) and delta values
// into the stage, zero past T (finite, so a select masks the row), and
// arrive on the stage's "full" mbarrier beside the TMA bytes (a bulk copy
// would need 16-byte aligned rows, which T 1026 does not give). The
// consumer warpgroup: S^T = K Q^T and dP^T = V dO^T (both operands K-major),
// P^T and dS^T on the accumulator registers, then dV += bf16(P^T) dO and
// dK += bf16(dS^T) Q with the fragments from registers and dO and Q read
// MN-major from the same swizzled tiles the scores read K-major (no Q^T or
// dO^T copy). A block wholly past valid_len writes exact zeros; causal blocks start at
// the query tile of their first key. ROT: dK leaves through the rotary
// transpose (`bwd_store`).
template <int DH, bool CAUSAL, bool ROT>
__global__ void __launch_bounds__(160, 2)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, const int* __restrict__ valid, int valid_n,
                    const __nv_bfloat16* __restrict__ cos_t, const __nv_bfloat16* __restrict__ sin_t, int H, int T,
                    float scale) {
  using C = BwdWgCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, ST = C::STAGES, CH = C::CH, TILE = C::TILE;
  static_assert(C::DKV_REGS <= kBwdAccRegs, "dK/dV's accumulators must fit the register budget");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sk = smem_u32(base);     // K [CH][BM][64]
  const uint32_t sv = sk + TILE;          // V [CH][BM][64]
  const uint32_t sq = sv + TILE;          // Q stages [ST][CH][BN][64]
  const uint32_t sdo = sq + ST * TILE;    // dO stages [ST][CH][BN][64]
  float* ls = reinterpret_cast<float*>(base + (2 + 2 * ST) * TILE);  // lse * log2 e [ST][BN]
  float* es = ls + ST * BN;                                           // delta [ST][BN]
  const uint32_t bar_kv = smem_u32(es + ST * BN);                     // then full[ST], empty[ST]
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * ST;

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BM;
  const int vl = clamp_valid(valid, valid_n, b, T);
  const size_t rbase = (size_t)bh * T;
  if (k0 >= vl) {  // every key of the block is past valid_len: exact zeros
    const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = threadIdx.x; i < BM * DH / 2; i += C::NT) {
      const int r = k0 + i / (DH / 2), c = (i % (DH / 2)) * 2;
      if (r < T) {
        *reinterpret_cast<__nv_bfloat162*>(dk + (rbase + r) * DH + c) = z;
        *reinterpret_cast<__nv_bfloat162*>(dv + (rbase + r) * DH + c) = z;
      }
    }
    return;
  }
  // every query row < T takes part (causal: from the tile of the block's first key on)
  const int it0 = CAUSAL ? k0 / BN : 0, n_tiles = (T + BN - 1) / BN - it0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes (lane 0's with the TMA bytes)
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // producer warp; it never meets the consumers at a barrier again
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * TILE);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        tma_load_3d(sk + c * BM * 128, &tm_k, bar_kv, c * 64, k0, bh);
        tma_load_3d(sv + c * BM * 128, &tm_v, bar_kv, c * 64, k0, bh);
      }
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % ST, i0 = (it0 + j) * BN;
      if (j >= ST) mbar_wait(bar_empty + 8 * s, (j / ST - 1) & 1);
      for (int r = lane; r < BN; r += 32) {
        const bool in = i0 + r < T;
        ls[s * BN + r] = in ? lse[rbase + i0 + r] * kLog2e : 0.f;
        es[s * BN + r] = in ? delta[rbase + i0 + r] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(bar_full + 8 * s, 2 * TILE);  // also this lane's arrival
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          tma_load_3d(sq + s * TILE + c * BN * 128, &tm_q, bar_full + 8 * s, c * 64, i0, bh);
          tma_load_3d(sdo + s * TILE + c * BN * 128, &tm_do, bar_full + 8 * s, c * 64, i0, bh);
        }
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qr = lane / 4, qc = (lane % 4) * 2;
  const float c2 = scale * kLog2e;
  const int key0 = k0 + warp * 16 + qr;
  const bool live0 = key0 < vl, live1 = key0 + 8 < vl;
  // a tile holds a dead pair when it reaches past T, the block holds a key
  // past valid_len, or (causal) a query of the tile precedes a key of the block
  const bool dead_keys = k0 + BM > vl;

  float ak[DH / 2], av[DH / 2];  // dK, dV accumulators
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) ak[i] = av[i] = 0.f;
  float st[BN / 2], dpt[BN / 2];
  uint32_t pa[BN / 16][4], sa[BN / 16][4];
  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % ST, i0 = (it0 + j) * BN;
    mbar_wait(bar_full + 8 * s, (j / ST) & 1);
    wgmma_fence();
    fwd_scores<DH, BN, BM>(st, sk, sq + s * TILE);
    fwd_scores<DH, BN, BM>(dpt, sv, sdo + s * TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    bwd_pt_dst<BN, CAUSAL>(st, dpt, ls + s * BN, es + s * BN, i0, key0, live0, live1, T,
                           dead_keys || i0 + BN > T || (CAUSAL && i0 < k0 + BM - 1), c2, qc);
    fwd_pack<BN>(pa, st);
    fwd_pack<BN>(sa, dpt);
    wgmma_fence();
    fwd_pv<DH, BN>(av, pa, sdo + s * TILE);  // dV += P^T dO, dO MN-major
    fwd_pv<DH, BN>(ak, sa, sq + s * TILE);   // dK += dS^T Q, Q MN-major
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(av);
    fence_regs(ak);
    fence_regs(pa);
    fence_regs(sa);
    mbar_arrive(bar_empty + 8 * s);
  }
  bwd_store<DH, ROT>(dk + rbase * DH, ak, scale, key0, T, qc, cos_t, sin_t);
  bwd_store<DH, false>(dv + rbase * DH, av, 1.f, key0, T, qc, nullptr, nullptr);
}

// x[r] = the halfsplit rotary's transpose of x[r], in place, for the rows r
// of [rows, DH] (row r at position r % T): `bwd_store`'s (and
// `_rotary_transpose`'s) arithmetic, 8 pairs (j, j + DH/2) per thread (each
// pair owned by one thread, so in place is safe). It follows the backward
// kernels that do not rotate in their epilogue (the causal ones, and the
// mma.sync ones at the other head dims).
template <int DH>
__global__ void __launch_bounds__(256)
flash_rotary_transpose_bf16(__nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cos_t,
                            const __nv_bfloat16* __restrict__ sin_t, long long rows, int T) {
  constexpr int D = DH / 2, VPH = D / 8;  // 8-element vectors per half row
  const long long n = rows * VPH;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / VPH;
    const int j = (int)(i % VPH) * 8, t = (int)(r % T);
    uint4 a4 = *reinterpret_cast<const uint4*>(x + r * DH + j);
    uint4 b4 = *reinterpret_cast<const uint4*>(x + r * DH + j + D);
    const uint4 c_lo4 = *reinterpret_cast<const uint4*>(cos_t + (size_t)t * DH + j);
    const uint4 c_hi4 = *reinterpret_cast<const uint4*>(cos_t + (size_t)t * DH + j + D);
    const uint4 s_lo4 = *reinterpret_cast<const uint4*>(sin_t + (size_t)t * DH + j);
    const uint4 s_hi4 = *reinterpret_cast<const uint4*>(sin_t + (size_t)t * DH + j + D);
    __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(&a4);
    __nv_bfloat16* b = reinterpret_cast<__nv_bfloat16*>(&b4);
    const __nv_bfloat16* c_lo = reinterpret_cast<const __nv_bfloat16*>(&c_lo4);
    const __nv_bfloat16* c_hi = reinterpret_cast<const __nv_bfloat16*>(&c_hi4);
    const __nv_bfloat16* s_lo = reinterpret_cast<const __nv_bfloat16*>(&s_lo4);
    const __nv_bfloat16* s_hi = reinterpret_cast<const __nv_bfloat16*>(&s_hi4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float u = __bfloat162float(a[e]), w = __bfloat162float(b[e]);
      a[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(u, __bfloat162float(c_lo[e])),
                                           __fmul_rn(w, __bfloat162float(s_hi[e]))));
      b[e] = __float2bfloat16_rn(__fadd_rn(__fmul_rn(w, __bfloat162float(c_hi[e])),
                                           __fmul_rn(u, __bfloat162float(s_lo[e]))));
    }
    *reinterpret_cast<uint4*>(x + r * DH + j) = a4;
    *reinterpret_cast<uint4*>(x + r * DH + j + D) = b4;
  }
}

// ---------------------------------------------------------------------------
// backward, f32, the head dims without the tiled kernels (scalar FMA, one
// row per thread)

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
// backward, f32, head dim 64: SIMT register tiles (F32BwdCfg)
//
// The f32 training path (the recipes train in f32 unless --bf16 is given)
// runs these at [8, 16, 832, 64] (VoMix, rotary) and [6, 8, 1026-1794, 64]
// (CoMix T2S, causal). True f32 FMAs on the CUDA cores (no TF32), so they are
// bound by the card's f32 FMA rate (67 TFLOP/s): dQ does 3 and dK/dV 4 dh-long
// products per live (query, key) pair. The one-row kernels above held q, dO
// and the accumulator (dQ) or k, v and two accumulators (dK/dV) as 192-256
// live floats a thread (255 registers, spilled), read every operand of an
// FMA from shared memory and took two block barriers per 32 rows with no
// copy in flight. Here, as in `flash_fwd_f32_tile`:
//   * one block per 64 rows of its own axis (query rows for dQ, key rows for
//     dK/dV), 128 threads; thread (rg, c) owns rows 8 rg .. 8 rg + 7 and, of
//     each 64-row tile of the other axis, the columns c + 16 i (i < 4) of the
//     two score products (S and dP, or S^T and dP^T: 32 + 32 accumulators),
//     then the output columns 4 c .. 4 c + 3 of the accumulating products
//     (dQ: 32; dK and dV: 64 accumulators); 8 + 4 operands loaded per 32
//     FMAs, so at most a quarter of the issue goes to shared-memory loads;
//   * the block's own two tiles (Q and dO, or K and V) loaded once, d-major,
//     so that a half-warp reads its 8 rows' values of one d with two
//     broadcast float4 loads; the streamed tiles (K and V, or Q and dO with
//     their lse and delta) double-buffered by cp.async, the next tile in
//     flight during the current one's products, rows past T zero-filled;
//   * the streamed tiles and the P / dS tile are [64][64] f32 with rows of 16
//     float4 chunks, chunk c4 of row r stored at c4 ^ (r & 7): the 8 lanes of
//     a load phase read 8 rows at one chunk, or one row at 8 chunks, from
//     distinct banks without padding, which keeps a block at 112-113 KB of
//     shared memory: two blocks per SM;
//   * P = 2^(s * scale * log2e - lse * log2e) and dS = P (dP - delta), a
//     select to 0 for a dead pair, checked only in the tiles that hold one;
//     dS (dQ), or P and then dS (dK/dV), goes through one shared tile, each
//     half-warp reading only the columns it wrote (warp barriers): one block
//     barrier per tile;
//   * causal blocks skip the tiles without a live pair (dQ stops the key loop
//     at its last query row, dK/dV starts the query loop at its first key
//     row) and launch longest first; a dK/dV block of key rows past
//     valid_len writes zeros without a loop;
//   * with rotary tables, dQ and dK leave through the rotary's transpose
//     (`_rotary_transpose`'s arithmetic; the column j ^ 32 a value pairs with
//     lies in lane c ^ 8 of the same half-warp), so the f32 backward runs no
//     counter-rotation in PyTorch.
// The masking and the outputs (dq = scale * sum_j ds k_j, dk = scale *
// sum_i ds q_i, dv = sum_i p dO_i; key rows past valid_len exact zeros) are
// those of the one-row kernels, which keep the other head dims.
struct F32BwdCfg {
  static constexpr int DH = 64, BM = 64, BN = 64, NT = 128;
  static constexpr int TILE = BM * DH;   // floats of one [64][64] tile
  // Q^T, dO^T, 2 x K, 2 x V, dS^T
  static constexpr size_t smem_dq = (size_t)7 * TILE * 4;
  // K^T, V^T, 2 x Q, 2 x dO, the P / dS tile; 2 x lse and delta rows
  static constexpr size_t smem_dkv = (size_t)7 * TILE * 4 + 4 * BN * 4;
};
static_assert(2 * (F32BwdCfg::smem_dq + 1024) <= 233472 && 2 * (F32BwdCfg::smem_dkv + 1024) <= 233472,
              "two f32 backward blocks per SM");

// Float offset of chunk c4 (4 floats) of row r in a swizzled [64][64] tile.
__device__ __forceinline__ int swz(int r, int c4) { return r * 64 + ((c4 ^ (r & 7)) << 2); }

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 4 : 0)
               : "memory");
}

// Rows [r0, r0 + 64) of a [T, 64] f32 matrix into a swizzled tile by
// cp.async (rows past T zero-filled); the caller commits.
__device__ __forceinline__ void cp_rows_f32(float* tile, const float* src, int r0, int T) {
#pragma unroll
  for (int i = 0; i < 64 * 16 / 128; ++i) {
    const int idx = threadIdx.x + i * 128, r = idx >> 4, c4 = idx & 15;
    const bool in = r0 + r < T;
    cp_async16(tile + swz(r, c4), src + (size_t)(in ? r0 + r : 0) * 64 + 4 * c4, in);
  }
}

// Rows [r0, r0 + 64) of a [T, 64] f32 matrix transposed into a d-major
// [64][64] tile (zero past T); consecutive lanes take consecutive rows, so
// the scalar stores hit distinct banks.
__device__ __forceinline__ void load_rows_t_f32(float* tile_t, const float* src, int r0, int T) {
  for (int idx = threadIdx.x; idx < 64 * 16; idx += 128) {
    const int r = idx & 63, c4 = idx >> 6;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * 64 + 4 * c4);
    tile_t[(4 * c4 + 0) * 64 + r] = x.x;
    tile_t[(4 * c4 + 1) * 64 + r] = x.y;
    tile_t[(4 * c4 + 2) * 64 + r] = x.z;
    tile_t[(4 * c4 + 3) * 64 + r] = x.w;
  }
}

// out[r][i] = sum_d at[d][r] b[c + 16 i][d] over d < 64, in the order of d:
// `at` points at the thread's 8 columns of a d-major tile, `b` at row c of a
// swizzled tile (rows c + 16 i share the swizzle cx = c & 7).
__device__ __forceinline__ void tile_scores(float (&out)[8][4], const float* at, const float* b, int cx) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) out[r][i] = 0.f;
#pragma unroll 4
  for (int d4 = 0; d4 < 16; ++d4) {
    float4 bf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) bf[i] = *reinterpret_cast<const float4*>(b + 16 * i * 64 + ((d4 ^ cx) << 2));
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 xa = *reinterpret_cast<const float4*>(at + (4 * d4 + dd) * 64);
      const float4 xb = *reinterpret_cast<const float4*>(at + (4 * d4 + dd) * 64 + 4);
      const float av[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bv = lane_of(bf[i], dd);
#pragma unroll
        for (int r = 0; r < 8; ++r) out[r][i] = fmaf(av[r], bv, out[r][i]);
      }
    }
  }
}

// The thread's 8 x 4 values x[r][i] into a swizzled tile at rows c + 16 i,
// columns 8 rg .. 8 rg + 7 (chunks 2 rg and 2 rg + 1).
__device__ __forceinline__ void store_cols(float* tile, const float (&x)[8][4], int rg, int c) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c + 16 * i;
    *reinterpret_cast<float4*>(tile + swz(row, 2 * rg)) = make_float4(x[0][i], x[1][i], x[2][i], x[3][i]);
    *reinterpret_cast<float4*>(tile + swz(row, 2 * rg + 1)) = make_float4(x[4][i], x[5][i], x[6][i], x[7][i]);
  }
}

// acc[r][e] += sum_j w[j][8 rg + r] m[j][4 c + e] over the 64 rows j of two
// swizzled tiles: w (columns written by this half-warp's store_cols) and m.
__device__ __forceinline__ void tile_accumulate(float (&acc)[8][4], const float* w, const float* m, int rg, int c) {
#pragma unroll 16
  for (int j = 0; j < 64; ++j) {
    const float4 wa = *reinterpret_cast<const float4*>(w + swz(j, 2 * rg));
    const float4 wb = *reinterpret_cast<const float4*>(w + swz(j, 2 * rg + 1));
    const float4 mv = *reinterpret_cast<const float4*>(m + swz(j, c));
    const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      acc[r][0] = fmaf(wv[r], mv.x, acc[r][0]);
      acc[r][1] = fmaf(wv[r], mv.y, acc[r][1]);
      acc[r][2] = fmaf(wv[r], mv.z, acc[r][2]);
      acc[r][3] = fmaf(wv[r], mv.w, acc[r][3]);
    }
  }
}

// Rows row0 .. row0 + 7 (those < T) of a [T, 64] f32 gradient from the
// thread's accumulators (columns 4 c .. 4 c + 3), times `scale`. With the
// tables, then the rotary's transpose, `_rotary_transpose`'s arithmetic:
// g'[j] = g[j] cos[j] + g[j ^ 32] sin[j ^ 32], both products and the sum
// rounded (no contraction); column j ^ 32 lies in lane c ^ 8. So the result
// is bit-equal to `_rotary_transpose` of the untabled output.
__device__ __forceinline__ void store_grad_f32(float* out, const float (&acc)[8][4], float scale, int row0, int T,
                                               int c, const float* cos_t, const float* sin_t) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + r;
    float g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) g[e] = acc[r][e] * scale;
    if (cos_t != nullptr) {
      float gp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) gp[e] = __shfl_xor_sync(0xffffffffu, g[e], 8);
      if (row < T) {
        const float4 cr = *reinterpret_cast<const float4*>(cos_t + (size_t)row * 64 + 4 * c);
        const float4 sp = *reinterpret_cast<const float4*>(sin_t + (size_t)row * 64 + 4 * (c ^ 8));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          g[e] = __fadd_rn(__fmul_rn(g[e], lane_of(cr, e)), __fmul_rn(gp[e], lane_of(sp, e)));
      }
    }
    if (row < T) *reinterpret_cast<float4*>(out + (size_t)row * 64 + 4 * c) = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// dQ for one (b, h, 64-query-row block). Grid: (row blocks, B*H); causal
// (B*H, row blocks), the last rows (the most key tiles) first.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dq_f32_tile(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq, const int* __restrict__ valid,
                      int valid_n, const float* __restrict__ cos_t, const float* __restrict__ sin_t, int H, int T,
                      float scale) {
  using C = F32BwdCfg;
  static_assert(DH == C::DH, "the tiled f32 backward is written for head dim 64");
  constexpr int BM = C::BM, BN = C::BN, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);  // [DH][BM], d-major
  float* Dt = Qt + TILE;                           // dO^T [DH][BM]
  float* Ks = Dt + TILE;                           // 2 x [BN][DH], swizzled
  float* Vs = Ks + 2 * TILE;                       // 2 x [BN][DH], swizzled
  float* St = Vs + 2 * TILE;                       // dS^T [BN][BM], swizzled

  const int bh = CAUSAL ? blockIdx.x : blockIdx.y;
  const int q0 = (CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.x) * BM;
  const size_t rbase = (size_t)bh * T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, bh / H, T);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) * 2 + (lane >> 4), c = lane & 15, cx = c & 7;
  const int n_tiles = ((CAUSAL ? min(vl, q0 + BM) : vl) + BN - 1) / BN;

  auto load_tile = [&](int k0, int buf) {
    cp_rows_f32(Ks + buf * TILE, k + base, k0, T);
    cp_rows_f32(Vs + buf * TILE, v + base, k0, T);
    cp_async_commit();
  };
  load_tile(0, 0);
  load_rows_t_f32(Qt, q + base, q0, T);
  load_rows_t_f32(Dt, dout + base, q0, T);

  float l2[8], dl[8], acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + rg * 8 + r;
    l2[r] = row < T ? lse[rbase + row] * kLog2e : 0.f;
    dl[r] = row < T ? delta[rbase + row] : 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;
  }
  const float c2 = scale * kLog2e;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN, buf = kt & 1;
    const float* Kb = Ks + buf * TILE;
    const float* Vb = Vs + buf * TILE;
    cp_async_wait_all();
    __syncthreads();   // tile kt (and Q^T, dO^T) in; every thread done with tile kt - 1
    if (kt + 1 < n_tiles) load_tile(k0 + BN, buf ^ 1);
    // P = 2^(S c2 - lse log2e) on the thread's 8 rows x 4 keys, 0 for a dead pair
    float p[8][4], dp[8][4];
    tile_scores(p, Qt + rg * 8, Kb + c * DH, cx);
    const bool mask = k0 + BN > vl || (CAUSAL && k0 + BN - 1 > q0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = q0 + rg * 8 + r, lim = CAUSAL ? min(vl, row + 1) : vl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ex2(fmaf(p[r][i], c2, -l2[r]));
        p[r][i] = !mask || k0 + c + 16 * i < lim ? e : 0.f;
      }
    }
    // dS = P (dP - delta), dP = dO V^T
    tile_scores(dp, Dt + rg * 8, Vb + c * DH, cx);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[r][i] = p[r][i] * (dp[r][i] - dl[r]);
    __syncwarp();   // the half-warp's reads of the last tile's dS^T columns are done
    store_cols(St, p, rg, c);
    __syncwarp();   // dS^T in: a half-warp reads only the columns it wrote
    tile_accumulate(acc, St, Kb, rg, c);   // dQ += dS K
  }
  store_grad_f32(dq + base, acc, scale, q0 + rg * 8, T, c, cos_t, sin_t);
}

// dK and dV for one (b, h, 64-key-row block). Grid: (row blocks, B*H);
// causal (B*H, row blocks), the first rows (the most query tiles) first.
template <int DH, bool CAUSAL>
__global__ void __launch_bounds__(128, 2)
flash_bwd_dkv_f32_tile(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                       const float* __restrict__ dout, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                       const int* __restrict__ valid, int valid_n, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, int H, int T, float scale) {
  using C = F32BwdCfg;
  static_assert(DH == C::DH, "the tiled f32 backward is written for head dim 64");
  constexpr int BM = C::BM, BN = C::BN, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Kt = reinterpret_cast<float*>(smem_raw);  // [DH][BM], d-major
  float* Vt = Kt + TILE;                           // V^T [DH][BM]
  float* Qs = Vt + TILE;                           // 2 x [BN][DH], swizzled
  float* Ds = Qs + 2 * TILE;                       // dO: 2 x [BN][DH], swizzled
  float* Pb = Ds + 2 * TILE;                       // P, then dS: [BN][BM] (query rows), swizzled
  float* Ls = Pb + TILE;                           // lse: 2 x [BN]
  float* Es = Ls + 2 * BN;                         // delta: 2 x [BN]

  const int bh = CAUSAL ? blockIdx.x : blockIdx.y;
  const int k0 = (CAUSAL ? blockIdx.y : blockIdx.x) * BM;
  const size_t rbase = (size_t)bh * T, base = rbase * DH;
  const int vl = clamp_valid(valid, valid_n, bh / H, T);
  const int tid = threadIdx.x, lane = tid & 31;
  const int rg = (tid >> 5) * 2 + (lane >> 4), c = lane & 15, cx = c & 7;
  // causal: the query tiles below the block's first key see none of its
  // keys; a block of keys past valid_len only writes zeros
  const int it0 = CAUSAL ? k0 / BN : 0, it_end = k0 < vl ? (T + BN - 1) / BN : it0;

  auto load_tile = [&](int i0, int buf) {
    cp_rows_f32(Qs + buf * TILE, q + base, i0, T);
    cp_rows_f32(Ds + buf * TILE, dout + base, i0, T);
    const int j = tid & (BN - 1);   // threads 0-63 copy lse, 64-127 delta
    const bool in = i0 + j < T;
    cp_async4((tid < BN ? Ls : Es) + buf * BN + j, (tid < BN ? lse : delta) + rbase + (in ? i0 + j : 0), in);
    cp_async_commit();
  };
  if (it0 < it_end) load_tile(it0 * BN, 0);
  load_rows_t_f32(Kt, k + base, k0, T);
  load_rows_t_f32(Vt, v + base, k0, T);

  float ak[8][4], av[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[r][e] = av[r][e] = 0.f;
  const float c2 = scale * kLog2e;
  for (int it = it0; it < it_end; ++it) {
    const int i0 = it * BN, buf = (it - it0) & 1;
    const float* Qb = Qs + buf * TILE;
    const float* Db = Ds + buf * TILE;
    cp_async_wait_all();
    __syncthreads();   // tile it (and K^T, V^T) in; every thread done with tile it - 1
    if (it + 1 < it_end) load_tile(i0 + BN, buf ^ 1);
    float lq[4], eq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      lq[i] = Ls[buf * BN + c + 16 * i] * kLog2e;
      eq[i] = Es[buf * BN + c + 16 * i];
    }
    // P^T = 2^(S^T c2 - lse log2e) on the thread's 8 keys x 4 queries, 0 for
    // a dead pair: a key past valid_len, a query past T (a zero-filled row
    // still gives 2^-lse), causal a query before the key
    float p[8][4], dp[8][4];
    tile_scores(p, Kt + rg * 8, Qb + c * DH, cx);
    const bool mask = k0 + BM > vl || i0 + BN > T || (CAUSAL && i0 < k0 + BM - 1);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int key = k0 + rg * 8 + r;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = i0 + c + 16 * i;
        const float e = ex2(fmaf(p[r][i], c2, -lq[i]));
        p[r][i] = !mask || (key < vl && qi < T && (!CAUSAL || qi >= key)) ? e : 0.f;
      }
    }
    __syncwarp();   // the half-warp's reads of the last tile's dS columns are done
    store_cols(Pb, p, rg, c);
    // dS^T = P^T (dP^T - delta), dP^T = V dO^T
    tile_scores(dp, Vt + rg * 8, Db + c * DH, cx);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[r][i] = p[r][i] * (dp[r][i] - eq[i]);
    __syncwarp();   // P in: a half-warp reads only the columns it wrote
    tile_accumulate(av, Pb, Db, rg, c);   // dV += P^T dO
    __syncwarp();
    store_cols(Pb, dp, rg, c);
    __syncwarp();
    tile_accumulate(ak, Pb, Qb, rg, c);   // dK += dS^T Q
  }
  store_grad_f32(dk + base, ak, scale, k0 + rg * 8, T, c, cos_t, sin_t);
  store_grad_f32(dv + base, av, 1.f, k0 + rg * 8, T, c, nullptr, nullptr);
}

// ---------------------------------------------------------------------------
// launches

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Error codes of this library besides CUDA's own (which are positive).
constexpr int kErrHeadDim = -1, kErrTables = -2, kErrNoEncoder = -3, kErrEncode = -4, kErrBwdTables = -5;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found once through the runtime
// (the library links no libcuda).
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                     &status);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e == cudaSuccess && status == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A TMA map over a contiguous bf16 [BH, T, DH] tensor, viewed 3-D so that a
// box reaching past T is zero-filled (a 2-D [BH*T, DH] view would fill it
// with the next head's rows); boxes of 64 columns x `rows` rows, 128-byte
// swizzle (the layout the wgmma descriptors read).
int encode_bf16_map(CUtensorMap* map, const void* ptr, int BH, int T, int DH, int rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)DH, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)DH * 2, (cuuint64_t)T * DH * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1}, elem[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int DH, bool CAUSAL>
int run_fwd(int is_f32, const void* q, const void* k, const void* v, void* o, float* lse,
            const int* valid, int valid_n, const void* cos_t, const void* sin_t, int B, int H, int T,
            float scale, cudaStream_t stream) {
  if (is_f32) {
    if constexpr (DH == F32TileCfg::DH) {
      using C = F32TileCfg;
      const dim3 grid((T + C::BM - 1) / C::BM, H, B);
      int e = allow_smem(flash_fwd_f32_tile<DH, CAUSAL>, C::smem);
      if (e) return e;
      flash_fwd_f32_tile<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<float*>(o), lse, valid, valid_n, static_cast<const float*>(cos_t),
          static_cast<const float*>(sin_t), H, T, scale);
    } else {
      using C = F32Cfg<DH>;
      const dim3 grid((T + C::BM - 1) / C::BM, H, B);
      int e = allow_smem(flash_fwd_f32<DH, CAUSAL>, C::smem);
      if (e) return e;
      flash_fwd_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<float*>(o), lse, valid, valid_n, static_cast<const float*>(cos_t),
          static_cast<const float*>(sin_t), H, T, scale);
    }
    return (int)cudaGetLastError();
  }
  if (cos_t != nullptr || sin_t != nullptr) return kErrTables;   // bf16: q, k come rotated
  if constexpr (wgmma_fwd(DH)) {
    using C = WgCfg<DH>;
    CUtensorMap mq, mk, mv;
    int e = encode_bf16_map(&mq, q, B * H, T, DH, C::BM);
    if (!e) e = encode_bf16_map(&mk, k, B * H, T, DH, C::BN);
    if (!e) e = encode_bf16_map(&mv, v, B * H, T, DH, C::BN);
    if (e) return e;
    const dim3 grid(B * H, (T + C::BM - 1) / C::BM);
    auto kernel = lse != nullptr ? flash_fwd_wgmma<DH, true, CAUSAL> : flash_fwd_wgmma<DH, false, CAUSAL>;
    e = allow_smem(kernel, C::smem);
    if (e) return e;
    kernel<<<grid, C::NT, C::smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, valid, valid_n,
                                             H, T, scale);
  } else {
    using C = Bf16Cfg<DH>;
    const dim3 grid((T + C::BM - 1) / C::BM, H, B);
    auto kernel = lse != nullptr ? flash_fwd_bf16<DH, true, CAUSAL> : flash_fwd_bf16<DH, false, CAUSAL>;
    int e = allow_smem(kernel, C::smem);
    if (e) return e;
    kernel<<<grid, C::NT, C::smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, valid, valid_n, H, T,
        scale);
  }
  return (int)cudaGetLastError();
}

// The rotary transpose in place on a bf16 [B*H*T, DH] gradient (after a
// backward kernel that does not rotate in its epilogue).
int rotary_transpose(void* x, const void* cos_t, const void* sin_t, int B, int H, int T, cudaStream_t stream) {
  const long long rows = (long long)B * H * T, vectors = rows * (FLASH_DH / 16);
  const int blocks = (int)(vectors + 255 < 132LL * 8 * 256 ? (vectors + 255) / 256 : 132 * 8);
  flash_rotary_transpose_bf16<FLASH_DH><<<blocks, 256, 0, stream>>>(
      static_cast<__nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(cos_t),
      static_cast<const __nv_bfloat16*>(sin_t), rows, T);
  return (int)cudaGetLastError();
}

// The four TMA maps of a wgmma backward kernel (boxes of 64 rows).
int encode_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* dout, int BH,
                    int T, int DH) {
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int e = encode_bf16_map(&m[i], ptrs[i], BH, T, DH, 64);
    if (e) return e;
  }
  return 0;
}

template <int DH, bool CAUSAL>
int run_bwd_dq(int is_f32, const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, const int* valid, int valid_n, const void* cos_t,
               const void* sin_t, int B, int H, int T, float scale, cudaStream_t stream) {
  const bool rot = cos_t != nullptr && sin_t != nullptr;
  if (is_f32) {
    if constexpr (DH == F32BwdCfg::DH) {
      using C = F32BwdCfg;
      const int blocks = (T + C::BM - 1) / C::BM;
      const dim3 grid = CAUSAL ? dim3(B * H, blocks) : dim3(blocks, B * H);
      int e = allow_smem(flash_bwd_dq_f32_tile<DH, CAUSAL>, C::smem_dq);
      if (e) return e;
      flash_bwd_dq_f32_tile<DH, CAUSAL><<<grid, C::NT, C::smem_dq, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), valid, valid_n,
          rot ? static_cast<const float*>(cos_t) : nullptr, rot ? static_cast<const float*>(sin_t) : nullptr, H, T,
          scale);
    } else {
      if (cos_t != nullptr || sin_t != nullptr) return kErrBwdTables;
      using C = F32Cfg<DH>;
      const dim3 grid((T + C::BM - 1) / C::BM, H, B);
      int e = allow_smem(flash_bwd_dq_f32<DH, CAUSAL>, C::smem);
      if (e) return e;
      flash_bwd_dq_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), valid, valid_n, H, T,
          scale);
    }
    return (int)cudaGetLastError();
  }
  bool fused = false;  // the kernel applied the rotary transpose in its epilogue
  if constexpr (wgmma_fwd(DH)) {
    using C = BwdWgCfg<DH>;
    CUtensorMap m[4];
    int e = encode_bwd_maps(m, q, k, v, dout, B * H, T, DH);
    if (e) return e;
    auto kernel = flash_bwd_dq_wgmma<DH, CAUSAL, false>;
    if constexpr (!CAUSAL) {
      if (rot) {
        kernel = flash_bwd_dq_wgmma<DH, false, true>;
        fused = true;
      }
    }
    e = allow_smem(kernel, C::smem_dq);
    if (e) return e;
    kernel<<<dim3(B * H, (T + C::BM - 1) / C::BM), C::NT, C::smem_dq, stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), valid, valid_n,
        static_cast<const __nv_bfloat16*>(cos_t), static_cast<const __nv_bfloat16*>(sin_t), H, T, scale);
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
  int e = (int)cudaGetLastError();
  if (!e && rot && !fused) e = rotary_transpose(dq, cos_t, sin_t, B, H, T, stream);
  return e;
}

template <int DH, bool CAUSAL>
int run_bwd_dkv(int is_f32, const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, const int* valid,
                int valid_n, const void* cos_t, const void* sin_t, int B, int H, int T, float scale,
                cudaStream_t stream) {
  const bool rot = cos_t != nullptr && sin_t != nullptr;
  if (is_f32) {
    if constexpr (DH == F32BwdCfg::DH) {
      using C = F32BwdCfg;
      const int blocks = (T + C::BM - 1) / C::BM;
      const dim3 grid = CAUSAL ? dim3(B * H, blocks) : dim3(blocks, B * H);
      int e = allow_smem(flash_bwd_dkv_f32_tile<DH, CAUSAL>, C::smem_dkv);
      if (e) return e;
      flash_bwd_dkv_f32_tile<DH, CAUSAL><<<grid, C::NT, C::smem_dkv, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), valid,
          valid_n, rot ? static_cast<const float*>(cos_t) : nullptr, rot ? static_cast<const float*>(sin_t) : nullptr,
          H, T, scale);
    } else {
      if (cos_t != nullptr || sin_t != nullptr) return kErrBwdTables;
      using C = F32Cfg<DH>;
      const dim3 grid((T + C::BM - 1) / C::BM, H, B);
      int e = allow_smem(flash_bwd_dkv_f32<DH, CAUSAL>, C::smem);
      if (e) return e;
      flash_bwd_dkv_f32<DH, CAUSAL><<<grid, C::NT, C::smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
          valid, valid_n, H, T, scale);
    }
    return (int)cudaGetLastError();
  }
  bool fused = false;
  if constexpr (wgmma_bwd_dkv<DH>()) {
    using C = BwdWgCfg<DH>;
    CUtensorMap m[4];
    int e = encode_bwd_maps(m, q, k, v, dout, B * H, T, DH);
    if (e) return e;
    auto kernel = flash_bwd_dkv_wgmma<DH, CAUSAL, false>;
    if constexpr (!CAUSAL) {
      if (rot) {
        kernel = flash_bwd_dkv_wgmma<DH, false, true>;
        fused = true;
      }
    }
    e = allow_smem(kernel, C::smem_dkv);
    if (e) return e;
    kernel<<<dim3(B * H, (T + C::BM - 1) / C::BM), C::NT, C::smem_dkv, stream>>>(
        m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
        valid, valid_n, static_cast<const __nv_bfloat16*>(cos_t), static_cast<const __nv_bfloat16*>(sin_t), H, T,
        scale);
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
  int e = (int)cudaGetLastError();
  if (!e && rot && !fused) e = rotary_transpose(dk, cos_t, sin_t, B, H, T, stream);
  return e;
}

}  // namespace

extern "C" {

// q/k/v/o (and dout/dq/dk/dv): contiguous [B, H, T, dh], bf16 (is_f32 == 0)
// or f32 (is_f32 == 1), 16-byte aligned. lse, delta: contiguous f32 [B, H, T].
// valid: int32 device array of valid_n (1 or B) entries. cos_t/sin_t:
// [>= T, dh] rotary tables of the input type, or both null; the bf16
// forward takes q and k already rotated (covomix_flash_rotary_bf16) and
// refuses tables, the f32 forward rotates with them; the bf16 backward takes
// rotated q and k and, with tables, returns dq and dk through the rotary's
// transpose (the gradients of the unrotated q and k), and so does the f32
// backward at head dim 64 (the other head dims' f32 backward refuses
// tables). lse may be null in the forward (no logsumexp output).
// causal != 0 picks the causal instantiation (key j <= query i).
int covomix_flash_attention_fwd(int is_f32, int causal, const void* q, const void* k, const void* v,
                                void* o, float* lse, const int* valid, int valid_n, const void* cos_t,
                                const void* sin_t, int B, int H, int T, int dh, float scale,
                                void* stream) {
  if (dh != FLASH_DH) return kErrHeadDim;
  auto run = causal ? run_fwd<FLASH_DH, true> : run_fwd<FLASH_DH, false>;
  return run(is_f32, q, k, v, o, lse, valid, valid_n, cos_t, sin_t, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

int covomix_flash_attention_bwd_dq(int is_f32, int causal, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* delta, void* dq,
                                   const int* valid, int valid_n, const void* cos_t, const void* sin_t, int B,
                                   int H, int T, int dh, float scale, void* stream) {
  if (dh != FLASH_DH) return kErrHeadDim;
  auto run = causal ? run_bwd_dq<FLASH_DH, true> : run_bwd_dq<FLASH_DH, false>;
  return run(is_f32, q, k, v, dout, lse, delta, dq, valid, valid_n, cos_t, sin_t, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

int covomix_flash_attention_bwd_dkv(int is_f32, int causal, const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta, void* dk,
                                    void* dv, const int* valid, int valid_n, const void* cos_t, const void* sin_t,
                                    int B, int H, int T, int dh, float scale, void* stream) {
  if (dh != FLASH_DH) return kErrHeadDim;
  auto run = causal ? run_bwd_dkv<FLASH_DH, true> : run_bwd_dkv<FLASH_DH, false>;
  return run(is_f32, q, k, v, dout, lse, delta, dk, dv, valid, valid_n, cos_t, sin_t, B, H, T, scale,
             static_cast<cudaStream_t>(stream));
}

// The rotary pre-pass: qr = rot(q), kr = rot(k) for contiguous bf16
// [B, H, T, dh] q, k, qr, kr (16-byte aligned) and [>= T, dh] bf16 tables.
int covomix_flash_rotary_bf16(const void* q, const void* k, const void* cos_t, const void* sin_t, void* qr,
                              void* kr, int B, int H, int T, int dh, void* stream) {
  if (dh != FLASH_DH) return kErrHeadDim;
  const long long rows = (long long)B * H * T, vectors = rows * (FLASH_DH / 16);
  const int blocks = (int)(vectors + 255 < 132LL * 8 * 256 ? (vectors + 255) / 256 : 132 * 8);
  flash_rotary_halfsplit_bf16<FLASH_DH><<<dim3(blocks, 2), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(cos_t), static_cast<const __nv_bfloat16*>(sin_t),
      static_cast<__nv_bfloat16*>(qr), static_cast<__nv_bfloat16*>(kr), rows, T);
  return (int)cudaGetLastError();
}

const char* covomix_cuda_error_string(int code) {
  switch (code) {
    case kErrHeadDim: return "head dim differs from the FLASH_DH this library was built for";
    case kErrTables: return "the bf16 forward takes q and k already rotated (the rotary pre-pass), not tables";
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    case kErrEncode: return "cuTensorMapEncodeTiled refused the tensor map";
    case kErrBwdTables: return "the f32 backward kernels take rotary tables at head dim 64 only";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
