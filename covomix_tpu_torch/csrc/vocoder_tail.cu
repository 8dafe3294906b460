// Fused HiFi-GAN upsample stage and tail for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of covomix_tpu/ops/vocoder_tail.py,
//   `_stage_kernel` (reached through `fused_stage`):
//       lrelu(0.1) -> ConvTranspose1d(rate 4, kernel 4, padding 0) ->
//       3-branch ResBlock1 MRF (18 convs) / 3            [B, T1, Cin] -> [B, 4*T1, C]
//   `_tail_kernel` (reached through `fused_tail`):
//       lrelu(0.1) -> ConvTranspose1d(rate 2, kernel 4, padding 1) -> MRF / 3 ->
//       lrelu(0.01) -> conv_post(kernel 7, C -> 1) -> tanh  [B, T2, Cin] -> [B, 2*T2] f32
//
// What bounds it on the card: at the covomix shapes (C = 62 / 31, B = 1,
// T = 512 mel frames) the stage does ~20 G MAC on ~9 MB of input and output
// and the tail ~10 G MAC on ~5 MB, so both are bound by the tensor cores, not
// by memory, as long as the 20 convs' intermediates never go to device
// memory. That is what the TPU kernel did too, and what this kernel keeps: one
// block owns a tile of output positions of one row plus a halo (the worst
// branch's cumulative reach, e.g. 5+5+15+5+25+5 = 60 for kernel 11 with
// dilations 1/3/5, plus 3 for conv_post), loads its input frames once, and
// runs the upsample and all 18 MRF convs out of three shared-memory buffers
// (upsample output, residual state, conv1 output), with the branch sum in
// f32 in shared memory. Each conv is computed only on the rows that later
// convs still read (the margin shrinks by the conv's reach), and only the
// centre of the tile is written out.
//
// The TPU kernel's space-to-depth lane packing (4 samples x 31 channels in
// 124 lanes) is not carried over: here activations are [rows, channels] with
// the channels padded to CP = 32 or 64 and a row stride that keeps the
// tensor-core operand loads free of bank conflicts.
//
// The MRF convs run on the tensor cores in bf16 (mma.sync m16n8k16, f32
// accumulate): a conv is sum over taps of [rows x CP] x [CP x CP] products,
// with the A operand read from the shared buffer at a row offset of
// dilation*(tap - k/2) and the weights pre-packed by the caller in fragment
// order and staged in shared memory one tap at a time (a conv's weights, up
// to 88 KB, would not stay in the L1 left beside the buffers). The upsample, conv_post and the whole f32 variant use scalar FMAs.
// No TMA, wgmma or pipelining yet: this is the simple, right version.
//
// Rounding follows the TPU kernel: the activated input, the upsample output,
// each conv1 output, its activation and each residual state are rounded to
// the activation type; conv sums, the branch sum, the /3 and the post-lrelu
// input are f32; the post-lrelu output is rounded before conv_post. Rows
// outside [0, U) are set to zero after every conv, which equals the zero
// padding of the op-by-op convs at the sequence edges.
//
// Kernel sizes and dilations are runtime arguments (3 branches x 3 levels).
//
// C interface (ctypes): covomix_vocoder_fused(...) returns 0, a CUDA error
// code of the launch, or a negative code (covomix_vocoder_error_string).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;          // 16 warps; __launch_bounds__ keeps them within 128 registers
constexpr int kWarps = kThreads / 32;
constexpr int kUpRows = 4;             // frames per upsample item
constexpr int kSlackRows = 32;         // rows read past a region by the last 2 x 16-row m-tiles
constexpr int kMaxSmem = 232448;       // 227 KB: the most a block may opt in to on sm_90
constexpr int kPostTaps = 7;
constexpr float kSlope = 0.1f;
constexpr float kPostSlope = 0.01f;

typedef __nv_bfloat16 bf16;

struct Taps {
  int k[3];
  int d[3][3];
};

template <typename T>
struct Params {
  const T* x;          // [B, t_in, cin]
  void* out;           // stage: T [B, U, c]; tail: float [B, U]
  const T* w_up;       // [4, cin, CP]: stage phase j / tail tap j
  const float* b_up;   // [CP]
  const T* w_mrf;      // 18 convs of k * CP * CP (bf16: mma fragment order; f32: [k][ci][co])
  const float* b_mrf;  // [18, CP]
  const T* w_post;     // tail: [7, CP]
  float b_post;
  int t_in, cin, c, U;
  int tile, halo;
  Taps taps;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

__device__ __forceinline__ float lrelu(float v, float slope) { return v >= 0.f ? v : v * slope; }

// Row stride (elements) of the shared activation buffers. bf16: CP + 8 puts
// the 8 rows of an mma A fragment on 8 different bank groups; f32: CP + 4
// does the same for the scalar path's 4 rows per warp.
template <typename T, int CP>
__host__ __device__ constexpr int row_stride() { return sizeof(T) == 2 ? CP + 8 : CP + 4; }

// 8 consecutive weights as f32.
__device__ __forceinline__ void load8(const float* w, float (&o)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(w));
  const float4 b = __ldg(reinterpret_cast<const float4*>(w) + 1);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const bf16* w, float (&o)[8]) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(w));
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// round(lrelu(v, 0.1)) of a pair of bf16 values, computed in f32.
__device__ __forceinline__ uint32_t act_bf16x2(uint32_t v) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  const __nv_bfloat162 r = __floats2bfloat162_rn(lrelu(f.x, kSlope), lrelu(f.y, kSlope));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

enum ConvMode { kConv1 = 0, kConv2 = 1 };

// One MRF conv from shared buffer `in` to shared buffer `out` over the rows
// [row0, row0 + n). With ACT the conv reads round(lrelu(in)) (conv1 reads the
// raw residual state); without it `in` is already activated (conv2 reads the
// stored conv1 output). kConv1 stores round(lrelu(round(acc + b))), the conv2
// input; kConv2 stores round((acc + b) + resid) and, at a branch's last level,
// adds that to the f32 branch sum (or sets it, for the first branch).
template <typename T, int CP>
struct Conv {
  const T* in;
  T* out;
  const T* resid;
  float* bsum;         // null unless this is a branch's last conv2
  int bsum_row0;
  bool assign;         // first branch: bsum = state instead of +=
  int row0, n, k, d;
  const T* w;
  const float* bias;
  int a0, U;           // absolute position of buffer row 0; sequence length

  __device__ __forceinline__ void store_pair(int mode, int r, int co, float v0, float v1) const {
    constexpr int S = row_stride<T, CP>();
    const int a = a0 + r;
    float y0 = 0.f, y1 = 0.f;
    if (a >= 0 && a < U) {
      if (mode == kConv1) {
        y0 = round_to<T>(lrelu(round_to<T>(v0 + bias[co]), kSlope));
        y1 = round_to<T>(lrelu(round_to<T>(v1 + bias[co + 1]), kSlope));
      } else {
        y0 = round_to<T>((v0 + bias[co]) + to_f(resid[r * S + co]));
        y1 = round_to<T>((v1 + bias[co + 1]) + to_f(resid[r * S + co + 1]));
      }
    }
    out[r * S + co] = from_f<T>(y0);
    out[r * S + co + 1] = from_f<T>(y1);
    if (bsum != nullptr) {
      float* s = bsum + (r - bsum_row0) * CP + co;
      if (assign) {
        s[0] = y0;
        s[1] = y1;
      } else {
        s[0] += y0;
        s[1] += y1;
      }
    }
  }
};

// Scalar conv: one thread per (row, group of 8 output channels).
template <typename T, int CP, bool ACT>
__device__ void conv_scalar(const Conv<T, CP>& cv, int mode, int c) {
  constexpr int S = row_stride<T, CP>();
  constexpr int G = CP / 8;
  for (int item = threadIdx.x; item < cv.n * G; item += kThreads) {
    const int r = cv.row0 + item / G, cg = item % G;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int tau = 0; tau < cv.k; ++tau) {
      const T* in = cv.in + (r + cv.d * (tau - cv.k / 2)) * S;
      const T* w = cv.w + (size_t)tau * CP * CP + cg * 8;
      for (int ci = 0; ci < c; ++ci) {
        const float a = ACT ? round_to<T>(lrelu(to_f(in[ci]), kSlope)) : to_f(in[ci]);
        float wv[8];
        load8(w + ci * CP, wv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[e] = fmaf(a, wv[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; e += 2) cv.store_pair(mode, r, cg * 8 + e, acc[e], acc[e + 1]);
  }
}

// Tensor-core conv (bf16): each warp owns units of MT 16-row m-tiles and all
// CP output channels; for every tap and 16-channel k-step it loads the A
// fragments from the shifted rows and the B fragments (pre-packed, 8 bytes a
// lane) from `wsm`, the tap's weights staged in shared memory by the whole
// block. The next tap's weights are loaded into registers while this tap
// computes, so the taps walk in step across the warps (two barriers a tap);
// a warp without a unit in the last round only helps stage the weights.
template <int CP, bool ACT>
__device__ void conv_mma(const Conv<bf16, CP>& cv, int mode, uint2* wsm) {
  constexpr int S = row_stride<bf16, CP>();
  constexpr int NT = CP / 8, KS = CP / 16, MT = 2;
  constexpr int kTapVecs = CP * CP * 2 / 16;                  // one tap's weights in 16-byte vectors
  constexpr int kPer = (kTapVecs + kThreads - 1) / kThreads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n_units = (cv.n + 16 * MT - 1) / (16 * MT);
  const int rounds = (n_units + kWarps - 1) / kWarps;
  const uint4* wg = reinterpret_cast<const uint4*>(cv.w);
  uint4* ws4 = reinterpret_cast<uint4*>(wsm);
  for (int round = 0; round < rounds; ++round) {
    const int u = warp + round * kWarps;
    const bool active = u < n_units;
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    uint4 pre[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      if (idx < kTapVecs) pre[i] = __ldg(wg + idx);
    }
#pragma unroll 1
    for (int tau = 0; tau < cv.k; ++tau) {
      __syncthreads();                      // every warp is done with the previous tap
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        if (idx < kTapVecs) ws4[idx] = pre[i];
      }
      __syncthreads();
      if (tau + 1 < cv.k) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int idx = threadIdx.x + i * kThreads;
          if (idx < kTapVecs) pre[i] = __ldg(wg + (size_t)(tau + 1) * kTapVecs + idx);
        }
      }
      if (!active) continue;
      const int off = cv.d * (tau - cv.k / 2);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* base = cv.in + (cv.row0 + (u * MT + mt) * 16 + g + off) * S + ks * 16 + 2 * t;
          a[mt][0] = ld32(base);
          a[mt][1] = ld32(base + 8 * S);
          a[mt][2] = ld32(base + 8);
          a[mt][3] = ld32(base + 8 * S + 8);
          if (ACT) {
#pragma unroll
            for (int e = 0; e < 4; ++e) a[mt][e] = act_bf16x2(a[mt][e]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint2 b = wsm[(ks * NT + nt) * 32 + lane];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b.x, b.y);
        }
      }
    }
    if (!active) continue;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = (u * MT + mt) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int co = nt * 8 + 2 * t;
        if (r < cv.n) cv.store_pair(mode, cv.row0 + r, co, acc[mt][nt][0], acc[mt][nt][1]);
        if (r + 8 < cv.n) cv.store_pair(mode, cv.row0 + r + 8, co, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  }
}

template <typename T, int CP, bool ACT>
__device__ __forceinline__ void run_conv(const Conv<T, CP>& cv, int mode, int c, uint2* wsm) {
  if constexpr (std::is_same<T, bf16>::value) {
    conv_mma<CP, ACT>(cv, mode, wsm);
  } else {
    conv_scalar<T, CP, ACT>(cv, mode, c);
  }
}

__host__ __device__ inline int post_reach(bool tail) { return tail ? kPostTaps / 2 : 0; }

// Shared memory of one block: three activation buffers of (E + slack) rows,
// the f32 branch sum of (tile + 2 * post reach) rows and, for bf16, one tap's
// MRF weights.
template <typename T, int CP, bool TAIL>
__host__ __device__ inline size_t buffer_elems(int tile, int halo) {
  return (size_t)(tile + 2 * halo + kSlackRows) * row_stride<T, CP>();
}
template <typename T, int CP, bool TAIL>
__host__ __device__ inline size_t smem_bytes(int tile, int halo) {
  return 3 * buffer_elems<T, CP, TAIL>(tile, halo) * sizeof(T) +
         (size_t)(tile + 2 * post_reach(TAIL)) * CP * sizeof(float) + (sizeof(T) == 2 ? CP * CP * 2 : 0);
}
// Input frames a block reads (they are staged in the conv1 buffer first).
template <bool TAIL>
__host__ __device__ inline int frames_per_block(int tile, int halo) {
  const int e = tile + 2 * halo;
  return TAIL ? e / 2 + 2 : e / 4;
}

template <typename T, int CP, bool TAIL>
__global__ void __launch_bounds__(kThreads) vocoder_fused_kernel(Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = row_stride<T, CP>();
  constexpr int G = CP / 8;
  const int post = post_reach(TAIL);
  const int E = p.tile + 2 * p.halo;
  const size_t nbuf = buffer_elems<T, CP, TAIL>(p.tile, p.halo);
  T* up = reinterpret_cast<T*>(smem);
  T* st = up + nbuf;
  T* hb = st + nbuf;
  float* bsum = reinterpret_cast<float*>(hb + nbuf);
  uint2* wsm = reinterpret_cast<uint2*>(bsum + (p.tile + 2 * post) * CP);
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * p.tile;
  const int a0 = p0 - p.halo;          // absolute position of buffer row 0 (a multiple of 4)

  // 1. zero the buffers: padded channels and slack rows must read as 0
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem);
    const int nz = (int)(3 * nbuf * sizeof(T) / 4);
    for (int i = threadIdx.x; i < nz; i += kThreads) z[i] = 0u;
  }
  __syncthreads();

  // 2. the block's input frames, activated and rounded, staged in hb
  const int nf = frames_per_block<TAIL>(p.tile, p.halo);
  const int f0 = TAIL ? a0 / 2 - 1 : a0 / 4;
  {
    const T* x = p.x + (size_t)b * p.t_in * p.cin;
    for (int idx = threadIdx.x; idx < nf * p.cin; idx += kThreads) {
      const int f = f0 + idx / p.cin;
      float v = 0.f;
      if (f >= 0 && f < p.t_in) v = round_to<T>(lrelu(to_f(x[(size_t)f * p.cin + idx % p.cin]), kSlope));
      hb[idx] = from_f<T>(v);
    }
  }
  __syncthreads();

  // 3. upsample into `up` on all E rows (scalar FMAs). One item: a phase j,
  //    kUpRows consecutive frames and 8 output channels, so each 8-wide
  //    weight vector is loaded once for kUpRows frames. Row i = F * fr + j
  //    reads hb frame rows fr + off. Stage: y[4t+j] = w[j] x[t], hb row fr is
  //    frame t. Tail: y[2t] = w[1] x[t] + w[3] x[t-1], y[2t+1] = w[0] x[t+1] +
  //    w[2] x[t], and hb row fr + 1 is frame t (f0 = a0/2 - 1).
  {
    constexpr int F = TAIL ? 2 : 4;                   // upsampled rows per input frame
    const int n_groups = (E / F + kUpRows - 1) / kUpRows;
    for (int item = threadIdx.x; item < n_groups * F * G; item += kThreads) {
      const int cg = item % G, j = (item / G) % F, fr0 = item / (G * F) * kUpRows;
      int taps[2] = {j, 0}, offs[2] = {0, 0};
      if (TAIL) {
        taps[0] = j == 0 ? 1 : 0;
        offs[0] = j == 0 ? 1 : 2;
        taps[1] = j == 0 ? 3 : 2;
        offs[1] = j == 0 ? 0 : 1;
      }
      float acc[kUpRows][8];
#pragma unroll
      for (int q = 0; q < kUpRows; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
      for (int pr = 0; pr < (TAIL ? 2 : 1); ++pr) {
        const T* xs = hb + (fr0 + offs[pr]) * p.cin;
        const T* w = p.w_up + (size_t)taps[pr] * p.cin * CP + cg * 8;
        for (int ci = 0; ci < p.cin; ++ci) {
          float wv[8];
          load8(w + (size_t)ci * CP, wv);
#pragma unroll
          for (int q = 0; q < kUpRows; ++q) {
            const float xv = to_f(xs[q * p.cin + ci]);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(xv, wv[e], acc[q][e]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUpRows; ++q) {
        const int i = F * (fr0 + q) + j;
        const int a = a0 + i;
        if (i >= E) break;
        const bool valid = a >= 0 && a < p.U;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int co = cg * 8 + e;
          up[i * S + co] = from_f<T>(valid ? round_to<T>(acc[q][e] + p.b_up[co]) : 0.f);
        }
      }
    }
  }
  __syncthreads();

  // 4. the MRF: 3 branches x 3 levels x (conv1, conv2), each conv on the rows
  //    the later convs still read (margin m around the tile)
  size_t w_off = 0;
  int conv_idx = 0;
  for (int br = 0; br < 3; ++br) {
    const int k = p.taps.k[br];
    int m = post;
    for (int l = 0; l < 3; ++l) m += p.taps.d[br][l] * (k / 2) + k / 2;
    for (int l = 0; l < 3; ++l) {
      const int d = p.taps.d[br][l];
      const T* src = l == 0 ? up : st;
      Conv<T, CP> c1;
      const int m1 = m - d * (k / 2);
      c1.in = src; c1.out = hb; c1.resid = nullptr; c1.bsum = nullptr; c1.bsum_row0 = 0; c1.assign = false;
      c1.row0 = p.halo - m1; c1.n = p.tile + 2 * m1; c1.k = k; c1.d = d;
      c1.w = p.w_mrf + w_off; c1.bias = p.b_mrf + conv_idx * CP; c1.a0 = a0; c1.U = p.U;
      run_conv<T, CP, true>(c1, kConv1, p.c, wsm);
      w_off += (size_t)k * CP * CP;
      ++conv_idx;
      __syncthreads();

      Conv<T, CP> c2;
      const int m2 = m1 - k / 2;
      c2.in = hb; c2.out = st; c2.resid = src;
      c2.bsum = l == 2 ? bsum : nullptr; c2.bsum_row0 = p.halo - post; c2.assign = br == 0;
      c2.row0 = p.halo - m2; c2.n = p.tile + 2 * m2; c2.k = k; c2.d = 1;
      c2.w = p.w_mrf + w_off; c2.bias = p.b_mrf + conv_idx * CP; c2.a0 = a0; c2.U = p.U;
      run_conv<T, CP, false>(c2, kConv2, p.c, wsm);
      w_off += (size_t)k * CP * CP;
      ++conv_idx;
      __syncthreads();
      m = m2;
    }
  }

  // 5. epilogue: only the centre of the tile is written
  if (!TAIL) {
    T* out = static_cast<T*>(p.out) + (size_t)b * p.U * p.c;
    for (int idx = threadIdx.x; idx < p.tile * p.c; idx += kThreads) {
      const int i = idx / p.c, co = idx % p.c;
      if (p0 + i < p.U) out[(size_t)(p0 + i) * p.c + co] = from_f<T>(bsum[i * CP + co] / 3.0f);
    }
  } else {
    // m = round(lrelu(bsum / 3, 0.01)) on tile + 2*3 rows (into hb), then conv_post + tanh
    const int nr = p.tile + 2 * post;
    for (int idx = threadIdx.x; idx < nr * CP; idx += kThreads) {
      const int i = idx / CP, co = idx % CP;
      hb[i * S + co] = from_f<T>(lrelu(bsum[idx] / 3.0f, kPostSlope));
    }
    __syncthreads();
    float* out = static_cast<float*>(p.out) + (size_t)b * p.U;
    for (int i = threadIdx.x; i < p.tile; i += kThreads) {
      if (p0 + i >= p.U) continue;
      float acc = 0.f;
      for (int tau = 0; tau < kPostTaps; ++tau) {
        const T* mrow = hb + (i + tau) * S;
        const T* w = p.w_post + tau * CP;
        for (int ci = 0; ci < p.c; ++ci) acc = fmaf(to_f(mrow[ci]), to_f(w[ci]), acc);
      }
      out[p0 + i] = tanhf(acc + p.b_post);
    }
  }
}

constexpr int kErrChannels = -1;
constexpr int kErrSmem = -2;
constexpr int kErrTaps = -3;

// The block halo: the worst branch's cumulative reach (+ conv_post's),
// rounded up to a multiple of 4 so buffer rows keep the upsample phases.
int block_halo(const Taps& taps, bool tail) {
  int worst = 0;
  for (int br = 0; br < 3; ++br) {
    int reach = 0;
    for (int l = 0; l < 3; ++l) reach += taps.d[br][l] * (taps.k[br] / 2) + taps.k[br] / 2;
    if (reach > worst) worst = reach;
  }
  return (worst + post_reach(tail) + 3) / 4 * 4;
}

template <typename T, int CP, bool TAIL>
int launch(Params<T> p, int B, cudaStream_t stream) {
  // the largest tile (a multiple of 32, at most 256) whose buffers fit
  int tile = 256;
  size_t smem = 0;
  for (; tile >= 32; tile -= 32) {
    smem = smem_bytes<T, CP, TAIL>(tile, p.halo);
    const bool frames_fit =
        (size_t)frames_per_block<TAIL>(tile, p.halo) * p.cin <= buffer_elems<T, CP, TAIL>(tile, p.halo);
    if (smem <= (size_t)kMaxSmem && frames_fit) break;
  }
  if (tile < 32) return kErrSmem;
  p.tile = tile;
  auto kernel = vocoder_fused_kernel<T, CP, TAIL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.U + tile - 1) / tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool TAIL>
int dispatch_cp(int cp, const Params<T>& p, int B, cudaStream_t stream) {
  if (cp == 32) return launch<T, 32, TAIL>(p, B, stream);
  if (cp == 64) return launch<T, 64, TAIL>(p, B, stream);
  return kErrChannels;
}

template <typename T>
int run(int tail, int cp, const void* x, void* out, const void* w_up, const float* b_up, const void* w_mrf,
        const float* b_mrf, const void* w_post, float b_post, const int* taps, int B, int t_in, int cin, int c,
        cudaStream_t stream) {
  if (c < 1 || c > cp || cin < 1) return kErrChannels;
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.out = out;
  p.w_up = static_cast<const T*>(w_up);
  p.b_up = b_up;
  p.w_mrf = static_cast<const T*>(w_mrf);
  p.b_mrf = b_mrf;
  p.w_post = static_cast<const T*>(w_post);
  p.b_post = b_post;
  p.t_in = t_in;
  p.cin = cin;
  p.c = c;
  p.U = tail ? 2 * t_in : 4 * t_in;
  for (int br = 0; br < 3; ++br) {
    p.taps.k[br] = taps[br];
    if (taps[br] < 1) return kErrTaps;
    for (int l = 0; l < 3; ++l) {
      p.taps.d[br][l] = taps[3 + 3 * br + l];
      if (taps[3 + 3 * br + l] < 1) return kErrTaps;
    }
  }
  p.halo = block_halo(p.taps, tail != 0);
  p.tile = 0;
  return tail ? dispatch_cp<T, true>(cp, p, B, stream) : dispatch_cp<T, false>(cp, p, B, stream);
}

}  // namespace

extern "C" {

// tail == 0: fused stage, x [B, t_in, cin] -> out [B, 4*t_in, c] of x's type.
// tail == 1: fused tail,  x [B, t_in, cin] -> out [B, 2*t_in] f32.
// is_f32 picks the type of x, w_up, w_mrf, w_post (bf16 otherwise). cp: the
// channel padding (32 or 64) the weights were packed with. taps: host array
// of 12 ints, the 3 kernel sizes then the 3x3 dilations by branch.
int covomix_vocoder_fused(int tail, int is_f32, int cp, const void* x, void* out, const void* w_up,
                          const float* b_up, const void* w_mrf, const float* b_mrf, const void* w_post,
                          float b_post, const int* taps, int B, int t_in, int cin, int c, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    return run<float>(tail, cp, x, out, w_up, b_up, w_mrf, b_mrf, w_post, b_post, taps, B, t_in, cin, c, s);
  return run<bf16>(tail, cp, x, out, w_up, b_up, w_mrf, b_mrf, w_post, b_post, taps, B, t_in, cin, c, s);
}

const char* covomix_vocoder_error_string(int code) {
  if (code == kErrChannels) return "channels must be in [1, cp] with cp 32 or 64, and cin >= 1";
  if (code == kErrSmem) return "the block's buffers do not fit in shared memory at any tile size";
  if (code == kErrTaps) return "kernel sizes and dilations must be >= 1";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
