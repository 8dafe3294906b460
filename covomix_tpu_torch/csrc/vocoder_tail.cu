// Fused HiFi-GAN upsample stage and tail for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernels of covomix_tpu/ops/vocoder_tail.py,
//   `_stage_kernel` (:369, reached through `fused_stage` :428):
//       lrelu(0.1) -> ConvTranspose1d(rate 4, kernel 4, padding 0) ->
//       3-branch ResBlock1 MRF (18 convs) / 3            [B, T1, Cin] -> [B, 4*T1, C]
//   `_tail_kernel` (:209, reached through `fused_tail` :270):
//       lrelu(0.1) -> ConvTranspose1d(rate 2, kernel 4, padding 1) -> MRF / 3 ->
//       lrelu(0.01) -> conv_post(kernel 7, C -> 1) -> tanh  [B, T2, Cin] -> [B, 2*T2] f32
//
// What bounds it on the card: the operations. At the covomix shapes (C = 62 /
// 31) the stage does ~4 k MAC per byte of input and output and the tail ~2 k,
// far above the card's ~150 MAC per byte, as long as the 20 convs'
// intermediates never go to device memory. So one block owns a tile of output
// positions of one row plus a halo (the worst branch's cumulative reach, e.g.
// 5+5+15+5+25+5 = 60 for kernel 11 with dilations 1/3/5, plus 3 for
// conv_post), loads its input frames once, and runs the upsample and all 18
// MRF convs out of shared-memory buffers (upsample output `up`, residual
// state `st`, its activation `ab` (bf16 only), conv1 output `hb`). Each conv
// runs only on the rows that later convs still read (the margin shrinks by
// the conv's reach), and only the centre of the tile is written out. The f32
// branch sum of the first two branches goes to a scratch area in device
// memory (it stays in L2); the last branch's last conv finishes it in its
// stores (the stage writes its output there, the tail conv_post's input).
//
// The TPU kernel's space-to-depth lane packing is not carried over:
// activations are [rows, channels] with the channels padded to CP = 32 or 64
// and a row stride that keeps the tensor-core operand loads free of bank
// conflicts.
//
// The bf16 MRF (mma.sync m16n8k16, f32 accumulate) is a sum over taps of
// [rows x CP] x [CP x CP] products. Its design, against what held the first
// version at 5-11 % of its bound (two block barriers per tap, 4-9 idle warps
// in every conv, the activation redone at every tap):
//  - weights by the copy engine: the 126 taps of the 18 convs stream in
//    order, one bulk copy of a whole tap (8 KB at CP 64, 2 KB at CP 32,
//    packed tap-major in fragment order by the wrapper) into a ring of 3 / 8
//    shared-memory stages, each with a "full" mbarrier (bytes in) and a
//    release count; the last of the 16 warps to release a stage refills it
//    with the tap NS further on, so the next conv's first taps arrive while
//    the current conv ends. (A producer warp of its own would make 17 warps,
//    and ptxas then caps a thread at 96 registers: the loop spilled.)
//  - no block barrier inside a conv: each of the 16 warps owns a fixed set of
//    units (a 16-row m-tile x a 32-channel slice) for the whole conv, keeps
//    their accumulators in registers and walks the taps once, waiting on
//    "full" and releasing each stage. The only block barriers left are the
//    18 between convs (conv2 reads all of conv1's output) and one per branch
//    after the pass that activates `up`; the first version had two per tap;
//  - every warp busy in every conv: units of 16 rows x 32 channels spread
//    the conv's 200-600 rows over all 16 warps (the first version's 32-row x
//    64-channel units left 4-9 warps idle), at most 3 units a warp;
//  - A fragments by ldmatrix.x4 from the tap-shifted rows of an activated
//    buffer (row strides 144 / 80 bytes, multiples of 16): conv2 stores the
//    new state's activation beside the state, so conv1 never activates in its
//    tap loop (the first version did it 2k times per element);
//  - the stores: a unit's residual and branch-sum pairs are loaded before its
//    outputs are stored, as packed bf16 pairs;
//  - the prologue: the upsample weights come into `st` / `ab` (free until the
//    MRF) by bulk copy, the input frames in 16-byte chunks;
//  - the grid: covomix_vocoder_plan picks the tile from the card's SM count
//    so that the last wave of one-block-per-SM blocks is not mostly empty;
//    the launch checks the tile it is given against the same limits.
// Measured with chip_smoke.py (NVIDIA H100 80GB HBM3, 700.00 W, bf16, time
// on the card): stage [1, 40964, 125] 0.99 ms, tail [1, 163856, 62] 0.75 ms,
// at 16 % / 11 % of their bounds; the first version took 1.53 / 1.36 ms on
// the same card.
// What bounds the MRF loop now is the SM's shared-memory bandwidth beside its
// mma.sync rate: each k-step of a warp reads ~2.5 KB of fragments for 12
// products. The upsample and conv_post use scalar FMAs; wgmma for the MRF
// (B read by the tensor cores once per warpgroup) and the upsample on the
// tensor cores are the next steps.
//
// The f32 form (hifigan_inference's default) keeps true f32 FMAs on the CUDA
// cores (no TF32), so it is bound by the card's f32 FMA rate. Its first
// version ran at 6 % of that bound (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W; 28 % now): one thread per (row, 8 channels) loaded 8
// weights from L1/L2 per input channel for 8 FMAs, and four f32 buffers left
// a 64-row tile whose halo made the convs do 1.69x the output rows' work.
// Now (conv_f32):
//  - the weights come by the copy engine through the same ring (2 x 16 KB /
//    8 x 4 KB), packed [ci][h][g][4] so that a warp's channel groups read one
//    contiguous run;
//  - register blocking: a thread owns R rows x 8 output channels for the
//    whole conv (R = 1-4 from the conv's rows), 8 + R shared loads per 32 R
//    FMAs; no block barrier inside a conv;
//  - three buffers: conv1 activates the state as it loads it (2 ops per
//    loaded value, which feeds 8 FMAs), so there is no activated copy, and
//    rows are clamped into the conv's region (no slack rows): the stage
//    keeps a 112-row tile, the tail up to 304, picked by the same cost model
//    as bf16 (full waves x the busiest thread's issue slots).
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

#include "mbarrier.cuh"

namespace {

constexpr int kThreads = 512;          // 16 warps; __launch_bounds__ keeps them within 128 registers
constexpr int kWarps = kThreads / 32;
// Frames per upsample item: bf16 6 (stage) / 5 (tail), so that one round
// of the 512 threads covers a block's frames at the planned tiles with few
// threads idle (and each weight load feeds that many frames); f32 4.
template <typename T, bool TAIL>
__host__ __device__ constexpr int up_rows() { return sizeof(T) == 2 ? (TAIL ? 5 : 6) : 4; }
// Rows a bf16 conv's last 16-row m-tile reads past its region (the f32
// conv clamps its rows into the region and reads none).
template <typename T>
__host__ __device__ constexpr int slack_rows() { return sizeof(T) == 2 ? 16 : 0; }
constexpr int kMaxSmem = 232448;       // 227 KB: the most a block may opt in to on sm_90
constexpr int kPostTaps = 7;
constexpr float kSlope = 0.1f;
constexpr float kPostSlope = 0.01f;
constexpr int kUnitRows = 16;          // a bf16 MRF unit: one m-tile of rows ...
constexpr int kUnitChannels = 32;      // ... by one slice of output channels
constexpr int kMaxUnits = 3;           // per warp and conv (accumulators in registers)

typedef __nv_bfloat16 bf16;

// The weight ring: one MRF tap a stage (bf16: 3 x 8 KB at CP 64, 8 x 2 KB
// at CP 32; f32: 2 x 16 KB, 8 x 4 KB); after the stages, each stage's
// "full" mbarrier (8 bytes) and release count (4 bytes), 16 bytes a stage
// with the padding; then the bf16 upsample weights' mbarrier in 16 bytes of
// its own. The activation buffers start right after (16-byte aligned).
template <typename T, int CP>
__host__ __device__ constexpr int ring_stages() { return CP == 64 ? (sizeof(T) == 2 ? 3 : 2) : 8; }
template <typename T, int CP>
__host__ __device__ constexpr int tap_bytes() { return CP * CP * (int)sizeof(T); }
template <typename T, int CP>
__host__ __device__ constexpr int ring_full_offset() { return ring_stages<T, CP>() * tap_bytes<T, CP>(); }
template <typename T, int CP>
__host__ __device__ constexpr int ring_released_offset() {
  return ring_full_offset<T, CP>() + 8 * ring_stages<T, CP>();
}
template <typename T, int CP>
__host__ __device__ constexpr int wup_bar_offset() { return ring_full_offset<T, CP>() + 16 * ring_stages<T, CP>(); }
template <typename T, int CP>
__host__ __device__ constexpr size_t ring_bytes() { return (size_t)wup_bar_offset<T, CP>() + 16; }
template <typename T, int CP>
constexpr bool ring_layout_ok() {
  return ring_released_offset<T, CP>() + 4 * ring_stages<T, CP>() <= wup_bar_offset<T, CP>() &&
         wup_bar_offset<T, CP>() % 8 == 0 && (size_t)wup_bar_offset<T, CP>() + 8 <= ring_bytes<T, CP>() &&
         ring_bytes<T, CP>() % 16 == 0;
}
static_assert(ring_layout_ok<bf16, 64>() && ring_layout_ok<bf16, 32>() && ring_layout_ok<float, 64>() &&
                  ring_layout_ok<float, 32>(),
              "every ring mbarrier and count lies before the activation buffers, which start 16-byte aligned");

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
  const T* w_mrf;      // 18 convs of k * CP * CP (bf16: mma fragment order; f32: [k][ci][h][g][4], co = 8g + 4h + e)
  const float* b_mrf;  // [18, CP]
  const T* w_post;     // tail: [7, CP]
  float* scratch;      // [B, blocks per row, tile + 2 * post, CP] f32: each block's branch sum
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
__device__ __forceinline__ void load8(const bf16* w, float (&o)[8]) {   // w in global or shared memory
  const uint4 v = *reinterpret_cast<const uint4*>(w);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two consecutive activations (the first at an even index) as f32, and back.
__device__ __forceinline__ float2 load_pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store_pair_to(float* p, float y0, float y1) {
  *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
}
__device__ __forceinline__ void store_pair_to(bf16* p, float y0, float y1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// What a conv stores. kAct (conv1): round(lrelu(round(acc + b))), the conv2
// input. kState (conv2 with a next level): the new residual state
// round((acc + b) + resid) and its activation round(lrelu(state)) into
// `act_out`, the next conv1's input. kSum (a branch's last conv2): the state,
// added to the f32 branch sum (set, for the first branch). kFinal (the last
// branch's last conv2): the state added to the branch sum, which is then
// final: the stage writes sum / 3 to its output, the tail
// round(lrelu(sum / 3, 0.01)) into `post_in`, conv_post's input rows.
enum StoreMode { kAct = 0, kState = 1, kSum = 2, kFinal = 3 };

// One MRF conv from shared buffer `in` (activated rows) to shared buffer
// `out` over the rows [row0, row0 + n); rows outside [0, U) are stored as 0.
template <typename T, int CP>
struct Conv {
  const T* in;
  T* out;
  T* act_out;          // kState, bf16 (f32 keeps no activated copy)
  const T* resid;      // kState, kSum
  float* bsum;         // kSum, kFinal: the block's [tile + 2 post, CP] in device memory
  int bsum_row0;       // buffer row of bsum's row 0
  bool assign;         // first branch: bsum = state instead of +=
  T* post_in;          // kFinal, tail: [tile + 2 post, S] rows in shared memory
  T* out_g;            // kFinal, stage: the output row [U, c] in device memory
  int c;               // kFinal, stage: output channels
  int row0, n, k, d;
  const T* w;
  const float* bias;
  int a0, U;           // absolute position of buffer row 0; sequence length

  __device__ __forceinline__ bool inside(int r) const { return a0 + r >= 0 && a0 + r < U; }
  __device__ __forceinline__ float2* bsum_at(int r, int co) const {
    return reinterpret_cast<float2*>(bsum + (r - bsum_row0) * CP + co);
  }

  // kFinal: the pair (co, co + 1) of row r's final branch sum.
  __device__ __forceinline__ void finish(int r, int co, float s0, float s1) const {
    constexpr int S = row_stride<T, CP>();
    if (post_in != nullptr) {
      store_pair_to(post_in + (r - bsum_row0) * S + co, round_to<T>(lrelu(s0 / 3.0f, kPostSlope)),
                    round_to<T>(lrelu(s1 / 3.0f, kPostSlope)));
    } else if (inside(r)) {
      T* o = out_g + (size_t)(a0 + r) * c + co;
      if (co < c) o[0] = from_f<T>(s0 / 3.0f);
      if (co + 1 < c) o[1] = from_f<T>(s1 / 3.0f);
    }
  }

  // The f32 conv's store of the pair (co, co + 1) of row r from the conv
  // sums v and the biases b (f32 keeps no activated copy of the state: the
  // next conv1 activates it as it loads it).
  template <int MODE>
  __device__ __forceinline__ void put(int r, int co, float v0, float v1, float2 b) const {
    constexpr int S = row_stride<T, CP>();
    float y0 = 0.f, y1 = 0.f;
    if (inside(r)) {
      if (MODE == kAct) {
        y0 = round_to<T>(lrelu(round_to<T>(v0 + b.x), kSlope));
        y1 = round_to<T>(lrelu(round_to<T>(v1 + b.y), kSlope));
      } else {
        const float2 res = load_pair(resid + r * S + co);
        y0 = round_to<T>((v0 + b.x) + res.x);
        y1 = round_to<T>((v1 + b.y) + res.y);
      }
    }
    store_pair_to(out + r * S + co, y0, y1);
    if (MODE == kSum || MODE == kFinal) {
      float2* sum = bsum_at(r, co);
      const float2 o = assign ? make_float2(0.f, 0.f) : *sum;
      if (MODE == kSum)
        *sum = make_float2(o.x + y0, o.y + y1);
      else
        finish(r, co, o.x + y0, o.y + y1);
    }
  }
};

// bf16 pairs packed in 32 bits: round two f32 to it, widen it, and
// round(lrelu(y)) of it as max(y, round(0.1 y)) (equal for bf16 y: rounding
// is monotone and y itself representable).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ float2 widen_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ uint32_t act_bf16x2(uint32_t v) {
  const float2 f = widen_bf16x2(v);
  const uint32_t s = pack_bf16x2(f.x * kSlope, f.y * kSlope);
  const __nv_bfloat162 r = __hmax2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Four 8x8 b16 matrices from shared memory: lanes 0-15 give the addresses of
// rows 0-15 at k-columns 0-7, lanes 16-31 the same rows at k-columns 8-15,
// which leaves the m16n8k16 A fragment in a[0..3].
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The bf16 weight ring of a block: stage s holds MRF tap j (the taps of the
// 18 convs in order) for j = s, s + NS, ...; `full` counts a tap's bytes in,
// `released` the warps done with it.
struct Ring {
  const unsigned char* stages;
  uint32_t full;         // shared address of full[0]; full[s] at full + 8 s
  unsigned* released;    // [NS]
  const unsigned char* w;   // the packed taps in device memory
  int n_taps;
};

// Tap j into its stage by one bulk copy (one thread).
template <typename T, int CP>
__device__ __forceinline__ void fill_stage(const Ring& ring, int j) {
  constexpr int NS = ring_stages<T, CP>(), TB = tap_bytes<T, CP>();
  const int s = j % NS;
  mbar_expect_tx(ring.full + 8 * s, TB);
  bulk_copy_g2s(smem_u32(ring.stages + s * TB), ring.w + (size_t)j * TB, TB, ring.full + 8 * s);
}

// A warp done with tap j's stage releases it; the last of the 16 warps to
// release it refills it with the tap NS further on.
template <typename T, int CP>
__device__ __forceinline__ void release_stage(const Ring& ring, int j, int lane) {
  constexpr int NS = ring_stages<T, CP>();
  const int s = j % NS;
  __syncwarp();
  if (lane == 0) {
    __threadfence_block();   // this warp's reads of the stage before its release
    if (atomicAdd(ring.released + s, 1u) == kWarps - 1) {
      ring.released[s] = 0;   // read again only after the refill lands
      if (j + NS < ring.n_taps) {
        __threadfence_block();
        fence_proxy_async();   // every warp's reads before the copy engine's writes
        fill_stage<T, CP>(ring, j + NS);
      }
    }
  }
}

// The f32 conv (CUDA-core FMAs, true f32): thread t owns the 8 output
// channels 8 g .. 8 g + 7 (g = t % G) of the rows row0 + t / G + SLOTS i
// (i < R, R = ceil(n / SLOTS) picked per conv by run_conv), clamped into the
// conv's n rows (a clamped row is computed and not stored), so it reads no
// row past the region. It walks the conv's taps from the weight ring once,
// with no block barrier: per 4 input channels it loads a float4 of each of
// its R rows (conv1 applies lrelu to it: its input is the raw state) and two
// float4 of weights per channel, 8 + R loads for 32 R FMAs; each weight feeds
// R rows and each activation 8 channels. The ring's taps are packed
// [ci][h][g][4] (co = 8 g + 4 h + e), so the 8 (4) channel groups of a warp
// read one contiguous 128-byte (64-byte) run, and the warp's 4 (8) rows of a
// float4 lie on distinct banks (row stride CP + 4).
template <int CP, int MODE, int R>
__device__ void conv_f32(const Conv<float, CP>& cv, const Ring& ring, int tap0) {
  constexpr int S = row_stride<float, CP>(), G = CP / 8, SLOTS = kThreads / G;
  constexpr int NS = ring_stages<float, CP>(), TB = tap_bytes<float, CP>();
  const int lane = threadIdx.x & 31, g = threadIdx.x % G, slot = threadIdx.x / G;
  int rows[R];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = cv.row0 + min(slot + SLOTS * i, cv.n - 1);
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
#pragma unroll 1
  for (int tau = 0; tau < cv.k; ++tau) {
    const int j = tap0 + tau, s = j % NS;
    mbar_wait(ring.full + 8 * s, (j / NS) & 1);
    const float* w = reinterpret_cast<const float*>(ring.stages + s * TB) + 4 * g;
    const int shift = cv.d * (tau - cv.k / 2);
    const float* a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = cv.in + (rows[i] + shift) * S;
#pragma unroll 8
    for (int ci = 0; ci < CP; ci += 4) {
      float4 x[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        x[i] = *reinterpret_cast<const float4*>(a[i] + ci);
        if (MODE == kAct) {   // lrelu(x) = max(x, 0.1 x), its product rounded as lrelu rounds it
          x[i].x = fmaxf(x[i].x, x[i].x * kSlope);
          x[i].y = fmaxf(x[i].y, x[i].y * kSlope);
          x[i].z = fmaxf(x[i].z, x[i].z * kSlope);
          x[i].w = fmaxf(x[i].w, x[i].w * kSlope);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float4 w0 = *reinterpret_cast<const float4*>(w + (ci + cc) * CP);
        const float4 w1 = *reinterpret_cast<const float4*>(w + (ci + cc) * CP + CP / 2);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float xv = cc == 0 ? x[i].x : cc == 1 ? x[i].y : cc == 2 ? x[i].z : x[i].w;
          acc[i][0] = fmaf(xv, w0.x, acc[i][0]);
          acc[i][1] = fmaf(xv, w0.y, acc[i][1]);
          acc[i][2] = fmaf(xv, w0.z, acc[i][2]);
          acc[i][3] = fmaf(xv, w0.w, acc[i][3]);
          acc[i][4] = fmaf(xv, w1.x, acc[i][4]);
          acc[i][5] = fmaf(xv, w1.y, acc[i][5]);
          acc[i][6] = fmaf(xv, w1.z, acc[i][6]);
          acc[i][7] = fmaf(xv, w1.w, acc[i][7]);
        }
      }
    }
    release_stage<float, CP>(ring, j, lane);
  }
  float2 bias[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bias[e] = __ldg(reinterpret_cast<const float2*>(cv.bias + 8 * g + 2 * e));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (slot + SLOTS * i >= cv.n) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) cv.template put<MODE>(rows[i], 8 * g + 2 * e, acc[i][2 * e], acc[i][2 * e + 1], bias[e]);
  }
}

// Tensor-core conv (bf16). Warp w owns the channel slice w % (CP / 32) and
// every (16 / slices)-th 16-row m-tile from w / slices on, for the whole
// conv (at most kMaxUnits; tile_fits keeps the widest conv within
// that), with those units' accumulators in registers. It walks the conv's
// taps (ring indices tap0 ...) once: wait on the stage's "full" mbarrier,
// load the slice's B fragments (pre-packed, 8 bytes a lane) and the A
// fragment of each unit by ldmatrix from the tap-shifted rows, then release
// the stage; the last of the 16 warps to release it refills it with the tap
// NS further on. No block barrier inside the conv.
template <int CP, int MODE>
__device__ void conv_mma(const Conv<bf16, CP>& cv, const Ring& ring, int tap0) {
  constexpr int S = row_stride<bf16, CP>();
  constexpr int NT = CP / 8, KS = CP / 16, SLICES = CP / kUnitChannels, PER_SLICE = kWarps / SLICES;
  constexpr int NS = ring_stages<bf16, CP>(), TB = tap_bytes<bf16, CP>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int slice = warp % SLICES, wm = warp / SLICES;
  const int n_mt = (cv.n + kUnitRows - 1) / kUnitRows;
  const int nu = n_mt > wm ? (n_mt - wm + PER_SLICE - 1) / PER_SLICE : 0;
  if (nu > kMaxUnits) __trap();
  float acc[kMaxUnits][4][4] = {};
  const uint32_t a_lane = smem_u32(cv.in) + ((cv.row0 + wm * kUnitRows + (lane & 15)) * S + (lane >> 4) * 8) * 2;
  const uint2* w_lane = reinterpret_cast<const uint2*>(ring.stages) + slice * 4 * 32 + lane;
#pragma unroll 1
  for (int tau = 0; tau < cv.k; ++tau) {
    const int j = tap0 + tau, s = j % NS;
    mbar_wait(ring.full + 8 * s, (j / NS) & 1);
    const uint2* w = w_lane + s * (TB / 8);
    const uint32_t a_tap = a_lane + cv.d * (tau - cv.k / 2) * S * 2;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {   // a k-step's fragments are all loaded before its products
      uint2 b[4];
      uint32_t a[kMaxUnits][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = w[(ks * NT + nt) * 32];
#pragma unroll
      for (int u = 0; u < kMaxUnits; ++u)
        if (u < nu) ldmatrix_x4(a[u], a_tap + (u * PER_SLICE * kUnitRows * S + ks * 16) * 2);
#pragma unroll
      for (int u = 0; u < kMaxUnits; ++u) {
        if (u < nu) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[u][nt], a[u], b[nt].x, b[nt].y);
        }
      }
    }
    release_stage<bf16, CP>(ring, j, lane);
  }
  // a unit's stores, row r then row r + 8 (h): the row's residual and
  // branch-sum pairs loaded first (all in flight at once), then the outputs,
  // as packed bf16 pairs; acc[u][nt][2h], [2h + 1] hold the row's pair nt
  float2 bias[4];   // of the lane's output channel pairs
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    bias[nt] = __ldg(reinterpret_cast<const float2*>(cv.bias + slice * kUnitChannels + nt * 8 + 2 * t));
#pragma unroll
  for (int u = 0; u < kMaxUnits; ++u) {
    if (u >= nu) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = (wm + u * PER_SLICE) * kUnitRows + g + 8 * h;
      if (r >= cv.n) break;
      const int row = cv.row0 + r;
      uint32_t res[4];
      float2 old[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = slice * kUnitChannels + nt * 8 + 2 * t;
        if (MODE != kAct) res[nt] = *reinterpret_cast<const uint32_t*>(cv.resid + row * S + co);
        if (MODE >= kSum) old[nt] = cv.assign ? make_float2(0.f, 0.f) : *cv.bsum_at(row, co);
      }
      const bool inside = cv.inside(row);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = slice * kUnitChannels + nt * 8 + 2 * t;
        float x0 = acc[u][nt][2 * h] + bias[nt].x, x1 = acc[u][nt][2 * h + 1] + bias[nt].y;
        if (MODE != kAct) {
          const float2 rf = widen_bf16x2(res[nt]);
          x0 += rf.x;
          x1 += rf.y;
        }
        const uint32_t y = inside ? pack_bf16x2(x0, x1) : 0u;
        *reinterpret_cast<uint32_t*>(cv.out + row * S + co) = MODE == kAct ? act_bf16x2(y) : y;
        if (MODE == kState) *reinterpret_cast<uint32_t*>(cv.act_out + row * S + co) = act_bf16x2(y);
        if (MODE >= kSum) {
          const float2 yf = widen_bf16x2(y);
          const float s0 = old[nt].x + yf.x, s1 = old[nt].y + yf.y;
          if (MODE == kSum)
            *cv.bsum_at(row, co) = make_float2(s0, s1);
          else
            cv.finish(row, co, s0, s1);
        }
      }
    }
  }
}

// The f32 conv's row slots (threads per 8-channel group) and the most rows a
// slot takes (tile_fits holds every conv to SLOTS x kMaxRowsF32 rows).
template <int CP>
__host__ __device__ constexpr int f32_slots() { return kThreads / (CP / 8); }
constexpr int kMaxRowsF32 = 4;

template <typename T, int CP, int MODE>
__device__ __forceinline__ void run_conv(const Conv<T, CP>& cv, const Ring& ring, int tap0) {
  if constexpr (std::is_same<T, bf16>::value) {
    conv_mma<CP, MODE>(cv, ring, tap0);
  } else {
    switch ((cv.n + f32_slots<CP>() - 1) / f32_slots<CP>()) {
      case 1: conv_f32<CP, MODE, 1>(cv, ring, tap0); break;
      case 2: conv_f32<CP, MODE, 2>(cv, ring, tap0); break;
      case 3: conv_f32<CP, MODE, 3>(cv, ring, tap0); break;
      case kMaxRowsF32: conv_f32<CP, MODE, kMaxRowsF32>(cv, ring, tap0); break;
      default: __trap();
    }
  }
}

__host__ __device__ constexpr int post_reach(bool tail) { return tail ? kPostTaps / 2 : 0; }

// Shared memory of one block: the weight ring and its mbarriers, then the
// activation buffers of (E + slack) rows: bf16 four (upsample output,
// residual state, its activation, conv1 output), f32 three (no activated
// copy: conv1 activates the state as it loads it, which buys f32 the tile
// the fourth buffer would take). The f32 branch sum lives in device memory
// (the caller's scratch), where it stays in L2.
template <typename T>
__host__ __device__ constexpr int n_buffers() { return sizeof(T) == 2 ? 4 : 3; }
template <typename T, int CP, bool TAIL>
__host__ __device__ constexpr size_t buffer_elems(int tile, int halo) {
  return (size_t)(tile + 2 * halo + slack_rows<T>()) * row_stride<T, CP>();
}
template <typename T, int CP, bool TAIL>
__host__ __device__ constexpr size_t smem_bytes(int tile, int halo) {
  return ring_bytes<T, CP>() + n_buffers<T>() * buffer_elems<T, CP, TAIL>(tile, halo) * sizeof(T);
}
// The budget the ring depths were picked for: at the default taps' halos
// (60 stage, 64 tail) the bf16 stage keeps a 208-row tile beside its 3
// stages of 8 KB, the tail a 480-row tile beside its 8 stages of 2 KB.
static_assert(smem_bytes<bf16, 64, false>(208, 60) <= kMaxSmem, "stage: 3 ring stages and a 208-row tile");
static_assert(smem_bytes<bf16, 32, true>(480, 64) <= kMaxSmem, "tail: 8 ring stages and a 480-row tile");
// f32: the stage keeps a 112-row tile beside its 2 stages of 16 KB (its 18
// convs then do 1.39x the output rows' work, 1.69x at the old 64 rows), the
// tail 304 rows beside its 8 stages of 4 KB.
static_assert(smem_bytes<float, 64, false>(112, 60) <= kMaxSmem, "f32 stage: 2 ring stages and a 112-row tile");
static_assert(smem_bytes<float, 32, true>(304, 64) <= kMaxSmem, "f32 tail: 8 ring stages and a 304-row tile");
// Input frames a block reads (they are staged in the conv1 buffer first).
template <bool TAIL>
__host__ __device__ inline int frames_per_block(int tile, int halo) {
  const int e = tile + 2 * halo;
  return TAIL ? e / 2 + 2 : e / 4;
}

template <typename T, int CP, bool TAIL>
__global__ void __launch_bounds__(kThreads, 1) vocoder_fused_kernel(Params<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kMma = std::is_same<T, bf16>::value;
  constexpr int NS = ring_stages<T, CP>();
  constexpr int S = row_stride<T, CP>();
  constexpr int G = CP / 8;
  const int post = post_reach(TAIL);
  const int E = p.tile + 2 * p.halo;
  const size_t nbuf = buffer_elems<T, CP, TAIL>(p.tile, p.halo);
  Ring ring;
  ring.stages = smem;
  ring.full = smem_u32(smem + ring_full_offset<T, CP>());
  ring.released = reinterpret_cast<unsigned*>(smem + ring_released_offset<T, CP>());
  ring.w = reinterpret_cast<const unsigned char*>(p.w_mrf);
  ring.n_taps = 6 * (p.taps.k[0] + p.taps.k[1] + p.taps.k[2]);
  T* up = reinterpret_cast<T*>(smem + ring_bytes<T, CP>());
  T* st = up + nbuf;
  T* ab = kMma ? st + nbuf : nullptr;   // bf16 only: the activated state
  T* hb = (kMma ? ab : st) + nbuf;
  float* bsum = p.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (p.tile + 2 * post) * CP;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * p.tile;
  const int a0 = p0 - p.halo;          // absolute position of buffer row 0 (a multiple of 4)

  // bf16: the upsample weights [4, cin, CP] come into st and ab (free until
  // the MRF) by four bulk copies, the first taps of the ring after them
  const T* w_up = p.w_up;
  if constexpr (kMma) {
    const uint32_t bar_wup = smem_u32(smem + wup_bar_offset<T, CP>());
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        mbar_init(ring.full + 8 * s, 1);
        ring.released[s] = 0;
      }
      mbar_init(bar_wup, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const uint32_t phase_bytes = p.cin * CP * sizeof(T);
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_wup, 4 * phase_bytes);
      for (int j = 0; j < 4; ++j)
        bulk_copy_g2s(smem_u32(st) + j * phase_bytes, p.w_up + (size_t)j * p.cin * CP, phase_bytes, bar_wup);
      for (int j = 0; j < NS && j < ring.n_taps; ++j) fill_stage<T, CP>(ring, j);   // under the upsample
    }
    w_up = st;
  } else {
    // f32: the upsample reads its weights from device memory; the ring's
    // first taps arrive under the staging and the upsample
    if (threadIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        mbar_init(ring.full + 8 * s, 1);
        ring.released[s] = 0;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int j = 0; j < NS && j < ring.n_taps; ++j) fill_stage<T, CP>(ring, j);
    }
  }

  // 1. the block's input frames, activated and rounded, staged in hb. No
  //    buffer is zeroed: every row a kept output reads is written first (the
  //    rows a conv's last m-tile reads past its region only feed rows that
  //    are not stored).
  const int nf = frames_per_block<TAIL>(p.tile, p.halo);
  const int f0 = TAIL ? a0 / 2 - 1 : a0 / 4;
  //    The frames are one flat range of x; it is read in 16-byte chunks
  //    aligned in x (whose start is 16-byte aligned; the last chunk, if x
  //    ends inside it, element by element), each element of the range's
  //    live part [0, t_in) stored once, the frames outside as 0.
  {
    constexpr int V = 16 / sizeof(T);   // elements a chunk
    const long long n_x = (long long)gridDim.y * p.t_in * p.cin;   // x's elements
    const long long row = (long long)b * p.t_in * p.cin;   // x's element index of row b's first frame
    const long long lo = (long long)f0 * p.cin, hi = lo + (long long)nf * p.cin;   // the range, in row b
    const long long live_lo = lo > 0 ? lo : 0, live_hi = hi < (long long)p.t_in * p.cin ? hi : (long long)p.t_in * p.cin;
    if (live_lo < live_hi) {
      const long long c0 = (row + live_lo) / V, c1 = (row + live_hi + V - 1) / V;
      for (long long ch = c0 + threadIdx.x; ch < c1; ch += kThreads) {
        T v[V];
        if ((ch + 1) * V <= n_x) {
          *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p.x + ch * V);
        } else {
          for (int i = 0; i < V; ++i) v[i] = ch * V + i < n_x ? p.x[ch * V + i] : from_f<T>(0.f);
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const long long e = ch * V + i - row;
          if (e >= live_lo && e < live_hi) hb[e - lo] = from_f<T>(round_to<T>(lrelu(to_f(v[i]), kSlope)));
        }
      }
    }
    for (long long e = lo + threadIdx.x; e < live_lo && e < hi; e += kThreads) hb[e - lo] = from_f<T>(0.f);
    for (long long e = (live_hi > lo ? live_hi : lo) + threadIdx.x; e < hi; e += kThreads) hb[e - lo] = from_f<T>(0.f);
  }
  __syncthreads();

  if constexpr (kMma) mbar_wait(smem_u32(smem + wup_bar_offset<T, CP>()), 0);

  // 2. upsample into `up` on all E rows (scalar FMAs). One item: a phase j,
  //    R consecutive frames and 8 output channels, so each 8-wide
  //    weight vector is loaded once for R frames. Row i = F * fr + j
  //    reads hb frame rows fr + off. Stage: y[4t+j] = w[j] x[t], hb row fr is
  //    frame t. Tail: y[2t] = w[1] x[t] + w[3] x[t-1], y[2t+1] = w[0] x[t+1] +
  //    w[2] x[t], and hb row fr + 1 is frame t (f0 = a0/2 - 1).
  {
    constexpr int F = TAIL ? 2 : 4;                   // upsampled rows per input frame
    constexpr int R = up_rows<T, TAIL>();
    const int n_groups = (E / F + R - 1) / R;
    for (int item = threadIdx.x; item < n_groups * F * G; item += kThreads) {
      const int cg = item % G, j = (item / G) % F, fr0 = item / (G * F) * R;
      int taps[2] = {j, 0}, offs[2] = {0, 0};
      if (TAIL) {
        taps[0] = j == 0 ? 1 : 0;
        offs[0] = j == 0 ? 1 : 2;
        taps[1] = j == 0 ? 3 : 2;
        offs[1] = j == 0 ? 0 : 1;
      }
      float acc[R][8];
#pragma unroll
      for (int q = 0; q < R; ++q)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[q][e] = 0.f;
#pragma unroll
      for (int pr = 0; pr < (TAIL ? 2 : 1); ++pr) {
        const T* xs = hb + (fr0 + offs[pr]) * p.cin;
        const T* w = w_up + (size_t)taps[pr] * p.cin * CP + cg * 8;
#pragma unroll(TAIL ? 1 : 2)
        for (int ci = 0; ci < p.cin; ++ci) {
          float wv[8];
          load8(w + (size_t)ci * CP, wv);
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const float xv = to_f(xs[q * p.cin + ci]);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[q][e] = fmaf(xv, wv[e], acc[q][e]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
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

  // 3. the MRF: 3 branches x 3 levels x (conv1, conv2), each conv on the rows
  //    the later convs still read (margin m around the tile); the convs take
  //    their taps from the ring in order (tap: the ring index of a conv's
  //    first). bf16 conv1 reads `ab`, the activated state: the upsample
  //    output's at a branch's start (one pass), then what the previous conv2
  //    stored; f32 conv1 reads the state itself (`up`, then `st`) and
  //    activates it as it loads it.
  size_t w_off = 0;
  int conv_idx = 0, tap = 0;
  for (int br = 0; br < 3; ++br) {
    const int k = p.taps.k[br];
    if constexpr (kMma) {
      const uint32_t* u32 = reinterpret_cast<const uint32_t*>(up);
      uint32_t* a32 = reinterpret_cast<uint32_t*>(ab);
      for (int i = threadIdx.x; i < (int)nbuf / 2; i += kThreads) a32[i] = act_bf16x2(u32[i]);
      __syncthreads();
    }
    int m = post;
    for (int l = 0; l < 3; ++l) m += p.taps.d[br][l] * (k / 2) + k / 2;
    for (int l = 0; l < 3; ++l) {
      const int d = p.taps.d[br][l];
      const T* src = l == 0 ? up : st;
      Conv<T, CP> c1;
      const int m1 = m - d * (k / 2);
      c1.in = kMma ? ab : src; c1.out = hb; c1.act_out = nullptr; c1.resid = nullptr; c1.bsum = nullptr; c1.bsum_row0 = 0;
      c1.assign = false; c1.post_in = nullptr; c1.out_g = nullptr; c1.c = p.c; c1.row0 = p.halo - m1; c1.n = p.tile + 2 * m1; c1.k = k; c1.d = d;
      c1.w = p.w_mrf + w_off; c1.bias = p.b_mrf + conv_idx * CP; c1.a0 = a0; c1.U = p.U;
      run_conv<T, CP, kAct>(c1, ring, tap);
      w_off += (size_t)k * CP * CP;
      tap += k;
      ++conv_idx;
      __syncthreads();

      Conv<T, CP> c2;
      const int m2 = m1 - k / 2;
      c2.in = hb; c2.out = st; c2.act_out = kMma && l < 2 ? ab : nullptr; c2.resid = src;
      c2.bsum = l == 2 ? bsum : nullptr; c2.bsum_row0 = p.halo - post; c2.assign = br == 0;
      // f32 tail: the post-lrelu rows go to `up`, free after the last branch's level 0
      c2.post_in = TAIL ? (kMma ? ab : up) : nullptr;
      c2.out_g = TAIL ? nullptr : static_cast<T*>(p.out) + (size_t)b * p.U * p.c;
      c2.c = p.c;
      c2.row0 = p.halo - m2; c2.n = p.tile + 2 * m2; c2.k = k; c2.d = 1;
      c2.w = p.w_mrf + w_off; c2.bias = p.b_mrf + conv_idx * CP; c2.a0 = a0; c2.U = p.U;
      if (l < 2)
        run_conv<T, CP, kState>(c2, ring, tap);
      else if (br < 2)
        run_conv<T, CP, kSum>(c2, ring, tap);
      else
        run_conv<T, CP, kFinal>(c2, ring, tap);
      w_off += (size_t)k * CP * CP;
      tap += k;
      ++conv_idx;
      __syncthreads();
      m = m2;
    }
  }

  // 4. epilogue: the stage's output was written by its last conv; the tail
  //    runs conv_post + tanh on the post-lrelu rows the last conv left in
  //    `ab` (f32: `up`), with conv_post's weights in `up` (f32: `hb`), free
  //    after the MRF
  if (TAIL) {
    T* w_post = kMma ? up : hb;
    const T* post_rows = kMma ? ab : up;
    for (int idx = threadIdx.x; idx < kPostTaps * CP; idx += kThreads) w_post[idx] = p.w_post[idx];
    __syncthreads();
    // one thread per output row, over all CP channels in pairs (the padded
    // channels hold zeros on both sides, so the sum is that of the c channels)
    float* out = static_cast<float*>(p.out) + (size_t)b * p.U;
    for (int i = threadIdx.x; i < p.tile; i += kThreads) {
      if (p0 + i >= p.U) continue;
      float acc = 0.f;
#pragma unroll
      for (int tau = 0; tau < kPostTaps; ++tau) {
        const T* mrow = post_rows + (i + tau) * S;
        const T* w = w_post + tau * CP;
#pragma unroll 8
        for (int ci = 0; ci < CP; ci += 2) {
          const float2 m = load_pair(mrow + ci), wv = load_pair(w + ci);
          acc = fmaf(m.x, wv.x, acc);
          acc = fmaf(m.y, wv.y, acc);
        }
      }
      out[p0 + i] = tanhf(acc + p.b_post);
    }
  }
}

constexpr int kErrChannels = -1;
constexpr int kErrSmem = -2;
constexpr int kErrTaps = -3;
constexpr int kErrTile = -4;
constexpr int kErrAlign = -5;
constexpr int kMrfConvs = 18;

int read_taps(const int* taps, Taps* out) {
  for (int br = 0; br < 3; ++br) {
    out->k[br] = taps[br];
    if (taps[br] < 1) return kErrTaps;
    for (int l = 0; l < 3; ++l) {
      out->d[br][l] = taps[3 + 3 * br + l];
      if (taps[3 + 3 * br + l] < 1) return kErrTaps;
    }
  }
  return 0;
}

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

// The kernel size and margin of each MRF conv in the kernel's order: a conv
// runs on tile + 2 * margin rows, the rows the later convs still read.
void conv_margins(const Taps& taps, bool tail, int (&k)[kMrfConvs], int (&margin)[kMrfConvs]) {
  int i = 0;
  for (int br = 0; br < 3; ++br) {
    const int kb = taps.k[br];
    int m = post_reach(tail);
    for (int l = 0; l < 3; ++l) m += taps.d[br][l] * (kb / 2) + kb / 2;
    for (int l = 0; l < 3; ++l) {
      m -= taps.d[br][l] * (kb / 2);
      k[i] = kb, margin[i++] = m;   // conv1
      m -= kb / 2;
      k[i] = kb, margin[i++] = m;   // conv2
    }
  }
}

// The bf16 MRF units (16-row m-tile x 32-channel slice) of a conv on n rows:
// warp w owns slice w % slices and every (16 / slices)-th m-tile from
// w / slices on (conv_mma). The busiest warp is warp 0.
template <int CP>
int warp_units(int n, int warp) {
  constexpr int slices = CP / kUnitChannels, per_slice = kWarps / slices;
  const int n_mt = (n + kUnitRows - 1) / kUnitRows, wm = warp / slices;
  return n_mt > wm ? (n_mt - wm + per_slice - 1) / per_slice : 0;
}

// The f32 conv's units (one row x 8 output channels, a thread's item) of a
// conv on n rows that warp w holds: its lanes' row slots (conv_f32) times
// the rows each slot takes. The busiest warp is warp 0.
template <int CP>
int f32_warp_units(int n, int warp) {
  constexpr int slots = f32_slots<CP>(), per_warp = 32 / (CP / 8);
  int units = 0;
  for (int slot = warp * per_warp; slot < (warp + 1) * per_warp; ++slot)
    units += slot < n ? (n - slot + slots - 1) / slots : 0;
  return units * (CP / 8);
}

// 0 if a block of `tile` output rows fits: a positive multiple of 4, the
// buffers and the staged input frames within shared memory; for bf16 room
// for the upsample weights in two buffers and no warp with more than
// kMaxUnits units in the widest conv; for f32 no thread with more than
// kMaxRowsF32 rows in the widest conv.
template <typename T, int CP, bool TAIL>
int tile_fits(int tile, int halo, int cin, const Taps& taps) {
  if (tile < 4 || tile % 4 != 0) return kErrTile;
  const size_t buffer = buffer_elems<T, CP, TAIL>(tile, halo);
  if (smem_bytes<T, CP, TAIL>(tile, halo) > (size_t)kMaxSmem ||
      (size_t)frames_per_block<TAIL>(tile, halo) * cin > buffer)
    return kErrSmem;
  if (std::is_same<T, bf16>::value) {
    if (2 * buffer < (size_t)4 * cin * CP) return kErrSmem;   // w_up in st, ab
    int k[kMrfConvs], margin[kMrfConvs];
    conv_margins(taps, TAIL, k, margin);
    for (int i = 0; i < kMrfConvs; ++i)
      if (warp_units<CP>(tile + 2 * margin[i], 0) > kMaxUnits) return kErrTile;
  } else {
    int k[kMrfConvs], margin[kMrfConvs];
    conv_margins(taps, TAIL, k, margin);
    for (int i = 0; i < kMrfConvs; ++i)
      if (tile + 2 * margin[i] > kMaxRowsF32 * f32_slots<CP>()) return kErrTile;
  }
  return 0;
}

// An estimate of a bf16 block's time in SM cycles, used only to weigh one
// tile against another (the constants are weights, not measurements): the
// busiest warp's unit k-steps over the 18 convs at ~128 cycles each while
// 16 warps share the tensor cores, plus the upsample's rounds of items
// (each SM sub-partition issues one warp-instruction of FMAs a cycle).
template <int CP, bool TAIL>
long long block_cycles(int tile, int halo, int cin, const Taps& taps) {
  constexpr long long kKstepCycles = 128;
  constexpr int R = up_rows<bf16, TAIL>(), F = TAIL ? 2 : 4;
  int k[kMrfConvs], margin[kMrfConvs];
  conv_margins(taps, TAIL, k, margin);
  long long ksteps = 0;
  for (int i = 0; i < kMrfConvs; ++i) ksteps += (long long)k[i] * warp_units<CP>(tile + 2 * margin[i], 0) * (CP / 16);
  const int e = tile + 2 * halo;
  const long long items = (long long)(((e + F - 1) / F + R - 1) / R) * F * (CP / 8);
  const long long up = (items + kThreads - 1) / kThreads * 4 * R * 8 * cin * (TAIL ? 2 : 1);
  return ksteps * kKstepCycles + up;
}

// The same estimate for an f32 block, in issue slots of the busiest thread
// (16 warps on 4 schedulers): per conv and tap, per 4 input channels, its R
// rows' 32 R FMAs, 8 + R loads and, in conv1, 8 R activation ops; plus the
// upsample's rounds of items.
template <int CP, bool TAIL>
long long block_cycles_f32(int tile, int halo, int cin, const Taps& taps) {
  constexpr int Ru = up_rows<float, TAIL>(), F = TAIL ? 2 : 4;
  int k[kMrfConvs], margin[kMrfConvs];
  conv_margins(taps, TAIL, k, margin);
  long long slots = 0;
  for (int i = 0; i < kMrfConvs; ++i) {
    const long long r = (tile + 2 * margin[i] + f32_slots<CP>() - 1) / f32_slots<CP>();
    slots += (long long)k[i] * (CP / 4) * (32 * r + 8 + r + (i % 2 == 0 ? 8 * r : 0));
  }
  const int e = tile + 2 * halo;
  const long long items = (long long)(((e + F - 1) / F + Ru - 1) / Ru) * F * (CP / 8);
  const long long up = (items + kThreads - 1) / kThreads * (2 + Ru + 8 * Ru) * cin * (TAIL ? 2 : 1);
  return 4 * (slots + up);
}

// The tile for B rows of U outputs on `sms` SMs: of the multiples of 16
// that fit, the one with the least estimated time, full waves x block
// cycles (one block per SM), so that the last wave is not mostly empty
// (the larger tile on a tie). 0 if none fits.
template <typename T, int CP, bool TAIL>
int pick_tile(int halo, int cin, const Taps& taps, int B, int U, int sms) {
  int best = 0;
  long long best_cost = 0;
  for (int tile = 16; tile < 1024; tile += 16) {
    if (tile_fits<T, CP, TAIL>(tile, halo, cin, taps) != 0) continue;
    const long long blocks = (long long)B * ((U + tile - 1) / tile);
    const long long cycles = std::is_same<T, bf16>::value ? block_cycles<CP, TAIL>(tile, halo, cin, taps)
                                                          : block_cycles_f32<CP, TAIL>(tile, halo, cin, taps);
    const long long cost = (blocks + sms - 1) / sms * cycles;
    if (best == 0 || cost <= best_cost) best = tile, best_cost = cost;
  }
  return best;
}

// f32 branch sums of all blocks in the caller's scratch.
size_t scratch_floats(int B, int U, int tile, int cp, bool tail) {
  return (size_t)B * ((U + tile - 1) / tile) * (tile + 2 * post_reach(tail)) * cp;
}

// Launch with the tile the caller planned (covomix_vocoder_plan) after
// checking it (tile_fits), x and the MRF weights (the ring's bulk copies)
// 16-byte aligned, and for bf16 the upsample weights too.
template <typename T, int CP, bool TAIL>
int launch(Params<T> p, int B, cudaStream_t stream) {
  const int fit = tile_fits<T, CP, TAIL>(p.tile, p.halo, p.cin, p.taps);
  if (fit != 0) return fit;
  if (reinterpret_cast<uintptr_t>(p.x) % 16 != 0 || reinterpret_cast<uintptr_t>(p.w_mrf) % 16 != 0)
    return kErrAlign;
  if (std::is_same<T, bf16>::value && reinterpret_cast<uintptr_t>(p.w_up) % 16 != 0) return kErrAlign;
  const size_t smem = smem_bytes<T, CP, TAIL>(p.tile, p.halo);
  auto kernel = vocoder_fused_kernel<T, CP, TAIL>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.U + p.tile - 1) / p.tile, B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The plan of one launch into plan[6] = {tile, halo, shared bytes, blocks,
// SMs, scratch floats} and, for a non-null convs, convs[18][4] = per MRF
// conv {rows, units, busiest warp's units, idlest warp's units} (bf16 units:
// 16-row x 32-channel m-tiles; f32: one row x 8 channels, a thread's item).
template <typename T, int CP, bool TAIL>
int plan_launch(const Taps& taps, int B, int U, int cin, int sms, long long* plan, int* convs) {
  const int halo = block_halo(taps, TAIL);
  const int tile = pick_tile<T, CP, TAIL>(halo, cin, taps, B, U, sms);
  if (tile == 0) return kErrSmem;
  plan[0] = tile;
  plan[1] = halo;
  plan[2] = (int)smem_bytes<T, CP, TAIL>(tile, halo);
  plan[3] = (long long)B * ((U + tile - 1) / tile);
  plan[4] = sms;
  plan[5] = (long long)scratch_floats(B, U, tile, CP, TAIL);
  if (convs != nullptr) {
    constexpr bool mma = std::is_same<T, bf16>::value;
    int k[kMrfConvs], margin[kMrfConvs];
    conv_margins(taps, TAIL, k, margin);
    for (int i = 0; i < kMrfConvs; ++i) {
      const int n = tile + 2 * margin[i];
      convs[4 * i] = n;
      convs[4 * i + 1] = mma ? (n + kUnitRows - 1) / kUnitRows * (CP / kUnitChannels) : n * (CP / 8);
      convs[4 * i + 2] = mma ? warp_units<CP>(n, 0) : f32_warp_units<CP>(n, 0);
      convs[4 * i + 3] = mma ? warp_units<CP>(n, kWarps - 1) : f32_warp_units<CP>(n, kWarps - 1);
    }
  }
  return 0;
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
        int tile, float* scratch, cudaStream_t stream) {
  if (c < 1 || c > cp || cin < 1) return kErrChannels;
  Params<T> p;
  p.x = static_cast<const T*>(x);
  p.out = out;
  p.w_up = static_cast<const T*>(w_up);
  p.b_up = b_up;
  p.w_mrf = static_cast<const T*>(w_mrf);
  p.b_mrf = b_mrf;
  p.w_post = static_cast<const T*>(w_post);
  p.scratch = scratch;
  p.b_post = b_post;
  p.t_in = t_in;
  p.cin = cin;
  p.c = c;
  p.U = tail ? 2 * t_in : 4 * t_in;
  const int err = read_taps(taps, &p.taps);
  if (err != 0) return err;
  p.halo = block_halo(p.taps, tail != 0);
  p.tile = tile;
  return tail ? dispatch_cp<T, true>(cp, p, B, stream) : dispatch_cp<T, false>(cp, p, B, stream);
}

template <typename T>
int plan_typed(int tail, int cp, const Taps& taps, int B, int U, int cin, int sms, long long* plan, int* convs) {
  if (cp == 32)
    return tail ? plan_launch<T, 32, true>(taps, B, U, cin, sms, plan, convs)
                : plan_launch<T, 32, false>(taps, B, U, cin, sms, plan, convs);
  if (cp == 64)
    return tail ? plan_launch<T, 64, true>(taps, B, U, cin, sms, plan, convs)
                : plan_launch<T, 64, false>(taps, B, U, cin, sms, plan, convs);
  return kErrChannels;
}

}  // namespace

extern "C" {

// The block plan of a launch on card `device` (its SM count read from the
// card): plan[6] = {tile, halo, shared bytes, blocks, SMs, scratch floats};
// with a non-null convs also convs[18 * 4], per MRF conv {rows, units,
// busiest warp's units, idlest warp's units}. Arguments as for
// covomix_vocoder_fused; returns 0 or an error code.
int covomix_vocoder_plan(int tail, int is_f32, int cp, const int* taps, int B, int t_in, int cin, int device,
                         long long* plan, int* convs) {
  Taps tp;
  const int err = read_taps(taps, &tp);
  if (err != 0) return err;
  if (cin < 1) return kErrChannels;
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const int U = tail ? 2 * t_in : 4 * t_in;
  return is_f32 ? plan_typed<float>(tail, cp, tp, B, U, cin, sms, plan, convs)
                : plan_typed<bf16>(tail, cp, tp, B, U, cin, sms, plan, convs);
}

// tail == 0: fused stage, x [B, t_in, cin] -> out [B, 4*t_in, c] of x's type.
// tail == 1: fused tail,  x [B, t_in, cin] -> out [B, 2*t_in] f32.
// is_f32 picks the type of x, w_up, w_mrf, w_post (bf16 otherwise). cp: the
// channel padding (32 or 64) the weights were packed with. taps: host array
// of 12 ints, the 3 kernel sizes then the 3x3 dilations by branch. tile:
// output rows per block, as covomix_vocoder_plan chose it. scratch: the
// plan's scratch floats (f32) in device memory, the blocks' branch sums.
int covomix_vocoder_fused(int tail, int is_f32, int cp, const void* x, void* out, const void* w_up,
                          const float* b_up, const void* w_mrf, const float* b_mrf, const void* w_post,
                          float b_post, const int* taps, int B, int t_in, int cin, int c, int tile, void* scratch,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (is_f32)
    return run<float>(tail, cp, x, out, w_up, b_up, w_mrf, b_mrf, w_post, b_post, taps, B, t_in, cin, c, tile, sc, s);
  return run<bf16>(tail, cp, x, out, w_up, b_up, w_mrf, b_mrf, w_post, b_post, taps, B, t_in, cin, c, tile, sc, s);
}

const char* covomix_vocoder_error_string(int code) {
  if (code == kErrChannels) return "channels must be in [1, cp] with cp 32 or 64, and cin >= 1";
  if (code == kErrSmem) return "the block's buffers do not fit in shared memory at this tile (or at any)";
  if (code == kErrTaps) return "kernel sizes and dilations must be >= 1";
  if (code == kErrTile)
    return "the tile must be a positive multiple of 4 giving no warp more than 3 units (bf16) or no thread more than "
           "4 rows (f32) a conv";
  if (code == kErrAlign) return "x, the MRF weights (and the bf16 upsample weights) must be 16-byte aligned";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
