// Flash attention (causal / sliding-window / non-causal), GQA-aware.
//
// Both kernels here replace the Pallas kernel
//   src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel):
//   out = softmax(q k^T * scale + mask) v over q [B, H, S, dh] and
//   k, v [B, KV, Sk, dh], query head h reading kv head h / (H / KV).
//   Queries are aligned to the end of the keys (q_offset = Sk - S); the
//   causal mask keeps kpos <= qpos, a window w > 0 also kpos > qpos - w.
//   Scores, the running max, the denominator (floored at 1e-30) and the
//   accumulator are float32; the output is in the input's type. Like the
//   Pallas kernel it takes any head dim the repo's configs use: dh 32, 64,
//   80, 112 and 128. The bf16 kernel also takes q and k of 192 against v
//   of 128 (latent attention: 128 without rope + 64 with it; the output
//   is v's width).
//
// Contract: equal to the plain PyTorch version
// (repro_torch.kernels.flash_attention.flash_attention_plain) up to float32
// summation order, for bfloat16 inputs too: there the softmax weights P
// enter the P V product on the tensor cores as two bfloat16 parts,
// P = hi + lo, so P keeps about 16 significant bits (a relative 2^-16)
// and the output differs from the plain version's by at most one bfloat16
// rounding step. The bf16 kernel takes exp in base 2 (ex2.approx, relative
// error about 2^-22) with scale * log2(e) folded into the scores. Masked
// scores are the finite -1e30, as in the reference: a row with no valid
// key in a tile that still runs gets exp(0) there, and the next tile with
// a valid key zeroes it through alpha = exp(-1e30 - m). With -inf that
// tile would give NaN.
//
// What bounds it on an H100: operations. At the llama3.2-3b prefill shape
// (B 4, H 32, KV 8, S = Sk = 2048, dh 128, causal) the function is 137
// GFLOP against 0.17 GB of inputs and output; the bf16 kernel issues 1.5x
// that on the tensor cores (P V runs on both parts of P), and the diagonal
// tiles add 136/128.
//
// * bfloat16 (the model's path): TMA + wgmma, warp-specialised and
//   persistent. One block of 384 threads per SM walks work items (query
//   tile of 128 rows, head, batch): the query tiles with the most key tiles
//   first, and within one tile the heads that share a kv head next to each
//   other, so that their K/V tiles come from L2. A producer warp (one
//   thread) issues TMA loads through 4-D tensor maps (dh, S, heads, B)
//   built from the wrapper's strides, so [B, S, H, dh] activations pass as
//   views and TMA fills zeros past S, Sk and dh (dh is padded to 64 or
//   128 in shared memory; rows are 64-column boxes with 128-byte swizzle).
//   The item's Q tile is loaded once, behind q_full / q_empty mbarriers;
//   K and V tiles of 128 keys go into a ring of stages, each with its own
//   k_full and v_full barrier and one kv_empty barrier. Two consumer
//   warpgroups each own 64 query rows. Per key tile a warpgroup runs
//   S = Q K^T as wgmma m64n128k16 with both operands in shared memory
//   (K-major), scales and masks S in registers (the causal frontier, the
//   window edge and the Sk edge are evaluated only on the tiles that cross
//   them; tiles the mask removes whole are never visited, as in the
//   reference's block skip, flash_attention.py:44-51), does the online
//   softmax in float32, splits P into hi and lo, and runs
//   O += P_lo V + P_hi V as wgmma m64n{dh}k16 with A from registers (the
//   S accumulator's layout is the A operand's) and V as the transposed
//   (MN-major) B operand. At q/k 192 against v 128 (FlashAttention-3's hdim
//   192 / vdim 128 for DeepSeek-V3's prefill is the precedent) Q and K are
//   three boxes and V two; P V stays m64n128. Two stages then fit, and K and
//   V free their stages apart: K when its Q K^T has waited, V when its P V
//   has, so the producer loads tile j + 1's K while tile j's P V still reads
//   V. Where q/k and v are alike, one barrier frees both. Inside a warpgroup
//   the products of two tiles overlap: S of tile j and P V of tile j - 1 are
//   issued together, and tile j's softmax runs while P V of tile j - 1 does;
//   the stage of tile j - 1 is freed when its P V has waited. setmaxnreg
//   moves the producer's registers to the consumers (O, S and the two parts
//   of P are 192 a thread at dh 128). The epilogue divides by max(l, 1e-30)
//   and stores bf16 pairs from registers, masked past S, while the producer
//   loads the next item. Ping-pong between the warpgroups (named barriers
//   taking turns to issue their products) was slower on the H100 and is not
//   used (PERF.md).
// * float32: 256 threads on the CUDA cores (no tensor-core rate would keep
//   float32 accuracy). Each thread holds a 4 x 4 score tile and 4 rows x
//   dh/16 columns of the accumulator in registers; K^T, V and P^T go
//   through shared memory in float32 (87 KB at dh 128). One block per
//   (query tile of 64 rows, head, batch), the query tiles with the most key
//   tiles first; the tiles the mask removes whole are skipped as above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;  // float32: query rows per block
constexpr int kBK = 64;  // float32: keys per tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // strides in elements; dh is contiguous
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int S, Sk, group, causal, window;
  float scale;
};

// float32: the block's query tile and the range of key tiles it runs.
// Tiles outside [first, last] are wholly masked (the block-level skip of
// flash_attention.py:44-51): past the causal frontier, or wholly before
// the window of every row. Query tiles go in reverse, so the blocks with
// the most key tiles (causal) start first.
struct Walk {
  int q0;     // first query row of the tile
  int q_lo;   // key-aligned position of that row
  int first;  // key tiles first..last run
  int last;

  __device__ Walk(const Params& p) {
    q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
    q_lo = q0 + p.Sk - p.S;
    const int q_hi = min(q0 + kBQ, p.S) - 1 + p.Sk - p.S;  // last real row
    first = 0;
    last = (p.Sk - 1) / kBK;
    if (p.causal) {
      last = min(last, q_hi / kBK);
      const int lo = q_lo - p.window + 1;  // first key any row keeps
      if (p.window > 0 && lo > 0) first = lo / kBK;
    }
  }
};

// whether query position qpos sees key kpos (P: Params or Rows)
template <typename P>
__device__ __forceinline__ bool keep(const P& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) {
    ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && kpos > qpos - p.window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// bfloat16: TMA + wgmma, warp-specialised, persistent

constexpr int kTQ = 128;         // query rows a work item (2 warpgroups x 64)
constexpr int kTK = 128;         // keys a stage
constexpr int kThreadsW = 384;   // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int kMaxStages = 4;
constexpr int kSmemMax = 232448;  // an H100 block's opt-in limit
constexpr int kSmemExtra = 1024 + 256;  // alignment and the barriers

// Q, K and V tiles in shared memory: rows of 64 bf16 (128 bytes, 128B
// swizzle) per box, a width padded to whole boxes: q/k DQK, v DV
template <int DQK, int DV>
struct Tile {
  static constexpr int kQKBoxes = (DQK + 63) / 64;
  static constexpr int kVBoxes = (DV + 63) / 64;
  static constexpr bool kSplit = DQK != DV;  // K and V free their stages apart
  static constexpr int kQBox = kTQ * 128;  // bytes of one 64-column box
  static constexpr int kKBox = kTK * 128;
  static constexpr int kQBytes = kQKBoxes * kQBox;
  static constexpr int kKBytes = kQKBoxes * kKBox;  // K of a stage
  static constexpr int kVBytes = kVBoxes * kKBox;   // V of a stage
  static constexpr int kStageBytes = kKBytes + kVBytes;
  static constexpr int kFit = (kSmemMax - kQBytes - kSmemExtra) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = kQBytes + kStages * kStageBytes + kSmemExtra;
};

struct Dims {
  void* o;
  long long o_sb, o_sh, o_ss;  // output strides in elements
  int B, H, S, Sk, group, causal, window, n_qt;
  float scale_log2;  // scale * log2(e)
};

// Work item w: query tile (the one with the most key tiles first), then
// batch, then head fastest; and the key tiles [first, last] it runs (the
// others are wholly masked: past the causal frontier, or wholly before the
// window of every row).
struct Item {
  int b, h, q0, first, last;

  __device__ Item(const Dims& p, int w) {
    const int hb = p.H * p.B;
    const int qt = p.n_qt - 1 - w / hb;
    const int r = w % hb;
    b = r / p.H;
    h = r - b * p.H;
    q0 = qt * kTQ;
    const int q_lo = q0 + p.Sk - p.S;  // key-aligned position of row q0
    const int q_hi = min(q0 + kTQ, p.S) - 1 + p.Sk - p.S;  // last real row
    first = 0;
    last = (p.Sk - 1) / kTK;
    if (p.causal) {
      last = min(last, q_hi / kTK);
      const int lo = q_lo - p.window + 1;  // first key any row keeps
      if (p.window > 0 && lo > 0) first = lo / kTK;
    }
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as hi + lo, each a bf16 pair: hi = x, y truncated to bf16 (their
// top 16 bits, a mask and a byte permute), lo = bf16 of the rest, which is
// below 2^-7 of x, y; so hi + lo is within 2^-16 of x, y
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t xb = __float_as_uint(x) & 0xFFFF0000u;
  const uint32_t yb = __float_as_uint(y) & 0xFFFF0000u;
  hi = __byte_perm(xb, yb, 0x7632);
  lo = pack_bf16(x - __uint_as_float(xb), y - __uint_as_float(yb));
}

// P = hi + lo in the A-operand order of the k16 steps of P V: register r
// of step kk holds p[8 kk + 2 r], p[8 kk + 2 r + 1] (row r0 for even r,
// r0 + 8 for odd r)
__device__ __forceinline__ void to_p(const float (&p)[kTK / 2],
                                     uint32_t (&phi)[kTK / 4],
                                     uint32_t (&plo)[kTK / 4]) {
#pragma unroll
  for (int i = 0; i < kTK / 4; ++i)
    split_bf16(p[2 * i], p[2 * i + 1], phi[i], plo[i]);
}

// One thread's two rows of a warpgroup's 64: the mask and the online
// softmax of one key tile of scores in the accumulator layout (sc[4j],
// sc[4j+1] at row r0, columns 8j + c0 + {0, 1}; sc[4j+2], sc[4j+3] at row
// r0 + 8). A row's scores live on the 4 lanes of a quad.
struct Rows {
  int Sk, causal, window;  // the mask (read by keep)
  float scale_log2;
  int q_lo;   // key-aligned position of the warpgroup's first row
  int qpos0;  // this thread's first row's
  int c0;     // its first column in each 8

  __device__ Rows(const Dims& p, int q_lo_, int r0, int c0_)
      : Sk(p.Sk), causal(p.causal), window(p.window),
        scale_log2(p.scale_log2), q_lo(q_lo_), qpos0(q_lo_ + r0), c0(c0_) {}

  // whether some (row, key) of the 64 rows against keys k_lo.. is masked:
  // the ragged key edge, a key after the first row, or one before the last
  // row's window
  __device__ bool needs_mask(int k_lo) const {
    if (k_lo + kTK > Sk) return true;
    if (!causal) return false;
    return k_lo + kTK - 1 > q_lo ||
           (window > 0 && k_lo <= q_lo + 63 - window);
  }

  // sc: raw scores -> P = 2^(sc * scale_log2 - m) (masked: 0, or 1 while a
  // row has seen no valid key); m, l updated; alpha rescales what O holds
  __device__ __forceinline__ void softmax(float (&sc)[kTK / 2], int k_lo,
                                          float& m0, float& m1, float& l0,
                                          float& l1, float& alpha0,
                                          float& alpha1) const {
    if (needs_mask(k_lo)) {
#pragma unroll
      for (int j = 0; j < kTK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_lo + 8 * j + c0 + (e & 1);
          sc[4 * j + e] = keep(*this, qpos0 + 8 * (e >> 1), kpos)
                              ? sc[4 * j + e] * scale_log2
                              : kNegInf;
        }
    } else {
#pragma unroll
      for (int i = 0; i < kTK / 2; ++i) sc[i] *= scale_log2;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    alpha0 = ex2(m0 - mn0);
    alpha1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j) {
      sc[4 * j] = ex2(sc[4 * j] - mn0);
      sc[4 * j + 1] = ex2(sc[4 * j + 1] - mn0);
      sc[4 * j + 2] = ex2(sc[4 * j + 2] - mn1);
      sc[4 * j + 3] = ex2(sc[4 * j + 3] - mn1);
      sum0 += sc[4 * j] + sc[4 * j + 1];
      sum1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }
};

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreadsW, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                                 const __grid_constant__ CUtensorMap tmap_k,
                                 const __grid_constant__ CUtensorMap tmap_v,
                                 const Dims p) {
  using T = Tile<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sq = smem;
  auto sk = [&](int s) { return smem + T::kQBytes + s * T::kStageBytes; };
  auto sv = [&](int s) { return sk(s) + T::kKBytes; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + T::kQBytes + T::kStages * T::kStageBytes);
  uint64_t* q_empty = q_full + 1;
  uint64_t* k_full = q_full + 2;
  uint64_t* v_full = k_full + T::kStages;
  // a stage's K and V read (K alone where they free apart: T::kSplit)
  uint64_t* kv_empty = v_full + T::kStages;
  uint64_t* v_empty = kv_empty + T::kStages;  // T::kSplit: its V read

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);  // the producer's arrival + the TMA bytes
    mbar_init(q_empty, kConsumerWarps);  // one arrival per consumer warp
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], kConsumerWarps);
      if constexpr (T::kSplit) mbar_init(&v_empty[s], kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int n_work = p.n_qt * p.H * p.B;

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    regs_dealloc<24>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
        const Item it(p, w);
        const int kvh = it.h / p.group;
        mbar_wait(q_empty, q_phase ^ 1);  // both warpgroups are past Q K^T
        q_phase ^= 1;
        mbar_arrive_expect_tx(q_full, T::kQBytes);
#pragma unroll
        for (int c = 0; c < T::kQKBoxes; ++c)
          tma_load_4d(sq + c * T::kQBox, &tmap_q, q_full, 64 * c, it.q0,
                      it.h, it.b);
        for (int kj = it.first; kj <= it.last; ++kj) {
          mbar_wait(&kv_empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&k_full[s], T::kKBytes);
#pragma unroll
          for (int c = 0; c < T::kQKBoxes; ++c)
            tma_load_4d(sk(s) + c * T::kKBox, &tmap_k, &k_full[s], 64 * c,
                        kj * kTK, kvh, it.b);
          if constexpr (T::kSplit) mbar_wait(&v_empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&v_full[s], T::kVBytes);
#pragma unroll
          for (int c = 0; c < T::kVBoxes; ++c)
            tma_load_4d(sv(s) + c * T::kKBox, &tmap_v, &v_full[s], 64 * c,
                        kj * kTK, kvh, it.b);
          if (++s == T::kStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 1 and 2: rows 64 (wg - 1).. of each query tile
    regs_alloc<240>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
    const int c0 = 2 * (lane % 4);        // its columns in each 8: c0, c0 + 1
    const uint8_t* qa = sq + wg * 64 * 128;  // the warpgroup's 64 rows of Q
    // S = Q K^T of the stage's K tile, issued (not waited for)
    auto issue_qk = [&](float (&sc)[kTK / 2], int st) {
      const uint8_t* q = qa;
      if constexpr (T::kSplit) {
        // twelve Q descriptors hoisted out of the key loop would hold
        // registers the consumer lacks at q/k 192 (ptxas spilled): an
        // opaque base makes each one formed next to its product
        asm volatile("" : "+l"(q));
      }
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        wgmma_bf16<0, 0>(
            sc, desc_sw128(q + (kk / 4) * T::kQBox + 32 * (kk % 4), 16, 1024),
            desc_sw128(sk(st) + (kk / 4) * T::kKBox + 32 * (kk % 4), 16, 1024),
            kk > 0);
      wgmma_commit();
    };
    // O += P_lo V + P_hi V of the stage's V tile [keys, DV], MN-major
    auto issue_pv = [&](float (&o)[DV / 2], uint32_t (&phi)[kTK / 4],
                        uint32_t (&plo)[kTK / 4], int st) {
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk) {
        const uint64_t dv = desc_sw128(sv(st) + 2048 * kk, T::kKBox, 1024);
        wgmma_bf16_rs<1>(o, &plo[4 * kk], dv, 1);
        wgmma_bf16_rs<1>(o, &phi[4 * kk], dv, 1);
      }
      wgmma_commit();
    };
    int s = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
      const Item it(p, w);
      const int row_lo = it.q0 + 64 * wg;
      const Rows rows(p, row_lo + p.Sk - p.S, r0, c0);
      float o[DV / 2];
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
      // running max in log2 units and this thread's part of the row sums
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
      float alpha0, alpha1;
      uint32_t phi[kTK / 4], plo[kTK / 4];  // P of the previous key tile
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;

      // the first key tile: S, softmax, P
      {
        float sc[kTK / 2];
        mbar_wait(&k_full[s], phase);
        wgmma_fence();
        issue_qk(sc, s);
        wgmma_wait<0>();
        fence_regs(sc);
        if (it.first == it.last && lane == 0) mbar_arrive(q_empty);
        if constexpr (T::kSplit)
          if (lane == 0) mbar_arrive(&kv_empty[s]);  // its K is read
        rows.softmax(sc, it.first * kTK, m0, m1, l0, l1, alpha0, alpha1);
        to_p(sc, phi, plo);
      }
      int s_prev = s;  // the stage of P's key tile
      uint32_t phase_prev = phase;
      if (++s == T::kStages) {
        s = 0;
        phase ^= 1;
      }
      // each next tile: S of this tile and P V of the previous one in
      // flight together; this tile's softmax runs while P V does
      for (int kj = it.first + 1; kj <= it.last; ++kj) {
        float sc[kTK / 2];
        mbar_wait(&k_full[s], phase);
        mbar_wait(&v_full[s_prev], phase_prev);
        wgmma_fence();
        issue_qk(sc, s);
        issue_pv(o, phi, plo, s_prev);
        wgmma_wait<1>();  // S has arrived
        fence_regs(sc);
        if (kj == it.last && lane == 0) mbar_arrive(q_empty);
        if constexpr (T::kSplit)
          if (lane == 0) mbar_arrive(&kv_empty[s]);  // its K is read
        rows.softmax(sc, kj * kTK, m0, m1, l0, l1, alpha0, alpha1);
        wgmma_wait<0>();  // P V of the previous tile has too
        fence_regs(o);
        fence_regs(phi);
        fence_regs(plo);
        if (lane == 0)  // its stage is read (its V, where they free apart)
          mbar_arrive(T::kSplit ? &v_empty[s_prev] : &kv_empty[s_prev]);
#pragma unroll
        for (int j = 0; j < DV / 8; ++j) {
          o[4 * j] *= alpha0;
          o[4 * j + 1] *= alpha0;
          o[4 * j + 2] *= alpha1;
          o[4 * j + 3] *= alpha1;
        }
        to_p(sc, phi, plo);
        s_prev = s;
        phase_prev = phase;
        if (++s == T::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      // P V of the last tile
      mbar_wait(&v_full[s_prev], phase_prev);
      wgmma_fence();
      issue_pv(o, phi, plo, s_prev);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(phi);
      fence_regs(plo);
      if (lane == 0)
        mbar_arrive(T::kSplit ? &v_empty[s_prev] : &kv_empty[s_prev]);

      // O / max(l, 1e-30) in bf16 pairs, rows past S not stored
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float d0 = fmaxf(l0, 1e-30f);
      const float d1 = fmaxf(l1, 1e-30f);
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) +
                           it.b * p.o_sb + it.h * p.o_sh;
      const int row0 = row_lo + r0;
      const int row1 = row0 + 8;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = 8 * j + c0;
        if (row0 < p.S)
          *reinterpret_cast<uint32_t*>(out + (long long)row0 * p.o_ss + col) =
              pack_bf16(o[4 * j] / d0, o[4 * j + 1] / d0);
        if (row1 < p.S)
          *reinterpret_cast<uint32_t*>(out + (long long)row1 * p.o_ss + col) =
              pack_bf16(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kThreads = 256;    // 16 x 16: ty owns rows ty*4..ty*4+3
constexpr int kPad = 4;          // keeps float4 rows aligned, spreads banks
constexpr int kQS = kBQ + kPad;  // row stride of Q^T and P^T
constexpr int kKS = kBK + kPad;  // row stride of K^T

template <int DH>
__host__ __device__ constexpr int f32_kv_floats() {
  return DH * kKS > kBK * DH ? DH * kKS : kBK * DH;
}

template <int DH>
__host__ __device__ constexpr int f32_smem_bytes() {
  return (DH * kQS + f32_kv_floats<DH>() + kBK * kQS) * 4;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attention_f32_kernel(const Params p) {
  constexpr int NC = DH / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* sQT = reinterpret_cast<float*>(smem4);  // [DH][kQS]
  float* sKV = sQT + DH * kQS;                   // K^T [DH][kKS], then V [kBK][DH]
  float* sPT = sKV + f32_kv_floats<DH>();        // [kBK][kQS]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const Walk w(p);
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH;
    const int d = e - r * DH;
    sQT[d * kQS + r] = w.q0 + r < p.S ? q[(long long)(w.q0 + r) * p.q_ss + d] : 0.0f;
  }

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int kj = w.first; kj <= w.last; ++kj) {
    const int k_lo = kj * kBK;
    __syncthreads();  // Q^T is staged; the last tile's P^T and V are read
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH;
      const int d = e - c * DH;
      sKV[d * kKS + c] = k_lo + c < p.Sk ? k[(long long)(k_lo + c) * p.k_ss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQT[d * kQS + ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&sKV[d * kKS + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // scale, mask, online softmax; a row's 64 columns live on the 16
    // lanes tx = 0..15 of one half-warp
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = w.q_lo + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = keep(p, qpos, k_lo + tx * 4 + j) ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPT[(tx * 4 + j) * kQS + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // K^T is read; P^T is visible

    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH;
      sKV[e] = k_lo + c < p.Sk ? v[(long long)(k_lo + c) * p.v_ss + (e - c * DH)] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(&sPT[c * kQS + ty * 4]);
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float vv = sKV[c * DH + tx + 16 * jj];
        acc[0][jj] = fmaf(pa.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(pa.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(pa.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(pa.w, vv, acc[3][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = w.q0 + ty * 4 + i;
    if (r >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      o[(long long)r * p.o_ss + tx + 16 * jj] = acc[i][jj] / denom;
  }
}

// ---------------------------------------------------------------------------
// launch

constexpr int kErrNoEncoder = -1;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;     // it refused a tensor map

// A 4-D map (dh, rows, heads, B) over a bf16 tensor with a contiguous dh and
// the given strides (elements), read in boxes of box_rows x 64 of dh with
// 128-byte swizzle; what lies outside the tensor reads as zeros.
int map_4d(CUtensorMap* m, const void* base, int dh, int rows, int heads,
           int batch, long long s_row, long long s_head, long long s_batch,
           int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int DQK, int DV>
int launch_wgmma(const Params& a, int B, int H, int KV, cudaStream_t st) {
  using T = Tile<DQK, DV>;
  CUtensorMap tq, tk, tv;
  int err = map_4d(&tq, a.q, DQK, a.S, H, B, a.q_ss, a.q_sh, a.q_sb, kTQ);
  if (err == 0)
    err = map_4d(&tk, a.k, DQK, a.Sk, KV, B, a.k_ss, a.k_sh, a.k_sb, kTK);
  if (err == 0)
    err = map_4d(&tv, a.v, DV, a.Sk, KV, B, a.v_ss, a.v_sh, a.v_sb, kTK);
  if (err != 0) return err;
  Dims p;
  p.o = a.o;
  p.o_sb = a.o_sb;
  p.o_sh = a.o_sh;
  p.o_ss = a.o_ss;
  p.B = B;
  p.H = H;
  p.S = a.S;
  p.Sk = a.Sk;
  p.group = a.group;
  p.causal = a.causal;
  p.window = a.window;
  p.n_qt = (a.S + kTQ - 1) / kTQ;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  int dev = 0, sms = 0;
  if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const long long n_work = (long long)p.n_qt * H * B;
  const int grid = n_work < sms ? (int)n_work : sms;
  flash_attention_wgmma_kernel<DQK, DV>
      <<<grid, kThreadsW, T::kSmemBytes, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

int launch_f32(void (*kernel)(const Params), int bytes, const Params& p, int B,
               int H, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted in
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((p.S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const Params& p, bool bf16, int B, int H, int KV,
              cudaStream_t stream) {
  if (bf16) return launch_wgmma<DH, DH>(p, B, H, KV, stream);
  return launch_f32(flash_attention_f32_kernel<DH>, f32_smem_bytes<DH>(), p,
                    B, H, stream);
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns 0 or an error code for
// flash_attention_error_string. dtype: 0 float32, 1 bfloat16; q/k width
// dh and v width dv: dh = dv in {32, 64, 80, 112, 128}, or in bfloat16
// dh 192, dv 128 (the output is [B, H, S, dv]); S >= 1, Sk >= 1, and
// Sk >= S when causal.
// Strides are in elements, the last dim contiguous; for bfloat16 the
// pointers are 16-byte aligned and the strides multiples of 8 (TMA).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KV, int S,
                           int Sk, int dh, int dv, long long q_sb,
                           long long q_sh, long long q_ss, long long k_sb,
                           long long k_sh, long long k_ss, long long v_sb,
                           long long v_sh, long long v_ss, long long o_sb,
                           long long o_sh, long long o_ss, int causal,
                           int window, float scale, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.S = S;
  p.Sk = Sk;
  p.group = H / KV;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const bool bf16 = dtype == 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh != dv) {
    if (dh == 192 && dv == 128 && bf16)
      return launch_wgmma<192, 128>(p, B, H, KV, st);
    return (int)cudaErrorInvalidValue;
  }
  switch (dh) {
    case 32: return launch_dh<32>(p, bf16, B, H, KV, st);
    case 64: return launch_dh<64>(p, bf16, B, H, KV, st);
    case 80: return launch_dh<80>(p, bf16, B, H, KV, st);
    case 112: return launch_dh<112>(p, bf16, B, H, KV, st);
    case 128: return launch_dh<128>(p, bf16, B, H, KV, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  if (err == kErrNoEncoder)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
