// RWKV6 WKV scan (data-dependent-decay linear attention), chunked and
// parallel over (stream, group of chunks), with the products on the tensor
// cores.
//
// Replaces the Pallas kernel
//   src/repro/kernels/rwkv_scan.py::rwkv_scan (_rwkv_kernel):
//   per (batch, head) stream, from a zero state S (dh x dh, key-major),
//     out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T
//   over r, k, v, w [B, S, H, dh] and u [H, dh]; out is float32
//   [B, S, H, dh] and, when asked, the final state float32 [B, H, dh, dh]
//   (row i = key channel, column j = value channel), as
//   src/repro/models/ssm.py::rwkv_recurrence returns it. r, k and v are
//   float32 or bfloat16 (read as they are: bf16 -> f32 is exact); w and u
//   are float32.
//
// Contract: within float32 rounding of the plain PyTorch version
// (repro_torch.kernels.rwkv_scan.rwkv_scan_plain, the serial recurrence);
// rwkv_scan_chunked_plain there is this kernel's decomposition in plain
// PyTorch. Any S >= 1 and any w in (0, 1]: no factor is ever divided by a
// cumulative decay (the TPU kernel divides k by it, which overflows once a
// chunk's decay passes float32's range).
//
// What bounds it on an H100: bytes, at the model's prefill shape (B 4,
// S 2048, H 32, dh 64): r, k, v, w read once, out and the final state
// written once (0.338 GB in float32, 0.237 GB with bf16 r/k/v), against
// about 6 dh^2 operations per token and stream (6.4 GFLOP).
//
// Design. The tokens of a stream split into G groups of whole chunks of
// kT = 32 tokens; the work is parallel over (stream, group), in up to
// three launches:
//   1. rwkv_scan_group_state_kernel, per (stream, group) but the last:
//      the group's own state from zero, dS_g = (k_j * 2^E_j)^T V over its
//      tokens, E_j the exclusive suffix sum of log2 w to the group's end
//      (summed from the end, so no two large sums are subtracted), and its
//      decay D_g = 2^(sum of log2 w); the product on the tensor cores,
//      accumulated in registers over the group's chunks.
//   2. rwkv_scan_carry_kernel, per state element: S_in[g + 1] =
//      diag(D_g) S_in[g] + dS_g, a short serial pass over the groups,
//      written over dS.
//   3. rwkv_scan_out_kernel, per (stream, group): from S_in[g], the
//      group's chunks in order, the state carried across them in shared
//      memory; the last group writes the final state.
// G is chosen to fill the card (plan()): about SMs / (B H) groups a
// stream, and one (launch 3 alone: every chunk of a stream in order) when
// the B H streams fill the SMs, as at the rwkv6-1.6b prefill (B 4, H 32:
// 128 streams on 132 SMs). Groups cost work: launch 1 computes each
// group's state a second time, about a third more tensor-core work, and
// the chunk walk of one block is bound by its issue rate, so more groups
// than SMs need measured slower (PERF.md).
//
// A chunk of rwkv_scan_out_kernel, with L the inclusive cumulative log2
// decay from the chunk's start (log2 w floored at -150, below which 2^x is
// 0 in float32):
//   cross: out += (r_t * 2^L_{t-1}) . S_in
//   intra: out += A V, A[t, j] = sum_c r_tc k_jc 2^(L_{t-1,c} - L_{j,c})
//          for j < t, and A[t, t] = sum_c r_tc u_c k_tc (the bonus)
//   state: S_out = diag(2^L_last) S_in + (k_j * 2^(L_last - L_j))^T V
//          (left out after a group's last chunk unless it is the final
//          state)
// Every exponent is <= 0, so every factor is <= 1. A is built per
// 16-token sub-chunk: its diagonal blocks pairwise on the CUDA cores, the
// decay prod_{j<i<t} w_i carried as a running product (no exp; eight lanes
// per query t split the channels and share each key's loads), its blocks
// below the diagonal as products with the decay anchored at the query
// sub-chunk's start p (token 16 a - 1): (r_t * 2^(L_{t-1} - L_p)) .
// (k_j * 2^(L_p - L_j)). The cross, intra, state and anchored score
// products run on the tensor cores (mma.sync m16n8k8 tf32, operands read
// from shared memory straight into registers), each as three products of
// a hi + lo split of both operands (lo*hi + hi*lo + hi*hi, "3xTF32", in
// three accumulators): plain TF32 keeps ~3 digits, the split ~6, which
// K4_TOL (1e-4 + 1e-4 |want|) needs. A block prefetches its next chunk's
// inputs into registers while it computes the current one; the five
// phases of a chunk are separated by block barriers. The inputs are read
// through their strides ([B, S, H, dh] with dh contiguous); tokens past S
// read as r = k = v = 0, w = 1 and are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;     // tokens per chunk
constexpr int kSub = 16;   // tokens per sub-chunk (an mma tile)
constexpr int kNSub = kT / kSub;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2Floor = -150.f;
// rows of the anchored keys: sub-chunk a >= 1 keeps its 16 a earlier keys
constexpr int kKpRows = kSub * kNSub * (kNSub - 1) / 2;

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;   // [H, dh], contiguous
  float* out;       // [B, S, H, dh], contiguous
  float* state;     // [B, H, dh, dh], contiguous, or null
  float* carry;     // [B H, G - 1, dh, dh]: dS_g, then S_in[g + 1]
  float* carry_decay;  // [B H, G - 1, dh]: D_g
  long long r_sb, r_ss, r_sh;  // strides in elements; dh is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  int S, H;
  int G, group_t;  // G groups a stream, of group_t tokens (whole chunks)
};

// 2^x on the MUFU (ex2.approx.ftz: a few ulp, results below 2^-126
// flushed to 0); exp2f's range handling measured slower at the same K4
// error (PERF.md)
__device__ __forceinline__ float pow2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a 16 x 16 float32 tile of mma.m16n8k8 accumulators: two n8 halves,
// c[n] = (g, 8n + 2t), (g, 8n + 2t + 1), (g + 8, 8n + 2t), (g + 8, 8n + 2t + 1)
// for lane 4 g + t
struct Tile {
  float c[2][4];
};

__device__ __forceinline__ void zero(Tile& x) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) x.c[n][i] = 0.f;
}

// hi += lo, element by element
__device__ __forceinline__ void fold(Tile& hi, const Tile& lo) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) hi.c[n][i] += lo.c[n][i];
}

// the tile to or from row-major shared memory p (row stride ld)
__device__ __forceinline__ void store_tile(const Tile& x, float* p, int ld,
                                           int g, int t) {
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    *reinterpret_cast<float2*>(p + g * ld + 8 * n + 2 * t) =
        make_float2(x.c[n][0], x.c[n][1]);
    *reinterpret_cast<float2*>(p + (g + 8) * ld + 8 * n + 2 * t) =
        make_float2(x.c[n][2], x.c[n][3]);
  }
}

// x rounded to tf32, to nearest with ties away (its low 13 bits zero)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element (row, col) of a matrix in shared memory: row-major p[row ld +
// col], or column-major p[col ld + row]
template <bool kCol>
__device__ __forceinline__ float at(const float* p, int ld, int row, int col) {
  return kCol ? p[col * ld + row] : p[row * ld + col];
}

// one k-step of 8 of a 16 x 16 product: a is 16 x 8, b is 8 x 16, and with
// each split into tf32 hi + lo (x - hi is exact in float32):
// hi += a_hi b_hi, lo += a_lo b_hi, lo2 += a_hi b_lo (three accumulators,
// so the chains of a tile's k-steps overlap). kExactB: b holds tf32 values
// (bf16 inputs), b_lo = 0 and its product is left out.
template <bool kColA, bool kColB, bool kExactB = false>
__device__ __forceinline__ void mma3(Tile& hi, Tile& lo, Tile& lo2,
                                     const float* a, int lda, const float* b,
                                     int ldb, int g, int t) {
  const float av[4] = {at<kColA>(a, lda, g, t), at<kColA>(a, lda, g + 8, t),
                       at<kColA>(a, lda, g, t + 4),
                       at<kColA>(a, lda, g + 8, t + 4)};
  uint32_t ah[4], al[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ah[i] = to_tf32(av[i]);
    al[i] = to_tf32(av[i] - __uint_as_float(ah[i]));
  }
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const float b0 = at<kColB>(b, ldb, t, 8 * n + g);
    const float b1 = at<kColB>(b, ldb, t + 4, 8 * n + g);
    const uint32_t bh0 = to_tf32(b0), bh1 = to_tf32(b1);
    const uint32_t bl0 = to_tf32(b0 - __uint_as_float(bh0));
    const uint32_t bl1 = to_tf32(b1 - __uint_as_float(bh1));
    mma_tf32(lo.c[n], al, bh0, bh1);
    mma_tf32(hi.c[n], ah, bh0, bh1);
    if (!kExactB) mma_tf32(lo2.c[n], ah, bl0, bl1);
  }
}

// shared memory of rwkv_scan_out_kernel, in floats; every buffer starts
// 32-byte aligned (rows are multiples of 16, so rows * ld is a multiple of
// 8)
template <int DH>
struct Smem {
  static constexpr int LD = DH + 4;   // row stride of [*, dh] buffers
  static constexpr int LT = kT + 4;   // row stride of A
  static constexpr int R = 0;                   // r            [kT][LD]
  static constexpr int K = R + kT * LD;         // k            [kT][LD]
  static constexpr int V = K + kT * LD;         // v            [kT][LD]
  static constexpr int L = V + kT * LD;         // log2 w, then L [kT][LD]
  static constexpr int W = L + kT * LD;         // w            [kT][LD]
  static constexpr int Q = W + kT * LD;         // r * 2^L_{t-1} [kT][LD]
  static constexpr int KD = Q + kT * LD;        // k * 2^(L_last - L_j)
  // anchored r of the sub-chunks past the first [kT - kSub][LD]
  static constexpr int QP = KD + kT * LD;
  static constexpr int KP = QP + (kT - kSub) * LD;  // anchored k [kKpRows][LD]
  static constexpr int A = KP + (kKpRows > 0 ? kKpRows : kSub) * LD;
  static constexpr int ST = A + kT * LT;        // S            [dh][LD]
  static constexpr int DS = ST + DH * LD;       // K^T V        [dh][LD]
  static constexpr int U = DS + DH * LD;        // u            [dh]
  static constexpr int DECAY = U + DH;          // 2^L_last     [dh]
  static constexpr int FLOATS = DECAY + DH;
};

// Row t = j0 + tl of A's diagonal block at j0 (a sub-chunk), for a thread
// (t, h) of the warp whose four t are below j0 + NJ: over its channels
// c = 16 i + 2 h and 2 h + 1, A[t, j] for j = t - 1 down to j0 with the
// decay prod_{j < i < t} w_i carried as a running product (no exp), and
// the bonus sum_c r_tc u_c k_tc at j = t; the eight h-lanes of a t then
// add up. The lanes of a warp share j, so k_j and w_j are broadcast reads.
template <int DH, int NJ>
__device__ __forceinline__ void diag_rows(float* sA, const float* sr,
                                          const float* sk, const float* sW,
                                          const float* su, int j0, int tl,
                                          int h8) {
  constexpr int LD = Smem<DH>::LD, LT = Smem<DH>::LT;
  const int t = j0 + tl;
  float acc[NJ - 1], bonus = 0.f;
#pragma unroll
  for (int jl = 0; jl < NJ - 1; ++jl) acc[jl] = 0.f;
#pragma unroll
  for (int c = 2 * h8; c < DH; c += 16) {
    const float2 rt = *reinterpret_cast<const float2*>(sr + t * LD + c);
    const float2 kt = *reinterpret_cast<const float2*>(sk + t * LD + c);
    const float2 ut = *reinterpret_cast<const float2*>(su + c);
    bonus += rt.x * ut.x * kt.x + rt.y * ut.y * kt.y;
    float2 f = make_float2(1.f, 1.f);  // prod_{jl < i < tl} w_i
#pragma unroll
    for (int jl = NJ - 2; jl >= 0; --jl) {
      const int o = (j0 + jl) * LD + c;
      const float2 kj = *reinterpret_cast<const float2*>(sk + o);
      const float2 wn = *reinterpret_cast<const float2*>(sW + o + LD);
      if (jl + 1 < tl) {
        f.x *= wn.x;
        f.y *= wn.y;
      }
      const float x = rt.x * kj.x * f.x + rt.y * kj.y * f.y;
      acc[jl] += jl < tl ? x : 0.f;
    }
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
#pragma unroll
    for (int jl = 0; jl < NJ - 1; ++jl)
      acc[jl] += __shfl_xor_sync(0xffffffffu, acc[jl], off);
  }
  if (h8 == 0) sA[t * LT + t] = bonus;
#pragma unroll
  for (int jl = 0; jl < NJ - 1; ++jl)  // lane h stores j = h and h + 8
    if ((jl & 7) == h8 && jl < tl) sA[t * LT + j0 + jl] = acc[jl];
}

// first row of sub-chunk a's anchored keys in KP
__device__ __forceinline__ int kp_row0(int a) {
  return kSub * (a - 1) * a / 2;
}

// The 16 x 16 tiles of a dh x dh product, dealt to the warps in turn:
// warp w holds tiles w, w + kWarps, ...
template <int DH>
struct StateTiles {
  static constexpr int n = (DH / 16) * (DH / 16);
  static constexpr int per_warp = (n + kWarps - 1) / kWarps;
};

// Launch 1, one block per (stream, group) but the last: the group's own
// state dS_g = sum_j (k_j * 2^E_j)^T v_j from zero, E_j = sum_{j<i} log2
// w_i to the group's end, and its decay D_g = 2^(sum_i log2 w_i). The
// chunks are taken from the group's end, the suffix sums carried across
// them. Each chunk's product is summed on the tensor cores (K = 32, as in
// the chunk walk) and added to the group's sum in registers on the CUDA
// cores: the tensor cores' float32 accumulation drifts by ~2^-23 a k-step,
// ~8e-6 over a 512-token group, which failed K4_TOL (PERF.md).
template <int DH, class TIn>
__global__ void __launch_bounds__(kThreads)
    rwkv_scan_group_state_kernel(const Params p) {
  constexpr int LD = DH + 4;
  constexpr int kPer = kT * DH / kThreads;  // inputs per thread per chunk
  constexpr bool kExactV = sizeof(TIn) == 2;
  using ST = StateTiles<DH>;
  __shared__ __align__(16) float sk[kT * LD];
  __shared__ __align__(16) float sv[kT * LD];
  __shared__ __align__(16) float sL[kT * LD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4, tq = tid % 4;
  const int grp = blockIdx.x % (p.G - 1);
  const int bh = blockIdx.x / (p.G - 1);
  const int h = bh % p.H, b = bh / p.H;
  const TIn* k = static_cast<const TIn*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TIn* v = static_cast<const TIn*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;

  Tile sum[ST::per_warp];
#pragma unroll
  for (int i = 0; i < ST::per_warp; ++i) zero(sum[i]);
  float suffix = 0.f;  // thread c < DH: sum of log2 w past this chunk
  for (int ci = p.group_t / kT - 1; ci >= 0; --ci) {
    const long long t0 = (long long)grp * p.group_t + ci * kT;  // all < S
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int t = e / DH, c = e % DH, o = t * LD + c;
      sk[o] = to_f32(k[(t0 + t) * p.k_ss + c]);
      sv[o] = to_f32(v[(t0 + t) * p.v_ss + c]);
      sL[o] = fmaxf(log2f(w[(t0 + t) * p.w_ss + c]), kLog2Floor);
    }
    __syncthreads();
    if (tid < DH) {
#pragma unroll 8
      for (int t = kT - 1; t >= 0; --t) {
        sk[t * LD + tid] *= pow2(suffix);
        suffix += sL[t * LD + tid];
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ST::per_warp; ++i) {
      const int tile = warp + i * kWarps;
      if (tile < ST::n) {
        const int ci16 = tile / (DH / 16), vi = tile % (DH / 16);
        Tile hi, lo, lo2;
        zero(hi);
        zero(lo);
        zero(lo2);
#pragma unroll
        for (int kj = 0; kj < kT; kj += 8)
          mma3<true, false, kExactV>(hi, lo, lo2, sk + kj * LD + ci16 * 16,
                                     LD, sv + kj * LD + vi * 16, LD, g, tq);
        fold(hi, lo);
        fold(hi, lo2);
        fold(sum[i], hi);
      }
    }
    __syncthreads();  // the next chunk overwrites k and v
  }
  const long long slot = (long long)bh * (p.G - 1) + grp;
  float* dS = p.carry + slot * DH * DH;
#pragma unroll
  for (int i = 0; i < ST::per_warp; ++i) {
    const int tile = warp + i * kWarps;
    if (tile < ST::n) {
      const int ci16 = tile / (DH / 16), vi = tile % (DH / 16);
      float* d = dS + ci16 * 16 * DH + vi * 16;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        *reinterpret_cast<float2*>(d + g * DH + 8 * n + 2 * tq) =
            make_float2(sum[i].c[n][0], sum[i].c[n][1]);
        *reinterpret_cast<float2*>(d + (g + 8) * DH + 8 * n + 2 * tq) =
            make_float2(sum[i].c[n][2], sum[i].c[n][3]);
      }
    }
  }
  if (tid < DH) p.carry_decay[slot * DH + tid] = pow2(suffix);
}

// Launch 2, one thread per state element (stream, i, j): S_in[g + 1] =
// D_g[i] S_in[g] + dS_g[i, j] from S_in[0] = 0, written over dS_g.
__global__ void rwkv_scan_carry_kernel(const Params p, int n_streams,
                                       int dh) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per = (long long)dh * dh;
  if (e >= n_streams * per) return;
  const long long bh = e / per, ij = e % per, i = ij / dh;
  float s = 0.f;
  for (int grp = 0; grp < p.G - 1; ++grp) {
    const long long slot = bh * (p.G - 1) + grp;
    float* x = p.carry + slot * per + ij;
    s = p.carry_decay[slot * dh + i] * s + *x;
    *x = s;
  }
}

// Launch 3, one block per (stream, group): the group's outputs from
// S_in[g], and the final state from the last group.
template <int DH, class TIn>
__global__ void __launch_bounds__(kThreads, 1)
    rwkv_scan_out_kernel(const Params p) {
  using SM = Smem<DH>;
  constexpr int LD = SM::LD, LT = SM::LT;
  constexpr int kPer = kT * DH / kThreads;  // inputs per thread per chunk
  static_assert(kT * DH % kThreads == 0, "chunk not a multiple of threads");
  constexpr int nO = (kT / 16) * (DH / 16);  // out tiles, one a warp
  static_assert(nO <= kWarps, "an out tile per warp");
  // bf16 v is exact in tf32: its products need no lo part
  constexpr bool kExactV = sizeof(TIn) == 2;
  extern __shared__ __align__(128) float smem[];
  float* sr = smem + SM::R;
  float* sk = smem + SM::K;
  float* sv = smem + SM::V;
  float* sL = smem + SM::L;
  float* sW = smem + SM::W;
  float* sQ = smem + SM::Q;
  float* sKd = smem + SM::KD;
  float* sQp = smem + SM::QP;
  float* sKp = smem + SM::KP;
  float* sA = smem + SM::A;
  float* sS = smem + SM::ST;
  float* sdS = smem + SM::DS;
  float* su = smem + SM::U;
  float* sdecay = smem + SM::DECAY;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4, tq = tid % 4;  // a lane's mma coordinates
  const int grp = blockIdx.x % p.G;
  const int bh = blockIdx.x / p.G;
  const int h = bh % p.H, b = bh / p.H;
  const TIn* r = static_cast<const TIn*>(p.r) + b * p.r_sb + h * p.r_sh;
  const TIn* k = static_cast<const TIn*>(p.k) + b * p.k_sb + h * p.k_sh;
  const TIn* v = static_cast<const TIn*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* w = p.w + b * p.w_sb + h * p.w_sh;
  const long long o_ss = (long long)p.H * DH;
  float* out = p.out + (long long)b * p.S * o_ss + h * DH;
  const int t_begin = grp * p.group_t;
  const int t_end = min(p.S, t_begin + p.group_t);
  const bool last = grp == p.G - 1;

  const float* s_in =
      grp > 0 ? p.carry + ((long long)bh * (p.G - 1) + grp - 1) * DH * DH
              : nullptr;
  for (int i = tid; i < DH * DH; i += kThreads)
    sS[(i / DH) * LD + i % DH] = s_in != nullptr ? s_in[i] : 0.f;
  for (int i = tid; i < DH; i += kThreads) su[i] = p.u[h * DH + i];
  // A above its diagonal is zero in every chunk
  for (int i = tid; i < kT * kT; i += kThreads) {
    const int t = i / kT, j = i % kT;
    if (j > t) sA[t * LT + j] = 0.f;
  }


  // element e = tid + i * kThreads of a chunk is token e / DH, channel
  // e % DH; the next chunk's are loaded into registers ahead of use
  TIn pr[kPer], pk[kPer], pv[kPer];
  float pw[kPer];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int t = t0 + e / DH, c = e % DH;
      const bool in = t < p.S;
      pr[i] = in ? r[t * p.r_ss + c] : TIn(0.f);
      pk[i] = in ? k[t * p.k_ss + c] : TIn(0.f);
      pv[i] = in ? v[t * p.v_ss + c] : TIn(0.f);
      pw[i] = in ? w[t * p.w_ss + c] : 1.f;
    }
  };
  load(t_begin);
  __syncthreads();

  for (int t0 = t_begin; t0 < t_end; t0 += kT) {
    // the state after this chunk is needed by the group's next chunk, or
    // is the final state
    const bool keep_state = t0 + kT < t_end || (last && p.state != nullptr);
    // phase 0: the chunk into shared memory; the next one's loads issued
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      const int o = (e / DH) * LD + e % DH;
      sr[o] = to_f32(pr[i]);
      sk[o] = to_f32(pk[i]);
      sv[o] = to_f32(pv[i]);
      sW[o] = pw[i];
      sL[o] = fmaxf(log2f(pw[i]), kLog2Floor);
    }
    if (t0 + kT < t_end) load(t0 + kT);
    __syncthreads();

    // phase 1: L = inclusive cumulative sum of log2 w over the chunk
    if (tid < DH) {
      float x[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) x[t] = sL[t * LD + tid];
#pragma unroll
      for (int t = 1; t < kT; ++t) x[t] += x[t - 1];
#pragma unroll
      for (int t = 0; t < kT; ++t) sL[t * LD + tid] = x[t];
    }
    __syncthreads();

    // phase 2: the decayed operands, and A's diagonal blocks
    for (int c = tid; c < DH; c += kThreads)
      sdecay[c] = pow2(sL[(kT - 1) * LD + c]);
    for (int e = tid; e < kT * DH; e += kThreads) {
      const int t = e / DH, c = e % DH, o = t * LD + c;
      const float lprev = t > 0 ? sL[o - LD] : 0.f;
      sQ[o] = sr[o] * pow2(lprev);
      sKd[o] = sk[o] * pow2(sL[(kT - 1) * LD + c] - sL[o]);
      if (t >= kSub)  // anchored at its sub-chunk's start
        sQp[o - kSub * LD] =
            sr[o] * pow2(lprev - sL[((t / kSub) * kSub - 1) * LD + c]);
    }
    for (int e = tid; e < kKpRows * DH; e += kThreads) {
      const int row = e / DH, c = e % DH;
      int a = 1;
      while (row >= kp_row0(a + 1)) ++a;
      const int j = row - kp_row0(a);
      sKp[row * LD + c] = sk[j * LD + c] *
                          pow2(sL[(a * kSub - 1) * LD + c] - sL[j * LD + c]);
    }
    // A's diagonal blocks (diag_rows); tl >> 2 is the same for a warp
    for (int task = tid; task < kNSub * 128; task += kThreads) {
      const int sub = task / 128, tl = (task % 128) / 8, h8 = task % 8;
      const int j0 = sub * kSub;
      switch (tl >> 2) {
        case 0: diag_rows<DH, 4>(sA, sr, sk, sW, su, j0, tl, h8); break;
        case 1: diag_rows<DH, 8>(sA, sr, sk, sW, su, j0, tl, h8); break;
        case 2: diag_rows<DH, 12>(sA, sr, sk, sW, su, j0, tl, h8); break;
        default: diag_rows<DH, 16>(sA, sr, sk, sW, su, j0, tl, h8); break;
      }
    }
    __syncthreads();

    // phase 3: warp w < nO: cross = Q S_in for out tile w, kept in
    // registers; the rest: A's blocks below the diagonal and dS = Kd^T V
    Tile o_acc;
    {
      constexpr int nBelow = kNSub * (kNSub - 1) / 2;
      const int nS = keep_state ? (DH / 16) * (DH / 16) : 0;
      for (int i = warp; i < nO + nBelow + nS; i += kWarps) {
        Tile acc, lo, lo2;
        zero(acc);
        zero(lo);
        zero(lo2);
        if (i < nO) {
          const int ti = i / (DH / 16), vi = i % (DH / 16);
#pragma unroll
          for (int kc = 0; kc < DH; kc += 8)
            mma3<false, false>(acc, lo, lo2, sQ + ti * 16 * LD + kc, LD,
                               sS + kc * LD + vi * 16, LD, g, tq);
          fold(acc, lo);
          fold(acc, lo2);
          o_acc = acc;
        } else if (i < nO + nBelow) {
          int a = 1, bi = i - nO;
          while (bi >= a) bi -= a++;
          const float* kp = sKp + (kp_row0(a) + bi * kSub) * LD;
#pragma unroll
          for (int kc = 0; kc < DH; kc += 8)
            mma3<false, true>(acc, lo, lo2, sQp + (a - 1) * kSub * LD + kc,
                              LD, kp + kc, LD, g, tq);
          fold(acc, lo);
          fold(acc, lo2);
          store_tile(acc, sA + a * kSub * LT + bi * kSub, LT, g, tq);
        } else {
          const int ci = (i - nO - nBelow) / (DH / 16);
          const int vi = (i - nO - nBelow) % (DH / 16);
#pragma unroll
          for (int kj = 0; kj < kT; kj += 8)
            mma3<true, false, kExactV>(acc, lo, lo2,
                                       sKd + kj * LD + ci * 16, LD,
                                       sv + kj * LD + vi * 16, LD, g, tq);
          fold(acc, lo);
          fold(acc, lo2);
          store_tile(acc, sdS + ci * 16 * LD + vi * 16, LD, g, tq);
        }
      }
    }
    __syncthreads();

    // phase 4: out = cross + A V (intra and bonus), written from
    // registers; S = diag(2^L_last) S + dS
    if (warp < nO) {
      const int ti = warp / (DH / 16), vi = warp % (DH / 16);
      Tile lo, lo2;
      zero(lo);
      zero(lo2);
      // A is zero right of its diagonal block
      for (int kj = 0; kj < (ti + 1) * 16; kj += 8)
        mma3<false, false, kExactV>(o_acc, lo, lo2, sA + ti * 16 * LT + kj,
                                    LT, sv + kj * LD + vi * 16, LD, g, tq);
      fold(o_acc, lo);
      fold(o_acc, lo2);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = t0 + ti * 16 + g + 8 * half;
        if (t < p.S) {
#pragma unroll
          for (int n = 0; n < 2; ++n)
            __stcs(reinterpret_cast<float2*>(out + t * o_ss + vi * 16 +
                                             8 * n + 2 * tq),
                   make_float2(o_acc.c[n][2 * half],
                               o_acc.c[n][2 * half + 1]));
        }
      }
    }
    if (keep_state) {
      for (int e = 4 * tid; e < DH * DH; e += 4 * kThreads) {
        const int c = e / DH, o = c * LD + e % DH;
        const float a = sdecay[c];
        float4 st = *reinterpret_cast<float4*>(sS + o);
        const float4 d = *reinterpret_cast<const float4*>(sdS + o);
        st.x = a * st.x + d.x;
        st.y = a * st.y + d.y;
        st.z = a * st.z + d.z;
        st.w = a * st.w + d.w;
        *reinterpret_cast<float4*>(sS + o) = st;
      }
    }
    // the next chunk overwrites v, which phase 4 reads
    __syncthreads();
  }

  if (last && p.state != nullptr) {
    float* st = p.state + (long long)bh * DH * DH;
    for (int e = tid; e < DH * DH; e += kThreads)
      st[e] = sS[(e / DH) * LD + e % DH];
  }
}

// G groups a stream of group_t tokens (whole chunks) for B H streams of S
// tokens on a card of n_sm SMs: about n_sm / (B H) groups, at least one
int plan(int B, int H, int S, int n_sm, int* G, int* group_t) {
  const int chunks = (S + kT - 1) / kT;
  const long long streams = (long long)B * H;
  const int want = (int)min((long long)chunks, max(1LL, n_sm / streams));
  *group_t = (chunks + want - 1) / want * kT;
  *G = (S + *group_t - 1) / *group_t;
  return 0;
}

template <int DH, class TIn>
int launch(const Params& p, int B, cudaStream_t stream, int* n_launches) {
  const int n_streams = B * p.H;
  *n_launches = 0;
  if (p.G > 1) {
    rwkv_scan_group_state_kernel<DH, TIn>
        <<<n_streams * (p.G - 1), kThreads, 0, stream>>>(p);
    ++*n_launches;
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long n = (long long)n_streams * DH * DH;
    rwkv_scan_carry_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                             stream>>>(p, n_streams, DH);
    ++*n_launches;
  }
  const int smem = Smem<DH>::FLOATS * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      rwkv_scan_out_kernel<DH, TIn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rwkv_scan_out_kernel<DH, TIn>
      <<<n_streams * p.G, kThreads, smem, stream>>>(p);
  ++*n_launches;
  return (int)cudaGetLastError();
}

template <class TIn>
int launch_dh(const Params& p, int B, int dh, cudaStream_t stream,
              int* n_launches) {
  switch (dh) {
    case 16: return launch<16, TIn>(p, B, stream, n_launches);
    case 32: return launch<32, TIn>(p, B, stream, n_launches);
    case 64: return launch<64, TIn>(p, B, stream, n_launches);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The groups a stream, *G, for B H streams of S tokens on the current
// device; the launch then needs carry of (G - 1) dh^2 floats a stream and
// carry_decay of (G - 1) dh. Returns a CUDA error code.
int rwkv_scan_groups(int B, int H, int S, int* G) {
  int dev = 0, n_sm = 0, group_t = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return plan(B, H, S, n_sm, G, &group_t);
}

// Enqueues the scan's kernels on `stream` (one when G == 1, else three),
// stores their number in *n_launches and returns cudaGetLastError(). r, k, v: [B, S, H, dh], float32 (rkv_bf16 == 0) or
// bfloat16 (1); w: float32 [B, S, H, dh]; all four with dh contiguous,
// strides in elements; u: float32 [H, dh] contiguous; out: float32
// [B, S, H, dh] contiguous; state: float32 [B, H, dh, dh] contiguous, or
// null for no final state; carry, carry_decay: float32 scratch of the
// sizes above (null when G == 1). dh in {16, 32, 64}; B, S, H >= 1.
int rwkv_scan_launch(const void* r, const void* k, const void* v,
                     const float* w, const float* u, float* out, float* state,
                     float* carry, float* carry_decay, int* n_launches,
                     int B, int S, int H, int dh, int rkv_bf16,
                     long long r_sb, long long r_ss, long long r_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long w_sb, long long w_ss, long long w_sh,
                     void* stream) {
  *n_launches = 0;
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.out = out;
  p.state = state;
  p.carry = carry;
  p.carry_decay = carry_decay;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  p.S = S;
  p.H = H;
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  plan(B, H, S, n_sm, &p.G, &p.group_t);
  if (p.G > 1 && (carry == nullptr || carry_decay == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rkv_bf16 ? launch_dh<__nv_bfloat16>(p, B, dh, st, n_launches)
                  : launch_dh<float>(p, B, dh, st, n_launches);
}

const char* rwkv_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
