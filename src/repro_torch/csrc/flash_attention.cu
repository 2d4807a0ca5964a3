// Flash attention (causal / sliding-window / non-causal), GQA-aware.
//
// Both kernels here replace the Pallas kernel
//   src/repro/kernels/flash_attention.py::flash_attention (_attn_kernel):
//   out = softmax(q k^T * scale + mask) v over q [B, H, S, dh] and
//   k, v [B, KV, Sk, dh], query head h reading kv head h / (H / KV).
//   Queries are aligned to the end of the keys (q_offset = Sk - S); the
//   causal mask keeps kpos <= qpos, a window w > 0 also kpos > qpos - w.
//   Scores, the running max, the denominator (floored at 1e-30) and the
//   accumulator are float32; the output is in the input's type.
//
// Contract: equal to the plain PyTorch version
// (repro_torch.kernels.flash_attention.flash_attention_plain) up to float32
// summation order, for bfloat16 inputs too: there the softmax weights P
// enter the P V product on the tensor cores as two bfloat16 parts,
// P = hi + lo, so P keeps about 16 significant bits (a relative 2^-17)
// and the output differs from the plain version's by at most one bfloat16
// rounding step. Masked scores are the finite -1e30, as in the
// reference: a row with no valid key in a tile that still runs gets exp(0)
// there, and the next tile with a valid key zeroes it through
// alpha = exp(-1e30 - m). With -inf that tile would give NaN.
//
// What bounds it on an H100: operations. At the llama3.2-3b prefill shape
// (B 4, H 32, KV 8, S = Sk = 2048, dh 128, causal) it does 137 GFLOP
// against 0.17 GB of inputs and output.
//
// Design. One block per (query tile of 64 rows, head, batch), the query
// tiles with the most key tiles first. The block stages its Q tile once,
// then walks the key tiles of 64 keys in order over the range the mask
// leaves (the tiles it removes wholly, flash_attention.py:44-51, are never
// visited); each tile is staged in shared memory, scored, masked where the
// tile has a masked pair, folded into the running max/sum/accumulator
// (online softmax), and dropped. The ragged S and Sk edges are masked:
// rows past S are computed on zeros and not stored, keys past Sk are
// masked and their K/V rows are zero.
//
// * bfloat16 (the model's path): 4 warps, each owning 16 query rows, on
//   the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate). The
//   warp keeps its Q fragments in registers, takes K fragments from shared
//   memory with 32-bit loads and V fragments with ldmatrix.trans, and
//   reuses the S accumulator layout as the A operand of P V, so P never
//   goes through shared memory; P V is issued twice, on P's high and low
//   bfloat16 parts (V is bfloat16 already, so nothing else rounds). K/V tiles are bf16 in two shared-memory
//   buffers (70 KB at dh 128): cp.async streams the next tile in while the
//   warps compute on this one. Rows are padded by 8 elements so that no
//   fragment load has a bank conflict.
// * float32: 256 threads on the CUDA cores (no tensor-core rate would keep
//   float32 accuracy). Each thread holds a 4 x 4 score tile and 4 rows x
//   dh/16 columns of the accumulator in registers; K^T, V and P^T go
//   through shared memory in float32 (87 KB at dh 128).
//
// Left for later: TMA loads, wgmma with a warp-specialised producer, and a
// persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // keys per tile
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

// The block's query tile and the range of key tiles it runs. Tiles outside
// [first, last] are wholly masked (the block-level skip of
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
  // whether some (row, key) of the tile is masked: the ragged key edge,
  // a key after the tile's first row, or one before the last row's window
  __device__ bool needs_mask(const Params& p, int k_lo) const {
    if (k_lo + kBK > p.Sk) return true;
    if (!p.causal) return false;
    return k_lo + kBK - 1 > q_lo ||
           (p.window > 0 && k_lo <= q_lo + kBQ - 1 - p.window);
  }
};

__device__ __forceinline__ bool keep(const Params& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) {
    ok = ok && kpos <= qpos;
    if (p.window > 0) ok = ok && kpos > qpos - p.window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, mma.sync m16n8k16

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row addresses
// of matrix i, and register i holds the fragment of matrix i
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// (x, y) as hi + lo, each a bf16 pair: hi = bf16(x, y), lo = bf16 of the rest
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int DH>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 4 * kBK * (DH + 8) * 2;  // two buffers of (K, V) in bf16
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows row0.. of a [*, DH] bf16 matrix into a [64][DH + 8]
// tile in 16-byte vectors; rows at or past `n_rows` (n_rows >= 1) are zero.
template <int DH>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int row0,
                                           int n_rows) {
  constexpr int kVec = DH / 8;
  for (int e = threadIdx.x; e < kBQ * kVec; e += kMmaThreads) {
    const int r = e / kVec;
    const int c = (e - r * kVec) * 8;
    const bool ok = r < n_rows;
    cp_async16(dst + r * (DH + 8) + c,
               src + (long long)(row0 + (ok ? r : 0)) * stride + c, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_mma_kernel(const Params p) {
  constexpr int RS = DH + 8;  // row stride in shared memory (elements)
  constexpr int KT = DH / 16;  // k-steps of Q K^T
  constexpr int NT = DH / 8;   // n-tiles of the output
  constexpr int ST = kBK / 8;  // n-tiles of the scores
  constexpr int TILE = kBK * RS;
  extern __shared__ float4 smem4[];
  // two buffers of (K, V); Q passes through the second K before the walk
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / p.group;
  const Walk w(p);
  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  stage_bf16<DH>(sm + 2 * TILE, q, p.q_ss, w.q0, p.S - w.q0);
  cp_async_commit();
  {
    const int k_lo = w.first * kBK;
    stage_bf16<DH>(sm, k, p.k_ss, k_lo, p.Sk - k_lo);
    stage_bf16<DH>(sm + TILE, v, p.v_ss, k_lo, p.Sk - k_lo);
    cp_async_commit();
  }
  cp_async_wait<1>();  // Q has arrived
  __syncthreads();
  // this warp's rows of Q as A fragments: a0 (g, 2t), a1 (g+8, 2t),
  // a2 (g, 2t+8), a3 (g+8, 2t+8) of each 16 x 16 step
  unsigned qf[KT][4];
  {
    const __nv_bfloat16* r0 = sm + 2 * TILE + (warp * 16 + g) * RS + 2 * t;
    const __nv_bfloat16* r1 = r0 + 8 * RS;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = ld32(r0 + kk * 16);
      qf[kk][1] = ld32(r1 + kk * 16);
      qf[kk][2] = ld32(r0 + kk * 16 + 8);
      qf[kk][3] = ld32(r1 + kk * 16 + 8);
    }
  }
  __syncthreads();  // Q is read: its buffer takes the next tile

  // accumulator C fragments: c0, c1 at row g, c2, c3 at row g + 8
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  const int qpos0 = w.q_lo + warp * 16 + g;
  const int qpos1 = qpos0 + 8;

  for (int kj = w.first, it = 0; kj <= w.last; ++kj, ++it) {
    const int k_lo = kj * kBK;
    const __nv_bfloat16* sK = sm + (it & 1) * 2 * TILE;
    const __nv_bfloat16* sV = sK + TILE;
    if (kj < w.last) {  // the next tile streams in while this one computes
      __nv_bfloat16* nK = sm + ((it + 1) & 1) * 2 * TILE;
      stage_bf16<DH>(nK, k, p.k_ss, k_lo + kBK, p.Sk - k_lo - kBK);
      stage_bf16<DH>(nK + TILE, v, p.v_ss, k_lo + kBK, p.Sk - k_lo - kBK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: B fragment (k 2t.., n g) is K[key g][d 2t..], contiguous
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int j = 0; j < ST; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * RS + kk * 16 + 2 * t;
        mma_bf16(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, mask (only where the tile has a masked pair) and online
    // softmax; a row's scores live on the 4 lanes that share g
    if (w.needs_mask(p, k_lo)) {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_lo + j * 8 + 2 * t + (e & 1);
          s[j][e] = keep(p, e < 2 ? qpos0 : qpos1, kpos) ? s[j][e] * p.scale
                                                         : kNegInf;
        }
    } else {
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p.scale;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P V: the score tiles 2kk and 2kk+1 are the A fragment of keys
    // 16kk..16kk+15, split into its high and low bf16 parts; V fragments
    // by ldmatrix.trans, two n-tiles at a time, each used by both parts
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const __nv_bfloat16* vr =
          sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RS + (lane >> 4) * 8;
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        unsigned r[4];
        ldmatrix_x4_trans(r, vr + nn * 16);
        mma_bf16(acc[2 * nn], lo, r[0], r[1]);
        mma_bf16(acc[2 * nn + 1], lo, r[2], r[3]);
        mma_bf16(acc[2 * nn], hi, r[0], r[1]);
        mma_bf16(acc[2 * nn + 1], hi, r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is read: the next-but-one tile takes it
  }

  const int row0 = w.q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * t;
    if (row0 < p.S)
      *reinterpret_cast<unsigned*>(o + (long long)row0 * p.o_ss + col) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < p.S)
      *reinterpret_cast<unsigned*>(o + (long long)row1 * p.o_ss + col) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
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

template <typename Kernel>
int launch(Kernel kernel, int threads, int bytes, const Params& p, int B,
           int H, cudaStream_t stream) {
  // above 48 KB a block's shared memory must be opted in
  const cudaError_t opt_in = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (opt_in != cudaSuccess) return (int)opt_in;
  const dim3 grid((p.S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dh(const Params& p, bool bf16, int B, int H, cudaStream_t stream) {
  if (bf16)
    return launch(flash_attention_mma_kernel<DH>, kMmaThreads,
                  mma_smem_bytes<DH>(), p, B, H, stream);
  return launch(flash_attention_f32_kernel<DH>, kThreads, f32_smem_bytes<DH>(),
                p, B, H, stream);
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError().
// dtype: 0 float32, 1 bfloat16; dh in {64, 80, 128}; S >= 1, Sk >= 1, and
// Sk >= S when causal. Strides are in elements, the last dim contiguous;
// for bfloat16 the pointers are 16-byte aligned and the strides multiples
// of 8 (the tiles move in 16-byte vectors).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int B, int H, int KV, int S,
                           int Sk, int dh, long long q_sb, long long q_sh,
                           long long q_ss, long long k_sb, long long k_sh,
                           long long k_ss, long long v_sb, long long v_sh,
                           long long v_ss, long long o_sb, long long o_sh,
                           long long o_ss, int causal, int window, float scale,
                           void* stream) {
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
  switch (dh) {
    case 64: return launch_dh<64>(p, bf16, B, H, st);
    case 80: return launch_dh<80>(p, bf16, B, H, st);
    case 128: return launch_dh<128>(p, bf16, B, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
