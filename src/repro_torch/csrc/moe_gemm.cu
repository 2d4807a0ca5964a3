// Grouped (per-expert) matrix product of the MoE layer.
//
// Both kernels here replace the Pallas kernel
//   src/repro/kernels/moe_gemm.py::moe_gemm (_moe_gemm_kernel):
//   out[e] = x[e] @ w[e] for the capacity-packed expert buffer x [E, C, d]
//   and the expert weights w [E, d, f], out [E, C, f], with a float32
//   accumulator over the whole d loop and the output in x's type.
//
// Contract: equal to the plain PyTorch version
// (repro_torch.kernels.moe_gemm.moe_gemm_plain: both inputs cast to float32,
// one float32 product, the result cast back) up to float32 summation order;
// a bfloat16 output then differs by at most one rounding step. Any C >= 1
// (rows past C are read as zeros and not stored); d and f multiples of 8,
// so that every row starts on a 16-byte boundary; x, w, out contiguous.
//
// What bounds it on an H100: operations, in the model's prefill. At
// mixtral-8x22b's expert shape [8, 2560, 6144] x [8, 6144, 16384] it does
// 4.12 TFLOP against 2.53 GB of inputs and output (4.17 ms against 0.76 ms
// at the card's peaks). In decode (C 8) it is bytes: the 1.61 GB of w.
//
// Design. The TPU kernel's sequential d-block grid axis, which carries the
// accumulator in scratch memory, becomes a loop inside the block; the grid
// is (f tiles, C tiles, E), one block per 128 x 128 output tile.
//
// * bfloat16 (the model's path): 8 warps on the tensor cores with mma.sync
//   m16n8k16 (bf16 in, f32 accumulate), each warp owning a 64 x 32 part of
//   the tile (4 x 4 fragments, 64 accumulators a thread). The d loop walks
//   32-deep stages through a ring of three shared-memory buffers: cp.async
//   streams stage k + 2 in while the warps compute on stage k. x rows are
//   [C, d] with d contiguous, so A fragments load as 32-bit pairs; w is
//   [d, f] with f contiguous, so its B fragments come by ldmatrix.trans,
//   as K3's V does. Rows are padded by 8 elements so that no fragment load
//   has a bank conflict. The ragged C and d edges are zero-filled by
//   cp.async (a source size of 0) and the store is masked.
// * float32: 256 threads on the CUDA cores (no tensor-core rate would keep
//   float32 accuracy), each holding a 4 x 4 part of a 64 x 64 tile; x^T
//   and w pass through shared memory 16 deep.
//
// Left for later: wgmma fed by TMA with a warp-specialised producer, a
// persistent grid, and a tile shape for the decode's few rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Params {
  const void* x;
  const void* w;
  void* o;
  int C, d, f;
};

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, mma.sync m16n8k16

constexpr int kBM = 128;       // rows of x (capacity slots) per block
constexpr int kBN = 128;       // columns of w per block
constexpr int kBK = 32;        // depth of a stage
constexpr int kStages = 3;     // the ring of shared-memory stages
constexpr int kThreads = 256;  // 8 warps: 2 along the rows x 4 along f
constexpr int kAS = kBK + 8;   // row stride of the x tile (elements)
constexpr int kBS = kBN + 8;   // row stride of the w tile (elements)
constexpr int kATile = kBM * kAS;
constexpr int kBTile = kBK * kBS;
constexpr int kMmaSmemBytes = kStages * (kATile + kBTile) * 2;

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

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying the stage at depth k0: x rows row0.. (kBM x kBK) and w rows
// k0.. at columns col0.. (kBK x kBN), in 16-byte vectors; vectors past C,
// d or f are zero.
__device__ __forceinline__ void load_stage(__nv_bfloat16* sA,
                                           __nv_bfloat16* sB,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* w,
                                           const Params& p, int row0,
                                           int col0, int k0) {
  constexpr int kAVec = kBK / 8;
  for (int e = threadIdx.x; e < kBM * kAVec; e += kThreads) {
    const int r = e / kAVec;
    const int c = (e - r * kAVec) * 8;
    const bool ok = row0 + r < p.C && k0 + c < p.d;
    cp_async16(sA + r * kAS + c,
               ok ? x + (long long)(row0 + r) * p.d + k0 + c : x, ok);
  }
  constexpr int kBVec = kBN / 8;
  for (int e = threadIdx.x; e < kBK * kBVec; e += kThreads) {
    const int r = e / kBVec;
    const int c = (e - r * kBVec) * 8;
    const bool ok = k0 + r < p.d && col0 + c < p.f;
    cp_async16(sB + r * kBS + c,
               ok ? w + (long long)(k0 + r) * p.f + col0 + c : w, ok);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    moe_gemm_mma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sA = sm;                       // kStages x [kBM][kAS]
  __nv_bfloat16* sB = sm + kStages * kATile;    // kStages x [kBK][kBS]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // fragment column pair
  const int wm = warp >> 2;  // this warp's 64 rows: wm * 64..
  const int wn = warp & 3;   // this warp's 32 columns: wn * 32..
  const int col0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int e = blockIdx.z;
  const __nv_bfloat16* x =
      static_cast<const __nv_bfloat16*>(p.x) + (long long)e * p.C * p.d;
  const __nv_bfloat16* w =
      static_cast<const __nv_bfloat16*>(p.w) + (long long)e * p.d * p.f;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + (long long)e * p.C * p.f;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;

  const int nk = (p.d + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk)
      load_stage(sA + s * kATile, sB + s * kBTile, x, w, p, row0, col0,
                 s * kBK);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // stage kt has arrived
    __syncthreads();  // ...for every thread; stage kt - 1 is read by all
    {
      const int nt = kt + kStages - 1;  // refill the buffer of stage kt - 1
      if (nt < nk)
        load_stage(sA + (nt % kStages) * kATile, sB + (nt % kStages) * kBTile,
                   x, w, p, row0, col0, nt * kBK);
      cp_async_commit();
    }
    const __nv_bfloat16* a_t = sA + (kt % kStages) * kATile;
    const __nv_bfloat16* b_t = sB + (kt % kStages) * kBTile;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // A fragments: a0 (g, 2t), a1 (g+8, 2t), a2 (g, 2t+8), a3 (g+8, 2t+8)
      unsigned af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* r0 =
            a_t + (wm * 64 + i * 16 + g) * kAS + kk * 16 + 2 * t;
        af[i][0] = ld32(r0);
        af[i][1] = ld32(r0 + 8 * kAS);
        af[i][2] = ld32(r0 + 8);
        af[i][3] = ld32(r0 + 8 * kAS + 8);
      }
      // B fragments (k 2t.., n g) of w [k][n] by ldmatrix.trans, two
      // n-tiles of 8 per load
      unsigned bf[4][2];
      const __nv_bfloat16* br =
          b_t + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kBS +
          wn * 32 + (lane >> 4) * 8;
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        unsigned r[4];
        ldmatrix_x4_trans(r, br + nn * 16);
        bf[2 * nn][0] = r[0];
        bf[2 * nn][1] = r[1];
        bf[2 * nn + 1][0] = r[2];
        bf[2 * nn + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  cp_async_wait<0>();

  // C fragments: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r0 = row0 + wm * 64 + i * 16 + g;
    const int r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + wn * 32 + j * 8 + 2 * t;
      if (col >= p.f) continue;
      if (r0 < p.C)
        *reinterpret_cast<unsigned*>(o + (long long)r0 * p.f + col) =
            pack_bf16(acc[i][j][0], acc[i][j][1]);
      if (r1 < p.C)
        *reinterpret_cast<unsigned*>(o + (long long)r1 * p.f + col) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores

constexpr int kFM = 64;        // rows per block
constexpr int kFN = 64;        // columns per block
constexpr int kFK = 16;        // depth per step
constexpr int kFThreads = 256;  // 16 x 16: (ty, tx) owns rows ty*4.., cols tx*4..
constexpr int kFPad = 4;       // keeps float4 rows aligned

__global__ void __launch_bounds__(kFThreads)
    moe_gemm_f32_kernel(const Params p) {
  __shared__ __align__(16) float sXT[kFK][kFM + kFPad];  // x tile, transposed
  __shared__ __align__(16) float sW[kFK][kFN + kFPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = blockIdx.x * kFN;
  const int row0 = blockIdx.y * kFM;
  const int e = blockIdx.z;
  const float* x = static_cast<const float*>(p.x) + (long long)e * p.C * p.d;
  const float* w = static_cast<const float*>(p.w) + (long long)e * p.d * p.f;
  float* o = static_cast<float*>(p.o) + (long long)e * p.C * p.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.d; k0 += kFK) {
    for (int v = tid; v < kFM * kFK; v += kFThreads) {
      const int r = v / kFK;
      const int c = v - r * kFK;
      sXT[c][r] = row0 + r < p.C && k0 + c < p.d
                      ? x[(long long)(row0 + r) * p.d + k0 + c]
                      : 0.0f;
    }
    for (int v = tid; v < kFK * kFN; v += kFThreads) {
      const int r = v / kFN;
      const int c = v - r * kFN;
      sW[r][c] = k0 + r < p.d && col0 + c < p.f
                     ? w[(long long)(k0 + r) * p.f + col0 + c]
                     : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&sXT[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sW[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the tiles are read: the next step overwrites them
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= p.C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < p.f) o[(long long)r * p.f + c] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError().
// dtype: 0 float32, 1 bfloat16. x [E, C, d], w [E, d, f] and out [E, C, f]
// contiguous, E >= 1, C >= 1, d and f positive multiples of 8; for bfloat16
// the pointers are 16-byte aligned (the tiles move in 16-byte vectors).
int moe_gemm_launch(const void* x, const void* w, void* o, int dtype, int E,
                    int C, int d, int f, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (E < 1 || C < 1 || d < 8 || f < 8 || d % 8 || f % 8)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.w = w;
  p.o = o;
  p.C = C;
  p.d = d;
  p.f = f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // above 48 KB a block's shared memory must be opted in
    const cudaError_t opt_in = cudaFuncSetAttribute(
        moe_gemm_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMmaSmemBytes);
    if (opt_in != cudaSuccess) return (int)opt_in;
    const dim3 grid((f + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
    moe_gemm_mma_kernel<<<grid, kThreads, kMmaSmemBytes, st>>>(p);
  } else {
    const dim3 grid((f + kFN - 1) / kFN, (C + kFM - 1) / kFM, E);
    moe_gemm_f32_kernel<<<grid, kFThreads, 0, st>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* moe_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
