// Grouped (per-expert) matrix product of the MoE layer.
//
// The kernels here replace the Pallas kernel
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
// so that every row starts on a 16-byte boundary; x, w, out contiguous and
// 16-byte aligned.
//
// What bounds it on an H100: operations in the model's prefill, bytes in
// its decode. At mixtral-8x22b's prefill shape [8, 2560, 6144] x [8, 6144,
// 16384] it does 4.12 TFLOP against 2.53 GB of inputs and output (4.17 ms
// against 0.76 ms at the card's peaks); in decode (C 8) the 1.61 GB of w
// take 0.48 ms and the products 0.013 ms.
//
// Design. The TPU kernel's sequential d-block grid axis, which carries the
// accumulator in scratch memory, becomes a loop inside the block over a
// ring of shared-memory stages. bfloat16 has two kernels, chosen by the
// wrapper from C alone (repro_torch.kernels.moe_gemm.pick_variant):
//
// * wide (C > 64: prefill). Persistent: one block per SM walks the 128 x
//   256 output tiles expert by expert; inside an expert in groups of
//   kGroupF f tiles, the C tiles fastest, so that the [d, 256] weight
//   panels of a group stay in L2 while every C tile passes over them. A
//   producer warp issues TMA loads (x box 128 rows x 64 of d; w four boxes
//   64 of d x 64 of f, all 128B-swizzled) into a ring of kWStages stages
//   behind full/empty mbarriers; two consumer warpgroups each run wgmma
//   m64n256k16 on 64 rows of the tile (x K-major as A, w MN-major as B,
//   the transpose-B bit set), with one wgmma group in flight while the next
//   stage is waited for. setmaxnreg gives the producer's registers to the
//   consumers (128 accumulators a thread). The epilogue stores bf16 pairs
//   from registers, masked at C and f, while the producer already loads the
//   next tile.
// * narrow (C <= 64: decode). The time is w's bytes, and a 64-row wgmma
//   tile over C would compute padded rows, so the operands swap:
//   out^T[f, C] = w^T x^T, with 64 columns of w as the M of wgmma
//   m64nNk16 (w MN-major as A, the transpose-A bit set) and x K-major as B,
//   N = C rounded up to 8, 16, 32 or 64. One block per 64 f columns of an
//   expert; a producer warp keeps a deep ring of 128-deep stages of w (16
//   KB) and x in flight. The store is masked at C and f.
//
// The 3-D tensor maps ([E, C, d] for x, [E, d, f] for w) make TMA fill
// zeros past each expert's C, past d and past f, so no tile reads another
// expert's rows. They are encoded on the host at every launch by
// cuTensorMapEncodeTiled (libcuda; hopper.cuh's encode_tiled), and passed
// as __grid_constant__ kernel parameters.
//
// * float32: 256 threads on the CUDA cores (no tensor-core rate would keep
//   float32 accuracy), each holding a 4 x 4 part of a 64 x 64 tile; x^T
//   and w pass through shared memory 16 deep.
//
// Routed (moe_gemm_routed_launch): x [R, d] holds each expert's routed rows
// in one segment, the segments in expert order and 128-row aligned, and a
// device array tiles[E + 1] gives each segment's start in 128-row tiles
// (tiles[E], the tiles in all; rows past it are neither read nor stored).
// The dropless prefill's capacity buffer is three rows in four empty; the
// routed one multiplies only the routed rows and at most 127 padding rows
// an expert. The host never reads the array: the wide kernel's persistent
// walk takes its length from tiles[E] and finds a tile's expert by a binary
// search of the array, then walks inside the expert as above; a segment is
// 128-aligned, so a tile never holds two experts' rows. The float32 kernel
// finds each 64-row block's expert the same way.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

struct Params {
  const void* x;
  const void* w;
  void* o;
  const int* tiles;  // routed: segment starts in 128-row tiles; else null
  int E, C, d, f;
};

// the bfloat16 kernels read x and w through their tensor maps
struct Dims {
  void* o;
  int E, C, d, f;
};

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// bytes of a 128B-swizzled bf16 box: rows x 64 elements
__host__ __device__ constexpr int box_bytes(int rows) { return rows * 128; }

// ---------------------------------------------------------------------------
// bfloat16, wide: persistent, TMA + wgmma m64n256k16, warp-specialised

constexpr int kWM = 128;              // rows of x (capacity slots) a tile
constexpr int kWN = 256;              // columns of w a tile
constexpr int kWK = 64;               // depth of a stage
constexpr int kWStages = 4;           // the ring: 4 x 48 KB
constexpr int kWThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kGroupF = 8;            // f tiles walked together
constexpr int kWABytes = box_bytes(kWM);          // 16 KB
constexpr int kWBBox = box_bytes(kWK);            // 8 KB: 64 of d x 64 of f
constexpr int kWBBytes = (kWN / 64) * kWBBox;     // 32 KB
constexpr int kWStageBytes = kWABytes + kWBBytes;
constexpr int kWSmemBytes = kWStages * kWStageBytes + 1024 + 128;

constexpr int kRouteRows = 128;       // a routed segment's alignment
static_assert(kRouteRows == kWM, "a wide tile is one routed tile");

// x's slice of a tile: its expert in the 3-D map (0 for the routed [1, R,
// d] map) and its first row there; w's expert and first column
struct WideTile {
  int xe, row0, e, col0;
};

// r-th tile inside an expert of tiles_c row tiles: groups of kGroupF f
// tiles, the row tiles fastest inside a group
__device__ __forceinline__ void in_expert(int r, int tiles_c, int* ct,
                                          int* ft) {
  const int group = r / (kGroupF * tiles_c);
  const int in_group = r - group * (kGroupF * tiles_c);
  *ct = in_group % tiles_c;
  *ft = group * kGroupF + in_group / tiles_c;
}

// the routed segment that holds `unit` (a tile index times `scale`): the
// last e < E whose start tiles[e] * scale is at most it. An empty segment
// starts where the next one does, so it is never the last such e.
__device__ __forceinline__ int segment_of(const int* __restrict__ tiles,
                                          int E, int unit, int scale) {
  int lo = 0, hi = E - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (__ldg(tiles + mid) * scale <= unit) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// tile t of the walk, expert-major. Dense: every expert has tiles_c row
// tiles. Routed: expert e has tiles[e + 1] - tiles[e], from row tiles[e] *
// kWM of x.
template <bool kRouted>
__device__ __forceinline__ WideTile wide_tile(int t, int tiles_c, int tiles_f,
                                              const Dims& p,
                                              const int* __restrict__ tiles) {
  int e, first = 0, r, ct, ft;
  if (kRouted) {
    e = segment_of(tiles, p.E, t, tiles_f);
    first = __ldg(tiles + e);
    tiles_c = __ldg(tiles + e + 1) - first;
    r = t - first * tiles_f;
  } else {
    e = t / (tiles_c * tiles_f);
    r = t - e * tiles_c * tiles_f;
  }
  in_expert(r, tiles_c, &ct, &ft);
  return {kRouted ? 0 : e, (first + ct) * kWM, e, ft * kWN};
}

template <bool kRouted>
__global__ void __launch_bounds__(kWThreads, 1)
    moe_gemm_wide_kernel(const __grid_constant__ CUtensorMap tmap_x,
                         const __grid_constant__ CUtensorMap tmap_w,
                         const Dims p, const int* __restrict__ tiles) {
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles start on 1024-byte boundaries
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStageBytes);
  uint64_t* empty = full + kWStages;
  auto stage_a = [&](int s) { return smem + s * kWStageBytes; };
  auto stage_b = [&](int s) { return smem + s * kWStageBytes + kWABytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);  // the producer's arrival + the TMA bytes
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // routed: p.C is R, the rows of x, and the walk covers tiles[E] row
  // tiles (at most R's)
  const int tiles_c = (p.C + kWM - 1) / kWM;
  const int tiles_f = (p.f + kWN - 1) / kWN;
  const int n_tiles =
      (kRouted ? min(__ldg(tiles + p.E), tiles_c) : p.E * tiles_c) * tiles_f;
  const int nk = (p.d + kWK - 1) / kWK;

  if (threadIdx.x < 128) {
    // producer warpgroup: one thread issues every load
    regs_dealloc<40>();
    if (threadIdx.x == 0) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const WideTile tile =
            wide_tile<kRouted>(t, tiles_c, tiles_f, p, tiles);
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[s], phase ^ 1);
          mbar_arrive_expect_tx(&full[s], kWStageBytes);
          const int k0 = kb * kWK;
          tma_load_3d(stage_a(s), &tmap_x, &full[s], k0, tile.row0, tile.xe);
#pragma unroll
          for (int i = 0; i < kWN / 64; ++i)
            tma_load_3d(stage_b(s) + i * kWBBox, &tmap_w, &full[s],
                        tile.col0 + 64 * i, k0, tile.e);
          if (++s == kWStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumer warpgroups 1 and 2: rows 64 (wg - 1).. of each tile
    regs_alloc<232>();
    const int wg = threadIdx.x / 128 - 1;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    float acc[kWN / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const WideTile tile = wide_tile<kRouted>(t, tiles_c, tiles_f, p, tiles);
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[s], phase);
        const uint8_t* a = stage_a(s) + wg * box_bytes(64);
        const uint8_t* b = stage_b(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWK / 16; ++kk)
          wgmma_bf16<0, 1>(acc, desc_sw128(a + 32 * kk, 16, 1024),
                           desc_sw128(b + 2048 * kk, kWBBox, 1024),
                           kb > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the group of k-block kb - 1 has finished...
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);  // ...free it
        prev = s;
        if (++s == kWStages) {
          s = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[prev]);
      fence_regs(acc);

      // C fragments: acc[4j..4j+1] at (r0, c), acc[4j+2..4j+3] at (r0 + 8, c)
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                         (long long)tile.xe * p.C * p.f;
      const int r0 = tile.row0 + wg * 64 + warp * 16 + lane / 4;
      const int c0 = tile.col0 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const int c = c0 + 8 * j;
        if (c >= p.f) continue;
        if (r0 < p.C)
          *reinterpret_cast<unsigned*>(o + (long long)r0 * p.f + c) =
              pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (r0 + 8 < p.C)
          *reinterpret_cast<unsigned*>(o + (long long)(r0 + 8) * p.f + c) =
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16, narrow: out^T = w^T x^T with wgmma m64nNk16, N = C rounded up

constexpr int kNM = 64;          // columns of w (rows of out^T) a block
constexpr int kNK = 128;         // depth of a stage
constexpr int kNThreads = 160;   // consumer warpgroup + producer warp
constexpr int kNWBytes = box_bytes(kNK);  // 16 KB: 128 of d x 64 of f

template <int N>
struct Narrow {
  static constexpr int kXBox = box_bytes(N);            // 64 of d x N rows
  static constexpr int kStageBytes = kNWBytes + 2 * kXBox;
  // as deep as fits two blocks an SM (~110 KB each)
  static constexpr int kStages =
      (110 * 1024 / kStageBytes) < 8 ? (110 * 1024 / kStageBytes) : 8;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 128;
};

template <int N>
__global__ void __launch_bounds__(kNThreads)
    moe_gemm_narrow_kernel(const __grid_constant__ CUtensorMap tmap_x,
                           const __grid_constant__ CUtensorMap tmap_w,
                           const Dims p) {
  using T = Narrow<N>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  auto stage_w = [&](int s) { return smem + s * T::kStageBytes; };
  auto stage_x = [&](int s) { return smem + s * T::kStageBytes + kNWBytes; };

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int f0 = blockIdx.x * kNM;
  const int e = blockIdx.y;
  const int nk = (p.d + kNK - 1) / kNK;

  if (threadIdx.x >= 128) {
    // producer warp
    if (threadIdx.x == 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_arrive_expect_tx(&full[s], T::kStageBytes);
        const int kd = kb * kNK;
        tma_load_3d(stage_w(s), &tmap_w, &full[s], f0, kd, e);
        tma_load_3d(stage_x(s), &tmap_x, &full[s], kd, 0, e);
        tma_load_3d(stage_x(s) + T::kXBox, &tmap_x, &full[s], kd + 64, 0, e);
        if (++s == T::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroup: out^T rows f0.., all N columns
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    float acc[N / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(&full[s], phase);
      const uint8_t* wt = stage_w(s);
      const uint8_t* xt = stage_x(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kNK / 16; ++kk)
        wgmma_bf16<1, 0>(acc, desc_sw128(wt + 2048 * kk, 16, 1024),
                         desc_sw128(xt + (kk / 4) * T::kXBox + 32 * (kk % 4),
                                    16, 1024),
                         kb > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == T::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    fence_regs(acc);

    // out^T fragments: acc[4j + 2h + i] at f row fr = f0 + 16 warp + lane / 4
    // + 8h, C column c + i, c = 8j + 2 (lane % 4)
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) +
                       (long long)e * p.C * p.f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int fr = f0 + warp * 16 + lane / 4 + 8 * h;
        if (fr >= p.f) continue;
        if (c < p.C)
          o[(long long)c * p.f + fr] = __float2bfloat16_rn(acc[4 * j + 2 * h]);
        if (c + 1 < p.C)
          o[(long long)(c + 1) * p.f + fr] =
              __float2bfloat16_rn(acc[4 * j + 2 * h + 1]);
      }
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
static_assert(kRouteRows % kFM == 0, "a block's rows lie in one segment");

__global__ void __launch_bounds__(kFThreads)
    moe_gemm_f32_kernel(const Params p) {
  __shared__ __align__(16) float sXT[kFK][kFM + kFPad];  // x tile, transposed
  __shared__ __align__(16) float sW[kFK][kFN + kFPad];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int col0 = blockIdx.x * kFN;
  const int row0 = blockIdx.y * kFM;
  // dense: expert blockIdx.z, its C rows. Routed: x and out are [R, .],
  // the rows up to tiles[E] * 128 are walked, each block's in one segment
  int e = blockIdx.z, rows = p.C;
  long long xe = e;
  if (p.tiles != nullptr) {
    rows = min(__ldg(p.tiles + p.E) * kRouteRows, p.C);
    if (row0 >= rows) return;
    e = segment_of(p.tiles, p.E, row0, kRouteRows);
    xe = 0;
  }
  const float* x = static_cast<const float*>(p.x) + xe * p.C * p.d;
  const float* w = static_cast<const float*>(p.w) + (long long)e * p.d * p.f;
  float* o = static_cast<float*>(p.o) + xe * p.C * p.f;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.d; k0 += kFK) {
    for (int v = tid; v < kFM * kFK; v += kFThreads) {
      const int r = v / kFK;
      const int c = v - r * kFK;
      sXT[c][r] = row0 + r < rows && k0 + c < p.d
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
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx * 4 + j;
      if (c < p.f) o[(long long)r * p.f + c] = acc[i][j];
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// host side

namespace {

constexpr int kErrNoEncoder = -1;  // libcuda has no cuTensorMapEncodeTiled
constexpr int kErrEncode = -2;     // it refused a tensor map

// A 3-D map over a contiguous bf16 tensor [outer][rows][inner], read in
// boxes of box_rows x 64 inner elements with 128-byte swizzle; what lies
// outside the tensor reads as zeros.
int map_3d(CUtensorMap* m, const void* base, int inner, int rows, int outer,
           int box_rows) {
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// dense: x [E, C, d]; routed: x [R, d] (p.C = R) and the device array
// `tiles`, which the host does not read: the grid covers R's row tiles
template <bool kRouted>
int launch_wide(const void* x, const void* w, const Dims& p,
                const int* tiles, cudaStream_t st) {
  CUtensorMap tx, tw;
  int err = map_3d(&tx, x, p.d, p.C, kRouted ? 1 : p.E, kWM);
  if (err == 0) err = map_3d(&tw, w, p.f, p.d, p.E, kWK);
  if (err != 0) return err;
  cudaError_t ce = cudaFuncSetAttribute(
      moe_gemm_wide_kernel<kRouted>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmemBytes);
  int dev = 0, sms = 0;
  if (ce == cudaSuccess) ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess)
    ce = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (ce != cudaSuccess) return (int)ce;
  const int n_tiles = (kRouted ? 1 : p.E) * ((p.C + kWM - 1) / kWM) *
                      ((p.f + kWN - 1) / kWN);
  const int grid = n_tiles < sms ? n_tiles : sms;
  moe_gemm_wide_kernel<kRouted>
      <<<grid, kWThreads, kWSmemBytes, st>>>(tx, tw, p, tiles);
  return (int)cudaGetLastError();
}

int launch_f32(const void* x, const void* w, void* o, const int* tiles,
               int E, int C, int d, int f, cudaStream_t st) {
  Params p;
  p.x = x;
  p.w = w;
  p.o = o;
  p.tiles = tiles;
  p.E = E;
  p.C = C;
  p.d = d;
  p.f = f;
  const dim3 grid((f + kFN - 1) / kFN, (C + kFM - 1) / kFM,
                  tiles == nullptr ? E : 1);
  moe_gemm_f32_kernel<<<grid, kFThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

template <int N>
int launch_narrow(const void* x, const void* w, const Dims& p,
                  cudaStream_t st) {
  CUtensorMap tx, tw;
  int err = map_3d(&tx, x, p.d, p.C, p.E, N);
  if (err == 0) err = map_3d(&tw, w, p.f, p.d, p.E, kNK);
  if (err != 0) return err;
  const cudaError_t ce = cudaFuncSetAttribute(
      moe_gemm_narrow_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Narrow<N>::kSmemBytes);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((p.f + kNM - 1) / kNM, p.E);
  moe_gemm_narrow_kernel<N>
      <<<grid, kNThreads, Narrow<N>::kSmemBytes, st>>>(tx, tw, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns 0 or an error code for
// moe_gemm_error_string. kind: 0 float32 (CUDA cores), 1 bfloat16 wide,
// 2 bfloat16 narrow (C <= 64). x [E, C, d], w [E, d, f] and out [E, C, f]
// contiguous, E >= 1, C >= 1, d and f positive multiples of 8; for
// bfloat16 the pointers are 16-byte aligned (TMA).
int moe_gemm_launch(const void* x, const void* w, void* o, int kind, int E,
                    int C, int d, int f, void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (E < 1 || C < 1 || d < 8 || f < 8 || d % 8 || f % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) return launch_f32(x, w, o, nullptr, E, C, d, f, st);
  const Dims p = {o, E, C, d, f};
  if (kind == 1) return launch_wide<false>(x, w, p, nullptr, st);
  if (C <= 8) return launch_narrow<8>(x, w, p, st);
  if (C <= 16) return launch_narrow<16>(x, w, p, st);
  if (C <= 32) return launch_narrow<32>(x, w, p, st);
  if (C <= 64) return launch_narrow<64>(x, w, p, st);
  return (int)cudaErrorInvalidValue;
}

// The routed product: x [R, d] holds expert e's rows from row tiles[e] *
// 128 to tiles[e + 1] * 128, w [E, d, f], out [R, f]; `tiles` is a device
// array of E + 1 int32, 0 first, non-decreasing, tiles[E] * 128 <= R (rows
// of out past it are not stored). kind: 0 float32, 1 bfloat16 wide.
// E >= 1, R >= 1, d and f positive multiples of 8, pointers as above.
int moe_gemm_routed_launch(const void* x, const void* w, void* o,
                           const void* tiles, int kind, int E, int R, int d,
                           int f, void* stream) {
  if (kind < 0 || kind > 1 || tiles == nullptr)
    return (int)cudaErrorInvalidValue;
  if (E < 1 || R < 1 || d < 8 || f < 8 || d % 8 || f % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tiles);
  if (kind == 0) return launch_f32(x, w, o, t, E, R, d, f, st);
  const Dims p = {o, E, R, d, f};
  return launch_wide<true>(x, w, p, t, st);
}

const char* moe_gemm_error_string(int err) {
  if (err == kErrNoEncoder)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (err == kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
