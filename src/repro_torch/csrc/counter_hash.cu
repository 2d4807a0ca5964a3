// Counter-hash synthesis kernels for the FedZero scheduling hot path.
//
// piece_window_kernel replaces the Pallas kernel
//   src/repro/kernels/counter_hash.py::piece_window (_piece_window_kernel):
//   the [R, W] sparse-utilisation window of a gather -- per-row level
//   gather levels[r, slot[r, t]], cheap-mixer cell noise keyed
//   ((row << 24) ^ (t0 + col)) ^ fold, centred as (u - 1/2) * amp, added,
//   clipped to [0, 1].
// forecast_z_kernel replaces the Pallas kernel
//   src/repro/kernels/counter_hash.py::forecast_z (_forecast_z_kernel):
//   the [R, W] forecast-error exponent before exp -- splitmix64 row premix
//   sm64(row ^ fold), key row_h ^ ((now << 20) + 1 + col), cheap mixer,
//   ((u - 1/2) * f32(sqrt 12)) * std[col].
//
// Contract: every output bit equals the NumPy reference
// (repro_torch.backend.base.ArrayBackend.synth_window / forecast_noise_z).
// The hashing is native 64-bit unsigned arithmetic, which wraps exactly as
// numpy's uint64 does. Every float32 product and sum is rounded on its own
// with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into
// an FMA; the file must not be built with --use_fast_math.
//
// What bounds them on an H100: device-memory bytes. piece_window moves about
// 4 + 8 + 4 bytes per cell (levels gather, int64 slot, float32 out) plus its
// levels row; forecast_z about 4 bytes per cell (its output) plus 8 bytes per
// row and 4 per lead. The hashing costs issued instructions that the byte
// bound does not count: forecast_z's mixer is two 64-bit multiplies per cell.
//
// piece_window: one thread per output cell, a grid-stride loop over the
// row-major [R, W] grid with 64-bit offsets, so neighbouring threads read
// neighbouring slot entries and write neighbouring outputs; the ragged
// edge is masked by the loop bound, nothing is padded.
//
// forecast_z is row-tiled and division-free. Each block owns a tile of
// whole rows (a multiple of 4 rows, about 4096 cells), which is one
// contiguous, 16-byte aligned span of the row-major output. The block
// computes the row premix sm64(row ^ fold) once per row into shared memory.
// Each thread owns groups of 4 consecutive cells, 1024 cells apart; it
// finds (row, col) of its first group with one division per thread and
// then walks: col + 1 per cell, and 1024 cells = (1024 / W rows, 1024 % W
// cols) per group, carrying into the row when col reaches W. The 24-bit
// mixer output converts through a 32-bit conversion (exact below 2^24).
// A group is written with one 16-byte streaming store (__stcs); staging
// the tile in shared memory for one bulk asynchronous copy measured no
// faster (PERF.md). A tile whose cell count is not a multiple of 4 (only
// the last, when R * W is not) writes its last cells one by one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// f32(sqrt(12)) exactly, i.e. np.float32(np.sqrt(12.0))
constexpr float kSqrt12 = 0x1.bb67aep+1f;

__device__ __forceinline__ unsigned long long sm64(unsigned long long x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

// two-round multiply-xorshift mixer -> float32 uniform in [0, 1); the top
// 24 bits convert exactly and the power-of-two scale is exact
__device__ __forceinline__ float cheap_u01(unsigned long long h) {
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 32;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 29;
  return __fmul_rn(__ull2float_rn(h >> 40), 0x1p-24f);
}

// cheap_u01 with the 24-bit value converted through 32 bits (exact: it is
// below 2^24), as forecast_z uses it
__device__ __forceinline__ float cheap_u01_24(unsigned long long h) {
  h *= 0xFF51AFD7ED558CCDull;
  h ^= h >> 32;
  h *= 0xC4CEB9FE1A85EC53ull;
  h ^= h >> 29;
  return __fmul_rn(__uint2float_rn((unsigned)(h >> 40)), 0x1p-24f);
}

__global__ void piece_window_kernel(const float* __restrict__ levels,
                                    const long long* __restrict__ slot,
                                    const unsigned long long* __restrict__ rows,
                                    float* __restrict__ out, long long R,
                                    long long S, long long W,
                                    unsigned long long fold, long long t0,
                                    float amp) {
  const long long n = R * W;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = i / W;
    const long long c = i - r * W;
    const float level = levels[r * S + slot[i]];
    const unsigned long long key =
        (rows[r] << 24) ^ (unsigned long long)(t0 + c);
    const float u = cheap_u01(key ^ fold);
    const float noise = __fmul_rn(__fsub_rn(u, 0.5f), amp);
    float v = __fadd_rn(level, noise);
    // np.clip(v, 0, 1): max then min, as numpy orders the comparisons
    v = v > 0.0f ? v : 0.0f;
    v = v < 1.0f ? v : 1.0f;
    out[i] = v;
  }
}

constexpr int kTileCells = 4096;  // target cells per forecast_z tile

__device__ __forceinline__ float forecast_cell(unsigned long long row_h,
                                               unsigned long long now_key,
                                               int c, unsigned long long fold,
                                               const float* std_lead) {
  const unsigned long long key =
      row_h ^ (now_key + (unsigned long long)(c + 1));
  const float u = cheap_u01_24(key ^ fold);
  const float t = __fmul_rn(__fsub_rn(u, 0.5f), kSqrt12);
  return __fmul_rn(t, __ldg(std_lead + c));
}

// one block per tile of `tile_rows` rows; dynamic shared memory holds the
// tile's row premixes
__global__ void __launch_bounds__(kThreads) forecast_z_kernel(
    const unsigned long long* __restrict__ rows,
    const float* __restrict__ std_lead, float* __restrict__ out, long long R,
    int W, int tile_rows, unsigned long long fold, unsigned long long now) {
  extern __shared__ __align__(16) unsigned long long row_h[];
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int n_rows = (int)min((long long)tile_rows, R - r0);
  for (int i = threadIdx.x; i < n_rows; i += kThreads)
    row_h[i] = sm64(rows[r0 + i] ^ fold);
  __syncthreads();

  const unsigned long long now_key = now << 20;
  const int n_cells = n_rows * W;
  const int n_groups = n_cells >> 2;
  float* tile = out + r0 * W;
  float4* dst = reinterpret_cast<float4*>(tile);
  // (row, col) of this thread's first group, and the step of one group
  // stride; the only divisions of the walk
  const int first = 4 * threadIdx.x;
  int r = first / W, c = first - r * W;
  const int dr = 4 * kThreads / W, dc = 4 * kThreads - dr * W;
  for (int g = threadIdx.x; g < n_groups; g += kThreads) {
    float z[4];
    int rr = r, cc = c;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      z[e] = forecast_cell(row_h[rr], now_key, cc, fold, std_lead);
      if (++cc == W) {
        cc = 0;
        ++rr;
      }
    }
    __stcs(dst + g, make_float4(z[0], z[1], z[2], z[3]));
    r += dr;
    c += dc;
    if (c >= W) {
      c -= W;
      ++r;
    }
  }
  // the last n_cells % 4 cells (only when R * W is not a multiple of 4)
  const int i = 4 * n_groups + threadIdx.x;
  if (i < n_cells) {
    const int ri = i / W;
    tile[i] = forecast_cell(row_h[ri], now_key, i - ri * W, fold, std_lead);
  }
}

unsigned int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  // the grid-stride loop covers whatever a capped grid leaves
  return (unsigned int)(blocks < 1048576 ? blocks : 1048576);
}

}  // namespace

extern "C" {

// Each launcher enqueues one kernel on `stream` and returns
// cudaGetLastError(); n == R * W must be positive.
int piece_window_launch(const void* levels, const void* slot, const void* rows,
                        void* out, long long R, long long S, long long W,
                        unsigned long long fold, long long t0, float amp,
                        void* stream) {
  piece_window_kernel<<<grid_for(R * W), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(levels), static_cast<const long long*>(slot),
      static_cast<const unsigned long long*>(rows), static_cast<float*>(out),
      R, S, W, fold, t0, amp);
  return (int)cudaGetLastError();
}

int forecast_z_launch(const void* rows, const void* std_lead, void* out,
                      long long R, long long W, unsigned long long fold,
                      unsigned long long now, void* stream) {
  // whole rows, a multiple of 4 (so every tile starts 16-byte aligned),
  // about kTileCells cells
  long long tile_rows = (kTileCells / W) & ~3LL;
  if (tile_rows < 4) tile_rows = 4;
  if (W > (1 << 24) || tile_rows * W > (1 << 26))
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (R + tile_rows - 1) / tile_rows;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_rows * sizeof(unsigned long long);
  forecast_z_kernel<<<(unsigned int)n_tiles, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(rows),
      static_cast<const float*>(std_lead), static_cast<float*>(out), R,
      (int)W, (int)tile_rows, fold, now);
  return (int)cudaGetLastError();
}

const char* counter_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
