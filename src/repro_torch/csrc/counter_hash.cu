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
// row and 4 per lead. The four or five 64-bit multiplies per cell are far
// below the card's integer rate.
//
// Design: one thread per output cell, a grid-stride loop over the
// row-major [R, W] grid with 64-bit offsets, so neighbouring threads read
// neighbouring slot entries and write neighbouring outputs; the ragged
// edge is masked by the loop bound, nothing is padded. This first version
// is simple and right, not tuned: the per-cell 64-bit division that splits
// a flat index into (row, col), and forecast_z recomputing the row premix
// in every cell of the row, are left for a later change.

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

__global__ void forecast_z_kernel(const unsigned long long* __restrict__ rows,
                                  const float* __restrict__ std_lead,
                                  float* __restrict__ out, long long R,
                                  long long W, unsigned long long fold,
                                  unsigned long long now) {
  const long long n = R * W;
  const long long step = (long long)gridDim.x * blockDim.x;
  const unsigned long long now_key = now << 20;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const long long r = i / W;
    const long long c = i - r * W;
    const unsigned long long row_h = sm64(rows[r] ^ fold);
    const unsigned long long key =
        row_h ^ (now_key + (unsigned long long)(c + 1));
    const float u = cheap_u01(key ^ fold);
    const float t = __fmul_rn(__fsub_rn(u, 0.5f), kSqrt12);
    out[i] = __fmul_rn(t, std_lead[c]);
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
  forecast_z_kernel<<<grid_for(R * W), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(rows),
      static_cast<const float*>(std_lead), static_cast<float*>(out), R, W,
      fold, now);
  return (int)cudaGetLastError();
}

const char* counter_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
