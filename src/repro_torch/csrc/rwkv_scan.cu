// RWKV6 WKV scan (data-dependent-decay linear attention), token-serial.
//
// Replaces the Pallas kernel
//   src/repro/kernels/rwkv_scan.py::rwkv_scan (_rwkv_kernel):
//   per (batch, head) stream, from a zero state S (dh x dh, key-major),
//     out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
//     S_t   = diag(w_t) S_{t-1} + k_t v_t^T
//   over r, k, v, w [B, S, H, dh] and u [H, dh], all float32; out is
//   float32 [B, S, H, dh] and, when asked, the final state float32
//   [B, H, dh, dh] (row i = key channel, column j = value channel), as
//   src/repro/models/ssm.py::rwkv_recurrence returns it.
//
// Contract: equal to the plain PyTorch version
// (repro_torch.kernels.rwkv_scan.rwkv_scan_plain) up to float32 summation
// order and fused multiply-adds. Unlike the TPU kernel, which works on
// chunks and divides by the chunk's cumulative decay (k / a, relying on
// float32 headroom), this kernel runs the recurrence of
// ref.rwkv_scan_ref step by step, so it divides by nothing and takes any
// S >= 1.
//
// What bounds it on an H100: bytes, at the model's prefill shape (B 4,
// S 2048, H 32, dh 64): 4 inputs and 1 output of 16.8 M float32 values and
// the 2 MB final state, 0.338 GB, against about 6 dh^2 operations per token
// and stream, 6.4 GFLOP. The token loop is serial, so the design is held
// back by latency long before either bound.
//
// Design. One block per (b, h) stream (B * H blocks, 128 at the model's
// shape) of dh threads; thread j holds column j of the state in registers
// (dh floats). The block stages r, k, v and w of kT steps at a time in
// shared memory, two buffers deep: while it computes one chunk, the loads
// of the next are in flight in registers, so one barrier per chunk
// suffices. At step t thread j reads r_t, k_t, w_t and u broadcast from
// shared memory, computes out_tj = sum_i r_ti (S_ij + u_i k_ti v_tj) over
// four partial sums (so the adds are not one dependent chain) and updates
// S_ij <- w_ti S_ij + k_ti v_tj. The inputs are read through their strides
// ([B, S, H, dh] with dh contiguous), without a transpose.
//
// Left for later: the chunked form on the tensor cores, bfloat16 inputs
// read directly, and more than one block per stream (the columns are
// independent).

#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;  // steps staged per chunk

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // [H, dh], contiguous
  float* out;       // [B, S, H, dh], contiguous
  float* state;     // [B, H, dh, dh], contiguous, or null
  long long r_sb, r_ss, r_sh;  // strides in elements; dh is contiguous
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  int S, H;
};

// element j (the pointers' offset) of steps t0 .. t0 + kT - 1; zeros past S
__device__ __forceinline__ void load_chunk(const Params& p, const float* r,
                                           const float* k, const float* v,
                                           const float* w, int t0,
                                           float (&pr)[kT], float (&pk)[kT],
                                           float (&pv)[kT], float (&pw)[kT]) {
#pragma unroll
  for (int tt = 0; tt < kT; ++tt) {
    const int t = t0 + tt;
    const bool in = t < p.S;
    pr[tt] = in ? r[t * p.r_ss] : 0.f;
    pk[tt] = in ? k[t * p.k_ss] : 0.f;
    pv[tt] = in ? v[t * p.v_ss] : 0.f;
    pw[tt] = in ? w[t * p.w_ss] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(DH) rwkv_scan_kernel(const Params p) {
  __shared__ __align__(16) float sr[2][kT][DH];
  __shared__ __align__(16) float sk[2][kT][DH];
  __shared__ __align__(16) float sv[2][kT][DH];
  __shared__ __align__(16) float sw[2][kT][DH];
  __shared__ __align__(16) float su[DH];

  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int j = threadIdx.x;
  const float* r = p.r + b * p.r_sb + h * p.r_sh + j;
  const float* k = p.k + b * p.k_sb + h * p.k_sh + j;
  const float* v = p.v + b * p.v_sb + h * p.v_sh + j;
  const float* w = p.w + b * p.w_sb + h * p.w_sh + j;
  const long long o_ss = (long long)p.H * DH;
  float* out = p.out + (long long)b * p.S * o_ss + h * DH + j;
  su[j] = p.u[h * DH + j];

  // element j of the chunk's kT steps, loaded ahead into registers
  float pr[kT], pk[kT], pv[kT], pw[kT];
  float s[DH];  // column j of the state: s[i] = S_ij
#pragma unroll
  for (int i = 0; i < DH; ++i) s[i] = 0.f;

  load_chunk(p, r, k, v, w, 0, pr, pk, pv, pw);
  for (int t0 = 0, buf = 0; t0 < p.S; t0 += kT, buf ^= 1) {
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      sr[buf][tt][j] = pr[tt];
      sk[buf][tt][j] = pk[tt];
      sv[buf][tt][j] = pv[tt];
      sw[buf][tt][j] = pw[tt];
    }
    // the chunk before the last used the other buffer, and every thread
    // has passed this barrier only after computing it
    __syncthreads();
    if (t0 + kT < p.S) load_chunk(p, r, k, v, w, t0 + kT, pr, pk, pv, pw);

    const float4* u4 = reinterpret_cast<const float4*>(su);
#pragma unroll
    for (int tt = 0; tt < kT; ++tt) {
      if (t0 + tt >= p.S) continue;  // the same for every thread
      const float4* r4 = reinterpret_cast<const float4*>(sr[buf][tt]);
      const float4* k4 = reinterpret_cast<const float4*>(sk[buf][tt]);
      const float4* w4 = reinterpret_cast<const float4*>(sw[buf][tt]);
      const float vj = sv[buf][tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < DH / 4; ++q) {
        const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
        const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
        const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
        const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
        const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e;
          const float kv = kk[e] * vj;
          acc[e] += rr[e] * (s[i] + uu[e] * kv);
          s[i] = ww[e] * s[i] + kv;
        }
      }
      out[(t0 + tt) * o_ss] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  if (p.state != nullptr) {
    float* st = p.state + ((long long)b * p.H + h) * DH * DH + j;
#pragma unroll
    for (int i = 0; i < DH; ++i) st[i * DH] = s[i];
  }
}

template <int DH>
int launch(const Params& p, int B, cudaStream_t stream) {
  rwkv_scan_kernel<DH><<<B * p.H, DH, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Enqueues one kernel on `stream` and returns cudaGetLastError().
// r, k, v, w: float32 [B, S, H, dh] with dh contiguous, strides in
// elements; u: float32 [H, dh] contiguous; out: float32 [B, S, H, dh]
// contiguous; state: float32 [B, H, dh, dh] contiguous, or null for no
// final state. dh in {16, 32, 64}; S >= 1.
int rwkv_scan_launch(const float* r, const float* k, const float* v,
                     const float* w, const float* u, float* out, float* state,
                     int B, int S, int H, int dh, long long r_sb,
                     long long r_ss, long long r_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb,
                     long long v_ss, long long v_sh, long long w_sb,
                     long long w_ss, long long w_sh, void* stream) {
  if (B < 1 || S < 1 || H < 1) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r;
  p.k = k;
  p.v = v;
  p.w = w;
  p.u = u;
  p.out = out;
  p.state = state;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  p.S = S;
  p.H = H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16: return launch<16>(p, B, st);
    case 32: return launch<32>(p, B, st);
    case 64: return launch<64>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* rwkv_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
