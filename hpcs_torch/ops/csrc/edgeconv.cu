// Kernel B2: one eval-mode VN EdgeConv stage, mean-pooled over neighbours.
//
// Replaces hpcs_tpu/ops/pallas/edgeconv_pallas.py::_edgeconv_gather_kernel.
// For each point i and each neighbour j = idx[i, kk] it forms the edge
// feature e = [x_j - x_i || x_i] (C vector channels each), applies
// VNLinearLeakyReLU with BatchNorm folded to a per-channel affine (a, b),
// optionally a second VNLinearLeakyReLU on the result, and writes only the
// mean over the K edges, [B, N, 21, 3].  The edge tensor never reaches
// device memory.
//
// Unlike the TPU kernel, which had to select neighbours with a one-hot
// matmul, this one loads each neighbour's row directly by index.  The
// weights split into the difference half W[:, :C] and the centre half
// W[:, C:]; the centre half's product is computed once per point.
//
// What bounds it on an H100: fp32 operations against 67 TFLOP/s.  The least
// work per edge is conv2's 2 (21 21 3 2) operations and the two gates: conv1
// is linear, W1 e = Wa x_j + (Wb - Wa) x_i, so both its products can be made
// once per point (2.4 GFLOP in all at B=16, N=1024, K=20, C=21).  This
// kernel still forms the difference half per edge, 2 (C 21 3 2) operations
// more.  The bytes it must move (the cloud, the indices, the output) take a
// few microseconds at 3.35 TB/s, and the repeated neighbour reads hit the
// 50 MB L2.
//
// Design: one warp per point, lane o < 21 owns output channel o and keeps
// its rows of the four weight matrices in registers.  For each edge the warp
// loads the neighbour row cooperatively, stores the difference in shared
// memory as float4 per channel, and every lane reads it back by broadcast.
// The gate of channel o needs only p[o] and d[o], so it runs per lane; the
// second conv reads the 21 gated vectors back through shared memory.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int COUT = 21;
constexpr int WARPS = 8;
constexpr float EPS = 1e-6f;
constexpr float SLOPE = 0.2f;

// Folded BatchNorm on the vector norm, then the direction-gated leaky ReLU
// (hpcs_tpu/ops/pallas/edgeconv_pallas.py::_gate).
__device__ __forceinline__ void gate(float p[3], const float d[3], float a, float b, float h[3]) {
  const float norm = sqrtf(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + EPS * EPS) + EPS;
  const float aff = (a * norm + b) / norm;
#pragma unroll
  for (int v = 0; v < 3; ++v) p[v] *= aff;
  const float dot = p[0] * d[0] + p[1] * d[1] + p[2] * d[2];
  const float dsq = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float coeff = dot < 0.f ? dot / (dsq + EPS) : 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v) h[v] = SLOPE * p[v] + (1.f - SLOPE) * (p[v] - coeff * d[v]);
}

template <int C, int NCONV>
__global__ void __launch_bounds__(WARPS * 32)
edgeconv_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                const float* __restrict__ w1, const float* __restrict__ wd1,
                const float* __restrict__ ab1, const float* __restrict__ w2,
                const float* __restrict__ wd2, const float* __restrict__ ab2,
                float* __restrict__ out, int points, int n, int k) {
  constexpr int CV = C * 3;
  __shared__ float4 s_diff[WARPS][C];
  __shared__ float4 s_h[WARPS][COUT];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int point = blockIdx.x * WARPS + warp;  // b * n + i
  if (point >= points) return;  // the whole warp leaves together
  const bool active = lane < COUT;
  const int o = active ? lane : 0;  // idle lanes shadow channel 0 and store nothing

  float wa[C], wda[C], pc[3] = {0.f, 0.f, 0.f}, dc[3] = {0.f, 0.f, 0.f};
  const float* xi = x + (size_t)point * CV;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wa[c] = w1[o * 2 * C + c];
    wda[c] = wd1[o * 2 * C + c];
    const float wb = w1[o * 2 * C + C + c], wdb = wd1[o * 2 * C + C + c];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      pc[v] = fmaf(wb, xi[c * 3 + v], pc[v]);
      dc[v] = fmaf(wdb, xi[c * 3 + v], dc[v]);
    }
  }
  const float a1 = ab1[o], b1 = ab1[COUT + o];
  float w2r[NCONV == 2 ? COUT : 1], wd2r[NCONV == 2 ? COUT : 1], a2 = 0.f, b2 = 0.f;
  if constexpr (NCONV == 2) {
#pragma unroll
    for (int c = 0; c < COUT; ++c) {
      w2r[c] = w2[o * COUT + c];
      wd2r[c] = wd2[o * COUT + c];
    }
    a2 = ab2[o];
    b2 = ab2[COUT + o];
  }
  // this lane's share of the centre row, for the differences
  const float cen0 = lane < CV ? xi[lane] : 0.f;
  const float cen1 = lane + 32 < CV ? xi[lane + 32] : 0.f;

  float* diff = reinterpret_cast<float*>(s_diff[warp]);
  float acc[3] = {0.f, 0.f, 0.f};
  const int* nbr = idx + (size_t)point * k;
  const float* xb = x + (size_t)(point / n) * n * CV;
  for (int kk = 0; kk < k; ++kk) {
    const int j = nbr[kk];
    if (j < 0 || j >= n) {  // not an index of this cloud: the point's output is NaN
      acc[0] = acc[1] = acc[2] = NAN;
      break;
    }
    const float* xj = xb + (size_t)j * CV;
    if (lane < CV) diff[(lane / 3) * 4 + lane % 3] = xj[lane] - cen0;
    if (lane + 32 < CV) diff[((lane + 32) / 3) * 4 + (lane + 32) % 3] = xj[lane + 32] - cen1;
    __syncwarp();
    float p[3] = {pc[0], pc[1], pc[2]}, d[3] = {dc[0], dc[1], dc[2]}, h[3];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float4 t = s_diff[warp][c];
      p[0] = fmaf(wa[c], t.x, p[0]);
      p[1] = fmaf(wa[c], t.y, p[1]);
      p[2] = fmaf(wa[c], t.z, p[2]);
      d[0] = fmaf(wda[c], t.x, d[0]);
      d[1] = fmaf(wda[c], t.y, d[1]);
      d[2] = fmaf(wda[c], t.z, d[2]);
    }
    gate(p, d, a1, b1, h);
    if constexpr (NCONV == 2) {
      if (active) s_h[warp][o] = make_float4(h[0], h[1], h[2], 0.f);
      __syncwarp();
      float p2[3] = {0.f, 0.f, 0.f}, d2[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < COUT; ++c) {
        const float4 t = s_h[warp][c];
        p2[0] = fmaf(w2r[c], t.x, p2[0]);
        p2[1] = fmaf(w2r[c], t.y, p2[1]);
        p2[2] = fmaf(w2r[c], t.z, p2[2]);
        d2[0] = fmaf(wd2r[c], t.x, d2[0]);
        d2[1] = fmaf(wd2r[c], t.y, d2[1]);
        d2[2] = fmaf(wd2r[c], t.z, d2[2]);
      }
      gate(p2, d2, a2, b2, h);
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) acc[v] += h[v];
    __syncwarp();  // shared memory is read before the next edge overwrites it
  }
  if (active) {
    const float inv_k = 1.f / k;
    float* o_ptr = out + ((size_t)point * COUT + o) * 3;
#pragma unroll
    for (int v = 0; v < 3; ++v) o_ptr[v] = acc[v] * inv_k;
  }
}

template <int C, int NCONV>
cudaError_t launch(const float* x, const int* idx, const float* w1, const float* wd1,
                   const float* ab1, const float* w2, const float* wd2, const float* ab2,
                   float* out, int points, int n, int k, cudaStream_t stream) {
  const int blocks = (points + WARPS - 1) / WARPS;
  edgeconv_kernel<C, NCONV><<<blocks, WARPS * 32, 0, stream>>>(
      x, idx, w1, wd1, ab1, w2, wd2, ab2, out, points, n, k);
  return cudaGetLastError();
}

}  // namespace

// x [b, n, c, 3], idx [b, n, k] int32, w1/wd1 [21, 2c], ab1 [2, 21] (folded
// BatchNorm scale and shift), w2/wd2 [21, 21] and ab2 [2, 21] (unused when
// n_convs == 1), out [b, n, 21, 3]; all contiguous fp32 on the device.
// Returns the cudaError_t of the launch.
extern "C" int hpcs_edgeconv(const float* x, const int* idx, const float* w1, const float* wd1,
                             const float* ab1, const float* w2, const float* wd2,
                             const float* ab2, float* out, int b, int n, int c, int k,
                             int n_convs, void* stream) {
  if (b < 1 || n < 1 || k < 1 || (long long)b * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int points = b * n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 1 && n_convs == 1) return (int)launch<1, 1>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, points, n, k, s);
  if (c == 1 && n_convs == 2) return (int)launch<1, 2>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, points, n, k, s);
  if (c == 21 && n_convs == 1) return (int)launch<21, 1>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, points, n, k, s);
  if (c == 21 && n_convs == 2) return (int)launch<21, 2>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, points, n, k, s);
  return (int)cudaErrorInvalidValue;
}
