// Kernel B2: one eval-mode VN EdgeConv stage, mean-pooled over neighbours.
//
// Replaces hpcs_tpu/ops/pallas/edgeconv_pallas.py::_edgeconv_gather_kernel.
// For each point i and each neighbour j = idx[i, kk] it forms the edge
// feature e = [x_j - x_i || x_i] (C vector channels each), applies
// VNLinearLeakyReLU with BatchNorm folded to a per-channel affine (a, b),
// optionally a second VNLinearLeakyReLU on the result, and writes only the
// mean over the K edges, [B, N, 21, 3].  The edge tensor never reaches
// device memory.  Unlike the TPU kernel, which selected neighbours with a
// one-hot matmul, this one loads each neighbour's row directly by index.
//
// What bounds it on an H100: fp32 operations against 67 TFLOP/s.  Per edge
// the least work is conv2's 2 (21 21 3 2) FMA operations and the two gates;
// the bytes that must move (the cloud, the indices, the output) take a few
// microseconds at 3.35 TB/s.  As built, the two-conv stages are bound by
// instruction issue (conv2's FFMAs, the uniform loads that feed them their
// weights, and the gates' IEEE square roots and divisions), and the
// one-conv stage by the gather from L2.
//
// Design:
// - conv1 is linear, W1 e = Wa (x_j - x_i) + Wb x_i.  For C = 21,
//   project_kernel makes U = Wa x, Ud = Wda x (the difference halves) and
//   Pc = Wb x, Dc = Wdb x (the centre halves) once per point, into a
//   workspace that stays in the 50 MB L2; an edge then gathers only
//   (U_j, Ud_j) and forms p = (U_j - U_i) + Pc_i, d = (Ud_j - Ud_i) + Dc_i.
//   On the self-edge U_j - U_i is exactly 0, so p = Wb x_i exactly, as in
//   the plain twin.  conv1 runs one thread per (point, channel), which
//   loads its centre terms once and gathers 24 bytes per edge; a warp's
//   loads cover whole rows.  For C = 1 conv1 is 4 FMAs per channel from the
//   3-float neighbour row, cheaper than any gather, and runs per edge.
// - conv2 runs one thread per edge: a block holds P whole points and KC of
//   each one's edges per round (all K when K <= 32), chosen so P KC fills
//   whole warps where shared memory allows.  Every vector component of a
//   gate sits in the thread's registers.  conv1's 21 gated channels wait in
//   the edge's row of shared memory; conv2 reads them back one at a time and
//   accumulates straight into its outputs' p and d.  All 21 outputs at once
//   (126 accumulators) took 255 registers and left one 5-warp block per SM,
//   so the thread makes them in two halves, one after the other (two
//   threads per edge, one per half, ran 2.3 times slower on an H100).
// - Every thread of a warp uses the same conv2 weight at the same time, so
//   W2 and Wd2 live in __constant__ memory and reach the FFMAs through the
//   constant cache with no load from shared or global memory.  The gates'
//   (a, b) and stage 1's W1 are read from shared memory.
// - The mean over K is a sum in edge order: through shared memory after
//   conv2, in the (point, channel) thread's registers in the one-conv stage.
//
// A range of centre rows (the point-sharded forward's rows): the edges and
// the output cover the range's centres only, the projection the whole
// table, whose rows the neighbours are; each point's arithmetic is the
// whole launch's, so the range's output is the whole launch's rows bit for
// bit.
//
// bf16 features (VN-DGCNN's bf16 configuration): x and the output are bf16;
// inside, the stage is fp32 as in the TPU kernel (it upcasts bf16 at its
// entry): x converted as it is loaded, the C = 21 workspace fp32, each
// pooled output rounded to bf16 once as it is stored.  The channel mixes
// W1, Wd1, W2, Wd2 are rounded to bf16 (the JAX package's mixes cast their
// weights to bf16) by the kernels as they load them, from the same fp32
// tensors the fp32 route takes, so no launch casts them; the folded
// BatchNorm stays fp32.  The one-conv stages run the fp32 route's kernels
// on T = bf16.  The two-conv stages (C = 1 and C = 21) run edge_tc_kernel:
//
// - conv2 on the bf16 tensor cores, exactly.  On this route W2 and Wd2 are
//   bf16, so each product W2[o][c] h[c] is exact in fp32 when h is bf16 too.
//   The edge splits conv1's fp32 output h into three bf16 limbs,
//   h0 = bf16(h), h1 = bf16(h - h0), h2 = bf16(h - h0 - h1): each
//   difference is exact in fp32, and h0 + h1 + h2 == h for every finite h
//   of magnitude 2^-110 or more (24 significand bits in three pieces of 8;
//   below that a limb falls under bf16's smallest subnormal, 2^-133, and
//   the split loses less than 2^-133).  conv2 is then the product
//   [48 rows x 32] [32 x 24] per 8 edges and limb: A holds W2 and Wd2
//   (rows 16 i .. 16 i + 7: p's channels 8 i .. 8 i + 7; rows 16 i + 8 ..:
//   d's same channels; zero past channel 20 and input 20), B the limb of
//   the 8 edges' three components (one n8 tile each), accumulated in fp32
//   by mma.sync.m16n8k16: 3 M-tiles x 3 N-tiles x 2 K-steps x 3 limbs = 54
//   HMMA per 8 edges, limb 2 first.  With that layout each lane's
//   accumulators hold p and d of the same channel (8 i + its group), for
//   the same two edges, in all three components: the gate runs in the
//   lane's registers, with no shuffle and no pass through shared memory.
//   wgmma (m64, B from shared memory) was the alternative: its accumulator
//   puts rows 0-15 and 32-47 in different warps, so p and d would meet
//   only through shared memory, and at 54 HMMA against ~450 other
//   instructions a lane per 8 edges the MMA pipe is not what bounds the
//   kernel, so wgmma's higher peak would buy nothing.  The first warp packs
//   the lanes' A fragments into shared memory once a block, rounding the
//   fp32 weights as it packs them; there is no __constant__ copy and no
//   cross-stream event on this route.
// - conv1 runs one thread per (point, channel) for both C: for C = 21 the
//   fp32 projection as on the fp32 route, for C = 1 the 4 FMAs a channel
//   from the neighbour's 3 coordinates, into the edge's row of shared
//   memory ([component][24 channels], 21..23 zero, rows of 72 floats so a
//   warp's 8-byte loads of 8 edges' rows hit distinct banks).
// - The gates use the SFU's reciprocal square root and reciprocal
//   (rsqrtf, __fdividef) in place of IEEE sqrt and division: a few fp32
//   ulps, under the output's one bf16 rounding.  The fp32 route keeps IEEE.
// - The mean over K is the fp32 route's: a sum in edge order through
//   shared memory, carried across rounds of 32 edges.
// - What bounds it: conv2's products at the tensor cores' rate (989
//   TFLOP/s dense bf16, three limb products each) take less time than the
//   adds, the gates and the mean at 67 TFLOP/s; as built, instruction issue
//   (the limb split, the gates, conv1's gather).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <mutex>
#include <type_traits>

namespace {

constexpr int COUT = 21;
constexpr int CV = COUT * 3;         // floats of one output row
constexpr int ROW = 128;             // floats per point in each workspace array (126 used)
constexpr int MAX_THREADS = 256;     // threads of an edge block (2 such blocks: <= 128 registers)
constexpr int MAX_EDGES = 32;        // edges of one point in one round
constexpr int SMEM_LIMIT = 48 * 1024;
constexpr int PROJECT_POINTS = 12;   // points per projection block, 21 threads each
constexpr int MEAN_THREADS = 256;
constexpr float EPS = 1e-6f;
constexpr float SLOPE = 0.2f;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// A channel mix's weight as the route computes with it: as it is on the
// fp32 route, rounded to bf16 on the bf16 route.
template <typename T> __device__ __forceinline__ float mix_weight(float w) {
  return std::is_same<T, float>::value ? w : __bfloat162float(__float2bfloat16_rn(w));
}

// Shared parameters of an edge block: ab1, ab2 [2][21] and, for C = 1,
// W1 and Wd1 [21][2] ([o][difference, centre]).
constexpr int PAR_AB1 = 0, PAR_AB2 = 2 * COUT, PAR_W1 = 4 * COUT, PAR_WD1 = 6 * COUT;
__host__ __device__ constexpr int par_floats(int c) { return c == 1 ? 8 * COUT : 4 * COUT; }

// conv2's weights, [out][in] as in torch's Linear: one slot for each stage
// shape with two convs (C = 1 and C = 21), so that the stages of one
// forward do not share a slot.
struct Conv2Weights {
  float w2[COUT * COUT], wd2[COUT * COUT];
};
__constant__ Conv2Weights c_conv2[2];

__host__ __device__ constexpr int slot_of(int c) { return c == 21 ? 1 : 0; }

// a . b of two 3-vectors.  The gate's arithmetic is spelled out with
// intrinsics so that no kernel's context changes how nvcc contracts it into
// FMAs: the stage-1 outputs near the ill-conditioned threshold move by
// about 1e-5 between two such contractions.
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return fmaf(a[2], b[2], fmaf(a[0], b[0], __fmul_rn(a[1], b[1])));
}

// Folded BatchNorm on the vector norm, then the direction-gated leaky ReLU
// (hpcs_tpu/ops/pallas/edgeconv_pallas.py::_gate), IEEE sqrt and division.
__device__ __forceinline__ void gate(float p[3], const float d[3], float a, float b, float h[3]) {
  const float norm = __fadd_rn(sqrtf(__fadd_rn(dot3(p, p), EPS * EPS)), EPS);
  const float aff = fmaf(a, norm, b) / norm;
#pragma unroll
  for (int v = 0; v < 3; ++v) p[v] = __fmul_rn(p[v], aff);
  const float dot = dot3(p, d);
  const float coeff = dot < 0.f ? dot / __fadd_rn(dot3(d, d), EPS) : 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v)
    h[v] = fmaf(p[v], SLOPE, __fmul_rn(1.f - SLOPE, fmaf(d[v], -coeff, p[v])));
}

// The same gate with the SFU's reciprocal square root and reciprocal (the
// bf16 route's two-conv kernel): sqrt(s) = s rsqrt(s), x / y = x rcp(y).
__device__ __forceinline__ void gate_fast(float p[3], const float d[3], float a, float b,
                                          float h[3]) {
  const float s = __fadd_rn(dot3(p, p), EPS * EPS);
  const float norm = __fadd_rn(__fmul_rn(s, rsqrtf(s)), EPS);
  const float aff = __fdividef(fmaf(a, norm, b), norm);
#pragma unroll
  for (int v = 0; v < 3; ++v) p[v] = __fmul_rn(p[v], aff);
  const float dot = dot3(p, d);
  const float coeff = dot < 0.f ? __fdividef(dot, __fadd_rn(dot3(d, d), EPS)) : 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v)
    h[v] = fmaf(p[v], SLOPE, __fmul_rn(1.f - SLOPE, fmaf(d[v], -coeff, p[v])));
}

template <bool FAST>
__device__ __forceinline__ void gate_of(float p[3], const float d[3], float a, float b,
                                        float h[3]) {
  if constexpr (FAST)
    gate_fast(p, d, a, b, h);
  else
    gate(p, d, a, b, h);
}

// conv1's per-point products for C = 21: gath[point][6 o ..] = (U[o], Ud[o])
// and cen[point][6 o ..] = (Pc[o], Dc[o]), each a 3-vector, rows of ROW
// floats.  Thread (point, o) of the block; the block stages its points'
// rows, the weights (rows padded to 43 floats: 21 channels, 21 banks) and
// its output rows in shared memory, so both reads and writes are whole
// contiguous rows.
template <typename T>
__global__ void __launch_bounds__(PROJECT_POINTS * COUT)
project_kernel(const T* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ wd1, float* __restrict__ gath, float* __restrict__ cen,
               int points) {
  constexpr int C = 21, WROW = 2 * C + 1, THREADS = PROJECT_POINTS * COUT;
  __shared__ float s_w[2][COUT * WROW];
  __shared__ float s_x[PROJECT_POINTS * C * 3];
  __shared__ float4 s_out[2][PROJECT_POINTS * ROW / 4];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * PROJECT_POINTS;
  for (int f = tid; f < COUT * 2 * C; f += THREADS) {
    const int o = f / (2 * C), c = f - o * 2 * C;
    s_w[0][o * WROW + c] = mix_weight<T>(w1[f]);
    s_w[1][o * WROW + c] = mix_weight<T>(wd1[f]);
  }
  const int rows = min(PROJECT_POINTS, points - first);
  for (int f = tid; f < rows * C * 3; f += THREADS)
    s_x[f] = to_float(x[(size_t)first * C * 3 + f]);
  __syncthreads();
  const int pl = tid / COUT, o = tid - pl * COUT;
  if (pl < rows) {
    const float* xi = s_x + pl * C * 3;
    const float* wr = s_w[0] + o * WROW;
    const float* wdr = s_w[1] + o * WROW;
    float u[3] = {0.f, 0.f, 0.f}, ud[3] = {0.f, 0.f, 0.f};
    float pc[3] = {0.f, 0.f, 0.f}, dc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float wa = wr[c], wb = wr[C + c], wda = wdr[c], wdb = wdr[C + c];
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const float xv = xi[c * 3 + v];
        u[v] = fmaf(wa, xv, u[v]);
        pc[v] = fmaf(wb, xv, pc[v]);
        ud[v] = fmaf(wda, xv, ud[v]);
        dc[v] = fmaf(wdb, xv, dc[v]);
      }
    }
    float* g = reinterpret_cast<float*>(s_out[0]) + pl * ROW + o * 6;
    float* z = reinterpret_cast<float*>(s_out[1]) + pl * ROW + o * 6;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      g[v] = u[v];
      g[3 + v] = ud[v];
      z[v] = pc[v];
      z[3 + v] = dc[v];
    }
    if (o < ROW - CV * 2) {  // the rows' two unused floats
      reinterpret_cast<float*>(s_out[0])[pl * ROW + 2 * CV + o] = 0.f;
      reinterpret_cast<float*>(s_out[1])[pl * ROW + 2 * CV + o] = 0.f;
    }
  }
  __syncthreads();
  float4* g4 = reinterpret_cast<float4*>(gath + (size_t)first * ROW);
  float4* z4 = reinterpret_cast<float4*>(cen + (size_t)first * ROW);
  for (int f = tid; f < rows * ROW / 4; f += THREADS) {
    g4[f] = s_out[0][f];
    z4[f] = s_out[1][f];
  }
}

// conv1 of one edge for C = 1, gated, into h1: channel o is
// Wa (x_j - x_i) + Wb x_i from the centre xi and the difference diff, with
// W1 and Wd1 from the block's parameters.
__device__ __forceinline__ void conv1_c1(const float xi[3], const float diff[3], const float* par,
                                         float* h1) {
#pragma unroll
  for (int o = 0; o < COUT; ++o) {
    const float wa = par[PAR_W1 + o * 2], wb = par[PAR_W1 + o * 2 + 1];
    const float wda = par[PAR_WD1 + o * 2], wdb = par[PAR_WD1 + o * 2 + 1];
    float p[3], d[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      p[v] = fmaf(wa, diff[v], __fmul_rn(wb, xi[v]));
      d[v] = fmaf(wda, diff[v], __fmul_rn(wdb, xi[v]));
    }
    gate(p, d, par[PAR_AB1 + o], par[PAR_AB1 + COUT + o], h1 + o * 3);
  }
}

// 6 floats from an 8-byte-aligned address: a 3-vector pair of channel o.
__device__ __forceinline__ void load6(const float* src, float a[3], float b[3]) {
  const float2* s2 = reinterpret_cast<const float2*>(src);
  const float2 s0 = s2[0], s1 = s2[1], s3 = s2[2];
  a[0] = s0.x, a[1] = s0.y, a[2] = s1.x, b[0] = s1.y, b[1] = s3.x, b[2] = s3.y;
}

// A launch over a range of centre rows, [row_begin, row_begin + rows) of
// each n-point cloud of the table: its local point lp (the index of idx's
// and out's rows) is row row_begin + lp % rows of cloud lp / rows, whose
// first point in the table is cloud_of(lp).  rows = n and row_begin = 0
// make lp the table's point.
__device__ __forceinline__ size_t cloud_of(int lp, int n, int rows) {
  return (size_t)(lp / rows) * n;
}
__device__ __forceinline__ size_t centre_of(int lp, int n, int rows, int row_begin) {
  return cloud_of(lp, n, rows) + row_begin + lp % rows;
}

// conv1 for C = 21, one thread per (point, channel o): the centre terms
// (U_i, Ud_i from the point's gath row, Pc_i, Dc_i from its cen row) are
// loaded once; each edge gathers (U_j, Ud_j), 24 bytes, forms
// p = (U_j - U_i) + Pc_i and d = (Ud_j - Ud_i) + Dc_i and gates them.
struct Conv1Channel {
  float ui[3], udi[3], pc[3], dc[3], a, b;
  const float* gath;
  int o;
  // ab1: the folded BatchNorm [2][21] (the block's parameters or the tensor)
  __device__ __forceinline__ Conv1Channel(const float* gath_, const float* cen, size_t point,
                                          int o_, const float* ab1)
      : a(ab1[o_]), b(ab1[COUT + o_]), gath(gath_), o(o_) {
    load6(gath + point * ROW + o * 6, ui, udi);
    load6(cen + point * ROW + o * 6, pc, dc);
  }
  // the gated channel of the edge to point j (its index in the workspace)
  template <bool FAST = false>
  __device__ __forceinline__ void edge(size_t j, float h[3]) const {
    float uj[3], udj[3], p[3], d[3];
    load6(gath + j * ROW + o * 6, uj, udj);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      p[v] = (uj[v] - ui[v]) + pc[v];
      d[v] = (udj[v] - udi[v]) + dc[v];
    }
    gate_of<FAST>(p, d, a, b, h);
  }
};

// The one-conv stage for C = 21: thread (point, o) gates channel o of each
// of the point's K edges in order and keeps their sum in registers, so it
// needs no shared memory, no barrier and no second pass for the mean.
template <typename T>
__global__ void __launch_bounds__(MEAN_THREADS)
edge_mean_kernel(const int* __restrict__ idx, const float* __restrict__ gath,
                 const float* __restrict__ cen, const float* __restrict__ ab1,
                 T* __restrict__ out, int points, int n, int k, int rows, int row_begin) {
  __shared__ float par[2 * COUT];
  for (int f = threadIdx.x; f < 2 * COUT; f += MEAN_THREADS) par[PAR_AB1 + f] = ab1[f];
  __syncthreads();
  const long long t = (long long)blockIdx.x * MEAN_THREADS + threadIdx.x;
  if (t >= (long long)points * COUT) return;
  const int point = (int)(t / COUT), o = (int)(t % COUT);
  const Conv1Channel ch(gath, cen, centre_of(point, n, rows, row_begin), o, par + PAR_AB1);
  const int* nbr = idx + (size_t)point * k;
  const size_t cloud = cloud_of(point, n, rows);
  float acc[3] = {0.f, 0.f, 0.f};
  bool valid = true;
  // an index outside the cloud is read as 0 and makes the point's output
  // NaN; with no branch on it the loads of several edges can be in flight
#pragma unroll 4
  for (int kk = 0; kk < k; ++kk) {
    const int j = nbr[kk];
    valid = valid && j >= 0 && j < n;
    float h[3];
    ch.edge(cloud + (j >= 0 && j < n ? j : 0), h);
#pragma unroll
    for (int v = 0; v < 3; ++v) acc[v] += h[v];
  }
  if (!valid) acc[0] = acc[1] = acc[2] = NAN;
#pragma unroll
  for (int v = 0; v < 3; ++v)
    out[(size_t)point * CV + o * 3 + v] = from_float<T>(acc[v] * (1.f / k));
}

// conv2's outputs LO .. HI-1 of one edge, gated, into h2: conv1's gated
// channels h1 (this edge's row of shared memory) one at a time, each
// accumulated into every output of the range.
template <int SLOT, int LO, int HI>
__device__ __forceinline__ void conv2_outputs(const float* h1, const float* par,
                                              float h2[(HI - LO) * 3]) {
  constexpr int NC = HI - LO;
  float acc_p[NC * 3] = {}, acc_d[NC * 3] = {};
#pragma unroll
  for (int o = 0; o < COUT; ++o) {
    const float h[3] = {h1[o * 3], h1[o * 3 + 1], h1[o * 3 + 2]};
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        acc_p[c * 3 + v] = fmaf(c_conv2[SLOT].w2[(LO + c) * COUT + o], h[v], acc_p[c * 3 + v]);
        acc_d[c * 3 + v] = fmaf(c_conv2[SLOT].wd2[(LO + c) * COUT + o], h[v], acc_d[c * 3 + v]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    float p[3] = {acc_p[c * 3], acc_p[c * 3 + 1], acc_p[c * 3 + 2]};
    const float d[3] = {acc_d[c * 3], acc_d[c * 3 + 1], acc_d[c * 3 + 2]};
    gate(p, d, par[PAR_AB2 + LO + c], par[PAR_AB2 + COUT + LO + c], h2 + c * 3);
  }
}

// One stage over the edges.  Block: P points x KC edge slots, edge
// e = point-in-block * KC + slot, and for C = 21 at least P x 21 threads.
// For C = 21 conv1 runs first, one thread per (point, channel) over the
// round's edges (Conv1Channel), into the edges' rows of s_h; for C = 1 the
// edge's thread makes all 21 channels itself.  With two convs the edge's
// thread then reads its row back one channel at a time into conv2, in two
// halves of its outputs (66 accumulators in place of 126, within 128
// registers, so that three blocks of 160-168 threads fit an SM), and
// overwrites the row with the outputs.  Dynamic shared memory, in floats:
// the parameters, the rows s_h[P KC][63], and, when K takes more than one
// round, the running sums s_acc[P][63].
template <typename T, int C, int NCONV>
__global__ void __launch_bounds__(MAX_THREADS, 2)
edge_kernel(const T* __restrict__ x, const int* __restrict__ idx,
            const float* __restrict__ gath, const float* __restrict__ cen,
            const float* __restrict__ w1, const float* __restrict__ wd1,
            const float* __restrict__ ab1, const float* __restrict__ ab2,
            T* __restrict__ out, int points, int n, int k, int kc, int per_block, int rows,
            int row_begin) {
  constexpr int SLOT = slot_of(C);
  extern __shared__ float4 smem4[];
  float* par = reinterpret_cast<float*>(smem4);
  float* s_h = par + par_floats(C);
  float* s_acc = s_h + per_block * kc * CV;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int first = blockIdx.x * per_block;
  const int pl = tid / kc, slot = tid - pl * kc;
  const int point = first + pl;
  const int rounds = (k + kc - 1) / kc;

  for (int f = tid; f < 2 * COUT; f += threads) {
    par[PAR_AB1 + f] = ab1[f];
    if (NCONV == 2) par[PAR_AB2 + f] = ab2[f];
    if (C == 1) {
      par[PAR_W1 + f] = mix_weight<T>(w1[f]);
      par[PAR_WD1 + f] = mix_weight<T>(wd1[f]);
    }
  }
  __syncthreads();

  for (int r = 0; r < rounds; ++r) {
    const int nk = min(kc, k - r * kc);
    if constexpr (C == 21) {
      const int pp = tid / COUT, o = tid - pp * COUT, pt = first + pp;
      if (pp < per_block && pt < points) {
        const Conv1Channel ch(gath, cen, centre_of(pt, n, rows, row_begin), o, par + PAR_AB1);
        const int* nbr = idx + (size_t)pt * k + r * kc;
        const size_t cloud = cloud_of(pt, n, rows);
#pragma unroll 4
        for (int q = 0; q < nk; ++q) {
          const int j = nbr[q];
          const bool valid = j >= 0 && j < n;  // else the point's output is NaN
          float* h = s_h + (pp * kc + q) * CV + o * 3;
          ch.edge(cloud + (valid ? j : 0), h);
          if (!valid) h[0] = h[1] = h[2] = NAN;
        }
      }
      __syncthreads();
    }
    const int kk = r * kc + slot;
    if (tid < per_block * kc && point < points && kk < k) {
      float* hs = s_h + tid * CV;
      const int j = idx[(size_t)point * k + kk];
      if (j < 0 || j >= n) {
        if (C == 1)  // for C = 21 conv1 has written NaN already
          for (int f = 0; f < CV; ++f) hs[f] = NAN;
      } else {
        if constexpr (C == 1) {
          const T* xc = x + centre_of(point, n, rows, row_begin) * 3;
          const T* xj = x + (cloud_of(point, n, rows) + j) * 3;
          float xi[3], diff[3];
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            xi[v] = to_float(xc[v]);
            diff[v] = to_float(xj[v]) - xi[v];
          }
          conv1_c1(xi, diff, par, hs);
        }
        if constexpr (NCONV == 2) {
          constexpr int HALF = 11;
          float lo[HALF * 3], hi[(COUT - HALF) * 3];
          conv2_outputs<SLOT, 0, HALF>(hs, par, lo);
          conv2_outputs<SLOT, HALF, COUT>(hs, par, hi);
#pragma unroll
          for (int f = 0; f < HALF * 3; ++f) hs[f] = lo[f];
#pragma unroll
          for (int f = 0; f < (COUT - HALF) * 3; ++f) hs[HALF * 3 + f] = hi[f];
        }
      }
    }
    __syncthreads();
    // segmented sum: output (point, f) adds its point's edges in order
    const bool last = r == rounds - 1;
    for (int f = tid; f < per_block * CV; f += threads) {
      const int p = f / CV, cv = f - p * CV;
      if (first + p >= points) continue;
      float a = r > 0 ? s_acc[f] : 0.f;
      const float* e = s_h + p * kc * CV + cv;
#pragma unroll 4
      for (int q = 0; q < nk; ++q) a += e[q * CV];
      if (last)
        out[(size_t)(first + p) * CV + cv] = from_float<T>(a * (1.f / k));
      else
        s_acc[f] = a;
    }
    if (!last) __syncthreads();
  }
}

// ---- the bf16 route's two-conv stages: conv2 on the tensor cores ----

constexpr int TC_CH = 24;            // floats of one component's channels in an edge's row
constexpr int TC_ROW = 3 * TC_CH;    // floats of an edge's row (72: 8-byte loads of 8 rows hit
                                     // distinct banks)
constexpr int TC_GROUP = 8;          // edges of one MMA column tile
constexpr int TC_THREADS = 192;      // threads of an edge_tc_kernel block at most (9 points)
constexpr int TC_BLOCKS = 4;         // its blocks resident on an SM: <= 80 registers a thread

// conv1 of one channel o of a point's edges for C = 1 on bf16 features:
// Wa (x_j - x_i) + Wb x_i from the centre's and the neighbour's 3
// coordinates, the weights rounded to bf16 (conv1_c1's arithmetic).
struct Conv1ChannelC1 {
  float xi[3], wa, wb, wda, wdb, a, b;
  const __nv_bfloat16* x;
  __device__ __forceinline__ Conv1ChannelC1(const __nv_bfloat16* x_, size_t point, int o,
                                            const float* w1, const float* wd1, const float* ab1)
      : a(ab1[o]), b(ab1[COUT + o]), x(x_) {
#pragma unroll
    for (int v = 0; v < 3; ++v) xi[v] = to_float(x[point * 3 + v]);
    wa = mix_weight<__nv_bfloat16>(w1[o * 2]);
    wb = mix_weight<__nv_bfloat16>(w1[o * 2 + 1]);
    wda = mix_weight<__nv_bfloat16>(wd1[o * 2]);
    wdb = mix_weight<__nv_bfloat16>(wd1[o * 2 + 1]);
  }
  template <bool FAST>
  __device__ __forceinline__ void edge(size_t j, float h[3]) const {
    float p[3], d[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float diff = to_float(x[j * 3 + v]) - xi[v];
      p[v] = fmaf(wa, diff, __fmul_rn(wb, xi[v]));
      d[v] = fmaf(wda, diff, __fmul_rn(wdb, xi[v]));
    }
    gate_of<FAST>(p, d, a, b, h);
  }
};

// Two fp32 values, rounded to bf16, packed as mma.sync takes a pair: the
// first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The three bf16 limbs of a pair of fp32 values h: limb[l] packs
// bf16(h - limb[0] - ... - limb[l-1]) of both; every difference is exact.
__device__ __forceinline__ void split3(float2 h, uint32_t limb[3]) {
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    limb[l] = pack_bf16(h.x, h.y);
    h.x = __fsub_rn(h.x, __uint_as_float(limb[l] << 16));
    h.y = __fsub_rn(h.y, __uint_as_float(limb[l] & 0xffff0000u));
  }
}

// c += a b over one 16 x 8 x 16 tile, bf16 in, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One bf16 stage with two convs.  Block: P points; conv1 thread (point,
// channel o) for tid < 21 P, writing each of the round's KC edges' gated
// channel o into the edge's row of s_h; then each warp takes groups of 8
// edge rows: lane (g, t) = (lane / 4, lane % 4) loads row g's channels
// 2t, 2t+1, 2t+8, 2t+9, 16+2t, 17+2t of each component (its B fragments),
// splits them into limbs, and after the 54 HMMA holds p and d of channels
// g, 8 + g and (g < 5) 16 + g for the edges 2t and 2t+1 of the group: it
// gates them and writes them back over conv1's channels.  Then the mean as
// in edge_kernel.  Dynamic shared memory: the A fragments s_a[3][2][32]
// (uint4: M-tile, K-step, lane), then in floats s_h[groups 8][72] and, when
// K takes more than one round, s_acc[P][63].  Each lane reloads its A
// fragments from s_a per M-tile, and conv1's per-thread state is made anew
// each round, so neither is live across the whole kernel: 80 registers
// hold 4 blocks of 6 warps on an SM.
template <int C>
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS)
edge_tc_kernel(const __nv_bfloat16* __restrict__ x, const int* __restrict__ idx,
               const float* __restrict__ gath, const float* __restrict__ cen,
               const float* __restrict__ w1, const float* __restrict__ wd1,
               const float* __restrict__ ab1, const float* __restrict__ w2,
               const float* __restrict__ wd2, const float* __restrict__ ab2,
               __nv_bfloat16* __restrict__ out, int points, int n, int k, int kc, int per_block,
               int rows, int row_begin) {
  extern __shared__ float4 smem4[];
  uint4* s_a = reinterpret_cast<uint4*>(smem4);
  float* s_h = reinterpret_cast<float*>(s_a + 3 * 2 * 32);
  const int slots = per_block * kc;
  const int groups = (slots + TC_GROUP - 1) / TC_GROUP;
  float* s_acc = s_h + groups * TC_GROUP * TC_ROW;
  const int tid = threadIdx.x, threads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = threads >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int first = blockIdx.x * per_block;
  const int rounds = (k + kc - 1) / kc;

  // the rows' channels 21..23: zero for good (B's rows past input 20)
  for (int f = tid; f < groups * TC_GROUP * 3; f += threads) {
    float* r = s_h + (f / 3) * TC_ROW + (f % 3) * TC_CH + COUT;
    r[0] = r[1] = r[2] = 0.f;
  }
  // the lanes' A fragments (M-tile i, K-step s: inputs 16 s ..), made by
  // the first warp; the first barrier below publishes them
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int ch = 8 * i + g;
      auto w = [&](const float* m, int c) {
        return ch < COUT && c < COUT ? m[ch * COUT + c] : 0.f;
      };
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int c = 16 * s2 + 2 * t;
        s_a[(i * 2 + s2) * 32 + lane] =
            make_uint4(pack_bf16(w(w2, c), w(w2, c + 1)), pack_bf16(w(wd2, c), w(wd2, c + 1)),
                       pack_bf16(w(w2, c + 8), w(w2, c + 9)),
                       pack_bf16(w(wd2, c + 8), w(wd2, c + 9)));
      }
    }
  }
  float ga[3], gb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int ch = 8 * i + g;
    ga[i] = ch < COUT ? ab2[ch] : 0.f;
    gb[i] = ch < COUT ? ab2[COUT + ch] : 0.f;
  }

  const int pp = tid / COUT, o = tid - pp * COUT, pt = first + pp;
  const bool conv1_thread = pp < per_block && pt < points;
  using Conv1 = std::conditional_t<C == 1, Conv1ChannelC1, Conv1Channel>;

  for (int r = 0; r < rounds; ++r) {
    const int nk = min(kc, k - r * kc);
    if (conv1_thread) {
      const size_t cloud = cloud_of(pt, n, rows);
      const Conv1 ch1 = [&] {
        const size_t centre = centre_of(pt, n, rows, row_begin);
        if constexpr (C == 1)
          return Conv1ChannelC1(x, centre, o, w1, wd1, ab1);
        else
          return Conv1Channel(gath, cen, centre, o, ab1);
      }();
      const int* nbr = idx + (size_t)pt * k + r * kc;
#pragma unroll 4
      for (int q = 0; q < nk; ++q) {
        const int j = nbr[q];
        const bool valid = j >= 0 && j < n;  // else the point's output is NaN
        float h[3];
        ch1.template edge<true>(cloud + (valid ? j : 0), h);
        float* row = s_h + (pp * kc + q) * TC_ROW + o;
#pragma unroll
        for (int v = 0; v < 3; ++v) row[v * TC_CH] = valid ? h[v] : NAN;
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int grp = warp; grp < groups; grp += warps) {
      const float* row = s_h + (grp * TC_GROUP + g) * TC_ROW + 2 * t;
      float acc[3][3][4] = {};
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        uint32_t lo[3], hi[3], up[3];  // inputs 2t.., 2t+8.., 16+2t.. of component v
        split3(*reinterpret_cast<const float2*>(row + v * TC_CH), lo);
        split3(*reinterpret_cast<const float2*>(row + v * TC_CH + 8), hi);
        split3(*reinterpret_cast<const float2*>(row + v * TC_CH + 16), up);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const uint4 a0 = s_a[(i * 2) * 32 + lane], a1 = s_a[(i * 2 + 1) * 32 + lane];
          const uint32_t k0[4] = {a0.x, a0.y, a0.z, a0.w}, k1[4] = {a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int l = 2; l >= 0; --l) {
            mma_bf16(acc[i][v], k0, lo[l], hi[l]);
            mma_bf16(acc[i][v], k1, up[l], 0u);
          }
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int ch = 8 * i + g;
        if (ch >= COUT) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float p[3] = {acc[i][0][c], acc[i][1][c], acc[i][2][c]};
          const float d[3] = {acc[i][0][2 + c], acc[i][1][2 + c], acc[i][2][2 + c]};
          float h[3];
          gate_fast(p, d, ga[i], gb[i], h);
          float* dst = s_h + (grp * TC_GROUP + 2 * t + c) * TC_ROW + ch;
#pragma unroll
          for (int v = 0; v < 3; ++v) dst[v * TC_CH] = h[v];
        }
      }
      __syncwarp();
    }
    __syncthreads();
    // segmented sum: output (point, f) adds its point's edges in order
    const bool last = r == rounds - 1;
    for (int f = tid; f < per_block * CV; f += threads) {
      const int p = f / CV, cv = f - p * CV, oc = cv / 3, v = cv - oc * 3;
      if (first + p >= points) continue;
      float acc = r > 0 ? s_acc[f] : 0.f;
      const float* e = s_h + p * kc * TC_ROW + v * TC_CH + oc;
#pragma unroll 4
      for (int q = 0; q < nk; ++q) acc += e[q * TC_ROW];
      if (last)
        out[(size_t)(first + p) * CV + cv] = from_float<__nv_bfloat16>(acc * (1.f / k));
      else
        s_acc[f] = acc;
    }
    if (!last) __syncthreads();
  }
}

// edge_tc_kernel's block: the most points (up to 9: 21 threads each, at
// most 192) whose A fragments and rows fit 48 KB of shared memory; threads
// rounded up to whole warps.
int tc_points_per_block(int kc, int rounds, int* threads, size_t* smem) {
  auto bytes = [&](int p) {
    const int rows = (p * kc + TC_GROUP - 1) / TC_GROUP * TC_GROUP;
    return 3 * 2 * 32 * sizeof(uint4) +
           sizeof(float) * ((size_t)rows * TC_ROW + (rounds > 1 ? p * CV : 0));
  };
  int p = TC_THREADS / COUT;
  while (p > 1 && bytes(p) > SMEM_LIMIT) --p;
  *threads = (p * COUT + 31) / 32 * 32;
  *smem = bytes(p);
  return p;
}

int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Points per block for KC edge slots each: the fewest whose edges fill
// whole warps, doubled up to four warps, then cut until the threads
// (P KC, and P 21 for the conv1 phase of C = 21) and the shared memory fit.
int points_per_block(int c, int kc, int rounds, int* threads, size_t* smem) {
  auto bytes = [&](int p) {
    return sizeof(float) * (size_t)(par_floats(c) + p * kc * CV + (rounds > 1 ? p * CV : 0));
  };
  auto count = [&](int p) { return p * (c == 21 && kc < COUT ? COUT : kc); };
  int p = 32 / gcd(kc, 32);
  while (p * kc < 128 && count(2 * p) <= MAX_THREADS && bytes(2 * p) <= SMEM_LIMIT) p *= 2;
  while (p > 1 && (count(p) > MAX_THREADS || bytes(p) > SMEM_LIMIT)) --p;
  *threads = count(p);
  *smem = bytes(p);
  return p;
}

// A copy of conv2's weights into a constant slot and the launches that read
// it are ordered across streams by one event per device: a copy waits until
// the previous two-conv launch, on whatever stream, has finished.
std::mutex g_order_mutex;
cudaEvent_t g_done[64] = {};

template <typename T, int C, int NCONV>
cudaError_t launch(const T* x, const int* idx, const float* w1, const float* wd1,
                   const float* ab1, const float* w2, const float* wd2, const float* ab2,
                   T* out, float* workspace, int b, int n, int k, int row_begin, int rows,
                   cudaStream_t s) {
  cudaError_t err;
  if (NCONV == 2) {
    constexpr size_t base = slot_of(C) * sizeof(Conv2Weights);
    constexpr size_t bytes = COUT * COUT * sizeof(float);
    if ((err = cudaMemcpyToSymbolAsync(c_conv2, w2, bytes, base + offsetof(Conv2Weights, w2),
                                       cudaMemcpyDeviceToDevice, s)))
      return err;
    if ((err = cudaMemcpyToSymbolAsync(c_conv2, wd2, bytes, base + offsetof(Conv2Weights, wd2),
                                       cudaMemcpyDeviceToDevice, s)))
      return err;
  }
  // the projection covers every point of the table (an edge reads its
  // neighbour's products); the edges only the range's centres
  const int table = b * n, points = b * rows;
  float* gath = workspace;
  float* cen = workspace + (size_t)table * ROW;
  if (C == 21) {
    project_kernel<T><<<(table + PROJECT_POINTS - 1) / PROJECT_POINTS, PROJECT_POINTS * COUT,
                        0, s>>>(x, w1, wd1, gath, cen, table);
    if ((err = cudaGetLastError())) return err;
  }
  if constexpr (C == 21 && NCONV == 1) {
    const long long t = (long long)points * COUT;
    edge_mean_kernel<T><<<(unsigned)((t + MEAN_THREADS - 1) / MEAN_THREADS), MEAN_THREADS, 0,
                          s>>>(idx, gath, cen, ab1, out, points, n, k, rows, row_begin);
  } else {
    const int kc = k < MAX_EDGES ? k : MAX_EDGES;
    const int rounds = (k + kc - 1) / kc;
    int threads = 0;
    size_t smem = 0;
    const int per_block = points_per_block(C, kc, rounds, &threads, &smem);
    const int blocks = (points + per_block - 1) / per_block;
    edge_kernel<T, C, NCONV><<<blocks, threads, smem, s>>>(
        x, idx, gath, cen, w1, wd1, ab1, ab2, out, points, n, k, kc, per_block, rows, row_begin);
  }
  return cudaGetLastError();
}

// The bf16 route's two-conv stage: the projection (C = 21), then
// edge_tc_kernel, which reads conv2's weights from w2 and wd2 themselves.
template <int C>
cudaError_t launch_tc(const __nv_bfloat16* x, const int* idx, const float* w1, const float* wd1,
                      const float* ab1, const float* w2, const float* wd2, const float* ab2,
                      __nv_bfloat16* out, float* workspace, int b, int n, int k, int row_begin,
                      int rows, cudaStream_t s) {
  const int table = b * n, points = b * rows;
  float* gath = workspace;
  float* cen = workspace + (size_t)table * ROW;
  if (C == 21) {
    project_kernel<__nv_bfloat16><<<(table + PROJECT_POINTS - 1) / PROJECT_POINTS,
                                    PROJECT_POINTS * COUT, 0, s>>>(x, w1, wd1, gath, cen, table);
    if (cudaError_t err = cudaGetLastError()) return err;
  }
  const int kc = k < MAX_EDGES ? k : MAX_EDGES;
  const int rounds = (k + kc - 1) / kc;
  int threads = 0;
  size_t smem = 0;
  const int per_block = tc_points_per_block(kc, rounds, &threads, &smem);
  const int blocks = (points + per_block - 1) / per_block;
  // shared memory for TC_BLOCKS blocks an SM (the default split may hold fewer)
  cudaError_t err = cudaFuncSetAttribute(edge_tc_kernel<C>,
                                         cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
  if (err) return err;
  edge_tc_kernel<C><<<blocks, threads, smem, s>>>(x, idx, gath, cen, w1, wd1, ab1, w2, wd2, ab2,
                                                  out, points, n, k, kc, per_block, rows,
                                                  row_begin);
  return cudaGetLastError();
}

// The stage on features of element type T (see hpcs_edgeconv below).
template <typename T>
int edgeconv_entry(const T* x, const int* idx, const float* w1, const float* wd1,
                   const float* ab1, const float* w2, const float* wd2, const float* ab2, T* out,
                   float* workspace, int b, int n, int c, int k, int n_convs, int row_begin,
                   int rows, void* stream) {
  if (b < 1 || n < 1 || k < 1 || (long long)b * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (!((c == 1 || c == 21) && (n_convs == 1 || n_convs == 2))) return (int)cudaErrorInvalidValue;
  if (c == 21 && workspace == nullptr) return (int)cudaErrorInvalidValue;
  if (row_begin < 0 || rows < 1 || row_begin > n - rows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_convs == 1)
    return (int)(c == 1 ? launch<T, 1, 1>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace,
                                          b, n, k, row_begin, rows, s)
                        : launch<T, 21, 1>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace,
                                           b, n, k, row_begin, rows, s));
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return (int)(c == 1 ? launch_tc<1>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b, n,
                                       k, row_begin, rows, s)
                        : launch_tc<21>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b,
                                        n, k, row_begin, rows, s));
  } else {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err) return (int)err;
    if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(g_order_mutex);
    if (g_done[dev] == nullptr) {
      if ((err = cudaEventCreateWithFlags(&g_done[dev], cudaEventDisableTiming))) return (int)err;
    } else if ((err = cudaStreamWaitEvent(s, g_done[dev], 0))) {
      return (int)err;
    }
    err = c == 1 ? launch<T, 1, 2>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b, n, k,
                                   row_begin, rows, s)
                 : launch<T, 21, 2>(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b, n,
                                    k, row_begin, rows, s);
    if (err) return (int)err;
    return (int)cudaEventRecord(g_done[dev], s);
  }
}

}  // namespace

// x [b, n, c, 3] (the table), idx [b, rows, k] int32 (indices into each
// cloud's n points), w1/wd1 [21, 2c], ab1 [2, 21] (folded BatchNorm scale
// and shift), w2/wd2 [21, 21] and ab2 [2, 21] (unused when n_convs == 1),
// out [b, rows, 21, 3] for the centres row_begin .. row_begin + rows - 1
// (rows = n, row_begin = 0: every point); workspace 2 b n 128 floats when
// c == 21 (conv1's per-point products of the whole table; unused when
// c == 1); all contiguous fp32 on the device.  Returns the cudaError_t of
// the launches.
extern "C" int hpcs_edgeconv(const float* x, const int* idx, const float* w1, const float* wd1,
                             const float* ab1, const float* w2, const float* wd2,
                             const float* ab2, float* out, float* workspace, int b, int n, int c,
                             int k, int n_convs, int row_begin, int rows, void* stream) {
  return edgeconv_entry(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b, n, c, k, n_convs,
                        row_begin, rows, stream);
}

// The same with x and out bf16 (the weights, folded BatchNorm and workspace
// fp32; the kernels round the channel mixes to bf16).
extern "C" int hpcs_edgeconv_bf16(const __nv_bfloat16* x, const int* idx, const float* w1,
                                  const float* wd1, const float* ab1, const float* w2,
                                  const float* wd2, const float* ab2, __nv_bfloat16* out,
                                  float* workspace, int b, int n, int c, int k, int n_convs,
                                  int row_begin, int rows, void* stream) {
  return edgeconv_entry(x, idx, w1, wd1, ab1, w2, wd2, ab2, out, workspace, b, n, c, k, n_convs,
                        row_begin, rows, stream);
}
