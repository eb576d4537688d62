// Kernel B1: the k nearest neighbours of every point of a batch of clouds.
//
// Replaces hpcs_tpu/ops/pallas/knn_pallas.py::_knn_kernel.  For x [B, N, D]
// fp32 (or bf16, below) it writes idx [B, N, k] int32: nearest first, the point itself
// included, ties broken toward the smallest index.  The ranking score of
// column j for row i is 2 x_i.x_j - |x_j|^2, accumulated with fp32 FMAs on
// the CUDA cores (never TF32), so the N x N score matrix never reaches
// device memory.
//
// What bounds it on an H100: the score FMAs, 2 B N^2 D operations (2.1
// GFLOP at B=16, N=1024, D=63) against 67 TFLOP/s of fp32, plus one compare
// per score for a running top-k; it reads only B N D floats.
//
// A launch may cover a range of query rows, ranked against all N points
// (the point-sharded forward's rows of the gathered cloud): the row tiles
// then start at the range's first row, and each score and selection is the
// whole launch's, bit for bit.
//
// Design: one block of 256 threads per (cloud, tile of TR rows).  The row
// tile is staged transposed in shared memory; the cloud streams through in
// tiles of TC=128 columns, also transposed, so each thread computes a
// register tile of TR/8 rows x 4 columns from one broadcast load per row
// and one float4 load per dimension.  The block keeps all N scores of its
// rows in shared memory; then each warp selects its rows' k best with a
// warp queue: lane q < k holds the q-th best (score, index) seen so far,
// sorted across lanes, and (s, i) ranks above (s', i') if s > s', or
// s == s' and i < i', so ties go to the smallest index whatever order the
// columns arrive in, as the TPU kernel's first-argmax does.  The warp scans
// the row 32 columns at a time, one load and one compare against the k-th
// best per score; only the columns that beat it (a ballot) are inserted,
// lowest lane first, each re-checked against the moving k-th best.  NaN
// scores never rank; a slot no score reached reports -1.
//
// bf16 features (VN-DGCNN's bf16 configuration): knn_kernel is a template
// on the element type of x and converts each value to fp32 as it loads it
// into shared memory, so everything after the load, and the result, is the
// fp32 kernel's on the upcast values (bf16 to fp32 is exact), as the TPU
// kernel upcasts bf16 at its entry.  The loads move half the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TC = 128;           // columns per staged tile (32 lanes x 4)
constexpr int TC_STRIDE = TC + 4; // padded row of the column tile
constexpr int MAX_D = 64;
constexpr int MAX_K = 32;
constexpr int MAX_N = 4096;

__host__ __device__ inline int padded_n(int n) { return (n + TC - 1) / TC * TC; }

__host__ inline size_t smem_bytes(int tr, int n, int d) {
  return sizeof(float) * ((size_t)tr * padded_n(n) + (size_t)d * tr +
                          (size_t)d * TC_STRIDE + TC);
}

template <int TR, typename T>
__global__ void __launch_bounds__(THREADS)
knn_kernel(const T* __restrict__ x, int* __restrict__ idx, int n, int d, int k, int row_begin,
           int rows) {
  constexpr int RT = TR / WARPS;  // rows per thread
  extern __shared__ float4 smem4[];
  const int np = padded_n(n);
  float* scores = reinterpret_cast<float*>(smem4);  // [TR][np]
  float* tile = scores + TR * np;                   // [d][TR]
  float* cols = tile + d * TR;                      // [d][TC_STRIDE]
  float* colsq = cols + d * TC_STRIDE;              // [TC]

  const int b = blockIdx.y;
  const int row0 = row_begin + blockIdx.x * TR;
  const int row_end = row_begin + rows;
  const T* xb = x + (size_t)b * n * d;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int e = tid; e < TR * d; e += THREADS) {
    const int r = e / d, dd = e % d;
    tile[dd * TR + r] = row0 + r < row_end ? to_float(xb[(size_t)(row0 + r) * d + dd]) : 0.f;
  }

  for (int c0 = 0; c0 < n; c0 += TC) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = tid; e < TC * d; e += THREADS) {
      const int c = e / d, dd = e % d;
      cols[dd * TC_STRIDE + c] = c0 + c < n ? to_float(xb[(size_t)(c0 + c) * d + dd]) : 0.f;
    }
    __syncthreads();
    if (tid < TC) {
      float sq = 0.f;
      for (int dd = 0; dd < d; ++dd) {
        const float v = cols[dd * TC_STRIDE + tid];
        sq = fmaf(v, v, sq);
      }
      colsq[tid] = sq;
    }
    float acc[RT][4];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float4 cv = *reinterpret_cast<const float4*>(&cols[dd * TC_STRIDE + lane * 4]);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float rv = tile[dd * TR + warp * RT + r];
        acc[r][0] = fmaf(rv, cv.x, acc[r][0]);
        acc[r][1] = fmaf(rv, cv.y, acc[r][1]);
        acc[r][2] = fmaf(rv, cv.z, acc[r][2]);
        acc[r][3] = fmaf(rv, cv.w, acc[r][3]);
      }
    }
    __syncthreads();  // colsq is written
    const float4 sq = *reinterpret_cast<const float4*>(&colsq[lane * 4]);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float4 s;
      s.x = 2.f * acc[r][0] - sq.x;
      s.y = 2.f * acc[r][1] - sq.y;
      s.z = 2.f * acc[r][2] - sq.z;
      s.w = 2.f * acc[r][3] - sq.w;
      *reinterpret_cast<float4*>(&scores[(warp * RT + r) * np + c0 + lane * 4]) = s;
    }
  }
  __syncthreads();

  // selection: warp w owns rows w*RT .. w*RT+RT-1 of the tile
  const unsigned below_k = k == 32 ? 0xffffffffu : (1u << k) - 1u;
  for (int r = 0; r < RT; ++r) {
    const int lr = warp * RT + r;
    const int row = row0 + lr;
    if (row >= row_end) break;
    const float* srow = scores + lr * np;
    float qs = -INFINITY;  // this lane's queue entry
    int qi = INT_MAX;
    float ts = -INFINITY;  // the threshold: entry k-1
    int ti = INT_MAX;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      const float v = c < n ? srow[c] : -INFINITY;
      unsigned cand = __ballot_sync(0xffffffffu, c < n && (v > ts || (v == ts && c < ti)));
      while (cand) {
        const int src = __ffs(cand) - 1;
        cand &= cand - 1;
        const float cv = __shfl_sync(0xffffffffu, v, src);
        const int ci = c0 + src;
        if (!(cv > ts || (cv == ts && ci < ti))) continue;  // the queue moved past it
        const bool above = qs > cv || (qs == cv && qi < ci);
        const int pos = __popc(__ballot_sync(0xffffffffu, above) & below_k);
        const float us = __shfl_up_sync(0xffffffffu, qs, 1);
        const int ui = __shfl_up_sync(0xffffffffu, qi, 1);
        if (lane == pos) {
          qs = cv;
          qi = ci;
        } else if (lane > pos) {
          qs = us;
          qi = ui;
        }
        ts = __shfl_sync(0xffffffffu, qs, k - 1);
        ti = __shfl_sync(0xffffffffu, qi, k - 1);
      }
    }
    // only NaN scores were left for a slot still at INT_MAX: report -1
    if (lane < k) idx[((size_t)b * rows + row - row_begin) * k + lane] = qi < n ? qi : -1;
  }
}

template <int TR, typename T>
cudaError_t launch(const T* x, int* idx, int b, int n, int d, int k, int row_begin, int rows,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(TR, n, d);
  cudaError_t err = cudaFuncSetAttribute(knn_kernel<TR, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((rows + TR - 1) / TR, b);
  knn_kernel<TR, T><<<grid, THREADS, smem, stream>>>(x, idx, n, d, k, row_begin, rows);
  return cudaGetLastError();
}

// A row range [row_begin, row_begin + rows) of an n-point cloud.
__host__ inline bool valid_rows(int n, int row_begin, int rows) {
  return row_begin >= 0 && rows >= 1 && row_begin <= n - rows;
}

// B1 on x [b, n, d] of element type T, for rows row_begin .. row_begin +
// rows - 1: the row tile as knn_kernel's entry points choose it.  The tile
// is sized by n, the candidates, whatever the number of rows.
template <typename T>
int knn_entry(const T* x, int* idx, int b, int n, int d, int k, int row_begin, int rows,
              void* stream) {
  if (b < 1 || b > 65535 || n < 1 || n > MAX_N || d < 1 || d > MAX_D || k < 1 ||
      k > MAX_K || k > n || !valid_rows(n, row_begin, rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the largest row tile that leaves room for two blocks on an SM
  if (smem_bytes(32, n, d) <= 113 * 1024)
    return (int)launch<32>(x, idx, b, n, d, k, row_begin, rows, s);
  if (smem_bytes(16, n, d) <= 113 * 1024)
    return (int)launch<16>(x, idx, b, n, d, k, row_begin, rows, s);
  return (int)launch<8>(x, idx, b, n, d, k, row_begin, rows, s);
}

// ---------------------------------------------------------------------------
// The wide route: the shapes knn_kernel refuses (k > 32, D > 64 or N > 4096).
//
// The same function as knn_kernel, with the TPU kernel's own selection kept
// simple: one block of 256 threads per (cloud, row).  The block stages the
// row in shared memory, scores all N columns into dynamic shared memory
// (column j read from global memory, i.e. from L2, by thread j mod 256, the
// score accumulated with fp32 FMAs in dimension order exactly as
// knn_kernel does), then runs k passes of a block-wide first-argmax: each
// pass takes the largest score, the smallest index among equal ones, and
// marks the chosen column NaN so it never ranks again.  NaN scores never
// rank; a slot no score reached reports -1.  Any D and any k <= N; N + D
// floats must fit in WIDE_SMEM_BYTES.
//
// What bounds it: nothing here is tuned.  The scores cost 2 B N^2 D FMAs as
// in knn_kernel, but every block re-reads the whole cloud (B N^2 D floats
// from L2 in all), and the selection reads the row's scores k times.

constexpr int WIDE_SMEM_BYTES = 192 * 1024;

__host__ inline size_t wide_smem_bytes(int n, int d) {
  return sizeof(float) * ((size_t)n + d) + (sizeof(float) + sizeof(int)) * WARPS;
}

__global__ void __launch_bounds__(THREADS)
knn_wide_kernel(const float* __restrict__ x, int* __restrict__ idx, int n, int d, int k,
                int row_begin, int rows) {
  extern __shared__ float4 smem4[];
  float* scores = reinterpret_cast<float*>(smem4);  // [n]
  float* xi = scores + n;                           // [d]
  float* red_s = xi + d;                            // [WARPS]
  int* red_i = reinterpret_cast<int*>(red_s + WARPS);  // [WARPS]

  const int row = row_begin + blockIdx.x;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * n * d;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int dd = tid; dd < d; dd += THREADS) xi[dd] = xb[(size_t)row * d + dd];
  __syncthreads();
  for (int j = tid; j < n; j += THREADS) {
    const float* xj = xb + (size_t)j * d;
    float acc = 0.f, sq = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      const float v = xj[dd];
      acc = fmaf(xi[dd], v, acc);
      sq = fmaf(v, v, sq);
    }
    scores[j] = 2.f * acc - sq;
  }
  __syncthreads();

  int* out = idx + ((size_t)b * rows + blockIdx.x) * k;
  for (int q = 0; q < k; ++q) {
    float bs = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < n; j += THREADS) {
      const float v = scores[j];
      if (v > bs || (v == bs && j < bi)) {  // false for NaN
        bs = v;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off /= 2) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (os > bs || (os == bs && oi < bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      red_s[warp] = bs;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        if (red_s[w] > bs || (red_s[w] == bs && red_i[w] < bi)) {
          bs = red_s[w];
          bi = red_i[w];
        }
      }
      out[q] = bi < n ? bi : -1;
      if (bi < n) scores[bi] = NAN;
    }
    __syncthreads();
  }
}

}  // namespace

// x [b, n, d] fp32 and idx [b, rows, k] int32, both contiguous on the
// device: the k nearest of all n points for each of rows row_begin ..
// row_begin + rows - 1 (rows = n, row_begin = 0: the whole cloud).
// Returns the cudaError_t of the launch.
extern "C" int hpcs_knn(const float* x, int* idx, int b, int n, int d, int k, int row_begin,
                        int rows, void* stream) {
  return knn_entry(x, idx, b, n, d, k, row_begin, rows, stream);
}

// The same for x [b, n, d] bf16.
extern "C" int hpcs_knn_bf16(const __nv_bfloat16* x, int* idx, int b, int n, int d, int k,
                             int row_begin, int rows, void* stream) {
  return knn_entry(x, idx, b, n, d, k, row_begin, rows, stream);
}

// The wide route: x [b, n, d] fp32 and idx [b, rows, k] int32, both
// contiguous on the device, rows as hpcs_knn's; any d, any k <= n, n + d
// floats within WIDE_SMEM_BYTES.  Returns the cudaError_t of the launch.
extern "C" int hpcs_knn_wide(const float* x, int* idx, int b, int n, int d, int k,
                             int row_begin, int rows, void* stream) {
  if (b < 1 || b > 65535 || n < 1 || d < 1 || k < 1 || k > n ||
      !valid_rows(n, row_begin, rows) || wide_smem_bytes(n, d) > (size_t)WIDE_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = wide_smem_bytes(n, d);
  cudaError_t err = cudaFuncSetAttribute(knn_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  knn_wide_kernel<<<dim3(rows, b), THREADS, smem, s>>>(x, idx, n, d, k, row_begin, rows);
  return (int)cudaGetLastError();
}
