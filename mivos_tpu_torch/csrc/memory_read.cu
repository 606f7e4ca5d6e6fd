// Fused top-k space-time memory read for NVIDIA Hopper (sm_90a).
//
// Counterpart of mivos_tpu/ops/pallas/memory_read.py. For each of N query
// rows and each of K objects, the affinity a = q . k / sqrt(128) against
// the M memory keys is reduced to a threshold t that lower-bounds the
// k-th largest affinity, and the read is sum_j w_j v_j / sum_j w_j with
// w_j = (a_j >= t) ? exp(a_j - rowmax) : 0. The (K, N, M) affinity never
// reaches device memory: every phase recomputes it tile by tile from the
// 128-deep keys, which is far cheaper than writing and re-reading it.
//
// Three kernels, one per Pallas call:
//   candidates_kernel  <- _candidates_kernel (phase A: top-2 per bin under
//                         two partitions, then bisection for t)
//   refine_kernel      <- _refine_kernel (exact-count threshold tightening)
//   readout_kernel     <- _readout_kernel (phase B: thresholded exp, w.V),
//   readout_mma_kernel    fp32 banks on FP32 FMAs, bf16 banks on mma.sync
//
// Layout and contract (checked by the Python wrapper, ops/cuda/memory_read.py):
//   q      (N, 128) fp32, pre-scaled by 1/sqrt(128), contiguous
//   keys   (K, M, 128) fp32 or bf16, rows contiguous, object stride stride_k
//   values (K, M, 512) same dtype as keys, object stride stride_v
//   mask   (M,) fp32 additive (0 or -1e30), or null for "all live"
//   stats  (K, 3, N) fp32: threshold, rowmax, refine upper bound
//   out    (K, N, 512) fp32
//
// Design shared by the three kernels. The TPU grid (K, N/256, M/1024)
// carried per-row state across memory tiles in VMEM scratch. Here one
// block owns one (object, 16-row query tile) and loops over the whole
// memory axis itself, so the carried state lives in registers and shared
// memory of that block. Each 128-key chunk is staged in shared memory as
// fp32 and a 16 x 128 affinity tile is computed with fp32 FMAs (never a
// bf16 or TF32 product: a single bf16 pass costs ~10% weight error on
// trained banks). All arithmetic that decides the selection (bisection
// midpoints, refine edges) uses explicitly rounded fp32 operations so that
// it matches the plain PyTorch version bit for bit given equal affinities.
//
// What bounds it on the H100. A block (one object, 16 query rows) streams
// that object's bank once: M*128 key elements (phase A, refine) or
// M*(128+512) key and value elements (phase B), against 2*16*M*128
// affinity FLOPs and 2*16*M*512 w.V FLOPs -- 32 FLOP per bank element,
// 16 per byte of a bf16 bank. The affinity runs on the FP32 pipes (67
// TFLOP/s, balanced at ~20 FLOP per byte of 3.35 TB/s device memory), so
// a lone block reading from device memory would be memory bound. The
// ceil(N/16) = 102 blocks of one object re-read the same bank; at the
// session's largest bank (K=3, M=21060, bf16) the keys (16 MB) fit the
// 50 MB L2 and the values (65 MB) do not. The FP32 pipes are further held
// back by shared-memory operand traffic (about one 16-byte shared load per
// four FMAs), which is why bf16 w.V runs on the tensor cores
// (readout_mma_kernel).
//
// What this first version leaves undone: the grid is only
// 3 x ceil(1620/16) = 306 blocks at the session shape (2-3 per SM on 132
// SMs), with no split of the memory axis across blocks and no merge pass;
// key and value chunks are loaded synchronously (no cp.async/TMA double
// buffering); the affinity stays on FP32 FMAs (no split-bf16 mma.sync);
// fp32-bank w.V stays on FMAs; wgmma is unused; and the query tile is
// re-staged per kernel instead of fusing the three phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CK = 128;          // key width
constexpr int CV = 512;          // value width
constexpr int TN = 16;           // query rows per block
constexpr int THREADS = 256;
constexpr int KC = 128;          // keys per affinity chunk
constexpr int KS = CK + 4;       // shared row stride of q/k tiles (floats)
constexpr int AFS = KC + 16;     // shared row stride of affinity/weight tiles
constexpr int VC = 32;           // value rows per w.V sub-chunk
constexpr int C_BINS = 256;      // candidate bins per partition
constexpr int TPU_SLICES = 4;    // 256-wide slices per TPU tile (TM = 1024)
constexpr int ROLL = 85;         // partition-2 roll per slice (coprime to 256)
constexpr float NEG_INF = -1e30f;
constexpr float THRESH_RANGE = 30.0f;
constexpr int BISECT_ITERS = 22;
constexpr int N_EDGES = 7;
constexpr float REFINE_CAP = 0.15f;

static_assert(TN * 4 * C_BINS <= KC * KS, "bin state must fit the key buffer");
static_assert(VC * CV <= KC * KS, "value chunk must fit the key buffer");

__device__ __forceinline__ void bf16x8_to_f32(uint4 raw, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copy `rows` rows of `width` elements starting at row j0 into shared
// memory as fp32 with row stride `stride`; rows >= M are zero.
template <int ROWS, int WIDTH, int STRIDE>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int M,
                                          int j0, float* dst) {
  constexpr int PER_ROW = WIDTH / 4;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + r < M)
      v = reinterpret_cast<const float4*>(src + (size_t)(j0 + r) * WIDTH)[c];
    *reinterpret_cast<float4*>(dst + r * STRIDE + c * 4) = v;
  }
}

template <int ROWS, int WIDTH, int STRIDE>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* __restrict__ src,
                                          int M, int j0, float* dst) {
  constexpr int PER_ROW = WIDTH / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = i % PER_ROW;
    float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (j0 + r < M)
      bf16x8_to_f32(
          reinterpret_cast<const uint4*>(src + (size_t)(j0 + r) * WIDTH)[c], f);
    float* d = dst + r * STRIDE + c * 8;
    *reinterpret_cast<float4*>(d) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(d + 4) = make_float4(f[4], f[5], f[6], f[7]);
  }
}

__device__ __forceinline__ void load_queries(const float* __restrict__ q, int N,
                                             int n0, float* qs) {
  load_rows<TN, CK, KS>(q, N, n0, qs);
}

// 16 x 128 affinity tile: thread t owns rows 4*(t/64) .. +3 and keys
// (t%64) and (t%64)+64 of the chunk. Sequential fp32 FMAs over d.
__device__ __forceinline__ void affinity_tile(const float* qs, const float* ks,
                                              float acc[4][2]) {
  const int rg = threadIdx.x >> 6, kg = threadIdx.x & 63;
  const float* k0 = ks + kg * KS;
  const float* k1 = ks + (kg + 64) * KS;
  const float* q0 = qs + rg * 4 * KS;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
  for (int d = 0; d < CK; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(k0 + d);
    const float4 b = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(q0 + i * KS + d);
      acc[i][0] = fmaf(x.x, a.x, acc[i][0]);
      acc[i][0] = fmaf(x.y, a.y, acc[i][0]);
      acc[i][0] = fmaf(x.z, a.z, acc[i][0]);
      acc[i][0] = fmaf(x.w, a.w, acc[i][0]);
      acc[i][1] = fmaf(x.x, b.x, acc[i][1]);
      acc[i][1] = fmaf(x.y, b.y, acc[i][1]);
      acc[i][1] = fmaf(x.z, b.z, acc[i][1]);
      acc[i][1] = fmaf(x.w, b.w, acc[i][1]);
    }
  }
}

// Masked affinity of the tile element (row 4*rg+i, key j): the dot
// product plus the additive mask, -1e30 past the end of the bank (the
// Pallas wrapper pads M with -1e30 in the mask).
__device__ __forceinline__ float masked(float dot, const float* __restrict__ mask,
                                        int j, int M) {
  if (j >= M) return NEG_INF;
  return mask ? dot + mask[j] : dot;
}

// top-2 insert into a sorted pair (a >= b).
__device__ __forceinline__ void insert2(float& a, float& b, float x) {
  b = fmaxf(b, fminf(a, x));
  a = fmaxf(a, x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Phase A. Replaces _candidates_kernel (mivos_tpu/ops/pallas/memory_read.py:116).
// Bounded by the affinity FMAs (2*16*M*128 per block) against the M*128
// key elements each block streams. Thread b owns bin b of both partitions for all 16
// rows, so the 2 x top-2 x 256-bin state (4 KB per row) lives in 64
// registers per thread instead of shared memory. The memory axis is walked
// in 256-wide slices s; partition 1 puts key j in bin j mod 256, partition
// 2 in bin (j mod 256 + 85 * ((j mod 1024) div 256)) mod 256 -- keyed on the
// TPU tiling's 1024 whatever this kernel's own chunking is. Slices past the
// end of the bank would only insert -1e30 and are skipped. At the end the
// state goes to shared memory and one warp per row runs the 22 bisection
// steps on [rowmax - 30, rowmax].
template <typename KT>
__global__ void __launch_bounds__(THREADS)
candidates_kernel(const float* __restrict__ q, const KT* __restrict__ keys,
                  long long stride_k, const float* __restrict__ mask,
                  float* __restrict__ stats, int N, int M, int top_k) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // TN x KS
  float* ks = qs + TN * KS;                       // KC x KS, later the bin state
  float* aff = ks + KC * KS;                      // TN x C_BINS (one slice)
  const int k = blockIdx.y, n0 = blockIdx.x * TN, tid = threadIdx.x;
  const int rg = tid >> 6, kg = tid & 63;
  const KT* kb = keys + (size_t)k * stride_k;
  load_queries(q, N, n0, qs);

  float p1a[TN], p1b[TN], p2a[TN], p2b[TN];
#pragma unroll
  for (int r = 0; r < TN; ++r) p1a[r] = p1b[r] = p2a[r] = p2b[r] = NEG_INF;

  const int nslices = (M + C_BINS - 1) / C_BINS;
  for (int s = 0; s < nslices; ++s) {
    for (int half = 0; half < C_BINS / KC; ++half) {
      const int j0 = s * C_BINS + half * KC;
      __syncthreads();
      load_rows<KC, CK, KS>(kb, M, j0, ks);
      __syncthreads();
      float acc[4][2];
      affinity_tile(qs, ks, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = kg + 64 * jj;
          aff[(rg * 4 + i) * C_BINS + half * KC + c] =
              masked(acc[i][jj], mask, j0 + c, M);
        }
    }
    __syncthreads();
    const int b = tid;
    const int src2 = (b - ROLL * (s % TPU_SLICES)) & (C_BINS - 1);
#pragma unroll
    for (int r = 0; r < TN; ++r) {
      insert2(p1a[r], p1b[r], aff[r * C_BINS + b]);
      insert2(p2a[r], p2b[r], aff[r * C_BINS + src2]);
    }
  }

  __syncthreads();
  float* st = ks;  // TN x (p1a | p1b | p2a | p2b), 4 * C_BINS per row
#pragma unroll
  for (int r = 0; r < TN; ++r) {
    st[r * 4 * C_BINS + tid] = p1a[r];
    st[r * 4 * C_BINS + C_BINS + tid] = p1b[r];
    st[r * 4 * C_BINS + 2 * C_BINS + tid] = p2a[r];
    st[r * 4 * C_BINS + 3 * C_BINS + tid] = p2b[r];
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < TN; r += THREADS / 32) {
    const float* row = st + r * 4 * C_BINS;
    float v1[16], v2[16];  // this lane's bins of (p1a, p1b) and (p2a, p2b)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v1[i] = row[lane + 32 * i];
      v1[8 + i] = row[C_BINS + lane + 32 * i];
      v2[i] = row[2 * C_BINS + lane + 32 * i];
      v2[8 + i] = row[3 * C_BINS + lane + 32 * i];
    }
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < 8; ++i) mx = fmaxf(mx, fmaxf(v1[i], v2[i]));
    mx = warp_max(mx);
    float lo = __fsub_rn(mx, THRESH_RANGE), hi = mx;
    for (int it = 0; it < BISECT_ITERS; ++it) {
      const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
      int c1 = 0, c2 = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        c1 += v1[i] >= mid;
        c2 += v2[i] >= mid;
      }
      c1 = __reduce_add_sync(0xffffffffu, c1);
      c2 = __reduce_add_sync(0xffffffffu, c2);
      const bool ok = max(c1, c2) >= top_k;
      lo = ok ? mid : lo;
      hi = ok ? hi : mid;
    }
    if (lane == 0 && n0 + r < N) {
      float* o = stats + (size_t)k * 3 * N + n0 + r;
      o[0] = lo;
      o[N] = mx;
      o[2 * N] = mx;  // refine upper bound starts at the row max
    }
  }
}

// ---------------------------------------------------------------------------
// Refine pass. Replaces _refine_kernel (mivos_tpu/ops/pallas/memory_read.py:221).
// Bounded like phase A (the same affinity stream, plus 7 compares per
// element). Counts, per row, the entries reaching each of 7 edges
// th + (i+1)*delta over [th, th + min(ub - th, 0.15)]; 16 threads share a
// row and reduce their integer counts by shuffles at the end.
template <typename KT>
__global__ void __launch_bounds__(THREADS)
refine_kernel(const float* __restrict__ q, const KT* __restrict__ keys,
              long long stride_k, const float* __restrict__ mask,
              const float* __restrict__ stats_in, float* __restrict__ stats_out,
              int N, int M, int top_k) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // TN x KS
  float* ks = qs + TN * KS;                       // KC x KS
  float* aff = ks + KC * KS;                      // TN x AFS
  float* edges = aff + TN * AFS;                  // TN x N_EDGES
  const int k = blockIdx.y, n0 = blockIdx.x * TN, tid = threadIdx.x;
  const int rg = tid >> 6, kg = tid & 63;
  const KT* kb = keys + (size_t)k * stride_k;
  const float* sin = stats_in + (size_t)k * 3 * N;
  load_queries(q, N, n0, qs);
  if (tid < TN) {
    const int n = min(n0 + tid, N - 1);
    const float th = sin[n], ub = sin[2 * N + n];
    const float delta =
        fmaxf(__fdiv_rn(fminf(__fsub_rn(ub, th), REFINE_CAP), (float)N_EDGES), 1e-7f);
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e)
      edges[tid * N_EDGES + e] = __fadd_rn(th, __fmul_rn((float)(e + 1), delta));
  }

  const int row = tid >> 4, col = tid & 15;
  int cnt[N_EDGES];
#pragma unroll
  for (int e = 0; e < N_EDGES; ++e) cnt[e] = 0;
  for (int j0 = 0; j0 < M; j0 += KC) {
    __syncthreads();
    load_rows<KC, CK, KS>(kb, M, j0, ks);
    __syncthreads();
    float acc[4][2];
    affinity_tile(qs, ks, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = kg + 64 * jj;
        aff[(rg * 4 + i) * AFS + c] = masked(acc[i][jj], mask, j0 + c, M);
      }
    __syncthreads();
    float e_row[N_EDGES];
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e) e_row[e] = edges[row * N_EDGES + e];
#pragma unroll
    for (int u = 0; u < KC / 16; ++u) {
      const float a = aff[row * AFS + col + 16 * u];
#pragma unroll
      for (int e = 0; e < N_EDGES; ++e) cnt[e] += a >= e_row[e];
    }
  }
#pragma unroll
  for (int e = 0; e < N_EDGES; ++e)
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) cnt[e] += __shfl_xor_sync(0xffffffffu, cnt[e], o);

  if (col == 0 && n0 + row < N) {
    const int n = n0 + row;
    const float th = sin[n], mx = sin[N + n], ub = sin[2 * N + n];
    const float delta =
        fmaxf(__fdiv_rn(fminf(__fsub_rn(ub, th), REFINE_CAP), (float)N_EDGES), 1e-7f);
    int nok = 0;
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e) nok += cnt[e] >= top_k;
    const float th_new = __fadd_rn(th, __fmul_rn((float)nok, delta));
    const float ub_new = nok < N_EDGES ? fminf(ub, __fadd_rn(th_new, delta)) : ub;
    float* o = stats_out + (size_t)k * 3 * N + n;
    o[0] = th_new;
    o[N] = mx;
    o[2 * N] = ub_new;
  }
}

// ---------------------------------------------------------------------------
// Phase B for fp32 banks. Replaces _readout_kernel
// (mivos_tpu/ops/pallas/memory_read.py:284). Bounded by the w.V FMAs
// (2*16*M*512 per block) and the M*(128+512) bank elements each block
// streams. The (16, 512) fp32 accumulator is spread over
// the block's registers (thread t: rows 4*(t/64)..+3, columns 4*(t%64)..+3
// and 256+4*(t%64)..+3), so no value columns need splitting across blocks.
// Each 128-key chunk: affinity tile -> w = (a >= t) ? exp(a - rowmax) : 0,
// sum of fp32 w kept per thread, w rounded to the value dtype into shared
// memory; then the chunk's values are staged 32 rows at a time (fp32) and
// accumulated with FMAs.
__global__ void __launch_bounds__(THREADS)
readout_kernel(const float* __restrict__ q, const float* __restrict__ keys,
               long long stride_k, const float* __restrict__ values,
               long long stride_v, const float* __restrict__ mask,
               const float* __restrict__ stats, float* __restrict__ out, int N,
               int M) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // TN x KS
  float* buf = qs + TN * KS;                      // keys (KC x KS) or values (VC x CV)
  float* wsm = buf + KC * KS;                     // TN x AFS
  float* red = wsm + TN * AFS;                    // 8 warps x 4 rows
  const int k = blockIdx.y, n0 = blockIdx.x * TN, tid = threadIdx.x;
  const int rg = tid >> 6, kg = tid & 63, cg = tid & 63;
  const float* kb = keys + (size_t)k * stride_k;
  const float* vb = values + (size_t)k * stride_v;
  const float* st = stats + (size_t)k * 3 * N;
  load_queries(q, N, n0, qs);

  float th[4], mx[4], wpart[4], o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = min(n0 + rg * 4 + i, N - 1);
    th[i] = st[n];
    mx[i] = st[N + n];
    wpart[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  for (int j0 = 0; j0 < M; j0 += KC) {
    __syncthreads();
    load_rows<KC, CK, KS>(kb, M, j0, buf);
    __syncthreads();
    float acc[4][2];
    affinity_tile(qs, buf, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = kg + 64 * jj;
        const float a = masked(acc[i][jj], mask, j0 + c, M);
        const float w = a >= th[i] ? expf(__fsub_rn(a, mx[i])) : 0.f;
        wpart[i] += w;
        wsm[(rg * 4 + i) * AFS + c] = w;
      }
    for (int sub = 0; sub < KC / VC && j0 + sub * VC < M; ++sub) {
      __syncthreads();
      load_rows<VC, CV, CV>(vb, M, j0 + sub * VC, buf);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < VC; ++c) {
        const float4 v0 = *reinterpret_cast<const float4*>(buf + c * CV + cg * 4);
        const float4 v1 =
            *reinterpret_cast<const float4*>(buf + c * CV + CV / 2 + cg * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = wsm[(rg * 4 + i) * AFS + sub * VC + c];
          o[i][0] = fmaf(w, v0.x, o[i][0]);
          o[i][1] = fmaf(w, v0.y, o[i][1]);
          o[i][2] = fmaf(w, v0.z, o[i][2]);
          o[i][3] = fmaf(w, v0.w, o[i][3]);
          o[i][4] = fmaf(w, v1.x, o[i][4]);
          o[i][5] = fmaf(w, v1.y, o[i][5]);
          o[i][6] = fmaf(w, v1.z, o[i][6]);
          o[i][7] = fmaf(w, v1.w, o[i][7]);
        }
      }
    }
  }

  // Row sums of w: the 64 threads of a row group are warps 2*rg and 2*rg+1.
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = warp_sum(wpart[i]);
    if (lane == 0) red[warp * 4 + i] = s;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + rg * 4 + i;
    if (n >= N) continue;
    const float ws = red[(2 * rg) * 4 + i] + red[(2 * rg + 1) * 4 + i];
    float* orow = out + ((size_t)k * N + n) * CV;
    *reinterpret_cast<float4*>(orow + cg * 4) =
        make_float4(__fdiv_rn(o[i][0], ws), __fdiv_rn(o[i][1], ws),
                    __fdiv_rn(o[i][2], ws), __fdiv_rn(o[i][3], ws));
    *reinterpret_cast<float4*>(orow + CV / 2 + cg * 4) =
        make_float4(__fdiv_rn(o[i][4], ws), __fdiv_rn(o[i][5], ws),
                    __fdiv_rn(o[i][6], ws), __fdiv_rn(o[i][7], ws));
  }
}

// ---------------------------------------------------------------------------
// Phase B for bf16 banks (the session's production setting). Replaces
// _readout_kernel (mivos_tpu/ops/pallas/memory_read.py:284) with the same
// contract as readout_kernel, with w.V on the tensor cores. Bounded by the
// affinity recompute on the FP32 pipes (as phase A) plus staging the
// M*512 bf16 values of each block through shared memory; the w.V products
// themselves are cheap on the tensor cores. Where readout_kernel's w.V
// FMAs were limited by their shared-memory operand loads (two 16-byte
// loads and four broadcasts per 32 FMAs), here each warp owns 64 output
// columns and runs
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate): A is the 16 x 16 tile of w
// already rounded to bf16 (exactly the rounding of the Pallas kernel, so
// no precision is lost), B a 16 x 8 value tile fetched transposed with
// ldmatrix. Values are staged 64 rows at a time as raw bf16 with a padded
// row stride (VSB) that keeps both ldmatrix and the staging stores free of
// bank conflicts. The affinity, the threshold test and sum(w) in fp32 are
// unchanged.
constexpr int VCM = 64;          // value rows per staged sub-chunk
constexpr int VSB = CV + 8;      // shared row stride of staged values (bf16)
constexpr int WSB = KC + 8;      // shared row stride of the bf16 w tile
static_assert(VCM * VSB * 2 <= KC * KS * 4, "value chunk must fit the key buffer");

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__global__ void __launch_bounds__(THREADS)
readout_mma_kernel(const float* __restrict__ q,
                   const __nv_bfloat16* __restrict__ keys, long long stride_k,
                   const __nv_bfloat16* __restrict__ values, long long stride_v,
                   const float* __restrict__ mask,
                   const float* __restrict__ stats, float* __restrict__ out,
                   int N, int M) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // TN x KS
  float* buf = qs + TN * KS;                      // keys fp32, or values bf16
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(buf);  // VCM x VSB
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(buf + KC * KS);  // TN x WSB
  float* red = reinterpret_cast<float*>(wb + TN * WSB);  // 8 warps x 4 rows
  float* wrow = red + 32;                                 // TN row sums
  const int k = blockIdx.y, n0 = blockIdx.x * TN, tid = threadIdx.x;
  const int rg = tid >> 6, kg = tid & 63;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const __nv_bfloat16* kb = keys + (size_t)k * stride_k;
  const __nv_bfloat16* vb = values + (size_t)k * stride_v;
  const float* st = stats + (size_t)k * 3 * N;
  load_queries(q, N, n0, qs);

  float th[4], mx[4], wpart[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = min(n0 + rg * 4 + i, N - 1);
    th[i] = st[n];
    mx[i] = st[N + n];
    wpart[i] = 0.f;
  }
  float acc[8][4];  // 8 n-tiles of 8 columns: warp * 64 + 8 * j
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int j0 = 0; j0 < M; j0 += KC) {
    __syncthreads();
    load_rows<KC, CK, KS>(kb, M, j0, buf);
    __syncthreads();
    float af[4][2];
    affinity_tile(qs, buf, af);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = kg + 64 * jj;
        const float a = masked(af[i][jj], mask, j0 + c, M);
        const float w = a >= th[i] ? expf(__fsub_rn(a, mx[i])) : 0.f;
        wpart[i] += w;
        wb[(rg * 4 + i) * WSB + c] = __float2bfloat16_rn(w);
      }
    for (int sub = 0; sub < KC / VCM && j0 + sub * VCM < M; ++sub) {
      __syncthreads();
      for (int i = tid; i < VCM * (CV / 8); i += THREADS) {
        const int r = i / (CV / 8), c = i % (CV / 8);
        const int j = j0 + sub * VCM + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (j < M) v = reinterpret_cast<const uint4*>(vb + (size_t)j * CV)[c];
        *reinterpret_cast<uint4*>(vbuf + r * VSB + c * 8) = v;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < VCM / 16; ++ks) {
        const __nv_bfloat16* wk = wb + sub * VCM + ks * 16 + t4 * 2;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(wk + g * WSB);
        a[1] = *reinterpret_cast<const uint32_t*>(wk + (g + 8) * WSB);
        a[2] = *reinterpret_cast<const uint32_t*>(wk + g * WSB + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(wk + (g + 8) * WSB + 8);
        const __nv_bfloat16* vrow =
            vbuf + (ks * 16 + (lane & 15)) * VSB + warp * 64 + (lane >> 4) * 8;
#pragma unroll
        for (int jt = 0; jt < 4; ++jt) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vrow + jt * 16);
          mma_bf16_16x8x16(acc[2 * jt], a, b[0], b[1]);
          mma_bf16_16x8x16(acc[2 * jt + 1], a, b[2], b[3]);
        }
      }
    }
  }

  // Row sums of w: the 64 threads of a row group are warps 2*rg and 2*rg+1.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float s = warp_sum(wpart[i]);
    if (lane == 0) red[warp * 4 + i] = s;
  }
  __syncthreads();
  if (tid < TN)
    wrow[tid] = red[(2 * (tid / 4)) * 4 + tid % 4] + red[(2 * (tid / 4) + 1) * 4 + tid % 4];
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half, n = n0 + r;
    if (n >= N) continue;
    const float ws = wrow[r];
    float* orow = out + ((size_t)k * N + n) * CV + warp * 64 + t4 * 2;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j) =
          make_float2(__fdiv_rn(acc[j][2 * half], ws),
                      __fdiv_rn(acc[j][2 * half + 1], ws));
  }
}

constexpr size_t kCandidatesSmem = (TN * KS + KC * KS + TN * C_BINS) * sizeof(float);
constexpr size_t kRefineSmem =
    (TN * KS + KC * KS + TN * AFS + TN * N_EDGES) * sizeof(float);
constexpr size_t kReadoutSmem = (TN * KS + KC * KS + TN * AFS + 32) * sizeof(float);
constexpr size_t kReadoutMmaSmem =
    (TN * KS + KC * KS) * sizeof(float) + TN * WSB * 2 + (32 + TN) * sizeof(float);

template <typename KT>
int launch_candidates(const void* q, const void* keys, long long stride_k,
                      const void* mask, void* stats, int K, int N, int M,
                      int top_k, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(candidates_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kCandidatesSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TN - 1) / TN, K);
  candidates_kernel<KT><<<grid, THREADS, kCandidatesSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(keys), stride_k,
      static_cast<const float*>(mask), static_cast<float*>(stats), N, M, top_k);
  return (int)cudaGetLastError();
}

template <typename KT>
int launch_refine(const void* q, const void* keys, long long stride_k,
                  const void* mask, const void* stats_in, void* stats_out, int K,
                  int N, int M, int top_k, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(refine_kernel<KT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kRefineSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TN - 1) / TN, K);
  refine_kernel<KT><<<grid, THREADS, kRefineSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const KT*>(keys), stride_k,
      static_cast<const float*>(mask), static_cast<const float*>(stats_in),
      static_cast<float*>(stats_out), N, M, top_k);
  return (int)cudaGetLastError();
}

int launch_readout_mma(const void* q, const void* keys, long long stride_k,
                       const void* values, long long stride_v, const void* mask,
                       const void* stats, void* out, int K, int N, int M,
                       cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(readout_mma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kReadoutMmaSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TN - 1) / TN, K);
  readout_mma_kernel<<<grid, THREADS, kReadoutMmaSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const __nv_bfloat16*>(keys),
      stride_k, static_cast<const __nv_bfloat16*>(values), stride_v,
      static_cast<const float*>(mask), static_cast<const float*>(stats),
      static_cast<float*>(out), N, M);
  return (int)cudaGetLastError();
}

int launch_readout(const void* q, const void* keys, long long stride_k,
                   const void* values, long long stride_v, const void* mask,
                   const void* stats, void* out, int K, int N, int M,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(readout_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kReadoutSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TN - 1) / TN, K);
  readout_kernel<<<grid, THREADS, kReadoutSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(keys), stride_k,
      static_cast<const float*>(values), stride_v, static_cast<const float*>(mask),
      static_cast<const float*>(stats), static_cast<float*>(out), N, M);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). `bf16` selects the bank dtype:
// 1 = bfloat16 keys/values, 0 = float32. Each function launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch (0 = success).
extern "C" {

int mr_candidates(const void* q, const void* keys, long long stride_k,
                  const void* mask, void* stats, int K, int N, int M, int top_k,
                  int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_candidates<__nv_bfloat16>(q, keys, stride_k, mask, stats,
                                                 K, N, M, top_k, s)
              : launch_candidates<float>(q, keys, stride_k, mask, stats, K, N,
                                         M, top_k, s);
}

int mr_refine(const void* q, const void* keys, long long stride_k,
              const void* mask, const void* stats_in, void* stats_out, int K,
              int N, int M, int top_k, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_refine<__nv_bfloat16>(q, keys, stride_k, mask, stats_in,
                                             stats_out, K, N, M, top_k, s)
              : launch_refine<float>(q, keys, stride_k, mask, stats_in,
                                     stats_out, K, N, M, top_k, s);
}

int mr_readout(const void* q, const void* keys, long long stride_k,
               const void* values, long long stride_v, const void* mask,
               const void* stats, void* out, int K, int N, int M, int bf16,
               void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_readout_mma(q, keys, stride_k, values, stride_v, mask,
                                  stats, out, K, N, M, s)
              : launch_readout(q, keys, stride_k, values, stride_v, mask,
                                      stats, out, K, N, M, s);
}

}  // extern "C"
