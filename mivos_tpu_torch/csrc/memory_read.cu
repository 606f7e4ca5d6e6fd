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
// Kernels, by the Pallas call they replace:
//   _candidates_kernel (phase A: top-2 per bin under two partitions, then
//   bisection for t):
//     candidates_bf16_kernel + candidates_merge_kernel   bf16 banks
//     candidates_f32_kernel + candidates_merge_kernel    fp32 banks
//   _refine_kernel (exact-count threshold tightening):
//     refine_bf16_kernel + refine_merge_kernel           bf16 banks
//     refine_hilo_kernel + refine_merge_kernel           fp32 banks
//   _readout_kernel (phase B: thresholded exp, w.V):
//     readout_bf16_kernel + readout_merge_kernel         bf16 banks
//     readout_f32_kernel + readout_merge_kernel          fp32 banks
//   and, for fp32 banks, hilo_planes_kernel: the bf16 planes k_hi = bf16(k),
//   k_lo = bf16(k - k_hi) of keys and values, which the JAX kernel forms in
//   the body of _affinity (pallas/memory_read.py:108-113) from each tile.
//
// Layout and contract (checked by the Python wrapper, ops/cuda/memory_read.py):
//   q      the query (N, 128) fp32, pre-scaled by 1/sqrt(128), as its split
//          q_hi = bf16(q), q_lo = bf16(q - q_hi), each (N, 128) bf16
//   keys   (K, M, 128) fp32 or bf16, rows contiguous, object stride stride_k;
//          for fp32 banks phases A and B take the keys' bf16 planes k_hi,
//          k_lo, each (K, M, 128) contiguous
//   values (K, M, 512) same dtype as keys, object stride stride_v; for fp32
//          banks phase B takes their planes v_hi, v_lo, (K, M, 512)
//   mask   (M,) fp32 additive (0 or -1e30), or null for "all live"
//   stats  (K, 3, N) fp32: threshold, rowmax, refine upper bound
//   out    (K, N, 512) fp32
//
// bf16 banks (the session's setting). The affinity is the JAX kernel's
// split (_affinity): a = q_hi.k + q_lo.k, two bf16 passes with fp32
// accumulation on the tensor cores, which is q.k up to fp32 rounding
// since bf16 keys are exact tensor-core inputs. The readout runs both its
// products on wgmma (sm_90a), refine its affinity; phase A runs the
// affinity on mma.sync.m16n8k16 (its 32-row tile is below wgmma's 64
// rows). All three add per K step of 16 the q_hi product, then the q_lo
// product, into one fp32 accumulator, so they rank the same numbers. The query
// split is staged once per block and held in shared memory. Key and value
// chunks, and the mask's chunk, stream through a two-stage cp.async ring
// (the next chunk loads while the current one is multiplied; a mask read
// from global memory per element had cost the readout ~30%), and the
// memory axis is split into
// S ranges cut at multiples of 256 keys so the grid fills the 132 SMs; the
// wrapper picks S from the grid and the SM count. Per-range partials go to
// a workspace the wrapper allocates, and a second kernel merges them in a
// fixed order of ranges (no atomics: two calls give equal bits).
//
//   readout_bf16_kernel: one block per (64 query rows, M-range, object),
//   blockIdx.x fastest so the row tiles sharing one object's M-range run
//   together and its values come from device memory about once, then from
//   the 50 MB L2. 8 warps, two warpgroups; per 64-key chunk each
//   warpgroup computes the 64 x 32 affinity tile of its half of the keys
//   with wgmma (query halves and keys read by the tensor cores from
//   shared memory), each warp forms w = (a >= t) ? exp(a - rowmax) : 0
//   for its 16 rows, keeps sum(w) in fp32 of the unrounded w and stores w
//   rounded to bf16 in shared memory; then each warpgroup multiplies the
//   64 rows of w by its 256 value columns with wgmma (a 64 x 256 fp32
//   accumulator, 128 registers a thread). cp.async stages queries, keys
//   and values in wgmma's 128-byte-swizzled layouts. Phase A
//   gives rowmax, so partial (w.V, sum w) over disjoint ranges simply add:
//   no running max, no rescaling. readout_merge_kernel divides the sums.
//
//   candidates_bf16_kernel: one block per (32 query rows, M-range, object),
//   512 threads. Per 256-key slice the 16 warps compute the 32 x 256
//   affinity tile into shared memory; thread b then inserts bin b of its
//   16 rows under both partitions into top-2 pairs held in registers (2
//   partitions x top-2 x 16 rows = 64 registers; 32 rows x 4 KB of bin
//   state per block is what fits one SM's register file). Partition 2's
//   roll is keyed on the global slice index ((j mod 1024) div 256), which
//   the 256-aligned cuts preserve. candidates_merge_kernel takes per bin
//   the top-2 of the union of the ranges' pairs (exact), then one warp per
//   row runs the 22 bisection steps.
//
//   refine_bf16_kernel: one block per (64 query rows, M-range, object),
//   one warpgroup; the query halves stay in registers as wgmma's A
//   fragments, and per 64-key chunk (K-major in the 128-byte swizzle) the
//   split affinity on wgmma.m64n64k16 lands in a 64 x 64 fp32
//   accumulator, 32 registers a thread. The epilogue reads it there: each
//   entry is compared once with its row's lowest edge, and only the few
//   at or above it (about top_k of a row's M) run the 7 edge compares.
//   Each thread counts for its two rows in registers; the quad's lanes
//   add their counts by shuffles at the end, and the block writes int32
//   counts (S, K, N, 7). 150 registers a thread and 67 KB of shared
//   memory let three blocks share an SM, so one block's epilogue and
//   staging hide behind another's wgmma. refine_merge_kernel adds the
//   ranges' counts (integers: exact in any order) and updates the stats.
//   Every block computes the edges from the stats with the same rounded
//   fp32 operations as the merge. Tried and slower at the timing shape:
//   the query read by wgmma from shared memory (by 8%), blocks of two
//   warpgroups and 128 rows (7%), 128-key chunks (84%).
//
// What bounds them on the H100 at the session's timing shape (K = 3,
// N = 1620, M = 21060, bf16 bank). The affinity counts as the JAX
// kernel's two bf16 passes, 2 x 26.2 = 52.4 GFLOP. Readout: 52.4 + 104.8
// (w.V) = 157.2 GFLOP, 0.159 ms at 989 TFLOP/s, against 91 MB of device
// memory (0.027 ms at 3.35 TB/s): compute bound. Its blocks stream 26 row
// tiles x 27 MB of one object's keys and values = 2.1 GB L2->SM per read
// (6.6 GB with the earlier 16-row tiles), plus S x 10 MB of partials each
// way. Candidates: 52.4 GFLOP, 0.053 ms, against 16 MB (0.005 ms):
// compute bound; 51 row tiles x 5.4 MB = 0.83 GB of keys L2->SM (1.65 GB
// at 16 rows), plus S x 20 MB of bin states each way. With mma.sync each
// warp reads its operands from shared memory itself (the layouts above let
// each ldmatrix feed two to four mma); wgmma reads each operand once per
// warpgroup and runs asynchronously at the full tensor-core rate.
// Measured on this design, no one part bounds the readout: taking out the
// exp, the affinity products, w.V or the value loads one at a time cut it
// by 10%, 5%, 20% and 25%. What is left is the chunk loop's serial chain
// (staging issue, two barriers and two wgmma waits per chunk) in one block
// of 8 warps an SM, which the 64 x 512 fp32 accumulator keeps from
// sharing an SM. Blocks of 128 rows x 256 value columns, with w kept in
// registers and one barrier per chunk, cut the L2->SM traffic to 1.26 GB
// and ran no faster.
//
// Refine at that shape: the same 52.4 GFLOP as phase A, 0.053 ms.
//
// fp32 banks. The affinity is the JAX kernel's three-term split for fp32
// keys (_affinity): a = q_hi.k_hi + q_hi.k_lo + q_lo.k_hi, the q_lo.k_lo
// term dropped (~1e-5 relative), three bf16 passes into one fp32
// accumulator, per K step of 16 in that order (a single bf16 or TF32 pass
// costs ~10% weight error on trained banks). The readout's w.V is
// fp32-accurate the same way: w_hi.v_hi + w_lo.v_hi + w_hi.v_lo, with
// sum(w) kept from the unrounded fp32 w. hilo_planes_kernel writes the
// keys' and values' bf16 planes once a read, for all phases (a pass over
// the bank at the memory rate, ~0.1 ms at K = 3, M = 21060), so the kernels
// stage bf16 planes with cp.async exactly as the bf16-bank kernels stage
// a bf16 bank, and split M in the same 256-aligned ranges with the same
// merges. The planes double the shared memory the bf16 plans need, so:
//
//   readout_f32_kernel: readout_bf16_kernel with 32-key chunks (64 query
//   rows, two warpgroups; per chunk the affinity of each warpgroup's 16
//   keys on wgmma.m64n16k16, 8 K steps x 3 passes; w.V as 2 K steps x 3
//   passes of wgmma.m64n256k16, A = the w_hi and w_lo tiles by ldmatrix).
//   Queries 32 KB, two stages of key planes 32 KB and value planes 128 KB,
//   w tiles 10 KB: 203 KB of the 227 KB a block may hold.
//
//   candidates_f32_kernel: candidates_bf16_kernel with the keys' planes
//   staged as 128-key half-slices (two stages x two planes = 136 KB); the
//   16 warps compute the 32 x 128 tile of a half-slice, 16 x 16 each, on
//   mma.sync (3 passes), and the bins take the 32 x 256 slice tile after
//   its second half.
//
//   What bounds them at the timing shape (K = 3, N = 1620, M = 21060,
//   fp32 bank): the readout's 3 + 3 passes are 78.6 + 314.4 = 393 GFLOP,
//   0.397 ms at 989 TFLOP/s against 173 MB of device memory (0.052 ms):
//   compute bound; phase A's 78.6 GFLOP, 0.079 ms. Measured (kernel and
//   merge on planes made apart, H100 SXM at 700 W): readout 1.24 ms, phase
//   A 0.61 ms, the read's planes of keys and values 0.116 ms (83% of their
//   0.097 ms bytes bound). Tried
//   and slower: blocks of 64-key chunks x 256 value columns (two blocks a
//   row tile, the query halves in registers, the affinity computed by
//   both), 19% slower at this shape. Splitting the planes in shared
//   memory after an fp32 stage would need the fp32 chunk (80 KB at 32
//   keys) beside its planes: 282 KB with two stages.
//
//   refine_hilo_kernel: refine_bf16_kernel with both key planes in its
//   ring and three passes a K step. Two stages x two planes of 64-key
//   chunks take 64 KB; the query halves (32 KB in the 128-byte swizzle)
//   are staged into the ring's second stage and loaded into registers
//   before chunk 1 needs it, so a block holds 64.5 KB and three share an
//   SM, which hides one block's epilogue and staging behind another's
//   wgmma as in the bf16 kernel. At the timing shape its 3 passes are
//   3 x 26.2 = 78.6 GFLOP, 0.0795 ms at 989 TFLOP/s, against 33.4 MB of
//   device memory (0.010 ms): compute bound. Its 26 row tiles read each
//   object's 10.8 MB of key planes from L2, 0.84 GB L2->SM, twice the
//   bf16 kernel's. Measured (with the merge, H100 SXM at 700 W): 0.186 ms,
//   43% of that bound. Tried and slower: 32-key chunks on
//   wgmma.m64n32k16 with the query apart (three blocks an SM, twice the
//   barriers a key), 20%; 64-key chunks with the query apart (96.5 KB,
//   two blocks an SM), 44%.
//
// All arithmetic that decides the selection (bisection midpoints, refine
// edges) uses explicitly rounded fp32 operations, so that given equal
// affinities kernel and plain PyTorch version pick the same set.
//
// Left undone: TMA for the staging (cp.async stages everything); phases
// A and B are not fused; warp specialization (a producer warp, mbarriers)
// in the readouts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CK = 128;          // key width
constexpr int CV = 512;          // value width
constexpr int THREADS = 256;
constexpr int C_BINS = 256;      // candidate bins per partition
constexpr int TPU_SLICES = 4;    // 256-wide slices per TPU tile (TM = 1024)
constexpr int ROLL = 85;         // partition-2 roll per slice (coprime to 256)
constexpr float NEG_INF = -1e30f;
constexpr float THRESH_RANGE = 30.0f;
constexpr int BISECT_ITERS = 22;
constexpr int N_EDGES = 7;
constexpr float REFINE_CAP = 0.15f;

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

// 22 bisection steps on [rowmax - 30, rowmax] over one row's bin state
// (this lane's 8 bins of each array: v1 = partition 1's top-1 | top-2,
// v2 = partition 2's); the whole warp calls it. Returns (t, rowmax).
__device__ __forceinline__ float2 bisect_row(const float v1[16], const float v2[16],
                                             int top_k) {
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
  return make_float2(lo, mx);
}

// ---------------------------------------------------------------------------
// Refine pass: per row, exact counts of the entries reaching each of 7
// edges th + (e+1)*delta over [th, th + min(ub - th, 0.15)], then th
// rises to the highest edge still counting >= top_k entries and ub falls
// to the next edge up. The edges and the update use explicitly rounded
// fp32 operations, as refine_plain's fp32 tensor ops round them.
__device__ __forceinline__ float refine_delta(float th, float ub) {
  return fmaxf(__fdiv_rn(fminf(__fsub_rn(ub, th), REFINE_CAP), (float)N_EDGES), 1e-7f);
}

__device__ __forceinline__ float refine_edge(float th, float delta, int e) {
  return __fadd_rn(th, __fmul_rn((float)(e + 1), delta));
}

// Row n's new (th, mx, ub) from its counts; `sin` and `sout` point at
// the object's (3, N) stats.
__device__ __forceinline__ void refine_update(const int cnt[N_EDGES], const float* sin,
                                              float* sout, int n, int N, int top_k) {
  const float th = sin[n], mx = sin[N + n], ub = sin[2 * N + n];
  const float delta = refine_delta(th, ub);
  int nok = 0;
#pragma unroll
  for (int e = 0; e < N_EDGES; ++e) nok += cnt[e] >= top_k;
  const float th_new = __fadd_rn(th, __fmul_rn((float)nok, delta));
  sout[n] = th_new;
  sout[N + n] = mx;
  sout[2 * N + n] = nok < N_EDGES ? fminf(ub, __fadd_rn(th_new, delta)) : ub;
}

// ---------------------------------------------------------------------------
// bf16 banks: tensor-core building blocks, the cp.async ring, the M split.

constexpr int QSB = CK + 8;        // shared row stride of bf16 q/key rows (272 B)
constexpr int SPLIT_ALIGN = C_BINS;  // M ranges are cut at multiples of 256 keys

__device__ __forceinline__ void mma_bf16_16x8x16(float c[4], const uint32_t a[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 16-byte asynchronous copy of the first src_bytes (0..16) of src; the
// rest of the 16 destination bytes is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage ROWS rows of WIDTH bf16 (rows row0.. of src, zero from `limit`
// on) into shared memory with row stride DST_STRIDE, by NT threads.
template <int ROWS, int WIDTH, int DST_STRIDE, int NT>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           int row0, int limit) {
  constexpr int PER_ROW = WIDTH / 8;
  static_assert(NT % PER_ROW == 0 && (ROWS * PER_ROW) % NT == 0, "piece layout");
  const int c = threadIdx.x % PER_ROW, r0 = threadIdx.x / PER_ROW;
  bf16* d = dst + r0 * DST_STRIDE + c * 8;
  const bf16* sp = src + (size_t)(row0 + r0) * WIDTH + c * 8;
#pragma unroll
  for (int t = 0; t < ROWS * PER_ROW / NT; ++t) {
    const int r = r0 + t * (NT / PER_ROW);
    const bool valid = row0 + r < limit;
    cp_async16(d + t * (NT / PER_ROW) * DST_STRIDE,
               valid ? sp + (size_t)t * (NT / PER_ROW) * WIDTH : src, valid ? 16 : 0);
  }
}

// Stage mask[j0, j0 + COUNT) into shared memory, zero from M on (keys
// past the bank are masked by index). The mask then costs the affinity
// epilogue a shared load per element instead of a global one.
template <int COUNT>
__device__ __forceinline__ void stage_mask(float* dst, const float* __restrict__ mask,
                                           int j0, int M) {
  for (int i = threadIdx.x; i < COUNT / 4; i += blockDim.x) {
    const int j = j0 + 4 * i, live = min(max(M - j, 0), 4);
    cp_async16(dst + 4 * i, mask + (live ? j : 0), 4 * live);
  }
}

// Masked affinity of key j (column c of the staged chunk `sm`, or no
// mask when sm is null).
__device__ __forceinline__ float masked_staged(float dot, const float* sm, int c,
                                               int j, int M) {
  if (j >= M) return NEG_INF;
  return sm ? dot + sm[c] : dot;
}

// Keys [j_begin, j_end) of range s of S: cuts at multiples of 256 keys,
// the ceil(M/256) slices shared out as evenly as integer division does.
__device__ __forceinline__ void split_range(int M, int S, int s, int& j_begin,
                                            int& j_end) {
  const long long nsl = (M + SPLIT_ALIGN - 1) / SPLIT_ALIGN;
  j_begin = (int)(s * nsl / S) * SPLIT_ALIGN;
  j_end = min((int)((s + 1) * nsl / S) * SPLIT_ALIGN, M);
}

// One warp's 16 x 32 split affinity tile: rows r0.. of the staged query
// halves, keys c0.. of the staged key chunk (row stride QSB). Two bf16
// passes (q_hi, q_lo) accumulate in fp32. acc[nt] is the m16n8 fragment
// of keys c0 + 8*nt .. +7.
__device__ __forceinline__ void split_affinity_16x32(const bf16* q_hi,
                                                     const bf16* q_lo,
                                                     const bf16* ks, int r0,
                                                     int c0, float acc[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int qoff = (r0 + (lane & 15)) * QSB + (lane >> 4) * 8;
  const int koff = (c0 + (lane & 7) + ((lane >> 4) << 3)) * QSB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    uint32_t ah[4], al[4];
    ldmatrix_x4(ah, q_hi + qoff + kk * 16);
    ldmatrix_x4(al, q_lo + qoff + kk * 16);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + koff + np * 16 * QSB + kk * 16);
      mma_bf16_16x8x16(acc[2 * np], ah, b[0], b[1]);
      mma_bf16_16x8x16(acc[2 * np], al, b[0], b[1]);
      mma_bf16_16x8x16(acc[2 * np + 1], ah, b[2], b[3]);
      mma_bf16_16x8x16(acc[2 * np + 1], al, b[2], b[3]);
    }
  }
}

// One warp's 16 x 16 three-pass split affinity tile for fp32 keys: rows
// r0.. of the staged query halves, keys c0.. of the staged key planes
// (row stride QSB). Per K step q_hi.k_hi, q_hi.k_lo, q_lo.k_hi accumulate
// in fp32 (the JAX kernel's _affinity for fp32 keys). acc[nt] is the m16n8
// fragment of keys c0 + 8*nt .. +7.
__device__ __forceinline__ void split3_affinity_16x16(const bf16* q_hi, const bf16* q_lo,
                                                      const bf16* k_hi, const bf16* k_lo,
                                                      int r0, int c0, float acc[2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  const int qoff = (r0 + (lane & 15)) * QSB + (lane >> 4) * 8;
  const int koff = (c0 + (lane & 7) + ((lane >> 4) << 3)) * QSB + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    uint32_t ah[4], al[4], bh[4], bl[4];
    ldmatrix_x4(ah, q_hi + qoff + kk * 16);
    ldmatrix_x4(al, q_lo + qoff + kk * 16);
    ldmatrix_x4(bh, k_hi + koff + kk * 16);
    ldmatrix_x4(bl, k_lo + koff + kk * 16);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16_16x8x16(acc[nt], ah, bh[2 * nt], bh[2 * nt + 1]);
      mma_bf16_16x8x16(acc[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
      mma_bf16_16x8x16(acc[nt], al, bh[2 * nt], bh[2 * nt + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Phase A for bf16 banks. Replaces _candidates_kernel
// (mivos_tpu/ops/pallas/memory_read.py:116). TR = 32 query rows per block
// (16-row blocks ran 17% slower: twice the key traffic), 512 threads; warp
// w computes rows 16*(w/8).. x keys 32*(w%8).. of each 256-key slice, and
// thread t owns bin t%256 of rows 16*(t/256)..+15. Writes the block's bin
// state to ws (S, K, N, 4, 256): p1 top-1, p1 top-2, p2 top-1, p2 top-2.
constexpr int TR = 32;             // query rows per phase-A block
constexpr int CAND_THREADS = 16 * TR;
constexpr int AFB = C_BINS + 4;    // shared row stride of the fp32 slice tile
constexpr size_t kCandidatesBf16Smem =
    (size_t)(2 * TR * QSB + 2 * C_BINS * QSB) * sizeof(bf16) +
    (size_t)(TR * AFB + 2 * C_BINS) * sizeof(float);

__global__ void __launch_bounds__(CAND_THREADS, 1)
candidates_bf16_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                       const bf16* __restrict__ keys, long long stride_k,
                       const float* __restrict__ mask, float* __restrict__ ws,
                       int N, int M, int S) {
  constexpr int NT = CAND_THREADS;
  extern __shared__ uint4 smem_u4[];
  bf16* sqh = reinterpret_cast<bf16*>(smem_u4);   // TR x QSB
  bf16* sql = sqh + TR * QSB;                     // TR x QSB
  bf16* sk = sql + TR * QSB;                      // 2 stages x 256 x QSB
  float* aff = reinterpret_cast<float*>(sk + 2 * C_BINS * QSB);  // TR x AFB
  float* smask = aff + TR * AFB;                  // 2 stages x 256
  const int n0 = blockIdx.x * TR, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int am = warp >> 3, akc = (warp & 7) * 32;   // affinity tile of this warp
  const int rgrp = tid >> 8, b = tid & (C_BINS - 1);  // bin owned by this thread
  const bf16* kb = keys + (size_t)k * stride_k;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nsl = (j_end - j_begin + C_BINS - 1) / C_BINS;

  float p1a[16], p1b[16], p2a[16], p2b[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) p1a[r] = p1b[r] = p2a[r] = p2b[r] = NEG_INF;

  stage_rows<TR, CK, QSB, NT>(sqh, q_hi, n0, N);
  stage_rows<TR, CK, QSB, NT>(sql, q_lo, n0, N);
  stage_rows<C_BINS, CK, QSB, NT>(sk, kb, j_begin, M);
  if (mask) stage_mask<C_BINS>(smask, mask, j_begin, M);
  cp_async_commit();
  for (int i = 0; i < nsl; ++i) {
    const int j0 = j_begin + i * C_BINS;
    cp_async_wait_all();
    __syncthreads();   // slice i landed; slice i-1's stage and tile are free
    if (i + 1 < nsl) {
      stage_rows<C_BINS, CK, QSB, NT>(sk + ((i + 1) & 1) * C_BINS * QSB, kb,
                                      j0 + C_BINS, M);
      if (mask) stage_mask<C_BINS>(smask + ((i + 1) & 1) * C_BINS, mask, j0 + C_BINS, M);
      cp_async_commit();
    }
    float acc[4][4];
    split_affinity_16x32(sqh, sql, sk + (i & 1) * C_BINS * QSB, am * 16, akc, acc);
    const float* sm = mask ? smask + (i & 1) * C_BINS : nullptr;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = akc + nt * 8 + t4 * 2;
        *reinterpret_cast<float2*>(aff + (am * 16 + g + 8 * h) * AFB + c) =
            make_float2(masked_staged(acc[nt][2 * h], sm, c, j0 + c, M),
                        masked_staged(acc[nt][2 * h + 1], sm, c + 1, j0 + c + 1, M));
      }
    __syncthreads();
    const int src2 = (b - ROLL * ((j0 / C_BINS) % TPU_SLICES)) & (C_BINS - 1);
    const float* arow = aff + rgrp * 16 * AFB;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      insert2(p1a[r], p1b[r], arow[r * AFB + b]);
      insert2(p2a[r], p2b[r], arow[r * AFB + src2]);
    }
  }

  float* o = ws + (((size_t)s * K + k) * N) * 4 * C_BINS;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = n0 + rgrp * 16 + r;
    if (n >= N) continue;
    float* row = o + (size_t)n * 4 * C_BINS;
    row[b] = p1a[r];
    row[C_BINS + b] = p1b[r];
    row[2 * C_BINS + b] = p2a[r];
    row[3 * C_BINS + b] = p2b[r];
  }
}

// Phase A for fp32 banks. Replaces _candidates_kernel
// (mivos_tpu/ops/pallas/memory_read.py:116). candidates_bf16_kernel's
// plan on the keys' bf16 planes: both planes of a 256-key slice and a
// second stage would take 278 KB, so they stream as 128-key half-slices
// (two stages x two planes, 136 KB). Warp w computes rows 16*(w/8).. x
// keys 16*(w%8).. of each half-slice into columns 128*(half).. of the
// slice tile; after the second half, thread t inserts bin t%256 of rows
// 16*(t/256)..+15. Writes the block's bin state to ws (S, K, N, 4, 256).
constexpr int CF_HALF = C_BINS / 2;   // keys per stage
constexpr size_t kCandidatesF32Smem =
    (size_t)(2 * TR * QSB + 4 * CF_HALF * QSB) * sizeof(bf16) +
    (size_t)(TR * AFB + 2 * CF_HALF) * sizeof(float);

__global__ void __launch_bounds__(CAND_THREADS, 1)
candidates_f32_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                      const bf16* __restrict__ k_hi, const bf16* __restrict__ k_lo,
                      const float* __restrict__ mask, float* __restrict__ ws, int N,
                      int M, int S) {
  constexpr int NT = CAND_THREADS, HP = CF_HALF * QSB;   // HP: one plane's half-slice
  extern __shared__ uint4 smem_u4[];
  bf16* sqh = reinterpret_cast<bf16*>(smem_u4);   // TR x QSB
  bf16* sql = sqh + TR * QSB;                     // TR x QSB
  bf16* sk = sql + TR * QSB;                      // [stage][hi, lo] x CF_HALF x QSB
  float* aff = reinterpret_cast<float*>(sk + 4 * HP);  // TR x AFB
  float* smask = aff + TR * AFB;                  // 2 stages x CF_HALF
  const int n0 = blockIdx.x * TR, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int am = warp >> 3, akc = (warp & 7) * 16;   // affinity tile of this warp
  const int rgrp = tid >> 8, b = tid & (C_BINS - 1);  // bin owned by this thread
  const bf16* kh = k_hi + (size_t)k * M * CK;
  const bf16* kl = k_lo + (size_t)k * M * CK;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nhalf = 2 * ((j_end - j_begin + C_BINS - 1) / C_BINS);

  float p1a[16], p1b[16], p2a[16], p2b[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) p1a[r] = p1b[r] = p2a[r] = p2b[r] = NEG_INF;

  auto stage = [&](int buf, int j0) {
    stage_rows<CF_HALF, CK, QSB, NT>(sk + 2 * buf * HP, kh, j0, M);
    stage_rows<CF_HALF, CK, QSB, NT>(sk + (2 * buf + 1) * HP, kl, j0, M);
    if (mask) stage_mask<CF_HALF>(smask + buf * CF_HALF, mask, j0, M);
  };
  stage_rows<TR, CK, QSB, NT>(sqh, q_hi, n0, N);
  stage_rows<TR, CK, QSB, NT>(sql, q_lo, n0, N);
  stage(0, j_begin);
  cp_async_commit();
  for (int i = 0; i < nhalf; ++i) {
    const int j0 = j_begin + i * CF_HALF, buf = i & 1;
    cp_async_wait_all();
    __syncthreads();   // half i landed; half i-1's stage and the last bin pass are done
    if (i + 1 < nhalf) {
      stage(buf ^ 1, j0 + CF_HALF);
      cp_async_commit();
    }
    float acc[2][4];
    split3_affinity_16x16(sqh, sql, sk + 2 * buf * HP, sk + (2 * buf + 1) * HP, am * 16,
                          akc, acc);
    const float* sm = mask ? smask + buf * CF_HALF : nullptr;
    float* arow = aff + (i & 1) * CF_HALF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = akc + nt * 8 + t4 * 2;
        *reinterpret_cast<float2*>(arow + (am * 16 + g + 8 * h) * AFB + c) =
            make_float2(masked_staged(acc[nt][2 * h], sm, c, j0 + c, M),
                        masked_staged(acc[nt][2 * h + 1], sm, c + 1, j0 + c + 1, M));
      }
    if (i & 1) {
      __syncthreads();   // the slice tile is complete
      const int src2 =
          (b - ROLL * (((j0 - CF_HALF) / C_BINS) % TPU_SLICES)) & (C_BINS - 1);
      const float* srow = aff + rgrp * 16 * AFB;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        insert2(p1a[r], p1b[r], srow[r * AFB + b]);
        insert2(p2a[r], p2b[r], srow[r * AFB + src2]);
      }
    }
  }

  float* o = ws + (((size_t)s * K + k) * N) * 4 * C_BINS;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int n = n0 + rgrp * 16 + r;
    if (n >= N) continue;
    float* row = o + (size_t)n * 4 * C_BINS;
    row[b] = p1a[r];
    row[C_BINS + b] = p1b[r];
    row[2 * C_BINS + b] = p2a[r];
    row[3 * C_BINS + b] = p2b[r];
  }
}

// Merge of phase A's ranges: per bin the top-2 of the union of the S
// ranges' pairs, in range order, then bisection; one warp per (object, row).
__device__ __forceinline__ void merge2(float& a, float& b, float c, float d) {
  b = fmaxf(fminf(a, c), fmaxf(b, d));
  a = fmaxf(a, c);
}

__global__ void __launch_bounds__(THREADS)
candidates_merge_kernel(const float* __restrict__ ws, float* __restrict__ stats,
                        int K, int N, int S, int top_k) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= K * N) return;   // whole warps only
  const size_t plane = (size_t)K * N * 4 * C_BINS;
  const float* src = ws + (size_t)row * 4 * C_BINS + lane;
  float v1[16], v2[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v1[i] = src[32 * i];
    v1[8 + i] = src[C_BINS + 32 * i];
    v2[i] = src[2 * C_BINS + 32 * i];
    v2[8 + i] = src[3 * C_BINS + 32 * i];
  }
  for (int s = 1; s < S; ++s) {
    const float* p = src + s * plane;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      merge2(v1[i], v1[8 + i], p[32 * i], p[C_BINS + 32 * i]);
      merge2(v2[i], v2[8 + i], p[2 * C_BINS + 32 * i], p[3 * C_BINS + 32 * i]);
    }
  }
  const float2 tm = bisect_row(v1, v2, top_k);
  if (lane == 0) {
    const int k = row / N, n = row % N;
    float* o = stats + (size_t)k * 3 * N + n;
    o[0] = tm.x;
    o[N] = tm.y;
    o[2 * N] = tm.y;  // refine upper bound starts at the row max
  }
}

// wgmma (sm_90a): D (64 x 256 fp32, 128 registers a thread of the
// warpgroup, the m16n8 fragment layout per warp and n-tile) += A (64 x 16
// bf16 in registers, the mma.sync A fragment of rows 16*warp..) x B (16 x
// 256 bf16 in shared memory, N contiguous, described by `desc`).
__device__ __forceinline__ void wgmma_64x256x16(float d[128], const uint32_t a[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// wgmma (sm_90a): D (64 x 32 fp32, 16 registers a thread, the m16n8
// fragment layout per warp and n-tile) += A (64 x 16 bf16) x B (16 x 32
// bf16), both K-major in shared memory, described by `da` and `db`.
__device__ __forceinline__ void wgmma_64x32x16_ss(float d[16], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// Shared-memory matrix descriptor of an operand in the 128-byte swizzle:
// atoms of 8 rows x 128 bytes (1024 bytes, 1024-aligned), row r of an atom
// at byte 128*r with its eight 16-byte chunks permuted by chunk ^ r.
// N-major operands (the values: rows along K, 64 N a row): atoms `lbo`
// bytes apart along N and `sbo` bytes apart along K. K-major operands
// (queries and keys: rows along M or N, 64 K a row): `lbo` unused (16),
// `sbo` bytes between 8-row atoms; a K step of 16 inside the atom's
// 64 adds 32 bytes to the start address.
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* smem, int lbo,
                                                    int sbo) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin the accumulator registers in program order around wgmma: the
// compiler must not read them between an issue and its wait.
template <int NR>
__device__ __forceinline__ void wgmma_fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// cp.async writes shared memory through the generic proxy, wgmma reads it
// through the async proxy: the writer fences between the two.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Phase B for bf16 banks. Replaces _readout_kernel
// (mivos_tpu/ops/pallas/memory_read.py:284). 64 query rows per block, 8
// warps, 64-key chunks; warpgroup g = w/4 holds rows 16*(w%4).. of both
// products' accumulators in warp w. Affinity (wgmma m64n32k16, both
// operands from shared memory): warpgroup g computes the 64 rows x keys
// 32*g.. of the chunk, 8 K steps x 2 passes (q_hi, q_lo) into a 64 x 32
// fp32 tile, 16 registers a thread, whose fragments are mma.sync's, so
// each warp forms w for its 16 rows as before. w.V (wgmma m64n256k16):
// warpgroup g multiplies the whole 64 x 64 bf16 w tile (A: each warp loads
// its 16 rows into registers with ldmatrix) by value columns 256*g.. into
// a 64 x 256 fp32 accumulator, 128 registers a thread. cp.async stages
// straight into wgmma's 128-byte-swizzled layouts (gmma_desc_sw128):
// queries and keys K-major, each 128-wide row as two 64-wide halves
// (stage_rows_sw128); values N-major, the atom of keys 8*ka.. and columns
// 64*na.. at byte na*V_NATOM + ka*V_KATOM. (Without the swizzle the 32
// column blocks of one key row share the same banks and the readout ran
// slower than with mma.sync.) Writes (S, K, N, 512) partial sums and
// (S, K, N) partial sum(w) to the workspace.
constexpr int RO_ROWS = 64;
constexpr int RO_KC = 64;
constexpr int WSB = RO_KC + 8;     // shared row stride of the bf16 w tile (144 B)
constexpr int V_KATOM = 1024;                     // bytes between atoms along K
constexpr int V_NATOM = (RO_KC / 8) * V_KATOM;    // bytes between atoms along N
constexpr int SW_ATOM = 1024;                     // bytes between 8-row K-major atoms
constexpr size_t kReadoutBf16Smem =
    (size_t)(2 * RO_ROWS * CK + 2 * RO_KC * CK + 2 * RO_KC * CV + RO_ROWS * WSB) *
        sizeof(bf16) +
    (size_t)(2 * RO_ROWS + 2 * RO_KC) * sizeof(float);

// Stage rows [row0, row0 + ROWS) of a (.., CK) bf16 matrix (zero from
// `limit` on) K-major in the 128-byte swizzle: columns 0-63 of all rows,
// then columns 64-127, each row a 128-byte line at byte 128*r of its half
// with its 16-byte chunks permuted by chunk ^ (r % 8). NT threads copy.
template <int ROWS, int NT = THREADS>
__device__ __forceinline__ void stage_rows_sw128(bf16* dst, const bf16* __restrict__ src,
                                                 int row0, int limit) {
  static_assert((ROWS * (CK / 8)) % NT == 0, "piece layout");
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int t = 0; t < ROWS * (CK / 8) / NT; ++t) {
    const int i = threadIdx.x + t * NT;
    const int u = i & 15, r = i >> 4;
    const bool valid = row0 + r < limit;
    cp_async16(d + (u >> 3) * ROWS * 128 + r * 128 + (((u & 7) ^ (r & 7)) << 4),
               valid ? src + (size_t)(row0 + r) * CK + u * 8 : src, valid ? 16 : 0);
  }
}

// Stage value rows [row0, row0 + KCH) (zero from `limit` on) in the
// layout above, with (KCH / 8) * V_KATOM bytes between atoms along N.
// Piece i is 16-byte chunk u = i%8 of key row j = (i/8)%KCH in column atom
// na = i/(8*KCH): eight lanes copy one row's 128 bytes of an atom, from
// contiguous global memory into one swizzled 128-byte line.
template <int KCH>
__device__ __forceinline__ void stage_values(bf16* dst, const bf16* __restrict__ src,
                                             int row0, int limit) {
  constexpr int NATOM = (KCH / 8) * V_KATOM;
  char* d = reinterpret_cast<char*>(dst);
#pragma unroll
  for (int t = 0; t < KCH * (CV / 8) / THREADS; ++t) {
    const unsigned i = threadIdx.x + t * THREADS;
    const int u = i & 7, j = (i >> 3) & (KCH - 1), na = i / (8 * KCH);
    const bool valid = row0 + j < limit;
    cp_async16(d + na * NATOM + (j >> 3) * V_KATOM + (j & 7) * 128 + ((u ^ (j & 7)) << 4),
               valid ? src + (size_t)(row0 + j) * CV + na * 64 + u * 8 : src,
               valid ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
readout_bf16_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                    const bf16* __restrict__ keys, long long stride_k,
                    const bf16* __restrict__ values, long long stride_v,
                    const float* __restrict__ mask, const float* __restrict__ stats,
                    float* __restrict__ ws_acc, float* __restrict__ ws_sum, int N,
                    int M, int S) {
  extern __shared__ __align__(1024) uint4 smem_u4[];
  bf16* sqh = reinterpret_cast<bf16*>(smem_u4);   // RO_ROWS x CK, K-major swizzled
  bf16* sql = sqh + RO_ROWS * CK;                 // RO_ROWS x CK, K-major swizzled
  bf16* sk = sql + RO_ROWS * CK;                  // 2 stages x RO_KC x CK, K-major swizzled
  bf16* sv = sk + 2 * RO_KC * CK;                 // 2 stages x RO_KC x CV, N-major swizzled
  bf16* sw = sv + 2 * RO_KC * CV;                 // RO_ROWS x WSB
  float* red = reinterpret_cast<float*>(sw + RO_ROWS * WSB);  // 2 x RO_ROWS
  float* smask = red + 2 * RO_ROWS;                // 2 stages x RO_KC
  const int n0 = blockIdx.x * RO_ROWS, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Affinity: rows 16*ar, keys 32*ac. w.V: rows 16*ar, columns 256*ac.
  const int ar = warp & 3, ac = warp >> 2;
  const bf16* kb = keys + (size_t)k * stride_k;
  const bf16* vb = values + (size_t)k * stride_v;
  const float* st = stats + (size_t)k * 3 * N;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nch = (j_end - j_begin + RO_KC - 1) / RO_KC;

  float th[2], mx[2], wpart[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = min(n0 + ar * 16 + g + 8 * h, N - 1);
    th[h] = st[n];
    mx[h] = st[N + n];
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  stage_rows_sw128<RO_ROWS>(sqh, q_hi, n0, N);
  stage_rows_sw128<RO_ROWS>(sql, q_lo, n0, N);
  stage_rows_sw128<RO_KC>(sk, kb, j_begin, M);
  stage_values<RO_KC>(sv, vb, j_begin, M);
  if (mask) stage_mask<RO_KC>(smask, mask, j_begin, M);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int j0 = j_begin + c * RO_KC, buf = c & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // chunk c landed; chunk c-1's stage and w tile are free
    if (c + 1 < nch) {
      stage_rows_sw128<RO_KC>(sk + (buf ^ 1) * RO_KC * CK, kb, j0 + RO_KC, M);
      stage_values<RO_KC>(sv + (buf ^ 1) * RO_KC * CV, vb, j0 + RO_KC, M);
      if (mask) stage_mask<RO_KC>(smask + (buf ^ 1) * RO_KC, mask, j0 + RO_KC, M);
      cp_async_commit();
    }
    // Split affinity of this warpgroup's 32 keys: K step kk reads columns
    // 16*kk.. of the query halves and keys, in half kk/4 at byte 32*(kk%4).
    float sa[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sa[i] = 0.f;
    const char* qh = reinterpret_cast<const char*>(sqh);
    const char* ql = reinterpret_cast<const char*>(sql);
    const char* kc = reinterpret_cast<const char*>(sk + buf * RO_KC * CK) + ac * 32 * 128;
    wgmma_fence_operands<16>(sa);   // the zeros are written before the fence
    wgmma_fence();
    wgmma_fence_operands<16>(sa);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const int qo = (kk >> 2) * RO_ROWS * 128 + (kk & 3) * 32;
      const uint64_t dk =
          gmma_desc_sw128(kc + (kk >> 2) * RO_KC * 128 + (kk & 3) * 32, 16, SW_ATOM);
      wgmma_64x32x16_ss(sa, gmma_desc_sw128(qh + qo, 16, SW_ATOM), dk);
      wgmma_64x32x16_ss(sa, gmma_desc_sw128(ql + qo, 16, SW_ATOM), dk);
    }
    wgmma_commit_and_wait();
    wgmma_fence_operands<16>(sa);
    const float* sm = mask ? smask + buf * RO_KC : nullptr;
    const bool tail = j0 + RO_KC > M;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ac * 32 + nt * 8 + t4 * 2;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sa[4 * nt + 2 * h + e];
          if (sm) a += sm[col + e];
          if (tail && j0 + col + e >= M) a = NEG_INF;
          w[e] = 0.f;
          if (a >= th[h]) {
            w[e] = expf(__fsub_rn(a, mx[h]));
            wpart[h] += w[e];
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(sw + (ar * 16 + g + 8 * h) * WSB + col) =
            __floats2bfloat162_rn(w[0], w[1]);
      }
    __syncthreads();   // the w tile is complete
    uint32_t a[RO_KC / 16][4];
#pragma unroll
    for (int ks = 0; ks < RO_KC / 16; ++ks)
      ldmatrix_x4(a[ks], sw + (ar * 16 + (lane & 15)) * WSB + ks * 16 + (lane >> 4) * 8);
    const char* vs =
        reinterpret_cast<const char*>(sv + buf * RO_KC * CV) + ac * (CV / 128) * V_NATOM;
    wgmma_fence();
    wgmma_fence_operands<128>(acc);
#pragma unroll
    for (int ks = 0; ks < RO_KC / 16; ++ks)
      wgmma_64x256x16(acc, a[ks], gmma_desc_sw128(vs + ks * 2 * V_KATOM, V_NATOM, V_KATOM));
    wgmma_commit_and_wait();
    wgmma_fence_operands<128>(acc);
  }

  // Partial sum(w) per row: over the 4 lanes of a row, then the 2 key halves.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = wpart[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t4 == 0) red[ac * RO_ROWS + ar * 16 + g + 8 * h] = v;
  }
  __syncthreads();
  const size_t plane = (size_t)s * K + k;
  if (tid < RO_ROWS && n0 + tid < N)
    ws_sum[plane * N + n0 + tid] = red[tid] + red[RO_ROWS + tid];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + ar * 16 + g + 8 * h;
    if (n >= N) continue;
    float* orow = ws_acc + (plane * N + n) * CV + ac * (CV / 2) + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < CV / 16; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
  }
}

// wgmma (sm_90a): D (64 x 16 fp32, 8 registers a thread, the m16n8
// fragment layout per warp and n-tile) += A (64 x 16 bf16) x B (16 x 16
// bf16), both K-major in shared memory, described by `da` and `db`.
__device__ __forceinline__ void wgmma_64x16x16_ss(float d[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// Phase B for fp32 banks. Replaces _readout_kernel
// (mivos_tpu/ops/pallas/memory_read.py:284). readout_bf16_kernel on the
// bf16 planes of the keys and values, in 32-key chunks: two stages of
// both planes of a 64-key chunk's values alone would take 256 KB. Per
// chunk warpgroup g computes the affinity of keys 16*g.. (wgmma m64n16k16,
// 8 K steps x 3 passes: q_hi.k_hi, q_hi.k_lo, q_lo.k_hi), each warp forms
// w for its 16 rows, keeps sum(w) in fp32 of the unrounded w and stores
// w_hi = bf16(w) and w_lo = bf16(w - w_hi) in shared memory; then each
// warpgroup adds w_hi.v_hi, w_lo.v_hi and w_hi.v_lo for its 256 value
// columns (wgmma m64n256k16, A = the w tiles loaded by ldmatrix), per K
// step of 16 keys in that order. Bounded by the tensor cores: 3 affinity
// passes and 3 w.V passes, 2.3x the FLOPs of the bf16-bank readout.
// Writes (S, K, N, 512) partial sums and (S, K, N) partial sum(w).
constexpr int RF32_KC = 32;                      // keys per chunk
constexpr int WSF = RF32_KC + 8;                 // shared row stride of the w tiles (80 B)
constexpr int VF_NATOM = (RF32_KC / 8) * V_KATOM;  // bytes between value atoms along N
constexpr size_t kReadoutF32Smem =
    (size_t)(2 * RO_ROWS * CK + 4 * RF32_KC * CK + 4 * RF32_KC * CV + 2 * RO_ROWS * WSF) *
        sizeof(bf16) +
    (size_t)(2 * RO_ROWS + 2 * RF32_KC) * sizeof(float);
static_assert(SPLIT_ALIGN % RF32_KC == 0, "chunks tile the M ranges");

__global__ void __launch_bounds__(THREADS, 1)
readout_f32_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                   const bf16* __restrict__ k_hi, const bf16* __restrict__ k_lo,
                   const bf16* __restrict__ v_hi, const bf16* __restrict__ v_lo,
                   const float* __restrict__ mask, const float* __restrict__ stats,
                   float* __restrict__ ws_acc, float* __restrict__ ws_sum, int N, int M,
                   int S) {
  constexpr int KCH = RF32_KC, KP = KCH * CK, VP = KCH * CV;  // one plane's chunk
  extern __shared__ __align__(1024) uint4 smem_u4[];
  bf16* sqh = reinterpret_cast<bf16*>(smem_u4);   // RO_ROWS x CK, K-major swizzled
  bf16* sql = sqh + RO_ROWS * CK;                 // RO_ROWS x CK, K-major swizzled
  bf16* sk = sql + RO_ROWS * CK;                  // [stage][hi, lo] x KCH x CK, K-major swizzled
  bf16* sv = sk + 4 * KP;                         // [stage][hi, lo] x KCH x CV, N-major swizzled
  bf16* swh = sv + 4 * VP;                        // RO_ROWS x WSF: w_hi
  bf16* swl = swh + RO_ROWS * WSF;                // RO_ROWS x WSF: w_lo
  float* red = reinterpret_cast<float*>(swl + RO_ROWS * WSF);  // 2 x RO_ROWS
  float* smask = red + 2 * RO_ROWS;               // 2 stages x KCH
  const int n0 = blockIdx.x * RO_ROWS, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  // Affinity: rows 16*ar, keys 16*ac. w.V: rows 16*ar, columns 256*ac.
  const int ar = warp & 3, ac = warp >> 2;
  const bf16* kh = k_hi + (size_t)k * M * CK;
  const bf16* kl = k_lo + (size_t)k * M * CK;
  const bf16* vh = v_hi + (size_t)k * M * CV;
  const bf16* vl = v_lo + (size_t)k * M * CV;
  const float* st = stats + (size_t)k * 3 * N;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nch = (j_end - j_begin + KCH - 1) / KCH;

  float th[2], mx[2], wpart[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = min(n0 + ar * 16 + g + 8 * h, N - 1);
    th[h] = st[n];
    mx[h] = st[N + n];
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  auto stage = [&](int buf, int j0) {
    stage_rows_sw128<KCH>(sk + 2 * buf * KP, kh, j0, M);
    stage_rows_sw128<KCH>(sk + (2 * buf + 1) * KP, kl, j0, M);
    stage_values<KCH>(sv + 2 * buf * VP, vh, j0, M);
    stage_values<KCH>(sv + (2 * buf + 1) * VP, vl, j0, M);
    if (mask) stage_mask<KCH>(smask + buf * KCH, mask, j0, M);
  };
  stage_rows_sw128<RO_ROWS>(sqh, q_hi, n0, N);
  stage_rows_sw128<RO_ROWS>(sql, q_lo, n0, N);
  stage(0, j_begin);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int j0 = j_begin + c * KCH, buf = c & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // chunk c landed; chunk c-1's stage and w tiles are free
    if (c + 1 < nch) {
      stage(buf ^ 1, j0 + KCH);
      cp_async_commit();
    }
    // Split affinity of this warpgroup's 16 keys: K step kk reads columns
    // 16*kk.. of the query halves and key planes, in half kk/4 at byte
    // 32*(kk%4).
    float sa[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sa[i] = 0.f;
    const char* qhc = reinterpret_cast<const char*>(sqh);
    const char* qlc = reinterpret_cast<const char*>(sql);
    const char* khc = reinterpret_cast<const char*>(sk + 2 * buf * KP) + ac * 16 * 128;
    const char* klc = reinterpret_cast<const char*>(sk + (2 * buf + 1) * KP) + ac * 16 * 128;
    wgmma_fence_operands<8>(sa);   // the zeros are written before the fence
    wgmma_fence();
    wgmma_fence_operands<8>(sa);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const int qo = (kk >> 2) * RO_ROWS * 128 + (kk & 3) * 32;
      const int ko = (kk >> 2) * KCH * 128 + (kk & 3) * 32;
      const uint64_t dqh = gmma_desc_sw128(qhc + qo, 16, SW_ATOM);
      const uint64_t dkh = gmma_desc_sw128(khc + ko, 16, SW_ATOM);
      wgmma_64x16x16_ss(sa, dqh, dkh);
      wgmma_64x16x16_ss(sa, dqh, gmma_desc_sw128(klc + ko, 16, SW_ATOM));
      wgmma_64x16x16_ss(sa, gmma_desc_sw128(qlc + qo, 16, SW_ATOM), dkh);
    }
    wgmma_commit_and_wait();
    wgmma_fence_operands<8>(sa);
    const float* sm = mask ? smask + buf * KCH : nullptr;
    const bool tail = j0 + KCH > M;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = ac * 16 + nt * 8 + t4 * 2;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = sa[4 * nt + 2 * h + e];
          if (sm) a += sm[col + e];
          if (tail && j0 + col + e >= M) a = NEG_INF;
          w[e] = 0.f;
          if (a >= th[h]) {
            w[e] = expf(__fsub_rn(a, mx[h]));
            wpart[h] += w[e];
          }
        }
        const __nv_bfloat162 whi = __floats2bfloat162_rn(w[0], w[1]);
        const int at = (ar * 16 + g + 8 * h) * WSF + col;
        *reinterpret_cast<__nv_bfloat162*>(swh + at) = whi;
        *reinterpret_cast<__nv_bfloat162*>(swl + at) = __floats2bfloat162_rn(
            __fsub_rn(w[0], __low2float(whi)), __fsub_rn(w[1], __high2float(whi)));
      }
    __syncthreads();   // the w tiles are complete
    uint32_t ah[KCH / 16][4], al[KCH / 16][4];
#pragma unroll
    for (int ks = 0; ks < KCH / 16; ++ks) {
      const int at = (ar * 16 + (lane & 15)) * WSF + ks * 16 + (lane >> 4) * 8;
      ldmatrix_x4(ah[ks], swh + at);
      ldmatrix_x4(al[ks], swl + at);
    }
    const char* vhs =
        reinterpret_cast<const char*>(sv + 2 * buf * VP) + ac * (CV / 128) * VF_NATOM;
    const char* vls =
        reinterpret_cast<const char*>(sv + (2 * buf + 1) * VP) + ac * (CV / 128) * VF_NATOM;
    wgmma_fence();
    wgmma_fence_operands<128>(acc);
#pragma unroll
    for (int ks = 0; ks < KCH / 16; ++ks) {
      const uint64_t dvh = gmma_desc_sw128(vhs + ks * 2 * V_KATOM, VF_NATOM, V_KATOM);
      wgmma_64x256x16(acc, ah[ks], dvh);
      wgmma_64x256x16(acc, al[ks], dvh);
      wgmma_64x256x16(acc, ah[ks], gmma_desc_sw128(vls + ks * 2 * V_KATOM, VF_NATOM, V_KATOM));
    }
    wgmma_commit_and_wait();
    wgmma_fence_operands<128>(acc);
  }

  // Partial sum(w) per row: over the 4 lanes of a row, then the 2 key halves.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = wpart[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (t4 == 0) red[ac * RO_ROWS + ar * 16 + g + 8 * h] = v;
  }
  __syncthreads();
  const size_t plane = (size_t)s * K + k;
  if (tid < RO_ROWS && n0 + tid < N)
    ws_sum[plane * N + n0 + tid] = red[tid] + red[RO_ROWS + tid];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + ar * 16 + g + 8 * h;
    if (n >= N) continue;
    float* orow = ws_acc + (plane * N + n) * CV + ac * (CV / 2) + t4 * 2;
#pragma unroll
    for (int nt = 0; nt < CV / 16; ++nt)
      *reinterpret_cast<float2*>(orow + nt * 8) =
          make_float2(acc[4 * nt + 2 * h], acc[4 * nt + 2 * h + 1]);
  }
}

// The bf16 planes of an fp32 bank, the split the JAX kernel's _affinity
// makes of each fp32 key tile (pallas/memory_read.py:108-113): hi =
// bf16(x), lo = bf16(x - hi), each written (K, rows, C) contiguous from
// the K objects of `src` (object stride `stride` elements, rows
// contiguous). Four elements a step; bounded by the bytes (4 read, 4
// written an element).
__global__ void __launch_bounds__(THREADS)
hilo_planes_kernel(const float* __restrict__ src, long long stride, long long per_obj4,
                   long long total4, bf16* __restrict__ hi, bf16* __restrict__ lo) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < total4;
       i += (long long)gridDim.x * THREADS) {
    const long long k = i / per_obj4;
    const float4 x =
        *reinterpret_cast<const float4*>(src + k * stride + 4 * (i - k * per_obj4));
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(x.z, x.w);
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(__fsub_rn(x.x, __low2float(h0)),
                                                    __fsub_rn(x.y, __high2float(h0)));
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(__fsub_rn(x.z, __low2float(h1)),
                                                    __fsub_rn(x.w, __high2float(h1)));
    reinterpret_cast<__nv_bfloat162*>(hi)[2 * i] = h0;
    reinterpret_cast<__nv_bfloat162*>(hi)[2 * i + 1] = h1;
    reinterpret_cast<__nv_bfloat162*>(lo)[2 * i] = l0;
    reinterpret_cast<__nv_bfloat162*>(lo)[2 * i + 1] = l1;
  }
}

// Merge of phase B's ranges: sum_s acc_s / sum_s (sum w)_s in range order.
// One block of 128 threads per (object, row), 4 columns a thread.
__global__ void __launch_bounds__(CV / 4)
readout_merge_kernel(const float* __restrict__ ws_acc,
                     const float* __restrict__ ws_sum, float* __restrict__ out,
                     int K, int N, int S) {
  const size_t row = blockIdx.x, rows = (size_t)K * N;
  const int c = threadIdx.x * 4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float wsum = 0.f;
  for (int s = 0; s < S; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(ws_acc + (s * rows + row) * CV + c);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
    wsum += ws_sum[s * rows + row];
  }
  *reinterpret_cast<float4*>(out + row * CV + c) =
      make_float4(__fdiv_rn(a.x, wsum), __fdiv_rn(a.y, wsum), __fdiv_rn(a.z, wsum),
                  __fdiv_rn(a.w, wsum));
}

// ---------------------------------------------------------------------------
// Refine for bf16 banks. Replaces _refine_kernel
// (mivos_tpu/ops/pallas/memory_read.py:221). 64 query rows and one
// warpgroup a block, 64-key chunks. The query halves are staged once and
// then held in registers as wgmma's A fragments (warp w: rows 16*w..,
// the mma.sync A fragment per K step, 64 registers), so each wgmma reads
// only the keys from shared memory. The accumulator is the m16n8
// fragment per n-tile: lane (g, t4) owns rows g and g + 8 at columns
// 8*nt + 2*t4 and +1. Writes (S, K, N, 7) int32 counts.
constexpr int RF_ROWS = 64;
constexpr int RF_KC = 64;
constexpr int RF_THREADS = 128;
constexpr size_t kRefineBf16Smem =
    (size_t)(2 * RF_KC * CK + 2 * RF_ROWS * QSB) * sizeof(bf16) + 2 * RF_KC * sizeof(float);
// Blocks an SM holds: 228 KB of shared memory, 1 KB of it reserved per block.
constexpr int RF_SM_BLOCKS = (int)(228 * 1024 / (kRefineBf16Smem + 1024));
static_assert(SPLIT_ALIGN % RF_KC == 0, "chunks tile the M ranges");

// wgmma (sm_90a): D (64 x 64 fp32) += A (64 x 16 bf16 in registers, the
// mma.sync A fragment of rows 16*warp..) x B (16 x 64 bf16, K-major in
// shared memory, described by `db`).
__device__ __forceinline__ void wgmma_64x64x16_rs(float d[32], const uint32_t a[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Refine's per-thread state in both refine kernels: lane (g, t4) of warp
// w owns rows n0 + 16*w + g and + 8 (h = 0, 1), their 7 edges and counts.
__device__ __forceinline__ void refine_edges(const float* sin, int N, int row0,
                                             float edge[2][N_EDGES], int cnt[2][N_EDGES]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = min(row0 + 8 * h, N - 1);
    const float th = sin[n], delta = refine_delta(th, sin[2 * N + n]);
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e) {
      edge[h][e] = refine_edge(th, delta, e);
      cnt[h][e] = 0;
    }
  }
}

// Refine's counts from one chunk's 64 x KCH accumulator (the m16n8
// fragment per n-tile): one compare per entry against its row's lowest
// edge; the edges are nondecreasing, so an entry below it reaches none.
// Keys from `live` on (past M, inside the last chunk) count for nothing.
template <int KCH>
__device__ __forceinline__ void refine_count(const float* acc, const float* sm, int live,
                                             float edge[2][N_EDGES],
                                             int cnt[2][N_EDGES]) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < KCH / 8; ++nt) {
    const int col = nt * 8 + t4 * 2;
    const float2 mk = sm ? *reinterpret_cast<const float2*>(sm + col)
                         : make_float2(0.f, 0.f);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        float a = acc[4 * nt + 2 * h + e2];
        if (sm) a += e2 ? mk.y : mk.x;
        if (a >= edge[h][0] && col + e2 < live) {
#pragma unroll
          for (int e = 0; e < N_EDGES; ++e) cnt[h][e] += a >= edge[h][e];
        }
      }
  }
}

// Per row the four lanes of a quad hold its columns: they add their
// counts, and lane t4 = 0 writes the row's 7 to `o` (the block's object
// and range in the (S, K, N, 7) workspace).
__device__ __forceinline__ void refine_write_counts(int cnt[2][N_EDGES], int* o, int N,
                                                    int row0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e) {
      cnt[h][e] += __shfl_xor_sync(0xffffffffu, cnt[h][e], 1);
      cnt[h][e] += __shfl_xor_sync(0xffffffffu, cnt[h][e], 2);
    }
    const int n = row0 + 8 * h;
    if ((threadIdx.x & 3) == 0 && n < N) {
#pragma unroll
      for (int e = 0; e < N_EDGES; ++e) o[(size_t)n * N_EDGES + e] = cnt[h][e];
    }
  }
}

__global__ void __launch_bounds__(RF_THREADS, RF_SM_BLOCKS)
refine_bf16_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                   const bf16* __restrict__ keys, long long stride_k,
                   const float* __restrict__ mask, const float* __restrict__ stats_in,
                   int* __restrict__ ws, int N, int M, int S) {
  extern __shared__ __align__(1024) uint4 smem_u4[];
  bf16* sk = reinterpret_cast<bf16*>(smem_u4);    // 2 stages x RF_KC x CK, K-major swizzled
  bf16* sqh = sk + 2 * RF_KC * CK;                // RF_ROWS x QSB
  bf16* sql = sqh + RF_ROWS * QSB;                // RF_ROWS x QSB
  float* smask = reinterpret_cast<float*>(sql + RF_ROWS * QSB);  // 2 stages x RF_KC
  const int n0 = blockIdx.x * RF_ROWS, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bf16* kb = keys + (size_t)k * stride_k;
  const float* sin = stats_in + (size_t)k * 3 * N;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nch = (j_end - j_begin + RF_KC - 1) / RF_KC;

  const int row0 = n0 + warp * 16 + g;   // this lane's rows: row0 and row0 + 8
  float edge[2][N_EDGES];
  int cnt[2][N_EDGES];
  refine_edges(sin, N, row0, edge, cnt);

  stage_rows<RF_ROWS, CK, QSB, RF_THREADS>(sqh, q_hi, n0, N);
  stage_rows<RF_ROWS, CK, QSB, RF_THREADS>(sql, q_lo, n0, N);
  stage_rows_sw128<RF_KC, RF_THREADS>(sk, kb, j_begin, M);
  if (mask) stage_mask<RF_KC>(smask, mask, j_begin, M);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t ah[CK / 16][4], al[CK / 16][4];
  const int qoff = (warp * 16 + (lane & 15)) * QSB + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    ldmatrix_x4(ah[kk], sqh + qoff + kk * 16);
    ldmatrix_x4(al[kk], sql + qoff + kk * 16);
  }
  for (int c = 0; c < nch; ++c) {
    const int j0 = j_begin + c * RF_KC, buf = c & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // chunk c landed; chunk c-1's stage is free
    if (c + 1 < nch) {
      stage_rows_sw128<RF_KC, RF_THREADS>(sk + (buf ^ 1) * RF_KC * CK, kb, j0 + RF_KC, M);
      if (mask) stage_mask<RF_KC>(smask + (buf ^ 1) * RF_KC, mask, j0 + RF_KC, M);
      cp_async_commit();
    }
    // Split affinity, the readout's order: per K step kk (key columns
    // 16*kk.., in half kk/4 at byte 32*(kk%4)) the q_hi pass, then q_lo.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const char* kc = reinterpret_cast<const char*>(sk + buf * RF_KC * CK);
    wgmma_fence_operands<32>(acc);
    wgmma_fence();
    wgmma_fence_operands<32>(acc);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const uint64_t dk =
          gmma_desc_sw128(kc + (kk >> 2) * RF_KC * 128 + (kk & 3) * 32, 16, SW_ATOM);
      wgmma_64x64x16_rs(acc, ah[kk], dk);
      wgmma_64x64x16_rs(acc, al[kk], dk);
    }
    wgmma_commit_and_wait();
    wgmma_fence_operands<32>(acc);
    refine_count<RF_KC>(acc, mask ? smask + buf * RF_KC : nullptr, M - j0, edge, cnt);
  }
  refine_write_counts(cnt, ws + ((size_t)s * K + k) * N * N_EDGES, N, row0);
}

// Refine for fp32 banks. Replaces _refine_kernel
// (mivos_tpu/ops/pallas/memory_read.py:221). refine_bf16_kernel on the
// keys' bf16 planes: 64 query rows and one warpgroup a block, 64-key
// chunks of both planes (and the mask's chunk) through the two-stage
// cp.async ring, and per K step the three passes q_hi.k_hi, q_hi.k_lo,
// q_lo.k_hi on wgmma.m64n64k16 into one fp32 accumulator, in
// readout_f32_kernel's order. The query halves are staged once, K-major
// in the 128-byte swizzle, into the ring's second stage, loaded from
// there into registers as wgmma's A fragments, and the ring takes the
// stage back for chunk 1: 64.5 KB a block, three blocks an SM, as the
// bf16 kernel. Writes (S, K, N, 7) int32 counts.
constexpr int RFH_KC = 64;
constexpr size_t kRefineHiloSmem =
    (size_t)4 * RFH_KC * CK * sizeof(bf16) + 2 * RFH_KC * sizeof(float);
constexpr int RFH_SM_BLOCKS = (int)(228 * 1024 / (kRefineHiloSmem + 1024));
static_assert(SPLIT_ALIGN % RFH_KC == 0, "chunks tile the M ranges");
static_assert(RFH_KC >= RF_ROWS, "the query halves fit the ring's second stage");

__global__ void __launch_bounds__(RF_THREADS, RFH_SM_BLOCKS)
refine_hilo_kernel(const bf16* __restrict__ q_hi, const bf16* __restrict__ q_lo,
                   const bf16* __restrict__ k_hi, const bf16* __restrict__ k_lo,
                   const float* __restrict__ mask, const float* __restrict__ stats_in,
                   int* __restrict__ ws, int N, int M, int S) {
  constexpr int KP = RFH_KC * CK;   // one plane's chunk
  extern __shared__ __align__(1024) uint4 smem_u4[];
  bf16* sk = reinterpret_cast<bf16*>(smem_u4);  // [stage][hi, lo] x RFH_KC x CK, K-major swizzled
  bf16* sqh = sk + 2 * KP;                      // RF_ROWS x CK, K-major swizzled, in stage 1
  bf16* sql = sqh + RF_ROWS * CK;               // until the halves are in registers
  float* smask = reinterpret_cast<float*>(sk + 4 * KP);  // 2 stages x RFH_KC
  const int n0 = blockIdx.x * RF_ROWS, s = blockIdx.y, k = blockIdx.z, K = gridDim.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const bf16* kh = k_hi + (size_t)k * M * CK;
  const bf16* kl = k_lo + (size_t)k * M * CK;
  const float* sin = stats_in + (size_t)k * 3 * N;
  int j_begin, j_end;
  split_range(M, S, s, j_begin, j_end);
  const int nch = (j_end - j_begin + RFH_KC - 1) / RFH_KC;

  const int row0 = n0 + warp * 16 + g;   // this lane's rows: row0 and row0 + 8
  float edge[2][N_EDGES];
  int cnt[2][N_EDGES];
  refine_edges(sin, N, row0, edge, cnt);

  auto stage = [&](int buf, int j0) {
    stage_rows_sw128<RFH_KC, RF_THREADS>(sk + 2 * buf * KP, kh, j0, M);
    stage_rows_sw128<RFH_KC, RF_THREADS>(sk + (2 * buf + 1) * KP, kl, j0, M);
    if (mask) stage_mask<RFH_KC>(smask + buf * RFH_KC, mask, j0, M);
  };
  stage_rows_sw128<RF_ROWS, RF_THREADS>(sqh, q_hi, n0, N);
  stage_rows_sw128<RF_ROWS, RF_THREADS>(sql, q_lo, n0, N);
  stage(0, j_begin);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // The A fragment of K step kk: lane l gives row 16*warp + l%16, 16-byte
  // chunk 2*(kk%4) + l/16 of half kk/4, stored at chunk ^ (row % 8).
  uint32_t ah[CK / 16][4], al[CK / 16][4];
  const int qr = warp * 16 + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < CK / 16; ++kk) {
    const int at = (kk >> 2) * RF_ROWS * 128 + qr * 128 +
                   (((2 * (kk & 3) + (lane >> 4)) ^ (qr & 7)) << 4);
    ldmatrix_x4(ah[kk], reinterpret_cast<const char*>(sqh) + at);
    ldmatrix_x4(al[kk], reinterpret_cast<const char*>(sql) + at);
  }
  for (int c = 0; c < nch; ++c) {
    const int j0 = j_begin + c * RFH_KC, buf = c & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();   // chunk c landed; chunk c-1's stage (at c = 0 the query) is free
    if (c + 1 < nch) {
      stage(buf ^ 1, j0 + RFH_KC);
      cp_async_commit();
    }
    // Three-pass split affinity: per K step kk (key columns 16*kk.., in
    // half kk/4 at byte 32*(kk%4)) q_hi.k_hi, q_hi.k_lo, then q_lo.k_hi.
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    const char* khc = reinterpret_cast<const char*>(sk + 2 * buf * KP);
    const char* klc = reinterpret_cast<const char*>(sk + (2 * buf + 1) * KP);
    wgmma_fence_operands<32>(acc);
    wgmma_fence();
    wgmma_fence_operands<32>(acc);
#pragma unroll
    for (int kk = 0; kk < CK / 16; ++kk) {
      const int ko = (kk >> 2) * RFH_KC * 128 + (kk & 3) * 32;
      const uint64_t dkh = gmma_desc_sw128(khc + ko, 16, SW_ATOM);
      wgmma_64x64x16_rs(acc, ah[kk], dkh);
      wgmma_64x64x16_rs(acc, ah[kk], gmma_desc_sw128(klc + ko, 16, SW_ATOM));
      wgmma_64x64x16_rs(acc, al[kk], dkh);
    }
    wgmma_commit_and_wait();
    wgmma_fence_operands<32>(acc);
    refine_count<RFH_KC>(acc, mask ? smask + buf * RFH_KC : nullptr, M - j0, edge, cnt);
  }
  refine_write_counts(cnt, ws + ((size_t)s * K + k) * N * N_EDGES, N, row0);
}

// Merge of refine's ranges: per (object, row) the sum of the S ranges'
// counts, then the update of the stats.
__global__ void __launch_bounds__(THREADS)
refine_merge_kernel(const int* __restrict__ ws, const float* __restrict__ stats_in,
                    float* __restrict__ stats_out, int K, int N, int S, int top_k) {
  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= K * N) return;
  int cnt[N_EDGES] = {0, 0, 0, 0, 0, 0, 0};
  for (int s = 0; s < S; ++s) {
    const int* p = ws + ((size_t)s * K * N + row) * N_EDGES;
#pragma unroll
    for (int e = 0; e < N_EDGES; ++e) cnt[e] += p[e];
  }
  const int k = row / N, n = row % N;
  refine_update(cnt, stats_in + (size_t)k * 3 * N, stats_out + (size_t)k * 3 * N, n, N,
                top_k);
}

// ---------------------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

// Plain C interface (loaded with ctypes). Each function launches on
// `stream`, does not synchronise, and returns cudaGetLastError() after
// the launch (0 = success). S is the number of M ranges; the workspaces
// are (S, K, N, 4, 256) fp32 for phase A, (S, K, N, 7) int32 for refine
// and (S, K, N, 512) plus (S, K, N) fp32 for phase B. The *_hilo
// functions take an fp32 bank as the bf16 planes mr_hilo_planes writes.
extern "C" {

int mr_hilo_planes(const void* src, long long stride, int K, int M, int C, void* hi,
                   void* lo, void* stream) {
  const long long per_obj4 = (long long)M * C / 4, total4 = per_obj4 * K;
  const int blocks = (int)std::min<long long>((total4 + THREADS - 1) / THREADS, 4096);
  hilo_planes_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), stride, per_obj4, total4, static_cast<bf16*>(hi),
      static_cast<bf16*>(lo));
  return (int)cudaGetLastError();
}

int mr_candidates_hilo(const void* q_hi, const void* q_lo, const void* k_hi,
                       const void* k_lo, const void* mask, void* ws, int K, int N, int M,
                       int S, void* stream) {
  if (int e = set_smem(candidates_f32_kernel, kCandidatesF32Smem)) return e;
  dim3 grid((N + TR - 1) / TR, S, K);
  candidates_f32_kernel<<<grid, CAND_THREADS, kCandidatesF32Smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(k_hi), static_cast<const bf16*>(k_lo),
      static_cast<const float*>(mask), static_cast<float*>(ws), N, M, S);
  return (int)cudaGetLastError();
}

int mr_candidates_bf16(const void* q_hi, const void* q_lo, const void* keys,
                       long long stride_k, const void* mask, void* ws, int K,
                       int N, int M, int S, void* stream) {
  if (int e = set_smem(candidates_bf16_kernel, kCandidatesBf16Smem)) return e;
  dim3 grid((N + TR - 1) / TR, S, K);
  candidates_bf16_kernel<<<grid, CAND_THREADS, kCandidatesBf16Smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(keys), stride_k, static_cast<const float*>(mask),
      static_cast<float*>(ws), N, M, S);
  return (int)cudaGetLastError();
}

int mr_candidates_merge(const void* ws, void* stats, int K, int N, int S,
                        int top_k, void* stream) {
  const int rows_per_block = THREADS / 32;
  candidates_merge_kernel<<<(K * N + rows_per_block - 1) / rows_per_block, THREADS,
                            0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(stats), K, N, S, top_k);
  return (int)cudaGetLastError();
}

int mr_refine_bf16(const void* q_hi, const void* q_lo, const void* keys,
                   long long stride_k, const void* mask, const void* stats_in,
                   void* ws, int K, int N, int M, int S, void* stream) {
  if (int e = set_smem(refine_bf16_kernel, kRefineBf16Smem)) return e;
  dim3 grid((N + RF_ROWS - 1) / RF_ROWS, S, K);
  refine_bf16_kernel<<<grid, RF_THREADS, kRefineBf16Smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(keys), stride_k, static_cast<const float*>(mask),
      static_cast<const float*>(stats_in), static_cast<int*>(ws), N, M, S);
  return (int)cudaGetLastError();
}

int mr_refine_hilo(const void* q_hi, const void* q_lo, const void* k_hi, const void* k_lo,
                   const void* mask, const void* stats_in, void* ws, int K, int N, int M,
                   int S, void* stream) {
  if (int e = set_smem(refine_hilo_kernel, kRefineHiloSmem)) return e;
  dim3 grid((N + RF_ROWS - 1) / RF_ROWS, S, K);
  refine_hilo_kernel<<<grid, RF_THREADS, kRefineHiloSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(k_hi), static_cast<const bf16*>(k_lo),
      static_cast<const float*>(mask), static_cast<const float*>(stats_in),
      static_cast<int*>(ws), N, M, S);
  return (int)cudaGetLastError();
}

int mr_refine_merge(const void* ws, const void* stats_in, void* stats_out, int K,
                    int N, int S, int top_k, void* stream) {
  refine_merge_kernel<<<(K * N + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ws), static_cast<const float*>(stats_in),
      static_cast<float*>(stats_out), K, N, S, top_k);
  return (int)cudaGetLastError();
}

int mr_readout_hilo(const void* q_hi, const void* q_lo, const void* k_hi,
                    const void* k_lo, const void* v_hi, const void* v_lo, const void* mask,
                    const void* stats, void* ws_acc, void* ws_sum, int K, int N, int M,
                    int S, void* stream) {
  if (int e = set_smem(readout_f32_kernel, kReadoutF32Smem)) return e;
  dim3 grid((N + RO_ROWS - 1) / RO_ROWS, S, K);
  readout_f32_kernel<<<grid, THREADS, kReadoutF32Smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(k_hi), static_cast<const bf16*>(k_lo),
      static_cast<const bf16*>(v_hi), static_cast<const bf16*>(v_lo),
      static_cast<const float*>(mask), static_cast<const float*>(stats),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_sum), N, M, S);
  return (int)cudaGetLastError();
}

int mr_readout_bf16(const void* q_hi, const void* q_lo, const void* keys,
                    long long stride_k, const void* values, long long stride_v,
                    const void* mask, const void* stats, void* ws_acc, void* ws_sum,
                    int K, int N, int M, int S, void* stream) {
  if (int e = set_smem(readout_bf16_kernel, kReadoutBf16Smem)) return e;
  dim3 grid((N + RO_ROWS - 1) / RO_ROWS, S, K);
  readout_bf16_kernel<<<grid, THREADS, kReadoutBf16Smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q_hi), static_cast<const bf16*>(q_lo),
      static_cast<const bf16*>(keys), stride_k, static_cast<const bf16*>(values),
      stride_v, static_cast<const float*>(mask), static_cast<const float*>(stats),
      static_cast<float*>(ws_acc), static_cast<float*>(ws_sum), N, M, S);
  return (int)cudaGetLastError();
}

int mr_readout_merge(const void* ws_acc, const void* ws_sum, void* out, int K,
                     int N, int S, void* stream) {
  readout_merge_kernel<<<K * N, CV / 4, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws_acc), static_cast<const float*>(ws_sum),
      static_cast<float*>(out), K, N, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
