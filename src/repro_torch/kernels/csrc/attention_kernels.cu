// Hopper (sm_90a) flash attention prefill in bf16 on the tensor cores.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes, as model_kernels.cu: the launcher takes device
// pointers and the caller's stream, launches without synchronising and
// returns cudaGetLastError().  The wrapper (flash_attention.py) checks
// device, dtype, shape and alignment before it calls in.
//
// ---------------------------------------------------------------------------
// flash_prefill_kernel (replaces src/repro/kernels/flash_attention.py:106,
// flash_attention, for bf16 prefill at head dims 64, 128 and 256, and at
// MLA's q / k head dim 192 with a v head dim of 128).
//
// Bound: operations.  At recurrentgemma-2b prefill (B 4, Sq = Skv 2560, 10
// query heads of 256 on one KV head, window 2048) the 3,146,752 visible
// pairs per head cost 4*D FLOPs each, 128.9 GFLOP a layer: 0.130 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against 115 MB (34 us) of q, k, v and
// out.  The SIMT kernel did these FMAs on the CUDA cores in fp32 (9.2 ms).
//
// Design.  One block of one warpgroup (128 threads) per (64 query rows,
// query head h, batch b); query head h reads KV head h / G.  Both products
// run as wgmma m64n64k16 with bf16 operands and fp32 accumulators:
//   S = Q K^T: A (Q) and B (K) from shared memory, D/16 steps over the
//     head dim;
//   O += P V:  A (P) from registers, where the S accumulator's layout is
//     already wgmma's A-fragment layout, B (V) from shared memory read
//     transposed (MN-major); one instruction per 64 output columns.
// Q, K and V tiles sit in shared memory as 64-column blocks (64 rows x 128
// bytes), 16-byte chunks swizzled by the row (chunk c of row r at c ^ (r &
// 7)): wgmma's 128-byte swizzle layout, conflict-free for its reads.  The
// copies are cp.async of 16 bytes a lane (zero past the edge), one K and
// one V buffer: K(j+1) loads while the softmax and P V of tile j run, V(j+1)
// while S of tile j+1 runs.  That is 96 KB at D 256 (Q 32 KB, K 32, V 32),
// so two blocks fit an SM and one block's copies overlap the other's
// products.
//
// Numerics.  The scale multiplies the fp32 scores (times log2 e; the
// softmax runs in base 2), never q in bf16: 1/sqrt(D) is not a power of two
// at D 128.  P goes to the tensor cores as two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi), each multiplied with the same V tile: P in one bf16
// rounding (2^-9 relative) would move an output by an estimated ~4e-5 at
// recurrentgemma-2b, outside the 2e-5 + 2^-7 |want| check against the
// fp32 plain version; hi + lo carries p to ~2^-17.  Masked scores are
// -1e30, the row sum (fp32, summed per thread and reduced over the row's
// four lanes at the end) is floored at 1e-30.
//
// Masking.  Before the loop the block reads every key tile's positions
// once: a tile whose position range shows every pair masked (no written
// slot; causal, its least position after the block's last query; window,
// its latest position out of the first query's window) is skipped, loads
// included; a tile that shows every pair visible (all slots written, its
// latest position at or before the first query, its range inside every
// query's window) takes no per-element mask; the rest, the tiles that
// straddle a boundary, are masked element by element from the positions.
// At recurrentgemma-2b prefill about half of the 40 x 40 tile pairs of a
// head are skipped.
//
// v's head dim DV may differ from D, as in the TPU kernel: S = Q K^T takes
// D / 16 k-steps (12 at deepseek-v2-lite's MLA, D = 128 nope + 64 rope),
// and P V one instruction per 64 of DV columns (2 at DV 128).  Q and K
// tiles are 64 x D, the V tile 64 x DV: 24 + 24 + 16 KB at (192, 128).
// ---------------------------------------------------------------------------

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFpThreads = 128;  // one warpgroup
constexpr int kFpRows = 64;      // query rows of a block: wgmma's M
constexpr int kFpKeys = 64;      // keys of a K / V tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSkip = 0;    // tile codes of the pre-pass
constexpr int kMasked = 1;
constexpr int kFull = 2;

int fp_smem_bytes(int D, int DV, int Skv) {
  return kFpRows * (2 * D + DV) * 2 + 1024 +
         4 * ((Skv + kFpKeys - 1) / kFpKeys);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the generic-proxy writes of cp.async made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// one 64 x D bf16 tile (rows at `stride` elements) into the swizzled
// 64-column blocks at shared address `dst`; rows >= `valid` are zeros
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int valid, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int idx = tid; idx < kFpRows * CH; idx += kFpThreads) {
    const int r = idx / CH, c = idx % CH;
    const uint32_t off = (c >> 3) * (kFpRows * 128) + r * 128 +
                         (((c & 7) ^ (r & 7)) << 4);
    cp_async16(dst + off,
               src + static_cast<size_t>(r < valid ? r : 0) * stride + c * 8,
               r < valid);
  }
}

// a shared-memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory (scale_d 0: d =)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A B, m64n64k16, A (bf16 pairs) in registers, B MN-major in shared
// memory (transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16_pair(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int D, int DV>
__global__ void __launch_bounds__(kFpThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ qpos,
                     const int* __restrict__ kvpos,
                     __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H,
                     int K, int causal, int window, float scale) {
  constexpr int NB = DV / 64;                // 64-column blocks of O
  constexpr uint32_t kTile = kFpRows * D * 2;  // bytes of a Q or K tile
  constexpr uint32_t kTileV = kFpRows * DV * 2;  // bytes of a V tile
  constexpr uint32_t kBlock = kFpRows * 128;   // bytes of a column block
  extern __shared__ __align__(1024) unsigned char fp_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(fp_smem));
  const uint32_t Qs = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024-aligned
  const uint32_t Ks = Qs + kTile, Vs = Ks + kTile;
  int* flags = reinterpret_cast<int*>(fp_smem + (Vs + kTileV - raw));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kFpRows, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int nq = min(kFpRows, Sq - q0);
  const int ntiles = (Skv + kFpKeys - 1) / kFpKeys;

  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < nq; ++r) {
    const int p = qpos[q0 + r];
    qlo = min(qlo, p);
    qhi = max(qhi, p);
  }
  // this thread's two rows of every 64-row accumulator (padded rows take
  // the last query's position; they are not stored)
  const int row0 = warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int myq0 = qpos[q0 + min(row0, nq - 1)];
  const int myq1 = qpos[q0 + min(row1, nq - 1)];

  // the pre-pass: each key tile skipped, masked or full
  for (int j = warp; j < ntiles; j += kFpThreads / 32) {
    const int s0 = j * kFpKeys + lane, s1 = s0 + 32;
    const int p0 = s0 < Skv ? kvpos[s0] : -1;
    const int p1 = s1 < Skv ? kvpos[s1] : -1;
    const int lo = __reduce_min_sync(
        0xffffffffu, min(p0 >= 0 ? p0 : INT_MAX, p1 >= 0 ? p1 : INT_MAX));
    const int hi = __reduce_max_sync(0xffffffffu, max(p0, p1));
    const bool written = __all_sync(0xffffffffu, p0 >= 0 && p1 >= 0);
    bool run = hi >= 0, full = written;
    if (causal) {
      run = run && lo <= qhi;
      full = full && hi <= qlo;
    }
    if (window > 0) {
      run = run && qlo - hi < window;
      full = full && qhi - lo < window;
    }
    if (lane == 0) flags[j] = run ? (full ? kFull : kMasked) : kSkip;
  }
  __syncthreads();

  int j = 0;
  while (j < ntiles && flags[j] == kSkip) ++j;
  const size_t kv_row = static_cast<size_t>(K) * D;
  const size_t kv0 = static_cast<size_t>(b) * Skv * kv_row + kh * D;
  const size_t v_row = static_cast<size_t>(K) * DV;
  const size_t v0 = static_cast<size_t>(b) * Skv * v_row + kh * DV;
  load_tile<D>(Qs, q + ((static_cast<size_t>(b) * Sq + q0) * H + h) * D,
               static_cast<size_t>(H) * D, nq, tid);
  if (j < ntiles)
    load_tile<D>(Ks, k + kv0 + j * kFpKeys * kv_row, kv_row,
                 Skv - j * kFpKeys, tid);
  cp_async_commit();
  if (j < ntiles)
    load_tile<DV>(Vs, v + v0 + j * kFpKeys * v_row, v_row,
                  Skv - j * kFpKeys, tid);
  cp_async_commit();

  const float sl2 = scale * kLog2e;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float o[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[cb][i] = 0.f;

  while (j < ntiles) {
    int jn = j + 1;
    while (jn < ntiles && flags[jn] == kSkip) ++jn;
    const bool masked = flags[j] == kMasked;
    cp_async_wait<1>();  // Q and K(j) have landed
    fence_proxy_async();
    __syncthreads();

    // S = Q K^T
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * kBlock + (kk & 3) * 32;
      wgmma_ss(s, smem_desc(Qs + off, 16, 1024), smem_desc(Ks + off, 16, 1024),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    __syncthreads();  // every warp is done with K(j)
    if (jn < ntiles)
      load_tile<D>(Ks, k + kv0 + jn * kFpKeys * kv_row, kv_row,
                   Skv - jn * kFpKeys, tid);
    cp_async_commit();

    // scale to base 2, mask, and the online softmax of rows row0 / row1
    // (a row's 64 scores sit in the four lanes of a quad)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[4 * n + e] * sl2, x1 = s[4 * n + 2 + e] * sl2;
        if (masked) {
          const int key = j * kFpKeys + 8 * n + 2 * (lane & 3) + e;
          const int p = key < Skv ? kvpos[key] : -1;
          bool v0 = p >= 0, v1 = p >= 0;
          if (causal) {
            v0 = v0 && p <= myq0;
            v1 = v1 && p <= myq1;
          }
          if (window > 0) {
            v0 = v0 && myq0 - p < window;
            v1 = v1 && myq1 - p < window;
          }
          if (!v0) x0 = kNegInf;
          if (!v1) x1 = kNegInf;
        }
        s[4 * n + e] = x0;
        s[4 * n + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = exp2f(s[4 * n + e] - mn0);
        s[4 * n + 2 + e] = exp2f(s[4 * n + 2 + e] - mn1);
        rs0 += s[4 * n + e];
        rs1 += s[4 * n + 2 + e];
      }
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        o[cb][4 * n] *= alpha0;
        o[cb][4 * n + 1] *= alpha0;
        o[cb][4 * n + 2] *= alpha1;
        o[cb][4 * n + 3] *= alpha1;
      }

    // P as A fragments, hi and lo bf16 parts: keys 16 kk.. of rows row0,
    // row1 are s[8 kk .. 8 kk + 7]
    uint32_t phi[4][4], plo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = s[8 * kk + 2 * i], y = s[8 * kk + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        phi[kk][i] = bf16_pair(hi);
        plo[kk][i] = bf16_pair(__floats2bfloat162_rn(
            x - __low2float(hi), y - __high2float(hi)));
      }

    cp_async_wait<1>();  // V(j) has landed; K(jn) may be in flight
    fence_proxy_async();
    __syncthreads();

    // O += P V
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) fence_regs(o[cb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        const uint64_t dv = smem_desc(Vs + cb * kBlock + kk * 2048, 1024, 1024);
        wgmma_rs(o[cb], phi[kk], dv);
        wgmma_rs(o[cb], plo[kk], dv);
      }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) fence_regs(o[cb]);
    __syncthreads();  // every warp is done with V(j)
    if (jn < ntiles)
      load_tile<DV>(Vs, v + v0 + jn * kFpKeys * v_row, v_row,
                    Skv - jn * kFpKeys, tid);
    cp_async_commit();
    j = jn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int r0 = q0 + row0, r1 = q0 + row1;
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = cb * 64 + 8 * n + 2 * (lane & 3);
      if (r0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(b) * Sq + r0) * H + h) * DV + col) =
            __floats2bfloat162_rn(o[cb][4 * n] / d0, o[cb][4 * n + 1] / d0);
      if (r1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(b) * Sq + r1) * H + h) * DV + col) =
            __floats2bfloat162_rn(o[cb][4 * n + 2] / d1,
                                  o[cb][4 * n + 3] / d1);
    }
}

template <int D, int DV>
int prefill_launch(const void* q, const void* k, const void* v,
                   const void* qpos, const void* kvpos, void* out, int B,
                   int Sq, int Skv, int H, int K, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int bytes = fp_smem_bytes(D, DV, Skv);
  auto kern = flash_prefill_kernel<D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kFpRows - 1) / kFpRows, H, B);
  kern<<<grid, kFpThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<__nv_bfloat16*>(out), Sq,
      Skv, H, K, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k (B, Skv, K, D), v (B, Skv, K, Dv), out (B, Sq, H,
// Dv): bfloat16, rows 16-byte aligned; (D, Dv) one of (64, 64), (128, 128),
// (256, 256), (192, 128)
int launch_flash_prefill(const void* q, const void* k, const void* v,
                         const void* qpos, const void* kvpos, void* out, int B,
                         int Sq, int Skv, int H, int K, int D, int Dv,
                         int causal, int window, float scale,
                         cudaStream_t stream) {
#define FP_CASE(DIM, DIMV)                                                   \
  if (D == DIM && Dv == DIMV)                                                \
    return prefill_launch<DIM, DIMV>(q, k, v, qpos, kvpos, out, B, Sq, Skv,  \
                                     H, K, causal, window, scale, stream);
  FP_CASE(64, 64)
  FP_CASE(128, 128)
  FP_CASE(256, 256)
  FP_CASE(192, 128)
#undef FP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
