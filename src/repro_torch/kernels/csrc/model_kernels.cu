// Hopper (sm_90a) kernels of the serving path: GQA flash attention with
// position masks (the SIMT kernel and the split-KV decode kernel with its
// combine), the RWKV6 WKV recurrence and the RG-LRU recurrence.  The
// tensor-core bf16 prefill is in attention_kernels.cu.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes.  Every launcher takes device pointers and the
// caller's stream, launches on that stream without synchronising, and
// returns cudaGetLastError() (0 on success).  The Python wrappers
// (flash_attention.py, rwkv6_scan.py, rglru_scan.py) check device, dtype,
// shape and contiguity before they call in.  The kernels here do fp32
// arithmetic on the CUDA cores.

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// Flash attention, SIMT (replaces src/repro/kernels/flash_attention.py:106,
// flash_attention, grid (B, Hq, nq, nk) with the KV axis sequential), for
// the shapes the other two designs do not take: prefill (Sq > 16) in fp32
// at every head dim, and in bf16 at head dims 16, 24 and 32.
//
// Contract.  Query head h reads KV head h / G for any G (12 / 4 = 3 at
// lm100m).  Masks come from the positions, element by element (kv_pos >=
// 0, causal kv_pos <= q_pos, window q_pos - kv_pos < window), as in the
// reference's naive_attention; the TPU kernel's wrapper drops the
// positions, which is wrong in decode.  Masked scores are -1e30 and the row
// sum is floored at 1e-30, so a masked tile behaves as in the TPU kernel.
// v has a head dim Dv of its own, as in the TPU kernel: the scores run over
// D, the V tile, the accumulator and the output over Dv (MLA: D = nope +
// rope = 192 against Dv 128 at deepseek-v2-lite, 24 / 16 at its smoke
// config; every other model D == Dv).
//
// Bound: operations, 2 (D + Dv) FLOPs a visible pair at the fp32 FFMA peak
// (67 TFLOP/s).  TF32 stays off, and 3xTF32 would break the chain below, so
// no tensor core.  lm100m prefill (B 8, 12 heads of 64 on 4, Sq 512 into a
// 577-slot cache) 3.23 GFLOP a layer, 0.048 ms, against 34.6 MB (0.010 ms
// at 3.35 TB/s); MLA fp32 prefill (B 4, Sq 1024 into 1057 slots, 16 heads
// of 192 / 128) 21.5 GFLOP, 0.321 ms; recurrentgemma-2b fp32 prefill (B 4,
// 2560 tokens, 10 query heads of 256 on one KV head, window 2048) 128.9
// GFLOP, 1.92 ms.
//
// Each score's q.k is ONE fmaf chain over d = 0..D-1, on q already scaled,
// in the order of cuBLAS's fp32 GEMM, so the plain path's scores match bit
// for bit: four interleaved partial sums sit nearer fp64 on random inputs,
// but move recurrentgemma-2b's random-init fp32 prefill blocks (scores in
// the thousands) 2e-4 from the plain path, past chip_smoke.py's 1e-5 block
// check.
//
// One block of kFaThreads per (query head h, batch b, q tile of kFaRows
// rows; twice both where noted below) walks the KV axis in tiles of
// kFaKeys keys, carrying the online softmax (row max m, row sum l, output
// accumulator) in registers.
// - Products, register-blocked.  The threads form row groups of kFaLanes
//   lanes, four to a warp; a thread holds 4 rows x 4 keys of the score
//   tile (keys tx, tx + 8, ...) and the same 4 rows x Dv / 8 columns of the
//   output, in runs of four contiguous columns.  It reads its q rows and K
//   keys as 16-byte loads of four successive d and runs the four FMAs of
//   each (row, key) pair in the order d .. d+3: the chain is unchanged,
//   and a shared load feeds 16 FMAs, four times what a scalar load of a
//   4 x 4 tile would.  P.V the same way: P read four keys at a time, V four
//   columns a load, keys c = 0 .. kFaKeys - 1 in order.  Rows are padded
//   to D + 4 (Dv + 4, keys + 4) values, an odd number of 16-byte units, so
//   the eight 16-byte reads of a wavefront fall on distinct banks; the
//   lanes of a warp that share a row or a key read it once.  A row group's
//   P rows are its own warp's, so P needs no block barrier.
// - Copies, asynchronous and double-buffered.  K and V tiles land in a
//   two-stage ring by cp.async (16 bytes a copy in fp32; bf16 is staged as
//   bf16, 8 bytes a copy, and widened as it is read), zeros past Skv, so
//   tile t + 1 arrives while tile t is in the products; one barrier a
//   tile.  Before the walk the block reads every slot's position once and
//   flags each KV tile: skipped, loads included, when its position range
//   shows every pair masked (no written slot, or, causal, its least
//   position after the q tile's last query, or, window, its latest
//   position already out of the first query's window); masked element by
//   element when some pair may be; neither when every pair is visible
//   (most tiles).  The TPU kernel's index-based skip holds only for
//   contiguous positions.
// - Occupancy and order.  32-key tiles keep the ring small enough that
//   three blocks share an SM at D 64 (61,440 bytes) and two at D 128
//   (110,592).  Where one block would hold an SM alone, a block takes
//   twice the rows on twice the threads if that still fits: 128 rows on
//   256 threads at 192 / 128 (202,768 bytes), eight warps an SM; D 256
//   (208,896 at 64 rows, under the 232,448 a block may take) keeps four.
//   The q tiles with the most keys (the causal diagonal's last rows)
//   launch first, so the last wave is not one long block.
// ---------------------------------------------------------------------------

constexpr int kFaThreads = 128;
constexpr int kFaRows = 64;   // query rows of a block
constexpr int kFaKeys = 32;   // keys of a KV tile
constexpr int kFaLanes = 8;   // lanes of a row group
constexpr int kFaBlocks = 3;  // blocks an SM at most (170 registers a thread)
constexpr float kNegInf = -1e30f;

// the q tile of `rows` rows and their probabilities in fp32, the
// two-stage K and V ring in T, then a byte per KV tile (its flag), rounded
// up to 16 bytes
template <typename T, int D, int DV>
constexpr int fa_smem_bytes(int rows, int ntiles) {
  return rows * (D + 4 + kFaKeys + 4) * 4 +
         2 * kFaKeys * (D + 4 + DV + 4) * static_cast<int>(sizeof(T)) +
         (ntiles + 15) / 16 * 16;
}

// a block's query rows: 2 * kFaRows (on 2 * kFaThreads threads) where a
// block of kFaRows rows would have its SM to itself and the taller one
// still fits (fp32 at MLA's D 192 / Dv 128: eight warps an SM, not four),
// else kFaRows
template <typename T, int D, int DV>
constexpr int fa_rows() {
  return 2 * (fa_smem_bytes<T, D, DV>(kFaRows, 1024) + 1024) > 233472 &&
                 fa_smem_bytes<T, D, DV>(2 * kFaRows, 1024) <= 232448
             ? 2 * kFaRows
             : kFaRows;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 8 : 0;  // 0: fill the 8 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
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

// four consecutive values of T into shared memory by one cp.async (zeros
// when !valid)
__device__ __forceinline__ void fa_copy4(float* dst, const float* src,
                                         bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void fa_copy4(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src,
                                         bool valid) {
  cp_async8(dst, src, valid);
}

// rows s0 .. s0 + BK - 1 of a K or V tile (C chunks of four values a row,
// rows `stride` values apart from `src`) into shared rows LD values apart,
// zeros past Skv; thread tid takes chunks tid, tid + NT, ...
template <int NT, int BK, int C, int LD, typename T>
__device__ __forceinline__ void fa_copy_tile(T* dst, const T* src,
                                             size_t stride, int s0, int Skv,
                                             int tid) {
#pragma unroll 4
  for (int r = 0; r < (BK * C + NT - 1) / NT; ++r) {
    const int idx = tid + r * NT;
    if ((BK * C) % NT == 0 || idx < BK * C) {
      const int c = idx / C, x = 4 * (idx % C), s = s0 + c;
      fa_copy4(dst + c * LD + x, s < Skv ? src + s * stride + x : src,
               s < Skv);
    }
  }
}

// N (2 or 4) consecutive values of T as floats, in one load
template <int N>
__device__ __forceinline__ void fa_load(const float* p, float* x) {
  if constexpr (N == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    x[0] = w.x;
    x[1] = w.y;
    x[2] = w.z;
    x[3] = w.w;
  } else {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x[0] = w.x;
    x[1] = w.y;
  }
}

template <int N>
__device__ __forceinline__ void fa_load(const __nv_bfloat16* p, float* x) {
  if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// N consecutive floats stored as T (one 16-byte store for 4 floats)
template <int N, typename T>
__device__ __forceinline__ void fa_store(T* p, const float* x) {
  if constexpr (N == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = from_f32<T>(x[i]);
  }
}

template <typename T, int D, int DV, int BQ, int MINB>
__global__ void __launch_bounds__(kFaThreads * BQ / kFaRows, MINB)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kvpos, T* __restrict__ out,
                       int Sq, int Skv, int H, int K, int G, int causal,
                       int window, float scale) {
  constexpr int NT = kFaThreads * BQ / kFaRows;
  constexpr int BK = kFaKeys;
  constexpr int KL = kFaLanes;
  constexpr int TM = BQ * KL / NT;           // rows a thread
  constexpr int TN = BK / KL;                // keys a thread
  constexpr int DN = DV / KL;                // output columns a thread
  constexpr int VW = DN < 4 ? 2 : 4;         // columns a vector load
  constexpr int LDQ = D + 4;
  constexpr int LDK = D + 4;
  constexpr int LDV = DV + 4;
  constexpr int LDP = BK + 4;
  static_assert(D % 4 == 0 && DN % VW == 0, "flash_simt head dims");
  extern __shared__ __align__(16) float fa_smem[];
  float* Qs = fa_smem;                          // BQ x LDQ, already scaled
  float* Ps = Qs + BQ * LDQ;                    // BQ x LDP
  T* Ks = reinterpret_cast<T*>(Ps + BQ * LDP);  // 2 x BK x LDK
  T* Vs = Ks + 2 * BK * LDK;                    // 2 x BK x LDV
  unsigned char* flags =                        // a byte per KV tile
      reinterpret_cast<unsigned char*>(Vs + 2 * BK * LDV);

  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid % KL, ty = tid / KL;
  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / G;

  // the q tile's position range (every warp reads it), and each of this
  // thread's rows' position (a padded row past Sq takes the tile's last
  // position; it is not stored)
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = lane; r < BQ && q0 + r < Sq; r += 32) {
    const int p = qpos[q0 + r];
    qlo = min(qlo, p);
    qhi = max(qhi, p);
  }
  qlo = __reduce_min_sync(0xffffffffu, qlo);
  qhi = __reduce_max_sync(0xffffffffu, qhi);
  int myq[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = q0 + ty * TM + i;
    myq[i] = s < Sq ? qpos[s] : qpos[min(q0 + BQ, Sq) - 1];
  }

  // each KV tile's pairs against the q tile's position range, from every
  // slot's position: 0 none visible (the tile is skipped, loads included),
  // 1 some (masked element by element), 2 all (no mask)
  const int ntiles = (Skv + BK - 1) / BK;
  for (int t = tid / 32; t < ntiles; t += NT / 32) {
    int lo = INT_MAX, hi = -1;
    bool unwritten = false;
    for (int c = lane; c < BK; c += 32) {
      const int s = t * BK + c;
      const int p = s < Skv ? kvpos[s] : -1;
      if (p >= 0) lo = min(lo, p);
      hi = max(hi, p);
      unwritten = unwritten || p < 0;
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    unwritten = __any_sync(0xffffffffu, unwritten);
    bool run = hi >= 0, all = !unwritten;
    if (causal) {
      run = run && lo <= qhi;
      all = all && hi <= qlo;
    }
    if (window > 0) {
      run = run && qlo - hi < window;
      all = all && qhi - lo < window;
    }
    if (lane == 0) flags[t] = run ? (all ? 2 : 1) : 0;
  }

  const T* kb = k + (static_cast<size_t>(b) * Skv * K + kh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Skv * K + kh) * DV;
  // tile t's K and V rows into ring stage `stage`, zeros past Skv
  auto copy_tile = [&](int t, int stage) {
    fa_copy_tile<NT, BK, D / 4, LDK>(Ks + stage * BK * LDK, kb,
                                     static_cast<size_t>(K) * D, t * BK, Skv,
                                     tid);
    fa_copy_tile<NT, BK, DV / 4, LDV>(Vs + stage * BK * LDV, vb,
                                      static_cast<size_t>(K) * DV, t * BK,
                                      Skv, tid);
    cp_async_commit();
  };
  auto next_run = [&](int t) {
    while (t < ntiles && flags[t] == 0) ++t;
    return t;
  };

  for (int idx = tid; idx < BQ * (D / 4); idx += NT) {
    const int r = idx / (D / 4), c = 4 * (idx % (D / 4)), s = q0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (s < Sq) {
      fa_load<4>(q + ((static_cast<size_t>(b) * Sq + s) * H + h) * D + c, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * LDQ + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
  __syncthreads();  // the tile flags are whole
  int t = next_run(0);
  if (t < ntiles) copy_tile(t, 0);

  float m[TM], l[TM], acc[TM][DN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int stage = 0; t < ntiles; stage ^= 1) {
    cp_async_wait<0>();
    // tile t (and the q tile) landed; every reader of the other stage and
    // of P is done with the last tile
    __syncthreads();
    const bool masked = flags[t] == 1;
    const int n = next_run(t + 1);
    if (n < ntiles) copy_tile(n, stage ^ 1);
    const T* ks = Ks + stage * BK * LDK;
    const T* vs = Vs + stage * BK * LDV;

    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float kd[TN][4];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        fa_load<4>(ks + (tx + KL * j) * LDK + d, kd[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float qd[4];
        fa_load<4>(Qs + (ty * TM + i) * LDQ + d, qd);
#pragma unroll
        for (int j = 0; j < TN; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[i][j] = fmaf(qd[e], kd[j][e], sc[i][j]);
      }
    }

    if (masked) {  // uniform over the block
      int kp[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int s = t * BK + tx + KL * j;
        kp[j] = s < Skv ? kvpos[s] : -1;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          bool vis = kp[j] >= 0;
          if (causal) vis = vis && kp[j] <= myq[i];
          if (window > 0) vis = vis && myq[i] - kp[j] < window;
          if (!vis) sc[i][j] = kNegInf;
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) mx = fmaxf(mx, sc[i][j]);
#pragma unroll
      for (int off = KL / 2; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty * TM + i) * LDP + tx + KL * j] = p;
      }
#pragma unroll
      for (int off = KL / 2; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    // a row group's P rows are its own warp's: no other warp reads them
    __syncwarp();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        fa_load<4>(Ps + (ty * TM + i) * LDP + c, pc[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vc[DN];
#pragma unroll
        for (int u = 0; u < DN / VW; ++u)
          fa_load<VW>(vs + (c + e) * LDV + VW * (tx + KL * u), vc + VW * u);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < DN; ++j)
            acc[i][j] = fmaf(pc[i][e], vc[j], acc[i][j]);
      }
    }
    t = n;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = q0 + ty * TM + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Sq + s) * H + h) * DV;
#pragma unroll
    for (int u = 0; u < DN / VW; ++u) {
      float y[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) y[w] = acc[i][VW * u + w] / denom;
      fa_store<VW>(o + VW * (tx + KL * u), y);
    }
  }
}

template <typename T, int D, int DV>
int flash_launch(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kvpos, void* out, int B,
                 int Sq, int Skv, int H, int K, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr int rows = fa_rows<T, D, DV>();
  // as many blocks an SM as their shared memory allows with the flags of
  // 1024 KV tiles (228 KB an SM, 1 KB of it reserved a block), at most
  // kFaBlocks; the register cap follows
  constexpr int fit =
      233472 / (fa_smem_bytes<T, D, DV>(rows, 1024) + 1024);
  constexpr int blocks = fit < kFaBlocks ? fit : kFaBlocks;
  auto kern = flash_attention_kernel<T, D, DV, rows, blocks>;
  const int bytes =
      fa_smem_bytes<T, D, DV>(rows, (Skv + kFaKeys - 1) / kFaKeys);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // q tiles on the slowest axis, in reverse: the most keys first
  dim3 grid(H, B, (Sq + rows - 1) / rows);
  kern<<<grid, kFaThreads * rows / kFaRows, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<T*>(out), Sq, Skv, H, K,
      H / K, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// the (D, Dv) pairs the kernels take: D == Dv for every GQA model, and
// MLA's nope + rope against v_head_dim at deepseek-v2-lite (192, 128) and
// its smoke config (24, 16)
#define FA_DIMS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(24, 16) X(192, 128)

template <typename T>
int flash_by_dim(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kvpos, void* out, int B,
                 int Sq, int Skv, int H, int K, int D, int Dv, int causal,
                 int window, float scale, cudaStream_t stream) {
#define FA_CASE(DIM, DIMV)                                                  \
  if (D == DIM && Dv == DIMV)                                               \
    return flash_launch<T, DIM, DIMV>(q, k, v, qpos, kvpos, out, B, Sq, Skv, \
                                      H, K, causal, window, scale, stream);
  FA_DIMS(FA_CASE)
#undef FA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// Flash attention, split-KV decode (replaces the same TPU kernel,
// src/repro/kernels/flash_attention.py:106, for Sq <= 16 query rows a head).
//
// Decode reads the whole KV cache for one query row a head, so bytes bound
// it: at recurrentgemma-2b (B 4, 10 query heads of 256 on one KV head, the
// 2048-slot ring) 8.44 MB a layer, 2.5 us at 3.35 TB/s; at lm100m (B 8,
// 12 query heads of 64 on 4 KV heads, a 577-slot cache) 9.51 MB, 2.8 us.
// The arithmetic (4*D FLOPs a visible pair) is ~1,000x below the fp32 peak.
// Filling the card's memory system is the point: the SIMT kernel gave
// decode one block per (query head, batch), 40 blocks on 132 SMs at
// recurrentgemma-2b, each walking 2048 keys in series, and the G = 10 query
// heads of a KV head each read its keys again.
//
// flash_decode_kernel: one block per (KV split, KV head kh x row group,
// batch b).  A block serves kFdRows of the G * Sq (query head, query) rows
// of kh, so each K / V row crosses the memory bus once per row group (once
// in all at Sq 1 and G <= 16).  The split count (decode_plan in
// flash_attention.py) takes as few 32-key tiles a split as still give
// about 3 x 132 blocks in all: 64 splits of 32 slots at recurrentgemma-2b
// (B*K = 4, 256 blocks), 10 splits of 64 at lm100m (B*K = 32, 320 blocks).
// With every block resident at once the kernel's time is one block's
// chain of latencies, so the design shortens that chain: the first tile's
// positions and the q rows are read together, every q load in flight at
// once, into registers; per tile of kFdTile keys the block skips the tile,
// loads included, when its position range shows every pair masked (as
// the SIMT kernel does); else brings K and V in with 16-byte cp.async
// copies (zero past the split; V lands while the scores are computed);
// computes the scores (bf16: mma.sync m16n8k16, the 16 rows by 8 keys a
// warp, fp32 accumulators; fp32, where TF32 stays off: a group of LPK
// lanes per key, each lane summing its 16-byte chunks of every row and the
// group reducing the rows' partial sums with one reduce-scatter of
// shuffles, 15 for 16 rows, not 16 x 5); masks element by element from the
// positions (the ring's slots are out of order); updates the online
// softmax of the rows (a lane per key, a warp's four rows' shuffle trees
// interleaved); and accumulates P.V in fp32 registers, a thread holding 16
// bytes' worth of columns of RPT consecutive rows, whose probabilities of
// a key are one vector load of the key-major scores.  It writes its fp32
// (m, l) and unnormalised accumulator per row to scratch the wrapper
// allocates.  A split with no tile run writes m = -1e30, l = 0, acc = 0.
//
// flash_decode_combine_kernel: one block per output row (b, sq, h) reads
// the splits' partials of its row, M = max m_s, and writes
// sum_s e^(m_s - M) acc_s / max(sum_s e^(m_s - M) l_s, 1e-30) in q's dtype;
// its threads split the row's columns (a float4 each) and its splits, so
// the splits' loads are in flight together, not one after another.
// Two kernels, not one with a ticket counter, so neither needs an order
// among blocks; one host call (launch_flash_decode with out) launches
// both, since decode pays the host's time per call at every layer.
//
// v's head dim Dv may differ from D (MLA): K rows, the q rows and the
// scores run over D, V rows, the accumulators, the partials and the
// combine over Dv.  A D whose 16-byte chunks are not a power of two (24
// and 192 in fp32) takes the power of two above as its lanes a key, the
// lanes past the last chunk idle; a D that is not a multiple of 16 (24
// in bf16) takes one more mma step, its columns past D zero in both
// fragments.
// ---------------------------------------------------------------------------

constexpr int kFdThreads = 128;
constexpr int kFdRows = 16;
constexpr int kFdTile = 32;
constexpr int kFcThreads = 256;

template <typename T, int D, int DV>
constexpr int fd_smem_bytes() {
  return (D + DV + 16 / static_cast<int>(sizeof(T))) * kFdTile *
             static_cast<int>(sizeof(T)) +
         4 * (kFdRows * kFdTile + 4 * kFdRows + kFdTile + 2);
}

// the least power of two >= n, at most 32 (lanes of a key's score group)
__host__ __device__ constexpr int fd_lanes(int n) {
  return n >= 32 ? 32 : n > 16 ? 32 : n > 8 ? 16 : n > 4 ? 8 : n > 2 ? 4
                                                                : n > 1 ? 2
                                                                        : 1;
}

// 16 bytes of T (4 floats or 8 bf16) as floats
__device__ __forceinline__ void unpack16(const float* p, float* x) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  x[0] = w.x;
  x[1] = w.y;
  x[2] = w.z;
  x[3] = w.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Sums N values v[0..N) across the lanes of an aligned group of 2 * O
// lanes, O, O/2, ..., 1 apart: at each step a lane keeps one half of its
// values (the upper one if its O bit is set) and adds its partner's copy
// of that half, so after log2(N) steps it holds the group's sums of N /
// (2 O) consecutive values starting at `base`; steps past that add the
// last value outright.  N / 2 + N / 4 + ... shuffles, not N log2(2 O).
template <int O, int N>
__device__ __forceinline__ void reduce_scatter(float* v, int lane,
                                               int& base) {
  if constexpr (O >= 1) {
    const bool upper = (lane & O) != 0;
    if constexpr (N > 1) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = upper ? v[i] : v[i + N / 2];
        const float keep = upper ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
      if (upper) base += N / 2;
      reduce_scatter<O / 2, N / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
      reduce_scatter<O / 2, 1>(v, lane, base);
    }
  }
}

// c += A B, m16n8k16, bf16 operands in registers, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N consecutive floats of shared memory, in vector loads where they fit
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + i);
      x[i] = w.x;
      x[i + 1] = w.y;
      x[i + 2] = w.z;
      x[i + 3] = w.w;
    }
  } else if constexpr (N == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    x[0] = w.x;
    x[1] = w.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = p[i];
  }
}

template <typename T, int D, int DV>
__global__ void __launch_bounds__(kFdThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kvpos,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int Sq, int Skv, int H, int K, int groups, int per_split,
                    int splits, int causal, int window, float scale) {
  constexpr int VN = 16 / static_cast<int>(sizeof(T));  // values a chunk
  constexpr int CH = D / VN;                // 16-byte chunks of a q / k row
  constexpr int CV = DV / VN;               // 16-byte chunks of a v row
  constexpr int LPK = fd_lanes(CH);         // lanes per (row, key) score
  constexpr int NV = (CH + LPK - 1) / LPK;  // chunks a lane sums
  constexpr int NG = kFdThreads / LPK;      // keys in flight
  constexpr int NF = LPK < kFdRows ? kFdRows / LPK : 1;  // rows a lane sums
  constexpr int DUP = LPK > kFdRows ? LPK / kFdRows : 1;  // lanes a row
  constexpr int RL = kFdThreads / CV;       // row lanes of P.V
  constexpr int RPT = RL < kFdRows ? kFdRows / RL : 1;  // its rows
  constexpr bool kMma = sizeof(T) == 2;     // bf16: q.k on the tensor cores
  constexpr int KLD = D + VN;               // K rows padded by 16 bytes
  constexpr int KS = (D + 15) / 16;         // mma steps over the head dim
  static_assert(kFdTile == 8 * (kFdThreads / 32) && kFdRows == 16,
                "the mma path takes 8 keys a warp and 16 rows");
  static_assert(D % VN == 0 && DV % VN == 0 && (!kMma || D % 8 == 0),
                "rows of whole 16-byte chunks");
  extern __shared__ __align__(16) unsigned char fd_smem[];
  T* Ks = reinterpret_cast<T*>(fd_smem);    // kFdTile x KLD
  T* Vs = Ks + kFdTile * KLD;               // kFdTile x DV
  float* Ss = reinterpret_cast<float*>(Vs + kFdTile * DV);  // keys x rows
  float* m_s = Ss + kFdRows * kFdTile;
  float* l_s = m_s + kFdRows;
  float* a_s = l_s + kFdRows;
  int* qp_s = reinterpret_cast<int*>(a_s + kFdRows);
  int* kp_s = qp_s + kFdRows;
  int* range_s = kp_s + kFdTile;            // the tile's least, largest

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kh = blockIdx.y / groups, r0 = (blockIdx.y % groups) * kFdRows;
  const int G = H / K;
  const int R = min(kFdRows, G * Sq - r0);  // row r: (g, sq) of r0 + r

  const int s_begin = split * per_split * kFdTile;
  const int s_end = min(Skv, s_begin + per_split * kFdTile);
  // warp 0 reads the first tile's positions while the q rows load
  int p_next = -1;
  if (warp == 0 && s_begin + lane < s_end) p_next = kvpos[s_begin + lane];
  if (tid < kFdRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    qp_s[tid] = qpos[(r0 + min(tid, R - 1)) % Sq];
  }
  // fp32: this lane's chunks (n * LPK + sub) of every q row, scaled, in
  // registers for all tiles.  bf16: the q rows as mma A fragments (rows g
  // and g + 8, columns 2t.. and 2t + 8.. of each 16-wide step), unscaled.
  // Rows past R load row R - 1 and are zeroed, so every load is issued
  // before the first returns.
  const int sub = lane % LPK;
  float qreg[kMma ? 1 : kFdRows][NV * VN];
  uint32_t qa[kMma ? KS : 1][4];
  if constexpr (kMma) {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int h8 = 0; h8 < 2; ++h8) {
      const int r = g + 8 * h8, rr = r0 + min(r, R - 1);
      const T* qr = q + ((static_cast<size_t>(b) * Sq + rr % Sq) * H +
                         kh * G + rr / Sq) * D + 2 * t4;
      const uint32_t keep = r < R ? 0xffffffffu : 0u;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        qa[ks][h8] = keep & *reinterpret_cast<const uint32_t*>(qr + 16 * ks);
        // the step's upper 8 columns, zero past D
        qa[ks][2 + h8] =
            (D % 16 == 0 || ks < KS - 1)
                ? keep & *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8)
                : 0u;
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kFdRows; ++r) {
      const int rr = r0 + min(r, R - 1);
      const T* qr = q + ((static_cast<size_t>(b) * Sq + rr % Sq) * H +
                         kh * G + rr / Sq) * D;
      const float f = r < R ? scale : 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float x[VN] = {};
        if (CH % LPK == 0 || n * LPK + sub < CH)
          unpack16(qr + (n * LPK + sub) * VN, x);
#pragma unroll
        for (int e = 0; e < VN; ++e) qreg[r][n * VN + e] = x[e] * f;
      }
    }
  }
  __syncthreads();
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < R; ++r) {
    qlo = min(qlo, qp_s[r]);
    qhi = max(qhi, qp_s[r]);
  }

  const int ch = tid % CV, rl = tid / CV;
  float acc[RPT][VN];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[j][e] = 0.f;

  for (int k0 = s_begin; k0 < s_end; k0 += kFdTile) {
    __syncthreads();  // the previous tile's readers are done
    if (warp == 0) {
      const int p = p_next;
      const int s = k0 + kFdTile + lane;  // the next tile's, read ahead
      p_next = s < s_end ? kvpos[s] : -1;
      kp_s[lane] = p;
      const int lo = __reduce_min_sync(0xffffffffu, p >= 0 ? p : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, p);
      if (lane == 0) {
        range_s[0] = lo;
        range_s[1] = hi;
      }
    }
    __syncthreads();
    bool run = range_s[1] >= 0;
    if (causal) run = run && range_s[0] <= qhi;
    if (window > 0) run = run && qlo - range_s[1] < window;
    if (!run) continue;  // uniform over the block

    for (int idx = tid; idx < kFdTile * CH; idx += kFdThreads) {
      const int c = idx / CH, x = idx % CH, s = k0 + c;
      const size_t off =
          ((static_cast<size_t>(b) * Skv + min(s, Skv - 1)) * K + kh) * D +
          x * VN;
      cp_async16(Ks + c * KLD + x * VN, k + off, s < s_end);
    }
    cp_async_commit();
    for (int idx = tid; idx < kFdTile * CV; idx += kFdThreads) {
      const int c = idx / CV, x = idx % CV, s = k0 + c;
      const size_t off =
          ((static_cast<size_t>(b) * Skv + min(s, Skv - 1)) * K + kh) * DV +
          x * VN;
      cp_async16(Vs + c * DV + x * VN, v + off, s < s_end);
    }
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    if constexpr (kMma) {
      // scores, bf16: warp w takes keys 8w..8w+7, all 16 rows, D / 16
      // mma.sync m16n8k16 steps with fp32 accumulators; the scale goes on
      // the fp32 sums.  Lane (g, t4) holds rows g, g + 8 of keys 2 t4,
      // 2 t4 + 1.  K rows are padded by 16 bytes, so the 8 keys' rows
      // fall in distinct banks.
      const int g = lane >> 2, t4 = lane & 3, n0 = 8 * warp;
      const T* kr = Ks + (n0 + g) * KLD + 2 * t4;
      float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_bf16(c4, qa[ks],
                 *reinterpret_cast<const uint32_t*>(kr + 16 * ks),
                 (D % 16 == 0 || ks < KS - 1)
                     ? *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8)
                     : 0u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i >> 1), c = n0 + 2 * t4 + (i & 1);
        if (r < R) {
          const int p = kp_s[c], qq = qp_s[r];
          bool vis = p >= 0;
          if (causal) vis = vis && p <= qq;
          if (window > 0) vis = vis && qq - p < window;
          Ss[c * kFdRows + r] = vis ? c4[i] * scale : kNegInf;
        }
      }
    } else {
      // scores, fp32: a group of LPK lanes per key, each lane summing its
      // chunks of all kFdRows rows (q slices held in registers), then a
      // reduce-scatter over the group leaves each lane the sums of NF
      // rows; a warp's groups take keys in step (kFdTile is a multiple of
      // 32 / LPK)
      for (int c = tid / LPK; c < kFdTile; c += NG) {
        float sv[kFdRows];
#pragma unroll
        for (int r = 0; r < kFdRows; ++r) sv[r] = 0.f;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          if (CH % LPK != 0 && n * LPK + sub >= CH) continue;  // idle lane
          float kx[VN];
          unpack16(Ks + c * KLD + (n * LPK + sub) * VN, kx);
#pragma unroll
          for (int r = 0; r < kFdRows; ++r)
#pragma unroll
            for (int e = 0; e < VN; ++e)
              sv[r] = fmaf(qreg[r][n * VN + e], kx[e], sv[r]);
        }
        int base = 0;
        reduce_scatter<LPK / 2, kFdRows>(sv, lane, base);
        if (sub % DUP == 0) {
          const int p = kp_s[c];
#pragma unroll
          for (int i = 0; i < NF; ++i) {
            const int r = base + i;
            if (r < R) {
              const int qq = qp_s[r];
              bool vis = p >= 0;
              if (causal) vis = vis && p <= qq;
              if (window > 0) vis = vis && qq - p < window;
              Ss[c * kFdRows + r] = vis ? sv[i] : kNegInf;
            }
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w takes rows w, w + 4, w + 8, w + 12 at once (a
    // lane per key, kFdTile == 32), their shuffle trees interleaved; rows
    // past R compute on stale scores and are never read back
    {
      constexpr int NR = kFdRows / (kFdThreads / 32);
      float sc[NR], mx[NR], rs[NR];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        sc[j] = Ss[lane * kFdRows + warp + 4 * j];
        mx[j] = sc[j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < NR; ++j)
          mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], off));
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = warp + 4 * j;
        mx[j] = fmaxf(m_s[r], mx[j]);
        sc[j] = expf(sc[j] - mx[j]);
        rs[j] = sc[j];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int j = 0; j < NR; ++j)
          rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], off);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = warp + 4 * j;
        Ss[lane * kFdRows + r] = sc[j];
        if (lane == 0) {
          const float alpha = expf(m_s[r] - mx[j]);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + rs[j];
          m_s[r] = mx[j];
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // P.V: thread (rl, ch) holds columns ch*VN.. of rows rl*RPT.. (rows
    // past R are computed and dropped), their probabilities of a key one
    // vector load of the key-major scores
    if (rl * RPT < kFdRows) {
      float al[RPT];
      load_rows<RPT>(a_s + rl * RPT, al);
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[j][e] *= al[j];
#pragma unroll 4
      for (int c = 0; c < kFdTile; ++c) {
        float vx[VN], pr[RPT];
        unpack16(Vs + c * DV + ch * VN, vx);
        load_rows<RPT>(Ss + c * kFdRows + rl * RPT, pr);
#pragma unroll
        for (int j = 0; j < RPT; ++j)
#pragma unroll
          for (int e = 0; e < VN; ++e)
            acc[j][e] = fmaf(pr[j], vx[e], acc[j][e]);
      }
    }
  }

  // this split's partials, in the output's row order (b, sq, h)
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rl * RPT + j;
    if (r < R) {
      const int g = (r0 + r) / Sq, sq = (r0 + r) % Sq;
      const size_t row = (static_cast<size_t>(b) * Sq + sq) * H + kh * G + g;
      float* dst = part_acc + (row * splits + split) * DV + ch * VN;
#pragma unroll
      for (int e = 0; e < VN; e += 4)
        *reinterpret_cast<float4*>(dst + e) =
            make_float4(acc[j][e], acc[j][e + 1], acc[j][e + 2], acc[j][e + 3]);
    }
  }
  if (tid < R) {
    const int g = (r0 + tid) / Sq, sq = (r0 + tid) % Sq;
    const size_t row = (static_cast<size_t>(b) * Sq + sq) * H + kh * G + g;
    part_ml[(row * splits + split) * 2] = m_s[tid];
    part_ml[(row * splits + split) * 2 + 1] = l_s[tid];
  }
}

// the combine's dynamic shared bytes: the splits' weights, the column
// groups' partial sums, the warps' partial max and sum
inline int fc_smem_bytes(int splits) {
  return 4 * (splits + 4 * kFcThreads + 2 * (kFcThreads / 32));
}

template <typename T, int D>
__global__ void __launch_bounds__(kFcThreads)
flash_decode_combine_kernel(const float* __restrict__ part_ml,
                            const float* __restrict__ part_acc,
                            T* __restrict__ out, int splits) {
  constexpr int CH = D / 4;              // float4 columns of a row
  constexpr int SG = kFcThreads / CH;    // split groups
  constexpr int NW = kFcThreads / 32;
  extern __shared__ __align__(16) float fc_smem[];
  float* w_s = fc_smem;                  // splits: e^(m_s - M), 0 if l_s 0
  float* red = w_s + splits;             // SG x D partial sums
  float* wred = red + 4 * kFcThreads;    // NW maxima, NW sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const float* ml = part_ml + row * splits * 2;
  const float* pa = part_acc + row * splits * D;

  float mx = kNegInf;
  for (int s = tid; s < splits; s += kFcThreads) mx = fmaxf(mx, ml[2 * s]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) wred[warp] = mx;
  __syncthreads();
  mx = wred[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) mx = fmaxf(mx, wred[w]);
  float total = 0.f;
  for (int s = tid; s < splits; s += kFcThreads) {
    const float l = ml[2 * s + 1];
    const float w = l == 0.f ? 0.f : expf(ml[2 * s] - mx);  // 0: nothing run
    w_s[s] = w;
    total += w * l;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, off);
  if (lane == 0) wred[NW + warp] = total;
  __syncthreads();

  // thread (g, c): columns 4c.. of the splits g, g + SG, ...
  const int c = tid % CH, g = tid / CH;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int s = g; s < splits; s += SG) {
    const float w = w_s[s];
    float x[4];
    unpack16(pa + static_cast<size_t>(s) * D + 4 * c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, x[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[4 * tid + e] = acc[e];
  __syncthreads();
  if (g == 0) {
    total = wred[NW];
#pragma unroll
    for (int w = 1; w < NW; ++w) total += wred[NW + w];
    const float denom = fmaxf(total, 1e-30f);
    for (int k = 1; k < SG; ++k) {
      const float* o = red + 4 * (k * CH + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] += o[e];
    }
    T* dst = out + row * D + 4 * c;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_f32<T>(acc[e] / denom);
  }
}

template <typename T, int D, int DV>
int decode_launch(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kvpos, void* part_ml,
                  void* part_acc, int B, int Sq, int Skv, int H, int K,
                  int groups, int per_split, int splits, int causal,
                  int window, float scale, cudaStream_t stream) {
  constexpr int bytes = fd_smem_bytes<T, D, DV>();
  auto kern = flash_decode_kernel<T, D, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(splits, K * groups, B);
  kern<<<grid, kFdThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), Sq, Skv, H, K, groups, per_split, splits,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int decode_by_dim(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kvpos, void* part_ml,
                  void* part_acc, int B, int Sq, int Skv, int H, int K, int D,
                  int Dv, int groups, int per_split, int splits, int causal,
                  int window, float scale, cudaStream_t stream) {
#define FD_CASE(DIM, DIMV)                                                  \
  if (D == DIM && Dv == DIMV)                                               \
    return decode_launch<T, DIM, DIMV>(q, k, v, qpos, kvpos, part_ml,       \
                                       part_acc, B, Sq, Skv, H, K, groups,  \
                                       per_split, splits, causal, window,   \
                                       scale, stream);
  FA_DIMS(FD_CASE)
#undef FD_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int D>
int combine_launch(const void* part_ml, const void* part_acc, void* out,
                   int rows, int splits, cudaStream_t stream) {
  const int bytes = fc_smem_bytes(splits);
  auto kern = flash_decode_combine_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<rows, kFcThreads, bytes, stream>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine_by_dim(const void* part_ml, const void* part_acc, void* out,
                   int rows, int splits, int D, cudaStream_t stream) {
  switch (D) {
    case 16:
      return combine_launch<T, 16>(part_ml, part_acc, out, rows, splits,
                                   stream);
    case 32:
      return combine_launch<T, 32>(part_ml, part_acc, out, rows, splits,
                                   stream);
    case 64:
      return combine_launch<T, 64>(part_ml, part_acc, out, rows, splits,
                                   stream);
    case 128:
      return combine_launch<T, 128>(part_ml, part_acc, out, rows, splits,
                                    stream);
    case 256:
      return combine_launch<T, 256>(part_ml, part_acc, out, rows, splits,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// WKV6 (replaces src/repro/kernels/rwkv6_scan.py:99, wkv6_chunked, grid
// (B, H, T/64) with the chunk axis sequential and the state in VMEM).
//
// The exact recurrence of kernels/ref.py:wkv6_ref, step by step:
//   y_t[j] = sum_i r_t[i] S[i][j] + v_t[j] sum_i r_t[i] u[i] k_t[i]
//   S[i][j] = exp(log_w_t[i]) S[i][j] + k_t[i] v_t[j]
// (the bonus term u k^T v summed once a step as a scalar times v[j]).  The
// TPU kernel's chunked matmul form clamps each cumulative log-decay to
// +-30 on its own, which is wrong once the decay is strong; a step loop has
// no exponent to clamp.
//
// Bound: at rwkv6-3b prefill (B 4, T 256, 40 heads of 64) r, k, v (bf16),
// log_w (fp32), y and the two states are 36.7 MB, 11 us at 3.35 TB/s,
// against 1.2 us of operations at the bf16 rate of its inputs: bytes bound
// it.  The arithmetic runs in fp32 on the CUDA cores: 3 D*D FMAs a step
// and head, 0.50 G instructions a layer, 15 us of the card's fp32 issue,
// so issue, not bytes, is what a design can reach.  At T = 1 (decode) the
// states' 5.2 MB dominate.
//
// Design, point by point: what holds the scan back, what the kernel does:
// 1. More blocks.  In prefill a head's (D, D) state is split across a
//    cluster of NS = D / kWkvKeys blocks by KEYS (rows i), kWkvKeys = 16
//    a block: 640 blocks of 64 threads at rwkv6-3b, ~4.8 an SM, all
//    resident at once.  Not by value columns: a block owning 16 of 64
//    columns would read and write the row-major state in 64-byte pieces
//    and y in 32-byte pieces, below the 128-byte rows the tile lint holds
//    every kernel to; a block owning 16 keys owns whole state rows.  The
//    sum over keys that y needs is taken across the cluster in
//    distributed shared memory: each block writes its partial y rows to
//    its shared memory, and after the cluster barrier block q sums rows
//    q, q + NS, ... over the NS blocks in rank order and writes them whole.
// 2. Register blocking.  Thread (g, p) holds kWkvCols = 4 adjacent columns
//    4g.. of its run of NI = 4 keys (2 at D 16): one float4 read each of
//    the step's r, k, w and r u k rows feeds 16 FMAs, and one float4 of v.
//    The P = 4 threads of a column group are adjacent lanes; they sum y
//    with a reduce-scatter (3 shuffles) that leaves each lane one column.
//    A quarter-warp reads 64 consecutive bytes: no bank conflict.  Two
//    lanes a column group (8 keys a thread, fewer shuffles) measured 23%
//    slower on the H100: half the warps to hide latency.
// 3. Staging overlaps compute.  Each block copies whole rows of r, k, v
//    and log_w, kWkvSteps = 16 steps a slot, into a ring of kWkvSlots = 2
//    slots with 16-byte cp.async, two chunks ahead.  A chunk is converted
//    once to fp32 rows of the block's keys (w = exp(log_w), q = r u k) and
//    of v, every shared load of the conversion before any store.  A whole
//    chunk's steps are unrolled with their partial y in registers until
//    the end, so no shared store orders one step's loads after the last.
//    The cluster barrier is split: a block arrives after its partial y of
//    chunk c and converts chunk c + 1 before it waits and sums chunk c.
//    The arrive's release fence costs ~700 cycles a chunk (clock64, one
//    block).  Stepping chunk c + 1 before the wait as well (three
//    partial-y buffers, 41 KB a block) was faster at B 1 and 2 but took
//    1.4x the time at rwkv6-3b's B 4, with or without the max-shared
//    carveout: likely not all 160 clusters of four resident at once.
// 4. Decode (T 1): no ring.  One block a head holds all D keys (64
//    threads of 16 keys at D 64: each warp's state reads and writes are
//    whole 128-byte rows; with 32- or 64-byte pieces decode took 1.7x or
//    1.2x the card time); each key's r, k, w and q are computed once into
//    shared rows, and the state is read and written as float4 along j.
// ---------------------------------------------------------------------------

constexpr int kWkvKeys = 16;   // keys a block holds in prefill
constexpr int kWkvCols = 4;    // adjacent value columns a thread holds
constexpr int kWkvSteps = 16;  // steps a ring slot holds
constexpr int kWkvSlots = 2;   // ring slots

// keys a thread holds (NI): at most 16, a quarter of the block's keys
// (four lanes a column group), fewer where a block would fall below a warp;
// and the threads of a block holding KB keys
__host__ __device__ constexpr int wkv_min(int a, int b) {
  return a < b ? a : b;
}
template <int D, int KB>
__host__ __device__ constexpr int wkv_run() {
  return wkv_min(16, wkv_min(KB / 4, KB * D / 128));
}
template <int D, int KB>
__host__ __device__ constexpr int wkv_threads() {
  return D / kWkvCols * (KB / wkv_run<D, KB>());
}
// dynamic shared bytes: in decode the r, k, w, q rows of a head; in
// prefill u, two buffers of partial y rows, the fp32 rows of the block's
// keys and of v, and the ring
template <typename T, int D, int KB>
constexpr int wkv_smem_bytes(bool decode) {
  return decode ? 16 * D
                : 4 * D + 2 * kWkvSteps * D * 4 +
                      kWkvSteps * (4 * KB + D) * 4 +
                      kWkvSlots * kWkvSteps * D *
                          (3 * static_cast<int>(sizeof(T)) + 4);
}

__device__ __forceinline__ float4 wkv_load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 wkv_load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void wkv_store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ void wkv_store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// the cluster barrier in two halves: arrive (release: this block's shared
// writes are visible to the cluster), then wait (acquire)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the column (0-3 of its group) a lane holds after wkv_step's reduce
__device__ __forceinline__ int wkv_col(int p) {
  return 2 * (p & 1) + ((p >> 1) & 1);
}

// One step for the NI x 4 state entries of a thread: y's partial sums over
// its keys, the state update, and the sum over the P lanes of its column
// group, reduce-scattered so that lane p ends with column wkv_col(p).
template <int NI, int P>
__device__ __forceinline__ float wkv_step(float (&st)[NI][kWkvCols],
                                          const float* rr, const float* kk,
                                          const float* ww, const float* qq,
                                          float4 v4, int p) {
  const float vv[kWkvCols] = {v4.x, v4.y, v4.z, v4.w};
  float bonus = 0.f;
#pragma unroll
  for (int n = 0; n < NI; ++n) bonus += qq[n];
  float acc[kWkvCols];
#pragma unroll
  for (int c = 0; c < kWkvCols; ++c) acc[c] = vv[c] * bonus;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
#pragma unroll
    for (int c = 0; c < kWkvCols; ++c) {
      acc[c] = fmaf(rr[n], st[n][c], acc[c]);
      st[n][c] = fmaf(ww[n], st[n][c], kk[n] * vv[c]);
    }
  }
  const bool b0 = p & 1, b1 = (p >> 1) & 1;
  float k0 = b0 ? acc[2] : acc[0], k1 = b0 ? acc[3] : acc[1];
  const float s0 = b0 ? acc[0] : acc[2], s1 = b0 ? acc[1] : acc[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  k1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  float col = b1 ? k1 : k0;
  col += __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 2);
#pragma unroll
  for (int m = 4; m < P; m *= 2) col += __shfl_xor_sync(0xffffffffu, col, m);
  return col;
}

// NI consecutive values as floats (16-byte vectors where NI % 4 == 0)
template <int NI, typename T>
__device__ __forceinline__ void wkv_load_run(const T* p, float* x) {
  if constexpr (NI % 4 == 0) {
#pragma unroll
    for (int m = 0; m < NI / 4; ++m) {
      const float4 a = wkv_load4(p + 4 * m);
      x[4 * m] = a.x;
      x[4 * m + 1] = a.y;
      x[4 * m + 2] = a.z;
      x[4 * m + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < NI; ++m) x[m] = to_f32(p[m]);
  }
}

// Grid: B * H * (D / KB) blocks in clusters of D / KB (one head each).
template <typename T, int D, int KB>
__global__ void __launch_bounds__((wkv_threads<D, KB>()))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ log_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sT, int Tn, int H) {
  constexpr int NI = wkv_run<D, KB>();
  constexpr int P = KB / NI;           // lanes of a column group
  constexpr int NT = wkv_threads<D, KB>();
  constexpr int NS = D / KB;           // blocks of a head: the cluster
  constexpr int STEPS = kWkvSteps;
  constexpr int Q4 = D / 4;            // float4s of a row
  extern __shared__ __align__(16) float wkv_smem[];
  float* us = wkv_smem;                // u[h]: D
  float* yt = us + D;                  // partial y: [2][STEPS][D]
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, p = tid % P, g = tid / P;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / NS, b = bh / H, h = bh % H;
  const int kb0 = rank * KB;           // the block's first key
  const int key0 = kb0 + p * NI;       // the thread's first key
  const int col0 = g * kWkvCols;       // the thread's first column
  float st[NI][kWkvCols];
  const size_t sbase = static_cast<size_t>(bh) * D * D;
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const float4 x = *reinterpret_cast<const float4*>(
        s0 + sbase + static_cast<size_t>(key0 + n) * D + col0);
    st[n][0] = x.x;
    st[n][1] = x.y;
    st[n][2] = x.z;
    st[n][3] = x.w;
  }
  auto store_state = [&] {
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      *reinterpret_cast<float4*>(sT + sbase +
                                 static_cast<size_t>(key0 + n) * D + col0) =
          make_float4(st[n][0], st[n][1], st[n][2], st[n][3]);
    }
  };

  if (Tn == 1) {
    // decode: a head in one block (NS 1, the launcher's check), no ring:
    // each key's r, k, w = exp(log_w) and q = r u k once into shared rows,
    // then each thread's run of them
    float* dk = wkv_smem;  // [4][D]
    const size_t row = static_cast<size_t>(bh) * D;  // (b, 0, h)
    for (int i = tid; i < D; i += NT) {
      const float rv = to_f32(r[row + i]), kv = to_f32(k[row + i]);
      dk[i] = rv;
      dk[D + i] = kv;
      dk[2 * D + i] = expf(log_w[row + i]);
      dk[3 * D + i] = rv * u[h * D + i] * kv;
    }
    __syncthreads();
    float rr[NI], kk[NI], ww[NI], qq[NI];
    wkv_load_run<NI>(dk + key0, rr);
    wkv_load_run<NI>(dk + D + key0, kk);
    wkv_load_run<NI>(dk + 2 * D + key0, ww);
    wkv_load_run<NI>(dk + 3 * D + key0, qq);
    const float4 v4 = wkv_load4(v + row + col0);
    const float yv = wkv_step<NI, P>(st, rr, kk, ww, qq, v4, p);
    if (p < 4) y[row + col0 + wkv_col(p)] = from_f32<T>(yv);
    store_state();
    return;
  }

  if constexpr (KB == kWkvKeys) {  // prefill: the launcher's check
    const float* yq[NS];                 // every block's partial y
#pragma unroll
    for (int q = 0; q < NS; ++q) yq[q] = cluster.map_shared_rank(yt, q);
    for (int i = tid; i < D; i += NT) us[i] = u[h * D + i];

    // sum rows q, q + NS, ... of the chunk's partial y over the cluster, in
    // rank order, and write them (nt rows from step t0)
    auto reduce_rows = [&](const int buf, const int t0, const int nt) {
      const int off = buf * STEPS * D;
      for (int e = tid; e < STEPS / NS * Q4; e += NT) {
        const int tt = rank + NS * (e / Q4), j = 4 * (e % Q4);
        if (tt < nt) {
          float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < NS; ++q) {
            const float4 x =
                *reinterpret_cast<const float4*>(yq[q] + off + tt * D + j);
            sum[0] += x.x;
            sum[1] += x.y;
            sum[2] += x.z;
            sum[3] += x.w;
          }
          wkv_store4(
              y + (static_cast<size_t>(b * Tn + t0 + tt) * H + h) * D + j,
              make_float4(sum[0], sum[1], sum[2], sum[3]));
        }
      }
    };

    // shared memory past the partial y: fp32 rows of the block's keys
    // (r, k, w, q: [STEPS][KB] each) and of v ([STEPS][D]), then the ring
    float* rf = yt + 2 * STEPS * D;
    float* kf = rf + STEPS * KB;
    float* wf = kf + STEPS * KB;
    float* qf = wf + STEPS * KB;
    float* vf = qf + STEPS * KB;
    // a slot: r, k, v rows in T, then log_w rows in fp32
    constexpr int RT = STEPS * D * static_cast<int>(sizeof(T));
    constexpr int SLOT = 3 * RT + STEPS * D * 4;
    unsigned char* ring = reinterpret_cast<unsigned char*>(vf + STEPS * D);
    constexpr int PT = D * static_cast<int>(sizeof(T)) / 16;  // 16-B pieces
    constexpr int PF = D * 4 / 16;
    const int nchunks = (Tn + STEPS - 1) / STEPS;
    const size_t row0 = (static_cast<size_t>(b) * Tn * H + h) * D;  // t = 0
    const size_t tstride = static_cast<size_t>(H) * D;

    auto issue = [&](const int c) {
      if (c < nchunks) {
        const int t0 = c * STEPS, nt = min(STEPS, Tn - t0);
        unsigned char* slot = ring + (c % kWkvSlots) * SLOT;
#pragma unroll
        for (int m = 0; m < (STEPS * PT + NT - 1) / NT; ++m) {
          const int e = tid + m * NT, tt = e / PT, piece = 16 * (e % PT);
          if (e < STEPS * PT && tt < nt) {
            const size_t src = (row0 + (t0 + tt) * tstride) * sizeof(T);
            const int dst = tt * D * static_cast<int>(sizeof(T)) + piece;
            cp_async16(slot + dst,
                       reinterpret_cast<const char*>(r) + src + piece, true);
            cp_async16(slot + RT + dst,
                       reinterpret_cast<const char*>(k) + src + piece, true);
            cp_async16(slot + 2 * RT + dst,
                       reinterpret_cast<const char*>(v) + src + piece, true);
          }
        }
#pragma unroll
        for (int m = 0; m < (STEPS * PF + NT - 1) / NT; ++m) {
          const int e = tid + m * NT, tt = e / PF, piece = 16 * (e % PF);
          if (e < STEPS * PF && tt < nt) {
            cp_async16(slot + 3 * RT + tt * D * 4 + piece,
                       reinterpret_cast<const char*>(
                           log_w + row0 + (t0 + tt) * tstride) + piece,
                       true);
          }
        }
      }
      cp_async_commit();
    };

    // the chunk in fp32, once: a thread takes one of the block's keys at
    // E1 steps, and E2 float4s of v; every load before any store (the
    // rows of a slot past the chunk's end hold stale values, converted and
    // never read)
    constexpr int E1 = STEPS * KB / NT, E2 = STEPS * Q4 / NT;
    static_assert(NT % KB == 0 && STEPS * KB % NT == 0 &&
                      STEPS * Q4 % NT == 0,
                  "a thread converts whole rows' worth of one key and of v");
    const int ckey = kb0 + tid % KB;
    auto convert = [&](const int c) {
      const unsigned char* slot = ring + (c % kWkvSlots) * SLOT;
      const T* rs = reinterpret_cast<const T*>(slot);
      const T* ks = reinterpret_cast<const T*>(slot + RT);
      const T* vs = reinterpret_cast<const T*>(slot + 2 * RT);
      const float* ls = reinterpret_cast<const float*>(slot + 3 * RT);
      const float uk = us[ckey];
      float rv[E1], kv[E1], lv[E1];
      float4 vv[E2];
#pragma unroll
      for (int m = 0; m < E1; ++m) {
        const int o = (tid / KB + m * (NT / KB)) * D + ckey;
        rv[m] = to_f32(rs[o]);
        kv[m] = to_f32(ks[o]);
        lv[m] = ls[o];
      }
#pragma unroll
      for (int m = 0; m < E2; ++m) {
        const int e = tid + m * NT;
        vv[m] = wkv_load4(vs + e / Q4 * D + 4 * (e % Q4));
      }
#pragma unroll
      for (int m = 0; m < E1; ++m) {
        const int e = tid + m * NT;
        rf[e] = rv[m];
        kf[e] = kv[m];
        wf[e] = expf(lv[m]);
        qf[e] = rv[m] * uk * kv[m];
      }
#pragma unroll
      for (int m = 0; m < E2; ++m) {
        const int e = tid + m * NT;
        *reinterpret_cast<float4*>(vf + e / Q4 * D + 4 * (e % Q4)) = vv[m];
      }
    };
    auto step = [&](const int tt) {
      float rr[NI], kk[NI], ww[NI], qq[NI];
      const int o = tt * KB + p * NI;
      wkv_load_run<NI>(rf + o, rr);
      wkv_load_run<NI>(kf + o, kk);
      wkv_load_run<NI>(wf + o, ww);
      wkv_load_run<NI>(qf + o, qq);
      const float4 v4 = *reinterpret_cast<const float4*>(vf + tt * D + col0);
      return wkv_step<NI, P>(st, rr, kk, ww, qq, v4, p);
    };

    issue(0);
    issue(1);
    cp_async_wait<kWkvSlots - 1>();  // chunk 0 has landed
    __syncthreads();                 // and us is written
    convert(0);
    __syncthreads();
    issue(kWkvSlots);
    for (int c = 0; c < nchunks; ++c) {
      const int t0 = c * STEPS, nt = min(STEPS, Tn - t0), buf = c & 1;
      float* yb = yt + buf * STEPS * D + col0;
      if (nt == STEPS) {
        // a whole slot unrolled, its partial y kept in registers until
        // the end: no shared store stands between one step's loads and
        // the next, so steps overlap
        float yv[STEPS];
#pragma unroll
        for (int tt = 0; tt < STEPS; ++tt) yv[tt] = step(tt);
        if (p < 4) {
#pragma unroll
          for (int tt = 0; tt < STEPS; ++tt) yb[tt * D + wkv_col(p)] = yv[tt];
        }
      } else {
        for (int tt = 0; tt < nt; ++tt) {
          const float yv = step(tt);
          if (p < 4) yb[tt * D + wkv_col(p)] = yv;
        }
      }
      cluster_arrive();  // this block's partial y of chunk c is written
      if (c + 1 < nchunks) {  // chunk c + 1 in fp32 while the cluster meets
        cp_async_wait<kWkvSlots - 1>();  // chunk c + 1 has landed
        __syncthreads();  // every warp is done with chunk c's fp32 rows
        convert(c + 1);
        __syncthreads();  // chunk c + 1's slot is free
        issue(c + 1 + kWkvSlots);
      }
      cluster_wait();  // every block's partial y of chunk c is written
      reduce_rows(buf, t0, nt);
    }
    store_state();
    cluster.sync();  // no block leaves while another reads its partial y
  }
}

template <typename T, int D, int KB>
int wkv6_launch(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int B, int Tn, int H, cudaStream_t stream) {
  constexpr int NS = D / KB;
  if (Tn == 1 ? NS != 1 : KB != kWkvKeys)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = wkv_smem_bytes<T, D, KB>(Tn == 1);
  auto kern = wkv6_kernel<T, D, KB>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(B * H * NS));
  if (NS == 1) {  // a plain launch: a cluster of one costs launch time
    kern<<<grid, wkv_threads<D, KB>(), bytes, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const float*>(log_w),
        static_cast<const float*>(u), static_cast<const float*>(s0),
        static_cast<T*>(y), static_cast<float*>(sT), Tn, H);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(wkv_threads<D, KB>());
  cfg.dynamicSmemBytes = static_cast<size_t>(bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), Tn, H);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// keys: the keys a block holds, kWkvKeys (prefill) or D (decode)
template <typename T, int D>
int wkv6_by_keys(const void* r, const void* k, const void* v,
                 const void* log_w, const void* u, const void* s0, void* y,
                 void* sT, int B, int Tn, int H, int keys,
                 cudaStream_t stream) {
  if (keys == kWkvKeys)
    return wkv6_launch<T, D, kWkvKeys>(r, k, v, log_w, u, s0, y, sT, B, Tn,
                                       H, stream);
  if (keys == D)
    return wkv6_launch<T, D, D>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int wkv6_by_dim(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int B, int Tn, int H, int D, int keys,
                cudaStream_t stream) {
  switch (D) {
    case 16:
      return wkv6_by_keys<T, 16>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                 keys, stream);
    case 32:
      return wkv6_by_keys<T, 32>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                 keys, stream);
    case 64:
      return wkv6_by_keys<T, 64>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                 keys, stream);
    case 128:
      return wkv6_by_keys<T, 128>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                  keys, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// RG-LRU (replaces src/repro/kernels/rglru_scan.py:71, rglru_chunked, grid
// (B, W/512, T/128) with the chunk axis sequential and the state in VMEM).
//
//   h_t[c] = a_t[c] * h_{t-1}[c] + b_t[c]    for every channel c = (b, w)
//
// Bound: at recurrentgemma-2b prefill (B 4, T 2560, W 2560) a, b and y are
// 3 x 104.9 MB fp32, 94 us at 3.35 TB/s, against 52 MFLOP: bytes bound
// it.  Decode (T 1) moves 5 x 41 KB and is latency, not bandwidth.
//
// The channels are independent and each one's steps are in order, so the
// kernel is a stream whose speed is the bytes it keeps in flight (Little's
// law: 3.35 TB/s at ~1 us of latency wants ~25 KB an SM).  One warp a
// block owns kLruChannels = 32 channels, one lane each, so every row it
// reads or writes is one 128-byte line: 320 blocks at recurrentgemma-2b,
// 2-3 an SM, all resident at once.  A ring of kLruStages = 4 slots of
// kLruSteps = 32 steps x 32 channels of a and b in shared memory is filled
// with 16-byte cp.async three slots ahead: 24 KB in flight a block, 48-72
// KB an SM (a fifth slot measured slower).  16-channel blocks would spread
// 640 blocks more evenly, but as 64-byte rows; with every block resident
// and HBM shared, the SM with three blocks does not set the pace of a
// stream.  A lane steps its channel through a slot and stores each h
// straight to y, one 128-byte line a step for the warp (staging y in
// shared memory for float4 stores measured 13% slower: one more barrier a
// slot).  When W is not a multiple of 4 or a or b is not 16-byte aligned
// (VEC false) the copies are 4-byte cp.async.  The step is __fmul_rn then
// __fadd_rn, never a contracted FMA, so the kernel equals the plain
// version (a[:, t] * h + b[:, t], two torch ops) bit for bit.  The TPU
// kernel pads T with (a=1, b=0) and W to its tile; the guards here need no
// padding.  Decode (T 1) reads a and b straight from global memory.
// ---------------------------------------------------------------------------

constexpr int kLruChannels = 32;
constexpr int kLruSteps = 32;
constexpr int kLruStages = 4;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <bool VEC>
__global__ void __launch_bounds__(kLruChannels)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ hT, int B, int Tn, int W) {
  __shared__ __align__(16) float as[kLruStages][kLruSteps][kLruChannels];
  __shared__ __align__(16) float bs[kLruStages][kLruSteps][kLruChannels];
  constexpr int kPieces = kLruChannels / 4;  // float4s of a row
  constexpr int kRowsAtOnce = kLruChannels / kPieces;
  const int lane = threadIdx.x;
  const long long nch = static_cast<long long>(B) * W;
  const long long c0 = static_cast<long long>(blockIdx.x) * kLruChannels;
  // this lane's channel, and its offset at step 0
  const long long c = c0 + lane;
  const bool live = c < nch;
  const size_t base =
      live ? static_cast<size_t>(c / W) * Tn * W + static_cast<size_t>(c % W)
           : 0;
  float h = (live && h0 != nullptr) ? h0[c] : 0.f;
  if (Tn == 1) {
    if (live) {
      h = __fadd_rn(__fmul_rn(a[base], h), b[base]);
      y[base] = h;
      hT[c] = h;
    }
    return;
  }
  // the float4 piece this lane copies: channels cq .. cq + 3 (never across
  // a batch row: W % 4 == 0 on this path), rows row0 + 4 j
  const int q = lane % kPieces, row0 = lane / kPieces;
  const long long cq = c0 + 4 * q;
  const bool qlive = cq < nch;
  const size_t qbase =
      qlive ? static_cast<size_t>(cq / W) * Tn * W + static_cast<size_t>(cq % W)
            : 0;
  const int nchunks = (Tn + kLruSteps - 1) / kLruSteps;

  auto issue = [&](const int ck) {
    if (ck < nchunks) {
      const int t0 = ck * kLruSteps, nt = min(kLruSteps, Tn - t0);
      const int s = ck % kLruStages;
      if constexpr (VEC) {
        if (qlive) {
          for (int tt = row0; tt < nt; tt += kRowsAtOnce) {
            const size_t off = qbase + static_cast<size_t>(t0 + tt) * W;
            cp_async16(&as[s][tt][4 * q], a + off, true);
            cp_async16(&bs[s][tt][4 * q], b + off, true);
          }
        }
      } else if (live) {
        for (int tt = 0; tt < nt; ++tt) {
          const size_t off = base + static_cast<size_t>(t0 + tt) * W;
          cp_async4(&as[s][tt][lane], a + off);
          cp_async4(&bs[s][tt][lane], b + off);
        }
      }
    }
    cp_async_commit();
  };

  for (int ck = 0; ck < kLruStages - 1; ++ck) issue(ck);
  for (int ck = 0; ck < nchunks; ++ck) {
    const int t0 = ck * kLruSteps, nt = min(kLruSteps, Tn - t0);
    const int s = ck % kLruStages;
    issue(ck + kLruStages - 1);  // into the slot chunk ck - 1 left
    cp_async_wait<kLruStages - 1>();  // chunk ck has landed
    __syncthreads();
    // each step's h straight to y: the warp's 32 lanes store one 128-byte
    // line a step
    if (nt == kLruSteps) {
#pragma unroll
      for (int tt = 0; tt < kLruSteps; ++tt) {
        h = __fadd_rn(__fmul_rn(as[s][tt][lane], h), bs[s][tt][lane]);
        if (live) y[base + static_cast<size_t>(t0 + tt) * W] = h;
      }
    } else {
      for (int tt = 0; tt < nt; ++tt) {
        h = __fadd_rn(__fmul_rn(as[s][tt][lane], h), bs[s][tt][lane]);
        if (live) y[base + static_cast<size_t>(t0 + tt) * W] = h;
      }
    }
    __syncthreads();  // the slot is free for the copy ck + kLruStages
  }
  if (live) hT[c] = h;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike)
int launch_flash_simt(const void* q, const void* k, const void* v,
                      const void* qpos, const void* kvpos, void* out,
                      int dtype, int B, int Sq, int Skv, int H, int K, int D,
                      int Dv, int causal, int window, float scale,
                      cudaStream_t stream) {
  if (dtype == 0)
    return flash_by_dim<float>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H, K,
                               D, Dv, causal, window, scale, stream);
  if (dtype == 1)
    return flash_by_dim<__nv_bfloat16>(q, k, v, qpos, kvpos, out, B, Sq, Skv,
                                       H, K, D, Dv, causal, window, scale,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_flash_decode_combine(const void* part_ml, const void* part_acc,
                                void* out, int dtype, int rows, int splits,
                                int D, cudaStream_t stream);

// q, k (head dim D), v (head dim Dv): dtype 0 float32, 1 bfloat16;
// part_ml (B, Sq, H, splits, 2) and part_acc (B, Sq, H, splits, Dv)
// float32 scratch.  With out (B, Sq, H, Dv) in q's dtype not null, the
// combine follows on the stream: one call from the host for the pair,
// whose host time decode pays every step.
int launch_flash_decode(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kvpos, void* part_ml,
                        void* part_acc, void* out, int dtype, int B, int Sq,
                        int Skv, int H, int K, int D, int Dv, int groups,
                        int per_split, int splits, int causal, int window,
                        float scale, cudaStream_t stream) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    err = decode_by_dim<float>(q, k, v, qpos, kvpos, part_ml, part_acc, B,
                               Sq, Skv, H, K, D, Dv, groups, per_split,
                               splits, causal, window, scale, stream);
  if (dtype == 1)
    err = decode_by_dim<__nv_bfloat16>(q, k, v, qpos, kvpos, part_ml,
                                       part_acc, B, Sq, Skv, H, K, D, Dv,
                                       groups, per_split, splits, causal,
                                       window, scale, stream);
  if (err != 0 || out == nullptr) return err;
  return launch_flash_decode_combine(part_ml, part_acc, out, dtype,
                                     B * Sq * H, splits, Dv, stream);
}

// out: (rows, D) in dtype (0 float32, 1 bfloat16), rows = B * Sq * H; D
// is the output's width, v's head dim
int launch_flash_decode_combine(const void* part_ml, const void* part_acc,
                                void* out, int dtype, int rows, int splits,
                                int D, cudaStream_t stream) {
  if (dtype == 0)
    return combine_by_dim<float>(part_ml, part_acc, out, rows, splits, D,
                                 stream);
  if (dtype == 1)
    return combine_by_dim<__nv_bfloat16>(part_ml, part_acc, out, rows,
                                         splits, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype: 0 float32, 1 bfloat16 (r, k, v and y); log_w, u and the states
// are float32; keys: the keys a block holds (rwkv6_scan.py:plan), 16 in
// prefill (a cluster of D / 16 blocks a head) or D in decode
int launch_wkv6(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int dtype, int B, int Tn, int H, int D, int keys,
                cudaStream_t stream) {
  if (dtype == 0)
    return wkv6_by_dim<float>(r, k, v, log_w, u, s0, y, sT, B, Tn, H, D,
                              keys, stream);
  if (dtype == 1)
    return wkv6_by_dim<__nv_bfloat16>(r, k, v, log_w, u, s0, y, sT, B, Tn,
                                      H, D, keys, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a, b, y: (B, T, W) float32; h0 (may be null: zeros) and hT: (B, W)
// float32; vec: W % 4 == 0 and a, b 16-byte aligned (rglru_scan.py
// decides), else 4-byte copies
int launch_rglru(const void* a, const void* b, const void* h0, void* y,
                 void* hT, int B, int Tn, int W, int vec,
                 cudaStream_t stream) {
  const long long channels = static_cast<long long>(B) * W;
  const unsigned blocks =
      static_cast<unsigned>((channels + kLruChannels - 1) / kLruChannels);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* hf = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* tf = static_cast<float*>(hT);
  if (vec)
    rglru_kernel<true><<<blocks, kLruChannels, 0, stream>>>(af, bf, hf, yf,
                                                            tf, B, Tn, W);
  else
    rglru_kernel<false><<<blocks, kLruChannels, 0, stream>>>(af, bf, hf, yf,
                                                             tf, B, Tn, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
