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
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
// at every head dim, and in bf16 at head dims 16 and 32.
//
// One block per (q tile of 64 rows, query head h, batch b); the block
// walks the KV axis in tiles of 64 keys held in shared memory, carrying the
// online softmax (row max m, row sum l, output accumulator) in registers.
// Query head h reads KV head h / G for any G (12 / 4 = 3 at lm100m).  The
// 256 threads form 16 row groups x 16 columns: a thread holds 4 rows of
// the 64-key score tile (keys tx, tx+16, tx+32, tx+48) and D/16 columns of
// the output; a row's max and sum are reduced over its 16 lanes with
// shuffles.  Shared rows are padded to D+1 floats, so the 16 lanes of a row
// group read 16 banks.
//
// Masks come from the positions, element by element (kv_pos >= 0, causal
// kv_pos <= q_pos, window q_pos - kv_pos < window), as in the reference's
// naive_attention; the TPU kernel's wrapper drops the positions, which is
// wrong in decode.  A KV tile is skipped, loads included, only when its
// position range shows every pair masked: no written slot, or (causal) its
// least position after the tile's last query, or (window) the tile's
// nearest key already out of the window.  The TPU kernel's index-based
// skip holds only for contiguous positions.  Masked scores are -1e30 and
// the row sum is floored at 1e-30, so a masked tile behaves as in the TPU
// kernel.  The scale multiplies q once, before q k^T.
//
// Bound: at lm100m prefill (B 8, 12 heads of 64, Sq 512 against a 577-slot
// cache) the 131,328 visible pairs per head cost 4*D FLOPs each, 3.23
// GFLOP a layer, 48 us at the 67 TFLOP/s fp32 peak, against 34.6 MB
// (10 us at 3.35 TB/s) of q, k, v and out: operations bound it.  At
// recurrentgemma-2b in fp32 (10 query heads of 256 on one KV head, window
// 2048, prefill over 2560 tokens) 128.9 GFLOP a layer, 1.92 ms at the fp32
// peak: operations.  D 256 takes 214,016 bytes of shared memory, so one
// block fits an SM.  TF32 stays off for fp32, so the tensor cores are not
// used here.
// ---------------------------------------------------------------------------

constexpr int kFaThreads = 256;
constexpr int kBK = 64;
constexpr float kNegInf = -1e30f;

template <int BQ, int D>
constexpr int fa_smem_bytes() {
  return (BQ * (D + 1) + 2 * kBK * (D + 1) + BQ * (kBK + 1)) *
         static_cast<int>(sizeof(float));
}

template <typename T, int BQ, int D>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kvpos, T* __restrict__ out,
                       int Sq, int Skv, int H, int K, int G, int causal,
                       int window, float scale) {
  constexpr int RM = BQ / 16;   // rows per thread
  constexpr int CN = kBK / 16;  // score columns per thread
  constexpr int DN = D / 16;    // output columns per thread
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x LD, already scaled
  float* Ks = Qs + BQ * LD;      // kBK x LD
  float* Vs = Ks + kBK * LD;     // kBK x LD
  float* Ps = Vs + kBK * LD;     // BQ x LP
  __shared__ int kp_s[kBK];
  __shared__ int red_lo[kBK / 32], red_hi[kBK / 32];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / G;

  // the q tile's position range, and each of this thread's rows' position
  // (a padded row past Sq takes the tile's last position; it is not stored)
  int qlo = INT_MAX, qhi = INT_MIN;
  for (int r = 0; r < BQ && q0 + r < Sq; ++r) {
    const int p = qpos[q0 + r];
    qlo = min(qlo, p);
    qhi = max(qhi, p);
  }
  int myq[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty * RM + i;
    myq[i] = s < Sq ? qpos[s] : qpos[min(q0 + BQ, Sq) - 1];
  }

  for (int idx = tid; idx < BQ * D; idx += kFaThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    float val = 0.f;
    if (s < Sq) {
      val = to_f32(q[((static_cast<size_t>(b) * Sq + s) * H + h) * D + d]) *
            scale;
    }
    Qs[r * LD + d] = val;
  }

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Skv; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < kBK) {
      const int s = k0 + tid;
      const int p = s < Skv ? kvpos[s] : -1;
      kp_s[tid] = p;
      const int lo = __reduce_min_sync(0xffffffffu, p >= 0 ? p : INT_MAX);
      const int hi = __reduce_max_sync(0xffffffffu, p);
      if ((tid & 31) == 0) {
        red_lo[tid >> 5] = lo;
        red_hi[tid >> 5] = hi;
      }
    }
    __syncthreads();
    int lo = red_lo[0], hi = red_hi[0];
#pragma unroll
    for (int w = 1; w < kBK / 32; ++w) {
      lo = min(lo, red_lo[w]);
      hi = max(hi, red_hi[w]);
    }
    bool run = hi >= 0;
    if (causal) run = run && lo <= qhi;
    if (window > 0) run = run && qlo - hi < window;
    if (!run) continue;  // uniform over the block

    for (int idx = tid; idx < kBK * D; idx += kFaThreads) {
      const int c = idx / D, d = idx % D, s = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (s < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + s) * K + kh) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[c * LD + d] = kv;
      Vs[c * LD + d] = vv;
    }
    __syncthreads();

    // q.k as one FMA chain over d, in the order of cuBLAS's fp32 GEMM, so
    // the plain path's scores match bit for bit: four interleaved partial
    // sums sit nearer fp64 on random inputs, but move recurrentgemma-2b's
    // random-init fp32 prefill blocks (scores in the thousands) 2e-4 from
    // the plain path, past chip_smoke.py's 1e-5 block check
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kd[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) kd[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float qd = Qs[(ty * RM + i) * LD + d];
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qd, kd[j], sc[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int p = kp_s[tx + 16 * j];
        bool vis = p >= 0;
        if (causal) vis = vis && p <= myq[i];
        if (window > 0) vis = vis && myq[i] - p < window;
        if (!vis) sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty * RM + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vc[DN];
#pragma unroll
      for (int j = 0; j < DN; ++j) vc[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = Ps[(ty * RM + i) * LP + c];
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(p, vc[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty * RM + i;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + ((static_cast<size_t>(b) * Sq + s) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) o[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int BQ, int D>
int flash_launch(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kvpos, void* out, int B,
                 int Sq, int Skv, int H, int K, int causal, int window,
                 float scale, cudaStream_t stream) {
  constexpr int bytes = fa_smem_bytes<BQ, D>();
  auto kern = flash_attention_kernel<T, BQ, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kern<<<grid, kFaThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qpos),
      static_cast<const int*>(kvpos), static_cast<T*>(out), Sq, Skv, H, K,
      H / K, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_by_dim(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kvpos, void* out, int B,
                 int Sq, int Skv, int H, int K, int D, int causal,
                 int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return flash_launch<T, 64, 16>(q, k, v, qpos, kvpos, out, B, Sq,
                                      Skv, H, K, causal, window, scale,
                                      stream);
    case 32:
      return flash_launch<T, 64, 32>(q, k, v, qpos, kvpos, out, B, Sq,
                                      Skv, H, K, causal, window, scale,
                                      stream);
    case 64:
      return flash_launch<T, 64, 64>(q, k, v, qpos, kvpos, out, B, Sq,
                                      Skv, H, K, causal, window, scale,
                                      stream);
    case 128:
      return flash_launch<T, 64, 128>(q, k, v, qpos, kvpos, out, B, Sq,
                                      Skv, H, K, causal, window, scale,
                                      stream);
    case 256:
      return flash_launch<T, 64, 256>(q, k, v, qpos, kvpos, out, B, Sq,
                                      Skv, H, K, causal, window, scale,
                                      stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
// ---------------------------------------------------------------------------

constexpr int kFdThreads = 128;
constexpr int kFdRows = 16;
constexpr int kFdTile = 32;
constexpr int kFcThreads = 256;

template <typename T, int D>
constexpr int fd_smem_bytes() {
  return (2 * D + 16 / static_cast<int>(sizeof(T))) * kFdTile *
             static_cast<int>(sizeof(T)) +
         4 * (kFdRows * kFdTile + 4 * kFdRows + kFdTile + 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

template <typename T, int D>
__global__ void __launch_bounds__(kFdThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ qpos,
                    const int* __restrict__ kvpos,
                    float* __restrict__ part_ml, float* __restrict__ part_acc,
                    int Sq, int Skv, int H, int K, int groups, int per_split,
                    int splits, int causal, int window, float scale) {
  constexpr int VN = 16 / static_cast<int>(sizeof(T));  // values a chunk
  constexpr int CH = D / VN;                // 16-byte chunks of a row
  constexpr int LPK = CH < 32 ? CH : 32;    // lanes per (row, key) score
  constexpr int NV = CH / LPK;              // chunks a lane sums
  constexpr int NG = kFdThreads / LPK;      // keys in flight
  constexpr int NF = LPK < kFdRows ? kFdRows / LPK : 1;  // rows a lane sums
  constexpr int DUP = LPK > kFdRows ? LPK / kFdRows : 1;  // lanes a row
  constexpr int RL = kFdThreads / CH;       // row lanes of P.V
  constexpr int RPT = RL < kFdRows ? kFdRows / RL : 1;  // its rows
  constexpr bool kMma = sizeof(T) == 2;     // bf16: q.k on the tensor cores
  constexpr int KLD = D + VN;               // K rows padded by 16 bytes
  constexpr int KS = D / 16;                // mma steps over the head dim
  static_assert(kFdTile == 8 * (kFdThreads / 32) && kFdRows == 16,
                "the mma path takes 8 keys a warp and 16 rows");
  extern __shared__ __align__(16) unsigned char fd_smem[];
  T* Ks = reinterpret_cast<T*>(fd_smem);    // kFdTile x KLD
  T* Vs = Ks + kFdTile * KLD;               // kFdTile x D
  float* Ss = reinterpret_cast<float*>(Vs + kFdTile * D);  // keys x rows
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
        qa[ks][2 + h8] =
            keep & *reinterpret_cast<const uint32_t*>(qr + 16 * ks + 8);
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
        float x[VN];
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

  const int ch = tid % CH, rl = tid / CH;
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
    for (int idx = tid; idx < kFdTile * CH; idx += kFdThreads) {
      const int c = idx / CH, x = idx % CH, s = k0 + c;
      const size_t off =
          ((static_cast<size_t>(b) * Skv + min(s, Skv - 1)) * K + kh) * D +
          x * VN;
      cp_async16(Vs + c * D + x * VN, v + off, s < s_end);
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
                 *reinterpret_cast<const uint32_t*>(kr + 16 * ks + 8));
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
        unpack16(Vs + c * D + ch * VN, vx);
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
      float* dst = part_acc + (row * splits + split) * D + ch * VN;
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

template <typename T, int D>
int decode_launch(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kvpos, void* part_ml,
                  void* part_acc, int B, int Sq, int Skv, int H, int K,
                  int groups, int per_split, int splits, int causal,
                  int window, float scale, cudaStream_t stream) {
  constexpr int bytes = fd_smem_bytes<T, D>();
  auto kern = flash_decode_kernel<T, D>;
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
                  int groups, int per_split, int splits, int causal,
                  int window, float scale, cudaStream_t stream) {
#define FD_CASE(DIM)                                                         \
  case DIM:                                                                  \
    return decode_launch<T, DIM>(q, k, v, qpos, kvpos, part_ml, part_acc, B, \
                                 Sq, Skv, H, K, groups, per_split, splits,   \
                                 causal, window, scale, stream);
  switch (D) {
    FD_CASE(16)
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(128)
    FD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FD_CASE
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
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] = exp(log_w_t[i]) S[i][j] + k_t[i] v_t[j]
// The TPU kernel's chunked matmul form clamps each cumulative log-decay to
// +-30 on its own, which is wrong once the decay is strong; a step loop has
// no exponent to clamp.  One block per (b, h) with 4*D threads: thread
// (j, part) keeps the state column S[i][j] for the D/4 keys i = part + 4n
// in registers (16 floats at D 64), so the (D, D) state never leaves the
// SM, and four lanes side by side sum y_t[j] with two shuffles.  The keys
// interleave by 4 so the four parts of a warp read four banks of the
// step's r, k and w rows.  16 steps of r, k, v and w = exp(log_w) are
// staged in shared memory at a time (one barrier pair per 16 steps).
//
// Bound: at rwkv6-3b prefill (B 4, T 256, 40 heads of 64) a step costs
// 7*D*D FLOPs per (b, h), 1.17 GFLOP a layer (1.2 us at the 989 TFLOP/s
// bf16 peak of its bf16 inputs; 18 us at the fp32 rate this kernel
// computes at), against 36.7 MB of r, k, v (bf16), log_w (fp32), y and
// the two states (11 us at 3.35 TB/s): bytes bound it.  The steps of one
// head are sequential, and only B*H = 160 blocks of 8 warps exist, so
// latency, not either bound, is expected to set the time.  At T = 1 (decode) the states'
// 5.2 MB dominate: bytes bound it.
// ---------------------------------------------------------------------------

constexpr int kWkvSplit = 4;
constexpr int kWkvSteps = 16;

template <typename T, int D>
__global__ void __launch_bounds__(kWkvSplit * D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ log_w,
            const float* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sT, int Tn, int H) {
  constexpr int NI = D / kWkvSplit;  // keys per thread
  constexpr int NT = kWkvSplit * D;
  __shared__ float rs[kWkvSteps][D], ks[kWkvSteps][D], vs[kWkvSteps][D],
      ws[kWkvSteps][D];
  const int tid = threadIdx.x;
  const int j = tid / kWkvSplit, part = tid % kWkvSplit;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t sbase = static_cast<size_t>(bh) * D * D;

  float S[NI], uu[NI];
#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = part + kWkvSplit * n;
    S[n] = s0[sbase + static_cast<size_t>(i) * D + j];
    uu[n] = u[h * D + i];
  }

  for (int t0 = 0; t0 < Tn; t0 += kWkvSteps) {
    const int nt = min(kWkvSteps, Tn - t0);
    __syncthreads();  // the previous steps' readers are done
    for (int idx = tid; idx < nt * D; idx += NT) {
      const int tt = idx / D, c = idx % D;
      const size_t off =
          ((static_cast<size_t>(b) * Tn + t0 + tt) * H + h) * D + c;
      rs[tt][c] = to_f32(r[off]);
      ks[tt][c] = to_f32(k[off]);
      vs[tt][c] = to_f32(v[off]);
      ws[tt][c] = expf(log_w[off]);
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int i = part + kWkvSplit * n;
        const float kv = ks[tt][i] * vj;
        acc = fmaf(rs[tt][i], fmaf(uu[n], kv, S[n]), acc);
        S[n] = fmaf(ws[tt][i], S[n], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (part == 0) {
        y[((static_cast<size_t>(b) * Tn + t0 + tt) * H + h) * D + j] =
            from_f32<T>(acc);
      }
    }
  }

#pragma unroll
  for (int n = 0; n < NI; ++n) {
    const int i = part + kWkvSplit * n;
    sT[sbase + static_cast<size_t>(i) * D + j] = S[n];
  }
}

template <typename T, int D>
int wkv6_launch(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int B, int Tn, int H, cudaStream_t stream) {
  wkv6_kernel<T, D><<<B * H, kWkvSplit * D, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(log_w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(sT), Tn, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int wkv6_by_dim(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int B, int Tn, int H, int D, cudaStream_t stream) {
  switch (D) {
    case 16:
      return wkv6_launch<T, 16>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                stream);
    case 32:
      return wkv6_launch<T, 32>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                stream);
    case 64:
      return wkv6_launch<T, 64>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                stream);
    case 128:
      return wkv6_launch<T, 128>(r, k, v, log_w, u, s0, y, sT, B, Tn, H,
                                 stream);
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
// The channels are independent, so one thread owns one channel and walks
// T in order with h in a register; 64 threads a block, so B*W = 10,240
// channels at recurrentgemma-2b make 160 blocks over the 132 SMs.  Loads
// and stores are coalesced across w.  The loads of a and b do not depend
// on h, so each thread keeps the next kLruSteps steps' a and b in flight
// (loaded one chunk ahead) while it computes the current chunk.  The step
// is __fmul_rn then __fadd_rn, never a contracted FMA, so the kernel equals
// the plain version (a[:, t] * h + b[:, t], two torch ops) bit for bit.
// The TPU kernel pads T with (a=1, b=0) and W to its tile; the guards here
// need no padding.
//
// Bound: at recurrentgemma-2b prefill (B 4, T 2560, W 2560) a, b and y are
// 3 x 104.9 MB fp32, 94 us at 3.35 TB/s, against 52 MFLOP: bytes bound
// it.  Decode (T 1) moves 5 x 41 KB and is latency, not bandwidth.
// ---------------------------------------------------------------------------

constexpr int kLruThreads = 64;
constexpr int kLruSteps = 8;

__global__ void __launch_bounds__(kLruThreads)
rglru_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ h0, float* __restrict__ y,
             float* __restrict__ hT, int B, int Tn, int W) {
  const long long c = static_cast<long long>(blockIdx.x) * kLruThreads +
                      threadIdx.x;
  if (c >= static_cast<long long>(B) * W) return;
  const long long bi = c / W, w = c % W;
  const size_t base = static_cast<size_t>(bi) * Tn * W + w;
  float h = h0 != nullptr ? h0[c] : 0.f;

  float av[kLruSteps], bv[kLruSteps];
#pragma unroll
  for (int u = 0; u < kLruSteps; ++u) {
    const size_t off = base + static_cast<size_t>(u) * W;
    av[u] = u < Tn ? a[off] : 1.f;
    bv[u] = u < Tn ? b[off] : 0.f;
  }
  for (int t0 = 0; t0 < Tn; t0 += kLruSteps) {
    // the next chunk's loads go out before this chunk's dependent steps
    float an[kLruSteps], bn[kLruSteps];
#pragma unroll
    for (int u = 0; u < kLruSteps; ++u) {
      const int t = t0 + kLruSteps + u;
      const size_t off = base + static_cast<size_t>(t) * W;
      an[u] = t < Tn ? a[off] : 1.f;
      bn[u] = t < Tn ? b[off] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLruSteps; ++u) {
      const int t = t0 + u;
      if (t < Tn) {
        h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
        y[base + static_cast<size_t>(t) * W] = h;
      }
    }
#pragma unroll
    for (int u = 0; u < kLruSteps; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
  }
  hT[c] = h;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike)
int launch_flash_simt(const void* q, const void* k, const void* v,
                      const void* qpos, const void* kvpos, void* out,
                      int dtype, int B, int Sq, int Skv, int H, int K, int D,
                      int causal, int window, float scale,
                      cudaStream_t stream) {
  if (dtype == 0)
    return flash_by_dim<float>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H, K,
                               D, causal, window, scale, stream);
  if (dtype == 1)
    return flash_by_dim<__nv_bfloat16>(q, k, v, qpos, kvpos, out, B, Sq, Skv,
                                       H, K, D, causal, window, scale,
                                       stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_flash_decode_combine(const void* part_ml, const void* part_acc,
                                void* out, int dtype, int rows, int splits,
                                int D, cudaStream_t stream);

// q, k, v: dtype 0 float32, 1 bfloat16; part_ml (B, Sq, H, splits, 2) and
// part_acc (B, Sq, H, splits, D) float32 scratch.  With out (B, Sq, H, D)
// in q's dtype not null, the combine follows on the stream: one call from
// the host for the pair, whose host time decode pays every step.
int launch_flash_decode(const void* q, const void* k, const void* v,
                        const void* qpos, const void* kvpos, void* part_ml,
                        void* part_acc, void* out, int dtype, int B, int Sq,
                        int Skv, int H, int K, int D, int groups,
                        int per_split, int splits, int causal, int window,
                        float scale, cudaStream_t stream) {
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    err = decode_by_dim<float>(q, k, v, qpos, kvpos, part_ml, part_acc, B,
                               Sq, Skv, H, K, D, groups, per_split, splits,
                               causal, window, scale, stream);
  if (dtype == 1)
    err = decode_by_dim<__nv_bfloat16>(q, k, v, qpos, kvpos, part_ml,
                                       part_acc, B, Sq, Skv, H, K, D, groups,
                                       per_split, splits, causal, window,
                                       scale, stream);
  if (err != 0 || out == nullptr) return err;
  return launch_flash_decode_combine(part_ml, part_acc, out, dtype,
                                     B * Sq * H, splits, D, stream);
}

// out: (rows, D) in dtype (0 float32, 1 bfloat16), rows = B * Sq * H
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
// are float32
int launch_wkv6(const void* r, const void* k, const void* v,
                const void* log_w, const void* u, const void* s0, void* y,
                void* sT, int dtype, int B, int Tn, int H, int D,
                cudaStream_t stream) {
  if (dtype == 0)
    return wkv6_by_dim<float>(r, k, v, log_w, u, s0, y, sT, B, Tn, H, D,
                              stream);
  if (dtype == 1)
    return wkv6_by_dim<__nv_bfloat16>(r, k, v, log_w, u, s0, y, sT, B, Tn,
                                      H, D, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// a, b, y: (B, T, W) float32; h0 (may be null: zeros) and hT: (B, W)
// float32
int launch_rglru(const void* a, const void* b, const void* h0, void* y,
                 void* hT, int B, int Tn, int W, cudaStream_t stream) {
  const long long channels = static_cast<long long>(B) * W;
  const long long blocks = (channels + kLruThreads - 1) / kLruThreads;
  rglru_kernel<<<static_cast<unsigned>(blocks), kLruThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), B, Tn, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
