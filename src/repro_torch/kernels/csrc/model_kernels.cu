// Hopper (sm_90a) kernels of the serving path: GQA flash attention with
// position masks, the RWKV6 WKV recurrence and the RG-LRU recurrence.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes.  Every launcher takes device pointers and the
// caller's stream, launches on that stream without synchronising, and
// returns cudaGetLastError() (0 on success).  The Python wrappers
// (flash_attention.py, rwkv6_scan.py, rglru_scan.py) check device, dtype,
// shape and contiguity before they call in.  All three kernels are simple
// first versions: fp32 arithmetic on the CUDA cores, no tensor cores, no
// TMA.

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
// Flash attention (replaces src/repro/kernels/flash_attention.py:106,
// flash_attention, grid (B, Hq, nq, nk) with the KV axis sequential).
//
// One block per (q tile of BQ rows, query head h, batch b); the block walks
// the KV axis in tiles of 64 keys held in shared memory, carrying the
// online softmax (row max m, row sum l, output accumulator) in registers.
// Query head h reads KV head h / G for any G (12 / 4 = 3 at lm100m).  The
// 256 threads form 16 row groups x 16 columns: a thread holds RM = BQ/16
// rows of the 64-key score tile (keys tx, tx+16, tx+32, tx+48) and D/16
// columns of the output; a row's max and sum are reduced over its 16
// lanes with shuffles.  Shared rows are padded to D+1 floats, so the
// 16 lanes of a row group read 16 banks.
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
// (10 us at 3.35 TB/s) of q, k, v and out: operations bound it.  Decode
// (Sq 1) reads the 577-slot cache, 9.5 MB (2.8 us): bytes bound it.  At
// recurrentgemma-2b (10 query heads of 256 on one KV head, window 2048)
// prefill over 2560 tokens has 3,146,752 visible pairs per head, 128.9
// GFLOP a layer (1.92 ms in fp32; in bf16, 0.130 ms at the 989 TFLOP/s
// tensor-core peak): operations; decode reads the 2048-slot ring,
// 8.4 MB (2.5 us): bytes.  D 256 takes 214,016 bytes of shared memory at
// 64 rows and 152,192 at 16, so one block fits an SM.  This kernel does
// its FMAs on the CUDA cores and stages every tile through shared memory;
// tensor cores (TF32 stays off for fp32, so wgmma would need bf16
// operands) are later work.
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

template <typename T, int D>
int flash_by_rows(const void* q, const void* k, const void* v,
                  const void* qpos, const void* kvpos, void* out, int B,
                  int Sq, int Skv, int H, int K, int causal, int window,
                  float scale, cudaStream_t stream) {
  // decode (Sq 1) takes 16-row tiles, so a block does a quarter of the
  // score work of a 64-row tile for its one live row
  if (Sq <= 16)
    return flash_launch<T, 16, D>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                  K, causal, window, scale, stream);
  return flash_launch<T, 64, D>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H, K,
                                causal, window, scale, stream);
}

template <typename T>
int flash_by_dim(const void* q, const void* k, const void* v,
                 const void* qpos, const void* kvpos, void* out, int B,
                 int Sq, int Skv, int H, int K, int D, int causal,
                 int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return flash_by_rows<T, 16>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                  K, causal, window, scale, stream);
    case 32:
      return flash_by_rows<T, 32>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                  K, causal, window, scale, stream);
    case 64:
      return flash_by_rows<T, 64>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                  K, causal, window, scale, stream);
    case 128:
      return flash_by_rows<T, 128>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                   K, causal, window, scale, stream);
    case 256:
      return flash_by_rows<T, 256>(q, k, v, qpos, kvpos, out, B, Sq, Skv, H,
                                   K, causal, window, scale, stream);
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
int launch_flash_attention(const void* q, const void* k, const void* v,
                           const void* qpos, const void* kvpos, void* out,
                           int dtype, int B, int Sq, int Skv, int H, int K,
                           int D, int causal, int window, float scale,
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
