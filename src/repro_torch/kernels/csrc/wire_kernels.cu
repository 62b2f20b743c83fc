// Hopper (sm_90a) kernels of the Hermes wire path: int4, int8 and fp32
// merges, the int4 nibble pack, and the flat int8 quantize / dequantize.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes.  Every launcher takes device pointers and the
// caller's stream, launches on that stream without synchronising, and
// returns cudaGetLastError() (0 on success).  The Python wrappers check
// device, dtype, shape and contiguity before they call in.
//
// None of these kernels does a matrix product: each streams its operands
// once, so each is bound by HBM bytes.  The design is a grid-stride
// elementwise pass (a warp per 256-block for the quantize, whose scale is
// a block reduction) with neighbouring threads on neighbouring addresses,
// and 32-bit index arithmetic whenever every index of the launch fits,
// since 64-bit division costs tens of instructions per element.  Byte
// counts are for one pass over the lm100m tree (124,670,208 fp32
// parameters) with 4 pods stacked, at 3.35 TB/s (H100 SXM data sheet).
//
// The floating-point kernels use __fmul_rn / __fadd_rn / __fdiv_rn, which
// nvcc never contracts into an FMA, so each equals its plain PyTorch
// version (one rounding per operation, pods accumulated in order) bit for
// bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;        // absmax quantization block
constexpr int kHalf = kBlock / 2;  // packed bytes per block
constexpr int kThreads = 256;

inline unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  // grid-stride loops cover the rest: 132 SMs x 16 resident blocks
  const long long cap = 132LL * 16LL;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}

inline bool fits32(long long max_index) { return max_index < (1LL << 31); }

__device__ __forceinline__ int8_t nibble_join(int lo, int hi) {
  const int v = ((hi & 0xF) << 4) | (lo & 0xF);  // [0, 255]
  return static_cast<int8_t>(v >= 128 ? v - 256 : v);
}

__device__ __forceinline__ int nibble_lo(int p) { return ((p & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nibble_hi(int p) { return p >> 4; }  // arithmetic

// Packed byte (o, b*128 + j, i) of a (outer, dh, inner) output pairs
// elements (o, b*256 + j, i) (low nibble) and (o, b*256 + 128 + j, i)
// (high nibble) of the (outer, 2*dh, inner) input.  The blocked axis stays
// in the middle, so a leaf blocked on a middle axis (the stacked attention
// wq (4, 12, 768, 12, 64)) needs no moveaxis copy.
template <typename I>
__global__ void pack_int4_kernel(const int8_t* __restrict__ q,
                                 int8_t* __restrict__ p, I dh, I inner,
                                 I n_out) {
  for (I n = blockIdx.x * (I)blockDim.x + threadIdx.x; n < n_out;
       n += (I)gridDim.x * blockDim.x) {
    const I i = n % inner;
    const I t = n / inner;
    const I jj = t % dh;
    const I o = t / dh;
    const I base = (o * 2 * dh + (jj / kHalf) * kBlock + jj % kHalf) * inner + i;
    p[n] = nibble_join(q[base], q[base + kHalf * inner]);
  }
}

// Inverse of pack_int4_kernel: one thread per packed byte writes its two
// sign-extended nibbles.
template <typename I>
__global__ void unpack_int4_kernel(const int8_t* __restrict__ p,
                                   int8_t* __restrict__ q, I dh, I inner,
                                   I n_in) {
  for (I n = blockIdx.x * (I)blockDim.x + threadIdx.x; n < n_in;
       n += (I)gridDim.x * blockDim.x) {
    const I i = n % inner;
    const I t = n / inner;
    const I jj = t % dh;
    const I o = t / dh;
    const I base = (o * 2 * dh + (jj / kHalf) * kBlock + jj % kHalf) * inner + i;
    const int v = p[n];
    q[base] = static_cast<int8_t>(nibble_lo(v));
    q[base + kHalf * inner] = static_cast<int8_t>(nibble_hi(v));
  }
}

// out (o, e, i) = any_push ? (denom*g + sum_k w2_k*(nib_k*s_k)) / denom : g
// over the canonical packed payload (n_pods, outer, nb*128, inner) and its
// scales (n_pods, outer, nb, inner).  One thread per output element; the
// zero padding of the last block (e >= d) is never visited, instead of
// padding g.  scal = [denom, any_push, w2_0 .. w2_{P-1}] lives on the
// device, so the launch needs no host sync.
template <typename I>
__global__ void dequant_merge_packed_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ qp,
    const float* __restrict__ scales, const float* __restrict__ scal,
    float* __restrict__ out, int n_pods, I d, I inner, I nb, I n_out,
    I pod_bytes, I pod_scales) {
  const float denom = scal[0];
  const bool any_push = scal[1] > 0.5f;
  for (I n = blockIdx.x * (I)blockDim.x + threadIdx.x; n < n_out;
       n += (I)gridDim.x * blockDim.x) {
    const float gv = g[n];
    if (!any_push) {
      out[n] = gv;
      continue;
    }
    const I i = n % inner;
    const I t = n / inner;
    const I e = t % d;
    const I o = t / d;
    const I blk = o * nb + e / kBlock;
    const I k = e % kBlock;
    const bool high = k >= kHalf;
    const I byte_idx = (blk * kHalf + k % kHalf) * inner + i;
    const I scale_idx = blk * inner + i;
    float acc = __fmul_rn(denom, gv);
    for (int pod = 0; pod < n_pods; ++pod) {
      const int v = qp[pod * pod_bytes + byte_idx];
      const float nib = static_cast<float>(high ? nibble_hi(v) : nibble_lo(v));
      const float s = scales[pod * pod_scales + scale_idx];
      acc = __fadd_rn(acc, __fmul_rn(scal[2 + pod], __fmul_rn(nib, s)));
    }
    out[n] = __fdiv_rn(acc, denom);
  }
}

// out = any_push ? (w1*g + sum_k w2_k*pods_k) / denom : g, flat.
// scal = [w1, denom, any_push, w2_0 .. w2_{P-1}] on the device.
template <typename I>
__global__ void loss_weighted_update_kernel(
    const float* __restrict__ g, const float* __restrict__ pods,
    const float* __restrict__ scal, float* __restrict__ out, int n_pods,
    I n) {
  const float w1 = scal[0];
  const float denom = scal[1];
  const bool any_push = scal[2] > 0.5f;
  for (I idx = blockIdx.x * (I)blockDim.x + threadIdx.x; idx < n;
       idx += (I)gridDim.x * blockDim.x) {
    const float gv = g[idx];
    if (!any_push) {
      out[idx] = gv;
      continue;
    }
    float acc = __fmul_rn(w1, gv);
    for (int pod = 0; pod < n_pods; ++pod) {
      acc = __fadd_rn(acc, __fmul_rn(scal[3 + pod], pods[pod * n + idx]));
    }
    out[idx] = __fdiv_rn(acc, denom);
  }
}

// out (o, e, i) = any_push ? (denom*g + sum_k w2_k*(q_k*s_k)) / denom : g
// over the trimmed int8 payload q (n_pods, outer, d, inner), which has g's
// layout per pod, and its scales (n_pods, outer, nb, inner).  One thread
// per output element, as dequant_merge_packed_kernel without the nibbles.
template <typename I>
__global__ void dequant_merge_kernel(
    const float* __restrict__ g, const int8_t* __restrict__ q,
    const float* __restrict__ scales, const float* __restrict__ scal,
    float* __restrict__ out, int n_pods, I d, I inner, I nb, I n_out,
    I pod_scales) {
  const float denom = scal[0];
  const bool any_push = scal[1] > 0.5f;
  for (I n = blockIdx.x * (I)blockDim.x + threadIdx.x; n < n_out;
       n += (I)gridDim.x * blockDim.x) {
    const float gv = g[n];
    if (!any_push) {
      out[n] = gv;
      continue;
    }
    const I i = n % inner;
    const I t = n / inner;
    const I e = t % d;
    const I o = t / d;
    const I scale_idx = (o * nb + e / kBlock) * inner + i;
    float acc = __fmul_rn(denom, gv);
    for (int pod = 0; pod < n_pods; ++pod) {
      const float qv = static_cast<float>(q[pod * n_out + n]);
      const float s = scales[pod * pod_scales + scale_idx];
      acc = __fadd_rn(acc, __fmul_rn(scal[2 + pod], __fmul_rn(qv, s)));
    }
    out[n] = __fdiv_rn(acc, denom);
  }
}

// NaN-propagating max, as torch.amax and jnp.max reduce.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Flat blockwise absmax int8 of x[0, n): one warp per 256-element block
// (8 consecutive elements per lane, two float4 loads when the block is
// whole and x is 16-byte aligned), the absmax reduced by warp shuffles,
// one 8-byte store of q per lane.  Elements past n quantize as zeros, the
// plain version's padding.
template <bool kVec>
__global__ void quantize_int8_kernel(const float* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales, long long n,
                                     long long nb) {
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long b = (static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x) >> 5;
       b < nb; b += warps) {
    const long long base = b * kBlock + lane * 8;
    float v[8];
    if (kVec && base + 8 <= n) {
      const float4 lo = *reinterpret_cast<const float4*>(x + base);
      const float4 hi = *reinterpret_cast<const float4*>(x + base + 4);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = base + k < n ? x[base + k] : 0.f;
    }
    float m = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) m = max_nan(m, fabsf(v[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max_nan(m, __shfl_xor_sync(0xffffffffu, m, off));
    float s = __fdiv_rn(m, 127.f);
    s = s != s ? s : fmaxf(s, 1e-12f);
    unsigned words[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      // rintf rounds half to even, as torch.round and jnp.round do
      const float r = fminf(fmaxf(rintf(__fdiv_rn(v[k], s)), -127.f), 127.f);
      words[k >> 2] |= (static_cast<unsigned>(static_cast<int>(r)) & 0xFFu)
                       << (8 * (k & 3));
    }
    *reinterpret_cast<uint2*>(q + base) = make_uint2(words[0], words[1]);
    if (lane == 0) scales[b] = s;
  }
}

// out[j] = q[j] * scales[j / 256] for j < n; four elements per thread, a
// 4-byte load of q and a float4 store of out when all four are in range
// and q is 4-byte aligned.
template <bool kVec>
__global__ void dequantize_int8_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x * 4;
  for (long long j = (static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x) * 4;
       j < n; j += stride) {
    const float s = scales[j / kBlock];  // a quad never straddles two blocks
    if (kVec && j + 4 <= n) {
      const char4 c = *reinterpret_cast<const char4*>(q + j);
      *reinterpret_cast<float4*>(out + j) =
          make_float4(__fmul_rn(static_cast<float>(c.x), s),
                      __fmul_rn(static_cast<float>(c.y), s),
                      __fmul_rn(static_cast<float>(c.z), s),
                      __fmul_rn(static_cast<float>(c.w), s));
    } else {
      for (long long k = j; k < n && k < j + 4; ++k)
        out[k] = __fmul_rn(static_cast<float>(q[k]), s);
    }
  }
}

}  // namespace

extern "C" {

// Replaces src/repro/kernels/pack.py:pack_int4 (_pack_kernel).  Bound by
// HBM bytes: reads 1 B and writes 0.5 B per element; at lm100m x 4 pods
// 498.7 MB + 249.3 MB = 748.0 MB, 0.223 ms at 3.35 TB/s.
// q: (outer, 2*dh, inner) int8 -> p: (outer, dh, inner) int8, dh % 128 == 0.
int launch_pack_int4(const void* q, void* p, long long outer, long long dh,
                     long long inner, void* stream) {
  const long long n = outer * dh * inner;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(2 * n)) {
    pack_int4_kernel<unsigned><<<grid_for(n), kThreads, 0, s>>>(
        (const int8_t*)q, (int8_t*)p, (unsigned)dh, (unsigned)inner,
        (unsigned)n);
  } else {
    pack_int4_kernel<long long><<<grid_for(n), kThreads, 0, s>>>(
        (const int8_t*)q, (int8_t*)p, dh, inner, n);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/pack.py:unpack_int4 (_unpack_kernel).  Bound
// by HBM bytes, the mirror of pack: 249.3 MB read + 498.7 MB written at
// lm100m x 4 pods, 0.223 ms at 3.35 TB/s.
// p: (outer, dh, inner) int8 -> q: (outer, 2*dh, inner) int8.
int launch_unpack_int4(const void* p, void* q, long long outer, long long dh,
                       long long inner, void* stream) {
  const long long n = outer * dh * inner;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(2 * n)) {
    unpack_int4_kernel<unsigned><<<grid_for(n), kThreads, 0, s>>>(
        (const int8_t*)p, (int8_t*)q, (unsigned)dh, (unsigned)inner,
        (unsigned)n);
  } else {
    unpack_int4_kernel<long long><<<grid_for(n), kThreads, 0, s>>>(
        (const int8_t*)p, (int8_t*)q, dh, inner, n);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge_packed
// (_packed_kernel).  Bound by HBM bytes: g 498.7 MB + packed 249.3 MB +
// scales 7.8 MB read, 498.7 MB written at lm100m x 4 pods = 1.254 GB,
// 0.374 ms at 3.35 TB/s.  g/out: (outer, d, inner) fp32; qp: (n_pods,
// outer, nb*128, inner) int8; scales: (n_pods, outer, nb, inner) fp32.
int launch_dequant_merge_packed(const void* g, const void* qp,
                                const void* scales, const void* scal,
                                void* out, int n_pods, long long outer,
                                long long d, long long inner, long long nb,
                                void* stream) {
  const long long n = outer * d * inner;
  const long long pod_bytes = outer * nb * kHalf * inner;
  const long long pod_scales = outer * nb * inner;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(n) && fits32(n_pods * pod_bytes)) {
    dequant_merge_packed_kernel<unsigned><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const int8_t*)qp, (const float*)scales,
        (const float*)scal, (float*)out, n_pods, (unsigned)d,
        (unsigned)inner, (unsigned)nb, (unsigned)n, (unsigned)pod_bytes,
        (unsigned)pod_scales);
  } else {
    dequant_merge_packed_kernel<long long><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const int8_t*)qp, (const float*)scales,
        (const float*)scal, (float*)out, n_pods, d, inner, nb, n, pod_bytes,
        pod_scales);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/loss_weighted_update.py:loss_weighted_update
// (_kernel).  Bound by HBM bytes: g 498.7 MB + pods 1994.7 MB read,
// 498.7 MB written at lm100m x 4 pods = 2.99 GB, 0.893 ms at 3.35 TB/s.
// g/out: (n,) fp32; pods: (n_pods, n) fp32.
int launch_loss_weighted_update(const void* g, const void* pods,
                                const void* scal, void* out, int n_pods,
                                long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(n_pods * n)) {
    loss_weighted_update_kernel<unsigned><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const float*)pods, (const float*)scal, (float*)out,
        n_pods, (unsigned)n);
  } else {
    loss_weighted_update_kernel<long long><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const float*)pods, (const float*)scal, (float*)out,
        n_pods, n);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge (_kernel, the
// int8 merge).  Bound by HBM bytes: g 498.7 MB + q 498.7 MB + scales 7.8
// MB read, 498.7 MB written at lm100m x 4 pods = 1.504 GB, 0.449 ms at
// 3.35 TB/s.  The trimmed wire q has g's (outer, d, inner) layout per pod,
// so the kernel reads it where it lies: no moveaxis copy, no re-padding of
// q or g and no per-128-lane scale expansion, which the TPU wrapper needs
// for its (32, 128) tiles.  g/out: (outer, d, inner) fp32; q: (n_pods,
// outer, d, inner) int8; scales: (n_pods, outer, nb, inner) fp32.
int launch_dequant_merge(const void* g, const void* q, const void* scales,
                         const void* scal, void* out, int n_pods,
                         long long outer, long long d, long long inner,
                         long long nb, void* stream) {
  const long long n = outer * d * inner;
  const long long pod_scales = outer * nb * inner;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits32(n_pods * n)) {
    dequant_merge_kernel<unsigned><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const int8_t*)q, (const float*)scales,
        (const float*)scal, (float*)out, n_pods, (unsigned)d,
        (unsigned)inner, (unsigned)nb, (unsigned)n, (unsigned)pod_scales);
  } else {
    dequant_merge_kernel<long long><<<grid_for(n), kThreads, 0, s>>>(
        (const float*)g, (const int8_t*)q, (const float*)scales,
        (const float*)scal, (float*)out, n_pods, d, inner, nb, n,
        pod_scales);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/quantize.py:quantize_int8 (_q_kernel).  Bound
// by HBM bytes: 4 B read and 1 B + 4/256 B written per element; over the
// lm100m x 4-pod delta (498.7M elements) 1.995 GB + 0.506 GB = 2.50 GB,
// 0.747 ms at 3.35 TB/s.  The TPU kernel takes 64 blocks per grid step and
// pads the row count to a multiple of 64; here a warp takes one block, so
// q is (ceil(n/256), 256) with no row padding.  x: n fp32 -> q: (nb, 256)
// int8, scales: nb fp32.
int launch_quantize_int8(const void* x, void* q, void* scales, long long n,
                         long long nb, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = grid_for(nb * 32);
  if (reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    quantize_int8_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, n, nb);
  } else {
    quantize_int8_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, n, nb);
  }
  return (int)cudaGetLastError();
}

// Replaces src/repro/kernels/quantize.py:dequantize_int8 (_dq_kernel).
// Bound by HBM bytes: 1 B + 4/256 B read and 4 B written per element;
// 2.50 GB over the lm100m x 4-pod delta, 0.747 ms at 3.35 TB/s.  The TPU
// kernel's grid is rows // 64, so it leaves every row past the last
// multiple of 64 unwritten; this one writes every element below n,
// whatever the row count.  q: (rows, 256) int8, scales: rows fp32 -> out:
// n fp32, rows * 256 >= n.
int launch_dequantize_int8(const void* q, const void* scales, void* out,
                           long long n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = grid_for((n + 3) / 4);
  if (reinterpret_cast<uintptr_t>(q) % 4 == 0) {
    dequantize_int8_kernel<true><<<grid, kThreads, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (float*)out, n);
  } else {
    dequantize_int8_kernel<false><<<grid, kThreads, 0, s>>>(
        (const int8_t*)q, (const float*)scales, (float*)out, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
