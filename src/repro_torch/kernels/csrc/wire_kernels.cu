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
// a block reduction; the int4 pack and unpack, the int4 and int8 merges
// and the loss-weighted update walk tiles of every leaf of a tree in one
// launch, see below)
// with neighbouring threads on neighbouring addresses, and 32-bit index
// arithmetic whenever every index of the launch fits, since 64-bit
// division costs tens of instructions per element.  Byte
// counts are for one pass over the lm100m tree (124,670,208 fp32
// parameters) with 4 pods stacked, at 3.35 TB/s (H100 SXM data sheet).
//
// The floating-point kernels use __fmul_rn / __fadd_rn / __fdiv_rn, which
// nvcc never contracts into an FMA, so each equals its plain PyTorch
// version (one rounding per operation, pods accumulated in order) bit for
// bit.  The three merges take g (and the fp32 merge its pods) in fp32,
// bf16 or fp16, as the reference's kernels take any float leaf: each
// element is widened to fp32 on load, merged in fp32, and rounded once to
// g's dtype on store, as the plain version's final .to(g.dtype) does.

#include <cstdint>
#include <cstring>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

__device__ __forceinline__ int8_t nibble_join(int lo, int hi) {
  const int v = ((hi & 0xF) << 4) | (lo & 0xF);  // [0, 255]
  return static_cast<int8_t>(v >= 128 ? v - 256 : v);
}

__device__ __forceinline__ int nibble_lo(int p) { return ((p & 0xF) ^ 8) - 8; }
__device__ __forceinline__ int nibble_hi(int p) { return p >> 4; }  // arithmetic

// ---- the merges' leaf dtypes ---------------------------------------------
//
// A merge leaf is fp32, bf16 or fp16 (the launchers' dtype codes 0, 1, 2):
// widen on load, round to nearest even once on store.
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// Four consecutive elements of T, 4 * sizeof(T)-byte aligned: one float4
// or one 8-byte access, widened to (or rounded from) fp32.
template <typename T>
__device__ __forceinline__ void load4(const T* p, float v[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    T h[4];
    memcpy(h, &x, sizeof(x));
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = widen(h[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, const float v[4]) {
  if constexpr (sizeof(T) == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else {
    T h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = narrow<T>(v[k]);
    uint2 x;
    memcpy(&x, h, sizeof(x));
    __stcs(reinterpret_cast<uint2*>(p), x);
  }
}

// ---- the int4 pack and unpack -------------------------------------------
//
// A leaf is viewed as (outer, d, inner) around its blocked axis: nf = d /
// 256 whole blocks and rem = d % 256 tail elements.  The nibble side q has
// qrow >= d rows along the axis (pack reads the quantizer's zero-padded q,
// qrow = nb*256; unpack writes the trimmed q, qrow = d) and the wire p has
// prow = nf*128 + htail, htail = ceil(rem/2).  The blocked axis stays in
// the middle, so a leaf blocked on a middle axis (the stacked attention wq
// (4, 12, 768, 12, 64)) needs no moveaxis copy.
//
// Around the blocked axis a whole block is regular.  With L = 128*inner,
// unit (o, b) of p is L contiguous bytes, unit (o, b) of q is 2L, and
//   p[c] = join(q[c], q[L + c])   for c < L,
// so a unit is a whole number of 16-byte slots, and a slot's offsets need
// only its unit: two multiplications by magic numbers the host computed
// (no division) a slot, 32-bit whenever every index of the launch fits.
// Pack makes two uint4 loads and one uint4 store a slot, unpack one load
// and two stores; the nibbles are joined and sign-extended four bytes to a
// 32-bit word with no carry across a byte.  A thread takes kPackUnroll
// slots a tile, every load before any store, so a block keeps 32 KB
// (pack) or 16 KB (unpack) of loads in flight.
//
// The tail of each outer index pairs (k, k + htail): byte k holds element
// k in its low nibble and k + htail in its high one, 0 where that is past
// rem (the wire's short pairing, ref.pack_tail_ref); its tiles go one
// packed byte an item.  A leaf whose base pointers or rows along the outer
// index (qrow*inner, prow*inner bytes) are not 16-byte aligned walks its
// whole blocks byte by byte (vec = 0), inside the kernel.
//
// The leaves travel by value in the kernel's parameters, kPackLeaves a
// launch, as the merges' do; tiles are numbered across the launch (each
// leaf's whole-block tiles, then its tail tiles), and a persistent grid of
// 132 SMs x kPackBlocksPerSm blocks walks them.

constexpr int kPackLeaves = 32;       // leaf descriptors a launch carries
constexpr int kPackBlocksPerSm = 4;   // persistent grid: 132 SMs x 4
constexpr int kPackUnroll = 4;        // slots a thread takes a tile
constexpr int kSlotBytes = 16;        // packed bytes a slot: one uint4
constexpr int kTileSlots = kThreads * kPackUnroll;  // a tail tile: bytes
constexpr int kPackFields = 15;       // int64 fields of a leaf descriptor

struct PackLeaf {
  const int8_t* src;   // pack: the nibbles q; unpack: the wire p
  int8_t* dst;         // pack: p; unpack: q
  long long outer, inner, nf, qrow, prow;
  long long tile0;     // the leaf's first whole-block tile in the launch
  long long tail0;     // and its first tail tile
  unsigned long long m_unit, m_nf;  // magic numbers of 8*inner and nf
  int s_unit, s_nf;                 // and their shifts
  int rem, htail;
  int vec;             // 16-byte slots: pointers and rows aligned
};

struct PackGroup {
  PackLeaf leaf[kPackLeaves];
  long long n_tiles;
  int n_leaves;
};

// n / d as (n * m) >> s with m = ceil(2^s / d), s = 31 + ceil(log2 d):
// exact for every n < 2^31 (kernels/pack.py:fast_div_magic); the 64-bit
// walk divides.
__device__ __forceinline__ unsigned quotient(unsigned n, unsigned,
                                             unsigned long long m, int s) {
  return static_cast<unsigned>((static_cast<unsigned long long>(n) * m) >> s);
}
__device__ __forceinline__ long long quotient(long long n, long long d,
                                              unsigned long long, int) {
  return n / d;
}

// Four packed bytes from four low and four high nibble bytes, and back.
__device__ __forceinline__ unsigned join4(unsigned lo, unsigned hi) {
  return (lo & 0x0F0F0F0Fu) | ((hi & 0x0F0F0F0Fu) << 4);
}
__device__ __forceinline__ unsigned lo4(unsigned p) {
  return __vsub4((p & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned hi4(unsigned p) {
  return __vsub4(((p >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

// The tile walk pack and unpack share.
template <bool kPack, typename I>
__device__ __forceinline__ void pack_tiles(const PackGroup& grp) {
  int li = 0;
  for (long long t = blockIdx.x; t < grp.n_tiles; t += gridDim.x) {
    while (li + 1 < grp.n_leaves && t >= grp.leaf[li + 1].tile0) ++li;
    const PackLeaf& L = grp.leaf[li];
    const int8_t* __restrict__ src = L.src;
    int8_t* __restrict__ dst = L.dst;
    const I inner = static_cast<I>(L.inner);
    const I nf = static_cast<I>(L.nf);
    const I half = kHalf * inner;                      // a unit of p
    const I qo = static_cast<I>(L.qrow) * inner;       // an outer index
    const I po = static_cast<I>(L.prow) * inner;       // of q and of p
    if (t < L.tail0) {
      const I unit = half / kSlotBytes;                // slots a unit
      const I slots = static_cast<I>(L.outer) * nf * unit;
      const I s0 = static_cast<I>(t - L.tile0) * kTileSlots + threadIdx.x;
      I qa[kPackUnroll], pa[kPackUnroll];
#pragma unroll
      for (int u = 0; u < kPackUnroll; ++u) {
        const I s = s0 + u * kThreads;
        const I r = quotient(s, unit, L.m_unit, L.s_unit);  // o*nf + b
        const I o = quotient(r, nf, L.m_nf, L.s_nf);
        const I b = r - o * nf;
        const I c = (s - r * unit) * kSlotBytes;
        qa[u] = o * qo + b * 2 * half + c;
        pa[u] = o * po + b * half + c;
      }
      if (L.vec) {
        uint4 x[kPackUnroll], y[kPackUnroll];
#pragma unroll
        for (int u = 0; u < kPackUnroll; ++u) {
          if (s0 + u * kThreads < slots) {
            if (kPack) {
              x[u] = __ldcs(reinterpret_cast<const uint4*>(src + qa[u]));
              y[u] = __ldcs(reinterpret_cast<const uint4*>(src + qa[u]
                                                           + half));
            } else {
              x[u] = __ldcs(reinterpret_cast<const uint4*>(src + pa[u]));
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kPackUnroll; ++u) {
          if (s0 + u * kThreads < slots) {
            if (kPack) {
              __stcs(reinterpret_cast<uint4*>(dst + pa[u]),
                     make_uint4(join4(x[u].x, y[u].x), join4(x[u].y, y[u].y),
                                join4(x[u].z, y[u].z),
                                join4(x[u].w, y[u].w)));
            } else {
              __stcs(reinterpret_cast<uint4*>(dst + qa[u]),
                     make_uint4(lo4(x[u].x), lo4(x[u].y), lo4(x[u].z),
                                lo4(x[u].w)));
              __stcs(reinterpret_cast<uint4*>(dst + qa[u] + half),
                     make_uint4(hi4(x[u].x), hi4(x[u].y), hi4(x[u].z),
                                hi4(x[u].w)));
            }
          }
        }
        continue;
      }
      // the scalar path: the same slots, byte by byte
      for (int u = 0; u < kPackUnroll; ++u) {
        if (s0 + u * kThreads >= slots) break;
        for (int m = 0; m < kSlotBytes; ++m) {
          if (kPack) {
            dst[pa[u] + m] = nibble_join(src[qa[u] + m],
                                         src[qa[u] + half + m]);
          } else {
            const int v = src[pa[u] + m];
            dst[qa[u] + m] = static_cast<int8_t>(nibble_lo(v));
            dst[qa[u] + half + m] = static_cast<int8_t>(nibble_hi(v));
          }
        }
      }
      continue;
    }
    // the tail: kTileSlots packed bytes a tile, one a thread a step
    const I htail = static_cast<I>(L.htail);
    const I tail = htail * inner;                      // an outer index's
    const I n = static_cast<I>(L.outer) * tail;
    const I e0 = static_cast<I>(t - L.tail0) * kTileSlots + threadIdx.x;
#pragma unroll
    for (int u = 0; u < kPackUnroll; ++u) {
      const I e = e0 + u * kThreads;
      if (e >= n) break;
      const I o = e / tail;
      const I x = e - o * tail;                        // k*inner + i
      const bool paired = x / inner + htail < static_cast<I>(L.rem);
      const I pi = o * po + nf * half + x;
      const I qi = o * qo + nf * 2 * half + x;
      if (kPack) {
        dst[pi] = nibble_join(src[qi], paired ? src[qi + tail] : 0);
      } else {
        const int v = src[pi];
        dst[qi] = static_cast<int8_t>(nibble_lo(v));
        if (paired) dst[qi + tail] = static_cast<int8_t>(nibble_hi(v));
      }
    }
  }
}

// Replaces src/repro/kernels/pack.py:pack_int4 (_pack_kernel), every leaf
// of a tree, its short-paired tail included, in one launch.
template <typename I>
__global__ void __launch_bounds__(kThreads, kPackBlocksPerSm)
pack_int4_kernel(const __grid_constant__ PackGroup grp) {
  pack_tiles<true, I>(grp);
}

// Replaces src/repro/kernels/pack.py:unpack_int4 (_unpack_kernel): the
// inverse of pack_int4_kernel, writing only the leaf's d real elements.
template <typename I>
__global__ void __launch_bounds__(kThreads, kPackBlocksPerSm)
unpack_int4_kernel(const __grid_constant__ PackGroup grp) {
  pack_tiles<false, I>(grp);
}

// Unpacks the leaf descriptors (kPackFields int64 each: src, dst, vec,
// outer, inner, nf, qrow, prow, rem, whole-block tiles, tail tiles,
// m_unit, s_unit, m_nf, s_nf) and launches the persistent grid; ``wide``
// takes 64-bit offsets.
template <bool kPack>
int launch_pack(const long long* desc, int n_leaves, int wide, void* stream) {
  if (n_leaves < 1 || n_leaves > kPackLeaves)
    return (int)cudaErrorInvalidValue;
  PackGroup grp = {};
  long long tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* f = desc + l * kPackFields;
    PackLeaf& L = grp.leaf[l];
    L.src = reinterpret_cast<const int8_t*>(f[0]);
    L.dst = reinterpret_cast<int8_t*>(f[1]);
    L.vec = (int)f[2];
    L.outer = f[3]; L.inner = f[4]; L.nf = f[5]; L.qrow = f[6];
    L.prow = f[7]; L.rem = (int)f[8]; L.htail = (L.rem + 1) / 2;
    L.tile0 = tiles;
    tiles += f[9];
    L.tail0 = tiles;
    tiles += f[10];
    L.m_unit = (unsigned long long)f[11]; L.s_unit = (int)f[12];
    L.m_nf = (unsigned long long)f[13]; L.s_nf = (int)f[14];
  }
  grp.n_tiles = tiles;
  grp.n_leaves = n_leaves;
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  const long long cap = 132LL * kPackBlocksPerSm;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  void (*kernel)(const PackGroup) =
      kPack ? (wide ? pack_int4_kernel<long long> : pack_int4_kernel<unsigned>)
            : (wide ? unpack_int4_kernel<long long>
                    : unpack_int4_kernel<unsigned>);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(grp);
  return (int)cudaGetLastError();
}

// ---- the int4 and int8 merges -------------------------------------------
//
// out (o, e, i) = any_push ? (denom*g + sum_k w2_k*(q_k*s_k)) / denom : g
// for every leaf of a tree in one launch.  A leaf is g viewed as (outer,
// d, inner) around its blocked axis.  Its payload q, per pod, is the
// trimmed int8 wire (g's layout) or the int4 wire (outer, prow, inner):
// byte (o, b*128 + j, i) of a whole block holds element (o, b*256 + j, i)
// in its low nibble and (o, b*256 + 128 + j, i) in its high one, and the
// last block pairs (j, j + htail) (128 when canonical, ceil(rem/2) on the
// trimmed wire).  Scales are (outer, nb, inner) per pod.  Only the real d
// elements are written: g is never padded.
//
// The leaves travel by value in the kernel's parameters (no host-to-device
// copy), kMergeLeaves a launch.  Each leaf is cut into tiles, numbered
// across the launch, and a persistent grid of 132 SMs x kMergeBlocksPerSm
// blocks walks them.  A row tile (inner == 1: the blocked axis is the
// contiguous one) is a run of kRowUnits whole 256-blocks, a warp per block
// per step.  A column tile (inner > 1) is (o, b, a group of kColPairs row
// pairs, 4*tc columns), tc threads across the columns, with the tile's
// row of scales staged in shared memory once.  Either way a thread's slot
// is four outputs along the contiguous axis and the four 128 rows
// further, the two halves an int4 byte pairs: each packed byte is loaded
// once, g and out move as float4 and the payload as 4-byte words, and a
// tile's offsets are decomposed once.  A block that is not whole, or a
// leaf whose rows break that alignment, takes the scalar path.  The
// payload words of kPodChunk pods are loaded before any of them is used.
//
// scal = [denom, any_push, w2_0 .. w2_{P-1}] lives on the device, so the
// launch needs no host sync.  Pods accumulate in order, one rounding per
// operation (w2*s is never hoisted, the division never a reciprocal), so
// each output equals the plain version's bit for bit.

constexpr int kMergeLeaves = 32;       // leaf descriptors a launch carries
constexpr int kMergeBlocksPerSm = 4;   // persistent grid: 132 SMs x 4
constexpr int kRowUnits = 32;          // 256-blocks a row tile, 4 a warp
constexpr int kColPairs = 32;          // row pairs (j, j + 128) a column tile
constexpr int kColWidth = 256;         // most columns a column tile holds
constexpr int kPodChunk = 4;           // pods whose payload loads together
constexpr int kLeafFields = 13;        // int64 fields of a leaf descriptor

struct MergeLeaf {
  const void* g;     // the launch's leaf dtype T, as out
  void* out;
  const int8_t* q;
  const float* scales;
  long long outer, d, inner, nb;
  long long prow;    // payload rows per pod and outer index (int8: d)
  long long tile0;   // the leaf's first tile in the launch
  int htail;         // int4: the pairing distance in the last block
  int tc;            // column tiles: threads across the columns; 0: row tiles
  int vec;           // g/out 16-byte and payload 4-byte accesses align
};

struct MergeGroup {
  MergeLeaf leaf[kMergeLeaves];
  long long n_tiles;
  int n_leaves;
  int has_cols;      // a leaf has column tiles: scales staged in shared memory
};

// A leaf's sizes in the launch's index type, g and out as T.
template <typename T, typename I>
struct LeafView {
  const T* g;
  T* out;
  const int8_t* q;
  const float* scales;
  I outer, d, inner, nb, prow, pod_q, pod_s;
  int htail;
  bool vec;
  __device__ explicit LeafView(const MergeLeaf& L)
      : g(static_cast<const T*>(L.g)), out(static_cast<T*>(L.out)), q(L.q),
        scales(L.scales), outer((I)L.outer), d((I)L.d), inner((I)L.inner),
        nb((I)L.nb), prow((I)L.prow),
        pod_q((I)(L.outer * L.prow * L.inner)),
        pod_s((I)(L.outer * L.nb * L.inner)), htail(L.htail),
        vec(L.vec != 0) {}
};

// Byte m of a little-endian word, sign-extended, and its two nibbles.
__device__ __forceinline__ int word_byte(unsigned w, int m) {
  return static_cast<int>(w << (24 - 8 * m)) >> 24;
}
__device__ __forceinline__ int word_lo(unsigned w, int m) {
  return static_cast<int>(w << (28 - 8 * m)) >> 28;
}
__device__ __forceinline__ int word_hi(unsigned w, int m) {
  return static_cast<int>(w << (24 - 8 * m)) >> 28;
}

// One thread's slot: the four outputs from (o, b*256 + k, i) on along the
// contiguous axis (e for row tiles, i for column tiles) and the four 128
// rows further.  col_sc: the slot's columns of the staged scales (column
// tiles), pod p's at col_sc[p * kColWidth].
template <bool kPacked, bool kCol, typename T, typename I>
__device__ __forceinline__ void merge_slot(const LeafView<T, I>& L, I o, I b,
                                           int k, I i, const float* col_sc,
                                           const float* w2, int n_pods,
                                           float denom, bool push) {
  if (L.vec && (b + 1) * kBlock <= L.d) {
    const I ga = (o * L.d + b * kBlock + k) * L.inner + i;
    const I gb = ga + kHalf * L.inner;
    float acc[8];
    load4(L.g + ga, acc);
    load4(L.g + gb, acc + 4);
    if (!push) {  // g as it was: its widening rounds back exactly
      store4(L.out + ga, acc);
      store4(L.out + gb, acc + 4);
      return;
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m] = __fmul_rn(denom, acc[m]);
    const I qa = kPacked ? (o * L.prow + b * kHalf + k) * L.inner + i : ga;
    const I sa = (o * L.nb + b) * L.inner + i;
    for (int p0 = 0; p0 < n_pods; p0 += kPodChunk) {
      unsigned wa[kPodChunk], wb[kPodChunk];
      float s1[kPodChunk];
#pragma unroll
      for (int c = 0; c < kPodChunk; ++c) {
        if (p0 + c < n_pods) {
          const int8_t* q = L.q + (p0 + c) * L.pod_q;
          wa[c] = __ldg(reinterpret_cast<const unsigned*>(q + qa));
          if (!kPacked)
            wb[c] = __ldg(reinterpret_cast<const unsigned*>(q + gb));
          if (!kCol) s1[c] = __ldg(L.scales + (p0 + c) * L.pod_s + sa);
        }
      }
#pragma unroll
      for (int c = 0; c < kPodChunk; ++c) {
        if (p0 + c < n_pods) {
          const int pod = p0 + c;
          float s[4] = {s1[c], s1[c], s1[c], s1[c]};
          if (kCol) {
            const float4 s4 =
                *reinterpret_cast<const float4*>(col_sc + pod * kColWidth);
            s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
          }
          const float w = w2[pod];
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const int v = kPacked
                ? (m < 4 ? word_lo(wa[c], m) : word_hi(wa[c], m - 4))
                : word_byte(m < 4 ? wa[c] : wb[c], m & 3);
            acc[m] = __fadd_rn(acc[m], __fmul_rn(w, __fmul_rn(
                static_cast<float>(v), s[m & 3])));
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m) acc[m] = __fdiv_rn(acc[m], denom);
    store4(L.out + ga, acc);
    store4(L.out + gb, acc + 4);
    return;
  }
  // the scalar path: element by element, masked to the leaf
  for (int m = 0; m < 8; ++m) {
    const int kk = k + (m >> 2) * kHalf + (kCol ? 0 : (m & 3));
    const I ii = i + (kCol ? (m & 3) : 0);
    const I e = b * kBlock + kk;
    if (e >= L.d || ii >= L.inner) continue;
    const I gi = (o * L.d + e) * L.inner + ii;
    if (!push) {
      L.out[gi] = L.g[gi];
      continue;
    }
    const float gv = widen(L.g[gi]);
    I qi = gi;
    bool high = false;
    if (kPacked) {
      const int hb = b + 1 == L.nb ? L.htail : kHalf;
      high = kk >= hb;
      qi = (o * L.prow + b * kHalf + (high ? kk - hb : kk)) * L.inner + ii;
    }
    const I si = (o * L.nb + b) * L.inner + ii;
    float acc = __fmul_rn(denom, gv);
    for (int pod = 0; pod < n_pods; ++pod) {
      const int v = L.q[pod * L.pod_q + qi];
      const float qv = static_cast<float>(
          kPacked ? (high ? nibble_hi(v) : nibble_lo(v)) : v);
      acc = __fadd_rn(acc, __fmul_rn(w2[pod], __fmul_rn(
          qv, L.scales[pod * L.pod_s + si])));
    }
    L.out[gi] = narrow<T>(__fdiv_rn(acc, denom));
  }
}

// The tile walk both merge kernels share.
template <bool kPacked, typename T, typename I>
__device__ __forceinline__ void merge_tiles(const MergeGroup& grp,
                                            const float* __restrict__ scal,
                                            int n_pods) {
  extern __shared__ float4 merge_smem[];
  float* col_sc = reinterpret_cast<float*>(merge_smem);  // (P, kColWidth)
  float* w2 = col_sc + (grp.has_cols ? n_pods * kColWidth : 0);
  for (int p = threadIdx.x; p < n_pods; p += kThreads) w2[p] = scal[2 + p];
  const float denom = scal[0];
  const bool push = scal[1] > 0.5f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  constexpr int kGroups = kHalf / kColPairs;
  int li = 0;
  for (long long t = blockIdx.x; t < grp.n_tiles; t += gridDim.x) {
    while (li + 1 < grp.n_leaves && t >= grp.leaf[li + 1].tile0) ++li;
    const LeafView<T, I> L(grp.leaf[li]);
    const int tc = grp.leaf[li].tc;
    const I tile = static_cast<I>(t - grp.leaf[li].tile0);
    if (tc == 0) {
      const I units = L.outer * L.nb;
      for (int s = 0; s < kRowUnits / kWarps; ++s) {
        const I u = tile * kRowUnits + s * kWarps + warp;
        if (u >= units) break;
        const I o = u / L.nb;
        merge_slot<kPacked, false, T, I>(L, o, u - o * L.nb, 4 * lane, 0,
                                         nullptr, w2, n_pods, denom, push);
      }
      continue;
    }
    const I width = 4 * tc;
    const I chunks = (L.inner + width - 1) / width;
    const I cc = tile % chunks;
    const I rest = tile / chunks;
    const int rg = static_cast<int>(rest % kGroups);
    const I ob = rest / kGroups;  // o * nb + b
    const I o = ob / L.nb;
    const I i0 = cc * width;
    const int cols = static_cast<int>(L.inner - i0 < width ? L.inner - i0
                                                           : width);
    __syncthreads();  // the previous column tile's readers are done
    if (push) {
      for (int x = threadIdx.x; x < n_pods * cols; x += kThreads) {
        const int pod = x / cols;
        const int c = x - pod * cols;
        col_sc[pod * kColWidth + c] =
            L.scales[pod * L.pod_s + ob * L.inner + i0 + c];
      }
    }
    __syncthreads();
    const int r = threadIdx.x / tc;
    const int c = threadIdx.x - r * tc;
    const I i = i0 + 4 * c;
    if (i >= L.inner) continue;
    for (int j = rg * kColPairs + r; j < (rg + 1) * kColPairs;
         j += kThreads / tc) {
      merge_slot<kPacked, true, T, I>(L, o, ob - o * L.nb, j, i,
                                      col_sc + 4 * c, w2, n_pods, denom,
                                      push);
    }
  }
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge_packed
// (_packed_kernel), every leaf of a tree in one launch.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, kMergeBlocksPerSm)
dequant_merge_packed_kernel(const __grid_constant__ MergeGroup grp,
                            const float* __restrict__ scal, int n_pods) {
  merge_tiles<true, T, I>(grp, scal, n_pods);
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge (_kernel, the
// int8 merge).  The trimmed wire q has g's layout per pod, so the kernel
// reads it where it lies: no moveaxis copy, no re-padding of q or g and no
// per-128-lane scale expansion, which the TPU wrapper needs for its (32,
// 128) tiles.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, kMergeBlocksPerSm)
dequant_merge_kernel(const __grid_constant__ MergeGroup grp,
                     const float* __restrict__ scal, int n_pods) {
  merge_tiles<false, T, I>(grp, scal, n_pods);
}

// Unpacks the leaf descriptors (kLeafFields int64 each: g, out, q,
// scales, outer, d, inner, nb, prow, htail, tc, vec, tiles) and launches
// the persistent grid; every leaf's g and out are T, ``wide`` takes
// 64-bit offsets.
template <bool kPacked, typename T>
int launch_merge_t(const long long* desc, int n_leaves, const void* scal,
                   int n_pods, int wide, void* stream) {
  if (n_leaves < 1 || n_leaves > kMergeLeaves || n_pods < 1)
    return (int)cudaErrorInvalidValue;
  MergeGroup grp = {};
  long long tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* f = desc + l * kLeafFields;
    MergeLeaf& L = grp.leaf[l];
    L.g = reinterpret_cast<const void*>(f[0]);
    L.out = reinterpret_cast<void*>(f[1]);
    L.q = reinterpret_cast<const int8_t*>(f[2]);
    L.scales = reinterpret_cast<const float*>(f[3]);
    L.outer = f[4]; L.d = f[5]; L.inner = f[6]; L.nb = f[7]; L.prow = f[8];
    L.htail = (int)f[9]; L.tc = (int)f[10]; L.vec = (int)f[11];
    L.tile0 = tiles;
    tiles += f[12];
    grp.has_cols |= L.tc != 0;
  }
  grp.n_tiles = tiles;
  grp.n_leaves = n_leaves;
  const long long cap = 132LL * kMergeBlocksPerSm;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  const size_t smem =
      sizeof(float) * n_pods * (1 + (grp.has_cols ? kColWidth : 0));
  const cudaStream_t s = (cudaStream_t)stream;
  void (*kernel)(const MergeGroup, const float*, int) =
      kPacked ? (wide ? dequant_merge_packed_kernel<T, long long>
                      : dequant_merge_packed_kernel<T, unsigned>)
              : (wide ? dequant_merge_kernel<T, long long>
                      : dequant_merge_kernel<T, unsigned>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, s>>>(grp, (const float*)scal, n_pods);
  return (int)cudaGetLastError();
}

// dtype: 0 fp32, 1 bf16, 2 fp16 (the leaves' g and out).
template <bool kPacked>
int launch_merge(const long long* desc, int n_leaves, const void* scal,
                 int n_pods, int dtype, int wide, void* stream) {
  switch (dtype) {
    case 0: return launch_merge_t<kPacked, float>(desc, n_leaves, scal,
                                                  n_pods, wide, stream);
    case 1: return launch_merge_t<kPacked, __nv_bfloat16>(
        desc, n_leaves, scal, n_pods, wide, stream);
    case 2: return launch_merge_t<kPacked, __half>(desc, n_leaves, scal,
                                                   n_pods, wide, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- the loss-weighted update ---------------------------------------------
//
// out = any_push ? (w1*g + sum_i w2_i*pods_i) / denom : g over every flat
// leaf of a tree of one dtype T in one launch: g and out (n,), pods
// (n_pods, n).  Nothing is reused, so the kernel is bound by HBM bytes,
// (2 + n_pods) * sizeof(T) an element.  A slot is 16 bytes of g (4 fp32 or
// 8 bf16 / fp16 elements), the same 16 bytes of every pod and of out; a
// tile is kLwuSlots slots a thread, neighbouring threads on neighbouring
// slots, and a persistent grid of 132 SMs x kLwuBlocksPerSm blocks walks
// the tiles of every leaf, numbered across the launch.  The leaf
// descriptors travel by value in the kernel's parameters, kMergeLeaves a
// launch, as the merges' do.  A thread issues its loads of g and of
// kPodChunk pods for all its slots before it uses any of them, through the
// read-only path (__ldg: the streaming hint __ldcs on the pods, or an L2
// prefetch hint, ran 4-7% slower on the H100; one slot a thread beat two,
// which spill at the 64 registers of 4 blocks an SM, and 4 blocks beat 2,
// 6 or 8: tools/merge_probe.py --sub), and stores out streaming.  w2 sits
// in shared memory, read once a block.  A leaf whose g, pods or out is not
// 16-byte aligned, or whose length is not a whole number of slots (pod
// i's row then breaks the alignment), walks its slots element by element.
//
// The arithmetic is the plain version's: widen to fp32 on load, w1*g, then
// + w2_i*p_i in pod order, then / denom, one rounding per operation, and
// one rounding to T on store; with any_push false out is g's bytes.

constexpr int kLwuSlots = 1;           // 16-byte slots a thread takes a tile
constexpr int kLwuBlocksPerSm = 4;     // persistent grid: 132 SMs x 4
constexpr int kLwuTile = kThreads * kLwuSlots;  // slots a tile
constexpr int kLwuFields = 6;          // int64 fields of a leaf descriptor

struct LwuLeaf {
  const void* g;     // (n,) T
  const void* pods;  // (n_pods, n) T
  void* out;         // (n,) T
  long long n;
  long long tile0;   // the leaf's first tile in the launch
  int vec;           // 16-byte slots: pointers aligned, n whole slots
};

struct LwuGroup {
  LwuLeaf leaf[kMergeLeaves];
  long long n_tiles;
  int n_leaves;
};

// The 16 bytes at p as fp32, and fp32 rounded to T into 16 bytes.
template <typename T>
__device__ __forceinline__ void widen16(uint4 x, float* v) {
  constexpr int kLwuVec = 16 / sizeof(T);
  T h[kLwuVec];
  memcpy(h, &x, sizeof(x));
#pragma unroll
  for (int k = 0; k < kLwuVec; ++k) v[k] = widen(h[k]);
}

template <typename T>
__device__ __forceinline__ uint4 narrow16(const float* v) {
  constexpr int kLwuVec = 16 / sizeof(T);
  T h[kLwuVec];
#pragma unroll
  for (int k = 0; k < kLwuVec; ++k) h[k] = narrow<T>(v[k]);
  uint4 x;
  memcpy(&x, h, sizeof(x));
  return x;
}

// Replaces src/repro/kernels/loss_weighted_update.py:loss_weighted_update
// (_kernel), every leaf of a tree of one dtype in one launch.
// scal = [w1, denom, any_push, w2_0 .. w2_{P-1}] on the device.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads, kLwuBlocksPerSm)
loss_weighted_update_kernel(const __grid_constant__ LwuGroup grp,
                            const float* __restrict__ scal, int n_pods) {
  constexpr int kLwuVec = 16 / sizeof(T);  // elements a slot
  extern __shared__ float lwu_w2[];
  for (int p = threadIdx.x; p < n_pods; p += kThreads) lwu_w2[p] = scal[3 + p];
  const float w1 = scal[0];
  const float denom = scal[1];
  const bool push = scal[2] > 0.5f;
  __syncthreads();
  int li = 0;
  for (long long t = blockIdx.x; t < grp.n_tiles; t += gridDim.x) {
    while (li + 1 < grp.n_leaves && t >= grp.leaf[li + 1].tile0) ++li;
    const LwuLeaf& L = grp.leaf[li];
    const T* g = static_cast<const T*>(L.g);
    const T* pods = static_cast<const T*>(L.pods);
    T* out = static_cast<T*>(L.out);
    const I n = static_cast<I>(L.n);
    const I s0 = static_cast<I>(t - L.tile0) * kLwuTile + threadIdx.x;
    if (L.vec) {
      const I slots = n / kLwuVec;
      uint4 gw[kLwuSlots];
#pragma unroll
      for (int u = 0; u < kLwuSlots; ++u) {
        const I s = s0 + u * kThreads;
        gw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (s < slots) gw[u] = __ldg(reinterpret_cast<const uint4*>(
            g + s * kLwuVec));
      }
      if (!push) {  // g as it was: its widening rounds back exactly
#pragma unroll
        for (int u = 0; u < kLwuSlots; ++u) {
          const I s = s0 + u * kThreads;
          if (s < slots) __stcs(reinterpret_cast<uint4*>(out + s * kLwuVec),
                                gw[u]);
        }
        continue;
      }
      float acc[kLwuSlots][kLwuVec];
      for (int p0 = 0; p0 < n_pods; p0 += kPodChunk) {
        uint4 pw[kPodChunk][kLwuSlots];
#pragma unroll
        for (int c = 0; c < kPodChunk; ++c) {
          if (p0 + c < n_pods) {
            const T* pod = pods + static_cast<I>(p0 + c) * n;
#pragma unroll
            for (int u = 0; u < kLwuSlots; ++u) {
              const I s = s0 + u * kThreads;
              pw[c][u] = make_uint4(0u, 0u, 0u, 0u);
              if (s < slots) pw[c][u] = __ldg(reinterpret_cast<const uint4*>(
                  pod + s * kLwuVec));
            }
          }
        }
        if (p0 == 0) {
#pragma unroll
          for (int u = 0; u < kLwuSlots; ++u) {
            widen16<T>(gw[u], acc[u]);
#pragma unroll
            for (int k = 0; k < kLwuVec; ++k)
              acc[u][k] = __fmul_rn(w1, acc[u][k]);
          }
        }
#pragma unroll
        for (int c = 0; c < kPodChunk; ++c) {
          if (p0 + c < n_pods) {
            const float w = lwu_w2[p0 + c];
#pragma unroll
            for (int u = 0; u < kLwuSlots; ++u) {
              float pv[kLwuVec];
              widen16<T>(pw[c][u], pv);
#pragma unroll
              for (int k = 0; k < kLwuVec; ++k)
                acc[u][k] = __fadd_rn(acc[u][k], __fmul_rn(w, pv[k]));
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kLwuSlots; ++u) {
        const I s = s0 + u * kThreads;
        if (s >= slots) continue;
#pragma unroll
        for (int k = 0; k < kLwuVec; ++k)
          acc[u][k] = __fdiv_rn(acc[u][k], denom);
        __stcs(reinterpret_cast<uint4*>(out + s * kLwuVec),
               narrow16<T>(acc[u]));
      }
      continue;
    }
    // the scalar path: each slot's elements one by one, masked to the leaf
    for (int u = 0; u < kLwuSlots; ++u) {
      const I e0 = (s0 + u * kThreads) * kLwuVec;
      for (int k = 0; k < kLwuVec; ++k) {
        const I e = e0 + k;
        if (e >= n) break;
        if (!push) {
          out[e] = g[e];
          continue;
        }
        float sum = __fmul_rn(w1, widen(g[e]));
        for (int pod = 0; pod < n_pods; ++pod)
          sum = __fadd_rn(sum, __fmul_rn(lwu_w2[pod], widen(
              pods[static_cast<I>(pod) * n + e])));
        out[e] = narrow<T>(__fdiv_rn(sum, denom));
      }
    }
  }
}

// Unpacks the leaf descriptors (kLwuFields int64 each: g, pods, out, n,
// vec, tiles) and launches the persistent grid; ``wide`` takes 64-bit
// offsets (some leaf's n_pods * n reaches 2^31).
template <typename T>
int launch_lwu_t(const long long* desc, int n_leaves, const void* scal,
                 int n_pods, int wide, void* stream) {
  if (n_leaves < 1 || n_leaves > kMergeLeaves || n_pods < 1)
    return (int)cudaErrorInvalidValue;
  LwuGroup grp = {};
  long long tiles = 0;
  for (int l = 0; l < n_leaves; ++l) {
    const long long* f = desc + l * kLwuFields;
    LwuLeaf& L = grp.leaf[l];
    L.g = reinterpret_cast<const void*>(f[0]);
    L.pods = reinterpret_cast<const void*>(f[1]);
    L.out = reinterpret_cast<void*>(f[2]);
    L.n = f[3];
    L.vec = (int)f[4];
    L.tile0 = tiles;
    tiles += f[5];
  }
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  grp.n_tiles = tiles;
  grp.n_leaves = n_leaves;
  const long long cap = 132LL * kLwuBlocksPerSm;
  const unsigned grid = (unsigned)(tiles < cap ? tiles : cap);
  const size_t smem = sizeof(float) * n_pods;
  void (*kernel)(const LwuGroup, const float*, int) =
      wide ? loss_weighted_update_kernel<T, long long>
           : loss_weighted_update_kernel<T, unsigned>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      grp, (const float*)scal, n_pods);
  return (int)cudaGetLastError();
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
// 498.7 MB + 249.3 MB = 748.0 MB, 0.223 ms at 3.35 TB/s.  desc: n_leaves
// (at most kPackLeaves) leaf descriptors, packed in one launch: q (outer,
// qrow, inner) int8 -> p (outer, nf*128 + ceil(rem/2), inner) int8.
int launch_pack_int4(const void* desc, int n_leaves, int wide,
                     void* stream) {
  return launch_pack<true>((const long long*)desc, n_leaves, wide, stream);
}

// Replaces src/repro/kernels/pack.py:unpack_int4 (_unpack_kernel).  Bound
// by HBM bytes, the mirror of pack: 249.3 MB read + 498.7 MB written at
// lm100m x 4 pods, 0.223 ms at 3.35 TB/s.  p (outer, prow, inner) int8 ->
// q (outer, d, inner) int8, desc as for launch_pack_int4.
int launch_unpack_int4(const void* desc, int n_leaves, int wide,
                       void* stream) {
  return launch_pack<false>((const long long*)desc, n_leaves, wide, stream);
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge_packed
// (_packed_kernel).  Bound by HBM bytes: g 498.7 MB + packed 249.3 MB +
// scales 7.8 MB read, 498.7 MB written at lm100m x 4 pods = 1.254 GB,
// 0.374 ms at 3.35 TB/s.  desc: n_leaves (at most kMergeLeaves) leaf
// descriptors of one dtype (0 fp32, 1 bf16, 2 fp16), merged in one
// launch.
int launch_dequant_merge_packed(const void* desc, int n_leaves,
                                const void* scal, int n_pods, int dtype,
                                int wide, void* stream) {
  return launch_merge<true>((const long long*)desc, n_leaves, scal, n_pods,
                            dtype, wide, stream);
}

// Replaces src/repro/kernels/loss_weighted_update.py:loss_weighted_update
// (_kernel).  Bound by HBM bytes: g 498.7 MB + pods 1994.7 MB read,
// 498.7 MB written at lm100m x 4 pods = 2.99 GB, 0.893 ms at 3.35 TB/s.
// desc: n_leaves (at most kMergeLeaves) leaf descriptors of one dtype (0
// fp32, 1 bf16, 2 fp16), g and out (n,), pods (n_pods, n), updated in one
// launch.
int launch_loss_weighted_update(const void* desc, int n_leaves,
                                const void* scal, int n_pods, int dtype,
                                int wide, void* stream) {
  const long long* d = (const long long*)desc;
  switch (dtype) {
    case 0: return launch_lwu_t<float>(d, n_leaves, scal, n_pods, wide,
                                       stream);
    case 1: return launch_lwu_t<__nv_bfloat16>(d, n_leaves, scal, n_pods,
                                               wide, stream);
    case 2: return launch_lwu_t<__half>(d, n_leaves, scal, n_pods, wide,
                                        stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Replaces src/repro/kernels/dequant_merge.py:dequant_merge (_kernel, the
// int8 merge).  Bound by HBM bytes: g 498.7 MB + q 498.7 MB + scales 7.8
// MB read, 498.7 MB written at lm100m x 4 pods = 1.504 GB, 0.449 ms at
// 3.35 TB/s.  desc and dtype as for launch_dequant_merge_packed.
int launch_dequant_merge(const void* desc, int n_leaves, const void* scal,
                         int n_pods, int dtype, int wide, void* stream) {
  return launch_merge<false>((const long long*)desc, n_leaves, scal, n_pods,
                             dtype, wide, stream);
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
