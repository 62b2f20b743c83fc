// Hopper (sm_90a) kernel of the static analyzer's self-test: the
// deliberately mis-tiled copy that proves the tile lint fires.
//
// Built by repro_torch/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound with ctypes, like wire_kernels.cu.  The launcher takes device
// pointers and the caller's stream, launches on that stream without
// synchronising, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

// out = x for a row-major (rows, cols) fp32 array, one block per
// (tile_rows, tile_cols) tile on a (ceil(rows/tile_rows),
// ceil(cols/tile_cols)) grid: thread t of block (i, j) copies column
// j*tile_cols + t of rows i*tile_rows .. i*tile_rows + tile_rows - 1.
// Where the tile does not divide the array, the last tile is partial and
// its threads past the array return: the mask Pallas applies to a partial
// edge block.
__global__ void tile_copy_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int rows, int cols,
                                 int tile_rows) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int r0 = blockIdx.x * tile_rows;
  const int r1 = min(r0 + tile_rows, rows);
  for (int r = r0; r < r1; ++r) {
    const size_t off = static_cast<size_t>(r) * cols + c;
    out[off] = x[off];
  }
}

}  // namespace

extern "C" {

// Replaces src/repro/launch/analyze.py:selftest_bad_tiles (its
// pallas_call copy of a (64, 250) fp32 array in (8, 100) blocks on an
// (8, 3) grid).  Bound by HBM bytes: 64,000 B read and 64,000 B written,
// 0.038 us at 3.35 TB/s, far under the launch's own few microseconds.
// The (8, 100) tile is bad on purpose: 100 does not divide 250, a row of
// it is 400 B (not whole 128-B segments), and its 100 threads are not
// whole warps.
int launch_tile_copy(const void* x, void* out, int rows, int cols,
                     int tile_rows, int tile_cols, void* stream) {
  if (rows <= 0 || cols <= 0 || tile_rows <= 0 || tile_cols <= 0 ||
      tile_cols > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + tile_rows - 1) / tile_rows,
                  (cols + tile_cols - 1) / tile_cols);
  tile_copy_kernel<<<grid, tile_cols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, cols,
      tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
