// CUDA fixed-block aligner: one lane group (a warp; a half warp for block
// 16) per pair, the block's DP column in registers, the 32x32 code table in
// shared memory.  Called from JAX through the XLA FFI (ops/fixed_block.py).
//
// Build (done at first use by block_aligner_jax/native/__init__.py):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> -o libbafixed.so fixed_block.cu

#include <cuda_runtime.h>

#include "fixed_block.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
using namespace ba_fixed;

template <int G_>
struct DeviceLanes {
  static constexpr int G = G_;
  using V = int;
  unsigned mask;
  int lane_id;

  __device__ DeviceLanes() {
    const int wl = threadIdx.x & 31;
    lane_id = wl & (G - 1);
    mask = G == 32 ? 0xffffffffu : (((1u << G) - 1) << (wl & ~(G - 1)));
  }
  __device__ __forceinline__ int lane() const { return lane_id; }
  __device__ __forceinline__ static int splat(int x) { return x; }
  __device__ __forceinline__ static int vmax(int a, int b) { return max(a, b); }
  __device__ __forceinline__ static int vsel(bool c, int a, int b) { return c ? a : b; }
  __device__ __forceinline__ static int vclamp(int x, int lo, int hi) { return min(max(x, lo), hi); }
  __device__ __forceinline__ int shfl_up(int v, int d) const { return __shfl_up_sync(mask, v, d, G); }
  __device__ __forceinline__ int shfl_down(int v, int d) const { return __shfl_down_sync(mask, v, d, G); }
  __device__ __forceinline__ int bcast(int v, int src) const { return __shfl_sync(mask, v, src, G); }
  __device__ __forceinline__ int max_all(int v) const {
#pragma unroll
    for (int d = G / 2; d > 0; d /= 2) v = max(v, __shfl_xor_sync(mask, v, d, G));
    return v;
  }
  __device__ __forceinline__ int load(const uint8_t* p, int idx) const { return p[idx]; }
  __device__ __forceinline__ int score(const int8_t* tab, int c, int code) const {
    return tab[c * 32 + code];
  }
};

constexpr int THREADS = 256;

template <int S, bool XDROP>
__global__ void __launch_bounds__(THREADS) fixed_block_kernel(
    const uint8_t* __restrict__ codes, const int32_t* __restrict__ meta,
    const int8_t* __restrict__ table, int32_t* __restrict__ out, int n_pairs,
    Params prm) {
  constexpr int G = S < 32 ? S : 32;
  __shared__ int8_t tab[32 * 32];
  for (int k = threadIdx.x; k < 32 * 32; k += blockDim.x) tab[k] = table[k];
  __syncthreads();
  const int pair = (blockIdx.x * blockDim.x + threadIdx.x) / G;
  if (pair >= n_pairs) return;  // whole lane groups leave together
  const int32_t* m = meta + 4 * pair;
  Pair p{codes + m[0], codes + m[1], m[2], m[3]};
  DeviceLanes<G> lp;
  Walk<DeviceLanes<G>, S, XDROP> w(lp, tab, prm);
  Result res = w.run(p);
  if (lp.lane() == 0) {
    out[3 * pair + 0] = res.score;
    out[3 * pair + 1] = res.qi;
    out[3 * pair + 2] = res.rj;
  }
}

template <int S, bool XDROP>
static cudaError_t launch(cudaStream_t stream, const uint8_t* codes,
                          const int32_t* meta, const int8_t* table, int32_t* out,
                          int n_pairs, const Params& prm) {
  constexpr int G = S < 32 ? S : 32;
  const int pairs_per_block = THREADS / G;
  const int grid = (n_pairs + pairs_per_block - 1) / pairs_per_block;
  if (grid > 0) {
    fixed_block_kernel<S, XDROP><<<grid, THREADS, 0, stream>>>(codes, meta, table, out,
                                                               n_pairs, prm);
  }
  return cudaGetLastError();
}

template <bool XDROP>
static cudaError_t dispatch(int block, cudaStream_t s, const uint8_t* c, const int32_t* m,
                            const int8_t* t, int32_t* o, int n, const Params& prm) {
  switch (block) {
    case 16: return launch<16, XDROP>(s, c, m, t, o, n, prm);
    case 32: return launch<32, XDROP>(s, c, m, t, o, n, prm);
    case 64: return launch<64, XDROP>(s, c, m, t, o, n, prm);
    case 128: return launch<128, XDROP>(s, c, m, t, o, n, prm);
    case 256: return launch<256, XDROP>(s, c, m, t, o, n, prm);
    case 512: return launch<512, XDROP>(s, c, m, t, o, n, prm);
    default: return cudaErrorInvalidValue;
  }
}

static ffi::Error FixedBlockImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> codes,
                                 ffi::Buffer<ffi::S32> meta, ffi::Buffer<ffi::S8> table,
                                 ffi::ResultBuffer<ffi::S32> out, int32_t block,
                                 int32_t x_drop_mode, int32_t gap_open, int32_t gap_extend,
                                 int32_t x_drop, int32_t byte_mode, int32_t match,
                                 int32_t mismatch) {
  const auto md = meta.dimensions();
  if (md.size() != 2 || md[1] != 4) {
    return ffi::Error::InvalidArgument("meta must be (n_pairs, 4)");
  }
  if (table.element_count() != 32 * 32) {
    return ffi::Error::InvalidArgument("table must hold 32x32 entries");
  }
  const int n = static_cast<int>(md[0]);
  Params prm{gap_open, gap_extend, x_drop, byte_mode, match, mismatch};
  cudaError_t err = x_drop_mode
      ? dispatch<true>(block, stream, codes.typed_data(), meta.typed_data(),
                       table.typed_data(), out->typed_data(), n, prm)
      : dispatch<false>(block, stream, codes.typed_data(), meta.typed_data(),
                        table.typed_data(), out->typed_data(), n, prm);
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("fixed-block kernel launch: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(BaFixedBlock, FixedBlockImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("block")
                                  .Attr<int32_t>("x_drop_mode")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend")
                                  .Attr<int32_t>("x_drop")
                                  .Attr<int32_t>("byte_mode")
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch"));
