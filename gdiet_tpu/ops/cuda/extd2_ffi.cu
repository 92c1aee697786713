// XLA FFI binding of the banded DP kernel (extd2.cuh); built and registered
// by ops/dp_cuda.py, which also documents the attribute layout.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "xla/ffi/api/ffi.h"

#define GD_DEVICE __device__ __forceinline__
#define GD_KERNEL __global__
#define GD_TID static_cast<int>(threadIdx.x)
#define GD_BID static_cast<int>(blockIdx.x)
#define GD_BDIM static_cast<int>(blockDim.x)
#define GD_BARRIER(tpc)         \
  do {                          \
    if ((tpc) == 32) {          \
      __syncwarp();             \
    } else {                    \
      __syncthreads();          \
    }                           \
  } while (0)
// Hopper DPX: three-way max and fused add-max
#define GD_MAX3(a, b, c) __vimax3_s32((a), (b), (c))
#define GD_ADDMAX(a, b, c) __viaddmax_s32((a), (b), (c))
#define GD_MAX(a, b) max((a), (b))
extern __shared__ int32_t gd_shared[];
#define GD_SHARED gd_shared

#include "extd2.cuh"

namespace ffi = xla::ffi;

namespace {

template <int LPT>
cudaError_t launch(const gdiet::Extd2Args& p, cudaStream_t st) {
  const int cpb = gdiet::candidates_per_block(p.tpc);
  const int blocks = (p.N + cpb - 1) / cpb;
  const size_t smem = sizeof(int32_t) * cpb * gdiet::exchange_words(p.tpc);
  auto* fn = gdiet::extd2_kernel<LPT>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (blocks > 0) fn<<<blocks, cpb * p.tpc, smem, st>>>(p);
  return cudaGetLastError();
}

// the largest group (a multiple of 32, at most 1024) a kernel launches with
// at its register use
template <int LPT>
int max_group() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, gdiet::extd2_kernel<LPT>) != cudaSuccess) {
    return 0;
  }
  const int m = attr.maxThreadsPerBlock < 1024 ? attr.maxThreadsPerBlock : 1024;
  return m / 32 * 32;
}

ffi::Error Extd2Impl(cudaStream_t stream, ffi::Buffer<ffi::U8> query,
                     ffi::Buffer<ffi::U8> target, ffi::Buffer<ffi::S32> qlens,
                     ffi::Buffer<ffi::S32> tlens, ffi::Buffer<ffi::S32> bands,
                     ffi::ResultBuffer<ffi::S32> score,
                     ffi::ResultBuffer<ffi::U8> dirs,
                     ffi::ResultBuffer<ffi::S32> scratch,
                     ffi::Span<const int32_t> cfg) {
  if (cfg.size() != 15) {
    return ffi::Error::InvalidArgument("extd2: cfg must hold 15 int32");
  }
  gdiet::Extd2Args p;
  p.query = query.typed_data();
  p.target = target.typed_data();
  p.qlens = qlens.typed_data();
  p.tlens = tlens.typed_data();
  p.bands = bands.typed_data();
  p.score = score->typed_data();
  p.dirs = dirs->typed_data();
  p.scratch = nullptr;
  p.N = static_cast<int32_t>(qlens.element_count());
  p.Lmax = cfg[0];
  p.Lt = cfg[1];
  p.R = cfg[2];
  p.T = cfg[3];
  p.TS = cfg[4];
  p.W = cfg[5];
  p.wmax = cfg[6];
  p.a = cfg[7];
  p.b = cfg[8];
  p.q = cfg[9];
  p.e = cfg[10];
  p.q2 = cfg[11];
  p.e2 = cfg[12];
  p.long_thres = cfg[13];
  p.long_diff = cfg[14];
  // rows wider than 256 lanes take the 3- or 4-slot register kernel
  static const int reg_max = std::min(max_group<3>(), max_group<4>());
  static const int mem_max = max_group<0>();
  if (reg_max < 32 || mem_max < 32) {
    return ffi::Error::Internal("extd2: kernel attributes unavailable");
  }
  const gdiet::Geometry g = gdiet::launch_geometry(p.W, reg_max, mem_max);
  p.tpc = g.tpc;
  p.lpt = g.lpt;
  cudaError_t err;
  if (g.in_memory) {
    const size_t words = (size_t)p.N * gdiet::kFields * p.lpt * p.tpc;
    if (scratch->element_count() < words) {
      return ffi::Error::InvalidArgument("extd2: lane-state scratch too small");
    }
    p.scratch = scratch->typed_data();
    err = launch<0>(p, stream);
  } else {
    switch (p.lpt) {
      case 1: err = launch<1>(p, stream); break;
      case 2: err = launch<2>(p, stream); break;
      case 3: err = launch<3>(p, stream); break;
      case 4: err = launch<4>(p, stream); break;
      case 5: err = launch<5>(p, stream); break;
      case 6: err = launch<6>(p, stream); break;
      case 7: err = launch<7>(p, stream); break;
      default: err = launch<8>(p, stream); break;
    }
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(GdietExtd2, Extd2Impl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()   // query
                                  .Arg<ffi::Buffer<ffi::U8>>()   // target
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlens
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tlens
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bands
                                  .Ret<ffi::Buffer<ffi::S32>>()  // score
                                  .Ret<ffi::Buffer<ffi::U8>>()   // dirs
                                  .Ret<ffi::Buffer<ffi::S32>>()  // scratch
                                  .Attr<ffi::Span<const int32_t>>("cfg"));
