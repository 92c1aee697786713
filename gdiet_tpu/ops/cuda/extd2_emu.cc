// Host emulation of the banded DP kernel (extd2.cuh): every GPU thread of a
// block is a std::thread and the barriers are std::barrier objects, so the
// kernel's own source, exchange protocol and launch geometry run on a CPU.
// The tests build it with g++ and compare it with ops/dp.py::extd2_batch;
// on the GPU the same source is compiled by nvcc (extd2_ffi.cu).
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

namespace emu {
thread_local int tid, bid, bdim;
thread_local int32_t* shared;
thread_local std::barrier<>* warp_bar;
thread_local std::barrier<>* block_bar;
}  // namespace emu

#define GD_DEVICE inline
#define GD_KERNEL
#define GD_TID emu::tid
#define GD_BID emu::bid
#define GD_BDIM emu::bdim
#define GD_SHARED emu::shared
#define GD_BARRIER(tpc)                     \
  do {                                      \
    if ((tpc) == 32) {                      \
      emu::warp_bar->arrive_and_wait();     \
    } else {                                \
      emu::block_bar->arrive_and_wait();    \
    }                                       \
  } while (0)
#define GD_MAX3(a, b, c) std::max(std::max((a), (b)), (c))
#define GD_ADDMAX(a, b, c) std::max((a) + (b), (c))
#define GD_MAX(a, b) std::max((a), (b))

#include "extd2.cuh"

namespace {

template <int LPT>
void run_block(const gdiet::Extd2Args& p, int block, int cpb) {
  const int nthr = cpb * p.tpc;
  std::vector<int32_t> smem(cpb * gdiet::exchange_words(p.tpc));
  std::barrier<> block_bar(nthr);
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; w < nthr / 32; ++w) {
    warp_bars.push_back(std::make_unique<std::barrier<>>(32));
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < nthr; ++t) {
    threads.emplace_back([&, t] {
      emu::tid = t;
      emu::bid = block;
      emu::bdim = nthr;
      emu::shared = smem.data();
      emu::warp_bar = warp_bars[t / 32].get();
      emu::block_bar = &block_bar;
      gdiet::extd2_kernel<LPT>(p);
    });
  }
  for (auto& th : threads) th.join();
}

template <int LPT>
void run(const gdiet::Extd2Args& p) {
  const int cpb = gdiet::candidates_per_block(p.tpc);
  for (int b = 0; b * cpb < p.N; ++b) run_block<LPT>(p, b, cpb);
}

}  // namespace

// launch_geometry for the tests: geom gets (tpc, lpt, in_memory)
extern "C" void gdiet_extd2_geometry(int32_t W, int32_t reg_max,
                                     int32_t mem_max, int32_t* geom) {
  const gdiet::Geometry g = gdiet::launch_geometry(W, reg_max, mem_max);
  geom[0] = g.tpc;
  geom[1] = g.lpt;
  geom[2] = g.in_memory;
}

// cfg: the 15 int32 of ops/dp_cuda.py::kernel_config; reg_max and mem_max
// stand for the launch limits the GPU reports (launch_geometry). geom gets
// (tpc, lpt, in_memory). Returns 0 on success.
extern "C" int gdiet_extd2_emu(const uint8_t* query, const uint8_t* target,
                               const int32_t* qlens, const int32_t* tlens,
                               const int32_t* bands, int32_t N,
                               const int32_t* cfg, int32_t reg_max,
                               int32_t mem_max, int32_t* score,
                               uint8_t* dirs, int32_t* geom) {
  gdiet::Extd2Args p;
  p.query = query;
  p.target = target;
  p.qlens = qlens;
  p.tlens = tlens;
  p.bands = bands;
  p.score = score;
  p.dirs = dirs;
  p.N = N;
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
  gdiet_extd2_geometry(p.W, reg_max, mem_max, geom);
  const gdiet::Geometry g{geom[0], geom[1], geom[2] != 0};
  p.tpc = g.tpc;
  p.lpt = g.lpt;
  std::vector<int32_t> scratch;
  p.scratch = nullptr;
  if (g.in_memory) {
    scratch.resize((size_t)N * gdiet::kFields * g.lpt * g.tpc);
    p.scratch = scratch.data();
    run<0>(p);
    return 0;
  }
  switch (g.lpt) {
    case 1: run<1>(p); break;
    case 2: run<2>(p); break;
    case 3: run<3>(p); break;
    case 4: run<4>(p); break;
    case 5: run<5>(p); break;
    case 6: run<6>(p); break;
    case 7: run<7>(p); break;
    case 8: run<8>(p); break;
    default: return 1;
  }
  return 0;
}
