// Stage clocks of the path-tracing megakernel (megakernel.cu).
//
// Compiled only into the instrumented library that `tools/hier_ab.py
// --mega-stages` builds with -DECHO_MEGA_STAGES; in every other build the
// macros below are empty, so the library that ops/megakernel.py loads
// carries none of it.
//
// ECHO_STAGE_CLOCK(k) starts a thread's clock in stage k; ECHO_STAGE(k)
// charges the cycles (clock()) since the last mark to the stage it closes
// and opens stage k. When the clock goes out of scope (the thread's
// function returns), its per-stage sums go to the device-wide counters
// g_cycles, which `megakernel_stages` reads and resets. The sums are over
// threads: divided by 32 they are warp cycles.

#pragma once

// the stages (tools/hier_ab.py STAGES names them in this order)
#define ECHO_STAGE_TRACE 0
#define ECHO_STAGE_SHADOW 1
#define ECHO_STAGE_INTERACT 2
#define ECHO_STAGE_TEXTURE 3
#define ECHO_STAGE_BSDF 4
#define ECHO_STAGE_NEE 5
#define ECHO_STAGE_END 6
#define ECHO_STAGE_POOL 7
#define ECHO_STAGE_COUNT 8

#ifdef ECHO_MEGA_STAGES

namespace echo_stages {

// per stage, then the number of clocks flushed (threads)
__device__ unsigned long long g_cycles[ECHO_STAGE_COUNT + 1];

struct Clock {  // 32-bit sums and clock(): a thread's stages last far fewer than 2^32 cycles
  unsigned int acc[ECHO_STAGE_COUNT];
  unsigned int t;
  int cur;
  __device__ explicit Clock(int first) {
#pragma unroll
    for (int i = 0; i < ECHO_STAGE_COUNT; ++i) acc[i] = 0;
    cur = first;
    t = (unsigned int)clock();
  }
  __device__ __forceinline__ void mark(int next) {
    const unsigned int now = (unsigned int)clock();
#pragma unroll
    for (int i = 0; i < ECHO_STAGE_COUNT; ++i)
      if (i == cur) acc[i] += now - t;
    t = now;
    cur = next;
  }
  __device__ ~Clock() {
    mark(cur);
#pragma unroll
    for (int i = 0; i < ECHO_STAGE_COUNT; ++i)
      if (acc[i]) atomicAdd(&g_cycles[i], (unsigned long long)acc[i]);
    atomicAdd(&g_cycles[ECHO_STAGE_COUNT], 1ull);
  }
};

}  // namespace echo_stages

// the counters in out[0 .. ECHO_STAGE_COUNT] (stages, then threads); zeroes
// them after the read when `reset` is set
extern "C" int megakernel_stages(unsigned long long* out, int reset) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, echo_stages::g_cycles, sizeof(echo_stages::g_cycles));
  if (err == cudaSuccess && reset) {
    static const unsigned long long zero[ECHO_STAGE_COUNT + 1] = {};
    err = cudaMemcpyToSymbol(echo_stages::g_cycles, zero, sizeof(zero));
  }
  return static_cast<int>(err);
}

#define ECHO_STAGE_CLOCK(first) echo_stages::Clock echo_stage_clock_(first)
#define ECHO_STAGE(k) echo_stage_clock_.mark(k)
// a function with marks of its own takes the caller's clock
#define ECHO_STAGE_PARAM , echo_stages::Clock& echo_stage_clock_
#define ECHO_STAGE_ARG , echo_stage_clock_

#else

#define ECHO_STAGE_CLOCK(first)
#define ECHO_STAGE(k)
#define ECHO_STAGE_PARAM
#define ECHO_STAGE_ARG

#endif
