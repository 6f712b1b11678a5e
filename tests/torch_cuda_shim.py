"""A host shim of the CUDA runtime, for compiling the port's kernel sources
as C++ on a machine without a card.

``SHIM`` is written as ``cuda_runtime.h`` into a build directory, so that
a kernel source's ``#include <cuda_runtime.h>`` finds it. Each CUDA thread
runs as one ``std::thread``:

- ``threadIdx``/``blockIdx`` are thread-local; ``__syncthreads`` is a
  ``std::barrier`` of the block (``shim_barrier``); static shared memory is
  a function static, shared by every thread of the kernel, so it holds
  one block's data where each warp uses a slice of its own, or where a
  block's writes follow a ``__syncthreads`` that the last reads of the
  block before it precede (or the driver runs one block at a time);
  ``shim_dyn`` stands for the dynamic shared memory.
- ``atomicMin`` is a compare-and-swap loop on a ``std::atomic_ref``.
- The warp intrinsics (``__shfl_sync``, ``__shfl_xor_sync`` and
  ``__shfl_down_sync`` with ``width``, ``__ballot_sync``, ``__any_sync``,
  ``__syncwarp``) go through a per-warp exchange buffer between two waits
  on a ``std::barrier`` of 32: every lane of the warp must reach each of
  them, as on the card under a full mask (a lane missing from one hangs
  the program, so drivers run under a time limit).
- ``shim_run(grid, block, fn)`` runs ``fn`` as a kernel: ``block``
  threads, each going through the blocks in order (warps proceed on their
  own, as they do on the card between block-wide barriers).

A kernel source is compiled by cutting off its launch functions (they use
``<<<...>>>``) and appending a driver: :func:`build`. Run the program
through :func:`run`, which holds it to one CPU core: every warp exchange
waits for all 32 of its threads, and threads spread over cores that other
processes keep busy wait on each other's time slices, where on one core
they simply take turns.
"""

import os
import shutil
import subprocess

SHIM = r"""
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <thread>
#include <vector>
using std::isnan;
using std::max;
using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __syncthreads() shim_barrier->arrive_and_wait()
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct shim_idx { unsigned x, y, z; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline thread_local shim_idx threadIdx, blockIdx;
inline shim_idx blockDim, gridDim;
inline std::barrier<>* shim_barrier;
inline float* shim_dyn;
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(uint32_t i) { float f; std::memcpy(&f, &i, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t i; std::memcpy(&i, &f, 4); return i; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
inline int __popc(uint32_t x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
template <class T> inline T atomicMin(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (v < old && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}
template <class T> inline T __ldg(const T* p) { return *p; }

// one warp: 32 lanes meet at a barrier around each exchange
struct shim_warp {
  std::barrier<> bar{32};
  uint64_t slot[32];
};
inline thread_local shim_warp* shim_this_warp;
inline unsigned shim_lane() { return threadIdx.x & 31u; }
template <class T> inline uint64_t shim_bits(T v) {
  static_assert(sizeof(T) <= 8, "a shuffled value has at most 8 bytes");
  uint64_t b = 0;
  std::memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T> inline T shim_from(uint64_t b) {
  T v;
  std::memcpy(&v, &b, sizeof(T));
  return v;
}
// every lane posts v; returns the value of lane src (its own if src < 0)
template <class T> inline T shim_exchange(T v, int src) {
  shim_warp* w = shim_this_warp;
  w->slot[shim_lane()] = shim_bits(v);
  w->bar.arrive_and_wait();
  const T r = src < 0 ? v : shim_from<T>(w->slot[src]);
  w->bar.arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_this_warp->bar.arrive_and_wait();
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  const int lane = shim_lane();
  return shim_exchange(v, (lane & ~(width - 1)) + (src & (width - 1)));
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, unsigned delta, int width = 32) {
  const int lane = shim_lane();
  const int in = lane & (width - 1);
  return shim_exchange(v, in + (int)delta < width ? lane + (int)delta : -1);
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  const int lane = shim_lane();
  const int src = lane ^ mask;
  // a lane of a later group of width lanes gives back the caller's own
  return shim_exchange(v, (src & ~(width - 1)) > (lane & ~(width - 1))
                              ? -1 : src);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  shim_warp* w = shim_this_warp;
  w->slot[shim_lane()] = pred ? 1u : 0u;
  w->bar.arrive_and_wait();
  unsigned b = 0;
  for (int l = 0; l < 32; ++l) b |= (unsigned)(w->slot[l] & 1u) << l;
  w->bar.arrive_and_wait();
  return b;
}
inline int __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0; }

// runs fn() as a kernel of grid blocks of block threads (block a multiple
// of 32): one std::thread per thread of a block, each going through the
// blocks in order
template <class F> inline void shim_run(unsigned grid, unsigned block, F fn) {
  std::deque<shim_warp> warps(block / 32);
  std::barrier<> bar(block);
  shim_barrier = &bar;
  blockDim = {block, 1, 1};
  gridDim = {grid, 1, 1};
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < block; ++t)
    ts.emplace_back([&, t] {
      threadIdx = {t, 0, 0};
      shim_this_warp = &warps[t / 32];
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx = {b, 0, 0};
        fn();
      }
    });
  for (auto& t : ts) t.join();
}
"""


def have_gxx() -> bool:
    return shutil.which("g++") is not None


def run(args, **kwargs):
    """``subprocess.run(args, **kwargs)`` of a shimmed program, its threads
    held to one of this process's cores (chosen by process id, so that
    parallel test workers spread over the cores). The calling thread takes
    that core while it starts and waits for the program, which inherits
    it: no code runs in the child before ``exec``, where a multithreaded
    parent's locks could hang it."""
    old = os.sched_getaffinity(0)
    cores = sorted(old)
    os.sched_setaffinity(0, {cores[os.getpid() % len(cores)]})
    try:
        return subprocess.run(args, **kwargs)
    finally:
        os.sched_setaffinity(0, old)


def build(tmp_path, source: str, cut: str, driver: str, name: str = "k"):
    """Compile ``source`` up to (not including) the first line that starts
    with ``cut``, followed by ``driver``, against :data:`SHIM`, into
    ``tmp_path / name``; returns the executable's path."""
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    cpp = tmp_path / f"{name}.cpp"
    cpp.write_text(source[:source.index(cut)] + driver)
    exe = tmp_path / name
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-pthread", f"-I{tmp_path}", str(cpp), "-o", str(exe)],
                   check=True)
    return exe
