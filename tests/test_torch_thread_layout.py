"""The one-thread layout of K3 and K6 at small d (``"thread"``: the chain's
cold state in a column of shared memory, one trajectory end kept) on the
CPU.

- ``thread_shape`` at d = 3, 10, 17 and 32 and max_depth 6, 8 and 10: the
  block that holds the most threads an SM, the shared bytes of its
  columns (``cold_words``), the blocks an SM that the shared memory and
  ``THREAD_REGS`` allow, and the refusal of a model beyond the card's
  shared memory; ``kernel_layout`` by d.
- The rendered d=10 sources declare the cold state in dynamic shared
  memory and no per-thread end, candidate or current-sample arrays; the
  ``"wide"`` layout at d=10 renders the one-thread code from before the
  ``"thread"`` layout byte for byte once comments are removed (its pinned
  hashes).
- Where ``g++`` is present: the rendered d=10 K3 and K6 (eight_schools,
  max_depth 8) built as C++ against a host shim of the CUDA runtime (one
  ``std::thread`` per CUDA thread of a block, ``__syncthreads`` a
  ``std::barrier``, the dynamic shared memory a per-block buffer filled
  with NaNs) under injected randomness, against the plain versions
  (``run_pairs``/``run_ticks`` in the thread layout): completed counts
  equal, values within 1e-5 (glibc's ``expf``/``logf`` are not CUDA's),
  with one coordinate collected and with all.
- The ``cuda``-marked test holds both kernels to their plain versions bit
  for bit at d = 10, 17 and 32, max_depth 6 and 10, both ways of
  collecting, on a card.
"""

import hashlib
import re
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import gen_tpu_torch as tt  # noqa: E402
from gen_tpu_torch.inference import FlatTarget  # noqa: E402
from gen_tpu_torch.inference.nuts_fsm import summary_stats  # noqa: E402
from gen_tpu_torch.ops import nuts_fused  # noqa: E402
from gen_tpu_torch.ops.scalarize import stage_scalarized  # noqa: E402
from gen_tpu_torch.utils import sqrt_mass_safe  # noqa: E402
from torch_port_models import (SCHOOL_ADDRS, SIGMAS_8, YS_8,  # noqa: E402
                               torch_eight_schools)

TOL = 1e-5
# the one-thread code of eight_schools d=10 at max_depth 8 from before the
# "thread" layout (comments removed), which the "wide" layout keeps
WIDE_D10 = {True: "8e99df6426b840de", False: "a55f21a4b4735c71"}

# a host shim of the CUDA runtime: one std::thread per CUDA thread of a
# block, one block at a time, __syncthreads a std::barrier, static shared
# memory as function statics (shared by the block's threads), the dynamic
# shared memory a per-block buffer
SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
using std::isnan;
using std::max;
using std::min;
#define __global__
#define __device__
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
inline shim_idx blockDim;
inline std::barrier<>* shim_barrier;
inline float* shim_dyn;
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __uint_as_float(uint32_t i) { float f; std::memcpy(&f, &i, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t i; std::memcpy(&i, &f, 4); return i; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __fmaf_rn(float a, float b, float c) { return std::fmaf(a, b, c); }
"""

# appended to the rendered kernel in place of its launch functions: runs
# KNAME<true, COLLECT_ALL> over the chains in the files of argv[1] (the
# injected streams), block by block, and writes the outputs there
SHIM_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>
static std::vector<float> shim_read(const char* dir, const char* name,
                                    size_t count) {
  std::vector<float> v(count);
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), 4, count, f) != count) std::abort();
  std::fclose(f);
  return v;
}
template <class T>
static void shim_write(const char* dir, const char* name,
                       const std::vector<T>& v) {
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}
int main(int argc, char** argv) {
  const char* dir = argv[1];
  const int n = std::atoi(argv[2]), steps = std::atoi(argv[3]);
  const float eps = std::atof(argv[4]), thr = std::atof(argv[5]);
  const int cidx = std::atoi(argv[6]);
  const bool all = cidx < 0;
  const size_t N = n, D = NUTS_D;
  auto v0 = shim_read(dir, "v0", D * N), res = shim_read(dir, "res", NUTS_R);
  auto inv = shim_read(dir, "inv", D), msc = shim_read(dir, "msc", D);
  auto z = shim_read(dir, "z", steps * D * N);
  auto u = shim_read(dir, "u", steps * NU * N);
  std::vector<float> vout(D * N), hist(all ? steps * D * N : steps * N),
      stats(5 * N), dyn(NUTS_BLOCK * NUTS_COLD_WORDS);
  std::vector<int> hist_cnt(steps * N), cnt(N);
  blockDim = {NUTS_BLOCK, 1, 1};
  for (unsigned b = 0; b * NUTS_BLOCK < N; ++b) {
    std::barrier<> bar(NUTS_BLOCK);
    shim_barrier = &bar;
    for (auto& w : dyn) w = __int_as_float(0x7fc01234);
    shim_dyn = dyn.data();
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < NUTS_BLOCK; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        auto k = all ? KNAME<true, true> : KNAME<true, false>;
        k(v0.data(), vout.data(), hist.data(), hist_cnt.data(), cnt.data(),
          stats.data(), res.data(), inv.data(), msc.data(), nullptr, 0, n,
          steps, eps, thr, cidx, 0u, 0u, z.data(), u.data());
      });
    for (auto& t : ts) t.join();
  }
  shim_write(dir, "vout", vout);
  shim_write(dir, "hist", hist);
  shim_write(dir, "hist_cnt", hist_cnt);
  shim_write(dir, "cnt", cnt);
  shim_write(dir, "stats", stats);
  return 0;
}
"""


def _code(src):
    """The source without comments and blank lines."""
    return "\n".join(ln.rstrip() for ln in re.sub(r"//[^\n]*", "",
                                                  src).splitlines()
                     if ln.strip())


def _hash(text):
    return hashlib.sha256(text.encode()).hexdigest()[:16]


@pytest.fixture(scope="module")
def schools10():
    ys, sig = np.asarray(YS_8, np.float32), np.asarray(SIGMAS_8, np.float32)
    tr, _ = torch_eight_schools.generate(
        tt.random.PRNGKey(0, "cpu"), (torch.from_numpy(sig),),
        tt.choicemap(ys=torch.from_numpy(ys)))
    target = FlatTarget(tr, tt.select(*SCHOOL_ADDRS))
    return target, stage_scalarized(target.logp, 10, "cpu")


def test_thread_shape_by_d_and_depth(monkeypatch):
    def resident(block, static):
        need = 4 * block * nuts_fused.cold_words(d, md) + static
        if need > nuts_fused.BLOCK_SMEM:
            return 0, 0
        blocks = max(1, min(nuts_fused.SM_SMEM // (need + 1024),
                            65536 // (block * nuts_fused.THREAD_REGS),
                            2048 // block, 32))
        return blocks, blocks * block

    for d in (3, 10, 17, 32):
        for md in (6, 8, 10):
            words = 7 * d + 2 + (md - 2) * d
            assert nuts_fused.cold_words(d, md) == words
            block, blocks, smem = nuts_fused.thread_shape(d, md, 400)
            assert smem == 4 * block * words
            assert (blocks, blocks * block) == resident(block, 400)
            # the first of the blocks that hold the most threads an SM
            best = max(resident(b, 400)[1] for b in (64, 128, 32))
            assert blocks * block == best
            assert block == next(b for b in (64, 128, 32)
                                 if resident(b, 400)[1] == best)
            assert blocks * block * nuts_fused.THREAD_REGS <= 65536
    # eight_schools at max_depth 8: 132 words a chain, 6 blocks of 64 (12
    # warps) an SM at up to 170 registers; d=17: 4 blocks of 64, or with
    # the 15-school model's 412 B of static shared memory 2 blocks of 128
    assert nuts_fused.thread_shape(10, 8) == (64, 6, 33792)
    assert nuts_fused.thread_shape(17, 8) == (64, 4, 57088)
    assert nuts_fused.thread_shape(17, 8, 412) == (128, 2, 114176)
    assert nuts_fused.thread_shape(32, 8) == (64, 2, 107008)
    assert nuts_fused.cold_words(4, 1) == nuts_fused.cold_words(4, 2) == 30
    with pytest.raises(ValueError, match="shared memory"):
        nuts_fused.thread_shape(32, 60)
    monkeypatch.setattr(nuts_fused, "THREAD_BLOCKS", (32,))
    assert nuts_fused.thread_shape(10, 8) == (32, 12, 16896)
    # kernel_layout: the thread layout up to THREAD_MAX_D
    for d in (4, nuts_fused.THREAD_MAX_D, nuts_fused.THREAD_MAX_D + 1):
        st = stage_scalarized(lambda x: -0.5 * torch.sum(x * x), d, "cpu")
        assert nuts_fused.kernel_layout(st) == (
            "thread" if d <= nuts_fused.THREAD_MAX_D
            else "warp" if d > 32 else "wide")


def test_thread_sources_hold_cold_state_in_shared_memory(schools10,
                                                         monkeypatch):
    _, st = schools10
    assert nuts_fused.kernel_layout(st) == "thread"
    for paired in (True, False):
        src = nuts_fused.kernel_source(st, 8, paired)
        assert "@@" not in src
        assert "#define NUTS_BLOCK 64\n#define NUTS_MIN_BLOCKS 6\n" in src
        assert "#define NUTS_COLD_WORDS 132\n" in src
        assert "__launch_bounds__(NUTS_BLOCK, NUTS_MIN_BLOCKS)" in src
        assert src.count("extern __shared__ float nuts_cold[];") == 1
        assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
        kernel = src[src.index("nuts_cold[];"):src.index("}  // namespace",
                                                         src.index(
                                                             "nuts_cold[];"))]
        decls = re.findall(r"\b(\w+)\[NUTS_D\]", kernel)
        assert not {"cur", "lt", "lr", "lg", "rt", "rr", "rg", "ct", "cg",
                    "cs", "csg"} & set(decls)
        assert "ck[NUTS_LEVELS]" not in kernel and "ck1[NUTS_D]" in kernel
        assert "swap_far(col" in kernel and "uturn_far(" in kernel
    # the wide layout keeps the earlier one-thread code
    monkeypatch.setattr(nuts_fused, "THREAD_MAX_D", 0)
    assert nuts_fused.kernel_layout(st) == "wide"
    for paired in (True, False):
        src = nuts_fused.kernel_source(st, 8, paired)
        assert "nuts_cold" not in src and "float cur[NUTS_D], lt[NUTS_D]" \
            in src
        assert _hash(_code(src)) == WIDE_D10[paired]


def _streams(seed, steps, n, d, n_u):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((steps, n, d)).astype(np.float32)
    us = [np.clip(rng.uniform(size=(steps, n)), 1e-6, 1 - 1e-6)
          .astype(np.float32) for _ in range(n_u)]
    return (z, *us)


@pytest.mark.parametrize("paired", [True, False])
def test_shimmed_kernel_matches_plain_version(paired, schools10, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    target, st = schools10
    d, md, eps, thr = 10, 8, 0.3, 1000.0
    n, steps = 80, (24 if paired else 48)      # two blocks, the last ragged
    name, _, n_u = nuts_fused._KERNELS[paired]
    src = nuts_fused.kernel_source(st, md, paired)
    src = src.replace("extern __shared__ float nuts_cold[];",
                      "float* nuts_cold = shim_dyn;")
    src = src[:src.index(f"template <bool INJECTED, bool COLLECT_ALL>\nint "
                         f"{name}_start(")]
    (tmp_path / "cuda_runtime.h").write_text(SHIM)
    (tmp_path / "k.cpp").write_text(
        src + f"#define KNAME {name}_kernel\n#define NU {n_u}\n" + SHIM_MAIN)
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-w",
                    "-pthread", f"-I{tmp_path}", str(tmp_path / "k.cpp"),
                    "-o", str(tmp_path / "k")], check=True)
    rng = np.random.default_rng(4)
    vals0 = (rng.standard_normal((n, d)) * 0.8).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, d).astype(np.float32)
    inj = _streams(5, steps, n, d, n_u)
    files = dict(v0=vals0.T, res=st.res_consts.numpy(), inv=inv,
                 msc=sqrt_mass_safe(torch.from_numpy(inv)).numpy(),
                 z=inj[0].transpose(0, 2, 1), u=np.stack(inj[1:], axis=1))
    for k, v in files.items():
        np.ascontiguousarray(v, np.float32).tofile(tmp_path / k)
    for cidx in (3, None):
        subprocess.run([str(tmp_path / "k"), str(tmp_path), str(n),
                        str(steps), repr(eps), repr(thr),
                        str(-1 if cidx is None else cidx)], check=True)

        def out(k, dt=np.float32):
            return np.fromfile(tmp_path / k, dt)

        vk, hk = out("vout").reshape(d, n).T, out("hist")
        hck, ck = out("hist_cnt", np.int32), out("cnt", np.int32)
        sk = out("stats").reshape(5, n)
        vp, hp, hcp, cp, sp = nuts_fused.nuts_chains_fused_plain(
            tt.random.PRNGKey(0, "cpu"), target.logp,
            torch.from_numpy(vals0), 2 * steps if paired else steps, eps, md,
            torch.from_numpy(inv), cidx, thr, inj, paired)
        np.testing.assert_array_equal(ck, cp.numpy())
        np.testing.assert_array_equal(hck.reshape(steps, n), hcp.numpy())
        assert ck.sum() > n
        np.testing.assert_allclose(vk, vp.numpy(), rtol=TOL, atol=TOL)
        hp = hp.numpy() if cidx is not None else \
            hp.permute(0, 2, 1).numpy()
        np.testing.assert_allclose(hk.reshape(hp.shape), hp, rtol=TOL,
                                   atol=TOL)
        s5 = [torch.from_numpy(x.copy()) for x in sk]
        stats = summary_stats(torch.from_numpy(ck), s5[0], s5[1],
                              s5[2].to(torch.int32), s5[3],
                              s5[4].to(torch.int32))
        for s in sp:
            torch.testing.assert_close(stats[s], sp[s], rtol=TOL, atol=TOL)


def _gauss(d, dev):
    """A d-dimensional Gaussian with couplings across its coordinates."""
    sds = torch.from_numpy(np.random.default_rng(d).uniform(
        0.5, 2.0, d).astype(np.float32)).to(dev)

    def logp(x):
        return (-0.5 * torch.sum((x / sds) ** 2) - 0.3 * x[0] * x[d - 1]
                - 0.1 * x[1] * x[2])
    return logp, sds


@pytest.mark.cuda
def test_thread_kernels_match_plain_versions_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    n = 5000                                   # a ragged last block
    for d in (10, 17, 32):
        logp, sds = _gauss(d, dev)
        g = torch.Generator(dev).manual_seed(d)
        vals0 = torch.randn(n, d, device=dev, generator=g) * sds
        layout = nuts_fused.kernel_layout(nuts_fused.stage(logp, d, dev))
        for md, paired, cidx in ((6, True, None), (10, True, d - 1),
                                 (6, False, 0), (10, False, None)):
            steps = 30 if paired else 60
            inj = tuple(torch.from_numpy(a).to(dev) for a in _streams(
                d + md, steps, n, d, 7 if paired else 4))
            kw = dict(num_ticks=2 * steps if paired else steps, eps=0.4,
                      max_depth=md, inv_mass_diag=sds ** 2,
                      collect_idx=cidx, injected_rng=inj, paired=paired)
            key = tt.random.PRNGKey(0, dev)
            before = nuts_fused.nuts_chains_fused.layout_launches[layout]
            out_k = nuts_fused.nuts_chains_fused(key, logp, vals0, **kw)
            assert nuts_fused.nuts_chains_fused.layout_launches[layout] == \
                before + 1
            out_p = nuts_fused.nuts_chains_fused_plain(key, logp, vals0,
                                                       **kw)
            for a, b in zip(out_k[:4], out_p[:4]):
                assert torch.equal(a, b), (d, md, paired, cidx)
            for s in out_k[4]:
                assert torch.equal(out_k[4][s], out_p[4][s]), (d, s)
            assert int(out_k[3].sum()) > n
