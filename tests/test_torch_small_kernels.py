"""The small kernels K4 (``ops/csrc/resample.cu``) and K5
(``ops/csrc/categorical.cu``) on the CPU, built as C++ against the host
shim of the CUDA runtime in ``torch_cuda_shim.py`` (one ``std::thread`` per
CUDA thread, the warp intrinsics through a per-warp exchange buffer and a
``std::barrier`` of 32), where ``g++`` is present.

- K4, float32 and float64: integer-equal to its plain version
  ``systematic_parents_count`` at N in {1, 2, 33, 1000, 4096}, with random
  weights, runs of zero weight and one dominant particle, at u in {0, 0.5,
  1 - 2^-24}; the blocks it launches are ``resample.launch_shape``'s. As
  it is and with small blocks and windows, where the 32-ary rounds run
  more, brackets stay wide and blocks take several passes.
- K5 with injected uniforms: index-equal to ``batched_categorical_plain``
  at (300, 37), (432, 27), (64, 4) and (64, 256), a NaN row and a row of
  ties included; its blocks are ``categorical.launch_shape``'s.
- K5 with Philox noise: the digest of its draws at those shapes (one key,
  or 16 keys of 27 rows at (432, 27)) equals the digest of the kernel it
  replaced (one warp per row), built against the same shim on the same
  inputs: the same draws, index for index.
- K5's wrapper hands the key to the kernel as it is and runs no torch op
  of its own (no key conversion, no copy), with injected uniforms no key.
- The launch floor's source and build job.
"""

import hashlib
import re

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from gen_tpu_torch import random  # noqa: E402
from gen_tpu_torch.ops import categorical as C  # noqa: E402
from gen_tpu_torch.ops import launch_floor as F  # noqa: E402
from gen_tpu_torch.ops import resample as P  # noqa: E402
import torch_cuda_shim as S  # noqa: E402
from torch_resample_cases import US, _log_weights  # noqa: E402

K4_NS = (1, 2, 33, 1000, 4096)
K4_CASES = ("random", "zero_runs", "dominant")
K4_CONFIGS = ("as_is", "small")
K5_SHAPES = ((300, 37), (432, 27), (64, 4), (64, 256))
K5_ROWS_PER_KEY = {(432, 27): 27}        # the decode example's vmap layout
# K5's Philox draws at K5_SHAPES, from the kernel this one replaced (one
# warp per row) built against the same shim
K5_PHILOX_DIGEST = "cc97daac6a4a61ec"

_IO = r"""
#include <cstdio>
#include <cstdlib>
template <class T>
static std::vector<T> rd(const char* dir, const char* name, size_t count) {
  std::vector<T> v(count);
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "rb");
  if (!f || std::fread(v.data(), sizeof(T), count, f) != count) std::abort();
  std::fclose(f);
  return v;
}
template <class T>
static void wr(const char* dir, const char* name, const std::vector<T>& v) {
  char path[4096];
  std::snprintf(path, sizeof path, "%s/%s", dir, name);
  FILE* f = std::fopen(path, "wb");
  std::fwrite(v.data(), sizeof(T), v.size(), f);
  std::fclose(f);
}
"""

# argv: dir n n_u double; files cdf (n), u (n_u) -> out (n_u x n), printed
# blocks
K4_DRIVER = _IO + r"""
template <class T> static void run(const char* dir, int n, int n_u) {
  auto cdf = rd<T>(dir, "cdf", n);
  auto us = rd<T>(dir, "u", n_u);
  std::vector<int32_t> out((size_t)n * n_u, -7);
  for (int j = 0; j < n_u; ++j)
    shim_run(resample_blocks(n), 32 * RESAMPLE_WARPS, [&] {
      resample_systematic_kernel<T>(cdf.data(), us.data() + j,
                                    out.data() + (size_t)j * n, n);
    });
  wr(dir, "out", out);
  std::printf("%d\n", resample_blocks(n));
}
int main(int argc, char** argv) {
  const int n = std::atoi(argv[2]), n_u = std::atoi(argv[3]);
  if (std::atoi(argv[4])) run<double>(argv[1], n, n_u);
  else run<float>(argv[1], n, n_u);
  return 0;
}
"""

# argv: dir n k rows_per_key injected; files logits, u or keys -> out,
# printed lanes a row and blocks
K5_DRIVER = _IO + r"""
template <bool INJ, int G>
static void go(const float* lg, const float* u, const long long* keys, int n,
               int k, int rpk, int32_t* out) {
  shim_run(cat_blocks(n, k), 32 * CAT_WARPS, [&] {
    categorical_kernel<INJ, G>(lg, u, keys, n, k, rpk, out);
  });
}
template <bool INJ>
static void run(const float* lg, const float* u, const long long* keys,
                int n, int k, int rpk, int32_t* out) {
  switch (cat_group(k)) {
    case 1: go<INJ, 1>(lg, u, keys, n, k, rpk, out); break;
    case 2: go<INJ, 2>(lg, u, keys, n, k, rpk, out); break;
    case 4: go<INJ, 4>(lg, u, keys, n, k, rpk, out); break;
    case 8: go<INJ, 8>(lg, u, keys, n, k, rpk, out); break;
    case 16: go<INJ, 16>(lg, u, keys, n, k, rpk, out); break;
    case 32: go<INJ, 32>(lg, u, keys, n, k, rpk, out); break;
  }
}
int main(int argc, char** argv) {
  const char* dir = argv[1];
  const int n = std::atoi(argv[2]), k = std::atoi(argv[3]),
            rpk = std::atoi(argv[4]), inj = std::atoi(argv[5]);
  auto lg = rd<float>(dir, "logits", (size_t)n * k);
  std::vector<int32_t> out(n, -7);
  if (inj) {
    auto u = rd<float>(dir, "u", (size_t)n * k);
    run<true>(lg.data(), u.data(), nullptr, n, k, rpk, out.data());
  } else {
    auto keys = rd<long long>(dir, "keys", 2 * (size_t)(n / rpk));
    run<false>(lg.data(), nullptr, keys.data(), n, k, rpk, out.data());
  }
  wr(dir, "out", out);
  std::printf("%d %d\n", cat_group(k), cat_blocks(n, k));
  return 0;
}
"""


def _run(exe, tmp, *args):
    res = S.run([str(exe), str(tmp), *map(str, args)], check=True,
                timeout=120, capture_output=True, text=True)
    return [int(x) for x in res.stdout.split()]


def _k4_source(config):
    """K4's source, or with blocks of 2 warps of 2 positions a lane and
    windows of 128 entries, so that at N <= 4,096 the 32-ary rounds run,
    brackets stay wide and blocks take several passes."""
    src = P.build_job()[1]
    if config == "small":
        for name, value in (("RESAMPLE_WARPS", 2), ("RESAMPLE_R", 2),
                            ("RESAMPLE_TILE", 128)):
            src, k = re.subn(rf"#define {name} \d+", f"#define {name} "
                             f"{value}", src)
            assert k == 1
    return src


@pytest.fixture(scope="module")
def k4_exe(tmp_path_factory):
    if not S.have_gxx():
        pytest.skip("needs g++")
    out = {}
    for config in K4_CONFIGS:
        tmp = tmp_path_factory.mktemp(f"k4_{config}")
        out[config] = S.build(tmp, _k4_source(config), "template <typename "
                              "T>\nstatic int launch(", K4_DRIVER), tmp
    return out


@pytest.fixture(scope="module")
def k5_exe(tmp_path_factory):
    if not S.have_gxx():
        pytest.skip("needs g++")
    tmp = tmp_path_factory.mktemp("k5")
    return S.build(tmp, C.kernel_source(), "template <bool INJECTED>\nstatic "
                   "void launch(", K5_DRIVER), tmp


@pytest.mark.parametrize("config", K4_CONFIGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k4_shim_equals_literal_count(dtype, config, k4_exe):
    exe, tmp = k4_exe[config]
    src = _k4_source(config)
    rng = np.random.default_rng(12)
    for n in K4_NS:
        for case in K4_CASES:
            lw = torch.tensor(_log_weights(n, case, rng), dtype=dtype)
            cdf = P.normalized_cdf(lw)
            cdf.numpy().tofile(tmp / "cdf")
            np.asarray(US, dtype=cdf.numpy().dtype).tofile(tmp / "u")
            blocks, = _run(exe, tmp, n, len(US), int(dtype == torch.float64))
            assert blocks == P.launch_shape(n, src)[2]
            got = np.fromfile(tmp / "out", np.int32).reshape(len(US), n)
            for j, u in enumerate(US):
                want = P.systematic_parents_count(
                    cdf, torch.tensor(u, dtype=dtype)).numpy()
                np.testing.assert_array_equal(got[j], want,
                                              err_msg=f"{n} {case} {u}")


def k5_inputs(n, k, seed):
    """Logits ~ 2 N(0, 1) and uniforms on [0, 1) with exact zeros, a row of
    ties (row 1) and a NaN (row 2); keys with uint32 words in int64."""
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((n, k)) * 2.0).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (n, k)).astype(np.float32)
    u[0, :min(k, 5)] = 0.0
    logits[1], u[1] = 0.0, 0.5
    logits[2, k // 2] = np.nan
    rpk = K5_ROWS_PER_KEY.get((n, k), n)
    keys = rng.integers(0, 2 ** 32, (n // rpk, 2), dtype=np.uint64)
    return logits, u, keys.astype(np.int64), rpk


def test_k5_shim_injected_equals_plain(k5_exe):
    exe, tmp = k5_exe
    for n, k in K5_SHAPES:
        logits, u, _, rpk = k5_inputs(n, k, n + k)
        logits.tofile(tmp / "logits")
        u.tofile(tmp / "u")
        g, blocks = _run(exe, tmp, n, k, rpk, 1)
        assert (g, blocks) == C.launch_shape(n, k)[::2]
        got = np.fromfile(tmp / "out", np.int32)
        want = C.batched_categorical_plain(torch.from_numpy(logits),
                                           torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"({n}, {k})")
        assert got[1] == 0 and got[2] == k - 1


def test_k5_shim_philox_draws_equal_the_earlier_kernel(k5_exe):
    exe, tmp = k5_exe
    h = hashlib.sha256()
    for n, k in K5_SHAPES:
        logits, _, keys, rpk = k5_inputs(n, k, n + k)
        logits.tofile(tmp / "logits")
        keys.tofile(tmp / "keys")
        _run(exe, tmp, n, k, rpk, 0)
        out = np.fromfile(tmp / "out", np.int32)
        assert out.min() >= 0 and out.max() <= k - 1 and out[2] == k - 1
        h.update(out.tobytes())
    assert h.hexdigest()[:16] == K5_PHILOX_DIGEST


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_k5_wrapper_passes_the_key_through(monkeypatch):
    """K5's launch path, with a CPU stand-in for the custom op: the key
    reaches the op as the same tensor, the logits and uniforms uncopied,
    and no torch op runs on the way."""
    calls = []
    out = torch.zeros(40, dtype=torch.int32)

    def op(logits, keys, u, rows_per_key):
        calls.append((logits, keys, u, rows_per_key))
        return out

    monkeypatch.setattr(C, "_categorical_op", op)
    key = random.PRNGKey(7, "cpu")
    logits = torch.randn(40, 27)
    u = torch.rand(40, 27)
    with _Ops() as seen:
        C._launch(key, logits, None)
        C._launch(key, logits, u)
    assert seen.ops == []
    (l1, k1, u1, r1), (l2, k2, u2, r2) = calls
    assert l1 is logits and k1 is key and u1 is None and r1 == 40
    assert key.dtype == torch.int64
    assert l2 is logits and k2 is None and u2 is u and r2 == 40


def test_launch_floor_source_and_build_job():
    name, src, sigs = F.build_job()
    assert name == "launch_floor" and set(sigs) == {"launch_floor"}
    assert 'extern "C" int launch_floor(' in src
    assert "launch_floor_kernel(int32_t* out) {}" in src
    with pytest.raises(ValueError, match="CUDA device"):
        F.launch_floor("cpu")
