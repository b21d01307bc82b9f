#!/usr/bin/env python3
"""Run the tiled ``grid_dia_matvec`` kernel of ``ops/csrc/dia_spmv.cu`` on the
host CPU, with no ``nvcc`` and no GPU: ``python3 tools/emulate_dia_spmv.py
[--source FILE]``.

The CUDA source is compiled by the host's ``g++`` (C++20) behind a small
header of CUDA stand-ins: the qualifiers are no-ops, ``__ldg`` / ``__ldcg``
plain loads, the 16-byte vector types plain structs, the runtime API stubs;
the launch syntax and inline ``asm`` (the slab SpMM's ``cp.async``) are cut
out.  A block runs as 256 host threads, one a CUDA thread; ``__syncthreads``
is a barrier and ``__ballot_sync`` a shared array between two barriers;
``__shared__`` arrays are function statics, shared by the block's threads,
one block at a time.  The one-thread-a-point kernel of the earlier design
(``grid_dia_matvec_v1``) runs the same way, its multiply-add written as the
FMA that ``nvcc`` contracts it to.  Each case checks that the tiled kernel
writes every point, equals v1 bit for bit and lies within 1e-5 (f32) /
1e-12 (f64) of max|plain| of ``GridDIA._apply``: every ``GRID_CASES``
operator of the tests, ragged and odd widths, 1 x 1 and 1 x 7, the empty
matrix, lists of several chunks, 1e30 coefficients where a source lies
outside the grid, on each path that the width allows.

It checks the kernels' index and list logic, not timing, memory ordering
or anything the GPU's compiler decides.  ``--source`` runs another copy of
the source, e.g. a deliberately broken one for a mutation check.  Prints
one line a case and ``ALL OK``, or exits 1.
"""
from __future__ import annotations

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import scipy.sparse as sp
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from iterative_solvers_tpu_torch.ops import sparse as ts  # noqa: E402
from iterative_solvers_tpu_torch.ops import spmv  # noqa: E402

SOURCE = ROOT / "iterative_solvers_tpu_torch" / "ops" / "csrc" / "dia_spmv.cu"

STANDINS = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3v { unsigned x, y, z; };
extern thread_local uint3v threadIdx;
extern uint3v blockIdx, blockDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
typedef void* cudaStream_t;
struct cudaFuncAttributes { int numRegs; size_t sharedSizeBytes, localSizeBytes; };
struct float4 { float x, y, z, w; };
struct double2 { double x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline double2 make_double2(double a, double b) { return {a, b}; }
template <class T> T __ldg(const T* p) { return *p; }
template <class T> T __ldcg(const T* p) { return *p; }
unsigned __ballot_sync(unsigned, int p);
void __syncthreads();
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline long long __double_as_longlong(double f) { long long u; std::memcpy(&u, &f, 8); return u; }
inline double __longlong_as_double(long long u) { double f; std::memcpy(&f, &u, 8); return f; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)p; }
using std::max;
using std::min;
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int*) { return 0; }
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes*, K) { return 0; }
inline cudaError_t cudaDeviceGetAttribute(int*, cudaDeviceAttr, int) { return 0; }
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int*, K, int, size_t) { return 0; }
"""

HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local uint3v threadIdx;
uint3v blockIdx, blockDim;
static std::barrier<>* g_bar;
static int g_pred[kMvThreads];
void __syncthreads() { g_bar->arrive_and_wait(); }
unsigned __ballot_sync(unsigned, int p) {
  const int tid = threadIdx.x, w0 = tid & ~31;
  g_pred[tid] = p != 0;
  g_bar->arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (g_pred[w0 + l] ? 1u : 0u) << l;
  g_bar->arrive_and_wait();
  return m;
}
template <class G, bool CYC>
void run_tiled(const typename G::Type* data, const int* terms, int nterms,
               const typename G::Type* x, typename G::Type* y, int ny, int nx) {
  for (int by = 0; by < (ny + G::H - 1) / G::H; ++by)
    for (int bx = 0; bx < (nx + G::W - 1) / G::W; ++bx) {
      blockIdx = {static_cast<unsigned>(bx), static_cast<unsigned>(by), 0};
      std::barrier<> bar(kMvThreads);
      g_bar = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < kMvThreads; ++t)
        threads.emplace_back([&, t] {
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          grid_dia_matvec_tiled_kernel<G, CYC, kMvKernel>(data, terms, nterms, x, y, ny, nx);
        });
      for (auto& h : threads) h.join();
    }
}
template <class T>
void run_v1(int cyclic, const T* data, const int* terms, int nterms, const T* x, T* y, int ny,
            int nx) {
  for (int by = 0; by < (ny + kBY - 1) / kBY; ++by)
    for (int bx = 0; bx < (nx + kBX - 1) / kBX; ++bx) {
      blockIdx = {static_cast<unsigned>(bx), static_cast<unsigned>(by), 0};
      for (int ty = 0; ty < kBY; ++ty)
        for (int tx = 0; tx < kBX; ++tx) {
          threadIdx = {static_cast<unsigned>(tx), static_cast<unsigned>(ty), 0};
          cyclic ? grid_dia_matvec_v1_kernel<T, true>(data, terms, nterms, x, y, ny, nx)
                 : grid_dia_matvec_v1_kernel<T, false>(data, terms, nterms, x, y, ny, nx);
        }
    }
}
template <class T>
void run_typed(int vec, int cyclic, const T* data, const int* terms, int nterms, const T* x,
               T* y, T* y1, int ny, int nx) {
  if (vec) {
    using G = MvOf<T, true>;
    cyclic ? run_tiled<G, true>(data, terms, nterms, x, y, ny, nx)
           : run_tiled<G, false>(data, terms, nterms, x, y, ny, nx);
  } else {
    using G = MvOf<T, false>;
    cyclic ? run_tiled<G, true>(data, terms, nterms, x, y, ny, nx)
           : run_tiled<G, false>(data, terms, nterms, x, y, ny, nx);
  }
  run_v1(cyclic, data, terms, nterms, x, y1, ny, nx);
}
extern "C" void emulate_matvec(int f64, int vec, int cyclic, const void* data, const int* terms,
                               int nterms, const void* x, void* y, void* y1, int ny, int nx) {
  if (f64)
    run_typed(vec, cyclic, static_cast<const double*>(data), terms, nterms,
              static_cast<const double*>(x), static_cast<double*>(y), static_cast<double*>(y1),
              ny, nx);
  else
    run_typed(vec, cyclic, static_cast<const float*>(data), terms, nterms,
              static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(y1),
              ny, nx);
}
"""

V1_MULTIPLY_ADD = """      acc += __ldg(data + static_cast<size_t>(k) * field + here)
             * __ldg(x + static_cast<size_t>(rr) * nx + cc);"""
V1_FMA = ("      acc = fma_rn(__ldg(data + static_cast<size_t>(k) * field + here),\n"
          "                   __ldg(x + static_cast<size_t>(rr) * nx + cc), acc);")


def build(source: pathlib.Path, out_dir: pathlib.Path) -> ctypes.CDLL:
    """The kernel source behind the stand-ins, with the harness, as a
    shared library."""
    text = source.read_text()
    if V1_MULTIPLY_ADD not in text:
        raise SystemExit("the v1 kernel's multiply-add is not where the emulator expects it")
    text = text.replace(V1_MULTIPLY_ADD, V1_FMA)
    text = re.sub(r"<<<.*?>>>", "", text, flags=re.S)
    text = re.sub(r"asm volatile\(.*?\);", ";", text, flags=re.S)
    text = text.replace("extern __shared__ __align__(16) unsigned char slab_smem[];",
                        "static unsigned char slab_smem[16];")
    (out_dir / "cuda_runtime.h").write_text(STANDINS)
    cpp = out_dir / "dia_spmv_host.cpp"
    cpp.write_text('#include "cuda_runtime.h"\n' + text + HARNESS)
    lib = out_dir / "libdia_spmv_host.so"
    out = subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                          "-Wno-unknown-pragmas", f"-I{out_dir}", "-o", str(lib), str(cpp),
                          "-lpthread"], capture_output=True, text=True, timeout=600)
    if out.returncode:
        print(out.stderr[-6000:], file=sys.stderr)
        raise SystemExit("g++ failed on the kernel source")
    fn = ctypes.CDLL(str(lib)).emulate_matvec
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, i, i, p, p, i, p, p, p, i, i]
    fn.restype = None
    return fn


def _second_difference(n, periodic):
    d = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1]).tolil()
    if periodic:
        d[0, n - 1] = d[n - 1, 0] = 1.0
    return d.tocsr()


def operator(kind, ny, nx):
    """The tests' operators on an ny x nx grid: the periodic SH operator
    (h = 0.7, r = 0.01), the Dirichlet 5-point Laplacian ("lap") and
    biharmonic (h = 0.7), a random matrix (one shift per entry), none."""
    if kind == "random":
        return sp.random(ny * nx, ny * nx, density=0.002, random_state=3, format="csr")
    if kind == "empty":
        return sp.csr_matrix((ny * nx, ny * nx))
    periodic = kind == "sh"
    lap = (sp.kron(sp.identity(ny), _second_difference(nx, periodic))
           + sp.kron(_second_difference(ny, periodic), sp.identity(nx))) / 0.49
    if kind == "sh":
        return (-(lap @ lap) - 2 * lap - 0.99 * sp.identity(ny * nx)).tocsr()
    return (lap @ lap).tocsr() if kind == "biharmonic" else lap.tocsr()


def run_case(fn, kind, grid, cyclic, dtype, path, big=False) -> bool:
    """One container with random coefficients everywhere (``big``: 1e30
    where a source lies outside the grid, and no plain reference)."""
    rng = np.random.default_rng(1)
    a = ts.GridDIA.from_scipy(operator(kind, *grid), grid, cyclic=cyclic, device="cpu")
    a = a._replace(data=torch.tensor(rng.standard_normal(tuple(a.data.shape)), dtype=dtype))
    if big:
        data = a.data.clone()
        gr, gc = torch.arange(grid[0])[:, None], torch.arange(grid[1])[None, :]
        for k, (dy, dx) in enumerate(a.shifts):
            data[k][(gr + dy < 0) | (gr + dy >= grid[0]) | (gc + dx < 0)
                    | (gc + dx >= grid[1])] = 1e30
        a = a._replace(data=data)
    x = torch.tensor(rng.standard_normal(grid), dtype=dtype)
    terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, torch.device("cpu"))
    y = torch.full(grid, float("nan"), dtype=dtype)
    y1 = torch.full(grid, float("nan"), dtype=dtype)
    fn(int(dtype == torch.float64), int(path == "vector"), int(cyclic), a.data.data_ptr(),
       terms.data_ptr() if terms.numel() else None, terms.shape[0], x.data_ptr(), y.data_ptr(),
       y1.data_ptr(), *grid)
    vs_v1 = float((y - y1).abs().max())
    rel = 0.0
    if not big:
        want = a._apply(x)
        scale = float(want.abs().max())
        rel = float((y - want).abs().max()) / scale if scale else float((y - want).abs().max())
    ok = (not bool(y.isnan().any()) and vs_v1 == 0.0
          and rel <= (1e-5 if dtype == torch.float32 else 1e-12))
    print(f"{kind:10s} {str(grid):11s} cyclic={int(cyclic)} {str(dtype)[6:]:8s} {path:6s} "
          f"terms={terms.shape[0]:4d} vs_v1={vs_v1} vs_plain={rel:.2e} "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    return ok


CASES = ([(kind, (24, 24), cyclic) for kind in ("sh", "lap", "biharmonic", "random")
          for cyclic in (False, True)]
         + [("sh", (37, 132), False), ("sh", (37, 132), True), ("lap", (37, 130), True),
            ("lap", (5, 999), False), ("lap", (9, 14), False), ("sh", (9, 14), True),
            ("empty", (24, 24), False), ("sh", (20, 260), False), ("sh", (1, 7), True),
            ("lap", (1, 1), False)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=pathlib.Path, default=SOURCE)
    args = ap.parse_args()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        fn = build(args.source, pathlib.Path(tmp))
        for kind, grid, cyclic in CASES:
            for dtype in (torch.float32, torch.float64):
                vector = 16 // torch.tensor([], dtype=dtype).element_size()
                for path in ("vector", "scalar"):
                    if path == "scalar" or grid[1] % vector == 0:
                        ok &= run_case(fn, kind, grid, cyclic, dtype, path)
        ok &= run_case(fn, "sh", (37, 132), False, torch.float32, "vector", big=True)
        ok &= run_case(fn, "biharmonic", (37, 132), False, torch.float64, "scalar", big=True)
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
