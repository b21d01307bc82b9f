#!/usr/bin/env python3
"""Run the tiled ``grid_dia_matvec`` and ``grid_dia_matmat`` kernels of
``ops/csrc/dia_spmv.cu`` on the host CPU, with no ``nvcc`` and no GPU:
``python3 tools/emulate_dia_spmv.py [--only spmv|spmm] [--source FILE]``.

The CUDA source is compiled by the host's ``g++`` (C++20) behind a small
header of CUDA stand-ins: the qualifiers are no-ops, ``__ldg`` / ``__ldcg``
plain loads, the 16-byte vector types plain structs, the runtime API stubs;
the launch syntax is cut out; a ``cp.async`` copy is queued by the thread
that issues it and lands at that thread's ``wait_group`` (its commit
counted), and the SpMM's x window starts each block as NaN, so a read of
the window before the wait shows.  A block's 256 CUDA
threads run as fibers on one host thread, one block after another;
``__syncthreads`` yields, and a round of the fibers brings every one to the
barrier before any passes it; ``__ballot_sync`` is a shared array between
two barriers; ``__shared__`` arrays are function statics, shared by the
block's threads.

The tiled SpMV and the tiled SpMM are held bit for bit against this
tool's own one-thread-a-point host loop (every term of the table tested at
every point for every right-hand side, each product fused into the sum
with ``std::fma``, in table order).  Every case checks that
the kernel writes every point, equals its reference bit for bit and lies
within 1e-5 (f32) / 1e-12 (f64) of max|plain| of ``GridDIA._apply`` (the
SpMM: ``_matmat_plain``): the tests' operators, the far-shift clamped SH
container, ragged and odd widths (999 f64, 130 f32), 1 x 1 and 1 x 7, the
empty matrix, lists of several chunks and of several staged groups, 1e30
coefficients where a source lies outside the grid, on each path that the
width allows; the SpMM in both layouts with 1, 3, 8 and 11 right-hand
sides.

It checks the kernels' index, list and staging logic, not timing, memory
ordering or anything the GPU's compiler decides.  ``--source`` runs
another copy of the source, e.g. a deliberately broken one for a mutation
check.  Prints one line a case and ``ALL OK``, or exits 1.
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
extern uint3v threadIdx, blockIdx;
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
// cp.async: a copy is queued by the thread that issues it and lands only at
// that thread's wait_group (harness)
void emu_cp_async(void* dst, const void* src, int bytes, int size);
void emu_cp_commit();
void emu_cp_wait(int pending);
// the SpMM's dynamic shared memory, poisoned (NaN) at each block's start
alignas(16) extern unsigned char g_mm_smem[1 << 17];
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
#include <cmath>
#include <ucontext.h>
#include <vector>
uint3v threadIdx, blockIdx;
// A block's threads are fibers on one host thread: each runs until its next
// __syncthreads, then yields; a round runs every fiber once, so no fiber
// passes a barrier before all have reached it.
static ucontext_t g_main;
static ucontext_t g_fiber[kTileThreads];
static std::vector<char> g_stack[kTileThreads];
static int g_pred[kTileThreads];
static int g_cur;
void __syncthreads() { swapcontext(&g_fiber[g_cur], &g_main); }
// each thread's queued cp.async copies, with the group each lies in, and
// its groups committed so far
struct PendingCopy {
  void* dst;
  const void* src;
  int bytes, size, group;
};
static std::vector<PendingCopy> g_copies[kTileThreads];
static int g_committed[kTileThreads];
alignas(16) unsigned char g_mm_smem[1 << 17];
void emu_cp_async(void* dst, const void* src, int bytes, int size) {
  g_copies[g_cur].push_back({dst, src, bytes, size, g_committed[g_cur]});
}
void emu_cp_commit() { ++g_committed[g_cur]; }
// land every copy of this thread's groups but the `pending` newest
// committed ones (a copy not yet committed stays queued)
void emu_cp_wait(int pending) {
  std::vector<PendingCopy>& q = g_copies[g_cur];
  std::vector<PendingCopy> keep;
  for (const PendingCopy& c : q) {
    if (c.group < g_committed[g_cur] - pending) {
      std::memcpy(c.dst, c.src, c.bytes);
      std::memset(static_cast<char*>(c.dst) + c.bytes, 0, c.size - c.bytes);
    } else {
      keep.push_back(c);
    }
  }
  q.swap(keep);
}
unsigned __ballot_sync(unsigned, int p) {
  const int tid = threadIdx.x, w0 = tid & ~31;
  g_pred[tid] = p != 0;
  __syncthreads();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= (g_pred[w0 + l] ? 1u : 0u) << l;
  __syncthreads();
  return m;
}
static void (*g_body)(void*);
static void* g_arg;
static bool g_done[kTileThreads];
static void fiber_entry() {
  g_body(g_arg);
  g_done[g_cur] = true;
}
// every block of a grid of tiles (h rows x w columns), one at a time, its
// kTileThreads threads as fibers
template <class F>
void run_blocks(int ny, int nx, int h, int w, F kernel) {
  g_body = [](void* f) { (*static_cast<F*>(f))(); };
  g_arg = &kernel;
  for (int by = 0; by < (ny + h - 1) / h; ++by)
    for (int bx = 0; bx < (nx + w - 1) / w; ++bx) {
      blockIdx = {static_cast<unsigned>(bx), static_cast<unsigned>(by), 0};
      std::memset(g_mm_smem, 0xFF, sizeof(g_mm_smem));
      for (int t = 0; t < kTileThreads; ++t) {
        g_copies[t].clear();
        g_committed[t] = 0;
        g_stack[t].resize(1 << 16);
        getcontext(&g_fiber[t]);
        g_fiber[t].uc_stack.ss_sp = g_stack[t].data();
        g_fiber[t].uc_stack.ss_size = g_stack[t].size();
        g_fiber[t].uc_link = &g_main;
        makecontext(&g_fiber[t], fiber_entry, 0);
        g_done[t] = false;
      }
      for (bool live = true; live;) {
        live = false;
        for (int t = 0; t < kTileThreads; ++t) {
          if (g_done[t]) continue;
          g_cur = t;
          threadIdx = {static_cast<unsigned>(t), 0, 0};
          swapcontext(&g_main, &g_fiber[t]);
          live = true;
        }
      }
    }
}
// the SpMV / SpMM one point at a time, every term of the table tested at
// every point for every right-hand side, each product fused into the sum:
// the reference the tiled kernels must equal bit for bit.  Element
// (j, r, c) of x and y lies at j * rs + r * ws + c.
template <class T>
void host_matmat(int cyclic, const T* data, const int* terms, int nterms, const T* x, T* y,
                 int nrhs, int ny, int nx, long long rs, long long ws) {
  const long long field = static_cast<long long>(ny) * nx;
  for (int j = 0; j < nrhs; ++j)
    for (int r = 0; r < ny; ++r)
      for (int c = 0; c < nx; ++c) {
        T acc = T(0);
        for (int t = 0; t < nterms; ++t) {
          const int k = terms[3 * t], dy = terms[3 * t + 1], dx = terms[3 * t + 2];
          int rr = r + dy, cc = c + dx;
          if (cyclic) {
            if (rr >= ny) rr -= ny;
            if (cc >= nx) cc -= nx;
          } else if (rr < 0 || rr >= ny || cc < 0 || cc >= nx) {
            continue;
          }
          acc = std::fma(data[k * field + static_cast<long long>(r) * nx + c],
                         x[j * rs + rr * ws + cc], acc);
        }
        y[j * rs + r * ws + c] = acc;
      }
}
template <class T>
void run_matvec(int vec, int cyclic, const T* data, const int* terms, int nterms, const T* x,
                T* y, T* y1, int ny, int nx) {
  auto tiled = [&](auto g) {
    using G = decltype(g);
    run_blocks(ny, nx, G::H, G::W, [&] {
      cyclic ? grid_dia_matvec_tiled_kernel<G, true, kMvKernel>(data, terms, nterms, x, y, ny, nx)
             : grid_dia_matvec_tiled_kernel<G, false, kMvKernel>(data, terms, nterms, x, y, ny,
                                                                  nx);
    });
  };
  vec ? tiled(MvOf<T, true>{}) : tiled(MvOf<T, false>{});
  host_matmat(cyclic, data, terms, nterms, x, y1, 1, ny, nx, 0, nx);
}
template <class T>
void run_matmat(int vec, int cyclic, int interleaved, const T* data, const int* terms,
                int nterms, const T* x, T* y, T* y1, int nrhs, int ny, int nx) {
  const long long rs = interleaved ? nx : static_cast<long long>(ny) * nx;
  const long long ws = interleaved ? static_cast<long long>(nrhs) * nx : nx;
  auto tiled = [&](auto g) {
    using G = decltype(g);
    run_blocks(ny, nx, G::H, G::W, [&] {
      cyclic ? grid_dia_matmat_tiled_kernel<G, true, kMvKernel>(data, terms, nterms, x, y,
                                                                nrhs, ny, nx, rs, ws)
             : grid_dia_matmat_tiled_kernel<G, false, kMvKernel>(data, terms, nterms, x, y,
                                                                 nrhs, ny, nx, rs, ws);
    });
  };
  vec ? tiled(MmOf<T, true>{}) : tiled(MmOf<T, false>{});
  host_matmat(cyclic, data, terms, nterms, x, y1, nrhs, ny, nx, rs, ws);
}
extern "C" void emulate_matvec(int f64, int vec, int cyclic, const void* data, const int* terms,
                               int nterms, const void* x, void* y, void* y1, int ny, int nx) {
  if (f64)
    run_matvec(vec, cyclic, static_cast<const double*>(data), terms, nterms,
               static_cast<const double*>(x), static_cast<double*>(y), static_cast<double*>(y1),
               ny, nx);
  else
    run_matvec(vec, cyclic, static_cast<const float*>(data), terms, nterms,
               static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(y1), ny,
               nx);
}
extern "C" void emulate_matmat(int f64, int vec, int cyclic, int interleaved, const void* data,
                               const int* terms, int nterms, const void* x, void* y, void* y1,
                               int nrhs, int ny, int nx) {
  if (f64)
    run_matmat(vec, cyclic, interleaved, static_cast<const double*>(data), terms, nterms,
               static_cast<const double*>(x), static_cast<double*>(y), static_cast<double*>(y1),
               nrhs, ny, nx);
  else
    run_matmat(vec, cyclic, interleaved, static_cast<const float*>(data), terms, nterms,
               static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(y1),
               nrhs, ny, nx);
}
"""

TUNING_EXPORTS = "// What the compiler and the card give the cyclic slab kernel"


def build(source: pathlib.Path, out_dir: pathlib.Path):
    """The kernel source behind the stand-ins, with the harness, as a
    shared library; returns its ``emulate_matvec`` and ``emulate_matmat``."""
    text = source.read_text()
    # the resource reports, at the end of the file, are not emulated
    text = text[:text.index(TUNING_EXPORTS)]
    text = re.sub(r"<<<.*?>>>", "", text, flags=re.S)
    # cp.async queued by the issuing thread, landing at its wait_group: a
    # read of the window before the wait sees the poison, not x
    text = re.sub(r'asm volatile\("cp\.async\.cg\.shared\.global.*?\);',
                  "(void)d; emu_cp_async(dst, src, fill ? 16 : 0, 16);", text, flags=re.S)
    text = re.sub(r'asm volatile\("cp\.async\.ca\.shared\.global.*?\);',
                  "(void)d; emu_cp_async(dst, src, BYTES, BYTES);", text, flags=re.S)
    text = re.sub(r'asm volatile\("cp\.async\.commit_group.*?\);', "emu_cp_commit();",
                  text, flags=re.S)
    text = re.sub(r'asm volatile\("cp\.async\.wait_group.*?\);', "emu_cp_wait(N);", text,
                  flags=re.S)
    text = re.sub(r"asm volatile\(.*?\);", ";", text, flags=re.S)
    text = text.replace("extern __shared__ __align__(16) unsigned char slab_smem[];",
                        "static unsigned char slab_smem[16];")
    text = text.replace("extern __shared__ __align__(16) unsigned char mm_smem[];",
                        "unsigned char* mm_smem = g_mm_smem;")
    (out_dir / "cuda_runtime.h").write_text(STANDINS)
    cpp = out_dir / "dia_spmv_host.cpp"
    cpp.write_text('#include "cuda_runtime.h"\n' + text + HARNESS)
    lib = out_dir / "libdia_spmv_host.so"
    out = subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                          "-Wno-unknown-pragmas", f"-I{out_dir}", "-o", str(lib), str(cpp),
                          ], capture_output=True, text=True, timeout=600)
    if out.returncode:
        print(out.stderr[-6000:], file=sys.stderr)
        raise SystemExit("g++ failed on the kernel source")
    so = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    mv, mm = so.emulate_matvec, so.emulate_matmat
    mv.argtypes = [i, i, i, p, p, i, p, p, p, i, i]
    mm.argtypes = [i, i, i, i, p, p, i, p, p, p, i, i, i]
    mv.restype = mm.restype = None
    return mv, mm


def _second_difference(n, periodic):
    d = sp.diags([np.ones(n - 1), -2 * np.ones(n), np.ones(n - 1)], [-1, 0, 1]).tolil()
    if periodic:
        d[0, n - 1] = d[n - 1, 0] = 1.0
    return d.tocsr()


def operator(kind, ny, nx):
    """The tests' operators on an ny x nx grid: the periodic SH operator
    (h = 0.7, r = 0.01), the Dirichlet 5-point Laplacian ("lap") and
    biharmonic (h = 0.7), a random matrix (one shift per entry), a band of
    105 diagonals, none, and the Dirichlet Laplacian behind 272 terms at
    dy -23..-8 ("deadfirst": the top tiles' first chunk of the list holds no
    live term, the next one whole terms that read the x window)."""
    if kind == "random":
        return sp.random(ny * nx, ny * nx, density=0.002, random_state=3, format="csr")
    if kind == "empty":
        return sp.csr_matrix((ny * nx, ny * nx))
    if kind == "band":  # 105 flat diagonals within 2 rows and 10 columns: many near terms
        offsets = [dy * nx + dx for dy in range(-2, 3) for dx in range(-10, 11)]
        return sp.diags([np.ones(ny * nx - abs(o)) for o in offsets], offsets).tocsr()
    periodic = kind == "sh"
    lap = (sp.kron(sp.identity(ny), _second_difference(nx, periodic))
           + sp.kron(_second_difference(ny, periodic), sp.identity(nx))) / 0.49
    if kind == "deadfirst":
        offsets = [dy * nx + dx for dy in range(-23, -7) for dx in range(-8, 9)]
        far = sp.diags([np.ones(ny * nx - abs(o)) for o in offsets], offsets)
        return (far + lap).tocsr()
    if kind == "sh":
        return (-(lap @ lap) - 2 * lap - 0.99 * sp.identity(ny * nx)).tocsr()
    return (lap @ lap).tocsr() if kind == "biharmonic" else lap.tocsr()


def _container(kind, grid, cyclic, dtype, rng, big):
    """One container with random coefficients everywhere (``big``: 1e30
    where a source lies outside the grid)."""
    a = ts.GridDIA.from_scipy(operator(kind, *grid), grid, cyclic=cyclic, device="cpu")
    a = a._replace(data=torch.tensor(rng.standard_normal(tuple(a.data.shape)), dtype=dtype))
    if big:
        data = a.data.clone()
        gr, gc = torch.arange(grid[0])[:, None], torch.arange(grid[1])[None, :]
        for k, (dy, dx) in enumerate(a.shifts):
            data[k][(gr + dy < 0) | (gr + dy >= grid[0]) | (gc + dx < 0)
                    | (gc + dx >= grid[1])] = 1e30
        a = a._replace(data=data)
    return a


def _report(label, got, ref, want, dtype, big, ref_name):
    """Every point written, equal to ``ref`` bit for bit and (unless
    ``big``) within 1e-5 (f32) / 1e-12 (f64) of max|want|."""
    vs_ref = float((got - ref).abs().max())
    rel = 0.0
    if not big:
        scale = float(want.abs().max())
        rel = float((got - want).abs().max()) / (scale if scale else 1.0)
    ok = (not bool(got.isnan().any()) and vs_ref == 0.0
          and rel <= (1e-5 if dtype == torch.float32 else 1e-12))
    print(f"{label} {ref_name}={vs_ref} vs_plain={rel:.2e} {'OK' if ok else 'FAIL'}", flush=True)
    return ok


def run_case(fn, kind, grid, cyclic, dtype, path, big=False) -> bool:
    """The tiled SpMV against the one-thread-a-point host loop (bit for
    bit) and ``GridDIA._apply``."""
    rng = np.random.default_rng(1)
    a = _container(kind, grid, cyclic, dtype, rng, big)
    x = torch.tensor(rng.standard_normal(grid), dtype=dtype)
    terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, torch.device("cpu"))
    y = torch.full(grid, float("nan"), dtype=dtype)
    y1 = torch.full(grid, float("nan"), dtype=dtype)
    fn(int(dtype == torch.float64), int(path == "vector"), int(cyclic), a.data.data_ptr(),
       terms.data_ptr() if terms.numel() else None, terms.shape[0], x.data_ptr(), y.data_ptr(),
       y1.data_ptr(), *grid)
    label = (f"spmv {kind:10s} {str(grid):11s} cyclic={int(cyclic)} {str(dtype)[6:]:8s} "
             f"{path:6s} terms={terms.shape[0]:4d}")
    return _report(label, y, y1, None if big else a._apply(x), dtype, big, "vs_host_loop")


def run_mm_case(fn, kind, grid, cyclic, dtype, nrhs, layout, path, big=False) -> bool:
    """The tiled SpMM against the one-thread-a-point host loop (bit for
    bit) and ``_matmat_plain``, in ``layout``."""
    rng = np.random.default_rng(2)
    a = _container(kind, grid, cyclic, dtype, rng, big)
    x3 = torch.tensor(rng.standard_normal((nrhs,) + grid), dtype=dtype)
    x = x3 if layout == "stacked" else x3.movedim(0, 1).contiguous()
    terms = spmv._grid_terms(a.shifts, a.grid, a.cyclic, torch.device("cpu"))
    y = torch.full(x.shape, float("nan"), dtype=dtype)
    y1 = torch.full(x.shape, float("nan"), dtype=dtype)
    fn(int(dtype == torch.float64), int(path == "vector"), int(cyclic),
       int(layout == "interleaved"), a.data.data_ptr(),
       terms.data_ptr() if terms.numel() else None, terms.shape[0], x.data_ptr(), y.data_ptr(),
       y1.data_ptr(), nrhs, *grid)
    want = None
    if not big:
        want = spmv._matmat_plain(a, x3)
        want = want if layout == "stacked" else want.movedim(0, 1)
    label = (f"spmm {kind:10s} {str(grid):11s} cyclic={int(cyclic)} {str(dtype)[6:]:8s} "
             f"{path:6s} x{nrhs:<2d} {layout:11s} terms={terms.shape[0]:4d}")
    return _report(label, y, y1, want, dtype, big, "vs_host_loop")


CASES = ([(kind, (24, 24), cyclic) for kind in ("sh", "lap", "biharmonic", "random")
          for cyclic in (False, True)]
         + [("sh", (37, 132), False), ("sh", (37, 132), True), ("lap", (37, 130), True),
            ("lap", (5, 999), False), ("lap", (9, 14), False), ("sh", (9, 14), True),
            ("empty", (24, 24), False), ("sh", (20, 260), False), ("sh", (1, 7), True),
            ("lap", (1, 1), False)])

F32, F64 = torch.float32, torch.float64
# (operator, grid, cyclic, dtype, right-hand sides): the far-shift clamped SH
# container (|dy| up to ny - 1) on both paths, 999-wide f64 and 130-wide
# f32 rows (the scalar path), 1 x 1, the empty matrix, random containers
# of several chunks of terms (~650 clamped, ~520 cyclic), cyclic wraps and
# ragged tiles, a band of 105 diagonals (lists of several staged groups of
# terms, whole terms past the x window), a list whose first chunk is dead
# for the top tiles and whose second reads the window; nrhs 1, 3, 8 and 11
# (more than one register tile)
MM_CASES = [("sh", (37, 132), False, F32, 8), ("sh", (37, 132), False, F32, 11),
            ("sh", (37, 132), False, F64, 3), ("sh", (20, 68), False, F32, 1),
            ("sh", (24, 24), True, F32, 11), ("sh", (37, 100), True, F64, 8),
            ("lap", (5, 999), False, F64, 8), ("lap", (9, 130), True, F32, 3),
            ("biharmonic", (9, 14), False, F64, 11), ("lap", (1, 1), False, F32, 1),
            ("lap", (1, 1), True, F64, 3), ("empty", (24, 24), False, F64, 3),
            ("random", (24, 24), False, F64, 8), ("random", (24, 24), True, F32, 11),
            ("band", (20, 260), False, F32, 11), ("band", (20, 260), True, F64, 11),
            ("deadfirst", (24, 132), False, F32, 11), ("deadfirst", (24, 99), False, F64, 8)]


def _paths(grid, dtype):
    vector = 16 // torch.tensor([], dtype=dtype).element_size()
    return ["vector", "scalar"] if grid[1] % vector == 0 else ["scalar"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=pathlib.Path, default=SOURCE)
    ap.add_argument("--only", choices=("spmv", "spmm"), help="run one kernel's cases")
    args = ap.parse_args()
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        mv, mm = build(args.source, pathlib.Path(tmp))
        if args.only != "spmm":
            for kind, grid, cyclic in CASES:
                for dtype in (F32, F64):
                    for path in _paths(grid, dtype):
                        ok &= run_case(mv, kind, grid, cyclic, dtype, path)
            ok &= run_case(mv, "sh", (37, 132), False, F32, "vector", big=True)
            ok &= run_case(mv, "biharmonic", (37, 132), False, F64, "scalar", big=True)
        if args.only != "spmv":
            for kind, grid, cyclic, dtype, nrhs in MM_CASES:
                for layout in ("stacked", "interleaved"):
                    for path in _paths(grid, dtype):
                        ok &= run_mm_case(mm, kind, grid, cyclic, dtype, nrhs, layout, path)
            for layout in ("stacked", "interleaved"):
                ok &= run_mm_case(mm, "sh", (37, 132), False, F32, 3, layout, "vector", big=True)
                ok &= run_mm_case(mm, "biharmonic", (37, 132), False, F64, 8, layout, "scalar",
                                  big=True)
    print("ALL OK" if ok else "SOME FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
