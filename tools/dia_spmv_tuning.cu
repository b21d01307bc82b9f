// The tuning script's variants of the kernels of
// iterative_solvers_tpu_torch/ops/csrc/dia_spmv.cu: the cyclic f32 slab
// SpMM, the clamped tiled SpMV and the clamped tiled (general) SpMM at
// other tilings, and their probes.  Built on its own by
// tools/tune_port_kernels.py (spmm, spmv, general) into a library of its
// own; the package's library holds the chosen tilings alone.
#include "../iterative_solvers_tpu_torch/ops/csrc/dia_spmv.cu"

namespace {

// the tuning script's variants of the f32 tiling (2 halo rows)
using SlabF32 = SlabOf<float, 2>;
using SlabGlobalHalo = SlabTiling<float, 64, 8, 2, 64, 256, 2, false>;
using SlabS3 = SlabTiling<float, 64, 8, 3, 64, 256, 2>;
using SlabW32 = SlabTiling<float, 32, 8, 2, 32, 256, 2>;
using SlabW128 = SlabTiling<float, 128, 8, 2, 128, 256, 2>;
using SlabB16 = SlabTiling<float, 64, 16, 2, 64, 256, 2>;
using SlabCols2 = SlabTiling<float, 64, 8, 2, 32, 256, 2>;

// the tuning script's variants of the clamped tiled SpMV
using MvF32U1 = MvTiling<float, true, 1, 1, 1>;
using MvF32U2 = MvTiling<float, true, 1, 1, 2>;
using MvF32U8 = MvTiling<float, true, 1, 1, 8>;
using MvF32P8 = MvTiling<float, true, 2, 1, 4>;
using MvF32R2 = MvTiling<float, true, 1, 2, 4>;
using MvF32T64 = MvTiling<float, true, 1, 1, 4, 64>;
using MvF32T128 = MvTiling<float, true, 1, 1, 4, 128>;
using MvF32SU4 = MvTiling<float, false, 4, 1, 4>;
using MvF64U1 = MvTiling<double, false, 4, 1, 1>;
using MvF64U4 = MvTiling<double, false, 4, 1, 4>;
using MvF64U8 = MvTiling<double, false, 4, 1, 8>;
using MvF64P2 = MvTiling<double, false, 2, 1, 2>;
using MvF64P8 = MvTiling<double, false, 8, 1, 2>;
using MvF64R2 = MvTiling<double, false, 4, 2, 2>;
using MvF64T64 = MvTiling<double, false, 4, 1, 2, 64>;
using MvF64T128 = MvTiling<double, false, 4, 1, 2, 128>;
using MvF64VU4 = MvTiling<double, true, 2, 1, 4>;
using MvF64U4B4 = MvTiling<double, false, 4, 1, 4, 32, 4>;

}  // namespace

// The cyclic f32 slab kernel (2 halo rows) at other tilings and wave
// counts, and its probes, for the tuning script (tools/tune_port_kernels.py);
// nothing of the package calls it.  Variants and probes as in the switch.
extern "C" int grid_dia_matmat_slab_variant_f32(const float* data, const int* terms,
                                                int nterms, const float* x, float* y,
                                                int nrhs, int ny, int nx, int interleaved,
                                                int hy, int hx, void* stream, int variant) {
  size_t rs, ws;
  layout_strides(interleaved, nrhs, ny, nx, &rs, &ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SLAB_VARIANT(G, PROBE, WAVES)                                                    \
  launch_slab<G, true, PROBE>(data, terms, nterms, x, y, nrhs, ny, nx, hy, hx, rs, ws, s, \
                              WAVES)
  switch (variant) {
    case 0: return SLAB_VARIANT(SlabF32, 0, 1);         // the chosen tiling
    case 1: return SLAB_VARIANT(SlabGlobalHalo, 0, 1);  // halo rows from global memory
    case 2: return SLAB_VARIANT(SlabS3, 0, 1);          // 3 stages: one block an SM
    case 3: return SLAB_VARIANT(SlabW32, 0, 1);
    case 4: return SLAB_VARIANT(SlabW128, 0, 1);        // one block an SM
    case 5: return SLAB_VARIANT(SlabB16, 0, 1);         // one block an SM
    case 6: return SLAB_VARIANT(SlabCols2, 0, 1);       // two columns a thread
    case 7: return SLAB_VARIANT(SlabF32, 0, 4);         // 4 waves of blocks
    case 10: return SLAB_VARIANT(SlabF32, 1, 1);        // probe: no copies
    case 11: return SLAB_VARIANT(SlabF32, 2, 1);        // probe: no arithmetic
    case 12: return SLAB_VARIANT(SlabF32, 3, 1);        // probe: copies alone
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLAB_VARIANT
}
// The clamped tiled SpMV at other tilings, and its probes, for the tuning
// script (tools/tune_port_kernels.py spmv); nothing of the package calls
// them.  Variants as in the switches: around the f32 vector path and the
// f64 scalar path (the Poisson 999^2 shape), each with the other path.
#define MV_VARIANT(G, PROBE) launch_mv<G, false, PROBE>(data, terms, nterms, x, y, ny, nx, s)

extern "C" int grid_dia_matvec_variant_f32(const float* data, const int* terms, int nterms,
                                           const float* x, float* y, int ny, int nx,
                                           void* stream, int variant) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return MV_VARIANT(MvF32, kMvKernel);         // the chosen tiling: P 4, U 4
    case 1: return MV_VARIANT(MvF32U1, kMvKernel);       // U = 1
    case 2: return MV_VARIANT(MvF32U2, kMvKernel);       // U = 2
    case 3: return MV_VARIANT(MvF32U8, kMvKernel);       // U = 8
    case 4: return MV_VARIANT(MvF32P8, kMvKernel);       // 8 points a thread
    case 5: return MV_VARIANT(MvF32R2, kMvKernel);       // 2 rows a thread
    case 6: return MV_VARIANT(MvF32S, kMvKernel);        // the scalar path (U = 2)
    case 7: return MV_VARIANT(MvF32T64, kMvKernel);      // 64 threads along a row
    case 8: return MV_VARIANT(MvF32T128, kMvKernel);     // 128 threads along a row
    case 9: return MV_VARIANT(MvF32SU4, kMvKernel);      // the scalar path, U = 4
    case 20: return MV_VARIANT(MvF32, kMvNoList);
    case 21: return MV_VARIANT(MvF32, kMvLoadsAlone);
    case 22: return MV_VARIANT(MvF32, kMvCoefAlone);
    case 23: return MV_VARIANT(MvF32, kMvXAlone);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int grid_dia_matvec_variant_f64(const double* data, const int* terms, int nterms,
                                           const double* x, double* y, int ny, int nx,
                                           void* stream, int variant) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return MV_VARIANT(MvF64, kMvKernel);         // the chosen tiling: P 4, U 2
    case 1: return MV_VARIANT(MvF64U1, kMvKernel);       // U = 1
    case 2: return MV_VARIANT(MvF64U4, kMvKernel);       // U = 4
    case 3: return MV_VARIANT(MvF64U8, kMvKernel);       // U = 8
    case 4: return MV_VARIANT(MvF64P2, kMvKernel);       // 2 points a thread
    case 5: return MV_VARIANT(MvF64P8, kMvKernel);       // 8 points a thread
    case 6: return MV_VARIANT(MvF64R2, kMvKernel);       // 2 rows a thread
    case 7: return MV_VARIANT(MvF64T64, kMvKernel);      // 64 threads along a row
    case 8: return MV_VARIANT(MvF64T128, kMvKernel);     // 128 threads along a row
    case 9: return MV_VARIANT(MvF64V, kMvKernel);        // the vector path (U = 2)
    case 10: return MV_VARIANT(MvF64VU4, kMvKernel);     // the vector path, U = 4
    case 11: return MV_VARIANT(MvF64U4B4, kMvKernel);    // U = 4 in 64 registers (spills)
    case 20: return MV_VARIANT(MvF64, kMvNoList);
    case 21: return MV_VARIANT(MvF64, kMvLoadsAlone);
    case 22: return MV_VARIANT(MvF64, kMvCoefAlone);
    case 23: return MV_VARIANT(MvF64, kMvXAlone);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef MV_VARIANT

namespace {

// the tuning script's variants of the clamped tiled SpMM: around the f32
// vector path (the far-shift container) and the f64 scalar path (the
// Poisson 999^2 shape); MmTiling<T, NV, U, J, MINB, HY, CPV>
using MmF32 = MmOf<float, true>;
using MmF32U2 = MmTiling<float, 2, 2, 8, 4, 2, true>;
using MmF32U8 = MmTiling<float, 2, 8, 8, 4, 2, true>;
using MmF32B3 = MmTiling<float, 2, 4, 8, 3, 2, true>;
using MmF32P1 = MmTiling<float, 1, 4, 8, 4, 2, true>;
using MmF32J4 = MmTiling<float, 2, 4, 4, 4, 2, true>;
using MmF32S = MmOf<float, false>;
using MmF32L1 = MmTiling<float, 2, 4, 8, 4, 0>;
using MmF64 = MmOf<double, false>;
using MmF64U4 = MmTiling<double, 1, 4, 8, 4, 2>;
using MmF64B3 = MmTiling<double, 1, 8, 8, 3, 2>;
using MmF64P2 = MmTiling<double, 2, 4, 8, 2, 2>;
using MmF64L1 = MmTiling<double, 1, 8, 8, 4, 0>;

}  // namespace

// The clamped tiled SpMM at other tilings, and its probes (as the tiled
// SpMV's), for the tuning script (tools/tune_port_kernels.py general);
// nothing of the package calls them.  Variants as in the switches.
#define MM_VARIANT(G, PROBE) \
  launch_mm<G, false, PROBE>(data, terms, nterms, x, y, nrhs, ny, nx, interleaved, s)

extern "C" int grid_dia_matmat_general_variant_f32(const float* data, const int* terms,
                                                   int nterms, const float* x, float* y,
                                                   int nrhs, int ny, int nx, int interleaved,
                                                   void* stream, int variant) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return MM_VARIANT(MmF32, kMvKernel);    // the chosen tiling: P 2, U 4, J 8, B 4
    case 1: return MM_VARIANT(MmF32U2, kMvKernel);  // U = 2
    case 2: return MM_VARIANT(MmF32U8, kMvKernel);  // U = 8
    case 3: return MM_VARIANT(MmF32B3, kMvKernel);  // capped for 3 blocks an SM
    case 4: return MM_VARIANT(MmF32P1, kMvKernel);  // 1 point a thread
    case 5: return MM_VARIANT(MmF32J4, kMvKernel);  // 4 right-hand sides a register tile
    case 6: return MM_VARIANT(MmF32S, kMvKernel);   // the scalar path: element copies
    case 7: return MM_VARIANT(MmF32L1, kMvKernel);  // no window: x through L1
    case 20: return MM_VARIANT(MmF32, kMvNoList);
    case 21: return MM_VARIANT(MmF32, kMvLoadsAlone);
    case 22: return MM_VARIANT(MmF32, kMvCoefAlone);
    case 23: return MM_VARIANT(MmF32, kMvXAlone);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int grid_dia_matmat_general_variant_f64(const double* data, const int* terms,
                                                   int nterms, const double* x, double* y,
                                                   int nrhs, int ny, int nx, int interleaved,
                                                   void* stream, int variant) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return MM_VARIANT(MmF64, kMvKernel);    // the chosen tiling: P 1, U 8, J 8, B 4
    case 1: return MM_VARIANT(MmF64U4, kMvKernel);  // U = 4
    case 2: return MM_VARIANT(MmF64B3, kMvKernel);  // capped for 3 blocks an SM
    case 3: return MM_VARIANT(MmF64P2, kMvKernel);  // 2 points a thread, U = 4, 2 blocks
    case 4: return MM_VARIANT(MmF64L1, kMvKernel);  // no window: x through L1
    case 20: return MM_VARIANT(MmF64, kMvNoList);
    case 21: return MM_VARIANT(MmF64, kMvLoadsAlone);
    case 22: return MM_VARIANT(MmF64, kMvCoefAlone);
    case 23: return MM_VARIANT(MmF64, kMvXAlone);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef MM_VARIANT
