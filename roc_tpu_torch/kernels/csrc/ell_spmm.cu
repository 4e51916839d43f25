// Degree-bucketed ELL neighbour sum, fp32 and bf16 (K4).
//
// Replaces roc_tpu/kernels/ell_spmm.py ell_aggregate_pallas
// (_bucket_kernel): for one degree bucket idx [rows, width] of source ids,
//   out[row_id[r], :] = sum_j feats[idx[r, j], :]
// summed in fp32 over the row's valid ids, the output in feats' type (bf16
// rounded once at the store, as the TPU kernel casts its fp32 accumulator
// once).  Ids outside [0, dummy) (the bucket padding holds dummy == the
// gathered row count) add nothing, so no zero row has to be appended to
// feats.  Bucket rows whose row_id is not a real output row are skipped.
// Rows in no bucket (degree 0) keep the zeros the caller allocated out
// with.  One launch per bucket, each bucket row written straight to its
// output row: no [rows, F] bucket output to concatenate and permute
// afterwards.
//
// Bound on the H100 (80GB HBM3, 700 W): the rate of its gathers, E * F *
// sizeof(E) bytes a call, every segment from L2 at least.  Measured
// (chip_smoke.py --gather-race, gather_ceiling: this kernel at F = 256
// fp32, slice 32, one bucket of 512 ids a row): 7.8 TB/s with random and
// with sequential ids alike, 13.8-14.5 with ids in 128 rows that L1
// holds: the L2-to-SM rate bounds it, 20-30x above the time of moving
// each input byte once.  The unsliced warp-per-row schedule gathers at F
// = 256 mostly from HBM (~3.8 TB/s of gathered bytes, 29.5 ms in fp32).
// Design: the column-sliced, slice-major gather-sum of row_gather.cuh, one
// warp per (bucket row, slice), the slice on blockIdx.y so that all blocks
// of one slice run before the next and its V * S * sizeof(E) bytes of feats
// stay in L2; the fp32 gathers then come from L2 at the ceiling (~7.7
// TB/s, 14.9 ms).  Rows move in the widest unit their starts allow
// (row_gather.cuh unit_bytes): at F = 602, the SGC's hop, fp32 rows of
// 8-byte units take 44.1 ms at slice 32 (68.7 in one-element units) and
// bf16 rows of 4-byte units 22.6 ms unsliced (65.3).  HBM carries feats
// once per bucket launch, out once, and the bucket's ids once per slice
// (ceil(F / S) passes). Lane groups fill the warp on narrow slices and
// combine in a fixed tree: no atomics, the same bits on every launch. The
// slice width S is a template parameter, one instance each for 16, 32, 64,
// 128 and 0 (unsliced, which stays the faster one at F <= 64 and over
// units narrower than 8 bytes), and the unit another; the wrapper picks
// the width per F and dtype from a race on the card (kernels/ell_spmm.py),
// the launch the unit from the addresses.
// The TPU kernel's 8-row DMA groups and SMEM index staging answer the
// TPU's (8, 128) HBM tiling and scalar-core DMA issue; neither exists here.

#include "row_gather.cuh"

using roc_gather::kWarpsPerBlock;

namespace {

template <typename E, int S, int B>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    ell_bucket_sum(const E* __restrict__ feats, const int* __restrict__ idx,
                   const int* __restrict__ row_id, E* __restrict__ out,
                   int rows, int width, int dummy, int num_rows, int F) {
  const int r = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // uniform across the warp
  const int dst = row_id[r];
  if (dst < 0 || dst >= num_rows) return;
  roc_gather::warp_gather_sum<E, S, B>(feats, idx + (long long)r * width,
                                         width, dummy, F,
                                         out + (long long)dst * F, lane);
}

template <typename E, int S>
void launch(const E* feats, const int* idx, const int* row_id, E* out,
            int rows, int width, int dummy, int num_rows, int F,
            cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  roc_gather::num_slices(S, F));
  const int unit = roc_gather::unit_bytes(feats, out, F);
  roc_gather::with_unit<E>(unit, [&](auto B) {
    ell_bucket_sum<E, S, decltype(B)::value>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
            feats, idx, row_id, out, rows, width, dummy,
            num_rows, F);
  });
}

template <typename E>
int run(const E* feats, const int* idx, const int* row_id, E* out, int rows,
        int width, int dummy, int num_rows, int F, int slice_cols,
        void* stream) {
  if (!roc_gather::valid_slice(slice_cols)) return (int)cudaErrorInvalidValue;
  if (rows == 0 || F == 0) return (int)cudaGetLastError();
  roc_gather::with_slice(slice_cols, [&](auto S) {
    launch<E, decltype(S)::value>(feats, idx, row_id, out, rows, width, dummy,
                                  num_rows, F, (cudaStream_t)stream);
  });
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int roc_ell_aggregate_f32(const float* feats, const int* idx,
                                     const int* row_id, float* out, int rows,
                                     int width, int dummy, int num_rows, int F,
                                     int slice_cols, void* stream) {
  return run(feats, idx, row_id, out, rows, width, dummy, num_rows, F,
             slice_cols, stream);
}

extern "C" int roc_ell_aggregate_bf16(const __nv_bfloat16* feats,
                                      const int* idx, const int* row_id,
                                      __nv_bfloat16* out, int rows, int width,
                                      int dummy, int num_rows, int F,
                                      int slice_cols, void* stream) {
  return run(feats, idx, row_id, out, rows, width, dummy, num_rows, F,
             slice_cols, stream);
}
