// Kernel F at the camera models other than the standard one: the C entry
// pct_mixed_gram_model over mixed_kernels.cuh's launch_mixed<IW, CW>, built
// at the fisheye (intr_w 8), rational (12), thin-prism (16) and tilted (18)
// widths for both key widths (9: the mixed chain, 6: the grouped one). A
// translation unit of its own, so that its nvcc runs beside
// mixed_grams.cu's and mixed_models_e.cu's.

#include "mixed_kernels.cuh"

extern "C" {

// Kernel F at intrinsic width intr_w (8, 12, 16, 18; a = intr_w + 6,
// W = a + 7) and key width cw (9 or 6). packed (B, PPB) of that width's
// layout, kd (48, K), uv (B, K, 2), mask (B, K), cmask (B, a), imask
// (B, 6), kmask (K, cw) -> gram (B, W, W), wcc (B, a cw, K), wic (B, 6 cw,
// K), hkk (K, cw, cw), gk (K, cw). Scratch: blk_part (ceil(K / 128), B,
// W (W + 1) / 2), hk_part (ceil(B / chunk), 9, K). Another width (the
// standard model's 9 is pct_mixed_gram, mixed_grams.cu) or key width
// returns cudaErrorInvalidValue and launches nothing.
int pct_mixed_gram_model(int intr_w, const float *packed, const float *kd,
                         const float *uv, const float *mask,
                         const float *cmask, const float *imask,
                         const float *kmask, int cw, int n_blocks,
                         int n_keys, int loss, int component, float f_scale,
                         int chunk, float *gram, float *wcc, float *wic,
                         float *hkk, float *gk, float *blk_part,
                         float *hk_part, void *stream) {
  if (cw != 9 && cw != 6) return (int)cudaErrorInvalidValue;
  switch (intr_w) {
#define PCT_CASE(IW)                                                         \
  case IW:                                                                   \
    return cw == 9                                                           \
               ? launch_mixed<IW, 9>(packed, kd, uv, mask, cmask, imask,     \
                                     kmask, n_blocks, n_keys, loss,          \
                                     component, f_scale, chunk, gram, wcc,   \
                                     wic, hkk, gk, blk_part, hk_part,        \
                                     (cudaStream_t)stream)                   \
               : launch_mixed<IW, 6>(packed, kd, uv, mask, cmask, imask,     \
                                     kmask, n_blocks, n_keys, loss,          \
                                     component, f_scale, chunk, gram, wcc,   \
                                     wic, hkk, gk, blk_part, hk_part,        \
                                     (cudaStream_t)stream);
    PCT_CASE(8) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The first pass of pct_mixed_gram_model at intr_w (8, 12, 16, 18) and cw
// (9, 6) as the device holds it: pct_mixed_occupancy (mixed_grams.cu)
// asks it.
int pct_mixed_gram_model_occupancy(int intr_w, int cw, int *out) {
  if (cw != 9 && cw != 6) return (int)cudaErrorInvalidValue;
  switch (intr_w) {
#define PCT_CASE(IW)                                                 \
  case IW:                                                           \
    return cw == 9 ? first_pass_occupancy<IW, 9, false>(out)         \
                   : first_pass_occupancy<IW, 6, false>(out);
    PCT_CASE(8) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
