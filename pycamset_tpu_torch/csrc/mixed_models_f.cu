// Kernel F at the camera models other than the standard one: the C entries
// pct_mixed_gram_model{,_rigs} over mixed_kernels.cuh's launch_mixed<IW,
// CW>, built at the fisheye (intr_w 8), rational (12), thin-prism (16) and
// tilted (18) widths for both key widths (9: the mixed chain, 6: the
// grouped one). A translation unit of its own, so that its nvcc runs beside
// mixed_grams.cu's and mixed_models_e.cu's.

#include "mixed_kernels.cuh"

extern "C" {

// Kernel F at intrinsic width intr_w (8, 12, 16, 18; a = intr_w + 6,
// W = a + 7) and key width cw (9 or 6) over n_rigs rigs of n_blocks blocks
// each (mixed_kernels.cuh launch_mixed), rig-major. packed (R B, PPB) of
// that width's layout, kd (R, 48, K), uv (R B, K, 2), mask (R B, K), cmask
// (R B, a), imask (R B, 6), kmask (R, K, cw) -> gram (R B, W, W), wcc
// (R B, a cw, K), wic (R B, 6 cw, K), hkk (R, K, cw, cw), gk (R, K, cw).
// Scratch: blk_part (ceil(K / 128), R B, W (W + 1) / 2), hk_part
// (R ceil(B / chunk), 9, K). Another width (the standard model's 9 is
// mixed_grams.cu's) or key width returns cudaErrorInvalidValue and
// launches nothing. pct_mixed_gram_rigs (mixed_grams.cu) forwards here.
int pct_mixed_gram_model_rigs(int intr_w, int n_rigs, const float *packed,
                              const float *kd, const float *uv,
                              const float *mask, const float *cmask,
                              const float *imask, const float *kmask, int cw,
                              int n_blocks, int n_keys, int loss,
                              int component, float f_scale, int chunk,
                              float *gram, float *wcc, float *wic, float *hkk,
                              float *gk, float *blk_part, float *hk_part,
                              void *stream) {
  if (cw != 9 && cw != 6) return (int)cudaErrorInvalidValue;
  switch (intr_w) {
#define PCT_CASE(IW)                                                         \
  case IW:                                                                   \
    return cw == 9                                                           \
               ? launch_mixed<IW, 9>(packed, kd, uv, mask, cmask, imask,     \
                                     kmask, n_rigs, n_blocks, n_keys, loss,  \
                                     component, f_scale, chunk, gram, wcc,   \
                                     wic, hkk, gk, blk_part, hk_part,        \
                                     (cudaStream_t)stream)                   \
               : launch_mixed<IW, 6>(packed, kd, uv, mask, cmask, imask,     \
                                     kmask, n_rigs, n_blocks, n_keys, loss,  \
                                     component, f_scale, chunk, gram, wcc,   \
                                     wic, hkk, gk, blk_part, hk_part,        \
                                     (cudaStream_t)stream);
    PCT_CASE(8) PCT_CASE(12) PCT_CASE(16) PCT_CASE(18)
#undef PCT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Kernel F at intrinsic width intr_w and key width cw, one rig: packed (B,
// PPB), kd (48, K), ..., hkk (K, cw, cw) (pct_mixed_gram_model_rigs at
// n_rigs = 1).
int pct_mixed_gram_model(int intr_w, const float *packed, const float *kd,
                         const float *uv, const float *mask,
                         const float *cmask, const float *imask,
                         const float *kmask, int cw, int n_blocks,
                         int n_keys, int loss, int component, float f_scale,
                         int chunk, float *gram, float *wcc, float *wic,
                         float *hkk, float *gk, float *blk_part,
                         float *hk_part, void *stream) {
  return pct_mixed_gram_model_rigs(intr_w, 1, packed, kd, uv, mask, cmask,
                                   imask, kmask, cw, n_blocks, n_keys, loss,
                                   component, f_scale, chunk, gram, wcc, wic,
                                   hkk, gk, blk_part, hk_part, stream);
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
